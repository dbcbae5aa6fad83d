"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process (all started
together) into an object file, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. A source listed
in ``VARIANTS`` is compiled once per set of macro definitions there, each
its own process and object: ``tile_fwd.cu`` per operand type and width
class of the row-tile forward, ``dual_mlp_bwd.cu`` per operand type of
the products, ``neddf_epilogue.cu`` per operand type of the epilogue
backward, ``layer_fwd.cu`` per operand type of the per-layer route's
layer forward and ``route_products.cu`` per operand type of its backward
products, so that their instantiations build side by side. The build
happens at first use, never at import, into
``neddf_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``), where
``<hash>`` covers the sources and the flags: an edit to any
``.cu``/``.cuh`` file builds a fresh library.

The CUDA runtime launches on the current device, so every launch takes
its stream from ``stream(device)``, which raises unless the tensors'
device is the current one: a data-parallel rank on ``cuda:r`` makes
``cuda:r`` current (``parallel/mesh.py::init_rank``) before it launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libneddf_kernels.so"
# source -> the macro definitions of each of its objects (a source not
# listed builds one object with none)
VARIANTS = {
    "tile_fwd.cu": [(f"NEDDF_TILE_F32={f32}", f"NEDDF_TILE_C={c}")
                    for f32 in (0, 1) for c in (64, 128, 256, 512)],
    "dual_mlp_bwd.cu": [(), ("NEDDF_GEMM_BF16",), ("NEDDF_GEMM_F32",)],
    "neddf_epilogue.cu": [(), ("NEDDF_EPI_BF16",), ("NEDDF_EPI_F32",)],
    "layer_fwd.cu": [(), ("NEDDF_FWD_BF16",), ("NEDDF_FWD_F32",)],
    "route_products.cu": [(), ("NEDDF_ROUTE_BF16",), ("NEDDF_ROUTE_F32",)],
}


def objects():
    """(source, object stem, -D flags) of every object of the library."""
    out = []
    for src in sorted(CSRC.glob("*.cu")):
        for defs in VARIANTS.get(src.name, [()]):
            stem = "_".join([src.stem, *[d.split("=")[-1].lower() for d in defs]])
            out.append((src, stem, [f"-D{d}" for d in defs]))
    return out


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build the CUDA kernels")


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(VARIANTS.items())).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out_dir = build_dir()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    start = time.perf_counter()
    jobs = []
    for src, stem, defs in objects():
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-c", "-o",
               str(out_dir / f"{stem}.{os.getpid()}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    def wait(proc):  # its output, and when it ended
        out, _ = proc.communicate()
        return out, time.perf_counter() - start

    with ThreadPoolExecutor(len(jobs)) as pool:
        ends = list(pool.map(wait, [proc for _, proc in jobs]))
    log, failed = "", 0
    for (cmd, proc), (out, end) in zip(jobs, ends):
        log += f"$ {' '.join(cmd)}\n{out}[exit {proc.returncode} at {end:.1f} s]\n"
        failed = failed or proc.returncode
    if not failed:
        tmp = out_dir / f"{_LIB_NAME}.{tag}"
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *[c[c.index("-o") + 1] for c, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}[exit {proc.returncode}]\n"
        failed = proc.returncode
    log += f"\n[build] {time.perf_counter() - start:.1f} s, exit {failed}\n"
    (out_dir / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed (exit {failed}):\n{log[-6000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


_VOIDP = ctypes.c_void_p
_VOIDPP = ctypes.POINTER(ctypes.c_void_p)
_INTP = ctypes.POINTER(ctypes.c_int)
_INT = ctypes.c_int
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with argtypes."""
    lib = ctypes.CDLL(str(build()))
    signatures = {
        # csrc/dual_mlp_fwd.cu
        "neddf_dual_mlp_fwd": [
            _INT, _INT, _INT, _INT, _INT, _INT, _VOIDPP, _VOIDPP, _INTP,
            _INT, _VOIDPP, _VOIDPP, _INTP, _VOIDPP, _VOIDP, _VOIDP, _VOIDP,
        ],
        # csrc/mlp_fwd.cu
        "neddf_mlp_seg_fwd": [
            _INT, _INT, _INT, _INT, _INT, _VOIDPP, _INTP,
            _INT, _VOIDPP, _VOIDPP, _INTP, _VOIDPP, _VOIDP, _VOIDP,
        ],
        # csrc/mlp_bwd.cu
        "neddf_mlp_bwd_gpre": [_INT, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                               _VOIDP, _VOIDP],
        # csrc/sdf_mlp.cu
        "neddf_sdf_sweep": [_INT, _INT, _INT, _INT, _INT, _VOIDPP, _INTP, _VOIDPP, _VOIDP,
                            _VOIDP],
        "neddf_sdf_top": [_INT, _LL, _INT, _INT, _VOIDP, _VOIDP, _VOIDP],
        # csrc/dual_mlp_bwd.cu
        "neddf_dual_bwd_gstack": [
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP,
        ],
        "neddf_gemm_tc": [
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOIDP, _LL, _INT, _VOIDP, _LL, _INT,
            _INT, _VOIDP, _LL, _INT, _INT, _VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP,
        ],
        "neddf_sum_splits": [_LL, _INT, _VOIDP, _VOIDP, _VOIDP],
        "neddf_sum_rows": [_INT, _INT, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP],
        # csrc/layer_fwd.cu
        "neddf_layer_fwd": [
            _INT, _INT, _INT, _INT, _INT, _INT, _VOIDP, _INT, _VOIDP, _INT, _INT, _INT, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP,
        ],
        # csrc/route_products.cu
        "neddf_route_product": [
            _INT, _INT, _INT, _INT, _INT, _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _VOIDP, _LL, _INT,
            _INT, _VOIDP, _VOIDP,
        ],
        # csrc/neddf_epilogue.cu
        "neddf_epilogue_fwd": [
            _INT, _INT, _INT, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP,
        ],
        "neddf_epilogue_bwd_blocks": [_INT, _INT, _INT, _INT, _INT, _INTP],
        "neddf_epilogue_bwd": [
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
        ],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.neddf_cuda_error_string.argtypes = [_INT]
    lib.neddf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().neddf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, for a launch on it;
    ``device`` must be the current device (the runtime launches there)."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(
            f"a kernel launch on {device} while cuda:{current} is the current device "
            f"(call torch.cuda.set_device({device.index}) first)")
    return torch.cuda.current_stream(device).cuda_stream


def pointers(values) -> "ctypes.Array":
    """A C array of ``void*`` (tensors by data_ptr, None as NULL)."""
    return (ctypes.c_void_p * len(values))(
        *[None if v is None else v.data_ptr() for v in values]
    )


def ints(values) -> "ctypes.Array":
    return (ctypes.c_int * len(values))(*[int(v) for v in values])
