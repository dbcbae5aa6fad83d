"""Package rules of the PyTorch port: it imports without JAX and without
the JAX package, maps config targets and devices as documented, and
never falls back from CUDA to the CPU."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import neddf_tpu_torch
from neddf_tpu import config as jconfig
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.fields.neddf import NeDDF
from neddf_tpu_torch.geometry.rays import Sampling
from neddf_tpu_torch.training.trainer import resolve_device

REPO = Path(__file__).resolve().parents[1]
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(neddf_tpu_torch.__path__, "neddf_tpu_torch.")
)


def test_every_module_imports_without_jax_or_neddf_tpu():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neddf_tpu'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'neddf_tpu.'))\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) > 20


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "tpu", "gpu"])
def test_cuda_request_without_cuda_raises(device):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(device)


def test_cpu_device_and_unknown_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("metal")


def test_fused_on_with_cpu_tensors_raises():
    field = NeDDF(ddf_layer_count=4, ddf_layer_width=16, col_layer_count=3,
                  col_layer_width=16, skips=(1,), fused="on")
    s = Sampling(torch.zeros(1, 4, 3), torch.ones(1, 4, 3), torch.zeros(1, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        field(s, field.schedule(-1))
    with pytest.raises(ValueError):
        NeDDF(fused="maybe")
    # YAML 1.1 reads `fused: on` / `off` as booleans
    assert NeDDF(fused=True).fused == "on" and NeDDF(fused=False).fused == "off"


@pytest.mark.parametrize("target,expect", [
    ("neddf_tpu.fields.NeDDF", "neddf_tpu_torch.fields.NeDDF"),
    ("neddf_tpu.render.NeRFRender", "neddf_tpu_torch.render.NeRFRender"),
    ("neddf.network.NeDDF", "neddf_tpu_torch.fields.NeDDF"),
    ("neddf.trainer.NeRFTrainer", "neddf_tpu_torch.training.NeRFTrainer"),
    ("neddf.dataset.NeRFSyntheticDataset", "neddf_tpu_torch.data.NeRFSyntheticDataset"),
])
def test_target_remap(target, expect):
    assert tconfig.remap_target(target) == expect
    assert tconfig.resolve_target(target).__module__.startswith("neddf_tpu_torch.")


def test_snapshot_and_compose_match_the_jax_config_layer():
    run = REPO / "pretrained" / "machine_neddf"
    assert tconfig.load_snapshot(run) == jconfig.load_snapshot(run)
    overrides = ["dataset=machine", "trainer.chunk=256", "network.fused=off"]
    assert (tconfig.compose(REPO / "config", overrides=overrides)
            == jconfig.compose(REPO / "config", overrides=overrides))


def test_chip_smoke_fails_without_cuda_and_outside_a_checkout(tmp_path):
    """The GPU smoke script exits non-zero and prints no result line on a
    machine without CUDA, and in a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    script = REPO / "chip_smoke.py"
    (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
    for cwd, path in ((REPO, script), (tmp_path, tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(path)], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0, (cwd, out.stdout)
        assert '"ok"' not in out.stdout, (cwd, out.stdout)
