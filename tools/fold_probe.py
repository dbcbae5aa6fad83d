"""Probe design choices of the folded products' route_nt epilogue
(``csrc/route_products.cu``, kFoldAct / kFoldDual) on the card: how much
of a folded nt's time the stash read costs, and what a shallower ring
costs (together they bound what a stash streamed by TMA into shared
memory, beside the ring, could gain), and how far ahead to prefetch the
stash.

Builds altered copies of this checkout's ``neddf_tpu_torch`` under
``outputs/fold_probe/`` (git-ignored), each by textual substitutions in
``route_products.cu`` that the script checks apply exactly once:

* ``no_stash``: the nt epilogues read no stash (each z a constant 0.5,
  the next tile's L2 prefetch gone); their outputs are wrong, their time
  is a floor for any design that reads the stash, TMA or not;
* ``ring3``: the bf16 folded route_nt with 3 ring stages instead of 4,
  the depth a 32 KB stash stage (128 x 128 bf16) would leave it in the
  card's shared memory (see ``budget``);
* ``ahead2``, ``ahead3``: the stash prefetched into L2 two or three tiles
  ahead of the epilogue instead of one; ``ahead2_unroll2``: ``ahead2``
  with the epilogues' row loops unrolled twice (two rows' loads in
  flight).

Then times ``tools/route_products_ab.py TREE --fold`` (the folded modes at
the shipped steps' shapes) for this checkout, the variants named (by
default ``no_stash`` and ``ring3``) and this checkout again, in that
order, and prints the shared-memory budgets of the tiles in question
against the card's opt-in limit, then one JSON line per run (as
``route_products_ab.py`` prints it). Run from the root of a checkout on a
machine with one CUDA card:

    python3 tools/fold_probe.py [NAME ...]
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "outputs" / "fold_probe"

NO_STASH = [
    ("    neddf::load_n<8>(zp + i, vec, n_in, zv);\n",
     "    for (int j = 0; j < 8; ++j) zv[j] = 0.5f;\n"),
    ("          if (s > 0) load_packed8(zp + s * plane + i, vec, n_in, zq[s]);\n",
     "          if (s > 0) for (int k = 0; k < 4; ++k) zq[s][k] = 0x3f003f00u;\n"),
    ("        if (s == 0 || (kCouple && !kPacked)) neddf::load_n<W>(zp + s * plane + i, vec, "
     "n_in, zv[s]);\n",
     "        if (s == 0 || (kCouple && !kPacked))\n"
     "          for (int j = 0; j < W; ++j) zv[s][j] = 0.5f;\n"),
    ("__device__ __forceinline__ void nt_prefetch(const NtArgs<T>& a, int tile, int t, int n) {\n",
     "__device__ __forceinline__ void nt_prefetch(const NtArgs<T>& a, int tile, int t, int n) {\n"
     "  return;\n"),
]
RING3 = [
    ("      std::is_same_v<T, bf16> && FOLD == kFoldNone ? 5 : Wide<T>::STAGES;\n",
     "      std::is_same_v<T, bf16> ? (FOLD == kFoldNone ? 5 : 3) : Wide<T>::STAGES;\n"),
]
AHEAD = [
    ("    if constexpr (FOLD != kFoldNone) nt_prefetch<T, FOLD, ACT, SL>(a, blockIdx.x, t, NE);\n",
     "    if constexpr (FOLD != kFoldNone)\n"
     "      for (int q = 0; q < {n}; ++q)\n"
     "        nt_prefetch<T, FOLD, ACT, SL>(a, blockIdx.x + q * gridDim.x, t, NE);\n"),
    ("        nt_prefetch<T, FOLD, ACT, SL>(a, tile + gridDim.x, t, NE);\n",
     "        nt_prefetch<T, FOLD, ACT, SL>(a, tile + {n} * gridDim.x, t, NE);\n"),
]
UNROLL2 = [
    ("#pragma unroll 1\n  for (int pl = t >> 4; pl < kTileRows; pl += n >> 4) {\n"
     "    const int row = r0 + pl;\n    if (row >= a.R) break;\n    float av[8];",
     "#pragma unroll 2\n  for (int pl = t >> 4; pl < kTileRows; pl += n >> 4) {\n"
     "    const int row = r0 + pl;\n    if (row >= a.R) break;\n    float av[8];"),
    ("#pragma unroll 1\n  for (int r = t >> 4; r < P; r += n >> 4) {",
     "#pragma unroll 2\n  for (int r = t >> 4; r < P; r += n >> 4) {"),
]


def ahead(n: int) -> list:
    return [(old, new.replace("{n}", str(n))) for old, new in AHEAD]


VARIANTS = {"no_stash": NO_STASH, "ring3": RING3, "ahead2": ahead(2), "ahead3": ahead(3),
            "ahead2_unroll2": ahead(2) + UNROLL2}
DEFAULT = ("no_stash", "ring3")


def variant(name: str, subs) -> Path:
    """A copy of neddf_tpu_torch with ``subs`` applied to route_products.cu."""
    tree = OUT / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(REPO / "neddf_tpu_torch", tree / "neddf_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tree / "neddf_tpu_torch" / "csrc" / "route_products.cu"
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old.strip()!r} found {text.count(old)} times")
        text = text.replace(old, new)
    src.write_text(text)
    return tree


def budget() -> dict:
    """Shared-memory bytes of route_nt's folded bf16 block (route_products.cu
    and hopper.cuh's constants: ring stages of A's 128 rows and B's 128
    columns of a 64-deep k-block, the handed-over f32 tile, the epilogue
    warps' column sums) at 128 x 128 with 4 stages, with one or two stash
    stages beside fewer, and at 128 x 256 with 2 stages or 1; against the
    card's opt-in limit per block."""
    import torch

    kb, rows, red_warps = 64, 128, (5 * 128 - 9 * 32) // 32

    def block(cols, stages, stash_stages=0):
        ring = stages * (rows + cols) * kb * 2
        hand = rows * cols * 4
        red = red_warps * cols * 4
        bars = ((2 * stages + 2) * 8 + 15) // 16 * 16
        return ring + hand + red + bars + stash_stages * rows * cols * 2

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return {"limit": limit, "128x128, 4 stages (shipped)": block(128, 4),
            "128x128, 4 stages + 1 stash stage": block(128, 4, 1),
            "128x128, 3 stages + 1 stash stage": block(128, 3, 1),
            "128x128, 3 stages + 2 stash stages": block(128, 3, 2),
            "128x128, 2 stages + 2 stash stages": block(128, 2, 2),
            "128x256, 2 stages": block(256, 2), "128x256, 1 stage": block(256, 1)}


def main(names) -> int:
    print(json.dumps({"smem_bytes": budget()}), flush=True)
    trees = [variant(name, VARIANTS[name]) for name in names]
    for tree in (REPO, *trees, REPO):
        out = subprocess.run([sys.executable, str(REPO / "tools" / "route_products_ab.py"),
                              str(tree), "--fold"], cwd=REPO, capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(json.dumps({"tree": str(tree.relative_to(REPO)) or ".",
                          "fold": json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DEFAULT))
