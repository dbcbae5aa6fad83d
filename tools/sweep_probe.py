"""Probe where the NeuS sweep's time goes (``csrc/sdf_sweep.cuh``) on the
card: each part's share is the time it saves when taken out.

Builds altered copies of this checkout's ``neddf_tpu_torch`` under
``outputs/sweep_probe/`` (git-ignored), each by textual substitutions in
``sdf_sweep.cuh`` that the script checks apply exactly once; the
variants' gE is wrong (except ``per_k8``'s), their time is what remains
without the part:

* ``no_split``: the two splitter warps arrive on ``ready`` without
  splitting W's stage (no tf32 planes written);
* ``no_e``: no e chunks (gE's columns of layer 0 and the post-skip
  layers: their stages, products and stores);
* ``no_products``: the consumers wait for each stage and release it
  without a product or an add;
* ``floor``: all three: what is left is W's stream from L2, the stash's
  from device memory, the barriers and the epilogue's stores;
* ``per_k8``: the products of each k8 step summed from zero, waited for
  and added with a rounded add (the layout of the row-tile forward), in
  place of one wait a k-block.

Then times ``tools/sweep_ab.py TREE`` (rows #7, 7s, P) for this checkout,
each variant named (by default all five) and this checkout again, in that
order (the builds first, all at once), and prints one JSON line per run
(as ``sweep_ab.py`` prints it). Run from the root of a checkout on a
machine with one CUDA card:

    python3 tools/sweep_probe.py [NAME ...]
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "outputs" / "sweep_probe"

NO_SPLIT = [
    ("            for (int u = t; u < units; u += 64) {\n",
     "            for (int u = t; u < 0 * units; u += 64) {\n"),
]
NO_E = [
    ("  return Chunks{has_e ? cdiv(r.a.E, r.p.ne) : 0, l > 0 ? cdiv(r.a.N, nc) : 0};\n",
     "  return Chunks{0, l > 0 ? cdiv(r.a.N, nc) : 0};\n"),
]
NO_PRODUCTS = [
    ("    wg_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) {\n"
     "      wg_tf32(part, al[kk], dh + 2 * kk, kk > 0);\n",
     "    if (dh == 0) {\n    wg_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) {\n"
     "      wg_tf32(part, al[kk], dh + 2 * kk, kk > 0);\n"),
    ("    for (int i = 0; i < NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);\n",
     "    for (int i = 0; i < NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);\n    }\n"),
]
PER_K8 = [
    ("    wg_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) {\n"
     "      wg_tf32(part, al[kk], dh + 2 * kk, kk > 0);\n"
     "      wg_tf32(part, ah[kk], dl + 2 * kk, 1);\n"
     "      wg_tf32(part, ah[kk], dh + 2 * kk, 1);\n    }\n"
     "    wg_commit();\n    wg_wait<0>();\n    fence_regs(part);\n#pragma unroll\n"
     "    for (int i = 0; i < NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);\n",
     "#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n"
     "      step_3xtf32(acc, part, ah[kk], al[kk], dh + 2 * kk, dl + 2 * kk);\n"),
]
VARIANTS = {"no_split": NO_SPLIT, "no_e": NO_E, "no_products": NO_PRODUCTS,
            "floor": NO_SPLIT + NO_E + NO_PRODUCTS, "per_k8": PER_K8}


def variant(name: str, subs) -> Path:
    """A copy of neddf_tpu_torch with ``subs`` applied to sdf_sweep.cuh."""
    tree = OUT / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(REPO / "neddf_tpu_torch", tree / "neddf_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tree / "neddf_tpu_torch" / "csrc" / "sdf_sweep.cuh"
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old.strip()!r} found {text.count(old)} times")
        text = text.replace(old, new)
    src.write_text(text)
    return tree


def main(names) -> int:
    trees = [variant(name, VARIANTS[name]) for name in names]
    build = "from neddf_tpu_torch.kernels import _build; _build.library()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=tree) for tree in (REPO, *trees)]
    if any(proc.wait() for proc in procs):
        print("a build failed", file=sys.stderr)
        return 1
    for tree in (REPO, *trees, REPO):
        out = subprocess.run([sys.executable, str(REPO / "tools" / "sweep_ab.py"), str(tree)],
                             cwd=REPO, capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(json.dumps({"tree": str(tree.relative_to(REPO)) or ".",
                          "sweep": json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or tuple(VARIANTS)))
