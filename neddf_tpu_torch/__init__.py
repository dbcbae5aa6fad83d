"""neddf_tpu_torch: the PyTorch + CUDA port of neddf_tpu for one NVIDIA H100.

The JAX package ``neddf_tpu`` stays the reference; this package mirrors
its layout and names and imports neither it nor JAX. Ported so far:
training (``scripts/run.py``), the eval render (``scripts/run_eval.py``,
with ``--ray-cull``) and geometry extraction (``scripts/fields_visualizer.py``,
``scripts/dataset_visualizer.py``) of the NeDDF, NeRF and NeuS fields, with
hand-written CUDA kernels (``csrc/``) built with nvcc at first use
(``kernels/_build.py``).
"""

__version__ = "0.1.0"
