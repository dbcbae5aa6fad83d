"""Field visualizer of the PyTorch port: voxel volume, iso-surface mesh and
field slices of a trained run.

Usage:
    python -m neddf_tpu_torch.scripts.fields_visualizer <run_dir>
        [--epoch 2000] [--resolution 64] [--threshold T] [--field auto]
        [--slices 5] [--device cuda] [--gui]

The flags and files of ``neddf_tpu/scripts/fields_visualizer.py``. The run
loads through ``run_eval.load_trainer`` (on the card unless ``--device
cpu``; in this one process, also for a data-parallel run), then:

* the field (``--field auto``: ``distance`` for NeDDF, ``sdf`` for NeuS,
  ``density`` otherwise) is queried over a ``resolution``^3 lattice of
  [-1.1, 1.1]^3 (``fields/base.py::voxelize``) and cached in
  ``<run_dir>/mesh/voxel[_{field}]_{res}.npy``; a cached volume is read
  instead;
* marching tetrahedra (numpy, on the host) extract the iso-surface at
  ``--threshold`` (default: distance 0.0275, sdf 0.05, density 15.0),
  recentred by ``v = (v - res/2) * (2 * 1.1 / res)``, written to
  ``mesh/mesh[_{field}]_{res}_threshold{t}.dae`` and ``.obj``;
* XY slices of the fields at ``--slices`` z-planes in [-1, 1] go to
  ``<run_dir>/fields/slice_{name}_z{i:02}.png``.

``--gui`` opens the Open3D viewer (``viz/gui.py``) where open3d imports;
otherwise it says so, and the headless files above stand.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from neddf_tpu_torch.fields.base import voxelize
from neddf_tpu_torch.scripts.run_eval import load_trainer
from neddf_tpu_torch.utils.png import write_png
from neddf_tpu_torch.viz import export_dae, export_obj, marching_tetrahedra

#: the iso level of each field when ``--threshold`` is not given
DEFAULT_THRESHOLD = {"distance": 0.0275, "sdf": 0.05, "density": 15.0}


def default_field(trainer) -> str:
    """The family's level-set field: distance (NeDDF), sdf (NeuS), density."""
    kind = type(trainer.neural_render.network_fine).__name__
    return {"NeDDF": "distance", "NeuS": "sdf"}.get(kind, "density")


def generate_mesh(
    trainer,
    output_dir: Path,
    resolution: int = 64,
    threshold: float = 0.0275,
    cube_range: float = 1.1,
    field_name: str = "distance",
) -> Tuple[np.ndarray, np.ndarray]:
    """Voxelize (or read the cached volume) and mesh one scalar field;
    returns (vertices, triangles) in world space."""
    mesh_dir = Path(output_dir) / "mesh"
    mesh_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if field_name == "distance" else f"_{field_name}"
    voxel_path = mesh_dir / f"voxel{suffix}_{resolution}.npy"
    if voxel_path.exists():
        voxel = np.load(voxel_path)
    else:
        voxel = voxelize(trainer.neural_render.network_fine, field_name=field_name,
                         cube_range=cube_range, cube_resolution=resolution)
        np.save(voxel_path, voxel)

    vertices, triangles = marching_tetrahedra(voxel, threshold)
    vertices -= resolution / 2.0
    vertices *= 2.0 * cube_range / resolution

    dae_path = mesh_dir / f"mesh{suffix}_{resolution}_threshold{threshold}.dae"
    export_dae(dae_path, vertices, triangles, name="mcube")
    export_obj(dae_path.with_suffix(".obj"), vertices, triangles)
    print(f"mesh: {vertices.shape[0]} vertices, {triangles.shape[0]} triangles -> {dae_path}")
    return vertices, triangles


def export_field_slices(trainer, output_dir: Path, n_slices: int) -> None:
    """``fields/slice_{name}_z{i:02}.png`` at ``n_slices`` z-planes in [-1, 1]."""
    fields_dir = Path(output_dir) / "fields"
    fields_dir.mkdir(parents=True, exist_ok=True)
    for i, slice_t in enumerate(np.linspace(-1.0, 1.0, n_slices)):
        images = trainer.neural_render.render_field_slice(
            slice_t=float(slice_t), render_size=1.1, render_resolution=128)
        for name, img in images.items():
            # the images are BGR; the PNG writer takes RGB
            write_png(fields_dir / f"slice_{name}_z{i:02}.png", img[:, :, ::-1])
    print(f"field slices ({n_slices} z-planes) -> {fields_dir}")


def main(argv: Optional[List[str]] = None) -> Tuple[np.ndarray, np.ndarray]:
    parser = ArgumentParser()
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--epoch", type=int, default=2000)
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--threshold", type=float, default=None,
                        help="iso level; default per field: distance 0.0275, sdf 0.05, "
                        "density 15.0")
    parser.add_argument("--field", type=str, default="auto",
                        help="scalar field to mesh: auto (by network family), distance "
                        "(NeDDF), sdf (NeuS), density")
    parser.add_argument("--slices", type=int, default=5)
    parser.add_argument("--device", type=str, default=None,
                        help="override trainer device (cpu, cuda, cuda:N)")
    parser.add_argument("--gui", action="store_true")
    args = parser.parse_args(argv)

    output_dir = args.output_dir.resolve()
    trainer = load_trainer(output_dir, args.epoch, args.device, one_process=True)
    field = default_field(trainer) if args.field == "auto" else args.field
    threshold = args.threshold
    if threshold is None:
        threshold = DEFAULT_THRESHOLD.get(field, DEFAULT_THRESHOLD["density"])

    mesh = generate_mesh(trainer, output_dir, args.resolution, threshold, field_name=field)
    export_field_slices(trainer, output_dir, args.slices)

    if args.gui:
        try:
            import open3d  # noqa: F401
        except ImportError:
            print("open3d is not installed; headless artifacts were written instead")
            return mesh
        from neddf_tpu_torch.viz.gui import FieldsVisualizerGUI, run_app

        def mesh_fn(resolution, level):
            return generate_mesh(trainer, output_dir, resolution, level, field_name=field)

        run_app(lambda: FieldsVisualizerGUI(trainer, mesh_fn))
    return mesh


if __name__ == "__main__":
    main()
