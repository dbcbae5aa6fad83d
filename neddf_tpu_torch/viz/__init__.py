"""Geometry export and the visualizers' GUIs (numpy; open3d only in
``gui.py``, imported there on use)."""
from neddf_tpu_torch.viz.marching import marching_tetrahedra
from neddf_tpu_torch.viz.mesh_io import compute_vertex_normals, export_dae, export_obj

__all__ = [
    "marching_tetrahedra",
    "compute_vertex_normals",
    "export_dae",
    "export_obj",
]
