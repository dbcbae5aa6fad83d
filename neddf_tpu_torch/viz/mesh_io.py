"""Triangle-mesh export: Wavefront .obj and COLLADA .dae.

Counterpart of ``neddf_tpu/viz/mesh_io.py`` (byte-identical files). The
reference exports its marching-cubes mesh to ``.dae`` via
``mcubes.export_mesh``; the COLLADA document is written directly here (a
small fixed XML schema), plus an .obj that any viewer reads.
"""
from __future__ import annotations

from pathlib import Path
from typing import Union
from xml.sax.saxutils import escape

import numpy as np


def compute_vertex_normals(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (same convention as
    o3d.TriangleMesh.compute_vertex_normals used at
    fields_visualizer.py:554)."""
    v = np.asarray(vertices, dtype=np.float64)
    t = np.asarray(triangles, dtype=np.int64)
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    normals = np.zeros_like(v)
    for i in range(3):
        np.add.at(normals, t[:, i], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.where(norm < 1e-12, 1.0, norm)


def export_obj(
    path: Union[str, Path], vertices: np.ndarray, triangles: np.ndarray
) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in np.asarray(triangles, dtype=np.int64) + 1:  # obj is 1-based
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")


_DAE_TEMPLATE = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset>
    <contributor><authoring_tool>neddf_tpu</authoring_tool></contributor>
    <unit name="meter" meter="1"/>
    <up_axis>Z_UP</up_axis>
  </asset>
  <library_geometries>
    <geometry id="{name}-mesh" name="{name}">
      <mesh>
        <source id="{name}-positions">
          <float_array id="{name}-positions-array" count="{n_pos}">\
{positions}</float_array>
          <technique_common>
            <accessor source="#{name}-positions-array" count="{n_verts}" stride="3">
              <param name="X" type="float"/>
              <param name="Y" type="float"/>
              <param name="Z" type="float"/>
            </accessor>
          </technique_common>
        </source>
        <source id="{name}-normals">
          <float_array id="{name}-normals-array" count="{n_pos}">{normals}</float_array>
          <technique_common>
            <accessor source="#{name}-normals-array" count="{n_verts}" stride="3">
              <param name="X" type="float"/>
              <param name="Y" type="float"/>
              <param name="Z" type="float"/>
            </accessor>
          </technique_common>
        </source>
        <vertices id="{name}-vertices">
          <input semantic="POSITION" source="#{name}-positions"/>
        </vertices>
        <triangles count="{n_tris}">
          <input semantic="VERTEX" source="#{name}-vertices" offset="0"/>
          <input semantic="NORMAL" source="#{name}-normals" offset="0"/>
          <p>{indices}</p>
        </triangles>
      </mesh>
    </geometry>
  </library_geometries>
  <library_visual_scenes>
    <visual_scene id="Scene" name="Scene">
      <node id="{name}" name="{name}" type="NODE">
        <instance_geometry url="#{name}-mesh"/>
      </node>
    </visual_scene>
  </library_visual_scenes>
  <scene>
    <instance_visual_scene url="#Scene"/>
  </scene>
</COLLADA>
"""


def export_dae(
    path: Union[str, Path],
    vertices: np.ndarray,
    triangles: np.ndarray,
    name: str = "mcube",
) -> None:
    """Write a minimal COLLADA 1.4.1 document (positions + normals +
    triangles), drop-in for mcubes.export_mesh."""
    v = np.asarray(vertices, dtype=np.float64)
    t = np.asarray(triangles, dtype=np.int64)
    normals = compute_vertex_normals(v, t)
    doc = _DAE_TEMPLATE.format(
        name=escape(name),
        n_pos=v.size,
        n_verts=v.shape[0],
        n_tris=t.shape[0],
        positions=" ".join(f"{x:.6f}" for x in v.reshape(-1)),
        normals=" ".join(f"{x:.6f}" for x in normals.reshape(-1)),
        indices=" ".join(str(i) for i in t.reshape(-1)),
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(doc)
