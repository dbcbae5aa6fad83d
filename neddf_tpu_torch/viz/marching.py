"""Isosurface extraction: vectorized marching tetrahedra (numpy, on the host).

Counterpart of ``neddf_tpu/viz/marching.py``, whose output it equals
bitwise on the same volume. The reference meshes the NeDDF distance field
with PyMCubes (``mcubes.marching_cubes(voxel, threshold)``); this is a
dependency-free isosurfacer with the same call surface,
``marching_tetrahedra(volume, threshold) -> (verts, tris)``, vertices in
index space (so the caller's recentring ``v = (v - res/2) *
(2*range/res)`` applies unchanged).

Each grid cell is split into 6 tetrahedra around the main diagonal;
every tet contributes 0-2 triangles with vertices linearly interpolated
to the iso level along crossing edges. All tets are processed as flat
numpy batches (one pass per 16-entry case table row), and shared edge
vertices are deduplicated via unique (endpoint, endpoint) keys so the
output mesh is vertex-welded.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# cube corner offsets, bit order (dx, dy, dz)
_CUBE_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int64,
)

# six tetrahedra per cube, all sharing the main diagonal corner0-corner6
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int64,
)

# tet edges by local vertex pair; triangle corners index into this list
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# triangles (as triples of tet-edge ids) for each of the 16 inside-bitmask
# cases; bit i set == local vertex i is on the "inside" (value < level) side
_CASE_TRIS: List[List[Tuple[int, int, int]]] = [
    [],                                    # 0000
    [(0, 1, 2)],                           # 0001: v0 in -> edges 01,02,03
    [(0, 4, 3)],                           # 0010: v1 in -> edges 01,13,12
    [(1, 2, 4), (1, 4, 3)],                # 0011: v0,v1
    [(1, 3, 5)],                           # 0100: v2 in -> edges 02,12,23
    [(0, 2, 5), (0, 5, 3)],                # 0101: v0,v2
    [(0, 1, 5), (0, 5, 4)],                # 0110: v1,v2
    [(2, 5, 4)],                           # 0111: v3 out
    [(2, 4, 5)],                           # 1000: v3 in -> edges 03,13,23
    [(0, 4, 5), (0, 5, 1)],                # 1001: v0,v3
    [(0, 3, 5), (0, 5, 2)],                # 1010: v1,v3 -> ring e01,e12,e23,e03
    [(1, 5, 3)],                           # 1011: v2 out
    [(1, 4, 2), (1, 3, 4)],                # 1100: v2,v3
    [(0, 3, 4)],                           # 1101: v1 out
    [(0, 2, 1)],                           # 1110: v0 out
    [],                                    # 1111
]


def marching_tetrahedra(
    volume: np.ndarray, level: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface ``volume == level``.

    Args:
        volume: [Nx, Ny, Nz] scalar field.
        level: iso value.

    Returns:
        (vertices [V, 3] float64 in index space, triangles [T, 3] int64).
    """
    volume = np.asarray(volume, dtype=np.float64)
    nx, ny, nz = volume.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    flat = volume.reshape(-1)
    stride = np.array([ny * nz, nz, 1], dtype=np.int64)

    # flat vertex ids of every cube corner for every cell: [C, 8]
    cx, cy, cz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # [C, 3]
    corner_ids = (base[:, None, :] + _CUBE_CORNERS[None, :, :]) @ stride  # [C, 8]

    # tet vertex flat ids: [C*6, 4]
    tet_ids = corner_ids[:, _TETS].reshape(-1, 4)
    tet_vals = flat[tet_ids]  # [T, 4]
    inside = tet_vals < level
    case = (
        inside[:, 0].astype(np.int64)
        | (inside[:, 1] << 1)
        | (inside[:, 2] << 2)
        | (inside[:, 3] << 3)
    )

    # gather triangle corner edges per case
    edge_a: List[np.ndarray] = []
    edge_b: List[np.ndarray] = []
    for c in range(16):
        tris = _CASE_TRIS[c]
        if not tris:
            continue
        sel = np.nonzero(case == c)[0]
        if sel.size == 0:
            continue
        ids = tet_ids[sel]  # [S, 4]
        for tri in tris:
            ea = _TET_EDGES[list(tri)]  # [3, 2] local vertex pairs
            a = ids[:, ea[:, 0]]  # [S, 3] flat endpoint ids
            b = ids[:, ea[:, 1]]
            edge_a.append(a)
            edge_b.append(b)
    if not edge_a:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    a = np.concatenate(edge_a, axis=0).reshape(-1)  # [3T]
    b = np.concatenate(edge_b, axis=0).reshape(-1)

    # weld: canonical (lo, hi) endpoint key per interpolated vertex
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    keys = lo * (nx * ny * nz) + hi
    uniq, inverse = np.unique(keys, return_inverse=True)
    u_lo = uniq // (nx * ny * nz)
    u_hi = uniq % (nx * ny * nz)

    f_lo = flat[u_lo]
    f_hi = flat[u_hi]
    denom = f_hi - f_lo
    t = np.where(
        np.abs(denom) < 1e-12, 0.5,
        (level - f_lo) / np.where(denom == 0, 1, denom),
    )
    t = np.clip(t, 0.0, 1.0)

    def unflatten(ids: np.ndarray) -> np.ndarray:
        x = ids // (ny * nz)
        rem = ids % (ny * nz)
        return np.stack([x, rem // nz, rem % nz], axis=1).astype(np.float64)

    p_lo = unflatten(u_lo)
    p_hi = unflatten(u_hi)
    vertices = p_lo + t[:, None] * (p_hi - p_lo)
    # per-vertex outward direction (toward increasing field value), used to
    # give all triangles a consistent winding below
    outward = (p_hi - p_lo) * np.sign(f_hi - f_lo)[:, None]
    triangles = inverse.reshape(-1, 3).astype(np.int64)

    # orient: flip any triangle whose face normal opposes the local field
    # gradient, so normals point toward increasing value everywhere
    fn = np.cross(
        vertices[triangles[:, 1]] - vertices[triangles[:, 0]],
        vertices[triangles[:, 2]] - vertices[triangles[:, 0]],
    )
    grad = outward[triangles].sum(axis=1)
    flip = np.sum(fn * grad, axis=1) < 0
    triangles[flip] = triangles[flip][:, [0, 2, 1]]

    # second weld by position: a crossing at t==0/1 sits exactly on a grid
    # corner, so different edges produce coincident vertices
    _, pos_ids, pos_inverse = np.unique(
        np.round(vertices, 9), axis=0, return_index=True, return_inverse=True
    )
    vertices = vertices[pos_ids]
    triangles = pos_inverse[triangles]

    # drop degenerate triangles (two corners welded to the same vertex)
    ok = (
        (triangles[:, 0] != triangles[:, 1])
        & (triangles[:, 1] != triangles[:, 2])
        & (triangles[:, 0] != triangles[:, 2])
    )
    triangles = triangles[ok]

    # drop vertices not referenced by any surviving triangle
    used = np.zeros(vertices.shape[0], dtype=bool)
    used[triangles.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return vertices[used], remap[triangles]
