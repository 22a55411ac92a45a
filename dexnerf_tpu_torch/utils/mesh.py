"""σ-field → triangle mesh via marching tetrahedra (numpy only).

The port's own copy of ``dexnerf_tpu/utils/mesh.py`` (the port imports
nothing of the JAX package). It extracts the σ = m isosurface, the density
threshold family of the Dex-NeRF depth (``volume_rendering_utils.py:51-58``),
from a dense σ grid: each grid cell splits into 6 tetrahedra (Kuhn's
subdivision), and each tetrahedron's 16 inside/outside cases reduce to
three shapes (1 vertex in → 1 triangle, 2 in → 2 triangles, 3 in → 1
triangle), vectorized over cells. The faces are wound by the field's
gradient so that normals point outward. The writer is an ASCII PLY.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Kuhn's 6-tetrahedra subdivision of the cube: one tet per axis
# permutation along the 0 -> 7 main diagonal (corner i has bits x=1, y=2,
# z=4). Kuhn's triangulation is CONSISTENT across neighboring cells —
# every cube face's diagonal runs from the face's min corner to its max
# corner, identical as seen from either side — so the extracted surface
# has matching triangles on shared faces (closed surfaces come out
# edge-manifold; the 0-6-diagonal table does not have this property).
_TETS = np.asarray(
    [
        (0, 1, 3, 7),
        (0, 1, 5, 7),
        (0, 2, 3, 7),
        (0, 2, 6, 7),
        (0, 4, 5, 7),
        (0, 4, 6, 7),
    ],
    np.int32,
)
_CORNER_OFFSETS = np.asarray(
    [[(i >> s) & 1 for s in (0, 1, 2)] for i in range(8)], np.int32
)


def _interp(p_a, v_a, p_b, v_b, iso):
    """Linear iso-crossing point on edge a-b, direction-independent."""
    denom = v_b - v_a
    t = np.where(np.abs(denom) > 1e-12, (iso - v_a) / denom, 0.5)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p_a + t * (p_b - p_a)


def marching_tetrahedra(
    values: np.ndarray,
    iso: float,
    *,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``values == iso`` surface from a dense [X, Y, Z] grid.

    Returns ``(vertices [V, 3], faces [F, 3])`` with deduplicated
    vertices. "Inside" is ``values >= iso``. ``origin``/``spacing`` place
    the grid in world space.
    """
    v = np.asarray(values, np.float32)
    if v.ndim != 3:
        raise ValueError(f"values must be [X, Y, Z], got {v.shape}")
    nx, ny, nz = v.shape
    origin = np.asarray(origin, np.float32)
    spacing = np.asarray(spacing, np.float32)

    # per-cell corner values [M, 8] and corner grid coords [M, 8, 3]
    ix, iy, iz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
        indexing="ij",
    )
    base = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)  # [M, 3]
    corners = base[:, None, :] + _CORNER_OFFSETS[None, :, :]  # [M, 8, 3]
    vals = v[corners[..., 0], corners[..., 1], corners[..., 2]]  # [M, 8]
    pos = origin + corners.astype(np.float32) * spacing  # [M, 8, 3]

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # [M, 4]
        tp = pos[:, tet]  # [M, 4, 3]
        inside = tv >= iso
        case = (
            inside[:, 0] * 1 + inside[:, 1] * 2
            + inside[:, 2] * 4 + inside[:, 3] * 8
        )

        def edge_point(sel, a, b):
            return _interp(
                tp[sel, a], tv[sel, a], tp[sel, b], tv[sel, b], iso
            )

        # one vertex inside (or its complement, three inside): a single
        # triangle on the three edges incident to that vertex
        for bit, (i, j, k, l) in enumerate(
            [(0, 1, 2, 3), (1, 0, 2, 3), (2, 0, 1, 3), (3, 0, 1, 2)]
        ):
            for c, flip in ((1 << bit, False), (15 ^ (1 << bit), True)):
                sel = case == c
                if not sel.any():
                    continue
                p1 = edge_point(sel, i, j)
                p2 = edge_point(sel, i, k)
                p3 = edge_point(sel, i, l)
                tri = (
                    np.stack([p1, p3, p2], axis=1) if flip
                    else np.stack([p1, p2, p3], axis=1)
                )
                tris.append(tri)

        # two vertices inside: a quad (two triangles) on the four edges
        # crossing to the two outside vertices
        for (i, j, k, l) in (
            (0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2),
        ):
            for (a, b), flip in (((i, j), False), ((k, l), True)):
                c = (1 << a) | (1 << b)
                sel = case == c
                if not sel.any():
                    continue
                o1, o2 = [x for x in (0, 1, 2, 3) if x not in (a, b)]
                p1 = edge_point(sel, a, o1)
                p2 = edge_point(sel, a, o2)
                p3 = edge_point(sel, b, o2)
                p4 = edge_point(sel, b, o1)
                if flip:
                    tris.append(np.stack([p1, p3, p2], axis=1))
                    tris.append(np.stack([p1, p4, p3], axis=1))
                else:
                    tris.append(np.stack([p1, p2, p3], axis=1))
                    tris.append(np.stack([p1, p3, p4], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    soup = np.concatenate(tris, axis=0)  # [F, 3, 3]
    flat = soup.reshape(-1, 3)
    # deduplicate vertices (quantized) -> indexed faces
    key = np.round(flat / (spacing.min() * 1e-4)).astype(np.int64)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    counts = np.zeros((uniq.shape[0],), np.int64)
    np.add.at(verts, inverse, flat.astype(np.float64))
    np.add.at(counts, inverse, 1)
    verts = (verts / counts[:, None]).astype(np.float32)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces (two corners merged by the quantization)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # Consistent winding via the FIELD, not per-case tables (the fiddly
    # part tetrahedra tables classically get wrong): the value gradient
    # points toward the inside (values rise across the iso surface), so
    # flip any face whose normal agrees with it — normals then point
    # outward everywhere.
    gx, gy, gz = np.gradient(v)
    cent = verts[faces].mean(axis=1)  # [F, 3] world
    gi = np.clip(
        np.round((cent - origin) / spacing).astype(np.int64),
        0, np.asarray([nx - 1, ny - 1, nz - 1]),
    )
    grad = np.stack(
        [g[gi[:, 0], gi[:, 1], gi[:, 2]] for g in (gx, gy, gz)], axis=-1
    )
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    flip = np.einsum("ij,ij->i", n, grad) > 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def write_ply_mesh(
    path: str, vertices: np.ndarray, faces: np.ndarray
) -> None:
    """ASCII PLY triangle mesh writer."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {vertices.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {faces.shape[0]}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for p in vertices:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
