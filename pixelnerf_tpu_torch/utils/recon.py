"""Mesh extraction from a trained field (counterpart of
``pixelnerf_tpu/utils/recon.py``).

Evaluates sigma on a chunked 3-D grid on the model's device, then extracts
an isosurface on the host: with PyMCubes when it is installed, else with a
numpy surface-nets fallback whose vertices and faces equal the JAX
package's exactly. Vertex colours come from querying the field at the
vertices.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def grid_points(reso: Tuple[int, int, int], bounds: Tuple[float, float]) -> np.ndarray:
    """The (X*Y*Z, 3) float32 grid of :func:`eval_sigma_grid`, built in numpy
    as the JAX package builds it (``torch.linspace`` rounds differently)."""
    xs, ys, zs = (np.linspace(bounds[0], bounds[1], n, dtype=np.float32) for n in reso)
    return np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)


def query_padded(query_fn, pts: np.ndarray, chunk: int, coarse: bool, device) -> torch.Tensor:
    """``query_fn`` over (N, 3) float32 points in chunks of ``chunk``, the
    last one padded with zero points, zero view directions: (N, 4) on
    ``device``."""
    dirs = torch.zeros((1, chunk, 3), device=device)
    outs = []
    for i in range(0, pts.shape[0], chunk):
        part = pts[i : i + chunk]
        n = part.shape[0]
        if n < chunk:
            part = np.concatenate([part, np.zeros((chunk - n, 3), np.float32)])
        outs.append(query_fn(torch.from_numpy(part[None]).to(device), dirs, coarse)[0, :n])
    return torch.cat(outs)


def eval_sigma_grid(
    query_fn,
    reso: Tuple[int, int, int] = (128, 128, 128),
    bounds: Tuple[float, float] = (-1.0, 1.0),
    chunk: int = 65536,
    coarse: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Evaluate sigma over a regular grid.

    :param query_fn: ``query_fn(xyz (1, B, 3), viewdirs (1, B, 3), coarse)
        -> (1, B, 4)`` on tensors on ``device``. The view directions are
        zeros, as in the reference, so the result is approximate for
        view-dependent models
    :return: the (X, Y, Z) float32 sigma volume, in numpy
    """
    out = query_padded(query_fn, grid_points(reso, bounds), chunk, coarse, device)
    return out[:, 3].float().cpu().numpy().reshape(reso)


def marching_cubes_np(volume: np.ndarray, level: float):
    """Midpoint surface nets, the fallback when PyMCubes is missing: one
    vertex per boundary cell (a cell whose occupancy ``volume > level``
    differs from a neighbour's), at the cell's integer coordinates, and a
    quad of two triangles across every sign change between two cells.

    Vectorised over the cells, in the JAX package's loop order: vertices in
    ``np.argwhere`` order; faces axis by axis, cells in coordinate order
    within an axis, each quad as ``(q0, q1, q2), (q0, q2, q3)``.

    :return: (verts (V, 3) float32, faces (F, 3) int64)
    """
    v = volume > level
    boundary = np.zeros(v.shape, dtype=bool)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        diff = v[tuple(lo)] != v[tuple(hi)]
        boundary[tuple(lo)] |= diff
        boundary[tuple(hi)] |= diff
    coords = np.argwhere(boundary)
    idx = -np.ones(v.shape, dtype=np.int64)
    idx[tuple(coords.T)] = np.arange(coords.shape[0])
    verts = coords.astype(np.float32)

    faces = []
    for axis in range(3):
        a1, a2 = (axis + 1) % 3, (axis + 2) % 3
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        # cells whose occupancy changes towards their +axis neighbour, with
        # the quad's other three cells (one and two steps back along a1, a2)
        # inside the grid
        change = np.argwhere(v[tuple(lo)] != v[tuple(hi)])
        change = change[(change[:, a1] >= 1) & (change[:, a2] >= 1)]
        quad = []
        for da, db in ((0, 0), (1, 0), (1, 1), (0, 1)):
            q = change.copy()
            q[:, a1] -= da
            q[:, a2] -= db
            quad.append(idx[tuple(q.T)])
        quad = np.stack(quad, axis=-1)                       # (n, 4)
        quad = quad[(quad >= 0).all(axis=-1)]
        tris = np.stack([quad[:, [0, 1, 2]], quad[:, [0, 2, 3]]], axis=1)
        faces.append(tris.reshape(-1, 3))
    faces = np.concatenate(faces).astype(np.int64)
    return verts, faces


def surface_from_grid(sigma: np.ndarray, bounds=(-1.0, 1.0), isosurface: float = 50.0):
    """(vertices in world coordinates, triangles) of a sigma volume at the
    level ``isosurface``: PyMCubes when it imports, else
    :func:`marching_cubes_np`. The vertex scaling runs in float64 and is
    cast to float32 last, as in the JAX package."""
    try:
        import mcubes  # optional

        verts, faces = mcubes.marching_cubes(sigma, isosurface)
    except ImportError:
        verts, faces = marching_cubes_np(sigma, isosurface)
    scale = (bounds[1] - bounds[0]) / (np.asarray(sigma.shape) - 1)
    verts = verts * scale + bounds[0]
    return verts.astype(np.float32), faces


def marching_cubes(
    query_fn,
    reso=(128, 128, 128),
    bounds=(-1.0, 1.0),
    isosurface: float = 50.0,
    chunk: int = 65536,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (vertices in world coords, triangles) at the given sigma level."""
    sigma = eval_sigma_grid(query_fn, reso, bounds, chunk, device=device)
    return surface_from_grid(sigma, bounds, isosurface)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Write a Wavefront OBJ (with per-vertex colours if given) from numpy
    arrays, with the JAX package's formatting: the same arrays give the
    same bytes."""
    with open(path, "w") as f:
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
