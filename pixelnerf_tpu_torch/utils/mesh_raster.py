"""Pure-numpy OBJ loading and z-buffer triangle rasterization (counterpart
of ``pixelnerf_tpu/utils/mesh_raster.py``, the port's own copy; results
equal the JAX module's bit for bit).

A host-side tool: it renders OBJ meshes (ShapeNet models, or the meshes
``apps.recon`` writes) into RGB, depth and coverage passes without a
Blender install. Per-triangle work is vectorized over the triangle's pixel
bounding box, so meshes with tens of thousands of faces render a 128x128
view in about a second.

Rendering model: perspective pinhole camera (OpenGL/Blender convention:
the camera looks down -Z, +Y up), z-buffered rasterization, flat per-face
Lambertian shading with double-sided normals (ShapeNet windings are
inconsistent), diffuse colours from .mtl ``Kd`` when present. Output
passes: RGB, camera-space depth, coverage alpha.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


# --------------------------------------------------------------------------
# OBJ / MTL loading
# --------------------------------------------------------------------------


def _parse_mtl(path: str) -> Dict[str, np.ndarray]:
    """Material name -> diffuse Kd color. Missing/invalid entries skipped."""
    colors: Dict[str, np.ndarray] = {}
    if not os.path.isfile(path):
        return colors
    cur = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl" and len(parts) > 1:
                cur = parts[1]
            elif parts[0] == "Kd" and cur is not None and len(parts) >= 4:
                try:
                    colors[cur] = np.array(
                        [float(parts[1]), float(parts[2]), float(parts[3])],
                        np.float32,
                    )
                except ValueError:
                    pass
    return colors


DEFAULT_COLOR = np.array([0.65, 0.65, 0.65], np.float32)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a Wavefront OBJ (with optional .mtl diffuse colors).

    Handles ``v``/``f`` records, ``f`` entries of the form ``v``, ``v/vt``,
    ``v//vn``, ``v/vt/vn``, negative (relative) indices, and polygon faces
    (fan-triangulated). Geometry-only — textures are reduced to the
    material's ``Kd``.

    :return: (verts (V,3) f32, faces (F,3) i32, face_colors (F,3) f32)
    """
    verts = []
    faces = []
    face_colors = []
    materials: Dict[str, np.ndarray] = {}
    color = DEFAULT_COLOR
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                verts.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif tag == "mtllib" and len(parts) > 1:
                materials.update(_parse_mtl(os.path.join(base, parts[1])))
            elif tag == "usemtl" and len(parts) > 1:
                color = materials.get(parts[1], DEFAULT_COLOR)
            elif tag == "f" and len(parts) >= 4:
                nv = len(verts)
                idx = []
                for p in parts[1:]:
                    s = p.split("/")[0]
                    if not s:
                        continue
                    i = int(s)
                    idx.append(i - 1 if i > 0 else nv + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    face_colors.append(color)
    if not verts or not faces:
        raise ValueError(f"no renderable geometry in {path}")
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.stack(face_colors).astype(np.float32),
    )


# --------------------------------------------------------------------------
# Mesh normalization (reference render_shapenet.py:35-81 semantics)
# --------------------------------------------------------------------------


def normalize_mesh(
    verts: np.ndarray, z_rot: float = 0.0
) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Spin around world z, scale so the bbox's largest extent is 2 units,
    rest the bbox bottom on z=0 (the reference's import normalization:
    join -> random z-rotation -> diameter ~2 -> rest on floor).

    OBJ files are y-up (imported with axis_forward=-Z, axis_up=Y, i.e. the
    mesh is re-oriented into Blender's z-up world); apply that re-orientation
    first: (x, y, z)_obj -> (x, -z, y)_world.

    :return: (normalized verts, (bbox_lo, bbox_hi), origin) where ``origin``
        is the world position of the OBJ file's origin after normalization —
        the analog of Blender's ``obj.location`` after the rest shift (the
        reference renderer aims its camera at this point, not at the floor).
    """
    v = np.stack([verts[:, 0], -verts[:, 2], verts[:, 1]], axis=-1)
    c, s = np.cos(z_rot), np.sin(z_rot)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    v = v @ rot.T
    lo, hi = v.min(axis=0), v.max(axis=0)
    scale = 2.0 / float((hi - lo).max())
    v = v * scale
    z_shift = -lo[2] * scale
    v[:, 2] += z_shift
    lo, hi = v.min(axis=0), v.max(axis=0)
    origin = np.array([0.0, 0.0, z_shift], np.float32)
    return (
        v.astype(np.float32),
        (lo.astype(np.float32), hi.astype(np.float32)),
        origin,
    )


# --------------------------------------------------------------------------
# Rasterizer
# --------------------------------------------------------------------------


def rasterize(
    verts: np.ndarray,
    faces: np.ndarray,
    face_colors: np.ndarray,
    c2w: np.ndarray,
    H: int,
    W: int,
    focal: float,
    light_dir=(0.4, 0.35, -0.85),
    ambient: float = 0.35,
    bg: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffer rasterization of a triangle mesh from a pinhole camera.

    :param c2w: (4,4) camera-to-world, OpenGL/Blender convention
        (camera -Z forward, +Y up) — the same convention
        ``utils.geometry.look_at`` produces.
    :return: (rgb (H,W,3) f32 in [0,1] with `bg` background,
              depth (H,W) f32 camera-space hit distance along -Z (0=miss),
              alpha (H,W) bool coverage)
    """
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    cam = verts @ w2c[:3, :3].T + w2c[:3, 3]          # (V, 3) camera space
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)

    # flat shading in WORLD space (light is a world-space sun)
    tri_w = verts[faces]                               # (F, 3, 3)
    n = np.cross(tri_w[:, 1] - tri_w[:, 0], tri_w[:, 2] - tri_w[:, 0])
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(nl, 1e-12)
    lam = np.abs(n @ light)                            # double-sided
    shade = np.clip(ambient + (1.0 - ambient) * lam, 0.0, 1.0)
    tri_rgb = np.clip(face_colors * shade[:, None], 0.0, 1.0)  # (F, 3)

    # project: u = cx + f*x/(-z), v = cy - f*y/(-z)
    tri = cam[faces]                                   # (F, 3, 3)
    z = tri[..., 2]
    # keep triangles fully in front of the camera (orbit cameras never
    # straddle the near plane for normalized scenes; clipping not needed)
    keep = np.all(z < -1e-6, axis=-1)
    degenerate = nl[:, 0] < 1e-12
    keep &= ~degenerate
    tri, z = tri[keep], z[keep]
    tri_rgb = tri_rgb[keep]
    if tri.shape[0] == 0:
        rgb = np.full((H, W, 3), bg, np.float32)
        return rgb, np.zeros((H, W), np.float32), np.zeros((H, W), bool)
    inv_z = -1.0 / z                                   # (F, 3) positive
    u = W * 0.5 + focal * tri[..., 0] * inv_z
    v = H * 0.5 - focal * tri[..., 1] * inv_z
    pts = np.stack([u, v], axis=-1)                    # (F, 3, 2) pixel space

    zbuf = np.full((H, W), np.inf, np.float64)
    rgb = np.full((H, W, 3), bg, np.float64)
    alpha = np.zeros((H, W), bool)

    # pixel-center sample grid
    lo = np.floor(pts.min(axis=1)).astype(np.int64)    # (F, 2)
    hi = np.ceil(pts.max(axis=1)).astype(np.int64)
    lo = np.clip(lo, 0, [W - 1, H - 1])
    hi = np.clip(hi, 0, [W, H])
    # skip triangles projecting entirely off-screen or to empty boxes
    ok = (hi[:, 0] > lo[:, 0]) & (hi[:, 1] > lo[:, 1])
    order = np.nonzero(ok)[0]

    for fi in order:
        (x0, y0), (x1, y1) = lo[fi], hi[fi]
        a, b, c = pts[fi]
        # edge functions at integer pixel coordinates — the framework's ray
        # convention casts rays through integer (x, y) (unproj_map /
        # reference util.py:113-143), so sample where the NeRF will sample
        xs = np.arange(x0, x1, dtype=np.float64)
        ys = np.arange(y0, y1, dtype=np.float64)
        px, py = np.meshgrid(xs, ys, indexing="xy")
        d = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(d) < 1e-12:
            continue
        w0 = ((b[0] - px) * (c[1] - py) - (b[1] - py) * (c[0] - px)) / d
        w1 = ((c[0] - px) * (a[1] - py) - (c[1] - py) * (a[0] - px)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z linearly in screen space
        izs = w0 * inv_z[fi, 0] + w1 * inv_z[fi, 1] + w2 * inv_z[fi, 2]
        depth = 1.0 / np.maximum(izs, 1e-12)
        tile = zbuf[y0:y1, x0:x1]
        win = inside & (depth < tile)
        if not win.any():
            continue
        tile[win] = depth[win]
        rgb[y0:y1, x0:x1][win] = tri_rgb[fi]
        alpha[y0:y1, x0:x1][win] = True

    depth_out = np.where(alpha, zbuf, 0.0).astype(np.float32)
    return rgb.astype(np.float32), depth_out, alpha
