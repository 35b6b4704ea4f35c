"""The port's own ``utils/mesh_raster.py`` against the JAX package's on
the CPU, bit for bit: the OBJ/MTL loader (polygons, negative indices,
materials), ``normalize_mesh``, the z-buffered ``rasterize`` of a sphere
mesh, and ``apps.recon``'s OBJ read back and rasterized."""
import textwrap

import numpy as np
import pytest

from pixelnerf_tpu.utils import mesh_raster as jax_raster
from pixelnerf_tpu_torch.utils import mesh_raster, recon
from pixelnerf_tpu_torch.utils.geometry import look_at


def _equal(a, b):
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def _uv_sphere(center, radius, n_lat=24, n_lon=48):
    """A latitude-longitude sphere mesh: (V, 3) float32, (F, 3) int32."""
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.sin(lat)[:, None] * np.cos(lon), np.sin(lat)[:, None] * np.sin(lon),
                     np.repeat(np.cos(lat)[:, None], n_lon, 1)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * radius + center
    faces = []
    last = len(verts) - 1
    for j in range(n_lon):
        k = (j + 1) % n_lon
        faces.append([0, 1 + j, 1 + k])
        faces.append([last, 1 + (n_lat - 2) * n_lon + k, 1 + (n_lat - 2) * n_lon + j])
        for i in range(n_lat - 2):
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + k
            faces += [[a, a + n_lon, b], [b, a + n_lon, b + n_lon]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def test_load_obj_polygons_negative_indices_mtl_match_jax(tmp_path):
    (tmp_path / "cube.mtl").write_text(textwrap.dedent("""
        newmtl red
        Kd 0.9 0.1 0.2
        newmtl blue
        Kd 0.1 0.2 0.9
        newmtl broken
        Kd 0.5 x 0.5
        """))
    (tmp_path / "m.obj").write_text(textwrap.dedent("""
        # a unit quad two ways, a pentagon, materials (one missing, one broken)
        mtllib cube.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0.5 1.5 0.25 0.1 0.2 0.3
        usemtl red
        f 1/1 2/2 3/3 4/4
        usemtl blue
        f -5//1 -4//2 -3//3
        usemtl missing
        f 1 2 3 5 4
        usemtl broken
        f 2/1/1 3/2/2 5/3/3
        """))
    got = mesh_raster.load_obj(str(tmp_path / "m.obj"))
    _equal(got, jax_raster.load_obj(str(tmp_path / "m.obj")))
    verts, faces, colors = got
    assert verts.shape == (5, 3) and faces.shape == (7, 3)
    np.testing.assert_array_equal(faces[2], [0, 1, 2])
    np.testing.assert_array_equal(colors[3], mesh_raster.DEFAULT_COLOR)
    (tmp_path / "empty.obj").write_text("v 0 0 0\n")
    for mod in (mesh_raster, jax_raster):
        with pytest.raises(ValueError, match="no renderable geometry"):
            mod.load_obj(str(tmp_path / "empty.obj"))


@pytest.mark.parametrize("z_rot", [0.0, 1.1, -2.7])
def test_normalize_mesh_matches_jax(z_rot):
    verts = np.random.default_rng(0).uniform(-3, 5, size=(200, 3)).astype(np.float32)
    out, (lo, hi), origin = mesh_raster.normalize_mesh(verts, z_rot=z_rot)
    ref, (lo_r, hi_r), origin_r = jax_raster.normalize_mesh(verts, z_rot=z_rot)
    _equal((out, lo, hi, origin), (ref, lo_r, hi_r, origin_r))
    assert abs((hi - lo).max() - 2.0) < 1e-5 and abs(lo[2]) < 1e-5


@pytest.mark.parametrize("bg", [0.0, 1.0])
def test_rasterize_sphere_matches_jax(bg):
    """A sphere mesh seen from an orbit camera: rgb, depth and coverage
    bit-equal, and the silhouette the analytic sphere's to within the
    mesh's facets."""
    H = W = 64
    focal = 1.2 * W
    center = np.array([0.05, -0.1, 0.15], np.float32)
    verts, faces = _uv_sphere(center, 0.5)
    colors = np.random.default_rng(1).uniform(0.2, 1.0, (len(faces), 3)).astype(np.float32)
    pose = look_at(np.array([0.4, 0.3, 2.2], np.float32), np.zeros(3))
    got = mesh_raster.rasterize(verts, faces, colors, pose, H, W, focal, bg=bg)
    _equal(got, jax_raster.rasterize(verts, faces, colors, pose, H, W, focal, bg=bg))
    rgb, depth, alpha = got
    # the analytic silhouette: pixels whose ray passes within the radius
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    d = np.stack([(xs - W / 2) / focal, -(ys - H / 2) / focal, -np.ones_like(xs)], -1) @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    oc = center - pose[:3, 3]
    dist = np.linalg.norm(oc - (d @ oc)[..., None] * d, axis=-1)
    iou = (alpha & (dist < 0.5)).sum() / (alpha | (dist < 0.5)).sum()
    assert iou > 0.95 and alpha.sum() > 200
    assert (rgb[~alpha] == bg).all() and (depth[~alpha] == 0).all() and (depth[alpha] > 1.0).all()


def test_recon_obj_reads_back_and_rasterizes(tmp_path):
    """An OBJ that ``utils.recon.save_obj`` writes with vertex colours (six
    numbers a ``v`` line) loads through both packages' ``load_obj`` to the
    saved vertices and faces, and rasterizes alike to a view that covers
    the surface."""
    g = np.stack(np.meshgrid(*(np.linspace(-1, 1, 24, dtype=np.float32),) * 3, indexing="ij"), -1)
    sigma = np.clip(50.0 * (1.0 - (np.linalg.norm(g, axis=-1) - 0.5) * 10.0), 0, 50).astype(np.float32)
    verts, faces = recon.surface_from_grid(sigma, (-1.0, 1.0), 25.0)
    colors = np.random.default_rng(2).uniform(0, 1, verts.shape).astype(np.float32)
    path = str(tmp_path / "recon.obj")
    recon.save_obj(path, verts, faces, colors)
    got = mesh_raster.load_obj(path)
    _equal(got, jax_raster.load_obj(path))
    v, f, c = got
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)
    assert (c == mesh_raster.DEFAULT_COLOR).all()
    pose = look_at(np.array([0.0, 0.6, 2.5], np.float32), np.zeros(3))
    view = mesh_raster.rasterize(v, f, c, pose, 48, 48, 60.0)
    _equal(view, jax_raster.rasterize(v, f, c, pose, 48, 48, 60.0))
    assert 100 < view[2].sum() < 48 * 48
