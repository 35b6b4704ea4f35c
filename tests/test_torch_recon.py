"""The port's mesh extraction (``utils/recon.py``, ``apps/recon.py``)
against the JAX package's on the CPU: the surface-nets fallback and the OBJ
writer exactly, the sigma grid at the query tolerance, PyMCubes through a
stand-in module, and the app end to end on the same weights and fixture."""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.utils import recon as jax_recon
from pixelnerf_tpu_torch.utils import recon

from torch_port_utils import (
    FOCAL,
    SRN_CONF,
    TINY,
    build_pair,
    source_view,
    t,
    write_jax_reference_weights,
    write_srn_fixture,
)

# the query tolerance of tests/test_torch_models.py (the encoder's 1e-4
# carried through a 5-block MLP)
ATOL, RTOL = 5e-4, 1e-3


def _blobs(reso, seed=0):
    """A sum of random gaussian blobs: several components, holes and
    handles at these sizes."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*(np.linspace(-1, 1, reso),) * 3, indexing="ij"), -1)
    vol = np.zeros((reso,) * 3, np.float32)
    for _ in range(6):
        c = rng.uniform(-0.7, 0.7, 3)
        vol += np.exp(-((g - c) ** 2).sum(-1) / rng.uniform(0.02, 0.1)).astype(np.float32)
    return vol, 0.5


def _sphere(reso):
    """An analytic sphere's sigma: 50 inside radius 0.6, falling off
    linearly outside."""
    g = np.stack(np.meshgrid(*(np.linspace(-1, 1, reso, dtype=np.float32),) * 3, indexing="ij"), -1)
    r = np.linalg.norm(g, axis=-1)
    return np.clip(50.0 * (1.0 - (r - 0.6) * 10.0), 0.0, 50.0).astype(np.float32), 25.0


def _touching(reso):
    """A slab and a cube that reach the grid's faces (cells on the first
    and the last index of every axis are boundary cells)."""
    vol = np.zeros((reso,) * 3, np.float32)
    vol[: reso // 3] = 1.0
    vol[reso // 2 :, reso // 2 :, reso // 2 :] = 1.0
    vol[0, 0, -1] = 1.0
    return vol, 0.5


VOLUMES = {
    "blobs_8": lambda: _blobs(8),
    "blobs_17": lambda: _blobs(17, seed=1),
    "blobs_32": lambda: _blobs(32, seed=2),
    "sphere_24": lambda: _sphere(24),
    "empty_12": lambda: (np.zeros((12, 12, 12), np.float32), 0.5),
    "full_12": lambda: (np.ones((12, 12, 12), np.float32), 0.5),
    "touching_16": lambda: _touching(16),
    "noise_9x11x13": lambda: (np.random.default_rng(3).uniform(0, 1, (9, 11, 13)).astype(np.float32), 0.6),
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_cubes_np_matches_jax(name):
    """The vectorised surface nets give the JAX loop's vertices and faces,
    in its order, with its dtypes (empty and full volumes too)."""
    vol, level = VOLUMES[name]()
    v_ref, f_ref = jax_recon.marching_cubes_np(vol, level)
    v, f = recon.marching_cubes_np(vol, level)
    assert (v.dtype, f.dtype) == (v_ref.dtype, f_ref.dtype) == (np.float32, np.int64)
    assert v.shape == v_ref.shape and f.shape == f_ref.shape
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(f, f_ref)
    if name.startswith(("empty", "full")):
        assert v.shape == (0, 3) and f.shape == (0, 3)
    else:
        assert len(f) > 0


def _jax_query(jnet, variables, enc):
    return jax.jit(lambda xyz, vd, coarse: jnet.apply(variables, enc, xyz, viewdirs=vd, coarse=coarse,
                                                      method=jnet.query), static_argnums=2)


@pytest.fixture(scope="module")
def field():
    """The small SRN-shaped model on both sides, encoded from one view."""
    jnet, variables, tnet, _, _ = build_pair()
    images, poses = source_view()
    enc_j = jnet.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(FOCAL), method=jnet.encode)
    with torch.no_grad():
        enc_t = tnet.encode(t(images), t(poses), FOCAL)
    return _jax_query(jnet, variables, enc_j), lambda xyz, vd, coarse: tnet.query(enc_t, xyz, vd, coarse=coarse)


def test_eval_sigma_grid_matches_jax(field):
    """A 12^3 grid in chunks of 500 points (the last one padded): the
    grid's points bit-equal, sigma at the query tolerance."""
    jq, tq = field
    reso, bounds = (12, 12, 12), (-0.6, 0.6)
    ref = np.asarray(jax_recon.eval_sigma_grid(jq, reso, bounds, chunk=500), np.float32)
    calls = []

    def counted(xyz, vd, coarse):
        calls.append((tuple(xyz.shape), coarse, float(vd.abs().max())))
        return tq(xyz, vd, coarse)

    with torch.no_grad():
        got = recon.eval_sigma_grid(counted, reso, bounds, chunk=500, device="cpu")
    assert got.shape == reso and got.dtype == np.float32
    assert calls == [((1, 500, 3), True, 0.0)] * 4
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert float(ref.std()) > 1e-2
    xs = np.linspace(bounds[0], bounds[1], 12, dtype=np.float32)
    np.testing.assert_array_equal(recon.grid_points(reso, bounds)[:12, 2], xs)


class _FakeMcubes(types.ModuleType):
    """A stand-in for PyMCubes: records its calls and returns the
    surface-nets result in float64, as ``mcubes.marching_cubes`` returns
    float64 vertices."""

    def __init__(self):
        super().__init__("mcubes")
        self.calls = []

    def marching_cubes(self, volume, level):
        self.calls.append((volume.shape, level))
        v, f = jax_recon.marching_cubes_np(volume, level)
        return v.astype(np.float64) + 0.25, f


def test_marching_cubes_uses_mcubes_when_it_imports(monkeypatch):
    """Both packages take PyMCubes when ``import mcubes`` succeeds (a
    stand-in module here) and scale its vertices alike; without it, the
    fallback. The field is a lookup of an analytic sphere's sigma at the
    grid's nodes."""
    vol, level = _sphere(16)

    def lookup(pts):
        i = np.rint((pts + 1.0) * 7.5).astype(np.int64)
        return vol[tuple(i.T)]

    def jax_query(xyz, vd, coarse):
        sig = jnp.asarray(lookup(np.asarray(xyz[0])))
        return jnp.concatenate([jnp.zeros((1, sig.shape[0], 3)), sig[None, :, None]], -1)

    def port_query(xyz, vd, coarse):
        sig = torch.from_numpy(lookup(xyz[0].numpy()))
        return torch.cat([torch.zeros((1, sig.shape[0], 3)), sig[None, :, None]], -1)

    fake = _FakeMcubes()
    monkeypatch.setitem(sys.modules, "mcubes", fake)
    v_ref, f_ref = jax_recon.marching_cubes(jax_query, (16,) * 3, (-1.0, 1.0), level, chunk=1000)
    v, f = recon.marching_cubes(port_query, (16,) * 3, (-1.0, 1.0), level, chunk=1000, device="cpu")
    assert len(fake.calls) == 2 and fake.calls[0] == fake.calls[1] == ((16, 16, 16), level)
    assert v.dtype == v_ref.dtype == np.float32 and len(f) > 0
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(f, f_ref)
    monkeypatch.setitem(sys.modules, "mcubes", None)        # import mcubes raises ImportError
    v2, f2 = recon.marching_cubes(port_query, (16,) * 3, (-1.0, 1.0), level, chunk=1000, device="cpu")
    v2_ref, f2_ref = jax_recon.marching_cubes(jax_query, (16,) * 3, (-1.0, 1.0), level, chunk=1000)
    assert len(fake.calls) == 2
    np.testing.assert_array_equal(v2, v2_ref)
    np.testing.assert_array_equal(f2, f2_ref)
    np.testing.assert_array_equal(f2, f)
    assert not np.array_equal(v2, v)


@pytest.mark.parametrize("with_colors", [False, True])
def test_save_obj_byte_equal(tmp_path, with_colors):
    vol, level = _blobs(14, seed=4)
    verts, faces = jax_recon.marching_cubes_np(vol, level)
    verts = verts * np.float32(2 / 13) - np.float32(1)
    colors = np.random.default_rng(5).uniform(0, 1, (len(verts), 3)).astype(np.float32) if with_colors else None
    jax_recon.save_obj(str(tmp_path / "jax.obj"), verts, faces, colors)
    recon.save_obj(str(tmp_path / "port.obj"), verts, faces, colors)
    data = (tmp_path / "port.obj").read_bytes()
    assert data == (tmp_path / "jax.obj").read_bytes()
    lines = data.decode().splitlines()
    assert len(faces) > 0 and len(lines) == len(verts) + len(faces)
    assert len(lines[0].split()) == (7 if with_colors else 4)


def _parse_obj(path):
    """(the vertex lines' first three fields as text, their colours as
    float32, the face lines as text)."""
    pos, col, faces = [], [], []
    for line in open(path).read().splitlines():
        parts = line.split()
        if parts[0] == "v":
            pos.append(parts[1:4])
            col.append([float(x) for x in parts[4:]])
        else:
            faces.append(line)
    return pos, np.asarray(col, np.float32), faces


def test_recon_app_matches_jax_app(tmp_path, monkeypatch, capsys):
    """``apps.recon`` against ``pixelnerf_tpu.apps.recon`` on one SRN-layout
    fixture and one reference checkpoint, at --reso 20.

    The level is taken from the JAX app's own sigma grid before the port
    runs: the middle of the widest gap between its sorted values between
    the quartiles. The port's grid (captured from its app) is held to the
    JAX grid at the query tolerance and must differ from it by less than
    half that gap, so that a rounding-sized difference cannot flip a cell:
    every cell has the same occupancy in both. Then the OBJ files have the
    same vertex positions (as written text) and the same faces, and the
    vertex colours agree at the query tolerance."""
    from pixelnerf_tpu.apps import recon as jax_app
    from pixelnerf_tpu_torch.apps import recon as port_app

    data = write_srn_fixture(str(tmp_path / "data"), stages=("test",), num_views=3)
    ck = str(tmp_path / "ck")
    write_jax_reference_weights(os.path.join(ck, "ref", "pixel_nerf_latest"))
    common = ["-n", "ref", "-c", SRN_CONF, "-F", "srn", "-D", data, "--checkpoints_path", ck, "-P", "0",
              "--subset", "1", "--reso", "20", "--bounds", "0.9"] + TINY
    grids = {"jax": [], "port": []}
    for name, mod in (("jax", jax_recon), ("port", port_app)):
        grid_fn = mod.eval_sigma_grid
        monkeypatch.setattr(mod, "eval_sigma_grid",
                            lambda *a, _f=grid_fn, _g=grids[name], **k: _g.append(_f(*a, **k)) or _g[-1])
    jax_app.main(common + ["--isosurface", "1.0", "-O", str(tmp_path / "probe")])
    ref = np.asarray(grids["jax"][0], np.float32)
    s = np.sort(ref.ravel())
    window = s[len(s) // 4 : 3 * len(s) // 4]
    gaps = np.diff(window)
    i = int(np.argmax(gaps))
    level = float((window[i] + window[i + 1]) / 2)

    jax_app.main(common + ["--isosurface", repr(level), "-O", str(tmp_path / "jax")])
    res = port_app.main(common + ["--isosurface", repr(level), "-O", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    got = grids["port"][0]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert float(np.abs(got - ref).max()) < gaps[i] / 2, (float(np.abs(got - ref).max()), gaps[i])
    assert "Evaluating sigma grid..." in out and f"{len(res['verts'])} vertices, {len(res['faces'])} faces" in out
    path = str(tmp_path / "port" / "ref_obj1.obj")
    assert res["path"] == path and set(res["ms"]) == {"encode", "grid", "surface", "colors", "write"}
    pos, col, faces = _parse_obj(path)
    pos_ref, col_ref, faces_ref = _parse_obj(str(tmp_path / "jax" / "ref_obj1.obj"))
    assert len(faces) > 100 and len(pos) == len(res["verts"])
    assert pos == pos_ref
    assert faces == faces_ref
    np.testing.assert_allclose(col, col_ref, atol=ATOL, rtol=RTOL)
    assert col.shape == (len(pos), 3) and float(col.std()) > 1e-3
