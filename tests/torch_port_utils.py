"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

A small SRN-shaped model is built in the JAX package, every parameter and
running statistic (``fc_1`` included) is moved off its initial value with
numpy draws from a seed, and the result is carried into the port through
``from_jax_variables``. Inputs are made with numpy and handed to both sides;
the renderer's random draws are made with ``jax.random`` exactly as the JAX
renderer makes them and injected into the port.
"""
from __future__ import annotations

import json
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from pixelnerf_tpu.config import load_config as jax_load_config
from pixelnerf_tpu.models import make_model as jax_make_model
from pixelnerf_tpu.utils import geometry as jax_geometry
from pixelnerf_tpu_torch.config import load_config
from pixelnerf_tpu_torch.models import load_jax_variables, make_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRN_CONF = os.path.join(REPO, "conf", "exp", "srn.conf")

# small SRN-shaped model: ResNet34 stem + layer1 (128-channel latent),
# ResnetFC 5 blocks with combine_layer 3 at width 64, 16+8 samples
H = W = 32
FOCAL = 30.0
NEAR, FAR = 0.8, 1.8


def small_conf(loader, d_hidden=64, num_layers=2, dtype=None):
    conf = loader(SRN_CONF)
    m = conf["model"]
    m["encoder"]["num_layers"] = num_layers
    for mlp in ("mlp_coarse", "mlp_fine"):
        m[mlp]["d_hidden"] = d_hidden
    if dtype is not None:
        m["dtype"] = dtype
    r = conf["renderer"]
    r["n_coarse"], r["n_fine"], r["n_fine_depth"] = 16, 8, 4
    return conf


def perturb(variables, seed=0):
    """Move every leaf off its init: weights and biases by normal draws at
    the leaf's scale (fc_1 and biases start at 0), running means by normal
    draws, running variances by a factor in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, kind)
                continue
            v = np.asarray(v, np.float32)
            if kind == "batch_stats" and k == "var":
                out[k] = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                continue
            fan_in = int(np.prod(v.shape[:-1])) if v.ndim > 1 else v.shape[0]
            scale = max(float(v.std()), 1.0 / np.sqrt(max(fan_in, 1)))
            out[k] = v + 0.3 * scale * rng.standard_normal(v.shape).astype(np.float32)
        return out

    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def source_view(SB=1, seed=0):
    """Images in [-1, 1] (SB, 1, H, W, 3) and c2w poses (SB, 1, 4, 4)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (SB, 1, H, W, 3)).astype(np.float32)
    poses = np.stack(
        [jax_geometry.look_at(np.array([0.3 * i, 0.4, 1.3], np.float32), np.zeros(3))
         for i in range(SB)]
    )[:, None]
    return images, poses


def novel_rays(seed=1, n_side=8):
    """(1, n_side^2, 8) rays of a novel view around the object."""
    pose = jax_geometry.look_at(np.array([0.9, 0.3, 1.0], np.float32), np.zeros(3))
    rays = np.asarray(jax_geometry.gen_rays(pose[None], n_side, n_side, FOCAL * n_side / W, NEAR, FAR))
    return rays.reshape(1, -1, 8)


def build_pair(d_hidden=64, num_layers=2, dtype=None, seed=0, SB=1):
    """The JAX net with perturbed variables, and the port's net on the CPU
    holding the same weights."""
    jconf = small_conf(jax_load_config, d_hidden, num_layers, dtype)
    jnet = jax_make_model(jconf["model"])
    images, poses = source_view(SB)
    variables = jnet.init(
        jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(FOCAL), jnp.zeros((SB, 4, 3)), jnp.ones((SB, 4, 3)),
    )
    variables = perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)), seed)
    # density bias: a field with sigma ~ 0 renders the white background
    # everywhere, and two constant renders would certify nothing
    for mlp in ("mlp_coarse", "mlp_fine"):
        variables["params"][mlp]["lin_out"]["bias"][3] += 3.0
    tconf = small_conf(load_config, d_hidden, num_layers, dtype)
    tnet = make_model(tconf["model"], device="cpu")
    load_jax_variables(tnet, variables)
    return jnet, variables, tnet, jconf, tconf


# the apps' tests' model: the SRN config narrowed by --override flags
TINY_OVERRIDES = {
    "model.encoder.num_layers": "2", "model.mlp_coarse.d_hidden": "32", "model.mlp_fine.d_hidden": "32",
    "renderer.n_coarse": "8", "renderer.n_fine": "4", "renderer.n_fine_depth": "2",
    "data.image_size": "[32, 32]",
}
TINY = [a for k, v in TINY_OVERRIDES.items() for a in ("--override", f"{k}={v}")]


def write_jax_reference_weights(path):
    """A JAX model of the TINY config, its variables moved off the init,
    written as a reference ``pixel_nerf_latest`` that both packages' apps
    load."""
    from pixelnerf_tpu.train.state import TrainState, export_torch_checkpoint

    conf = jax_load_config(SRN_CONF)
    conf["model"]["encoder"]["num_layers"] = 2
    conf["model"]["mlp_coarse"]["d_hidden"] = conf["model"]["mlp_fine"]["d_hidden"] = 32
    net = jax_make_model(conf["model"])
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)), jnp.tile(jnp.eye(4), (1, 1, 1, 1)),
                         jnp.asarray(40.0), jnp.zeros((1, 4, 3)), jnp.ones((1, 4, 3)))
    variables = perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)), 1)
    for mlp in ("mlp_coarse", "mlp_fine"):
        variables["params"][mlp]["lin_out"]["bias"][3] += 3.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None,
                       step=jnp.zeros((), jnp.int32))
    export_torch_checkpoint(state, path)


def mlp_pair(dtype="float32", d_hidden=64, d_latent=128, seed=0):
    """A JAX ResnetFC (42 -> 5 blocks, combine_layer 3) with perturbed
    variables and the port's ResnetFC holding the same weights."""
    from pixelnerf_tpu.models.resnetfc import ResnetFC as JaxResnetFC
    from pixelnerf_tpu_torch.models import ResnetFC

    jmlp = JaxResnetFC(d_in=42, d_latent=d_latent, n_blocks=5, d_hidden=d_hidden,
                       combine_layer=3, dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(8, d_latent)).astype(np.float32)
    x = rng.normal(size=(8, 42)).astype(np.float32)
    variables = perturb(jax.device_get(jmlp.init(jax.random.PRNGKey(seed), (jnp.asarray(z), jnp.asarray(x)))), seed)
    tmlp = ResnetFC(d_in=42, d_latent=d_latent, n_blocks=5, d_hidden=d_hidden,
                    combine_layer=3, dtype=getattr(torch, dtype))
    load_jax_variables(tmlp, variables)
    return jmlp, variables, tmlp


def port_weights_from_jax(weights):
    """The JAX package's packed weight tuple (matrices (in, out), biases
    (1, n)) as the port's (matrices (out, in), biases 1-D), bf16."""
    names = ("win", "bin", "wz", "bz", "w0", "b0", "w1", "b1", "wout", "bout")
    out = []
    for name, a in zip(names, weights):
        a = torch.from_numpy(np.asarray(a, np.float32))
        a = a.transpose(-1, -2) if name.startswith("w") else a.squeeze(-2)
        out.append(a.contiguous().to(torch.bfloat16))
    return tuple(out)


def jax_draws(key, SB, B, cfg, train=False):
    """The random numbers JAX's ``render_rays`` draws from ``key``, as the
    port's noise dict (numpy -> torch); with ``train`` and
    ``cfg.noise_std > 0`` also the sigma noise of both passes."""
    k_coarse, k_fine, k_depth, k_noise_c, k_noise_f = jax.random.split(key, 5)
    noise = {"coarse": jax.random.uniform(k_coarse, (SB, B, cfg.n_coarse))}
    n_imp = cfg.n_fine - cfg.n_fine_depth
    if cfg.n_fine > 0 and n_imp > 0:
        r1, r2 = jax.random.split(k_fine)
        noise["fine_u"] = jax.random.uniform(r1, (SB, B, n_imp))
        noise["fine_jitter"] = jax.random.uniform(r2, (SB, B, n_imp))
    if cfg.n_fine > 0 and cfg.n_fine_depth > 0:
        noise["depth"] = jax.random.normal(k_depth, (SB, B, cfg.n_fine_depth))
    if train and cfg.noise_std > 0:
        noise["noise_c"] = jax.random.normal(k_noise_c, (SB, B, cfg.n_coarse))
        if cfg.n_fine > 0:
            noise["noise_f"] = jax.random.normal(k_noise_f, (SB, B, cfg.n_coarse + cfg.n_fine))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in noise.items()}


def jax_chunk_draws(key, SB, B, cfg, ray_chunk=None, train=True):
    """The draws of JAX's train render, one noise dict per ray chunk: the
    step's key directly when it does not chunk, else one key per chunk
    from ``jax.random.split(key, n_chunks)`` (``render_rays_chunked``)."""
    if ray_chunk is None or B <= ray_chunk:
        return [jax_draws(key, SB, B, cfg, train)]
    keys = jax.random.split(key, B // ray_chunk)
    return [jax_draws(k, SB, ray_chunk, cfg, train) for k in keys]


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def write_srn_fixture(root, name="cars", stages=("train", "val", "test"), num_objects=2, num_views=3,
                      size=32, nested=False):
    """An SRN-layout dataset ``<root>/<name>_<stage>/<obj>/{intrinsics.txt,
    rgb/*.png, pose/*.txt}`` made from the JAX package's synthetic scenes,
    written with imageio; poses stored before the readers' coordinate flip,
    as SRN stores them. ``nested`` puts the train split's objects one
    level down, in ``chairs_2.0_train`` (SRN's public chairs). Returns the
    dataset path to pass as ``-D``."""
    from pixelnerf_tpu.data import SyntheticSphereDataset as JaxSynthetic

    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    for stage in stages:
        ds = JaxSynthetic(num_objects=num_objects, num_views=num_views, image_size=(size, size),
                          radius=1.3, stage=stage)
        base = os.path.join(root, f"{name}_{stage}")
        if nested and stage == "train":
            base = os.path.join(base, "chairs_2.0_train")
        for i in range(num_objects):
            d = ds[i]
            obj = os.path.join(base, f"{stage}{i}")
            os.makedirs(os.path.join(obj, "rgb"))
            os.makedirs(os.path.join(obj, "pose"))
            with open(os.path.join(obj, "intrinsics.txt"), "w") as f:
                f.write(f"{d['focal']} {d['c'][0]} {d['c'][1]} 0.\n0. 0. 0.\n1.\n{size} {size}\n")
            for v in range(num_views):
                img = ((d["images"][v] * 0.5 + 0.5) * 255).astype(np.uint8)
                imageio.imwrite(os.path.join(obj, "rgb", f"{v:06d}.png"), img)
                np.savetxt(os.path.join(obj, "pose", f"{v:06d}.txt"), (d["poses"][v] @ flip).reshape(1, 16))
    return os.path.join(root, name)


# --- DVR (NMR, DTU) and multi-object fixtures, written with imageio and Pillow ---

_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
_SHAPENET_WORLD = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
_SHAPENET_CAM = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)

DTU_H, DTU_W, DTU_VIEWS = 30, 40, 6
NMR_SIZE, NMR_VIEWS = 16, 4


def _image(rng, h, w):
    """A uint8 RGB image: a gradient (so the row filters matter) and noise."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 5, yy * 7, (xx + yy) * 3], -1)
    return ((base + rng.integers(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def _blob(rng, h, w):
    """A non-empty boolean mask: a random rectangle."""
    m = np.zeros((h, w), bool)
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    m[y0 : y0 + rng.integers(2, h // 2), x0 : x0 + rng.integers(2, w // 2)] = True
    return m


def orbit(i, n, radius):
    """The position of camera i of n on a circle about the y axis, a little
    above the object."""
    return np.array([radius * np.cos(2 * np.pi * i / n), 0.4 * radius, radius * np.sin(2 * np.pi * i / n)],
                    np.float32)


def write_nmr_fixture(root, rng):
    """An NMR-layout category of 4 objects x NMR_VIEWS views: 8-bit masks
    for even objects, Pillow 1-bit masks for odd ones; ``world_mat`` (3x4
    or 4x4) or ``world_mat_inv``; the softras_ and gen_ split lists."""
    cat = os.path.join(root, "02958343")
    names = [f"obj{i}" for i in range(4)]
    for i, name in enumerate(names):
        obj = os.path.join(cat, name)
        os.makedirs(os.path.join(obj, "image"))
        os.makedirs(os.path.join(obj, "mask"))
        cams = {}
        for v in range(NMR_VIEWS):
            imageio.imwrite(os.path.join(obj, "image", f"{v:04d}.png"), _image(rng, NMR_SIZE, NMR_SIZE))
            m = _blob(rng, NMR_SIZE, NMR_SIZE)
            mask_path = os.path.join(obj, "mask", f"{v:04d}.png")
            if i % 2:
                Image.fromarray(m).save(mask_path)
            else:
                imageio.imwrite(mask_path, m.astype(np.uint8) * 255)
            c2w = jax_geometry.look_at(orbit(v, NMR_VIEWS, 2.0), np.zeros(3))
            world_mat = np.linalg.inv(np.linalg.inv(_SHAPENET_WORLD) @ c2w @ np.linalg.inv(_SHAPENET_CAM))
            if i == 1:
                cams[f"world_mat_inv_{v}"] = np.linalg.inv(world_mat).astype(np.float32)
            cams[f"world_mat_{v}"] = (world_mat[:3] if i == 2 else world_mat).astype(np.float32)
            f_norm = 1.75
            cams[f"camera_mat_{v}"] = np.diag([f_norm, f_norm, 1.0, 1.0]).astype(np.float32)
        np.savez(os.path.join(obj, "cameras.npz"), **cams)
    for prefix in ("softras_", "gen_"):
        for split, objs in (("train", names[:2]), ("val", names[2:3]), ("test", names[1:])):
            if prefix == "gen_":
                objs = objs[::-1]
            with open(os.path.join(cat, f"{prefix}{split}.lst"), "w") as f:
                f.write("\n".join(objs) + "\n")
    return root


def dtu_camera(rng, v, n_views, s):
    """One DTU-like view: P = s K [R | t] (K off-centre, fx != fy) and its
    scale_mat, from a camera orbiting the normalised object. A negative s
    gives K a negative K[2, 2] in the decomposition (cv2's and the port's
    alike), so the reader's fx and fy change sign."""
    K = np.array([[36.0 + rng.uniform(-1, 1), 0.2, DTU_W / 2 + 3.5 + rng.uniform(-0.5, 0.5)],
                  [0, 35.0 + rng.uniform(-1, 1), DTU_H / 2 - 2.5 + rng.uniform(-0.5, 0.5)], [0, 0, 1]])
    scale, trans = 200.0, np.array([10.0, -20.0, 600.0])
    pose_cv = _FLIP @ jax_geometry.look_at(orbit(v, n_views, 2.5), np.zeros(3)) @ _FLIP
    centre = scale * pose_cv[:3, 3] + trans
    r_w2c = pose_cv[:3, :3].T
    P = s * K @ np.concatenate([r_w2c, (-r_w2c @ centre)[:, None]], 1)
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= scale
    scale_mat[:3, 3] = trans
    return np.vstack([P, [0, 0, 0, 1]]).astype(np.float32), scale_mat.astype(np.float32)


def write_dtu_fixture(root, rng, scans=3, views=DTU_VIEWS):
    """A DTU-layout ``DTU`` directory: ``scanN/image/*.png`` (DTU_W x DTU_H
    RGB), ``cameras.npz`` (world_mat_i, scale_mat_i) and new_*.lst; the
    last scan (val and test) has projection matrices of negative scale."""
    cat = os.path.join(root, "DTU")
    names = [f"scan{i + 1}" for i in range(scans)]
    for n, name in enumerate(names):
        os.makedirs(os.path.join(cat, name, "image"))
        cams = {}
        for v in range(views):
            imageio.imwrite(os.path.join(cat, name, "image", f"{v:06d}.png"), _image(rng, DTU_H, DTU_W))
            s = -1.3 if n == scans - 1 else 0.8 + 0.1 * (v % 3)
            cams[f"world_mat_{v}"], cams[f"scale_mat_{v}"] = dtu_camera(rng, v, views, s)
        np.savez(os.path.join(cat, name, "cameras.npz"), **cams)
    for split, objs in (("train", names[:2]), ("val", names[2:]), ("test", names[2:])):
        with open(os.path.join(cat, f"new_{split}.lst"), "w") as f:
            f.write("\n".join(objs) + "\n")
    return root


def write_multi_obj_fixture(root, rng):
    """Multi-object scenes: in train/ two of 3 frames (one frame fully
    transparent) and one of 2 frames (the n_views sentinel's case); in
    test/ one of 3 frames."""
    for stage, k, n_frames in (("train", 0, 3), ("train", 1, 2), ("train", 2, 3), ("test", 3, 3)):
        scene = os.path.join(root, stage, f"{k:05d}")
        os.makedirs(scene)
        frames = []
        for f in range(n_frames):
            rgba = np.concatenate([_image(rng, 12, 12), (_blob(rng, 12, 12) * 255).astype(np.uint8)[..., None]], -1)
            if k == 2 and f == 1:
                rgba[:] = 0
            imageio.imwrite(os.path.join(scene, f"r_{f}_obj.png"), rgba)
            frames.append({"file_path": f"./r_{f}", "transform_matrix": jax_geometry.look_at(
                orbit(f, n_frames, 6.0), np.zeros(3)).tolist()})
        with open(os.path.join(scene, "transforms.json"), "w") as fh:
            json.dump({"camera_angle_x": 0.69 + 0.01 * k, "frames": frames}, fh)
    return root
