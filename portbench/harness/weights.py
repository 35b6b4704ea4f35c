"""The model's weights, made on the device from the seed in one draw: the
names and shapes follow from the configuration (torchvision's names for the
ResNet, the field's own names for the two MLPs), each leaf a slice of one
standard normal vector, scaled as below.

The scales make a random field that renders like a scene: He-normal
products, so that activations keep their size through the layers; the
residual branches' second batch norm at half scale, so that the ResNet's
stages do not grow its maps 2x a block; the MLP's latent injections scaled
down by the latent's size; sigma's output row set so that about half of a
ray's light is absorbed, and rgb's small enough that colours stay off the
sigmoid's flat ends (``calibrate_heads``). None of this changes a width."""
from __future__ import annotations

import math

import torch

from . import seeds

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
Z_GAIN = 0.2
HEAD_MEAN = (0.0, 0.0, 0.0, 1.0)
HEAD_STD = (1.5, 1.5, 1.5, 4.0)


def _bn(spec, name, c, gamma=1.0):
    spec += [(f"{name}.weight", (c,), ("bn_w", gamma)), (f"{name}.bias", (c,), ("bn_b",)),
             (f"{name}.running_mean", (c,), ("bn_m",)), (f"{name}.running_var", (c,), ("bn_v",)),
             (f"{name}.num_batches_tracked", (), ("count",))]


def spec(config: dict, d_in: int) -> list:
    """[(name, shape, how)] of every parameter and buffer."""
    enc = config["model"]["encoder"]
    mlp = config["model"]["mlp"]
    out = [("encoder.model.conv1.weight", (64, 3, 7, 7), ("conv",))]
    _bn(out, "encoder.model.bn1", 64)
    cin = 64
    for k in range(1, enc["num_layers"]):
        cout = STAGE_WIDTHS[k - 1]
        for b in range(STAGE_BLOCKS[enc["backbone"]][k - 1]):
            name = f"encoder.model.layer{k}.{b}"
            stride = 2 if (b == 0 and k > 1) else 1
            out.append((f"{name}.conv1.weight", (cout, cin, 3, 3), ("conv",)))
            _bn(out, f"{name}.bn1", cout)
            out.append((f"{name}.conv2.weight", (cout, cout, 3, 3), ("conv",)))
            _bn(out, f"{name}.bn2", cout, gamma=0.5)
            if stride != 1 or cin != cout:
                out.append((f"{name}.downsample.0.weight", (cout, cin, 1, 1), ("conv",)))
                _bn(out, f"{name}.downsample.1", cout)
            cin = cout
    dh, dl = mlp["d_hidden"], enc["latent_size"]
    for m in ("mlp_coarse", "mlp_fine"):
        out += [(f"{m}.lin_in.weight", (dh, d_in), ("lin", 1.0, False)), (f"{m}.lin_in.bias", (dh,), ("bias",))]
        for i in range(min(mlp["combine_layer"], mlp["n_blocks"])):
            out += [(f"{m}.lin_z.{i}.weight", (dh, dl), ("lin", Z_GAIN, False)), (f"{m}.lin_z.{i}.bias", (dh,), ("bias",))]
        for j in range(mlp["n_blocks"]):
            for fc, gain in (("fc_0", 1.0), ("fc_1", 0.5)):
                out += [(f"{m}.blocks.{j}.{fc}.weight", (dh, dh), ("lin", gain, True)),
                        (f"{m}.blocks.{j}.{fc}.bias", (dh,), ("bias",))]
        out += [(f"{m}.lin_out.weight", (4, dh), ("head",)), (f"{m}.lin_out.bias", (4,), ("head_bias",))]
    return out


def make(config: dict, d_in: int, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` (the batch-norm counters int64)."""
    entries = spec(config, d_in)
    sizes = [math.prod(shape) for _, shape, _ in entries]
    noise = torch.randn(sum(sizes), generator=seeds.generator(device, seed, "weights"), device=device)
    weights = {}
    for (name, shape, how), piece in zip(entries, torch.split(noise, sizes)):
        x = piece.view(shape)
        kind = how[0]
        if kind == "conv":
            x = x * math.sqrt(2.0 / x[0].numel())
        elif kind == "bn_w":
            x = how[1] * (1.0 + 0.1 * x)
        elif kind in ("bn_b", "bn_m"):
            x = 0.1 * x
        elif kind == "bn_v":
            x = torch.exp(0.2 * x)
        elif kind == "count":
            x = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "lin":
            x = x * (how[1] * math.sqrt(2.0 / shape[1]))
            if how[2]:
                x = x - x.mean(dim=1, keepdim=True)
        elif kind == "bias":
            x = 0.05 * x
        elif kind == "head":
            x = x - x.mean(dim=1, keepdim=True)
            x = x * math.sqrt(1.0 / shape[1])
        elif kind == "head_bias":
            x = 0.0 * x
        weights[name] = x.contiguous()
    calibrate_heads(weights, config, seed, device)
    return weights


@torch.no_grad()
def calibrate_heads(weights: dict, config: dict, seed: int, device, points: int = 4096) -> None:
    """Set each MLP's output layer so that, over points along camera rays
    through the scene conditioned on probe views made from the seed, the
    pre-activations of rgb spread about 0 (sigmoid's middle) and sigma's
    sit about a mean of 1 with a spread of 4: some space empty, some dense.
    A random ReLU network's outputs are otherwise dominated by an offset
    common to all points, and the field would be empty or solid everywhere.
    The probe runs the plain reference in float32."""
    from ..reference import encoder, field
    from ..reference.precision import exact_float32
    from . import scene

    cam = config["camera"]
    h, w = cam["image_size"]
    ns = config["source_views"]
    gen = seeds.generator(device, seed, "calibration")
    images = scene.smooth_views(gen, ns, h, w, device)
    radius = cam.get("radius") or cam["arc"]["radius"]
    poses = scene.sphere_poses(gen, ns + 1, radius, device)
    focal = torch.tensor(scene.focal_pair(cam), device=device)
    with exact_float32():
        lat = encoder.encode(weights, images, config["model"]["encoder"])
        sc = field.Scene(lat, poses[:ns], focal, torch.tensor(cam["c"], device=device, dtype=torch.float32), (w, h))
        u = torch.rand(points, 3, generator=gen, device=device)
        pix_x, pix_y = u[:, 0] * (w - 1), u[:, 1] * (h - 1)
        d = torch.stack([(pix_x - cam["c"][0]) / focal[0], -(pix_y - cam["c"][1]) / focal[1], -torch.ones_like(pix_x)], -1)
        d = d / d.norm(dim=-1, keepdim=True) @ poses[ns, :3, :3].t()
        z = cam["z_near"] + u[:, 2:] * (cam["z_far"] - cam["z_near"])
        pts = poses[ns, :3, 3] + z * d
        for m in ("mlp_coarse", "mlp_fine"):
            wt, b = weights[f"{m}.lin_out.weight"], weights[f"{m}.lin_out.bias"]
            b.zero_()
            out = field.query(weights, config["model"], sc, pts, d, m == "mlp_coarse", field_raw=True)
            mean, std = out.mean(dim=0), out.std(dim=0).clamp(min=1e-6)
            target_mean = torch.tensor(HEAD_MEAN, device=device)
            target_std = torch.tensor(HEAD_STD, device=device)
            wt.mul_((target_std / std)[:, None])
            b.copy_(target_mean - mean * target_std / std)


def trainable(config: dict, d_in: int) -> list:
    """The parameters' names (the buffers left out)."""
    return [n for n, _, how in spec(config, d_in) if how[0] not in ("bn_m", "bn_v", "count")]
