"""pixelNeRF's training step (``train.py`` of the paper's code): encode the
source views with the batch norms on the batch's statistics, render each
object's target rays coarse and fine, the loss the mean squared error of
both passes against the pixels, the gradient by autograd, and one Adam
update (``torch.optim.Adam``'s arithmetic, written out)."""
from __future__ import annotations

import torch

from . import encoder, field, render
from .precision import Precision


def forward_loss(w: dict, cfg: dict, batch: dict, noise: dict, prec: Precision):
    """The step's loss for a batch of tensors (images (SB, NS, H, W, 3),
    poses, focal (SB,), c (SB, 2), rays (SB, R, 8), rgb_gt (SB, R, 3)) and
    its draws (each (SB, R, k))."""
    model, rcfg = cfg["model"], cfg["renderer"]
    sb, ns, h, wd = batch["images"].shape[:4]
    latent = encoder.encode(w, batch["images"].reshape(sb * ns, h, wd, 3), model["encoder"], prec, train=True)
    latent = latent.reshape(sb, ns, *latent.shape[1:])
    loss_c = loss_f = 0.0
    for s in range(sb):
        f = batch["focal"][s]
        scene = field.Scene(latent[s], batch["poses"][s], torch.stack([f, f]), batch["c"][s], (wd, h))

        def fld(pts, dirs, coarse):
            return field.query(w, model, scene, pts, dirs, coarse, prec)

        out = render.render(fld, batch["rays"][s], {k: v[s] for k, v in noise.items()}, rcfg)
        loss_c = loss_c + ((out["coarse"][0] - batch["rgb_gt"][s]) ** 2).mean() / sb
        loss_f = loss_f + ((out["fine"][0] - batch["rgb_gt"][s]) ** 2).mean() / sb
    lc, lf = cfg["loss"]["lambda_coarse"], cfg["loss"]["lambda_fine"]
    return lc * loss_c + lf * loss_f


def train(w: dict, cfg: dict, batches: list, noises: list, prec: Precision = None):
    """Run the steps from the weights ``w`` (left as they are). Returns the
    losses, the first step's gradients and the parameters after the last
    step, by name, of the parameters that ``cfg['trainable']`` names."""
    prec = prec or Precision()
    opt = cfg["optimizer"]
    b1, b2 = opt["betas"]
    names = cfg["trainable"]
    params = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    state = {k: (torch.zeros_like(p), torch.zeros_like(p)) for k, p in params.items()}
    losses, first_grads = [], None
    for t, (batch, noise) in enumerate(zip(batches, noises), start=1):
        cur = dict(w)
        cur.update(params)
        loss = forward_loss(cur, cfg, batch, noise, prec)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m, v = state[k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(opt["eps"])
                params[k].addcdiv_(m, denom, value=-opt["lr"] / (1 - b1 ** t))
    return losses, first_grads, {k: p.detach() for k, p in params.items()}
