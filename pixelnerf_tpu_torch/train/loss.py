"""Training losses (counterpart of ``pixelnerf_tpu/train/loss.py``): the
coarse + fine RGB loss, MSE or L1, and the uncertainty-weighted fine loss
behind ``loss.rgb_fine.use_uncertainty``."""
from __future__ import annotations

import torch


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor, use_l1: bool = False) -> torch.Tensor:
    if use_l1:
        return torch.mean(torch.abs(pred - gt))
    return torch.mean((pred - gt) ** 2)


def rgb_loss_with_uncertainty(
    pred: torch.Tensor, gt: torch.Tensor, betas: torch.Tensor, use_l1: bool = False
) -> torch.Tensor:
    """Kendall'17: per-ray error / beta + mean log beta."""
    if use_l1:
        err = torch.mean(torch.abs(pred - gt), dim=-1)
    else:
        err = torch.mean((pred - gt) ** 2, dim=-1)
    return torch.mean(err / betas) + torch.mean(torch.log(betas))


def make_render_loss(conf):
    """Build ``loss_fn(outputs, rgb_gt) -> (loss, {'rc', 'rf', 't'})`` from
    a 'loss' config subtree.

    With ``rgb_fine.use_uncertainty`` the fine pass uses
    :func:`rgb_loss_with_uncertainty` on ``outputs['fine']['betas']``; the
    renderer produces no betas, so that config raises a ValueError that
    says so (in the reference it is a TypeError).
    """
    lambda_coarse = conf.get_float("lambda_coarse", 1.0)
    lambda_fine = conf.get_float("lambda_fine", 1.0)
    coarse_conf = conf.get_config("rgb", None)
    use_l1_coarse = coarse_conf.get_bool("use_l1", False) if coarse_conf else False
    fine_conf = conf.get_config("rgb_fine", None)
    use_l1_fine = fine_conf.get_bool("use_l1", False) if fine_conf else use_l1_coarse
    use_uncertainty = fine_conf.get_bool("use_uncertainty", False) if fine_conf else False

    def loss_fn(outputs, rgb_gt):
        rc = rgb_loss(outputs["coarse"]["rgb"], rgb_gt, use_l1_coarse)
        loss = lambda_coarse * rc
        losses = {"rc": rc}
        if "fine" in outputs:
            if use_uncertainty:
                if "betas" not in outputs["fine"]:
                    raise ValueError(
                        "loss.rgb_fine.use_uncertainty=true but the render outputs carry "
                        "no fine betas; provide outputs['fine']['betas'] of shape "
                        "(..., n_rays) or unset the flag"
                    )
                rf = rgb_loss_with_uncertainty(
                    outputs["fine"]["rgb"], rgb_gt, outputs["fine"]["betas"], use_l1_fine
                )
            else:
                rf = rgb_loss(outputs["fine"]["rgb"], rgb_gt, use_l1_fine)
            loss = loss + lambda_fine * rf
            losses["rf"] = rf
        losses["t"] = loss
        return loss, losses

    return loss_fn
