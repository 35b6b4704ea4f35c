"""Faults planted underneath the timed path, for the tests and the
calibration that show ``correct`` comes out false: each patches the
program for the duration of a ``with`` block.

- ``stale_state``: a render session renders from the first encoding made
  (its state never updated); a training step leaves the parameters as
  they were (the optimizer's update skipped).
- ``half_batch``: training's loss is the mean over the first half of each
  object's rays; a multi-view render averages the first half of the
  source views at the combine layer.
- ``altered_answer``: a rendered view's rgb raised by 0.05 where the
  renderer returns it; the reader's decoded pixels altered by one level at
  the centre of every view.
"""
from __future__ import annotations

import contextlib

RENDER = ("stale_state", "half_batch", "altered_answer")
TRAIN = ("stale_state", "half_batch", "altered_answer")


def applies(kind: str, fault: str, config: dict) -> bool:
    if kind == "render" and fault == "half_batch":
        return config["source_views"] > 1
    return True


@contextlib.contextmanager
def planted(kind: str, fault: str):
    from unittest import mock

    if kind == "render" and fault == "stale_state":
        from pixelnerf_tpu_torch.models.pixelnerf import PixelNeRFNet

        orig, first = PixelNeRFNet.encode, []

        def encode(self, *args, **kwargs):
            if not first:
                first.append(orig(self, *args, **kwargs))
            return first[0]

        with mock.patch.object(PixelNeRFNet, "encode", encode):
            yield
    elif kind == "train" and fault == "stale_state":
        import torch

        with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
            yield
    elif kind == "train" and fault == "half_batch":
        from pixelnerf_tpu_torch.train import loss

        orig = loss.rgb_loss

        def half(pred, gt, use_l1=False):
            r = pred.shape[1] // 2
            return orig(pred[:, :r], gt[:, :r], use_l1)

        with mock.patch.object(loss, "rgb_loss", half):
            yield
    elif kind == "render" and fault == "half_batch":
        import torch
        from pixelnerf_tpu_torch.models import resnetfc

        def combine(t, inner_dims=(1,), agg_type="average"):
            t = t.reshape(-1, *inner_dims, *t.shape[1:])
            return torch.mean(t[:, : max(1, t.shape[1] // 2)], dim=1)

        with mock.patch.object(resnetfc, "combine_interleaved", combine):
            yield
    elif kind == "render" and fault == "altered_answer":
        from pixelnerf_tpu_torch.eval.common import FullRenderer

        orig = FullRenderer.render_image

        def render_image(self, *args, **kwargs):
            rgb, depth = orig(self, *args, **kwargs)
            return rgb + 0.05, depth

        with mock.patch.object(FullRenderer, "render_image", render_image):
            yield
    elif kind == "train" and fault == "altered_answer":
        from pixelnerf_tpu_torch.data import srn

        orig = srn.imread_many

        def imread_many(paths):
            out = [img.copy() for img in orig(paths)]
            for img in out:
                img[img.shape[0] // 2, img.shape[1] // 2, 0] ^= 1
            return out

        with mock.patch.object(srn, "imread_many", imread_many):
            yield
    else:
        raise ValueError(f"no fault {fault!r} for {kind}")
