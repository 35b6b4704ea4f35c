"""Datasets and the training input pipeline (counterpart of
``pixelnerf_tpu/data``). Ported so far: the synthetic sphere scenes; the
SRN, DVR and multi-object readers raise ``NotImplementedError``."""
from __future__ import annotations

from .base import DatasetBase  # noqa: F401
from .pipeline import RayBatchPipeline, gen_rays_at  # noqa: F401
from .synthetic import SyntheticSphereDataset  # noqa: F401

NOT_PORTED = ("srn", "multi_obj", "dvr", "dvr_gen", "dvr_dtu")


def dataset_kwargs_from_conf(conf) -> dict:
    """``data.*`` config keys (minus ``format``) as dataset constructor
    kwargs, so ``--override data.num_objects=64`` reaches the dataset."""
    return {k: v for k, v in (conf.get("data") or {}).items() if k != "format"}


def get_split_dataset(dataset_type, datadir, want_split="all", **kwargs):
    """Build dataset(s) for the requested split(s) (``datadir`` is unused
    by the synthetic scenes).

    :param want_split: 'train' | 'val' | 'test' | 'all' (returns a 3-tuple)
    """
    if dataset_type in NOT_PORTED:
        raise NotImplementedError(f"the {dataset_type!r} reader is not ported yet; use 'synthetic'")
    if dataset_type != "synthetic":
        raise NotImplementedError(f"Unsupported dataset type {dataset_type}")

    def build(stage):
        return SyntheticSphereDataset(stage=stage, **kwargs)

    if want_split in ("train", "val", "test"):
        return build(want_split)
    return build("train"), build("val"), build("test")
