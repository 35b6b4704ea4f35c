"""Datasets and the training input pipeline (counterpart of
``pixelnerf_tpu/data``). Ported so far: the SRN reader and the synthetic
sphere scenes; the DVR and multi-object readers raise
``NotImplementedError``."""
from __future__ import annotations

from .base import DatasetBase  # noqa: F401
from .pipeline import RayBatchPipeline, gen_rays_at  # noqa: F401
from .srn import SRNDataset  # noqa: F401
from .synthetic import SyntheticSphereDataset  # noqa: F401

NOT_PORTED = ("multi_obj", "dvr", "dvr_gen", "dvr_dtu")


def dataset_kwargs_from_conf(conf) -> dict:
    """``data.*`` config keys (minus ``format``) as dataset constructor
    kwargs, so ``--override data.num_objects=64`` reaches the dataset."""
    return {k: v for k, v in (conf.get("data") or {}).items() if k != "format"}


def get_split_dataset(dataset_type, datadir, want_split="all", training=True, **kwargs):
    """Build dataset(s) for the requested split(s) (``datadir`` is unused
    by the synthetic scenes; ``training`` only changes the DTU reader's
    view cap in the JAX package, which is not ported).

    :param want_split: 'train' | 'val' | 'test' | 'all' (returns a 3-tuple)
    """
    if dataset_type in NOT_PORTED:
        raise NotImplementedError(f"the {dataset_type!r} reader is not ported yet; use 'srn' or 'synthetic'")
    if dataset_type == "srn":
        def build(stage):
            return SRNDataset(datadir, stage=stage, **kwargs)
    elif dataset_type == "synthetic":
        def build(stage):
            return SyntheticSphereDataset(stage=stage, **kwargs)
    else:
        raise NotImplementedError(f"Unsupported dataset type {dataset_type}")

    if want_split in ("train", "val", "test"):
        return build(want_split)
    return build("train"), build("val"), build("test")
