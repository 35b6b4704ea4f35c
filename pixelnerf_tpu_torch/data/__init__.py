"""Datasets and the training input pipeline (counterpart of
``pixelnerf_tpu/data``): the SRN, DVR (NMR ShapeNet and DTU) and
multi-object readers, DTU's colour jitter and the synthetic sphere scenes.

Formats: srn | dvr | dvr_gen | dvr_dtu | multi_obj | synthetic.
"""
from __future__ import annotations

from .base import DatasetBase  # noqa: F401
from .color_jitter import ColorJitterDataset  # noqa: F401
from .dvr import DVRDataset  # noqa: F401
from .multi_object import MultiObjectDataset  # noqa: F401
from .pipeline import RayBatchPipeline, gen_rays_at  # noqa: F401
from .srn import SRNDataset  # noqa: F401
from .synthetic import SyntheticSphereDataset  # noqa: F401


def dataset_kwargs_from_conf(conf) -> dict:
    """``data.*`` config keys (minus ``format``) as dataset constructor
    kwargs, so ``--override data.num_objects=64`` reaches the dataset."""
    return {k: v for k, v in (conf.get("data") or {}).items() if k != "format"}


def get_split_dataset(dataset_type, datadir, want_split="all", training=True, **kwargs):
    """Build dataset(s) for the requested split(s), with the JAX factory's
    flags per format (``datadir`` is unused by the synthetic scenes;
    ``training`` caps DTU at 49 views an object).

    :param want_split: 'train' | 'val' | 'test' | 'all' (returns a 3-tuple)
    """
    flags = {}
    train_aug = None
    train_aug_flags = {}

    if dataset_type == "srn":
        dset_class = SRNDataset
    elif dataset_type == "multi_obj":
        dset_class = MultiObjectDataset
    elif dataset_type == "synthetic":
        def dset_class(datadir, stage="train", **kw):  # datadir unused
            return SyntheticSphereDataset(stage=stage, **kw)
    elif dataset_type.startswith("dvr"):
        dset_class = DVRDataset
        if dataset_type == "dvr_gen":
            flags["list_prefix"] = "gen_"
        elif dataset_type == "dvr_dtu":
            flags["list_prefix"] = "new_"
            if training:
                flags["max_imgs"] = 49
            flags["sub_format"] = "dtu"
            flags["scale_focal"] = False
            flags["z_near"] = 0.1
            flags["z_far"] = 5.0
            train_aug = ColorJitterDataset
            train_aug_flags = {"extra_inherit_attrs": ["sub_format"]}
    else:
        raise NotImplementedError(f"Unsupported dataset type {dataset_type}")

    def build(stage):
        dset = dset_class(datadir, stage=stage, **flags, **kwargs)
        if stage == "train" and train_aug is not None:
            dset = train_aug(dset, **train_aug_flags)
        return dset

    if want_split in ("train", "val", "test"):
        return build(want_split)
    return build("train"), build("val"), build("test")
