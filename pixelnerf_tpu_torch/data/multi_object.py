"""Multi-object synthetic Blender scenes (counterpart of
``pixelnerf_tpu/data/multi_object.py``; NeRF ``transforms.json`` format,
reference src/data/MultiObjectDataset.py).

Reads the ``<frame>_obj.png`` RGBA renders of a scene (decoded together by
the port's PNG reader, ``utils/png.py``), composites them onto white by
their alpha, takes a bbox of the pixels with any nonzero channel, and
derives the focal from ``camera_angle_x``. A scene whose frame or PNG count
is not ``n_views`` yields the empty-dict sentinel that the training
pipeline skips (reference MultiObjectDataset.py:41-61, train/train.py:118-119).
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..utils.png import imread_many
from .base import DatasetBase, image_to_tensor, mask_to_tensor


class MultiObjectDataset(DatasetBase):
    def __init__(self, path, stage="train", z_near=4.0, z_far=9.0, n_views=None):
        self.base_path = os.path.join(path, stage)
        trans_files = []
        for root, _dirs, filenames in os.walk(self.base_path):
            if "transforms.json" in filenames:
                trans_files.append(os.path.join(root, "transforms.json"))
        self.trans_files = sorted(trans_files)
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        self.n_views = n_views

    def __len__(self):
        return len(self.trans_files)

    def _check_valid(self, index):
        if self.n_views is None:
            return True
        trans_file = self.trans_files[index]
        dir_path = os.path.dirname(trans_file)
        try:
            with open(trans_file, "r") as f:
                transform = json.load(f)
        except (OSError, ValueError):
            return False
        if len(transform["frames"]) != self.n_views:
            return False
        return len(glob.glob(os.path.join(dir_path, "*.png"))) == self.n_views

    def __getitem__(self, index):
        if not self._check_valid(index):
            return {}

        trans_file = self.trans_files[index]
        dir_path = os.path.dirname(trans_file)
        with open(trans_file, "r") as f:
            transform = json.load(f)

        names = [os.path.splitext(os.path.basename(fr["file_path"]))[0] for fr in transform["frames"]]
        rgba = imread_many([os.path.join(dir_path, f"{name}_obj.png") for name in names])
        imgs, masks, bboxes, poses = [], [], [], []
        for frame, img in zip(transform["frames"], rgba):
            mask = mask_to_tensor(img[..., 3])
            nz = np.argwhere(img.any(axis=-1))
            if len(nz) == 0:
                bbox = np.array([0, 0, img.shape[1], img.shape[0]], dtype=np.float32)
            else:
                (rmin, cmin), (rmax, cmax) = nz.min(0), nz.max(0)
                bbox = np.array([cmin, rmin, cmax, rmax], dtype=np.float32)
            rgb = image_to_tensor(img[..., :3])
            rgb = rgb * mask + (1.0 - mask)  # white where transparent
            imgs.append(rgb)
            masks.append(mask)
            bboxes.append(bbox)
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))

        images = np.stack(imgs).astype(np.float32)
        W = images.shape[2]
        focal = 0.5 * W / np.tan(0.5 * float(transform["camera_angle_x"]))
        return {
            "path": dir_path,
            "img_id": index,
            "focal": np.float32(focal),
            "images": images,
            "masks": np.stack(masks).astype(np.float32),
            "bbox": np.stack(bboxes),
            "poses": np.stack(poses),
        }
