"""The multi-GPU layer: a (data, ray) mesh over ``torch.distributed``
processes (counterpart of ``pixelnerf_tpu/parallel/mesh.py``).

The JAX package runs one process over every chip and lets XLA place the
collectives; here, as PyTorch does it, each GPU has its own process (one
rank, launched by ``torchrun``), NCCL joins them on the card and gloo on
the CPU. The mesh keeps the JAX package's axes and layout: rank
``d * ray + r`` sits at (data ``d``, ray ``r``).

- axis ``"data"``: the object (super-batch) dimension, the training axis
  of data parallelism; the encoder's train-mode batch norms reduce their
  statistics over it, and the gradients are averaged over every rank.
- axis ``"ray"``: the per-object ray dimension; rendering along it needs
  no communication.

Parameters and small intrinsics are replicated: every rank holds the whole
model and a global host batch, and keeps its own slice of it
(:func:`shard_batch`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
RAY_AXIS = "ray"

# the train batch schema, shared by shard_batch and the sharded train step:
# RAY_AXIS_KEYS are the entries whose SECOND axis is the ray axis (split
# over 'ray'); every other entry is per object only. Keyed explicitly: a
# shape-divisibility heuristic would split c (SB, 2) on a ray=2 mesh or
# images (SB, NS, ...) when NS divides the ray axis.
BATCH_KEYS = ("images", "poses", "focal", "c", "rays", "rgb_gt")
RAY_AXIS_KEYS = ("rays", "rgb_gt")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a (data, ray) mesh of ranks.

    :param shape: ``{"data": d, "ray": r}``
    :param data_index: this rank's coordinate on the data axis
    :param ray_index: its coordinate on the ray axis
    :param data_group: the ranks that share this rank's ray coordinate
        (the data axis through it), None when ``torch.distributed`` is not
        initialised
    :param ray_group: the ranks that share its data coordinate
    """

    shape: Dict[str, int]
    data_index: int
    ray_index: int
    data_group: Optional[object] = None
    ray_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[RAY_AXIS]

    @property
    def rank(self) -> int:
        return self.data_index * self.shape[RAY_AXIS] + self.ray_index

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def world_size() -> int:
    """The number of ranks: the process group's, else ``WORLD_SIZE`` as
    ``torchrun`` sets it, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_main_process() -> bool:
    """Rank 0 (or no process group): the one rank that writes files,
    checkpoints and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def init_distributed(device: str) -> str:
    """Join the process group that ``torchrun``'s environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), NCCL on CUDA devices and gloo on the CPU, unless one
    is initialised already.

    :param device: the app's ``--device``; a bare ``"cuda"`` becomes this
        rank's card, ``cuda:<LOCAL_RANK>``
    :return: the device this rank runs on
    """
    cuda = device.split(":")[0] == "cuda"
    if cuda and device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if cuda:
        torch.cuda.set_device(torch.device(device))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    return device


def make_mesh(data: Optional[int] = None, ray: Optional[int] = None) -> Mesh:
    """A (data, ray) mesh over every rank of the process group (one rank,
    with no group, when ``torch.distributed`` is not initialised).

    Defaults: every rank on the ray axis (pure ray sharding, the eval
    layout). ``make_mesh(data=N)`` puts N-way object parallelism first and
    the rest on rays. Every rank must call it, in the same order: it makes
    the axes' process groups.
    """
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    if data is None and ray is None:
        data, ray = 1, n
    elif data is None:
        data = n // ray
    elif ray is None:
        ray = n // data
    assert data * ray == n, f"mesh {data}x{ray} != {n} devices"
    rank = dist.get_rank() if initialized else 0
    d, r = divmod(rank, ray)
    data_group = ray_group = None
    if initialized:
        # new_group is collective: every rank makes every group
        for rr in range(ray):
            g = dist.new_group([dd * ray + rr for dd in range(data)])
            if rr == r:
                data_group = g
        for dd in range(data):
            g = dist.new_group([dd * ray + rr for rr in range(ray)])
            if dd == d:
                ray_group = g
    return Mesh({DATA_AXIS: data, RAY_AXIS: ray}, d, r, data_group, ray_group)


def batch_spec(mesh: Mesh, x, ray_axis: bool) -> Tuple[str, ...]:
    """Where :func:`shard_batch` puts an entry, as the JAX package's
    ``PartitionSpec``: ``("data", "ray")`` (axis 0 over data, axis 1 over
    ray) for a ray-major entry whose two axes divide the mesh, else
    ``("data",)`` when axis 0 divides the data axis, else ``()``
    (replicated)."""
    shape = np.shape(x)
    if (ray_axis and len(shape) >= 2 and shape[0] % mesh.shape[DATA_AXIS] == 0
            and shape[1] % mesh.shape[RAY_AXIS] == 0):
        return (DATA_AXIS, RAY_AXIS)
    if len(shape) >= 1 and shape[0] % mesh.shape[DATA_AXIS] == 0:
        return (DATA_AXIS,)
    return ()


def _block(n: int, parts: int, index: int) -> slice:
    size = n // parts
    return slice(index * size, (index + 1) * size)


def local_slice(mesh: Mesh, x, spec: Tuple[str, ...]):
    """This rank's block of a global array ``x`` placed by ``spec``."""
    index = {DATA_AXIS: mesh.data_index, RAY_AXIS: mesh.ray_index}
    shape = np.shape(x)
    return x[tuple(_block(shape[i], mesh.shape[axis], index[axis]) for i, axis in enumerate(spec))]


def shard_batch(mesh: Mesh, tree):
    """This rank's slice of a global host batch: the leading axis (objects)
    over 'data'; for the ray-major entries (``RAY_AXIS_KEYS``) the second
    axis over 'ray' (:func:`batch_spec`). Entries are numpy arrays or
    tensors and keep their type; a bare array is treated as ray-major."""
    if isinstance(tree, dict):
        return {k: local_slice(mesh, v, batch_spec(mesh, v, k in RAY_AXIS_KEYS)) for k, v in tree.items()}
    return local_slice(mesh, tree, batch_spec(mesh, tree, True))


def shard_rays(mesh: Mesh, rays):
    """This rank's slice of (SB, B, 8) rays, B split over every mesh axis
    (rank-major), the sharded render's layout."""
    B = np.shape(rays)[1]
    if B % mesh.size:
        raise ValueError(f"{B} rays do not split over a mesh of {mesh.size} ranks")
    return rays[:, _block(B, mesh.size, mesh.rank)]


def local_noise(noise, sb: slice, b: slice) -> Dict[str, torch.Tensor]:
    """This rank's block of the renderer's draws made on the global shape:
    ``noise`` is one dict of (SB, B, K) tensors or one dict per ray chunk
    along B (joined first)."""
    if isinstance(noise, (list, tuple)):
        noise = {k: torch.cat([n[k] for n in noise], dim=1) for k in noise[0]}
    return {k: v[sb, b] for k, v in noise.items()}


def split_noise(noise: Dict[str, torch.Tensor], ray_chunk: Optional[int]):
    """One noise dict per chunk of ``ray_chunk`` rays along B (one dict
    when ``ray_chunk`` is None or not smaller than B)."""
    B = next(iter(noise.values())).shape[1]
    if ray_chunk is None or B <= ray_chunk:
        return [noise]
    return [{k: v[:, s : s + ray_chunk] for k, v in noise.items()} for s in range(0, B, ray_chunk)]


def gather_rays(mesh: Mesh, tree, dim: int = 1):
    """Every rank's slice of the ray axis ``dim`` of each tensor in a
    nested dict, joined in rank order: the whole result on every rank (the
    JAX package's replicated ``out_shardings``)."""
    if isinstance(tree, dict):
        return {k: gather_rays(mesh, v, dim) for k, v in tree.items()}
    if not mesh.distributed:
        return tree
    x = tree.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


def average_over_ranks(mesh: Mesh, tensors):
    """Each tensor replaced in place by its mean over every rank (one
    all-reduce of the tensors flattened into one buffer)."""
    tensors = [t for t in tensors if t is not None]
    if not mesh.distributed or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= mesh.size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


@contextlib.contextmanager
def synced_batch_norms(net, mesh: Optional[Mesh]):
    """The encoders' train-mode batch norms reduce their statistics over
    the mesh's data axis inside the block (nothing changes on a data axis
    of one rank, whose batch is the whole batch)."""
    from ..models.resnet import BatchNorm2d

    mods = []
    if mesh is not None and mesh.distributed and mesh.shape[DATA_AXIS] > 1:
        mods = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in mods:
        m.sync_group = mesh.data_group
    try:
        yield
    finally:
        for m in mods:
            m.sync_group = None
