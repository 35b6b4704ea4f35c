"""The multi-GPU layer (counterpart of ``pixelnerf_tpu/parallel``): a
(data, ray) mesh over ``torch.distributed`` ranks, the batch's placement
on it, and the sharded render."""
from .mesh import (  # noqa: F401
    BATCH_KEYS,
    DATA_AXIS,
    RAY_AXIS,
    RAY_AXIS_KEYS,
    Mesh,
    make_mesh,
    shard_batch,
    shard_rays,
)
from .render import make_sharded_render  # noqa: F401
