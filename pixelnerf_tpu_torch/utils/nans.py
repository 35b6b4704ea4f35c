"""The port's counterpart of ``jax_debug_nans`` (the apps' ``--debug_nans``)."""
from __future__ import annotations

from typing import Mapping, Union

import torch


def raise_if_not_finite(what: str, values: Union[torch.Tensor, Mapping]) -> None:
    """Raise ``FloatingPointError`` if a tensor of ``values`` (a tensor, or
    a nested mapping of them) holds a NaN or an infinity. It reads the
    answer back from the device, so callers run it only under
    ``--debug_nans``."""
    if isinstance(values, Mapping):
        for key, value in values.items():
            raise_if_not_finite(f"{what}[{key!r}]", value)
    elif not bool(torch.isfinite(values).all()):
        raise FloatingPointError(f"non-finite values in {what} (--debug_nans)")
