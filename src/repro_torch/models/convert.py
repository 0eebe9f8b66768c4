"""JAX parameter tree or train state -> the port's tensors.

The layouts are the same on both sides (weights ``(in, out)``, blocks
stacked on a leading layer dim), so conversion is the identity on shapes.
Leaves arrive as numpy arrays (``np.asarray`` of a jax.Array); bf16 leaves
are ml_dtypes bfloat16 arrays and cross over through a uint16 view, so
neither jax nor ml_dtypes is imported here.  JAX's ``_stacked`` marker
scalar is dropped wherever it sits (params and the optimizer's trees).  A
whole train state ``{"params", "opt": {"master"?, "m", "v", "count"},
"step"}`` converts the same way: its int32 scalars become 0-d int32
tensors, so both frameworks can start from one state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


def _leaf(arr: Any, device: torch.device) -> torch.Tensor:
    a = np.array(arr, copy=True)   # writable and contiguous for from_numpy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(node: Any, device: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()
                if k != "_stacked"}
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v, device) for v in node)
    return _leaf(node, device)


def from_jax(params: Any, device: DeviceLike = None) -> Any:
    """Convert a JAX tree (dicts/lists of arrays: parameters or a whole
    train state) to tensors."""
    return _convert(params, resolve_device(device))
