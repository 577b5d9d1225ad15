"""Carry a canonical weight dict from numpy arrays into the port.

The JAX package and the port share one canonical naming and layout (stacked
``[L, in, out]`` linears, see ``loader/weight_maps.py``). ``weights_from_jax``
takes that dict as host numpy arrays (``np.asarray`` of each JAX array) and
returns torch tensors on ``device``. Only float weights are ported: bf16
arrays (numpy's ml_dtypes bfloat16, 2 bytes) and float16/32.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from rtp_llm_tpu_torch.device import resolve_device


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a JAX buffer: torch needs its own copy
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16-bit words
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype in (np.float32, np.float16, np.float64):
        return torch.from_numpy(arr)
    raise NotImplementedError(
        f"weights of dtype {arr.dtype} are not ported (bf16 / f16 / f32 only)")


def weights_from_jax(np_weights: dict,
                     device: Optional[Union[str, torch.device]] = None) -> dict:
    """{canonical name: np.ndarray} -> {canonical name: torch.Tensor on device}."""
    dev = resolve_device(device)
    return {name: _to_tensor(np.asarray(a)).to(dev) for name, a in np_weights.items()}
