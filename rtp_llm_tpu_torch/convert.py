"""Carry a canonical weight dict from numpy arrays into the port.

The JAX package and the port share one canonical naming and layout (stacked
``[L, in, out]`` linears, see ``loader/weight_maps.py``). ``weights_from_jax``
takes that dict as host numpy arrays (``np.asarray`` of each JAX array) and
returns torch tensors on ``device``: bf16 arrays (numpy's ml_dtypes bfloat16,
2 bytes), fp8 e4m3 codes (ml_dtypes float8_e4m3fn, the same bits),
float16/32/64, the integer arrays of quantized weights (u8 packed 4-bit
codes, i8 int8 / int4 values, i32), and 0-d arrays (a per-tensor scale) as
0-d tensors. A quantization marker of the JAX dict (an object whose presence
under ``name.int4p`` / ``name.fp4`` / ``name.w8a8`` / ``name.w4a8`` selects
the matmul) arrives as an object array and becomes the port's plain marker.

A speculative draft model's dict is a canonical dict like the target's:
``weights_from_jax`` carries it too. ``eagle_from_jax`` carries an EAGLE /
EAGLE3 head's dict (the JAX ``load_eagle_weights``: fc, the layer's linears
and norms, optional embed / norm / LM head, ``d2t`` int32 -> int64).

``cache_from_jax`` carries a KV pool over the same way, so a test can start
both sides from one pool: an array (bf16 / f32; fp8 e4m3 as its bytes), or
the int8 pool's ``{"data", "scale"}`` dict.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from rtp_llm_tpu_torch.device import resolve_device
from rtp_llm_tpu_torch.quant.weight_only import MARKER


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps a 0-d array 0-d
    if not arr.flags.writeable:  # e.g. a JAX buffer: torch needs its own copy
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16-bit words
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":  # ml_dtypes: the same bits
        return torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    if arr.dtype in (np.float32, np.float16, np.float64, np.uint8, np.int8, np.int32):
        return torch.from_numpy(arr)
    raise NotImplementedError(f"weights of dtype {arr.dtype} are not ported")


def weights_from_jax(np_weights: dict,
                     device: Optional[Union[str, torch.device]] = None) -> dict:
    """{canonical name: np.ndarray} -> {canonical name: torch.Tensor on device}."""
    dev = resolve_device(device)
    out = {}
    for name, a in np_weights.items():
        a = np.asarray(a)
        out[name] = MARKER if a.dtype == object else _to_tensor(a).to(dev)
    return out


def eagle_from_jax(np_eagle: dict,
                   device: Optional[Union[str, torch.device]] = None) -> dict:
    """A JAX EAGLE head dict as host numpy -> the port's head dict on
    ``device`` (the layout is shared; the ``d2t`` map becomes int64)."""
    out = weights_from_jax(np_eagle, device)
    if "d2t" in out:
        out["d2t"] = out["d2t"].to(torch.int64)
    return out


def cache_from_jax(np_cache, device: Optional[Union[str, torch.device]] = None):
    """A JAX KV cache as host numpy (an ``[L, 2, NS, Hkv*D]`` array, or the
    int8 pool's ``{"data", "scale"}`` dict of arrays) -> the port's pool on
    ``device``, bit for bit."""
    dev = resolve_device(device)
    if isinstance(np_cache, dict):
        return {k: _to_tensor(np.asarray(v)).to(dev) for k, v in np_cache.items()}
    return _to_tensor(np.asarray(np_cache)).to(dev)
