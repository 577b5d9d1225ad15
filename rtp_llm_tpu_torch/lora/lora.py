"""LoRA adapters: loading, the static merge and the runtime registry.

Port of ``rtp_llm_tpu/lora/lora.py``. An adapter is a HF PEFT directory:
``adapter_config.json`` ``{r, lora_alpha, target_modules}`` and weights
``base_model.model.model.layers.{l}.self_attn.q_proj.lora_A.weight`` ``[r,
in]`` and ``...lora_B.weight`` ``[out, r]`` in ``adapter_model.safetensors``
(read by the port's own reader: the card has no ``safetensors`` package) or
``adapter_model.bin``. Stored as ``A[name] = [L, in, r]`` and ``B[name] =
[L, r, out]`` f32 on the host (``delta = A @ B`` in the ``x @ W``
convention), zeros for layers the adapter leaves out; the scale
``alpha / r`` is applied by the merge and folded into B by ``device_pack``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Dict, List, Optional

import torch

from rtp_llm_tpu_torch.loader.loader import SafetensorsFile

# HF target module name -> canonical weight name
_TARGET_TO_CANONICAL = {
    "q_proj": "q_proj",
    "k_proj": "k_proj",
    "v_proj": "v_proj",
    "o_proj": "o_proj",
    "gate_proj": "gate_proj",
    "up_proj": "up_proj",
    "down_proj": "down_proj",
}

_NAME_RE = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight$")


@dataclasses.dataclass
class LoraAdapter:
    name: str
    rank: int
    alpha: float
    # canonical name -> [L, in, r] / [L, r, out] f32 on the host (zeros where absent)
    a: Dict[str, torch.Tensor]
    b: Dict[str, torch.Tensor]

    @property
    def scale(self) -> float:
        return self.alpha / max(self.rank, 1)


def _read_tensors(path: str) -> Dict[str, torch.Tensor]:
    st_path = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st_path):
        f = SafetensorsFile(st_path)
        try:
            return {k: f.get(k) for k in f.keys()}
        finally:
            f.close()
    sd = torch.load(os.path.join(path, "adapter_model.bin"), map_location="cpu",
                    weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def load_peft_adapter(path: str, num_layers: int, name: Optional[str] = None) -> LoraAdapter:
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    rank = int(cfg.get("r", 8))
    alpha = float(cfg.get("lora_alpha", rank))
    a: Dict[str, torch.Tensor] = {}
    b: Dict[str, torch.Tensor] = {}
    for hf_name, t in _read_tensors(path).items():
        m = _NAME_RE.search(hf_name)
        if not m:
            continue
        layer, target, ab = int(m.group(1)), m.group(2), m.group(3)
        canon = _TARGET_TO_CANONICAL.get(target)
        if canon is None:
            continue
        mat = t.float().T  # A [r, in] -> [in, r]; B [out, r] -> [r, out]
        store = a if ab == "A" else b
        if canon not in store:
            store[canon] = torch.zeros((num_layers,) + tuple(mat.shape), dtype=torch.float32)
        store[canon][layer] = mat
    return LoraAdapter(name=name or os.path.basename(path.rstrip("/")), rank=rank,
                       alpha=alpha, a=a, b=b)


def merge_lora(weights: dict, adapter: LoraAdapter) -> dict:
    """Static merge: ``W[name] += (A @ B) * scale`` a layer, in f32, then
    back to W's type. Takes a bf16 / f32 base in the unfused layout (before
    ``fuse_weights``); a quantized base cannot be merged (ValueError): serve
    such an adapter dynamically."""
    out = dict(weights)
    for name, A in adapter.a.items():
        Bm = adapter.b.get(name)
        if Bm is None or name not in weights:
            continue
        W = weights[name]
        if not W.dtype.is_floating_point or W.element_size() < 2 or name + ".scale" in weights:
            raise ValueError(f"cannot statically merge LoRA into quantized weight {name!r}; "
                             "use dynamic adapters")
        merged = torch.empty_like(W)
        for layer in range(W.shape[0]):
            delta = (A[layer].to(W.device) @ Bm[layer].to(W.device)) * adapter.scale
            merged[layer] = (W[layer].float() + delta).to(W.dtype)
        out[name] = merged
    return out


class LoraManager:
    """Runtime adapter registry (JAX ``LoraManager``): adapters by name,
    each with an id that stays reserved after removal (0 = no adapter).

    ``device_pack`` stacks all adapters into per-weight tensors ``[n_ids,
    L, in, r_max]`` / ``[n_ids, L, r_max, out]`` bf16 (id 0 and removed ids
    zeros; scale folded into B) so that a batched forward can index each
    row's adapter by id."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers
        self._adapters: Dict[str, LoraAdapter] = {}
        self._ids: Dict[str, int] = {}
        self._adds: Dict[str, int] = {}  # registrations of each name so far
        self._lock = threading.Lock()

    def add_adapter(self, path: str, name: Optional[str] = None) -> str:
        adapter = load_peft_adapter(path, self.num_layers, name)
        with self._lock:
            self._adapters[adapter.name] = adapter
            if adapter.name not in self._ids:
                self._ids[adapter.name] = len(self._ids) + 1  # 0 = none
            self._adds[adapter.name] = self._adds.get(adapter.name, 0) + 1
        return adapter.name

    def remove_adapter(self, name: str) -> bool:
        with self._lock:
            # the id stays reserved (its slice becomes zeros on the next pack)
            return self._adapters.pop(name, None) is not None

    def adapter_id(self, name: Optional[str]) -> int:
        if not name:
            return 0
        with self._lock:
            if name not in self._adapters:
                raise KeyError(f"unknown LoRA adapter {name!r}")
            return self._ids[name]

    def entries(self) -> Dict[str, tuple]:
        """``{name: (id, registration)}`` of the registered adapters; the
        registration counts the adds of that name (a name added again may
        hold other weights under the same id)."""
        with self._lock:
            return {n: (self._ids[n], self._adds[n]) for n in self._adapters}

    def device_pack(self, device="cpu") -> dict:
        """Stacked ``{canonical.lora_a / canonical.lora_b}`` bf16 tensors on
        ``device``; {} without adapters."""
        with self._lock:
            adapters = dict(self._adapters)
            ids = dict(self._ids)
        if not adapters:
            return {}
        n_slots = max(ids.values()) + 1
        r_max = max(a.rank for a in adapters.values())
        names = set()
        for a in adapters.values():
            names |= set(a.a) & set(a.b)
        out = {}
        for name in sorted(names):
            in_dim, out_dim = next((a.a[name].shape[1], a.b[name].shape[2])
                                   for a in adapters.values() if name in a.a)
            A = torch.zeros((n_slots, self.num_layers, in_dim, r_max), dtype=torch.float32)
            B = torch.zeros((n_slots, self.num_layers, r_max, out_dim), dtype=torch.float32)
            for aname, a in adapters.items():
                if name not in a.a or name not in a.b:
                    continue
                sid = ids[aname]
                A[sid, :, :, : a.rank] = a.a[name]
                B[sid, :, : a.rank, :] = a.b[name] * a.scale
            out[name + ".lora_a"] = A.to(torch.bfloat16).to(device)
            out[name + ".lora_b"] = B.to(torch.bfloat16).to(device)
        return out

    def get(self, name: Optional[str]) -> Optional[LoraAdapter]:
        if not name:
            return None
        with self._lock:
            adapter = self._adapters.get(name)
        if adapter is None:
            raise KeyError(f"unknown LoRA adapter {name!r}")
        return adapter

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._adapters)


def apply_dynamic_lora(x: torch.Tensor, name: str, layer: int,
                       adapter: Optional[LoraAdapter]):
    """One layer's dynamic delta ``((x @ A_l) @ B_l) * scale`` in x's type,
    or 0."""
    if adapter is None:
        return 0.0
    A = adapter.a.get(name)
    Bm = adapter.b.get(name)
    if A is None or Bm is None:
        return 0.0
    a = A[layer].to(x.device, x.dtype)
    bmat = Bm[layer].to(x.device, x.dtype)
    return ((x @ a) @ bmat) * adapter.scale
