"""HF safetensors checkpoint loader for the dense llama family.

Port of ``rtp_llm_tpu/loader/loader.py::CheckpointLoader`` for float
checkpoints, packed GPTQ / AWQ int4 checkpoints and pre-quantized
SmoothQuant / OmniQuant W8A8 checkpoints (both recognised from
``ModelConfig.quantization``), and a load-time quantization ``transform``
(``quant/weight_only.py``); ``load_eagle_weights`` reads an EAGLE / EAGLE3
head for speculative decoding. It carries its own safetensors reader (an 8-byte header
length, a JSON header, then raw little-endian tensor bytes), built on
``json``, ``mmap`` and ``torch.frombuffer``, so it needs no ``safetensors``
package. Handles ``model.safetensors.index.json`` shards or any
``*.safetensors`` files in the directory.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from typing import Callable, Optional, Union

import torch

from rtp_llm_tpu_torch.config.model_config import SMOOTH_QUANT_METHODS, ModelConfig
from rtp_llm_tpu_torch.device import resolve_device
from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec, get_weight_specs, hf_names_for
from rtp_llm_tpu_torch.models.llama_family import torch_dtype
from rtp_llm_tpu_torch.ops.quant_gemm import pack_split_half

# (spec, canonical tensor) -> {suffix: tensor or marker}, or None to pass
TransformFn = Callable[[WeightSpec, torch.Tensor], Optional[dict]]

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsFile:
    """Read-only view of one .safetensors file: name -> CPU tensor."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header.pop("__metadata__", None)
        self._data_start = 8 + n
        self.entries = header

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        meta = self.entries[name]
        dtype = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        shape = meta["shape"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        with warnings.catch_warnings():  # the mmap is read-only; we copy below
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(self._mm, dtype=dtype, count=count,
                                    offset=self._data_start + start)
        return flat.reshape(shape).clone()

    def close(self):
        self._mm.close()


class _TensorSource:
    """All checkpoint files of a directory, name -> tensor."""

    def __init__(self, model_path: str):
        self.model_path = model_path
        self._files: dict[str, SafetensorsFile] = {}
        self._name_to_file: dict[str, str] = {}
        index = os.path.join(model_path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                self._name_to_file = dict(json.load(f)["weight_map"])
        else:
            names = sorted(f for f in os.listdir(model_path) if f.endswith(".safetensors"))
            if not names:
                raise FileNotFoundError(f"no .safetensors files in {model_path}")
            for fname in names:
                for key in self._open(fname).keys():
                    self._name_to_file[key] = fname

    def _open(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(os.path.join(self.model_path, fname))
        return self._files[fname]

    def names(self) -> set:
        return set(self._name_to_file)

    def get(self, name: str) -> torch.Tensor:
        return self._open(self._name_to_file[name]).get(name)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


class CheckpointLoader:
    """Loads a model's weights per the llama-family spec table into the
    canonical dict on ``device``. Float tensors are cast to ``cfg.dtype``
    unless ``transform`` (load-time quantization) rewrites them; the linears
    of a GPTQ / AWQ checkpoint arrive packed, with ``.scale``, ``.zero`` and
    the ``.int4p`` marker (or, where the in dim does not pack, as int8
    values with ``.scale`` and ``.zero``); those of a SmoothQuant /
    OmniQuant checkpoint as int8 with ``.scale``, the ``.w8a8`` marker and
    ``.smoother`` / ``.shift`` where the checkpoint has them."""

    def __init__(self, model_config: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 transform: Optional[TransformFn] = None):
        self.cfg = model_config
        self.device = resolve_device(device)
        self.transform = transform

    def load(self, model_path: str) -> dict:
        cfg = self.cfg
        src = _TensorSource(model_path)
        weights = {}
        try:
            available = src.names()
            for spec in get_weight_specs(cfg):
                names = hf_names_for(spec, cfg.num_layers)
                if self._is_packed_quant(spec, available, names):
                    entries = self._assemble_packed(spec, src, names)
                elif self._is_w8a8_ckpt(spec, available, names):
                    entries = self._assemble_w8a8(spec, src, names)
                else:
                    missing = [n for n in names if n not in available]
                    if missing and spec.optional:
                        continue
                    if missing:
                        raise KeyError(f"checkpoint missing tensors for {spec.name!r}: "
                                       f"{missing[:3]}{'...' if len(missing) > 3 else ''}")
                    entries = self._apply_transform(spec, self._assemble(spec, src, names))
                for suffix, t in entries.items():
                    weights[spec.name + suffix] = self._place(t)
        finally:
            src.close()
        return weights

    @staticmethod
    def _hf_rows(spec: WeightSpec, t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """A tensor whose dim 0 is the HF tensor's (its out dim), cut to the
        spec's member: ``hf_slice`` rows, then ``hf_transform``."""
        if spec.hf_slice is not None:
            a, b = spec.hf_slice
            t = t[a:b]
        if spec.hf_transform is not None:
            t = spec.hf_transform(t, cfg)
        return t

    def _assemble(self, spec: WeightSpec, src: _TensorSource, names) -> torch.Tensor:
        parts = [self._hf_rows(spec, src.get(n), self.cfg) for n in names]
        if spec.transpose:
            parts = [t.transpose(-1, -2) for t in parts]
        return torch.stack(parts) if spec.per_layer else parts[0]

    def _apply_transform(self, spec: WeightSpec, t: torch.Tensor) -> dict:
        if self.cfg.norm_unit_offset and spec.name.endswith("_norm"):
            # gemma: the norm computes x * (1 + w); the offset is folded in
            # here, in f32 before the cast, as the JAX loader folds it
            t = t.float() + 1.0
        if self.transform is not None:
            # quantize where the weights will live: a full-width model takes
            # minutes on the host and seconds on the card
            out = self.transform(spec, t.to(self.device))
            if out is not None:
                return out
        return {"": t.to(torch_dtype(self.cfg.dtype))}

    def _place(self, t):
        if not isinstance(t, torch.Tensor):
            return t  # a marker: a plain entry, only its presence is tested
        return t.contiguous().to(self.device)

    # ---- packed GPTQ / AWQ checkpoints ----

    def _has_qweight(self, methods, spec: WeightSpec, available, names) -> bool:
        q = self.cfg.quantization
        if not q or q.get("method") not in methods or spec.shard_axis not in ("out", "in"):
            return False
        first = names[0]
        return first.endswith(".weight") and (
            first[: -len(".weight")] + ".qweight" in available)

    def _is_packed_quant(self, spec: WeightSpec, available, names) -> bool:
        return self._has_qweight(("gptq", "awq"), spec, available, names)

    def _is_w8a8_ckpt(self, spec: WeightSpec, available, names) -> bool:
        return self._has_qweight(SMOOTH_QUANT_METHODS, spec, available, names)

    def _assemble_packed(self, spec: WeightSpec, src: _TensorSource, names) -> dict:
        """codes - 8 packed split-half, zero - 8, scale f32 and the ``.int4p``
        marker: ``(q - z) * s`` is shift-invariant, so moving the unsigned
        0..15 codes and their zero points into the s4 range keeps the
        dequantized weights while device memory holds two values a byte.
        A fused checkpoint tensor is cut on its out columns (``hf_slice`` /
        ``hf_transform``, as on a float tensor's rows). GPTQ act-order
        (a non-monotonic ``g_idx``): the rows arrive sorted into group order
        and ``.act_perm`` ``[L, in]`` int32 holds each layer's permutation
        of the input features (the identity for a layer whose ``g_idx``
        was monotonic): the product is ``x[:, perm] @ W``."""
        from rtp_llm_tpu_torch.quant.gptq_awq import awq_to_canonical, gptq_to_canonical
        from rtp_llm_tpu_torch.quant.weight_only import MARKER

        method = self.cfg.quantization["method"]
        available = src.names()
        vals, scales, zeros, perms = [], [], [], []
        cut = lambda t: self._hf_rows(spec, t.transpose(0, 1), self.cfg).transpose(0, 1)
        for name in names:
            base = name[: -len(".weight")]
            qw, qz, sc = (src.get(base + suffix) for suffix in (".qweight", ".qzeros", ".scales"))
            perm = None
            if method == "gptq":
                gi = src.get(base + ".g_idx") if base + ".g_idx" in available else None
                v, s, z, perm = gptq_to_canonical(qw, qz, sc, gi)
            else:
                v, s, z = awq_to_canonical(qw, qz, sc)
            vals.append(cut(v))
            scales.append(cut(s))
            zeros.append(cut(z))
            perms.append(perm)
        stack = torch.stack if spec.per_layer else (lambda xs: xs[0])
        v_all, s_all, z_all = stack(vals), stack(scales), stack(zeros)
        out = {}
        if any(p is not None for p in perms):
            k = vals[0].shape[0]
            out[".act_perm"] = stack([p if p is not None else torch.arange(k, dtype=torch.int32)
                                      for p in perms])
        k_rows, g_rows = v_all.shape[-2], s_all.shape[-2]
        packable = (k_rows % 2 == 0 and g_rows % 2 == 0
                    and k_rows % (2 * (k_rows // g_rows)) == 0)
        if not packable:  # one value a byte, through the 8-bit groupwise product
            return {"": v_all, ".scale": s_all, ".zero": z_all, **out}
        return {"": pack_split_half(v_all.to(torch.int16) - 8), ".scale": s_all,
                ".zero": z_all - 8.0, ".int4p": MARKER, **out}

    # ---- pre-quantized SmoothQuant / OmniQuant checkpoints ----

    def _assemble_w8a8(self, spec: WeightSpec, src: _TensorSource, names) -> dict:
        """``{base}.qweight`` i8 (oriented as ``{base}.weight``),
        ``{base}.scales`` f32 per out channel, optional ``{base}.smoother``
        / ``{base}.shift`` f32 per in channel. Calibration multiplied the
        smoother into the weights; the forward applies ``x' = (x - shift) /
        smoother`` before the integer contraction. A layer without a vector
        that others have gets ones (smoother) or zeros (shift)."""
        from rtp_llm_tpu_torch.quant.weight_only import MARKER

        available = src.names()
        vals, scales, smooths, shifts = [], [], [], []
        for name in names:
            base = name[: -len(".weight")]
            qw = self._hf_rows(spec, src.get(base + ".qweight").to(torch.int8), self.cfg)
            vals.append(qw.transpose(-1, -2) if spec.transpose else qw)
            scales.append(self._hf_rows(spec, src.get(base + ".scales").float().reshape(-1),
                                        self.cfg))
            smooths.append(src.get(base + ".smoother").float().reshape(-1)
                           if base + ".smoother" in available else None)
            shifts.append(src.get(base + ".shift").float().reshape(-1)
                          if base + ".shift" in available else None)
        stack = torch.stack if spec.per_layer else (lambda xs: xs[0])
        out = {"": stack(vals), ".scale": stack(scales), ".w8a8": MARKER}
        k = vals[0].shape[-2]
        for suffix, vecs, fill in ((".smoother", smooths, torch.ones),
                                   (".shift", shifts, torch.zeros)):
            if any(v is not None for v in vecs):
                out[suffix] = stack([v if v is not None else fill(k) for v in vecs])
        return out


# ---- EAGLE head checkpoints (speculative decoding) ----

# HF EAGLE checkpoint names (yuhuili/EAGLE-* format) -> the head's canonical
# keys; every linear transposes to the canonical [in, out] layout
_EAGLE_NAME_MAP = {
    "fc.weight": "fc",
    "embed_tokens.weight": "embed_tokens",
    "layers.0.self_attn.q_proj.weight": "q_proj",
    "layers.0.self_attn.k_proj.weight": "k_proj",
    "layers.0.self_attn.v_proj.weight": "v_proj",
    "layers.0.self_attn.o_proj.weight": "o_proj",
    "layers.0.mlp.gate_proj.weight": "gate_proj",
    "layers.0.mlp.up_proj.weight": "up_proj",
    "layers.0.mlp.down_proj.weight": "down_proj",
    "layers.0.post_attention_layernorm.weight": "post_attn_norm",
}

# EAGLE3 names, the official ``midlayer.*`` style and the ``layers.0.*``
# one: input_norm normalises the token embedding, hidden_norm the fc-fused
# target feature; a draft-vocabulary head brings its own norm, LM head and
# the ``d2t`` draft -> target id offsets
_EAGLE3_EXTRA_MAP = {
    "layers.0.hidden_norm.weight": "hidden_norm",
    "layers.0.input_layernorm.weight": "input_norm",
    "midlayer.hidden_norm.weight": "hidden_norm",
    "midlayer.input_layernorm.weight": "input_norm",
    "midlayer.self_attn.q_proj.weight": "q_proj",
    "midlayer.self_attn.k_proj.weight": "k_proj",
    "midlayer.self_attn.v_proj.weight": "v_proj",
    "midlayer.self_attn.o_proj.weight": "o_proj",
    "midlayer.mlp.gate_proj.weight": "gate_proj",
    "midlayer.mlp.up_proj.weight": "up_proj",
    "midlayer.mlp.down_proj.weight": "down_proj",
    "midlayer.post_attention_layernorm.weight": "post_attn_norm",
    "norm.weight": "final_norm",
    "lm_head.weight": "lm_head",
    "d2t": "d2t",
}

_EAGLE_NORMS = ("post_attn_norm", "hidden_norm", "input_norm", "final_norm")
_EAGLE_REQUIRED = {"fc", "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                   "down_proj", "post_attn_norm"}


def load_eagle_weights(model_path: str, dtype: torch.dtype = torch.bfloat16,
                       device: Optional[Union[str, torch.device]] = None) -> dict:
    """An HF-format EAGLE / EAGLE3 head (fc + one llama layer) as the dict
    ``engine/eagle.EagleRunner`` takes, on ``device``: linears ``[in, out]``
    and norms as vectors in ``dtype``, ``d2t`` int64; ``embed_tokens`` and
    ``lm_head`` only where the checkpoint ships them (else the runner uses
    the target's). Each name is looked up bare and under ``model.``. Read by
    the port's own safetensors reader."""
    dev = resolve_device(device)
    src = _TensorSource(model_path)
    try:
        available = src.names()
        out = {}
        for hf_name, key in {**_EAGLE_NAME_MAP, **_EAGLE3_EXTRA_MAP}.items():
            name = next((c for c in (hf_name, "model." + hf_name) if c in available), None)
            if name is None:
                continue
            t = src.get(name)
            if key == "d2t":
                out[key] = t.to(torch.int64).to(dev)
                continue
            if key != "embed_tokens" and key not in _EAGLE_NORMS:
                t = t.transpose(-1, -2)  # HF [out, in] -> [in, out]
            out[key] = t.float().to(dtype).contiguous().to(dev)
    finally:
        src.close()
    missing = _EAGLE_REQUIRED - set(out)
    if missing:
        raise ValueError(f"EAGLE checkpoint at {model_path} missing tensors: {sorted(missing)}")
    return out
