"""HF safetensors checkpoint loader for the dense llama family.

Port of ``rtp_llm_tpu/loader/loader.py::CheckpointLoader`` restricted to
float checkpoints. It carries its own safetensors reader (an 8-byte header
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
from typing import Optional, Union

import torch

from rtp_llm_tpu_torch.config.model_config import ModelConfig
from rtp_llm_tpu_torch.device import resolve_device
from rtp_llm_tpu_torch.loader.weight_maps import get_weight_specs, hf_names_for
from rtp_llm_tpu_torch.models.llama_family import torch_dtype

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
    canonical dict, cast to ``cfg.dtype``, on ``device``."""

    def __init__(self, model_config: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = model_config
        self.device = resolve_device(device)

    def load(self, model_path: str) -> dict:
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        src = _TensorSource(model_path)
        weights = {}
        try:
            available = src.names()
            for spec in get_weight_specs(cfg):
                names = hf_names_for(spec, cfg.num_layers)
                missing = [n for n in names if n not in available]
                if missing:
                    raise KeyError(f"checkpoint missing tensors for {spec.name!r}: "
                                   f"{missing[:3]}{'...' if len(missing) > 3 else ''}")
                parts = []
                for n in names:
                    t = src.get(n)
                    if spec.transpose:
                        t = t.transpose(-1, -2)
                    parts.append(t.to(dtype))
                t = torch.stack(parts) if spec.per_layer else parts[0]
                weights[spec.name] = t.contiguous().to(self.device)
        finally:
            src.close()
        return weights
