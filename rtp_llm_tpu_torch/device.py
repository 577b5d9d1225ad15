"""Device selection shared by every entry point.

Entry points run on the GPU by default. A caller who wants the CPU (the
tests, which compare against the JAX package) says so with ``device="cpu"``;
without a GPU and without that request the entry point raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU. Raises if the GPU is asked for (or implied) and
    CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtp_llm_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
