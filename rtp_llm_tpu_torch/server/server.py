"""Server assembly: config -> model -> engine -> HTTP app.

Port of ``rtp_llm_tpu/server/server.py`` for one process on one GPU.
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import torch

from rtp_llm_tpu_torch.config.engine_config import EngineConfig
from rtp_llm_tpu_torch.config.model_config import ModelConfig
from rtp_llm_tpu_torch.device import resolve_device
from rtp_llm_tpu_torch.engine.engine import LlmEngine
from rtp_llm_tpu_torch.frontend.openai_api import build_app
from rtp_llm_tpu_torch.frontend.tokenizer_factory import TokenizerFactory
from rtp_llm_tpu_torch.loader.loader import CheckpointLoader, load_eagle_weights
from rtp_llm_tpu_torch.lora import load_peft_adapter, merge_lora
from rtp_llm_tpu_torch.models.llama_family import LlamaFamilyModel, torch_dtype
from rtp_llm_tpu_torch.quant import make_quant_transform

logger = logging.getLogger(__name__)


def build_engine(model_path: str, config: EngineConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 model_type: Optional[str] = None, dtype: str = "bfloat16") -> LlmEngine:
    dev = resolve_device(device)
    model_config = ModelConfig.from_pretrained(model_path, model_type)
    model_config.dtype = dtype
    # load-time quantization from the engine's config; a GPTQ / AWQ
    # checkpoint is recognised by the loader from ModelConfig.quantization
    transform = make_quant_transform(config.quant)
    logger.info("loading %s weights from %s (quant=%s, checkpoint quantization=%s)",
                model_config.model_type, model_path, config.quant.method.value,
                (model_config.quantization or {}).get("method"))
    weights = CheckpointLoader(model_config, device=dev, transform=transform).load(model_path)
    weights = merge_static_adapters(weights, config.server.lora_adapters, model_config.num_layers)
    model = LlamaFamilyModel(model_config, device=dev)
    draft, eagle = _speculative_parts(config, dev, dtype)
    return LlmEngine(model, weights, config, device=dev, draft=draft, eagle=eagle)


def merge_static_adapters(weights: dict, spec: str, num_layers: int) -> dict:
    """Merge each adapter of ``spec`` (``"name=path[,...]"``, the
    ``server.lora_adapters`` field) into the unfused weights, in order."""
    for item in filter(None, spec.split(",")):
        name, _, path = item.partition("=")
        adapter = load_peft_adapter(path or name, num_layers, name if path else None)
        logger.info("merging static LoRA adapter %r", adapter.name)
        weights = merge_lora(weights, adapter)
    return weights


def _speculative_parts(config: EngineConfig, dev: torch.device, dtype: str):
    """(draft model and weights, EAGLE head weights) the speculative method
    needs, from ``speculative.sp_model_path``: a draft checkpoint through
    the ``CheckpointLoader`` (not quantized), an EAGLE / EAGLE3 head through
    ``load_eagle_weights``."""
    sp = config.speculative
    if sp.method not in ("vanilla", "eagle") or not sp.enabled:
        return None, None
    if not sp.sp_model_path:
        raise ValueError(f"speculative method {sp.method!r} needs --speculative-sp-model-path")
    if sp.method == "eagle":
        logger.info("loading the EAGLE head from %s", sp.sp_model_path)
        return None, load_eagle_weights(sp.sp_model_path, dtype=torch_dtype(dtype), device=dev)
    draft_cfg = ModelConfig.from_pretrained(sp.sp_model_path)
    draft_cfg.dtype = dtype
    logger.info("loading the draft model %s from %s", draft_cfg.model_type, sp.sp_model_path)
    weights = CheckpointLoader(draft_cfg, device=dev).load(sp.sp_model_path)
    return (LlamaFamilyModel(draft_cfg, device=dev), weights), None


def serve(model_path: str, config: EngineConfig, host: str = "0.0.0.0",
          port: int = 8088, device=None, tokenizer_path: Optional[str] = None,
          model_name: Optional[str] = None, model_type: Optional[str] = None,
          access_log_path: Optional[str] = None):
    """Blocking: build everything and run the HTTP server."""
    engine = build_engine(model_path, config, device=device, model_type=model_type)
    if engine.device.type == "cuda":
        engine.warmup()  # capture the decode graphs before the first request
    tokenizer = TokenizerFactory.create(tokenizer_path or model_path)
    app = build_app(engine, tokenizer,
                    model_name=model_name or model_path.rstrip("/").rsplit("/", 1)[-1],
                    access_log_path=access_log_path)
    logger.info("serving on %s:%d", host, port)
    app.serve_forever(host, port)
