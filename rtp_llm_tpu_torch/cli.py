"""CLI entrypoint: ``rtp-llm-tpu-torch serve <model_path> [flags]``."""

from __future__ import annotations

import argparse
import logging
import sys

from rtp_llm_tpu_torch.config import server_args
from rtp_llm_tpu_torch.config.engine_config import (
    SPECULATIVE_METHODS, CacheConfig, EngineConfig, QuantConfig, QuantMethod, SchedulerConfig,
    SpeculativeConfig,
)


# ``serve``'s own flags, each an alias of one config field: dest -> (group,
# field[, value map]); every field also has its ``--<group>-<field>`` flag
# and its ``RTP_<GROUP>_<FIELD>`` env var (``config/server_args.py``)
ALIASES = {
    "max_batch_size": ("scheduler", "max_batch_size"),
    "max_seq_len": ("scheduler", "max_seq_len"),
    "block_size": ("cache", "block_size"),
    "num_blocks": ("cache", "num_blocks"),
    "no_prefix_cache": ("cache", "enable_prefix_cache", lambda v: not v),
    "quant": ("quant", "method"),
    "quant_group_size": ("quant", "group_size"),
    "fp8_block_size": ("quant", "fp8_block_size"),
    "quantize_lm_head": ("quant", "quantize_lm_head"),
    "int4_pipeline": ("kernel", "int4_pipeline"),
    "kv_cache_dtype": ("quant", "kv_cache_dtype"),
    "defer_kv_writes": ("scheduler", "defer_kv_writes"),
    "decode_steps": ("scheduler", "decode_steps"),
    "no_async_decode": ("scheduler", "async_decode", lambda v: not v),
    "max_prefill_tokens_per_step": ("scheduler", "max_prefill_tokens_per_step"),
    "max_prefills_per_step": ("scheduler", "max_prefills_per_step"),
    "decode_steps_per_prefill": ("scheduler", "decode_steps_per_prefill"),
    "ttft_slo_ms": ("scheduler", "ttft_slo_ms"),
    "tree_decode_config_path": ("", "tree_decode_config_path"),
    "speculative_method": ("speculative", "method"),
    "speculative_draft_tokens": ("speculative", "draft_tokens"),
    "speculative_ngram_min": ("speculative", "ngram_min"),
    "speculative_ngram_max": ("speculative", "ngram_max"),
    "speculative_sp_model_path": ("speculative", "sp_model_path"),
}


def parse_args(argv=None):
    """``serve``'s flags: its own (defaults None: not given, the config's
    default applies) and ``--<group>-<field>`` for every config field."""
    ap = argparse.ArgumentParser(prog="rtp-llm-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve an HF checkpoint over the OpenAI API")
    s.add_argument("model_path")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8088)
    s.add_argument("--device", default=None, help="default: cuda")
    s.add_argument("--model-type", default=None)
    s.add_argument("--tokenizer-path", default=None)
    s.add_argument("--served-model-name", default=None)
    s.add_argument("--access-log-path", default=None,
                   help="one JSON line a request (default: standard error)")
    s.add_argument("--max-batch-size", type=int, default=None,
                   help=f"decode slots (default {SchedulerConfig.max_batch_size})")
    s.add_argument("--max-seq-len", type=int, default=None,
                   help=f"default {SchedulerConfig.max_seq_len}")
    s.add_argument("--block-size", type=int, default=None,
                   help=f"tokens a KV block (default {CacheConfig.block_size})")
    s.add_argument("--num-blocks", type=int, default=None,
                   help="KV blocks (default 0: size from free memory)")
    s.add_argument("--no-prefix-cache", action="store_true", default=None)
    s.add_argument("--quant", choices=[m.value for m in QuantMethod], default=None,
                   help="load-time weight quantization: int8 (per channel), int4 / fp4 "
                        "(groupwise, packed), fp8 (e4m3, see --fp8-block-size), w8a8 / "
                        "w4a8 (per-token int8 activations, integer products). A GPTQ / AWQ "
                        "or SmoothQuant / OmniQuant checkpoint is recognised from its "
                        "config.json")
    s.add_argument("--quant-group-size", type=int, default=None,
                   help=f"default {QuantConfig.group_size}")
    s.add_argument("--fp8-block-size", type=int, default=None,
                   help="fp8 scales: > 0 one per block x block tile, 0 one per tensor, "
                        f"-1 one per out channel (default {QuantConfig.fp8_block_size})")
    s.add_argument("--quantize-lm-head", action="store_true", default=None,
                   help="quantize the LM head to per-channel int8 (with --quant)")
    s.add_argument("--int4-pipeline", action="store_true", default=None,
                   help="4-bit linears through gw_gemm_pipe: the decode of each "
                        "k-tile overlaps the products of the one before (a "
                        "decode warpgroup beside two wgmma warpgroups from 128 rows)")
    s.add_argument("--kv-cache-dtype", choices=("bfloat16", "int8", "fp8"), default=None,
                   help="KV pool storage: int8 keeps per-(slot, kv head) scales, "
                        f"fp8 is e4m3 without scales (default {QuantConfig.kv_cache_dtype})")
    s.add_argument("--defer-kv-writes", action="store_true", default=None,
                   help="write a decode step's KV rows in one batched scatter")
    s.add_argument("--decode-steps", type=int, default=None,
                   help="decode tokens per window: N fused decode bodies in one "
                        f"CUDA graph, one readback per N tokens (default "
                        f"{SchedulerConfig.decode_steps})")
    s.add_argument("--no-async-decode", action="store_true", default=None,
                   help="read back each decode window before dispatching the next")
    s.add_argument("--max-prefill-tokens-per-step", type=int, default=None,
                   help="with decodes running, prompt tokens admitted a step "
                        "(at least one stream; 0: unlimited; default "
                        f"{SchedulerConfig.max_prefill_tokens_per_step})")
    s.add_argument("--max-prefills-per-step", type=int, default=None,
                   help="streams admitted a step (0, the default: unlimited)")
    s.add_argument("--decode-steps-per-prefill", type=int, default=None,
                   help="with decodes running, decode-only steps between two "
                        "prefill rounds (0, the default: none)")
    s.add_argument("--ttft-slo-ms", type=int, default=None,
                   help="reject a request (HTTP 429) when its projected queue "
                        "wait exceeds this (0, the default: off)")
    s.add_argument("--tree-decode-config-path", default=None,
                   help="trie-constrained decode: a JSON file of start_token_id, "
                        "end_token_id, sep and prefix_dict (every request)")
    s.add_argument("--speculative-method", choices=SPECULATIVE_METHODS + ("mtp",),
                   default=None,
                   help="speculative decoding of greedy streams: prompt_lookup (n-grams "
                        "of the stream itself), vanilla (a draft model) or eagle (an "
                        "EAGLE / EAGLE3 head) proposes, one T = K+1 window verifies "
                        "(mtp is not ported; default none)")
    s.add_argument("--speculative-draft-tokens", type=int, default=None,
                   help=f"K: proposals a step (default {SpeculativeConfig.draft_tokens})")
    s.add_argument("--speculative-ngram-min", type=int, default=None)
    s.add_argument("--speculative-ngram-max", type=int, default=None)
    s.add_argument("--speculative-sp-model-path", default=None,
                   help="the draft model's checkpoint (vanilla) or the EAGLE head's (eagle)")
    s.add_argument("--log-level", default="INFO")
    server_args.add_config_flags(s)
    return ap.parse_args(argv)


def config_from_args(args) -> EngineConfig:
    """The engine config of parsed ``serve`` flags: each field from its
    flag (an alias above or ``--<group>-<field>``), else its env var, else
    its default."""
    cfg = server_args.apply_env_and_args(EngineConfig(), namespace=args)
    for dest, (group, field, *convert) in ALIASES.items():
        value = getattr(args, dest, None)
        if value is not None:
            setattr(getattr(cfg, group) if group else cfg, field,
                    convert[0](value) if convert else value)
    return server_args.revalidate(cfg)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from rtp_llm_tpu_torch.server.server import serve

    serve(args.model_path, config_from_args(args), host=args.host, port=args.port,
          device=args.device, tokenizer_path=args.tokenizer_path, model_name=args.served_model_name,
          model_type=args.model_type, access_log_path=args.access_log_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
