"""CLI entrypoint: ``rtp-llm-tpu-torch serve <model_path> [flags]``."""

from __future__ import annotations

import argparse
import logging
import sys

from rtp_llm_tpu_torch.config.engine_config import (
    SPECULATIVE_METHODS, CacheConfig, EngineConfig, KernelConfig, QuantConfig, QuantMethod,
    SchedulerConfig, SpeculativeConfig,
)


def parse_args(argv=None):
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
    s.add_argument("--max-batch-size", type=int, default=SchedulerConfig.max_batch_size)
    s.add_argument("--max-seq-len", type=int, default=SchedulerConfig.max_seq_len)
    s.add_argument("--block-size", type=int, default=CacheConfig.block_size)
    s.add_argument("--num-blocks", type=int, default=0, help="0: size from free memory")
    s.add_argument("--no-prefix-cache", action="store_true")
    s.add_argument("--quant", choices=[m.value for m in QuantMethod], default="none",
                   help="load-time weight quantization: int8 (per channel), int4 / fp4 "
                        "(groupwise, packed), fp8 (e4m3, see --fp8-block-size), w8a8 / "
                        "w4a8 (per-token int8 activations, integer products). A GPTQ / AWQ "
                        "or SmoothQuant / OmniQuant checkpoint is recognised from its "
                        "config.json")
    s.add_argument("--quant-group-size", type=int, default=QuantConfig.group_size)
    s.add_argument("--fp8-block-size", type=int, default=QuantConfig.fp8_block_size,
                   help="fp8 scales: > 0 one per block x block tile, 0 one per tensor, "
                        "-1 one per out channel")
    s.add_argument("--quantize-lm-head", action="store_true",
                   help="quantize the LM head to per-channel int8 (with --quant)")
    s.add_argument("--int4-pipeline", action="store_true",
                   help="4-bit linears through gw_gemm_pipe: the decode of each "
                        "k-tile overlaps the products of the one before (a "
                        "decode warpgroup beside two wgmma warpgroups from 128 rows)")
    s.add_argument("--kv-cache-dtype", choices=("bfloat16", "int8", "fp8"),
                   default=QuantConfig.kv_cache_dtype,
                   help="KV pool storage: int8 keeps per-(slot, kv head) scales, "
                        "fp8 is e4m3 without scales")
    s.add_argument("--defer-kv-writes", action="store_true",
                   help="write a decode step's KV rows in one batched scatter")
    s.add_argument("--decode-steps", type=int, default=SchedulerConfig.decode_steps,
                   help="decode tokens per window: N fused decode bodies in one "
                        "CUDA graph, one readback per N tokens")
    s.add_argument("--no-async-decode", action="store_true",
                   help="read back each decode window before dispatching the next")
    s.add_argument("--max-prefill-tokens-per-step", type=int,
                   default=SchedulerConfig.max_prefill_tokens_per_step,
                   help="with decodes running, prompt tokens admitted a step "
                        "(at least one stream; 0: unlimited)")
    s.add_argument("--max-prefills-per-step", type=int,
                   default=SchedulerConfig.max_prefills_per_step,
                   help="streams admitted a step (0: unlimited)")
    s.add_argument("--decode-steps-per-prefill", type=int,
                   default=SchedulerConfig.decode_steps_per_prefill,
                   help="with decodes running, decode-only steps between two "
                        "prefill rounds (0: none)")
    s.add_argument("--ttft-slo-ms", type=int, default=SchedulerConfig.ttft_slo_ms,
                   help="reject a request (HTTP 429) when its projected queue "
                        "wait exceeds this (0: off)")
    s.add_argument("--tree-decode-config-path", default="",
                   help="trie-constrained decode: a JSON file of start_token_id, "
                        "end_token_id, sep and prefix_dict (every request)")
    s.add_argument("--speculative-method", choices=SPECULATIVE_METHODS + ("mtp",),
                   default=SpeculativeConfig.method,
                   help="speculative decoding of greedy streams: prompt_lookup (n-grams "
                        "of the stream itself), vanilla (a draft model) or eagle (an "
                        "EAGLE / EAGLE3 head) proposes, one T = K+1 window verifies "
                        "(mtp is not ported)")
    s.add_argument("--speculative-draft-tokens", type=int,
                   default=SpeculativeConfig.draft_tokens, help="K: proposals a step")
    s.add_argument("--speculative-ngram-min", type=int, default=SpeculativeConfig.ngram_min)
    s.add_argument("--speculative-ngram-max", type=int, default=SpeculativeConfig.ngram_max)
    s.add_argument("--speculative-sp-model-path", default=SpeculativeConfig.sp_model_path,
                   help="the draft model's checkpoint (vanilla) or the EAGLE head's (eagle)")
    s.add_argument("--log-level", default="INFO")
    return ap.parse_args(argv)


def config_from_args(args) -> EngineConfig:
    return EngineConfig(
        quant=QuantConfig(method=args.quant, group_size=args.quant_group_size,
                          fp8_block_size=args.fp8_block_size,
                          quantize_lm_head=args.quantize_lm_head,
                          kv_cache_dtype=args.kv_cache_dtype),
        kernel=KernelConfig(int4_pipeline=args.int4_pipeline),
        cache=CacheConfig(block_size=args.block_size, num_blocks=args.num_blocks,
                          enable_prefix_cache=not args.no_prefix_cache),
        scheduler=SchedulerConfig(max_batch_size=args.max_batch_size,
                                  max_seq_len=args.max_seq_len,
                                  defer_kv_writes=args.defer_kv_writes,
                                  decode_steps=args.decode_steps,
                                  async_decode=not args.no_async_decode,
                                  max_prefill_tokens_per_step=args.max_prefill_tokens_per_step,
                                  max_prefills_per_step=args.max_prefills_per_step,
                                  decode_steps_per_prefill=args.decode_steps_per_prefill,
                                  ttft_slo_ms=args.ttft_slo_ms),
        speculative=SpeculativeConfig(method=args.speculative_method,
                                      draft_tokens=args.speculative_draft_tokens,
                                      ngram_min=args.speculative_ngram_min,
                                      ngram_max=args.speculative_ngram_max,
                                      sp_model_path=args.speculative_sp_model_path),
        tree_decode_config_path=args.tree_decode_config_path,
    )


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from rtp_llm_tpu_torch.server.server import serve

    serve(args.model_path, config_from_args(args), host=args.host, port=args.port,
          device=args.device, tokenizer_path=args.tokenizer_path, model_name=args.served_model_name,
          model_type=args.model_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
