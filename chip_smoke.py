#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``rtp_llm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device: card name and power limit (nvidia-smi), torch / CUDA versions;
  2. build: nvcc builds every kernel of the main path from ``csrc/``;
  3. decode kernel vs its plain version at Qwen2-7B attention shapes
     (Hq 28, Hkv 4, D 128, block 64, bf16 pool), B in {1, 8, 64}, kv_lens
     mixing 0, 1, 63, 64, 65, 2047, 2048 and > 2048 (to 8192), with and
     without a sliding window and the deferred current token, pages of 16
     and 64 tokens, rows of two nearly cancelling keys; every slot of the
     pool no live token maps to holds NaN for the kernel. Planted faults
     include three built into the kernel (-DPD_FAULT=n, see PD_FAULTS): a
     ring stage of the wrong parity, dead rows read instead of zero-filled,
     the remainder product of P left out;
  4. prefill kernel vs its plain version: T in {64, 512, 2048}, q_offset in
     {0, 37, 1000}, a padded tail whose rows must be exactly 0, a window;
     then what the tiling can get wrong: Llama-3-8B heads (4 query heads a
     kv head) beside Qwen2-7B's (7), 1 and 8, T = 100, three rows with their
     own offsets of which one is wholly padding, a window that ends inside a
     key tile, pages of 16 tokens, the 2048 bucket of a 1000-token prompt
     (tail rows exact zeros), a packed prefill group (B = 4 rows at T =
     1801, offsets 0 / 1024 / 37 / 0, also on the int8 and e4m3 pools in
     4a); every slot of the pool no live key maps to holds NaN for the
     kernel.
     Phases 3-4 also plant faults (one 64-token tile read from the wrong
     block, kv_len off by one, P of a key tile against the V tile of the
     neighbouring ring stage) and fail unless the check catches them;
  4a. the quantized pools. The int8 (per-(slot, kv head) bf16 scales) and
     e4m3 entries of the decode kernel vs their plain versions at Llama-3-8B
     heads (32 / 8) and Qwen2-7B heads, B = 64, and at 8 rows of 8192 tokens,
     each with and without window and deferred current token, with a
     zero-length row, the kernel's scales NaN wherever no live token lives.
     Planted faults: V scale left out, K scale of the neighbouring kv head,
     scales read at the logical position, int8 read as uint8, V scale folded
     in before the normaliser, dead rows read (built in) against NaN scales.
     Decode times through the wrapper (``ms``) and as a replayed CUDA graph
     (``device_ms``), here and in 3, and at the served shape (8 rows of about
     560 tokens, Llama-3-8B heads, bf16 and int8 pools, four layers' pools
     cycled past the L2). The same two entries of the prefill kernel at
     T = 2048 behind a 1000-token reused prefix, at two rows and at the
     geometry cases of 4. Times (through the wrapper and as a replayed CUDA
     graph, with TFLOP/s) of all three entries at T in {512, 2048}, offsets
     0 and 1000, and at the 2048 bucket of 1000 tokens. Then the quantized
     writes (plain PyTorch): ``write_kv_quant`` and the engine's batched
     deferred scatter on the card against the CPU, bit for bit;
  5. the 4-bit GEMM kernels gw_gemm, gw_gemm_pipe and gw_gemm_partial vs
     their plain versions at the four Qwen2-7B linears (group 128, s4) with
     M in {1, 5, 8, 64, 100, 127, 128, 130, 512, 2048} (both kernels behind
     each of gw_gemm's and gw_gemm_pipe's entries) and the two Llama-3-8B
     shapes that differ, e2m1 at group 32, ragged edges (N = 3600 at 8 to
     2048 rows), a layer >= 1 of a stack, K splits forced on the tile
     kernels; planted faults (nibbles swapped, the high plane on the low
     plane's scale rows, two's-complement decoding, one K split left out, the
     scale rows of the next ring stage) must fail the same check, and so
     must three kernels built with a fault inside (-DGW_FAULT: gw_gemm_pipe's
     products reading the decoded slot of the wrong parity, its decode
     writing the slot without the swizzle, gw_gemm_partial scaling a group
     by the next one's scales); repeated runs must give the same bits. All
     three are timed at M in {8, 64, 512, 2048} at qkv, gate-up and down
     (gw_gemm at all six linears; gw_gemm_pipe's tile kernel at M >= 512 also
     with 128- and 256-row blocks both) through the wrapper (``ms``) and as a
     replayed CUDA graph (``device_ms``: at small shapes the host's launch
     path outlasts the kernel); then the tile sweep of gw_gemm_partial at the
     three sweep geometries, M = 64;
  6. full-width Qwen2-7B (cut to 8 of its 28 layers, ``QWEN2_LAYERS``;
     bf16, weights from a seeded generator on
     the card, fused as the engine serves them): a prefill of a few prompts
     plus decode steps through the kernels. Every layer's attention output
     is held against the plain version on the same inputs (and a planted
     fault must fail that check); the logits against the same forward
     through plain attention;
  7. serve: the engine behind ``build_app`` on a local port, at its
     defaults (every decode window a replayed CUDA graph, captured by
     ``warmup()``; async decode; one decode step a window), answers ~8
     concurrent /v1/completions requests (two share a 1024-token prefix and
     the second must reuse it), then one lone 1000-token request (its TTFT
     beside the one recorded when every prefill padded to a bucket),
     /health and /worker_status. Every prefill runs at its real length; new
     streams of a step go in packed groups whose first tokens are read back
     in the next step: the line counts the groups, their rows and real
     tokens, the attention operand's padded share, the deferred finishes,
     the largest B of a prefill attention call (some serve must reach B > 1)
     and the peak reserved device memory. Graph replays must have run every decode window, and
     no window without penalties or logprobs may be captured after
     ``warmup()``; launch counts include what each replay launched. The
     bf16 engine, which ``[controls]`` serves next, also captures the stats
     and constrained windows in ``warmup()``'s background (``make_engine``
     waits for them); the other engines leave those to first use.
     ``[decode-graph]``: the same engine runs one fixed greedy batch (8
     prompts of 100-1800 tokens, 32 out) eagerly and graphed with
     ``decode_steps`` 1 and 4, async decode off and on: the token ids must be
     identical; 8 sampled rows must draw differently on two replays of one
     graph; graphs, capture seconds and the shared pool's size.
     ``[step-time]``: ms per output token of 8 steady rows, eager and
     graphed N=1 and N=4, each with async off and on, windows in turns
     there and back, beside the device ms of a token (CUDA events around
     each replay; an eager window takes the graphed windows' mean) and the
     busy share it implies;
  7a. ``[controls]``: the request controls on the same served bf16 engine,
     over HTTP (a word tokenizer for the chat route): logit bias (+100 pins
     a token, -100 keeps the plain run's first token out),
     no_repeat_ngram_size 3, a think budget (the end token where the JAX
     rule puts it), a trie from a temp file, n = 3 sampled (streamed and
     not), top_logprobs 2 on a chat, calculate_loss and return_hidden_states
     against one plain forward (CONTROL_REL_L2; a target shifted by one must
     fail; the hidden loop's tokens the argmax of its own logits, and the
     plain argmax where the top-2 gap exceeds twice the row's largest logit
     error), K3 at one query row and an offset against its plain version.
     Every decode window a replay (constrained and stats keys among them),
     none captured during the phase, K1 and K3 launched, no plain call; two
     planted faults (bias left unapplied, forcing not cleared) must fail;
     the device ms of a replayed window at 8 rows for the plain and stats
     keys and the constrained ones without and with stats;
  7a'. ``[frontend]``: the chat frontend on the same served bf16 engine, a
     piece tokenizer (``_PieceTokenizer``: ids whose text pieces split the
     think and tool-call tags) and a trie from a temp file whose start token
     ``logit_bias`` pins: the forced answer (a think block, then one hermes
     tool call) must come back as ``reasoning_content``, one ``tool_calls``
     entry (name and JSON arguments) and ``finish_reason: "tool_calls"``,
     with and without ``tools``, non-streamed and streamed (the role chunk
     first, the deltas joining to the same fields, no ``content`` delta at
     all); two planted faults (the parser bypassed, a holdback of zero)
     must fail. The routes on the same server: ``/v1/models``, ``/status``,
     ``POST /`` (greedy ids equal ``/v1/completions``'), ``/tokenizer/encode``,
     ``/set_log_level``, ``/cache_status`` (its version advances, the hashes
     a request inserted listed from the old one), ``/metrics``
     (``engine.tokens_generated`` grows by the decode tokens served, the
     TTFT count by the requests), ``/pause`` (no step for 1 s, the request
     done after ``/restart``), ``/start_profile`` / ``/stop_profile`` (a
     Chrome trace naming K3's kernel; a second start answers 409). Every
     decode window a replay, none captured, K1 and K3 launched, no plain
     call, the access log's lines. ``[update-weights]``: a 2-layer cut of
     Qwen2-7B at full width on random weights A, graphs captured, serves;
     random weights B written as a checkpoint under ``build/`` and sent to
     ``/update_weights``: the served prompt loss equals a fresh engine's on
     B (CONTROL_REL_L2, centred) and stays far from A's, the replayed
     window's greedy tokens equal the fresh engine's; a rebinding in place
     of the copy must fail that check; a checkpoint with one tensor of
     another shape answers 400 and the engine serves on;
  7b. speculative decoding, K = 4 drafts a window. ``[spec-shapes]`` (with
     the kernel phases): K3 at the verify shape (B = 64, T = 5, each row
     behind its own 100-2000-token context; bf16 pool with Qwen2-7B heads,
     int8 with Llama-3-8B heads) against its plain version, timed beside K1
     at the same rows, SDPA and the byte bound; gw_gemm at M = 320 (its tile
     kernel) beside cuBLAS bf16 on dequantized weights. ``[spec]``: a second
     engine on the served bf16 Qwen2-7B weights with prompt lookup: one
     verify window at 8 rows (contexts 100-1800) held against the same
     window through plain attention (a ``q_offsets + 1`` fault must fail),
     the normal engine's greedy continuation as drafts accepted at every
     decisive position (top-2 gap above 4x the measured logit error), the
     emitted counts of a window whose second draft is wrong and third right
     through ``_verify_window`` (an acceptance counting past the first
     mismatch must fail); 8 greedy requests of prompts repeating a 128-token
     segment, 64 out, on the normal and the spec engine in turns: tokens
     equal at decisive positions, K3 launched, no plain call, no capture;
     the device ms of a replayed verify and decode window at 8 rows.
     ``[spec-draft]``: a full-width Qwen2-1.5B draft (rollout and verify ms,
     K1 launched on the draft's pool) and a 4-layer cut of Qwen2-7B as its
     own draft (every decisive draft accepted);
  8. the same model with 4-bit weights: the bf16 linears are quantized on
     the card to the GPTQ form the loader emits, fused, and the bf16 copies
     freed. Every linear call of a prefill plus decode steps runs gw_gemm
     and the plain version on the same inputs (a planted fault must fail);
     logits vs the same forward through the plain versions; the distance to
     the bf16 logits is printed. A 4-layer cut repeats this with
     ``variant="pipe"`` and with fp4 weights from the load-time transform;
  9. serve with 4-bit weights as in 7, through gw_gemm, through gw_gemm
     with windows of 4 decode steps, and through gw_gemm_pipe. gw launches
     must be 4 per layer per forward call and plain-version calls 0.
     ``[prefill-pack]`` on each full-width 4-bit engine (also in 11): one
     packed group of 4 prompts (100, 300, 900, 1800 tokens, the last behind
     a reused 1024-token prefix) against each prompt prefilled alone: each
     row's logits within PACK_LOGITS_REL_L2 of a solo whose 4-bit linears
     run the group's GEMM plan, within MODEL_LOGITS_REL_L2 of a solo as
     served, argmax equal where the top-2 gap exceeds 4x the largest
     error, linears at M = the real tokens,
     attention at B = 4, T = the longest row; forward ms against the solos'
     sum. ``[prefill-sync]``: a group dispatched while a decode window is
     in flight, under ``torch.cuda.set_sync_debug_mode("error")``, its
     layers launched while the work queued ahead of it (the window,
     stretched by a GPU spin of about a second) still runs, up to the
     card's launch-queue depth;
 10. full-width Llama-3-8B (cut to 8 of its 32 layers, ``LLAMA_LAYERS``;
     seeded bf16 weights) on an int8 KV
     pool, decode writes in-layer and deferred: every layer's attention held
     against the plain version as in 6; the logits' distance to the bf16-KV
     forward and between the two write modes is printed. A 4-layer cut runs
     and serves with an fp8 pool;
 11. serve Llama-3-8B with 4-bit weights (GPTQ form), int8 KV, prefix cache
     and deferred writes, as in 7: the int8 attention entries must have
     launched, the bf16 and e4m3 ones not, plain-version calls 0.
     ``[spec-eagle]`` on its weights: random EAGLE and EAGLE3 heads at the
     published Llama-3-8B heads' shapes, written as safetensors under
     ``build/`` and read through ``load_eagle_weights``: the checks of
     ``[spec]`` (drafts from each head's rollout), every attention call
     (K3-i8) and 4-bit linear (gw_gemm, M = 320) of a verify held against
     the plain versions, the 8 requests beside the served engine, rollout
     and verify ms. A
     ``[kv-pool]`` line: bytes a block and tokens an auto-sized pool holds
     per pool type. Decode step times with int8 KV deferred, int8 KV
     in-layer and bf16 KV beside the same weights;
 5a. the 8-bit kernels, which have no Pallas counterpart (XLA fusions in the
     JAX package): w8_gemm (its ring kernel below 128 rows, its wgmma tile
     kernel from 128) against its plain version at every linear of Qwen2-7B
     and Qwen2-1.5B and the Qwen2-7B LM head, M in {1, 8, 64, 127, 128, 130,
     776, 1000, 2048}, s8 per channel, e4m3 per tensor / per channel /
     block-128, s8 groupwise (GPTQ values); every s8 and e4m3 code through
     both kernels to its exact value (``[w8-decode]``); act_quant's codes
     and scales equal to the plain version's bit for bit (both paths: 16-byte
     loads and the scalar path of a ragged K, row stride or pointer; rows
     with an element at half their amax, where a reciprocal product alone
     rounds the other way), timed at the W4A8 decode and the W8A8 / W4A8
     prefill shapes; i8_gemm (its ring kernel
     below 128 rows, its wgmma tile kernel from 128) at one group spanning K
     (W8A8) and groups of 128 (W4A8), M in {1, 8, 64, 127, 128, 130, 256,
     776, 1000, 2048}. Faults built in (-DW8_FAULT, -DI8_FAULT, -DACT_FAULT)
     must fail the same checks. Times beside cuBLAS bf16 on dequantized
     weights, the materialising ``x @ w.to(bf16) * s`` and ``torch._int_mm``
     with the codes row-major and column-major, alone and with its epilogue;
 11a. 8-bit weights, quantized on the card by the load-time transform, each
     engine served (each 8-bit kernel launched as often as the forwards call
     it, gw_gemm never, no plain call) with graphed tokens held against
     eager: a 4-layer cut of Qwen2-7B with fp8 block-128; full-width
     Qwen2-7B W4A8, groups of 128 (serve, decode-graph, step-time; every
     act_quant call of the lone-1000 and group-2076 forms bit-equal to the
     plain quantizer and every i8_gemm call held against the plain version
     with a planted fault, ``[model-8bit]``), W8A8 (serve, decode-graph,
     ``[model-8bit]`` likewise) and int8 with the int8 LM head (every linear
     of those forms held likewise; serve, decode-graph, step-time) and
     Qwen2-1.5B int8 (BASELINE config 2; serve, decode-graph, step-time);
 12. profiled windows of decode steps, eager and replayed as graphs (device
     busy share from kernel time only, launches a step, top kernels) of the
     three Llama-3-8B engines, the two int8 engines and the three Qwen2-7B
     engines (the W4A8 one graphed only), and of three
     prefill forwards summed by kernel name: a lone 1000-token prompt padded
     to its 2048-row bucket, the same at its own length, one packed group
     of four prompts (2076 rows), also of the W8A8 and W4A8 engines
     (i8_gemm's and act_quant's ms and launches apart). They come last,
     because a profiler window slows every later launch of the process;
 5b. ``[lora-kernel]``: X4 ``lora_bgmv`` (the segment pass, shrink and
     expand, rows grouped by adapter, each adapter read in place) against
     its plain version at the Qwen2-7B fused linears with rank-16 and
     rank-64 adapters on all seven targets (the shrink over the members' A
     joined along r, the expand into each member's columns), N 64 / 320 /
     2048, ids over {0, X, Y}, all 0, one adapter, eight adapters: the
     segment record, t and the delta within one bf16 ulp, y in place, id-0
     rows bit-equal, two graph replays bit-equal; three faults built in
     (-DLORA_BGMV_FAULT=1..3) must fail; rank-16 times (and the segment
     pass's) beside cuBLAS's one-adapter ``x @ A``, ``t @ B`` and the byte
     bound of this run's ids;
 7c. ``[beam]`` on the served bf16 Qwen2-7B and (in 11) on the Llama-3-8B
     int4 + int8 KV deferred engine: a num_beams 4 request (1000-token
     prompt, 32 out) beside 7 greedy streams, free blocks poisoned with NaN
     (int8: their scales): every hypothesis's cum_logprob against a
     teacher-forced recompute within an unforked width-1 run's summed
     per-token error,
     greedy tokens bit-equal to a run without the group, no block leaked,
     K1 / K3 launched, no plain call or capture; planted faults (the tail
     copy left out; the codes copied without their scales) must fail;
     ``[lora]`` on the same bf16 engine: two adapters written under
     ``build/lora/`` and added through ``POST /v1/loras`` (every graph
     captured again; base-only rows then bit-equal to before, their
     windows timed), 8 rows mixing X, Y and none at decode_steps 1 and 4
     (base rows bit-equal to before, X rows moved, every row's served
     logprobs against a teacher-forced plain forward under its adapter; a
     planted swap of two slots' adapters must fail), X4 launched, no
     capture while serving, ``DELETE`` Y (then 400), the static merge
     against the dynamic adapter on a 4-layer cut;
 5c. ``[head-dim]``: each attention entry (decode, prefill; bf16, int8,
     e4m3 pools) at head_dim 64 (Qwen2-0.5B's 14 / 2 heads), 96
     (Phi-3-mini's 32 / 32), 128 (Gemma-2-27B's 32 / 16) and 256
     (Gemma-2-9B's 16 / 8, Gemma-7B's 16 / 16, and 16 / 2) against its
     plain version, with and without a window and the deferred current
     token, uncapped and under a soft-cap of 5 that queries scaled by 4
     reach, contexts past 2048 and past the window, dead slots NaN; builds
     with S's last k16 step left out (-DPD_FAULT=4, -DPP_FAULT=1) and the
     cap's tanh left out (-DPD_FAULT=5, -DPP_FAULT=2) must fail; times
     beside SDPA and the bound (D 256 capped and not, also 8 rows of
     8192);
 12. after the profiler windows, every earlier engine released
     (``phase_families``): ``[qwen2-0.5b]`` (full width, 64 slots, bf16 /
     int8 / fp8 pools), ``[phi3]`` and ``[mistral-swa]`` (Phi-3-mini-4k,
     Mistral-7B-v0.1 at full width: prompts past the window served with
     sliding-window block recycling beside the same engine without it and
     with the prefix cache: at most ``ceil(W / 64) + 2`` distinct blocks a
     stream, the pool whole after, tokens bit-equal, served logprobs against
     a teacher-forced plain forward; Phi-3 cuts on int8 / fp8 pools),
     ``[act-order]`` (Mistral-7B GPTQ-form with act-order permutations
     through K4 and K5 against the plain dequantized forward; a 4-layer cut
     with a permutation a member, unfused; the gathers' ms a decode step),
     ``[internlm2]`` (a 4-layer checkpoint with a grouped ``wqkv``, loaded
     and run against plain attention), ``[gemma2]`` (Gemma-2-9B bf16 at 42
     layers on split pools, 8 slots: pool bytes as sized, 8 prompts of
     500-6000 tokens, tokens equal at ``decode_steps`` 4, teacher-forced
     logprobs, TTFT, decode tok/s, serving memory), ``[gemma2-kv]`` (a
     4-layer cut on int8 / fp8 split pools) and ``[gemma]`` (Gemma-7B's
     MHA heads, a 4-layer cut, bf16 / int8 pools); the D 64 / 96 / 256
     entries must launch there and plain attention never; then the ALiBi,
     multi-query and partial-rotary families (``phase_partial_rotary_families``:
     Phi-2 at full width and depth with every K1 / K3 launch in the ``_d80``
     entries, also on int8 / fp8 pools; GLM-4-9B-0414 and ChatGLM3-6B in the
     ``_g9to16`` mode, GPT-NeoX-20B at D 96, Qwen-7B; each TTFT, tok/s, peak
     memory and teacher-forced logprobs);
 12'. ``[longrope]`` (``phase_longrope``): Phi-3-mini's widths at full
     depth with a longrope block of seeded factor lists (original 4096,
     131072 positions): a 3900-token stream decodes past the switch inside
     the decode graphs, a 4300-token one prefills on the long table; layer
     0's pooled key rows each turned by its stream's table at that step,
     the served logprobs against a teacher-forced plain forward that picks
     the tables as the served forwards did, prefix blocks never shared
     across tables, every K1 / K3 launch in the D 96 entries;
     ``[moe-kernels]`` / ``[moe-time]`` (in the kernels stage): X6
     ``moe_grouped_gemm`` (its ``wgmma`` kernel at 64-, 128- and 160-row
     tiles) against the plain grouped product (summed in f32) at Qwen3-30B-A3B's, Qwen1.5-MoE-A2.7B's and Mixtral-8x7B's expert
     shapes, 64 decode slots and 2048 prefill tokens, random and skewed
     routing (empty experts), gate-up through the token gather and down, at
     every tile height and through the wrapper, and at a synthetic shape
     whose K and N are off multiples of 64 (``MOE_RAGGED``); four faults
     built in with -DMOE_GEMM_FAULT=1..4 must fail the same check; the
     sweep (``MOE_SWEEP_TOKENS``, and each model's tokens at
     ``MOE_SWITCH_ROWS`` rows an expert around the switch) times every tile
     height beside the bound, the plain version and ``torch._grouped_mm``
     (the down product also through a build that gathers its x rows
     instead of a TMA map) and prints each token count's fastest beside
     ``tile_rows``' pick (``[moe-switch]``);
     ``[moe]`` (``phase_moe_families``):
     Qwen1.5-MoE-A2.7B (28.6 GB) and Qwen3-30B-A3B (61.1 GB) at full depth,
     Mixtral-8x7B at 8 of 32 layers, each served as the families are (TTFT,
     tok/s, X6 / K1 / K3 launched and no plain call, ``decode_steps`` 4
     tokens equal) with its served logprobs against the plain teacher
     (``_moe_teacher_check``: decisive tokens equal, 90% of positions
     within the tolerance, routing flips between the plain and kernel
     forms counted), X6's launches by tile height, a graphed decode step's and a lone 1000-token prefill
     forward's kernel time with X6 apart;
 13. one ``kernels`` JSON line: launches of each kernel on its path (each
     must be > 0, plain-version calls there must be 0; the speculative
     phases' launches added to their kernels' rows), max error against the
     plain version, and kernel / plain / library / bound times at the main
     path's shapes.
The last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense), see PERF.md
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

HQ, HKV, D, BS = 28, 4, 128, 64
# kernel vs plain, both rounding the output to bf16: every element within
# ATOL + RTOL * |want| (RTOL spans one bf16 ulp, 2**-7), and per (row,
# token, head) the relative L2 distance over D within REL_L2. Two roundings
# of one value differ by ~1-3e-3 there; one 64-token tile of an 8192-token
# row read from the wrong block moves that row by several 1e-2.
ATOL, RTOL, REL_L2 = 2e-3, 1e-2, 1e-2
# full-width logits, relative L2 kernel path vs plain path. Coarse on
# purpose: bf16 rounding alone moves random-weight logits by a few 1e-2
# over 28 layers; the tight check is the per-layer one at REL_L2.
MODEL_LOGITS_REL_L2 = 0.1
# 4-bit GEMM kernel vs its plain version, both f32 sums rounded once to bf16.
# The two sum in different orders, so an f32 difference of ~1e-6 relative
# now and then lands on the other side of a bf16 rounding boundary: one ulp,
# 2**-8 relative, which GW_RTOL spans. Near zero the difference is f32 noise,
# far below GW_ATOL times the row's rms. Per row the relative L2 distance
# stays near 5e-4 (flips are rare); a wrong scale row, nibble or decoding
# moves it to 1e-1 and more.
GW_ATOL, GW_RTOL, GW_REL_L2 = 1e-3, 1e-2, 2e-3
GW_GROUP = 128
GW_SHAPES = {"qkv_proj": (3584, 4608), "o_proj": (3584, 3584),
             "gate_up_proj": (3584, 37888), "down_proj": (18944, 3584)}
# the rows a served packed prefill gives the linears: a 776-token row behind
# a cached prefix, a lone 1000-token prompt, the group of four of
# [prefill-pack] (2076 = 8 x 256 + 28: a ragged 256-row tile of gw_gemm_pipe)
GW_PACKED_MS = (776, 1000, 2076)
GW_MS = (1, 5, 8, 64, 100, 127, 128, 130, 512, 2048) + GW_PACKED_MS
GW_TIMED_MS = (8, 64, 512, 2048)
# the linears at which all three 4-bit kernels are timed (gw_gemm at all six)
GW_ALL_TIMED = ("qkv_proj", "gate_up_proj", "down_proj")
# the 4-bit kernels built with a planted fault (-DGW_FAULT=n): (name, variant,
# source, define, rows at which the faulty kernel runs)
GW_FAULTS = (("pipe_slot_of_the_wrong_parity", "pipe", "gw_gemm_pipe.cu", "GW_FAULT=1", 512),
             ("pipe_decoded_slot_unswizzled", "pipe", "gw_gemm_pipe.cu", "GW_FAULT=2", 512),
             ("partial_scales_of_the_next_group", "partial", "gw_gemm_partial.cu", "GW_FAULT=3", 64))
# the decode kernel built with a planted fault (-DPD_FAULT=n): (name, define)
PD_FAULTS = (("ring_stage_of_the_wrong_parity", "PD_FAULT=1"),
             ("dead_rows_not_zero_filled", "PD_FAULT=2"),
             ("remainder_product_left_out", "PD_FAULT=3"))
# the two Llama-3-8B linears whose shapes differ from every Qwen2-7B one
GW_LLAMA_SHAPES = {"llama_gate_up_proj": (4096, 28672), "llama_down_proj": (14336, 4096)}
# lone 1000-token TTFT (ms) of each serve phase as PERF.md records it for the
# engine that padded every prefill to a bucket (2048 rows for this prompt),
# the last run before prefill ran at the prompt's length (NVIDIA H100 80GB
# HBM3, 700 W)
# Qwen2-7B's and Llama-3-8B's paths run at their full widths cut to 8
# layers, which keeps the script within 800 s of stages on one H100 beside
# the MoE and longrope phases (at full depth it read 892-925 s; 28 layers
# of Qwen2-7B took 218-262 s of it, 32 of Llama-3-8B 131 s; at 14 / 16
# layers the stages took 697.3 s before those phases, 881.0 s with them on
# a slower host)
QWEN2_LAYERS = 8
QWEN2_NAME = f"qwen2-7b-{QWEN2_LAYERS}-layers"
LLAMA_LAYERS = 8
LLAMA_NAME = f"llama3-8b-{LLAMA_LAYERS}-layers"
TTFT_BEFORE = {("qwen2-7b", "bf16", None, "bfloat16"): 131.6,
               ("qwen2-7b", "int4", "base", "bfloat16"): 119.9,
               ("qwen2-7b", "int4", "pipe", "bfloat16"): 117.8,
               ("llama3-8b", "int4", "base", "int8"): 128.6}
# packed prefill against each prompt prefilled alone with its 4-bit linears
# at the group's GEMM plan: relative L2 distance of each row's first-token
# logits. Every op then sums a row in the same order in both forwards, but
# the library GEMMs (LM head, zero correction) may pick other algorithms at
# other M, and bf16 rounds what differs.
PACK_LOGITS_REL_L2 = 1e-2
# [prefill-sync]: layers of a group's forward that must be launched while a
# second's spin queued ahead of it still runs. The card's launch queue held
# about 1000 launches: 14 of 28 layers (Qwen2-7B int4, either GEMM, 72
# launches a layer) and 10 of 32 (Llama-3-8B int4 + int8 KV, 103 a layer)
# on an H100 80GB HBM3 at 700 W, two runs each (PERF.md). 80% of that,
# rounded down; a synchronisation in any layer stops the count at it. (The
# Qwen2-7B and Llama-3-8B paths run QWEN2_LAYERS / LLAMA_LAYERS layers,
# fewer than either count: all of them must launch before the queue is
# full.)
SYNC_MIN_LAYERS = {"qwen2": min(11, QWEN2_LAYERS), "llama": min(8, LLAMA_LAYERS)}
SWEEP_GEOMS = ((3584, 18944), (18944, 3584), (3584, 4608))
SWEEP_TILES = ((16, 64, 1), (16, 128, 1), (32, 64, 1), (32, 128, 1), (64, 64, 1), (64, 128, 1),
               (16, 64, 4), (32, 64, 4), (32, 128, 4))  # (bm, bn, K splits)


def _line(tag: str, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


@contextlib.contextmanager
def _stage(name):
    """``[stage] name=... seconds=...`` after the body: the wall time of each
    top-level stage of ``main``, and (as a decorator) of each call of the
    model phases' parts, so that the whole run's seconds add up."""
    t0 = time.time()
    try:
        yield
    finally:
        _line("stage", name=name, seconds=f"{time.time() - t0:.1f}")


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls, reps=5):
    """Device time of one call of ``fn``: ``calls`` of them captured into one
    CUDA graph and replayed, so that the host's launch path (which exceeds
    the kernel's time at the small shapes) is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        for _ in range(min(calls, 3)):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _check(got, want):
    """(max abs error, max relative L2 over D, ok) of ``got`` against the
    plain version ``want``. A vector that is zero in ``want`` (kv_len 0, a
    padded tail row) must be exactly zero in ``got``."""
    import torch

    g, w = got.float(), want.float()
    diff = g - w
    dn, wn = diff.norm(dim=-1), w.norm(dim=-1)
    rel = torch.where(wn > 0, dn / wn.clamp_min(1e-30),
                      torch.where(dn > 0, float("inf"), 0.0))
    err, max_rel = float(diff.abs().max()), float(rel.max())
    ok = (bool(torch.isfinite(g).all()) and max_rel <= REL_L2
          and not bool((diff.abs() > ATOL + RTOL * w.abs()).any()))
    return err, max_rel, ok


def _check_gemm(got, want):
    """(max abs error, max relative L2 per row, ok) of a GEMM output against
    its plain version, see GW_ATOL / GW_RTOL / GW_REL_L2."""
    import torch

    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    diff = g - w
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rel = diff.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    err, max_rel = float(diff.abs().max()), float(rel.max())
    ok = (bool(torch.isfinite(g).all()) and max_rel <= GW_REL_L2
          and not bool((diff.abs() > GW_ATOL * rms + GW_RTOL * w.abs()).any()))
    return err, max_rel, ok


def _planted(tag, cases, check=None):
    """Each (name, got, want) is a kernel run with a planted fault: the check
    must fail it, or it cannot tell a wrong kernel from a right one."""
    check = check or _check
    missed = []
    for name, got, want in cases:
        _, rel, ok = check(got, want)
        _line(tag, fault=name, max_rel_l2=f"{rel:.3e}", caught=not ok)
        if ok:
            missed.append(name)
    if missed:
        raise SystemExit(f"{tag}: the check does not catch {missed}")


# ---------------------------------------------------------------- phase 1-2


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, card=card.replace(" ", "_"))
    return card


def phase_build():
    # the kernels are built from this checkout's sources: the package must
    # sit beside this script, not come from an installed copy elsewhere
    import rtp_llm_tpu_torch

    here = os.path.dirname(os.path.abspath(__file__))
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(rtp_llm_tpu_torch.__file__)))
    if pkg_root != here:
        raise SystemExit(f"chip_smoke: rtp_llm_tpu_torch comes from {pkg_root}, "
                         f"not from this checkout ({here})")
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import lora, moe, quant_gemm, quant_gemm8
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    kernels = [*decode.KERNELS_BY_DIM.values(), *prefill.KERNELS_BY_DIM.values(),
               *quant_gemm.KERNELS.values(), *quant_gemm8.KERNELS.values(),
               *lora.KERNELS.values(), *moe.KERNELS.values(),
               *_moe_fault_kernels().values(), _moe_gather_kernel(),
               *_gw_fault_kernels().values(), *_pd_fault_kernels().values(),
               *_hd_fault_kernels().values(), *_group_fault_kernels().values(),
               *_alibi_fault_kernels().values(),
               *(k for _, k in _group_wide_fault_kernels().values()),
               *(k for _, k in _q8_fault_kernels().values()), _act_divide_kernel(),
               *_lora_fault_kernels().values()]
    secs = _kernels.build_all(kernels)  # one nvcc per source, all started together
    for lib in {id(k.lib): k.lib for k in kernels}.values():
        notes = [ln.strip() for ln in lib.build_log.splitlines()
                 if "warning" in ln.lower() or "serializ" in ln.lower()]
        if notes:  # ptxas names a real loss here, e.g. "wgmma ... serialized"
            _line("ptxas-note", source=os.path.basename(lib.source), flags=" ".join(
                f for f in lib.flags if f.startswith("-D")) or "-", notes=" | ".join(notes))
        info = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        if len(info) > 4:  # a source of many template instances: the extremes
            regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in info
                    if "Used " in ln]
            smem = [int(ln.split(" bytes smem")[0].split()[-1]) for ln in info
                    if " bytes smem" in ln]
            spills = [ln for ln in info if "spill" in ln and "0 bytes spill stores" not in ln]
            info = [f"{len(regs)} kernels", f"registers {min(regs)}-{max(regs)}",
                    f"static smem {min(smem)}-{max(smem)} B" if smem else "no static smem",
                    f"spilling kernels {len(spills)}"] + spills
        _line("ptxas", source=os.path.basename(lib.source),
              flags=" ".join(f for f in lib.flags if f.startswith("-D")) or "-",
              entries=",".join(k.entry for k in kernels if k.lib is lib),
              info=" | ".join(info) or "cached")
    _line("build", seconds=f"{secs:.1f}", kernels=",".join(k.name for k in kernels))


# ---------------------------------------------------------------- phase 3


def _pool(num_blocks, gen, bs=BS, hkv=HKV):
    import torch

    shape = (num_blocks * bs, hkv * D)
    k = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    return k, v


def _tables(lens, mb, gen, bs=BS):
    """Distinct random blocks per row (block 0 stays the null block)."""
    import torch

    need = [max(1, -(-int(n) // bs)) for n in lens]
    perm = torch.randperm(sum(need) + 8, generator=gen, device="cuda") + 1
    bt = torch.zeros((len(lens), mb), dtype=torch.int32, device="cuda")
    i = 0
    for r, n in enumerate(need):
        bt[r, :n] = perm[i:i + n].to(torch.int32)
        i += n
    return bt, sum(need) + 9


def _kv_bucket_blocks(max_len):
    mb = -(-max_len // BS)
    b = 8
    while b < mb:
        b *= 2
    return min(b, 8192 // BS)


def _sdpa_decode(q, k_cache, v_cache, bt, lens, window, hkv=HKV):
    """Library yardstick: F.scaled_dot_product_attention over the gathered KV
    (a bf16 pool; a quantized pool is dequantized to one first)."""
    import torch
    import torch.nn.functional as F

    b, mb = bt.shape
    s = mb * BS
    idx = (bt.long()[:, :, None] * BS + torch.arange(BS, device="cuda")).reshape(b, s)
    kk = k_cache[idx].reshape(b, s, hkv, D).transpose(1, 2).contiguous()
    vv = v_cache[idx].reshape(b, s, hkv, D).transpose(1, 2).contiguous()
    pos = torch.arange(s, device="cuda")[None, :]
    mask = pos < lens.long()[:, None]
    if window:
        mask &= pos >= (lens.long()[:, None] - window)
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    return _sdpa_call(qq, kk, vv, mask)


def _sdpa_call(q, k, v, mask):
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


@functools.lru_cache(maxsize=None)
def _pd_fault_kernels():
    """The decode kernel built with a planted fault, by (fault name, pool dtype)."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops.attention import decode

    return {(name, dt): _kernels.Kernel(f"{k.name}:{name}", "paged_decode.cu", k.entry,
                                        decode._ARGTYPES, defines=(define,))
            for name, define in PD_FAULTS for dt, k in decode.KERNELS.items()}


@contextlib.contextmanager
def _decode_fault(name):
    """``paged_decode_attention`` launches the build with fault ``name``."""
    from rtp_llm_tpu_torch.ops.attention import decode

    saved = dict(decode.KERNELS)
    decode.KERNELS.update({dt: k for (n, dt), k in _pd_fault_kernels().items() if n == name})
    try:
        yield
    finally:
        decode.KERNELS.update(saved)


def _few_cancelling_keys(gen, rows=8, hq=HQ, hkv=HKV):
    """Rows of two keys whose scores nearly tie (the second key is the first
    plus 5% noise) and whose V rows nearly cancel (v2 = -0.95 v1): each
    output is a small difference of two large terms, so P rounded to bf16
    without its remainder moves it by a few 1e-2 relative
    (tests/test_torch_decode_tiles.py holds the same construction)."""
    import torch

    lens = torch.full((rows,), 2, dtype=torch.int32, device="cuda")
    bt, nblocks = _tables([2] * rows, 2, gen)
    k, v = _pool(nblocks, gen, hkv=hkv)
    s0 = bt[:, 0].long() * BS
    noise = torch.randn((rows, hkv * D), generator=gen, device="cuda")
    k[s0 + 1] = (k[s0].float() + 0.05 * noise).to(torch.bfloat16)
    v[s0] = (v[s0].float() * 4).to(torch.bfloat16)
    v[s0 + 1] = (-0.95 * v[s0].float()).to(torch.bfloat16)
    q = torch.randn((rows, hq, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    return q, k, v, bt, lens


def _decode_times(run, plain, library, calls=8):
    """(host-loop ms, device ms, plain ms, library device ms) of a decode
    call: ``ms`` through the wrapper in a host loop, ``device_ms`` as a
    replayed CUDA graph of ``calls`` calls (the host's launch path out)."""
    return (_time_ms(run), _graph_ms(run, calls), _time_ms(plain, iters=5, warmup=1),
            _graph_ms(library, calls))


def phase_decode(gen):
    import torch

    from rtp_llm_tpu_torch.ops.attention.decode import (
        paged_decode_attention, paged_decode_ref,
    )

    specials = [0, 1, 63, 64, 65, 2047, 2048, 8192]
    cases = {
        1: [5000],
        8: specials,
        64: specials[:-1] + [2048] * 56 + [3000],
    }
    sm = D ** -0.5
    worst, record = 0.0, None
    for b, lens_l in cases.items():
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        mb = _kv_bucket_blocks(max(lens_l))
        bt, nblocks = _tables(lens_l, mb, gen)
        k_cache, v_cache = _pool(nblocks, gen)
        # the kernel reads a pool whose dead slots hold NaN
        kp, vp = _poison_dead_slots(k_cache, v_cache, bt, lens)
        q = torch.randn((b, HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        ck = torch.randn((b, HKV * D), generator=gen, device="cuda", dtype=torch.bfloat16)
        cv = torch.randn((b, HKV * D), generator=gen, device="cuda", dtype=torch.bfloat16)
        for window in (0, 1000):
            for cur in (False, True):
                kw = dict(sliding_window=window, cur_k=ck if cur else None,
                          cur_v=cv if cur else None)
                got = paged_decode_attention(q, kp, vp, bt, lens, sm, BS, **kw)
                want = paged_decode_ref(q, k_cache, v_cache, bt, lens, sm, BS, **kw)
                torch.cuda.synchronize()
                err, rel, ok = _check(got, want)
                zero_rows = bool((got[lens == 0] == 0).all())
                ok = ok and zero_rows
                _line("decode", B=b, mb=mb, window=window, cur=cur, dead_slots="NaN",
                      max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}",
                      zero_rows_ok=zero_rows, ok=ok)
                if not ok:
                    raise SystemExit(f"decode kernel disagrees with plain (B={b}, "
                                     f"window={window}, cur={cur})")
                worst = max(worst, err)
        # timing at the main path's mode: no window, in-layer KV writes
        run = lambda: paged_decode_attention(q, k_cache, v_cache, bt, lens, sm, BS)
        plain = lambda: paged_decode_ref(q, k_cache, v_cache, bt, lens, sm, BS)
        if b == 8:
            # the 8192-token row reads its 100th tile from another block
            row = lens_l.index(8192)
            bt_bad = bt.clone()
            bt_bad[row, 100] = bt[lens_l.index(2048), 0]
            want = plain()
            # faults built into the kernel (-DPD_FAULT=n); dead rows read from
            # the poisoned pool, where the right kernel passed above
            with _decode_fault("ring_stage_of_the_wrong_parity"):
                wrong_stage = paged_decode_attention(q, k_cache, v_cache, bt, lens, sm, BS)
            with _decode_fault("dead_rows_not_zero_filled"):
                dead_rows = paged_decode_attention(q, kp, vp, bt, lens, sm, BS)
            fq, fk, fv, fbt, flens = _few_cancelling_keys(gen)
            few_want = paged_decode_ref(fq, fk, fv, fbt, flens, sm, BS)
            few_got = paged_decode_attention(fq, fk, fv, fbt, flens, sm, BS)
            torch.cuda.synchronize()
            err, rel, ok = _check(few_got, few_want)
            _line("decode", case="few_cancelling_keys", B=len(flens), max_abs_err=f"{err:.3e}",
                  max_rel_l2=f"{rel:.3e}", ok=ok)
            if not ok:
                raise SystemExit("decode kernel disagrees with plain (few cancelling keys)")
            with _decode_fault("remainder_product_left_out"):
                no_remainder = paged_decode_attention(fq, fk, fv, fbt, flens, sm, BS)
            _planted("decode-fault", [
                ("one_tile_of_8192_row", paged_decode_attention(
                    q, k_cache, v_cache, bt_bad, lens, sm, BS), want),
                ("built_in:ring_stage_of_the_wrong_parity", wrong_stage, want),
                ("built_in:dead_rows_not_zero_filled", dead_rows, want),
                ("built_in:remainder_product_left_out", no_remainder, few_want)])
        if b == 64:
            # rows of >= 2048 tokens attend one key fewer
            want = plain()
            _planted("decode-fault", [
                ("kv_len_minus_1_long_rows", paged_decode_attention(
                    q, k_cache, v_cache, bt, lens - (lens >= 2048).int(), sm, BS), want)])
        ms, device_ms, plain_ms, lib_ms = _decode_times(
            run, plain, _sdpa_decode(q, k_cache, v_cache, bt, lens, 0))
        ntok = float(lens.clamp_min(0).sum())
        nbytes = ntok * HKV * D * 2 * 2 + 2 * b * HQ * D * 2 + bt.numel() * 4 + b * 4
        flops = 4.0 * ntok * HQ * D
        bound, by = _bound_ms(nbytes, flops)
        _line("decode-time", B=b, Hq=HQ, Hkv=HKV, ctx_tokens=int(ntok), ms=f"{ms:.4f}",
              device_ms=f"{device_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
              share_of_bound=f"{bound / device_ms:.2f}")
        if b == 64:
            record = dict(ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
    # other page sizes: the kernel addresses any block_size
    for bs in (16, 64):
        lens_l = specials
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        bt, nblocks = _tables(lens_l, -(-max(lens_l) // bs), gen, bs)
        k_cache, v_cache = _pool(nblocks, gen, bs)
        kp, vp = _poison_dead_slots(k_cache, v_cache, bt, lens, bs)
        q = torch.randn((len(lens_l), HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        got = paged_decode_attention(q, kp, vp, bt, lens, sm, bs)
        want = paged_decode_ref(q, k_cache, v_cache, bt, lens, sm, bs)
        torch.cuda.synchronize()
        err, rel, ok = _check(got, want)
        _line("decode", B=len(lens_l), block_size=bs, table="exact", dead_slots="NaN",
              max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", ok=ok)
        if not ok:
            raise SystemExit(f"decode kernel disagrees with plain (block_size={bs})")
        worst = max(worst, err)
    record["max_abs_err"] = worst
    return record


# ---------------------------------------------------------------- phase 4


def _sdpa_prefill(q, k_cache, v_cache, bt, q_off, kv_len, hkv=HKV):
    import torch

    t = q.shape[1]
    s = bt.shape[1] * BS
    idx = (bt[0].long()[:, None] * BS + torch.arange(BS, device="cuda")).reshape(s)
    kk = k_cache[idx].reshape(1, s, hkv, D).transpose(1, 2).contiguous()
    vv = v_cache[idx].reshape(1, s, hkv, D).transpose(1, 2).contiguous()
    qpos = q_off + torch.arange(t, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = ((kpos <= qpos) & (kpos < kv_len))[None, None]
    return _sdpa_call(q.transpose(1, 2).contiguous(), kk, vv, mask)


def _poison_dead_slots(k, v, bt, lens, bs=BS):
    """Copies of a bf16 or e4m3 pool with NaN in every slot no live key maps
    to (the null block, rows past kv_len, free blocks): a kernel that read one
    would return NaN. The plain version gathers whole blocks and keeps the
    clean pool."""
    import torch

    slots, _, live = _slot_grid(bt, lens, bs)
    dead = torch.ones(k.shape[0], dtype=torch.bool, device="cuda")
    dead[slots[live]] = False
    kp, vp = k.clone(), v.clone()
    for pool in (kp, vp):
        if pool.element_size() == 1:
            pool.view(torch.uint8)[dead] = 0x7F  # e4m3 NaN
        else:
            pool[dead] = float("nan")
    return kp, vp


def _v_one_stage_off(v, bt, lens, stage=64, bs=BS):
    """A V pool as a kernel would see it that multiplied P of key tile i with
    the V tile of the neighbouring ring stage: the slot of position p holds
    the row of position p + 64."""
    slots, pos, live = _slot_grid(bt, lens, bs)
    out = v.clone()
    ok = live[:, :-stage] & live[:, stage:]
    out[slots[:, :-stage][ok]] = v[slots[:, stage:][ok]]
    return out


def _prefill_flops(t, offs_l, lens_l, hq, window=0):
    pairs = 0
    for off, kv_len in zip(offs_l, lens_l):
        for i in range(t):
            if off + i < kv_len:
                n = min(off + i + 1, kv_len)
                pairs += min(n, window) if window else n
    return 4.0 * pairs * hq * D


# (name, Hq, Hkv, T, q_offsets, kv_lens, window, block size): what the tiling
# can get wrong. Llama-3-8B heads (G = 4) beside Qwen2-7B's (G = 7); G = 1
# and G = 8; T not a multiple of the query tile; three rows with their own
# offsets, one wholly padding; a window that ends inside a key tile; pages
# of 16 tokens; the 2048 bucket of a 1000-token prompt; a packed group.
PREFILL_GEOMETRY = (
    ("llama_heads", 32, 8, 2048, [0], [2048], 0, BS),
    ("llama_heads_prefix", 32, 8, 512, [1000], [1512], 0, BS),
    ("g1", 8, 8, 300, [37], [337], 0, BS),
    ("g8", 32, 4, 300, [37], [337], 0, BS),
    ("t_100", HQ, HKV, 100, [0], [100], 0, BS),
    ("t_100_llama", 32, 8, 100, [1000], [1100], 0, BS),
    ("three_rows_one_padding", 32, 8, 512, [0, 37, 700], [500, 549, 700], 0, BS),
    ("three_rows_qwen", HQ, HKV, 100, [5, 0, 300], [105, 60, 250], 0, BS),
    ("window_inside_tile", 32, 8, 512, [37], [549], 100, BS),
    ("window_qwen_two_rows", HQ, HKV, 512, [0, 1000], [512, 1400], 333, BS),
    ("block_16_llama", 32, 8, 300, [0, 37], [290, 337], 0, 16),
    ("bucket_tail_2048_of_1000", 32, 8, 2048, [0], [1000], 0, BS),
    # a packed prefill group: four rows at their real lengths, T = the
    # longest (not a multiple of 64), one behind a reused 1024-token prefix
    ("ragged_four_rows", 32, 8, 1801, [0, 1024, 37, 0], [1801, 1800, 337, 100], 0, BS),
    ("bucket_tail_qwen", HQ, HKV, 2048, [0], [1000], 0, BS),
)


def _prefill_inputs(gen, hq, hkv, t, offs_l, lens_l, bs):
    import torch

    b = len(offs_l)
    mb = -(-max(o + t for o in offs_l) // bs) + 1
    bt, nblocks = _tables([o + t for o in offs_l], mb, gen, bs)
    kb, vb = _pool(nblocks, gen, bs, hkv)
    q = torch.randn((b, t, hq, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    offs = torch.tensor(offs_l, dtype=torch.int32, device="cuda")
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    return q, kb, vb, bt, offs, lens


def _padded_rows_zero(got, t, offs, lens):
    import torch

    pos = offs.long()[:, None] + torch.arange(t, device="cuda")[None, :]
    return bool((got[pos >= lens.long()[:, None]] == 0).all())


def phase_prefill(gen):
    import torch

    from rtp_llm_tpu_torch.ops.attention.prefill import (
        paged_prefill_attention, paged_prefill_ref, tile_plan,
    )

    sm = D ** -0.5
    worst, record = 0.0, None
    cases = [(t, off, 0, 0) for t in (64, 512, 2048) for off in (0, 37, 1000)]
    cases += [(512, 37, 13, 0), (2048, 1000, 300, 0), (512, 37, 0, 100)]
    for t, off, tail, window in cases:
        kv_len = off + t - tail
        q, k_cache, v_cache, bt, offs, lens = _prefill_inputs(gen, HQ, HKV, t, [off], [kv_len], BS)
        kp, vp = _poison_dead_slots(k_cache, v_cache, bt, lens)
        got = paged_prefill_attention(q, kp, vp, bt, offs, lens, sm, BS, sliding_window=window)
        args = (q, k_cache, v_cache, bt, offs, lens, sm, BS)
        want = paged_prefill_ref(*args, sliding_window=window)
        torch.cuda.synchronize()
        err, rel, ok = _check(got, want)
        tail_ok = bool((got[:, t - tail:] == 0).all()) if tail else True
        ok = ok and tail_ok
        _line("prefill", T=t, q_offset=off, tail=tail, window=window, dead_slots="NaN",
              max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", tail_zero=tail_ok, ok=ok)
        if not ok:
            raise SystemExit(f"prefill kernel disagrees with plain (T={t}, "
                             f"q_offset={off}, tail={tail}, window={window})")
        worst = max(worst, err)
        if tail or window or off == 37 or t == 64:
            continue
        # through the wrapper, and as a replayed CUDA graph (the device's own time)
        ms = _time_ms(lambda: paged_prefill_attention(*args), iters=10)
        device_ms = _graph_ms(lambda: paged_prefill_attention(*args), 8)
        plain_ms = _time_ms(lambda: paged_prefill_ref(*args), iters=3, warmup=1)
        lib_ms = _graph_ms(_sdpa_prefill(q, k_cache, v_cache, bt, off, kv_len), 8)
        flops = _prefill_flops(t, [off], [kv_len], HQ)
        nbytes = 2 * t * HQ * D * 2 + kv_len * HKV * D * 2 * 2 + bt.numel() * 4
        bound, by = _bound_ms(nbytes, flops)
        _line("prefill-time", pool="bf16", Hq=HQ, Hkv=HKV, T=t, q_offset=off, ms=f"{ms:.4f}",
              device_ms=f"{device_ms:.4f}", tflops=f"{flops / device_ms / 1e9:.1f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
              bound_by=by)
        if t == 2048 and off == 0:
            record = dict(ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
            # the 10th key tile read from the null block; kv_len one short;
            # P of a key tile against the V tile of the neighbouring stage
            bt_bad = bt.clone()
            bt_bad[0, 10] = 0
            _planted("prefill-fault", [
                ("one_tile_from_null_block", paged_prefill_attention(
                    q, k_cache, v_cache, bt_bad, offs, lens, sm, BS), want),
                ("kv_len_minus_1", paged_prefill_attention(
                    q, k_cache, v_cache, bt, offs, lens - 1, sm, BS), want),
                ("v_tile_of_neighbouring_stage", paged_prefill_attention(
                    q, k_cache, _v_one_stage_off(v_cache, bt, lens), bt, offs, lens, sm, BS),
                 want)])
    for name, hq, hkv, t, offs_l, lens_l, window, bs in PREFILL_GEOMETRY:
        q, k_cache, v_cache, bt, offs, lens = _prefill_inputs(gen, hq, hkv, t, offs_l, lens_l, bs)
        kp, vp = _poison_dead_slots(k_cache, v_cache, bt, lens, bs)
        got = paged_prefill_attention(q, kp, vp, bt, offs, lens, sm, bs, sliding_window=window)
        want = paged_prefill_ref(q, k_cache, v_cache, bt, offs, lens, sm, bs,
                                 sliding_window=window)
        torch.cuda.synchronize()
        err, rel, ok = _check(got, want)
        zeros_ok = _padded_rows_zero(got, t, offs, lens)
        ok = ok and zeros_ok
        plan = tile_plan(len(offs_l), t, hq, hkv)
        _line("prefill", case=name, Hq=hq, Hkv=hkv, T=t, block_size=bs, q_offsets=offs_l,
              kv_lens=lens_l, window=window, tokens_a_block=plan.tokens, grid=plan.grid,
              dead_slots="NaN", max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}",
              padded_rows_zero=zeros_ok, ok=ok)
        if not ok:
            raise SystemExit(f"prefill kernel disagrees with plain ({name})")
        worst = max(worst, err)
    # another page size, two rows with their own offsets and lengths
    bs, t = 16, 512
    offs_l, lens_l = [0, 37], [500, 37 + 512]
    bt, nblocks = _tables([t + 37] * 2, -(-(t + 37) // bs), gen, bs)
    k_cache, v_cache = _pool(nblocks, gen, bs)
    q = torch.randn((2, t, HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    args = (q, k_cache, v_cache, bt, torch.tensor(offs_l, dtype=torch.int32, device="cuda"),
            torch.tensor(lens_l, dtype=torch.int32, device="cuda"), sm, bs)
    got, want = paged_prefill_attention(*args), paged_prefill_ref(*args)
    torch.cuda.synchronize()
    err, rel, ok = _check(got, want)
    _line("prefill", B=2, T=t, block_size=bs, q_offsets=offs_l, kv_lens=lens_l,
          max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", ok=ok)
    if not ok:
        raise SystemExit(f"prefill kernel disagrees with plain (block_size={bs}, B=2)")
    record["max_abs_err"] = max(worst, err)
    return record


# ---------------------------------------------------------------- quantized KV


LLAMA_HQ, LLAMA_HKV = 32, 8
KV_KINDS = ("int8", "e4m3")  # pool element types beside bf16


def _slot_grid(bt, lens, bs=BS):
    """(flat slot of every table position [B, S], its position, whether it is
    below the row's kv_len)."""
    import torch

    b, mb = bt.shape
    pos = torch.arange(mb * bs, device="cuda")[None, :].expand(b, mb * bs)
    slots = (bt.long()[:, :, None] * bs + torch.arange(bs, device="cuda")).reshape(b, mb * bs)
    return slots, pos, pos < lens.long()[:, None]


def _quantized_pools(kb, vb, hkv, bt, lens, d=D):
    """{kind: (k, v, scale kwargs for the plain version, scale kwargs for the
    kernel)} from a bf16 pool. int8 as the engine quantizes it; the kernel's
    scales are NaN at every slot no live position maps to (the null block,
    rows past kv_len, unused blocks): a kernel that read one there would
    return NaN, where the plain version, gathering whole blocks, needs them
    finite. e4m3 is the downcast pool, no scales."""
    import torch

    from rtp_llm_tpu_torch.ops.kv_cache import FP8, quantize_kv

    kq, ks, vq, vs = quantize_kv(kb.view(-1, hkv, d), vb.view(-1, hkv, d))
    slots, _, live = _slot_grid(bt, lens)
    is_live = torch.zeros(kb.shape[0], dtype=torch.bool, device="cuda")
    is_live[slots[live]] = True
    nan = torch.full_like(ks, float("nan"))
    poisoned = dict(k_scale=torch.where(is_live[:, None], ks, nan),
                    v_scale=torch.where(is_live[:, None], vs, nan))
    return {"int8": (kq, vq, dict(k_scale=ks, v_scale=vs), poisoned),
            "e4m3": (kb.to(FP8), vb.to(FP8), {}, {})}


def _dequant_pair(k, v, scales, hkv, d=D):
    """A quantized pool as the bf16 pool the library yardstick reads."""
    import torch

    if not scales:
        return k.to(torch.bfloat16), v.to(torch.bfloat16)
    deq = lambda c, s: (c.view(-1, hkv, d).float() * s.float()[..., None]).view(
        c.shape).to(torch.bfloat16)
    return deq(k, scales["k_scale"]), deq(v, scales["v_scale"])


def _scales_at_logical_position(scale, bt, lens):
    """The scales a kernel would see that indexed them by position instead of
    through the block table: slot(b, p) holds scale[p]."""
    slots, pos, live = _slot_grid(bt, lens)
    out = scale.clone()
    out[slots[live]] = scale[pos[live]]
    return out


def _decode_plain_vs_before_normaliser(q, kq, vq, ks, vs, bt, lens, sm, hkv):
    """A faulty plain version: the V scale multiplied onto the probabilities
    before they are summed into the normaliser."""
    import torch

    b, hq, d = q.shape
    slots, _, live = _slot_grid(bt, lens)
    kf = kq[slots].view(b, -1, hkv, d).float() * ks[slots].float()[..., None]
    vf = vq[slots].view(b, -1, hkv, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", q.view(b, hkv, hq // hkv, d).float(), kf) * sm
    mask = live[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    w = torch.where(mask, e, torch.zeros_like(e)) * vs[slots].float().permute(0, 2, 1)[:, :, None]
    out = torch.einsum("bhgs,bshd->bhgd", w, vf) / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return out.reshape(b, hq, d).to(q.dtype)


def _kv_bound(ntok, hkv, kind, fixed_bytes, flops):
    """Least time for attention over ``ntok`` cached tokens: K and V rows at
    the pool's element size, the int8 pool's two bf16 scales a token and kv
    head, and the fixed q / out / table bytes; operations at the bf16 rate
    (the query and the probabilities are not 8-bit)."""
    elem = 2 if kind == "bf16" else 1
    nbytes = ntok * 2 * hkv * D * elem + (ntok * 2 * hkv * 2 if kind == "int8" else 0)
    return _bound_ms(nbytes + fixed_bytes, flops)


def phase_decode_quant(gen):
    """The int8 and e4m3 entries of the decode kernel against their plain
    versions, tolerance as ``_check`` (ATOL / RTOL / REL_L2 above), at (a)
    Llama-3-8B heads, B = 64 with the contexts ``phase_decode`` draws, (b)
    Qwen2-7B heads, the same contexts, (c) long rows, 8 x 8192 and a
    zero-length row; each with and without a sliding window and the deferred
    current token. Returns {name: record}: the two entries at (a), and the
    bf16 entry at (c), where every bucketed context is beyond the TPU
    whole-row kernel's 2048 tokens."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.decode import (
        paged_decode_attention, paged_decode_ref,
    )

    contexts = [0, 1, 63, 64, 65, 2047, 2048] + [2048] * 56 + [3000]
    shapes = (("llama3_8b", LLAMA_HQ, LLAMA_HKV, contexts),
              ("qwen2_7b", HQ, HKV, contexts),
              ("long_rows", LLAMA_HQ, LLAMA_HKV, [8192] * 8 + [0]))
    sm = D ** -0.5
    worst = dict.fromkeys(KV_KINDS, 0.0)
    records = {}
    for shape, hq, hkv, lens_l in shapes:
        b = len(lens_l)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        mb = _kv_bucket_blocks(max(lens_l))
        bt, nblocks = _tables(lens_l, mb, gen)
        kb, vb = _pool(nblocks, gen, hkv=hkv)
        q = torch.randn((b, hq, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        ck = torch.randn((b, hkv * D), generator=gen, device="cuda", dtype=torch.bfloat16)
        cv = torch.randn((b, hkv * D), generator=gen, device="cuda", dtype=torch.bfloat16)
        pools = _quantized_pools(kb, vb, hkv, bt, lens)
        for kind in KV_KINDS:
            k, v, plain_scales, kernel_scales = pools[kind]
            # the kernel reads NaN wherever no live token lives: int8 scales, e4m3 data
            kk, kv_ = _poison_dead_slots(k, v, bt, lens) if kind == "e4m3" else (k, v)
            for window in (0, 1000):
                for cur in (False, True):
                    kw = dict(sliding_window=window, cur_k=ck if cur else None,
                              cur_v=cv if cur else None)
                    got = paged_decode_attention(q, kk, kv_, bt, lens, sm, BS, **kw,
                                                 **kernel_scales)
                    want = paged_decode_ref(q, k, v, bt, lens, sm, BS, **kw, **plain_scales)
                    torch.cuda.synchronize()
                    err, rel, ok = _check(got, want)
                    zero_rows = bool((got[lens == 0] == 0).all())
                    ok = ok and zero_rows
                    _line("decode-quant", shape=shape, pool=kind, B=b, Hq=hq, Hkv=hkv, mb=mb,
                          window=window, cur=cur, dead_slots="NaN", max_abs_err=f"{err:.3e}",
                          max_rel_l2=f"{rel:.3e}", tol=f"{ATOL}+{RTOL}*|x|,rel_l2<={REL_L2}",
                          zero_rows_ok=zero_rows, ok=ok)
                    if not ok:
                        raise SystemExit(f"decode kernel ({kind} pool) disagrees with plain "
                                         f"({shape}, window={window}, cur={cur})")
                    worst[kind] = max(worst[kind], err)
        if shape == "llama3_8b":
            kq, vq, sc, _ = pools["int8"]
            ks, vs = sc["k_scale"], sc["v_scale"]
            run = lambda **over: paged_decode_attention(q, kq, vq, bt, lens, sm, BS,
                                                        **{**sc, **over})
            want = paged_decode_ref(q, kq, vq, bt, lens, sm, BS, **sc)
            got = run()
            u8 = torch.uint8
            with _decode_fault("dead_rows_not_zero_filled"):  # the scales NaN there
                dead_rows = paged_decode_attention(q, kq, vq, bt, lens, sm, BS,
                                                   **pools["int8"][3])
            _planted("decode-quant-fault", [
                ("built_in:dead_rows_not_zero_filled_nan_scales", dead_rows, want),
                ("v_scale_left_out", run(v_scale=torch.ones_like(vs)), want),
                ("k_scale_of_neighbour_kv_head", run(k_scale=ks.roll(1, dims=1)), want),
                ("scales_at_logical_position",
                 run(k_scale=_scales_at_logical_position(ks, bt, lens),
                     v_scale=_scales_at_logical_position(vs, bt, lens)), want),
                # the right kernel against a plain version with the fault
                ("int8_read_as_uint8", got,
                 paged_decode_ref(q, kq.view(u8), vq.view(u8), bt, lens, sm, BS, **sc)),
                ("v_scale_before_normaliser", got,
                 _decode_plain_vs_before_normaliser(q, kq, vq, ks, vs, bt, lens, sm, hkv)),
            ])
        # times: no window, in-layer writes; the long rows without the empty one
        n = 8 if shape == "long_rows" else b
        qn, btn, lensn = q[:n], bt[:n], lens[:n]
        ntok = float(lensn.sum())
        fixed = 2 * n * hq * D * 2 + btn.numel() * 4 + n * 4
        flops = 4.0 * ntok * hq * D
        bf16_run = lambda: paged_decode_attention(qn, kb, vb, btn, lensn, sm, BS)
        bf16_ms = _graph_ms(bf16_run, 8)
        for kind in KV_KINDS:
            k, v, plain_scales, _ = pools[kind]
            kd, vd = _dequant_pair(k, v, plain_scales, hkv)
            ms, device_ms, plain_ms, lib_ms = _decode_times(
                lambda: paged_decode_attention(qn, k, v, btn, lensn, sm, BS, **plain_scales),
                lambda: paged_decode_ref(qn, k, v, btn, lensn, sm, BS, **plain_scales),
                _sdpa_decode(qn, kd, vd, btn, lensn, 0, hkv=hkv))
            del kd, vd
            bound, by = _kv_bound(ntok, hkv, kind, fixed, flops)
            _line("decode-quant-time", shape=shape, pool=kind, B=n, Hq=hq, Hkv=hkv,
                  ctx_tokens=int(ntok), ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
                  bound_ms=f"{bound:.4f}", bound_by=by,
                  share_of_bound=f"{bound / device_ms:.2f}",
                  bf16_pool_device_ms=f"{bf16_ms:.4f}")
            if shape == "llama3_8b":
                records[kind] = dict(ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by)
        if shape != "qwen2_7b":
            ms, device_ms, plain_ms, lib_ms = _decode_times(
                bf16_run, lambda: paged_decode_ref(qn, kb, vb, btn, lensn, sm, BS),
                _sdpa_decode(qn, kb, vb, btn, lensn, 0, hkv=hkv))
            bound, by = _kv_bound(ntok, hkv, "bf16", fixed, flops)
            _line("decode-quant-time", shape=shape, pool="bf16", B=n, Hq=hq, Hkv=hkv,
                  ctx_tokens=int(ntok), ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
                  bound_ms=f"{bound:.4f}", bound_by=by,
                  share_of_bound=f"{bound / device_ms:.2f}")
        del pools, kb, vb
        torch.cuda.empty_cache()
    for kind in KV_KINDS:
        records[kind]["max_abs_err"] = worst[kind]
    return records


def phase_decode_served(gen, copies=4):
    """The call the engine makes 28-32 times a decode step: 8 rows of about
    560 context tokens at Llama-3-8B heads, the block table bucketed as the
    engine buckets it, bf16 and int8 pools. ``copies`` pools, one a layer,
    are cycled so that each call finds its KV cold in the 50 MB L2, as a
    layer's call does. Checks each pool type once (dead slots NaN for the
    kernel), then times the kernel (host loop and replayed graph), the plain
    version and the library call."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.decode import (
        paged_decode_attention, paged_decode_ref,
    )

    hq, hkv, sm = LLAMA_HQ, LLAMA_HKV, D ** -0.5
    lens_l = [553 + 2 * i for i in range(8)]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mb = _kv_bucket_blocks(max(lens_l))
    bt, nblocks = _tables(lens_l, mb, gen)
    q = torch.randn((len(lens_l), hq, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    layers = []
    for _ in range(copies):
        kb, vb = _pool(nblocks, gen, hkv=hkv)
        kq, vq, sc, poisoned = _quantized_pools(kb, vb, hkv, bt, lens)["int8"]
        layers.append({"bf16": (kb, vb, {}, _poison_dead_slots(kb, vb, bt, lens) + ({},)),
                       "int8": (kq, vq, sc, (kq, vq, poisoned))})
    ntok = float(lens.sum())
    fixed = 2 * len(lens_l) * hq * D * 2 + bt.numel() * 4 + len(lens_l) * 4
    flops = 4.0 * ntok * hq * D
    for kind in ("bf16", "int8"):
        k, v, sc, (kp, vp, scp) = layers[0][kind]
        got = paged_decode_attention(q, kp, vp, bt, lens, sm, BS, **scp)
        want = paged_decode_ref(q, k, v, bt, lens, sm, BS, **sc)
        torch.cuda.synchronize()
        err, rel, ok = _check(got, want)
        _line("decode", shape="served_llama3_8b", pool=kind, B=len(lens_l), mb=mb,
              dead_slots="NaN", max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", ok=ok)
        if not ok:
            raise SystemExit(f"decode kernel ({kind} pool) disagrees with plain (served shape)")
        libs = []
        for layer in layers:
            kd, vd = _dequant_pair(layer[kind][0], layer[kind][1], layer[kind][2], hkv)
            libs.append(_sdpa_decode(q, kd, vd, bt, lens, 0, hkv=hkv))
        run = _cycling(lambda i: paged_decode_attention(
            q, layers[i][kind][0], layers[i][kind][1], bt, lens, sm, BS, **layers[i][kind][2]),
            copies)
        ms, device_ms, plain_ms, lib_ms = _decode_times(
            run, lambda: paged_decode_ref(q, k, v, bt, lens, sm, BS, **sc),
            _cycling(lambda i: libs[i](), copies), calls=2 * copies)
        del libs
        bound, by = _kv_bound(ntok, hkv, kind, fixed, flops)
        _line("decode-time", shape="served_llama3_8b", pool=kind, B=len(lens_l), Hq=hq,
              Hkv=hkv, mb=mb, ctx_tokens=int(ntok), layers_cycled=copies, ms=f"{ms:.4f}",
              device_ms=f"{device_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
              share_of_bound=f"{bound / device_ms:.2f}")
    del layers
    torch.cuda.empty_cache()


def phase_prefill_quant(gen):
    """The int8 and e4m3 entries of the prefill kernel against their plain
    versions at Llama-3-8B heads: T = 2048 behind a reused prefix of 1000
    tokens (read back quantized), two rows with their own offsets, the
    first with a padded tail, and the geometry cases of ``phase_prefill``
    (int8 scales NaN wherever no live token lives). Then the times of all
    three entries at T in {512, 2048}, offsets 0 and 1000, and at the 2048
    bucket of a 1000-token prompt. Returns {kind: record} at the first case."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.prefill import (
        paged_prefill_attention, paged_prefill_ref,
    )

    hq, hkv, sm = LLAMA_HQ, LLAMA_HKV, D ** -0.5
    worst = dict.fromkeys(KV_KINDS, 0.0)
    records = {}
    cases = [("reused_prefix", hq, hkv, 2048, [1000], [3048], 0, BS),
             ("two_rows", hq, hkv, 512, [0, 37], [500, 549], 0, BS)]
    cases += [c for c in PREFILL_GEOMETRY if c[-1] == BS and c[0] != "llama_heads"]
    for case, chq, chkv, t, offs_l, lens_l, window, _ in cases:
        b = len(offs_l)
        q, kb, vb, bt, offs, lens = _prefill_inputs(gen, chq, chkv, t, offs_l, lens_l, BS)
        pools = _quantized_pools(kb, vb, chkv, bt, lens)
        for kind in KV_KINDS:
            k, v, plain_scales, kernel_scales = pools[kind]
            got = paged_prefill_attention(q, k, v, bt, offs, lens, sm, BS,
                                          sliding_window=window, **kernel_scales)
            want = paged_prefill_ref(q, k, v, bt, offs, lens, sm, BS, sliding_window=window,
                                     **plain_scales)
            torch.cuda.synchronize()
            err, rel, ok = _check(got, want)
            tail_ok = _padded_rows_zero(got, t, offs, lens)
            ok = ok and tail_ok
            _line("prefill-quant", case=case, pool=kind, B=b, Hq=chq, Hkv=chkv, T=t,
                  q_offsets=offs_l, kv_lens=lens_l, window=window, max_abs_err=f"{err:.3e}",
                  max_rel_l2=f"{rel:.3e}",
                  tol=f"{ATOL}+{RTOL}*|x|,rel_l2<={REL_L2}", tail_zero=tail_ok, ok=ok)
            if not ok:
                raise SystemExit(f"prefill kernel ({kind} pool) disagrees with plain ({case})")
            worst[kind] = max(worst[kind], err)
        if case != "reused_prefix":
            continue
        kq, vq, sc, _ = pools["int8"]
        want = paged_prefill_ref(q, kq, vq, bt, offs, lens, sm, BS, **sc)
        run = lambda vv=vq, **over: paged_prefill_attention(q, kq, vv, bt, offs, lens, sm, BS,
                                                            **{**sc, **over})
        _planted("prefill-quant-fault", [
            # P left unscaled by the V scale
            ("v_scale_left_out", run(v_scale=torch.ones_like(sc["v_scale"])), want),
            ("k_scale_of_neighbour_kv_head", run(k_scale=sc["k_scale"].roll(1, dims=1)), want),
            ("int8_read_as_uint8", run(), paged_prefill_ref(
                q, kq.view(torch.uint8), vq.view(torch.uint8), bt, offs, lens, sm, BS, **sc)),
            # the right V scales on the V rows of the neighbouring ring stage
            ("v_tile_of_neighbouring_stage", run(vv=_v_one_stage_off(vq, bt, lens)), want),
        ])
        del pools
    for t, off, kv_len in [(t, off, off + t) for t in (512, 2048) for off in (0, 1000)] + [
            (2048, 0, 1000)]:
        q, kb, vb, bt, offs, lens = _prefill_inputs(gen, hq, hkv, t, [off], [kv_len], BS)
        pools = _quantized_pools(kb, vb, hkv, bt, lens)
        pools["bf16"] = (kb, vb, {}, {})
        flops = _prefill_flops(t, [off], [kv_len], hq)
        fixed = 2 * t * hq * D * 2 + bt.numel() * 4
        bf16_ms = None
        for kind in ("bf16",) + KV_KINDS:
            k, v, plain_scales, _ = pools[kind]
            call = lambda: paged_prefill_attention(q, k, v, bt, offs, lens, sm, BS,
                                                   **plain_scales)
            ms = _time_ms(call, iters=10)
            device_ms = _graph_ms(call, 8)
            plain_ms = _time_ms(lambda: paged_prefill_ref(q, k, v, bt, offs, lens, sm, BS,
                                                          **plain_scales), iters=3, warmup=1)
            kd, vd = _dequant_pair(k, v, plain_scales, hkv)
            lib_ms = _graph_ms(_sdpa_prefill(q, kd, vd, bt, off, kv_len, hkv=hkv), 8)
            del kd, vd
            bound, by = _kv_bound(kv_len, hkv, kind, fixed, flops)
            bf16_ms = device_ms if kind == "bf16" else bf16_ms
            _line("prefill-quant-time", pool=kind, T=t, q_offset=off, kv_len=kv_len, Hq=hq,
                  Hkv=hkv, ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}",
                  tflops=f"{flops / device_ms / 1e9:.1f}", plain_ms=f"{plain_ms:.4f}",
                  library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
                  share_of_bound=f"{bound / device_ms:.3f}",
                  bf16_pool_device_ms=f"{bf16_ms:.4f}")
            if kind != "bf16" and (t, off) == (2048, 1000):
                records[kind] = dict(ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by)
        del pools
    for kind in KV_KINDS:
        records[kind]["max_abs_err"] = worst[kind]
    return records


def _deferred_writer(cache, block_size):
    """The engine's batched deferred scatter, bound to ``cache`` alone."""
    import types

    from rtp_llm_tpu_torch.engine import LlmEngine

    holder = types.SimpleNamespace(kv=cache, block_size=block_size,
                                   _scatter_flat=LlmEngine._scatter_flat)
    return lambda *args: LlmEngine._apply_kv_writes(holder, *args)


def phase_write(gen):
    """The quantize-and-write ops (plain PyTorch, no kernel) on the card
    against the same functions on the CPU, at Llama-3-8B widths: int8 bytes
    and bf16 scales equal, and invalid rows leave the pool bit-identical."""
    import torch

    from rtp_llm_tpu_torch.ops.kv_cache import INVALID_SLOT, write_kv_quant

    layers, hkv, nblocks = 32, LLAMA_HKV, 128
    ns, hd = nblocks * BS, LLAMA_HKV * D
    data = torch.randint(-127, 128, (layers, 2, ns, hd), generator=gen, device="cuda",
                         dtype=torch.int8)
    scale = torch.rand((layers, 2, ns, hkv), generator=gen, device="cuda").to(torch.bfloat16)
    same = lambda a, b: bool(torch.equal(a.cpu(), b))

    # one prefill chunk's rows into one layer, its padded tail invalid
    t = 2048
    k_new = torch.randn((t, hkv, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    v_new = torch.randn((t, hkv, D), generator=gen, device="cuda", dtype=torch.bfloat16) * 0.1
    slots = torch.randperm(ns - BS, generator=gen, device="cuda")[:t] + BS
    slots[-300:] = INVALID_SLOT
    dev = [data[0].clone(), scale[0].clone()]
    host = [x.cpu() for x in dev]
    write_kv_quant(dev[0][0], dev[0][1], dev[1][0], dev[1][1], k_new, v_new, slots)
    write_kv_quant(host[0][0], host[0][1], host[1][0], host[1][1], k_new.cpu(), v_new.cpu(),
                   slots.cpu())
    in_layer_ok = same(dev[0], host[0]) and same(dev[1], host[1])
    written = int((dev[0][0] != data[0, 0]).any(dim=-1).sum())
    untouched = [data[0].clone(), scale[0].clone()]
    write_kv_quant(untouched[0][0], untouched[0][1], untouched[1][0], untouched[1][1],
                   k_new, v_new, torch.full_like(slots, INVALID_SLOT))
    invalid_ok = bool(torch.equal(untouched[0], data[0]) and torch.equal(untouched[1], scale[0]))

    # a decode step's rows of every layer, one batched scatter; rows 3, 10 inactive
    b, mb = 64, 32
    kv_lens = torch.randint(1, mb * BS - 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    kv_lens[3] = kv_lens[10] = 0
    bt = (torch.randperm(nblocks - 1, generator=gen, device="cuda")[:b] + 1).to(torch.int32)
    bt = bt[:, None].expand(b, mb).contiguous()  # a row's positions share its block: distinct rows
    kw = torch.randn((layers, b, hd), generator=gen, device="cuda", dtype=torch.bfloat16)
    vw = torch.randn((layers, b, hd), generator=gen, device="cuda", dtype=torch.bfloat16) * 0.1
    dev = {"data": data.clone(), "scale": scale.clone()}
    host = {n: x.cpu() for n, x in dev.items()}
    _deferred_writer(dev, BS)((kw, vw), kv_lens, bt, kv_lens > 0)
    _deferred_writer(host, BS)((kw.cpu(), vw.cpu()), kv_lens.cpu(), bt.cpu(), (kv_lens > 0).cpu())
    deferred_ok = same(dev["data"], host["data"]) and same(dev["scale"], host["scale"])
    rows = int((dev["data"] != data).any(dim=-1).sum())
    idle = {"data": data.clone(), "scale": scale.clone()}
    _deferred_writer(idle, BS)((kw, vw), torch.zeros_like(kv_lens), bt,
                               torch.zeros(b, dtype=torch.bool, device="cuda"))
    idle_ok = bool(torch.equal(idle["data"], data) and torch.equal(idle["scale"], scale))
    torch.cuda.synchronize()
    ok = (in_layer_ok and invalid_ok and deferred_ok and idle_ok and written == t - 300
          and rows == layers * 2 * (b - 2))
    _line("kv-write", write_kv_quant_equals_cpu=in_layer_ok, rows_written=written,
          invalid_rows_leave_pool_identical=invalid_ok,
          apply_kv_writes_equals_cpu=deferred_ok, deferred_rows_written=rows,
          inactive_batch_leaves_pool_identical=idle_ok, ok=ok)
    if not ok:
        raise SystemExit("quantized KV writes on the card differ from the CPU's")


# ---------------------------------------------------------------- phase 5


def _gw_bound(m, k, n, group):
    nbytes = k * n / 2 + 4.0 * k * n / group + 2.0 * m * k + 2.0 * m * n
    return _bound_ms(nbytes, 2.0 * m * k * n)


def _gw_weights(k, n, group, gen, copies=1):
    """Random codes and positive scales that differ by up to 3x between
    groups; ``copies`` stacked layers, so that timed calls can walk through
    more weight bytes than the 50 MB L2 holds, as the model's layers do."""
    import torch

    packed = torch.randint(0, 256, (copies, k // 2, n), generator=gen, device="cuda",
                           dtype=torch.uint8)
    scale = (torch.rand((copies, k // group, n), generator=gen, device="cuda") + 0.5) * 3e-3
    return packed, scale


def _cycling(fn, copies):
    """A closure for ``_time_ms``: call ``fn(layer)``, the next layer each time."""
    state = [0]

    def run():
        fn(state[0] % copies)
        state[0] += 1
    return run


@functools.lru_cache(maxsize=None)
def _gw_fault_kernels():
    """The 4-bit kernels built with a planted fault, by fault name."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    return {name: _kernels.Kernel(f"{qg.KERNELS[v].name}:{name}", src, qg.KERNELS[v].entry,
                                  qg._ARGTYPES, defines=(define,))
            for name, v, src, define, _ in GW_FAULTS}


@contextlib.contextmanager
def _kernel_swapped(variant, kernel):
    """``groupwise_matmul_packed(variant=...)`` launches ``kernel`` inside."""
    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    saved = qg.KERNELS[variant]
    qg.KERNELS[variant] = kernel
    try:
        yield
    finally:
        qg.KERNELS[variant] = saved


def _gw_plain(variant):
    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    return qg.groupwise_matmul_partial_ref if variant == "partial" else qg.groupwise_matmul_ref


def phase_gw(gen):
    """gw_gemm / gw_gemm_pipe / gw_gemm_partial against their plain versions;
    returns {variant: record} at the gate-up shape, M = 64."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    variants = ("base", "pipe", "partial")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst = dict.fromkeys(variants, 0.0)
    records = {}

    def compare(tag, x, packed, scale, code, only=variants, tile=None, **kw):
        for v in only:
            got = qg.groupwise_matmul_packed(x, packed, scale, code=code, variant=v, tile=tile,
                                             **kw)
            layer = kw.get("layer")
            want = _gw_plain(v)(x, packed if layer is None else packed[layer], scale, code)
            torch.cuda.synchronize()
            err, rel, ok = _check_gemm(got, want)
            k, n = x.shape[-1], want.shape[-1]
            _line("gw", case=tag, kernel=qg.KERNELS[v].name, M=x.shape[0], K=k, N=n, code=code,
                  tile=tile or qg.plan(x.shape[0], k, n, sm, v), max_abs_err=f"{err:.3e}",
                  max_rel_l2=f"{rel:.3e}", ok=ok)
            if not ok:
                raise SystemExit(f"{qg.KERNELS[v].name} disagrees with its plain version "
                                 f"({tag}, M={x.shape[0]}, K={k}, N={n}, {code})")
            worst[v] = max(worst[v], err)

    for name, (k, n) in {**GW_SHAPES, **GW_LLAMA_SHAPES}.items():
        nbytes = k * n // 2
        copies = max(1, -(-120_000_000 // nbytes))
        packed, scale = _gw_weights(k, n, GW_GROUP, gen, copies)
        for m in GW_MS if name in GW_SHAPES else GW_TIMED_MS + GW_PACKED_MS:
            x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            compare(name, x, packed[0], scale[0], "s4")
            if m not in GW_TIMED_MS:
                continue
            # times: every call takes the next layer's weights (cold in L2)
            wd = torch.stack([qg.dequantize(packed[i], scale[i]).to(torch.bfloat16)
                              for i in range(copies)])
            lib_ms = _graph_ms(_cycling(lambda i: torch.matmul(x, wd[i]), copies), 2 * copies)
            del wd
            bound, by = _gw_bound(m, k, n, GW_GROUP)
            for v in variants if name in GW_ALL_TIMED else ("base",):
                call = _cycling(lambda i: qg.groupwise_matmul_packed(
                    x, packed, scale[i], layer=i, variant=v), copies)
                ms = _time_ms(call)
                device_ms = _graph_ms(call, 2 * copies)
                plain_ms = _time_ms(_cycling(lambda i: _gw_plain(v)(
                    x, packed[i], scale[i], "s4"), copies), iters=3, warmup=1)
                _line("gw-time", linear=name, kernel=qg.KERNELS[v].name, M=m, K=k, N=n,
                      tile=qg.plan(m, k, n, sm, v), ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}",
                      plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
                      bound_ms=f"{bound:.4f}", bound_by=by,
                      share_of_bound=f"{bound / device_ms:.3f}",
                      tflops=f"{2.0 * m * k * n / device_ms / 1e9:.1f}")
                if name == "gate_up_proj" and m == 64:
                    records[v] = dict(ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=bound, bound_by=by)
            if name in GW_ALL_TIMED and m >= 512:
                # gw_gemm_pipe's tile kernel at both block heights: what its
                # plan weighs when it picks one
                rows_ms = {bm: _graph_ms(_cycling(lambda i: qg.groupwise_matmul_packed(
                    x, packed, scale[i], layer=i, variant="pipe", tile=(bm, 128, 1)), copies),
                    2 * copies) for bm in (128, 256)}
                rounds = {bm: -(-(-(-m // bm) * -(-n // 128)) // sm) for bm in (128, 256)}
                per_round = {bm: rows_ms[bm] / rounds[bm] for bm in (128, 256)}
                _line("gw-rows", linear=name, kernel="gw_gemm_pipe", M=m, K=k, N=n,
                      plan=qg.plan(m, k, n, sm, "pipe"),
                      **{f"device_ms_{bm}_rows": f"{t:.4f}" for bm, t in rows_ms.items()},
                      rounds_128_256=f"{rounds[128]},{rounds[256]}",
                      round_time_256_over_128=f"{per_round[256] / per_round[128]:.3f}")
        if name == "o_proj":
            # a layer >= 1 of the stack, through the layer index, at both
            # kernels of each entry
            for m in (64, 512):
                x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
                compare("stack_layer_2", x, packed, scale[2], "s4", layer=2)
            # K splits forced on the tile kernels
            compare("k_split_3", x, packed[0], scale[0], "s4", only=("base",), tile=(128, 128, 3))
            for bm in (128, 256):
                compare("k_split_3", x, packed[0], scale[0], "s4", only=("pipe",),
                        tile=(bm, 128, 3))
            # planted faults at the decode shape that splits K
            x = torch.randn((64, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            g2 = scale.shape[1] // 2
            for v in variants:
                want = _gw_plain(v)(x, packed[0], scale[0], "s4")
                run = lambda xx=x, pp=packed[0], ss=scale[0]: qg.groupwise_matmul_packed(
                    xx, pp, ss, code="s4", variant=v)
                splits = qg.plan(64, k, n, sm, v)[2]
                r0, r1 = qg.split_rows(k, splits, 1)
                x_cut = x.clone()
                x_cut[:, r0:r1] = 0
                x_cut[:, k // 2 + r0: k // 2 + r1] = 0
                if splits < 2:
                    raise SystemExit("the planted split fault needs a shape that splits K")
                _planted(f"gw-fault:{qg.KERNELS[v].name}", [
                    ("nibbles_swapped", run(pp=(packed[0] >> 4) | (packed[0] << 4)), want),
                    ("high_plane_on_low_scale_rows",
                     run(ss=torch.cat([scale[0, :g2], scale[0, :g2]])), want),
                    ("s4_as_twos_complement", run(pp=packed[0] ^ 0x88), want),
                    (f"split_1_of_{splits}_left_out", run(xx=x_cut), want),
                    # a ring stage off: every k-tile against the scale rows of the next group
                    ("scales_of_the_next_ring_stage", run(ss=torch.cat(
                        [scale[0, :g2].roll(-1, dims=0), scale[0, g2:].roll(-1, dims=0)])), want),
                ], check=_check_gemm)
                # fixed-order split reduce: the same bits from run to run
                again = [run() for _ in range(3)]
                torch.cuda.synchronize()
                same = all(torch.equal(again[0], y) for y in again[1:])
                _line("gw-repeat", kernel=qg.KERNELS[v].name, M=64, K=k, N=n, splits=splits,
                      identical_bits_over_runs=same)
                if not same:
                    raise SystemExit(f"{qg.KERNELS[v].name}: results change from run to run")
            # faults inside the kernels, built in: each must fail the same check
            cases = []
            for fault, v, _, _, m in GW_FAULTS:
                xf = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
                want = _gw_plain(v)(xf, packed[0], scale[0], "s4")
                with _kernel_swapped(v, _gw_fault_kernels()[fault]):
                    cases.append((f"{fault}_M{m}", qg.groupwise_matmul_packed(
                        xf, packed[0], scale[0], code="s4", variant=v), want))
            _planted("gw-fault:built_in", cases, check=_check_gemm)
        del packed, scale
        torch.cuda.empty_cache()
    # fp4: e2m1 codes at group 32
    k, n = GW_SHAPES["qkv_proj"]
    packed, scale = _gw_weights(k, n, 32, gen)
    for m in (1, 8, 64, 127, 128, 130, 512, 2048):
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        compare("e2m1_group_32", x, packed[0], scale[0], "e2m1")
    # group 32: a k-tile of 32 packed rows is one scale group a plane, so the
    # next ring stage's scales are the next scale row
    g2 = scale.shape[1] // 2
    want = qg.groupwise_matmul_ref(x, packed[0], scale[0], "e2m1")
    _planted("gw-fault:gw_gemm", [
        ("e2m1_scales_of_the_next_ring_stage", qg.groupwise_matmul_packed(
            x, packed[0], torch.cat([scale[0, :g2].roll(-1, dims=0),
                                     scale[0, g2:].roll(-1, dims=0)]), code="e2m1"), want),
    ], check=_check_gemm)
    # ragged rows and columns against every block shape, K split
    for m, k, n in ((130, 3584, 3600), (300, 512, 208), (8, 3584, 3600), (64, 3584, 3600),
                    (2048, 3584, 3600)):
        packed, scale = _gw_weights(k, n, 32, gen)
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        compare("ragged_edges_group_32", x, packed[0], scale[0], "s4")
    for v in variants:
        records[v]["max_abs_err"] = worst[v]
    return records


def phase_sweep(gen):
    """The path of gw_gemm_partial: its tile sizes swept at the sweep
    geometries, M = 64. Every tile is first held against the plain version;
    then the launch count is set to 0 and the timed sweep is driven, and the
    count read back. Returns (launches, best tile per geometry)."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    kernel = qg.KERNELS["partial"]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    m = 64
    cases = []
    for k, n in SWEEP_GEOMS:
        copies = max(1, -(-120_000_000 // (k * n // 2)))
        packed, scale = _gw_weights(k, n, GW_GROUP, gen, copies)
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        want = qg.groupwise_matmul_partial_ref(x, packed[0], scale[0], "s4")
        tiles = list(dict.fromkeys(SWEEP_TILES + (qg.plan(m, k, n, sm, "partial"),)))
        for tile in tiles:
            got = qg.groupwise_matmul_packed(x, packed[0], scale[0], variant="partial", tile=tile)
            torch.cuda.synchronize()
            err, rel, ok = _check_gemm(got, want)
            if not ok:
                raise SystemExit(f"gw_gemm_partial tile {tile} disagrees with its plain "
                                 f"version at K={k}, N={n} (rel L2 {rel:.3e})")
        cases.append((k, n, copies, packed, scale, x, tiles))
    kernel.launches.n = 0
    best = {}
    for k, n, copies, packed, scale, x, tiles in cases:
        bound, by = _gw_bound(m, k, n, GW_GROUP)
        for tile in tiles:
            ms = _time_ms(_cycling(lambda i: qg.groupwise_matmul_packed(
                x, packed, scale[i], layer=i, variant="partial", tile=tile), copies))
            _line("sweep", kernel=kernel.name, M=m, K=k, N=n, bm=tile[0], bn=tile[1],
                  splits=tile[2], ms=f"{ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by, ok=True)
            if (k, n) not in best or ms < best[(k, n)][1]:
                best[(k, n)] = (tile, ms)
    launches = kernel.launches.n
    _line("sweep-best", launches=launches, **{f"K{k}xN{n}": f"{t}:{ms:.4f}ms"
                                              for (k, n), (t, ms) in best.items()})
    return launches


# ---------------------------------------------------------------- main


def main():
    t_main = time.time()
    card = phase_device()
    import torch

    with _stage("build"):
        phase_build()
    from rtp_llm_tpu_torch.utils.access_logger import AccessLogger

    if os.path.exists(ACCESS_LOG):
        os.unlink(ACCESS_LOG)
    AccessLogger(ACCESS_LOG)  # the first one sets the process's access log
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    with _stage("kernels"):
        dec = phase_decode(gen)
        pre = phase_prefill(gen)
        dec_q = phase_decode_quant(gen)
        phase_decode_served(gen)
        pre_q = phase_prefill_quant(gen)
        phase_write(gen)
        gw = phase_gw(gen)
        sweep_launches = phase_sweep(gen)
        w8 = phase_w8(gen)
        act = phase_act_quant(gen)
        i8 = phase_i8(gen)
        lora_rec = phase_lora_kernels(gen)
        phase_spec_kernels(card)
        head_dim, _ = phase_head_dim(gen)
        group, _ = phase_group()
        alibi = phase_alibi()
        group_wide, _ = phase_group_wide()
        moe_rec = phase_moe_kernels()
    _line("kernels-checked", seconds=f"{time.time() - t0:.1f}")
    spec_launches = collections.Counter()  # the speculative phases' launches
    with _stage("qwen2"):
        launches, plain_calls, b_max = phase_qwen2(gen, card, spec_launches)
    with _stage("llama3"):
        llama_launches, llama_plain, llama_engines, llama_b = phase_llama3(gen, card,
                                                                          spec_launches)
    b_max = max(b_max, llama_b)
    launches.update(llama_launches)
    plain_calls += llama_plain
    launches["gw_gemm_partial"] = sweep_launches
    with _stage("qwen2-8bit"):
        q8_launches, q8_plain, q8_b, q8_engines = phase_qwen2_8bit(gen, card)
    launches.update(q8_launches)
    plain_calls += q8_plain
    b_max = max(b_max, q8_b)
    with _stage("profiles"):
        phase_profiles(gen, llama_engines, q8_engines)
    for name, n in spec_launches.items():
        launches[name] = launches.get(name, 0) + n
    with _stage("families"):
        fam_launches, fam_plain = phase_families(gen, card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    plain_calls += fam_plain
    with _stage("alibi-families"):
        fam_launches, fam_plain = phase_alibi_families(card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    plain_calls += fam_plain
    with _stage("mqa-families"):
        fam_launches, fam_plain = phase_mqa_families(card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    plain_calls += fam_plain
    with _stage("partial-rotary-families"):
        fam_launches, fam_plain = phase_partial_rotary_families(card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    plain_calls += fam_plain
    with _stage("longrope"):
        fam_launches, fam_plain = phase_longrope(card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    plain_calls += fam_plain
    with _stage("moe-families"):
        fam_launches, fam_plain = phase_moe_families(card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    plain_calls += fam_plain

    rows = []
    for name, src, rep, rec in (
        ("paged_decode", "rtp_llm_tpu_torch/csrc/paged_decode.cu",
         "rtp_llm_tpu/ops/attention/pallas_decode.py:206", dec),
        ("paged_decode_i8", "rtp_llm_tpu_torch/csrc/paged_decode.cu",
         "rtp_llm_tpu/ops/attention/pallas_decode.py:206", dec_q["int8"]),
        ("paged_decode_e4m3", "rtp_llm_tpu_torch/csrc/paged_decode.cu",
         "rtp_llm_tpu/ops/attention/pallas_decode.py:206", dec_q["e4m3"]),
        ("paged_prefill", "rtp_llm_tpu_torch/csrc/paged_prefill.cu",
         "rtp_llm_tpu/ops/attention/pallas_prefill.py:43", pre),
        ("paged_prefill_i8", "rtp_llm_tpu_torch/csrc/paged_prefill.cu",
         "rtp_llm_tpu/ops/attention/pallas_prefill.py:43", pre_q["int8"]),
        ("paged_prefill_e4m3", "rtp_llm_tpu_torch/csrc/paged_prefill.cu",
         "rtp_llm_tpu/ops/attention/pallas_prefill.py:43", pre_q["e4m3"]),
        ("gw_gemm", "rtp_llm_tpu_torch/csrc/gw_gemm.cu",
         "rtp_llm_tpu/ops/quant_gemm.py:89", gw["base"]),
        ("gw_gemm_pipe", "rtp_llm_tpu_torch/csrc/gw_gemm_pipe.cu",
         "rtp_llm_tpu/ops/quant_gemm.py:136", gw["pipe"]),
        ("gw_gemm_partial", "rtp_llm_tpu_torch/csrc/gw_gemm_partial.cu",
         "benchmarks/int4_kernel_sweep.py:183", gw["partial"]),
        # no Pallas counterpart: XLA fusions of rtp_llm_tpu/quant/weight_only.py
        ("w8_gemm", "rtp_llm_tpu_torch/csrc/w8_gemm.cu",
         "rtp_llm_tpu/quant/weight_only.py:383", w8),
        ("act_quant", "rtp_llm_tpu_torch/csrc/act_quant.cu",
         "rtp_llm_tpu/quant/weight_only.py:157", act),
        ("i8_gemm", "rtp_llm_tpu_torch/csrc/i8_gemm.cu",
         "rtp_llm_tpu/quant/weight_only.py:187", i8),
        # no Pallas counterpart: the XLA gather + einsums of dynamic LoRA
        ("lora_segments", "rtp_llm_tpu_torch/csrc/lora_bgmv.cu",
         "rtp_llm_tpu/models/llama_family.py:690", lora_rec["segments"]),
        ("lora_shrink", "rtp_llm_tpu_torch/csrc/lora_bgmv.cu",
         "rtp_llm_tpu/models/llama_family.py:690", lora_rec["shrink"]),
        ("lora_expand", "rtp_llm_tpu_torch/csrc/lora_bgmv.cu",
         "rtp_llm_tpu/models/llama_family.py:691", lora_rec["expand"]),
        # no Pallas counterpart: the XLA ragged_dot of the expert products
        ("moe_grouped_gemm", "rtp_llm_tpu_torch/csrc/moe_grouped_gemm.cu",
         "rtp_llm_tpu/ops/moe.py:40", moe_rec),
    ):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
    # the head_dim 64 / 80 / 96 / 256 entries of the attention sources
    for (op, kind, d), rec in sorted(head_dim.items()):
        name = f"paged_{op}{dict(bf16='', int8='_i8', e4m3='_e4m3')[kind]}_d{d}"
        rep = ("rtp_llm_tpu/ops/attention/pallas_decode.py:206" if op == "decode"
               else "rtp_llm_tpu/ops/attention/pallas_prefill.py:43")
        rows.append({"name": name, "route": "cuda",
                     "source": f"rtp_llm_tpu_torch/csrc/paged_{op}.cu", "replaces": rep,
                     "launches": launches.get(name, 0), "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
        launches.setdefault(name, 0)  # the check below: every listed entry launched
    # the D 128 entries at groups of 9-16 heads (two n8 head tiles in K1 / K2)
    for (op, kind), rec in sorted(group.items()):
        name = f"paged_{op}{dict(bf16='', int8='_i8', e4m3='_e4m3')[kind]}_g9to16"
        rep = ("rtp_llm_tpu/ops/attention/pallas_decode.py:206" if op == "decode"
               else "rtp_llm_tpu/ops/attention/pallas_prefill.py:43")
        rows.append({"name": name, "route": "cuda",
                     "source": f"rtp_llm_tpu_torch/csrc/paged_{op}.cu", "replaces": rep,
                     "launches": launches.get(name, 0), "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
        launches.setdefault(name, 0)
    # the ALiBi mode of every entry at D 64 and 128 (K1 / K2 and K3)
    for (op, kind, d), rec in sorted(alibi.items()):
        name = (f"paged_{op}{dict(bf16='', int8='_i8', e4m3='_e4m3')[kind]}"
                f"{'' if d == D else f'_d{d}'}_alibi")
        rep = ("rtp_llm_tpu/ops/attention/pallas_decode.py:206" if op == "decode"
               else "rtp_llm_tpu/ops/attention/pallas_prefill.py:43")
        rows.append({"name": name, "route": "cuda",
                     "source": f"rtp_llm_tpu_torch/csrc/paged_{op}.cu", "replaces": rep,
                     "launches": launches.get(name, 0), "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
        launches.setdefault(name, 0)
    # the head-chunk mode (G 17-128 at D 64 / 128; StarCoder's G 48 timed)
    for (op, kind), rec in sorted(group_wide.items()):
        name = f"paged_{op}{dict(bf16='', int8='_i8', e4m3='_e4m3')[kind]}_gwide"
        rep = ("rtp_llm_tpu/ops/attention/pallas_decode.py:206" if op == "decode"
               else "rtp_llm_tpu/ops/attention/pallas_prefill.py:43")
        rows.append({"name": name, "route": "cuda",
                     "source": f"rtp_llm_tpu_torch/csrc/paged_{op}.cu", "replaces": rep,
                     "launches": launches.get(name, 0), "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
        launches.setdefault(name, 0)
    _line("stage", name="total", seconds=f"{time.time() - t_main:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if not all(n > 0 for n in launches.values()) or plain_calls != 0 or b_max < 2:
        print(f"chip_smoke: a kernel was not launched on its path ({launches}), a "
              f"plain version was called there ({plain_calls}), or no served prefill "
              f"attention call took more than one row (largest B {b_max})", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def random_weights(cfg, gen):
    """Canonical weights at ``cfg``'s shapes (unfused, stacked [L, in, out],
    bf16; QKV biases where the family has them) drawn on the card from
    ``gen``, as a checkpoint loader gives them."""
    import torch

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "embed_tokens": (cfg.vocab_size, H), "lm_head": (H, cfg.vocab_size),
        "q_proj": (L, H, hq * d), "k_proj": (L, H, hkv * d), "v_proj": (L, H, hkv * d),
        "q_bias": (L, hq * d), "k_bias": (L, hkv * d), "v_bias": (L, hkv * d),
        "o_proj": (L, hq * d, H), "gate_proj": (L, H, I), "up_proj": (L, H, I),
        "down_proj": (L, I, H),
    }
    if not cfg.attention_bias:
        for n in ("q_bias", "k_bias", "v_bias"):
            del shapes[n]
    if not cfg.gated_mlp:  # starcoder2: c_fc / c_proj as up / down, no gate
        del shapes["gate_proj"]
    w = {n: torch.empty(s, dtype=torch.bfloat16, device="cuda").normal_(0.0, 0.02, generator=gen)
         for n, s in shapes.items()}
    for n, s in (("input_norm", (L, H)), ("post_attn_norm", (L, H)), ("final_norm", (H,))):
        w[n] = torch.ones(s, dtype=torch.bfloat16, device="cuda")
    return w


class _checked_attention:
    """While active, every attention call of the model also runs the plain
    version on the same inputs, and the kernel once more with a planted
    fault (block-table column 1 pointed at the null block). ``stats`` keeps
    (check of the kernel, check of the faulty kernel) per call, over the
    live query rows: on padded bucket-tail rows the model's plain path (the
    JAX reference's semantics) attends while the kernel writes zeros, and
    neither reaches the logits (phase 4 pins the kernel's zeros)."""

    def __init__(self):
        self.stats = []

    def __enter__(self):
        from rtp_llm_tpu_torch.models import llama_family

        self.module = llama_family
        self.orig = orig = llama_family.paged_attention

        def attn(q, k_cache, v_cache, block_tables, kv_lens, q_offsets, *args, **kw):
            import torch

            call = lambda bt, **over: orig(q, k_cache, v_cache, bt, kv_lens, q_offsets,
                                           *args, **{**kw, **over})
            got, want = call(block_tables), call(block_tables, backend="plain")
            bt_bad = block_tables.clone()
            bt_bad[:, 1] = 0
            bad = call(bt_bad)
            t = q.shape[1]
            live = (q_offsets[:, None] + torch.arange(t, device=q.device)) < kv_lens[:, None]
            self.stats.append((_check(got[live], want[live]), _check(bad[live], want[live])))
            return got

        llama_family.paged_attention = attn
        return self

    def __exit__(self, *exc):
        self.module.paged_attention = self.orig


def model_steps(cfg, gen, lens=(100, 700, 1500), t=2048, decode_steps=4):
    """Inputs of one padded B=3 prefill bucket and a few decode steps;
    returns (steps, pool blocks needed)."""
    import torch

    from rtp_llm_tpu_torch.models import ModelInputs

    lens = list(lens)
    mb = -(-(max(lens) + 8) // BS)
    bt = torch.arange(1, 1 + 3 * mb, dtype=torch.int32, device="cuda").reshape(3, mb)
    toks = torch.randint(1, cfg.vocab_size, (3, t), generator=gen, device="cuda")
    pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(3, 1)
    for r, n in enumerate(lens):
        toks[r, n:] = 0
        pos[r, n:] = 0
    steps = [ModelInputs(toks, pos, bt, torch.tensor(lens, dtype=torch.int32, device="cuda"),
                         torch.zeros(3, dtype=torch.int32, device="cuda"))]
    for i in range(decode_steps):
        cur = torch.tensor([n + i for n in lens], dtype=torch.int32, device="cuda")
        steps.append(ModelInputs(
            torch.randint(1, cfg.vocab_size, (3, 1), generator=gen, device="cuda"),
            cur[:, None], bt, cur + 1, cur))
    return steps, 3 * mb + 1


@_stage("run_steps")
def run_steps(model, weights, steps, num_blocks, ctx=None, kv="bfloat16", defer=False):
    """Forward every step on a fresh cache of type ``kv``; returns the
    stacked logits. With ``defer`` the decode steps (T = 1) leave their KV
    rows to one batched scatter after the forward, as the engine does."""
    import torch

    from rtp_llm_tpu_torch.models.llama_family import torch_dtype

    cache = model.init_cache(num_blocks, BS, torch_dtype(kv))
    write = _deferred_writer(cache, BS)
    logits = []
    with ctx or contextlib.nullcontext():
        for inp in steps:
            deferred = defer and inp.tokens.shape[1] == 1
            out, cache = model.forward(weights, cache, inp, defer_kv_writes=deferred)
            if deferred:
                write(out.kv_writes, inp.q_offsets, inp.block_tables, inp.kv_lens > 0)
            logits.append(out.logits)
    torch.cuda.synchronize()
    return torch.stack(logits)


@_stage("phase_model")
def phase_model(model, weights, steps, num_blocks, kv="bfloat16", defer=False):
    """Prefill 3 prompts (one padded B=3 bucket) + 4 decode steps through
    the kernels on a pool of type ``kv`` (decode writes deferred or
    in-layer), each layer's attention checked against the plain version;
    then the same inputs through the plain attention for the logits.
    Returns the logits of the kernel path."""
    import torch

    cfg = model.cfg
    lens = steps[0].kv_lens.tolist()
    checker = _checked_attention()
    got = run_steps(model, weights, steps, num_blocks, checker, kv=kv, defer=defer)
    model.attn_backend = "plain"
    want = run_steps(model, weights, steps, num_blocks, kv=kv, defer=defer)
    model.attn_backend = "auto"
    calls = len(checker.stats)
    layer_ok = all(c[2] for c, _ in checker.stats)
    layer_rel = max(c[1] for c, _ in checker.stats)
    layer_err = max(c[0] for c, _ in checker.stats)
    fault_caught = all(not f[2] for _, f in checker.stats)
    fault_rel = min(f[1] for _, f in checker.stats)
    rel_l2 = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ok = (got.shape == (len(steps), 3, cfg.vocab_size) and bool(torch.isfinite(got).all())
          and calls == len(steps) * cfg.num_layers and layer_ok and fault_caught
          and rel_l2 <= MODEL_LOGITS_REL_L2)
    _line("model", family=cfg.model_type, layers=cfg.num_layers, hidden=cfg.hidden_size,
          kv=kv, kv_writes="deferred" if defer else "in-layer", prompts=lens,
          decode_steps=len(steps) - 1, attn_calls_checked=calls,
          attn_max_abs_err=f"{layer_err:.3e}",
          attn_max_rel_l2=f"{layer_rel:.3e}", attn_tol=REL_L2,
          planted_fault_min_rel_l2=f"{fault_rel:.3e}", planted_fault_caught=fault_caught,
          logits_rel_l2=f"{rel_l2:.3e}", logits_tol=MODEL_LOGITS_REL_L2,
          argmax_agree=f"{agree:.3f}", ok=ok)
    if not ok:
        raise SystemExit(f"full-width model ({cfg.model_type}, {kv} KV): the kernel path "
                         "disagrees with plain attention, or the per-layer check missed "
                         "the planted fault")
    return got


# ---------------------------------------------------------------- 4-bit model

QUANT_LINEARS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")


def quantize_gptq_form(weights, group=GW_GROUP):
    """The fused bf16 linears -> the canonical form the loader emits for a
    GPTQ checkpoint: asymmetric round-to-nearest per (group, column), f16
    scales, codes - 8 packed split-half, zero - 8, the ``.int4p`` marker.
    Layer by layer on the card; everything else is shared with ``weights``."""
    import torch

    from rtp_llm_tpu_torch.ops.quant_gemm import pack_split_half

    out = {n: t for n, t in weights.items() if n not in QUANT_LINEARS}
    for name in QUANT_LINEARS:
        packed, scales, zeros = [], [], []
        for w in weights[name]:
            k, n = w.shape
            wg = w.float().reshape(k // group, group, n)
            wmin, wmax = wg.amin(dim=1), wg.amax(dim=1)
            s = ((wmax - wmin) / 15.0).clamp_min(1e-8).half().float()
            z = torch.round(-wmin / s).clamp(0, 15)
            q = (torch.round(wg / s[:, None]) + z[:, None]).clamp(0, 15)
            packed.append(pack_split_half(q.reshape(k, n).to(torch.int16) - 8))
            scales.append(s)
            zeros.append(z - 8.0)
        out[name] = torch.stack(packed)
        out[name + ".scale"] = torch.stack(scales)
        out[name + ".zero"] = torch.stack(zeros)
        out[name + ".int4p"] = True
    return out


def _plain_gemm(x, packed, scale, *, code, zero_scale, layer, variant):
    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    y = qg.groupwise_matmul_ref(x, packed[layer], scale, code)
    if zero_scale is not None:
        y = qg.subtract_zero_correction(y, x, zero_scale)
    return y


class _patched_linears:
    """While active the model's 4-bit linears go through ``fn`` (same
    signature as ``groupwise_matmul_packed`` as ``_linear`` calls it)."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from rtp_llm_tpu_torch.models import llama_family

        self.module = llama_family
        self.orig = llama_family.groupwise_matmul_packed
        llama_family.groupwise_matmul_packed = self.fn
        return self

    def __exit__(self, *exc):
        self.module.groupwise_matmul_packed = self.orig


class _checked_linears(_patched_linears):
    """While active, every 4-bit linear of the model runs the kernel, the
    plain version on the same inputs, and the kernel once more with a
    planted fault (the high plane given the low plane's scale rows).
    ``stats`` keeps (check of the kernel, check of the faulty kernel).
    What is compared is the GEMM itself, before the zero correction: that
    correction is the same plain PyTorch on both sides, and subtracting it
    cancels most of a GPTQ-form product, which would turn one bf16 ulp of
    the product into many ulps of the difference."""

    def __init__(self):
        from rtp_llm_tpu_torch.ops import quant_gemm as qg

        self.stats = []

        def gemm(x, packed, scale, *, code, zero_scale, layer, variant):
            import torch

            kw = dict(code=code, layer=layer, variant=variant)
            got = qg.groupwise_matmul_packed(x, packed, scale, **kw)
            want = qg.groupwise_matmul_ref(x, packed[layer], scale, code)
            g2 = scale.shape[0] // 2
            bad = qg.groupwise_matmul_packed(x, packed, torch.cat([scale[:g2], scale[:g2]]), **kw)
            self.stats.append((_check_gemm(got, want), _check_gemm(bad, want)))
            if zero_scale is not None:  # as the wrapper applies it
                got = qg.subtract_zero_correction(got, x, zero_scale)
            return got

        super().__init__(gemm)


@_stage("phase_model_4bit")
def phase_model_4bit(model, weights, steps, num_blocks, tag, bf16_logits=None):
    """The steps through the 4-bit kernels with every linear call checked,
    then through the plain versions for the logits."""
    import torch

    cfg = model.cfg
    checker = _checked_linears()
    got = run_steps(model, weights, steps, num_blocks, checker)
    want = run_steps(model, weights, steps, num_blocks, _patched_linears(_plain_gemm))
    calls = len(checker.stats)
    lin_ok = all(c[2] for c, _ in checker.stats)
    lin_rel = max(c[1] for c, _ in checker.stats)
    lin_err = max(c[0] for c, _ in checker.stats)
    fault_caught = all(not f[2] for _, f in checker.stats)
    fault_rel = min(f[1] for _, f in checker.stats)
    rel_l2 = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ok = (got.shape == (len(steps), 3, cfg.vocab_size) and bool(torch.isfinite(got).all())
          and calls == 4 * len(steps) * cfg.num_layers and lin_ok and fault_caught
          and rel_l2 <= MODEL_LOGITS_REL_L2)
    extra = {}
    if bf16_logits is not None:  # printed, not judged: what int4 costs in accuracy
        extra["rel_l2_to_bf16_logits"] = f"{float((got - bf16_logits).norm() / bf16_logits.norm()):.3e}"
        extra["argmax_agree_with_bf16"] = (
            f"{float((got.argmax(-1) == bf16_logits.argmax(-1)).float().mean()):.3f}")
    _line("model-4bit", case=tag, variant=model.gemm_variant, layers=cfg.num_layers,
          linear_calls_checked=calls, linear_max_abs_err=f"{lin_err:.3e}",
          linear_max_rel_l2=f"{lin_rel:.3e}", linear_tol=GW_REL_L2,
          planted_fault_min_rel_l2=f"{fault_rel:.3e}", planted_fault_caught=fault_caught,
          logits_rel_l2=f"{rel_l2:.3e}", logits_tol=MODEL_LOGITS_REL_L2,
          argmax_agree=f"{agree:.3f}", ok=ok, **extra)
    if not ok:
        raise SystemExit(f"4-bit model ({tag}): the kernel path disagrees with the plain "
                         "versions, or the per-linear check missed the planted fault")


@_stage("phase_model_4bit_packed")
def phase_model_4bit_packed(engine, gen, tag):
    """The packed prefill forwards a served 4-bit engine runs, at the rows
    its linears see there (``_prefill_forms``: a lone 1000-token prompt at
    its length, and a group of four with 2076 real rows, which gives
    ``gw_gemm_pipe`` a ragged 256-row tile), on the engine's weights and
    pool: every 4-bit linear call held against the plain version with a
    planted fault (``_checked_linears``), and the logits against a forward
    through the plain versions. The prefix cache is emptied first: the
    forms write blocks that no stream holds."""
    import torch

    model, cfg = engine.model, engine.model.cfg
    _drain(engine)
    _drop_prefix_cache(engine)
    forms = _prefill_forms(cfg, gen)
    for form in ("lone_1000", "group_4"):
        inp = forms[form]
        checker = _checked_linears()
        with checker:
            got = model.forward(engine.weights, engine.kv, inp)[0].logits
        with _patched_linears(_plain_gemm):
            want = model.forward(engine.weights, engine.kv, inp)[0].logits
        torch.cuda.synchronize()
        calls = len(checker.stats)
        lin_ok = all(c[2] for c, _ in checker.stats)
        fault_caught = all(not f[2] for _, f in checker.stats)
        rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
        rows = len(inp.row_lens)
        ok = (got.shape == (rows, cfg.vocab_size) and bool(torch.isfinite(got).all())
              and calls == 4 * cfg.num_layers and lin_ok and fault_caught
              and max(rel) <= MODEL_LOGITS_REL_L2)
        _line("model-4bit-packed", model=cfg.model_type, weights=tag,
              variant=model.gemm_variant, form=form, linear_m=sum(inp.row_lens),
              linear_calls_checked=calls,
              linear_max_abs_err=f"{max(c[0] for c, _ in checker.stats):.3e}",
              linear_max_rel_l2=f"{max(c[1] for c, _ in checker.stats):.3e}",
              linear_tol=GW_REL_L2,
              planted_fault_min_rel_l2=f"{min(f[1] for _, f in checker.stats):.3e}",
              planted_fault_caught=fault_caught,
              logits_rel_l2="|".join(f"{r:.3e}" for r in rel), logits_tol=MODEL_LOGITS_REL_L2,
              argmax_agree=f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}",
              ok=ok)
        if not ok:
            raise SystemExit(f"4-bit packed prefill ({cfg.model_type} {tag}, {form}): the "
                             "kernels disagree with the plain versions at the served rows, "
                             "or the per-linear check missed the planted fault")


@_stage("phase_model_4bit_cuts")
def phase_model_4bit_cuts(cfg, bf16_weights, wq, gen, layers=4):
    """A few layers with ``variant="pipe"`` on the GPTQ-form weights, and
    with fp4 weights from the load-time transform through both kernels."""
    import dataclasses

    from rtp_llm_tpu_torch.config import QuantConfig
    from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec
    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.quant import make_quant_transform

    cut = dataclasses.replace(cfg, num_layers=layers)
    model = LlamaFamilyModel(cut, device="cuda")
    steps, nb = model_steps(cut, gen, lens=(60, 300, 500), t=512, decode_steps=2)
    per_layer = lambda w: {n: (t[:layers] if n not in ("embed_tokens", "lm_head", "final_norm")
                               and hasattr(t, "shape") else t) for n, t in w.items()}
    model.gemm_variant = "pipe"
    phase_model_4bit(model, per_layer(wq), steps, nb, f"gptq_form_{layers}_layers")
    transform = make_quant_transform(QuantConfig(method="fp4"))
    w4 = {}
    for name, t in per_layer(bf16_weights).items():
        spec = WeightSpec(name, "", per_layer=True, transpose=True,
                          shard_axis="out" if name in QUANT_LINEARS else None)
        for suffix, v in transform(spec, t).items():
            w4[name + suffix] = v
    for variant in ("base", "pipe"):
        model.gemm_variant = variant
        phase_model_4bit(model, w4, steps, nb, f"fp4_transform_{layers}_layers")


def _sse_request(base, body):
    """POST a streaming completion; returns (ttft_s, t_last_s, last_chunk)."""
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    first, last, final = None, None, None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            now = time.time() - t0
            first = now if first is None else first
            last = now
            final = json.loads(line[len("data: "):])
    return first, last, final


def _attention_kernels(kv):
    """({name: kernel} of the pool type's decode and prefill entries, the
    attention entries of every other pool type)."""
    from rtp_llm_tpu_torch.models.llama_family import torch_dtype
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    dtype = torch_dtype(kv)
    mine = {m.KERNELS[dtype].name: m.KERNELS[dtype] for m in (decode, prefill)}
    others = [k for m in (decode, prefill) for d, k in m.KERNELS.items() if d != dtype]
    return mine, others


@_stage("phase_serve")
def phase_serve(model, weights, gen, card, tag="bf16", gemm=None, kv="bfloat16", defer=False,
                name=QWEN2_NAME, decode_steps=1, follow_up=True, q8=None, tail=False):
    """The engine behind ``build_app`` answering HTTP requests, at the
    engine's defaults: decode windows replayed as CUDA graphs, async decode,
    ``decode_steps`` tokens a window. ``gemm`` names the 4-bit GEMM variant
    the weights run through ("base" / "pipe"), None for bf16 weights; ``q8``
    the 8-bit route ("w8": weight-only int8 / fp8, "w8a8", "w4a8"), whose
    kernels must launch as often as the forwards call them; ``kv``
    the pool type, ``defer`` deferred decode writes. Every launch count of
    the path is set to 0 just before the requests and read just after
    (graph replays add what their capture launched): the attention entries
    of the engine's pool type must have launched, those of the other pool
    types not. Every decode window must be a replay, and no window without
    penalties or logprobs may be captured after ``warmup()``. With
    ``follow_up`` the same engine then holds its graphs against the eager
    window (``phase_decode_graph``) and times the decode step
    (``phase_step_time``). ``tail``: ``make_engine``'s. Returns (engine,
    launches, plain-version calls)."""
    import threading
    import urllib.request

    import torch

    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.ops import quant_gemm, quant_gemm8
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS

    cfg = model.cfg
    attn, other_attn = _attention_kernels(kv)
    q8_kernels = {k.name: k for k in quant_gemm8.KERNELS.values()}
    counted = dict(attn)
    if gemm:
        counted[quant_gemm.KERNELS[gemm].name] = quant_gemm.KERNELS[gemm]
    engine = make_engine(model, weights, gemm=gemm, kv=kv, defer=defer,
                         decode_steps=decode_steps, tail=tail)
    graphs = engine._graphs
    app = build_app(engine, tokenizer=None, model_name=f"{name}-random-{tag}-{kv}-kv")
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    try:
        def rand(n):
            return torch.randint(1, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()

        prefix = rand(1024)
        first = prefix + rand(50)
        others = [prefix + rand(80)] + [rand(n) for n in (100, 300, 600, 900, 1300, 1800)]
        body = {"max_tokens": 32, "temperature": 0, "ignore_eos": True}
        # one request samples with penalties and logprobs (the sampler's
        # other paths); the rest are greedy
        bodies = [body] * len(others)
        bodies[2] = {**body, "temperature": 0.8, "top_k": 40, "top_p": 0.9,
                     "repetition_penalty": 1.1, "logprobs": True}

        for k in (*quant_gemm.KERNELS.values(), *q8_kernels.values()):
            k.launches.n = 0
        for k in (*counted.values(), *other_attn):
            k.launches.n = 0
        PLAIN_CALLS.n = quant_gemm.PLAIN_CALLS.n = quant_gemm8.PLAIN_CALLS.n = 0
        replays0, warm, capture_s0 = graphs.replays, set(graphs.graphs), graphs.capture_seconds
        torch.cuda.reset_peak_memory_stats()
        spy = _prefill_spy(engine).__enter__()
        t0 = time.time()
        results = [_sse_request(base, {**body, "prompt": first})]
        out = [None] * len(others)

        def worker(i):
            out[i] = _sse_request(base, {**bodies[i], "prompt": others[i]})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(others))]
        t1 = time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.time() - t1
        results += out
        # a lone 1000-token prompt, no shared prefix, on a warm engine
        results.append(_sse_request(base, {**body, "prompt": rand(1000)}))
        with engine.device_lock:
            spy.__exit__()
        peak_reserved = torch.cuda.max_memory_reserved()
        launches = {n: k.launches.n for n, k in counted.items()}
        stray = {k.name: k.launches.n for k in other_attn if k.launches.n}
        gw_all = sum(k.launches.n for k in quant_gemm.KERNELS.values())
        q8_launches = {n: k.launches.n for n, k in q8_kernels.items()}
        plain_calls = PLAIN_CALLS.n + quant_gemm.PLAIN_CALLS.n + quant_gemm8.PLAIN_CALLS.n
        replays = graphs.replays - replays0
        captured = set(graphs.graphs) - warm

        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/worker_status", timeout=60) as r:
            status = json.loads(r.read())
    finally:
        app.stop()

    bad = []
    for i, res in enumerate(results):
        if res is None or res[2] is None:
            bad.append(f"request {i}: no response")
            continue
        ch, usage = res[2]["choices"][0], res[2].get("usage", {})
        if usage.get("completion_tokens") != 32 or ch.get("finish_reason") != "length":
            bad.append(f"request {i}: {usage} {ch.get('finish_reason')}")
    reuse = results[1][2]["usage"]["prompt_tokens_details"]["cached_tokens"] if results[1] else 0
    if reuse <= 0:
        bad.append("second shared-prefix request shows no prefix reuse")
    if health != {"status": "ok"} or not status.get("alive"):
        bad.append(f"health {health} / worker_status {status}")
    if replays <= 0 or engine._eager_decode:
        bad.append(f"decode windows not replayed as graphs ({replays} replays)")
    if any(not key[2] for key in captured):
        bad.append(f"windows without stats captured after warmup(): {sorted(captured)}")
    if stray or not all(launches[n] > 0 for n in attn):
        bad.append(f"a {kv} pool must be served by {sorted(attn)} alone: {launches}, "
                   f"other entries {stray}")
    # every forward call launches one attention kernel and four linears a layer
    forwards = sum(launches[n] for n in attn) // cfg.num_layers
    want_gw = 4 * cfg.num_layers * forwards if gemm else 0
    if gw_all != want_gw or (gemm and launches[quant_gemm.KERNELS[gemm].name] != want_gw):
        bad.append(f"4-bit GEMM launches {gw_all}, expected {want_gw} "
                   f"(4 x {cfg.num_layers} layers x {forwards} forward calls)")
    want_q8 = _q8_launches(q8, engine, attn, launches)
    if q8_launches != want_q8:
        bad.append(f"8-bit kernel launches {q8_launches}, expected {want_q8}")
    if plain_calls:
        bad.append(f"{plain_calls} plain-version calls on the served path")
    if bad:
        raise SystemExit(f"serve phase ({tag}) failed: " + "; ".join(bad))
    concurrent = results[1:1 + len(others)]
    ttfts = [r[0] for r in concurrent]
    rates = [31.0 / (r[1] - r[0]) for r in concurrent if r[1] > r[0]]
    total_out = sum(r[2]["usage"]["completion_tokens"] for r in concurrent)
    _line("serve", model=name, weights=tag, gemm=gemm, kv=kv,
          kv_writes="deferred" if defer else "in-layer", decode_steps=decode_steps,
          async_decode=engine.config.scheduler.async_decode, requests=len(results),
          shared_prefix_reuse_tokens=reuse,
          ttft_first_ms=f"{results[0][0] * 1e3:.1f}",
          ttft_concurrent_ms_mean=f"{1e3 * sum(ttfts) / len(ttfts):.1f}",
          ttft_concurrent_ms_max=f"{1e3 * max(ttfts):.1f}",
          ttft_lone_1000_ms=f"{results[-1][0] * 1e3:.1f}",
          ttft_lone_1000_ms_before=TTFT_BEFORE.get((name, tag, gemm, kv), "none"),
          decode_tok_per_s_per_request=f"{sum(rates) / max(len(rates), 1):.1f}",
          concurrent_tok_per_s=f"{total_out / wall:.1f}",
          forward_calls=forwards, gw_launches=gw_all, q8=q8,
          **{f"{n}_launches": c for n, c in q8_launches.items() if q8},
          **{f"{n}_launches": c for n, c in launches.items()},
          other_attention_entries_launched=sum(stray.values()), plain_calls=plain_calls,
          graph_replays=replays, graph_captures_during_serve=len(captured),
          graph_keys_captured_during_serve="|".join(map(str, sorted(captured))) or "none",
          graph_capture_seconds_during_serve=f"{graphs.capture_seconds - capture_s0:.2f}",
          **spy.fields(), peak_memory_reserved_bytes=peak_reserved,
          engine_steps=status.get("step_count"), card=card.replace(" ", "_"),
          seconds=f"{time.time() - t0:.1f}", ok=True)
    if follow_up and gemm:
        phase_prefill_pack(engine, gen, tag, card)
    if follow_up:
        phase_decode_graph(engine, cfg, gen, tag)
        phase_step_time(engine, cfg, gen, tag, card)
    launches.update({n: c for n, c in q8_launches.items() if q8})
    return engine, launches, plain_calls, spy.fields()["prefill_attention_b_max"]


def _q8_launches(q8, engine, attn, launches):
    """{8-bit kernel: launches} a serve must show: every linear of a decode
    forward (one decode attention launch a layer) and of a prefill forward
    (one prefill attention launch a layer) through its route, the int8 LM
    head through w8_gemm. W8A8 takes the weight-only product at decode."""
    from rtp_llm_tpu_torch.ops import quant_gemm8
    from rtp_llm_tpu_torch.ops.attention import decode

    layers = engine.model.cfg.num_layers
    dec_name = next(n for n in attn if n in {k.name for k in decode.KERNELS.values()})
    dec = launches[dec_name] // layers
    pre = sum(launches[n] for n in attn if n != dec_name) // layers
    head = int("lm_head.scale" in engine.weights)
    lin = 4 * layers
    n = {"w8": 0, "act_quant": 0, "i8": 0}
    if q8 == "w8":
        n["w8"] = lin * (dec + pre)
    elif q8 == "w8a8":
        n.update(w8=lin * dec, act_quant=lin * pre, i8=lin * pre)
    elif q8 == "w4a8":
        n.update(act_quant=lin * (dec + pre), i8=lin * (dec + pre))
    n["w8"] += head * (dec + pre)
    return {quant_gemm8.KERNELS[k].name: v for k, v in n.items()}


class _prefill_spy:
    """While active, records the prefills of ``engine``: each group it
    dispatches (rows, real tokens, longest row), the groups finished in a
    later step than their dispatch, the single-path prefills, the (B, T) of
    every prefill attention call (T > 1) and the M of every linear of a
    group's forward. Host-side wrappers: they launch nothing."""

    def __init__(self, engine):
        self.engine = engine
        self.groups, self.deferred, self.singles = [], 0, 0
        self.attn, self.linear_m = [], set()

    def __enter__(self):
        from rtp_llm_tpu_torch.models import llama_family

        e, model = self.engine, self.engine.model
        dispatch, finish, single = e._dispatch_prefill_group, e._finish_prefill_group, e._run_prefill
        linear, attention = model._linear, llama_family.paged_attention
        dispatched, in_group = set(), [False]

        def dispatch_spy(group):
            real = [s.prompt_len - s.reuse_len for s in group]
            self.groups.append((len(group), sum(real), max(real)))
            in_group[0] = True
            try:
                g = dispatch(group)
            finally:
                in_group[0] = False
            dispatched.add(id(g))
            return g

        def finish_spy(g):
            self.deferred += id(g) in dispatched
            return finish(g)

        def single_spy(s):
            self.singles += 1
            return single(s)

        def linear_spy(w, name, i, x, *rest):
            if in_group[0]:
                self.linear_m.add(x.shape[0])
            return linear(w, name, i, x, *rest)

        def attention_spy(q, *a, **kw):
            if q.shape[1] > 1:
                self.attn.append(tuple(q.shape[:2]))
            return attention(q, *a, **kw)

        e._dispatch_prefill_group, e._finish_prefill_group = dispatch_spy, finish_spy
        e._run_prefill, model._linear = single_spy, linear_spy
        self.module, self.attention = llama_family, attention
        llama_family.paged_attention = attention_spy
        return self

    def __exit__(self, *exc):
        for obj, name in ((self.engine, "_dispatch_prefill_group"),
                          (self.engine, "_finish_prefill_group"),
                          (self.engine, "_run_prefill"), (self.engine.model, "_linear")):
            delattr(obj, name)
        self.module.paged_attention = self.attention

    def fields(self):
        """The counts a ``[serve]`` line prints."""
        rows = sum(n for n, _, _ in self.groups)
        real = sum(t for _, t, _ in self.groups)
        padded = sum(n * t_max for n, _, t_max in self.groups)
        return dict(prefill_groups=len(self.groups),
                    rows_a_group=f"{rows / max(len(self.groups), 1):.2f}",
                    group_real_tokens="|".join(str(t) for _, t, _ in self.groups) or "none",
                    attention_padded_token_share=f"{(padded - real) / max(padded, 1):.3f}",
                    deferred_group_finishes=self.deferred, single_prefills=self.singles,
                    prefill_attention_b_max=max((b for b, _ in self.attn), default=0))


class _timed_forwards:
    """Brackets every ``model.forward`` call of ``engine`` with CUDA events:
    the device span of each forward (its kernels back to back, or the gaps
    between them where the host launches slower than the card runs)."""

    def __init__(self, engine):
        self.model, self.spans = engine.model, []

    def __enter__(self):
        import torch

        forward = self.model.forward

        def timed(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = forward(*a, **kw)
            end.record()
            self.spans.append((start, end))
            return out
        self.model.forward = timed
        return self

    def __exit__(self, *exc):
        del self.model.forward

    def take(self):
        """Device ms of each forward since the last take."""
        import torch

        torch.cuda.synchronize()
        spans, self.spans = self.spans, []
        return [s.elapsed_time(e) for s, e in spans]


def _at_plan_of(m):
    """While active every 4-bit linear runs the kernel, tile and K split
    that an ``m``-row product of its shape takes (``quant_gemm.plan``), at
    whatever rows it has: a row's sums then run in the same order as in an
    ``m``-row product."""
    from rtp_llm_tpu_torch.ops import quant_gemm as qg

    def gemm(x, packed, scale, *, code, zero_scale, layer, variant):
        k, n = 2 * packed.shape[-2], packed.shape[-1]
        return qg.groupwise_matmul_packed(
            x, packed, scale, code=code, zero_scale=zero_scale, layer=layer, variant=variant,
            tile=qg.plan(m, k, n, qg._sm_count(x.device), variant))
    return _patched_linears(gemm)


@_stage("phase_prefill_pack")
def phase_prefill_pack(engine, gen, tag, card):
    """A packed prefill group against each of its prompts prefilled alone,
    on a served full-width engine: 4 prompts of 100, 300, 900 and 1800
    tokens, the last behind a reused 1024-token prefix (776 real tokens).
    Each prompt runs alone twice: with every 4-bit linear at the plan the
    group's M takes (``_at_plan_of``), so that each row's sums run in the
    group's order, and as served, where a 100-row product runs the few-row
    kernel and a 300-row one may split K. Each packed row's first-token
    logits are held against the first by relative L2 (PACK_LOGITS_REL_L2)
    and against the second by MODEL_LOGITS_REL_L2 (sums in another order,
    over 28-32 layers of random weights). Each prompt also runs alone
    through the plain versions of the 4-bit GEMMs (its prefix cached
    through them too): the packed rows and the served solos are each held
    against those by MODEL_LOGITS_REL_L2, so that the served distance has a
    witness outside the kernels. Argmax must agree wherever the top-2 gap
    exceeds 4x the largest error measured. The group's linears must run at
    M = its real tokens and its attention at B = 4, T = the longest real
    row. Then ``phase_model_4bit_packed`` and ``phase_prefill_sync``."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    cfg = engine.model.cfg
    rand = lambda n: torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                                   device="cuda").tolist()
    prefix = rand(1024)
    prompts = [rand(100), rand(300), rand(900), prefix + rand(776)]
    group_m = sum(len(p) for p in prompts) - 1024
    one = GenerateConfig(max_new_tokens=1, do_sample=False, ignore_eos=True)
    seen = {}
    sample = engine._sample_first

    def sample_spy(streams, logits, bt):
        for r, s in enumerate(streams):
            seen[id(s)] = logits[r].float().clone()
        return sample(streams, logits, bt)

    def cache_prefix(ctx=contextlib.nullcontext()):
        _drop_prefix_cache(engine)
        with ctx:
            engine.enqueue(prefix + rand(10), one)
            _drain(engine)

    def alone(ctx, prefix_ctx=contextlib.nullcontext()):
        """Each prompt prefilled alone: (streams, forward ms)."""
        streams, ms = [], []
        cache_prefix(prefix_ctx)
        fwd.take()
        for p in prompts:
            with ctx:
                streams.append(engine.enqueue(p, one))
                _drain(engine)
            ms += fwd.take()
        return streams, ms

    _drain(engine)
    engine._sample_first = sample_spy
    try:
        with _timed_forwards(engine) as fwd:
            same_plan, _ = alone(_at_plan_of(group_m))
            served, solo_ms = alone(contextlib.nullcontext())
            plain_ctx = _patched_linears(_plain_gemm)
            plain, _ = alone(plain_ctx, plain_ctx)
            cache_prefix()
            fwd.take()
            with _prefill_spy(engine) as spy:
                group = [engine.enqueue(p, one) for p in prompts]
                engine.step()  # dispatches the group; the next step finishes it
                pending = len(engine._prefill_pending)
                _drain(engine)
            group_ms = fwd.take()
    finally:
        del engine._sample_first
    real = [s.prompt_len - s.reuse_len for s in group]
    logits = lambda streams: torch.stack([seen[id(s)] for s in streams])
    checks = {}
    # (name, rows under test, reference rows, tolerance): the packed rows
    # against the solos at the group's plan, against the served solos, and
    # both packed and served solos against the solos through the plain
    # versions (prefix cached through them too), the witness of which side
    # the served distance comes from
    for name, tested, solo, tol in (("same_plan", group, same_plan, PACK_LOGITS_REL_L2),
                                    ("served", group, served, MODEL_LOGITS_REL_L2),
                                    ("packed_vs_plain", group, plain, MODEL_LOGITS_REL_L2),
                                    ("served_vs_plain", served, plain, MODEL_LOGITS_REL_L2)):
        got, want = logits(tested), logits(solo)
        rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
        err = float((got - want).abs().max())
        top2 = want.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 4 * err
        argmax_ok = bool(((got.argmax(-1) == want.argmax(-1)) | ~decided).all())
        checks[name] = (rel, err, int(decided.sum()), argmax_ok,
                        max(rel) <= tol and argmax_ok
                        and [s.reuse_len for s in solo] == [0, 0, 0, 1024])
    shapes_ok = (spy.groups == [(4, group_m, max(real))] and spy.linear_m == {group_m}
                 and spy.attn == [(4, max(real))] * cfg.num_layers and pending == 1
                 and spy.deferred == 1 and [s.reuse_len for s in group] == [0, 0, 0, 1024])
    ok = (bool(torch.isfinite(logits(group)).all()) and all(c[-1] for c in checks.values())
          and shapes_ok and all(len(s.output_token_ids) == 1 for s in group))
    n = len(prompts)
    _line("prefill-pack", model=cfg.model_type, weights=tag, gemm=engine.model.gemm_variant,
          **_kv_mode(engine), prompts=[len(p) for p in prompts], reuse=[s.reuse_len for s in group],
          real_rows=group_m, attention_rows=n * max(real),
          padded_attention_rows=n * max(real) - group_m,
          bucketed_rows=n * 2048, gw_gemm_m="|".join(map(str, sorted(spy.linear_m))),
          k3_b_t=spy.attn[0] if spy.attn else "none",
          group_forward_ms=f"{sum(group_ms):.3f}",
          solo_forward_ms="|".join(f"{m:.3f}" for m in solo_ms),
          solo_forward_ms_sum=f"{sum(solo_ms):.3f}",
          **{f"{name}_{k}": v for name, (rel, err, decided, agree, _) in checks.items()
             for k, v in (("rel_l2", "|".join(f"{r:.3e}" for r in rel)),
                          ("max_abs_err", f"{err:.3e}"), ("argmax_decided_rows", decided),
                          ("argmax_agree", agree))},
          tol_same_plan=PACK_LOGITS_REL_L2, tol_others=MODEL_LOGITS_REL_L2,
          shapes_ok=shapes_ok, card=card.replace(" ", "_"), ok=ok)
    if not ok:
        raise SystemExit(f"prefill-pack ({cfg.model_type} {tag}): packed rows disagree with "
                         f"their solo prefills, or the group did not run at its real shape")
    phase_model_4bit_packed(engine, gen, tag)
    phase_prefill_sync(engine, gen, tag)


@_stage("phase_prefill_sync")
def phase_prefill_sync(engine, gen, tag, lens=(100, 300, 900), rows=8, stretch_cycles=2e9):
    """A group's dispatch (``_dispatch_prefill_group``, called here on
    streams the scheduler admitted) must not wait for the decode window in
    flight. ``engine.step()`` itself reads that window back before it admits
    new streams, as the JAX engine does, and a lone stream's prefill reads
    its first token back at once; what is shown here is that the packed
    path adds no wait of its own. ``rows`` streams decode (async windows),
    new streams are admitted, and the group's forward and first-token sample are dispatched
    under ``torch.cuda.set_sync_debug_mode("error")``, in which a host
    synchronisation that PyTorch sees (a blocking copy, ``.item()``,
    ``.cpu()``, a stream wait) raises. That mode does not see everything
    (a wait inside the CUDA runtime, a first kernel load), so the window in flight
    is also stretched by a spin of ``stretch_cycles`` GPU cycles (about a
    second) queued behind it, and each layer records whether that work still
    ran when the host began to launch it. The card's launch queue holds a
    bounded number of launches, and a full-width forward launches more, so
    the host stalls once the queue is full; a synchronisation would stall it
    at once. At least SYNC_MIN_LAYERS of the model's layers must be
    launched while the work ahead runs. A group of the same lengths runs first: the first launch of
    a kernel instance in a process loads it (CUDA's lazy loading), which
    waits for the device once."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    cfg, model = engine.model.cfg, engine.model
    rand = lambda n: torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                                   device="cuda").tolist()
    decoding = [rand(200) for _ in range(rows)]
    prompts = [rand(n) for n in lens]  # read back now: later the window is in flight
    _drain(engine)
    for n in lens:  # the same shapes once, to load their kernels
        engine.enqueue(rand(n), GenerateConfig(max_new_tokens=1, do_sample=False,
                                               ignore_eos=True))
    engine.step()
    _drain(engine)
    for p in decoding:
        engine.enqueue(p, GenerateConfig(max_new_tokens=64, do_sample=False, ignore_eos=True))
    for _ in range(4):
        engine.step()
    in_flight = engine._pending is not None and not engine._pending[0].event.query()
    torch.cuda._sleep(int(stretch_cycles))
    ahead = torch.cuda.Event()
    ahead.record()
    new = [engine.enqueue(p, GenerateConfig(max_new_tokens=8, do_sample=False,
                                            ignore_eos=True)) for p in prompts]
    admitted = engine.scheduler.schedule()  # host bookkeeping only
    layer, ran = model._layer, []

    def layer_spy(*a, **kw):
        ran.append(not ahead.query())
        return layer(*a, **kw)
    model._layer = layer_spy
    error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        g = engine._dispatch_prefill_group(admitted)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:  # a synchronising call under "error"
        error, g, dispatch_ms = str(e).splitlines()[0], None, 0.0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del model._layer
    # layers whose launch began while the work ahead still ran
    under = ran.index(False) if False in ran else len(ran)
    if g is not None:
        engine._prefill_pending.append(g)
    else:
        engine.abort_all("prefill-sync failed")
    _drain(engine)
    min_layers = SYNC_MIN_LAYERS[cfg.model_type]
    ok = (error is None and in_flight and under >= min_layers and admitted == new
          and all(len(s.output_token_ids) == 8 for s in new))
    _line("prefill-sync", model=cfg.model_type, weights=tag, gemm=model.gemm_variant,
          **_kv_mode(engine), decoding_rows=rows, group_rows=len(admitted),
          group_real_tokens=sum(lens), window_in_flight_before_dispatch=in_flight,
          layers_launched_while_work_ahead_ran=f"{under}/{cfg.num_layers}",
          layers_needed=min_layers,
          dispatch_host_ms=f"{dispatch_ms:.2f}", sync_debug_mode="error",
          sync_error=error or "none", ok=ok)
    if not ok:
        raise SystemExit(f"prefill-sync ({cfg.model_type} {tag}): the group's dispatch "
                         f"synchronised with the host ({error}; {under} layers launched under "
                         f"the work ahead, {min_layers} needed), or no window was in flight")


def _post(base, body):
    """POST a non-streaming completion; returns (HTTP status, parsed body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# the scheduler fields `cli serve` sets from its admission flags
ADMISSION_FIELDS = ("max_prefill_tokens_per_step", "max_prefills_per_step",
                    "decode_steps_per_prefill", "ttft_slo_ms")
RATIO_FLAGS = ("--max-prefills-per-step", "1", "--decode-steps-per-prefill", "2")
SLO_FLAGS = RATIO_FLAGS + ("--ttft-slo-ms", "50")


@_stage("phase_admission")
def phase_admission(engine, gen, card, rows=8, prompt_len=300, shed_rows=12):
    """The scheduler's admission controls on a served engine, set from the
    flags as ``cli serve`` parses them, each run a burst of concurrent HTTP
    requests with the engine's admissions recorded step by step:

    - ``off`` (the defaults) and ``ratio`` (``RATIO_FLAGS``: one admission a
      step, two decode-only steps between prefill rounds while decodes run):
      ``rows`` requests of ``prompt_len`` tokens, 16 out. Under ``ratio`` no
      step may admit more than one stream, and two steps that admit with
      decodes running must lie at least three steps apart.
    - ``slo`` (``SLO_FLAGS``: the ratio control and a 50 ms TTFT SLO):
      ``shed_rows`` requests of 1000 tokens at once. A request that finds the
      queue empty is admitted; one queued behind a 1000-token prompt projects
      a wait of that prompt over the admitted tokens a second of the last
      30 s (a few thousand here), well past 50 ms. At least one must be
      answered in full and at least one refused with HTTP 429 and an
      "overloaded" error, and no other outcome is allowed.

    The scheduler's fields are put back to the defaults at the end."""
    import threading

    import torch

    from rtp_llm_tpu_torch import cli
    from rtp_llm_tpu_torch.frontend.openai_api import build_app

    cfg, sched = engine.model.cfg, engine.scheduler
    _drain(engine)

    def configure(flags):
        sc = cli.config_from_args(cli.parse_args(["serve", "checkpoint", *flags])).scheduler
        for f in ADMISSION_FIELDS:
            setattr(engine.config.scheduler, f, getattr(sc, f))
        return {f: getattr(sc, f) for f in ADMISSION_FIELDS}

    log = []  # (streams admitted, decodes running) each step
    schedule = sched.schedule

    def schedule_spy():
        decoding = any(not s.is_finished() for s in sched.running)
        new = schedule()
        log.append((len(new), decoding))
        return new

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()

    def burst(call, bodies):
        out = [None] * len(bodies)

        def worker(i):
            out[i] = call(base, bodies[i])
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        while engine.has_work():  # the runner finishes what is left
            time.sleep(0.01)
        return out

    body = {"max_tokens": 16, "temperature": 0, "ignore_eos": True}
    app = build_app(engine, tokenizer=None, model_name="admission")
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    sched.schedule = schedule_spy
    bad, lines = [], []
    try:
        for run, flags in (("off", ()), ("ratio", RATIO_FLAGS)):
            fields = configure(flags)
            del log[:]
            res = burst(_sse_request, [{**body, "prompt": rand(prompt_len)} for _ in range(rows)])
            steps = list(log)
            admit_at = [i for i, (n, dec) in enumerate(steps) if n and dec]
            gaps = [b - a - 1 for a, b in zip(admit_at, admit_at[1:])]
            done = [r for r in res if r and r[2] and r[2]["usage"]["completion_tokens"] == 16]
            ttft = [r[0] * 1e3 for r in done]
            rates = [15.0 / (r[1] - r[0]) for r in done if r[1] > r[0]]
            most = max((n for n, _ in steps), default=0)
            if len(done) != rows:
                bad.append(f"{run}: {rows - len(done)} requests not answered in full")
            if run == "ratio" and (most > 1 or min(gaps, default=2) < 2):
                bad.append(f"ratio: {most} admissions in a step, decode-only gaps {gaps}")
            lines.append(dict(run=run, **fields, requests=rows, prompt_tokens=prompt_len,
                              engine_steps=len(steps), admission_steps=sum(n > 0 for n, _ in steps),
                              admissions_a_step_max=most,
                              decode_only_steps_between_rounds_min=min(gaps, default="none"),
                              ttft_ms_mean=f"{sum(ttft) / max(len(ttft), 1):.1f}",
                              ttft_ms_max=f"{max(ttft, default=0.0):.1f}",
                              decode_tok_per_s_per_request=f"{sum(rates) / max(len(rates), 1):.1f}"))
        fields = configure(SLO_FLAGS)
        res = burst(_post, [{**body, "prompt": rand(1000)} for _ in range(shed_rows)])
        answered = sum(st == 200 and r["usage"]["completion_tokens"] == 16 for st, r in res)
        shed = sum(st == 429 and "overloaded" in json.dumps(r) for st, r in res)
        if answered < 1 or shed < 1 or answered + shed != shed_rows:
            bad.append(f"slo: {answered} answered, {shed} refused with 429 of {shed_rows}: "
                       f"{sorted(st for st, _ in res)}")
        lines.append(dict(run="slo", **fields, requests=shed_rows, prompt_tokens=1000,
                          answered=answered, refused_429_overloaded=shed))
    finally:
        del sched.schedule
        configure(())
        app.stop()
    for kw in lines:
        _line("admission", model=cfg.model_type, gemm=engine.model.gemm_variant, **kw,
              card=card.replace(" ", "_"))
    if bad:
        raise SystemExit("admission controls: " + "; ".join(bad))


@_stage("make_engine")
def make_engine(model, weights, gemm=None, kv="bfloat16", defer=False, decode_steps=1,
                tail=False, speculative="none", draft=None, eagle=None, num_blocks=1024,
                prefix=True, recycle=False, slots=64):
    """An engine as the serve phases run it: 1024 blocks of 64 tokens, 64
    decode slots, prefix cache on, async decode, ``decode_steps`` tokens a
    window, its common decode graphs captured by ``warmup()`` (``num_blocks``,
    the prefix cache and sliding-window recycling as asked). With
    ``tail``, as ``cli serve`` does, also the stats and constrained windows
    (``warmup()``'s background captures, waited for before any timing);
    without, an engine that no phase sends constraints to leaves those to
    first use. ``speculative`` names the method (SPEC_K drafts a window;
    ``draft`` / ``eagle`` its proposer): warmup also captures each kv
    bucket's rollout and verify. ``slots``: decode slots (a split-pool
    model's rings are per slot)."""
    from rtp_llm_tpu_torch.config import (
        CacheConfig, EngineConfig, KernelConfig, QuantConfig, SchedulerConfig,
        SpeculativeConfig,
    )
    from rtp_llm_tpu_torch.engine import LlmEngine

    engine = LlmEngine(model, weights, EngineConfig(
        quant=QuantConfig(kv_cache_dtype=kv),
        kernel=KernelConfig(int4_pipeline=gemm == "pipe"),
        cache=CacheConfig(block_size=BS, num_blocks=num_blocks, enable_prefix_cache=prefix,
                          swa_recycle=recycle),
        scheduler=SchedulerConfig(defer_kv_writes=defer, decode_steps=decode_steps,
                                  max_batch_size=slots),
        speculative=SpeculativeConfig(method=speculative, draft_tokens=SPEC_K)),
        device="cuda", draft=draft, eagle=eagle)
    engine.warmup(tail=tail)
    engine.wait_warmup_complete()  # the background captures, before any timing
    return engine


def _kv_mode(engine):
    return dict(kv=engine.config.quant.kv_cache_dtype,
                kv_writes="deferred" if engine._defer_decode else "in-layer")


def _steady_decode(engine, cfg, gen, rows, max_new_tokens=64):
    """Enqueue ``rows`` 500-token prompts and step past their prefills."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    for _ in range(rows):
        prompt = torch.randint(1, cfg.vocab_size, (500,), generator=gen, device="cuda").tolist()
        engine.enqueue(prompt, GenerateConfig(max_new_tokens=max_new_tokens, do_sample=False,
                                              ignore_eos=True))
    for _ in range(3):  # prefills + first decode steps
        engine.step()
    torch.cuda.synchronize()


def _drain(engine):
    while engine.has_work():
        engine.step()


def _set_decode(engine, mode, steps, asy):
    """Switch an engine between eager and graphed windows, window length and
    async decode (the engine reads its scheduler config at every step)."""
    engine._eager_decode = mode == "eager"
    engine.config.scheduler.decode_steps = steps
    engine.config.scheduler.async_decode = asy


def _drop_prefix_cache(engine):
    """Evict every cached prefix block, so that a batch run again prefills
    as it did the first time."""
    cm = engine.cache_mgr
    while (b := cm.prefix_cache.pop_lru()) is not None:
        cm.pool.free([b])


class _timed_replays:
    """Brackets every graph replay of ``engine`` with CUDA events, so that a
    window of steps yields the device time its replays took (their kernels
    run back to back inside each replay) beside the host's wall time."""

    def __init__(self, engine):
        self.graphs, self.spans = engine._graphs, []

    def __enter__(self):
        import torch

        replay = type(self.graphs).replay

        def timed(key):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = replay(self.graphs, key)
            end.record()
            self.spans.append((start, end, key[3]))
            return out
        self.graphs.replay = timed
        return self

    def __exit__(self, *exc):
        del self.graphs.replay

    def take(self):
        """(device ms, decode positions) of the replays since the last take."""
        import torch

        torch.cuda.synchronize()
        spans, self.spans = self.spans, []
        return sum(s.elapsed_time(e) for s, e, _ in spans), sum(n for _, _, n in spans)


DECODE_MODES = (("eager", 1, False), ("eager", 1, True), ("graph", 1, False),
                ("graph", 1, True), ("graph", 4, False), ("graph", 4, True))


@_stage("phase_decode_graph")
def phase_decode_graph(engine, cfg, gen, tag, out_tokens=32):
    """Graphed decode against the eager window on a served engine. One fixed
    greedy batch (8 prompts of 100-1800 tokens, ``out_tokens`` out) runs
    eagerly, then graphed at every (decode_steps, async_decode) of
    DECODE_MODES, from an empty prefix cache each time: the same kernels on
    the same shapes in the same order, so the token ids must be identical.
    Then 8 sampled rows (temperature 0.8, top-k 40): one window replayed
    twice over the same batch state must draw different tokens, or the
    engine's generator is not registered with the graph."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig
    from rtp_llm_tpu_torch.engine.decode_graphs import WindowKey

    lens = (100, 1800, 300, 1500, 600, 1200, 900, 1000)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in lens]
    greedy = GenerateConfig(max_new_tokens=out_tokens, do_sample=False, ignore_eos=True)
    results = {}
    for mode in (DECODE_MODES[0],) + DECODE_MODES[2:]:
        _set_decode(engine, *mode)
        if mode[1] > 1:
            engine.warmup(tail=False)  # the common decode_steps windows
        _drop_prefix_cache(engine)
        streams = [engine.enqueue(p, greedy) for p in prompts]
        while not all(s.is_finished() for s in streams):
            engine.step()
        _drain(engine)
        results[mode] = [s.output_token_ids for s in streams]
    want = results[DECODE_MODES[0]]
    differ = {f"{m}-n{n}-{'async' if a else 'sync'}": sum(
        x != y for r, w in zip(got, want) for x, y in zip(r, w))
        for (m, n, a), got in results.items()}

    _set_decode(engine, "graph", 1, False)
    sampled = GenerateConfig(max_new_tokens=64, do_sample=True, temperature=0.8, top_k=40,
                             ignore_eos=True)
    streams = [engine.enqueue(p[:200], sampled) for p in prompts]
    for _ in range(2):  # prefills, then one window
        engine.step()
    active = [s for s in streams if s.slot >= 0]
    key = WindowKey(engine._kv_bucket(active, 0), True, False, 1, False)
    st = engine.state
    saved = st.last_tokens.clone(), st.kv_lens.clone()
    draws = []
    for _ in range(2):
        draws.append(engine._graphs.replay(key)[0].clone())
        st.last_tokens.copy_(saved[0])
        st.kv_lens.copy_(saved[1])
    rows = [s.slot for s in active]
    sampled_differ = int((draws[0][0, rows] != draws[1][0, rows]).sum())
    engine.abort_all("decode-graph check done")
    _drain(engine)
    _set_decode(engine, "graph", 1, True)
    graphs = engine._graphs
    _line("decode-graph", model=cfg.model_type, weights=tag, gemm=engine.model.gemm_variant,
          **_kv_mode(engine), prompts=len(prompts), out_tokens=out_tokens,
          tokens_differing_from_eager=",".join(f"{k}:{v}" for k, v in differ.items()),
          sampled_rows=len(rows), sampled_rows_differing_between_replays=sampled_differ,
          graphs=len(graphs.graphs), captures=graphs.captures,
          capture_seconds=f"{graphs.capture_seconds:.2f}",
          graph_pool_bytes=graphs.pool_bytes(),
          reserve_runtime_mem_bytes=engine.config.cache.reserve_runtime_mem_mb << 20)
    if any(differ.values()) or sampled_differ == 0:
        raise SystemExit(f"decode-graph ({cfg.model_type} {tag}): graphed tokens differ from "
                         f"eager {differ}, or two replays drew the same tokens "
                         f"({sampled_differ} sampled rows differ)")


@_stage("phase_step_time")
def phase_step_time(engine, cfg, gen, tag, card, rows=8, tokens=24):
    """Host-clock ms per output token of a steady batch of ``rows`` streams
    in each of DECODE_MODES, windows of ``tokens`` tokens a stream taken in
    turns, there and back (the host's speed drifts between runs). Beside
    each, the device ms of a token and the busy share: in a graphed window
    the replays' own device time (CUDA events around each); in an eager
    window the same kernels' device time, taken from the graphed windows
    (their mean). Taken before torch.profiler has run in this process: once
    it has, its tracing hooks stay loaded and later launches pay for them."""
    import torch

    _steady_decode(engine, cfg, gen, rows, max_new_tokens=2 * len(DECODE_MODES) * tokens + 64)
    ms = {mode: [] for mode in DECODE_MODES}
    with _timed_replays(engine) as timer:
        for mode in DECODE_MODES + DECODE_MODES[::-1]:
            _set_decode(engine, *mode)
            engine.step()  # the switch's own window
            engine._resolve_pending()  # its tokens are not this window's
            timer.take()
            t0, n0 = time.time(), engine.tokens_generated
            while engine.tokens_generated - n0 < rows * tokens:
                engine.step()
            wall = (time.time() - t0) * 1e3
            dev, positions = timer.take()
            ms[mode].append((wall * rows / (engine.tokens_generated - n0),
                             dev / positions if positions else None))
    graphed = [d for runs in ms.values() for _, d in runs if d is not None]
    eager_dev = sum(graphed) / len(graphed)
    for (m, n, a), runs in ms.items():
        dev = [eager_dev if d is None else d for _, d in runs]
        _line("step-time", model=cfg.model_type, weights=tag, gemm=engine.model.gemm_variant,
              **_kv_mode(engine), active_rows=rows, mode=m, decode_steps=n,
              async_decode=a, ms_per_token=",".join(f"{h:.2f}" for h, _ in runs),
              device_ms_per_token=",".join(f"{d:.3f}" for d in dev),
              device_ms_from="graphed_windows_mean" if m == "eager" else "replay_events",
              device_busy_share=",".join(f"{d / h:.3f}" for (h, _), d in zip(runs, dev)),
              card=card.replace(" ", "_"))
    _set_decode(engine, "graph", 1, True)
    engine.abort_all("step-time done")
    _drain(engine)
    torch.cuda.synchronize()



# ---------------------------------------------------------------- request controls

# the controls phase's limit against one plain forward (plain attention), the
# full-width logits' own (MODEL_LOGITS_REL_L2): the returned hidden states'
# relative L2, and the prompt's NLL's relative L2 about its mean (the row
# logsumexp, about ln V, is common to every token and would hide an error);
# a target shifted by one must fail the NLL check
CONTROL_REL_L2 = MODEL_LOGITS_REL_L2


class _WordTokenizer:
    """Token ids as words ("w<id>"), so that the chat route runs on a card
    with no tokenizer package: the chat template is the last message's
    words, a word that is not "w<id>" encodes to nothing."""

    unk_token_id = None

    def encode(self, text, add_special_tokens=True):
        return [int(w[1:]) for w in text.split() if w[:1] == "w" and w[1:].isdigit()]

    def decode(self, ids, **kw):
        return " ".join(f"w{t}" for t in ids)

    def apply_chat_template(self, messages, add_generation_prompt=True, tokenize=True, **kw):
        return self.encode(messages[-1]["content"])

    def convert_tokens_to_ids(self, token):
        return None


def _post_route(base, route, body, method="POST"):
    """A non-streamed request with a JSON body to ``route`` (POST, or
    ``method``); (status, parsed body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + route, data=json.dumps(body).encode(), method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _sse_choices(base, body):
    """POST a streamed completion; ({choice index: token ids}, {index:
    finish reason}, saw [DONE])."""
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, fins, done = {}, {}, False
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                ch = json.loads(line[len("data: "):])["choices"][0]
                toks.setdefault(ch["index"], []).extend(ch["token_ids"])
                if ch["finish_reason"]:
                    fins[ch["index"]] = ch["finish_reason"]
    return toks, fins, done


def _think_forced_at(out, start, end, budget, lag=1):
    """Output positions where the engine forces ``end``, by the JAX engine's
    rule: before window j (token j, j >= 1) the host reads the stream's
    think state after tokens 0 .. j - 1 - lag (at least token 0; ``lag``
    windows are in flight), writes the forcing only when it changes, and the
    window clears it once applied."""
    def forcing(toks):
        thinking, n = False, 0
        for t in toks:
            if t == start:
                thinking, n = True, 0
            elif thinking:
                if t == end:
                    thinking = False
                else:
                    n += 1
        return end if thinking and n >= budget else -1

    written, at = -1, []
    for j in range(1, len(out)):
        f = forcing(out[: max(1, j - lag)])
        if f != written:
            written = f
            if f == end:
                at.append(j)
    return at


def _repeated_ngram(ids, n):
    grams = [tuple(ids[i: i + n]) for i in range(len(ids) - n + 1)]
    return len(grams) != len(set(grams))


def _plain_all(engine, tokens, adapter_id=0, **need):
    """One forward over ``tokens`` through plain attention (under LoRA
    adapter ``adapter_id``), on a private allocation of the engine's pool:
    (all_logits, all_hidden) as asked."""
    import torch

    with engine.device_lock, torch.no_grad():
        alloc = engine.cache_mgr.allocate(tokens, allow_reuse=False)
        model = engine.model
        model.attn_backend = "plain"
        try:
            inputs = engine._prefill_inputs([(tokens, 0)], engine._block_row(alloc.blocks)[None],
                                            adapter_ids=[adapter_id])
            out, engine.kv = model.forward(engine.weights, engine.kv, inputs, **need)
        finally:
            model.attn_backend = "auto"
            engine.cache_mgr.free(alloc)
    return out.all_logits, out.all_hidden


# [logprob-gap] (ROADMAP C10): one 1000-token prompt from a generator of its
# own, 8 tokens served; one bf16 rounding of a layer's output is 2^-8
# relative, the threshold of "a layer's gap"
GAP_SEED, GAP_PROMPT, GAP_OUT, GAP_ULP = 21, 1000, 8, 2.0 ** -8


@_stage("phase_logprob_gap")
def phase_logprob_gap(engine, card):
    """``[logprob-gap]`` (ROADMAP C10): where a served logprob parts from
    the teacher-forced plain ``log_softmax``. One prompt served greedily on
    the full-width Qwen2-7B bf16 engine (its graphs), then the same tokens
    four ways, eagerly, on a private allocation, every layer's output
    captured: PK, one prefill forward over the prompt and the served tokens
    with the attention kernels (K3); PP, the same through plain attention
    (the teacher of ``_teacher_check``); DK, each served position as a
    one-row decode step with K1 reading what PK wrote; DP, the same through
    plain attention after PP. Prints each variant's largest logprob gap to
    the served tokens (served token 0 comes from the prefill, the rest from
    decode windows), each layer's relative L2 gap between DK and PP, and at
    the first layer past one bf16 rounding (``GAP_ULP``) the gaps that
    split it: DK - PK (decode against prefill form: the linears at M = 1
    against M = 1007, K1 against K3), PK - PP (K3 against plain attention),
    DK - DP (K1 against plain). Fails only on a non-finite row."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig
    from rtp_llm_tpu_torch.models import ModelInputs

    t0 = time.time()
    cfg, model = engine.model.cfg, engine.model
    own = torch.Generator(device="cuda")
    own.manual_seed(GAP_SEED)
    prompt = torch.randint(1, cfg.vocab_size, (GAP_PROMPT,), generator=own,
                           device="cuda").tolist()
    stream = engine.enqueue(prompt, GenerateConfig(max_new_tokens=GAP_OUT, do_sample=False,
                                                   ignore_eos=True, return_logprobs=True))
    while engine.has_work():
        engine.step()
    torch.cuda.synchronize()
    served = torch.tensor(stream.output_logprobs, device="cuda")
    seq = prompt + list(stream.output_token_ids)
    p, layers = len(prompt), tuple(range(cfg.num_layers))
    nxt = torch.tensor(seq[p:], device="cuda")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    got = {}
    with engine.device_lock, torch.no_grad():
        alloc = engine.cache_mgr.allocate(seq, allow_reuse=False)
        row = engine._block_row(alloc.blocks)[None]
        try:
            for backend, tag in (("auto", "K"), ("plain", "P")):
                model.attn_backend = backend
                out, engine.kv = model.forward(
                    engine.weights, engine.kv, engine._prefill_inputs([(seq[:-1], 0)], row),
                    need_all_logits=True, capture_layers=layers)
                lp = torch.log_softmax(out.all_logits.float()[p - 1:], dim=-1)
                got["P" + tag] = (lp.gather(1, nxt[:, None])[:, 0], out.all_hidden[p - 1:])
                lps, rows = [], []
                for k in range(p - 1, len(seq) - 1):
                    inp = ModelInputs(tokens=i32([[seq[k]]]), positions=i32([[k]]),
                                      block_tables=row, kv_lens=i32([k + 1]),
                                      q_offsets=i32([k]))
                    o, engine.kv = model.forward(engine.weights, engine.kv, inp,
                                                 capture_layers=layers)
                    lps.append(torch.log_softmax(o.logits.float()[0], dim=-1)[seq[k + 1]])
                    rows.append(o.all_hidden[0])
                got["D" + tag] = (torch.stack(lps), torch.stack(rows))
        finally:
            model.attn_backend = "auto"
            engine.cache_mgr.free(alloc)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(v).all()) for pair in got.values() for v in pair)
    h = cfg.hidden_size

    def per_layer(a, b):  # relative L2 a layer over the decode positions 1..
        a = got[a][1][1:].float().view(-1, cfg.num_layers, h)
        b = got[b][1][1:].float().view(-1, cfg.num_layers, h)
        return ((a - b).norm(dim=(0, 2)) / b.norm(dim=(0, 2))).tolist()

    total = per_layer("DK", "PP")
    first = next((i for i, g in enumerate(total) if g > GAP_ULP), None)
    split = {pair: per_layer(*pair) for pair in (("DK", "PK"), ("PK", "PP"), ("DK", "DP"))}
    lp_gap = {k: float((v[0] - served).abs()[1:].max()) for k, v in got.items()}
    lp_gap0 = {k: float((v[0] - served).abs()[0]) for k, v in got.items()}
    at = first if first is not None else cfg.num_layers - 1
    _line("logprob-gap", prompt=GAP_PROMPT, out_tokens=GAP_OUT,
          served_vs_decode_positions=",".join(f"{k}:{v:.4f}" for k, v in sorted(lp_gap.items())),
          served_vs_token0=",".join(f"{k}:{v:.4f}" for k, v in sorted(lp_gap0.items())),
          layer_gap_dk_pp=",".join(f"{g:.2e}" for g in total),
          first_layer_past_one_rounding=first, ulp=f"{GAP_ULP:.2e}",
          **{f"at_layer_{'_'.join(pair).lower()}": f"{split[pair][at]:.2e}" for pair in split},
          **{f"last_layer_{'_'.join(pair).lower()}": f"{split[pair][-1]:.2e}" for pair in split},
          finite=finite, seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    if not finite:
        raise SystemExit("logprob-gap: a captured row or logprob is not finite")


def _trie_walk(engine, state, prompt, served):
    """Walk a trie (``state``, a fresh ``TreeDecodeState``) over one plain
    teacher-forced forward of ``prompt + served``: at each step the plain
    logits masked to the step's allowed set (the whole vocabulary outside
    the trie's region), their argmax beside the served token. A step is
    decisive where the masked top-2 gap exceeds 2 x TEACHER_TOL (no rounding
    of the served path that size can swap them; one allowed token always
    is); there the served token must be the argmax, elsewhere one of the
    top two. Returns the counts: constrained steps, decisive ones, near ties
    and steps off the walk."""
    import torch

    logits, _ = _plain_all(engine, list(prompt) + list(served[:-1]), need_all_logits=True)
    rows = logits[len(prompt) - 1:].float()
    for t in prompt:  # the engine walks the prompt too
        state.update(t)
    out = dict(constrained=0, decisive=0, near_ties=0, off_walk=0)
    for j, t in enumerate(served):
        allowed = state.allowed()
        ids = (torch.tensor(allowed, device=rows.device) if allowed is not None
               else torch.arange(rows.shape[1], device=rows.device))
        out["constrained"] += allowed is not None
        top = rows[j, ids].topk(min(2, len(ids)))
        best = ids[top.indices].tolist()
        gap = float(top.values[0] - top.values[1]) if len(ids) > 1 else float("inf")
        if gap > 2 * TEACHER_TOL:
            out["decisive"] += 1
            out["off_walk"] += t != best[0]
        else:
            out["near_ties"] += 1
            out["off_walk"] += t not in best
        state.update(t)
    return out


def _rel_l2(got, want, centred=False):
    """||got - want|| / ||want|| (``centred``: / ||want - mean(want)||)."""
    scale = want - want.mean() if centred else want
    return float((got - want).norm() / scale.norm())


def _k3_one_row(gen):
    """K3 at one query row and an offset (the shape a teacher-forced step
    would give it) against the plain version."""
    from rtp_llm_tpu_torch.ops.attention.prefill import paged_prefill_attention, paged_prefill_ref

    offs = [0, 37, 999, 1500]
    q, k, v, bt, offs_t, lens = _prefill_inputs(gen, HQ, HKV, 1, offs, [o + 1 for o in offs], BS)
    args = (q, k, v, bt, offs_t, lens, D ** -0.5, BS)
    return _check(paged_prefill_attention(*args), paged_prefill_ref(*args))


@_stage("phase_controls")
def phase_controls(engine, gen, card):
    """The request controls on the served full-width Qwen2-7B bf16 engine,
    through HTTP (a word tokenizer for the chat route), each held against
    an unbiased greedy run of the same prompt or against one plain forward:
    logit bias (+100 pins a token, -100 keeps the plain run's first token
    out), no_repeat_ngram_size 3 (no repeated 3-gram over prompt + output;
    the prompt ends in a repeat, so the first sample is banned), a think
    budget (the end token lands where the JAX rule puts it, the start token
    being the plain run's first), a trie from a temp file (outputs after its
    start token follow prefix_dict), n = 3 sampled, streamed and not,
    top_logprobs 2 on a chat (``[]`` lists beside logprobs), calculate_loss
    (the NLL against a plain forward's log-softmax) and return_hidden_states
    (against the plain forward's final-normed hidden over the returned
    tokens; each token the argmax of the loop's own logits, and the plain
    forward's where its top-2 gap clears the rounding). Every launch count is set to 0 before the requests and read
    after: every decode window must be a replay (the constrained and stats
    keys among them), none captured during the phase, K1 and K3 launched and
    no plain version called. Then, with eager windows, two planted faults
    must fail their checks: the bias left unapplied, the forcing not
    cleared. Last, the device ms of a replayed window at 8 active rows for
    the plain, stats, constrained and constrained-with-stats keys."""
    import tempfile

    import torch

    from rtp_llm_tpu_torch.engine import engine as engine_mod
    from rtp_llm_tpu_torch.engine.decode_graphs import WindowKey
    from rtp_llm_tpu_torch.engine.logits_processors import TreeDecodeConfig, TreeDecodeState
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS

    cfg = engine.model.cfg
    t_phase = time.time()
    attn, other_attn = _attention_kernels("bfloat16")
    graphs = engine._graphs
    engine.wait_warmup_complete()
    app = build_app(engine, tokenizer=_WordTokenizer(), model_name="qwen2-7b-random-controls")
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    replayed, replay = [], type(graphs).replay

    def spy(key):
        replayed.append(key)
        return replay(graphs, key)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()

    def toks(out):
        return out["choices"][0]["token_ids"]

    bad, fields = [], {}
    try:
        for k in (*attn.values(), *other_attn):
            k.launches.n = 0
        PLAIN_CALLS.n = 0
        captures0, warm = graphs.captures, set(graphs.graphs)
        graphs.replay = spy
        n_out = 16
        greedy = {"max_tokens": n_out, "temperature": 0, "ignore_eos": True}
        # a prompt whose plain output does not open with a loop on its
        # first token (the think budget must run out)
        for _ in range(4):
            prompt = rand(40)
            plain = toks(_post(base, {**greedy, "prompt": prompt})[1])
            if plain[0] not in plain[1:6]:
                break
        start, avoid = plain[0], set(plain) | set(prompt)
        free = [t for t in rand(64) if t not in avoid]
        pin, end, trie_ids = free[0], free[1], free[2:8]

        # logit bias
        ttft, t_last, last = _sse_request(base, {**greedy, "prompt": prompt,
                                                 "logit_bias": {str(pin): 100.0}})
        _, up = _post(base, {**greedy, "prompt": prompt, "logit_bias": {str(pin): 100.0}})
        _, down = _post(base, {**greedy, "prompt": prompt, "logit_bias": {str(start): -100.0}})

        def bias_ok(up, down):
            return toks(up) == [pin] * n_out and start not in toks(down)
        if not bias_ok(up, down):
            bad.append(f"logit_bias: +100 gave {toks(up)[:6]}.., -100 gave {toks(down)[:6]}..")
        fields.update(bias_ttft_ms=f"{ttft * 1e3:.1f}",
                      bias_decode_tok_per_s=f"{(n_out - 1) / (t_last - ttft):.1f}")

        # n-gram bans: the prompt ends in a repeat, so the first token is banned
        a, b, c = rand(3)
        ng_prompt = rand(30) + [a, b, c, a, b]
        _, ng_plain = _post(base, {**greedy, "prompt": ng_prompt})
        _, ng = _post(base, {**greedy, "prompt": ng_prompt, "no_repeat_ngram_size": 3})
        ng_all = ng_prompt + toks(ng)
        fired = sum(bool(engine_mod.LlmEngine._ngram_bans(ng_all[: len(ng_prompt) + j], 3, 16))
                    for j in range(n_out))
        if _repeated_ngram(ng_all, 3) or fired == 0 or toks(ng)[0] == c:
            bad.append(f"no_repeat_ngram_size: {toks(ng)}, bans fired {fired}")
        fields.update(ngram_bans_fired=fired,
                      ngram_plain_repeats=_repeated_ngram(ng_prompt + toks(ng_plain), 3))

        # think budget: thinking opens at the plain run's first token
        think = {**greedy, "prompt": prompt, "max_thinking_tokens": 3,
                 "think_start_token_id": start, "think_end_token_id": end}

        def think_ok(out):
            want = _think_forced_at(out, start, end, 3)
            return bool(want) and [j for j, t in enumerate(out) if t == end] == want
        _, th = _post(base, think)
        if not think_ok(toks(th)):
            bad.append(f"think budget: end {end} at "
                       f"{[j for j, t in enumerate(toks(th)) if t == end]}, JAX rule "
                       f"{_think_forced_at(toks(th), start, end, 3)}")
        fields.update(think_end_at=",".join(str(j) for j in _think_forced_at(
            toks(th), start, end, 3)))

        # trie from a temp file, opened by the plain run's first token
        p, q, r, s, u, w = trie_ids
        trie = {"start_token_id": start, "end_token_id": end, "sep": "_",
                "prefix_dict": {"": [p, q], f"{p}": [r, s], f"{q}": [u], f"{p}_{r}": [w],
                                f"{p}_{s}": [w], f"{q}_{u}": [w]}}
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            json.dump(trie, f)
        with engine.device_lock:
            engine.tree_config = TreeDecodeConfig.from_file(f.name)
        try:
            _, tr = _post(base, {**greedy, "prompt": prompt})
        finally:
            with engine.device_lock:
                engine.tree_config = None
        trie_served = toks(tr)  # held against the plain walk below, after the counts

        # n = 3, sampled, not streamed and streamed
        fan = {"max_tokens": 8, "temperature": 0.8, "top_k": 40, "ignore_eos": True,
               "prompt": prompt, "n": 3}
        _, nb = _post(base, fan)
        sse_toks, sse_fins, done = _sse_choices(base, fan)
        n_ok = ([c["index"] for c in nb["choices"]] == [0, 1, 2]
                and all(len(c["token_ids"]) == 8 for c in nb["choices"])
                and sorted(sse_toks) == [0, 1, 2] and all(len(v) == 8 for v in sse_toks.values())
                and sse_fins == {0: "length", 1: "length", 2: "length"} and done)
        if not n_ok:
            bad.append(f"n=3: {nb.get('choices')} / streamed {sse_toks} {sse_fins} {done}")

        # top_logprobs on the chat route
        chat = {"messages": [{"role": "user", "content": " ".join(f"w{t}" for t in prompt)}],
                "max_tokens": 8, "temperature": 0, "ignore_eos": True, "logprobs": True,
                "top_logprobs": 2}
        _, ch = _post_route(base, "/v1/chat/completions", chat)
        content = ((ch.get("choices") or [{}])[0].get("logprobs") or {}).get("content", [])
        if not (len(content) == 8 and all(e["top_logprobs"] == [] and e["logprob"] <= 0
                                          for e in content)
                and ch["choices"][0]["token_ids"] == plain[:8]):
            bad.append(f"top_logprobs: {ch}")

        # calculate_loss and return_hidden_states; their plain forwards
        # (plain attention) come after the counts are read
        loss_prompt = prompt + plain
        _, lo = _post(base, {"prompt": loss_prompt, "max_tokens": 2, "calculate_loss": 2,
                             "temperature": 0, "ignore_eos": True})
        _, hd = _post(base, {"prompt": prompt, "max_tokens": 6, "return_hidden_states": True,
                             "temperature": 0, "ignore_eos": True})
        torch.cuda.synchronize()
        del graphs.replay
        launches = {n: k.launches.n for n, k in attn.items()}
        stray = sum(k.launches.n for k in other_attn)
        plain_calls = PLAIN_CALLS.n
        captured = set(graphs.graphs) - warm
    finally:
        graphs.__dict__.pop("replay", None)
        app.stop()

    # the trie: the served tokens are the plain forward's walk, each step's
    # argmax over its allowed set; the tokens served without the trie (a
    # planted fault: the trie left unapplied) must fail the same walk
    walk = _trie_walk(engine, TreeDecodeState(TreeDecodeConfig(**trie)), prompt, trie_served)
    unapplied = _trie_walk(engine, TreeDecodeState(TreeDecodeConfig(**trie)), prompt,
                           plain[:n_out])
    if walk["off_walk"] or walk["constrained"] < 1 or not unapplied["off_walk"]:
        bad.append(f"trie: served {trie_served}, {walk}; served without the trie {unapplied}")
    fields.update(trie_constrained_tokens=walk["constrained"],
                  trie_decisive_positions=walk["decisive"], trie_near_ties=walk["near_ties"],
                  trie_off_walk=walk["off_walk"],
                  trie_unapplied_off_walk=unapplied["off_walk"])

    logits, _ = _plain_all(engine, loss_prompt, need_all_logits=True)
    logp = torch.log_softmax(logits[:-1], dim=-1)
    nxt = torch.tensor(loss_prompt[1:], device="cuda")[:, None]
    ref = -logp.gather(1, nxt)[:, 0]
    shifted = -logp[:-1].gather(1, nxt[1:])[:, 0]  # a planted off-by-one target
    got = torch.tensor(lo.get("loss") or [0.0], device="cuda")
    loss_rel = _rel_l2(got, ref, centred=True) if got.shape == ref.shape else float("inf")
    shift_rel = _rel_l2(shifted, ref[1:], centred=True)
    if loss_rel > CONTROL_REL_L2 or shift_rel <= CONTROL_REL_L2:
        bad.append(f"calculate_loss: centred rel L2 {loss_rel:.3e} against the plain NLL, "
                   f"the shifted target's {shift_rel:.3e} (limit {CONTROL_REL_L2})")
    fields.update(loss_tokens=ref.numel(), loss_centred_rel_l2=f"{loss_rel:.3e}",
                  loss_max_abs_err=(f"{float((got - ref).abs().max()):.3e}"
                                    if got.shape == ref.shape else "none"),
                  loss_shifted_target_centred_rel_l2=f"{shift_rel:.3e}")
    hid_toks = toks(hd)
    hid = torch.tensor(hd["choices"][0].get("hidden_states") or [[0.0]], device="cuda")
    plain_lg, hidden = _plain_all(engine, prompt + hid_toks[:-1], need_all_logits=True,
                                  need_all_hidden=True)
    want_hid = hidden[len(prompt) - 1:].float()
    plain_lg = plain_lg[len(prompt) - 1:]
    hid_ok = hid.shape == want_hid.shape and len(hid_toks) == 6
    hid_rel = _rel_l2(hid, want_hid) if hid_ok else float("inf")
    # every token against the loop's own logits (its returned hidden rows
    # through the head, one row a call as the loop ran them: the argmax, up
    # to a bf16 step of the row's largest logit), and against the plain
    # forward's argmax wherever that one's top-2 gap exceeds twice the row's
    # largest logit error between the two, which no rounding of that size
    # can flip (below it the loop's one-token forwards may round a near tie
    # the other way)
    gaps, errs, own_ok, vs_plain = [], [], hid_ok, []
    if hid_ok:
        loop_lg = torch.cat([engine.model._lm_head(engine.weights, hid[i: i + 1].to(hidden.dtype))
                             for i in range(len(hid_toks))])
        top2 = plain_lg.topk(2, dim=-1)
        for i, t in enumerate(hid_toks):
            row_max = float(loop_lg[i].max())
            own_ok = own_ok and row_max - float(loop_lg[i, t]) <= abs(row_max) * 2 ** -7
            gaps.append(float(top2.values[i, 0] - top2.values[i, 1]))
            errs.append(float((loop_lg[i] - plain_lg[i]).abs().max()))
            if gaps[-1] > 2 * errs[-1]:
                vs_plain.append(t == int(top2.indices[i, 0]))
    if hid_rel > CONTROL_REL_L2 or not own_ok or not all(vs_plain) or hid_toks[0] != plain[0]:
        bad.append(f"return_hidden_states: rel L2 {hid_rel:.3e}, tokens {hid_toks} (served "
                   f"{plain[:6]}), own argmax {own_ok}, against plain {vs_plain}")
    fields.update(hidden_shape="x".join(map(str, hid.shape)), hidden_rel_l2=f"{hid_rel:.3e}",
                  hidden_tokens="/".join(map(str, hid_toks)),
                  hidden_served_tokens="/".join(map(str, plain[:6])),
                  hidden_plain_top2_gaps="/".join(f"{g:.4f}" for g in gaps),
                  hidden_logit_max_errs="/".join(f"{e:.4f}" for e in errs),
                  hidden_tokens_checked_against_plain=len(vs_plain))
    k3_err, k3_rel, k3_ok = _k3_one_row(gen)
    if not k3_ok:
        bad.append(f"K3 at one query row disagrees with plain (rel L2 {k3_rel:.3e})")

    keys = set(replayed)
    if engine._eager_decode or not replayed:
        bad.append("decode windows not replayed as graphs")
    if not any(k[4] for k in keys) or not any(k[2] and not k[4] for k in keys):
        bad.append(f"no constrained or no stats window replayed: {sorted(keys)}")
    if captured or graphs.captures != captures0:
        bad.append(f"graphs captured during the phase: {sorted(captured)}")
    if not all(launches[n] > 0 for n in attn) or stray or plain_calls:
        bad.append(f"K1 / K3 launches {launches}, other entries {stray}, "
                   f"plain calls {plain_calls}")

    # planted faults, with eager windows: the same checks must fail
    engine._eager_decode = True
    app = build_app(engine, tokenizer=None)
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    real_sample = engine_mod.sample_tokens
    caught = {}
    try:
        def no_bias(*args, **kw):
            kw.pop("bias_ids", None)
            kw.pop("bias_vals", None)
            return real_sample(*args, **kw)
        engine_mod.sample_tokens = no_bias
        _, up = _post(base, {**greedy, "prompt": prompt, "logit_bias": {str(pin): 100.0}})
        _, down = _post(base, {**greedy, "prompt": prompt, "logit_bias": {str(start): -100.0}})
        caught["bias_left_unapplied"] = not bias_ok(up, down)
        engine_mod.sample_tokens = real_sample
        engine.state.clear_forced = lambda: None
        caught["forcing_not_cleared"] = not think_ok(toks(_post(base, think)[1]))
    finally:
        engine_mod.sample_tokens = real_sample
        engine.state.__dict__.pop("clear_forced", None)
        engine._eager_decode = False
        app.stop()
    if not all(caught.values()):
        bad.append(f"a planted fault passed its check: {caught}")

    # device ms of one replayed window at 8 active rows, in turns
    _steady_decode(engine, cfg, gen, 8)
    kvb = engine._kv_bucket([s for s in engine.scheduler.running if s.slot >= 0], 64)
    st = engine.state
    saved = st.last_tokens.clone(), st.kv_lens.clone()
    win = {"plain": WindowKey(kvb, False, False, 1, False),
           "stats": WindowKey(kvb, False, True, 1, False),
           "constrained": WindowKey(kvb, False, False, 1, True),
           "constrained_stats": WindowKey(kvb, False, True, 1, True)}
    ms = {name: [] for name in win}
    for name in list(win) + list(win)[::-1]:
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(10):
            graphs.replay(win[name])
        end_ev.record()
        torch.cuda.synchronize()
        ms[name].append(start_ev.elapsed_time(end_ev) / 10)
        st.last_tokens.copy_(saved[0])
        st.kv_lens.copy_(saved[1])
    engine.abort_all("controls done")
    _drain(engine)
    _line("controls", model=cfg.model_type, weights="bf16", prompt_len=len(prompt),
          **fields, graph_replays=len(replayed),
          graph_keys_replayed="|".join(map(str, sorted(keys))),
          graph_captures_during_serve=len(captured),
          **{f"{n}_launches": c for n, c in launches.items()},
          other_attention_entries_launched=stray, plain_calls=plain_calls,
          k3_one_row_max_abs_err=f"{k3_err:.3e}", k3_one_row_max_rel_l2=f"{k3_rel:.3e}",
          planted_faults_caught=",".join(f"{k}:{v}" for k, v in caught.items()),
          window_device_ms_8_rows=",".join(
              f"{n}:{'/'.join(f'{t:.3f}' for t in v)}" for n, v in ms.items()),
          card=card.replace(" ", "_"), seconds=f"{time.time() - t_phase:.1f}",
          ok=not bad)
    if bad:
        raise SystemExit("controls phase failed: " + "; ".join(bad))
    return launches


# ---------------------------------------------------------------- frontend

# the forced chat answer, in pieces that split every tag: a think block, then
# one hermes tool call; ids high in the Qwen2 vocabulary, none an EOS
FRONTEND_PIECES = {150000: "<thi", 150001: "nk>The user", 150002: " wants the weather",
                   150003: "</th", 150004: "ink><tool", 150005: '_call>{"name": "get_',
                   150006: 'weather", "arguments": ', 150007: '{"city": "Paris"}}</tool_',
                   150008: "call>"}
FRONTEND_REASONING = "The user wants the weather"
FRONTEND_CALL = ("get_weather", {"city": "Paris"})
FRONTEND_END = 150100  # the trie's end token, kept out by a -100 bias
ACCESS_LOG = os.path.join("build", "access.log")  # every served request's JSON lines
FRONTEND_TAGS = ("<think>", "</think>", "<tool_call>", "</tool_call>")
FRONTEND_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "look up weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]


class _PieceTokenizer(_WordTokenizer):
    """``_WordTokenizer`` with fixed text pieces: an id of
    ``FRONTEND_PIECES`` decodes to its piece (the others to " w<id>"), and
    encode reads pieces beside "w<id>" words."""

    def encode(self, text, add_special_tokens=True):
        by_text = {v: k for k, v in FRONTEND_PIECES.items()}
        ids, rest = [], text
        while rest.strip():
            rest = rest.lstrip()
            piece = next((p for p in sorted(by_text, key=len, reverse=True)
                          if rest.startswith(p)), None)
            if piece is not None:
                ids.append(by_text[piece])
                rest = rest[len(piece):]
                continue
            word, _, rest = rest.partition(" ")
            if word[:1] == "w" and word[1:].isdigit():
                ids.append(int(word[1:]))
        return ids

    def decode(self, ids, **kw):
        return "".join(FRONTEND_PIECES.get(int(t), f" w{int(t)}") for t in ids)

    def convert_ids_to_tokens(self, ids):
        return [FRONTEND_PIECES.get(int(t), f"w{int(t)}") for t in ids]


def _sse_events(base, route, body):
    """POST a streamed request; its chunks (parsed) and whether [DONE] came."""
    import urllib.request

    req = urllib.request.Request(base + route, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    chunks, done = [], False
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                chunks.append(json.loads(line[len("data: "):]))
    return chunks, done


def _get_route(base, route, headers=None):
    """GET ``route``; (status, body: parsed JSON, else text)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + route, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            data = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        data, status = e.read(), e.code
    try:
        return status, json.loads(data)
    except ValueError:
        return status, data.decode()


def _forced_chat_faults(out, chunks, done):
    """What is wrong with a forced chat answer (non-streamed ``out``,
    streamed ``chunks``), against the forced reasoning and call."""
    bad = []
    ch = (out.get("choices") or [{}])[0]
    msg = ch.get("message") or {}
    calls = msg.get("tool_calls") or []

    def call_ok(calls):
        try:
            return (len(calls) == 1 and calls[0]["function"]["name"] == FRONTEND_CALL[0]
                    and json.loads(calls[0]["function"]["arguments"]) == FRONTEND_CALL[1])
        except (KeyError, ValueError, TypeError):
            return False
    if not (msg.get("reasoning_content") == FRONTEND_REASONING and call_ok(calls)
            and msg.get("content") in (None, "") and ch.get("finish_reason") == "tool_calls"):
        bad.append(f"message {msg}, finish {ch.get('finish_reason')}")
    deltas = [c["choices"][0] for c in chunks]
    reasoning = "".join(d["delta"].get("reasoning_content") or "" for d in deltas)
    contents = [d["delta"]["content"] for d in deltas[1:] if d["delta"].get("content")]
    s_calls = [tc for d in deltas for tc in d["delta"].get("tool_calls") or []]
    fins = [d["finish_reason"] for d in deltas if d["finish_reason"]]
    leaked = [c for c in contents if any(t[:k] in c for t in FRONTEND_TAGS
                                         for k in range(2, len(t) + 1))]
    if not (done and deltas and deltas[0]["delta"] == {"role": "assistant", "content": ""}
            and reasoning == FRONTEND_REASONING and call_ok(s_calls) and not contents
            and fins == ["tool_calls"]):
        bad.append(f"stream: reasoning {reasoning!r}, content deltas {contents} (pieces of a "
                   f"tag {leaked}), calls {s_calls}, finishes {fins}, [DONE] {done}")
    return bad


@_stage("phase_frontend")
def phase_frontend(engine, gen, card):
    """``[frontend]`` on the served full-width Qwen2-7B bf16 engine: the
    forced think + tool-call chat parsed both ways, the routes, the graphs
    and launches, two planted parser faults (see the module docstring,
    7a')."""
    import logging
    import tempfile
    import threading

    import torch

    from rtp_llm_tpu_torch.engine.logits_processors import TreeDecodeConfig
    from rtp_llm_tpu_torch.frontend import output_parsers
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS

    cfg = engine.model.cfg
    t_phase = time.time()
    attn, other_attn = _attention_kernels("bfloat16")
    graphs = engine._graphs
    engine.wait_warmup_complete()
    name = "qwen2-7b-random-frontend"
    app = build_app(engine, tokenizer=_PieceTokenizer(), model_name=name)
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    replayed, replay = [], type(graphs).replay

    def spy(key):
        replayed.append(key)
        return replay(graphs, key)

    def words(n):
        ids = torch.randint(1, 140000, (n,), generator=gen, device="cuda").tolist()
        return ids, " ".join(f"w{t}" for t in ids)

    forced = list(FRONTEND_PIECES)
    prefix = {"_".join(map(str, forced[1: i + 1])): [forced[i + 1]]
              for i in range(len(forced) - 1)}
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"start_token_id": forced[0], "end_token_id": FRONTEND_END, "sep": "_",
                   "prefix_dict": prefix}, f)
    _, text = words(30)
    chat = {"messages": [{"role": "user", "content": text}], "max_tokens": len(forced),
            "temperature": 0, "ignore_eos": True,
            "logit_bias": {str(forced[0]): 100.0, str(FRONTEND_END): -100.0}}
    greedy = {"max_tokens": 8, "temperature": 0, "ignore_eos": True}
    bad, fields, decode_tokens, requests = [], {}, [0], [0]

    def served(*token_lists):  # generation requests' output ids, one list each
        requests[0] += len(token_lists)
        decode_tokens[0] += sum(max(len(t) - 1, 0) for t in token_lists)  # first: prefill

    def metrics():
        with engine.device_lock:  # the step that answered the last request has ended
            return _get_route(base, "/metrics?format=json")[1]

    def forced_round(tag):
        with engine.device_lock:
            engine.tree_config = TreeDecodeConfig.from_file(f.name)
        try:
            out = {}
            for tools in (True, False):
                body = {**chat, **({"tools": FRONTEND_TOOLS} if tools else {})}
                status, out[tools] = _post_route(base, "/v1/chat/completions", body)
                chunks, done = _sse_events(base, "/v1/chat/completions", body)
                out[tools, "sse"] = (chunks, done)
                if tag == "real":
                    served(out[tools]["choices"][0]["token_ids"],
                           [t for c in chunks for t in c["choices"][0]["token_ids"]])
        finally:
            with engine.device_lock:
                engine.tree_config = None
        return [f"{'tools' if tools else 'no tools'}: {b}" for tools in (True, False)
                for b in _forced_chat_faults(out[tools], *out[tools, "sse"])], out

    access0 = _access_lines()
    root = logging.getLogger()
    level = root.level
    push_s, pushes = [0.0], [0]
    real_push = output_parsers.StreamingOutputParser.push

    def timed_push(self, delta):
        t0 = time.perf_counter()
        try:
            return real_push(self, delta)
        finally:
            push_s[0] += time.perf_counter() - t0
            pushes[0] += 1
    try:
        for k in (*attn.values(), *other_attn):
            k.launches.n = 0
        PLAIN_CALLS.n = 0
        captures0, warm = graphs.captures, set(graphs.graphs)
        graphs.replay = spy
        m0 = metrics()
        output_parsers.StreamingOutputParser.push = timed_push
        try:
            wrong, out = forced_round("real")
        finally:
            output_parsers.StreamingOutputParser.push = real_push
        bad += wrong
        if out[True]["choices"][0]["token_ids"] != forced:
            bad.append(f"forced ids: {out[True]['choices'][0]['token_ids']}")
        fields.update(forced_tokens=len(forced),
                      parser_push_us_per_chunk=f"{push_s[0] / max(pushes[0], 1) * 1e6:.1f}",
                      parser_pushes=pushes[0])

        # routes
        status, models = _get_route(base, "/v1/models")
        if status != 200 or models["data"][0]["id"] != name:
            bad.append(f"/v1/models: {status} {models}")
        if _get_route(base, "/status") != (200, {"status": "ok"}):
            bad.append("/status")
        prompt, _ = words(40)
        _, root_out = _post_route(base, "/", {**greedy, "prompt": prompt})
        _, cmpl = _post_route(base, "/v1/completions", {**greedy, "prompt": prompt})
        served(root_out["choices"][0]["token_ids"], cmpl["choices"][0]["token_ids"])
        if root_out["choices"][0]["token_ids"] != cmpl["choices"][0]["token_ids"]:
            bad.append("POST / and /v1/completions disagree")
        enc = _post_route(base, "/tokenizer/encode", {"prompt": "w5 w6 <thi"})
        if enc != (200, {"token_ids": [5, 6, forced[0]], "tokens": ["w5", "w6", "<thi"]}):
            bad.append(f"/tokenizer/encode: {enc}")
        lv = _post_route(base, "/set_log_level", {"level": "warning"})
        if lv != (200, {"status": "ok", "level": "WARNING"}) or root.level != logging.WARNING:
            bad.append(f"/set_log_level: {lv}")
        root.setLevel(level)
        _, c0 = _get_route(base, "/cache_status")
        cache_prompt, _ = words(200)
        _, co = _post_route(base, "/v1/completions", {**greedy, "prompt": cache_prompt})
        served(co["choices"][0]["token_ids"])
        with engine.device_lock:
            pass  # the release that inserted the blocks has run
        _, c1 = _get_route(base, "/cache_status")
        _, diff = _get_route(base, f"/cache_status?from_version={c0['version']}")
        inserted = (len(cache_prompt) + len(co["choices"][0]["token_ids"]) - 1) // BS
        if not (c1["version"] > c0["version"] and len(diff["added"]) == inserted
                and all(isinstance(h, int) for h in diff["added"])):
            bad.append(f"/cache_status: {c0['version']} -> {c1['version']}, "
                       f"{len(diff['added'])} hashes added for {inserted} blocks")
        fields.update(cache_version=f"{c0['version']}->{c1['version']}",
                      cache_hashes_added=len(diff["added"]))

        # pause: a request sent while paused takes no step for 1 s
        _post_route(base, "/pause", {})
        steps0, got = -1, {}
        while steps0 != engine.step_count:  # the step in progress at the pause ends
            steps0 = engine.step_count
            time.sleep(0.2)
        pause_prompt, _ = words(50)
        t = threading.Thread(target=lambda: got.update(out=_post_route(
            base, "/v1/completions", {**greedy, "prompt": pause_prompt})))
        t.start()
        time.sleep(1.0)
        held = engine.step_count == steps0 and "out" not in got
        restart = _post_route(base, "/restart", {})
        t.join(600)
        pout = got.get("out", (0, {}))
        if not (held and restart == (200, {"status": "running"}) and pout[0] == 200
                and len(pout[1]["choices"][0]["token_ids"]) == 8):
            bad.append(f"/pause: held {held}, restart {restart}, then {pout[0]}")
        else:
            served(pout[1]["choices"][0]["token_ids"])

        # profile one request: the trace names K3's kernel (prefill is eager)
        trace_dir = os.path.join("build", "frontend_trace")
        p1 = _post_route(base, "/start_profile", {"dir": trace_dir})
        p2 = _post_route(base, "/start_profile", {"dir": trace_dir})
        prof_prompt, _ = words(100)
        _, po = _post_route(base, "/v1/completions", {**greedy, "prompt": prof_prompt})
        served(po["choices"][0]["token_ids"])
        p3 = _post_route(base, "/stop_profile", {})
        names = set()
        if p3[0] == 200:
            with open(p3[1]["trace"]) as tf:
                names = {str(e.get("name", "")) for e in json.load(tf)["traceEvents"]}
        k3_named = any("paged_prefill_kernel" in n for n in names)
        k1_named = any("paged_decode_kernel" in n for n in names)
        if p1[0] != 200 or p2[0] != 409 or p3[0] != 200 or not k3_named:
            bad.append(f"profile routes: {p1[0]}, second start {p2[0]}, stop {p3[0]}, "
                       f"K3 named {k3_named}")
        fields.update(trace_events=len(names), trace_names_k3=k3_named, trace_names_k1=k1_named)

        torch.cuda.synchronize()
        m1 = metrics()
        del graphs.replay
        launches = {n: k.launches.n for n, k in attn.items()}
        stray = sum(k.launches.n for k in other_attn)
        plain_calls = PLAIN_CALLS.n
        captured = set(graphs.graphs) - warm
    finally:
        graphs.__dict__.pop("replay", None)
        root.setLevel(level)

    c0_, c1_ = m0["counters"], m1["counters"]
    tok_delta = c1_.get("engine.tokens_generated", 0) - c0_.get("engine.tokens_generated", 0)
    ttft0 = m0["histograms"].get("frontend.ttft_ms", {"count": 0})["count"]
    ttft_delta = m1["histograms"]["frontend.ttft_ms"]["count"] - ttft0
    req_delta = c1_.get("frontend.requests", 0) - c0_.get("frontend.requests", 0)
    if not (tok_delta == decode_tokens[0] and ttft_delta == requests[0] == req_delta):
        bad.append(f"/metrics: tokens_generated +{tok_delta} for {decode_tokens[0]} decode "
                   f"tokens served, ttft count +{ttft_delta} and requests +{req_delta} for "
                   f"{requests[0]} requests")
    status, text = _get_route(base, "/metrics")
    if status != 200 or "rtp_engine_tokens_generated_total" not in text:
        bad.append("/metrics: no Prometheus text")
    fields.update(tokens_generated_delta=tok_delta, decode_tokens_served=decode_tokens[0],
                  ttft_count_delta=ttft_delta, requests=requests[0])

    keys = set(replayed)
    if engine._eager_decode or not replayed or not any(k[4] for k in keys):
        bad.append(f"decode windows not replayed as graphs (constrained among them): "
                   f"{sorted(keys)}")
    if captured or graphs.captures != captures0:
        bad.append(f"graphs captured during the phase: {sorted(captured)}")
    if not all(launches[n] > 0 for n in attn) or stray or plain_calls:
        bad.append(f"K1 / K3 launches {launches}, other entries {stray}, "
                   f"plain calls {plain_calls}")

    # planted faults: the same checks must fail
    caught = {}
    real_parse, real_stream = app.parse, app.stream_parser
    real_holdback = output_parsers.StreamingOutputParser._holdback

    class RawParser:
        def push(self, text):
            return "", text

        def finalize(self):
            return "", "", None
    try:
        app.parse = lambda text: output_parsers.ParsedOutput(content=text)
        app.stream_parser = RawParser
        caught["parser_bypassed"] = bool(forced_round("fault")[0])
        app.parse, app.stream_parser = real_parse, real_stream
        output_parsers.StreamingOutputParser._holdback = lambda self, text: (text, "")
        wrong, _ = forced_round("fault")
        caught["zero_holdback"] = any("pieces of a tag ['" in w for w in wrong)
    finally:
        app.parse, app.stream_parser = real_parse, real_stream
        output_parsers.StreamingOutputParser._holdback = real_holdback
        app.stop()
        os.unlink(f.name)
    if not all(caught.values()):
        bad.append(f"a planted fault passed its check: {caught}")
    access = _access_lines()[len(access0):]
    for _ in range(20):  # the log's listener thread writes behind
        if sum(r["type"] == "success" for r in access) >= requests[0]:
            break
        time.sleep(0.1)
        access = _access_lines()[len(access0):]
    if sum(r["type"] == "success" for r in access) < requests[0]:
        bad.append(f"access log: {len(access)} lines for {requests[0]} requests")
    _line("frontend", model=cfg.model_type, weights="bf16", **fields,
          graph_replays=len(replayed), graph_captures_during_serve=len(captured),
          **{f"{n}_launches": c for n, c in launches.items()},
          other_attention_entries_launched=stray, plain_calls=plain_calls,
          access_log_lines=len(access),
          planted_faults_caught=",".join(f"{k}:{v}" for k, v in caught.items()),
          card=card.replace(" ", "_"), seconds=f"{time.time() - t_phase:.1f}", ok=not bad)
    if bad:
        raise SystemExit("frontend phase failed: " + "; ".join(bad))


def _access_lines():
    """The access log's records so far (``ACCESS_LOG``, set up by ``main``)."""
    if not os.path.exists(ACCESS_LOG):
        return []
    with open(ACCESS_LOG) as f:
        return [json.loads(line) for line in f if line.strip()]


def _save_hf_checkpoint(path, cfg, weights):
    """Canonical unfused weights as an HF checkpoint (``[out, in]`` linears,
    one tensor a layer) in one .safetensors file; returns (bytes, names)."""
    from rtp_llm_tpu_torch.loader.weight_maps import get_weight_specs, hf_names_for

    tensors = {}
    for spec in get_weight_specs(cfg):
        t = weights[spec.name]
        parts = t.unbind(0) if spec.per_layer else [t]
        for hf, part in zip(hf_names_for(spec, cfg.num_layers), parts):
            tensors[hf] = part.transpose(-1, -2) if spec.transpose else part
    os.makedirs(path, exist_ok=True)
    _save_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return sum(t.numel() * t.element_size() for t in tensors.values()), list(tensors)


@_stage("phase_update_weights")
def phase_update_weights(cfg, card, layers=2):
    """``[update-weights]`` on a ``layers``-layer cut of ``cfg`` at full
    width (see the module docstring, 7a')."""
    import dataclasses
    import gc
    import shutil

    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.loader import CheckpointLoader
    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.server import engine_runner

    t_phase = time.time()
    cut = dataclasses.replace(cfg, num_layers=layers)
    model = LlamaFamilyModel(cut, device="cuda")
    engine = make_engine(model, _seeded_weights(model, 21, "qwen2-7b-2l-a"))
    app = build_app(engine, tokenizer=None, model_name="qwen2-7b-2l-update")
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)

    def rand(n):
        return torch.randint(1, cut.vocab_size, (n,), generator=gen, device="cuda").tolist()

    greedy = {"max_tokens": 16, "temperature": 0, "ignore_eos": True}
    loss_prompt = rand(300)
    root = os.path.join("build", "update_weights")
    dir_b, dir_bad = os.path.join(root, "b"), os.path.join(root, "wrong_shape")
    bad, fields = [], {}
    try:
        status, first = _post_route(base, "/v1/completions", {**greedy, "prompt": rand(100)})
        loss_a = torch.tensor(_post_route(base, "/v1/completions", {
            "prompt": loss_prompt, "max_tokens": 1, "calculate_loss": 2})[1]["loss"])
        t0 = time.time()
        wgen = torch.Generator(device="cuda")
        wgen.manual_seed(22)
        nbytes, names = _save_hf_checkpoint(dir_b, cut, random_weights(cut, wgen))
        write_s = time.time() - t0
        # one tensor of another shape: every other name read from B's file
        os.makedirs(dir_bad, exist_ok=True)
        _save_safetensors(os.path.join(dir_bad, "norm.safetensors"), {
            "model.norm.weight": torch.ones(cut.hidden_size - 1, dtype=torch.bfloat16)})
        with open(os.path.join(dir_bad, "model.safetensors.index.json"), "w") as jf:
            json.dump({"weight_map": {n: ("norm.safetensors" if n == "model.norm.weight"
                                          else "../b/model.safetensors")
                                      for n in names}}, jf)

        fresh_model = LlamaFamilyModel(cut, device="cuda")
        fresh = make_engine(fresh_model, CheckpointLoader(cut, device="cuda").load(dir_b))
        loss_b = fresh.compute_prompt_loss(loss_prompt)
        serve_prompt = rand(120)
        want = fresh.generate(serve_prompt, GenerateConfig(max_new_tokens=16, do_sample=False,
                                                           ignore_eos=True)).output_token_ids

        def update_and_serve():
            t0 = time.time()
            st, body = _post_route(base, "/update_weights", {"model_path": dir_b})
            took = time.time() - t0
            _, out = _post_route(base, "/v1/completions", {**greedy, "prompt": serve_prompt})
            _, lo = _post_route(base, "/v1/completions", {"prompt": loss_prompt, "max_tokens": 1,
                                                          "calculate_loss": 2})
            return st, took, out["choices"][0]["token_ids"], torch.tensor(lo["loss"])

        # the planted rebinding first: the graphs keep reading A
        live = dict(engine.weights)
        real_copy = engine_runner.copy_weights
        engine_runner.copy_weights = lambda old, new: old.update(new)
        try:
            st, _, fault_toks, fault_loss = update_and_serve()
        finally:
            engine_runner.copy_weights = real_copy
            with engine.device_lock:
                engine.weights.clear()
                engine.weights.update(live)
        caught = st == 200 and fault_toks != want
        copy_s = []

        def timed_copy(old, new):
            torch.cuda.synchronize()
            t0 = time.time()
            real_copy(old, new)
            torch.cuda.synchronize()
            copy_s.append(time.time() - t0)
        engine_runner.copy_weights = timed_copy
        try:
            st, update_s, got, loss_got = update_and_serve()
        finally:
            engine_runner.copy_weights = real_copy
        same_storage = all(engine.weights[k] is t for k, t in live.items())
        rel = _rel_l2(loss_got, loss_b, centred=True)
        rel_a = _rel_l2(loss_a, loss_b, centred=True)
        if not (st == 200 and got == want and rel <= CONTROL_REL_L2 and rel_a > 10 * CONTROL_REL_L2
                and same_storage):
            bad.append(f"update: {st}, tokens {got[:6]}.. vs fresh {want[:6]}.., loss centred "
                       f"rel L2 {rel:.3e} (A's {rel_a:.3e}), storage kept {same_storage}")
        if not caught:
            bad.append(f"the planted rebinding passed: tokens {fault_toks[:6]}..")
        st_bad, err = _post_route(base, "/update_weights", {"model_path": dir_bad})
        _, after = _post_route(base, "/v1/completions", {**greedy, "prompt": serve_prompt})
        if st_bad != 400 or after["choices"][0]["token_ids"] != want:
            bad.append(f"wrong shape: {st_bad} {err}, then tokens equal "
                       f"{after['choices'][0]['token_ids'] == want}")
        fields.update(checkpoint_gbytes=f"{nbytes / 1e9:.2f}", write_s=f"{write_s:.1f}",
                      update_http_s=f"{update_s:.2f}", copy_s=f"{copy_s[0]:.3f}",
                      load_s=f"{update_s - copy_s[0]:.2f}",
                      loss_centred_rel_l2=f"{rel:.3e}", loss_a_centred_rel_l2=f"{rel_a:.3e}",
                      tokens_equal_fresh=got == want, rebinding_fault_caught=caught,
                      rebinding_fault_loss_centred_rel_l2=(
                          f"{_rel_l2(fault_loss, loss_b, centred=True):.3e}"),
                      wrong_shape_status=st_bad, first_status=status)
    finally:
        app.stop()
        shutil.rmtree(root, ignore_errors=True)
    del engine, fresh, model, fresh_model
    gc.collect()
    torch.cuda.empty_cache()
    _line("update-weights", model=f"{cfg.model_type}-{layers}l", **fields,
          card=card.replace(" ", "_"), seconds=f"{time.time() - t_phase:.1f}", ok=not bad)
    if bad:
        raise SystemExit("update-weights phase failed: " + "; ".join(bad))


# ---------------------------------------------------------------- speculative decoding

SPEC_K = 4  # drafts a verify window checks
SPEC_ROWS = 8
# contexts of the rows a verify window is checked at
SPEC_LENS = (100, 300, 500, 700, 900, 1200, 1500, 1800)
# a position is decisive where its top-2 logit gap exceeds this many times
# the largest logit error measured on the same window (kernel against plain
# attention, and the decode window against the verify's first position)
SPEC_DECISIVE = 4.0
# an EAGLE engine's generate_with_hidden rows against the served engine's:
# the same forwards on the same model object and weights, another pool
HIDDEN_REL_L2 = 1e-3
# Llama-3-8B EAGLE heads at the shapes of yuhuili/EAGLE-LLaMA3-Instruct-8B
# (fc 8192 -> 4096, one layer) and yuhuili/EAGLE3-LLaMA3.1-Instruct-8B (3
# captured layers, fc 12288 -> 4096, a 32000-id draft vocabulary with d2t)
EAGLE3_DRAFT_VOCAB = 32000


def _spec_gen(seed):
    """The speculative phases' own generator: drawing from the shared one
    would change the data of every phase after them."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def _rand_tokens(gen, vocab, n):
    import torch

    return torch.randint(1, vocab, (n,), generator=gen, device="cuda").tolist()


def _spec_prompts(gen, vocab, rows=SPEC_ROWS, seg=128, total=1000):
    """Prompts that repeat a seeded 128-token segment (one a row) to about
    1000 tokens: prompt lookup finds a continuation at every position."""
    return [(_rand_tokens(gen, vocab, seg) * (total // seg + 1))[: total - 24 * r]
            for r in range(rows)]


def _admit_rows(engine, prompts, max_new=64):
    """Admit and prefill ``prompts`` into decode slots, with no decode step,
    and grow each allocation for a verify window: the engine's state then
    holds the rows with their first tokens pending."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    streams = [engine.enqueue(p, GenerateConfig(max_new_tokens=max_new, do_sample=False,
                                                ignore_eos=True)) for p in prompts]
    k = engine.spec.draft_tokens
    with engine.device_lock, torch.no_grad():
        while engine.scheduler.waiting:
            new = engine.scheduler.schedule()
            if not new:
                raise SystemExit("spec: admission stalled")
            for s in new:
                engine._run_prefill(s)
        for s in streams:
            if s.slot < 0 or not engine.cache_mgr.extend(s.alloc, s.total_len + k):
                raise SystemExit("spec: a row did not reach a decode slot")
            engine.state.block_tables[s.slot] = engine._block_row(s.alloc.blocks)
            engine._slot_nblocks[s.slot] = len(s.alloc.blocks)
    torch.cuda.synchronize()
    return streams


def _spec_snapshot(engine):
    st = engine.state
    return (st.last_tokens.clone(), st.kv_lens.clone(), st.output_counts.clone(),
            engine.eagle.hidden.clone() if engine.eagle is not None else None)


def _spec_restore(engine, snap):
    st = engine.state
    st.last_tokens.copy_(snap[0])
    st.kv_lens.copy_(snap[1])
    st.output_counts.copy_(snap[2])
    if snap[3] is not None:
        engine.eagle.hidden.copy_(snap[3])


def _top2_gap(logits):
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _count_all_matches(all_logits, drafts):
    """A planted fault: acceptance that counts every matching draft, also
    past the first mismatch."""
    import torch

    g = torch.argmax(all_logits, dim=-1)
    return g, (drafts.to(g.dtype) == g[:, :-1]).long().sum(-1) + 1


def _verify_checks(engine, streams, teacher=None, expect_accept=True):
    """One verify window at the rows of ``streams`` (``_admit_rows``).

    (a) its logits against the same window through plain attention: relative
    L2 within MODEL_LOGITS_REL_L2; a planted fault (the queries one position
    late, ``q_offsets + 1``) must exceed it. (b) The drafts (``teacher``:
    {stream: the normal engine's greedy tokens}, else the engine's own
    rollout): with ``expect_accept``, at every leading decisive position the
    verify's argmax is the draft and the draft is accepted. Then the
    acceptance itself: drafts [g0, X, g2, 0], whose second is wrong and
    third right, must emit exactly the count the host computes from the
    window's argmax, through ``_verify_window``; a planted acceptance that
    counts past the first mismatch must not. The state is restored after.
    Returns (fields, the largest logit error, bad)."""
    import torch

    from rtp_llm_tpu_torch.engine import engine as engine_mod
    from rtp_llm_tpu_torch.models import ModelInputs

    k, st, model = engine.spec.draft_tokens, engine.state, engine.model
    kvb = engine._kv_bucket(streams, k)
    idx = torch.tensor([s.slot for s in streams], device="cuda")
    snap = _spec_snapshot(engine)
    bad = []
    with engine.device_lock, torch.no_grad():
        if teacher is None:
            engine._window(engine._spec_keys(kvb)[0])
            _spec_restore(engine, snap)  # the rollout moved an EAGLE head's features
        else:
            host = torch.zeros(tuple(engine._draft_buf.shape), dtype=torch.int64)
            for s in streams:
                host[s.slot] = torch.tensor(teacher[s][1: k + 1])
            engine._draft_buf.copy_(host)
        drafts = engine._draft_buf.clone()
        logits, _ = engine._verify_logits(kvb, k)
        model.attn_backend = "plain"
        try:
            plain, _ = engine._verify_logits(kvb, k)
        finally:
            model.attn_backend = "auto"
        active = st.kv_lens > 0
        dec, _ = model.forward(engine.weights, engine.kv, ModelInputs(
            st.last_tokens[:, None], torch.where(active, st.kv_lens, 0)[:, None],
            st.block_tables[:, :kvb], torch.where(active, st.kv_lens + 1, 0), st.kv_lens))
        orig = engine._verify_inputs
        engine._verify_inputs = lambda kb, kk: orig(kb, kk)._replace(q_offsets=st.kv_lens + 1)
        try:
            shifted, _ = engine._verify_logits(kvb, k)
        finally:
            del engine._verify_inputs
        lk, lp = logits[idx].float(), plain[idx].float()
        # compared where no EOS ban put -1e30 (it would swamp every norm)
        cols = ~engine._ban_row
        lkc, lpc = lk[..., cols], lp[..., cols]
        err_kp = float((lkc - lpc).abs().max())
        err_dv = float((dec.logits[idx][:, cols].float() - lkc[:, 0]).abs().max())
        err = max(err_kp, err_dv)
        rel, rel_fault = _rel_l2(lkc, lpc), _rel_l2(shifted[idx][..., cols].float(), lpc)
        if not (bool(torch.isfinite(lk).all()) and rel <= MODEL_LOGITS_REL_L2):
            bad.append(f"verify logits rel L2 {rel:.3e} to plain attention")
        if rel_fault <= MODEL_LOGITS_REL_L2:
            bad.append(f"the q_offsets + 1 fault passed (rel L2 {rel_fault:.3e})")

        # (b) the drafts at the leading decisive positions
        g = lk.argmax(-1)
        decisive = _top2_gap(lk) > SPEC_DECISIVE * err
        d = drafts[idx]
        acc = torch.cumprod((d == g[:, :k]).long(), -1).sum(-1)
        lead = skipped = full = 0
        for i, s in enumerate(streams):
            if teacher is not None and teacher[s][0] != int(st.last_tokens[s.slot]):
                skipped += 1  # the first tokens differ (a non-decisive prefill)
                continue
            j = 0
            while j < k and bool(decisive[i, j]):
                j += 1
            if expect_accept and (bool((g[i, :j] != d[i, :j]).any()) or int(acc[i]) < j):
                bad.append(f"row {i}: a decisive draft rejected (argmax {g[i].tolist()}, "
                           f"drafts {d[i].tolist()}, accepted {int(acc[i])})")
            lead += j
            full += int(acc[i]) == k

        # the acceptance through the window, and its planted fault
        vocab = lk.shape[-1]
        x0 = (g[:, 0] + 7) % vocab
        pass_a = torch.zeros_like(engine._draft_buf)
        pass_a[idx, 0], pass_a[idx, 1] = g[:, 0], x0
        engine._draft_buf.copy_(pass_a)
        ga = engine._verify_logits(kvb, k)[0][idx].argmax(-1)
        pass_c = pass_a.clone()
        pass_c[idx, 2] = ga[:, 2]
        engine._draft_buf.copy_(pass_c)
        gc_ = engine._verify_logits(kvb, k)[0][idx].argmax(-1)
        want_n = 1 + torch.cumprod((pass_c[idx] == gc_[:, :k]).long(), -1).sum(-1)
        emitted, right = {}, engine_mod.greedy_verify
        try:
            for name, fn in (("right", right), ("fault", _count_all_matches)):
                _spec_restore(engine, snap)
                engine._draft_buf.copy_(pass_c)
                engine_mod.greedy_verify = fn
                (out,) = engine._verify_window(kvb, k)
                emitted[name] = out[k + 1][idx].clone()
        finally:
            engine_mod.greedy_verify = right
            _spec_restore(engine, snap)
        if not torch.equal(emitted["right"], want_n):
            bad.append(f"emitted {emitted['right'].tolist()}, the argmax says {want_n.tolist()}")
        caught = not torch.equal(emitted["fault"], want_n)
        if not caught:
            bad.append("the acceptance counting past the first mismatch passed")
    torch.cuda.synchronize()
    fields = dict(rows=len(streams), verify_logits_rel_l2=f"{rel:.3e}",
                  verify_logits_max_abs=f"{err_kp:.3e}", decode_vs_verify_max_abs=f"{err_dv:.3e}",
                  decisive_gap=f"{SPEC_DECISIVE * err:.3e}",
                  decisive_leading_positions=lead, rows_skipped=skipped,
                  rows_fully_accepted=full,
                  drafts_accepted_mean=f"{float(acc.float().mean()):.2f}",
                  q_offset_fault_rel_l2=f"{rel_fault:.3e}", q_offset_fault_caught=rel_fault >
                  MODEL_LOGITS_REL_L2, emitted=",".join(map(str, emitted["right"].tolist())),
                  overcount_fault_caught=caught)
    return fields, err, bad


def _replay_ms(engine, keys, reps=10):
    """Device ms of one replay of each key on the engine's current rows,
    in turns there and back: {key: [ms, ms]}. The lengths and pending
    tokens are put back before every replay (a verify advances them)."""
    import torch

    snap = _spec_snapshot(engine)
    st = engine.state
    ms = {key: [] for key in keys}
    with engine.device_lock, torch.no_grad():
        for key in list(keys) + list(keys)[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                st.last_tokens.copy_(snap[0])
                st.kv_lens.copy_(snap[1])
                engine._graphs.replay(key)
            end.record()
            torch.cuda.synchronize()
            ms[key].append(start.elapsed_time(end) / reps)
        _spec_restore(engine, snap)
    return ms


def _ms_field(ms):
    return "/".join(f"{t:.3f}" for t in ms)


def _serve_greedy(engine, prompts, max_new=64):
    """Serve ``prompts`` together through ``engine.step`` from an empty
    prefix cache: (outputs, mean decode tok/s a request, stats of the
    speculative steps it took)."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    _drop_prefix_cache(engine)
    spec0 = dict(engine.spec_stats)
    streams = [engine.enqueue(p, GenerateConfig(max_new_tokens=max_new, do_sample=False,
                                                ignore_eos=True)) for p in prompts]
    first, done = {}, {}
    while not all(s.is_finished() for s in streams):
        engine.step()
        now = time.perf_counter()
        for i, s in enumerate(streams):
            if s.output_token_ids and i not in first:
                first[i] = now
            if s.is_finished() and i not in done:
                done[i] = now
    _drain(engine)
    torch.cuda.synchronize()
    rates = [(len(s.output_token_ids) - 1) / (done[i] - first[i])
             for i, s in enumerate(streams) if done[i] > first[i]]
    spec = {n: engine.spec_stats[n] - spec0[n] for n in spec0}
    return [s.output_token_ids for s in streams], sum(rates) / max(len(rates), 1), spec


def _decisive_mismatches(normal, prompts, want, got, err):
    """Rows whose tokens differ from the normal engine's at a decisive
    position: the first differing position's top-2 gap, in a plain forward
    over the prompt and the normal tokens before it, above SPEC_DECISIVE x
    ``err``. Returns (rows equal, [(row, position, gap)] of the decisive
    mismatches, [gap at the first mismatch] of the others)."""
    equal, decisive, loose = 0, [], []
    for r, (p, a, b) in enumerate(zip(prompts, want, got)):
        m = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if m is None and len(a) == len(b):
            equal += 1
            continue
        m = min(len(a), len(b)) if m is None else m
        logits, _ = _plain_all(normal, p + a[:m], need_all_logits=True)
        gap = float(_top2_gap(logits[-1].float()))
        (decisive if gap > SPEC_DECISIVE * err else loose).append((r, m, round(gap, 4)))
    return equal, decisive, loose


def _spec_serve_counts(engine, kernels):
    """Zero the launch counts, plain calls and note the graphs: a closure
    that reads them back after a serve."""
    from rtp_llm_tpu_torch.ops import quant_gemm
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS

    for k in kernels.values():
        k.launches.n = 0
    PLAIN_CALLS.n = quant_gemm.PLAIN_CALLS.n = 0
    captures0 = engine._graphs.captures

    def read():
        return ({n: k.launches.n for n, k in kernels.items()},
                PLAIN_CALLS.n + quant_gemm.PLAIN_CALLS.n, engine._graphs.captures - captures0)
    return read


def _spec_turns(normal, spec, prompts, kernels):
    """Serve ``prompts`` on the normal and the speculative engine in turns
    (normal, spec, spec, normal); the launches, plain calls and captures of
    the spec turns. Returns (normal outputs, spec outputs, {normal: [tok/s],
    spec: [tok/s]}, spec stats of its first turn, launches, plain calls,
    captures)."""
    rates = {"normal": [], "spec": []}
    outs, stats = {}, None
    launches = dict.fromkeys(kernels, 0)
    plain = captures = 0
    for turn in ("normal", "spec", "spec", "normal"):
        engine = normal if turn == "normal" else spec
        read = _spec_serve_counts(engine, kernels) if turn == "spec" else None
        out, rate, st = _serve_greedy(engine, prompts)
        rates[turn].append(rate)
        outs.setdefault(turn, out)
        if read is not None:
            got, p, c = read()
            for n, v in got.items():
                launches[n] += v
            plain, captures = plain + p, captures + c
            stats = stats or st
    return outs["normal"], outs["spec"], rates, stats, launches, plain, captures


def _spec_stats_fields(st):
    steps = max(st["steps"], 1)
    return dict(verify_steps=st["steps"],
                tokens_per_verify_row=f"{st['tokens'] / max(st['rows'], 1):.3f}",
                host_propose_ms_per_step=f"{1e3 * st['propose_s'] / steps:.3f}",
                host_verify_ms_per_step=f"{1e3 * st['verify_s'] / steps:.3f}")


def _graph_launches(engine, want):
    """Launches one replay of each speculative graph adds, from what its
    capture recorded (``CapturedCalls``), against ``want`` {(kind, kernel):
    launches a replay}: (fields, bad). Every kv bucket's graph of the kind
    must launch exactly that many."""
    fields, bad = {}, []
    for (kind, kernel), n in want.items():
        got = {key.kv_blocks: sum(d for c, d in g.calls.deltas if c is kernel.launches)
               for key, g in engine._graphs.graphs.items() if key.kind == kind}
        fields[f"{kind}_graph_{kernel.name}_launches"] = (
            "|".join(map(str, sorted(set(got.values())))) or "none")
        if not got or set(got.values()) != {n}:
            bad.append(f"{kind} graphs launch {kernel.name} {got} times, want {n} a replay")
    return fields, bad


@_stage("phase_spec")
def phase_spec(normal, card, spec_launches):
    """``[spec]``: a second engine on the served full-width Qwen2-7B bf16
    weights (shared, no copy) with prompt lookup, K = SPEC_K, 64 slots and
    1024 blocks of 64. (a) / (b): ``_verify_checks`` at 8 rows of 100-1800
    tokens with the normal engine's greedy continuation as drafts. (c): 8
    greedy requests whose prompts repeat a 128-token segment to about 1000
    tokens, 64 out, on the normal and the spec engine in turns: tokens equal
    at decisive positions, K3 launched, no plain call, no capture. Every
    verify graph launches K3 once a layer. The device ms of a replayed
    verify window and of a decode window at 8 rows. The spec turns'
    launches are added to ``spec_launches``."""
    import torch

    from rtp_llm_tpu_torch.engine.decode_graphs import WindowKey
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    cfg, gen = normal.model.cfg, _spec_gen(150)
    t0 = time.time()
    spec = make_engine(normal.model, normal.weights, speculative="prompt_lookup")
    warm_s = time.time() - t0
    prompts = [_rand_tokens(gen, cfg.vocab_size, n) for n in SPEC_LENS]
    teacher = _serve_greedy(normal, prompts, max_new=SPEC_K + 1)[0]
    streams = _admit_rows(spec, prompts)
    checks, err, bad = _verify_checks(spec, streams, dict(zip(streams, teacher)))
    kvb = spec._kv_bucket(streams, SPEC_K)
    verify, window = spec._spec_keys(kvb)[-1], WindowKey(kvb, False, False, 1, False)
    ms = _replay_ms(spec, [verify, window])
    spec.abort_all("checked")
    _drain(spec)

    kernels = {k.name: k for k in (prefill.KERNELS[torch.bfloat16], decode.KERNELS[torch.bfloat16])}
    graph_fields, graph_bad = _graph_launches(
        spec, {("verify", kernels["paged_prefill"]): cfg.num_layers})
    bad += graph_bad
    serve_prompts = _spec_prompts(gen, cfg.vocab_size)
    want, got, rates, st, launches, plain, captures = _spec_turns(normal, spec, serve_prompts,
                                                                  kernels)
    equal, decisive, loose = _decisive_mismatches(normal, serve_prompts, want, got, err)
    if decisive:
        bad.append(f"tokens differ from the normal engine's at decisive positions {decisive}")
    if launches["paged_prefill"] <= 0 or plain or captures:
        bad.append(f"launches {launches}, plain calls {plain}, captures during serve {captures}")
    spec_launches.update(launches)
    _line("spec", model=QWEN2_NAME, weights="bf16", method="prompt_lookup", k=SPEC_K,
          **checks, **graph_fields, verify_device_ms_8_rows=_ms_field(ms[verify]),
          decode_window_device_ms_8_rows=_ms_field(ms[window]),
          kv_blocks=kvb, serve_rows_equal=equal, serve_first_mismatch_gaps=loose or "none",
          **_spec_stats_fields(st),
          decode_tok_per_s_per_request_normal=_ms_field(rates["normal"]),
          decode_tok_per_s_per_request_spec=_ms_field(rates["spec"]),
          **{f"{n}_launches": v for n, v in launches.items()}, plain_calls=plain,
          graph_captures_during_serve=captures, graphs=len(spec._graphs.graphs),
          warmup_seconds=f"{warm_s:.1f}", card=card.replace(" ", "_"),
          seconds=f"{time.time() - t0:.1f}", ok=not bad)
    del spec
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit("spec phase failed: " + "; ".join(bad))
    return want, serve_prompts, err


@_stage("phase_spec_draft")
def phase_spec_draft(normal, want, serve_prompts, err, card, spec_launches):
    """``[spec-draft]``. The cost run: a full-width Qwen2-1.5B bf16 draft
    (seeded; vocabulary 151936 within the target's) for the Qwen2-7B bf16
    target serves ``serve_prompts``: its rollout and verify ms at 8 rows,
    K1 launched on the draft's pool, tokens equal to the normal engine's
    at decisive positions. The acceptance check: a 4-layer cut of Qwen2-7B
    as its own draft, ``_verify_checks`` with the rollout's drafts, full
    acceptance at every decisive position; then it serves ``serve_prompts``
    in turns with a normal engine on the same cut (model object and
    weights): more than one token a verify row (drafts accepted in served
    steps), tokens equal at decisive positions. Every rollout graph launches
    K1 once a draft layer a step, every verify graph K3 once a layer."""
    import dataclasses
    import gc

    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_1_5b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    t0, gen = time.time(), _spec_gen(151)
    model, weights, cfg = normal.model, normal.weights, normal.model.cfg
    dmodel = LlamaFamilyModel(qwen2_1_5b_config(), device="cuda")
    dweights = _seeded_weights(dmodel, 3, "qwen2-1.5b-draft")
    eng = make_engine(model, weights, speculative="vanilla", draft=(dmodel, dweights))
    kernels = {k.name: k for k in (prefill.KERNELS[torch.bfloat16],
                                   decode.KERNELS[torch.bfloat16])}
    per_replay = lambda draft_layers, layers: {  # noqa: E731
        ("vanilla", kernels["paged_decode"]): (SPEC_K + 1) * draft_layers,
        ("verify", kernels["paged_prefill"]): layers}
    graph_fields, bad = _graph_launches(eng, per_replay(dmodel.cfg.num_layers, cfg.num_layers))
    read = _spec_serve_counts(eng, kernels)
    got, rate, st = _serve_greedy(eng, serve_prompts)
    launches, plain, captures = read()
    equal, decisive, loose = _decisive_mismatches(normal, serve_prompts, want, got, err)
    streams = _admit_rows(eng, serve_prompts)
    kvb = eng._kv_bucket(streams, SPEC_K)
    rollout, verify = eng._spec_keys(kvb)
    ms = _replay_ms(eng, [rollout, verify])
    eng.abort_all("timed")
    _drain(eng)
    if decisive:
        bad.append(f"tokens differ from the normal engine's at decisive positions {decisive}")
    if launches["paged_decode"] <= 0 or plain or captures:
        bad.append(f"launches {launches}, plain calls {plain}, captures during serve {captures}")
    spec_launches.update(launches)
    fields = dict(cost_draft="qwen2-1.5b", rollout_device_ms_8_rows=_ms_field(ms[rollout]),
        verify_device_ms_8_rows=_ms_field(ms[verify]), **graph_fields, kv_blocks=kvb,
        serve_rows_equal=equal, serve_first_mismatch_gaps=loose or "none",
        decode_tok_per_s_per_request=f"{rate:.1f}", **_spec_stats_fields(st),
        **{f"{n}_launches": v for n, v in launches.items()}, plain_calls=plain,
        graph_captures_during_serve=captures)
    del eng, dmodel, dweights
    gc.collect()
    torch.cuda.empty_cache()

    # the acceptance check: a 4-layer cut as its own draft
    layers = 4
    cut_cfg = dataclasses.replace(cfg, num_layers=layers)
    whole = ("embed_tokens", "lm_head", "final_norm")
    cut_w = {n: (t if n in whole else t[:layers].clone()) for n, t in weights.items()}
    eng = make_engine(LlamaFamilyModel(cut_cfg, device="cuda"), cut_w, speculative="vanilla",
                      draft=(LlamaFamilyModel(cut_cfg, device="cuda"), dict(cut_w)))
    streams = _admit_rows(eng, [_rand_tokens(gen, cfg.vocab_size, n) for n in SPEC_LENS])
    checks, err_self, bad_self = _verify_checks(eng, streams)
    bad += bad_self
    eng.abort_all("checked")
    _drain(eng)
    graph_fields, graph_bad = _graph_launches(eng, per_replay(layers, layers))
    checks.update(graph_fields)
    bad += graph_bad
    # served: the accepting path (several tokens a row a step) through the
    # graphed rollout and verify, against a normal engine on the same cut
    cut_normal = make_engine(eng.model, eng.weights)
    want_s, got_s, rates, st, launches, plain, captures = _spec_turns(cut_normal, eng,
                                                                      serve_prompts, kernels)
    equal, decisive, loose = _decisive_mismatches(cut_normal, serve_prompts, want_s, got_s,
                                                  err_self)
    if decisive:
        bad.append(f"self-draft tokens differ from the normal engine's at decisive "
                   f"positions {decisive}")
    if st["tokens"] <= st["rows"]:
        bad.append(f"self-draft served {st['tokens']} tokens over {st['rows']} verify rows: "
                   "no draft accepted in a served step")
    if launches["paged_decode"] <= 0 or launches["paged_prefill"] <= 0 or plain or captures:
        bad.append(f"self-draft launches {launches}, plain calls {plain}, captures during "
                   f"serve {captures}")
    spec_launches.update(launches)
    checks.update(serve_rows_equal=equal, serve_first_mismatch_gaps=loose or "none",
                  **_spec_stats_fields(st),
                  decode_tok_per_s_per_request_normal=_ms_field(rates["normal"]),
                  decode_tok_per_s_per_request_spec=_ms_field(rates["spec"]),
                  **{f"{n}_launches": v for n, v in launches.items()}, plain_calls=plain,
                  graph_captures_during_serve=captures)
    del eng, cut_normal, cut_w
    gc.collect()
    torch.cuda.empty_cache()
    _line("spec-draft", target=QWEN2_NAME, weights="bf16", k=SPEC_K, **fields,
          self_draft=f"qwen2-7b-{layers}-layers", **{f"self_{n}": v for n, v in checks.items()},
          card=card.replace(" ", "_"), seconds=f"{time.time() - t0:.1f}", ok=not bad)
    if bad:
        raise SystemExit("spec-draft phase failed: " + "; ".join(bad))


_ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float32": "F32", "torch.int64": "I64"}


def _save_safetensors(path, tensors):
    """A .safetensors file (an 8-byte header length, a JSON header, the raw
    little-endian bytes): the GPU machine has no ``safetensors`` package."""
    import struct

    import torch

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def _write_eagle_head(path, cfg, gen, eagle3):
    """A random bf16 EAGLE (or EAGLE3) head for ``cfg`` under HF names
    ([out, in] linears, norms of ones): the shapes of the published
    Llama-3-8B heads. Returns its directory."""
    import torch

    h, hq, hkv, d, inter = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_kv_heads,
                            cfg.head_dim, cfg.intermediate_size)

    def w(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
            0.0, 0.02, generator=gen)

    ones = lambda: torch.ones(h, dtype=torch.bfloat16, device="cuda")  # noqa: E731
    layer = "midlayer." if eagle3 else "layers.0."
    hin = 2 * h if eagle3 else h
    t = {"fc.weight": w(h, (3 if eagle3 else 2) * h),
         layer + "self_attn.q_proj.weight": w(hq * d, hin),
         layer + "self_attn.k_proj.weight": w(hkv * d, hin),
         layer + "self_attn.v_proj.weight": w(hkv * d, hin),
         layer + "self_attn.o_proj.weight": w(h, hq * d),
         layer + "mlp.gate_proj.weight": w(inter, h), layer + "mlp.up_proj.weight": w(inter, h),
         layer + "mlp.down_proj.weight": w(h, inter),
         layer + "post_attention_layernorm.weight": ones()}
    if eagle3:
        cpu = torch.Generator().manual_seed(11)
        ids = torch.randperm(cfg.vocab_size, generator=cpu)[:EAGLE3_DRAFT_VOCAB].sort().values
        t.update({"midlayer.input_layernorm.weight": ones(),
                  "midlayer.hidden_norm.weight": ones(), "norm.weight": ones(),
                  "lm_head.weight": w(EAGLE3_DRAFT_VOCAB, h),
                  "d2t": ids - torch.arange(EAGLE3_DRAFT_VOCAB)})
    os.makedirs(path, exist_ok=True)
    _save_safetensors(os.path.join(path, "model.safetensors"), t)
    return path


@_stage("phase_spec_eagle")
def phase_spec_eagle(served, card, spec_launches):
    """``[spec-eagle]`` on the served full-width Llama-3-8B (``LLAMA_LAYERS``
    layers) int4 + int8 KV deferred engine's weights: a random EAGLE and a
    random EAGLE3 head at
    the published heads' shapes, written as safetensors under ``build/`` and
    read back through ``load_eagle_weights``, each behind its own engine on
    the served engine's model object. Each runs ``_verify_checks`` (drafts
    from its rollout) with every attention call (paged_prefill_i8) and every
    4-bit linear (gw_gemm at M = 64 x (K+1)) of one verify held against the
    plain versions, then serves the 8 requests beside the served engine:
    tokens equal at decisive positions, no plain call, no capture; rollout
    and verify ms at 8 rows; every rollout graph launches K1 once a step,
    every verify graph K3-i8 once a layer. Its ``generate_with_hidden``
    returns the served engine's final-normed rows ``[n, H]`` (EAGLE3's
    capture layers reach only its own verify and prefill forwards)."""
    import gc

    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    from rtp_llm_tpu_torch.loader import load_eagle_weights
    from rtp_llm_tpu_torch.ops import quant_gemm
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    cfg, gen, hgen = served.model.cfg, _spec_gen(152), _spec_gen(153)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "spec_heads")
    kernels = {k.name: k for k in (prefill.KERNELS[torch.int8], decode.KERNELS[torch.bfloat16],
                                   quant_gemm.KERNELS["base"])}
    prompts = [_rand_tokens(gen, cfg.vocab_size, n) for n in SPEC_LENS]
    serve_prompts = _spec_prompts(gen, cfg.vocab_size)
    want = None
    for name in ("eagle", "eagle3"):
        t0 = time.time()
        path = _write_eagle_head(os.path.join(root, name), cfg, hgen, name == "eagle3")
        head = load_eagle_weights(path, device="cuda")
        head_gbytes = _tensor_gbytes(head)
        eng = make_engine(served.model, served.weights, gemm="base", kv="int8", defer=True,
                          speculative="eagle", eagle=head)
        graph_fields, graph_bad = _graph_launches(eng, {
            ("eagle", kernels["paged_decode"]): SPEC_K + 1,
            ("verify", kernels["paged_prefill_i8"]): cfg.num_layers})
        streams = _admit_rows(eng, prompts)
        checks, err, bad = _verify_checks(eng, streams, expect_accept=False)
        bad += graph_bad
        kvb = eng._kv_bucket(streams, SPEC_K)
        cl, gw_rows = _checked_linears(), set()
        inner = cl.fn
        cl.fn = lambda x, *a, **kw: (gw_rows.add(x.shape[0]), inner(x, *a, **kw))[1]
        with eng.device_lock, torch.no_grad(), _checked_attention() as ca, cl:
            eng._verify_logits(kvb, SPEC_K)
        rollout, verify = eng._spec_keys(kvb)
        ms = _replay_ms(eng, [rollout, verify])
        eng.abort_all("checked")
        _drain(eng)
        attn_ok = all(c[2] for c, _ in ca.stats) and all(not f[2] for _, f in ca.stats)
        lin_ok = all(c[2] for c, _ in cl.stats) and all(not f[2] for _, f in cl.stats)
        if not (attn_ok and lin_ok and len(ca.stats) == cfg.num_layers
                and len(cl.stats) == 4 * cfg.num_layers):
            bad.append(f"verify kernels against plain: attention {len(ca.stats)} calls ok "
                       f"{attn_ok}, 4-bit linears {len(cl.stats)} calls ok {lin_ok}")
        if want is None:
            want = _serve_greedy(served, serve_prompts)[0]
        read = _spec_serve_counts(eng, kernels)
        got, rate, st = _serve_greedy(eng, serve_prompts)
        launches, plain, captures = read()
        equal, decisive, loose = _decisive_mismatches(served, serve_prompts, want, got, err)
        if decisive:
            bad.append(f"tokens differ from the normal engine's at decisive positions {decisive}")
        if (launches["paged_prefill_i8"] <= 0 or launches["paged_decode"] <= 0
                or launches["gw_gemm"] <= 0 or plain or captures):
            bad.append(f"launches {launches}, plain calls {plain}, captures {captures}")
        spec_launches.update(launches)
        # the hidden states a request asks for: the final-normed rows, as the
        # served engine on the same model object returns them
        hid = [e.generate_with_hidden(serve_prompts[0][:200], GenerateConfig(
            max_new_tokens=4, do_sample=False, ignore_eos=True)) for e in (eng, served)]
        toks = [s.output_token_ids for s, _ in hid]
        same = next((i for i, (a, b) in enumerate(zip(*toks)) if a != b), len(toks[0])) + 1
        shapes = [tuple(h.shape) for _, h in hid]
        hidden_rel = (_rel_l2(hid[0][1][:same].float(), hid[1][1][:same].float())
                      if shapes[0] == shapes[1] else float("inf"))
        if shapes != [(4, cfg.hidden_size)] * 2 or not hidden_rel <= HIDDEN_REL_L2:
            bad.append(f"generate_with_hidden: shapes {shapes}, rows rel L2 {hidden_rel:.3e} "
                       "to the served engine's")
        _line("spec-eagle", model=LLAMA_NAME, weights="int4", kv="int8", kv_writes="deferred",
              head=name, head_gbytes=f"{head_gbytes:.2f}",
              capture_layers=eng.eagle.capture_layers or "none", k=SPEC_K, **checks,
              **graph_fields, hidden_states_shape="x".join(map(str, shapes[0])),
              hidden_states_rel_l2_to_served=f"{hidden_rel:.3e}",
              verify_attention_calls_checked=len(ca.stats),
              verify_attention_max_rel_l2=f"{max(c[1] for c, _ in ca.stats):.3e}",
              verify_gw_calls_checked=len(cl.stats), verify_gw_rows="|".join(map(str, sorted(gw_rows))),
              verify_gw_max_rel_l2=f"{max(c[1] for c, _ in cl.stats):.3e}",
              planted_faults_caught=attn_ok and lin_ok,
              rollout_device_ms_8_rows=_ms_field(ms[rollout]),
              verify_device_ms_8_rows=_ms_field(ms[verify]), kv_blocks=kvb,
              serve_rows_equal=equal, serve_first_mismatch_gaps=loose or "none",
              decode_tok_per_s_per_request=f"{rate:.1f}", **_spec_stats_fields(st),
              **{f"{n}_launches": v for n, v in launches.items()}, plain_calls=plain,
              graph_captures_during_serve=captures, card=card.replace(" ", "_"),
              seconds=f"{time.time() - t0:.1f}", ok=not bad)
        del eng, head
        gc.collect()
        torch.cuda.empty_cache()
        if bad:
            raise SystemExit(f"spec-eagle phase ({name}) failed: " + "; ".join(bad))



def _sdpa_verify(q, k_cache, v_cache, bt, offs, lens, hkv):
    """Library yardstick for a verify window: F.scaled_dot_product_attention
    over each row's gathered KV, causal from its offset."""
    import torch

    b, t = q.shape[:2]
    s = bt.shape[1] * BS
    idx = (bt.long()[:, :, None] * BS + torch.arange(BS, device="cuda")).reshape(b, s)
    kk = k_cache[idx].reshape(b, s, hkv, D).transpose(1, 2).contiguous()
    vv = v_cache[idx].reshape(b, s, hkv, D).transpose(1, 2).contiguous()
    qpos = offs.long()[:, None, None] + torch.arange(t, device="cuda")[None, :, None]
    kpos = torch.arange(s, device="cuda")[None, None, :]
    mask = ((kpos <= qpos) & (kpos < lens.long()[:, None, None]))[:, None]
    return _sdpa_call(q.transpose(1, 2).contiguous(), kk, vv, mask)


def phase_spec_kernels(card):
    """The verify window's kernel shapes. K3 at B = 64, T = SPEC_K + 1, each
    row behind its own context of 100-2000 tokens (``q_offsets`` = the
    context), bf16 pool with Qwen2-7B heads and int8 pool with Llama-3-8B
    heads (its scales NaN wherever no live token lives): held against its
    plain version, timed as a replayed graph beside K1 at the same rows and
    contexts (T = 1), SDPA over the gathered KV and its byte bound. gw_gemm
    at M = 64 x (SPEC_K + 1) = 320 rows (its wgmma tile kernel) at the
    Qwen2-7B and Llama-3-8B gate-up and Llama-3-8B down: against its plain
    version, beside cuBLAS bf16 on dequantized weights and its bound."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm as qg
    from rtp_llm_tpu_torch.ops.attention.decode import paged_decode_attention
    from rtp_llm_tpu_torch.ops.attention.prefill import paged_prefill_attention, paged_prefill_ref

    t, b, gen = SPEC_K + 1, 64, _spec_gen(154)
    ctx = torch.randint(100, 2001, (b,), generator=gen, device="cuda").tolist()
    for kind, hq, hkv in (("bf16", HQ, HKV), ("int8", 32, 8)):
        q, kb, vb, bt, offs, lens = _prefill_inputs(gen, hq, hkv, t, ctx, [c + t for c in ctx],
                                                    BS)
        sm = D ** -0.5
        plain_kw = kern_kw = {}
        k, v = kb, vb
        if kind == "int8":
            k, v, plain_kw, kern_kw = _quantized_pools(kb, vb, hkv, bt, lens)["int8"]
        got = paged_prefill_attention(q, k, v, bt, offs, lens, sm, BS, **kern_kw)
        want = paged_prefill_ref(q, k, v, bt, offs, lens, sm, BS, **plain_kw)
        err, rel, ok = _check(got, want)
        ms = _graph_ms(lambda: paged_prefill_attention(q, k, v, bt, offs, lens, sm, BS,
                                                       **kern_kw), 8)
        plain_ms = _time_ms(lambda: paged_prefill_ref(q, k, v, bt, offs, lens, sm, BS,
                                                      **plain_kw), iters=3, warmup=1)
        k1_ms = _graph_ms(lambda: paged_decode_attention(q[:, -1].contiguous(), k, v, bt, lens,
                                                         sm, BS, **kern_kw), 8)
        kd, vd = _dequant_pair(k, v, plain_kw, hkv)
        lib_ms = _graph_ms(_sdpa_verify(q, kd, vd, bt, offs, lens, hkv), 8)
        tokens = sum(c + t for c in ctx)
        per_token = hkv * D * 2 * k.element_size() + (4 * hkv if kind == "int8" else 0)
        nbytes = tokens * per_token + 2 * q.numel() * 2
        bound, by = _bound_ms(nbytes, _prefill_flops(t, ctx, [c + t for c in ctx], hq))
        name = "paged_prefill" if kind == "bf16" else "paged_prefill_i8"
        _line("spec-shapes", kernel=name, B=b, T=t, Hq=hq, Hkv=hkv, context_tokens=tokens,
              max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", ok=ok, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", k1_same_rows_ms=f"{k1_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
              share_of_bound=f"{bound / ms:.3f}", card=card.replace(" ", "_"))
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version at the verify shape")
    m = 64 * t
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (kk, n) in (("gate_up_proj", GW_SHAPES["gate_up_proj"]),
                          *GW_LLAMA_SHAPES.items()):
        copies = max(1, -(-120_000_000 // (kk * n // 2)))
        packed, scale = _gw_weights(kk, n, GW_GROUP, gen, copies)
        x = torch.randn((m, kk), generator=gen, device="cuda", dtype=torch.bfloat16)
        got = qg.groupwise_matmul_packed(x, packed[0], scale[0], code="s4")
        err, rel, ok = _check_gemm(got, qg.groupwise_matmul_ref(x, packed[0], scale[0], "s4"))
        ms = _graph_ms(_cycling(lambda i: qg.groupwise_matmul_packed(
            x, packed, scale[i], layer=i), copies), 2 * copies)
        plain_ms = _time_ms(_cycling(lambda i: qg.groupwise_matmul_ref(
            x, packed[i], scale[i], "s4"), copies), iters=3, warmup=1)
        wd = torch.stack([qg.dequantize(packed[i], scale[i]).to(torch.bfloat16)
                          for i in range(copies)])
        lib_ms = _graph_ms(_cycling(lambda i: torch.matmul(x, wd[i]), copies), 2 * copies)
        del wd
        bound, by = _gw_bound(m, kk, n, GW_GROUP)
        _line("spec-shapes", kernel="gw_gemm", linear=name, M=m, K=kk, N=n,
              tile=qg.plan(m, kk, n, sms, "base"), max_abs_err=f"{err:.3e}",
              max_rel_l2=f"{rel:.3e}", ok=ok, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
              share_of_bound=f"{bound / ms:.3f}", card=card.replace(" ", "_"))
        if not ok:
            raise SystemExit(f"gw_gemm disagrees with its plain version at M = {m}")


# ---------------------------------------------------------------- beam search and LoRA

# X4 (lora_bgmv) at the fused linears of Qwen2-7B with adapters on all seven
# targets: (in, the members' out widths); the shrink's A joins the members
# along r (fuse_lora), the expand writes each member's columns
LORA_SHAPES = {"qkv_proj": (3584, (3584, 512, 512)), "o_proj": (3584, (3584,)),
               "gate_up_proj": (3584, (18944, 18944)), "down_proj": (18944, (3584,))}
# a decode window's 64 slots, a verify window (T = K + 1 = 5 over 64
# slots), a 2048-row prefill
LORA_NS = (64, 320, 2048)
# the ids: over {0, X, Y}, every row id 0, one adapter on every row, over
# {0, 1, .., 8}; (adapters in the stacks, ids drawn from)
LORA_MIXES = {"mixed": (2, (0, 3)), "all_id_0": (2, (0, 1)), "one_adapter": (2, (1, 2)),
              "eight_adapters": (8, (0, 9))}
LORA_RANK, LORA_ALPHA = 16, 32
LORA_WIDE_RANK = 64  # checked beside the served rank: q | k | v join to R = 192
# X4's t and delta against the plain version: within one bf16 ulp of the
# plain value, the ulp taken of the larger of |plain| and LORA_ULP_FLOOR x
# the plain values' rms. The f32 sums differ by their order alone, far
# below a bf16 ulp of the rms; a sum that cancels to near 0 has no bf16 ulp
# of its own. Values the plain version holds at exactly 0 with an rms
# of 0 (all rows id 0) must be exactly 0.
LORA_ULP_FLOOR = 2.0 ** -10
# [lora]: each served row's logprobs against a teacher-forced plain forward
# (plain attention, plain LoRA) under its adapter: within LORA_TOL_FACTOR x
# the largest error of the rows served without an adapter, and at least
# LORA_TOL_FLOOR; the served token at most that far from the teacher's best
LORA_TOL_FACTOR, LORA_TOL_FLOOR = 2.0, 0.05
# adapter weights: A ~ N(0, 0.02) as the base weights, B ~ N(0, 0.05): the
# delta is about 40% of a linear's output on random weights
LORA_SIGMA_A, LORA_SIGMA_B = 0.02, 0.05
LORA_DIR = os.path.join("build", "lora")
LORA_LAYERS_CUT = 4
# [beam]: a num_beams request of a 1000-token prompt beside 7 greedy streams
BEAM_K, BEAM_PROMPT, BEAM_OUT = 4, 1000, 32
BEAM_GREEDY_LENS = (100, 300, 600, 900, 1200, 1500, 1800)
# |cum_logprob - the teacher-forced sum of its tokens| of every hypothesis:
# at most the summed per-token |served - teacher-forced| logprob error of an
# unforked width-1 run (a greedy request of the same prompt; x
# BEAM_TOL_FACTOR), and at least BEAM_TOL_FLOOR. The signed sum of that
# run's errors is no bound: on an H100 80GB HBM3 (700 W) it came to 0.032
# while a beam's hypothesis was 0.185 off (its absolute sum 1.158, Qwen2-7B;
# 1.690 against 0.285, Llama-3-8B int4); a tail copy left out moved one by
# 164, its scales left out by 183
BEAM_TOL_FACTOR, BEAM_TOL_FLOOR = 1.0, 0.05


# X4's planted faults: (the entry it replaces, its -DLORA_BGMV_FAULT value)
LORA_FAULTS = {"row_in_the_neighbouring_segment": ("segments", 1),
               "tile_last_row_dropped": ("segments", 2),
               "split_partial_left_out": ("shrink", 3)}


@functools.lru_cache(maxsize=None)
def _lora_fault_kernels():
    """X4's entries built with their planted faults, by fault name."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import lora

    out = {}
    for name, (key, value) in LORA_FAULTS.items():
        base = lora.KERNELS[key]
        out[name] = _kernels.Kernel(f"{base.name}:{name}", "lora_bgmv.cu", base.entry,
                                    base.argtypes, defines=(f"LORA_BGMV_FAULT={value}",))
    return out


def _lora_operands(gen, n, k, widths, r, mix="mixed", layers=2):
    """Stacks of the mix's adapters (id 0 zeros): A joined over the members
    (``[.., k, len(widths) r]``), each member's B, and x, y and the mix's
    ids."""
    import torch

    adapters, (lo, hi) = LORA_MIXES[mix]

    def normal(shape, sigma):
        t = torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
            0.0, sigma, generator=gen)
        t[0] = 0
        return t
    a = normal((adapters + 1, layers, k, len(widths) * r), LORA_SIGMA_A)
    members = [(normal((adapters + 1, layers, r, o), LORA_SIGMA_B), o) for o in widths]
    x = torch.empty((n, k), dtype=torch.bfloat16, device="cuda").normal_(0.0, 1.0, generator=gen)
    y = torch.empty((n, sum(widths)), dtype=torch.bfloat16, device="cuda").normal_(
        0.0, 1.0, generator=gen)
    ids = torch.randint(lo, hi, (n,), generator=gen, device="cuda", dtype=torch.int32)
    return a, members, x, y, ids


def _lora_bound(k, widths, r, ids):
    """(shrink, expand) bounds from this run's data: for the N' rows with an
    adapter only (the function leaves the others alone), x, t and y moved
    once and each distinct adapter's member slices read once (A ``[k, r]``
    and B ``[r, o_j]`` a member); 2 N' k R / 2 N' r out operations, R the
    members' ranks joined."""
    live = int((ids > 0).sum())
    distinct = len(set(ids[ids > 0].tolist()))
    rr, out = len(widths) * r, sum(widths)
    shrink = _bound_ms(live * k * 2 + live * rr * 4 + distinct * k * rr * 2, 2 * live * k * rr)
    expand = _bound_ms(live * rr * 4 + live * out * 2 * 2 + distinct * r * out * 2,
                       2 * live * r * out)
    return shrink, expand


def _lora_segments_bound(n, n_ids):
    """The segment pass reads the ids and writes perm, the offsets, the
    tile table and the zeroed counters once."""
    from rtp_llm_tpu_torch.ops import lora

    m = lora.max_tiles(n, n_ids)
    return _bound_ms(4 * (2 * n + n_ids + 1 + 4 * m + lora.MAX_RCHUNKS * m), 0)


def _lora_library(x, a, members, t, y):
    """cuBLAS for one adapter (id 1) over all rows: ``x @ A``, and each
    member's ``t_j @ B_j`` added to its columns of y."""
    import torch

    a1, tb = a[1, 1], t.to(torch.bfloat16)
    parts, col, seg = [], 0, 0
    for b, o in members:
        r = b.shape[2]
        parts.append((y[:, col: col + o], tb[:, seg: seg + r], b[1, 1]))
        col, seg = col + o, seg + r

    def expand():
        for yj, tj, bj in parts:
            yj.add_(tj @ bj)
    return (lambda: x @ a1), expand


def _bf16_ulp(v):
    """One bf16 ulp of each value of ``v`` (see LORA_ULP_FLOOR)."""
    import torch

    w = v.float()
    rms = float(w.pow(2).mean().sqrt()) if w.numel() else 0.0
    mag = torch.clamp_min(w.abs(), LORA_ULP_FLOOR * rms).clamp_min(1e-38)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _beyond_ulp(got, want, also=None):
    """Elements of ``got`` more than one bf16 ulp from the plain ``want``
    (and one of ``also`` beside it: y = y0 + delta moves by the delta's
    ulp), or not finite."""
    import torch

    tol = _bf16_ulp(want) + (0 if also is None else _bf16_ulp(also))
    g = got.float()
    return int(((g - want.float()).abs() > tol).sum()) + int((~torch.isfinite(g)).sum())


def _lora_segments_equal(seg, ids, n_ids):
    """The kernel's record equals the plain pass's on the same ids (perm,
    offsets, every tile entry, zero counters)."""
    import torch

    from rtp_llm_tpu_torch.ops import lora

    ref = lora.lora_segments_ref(ids.cpu(), n_ids)
    return all(torch.equal(getattr(seg, f).cpu(), getattr(ref, f))
               for f in ("perm", "offsets", "tiles", "counters"))


def _lora_replays_equal(x, a, members, ids, y0):
    """One graph of the segment pass, the shrink and the expand, replayed
    twice: t and y must come back the same bits."""
    import torch

    from rtp_llm_tpu_torch.ops import lora

    y, out = y0.clone(), {}

    def run():
        seg = lora.lora_segments(ids, a.shape[0])
        y.copy_(y0)
        out["t"] = lora.lora_shrink(x, a, ids, 1, seg)
        lora.lora_expand(out["t"], members, ids, 1, y, seg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    t1, y1 = out["t"].clone(), y.clone()
    graph.replay()
    torch.cuda.synchronize()
    return (torch.equal(t1.view(torch.int32), out["t"].view(torch.int32))
            and torch.equal(y1.view(torch.int16), y.view(torch.int16)))


def phase_lora_kernels(gen):
    """X4 against its plain version at the Qwen2-7B fused linears, N 64 /
    320 / 2048, in every id mix (``LORA_MIXES``), layer 1 of a 2-layer
    stack, at the served rank 16 and at rank 64 (q | k | v joined to 192
    ranks): the segment record equal to the plain pass's; t and the delta
    alone (y = 0) within one bf16 ulp of the plain version
    (``_beyond_ulp``) and within the kernels' usual tolerance (``_check``);
    y on a random y equal to y + the kernel's own delta rounded once, within
    a bf16 ulp of the plain y plus one of the plain delta, its id-0 rows
    bit for bit; two replays of one graph of the three launches bit-equal. Each planted fault
    (``LORA_FAULTS``) must fail the delta's check. Times at rank 16, in
    every mix: segment pass, shrink and expand (replayed graphs); in the
    mixed one also plain, cuBLAS for one adapter over all rows (the floor
    of any mixed-adapter kernel) and the bound from this run's ids.
    Returns the kernels-line records: the segment pass at N 64, shrink and
    expand summed over the four linears at N 64 and rank 16 (a decode
    layer's LoRA)."""
    import torch

    from rtp_llm_tpu_torch.ops import lora

    t0 = time.time()
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    sums = {(key, n): dict(max_abs_err=0.0, bound_by="bytes", **{k: 0.0 for k in keys})
            for key in ("shrink", "expand") for n in LORA_NS}
    seg_rec = None
    good = True
    faults = []
    # the shared generator gives only the operands PR 17's phase drew from it
    # (mixed ids at N 64 and 2048), in its order, so that every later phase
    # keeps its data ([controls]' trie check depends on its random prompts)
    own = torch.Generator(device="cuda")
    own.manual_seed(18)
    for r in (LORA_RANK, LORA_WIDE_RANK):
        timed = r == LORA_RANK
        for n in LORA_NS:
            for mix in LORA_MIXES:
                for name, (k, widths) in LORA_SHAPES.items():
                    g = gen if mix == "mixed" and n in (64, 2048) else own
                    a, members, x, y0, ids = _lora_operands(g, n, k, widths, r, mix)
                    n_ids = a.shape[0]
                    seg = lora.lora_segments(ids, n_ids)
                    seg_ok = _lora_segments_equal(seg, ids, n_ids)
                    t = lora.lora_shrink(x, a, ids, 1, seg)
                    t_ref = lora.lora_shrink_ref(x, a, ids, 1)
                    err_t, rel_t, ok_t = _check(t, t_ref)
                    ulp_t = _beyond_ulp(t, t_ref)
                    zero = torch.zeros_like(y0)
                    d = lora.lora_expand(t_ref, members, ids, 1, zero.clone(), seg)
                    d_ref = lora.lora_expand_ref(t_ref, members, ids, 1, zero.clone())
                    err_d, rel_d, ok_d = _check(d, d_ref)
                    ulp_d = _beyond_ulp(d, d_ref)
                    # y on a random y: the kernel's own delta added once and
                    # rounded (bit for bit), within a bf16 ulp of y and of the
                    # delta of the plain version, id-0 rows untouched
                    y = lora.lora_expand(t_ref, members, ids, 1, y0.clone(), seg)
                    y_ref = lora.lora_expand_ref(t_ref, members, ids, 1, y0.clone())
                    _, rel_y, _ = _check(y, y_ref)
                    y_exact = bool(torch.equal(y, (y0.float() + d.float()).to(torch.bfloat16)))
                    ulp_y = _beyond_ulp(y, y_ref, also=d_ref)
                    base_rows = bool(torch.equal(y[ids == 0], y0[ids == 0]))
                    replays = (_lora_replays_equal(x, a, members, ids, y0)
                               if name == "qkv_proj" else True)
                    ok = (seg_ok and ok_t and ok_d and y_exact and base_rows and replays
                          and ulp_t == 0 and ulp_d == 0 and ulp_y == 0)
                    good = good and ok
                    line = dict(linear=name, n=n, mix=mix, k=k, out=sum(widths), r=r,
                                joined_r=a.shape[-1],
                                plan=":".join(map(str, lora.shrink_plan(n, k, a.shape[-1]))),
                                ok=ok,
                                segments_equal=seg_ok, id0_rows_unchanged=base_rows,
                                replays_bit_equal=replays, shrink_beyond_1ulp=ulp_t,
                                delta_beyond_1ulp=ulp_d, y_is_y0_plus_delta=y_exact,
                                y_beyond_1ulp=ulp_y, shrink_err=f"{err_t:.3e}",
                                shrink_rel_l2=f"{rel_t:.3e}", delta_err=f"{err_d:.3e}",
                                delta_rel_l2=f"{rel_d:.3e}", y_rel_l2=f"{rel_y:.3e}")
                    if mix == "mixed" and name == "qkv_proj" and n in (64, 2048) and timed:
                        for fault, (key, _) in LORA_FAULTS.items():
                            with _lora_swapped(key, _lora_fault_kernels()[fault]):
                                got = lora.lora_delta(x, zero.clone(), a, members, ids, 1)
                            want = lora.lora_expand_ref(t_ref, members, ids, 1, zero.clone())
                            faults.append((f"{fault}_{name}_{n}", got, want))
                    if not timed:
                        _line("lora-kernel", **line)
                        continue
                    ms_s = _graph_ms(lambda: lora.lora_shrink(x, a, ids, 1, seg), calls=20)
                    yy = y0.clone()
                    ms_e = _graph_ms(lambda: lora.lora_expand(t, members, ids, 1, yy, seg),
                                     calls=20)
                    timing = dict(shrink_ms=f"{ms_s:.4f}", expand_ms=f"{ms_e:.4f}")
                    if name == "qkv_proj":
                        ms_g = _graph_ms(lambda: lora.lora_segments(ids, n_ids), calls=20)
                        plain_g = _time_ms(lambda: lora.lora_segments_ref(ids, n_ids), iters=3,
                                           warmup=1)
                        argsort_g = _graph_ms(lambda: torch.argsort(ids, stable=True), calls=20)
                        bound_g = _lora_segments_bound(n, n_ids)
                        _line("lora-segments", n=n, mix=mix, n_ids=n_ids,
                              live_tiles=int((seg.tiles[:, 2] > 0).sum()),
                              max_tiles=seg.tiles.shape[0], ok=seg_ok, ms=f"{ms_g:.4f}",
                              plain_ms=f"{plain_g:.4f}", argsort_ms=f"{argsort_g:.4f}",
                              bound_ms=f"{bound_g[0]:.3e}")
                        if n == 64 and mix == "mixed":
                            seg_rec = dict(max_abs_err=0.0 if seg_ok else float("inf"),
                                           ms=round(ms_g, 4), plain_ms=round(plain_g, 4),
                                           bound_ms=bound_g[0], bound_by="bytes",
                                           library_ms=None)
                    if mix != "mixed":
                        _line("lora-kernel", **line, live_rows=int((ids > 0).sum()), **timing)
                        continue
                    plain_s = _time_ms(lambda: lora.lora_shrink_ref(x, a, ids, 1), iters=5,
                                       warmup=1)
                    plain_e = _time_ms(lambda: lora.lora_expand_ref(t, members, ids, 1, yy),
                                       iters=5, warmup=1)
                    lib_shrink, lib_expand = _lora_library(x, a, members, t, yy)
                    lib_s = _graph_ms(lib_shrink, calls=20)
                    lib_e = _graph_ms(lib_expand, calls=20)
                    (bs, bys), (be, bye) = _lora_bound(k, widths, r, ids)
                    _line("lora-kernel", **line, live_rows=int((ids > 0).sum()), **timing,
                          shrink_plain_ms=f"{plain_s:.4f}",
                          shrink_cublas_one_adapter_ms=f"{lib_s:.4f}", shrink_bound_ms=f"{bs:.4f}",
                          shrink_bound_by=bys, expand_plain_ms=f"{plain_e:.4f}",
                          expand_cublas_one_adapter_ms=f"{lib_e:.4f}",
                          expand_bound_ms=f"{be:.4f}", expand_bound_by=bye)
                    for key, vals in (("shrink", (err_t, ms_s, plain_s, bs, lib_s)),
                                      ("expand", (err_d, ms_e, plain_e, be, lib_e))):
                        r_ = sums[(key, n)]
                        r_["max_abs_err"] = max(r_["max_abs_err"], vals[0])
                        for i, name_ in enumerate(keys):
                            r_[name_] += vals[1 + i]
    _planted("lora-kernel", faults)
    for r_ in sums.values():
        for key in keys:
            r_[key] = round(r_[key], 4)
    _line("lora-kernels", ok=good, seconds=f"{time.time() - t0:.1f}",
          **{f"{key}_n{n}_{what}": sums[(key, n)][what] for key in ("shrink", "expand")
             for n in LORA_NS for what in keys})
    if not good or seg_rec is None:
        raise SystemExit("lora-kernel: X4 disagrees with its plain version")
    return {"segments": seg_rec, "shrink": sums[("shrink", 64)],
            "expand": sums[("expand", 64)]}


@contextlib.contextmanager
def _lora_swapped(key, kernel):
    from rtp_llm_tpu_torch.ops import lora

    saved = lora.KERNELS[key]
    lora.KERNELS[key] = kernel
    try:
        yield
    finally:
        lora.KERNELS[key] = saved


def _step_until_admitted(engine):
    """Step until every queued stream is prefilled and in a decode slot."""
    while engine.scheduler.waiting or engine._prefill_pending:
        engine.step()


def _fill_free_blocks(engine, value):
    """Fill every block on the pool's free list (data, and an int8 pool's
    scales) with ``value``: NaN makes a read of a row no one wrote poison
    what reads it."""
    import torch

    _drop_prefix_cache(engine)
    free = engine.cache_mgr.pool._free
    if not free:
        return
    bs = engine.block_size
    rows = (torch.tensor(free)[:, None] * bs + torch.arange(bs)).reshape(-1).cuda()
    kv = engine.kv
    if isinstance(kv, dict):  # int8 codes cannot hold NaN: their scales do
        kv["data"].index_fill_(2, rows, 0)
        kv["scale"].index_fill_(2, rows, value)
    else:
        kv.index_fill_(2, rows, value)
    torch.cuda.synchronize()


def _teacher_logprobs(engine, prompt, tokens, adapter_id=0, top=False):
    """log p(token) of each of ``tokens`` after ``prompt`` (a host list):
    one plain forward over prompt + tokens (under ``adapter_id``),
    log_softmax in f32; with ``top`` also each position's largest."""
    import torch

    logits, _ = _plain_all(engine, prompt + tokens, adapter_id, need_all_logits=True)
    p = len(prompt)
    lp = torch.log_softmax(logits.float()[p - 1: p - 1 + len(tokens)], dim=-1)
    got = lp.gather(1, torch.tensor(tokens, device="cuda")[:, None])[:, 0].tolist()
    return (got, lp.max(dim=-1).values.tolist()) if top else got


def _copy_nothing(engine):
    return lambda src, dst: None


def _copy_data_only(engine):
    """``copy_blocks`` that copies an int8 pool's codes and leaves its scales."""
    import torch

    def copy(src, dst):
        if not src:
            return
        bs = engine.block_size
        offs = torch.arange(bs)
        s = (torch.tensor(src)[:, None] * bs + offs).reshape(-1).cuda()
        d = (torch.tensor(dst)[:, None] * bs + offs).reshape(-1).cuda()
        data = engine.kv["data"]
        data.index_copy_(2, d, data.index_select(2, s))
    return copy


@_stage("phase_beam")
def phase_beam(engine, card, tag, fault):
    """``[beam]`` on a served engine: a ``num_beams`` 4 request of a
    1000-token prompt, 32 out, ignore_eos, enqueued once 7 greedy streams of
    100-1800 tokens sit in decode slots. Every free block holds NaN (int8:
    NaN scales) before the beam runs, so a tail no one copied poisons its
    beam. Checks: each final hypothesis's cum_logprob equals the
    teacher-forced sum of its tokens (one plain forward) within the
    tolerance an unforked width-1 run gives; the greedy streams' tokens equal
    the same engine's without the beam group, bit for bit; free blocks after
    = before; K1 and K3 launched, no plain call, no capture. Planted fault
    (``fault``: (name, copy_blocks factory)) must fail the recompute check.
    Records: beam step ms at k = 4 (host wall: forward, readback, selection),
    beam tokens/s, and the greedy streams' window device ms and step wall ms
    with and without the live group."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig
    from rtp_llm_tpu_torch.ops import lora, quant_gemm, quant_gemm8
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS

    t0 = time.time()
    cfg = engine.model.cfg
    gen = _spec_gen(17)
    greedy = [_rand_tokens(gen, cfg.vocab_size, n) for n in BEAM_GREEDY_LENS]
    prompt = _rand_tokens(gen, cfg.vocab_size, BEAM_PROMPT)
    gcfg = dict(max_new_tokens=BEAM_OUT, do_sample=False, ignore_eos=True)
    mine, _ = _attention_kernels(engine.config.quant.kv_cache_dtype)

    def plain_calls():
        return (PLAIN_CALLS.n + quant_gemm.PLAIN_CALLS.n + quant_gemm8.PLAIN_CALLS.n
                + lora.PLAIN_CALLS.n)

    def serve(with_beam, copy=None):
        """(greedy outputs, beam stream, (window ms, step wall ms) of the
        greedy windows while the group lived or, without a beam, while the
        same streams decoded, beam wall seconds)."""
        _fill_free_blocks(engine, float("nan") if with_beam else 0.0)
        streams = [engine.enqueue(p, GenerateConfig(**gcfg)) for p in greedy]
        _step_until_admitted(engine)
        beam, wall, steps = None, 0.0, 0
        if copy is not None:
            engine.copy_blocks = copy
        try:
            with _timed_replays(engine) as tr:
                tr.take()
                t1 = time.perf_counter()
                if with_beam:
                    beam = engine.enqueue(prompt, GenerateConfig(**gcfg, num_beams=BEAM_K))
                while (beam is not None and not beam.is_finished()) or (
                        beam is None and steps < BEAM_OUT):
                    engine.step()
                    steps += 1
                wall = time.perf_counter() - t1
                dev_ms, windows = tr.take()
            while not all(s.is_finished() for s in streams):
                engine.step()
            _drain(engine)
        finally:
            if copy is not None:
                del engine.copy_blocks
        torch.cuda.synchronize()
        return ([s.output_token_ids for s in streams], beam,
                (dev_ms / max(windows, 1), wall * 1e3 / max(steps, 1)), wall)

    _fill_free_blocks(engine, 0.0)
    free0 = engine.cache_mgr.pool.free_blocks
    alone, _, (win_alone, wall_alone), _ = serve(False)
    for k in mine.values():
        k.launches.n = 0
    plain0, captures0 = plain_calls(), engine._graphs.captures
    st0 = dict(engine.beam_stats)
    together, beam, (win_beam, wall_beam), beam_s = serve(True)
    launches = {n: k.launches.n for n, k in mine.items()}
    plain, captures = plain_calls() - plain0, engine._graphs.captures - captures0
    steps = engine.beam_stats["steps"] - st0["steps"]
    step_ms = (engine.beam_stats["seconds"] - st0["seconds"]) * 1e3 / max(steps, 1)
    _fill_free_blocks(engine, 0.0)  # the plain recompute reads whole blocks
    free1 = engine.cache_mgr.pool.free_blocks
    # the unforked width-1 run: greedy, its served logprobs summed
    ref = engine.enqueue(prompt, GenerateConfig(**gcfg, return_logprobs=True))
    while not ref.is_finished():
        engine.step()
    _drain(engine)
    want1 = _teacher_logprobs(engine, prompt, ref.output_token_ids)
    err1 = sum(abs(a - b) for a, b in zip(ref.output_logprobs, want1))
    tol = max(BEAM_TOL_FACTOR * err1, BEAM_TOL_FLOOR)
    errs = [abs(c - sum(_teacher_logprobs(engine, prompt, toks)))
            for toks, c in beam.beam_hypotheses]
    # the planted fault: the beam again with the broken copy
    _, bad_beam, _, _ = serve(True, copy=fault[1](engine))
    _fill_free_blocks(engine, 0.0)
    bad_errs = [abs(c - sum(_teacher_logprobs(engine, prompt, toks))) if c == c
                else float("inf") for toks, c in bad_beam.beam_hypotheses]
    caught = not max(bad_errs) <= tol
    ok = (together == alone and max(errs) <= tol and free1 == free0
          and len(beam.output_token_ids) == BEAM_OUT and all(launches.values())
          and plain == 0 and captures == 0 and caught)
    _line("beam", engine=tag, ok=ok, k=BEAM_K, prompt=BEAM_PROMPT, out=BEAM_OUT,
          hypotheses=len(beam.beam_hypotheses),
          cum_logprob_errs="/".join(f"{e:.4f}" for e in errs), tolerance=f"{tol:.4f}",
          width1_abs_err_sum=f"{err1:.4f}", greedy_bit_equal=together == alone,
          free_blocks_before=free0, after=free1, launches=launches, plain_calls=plain,
          captures=captures, beam_steps=steps, beam_step_ms=f"{step_ms:.2f}",
          beam_tokens_per_s=f"{BEAM_OUT / beam_s:.1f}",
          greedy_window_device_ms_alone=f"{win_alone:.3f}",
          greedy_window_device_ms_with_beam=f"{win_beam:.3f}",
          greedy_step_wall_ms_alone=f"{wall_alone:.2f}",
          greedy_step_wall_ms_with_beam=f"{wall_beam:.2f}", card=card.replace(" ", "_"))
    _line("beam", engine=tag, fault=fault[0], max_cum_logprob_err=f"{max(bad_errs):.4f}",
          caught=caught)
    _line("beam", engine=tag, seconds=f"{time.time() - t0:.1f}")
    if not ok:
        raise SystemExit(f"beam: a check failed on {tag}")


def _lora_dims(cfg):
    h, f, q, kv = (cfg.hidden_size, cfg.intermediate_size,
                   cfg.num_attention_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim)
    return {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv), "o_proj": (q, h),
            "gate_proj": (h, f), "up_proj": (h, f), "down_proj": (f, h)}


def _write_adapter(path, cfg, layers, seed):
    """A PEFT adapter directory at ``cfg``'s widths (rank 16, alpha 32, all
    seven targets) for ``layers`` layers, A and B drawn from ``seed`` layer
    by layer: a cut of fewer layers holds the same first layers."""
    import torch

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA,
                   "target_modules": list(_lora_dims(cfg))}, f)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tensors = {}
    for layer in range(layers):
        for t, (i, o) in _lora_dims(cfg).items():
            mod = "self_attn" if t in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
            base = f"base_model.model.model.layers.{layer}.{mod}.{t}"
            for ab, shape, sigma in (("A", (LORA_RANK, i), LORA_SIGMA_A),
                                     ("B", (o, LORA_RANK), LORA_SIGMA_B)):
                tensors[f"{base}.lora_{ab}.weight"] = torch.empty(
                    shape, dtype=torch.bfloat16, device="cuda").normal_(0.0, sigma, generator=gen)
    _save_safetensors(os.path.join(path, "adapter_model.safetensors"), tensors)
    return path


def _unfused(cfg, w):
    """The canonical per-linear weights of a fused dict (the loader's layout,
    which the static merge takes)."""
    hq, hkv = cfg.num_attention_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out = {n: t for n, t in w.items() if n not in ("qkv_proj", "qkv_bias", "gate_up_proj")}
    out["q_proj"], out["k_proj"], out["v_proj"] = w["qkv_proj"].split((hq, hkv, hkv), dim=-1)
    if "qkv_bias" in w:
        out["q_bias"], out["k_bias"], out["v_bias"] = w["qkv_bias"].split((hq, hkv, hkv), dim=-1)
    out["gate_proj"], out["up_proj"] = w["gate_up_proj"].chunk(2, dim=-1)
    return {n: t.contiguous() for n, t in out.items()}


def _serve_rows(engine, rows, steps, logprobs=False, admitted=None):
    """Serve (prompt, adapter name) rows together at ``steps`` decode steps a
    window (graphed, async), from an empty prefix cache: (outputs, device ms
    a window), and with ``logprobs`` each row's served logprobs.
    ``admitted(streams)`` runs once every row sits in a decode slot."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    _set_decode(engine, "graph", steps, True)
    _drop_prefix_cache(engine)
    with _timed_replays(engine) as tr:
        streams = [engine.enqueue(p, GenerateConfig(max_new_tokens=24, do_sample=False,
                                                    ignore_eos=True, adapter_name=a,
                                                    return_logprobs=logprobs))
                   for p, a in rows]
        _step_until_admitted(engine)
        if admitted is not None:
            admitted(streams)
        tr.take()
        while not all(s.is_finished() for s in streams):
            engine.step()
        ms, positions = tr.take()
    _drain(engine)
    _set_decode(engine, "graph", 1, True)
    torch.cuda.synchronize()
    errors = [s.error for s in streams if s.error]
    if errors:
        raise SystemExit(f"lora: a request failed: {errors[0]}")
    out = [s.output_token_ids for s in streams], ms * steps / max(positions, 1)
    return out + ([s.output_logprobs for s in streams],) if logprobs else out


@contextlib.contextmanager
def _plain_lora():
    """The model's LoRA delta through X4's plain version (the gather and
    einsums), as the teacher-forced forwards of ``[lora]`` take it."""
    from rtp_llm_tpu_torch.models import llama_family
    from rtp_llm_tpu_torch.ops import lora

    saved = llama_family.lora_delta
    llama_family.lora_delta = lambda x, y, a, members, ids, layer, seg=None: (
        lora.lora_expand_ref(lora.lora_shrink_ref(x, a, ids, layer), members, ids, layer, y))
    try:
        yield
    finally:
        llama_family.lora_delta = saved


def _lora_verify(engine, tol):
    """X4 in the verify window: a prompt-lookup engine on the [lora]
    engine's model, weights and adapter stacks (shared, no copy). Every
    verify graph must launch the segment pass once and the shrink and the
    expand once a linear (what its capture recorded); rows whose prompts
    repeat a segment (prompt lookup drafts at every step) under X, Y and no
    adapter must run verify windows (greedy, no logprobs: the speculative
    gate), and every served token must lie within ``tol`` (the [lora]
    rule's) of the best of a teacher-forced plain forward under its row's
    adapter; a planted swap of the X and Y rows' slots must fail that.
    Returns the record (``ok``)."""
    import gc

    import torch

    from rtp_llm_tpu_torch.ops import lora

    t0 = time.time()
    cfg = engine.model.cfg
    spec = make_engine(engine.model, dict(engine.weights), speculative="prompt_lookup")
    spec.lora_manager, spec._lora = engine.lora_manager, dict(engine._lora)
    per_linear = 4 * cfg.num_layers
    fields, bad = _graph_launches(spec, {("verify", lora.KERNELS["segments"]): 1,
                                         ("verify", lora.KERNELS["shrink"]): per_linear,
                                         ("verify", lora.KERNELS["expand"]): per_linear})
    rows = list(zip(_spec_prompts(_spec_gen(24), cfg.vocab_size, rows=4), (None, "X", "Y", "X")))
    def gaps_of(toks):
        out = []
        with _plain_lora():
            for (prompt, name), t in zip(rows, toks):
                want, top = _teacher_logprobs(spec, prompt, t,
                                              spec._lora[name][0] if name else 0, top=True)
                out.append(max(m - w for m, w in zip(top, want)))
        return out

    def swap_x_and_y(streams):
        """Planted: the X and Y rows' slots read each other's adapter."""
        st = spec.state
        i, j = streams[1].slot, streams[2].slot
        st.adapter_ids[i], st.adapter_ids[j] = st.adapter_ids[j].clone(), st.adapter_ids[i].clone()
    steps0 = spec.spec_stats["steps"]
    gaps = gaps_of(_serve_rows(spec, rows, 1)[0])
    verify_steps = spec.spec_stats["steps"] - steps0
    fault = max(gaps_of(_serve_rows(spec, rows, 1, admitted=swap_x_and_y)[0]))
    if verify_steps == 0 or max(gaps) > tol or fault <= tol:
        bad.append(f"verify steps {verify_steps}, served tokens {max(gaps):.4f} from the "
                   f"teacher's best against {tol:.4f}, the slot swap {fault:.4f}")
    del spec
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(ok=not bad, verify_steps=verify_steps,
               teacher_gap_max="/".join(f"{g:.4f}" for g in gaps), tolerance=f"{tol:.4f}",
               fault_slots_swap_x_and_y=f"{fault:.4f}", fault_caught=fault > tol,
               **fields, seconds=f"{time.time() - t0:.1f}")
    _line("lora-verify", **rec, problems="; ".join(bad) or "none")
    return rec


def _lora_teacher_errors(engine, rows, served):
    """Each row's (max |served - teacher| logprob, max teacher top - teacher
    logprob of the served token) over its tokens, the teacher a plain forward
    (plain attention, plain LoRA) of prompt + served tokens under the row's
    adapter."""
    toks, _, lps = served
    out = []
    with _plain_lora():
        for (prompt, name), t, lp in zip(rows, toks, lps):
            aid = engine._lora[name][0] if name else 0
            want, top = _teacher_logprobs(engine, prompt, t, aid, top=True)
            out.append((max(abs(a - b) for a, b in zip(lp, want)),
                        max(m - w for m, w in zip(top, want))))
    return out


@_stage("phase_lora")
def phase_lora(engine, weights, card):
    """``[lora]`` on the served full-width Qwen2-7B bf16 engine. Two
    adapters X and Y (rank 16, alpha 32, all seven targets, A ~ N(0, 0.02),
    B ~ N(0, 0.05), written as PEFT directories under ``build/lora/``) are
    added through ``POST /v1/loras``: the refresh captures every graph
    again; base-only rows served after it are bit-equal to those before (and
    their window times are recorded: X4's launches return at once on rows of
    id 0). 8 rows mixing X, Y and no adapter (one prompt under X, Y and none)
    at ``decode_steps`` 1 and 4: base rows bit-equal to the engine's before
    the adapters, the X row differs from the same prompt's base and Y rows;
    each row's served logprobs, and its tokens' distance from the best,
    against a teacher-forced plain forward (plain attention, plain LoRA)
    under its adapter within LORA_TOL_FACTOR x the base rows' own error
    (planted: the X and Y rows' decode slots swap adapters after the
    prefill, which the check must catch);
    X4 launched (the segment pass once a forward, shrink and expand once a
    linear: 1 + 112 + 112 launches a decode step and a prefill forward), no
    plain call, no capture while serving. ``DELETE`` Y, then
    a Y request answers 400 and an X request 200. On a 4-layer cut (a second
    full-width engine would not fit beside the ones this run holds), the
    prompt loss under X served dynamically against an engine with X merged
    at load: relative L2 about the mean within CONTROL_REL_L2; the base
    model's loss must fail that check. Records the window device ms at 8
    rows with and without adapters."""
    import dataclasses
    import shutil

    import torch

    from rtp_llm_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from rtp_llm_tpu_torch.engine import LlmEngine
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.lora import LoraManager
    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops import lora, quant_gemm, quant_gemm8
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS
    from rtp_llm_tpu_torch.server.server import merge_static_adapters

    t0 = time.time()
    cfg = engine.model.cfg
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    paths = {name: _write_adapter(os.path.join(LORA_DIR, name.lower()), cfg, cfg.num_layers, seed)
             for name, seed in (("X", 31), ("Y", 32))}
    cut_path = _write_adapter(os.path.join(LORA_DIR, "x_cut"), cfg, LORA_LAYERS_CUT, 31)
    t_write = time.time() - t0
    gen = _spec_gen(23)
    prompts = [_rand_tokens(gen, cfg.vocab_size, n) for n in (100, 300, 500, 700, 900, 1200)]
    rows = [(prompts[0], None), (prompts[1], "X"), (prompts[1], "Y"), (prompts[1], None),
            (prompts[2], "X"), (prompts[3], "Y"), (prompts[4], None), (prompts[5], "X")]
    base_rows = [(p, None) for p, _ in rows]
    base = {s: _serve_rows(engine, base_rows, s) for s in (1, 4)}

    app = build_app(engine, None, model_name="qwen2-7b-lora")
    url = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    c0, s0 = engine._graphs.captures, engine._graphs.capture_seconds
    try:
        added = [_post_route(url, "/v1/loras", {"name": n, "path": p}) for n, p in paths.items()]
        listed = _get_route(url, "/v1/loras")
    finally:
        app.stop()
    refresh_captures = engine._graphs.captures - c0
    refresh_s = engine._graphs.capture_seconds - s0
    # base-only traffic once adapters are registered: every graph now holds
    # X4's launches, which return at once on rows of id 0
    base_after = {s: _serve_rows(engine, base_rows, s) for s in (1, 4)}
    base_after_equal = all(base_after[s][0] == base[s][0] for s in (1, 4))

    mine, _ = _attention_kernels("bfloat16")
    kernels = {**mine, **{k.name: k for k in lora.KERNELS.values()}}
    for k in kernels.values():
        k.launches.n = 0
    plain0 = (PLAIN_CALLS.n + quant_gemm.PLAIN_CALLS.n + quant_gemm8.PLAIN_CALLS.n
              + lora.PLAIN_CALLS.n)
    c1 = engine._graphs.captures
    mixed = {s: _serve_rows(engine, rows, s) for s in (1, 4)}
    launches = {n: k.launches.n for n, k in kernels.items()}
    plain = (PLAIN_CALLS.n + quant_gemm.PLAIN_CALLS.n + quant_gemm8.PLAIN_CALLS.n
             + lora.PLAIN_CALLS.n) - plain0
    captures = engine._graphs.captures - c1
    base_equal = all(mixed[s][0][i] == base[s][0][i] for s in (1, 4)
                     for i, (_, a) in enumerate(rows) if a is None)
    # X4's launches a decode step (what a one-step window's graph recorded
    # at capture) and a prefill forward (one chunk of a teacher-forced loop)
    window = next(g for k, g in engine._graphs.graphs.items()
                  if k.kind == "decode" and k.n_steps == 1)
    per_step = {c.name: d for c, d in window.calls.deltas if c.name.startswith("lora_")}
    before = {k.name: k.launches.n for k in lora.KERNELS.values()}
    engine.compute_prompt_loss(prompts[0], adapter_name="X")
    per_prefill = {k.name: k.launches.n - before[k.name] for k in lora.KERNELS.values()}
    per_forward_ok = per_step == per_prefill == {"lora_segments": 1,
                                                 "lora_shrink": 4 * cfg.num_layers,
                                                 "lora_expand": 4 * cfg.num_layers}
    x_moves = all(mixed[s][0][1] != base[s][0][1] and mixed[s][0][1] != mixed[s][0][2]
                  for s in (1, 4))
    # every row's served tokens and logprobs against the teacher under its
    # adapter, at both window depths; the tolerance from the base rows'
    served = {s: _serve_rows(engine, rows, s, logprobs=True) for s in (1, 4)}
    teacher = {s: _lora_teacher_errors(engine, rows, served[s]) for s in (1, 4)}
    base_err = max(teacher[s][i][0] for s in (1, 4) for i, (_, a) in enumerate(rows)
                   if a is None)
    tol = max(LORA_TOL_FACTOR * base_err, LORA_TOL_FLOOR)
    worst = {s: max(max(e, g) for (e, g), (_, a) in zip(teacher[s], rows) if a)
             for s in (1, 4)}
    teacher_ok = all(w <= tol for w in worst.values())

    def swap_x_and_y(streams):
        """Planted: after the prefill, the X row's decode slot reads Y's
        adapter and the Y row's X's."""
        st = engine.state
        i, j = streams[1].slot, streams[2].slot
        st.adapter_ids[i], st.adapter_ids[j] = st.adapter_ids[j].clone(), st.adapter_ids[i].clone()
    faulty = _serve_rows(engine, rows, 4, logprobs=True, admitted=swap_x_and_y)
    fault_err = max(max(e, g) for (e, g), (_, a) in
                    zip(_lora_teacher_errors(engine, rows, faulty), rows) if a)
    fault_caught = fault_err > tol
    _line("lora", fault="decode_slots_swap_x_and_y", max_err=f"{fault_err:.4f}",
          tolerance=f"{tol:.4f}", caught=fault_caught)
    verify = _lora_verify(engine, tol)

    app = build_app(engine, None, model_name="qwen2-7b-lora")
    url = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    try:
        removed = _post_route(url, "/v1/loras", {"name": "Y"}, method="DELETE")
        body = {"prompt": prompts[0], "max_tokens": 4, "temperature": 0, "ignore_eos": True}
        y_status = _post_route(url, "/v1/completions", {**body, "adapter_name": "Y"})[0]
        x_status = _post_route(url, "/v1/completions", {**body, "adapter_name": "X"})[0]
        listed_after = _get_route(url, "/v1/loras")
    finally:
        app.stop()

    # the static merge, against the dynamic adapter, on a 4-layer cut
    cut = LlamaFamilyModel(dataclasses.replace(cfg, num_layers=LORA_LAYERS_CUT), device="cuda")
    whole = ("embed_tokens", "lm_head", "final_norm")
    cut_w = {n: (t if n in whole else t[:LORA_LAYERS_CUT].clone()) for n, t in weights.items()
             if ".lora_" not in n}

    def small_engine(w):
        return LlmEngine(cut, w, EngineConfig(
            cache=CacheConfig(block_size=BS, num_blocks=64),
            scheduler=SchedulerConfig(max_batch_size=8)), device="cuda")
    dyn = small_engine(dict(cut_w))
    mgr = LoraManager(LORA_LAYERS_CUT)
    mgr.add_adapter(cut_path, name="X")
    dyn.set_lora_manager(mgr)
    merged = small_engine(merge_static_adapters(_unfused(cfg, cut_w), f"X={cut_path}",
                                                LORA_LAYERS_CUT))
    loss_dyn = dyn.compute_prompt_loss(prompts[2], adapter_name="X")
    loss_merged = merged.compute_prompt_loss(prompts[2])
    loss_base = dyn.compute_prompt_loss(prompts[2])
    merge_rel = _rel_l2(loss_dyn, loss_merged, centred=True)
    base_rel = _rel_l2(loss_base, loss_merged, centred=True)
    del dyn, merged, cut, cut_w
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    ok = (all(s == 200 for s, _ in added) and listed == (200, {"adapters": ["X", "Y"]})
          and base_equal and x_moves and all(launches.values()) and plain == 0
          and captures == 0 and per_forward_ok and base_after_equal and teacher_ok
          and fault_caught and verify["ok"]
          and removed[0] == 200 and y_status == 400 and x_status == 200
          and listed_after == (200, {"adapters": ["X"]})
          and merge_rel <= CONTROL_REL_L2 and base_rel > CONTROL_REL_L2)
    _line("lora", ok=ok, rows=len(rows), base_rows_bit_equal=base_equal, x_row_moves=x_moves,
          launches=launches, x4_launches_decode_step=per_step,
          x4_launches_prefill_forward=per_prefill, plain_calls=plain,
          captures_serving=captures,
          refresh_captures=refresh_captures, refresh_capture_seconds=f"{refresh_s:.1f}",
          delete_status=removed[0], removed_adapter_status=y_status, live_adapter_status=x_status,
          teacher_max_err_n1=f"{worst[1]:.4f}", teacher_max_err_n4=f"{worst[4]:.4f}",
          teacher_base_rows_err=f"{base_err:.4f}", teacher_tolerance=f"{tol:.4f}",
          base_after_post_bit_equal=base_after_equal,
          window_device_ms_base_n1=f"{base[1][1]:.3f}",
          window_device_ms_base_after_post_n1=f"{base_after[1][1]:.3f}",
          window_device_ms_base_after_post_n4=f"{base_after[4][1]:.3f}",
          window_device_ms_adapters_n1=f"{mixed[1][1]:.3f}",
          window_device_ms_base_n4=f"{base[4][1]:.3f}",
          window_device_ms_adapters_n4=f"{mixed[4][1]:.3f}",
          merged_cut_layers=LORA_LAYERS_CUT, merged_loss_rel_l2=f"{merge_rel:.4f}",
          base_loss_rel_l2=f"{base_rel:.4f}", limit=CONTROL_REL_L2,
          write_seconds=f"{t_write:.1f}", seconds=f"{time.time() - t0:.1f}",
          card=card.replace(" ", "_"))
    if not ok:
        raise SystemExit("lora: a check failed")
    return launches


@_stage("phase_profile")
def phase_profile(engine, cfg, gen, tag, rows=8, steps=5, mode="eager"):
    """Where a decode step's time goes: a torch.profiler window over a steady
    window of ``rows`` active streams, decode windows of one step, read back
    synchronously, eager or replayed as graphs (``mode``). Device time sums
    GPU kernel events only (a host op's entry repeats the time of the
    kernels it launched), grouped into library GEMMs, the 4-bit GEMM
    kernels, the attention kernels and the rest; the busy share is that sum
    over the window's wall time. The profiler stretches the host's step; the
    unprofiled step time is ``phase_step_time``'s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _set_decode(engine, mode, 1, False)
    _steady_decode(engine, cfg, gen, rows)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t1) * 1e6
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total
    per_step = lambda us: f"{us / steps / 1e3:.3f}"
    busy = sum(dev(e) for e in kernels)
    is_gw = lambda e: "gw_" in e.key or "reduce_splits" in e.key  # gw_ring / gw_tile / gw_gemm_pipe ..
    is_q8 = lambda e: any(m in e.key for m in ("w8_", "i8_", "act_quant"))  # the 8-bit kernels
    gw = sum(dev(e) for e in kernels if is_gw(e))
    q8 = sum(dev(e) for e in kernels if is_q8(e))
    act = [e for e in kernels if "act_quant" in e.key]
    i8 = [e for e in kernels if "i8_ring" in e.key or "i8_tile" in e.key]  # one a call
    is_moe = lambda e: "moe_gemm" in e.key  # X6
    gemm = sum(dev(e) for e in kernels if not is_gw(e) and not is_q8(e) and not is_moe(e)
               and any(m in e.key for m in ("nvjet", "gemm", "cutlass", "xmma")))
    attn = sum(dev(e) for e in kernels if "paged_" in e.key)
    moe = sum(dev(e) for e in kernels if is_moe(e))
    top = sorted(kernels, key=dev, reverse=True)[:8]
    launches = sum(e.count for e in kernels) / steps
    _line("profile", model=cfg.model_type, weights=tag, gemm=engine.model.gemm_variant,
          **_kv_mode(engine), active_rows=rows, mode=mode,
          profiled_step_ms=f"{wall_us / steps / 1e3:.2f}",
          device_busy_share=f"{busy / wall_us:.3f}",
          kernel_ms_per_step=per_step(busy), gemm_ms_per_step=per_step(gemm),
          gw_gemm_ms_per_step=per_step(gw), q8_kernels_ms_per_step=per_step(q8),
          act_quant_ms_per_step=per_step(sum(dev(e) for e in act)),
          act_quant_launches_per_step=f"{sum(e.count for e in act) / steps:.0f}",
          i8_gemm_launches_per_step=f"{sum(e.count for e in i8) / steps:.0f}",
          attention_ms_per_step=per_step(attn), moe_gemm_ms_per_step=per_step(moe),
          other_ms_per_step=per_step(busy - gemm - gw - q8 - attn - moe),
          kernel_launches_per_step=f"{launches:.0f}",
          top_kernels_ms_per_step="|".join(f"{e.key[:40]}:{per_step(dev(e))}" for e in top))
    top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    _line("profile-host", model=cfg.model_type, weights=tag, **_kv_mode(engine), mode=mode,
          top_host_ms_per_step="|".join(
        f"{e.key[:40]}:{e.self_cpu_time_total / steps / 1e3:.3f}" for e in top_cpu))
    engine.abort_all("profile done")
    _drain(engine)
    _set_decode(engine, "graph", 1, True)
    return launches


def _prefill_forms(cfg, gen):
    """{form: ModelInputs} of the prefill forwards ``phase_profile_prefill``
    times: a lone 1000-token prompt padded to its 2048-row bucket (as the
    engine ran it before prefill ran at the prompt's length), the same at
    its own length (packed form, 1000 rows), and one packed group of four
    prompts (100, 300, 900 and 1800 tokens, the last behind a 1024-token
    prefix: 2076 rows). Each row has blocks of its own after block 0."""
    import torch

    from rtp_llm_tpu_torch.models import ModelInputs

    dev = dict(dtype=torch.int32, device="cuda")
    t, n = 2048, 1000
    toks = torch.randint(1, cfg.vocab_size, (1, t), generator=gen, device="cuda")
    pos = torch.arange(t, **dev)[None].clone()
    toks[0, n:] = 0
    pos[0, n:] = 0
    bt = torch.arange(1, 1 + t // BS, **dev)[None]
    forms = {"bucket_2048_of_1000": ModelInputs(
        toks, pos, bt, torch.tensor([n], **dev), torch.zeros(1, **dev))}
    forms["lone_1000"] = ModelInputs(toks[0, :n], pos[0, :n], bt, torch.tensor([n], **dev),
                                     torch.zeros(1, **dev), row_lens=(n,))
    offs, lens = [0, 0, 0, 1024], [100, 300, 900, 1800]
    mb = -(-max(lens) // BS)
    bt4 = torch.arange(1, 1 + 4 * mb, **dev).reshape(4, mb)
    rows = [k - o for o, k in zip(offs, lens)]
    forms["group_4"] = ModelInputs(
        torch.randint(1, cfg.vocab_size, (sum(rows),), generator=gen, device="cuda"),
        torch.cat([torch.arange(o, k, **dev) for o, k in zip(offs, lens)]), bt4,
        torch.tensor(lens, **dev), torch.tensor(offs, **dev), row_lens=tuple(rows))
    return forms


@_stage("phase_profile_prefill")
def phase_profile_prefill(engine, gen, tag):
    """Kernel time of each prefill form of ``_prefill_forms`` summed by
    kernel name, from a torch.profiler window over one ``model.forward`` on
    the engine's weights and pool: the padded 2048-row bucket, the lone
    1000-token prompt at its length, one packed group of four."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, cfg = engine.model, engine.model.cfg
    for form, inp in _prefill_forms(cfg, gen).items():
        for _ in range(2):
            model.forward(engine.weights, engine.kv, inp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            model.forward(engine.weights, engine.kv, inp)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t1) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev = lambda e: e.self_device_time_total
        ms = lambda us: f"{us / 1e3:.3f}"
        is_gw = lambda e: "gw_" in e.key or "reduce_splits" in e.key
        is_q8 = lambda e: any(m in e.key for m in ("w8_", "i8_", "act_quant"))
        is_i8 = lambda e: "i8_" in e.key and "paged_" not in e.key  # i8_gemm's kernels
        attn = sum(dev(e) for e in kernels if "paged_" in e.key)
        gw = sum(dev(e) for e in kernels if is_gw(e))
        q8 = sum(dev(e) for e in kernels if is_q8(e))
        lib = sum(dev(e) for e in kernels if not is_gw(e) and not is_q8(e)
                  and any(m in e.key for m in ("nvjet", "gemm", "cutlass", "xmma")))
        busy = sum(dev(e) for e in kernels)
        top = sorted(kernels, key=dev, reverse=True)[:6]
        rows = (sum(inp.row_lens) if inp.row_lens else inp.tokens.numel())
        _line("profile-prefill", model=cfg.model_type, weights=tag, gemm=model.gemm_variant,
              **_kv_mode(engine), form=form, linear_rows=rows,
              live_tokens=int((inp.kv_lens - inp.q_offsets).sum()),
              forward_wall_ms=f"{wall_ms:.1f}", kernel_ms=ms(busy), attention_ms=ms(attn),
              gw_gemm_ms=ms(gw), q8_kernels_ms=ms(q8),
              i8_gemm_ms=ms(sum(dev(e) for e in kernels if is_i8(e))),
              i8_gemm_launches=sum(e.count for e in kernels
                                   if "i8_ring" in e.key or "i8_tile" in e.key),
              act_quant_ms=ms(sum(dev(e) for e in kernels if "act_quant" in e.key)),
              act_quant_launches=sum(e.count for e in kernels if "act_quant" in e.key),
              library_gemm_ms=ms(lib),
              other_ms=ms(busy - attn - gw - q8 - lib),
              launches=sum(e.count for e in kernels),
              top_kernels_ms="|".join(f"{e.key[:44]}:{ms(dev(e))}" for e in top))


def _tensor_gbytes(weights):
    return sum(t.numel() * t.element_size() for t in weights.values()
               if hasattr(t, "numel")) / 1e9


@_stage("_seeded_weights")
def _seeded_weights(model, seed, name):
    """bf16 weights in the layout the engine serves (q/k/v and gate/up fused
    at load time), from a generator of their own so that the same weights
    can be drawn again."""
    import torch

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    weights = model.fuse_weights(random_weights(cfg, wgen))
    torch.cuda.synchronize()
    _line("weights", model=name, layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


@_stage("_to_gptq_form")
def _to_gptq_form(model, weights):
    """Quantize the bf16 linears on the card to the GPTQ form and fuse as the
    engine does; returns (weights, seconds)."""
    import torch

    t0 = time.time()
    wq = model.fuse_weights(quantize_gptq_form(weights))
    torch.cuda.synchronize()
    return wq, time.time() - t0


def _free_linears(weights, wq, cfg, name, quant_s):
    """Drop the bf16 linears of ``weights`` and say what is left on the card."""
    import gc

    import torch

    for n in QUANT_LINEARS:
        del weights[n]
    gc.collect()  # an engine behind a stopped HTTP app dies with its reference cycle
    torch.cuda.empty_cache()
    trunk = {n: t for n, t in wq.items() if n.split(".")[0] in QUANT_LINEARS}
    _line("weights", model=name, layers=cfg.num_layers, dtype="int4-gptq-form",
          group=GW_GROUP, gbytes=f"{_tensor_gbytes(wq):.2f}",
          trunk_gbytes=f"{_tensor_gbytes(trunk):.2f}", quantize_seconds=f"{quant_s:.1f}",
          device_gbytes_allocated=f"{torch.cuda.memory_allocated() / 1e9:.2f}")


def _logits_distance(tag, got, ref):
    """Printed, not judged: what a change of pool type or write mode costs
    on random weights."""
    _line("logits-distance", case=tag,
          rel_l2=f"{float((got - ref).norm() / ref.norm()):.3e}",
          argmax_agree=f"{float((got.argmax(-1) == ref.argmax(-1)).float().mean()):.3f}")


def phase_qwen2(gen, card, spec_launches):
    """Phases 6-9 on Qwen2-7B. Returns ({kernel name: launches on its serve
    path}, plain-version calls over the serve phases, the largest B of a
    prefill attention call there); the speculative phases' launches go to
    ``spec_launches``."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    cfg = dataclasses.replace(qwen2_7b_config(), num_layers=QWEN2_LAYERS)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 1, QWEN2_NAME)
    steps, num_blocks = model_steps(cfg, gen)
    bf16_logits = phase_model(model, weights, steps, num_blocks)
    engine, launches, plain_calls, b_max = phase_serve(model, weights, gen, card, tail=True)
    phase_controls(engine, gen, card)
    phase_logprob_gap(engine, card)
    phase_frontend(engine, gen, card)
    phase_update_weights(cfg, card)
    want, serve_prompts, err = phase_spec(engine, card, spec_launches)
    phase_spec_draft(engine, want, serve_prompts, err, card, spec_launches)
    phase_beam(engine, card, "qwen2-7b-bf16", ("tail_copy_left_out", _copy_nothing))
    lora_launches = phase_lora(engine, weights, card)
    launches.update({n: lora_launches[n] for n in ("lora_segments", "lora_shrink",
                                                   "lora_expand")})
    del engine
    for name in [n for n in weights if ".lora_" in n]:  # the adapter stacks go with it
        del weights[name]

    # 4-bit: quantize on the card, fuse as the engine does, free the bf16 linears
    wq, quant_s = _to_gptq_form(model, weights)
    phase_model_4bit_cuts(cfg, weights, wq, gen)
    _free_linears(weights, wq, cfg, QWEN2_NAME, quant_s)
    model.gemm_variant = "base"
    phase_model_4bit(model, wq, steps, num_blocks, "gptq_form_full_width", bf16_logits)
    engine, got, plain, b = phase_serve(model, wq, gen, card, tag="int4", gemm="base")
    b_max = max(b_max, b)
    phase_admission(engine, gen, card)
    del engine
    # the attention kernels' rows keep the bf16 path's counts
    launches["gw_gemm"] = got["gw_gemm"]
    # the same engine with windows of 4 decode steps
    engine, _, plain4, b = phase_serve(model, wq, gen, card, tag="int4", gemm="base",
                                       decode_steps=4, follow_up=False)
    b_max = max(b_max, b)
    del engine
    engine, got, plain_pipe, b = phase_serve(model, wq, gen, card, tag="int4", gemm="pipe")
    b_max = max(b_max, b)
    del engine
    launches["gw_gemm_pipe"] = got["gw_gemm_pipe"]
    model.gemm_variant = "base"
    torch.cuda.empty_cache()
    return launches, plain_calls + plain + plain4 + plain_pipe, b_max


def phase_llama3(gen, card, spec_launches):
    """Llama-3-8B at full width, cut to ``LLAMA_LAYERS`` layers, on a
    quantized KV pool.

    Model steps with bf16 weights: int8 KV with in-layer writes and with
    deferred writes, every layer's attention held against the plain version;
    the distance of the int8-KV logits to the bf16-KV logits, and of the
    deferred to the in-layer ones. A 4-layer cut of the same weights serves
    with an fp8 pool. Then the weights go to the GPTQ form and the engine
    serves with 4-bit weights, int8 KV, prefix cache and deferred writes.
    Returns ({kernel name: launches}, plain-version calls, the engines whose
    decode step is profiled at the end: int8 KV deferred, int8 KV in-layer,
    bf16 KV; the largest B of a served prefill attention call)."""
    import dataclasses

    import torch

    from rtp_llm_tpu_torch.config.model_config import llama3_8b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    cfg = dataclasses.replace(llama3_8b_config(), num_layers=LLAMA_LAYERS)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 2, LLAMA_NAME)
    steps, num_blocks = model_steps(cfg, gen)
    bf16_kv = run_steps(model, weights, steps, num_blocks)
    int8_kv = phase_model(model, weights, steps, num_blocks, kv="int8")
    int8_deferred = phase_model(model, weights, steps, num_blocks, kv="int8", defer=True)
    _logits_distance(f"{LLAMA_NAME} int8 KV vs bf16 KV", int8_kv, bf16_kv)
    _logits_distance(f"{LLAMA_NAME} int8 KV deferred vs in-layer", int8_deferred, int8_kv)
    del bf16_kv, int8_kv, int8_deferred

    # fp8 pool, bf16 weights: a 4-layer cut of the same weights
    layers = 4
    cut = LlamaFamilyModel(dataclasses.replace(cfg, num_layers=layers), device="cuda")
    whole = ("embed_tokens", "lm_head", "final_norm")
    # copies, not views: a view would keep the whole 32-layer stack alive
    cut_weights = {n: (t if n in whole else t[:layers].clone()) for n, t in weights.items()}
    cut_steps, cut_blocks = model_steps(cut.cfg, gen, lens=(60, 300, 500), t=512, decode_steps=2)
    phase_model(cut, cut_weights, cut_steps, cut_blocks, kv="fp8")
    engine, launches, plain_calls, b_max = phase_serve(
        cut, cut_weights, gen, card, tag="bf16-4-layers", kv="fp8", name="llama3-8b")
    del engine, cut_weights

    wq, quant_s = _to_gptq_form(model, weights)
    _free_linears(weights, wq, cfg, LLAMA_NAME, quant_s)
    del weights
    torch.cuda.empty_cache()
    phase_kv_pool(model)
    served, got, plain, b = phase_serve(model, wq, gen, card, tag="int4", gemm="base",
                                        kv="int8", defer=True, name=LLAMA_NAME)
    phase_spec_eagle(served, card, spec_launches)
    phase_beam(served, card, f"{LLAMA_NAME}-int4-int8kv-deferred",
               ("scales_not_copied", _copy_data_only))
    launches.update(got)
    launches.pop("gw_gemm")  # that row keeps the Qwen2-7B serve's count
    # the same weights beside the other two write modes, for the step tables
    engines = [served, make_engine(model, wq, gemm="base", kv="int8"),
               make_engine(model, wq, gemm="base", kv="bfloat16")]
    for engine in engines[1:]:
        phase_step_time(engine, cfg, gen, "int4", card)
    return launches, plain_calls + plain, engines, max(b_max, b)


@_stage("phase_kv_pool")
def phase_kv_pool(model):
    """What a KV block weighs and how many tokens a pool sized from the
    card's free memory holds, per pool type, beside the weights resident
    now. Nothing is allocated: the engine's own sizing is asked."""
    import gc

    from rtp_llm_tpu_torch.config import EngineConfig, QuantConfig
    from rtp_llm_tpu_torch.engine import LlmEngine

    gc.collect()
    out = {}
    for kv in ("bfloat16", "int8", "fp8"):
        probe = LlmEngine.__new__(LlmEngine)  # sizing reads config, model and device only
        probe.config, probe.model, probe.device = (
            EngineConfig(quant=QuantConfig(kv_cache_dtype=kv)), model, model.device)
        blocks = probe._auto_size_blocks()
        out[f"{kv}_block_bytes"] = probe.kv_block_bytes()
        out[f"{kv}_auto_blocks"] = blocks
        out[f"{kv}_auto_tokens"] = blocks * probe.config.cache.block_size
    import torch

    _line("kv-pool", model=LLAMA_NAME, weights="int4-gptq-form", block_size=BS,
          device_gbytes_allocated=f"{torch.cuda.memory_allocated() / 1e9:.2f}", **out)


# ---------------------------------------------------------------- 8-bit weights

INT8_OP_PER_S = 1979e12  # H100 SXM data sheet, int8 dense
# (K, N) of every linear of Qwen2-7B and Qwen2-1.5B (q/k/v and gate/up fused,
# as served) and the Qwen2-7B LM head
W8_SHAPES = {"qwen2-7b_qkv_proj": (3584, 4608), "qwen2-7b_o_proj": (3584, 3584),
             "qwen2-7b_gate_up_proj": (3584, 37888), "qwen2-7b_down_proj": (18944, 3584),
             "qwen2-7b_lm_head": (3584, 152064),
             "qwen2-1.5b_qkv_proj": (1536, 2048), "qwen2-1.5b_o_proj": (1536, 1536),
             "qwen2-1.5b_gate_up_proj": (1536, 17920), "qwen2-1.5b_down_proj": (8960, 1536)}
# w8_gemm: the ring kernel below 128 rows, the tile kernel from 128 (127 /
# 128 / 130 straddle the switch; 1000 is the lone prompt at its length)
W8_MS = (1, 8, 64, 127, 128, 130, 776, 1000, 2048)
# i8_gemm: the ring kernel below 128 rows, the tile kernel from 128 (127 /
# 128 / 130 straddle the switch, 256 fills a tile)
I8_MS = (1, 8, 64, 127, 128, 130, 256, 776, 1000, 2048)
# w8_gemm's modes: codes and scale layout (s8 groupwise holds GPTQ values 0..15)
W8_MODES = ("s8_channel", "e4m3_tensor", "e4m3_channel", "e4m3_block_128", "s8_group_128")
W8_TIMED = ("qwen2-7b_qkv_proj", "qwen2-7b_gate_up_proj", "qwen2-7b_down_proj",
            "qwen2-7b_lm_head", "qwen2-1.5b_gate_up_proj")
W8_ALL_MODES_TIMED = ("qwen2-7b_gate_up_proj", "qwen2-7b_down_proj", "qwen2-7b_lm_head")
W8_TIMED_MS = (8, 64, 2048)
# kernels built with a planted fault: (name, define, the mode it is run at,
# the rows: 64 runs the ring kernel, 256 the tile kernel)
W8_FAULTS = (
    ("per_channel_scale_of_the_neighbouring_column", "W8_FAULT=1", "s8_channel", (64, 256)),
    ("group_scaled_by_the_next_groups_row", "W8_FAULT=2", "e4m3_block_128", (64, 256)),
    ("e4m3_exponent_off_by_one", "W8_FAULT=3", "e4m3_channel", (64, 256)),
    ("tile_slot_of_the_wrong_parity", "W8_FAULT=4", "s8_channel", (256,)),
    ("tile_group_end_skipped", "W8_FAULT=5", "e4m3_block_128", (256,)))
# i8_gemm built with a planted fault: (name, define, groups: "one" (W8A8) or
# "128" (W4A8), the rows: 64 runs the ring kernel, 256 the tile kernel)
I8_FAULTS = (
    ("group_partial_not_reset", "I8_FAULT=1", "128", (64, 256)),
    ("i8_slot_of_the_wrong_parity", "I8_FAULT=2", "one", (256,)),
    ("b_operand_one_k_quad_off", "I8_FAULT=3", "one", (64, 256)),
    ("i8_tile_group_end_skipped", "I8_FAULT=4", "128", (256,)))
# act_quant's inputs: (M, K, row stride, offset of the first element). Every
# row with its amax at a column that moves through the warps and chunks of
# the kernel's plan and an element at half its amax (_act_input). K 3585,
# an offset of one element and a K of 7 or 1 take the scalar path; 70000
# is taken in two rounds
ACT_SHAPES = ((1, 3584, 3584, 0), (64, 3584, 3584, 0), (64, 18944, 18944, 0),
              (776, 18944, 18944, 0),
              (1000, 3584, 3584, 0), (1000, 18944, 18944, 0), (2048, 3584, 3584, 0),
              (2048, 18944, 18944, 0), (2076, 3584, 3584, 0), (2076, 18944, 18944, 0),
              (8, 1536, 1536, 0), (1000, 1536, 1536, 0), (2048, 8960, 8960, 0),
              (1000, 3584, 3648, 0), (64, 3585, 3585, 0), (1000, 3585, 3585, 0),
              (64, 3584, 3592, 1), (64, 7, 7, 0), (64, 1, 1, 0), (4, 70000, 70000, 0))
# the shapes timed: W4A8 decode (64 rows), a lone 1000-token prefill and a
# group of four (2076 rows) into qkv / o_proj / gate-up (K 3584) and down
# (18944), and 2048 rows
ACT_TIMED = ((64, 3584), (64, 18944), (1000, 3584), (1000, 18944), (2048, 18944),
             (2076, 3584), (2076, 18944))
# act_quant built with a planted fault: (name, define, the ACT_SHAPES entries
# it must be caught at)
ACT_FAULTS = (
    ("amax_without_the_last_warp", "ACT_FAULT=1",
     ((2048, 18944, 18944, 0), (1000, 1536, 1536, 0))),
    ("near_half_escape_left_out", "ACT_FAULT=2", ((1000, 3584, 3584, 0), (64, 3584, 3584, 0))),
    ("scalar_path_drops_the_last_element", "ACT_FAULT=3",
     ((64, 3585, 3585, 0), (64, 3584, 3592, 1))))


@functools.lru_cache(maxsize=None)
def _q8_fault_kernels():
    """The 8-bit kernels built with a planted fault, by fault name."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    out = {}
    for faults, key, src in ((W8_FAULTS, "w8", "w8_gemm.cu"), (I8_FAULTS, "i8", "i8_gemm.cu"),
                             (ACT_FAULTS, "act_quant", "act_quant.cu")):
        base = q8.KERNELS[key]
        for fault in faults:
            assert fault[0] not in out, f"two faults named {fault[0]}"
            out[fault[0]] = (key, _kernels.Kernel(f"{base.name}:{fault[0]}", src, base.entry,
                                                  base.argtypes, defines=(fault[1],)))
    return out


@functools.lru_cache(maxsize=None)
def _act_divide_kernel():
    """act_quant built to divide every element (ACT_DIVIDE_ALL), timed
    beside the served build in phase_act_quant."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    base = q8.KERNELS["act_quant"]
    return _kernels.Kernel(f"{base.name}:divide_every_element", "act_quant.cu", base.entry,
                           base.argtypes, defines=("ACT_DIVIDE_ALL=1",))


@contextlib.contextmanager
def _q8_swapped(fault):
    """The 8-bit wrapper of the faulty kernel's entry launches it inside."""
    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    key, kernel = _q8_fault_kernels()[fault]
    saved = q8.KERNELS[key]
    q8.KERNELS[key] = kernel
    try:
        yield
    finally:
        q8.KERNELS[key] = saved


def _w8_weights(k, n, mode, gen, copies=1):
    """Codes and positive scales of ``mode`` for ``copies`` stacked layers:
    s8 codes over [-127, 127] (GPTQ values 0..15 for the groupwise mode),
    e4m3 codes drawn over every byte but NaN (subnormals included)."""
    import torch

    if mode.startswith("s8"):
        lo, hi = (0, 16) if mode == "s8_group_128" else (-127, 128)
        codes = torch.randint(lo, hi, (copies, k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
    else:
        b = torch.randint(0, 256, (copies, k, n), generator=gen, device="cuda",
                          dtype=torch.uint8)
        b[(b & 0x7F) == 0x7F] = 0
        codes = b.view(torch.float8_e4m3fn)
    shape = {"tensor": (copies,), "channel": (copies, n)}.get(
        mode.split("_")[1], (copies, k // 128, n))
    scale = (torch.rand(shape, generator=gen, device="cuda") + 0.5) * (
        3e-3 if mode.startswith("s8") else 3e-5)
    return codes, scale


def _w8_dequant(codes, scale):
    """The bf16 weights ``codes`` and ``scale`` stand for (library_ms's operand)."""
    import torch

    s = scale.float()
    if s.dim() == 2:
        s = s.repeat_interleave(codes.shape[0] // s.shape[0], dim=0)
    return (codes.float() * s).to(torch.bfloat16)


def _materialising(x, codes, scale):
    """``x @ w.to(bf16) * s``: what PyTorch offers without a fused convert."""
    import torch

    return (x @ codes.to(torch.bfloat16)) * scale.to(torch.bfloat16)


def _w8_bound(m, k, n, scale):
    nbytes = k * n + 4.0 * scale[0].numel() + 2.0 * m * k + 2.0 * m * n
    return _bound_ms(nbytes, 2.0 * m * k * n)


def _w8_decode_exact():
    """Every s8 code and every e4m3 code but NaN, through both kernels,
    comes out as the exact value: W [256, 256] holds each code once in every
    column (row i, column n: byte (i + n) % 256), x one-hot rows pick W's
    rows, the scale is 1, so each output is one code's value in bf16. 256
    rows run the tile kernel, four calls of 64 the ring kernel."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    idx = torch.arange(256, device="cuda")
    b = ((idx[:, None] + idx[None, :]) % 256).to(torch.uint8)
    one = torch.ones((), device="cuda")
    for code, codes in (("s8", b.view(torch.int8)),
                        ("e4m3", torch.where((b & 0x7F) == 0x7F, 0, b).view(torch.float8_e4m3fn))):
        want = codes.to(torch.bfloat16)
        eye = torch.eye(256, device="cuda", dtype=torch.bfloat16)
        tile = q8.w8_matmul(eye, codes, one)
        ring = torch.cat([q8.w8_matmul(eye[r:r + 64], codes, one) for r in range(0, 256, 64)])
        # values, not bits: a sum of products turns the code -0.0 into +0.0
        bad = {k: int((got.float() != want.float()).sum())
               for k, got in (("tile", tile), ("ring", ring))}
        _line("w8-decode", code=code, codes=len(torch.unique(codes.view(torch.uint8))),
              tile_values_differing=bad["tile"], ring_values_differing=bad["ring"])
        if any(bad.values()):
            raise SystemExit(f"w8_gemm does not decode every {code} code exactly ({bad})")


def phase_w8(gen):
    """w8_gemm against its plain version at every linear shape of Qwen2-7B
    and Qwen2-1.5B and the Qwen2-7B LM head, in each mode of W8_MODES, at M
    in W8_MS (both kernels); every code decoded exactly by both; five
    kernels built with a planted fault must fail the same check. Times at
    W8_TIMED (every call on the next layer's weights, cold in L2) beside the
    plain version, cuBLAS bf16 on weights dequantized beforehand
    (``library_ms``) and the materialising ``x @ w.to(bf16) * s``. Returns
    the record at the Qwen2-7B gate-up shape, M = 64, s8 per channel (the
    int8 engine's decode)."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    _w8_decode_exact()
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, record = 0.0, None
    for name, (k, n) in W8_SHAPES.items():
        for mode in W8_MODES:
            timed = name in W8_TIMED and (mode == "s8_channel" or name in W8_ALL_MODES_TIMED)
            copies = max(1, -(-120_000_000 // (k * n))) if timed else 1
            codes, scale = _w8_weights(k, n, mode, gen, copies)
            for m in W8_MS:
                x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
                got = q8.w8_matmul(x, codes[0], scale[0])
                want = q8.w8_matmul_ref(x, codes[0], scale[0])
                err, rel, ok = _check_gemm(got, want)
                _line("w8", shape=name, mode=mode, M=m, K=k, N=n,
                      plan=q8.w8_plan(m, k, n, 128 if mode.endswith("128") else q8.W8_K_TILE, sm,
                                      grouped=mode.endswith("128")),
                      max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", ok=ok)
                if not ok:
                    raise SystemExit(f"w8_gemm disagrees with its plain version ({name}, "
                                     f"{mode}, M={m})")
                worst = max(worst, err)
                if not timed or m not in W8_TIMED_MS:
                    continue
                ms = _graph_ms(_cycling(lambda i: q8.w8_matmul(x, codes[i], scale[i]), copies),
                               2 * copies)
                plain_ms = _time_ms(_cycling(lambda i: q8.w8_matmul_ref(
                    x, codes[i], scale[i]), copies), iters=3, warmup=1)
                wd = torch.stack([_w8_dequant(codes[i], scale[i]) for i in range(copies)])
                lib_ms = _graph_ms(_cycling(lambda i: torch.matmul(x, wd[i]), copies),
                                   2 * copies)
                del wd
                mat_ms = "none"  # the groupwise modes have no one-multiply form
                if not mode.endswith("128"):
                    mat_ms = f"{_graph_ms(_cycling(lambda i: _materialising(x, codes[i], scale[i]), copies), 2 * copies):.4f}"
                bound, by = _w8_bound(m, k, n, scale)
                _line("w8-time", shape=name, mode=mode, M=m, K=k, N=n, device_ms=f"{ms:.4f}",
                      plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
                      materialising_ms=mat_ms, bound_ms=f"{bound:.4f}", bound_by=by,
                      share_of_bound=f"{bound / ms:.3f}",
                      tflops=f"{2.0 * m * k * n / ms / 1e9:.1f}")
                if name == "qwen2-7b_gate_up_proj" and m == 64 and mode == "s8_channel":
                    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                  bound_by=by)
            if name == "qwen2-7b_o_proj":
                # faults built into the kernels
                cases = []
                for fault, _, fmode, rows in W8_FAULTS:
                    for m in rows if fmode == mode else ():
                        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
                        want = q8.w8_matmul_ref(x, codes[0], scale[0])
                        with _q8_swapped(fault):
                            cases.append((f"{fault}:M{m}", q8.w8_matmul(x, codes[0], scale[0]),
                                          want))
                _planted("w8-fault:built_in", cases, check=_check_gemm)
            del codes, scale
        torch.cuda.empty_cache()
    record["max_abs_err"] = worst
    return record


@functools.lru_cache(maxsize=None)
def _act_near_half_pairs():
    """(amax, x) of every bf16 pair, amax in [1, 2) and 0 < x <= amax,
    whose code the reciprocal product alone (``rint(x * rn(1 / s))``) gives
    otherwise than the true division: a search on the CPU. act_quant's
    near-half escape must hold them; ACT_FAULT=2 leaves it out."""
    import torch

    pairs = []
    for i in range(128):
        x = (torch.arange(1, 0x3F80 + i + 1, dtype=torch.int32) << 16).view(torch.float32)
        s = x[-1:] / torch.full_like(x[-1:], 127.0)
        fast = torch.round((x * (torch.ones_like(s) / s)).clamp(-127, 127))
        true = torch.round((x / s).clamp(-127, 127))
        pairs += [(float(x[-1]), float(v)) for v in x[fast != true]]
    assert pairs, "no pair for the near-half escape to hold"
    return tuple(pairs)


def _act_input(m, k, lda, shift, gen):
    """x [m, k] bf16, a view of [m, lda] from element ``shift`` on, for
    act_quant's checks. Row 0 is zero. In row r the largest magnitude, a
    near-half pair's amax times 2^((r % 17) - 8) (the sign alternating),
    sits at column (131 r + 7) % k, which moves through the kernel's warps
    and chunks, the pair's x (half the amax) at the next column; the other
    values are normal, 3/16 of the amax wide, clipped below it."""
    import torch

    pairs = torch.tensor(_act_near_half_pairs(), device="cuda")
    buf = torch.randn((m, lda), generator=gen, device="cuda", dtype=torch.bfloat16)
    x = buf[:, shift:shift + k] if shift or lda > k else buf
    r = torch.arange(m, device="cuda")
    p = pairs[r % len(pairs)] * torch.exp2((r % 17 - 8).float())[:, None]
    sign = 1.0 - 2.0 * (r % 2).float()
    amax = p[:, 0:1]
    body = (x.float() * (3.0 / 16.0) * amax).clamp(-0.99 * amax, 0.99 * amax)
    col = (r * 131 + 7) % k
    body[r, (col + 1) % k] = sign * p[:, 1]
    body[r, col] = sign * p[:, 0]
    body[0] = 0.0
    x.copy_(body.to(torch.bfloat16))
    return x


def phase_act_quant(gen):
    """act_quant's codes and scales equal its plain version's bit for bit at
    every input of ACT_SHAPES (the 16-byte path, the scalar path on ragged
    K and a misaligned pointer, a row stride above K, two rounds); each
    kernel built with a planted fault (ACT_FAULTS) must differ at its
    inputs. Times at ACT_TIMED beside the plain version, the byte bound
    and two simpler designs (_act_variants). Returns the record at M = 2048 into the Qwen2-7B down projection (K =
    18944)."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    record = None
    for m, k, lda, shift in ACT_SHAPES:
        x = _act_input(m, k, lda, shift, gen)
        q, s = q8.act_quant(x)
        rq, rs = q8.quantize_activations_ref(x)
        ok = torch.equal(q, rq) and torch.equal(s, rs)
        vec = k % 8 == 0 and lda % 8 == 0 and x.data_ptr() % 16 == 0
        _line("act-quant", M=m, K=k, lda=lda, offset=shift, plan=q8.act_plan(m, k, sm),
              path="16-byte" if vec else "scalar", codes_differing=int((q != rq).sum()),
              scales_differing=int((s != rs).sum()), ok=ok)
        if not ok:
            raise SystemExit(f"act_quant's codes differ from the plain version's (M={m}, "
                             f"K={k}, lda={lda}, offset={shift})")
        if (m, k) in ACT_TIMED and lda == k:
            ms = _graph_ms(lambda: q8.act_quant(x), 8)
            plain_ms = _time_ms(lambda: q8.quantize_activations_ref(x), iters=5)
            bound, by = _bound_ms(3.0 * m * k + 4.0 * m, 0.0)
            _line("act-quant-time", M=m, K=k, device_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                  bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / ms:.3f}")
            if (m, k) == (2048, 18944):
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                              bound_by=by, max_abs_err=0.0)
    missed = []
    for fault, _, shapes in ACT_FAULTS:
        for m, k, lda, shift in shapes:
            x = _act_input(m, k, lda, shift, gen)
            rq, rs = q8.quantize_activations_ref(x)
            with _q8_swapped(fault):
                fq, fs = q8.act_quant(x)
            caught = not (torch.equal(fq, rq) and torch.equal(fs, rs))
            _line("act-quant-fault", fault=fault, M=m, K=k, lda=lda, offset=shift,
                  rows_differing=int((fq != rq).any(-1).sum()), caught=caught)
            if not caught:
                missed.append(f"{fault}:M{m}:K{k}")
    if missed:
        raise SystemExit(f"act-quant: the check does not catch {missed}")
    _act_variants(gen, sm)
    return record


def _act_variants(gen, sm):
    """act_quant's design against two simpler ones at ACT_TIMED, in turns
    (served, variant, variant, served): the build that divides every
    element, and the served build run at 2, 8 or 16 chunks a thread (the
    next at or above the plan's, the rest masked). Each must stay
    bit-equal."""
    import torch

    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    def launch(kernel, x, fixed=False):
        m, k = x.shape
        q = torch.empty((m, k), dtype=torch.int8, device="cuda")
        s = torch.empty((m, 1), dtype=torch.float32, device="cuda")
        vpt, warps, rows = q8.act_plan(m, k, sm)
        if fixed:
            vpt = 2 if vpt <= 2 else 8 if vpt <= 8 else 16
        kernel.launch(x.data_ptr(), x.stride(0), q.data_ptr(), s.data_ptr(), m, k, vpt, warps,
                      rows, _kernels.stream_ptr(x.device))
        return q, s

    served = q8.KERNELS["act_quant"]
    for m, k in ACT_TIMED:
        x = _act_input(m, k, k, 0, gen)
        rq, rs = q8.quantize_activations_ref(x)
        for name, fn in (("divide_every_element", lambda: launch(_act_divide_kernel(), x)),
                         ("chunks_2_8_16", lambda: launch(served, x, fixed=True))):
            q, s = fn()
            ok = torch.equal(q, rq) and torch.equal(s, rs)
            t = [_graph_ms(f, 8) for f in (lambda: launch(served, x), fn, fn,
                                            lambda: launch(served, x))]
            _line("act-quant-variant", variant=name, M=m, K=k,
                  served_ms=f"{t[0]:.4f},{t[3]:.4f}", variant_ms=f"{t[1]:.4f},{t[2]:.4f}",
                  ratio=f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"act-quant-variant {name}: codes differ (M={m}, K={k})")


def _int_mm_forms(xq, xs, w, s, copies):
    """{form: ms} of ``torch._int_mm`` on the W8A8 product: the codes
    row-major as the port keeps them ([K, N]) and column-major (a [N, K]
    contiguous copy passed as ``.t()``, the layout cuBLASLt's int8 path
    takes), each alone (int32 out) and with the epilogue (f32 scales, bf16
    out); or {form: reason} where it does not take these operands."""
    import torch

    wt = w.transpose(-1, -2).contiguous()
    layouts = {"kn": lambda i: w[i], "nk_t": lambda i: wt[i].t()}
    out = {}
    for layout, weight in layouts.items():
        for epilogue in (False, True):
            def run(i, weight=weight, epilogue=epilogue):
                y = torch._int_mm(xq, weight(i))
                return ((y.float() * s[i]) * xs).to(torch.bfloat16) if epilogue else y
            form = f"int_mm_{layout}" + ("+epilogue" if epilogue else "")
            try:
                run(0)
                out[form] = _graph_ms(_cycling(run, copies), 2 * copies)
            except RuntimeError as e:
                out[form] = str(e).splitlines()[0][:80].replace(" ", "_")
    return out


def _i8_faults(gen, k, n):
    """The kernels built with a planted fault (I8_FAULTS) at the Qwen2-7B
    o_proj shape, each at its rows and group mode: every one must fail the
    check ``[i8]`` applies."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    cases = []
    for fault, _, mode, rows in I8_FAULTS:
        groups, lim = (1, 127) if mode == "one" else (k // 128, 7)
        w = torch.randint(-lim, lim + 1, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        s = (torch.rand((groups, n), generator=gen, device="cuda") + 0.5) * 3e-3
        s = s[0] if groups == 1 else s
        for m in rows:
            x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            xq, xs = q8.quantize_activations_ref(x)
            want = q8.i8_matmul_ref(xq, xs, w, s, torch.bfloat16)
            with _q8_swapped(fault):
                cases.append((f"{fault}:M{m}", q8.i8_matmul(xq, xs, w, s), want))
    _planted("i8-fault:built_in", cases, check=_check_gemm)


def phase_i8(gen):
    """i8_gemm against its plain version (the integer sums exact in f64) at
    every shape of W8_SHAPES, M in I8_MS (both kernels), one group spanning
    K (W8A8: s8 weights, per-channel scales) and groups of 128 (W4A8: int4
    values); the kernels built with a planted fault (I8_FAULTS) must fail
    the same check. Times at qkv, gate-up and down, M 64 / 2048 (every call
    on the next layer's weights, cold in L2) beside ``torch._int_mm`` in
    each operand layout, alone and with its epilogue (``_int_mm_forms``).
    Returns the record at the Qwen2-7B gate-up shape, M = 2048, W8A8 (a
    prefill); its library_ms is the fastest ``_int_mm`` form."""
    import torch

    from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, record = 0.0, None
    for name, (k, n) in W8_SHAPES.items():
        for groups, lim in ((1, 127), (k // 128, 7)):
            timed = name in W8_TIMED[:3]
            copies = max(1, -(-120_000_000 // (k * n))) if timed else 1
            w = torch.randint(-lim, lim + 1, (copies, k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
            s = (torch.rand((copies, groups, n), generator=gen, device="cuda") + 0.5) * 3e-3
            if groups == 1:
                s = s[:, 0]
            for m in I8_MS:
                x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
                xq, xs = q8.quantize_activations_ref(x)
                got = q8.i8_matmul(xq, xs, w[0], s[0])
                want = q8.i8_matmul_ref(xq, xs, w[0], s[0], torch.bfloat16)
                err, rel, ok = _check_gemm(got, want)
                _line("i8", shape=name, groups=groups, M=m, K=k, N=n,
                      plan=q8.plan(m, k, n, k // groups if groups > 1 else q8.K_TILE, sm,
                                   grouped=groups > 1),
                      max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", ok=ok)
                if not ok:
                    raise SystemExit(f"i8_gemm disagrees with its plain version ({name}, "
                                     f"groups={groups}, M={m})")
                worst = max(worst, err)
                if not timed or m not in (64, 2048):
                    continue
                ms = _graph_ms(_cycling(lambda i: q8.i8_matmul(xq, xs, w[i], s[i]), copies),
                               2 * copies)
                plain_ms = _time_ms(_cycling(lambda i: q8.i8_matmul_ref(
                    xq, xs, w[i], s[i], torch.bfloat16), copies), iters=2, warmup=1)
                forms = _int_mm_forms(xq, xs, w, s, copies) if groups == 1 else {}
                timed_forms = {f: v for f, v in forms.items() if isinstance(v, float)}
                lib_ms = min(timed_forms.values()) if timed_forms else None
                nbytes = m * k + k * n + 4.0 * s[0].numel() + 4.0 * m + 2.0 * m * n
                tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * m * k * n / INT8_OP_PER_S * 1e3
                bound, by = (tb, "bytes") if tb >= tf else (tf, "operations")
                _line("i8-time", shape=name, groups=groups, M=m, K=k, N=n,
                      device_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                      library_ms=f"{lib_ms:.4f}" if lib_ms else "none(grouped)",
                      library_form=min(timed_forms, key=timed_forms.get) if timed_forms
                      else "none",
                      **{f.replace("+", "_plus_"): v if isinstance(v, str) else f"{v:.4f}"
                         for f, v in forms.items()},
                      bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / ms:.3f}",
                      tops=f"{2.0 * m * k * n / ms / 1e9:.1f}")
                if name == "qwen2-7b_gate_up_proj" and m == 2048 and groups == 1:
                    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                  bound_by=by)
            del w, s
        if name == "qwen2-7b_o_proj":
            _i8_faults(gen, k, n)
        torch.cuda.empty_cache()
    record["max_abs_err"] = worst
    return record


@_stage("quantize_8bit")
def quantize_8bit(weights, method, head=False, **quant):
    """The fused bf16 linears (and, with ``head``, the LM head) through the
    port's load-time transform on the card; everything else shared. A
    stack goes through the transform four layers at a time and is joined
    after: every route quantizes each layer on its own, and the f32
    temporaries of a whole stack (14 GB for W4A8 gate-up) would not fit
    beside the engines the run holds."""
    import torch

    from rtp_llm_tpu_torch.config import QuantConfig
    from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec
    from rtp_llm_tpu_torch.quant import make_quant_transform

    transform = make_quant_transform(QuantConfig(method=method, quantize_lm_head=head, **quant))
    out = {n: t for n, t in weights.items() if n not in QUANT_LINEARS}
    for name in QUANT_LINEARS + (("lm_head",) if head else ()):
        spec = WeightSpec(name, "", per_layer=name != "lm_head", transpose=True,
                          shard_axis="out")
        w = weights[name]
        if not spec.per_layer:
            parts = [transform(spec, w)]
        else:
            parts = [transform(spec, w[i:i + 4]) for i in range(0, w.shape[0], 4)]
        for suffix, v in parts[0].items():
            out[name + suffix] = (torch.cat([p[suffix] for p in parts])
                                  if torch.is_tensor(v) else v)
    return out


def _weights_line(weights, cfg, name, dtype, seconds):
    import torch

    part = lambda names: _tensor_gbytes({n: t for n, t in weights.items()
                                         if n.split(".")[0] in names})
    _line("weights", model=name, layers=cfg.num_layers, dtype=dtype,
          gbytes=f"{_tensor_gbytes(weights):.2f}", trunk_gbytes=f"{part(QUANT_LINEARS):.2f}",
          embed_gbytes=f"{part(('embed_tokens',)):.2f}",
          head_gbytes=f"{part(('lm_head',)):.2f}" if "lm_head" in weights else "tied",
          quantize_seconds=f"{seconds:.1f}",
          device_gbytes_allocated=f"{torch.cuda.memory_allocated() / 1e9:.2f}")


class _checked_w8:
    """While active, every weight-only 8-bit linear of the model (the LM head
    included) runs the kernel, the plain version on the same inputs, and the
    kernel once more with a planted fault (the scales shifted by one
    column, or a per-tensor scale doubled). ``stats`` keeps (check of the
    kernel, check of the faulty kernel) per call."""

    def __init__(self):
        self.stats = []

    def __enter__(self):
        from rtp_llm_tpu_torch.models import llama_family
        from rtp_llm_tpu_torch.ops import quant_gemm8 as q8
        from rtp_llm_tpu_torch.ops.quant_gemm import subtract_zero_correction

        def w8(x, w, scale, *, zero_scale=None):
            got = q8.w8_matmul(x, w, scale)
            want = q8.w8_matmul_ref(x, w, scale)
            bad = q8.w8_matmul(x, w, scale.roll(1, dims=-1) if scale.dim() else scale * 2)
            self.stats.append((_check_gemm(got, want), _check_gemm(bad, want)))
            return got if zero_scale is None else subtract_zero_correction(got, x, zero_scale)

        self.module, self.orig = llama_family, llama_family.w8_matmul
        llama_family.w8_matmul = w8
        return self

    def __exit__(self, *exc):
        self.module.w8_matmul = self.orig


class _plain_w8(_checked_w8):
    """While active, the weight-only 8-bit linears take the plain version."""

    def __enter__(self):
        from rtp_llm_tpu_torch.models import llama_family
        from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

        self.module, self.orig = llama_family, llama_family.w8_matmul
        llama_family.w8_matmul = lambda x, w, scale, zero_scale=None: q8.w8_matmul_ref(x, w, scale)
        return self


class _checked_i8(_checked_w8):
    """While active, every W8A8 and W4A8 linear of a prefill takes its
    activation codes from act_quant (held against the plain quantizer, bit
    for bit: ``codes``) and runs i8_gemm, the plain version on the same
    codes, and i8_gemm once more with a planted fault (the scales shifted by
    one column)."""

    def route(self, x, w, scale):
        import torch

        from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

        xq, xs = q8.act_quant(x)
        rq, rs = q8.quantize_activations_ref(x)
        self.codes.append(torch.equal(xq, rq) and torch.equal(xs, rs))
        got = q8.i8_matmul(xq, xs, w, scale, x.dtype)
        want = q8.i8_matmul_ref(xq, xs, w, scale, x.dtype)
        bad = q8.i8_matmul(xq, xs, w, scale.roll(1, dims=-1), x.dtype)
        self.stats.append((_check_gemm(got, want), _check_gemm(bad, want)))
        return got

    def __enter__(self):
        from rtp_llm_tpu_torch.models import llama_family

        def w8a8(x, w, scale, decode=False):
            assert not decode, "the checked forwards are prefills"
            return self.route(x, w, scale)

        self.codes = []
        self.module = llama_family
        self.orig = (llama_family.w8a8_matmul, llama_family.w4a8_matmul)
        llama_family.w8a8_matmul, llama_family.w4a8_matmul = w8a8, self.route
        return self

    def __exit__(self, *exc):
        self.module.w8a8_matmul, self.module.w4a8_matmul = self.orig


class _plain_i8(_checked_i8):
    """While active, the W8A8 and W4A8 linears take the plain versions."""

    def route(self, x, w, scale):
        from rtp_llm_tpu_torch.ops import quant_gemm8 as q8

        xq, xs = q8.quantize_activations_ref(x)
        return q8.i8_matmul_ref(xq, xs, w, scale, x.dtype)


@_stage("phase_model_8bit")
def phase_model_8bit(engine, gen, tag, route="w8"):
    """The packed prefill forwards a served 8-bit engine runs (a lone
    1000-token prompt, a group of four with 2076 real rows) on its weights
    and pool: every 8-bit linear call of ``route`` ("w8": w8_gemm, the int8
    LM head included; "w8a8" / "w4a8": act_quant's codes bit for bit and
    i8_gemm) held against the plain version with a planted fault, and the
    logits against a forward through the plain versions."""
    import torch

    model, cfg = engine.model, engine.model.cfg
    _drain(engine)
    _drop_prefix_cache(engine)
    forms = _prefill_forms(cfg, gen)
    head = int("lm_head.scale" in engine.weights)
    checked, plain = (_checked_w8, _plain_w8) if route == "w8" else (_checked_i8, _plain_i8)
    for form in ("lone_1000", "group_4"):
        inp = forms[form]
        with checked() as checker:
            got = model.forward(engine.weights, engine.kv, inp)[0].logits
        with plain():
            want = model.forward(engine.weights, engine.kv, inp)[0].logits
        torch.cuda.synchronize()
        stats, codes = checker.stats, getattr(checker, "codes", [])
        rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
        ok = (got.shape == (len(inp.row_lens), cfg.vocab_size)
              and bool(torch.isfinite(got).all())
              and len(stats) == 4 * cfg.num_layers + head and all(c[2] for c, _ in stats)
              and all(not f[2] for _, f in stats) and max(rel) <= MODEL_LOGITS_REL_L2
              and all(codes) and len(codes) == (len(stats) if route != "w8" else 0))
        _line("model-8bit", model=cfg.model_type, weights=tag, route=route, form=form,
              linear_m=sum(inp.row_lens), linear_calls_checked=len(stats),
              act_quant_codes_equal=f"{sum(codes)}/{len(codes)}",
              linear_max_abs_err=f"{max(c[0] for c, _ in stats):.3e}",
              linear_max_rel_l2=f"{max(c[1] for c, _ in stats):.3e}", linear_tol=GW_REL_L2,
              planted_fault_min_rel_l2=f"{min(f[1] for _, f in stats):.3e}",
              planted_fault_caught=all(not f[2] for _, f in stats),
              logits_rel_l2="|".join(f"{r:.3e}" for r in rel), logits_tol=MODEL_LOGITS_REL_L2,
              argmax_agree=f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}",
              ok=ok)
        if not ok:
            raise SystemExit(f"8-bit model ({tag}, {form}): the kernels disagree with the "
                             "plain versions at the served rows, or the per-linear check "
                             "missed the planted fault")


# the 4-layer cut of Qwen2-7B served with the grouped fp8 route (W4A8, W8A8
# and int8 are served at full width): (tag, QuantConfig method, its fields,
# route of phase_serve)
Q8_CUTS = (("fp8-block-128", "fp8", {"fp8_block_size": 128}, "w8"),)


def phase_qwen2_8bit(gen, card, layers=4):
    """8-bit weights. Qwen2-7B's seeded bf16 weights, cut to ``layers``
    layers, quantized on the card to fp8 block-128 and served (graphed
    tokens against eager); then the full model to W4A8, groups of 128
    (serve, decode-graph, step-time, ``[model-8bit]`` of its act_quant and
    i8_gemm calls; the engine is released before the next is built and
    rebuilt for the profiler windows), to W8A8 (serve, decode-graph,
    ``[model-8bit]``) and to int8 with the int8 LM head (serve,
    ``[model-8bit]``, decode-graph, step-time), and Qwen2-1.5B to int8
    (BASELINE config 2). Returns ({kernel: launches on its serve path},
    plain-version calls, the largest B of a served prefill attention call,
    {tag: full-width engine}, profiled last)."""
    import dataclasses
    import gc

    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_1_5b_config, qwen2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    cfg = dataclasses.replace(qwen2_7b_config(), num_layers=QWEN2_LAYERS)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 1, QWEN2_NAME)
    launches, plain, b_max = {}, 0, 0
    cut = LlamaFamilyModel(dataclasses.replace(cfg, num_layers=layers), device="cuda")
    whole = ("embed_tokens", "lm_head", "final_norm")
    for tag, method, fields, route in Q8_CUTS:
        t0 = time.time()
        wq = quantize_8bit({n: (t if n in whole else t[:layers]) for n, t in weights.items()},
                           method, **fields)
        torch.cuda.synchronize()
        _weights_line(wq, cut.cfg, f"qwen2-7b-{layers}-layers", tag, time.time() - t0)
        engine, got, p, b = phase_serve(cut, wq, gen, card, tag=tag, q8=route,
                                        follow_up=False)
        phase_decode_graph(engine, cut.cfg, gen, tag, out_tokens=16)
        plain, b_max = plain + p, max(b_max, b)
        del engine, wq
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.time()
    wq = quantize_8bit(weights, "w4a8", group_size=128)
    torch.cuda.synchronize()
    _weights_line(wq, cfg, QWEN2_NAME, "w4a8", time.time() - t0)
    engine, got, p, b = phase_serve(model, wq, gen, card, tag="w4a8", q8="w4a8")
    phase_model_8bit(engine, gen, "w4a8", route="w4a8")
    for n in ("act_quant", "i8_gemm"):  # the attention rows keep the bf16 serve's counts
        launches[n] = launches.get(n, 0) + got[n]
    plain, b_max = plain + p, max(b_max, b)
    del engine, wq
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    wq = quantize_8bit(weights, "w8a8")
    torch.cuda.synchronize()
    _weights_line(wq, cfg, QWEN2_NAME, "w8a8", time.time() - t0)
    engine_w8a8, got, p, b = phase_serve(model, wq, gen, card, tag="w8a8", q8="w8a8",
                                         follow_up=False)
    phase_decode_graph(engine_w8a8, cfg, gen, "w8a8")
    phase_model_8bit(engine_w8a8, gen, "w8a8", route="w8a8")
    for n in ("act_quant", "i8_gemm"):
        launches[n] = launches.get(n, 0) + got[n]
    plain, b_max = plain + p, max(b_max, b)
    del wq

    t0 = time.time()
    wq = quantize_8bit(weights, "int8", head=True)
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    _weights_line(wq, cfg, QWEN2_NAME, "int8-head", quant_s)
    engine7, got, p, b = phase_serve(model, wq, gen, card, tag="int8-head", q8="w8")
    phase_model_8bit(engine7, gen, "int8-head")
    launches["w8_gemm"] = got["w8_gemm"]
    plain, b_max = plain + p, max(b_max, b)

    cfg = qwen2_1_5b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 3, "qwen2-1.5b")
    del weights["lm_head"]  # tied: the forward multiplies by embed_tokens.T
    t0 = time.time()
    wq = quantize_8bit(weights, "int8")
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    _weights_line(wq, cfg, "qwen2-1.5b", "int8", quant_s)
    engine15, got, p, b = phase_serve(model, wq, gen, card, tag="int8", q8="w8",
                                      name="qwen2-1.5b")
    return launches, plain + p, max(b_max, b), {"w8a8": engine_w8a8, "int8-head": engine7,
                                                "int8": engine15}


def phase_profiles(gen, llama_engines, q8_engines):
    """Profiler windows, after everything timed: their hooks slow every
    later launch of the process. The three Llama-3-8B engines (int8 KV
    deferred, int8 KV in-layer, bf16 KV), the full-width 8-bit engines
    (Qwen2-7B W8A8: prefill only, its decode is the int8 engine's w8_gemm;
    Qwen2-7B int8 + int8 head and Qwen2-1.5B int8: decode and prefill), then
    Qwen2-7B, its weights drawn again from their seed: W4A8 (decode graphed
    and prefill; quantized again, its served engine was released), the two
    int4 engines and bf16."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    deferred, int8, bf16 = (phase_profile(engine, engine.model.cfg, gen, "int4")
                            for engine in llama_engines)
    for engine in llama_engines:
        phase_profile(engine, engine.model.cfg, gen, "int4", mode="graph")
    phase_profile_prefill(llama_engines[0], gen, "int4")
    layers = llama_engines[0].model.cfg.num_layers
    # what the quantize-and-write ops (plain PyTorch) add to a decode step
    _line("kv-write-launches", model=LLAMA_NAME, layers=layers,
          bf16_in_layer_per_step=f"{bf16:.0f}", int8_in_layer_per_step=f"{int8:.0f}",
          int8_deferred_per_step=f"{deferred:.0f}",
          int8_in_layer_over_bf16_per_layer=f"{(int8 - bf16) / layers:.1f}",
          int8_deferred_over_bf16_per_step=f"{deferred - bf16:.0f}")
    llama_engines.clear()
    for tag, engine in q8_engines.items():
        for mode in ("eager", "graph") if tag != "w8a8" else ():
            phase_profile(engine, engine.model.cfg, gen, tag, mode=mode)
        phase_profile_prefill(engine, gen, tag)
    q8_engines.clear()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(qwen2_7b_config(), num_layers=QWEN2_LAYERS)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 1, QWEN2_NAME)
    engine = make_engine(model, quantize_8bit(weights, "w4a8", group_size=128))
    phase_profile(engine, cfg, gen, "w4a8", mode="graph")
    phase_profile_prefill(engine, gen, "w4a8")
    del engine
    torch.cuda.empty_cache()
    wq, _ = _to_gptq_form(model, weights)
    for gemm in ("pipe", "base"):
        engine = make_engine(model, wq, gemm=gemm)
        phase_profile(engine, cfg, gen, "int4")
        phase_profile(engine, cfg, gen, "int4", mode="graph")
        phase_profile_prefill(engine, gen, "int4")
        del engine
    model.gemm_variant = "base"
    del wq
    engine = make_engine(model, weights)
    phase_profile(engine, cfg, gen, "bf16")
    phase_profile(engine, cfg, gen, "bf16", mode="graph")
    phase_profile_prefill(engine, gen, "bf16")



# ---------------------------------------------------------------- the llama
# families, sliding-window recycling, GPTQ act-order and the head_dim 64 / 96
# modes of the attention kernels

# (model, D, Hq, Hkv, window, timed) of the [head-dim] checks: the heads of
# the served models, Qwen2-0.5B (G = 7; a window of 1000 checked beside
# none), Phi-3-mini (MHA, its 2047-token window), Gemma-2-9B (D 256, G = 2,
# its 4096-token window) and Gemma-7B (D 256, MHA: G = 1), and two that
# check the soft-cap and the group's range: Gemma-2-27B's (D 128, 32 / 16)
# and a D 256 group of 8 (16 / 2); last Phi-2's (D 80, MHA; no window of its
# own: 1000 checked beside none). ``timed``: [head-dim-time] lines.
HEAD_DIM_CASES = (("qwen2_0_5b", 64, 14, 2, 1000, True), ("phi3_mini", 96, 32, 32, 2047, True),
                  ("gemma2_27b", 128, 32, 16, 4096, True),
                  ("gemma2_9b", 256, 16, 8, 4096, True), ("gemma_7b", 256, 16, 16, 4096, True),
                  ("d256_g8", 256, 16, 2, 4096, False), ("phi_2", 80, 32, 32, 1000, True))
HD_KINDS = ("bf16", "int8", "e4m3")
# decode contexts; a case whose window exceeds the longest adds one past it
HD_DECODE_LENS = (0, 1, 63, 64, 65, 2047, 2048, 3000)
# prefill rows: (T, q_offsets, kv_lens): one from 0, one behind a 37-token
# prefix, one behind 1000 tokens whose last live key ends inside a tile (a
# case from D 128 up whose window exceeds 1000: behind window - 100 tokens)
HD_PREFILL = (300, (0, 37, 1000), (300, 337, 1250))
# the timed shapes: a decode batch of 64 rows of 2048 tokens, a 2048-token
# prompt; at D 80 and 256 also 8 rows of 8192 (split over KV)
HD_TIME_DECODE_ROWS, HD_TIME_CTX = 64, 2048
HD_TIME_LONG, HD_TIME_LONG_DIMS = (8, 8192), (80, 256)
# faults built into each attention source, checked at every case's D: S's
# last k16 step left out (checked uncapped), the soft-cap's tanh left out
# (checked capped)
HD_FAULTS = (("decode", "paged_decode.cu", "s_last_k_step_left_out", "PD_FAULT=4"),
             ("prefill", "paged_prefill.cu", "s_last_k_step_left_out", "PP_FAULT=1"),
             ("decode", "paged_decode.cu", "soft_cap_tanh_left_out", "PD_FAULT=5"),
             ("prefill", "paged_prefill.cu", "soft_cap_tanh_left_out", "PP_FAULT=2"))
# the capped checks: a cap of 5 with queries scaled by 4, so that scores of
# random rows (about N(0, 16) after sm_scale) reach several times the cap
# and the tanh bends them (random weights would hardly meet Gemma-2's 50)
HD_CAP, HD_CAP_Q_SCALE = 5.0, 4.0
# the cases after the first two (D 64, 96) draw from a generator of their
# own, so that the shared one reaches the later phases in the state it did
# before they came ([controls]' trie check holds on those phases' prompts:
# ROADMAP / PERF.md)
HD_SHARED_GEN_CASES, HD_OWN_SEED = ("qwen2_0_5b", "phi3_mini"), 20
# [mistral-swa]: 8 streams of 4500-6000 prompt tokens, 256 out; the pool of
# each engine holds them all without recycling
SWA_ROWS, SWA_PROMPTS, SWA_OUT, SWA_BLOCKS = 8, (4500, 6000), 256, 800
# [phi3]: 8 streams whose prompts cross the 2047-token window
PHI3_ROWS, PHI3_PROMPTS, PHI3_OUT, PHI3_BLOCKS = 8, (2100, 3000), 64, 512
# [qwen2-0.5b]: 64 streams, every decode slot
QWEN05_ROWS, QWEN05_PROMPTS, QWEN05_OUT = 64, (100, 900), 32
# served logprobs against a teacher-forced plain-attention forward, and the
# served greedy token equal to the teacher's best wherever the teacher's
# top-2 gap exceeds 2 x TEACHER_TOL (a decisive position: the served errors
# at both tokens cannot swap them); over TEACHER_ROWS rows a model. bf16
# activations through 24-32 layers: the Qwen2-7B engines' served logprobs
# sat 0.036-0.19 nats from such a forward in [beam] / [lora] (PERF.md
# section 7) at 1000-token contexts; these reach 6256
TEACHER_TOL, TEACHER_ROWS, TEACHER_CHUNK = 0.25, 2, 1024
FAMILY_LAYERS_CUT = 4
# [gemma2]: 8 decode slots (each slot's rings take 2.1 GB at the 8192-token
# prefill span), 8 prompts of 500-6000 tokens (four past the 4096 window),
# 32 tokens out, and a lone 1000-token prompt for TTFT; [gemma]: 8 prompts
GEMMA2_SLOTS, GEMMA2_OUT, GEMMA2_BLOCKS = 8, 32, 800
GEMMA2_PROMPTS = (500, 1200, 2600, 3900, 4500, 5100, 5600, 6000)
GEMMA_LONE = 1000
GEMMA_ROWS, GEMMA_PROMPTS, GEMMA_OUT, GEMMA_BLOCKS = 8, (300, 1500), 32, 256


def _hd_pools(gen, kind, nblocks, hkv, d, bt, lens):
    """(k, v, scale kwargs) of a pool of ``kind`` for the plain version, and
    the same for the kernel: there every slot no live key maps to holds NaN
    (int8: its scales)."""
    import torch

    shape = (nblocks * BS, hkv * d)
    kb = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    vb = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    if kind != "bf16":
        k, v, plain_kw, kernel_kw = _quantized_pools(kb, vb, hkv, bt, lens, d)[kind]
        if kind == "int8":
            return (k, v, plain_kw), (k, v, kernel_kw)
        kb, vb = k, v
    kp, vp = _poison_dead_slots(kb, vb, bt, lens)
    return (kb, vb, {}), (kp, vp, {})


def _hd_sdpa(q, k, v, bt, q_pos, kv_lens, hkv, d, alibi=None):
    """F.scaled_dot_product_attention over the gathered rows of a bf16 pool:
    query rows at positions ``q_pos`` [B, T], causal below ``kv_lens``; with
    ``alibi`` slopes [Hq] the mask is the float bias ``slope * (p - q_pos)``,
    -inf where masked."""
    import torch

    b, mb = bt.shape
    s = mb * BS
    idx = (bt.long()[:, :, None] * BS + torch.arange(BS, device="cuda")).reshape(b, s)
    kk = k[idx].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    vv = v[idx].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    kpos = torch.arange(s, device="cuda")[None, None, :]
    mask = (kpos <= q_pos[:, :, None]) & (kpos < kv_lens.long()[:, None, None])
    mask = mask[:, None]
    if alibi is not None:  # [B, Hq, T, S]
        rel = (kpos - q_pos[:, :, None]).float()[:, None]
        bias = alibi.float()[None, :, None, None] * rel
        mask = torch.where(mask, bias, torch.full_like(bias, float("-inf"))).to(q.dtype)
    return _sdpa_call(q.transpose(1, 2).contiguous(), kk, vv, mask)


@functools.lru_cache(maxsize=None)
def _hd_fault_kernels():
    """{(op, fault name, pool kind, D): the entry built with that fault}."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    import torch

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    out = {}
    for op, src, name, define in HD_FAULTS:
        mod = decode if op == "decode" else prefill
        for kind, dt in dtypes.items():
            for d in sorted({case[1] for case in HEAD_DIM_CASES}):
                k = mod.KERNELS_BY_DIM[(dt, d)]
                out[(op, name, kind, d)] = _kernels.Kernel(f"{k.name}:{name}", src, k.entry,
                                                           mod._ARGTYPES, defines=(define,))
    return out


@contextlib.contextmanager
def _entry_swapped(op, dtype, kernel, d):
    """``op``'s wrapper launches ``kernel`` (a build with a planted fault)
    for pool ``dtype`` at head width ``d`` (D 128: through ``KERNELS``,
    which ``kernel_for`` reads there)."""
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    mod = decode if op == "decode" else prefill
    table = mod.KERNELS if d == mod.HEAD_DIM else mod.KERNELS_BY_DIM
    key = dtype if d == mod.HEAD_DIM else (dtype, d)
    saved = table[key]
    table[key] = kernel
    try:
        yield
    finally:
        table[key] = saved


def _hd_fault(op, name, dtype, kind, d):
    """``op``'s wrapper launches the build with fault ``name`` for pool
    ``dtype`` at head width ``d``."""
    return _entry_swapped(op, dtype, _hd_fault_kernels()[(op, name, kind, d)], d)


def _hd_decode_time(gen, kind, d, hq, hkv, rows, ctx, cap, alibi=None):
    """[head-dim-time] of one decode entry: ``rows`` rows of ``ctx`` tokens
    (no window; capped at ``cap`` when > 0, queries scaled as in the capped
    checks; ALiBi under ``alibi`` slopes), a replayed graph of 8 calls,
    beside its plain version, SDPA on the same rows (uncapped: the
    yardstick; ALiBi as a float mask) and the bytes bound (ALiBi adds no
    bytes)."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.decode import paged_decode_attention, paged_decode_ref

    sm = d ** -0.5
    tl = [ctx] * rows
    tlens = torch.tensor(tl, dtype=torch.int32, device="cuda")
    tbt, tnb = _tables(tl, _kv_bucket_blocks(ctx), gen)
    (pk, pv, pkw), _ = _hd_pools(gen, kind, tnb, hkv, d, tbt, tlens)
    tq = torch.randn((rows, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    if cap:
        tq = (tq.float() * HD_CAP_Q_SCALE).to(torch.bfloat16)
    run = lambda: paged_decode_attention(tq, pk, pv, tbt, tlens, sm, BS, soft_cap=cap,
                                         alibi_slopes=alibi, **pkw)
    plain = lambda: paged_decode_ref(tq, pk, pv, tbt, tlens, sm, BS, soft_cap=cap,
                                     alibi_slopes=alibi, **pkw)
    dk, dv = _dequant_pair(pk, pv, pkw, hkv, d)
    lib = _hd_sdpa(tq[:, None], dk, dv, tbt, (tlens.long() - 1)[:, None], tlens, hkv, d, alibi)
    ms, device_ms, plain_ms, lib_ms = _decode_times(run, plain, lib)
    ntok = float(sum(tl))
    elem = 2 if kind == "bf16" else 1
    nbytes = (ntok * 2 * hkv * d * elem + (ntok * 2 * hkv * 2 if kind == "int8" else 0)
              + 2 * rows * hq * d * 2 + tbt.numel() * 4)
    bound, by = _bound_ms(nbytes, 4.0 * ntok * hq * d)
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, ntok=int(ntok))


def _hd_prefill_time(gen, kind, d, hq, hkv, tt, cap, alibi=None, off=0):
    """[head-dim-time] of one prefill entry: one ``tt``-token prompt (no
    window; capped at ``cap`` when > 0; ALiBi under ``alibi``) behind ``off``
    cached tokens, beside its plain version, SDPA and the operations
    bound."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.prefill import (
        paged_prefill_attention, paged_prefill_ref,
    )

    sm = d ** -0.5
    tbt, tnb = _tables([off + tt], -(-(off + tt) // BS), gen)
    toffs = torch.full((1,), off, dtype=torch.int32, device="cuda")
    tlens = torch.full((1,), off + tt, dtype=torch.int32, device="cuda")
    (pk, pv, pkw), _ = _hd_pools(gen, kind, tnb, hkv, d, tbt, tlens)
    tq = torch.randn((1, tt, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    if cap:
        tq = (tq.float() * HD_CAP_Q_SCALE).to(torch.bfloat16)
    run = lambda: paged_prefill_attention(tq, pk, pv, tbt, toffs, tlens, sm, BS, soft_cap=cap,
                                          alibi_slopes=alibi, **pkw)
    plain = lambda: paged_prefill_ref(tq, pk, pv, tbt, toffs, tlens, sm, BS, soft_cap=cap,
                                      alibi_slopes=alibi, **pkw)
    dk, dv = _dequant_pair(pk, pv, pkw, hkv, d)
    lib = _hd_sdpa(tq, dk, dv, tbt, off + torch.arange(tt, device="cuda")[None], tlens, hkv, d,
                   alibi)
    ms, plain_ms, lib_ms = _time_ms(run), _time_ms(plain, iters=3, warmup=1), _time_ms(lib)
    pairs = tt * off + tt * (tt + 1) / 2
    elem = 2 if kind == "bf16" else 1
    ntok = off + tt
    nbytes = (ntok * 2 * hkv * d * elem + (ntok * 2 * hkv * 2 if kind == "int8" else 0)
              + 2 * tt * hq * d * 2 + tbt.numel() * 4)
    bound, by = _bound_ms(nbytes, 4.0 * pairs * hq * d)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def _decode_checks(gen, tag, model, d, hq, hkv, window, kind, caps, fault, alibi=None):
    """The decode entry of pool ``kind`` at heads (``hq``, ``hkv``) and
    width ``d`` against its plain version, tolerance as ``_check``: rows of
    ``HD_DECODE_LENS`` tokens (and one past the window), with and without
    the window and the deferred current token, for each cap of ``caps``
    (queries scaled by ``HD_CAP_Q_SCALE`` when capped), on a pool whose dead
    slots hold NaN (int8: its scales). ``fault(cap)`` gives (name, context
    under which the wrapper launches a build with that planted fault), run
    with the window, which must fail the check (None: none). ``alibi``:
    slopes [Hq] in every call. Returns the largest error."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.decode import paged_decode_attention, paged_decode_ref

    sm = d ** -0.5
    lens_l = list(HD_DECODE_LENS) + ([window + 904] if window > max(HD_DECODE_LENS) else [])
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    bt, nblocks = _tables(lens_l, _kv_bucket_blocks(max(lens_l)), gen)
    plain_pool, kernel_pool = _hd_pools(gen, kind, nblocks, hkv, d, bt, lens)
    q0 = torch.randn((len(lens_l), hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    ck = torch.randn((len(lens_l), hkv * d), generator=gen, device="cuda", dtype=torch.bfloat16)
    cv = torch.randn_like(ck)
    worst = 0.0
    for cap in caps:
        q = (q0.float() * HD_CAP_Q_SCALE).to(torch.bfloat16) if cap else q0
        for win in sorted({0, window}):
            for cur in (False, True):
                kw = dict(sliding_window=win, cur_k=ck if cur else None,
                          cur_v=cv if cur else None, soft_cap=cap, alibi_slopes=alibi)
                got = paged_decode_attention(q, *kernel_pool[:2], bt, lens, sm, BS, **kw,
                                             **kernel_pool[2])
                want = paged_decode_ref(q, *plain_pool[:2], bt, lens, sm, BS, **kw,
                                        **plain_pool[2])
                torch.cuda.synchronize()
                err, rel, ok = _check(got, want)
                ok = ok and bool((got[lens == 0] == 0).all())
                _line(tag, op="decode", model=model, D=d, G=hq // hkv, Hq=hq, Hkv=hkv, pool=kind,
                      window=win, cur=cur, soft_cap=cap, alibi=alibi is not None,
                      max_abs_err=f"{err:.3e}",
                      max_rel_l2=f"{rel:.3e}", ok=ok)
                if not ok:
                    raise SystemExit(f"{tag}: decode D={d} G={hq // hkv} {kind} disagrees with "
                                     f"plain (window={win}, cur={cur}, cap={cap})")
                worst = max(worst, err)
        if fault is None:
            continue
        name, planted = fault(cap)
        want = paged_decode_ref(q, *plain_pool[:2], bt, lens, sm, BS, sliding_window=window,
                                soft_cap=cap, alibi_slopes=alibi, **plain_pool[2])
        with planted:
            bad = paged_decode_attention(q, *kernel_pool[:2], bt, lens, sm, BS,
                                         sliding_window=window, soft_cap=cap,
                                         alibi_slopes=alibi, **kernel_pool[2])
        _planted(f"{tag}-fault", [(f"decode_D{d}_G{hq // hkv}_{kind}:{name}", bad, want)])
    return worst


def _prefill_checks(gen, tag, model, d, hq, hkv, window, kind, caps, fault, own_rows,
                    alibi=None, rows=HD_PREFILL):
    """The prefill entry of pool ``kind`` against its plain version: rows
    ``HD_PREFILL`` (with ``own_rows`` and a window past 1000 tokens, the
    last row's prefix moved past the window), with and without the window,
    each cap of ``caps``, padded rows exact zeros; the planted fault of
    ``fault(cap)`` must fail the check (None: none). ``alibi``: slopes [Hq]
    in every call; ``rows``: another (T, q_offsets, kv_lens). Returns the
    largest error."""
    import torch

    from rtp_llm_tpu_torch.ops.attention.prefill import (
        paged_prefill_attention, paged_prefill_ref,
    )

    sm = d ** -0.5
    t, offs_l, lens_l = rows
    if own_rows and window > offs_l[-1]:  # the last row's prefix past the window
        offs_l = offs_l[:-1] + (window - 100,)
        lens_l = lens_l[:-1] + (window + 150,)
    offs = torch.tensor(offs_l, dtype=torch.int32, device="cuda")
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    mb = -(-max(o + t for o in offs_l) // BS) + 1
    bt, nblocks = _tables([o + t for o in offs_l], mb, gen)
    plain_pool, kernel_pool = _hd_pools(gen, kind, nblocks, hkv, d, bt, lens)
    q0 = torch.randn((len(offs_l), t, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    worst = 0.0
    for cap in caps:
        q = (q0.float() * HD_CAP_Q_SCALE).to(torch.bfloat16) if cap else q0
        for win in sorted({0, window}):
            got = paged_prefill_attention(q, *kernel_pool[:2], bt, offs, lens, sm, BS,
                                          sliding_window=win, soft_cap=cap, alibi_slopes=alibi,
                                          **kernel_pool[2])
            want = paged_prefill_ref(q, *plain_pool[:2], bt, offs, lens, sm, BS,
                                     sliding_window=win, soft_cap=cap, alibi_slopes=alibi,
                                     **plain_pool[2])
            torch.cuda.synchronize()
            err, rel, ok = _check(got, want)
            zeros = _padded_rows_zero(got, t, offs, lens)
            ok = ok and zeros
            _line(tag, op="prefill", model=model, D=d, G=hq // hkv, Hq=hq, Hkv=hkv, pool=kind, T=t,
                  q_offsets=",".join(map(str, offs_l)), window=win, soft_cap=cap,
                  alibi=alibi is not None, max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}",
                  padded_rows_zero=zeros, ok=ok)
            if not ok:
                raise SystemExit(f"{tag}: prefill D={d} G={hq // hkv} {kind} disagrees with "
                                 f"plain (window={win}, cap={cap})")
            worst = max(worst, err)
        if fault is None:
            continue
        name, planted = fault(cap)
        with planted:
            bad = paged_prefill_attention(q, *kernel_pool[:2], bt, offs, lens, sm, BS,
                                          sliding_window=window, soft_cap=cap,
                                          alibi_slopes=alibi, **kernel_pool[2])
        _planted(f"{tag}-fault", [(f"prefill_D{d}_G{hq // hkv}_{kind}:{name}", bad, want)])
    return worst


def phase_head_dim(gen):
    """``[head-dim]``: the decode and prefill entries of each pool type at
    the heads of ``HEAD_DIM_CASES`` (D 64, 80, 96, 128 and 256; G 1, 2, 7, 8)
    against their plain versions, tolerance as ``_check`` (the decode and
    prefill phases'): decode rows of ``HD_DECODE_LENS`` tokens (and one past
    the window) with and without the window and the deferred current token,
    prefill rows ``HD_PREFILL`` with and without the window, each uncapped
    and under a soft-cap of ``HD_CAP`` (queries scaled by
    ``HD_CAP_Q_SCALE``), a pool whose dead slots hold NaN (int8: its
    scales). The builds with a planted fault (``HD_FAULTS``: S without its
    last k16 step, checked uncapped; the cap's tanh left out, checked
    capped) must fail the same check. Times of the timed cases: decode at B
    64 x 2048 tokens (a replayed graph of 8 calls), at D 80 and 256 also
    B 8 x 8192, capped and not (D 80 uncapped); prefill of one 2048-token prompt; each beside its
    plain version, SDPA on the same rows (uncapped; a quantized pool
    dequantized first) and its bound; D 128 and 256 capped too. Returns
    {(op, kind, D): record} of the D 64 / 80 / 96 / 256 entries (the first timed
    case of a width; D 256: Gemma-2-9B's heads, capped, the served mode) and
    every timing line's record by (model, op, kind, shape, cap)."""
    import torch

    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    t0 = time.time()
    records, times = {}, {}
    own = torch.Generator(device="cuda")
    own.manual_seed(HD_OWN_SEED)
    shared = gen
    for model, d, hq, hkv, window, timed in HEAD_DIM_CASES:
        gen = shared if model in HD_SHARED_GEN_CASES else own
        for kind in HD_KINDS:
            def faults(cap, op="decode", kind=kind, d=d):
                name = "soft_cap_tanh_left_out" if cap else "s_last_k_step_left_out"
                return name, _hd_fault(op, name, dtypes[kind], kind, d)

            # ---- decode
            worst = _decode_checks(gen, "head-dim", model, d, hq, hkv, window, kind,
                                   (0.0, HD_CAP), faults)
            if timed:
                shapes = [(HD_TIME_DECODE_ROWS, HD_TIME_CTX)] + (
                    [HD_TIME_LONG] if d in HD_TIME_LONG_DIMS else [])
                for rows, ctx in shapes:
                    for cap in ((0.0, HD_CAP) if d >= 128 else (0.0,)):
                        r = _hd_decode_time(gen, kind, d, hq, hkv, rows, ctx, cap)
                        _line("head-dim-time", op="decode", model=model, D=d, pool=kind, B=rows,
                              ctx_tokens=r["ntok"], soft_cap=cap, ms=f"{r['ms']:.4f}",
                              device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                              library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                              bound_by=r["bound_by"],
                              share_of_bound=f"{r['bound_ms'] / r['device_ms']:.2f}")
                        rec = dict(ms=r["device_ms"], plain_ms=r["plain_ms"],
                                   library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                   bound_by=r["bound_by"], max_abs_err=worst)
                        times[(model, "decode", kind, (rows, ctx), cap)] = rec
                        if (d != 128 and (rows, ctx) == (HD_TIME_DECODE_ROWS, HD_TIME_CTX)
                                and (d != 256 or cap)):
                            records.setdefault(("decode", kind, d), rec)

            # ---- prefill
            worst = _prefill_checks(gen, "head-dim", model, d, hq, hkv, window, kind,
                                    (0.0, HD_CAP), lambda cap: faults(cap, "prefill"),
                                    own_rows=gen is own)
            if timed:
                for cap in ((0.0, HD_CAP) if d >= 128 else (0.0,)):
                    r = _hd_prefill_time(gen, kind, d, hq, hkv, HD_TIME_CTX, cap)
                    _line("head-dim-time", op="prefill", model=model, D=d, pool=kind,
                          T=HD_TIME_CTX, soft_cap=cap, ms=f"{r['ms']:.4f}",
                          plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['library_ms']:.4f}",
                          bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
                          share_of_bound=f"{r['bound_ms'] / r['ms']:.2f}")
                    rec = dict(r, max_abs_err=worst)
                    times[(model, "prefill", kind, HD_TIME_CTX, cap)] = rec
                    if d != 128 and (d != 256 or cap):
                        records.setdefault(("prefill", kind, d), rec)
    _line("head-dim", seconds=f"{time.time() - t0:.1f}")
    return records, times


# (model, Hq, Hkv, window) of the [group] checks at D 128: StarCoder2-7B's
# 36 / 4 (G 9, its 4096-token window), Command R+'s 96 / 8 (G 12) and
# Llama-3.1-405B's 128 / 8 (G 16: two full n8 tiles)
GROUP_CASES = (("starcoder2_7b", 36, 4, 4096), ("command_r_plus", 96, 8, 0),
               ("llama3_405b", 128, 8, 0))
# the timed shapes: K1 at 64 rows of 2048 tokens, K2 at 8 rows of 8192, K3
# one 2048-token prompt
GROUP_DECODE_SHAPES = ((64, 2048), (8, 8192))
# faults built into each source: the second head tile's scores left out
# (decode), the query rows of heads past the eighth staged as zeros (prefill)
GROUP_FAULTS = (("decode", "paged_decode.cu", "second_head_tile_left_out", "PD_FAULT=6"),
                ("prefill", "paged_prefill.cu", "heads_past_8_left_out", "PP_FAULT=3"))
GROUP_SEED = 22  # the phase's own generator: the shared one reaches later phases as before


@functools.lru_cache(maxsize=None)
def _group_fault_kernels():
    """{(op, pool kind): the D 128 entry built with the op's group fault}."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    import torch

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    out = {}
    for op, src, name, define in GROUP_FAULTS:
        mod = decode if op == "decode" else prefill
        for kind, dt in dtypes.items():
            k = mod.KERNELS[dt]
            out[(op, kind)] = _kernels.Kernel(f"{k.name}:{name}", src, k.entry, mod._ARGTYPES,
                                              defines=(define,))
    return out


@contextlib.contextmanager
def _group_fault(op, dtype, kind):
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    mod = decode if op == "decode" else prefill
    saved = mod.KERNELS[dtype]
    mod.KERNELS[dtype] = _group_fault_kernels()[(op, kind)]
    try:
        yield
    finally:
        mod.KERNELS[dtype] = saved


def _ptxas_by_kernel(lib):
    """(kernel instance, registers, spill stores, spill loads) of each
    ``__global__`` function in a library's ptxas log, the mangled name cut
    to its template arguments."""
    out, name, spill = [], None, ("?", "?")
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            for marker in ("paged_decode_kernel", "paged_prefill_kernel", "paged_decode_combine"):
                if marker in name:
                    name = marker + name.split(marker, 1)[1].split("EEv")[0] + "E"
        elif "spill stores" in ln:
            parts = ln.replace(",", "").split()
            spill = (parts[parts.index("stores") - 3], parts[parts.index("loads") - 3])
        elif "Used " in ln and name:
            out.append((name, int(ln.split("Used ")[1].split(" registers")[0])) + spill)
            name, spill = None, ("?", "?")
    return out


def phase_group():
    """``[group]``: the D 128 entries of each pool type at groups of 9-16
    query heads (``GROUP_CASES``; decode takes two n8 head tiles, prefill
    10-14 tokens a block) against their plain versions, uncapped, as
    ``[head-dim]`` checks its widths (``_decode_checks``,
    ``_prefill_checks``); the builds with a planted fault (``GROUP_FAULTS``)
    must fail the same check. Times: K1 at 64 rows x 2048, K2 at 8 x 8192
    (a replayed graph of 8 calls), K3 at T 2048, each beside its plain
    version, SDPA on the same (dequantized) rows and its bound (bytes /
    operations). ptxas registers and spills of each decode kernel instance.
    Returns {(op, kind): record} at StarCoder2-7B's heads (K1 64 x 2048, K3
    2048), and every timing's record by (model, op, kind, shape)."""
    import torch

    from rtp_llm_tpu_torch.ops.attention import decode
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    t0 = time.time()
    for lib in {id(k.lib): k.lib for k in decode.KERNELS_BY_DIM.values()}.values():
        for name, regs, stores, loads in _ptxas_by_kernel(lib):
            _line("ptxas-entry", kernel=name, registers=regs, spill_stores=stores,
                  spill_loads=loads)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GROUP_SEED)
    records, times = {}, {}
    for model, hq, hkv, window in GROUP_CASES:
        g = hq // hkv
        for kind in HD_KINDS:
            def faults(cap, op, kind=kind):
                name = GROUP_FAULTS[0 if op == "decode" else 1][2]
                return name, _group_fault(op, dtypes[kind], kind)

            worst = _decode_checks(gen, "group", model, D, hq, hkv, window, kind, (0.0,),
                                   lambda cap: faults(cap, "decode"))
            for rows, ctx in GROUP_DECODE_SHAPES:
                r = _hd_decode_time(gen, kind, D, hq, hkv, rows, ctx, 0.0)
                _line("group-time", op="decode", model=model, G=g, pool=kind, B=rows,
                      ctx_tokens=r["ntok"], ms=f"{r['ms']:.4f}",
                      device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                      library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                      bound_by=r["bound_by"],
                      share_of_bound=f"{r['bound_ms'] / r['device_ms']:.2f}")
                rec = dict(ms=r["device_ms"], plain_ms=r["plain_ms"],
                           library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                           bound_by=r["bound_by"], max_abs_err=worst)
                times[(model, "decode", kind, (rows, ctx))] = rec
                if (rows, ctx) == GROUP_DECODE_SHAPES[0]:
                    records.setdefault(("decode", kind), rec)

            worst = _prefill_checks(gen, "group", model, D, hq, hkv, window, kind, (0.0,),
                                    lambda cap: faults(cap, "prefill"), own_rows=True)
            r = _hd_prefill_time(gen, kind, D, hq, hkv, HD_TIME_CTX, 0.0)
            _line("group-time", op="prefill", model=model, G=g, pool=kind, T=HD_TIME_CTX,
                  ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                  library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                  bound_by=r["bound_by"], share_of_bound=f"{r['bound_ms'] / r['ms']:.2f}")
            rec = dict(r, max_abs_err=worst)
            times[(model, "prefill", kind, HD_TIME_CTX)] = rec
            records.setdefault(("prefill", kind), rec)
    _line("group", seconds=f"{time.time() - t0:.1f}")
    return records, times


# (model, D, Hq, Hkv, timed) of the [group-wide] checks: Falcon-40B's 128 / 8
# heads (G 16 at D 64: two n8 tiles, one chunk), StarCoderBase-7B's 32 and
# StarCoder's 48 query heads on one kv head (D 128: two and three chunks of
# 16) and Falcon-7B's 71 on one (D 64: four chunks of 16 and one of 7)
GROUP_WIDE_CASES = (("falcon_40b", 64, 128, 8, True), ("starcoderbase_7b", 128, 32, 1, False),
                    ("starcoder_15b", 128, 48, 1, True), ("falcon_7b", 64, 71, 1, True))
# faults built into each source for the head-chunk mode: the last chunk of
# a wide group reads (decode) or stages (prefill) the first chunk's queries;
# a group of 16 (one chunk) takes the two-tile faults of [group] at D 64
GROUP_WIDE_FAULTS = (("decode", "paged_decode.cu", "last_chunk_reads_first_chunk_queries",
                      "PD_FAULT=8"),
                     ("prefill", "paged_prefill.cu", "last_chunk_stages_first_chunk_queries",
                      "PP_FAULT=5"))
GROUP_WIDE_SEED = 31  # the phase's own generator: the shared one reaches later phases as before


@functools.lru_cache(maxsize=None)
def _group_wide_fault_kernels():
    """{(op, pool kind, D, chunked): the entry built with the op's fault}:
    the head-chunk faults (``GROUP_WIDE_FAULTS``) and, for a group of 16,
    [group]'s two-tile faults (``GROUP_FAULTS``, the same libraries) at the
    widths of ``GROUP_WIDE_CASES``."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    import torch

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    out = {}
    for chunked, faults in ((True, GROUP_WIDE_FAULTS), (False, GROUP_FAULTS)):
        for op, src, name, define in faults:
            mod = decode if op == "decode" else prefill
            for kind, dt in dtypes.items():
                for d in sorted({case[1] for case in GROUP_WIDE_CASES}):
                    k = mod.KERNELS_BY_DIM[(dt, d)]
                    out[(op, kind, d, chunked)] = (name, _kernels.Kernel(
                        f"{k.name}:{name}", src, k.entry, mod._ARGTYPES, defines=(define,)))
    return out


def phase_group_wide():
    """``[group-wide]``: the decode and prefill entries of each pool type at
    the wide groups of ``GROUP_WIDE_CASES`` (G 16 at D 64; G 32, 48 at D
    128 and 71 at D 64 in chunks of 16 heads) against their plain versions,
    uncapped, as ``[head-dim]`` checks its widths: decode rows of
    ``HD_DECODE_LENS`` tokens (the 3000-token row splits over KV: K2) with
    and without a 1000-token window and the deferred current token, prefill
    rows ``HD_PREFILL`` (offsets 0, 37, 1000) with and without the window,
    pools whose dead slots hold NaN. The builds with a planted fault
    (``GROUP_WIDE_FAULTS`` past 16 heads, ``GROUP_FAULTS`` at 16) must fail
    the same check. Times of the served heads: K1 at 64 rows x 2048, K2 at 8
    x 8192 (a replayed graph of 8 calls), K3 at T 2048, each beside its
    plain version, SDPA on the same (dequantized) rows and its bound (the
    bytes each input read once: a chunk's second read of a strip is not
    counted). Returns ({(op, kind): record} at StarCoder's heads (K1 64 x
    2048, K3 2048), {(model, op, kind, shape): record} of every timing)."""
    import torch

    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GROUP_WIDE_SEED)
    records, times = {}, {}
    for model, d, hq, hkv, timed in GROUP_WIDE_CASES:
        g = hq // hkv
        for kind in HD_KINDS:
            def faults(cap, op, kind=kind, d=d, g=g):
                name, kernel = _group_wide_fault_kernels()[(op, kind, d, g > 16)]
                return name, _entry_swapped(op, dtypes[kind], kernel, d)

            worst = _decode_checks(gen, "group-wide", model, d, hq, hkv, 1000, kind, (0.0,),
                                   lambda cap: faults(cap, "decode"))
            worst_p = _prefill_checks(gen, "group-wide", model, d, hq, hkv, 1000, kind, (0.0,),
                                      lambda cap: faults(cap, "prefill"), own_rows=True)
            if not timed:
                continue
            for rows, ctx in GROUP_DECODE_SHAPES:
                r = _hd_decode_time(gen, kind, d, hq, hkv, rows, ctx, 0.0)
                _line("group-wide-time", op="decode", model=model, D=d, G=g, pool=kind, B=rows,
                      ctx_tokens=r["ntok"], ms=f"{r['ms']:.4f}",
                      device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                      library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                      bound_by=r["bound_by"],
                      share_of_bound=f"{r['bound_ms'] / r['device_ms']:.2f}")
                rec = dict(ms=r["device_ms"], plain_ms=r["plain_ms"],
                           library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                           bound_by=r["bound_by"], max_abs_err=worst)
                times[(model, "decode", kind, (rows, ctx))] = rec
                if model == "starcoder_15b" and (rows, ctx) == GROUP_DECODE_SHAPES[0]:
                    records[("decode", kind)] = rec
            r = _hd_prefill_time(gen, kind, d, hq, hkv, HD_TIME_CTX, 0.0)
            _line("group-wide-time", op="prefill", model=model, D=d, G=g, pool=kind,
                  T=HD_TIME_CTX, ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                  library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                  bound_by=r["bound_by"], share_of_bound=f"{r['bound_ms'] / r['ms']:.2f}")
            rec = dict(r, max_abs_err=worst_p)
            times[(model, "prefill", kind, HD_TIME_CTX)] = rec
            if model == "starcoder_15b":
                records[("prefill", kind)] = rec
    _line("group-wide", seconds=f"{time.time() - t0:.1f}")
    return records, times


def _attention_counters():
    """Every attention entry (and each pool type's count at groups of 9-16
    heads and in the head-chunk mode, and each entry's count in ALiBi mode,
    in the same form), and the plain version's counter."""
    import types

    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS, decode, prefill

    wide = [types.SimpleNamespace(name=c.name, launches=c)
            for c in (*decode.WIDE_GROUP.values(), *prefill.WIDE_GROUP.values(),
                      *decode.GROUP_WIDE.values(), *prefill.GROUP_WIDE.values(),
                      *decode.ALIBI.values(), *prefill.ALIBI.values())]
    return [*decode.KERNELS_BY_DIM.values(), *prefill.KERNELS_BY_DIM.values(), *wide], PLAIN_CALLS


def _serve_family(engine, prompts, max_new, watch=None):
    """Serve ``prompts`` greedily through ``engine.step`` (``watch(engine)``
    after every step); returns (the streams, {entry: launches}, plain-version
    calls) of the serve alone."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    kernels, plain = _attention_counters()
    for k in kernels:
        k.launches.n = 0
    plain.n = 0
    streams = [engine.enqueue(p, GenerateConfig(max_new_tokens=max_new, do_sample=False,
                                                ignore_eos=True, return_logprobs=True))
               for p in prompts]
    while engine.has_work():
        engine.step()
        if watch is not None:
            watch(engine)
    torch.cuda.synchronize()
    return streams, {k.name: k.launches.n for k in kernels if k.launches.n}, plain.n


def _teacher_chunked(engine, prompt, tokens, chunk=TEACHER_CHUNK, backend="plain"):
    """(log p of each of ``tokens`` after ``prompt``, each position's best
    token and its top-2 gap) from a teacher-forced forward through plain
    attention (with the
    model's window), in chunks of ``chunk`` query rows on a private
    allocation of the engine's pool: the plain version's scores of a 6000-
    token forward in one piece would not fit beside the engines. A longrope
    model's chunk takes the table its served forwards took: the prompt's
    (one prefill) for the prompt's rows, its own last position's past them
    (the decode steps; a chunk boundary at the switch keeps them apart)."""
    import torch

    seq = list(prompt) + list(tokens)
    p = len(prompt)
    model = engine.model
    with engine.device_lock, torch.no_grad():
        alloc = engine.cache_mgr.allocate(seq, allow_reuse=False)
        row = engine._block_row(alloc.blocks)[None]
        model.attn_backend = backend
        picked, best, gap = [], [], []
        try:
            for off in range(0, len(seq), chunk):
                part = seq[off: off + chunk]
                need = off + len(part) > p - 1
                inputs = engine._prefill_inputs([(part, off)], row)
                if model.rope_switch:  # longrope: the prompt's chunks on the prompt's table
                    inputs = inputs._replace(rope_lens=torch.full_like(
                        inputs.kv_lens, max(p, off + len(part))))
                out, engine.kv = model.forward(engine.weights, engine.kv, inputs,
                                               need_all_logits=need)
                if not need:
                    continue
                lo, hi = max(p - 1, off), min(off + len(part), p - 1 + len(tokens))
                lp = torch.log_softmax(out.all_logits.float()[lo - off: hi - off], dim=-1)
                ids = torch.tensor(seq[lo + 1: hi + 1], device="cuda")
                picked += lp.gather(1, ids[:, None])[:, 0].tolist()
                top = lp.topk(2, dim=-1)
                best += top.indices[:, 0].tolist()
                gap += (top.values[:, 0] - top.values[:, 1]).tolist()
        finally:
            model.attn_backend = "auto"
            engine.cache_mgr.free(alloc)
    return picked, best, gap


def _teacher_check(tag, engine, streams, rows=TEACHER_ROWS):
    """Served logprobs of ``rows`` streams against the teacher-forced plain
    forward: within TEACHER_TOL, and each greedy token the teacher's best
    at every decisive position (top-2 gap above 2 x TEACHER_TOL). Returns
    the largest error."""
    worst, decisive, off_best = 0.0, 0, 0
    for s in streams[:rows]:
        want, best, gap = _teacher_chunked(engine, s.prompt_token_ids, s.output_token_ids)
        got = s.output_logprobs
        if len(got) != len(want):
            raise SystemExit(f"{tag}: {len(got)} served logprobs for {len(want)} tokens")
        worst = max(worst, max(abs(a - b) for a, b in zip(got, want)))
        for tok, b, g in zip(s.output_token_ids, best, gap):
            if g > 2 * TEACHER_TOL:
                decisive += 1
                off_best += tok != b
    ok = worst <= TEACHER_TOL and off_best == 0
    _line(tag, check="teacher_forced_logprobs", rows=rows, max_abs_err=f"{worst:.4f}",
          tol=TEACHER_TOL, decisive_positions=decisive, tokens_off_the_best=off_best, ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: served logprobs stray from the teacher-forced plain forward")
    return worst


def _prompts(gen, vocab, rows, lo_hi):
    import torch

    lens = torch.randint(lo_hi[0], lo_hi[1] + 1, (rows,), generator=gen, device="cuda").tolist()
    return [torch.randint(1, vocab, (n,), generator=gen, device="cuda").tolist() for n in lens]


def _served_ok(tag, streams, max_new, launches, plain, want_entries):
    """Every stream served ``max_new`` finite-logprob tokens, every entry of
    ``want_entries`` launched, the plain attention never called."""
    import math

    full = all(len(s.output_token_ids) == max_new for s in streams)
    finite = all(math.isfinite(x) for s in streams for x in s.output_logprobs)
    missing = [n for n in want_entries if not launches.get(n)]
    ok = full and finite and not missing and plain == 0
    _line(tag, streams=len(streams), tokens_each=max_new, all_served=full, finite=finite,
          launches=",".join(f"{n}:{c}" for n, c in sorted(launches.items())),
          plain_attention_calls=plain, ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: a stream was not served whole, a logprob is not finite, "
                         f"an entry was not launched ({missing}) or plain attention ran")


def _cut(cfg, weights, layers):
    """A ``layers``-layer cut of ``cfg`` and ``weights`` (views of the first
    layers' stacks)."""
    import dataclasses

    L = cfg.num_layers
    cut = {n: (t[:layers] if hasattr(t, "shape") and t.dim() and t.shape[0] == L
               and n not in ("embed_tokens", "lm_head", "final_norm") else t)
           for n, t in weights.items()}
    return dataclasses.replace(cfg, num_layers=layers), cut


def phase_qwen2_0_5b(gen, card):
    """``[qwen2-0.5b]``: Qwen2-0.5B (D 64, 14 / 2 heads, tied head) at full
    width and depth, random bf16 weights, served at 64 slots on a bf16, an
    int8 and an fp8 pool: every stream served whole with finite logprobs,
    the D 64 entries of the pool type launched and the plain attention
    never; teacher-forced logprobs on the bf16 pool. Returns ({entry:
    launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_0_5b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = qwen2_0_5b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 5, "qwen2-0.5b")
    prompts = _prompts(gen, cfg.vocab_size, QWEN05_ROWS, QWEN05_PROMPTS)
    launches, plain_calls = collections.Counter(), 0
    for kv, suffix in (("bfloat16", ""), ("int8", "_i8"), ("fp8", "_e4m3")):
        engine = make_engine(model, weights, kv=kv)
        streams, got, plain = _serve_family(engine, prompts, QWEN05_OUT)
        _served_ok(f"qwen2-0.5b:{kv}", streams, QWEN05_OUT, got, plain,
                   [f"paged_decode{suffix}_d64", f"paged_prefill{suffix}_d64"])
        if kv == "bfloat16":
            _teacher_check("qwen2-0.5b", engine, streams)
        launches.update(got)
        plain_calls += plain
        del engine
    torch.cuda.empty_cache()
    _line("qwen2-0.5b", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def _swa_serve(tag, model, weights, prompts, max_new, num_blocks, keep_check, decode_steps=1):
    """One model served twice: recycling on (prefix cache off), then off
    with the prefix cache on. Recycled streams hold at most ``swa_keep``
    distinct blocks once in a decode slot, at every step; the pool is whole
    once they are freed; the tokens equal the other engine's bit for bit.
    Returns (the recycled engine's streams and engine, launches, plain
    calls, pool peak bytes with and without recycling)."""
    import torch

    cfg = model.cfg
    block_bytes = 2 * cfg.num_layers * BS * cfg.num_kv_heads * cfg.head_dim * 2
    runs = {}
    for recycle in (True, False):
        engine = make_engine(model, weights, num_blocks=num_blocks, recycle=recycle,
                             prefix=not recycle, decode_steps=decode_steps if recycle else 1)
        cm = engine.cache_mgr
        stats = dict(peak=0, decode_peak=0, worst=0, checks=0)

        def watch(eng, cm=cm, stats=stats):
            used = cm.pool.num_blocks - 1 - cm.pool.free_blocks
            stats["peak"] = max(stats["peak"], used)
            live = [s for s in eng.slots if s is not None and s.alloc is not None]
            if len(live) == len(prompts):  # every stream decoding
                stats["decode_peak"] = max(stats["decode_peak"], used)
            for s in live:
                stats["worst"] = max(stats["worst"], len(set(s.alloc.blocks)))
                stats["checks"] += 1

        streams, got, plain = _serve_family(engine, prompts, max_new, watch)
        if cm.prefix_cache is not None:
            _drop_prefix_cache(engine)
        whole = cm.pool.free_blocks == cm.pool.num_blocks - 1
        runs[recycle] = (engine, streams, got, plain, stats, whole)
    (eng_r, st_r, got_r, plain_r, stats_r, whole_r) = runs[True]
    (eng_n, st_n, got_n, plain_n, stats_n, whole_n) = runs[False]
    same = all(a.output_token_ids == b.output_token_ids for a, b in zip(st_r, st_n))
    keep = eng_r.cache_mgr.swa_keep
    ok = (keep == keep_check and stats_r["worst"] <= keep and stats_r["checks"] > 0
          and whole_r and whole_n and same)
    _line(tag, check="recycling", swa_keep=keep, max_distinct_blocks=stats_r["worst"],
          slot_checks=stats_r["checks"], pool_whole_after=whole_r and whole_n,
          tokens_equal_non_recycled=same, decode_steps=decode_steps,
          pool_peak_bytes_recycled=stats_r["peak"] * block_bytes,
          pool_peak_bytes_not_recycled=stats_n["peak"] * block_bytes,
          pool_decode_peak_bytes_recycled=stats_r["decode_peak"] * block_bytes,
          pool_decode_peak_bytes_not_recycled=stats_n["decode_peak"] * block_bytes, ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: recycling broke its bound, leaked blocks or changed tokens")
    del eng_n
    return st_r, eng_r, got_r, plain_r + plain_n


def phase_phi3(gen, card):
    """``[phi3]``: Phi-3-mini-4k (D 96, 32 / 32 heads, window 2047) at full
    width and depth, random bf16 weights, 8 streams whose prompts cross the
    window, served with recycling and without (``_swa_serve``), teacher-
    forced logprobs; then a 4-layer cut served on an int8 and an fp8 pool
    (the D 96 entries of those pools on a served path). Returns ({entry:
    launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import phi3_mini_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = phi3_mini_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 6, "phi3-mini")
    prompts = _prompts(gen, cfg.vocab_size, PHI3_ROWS, PHI3_PROMPTS)
    keep = -(-cfg.sliding_window // BS) + 2
    streams, engine, launches, plain_calls = _swa_serve("phi3", model, weights, prompts,
                                                        PHI3_OUT, PHI3_BLOCKS, keep)
    launches = collections.Counter(launches)
    _served_ok("phi3:bfloat16", streams, PHI3_OUT, launches, plain_calls,
               ["paged_decode_d96", "paged_prefill_d96"])
    _teacher_check("phi3", engine, streams)
    del engine
    ccfg, cw = _cut(cfg, weights, FAMILY_LAYERS_CUT)
    cmodel = LlamaFamilyModel(ccfg, device="cuda")
    for kv, suffix in (("int8", "_i8"), ("fp8", "_e4m3")):
        engine = make_engine(cmodel, cw, kv=kv, num_blocks=PHI3_BLOCKS)
        st, got, plain = _serve_family(engine, prompts, PHI3_OUT)
        _served_ok(f"phi3-cut:{kv}", st, PHI3_OUT, got, plain,
                   [f"paged_decode{suffix}_d96", f"paged_prefill{suffix}_d96"])
        launches.update(got)
        plain_calls += plain
        del engine
    del weights, cw
    torch.cuda.empty_cache()
    _line("phi3", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_mistral_swa(gen, card):
    """``[mistral-swa]``: Mistral-7B-v0.1 (window 4096) at full width and
    depth, random bf16 weights, 8 streams of 4500-6000 prompt tokens, 256
    out each, through the graphed engine with recycling on (windows of 4
    decode steps) beside the same engine with recycling off and the prefix
    cache on (``_swa_serve``: at most 66 distinct blocks a stream, the pool
    whole after, tokens equal bit for bit), then teacher-forced logprobs.
    Returns (model, weights, {entry: launches}, plain calls)."""
    from rtp_llm_tpu_torch.config.model_config import mistral_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = mistral_7b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 7, "mistral-7b")
    prompts = _prompts(gen, cfg.vocab_size, SWA_ROWS, SWA_PROMPTS)
    keep = -(-cfg.sliding_window // BS) + 2  # 66 at the published window
    streams, engine, launches, plain_calls = _swa_serve(
        "mistral-swa", model, weights, prompts, SWA_OUT, SWA_BLOCKS, keep, decode_steps=4)
    _served_ok("mistral-swa:bfloat16", streams, SWA_OUT, launches, plain_calls,
               ["paged_decode", "paged_prefill"])
    _teacher_check("mistral-swa", engine, streams)
    del engine
    _line("mistral-swa", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return model, weights, launches, plain_calls


def _act_order(wq, cfg, gen, shared=True):
    """GPTQ act-order form of the fused 4-bit weights ``wq`` (codes already
    in group order): a random permutation of each linear's input features a
    layer, ``.act_perm``, as a random ``g_idx`` would give after the stable
    sort. ``shared``: one for q / k / v (the fused qkv), one for gate / up,
    as AutoGPTQ writes them; else the members are split apart, each with
    its own."""
    import torch

    out = dict(wq)
    L = cfg.num_layers
    perm = lambda k: torch.stack([torch.randperm(k, generator=gen, device="cuda")
                                  for _ in range(L)]).to(torch.int32)
    if shared:
        for name in QUANT_LINEARS:
            out[name + ".act_perm"] = perm(cfg.hidden_size if name != "down_proj"
                                           else cfg.intermediate_size)
        return out
    hq, hkv, d, i = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    for fused, members in (("qkv_proj", (("q_proj", hq * d), ("k_proj", hkv * d),
                                         ("v_proj", hkv * d))),
                           ("gate_up_proj", (("gate_proj", i), ("up_proj", i)))):
        start = 0
        for name, width in members:
            for suffix in ("", ".scale", ".zero"):
                out[name + suffix] = out[fused + suffix][..., start: start + width].contiguous()
            out[name + ".int4p"] = True
            out[name + ".act_perm"] = perm(cfg.hidden_size)
            start += width
        for suffix in ("", ".scale", ".zero", ".int4p"):
            del out[fused + suffix]
    for name in ("o_proj", "down_proj"):
        out[name + ".act_perm"] = perm(cfg.hidden_size if name == "o_proj" else i)
    return out


def phase_act_order(model, weights, gen, card):
    """``[act-order]``: Mistral-7B in GPTQ-int4 form with act-order at full
    width and depth: the bf16 weights quantized on the card
    (``quantize_gptq_form``, groups of 128), random ``.act_perm`` a linear
    and layer, shared as AutoGPTQ shares them. The model steps through K4
    and through K5 (``int4_pipeline``) against the plain dequantized
    forward (``_plain_gemm``, the same gather), at the 4-bit phases' tolerance
    (MODEL_LOGITS_REL_L2); the 4-bit product's launches counted. Then a
    4-layer cut with a permutation of its own for every member, which runs
    them unfused. The gather's device ms a decode step (64 rows)."""
    import torch

    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops import quant_gemm

    t0 = time.time()
    cfg = model.cfg
    wq = quantize_gptq_form(weights)
    for n in QUANT_LINEARS:
        del weights[n]
    torch.cuda.empty_cache()
    steps, num_blocks = model_steps(cfg, gen)
    launches = collections.Counter()
    for shared, layers in ((True, cfg.num_layers), (False, FAMILY_LAYERS_CUT)):
        ccfg, cw = _cut(cfg, wq, layers) if layers != cfg.num_layers else (cfg, wq)
        cmodel = model if layers == cfg.num_layers else LlamaFamilyModel(ccfg, device="cuda")
        aw = cmodel.fuse_weights(_act_order(cw, ccfg, gen, shared))
        fused = "qkv_proj" in aw and "gate_up_proj" in aw
        want = run_steps(cmodel, aw, steps, num_blocks, _patched_linears(_plain_gemm))
        for variant in ("base", "pipe"):
            cmodel.gemm_variant = variant
            k = quant_gemm.KERNELS[variant]
            k.launches.n = 0
            got = run_steps(cmodel, aw, steps, num_blocks)
            n = k.launches.n
            launches[k.name] += n
            rel = float((got - want).norm() / want.norm())
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            ok = (bool(torch.isfinite(got).all()) and rel <= MODEL_LOGITS_REL_L2 and n > 0
                  and fused == shared)
            _line("act-order", layers=layers, members="shared" if shared else "own",
                  fused=fused, variant=variant, kernel=k.name, launches=n,
                  logits_rel_l2=f"{rel:.3e}", tol=MODEL_LOGITS_REL_L2,
                  argmax_agree=f"{agree:.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"act-order ({variant}, {'shared' if shared else 'own'}): the "
                                 "kernel path disagrees with the plain dequantized forward")
        cmodel.gemm_variant = "base"
    # the gathers of one decode step at 64 rows: 4 a layer
    x = {kk: torch.randn((64, kk), generator=gen, device="cuda", dtype=torch.bfloat16)
         for kk in (cfg.hidden_size, cfg.intermediate_size)}
    aw = _act_order(wq, cfg, gen)
    perms = [(x[aw[n + ".act_perm"].shape[-1]], aw[n + ".act_perm"][i])
             for i in range(cfg.num_layers) for n in QUANT_LINEARS]
    gather = lambda: [xx.index_select(-1, p) for xx, p in perms]
    ms = _graph_ms(gather, 4)
    _line("act-order", gather_ms_per_decode_step=f"{ms:.4f}", gathers=len(perms), rows=64,
          seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    del wq, aw
    torch.cuda.empty_cache()
    return launches


def _internlm2_checkpoint(path, cfg, w):
    """Canonical unfused weights as an HF internlm2 checkpoint: ``wqkv``
    [(Hq + 2 Hkv) * D, H] grouped per kv head (the group's query heads,
    then its k and v), every other tensor under its internlm2 name."""
    import torch

    from rtp_llm_tpu_torch.loader.weight_maps import get_weight_specs, hf_names_for

    hq, hkv, d, h = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    g = hq // hkv
    tensors = {}
    for spec in get_weight_specs(cfg):
        if spec.hf_transform is not None:
            continue
        t = w[spec.name]
        parts = t.unbind(0) if spec.per_layer else [t]
        for name, part in zip(hf_names_for(spec, cfg.num_layers), parts):
            tensors[name] = part.transpose(-1, -2) if spec.transpose else part
    for layer in range(cfg.num_layers):
        q = w["q_proj"][layer].reshape(h, hkv, g, d)
        k = w["k_proj"][layer].reshape(h, hkv, 1, d)
        v = w["v_proj"][layer].reshape(h, hkv, 1, d)
        tensors[f"model.layers.{layer}.attention.wqkv.weight"] = (
            torch.cat([q, k, v], dim=2).reshape(h, -1).transpose(0, 1))
    os.makedirs(path, exist_ok=True)
    _save_safetensors(os.path.join(path, "model.safetensors"), tensors)


def phase_internlm2(gen, card):
    """``[internlm2]``: a 4-layer cut of InternLM2-7B at its published width
    written as an HF checkpoint (the grouped fused ``wqkv``), loaded by the
    port's loader: q / k / v equal the weights written, bit for bit; the
    model steps through the kernels against the plain attention, at
    MODEL_LOGITS_REL_L2."""
    import dataclasses
    import shutil

    import torch

    from rtp_llm_tpu_torch.config.model_config import internlm2_7b_config
    from rtp_llm_tpu_torch.loader import CheckpointLoader
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = dataclasses.replace(internlm2_7b_config(), num_layers=FAMILY_LAYERS_CUT)
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(8)
    w = random_weights(cfg, wgen)
    path = os.path.join("build", "internlm2_cut")
    _internlm2_checkpoint(path, cfg, w)
    try:
        loaded = CheckpointLoader(cfg, device="cuda").load(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    split_ok = all(torch.equal(loaded[n], w[n]) for n in ("q_proj", "k_proj", "v_proj"))
    model = LlamaFamilyModel(cfg, device="cuda")
    fused = model.fuse_weights(loaded)
    steps, num_blocks = model_steps(cfg, gen)
    got = run_steps(model, fused, steps, num_blocks)
    model.attn_backend = "plain"
    want = run_steps(model, fused, steps, num_blocks)
    model.attn_backend = "auto"
    rel = float((got - want).norm() / want.norm())
    ok = split_ok and bool(torch.isfinite(got).all()) and rel <= MODEL_LOGITS_REL_L2
    _line("internlm2", layers=cfg.num_layers, wqkv_split_exact=split_ok,
          logits_rel_l2=f"{rel:.3e}", tol=MODEL_LOGITS_REL_L2, ok=ok,
          seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    if not ok:
        raise SystemExit("internlm2: the wqkv split or the forward disagrees")


def _release():
    """Free what the engines of a phase held (an engine's reference cycles
    keep its pool alive until a collection)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_families(gen, card):
    """The llama-layout families' phases, after every earlier engine is
    released. Returns ({entry: launches on their served paths}, plain
    attention calls there)."""
    _release()
    t0 = time.time()
    launches, plain_calls = collections.Counter(), 0
    for phase in (phase_qwen2_0_5b, phase_phi3):
        got, plain = phase(gen, card)
        launches.update(got)
        plain_calls += plain
        _release()
    model, weights, got, plain = phase_mistral_swa(gen, card)
    plain_calls += plain
    launches.update({n: c for n, c in got.items() if n in ("paged_decode", "paged_prefill")})
    _release()
    launches.update(phase_act_order(model, weights, gen, card))
    del model, weights
    _release()
    phase_internlm2(gen, card)
    _release()
    for phase in (phase_gemma2, phase_gemma, phase_starcoder2, phase_aya23,
                  phase_command_r_plus):
        got, plain = phase(gen, card)
        launches.update(got)
        plain_calls += plain
        _release()
    _line("families", seconds=f"{time.time() - t0:.1f}")
    return launches, plain_calls


def _gemma_weights(model, seed, name):
    """bf16 weights of a gemma / gemma2 config as the loader gives them
    (norms 1 + 0, the offset folded; gemma2's sandwich norms; no LM head:
    the embedding is tied), fused, from a generator of their own."""
    import torch

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    w = random_weights(cfg, wgen)
    del w["lm_head"]
    if cfg.sandwich_norms:
        for n in ("pre_ffn_norm", "post_ffn_norm"):
            w[n] = torch.ones((cfg.num_layers, cfg.hidden_size), dtype=torch.bfloat16,
                              device="cuda")
    weights = model.fuse_weights(w)
    torch.cuda.synchronize()
    _line("weights", model=name, layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


def _pool_bytes(pool):
    """Device bytes of a pool: a tensor, or an int8 pool's data and scales."""
    parts = pool.values() if isinstance(pool, dict) else (pool,)
    return sum(t.numel() * t.element_size() for t in parts)


def _timed_serve(engine, prompts, max_new):
    """Serve ``prompts`` together through ``engine.step``: (streams, TTFT
    of the first token of each stream in ms, decode tokens per second over
    the steps in which every stream had its first token, seconds)."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    t0 = time.perf_counter()
    streams = [engine.enqueue(p, GenerateConfig(max_new_tokens=max_new, do_sample=False,
                                                ignore_eos=True, return_logprobs=True))
               for p in prompts]
    first, t_all = {}, None
    while engine.has_work():
        engine.step()
        now = time.perf_counter()
        for i, s in enumerate(streams):
            if i not in first and s.output_token_ids:
                first[i] = (now - t0) * 1e3
        if t_all is None and len(first) == len(streams):
            t_all, n_all = now, sum(len(s.output_token_ids) for s in streams)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    n_end = sum(len(s.output_token_ids) for s in streams)
    tok_s = (n_end - n_all) / max(t_end - t_all, 1e-9)
    return streams, [first[i] for i in range(len(streams))], tok_s, t_end - t0


def _split_pool_bytes_ok(tag, engine):
    """The split pool's halves at the bytes the engine's sizing computes:
    the rings (``ring_bytes``: a slot's, and the ring pool's null block)
    and the paged pool (``kv_block_bytes`` a block)."""
    per_slot, null = engine.ring_bytes()
    slots = engine.config.scheduler.max_batch_size
    ring, full = _pool_bytes(engine.kv.swa), _pool_bytes(engine.kv.full)
    ok = (ring == slots * per_slot + null and full == engine.num_blocks * engine.kv_block_bytes())
    _line(tag, check="split_pool_bytes", slots=slots, ring_blocks_a_slot=engine.model.swa_nring,
          ring_bytes_a_slot=per_slot, ring_pool_bytes=ring, paged_blocks=engine.num_blocks,
          paged_pool_bytes=full, ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: the split pool's bytes differ from the engine's sizing")


def phase_gemma2(gen, card):
    """``[gemma2]``: Gemma-2-9B bf16 at full width and depth (42 layers:
    21 global on the paged pool, 21 sliding on one ring a slot), seeded
    random weights (std 0.02), blocks of 64, graphs and async decode, 8
    decode slots (a slot's rings hold window + the 8192-token prefill span:
    193 blocks, 2.1 GB), pool bytes as sized; 8 prompts of 500-6000 tokens
    (four past the 4096 window) served together, 32 tokens each, with
    K1 / K2 / K3 at D 256 under the attention cap and never the plain
    attention; the same tokens at ``decode_steps`` 4; served logprobs
    against a teacher-forced plain forward; a lone 1000-token prompt's
    TTFT; decode tok/s; peak reserved memory. Then ``[gemma2-kv]``: a
    4-layer cut on int8 and fp8 pools (split pools of quantized halves).
    Returns ({entry: launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import gemma2_9b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = gemma2_9b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _gemma_weights(model, 9, "gemma2-9b")
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in GEMMA2_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=gen, device="cuda").tolist()
    # every window captured before the timings (the stats windows too: the
    # requests ask for logprobs), so that no capture lands in a TTFT
    engine = make_engine(model, weights, num_blocks=GEMMA2_BLOCKS, slots=GEMMA2_SLOTS,
                         tail=True)
    _split_pool_bytes_ok("gemma2", engine)
    # serving's memory: what loading left cached (the unfused weights) is
    # handed back first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels, plain = _attention_counters()
    for k in kernels:
        k.launches.n = 0
    plain.n = 0
    (lone_s,), (ttft,), lone_tok_s, _ = _timed_serve(engine, [lone], GEMMA2_OUT)
    streams, firsts, tok_s, secs = _timed_serve(engine, prompts, GEMMA2_OUT)
    torch.cuda.synchronize()
    # the lone prompt again, on a warm engine (the first request pays
    # first-use costs of its own)
    (lone_w,), (ttft_warm,), lone_tok_s_warm, _ = _timed_serve(engine, [lone], GEMMA2_OUT)
    launches = collections.Counter({k.name: k.launches.n for k in kernels if k.launches.n})
    plain_calls = plain.n
    _served_ok("gemma2:bfloat16", streams + [lone_s, lone_w], GEMMA2_OUT, launches, plain_calls,
               ["paged_decode_d256", "paged_prefill_d256"])
    _line("gemma2", check="serve", slots=GEMMA2_SLOTS, prompts=",".join(map(str, GEMMA2_PROMPTS)),
          out_tokens=GEMMA2_OUT, lone_prompt=GEMMA_LONE, ttft_lone_first_ms=f"{ttft:.1f}",
          ttft_lone_warm_ms=f"{ttft_warm:.1f}", lone_decode_tok_s=f"{lone_tok_s:.1f},"
          f"{lone_tok_s_warm:.1f}", ttft_batch_ms=",".join(f"{x:.0f}" for x in firsts),
          batch_decode_tok_s=f"{tok_s:.1f}", batch_seconds=f"{secs:.2f}",
          serving_peak_reserved_gbytes=f"{torch.cuda.max_memory_reserved() / 1e9:.2f}",
          serving_peak_allocated_gbytes=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          launches_a_decode_step=cfg.num_layers)
    # the same tokens in windows of 4 decode steps
    _set_decode(engine, "graph", 4, True)
    again, _, tok_s4, _ = _timed_serve(engine, prompts, GEMMA2_OUT)
    _set_decode(engine, "graph", 1, True)
    same = all(a.output_token_ids == b.output_token_ids for a, b in zip(streams, again))
    _line("gemma2", check="decode_steps_4", tokens_equal=same, batch_decode_tok_s=f"{tok_s4:.1f}",
          ok=same)
    if not same:
        raise SystemExit("gemma2: decode_steps 4 served other tokens than 1")
    _teacher_check("gemma2", engine, streams)
    del engine
    _release()
    # [gemma2-kv]: split pools of int8 and e4m3 halves, a 4-layer cut
    ccfg, cw = _cut(cfg, weights, FAMILY_LAYERS_CUT)
    cmodel = LlamaFamilyModel(ccfg, device="cuda")
    for kv, suffix in (("int8", "_i8"), ("fp8", "_e4m3")):
        engine = make_engine(cmodel, cw, kv=kv, num_blocks=GEMMA2_BLOCKS, slots=GEMMA2_SLOTS)
        _split_pool_bytes_ok(f"gemma2-kv:{kv}", engine)
        st, got, plain_n = _serve_family(engine, prompts, GEMMA2_OUT)
        _served_ok(f"gemma2-kv:{kv}", st, GEMMA2_OUT, got, plain_n,
                   [f"paged_decode{suffix}_d256", f"paged_prefill{suffix}_d256"])
        launches.update(got)
        plain_calls += plain_n
        del engine
        _release()
    del weights, cw
    _line("gemma2", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_gemma(gen, card):
    """``[gemma]``: Gemma-7B at its published widths (D 256, 16 / 16 heads:
    G = 1, the mma's one live column), a 4-layer cut, seeded random bf16
    weights, 8 prompts served on a bf16 and an int8 pool (one pool: no
    window), teacher-forced logprobs on the bf16 one. Returns ({entry:
    launches}, plain calls)."""
    import dataclasses

    from rtp_llm_tpu_torch.config.model_config import gemma_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = dataclasses.replace(gemma_7b_config(), num_layers=FAMILY_LAYERS_CUT)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _gemma_weights(model, 10, "gemma-7b-4-layers")
    prompts = _prompts(gen, cfg.vocab_size, GEMMA_ROWS, GEMMA_PROMPTS)
    launches, plain_calls = collections.Counter(), 0
    for kv, suffix in (("bfloat16", ""), ("int8", "_i8")):
        engine = make_engine(model, weights, kv=kv, num_blocks=GEMMA_BLOCKS)
        st, got, plain = _serve_family(engine, prompts, GEMMA_OUT)
        _served_ok(f"gemma:{kv}", st, GEMMA_OUT, got, plain,
                   [f"paged_decode{suffix}_d256", f"paged_prefill{suffix}_d256"])
        if kv == "bfloat16":
            _teacher_check("gemma", engine, st)
        launches.update(got)
        plain_calls += plain
        del engine
        _release()
    _line("gemma", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls



# [starcoder2] / [aya23]: full depth, 64 slots, the gemma2 prompts (500-6000
# tokens, four past StarCoder2's 4096 window), a lone 1000, 32 out;
# [command-r-plus]: a 4-layer cut, 4 prompts, also on int8 / fp8 pools
FAM_SLOTS, FAM_OUT, FAM_BLOCKS = 64, 32, 800
CRP_PROMPTS, CRP_BLOCKS = (300, 900, 1500, 2500), 256
FAM_SEEDS = {"starcoder2": 23, "aya23": 24, "command-r-plus": 25}


def _family_weights(model, seed, name):
    """bf16 weights of a cohere / starcoder2 config as the loader gives them
    (std 0.02, norms 1), fused, from a generator of their own: no LM head
    (tied); starcoder2's biases under their linears' names and its
    LayerNorm biases, no gate; cohere without ``post_attn_norm`` (one norm
    feeds attention and MLP), its q / k norms per head."""
    import torch

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    w = random_weights(cfg, wgen)
    del w["lm_head"]
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    rand = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
        0.0, 0.02, generator=wgen)
    if cfg.parallel_residual:
        del w["post_attn_norm"]
    if cfg.use_qk_norm:
        for n, heads in (("q_norm", cfg.num_attention_heads), ("k_norm", cfg.num_kv_heads)):
            w[n] = torch.ones((L, heads, cfg.head_dim), dtype=torch.bfloat16, device="cuda")
    if cfg.norm_type == "layernorm":
        for p in ("q", "k", "v"):
            w[f"{p}_proj.bias"] = w.pop(f"{p}_bias")
        w.update({"o_proj.bias": rand(L, H), "up_proj.bias": rand(L, I),
                  "down_proj.bias": rand(L, H), "input_norm.bias": rand(L, H),
                  "post_attn_norm.bias": rand(L, H), "final_norm.bias": rand(H)})
    weights = model.fuse_weights(w)
    torch.cuda.synchronize()
    _line("weights", model=name, layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


def _group_mode(cfg):
    """The counter suffix of the attention kernels' group mode a model's
    launches take: ``_gwide`` (head chunks, G > 16), ``_g9to16`` (two n8
    tiles), or None (G <= 8)."""
    from rtp_llm_tpu_torch.ops.attention import decode

    g = cfg.num_attention_heads // cfg.num_kv_heads
    return "_gwide" if g > decode.CHUNK else "_g9to16" if g > decode.N8 else None


def _group_mode_all(tag, launches, entries, mode):
    """Every launch of each of ``entries`` (a decode and a prefill entry of
    one pool type) on a served path was in the group mode ``mode``: the
    entry's count equals its pool type's mode counter."""
    counts = {}
    for n in entries:
        op = "decode" if "decode" in n else "prefill"
        pool = n.split("paged_" + op)[1].split("_d")[0]  # "", "_i8" or "_e4m3"
        counts[n] = (launches.get(n, 0), launches.get(f"paged_{op}{pool}{mode}", 0))
    ok = all(a == b > 0 for a, b in counts.values())
    _line(tag, check="group_mode", mode=mode.lstrip("_"),
          launches=",".join(f"{n}:{a}/{b}" for n, (a, b) in counts.items()), ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: an attention launch ran outside the {mode} mode ({counts})")


def _family_serve(tag, engine, cfg, prompts, lone):
    """The gemma2 checks on a served family: a lone prompt (TTFT cold, then
    warm: with the prefix cache on, behind its cached prefix), the prompts
    together (decode tok/s, serving memory), K1 / K3 of the model's head
    width launched, the G 9-16 counts where the group is past 8, an ALiBi
    model's every K1 / K3 launch in ALiBi mode, plain attention never; the
    same tokens at ``decode_steps`` 4 (from an empty prefix cache); served
    logprobs against the teacher-forced plain forward. Returns ({entry:
    launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels, plain = _attention_counters()
    for k in kernels:
        k.launches.n = 0
    plain.n = 0
    (lone_s,), (ttft,), lone_tok_s, _ = _timed_serve(engine, [lone], FAM_OUT)
    streams, firsts, tok_s, secs = _timed_serve(engine, prompts, FAM_OUT)
    (lone_w,), (ttft_warm,), lone_tok_s_warm, _ = _timed_serve(engine, [lone], FAM_OUT)
    torch.cuda.synchronize()
    launches = collections.Counter({k.name: k.launches.n for k in kernels if k.launches.n})
    plain_calls = plain.n
    mode = _group_mode(cfg)
    entries = [decode.kernel_for(torch.bfloat16, cfg.head_dim).name,
               prefill.kernel_for(torch.bfloat16, cfg.head_dim).name]
    _served_ok(f"{tag}:bfloat16", streams + [lone_s, lone_w], FAM_OUT, launches, plain_calls,
               entries + ([f"paged_decode{mode}", f"paged_prefill{mode}"] if mode else [])
               + ([n + "_alibi" for n in entries] if cfg.use_alibi else []))
    if cfg.use_alibi:
        _alibi_all(tag, launches, entries)
    if mode:
        _group_mode_all(tag, launches, entries, mode)
    _line(tag, check="serve", slots=engine.config.scheduler.max_batch_size,
          prompts=",".join(str(len(p)) for p in prompts), out_tokens=FAM_OUT,
          lone_prompt=len(lone), ttft_lone_first_ms=f"{ttft:.1f}",
          ttft_lone_warm_ms=f"{ttft_warm:.1f}",
          lone_decode_tok_s=f"{lone_tok_s:.1f},{lone_tok_s_warm:.1f}",
          ttft_batch_ms=",".join(f"{x:.0f}" for x in firsts), batch_decode_tok_s=f"{tok_s:.1f}",
          batch_seconds=f"{secs:.2f}",
          serving_peak_reserved_gbytes=f"{torch.cuda.max_memory_reserved() / 1e9:.2f}",
          serving_peak_allocated_gbytes=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          launches_a_decode_step=cfg.num_layers, lone_warm_prefix_reused_tokens=lone_w.reuse_len,
          window=cfg.sliding_window, recycling=engine.config.cache.swa_recycle)
    if engine.config.cache.enable_prefix_cache:
        _drop_prefix_cache(engine)  # the re-serve prefills as the first serve did
    _set_decode(engine, "graph", 4, True)
    again, _, tok_s4, _ = _timed_serve(engine, prompts, FAM_OUT)
    _set_decode(engine, "graph", 1, True)
    same = all(a.output_token_ids == b.output_token_ids for a, b in zip(streams, again))
    _line(tag, check="decode_steps_4", tokens_equal=same, batch_decode_tok_s=f"{tok_s4:.1f}",
          ok=same)
    if not same:
        raise SystemExit(f"{tag}: decode_steps 4 served other tokens than 1")
    _teacher_check(tag, engine, streams)
    return launches, plain_calls


def phase_starcoder2(gen, card):
    """``[starcoder2]``: StarCoder2-7B bf16 at full width and depth (36 / 4
    heads: G 9, two n8 tiles in K1; biased LayerNorms and linears, the
    non-gated gelu MLP, tied embeddings, a 4096-token window on every
    layer), seeded random weights, 64 slots with sliding-window recycling
    (the prefix cache off), 8 prompts of 500-6000 tokens (four past the
    window), a lone 1000, 32 out (``_family_serve``). Returns ({entry:
    launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import starcoder2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = starcoder2_7b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _family_weights(model, FAM_SEEDS["starcoder2"], "starcoder2-7b")
    own = torch.Generator(device="cuda")
    own.manual_seed(FAM_SEEDS["starcoder2"])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in GEMMA2_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=FAM_BLOCKS, slots=FAM_SLOTS, recycle=True,
                         prefix=False, tail=True)
    launches, plain_calls = _family_serve("starcoder2", engine, cfg, prompts, lone)
    pool = engine.cache_mgr.pool
    whole = pool.free_blocks == pool.num_blocks - 1
    _line("starcoder2", check="recycling", swa_keep=engine.cache_mgr.swa_keep,
          free_blocks_after=pool.free_blocks, ok=whole)
    if not whole:
        raise SystemExit("starcoder2: the recycled pool is not whole after the serves")
    del engine, weights
    _line("starcoder2", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_aya23(gen, card):
    """``[aya23]``: Aya-23-8B bf16 at full width and depth (cohere: weight-
    only LayerNorms, the parallel residual, GPT-J pair RoPE, logits x 0.125,
    tied 256000-token embeddings; 32 / 8 heads), seeded random weights, 64
    slots, the prompts of ``[starcoder2]``'s lengths (``_family_serve``).
    Returns ({entry: launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import aya_23_8b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = aya_23_8b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _family_weights(model, FAM_SEEDS["aya23"], "aya-23-8b")
    own = torch.Generator(device="cuda")
    own.manual_seed(FAM_SEEDS["aya23"])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in GEMMA2_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=FAM_BLOCKS, slots=FAM_SLOTS, prefix=False,
                         tail=True)
    launches, plain_calls = _family_serve("aya23", engine, cfg, prompts, lone)
    del engine, weights
    _line("aya23", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_command_r_plus(gen, card):
    """``[command-r-plus]``: Command R+ at its published width (96 / 8 heads:
    G 12, per-head q / k LayerNorms, logits x 0.8333), a 4-layer cut,
    seeded random bf16 weights, 64 slots, 4 prompts of 300-2500 tokens and
    a lone 1000 (``_family_serve``); then the cut on int8 and fp8 pools (the
    G 9-16 mode of those entries on a served path). Returns ({entry:
    launches}, plain calls)."""
    import dataclasses

    import torch

    from rtp_llm_tpu_torch.config.model_config import command_r_plus_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    t0 = time.time()
    cfg = dataclasses.replace(command_r_plus_config(), num_layers=FAMILY_LAYERS_CUT)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _family_weights(model, FAM_SEEDS["command-r-plus"], "command-r-plus-4-layers")
    own = torch.Generator(device="cuda")
    own.manual_seed(FAM_SEEDS["command-r-plus"])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in CRP_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=CRP_BLOCKS, slots=FAM_SLOTS, prefix=False,
                         tail=True)
    launches, plain_calls = _family_serve("command-r-plus", engine, cfg, prompts, lone)
    del engine
    _release()
    for kv, suffix in (("int8", "_i8"), ("fp8", "_e4m3")):
        engine = make_engine(model, weights, kv=kv, num_blocks=CRP_BLOCKS, slots=FAM_SLOTS,
                             prefix=False)
        st, got, plain = _serve_family(engine, prompts, FAM_OUT)
        _served_ok(f"command-r-plus:{kv}", st, FAM_OUT, got, plain,
                   [f"paged_decode{suffix}", f"paged_prefill{suffix}",
                    f"paged_decode{suffix}_g9to16", f"paged_prefill{suffix}_g9to16"])
        launches.update(got)
        plain_calls += plain
        del engine
        _release()
    del weights
    _line("command-r-plus", seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


# ---------------------------------------------------------------- the ALiBi
# families (baichuan2-13B, bloom, mpt, falcon's multi-head form) and the
# ALiBi mode of the attention kernels

# (model, D, Hq, Hkv, timed) of the [alibi] checks: Baichuan2-13B's 40 / 40
# heads at D 128 and falcon-rw-1b's 32 / 32 at D 64 (the served ALiBi models:
# G 1), and a group of 4 at each width, where a block row's head under the
# prefill plan's row map (r % G) is not its token's
ALIBI_CASES = (("baichuan2_13b", 128, 40, 40, True), ("falcon_rw_1b", 64, 32, 32, True),
               ("alibi_g4_d128", 128, 32, 8, False), ("alibi_g4_d64", 64, 16, 4, False))
# K1 at 64 rows x 2048 tokens, K2 at 8 x 8192 (split over KV), K3 one
# 2048-token prompt from position 0 and behind a 1000-token reused prefix
ALIBI_DECODE_SHAPES = ((64, 2048), (8, 8192))
ALIBI_PREFILL_OFFSETS = (0, 1000)
# the speculative verify window: 8 rows of K + 1 = 5 query tokens behind
# their contexts (one row a padded tail: 3 live tokens from position 0)
ALIBI_VERIFY = (SPEC_K + 1, (100, 517, 1023, 2047, 0, 64, 300, 1500),
                (105, 522, 1028, 2052, 3, 69, 305, 1505))
# faults built into each source: every head's bias with head 0's slope
# (decode), a block row's head read as r / TQ, heads major (prefill: caught
# where G > 1)
ALIBI_FAULTS = (("decode", "paged_decode.cu", "alibi_slope_of_head_0", "PD_FAULT=7"),
                ("prefill", "paged_prefill.cu", "alibi_row_head_misread", "PP_FAULT=4"))
ALIBI_SEED = 26  # the phase's own generator: the shared one reaches later phases as before


@functools.lru_cache(maxsize=None)
def _alibi_fault_kernels():
    """{(op, pool kind, D): the entry built with the op's ALiBi fault}, at
    the widths of ``ALIBI_CASES``."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    import torch

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    out = {}
    for op, src, name, define in ALIBI_FAULTS:
        mod = decode if op == "decode" else prefill
        for kind, dt in dtypes.items():
            for d in sorted({case[1] for case in ALIBI_CASES}):
                k = mod.KERNELS_BY_DIM[(dt, d)]
                out[(op, kind, d)] = _kernels.Kernel(f"{k.name}:{name}", src, k.entry,
                                                     mod._ARGTYPES, defines=(define,))
    return out


def _alibi_fault(op, dtype, kind, d):
    """``op``'s wrapper launches the build with its ALiBi fault for pool
    ``dtype`` at head width ``d``."""
    return _entry_swapped(op, dtype, _alibi_fault_kernels()[(op, kind, d)], d)


def _model_slopes(model, hq, d):
    """The slopes a served model hands the kernels: the ALiBi schedule of
    ``hq`` heads, falcon's times ``sm_scale``."""
    import torch

    from rtp_llm_tpu_torch.models.llama_family import alibi_slopes

    scale = d ** -0.5 if model.startswith("falcon") else 1.0
    return torch.tensor([x * scale for x in alibi_slopes(hq)], dtype=torch.float32,
                        device="cuda")


def _alibi_all(tag, launches, entries):
    """Every launch of each of ``entries`` on a served ALiBi path was in
    ALiBi mode."""
    counts = {n: (launches.get(n, 0), launches.get(n + "_alibi", 0)) for n in entries}
    ok = all(a == b > 0 for a, b in counts.values())
    _line(tag, check="alibi_mode", launches=",".join(f"{n}:{a}/{b}" for n, (a, b) in
                                                     counts.items()), ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: an attention launch on the ALiBi path ran without the bias "
                         f"({counts})")


def phase_alibi():
    """``[alibi]``: the ALiBi mode of every decode and prefill entry of each
    pool type at D 64 and 128 (``ALIBI_CASES``) against its plain version,
    tolerance as ``_check``: decode rows of ``HD_DECODE_LENS`` tokens with
    and without a window and the deferred current token; prefill rows
    ``HD_PREFILL`` (offsets 0, 37, 1000) and the verify window
    ``ALIBI_VERIFY``; pools whose dead slots hold NaN. The builds with a
    planted fault (``ALIBI_FAULTS``) must fail the same check: decode at
    every case, prefill where G > 1. Times of the served heads: K1 at 64 x
    2048, K2 at 8 x 8192 (a replayed graph of 8 calls), K3 at T 2048 from 0
    and behind 1000 cached tokens, each beside its plain version, SDPA with
    the bias as a float mask on the same (dequantized) rows and its bound
    (bytes for K1 / K2, as uncapped: ALiBi adds no bytes; operations for
    K3), and the same entry at the same shape without the bias. Returns
    {(op, kind, D): record} of the served heads (K1 64 x 2048, K3 2048 from
    0)."""
    import torch

    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ALIBI_SEED)
    records = {}
    for model, d, hq, hkv, timed in ALIBI_CASES:
        g = hq // hkv
        slopes = _model_slopes(model, hq, d)
        for kind in HD_KINDS:
            def faults(cap, op, kind=kind, d=d):
                return ALIBI_FAULTS[0 if op == "decode" else 1][2], _alibi_fault(
                    op, dtypes[kind], kind, d)

            worst = _decode_checks(gen, "alibi", model, d, hq, hkv, 1000, kind, (0.0,),
                                   lambda cap: faults(cap, "decode"), alibi=slopes)
            worst_p = _prefill_checks(gen, "alibi", model, d, hq, hkv, 0, kind, (0.0,),
                                      (lambda cap: faults(cap, "prefill")) if g > 1 else None,
                                      own_rows=False, alibi=slopes)
            worst_p = max(worst_p, _prefill_checks(
                gen, "alibi", model, d, hq, hkv, 0, kind, (0.0,),
                (lambda cap: faults(cap, "prefill")) if g > 1 else None, own_rows=False,
                alibi=slopes, rows=ALIBI_VERIFY))
            if not timed:
                continue
            for rows, ctx in ALIBI_DECODE_SHAPES:
                r = _hd_decode_time(gen, kind, d, hq, hkv, rows, ctx, 0.0, alibi=slopes)
                bare = _hd_decode_time(gen, kind, d, hq, hkv, rows, ctx, 0.0)
                _line("alibi-time", op="decode", model=model, D=d, G=g, pool=kind, B=rows,
                      ctx_tokens=r["ntok"], ms=f"{r['ms']:.4f}",
                      device_ms=f"{r['device_ms']:.4f}",
                      without_alibi_device_ms=f"{bare['device_ms']:.4f}",
                      plain_ms=f"{r['plain_ms']:.4f}",
                      library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                      bound_by=r["bound_by"],
                      share_of_bound=f"{r['bound_ms'] / r['device_ms']:.2f}")
                if (rows, ctx) == ALIBI_DECODE_SHAPES[0]:
                    records[("decode", kind, d)] = dict(
                        ms=r["device_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"], max_abs_err=worst)
            for off in ALIBI_PREFILL_OFFSETS:
                r = _hd_prefill_time(gen, kind, d, hq, hkv, HD_TIME_CTX, 0.0, alibi=slopes,
                                     off=off)
                bare = _hd_prefill_time(gen, kind, d, hq, hkv, HD_TIME_CTX, 0.0, off=off)
                _line("alibi-time", op="prefill", model=model, D=d, G=g, pool=kind,
                      T=HD_TIME_CTX, q_offset=off, ms=f"{r['ms']:.4f}",
                      without_alibi_ms=f"{bare['ms']:.4f}",
                      plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['library_ms']:.4f}",
                      bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
                      share_of_bound=f"{r['bound_ms'] / r['ms']:.2f}")
                if off == 0:
                    records[("prefill", kind, d)] = dict(r, max_abs_err=worst_p)
    _line("alibi", seconds=f"{time.time() - t0:.1f}")
    return records


# [baichuan2-13b] / [bloom-7b1] / [falcon-rw-1b] / [mpt-7b]: 8 prompts of
# 500-2000 tokens and a lone 1000, 32 out, on 512 blocks of 64 (Baichuan2-13B:
# 819 KB of KV a token, 26.8 GB); MPT-7B cut to FAMILY_LAYERS_CUT layers
ALIBI_PROMPTS = (500, 700, 900, 1100, 1300, 1500, 1800, 2000)
ALIBI_BLOCKS = 512
# the verify engine beside the served one: 8 rows of about 1000 tokens
ALIBI_SPEC_BLOCKS = 192
ALIBI_SEEDS = {"baichuan2-13b": 27, "bloom-7b1": 28, "falcon-rw-1b": 29, "mpt-7b": 30}


def _alibi_weights(model, seed, name):
    """bf16 weights of an ALiBi family's config as the loader gives them
    (std 0.02, norms 1), fused, from a generator of their own: Baichuan2's
    LM head rows L2-normalised (``NormHead``, as the loader does); tied
    families without a head; LayerNorm families (bloom, falcon) with norm
    and linear biases under their linears' names, bloom's ``embed_norm``;
    no gate where the MLP is not gated; falcon's parallel form without
    ``post_attn_norm``."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import arch_of

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    w = random_weights(cfg, wgen)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    rand = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
        0.0, 0.02, generator=wgen)
    if cfg.tie_word_embeddings:
        del w["lm_head"]
    elif cfg.norm_head:
        w["lm_head"] = torch.nn.functional.normalize(w["lm_head"].float(), dim=0).to(
            torch.bfloat16)
    if cfg.parallel_residual:
        del w["post_attn_norm"]
    if cfg.norm_type == "layernorm":
        for p in ("q", "k", "v"):
            w[f"{p}_proj.bias"] = w.pop(f"{p}_bias")
        w.update({"o_proj.bias": rand(L, H), "up_proj.bias": rand(L, I),
                  "down_proj.bias": rand(L, H), "input_norm.bias": rand(L, H),
                  "final_norm.bias": rand(H)})
        if not cfg.parallel_residual:
            w["post_attn_norm.bias"] = rand(L, H)
    if arch_of(cfg.model_type) == "bloom":
        w["embed_norm"] = torch.ones(H, dtype=torch.bfloat16, device="cuda")
        w["embed_norm.bias"] = rand(H)
    weights = model.fuse_weights(w)
    torch.cuda.synchronize()
    _line("weights", model=name, layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


def _alibi_verify(tag, model, weights, normal):
    """The speculative verify window on an ALiBi model: a prompt-lookup
    engine on the same weights serves prompts that repeat a segment beside
    the normal engine; its verify graphs launch K3 once a layer a replay,
    in ALiBi mode; verify windows ran; the two engines' tokens agree at every
    decisive position (``_decisive_mismatches``); plain attention never."""
    import torch

    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS, prefill

    cfg = model.cfg
    spec = make_engine(model, weights, num_blocks=ALIBI_SPEC_BLOCKS, slots=SPEC_ROWS,
                       speculative="prompt_lookup")
    k3 = prefill.kernel_for(torch.bfloat16, cfg.head_dim)
    k3a = collections.namedtuple("Counted", "name launches")(
        k3.name + "_alibi", prefill.ALIBI[(torch.bfloat16, cfg.head_dim)])
    fields, bad = _graph_launches(spec, {("verify", k3): cfg.num_layers,
                                         ("verify", k3a): cfg.num_layers})
    prompts = _spec_prompts(_spec_gen(ALIBI_SEEDS[tag] + 100), cfg.vocab_size)
    PLAIN_CALLS.n = 0
    want, _, _ = _serve_greedy(normal, prompts, max_new=32)
    got, _, st = _serve_greedy(spec, prompts, max_new=32)
    plain = PLAIN_CALLS.n
    equal, decisive, loose = _decisive_mismatches(normal, prompts, want, got, TEACHER_TOL)
    ok = not bad and st["steps"] > 0 and not decisive and plain == 0
    _line(tag, check="verify_window", rows=len(prompts), k=SPEC_K, rows_equal=equal,
          decisive_mismatches=decisive or "none", loose_mismatches=loose or "none",
          plain_attention_calls=plain, **fields, **_spec_stats_fields(st), ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: the verify window on the ALiBi path failed ({bad}, "
                         f"{st['steps']} verify steps, decisive {decisive}, plain {plain})")
    del spec


def _alibi_family(tag, cfg, card, layers=None, kvs=(), verify=False, tail=True):
    """Serve one ALiBi family (``_family_serve``: the every-launch-in-ALiBi
    check among its checks), its verify window with ``verify``, then the
    same weights on each pool of ``kvs`` (K1 / K3 of that pool in ALiBi
    mode). Returns ({entry: launches}, plain calls)."""
    import dataclasses

    import torch

    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    t0 = time.time()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _alibi_weights(model, ALIBI_SEEDS[tag],
                             tag + (f"-{layers}-layers" if layers else ""))
    own = torch.Generator(device="cuda")
    own.manual_seed(ALIBI_SEEDS[tag])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in ALIBI_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=ALIBI_BLOCKS, slots=FAM_SLOTS, tail=tail)
    launches, plain_calls = _family_serve(tag, engine, cfg, prompts, lone)
    if verify:
        _alibi_verify(tag, model, weights, engine)
    del engine
    _release()
    dtypes = {"int8": torch.int8, "fp8": FP8}
    for kv in kvs:
        engine = make_engine(model, weights, kv=kv, num_blocks=ALIBI_BLOCKS, slots=FAM_SLOTS,
                             prefix=False)
        st, got, plain = _serve_family(engine, prompts[:4], FAM_OUT)
        entries = [decode.kernel_for(dtypes[kv], cfg.head_dim).name,
                   prefill.kernel_for(dtypes[kv], cfg.head_dim).name]
        _served_ok(f"{tag}:{kv}", st, FAM_OUT, got, plain,
                   entries + [n + "_alibi" for n in entries])
        _alibi_all(f"{tag}:{kv}", got, entries)
        launches.update(got)
        plain_calls += plain
        del engine
        _release()
    del weights
    _line(tag, seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_alibi_families(card):
    """The ALiBi families served through ``make_engine`` with seeded random
    bf16 weights, every earlier engine released: ``[baichuan2-13b]``
    (Baichuan2-13B at full width and depth: 40 layers, 40 / 40 heads of 128,
    its NormHead; with the verify window, whose tokens meet near ties: the
    normalised head leaves random-weight logits flat), ``[bloom-7b1]`` (full
    depth: embedding LayerNorm, biased LayerNorms and linears, gelu-tanh;
    with the verify window, on decisive logits),
    ``[falcon-rw-1b]`` (full depth, D 64: the corrected falcon path, slopes
    times sm_scale, exact GELU; then on int8 and fp8 pools) and
    ``[mpt-7b]`` (a 4-layer cut at its width: weight-only LayerNorms, exact
    GELU; then on int8 and fp8 pools). Returns ({entry: launches}, plain
    calls)."""
    from rtp_llm_tpu_torch.config.model_config import (
        baichuan2_13b_config, bloom_7b1_config, falcon_rw_1b_config, mpt_7b_config,
    )

    _release()
    launches, plain_calls = collections.Counter(), 0
    for tag, cfg, kw in (
            ("baichuan2-13b", baichuan2_13b_config(), dict(verify=True)),
            ("bloom-7b1", bloom_7b1_config(), dict(verify=True)),
            ("falcon-rw-1b", falcon_rw_1b_config(), dict(kvs=("int8", "fp8"), tail=False)),
            ("mpt-7b", mpt_7b_config(), dict(layers=FAMILY_LAYERS_CUT, kvs=("int8", "fp8"),
                                             tail=False))):
        got, plain = _alibi_family(tag, cfg, card, **kw)
        launches.update(got)
        plain_calls += plain
        _release()
    return launches, plain_calls


# ---------------------------------------------------------------- the
# multi-query families (StarCoder-15.5B, Falcon-7B, a cut of Falcon-40B) and
# the head-chunk mode of the attention kernels

# [starcoder-15b] / [falcon-7b] / [falcon-40b]: 8 prompts of 500-2000 tokens
# and a lone 1000, 32 out, on 512 blocks of 64 (ALIBI_PROMPTS, ALIBI_BLOCKS);
# Falcon-40B at FALCON_40B_LAYERS of its 60 layers (60 would take 83.7 GB of
# bf16 weights alone)
MQA_SEEDS = {"starcoder-15b": 32, "falcon-7b": 33, "falcon-40b": 34}
FALCON_40B_LAYERS = 30


def _mqa_weights(model, seed, name):
    """bf16 weights of a multi-query family's config as the loader gives
    them (std 0.02, norms 1), fused, from a generator of their own: tied
    embeddings (no LM head); LayerNorm biases; gpt_bigcode's linear biases
    and its learned positions ``pos_embed`` (``n_positions`` rows); one
    norm feeding falcon's parallel attention and MLP (the multi-query form)
    or two (the new decoder's ``ln_attn`` / ``ln_mlp``)."""
    import torch

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    w = random_weights(cfg, wgen)
    del w["lm_head"]
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    rand = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
        0.0, 0.02, generator=wgen)
    w.update({"input_norm.bias": rand(L, H), "final_norm.bias": rand(H)})
    if cfg.parallel_residual and cfg.parallel_norms == "shared":
        del w["post_attn_norm"]
    else:
        w["post_attn_norm.bias"] = rand(L, H)
    if cfg.attention_bias:  # gpt_bigcode: every linear biased
        w.update({"o_proj.bias": rand(L, H), "up_proj.bias": rand(L, I),
                  "down_proj.bias": rand(L, H)})
    if cfg.use_learned_positions:
        w["pos_embed"] = rand(cfg.max_position_embeddings, H)
    weights = model.fuse_weights(w)
    torch.cuda.synchronize()
    _line("weights", model=name, layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


def _mqa_family(tag, cfg, card, layers=None, kvs=()):
    """Serve one multi-query family (``_family_serve``: TTFT, tok/s at 8
    rows, peak memory, the teacher-forced logprobs, every K1 / K3 launch in
    the group mode), then the same weights on each pool of ``kvs`` (K1 / K3
    of that pool, every launch in the mode). Returns ({entry: launches},
    plain calls)."""
    import dataclasses

    import torch

    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    t0 = time.time()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _mqa_weights(model, MQA_SEEDS[tag], tag + (f"-{layers}-layers" if layers else ""))
    own = torch.Generator(device="cuda")
    own.manual_seed(MQA_SEEDS[tag])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in ALIBI_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=ALIBI_BLOCKS, slots=FAM_SLOTS)
    launches, plain_calls = _family_serve(tag, engine, cfg, prompts, lone)
    _line(tag, check="config", layers=cfg.num_layers, G=cfg.num_attention_heads // cfg.num_kv_heads,
          D=cfg.head_dim, chunks_a_kv_head=len(decode.head_chunks(
              cfg.num_attention_heads // cfg.num_kv_heads)),
          max_seq_len=engine.config.scheduler.max_seq_len,
          learned_positions=cfg.use_learned_positions, parallel_norms=cfg.parallel_norms)
    del engine
    _release()
    mode = _group_mode(cfg)
    dtypes = {"int8": torch.int8, "fp8": FP8}
    for kv in kvs:
        engine = make_engine(model, weights, kv=kv, num_blocks=ALIBI_BLOCKS, slots=FAM_SLOTS,
                             prefix=False)
        st, got, plain = _serve_family(engine, prompts[:4], FAM_OUT)
        entries = [decode.kernel_for(dtypes[kv], cfg.head_dim).name,
                   prefill.kernel_for(dtypes[kv], cfg.head_dim).name]
        pool = entries[0].split("paged_decode")[1].split("_d")[0]
        _served_ok(f"{tag}:{kv}", st, FAM_OUT, got, plain,
                   entries + [f"paged_decode{pool}{mode}", f"paged_prefill{pool}{mode}"])
        _group_mode_all(f"{tag}:{kv}", got, entries, mode)
        launches.update(got)
        plain_calls += plain
        del engine
        _release()
    del weights
    _line(tag, seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_mqa_families(card):
    """The multi-query families served through ``make_engine`` with seeded
    random bf16 weights, every earlier engine released: ``[starcoder-15b]``
    (StarCoder at full width and depth: 40 layers, 48 query heads on one kv
    head of 128, learned positions over 8192, biased LayerNorms and linears,
    exact GELU; K1 / K3 in three head chunks), ``[falcon-7b]`` (full width
    and depth: 32 layers, 71 query heads on one kv head of 64, RoPE, one
    norm feeding the parallel attention and MLP; five head chunks; then on
    int8 and fp8 pools) and ``[falcon-40b]`` (full width, FALCON_40B_LAYERS
    of its 60 layers: 128 / 8 heads of 64, G 16 on two n8 tiles, the new
    decoder's ln_attn / ln_mlp). Returns ({entry: launches}, plain calls)."""
    from rtp_llm_tpu_torch.config.model_config import (
        falcon_7b_config, falcon_40b_config, starcoder_15b_config,
    )

    _release()
    launches, plain_calls = collections.Counter(), 0
    for tag, cfg, kw in (
            ("starcoder-15b", starcoder_15b_config(), {}),
            ("falcon-7b", falcon_7b_config(), dict(kvs=("int8", "fp8"))),
            ("falcon-40b", falcon_40b_config(), dict(layers=FALCON_40B_LAYERS))):
        got, plain = _mqa_family(tag, cfg, card, **kw)
        launches.update(got)
        plain_calls += plain
        _release()
    return launches, plain_calls


# ---------------------------------------------------------------- the
# partial-rotary families (Phi-2, GLM-4-9B-0414, ChatGLM3-6B, GPT-NeoX-20B,
# Qwen-7B) and the D 80 mode of the attention kernels

# each family's weights and prompts from a generator of its own; the ALiBi
# families' prompts (8 of 500-2000 tokens, a lone 1000, 32 out) on
# ALIBI_BLOCKS blocks of 64, but GPT-NeoX-20B: its 44 layers hold 41.1 GB of
# bf16 weights and a token of its KV 1.08 MB, so its pool is sized for the
# serve's tokens, NEOX_BLOCKS of 64 (17.7 GB), at full depth
PARTIAL_SEEDS = {"phi-2": 40, "glm4-9b": 41, "chatglm3-6b": 42, "gpt-neox-20b": 43,
                 "qwen-7b": 44}
NEOX_BLOCKS = 256


def _partial_weights(model, seed, name):
    """bf16 weights of a partial-rotary family's config as the loader gives
    them (std 0.02, norms 1), fused, from a generator of their own: glm4's
    sandwich norms (``pre_ffn_norm`` / ``post_ffn_norm``), the LayerNorm
    families' norm and linear biases (phi: one norm a layer, its LM head's
    bias; gpt_neox: two norms a layer), qkv biases where the family has
    them."""
    import torch

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    w = random_weights(cfg, wgen)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    rand = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
        0.0, 0.02, generator=wgen)
    if cfg.parallel_residual and cfg.parallel_norms == "shared":
        del w["post_attn_norm"]
    if cfg.sandwich_norms:
        for n in ("pre_ffn_norm", "post_ffn_norm"):
            w[n] = torch.ones((L, H), dtype=torch.bfloat16, device="cuda")
    if cfg.norm_type == "layernorm":
        w.update({n + ".bias": rand(*w[n].shape)
                  for n in ("input_norm", "post_attn_norm", "final_norm") if n in w})
        w.update({"o_proj.bias": rand(L, H), "up_proj.bias": rand(L, I),
                  "down_proj.bias": rand(L, H)})
    if cfg.lm_head_bias:
        w["lm_head.bias"] = rand(cfg.vocab_size)
    weights = model.fuse_weights(w)
    torch.cuda.synchronize()
    _line("weights", model=name, layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


def _entries_only(tag, launches, entries):
    """Every attention launch of a served path was in one of ``entries``
    (K1 / K3 of the model's head width and pool type), each launched."""
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    names = {k.name for k in (*decode.KERNELS_BY_DIM.values(), *prefill.KERNELS_BY_DIM.values())}
    stray = {n: c for n, c in launches.items() if n in names and n not in entries and c}
    ok = not stray and all(launches.get(n, 0) > 0 for n in entries)
    _line(tag, check="entries", entries=",".join(f"{n}:{launches.get(n, 0)}" for n in entries),
          stray=",".join(f"{n}:{c}" for n, c in stray.items()) or "none", ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: an attention launch ran outside {entries} ({stray})")


def _partial_family(tag, cfg, card, kvs=(), num_blocks=ALIBI_BLOCKS):
    """Serve one partial-rotary family (``_family_serve``: TTFT cold and
    warm, tok/s at 8 rows, peak memory, ``decode_steps`` 4, the teacher-
    forced logprobs; the group mode where G > 8), every K1 / K3 launch in
    the entries of its head width (``_entries_only``), then the same weights
    on each pool of ``kvs``. Returns ({entry: launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    t0 = time.time()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _partial_weights(model, PARTIAL_SEEDS[tag], tag)
    own = torch.Generator(device="cuda")
    own.manual_seed(PARTIAL_SEEDS[tag])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in ALIBI_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=num_blocks, slots=FAM_SLOTS)
    launches, plain_calls = _family_serve(tag, engine, cfg, prompts, lone)
    d = cfg.head_dim
    _entries_only(tag, launches, [decode.kernel_for(torch.bfloat16, d).name,
                                  prefill.kernel_for(torch.bfloat16, d).name])
    _line(tag, check="config", layers=cfg.num_layers, D=d, rotary_dim=cfg.rotary_dim,
          rotation=("whole head" if cfg.rotary_dim == d else
                    "pairs" if cfg.rope_partial_interleaved else "halves"),
          G=cfg.num_attention_heads // cfg.num_kv_heads, pool_blocks=num_blocks,
          parallel_residual=cfg.parallel_residual, parallel_norms=cfg.parallel_norms,
          sandwich_norms=cfg.sandwich_norms, lm_head_bias="lm_head.bias" in weights)
    del engine
    _release()
    dtypes = {"int8": torch.int8, "fp8": FP8}
    for kv in kvs:
        engine = make_engine(model, weights, kv=kv, num_blocks=num_blocks, slots=FAM_SLOTS,
                             prefix=False)
        st, got, plain = _serve_family(engine, prompts[:4], FAM_OUT)
        entries = [decode.kernel_for(dtypes[kv], d).name, prefill.kernel_for(dtypes[kv], d).name]
        _served_ok(f"{tag}:{kv}", st, FAM_OUT, got, plain, entries)
        _entries_only(f"{tag}:{kv}", got, entries)
        launches.update(got)
        plain_calls += plain
        del engine
        _release()
    del weights
    _line(tag, seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def phase_partial_rotary_families(card):
    """The partial-rotary families served through ``make_engine`` with
    seeded random bf16 weights, every earlier engine released: ``[phi-2]``
    (full width and depth: 32 / 32 heads of 80, RoPE in halves over 32 dims,
    one biased LayerNorm feeding the parallel attention and MLP, the LM
    head's bias; every K1 / K3 launch in the ``_d80`` entries; then on int8
    and fp8 pools), ``[glm4-9b]`` (GLM-4-9B-0414 at full width and depth: 32
    / 2 heads of 128 in the ``_g9to16`` mode, RoPE in pairs over half the
    head, sandwich norms), ``[chatglm3-6b]`` (full width and depth, the same
    RoPE and group), ``[gpt-neox-20b]`` (full width and depth, 64 / 64 heads
    of 96, RoPE in halves over 24 dims, the "dual" parallel residual, its
    pool NEOX_BLOCKS) and ``[qwen-7b]`` (full width and depth, full-head
    RoPE). Returns ({entry: launches}, plain calls)."""
    from rtp_llm_tpu_torch.config.model_config import (
        chatglm3_6b_config, glm4_9b_config, gpt_neox_20b_config, phi_2_config, qwen_7b_config,
    )

    _release()
    launches, plain_calls = collections.Counter(), 0
    for tag, cfg, kw in (
            ("phi-2", phi_2_config(), dict(kvs=("int8", "fp8"))),
            ("glm4-9b", glm4_9b_config(), {}),
            ("chatglm3-6b", chatglm3_6b_config(), {}),
            ("gpt-neox-20b", gpt_neox_20b_config(), dict(num_blocks=NEOX_BLOCKS)),
            ("qwen-7b", qwen_7b_config(), {})):
        got, plain = _partial_family(tag, cfg, card, **kw)
        launches.update(got)
        plain_calls += plain
        _release()
    return launches, plain_calls


# ---------------------------------------------------------------- longrope

# [longrope]: Phi-3-mini's widths (D 96, 32 / 32 heads, 32 layers) with a
# longrope block as Phi-3-mini-128k publishes it (original 4096, 131072
# positions), its 48 short and long factors drawn from LONGROPE_SEED (the
# published lists are not in the repository); no window (the 128k config's
# 262144 exceeds every context here). Stream A prefills LONGROPE_SHORT
# tokens and decodes past the switch, stream B prefills LONGROPE_LONG
LONGROPE_SEED, LONGROPE_ORIG, LONGROPE_BLOCKS = 45, 4096, 400
LONGROPE_SHORT, LONGROPE_LONG, LONGROPE_OUT = 3900, 4300, 256
# a pooled key row against the rotation of its table: bf16 roundings of the
# product and the row (~1e-2); against the other table's, O(1) past a few
# hundred positions
K_ROW_TOL = 0.05


def _longrope_config():
    import torch

    from rtp_llm_tpu_torch.config.model_config import phi3_mini_config

    gen = torch.Generator()
    gen.manual_seed(LONGROPE_SEED)
    short = (1.0 + 0.2 * torch.rand(48, generator=gen, dtype=torch.float64)).tolist()
    long = (1.0 + 30.0 * torch.rand(48, generator=gen, dtype=torch.float64)).sort().values.tolist()
    return dataclasses.replace(
        phi3_mini_config(), max_position_embeddings=131072, sliding_window=0,
        rope_scaling={"type": "longrope", "short_factor": short, "long_factor": long,
                      "original_max_position_embeddings": LONGROPE_ORIG})


def _k_rows_by_table(engine, tokens, blocks, positions):
    """(relative L2 of layer 0's pooled K rows at ``positions`` against
    the short table's rotation, against the long table's) per position:
    layer 0's K is the rotated product of the tokens' normed embeddings, so
    each written row shows which table turned it."""
    import torch

    from rtp_llm_tpu_torch.ops.rope import rope_at

    model, w, cfg = engine.model, engine.weights, engine.model.cfg
    hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.tensor(positions, device="cuda")
    ids = torch.tensor([tokens[p] for p in positions], device="cuda")
    x = model._norm_at(w, "input_norm", w["embed_tokens"][ids], 0)
    k = model._product(w, "qkv_proj", 0, x)[:, hq * d: (hq + hkv) * d].view(-1, hkv, d)
    bs = engine.block_size
    slots = torch.tensor([blocks[p // bs] * bs + p % bs for p in positions], device="cuda")
    got = engine.kv[0, 0].index_select(0, slots).float().view(-1, hkv, d)
    out = []
    for offset in (0, cfg.max_position_embeddings):  # the short rows, the long rows
        want = model.rotate(k, *rope_at(pos + offset, model.cos, model.sin)).float()
        out.append(((got - want).norm(dim=(1, 2)) / want.norm(dim=(1, 2))).tolist())
    return list(zip(*out))


@_stage("phase_longrope")
def phase_longrope(card):
    """``[longrope]``: Phi-3-mini widths with a seeded longrope block, full
    depth, served through ``make_engine`` (graphed decode, prefix cache). A
    stream of LONGROPE_SHORT tokens decodes past the switch inside the
    decode graphs, one of LONGROPE_LONG prefills on the long table. Checks:
    the served logprobs against a teacher-forced plain forward whose chunks
    pick their table as the served forwards did (``_teacher_chunked``:
    chunks of 1024 end at the switch), the decisive greedy tokens equal;
    the switch seen at its step (past it, the served logprobs sit far from a
    teacher that never switches, and before it, from one that switched from
    the start); prefix blocks never cross tables (a short prompt reuses the
    short stream's blocks, a long one sharing its first 3968 tokens reuses
    none, a long one sharing the long stream's reuses them); every K1 / K3
    launch in the D 96 entries. Returns ({entry: launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig
    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    t0 = time.time()
    cfg = _longrope_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _partial_weights(model, LONGROPE_SEED, "phi3-mini-longrope")
    own = torch.Generator(device="cuda")
    own.manual_seed(LONGROPE_SEED)
    rand = lambda n: torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
    p_short, p_long = rand(LONGROPE_SHORT), rand(LONGROPE_LONG)
    engine = make_engine(model, weights, num_blocks=LONGROPE_BLOCKS, slots=8)
    kernels, plain = _attention_counters()
    for k in kernels:
        k.launches.n = 0
    plain.n = 0
    kept, release = {}, engine.scheduler.release

    def keep_blocks(stream):  # each stream's block table, for the K rows below
        if stream.alloc is not None:
            kept["a" if stream.prompt_len == LONGROPE_SHORT else "b"] = list(stream.alloc.blocks)
        release(stream)

    engine.scheduler.release = keep_blocks
    (a, b), firsts, tok_s, secs = _timed_serve(engine, [p_short, p_long], LONGROPE_OUT)
    engine.scheduler.release = release
    torch.cuda.synchronize()
    launches = collections.Counter({k.name: k.launches.n for k in kernels if k.launches.n})
    plain_calls = plain.n
    entries = [decode.kernel_for(torch.bfloat16, 96).name,
               prefill.kernel_for(torch.bfloat16, 96).name]
    _served_ok("longrope", [a, b], LONGROPE_OUT, launches, plain_calls, entries)
    _entries_only("longrope", launches, entries)
    graphs = engine._graphs.replays
    # the switch at its step: layer 0's K rows of A just before and past
    # it, and of B from its first position, against each table's rotation
    # (before any other allocation writes the pool)
    at = LONGROPE_ORIG
    where = {"a": [at - 2, at - 1, at, at + 1, at + 50],  # A: short, short, long ...
             "b": [at // 2, LONGROPE_LONG // 4, at - 1, at, LONGROPE_LONG - 1]}  # B: all long
    rows = {"a": _k_rows_by_table(engine, a.prompt_token_ids + a.output_token_ids, kept["a"],
                                  where["a"]),
            "b": _k_rows_by_table(engine, b.prompt_token_ids, kept["b"], where["b"])}
    want_long = {"a": [False, False, True, True, True], "b": [True] * 5}
    seen = all((lng < K_ROW_TOL < sht) if is_long else (sht < K_ROW_TOL < lng)
               for t in rows for (sht, lng), is_long in zip(rows[t], want_long[t]))
    _line("longrope", check="switch", switch=at, short_prompt=LONGROPE_SHORT,
          long_prompt=LONGROPE_LONG, first_long_output=at - LONGROPE_SHORT,
          k_rows_rel_l2_short_long=";".join(f"{t}@{p}:{sht:.3g}/{lng:.3g}" for t in rows
                                            for p, (sht, lng) in zip(where[t], rows[t])),
          tol=K_ROW_TOL, ok=seen)
    if not seen:
        raise SystemExit("longrope: a key row was not turned by its stream's table")
    _teacher_check("longrope", engine, [a, b])
    # prefix reuse across the tables
    ctx_a = a.prompt_token_ids + a.output_token_ids
    orig = LONGROPE_ORIG
    reqs = {"short_behind_a": p_short[: orig * 3 // 4] + rand(orig // 16),
            "long_sharing_a": ctx_a[: orig * 31 // 32] + rand(orig // 8),
            "long_sharing_b": p_long[: LONGROPE_LONG - 100] + rand(40)}
    got = {}
    for name, prompt in reqs.items():
        s = engine.enqueue(prompt, GenerateConfig(max_new_tokens=4, do_sample=False,
                                                  ignore_eos=True))
        while engine.has_work():
            engine.step()
        got[name] = s.reuse_len
    ok = (got["short_behind_a"] > 0 and got["long_sharing_a"] == 0
          and got["long_sharing_b"] > 0)
    _line("longrope", check="prefix_tables",
          reuse=",".join(f"{n}:{v}" for n, v in got.items()), ok=ok)
    if not ok:
        raise SystemExit("longrope: a prefix block crossed RoPE tables")
    _line("longrope", check="serve", ttft_ms=",".join(f"{x:.0f}" for x in firsts),
          decode_tok_s=f"{tok_s:.1f}", seconds=f"{secs:.2f}", graph_replays=graphs,
          layers=cfg.num_layers, D=cfg.head_dim, seconds_total=f"{time.time() - t0:.1f}",
          card=card.replace(" ", "_"))
    del engine, weights, model
    _release()
    return launches, plain_calls


# ---------------------------------------------------------------- MoE

# [moe-kernels]: X6 at the three served models' expert shapes, (name, E,
# top-k, H, I), with the rows of a 64-slot decode step and a 2048-token
# prefill, every instance (rows a tile) against the plain product; the check
# is _check_gemm's (both sum in f32 and round once). MOE_RAGGED: E, top-k, K
# = N, tokens of a synthetic shape whose K and N are multiples of 8 but not
# of 64 or 128 (the only check of W's zero-fill past K and the column masks)
MOE_SHAPES = (("qwen3-30b-a3b", 128, 8, 2048, 768), ("qwen1.5-moe-a2.7b", 60, 4, 2048, 1408),
              ("mixtral-8x7b", 8, 2, 4096, 14336))
MOE_TOKENS = (64, 2048)
MOE_RAGGED = (8, 2, 1416, 1024)
# -DMOE_GEMM_FAULT=n builds: (name, n, where it must be caught). 2 shows
# only where an expert has a second tile, 3 only past a ring's first round,
# 4 only at a K off a multiple of 64
MOE_FAULTS = (("last_k_stage_left_out", 1), ("second_tile_reads_the_first_tiles_rows", 2),
              ("full_parity_never_flips", 3), ("w_map_2d_over_experts", 4))
MOE_SEED = 46
# [moe-time]: the sweep that sets ops/moe.py TILE_SWITCH, at MOE_SWEEP_TOKENS
# and at each model's tokens for MOE_SWITCH_ROWS rows an expert (plain times
# at MOE_PLAIN_TOKENS only: one matmul an expert is slow)
MOE_SWEEP_TOKENS = (8, 16, 64, 256, 512, 1000, 2048, 4096)
MOE_SWITCH_ROWS = (40, 48, 56, 80, 96, 160, 180, 224, 360)
MOE_PLAIN_TOKENS = (64, 2048)
MOE_ROUNDS = 3  # interleaved timing rounds a sweep point (each height's least)


def _moe_fault_kernels():
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import moe

    k = moe.KERNELS["moe_gemm"]
    return {name: _kernels.Kernel(f"{k.name}:{name}", "moe_grouped_gemm.cu", k.entry, k.argtypes,
                                  defines=(f"MOE_GEMM_FAULT={n}",))
            for name, n in MOE_FAULTS}


def _card_state():
    """The card's SM clock, power draw and active throttle reasons, as
    ``nvidia-smi`` reads them now."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                          "clocks_throttle_reasons.active", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().replace(" ", "") if smi.returncode == 0 else "unavailable"


def _moe_gather_kernel():
    """X6 built with -DMOE_DOWN_GATHER=1: the down product's x rows by the
    gate-up product's cp.async gather instead of a TMA map (timed beside
    the map in [moe-time], never served)."""
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops import moe

    k = moe.KERNELS["moe_gemm"]
    return _kernels.Kernel(f"{k.name}:down_gather", "moe_grouped_gemm.cu", k.entry, k.argtypes,
                           defines=("MOE_DOWN_GATHER=1",))


def _moe_library(xs, w, offsets):
    """(one PyTorch call computing the same grouped product, its label):
    ``torch._grouped_mm`` where the card's PyTorch has it, else a loop of one
    ``torch.matmul`` an expert (the offsets read on the host)."""
    import torch

    if hasattr(torch, "_grouped_mm"):
        ends = offsets[1:].contiguous()
        return (lambda: torch._grouped_mm(xs, w, offs=ends)), "torch._grouped_mm"
    off = offsets.tolist()
    return (lambda: [xs[off[e]: off[e + 1]] @ w[e] for e in range(w.shape[0])
                     if off[e + 1] > off[e]]), "matmul_loop"


def _moe_launcher(kernel, x, w, offsets, rows, tm):
    """(y, a call of ``kernel`` at tile height ``tm`` writing y): X6's C
    entry with its operands made once, for checks and kernel-only times."""
    import torch

    from rtp_llm_tpu_torch import _kernels

    e, k, n = w.shape
    r = x.shape[0] if rows is None else rows.shape[0]
    y = torch.full((r, n), float("nan"), dtype=torch.bfloat16, device=x.device)
    r32 = None if rows is None else rows.to(torch.int32).contiguous()
    st = _kernels.stream_ptr(x.device)
    return y, lambda: kernel.launch(x.data_ptr(), x.stride(0),
                                    None if r32 is None else r32.data_ptr(), w.data_ptr(),
                                    offsets.data_ptr(), y.data_ptr(), y.stride(0), r, k, n, e,
                                    tm, st)


def _moe_case(gen, e, top, h, n, routing, i):
    """x [n, h], the routing (idx, wts), the sorted rows, offsets, and the
    activation rows [n * top, i] of one MoE layer's products."""
    import torch

    from rtp_llm_tpu_torch.ops import moe

    x = torch.randn((n, h), generator=gen, device="cuda").bfloat16()
    logits = torch.randn((n, e), generator=gen, device="cuda")
    if routing == "skewed":  # most groups empty
        logits[:, : e - max(2, e // 8)] -= 12.0
    idx, wts = moe.route(logits, top, True)
    order, off = moe.sort_by_expert(idx, e)
    rows = torch.div(order, top, rounding_mode="floor")
    act = torch.randn((n * top, i), generator=gen, device="cuda").bfloat16()
    return x, idx, wts, rows, off, act


def phase_moe_kernels():
    """``[moe-kernels]`` / ``[moe-time]``: X6 against the plain grouped
    product (one matmul an expert, f32) at the three models' shapes, decode
    and prefill rows, gate-up through the token gather and down, with empty
    experts (a skewed routing), through the wrapper and at every instance;
    the synthetic ragged shape at every instance; the planted faults must
    fail the same check. Then the sweep: every instance's time (CUDA events,
    the kernel alone) at MOE_SWEEP_TOKENS beside the byte bound (the touched
    experts' slices, x's rows once, y) or the operation bound, the plain
    version, the library call and the wrapper (the served instance), and
    each token count's fastest instance against ``tile_rows``' pick. Returns
    the record of the JSON's X6 row: the wrapper at Qwen3-30B-A3B's
    2048-token gate-up."""
    import torch

    from rtp_llm_tpu_torch.ops import moe

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MOE_SEED)
    x6 = moe.KERNELS["moe_gemm"]
    faults = _moe_fault_kernels()
    worst = 0.0
    caught = {name: False for name, _ in MOE_FAULTS}

    def held(tag, got, want, tm):
        nonlocal worst
        err, rel, ok = _check_gemm(got, want)
        worst = max(worst, err)
        if not ok:
            raise SystemExit(f"moe-kernels: X6 disagrees with its plain version ({tag}, "
                             f"tile rows {tm}: max abs {err:.3e}, rel {rel:.3e})")
        return err, rel

    def faulty(name, prods, tms):
        for tm in tms:
            for a_in, w, r_in, off, want in prods:
                y, go = _moe_launcher(faults[name], a_in, w, off, r_in, tm)
                go()
                torch.cuda.synchronize()
                caught[name] |= not _check_gemm(y, want)[2]

    cases = [(name, e, top, h, i, n, routing) for name, e, top, h, i in MOE_SHAPES
             for n in MOE_TOKENS for routing in ("random", "skewed")]
    ne, ntop, nk, ntok = MOE_RAGGED
    cases.append(("ragged", ne, ntop, nk, nk, ntok, "random"))
    weights = {}
    for name, e, top, h, i, n, routing in cases:
        if name not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            ngu = i if name == "ragged" else 2 * i  # ragged: K = N = 1416 in both products
            weights[name] = ((torch.randn((e, h, ngu), generator=gen, device="cuda") * 0.02)
                             .bfloat16(),
                             (torch.randn((e, i, h), generator=gen, device="cuda") * 0.02)
                             .bfloat16())
        wgu, wd = weights[name]
        x, idx, wts, rows, off, act = _moe_case(gen, e, top, h, n, routing, i)
        want_gu = moe.grouped_gemm_plain(x.float(), wgu.float(), off, rows).bfloat16()
        want_d = moe.grouped_gemm_plain(act.float(), wd.float(), off).bfloat16()
        prods = ((x, wgu, rows, off, want_gu), (act, wd, None, off, want_d))
        empty = int((off[1:] == off[:-1]).sum())
        tag = f"{name}, {n} tokens, {routing}"
        by_tile = {}
        for tm in moe.TILE_ROWS:
            errs = []
            for a_in, w, r_in, _, want in prods:
                y, go = _moe_launcher(x6, a_in, w, off, r_in, tm)
                go()
                torch.cuda.synchronize()
                errs.append(held(tag, y, want, tm))
            by_tile[tm] = errs
        line = dict(model=name, E=e, K=top, H=h, I=i, tokens=n, rows=n * top, routing=routing,
                    empty_experts=empty)
        if name != "ragged":  # the served path: the wrapper's instance, the fused layer
            got_gu, got_d = moe.grouped_gemm(x, wgu, off, rows), moe.grouped_gemm(act, wd, off)
            torch.cuda.synchronize()
            e1, r1 = held(tag, got_gu, want_gu, moe.tile_rows(n * top, e))
            e2, r2 = held(tag, got_d, want_d, moe.tile_rows(n * top, e))
            _, r3, _ = _check_gemm(moe.fused_moe(x, idx, wts, wgu, wd),
                                   moe.fused_moe_plain(x, idx, wts, wgu, wd))
            line.update(tile_rows=moe.tile_rows(n * top, e), gate_up_max_abs_err=f"{e1:.3e}",
                        gate_up_rel_l2=f"{r1:.3e}", down_max_abs_err=f"{e2:.3e}",
                        down_rel_l2=f"{r2:.3e}", fused_vs_plain_layer_rel_l2=f"{r3:.3e}")
        _line("moe-kernels", **line, **{
            f"tm{tm}_max_abs_err": "/".join(f"{er:.3e}" for er, _ in errs)
            for tm, errs in by_tile.items()},
              tol=f"rel_l2<={GW_REL_L2},abs<={GW_ATOL}*row_rms+{GW_RTOL}*|plain|", ok=True)
        if routing != "random":
            continue
        faulty("last_k_stage_left_out", prods, moe.TILE_ROWS)
        faulty("second_tile_reads_the_first_tiles_rows", prods, moe.TILE_ROWS)
        if name == "ragged":
            faulty("w_map_2d_over_experts", prods, moe.TILE_ROWS)
        if name == "ragged" or (name == MOE_SHAPES[0][0] and n == MOE_TOKENS[-1]):
            # bounded waits: each launch a few milliseconds to a few hundred
            faulty("full_parity_never_flips", prods, moe.TILE_ROWS)
    weights.clear()
    for fname, hit in caught.items():
        _line("moe-kernels", fault=fname, caught=hit)
    if not all(caught.values()):
        raise SystemExit(f"moe-kernels: the check does not catch {caught}")
    _line("moe-kernels", seconds=f"{time.time() - t0:.1f}")
    rec = _moe_sweep(gen)
    rec["max_abs_err"] = worst
    return rec


def _moe_sweep(gen):
    """``[moe-time]`` lines of the sweep (the down product also through the
    gather build, ``gather_x_ms``, at ``tile_rows``' pick, its output equal
    to the map's) and ``[moe-switch]`` lines (each model and token count:
    the instance fastest over gate-up + down beside ``tile_rows``' pick; the
    worst pick last). Returns the X6 row's record."""
    import torch

    from rtp_llm_tpu_torch.ops import moe

    t0 = time.time()
    x6, gather = moe.KERNELS["moe_gemm"], _moe_gather_kernel()
    rec, worst = None, (0.0, None)
    for name, e, top, h, i in MOE_SHAPES:
        wgu = (torch.randn((e, h, 2 * i), generator=gen, device="cuda") * 0.02).bfloat16()
        wd = (torch.randn((e, i, h), generator=gen, device="cuda") * 0.02).bfloat16()
        switch = {round(r * e / top) for r in MOE_SWITCH_ROWS}
        for n in sorted(set(MOE_SWEEP_TOKENS) | switch):
            x, _, _, rows, off, act = _moe_case(gen, e, top, h, n, "random", i)
            touched = int((off[1:] > off[:-1]).sum())
            pick = moe.tile_rows(n * top, e)
            total = collections.Counter()
            for prod, a_in, w, r_in in (("gate_up", x, wgu, rows), ("down", act, wd, None)):
                kk, nn = w.shape[1], w.shape[2]
                # the touched experts' slices, x's rows once (tokens for the
                # gather), y written once
                nbytes = (touched * kk * nn + (n if r_in is not None else n * top) * kk
                          + n * top * nn) * 2
                flops = 2.0 * n * top * kk * nn
                bound, by = _bound_ms(nbytes, flops)
                # each timer's least of MOE_ROUNDS interleaved rounds: the
                # card runs into its power limit on Mixtral's shapes and its
                # clocks move within a sweep
                runs = {tm: _moe_launcher(x6, a_in, w, off, r_in, tm) for tm in moe.TILE_ROWS}
                timers = {tm: go for tm, (_, go) in runs.items()}
                if r_in is None:  # the down product through the gather build
                    yg, timers["gather"] = _moe_launcher(gather, a_in, w, off, None, pick)
                timers["wrapper"] = lambda: moe.grouped_gemm(a_in, w, off, r_in)
                xs = a_in if r_in is None else a_in.index_select(0, r_in)
                timers["library"], label = _moe_library(xs, w, off)
                least = dict.fromkeys(timers, float("inf"))
                for _ in range(MOE_ROUNDS):
                    for key, fn in timers.items():
                        least[key] = min(least[key], _time_ms(fn))
                times = {tm: least[tm] for tm in runs}
                for tm in runs:
                    total[tm] += times[tm]
                extra = {}
                if r_in is None:
                    extra["gather_x_ms"] = f"{least['gather']:.4f}"
                    if not torch.equal(runs[pick][0], yg):
                        raise SystemExit(f"moe-time: the gather build's down product "
                                         f"differs from the map's ({name}, {n} tokens)")
                ms, lib_ms = least["wrapper"], least["library"]
                plain_ms = (_time_ms(lambda: moe.grouped_gemm_plain(a_in, w, off, r_in),
                                     iters=3, warmup=1) if n in MOE_PLAIN_TOKENS else None)
                best = min(times, key=times.get)
                _line("moe-time", model=name, product=prod, tokens=n, rows=n * top,
                      rows_an_expert=f"{n * top / e:.1f}", experts_touched=touched, K=kk, N=nn,
                      **{f"tm{tm}_ms": f"{t:.4f}" for tm, t in times.items()},
                      **extra, fastest=best, tile_rows=pick, ms=f"{ms:.4f}",
                      plain_ms="-" if plain_ms is None else f"{plain_ms:.4f}",
                      library_ms=f"{lib_ms:.4f}", library=label, bound_ms=f"{bound:.4f}",
                      bound_by=by, share_of_bound=f"{bound / ms:.3f}",
                      vs_library=f"{ms / lib_ms:.3f}")
                if name == MOE_SHAPES[0][0] and prod == "gate_up" and n == 2048:
                    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                               library_ms=lib_ms)
            best = min(total, key=total.get)
            worst = max(worst, (total[pick] / total[best], f"{name}:{n}"))
            _line("moe-switch", model=name, tokens=n, rows_an_expert=f"{n * top / e:.1f}",
                  largest_group=int((off[1:] - off[:-1]).max()), fastest=best, tile_rows=pick,
                  pick_over_fastest=f"{total[pick] / total[best]:.3f}",
                  **{f"tm{tm}_ms": f"{t:.4f}" for tm, t in total.items()})
        del wgu, wd
        _line("moe-time", model=name, after_sweep=_card_state())
    _line("moe-switch", worst_pick_over_fastest=f"{worst[0]:.3f}", at=worst[1])
    _line("moe-time", seconds=f"{time.time() - t0:.1f}")
    return rec


# [moe]: the three models served with seeded random bf16 weights, 8 prompts
# of 500-2000 tokens (ALIBI_PROMPTS), FAM_OUT tokens each, graphed decode;
# Mixtral-8x7B at MIXTRAL_LAYERS of its 32 layers (32 take 93 GB in bf16)
MOE_SEEDS = {"qwen1.5-moe-a2.7b": 47, "qwen3-30b-a3b": 48, "mixtral-8x7b": 49}
MOE_BLOCKS = {"qwen1.5-moe-a2.7b": 512, "qwen3-30b-a3b": 256, "mixtral-8x7b": 512}
MIXTRAL_LAYERS = 8


def _moe_weights(model, seed, name):
    """bf16 weights of a MoE config as the loader gives them (std 0.02, norms
    1), drawn on the card from a generator of their own, with the expert
    stacks drawn already fused (``moe_gate_up`` [L, E, H, 2I]: a whole
    Qwen3-30B-A3B gate and up side by side would not fit twice)."""
    import torch

    cfg = model.cfg
    t0 = time.time()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(seed)
    w = random_weights(dataclasses.replace(cfg, intermediate_size=8), wgen)
    for n in ("gate_proj", "up_proj", "down_proj"):
        del w[n]
    L, H, E, I = cfg.num_layers, cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    rand = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="cuda").normal_(
        0.0, 0.02, generator=wgen)
    w["router"] = rand(L, H, E)
    w["moe_gate_up"] = rand(L, E, H, 2 * I)
    w["moe_down"] = rand(L, E, I, H)
    si = cfg.intermediate_size  # Qwen1.5-MoE's shared expert: 5632, as its dense width
    if cfg.num_shared_experts:
        w.update(shared_gate_up=rand(L, H, 2 * si), shared_down=rand(L, si, H),
                 shared_expert_gate=rand(L, H, 1))
    if cfg.use_qk_norm:
        for n in ("q_norm", "k_norm"):
            w[n] = torch.ones((L, cfg.head_dim), dtype=torch.bfloat16, device="cuda")
    weights = model.fuse_weights(w)
    torch.cuda.synchronize()
    _line("weights", model=name, layers=L, dtype="bf16", experts=E,
          gbytes=f"{_tensor_gbytes(weights):.2f}", seconds=f"{time.time() - t0:.1f}")
    return weights


def _moe_family(tag, cfg, card):
    """Serve one MoE model (``_timed_serve``: a lone prompt cold and warm,
    the 8 prompts together), X6, K1 and K3 launched on the served path and
    no plain version (attention or experts) called there, the same tokens
    at ``decode_steps`` 4, the served logprobs against the teacher-forced
    plain forward (plain attention and plain expert products,
    ``_moe_teacher_check``). Returns
    ({kernel: launches}, plain calls)."""
    import torch

    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.ops import moe
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    t0 = time.time()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _moe_weights(model, MOE_SEEDS[tag], tag)
    own = torch.Generator(device="cuda")
    own.manual_seed(MOE_SEEDS[tag])
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=own, device="cuda").tolist()
               for n in ALIBI_PROMPTS]
    lone = torch.randint(1, cfg.vocab_size, (GEMMA_LONE,), generator=own, device="cuda").tolist()
    engine = make_engine(model, weights, num_blocks=MOE_BLOCKS[tag], slots=FAM_SLOTS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels, plain = _attention_counters()
    x6, by_tile = moe.KERNELS["moe_gemm"], moe.TILE_LAUNCHES
    for k in [*kernels, x6]:
        k.launches.n = 0
    for c in by_tile.values():
        c.n = 0
    plain.n = moe.PLAIN_CALLS.n = 0
    replays = engine._graphs.replays
    (lone_s,), (ttft,), lone_tok_s, _ = _timed_serve(engine, [lone], FAM_OUT)
    streams, firsts, tok_s, secs = _timed_serve(engine, prompts, FAM_OUT)
    (lone_w,), (ttft_warm,), _, _ = _timed_serve(engine, [lone], FAM_OUT)
    torch.cuda.synchronize()
    replays = engine._graphs.replays - replays
    launches = collections.Counter({k.name: k.launches.n for k in kernels if k.launches.n})
    launches[x6.name] = x6.launches.n
    plain_calls = plain.n + moe.PLAIN_CALLS.n
    entries = [decode.kernel_for(torch.bfloat16, cfg.head_dim).name,
               prefill.kernel_for(torch.bfloat16, cfg.head_dim).name, x6.name]
    _served_ok(tag, streams + [lone_s, lone_w], FAM_OUT, launches, plain_calls, entries)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    _line(tag, check="serve", layers=cfg.num_layers, experts=cfg.num_experts,
          top_k=cfg.num_experts_per_tok, shared_expert=cfg.num_shared_experts,
          slots=FAM_SLOTS, prompts=",".join(str(len(p)) for p in prompts), out_tokens=FAM_OUT,
          ttft_lone_first_ms=f"{ttft:.1f}", ttft_lone_warm_ms=f"{ttft_warm:.1f}",
          lone_decode_tok_s=f"{lone_tok_s:.1f}",
          ttft_batch_ms=",".join(f"{x:.0f}" for x in firsts), batch_decode_tok_s=f"{tok_s:.1f}",
          batch_seconds=f"{secs:.2f}", graph_replays=replays, x6_launches=x6.launches.n,
          x6_launches_by_tile_rows=",".join(f"{tm}:{c.n}" for tm, c in by_tile.items()),
          x6_launches_a_forward=2 * moe_layers, moe_plain_calls=moe.PLAIN_CALLS.n,
          serving_peak_reserved_gbytes=f"{torch.cuda.max_memory_reserved() / 1e9:.2f}",
          lone_warm_prefix_reused_tokens=lone_w.reuse_len)
    _drop_prefix_cache(engine)
    _set_decode(engine, "graph", 4, True)
    again, _, tok_s4, _ = _timed_serve(engine, prompts, FAM_OUT)
    _set_decode(engine, "graph", 1, True)
    same = all(a.output_token_ids == b.output_token_ids for a, b in zip(streams, again))
    _line(tag, check="decode_steps_4", tokens_equal=same, batch_decode_tok_s=f"{tok_s4:.1f}",
          ok=same)
    if not same:
        raise SystemExit(f"{tag}: decode_steps 4 served other tokens than 1")
    _moe_teacher_check(tag, engine, streams)
    _moe_step_profile(tag, engine, cfg, weights)
    _moe_prefill_profile(tag, engine, cfg)
    del engine, weights, model
    _line(tag, seconds=f"{time.time() - t0:.1f}", card=card.replace(" ", "_"))
    return launches, plain_calls


def _moe_step_profile(tag, engine, cfg, weights):
    """Where a graphed decode step of 8 rows goes (``phase_profile``: X6,
    attention, library GEMMs and the rest), beside the byte bounds of a
    step: the weights one token reads (its top-k experts of each sparse
    layer, the embedding's row) and every weight (all experts touched)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(MOE_SEEDS[tag])
    phase_profile(engine, cfg, gen, "bf16", mode="graph")
    nbytes = lambda t: t.numel() * t.element_size()
    every = _tensor_gbytes(weights) * 1e9 - nbytes(weights["embed_tokens"])
    stacks = nbytes(weights["moe_gate_up"]) + nbytes(weights["moe_down"])
    one_token = every - stacks * (1 - cfg.num_experts_per_tok / cfg.num_experts)
    _line(tag, check="decode_step_bound", one_token_gbytes=f"{one_token / 1e9:.2f}",
          one_token_bound_ms=f"{_bound_ms(one_token, 0)[0]:.3f}",
          every_weight_gbytes=f"{every / 1e9:.2f}",
          every_weight_bound_ms=f"{_bound_ms(every, 0)[0]:.3f}")


def _moe_prefill_profile(tag, engine, cfg):
    """Where a lone 1000-token prefill forward goes (``_prefill_forms``'
    ``lone_1000`` on the engine's weights and pool, last: it writes the
    pool's first blocks): kernel ms of one profiled forward, X6 apart, and
    X6's launches by tile rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtp_llm_tpu_torch.ops import moe

    gen = torch.Generator(device="cuda")
    gen.manual_seed(MOE_SEEDS[tag])
    inp = _prefill_forms(cfg, gen)["lone_1000"]
    model = engine.model
    for _ in range(2):
        model.forward(engine.weights, engine.kv, inp)
    torch.cuda.synchronize()
    before = {tm: c.n for tm, c in moe.TILE_LAUNCHES.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        model.forward(engine.weights, engine.kv, inp)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t1) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total
    ms = lambda us: f"{us / 1e3:.3f}"
    is_moe = lambda e: "moe_gemm" in e.key  # X6's two kernels
    busy = sum(dev(e) for e in kernels)
    x6 = sum(dev(e) for e in kernels if is_moe(e))
    attn = sum(dev(e) for e in kernels if "paged_" in e.key)
    gemm = sum(dev(e) for e in kernels if not is_moe(e)
               and any(m in e.key for m in ("nvjet", "gemm", "cutlass", "xmma")))
    _line(tag, check="prefill_profile", form="lone_1000", profiled_wall_ms=f"{wall_ms:.2f}",
          kernel_ms=ms(busy), x6_ms=ms(x6), library_gemm_ms=ms(gemm), attention_ms=ms(attn),
          other_ms=ms(busy - x6 - gemm - attn), kernel_launches=sum(e.count for e in kernels),
          x6_launches_by_tile_rows=",".join(
              f"{tm}:{c.n - before[tm]}" for tm, c in moe.TILE_LAUNCHES.items()),
          x6_kernels="|".join(f"{e.key[:48]}:{ms(dev(e))}:{e.count}" for e in kernels
                              if is_moe(e)))


def _moe_teacher_check(tag, engine, streams, rows=TEACHER_ROWS):
    """The served logprobs of ``rows`` streams against the teacher-forced
    plain forward: each greedy token the teacher's best at every decisive
    position (top-2 gap above 2 x TEACHER_TOL), and 90% of the positions
    within TEACHER_TOL. Not every position, as for a dense model: routing is
    discontinuous, and where the served and the teacher's bf16 roundings put
    a token on another expert its logprob moves by far more than rounding,
    and so do the later positions that attend to it. Reported beside it:
    the served logprobs against the same teacher-forced forward through the
    kernels, and the token-layers whose top-k expert sets differ between
    the plain and the kernel teacher (routing flips). Returns the largest
    error against the plain teacher."""
    from rtp_llm_tpu_torch.models import llama_family

    seen, route = {"plain": [], "auto": []}, llama_family.route

    def recording(logits, k, norm):
        idx, w = route(logits, k, norm)
        seen[backend].append(idx.sort(dim=1).values)
        return idx, w

    errs, kernel_errs, decisive, off_best = [], [], 0, 0
    llama_family.route = recording
    try:
        for s in streams[:rows]:
            for backend in ("plain", "auto"):
                want, best, gap = _teacher_chunked(engine, s.prompt_token_ids,
                                                   s.output_token_ids, backend=backend)
                diff = [abs(a - b) for a, b in zip(s.output_logprobs, want)]
                if backend == "auto":
                    kernel_errs += diff
                    continue
                errs += diff
                for tok, b, g in zip(s.output_token_ids, best, gap):
                    if g > 2 * TEACHER_TOL:
                        decisive += 1
                        off_best += tok != b
    finally:
        llama_family.route = route
    pairs = list(zip(seen["plain"], seen["auto"]))
    flips = sum(int((a != b).any(dim=1).sum()) for a, b in pairs)
    errs.sort()
    p90 = errs[int(0.9 * (len(errs) - 1))]
    ok = off_best == 0 and p90 <= TEACHER_TOL
    _line(tag, check="teacher_forced_logprobs", rows=rows, max_abs_err=f"{errs[-1]:.4f}",
          p50_abs_err=f"{errs[len(errs) // 2]:.4f}", p90_abs_err=f"{p90:.4f}",
          beyond_tol=sum(e > TEACHER_TOL for e in errs), positions=len(errs), tol=TEACHER_TOL,
          decisive_positions=decisive, tokens_off_the_best=off_best,
          kernel_teacher_max_abs_err=f"{max(kernel_errs):.4f}",
          kernel_teacher_beyond_tol=sum(e > TEACHER_TOL for e in kernel_errs),
          routing_flips_plain_vs_kernels=f"{flips}/{sum(a.shape[0] for a, _ in pairs)}", ok=ok)
    if not ok:
        raise SystemExit(f"{tag}: served logprobs stray from the teacher-forced plain forward")
    return errs[-1]


def phase_moe_families(card):
    """``[moe]``: Qwen1.5-MoE-A2.7B and Qwen3-30B-A3B at full width and
    depth, Mixtral-8x7B at full width and MIXTRAL_LAYERS layers, each
    through ``_moe_family`` with every earlier engine released. Returns
    ({kernel: launches}, plain calls)."""
    from rtp_llm_tpu_torch.config.model_config import (
        mixtral_8x7b_config, qwen1_5_moe_a2_7b_config, qwen3_30b_a3b_config,
    )

    _release()
    launches, plain_calls = collections.Counter(), 0
    for tag, cfg in (("qwen1.5-moe-a2.7b", qwen1_5_moe_a2_7b_config()),
                     ("qwen3-30b-a3b", qwen3_30b_a3b_config()),
                     ("mixtral-8x7b", dataclasses.replace(mixtral_8x7b_config(),
                                                          num_layers=MIXTRAL_LAYERS))):
        got, plain = _moe_family(tag, cfg, card)
        launches.update(got)
        plain_calls += plain
        _release()
    return launches, plain_calls


if __name__ == "__main__":
    sys.exit(main())
