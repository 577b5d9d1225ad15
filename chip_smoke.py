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
     without a sliding window and the deferred current token;
  4. prefill kernel vs its plain version: T in {64, 512, 2048}, q_offset in
     {0, 37, 1000}, a padded tail whose rows must be exactly 0, a window;
     then what the tiling can get wrong: Llama-3-8B heads (4 query heads a
     kv head) beside Qwen2-7B's (7), 1 and 8, T = 100, three rows with their
     own offsets of which one is wholly padding, a window that ends inside a
     key tile, pages of 16 tokens, the 2048 bucket of a 1000-token prompt
     (tail rows exact zeros); every slot of the pool no live key maps to
     holds NaN for the kernel.
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
     in before the normaliser. The same two entries of the prefill kernel at
     T = 2048 behind a 1000-token reused prefix, at two rows and at the
     geometry cases of 4. Times (through the wrapper and as a replayed CUDA
     graph, with TFLOP/s) of all three entries at T in {512, 2048}, offsets
     0 and 1000, and at the 2048 bucket of 1000 tokens. Then the quantized
     writes (plain PyTorch): ``write_kv_quant`` and the engine's batched
     deferred scatter on the card against the CPU, bit for bit;
  5. the 4-bit GEMM kernels gw_gemm, gw_gemm_pipe and gw_gemm_partial vs
     their plain versions at the four Qwen2-7B linears (group 128, s4) with
     M in {1, 5, 8, 64, 100, 512, 2048} and the two Llama-3-8B shapes that
     differ, e2m1 at group 32, ragged edges, and a layer >= 1 of a stack;
     planted faults (nibbles swapped, the high plane on the low plane's
     scale rows, two's-complement decoding, one K split left out, the scale
     rows of the next ring stage) must fail the same check, and repeated
     runs must give the same bits; gw_gemm is timed at M in {8, 64, 512,
     2048} through the wrapper (``ms``) and as a replayed CUDA graph
     (``device_ms``: at small shapes the host's launch path outlasts the
     kernel); then the tile sweep of gw_gemm_partial at the three sweep
     geometries, M = 64;
  6. full-width Qwen2-7B (28 layers, bf16, weights from a seeded generator on
     the card, fused as the engine serves them): a prefill of a few prompts
     plus decode steps through the kernels. Every layer's attention output
     is held against the plain version on the same inputs (and a planted
     fault must fail that check); the logits against the same forward
     through plain attention;
  7. serve: the engine behind ``build_app`` on a local port answers ~8
     concurrent /v1/completions requests (two share a 1024-token prefix and
     the second must reuse it), then one lone 1000-token request (its TTFT
     beside the value recorded before the kernels' redesign), /health and
     /worker_status; then the decode step's host and device time;
  8. the same model with 4-bit weights: the bf16 linears are quantized on
     the card to the GPTQ form the loader emits, fused, and the bf16 copies
     freed. Every linear call of a prefill plus decode steps runs gw_gemm
     and the plain version on the same inputs (a planted fault must fail);
     logits vs the same forward through the plain versions; the distance to
     the bf16 logits is printed. A 4-layer cut repeats this with
     ``variant="pipe"`` and with fp4 weights from the load-time transform;
  9. serve with 4-bit weights as in 7, through gw_gemm and then through
     gw_gemm_pipe. gw launches must be 4 per layer per forward call and
     plain-version calls 0;
 10. full-width Llama-3-8B (32 layers, seeded bf16 weights) on an int8 KV
     pool, decode writes in-layer and deferred: every layer's attention held
     against the plain version as in 6; the logits' distance to the bf16-KV
     forward and between the two write modes is printed. A 4-layer cut runs
     and serves with an fp8 pool;
 11. serve Llama-3-8B with 4-bit weights (GPTQ form), int8 KV, prefix cache
     and deferred writes, as in 7: the int8 attention entries must have
     launched, the bf16 and e4m3 ones not, plain-version calls 0. A
     ``[kv-pool]`` line: bytes a block and tokens an auto-sized pool holds
     per pool type. Decode step times with int8 KV deferred, int8 KV
     in-layer and bf16 KV beside the same weights;
 12. profiled windows of decode steps (device busy share from kernel time
     only, launches a step, top kernels) of the three Llama-3-8B engines and
     the three Qwen2-7B engines, and of one 2048-row prefill forward (the
     bucket of a lone 1000-token prompt) summed by kernel name. They come
     last, because a profiler window slows every later launch of the process;
 13. one ``kernels`` JSON line: launches of each kernel on its path (each
     must be > 0, plain-version calls there must be 0), max error against the
     plain version, and kernel / plain / library / bound times at the main
     path's shapes.
The last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
GW_MS = (1, 5, 8, 64, 100, 512, 2048)
GW_TIMED_MS = (8, 64, 512, 2048)  # gw_gemm; the other two kernels at 64 and 2048 as before
# the two Llama-3-8B linears whose shapes differ from every Qwen2-7B one
GW_LLAMA_SHAPES = {"llama_gate_up_proj": (4096, 28672), "llama_down_proj": (14336, 4096)}
# lone 1000-token TTFT (ms) of each serve phase as PERF.md records it from before
# the prefill attention and gw_gemm kernels were redesigned for tensor cores
# and asynchronous copies (NVIDIA H100 80GB HBM3, 700 W)
TTFT_BEFORE = {("qwen2-7b", "bf16", None, "bfloat16"): 113.4,
               ("qwen2-7b", "int4", "base", "bfloat16"): 296.0,
               ("qwen2-7b", "int4", "pipe", "bfloat16"): 235.6,
               ("llama3-8b", "int4", "base", "int8"): 328.7}
SWEEP_GEOMS = ((3584, 18944), (18944, 3584), (3584, 4608))
SWEEP_TILES = ((16, 64, 1), (16, 128, 1), (32, 64, 1), (32, 128, 1),
               (16, 64, 4), (32, 64, 4), (32, 128, 4))  # (bm, bn, K splits)


def _line(tag: str, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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
    from rtp_llm_tpu_torch.ops import quant_gemm
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    kernels = [*decode.KERNELS.values(), *prefill.KERNELS.values(),
               *quant_gemm.KERNELS.values()]
    secs = _kernels.build_all(kernels)  # one nvcc per source, all started together
    for lib in {id(k.lib): k.lib for k in kernels}.values():
        info = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        if len(info) > 4:  # a source of many template instances: the extremes
            regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in info
                    if "Used " in ln]
            smem = [int(ln.split(" bytes smem")[0].split()[-1]) for ln in info
                    if " bytes smem" in ln]
            spills = [ln for ln in info if "spill" in ln and "0 bytes spill stores" not in ln]
            info = [f"{len(regs)} kernels", f"registers {min(regs)}-{max(regs)}",
                    f"smem {min(smem)}-{max(smem)} B", f"spilling kernels {len(spills)}"] + spills
        _line("ptxas", source=os.path.basename(lib.source),
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
        q = torch.randn((b, HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        ck = torch.randn((b, HKV * D), generator=gen, device="cuda", dtype=torch.bfloat16)
        cv = torch.randn((b, HKV * D), generator=gen, device="cuda", dtype=torch.bfloat16)
        for window in (0, 1000):
            for cur in (False, True):
                kw = dict(sliding_window=window, cur_k=ck if cur else None,
                          cur_v=cv if cur else None)
                got = paged_decode_attention(q, k_cache, v_cache, bt, lens, sm, BS, **kw)
                want = paged_decode_ref(q, k_cache, v_cache, bt, lens, sm, BS, **kw)
                torch.cuda.synchronize()
                err, rel, ok = _check(got, want)
                zero_rows = bool((got[lens == 0] == 0).all())
                ok = ok and zero_rows
                _line("decode", B=b, mb=mb, window=window, cur=cur,
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
            _planted("decode-fault", [
                ("one_tile_of_8192_row", paged_decode_attention(
                    q, k_cache, v_cache, bt_bad, lens, sm, BS), want)])
        if b == 64:
            # rows of >= 2048 tokens attend one key fewer
            want = plain()
            _planted("decode-fault", [
                ("kv_len_minus_1_long_rows", paged_decode_attention(
                    q, k_cache, v_cache, bt, lens - (lens >= 2048).int(), sm, BS), want)])
        ms = _time_ms(run)
        plain_ms = _time_ms(plain, iters=5, warmup=1)
        lib_ms = _time_ms(_sdpa_decode(q, k_cache, v_cache, bt, lens, 0))
        ntok = float(lens.clamp_min(0).sum())
        nbytes = ntok * HKV * D * 2 * 2 + 2 * b * HQ * D * 2 + bt.numel() * 4 + b * 4
        flops = 4.0 * ntok * HQ * D
        bound, by = _bound_ms(nbytes, flops)
        _line("decode-time", B=b, ctx_tokens=int(ntok), ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by)
        if b == 64:
            record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
    # another page size: the kernel addresses any block_size
    lens_l, bs = specials, 16
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    bt, nblocks = _tables(lens_l, -(-max(lens_l) // bs), gen, bs)
    k_cache, v_cache = _pool(nblocks, gen, bs)
    q = torch.randn((len(lens_l), HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    got = paged_decode_attention(q, k_cache, v_cache, bt, lens, sm, bs)
    want = paged_decode_ref(q, k_cache, v_cache, bt, lens, sm, bs)
    torch.cuda.synchronize()
    err, rel, ok = _check(got, want)
    _line("decode", B=len(lens_l), block_size=bs, max_abs_err=f"{err:.3e}",
          max_rel_l2=f"{rel:.3e}", ok=ok)
    if not ok:
        raise SystemExit(f"decode kernel disagrees with plain (block_size={bs})")
    record["max_abs_err"] = max(worst, err)
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
    """Copies of a bf16 pool with NaN in every slot no live key maps to (the
    null block, rows past kv_len, free blocks): a kernel that read one would
    return NaN. The plain version gathers whole blocks and keeps the clean pool."""
    import torch

    slots, _, live = _slot_grid(bt, lens, bs)
    dead = torch.ones(k.shape[0], dtype=torch.bool, device="cuda")
    dead[slots[live]] = False
    kp, vp = k.clone(), v.clone()
    kp[dead] = float("nan")
    vp[dead] = float("nan")
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
# of 16 tokens; the 2048 bucket of a 1000-token prompt.
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


def _quantized_pools(kb, vb, hkv, bt, lens):
    """{kind: (k, v, scale kwargs for the plain version, scale kwargs for the
    kernel)} from a bf16 pool. int8 as the engine quantizes it; the kernel's
    scales are NaN at every slot no live position maps to (the null block,
    rows past kv_len, unused blocks): a kernel that read one there would
    return NaN, where the plain version, gathering whole blocks, needs them
    finite. e4m3 is the downcast pool, no scales."""
    import torch

    from rtp_llm_tpu_torch.ops.kv_cache import FP8, quantize_kv

    kq, ks, vq, vs = quantize_kv(kb.view(-1, hkv, D), vb.view(-1, hkv, D))
    slots, _, live = _slot_grid(bt, lens)
    is_live = torch.zeros(kb.shape[0], dtype=torch.bool, device="cuda")
    is_live[slots[live]] = True
    nan = torch.full_like(ks, float("nan"))
    poisoned = dict(k_scale=torch.where(is_live[:, None], ks, nan),
                    v_scale=torch.where(is_live[:, None], vs, nan))
    return {"int8": (kq, vq, dict(k_scale=ks, v_scale=vs), poisoned),
            "e4m3": (kb.to(FP8), vb.to(FP8), {}, {})}


def _dequant_pair(k, v, scales, hkv):
    """A quantized pool as the bf16 pool the library yardstick reads."""
    import torch

    if not scales:
        return k.to(torch.bfloat16), v.to(torch.bfloat16)
    deq = lambda c, s: (c.view(-1, hkv, D).float() * s.float()[..., None]).view(
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
            for window in (0, 1000):
                for cur in (False, True):
                    kw = dict(sliding_window=window, cur_k=ck if cur else None,
                              cur_v=cv if cur else None)
                    got = paged_decode_attention(q, k, v, bt, lens, sm, BS, **kw, **kernel_scales)
                    want = paged_decode_ref(q, k, v, bt, lens, sm, BS, **kw, **plain_scales)
                    torch.cuda.synchronize()
                    err, rel, ok = _check(got, want)
                    zero_rows = bool((got[lens == 0] == 0).all())
                    ok = ok and zero_rows
                    _line("decode-quant", shape=shape, pool=kind, B=b, Hq=hq, Hkv=hkv, mb=mb,
                          window=window, cur=cur, max_abs_err=f"{err:.3e}",
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
            _planted("decode-quant-fault", [
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
        bf16_ms = _time_ms(lambda: paged_decode_attention(qn, kb, vb, btn, lensn, sm, BS))
        for kind in KV_KINDS:
            k, v, plain_scales, _ = pools[kind]
            ms = _time_ms(lambda: paged_decode_attention(qn, k, v, btn, lensn, sm, BS,
                                                         **plain_scales))
            plain_ms = _time_ms(lambda: paged_decode_ref(qn, k, v, btn, lensn, sm, BS,
                                                         **plain_scales), iters=5, warmup=1)
            kd, vd = _dequant_pair(k, v, plain_scales, hkv)
            lib_ms = _time_ms(_sdpa_decode(qn, kd, vd, btn, lensn, 0, hkv=hkv))
            del kd, vd
            bound, by = _kv_bound(ntok, hkv, kind, fixed, flops)
            _line("decode-quant-time", shape=shape, pool=kind, B=n, Hq=hq, Hkv=hkv,
                  ctx_tokens=int(ntok), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                  library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
                  bf16_pool_kernel_ms=f"{bf16_ms:.4f}")
            if shape == "llama3_8b":
                records[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by)
        if shape != "qwen2_7b":
            plain_ms = _time_ms(lambda: paged_decode_ref(qn, kb, vb, btn, lensn, sm, BS),
                                iters=5, warmup=1)
            lib_ms = _time_ms(_sdpa_decode(qn, kb, vb, btn, lensn, 0, hkv=hkv))
            bound, by = _kv_bound(ntok, hkv, "bf16", fixed, flops)
            _line("decode-quant-time", shape=shape, pool="bf16", B=n, Hq=hq, Hkv=hkv,
                  ctx_tokens=int(ntok), ms=f"{bf16_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                  library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by)
        del pools, kb, vb
        torch.cuda.empty_cache()
    for kind in KV_KINDS:
        records[kind]["max_abs_err"] = worst[kind]
    return records


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

    def compare(tag, x, packed, scale, code, **kw):
        for v in variants:
            got = qg.groupwise_matmul_packed(x, packed, scale, code=code, variant=v, **kw)
            layer = kw.get("layer")
            want = _gw_plain(v)(x, packed if layer is None else packed[layer], scale, code)
            torch.cuda.synchronize()
            err, rel, ok = _check_gemm(got, want)
            k, n = x.shape[-1], want.shape[-1]
            _line("gw", case=tag, kernel=qg.KERNELS[v].name, M=x.shape[0], K=k, N=n, code=code,
                  tile=qg.plan(x.shape[0], k, n, sm, v), max_abs_err=f"{err:.3e}",
                  max_rel_l2=f"{rel:.3e}", ok=ok)
            if not ok:
                raise SystemExit(f"{qg.KERNELS[v].name} disagrees with its plain version "
                                 f"({tag}, M={x.shape[0]}, K={k}, N={n}, {code})")
            worst[v] = max(worst[v], err)

    for name, (k, n) in {**GW_SHAPES, **GW_LLAMA_SHAPES}.items():
        nbytes = k * n // 2
        copies = max(1, -(-120_000_000 // nbytes))
        packed, scale = _gw_weights(k, n, GW_GROUP, gen, copies)
        for m in GW_MS if name in GW_SHAPES else GW_TIMED_MS:
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
            timed = variants if (m in (64, 2048) and name in GW_SHAPES) else ("base",)
            for v in timed:
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
        if name == "o_proj":
            # a layer >= 1 of the stack, through the layer index
            x = torch.randn((64, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            compare("stack_layer_2", x, packed, scale[2], "s4", layer=2)
            # planted faults at the decode shape that splits K
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
        del packed, scale
        torch.cuda.empty_cache()
    # fp4: e2m1 codes at group 32
    k, n = GW_SHAPES["qkv_proj"]
    packed, scale = _gw_weights(k, n, 32, gen)
    for m in (8, 64, 2048):
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
    # ragged rows and columns against the 128 x 128 blocks, K split
    for m, k, n in ((130, 3584, 3600), (300, 512, 208)):
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
    card = phase_device()
    import torch

    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    dec = phase_decode(gen)
    pre = phase_prefill(gen)
    dec_q = phase_decode_quant(gen)
    pre_q = phase_prefill_quant(gen)
    phase_write(gen)
    gw = phase_gw(gen)
    sweep_launches = phase_sweep(gen)
    _line("kernels-checked", seconds=f"{time.time() - t0:.1f}")
    launches, plain_calls = phase_qwen2(gen, card)
    llama_launches, llama_plain, llama_engines = phase_llama3(gen, card)
    launches.update(llama_launches)
    plain_calls += llama_plain
    launches["gw_gemm_partial"] = sweep_launches
    phase_profiles(gen, llama_engines)

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
        ("gw_gemm_pipe", "rtp_llm_tpu_torch/csrc/gw_gemm.cu",
         "rtp_llm_tpu/ops/quant_gemm.py:136", gw["pipe"]),
        ("gw_gemm_partial", "rtp_llm_tpu_torch/csrc/gw_gemm_partial.cu",
         "benchmarks/int4_kernel_sweep.py:183", gw["partial"]),
    ):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if not all(n > 0 for n in launches.values()) or plain_calls != 0:
        print(f"chip_smoke: a kernel was not launched on its path ({launches}), or a "
              f"plain version was called there ({plain_calls})", file=sys.stderr)
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


def phase_serve(model, weights, gen, card, tag="bf16", gemm=None, kv="bfloat16", defer=False,
                name="qwen2-7b"):
    """The engine behind ``build_app`` answering HTTP requests. ``gemm`` names
    the 4-bit GEMM variant the weights run through ("base" / "pipe"), None
    for bf16 weights; ``kv`` the pool type, ``defer`` deferred decode writes.
    Every launch count of the path is set to 0 just before the requests and
    read just after: the attention entries of the engine's pool type must
    have launched, those of the other pool types not. Then the unprofiled
    decode step is timed. Returns (engine, launches, plain-version calls)."""
    import threading
    import urllib.request

    import torch

    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.ops import quant_gemm
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS

    cfg = model.cfg
    attn, other_attn = _attention_kernels(kv)
    counted = dict(attn)
    if gemm:
        counted[quant_gemm.KERNELS[gemm].name] = quant_gemm.KERNELS[gemm]
    engine = make_engine(model, weights, gemm=gemm, kv=kv, defer=defer)
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

        for k in quant_gemm.KERNELS.values():
            k.launches.n = 0
        for k in (*counted.values(), *other_attn):
            k.launches.n = 0
        PLAIN_CALLS.n = quant_gemm.PLAIN_CALLS.n = 0
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
        launches = {n: k.launches.n for n, k in counted.items()}
        stray = {k.name: k.launches.n for k in other_attn if k.launches.n}
        gw_all = sum(k.launches.n for k in quant_gemm.KERNELS.values())
        plain_calls = PLAIN_CALLS.n + quant_gemm.PLAIN_CALLS.n

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
    if stray or not all(launches[n] > 0 for n in attn):
        bad.append(f"a {kv} pool must be served by {sorted(attn)} alone: {launches}, "
                   f"other entries {stray}")
    # every forward call launches one attention kernel and four linears a layer
    forwards = sum(launches[n] for n in attn) // cfg.num_layers
    want_gw = 4 * cfg.num_layers * forwards if gemm else 0
    if gw_all != want_gw or (gemm and launches[quant_gemm.KERNELS[gemm].name] != want_gw):
        bad.append(f"4-bit GEMM launches {gw_all}, expected {want_gw} "
                   f"(4 x {cfg.num_layers} layers x {forwards} forward calls)")
    if bad:
        raise SystemExit(f"serve phase ({tag}) failed: " + "; ".join(bad))
    concurrent = results[1:1 + len(others)]
    ttfts = [r[0] for r in concurrent]
    rates = [31.0 / (r[1] - r[0]) for r in concurrent if r[1] > r[0]]
    total_out = sum(r[2]["usage"]["completion_tokens"] for r in concurrent)
    _line("serve", model=name, weights=tag, gemm=gemm, kv=kv,
          kv_writes="deferred" if defer else "in-layer", requests=len(results),
          shared_prefix_reuse_tokens=reuse,
          ttft_first_ms=f"{results[0][0] * 1e3:.1f}",
          ttft_concurrent_ms_mean=f"{1e3 * sum(ttfts) / len(ttfts):.1f}",
          ttft_concurrent_ms_max=f"{1e3 * max(ttfts):.1f}",
          ttft_lone_1000_ms=f"{results[-1][0] * 1e3:.1f}",
          ttft_lone_1000_ms_before=TTFT_BEFORE.get((name, tag, gemm, kv), "none"),
          decode_tok_per_s_per_request=f"{sum(rates) / max(len(rates), 1):.1f}",
          concurrent_tok_per_s=f"{total_out / wall:.1f}",
          forward_calls=forwards, gw_launches=gw_all,
          **{f"{n}_launches": c for n, c in launches.items()},
          other_attention_entries_launched=sum(stray.values()), plain_calls=plain_calls,
          engine_steps=status.get("step_count"), card=card.replace(" ", "_"),
          seconds=f"{time.time() - t0:.1f}", ok=True)
    phase_step_time(engine, cfg, gen, tag)
    return engine, launches, plain_calls


def make_engine(model, weights, gemm=None, kv="bfloat16", defer=False):
    """An engine as the serve phases run it: 1024 blocks of 64 tokens, 64
    decode slots, prefix cache on."""
    from rtp_llm_tpu_torch.config import (
        CacheConfig, EngineConfig, KernelConfig, QuantConfig, SchedulerConfig,
    )
    from rtp_llm_tpu_torch.engine import LlmEngine

    return LlmEngine(model, weights, EngineConfig(
        quant=QuantConfig(kv_cache_dtype=kv),
        kernel=KernelConfig(int4_pipeline=gemm == "pipe"),
        cache=CacheConfig(block_size=BS, num_blocks=1024),
        scheduler=SchedulerConfig(defer_kv_writes=defer)), device="cuda")


def _kv_mode(engine):
    return dict(kv=engine.config.quant.kv_cache_dtype,
                kv_writes="deferred" if engine._defer_decode else "in-layer")


def _steady_decode(engine, cfg, gen, rows):
    """Enqueue ``rows`` 500-token prompts and step past their prefills."""
    import torch

    from rtp_llm_tpu_torch.config import GenerateConfig

    for _ in range(rows):
        prompt = torch.randint(1, cfg.vocab_size, (500,), generator=gen, device="cuda").tolist()
        engine.enqueue(prompt, GenerateConfig(max_new_tokens=64, do_sample=False,
                                              ignore_eos=True))
    for _ in range(3):  # prefills + first decode steps
        engine.step()
    torch.cuda.synchronize()


def phase_step_time(engine, cfg, gen, tag, rows=8, steps=20):
    """Host-clock decode step over a steady window of ``rows`` active
    streams, and the device time of the same steps from CUDA events. Taken
    before torch.profiler has run in this process: once it has, its tracing
    hooks stay loaded and later launches pay for them (the same 4-bit step
    read 82 ms after a profiled window and 50 ms before one)."""
    import torch

    _steady_decode(engine, cfg, gen, rows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    for _ in range(steps):
        engine.step()
    end.record()
    torch.cuda.synchronize()
    _line("step-time", model=cfg.model_type, weights=tag, gemm=engine.model.gemm_variant,
          **_kv_mode(engine), active_rows=rows,
          steps=steps, decode_step_ms=f"{(time.time() - t0) / steps * 1e3:.2f}",
          device_span_ms_per_step=f"{start.elapsed_time(end) / steps:.2f}")
    while engine.has_work():  # drain, so a later window starts from idle
        engine.step()


def phase_profile(engine, cfg, gen, tag, rows=8, steps=5):
    """Where a decode step's time goes: a torch.profiler window over a steady
    window of ``rows`` active streams. Device time sums GPU kernel events
    only (a host op's entry repeats the time of the kernels it launched),
    grouped into library GEMMs, the 4-bit GEMM kernels, the attention
    kernels and the rest; the busy share is that sum over the window's wall
    time. The profiler stretches the host's step; the unprofiled step time
    is ``phase_step_time``'s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    gw = sum(dev(e) for e in kernels if is_gw(e))
    gemm = sum(dev(e) for e in kernels if not is_gw(e)
               and any(m in e.key for m in ("nvjet", "gemm", "cutlass", "xmma")))
    attn = sum(dev(e) for e in kernels if "paged_" in e.key)
    top = sorted(kernels, key=dev, reverse=True)[:8]
    launches = sum(e.count for e in kernels) / steps
    _line("profile", model=cfg.model_type, weights=tag, gemm=engine.model.gemm_variant,
          **_kv_mode(engine), active_rows=rows,
          profiled_step_ms=f"{wall_us / steps / 1e3:.2f}",
          device_busy_share=f"{busy / wall_us:.3f}",
          kernel_ms_per_step=per_step(busy), gemm_ms_per_step=per_step(gemm),
          gw_gemm_ms_per_step=per_step(gw), attention_ms_per_step=per_step(attn),
          other_ms_per_step=per_step(busy - gemm - gw - attn),
          kernel_launches_per_step=f"{launches:.0f}",
          top_kernels_ms_per_step="|".join(f"{e.key[:40]}:{per_step(dev(e))}" for e in top))
    top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    _line("profile-host", model=cfg.model_type, weights=tag, **_kv_mode(engine),
          top_host_ms_per_step="|".join(
        f"{e.key[:40]}:{e.self_cpu_time_total / steps / 1e3:.3f}" for e in top_cpu))
    return launches


def phase_profile_prefill(engine, gen, tag):
    """Kernel time of one 2048-row prefill forward (the bucket a lone
    1000-token prompt runs in) summed by kernel name, from a torch.profiler
    window over one ``model.forward`` on the engine's weights and pool."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtp_llm_tpu_torch.models import ModelInputs

    model, cfg = engine.model, engine.model.cfg
    t, n = 2048, 1000
    toks = torch.randint(1, cfg.vocab_size, (1, t), generator=gen, device="cuda")
    pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].clone()
    toks[0, n:] = 0
    pos[0, n:] = 0
    bt = torch.arange(1, 1 + t // BS, dtype=torch.int32, device="cuda")[None]
    inp = ModelInputs(toks, pos, bt, torch.tensor([n], dtype=torch.int32, device="cuda"),
                      torch.zeros(1, dtype=torch.int32, device="cuda"))
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
    attn = {}
    for e in kernels:
        if "paged_" in e.key:
            name = "paged_prefill" if "prefill" in e.key else "paged_decode"
            attn[name] = attn.get(name, 0) + dev(e)
    gw = sum(dev(e) for e in kernels if is_gw(e))
    lib = sum(dev(e) for e in kernels if not is_gw(e)
              and any(m in e.key for m in ("nvjet", "gemm", "cutlass", "xmma")))
    busy = sum(dev(e) for e in kernels)
    top = sorted(kernels, key=dev, reverse=True)[:6]
    _line("profile-prefill", model=cfg.model_type, weights=tag, gemm=model.gemm_variant,
          **_kv_mode(engine), rows=t, live_tokens=n, forward_wall_ms=f"{wall_ms:.1f}",
          kernel_ms=ms(busy), attention_ms=ms(sum(attn.values())), gw_gemm_ms=ms(gw),
          library_gemm_ms=ms(lib), other_ms=ms(busy - sum(attn.values()) - gw - lib),
          launches=sum(e.count for e in kernels),
          top_kernels_ms="|".join(f"{e.key[:44]}:{ms(dev(e))}" for e in top))


def _tensor_gbytes(weights):
    return sum(t.numel() * t.element_size() for t in weights.values()
               if hasattr(t, "numel")) / 1e9


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


def phase_qwen2(gen, card):
    """Phases 6-9 on Qwen2-7B. Returns ({kernel name: launches on its serve
    path}, plain-version calls over the serve phases)."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    cfg = qwen2_7b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 1, "qwen2-7b")
    steps, num_blocks = model_steps(cfg, gen)
    bf16_logits = phase_model(model, weights, steps, num_blocks)
    engine, launches, plain_calls = phase_serve(model, weights, gen, card)
    del engine

    # 4-bit: quantize on the card, fuse as the engine does, free the bf16 linears
    wq, quant_s = _to_gptq_form(model, weights)
    phase_model_4bit_cuts(cfg, weights, wq, gen)
    _free_linears(weights, wq, cfg, "qwen2-7b", quant_s)
    model.gemm_variant = "base"
    phase_model_4bit(model, wq, steps, num_blocks, "gptq_form_full_width", bf16_logits)
    engine, got, plain = phase_serve(model, wq, gen, card, tag="int4", gemm="base")
    del engine
    # the attention kernels' rows keep the bf16 path's counts
    launches["gw_gemm"] = got["gw_gemm"]
    engine, got, plain_pipe = phase_serve(model, wq, gen, card, tag="int4", gemm="pipe")
    del engine
    launches["gw_gemm_pipe"] = got["gw_gemm_pipe"]
    model.gemm_variant = "base"
    torch.cuda.empty_cache()
    return launches, plain_calls + plain + plain_pipe


def phase_llama3(gen, card):
    """Llama-3-8B at full width and depth on a quantized KV pool.

    Model steps with bf16 weights: int8 KV with in-layer writes and with
    deferred writes, every layer's attention held against the plain version;
    the distance of the int8-KV logits to the bf16-KV logits, and of the
    deferred to the in-layer ones. A 4-layer cut of the same weights serves
    with an fp8 pool. Then the weights go to the GPTQ form and the engine
    serves with 4-bit weights, int8 KV, prefix cache and deferred writes.
    Returns ({kernel name: launches}, plain-version calls, the engines whose
    decode step is profiled at the end: int8 KV deferred, int8 KV in-layer,
    bf16 KV)."""
    import dataclasses

    import torch

    from rtp_llm_tpu_torch.config.model_config import llama3_8b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    cfg = llama3_8b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 2, "llama3-8b")
    steps, num_blocks = model_steps(cfg, gen)
    bf16_kv = run_steps(model, weights, steps, num_blocks)
    int8_kv = phase_model(model, weights, steps, num_blocks, kv="int8")
    int8_deferred = phase_model(model, weights, steps, num_blocks, kv="int8", defer=True)
    _logits_distance("llama3-8b int8 KV vs bf16 KV", int8_kv, bf16_kv)
    _logits_distance("llama3-8b int8 KV deferred vs in-layer", int8_deferred, int8_kv)
    del bf16_kv, int8_kv, int8_deferred

    # fp8 pool, bf16 weights: a 4-layer cut of the same weights
    layers = 4
    cut = LlamaFamilyModel(dataclasses.replace(cfg, num_layers=layers), device="cuda")
    whole = ("embed_tokens", "lm_head", "final_norm")
    # copies, not views: a view would keep the whole 32-layer stack alive
    cut_weights = {n: (t if n in whole else t[:layers].clone()) for n, t in weights.items()}
    cut_steps, cut_blocks = model_steps(cut.cfg, gen, lens=(60, 300, 500), t=512, decode_steps=2)
    phase_model(cut, cut_weights, cut_steps, cut_blocks, kv="fp8")
    engine, launches, plain_calls = phase_serve(cut, cut_weights, gen, card, tag="bf16-4-layers",
                                                kv="fp8", name="llama3-8b")
    del engine, cut_weights

    wq, quant_s = _to_gptq_form(model, weights)
    _free_linears(weights, wq, cfg, "llama3-8b", quant_s)
    del weights
    torch.cuda.empty_cache()
    phase_kv_pool(model)
    served, got, plain = phase_serve(model, wq, gen, card, tag="int4", gemm="base", kv="int8",
                                     defer=True, name="llama3-8b")
    launches.update(got)
    launches.pop("gw_gemm")  # that row keeps the Qwen2-7B serve's count
    # the same weights beside the other two write modes, for the step tables:
    # a window each in turns, there and back, since the host's load drifts
    engines = [served, make_engine(model, wq, gemm="base", kv="int8"),
               make_engine(model, wq, gemm="base", kv="bfloat16")]
    for engine in engines[1:] + engines[::-1]:
        phase_step_time(engine, cfg, gen, "int4")
    return launches, plain_calls + plain, engines


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

    _line("kv-pool", model="llama3-8b", weights="int4-gptq-form", block_size=BS,
          device_gbytes_allocated=f"{torch.cuda.memory_allocated() / 1e9:.2f}", **out)


def phase_profiles(gen, llama_engines):
    """Profiler windows, after everything timed: their hooks slow every
    later launch of the process. The three Llama-3-8B engines (int8 KV
    deferred, int8 KV in-layer, bf16 KV), then Qwen2-7B as before, its
    weights drawn again from their seed."""
    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    deferred, int8, bf16 = (phase_profile(engine, engine.model.cfg, gen, "int4")
                            for engine in llama_engines)
    phase_profile_prefill(llama_engines[0], gen, "int4")
    layers = llama_engines[0].model.cfg.num_layers
    # what the quantize-and-write ops (plain PyTorch) add to a decode step
    _line("kv-write-launches", model="llama3-8b", layers=layers,
          bf16_in_layer_per_step=f"{bf16:.0f}", int8_in_layer_per_step=f"{int8:.0f}",
          int8_deferred_per_step=f"{deferred:.0f}",
          int8_in_layer_over_bf16_per_layer=f"{(int8 - bf16) / layers:.1f}",
          int8_deferred_over_bf16_per_step=f"{deferred - bf16:.0f}")
    llama_engines.clear()
    torch.cuda.empty_cache()
    cfg = qwen2_7b_config()
    model = LlamaFamilyModel(cfg, device="cuda")
    weights = _seeded_weights(model, 1, "qwen2-7b")
    wq, _ = _to_gptq_form(model, weights)
    for gemm in ("pipe", "base"):
        engine = make_engine(model, wq, gemm=gemm)
        phase_profile(engine, cfg, gen, "int4")
        phase_profile_prefill(engine, gen, "int4")
        del engine
    model.gemm_variant = "base"
    del wq
    engine = make_engine(model, weights)
    phase_profile(engine, cfg, gen, "bf16")
    phase_profile_prefill(engine, gen, "bf16")


if __name__ == "__main__":
    sys.exit(main())
