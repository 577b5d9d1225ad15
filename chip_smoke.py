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
     Phases 3-4 also plant faults (one 64-token tile read from the wrong
     block, kv_len off by one) and fail unless the check catches them;
  5. full-width Qwen2-7B (28 layers, bf16, weights from a seeded generator on
     the card, fused as the engine serves them): a prefill of a few prompts
     plus decode steps through the kernels. Every layer's attention output
     is held against the plain version on the same inputs (and a planted
     fault must fail that check); the logits against the same forward
     through plain attention;
  6. serve: the engine behind ``build_app`` on a local port answers ~8
     concurrent /v1/completions requests (two share a 1024-token prefix and
     the second must reuse it), then one lone 1000-token request, /health
     and /worker_status; then a profiled window of decode steps (step time,
     device busy share from kernel time only, top kernels);
  7. one ``kernels`` JSON line: launches of each kernel during the serve
     phase (each must be > 0, plain attention calls there must be 0), max
     error against the plain version, and kernel / plain / library / bound
     times at the main path's shapes.
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


def _planted(tag, cases):
    """Each (name, got, want) is a kernel run with a planted fault: the check
    must fail it, or it cannot tell a wrong kernel from a right one."""
    missed = []
    for name, got, want in cases:
        _, rel, ok = _check(got, want)
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
    from rtp_llm_tpu_torch.ops.attention import decode, prefill

    kernels = [decode.KERNEL, prefill.KERNEL]
    secs = _kernels.build_all(kernels)
    for k in kernels:
        info = [ln.strip() for ln in k.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        _line("ptxas", kernel=k.name, info=" | ".join(info) or "cached")
    _line("build", seconds=f"{secs:.1f}", kernels=",".join(k.name for k in kernels))


# ---------------------------------------------------------------- phase 3


def _pool(num_blocks, gen, bs=BS):
    import torch

    shape = (num_blocks * bs, HKV * D)
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


def _sdpa_decode(q, k_cache, v_cache, bt, lens, window):
    """Library yardstick: F.scaled_dot_product_attention over the gathered KV."""
    import torch
    import torch.nn.functional as F

    b, mb = bt.shape
    s = mb * BS
    idx = (bt.long()[:, :, None] * BS + torch.arange(BS, device="cuda")).reshape(b, s)
    kk = k_cache[idx].reshape(b, s, HKV, D).transpose(1, 2).contiguous()
    vv = v_cache[idx].reshape(b, s, HKV, D).transpose(1, 2).contiguous()
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


def _sdpa_prefill(q, k_cache, v_cache, bt, q_off, kv_len):
    import torch

    t = q.shape[1]
    s = bt.shape[1] * BS
    idx = (bt[0].long()[:, None] * BS + torch.arange(BS, device="cuda")).reshape(s)
    kk = k_cache[idx].reshape(1, s, HKV, D).transpose(1, 2).contiguous()
    vv = v_cache[idx].reshape(1, s, HKV, D).transpose(1, 2).contiguous()
    qpos = q_off + torch.arange(t, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = ((kpos <= qpos) & (kpos < kv_len))[None, None]
    return _sdpa_call(q.transpose(1, 2).contiguous(), kk, vv, mask)


def phase_prefill(gen):
    import torch

    from rtp_llm_tpu_torch.ops.attention.prefill import (
        paged_prefill_attention, paged_prefill_ref,
    )

    sm = D ** -0.5
    worst, record = 0.0, None
    cases = [(t, off, 0, 0) for t in (64, 512, 2048) for off in (0, 37, 1000)]
    cases += [(512, 37, 13, 0), (2048, 1000, 300, 0), (512, 37, 0, 100)]
    for t, off, tail, window in cases:
        kv_len = off + t - tail
        mb = -(-(off + t) // BS) + 1
        bt, nblocks = _tables([off + t], mb, gen)
        k_cache, v_cache = _pool(nblocks, gen)
        q = torch.randn((1, t, HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        offs = torch.tensor([off], dtype=torch.int32, device="cuda")
        lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
        args = (q, k_cache, v_cache, bt, offs, lens, sm, BS)
        got = paged_prefill_attention(*args, sliding_window=window)
        want = paged_prefill_ref(*args, sliding_window=window)
        torch.cuda.synchronize()
        err, rel, ok = _check(got, want)
        tail_ok = bool((got[:, t - tail:] == 0).all()) if tail else True
        ok = ok and tail_ok
        _line("prefill", T=t, q_offset=off, tail=tail, window=window,
              max_abs_err=f"{err:.3e}", max_rel_l2=f"{rel:.3e}", tail_zero=tail_ok, ok=ok)
        if not ok:
            raise SystemExit(f"prefill kernel disagrees with plain (T={t}, "
                             f"q_offset={off}, tail={tail}, window={window})")
        worst = max(worst, err)
        if tail or window or off == 37:
            continue
        ms = _time_ms(lambda: paged_prefill_attention(*args), iters=10)
        plain_ms = _time_ms(lambda: paged_prefill_ref(*args), iters=3, warmup=1)
        lib_ms = _time_ms(_sdpa_prefill(q, k_cache, v_cache, bt, off, kv_len), iters=10)
        pairs = sum(min(off + i + 1, kv_len) for i in range(t) if off + i < kv_len)
        flops = 4.0 * pairs * HQ * D
        nbytes = 2 * t * HQ * D * 2 + kv_len * HKV * D * 2 * 2 + bt.numel() * 4
        bound, by = _bound_ms(nbytes, flops)
        _line("prefill-time", T=t, q_offset=off, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by)
        if t == 2048 and off == 0:
            record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
            # the 10th key tile read from the null block; kv_len one short
            bt_bad = bt.clone()
            bt_bad[0, 10] = 0
            _planted("prefill-fault", [
                ("one_tile_from_null_block", paged_prefill_attention(
                    q, k_cache, v_cache, bt_bad, offs, lens, sm, BS), want),
                ("kv_len_minus_1", paged_prefill_attention(
                    q, k_cache, v_cache, bt, offs, lens - 1, sm, BS), want)])
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
    _line("kernels-checked", seconds=f"{time.time() - t0:.1f}")
    launches, plain_calls = phase_model_and_serve(gen, card)

    rows = []
    for name, src, rep, rec in (
        ("paged_decode", "rtp_llm_tpu_torch/csrc/paged_decode.cu",
         "rtp_llm_tpu/ops/attention/pallas_decode.py:206", dec),
        ("paged_prefill", "rtp_llm_tpu_torch/csrc/paged_prefill.cu",
         "rtp_llm_tpu/ops/attention/pallas_prefill.py:43", pre),
    ):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if not all(n > 0 for n in launches.values()) or plain_calls != 0:
        print("chip_smoke: a kernel was not launched on the serve path, or the "
              "plain attention was", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def random_weights(cfg, gen):
    """Qwen2-7B-shaped canonical weights (unfused, stacked [L, in, out], bf16)
    drawn on the card from ``gen``, as a checkpoint loader gives them."""
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


def phase_model(model, weights, gen):
    """Prefill 3 prompts (one padded B=3 bucket) + 4 decode steps through
    the kernels, each layer's attention checked against the plain version;
    then the same inputs through the plain attention for the logits."""
    import torch

    from rtp_llm_tpu_torch.models import ModelInputs

    cfg = model.cfg
    lens = [100, 700, 1500]
    t = 2048
    mb = -(-(max(lens) + 8) // BS)
    bt = torch.arange(1, 1 + 3 * mb, dtype=torch.int32, device="cuda").reshape(3, mb)
    toks = torch.randint(1, cfg.vocab_size, (3, t), generator=gen, device="cuda")
    pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(3, 1)
    for r, n in enumerate(lens):
        toks[r, n:] = 0
        pos[r, n:] = 0
    steps = [ModelInputs(toks, pos, bt, torch.tensor(lens, dtype=torch.int32, device="cuda"),
                         torch.zeros(3, dtype=torch.int32, device="cuda"))]
    for i in range(4):
        cur = torch.tensor([n + i for n in lens], dtype=torch.int32, device="cuda")
        steps.append(ModelInputs(
            torch.randint(1, cfg.vocab_size, (3, 1), generator=gen, device="cuda"),
            cur[:, None], bt, cur + 1, cur))
    results = {}
    checker = _checked_attention()
    for run in ("kernel", "plain"):
        model.attn_backend = "auto" if run == "kernel" else "plain"
        cache = model.init_cache(3 * mb + 1, BS, torch.bfloat16)
        logits = []
        with checker if run == "kernel" else contextlib.nullcontext():
            for inp in steps:
                out, cache = model.forward(weights, cache, inp)
                logits.append(out.logits)
        torch.cuda.synchronize()
        results[run] = torch.stack(logits)
        del cache
    model.attn_backend = "auto"
    got, want = results["kernel"], results["plain"]
    calls = len(checker.stats)
    layer_ok = all(c[2] for c, _ in checker.stats)
    layer_rel = max(c[1] for c, _ in checker.stats)
    layer_err = max(c[0] for c, _ in checker.stats)
    fault_caught = all(not f[2] for _, f in checker.stats)
    fault_rel = min(f[1] for _, f in checker.stats)
    rel_l2 = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ok = (got.shape == (5, 3, cfg.vocab_size) and bool(torch.isfinite(got).all())
          and calls == 5 * cfg.num_layers and layer_ok and fault_caught
          and rel_l2 <= MODEL_LOGITS_REL_L2)
    _line("model", layers=cfg.num_layers, hidden=cfg.hidden_size, prompts=lens,
          decode_steps=4, attn_calls_checked=calls, attn_max_abs_err=f"{layer_err:.3e}",
          attn_max_rel_l2=f"{layer_rel:.3e}", attn_tol=REL_L2,
          planted_fault_min_rel_l2=f"{fault_rel:.3e}", planted_fault_caught=fault_caught,
          logits_rel_l2=f"{rel_l2:.3e}", logits_tol=MODEL_LOGITS_REL_L2,
          argmax_agree=f"{agree:.3f}", ok=ok)
    if not ok:
        raise SystemExit("full-width model: the kernel path disagrees with plain attention, "
                         "or the per-layer check missed the planted fault")


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


def phase_serve(model, weights, gen, card):
    import threading
    import urllib.request

    import torch

    from rtp_llm_tpu_torch.config import CacheConfig, EngineConfig
    from rtp_llm_tpu_torch.engine import LlmEngine
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.ops.attention import PLAIN_CALLS, decode, prefill

    cfg = model.cfg
    engine = LlmEngine(model, weights,
                       EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=1024)),
                       device="cuda")
    app = build_app(engine, tokenizer=None, model_name="qwen2-7b-random")
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

        for k in (decode.KERNEL, prefill.KERNEL):
            k.launches.n = 0
        PLAIN_CALLS.n = 0
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
        launches = {"paged_decode": decode.KERNEL.launches.n,
                    "paged_prefill": prefill.KERNEL.launches.n}
        plain_calls = PLAIN_CALLS.n

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
    if bad:
        raise SystemExit("serve phase failed: " + "; ".join(bad))
    concurrent = results[1:1 + len(others)]
    ttfts = [r[0] for r in concurrent]
    rates = [31.0 / (r[1] - r[0]) for r in concurrent if r[1] > r[0]]
    total_out = sum(r[2]["usage"]["completion_tokens"] for r in concurrent)
    _line("serve", requests=len(results), shared_prefix_reuse_tokens=reuse,
          ttft_first_ms=f"{results[0][0] * 1e3:.1f}",
          ttft_concurrent_ms_mean=f"{1e3 * sum(ttfts) / len(ttfts):.1f}",
          ttft_concurrent_ms_max=f"{1e3 * max(ttfts):.1f}",
          ttft_lone_1000_ms=f"{results[-1][0] * 1e3:.1f}",
          decode_tok_per_s_per_request=f"{sum(rates) / max(len(rates), 1):.1f}",
          concurrent_tok_per_s=f"{total_out / wall:.1f}",
          decode_launches=launches["paged_decode"],
          prefill_launches=launches["paged_prefill"], plain_calls=plain_calls,
          engine_steps=status.get("step_count"), card=card.replace(" ", "_"),
          seconds=f"{time.time() - t0:.1f}", ok=True)
    phase_profile(engine, cfg, gen)
    return launches, plain_calls


def phase_profile(engine, cfg, gen, rows=8, steps=5):
    """Where a decode step's time goes: host-clock step time over a steady
    window of ``rows`` active streams, then a torch.profiler window. Device
    time sums GPU kernel events only (a host op's entry repeats the time of
    the kernels it launched), grouped into GEMMs, the attention kernels and
    the rest; the busy share is that sum over the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtp_llm_tpu_torch.config import GenerateConfig

    for _ in range(rows):
        prompt = torch.randint(1, cfg.vocab_size, (500,), generator=gen, device="cuda").tolist()
        engine.enqueue(prompt, GenerateConfig(max_new_tokens=64, do_sample=False,
                                              ignore_eos=True))
    for _ in range(3):  # prefills + first decode steps
        engine.step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        engine.step()
    step_ms = (time.time() - t0) / 10 * 1e3
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
    gemm = sum(dev(e) for e in kernels
               if any(m in e.key for m in ("nvjet", "gemm", "cutlass", "xmma")))
    attn = sum(dev(e) for e in kernels if "paged_" in e.key)
    top = sorted(kernels, key=dev, reverse=True)[:8]
    _line("profile", active_rows=rows, decode_step_ms=f"{step_ms:.2f}",
          profiled_step_ms=f"{wall_us / steps / 1e3:.2f}",
          device_busy_share=f"{busy / wall_us:.3f}",
          kernel_ms_per_step=per_step(busy), gemm_ms_per_step=per_step(gemm),
          attention_ms_per_step=per_step(attn), other_ms_per_step=per_step(busy - gemm - attn),
          kernel_launches_per_step=f"{sum(e.count for e in kernels) / steps:.0f}",
          top_kernels_ms_per_step="|".join(f"{e.key[:40]}:{per_step(dev(e))}" for e in top))
    top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    _line("profile-host", top_host_ms_per_step="|".join(
        f"{e.key[:40]}:{e.self_cpu_time_total / steps / 1e3:.3f}" for e in top_cpu))


def phase_model_and_serve(gen, card):
    import torch

    from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config
    from rtp_llm_tpu_torch.models import LlamaFamilyModel

    cfg = qwen2_7b_config()
    t0 = time.time()
    model = LlamaFamilyModel(cfg, device="cuda")
    # the layout the engine serves: q/k/v and gate/up fused at load time
    weights = model.fuse_weights(random_weights(cfg, gen))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in weights.values())
    _line("weights", model="qwen2-7b", layers=cfg.num_layers, dtype="bf16",
          gbytes=f"{nbytes / 1e9:.2f}", seconds=f"{time.time() - t0:.1f}")
    phase_model(model, weights, gen)
    return phase_serve(model, weights, gen, card)


if __name__ == "__main__":
    sys.exit(main())
