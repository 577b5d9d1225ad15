"""The D 128 attention kernels of two checkouts, in turns on one card.

    python3 chip_ab_attention.py <other checkout>

builds ``csrc/paged_decode.cu`` and ``csrc/paged_prefill.cu`` of the other
checkout beside this one's and times their bf16 / int8 / e4m3 decode entries
at 64 rows of 2048 tokens (Qwen2-7B heads, 28 / 4; a replayed graph of 8
calls) and the bf16 prefill entry on one 2048-token prompt (Llama-3-8B
heads, 32 / 8), in rounds of (other, this, this, other); prints each one's
times, and whether the two give the same bits. An entry whose C signature
ends without ``soft_cap`` (sources that predate the soft-cap mode) is
called without it. Needs a CUDA card; imports nothing of JAX.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main(other: str) -> int:
    import torch

    card = cs.phase_device()
    from rtp_llm_tpu_torch import _kernels
    from rtp_llm_tpu_torch.ops.attention import decode, prefill
    from rtp_llm_tpu_torch.ops.kv_cache import FP8

    csrc = os.path.join(os.path.abspath(other), "rtp_llm_tpu_torch", "csrc")
    capped = {src: "float soft_cap" in open(os.path.join(csrc, src)).read()
              for src in ("paged_decode.cu", "paged_prefill.cu")}
    drop = lambda args, has: args if has else args[:-2] + args[-1:]  # the F32 before the stream
    kinds = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": FP8}
    other_dec = {dt: _kernels.Kernel("other_" + decode.KERNELS[dt].name,
                                     os.path.join(csrc, "paged_decode.cu"),
                                     decode.KERNELS[dt].entry,
                                     drop(decode._ARGTYPES[:-2], capped["paged_decode.cu"])
                                     + decode._ARGTYPES[-2:])
                 for dt in kinds.values()}
    other_pre = _kernels.Kernel("other_paged_prefill", os.path.join(csrc, "paged_prefill.cu"),
                                prefill.KERNELS[torch.bfloat16].entry,
                                drop(prefill._ARGTYPES, capped["paged_prefill.cu"]))
    mine = [decode.KERNELS[dt] for dt in kinds.values()] + [prefill.KERNELS[torch.bfloat16]]
    cs._line("ab-build", seconds=f"{_kernels.build_all(list(other_dec.values()) + [other_pre] + mine):.1f}",
             other_takes_soft_cap=capped)

    def dec_launch(kernel, has_cap, q, k, v, bt, lens, sm, ks=None, vs=None):
        b, hq, d = q.shape
        hkv = k.shape[1] // d
        splits = decode.num_splits(b, hkv, bt.shape[1], cs.BS, decode._sm_count(q.device),
                                   k.element_size())
        out = torch.empty_like(q)
        ws_o = ws_ml = None
        if splits > 1:
            ws_o = torch.empty((b, hq, splits, d), dtype=torch.float32, device="cuda")
            ws_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32, device="cuda")
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), k.stride(0), v.stride(0),
                ks.data_ptr() if ks is not None else None,
                vs.data_ptr() if vs is not None else None, ks.stride(0) if ks is not None else 0,
                bt.data_ptr(), bt.shape[1], lens.data_ptr(), None, None, 0, out.data_ptr(),
                ws_o.data_ptr() if ws_o is not None else None,
                ws_ml.data_ptr() if ws_ml is not None else None, b, hq, hkv, cs.BS, 0, float(sm)]
        kernel.launch(*args, *([0.0] if has_cap else []), splits, _kernels.stream_ptr(q.device))
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    hq, hkv, d = 28, 4, 128
    tl = [2048] * 64
    lens = torch.tensor(tl, dtype=torch.int32, device="cuda")
    bt, nb = cs._tables(tl, cs._kv_bucket_blocks(2048), gen)
    q = torch.randn((64, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    pools = {}
    for kind in kinds:
        (pk, pv, pkw), _ = cs._hd_pools(gen, kind, nb, hkv, d, bt, lens)
        pools[kind] = (pk, pv, pkw.get("k_scale"), pkw.get("v_scale"))
    runs = {"other": lambda dt: (other_dec[dt], capped["paged_decode.cu"]),
            "this": lambda dt: (decode.KERNELS[dt], True)}
    res, same = {}, {}
    for _ in range(3):
        for kind, dt in kinds.items():
            for label in ("other", "this", "this", "other"):
                kern, has = runs[label](dt)
                fn = lambda: dec_launch(kern, has, q, *pools[kind][:2], bt, lens, d ** -0.5,
                                        *pools[kind][2:])
                res.setdefault((f"decode_{kind}", label), []).append(cs._graph_ms(fn, 8, reps=10))
    for kind, dt in kinds.items():
        a, b = (dec_launch(*runs[lab](dt), q, *pools[kind][:2], bt, lens, d ** -0.5,
                           *pools[kind][2:]) for lab in ("other", "this"))
        same[f"decode_{kind}"] = bool(torch.equal(a, b))

    phq, phkv, tt = 32, 8, 2048
    tbt, tnb = cs._tables([tt], -(-tt // cs.BS), gen)
    toffs = torch.zeros(1, dtype=torch.int32, device="cuda")
    tlens = torch.full((1,), tt, dtype=torch.int32, device="cuda")
    (pk, pv, _), _ = cs._hd_pools(gen, "bf16", tnb, phkv, d, tbt, tlens)
    tq = torch.randn((1, tt, phq, d), generator=gen, device="cuda", dtype=torch.bfloat16)

    def pre_launch(kernel, has_cap):
        out = torch.empty_like(tq)
        kernel.launch(tq.data_ptr(), pk.data_ptr(), pv.data_ptr(), pk.stride(0), pv.stride(0),
                      None, None, 0, tbt.data_ptr(), tbt.shape[1], toffs.data_ptr(),
                      tlens.data_ptr(), out.data_ptr(), 1, tt, phq, phkv, cs.BS, 0,
                      float(d ** -0.5), *([0.0] if has_cap else []),
                      _kernels.stream_ptr(tq.device))
        return out

    pre = {"other": (other_pre, capped["paged_prefill.cu"]),
           "this": (prefill.KERNELS[torch.bfloat16], True)}
    for _ in range(3):
        for label in ("other", "this", "this", "other"):
            fn = lambda: pre_launch(*pre[label])
            res.setdefault(("prefill_bf16", label), []).append(cs._graph_ms(fn, 8, reps=10))
    same["prefill_bf16"] = bool(torch.equal(pre_launch(*pre["other"]), pre_launch(*pre["this"])))
    for (name, label), ms in sorted(res.items()):
        cs._line("ab", entry=name, checkout=label, device_ms=",".join(f"{x:.4f}" for x in ms),
                 min_ms=f"{min(ms):.4f}", mean_ms=f"{sum(ms) / len(ms):.4f}",
                 same_bits=same[name])
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
