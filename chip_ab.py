#!/usr/bin/env python3
"""One turn of a parent / change comparison of act_quant on one H100.

Run from anywhere, naming a checkout of the repository (any version of
``rtp_llm_tpu_torch`` with this version's ``chip_smoke.py`` beside it) and a
label for the output lines:

    python3 chip_ab.py <checkout> <label>

It builds the kernels of the checkout and times, as replayed CUDA graphs,
``act_quant`` at ``chip_smoke.ACT_TIMED`` (the W4A8 decode rows and the
lone and grouped prefill rows into the Qwen2-7B linears) and, as a control,
``i8_gemm`` at the Qwen2-7B qkv, gate-up and down shapes (one group and
groups of 128; M 64, 1000 and 2048; each call on the next layer's weights).
Then it serves full-width Qwen2-7B W8A8 (seeded weights, quantized on the
card) through ``chip_smoke.phase_serve``, builds full-width W4A8 (groups of
128) and times its decode step (``chip_smoke.phase_step_time``), and last,
since a profiler window slows every later launch, profiles the W8A8 and
W4A8 prefill forwards (``chip_smoke.phase_profile_prefill``) and the W4A8
decode step, graphed (``chip_smoke.phase_profile``). Compare two checkouts
in turns in one call (parent, change, change, parent): each turn is its
own process.
"""
import os
import sys
import time

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
os.chdir(tree)
sys.path.insert(0, tree)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

t_start = time.time()
card = cs.phase_device()
from rtp_llm_tpu_torch import _kernels  # noqa: E402
from rtp_llm_tpu_torch.ops import quant_gemm8 as q8  # noqa: E402
from rtp_llm_tpu_torch.ops.attention import decode, prefill  # noqa: E402

assert os.path.dirname(os.path.dirname(_kernels.__file__)) == tree
kernels = [*decode.KERNELS.values(), *prefill.KERNELS.values(), *q8.KERNELS.values()]
cs._line("turn-build", label=label, seconds=f"{_kernels.build_all(kernels):.1f}")
gen = torch.Generator(device="cuda")
gen.manual_seed(0)

for m, k in cs.ACT_TIMED:
    x = cs._act_input(m, k, k, 0, gen)
    q, s = q8.act_quant(x)
    rq, rs = q8.quantize_activations_ref(x)
    ms = cs._graph_ms(lambda: q8.act_quant(x), 8)
    bound, _ = cs._bound_ms(3.0 * m * k + 4.0 * m, 0.0)
    cs._line("turn-act-time", label=label, M=m, K=k, device_ms=f"{ms:.4f}",
             bound_ms=f"{bound:.4f}", share_of_bound=f"{bound / ms:.3f}",
             ok=torch.equal(q, rq) and torch.equal(s, rs))

for name in cs.W8_TIMED[:3]:
    k, n = cs.W8_SHAPES[name]
    for groups, lim in ((1, 127), (k // 128, 7)):
        copies = max(1, -(-120_000_000 // (k * n)))
        w = torch.randint(-lim, lim + 1, (copies, k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = (torch.rand((copies, groups, n), generator=gen, device="cuda") + 0.5) * 3e-3
        if groups == 1:
            s = s[:, 0]
        for m in (64, 1000, 2048):
            x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            xq, xs = q8.quantize_activations_ref(x)
            ok = cs._check_gemm(q8.i8_matmul(xq, xs, w[0], s[0]),
                                q8.i8_matmul_ref(xq, xs, w[0], s[0], torch.bfloat16))[2]
            ms = cs._graph_ms(cs._cycling(lambda i: q8.i8_matmul(xq, xs, w[i], s[i]), copies),
                              2 * copies)
            cs._line("turn-i8-time", label=label, shape=name, groups=groups, M=m,
                     device_ms=f"{ms:.4f}", ok=ok)
        del w, s
    torch.cuda.empty_cache()

from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config  # noqa: E402
from rtp_llm_tpu_torch.models import LlamaFamilyModel  # noqa: E402

cfg = qwen2_7b_config()
model = LlamaFamilyModel(cfg, device="cuda")
weights = cs._seeded_weights(model, 1, "qwen2-7b")
engines = {}
for tag, quant in (("w8a8", {}), ("w4a8", {"group_size": 128})):
    t0 = time.time()
    wq = cs.quantize_8bit(weights, tag, **quant)
    torch.cuda.synchronize()
    cs._weights_line(wq, cfg, "qwen2-7b", tag, time.time() - t0)
    if tag == "w8a8":
        engine, got, plain, b = cs.phase_serve(model, wq, gen, card, tag=tag, q8=tag,
                                               follow_up=False)
        cs._line("turn-launches", label=label, weights=tag, plain_calls=plain,
                 **{n: v for n, v in got.items() if n in ("w8_gemm", "act_quant", "i8_gemm")})
    else:
        engine = cs.make_engine(model, wq)
        cs.phase_step_time(engine, cfg, gen, tag, card)
    engines[tag] = engine
    del wq
del weights
for tag, engine in engines.items():
    cs.phase_profile_prefill(engine, gen, tag)
cs.phase_profile(engines["w4a8"], cfg, gen, "w4a8", mode="graph")
cs._line("turn-done", label=label, seconds=f"{time.time() - t_start:.1f}")
