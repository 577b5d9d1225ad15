#!/usr/bin/env python3
"""One turn of a parent / change comparison of the graphed decode step on
one H100.

Run from anywhere, naming a checkout of the repository (any version of
``rtp_llm_tpu_torch`` with this version's ``chip_smoke.py`` beside it) and a
label for the output lines:

    python3 chip_ab.py <checkout> <label>

It builds the attention kernels of the checkout, serves nothing, and on
full-width Qwen2-7B bf16 (seeded weights, the engine as ``chip_smoke.py``
builds it, its graphs captured by ``warmup()``) times the decode step
(``chip_smoke.phase_step_time``: eager and graphed, one and four steps a
window, async off and on, 8 steady rows, with the replays' device ms) and
then profiles graphed decode steps (``chip_smoke.phase_profile``; last,
since a profiler window slows every later launch). Compare two checkouts in
turns in one call (parent, change, change, parent): each turn is its own
process.
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
from rtp_llm_tpu_torch.config import CacheConfig, EngineConfig  # noqa: E402
from rtp_llm_tpu_torch.config.model_config import qwen2_7b_config  # noqa: E402
from rtp_llm_tpu_torch.engine import LlmEngine  # noqa: E402
from rtp_llm_tpu_torch.models import LlamaFamilyModel  # noqa: E402
from rtp_llm_tpu_torch.ops.attention import decode, prefill  # noqa: E402

assert os.path.dirname(os.path.dirname(_kernels.__file__)) == tree
kernels = [*decode.KERNELS.values(), *prefill.KERNELS.values()]
cs._line("turn-build", label=label, seconds=f"{_kernels.build_all(kernels):.1f}")
gen = torch.Generator(device="cuda")
gen.manual_seed(0)

cfg = qwen2_7b_config()
model = LlamaFamilyModel(cfg, device="cuda")
weights = cs._seeded_weights(model, 1, "qwen2-7b")
engine = LlmEngine(model, weights, EngineConfig(cache=CacheConfig(block_size=cs.BS,
                                                                  num_blocks=1024)),
                   device="cuda")
t0 = time.time()
engine.warmup()
if hasattr(engine, "wait_warmup_complete"):  # the parent captures no tail
    engine.wait_warmup_complete()
cs._line("turn-warmup", label=label, graphs=len(engine._graphs.graphs),
         seconds=f"{time.time() - t0:.1f}")
cs.phase_step_time(engine, cfg, gen, f"bf16-{label}", card)
cs.phase_profile(engine, cfg, gen, f"bf16-{label}", mode="graph")
cs._line("turn-done", label=label, seconds=f"{time.time() - t_start:.1f}")
