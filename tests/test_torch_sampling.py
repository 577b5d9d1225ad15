"""Port sampler vs the JAX package: penalties and top-k/top-p masks equal,
greedy tokens exact. (Sampled tokens are not compared: the two frameworks'
random generators differ.)"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rtp_llm_tpu.ops import sampling as js
from rtp_llm_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

B, V = 6, 96


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    prompt_mask = rng.random((B, V)) < 0.1
    counts = (rng.random((B, V)) < 0.05) * rng.integers(1, 4, size=(B, V))
    params = dict(
        temperature=np.array([1.0, 0.7, 1.3, 1.0, 0.5, 2.0], np.float32),
        top_k=np.array([0, 5, 1, 64, 200, 3], np.int32),
        top_p=np.array([1.0, 0.9, 0.5, 0.3, 1.0, 0.95], np.float32),
        do_sample=np.array([False, True, True, False, True, False]),
        repetition_penalty=np.array([1.0, 1.2, 0.8, 1.0, 1.5, 1.1], np.float32),
        presence_penalty=np.array([0.0, 0.5, 0.0, 1.0, 0.2, 0.0], np.float32),
        frequency_penalty=np.array([0.0, 0.1, 0.3, 0.0, 0.0, 0.7], np.float32),
        ban_eos=np.array([False, True, False, True, False, False]),
    )
    jp = js.SamplingParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tp = ts.SamplingParams(**{k: torch.from_numpy(v) for k, v in params.items()})
    return logits, prompt_mask, counts, jp, tp


def test_apply_penalties_matches():
    logits, pm, counts, jp, tp = _inputs()
    want = js.apply_penalties(jnp.asarray(logits), jnp.asarray(pm),
                              jnp.asarray(counts, jnp.int16), jp)
    got = ts.apply_penalties(torch.from_numpy(logits), torch.from_numpy(pm),
                             torch.from_numpy(counts.astype(np.int32)), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_topp_mask_matches(seed):
    logits, _, _, jp, tp = _inputs(seed)
    want = np.asarray(js._topk_topp_mask(jnp.asarray(logits), jp))
    got = ts._topk_topp_mask(torch.from_numpy(logits), tp).numpy()
    np.testing.assert_array_equal(got <= ts.NEG_INF / 2, want <= js.NEG_INF / 2)
    kept = want > js.NEG_INF / 2
    np.testing.assert_array_equal(got[kept], want[kept])


def test_greedy_tokens_exact_with_penalties_and_eos_ban():
    logits, pm, counts, jp, tp = _inputs(3)
    jp = jp._replace(do_sample=jnp.zeros(B, bool))
    tp = tp._replace(do_sample=torch.zeros(B, dtype=torch.bool))
    eos = [int(np.argmax(logits[1])), 7]  # row 1 bans its own argmax
    jt, jl, jc = js.sample_tokens(jnp.asarray(logits), jp, jnp.asarray(pm),
                                  jnp.asarray(counts, jnp.int16), eos,
                                  jax.random.PRNGKey(0), need_sampling=False)
    tc = torch.from_numpy(counts.astype(np.int32))
    tt, tl = ts.sample_tokens(torch.from_numpy(logits), tp, torch.from_numpy(pm), tc, eos,
                              None, need_sampling=False)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))  # counts bumped in place


def test_sampling_respects_top_k_one_and_mask():
    """top_k=1 sampling rows must return the greedy token; every sampled
    token lies inside the top-k/top-p nucleus."""
    logits, pm, counts, _, tp = _inputs(4)
    gen = torch.Generator().manual_seed(0)
    filtered = ts._topk_topp_mask(torch.from_numpy(logits) / tp.temperature[:, None], tp)
    for _ in range(5):
        tt, _ = ts.sample_tokens(torch.from_numpy(logits), tp, torch.from_numpy(pm),
                                 torch.zeros((B, V), dtype=torch.int32), [], gen,
                                 need_stats=False)
        for r in range(B):
            if bool(tp.do_sample[r]):
                assert filtered[r, tt[r]] > ts.NEG_INF / 2
    row = 2  # top_k=1, do_sample
    assert int(tt[row]) == int(torch.argmax(filtered[row]))
