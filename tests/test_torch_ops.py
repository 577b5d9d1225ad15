"""Port ops vs the JAX package: norms, activations, RoPE, KV slots / writes.

Inputs are made with numpy from a seed and fed to both sides in float32.
Tolerance 1e-5 (f32 elementwise math; only summation order differs).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.ops import activations as jact
from rtp_llm_tpu.ops import kv_cache as jkv
from rtp_llm_tpu.ops import norms as jnorms
from rtp_llm_tpu.ops import rope as jrope
from rtp_llm_tpu_torch.ops import activations as tact
from rtp_llm_tpu_torch.ops import kv_cache as tkv
from rtp_llm_tpu_torch.ops import norms as tnorms
from rtp_llm_tpu_torch.ops import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_silu_and_mul():
    rng = np.random.default_rng(1)
    g, u = (rng.standard_normal((4, 32)).astype(np.float32) for _ in range(2))
    _close(tact.silu_and_mul(torch.from_numpy(g), torch.from_numpy(u)),
           jact.silu_and_mul(jnp.asarray(g), jnp.asarray(u)))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 256},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 256},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 128},
], ids=["default", "linear", "dynamic", "llama3", "yarn"])
def test_rope_tables_and_apply(scaling):
    cos_t, sin_t = trope.compute_rope_freqs(32, 512, 10000.0, scaling)
    cos_j, sin_j = jrope.compute_rope_freqs(32, 512, 10000.0, scaling)
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 512, size=(2, 6))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           torch.from_numpy(cos_t), torch.from_numpy(sin_t))
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), cos_j, sin_j)
    _close(got, want)


def test_token_slots_matches():
    rng = np.random.default_rng(3)
    bs = 4
    bt = rng.integers(1, 50, size=(3, 6)).astype(np.int32)
    pos = rng.integers(0, 6 * bs, size=(3, 5)).astype(np.int32)
    valid = rng.random((3, 5)) > 0.3
    got = tkv.token_slots(torch.from_numpy(pos), torch.from_numpy(bt), bs,
                          torch.from_numpy(valid))
    want = jkv.token_slots(jnp.asarray(pos), jnp.asarray(bt), bs, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # 1-D block table (single sequence)
    got1 = tkv.token_slots(torch.from_numpy(pos[0]), torch.from_numpy(bt[0]), bs,
                           torch.from_numpy(valid[0]))
    want1 = jkv.token_slots(jnp.asarray(pos[0]), jnp.asarray(bt[0]), bs,
                            jnp.asarray(valid[0]))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


def test_write_kv_drops_invalid_rows():
    """Invalid tokens (slot 2**30) leave the pool bit-for-bit unchanged,
    slot 0 (the null block) included — JAX's scatter mode="drop"."""
    rng = np.random.default_rng(4)
    ns, hkv, d = 32, 2, 8
    kc = rng.standard_normal((ns, hkv * d)).astype(np.float32)
    vc = rng.standard_normal((ns, hkv * d)).astype(np.float32)
    kn = rng.standard_normal((6, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((6, hkv, d)).astype(np.float32)
    slots = np.array([5, 2**30, 17, 2**30, 0 + 9, 2**30], np.int64)
    jk, jv = jkv.write_kv(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                          jnp.asarray(vn), jnp.asarray(slots.astype(np.int32)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tkv.write_kv(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                 torch.from_numpy(slots))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[0], kc[0])  # null slot untouched


def test_write_kv_into_pool_view():
    """Writes through a ``cache[l, 0]`` view land in the [L, 2, NS, HD] pool."""
    pool = torch.zeros((2, 2, 16, 4))
    new = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    tkv.write_kv(pool[1, 0], pool[1, 1], new, new + 100,
                 torch.tensor([3, tkv.INVALID_SLOT]))
    assert torch.equal(pool[1, 0, 3], new[0])
    assert torch.equal(pool[1, 1, 3], new[0] + 100)
    assert pool.abs().sum() == new[0].sum() + (new[0] + 100).sum()
