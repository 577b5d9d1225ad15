"""Port model forward vs the JAX ``LlamaFamilyModel.forward``.

Tiny qwen2 / llama / qwen3 configs, weights from the JAX package's fake
checkpoint through its loader, carried over with ``weights_from_jax``. Each
case runs a two-row prefill, a second prefill chunk with q_offset > 0 (the
prefix-reuse shape) and a decode step on both sides; logits and the KV pool
must agree to 1e-4 (f32; summation order differs).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

TOL = dict(rtol=1e-4, atol=1e-4)
BS, NB = 4, 24


def port_config(jcfg) -> TConfig:
    names = {f.name for f in dataclasses.fields(TConfig)}
    return TConfig(**{n: getattr(jcfg, n) for n in names})


def _steps():
    """(tokens, positions, block_tables, kv_lens, q_offsets) per call."""
    rng = np.random.default_rng(0)
    bt = np.zeros((2, 6), np.int32)
    bt[0, :5] = [3, 7, 1, 9, 12]
    bt[1, :5] = [2, 5, 11, 4, 6]
    t = 12
    toks = rng.integers(1, 128, size=(2, t))
    pos = np.tile(np.arange(t), (2, 1))
    lens = np.array([10, 7])
    toks[1, 7:] = 0
    pos[1, 7:] = 0
    toks[0, 10:] = 0
    pos[0, 10:] = 0
    yield toks, pos, bt, lens, np.array([0, 0])
    # second chunk at q_offset > 0
    t2 = 8
    toks2 = rng.integers(1, 128, size=(2, t2))
    offs = np.array([10, 7])
    lens2 = np.array([15, 10])
    pos2 = offs[:, None] + np.arange(t2)[None, :]
    for r in range(2):
        n = lens2[r] - offs[r]
        toks2[r, n:] = 0
        pos2[r, n:] = 0
    yield toks2, pos2, bt, lens2, offs
    # one decode step
    yield (rng.integers(1, 128, size=(2, 1)), lens2[:, None], bt, lens2 + 1, lens2)


@pytest.fixture(scope="module", params=["qwen2", "llama", "qwen3"])
def family(request, tmp_path_factory):
    jcfg = tiny_config(request.param)
    jcfg.dtype = "float32"
    ckpt = write_fake_checkpoint(str(tmp_path_factory.mktemp(request.param)), jcfg)
    jw = JLoader(jcfg).load(ckpt)
    return jcfg, jw


def test_forward_matches_jax(family):
    jcfg, jw = family
    jmodel = create_model(jcfg)
    jcache = jmodel.init_cache(NB, BS, jnp.float32)
    tmodel = LlamaFamilyModel(port_config(jcfg), device="cpu")
    tw = tmodel.fuse_weights(
        weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu"))
    tcache = tmodel.init_cache(NB, BS, torch.float32)
    for toks, pos, bt, lens, offs in _steps():
        jin = JInputs(tokens=jnp.asarray(toks, jnp.int32), positions=jnp.asarray(pos, jnp.int32),
                      block_tables=jnp.asarray(bt), kv_lens=jnp.asarray(lens, jnp.int32),
                      q_offsets=jnp.asarray(offs, jnp.int32))
        jout, jcache = jmodel.forward(jw, jcache, jin)
        tin = ModelInputs(*(torch.from_numpy(np.asarray(a)) for a in (toks, pos, bt, lens, offs)))
        tout, tcache = tmodel.forward(tw, tcache, tin)
        np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), **TOL)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), **TOL)


def test_fused_weights_give_same_logits(family):
    """Load-time QKV / gate-up fusion lays the weights out as the JAX
    ``fuse_weights`` does, and both fused forwards give the same logits."""
    jcfg, jw = family
    jmodel = create_model(jcfg)
    jfused = jmodel.fuse_weights(jw)
    model = LlamaFamilyModel(port_config(jcfg), device="cpu")
    fused = model.fuse_weights(
        weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu"))
    assert "qkv_proj" in fused and "gate_up_proj" in fused and "q_proj" not in fused
    for name in ("qkv_proj", "qkv_bias", "gate_up_proj"):
        assert (name in fused) == (name in jfused), name
        if name in fused:
            np.testing.assert_array_equal(fused[name].numpy(), np.asarray(jfused[name]))
    assert model.fuse_weights(fused).keys() == fused.keys()
    toks, pos, bt, lens, offs = next(_steps())
    jin = JInputs(tokens=jnp.asarray(toks, jnp.int32), positions=jnp.asarray(pos, jnp.int32),
                  block_tables=jnp.asarray(bt), kv_lens=jnp.asarray(lens, jnp.int32),
                  q_offsets=jnp.asarray(offs, jnp.int32))
    jout, _ = jmodel.forward(jfused, jmodel.init_cache(NB, BS, jnp.float32), jin)
    tin = ModelInputs(*(torch.from_numpy(np.asarray(a)) for a in (toks, pos, bt, lens, offs)))
    tout, _ = model.forward(fused, model.init_cache(NB, BS, torch.float32), tin)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), **TOL)


def test_bf16_weights_carry_over_exactly(family):
    jcfg, jw = family
    arr = np.asarray(jw["embed_tokens"].astype(jnp.bfloat16))
    t = weights_from_jax({"embed_tokens": arr}, device="cpu")["embed_tokens"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
