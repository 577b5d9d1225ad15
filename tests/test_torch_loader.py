"""The port's safetensors loader vs the JAX ``CheckpointLoader``: every
canonical weight must be identical (same name, shape, dtype and bits)."""

import numpy as np
import pytest

import torch

from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import (
    tiny_config, write_fake_checkpoint, write_fake_checkpoint_sharded,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.loader.loader import SafetensorsFile

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each


def _assert_same(jw, tw):
    assert set(tw) == set(jw)
    ref = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    for name, t in tw.items():
        assert t.dtype == ref[name].dtype, name
        assert torch.equal(t, ref[name]), name


@pytest.mark.parametrize("mt,dtype", [("qwen2", "float32"), ("llama", "float32"),
                                      ("qwen3", "float32"), ("qwen2", "bfloat16")])
def test_loader_matches_jax(tmp_path, mt, dtype):
    jcfg = tiny_config(mt, dtype=dtype)
    ckpt = write_fake_checkpoint(str(tmp_path / mt), jcfg)
    tcfg = TConfig.from_pretrained(ckpt)
    tcfg.dtype = dtype
    assert (tcfg.model_type, tcfg.attention_bias, tcfg.use_qk_norm) == (
        mt, jcfg.attention_bias, jcfg.use_qk_norm)
    _assert_same(JLoader(jcfg).load(ckpt), TLoader(tcfg, device="cpu").load(ckpt))


def test_sharded_index_checkpoint(tmp_path):
    """model.safetensors.index.json + several f16 shards."""
    jcfg = tiny_config("qwen2", dtype="float32")
    ckpt = write_fake_checkpoint_sharded(str(tmp_path / "sh"), jcfg, max_shard_bytes=40_000)
    tcfg = TConfig.from_pretrained(ckpt)
    tcfg.dtype = "float32"
    _assert_same(JLoader(jcfg).load(ckpt), TLoader(tcfg, device="cpu").load(ckpt))


def test_safetensors_reader_roundtrip(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b": rng.standard_normal((7,)).astype(np.float16),
               "c": np.arange(6, dtype=np.int64).reshape(2, 3)}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    f = SafetensorsFile(str(tmp_path / "x.safetensors"))
    try:
        for k, v in tensors.items():
            np.testing.assert_array_equal(f.get(k).numpy(), v)
    finally:
        f.close()
