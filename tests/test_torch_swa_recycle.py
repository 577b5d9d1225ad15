"""Sliding-window block recycling of the port against the JAX package, on
the CPU.

The cache manager: a scripted sequence of ``allocate``, ``shrink_sliding``,
``extend`` (past several windows, then with a block shared as a beam fork
shares it, which stops recycling) and ``free`` leaves the same block tables,
free counts and ``recycled`` flags as the JAX ``KVCacheManager`` (python
backend). The engine: a tiny mistral (a window of 8 tokens, blocks of 4, so
``swa_keep`` = 4) served with ``swa_recycle`` gives the JAX engine's greedy
tokens at ``decode_steps`` 1 / 4 with async decode off and on, prompts and
outputs well past the window; every stream in a decode slot holds at most
``swa_keep`` distinct blocks at every step, and the pool is whole after.
"""

import pytest

from rtp_llm_tpu.cache.kv_cache_manager import KVCacheManager as JManager
from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel

WINDOW, BS, NB, BATCH, MSL = 8, 4, 40, 4, 96
KEEP = -(-WINDOW // BS) + 2
CONFIGS = [(1, False), (1, True), (4, False), (4, True)]  # (decode_steps, async_decode)
IDS = ["n1-sync", "n1-async", "n4-sync", "n4-async"]
PROMPTS = [list(range(3, 3 + n)) for n in (5, 13, 22, 30)]
OUT = 28


# ---- the cache manager ----


def _state(mgr, allocs):
    return ([list(a.blocks) for a in allocs], [a.recycled for a in allocs],
            mgr.pool.free_blocks)


def test_manager_script_matches_jax():
    port = KVCacheManager(NB, BS, enable_prefix_cache=False, sliding_window_tokens=WINDOW)
    jax_mgr = JManager(NB, BS, enable_prefix_cache=False, backend="python",
                       sliding_window_tokens=WINDOW)
    assert port.swa_keep == jax_mgr.swa_keep == KEEP
    assert port.estimate_peak_blocks(30, 100) == jax_mgr.estimate_peak_blocks(30, 100)
    pa, ja = [], []
    for n in (5, 30, 18):
        pa.append(port.allocate(list(range(n)), allow_reuse=False))
        ja.append(jax_mgr.allocate(list(range(n)), allow_reuse=False))
    assert _state(port, pa) == _state(jax_mgr, ja)
    for p, j, n in zip(pa, ja, (5, 30, 18)):  # after prefill
        assert port.shrink_sliding(p, n + 1) == jax_mgr.shrink_sliding(j, n + 1)
    assert _state(port, pa) == _state(jax_mgr, ja)
    assert len(set(pa[1].blocks)) == KEEP and pa[1].recycled
    # decode growth past several windows: blocks come back round
    for total in range(6, 60, 3):
        for p, j, n in zip(pa, ja, (5, 30, 18)):
            assert port.extend(p, n + total) == jax_mgr.extend(j, n + total)
        assert _state(port, pa) == _state(jax_mgr, ja)
    assert all(len(set(a.blocks)) <= KEEP for a in pa)
    # a block held twice (a beam fork's reference) is not recycled
    forked = pa[2].blocks[-KEEP + 1]  # the block the next extend would recycle
    assert forked == ja[2].blocks[-KEEP + 1]
    for mgr in (port, jax_mgr):
        mgr.pool.ref([forked])
    free_before = port.pool.free_blocks
    for p, j, n in zip(pa, ja, (5, 30, 18)):
        assert port.extend(p, n + 70) == jax_mgr.extend(j, n + 70)
    assert _state(port, pa) == _state(jax_mgr, ja)
    assert port.pool.free_blocks < free_before  # fresh blocks past the fork
    for mgr in (port, jax_mgr):
        mgr.pool.free([forked])
    for p, j in zip(pa, ja):
        port.free(p)
        jax_mgr.free(j)
    assert port.pool.free_blocks == jax_mgr.pool.free_blocks == NB - 1


def test_manager_refuses_prefix_cache_with_recycling():
    with pytest.raises(ValueError, match="prefix cache"):
        KVCacheManager(NB, BS, enable_prefix_cache=True, sliding_window_tokens=WINDOW)
    off = KVCacheManager(NB, BS, enable_prefix_cache=False)
    a = off.allocate(list(range(30)), allow_reuse=False)
    assert not off.shrink_sliding(a, 31) and off.swa_keep == 0
    assert off.estimate_peak_blocks(30, 100) == off.blocks_for_tokens(130)


# ---- the engine ----


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = tiny_config("mistral", sliding_window=WINDOW)
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("swa")), cfg,
                                 extra_config={"sliding_window": WINDOW})


def port_engine(ckpt, steps, asy, recycle=True):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    assert cfg.sliding_window == WINDOW  # C6: mistral's window is read as published
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB, swa_recycle=recycle),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL,
                                  prefill_buckets=(16, 64), decode_steps=steps,
                                  async_decode=asy),
        quant=QuantConfig(kv_cache_dtype="float32"))
    weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def jax_engine(ckpt, steps, asy):
    cfg = tiny_config("mistral", sliding_window=WINDOW, dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB, swa_recycle=True),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy))
    econf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


def serve(engine, gen_cls, watch=None):
    streams = [engine.enqueue(p, gen_cls(max_new_tokens=OUT, do_sample=False, ignore_eos=True))
               for p in PROMPTS]
    for _ in range(400):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
        if watch is not None:
            watch(engine)
    assert all(s.is_finished() for s in streams)
    for _ in range(20):
        if not engine.has_work():
            break
        engine.step()
    return [list(s.output_token_ids) for s in streams]


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_recycled_engine_matches_jax(ckpt, steps, asy):
    engine = port_engine(ckpt, steps, asy)
    cm = engine.cache_mgr
    assert cm.swa_keep == KEEP and cm.prefix_cache is None
    seen = {"worst": 0, "recycled": 0}

    def watch(eng):
        for s in eng.slots:
            if s is not None and s.alloc is not None:
                seen["worst"] = max(seen["worst"], len(set(s.alloc.blocks)))
                seen["recycled"] += s.alloc.recycled

    got = serve(engine, GenerateConfig, watch)
    want = serve(jax_engine(ckpt, steps, asy), JGen)
    assert got == want
    assert seen["worst"] <= KEEP and seen["recycled"] > 0
    assert cm.pool.free_blocks == NB - 1


def test_recycling_leaves_tokens_as_they_were(ckpt):
    """Recycling changes which physical blocks hold what, never the tokens:
    the same engine without it (prefix cache on) serves the same."""
    assert serve(port_engine(ckpt, 1, True), GenerateConfig) == serve(
        port_engine(ckpt, 1, True, recycle=False), GenerateConfig)


def test_swa_recycle_flag_and_env(monkeypatch):
    """``--cache-swa-recycle`` / ``RTP_CACHE_SWA_RECYCLE`` set
    ``CacheConfig.swa_recycle`` (flag over env over default), as the JAX
    package's config surface does."""
    from rtp_llm_tpu.config.server_args import parse_engine_config as jax_parse
    from rtp_llm_tpu_torch.config.server_args import parse_engine_config

    for parse in (parse_engine_config, jax_parse):
        monkeypatch.delenv("RTP_CACHE_SWA_RECYCLE", raising=False)
        assert parse([]).cache.swa_recycle is False
        assert parse(["--cache-swa-recycle", "true"]).cache.swa_recycle is True
        monkeypatch.setenv("RTP_CACHE_SWA_RECYCLE", "1")
        assert parse([]).cache.swa_recycle is True
        assert parse(["--cache-swa-recycle", "false"]).cache.swa_recycle is False
