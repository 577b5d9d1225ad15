"""The mixture-of-experts trunk in the port against the JAX package and HF
``transformers``, on the CPU (ROADMAP A11 step 1a): qwen2_moe, qwen3_moe and
mixtral with bf16 / f32 expert stacks.

* ``route``, ``sort_by_expert``, the plain grouped product and
  ``fused_moe_plain`` against the JAX routing of ``_moe_mlp`` and
  ``rtp_llm_tpu/ops/moe.py::fused_moe`` (``jax.lax.ragged_dot``), f32 and
  bf16, with empty experts.
* X6's tile map (``csrc/moe_grouped_gemm.cu``): a numpy emulation of how
  each block finds its (expert, rows) from the device offsets covers every
  sorted row once in every column tile within the grid's ``ceil(R / TM) +
  E`` row tiles at every instance's tile height (64, 128, 160), on routed
  and on random (hypothesis) group sizes, an expert's blocks side by side;
  ``tile_rows`` picks the instance PERF.md records for the served models'
  decode and prefill rows.
* Configs: the presets against the published config.json; HF parsing,
  aliases; C27 (``decoder_sparse_step``: HF's sparse layers are those with
  ``(i + 1) % step == 0``, the JAX package's ``i % step == 0``) and C28
  (``norm_topk_prob`` absent: HF's Qwen2-MoE / Qwen3-MoE default False, the
  JAX package True), both pinned.
* Checkpoints written by HF's ``Qwen2MoeForCausalLM`` (a shared expert and
  its gate), ``Qwen3MoeForCausalLM`` (``decoder_sparse_step`` 2: layers 0
  and 2 dense) and ``MixtralForCausalLM`` at tiny widths (2-3 layers, 8 experts, top 2,
  expert width 32), every parameter redrawn at std 0.15; JAX fake
  checkpoints of qwen2_moe / qwen3_moe: the port's logits against HF's and
  the JAX model's, f32, within 1e-4.
* Quantized expert stacks raise, naming ROADMAP A11 step 1b.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.ops import moe as jmoe
from rtp_llm_tpu_torch.config import QuantConfig
from rtp_llm_tpu_torch.config import model_config as tmc
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.ops import moe as tmoe
from rtp_llm_tpu_torch.quant.weight_only import make_quant_transform

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

V = 128
BS = 4
PROMPT = [int(t) for t in np.random.default_rng(5).integers(3, V, 24)]
TOL = dict(rtol=1e-4, atol=1e-4)

# the HF forms: (HF class prefix, config kwargs)
HF_FORMS = {
    "qwen2_moe": ("Qwen2Moe", dict(num_experts=8, num_experts_per_tok=2,
                                   moe_intermediate_size=32, shared_expert_intermediate_size=48,
                                   intermediate_size=96, norm_topk_prob=False)),
    "qwen3_moe": ("Qwen3Moe", dict(num_experts=8, num_experts_per_tok=2, head_dim=16,
                                   moe_intermediate_size=32, intermediate_size=96,
                                   norm_topk_prob=True, decoder_sparse_step=2,
                                   num_hidden_layers=3)),
    "mixtral": ("Mixtral", dict(num_local_experts=8, num_experts_per_tok=2,
                                intermediate_size=32)),
}


# ---- routing and the expert products against the JAX functions ----


def _moe_case(rng, n, e, k, h=32, i=16, dtype=np.float32, skew=False):
    x = rng.standard_normal((n, h)).astype(np.float32)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    if skew:  # most tokens pick the first experts: the rest of the groups are empty
        logits[:, : e // 2] -= 8.0
    wg, wu = (rng.standard_normal((e, h, i)).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.standard_normal((e, i, h)).astype(np.float32) * 0.2
    return x, logits, wg, wu, wd


def _jax_route(logits, k, norm):
    """The JAX ``_moe_mlp`` softmax branch's (top_idx, top_vals)."""
    scores = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    top_vals, top_idx = jax.lax.top_k(scores, k)
    if norm:
        top_vals = top_vals / jnp.maximum(jnp.sum(top_vals, axis=-1, keepdims=True), 1e-20)
    return np.asarray(top_idx), np.asarray(top_vals)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("n,e,k", [(5, 8, 2), (64, 60, 4), (3, 16, 8)])
def test_route_matches_jax(n, e, k, norm):
    _, logits, *_ = _moe_case(np.random.default_rng(n + e), n, e, k)
    idx, w = tmoe.route(torch.from_numpy(logits), k, norm)
    jidx, jw = _jax_route(logits, k, norm)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("skew", [False, True])
def test_sort_by_expert_matches_jax(skew):
    rng = np.random.default_rng(3)
    _, logits, *_ = _moe_case(rng, 40, 16, 4, skew=skew)
    idx, _ = tmoe.route(torch.from_numpy(logits), 4, True)
    order, offsets = tmoe.sort_by_expert(idx, 16)
    flat = jnp.asarray(idx.numpy().reshape(-1))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jnp.argsort(flat)))
    counts = np.asarray(jnp.bincount(flat, length=16))
    np.testing.assert_array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert offsets.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_plain_matches_ragged_dot(dtype):
    rng = np.random.default_rng(4)
    x, logits, wg, _, _ = _moe_case(rng, 24, 8, 2, skew=True)
    idx, _ = tmoe.route(torch.from_numpy(logits), 2, True)
    order, offsets = tmoe.sort_by_expert(idx, 8)
    rows = order // 2
    tdt = getattr(torch, dtype)
    got = tmoe.grouped_gemm_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(wg).to(tdt),
                                  offsets, rows)
    jdt = getattr(jnp, dtype)
    sizes = jnp.asarray(np.diff(offsets.numpy()).astype(np.int32))
    want = jax.lax.ragged_dot(jnp.asarray(x, jdt)[jnp.asarray(rows.numpy())],
                              jnp.asarray(wg, jdt), sizes)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skew", [False, True])
def test_fused_moe_plain_matches_jax(dtype, skew):
    rng = np.random.default_rng(6)
    x, logits, wg, wu, wd = _moe_case(rng, 33, 8, 2, skew=skew)
    idx, w = tmoe.route(torch.from_numpy(logits), 2, True)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tmoe.fused_moe_plain(
        torch.from_numpy(x).to(tdt), idx, w,
        torch.cat([torch.from_numpy(wg), torch.from_numpy(wu)], dim=-1).to(tdt),
        torch.from_numpy(wd).to(tdt))
    want = jmoe.fused_moe(jnp.asarray(x, jdt), jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
                          jnp.asarray(wg, jdt), jnp.asarray(wu, jdt), jnp.asarray(wd, jdt))
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_cpu_takes_the_plain_products():
    rng = np.random.default_rng(8)
    x, logits, wg, wu, wd = (torch.from_numpy(a) for a in _moe_case(rng, 7, 4, 2))
    idx, w = tmoe.route(logits, 2, True)
    n0 = tmoe.PLAIN_CALLS.n
    got = tmoe.fused_moe(x, idx, w, torch.cat([wg, wu], -1), wd)
    assert tmoe.PLAIN_CALLS.n == n0 + 2  # gate-up and down
    torch.testing.assert_close(got, tmoe.fused_moe_plain(x, idx, w, torch.cat([wg, wu], -1), wd))


# ---- X6's tile map, emulated ----


def emulate_tile_map(offsets, tm, cols):
    """Each block's (expert, first row, rows, column tile) as
    ``moe_grouped_gemm.cu``'s block finds it: its row tile b // cols located
    by warp-wide prefix sums of ceil(count / tm) over experts in chunks of
    32, then its place among its expert's blocks, row tiles fastest; a block
    past the last tile gets no rows."""
    e = len(offsets) - 1
    r = offsets[-1]
    out = []
    for b in range((-(-r // tm) + e) * cols):
        row, found, base = b // cols, (0, 0, 0, 0), 0
        for e0 in range(0, e, 32):
            cnt = [offsets[j + 1] - offsets[j] if j < e else 0 for j in range(e0, e0 + 32)]
            tiles = [-(-c // tm) for c in cnt]
            inc = np.cumsum(tiles)
            for lane in range(32):
                excl = base + inc[lane] - tiles[lane]
                if excl <= row < excl + tiles[lane]:
                    k = b - excl * cols
                    j, c = k % tiles[lane], k // tiles[lane]
                    found = (e0 + lane, offsets[e0 + lane] + j * tm, min(tm, cnt[lane] - j * tm), c)
            base += inc[-1]
        out.append(found)
    return out


def check_tile_map(off, tm, cols=3):
    """Every sorted row covered once in every column tile, no tile past its
    expert or its height, the grid (ceil(R / tm) + E) x cols; an expert's
    blocks follow each other, each column tile's row tiles side by side."""
    e, r = len(off) - 1, off[-1]
    blocks = emulate_tile_map(off, tm, cols)
    assert len(blocks) == (-(-r // tm) + e) * cols
    seen = np.zeros((r, cols), int)
    for ex, first, n, c in blocks:
        if n:
            assert 0 < n <= tm and off[ex] <= first and first + n <= off[ex + 1] and 0 <= c < cols
            seen[first: first + n, c] += 1
    assert (seen == 1).all()
    live = [(ex, c) for ex, _, n, c in blocks if n]
    assert live == sorted(live)


# tile_rows' pick at each case: 64 rows at a few rows an expert, 160 at 128
# (Qwen3-30B-A3B's 2048-token prefill) and at 512 (Mixtral-8x7B's)
MAP_PICKS = {(512, 128): 64, (256, 60): 64, (128, 8): 64, (16384, 128): 160, (4096, 8): 160,
             (3, 128): 64}


@pytest.mark.parametrize("rows,e,k", [(64 * 8, 128, 8), (64 * 4, 60, 4), (64 * 2, 8, 2),
                                      (2048 * 8, 128, 8), (2048 * 2, 8, 2), (3, 128, 8)])
def test_tile_map_covers_every_row_once(rows, e, k):
    rng = np.random.default_rng(rows + e)
    idx = torch.from_numpy(rng.integers(0, e, (rows // k, k)))
    _, offsets = tmoe.sort_by_expert(idx, e)
    off = offsets.tolist()
    assert tmoe.tile_rows(off[-1], e) == MAP_PICKS[(rows, e)]
    for tm in tmoe.TILE_ROWS:
        check_tile_map(off, tm)


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 90), st.booleans()), min_size=1, max_size=70))
def test_tile_map_property(groups):
    """Random group sizes, many experts empty (each drawn empty or not): the
    tile map of every instance covers the rows once within its grid."""
    counts = [0 if empty else c for c, empty in groups]
    off = [0] + np.cumsum(counts).tolist()
    for tm in tmoe.TILE_ROWS:
        check_tile_map(off, tm)


# (model, tokens): X6's rows a tile at a 64-slot decode step and the 1000- and
# 2048-token prefills, as PERF.md's X6 switch-point table records them
SERVED_TILES = {
    ("qwen3_30b_a3b_config", 64): 64, ("qwen3_30b_a3b_config", 1000): 128,
    ("qwen3_30b_a3b_config", 2048): 160,
    ("qwen1_5_moe_a2_7b_config", 64): 64, ("qwen1_5_moe_a2_7b_config", 1000): 128,
    ("qwen1_5_moe_a2_7b_config", 2048): 160,
    ("mixtral_8x7b_config", 64): 64, ("mixtral_8x7b_config", 1000): 160,
    ("mixtral_8x7b_config", 2048): 160,
}


@pytest.mark.parametrize("preset,tokens", sorted(SERVED_TILES))
def test_served_rows_pick_the_recorded_instance(preset, tokens):
    cfg = getattr(tmc, preset)()
    rows = tokens * cfg.num_experts_per_tok
    assert tmoe.tile_rows(rows, cfg.num_experts) == SERVED_TILES[(preset, tokens)]


# (rows, experts, tile rows) where [moe-switch] found the height: Mixtral-8x7B
# at 180 and 360 rows an expert (a 160-row tile pads groups of 161-224 rows
# to 320), at 250 and 512 (160), at 56 and 64 (128 over 64); Qwen3-30B-A3B at
# 160 rows an expert (160: half its groups fit in one tile, none in one of
# 128), at 180 (128), at 48 (64) and 62.5 (128)
@pytest.mark.parametrize("rows,e,tm", [(1440, 8, 128), (2880, 8, 128), (2000, 8, 160),
                                       (4096, 8, 160), (448, 8, 128), (512, 8, 128),
                                       (20480, 128, 160), (23040, 128, 128), (6144, 128, 64),
                                       (8000, 128, 128)])
def test_tile_rows_picks_the_least_expected_cost(rows, e, tm):
    assert tmoe.tile_rows(rows, e) == tm


@pytest.mark.parametrize("m,tm", [(0.5, 64), (56.0, 64), (160.0, 128), (160.0, 160),
                                  (224.0, 128), (512.0, 160)])
def test_tiles_an_expert_matches_sampled_groups(m, tm):
    """The expected tiles of a group ~ Normal(m, m), against the mean of
    ceil(g / tm) over sampled groups (floored at one tile)."""
    g = np.random.default_rng(7).normal(m, m ** 0.5, 200_000)
    want = np.maximum(np.ceil(g / tm), 1).mean()
    assert abs(tmoe._tiles_an_expert(m, tm) - want) < 0.01


# ---- configs ----

PUBLISHED = {
    # Qwen/Qwen1.5-MoE-A2.7B config.json
    "qwen1_5_moe_a2_7b_config": {
        "model_type": "qwen2_moe", "hidden_size": 2048, "intermediate_size": 5632,
        "max_position_embeddings": 8192, "moe_intermediate_size": 1408, "norm_topk_prob": False,
        "num_attention_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
        "num_hidden_layers": 24, "num_key_value_heads": 16, "rms_norm_eps": 1e-06,
        "rope_theta": 1000000.0, "shared_expert_intermediate_size": 5632,
        "sliding_window": 32768, "use_sliding_window": False, "tie_word_embeddings": False,
        "vocab_size": 151936, "decoder_sparse_step": 1, "eos_token_id": 151643},
    # Qwen/Qwen3-30B-A3B config.json
    "qwen3_30b_a3b_config": {
        "model_type": "qwen3_moe", "hidden_size": 2048, "intermediate_size": 6144,
        "head_dim": 128, "max_position_embeddings": 40960, "moe_intermediate_size": 768,
        "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
        "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4,
        "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "sliding_window": None,
        "use_sliding_window": False, "tie_word_embeddings": False, "vocab_size": 151936,
        "decoder_sparse_step": 1, "mlp_only_layers": [], "attention_bias": False,
        "eos_token_id": 151645},
    # mistralai/Mixtral-8x7B-v0.1 config.json
    "mixtral_8x7b_config": {
        "model_type": "mixtral", "hidden_size": 4096, "intermediate_size": 14336,
        "max_position_embeddings": 32768, "num_attention_heads": 32, "num_experts_per_tok": 2,
        "num_hidden_layers": 32, "num_key_value_heads": 8, "num_local_experts": 8,
        "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "sliding_window": None,
        "tie_word_embeddings": False, "vocab_size": 32000, "eos_token_id": 2},
}


@pytest.mark.parametrize("preset", sorted(PUBLISHED))
def test_presets_equal_the_published_configs(preset):
    got = getattr(tmc, preset)()
    want = TConfig.from_hf_config(PUBLISHED[preset])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert all(got.is_moe_layer(i) for i in range(got.num_layers))


def test_qwen3_yarn_option():
    cfg = tmc.qwen3_30b_a3b_config(yarn=True)
    assert cfg.rope_scaling == {"rope_type": "yarn", "factor": 4.0,
                                "original_max_position_embeddings": 32768}
    assert cfg.max_position_embeddings == 131072


@pytest.mark.parametrize("alias,target", [("qwen_2_moe", "qwen2_moe"), ("qwen_3_moe", "qwen3_moe"),
                                          ("qwen_3_moe_eagle3", "qwen3_moe"),
                                          ("qwen3_coder_moe", "qwen3_moe"),
                                          ("qwen35_moe", "qwen3_moe"),
                                          ("qwen35_moe_mtp", "qwen3_moe")])
def test_aliases_are_served(alias, target):
    hf = dict(PUBLISHED["qwen3_30b_a3b_config"], model_type=alias)
    cfg = TConfig.from_hf_config(hf)
    jcfg = JConfig.from_hf_config(hf)
    for f in dataclasses.fields(TConfig):  # the JAX package's fields, read alike
        if f.name not in ("moe_norm_topk_prob", "num_shared_experts"):  # C28's defaults
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.num_shared_experts == (target == "qwen2_moe")
    assert tmc.arch_of(cfg.model_type) == target
    assert cfg.num_experts == 128 and cfg.use_qk_norm == (target == "qwen3_moe")
    assert alias not in tmc.UNSERVED_ALIASES


def test_unserved_moe_families_still_raise():
    for mt in ("glm4_moe", "deepseek_v3", "glm_5"):
        with pytest.raises(ValueError, match="not ported"):
            TConfig.from_hf_config(dict(PUBLISHED["qwen3_30b_a3b_config"], model_type=mt))


def test_c27_decoder_sparse_step():
    """C27: with ``decoder_sparse_step`` 2, HF's sparse layers are 1 and 3
    (``(i + 1) % 2 == 0``); the JAX package's are 0 and 2."""
    hf = dict(PUBLISHED["qwen3_30b_a3b_config"], num_hidden_layers=4, decoder_sparse_step=2)
    port = TConfig.from_hf_config(hf)
    jcfg = JConfig.from_hf_config(hf)
    assert [port.is_moe_layer(i) for i in range(4)] == [False, True, False, True]
    assert [jcfg.is_moe_layer(i) for i in range(4)] == [True, False, True, False]
    hf["mlp_only_layers"] = [3]  # no published checkpoint sets it: refused
    with pytest.raises(NotImplementedError, match="mlp_only_layers"):
        TConfig.from_hf_config(hf)


def test_c28_norm_topk_prob_default():
    """C28, HF's defaults where a config leaves a key out: without
    ``norm_topk_prob`` a qwen2_moe / qwen3_moe config keeps the top-k
    weights as they are (HF's default False; the JAX package renormalises
    them, its default True); without ``shared_expert_intermediate_size`` a
    qwen2_moe config has HF's shared expert of 5632 (the JAX package none).
    Mixtral always renormalises."""
    for preset in ("qwen1_5_moe_a2_7b_config", "qwen3_30b_a3b_config"):
        hf = {k: v for k, v in PUBLISHED[preset].items() if k != "norm_topk_prob"}
        assert TConfig.from_hf_config(hf).moe_norm_topk_prob is False
        assert JConfig.from_hf_config(hf).moe_norm_topk_prob is True
    hf = {k: v for k, v in PUBLISHED["qwen1_5_moe_a2_7b_config"].items()
          if k != "shared_expert_intermediate_size"}
    assert TConfig.from_hf_config(hf).num_shared_experts == 1
    assert JConfig.from_hf_config(hf).num_shared_experts == 0
    assert TConfig.from_hf_config(PUBLISHED["mixtral_8x7b_config"]).moe_norm_topk_prob


# ---- checkpoints: HF-written and JAX fake ----


def _redraw(model, seed, std=0.15):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            norm = "norm" in name
            p.copy_(1.0 + 0.1 * draw if norm and name.endswith("weight") else std * draw)
    return model


def write_hf_moe(path, form, seed=0):
    import transformers

    cls, kw = HF_FORMS[form]
    kw = dict(dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=256,
                   tie_word_embeddings=False, eos_token_id=2, bos_token_id=1,
                   pad_token_id=0), **kw)
    torch.manual_seed(0)
    model = getattr(transformers, cls + "ForCausalLM")(getattr(transformers, cls + "Config")(**kw))
    _redraw(model, seed).save_pretrained(path, safe_serialization=True)
    return path


def write_jax_moe(path, mt):
    over = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)
    if mt == "qwen2_moe":
        over["num_shared_experts"] = 1
    write_fake_checkpoint(path, tiny_config(mt, **over), seed=1, scale=0.15)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe"))
    out = {f"hf_{f}": write_hf_moe(os.path.join(root, f"hf_{f}"), f) for f in HF_FORMS}
    out.update({f"jax_{mt}": write_jax_moe(os.path.join(root, f"jax_{mt}"), mt)
                for mt in ("qwen2_moe", "qwen3_moe")})
    return out


def port_config(path):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path):
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def _rows(prompt):
    t = len(prompt)
    return dict(tokens=np.asarray([prompt], np.int32),
                positions=np.arange(t, dtype=np.int32)[None],
                block_tables=np.arange(1, 1 + -(-t // BS), dtype=np.int32)[None],
                kv_lens=np.asarray([t], np.int32), q_offsets=np.asarray([0], np.int32))


def port_logits(path, weights=None):
    cfg = port_config(path)
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(weights if weights is not None
                           else TLoader(cfg, device="cpu").load(path))
    inputs = ModelInputs(**{k: torch.from_numpy(v) for k, v in _rows(PROMPT).items()})
    out, _ = model.forward(w, model.init_cache(-(-len(PROMPT) // BS) + 2, BS, torch.float32),
                           inputs, need_all_logits=True)
    return out.all_logits.numpy()


def jax_logits(path):
    cfg = jax_config(path)
    model = create_model(cfg)
    inputs = JInputs(**{k: jnp.asarray(v) for k, v in _rows(PROMPT).items()})
    out, _ = model.forward(JLoader(cfg).load(path),
                           model.init_cache(-(-len(PROMPT) // BS) + 2, BS, jnp.float32),
                           inputs, need_all_logits=True)
    return np.asarray(out.all_logits).reshape(len(PROMPT), -1)


@pytest.mark.parametrize("form", sorted(HF_FORMS))
def test_hf_checkpoint_loads_and_meets_hf(ckpts, form):
    import transformers

    path = ckpts[f"hf_{form}"]
    cfg = port_config(path)
    assert cfg.num_experts == 8 and cfg.num_experts_per_tok == 2
    assert cfg.moe_intermediate_size == 32
    hf = getattr(transformers, HF_FORMS[form][0] + "ForCausalLM").from_pretrained(
        path, dtype=torch.float32).eval()
    with torch.no_grad():
        want = hf(torch.tensor([PROMPT])).logits[0].numpy()
    np.testing.assert_allclose(port_logits(path), want, **TOL)


@pytest.mark.parametrize("ckpt", ["hf_qwen2_moe", "hf_mixtral", "jax_qwen2_moe", "jax_qwen3_moe"])
def test_logits_meet_jax(ckpts, ckpt):
    """The JAX model on the same checkpoint (HF-written qwen3_moe has
    ``decoder_sparse_step`` 2, which the JAX package maps otherwise: C27)."""
    path = ckpts[ckpt]
    np.testing.assert_allclose(port_logits(path), jax_logits(path), **TOL)


def test_weights_are_the_jax_loaders(ckpts):
    """The expert stacks and the shared expert as the JAX loader gives them
    (``[L, E, H, I]`` / ``[L, E, I, H]``), gate and up fused by the model."""
    path = ckpts["hf_qwen2_moe"]
    tw = TLoader(port_config(path), device="cpu").load(path)
    jw = JLoader(jax_config(path)).load(path)
    for name in ("router", "moe_gate", "moe_up", "moe_down", "shared_gate", "shared_up",
                 "shared_down", "shared_expert_gate"):
        np.testing.assert_array_equal(tw[name].numpy(), np.asarray(jw[name]), err_msg=name)
    fused = LlamaFamilyModel(port_config(path), device="cpu").fuse_weights(tw)
    assert tuple(fused["moe_gate_up"].shape) == (2, 8, 64, 64)
    assert tuple(fused["shared_gate_up"].shape) == (2, 64, 96)


@pytest.mark.parametrize("ckpt", ["jax_qwen2_moe", "jax_qwen3_moe"])
def test_weights_from_jax_carry_the_stacks(ckpts, ckpt):
    """The JAX loader's parameters (numpy) carried over by
    ``convert.weights_from_jax`` equal the port loader's, expert stacks and
    shared expert included, and give the same logits."""
    from rtp_llm_tpu_torch.convert import weights_from_jax

    path = ckpts[ckpt]
    jw = JLoader(jax_config(path)).load(path)
    carried = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    own = TLoader(port_config(path), device="cpu").load(path)
    assert set(carried) == set(own)
    for name, t in own.items():
        torch.testing.assert_close(carried[name], t, rtol=0, atol=0, msg=name)
    np.testing.assert_array_equal(port_logits(path, carried), port_logits(path, own))


def test_dense_layers_keep_their_mlp(ckpts):
    """qwen3_moe with ``decoder_sparse_step`` 2: layers 0 and 2 keep a dense
    MLP (width 96) stacked apart, the experts sit on layer 1."""
    path = ckpts["hf_qwen3_moe"]
    cfg = port_config(path)
    tw = TLoader(cfg, device="cpu").load(path)
    assert tuple(tw["gate_proj"].shape) == (2, 64, 96)
    assert tuple(tw["moe_gate"].shape) == (1, 8, 64, 32)
    model = LlamaFamilyModel(cfg, device="cpu")
    assert model._moe_pos == {1: 0} and model._dense_pos == {0: 0, 2: 1}


def test_quantized_expert_stacks_raise(ckpts):
    path = ckpts["hf_qwen3_moe"]
    for method in ("int8", "int4", "fp8"):
        with pytest.raises(NotImplementedError, match="A11 step 1b"):
            TLoader(port_config(path), device="cpu",
                    transform=make_quant_transform(QuantConfig(method=method))).load(path)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    hf["quantization_config"] = {"quant_method": "gptq", "bits": 4, "group_size": 32}
    cfg = TConfig.from_hf_config(hf)
    with pytest.raises(NotImplementedError, match="A11 step 1b"):
        TLoader(cfg, device="cpu").load(path)
