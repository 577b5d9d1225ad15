"""LoRA in the port against the JAX package, on the CPU (tiny f32 model).

* The PEFT loader, the static merge, the registry's device pack and the
  per-layer dynamic delta equal the JAX module's (arrays exactly, the merge
  and the bf16 pack exactly, deltas to 1e-5).
* The plain ``lora_delta`` (the yardstick of kernel X4) against the JAX
  gather-and-einsum form, ids mixed over {0, X, Y}: within 1e-2 of the
  delta's spread (bf16 roundings of sums taken in another order).
* The port's forward with adapter stacks against the JAX forward (which
  unfuses its linears): logits within 1e-3.
* Engines: greedy tokens of requests mixing X, Y and no adapter equal the
  JAX dynamic engine's at ``decode_steps`` 1 / 4 x async off / on, in
  packed prefill groups and alone; with a static merge of X; on int4 and
  int8 bases; under prompt lookup.
* ``/v1/loras`` GET / POST / DELETE and the 400 of an unknown adapter.
* The reference's faults F2 (the prefix cache lends blocks across
  adapters) and F3 (``update_weights`` drops the adapter stacks), each
  shown on the JAX engine and repaired in the port (ROADMAP.md, section C).
"""

import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import QuantConfig as JQuant
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.lora import LoraManager as JLoraManager
from rtp_llm_tpu.lora import load_peft_adapter as jload
from rtp_llm_tpu.lora import merge_lora as jmerge
from rtp_llm_tpu.lora.lora import apply_dynamic_lora as japply
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.quant import make_quant_transform as j_transform
from rtp_llm_tpu.server.engine_runner import EngineRunner as JRunner
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.frontend.openai_api import build_app
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.lora import LoraManager, apply_dynamic_lora, load_peft_adapter, merge_lora
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from rtp_llm_tpu_torch.models.batch import ModelInputs
from rtp_llm_tpu_torch.ops import lora as lora_ops
from rtp_llm_tpu_torch.quant import make_quant_transform
from rtp_llm_tpu_torch.server.engine_runner import EngineRunner

BS, NB, BATCH, MSL = 4, 96, 4, 128
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the tiny qwen2's (in, out) of each target: hidden 64, 4 / 2 heads of 16,
# intermediate 128
DIMS = {"q_proj": (64, 64), "k_proj": (64, 32), "v_proj": (64, 32), "o_proj": (64, 64),
        "gate_proj": (64, 128), "up_proj": (64, 128), "down_proj": (128, 64)}
PROMPTS = [[1, 5, 9, 42], [7, 7, 1, 2, 3], [11, 3, 4, 90, 2, 6], [60, 61]]


def write_fake_adapter(path, num_layers=2, rank=4, alpha=8, targets=TARGETS, seed=0,
                       scale=0.3, dims=None):
    """A PEFT adapter directory (``adapter_config.json`` and
    ``adapter_model.safetensors``) with A and B drawn from ``seed``; the
    writer of ``tests/test_lora.py`` with each target's in and out dims."""
    from safetensors.numpy import save_file

    dims = dims or DIMS
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha, "target_modules": list(targets)}, f)
    rng = np.random.default_rng(seed)
    tensors = {}
    attn = {"q_proj", "k_proj", "v_proj", "o_proj"}
    for layer in range(num_layers):
        for t in targets:
            mod = "self_attn" if t in attn else "mlp"
            base = f"base_model.model.model.layers.{layer}.{mod}.{t}"
            i, o = dims[t]
            tensors[f"{base}.lora_A.weight"] = (rng.standard_normal((rank, i)) * scale
                                                ).astype(np.float32)
            tensors[f"{base}.lora_B.weight"] = (rng.standard_normal((o, rank)) * scale
                                                ).astype(np.float32)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("lora_m")), tiny_config("qwen2"))


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Paths of adapters X (rank 4, all seven targets) and Y (rank 8, q, v,
    up and down)."""
    root = tmp_path_factory.mktemp("lora_ad")
    return {"X": write_fake_adapter(str(root / "x"), seed=1),
            "Y": write_fake_adapter(str(root / "y"), rank=8, alpha=8, seed=2,
                                    targets=("q_proj", "v_proj", "up_proj", "down_proj"))}


def _port_weights(ckpt, transform=None):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    return CheckpointLoader(cfg, device="cpu", transform=transform).load(ckpt)


def _greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


def _port(ckpt, steps=1, asy=True, weights=None, transform=None, spec=None, prefix=True):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL,
                                  prefill_buckets=(16, 64), decode_steps=steps,
                                  async_decode=asy),
        quant=QuantConfig(kv_cache_dtype="float32"),
        speculative=spec or SpeculativeConfig())
    if weights is None:
        weights = CheckpointLoader(cfg, device="cpu", transform=transform).load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def _jax(ckpt, steps=1, asy=True, weights=None, transform=None, prefix=True):
    cfg = tiny_config("qwen2", dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy))
    econf.quant.kv_cache_dtype = "float32"
    if weights is None:
        weights = JLoader(cfg, transform=transform).load(ckpt)
    return JEngine(create_model(cfg), weights, econf)


def _with_adapters(engine, mgr_cls, adapters, names=("X", "Y")):
    mgr = mgr_cls(2)
    for name in names:
        mgr.add_adapter(adapters[name], name=name)
    engine.set_lora_manager(mgr)
    return engine


def _run(engine, reqs, gen_cls, steps=300):
    streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return [s.output_token_ids for s in streams]


MIXED = [(PROMPTS[0], _greedy(9, adapter_name="X")), (PROMPTS[1], _greedy(7)),
         (PROMPTS[2], _greedy(8, adapter_name="Y")), (PROMPTS[3], _greedy(6, adapter_name="X"))]


# ---- the module --------------------------------------------------------------


def test_loaded_arrays_merge_and_pack_equal_jax(ckpt, adapters):
    """Each adapter's A / B arrays, its static merge into the f32 weights
    and the registry's bf16 stacks equal the JAX module's."""
    for name, path in adapters.items():
        got, want = load_peft_adapter(path, 2), jload(path, 2)
        assert (got.rank, got.alpha, got.scale) == (want.rank, want.alpha, want.scale)
        assert sorted(got.a) == sorted(want.a) and sorted(got.b) == sorted(want.b)
        for t in got.a:
            np.testing.assert_array_equal(got.a[t].numpy(), want.a[t])
            np.testing.assert_array_equal(got.b[t].numpy(), want.b[t])
    cfg = tiny_config("qwen2", dtype="float32")
    jw = JLoader(cfg).load(ckpt)
    tw = _port_weights(ckpt)
    merged, jmerged = merge_lora(tw, load_peft_adapter(adapters["X"], 2)), jmerge(
        jw, jload(adapters["X"], 2))
    for t in TARGETS:
        np.testing.assert_allclose(merged[t].numpy(), np.asarray(jmerged[t]), rtol=0, atol=1e-6)
    assert torch.equal(merged["embed_tokens"], tw["embed_tokens"])
    mgr, jmgr = LoraManager(2), JLoraManager(2)
    for name, path in adapters.items():
        assert mgr.add_adapter(path, name=name) == jmgr.add_adapter(path, name=name)
    mgr.remove_adapter("X")
    jmgr.remove_adapter("X")
    pack, jpack = mgr.device_pack(), jmgr.device_pack()
    assert sorted(pack) == sorted(jpack) and mgr.names() == jmgr.names() == ["Y"]
    for k in pack:
        np.testing.assert_array_equal(pack[k].float().numpy(),
                                      np.asarray(jpack[k]).astype(np.float32))
    assert mgr.adapter_id("Y") == jmgr.adapter_id("Y") == 2  # X's id stays reserved
    with pytest.raises(KeyError):
        mgr.adapter_id("X")


def test_dynamic_delta_equals_merged_and_jax(ckpt, adapters):
    """``x @ W + apply_dynamic_lora`` equals ``x @ merged W`` and the JAX
    delta (f32, summed in another order: within 1e-5)."""
    ad, jad = load_peft_adapter(adapters["X"], 2), jload(adapters["X"], 2)
    tw = _port_weights(ckpt)
    merged = merge_lora(tw, ad)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32))
    for t in ("q_proj", "gate_proj"):
        dyn = x @ tw[t][1] + apply_dynamic_lora(x, t, 1, ad)
        np.testing.assert_allclose(dyn.numpy(), (x @ merged[t][1]).numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(apply_dynamic_lora(x, t, 1, ad).numpy(),
                                   np.asarray(japply(jnp.asarray(x.numpy()), t, 1, jad)),
                                   rtol=0, atol=1e-5)


def test_merge_refuses_a_quantized_base(ckpt, adapters):
    tw = _port_weights(ckpt, make_quant_transform(QuantConfig(method="int8")))
    with pytest.raises(ValueError, match="quantized"):
        merge_lora(tw, load_peft_adapter(adapters["X"], 2))


@pytest.mark.parametrize("n", [5, 64])
def test_plain_lora_delta_matches_the_jax_einsums(n):
    """The plain version of X4 (gather, f32 shrink, bf16 delta) against the
    JAX branch's gather and einsums, ids mixed over {0, 1, 2}; id 0 rows
    stay exactly as they were."""
    rng = np.random.default_rng(n)
    k, r, out, layers = 96, 16, 40, 3
    a = rng.standard_normal((3, layers, k, r)).astype(np.float32) * 0.2
    b = rng.standard_normal((3, layers, r, out)).astype(np.float32) * 0.2
    a[0] = b[0] = 0
    x = rng.standard_normal((n, k)).astype(np.float32)
    y0 = rng.standard_normal((n, out)).astype(np.float32)
    ids = rng.integers(0, 3, n).astype(np.int32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    am, bm = ja[jnp.asarray(ids), 1], jb[jnp.asarray(ids), 1]
    xa = jnp.einsum("bth,bhr->btr", jnp.asarray(x)[:, None].astype(am.dtype), am)
    want = np.asarray(jnp.asarray(y0)[:, None] + jnp.einsum("btr,bro->bto", xa, bm).astype(
        jnp.float32))[:, 0]
    ta, tb = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    got = lora_ops.lora_delta(torch.from_numpy(x), torch.from_numpy(y0.copy()), ta, [(tb, out)],
                              torch.from_numpy(ids), 1).numpy()
    spread = np.abs(want - y0).max()
    assert np.abs(got - want).max() <= 1e-2 * spread
    np.testing.assert_array_equal(got[ids == 0], y0[ids == 0])


def _packed_forward_inputs():
    toks = [[1, 5, 9, 42, 7], [3, 4, 11], [60, 61, 62, 63, 64, 65]]
    return toks, [1, 0, 2]


def test_forward_with_adapters_matches_jax(ckpt, adapters):
    """A padded prefill of three rows with adapters X, none and Y: the
    port's fused forward (``fuse_lora``'s stacks) against the JAX forward on
    its unfused weights and pack."""
    _forward_against_jax(ckpt, adapters)


def _forward_against_jax(ckpt, adapters):
    toks, ids = _packed_forward_inputs()
    t = max(len(r) for r in toks)
    tok = np.zeros((3, t), np.int32)
    pos = np.zeros((3, t), np.int32)
    for i, r in enumerate(toks):
        tok[i, : len(r)] = r
        pos[i, : len(r)] = np.arange(len(r))
    bt = np.arange(1, 1 + 3 * 4, dtype=np.int32).reshape(3, 4)
    lens = np.array([len(r) for r in toks], np.int32)
    cfg = tiny_config("qwen2", dtype="float32")
    jmodel = create_model(cfg)
    jmgr = JLoraManager(2)
    mgr = LoraManager(2)
    for name in ("X", "Y"):
        jmgr.add_adapter(adapters[name], name=name)
        mgr.add_adapter(adapters[name], name=name)
    jw = dict(JLoader(cfg).load(ckpt))
    jw.update(jmgr.device_pack())
    jin = JInputs(jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(lens),
                  jnp.zeros(3, jnp.int32), adapter_ids=jnp.asarray(ids, jnp.int32))
    jout, _ = jmodel.forward(jw, jmodel.init_cache(16, BS, jnp.float32), jin)
    model = LlamaFamilyModel(TConfig.from_pretrained(ckpt), device="cpu")
    model.cfg.dtype = "float32"
    tw = model.fuse_weights(_port_weights(ckpt))
    tw.update(model.fuse_lora(mgr.device_pack()))
    tin = ModelInputs(torch.from_numpy(tok), torch.from_numpy(pos), torch.from_numpy(bt),
                      torch.from_numpy(lens), torch.zeros(3, dtype=torch.int32),
                      adapter_ids=torch.tensor(ids))
    out, _ = model.forward(tw, model.init_cache(16, BS, torch.float32), tin)
    want, got = np.asarray(jout.logits), out.logits.numpy()
    base, _ = model.forward({k: v for k, v in tw.items() if ".lora_" not in k},
                            model.init_cache(16, BS, torch.float32), tin)
    # the adapters move the logits clearly, the two forwards agree within
    # 1e-3, and the row without an adapter does not move at all
    assert np.abs(base.logits.numpy() - want).max() > 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(base.logits.numpy()[1], got[1])
    return tw


def test_rank_64_adapter_on_all_seven_targets_passes_the_kernel_checks(ckpt, adapters,
                                                                      tmp_path):
    """An r = 64 adapter on all seven targets (with Y, r = 8 on four): the
    fused stacks pass the checks the CUDA wrappers make before a launch
    (q | k | v join to R = 192, served in two chunks of 96 ranks), and the
    forward still equals the JAX forward."""
    x64 = write_fake_adapter(str(tmp_path / "x64"), rank=64, alpha=64, seed=5, scale=0.1)
    tw = _forward_against_jax(ckpt, {"X": x64, "Y": adapters["Y"]})
    model = LlamaFamilyModel(TConfig.from_pretrained(ckpt), device="cpu")
    ranks = {}
    for fused, members in model.lora_members.items():
        a = tw[fused + ".lora_a"]
        lora_ops.check_stacks(a, [(tw.get(m + ".lora_b"), o) for m, o in members])
        ranks[fused] = (a.shape[-1], lora_ops.shrink_chunk(a.shape[-1]))
    assert ranks == {"qkv_proj": (192, 12), "o_proj": (64, 8), "gate_up_proj": (128, 16),
                     "down_proj": (64, 8)}


def _emulate_shrink(x, A, seg, layer, plan):
    """The shrink kernel's arithmetic over the segment record: a block a
    (tile, split of ``in`` in k-tiles, chunk of 8 NT ranks), the tile's x
    rows gathered through perm; the splits' f32 partials added in split
    order and rounded once to bf16; t's rows of id 0 zero, and a row no
    tile covers left NaN."""
    _, _, k, r = A.shape
    nt, splits = plan
    k_tiles = -(-k // lora_ops.K_TILE)
    per = -(-k_tiles // splits)
    assert (splits - 1) * per < k_tiles  # no split is empty
    t = torch.full((x.shape[0], r), float("nan"))
    t[seg.perm[: int(seg.offsets[1])].long()] = 0
    xb = x.to(torch.bfloat16).float()
    for aid, first, count, _ in seg.tiles.tolist():
        if count == 0:
            continue
        rows = seg.perm[first: first + count].long()
        for c0 in range(0, r, 8 * nt):
            cols = slice(c0, min(r, c0 + 8 * nt))
            s = torch.zeros((count, cols.stop - c0))
            for sp in range(splits):
                ks = slice(sp * per * lora_ops.K_TILE, min(k, (sp + 1) * per * lora_ops.K_TILE))
                s = s + xb[rows, ks] @ A[aid, layer, ks, cols].float()
            t[rows, cols] = s.to(torch.bfloat16).float()
    return t


def _emulate_expand(t, members, seg, layer, y):
    """The expand kernel's arithmetic: a block a (tile, 128-column tile of
    one present member), t's member segment (r times the members present
    before it) read as bf16, the delta rounded to bf16 and added to y; rows
    in no tile and members without B untouched."""
    r, col1, col2 = lora_ops.expand_layout(members, y.shape[1])
    bounds = [0, col1, col2, y.shape[1]]
    present = [(b, bounds[j], bounds[j + 1] - bounds[j]) for j, (b, _) in enumerate(members)
               if b is not None]
    for aid, first, count, _ in seg.tiles.tolist():
        if count == 0:
            continue
        rows = seg.perm[first: first + count].long()
        for p, (b, start, width) in enumerate(present):
            tt = t[rows, p * r: (p + 1) * r].to(torch.bfloat16).float()
            for col0 in range(0, width, 128):
                cols = slice(col0, min(width, col0 + 128))
                d = (tt @ b[aid, layer, :, cols].float()).to(torch.bfloat16).float()
                ys = slice(start + cols.start, start + cols.stop)
                y[rows, ys] = (y[rows, ys].float() + d).to(y.dtype)
    return y


@pytest.mark.parametrize("rank,widths,absent", [
    (4, (64, 32, 32), ()), (16, (64, 32, 32), (1,)), (64, (128, 128), ()),
    (64, (64,), ()), (24, (32, 16, 16), (0, 2))])
def test_kernel_emulation_matches_the_plain_version(rank, widths, absent):
    """A blocked emulation of X4's index arithmetic (the segment record's
    tiles, the shrink's plan: splits of ``in`` and rank chunks, the expand's
    member column tiles and t segments) against the plain version, ids
    mixed over {0, 1, 2}, members left out included: equal to the last
    bf16 rounding of sums taken in another order."""
    gen = torch.Generator().manual_seed(rank + len(widths))
    n, k, layers = 9, 304, 2
    present = [j for j in range(len(widths)) if j not in absent]
    big_r = len(present) * rank
    big_r += -big_r % lora_ops.R_MULTIPLE
    a = (torch.randn((3, layers, k, big_r), generator=gen) * 0.3).to(torch.bfloat16)
    a[0] = 0
    members = []
    for j, o in enumerate(widths):
        b = None
        if j in present:
            b = (torch.randn((3, layers, rank, o), generator=gen) * 0.3).to(torch.bfloat16)
            b[0] = 0
        members.append((b, o))
    lora_ops.check_stacks(a, members)
    x = torch.randn((n, k), generator=gen)
    y0 = torch.randn((n, sum(widths)), generator=gen).to(torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1, 0], dtype=torch.int32)
    seg = lora_ops.lora_segments(ids, 3)
    plan = lora_ops.shrink_plan(n, k, big_r)
    assert plan[1] == 3  # three k-tiles of 128 (the last ragged), one a split
    t_ref = lora_ops.lora_shrink_ref(x, a, ids, 1)
    t_emu = _emulate_shrink(x, a, seg, 1, plan)
    torch.testing.assert_close(t_emu, t_ref, rtol=1e-2, atol=1e-2)
    y_ref = lora_ops.lora_expand_ref(t_ref, members, ids, 1, y0.clone())
    y_emu = _emulate_expand(t_ref, members, seg, 1, y0.clone())
    torch.testing.assert_close(y_emu.float(), y_ref.float(), rtol=1e-2, atol=2e-2)
    assert torch.equal(y_emu[ids == 0], y0[ids == 0])
    for j in absent:
        cols = slice(sum(widths[:j]), sum(widths[: j + 1]))
        assert torch.equal(y_ref[:, cols], y0[:, cols])


@pytest.mark.parametrize("rank,widths", [(12, (64, 32, 32)), (8, (60, 4)), (8, (8,) * 4)])
def test_the_kernel_checks_refuse_what_it_does_not_take(rank, widths):
    """A rank that is not a multiple of 8, member widths that are not, and
    more than three members are refused before a launch."""
    a = torch.zeros((2, 1, 8, rank), dtype=torch.bfloat16)
    members = [(torch.zeros((2, 1, 8, o), dtype=torch.bfloat16), o) for o in widths]
    with pytest.raises(ValueError):
        lora_ops.check_stacks(a, members)


# ---- engines -----------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_pairs(ckpt, adapters):
    """(JAX engine, port engine) with X and Y registered, by (steps, async),
    built once for the module."""
    cache = {}

    def get(steps=1, asy=True):
        if (steps, asy) not in cache:
            cache[steps, asy] = (_with_adapters(_jax(ckpt, steps, asy), JLoraManager, adapters),
                                 _with_adapters(_port(ckpt, steps, asy), LoraManager, adapters))
        return cache[steps, asy]
    return get


@pytest.mark.parametrize("steps,asy", [(1, True), (1, False), (4, True), (4, False)],
                         ids=["n1-async", "n1-sync", "n4-async", "n4-sync"])
def test_mixed_adapters_match_the_jax_engine(engine_pairs, steps, asy):
    """Four requests at once, mixing X, Y and no adapter (one packed
    prefill group, then graphed-form decode windows): tokens equal the JAX
    dynamic engine's, and the adapters change them."""
    je, te = engine_pairs(steps, asy)
    got = _run(te, MIXED, GenerateConfig)
    assert got == _run(je, MIXED, JGen)
    base = _run(te, [(p, {k: v for k, v in kw.items() if k != "adapter_name"})
                     for p, kw in MIXED], GenerateConfig)
    assert got[1] == base[1] and got[0] != base[0] and got[2] != base[2]
    assert sorted(te._free_slots) == list(range(BATCH))


def test_mixed_batch_equals_each_request_alone(engine_pairs):
    _, te = engine_pairs(1, True)
    together = _run(te, MIXED, GenerateConfig)
    alone = [_run(te, [req], GenerateConfig)[0] for req in MIXED]
    assert together == alone


def test_dynamic_adapter_equals_a_merged_engine(ckpt, adapters, engine_pairs):
    """X served dynamically gives the tokens of an engine with X merged at
    load (``server.lora_adapters``), its prompt loss within 1% and its
    hidden states within 10% (relative L2 norm; 0.4-8% a position,
    measured): the dynamic path holds A and B in bf16 and rounds ``x @ A``
    and the delta to bf16, the merge is f32. The teacher-forced loop's
    hidden states equal one forward's over the same tokens with X."""
    from rtp_llm_tpu_torch.server.server import build_engine

    conf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64)),
        quant=QuantConfig(kv_cache_dtype="float32"))
    conf.server.lora_adapters = f"X={adapters['X']}"
    merged = build_engine(ckpt, conf, device="cpu", dtype="float32")
    _, te = engine_pairs(1, True)
    reqs = [(PROMPTS[0], _greedy(9)), (PROMPTS[2], _greedy(8))]
    want = _run(merged, reqs, GenerateConfig)
    assert _run(te, [(p, dict(kw, adapter_name="X")) for p, kw in reqs], GenerateConfig) == want
    prompt = PROMPTS[2] + [7, 8, 9]
    np.testing.assert_allclose(te.compute_prompt_loss(prompt, adapter_name="X").numpy(),
                               merged.compute_prompt_loss(prompt).numpy(), rtol=1e-2, atol=0)
    s, hidden = te.generate_with_hidden(PROMPTS[0], GenerateConfig(**_greedy(4, adapter_name="X")))
    ms, mhidden = merged.generate_with_hidden(PROMPTS[0], GenerateConfig(**_greedy(4)))
    assert s.output_token_ids == ms.output_token_ids
    assert np.linalg.norm(hidden.numpy() - mhidden.numpy()) <= 0.1 * np.linalg.norm(
        mhidden.numpy())
    # the loop's rows are those of one forward over the whole sequence with X
    seq = PROMPTS[0] + s.output_token_ids[:-1]
    mb = te.max_blocks_per_seq
    inputs = te._prefill_inputs([(seq, 0)], torch.arange(1, mb + 1, dtype=torch.int32)[None],
                                [te._lora_entry("X")[0]])
    out, _ = te.model.forward(te.weights, te.model.init_cache(mb + 1, BS, torch.float32),
                              inputs, need_all_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), out.all_hidden[len(PROMPTS[0]) - 1:].numpy(),
                               rtol=0, atol=1e-4)


def test_unknown_adapter_is_refused(engine_pairs):
    _, te = engine_pairs(1, True)
    s = te.enqueue([1, 2, 3], GenerateConfig(**_greedy(3, adapter_name="nope")))
    assert s.is_finished() and "unknown LoRA adapter" in s.error
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        te.compute_prompt_loss([1, 2, 3], adapter_name="nope")


def test_adapter_stream_under_prompt_lookup(ckpt, adapters):
    """A speculative engine (prompt lookup) serves adapter streams with the
    tokens of the normal engine: the verify window reads the slots'
    adapter ids."""
    spec = _with_adapters(_port(ckpt, spec=SpeculativeConfig(method="prompt_lookup",
                                                             draft_tokens=3)),
                          LoraManager, adapters)
    normal = _with_adapters(_port(ckpt), LoraManager, adapters)
    reqs = [([1, 2, 3, 1, 2, 3, 1, 2], _greedy(10, adapter_name="X")),
            ([5, 6, 5, 6, 5, 6], _greedy(9)), ([9, 8, 9, 8, 9], _greedy(8, adapter_name="Y"))]
    assert _run(spec, reqs, GenerateConfig) == _run(normal, reqs, GenerateConfig)
    assert spec.spec_stats["steps"] > 0


def _near_tie(te, prompt, tokens, adapter_name, tol=1 / 64):
    """The first step of ``tokens`` whose choice was a near tie in the
    port's teacher-forced logits (top-2 gap at most ``tol``, two bf16 ulps
    at 1.0), or len(tokens)."""
    seq = prompt + tokens[:-1]
    mb = te.max_blocks_per_seq
    inputs = te._prefill_inputs([(seq, 0)], torch.arange(1, mb + 1, dtype=torch.int32)[None],
                                [te._lora_entry(adapter_name)[0]])
    out, _ = te.model.forward(te.weights, te.model.init_cache(mb + 1, BS, torch.float32),
                              inputs, need_all_logits=True)
    top2 = out.all_logits[len(prompt) - 1:].topk(2, dim=-1).values
    ties = ((top2[:, 0] - top2[:, 1]) <= tol).nonzero()
    return int(ties[0]) if len(ties) else len(tokens)


@pytest.mark.parametrize("method", ["int8", "int4"])
def test_quantized_base_with_adapters_matches_the_jax_engine(ckpt, adapters, method):
    """Dynamic adapters over a base quantized at load (bf16 activations):
    each request's tokens equal the JAX dynamic engine's up to its first
    near tie (a top-2 gap of two bf16 ulps or less in the port's
    teacher-forced logits), the tie's own step included only when the two
    agree there. The logits of this tiny model are bf16 values near 1,
    where ties are common; the JAX engine's packed prefill and its plain
    forward already differ by an ulp at such a step."""
    kw = {"group_size": 32} if method == "int4" else {}
    je = _with_adapters(_jax(ckpt, transform=j_transform(JQuant(method=method, **kw))),
                        JLoraManager, adapters)
    te = _with_adapters(_port(ckpt, transform=make_quant_transform(
        QuantConfig(method=method, **kw))), LoraManager, adapters)
    got, want = _run(te, MIXED, GenerateConfig), _run(je, MIXED, JGen)
    compared = 0
    for (p, kw_), g, w in zip(MIXED, got, want):
        k = _near_tie(te, p, g, kw_.get("adapter_name"))
        assert g[:k] == w[:k]
        compared += k
    assert compared >= 8  # of the 30 tokens
    assert got[1] == want[1]  # the request without an adapter


# ---- the reference's faults, repaired ------------------------------------------


def test_f2_the_prefix_cache_keeps_adapters_apart(ckpt, adapters):
    """F2: a prompt served under X, then the same prompt under no adapter.
    The JAX engine reuses X's blocks for the second request, whose tokens
    then differ from a fresh engine's; the port's reuse none and equal
    them."""
    prompt = list(range(20, 37))  # 17 tokens: four full blocks to share
    fresh = _run(_port(ckpt), [(prompt, _greedy(6))], GenerateConfig)[0]
    jfresh = _run(_jax(ckpt), [(prompt, _greedy(6))], JGen)[0]
    assert fresh == jfresh
    je = _with_adapters(_jax(ckpt), JLoraManager, adapters)
    te = _with_adapters(_port(ckpt), LoraManager, adapters)
    for engine, gen in ((je, JGen), (te, GenerateConfig)):
        _run(engine, [(prompt, _greedy(6, adapter_name="X"))], gen)
    js = je.enqueue(prompt, JGen(**_greedy(6)))
    ts = te.enqueue(prompt, GenerateConfig(**_greedy(6)))
    while je.has_work():
        je.step()
    while te.has_work():
        te.step()
    assert js.reuse_len == 16 and js.output_token_ids != jfresh  # the fault
    assert ts.reuse_len == 0 and ts.output_token_ids == fresh
    # the same adapter still reuses its own blocks
    again = te.enqueue(prompt, GenerateConfig(**_greedy(6, adapter_name="X")))
    while te.has_work():
        te.step()
    assert again.reuse_len == 16


def test_f3_update_weights_keeps_the_adapters(ckpt, adapters, tmp_path):
    """F3: after ``update_weights`` to checkpoint B, an X request of the
    JAX runner runs the base model (its rebinding drops the stacks); the
    port's keeps X and equals an engine loaded from B with X merged."""
    new = write_fake_checkpoint(str(tmp_path / "b"), tiny_config("qwen2"), seed=5)
    req = [(PROMPTS[0], _greedy(8, adapter_name="X"))]
    base_req = [(PROMPTS[0], _greedy(8))]
    je = _with_adapters(_jax(ckpt, prefix=False), JLoraManager, adapters)
    JRunner(je).update_weights(new)
    jgot = _run(je, req, JGen)
    assert jgot == _run(je, base_req, JGen)  # the fault: X is gone
    te = _with_adapters(_port(ckpt, prefix=False), LoraManager, adapters)
    EngineRunner(te).update_weights(new)
    tw = CheckpointLoader(te.model.cfg, device="cpu").load(new)
    merged = _port(new, weights=merge_lora(tw, load_peft_adapter(adapters["X"], 2)),
                   prefix=False)
    got = _run(te, req, GenerateConfig)
    assert got == _run(merged, base_req, GenerateConfig)
    assert got != _run(te, base_req, GenerateConfig)


# ---- HTTP ----------------------------------------------------------------------


def _call(base, method, route, body=None):
    req = urllib.request.Request(base + route, method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_loras_route_get_post_delete(ckpt, adapters):
    """``/v1/loras`` as the JAX route answers: GET lists, POST adds (400
    without a path or with a bad one), DELETE removes (404 for an unknown
    name); a request naming a removed or unknown adapter answers 400, and
    one naming a live adapter 200 with its tokens."""
    app = build_app(_port(ckpt), None)
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    try:
        assert _call(base, "GET", "/v1/loras") == (200, {"adapters": []})
        assert _call(base, "POST", "/v1/loras", {"name": "X"})[0] == 400
        assert _call(base, "POST", "/v1/loras", {"name": "Z", "path": "/nonexistent"})[0] == 400
        for name in ("X", "Y"):
            assert _call(base, "POST", "/v1/loras", {"name": name, "path": adapters[name]}) == (
                200, {"status": "added", "name": name})
        assert _call(base, "GET", "/v1/loras") == (200, {"adapters": ["X", "Y"]})
        body = {"prompt": PROMPTS[0], "max_tokens": 9, "temperature": 0, "ignore_eos": True}
        status, out = _call(base, "POST", "/v1/completions", dict(body, adapter_name="X"))
        want = _run(_with_adapters(_port(ckpt), LoraManager, adapters),
                    [(PROMPTS[0], _greedy(9, adapter_name="X"))], GenerateConfig)[0]
        assert status == 200 and out["choices"][0]["token_ids"] == want
        assert _call(base, "DELETE", "/v1/loras", {"name": "Y"}) == (
            200, {"status": "removed", "name": "Y"})
        assert _call(base, "DELETE", "/v1/loras", {"name": "Y"})[0] == 404
        assert _call(base, "GET", "/v1/loras") == (200, {"adapters": ["X"]})
        for name in ("Y", "nope"):
            status, out = _call(base, "POST", "/v1/completions", dict(body, adapter_name=name))
            assert status == 400 and "unknown LoRA adapter" in out["error"]["message"]
    finally:
        app.stop()
