"""Dense decoder-only transformer forward (llama architecture family).

Port of ``rtp_llm_tpu/models/llama_family.py`` for the dense trunk: llama,
qwen2 (qkv bias), qwen3 (per-head q/k RMSNorm), mistral and phi3 (a sliding
window), yi, internlm (attention and o_proj biases) and internlm2 (their
checkpoints' layouts are the loader's business), gemma (GeGLU, embeddings
scaled by sqrt(H), ``1 + w`` norms folded at load) and gemma2 (also
sandwich norms, attention and final-logit soft-caps, its own query scale and
a window on the even layers, whose K/V live in per-slot rings: split pools),
cohere (weight-only LayerNorms, one norm feeding attention and MLP in
parallel, GPT-J pair RoPE, scaled logits, per-head q / k LayerNorms) and
starcoder2 (biased LayerNorms and linears, a non-gated gelu-tanh MLP, a
window on every layer) and the ALiBi families, baichuan-13B, bloom (also a
LayerNorm on the embeddings, ``embed_norm``), mpt and falcon (no RoPE: each
head's slope times the distance to the query, ``alibi_slopes``, added to
its scores by the attention kernels), and the multi-query families:
gpt_bigcode (StarCoder: learned absolute positions, ``pos_embed``, added to
the embeddings instead of RoPE; one kv head under 48 query heads) and
falcon's multi-query and new-decoder forms (71 query heads on one kv head;
groups of 16 with ``ln_attn`` / ``ln_mlp``, ``parallel_norms`` "dual"), and
the partial-rotary families, whose RoPE turns only the first ``rotary_dim``
dims of a head: glm4 (GPT-J pairs over half the head, gemma2's sandwich norms
under glm's names), chatglm (the same RoPE), gpt_neox (neox halves over a
quarter, the "dual" parallel residual or the sequential one), phi (neox
halves, one LayerNorm feeding the parallel attention and MLP, a biased LM
head: ``lm_head.bias``) and qwen v1 (full-head RoPE), and the
mixture-of-experts trunks qwen2_moe / qwen3_moe / mixtral (``_moe_mlp``: the
sparse layers route each token row to its top-k experts, ``ops/moe.py``,
qwen2_moe adds a gated shared expert; layers ``is_moe_layer`` leaves dense
keep their MLP, each kind indexed in its own stacks), with
bf16 or f32 weights,
4-bit linears (split-half packed int4 with or without GPTQ/AWQ zero points,
or fp4) that run through ``ops/quant_gemm.groupwise_matmul_packed`` (GPTQ
act-order ones after a gather of their input, ``name.act_perm``), or
8-bit ones (int8 / fp8 weight-only, W8A8, W4A8, GPTQ values that do not
pack) that run through ``ops/quant_gemm8``; the LM head may be int8.
Any linear may add each token row's LoRA adapter delta (``ops/lora.py``,
from stacks that ``fuse_lora`` lays out for the fused linears; the rows are
grouped by adapter once a forward, ``lora_segments``).
Like the JAX model it is a function over a canonical weight dict (stacked
``[L, in, out]`` linears, ``y = x @ W``) with the paged KV cache threaded
through; the JAX ``lax.scan`` over layers is a Python loop, and the cache is
updated in place.

Layer structure (pre-norm; each norm by ``norm_type``, a biased LayerNorm
where the site's ``<name>.bias`` is loaded; any linear adds its loaded
``<name>.bias``):
  x -> norm -> attn(paged KV) -> +res -> norm -> mlp -> +res
gemma2 (sandwich norms):
  x -> rms_norm -> attn -> rms_norm -> +res -> rms_norm -> mlp -> rms_norm -> +res
glm4 (sandwich norms under glm's names, no ``1 + w``): as gemma2
cohere, falcon's parallel form and phi (parallel residual):
  x -> norm -> (attn, mlp) -> res + attn + mlp
falcon's new decoder and gpt_neox (``parallel_norms`` "dual"): attn and mlp
each take their own norm of x:
  res + attn(ln_attn(x)) + mlp(ln_mlp(x))
bloom: x = norm(embed(tokens)) before the first layer

Longrope (Phi-3's 128k configs) keeps two RoPE tables, the long one's rows
after the short one's: a token row reads the long rows when its stream's
``rope_lens`` (default ``kv_lens``: its last position in the forward + 1)
passes ``rope_switch``, computed on the device, so a captured decode graph
switches at the right step.

Split pools (gemma2: ``sliding_window`` with ``sliding_window_pattern``,
JAX ``swa_split``): the global layers keep the paged pool; each sliding
layer keeps one ring a decode slot of ``swa_nring = ceil((window + span) /
block_size) + 1`` blocks (``span``: the largest prefill chunk, set by the
engine as ``swa_prefill_span``), addressed through the ring table ``slot *
swa_nring + column % swa_nring``. Only the last ``(swa_nring - 1) *
block_size`` positions of a forward's rows are written: they cover the
window behind every query of the chunk and map to distinct ring slots. The
ring pool ends in one more block, its null block, where dropped writes go
(the paged pool's null block is block 0; a ring pool's first slot is decode
slot 0's).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from rtp_llm_tpu_torch.config.model_config import ModelConfig
from rtp_llm_tpu_torch.device import resolve_device
from rtp_llm_tpu_torch.models.batch import ModelInputs, ModelOutputs, packed_index
from rtp_llm_tpu_torch.ops.activations import ACT, ACT_AND_MUL
from rtp_llm_tpu_torch.ops.attention import paged_attention
from rtp_llm_tpu_torch.ops.kv_cache import (
    FP8, SplitPool, token_slots, write_kv, write_kv_quant,
)
from rtp_llm_tpu_torch.ops.lora import R_MULTIPLE, check_stacks, lora_delta, lora_segments
from rtp_llm_tpu_torch.ops.moe import fused_moe, route
from rtp_llm_tpu_torch.ops.norms import NORMS, layer_norm, rms_norm
from rtp_llm_tpu_torch.ops.quant_gemm import groupwise_matmul_packed
from rtp_llm_tpu_torch.ops.quant_gemm8 import w4a8_matmul, w8_matmul, w8a8_matmul
from rtp_llm_tpu_torch.ops.rope import (
    compute_rope_freqs, rope_at, rope_switch, rotate, rotate_pairs, rotate_pairs_partial,
    rotate_partial,
)

# per-linear companions of a quantized weight: tensors joined on the out dim
# when linears fuse, the markers that name the product, and the per-input
# vectors of SmoothQuant / OmniQuant that members of a fusion share
_QUANT_TENSORS = (".scale", ".zero")
_QUANT_MARKERS = (".int4p", ".fp4", ".w8a8", ".w4a8")
_PER_INPUT = (".smoother", ".shift")

# KV pool storage types by their config name; fp8 is e4m3, storage only
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8, "fp8": FP8, "float8_e4m3": FP8}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise NotImplementedError(
            f"dtype {name!r} is not ported ({' / '.join(_DTYPES)} only)") from None


def alibi_slopes(n_heads: int) -> list[float]:
    """The ALiBi slope of each head (JAX ``alibi_slopes``, bloom's
    schedule, which mpt's ``alibi_bias_max`` 8 gives too): powers of
    ``2^(-8/n)`` for the nearest power-of-two head count ``n`` at or below
    ``n_heads``, the rest interleaved from the schedule of ``2n``."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(n_heads).is_integer():
        return pow2(n_heads)
    closest = 2 ** int(math.floor(math.log2(n_heads)))
    return pow2(closest) + pow2(2 * closest)[0::2][: n_heads - closest]


class LlamaFamilyModel:
    """Static model metadata + forward.

    The KV cache is one tensor ``[L, 2, num_blocks * block_size, Hkv * D]``
    (see ops/kv_cache.py); block 0 is the null block for padding tokens. An
    int8 cache is ``{"data": int8 of that shape, "scale": bf16 [L, 2, NS,
    Hkv]}``; an fp8 cache is one ``float8_e4m3fn`` tensor without scales.
    A split model's cache is a ``SplitPool`` of two such pools (the module
    docstring).
    ``attn_backend`` is "auto" (kernels on the GPU, plain on the CPU) or
    "plain" (the plain version everywhere, for comparisons: attention and
    the expert products).
    ``gemm_variant`` picks the 4-bit GEMM kernel: "base" or "pipe"."""

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # tables at the rotated width (partial rotary: a slice of the head);
        # longrope keeps its long table's rows after the short one's, and a
        # row whose ``rope_lens`` passes ``rope_switch`` reads them
        self.rope_switch = rope_switch(cfg.rope_scaling, cfg.max_position_embeddings)
        tables = [compute_rope_freqs(cfg.rotary_dim, cfg.max_position_embeddings,
                                     cfg.rope_theta, cfg.rope_scaling,
                                     cfg.max_position_embeddings, long=long)
                  for long in ((False, True) if self.rope_switch else (False,))]
        self.cos = torch.cat([torch.from_numpy(c) for c, _ in tables]).to(self.device)
        self.sin = torch.cat([torch.from_numpy(s) for _, s in tables]).to(self.device)
        self.sm_scale = (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar
                         else cfg.head_dim ** -0.5)
        # ALiBi: the slopes as an f32 [Hq] device tensor, which the decode
        # graphs capture by address; falcon's times sm_scale (its bias is
        # scaled with the scores)
        self.alibi = None
        if cfg.use_alibi:
            scale = self.sm_scale if cfg.alibi_scaled else 1.0
            self.alibi = torch.tensor([x * scale for x in alibi_slopes(cfg.num_attention_heads)],
                                      dtype=torch.float32, device=self.device)
        try:
            self.act_and_mul = ACT_AND_MUL[cfg.hidden_act] if cfg.gated_mlp else None
            self.act = ACT[cfg.hidden_act]
            self._norm = NORMS[cfg.norm_type]
        except KeyError:
            raise NotImplementedError(
                f"hidden_act {cfg.hidden_act!r} / norm_type {cfg.norm_type!r} is not ported "
                f"({' / '.join(ACT_AND_MUL)}; {' / '.join(NORMS)} only)") from None
        # cohere turns GPT-J pairs, the rest neox halves; a partial rotary
        # turns the first rotary_dim dims, in pairs (glm4, chatglm) or halves
        # (gpt_neox, phi: rope_partial_interleaved false), as the JAX model
        if cfg.rotary_dim != cfg.head_dim:
            self.rotate = rotate_pairs_partial if cfg.rope_partial_interleaved else rotate_partial
        else:
            self.rotate = rotate_pairs if cfg.rope_gptj_pairs else rotate
        # MoE: each layer's index in the expert stacks (sparse layers) or in
        # the dense MLP's stacks (the others), as the JAX model maps them
        self._moe_pos, self._dense_pos = {}, {}
        for i in range(cfg.num_layers if cfg.num_experts else 0):
            pos = self._moe_pos if cfg.is_moe_layer(i) else self._dense_pos
            pos[i] = len(pos)
        # split pools (module docstring): each layer's index in its pool
        self.swa_split = bool(cfg.sliding_window and cfg.sliding_window_pattern)
        self._swa_pos, self._full_pos = {}, {}
        for i in range(cfg.num_layers if self.swa_split else 0):
            pos = self._swa_pos if cfg.is_swa_layer(i) else self._full_pos
            pos[i] = len(pos)
        self.swa_nring = 0  # set by init_cache
        self.max_slots = 0
        # the largest prefill chunk; an engine sets it before init_cache
        self.swa_prefill_span = 128
        # forward(..., defer_kv_writes=True); split pools write in-layer
        self.supports_deferred_kv = not self.swa_split
        self.block_size = 16  # set by init_cache
        self.attn_backend = "auto"
        self.gemm_variant = "base"
        hq, hkv, d, h, f = (cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.hidden_size, cfg.intermediate_size)
        # each fused linear's LoRA targets, (name, out columns) in the
        # column order of its output
        self.lora_members = {
            "qkv_proj": (("q_proj", hq * d), ("k_proj", hkv * d), ("v_proj", hkv * d)),
            "o_proj": (("o_proj", h),),
            **({"gate_up_proj": (("gate_proj", f), ("up_proj", f))} if cfg.gated_mlp
               else {"up_proj": (("up_proj", f),)}),
            "down_proj": (("down_proj", h),)}

    # ---- load-time weight fusion ----

    def fuse_weights(self, w: dict) -> dict:
        """Fuse q/k/v -> ``qkv_proj`` (+ ``qkv_bias``, from ``q_bias`` ... or
        ``q_proj.bias`` ...) and gate/up -> ``gate_up_proj`` (a non-gated
        MLP's ``up_proj`` stays as it is): fewer, larger GEMMs per layer.
        ``forward`` takes only the fused layout; a dict already fused is
        returned as is.

        Quantized members join their codes, ``.scale`` and ``.zero`` on the
        last axis and carry their marker: the out dim is not packed, so the
        join is exact. A per-tensor scale (``[L]`` beside an ``[L, K, N]``
        stack) is first repeated over its member's out columns, so the fused
        linear has a per-channel scale that gives every member its own (the
        JAX package joins the ``[L]`` vectors into ``[3L]`` and gives k and v
        the scale of q; ROADMAP.md, section C). SmoothQuant ``.smoother`` /
        ``.shift`` vectors belong to the shared input and are carried once.
        Members of different schemes, scale layouts or per-input vectors do
        not fuse. Every ``.zero`` then becomes ``.zs = zero * scale``, the
        operand of the zero correction, computed here once instead of at
        every call.

        GPTQ act-order members (``.act_perm``, their input's permutation)
        fuse only when every member carries the same one, as AutoGPTQ writes
        q / k / v and gate / up (each group's members share one input
        Hessian): the fused product gathers x once. Otherwise the members
        stay apart and the forward runs each on its own gathered input (the
        JAX package never fuses act-order members)."""
        w = dict(w)

        def scale_of(n):
            s = w.pop(n + ".scale")
            if s.dim() == w[n].dim() - 2:  # per tensor: one scale per layer
                s = s[..., None].expand(*s.shape, w[n].shape[-1])
            return s

        def fuse(names, out_name, bias_names=None, bias_out=None):
            if out_name in w:
                return
            perms = [w.get(n + ".act_perm") for n in names]
            if any(p is not None for p in perms):
                if any(p is None or not torch.equal(p, perms[0]) for p in perms):
                    return  # the members gather their input apart
                w[out_name + ".act_perm"] = perms[0]
                for n in names:
                    del w[n + ".act_perm"]
            for suffix in _QUANT_TENSORS + _QUANT_MARKERS + _PER_INPUT:
                if len({n + suffix in w for n in names}) != 1:
                    raise ValueError(
                        f"cannot fuse {names}: only some carry {suffix!r} "
                        "(mixed quantization schemes)")
            if len({w[n].dtype for n in names}) != 1:
                raise ValueError(f"cannot fuse {names}: mixed dtypes")
            for suffix in _PER_INPUT:
                if names[0] + suffix in w and not all(
                        torch.equal(w[names[0] + suffix], w[n + suffix]) for n in names[1:]):
                    raise ValueError(f"cannot fuse {names}: their {suffix!r} vectors differ")
            if names[0] + ".scale" in w:
                scales = [scale_of(n) for n in names]
                if len({s.shape[:-1] for s in scales}) != 1:
                    raise ValueError(f"cannot fuse {names}: mixed scale layouts")
                w[out_name + ".scale"] = torch.cat(scales, dim=-1)
            w[out_name] = torch.cat([w.pop(n) for n in names], dim=-1)
            if names[0] + ".zero" in w:
                w[out_name + ".zero"] = torch.cat([w.pop(n + ".zero") for n in names], dim=-1)
            for suffix in _QUANT_MARKERS + _PER_INPUT:
                if names[0] + suffix in w:
                    w[out_name + suffix] = [w.pop(n + suffix) for n in names][0]
            if bias_names and bias_names[0] in w:
                w[bias_out] = torch.cat([w.pop(b) for b in bias_names], dim=-1)

        for p in ("q", "k", "v"):  # starcoder2 names them as its linears' biases
            if p + "_proj.bias" in w:
                w[p + "_bias"] = w.pop(p + "_proj.bias")
        fuse(("q_proj", "k_proj", "v_proj"), "qkv_proj",
             bias_names=("q_bias", "k_bias", "v_bias"), bias_out="qkv_bias")
        if "gate_proj" in w:  # a non-gated MLP keeps up_proj alone
            fuse(("gate_proj", "up_proj"), "gate_up_proj")
        if "moe_gate" in w:  # the expert stacks [L, E, H, 2I], the shared expert's
            fuse(("moe_gate", "moe_up"), "moe_gate_up")
        if "shared_gate" in w:
            fuse(("shared_gate", "shared_up"), "shared_gate_up")
        for name in [n for n in w if n.endswith(".zero")]:
            base = name[: -len(".zero")]
            w[base + ".zs"] = w.pop(name) * w[base + ".scale"]
        return w

    def fuse_lora(self, pack: dict) -> dict:
        """Lay out the adapter stacks of ``LoraManager.device_pack`` (by
        the canonical names: ``q_proj.lora_a`` ``[n_ids, L, in, r]``,
        ``q_proj.lora_b`` ``[n_ids, L, r, out]``) for the fused linears the
        forward runs: the A of the members a fused linear's adapters target
        joined along r (``qkv_proj.lora_a = [A_q | A_k | A_v]``, zero
        columns padding it to a multiple of ``R_MULTIPLE``, so one shrink
        serves them), each member's B kept as it is under its own name. The
        expand adds each member's delta to its columns of the fused output
        (``lora_members``; a member no adapter targets has no B and adds
        nothing). The JAX engine unfuses the linears instead; the function
        is the same. Raises before anything is laid out if the kernels would
        not take a stack (``ops.lora.check_stacks``)."""
        out = {}
        for fused, members in self.lora_members.items():
            present = [m for m, _ in members if m + ".lora_a" in pack]
            if not present:
                continue
            a = torch.cat([pack[m + ".lora_a"] for m in present], dim=-1)
            pad = -a.shape[-1] % R_MULTIPLE
            if pad:
                a = torch.nn.functional.pad(a, (0, pad))
            bs = [(pack.get(m + ".lora_b"), o) for m, o in members]
            check_stacks(a, bs)
            out[fused + ".lora_a"] = a.contiguous()
            out.update({m + ".lora_b": pack[m + ".lora_b"] for m in present})
        return out

    # ---- cache ----

    def _pool(self, layers: int, slots: int, dtype: torch.dtype):
        c = self.cfg
        shape = (layers, 2, slots, c.num_kv_heads * c.head_dim)
        data = torch.zeros(shape, dtype=dtype, device=self.device)
        if dtype != torch.int8:
            return data
        # int8 KV: quantized rows + per-(slot, kv-head) scales
        return {"data": data,
                "scale": torch.zeros(shape[:-1] + (c.num_kv_heads,),
                                     dtype=torch.bfloat16, device=self.device)}

    def ring_blocks(self, block_size: int) -> int:
        """Blocks of one slot's ring: the window and the largest prefill
        chunk's live tokens, and one block so that the kept span never
        collides modulo the ring (JAX ``swa_nring``)."""
        return -(-(self.cfg.sliding_window + self.swa_prefill_span) // block_size) + 1

    def init_cache(self, num_blocks: int, block_size: int,
                   dtype: torch.dtype = torch.bfloat16, max_slots: int = 0):
        """The pool, or a split model's ``SplitPool``: its rings for
        ``max_slots`` decode slots (0: 8, for direct use of the model, as
        the JAX package) and their null block."""
        self.block_size = block_size
        if not self.swa_split:
            return self._pool(self.cfg.num_layers, num_blocks * block_size, dtype)
        self.max_slots = max_slots or 8
        self.swa_nring = self.ring_blocks(block_size)
        return SplitPool(
            full=self._pool(len(self._full_pos), num_blocks * block_size, dtype),
            swa=self._pool(len(self._swa_pos),
                           (self.max_slots * self.swa_nring + 1) * block_size, dtype))

    # ---- forward ----

    @torch.no_grad()
    def forward(self, weights: dict, cache, inputs: ModelInputs,
                defer_kv_writes: bool = False, need_all_logits: bool = False,
                need_all_hidden: bool = False,
                capture_layers: tuple = ()) -> tuple[ModelOutputs, object]:
        """``weights`` in the fused layout of ``fuse_weights``; ``cache`` as
        ``init_cache`` made it, updated in place. With ``defer_kv_writes`` (a
        decode step, T = 1) no layer writes its K/V row: attention folds the
        current token in beside the cached ones, and the rows come back in
        ``ModelOutputs.kv_writes`` for one batched scatter by the caller.
        ``need_all_hidden`` returns the final-normed hidden state of every
        token row (``[N, H]``, the JAX ``all_hidden``); ``capture_layers``
        (an EAGLE3 head's, per call: the model object may serve other
        engines) returns instead those layers' outputs before the final
        norm, concatenated (``[N, len * H]``); ``need_all_logits`` the
        LM head over every row (``[N, V]`` f32), for the teacher-forced loops
        and the speculative verify.

        Every op but attention runs on token rows ``[N, H]``: all ``B * T``
        tokens of the padded form, only the real ones of the packed form
        (``inputs.row_lens``); attention scatters the packed queries into
        ``[B, T_max]`` and gathers its output back."""
        cfg = self.cfg
        packed = inputs.row_lens is not None
        if packed:
            b, t = len(inputs.row_lens), max(inputs.row_lens)
        else:
            b, t = inputs.tokens.shape
        if defer_kv_writes and (packed or t != 1):
            raise ValueError("deferred KV writes are a decode (T = 1) mode")

        # computed once for all layers: the int32 operands the attention
        # kernels take, flat cache slots, rope rows, the LM head's rows
        i32 = lambda a: a.to(torch.int32).contiguous()
        tokens, positions = inputs.tokens.reshape(-1), inputs.positions.reshape(-1)
        adapter_ids, state_slots = inputs.adapter_ids, inputs.state_slots
        rope_lens = inputs.rope_lens if inputs.rope_lens is not None else inputs.kv_lens
        inputs = ModelInputs(tokens, positions, i32(inputs.block_tables),
                             i32(inputs.kv_lens), i32(inputs.q_offsets), inputs.row_lens)
        row = None
        if packed:
            pad, last = packed_index(inputs.row_lens, self.device)
            # every packed token is real; its row's block table by its row
            row = torch.div(pad, t, rounding_mode="floor")
            slots = token_slots(positions[:, None], inputs.block_tables[row], self.block_size,
                                torch.ones((pad.numel(), 1), dtype=torch.bool,
                                           device=self.device)).reshape(-1)  # [N]
            if b == 1:  # one row fills its padded layout: attention needs no scatter
                pad = None
        else:
            pad = None
            steps = torch.arange(t, device=self.device)
            valid = (inputs.q_offsets[:, None] + steps[None, :]) < inputs.kv_lens[:, None]
            slots = token_slots(positions.view(b, t), inputs.block_tables,
                                self.block_size, valid).reshape(-1)  # [B*T]
            # each row's last valid token
            last = (torch.arange(b, device=self.device) * t
                    + (inputs.kv_lens.long() - inputs.q_offsets.long() - 1).clamp(0, t - 1))
        # each token row's adapter id, when adapters are loaded, and the rows
        # grouped by adapter once for every layer's linears (one launch)
        lora = None
        stack = next((v for k, v in weights.items() if k.endswith(".lora_a")), None)
        if adapter_ids is not None and stack is not None:
            lora_ids = (adapter_ids.to(torch.int32)[row] if packed
                        else adapter_ids.to(torch.int32)[:, None].expand(b, t).reshape(-1))
            lora_ids = lora_ids.contiguous()
            lora = (lora_ids, lora_segments(lora_ids, stack.shape[0]))
        x = weights["embed_tokens"][tokens.long()]  # [N, H]
        if cfg.scale_embeddings:  # gemma: sqrt(H) rounded to the activation type
            # (a host value: a CUDA graph captures no host-to-device copy; the
            # product of two such values rounds once, as the JAX bf16 product)
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype).item()
        if "embed_norm" in weights:  # bloom: a LayerNorm on the word embeddings
            x = self._norm_at(weights, "embed_norm", x)
        if cfg.use_learned_positions:
            # gpt_bigcode: the learned position of every token row, from the
            # positions the engine passes (which keeps a live row's below
            # n_positions: it caps max_seq_len there; the clamp holds the
            # index of a padding row inside the table)
            table = weights["pos_embed"]
            x = x + table[positions.long().clamp(0, table.shape[0] - 1)]
        rope = None
        if self.alibi is None and not cfg.use_learned_positions:
            pos = positions.long()
            if self.rope_switch:  # longrope: a row past the switch reads the long rows
                long = (rope_lens.to(self.device).long() > self.rope_switch).long()
                long = long[row] if packed else long[:, None].expand(b, t).reshape(-1)
                pos = pos + long * cfg.max_position_embeddings
            rope = rope_at(pos, self.cos, self.sin)
        sites = self._attention_sites(cache, inputs, state_slots, slots,
                                      positions, row if packed else None, (b, t))
        kv_writes = ([], []) if defer_kv_writes else None
        # a decode step: one token a row of the padded form (the JAX
        # package's T = 1); a packed forward is a prefill whatever its length
        decode = not packed and t == 1
        cap = tuple(capture_layers)
        captured = {}
        for i in range(cfg.num_layers):
            x = self._layer(weights, sites[i], i, x, inputs, (b, t, pad, decode), rope,
                            kv_writes, lora)
            if i in cap:
                captured[i] = x

        # the final norm and the LM head at each row's last token only
        # (every token row's too when asked: the norm is row-wise)
        normed = all_logits = None
        if need_all_hidden or need_all_logits:
            normed = self._norm_at(weights, "final_norm", x)  # [N, H]
            hidden_last = normed[last]
            if need_all_logits:
                all_logits = self._lm_head(weights, normed)
        else:
            hidden_last = self._norm_at(weights, "final_norm", x[last])  # [B, H]
        logits = self._lm_head(weights, hidden_last)
        if kv_writes is not None:
            kv_writes = (torch.stack(kv_writes[0]), torch.stack(kv_writes[1]))
        all_hidden = None
        if need_all_hidden or cap:
            # ordered, and repeated for a model shallower than the capture count
            all_hidden = torch.cat([captured[i] for i in cap], dim=-1) if cap else normed
        return ModelOutputs(logits=logits, kv_writes=kv_writes, all_logits=all_logits,
                            all_hidden=all_hidden), cache

    def _lm_head(self, weights: dict, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits of hidden rows ``[N, H]`` through the model's head: the
        tied embedding, the per-channel int8 head (``quantize_lm_head``) or
        the bf16 one, plus phi's loaded ``lm_head.bias`` in f32; cohere's
        ``logit_scale`` and gemma2's final soft-cap ``cap * tanh(logits /
        cap)`` on them, so that the sampler, logprobs, the prompt loss and the
        verify all read scaled and capped logits."""
        if self.cfg.tie_word_embeddings:
            logits = hidden @ weights["embed_tokens"].T
        elif "lm_head.scale" in weights:
            logits = w8_matmul(hidden, weights["lm_head"], weights["lm_head.scale"])
        else:
            logits = hidden @ weights["lm_head"]
        logits = logits.float()
        bias = weights.get("lm_head.bias")
        if bias is not None:
            logits = logits + bias.float()
        if self.cfg.logit_scale:
            logits = logits * self.cfg.logit_scale
        cap = self.cfg.final_logit_soft_cap
        return cap * torch.tanh(logits / cap) if cap else logits

    def _norm_at(self, w: dict, name: str, x: torch.Tensor, i: Optional[int] = None):
        """The norm of site ``name`` (layer ``i``'s, or a global one): a
        biased LayerNorm where ``<name>.bias`` is loaded, else the
        ``norm_type``'s (JAX ``_norm_at``)."""
        wt = w[name] if i is None else w[name][i]
        b = w.get(name + ".bias")
        if b is not None:
            return layer_norm(x, wt, b if i is None else b[i], self.cfg.rms_norm_eps)
        return self._norm(x, wt, self.cfg.rms_norm_eps)

    def _attention_sites(self, cache, inputs, state_slots, slots, positions, row, bt_shape):
        """Each layer's (pool, its index in the pool, block table, write
        slots, null slot, window). One pool: the engine's block tables and
        ``slots``, the model's window on every layer. Split pools: global
        layers the paged pool, unwindowed; sliding layers the rings, through
        the ring table of each row's decode slot (``state_slots``, else the
        row index) and its write slots, where only positions at or past
        ``kv_len - (swa_nring - 1) * block_size`` are written."""
        cfg = self.cfg
        if not self.swa_split:
            return [(cache, i, inputs.block_tables, slots, 0, cfg.sliding_window)
                    for i in range(cfg.num_layers)]
        b, t = bt_shape
        bs, ring = self.block_size, self.swa_nring
        dev = self.device
        sids = (state_slots.to(device=dev, dtype=torch.int64) if state_slots is not None
                else torch.arange(b, device=dev))
        mb = inputs.block_tables.shape[1]
        table = (sids[:, None] * ring
                 + torch.arange(mb, device=dev)[None, :] % ring).to(torch.int32)
        lens = inputs.kv_lens.long()
        if row is not None:  # packed: every token real, its row's table
            kept = positions.long() >= lens[row] - (ring - 1) * bs
            ring_slots = token_slots(positions[:, None], table[row], bs, kept[:, None])
        else:
            pos = positions.view(b, t).long()
            valid = (inputs.q_offsets.long()[:, None]
                     + torch.arange(t, device=dev)[None, :]) < lens[:, None]
            kept = valid & (pos >= lens[:, None] - (ring - 1) * bs)
            ring_slots = token_slots(pos, table, bs, kept)
        ring_slots = ring_slots.reshape(-1)
        ring_null = self.max_slots * ring * bs + bs - 1  # the ring pool's null block
        return [(cache.swa, self._swa_pos[i], table, ring_slots, ring_null, cfg.sliding_window)
                if i in self._swa_pos else
                (cache.full, self._full_pos[i], inputs.block_tables, slots, 0, 0)
                for i in range(cfg.num_layers)]

    def _layer(self, w, site, i, x, inputs: ModelInputs, layout, rope, kv_writes=None,
               lora=None):
        """One layer over token rows ``x [N, H]``. ``site``: the layer's
        (pool, index in it, block table, write slots, null slot, window),
        ``_attention_sites``. ``layout`` is (B, T, pad, decode): pad None
        when the rows are the whole ``[B, T]`` grid, else each row's index
        in it (packed form); decode True for a decode step. ``lora``: (each
        row's adapter ``[N]``, their ``ops.lora.Segments``), or None."""
        cfg = self.cfg
        b, t, pad, decode = layout
        n = x.shape[0]
        hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim

        res = x
        x = self._norm_at(w, "input_norm", x, i)
        normed = x  # cohere's MLP reads it too
        if "qkv_proj" in w:
            qkv = self._linear(w, "qkv_proj", i, x, decode, lora)
            if "qkv_bias" in w:
                qkv = qkv + w["qkv_bias"][i]
            q, k, v = torch.split(qkv, (hq * d, hkv * d, hkv * d), dim=-1)
        else:  # act-order members of different permutations (fuse_weights)
            q, k, v = (self._unfused(w, p, i, x, decode, lora) for p in ("q", "k", "v"))
        q = q.reshape(n, hq, d)
        k = k.reshape(n, hkv, d)
        v = v.reshape(n, hkv, d)
        if cfg.use_qk_norm:  # qwen3: [D] RMSNorm weights; cohere: per head [H, D]
            q = self._norm(q, w["q_norm"][i], cfg.rms_norm_eps)
            k = self._norm(k, w["k_norm"][i], cfg.rms_norm_eps)
        if rope is not None:  # ALiBi and learned-position models take no RoPE
            q = self.rotate(q, *rope)
            k = self.rotate(k, *rope)

        # the layer's views of its pool (and of the int8 pool's scales)
        cache, li, block_tables, slots, null_slot, window = site
        quant = isinstance(cache, dict)
        data = cache["data"] if quant else cache
        k_cache, v_cache = data[li, 0], data[li, 1]
        k_scale, v_scale = (cache["scale"][li, 0], cache["scale"][li, 1]) if quant else (None, None)
        cur_k = cur_v = None
        if kv_writes is not None:
            # deferred: the pool holds kv_len - 1 tokens (quantized or not);
            # the current token goes to attention as it is and to the caller
            cur_k, cur_v = k.reshape(n, hkv * d), v.reshape(n, hkv * d)
            kv_writes[0].append(cur_k)
            kv_writes[1].append(cur_v)
        elif quant:
            write_kv_quant(k_cache, v_cache, k_scale, v_scale, k, v, slots, null_slot)
        else:
            write_kv(k_cache, v_cache, k.reshape(n, hkv * d), v.reshape(n, hkv * d), slots,
                     null_slot)
        if pad is None:
            q = q.view(b, t, hq, d)
        else:  # the kernel's operand alone carries pad rows
            q = q.new_zeros((b * t, hq, d)).index_copy_(0, pad, q).view(b, t, hq, d)
        attn = paged_attention(
            q, k_cache, v_cache, block_tables, inputs.kv_lens,
            inputs.q_offsets, self.sm_scale, block_size=self.block_size,
            sliding_window=window, soft_cap=cfg.attn_soft_cap, backend=self.attn_backend,
            k_scale=k_scale, v_scale=v_scale, cur_k=cur_k, cur_v=cur_v,
            alibi_slopes=self.alibi,
        ).reshape(b * t, hq * d)
        if pad is not None:
            attn = attn.index_select(0, pad)
        o = self._linear(w, "o_proj", i, attn, decode, lora)
        if cfg.parallel_residual:  # cohere, falcon, phi: x + attn(ln(x)) + mlp(ln(x))
            if cfg.parallel_norms == "dual":  # falcon's new decoder, gpt_neox: mlp(ln_mlp(x))
                normed = self._norm_at(w, "post_attn_norm", res, i)
            return res + o + self._mlp(w, i, normed, decode, lora)
        if cfg.sandwich_norms:  # gemma2, glm4: the attention and MLP outputs normed too
            x = res + rms_norm(o, w["post_attn_norm"][i], cfg.rms_norm_eps)
            h = self._mlp(w, i, rms_norm(x, w["pre_ffn_norm"][i], cfg.rms_norm_eps),
                          decode, lora)
            return x + rms_norm(h, w["post_ffn_norm"][i], cfg.rms_norm_eps)
        x = res + o

        res = x
        x = self._norm_at(w, "post_attn_norm", x, i)
        return res + self._mlp(w, i, x, decode, lora)

    def _unfused(self, w, p, i, x, decode, lora):
        """Member ``p`` ("q", "gate", ...) of a linear left unfused: its own
        product and bias. Adapters target the fused layout only."""
        if lora is not None and any(k.endswith(".lora_a") for k in w):
            raise NotImplementedError(
                "LoRA adapters on unfused (act-order) linears are not ported")
        y = self._product(w, p + "_proj", i, x, decode)
        b = w.get(p + "_bias")
        return y if b is None else y + b[i]

    def _mlp(self, w, i, x, decode, lora):
        """Layer ``i``'s MLP: the experts on a sparse layer, else the dense
        MLP, each at the layer's index in its own stacks."""
        j = self._moe_pos.get(i)
        if j is not None:
            return self._moe_mlp(w, j, x, decode)
        return self._dense_mlp(w, self._dense_pos.get(i, i), x, decode, lora)

    def _moe_mlp(self, w, j, x, decode=False):
        """The routed experts of sparse layer ``j`` over token rows ``x [N,
        H]`` (JAX ``_moe_mlp``, softmax branch): router logits in f32, the
        top-k weights, the experts (``ops.moe.fused_moe``: X6 on the card),
        qwen2_moe's shared expert times its sigmoid gate added in f32, the sum
        rounded to x's type once."""
        cfg = self.cfg
        logits = x.float() @ w["router"][j].float()  # [N, E]
        top_idx, top_w = route(logits, cfg.num_experts_per_tok, cfg.moe_norm_topk_prob)
        out = fused_moe(x, top_idx, top_w, w["moe_gate_up"][j], w["moe_down"][j],
                        plain=self.attn_backend == "plain")
        if "shared_gate_up" in w:
            gate, up = torch.chunk(self._product(w, "shared_gate_up", j, x, decode), 2, dim=-1)
            shared = self._product(w, "shared_down", j, self.act_and_mul(gate, up), decode)
            if "shared_expert_gate" in w:
                g = torch.sigmoid(x.float() @ w["shared_expert_gate"][j].float())
                shared = shared * g.to(shared.dtype)
            out = out + shared.float()
        return out.to(x.dtype)

    def _dense_mlp(self, w, i, x, decode=False, lora=None):
        if not self.cfg.gated_mlp:  # starcoder2, bloom, mpt, falcon: act(up) -> down
            up = self._linear(w, "up_proj", i, x, decode, lora)
            return self._linear(w, "down_proj", i, self.act(up), decode, lora)
        if "gate_up_proj" in w:
            gate, up = torch.chunk(self._linear(w, "gate_up_proj", i, x, decode, lora), 2,
                                   dim=-1)
        else:  # act-order members of different permutations (fuse_weights)
            gate, up = (self._unfused(w, p, i, x, decode, lora) for p in ("gate", "up"))
        return self._linear(w, "down_proj", i, self.act_and_mul(gate, up), decode, lora)

    def _linear(self, w, name, i, x, decode=False, lora=None):
        """The layer's product (``_product``), plus its loaded ``name.bias``
        (the JAX ``_linear``'s rule: internlm's ``o_proj``, starcoder2's
        linears), plus each token row's adapter delta when ``lora`` (ids,
        segments) is given and the weights hold ``name.lora_a`` (and each
        targeted member's ``.lora_b``, ``fuse_lora``), from the linear's
        input before any smoothing (the JAX ``_linear``'s; it adds the QKV
        bias before the delta too, the port's layer adds ``qkv_bias`` after
        it)."""
        y = self._product(w, name, i, x, decode)
        bias = w.get(name + ".bias")
        if bias is not None:
            y = y + bias[i]
        a = w.get(name + ".lora_a")
        if lora is not None and a is not None:
            members = [(w.get(m + ".lora_b"), o) for m, o in self.lora_members[name]]
            y = lora_delta(x, y, a, members, lora[0], i, lora[1])
        return y

    def _product(self, w, name, i, x, decode=False):
        """``x @ W[name][i]`` for a bf16/f32 weight; for a quantized one the
        route of the JAX ``_linear``. SmoothQuant's ``name.shift`` and
        ``name.smoother`` come off x first, ``x' = (x - shift) / smoother``.
        Then packed 4-bit codes (``name.int4p``: s4, with ``name.zs`` when
        the checkpoint has zero points; ``name.fp4``: e2m1) take the 4-bit
        GEMM, ``name.w4a8`` the integer contraction, ``name.w8a8`` the
        integer contraction at prefill and the weight-only product at decode
        (the JAX package keys that on T = 1), and any other scaled weight
        (int8 / e4m3 codes, per tensor, per channel or groupwise with
        ``name.zs``) the weight-only 8-bit product. Every kernel gets the
        layer's view of the ``[L, ...]`` stack, never a copy. A GPTQ
        act-order weight (``name.act_perm``, rows sorted into group order)
        first gathers x's features into that order: a plain
        ``index_select``, as the JAX package's ``jnp.take`` outside its
        kernel."""
        perm = w.get(name + ".act_perm")
        if perm is not None:
            x = x.index_select(-1, perm[i])
        sh = w.get(name + ".shift")
        if sh is not None:
            x = x - sh[i].to(x.dtype)
        sm = w.get(name + ".smoother")
        if sm is not None:
            x = x / sm[i].to(x.dtype)
        s = w.get(name + ".scale")
        if s is None:
            return x @ w[name][i]
        zs = w.get(name + ".zs")
        zs = None if zs is None else zs[i]
        fp4 = name + ".fp4" in w
        if fp4 or name + ".int4p" in w:
            return groupwise_matmul_packed(
                x, w[name], s[i], code="e2m1" if fp4 else "s4",
                zero_scale=zs, layer=i, variant=self.gemm_variant)
        if name + ".w4a8" in w:
            return w4a8_matmul(x, w[name][i], s[i])
        if name + ".w8a8" in w:
            return w8a8_matmul(x, w[name][i], s[i], decode=decode)
        return w8_matmul(x, w[name][i], s[i], zero_scale=zs)
