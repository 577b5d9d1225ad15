"""EAGLE / EAGLE3 speculative proposer: one llama layer on the target's
features.

Port of ``rtp_llm_tpu/engine/eagle.py``. EAGLE predicts the token after
next from the target's feature at a position fused with the next token's
embedding:

    x   = fc([embed(t_{i+1}); h_i])       # [2H] -> [H]
    h'  = layer(x)                        # one llama layer, no input norm
    p   = softmax(lm_head(final_norm(h')))  # the target's own head

``h_i`` is what the target's ``all_hidden`` holds: its final-normed rows
(the JAX code's, whatever its docstrings say). EAGLE3 captures three target
layers' outputs before the final norm (``capture_layers``, which the
engine passes to the target's forward in its prefill and verify only),
projects them with ``fc`` ``[3H] -> [H]`` where the feature
enters (prefill, the verify's refresh), and feeds the layer
``[input_norm(embed(t)); hidden_norm(h)]`` with ``h`` as the residual; it
has its own final norm and head over a draft vocabulary whose ids map to
the target's through ``d2t`` (``target = draft + d2t[draft]``).

* The layer keeps a one-layer bf16 KV pool on the target's block ids.
* A per-slot feature ``[S, H]`` f32 is seeded at insertion with the
  target's feature at the last prompt position and refreshed by every
  verify with the feature at the row's last accepted position.
* The rollout is K+1 T = 1 steps (the last writes the K-th draft's KV row);
  on the card the engine replays it as one captured graph.
* The dtypes follow the JAX code step by step (the fused input rounded to
  bf16, products in the head's dtype), so that on f32 heads the drafts are
  the JAX proposer's.
"""

from __future__ import annotations

from typing import List

import torch

from rtp_llm_tpu_torch.ops.activations import silu_and_mul
from rtp_llm_tpu_torch.ops.attention import paged_attention
from rtp_llm_tpu_torch.ops.kv_cache import token_slots, write_kv
from rtp_llm_tpu_torch.ops.norms import rms_norm
from rtp_llm_tpu_torch.ops.rope import rope_at, rotate


def capture_layers(num_layers: int, n_capture: int) -> tuple:
    """The target layers an EAGLE3 head reads: low, middle and high (the
    official capture points), then others; a model shallower than the
    count repeats its deepest. Sorted."""
    seen: list = []
    for c in (2, num_layers // 2, num_layers - 3, 1, num_layers - 1, 0):
        c = min(max(c, 0), num_layers - 1)
        if c not in seen:
            seen.append(c)
        if len(seen) == n_capture:
            break
    while len(seen) < n_capture:
        seen.append(seen[-1])
    return tuple(sorted(seen))


class EagleRunner:
    """Owns the EAGLE layer's weights, KV pool and per-slot features.
    ``model`` is the target (its config fixes the layer's geometry, its
    final norm and head serve an EAGLE head that ships none);
    ``target_weights`` the engine's fused dict."""

    def __init__(self, model, target_weights: dict, eagle_weights: dict, num_blocks: int,
                 block_size: int, max_slots: int):
        self.model, self.cfg, self.tw = model, model.cfg, target_weights
        cfg = model.cfg
        w = dict(eagle_weights)
        self.is_eagle3 = "hidden_norm" in w
        self.capture_layers = (capture_layers(cfg.num_layers, w["fc"].shape[0] // cfg.hidden_size)
                               if self.is_eagle3 else ())
        # fewer, larger products a step; the join is on the out dim (exact)
        w["qkv_proj"] = torch.cat([w.pop("q_proj"), w.pop("k_proj"), w.pop("v_proj")], dim=-1)
        w["gate_up_proj"] = torch.cat([w.pop("gate_proj"), w.pop("up_proj")], dim=-1)
        self.w = w
        self.block_size = block_size
        dev = model.device
        self.kv = torch.zeros((2, num_blocks * block_size, cfg.num_kv_heads * cfg.head_dim),
                              dtype=torch.bfloat16, device=dev)
        self.hidden = torch.zeros((max_slots, cfg.hidden_size), dtype=torch.float32, device=dev)

    # ---- the fused input and the one layer ----

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.w.get("embed_tokens")
        if emb is None:
            emb = self.tw["embed_tokens"]
        return emb[tokens.long()].float()

    def _fuse(self, tokens: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        """EAGLE: ``fc([embed(t); h])`` ``[.., H]``. EAGLE3:
        ``[input_norm(embed(t)); hidden_norm(h)]`` ``[.., 2H]`` (``h`` is
        already the fc-projected feature)."""
        emb, eps = self._embed(tokens), self.cfg.rms_norm_eps
        if self.is_eagle3:
            return torch.cat([rms_norm(emb, self.w["input_norm"], eps),
                              rms_norm(hidden.float(), self.w["hidden_norm"], eps)], dim=-1)
        fc = self.w["fc"]
        return torch.cat([emb, hidden.float()], dim=-1).to(fc.dtype) @ fc

    def fc(self, feat: torch.Tensor) -> torch.Tensor:
        """EAGLE3: the target's captured ``[.., N*H]`` feature projected to
        ``[.., H]`` f32; EAGLE: the feature as it is."""
        if not self.is_eagle3:
            return feat
        fc = self.w["fc"]
        return (feat.to(fc.dtype) @ fc).float()

    def _layer(self, x, res, positions, block_tables, kv_lens, q_offsets, slots):
        """The llama layer without its input norm over ``x [B, T, Hin]``
        (bf16); the residual is ``x`` (EAGLE) or the H-wide feature
        (EAGLE3, ``res``). Returns ``[B, T, H]``."""
        cfg, w = self.cfg, self.w
        b, t, _ = x.shape
        hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
        x = x.reshape(b * t, -1).to(w["qkv_proj"].dtype)
        res = x if res is None else res.reshape(b * t, -1).to(torch.bfloat16).to(x.dtype)
        q, k, v = torch.split(x @ w["qkv_proj"], (hq * d, hkv * d, hkv * d), dim=-1)
        rope = rope_at(positions.reshape(-1).long(), self.model.cos, self.model.sin)
        q = rotate(q.reshape(b * t, hq, d), *rope)
        k = rotate(k.reshape(b * t, hkv, d), *rope)
        write_kv(self.kv[0], self.kv[1], k.reshape(b * t, hkv * d), v, slots)
        attn = paged_attention(q.view(b, t, hq, d), self.kv[0], self.kv[1], block_tables,
                               kv_lens, q_offsets, d ** -0.5, block_size=self.block_size,
                               backend=self.model.attn_backend)
        x = res + attn.reshape(b * t, hq * d) @ w["o_proj"]
        xn = rms_norm(x, w["post_attn_norm"], cfg.rms_norm_eps)
        gate, up = torch.chunk(xn @ w["gate_up_proj"], 2, dim=-1)
        return (x + silu_and_mul(gate, up) @ w["down_proj"]).view(b, t, -1)

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits of the layer's output: the head's own final norm and
        LM head where it ships them (EAGLE3's draft vocabulary), else the
        target's (tied, int8 or bf16, as the target computes it)."""
        fn = self.w.get("final_norm", self.tw["final_norm"])
        hn = rms_norm(hidden.float(), fn, self.cfg.rms_norm_eps)
        if "lm_head" in self.w:
            return (hn.to(self.w["lm_head"].dtype) @ self.w["lm_head"]).float()
        # the model's activation dtype (an int8 head's codes are not)
        return self.model._lm_head(self.tw, hn.to(self.tw["embed_tokens"].dtype))

    def _to_target_vocab(self, ids: torch.Tensor) -> torch.Tensor:
        d2t = self.w.get("d2t")
        return ids if d2t is None else ids + d2t[ids]

    # ---- the engine's calls ----

    def prefill(self, prompt: List[int], chunks, block_row: torch.Tensor) -> None:
        """Write the layer's rows for one stream's prompt: row i fuses
        token i+1 with the target's feature at i. ``chunks`` holds (first
        position, the target's ``all_hidden`` ``[t, Hc]``) of each prefill
        forward, in order; the last prompt position has no next token."""
        p, dev = len(prompt), block_row.device
        for pos, hid in chunks:
            n = min(pos + hid.shape[0], p - 1) - pos
            if n <= 0:
                continue
            h = self.fc(hid[:n])[None]  # [1, n, H]
            tokens = torch.tensor(prompt[pos + 1: pos + 1 + n], device=dev)[None]
            positions = torch.arange(pos, pos + n, device=dev)[None]
            bt = block_row[None]
            slots = token_slots(positions, bt, self.block_size,
                                torch.ones_like(positions, dtype=torch.bool)).reshape(-1)
            x = self._fuse(tokens, h).to(torch.bfloat16)
            lens = torch.tensor([pos + n], dtype=torch.int32, device=dev)
            self._layer(x, h if self.is_eagle3 else None, positions, bt, lens,
                        lens - n, slots)

    def set_slot_hidden(self, slot: int, row: torch.Tensor) -> None:
        """Seed a slot's feature with the target's feature ``[Hc]`` at the
        last prompt position."""
        self.hidden[slot] = self.fc(row[None])[0].float()

    def update_hidden(self, feat: torch.Tensor, active: torch.Tensor) -> None:
        """The verify's refresh: the target's feature ``[B, Hc]`` at each
        active row's last accepted position."""
        self.hidden.copy_(torch.where(active[:, None], self.fc(feat).float(), self.hidden))

    def rollout(self, state, kv_blocks: int, k: int, drafts: torch.Tensor) -> None:
        """K+1 greedy steps from each slot's pending token and feature; the
        first K tokens (target ids) land in ``drafts [B, K]``. Updates the
        pool and the features in place; reads nothing back."""
        active = state.kv_lens > 0
        bt = state.block_tables[:, :kv_blocks]
        h, cur, pos = self.hidden, state.last_tokens, state.kv_lens.long()
        out = []
        for _ in range(k + 1):
            positions = torch.where(active, pos, 0)[:, None]
            kvl = torch.where(active, pos + 1, 0)
            slots = token_slots(positions, bt, self.block_size, active[:, None]).reshape(-1)
            x = self._fuse(cur, h)[:, None].to(torch.bfloat16)
            o = self._layer(x, h[:, None] if self.is_eagle3 else None, positions, bt,
                            kvl, pos, slots)
            h_new = o[:, 0].float()
            nxt = self._to_target_vocab(torch.argmax(self._head(h_new), dim=-1))
            cur = torch.where(active, nxt, cur)
            h = torch.where(active[:, None], h_new, h)
            out.append(cur)
            pos = pos + 1
        self.hidden.copy_(h)
        drafts.copy_(torch.stack(out[:k], dim=1))
