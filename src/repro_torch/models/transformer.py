"""Decoder-only transformer LM, dense, MoE and VLM-prefix families
(granite, danube, stablelm, phi3, qwen2-moe, moonshot, llava), and the
encoder-decoder (seamless), ported from ``repro.models.transformer`` for
training, evaluation and serving.

The JAX package scans one stacked block over the layers; here each layer
is a ``Block`` module in a ``ModuleList`` (the JAX ``layers`` value
tree's fields without the leading layer axis), and the forward pass is a
Python loop over them.  A MoE model's block holds ``moe`` where a dense
one holds ``mlp``, with the routed experts padded to a multiple of 16 as
in the JAX package.  ``cfg.remat`` recomputes each block in the backward
pass (``torch.utils.checkpoint``) when autograd records, as
``jax.checkpoint`` does in the reference.  ``cfg.use_flash`` sends
``full_attention`` through the flash-attention kernel, which is
forward-only as in the JAX package: evaluate with it under
``torch.no_grad()``, train without it.  Serving (``prefill`` /
``decode_step``) runs ``prefill_attention`` / ``decode_attention``, plain
products in both packages; the KV cache is one ``KVCache`` whose leaves
carry the layer axis first, as the reference's scan stacks them, and
``decode_step`` writes it in place.

``EncDecLM`` encodes precomputed frame embeddings (the audio frontend is
a stub, as in the reference) with bidirectional attention and decodes
with causal self-attention plus cross attention over the encoder.  Both
run the plain attention route (``use_flash=False``), as in the
reference, so the encoder-decoder launches no kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import (ones_init, param, remat,
                                      weights_generator)


def _pad_experts(n: int, multiple: int = 16) -> int:
    return int(math.ceil(n / multiple) * multiple)


class Block(nn.Module):
    """One layer: attn_norm, attn, mlp_norm, and mlp (dense) or moe."""
    AXES = {"attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.dtype_torch
        self.attn_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        self.attn = L.AttnParams(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, dt, device)
        self.mlp_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        if cfg.n_experts > 0:
            self.moe = L.MoeParams(gen, cfg.d_model, cfg.n_experts,
                                   cfg.expert_ff, cfg.n_shared_experts, dt,
                                   device,
                                   pad_experts_to=_pad_experts(cfg.n_experts))
        else:
            self.mlp = L.MlpParams(gen, cfg.d_model, cfg.d_ff, dt, device)


class TransformerLM(nn.Module):
    """granite / danube / stablelm / phi3 / qwen2-moe / moonshot / llava."""
    AXES = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.vocab_padded = L.pad_vocab(cfg.vocab)
        self.is_moe = cfg.n_experts > 0
        gen = weights_generator(device, generator)
        dt = cfg.dtype_torch
        self.embed = L.init_embedding(gen, self.vocab_padded, cfg.d_model, dt,
                                      device)
        self.layers = nn.ModuleList(Block(gen, cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = param(gen, (cfg.d_model,), dt, device,
                                init=ones_init)

    # -- forward --------------------------------------------------------------
    def _ffn(self, lp: Block, h: torch.Tensor, moe_group: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block's MLP or MoE on the normed ``h``: (out, aux loss, None
        for the dense family)."""
        cfg = self.cfg
        if self.is_moe:
            return L.moe(lp.moe, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         group_tokens=moe_group)
        return L.mlp(lp.mlp, h), None

    def _block(self, lp: Block, x: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        h = L.rms_norm(lp.attn_norm, x)
        h = L.full_attention(lp.attn, h, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                             rope_theta=cfg.rope_theta,
                             window=cfg.sliding_window,
                             use_flash=cfg.use_flash,
                             q_chunk=cfg.attn_q_chunk)
        x = x + h
        h, aux = self._ffn(lp, L.rms_norm(lp.mlp_norm, x))
        return x + h, aux

    def hidden_states(self, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the layer stack over embedded inputs x: (B, S, d).  Returns
        (final-normed states, aux loss summed over the layers; 0 for the
        dense family)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            x, a = remat(self.cfg, self._block, lp, x)
            if a is not None:
                aux = aux + a
        return L.rms_norm(self.final_norm, x), aux

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        logits = L.logits_head(self.embed, h).float()
        if self.vocab_padded > self.cfg.vocab:
            pad = torch.arange(self.vocab_padded,
                               device=logits.device) >= self.cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """tokens (B, S) and/or prefix 'embeds' (B, P, d) -> (B, S_total,
        d)."""
        parts = []
        if "embeds" in batch:                      # VLM stub prefix
            parts.append(batch["embeds"].to(self.cfg.dtype_torch))
        if "tokens" in batch:
            parts.append(L.embed(self.embed, batch["tokens"]))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return constrain(x, "batch", "seq", "embed")

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token cross entropy.  batch: tokens (B, S) [+ embeds],
        labels (B, S_text) aligned to the token positions.  Returns (loss,
        {"nll", "aux"})."""
        x = self.embed_inputs(batch)
        h, aux = self.hidden_states(x)
        labels = batch["labels"]
        h_text = h[:, -labels.shape[1]:]           # predictions for text slots
        return L.lm_loss(self.embed, h_text, labels, self.cfg.vocab,
                         self.vocab_padded, self.cfg.ce_seq_chunk, aux)

    # -- serving --------------------------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        window = self.cfg.sliding_window
        return window if window and seq_len > window else seq_len

    def init_cache(self, batch: int, seq_len: int) -> L.KVCache:
        cfg = self.cfg
        one = L.init_kv_cache(batch, self.cache_capacity(seq_len),
                              cfg.n_kv_heads, cfg.hd, cfg.dtype_torch,
                              self.device)
        return L.KVCache(*(a[None].repeat((cfg.num_layers,) + (1,) * a.dim())
                           for a in one))

    @torch.no_grad()
    def prefill(self, batch, seq_len: int):
        """Embed and run the layers, filling a cache of
        ``cache_capacity(seq_len)`` slots.  Returns (last logits, cache)."""
        cfg = self.cfg
        x = self.embed_inputs(batch)
        cap = self.cache_capacity(seq_len)
        kvs = []
        for lp in self.layers:
            a_out, kv = L.prefill_attention(
                lp.attn, L.rms_norm(lp.attn_norm, x), cap,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                q_chunk=cfg.attn_q_chunk)
            x = x + a_out
            x = x + self._ffn(lp, L.rms_norm(lp.mlp_norm, x))[0]
            kvs.append(kv)
        h = L.rms_norm(self.final_norm, x[:, -1:])
        cache = L.KVCache(*(torch.stack(leaf) for leaf in zip(*kvs)))
        return self._logits(h), cache

    @torch.no_grad()
    def decode_step(self, cache: L.KVCache, tokens, cur_pos: int,
                    moe_group: Optional[bool] = None):
        """tokens: (B, 1); cur_pos: int.  -> (logits (B, 1, V), cache),
        the cache written in place.  ``moe_group`` (default
        ``cfg.moe_group_decode``) routes the batch as one group."""
        cfg = self.cfg
        if moe_group is None:
            moe_group = cfg.moe_group_decode
        x = constrain(L.embed(self.embed, tokens), "batch", None, "embed")
        for i, lp in enumerate(self.layers):
            a_out, _ = L.decode_attention(
                lp.attn, L.rms_norm(lp.attn_norm, x),
                L.KVCache(cache.k[i], cache.v[i], cache.pos[i]), cur_pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, window=cfg.sliding_window)
            x = x + a_out
            x = x + self._ffn(lp, L.rms_norm(lp.mlp_norm, x), moe_group)[0]
        h = L.rms_norm(self.final_norm, x)
        return self._logits(h), cache


# ---------------------------------------------------------------------------
# encoder-decoder (seamless-m4t): audio-frame encoder stub + text decoder
# ---------------------------------------------------------------------------
class EncBlock(nn.Module):
    """One encoder layer: attn_norm, attn, mlp_norm, mlp."""
    AXES = {"attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.dtype_torch
        self.attn_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        self.attn = L.AttnParams(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, dt, device)
        self.mlp_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        self.mlp = L.MlpParams(gen, cfg.d_model, cfg.d_ff, dt, device)


class DecBlock(EncBlock):
    """One decoder layer: an encoder layer's fields plus cross_norm and
    cross (the cross attention's projections)."""
    AXES = dict(EncBlock.AXES, cross_norm=("embed",))

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__(gen, cfg, device)
        dt = cfg.dtype_torch
        self.cross_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        self.cross = L.AttnParams(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.hd, dt, device)


class EncDecLM(nn.Module):
    """Encoder over precomputed frame embeddings, decoder with self and
    cross attention.  The serving cache is {"self": a ``KVCache`` of
    (L, ...) leaves, "cross": the (k, v) of every layer, each (L, B, Se,
    Kh, hd)}, the reference's layout."""
    AXES = {"embed": ("vocab", "embed"), "enc_norm": ("embed",),
            "final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.vocab_padded = L.pad_vocab(cfg.vocab)
        gen = weights_generator(device, generator)
        dt = cfg.dtype_torch
        self.embed = L.init_embedding(gen, self.vocab_padded, cfg.d_model, dt,
                                      device)
        self.enc_layers = nn.ModuleList(EncBlock(gen, cfg, device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_norm = param(gen, (cfg.d_model,), dt, device,
                              init=ones_init)
        self.dec_layers = nn.ModuleList(DecBlock(gen, cfg, device)
                                        for _ in range(cfg.num_layers))
        self.final_norm = param(gen, (cfg.d_model,), dt, device,
                                init=ones_init)

    def _enc_block(self, lp: EncBlock, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = h + L.full_attention(
            lp.attn, L.rms_norm(lp.attn_norm, h), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            causal=False, q_chunk=cfg.attn_q_chunk, use_flash=False)
        return h + L.mlp(lp.mlp, L.rms_norm(lp.mlp_norm, h))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, Se, d) precomputed embeddings -> (B, Se, d) in the
        model's dtype."""
        x = constrain(frames.to(self.cfg.dtype_torch), "batch", "seq", "embed")
        for lp in self.enc_layers:
            x = remat(self.cfg, self._enc_block, lp, x)
        return L.rms_norm(self.enc_norm, x)

    def _dec_block(self, lp: DecBlock, h, enc_kv, attn_fn):
        """Self-attention by ``attn_fn(lp, normed h)`` -> (out, extra),
        cross attention over ``enc_kv``, and the MLP.  Returns (h,
        extra)."""
        cfg = self.cfg
        a_out, extra = attn_fn(lp, L.rms_norm(lp.attn_norm, h))
        h = h + a_out
        h = h + L.cross_attention(lp.cross, L.rms_norm(lp.cross_norm, h),
                                  enc_kv, n_heads=cfg.n_heads,
                                  n_kv=cfg.n_kv_heads, head_dim=cfg.hd)
        return h + L.mlp(lp.mlp, L.rms_norm(lp.mlp_norm, h)), extra

    def _self_attn(self, lp: DecBlock, hn):
        cfg = self.cfg
        return L.full_attention(
            lp.attn, hn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            q_chunk=cfg.attn_q_chunk), None

    def _dec_train_block(self, lp: DecBlock, h, enc_out):
        enc_kv = L.encode_cross_kv(lp.cross, enc_out, n_kv=self.cfg.n_kv_heads,
                                   head_dim=self.cfg.hd)
        return self._dec_block(lp, h, enc_kv, self._self_attn)[0]

    def loss(self, batch: Dict[str, torch.Tensor]):
        """batch: frames (B, Se, d), tokens (B, St), labels (B, St).
        Returns (loss, {"nll", "aux"}); aux is 0, as in the reference."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        x = L.embed(self.embed, batch["tokens"])
        for lp in self.dec_layers:
            x = remat(cfg, self._dec_train_block, lp, x, enc_out)
        h = L.rms_norm(self.final_norm, x)
        return L.lm_loss(self.embed, h, batch["labels"], cfg.vocab,
                         self.vocab_padded, cfg.ce_seq_chunk)

    # -- serving: cache = (self KV ring, precomputed cross KV) ---------------
    @torch.no_grad()
    def init_cache(self, frames: torch.Tensor, seq_len: int):
        cfg = self.cfg
        enc_out = self.encode(frames)
        kvs = [L.encode_cross_kv(lp.cross, enc_out, n_kv=cfg.n_kv_heads,
                                 head_dim=cfg.hd) for lp in self.dec_layers]
        one = L.init_kv_cache(frames.shape[0], seq_len, cfg.n_kv_heads,
                              cfg.hd, cfg.dtype_torch, self.device)
        self_c = L.KVCache(*(a[None].repeat((cfg.num_layers,) +
                                            (1,) * a.dim()) for a in one))
        return {"self": self_c,
                "cross": tuple(torch.stack(leaf) for leaf in zip(*kvs))}

    @torch.no_grad()
    def decode_step(self, cache, tokens, cur_pos: int):
        """tokens: (B, 1); cur_pos: int.  -> (logits (B, 1, V), cache),
        the self-attention cache written in place.  The padded vocabulary
        is not masked, as in the reference."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        sc, (ck, cv) = cache["self"], cache["cross"]
        for i, lp in enumerate(self.dec_layers):
            def self_attn(lp_, hn, i=i):
                return L.decode_attention(
                    lp_.attn, hn, L.KVCache(sc.k[i], sc.v[i], sc.pos[i]),
                    cur_pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.hd, rope_theta=cfg.rope_theta)
            x, _ = self._dec_block(lp, x, (ck[i], cv[i]), self_attn)
        h = L.rms_norm(self.final_norm, x)
        return L.logits_head(self.embed, h).float(), cache
