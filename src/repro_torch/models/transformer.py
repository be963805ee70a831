"""Decoder-only transformer LM, dense, MoE and VLM-prefix families
(granite, danube, stablelm, phi3, qwen2-moe, moonshot, llava), ported
from ``repro.models.transformer`` for training, evaluation and serving.

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

Not ported yet: ``EncDecLM``; it raises ``NotImplementedError`` naming
its ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import ones_init, param, weights_generator

ENCDEC_LATER = "ROADMAP Queue 1 item 11 (EncDecLM, layers.cross_attention)"


def _pad_experts(n: int, multiple: int = 16) -> int:
    return int(math.ceil(n / multiple) * multiple)


class Block(nn.Module):
    """One layer: attn_norm, attn, mlp_norm, and mlp (dense) or moe."""

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
        recompute = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            if recompute:
                x, a = checkpoint(self._block, lp, x, use_reentrant=False)
            else:
                x, a = self._block(lp, x)
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
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token cross entropy.  batch: tokens (B, S) [+ embeds],
        labels (B, S_text) aligned to the token positions.  Returns (loss,
        {"nll", "aux"})."""
        x = self.embed_inputs(batch)
        h, aux = self.hidden_states(x)
        labels = batch["labels"]
        h_text = h[:, -labels.shape[1]:]           # predictions for text slots
        nll = L.nll_loss(self.embed, h_text, labels, self.cfg.vocab,
                         self.vocab_padded, self.cfg.ce_seq_chunk)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

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
        x = L.embed(self.embed, tokens)
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
