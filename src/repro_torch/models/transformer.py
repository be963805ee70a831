"""Decoder-only transformer LM, dense and VLM-prefix families (granite,
danube, stablelm, phi3, llava), ported from ``repro.models.transformer``
for training and evaluation.

The JAX package scans one stacked block over the layers; here each layer
is a ``DenseBlock`` module in a ``ModuleList`` (the JAX ``layers`` value
tree's fields without the leading layer axis), and the forward pass is a
Python loop over them.  ``cfg.remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``) when autograd records, as
``jax.checkpoint`` does in the reference.  ``cfg.use_flash`` sends
``full_attention`` through the flash-attention kernel, which is
forward-only as in the JAX package: evaluate with it under
``torch.no_grad()``, train without it.

Not ported yet: MoE (``cfg.n_experts``), ``EncDecLM`` and the serving
methods (``init_cache`` / ``prefill`` / ``decode_step``); they raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import ones_init, param, weights_generator

MOE_LATER = "ROADMAP Queue 1 item 11 (TransformerLM with MoE, layers.moe)"
SERVING_LATER = ("ROADMAP Queue 1 item 11 (TransformerLM serving: "
                 "init_cache, prefill, decode_step)")
ENCDEC_LATER = "ROADMAP Queue 1 item 11 (EncDecLM, layers.cross_attention)"


class DenseBlock(nn.Module):
    """One layer: attn_norm, attn, mlp_norm, mlp."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.dtype_torch
        self.attn_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        self.attn = L.AttnParams(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, dt, device)
        self.mlp_norm = L.init_rmsnorm(gen, cfg.d_model, dt, device)
        self.mlp = L.MlpParams(gen, cfg.d_model, cfg.d_ff, dt, device)


class TransformerLM(nn.Module):
    """granite / danube / stablelm / phi3 / llava (dense and VLM)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(f"{cfg.name}: MoE layers are not "
                                      f"ported yet: {MOE_LATER}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.vocab_padded = L.pad_vocab(cfg.vocab)
        gen = weights_generator(device, generator)
        dt = cfg.dtype_torch
        self.embed = L.init_embedding(gen, self.vocab_padded, cfg.d_model, dt,
                                      device)
        self.layers = nn.ModuleList(DenseBlock(gen, cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = param(gen, (cfg.d_model,), dt, device,
                                init=ones_init)

    # -- forward --------------------------------------------------------------
    def _block(self, lp: DenseBlock, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(lp.attn_norm, x)
        h = L.full_attention(lp.attn, h, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                             rope_theta=cfg.rope_theta,
                             window=cfg.sliding_window,
                             use_flash=cfg.use_flash,
                             q_chunk=cfg.attn_q_chunk)
        x = x + h
        h = L.rms_norm(lp.mlp_norm, x)
        return x + L.mlp(lp.mlp, h)

    def hidden_states(self, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the layer stack over embedded inputs x: (B, S, d).  Returns
        (final-normed states, aux loss); the dense family's aux is 0."""
        recompute = self.cfg.remat and torch.is_grad_enabled()
        for lp in self.layers:
            if recompute:
                x = checkpoint(self._block, lp, x, use_reentrant=False)
            else:
                x = self._block(lp, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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

    # -- serving (not ported yet) --------------------------------------------
    def cache_capacity(self, seq_len: int) -> int:
        raise NotImplementedError(SERVING_LATER)

    def init_cache(self, batch: int, seq_len: int):
        raise NotImplementedError(SERVING_LATER)

    def prefill(self, batch, seq_len: int):
        raise NotImplementedError(SERVING_LATER)

    def decode_step(self, cache, tokens, cur_pos: int, moe_group=None):
        raise NotImplementedError(SERVING_LATER)
