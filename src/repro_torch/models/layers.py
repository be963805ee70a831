"""The building blocks of the port's language models: every family of
the JAX package (SSM, hybrid, dense, MoE, VLM and encoder-decoder), for
training, evaluation and serving.

Plain functions on tensors, as in ``repro.models.layers``, with the same
layouts (activations ``(B, S, d)``, heads ``(B, S, H, hd)``, weights
``(in, out)``), so that the tests hold each against its JAX counterpart.
The parameters live in small ``nn.Module``s (``AttnParams``,
``MlpParams``) whose fields are the JAX package's ``NamedTuple`` fields
without the leading layer axis.  These are plain matrix products that the
JAX package computes outside any Pallas kernel, so ``torch.matmul`` and
``einsum`` compute them here too, the MoE's expert products included.

Attention: GQA, RoPE, causal masking (or none, for the encoder),
sliding windows, cross attention over a precomputed encoder K/V, and a
ring-buffer KV cache for decode (capacity ``seq_len`` for full
attention).  ``full_attention`` (training and evaluation) has two
routes, chosen by ``use_flash`` as in the JAX package: the hand-written
flash-attention kernel (``kernels.ops.flash_attention``; its plain
version on CPU tensors), or the plain dense / query-chunked products.
The kernel is forward-only, as the JAX package's Pallas kernel is:
training runs the plain route, and a grad-enabled call of the kernel
route raises.
``decode_attention`` writes the new slot into the cache it is given, in
place, where the JAX package returns a new cache: the caller never reads
the old one, and a copy per token would move the whole cache.

MoE: routed top-k with per-group capacity and scatter dispatch into an
``(G, E, C, d)`` buffer, as in the JAX package; dropped tokens (over
capacity) contribute nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.module import ones_init, param


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------
def init_rmsnorm(gen, dim: int, dtype, device) -> nn.Parameter:
    return param(gen, (dim,), dtype, device, init=ones_init)


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
class AttnParams(nn.Module):
    """wq (d, H*hd), wk and wv (d, Kh*hd), wo (H*hd, d)."""

    def __init__(self, gen, d_model: int, n_heads: int, n_kv: int,
                 head_dim: int, dtype, device):
        super().__init__()
        std = d_model ** -0.5
        self.wq = param(gen, (d_model, n_heads * head_dim), dtype, device,
                        stddev=std)
        self.wk = param(gen, (d_model, n_kv * head_dim), dtype, device,
                        stddev=std)
        self.wv = param(gen, (d_model, n_kv * head_dim), dtype, device,
                        stddev=std)
        self.wo = param(gen, (n_heads * head_dim, d_model), dtype, device,
                        stddev=std)


class KVCache(NamedTuple):
    """Unified ring-buffer cache: capacity C = seq_len (full attention)
    or window (SWA).  ``pos`` holds the absolute position stored in each
    slot (-1 = empty); masking uses positions, so full and windowed caches
    share one code path."""
    k: torch.Tensor        # (B, C, Kh, hd)
    v: torch.Tensor        # (B, C, Kh, hd)
    pos: torch.Tensor      # (B, C) int32


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                       device=device),
    )


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _additive(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, -1e30 elsewhere, in float32."""
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill(~ok, -1e30)


def attention_scores(q, k, mask, dtype) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,Kh,hd) -> weights (B,H,Sq,Sk) given the
    additive ``mask`` broadcastable to (B, 1|H, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    Kh = k.shape[2]
    group = H // Kh
    qg = q.reshape(B, Sq, Kh, group, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = logits.reshape(B, Kh * group, Sq, -1) + mask
    return torch.softmax(logits, dim=-1).to(dtype)


def attention_context(w, v) -> torch.Tensor:
    """w: (B,H,Sq,Sk), v: (B,Sk,Kh,hd) -> (B,Sq,H,hd) float32."""
    B, H, Sq, Sk = w.shape
    Kh = v.shape[2]
    group = H // Kh
    wg = w.reshape(B, Kh, group, Sq, Sk)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", wg.float(), v.float())
    return ctx.reshape(B, Sq, H, -1)


def causal_mask(sq: int, sk: int, window: int = 0, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """Additive (1, 1, Sq, Sk) mask.  window=0 -> plain causal."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return _additive(ok)[None, None]


def _chunked_attention(q, k, v, *, causal, window, q_chunk, dtype):
    """Exact attention with the query axis processed in chunks of
    ``q_chunk``: a row's softmax does not depend on other rows, so the
    score buffer is (B, H, q_chunk, Sk).  With a sliding window each
    chunk attends only to its q_chunk + window columns."""
    B, S, H, D = q.shape
    use_kv_slice = bool(window) and window + q_chunk < S
    chunks = []
    for i in range(S // q_chunk):
        q_i = q[:, i * q_chunk:(i + 1) * q_chunk]
        if use_kv_slice:
            kv_len = q_chunk + window
            start = min(max(i * q_chunk - window, 0), S - kv_len)
            k_i = k[:, start:start + kv_len]
            v_i = v[:, start:start + kv_len]
            kpos = start + torch.arange(kv_len, device=q.device)[None, :]
        else:
            k_i, v_i = k, v
            kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        ok = torch.ones((q_chunk, kpos.shape[1]), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        w = attention_scores(q_i, k_i, _additive(ok)[None, None], dtype)
        chunks.append(attention_context(w, v_i).to(dtype))
    return torch.cat(chunks, dim=1)


def full_attention(p: AttnParams, x, *, n_heads, n_kv, head_dim, rope_theta,
                   window=0, use_flash=False, causal=True, q_chunk=0):
    """Training / evaluation self-attention over the full sequence, causal
    or (``causal=False``, the encoder's) over every position.

    ``use_flash`` routes through the flash-attention kernel (forward only);
    otherwise ``q_chunk`` > 0 and S > 2*q_chunk routes through exact
    chunked attention (memory O(S * q_chunk) instead of O(S^2)), and the
    rest through dense attention.  The JAX package's unused layer index
    ``li``, its ``flash_interpret`` switch and its ``positions`` argument
    (no caller passes it) have no counterpart."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(x @ p.wq, n_heads, head_dim)
    k = _split_heads(x @ p.wk, n_kv, head_dim)
    v = _split_heads(x @ p.wv, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if use_flash:
        from repro_torch.kernels import ops as kops
        ctx = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif q_chunk and S > 2 * q_chunk and S % q_chunk == 0:
        ctx = _chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, dtype=x.dtype)
    else:
        mask = (causal_mask(S, S, window, device=x.device) if causal else
                torch.zeros((1, 1, 1, S), device=x.device))
        w = attention_scores(q, k, mask, x.dtype)
        ctx = attention_context(w, v).to(x.dtype)
    return ctx.reshape(B, S, n_heads * head_dim) @ p.wo


def prefill_attention(p: AttnParams, x, capacity: int, *, n_heads, n_kv,
                      head_dim, rope_theta, window=0, q_chunk=0):
    """Full-sequence attention that also fills a fresh KV cache (ring
    layout, capacity ``capacity``)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(x @ p.wq, n_heads, head_dim)
    k = _split_heads(x @ p.wk, n_kv, head_dim)
    v = _split_heads(x @ p.wv, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if q_chunk and S > 2 * q_chunk and S % q_chunk == 0:
        ctx = _chunked_attention(q, k, v, causal=True, window=window,
                                 q_chunk=q_chunk, dtype=x.dtype)
    else:
        mask = causal_mask(S, S, window, device=x.device)
        w = attention_scores(q, k, mask, x.dtype)
        ctx = attention_context(w, v).to(x.dtype)
    out = ctx.reshape(B, S, n_heads * head_dim) @ p.wo

    C = capacity
    if S >= C:
        # keep the last C entries, each at ring slot (pos % C)
        pc = torch.arange(S - C, S, dtype=torch.int32, device=x.device)
        order = torch.argsort(pc % C)
        new = KVCache(k[:, S - C:][:, order].contiguous(),
                      v[:, S - C:][:, order].contiguous(),
                      pc[order][None].expand(B, C).contiguous())
    else:
        pad = C - S
        kc = F.pad(k, (0, 0, 0, 0, 0, pad))
        vc = F.pad(v, (0, 0, 0, 0, 0, pad))
        pc = torch.cat([
            torch.arange(S, dtype=torch.int32, device=x.device)[None]
            .expand(B, S),
            torch.full((B, pad), -1, dtype=torch.int32, device=x.device)],
            dim=1)
        new = KVCache(kc, vc, pc)
    return out, new


def decode_attention(p: AttnParams, x, cache: KVCache, cur_pos: int, *,
                     n_heads, n_kv, head_dim, rope_theta, window=0):
    """One-token decode: write (k, v) at slot cur_pos % C of ``cache`` (in
    place) and attend over the cache.

    x: (B, 1, d); cur_pos: int, the same position across the batch."""
    B = x.shape[0]
    C = cache.k.shape[1]
    pos_b = torch.full((B, 1), cur_pos, dtype=torch.int32, device=x.device)
    q = _split_heads(x @ p.wq, n_heads, head_dim)
    k = _split_heads(x @ p.wk, n_kv, head_dim)
    v = _split_heads(x @ p.wv, n_kv, head_dim)
    q = apply_rope(q, pos_b, rope_theta)
    k = apply_rope(k, pos_b, rope_theta)

    slot = cur_pos % C
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[:, slot] = cur_pos
    cp = cache.pos

    valid = (cp >= 0) & (cp <= cur_pos)
    if window:
        valid &= cp > cur_pos - window
    mask = _additive(valid)[:, None, None, :]                # (B,1,1,C)
    w = attention_scores(q, cache.k, mask, x.dtype)
    ctx = attention_context(w, cache.v).to(x.dtype)
    out = ctx.reshape(B, 1, n_heads * head_dim) @ p.wo
    return out, cache


def cross_attention(p: AttnParams, x, enc_kv, *, n_heads, n_kv, head_dim):
    """Decoder -> encoder attention over the precomputed ``enc_kv`` = (k,
    v), each (B, Se, Kh, hd): no rope and no mask over the encoder."""
    B, S, _ = x.shape
    q = _split_heads(x @ p.wq, n_heads, head_dim)
    k, v = enc_kv
    mask = torch.zeros((1, 1, 1, k.shape[1]), device=x.device)
    w = attention_scores(q, k, mask, x.dtype)
    ctx = attention_context(w, v).to(x.dtype)
    return ctx.reshape(B, S, n_heads * head_dim) @ p.wo


def encode_cross_kv(p: AttnParams, enc_out, *, n_kv, head_dim):
    """The cross attention's (k, v) of the encoder's output (B, Se, d)."""
    return (_split_heads(enc_out @ p.wk, n_kv, head_dim),
            _split_heads(enc_out @ p.wv, n_kv, head_dim))


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MlpParams(nn.Module):
    """w_gate and w_up (d, ff), w_down (ff, d)."""

    def __init__(self, gen, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = param(gen, (d_model, d_ff), dtype, device,
                            stddev=d_model ** -0.5)
        self.w_up = param(gen, (d_model, d_ff), dtype, device,
                          stddev=d_model ** -0.5)
        self.w_down = param(gen, (d_ff, d_model), dtype, device,
                            stddev=d_ff ** -0.5)


def mlp(p: MlpParams, x: torch.Tensor) -> torch.Tensor:
    h = F.silu((x @ p.w_gate).float()).to(x.dtype) * (x @ p.w_up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# Mixture of Experts (routed top-k, per-group capacity, scatter dispatch)
# ---------------------------------------------------------------------------
class MoeParams(nn.Module):
    """The reference's ``init_moe``: w_router (d, E) in float32 whatever
    the model's dtype, w_gate and w_up (E, d, ff), w_down (E, ff, d), and
    ``shared``, the shared experts as one fused ``MlpParams`` (None
    without shared experts).  ``n_experts`` routed experts are stored as
    E = max(n_experts, pad_experts_to); the padding experts are never
    routed."""

    def __init__(self, gen, d_model: int, n_experts: int, expert_ff: int,
                 n_shared: int, dtype, device, pad_experts_to: int = 0):
        super().__init__()
        E = max(n_experts, pad_experts_to)
        std = d_model ** -0.5
        self.shared = (MlpParams(gen, d_model, n_shared * expert_ff, dtype,
                                 device) if n_shared else None)
        self.w_router = param(gen, (d_model, E), torch.float32, device,
                              stddev=std)
        self.w_gate = param(gen, (E, d_model, expert_ff), dtype, device,
                            stddev=std)
        self.w_up = param(gen, (E, d_model, expert_ff), dtype, device,
                          stddev=std)
        self.w_down = param(gen, (E, expert_ff, d_model), dtype, device,
                            stddev=expert_ff ** -0.5)


class MoeRouting(NamedTuple):
    """Where ``moe`` sends each of a group's T*k (token, choice) pairs, in
    token-major order."""
    top_p: torch.Tensor      # (G, T, K) renormalised router weights
    top_e: torch.Tensor      # (G, T, K) chosen experts, best first
    aux: torch.Tensor        # () float32 Switch load-balance loss
    slot: torch.Tensor       # (G, T*K) slot in the expert, min(pos, C-1)
    keep: torch.Tensor       # (G, T*K) pos < C: the pair is not dropped
    capacity: int            # C, slots per expert and group


def moe_routing(p: MoeParams, xg: torch.Tensor, *, n_experts: int,
                top_k: int, capacity_factor: float = 1.25) -> MoeRouting:
    """The router of ``moe`` on its routing groups ``xg`` (G, T, d):
    float32 logits (padding experts at -1e30), softmax, top-k
    renormalised, the aux loss, and each pair's capacity slot.  The top-k
    is a stable sort, so tied experts come lowest index first, as
    ``lax.top_k`` gives them."""
    G, T = xg.shape[0], xg.shape[1]
    E = p.w_gate.shape[0]
    logits = xg.float() @ p.w_router                         # (G, T, E)
    if E > n_experts:
        pad = torch.arange(E, device=xg.device) >= n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]   # (G, T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch-style): E * sum(f_e * p_e)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e, E).sum(2).float().mean(dim=(0, 1)) / top_k
    aux = n_experts * torch.sum(me * ce)

    C = max(1, math.ceil(T * top_k * capacity_factor / n_experts))
    e_flat = top_e.reshape(G, T * top_k)                     # (G, TK)
    oh = F.one_hot(e_flat, E)                                # (G, TK, E)
    pos = torch.cumsum(oh, dim=1) - oh
    pos_sel = torch.gather(pos, -1, e_flat[..., None])[..., 0]
    return MoeRouting(top_p, top_e, aux, pos_sel.clamp_max(C - 1),
                      pos_sel < C, C)


def expert_matmul_f32(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``buf`` (G, E, C, d) @ ``w`` (E, d, f) -> (G, E, C, f) in float32:
    the products of the input dtype's values summed in float32 and never
    rounded to the input dtype.  On the card a bf16/f16 product asks
    cuBLAS for float32 output (``out_dtype``), so no float32 copy of the
    experts' weights is made; the CPU has no such product and widens both
    operands."""
    G, E, C, d = buf.shape
    a = buf.transpose(0, 1).reshape(E, G * C, d)
    if a.dtype == torch.float32:
        h = torch.bmm(a, w)
    elif a.is_cuda:
        h = torch.bmm(a, w, out_dtype=torch.float32)
    else:
        h = torch.bmm(a.float(), w.float())
    return h.reshape(E, G, C, -1).transpose(0, 1)


def moe(p: MoeParams, x: torch.Tensor, *, n_experts: int, top_k: int,
        capacity_factor: float = 1.25, group_tokens: bool = False):
    """Routed MoE.  x: (B, S, d) -> (y, aux_loss).

    Routing groups are batch rows; with ``group_tokens`` the whole (B*S)
    token stream forms one routing group.  Only the first ``n_experts``
    experts are routable.  Each group's expert e holds C =
    ceil(T*k*cf / n_experts) tokens, taken in token-major (T*k) order;
    the rest are dropped (``moe_routing``).  The reference adds each
    token into its slot; a kept (e, slot) pair is unique and a dropped
    one adds zero, so a masked write of the kept pairs gives the same
    buffer.  The gate product comes out in float32 before the SiLU, as
    the reference's ``preferred_element_type=float32`` asks
    (``expert_matmul_f32``); the up and down products are in the input
    dtype."""
    B, S, d = x.shape
    E = p.w_gate.shape[0]
    xg = x.reshape(1, B * S, d) if group_tokens else x
    G, T = xg.shape[0], xg.shape[1]
    r = moe_routing(p, xg, n_experts=n_experts, top_k=top_k,
                    capacity_factor=capacity_factor)
    C = r.capacity
    e_flat = r.top_e.reshape(G, T * top_k)

    # kept pairs to their (g, e, slot) row, dropped ones to a spare last row
    g_idx = torch.arange(G, device=x.device)[:, None]
    dest = torch.where(r.keep, (g_idx * E + e_flat) * C + r.slot, G * E * C)
    buf = torch.zeros((G * E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest.reshape(-1)] = xg.repeat_interleave(top_k, dim=1).reshape(-1, d)
    buf = buf[:-1].reshape(G, E, C, d)

    h = F.silu(expert_matmul_f32(buf, p.w_gate))
    h = h.to(x.dtype) * torch.einsum("gecd,edf->gecf", buf, p.w_up)
    y_buf = torch.einsum("gecf,efd->gecd", h, p.w_down)

    y_tok = y_buf[g_idx, e_flat, r.slot] * r.keep[..., None].to(x.dtype)
    y = (y_tok.reshape(G, T, top_k, d)
         * r.top_p[..., None].to(y_tok.dtype)).sum(dim=2)
    y = y.reshape(B, S, d)
    if p.shared is not None:
        y = y + mlp(p.shared, x)
    return y, r.aux


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def init_embedding(gen, vocab: int, d_model: int, dtype,
                   device) -> nn.Parameter:
    return param(gen, (vocab, d_model), dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def logits_head(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: (B, S, d) @ (V, d)^T -> (B, S, V)."""
    return x @ table.t()


def pad_vocab(vocab: int, multiple: int = 128) -> int:
    return int(math.ceil(vocab / multiple) * multiple)


def nll_loss(table, h, labels, vocab: int, vocab_padded: int,
             seq_chunk: int = 0) -> torch.Tensor:
    """Next-token NLL (float32 scalar) of the tied head over ``h`` (B, S,
    d) against ``labels`` (B, S); labels < 0 are ignored, and the padded
    vocabulary entries are masked to -1e30.  With ``seq_chunk`` > 0 the
    (B, S, V) logits are never materialized whole: the sequence goes in
    chunks, each recomputed in the backward pass when autograd records."""
    S = h.shape[1]
    pad = (torch.arange(vocab_padded, device=h.device) >= vocab
           if vocab_padded > vocab else None)

    def chunk_nll(h_i, lab_i):
        logits = logits_head(table, h_i).float()
        if pad is not None:
            logits = logits.masked_fill(pad, -1e30)
        lp = torch.log_softmax(logits, dim=-1)
        # an ignored label (< 0) reads entry 0; the mask zeroes it
        idx = lab_i.long().clamp_min(0)[..., None]
        tgt = torch.gather(lp, -1, idx)[..., 0]
        mask = (lab_i >= 0).float()
        return (tgt * mask).sum(), mask.sum()

    if seq_chunk and S > seq_chunk and S % seq_chunk == 0:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(S // seq_chunk):
            sl = slice(i * seq_chunk, (i + 1) * seq_chunk)
            if torch.is_grad_enabled():
                t, c = checkpoint(chunk_nll, h[:, sl], labels[:, sl],
                                  use_reentrant=False)
            else:
                t, c = chunk_nll(h[:, sl], labels[:, sl])
            tot, cnt = tot + t, cnt + c
        return -tot / cnt.clamp_min(1.0)
    tot, cnt = chunk_nll(h, labels)
    return -tot / cnt.clamp_min(1.0)


def lm_loss(table, h, labels, vocab: int, vocab_padded: int,
            seq_chunk: int = 0, aux: Optional[torch.Tensor] = None):
    """A language model's loss over the final-normed states ``h``: (nll +
    0.01 aux, {"nll", "aux"}), as the reference's models return it; aux
    is 0 for the families without a MoE router (``aux=None``)."""
    nll = nll_loss(table, h, labels, vocab, vocab_padded, seq_chunk)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return nll, {"nll": nll, "aux": aux}
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}
