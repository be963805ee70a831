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

Activation layouts are annotated with logical axis names through
``repro_torch.dist.sharding.constrain``, at the reference's places: the
identity without an active mesh, so every single-device path is
unchanged, and a DTensor redistribution inside ``use_mesh``.  On a mesh
the MoE (top-k sort, one-hot, cumsum, scatter and gather, which have no
DTensor sharding rule) runs on each rank's shards through ``local_map``,
the embedding lookup on the table's own shards (``_embed_on_shards``:
only the tokens move); attention runs on each rank's shards in
the reference's layout (``attend``).  The weight products keep the
reference's tensor-parallel split: a weight's FSDP split alone is made
whole (``fsdp_whole``), a column-parallel product (``columns``) gives
each 'model' rank its columns and a row-parallel one a partial sum that
the next ``constrain`` reduces, and the products' input gradients are
summed once (``grad_as_input``).  The loss reduces its log-softmax over
the ranks' slices of the vocabulary (``nll_loss``).  A mesh of one rank
takes the plain products.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (constrain, fsdp_whole, gathered,
                                      on_mesh)
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
    AXES = {"wq": ("embed", "qkv"), "wk": ("embed", "qkv"),
            "wv": ("embed", "qkv"), "wo": ("qkv", "embed")}

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
    """(..., n*hd) -> (..., n, hd).  On a mesh a last dim sharded over
    ranks that do not divide ``n`` is gathered first: DTensor cannot split
    a dim into parts whose leading one the ranks do not divide."""
    if isinstance(x, DTensor):
        x = _gather_dim_unless_divides(x, x.dim() - 1, n)
    return x.reshape(x.shape[:-1] + (n, hd))


def _merge_heads(ctx: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n, hd) -> (..., n*hd), laid out as ``wo``'s rows ("qkv").  On
    a mesh a split ``head_dim`` is gathered first: the merged dim of a
    split minor dim is no contiguous shard, and the product with ``wo``
    has no sharding rule for it.  The merged tensor is then split again
    by ``wo``'s rows (each rank keeps its slice: no data moves), so the
    row-parallel product and its weight's gradient run on the rank's
    rows, and the gradient, gathered back, splits into heads."""
    if isinstance(ctx, DTensor):
        ctx = _gather_dim_unless_divides(ctx, ctx.dim() - 1, 1)
    out = ctx.reshape(ctx.shape[:-2] + (n * hd,))
    return constrain(out, "batch", "seq", "qkv") if _splits(out) else out


def _splits(x) -> bool:
    """``x`` is a DTensor on a mesh of more than one rank."""
    return isinstance(x, DTensor) and x.device_mesh.size() > 1


class _GradAsInput(torch.autograd.Function):
    """The identity, whose gradient is laid out as its input is."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.layout
        if isinstance(g, DTensor) and tuple(g.placements) != placements:
            g = g.redistribute(mesh, placements)
        return g


def grad_as_input(x):
    """``x``, whose gradient is laid out as ``x`` is: one that arrives as
    partial sums over ranks is summed here, one split where ``x`` is
    whole is gathered.  On the input of column-parallel products
    (``columns``), whose input gradients are partial sums over the ranks'
    columns: they are summed once (all-reduced in the backward pass), as
    the reference's compiled backward does, not carried on as partial
    sums that DTensor would meet in the products before them by gathering
    their weights whole.  The identity off a mesh of more than one rank
    and without autograd; idempotent."""
    if not _splits(x) or not torch.is_grad_enabled():
        return x
    return _GradAsInput.apply(x)


def columns(x, axis: str, *ws) -> Tuple[torch.Tensor, ...]:
    """The column-parallel products ``x @ w`` of activations (B, S, d)
    with each weight (d, n) of ``ws``, whose columns the logical ``axis``
    names.  On a mesh of more than one rank ``x`` comes through
    ``grad_as_input`` once, each ``w``'s FSDP split is made whole
    (``fsdp_whole``) and each output is constrained to ("batch", "seq",
    ``axis``) at once: each rank computes its own columns and nothing
    moves, as in the reference's compiled products."""
    if not _splits(x):
        return tuple(x @ w for w in ws)
    x = grad_as_input(x)
    return tuple(constrain(x @ fsdp_whole(w), "batch", "seq", axis)
                 for w in ws)


def _qkv(p: AttnParams, x, n_heads: int, n_kv: int, head_dim: int):
    """q (B, S, H, hd), k and v (B, S, Kh, hd): the column-parallel
    products of ``x`` with ``wq``, ``wk`` and ``wv``."""
    q, k, v = columns(x, "qkv", p.wq, p.wk, p.wv)
    return (_split_heads(q, n_heads, head_dim),
            _split_heads(k, n_kv, head_dim), _split_heads(v, n_kv, head_dim))


def _gather_dim_unless_divides(x: DTensor, dim: int, n: int) -> DTensor:
    """``x`` with ``dim`` replicated when the ranks sharding it do not
    divide ``n``."""
    mesh, placements = x.device_mesh, tuple(x.placements)
    ranks = math.prod(mesh.size(i) for i, p in enumerate(placements)
                      if p.is_shard(dim))
    if n % ranks == 0:
        return x
    return x.redistribute(mesh, tuple(Replicate() if p.is_shard(dim) else p
                                      for p in placements))


def _additive(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, -1e30 elsewhere, in float32 (laid out as ``ok`` on
    a mesh)."""
    return torch.zeros_like(ok, dtype=torch.float32).masked_fill(~ok, -1e30)


def _logits(q, k, hd: int) -> torch.Tensor:
    """q: (B,Sq,H,d), k: (B,Sk,Kh,d) -> float32 logits (B,H,Sq,Sk) scaled
    by 1/sqrt(hd) (``hd`` the whole head dim: d is a rank's slice of it
    when the head dim is split)."""
    B, Sq, H, d = q.shape
    Kh = k.shape[2]
    group = H // Kh
    qg = q.reshape(B, Sq, Kh, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    return logits.reshape(B, Kh * group, Sq, -1)


def attention_scores(q, k, mask, dtype) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,Kh,hd) -> weights (B,H,Sq,Sk) given the
    additive ``mask`` broadcastable to (B, 1|H, Sq, Sk)."""
    logits = _logits(q, k, q.shape[-1]) + mask
    return torch.softmax(logits, dim=-1).to(dtype)


def attention_context(w, v) -> torch.Tensor:
    """w: (B,H,Sq,Sk), v: (B,Sk,Kh,hd) -> (B,Sq,H,hd) float32."""
    B, H, Sq, Sk = w.shape
    Kh = v.shape[2]
    group = H // Kh
    wg = w.reshape(B, Kh, group, Sq, Sk)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", wg.float(), v.float())
    return ctx.reshape(B, Sq, H, -1)


def _attend_plain(q, k, v, mask, dtype) -> torch.Tensor:
    return attention_context(attention_scores(q, k, mask, dtype), v).to(dtype)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a DTensor built on
    a permuted local gradient fails the views of the backward pass."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _all_reduce(x: torch.Tensor, op: str, group: str) -> torch.Tensor:
    """``x`` reduced by ``op`` ("sum", "max") over the ranks of the process
    group named ``group`` (a functional collective, as DTensor issues)."""
    out = torch.ops._c10d_functional.all_reduce(x.contiguous(), op, group)
    return torch.ops._c10d_functional.wait_tensor(out)


class _SumOverRanks(torch.autograd.Function):
    """The sum over a group's ranks of partial values whose gradients are
    partial too: each rank's gradient covers only its own downstream
    share, so the backward pass sums the gradients as well."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _Layout(NamedTuple):
    """How ``attend`` splits each mesh dim (size > 1) among the ranks:
    "batch" (q, k, v and a per-row mask split by rows), "heads" (q's
    heads; k and v split alike where the ranks divide Kh, else whole),
    "head_dim" (q, k and v split on dim 3: partial logits, summed),
    "kv_seq" (k, v and the mask split by key position: split-K) or
    "whole"."""
    mesh: object
    modes: Tuple[str, ...]
    kv_aligned: bool       # "heads" splits k and v too
    hd: int                # the whole head dim: the logits' scale

    def groups(self, mode: str):
        """The process groups of the mesh dims split as ``mode``."""
        return [self.mesh.get_group(i).group_name
                for i, m in enumerate(self.modes) if m == mode]


def _attend_layout(q: DTensor, k, mask, split_keys: bool = True
                   ) -> _Layout:
    """The reference's layout for one attention call: each mesh dim keeps
    the split its inputs carry (k's ``kv_seq`` first, unless
    ``split_keys`` is off, then the batch, the head dim and q's heads)
    where the ranks divide what they split."""
    mesh = q.device_mesh
    kp = k.placements if isinstance(k, DTensor) else \
        (Replicate(),) * mesh.ndim
    B, H, hd, Sk = q.shape[0], q.shape[2], q.shape[3], k.shape[1]
    modes = []
    for i, (qp, p) in enumerate(zip(q.placements, kp)):
        if mesh.size(i) == 1:
            modes.append("whole")
        elif p.is_shard(1) and split_keys:
            modes.append("kv_seq")
        elif qp.is_shard(0) or p.is_shard(0):
            modes.append("batch")
        elif qp.is_shard(3) or p.is_shard(3):
            modes.append("head_dim")
        elif qp.is_shard(2) or p.is_shard(2):
            modes.append("heads")
        else:
            modes.append("whole")

    def ranks(mode):
        return math.prod(mesh.size(i) for i, m in enumerate(modes)
                         if m == mode)

    size = {"batch": B, "heads": H, "head_dim": hd, "kv_seq": Sk}
    for mode, n in size.items():
        if n % ranks(mode) or (mode == "batch" and mask is not None and
                               mask.shape[0] not in (1, B)):
            modes = [("whole" if m == mode else m) for m in modes]
    return _Layout(mesh, tuple(modes), k.shape[2] % ranks("heads") == 0, hd)


def _placements(lay: _Layout, of: str, mask_shape=None):
    """Per-mesh-dim placements of q (and the output), k and v, or the
    mask."""
    dims = {"q": {"batch": 0, "heads": 2, "head_dim": 3},
            "kv": {"batch": 0, "head_dim": 3, "kv_seq": 1,
                   **({"heads": 2} if lay.kv_aligned else {})},
            "mask": {"batch": 0, "heads": 1, "kv_seq": 3}}[of]
    out = []
    for m in lay.modes:
        d = dims.get(m)
        if of == "mask" and d is not None and mask_shape[d] == 1:
            d = None
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


def _kv_for_heads(kv, first: int, n: int, group: int):
    """The kv heads of q heads ``first .. first+n-1`` (kv head h // group
    serves q head h): the slice of them when each serves the same number
    of the n heads in order, else one kv head per q head."""
    want = [(first + j) // group for j in range(n)]
    lo, span = want[0], want[-1] - want[0] + 1
    if n % span == 0 and want == [lo + j // (n // span) for j in range(n)]:
        return kv[:, :, lo:lo + span]
    return kv[:, :, want]


def _to_ranks(q: DTensor, k, v, mask, split_keys: bool = True):
    """(layout, and this rank's q, k, v and mask) of an attention call on
    a mesh; ``mask`` None stays None.  k and v left whole under "heads"
    are cut to the kv heads of the rank's q heads, and their gradients
    marked partial sums over those ranks."""
    lay = _attend_layout(q, k, mask, split_keys)
    mesh, modes = lay.mesh, lay.modes
    if "kv_seq" in modes and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "attention over a key sequence split among ranks (split-K) is "
            "forward-only: decode under torch.no_grad()")
    if not isinstance(k, DTensor):
        k, v = (on_mesh(t, mesh) for t in (k, v))
    kvpl = _placements(lay, "kv")
    kv_grad = tuple(Partial() if m == "heads" and not lay.kv_aligned else p
                    for m, p in zip(modes, kvpl))
    ql = q.redistribute(mesh, _placements(lay, "q")).to_local()
    kl, vl = (t.redistribute(mesh, kvpl).to_local(grad_placements=kv_grad)
              for t in (k, v))
    ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
    if "heads" in modes and not lay.kv_aligned:
        block, coord = 0, mesh.get_coordinate()
        for i, m in enumerate(modes):
            if m == "heads":
                block = block * mesh.size(i) + coord[i]
        n, group = ql.shape[2], q.shape[2] // k.shape[2]
        kl, vl = (_kv_for_heads(t, block * n, n, group) for t in (kl, vl))
    ml = None
    if mask is not None:
        mask = mask if isinstance(mask, DTensor) else on_mesh(mask, mesh)
        ml = mask.redistribute(mesh, _placements(lay, "mask", mask.shape)
                               ).to_local()
    return lay, ql, kl, vl, ml


def _attend_split_k(q, k, v, mask, dtype, hd: int, groups,
                    hd_groups=()) -> torch.Tensor:
    """Attention over keys split among the ranks of ``groups``, merged as
    in split-K (flash-decoding): the global row max, then the sums of
    exp(s - max) and of the unnormalised contexts, O(B·H·hd) bytes.  The
    logits of a head dim split over ``hd_groups`` are summed first."""
    logits = _logits(q, k, hd)                          # (B,H,Sq,Sk_rank)
    for g in hd_groups:
        logits = _all_reduce(logits, "sum", g)
    logits = logits + mask
    m = logits.amax(dim=-1, keepdim=True)
    for g in groups:
        m = _all_reduce(m, "max", g)
    p = torch.exp(logits - m)
    ctx = attention_context(p, v)                       # (B,Sq,H,hd) f32
    lsum = p.sum(dim=-1).transpose(1, 2)[..., None]     # (B,Sq,H,1)
    both = torch.cat([ctx, lsum], dim=-1)
    for g in groups:
        both = _all_reduce(both, "sum", g)
    return (both[..., :-1] / both[..., -1:]).to(dtype)


def _attend_ranks(lay: _Layout, q, k, v, mask, dtype) -> torch.Tensor:
    """One rank's attention on its local q, k, v and mask (``_to_ranks``)
    in the layout ``lay``."""
    keys, dims = lay.groups("kv_seq"), lay.groups("head_dim")
    if keys:
        return _attend_split_k(q, k, v, mask, dtype, lay.hd, keys, dims)
    if not dims:
        return _attend_plain(q, k, v, mask, dtype)
    logits = _logits(q, k, lay.hd)
    for g in dims:
        logits = _SumOverRanks.apply(logits, g)
    w = torch.softmax(logits + mask, dim=-1).to(dtype)
    return attention_context(w, v).to(dtype)


def _from_ranks(lay: _Layout, out: torch.Tensor) -> DTensor:
    """The (B, Sq, H, hd) DTensor of each rank's attention output."""
    return DTensor.from_local(out.contiguous(), lay.mesh,
                              _placements(lay, "q"), run_check=False)


def attend(q, k, v, mask, dtype) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, hd) over k, v (B, Sk, Kh, hd)
    under the additive 4-d ``mask`` (B|1, 1, Sq|1, Sk): (B, Sq, H, hd) in
    ``dtype``.

    On a mesh each rank attends on its shards, in the reference's layout
    (``_attend_layout``): nothing the reference leaves split is gathered.
    The scores' reshapes flatten the heads into the batch, which DTensor
    refuses on a split dim, so the products run on local tensors:

    - "heads": a rank's H/m q heads attend over the kv heads they read
      (h // (H/Kh)); where the ranks do not divide Kh, k and v stay whole
      on every rank and their gradients are partial sums (reduced by
      DTensor where they meet the whole tensors).
    - "head_dim": the logits are partial sums over the slices of the head
      dim, summed over the ranks (forward and backward) before the mask
      and the softmax; the context is the rank's slice.
    - "kv_seq": split-K over the ranks' key positions
      (``_attend_split_k``).  Decode runs it without gradients; a
      grad-enabled call whose inputs require grad raises.
    - "batch": rows are independent; a per-row mask is split alike.

    A mesh dim of size 1 splits nothing, so on a one-rank mesh this is
    ``_attend_plain`` on the whole tensors, bitwise."""
    if not isinstance(q, DTensor):
        return _attend_plain(q, k, v, mask, dtype)
    lay, ql, kl, vl, ml = _to_ranks(q, k, v, mask)
    return _from_ranks(lay, _attend_ranks(lay, ql, kl, vl, ml, dtype))


def causal_mask(sq: int, sk: int, window: int = 0, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """Additive (1, 1, Sq, Sk) mask.  window=0 -> plain causal."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return _additive(ok)[None, None]


def _chunked_attention(q, k, v, *, causal, window, q_chunk, dtype,
                       attend_fn=attend):
    """Exact attention with the query axis processed in chunks of
    ``q_chunk``: a row's softmax does not depend on other rows, so the
    score buffer is (B, H, q_chunk, Sk).  With a sliding window each
    chunk attends only to its q_chunk + window columns.  On a mesh the
    chunks run on each rank's shards in one layout, so the partial
    gradients of whole k and v are reduced once, not once a chunk."""
    if isinstance(q, DTensor):
        lay, ql, kl, vl, _ = _to_ranks(q, k, v, None, split_keys=False)
        return _from_ranks(lay, _chunked_attention(
            ql, kl, vl, causal=causal, window=window, q_chunk=q_chunk,
            dtype=dtype, attend_fn=functools.partial(_attend_ranks, lay)))
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
        chunks.append(attend_fn(q_i, k_i, v_i, _additive(ok)[None, None],
                                dtype))
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
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    q = constrain(q, "attn_batch", "seq", "heads", "head_dim")
    k = constrain(k, "attn_batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "attn_batch", "seq", "kv_heads", "head_dim")
    if use_flash:
        from repro_torch.kernels import ops as kops
        ctx = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif q_chunk and S > 2 * q_chunk and S % q_chunk == 0:
        ctx = _chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, dtype=x.dtype)
    else:
        mask = (causal_mask(S, S, window, device=x.device) if causal else
                torch.zeros((1, 1, 1, S), device=x.device))
        ctx = attend(q, k, v, mask, x.dtype)
    ctx = constrain(ctx, "batch", "seq", "heads", "head_dim")
    out = _merge_heads(ctx, n_heads, head_dim) @ fsdp_whole(p.wo)
    return constrain(out, "batch", "seq", "embed")


def prefill_attention(p: AttnParams, x, capacity: int, *, n_heads, n_kv,
                      head_dim, rope_theta, window=0, q_chunk=0):
    """Full-sequence attention that also fills a fresh KV cache (ring
    layout, capacity ``capacity``)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    if q_chunk and S > 2 * q_chunk and S % q_chunk == 0:
        ctx = _chunked_attention(q, k, v, causal=True, window=window,
                                 q_chunk=q_chunk, dtype=x.dtype)
    else:
        mask = causal_mask(S, S, window, device=x.device)
        ctx = attend(q, k, v, mask, x.dtype)
    out = _merge_heads(ctx, n_heads, head_dim) @ fsdp_whole(p.wo)

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
    return constrain(out, "batch", "seq", "embed"), new


def decode_attention(p: AttnParams, x, cache: KVCache, cur_pos: int, *,
                     n_heads, n_kv, head_dim, rope_theta, window=0):
    """One-token decode: write (k, v) at slot cur_pos % C of ``cache`` (in
    place) and attend over the cache.

    x: (B, 1, d); cur_pos: int, the same position across the batch."""
    B = x.shape[0]
    C = cache.k.shape[1]
    pos_b = torch.full((B, 1), cur_pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    q = apply_rope(q, pos_b, rope_theta)
    k = apply_rope(k, pos_b, rope_theta)

    slot = cur_pos % C
    _write_slot(cache.k, slot, k[:, 0])
    _write_slot(cache.v, slot, v[:, 0])
    _write_slot(cache.pos, slot, cur_pos)
    cp = cache.pos
    ck = constrain(cache.k, "batch", "kv_seq", "kv_heads", "head_dim")
    cv = constrain(cache.v, "batch", "kv_seq", "kv_heads", "head_dim")

    valid = (cp >= 0) & (cp <= cur_pos)
    if window:
        valid &= cp > cur_pos - window
    mask = _additive(valid)[:, None, None, :]      # (B,1,1,C)
    ctx = attend(q, ck, cv, mask, x.dtype)
    out = _merge_heads(ctx, n_heads, head_dim) @ fsdp_whole(p.wo)
    return constrain(out, "batch", None, "embed"), cache


def _shard_range(x: DTensor, dim: int) -> Tuple[int, int]:
    """(start, length) of this rank's shard of ``x``'s ``dim``: split by
    each mesh dim that splits it, in mesh order, into DTensor's chunks
    (the last ones may be shorter)."""
    start, length = 0, x.shape[dim]
    coord = x.device_mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            chunk = -(-length // x.device_mesh.size(i))
            lo = min(coord[i] * chunk, length)
            start, length = start + lo, min(chunk, length - lo)
    return start, length


def _write_slot(buf, slot: int, value) -> None:
    """``buf[:, slot] = value``, in place.  On a mesh (``buf`` a DTensor)
    each rank writes its own shard: the rank whose shard of dim 1 holds
    ``slot`` writes its shard of ``value`` (laid out as ``buf`` without
    dim 1) there; the others hold no copy of that slot."""
    if not isinstance(buf, DTensor):
        buf[:, slot] = value
        return
    mesh, placements = buf.device_mesh, tuple(buf.placements)
    local = buf.to_local()
    start, length = _shard_range(buf, 1)
    if isinstance(value, DTensor):       # every rank: a collective
        value = value.redistribute(mesh, tuple(
            Replicate() if p.is_shard(1) else
            Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
            for p in placements)).to_local()
    if start <= slot < start + length:
        local[:, slot - start] = value


def cross_attention(p: AttnParams, x, enc_kv, *, n_heads, n_kv, head_dim):
    """Decoder -> encoder attention over the precomputed ``enc_kv`` = (k,
    v), each (B, Se, Kh, hd): no rope and no mask over the encoder."""
    q = _split_heads(columns(x, "qkv", p.wq)[0], n_heads, head_dim)
    k, v = enc_kv
    mask = torch.zeros((1, 1, 1, k.shape[1]), device=x.device)
    ctx = attend(q, k, v, mask, x.dtype)
    out = _merge_heads(ctx, n_heads, head_dim) @ fsdp_whole(p.wo)
    return constrain(out, "batch", "seq", "embed")


def encode_cross_kv(p: AttnParams, enc_out, *, n_kv, head_dim):
    """The cross attention's (k, v) of the encoder's output (B, Se, d)."""
    k, v = columns(enc_out, "qkv", p.wk, p.wv)
    return _split_heads(k, n_kv, head_dim), _split_heads(v, n_kv, head_dim)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MlpParams(nn.Module):
    """w_gate and w_up (d, ff), w_down (ff, d)."""
    AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}

    def __init__(self, gen, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = param(gen, (d_model, d_ff), dtype, device,
                            stddev=d_model ** -0.5)
        self.w_up = param(gen, (d_model, d_ff), dtype, device,
                          stddev=d_model ** -0.5)
        self.w_down = param(gen, (d_ff, d_model), dtype, device,
                            stddev=d_ff ** -0.5)


def mlp(p: MlpParams, x: torch.Tensor) -> torch.Tensor:
    gate, up = columns(x, "mlp", p.w_gate, p.w_up)
    h = F.silu(gate.float()).to(x.dtype) * up
    h = constrain(h, "batch", "seq", "mlp")
    return constrain(h @ fsdp_whole(p.w_down), "batch", "seq", "embed")


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
    AXES = {"w_router": ("embed", None),
            "w_gate": ("expert", "embed", "expert_mlp"),
            "w_up": ("expert", "embed", "expert_mlp"),
            "w_down": ("expert", "expert_mlp", "embed")}

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


def _route(xg: torch.Tensor, w_router: torch.Tensor, E: int, *,
           n_experts: int, top_k: int, capacity_factor: float):
    """The router on routing groups ``xg`` (G, T, d): (top_p, top_e, me,
    ce, slot, keep, C), with ``me`` and ``ce`` the per-expert means of the
    router's probabilities and of the top-k choices over ``xg``'s tokens,
    which the aux loss multiplies."""
    G, T = xg.shape[0], xg.shape[1]
    logits = xg.float() @ w_router                           # (G, T, E)
    if E > n_experts:
        pad = torch.arange(E, device=xg.device) >= n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]   # (G, T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e, E).sum(2).float().mean(dim=(0, 1)) / top_k

    C = max(1, math.ceil(T * top_k * capacity_factor / n_experts))
    e_flat = top_e.reshape(G, T * top_k)                     # (G, TK)
    oh = F.one_hot(e_flat, E)                                # (G, TK, E)
    pos = torch.cumsum(oh, dim=1) - oh
    pos_sel = torch.gather(pos, -1, e_flat[..., None])[..., 0]
    return top_p, top_e, me, ce, pos_sel.clamp_max(C - 1), pos_sel < C, C


def moe_routing(p: MoeParams, xg: torch.Tensor, *, n_experts: int,
                top_k: int, capacity_factor: float = 1.25) -> MoeRouting:
    """The router of ``moe`` on its routing groups ``xg`` (G, T, d):
    float32 logits (padding experts at -1e30), softmax, top-k
    renormalised, the aux loss (Switch-style: n_experts * sum(f_e *
    p_e)), and each pair's capacity slot.  The top-k is a stable sort, so
    tied experts come lowest index first, as ``lax.top_k`` gives them."""
    top_p, top_e, me, ce, slot, keep, C = _route(
        xg, p.w_router, p.w_gate.shape[0], n_experts=n_experts,
        top_k=top_k, capacity_factor=capacity_factor)
    return MoeRouting(top_p, top_e, n_experts * torch.sum(me * ce), slot,
                      keep, C)


def _route_dispatch(xg, w_router, *, E: int, n_experts: int, top_k: int,
                    capacity_factor: float, shards: int):
    """Route the groups ``xg`` (G, T, d) and scatter their kept (token,
    choice) pairs into the expert buffer (G, E, C, d): (buf, top_p,
    e_flat, slot, keep, me / shards, ce / shards).  The reference adds
    each token into its slot; a kept (e, slot) pair is unique and a
    dropped one adds zero, so a masked write of the kept pairs gives the
    same buffer."""
    top_p, top_e, me, ce, slot, keep, C = _route(
        xg, w_router, E, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor)
    G, T, d = xg.shape
    e_flat = top_e.reshape(G, T * top_k)
    # kept pairs to their (g, e, slot) row, dropped ones to a spare last row
    g_idx = torch.arange(G, device=xg.device)[:, None]
    dest = torch.where(keep, (g_idx * E + e_flat) * C + slot, G * E * C)
    buf = torch.zeros((G * E * C + 1, d), dtype=xg.dtype, device=xg.device)
    buf[dest.reshape(-1)] = xg.repeat_interleave(top_k, dim=1).reshape(-1, d)
    return (buf[:-1].reshape(G, E, C, d), top_p, e_flat, slot, keep,
            me / shards, ce / shards)


def _by_expert(buf: torch.Tensor) -> torch.Tensor:
    """(G, E, C, d) -> (E, G*C, d): one batch of rows per expert."""
    G, E, C, d = buf.shape
    return buf.transpose(0, 1).reshape(E, G * C, d)


def _from_expert(h: torch.Tensor, G: int) -> torch.Tensor:
    """(E, G*C, f) -> (G, E, C, f)."""
    E, GC, f = h.shape
    return h.reshape(E, G, GC // G, f).transpose(0, 1)


def expert_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``buf`` (G, E, C, d) @ ``w`` (E, d, f) -> (G, E, C, f) in the input
    dtype: one ``bmm`` over the experts."""
    return _from_expert(torch.bmm(_by_expert(buf), w), buf.shape[0])


def expert_matmul_f32(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``buf`` (G, E, C, d) @ ``w`` (E, d, f) -> (G, E, C, f) in float32:
    the products of the input dtype's values summed in float32 and never
    rounded to the input dtype.  On the card a bf16/f16 product asks
    cuBLAS for float32 output (``out_dtype``), so no float32 copy of the
    experts' weights is made; the CPU has no such product and widens both
    operands, and so does training (``bmm`` with ``out_dtype`` has no
    derivative)."""
    a = _by_expert(buf)
    training = torch.is_grad_enabled() and (a.requires_grad or
                                            w.requires_grad)
    if a.dtype == torch.float32:
        h = torch.bmm(a, w)
    elif a.is_cuda and not training:
        h = torch.bmm(a, w, out_dtype=torch.float32)
    else:
        h = torch.bmm(a.float(), w.float())
    return _from_expert(h, buf.shape[0])


def _experts_combine(buf, w_gate, w_up, w_down, top_p, e_flat, slot, keep
                     ) -> torch.Tensor:
    """The expert products on the buffer (G, E, C, d) -- the gate product
    in float32 before the SiLU, as the reference's
    ``preferred_element_type=float32`` asks, the up and down products in
    the input dtype -- and each token's kept choices gathered back out of
    it and weighted by ``top_p``: (G, T, d).  Linear in ``w_down``'s
    output, so a rank holding a slice of the experts' hidden dim returns
    its share of the sum."""
    h = F.silu(expert_matmul_f32(buf, w_gate))
    h = h.to(buf.dtype) * expert_matmul(buf, w_up)
    y_buf = expert_matmul(h, w_down)
    G, TK = e_flat.shape
    K = top_p.shape[-1]
    g_idx = torch.arange(G, device=buf.device)[:, None]
    y_tok = y_buf[g_idx, e_flat, slot] * keep[..., None].to(buf.dtype)
    return (y_tok.reshape(G, TK // K, K, -1)
            * top_p[..., None].to(y_tok.dtype)).sum(dim=2)


def moe(p: MoeParams, x: torch.Tensor, *, n_experts: int, top_k: int,
        capacity_factor: float = 1.25, group_tokens: bool = False):
    """Routed MoE.  x: (B, S, d) -> (y, aux_loss).

    Routing groups are batch rows; with ``group_tokens`` the whole (B*S)
    token stream forms one routing group.  Only the first ``n_experts``
    experts are routable.  Each group's expert e holds C =
    ceil(T*k*cf / n_experts) tokens, taken in token-major (T*k) order;
    the rest are dropped (``moe_routing``).  On a mesh (``x`` a DTensor)
    see ``_moe_on_mesh``."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(p, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor,
                            group_tokens=group_tokens)
    B, S, d = x.shape
    xg = x.reshape(1, B * S, d) if group_tokens else x
    buf, top_p, e_flat, slot, keep, me, ce = _route_dispatch(
        xg, p.w_router, E=p.w_gate.shape[0], n_experts=n_experts,
        top_k=top_k, capacity_factor=capacity_factor, shards=1)
    y = _experts_combine(buf, p.w_gate, p.w_up, p.w_down, top_p, e_flat,
                         slot, keep).reshape(B, S, d)
    if p.shared is not None:
        y = y + mlp(p.shared, x)
    return y, n_experts * torch.sum(me * ce)


def _moe_on_mesh(p: MoeParams, x, *, n_experts: int, top_k: int,
                 capacity_factor: float, group_tokens: bool):
    """``moe`` on a mesh, as two ``local_map``s (the sort, one-hot, cumsum
    and scatter of routing have no DTensor sharding rule).

    The routing groups stay split as the batch is (``rows``): each rank
    routes and dispatches its own groups against the whole router, and
    only the aux loss's two per-expert means are summed over the ranks
    (each rank's mean over its equal share, divided by the number of
    shares).  The grouped layout (one group of every token) cannot be
    split, so there ``x`` is gathered and every rank routes it all.  The
    expert products and the combine run on each rank's groups with the
    weights' hidden dim (``expert_mlp``) split where the weights split it
    on a dim that does not split the groups: a rank's output is then its
    share of the down product's sum, reduced once on (G, T, d) after the
    combine, which is linear in it.  This is the reference's layout
    (buffer over "batch", hidden over "expert_mlp", the down product
    summed), with the sum taken after the gather instead of before it."""
    mesh, (B, S, d) = x.device_mesh, x.shape
    if group_tokens:
        xg = on_mesh(gathered(x).reshape(1, B * S, d), mesh)
    else:
        xg = x
    rows = tuple(Shard(0) if pl.is_shard(0) and not group_tokens
                 else Replicate() for pl in xg.placements)
    xg = xg.redistribute(mesh, rows)
    whole = (Replicate(),) * mesh.ndim
    shared = tuple(Partial() if r.is_shard() else Replicate() for r in rows)
    shards = math.prod(mesh.size(i) for i, r in enumerate(rows)
                       if r.is_shard())
    route = local_map(
        functools.partial(_route_dispatch, E=p.w_gate.shape[0],
                          n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor, shards=shards),
        out_placements=(rows,) * 5 + (shared, shared),
        in_placements=(rows, whole), in_grad_placements=(rows, shared),
        device_mesh=mesh)
    buf, top_p, e_flat, slot, keep, me, ce = route(
        xg, p.w_router.redistribute(mesh, whole))

    split = tuple(not r.is_shard() and w.is_shard(2)
                  for r, w in zip(rows, p.w_gate.placements))
    gate = tuple(Shard(2) if s else Replicate() for s in split)
    down = tuple(Shard(1) if s else Replicate() for s in split)
    out = tuple(Partial() if s else r for s, r in zip(split, rows))
    w_grad = tuple(Shard(2) if s else g for s, g in zip(split, shared))
    down_grad = tuple(Shard(1) if s else g for s, g in zip(split, shared))
    experts = local_map(
        _experts_combine, out_placements=(out,),
        in_placements=(rows, gate, gate, down) + (rows,) * 4,
        in_grad_placements=(out, w_grad, w_grad, down_grad, out)
        + (rows,) * 3, device_mesh=mesh)
    y = experts(buf, p.w_gate.redistribute(mesh, gate),
                p.w_up.redistribute(mesh, gate),
                p.w_down.redistribute(mesh, down), top_p, e_flat, slot,
                keep).redistribute(mesh, rows)
    y = y.reshape(B, S, d)
    if p.shared is not None:
        y = y + mlp(p.shared, x)
    me, ce = (t.redistribute(mesh, whole) for t in (me, ce))
    return constrain(y, "batch", "seq", "embed"), n_experts * torch.sum(me * ce)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def init_embedding(gen, vocab: int, d_model: int, dtype,
                   device) -> nn.Parameter:
    return param(gen, (vocab, d_model), dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` for ``tokens``.  On a mesh the table stays
    as it is placed (``_embed_on_shards``)."""
    if isinstance(table, DTensor):
        return constrain(_embed_on_shards(table, tokens), "batch", "seq",
                         "embed")
    return constrain(table[tokens], "batch", "seq", "embed")


class _ShardLookup(torch.autograd.Function):
    """``table[tokens]`` on this rank's rows of a table, which start at
    row ``start``: a token outside them reads a zero row.  The backward
    pass accumulates the output gradient into the rank's rows
    (``index_put_`` with ``accumulate``, the tokens in their order), as
    ``table[tokens]``'s backward does on the whole table, so each row's
    gradient is the same sum in the same order; a token outside the rows
    adds an exact zero.  (DTensor's rule for that backward fails on the
    card's torch, and ``F.embedding``'s backward sums in another
    order.)"""

    @staticmethod
    def forward(ctx, table, tokens, start):
        n = table.shape[0]
        local = tokens.long() - start
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        ctx.save_for_backward(local, mine)
        ctx.rows = table.shape
        return table[local].masked_fill(~mine[..., None], 0)

    @staticmethod
    def backward(ctx, g):
        local, mine = ctx.saved_tensors
        grad = g.new_zeros(ctx.rows)
        grad.index_put_((local,), g.masked_fill(~mine[..., None], 0),
                        accumulate=True)
        return grad, None, None


def _embed_on_shards(table: DTensor, tokens) -> DTensor:
    """The lookup on the table's own shards, as the reference's compiled
    lookup runs it: the int32 tokens are made whole over every mesh dim
    that splits the table (they keep their split elsewhere), each rank
    reads its rows (``_ShardLookup``) and its columns, and the result is
    a partial sum over the mesh dims that split the vocabulary, split by
    columns where the table's columns are: the caller's ``constrain``
    reduces it.  Nothing of the table moves forward.  On a mesh dim that
    splits the tokens but not the table (the batch's 'pod', or a table
    left whole on 'data'), a rank's gradient holds only its tokens: it is
    marked a partial sum there, and the redistribution to the table's own
    placements (no move forward) all-reduces it backward, so the table's
    gradient arrives whole in its placements."""
    mesh, by = table.device_mesh, tuple(table.placements)
    if not isinstance(tokens, DTensor):
        tokens = on_mesh(tokens, mesh)
    tok = tuple(p if t.is_replicate() else Replicate()
                for t, p in zip(by, tokens.placements))
    tokens = tokens.to(torch.int32).redistribute(mesh, tok)
    nd = tokens.dim()
    out = tuple(Partial() if t.is_shard(0) else Shard(nd) if t.is_shard(1)
                else p for t, p in zip(by, tok))
    grad = tuple(Partial() if t.is_replicate() and p.is_shard() else t
                 for t, p in zip(by, tok))
    rows = _ShardLookup.apply(
        table.redistribute(mesh, by).to_local(grad_placements=grad),
        tokens.to_local(), _shard_range(table, 0)[0])
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(rows, mesh, out, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def logits_head(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: (B, S, d) @ (V, d)^T -> (B, S, V)."""
    return constrain(columns(x, "vocab", table.t())[0], "batch", "seq",
                     "vocab")


def pad_vocab(vocab: int, multiple: int = 128) -> int:
    return int(math.ceil(vocab / multiple) * multiple)


def _gather_last(x, idx):
    return torch.gather(x, -1, idx)


def _take_last(x, idx):
    """``torch.gather(x, -1, idx)``.  On a mesh each rank gathers from its
    rows with the last dim whole (``local_map``): DTensor's gather
    backward would make a zeros of x's global shape, replicated, on every
    rank (for the loss, the whole batch's logits)."""
    if not isinstance(x, DTensor):
        return _gather_last(x, idx)
    mesh = x.device_mesh
    x = _gather_dim_unless_divides(x, x.dim() - 1, 1)
    idx = (idx if isinstance(idx, DTensor) else on_mesh(idx, mesh)
           ).redistribute(mesh, x.placements)
    return local_map(_gather_last, out_placements=(x.placements,),
                     in_placements=(x.placements, x.placements),
                     device_mesh=mesh)(x, idx)


class _VocabShardLogProb(torch.autograd.Function):
    """Each row's log-probability of its label from this rank's slice
    (..., V/m) of float32 logits split by vocabulary over the ranks of
    ``groups``, the slice starting at entry ``start``: the row max by an
    all-reduce of max, then the sum of exponentials and the label's logit
    (taken by the rank that holds it, 0 on the others) by one all-reduce
    of sums.  Entries at or past ``vocab`` (the padding) count as -1e30,
    as the plain path masks them.  The backward pass is the rank's slice
    of (onehot - softmax) times each row's gradient, with no collective:
    the rows' log-probabilities are the same on every rank of
    ``groups``."""

    @staticmethod
    def forward(ctx, logits, idx, start, vocab, groups):
        n = logits.shape[-1]
        cols = start + torch.arange(n, device=logits.device)
        logits = logits.masked_fill(cols >= vocab, -1e30)
        m = logits.amax(dim=-1)
        for g in groups:
            m = _all_reduce(m, "max", g)
        e = torch.exp(logits - m[..., None])
        local = idx - start
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        tgt = torch.gather(logits, -1, local[..., None])[..., 0]
        both = torch.stack([e.sum(dim=-1), torch.where(mine, tgt, 0.0)], -1)
        for g in groups:
            both = _all_reduce(both, "sum", g)
        total, tgt = both.unbind(-1)
        ctx.save_for_backward(e, total, local, mine)
        return tgt - m - torch.log(total)

    @staticmethod
    def backward(ctx, g):
        e, total, local, mine = ctx.saved_tensors
        onehot = torch.zeros_like(e).scatter_(
            -1, local[..., None], mine[..., None].to(e.dtype))
        return ((onehot - e / total[..., None]) * g[..., None],
                None, None, None, None)


def _vocab_split(x) -> Tuple[str, ...]:
    """The process groups of the mesh dims (of more than one rank) that
    split ``x``'s last dim; () for a plain tensor."""
    if not isinstance(x, DTensor):
        return ()
    mesh, last = x.device_mesh, x.dim() - 1
    return tuple(mesh.get_group(i).group_name
                 for i, p in enumerate(x.placements)
                 if p.is_shard(last) and mesh.size(i) > 1)


def _label_logprob_by_shards(logits: DTensor, idx, vocab: int):
    """Each row's log-probability of label ``idx`` under ``logits`` (...,
    V) split by vocabulary among ranks (``_VocabShardLogProb`` on each
    rank's slice): laid out as the rows of ``logits``."""
    mesh, last = logits.device_mesh, logits.dim() - 1
    rows = tuple(Replicate() if p.is_shard(last) else p
                 for p in logits.placements)
    idx = (idx if isinstance(idx, DTensor) else on_mesh(idx, mesh)
           ).redistribute(mesh, rows).to_local()
    out = _VocabShardLogProb.apply(logits.to_local(), idx,
                                   _shard_range(logits, last)[0], vocab,
                                   _vocab_split(logits))
    return DTensor.from_local(out, mesh, rows, run_check=False)


def nll_loss(table, h, labels, vocab: int, vocab_padded: int,
             seq_chunk: int = 0) -> torch.Tensor:
    """Next-token NLL (float32 scalar) of the tied head over ``h`` (B, S,
    d) against ``labels`` (B, S); labels < 0 are ignored, and the padded
    vocabulary entries are masked to -1e30.  With ``seq_chunk`` > 0 the
    (B, S, V) logits are never materialized whole: the sequence goes in
    chunks, each recomputed in the backward pass when autograd records.
    On a mesh whose ranks split the vocabulary the log-softmax reduces
    over the ranks' slices (``_label_logprob_by_shards``), as the
    reference's does; the vocabulary is never made whole."""
    S = h.shape[1]
    pad = (torch.arange(vocab_padded, device=h.device) >= vocab
           if vocab_padded > vocab else None)

    def chunk_nll(h_i, lab_i):
        logits = logits_head(table, h_i).float()
        # an ignored label (< 0) reads entry 0; the mask zeroes it
        idx = lab_i.long().clamp_min(0)
        if _vocab_split(logits):
            tgt = _label_logprob_by_shards(logits, idx, vocab)
        else:
            if pad is not None:
                logits = logits.masked_fill(pad, -1e30)
            lp = torch.log_softmax(logits, dim=-1)
            tgt = _take_last(lp, idx[..., None])[..., 0]
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
