"""Mamba-1 (falcon-mamba), Mamba-2 blocks, and the Zamba2 hybrid
(Mamba-2 backbone + one weight-tied shared attention block applied every
``shared_attn_every`` layers), ported from ``repro.models.mamba``.

The selective scan has two full-sequence implementations, chosen by
``cfg.use_flash`` as in the JAX package:
  - ``selective_scan``          a Python loop over time in chunks of
                                ``cfg.ssm_time_chunk`` steps (the plain
                                version; any device),
  - ``kernels.ops.ssm_scan``    the hand-written CUDA kernel on the card
                                (the plain version for CPU tensors;
                                forward only, as in the JAX package),
and a single-step update for decode (state carried in the cache).

State convention: h (B, d_inner, N) float32;
  h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t ;  y_t = <h_t, C_t>.
Mamba-2 reuses the same recurrence with per-head scalar A broadcast over
channels and head-shared dt.

Per-layer parameters live in ``Mamba1Params`` / ``Mamba2Params`` modules
(the JAX ``NamedTuple`` fields without the leading layer axis), held by
the models in a ``ModuleList``.  Caches keep the JAX layout, stacked over
layers: ``conv (L, B, W-1, Di)``, ``ssm (L, B, Di, N)`` and, for the
hybrid, ``kv`` as a ``KVCache`` of ``(n_apps, ...)`` tensors.
``decode_step`` updates the cache it is given in place and returns it.
``cfg.remat`` recomputes each Mamba layer in the backward pass
(``torch.utils.checkpoint``) when autograd records, as ``jax.checkpoint``
does in the reference; the hybrid's shared block is not recomputed there
either.  Training runs ``use_flash=False``: the scan kernel has no
gradient, so an SSM or hybrid step runs the plain loop, which is the
reference's ``lax.scan`` route.

On a device mesh (the parameters DTensors, ``use_mesh`` active) the
blocks annotate their activations at the reference's ``constrain``
points, and the per-channel work runs on each rank's channels of
``inner`` (``local_map``): the causal conv, and the scan with its skip
and gate.  The scan's recurrence is per channel, so it needs no
collective, and its per-step operations stay plain tensor operations.
``torch.chunk`` of the ``2·Di`` projection leaves a rank a slice of x or
of z, not matching slices of both, so both halves are gathered and
each is split again by channel.  The products that contract ``inner``
(``x_proj``, ``out_proj``) and Mamba-2's gate norm (a mean over ``Di``)
run as DTensor operations, which sum the ranks' parts.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist.sharding import constrain, fsdp_whole
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import (ones_init, param, remat,
                                      weights_generator, zeros_init)


# ---------------------------------------------------------------------------
# selective scan (shared by mamba1/mamba2)
# ---------------------------------------------------------------------------
SCAN_CHUNK = 16      # the plain scan's chunk when cfg.ssm_time_chunk is 0


def selective_scan(x, dt, A, B, C, h0=None, chunk: int = 0):
    """x, dt: (Bt, S, Di); A: (Di, N); B, C: (Bt, S, N) -> (y, h_final),
    y (Bt, S, Di) and h_final (Bt, Di, N), both float32.

    The time axis runs in chunks of ``chunk`` steps (``SCAN_CHUNK`` when
    0; the last chunk may be shorter): each chunk's decays exp(dt A) and
    inputs (dt x) B are computed in one operation each, then its steps run
    h = decay h + u and y = <h, C>: four operations a step, where a loop
    of the reference's step issues eight.  Every element goes through the
    reference's step in the reference's order, so no chunk size changes a
    bit of the result; the reference's ``selective_scan_chunked`` is the
    same recurrence, and ``cfg.ssm_time_chunk`` sets the size here."""
    Bt, S, Di = x.shape
    N = A.shape[1]
    chunk = chunk or SCAN_CHUNK
    h = (torch.zeros((Bt, Di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    Af = A.float()
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    ys = []
    for c in range(0, S, chunk):
        sl = slice(c, c + chunk)
        decay = torch.exp(dtf[:, sl, :, None] * Af)       # (Bt, chunk, Di, N)
        u = (dtf[:, sl] * xf[:, sl])[..., None] * Bf[:, sl, None, :]
        # unbind: one view op a chunk, and one stack in the backward pass
        for d_t, u_t, C_t in zip(decay.unbind(1), u.unbind(1),
                                 Cf[:, sl, None, :].unbind(1)):
            h = d_t * h + u_t
            ys.append(torch.sum(h * C_t, dim=-1))
    if not ys:
        return torch.zeros((Bt, 0, Di), dtype=torch.float32,
                           device=x.device), h
    return torch.stack(ys, dim=1), h


def selective_step(h, x_t, dt_t, A, B_t, C_t):
    """One decode step: x_t, dt_t (Bt, Di); B_t, C_t (Bt, N)."""
    decay = torch.exp(dt_t[..., None].float() * A.float()[None])
    h = decay * h + (dt_t * x_t)[..., None].float() * B_t[:, None, :].float()
    y = torch.sum(h * C_t[:, None, :].float(), dim=-1)
    return h, y


def causal_conv1d(x, w, b):
    """Depthwise causal conv: x (Bt,S,Di), w (Di,W), b (Di,)."""
    W = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[:, i] for i in range(W))
    return out + b


def conv1d_step(conv_state, x_t, w, b):
    """conv_state: (Bt, W-1, Di) trailing inputs; x_t: (Bt, Di)."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)          # (Bt, W, Di)
    out = torch.einsum("bwd,dw->bd", full, w) + b
    return full[:, 1:], out


def _ssm_full(cfg: ModelConfig, x_c, dt, A, B_ssm, C_ssm):
    """The full-sequence scan: the kernel with ``use_flash``, else the
    loop in chunks of ``cfg.ssm_time_chunk`` steps."""
    if cfg.use_flash:
        from repro_torch.kernels import ops as kops
        return kops.ssm_scan(x_c, dt, A, B_ssm, C_ssm)
    return selective_scan(x_c, dt, A, B_ssm, C_ssm, chunk=cfg.ssm_time_chunk)


def _conv_silu(x_in, conv_w, conv_b, dtype):
    """The causal conv and its SiLU over (Bt, S, Di) inputs, and the
    conv's last W-1 inputs (the decode state)."""
    W = conv_w.shape[1]
    tail = F.pad(x_in, (0, 0, W - 1, 0))[:, -(W - 1):, :]
    return F.silu(causal_conv1d(x_in, conv_w, conv_b).float()).to(dtype), tail


def _scan_gate(cfg: ModelConfig, x_c, dt, A, B_ssm, C_ssm, D, z):
    """The scan, its skip D x and the SiLU gate of z: (y, h_final), y in
    x_c's dtype."""
    y, h_fin = _ssm_full(cfg, x_c, dt, A, B_ssm, C_ssm)
    y = y + D * x_c.float()
    return y.to(x_c.dtype) * F.silu(z.float()).to(x_c.dtype), h_fin


class _Ranks:
    """How a Mamba block's tensors lie on the mesh, per mesh dim: a dim
    splits the channels of ``inner`` where the parameter ``D`` (Di,) is
    split, and the batch rows where the block's input is."""

    def __init__(self, x: DTensor, D: DTensor):
        self.mesh = x.device_mesh
        self.ch = tuple(p.is_shard(0) for p in D.placements)
        self.rows = tuple(p.is_shard(0) and not c
                          for p, c in zip(x.placements, self.ch))

    def _each(self, on_ch, on_rows):
        return tuple(on_ch if c else on_rows if r else Replicate()
                     for c, r in zip(self.ch, self.rows))

    def act(self, dim: int = 2):
        """An activation split by rows and by channels on ``dim``."""
        return self._each(Shard(dim), Shard(0))

    def rows_only(self):
        """An activation split by rows, its channels whole."""
        return self._each(Replicate(), Shard(0))

    def rows_grad(self):
        """The gradient of a ``rows_only`` input: each channel shard's
        part."""
        return self._each(Partial(), Shard(0))

    def weight(self):
        """A per-channel weight, split by channels on its dim 0."""
        return self._each(Shard(0), Replicate())

    def weight_grad(self):
        """Its gradient: summed over the rows' shards."""
        return self._each(Shard(0), Partial())

    def run(self, fn, ins, outs):
        """``fn`` on each rank's shards: ``ins`` is a list of (tensor,
        placements, gradient placements), None for a non-tensor; every
        tensor is first laid out as its placements say."""
        args = [t if pl is None else t.redistribute(self.mesh, pl)
                for t, pl, _ in ins]
        return local_map(fn, out_placements=outs,
                         in_placements=tuple(pl for _, pl, _ in ins),
                         in_grad_placements=tuple(g for _, _, g in ins),
                         device_mesh=self.mesh)(*args)


def _conv_full(lp, x_in, dtype, ranks: Optional[_Ranks]):
    """``_conv_silu`` of the block, per rank on a mesh: (x_c, tail)."""
    if ranks is None:
        return _conv_silu(x_in, lp.conv_w, lp.conv_b, dtype)
    act, w, wg = ranks.act(), ranks.weight(), ranks.weight_grad()
    return ranks.run(_conv_silu, [(x_in, act, act), (lp.conv_w, w, wg),
                                  (lp.conv_b, w, wg), (dtype, None, None)],
                     (act, act))


def _scan_full(cfg, ranks: Optional[_Ranks], x_c, dt, A, B_ssm, C_ssm, D, z):
    """``_scan_gate``, per rank on a mesh: (y, h_final)."""
    if ranks is None:
        return _scan_gate(cfg, x_c, dt, A, B_ssm, C_ssm, D, z)
    act, rows, rows_g = ranks.act(), ranks.rows_only(), ranks.rows_grad()
    return ranks.run(
        functools.partial(_scan_gate, cfg),
        [(x_c, act, act), (dt, act, act),
         (A, ranks.weight(), ranks.weight_grad()),
         (B_ssm, rows, rows_g), (C_ssm, rows, rows_g),
         (D, ranks.weight(), ranks.weight_grad()), (z, act, act)],
        (act, ranks.act(1)))


def _on_ranks(x, D) -> Optional[_Ranks]:
    """The block's ``_Ranks`` on a mesh; None without one."""
    return _Ranks(x, D) if isinstance(x, DTensor) else None


def _inner_halves(xz, ranks: Optional[_Ranks]):
    """x and z, each split by channels on a mesh (the halves are gathered
    across the ranks that split ``2·Di``, then split again)."""
    x_in, z = torch.chunk(xz, 2, dim=-1)
    if ranks is None:
        return x_in, z
    return (x_in.redistribute(ranks.mesh, ranks.act()),
            z.redistribute(ranks.mesh, ranks.act()))


def _a_log_mamba1(N: int):
    def init(gen, shape, dtype, device):
        a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(tuple(shape)).to(dtype).clone()
    return init


def _dt_bias(gen, shape, dtype, device):
    return torch.log(torch.expm1(torch.full(tuple(shape), 1e-2,
                                            dtype=torch.float32,
                                            device=device))).to(dtype)


def _a_log_mamba2(gen, shape, dtype, device):
    return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                    dtype=torch.float32,
                                    device=device)).to(dtype)


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba)
# ---------------------------------------------------------------------------
class Mamba1Params(nn.Module):
    """One Mamba-1 layer: norm (d), in_proj (d, 2Di), conv_w (Di, W),
    conv_b (Di), x_proj (Di, dt_rank + 2N), dt_w (dt_rank, Di),
    dt_b (Di) f32, A_log (Di, N) f32, D (Di) f32, out_proj (Di, d)."""
    AXES = {"norm": ("embed",), "in_proj": ("embed", "inner"),
            "conv_w": ("inner", "conv"), "conv_b": ("inner",),
            "x_proj": ("inner", None), "dt_w": ("dt_rank", "inner"),
            "dt_b": ("inner",), "A_log": ("inner", "ssm_state"),
            "D": ("inner",), "out_proj": ("inner", "embed")}

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        d, Di, N = cfg.d_model, cfg.inner, cfg.ssm_state
        dtr, W, dt = cfg.dtr, cfg.conv_width, cfg.dtype_torch
        f32 = torch.float32
        self.norm = L.init_rmsnorm(gen, d, dt, device)
        self.in_proj = param(gen, (d, 2 * Di), dt, device, stddev=d ** -0.5)
        self.conv_w = param(gen, (Di, W), dt, device, stddev=W ** -0.5)
        self.conv_b = param(gen, (Di,), dt, device, init=zeros_init)
        self.x_proj = param(gen, (Di, dtr + 2 * N), dt, device,
                            stddev=Di ** -0.5)
        self.dt_w = param(gen, (dtr, Di), dt, device, stddev=dtr ** -0.5)
        self.dt_b = param(gen, (Di,), f32, device, init=_dt_bias)
        self.A_log = param(gen, (Di, N), f32, device, init=_a_log_mamba1(N))
        self.D = param(gen, (Di,), f32, device, init=ones_init)
        self.out_proj = param(gen, (Di, d), dt, device, stddev=Di ** -0.5)


def mamba1_block(lp: Mamba1Params, x, cfg: ModelConfig, state=None):
    """x: (Bt, S, d).  state=None: full scan (returns y, final_state);
    state=(conv_state, h): single-step decode (S==1)."""
    N, dtr = cfg.ssm_state, cfg.dtr
    h_in = L.rms_norm(lp.norm, x)
    xz, = L.columns(h_in, "inner", lp.in_proj)

    if state is None:
        ranks = _on_ranks(x, lp.D)
        x_in, z = _inner_halves(xz, ranks)
        x_c, conv_tail = _conv_full(lp, x_in, x.dtype, ranks)
        dbc = x_c @ lp.x_proj
        if ranks is not None:   # the ranks' partial sums, added
            dbc = dbc.redistribute(ranks.mesh, ranks.rows_only())
        dt_r, B_ssm, C_ssm = torch.split(dbc, [dtr, N, N], dim=-1)
        dt = F.softplus((dt_r @ lp.dt_w).float() + lp.dt_b)
        A = -torch.exp(lp.A_log)
        y, h_fin = _scan_full(cfg, ranks, x_c, dt, A, B_ssm, C_ssm, lp.D, z)
        out = constrain(y @ fsdp_whole(lp.out_proj), "batch", "seq",
                        "embed")
        return x + out, (conv_tail, h_fin)

    x_in, z = torch.chunk(xz, 2, dim=-1)
    conv_state, h = state
    x_t, z_t = x_in[:, 0], z[:, 0]
    conv_state, x_c = conv1d_step(conv_state, x_t, lp.conv_w, lp.conv_b)
    x_c = F.silu(x_c.float()).to(x.dtype)
    dt_r, B_t, C_t = torch.split(x_c @ lp.x_proj, [dtr, N, N], dim=-1)
    dt = F.softplus((dt_r @ lp.dt_w).float() + lp.dt_b)
    A = -torch.exp(lp.A_log)
    h, y = selective_step(h, x_c, dt, A, B_t, C_t)
    y = y + lp.D * x_c.float()
    y = y.to(x.dtype) * F.silu(z_t.float()).to(x.dtype)
    out = y[:, None] @ fsdp_whole(lp.out_proj)
    return x + constrain(out, "batch", None, "embed"), (conv_state, h)


# ---------------------------------------------------------------------------
# Mamba-2 block (zamba2 backbone)
# ---------------------------------------------------------------------------
class Mamba2Params(nn.Module):
    """One Mamba-2 layer: norm (d), in_proj (d, 2Di), conv_w (Di, W),
    conv_b (Di), bc_proj (d, 2N), dt_w (d, H), dt_b (H) f32,
    A_log (H) f32, D (Di) f32, gate_norm (Di), out_proj (Di, d).  The
    gate norm's axis is "embed", as every RMSNorm scale's is in the
    reference."""
    AXES = {"norm": ("embed",), "in_proj": ("embed", "inner"),
            "conv_w": ("inner", "conv"), "conv_b": ("inner",),
            "bc_proj": ("embed", None), "dt_w": ("embed", None),
            "dt_b": (None,), "A_log": (None,), "D": ("inner",),
            "gate_norm": ("embed",), "out_proj": ("inner", "embed")}

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        d, Di, N = cfg.d_model, cfg.inner, cfg.ssm_state
        H, W, dt = cfg.n_ssm_heads, cfg.conv_width, cfg.dtype_torch
        f32 = torch.float32
        self.norm = L.init_rmsnorm(gen, d, dt, device)
        self.in_proj = param(gen, (d, 2 * Di), dt, device, stddev=d ** -0.5)
        self.conv_w = param(gen, (Di, W), dt, device, stddev=W ** -0.5)
        self.conv_b = param(gen, (Di,), dt, device, init=zeros_init)
        self.bc_proj = param(gen, (d, 2 * N), dt, device, stddev=d ** -0.5)
        self.dt_w = param(gen, (d, H), dt, device, stddev=d ** -0.5)
        self.dt_b = param(gen, (H,), f32, device, init=_dt_bias)
        self.A_log = param(gen, (H,), f32, device, init=_a_log_mamba2)
        self.D = param(gen, (Di,), f32, device, init=ones_init)
        self.gate_norm = L.init_rmsnorm(gen, Di, dt, device)
        self.out_proj = param(gen, (Di, d), dt, device, stddev=Di ** -0.5)


def mamba2_block(lp: Mamba2Params, x, cfg: ModelConfig, state=None):
    """Mamba-2: scalar per-head decay; reuses the mamba1 recurrence with A
    and dt broadcast across each head's channels."""
    N, dh = cfg.ssm_state, cfg.ssm_head_dim
    # the products below share h_in, whose gradient they sum once
    h_in = L.grad_as_input(L.rms_norm(lp.norm, x))
    xz, = L.columns(h_in, "inner", lp.in_proj)
    B_ssm, C_ssm = torch.chunk(h_in @ fsdp_whole(lp.bc_proj), 2, dim=-1)
    dt_h = F.softplus((h_in @ fsdp_whole(lp.dt_w)).float()
                      + lp.dt_b)                               # (Bt,S,H)
    A_h = -torch.exp(lp.A_log)                                 # (H,)
    A_full = A_h.repeat_interleave(dh)[:, None].repeat(1, N)   # (Di, N)
    dt_full = dt_h.repeat_interleave(dh, dim=-1)               # (Bt,S,Di)

    if state is None:
        ranks = _on_ranks(x, lp.D)
        x_in, z = _inner_halves(xz, ranks)
        x_c, conv_tail = _conv_full(lp, x_in, x.dtype, ranks)
        y, h_fin = _scan_full(cfg, ranks, x_c, dt_full, A_full, B_ssm, C_ssm,
                              lp.D, z)
        y = L.rms_norm(lp.gate_norm, y)
        out = constrain(y @ fsdp_whole(lp.out_proj), "batch", "seq",
                        "embed")
        return x + out, (conv_tail, h_fin)

    x_in, z = torch.chunk(xz, 2, dim=-1)
    conv_state, h = state
    x_t, z_t = x_in[:, 0], z[:, 0]
    conv_state, x_c = conv1d_step(conv_state, x_t, lp.conv_w, lp.conv_b)
    x_c = F.silu(x_c.float()).to(x.dtype)
    h, y = selective_step(h, x_c, dt_full[:, 0], A_full, B_ssm[:, 0],
                          C_ssm[:, 0])
    y = y + lp.D * x_c.float()
    y = L.rms_norm(lp.gate_norm,
                   y.to(x.dtype) * F.silu(z_t.float()).to(x.dtype))
    out = y[:, None] @ fsdp_whole(lp.out_proj)
    return x + constrain(out, "batch", None, "embed"), (conv_state, h)


class _LM(nn.Module):
    """What both SSM language models share: the tied embedding, the
    final norm, the padded-vocabulary logits and the cache's home."""
    AXES = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
    embed: nn.Parameter
    final_norm: nn.Parameter

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.vocab_padded = L.pad_vocab(cfg.vocab)

    def _logits(self, h):
        logits = L.logits_head(self.embed, h).float()
        if self.vocab_padded > self.cfg.vocab:
            pad = torch.arange(self.vocab_padded,
                               device=logits.device) >= self.cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _ssm_cache(self, batch: int):
        cfg = self.cfg
        Lr, Di, N, W = cfg.num_layers, cfg.inner, cfg.ssm_state, cfg.conv_width
        return {
            "conv": torch.zeros((Lr, batch, W - 1, Di), dtype=cfg.dtype_torch,
                                device=self.device),
            "ssm": torch.zeros((Lr, batch, Di, N), dtype=torch.float32,
                               device=self.device),
        }


# ---------------------------------------------------------------------------
# Falcon-mamba: pure Mamba-1 LM
# ---------------------------------------------------------------------------
class MambaLM(_LM):
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        gen = weights_generator(device, generator)
        dt = cfg.dtype_torch
        self.embed = L.init_embedding(gen, self.vocab_padded, cfg.d_model, dt,
                                      device)
        self.layers = nn.ModuleList(Mamba1Params(gen, cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = param(gen, (cfg.d_model,), dt, device,
                                init=ones_init)

    def hidden_states(self, x, with_state: bool = False):
        """Run the layers over embedded inputs x (B, S, d).  Returns
        (final-normed states, None), or with ``with_state`` (states,
        (conv (L, B, W-1, Di), ssm (L, B, Di, N))), each layer's final
        state stacked as the reference's layer scan stacks them."""
        convs, ssms = [], []
        for lp in self.layers:
            x, (conv, ssm) = remat(self.cfg, mamba1_block, lp, x, self.cfg)
            if with_state:
                convs.append(conv)
                ssms.append(ssm)
        states = (torch.stack(convs), torch.stack(ssms)) if with_state \
            else None
        return L.rms_norm(self.final_norm, x), states

    def loss(self, batch):
        """Next-token cross entropy.  batch: tokens (B, S), labels (B,
        S).  Returns (loss, {"nll", "aux"})."""
        h, _ = self.hidden_states(L.embed(self.embed, batch["tokens"]))
        return L.lm_loss(self.embed, h, batch["labels"], self.cfg.vocab,
                         self.vocab_padded, self.cfg.ce_seq_chunk)

    def init_cache(self, batch: int, seq_len: int):
        return self._ssm_cache(batch)

    @torch.no_grad()
    def prefill(self, batch, seq_len: int):
        x = L.embed(self.embed, batch["tokens"])
        h, (conv, ssm) = self.hidden_states(x, with_state=True)
        return self._logits(h[:, -1:]), {"conv": conv, "ssm": ssm}

    @torch.no_grad()
    def decode_step(self, cache, tokens, cur_pos: int):
        x = L.embed(self.embed, tokens)
        for i, lp in enumerate(self.layers):
            x, (conv, ssm) = mamba1_block(
                lp, x, self.cfg, state=(cache["conv"][i], cache["ssm"][i]))
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        h = L.rms_norm(self.final_norm, x)
        return self._logits(h), cache


# ---------------------------------------------------------------------------
# Zamba2 hybrid: Mamba-2 backbone + weight-tied shared attention block
# ---------------------------------------------------------------------------
class SharedBlock(nn.Module):
    """The one weight-tied (attention + MLP) block of the hybrid."""
    AXES = {"attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.dtype_torch
        self.attn_norm = param(gen, (cfg.d_model,), dt, device,
                               init=ones_init)
        self.attn = L.AttnParams(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, dt, device)
        self.mlp_norm = param(gen, (cfg.d_model,), dt, device,
                              init=ones_init)
        self.mlp = L.MlpParams(gen, cfg.d_model, cfg.d_ff, dt, device)


class HybridLM(_LM):
    """``shared_attn_every`` mamba2 layers are preceded by one application of
    a single weight-tied (attention + MLP) block; each application keeps its
    own KV cache."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        k = cfg.shared_attn_every
        self.n_apps = math.ceil(cfg.num_layers / k)
        # group g covers mamba layers [g*k, min((g+1)*k, L))
        self.group_sizes = [min((g + 1) * k, cfg.num_layers) - g * k
                            for g in range(self.n_apps)]
        gen = weights_generator(device, generator)
        dt = cfg.dtype_torch
        self.shared = SharedBlock(gen, cfg, device)
        self.embed = L.init_embedding(gen, self.vocab_padded, cfg.d_model, dt,
                                      device)
        self.layers = nn.ModuleList(Mamba2Params(gen, cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = param(gen, (cfg.d_model,), dt, device,
                                init=ones_init)

    def _groups(self):
        off = 0
        for size in self.group_sizes:
            yield off, self.layers[off:off + size]
            off += size

    def _shared_mlp(self, x):
        sh = self.shared
        return x + L.mlp(sh.mlp, L.rms_norm(sh.mlp_norm, x))

    def _apply_shared_full(self, x):
        """One application of the shared block over the full sequence:
        causal self-attention (the flash kernel with ``use_flash``) and the
        MLP, each with its residual."""
        cfg, sh = self.cfg, self.shared
        x = x + L.full_attention(
            sh.attn, L.rms_norm(sh.attn_norm, x), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            use_flash=cfg.use_flash, q_chunk=cfg.attn_q_chunk)
        return self._shared_mlp(x)

    def hidden_states(self, x):
        """The shared block before each group of ``shared_attn_every``
        Mamba-2 layers, over embedded inputs x (B, S, d); returns the
        final-normed states.  Only the Mamba layers are recomputed with
        ``cfg.remat``, as in the reference; the shared block's weights
        are tied, so its gradient sums over its applications."""
        cfg = self.cfg
        for _, group in self._groups():
            x = self._apply_shared_full(x)
            for lp in group:
                x, _ = remat(cfg, mamba2_block, lp, x, cfg)
        return L.rms_norm(self.final_norm, x)

    def loss(self, batch):
        """Next-token cross entropy.  batch: tokens (B, S), labels (B,
        S).  Returns (loss, {"nll", "aux"})."""
        h = self.hidden_states(L.embed(self.embed, batch["tokens"]))
        return L.lm_loss(self.embed, h, batch["labels"], self.cfg.vocab,
                         self.vocab_padded, self.cfg.ce_seq_chunk)

    def init_cache(self, batch: int, seq_len: int):
        cfg = self.cfg
        one = L.init_kv_cache(batch, seq_len, cfg.n_kv_heads, cfg.hd,
                              cfg.dtype_torch, self.device)
        cache = self._ssm_cache(batch)
        cache["kv"] = L.KVCache(*(a[None].repeat((self.n_apps,) +
                                                 (1,) * a.dim())
                                  for a in one))
        return cache

    @torch.no_grad()
    def prefill(self, batch, seq_len: int):
        """Full-sequence pass that fills SSM + KV caches."""
        cfg, sh = self.cfg, self.shared
        x = L.embed(self.embed, batch["tokens"])
        convs, ssms, kvs = [], [], []
        for _, group in self._groups():
            a_out, kv = L.prefill_attention(
                sh.attn, L.rms_norm(sh.attn_norm, x), seq_len,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, q_chunk=cfg.attn_q_chunk)
            x = self._shared_mlp(x + a_out)
            kvs.append(kv)
            for lp in group:
                x, (conv, ssm) = mamba2_block(lp, x, cfg)
                convs.append(conv)
                ssms.append(ssm)
        h = L.rms_norm(self.final_norm, x[:, -1:])
        cache = {
            "conv": torch.stack(convs),
            "ssm": torch.stack(ssms),
            "kv": L.KVCache(*(torch.stack(leaf) for leaf in zip(*kvs))),
        }
        return self._logits(h), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, cur_pos: int):
        cfg, sh = self.cfg, self.shared
        x = L.embed(self.embed, tokens)
        kv = cache["kv"]
        for g, (off, group) in enumerate(self._groups()):
            a_out, _ = L.decode_attention(
                sh.attn, L.rms_norm(sh.attn_norm, x),
                L.KVCache(kv.k[g], kv.v[g], kv.pos[g]), cur_pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta)
            x = self._shared_mlp(x + a_out)
            for i, lp in enumerate(group, start=off):
                x, (conv, ssm) = mamba2_block(
                    lp, x, cfg, state=(cache["conv"][i], cache["ssm"][i]))
                cache["conv"][i] = conv
                cache["ssm"][i] = ssm
        h = L.rms_norm(self.final_norm, x)
        return self._logits(h), cache
