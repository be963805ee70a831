"""Unified model configuration for the 10 assigned architectures.

The same fields as ``repro.models.config.ModelConfig``, so that one config
means the same model in both packages.  ``dtype_torch`` takes the place of
``dtype_jnp``.  ``scan_layers`` steers only the JAX package's lowering
and is kept for parity; ``fsdp`` and ``attn_batch_shard`` pick the
sharding rules of a device mesh (``registry.sharding_rules``).  ``use_flash`` selects
the hand-written kernels (the selective scan and the forward-only flash
attention), ``ssm_time_chunk`` the plain scan's chunk of steps, ``remat``
recomputes each layer in the backward pass, and ``ce_seq_chunk`` chunks
the cross-entropy, as in the JAX package.  ``ShapeConfig`` and ``SHAPES``
are the reference's input-shape cells.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    num_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 0
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_ff: int = 0           # routed expert hidden dim
    capacity_factor: float = 1.25
    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    d_inner: int = 0             # 0 -> 2 * d_model
    conv_width: int = 4
    dt_rank: int = 0             # mamba1; 0 -> ceil(d_model / 16)
    ssm_head_dim: int = 64       # mamba2
    ssm_chunk: int = 128
    # the plain selective scan's chunk of steps (0: mamba.SCAN_CHUNK;
    # use_flash takes the CUDA kernel instead)
    ssm_time_chunk: int = 0
    # hybrid (zamba2): one weight-tied attention block applied every k layers
    shared_attn_every: int = 0
    # enc-dec
    encoder_layers: int = 0
    # modality frontend stubs ([audio]/[vlm]): prepended precomputed embeds
    num_prefix_embeds: int = 0
    # attention memory control: process queries in chunks of this size when
    # S > 2*chunk (exact, O(S*chunk) memory; SWA also slices the KV range)
    attn_q_chunk: int = 1024
    # decode_step's default MoE routing group: the whole batch (True) or
    # each row (False)
    moe_group_decode: bool = False
    # fused cross-entropy: the loss's logits in sequence chunks of this size
    ce_seq_chunk: int = 0
    # attention batch re-sharding and FSDP: on a device mesh, attention
    # with the batch over every mesh axis and heads replicated, and the
    # weights' embed dim over 'data' (registry.sharding_rules)
    attn_batch_shard: bool = False
    fsdp: bool = True
    # numerics / lowering
    dtype: str = "bfloat16"
    scan_layers: bool = True     # JAX layer scan; kept for parity only
    # route the SSM scan and full_attention through the CUDA kernels; the
    # flash-attention kernel is forward-only (as in the JAX package), so
    # training runs with use_flash=False
    use_flash: bool = False
    # recompute each layer in the backward pass (torch.utils.checkpoint)
    # when training
    remat: bool = True

    # ---- derived -----------------------------------------------------------
    @property
    def dtype_torch(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def n_ssm_heads(self) -> int:
        return self.inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
