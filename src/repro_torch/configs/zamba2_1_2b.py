"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba-2 backbone + weight-tied shared attention blocks
[arXiv:2411.15242].

One shared (attention + MLP) block is applied before every group of 6
Mamba-2 layers (7 applications over 38 layers), each application with its
own KV cache.  Mamba-2: d_inner=4096, head_dim=64 -> 64 SSM heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, conv_width=4, shared_attn_every=6,
)

SMOKE = CONFIG.replace(
    num_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    ssm_state=8, ssm_head_dim=16, shared_attn_every=2)
