"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219].

40 heads do not divide the 16-way model axis; the registry's sharding
rules shard head_dim (128 -> 8/device, contraction-dim TP) instead.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    head_dim=128, d_ff=17920, vocab=100352,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=80, n_heads=5, n_kv_heads=5, head_dim=16,
    d_ff=160, vocab=256)
