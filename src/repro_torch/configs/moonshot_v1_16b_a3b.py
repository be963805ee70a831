"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 experts top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    vocab=163840,
    n_experts=64, top_k=6, n_shared_experts=0, expert_ff=1408,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=256,
    n_experts=8, top_k=2, expert_ff=32)
