"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

Routed experts are padded 60 -> 64 for the 16-way expert-parallel axis
(padding experts get -inf router logits and are never selected)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4, expert_ff=1408,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=256,
    n_experts=8, top_k=2, n_shared_experts=2, expert_ff=32)
