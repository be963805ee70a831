"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — encoder-decoder, multimodal [arXiv:2308.11596].

The audio frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed frame embeddings (B, S, d).  We model 12 encoder + 12 decoder
layers; decode shapes use a 4096-frame encoder context
(``num_prefix_embeds``) for the cross-attention KV.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, encoder_layers=12, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab=256206, num_prefix_embeds=4096,
)

SMOKE = CONFIG.replace(
    num_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, num_prefix_embeds=16)
