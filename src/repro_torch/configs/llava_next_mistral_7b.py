"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower is a STUB per the assignment: ``input_specs`` supplies
2880 precomputed patch embeddings (anyres high-res tiling budget) prepended
to the text tokens; the config here is the Mistral-7B language backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, num_prefix_embeds=2880,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    num_prefix_embeds=8)
