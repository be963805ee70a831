"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=80, n_heads=4, n_kv_heads=2, d_ff=160, vocab=256)
