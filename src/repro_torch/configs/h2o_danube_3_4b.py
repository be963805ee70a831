"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].  SWA window 4096 makes long_500k runnable."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, sliding_window=4096,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    sliding_window=16)
