"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — Mamba-1 architecture [arXiv:2410.05355].

d_inner = 2*d_model = 8192, dt_rank = d_model/16 = 256, conv width 4.
Recurrent O(1)/token state makes every decode shape (incl. long_500k)
runnable."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, vocab=65024,
    ssm_state=16, conv_width=4,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, vocab=256, ssm_state=4)
