"""Host-loop black-box optimizers (Table IV), numpy on the host with
fitness batches on the fitness' device."""
from repro_torch.core.optimizers import blackbox
from repro_torch.core.optimizers.base import Recorder, decode_x, eval_x

__all__ = ["blackbox", "Recorder", "decode_x", "eval_x"]
