"""repro_torch.lint — runtime sanitizers and the race harness for the port.

The counterparts of the reference's runtime side:
:class:`~repro_torch.lint.runtime.RecompileGuard` (fails a run that
builds or compiles after ``warmup()``),
:func:`~repro_torch.lint.runtime.transfer_sanitizer` (scoped
``torch.cuda.set_sync_debug_mode("error")``) and ``repro_torch.lint.race``
(the MemoStore / AnalysisPool concurrency harness).  The reference's static
analyzer (``python -m repro.lint``) already covers the port's sources, so
it has nothing to port.
"""
from repro_torch.lint.runtime import (RecompileError, RecompileGuard,
                                      transfer_sanitizer)

__all__ = ["RecompileError", "RecompileGuard", "transfer_sanitizer"]
