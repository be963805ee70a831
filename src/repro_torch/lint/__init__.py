"""repro_torch.lint — runtime sanitizers for the port.

Only :func:`repro_torch.lint.runtime.transfer_sanitizer` is ported (the
reference's ``repro.lint.runtime`` counterpart).  The reference's static
analyzer (``python -m repro.lint``) already covers the port's sources, so
it has nothing to port; ``RecompileGuard`` is ROADMAP Queue 1 item 13.
"""
from repro_torch.lint.runtime import transfer_sanitizer

__all__ = ["transfer_sanitizer"]
