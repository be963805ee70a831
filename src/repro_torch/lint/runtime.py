"""Runtime sanitizers — the port's counterpart of ``repro.lint.runtime``.

:func:`transfer_sanitizer` is the reference's scoped
``jax.transfer_guard("disallow")`` in PyTorch terms: inside the scope a
call that synchronises the host with the card (a blocking copy in
either direction, ``.item()``, ``nonzero``, a boolean-mask index, an
explicit synchronize) raises instead of silently stalling the issue of
device work.  ``RecompileGuard`` is ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def transfer_sanitizer(enabled: bool = True):
    """Run the scope under ``torch.cuda.set_sync_debug_mode("error")``
    and restore the previous mode after it (no-op when disabled or when
    no card is present).

    JAX separates transfers from synchronisation: its guard disallows
    implicit transfers only, so the reference wraps both a batch's
    launch and its ``block_until_ready`` / ``device_get``.  In PyTorch
    every device-to-host copy is a synchronisation, so callers wrap the
    **dispatch** region only — the non-blocking copies of a batch to the
    card and the issue of its generation loop — and run their explicit
    wait and read-back outside the scope.  The mode is process-wide, so
    host threads that touch no CUDA tensor are unaffected.
    """
    if not enabled or not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)
