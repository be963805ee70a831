"""repro_torch.lint — the port's static analyzer and runtime sanitizers.

Static side (``python -m repro_torch.lint src/repro_torch [--strict]``):
five plain-``ast`` checkers under the reference's rule IDs, for the
port's torch hazards — draws from torch's global generator, host syncs
in the dispatch region, impure strategy state, unlocked shared mutation,
byte-unstable digest inputs (``repro_torch.lint.checkers`` holds the
catalog).  It imports neither the checked code nor torch.

Runtime side (``repro_torch.lint.runtime``): ``RecompileGuard`` (fails a
run that builds or compiles after ``warmup()``), ``transfer_sanitizer``
(scoped ``torch.cuda.set_sync_debug_mode("error")``), and
``repro_torch.lint.race`` (the MemoStore / AnalysisPool concurrency
harness).
"""
from repro_torch.lint import checkers as _checkers  # registers L001..L005
from repro_torch.lint.core import (CHECKERS, RULES, Finding, SourceFile,
                                   lint_file, lint_text, run)

del _checkers

__all__ = ["CHECKERS", "RULES", "Finding", "SourceFile", "lint_file",
           "lint_text", "run"]
