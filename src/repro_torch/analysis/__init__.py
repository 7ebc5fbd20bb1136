"""Static verification of compiled ExecutionPlans (see ``verifier``).

Public surface:

* :func:`verify_plan` / :func:`verify_execution_plan` -- run every static
  check over a plan, returning typed :class:`Diagnostic` findings;
* :class:`Diagnostic` / :class:`Severity` / :data:`CODES` /
  :class:`VerificationError` -- the diagnostic vocabulary;
* :func:`journal_trace` -- per-buffer live intervals from the allocator
  journal replay;
* :mod:`repro_torch.analysis.mutate` -- the seeded mutation fuzzer proving the
  verifier's coverage;
* ``python -m repro_torch.analysis`` -- the CLI (verify zoo plans, run the
  mutation-kill gate, write reports).

The counterpart of the JAX package's ``repro.analysis``, carried across as
the plain Python it is: the same codes, checks, mutation classes and seeds,
run over this package's plans, its simulator and its ``prefix_bound``.
"""
from repro_torch.analysis.diagnostics import (CODES, Diagnostic, Severity,
                                              VerificationError,
                                              render_report)
from repro_torch.analysis.liveness import (BufferInterval, JournalTrace,
                                           journal_trace, render_intervals)
from repro_torch.analysis.mutate import (BOUND_CLASSES, CLASSES, Mutant,
                                         bound_kill_matrix,
                                         bound_survives_differential,
                                         kill_matrix, mutate_bound,
                                         mutate_plan, render_kill_matrix,
                                         simulator_detects)
from repro_torch.analysis.verifier import (errors_of, verify_execution_plan,
                                           verify_plan)

__all__ = [
    "CODES", "Diagnostic", "Severity", "VerificationError",
    "render_report", "BufferInterval", "JournalTrace", "journal_trace",
    "render_intervals", "BOUND_CLASSES", "CLASSES", "Mutant",
    "bound_kill_matrix", "bound_survives_differential", "kill_matrix",
    "mutate_bound", "mutate_plan", "render_kill_matrix",
    "simulator_detects", "errors_of", "verify_execution_plan",
    "verify_plan",
]
