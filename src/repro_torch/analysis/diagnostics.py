"""Typed diagnostics for the static plan verifier.

Every check in ``repro_torch.analysis.verifier`` reports through a
:class:`Diagnostic` carrying a stable ``SF0xx`` code, a severity, the
group / instruction-word anchor the finding points at, and a rendered
source-context line.  Codes are stable across releases (tests, CI gates
and downstream tooling key on them); new checks take new codes instead of
reusing retired ones.

Code map (the check catalog lives in ``docs/architecture.md``):

====== ====================================================================
SF01x  dataflow (def-before-use, single producer, stream shape)
SF02x  buffer liveness (clobbers, unavailable operands, lost outputs)
SF03x  capacity (SRAM/BRAM budgets, buffer occupancy vs declared maxima)
SF04x  DRAM conservation (double writes, dangling reads, model agreement)
SF05x  ISA well-formedness (bit-field ranges, mode/fusion legality)
====== ====================================================================
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:  # render as "error"/"warning" in reports
        return self.value


#: code -> (title, default severity).  The verifier may downgrade capacity
#: errors to warnings when the plan itself is marked infeasible (the
#: optimizer already knows and reports it; strict mode gates on errors).
CODES: dict[str, tuple[str, Severity]] = {
    # ---- SF01x: dataflow
    "SF010": ("use-before-def: src operand refers to a gid not yet "
              "produced", Severity.ERROR),
    "SF011": ("unknown producer: src operand out of range", Severity.ERROR),
    "SF012": ("duplicate producer: gid encoded more than once",
              Severity.ERROR),
    "SF013": ("stream order: instructions not in dense ascending gid "
              "order", Severity.ERROR),
    "SF014": ("missing group: no instruction for a graph group",
              Severity.ERROR),
    "SF015": ("src_main disagrees with the grouped graph's main input",
              Severity.ERROR),
    "SF016": ("src_shortcut disagrees with the grouped graph's shortcut "
              "source", Severity.ERROR),
    # ---- SF02x: buffer liveness
    "SF020": ("shortcut clobber: write evicts a live tensor another "
              "consumer will read", Severity.ERROR),
    "SF021": ("operand unavailable: frame-mode read finds the tensor in "
              "no buffer and not in DRAM", Severity.ERROR),
    "SF022": ("row-mode read of a frame-produced tensor never written "
              "out at the boundary", Severity.ERROR),
    "SF023": ("frame-mode output has no destination (no buffer, not "
              "spilled, not a boundary write)", Severity.ERROR),
    "SF024": ("allocation record diverges from the allocator journal "
              "replay", Severity.ERROR),
    "SF025": ("alloc field inconsistent with the abstract machine's "
              "buffer state", Severity.ERROR),
    # ---- SF03x: capacity
    "SF030": ("SRAM total exceeds the hardware budget", Severity.ERROR),
    "SF031": ("BRAM18K count exceeds the hardware budget (advisory: the "
              "optimizer's feasibility contract constrains SRAM bytes, "
              "not BRAM banks)", Severity.WARNING),
    "SF032": ("buffer occupancy exceeds the allocation's declared "
              "capacity", Severity.ERROR),
    # ---- SF04x: DRAM conservation
    "SF040": ("tensor written to DRAM more than once", Severity.ERROR),
    "SF041": ("DRAM read of a tensor never written to DRAM",
              Severity.ERROR),
    "SF042": ("static DRAM byte count disagrees with the analytic model",
              Severity.ERROR),
    "SF043": ("dead DRAM spill: tensor written off-chip but never read",
              Severity.WARNING),
    # ---- SF05x: ISA well-formedness
    "SF050": ("bit-field overflow: field value does not fit its encoding "
              "slot", Severity.ERROR),
    "SF051": ("unknown opcode / mode / activation code", Severity.ERROR),
    "SF052": ("alloc field is not a physical buffer id or OFFCHIP",
              Severity.ERROR),
    "SF053": ("row-mode group carries an on-chip buffer assignment",
              Severity.ERROR),
    "SF054": ("fusion legality: eltwise/shortcut operand rules violated",
              Severity.ERROR),
    "SF055": ("instruction geometry disagrees with the graph group",
              Severity.ERROR),
}


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.

    ``gid`` anchors the group the finding is about (None for stream-level
    findings); ``word`` the instruction word index within the 11-word
    encoding, when the finding points at a specific field; ``context`` is
    a rendered source-context line (group repr, live interval, field
    dump) for human reports."""
    code: str
    message: str
    gid: int | None = None
    word: int | None = None
    context: str = ""
    severity: Severity = field(default=Severity.ERROR)

    @property
    def title(self) -> str:
        return CODES[self.code][0]

    def render(self) -> str:
        anchor = "" if self.gid is None else f" @g{self.gid}"
        anchor += "" if self.word is None else f".w{self.word}"
        out = f"{self.code}{anchor} [{self.severity}] {self.message}"
        if self.context:
            out += f"\n        | {self.context}"
        return out


def make(code: str, message: str, gid: int | None = None,
         word: int | None = None, context: str = "",
         severity: Severity | None = None) -> Diagnostic:
    """Build a Diagnostic with the catalog's default severity unless
    overridden (unknown codes are a programming error, caught here)."""
    if code not in CODES:
        raise KeyError(f"unknown diagnostic code {code!r}")
    return Diagnostic(code=code, message=message, gid=gid, word=word,
                      context=context,
                      severity=severity or CODES[code][1])


class VerificationError(RuntimeError):
    """Raised by ``compile_graph(verify="strict")`` / the CLI when a plan
    has error-severity diagnostics.  Carries the full diagnostic list."""

    def __init__(self, name: str, diagnostics: list[Diagnostic]):
        self.diagnostics = diagnostics
        errors = [d for d in diagnostics if d.severity is Severity.ERROR]
        lines = "\n".join("  " + d.render() for d in diagnostics)
        super().__init__(
            f"static verification of {name!r} failed: "
            f"{len(errors)} error(s), "
            f"{len(diagnostics) - len(errors)} warning(s)\n{lines}")


def render_report(name: str, diagnostics: list[Diagnostic],
                  extra: str = "") -> str:
    """Human-readable per-plan report block (the CLI's output unit)."""
    errors = sum(d.severity is Severity.ERROR for d in diagnostics)
    warnings = len(diagnostics) - errors
    head = (f"== {name}: "
            + ("clean" if not diagnostics
               else f"{errors} error(s), {warnings} warning(s)"))
    body = "\n".join("  " + d.render() for d in diagnostics)
    parts = [head]
    if extra:
        parts.append(extra)
    if body:
        parts.append(body)
    return "\n".join(parts)
