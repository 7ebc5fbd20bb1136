"""Seeded plan-mutation fuzzer: prove the static verifier's coverage.

A verifier that passes every healthy plan proves nothing until it also
*fails* every broken one.  ``mutate_plan`` injects one violation from a
known class into a deep copy of a compiled plan -- clobber a buffer
assignment, swap two live ranges, overflow a bit-field, drop a spill,
forge a shortcut operand -- and records which diagnostic codes the
injection must trigger.  Two gates ride on it:

* **mutation kill** -- for every class that applies to a plan, the
  verifier must emit at least one error-severity diagnostic, including
  one of the class's expected codes (``kill_matrix``);
* **differential** -- every mutant the dynamic ``Simulator`` can detect
  (an exception, or DRAM counters drifting from the original plan's
  reports) must also be caught statically (``simulator_detects`` vs the
  static verdict), so the O(plan) verifier never lags the oracle.

Mutations are seeded and deterministic: the same ``(plan, cls, seed)``
always produces the same mutant, so CI failures replay exactly.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from dataclasses import dataclass

from repro_torch.analysis.diagnostics import Diagnostic, Severity
from repro_torch.analysis.liveness import journal_trace
from repro_torch.analysis.verifier import verify_plan
from repro_torch.core.allocator import Allocation
from repro_torch.core.isa import FIELD_WIDTHS, OFFCHIP, GroupInstruction

#: every violation class the fuzzer knows how to inject, with the
#: diagnostic codes at least one of which must fire on the mutant.
CLASSES: dict[str, tuple[str, ...]] = {
    # reroute a frame group's output into a buffer whose tensor is still
    # live -> the shortcut-clobber class Algorithm 1 exists to prevent
    "clobber_alloc": ("SF020", "SF024", "SF021", "SF025"),
    # swap the alloc_out assignments of two frame groups -> both diverge
    # from the journal and at least one read goes to the wrong place
    "swap_live": ("SF024", "SF020", "SF021", "SF025"),
    # write a field value past its encoding slot width
    "overflow_field": ("SF050",),
    # erase a spill record -> the tensor silently never reaches DRAM
    "drop_spill": ("SF023", "SF024", "SF041", "SF022", "SF042"),
    # invent a shortcut operand on a group with no eltwise add
    "forge_shortcut": ("SF054", "SF016", "SF010"),
}


@dataclass
class Mutant:
    """One injected violation: the mutated plan pieces plus provenance."""
    cls: str
    seed: int
    description: str
    gg: object
    hw: object
    alloc: Allocation
    instructions: list[GroupInstruction]
    expect: tuple[str, ...]

    def verify(self) -> list[Diagnostic]:
        return verify_plan(self.gg, self.alloc, self.instructions,
                           self.hw, feasible=True)

    def statically_killed(self) -> bool:
        """True when the verifier both errors AND names an expected code."""
        diags = self.verify()
        errs = [d for d in diags if d.severity is Severity.ERROR]
        return bool(errs) and any(d.code in self.expect for d in errs)


def _copy_alloc(a: Allocation) -> Allocation:
    return Allocation(
        policy=dict(a.policy), alloc_in=dict(a.alloc_in),
        alloc_out=dict(a.alloc_out),
        alloc_shortcut=dict(a.alloc_shortcut), buff=list(a.buff),
        side_buff=a.side_buff, spilled=set(a.spilled),
        boundary_writes=set(a.boundary_writes),
        boundary_reads=dict(a.boundary_reads))


def _copy_instructions(ins: list[GroupInstruction]) -> list[GroupInstruction]:
    return [dataclasses.replace(i) for i in ins]


def mutate_plan(plan, cls: str, seed: int) -> Mutant | None:
    """Inject one ``cls`` violation into a copy of ``plan``.

    Returns None when the class does not apply (e.g. ``drop_spill`` on a
    plan with no spills) -- callers record the skip, they do not fail."""
    if cls not in CLASSES:
        raise KeyError(f"unknown mutation class {cls!r}; "
                       f"expected one of {sorted(CLASSES)}")
    rng = random.Random(seed)
    gg, hw = plan.grouped, plan.hw
    alloc = _copy_alloc(plan.alloc)
    instructions = _copy_instructions(plan.instructions)
    by_gid = {i.gid: i for i in instructions}

    def built(desc: str) -> Mutant:
        return Mutant(cls=cls, seed=seed, description=desc, gg=gg, hw=hw,
                      alloc=alloc, instructions=instructions,
                      expect=CLASSES[cls])

    if cls == "clobber_alloc":
        # Victims: journal intervals still live strictly after some frame
        # group that owns a different buffer -- rerouting that group's
        # output onto the victim's buffer destroys data a later consumer
        # reads.
        trace = journal_trace(gg, alloc.policy)
        options = []
        for gid, b in sorted(alloc.alloc_out.items()):
            for iv in trace.intervals:
                if iv.buffer != b and iv.owner != gid \
                        and iv.start <= gid < iv.end:
                    options.append((gid, iv))
        if not options:
            return None
        gid, iv = rng.choice(options)
        alloc.alloc_out[gid] = iv.buffer
        by_gid[gid].alloc_out = iv.buffer
        return built(f"rerouted g{gid}.alloc_out -> buf{iv.buffer}, "
                     f"destroying {iv.render()}")

    if cls == "swap_live":
        gids = sorted(gid for gid, b in alloc.alloc_out.items()
                      if gid in by_gid)
        pairs = [(a, b) for i, a in enumerate(gids) for b in gids[i + 1:]
                 if alloc.alloc_out[a] != alloc.alloc_out[b]]
        if not pairs:
            return None
        a, b = rng.choice(pairs)
        alloc.alloc_out[a], alloc.alloc_out[b] = \
            alloc.alloc_out[b], alloc.alloc_out[a]
        by_gid[a].alloc_out, by_gid[b].alloc_out = \
            alloc.alloc_out[a], alloc.alloc_out[b]
        return built(f"swapped alloc_out of g{a} (buf"
                     f"{alloc.alloc_out[b]}) and g{b} "
                     f"(buf{alloc.alloc_out[a]})")

    if cls == "overflow_field":
        ins = rng.choice(instructions)
        name = rng.choice([n for n in FIELD_WIDTHS
                           if FIELD_WIDTHS[n] < 32])
        width = FIELD_WIDTHS[name]
        value = (1 << width) + rng.randrange(1 << width)
        setattr(ins, name, value)
        return built(f"g{ins.gid}.{name} = {value} "
                     f"(past its {width}-bit slot)")

    if cls == "drop_spill":
        if not alloc.spilled:
            return None
        gid = rng.choice(sorted(alloc.spilled))
        alloc.spilled.discard(gid)
        return built(f"dropped spill record of g{gid}: its output now "
                     f"never reaches DRAM")

    if cls == "forge_shortcut":
        options = [i for i in instructions
                   if i.fused_eltwise == 0 and i.src_shortcut == -1
                   and i.gid > 0]
        if not options:
            return None
        ins = rng.choice(options)
        forged = rng.randrange(len(gg.groups))
        ins.src_shortcut = forged
        return built(f"forged g{ins.gid}.src_shortcut = {forged} on a "
                     f"group with no eltwise add")

    raise AssertionError(cls)


def simulator_detects(plan, mutant: Mutant) -> bool:
    """Dynamic-oracle verdict on a mutant: does the dry-mode Simulator
    observe the corruption?  Detection = an exception during the run, a
    dangling DRAM read, or DRAM counters drifting from the *original*
    plan's reports (the analytic model of the unmutated allocation)."""
    from repro_torch.core.simulator import simulate
    try:
        _, c = simulate(mutant.gg, mutant.alloc, mutant.instructions,
                        execute=False)
    except Exception:
        return True
    return (c.fm_total != plan.dram.fm_bytes
            or c.weight_reads != plan.dram.weight_bytes
            or c.dangling_reads > 0)


def kill_matrix(plans: dict[str, object],
                seeds: tuple[int, ...] = (0, 1, 2)) -> list[dict]:
    """Run every mutation class x seed over every plan; one row per
    attempted injection.  Rows: net, cls, seed, applied, killed,
    matched_codes, description."""
    rows = []
    for net, plan in plans.items():
        for cls in CLASSES:
            for seed in seeds:
                m = mutate_plan(plan, cls, seed)
                if m is None:
                    rows.append({"net": net, "cls": cls, "seed": seed,
                                 "applied": False, "killed": None,
                                 "codes": [], "description": "n/a"})
                    continue
                diags = m.verify()
                errs = sorted({d.code for d in diags
                               if d.severity is Severity.ERROR})
                rows.append({
                    "net": net, "cls": cls, "seed": seed, "applied": True,
                    "killed": bool(errs) and any(c in m.expect
                                                 for c in errs),
                    "codes": errs, "description": m.description})
    return rows


# --------------------------------------------------- bound-mutation fuzzer
# Adversarial mutations of ``CutpointEngine.prefix_bound``, the admissible
# lower bound branch-and-bound pruning rests on (core/cutpoint.py).  A
# broken bound does NOT corrupt a plan -- it silently prunes the true
# argmin -- so the plan verifier above cannot see it; instead the
# *differential property layer* (tests/test_branch_bound.py) must kill it:
#
# * ``deflate_bound`` -- the bound claims lower than the prefix-exact
#   value.  Deflation is still admissible (it never prunes the optimum,
#   only prunes less), which is exactly why a bit-identity test can never
#   catch it; the full-depth exactness property does: at
#   ``depth == len(runs)`` the completion is unique, so the bound must
#   EQUAL the candidate's exact primary metric, and any deflation breaks
#   the equality.
# * ``inflate_bound`` -- the bound claims higher than the true completion
#   floor: the production-dangerous direction (prunes sub-spaces that may
#   hold the argmin).  Killed by the admissibility property -- bound key
#   <= every brute-forced completion key -- and by full-depth exactness.
#
# The gate is the same shape as ``kill_matrix``: every (net, class, seed)
# mutant must fail at least one differential probe, 100%.
BOUND_CLASSES: dict[str, str] = {
    "deflate_bound": "bound claims lower than the prefix-exact value",
    "inflate_bound": "bound claims higher than the true completion floor",
}


def mutate_bound(bound_fn, cls: str, seed: int):
    """A broken variant of ``bound_fn`` (a ``prefix_bound`` method).

    Deterministic in ``(cls, seed)``: the same seed always produces the
    same deflation/inflation factor.  The constant +-1 keeps the mutation
    strict even at a zero bound."""
    if cls not in BOUND_CLASSES:
        raise KeyError(f"unknown bound-mutation class {cls!r}; "
                       f"expected one of {sorted(BOUND_CLASSES)}")
    rng = random.Random(seed)
    if cls == "deflate_bound":
        scale = rng.uniform(0.3, 0.9)

        def mutated(cuts, depth, objective):
            return bound_fn(cuts, depth, objective) * scale - 1
    else:
        scale = rng.uniform(1.5, 4.0)

        def mutated(cuts, depth, objective):
            return bound_fn(cuts, depth, objective) * scale + 1
    mutated.cls = cls
    mutated.seed = seed
    mutated.scale = scale
    return mutated


def bound_survives_differential(engine, bound_fn=None, seed: int = 0,
                                probes: int = 6,
                                max_slice: int = 256) -> bool:
    """Run the property layer's two bound checks against ``bound_fn``.

    Returns True iff every probe passes -- the genuine
    ``engine.prefix_bound`` survives (that is
    ``test_branch_bound.test_bound_differential_sound``); every
    :func:`mutate_bound` mutant must NOT.  Probes are seeded and
    deterministic:

    1. **full-depth exactness** -- on a random full tuple, the bound at
       ``depth == len(runs)`` must equal ``evaluate``'s exact primary
       metric for each objective;
    2. **admissibility vs brute force** -- on the deepest prefix of that
       tuple whose completion count fits ``max_slice``, the bound key
       ``(False, lb, 0)`` must not exceed any brute-forced completion's
       objective key.
    """
    from repro_torch.core.cutpoint import _key
    if bound_fn is None:
        bound_fn = engine.prefix_bound
    runs = engine.runs
    nr = len(runs)
    if not nr:
        return True
    dims = [len(r) + 1 for r in runs]
    rng = random.Random(seed ^ 0x5FBD)
    objectives = ("latency", "sram", "dram")
    for _ in range(probes):
        t = tuple(rng.randrange(d) for d in dims)
        m = engine.evaluate(t, memoize=False)
        for obj in objectives:
            if bound_fn(t, nr, obj) != _key(m, obj)[1]:
                return False
        depth, total = nr, 1
        while depth > 1 and total * dims[depth - 1] <= max_slice:
            depth -= 1
            total *= dims[depth]
        if depth == nr:
            continue
        batch = [t[:depth] + s for s in
                 itertools.product(*[range(d) for d in dims[depth:]])]
        scored = engine.score_batch(batch, memoize=False)
        for obj in objectives:
            bk = (False, bound_fn(t, depth, obj), 0)
            if any(bk > _key(c, obj) for c in scored):
                return False
    return True


def bound_kill_matrix(engines: dict[str, object],
                      seeds: tuple[int, ...] = (0, 1, 2),
                      probes: int = 6) -> list[dict]:
    """Every bound-mutation class x seed over every engine; one row per
    injection.  Rows: net, cls, seed, killed, scale."""
    rows = []
    for net, engine in engines.items():
        for cls in BOUND_CLASSES:
            for seed in seeds:
                mutated = mutate_bound(engine.prefix_bound, cls, seed)
                killed = not bound_survives_differential(
                    engine, mutated, seed=seed, probes=probes)
                rows.append({"net": net, "cls": cls, "seed": seed,
                             "killed": killed, "scale": mutated.scale})
    return rows


def render_kill_matrix(rows: list[dict]) -> str:
    lines = ["net                cls             seed killed codes"]
    for r in rows:
        status = ("skip" if not r["applied"]
                  else "KILL" if r["killed"] else "MISS")
        lines.append(f"{r['net']:<18} {r['cls']:<15} {r['seed']:>4} "
                     f"{status:<6} {','.join(r['codes'])}")
    applied = [r for r in rows if r["applied"]]
    killed = sum(r["killed"] for r in applied)
    lines.append(f"-- {killed}/{len(applied)} applied mutants killed "
                 f"({len(rows) - len(applied)} skipped as inapplicable)")
    return "\n".join(lines)
