"""How ``correct`` is decided: every plan the window returned, part by part,
against the reference's plan for the same request.

A plan is read into four parts, each compared exactly:

* ``winner``: the winning cut tuple, ``evaluated`` and the search's path;
* ``allocation``: the policy, the buffer assignments, the buffer sizes, the
  spills and the boundary reads and writes;
* ``reports``: every integer of the SRAM and DRAM reports and of the
  candidate, and the bits of every float64 latency (total and per group);
* ``instructions``: the instruction words.

Each number compared counts the checked compiles whose part differs from
the reference's; its limit is 0, since the compiler's contract is that a
plan is exact.
"""
from __future__ import annotations

PARTS = ("winner", "allocation", "reports", "instructions")
# the numbers compared, each with its limit (exact: 0)
LIMITS = {"failed_requests": 0,
          **{f"{part}_mismatch": 0 for part in PARTS}}


def _items(d) -> tuple:
    return tuple(sorted((int(k), int(v)) for k, v in d.items()))


def _bits(x) -> str:
    return float(x).hex()


def plan_parts(plan, words: bool = True) -> dict:
    """The four parts of a plan as plain values (a plan of the program or
    of the reference: both carry the same attribute names).  With
    ``words=False`` the instructions are their fields, not their encoded
    words: the cheap form a fingerprint takes in the window."""
    c, a, s, d, lat = (plan.candidate, plan.alloc, plan.sram, plan.dram,
                       plan.latency)
    if words:
        ins = tuple(int(w) for i in plan.instructions for w in i.encode())
    else:
        ins = tuple(tuple(vars(i).values()) for i in plan.instructions)
    return {
        "winner": (tuple(int(x) for x in c.cuts), int(plan.search.evaluated),
                   str(plan.search.path)),
        "allocation": (
            tuple(sorted((int(g), str(m)) for g, m in a.policy.items())),
            _items(a.alloc_in), _items(a.alloc_out),
            _items(a.alloc_shortcut), tuple(int(b) for b in a.buff),
            int(a.side_buff), tuple(sorted(int(g) for g in a.spilled)),
            tuple(sorted(int(g) for g in a.boundary_writes)),
            _items(a.boundary_reads)),
        "reports": (
            int(s.weight_buff), int(s.row_buff), int(s.out_buff),
            int(s.write_buff), tuple(int(b) for b in s.buff),
            int(s.side_buff), int(s.sram_total), int(s.bram18k),
            int(d.fm_bytes), int(d.weight_bytes), _bits(lat.cycles),
            tuple((int(g), _bits(v)) for g, v in lat.per_group.items()),
            _bits(c.latency_cycles), int(c.dram_total), int(c.dram_fm),
            int(c.sram_total), int(c.bram18k), bool(c.feasible)),
        "instructions": ins,
    }


def fingerprint(plan) -> int:
    """A plan's identity within one process: two plans with one
    fingerprint have the same parts.  Cheap enough to take in the window
    after every compile; the parts, with the instruction words, are then
    read once from one plan of each fingerprint."""
    return hash(tuple(plan_parts(plan, words=False).values()))


def compare(answers: list, program_parts: dict,
            reference_parts: dict) -> tuple[dict, int]:
    """The numbers compared, and how many requests failed (raised, or
    returned a plan the check rejects).  ``answers``: per request run,
    ``(request key, fingerprint, or None when the request raised)``;
    ``program_parts``: ``(key, fingerprint)`` -> the parts of a plan the
    program returned; ``reference_parts``: key -> the reference plan's, for
    every key sent."""
    out = dict.fromkeys(LIMITS, 0)
    rejected = 0
    for key, fp in answers:
        if fp is None:
            out["failed_requests"] += 1
            rejected += 1
            continue
        got, want = program_parts[key, fp], reference_parts[key]
        wrong = [part for part in PARTS if got[part] != want[part]]
        for part in wrong:
            out[f"{part}_mismatch"] += 1
        rejected += bool(wrong)
    return out, rejected


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
