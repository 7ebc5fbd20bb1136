"""The reference's host oracle against the JAX package's, on the CPU.

``reference/`` holds a frozen copy of the port's host code (grouping, the
allocator, the SRAM / DRAM / latency models, the ISA), so a fault the port
carries there would be copied into the reference and pass the check.  These
tests hold the copy to the JAX package (``src/repro``), the implementation
the port was ported from, on the benchmark's own networks: the same groups,
blocks and runs, and at cut tuples drawn over every run's range, the same
allocation, reports and instruction words.  The JAX package is imported
inside the tests only: no run of the benchmark loads it.
"""
import dataclasses
import json
import math
import random
from pathlib import Path
from types import SimpleNamespace

import pytest

import reference
from harness import check
from reference import cuts

BENCH = Path(__file__).resolve().parent
MIB = 1 << 20
TUPLES = 40                     # cut tuples a configuration, beside the ends


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def jax_package_oracle(network: dict):
    """The JAX package's grouped graph, blocks and runs, and a function of
    ``(cuts, accelerator fields)`` -> its plan of those cuts."""
    from repro.core import cutpoint, dram, grouping, hw, ir, isa, sram, timing

    cols = network["columns"]
    graph = ir.Graph(network["name"],
                     [ir.LayerNode(idx=i, **dict(zip(cols, row)))
                      for i, row in enumerate(network["layers"])])
    gg = grouping.group_nodes(graph)
    blocks = cutpoint.split_blocks(gg)
    runs = cutpoint.monotone_runs(blocks)

    def plan(cut_tuple, fields):
        acc = hw.FPGAConfig(**fields)
        c = cutpoint.evaluate(gg, blocks, runs, cut_tuple, acc)
        lat = timing.latency_report(gg, c.alloc, acc)
        # The total is the per-group terms added left to right in gid
        # order, as the JAX package's batched search ranks candidates
        # (``latency_cycles_fast_batch``: np.cumsum).  Its scalar report
        # adds them with the builtin ``sum``, which Python 3.12 compensates,
        # so that total may differ in its last bits; every term is held
        # bit for bit.
        total = 0.0
        for v in lat.per_group.values():
            total += v
        assert math.isclose(lat.cycles, total, rel_tol=1e-12)
        lat = SimpleNamespace(cycles=total, per_group=lat.per_group)
        return SimpleNamespace(
            candidate=dataclasses.replace(c, latency_cycles=total),
            alloc=c.alloc, sram=sram.sram_report(gg, c.alloc, acc),
            dram=dram.dram_report(gg, c.alloc), latency=lat,
            instructions=isa.generate_instructions(gg, c.alloc),
            search=SimpleNamespace(evaluated=0, path="-"))

    return gg, blocks, runs, plan


def reference_plan(ref: reference.Reference, cut_tuple, fields):
    ev = cuts.evaluate(ref.gg, ref.blocks, ref.runs, cut_tuple,
                       reference.accelerator(fields))
    candidate = SimpleNamespace(
        cuts=ev.cuts, latency_cycles=ev.latency.cycles,
        dram_total=ev.dram.total, dram_fm=ev.dram.fm_bytes,
        sram_total=ev.sram.sram_total, bram18k=ev.sram.bram18k,
        feasible=ev.feasible)
    return SimpleNamespace(
        candidate=candidate, alloc=ev.alloc, sram=ev.sram, dram=ev.dram,
        latency=ev.latency,
        instructions=reference.generate_instructions(ref.gg, ev.alloc),
        search=SimpleNamespace(evaluated=0, path="-"))


def cut_tuples(runs, seed: int) -> list[tuple]:
    """Every run at its first and at its last cut, and ``TUPLES`` tuples
    drawn uniformly over each run's ``len(run) + 1`` choices."""
    rng = random.Random(seed)
    out = [tuple(0 for _ in runs), tuple(len(r) for r in runs)]
    out += [tuple(rng.randint(0, len(r)) for r in runs)
            for _ in range(TUPLES)]
    return out


def mismatches(name: str) -> list:
    cfg = config(name)
    ref = reference.Reference(cfg["network"], "cpu")
    gg, blocks, runs, jax_plan = jax_package_oracle(cfg["network"])
    assert [[n.idx for n in g.nodes] for g in gg.groups] == \
        [[n.idx for n in g.nodes] for g in ref.gg.groups]
    assert [dataclasses.astuple(b) for b in blocks] == \
        [dataclasses.astuple(b) for b in ref.blocks]
    assert runs == ref.runs
    out = []
    for i, cut_tuple in enumerate(cut_tuples(runs, seed=len(runs))):
        # the budgets of the mix in turn: feasibility is a part too
        fields = dict(cfg["accelerator"]["fields"],
                      sram_budget=(2 + i % 11) * MIB)
        want = check.plan_parts(jax_plan(cut_tuple, fields))
        got = check.plan_parts(reference_plan(ref, cut_tuple, fields))
        out += [(cut_tuple, part) for part in check.PARTS
                if got[part] != want[part]]
    return out


@pytest.mark.parametrize("name", ["yolov2-416", "yolov3-416"])
def test_reference_oracle_equals_jax_package(name):
    assert mismatches(name) == []


@pytest.mark.parametrize("part", ["allocation", "instructions"])
def test_planted_oracle_fault_is_caught(part, monkeypatch):
    """A fault in the copied allocator or ISA, which the port would share,
    is caught by the JAX package's plans."""
    from reference import isa

    if part == "allocation":
        inner = cuts.allocate

        def allocate(gg, policy):
            alloc = inner(gg, policy)
            alloc.side_buff += 1
            return alloc

        monkeypatch.setattr(cuts, "allocate", allocate)
    else:
        encode = isa.GroupInstruction.encode
        monkeypatch.setattr(isa.GroupInstruction, "encode",
                            lambda self: encode(self) ^ 1)
    assert any(p == part for _, p in mismatches("yolov2-416"))
