"""The benchmark's plain reference: what each compile has to return.

The modules beside this one are a frozen copy of the port's host oracle, as
``src/repro_torch/core`` had it when the benchmark was added, trimmed to
what a plan needs (no search engine, no journals): the graph IR,
the grouping pass, the allocator (Algorithm 1), the SRAM / DRAM / latency
models, the ISA and the cut-tuple encoding.  ``space.py`` adds a plain
enumeration of the whole cut space on a device, in blocks, for the argmin.
Nothing here imports the program: the network and the accelerator come
from a configuration's data, and the program's plans are only read to be
judged.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .cuts import evaluate, monotone_runs, split_blocks
from .grouping import group_nodes
from .hw import FPGAConfig
from .ir import Graph, LayerNode
from .isa import generate_instructions
from .space import Space
from .timing import LatencyReport


def build_graph(network: dict) -> Graph:
    """The network of a configuration file: one node a row of its table."""
    cols = network["columns"]
    nodes = [LayerNode(idx=i, **dict(zip(cols, row)))
             for i, row in enumerate(network["layers"])]
    graph = Graph(network["name"], nodes)
    graph.validate()
    return graph


def accelerator(fields: dict) -> FPGAConfig:
    return FPGAConfig(**fields)


class Reference:
    """Plans of one network, priced in ``precision``: ``"float64"`` as the
    configuration states, ``"float32"`` for the control."""

    def __init__(self, network: dict, device, precision: str = "float64"):
        self.gg = group_nodes(build_graph(network))
        self.blocks = split_blocks(self.gg)
        self.runs = monotone_runs(self.blocks)
        self.device = device
        self.precision = precision
        self._costs = {}

    def space(self, hw: FPGAConfig) -> Space:
        return Space(self.gg, self.blocks, self.runs, hw)

    def plan(self, hw: FPGAConfig, objective: str, exhaustive_limit: int):
        """The plan an exact exhaustive search returns for one request."""
        # the budget enters only the argmin: one pricing serves every budget
        key = tuple(sorted((k, v) for k, v in vars(hw).items()
                           if k != "sram_budget"))
        if key not in self._costs:
            space = self.space(hw)
            if space.size > exhaustive_limit:
                raise ValueError(f"{space.size} cut tuples exceed the "
                                 f"exhaustive limit {exhaustive_limit}: "
                                 f"the reference prices exhaustive search "
                                 f"only")
            self._costs[key] = space.costs(self.device, self.precision)
        costs = self._costs[key]
        index = costs.winner(hw.sram_budget, objective)
        ev = evaluate(self.gg, self.blocks, self.runs, costs.cuts(index), hw)
        latency = ev.latency
        if self.precision == "float64":
            priced = (float(costs.latency[index]), int(costs.sram[index]),
                      int(costs.dram[index]))
            oracle = (latency.cycles, ev.sram.sram_total, ev.dram.total)
            if priced != oracle:
                raise RuntimeError(f"the enumeration priced {priced}, the "
                                   f"oracle {oracle}, at {ev.cuts}")
        else:
            per = {g: np.dtype(self.precision).type(v)
                   for g, v in latency.per_group.items()}
            total = np.dtype(self.precision).type(0)
            for v in per.values():
                total = total + v
            latency = LatencyReport(
                cycles=float(total),
                per_group={g: float(v) for g, v in per.items()})
        candidate = SimpleNamespace(
            cuts=ev.cuts, latency_cycles=latency.cycles,
            dram_total=ev.dram.total, dram_fm=ev.dram.fm_bytes,
            sram_total=ev.sram.sram_total, bram18k=ev.sram.bram18k,
            feasible=ev.feasible)
        return SimpleNamespace(
            candidate=candidate, alloc=ev.alloc, sram=ev.sram, dram=ev.dram,
            latency=latency,
            instructions=generate_instructions(self.gg, ev.alloc),
            search=SimpleNamespace(evaluated=costs.latency.numel(),
                                   path="exhaustive"))


def shape(network: dict) -> dict:
    """The counts the roofline bounds take from a network: groups, runs,
    cut tuples, and per group (side path?, producers, shortcut?)."""
    from .allocator import graph_steps

    gg = group_nodes(build_graph(network))
    runs = monotone_runs(split_blocks(gg))
    size = 1
    for r in runs:
        size *= len(r) + 1
    return {"groups": len(gg.groups), "runs": len(runs), "space": size,
            "steps": [(s.is_side, len(s.gin), s.sc_src is not None)
                      for s in graph_steps(gg)]}
