"""ExecutionPlan <-> bytes codec for the persistent plan cache.

Serves the byte-identity contract: a decoded cache hit must equal a cold
``compile_graph`` of the same request in every field the contract covers
-- candidate metrics, allocation, the three analytic reports, the
``evaluated`` count, the raw instruction-stream words, and the verifier
diagnostics.  So the codec stores those *verbatim* (msgpack round-trips
int and float64 bit-exactly) instead of recomputing anything at decode
time -- recomputation would be both slower (hits must serve in ~ms) and
a place for drift to hide.

Only the structural skeleton is rebuilt at decode: ``graph`` and ``hw``
arrive with the request itself (the cache key guarantees they match what
the record was compiled from), and ``grouped``/``blocks``/``runs`` are
pure deterministic functions of them (``group_nodes`` /
``split_blocks`` / ``monotone_runs``).  ``SearchResult.events`` (what one
historical run *survived*) and ``SearchResult.pruned`` (how much of the
space one run's incumbent bounded away -- a warm-started compile prunes
more than a cold one while producing the identical plan) are run
*history*, not plan content, so both are deliberately dropped; decoded
plans report ``events=[]`` / ``pruned=0``.  ``evaluated`` IS kept: under
``count_pruned=True`` it equals the full enumeration count, a
deterministic function of the request.

Layout: one msgpack map, ``{"v": CACHE_SCHEMA_VERSION, ...}``; the
instruction stream rides as the raw little-endian uint32 byte string of
``isa.encode_stream`` (terminator words included), so hit/cold stream
equality is literal ``bytes`` equality.  The map is written by
``packing.packb``, so a record is byte-equal to the JAX package's
``encode_plan`` of an equal plan, and it keeps msgpack's refusals: a
numpy scalar in a plan raises ``TypeError`` here, never a silent
conversion.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic, Severity
from repro_torch.core.allocator import Allocation
from repro_torch.core.compiler import ExecutionPlan
from repro_torch.core.cutpoint import (Candidate, SearchResult,
                                       monotone_runs, split_blocks)
from repro_torch.core.dram import DRAMReport
from repro_torch.core.grouping import group_nodes
from repro_torch.core.hw import FPGAConfig
from repro_torch.core.ir import Graph
from repro_torch.core.isa import decode_stream, encode_stream
from repro_torch.core.sram import SRAMReport
from repro_torch.core.timing import LatencyReport
from repro_torch.service.canonical import CACHE_SCHEMA_VERSION
from repro_torch.service.packing import packb, unpackb


class PlanCodecError(ValueError):
    """The blob is not a plan record this codec version can decode."""


def _enc_policy(policy: dict[int, str]) -> list:
    return [[gid, mode] for gid, mode in sorted(policy.items())]


def _dec_policy(items: list) -> dict[int, str]:
    return {gid: mode for gid, mode in items}


def _enc_alloc(a: Allocation) -> dict:
    return {
        "policy": _enc_policy(a.policy),
        "in": sorted(a.alloc_in.items()),
        "out": sorted(a.alloc_out.items()),
        "shortcut": sorted(a.alloc_shortcut.items()),
        "buff": list(a.buff),
        "side_buff": a.side_buff,
        "spilled": sorted(a.spilled),
        "boundary_writes": sorted(a.boundary_writes),
        "boundary_reads": sorted(a.boundary_reads.items()),
    }


def _dec_alloc(d: dict) -> Allocation:
    return Allocation(
        policy=_dec_policy(d["policy"]),
        alloc_in=dict(map(tuple, d["in"])),
        alloc_out=dict(map(tuple, d["out"])),
        alloc_shortcut=dict(map(tuple, d["shortcut"])),
        buff=list(d["buff"]),
        side_buff=d["side_buff"],
        spilled=set(d["spilled"]),
        boundary_writes=set(d["boundary_writes"]),
        boundary_reads=dict(map(tuple, d["boundary_reads"])),
    )


def encode_plan(plan: ExecutionPlan) -> bytes:
    cand = plan.candidate
    rec = {
        "v": CACHE_SCHEMA_VERSION,
        "candidate": {
            "cuts": list(cand.cuts),
            "policy": _enc_policy(cand.policy),
            "lat": cand.latency_cycles,
            "dram_total": cand.dram_total,
            "dram_fm": cand.dram_fm,
            "sram": cand.sram_total,
            "bram": cand.bram18k,
            "feasible": bool(cand.feasible),
        },
        "alloc": _enc_alloc(plan.alloc),
        "sram": {
            "weight_buff": plan.sram.weight_buff,
            "row_buff": plan.sram.row_buff,
            "out_buff": plan.sram.out_buff,
            "write_buff": plan.sram.write_buff,
            "buff": list(plan.sram.buff),
            "side_buff": plan.sram.side_buff,
            "sram_total": plan.sram.sram_total,
            "bram18k": plan.sram.bram18k,
        },
        "dram": {"fm": plan.dram.fm_bytes, "w": plan.dram.weight_bytes},
        "latency": {
            "cycles": plan.latency.cycles,
            "per_group": sorted(plan.latency.per_group.items()),
        },
        "stream": encode_stream(plan.instructions).tobytes()
        if plan.instructions else b"",
        "diagnostics": [
            [d.code, d.message, d.gid, d.word, d.context,
             d.severity.value] for d in plan.diagnostics],
    }
    if plan.search is not None:
        # `pruned` (like `events`) is run-history, not plan content: a
        # warm-started compile legitimately prunes MORE than a cold one
        # while producing the identical plan, so it stays out of the
        # record -- otherwise hit/cold byte-identity would break for
        # warm-compiled records.  `path` IS plan content: whether the
        # record came from the oracle-exact exhaustive argmin or from
        # coordinate descent is a deterministic function of the request
        # (space vs exhaustive_limit), and the warm-start donor filter
        # keys on it.
        rec["search"] = {"evaluated": plan.search.evaluated,
                         "path": plan.search.path}
    return packb(rec)


def decode_plan(blob: bytes, graph: Graph, hw: FPGAConfig) -> ExecutionPlan:
    """Rebuild an ExecutionPlan for ``(graph, hw)`` from ``blob``.

    The caller owns the guarantee that ``blob`` was compiled from an
    equivalent request -- in the service that guarantee *is* the cache
    key.
    """
    try:
        rec = unpackb(blob)
    except Exception as e:
        raise PlanCodecError(f"undecodable plan record: {e}") from e
    if not isinstance(rec, dict) or rec.get("v") != CACHE_SCHEMA_VERSION:
        raise PlanCodecError(
            f"plan record schema {rec.get('v') if isinstance(rec, dict) else '?'} "
            f"!= expected {CACHE_SCHEMA_VERSION}")
    gg = group_nodes(graph)
    alloc = _dec_alloc(rec["alloc"])
    c = rec["candidate"]
    cand = Candidate(
        cuts=tuple(c["cuts"]), policy=alloc.policy, alloc=alloc,
        latency_cycles=c["lat"], dram_total=c["dram_total"],
        dram_fm=c["dram_fm"], sram_total=c["sram"], bram18k=c["bram"],
        feasible=c["feasible"])
    search = None
    if "search" in rec:
        blocks = split_blocks(gg)
        search = SearchResult(
            best=cand, evaluated=rec["search"]["evaluated"],
            runs=monotone_runs(blocks), blocks=blocks,
            pruned=0, path=rec["search"].get("path", "exhaustive"))
    s = rec["sram"]
    stream = np.frombuffer(rec["stream"], dtype=np.uint32)
    return ExecutionPlan(
        graph=graph, grouped=gg, hw=hw, candidate=cand, alloc=alloc,
        sram=SRAMReport(weight_buff=s["weight_buff"],
                        row_buff=s["row_buff"], out_buff=s["out_buff"],
                        write_buff=s["write_buff"], buff=list(s["buff"]),
                        side_buff=s["side_buff"],
                        sram_total=s["sram_total"], bram18k=s["bram18k"]),
        dram=DRAMReport(fm_bytes=rec["dram"]["fm"],
                        weight_bytes=rec["dram"]["w"]),
        latency=LatencyReport(cycles=rec["latency"]["cycles"],
                              per_group=dict(map(
                                  tuple, rec["latency"]["per_group"]))),
        instructions=decode_stream(stream) if stream.size else [],
        search=search,
        diagnostics=[
            Diagnostic(code=code, message=msg, gid=gid, word=word,
                       context=ctx, severity=Severity(sev))
            for code, msg, gid, word, ctx, sev in rec["diagnostics"]])
