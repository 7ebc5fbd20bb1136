"""``correct`` on the CPU: a sound run passes; the control (the reference
in float32 in the program's place) and each fault a compile cell can have,
planted under the timed path, are rejected."""
import time

import pytest
import torch

from harness.cell import run_cell
from harness.control import Control

SEED = 2 ** 31 + 11


def run(small, **kw):
    root, cell = small
    return run_cell(cell, SEED, 1.0, False, time.perf_counter(),
                    device="cpu", root=root, log=lambda _msg: None, **kw)


def test_sound_run_is_correct(small):
    r = run(small)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_control_is_rejected(small):
    r = run(small, program=Control)
    assert not r["correct"]
    assert r["checks"]["reports_mismatch"]["value"] > 0
    assert r["failed"] > 0


def _state_unchanged(monkeypatch):
    """K1's replay hands back its initial state."""
    from repro_torch.kernels import search_pipeline
    from repro_torch.kernels.alloc_scan import N_STATS, STAT_FEAS, \
        AllocScanResult

    def alloc_scan(at, frame, backend=None):
        B = frame.shape[0]
        stats = torch.zeros((B, N_STATS), dtype=torch.int64)
        stats[:, STAT_FEAS] = 1
        return AllocScanResult(io=torch.zeros((B, at.n), dtype=torch.int64),
                               stats=stats)

    monkeypatch.setattr(search_pipeline, "alloc_scan", alloc_scan)


def _half_the_chunks(monkeypatch):
    """Every other chunk of the search left out: its winner never posted."""
    from repro_torch.kernels import search_pipeline

    inner = search_pipeline.run_chunks

    def run_chunks(*args, **kwargs):
        rows = inner(*args, **kwargs)
        rows[1::2] = float("inf")
        return rows

    monkeypatch.setattr(search_pipeline, "run_chunks", run_chunks)


def _answer_altered(monkeypatch):
    """One instruction field altered where the instructions are made."""
    from repro_torch.core import compiler

    inner = compiler.generate_instructions

    def generate_instructions(gg, alloc):
        ins = inner(gg, alloc)
        ins[-1].act = (ins[-1].act + 1) % 5
        return ins

    monkeypatch.setattr(compiler, "generate_instructions",
                        generate_instructions)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_chunks,
                                   _answer_altered],
                         ids=["state_unchanged", "half_the_chunks",
                              "answer_altered"])
def test_fault_is_rejected(plant, small, monkeypatch):
    plant(monkeypatch)
    r = run(small)
    assert not r["correct"] and r["failed"] > 0
