"""The PyTorch port's fault-tolerant search runtime, every failure path,
deterministically, on the CPU -- and against the JAX package's.

Case for case with tests/test_fault_tolerance.py, on the port (engines on
the host: ``journal``, and ``device:torch`` for the fallback): retry after
worker death, transient-error re-dispatch, straggler duplicates, engine
fallback, journal resume and preemption drain all merge to a
``SearchResult`` byte-identical to the clean serial run, with every
recovery surfaced on ``result.events``; exhausted retries, a corrupt
journal and deterministic worker exceptions raise.  Beyond those:

* the chaos draws (``_unit``, ``event_for``) equal the reference's over a
  grid of seeds, sites and keys, and a seeded chaos run gives the same
  multiset of ``FaultEvent`` kinds and tasks in both packages;
* the journal: a port record decodes to the same values as the
  reference's record of the same task result; a truncated or altered
  record raises ``JournalError``; the module imports with no msgpack; a
  journal written under one engine resumes a search under another;
* one spawn pool: the executor's initializer carries the injector to
  spawn workers, and a (fork-inherited) hold gate is refused there.
"""
import collections
import contextlib
import hashlib
import multiprocessing as mp
import signal
import subprocess
import sys
from pathlib import Path

import pytest

import repro.checkpoint.checkpoint as ref_ckpt
import repro.core.search_pool as ref_pool
import repro.runtime.chaos as ref_chaos
from repro.core.options import CompileOptions as RefOptions

import repro_torch.core.compiler as port_compiler
from repro_torch.checkpoint.checkpoint import (JournalError, TaskJournal,
                                               decode_record, encode_record)
from repro_torch.cnn import build_cnn
from repro_torch.core import search_pool
from repro_torch.core.cutpoint import (CandidateMetrics, monotone_runs,
                                       search, split_blocks)
from repro_torch.core.grouping import group_nodes
from repro_torch.core.hw import KCU1500
from repro_torch.core.options import CompileOptions, degrade_engine
from repro_torch.core.search_pool import (TASKS_PER_WORKER,
                                          ParallelSearchDriver,
                                          SearchPreempted, partition_space)
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StragglerMonitor)

from test_torch_search_pool import TEST_LIMIT, assert_results_identical
from torch_parity import both

ROOT = Path(__file__).resolve().parent.parent
HAS_FORK = "fork" in mp.get_all_start_methods()
needs_fork = pytest.mark.skipif(
    not HAS_FORK, reason="fork start method required for workers to "
    "inherit the parent-installed chaos injector")

# Zoo slice for the fuzz sweep: resnet50/152 take the partitioned
# exhaustive path at TEST_LIMIT, the rest the per-start descent path, so
# both task shapes get fuzzed.
FUZZ_CNNS = ["vgg16-conv", "yolov3", "resnet50", "resnet152",
             "efficientnet-b1", "retinanet", "mobilenet-v3"]

TEST_OPTS = CompileOptions(engine="journal", device="cpu",
                           exhaustive_limit=TEST_LIMIT)


@contextlib.contextmanager
def injected(injector, module=chaos):
    module.install(injector)
    try:
        yield injector
    finally:
        module.uninstall()


@pytest.fixture(scope="module")
def resnet():
    gg = group_nodes(build_cnn("resnet50"))
    return gg, search(gg, KCU1500, TEST_OPTS)


def resnet_prefixes(gg, workers=2):
    blocks = split_blocks(gg)
    runs = monotone_runs(blocks)
    return partition_space(runs, workers * TASKS_PER_WORKER)[0]


# ------------------------------------------------------- satellite fixes
def test_step_end_without_step_start_is_a_noop():
    m = StragglerMonitor()
    assert m.step_end(0) is False
    assert len(m.times) == 0
    m.step_start()
    assert m.step_end(1) is False          # normal pairing still works
    assert len(m.times) == 1


def test_straggler_monitor_honors_window():
    m = StragglerMonitor(window=7)
    for i in range(50):
        m.observe(1.0 + i)
    assert m.times.maxlen == 7
    assert len(m.times) == 7
    assert list(m.times) == [1.0 + i for i in range(43, 50)]


def test_straggler_ewma_deadline_warmup_and_value():
    m = StragglerMonitor(threshold=3.0, alpha=0.5, min_samples=3)
    assert m.straggler_after() is None
    m.observe(1.0)
    m.observe(1.0)
    assert m.straggler_after() is None     # still warming up
    m.observe(2.0)
    # ewma: 1.0 -> 1.0 -> 0.5*2 + 0.5*1 = 1.5; deadline = 3 * 1.5
    assert m.straggler_after() == pytest.approx(4.5)


def test_preemption_guard_uninstall_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard()
    g.install()
    assert signal.getsignal(signal.SIGTERM) == g._handler
    g.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    with PreemptionGuard() as g2:          # context manager pairs them
        assert signal.getsignal(signal.SIGTERM) == g2._handler
        assert not g2.preempted
        g2.request()
        assert g2.preempted
    assert signal.getsignal(signal.SIGTERM) == before


# ------------------------------------------------------- chaos injector
def test_chaos_schedule_is_deterministic_and_scheduling_independent():
    a = chaos.ChaosInjector(seed=11, p_kill=0.2, p_raise=0.2, p_delay=0.2)
    b = chaos.ChaosInjector(seed=11, p_kill=0.2, p_raise=0.2, p_delay=0.2)
    keys = [(i, j) for i in range(10) for j in range(10)]
    plan_a = [a.event_for("task", k) for k in keys]
    # same seed, any consultation order -> same plan per (site, key)
    plan_b = [b.event_for("task", k) for k in reversed(keys)][::-1]
    assert plan_a == plan_b
    assert any(e is not None for e in plan_a)
    assert any(e is None for e in plan_a)
    # a different seed reshuffles the schedule
    c = chaos.ChaosInjector(seed=12, p_kill=0.2, p_raise=0.2, p_delay=0.2)
    assert [c.event_for("task", k) for k in keys] != plan_a
    # sites draw independently
    assert ([a.event_for("device", k) for k in keys] != plan_a)


def test_chaos_explicit_events_override_seeded_draw():
    inj = chaos.ChaosInjector(
        seed=0, p_kill=1.0,
        events={("task", "pinned"): chaos.ChaosEvent("delay", delay_s=0.0)})
    assert inj.event_for("task", "pinned").action == "delay"
    assert inj.event_for("task", "other").action == "kill"
    with pytest.raises(ValueError):
        chaos.ChaosEvent("segfault")


def test_chaos_fires_only_below_max_attempt():
    inj = chaos.ChaosInjector(seed=0, p_raise=1.0, max_attempt=2)
    with pytest.raises(chaos.ChaosError):
        inj.fire("task", "k", attempt=0)
    with pytest.raises(chaos.ChaosError):
        inj.fire("task", "k", attempt=1)
    inj.fire("task", "k", attempt=2)       # retry budget reached: no-op
    assert chaos.ChaosError.transient is True
    assert [f[3] for f in inj.fired] == ["raise", "raise"]


def test_chaos_maybe_fire_is_noop_without_injector():
    chaos.uninstall()
    chaos.maybe_fire("task", "anything")   # must not raise


def test_chaos_draws_equal_reference():
    """``_unit`` is the same formula in both packages, so a seed plans the
    same faults in both: every draw and every planned event agrees."""
    keys = ([(i, j) for i in range(6) for j in range(6)]
            + [(0, 2, 1, 1), (), "pinned", 7, (1,)])
    for seed in (0, 1, 3, 7, 11, 12345, 2 ** 40 + 3):
        kw = dict(seed=seed, p_kill=0.1, p_raise=0.2, p_delay=0.15,
                  delay_s=0.3, max_attempt=2)
        port, ref = chaos.ChaosInjector(**kw), ref_chaos.ChaosInjector(**kw)
        for site in ("task", "device", "other"):
            for key in keys:
                assert (chaos._unit(seed, site, key)
                        == ref_chaos._unit(seed, site, key))
                p, r = port.event_for(site, key), ref.event_for(site, key)
                assert (p is None) == (r is None), (seed, site, key)
                if p is not None:
                    assert ((p.action, p.delay_s, p.max_attempt)
                            == (r.action, r.delay_s, r.max_attempt))


# --------------------------------------------- retry & healing identity
@needs_fork
def test_worker_kill_heals_pool_and_result_is_bit_identical(resnet):
    gg, serial = resnet
    with injected(chaos.ChaosInjector(seed=7, p_kill=0.08)):
        with ParallelSearchDriver(workers=2, mp_context="fork") as d:
            r = d.search(gg, KCU1500, TEST_OPTS)
    assert_results_identical(serial, r, ctx="kill-retry")
    retries = [e for e in r.events if e.kind == "retry"]
    assert retries and all("died" in e.detail for e in retries)


@needs_fork
def test_transient_raise_is_retried_and_bit_identical(resnet):
    gg, serial = resnet
    with injected(chaos.ChaosInjector(seed=3, p_raise=0.15)):
        with ParallelSearchDriver(workers=2, mp_context="fork") as d:
            r = d.search(gg, KCU1500, TEST_OPTS)
    assert_results_identical(serial, r, ctx="transient-raise")
    retries = [e for e in r.events if e.kind == "retry"]
    assert retries and all("chaos" in e.detail for e in retries)


@needs_fork
def test_exhausted_retries_raise_instead_of_hanging(resnet):
    gg, _ = resnet
    # max_attempt high: the fault outlives every re-dispatch
    with injected(chaos.ChaosInjector(seed=7, p_kill=0.08, max_attempt=99)):
        with ParallelSearchDriver(workers=2, mp_context="fork",
                                  max_retries=1) as d:
            with pytest.raises(RuntimeError,
                               match="worker process died"):
                d.search(gg, KCU1500, TEST_OPTS)
    with injected(chaos.ChaosInjector(seed=3, p_raise=0.15,
                                      max_attempt=99)):
        with ParallelSearchDriver(workers=2, mp_context="fork",
                                  max_retries=1) as d:
            with pytest.raises(RuntimeError, match="failed after"):
                d.search(gg, KCU1500, TEST_OPTS)


@needs_fork
def test_deterministic_worker_exception_is_never_retried(resnet):
    """A worker exception without ``transient=True`` propagates unchanged
    on the first attempt -- no retry events, no healing.  (Invalid knob
    values never reach workers through the options; the bad objective
    is put into the task by hand.)"""
    gg, _ = resnet
    prefixes, suffix_dims = partition_space(
        monotone_runs(split_blocks(gg)), 2 * TASKS_PER_WORKER)
    with ParallelSearchDriver(workers=2, mp_context="fork",
                              max_retries=5) as d:
        tasks = [t._replace(objective="bogus") for t in d.subspace_tasks(
            gg, KCU1500, prefixes, suffix_dims, TEST_OPTS)]
        events = []
        with pytest.raises(ValueError, match="bogus"):
            d._run_tasks(search_pool._run_subspace, tasks, keys=prefixes,
                         events=events)
    assert events == []


# --------------------------------------------- deadlines & degradation
@needs_fork
def test_straggler_duplicate_rescues_delayed_task(resnet):
    """The victim's first attempt blocks on a chaos *hold* gate: it
    deterministically overruns the deadline, the speculative duplicate
    (attempt 1, past max_attempt; the journal engine on the host) completes,
    and the gate is released before pool shutdown."""
    gg, serial = resnet
    victim = resnet_prefixes(gg)[1]
    inj = chaos.ChaosInjector()
    release = inj.hold("task", victim)
    with injected(inj):
        with ParallelSearchDriver(workers=2, mp_context="fork",
                                  task_deadline_s=0.5) as d:
            try:
                r = d.search(gg, KCU1500, TEST_OPTS.replace(engine="device"))
            finally:
                release()
    assert_results_identical(serial, r, ctx="straggler")
    stragglers = [e for e in r.events if e.kind == "straggler"]
    # Membership, not equality: a slow CI box may legitimately flag a
    # second straggler; the held victim must always be one of them.
    assert victim in [e.task for e in stragglers]


@needs_fork
def test_device_replay_falls_back_to_journal_loudly(resnet):
    gg, serial = resnet
    victim = resnet_prefixes(gg)[2]
    ev = {("device", victim): chaos.ChaosEvent("raise")}
    with injected(chaos.ChaosInjector(events=ev)):
        with ParallelSearchDriver(workers=2, mp_context="fork") as d:
            r = d.search(gg, KCU1500, TEST_OPTS.replace(engine="device"))
    assert_results_identical(serial, r, ctx="device-fallback")
    falls = [e for e in r.events if e.kind == "device_fallback"]
    assert [e.task for e in falls] == [victim]
    assert "journal engine on cpu substituted" in falls[0].detail


def test_chaos_hold_gate_mechanics():
    """hold events need a gate, release unblocks fire(), and attempts at
    or past max_attempt (the straggler duplicate) never block."""
    with pytest.raises(ValueError, match="need a gate"):
        chaos.ChaosEvent("hold")
    inj = chaos.ChaosInjector()
    release = inj.hold("task", ("k",))
    inj.fire("task", ("k",), attempt=1)     # duplicate: no block
    release()
    inj.fire("task", ("k",), attempt=0)     # released gate: returns
    assert [f[:2] for f in inj.fired] == [("task", ("k",))]


def test_degrade_engine_keeps_the_batch_and_equals_reference():
    for spelling in ("pipeline", "pipeline:cuda@1048576", "device:torch",
                     "device@64", "journal", "journal@512"):
        want = ref_pool.degrade_engine(spelling.replace(":cuda", "")
                                       .replace(":torch", ""))
        assert degrade_engine(spelling) == want, spelling


# ------------------------------------------------- journal & preemption
def test_resume_skips_journaled_tasks_bit_identically(resnet, tmp_path):
    gg, serial = resnet
    with ParallelSearchDriver(workers=2) as d:
        first = d.search(gg, KCU1500,
                         TEST_OPTS.replace(resume_dir=tmp_path))
    assert_results_identical(serial, first, ctx="journal-first")
    assert not first.events               # clean run: nothing to report
    recs = list(tmp_path.glob("search_*/task_*.rec"))
    assert recs                           # every task committed a record
    with ParallelSearchDriver(workers=2) as d:
        second = d.search(gg, KCU1500,
                          TEST_OPTS.replace(resume_dir=tmp_path))
    assert_results_identical(serial, second, ctx="journal-second")
    resumed = [e for e in second.events if e.kind == "resume"]
    assert len(resumed) == len(recs)      # fully replayed from disk


@needs_fork
def test_killed_compile_resumes_from_task_journal(resnet, tmp_path):
    """A parallel search killed mid-flight (injected worker death, retries
    exhausted) leaves its completed tasks journaled; the re-run resumes
    and merges to the byte-identical result, surfacing the resume
    events."""
    gg, serial = resnet
    # the doomed task is dispatched last (sliding window), so earlier
    # tasks deterministically complete and journal before it exhausts
    doomed = resnet_prefixes(gg)[-1]
    ev = {("task", doomed): chaos.ChaosEvent("kill", max_attempt=99)}
    with injected(chaos.ChaosInjector(events=ev)):
        with ParallelSearchDriver(workers=2, mp_context="fork",
                                  max_retries=1) as d:
            with pytest.raises(RuntimeError, match="worker process died"):
                d.search(gg, KCU1500,
                         TEST_OPTS.replace(resume_dir=tmp_path))
    survivors = len(list(tmp_path.glob("search_*/task_*.rec")))
    assert survivors > 0
    with ParallelSearchDriver(workers=2, mp_context="fork") as d:
        r = d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))
    assert_results_identical(serial, r, ctx="resume-after-kill")
    assert len([e for e in r.events if e.kind == "resume"]) == survivors


def test_preemption_drains_and_resumes(resnet, tmp_path):
    gg, serial = resnet
    guard = PreemptionGuard()
    guard.request()                       # SIGTERM already latched
    with ParallelSearchDriver(workers=2, guard=guard) as d:
        with pytest.raises(SearchPreempted, match="resume to finish"):
            d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))
    with ParallelSearchDriver(workers=2) as d:
        r = d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))
    assert_results_identical(serial, r, ctx="resume-after-preempt")


def test_corrupt_journal_record_raises_not_resumes(resnet, tmp_path):
    gg, _ = resnet
    with ParallelSearchDriver(workers=2) as d:
        d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))
    rec = sorted(tmp_path.glob("search_*/task_*.rec"))[0]
    rec.write_bytes(b"\x00garbage" + rec.read_bytes()[4:])
    with ParallelSearchDriver(workers=2) as d:
        with pytest.raises(JournalError, match="corrupt task-journal"):
            d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))


def test_journal_keyed_by_search_content(resnet, tmp_path):
    """A journal written for one (objective, partition) must not be
    consulted for another -- the content hash separates them."""
    gg, _ = resnet
    with ParallelSearchDriver(workers=2) as d:
        d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))
        serial_sram = search(gg, KCU1500,
                             TEST_OPTS.replace(objective="sram"))
        r = d.search(gg, KCU1500,
                     TEST_OPTS.replace(objective="sram",
                                       resume_dir=tmp_path))
    assert not [e for e in r.events if e.kind == "resume"]
    assert_results_identical(serial_sram, r, ctx="objective-keyed")
    assert len(list(tmp_path.glob("search_*"))) == 2


def test_journal_record_decodes_like_reference(tmp_path):
    """The same task result through both packages' record codecs: the
    bytes differ (JSON + zlib here, msgpack there), the decoded values
    do not -- the float64 latency bit for bit."""
    m = CandidateMetrics(cuts=(5, 0, 2, 0, 2, 0, 1, 0),
                         latency_cycles=2163251.1999999993,
                         dram_total=12345678901, dram_fm=42,
                         sram_total=7040896, bram18k=1729, feasible=True)
    sub = (m, 1093, 7, ())
    desc = (m, frozenset({(0, 1, 2), (3, 4, 5), (0, 1, 3)}), ())
    for enc, dec, ref_enc, result in (
            (search_pool._encode_subspace, search_pool._decode_subspace,
             ref_pool._encode_subspace, sub),
            (search_pool._encode_descent, search_pool._decode_descent,
             ref_pool._encode_descent, desc)):
        ours = TaskJournal(tmp_path / "port", "k")
        theirs = ref_ckpt.TaskJournal(tmp_path / "ref", "k")
        ours.put("t", enc(result))
        theirs.put("t", ref_enc(result))
        got, want = ours.get("t"), theirs.get("t")
        assert got == want
        assert got["lat"].hex() == want["lat"].hex() == (
            2163251.1999999993).hex()
        back = dec(got)
        assert back[0] == m and back[1:-1] == result[1:-1]
    # a pruned-away task (no candidate) round-trips too
    assert search_pool._decode_subspace(decode_record(encode_record(
        search_pool._encode_subspace((None, 0, 81, ()))))) == (None, 0, 81,
                                                              ())


def test_truncated_or_altered_record_raises(tmp_path):
    j = TaskJournal(tmp_path, "k")
    j.put("t", {"lat": 818109.9999999995, "cuts": [1, 2], "ok": True})
    assert j.get("t")["lat"] == 818109.9999999995 and len(j) == 1
    path = j._path("t")
    good = path.read_bytes()
    for bad in (good[:-3],                        # truncated blob
                good[:len(good) // 3],            # truncated header
                good[:-1] + bytes([good[-1] ^ 1]),  # altered blob
                good.replace(b'"zlib"', b'"zstd"'),  # foreign codec
                b""):
        path.write_bytes(bad)
        with pytest.raises(JournalError, match="corrupt task-journal"):
            j.get("t")
    assert j.get("absent") is None


def test_journal_imports_without_msgpack_or_jax():
    code = ("import sys\n"
            "sys.modules['msgpack'] = None\n"
            "sys.modules['jax'] = None\n"
            "from repro_torch.checkpoint.checkpoint import (decode_record,"
            " encode_record)\n"
            "import repro_torch.core.search_pool\n"
            "rec = {'lat': 2163251.1999999993, 'cuts': [1, 0], 'n': 2**70}\n"
            "assert decode_record(encode_record(rec)) == rec\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok"]


def test_pipeline_journal_resumes_journal_engine(resnet, tmp_path):
    """The journal is keyed by the plan, not the engine: records a
    ``pipeline:torch`` search committed resume a ``journal`` search, and
    the plan is the same."""
    gg, serial = resnet
    with ParallelSearchDriver(workers=2) as d:
        first = d.search(gg, KCU1500, TEST_OPTS.replace(
            engine="pipeline:torch", resume_dir=tmp_path))
        second = d.search(gg, KCU1500, TEST_OPTS.replace(
            resume_dir=tmp_path))
    assert_results_identical(serial, first, ctx="pipeline-journal")
    assert_results_identical(serial, second, ctx="journal-resume")
    resumed = [e for e in second.events if e.kind == "resume"]
    assert len(resumed) == len(resnet_prefixes(gg)) > 1


# ------------------------------------------------------------ zoo fuzz
@needs_fork
@pytest.mark.parametrize("name", FUZZ_CNNS)
def test_fuzzed_chaos_preserves_bit_identity_across_zoo(name):
    """Seeded kill/raise/delay schedule over each zoo net (exhaustive
    and descent task shapes): whatever fires, the merged result must be
    byte-identical to the clean serial run."""
    gg = group_nodes(build_cnn(name))
    serial = search(gg, KCU1500, TEST_OPTS)
    # stable per-net seed (Python's str hash is salted per process)
    seed = int(hashlib.sha256(name.encode()).hexdigest()[:4], 16)
    inj = chaos.ChaosInjector(seed=seed, p_kill=0.03, p_raise=0.05,
                              p_delay=0.05, delay_s=0.2)
    with injected(inj):
        with ParallelSearchDriver(workers=2, mp_context="fork") as d:
            r = d.search(gg, KCU1500, TEST_OPTS)
    assert_results_identical(serial, r, ctx=f"fuzz-{name}")


@needs_fork
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzzed_chaos_multi_seed_resume_round_trip(seed, tmp_path, resnet):
    """Different schedules, same invariant: chaos run journals into
    resume_dir, a clean resume completes it, both bit-identical."""
    gg, serial = resnet
    inj = chaos.ChaosInjector(seed=seed, p_kill=0.05, p_raise=0.05)
    with injected(inj):
        with ParallelSearchDriver(workers=2, mp_context="fork") as d:
            try:
                r = d.search(gg, KCU1500,
                             TEST_OPTS.replace(resume_dir=tmp_path))
            except RuntimeError:
                r = None                  # retries exhausted: resume below
    if r is not None:
        assert_results_identical(serial, r, ctx=f"fuzz-seed{seed}")
    with ParallelSearchDriver(workers=2, mp_context="fork") as d:
        r2 = d.search(gg, KCU1500, TEST_OPTS.replace(resume_dir=tmp_path))
    assert_results_identical(serial, r2, ctx=f"fuzz-seed{seed}-resume")


@needs_fork
@pytest.mark.parametrize("engine", ["journal", "device"])
@pytest.mark.parametrize("name", ["resnet50", "yolov3"])
def test_seeded_chaos_events_equal_reference(name, engine):
    """One seeded schedule (transient raises at the task and device
    sites, task-local, so no fault takes another task down with it) run
    through both packages' pools: the same multiset of event kinds and
    tasks, and the same plan."""
    ref, port = both(name)
    kw = dict(seed=5, p_raise=0.3)
    ropts = RefOptions(engine=engine, exhaustive_limit=TEST_LIMIT)
    with injected(ref_chaos.ChaosInjector(**kw), ref_chaos):
        with ref_pool.ParallelSearchDriver(workers=2,
                                           mp_context="fork") as d:
            want = d.search(ref.gg, ref.hw, ropts)
    with injected(chaos.ChaosInjector(**kw)):
        with ParallelSearchDriver(workers=2, mp_context="fork") as d:
            got = d.search(port.gg, port.hw, TEST_OPTS.replace(
                engine=engine))
    kinds = collections.Counter((e.kind, e.task) for e in got.events)
    assert kinds == collections.Counter((e.kind, e.task)
                                        for e in want.events)
    assert kinds, "the seed plans no fault on this net"
    assert tuple(got.best.cuts) == tuple(want.best.cuts)
    assert got.evaluated == want.evaluated


# ------------------------------------------------------------ spawn pool
def test_spawn_workers_receive_the_injector(resnet):
    """Spawn workers inherit nothing: the executor's initializer installs
    the injector the parent had when it created the pool, so one pinned
    ``raise`` gives exactly one retry."""
    gg, serial = resnet
    victim = resnet_prefixes(gg)[3]
    ev = {("task", victim): chaos.ChaosEvent("raise")}
    with injected(chaos.ChaosInjector(events=ev)):
        with ParallelSearchDriver(workers=2, mp_context="spawn") as d:
            r = d.search(gg, KCU1500, TEST_OPTS)
            assert d.start_method == "spawn"
    assert_results_identical(serial, r, ctx="spawn-chaos")
    assert [(e.kind, e.task, e.attempt) for e in r.events] == [
        ("retry", victim, 1)]


def test_fork_built_hold_gate_is_refused_under_spawn(resnet):
    """A hold gate is fork-inherited: the pool refuses it before any spawn
    worker starts."""
    inj = chaos.ChaosInjector()
    release = inj.hold("task", (0, 0))
    try:
        with injected(inj):
            with ParallelSearchDriver(workers=2, mp_context="spawn") as d:
                with pytest.raises(ValueError, match="fork-inherited"):
                    d.map(abs, [-1])
                assert d._pool is None
    finally:
        release()


# ------------------------------------------------------ compiler surface
@needs_fork
def test_compile_graph_resume_dir_end_to_end(tmp_path):
    graph = build_cnn("resnet50")
    clean = port_compiler.compile_graph(graph, KCU1500,
                                        TEST_OPTS.replace(workers=2))
    doomed = resnet_prefixes(group_nodes(graph))[-1]
    ev = {("task", doomed): chaos.ChaosEvent("kill", max_attempt=99)}
    with injected(chaos.ChaosInjector(events=ev)):
        with pytest.raises(RuntimeError, match="worker process died"):
            port_compiler.compile_graph(
                graph, KCU1500, TEST_OPTS.replace(
                    workers=2, max_retries=1, resume_dir=tmp_path))
    guard = PreemptionGuard()              # never trips: a clean run
    plan = port_compiler.compile_graph(
        graph, KCU1500, TEST_OPTS.replace(workers=2, resume_dir=tmp_path),
        guard=guard)
    assert plan.candidate.cuts == clean.candidate.cuts
    assert plan.latency.cycles == clean.latency.cycles
    assert plan.search.evaluated == clean.search.evaluated
    assert plan.instructions == clean.instructions
    assert any(e.kind == "resume" for e in plan.search.events)
