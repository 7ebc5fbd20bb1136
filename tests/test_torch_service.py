"""The port's compile service (``repro_torch.service``) against the JAX
package's (``repro.service``).

The first part mirrors ``tests/test_service.py`` on the port, with
``device="cpu"`` (the service's default options run the cut search on the
GPU): request hashing, the plan codec's byte-identity contract, the plan
cache's commit / eviction / corruption discipline, warm-started misses and
the daemon's queueing, coalescing and failure semantics.

The second part holds the two packages against each other on the 8 zoo
nets: ``request_key`` and ``graph_fingerprint`` equal; ``encode_plan``
byte-equal up to the two float64 latency totals of ROADMAP R1 (the
reference totals ``latency.cycles`` and ``candidate.latency_cycles`` with
builtin ``sum``, compensated on Python >= 3.12; the port with
``timing.seq_sum``, a plain left-to-right sum), and outright where R1 does
not show; cache records written by one package and read by the other.
"""
import dataclasses
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import repro.checkpoint.checkpoint as ref_checkpoint
import repro.service as ref_service
from repro.cnn import build_cnn as ref_build_cnn
from repro.core.compiler import compile_graph as ref_compile_graph
from repro.core.hw import KCU1500 as REF_HW
from repro.core.options import CompileOptions as RefOptions
from repro.service.codec import decode_plan as ref_decode_plan

import repro_torch.checkpoint.checkpoint as port_checkpoint
from repro_torch.cnn import build_cnn
from repro_torch.cnn.zoo import CNN_BUILDERS
from repro_torch.core.compiler import compile_graph
from repro_torch.core.hw import KCU1500, FPGAConfig
from repro_torch.core.ir import Graph, make_input
from repro_torch.core.isa import encode_stream
from repro_torch.core.options import CompileOptions
from repro_torch.core.timing import seq_sum
from repro_torch.kernels import _build
from repro_torch.service import (CACHE_SCHEMA_VERSION, CompileService,
                                 PlanCache, PlanCodecError, ServiceClosed,
                                 ServiceOverloaded, canonical_graph,
                                 decode_plan, encode_plan, graph_fingerprint,
                                 hw_signature, request_key)
from repro_torch.service.packing import packb
from torch_parity import ALL_CNNS
import torch_parity

torch_parity.one_thread()

ROOT = Path(__file__).resolve().parent.parent
TEST_OPTS = CompileOptions(exhaustive_limit=50_000, device="cpu")
# the two packages at their default plan options, on the host journal
# engine (the port's pipeline would walk yolov2's 7,962,624 tuples on the
# CPU)
CROSS_SIZE = 64
REF_OPTS = RefOptions(engine="journal")
PORT_OPTS = CompileOptions(engine="journal", device="cpu")
# where R1 does not show at CROSS_SIZE: the records are byte-equal as they
# stand
R1_FREE = ("vgg16-conv", "yolov2", "yolov3")


def assert_plans_identical(a, b, ctx=""):
    """The byte-identity contract the cache serves: every plan field the
    contract covers, compared bit-for-bit."""
    for f in ("cuts", "latency_cycles", "dram_total", "dram_fm",
              "sram_total", "bram18k", "feasible", "policy"):
        assert getattr(a.candidate, f) == getattr(b.candidate, f), (ctx, f)
    for f in ("policy", "alloc_in", "alloc_out", "alloc_shortcut", "buff",
              "side_buff", "spilled", "boundary_writes", "boundary_reads"):
        assert getattr(a.alloc, f) == getattr(b.alloc, f), (ctx, f)
    assert a.sram == b.sram, ctx
    assert a.dram == b.dram, ctx
    assert a.latency == b.latency, ctx
    sa = encode_stream(a.instructions).tobytes() if a.instructions else b""
    sb = encode_stream(b.instructions).tobytes() if b.instructions else b""
    assert sa == sb, f"{ctx}: instruction streams differ"
    assert a.diagnostics == b.diagnostics, ctx
    if a.search is not None or b.search is not None:
        assert a.search.evaluated == b.search.evaluated, ctx


# --------------------------------------------------------- canonical form
def _shuffled_twin(name="vgg16-conv", size=64):
    g1 = build_cnn(name, size)
    g2 = Graph(g1.name + "-rebuilt")
    g2.nodes = [n.clone(name=f"renamed_{n.idx}") for n in g1.nodes]
    g2.validate()
    return g1, g2


def test_canonical_graph_ignores_names():
    g1, g2 = _shuffled_twin()
    assert canonical_graph(g1) == canonical_graph(g2)
    assert graph_fingerprint(g1) == graph_fingerprint(g2)


def test_canonical_graph_insertion_order_independent():
    """Two topologically-valid insertion orders of the same diamond
    canonicalize identically (the branches differ in kernel size, so they
    are not automorphic twins)."""
    def build(order):
        g = Graph("diamond")
        make_input(g, 16, 16)
        g.add("conv", out_ch=8, k=3, act="relu")
        stem = len(g.nodes) - 1
        if order == "ab":
            a = g.add("conv", inputs=[stem], out_ch=8, k=1, act="linear")
            b = g.add("conv", inputs=[stem], out_ch=8, k=3, act="linear")
        else:
            b = g.add("conv", inputs=[stem], out_ch=8, k=3, act="linear")
            a = g.add("conv", inputs=[stem], out_ch=8, k=1, act="linear")
        g.add("add", inputs=[a.idx, b.idx])
        g.validate()
        return g

    assert canonical_graph(build("ab")) == canonical_graph(build("ba"))
    assert (request_key(build("ab"), KCU1500, TEST_OPTS)
            == request_key(build("ba"), KCU1500, TEST_OPTS))


def test_canonical_graph_distinguishes_add_operand_order():
    def build(swap):
        g = Graph("ops")
        make_input(g, 16, 16)
        g.add("conv", out_ch=8, k=3, act="relu")
        entry = len(g.nodes) - 1
        g.add("conv", out_ch=8, k=1, act="relu")
        g.add("conv", out_ch=8, k=3, act="linear")
        main = len(g.nodes) - 1
        ins = [entry, main] if swap else [main, entry]
        g.add("add", inputs=ins)
        g.validate()
        return g

    assert canonical_graph(build(False)) != canonical_graph(build(True))


def test_request_key_cross_process_stable():
    """The hash survives a fresh interpreter with another PYTHONHASHSEED,
    and is the JAX package's key."""
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "from repro_torch.cnn import build_cnn\n"
        "from repro_torch.core.hw import KCU1500\n"
        "from repro_torch.core.options import CompileOptions\n"
        "from repro_torch.service import request_key\n"
        "print(request_key(build_cnn('mobilenet-v3', 64), KCU1500,\n"
        "      CompileOptions(exhaustive_limit=50_000)))\n")
    keys = set()
    for seed in ("0", "12345"):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=ROOT, env={"PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin"})
        assert out.returncode == 0, out.stderr
        keys.add(out.stdout.strip())
    assert len(keys) == 1
    key = keys.pop()
    assert key == request_key(build_cnn("mobilenet-v3", 64), KCU1500,
                              TEST_OPTS)
    assert key == ref_service.request_key(
        ref_build_cnn("mobilenet-v3", 64), REF_HW,
        RefOptions(exhaustive_limit=50_000))


def test_request_key_plan_fields_only():
    g = build_cnn("vgg16-conv", 64)
    base = request_key(g, KCU1500, TEST_OPTS)
    sched = request_key(g, KCU1500, TEST_OPTS.replace(
        workers=8, engine="device", verify="strict", batch_size=7))
    assert sched == base
    # the device is scheduling-only too
    assert request_key(g, KCU1500, TEST_OPTS.replace(device="cuda")) == base
    assert request_key(g, KCU1500, TEST_OPTS.replace(prune=False)) != base
    assert request_key(g, KCU1500,
                       TEST_OPTS.replace(objective="sram")) != base
    hw2 = dataclasses.replace(KCU1500, name="other", to=KCU1500.to * 2)
    assert request_key(g, hw2, TEST_OPTS) != base


# ----------------------------------------------------------------- codec
@pytest.mark.parametrize("name", sorted(CNN_BUILDERS))
def test_codec_round_trip_zoo(name):
    g = build_cnn(name)
    plan = compile_graph(g, options=TEST_OPTS)
    back = decode_plan(encode_plan(plan), g, KCU1500)
    assert_plans_identical(plan, back, ctx=f"codec-{name}")
    assert encode_plan(back) == encode_plan(plan)


def test_codec_rejects_garbage_and_stale_schema():
    g = build_cnn("vgg16-conv", 64)
    with pytest.raises(PlanCodecError, match="undecodable"):
        decode_plan(b"not msgpack at all", g, KCU1500)
    stale = packb({"v": CACHE_SCHEMA_VERSION + 1})
    with pytest.raises(PlanCodecError, match="schema"):
        decode_plan(stale, g, KCU1500)
    good = encode_plan(compile_graph(g, options=TEST_OPTS))
    for bad in (good[:-1], good + b"\x00"):     # truncated, trailing bytes
        with pytest.raises(PlanCodecError, match="undecodable"):
            decode_plan(bad, g, KCU1500)


def test_codec_keeps_msgpack_refusals():
    """A numpy scalar in a plan raises in the encoder, as msgpack does: the
    port builds its plans from Python numbers."""
    import numpy as np
    g = build_cnn("vgg16-conv", 64)
    plan = compile_graph(g, options=TEST_OPTS)
    plan.dram = dataclasses.replace(plan.dram,
                                    fm_bytes=np.int64(plan.dram.fm_bytes))
    with pytest.raises(TypeError):
        encode_plan(plan)


# ----------------------------------------------------------------- cache
def test_cache_put_get_and_digest_check(tmp_path):
    c = PlanCache(tmp_path)
    c.put("a" * 64, b"payload", meta={"x": 1})
    assert ("a" * 64) in c and len(c) == 1
    assert c.get("a" * 64) == b"payload"
    rec = next(tmp_path.glob("plan_*.rec"))
    assert rec.name == f"plan_{'a' * 32}.rec"
    blob = bytearray(rec.read_bytes())
    blob[-1] ^= 0xFF
    rec.write_bytes(bytes(blob))
    assert c.get("a" * 64) is None
    assert len(c) == 0


def test_cache_lru_eviction(tmp_path):
    c = PlanCache(tmp_path, capacity=2)
    c.put("k1" + "0" * 62, b"one", meta={})
    time.sleep(0.02)
    c.put("k2" + "0" * 62, b"two", meta={})
    time.sleep(0.02)
    assert c.get("k1" + "0" * 62) == b"one"
    time.sleep(0.02)
    c.put("k3" + "0" * 62, b"three", meta={})
    assert len(c) == 2
    assert c.get("k2" + "0" * 62) is None
    assert c.get("k1" + "0" * 62) == b"one"
    assert c.get("k3" + "0" * 62) == b"three"


def test_cache_nearest_same_family_closest_hw(tmp_path):
    c = PlanCache(tmp_path)
    sig_near = [["ti", 16], ["to", 32], ["sram_budget", 4_000_000]]
    sig_far = [["ti", 16], ["to", 32], ["sram_budget", 16_000_000]]
    c.put("n1" + "0" * 62, b"x",
          meta={"graph_fp": "famA", "hw_sig": sig_near, "cuts": [1, 2]})
    c.put("n2" + "0" * 62, b"x",
          meta={"graph_fp": "famA", "hw_sig": sig_far, "cuts": [3, 4],
                "path": "exhaustive"})
    c.put("n3" + "0" * 62, b"x",
          meta={"graph_fp": "famB", "hw_sig": sig_near, "cuts": [9, 9]})
    query = [["ti", 16], ["to", 32], ["sram_budget", 5_000_000]]
    assert c.nearest("famA", query) == (1, 2)
    assert c.nearest("famA", query, require_path="exhaustive") == (3, 4)
    assert c.nearest("famC", query) is None


# ---------------------------------------------------------------- daemon
def test_service_hit_is_byte_identical_to_cold_compile(tmp_path):
    g = build_cnn("mobilenet-v3", 64)
    cold = compile_graph(g, options=TEST_OPTS)
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        miss = svc.compile(g)
        hit = svc.compile(g)
        assert svc.stats["misses"] == 1 and svc.stats["hits"] == 1
    assert_plans_identical(cold, miss, ctx="cold-vs-miss")
    assert_plans_identical(cold, hit, ctx="cold-vs-hit")
    assert encode_plan(cold) == encode_plan(hit)


def test_service_hit_survives_restart_and_strict_verify(tmp_path):
    g = build_cnn("vgg16-conv", 64)
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        svc.compile(g)
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        t = svc.submit(g, options=TEST_OPTS.replace(verify="strict"))
        plan = t.result(timeout=60)
        assert t.hit
        assert plan.diagnostics is not None
        assert svc.stats["hits"] == 1 and svc.stats["misses"] == 0


def test_service_warm_start_exact_on_new_hw(tmp_path):
    """A miss for a known net on a new hw config warm-starts from the
    nearest cached plan and returns the oracle-exact argmin: bit-identical
    (``evaluated`` included) to a cold compile."""
    g = build_cnn("resnet50", 64)
    hw2 = dataclasses.replace(KCU1500, name="kcu1500-smallsram",
                              sram_budget=KCU1500.sram_budget // 2)
    cold = compile_graph(g, hw2, options=TEST_OPTS)
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        svc.compile(g)
        t = svc.submit(g, hw2)
        warm = t.result(timeout=120)
        assert not t.hit and t.warm_started
        assert svc.stats["warm_starts"] == 1
    assert_plans_identical(cold, warm, ctx="warm-vs-cold")


def test_service_coalesces_identical_inflight_requests(tmp_path):
    g = build_cnn("vgg16-conv", 64)
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        t1 = svc.submit(g)
        t2 = svc.submit(g)
        assert t1 is t2
        assert svc.stats["coalesced"] == 1
        p1 = t1.result(timeout=60)
        t3 = svc.submit(g)
        assert t3 is not t1
        p3 = t3.result(timeout=60)
    assert_plans_identical(p1, p3, ctx="coalesce")


def test_service_overload_backpressure(tmp_path):
    """A full bounded queue rejects at submit(); a gate stalls the single
    worker so the queue fills."""
    gate = threading.Event()
    started = threading.Event()
    nets = [build_cnn(n, 64) for n in ("vgg16-conv", "mobilenet-v3",
                                       "resnet50", "yolov2")]
    with CompileService(tmp_path, options=TEST_OPTS, max_pending=2,
                        threads=1) as svc:
        orig = svc._fulfil

        def stalled(ticket, graph, hw, opts):
            started.set()
            gate.wait(timeout=30)
            return orig(ticket, graph, hw, opts)

        svc._fulfil = stalled
        tickets = [svc.submit(nets[0])]
        assert started.wait(timeout=30)
        tickets += [svc.submit(nets[1]), svc.submit(nets[2])]
        with pytest.raises(ServiceOverloaded, match="retry with backoff"):
            svc.submit(nets[3])
        assert svc.stats["overloads"] == 1
        gate.set()
        for t in tickets:
            t.result(timeout=120)


def test_service_failure_fails_ticket_not_daemon(tmp_path):
    bad = Graph("bad")                 # no input node: compile must fail
    g = build_cnn("vgg16-conv", 64)
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        t = svc.submit(bad)
        with pytest.raises(Exception):
            t.result(timeout=60)
        assert svc.stats["failures"] == 1
        assert len(svc.cache) == 0
        svc.compile(g)
        assert svc.stats["misses"] == 2


def test_service_closed_rejects_submit(tmp_path):
    svc = CompileService(tmp_path, options=TEST_OPTS)
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(build_cnn("vgg16-conv", 64))
    svc.close()                        # idempotent


def test_service_defaults_to_the_gpu(tmp_path):
    """With no options a miss runs the cut search on the GPU; on a host
    without one the ticket fails (it is not retried on the host) and
    nothing is cached."""
    import torch
    with CompileService(tmp_path) as svc:
        assert (svc.options.engine, svc.options.device) == ("pipeline",
                                                            "cuda")
        if torch.cuda.is_available():
            return
        t = svc.submit(build_cnn("vgg16-conv", 64))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.result(timeout=60)
        assert svc.stats["failures"] == 1 and svc.stats["misses"] == 1
        assert len(svc.cache) == 0


# --------------------------------------------- against the JAX package
@pytest.mark.parametrize("name", ALL_CNNS)
def test_request_key_and_fingerprint_equal_the_reference(name):
    g, rg = build_cnn(name), ref_build_cnn(name)
    assert graph_fingerprint(g) == ref_service.graph_fingerprint(rg)
    assert hw_signature(KCU1500) == ref_service.hw_signature(REF_HW)
    for opts in (CompileOptions(), TEST_OPTS,
                 CompileOptions(backend="pallas", objective="sram")):
        ref_opts = RefOptions(**{f: getattr(opts, f) for f in (
            "objective", "exhaustive_limit", "backend", "prune",
            "count_pruned")})
        assert (request_key(g, KCU1500, opts)
                == ref_service.request_key(rg, REF_HW, ref_opts))


_PLANS: dict = {}


def _both_plans(name):
    """(reference plan, port plan) of ``name`` at CROSS_SIZE."""
    if name not in _PLANS:
        _PLANS[name] = (
            ref_compile_graph(ref_build_cnn(name, CROSS_SIZE),
                              options=REF_OPTS),
            compile_graph(build_cnn(name, CROSS_SIZE), options=PORT_OPTS))
    return _PLANS[name]


def _r1_reference(ref):
    """The reference plan with its two R1 totals replaced by ``seq_sum`` of
    its own ``latency.per_group`` in gid order: the port's total."""
    total = seq_sum([ref.latency.per_group[g]
                     for g in sorted(ref.latency.per_group)])
    return dataclasses.replace(
        ref, candidate=dataclasses.replace(ref.candidate,
                                           latency_cycles=total),
        latency=dataclasses.replace(ref.latency, cycles=total))


@pytest.mark.parametrize("name", ALL_CNNS)
def test_encode_plan_equals_the_reference_up_to_r1(name):
    """``encode_plan`` of the port's plan equals the JAX package's
    ``encode_plan`` of its plan once the reference's two latency totals
    are summed as the port sums them (ROADMAP R1); the totals themselves
    differ by at most a few ulps."""
    ref, port = _both_plans(name)
    assert encode_plan(port) == ref_service.encode_plan(_r1_reference(ref))
    assert port.latency.cycles == pytest.approx(ref.latency.cycles,
                                                rel=1e-13)


@pytest.mark.parametrize("name", R1_FREE)
def test_encode_plan_equals_the_reference_outright(name):
    ref, port = _both_plans(name)
    assert encode_plan(port) == ref_service.encode_plan(ref)


@pytest.mark.parametrize("name", ["yolov2", "resnet152", "mobilenet-v3"])
def test_cache_records_cross_between_packages(name, tmp_path, monkeypatch):
    """A zlib cache record written by either package is read by the other
    and decodes to an equal plan (zstd is forced off on both sides)."""
    monkeypatch.setattr(ref_checkpoint, "zstandard", None)
    monkeypatch.setattr(port_checkpoint, "zstandard", None)
    ref, port = _both_plans(name)
    g, rg = build_cnn(name, CROSS_SIZE), ref_build_cnn(name, CROSS_SIZE)
    key = request_key(g, KCU1500, PORT_OPTS)
    meta = {"graph_fp": graph_fingerprint(g), "hw_sig": hw_signature(KCU1500),
            "cuts": list(port.candidate.cuts), "path": port.search.path}
    port_cache = PlanCache(tmp_path / "port")
    ref_cache = ref_service.PlanCache(tmp_path / "ref")
    port_cache.put(key, encode_plan(port), meta=meta)
    ref_cache.put(key, ref_service.encode_plan(_r1_reference(ref)),
                  meta=meta)
    # the wrappers are byte-equal: same layout, same codec, same meta
    [p_rec] = (tmp_path / "port").glob("plan_*.rec")
    [r_rec] = (tmp_path / "ref").glob("plan_*.rec")
    assert p_rec.name == r_rec.name == f"plan_{key[:32]}.rec"
    assert p_rec.read_bytes() == r_rec.read_bytes()
    # each package reads the other's record
    from_ref = PlanCache(tmp_path / "ref").get(key)
    from_port = ref_service.PlanCache(tmp_path / "port").get(key)
    assert_plans_identical(decode_plan(from_ref, g, KCU1500), port,
                           ctx=f"{name}: port reads the reference's record")
    back = ref_decode_plan(from_port, rg, REF_HW)
    assert ref_service.encode_plan(back) == encode_plan(port)
    assert PlanCache(tmp_path / "ref").nearest(
        meta["graph_fp"], meta["hw_sig"]) == tuple(port.candidate.cuts)


def test_zstd_record_without_zstandard_raises_as_the_reference(
        tmp_path, monkeypatch):
    """With zstandard installed both packages write zstd records; on a host
    without it reading one raises the reference's ``RuntimeError`` in both
    packages (the record is not a miss), and the service fails the
    request."""
    pytest.importorskip("zstandard")
    g = build_cnn("vgg16-conv", 64)
    key = request_key(g, KCU1500, TEST_OPTS)
    plan = compile_graph(g, options=TEST_OPTS)
    PlanCache(tmp_path).put(key, encode_plan(plan), meta={})
    [rec] = tmp_path.glob("plan_*.rec")
    assert ref_service.PlanCache(tmp_path).get(key) == encode_plan(plan)
    monkeypatch.setattr(ref_checkpoint, "zstandard", None)
    monkeypatch.setattr(port_checkpoint, "zstandard", None)
    assert port_checkpoint.get_codec()[0] == "zlib"
    for cache in (PlanCache(tmp_path), ref_service.PlanCache(tmp_path)):
        with pytest.raises(RuntimeError, match="zstandard is not installed"):
            cache.get(key)
    assert rec.exists()                  # refused, not dropped as a miss
    with CompileService(tmp_path, options=TEST_OPTS) as svc:
        t = svc.submit(g)
        with pytest.raises(RuntimeError, match="zstandard is not installed"):
            t.result(timeout=60)
        assert svc.stats["failures"] == 1 and svc.stats["misses"] == 0


def test_codec_helpers_equal_the_reference(monkeypatch):
    blob = bytes(range(256)) * 64
    for zstd in (True, False):
        if not zstd:
            monkeypatch.setattr(ref_checkpoint, "zstandard", None)
            monkeypatch.setattr(port_checkpoint, "zstandard", None)
        name, compress = port_checkpoint.get_codec()
        ref_name, ref_compress = ref_checkpoint.get_codec()
        assert name == ref_name
        assert compress(blob) == ref_compress(blob)
        assert port_checkpoint.get_decompressor(name)(compress(blob)) == blob


# ----------------------------------------- the kernel library's first build
def test_library_is_built_once_by_concurrent_first_calls(tmp_path,
                                                         monkeypatch):
    """Threads whose first kernel calls arrive together (two service
    threads' first misses) build the library once: ``load`` holds a lock
    while it builds."""
    calls = []

    def slow_compile(out_dir, lib_path, verbose):
        calls.append(threading.get_ident())
        time.sleep(0.2)                  # a build takes seconds
        lib_path.write_bytes(b"")

    class FakeLib:
        pass

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_compile", slow_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_declare", lambda lib: None)
    got = []
    start = threading.Barrier(4)

    def first_call():
        start.wait()
        got.append(_build.load())

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(calls) == 1
    assert len(got) == 4 and all(lib is got[0] for lib in got)
