"""The static plan verifier of the PyTorch port (``repro_torch.analysis``)
against the JAX package's (``repro.analysis``), on the CPU.

The verifier is plain Python carried across, so everything here is held
equal, not close: the rendered diagnostics of every zoo plan, the mutation
kill matrix row by row (same classes, same seeds, same descriptions and
codes), the bound-mutation matrix, the ``verify`` knob's three modes and
the CLI's report text.  The port's plans come from its host ``journal``
engine with ``device="cpu"``; the reference's from its default engine
(efficientnet-b1 with ``batch_size=1``, R5 in ROADMAP queue 3).
"""
import dataclasses
import warnings

import pytest

import repro.analysis as ref_analysis
import repro.cnn as ref_cnn
import repro.core.compiler as ref_compiler
import repro.core.options as ref_options
from repro.analysis.__main__ import main as ref_cli

import repro_torch.analysis as port_analysis
import repro_torch.cnn as port_cnn
import repro_torch.core.compiler as port_compiler
import repro_torch.core.options as port_options
from repro_torch.analysis.__main__ import main as port_cli

from torch_parity import ALL_CNNS, REF_BATCH, both
import torch_parity

torch_parity.one_thread()

SIZES = {"vgg16-conv": 224, "yolov2": 416, "yolov3": 416, "resnet50": 224,
         "resnet152": 224, "efficientnet-b1": 256, "retinanet": 512,
         "mobilenet-v3": 224}
AUDIT_LIMIT = 50_000           # the bound of the reference's own audit
KILL_NETS = ["yolov2", "resnet50", "retinanet"]   # tests/test_analysis.py
SEEDS = (0, 1, 2)

_PLANS: dict = {}


def plans(name):
    """``(reference plan, port plan)`` of one zoo net at its published
    size."""
    if name not in _PLANS:
        ref = ref_compiler.compile_graph(
            ref_cnn.build_cnn(name, SIZES[name]),
            options=ref_options.CompileOptions(
                exhaustive_limit=AUDIT_LIMIT,
                batch_size=REF_BATCH.get(name, 1024)))
        port = port_compiler.compile_graph(
            port_cnn.build_cnn(name, SIZES[name]),
            options=port_options.CompileOptions(
                engine="journal", device="cpu",
                exhaustive_limit=AUDIT_LIMIT))
        assert tuple(port.candidate.cuts) == tuple(ref.candidate.cuts), name
        _PLANS[name] = (ref, port)
    return _PLANS[name]


def _rendered(diags):
    return [(d.render(), str(d.severity)) for d in diags]


def test_same_vocabulary():
    assert {c: (t, str(s)) for c, (t, s) in port_analysis.CODES.items()} \
        == {c: (t, str(s)) for c, (t, s) in ref_analysis.CODES.items()}
    assert port_analysis.CLASSES == ref_analysis.CLASSES
    assert port_analysis.BOUND_CLASSES == ref_analysis.BOUND_CLASSES


@pytest.mark.parametrize("name", ALL_CNNS)
def test_diagnostics_equal_reference(name):
    ref, port = plans(name)
    want = ref_analysis.verify_execution_plan(ref)
    got = port_analysis.verify_execution_plan(port)
    assert _rendered(got) == _rendered(want), name
    assert port_analysis.errors_of(got) == []
    # the live intervals of the allocator journal, interval by interval
    rt = ref_analysis.journal_trace(ref.grouped, ref.alloc.policy)
    pt = port_analysis.journal_trace(port.grouped, port.alloc.policy)
    assert ([dataclasses.astuple(i) for i in pt.intervals]
            == [dataclasses.astuple(i) for i in rt.intervals])
    assert (port_analysis.render_intervals(pt)
            == ref_analysis.render_intervals(rt))


_KILL: dict = {}


def kill_rows():
    if not _KILL:
        _KILL["ref"] = ref_analysis.kill_matrix(
            {n: plans(n)[0] for n in KILL_NETS}, seeds=SEEDS)
        _KILL["port"] = port_analysis.kill_matrix(
            {n: plans(n)[1] for n in KILL_NETS}, seeds=SEEDS)
    return _KILL["ref"], _KILL["port"]


@pytest.mark.parametrize("cls", sorted(ref_analysis.CLASSES))
def test_kill_matrix_equals_reference(cls):
    """Class by class, with the same seeds: the same mutants apply, with
    the same descriptions, and the verifier kills each with the same
    codes; every applied mutant is killed."""
    ref_rows, port_rows = kill_rows()
    want = [r for r in ref_rows if r["cls"] == cls]
    got = [r for r in port_rows if r["cls"] == cls]
    assert got == want
    assert all(r["killed"] for r in got if r["applied"])


def test_kill_matrix_report_equals_reference():
    ref_rows, port_rows = kill_rows()
    text = port_analysis.render_kill_matrix(port_rows)
    assert text == ref_analysis.render_kill_matrix(ref_rows)
    assert {r["cls"] for r in port_rows if r["applied"]} == set(
        port_analysis.CLASSES)


@pytest.mark.parametrize("cls", sorted(ref_analysis.CLASSES))
def test_simulator_verdicts_equal_reference(cls):
    """The dynamic oracle (the dry simulator) reaches the reference's
    verdict on every mutant, and the static verifier catches whatever it
    catches."""
    for name in KILL_NETS:
        ref, port = plans(name)
        for seed in SEEDS[:2]:
            rm = ref_analysis.mutate_plan(ref, cls, seed)
            pm = port_analysis.mutate_plan(port, cls, seed)
            assert (pm is None) == (rm is None)
            if pm is None:
                continue
            dynamic = port_analysis.simulator_detects(port, pm)
            assert dynamic == ref_analysis.simulator_detects(ref, rm)
            assert not dynamic or port_analysis.errors_of(pm.verify())


def test_bound_kill_matrix_equals_reference():
    """The prefix-bound mutants of both packages get the same scales and
    the same verdicts; all are killed, the true bound survives."""
    names = ["vgg16-conv", "resnet50"]
    sides = {n: both(n) for n in names}
    want = ref_analysis.bound_kill_matrix(
        {n: s[0].engine() for n, s in sides.items()}, seeds=SEEDS[:2])
    got = port_analysis.bound_kill_matrix(
        {n: s[1].engine(device="cpu") for n, s in sides.items()},
        seeds=SEEDS[:2])
    assert got == want
    assert all(r["killed"] for r in got)
    for n, (_, port) in sides.items():
        assert port_analysis.bound_survives_differential(
            port.engine(device="cpu"))


# ------------------------------------------------------------ the knob
def test_verify_knob_off_warn_strict_on_clean_plans():
    g = port_cnn.build_cnn("vgg16-conv", 224)
    opts = port_options.CompileOptions(engine="journal", device="cpu")
    off = port_compiler.compile_graph(g, options=opts)
    assert off.diagnostics == []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn = port_compiler.compile_graph(
            g, options=opts.replace(verify="warn"))
    strict = port_compiler.compile_graph(
        g, options=opts.replace(verify="strict"))
    want = ref_analysis.verify_execution_plan(plans("vgg16-conv")[0])
    assert _rendered(warn.diagnostics) == _rendered(strict.diagnostics) \
        == _rendered(want)
    # a pure post-check: the plan is the same with and without it
    for p in (warn, strict):
        assert tuple(p.candidate.cuts) == tuple(off.candidate.cuts)
        assert [i.encode().tolist() for i in p.instructions] == \
            [i.encode().tolist() for i in off.instructions]
    with pytest.raises(ValueError, match="verify"):
        port_options.CompileOptions(verify="loose")


@pytest.mark.parametrize("cls", ["clobber_alloc", "swap_live",
                                 "overflow_field"])
def test_verify_knob_on_a_broken_plan(cls):
    """``warn`` records the findings and warns once per error; ``strict``
    raises; both name the reference's codes on the same mutant."""
    ref, port = plans("resnet50")
    pm = port_analysis.mutate_plan(port, cls, 0)
    rm = ref_analysis.mutate_plan(ref, cls, 0)
    bad = dataclasses.replace(port, instructions=pm.instructions,
                              alloc=pm.alloc, diagnostics=[])
    rbad = dataclasses.replace(ref, instructions=rm.instructions,
                               alloc=rm.alloc, diagnostics=[])
    with pytest.warns(UserWarning) as caught:
        port_compiler.apply_verification(bad, "warn")
    ref_compiler.apply_verification(rbad, "off")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_compiler.apply_verification(rbad, "warn")
    errors = port_analysis.errors_of(bad.diagnostics)
    assert errors and len(caught) == len(errors)
    assert _rendered(bad.diagnostics) == _rendered(rbad.diagnostics)
    with pytest.raises(port_analysis.VerificationError) as err:
        port_compiler.apply_verification(
            dataclasses.replace(bad, diagnostics=[]), "strict")
    with pytest.raises(ref_analysis.VerificationError) as rerr:
        ref_compiler.apply_verification(
            dataclasses.replace(rbad, diagnostics=[]), "strict")
    assert str(err.value) == str(rerr.value)
    assert port_compiler.apply_verification(bad, "off") is bad


# ------------------------------------------------------------------ CLI
def _cli(main, argv, capsys):
    code = main(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--net", "vgg16-conv", "--strict"],
    ["--net", "resnet50", "--net", "mobilenet-v3", "--intervals"],
])
def test_cli_prints_the_reference_report(argv, capsys):
    want = _cli(ref_cli, argv, capsys)
    got = _cli(port_cli, argv, capsys)
    assert got == want
    assert got[0] == 0 and "clean" in got[1]


def test_cli_report_and_kill_gate(tmp_path, capsys):
    report = tmp_path / "verify.txt"
    code, out = _cli(port_cli, ["--net", "yolov2", "--strict",
                                "--mutation-kill", "--seeds", "1",
                                "--report", str(report)], capsys)
    assert code == 0
    text = report.read_text()
    assert "yolov2" in text and "mutants killed" in text
    assert text == out


def test_cli_device_engine_on_the_cpu(capsys):
    """``--engine device --device cpu`` runs the plain replay and gives
    the journal engine's report."""
    want = _cli(port_cli, ["--net", "resnet50"], capsys)
    got = _cli(port_cli, ["--net", "resnet50", "--engine", "device",
                          "--device", "cpu"], capsys)
    assert got == want


def test_cli_rejects_unknown_net():
    with pytest.raises(SystemExit):
        port_cli(["--net", "lenet"])
    with pytest.raises(SystemExit):
        port_cli([])
