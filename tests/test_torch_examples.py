"""The port's example twins (``examples/*_torch.py``) on the CPU
(``--device cpu``), against the JAX package's examples where those run
here: the same printed lines, timings aside.  Each twin's default device
is the card, so without a GPU each raises.

The examples are scripts, not modules of a package: each is loaded from
its path and its ``main`` called (the JAX ones read ``sys.argv``, set for
the call by ``monkeypatch``)."""
import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch
import torch_parity

torch_parity.one_thread()

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TWINS = ("quickstart", "serve_compile", "serve_lm", "train_lm")
# a number of milliseconds or seconds, or a speed-up, in a printed line,
# with the spaces that pad it
TIMING = re.compile(r"\s*\d+(\.\d+)?(\s*ms|s\b|x faster| tok/s)")


def load(name: str):
    """``examples/<name>.py`` as a module object (not put in
    ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_example(name, args, monkeypatch, capsys) -> list:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    load(name).main()
    return capsys.readouterr().out.splitlines()


def run_twin(name, args, capsys) -> list:
    load(f"{name}_torch").main([*args, "--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def untimed(lines, cache_dir=None) -> list:
    out = [TIMING.sub(" <t>", line) for line in lines]
    return [line.replace(str(cache_dir), "<dir>") if cache_dir else line
            for line in out]


@pytest.mark.parametrize("net", ["vgg16-conv", "resnet50"])
def test_quickstart_prints_what_the_jax_quickstart_prints(net, monkeypatch,
                                                          capsys):
    """At 64 px: the graph, the plan's summary, the search's count, the
    policy, the buffers and the simulator audit line for line; the last
    line names the reference the numerics were held to (the port's plain
    torch one, ``cnn/torch_ref.py``)."""
    args = ["--net", net, "--size", "64"]
    want = run_jax_example("quickstart", args, monkeypatch, capsys)
    got = run_twin("quickstart", args, capsys)
    assert len(got) == len(want) == 7
    assert got[:-1] == want[:-1]
    assert want[-1] == "numerical check vs JAX reference: OK"
    assert got[-1] == "numerical check vs torch reference: OK"


def test_serve_compile_prints_what_the_jax_example_prints(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """resnet50 at 64 px, the example's defaults: a cold miss, a hit
    byte-identical to it and a warm-started miss on the half-SRAM config;
    the cuts, the stats and the cache's record count equal the JAX
    service's, timings aside."""
    want = run_jax_example("serve_compile",
                           ["--cache-dir", str(tmp_path / "jax")],
                           monkeypatch, capsys)
    got = run_twin("serve_compile", ["--cache-dir", str(tmp_path / "port")],
                   capsys)
    assert untimed(got, tmp_path / "port") == untimed(want, tmp_path / "jax")
    assert len(got) == 5 and "byte-identical" in got[1]
    assert "warm_started=True" in got[2]
    assert got[3] == ("stats: {'requests': 3, 'hits': 1, 'misses': 2, "
                      "'coalesced': 0, 'warm_starts': 1, 'overloads': 0, "
                      "'failures': 0}")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b",
                                  "smollm-360m"])
def test_serve_lm_serves_a_smoke_model(arch, capsys):
    """The example's smoke config at a small batch: its three kinds of
    line, and greedy tokens of the vocabulary (the JAX ``serve()`` does
    not run on this CPU: ROADMAP queue 3, R7; ``tests/test_torch_serve.py``
    holds the port's serving against the JAX ``Model``)."""
    from repro_torch.configs import smoke_config
    got = run_twin("serve_lm", ["--arch", arch, "--batch", "2", "--prompt",
                                "8", "--gen", "6"], capsys)
    cfg = smoke_config(arch)
    assert got[0] == (f"serving {cfg.name} ({cfg.family}), batch=2, "
                      f"prompt=8, gen=6")
    assert re.fullmatch(r"prefill \d+ ms, decode \d+ ms \(\d+\.\d tok/s\)",
                        got[1])
    assert len(got) == 4
    for i, line in enumerate(got[2:]):
        head, tokens = line.split(": ", 1)
        assert head == f"request {i}" and tokens.endswith(" ...")
        row = [int(t) for t in tokens[1:-5].split(", ")]
        assert len(row) == 6 and all(0 <= t < cfg.vocab for t in row)


def test_train_lm_loses_more_than_a_nat(tmp_path, capsys):
    """The example's ~100M-parameter float32 smollm at batch 2 x 16, 30
    steps: its own check (the loss falls by more than one nat) holds; the
    first line is the JAX example's for the same arguments."""
    from repro.configs import get_config as jax_config
    got = run_twin("train_lm", ["--steps", "30", "--seq", "16", "--batch",
                                "2", "--ckpt-dir", str(tmp_path / "ck")],
                   capsys)
    ref = jax_config("smollm-360m").replace(
        name="smollm-100m", n_layers=12, d_model=640, n_heads=8,
        n_kv_heads=4, head_dim=80, d_ff=1920)
    assert got[0] == (f"training smollm-100m: "
                      f"{ref.param_count() / 1e6:.0f}M params, seq 16, "
                      f"batch 2")
    first, last = re.search(r"loss (\S+) -> (\S+) in", got[-1]).groups()
    assert float(first) - float(last) > 1.0
    assert got[1].startswith("step 0: loss ")


@pytest.mark.parametrize("name", TWINS)
def test_each_twin_defaults_to_the_card(name, tmp_path):
    """``--device`` defaults to ``cuda``: on a host without a GPU the
    example raises (the service fails its first request with the
    compile's error) rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = {"quickstart": ["--net", "vgg16-conv", "--size", "64"],
            "serve_compile": ["--cache-dir", str(tmp_path / "plans")],
            "serve_lm": ["--batch", "1", "--prompt", "4", "--gen", "2"],
            "train_lm": ["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")],
            }[name]
    mod = load(f"{name}_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
    assert not (tmp_path / "ck").exists()
