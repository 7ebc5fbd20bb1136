"""The LM serving slice as a whole: the port's ``Model.prefill`` /
``decode_step`` and ``serve`` against the JAX package's.

Each family whose layer kinds the port serves -- recurrentgemma-2b (RG-LRU
and local attention), gemma2-2b (local and global attention, soft caps,
sandwich norms), smollm-360m (global attention) and mamba2-2.7b (SSD
blocks, chunk 8) -- is built from its smoke config; the JAX package initialises the weights, and
``convert.lm_params_from_numpy`` hands the same numbers to the port.  Both
get the same tokens, made from a seed with numpy.  The JAX side runs
``Model.prefill`` / ``decode_step`` without a mesh: its ``serve()`` fails
under this jax (ROADMAP queue 3, R7).  Logits must agree at every step
within 1e-4 of their scale (float32; K6 / K7 / K8 / K9's plain versions run
here and sum in other orders than XLA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models.model import build_model as jax_build
from repro.models.transformer import set_mesh_axes

from repro_torch.configs import smoke_config as port_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models.model import Model
import torch_parity

torch_parity.one_thread()

ARCHS = ["recurrentgemma-2b", "gemma2-2b", "smollm-360m", "mamba2-2.7b",
         "gemma2-27b", "granite-20b"]
REL_TOL = 1e-4          # of the logits' scale (their largest magnitude)
_CACHE: dict = {}


def jax_side(arch: str, max_seq: int):
    """The JAX model (no mesh), its weights and its jitted serving calls."""
    key = (arch, max_seq)
    if key not in _CACHE:
        set_mesh_axes(None)
        cfg = smoke_config(arch).replace(max_seq=max_seq)
        model = jax_build(cfg)
        params = model.init(jax.random.key(0), cfg.dtype)
        _CACHE[key] = (cfg, params, jax.jit(model.prefill),
                       jax.jit(model.decode_step))
    return _CACHE[key]


def port_model(arch: str, max_seq: int, params) -> Model:
    cfg = port_smoke(arch).replace(max_seq=max_seq)
    model = Model(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    model.load_state_dict(lm_params_from_numpy(cfg, tree))
    return model


def assert_logits_close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert got.shape == want.shape and err <= REL_TOL * scale, (
        f"{what}: max abs err {err:.3g} > {REL_TOL} x scale {scale:.3g}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill 24 tokens, then 6 decode steps (teacher-forced with the same
    random tokens on both sides).  max_seq 40 > window 16, so the local
    layers decode through a ring cache; the global ones through a linear
    cache."""
    cfg, params, jprefill, jdecode = jax_side(arch, 40)
    model = port_model(arch, 40, params)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (6, 2, 1)).astype(np.int32)
    want, jcache = jprefill(params, {"tokens": jnp.asarray(prompt)})
    got, cache = model.prefill({"tokens": torch.from_numpy(prompt)})
    assert cache["pos"] == int(jcache["pos"]) == 24
    assert_logits_close(got, want, f"{arch} prefill")
    for i in range(6):
        want, jcache = jdecode(params, jcache, jnp.asarray(nxt[i]))
        got, cache = model.decode_step(cache, torch.from_numpy(nxt[i]))
        assert_logits_close(got, want, f"{arch} decode step {i}")
    assert cache["pos"] == 30


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_jax(arch):
    """``serve(..., device="cpu")`` with the JAX weights: its greedy tokens
    equal the JAX model's greedy tokens, run the way the JAX ``serve()``
    runs them (same prompts, max_seq = prompt + gen), at every step up to
    the first whose top-2 margin in the JAX logits is within 10x the
    tolerance (after a near tie the two may rightly part)."""
    sc = ServeConfig(batch=2, prompt_len=20, gen_len=8, seed=3)
    max_len = sc.prompt_len + sc.gen_len
    cfg, params, jprefill, jdecode = jax_side(arch, max_len)
    tree = jax.tree.map(np.asarray, params)
    out = serve(port_smoke(arch), sc, device="cpu",
                params=lm_params_from_numpy(port_smoke(arch), tree))
    assert out["tokens"].shape == (sc.batch, sc.gen_len)
    assert out["prefill_s"] > 0 and out["decode_s"] > 0

    prompts = np.random.default_rng(sc.seed).integers(
        0, cfg.vocab, (sc.batch, sc.prompt_len)).astype(np.int32)
    logits, cache = jprefill(params, {"tokens": jnp.asarray(prompts)})
    steps = []
    for i in range(sc.gen_len):
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        steps.append((lg.argmax(-1), top2[:, 1] - top2[:, 0],
                      float(np.abs(lg).max())))
        if i + 1 < sc.gen_len:
            tok = jnp.asarray(lg.argmax(-1).astype(np.int32)[:, None])
            logits, cache = jdecode(params, cache, tok)
    for b in range(sc.batch):
        for i, (tok, margin, scale) in enumerate(steps):
            if margin[b] <= 10 * REL_TOL * scale:
                break
            assert out["tokens"][b, i] == tok[b], (arch, b, i)


def test_ring_cache_window_smaller_than_the_sequence():
    """recurrentgemma's local layer at window 16 holds a ring of 16 slots
    while 30 tokens pass; the port's logits still follow the JAX model's."""
    cfg, params, jprefill, jdecode = jax_side("recurrentgemma-2b", 40)
    model = port_model("recurrentgemma-2b", 40, params)
    local = [i for i, layer in enumerate(model.layers)
             if layer.kind == "local"]
    cache = model.init_cache(1, 40)
    assert local and cache["layers"][local[0]]["k"].shape[1] == cfg.window
    prompt = np.arange(1, 21, dtype=np.int32)[None]
    want, jcache = jprefill(params, {"tokens": jnp.asarray(prompt)})
    got, cache = model.prefill({"tokens": torch.from_numpy(prompt)}, cache)
    assert_logits_close(got, want, "ring prefill")
    for t in range(21, 31):
        tok = np.array([[t]], np.int32)
        want, jcache = jdecode(params, jcache, jnp.asarray(tok))
        got, cache = model.decode_step(cache, torch.from_numpy(tok))
    assert_logits_close(got, want, "ring decode at position 30")


def test_mamba2_ragged_prompt_matches_jax():
    """A 21-token prompt (chunks 8, 8 and a ragged 5) and 4 decode steps:
    the port's SSD masks the last chunk where the JAX model pads it."""
    cfg, params, jprefill, jdecode = jax_side("mamba2-2.7b", 40)
    model = port_model("mamba2-2.7b", 40, params)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32)
    want, jcache = jprefill(params, {"tokens": jnp.asarray(prompt)})
    got, cache = model.prefill({"tokens": torch.from_numpy(prompt)})
    assert_logits_close(got, want, "mamba2 ragged prefill")
    for i in range(4):
        want, jcache = jdecode(params, jcache, jnp.asarray(nxt[i]))
        got, cache = model.decode_step(cache, torch.from_numpy(nxt[i]))
        assert_logits_close(got, want, f"mamba2 decode step {i}")
    assert cache["pos"] == int(jcache["pos"]) == 25


def test_mamba2_prefill_continued_from_a_cache_matches_jax():
    """A second prefill (13 tokens) from the cache of a first one (11
    tokens): the SSD starts from the cached state and the convolutions
    from the cached inputs, on both sides; then one decode step."""
    cfg, params, jprefill, jdecode = jax_side("mamba2-2.7b", 40)
    model = port_model("mamba2-2.7b", 40, params)
    rng = np.random.default_rng(12)
    first = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    second = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    _, jcache = jprefill(params, {"tokens": jnp.asarray(first)})
    _, cache = model.prefill({"tokens": torch.from_numpy(first)})
    want, jcache = jprefill(params, {"tokens": jnp.asarray(second)}, jcache)
    got, cache = model.prefill({"tokens": torch.from_numpy(second)}, cache)
    assert cache["pos"] == int(jcache["pos"]) == 24
    assert_logits_close(got, want, "mamba2 continued prefill")
    want, jcache = jdecode(params, jcache, jnp.asarray(nxt))
    got, cache = model.decode_step(cache, torch.from_numpy(nxt))
    assert_logits_close(got, want, "mamba2 decode after it")


def test_prefill_from_a_later_position_raises():
    model = Model(port_smoke("gemma2-2b").replace(max_seq=32), device="cpu")
    model.init_weights(0)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    _, cache = model.prefill({"tokens": tokens})
    with pytest.raises(NotImplementedError, match="position 4"):
        model.prefill({"tokens": tokens}, cache)


def test_serve_defaults_to_the_card():
    """``serve`` runs on the card unless told otherwise; on a host without
    one it says so instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(port_smoke("smollm-360m"), ServeConfig(batch=1, prompt_len=4,
                                                     gen_len=2))


def test_weights_from_a_seed_are_reproducible():
    a = Model(port_smoke("recurrentgemma-2b"), device="cpu").init_weights(5)
    b = Model(port_smoke("recurrentgemma-2b"), device="cpu").init_weights(5)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    tok = sa["embed.tok"]
    assert float(tok.abs().max()) <= 2 * 64 ** -0.5 + 1e-6
    assert float(tok.std()) == pytest.approx(0.88 * 64 ** -0.5, rel=0.05)
    assert torch.equal(sa["final_norm"], torch.zeros(64))
    assert torch.equal(sa["layers.0.rglru.lam"], torch.ones(64))


def test_serve_command_line_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
          "--batch", "1", "--prompt", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.startswith("prefill ") and "tok/s" in out


def test_bfloat16_weights_cross_unchanged():
    """A bfloat16 tree (the full configs' type; numpy holds it through
    ml_dtypes) lands in a bfloat16 model value for value."""
    cfg = smoke_config("recurrentgemma-2b")
    params = jax_build(cfg).init(jax.random.key(1), "bfloat16")
    tree = jax.tree.map(np.asarray, params)
    pcfg = port_smoke("recurrentgemma-2b").replace(dtype="bfloat16")
    sd = lm_params_from_numpy(pcfg, tree)
    model = Model(pcfg, device="cpu")
    model.load_state_dict(sd)
    got = model.state_dict()["layers.2.attn.wq"]
    want = tree["stack"]["groups"]["p2"]["attn"]["wq"][0]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.to(torch.float32).numpy(),
                          want.astype(np.float32))


def test_serve_is_prefill_then_greedy_decode_steps():
    """``serve`` with weights from its seed gives the tokens of the model
    built from that seed, run by hand: a prefill, then each step's argmax
    fed to ``decode_step``; handing it those weights changes nothing."""
    cfg = port_smoke("recurrentgemma-2b")
    sc = ServeConfig(batch=2, prompt_len=12, gen_len=5, seed=4)
    max_len = sc.prompt_len + sc.gen_len
    model = Model(cfg.replace(max_seq=max_len), device="cpu")
    model.init_weights(sc.seed)
    prompts = np.random.default_rng(sc.seed).integers(
        0, cfg.vocab, (sc.batch, sc.prompt_len)).astype(np.int32)
    logits, cache = model.prefill({"tokens": torch.from_numpy(prompts)},
                                  model.init_cache(sc.batch, max_len))
    want = []
    for _ in range(sc.gen_len):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        want.append(tok)
        logits, cache = model.decode_step(cache, tok)
    want = torch.cat(want, dim=1).numpy()
    assert cache["pos"] == max_len
    drawn = serve(cfg, sc, device="cpu")["tokens"]
    handed = serve(cfg, sc, device="cpu", params=model.state_dict())["tokens"]
    assert drawn.dtype == np.int32
    assert np.array_equal(drawn, want) and np.array_equal(handed, want)
