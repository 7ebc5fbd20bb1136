"""The MoE, vision (cross-attention) and audio (encoder-decoder) families in
the port against the JAX package: prefill and decode steps, ``serve()``'s
greedy tokens, the router's dispatch (capacity drops included), the loss
with its aux term and every parameter's gradient, and the launch counts
``chip_smoke.py`` pins for these families' serves and model checks.

Each architecture is built from its smoke config; the JAX package
initialises the weights and ``convert.lm_params_from_numpy`` hands the same
numbers to the port.  llama-3.2-vision's gates ``gate_attn`` / ``gate_mlp``
start at zero (``tanh(0) = 0``: a cross layer would add nothing), so every
test here sets them to 0.5 in both packages, and feeds random patches
except where it follows the serve (zeros, as the JAX ``serve()``).  Inputs
are made from a seed with numpy.  The JAX side runs without a mesh (its
``serve()`` fails under this jax: ROADMAP queue 3, R7).  Tolerances:
logits within 1e-4 of their scale (``test_torch_serve.py``'s ``REL_TOL``),
the loss within 1e-5 (relative) and each gradient within 1e-4 of its
largest magnitude (``test_torch_train.py``'s); the router's keep / slot
equal outright.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
from repro.configs import smoke_config
from repro.models.model import build_model as jax_build
from repro.models.transformer import set_mesh_axes

import repro_torch.models.moe as moe
from repro_torch.configs import get_config
from repro_torch.configs import smoke_config as port_smoke
from repro_torch.convert import (lm_leaf_key, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.launch.steps import train_params
from repro_torch.models.layers import Params
from repro_torch.models.model import Model
from torch_parity import chip_smoke, count_lm_calls
import torch_parity

torch_parity.one_thread()

ARCHS = ["qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b",
         "llama-3.2-vision-11b", "whisper-base"]
REL_TOL = 1e-4           # of the logits' scale
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each gradient's largest magnitude
GATE = 0.5               # the vlm gates, in both packages
_CACHE: dict = {}


def with_gates(tree: dict) -> dict:
    """``tree`` with every vlm gate set to ``GATE`` (other trees as they
    are)."""
    for block in tree["stack"]["groups"].values():
        attn = block.get("attn", {})
        for name in ("gate_attn", "gate_mlp"):
            if name in attn:
                attn[name] = np.full_like(attn[name], GATE)
    return tree


def jax_side(arch: str, max_seq: int, dtype: str | None = None, **over):
    """The JAX model (no mesh), its weights (vlm gates at ``GATE``) as
    device arrays and as numpy, and its jitted serving calls."""
    key = (arch, max_seq, dtype, tuple(sorted(over.items())))
    if key not in _CACHE:
        set_mesh_axes(None)
        cfg = smoke_config(arch).replace(max_seq=max_seq, **over)
        model = jax_build(cfg)
        tree = with_gates(jax.tree.map(
            np.asarray, model.init(jax.random.key(0), dtype or cfg.dtype)))
        params = jax.tree.map(jnp.asarray, tree)
        _CACHE[key] = (cfg, model, params, tree, jax.jit(model.prefill),
                       jax.jit(model.decode_step))
    return _CACHE[key]


def port_model(arch, max_seq, tree, param_dtype=None, **over) -> Model:
    cfg = port_smoke(arch).replace(max_seq=max_seq, **over)
    model = Model(cfg, device="cpu", param_dtype=param_dtype)
    model.load_state_dict(lm_params_from_numpy(cfg, tree))
    return model


def context(cfg, rng, b: int) -> dict:
    """Random frames (audio) or patches (vlm) of ``b`` rows, float32."""
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (b, cfg.vision_seq, cfg.d_model)).astype(np.float32)}
    return {}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_logits_close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert got.shape == want.shape and err <= REL_TOL * scale, (
        f"{what}: max abs err {err:.3g} > {REL_TOL} x scale {scale:.3g}")


# --------------------------------------------------------- serving parity
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill 24 tokens (with random frames / patches), then 6 decode
    steps, teacher-forced with the same random tokens on both sides; the
    cross layers' keys and values come from the prefill's cache."""
    cfg, _, params, tree, jprefill, jdecode = jax_side(arch, 40)
    model = port_model(arch, 40, tree)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             **context(cfg, rng, 2)}
    nxt = rng.integers(0, cfg.vocab, (6, 2, 1)).astype(np.int32)
    want, jcache = jprefill(params, to_jax(batch))
    got, cache = model.prefill(to_torch(batch))
    assert cache["pos"] == int(jcache["pos"]) == 24
    assert_logits_close(got, want, f"{arch} prefill")
    for i in range(6):
        want, jcache = jdecode(params, jcache, jnp.asarray(nxt[i]))
        got, cache = model.decode_step(cache, torch.from_numpy(nxt[i]))
        assert_logits_close(got, want, f"{arch} decode step {i}")
    assert cache["pos"] == 30


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_jax(arch):
    """``serve(..., device="cpu")`` with the JAX weights (frames / patches
    of zeros in bfloat16, as both ``serve()``s give them): its greedy tokens
    equal the JAX model's at every step up to the first whose top-2 margin
    is within 10x the tolerance."""
    sc = ServeConfig(batch=2, prompt_len=20, gen_len=8, seed=3)
    max_len = sc.prompt_len + sc.gen_len
    cfg, _, params, tree, jprefill, jdecode = jax_side(arch, max_len)
    out = serve(port_smoke(arch), sc, device="cpu",
                params=lm_params_from_numpy(port_smoke(arch), tree))
    assert out["tokens"].shape == (sc.batch, sc.gen_len)

    batch = {"tokens": jnp.asarray(np.random.default_rng(sc.seed).integers(
        0, cfg.vocab, (sc.batch, sc.prompt_len)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = jnp.zeros((sc.batch, cfg.enc_seq, cfg.d_model),
                                    jnp.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = jnp.zeros((sc.batch, cfg.vision_seq,
                                      cfg.d_model), jnp.bfloat16)
    logits, cache = jprefill(params, batch)
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


def test_cross_attention_gates_change_the_logits():
    """With both gates at 0 a vlm cross layer adds nothing (its updates are
    scaled by tanh(0)); at 0.5 its attention over random patches changes
    the logits -- which is why every check here sets them."""
    cfg, _, _, tree, _, _ = jax_side("llama-3.2-vision-11b", 40)
    rng = np.random.default_rng(5)
    batch = to_torch({"tokens": rng.integers(0, cfg.vocab, (1, 12)).astype(
        np.int32), **context(cfg, rng, 1)})
    gated = port_model("llama-3.2-vision-11b", 40, tree)
    closed = port_model("llama-3.2-vision-11b", 40, tree)
    for layer in closed.layers:
        if layer.kind == "cross":
            layer.attn.gate_attn.zero_()
            layer.attn.gate_mlp.zero_()
    other = dict(batch, patches=batch["patches"] + 1.0)
    assert not torch.equal(gated.prefill(batch)[0], gated.prefill(other)[0])
    assert torch.equal(closed.prefill(batch)[0], closed.prefill(other)[0])


def test_whisper_cache_holds_the_encoders_keys_and_values():
    """An encdec layer's cache: the self-attention's linear cache and the
    cross-attention's keys and values of the encoder's ``enc_seq`` frames,
    written at the prefill and equal to the JAX package's there."""
    cfg, _, params, tree, jprefill, _ = jax_side("whisper-base", 40)
    model = port_model("whisper-base", 40, tree)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32),
             **context(cfg, rng, 2)}
    _, jcache = jprefill(params, to_jax(batch))
    _, cache = model.prefill(to_torch(batch))
    assert [layer.kind for layer in model.layers] == ["encdec"] * 2
    assert [layer.kind for layer in model.enc_layers] == ["enc"] * 2
    for i, c in enumerate(cache["layers"]):
        assert set(c) == {"self", "crosskv"}
        want = np.asarray(jcache["groups"]["p0"]["crosskv"]["ck"][i])
        assert c["crosskv"]["ck"].shape == (2, cfg.enc_seq, cfg.n_kv_heads,
                                            cfg.hd)
        np.testing.assert_allclose(c["crosskv"]["ck"].numpy(), want,
                                   rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- the router
def moe_case(capacity_factor: float, t: int = 40, seed: int = 11):
    """The smoke MoE config at ``capacity_factor``, its router and experts
    (the JAX initializer) and ``t`` random normalised tokens, float32."""
    cfg = smoke_config("moonshot-v1-16b-a3b").replace(
        capacity_factor=capacity_factor)
    pcfg = port_smoke("moonshot-v1-16b-a3b").replace(
        capacity_factor=capacity_factor)
    from repro.models.layers import materialize
    defs = jax_moe.moe_defs(cfg)
    tree = {k: np.asarray(v) for k, v in materialize(
        defs, jax.random.key(seed)).items()}
    p = Params(moe.moe_defs(pcfg), torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(v.astype(np.float32))
                       for k, v in tree.items()})
    h2 = np.random.default_rng(seed).standard_normal(
        (t, cfg.d_model)).astype(np.float32)
    return cfg, pcfg, tree, p, h2


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0],
                         ids=["drops", "no_drops"])
def test_route_rank_and_slot_equal_jax(capacity_factor):
    """``_route``'s experts equal, its probabilities within float32
    rounding; ``_rank_and_slot``'s keep and slot equal outright -- at 0.5
    (C 8 for 40 tokens x 2 of 8 experts: some experts overflow and drop
    tokens) and at the smoke configs' 8.0 (nothing dropped)."""
    cfg, pcfg, tree, p, h2 = moe_case(capacity_factor)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jg, jidx, jme, jce = jax_moe._route(jtree, jnp.asarray(h2), cfg)
    g, idx, me, ce = moe._route(p, torch.from_numpy(h2), pcfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    for got, want in ((g, jg), (me, jme), (ce, jce)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    C = moe._capacity(h2.shape[0], pcfg)
    assert C == jax_moe._capacity(h2.shape[0], cfg)
    flat = np.array(jidx).reshape(-1)
    jkeep, jslot = jax_moe._rank_and_slot(jnp.asarray(flat),
                                          cfg.n_experts, C)
    keep, slot = moe._rank_and_slot(torch.from_numpy(flat).long(),
                                    pcfg.n_experts, C)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0],
                         ids=["drops", "no_drops"])
def test_dispatch_combine_equals_jax(capacity_factor):
    """The whole dispatch -> experts -> combine, and the aux loss, within
    float32 rounding of the JAX package's; a dropped assignment adds
    nothing."""
    cfg, pcfg, tree, p, h2 = moe_case(capacity_factor)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jy, jaux = jax_moe._dispatch_combine(jtree, jnp.asarray(h2), cfg, None)
    y, aux = moe._dispatch_combine(p, torch.from_numpy(h2), pcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert aux.dtype == torch.float32
    assert aux.item() == pytest.approx(float(jaux), rel=1e-6)


def test_moe_model_with_drops_matches_jax():
    """moonshot's smoke model at capacity factor 0.5: a prefill of 2 x 24
    tokens drops assignments, the same ones on both sides, and the logits
    still agree; then a decode step (C 8 for 2 tokens: no drop)."""
    cfg, _, params, tree, jprefill, jdecode = jax_side(
        "moonshot-v1-16b-a3b", 40, capacity_factor=0.5)
    model = port_model("moonshot-v1-16b-a3b", 40, tree, capacity_factor=0.5)
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    want, jcache = jprefill(params, {"tokens": jnp.asarray(prompt)})
    got, cache = model.prefill({"tokens": torch.from_numpy(prompt)})
    assert_logits_close(got, want, "moonshot prefill with drops")
    want, _ = jdecode(params, jcache, jnp.asarray(nxt))
    got, _ = model.decode_step(cache, torch.from_numpy(nxt))
    assert_logits_close(got, want, "moonshot decode after drops")


# ------------------------------------------------------- loss, gradients
def batch_of(cfg, seed, b=2, s=21):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                  # not counted
    return {"tokens": tokens, "labels": labels, **context(cfg, rng, b)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """``Model.loss`` (nll, and the MoE aux loss summed over the layers)
    and every parameter's gradient -- the experts', the router's, the
    gates', the encoder's -- against ``jax.value_and_grad(model.loss)``."""
    cfg, jmodel, params, tree, _, _ = jax_side(arch, 40, "float32")
    batch = batch_of(cfg, 3)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, to_jax(batch))
    model = port_model(arch, 40, tree, param_dtype=torch.float32)
    named = train_params(model)
    loss, metrics = model.loss(to_torch(batch))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert metrics["nll"].item() == pytest.approx(float(jmetrics["nll"]),
                                                  rel=LOSS_RTOL)
    assert metrics["aux"].item() == pytest.approx(float(jmetrics["aux"]),
                                                  rel=LOSS_RTOL, abs=0.0)
    assert (metrics["aux"].item() > 0) == bool(cfg.n_experts)
    flat_want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrads))[0]
    flat_got = jax.tree.leaves(lm_params_to_numpy(model.cfg, grads))
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max()) if w.size else 0.0
        scale = float(np.abs(w).max()) if w.size else 1.0
        assert err <= GRAD_TOL * scale, (
            f"{arch} {jax.tree_util.keystr(path)}: max abs err {err:.3g} > "
            f"{GRAD_TOL} x {scale:.3g}")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_both_ways_leaf_for_leaf(arch):
    """Every JAX leaf -- the experts' [E, d, ff], the router, ``xattn.*``,
    the 0-dim gates, the encoder's stack and norm -- lands in exactly one
    port parameter and comes back equal; the port's leaf order is the JAX
    tree's."""
    _, _, _, tree, _, _ = jax_side(arch, 40)
    cfg = port_smoke(arch).replace(max_seq=40)
    sd = lm_params_from_numpy(cfg, tree)
    model = Model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = lm_params_to_numpy(cfg, model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    keys = [lm_leaf_key(cfg, n) for n in sorted(
        sd, key=lambda n: lm_leaf_key(cfg, n))]
    # a stacked leaf's layers follow each other, by group
    order = [k[:-1] for i, k in enumerate(keys)
             if i == 0 or k[:-1] != keys[i - 1][:-1]]
    assert order == paths
    with pytest.raises(ValueError, match="no place"):
        lm_params_from_numpy(cfg, dict(tree, extra=np.zeros(1)))


def test_serve_holds_handed_in_weights_in_place(monkeypatch):
    """``serve(params=...)`` runs on the caller's tensors, not a copy (a
    second copy of moonshot's ~55 GB would not fit beside the first)."""
    import repro_torch.launch.serve as serve_mod
    cfg = port_smoke("moonshot-v1-16b-a3b")
    weights = Model(cfg, device="cpu").init_weights(2).state_dict()
    seen = []
    make = serve_mod.make_prefill_step

    def spy(model):
        seen.append({n: t.data_ptr() for n, t in model.state_dict().items()})
        return make(model)
    monkeypatch.setattr(serve_mod, "make_prefill_step", spy)
    serve(cfg, ServeConfig(batch=1, prompt_len=6, gen_len=2), device="cpu",
          params=weights)
    assert seen == [{n: t.data_ptr() for n, t in weights.items()}]


def test_batch_spec_adds_the_context():
    for arch, key, length in (("whisper-base", "frames", "enc_seq"),
                              ("llama-3.2-vision-11b", "patches",
                               "vision_seq")):
        cfg = port_smoke(arch)
        model = Model(cfg, device="cpu")
        for mode in ("train", "prefill"):
            spec = model.batch_spec(16, 2, mode)[key]
            assert spec.shape == (2, getattr(cfg, length), cfg.d_model)
            assert spec.dtype == torch.bfloat16
        assert set(model.batch_spec(16, 2, "decode")) == {"tokens"}


# ------------------------------------------- chip_smoke.py's launch counts
def full_depth(arch, **over):
    """The smoke config of ``arch`` at the full config's depth (and
    encoder depth)."""
    full = get_config(arch)
    return port_smoke(arch).replace(n_layers=full.n_layers,
                                    enc_layers=full.enc_layers, **over)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama-3.2-vision-11b", "whisper-base"])
def test_a_serve_runs_each_kernel_as_chip_smoke_pins_it(arch, monkeypatch):
    """A serve of the smoke width at the full depth, batch and generated
    length of ``LM_SERVES[arch]`` (a short prompt) runs K6 and K7 exactly
    as often as ``chip_smoke.py`` pins it for the full serve: launches
    follow the layers and steps, not the width."""
    spec = chip_smoke().LM_SERVES[arch]
    calls = count_lm_calls(monkeypatch)
    shape = dict(spec["shape"], prompt_len=12)
    serve(full_depth(arch), ServeConfig(**shape, seed=0), device="cpu")
    assert {k: n for k, n in calls.items() if n} == spec["launches"]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama-3.2-vision-11b", "whisper-base"])
def test_a_model_check_runs_each_kernel_as_chip_smoke_pins_it(arch,
                                                              monkeypatch):
    """The float32 model check's prefill and decode step at its depth: the
    launches ``LM_SERVES[arch]["check_launches"]`` states."""
    spec = chip_smoke().LM_SERVES[arch]
    check = spec["check"]
    calls = count_lm_calls(monkeypatch)
    cfg = port_smoke(arch).replace(
        n_layers=check["n_layers"], max_seq=17,
        **({"enc_layers": get_config(arch).enc_layers}
           if arch == "whisper-base" else {}))
    model = Model(cfg, device="cpu").init_weights(0)
    rng = np.random.default_rng(0)
    b = check["batch"]
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, 16)).astype(np.int32),
             **context(cfg, rng, b)}
    _, cache = model.prefill(to_torch(batch))
    model.decode_step(cache, torch.zeros((b, 1), dtype=torch.int32))
    assert {k: n for k, n in calls.items() if n} == spec["check_launches"]
