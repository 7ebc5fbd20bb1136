"""The training slice in the port against the JAX package: ``Model.loss``
and its gradients, the LM kernels' ``autograd.Function``s, remat, the
train step, checkpoints across packages and the restart.

The JAX side runs without a mesh (its ``train()`` fails under this jax:
ROADMAP queue 3, R4): ``jax.value_and_grad(model.loss)`` and the jitted
``make_train_step``.  Weights come from the JAX package's ``init`` and
cross through ``convert.lm_params_from_numpy``; batches are made from a
seed with numpy (or the data pipeline).  Tolerances: the loss within 1e-5
(relative), each gradient within 1e-4 of its largest magnitude, three
train steps' losses within 1e-4 (relative) and the parameters after them
within 1e-4 (absolute; float32 sums in other orders than XLA's).  On the
CPU each kernel's ``autograd.Function`` runs with the plain version in the
kernel's place, so the backward code the card runs is the one tested here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.checkpoint.checkpoint as jax_ckpt
import repro.models.model as jax_model
from repro.configs import smoke_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.transformer import set_mesh_axes
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state

import repro_torch.checkpoint.checkpoint as ckpt
import repro_torch.models.model as port_model
from repro_torch.configs import smoke_config as port_smoke
from repro_torch.convert import (lm_leaf_key, lm_params_from_numpy,
                                 lm_params_to_numpy, opt_state_from_numpy,
                                 opt_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.kernels import autograd as kag
from repro_torch.kernels import kernel_wrappers, ops
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.kernels.fused_block import fused_block_torch
from repro_torch.kernels.rglru_scan import rglru_scan_torch
from repro_torch.kernels.ssd_scan import ssd_scan_torch
from repro_torch.launch.steps import (STEP_MARKS, make_train_step,
                                     train_params)
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.layers import grad_fence
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from torch_parity import LM_PLAIN, chip_smoke, count_lm_calls
import torch_parity

torch_parity.one_thread()

ARCHS = ["smollm-360m", "gemma2-2b", "recurrentgemma-2b", "mamba2-2.7b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each gradient's largest magnitude
STEP_TOL = 1e-4
OPT = dict(lr=6e-4, warmup_steps=4, total_steps=12)
_CACHE: dict = {}


def jax_side(arch: str):
    """The JAX model (no mesh) and its float32 weights."""
    if arch not in _CACHE:
        set_mesh_axes(None)
        cfg = smoke_config(arch).replace(max_seq=40)
        model = jax_model.build_model(cfg)
        _CACHE[arch] = (cfg, model, model.init(jax.random.key(0), "float32"))
    return _CACHE[arch]


def as_tree(params):
    return jax.tree.map(np.asarray, params)


def port_side(arch: str, params) -> Model:
    cfg = port_smoke(arch).replace(max_seq=40)
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(lm_params_from_numpy(cfg, as_tree(params)))
    return model


def loss_and_grads(model, batch, remat="full"):
    params = train_params(model)
    loss, metrics = model.loss(batch, remat=remat)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, metrics, dict(zip(params, grads))


def assert_trees_close(got: dict, want, tol, what, relative=True):
    """Every leaf of the port's tree within ``tol`` (of the leaf's largest
    magnitude when ``relative``) of the JAX tree's."""
    flat_want = jax.tree_util.tree_flatten_with_path(as_tree(want))[0]
    flat_got = jax.tree.leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        assert g.shape == w.shape, (what, path)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        scale = float(np.abs(w).max()) if relative and w.size else 1.0
        assert err <= tol * scale, (
            f"{what} {jax.tree_util.keystr(path)}: max abs err {err:.3g} > "
            f"{tol} x {scale:.3g}")


def batch_of(cfg, seed, b=2, s=37):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1                  # not counted
    labels[1, -3:] = -1
    return {"tokens": tokens, "labels": labels}


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["one_chunk", "ragged_chunks"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, chunked, remat, monkeypatch):
    """``Model.loss`` and every parameter's gradient against
    ``jax.value_and_grad(model.loss)`` (labels -1 masked), both under the
    same ``remat``.  ``ragged_chunks`` sets both packages' ``LOSS_CHUNK``
    to 32: chunks of 16 tokens at batch 2, so 37 tokens make two chunks
    and a remainder of 5."""
    cfg, jmodel, params = jax_side(arch)
    if chunked:
        monkeypatch.setattr(jax_model, "LOSS_CHUNK", 32)
        monkeypatch.setattr(port_model, "LOSS_CHUNK", 32)
    batch = batch_of(cfg, 3)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jmodel.loss, remat=remat), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_side(arch, params)
    loss, metrics, grads = loss_and_grads(model, batch, remat=remat)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert metrics["nll"].item() == pytest.approx(float(jmetrics["nll"]),
                                                  rel=LOSS_RTOL)
    assert metrics["aux"].item() == float(jmetrics["aux"]) == 0.0
    assert_trees_close(lm_params_to_numpy(model.cfg, grads), jgrads,
                       GRAD_TOL, f"{arch} gradient")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_full_equals_none(remat):
    """Remat changes what the backward keeps, never a value: the loss and
    every gradient under ``remat`` equal ``"none"``'s."""
    cfg, _, params = jax_side("recurrentgemma-2b")
    model = port_side("recurrentgemma-2b", params)
    batch = batch_of(cfg, 5)
    full = loss_and_grads(model, batch, remat=remat)
    none = loss_and_grads(model, batch, remat="none")
    assert torch.equal(full[0], none[0])
    for name in full[2]:
        assert torch.equal(full[2][name], none[2][name]), name


def test_remat_rejects_an_unknown_policy():
    cfg, _, params = jax_side("smollm-360m")
    model = port_side("smollm-360m", params)
    with pytest.raises(ValueError, match="remat"):
        model.loss(batch_of(cfg, 1), remat="all")


class OpCounter(TorchDispatchMode):
    """Counts every op the dispatcher runs inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def backward_ops(model, batch, remat) -> dict:
    """The ops ``torch.autograd.grad`` runs for the loss under ``remat``
    (the recomputation included), with the loss and the gradients."""
    params = train_params(model)
    loss, _ = model.loss(batch, remat=remat)
    with OpCounter() as seen:
        grads = torch.autograd.grad(loss, list(params.values()))
    return seen.counts, loss, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_recomputes_no_projection(arch):
    """Under ``"dots"`` the backward runs as many products with no batch
    dimension (``aten.mm`` / ``aten.addmm``) as under ``"none"``, which
    recomputes nothing: every projection of the forward is kept, and K7
    (``repro_torch::fused_block``) is not run again.  Under ``"full"`` the
    recomputation runs the projections and K7 again.  The gradients of
    all three are equal."""
    cfg, _, params = jax_side(arch)
    model = port_side(arch, params)
    batch = batch_of(cfg, 11)
    runs = {remat: backward_ops(model, batch, remat)
            for remat in ("none", "dots", "full")}

    def products(remat):
        counts = runs[remat][0]
        return (counts.get("aten.mm.default", 0)
                + counts.get("aten.addmm.default", 0))

    assert products("dots") == products("none") > 0
    assert products("full") > products("none")
    k7 = "repro_torch.fused_block.default"
    assert k7 not in runs["dots"][0] and k7 not in runs["none"][0]
    if arch != "mamba2-2.7b":                  # the ssm layers have no MLP
        assert runs["full"][0][k7] == cfg.n_layers
    for remat in ("dots", "full"):
        assert torch.equal(runs[remat][1], runs["none"][1])
        for a, b in zip(runs[remat][2], runs["none"][2]):
            assert torch.equal(a, b), remat


def test_train_batch_spec():
    model = Model(port_smoke("smollm-360m"), device="cpu")
    spec = model.batch_spec(16, 4, "train")
    assert sorted(spec) == ["labels", "tokens"]
    assert all(s.shape == (4, 16) and s.dtype == torch.int32
               for s in spec.values())


# ----------------------------------------------------- K6-K9 as Functions
def rnd(seed, shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(np.asarray(
        scale * np.random.default_rng(seed).standard_normal(shape),
        dtype=np.float32)).to(dtype)


def k6_case(dtype, b=2, s=11, nh=4, nkv=2, hd=8):
    kw = dict(causal=True, window=5, softcap=20.0)
    return (kag.FlashAttention, flash_attention_torch, kw,
            [rnd(i, (b, s, n, hd), 1.0, dtype)
             for i, n in enumerate((nh, nkv, nkv))])


def k7_case(dtype, m=6, d=8, f=12, sandwich=True, gated=True):
    kw = dict(act="gelu", gated=gated, sandwich=sandwich)
    return (kag.FusedBlock, fused_block_torch, kw,
            [rnd(10, (m, d), 1.0, dtype), rnd(11, (d,), 0.1, dtype),
             rnd(12, (d, f), 0.3, dtype), rnd(13, (d, f), 0.3, dtype),
             rnd(14, (f, d), 0.3, dtype), rnd(15, (d,), 0.1, dtype)])


def k8_case(dtype, b=1, s=10, h=4, p=3, g=2, n=5, chunk=4):
    x = rnd(20, (b, s, h, p), 1.0, dtype)
    dt = torch.sigmoid(rnd(21, (b, s, h), 1.0, dtype))
    return (kag.SSDScan, ssd_scan_torch, chunk,
            [x, dt, -torch.exp(rnd(22, (h,), 0.5, dtype)),
             rnd(23, (b, s, g, n), 1.0, dtype),
             rnd(24, (b, s, g, n), 1.0, dtype), rnd(25, (h,), 1.0, dtype),
             rnd(26, (b, h, p, n), 0.5, dtype)])


def k9_case(dtype, b=2, s=9, w=5):
    return (kag.RGLRUScan, rglru_scan_torch, None,
            [torch.sigmoid(rnd(30, (b, s, w), 1.0, dtype)),
             rnd(31, (b, s, w), 1.0, dtype)])


CASES = {"flash_attention": k6_case, "fused_block": k7_case,
         "ssd_scan": k8_case, "rglru_scan": k9_case}


def apply_fn(fn, forward, kw):
    if fn is kag.RGLRUScan:
        return lambda *xs: fn.apply(forward, *xs)
    return lambda *xs: fn.apply(forward, kw, *xs)


def outputs(y):
    return y if isinstance(y, tuple) else (y,)


@pytest.mark.parametrize("kernel", list(CASES))
def test_function_gradcheck_in_float64(kernel):
    """``torch.autograd.gradcheck`` of each Function, the plain version as
    its forward, at a tiny size.  The plain versions and the backwards'
    training functions compute in float32 inside (as the JAX package's
    do), so the finite differences use eps 1e-3 and the check rtol 1e-2,
    atol 1e-3."""
    fn, forward, kw, inputs = CASES[kernel](torch.float64)
    inputs = [x.requires_grad_() for x in inputs]
    assert torch.autograd.gradcheck(apply_fn(fn, forward, kw),
                                     tuple(inputs), eps=1e-3, atol=1e-3,
                                     rtol=1e-2)


@pytest.mark.parametrize("kernel", list(CASES))
def test_function_backward_equals_autograd_through_the_plain_version(
        kernel):
    """Float32 at the smoke configs' widths: the Function's gradients (the
    backward the card runs) against autograd through the plain version,
    within 1e-5 of each gradient's scale; the outputs are the plain
    version's, with a ``grad_fn``."""
    fn, forward, kw, _ = CASES[kernel](torch.float32)
    shapes = {"flash_attention": dict(b=2, s=37, nh=4, nkv=2, hd=16),
              "fused_block": dict(m=74, d=64, f=128),
              "ssd_scan": dict(b=2, s=37, h=8, p=8, g=1, n=16, chunk=8),
              "rglru_scan": dict(b=2, s=37, w=64)}[kernel]
    *_, inputs = CASES[kernel](torch.float32, **shapes)
    a = [x.clone().requires_grad_() for x in inputs]
    b = [x.clone().requires_grad_() for x in inputs]
    got = outputs(apply_fn(fn, forward, kw)(*a))
    want = outputs(forward(*b) if kernel == "rglru_scan" else (
        forward(*b, chunk=kw) if kernel == "ssd_scan" else forward(*b, **kw)))
    for g, w in zip(got, want):
        assert g.grad_fn is not None and torch.equal(g, w)
    cot = [rnd(40 + i, w.shape) for i, w in enumerate(want)]
    ga = torch.autograd.grad(got, a, cot)
    gb = torch.autograd.grad(want, b, cot)
    for i, (x, y) in enumerate(zip(ga, gb)):
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= 1e-5 * scale, (kernel, i)


def test_ops_outputs_carry_a_grad_fn_and_launch_nothing_on_the_cpu():
    before = {n: fn.launches for n, fn in kernel_wrappers().items()}
    for kernel, case in CASES.items():
        fn, _, kw, inputs = case(torch.float32)
        inputs = [x.requires_grad_() for x in inputs]
        call = {"flash_attention": lambda: ops.flash_attention(*inputs, **kw),
                "fused_block": lambda: ops.fused_block(*inputs, **kw),
                "ssd_scan": lambda: ops.ssd_scan(*inputs, chunk=kw),
                "rglru_scan": lambda: ops.rglru_scan(*inputs)}[kernel]
        for y in outputs(call()):
            assert type(y.grad_fn).__name__ == fn.__name__ + "Backward"
        with ops.plain_versions():
            for y in outputs(call()):
                assert not type(y.grad_fn).__name__.startswith(fn.__name__)
    assert {n: fn.launches for n, fn in kernel_wrappers().items()} == before


def test_grad_fence_casts_the_cotangent():
    x = rnd(50, (3, 4), dtype=torch.bfloat16).requires_grad_()
    y = grad_fence(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y.to(torch.float32) * 3.0).sum(), x)
    assert g.dtype == torch.bfloat16 and torch.all(g == 3.0)


def test_mlp_hands_k7_weights_of_the_activations_type(monkeypatch):
    """float32 masters, bfloat16 activations: K7 gets bfloat16 weights (the
    kernel refuses mixed types); the norm scales stay float32."""
    seen = []

    def spy(x, scale, w_gate, w_up, w_down, post_scale=None, **kw):
        seen.append((x.dtype, w_gate.dtype, w_up.dtype, w_down.dtype,
                     scale.dtype))
        return x

    monkeypatch.setattr(ops, "fused_block", spy)
    cfg = port_smoke("smollm-360m").replace(dtype="bfloat16")
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    model.init_weights(0)
    model.loss(batch_of(cfg, 2), remat="none")
    bf, f32 = torch.bfloat16, torch.float32
    assert seen == [(bf, bf, bf, bf, f32)] * cfg.n_layers


def test_bfloat16_training_forward_is_finite_on_the_cpu():
    cfg = port_smoke("recurrentgemma-2b").replace(dtype="bfloat16")
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    model.init_weights(0)
    loss, _, grads = loss_and_grads(model, batch_of(cfg, 4))
    assert torch.isfinite(loss)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())


# --------------------------------------------------------------- convert
@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_opt_state_cross_both_ways(arch):
    """``lm_params_to_numpy`` inverts ``lm_params_from_numpy`` on the JAX
    tree (group-stacked leaves, tail layers), and ``lm_leaf_key`` orders the
    port's names as the JAX tree's leaves come."""
    cfg, _, params = jax_side(arch)
    pcfg = port_smoke(arch).replace(max_seq=40)
    tree = as_tree(params)
    sd = lm_params_from_numpy(pcfg, tree)
    back = lm_params_to_numpy(pcfg, sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    order = []
    for name in sorted(sd, key=lambda n: lm_leaf_key(pcfg, n)):
        path = "".join(f"[{k!r}]" for k in lm_leaf_key(pcfg, name)[:-1])
        if not order or order[-1] != path:
            order.append(path)
    assert order == paths
    opt = jax.tree.map(np.asarray, jax_init_opt_state(params))
    state = opt_state_from_numpy(pcfg, opt)
    assert state["step"] == 0
    again = opt_state_to_numpy(pcfg, state)
    assert jax.tree.structure(again) == jax.tree.structure(opt)
    assert again["step"].dtype == np.int32 and again["step"].shape == ()


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "mamba2-2.7b"])
def test_three_train_steps_match_the_jax_step(arch):
    """Three steps of ``make_train_step`` against the JAX package's, jitted
    without a mesh, on the data pipeline's batches: the losses and grad
    norms within 1e-4 (relative), the parameters and the optimizer state
    after them within 1e-4."""
    cfg, jmodel, params = jax_side(arch)
    model = port_side(arch, params)
    step = make_train_step(model, AdamWConfig(**OPT))
    opt_state = init_opt_state(train_params(model))
    jstep = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(**OPT)))
    jstate = jax_init_opt_state(params)
    source = SyntheticSource(DataConfig(seq_len=24, global_batch=2,
                                        vocab=cfg.vocab))
    for s in range(3):
        batch = source.batch_at(s)
        params, jstate, want = jstep(params, jstate,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        got = step(opt_state, batch)
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                  rel=STEP_TOL), (s, k)
    assert_trees_close(lm_params_to_numpy(model.cfg, model.state_dict()),
                       params, STEP_TOL, f"{arch} params", relative=False)
    assert_trees_close(opt_state_to_numpy(model.cfg, opt_state), jstate,
                       STEP_TOL, f"{arch} opt state", relative=False)


def test_train_step_marks_its_stages_and_computes_the_same():
    """``make_train_step``'s ``mark`` is called at ``STEP_MARKS`` in turn,
    once a step, and changes nothing of what the step computes."""
    cfg, _, params = jax_side("smollm-360m")
    marked, plain = port_side("smollm-360m", params), \
        port_side("smollm-360m", params)
    seen = []
    step_m = make_train_step(marked, AdamWConfig(**OPT), mark=seen.append)
    step_p = make_train_step(plain, AdamWConfig(**OPT))
    state_m = init_opt_state(train_params(marked))
    state_p = init_opt_state(train_params(plain))
    batch = batch_of(cfg, 10)
    for _ in range(2):
        got, want = step_m(state_m, batch), step_p(state_p, batch)
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}
    assert seen == 2 * list(STEP_MARKS)
    for name, t in plain.state_dict().items():
        assert torch.equal(marked.state_dict()[name], t), name


def test_lm_params_to_numpy_shares_no_memory_with_the_model():
    """The host tree is a copy: an in-place step on the model leaves it
    as it was (so ``AsyncCheckpointer`` takes its numpy leaves as they
    are)."""
    cfg, _, params = jax_side("smollm-360m")
    model = port_side("smollm-360m", params)
    tree = lm_params_to_numpy(model.cfg, model.state_dict())
    before = jax.tree.map(np.copy, tree)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(1.0)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(before)))


# ------------------------------------------------------------ checkpoints
def train_tree(arch):
    """The JAX train state (params, opt state) and the abstract tree of
    it."""
    _, _, params = jax_side(arch)
    state = (params, jax_init_opt_state(params))
    return state, jax.eval_shape(lambda: state)


@pytest.fixture
def zlib_only(monkeypatch):
    """Both packages' codec as on the machine with the GPU (no
    zstandard)."""
    monkeypatch.setattr(ckpt, "zstandard", None)
    monkeypatch.setattr(jax_ckpt, "zstandard", None)


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
def test_a_port_checkpoint_restores_in_jax(arch, tmp_path, zlib_only,
                                           monkeypatch):
    """The port writes the state of a model and its optimizer (from its
    own tensors, in pieces of at most 4 KB); the JAX ``restore`` reads it
    back leaf for leaf."""
    monkeypatch.setattr(ckpt, "PIECE_BYTES", 4096)
    state, abstract = train_tree(arch)
    model = port_side(arch, state[0])
    pcfg = model.cfg
    opt = opt_state_from_numpy(pcfg, as_tree(state[1]))
    opt["step"] = 7
    for t in opt["m"].values():
        t.add_(0.25)
    tree = (lm_params_to_numpy(pcfg, model.state_dict()),
            opt_state_to_numpy(pcfg, opt))
    ckpt.save(tree, tmp_path, 7)
    assert jax_ckpt.latest_step(tmp_path) == 7
    manifest = (tmp_path / "step_000000007" / "MANIFEST_0.json").read_text()
    assert '"codec": "zlib"' in manifest
    back = jax_ckpt.restore(abstract, tmp_path, 7)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)


def test_a_jax_checkpoint_restores_in_the_port(tmp_path, zlib_only):
    state, _ = train_tree("recurrentgemma-2b")
    jax_ckpt.save(state, tmp_path, 3)
    assert ckpt.latest_step(tmp_path) == 3
    back = ckpt.restore(tmp_path, 3)
    assert isinstance(back, tuple) and len(back) == 2
    want = as_tree(state)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pcfg = port_smoke("recurrentgemma-2b").replace(max_seq=40)
    model = Model(pcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(lm_params_from_numpy(pcfg, back[0]))
    assert opt_state_from_numpy(pcfg, back[1])["step"] == 0


def test_restore_refuses_a_damaged_checkpoint(tmp_path):
    tree = {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "s": np.asarray(5, np.int32)}
    path = ckpt.save(tree, tmp_path, 1)
    back = ckpt.restore(tmp_path, 1)
    assert np.array_equal(back["w"], tree["w"]) and back["s"] == 5
    manifest = (path / "MANIFEST_0.json").read_text()
    (path / "MANIFEST_0.json").write_text(
        manifest.replace(manifest.split('"digest": "')[1][:16], "0" * 16))
    with pytest.raises(ValueError, match="digest"):
        ckpt.restore(tmp_path, 1)
    (path / "COMMITTED").unlink()
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 1)


def test_async_snapshot_survives_an_in_place_step(tmp_path):
    """The snapshot is taken when ``save`` is called: an optimizer step
    that writes the parameters in place right after does not reach the
    checkpoint."""
    cfg, _, params = jax_side("smollm-360m")
    model = port_side("smollm-360m", params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    saver = ckpt.AsyncCheckpointer(tmp_path)
    saver.save({"params": dict(model.state_dict())}, 1)
    step = make_train_step(model, AdamWConfig(**OPT))
    step(init_opt_state(train_params(model)), batch_of(cfg, 6))
    saver.wait()
    back = ckpt.restore(tmp_path, 1)["params"]
    changed = 0
    for name, t in before.items():
        assert np.array_equal(back[name], t.numpy()), name
        changed += not torch.equal(model.state_dict()[name], t)
    assert changed == len(before)


def test_async_checkpointer_raises_what_its_thread_raised(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(blocker)
    saver.save({"w": np.zeros(3, np.float32)}, 1)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                              # reported once


# ---------------------------------------------------------------- train()
def small_run(tmp_path, name, steps):
    cfg = port_smoke("smollm-360m").replace(max_seq=16)
    dc = DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab)
    tc = TrainConfig(steps=steps, log_every=1, ckpt_every=3,
                     ckpt_dir=str(tmp_path / name), opt=AdamWConfig(**OPT))
    return train(cfg, tc, data_cfg=dc, device="cpu")


def test_preempt_restart_identical_trajectory(tmp_path):
    """6 steps straight against 3, a checkpoint, and a fresh ``train()``
    on the same directory that resumes at step 3: the losses at steps
    3-5 within 1e-4 (the JAX package's test of the same)."""
    straight = dict(small_run(tmp_path, "a", 6)["losses"])
    first = small_run(tmp_path, "b", 3)
    assert ckpt.latest_step(tmp_path / "b") == 3
    assert [s for s, _ in first["losses"]] == [0, 1, 2]
    resumed = small_run(tmp_path, "b", 6)
    assert [s for s, _ in resumed["losses"]] == [3, 4, 5]
    assert resumed["opt_state"]["step"] == 6
    for s, loss in resumed["losses"]:
        assert abs(loss - straight[s]) < 1e-4, (s, loss, straight[s])
    assert straight[5] < straight[0]
    assert len(resumed["step_s"]) == 3 and min(resumed["step_s"]) > 0


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(port_smoke("smollm-360m"), TrainConfig(steps=1))


def test_train_command_line_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu", "--seq",
          "16", "--batch", "2", "--steps", "2", "--ckpt-dir",
          str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "step 0: loss" in out and out.rstrip().endswith("over 1 steps")


# ------------------------------------------------ chip_smoke.py's phase 7
@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_a_train_step_runs_each_kernel_as_chip_smoke_pins_it(remat,
                                                            monkeypatch):
    """A step's forwards and backward of smollm-360m (smoke width, 3
    layers) run K6 and K7 as ``TRAIN_LAUNCHES_PER_STEP[remat]`` pins them
    for 32 layers: K6 and K7 twice a layer under remat="full" (the
    recomputation), K6 twice and K7 once under "dots" (K7's output kept),
    each once without remat."""
    smoke = chip_smoke()
    calls = count_lm_calls(monkeypatch)
    cfg = port_smoke("smollm-360m").replace(n_layers=3)
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    model.init_weights(0)
    loss_and_grads(model, batch_of(cfg, 8), remat=remat)
    per_layer = ({"flash_attention": 1, "fused_block": 1} if remat == "none"
                 else {k: v // 32 for k, v in
                       smoke.TRAIN_LAUNCHES_PER_STEP[remat].items()})
    assert calls == {k: 3 * per_layer.get(k, 0) for k in LM_PLAIN}
    assert smoke.TRAIN_LAUNCHES_PER_STEP["dots"] == {
        "flash_attention": 2 * 32, "fused_block": 32}


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "mamba2-2.7b", "smollm-360m remat=full",
                                  "smollm-360m remat=dots",
                                  "recurrentgemma-2b remat=dots"])
def test_gradient_checks_run_each_kernel_as_chip_smoke_pins_it(arch,
                                                              monkeypatch):
    """The gradient checks' launch counts (``GRAD_CHECKS`` under each
    check's remat: "full" runs each layer again in the backward, "dots"
    each layer but its K7; K9 again in the backward) on the smoke configs at the same depth; and the
    variants they pin are those the fixed rules give float32 at the full
    configs' shapes (batch 2 x 512 on 132 SMs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_block import fused_block_variant
    from repro_torch.kernels.flash_attention import flash_attention_variant
    from repro_torch.kernels.ssd_scan import ssd_scan_variant
    smoke = chip_smoke()
    spec = smoke.GRAD_CHECKS[arch]
    calls = count_lm_calls(monkeypatch)
    cfg = port_smoke(spec["arch"]).replace(n_layers=spec["n_layers"])
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    model.init_weights(0)
    loss_and_grads(model, batch_of(cfg, 9), remat=spec["remat"])
    assert {k: n for k, n in calls.items() if n} == spec["launches"]
    full = get_config(spec["arch"])
    m = smoke.GRAD_BATCH[0] * smoke.GRAD_BATCH[1]
    rules = {"flash_attention": lambda: flash_attention_variant(
                 torch.float32, full.hd),
             "fused_block": lambda: fused_block_variant(
                 torch.float32, m, full.d_model, full.d_ff, 132),
             "ssd_scan": lambda: ssd_scan_variant(torch.float32)}
    for name, by_variant in spec["by_variant"].items():
        assert by_variant == {rules[name](): spec["launches"][name]}
