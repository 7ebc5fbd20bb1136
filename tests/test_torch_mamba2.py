"""The port's Mamba-2 pieces against the JAX package: K8's plain version
``kernels/ssd_scan.py::ssd_scan_torch`` against the JAX model's
``ssd_chunked``, the Pallas ``ssd_scan`` in interpret mode (as
tests/test_kernels.py runs it) and the sequential oracle
``kernels/ref.py::ssd_scan_ref``; the whole block ``ssm_apply`` (prefill,
a prefill continued from a state, decode) and ``init_ssm_state``; and the
weights crossing over through ``convert.lm_params_from_numpy``.

Inputs are made from a seed with numpy and handed to both packages; in
bfloat16 both round the same float32 numbers to nearest even.  Tolerances
are those of tests/test_kernels.py for the SSD: float32 1e-4, bfloat16
4e-2 (on ``y``; the final state is float32 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
import repro.models.mamba2 as jax_mamba2
from repro.configs import get_config, smoke_config
from repro.kernels.ref import ssd_scan_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_kernel
from repro.models.model import build_model as jax_build

import repro_torch.models.mamba2 as mamba2
from repro_torch.configs import get_config as port_config
from repro_torch.configs import smoke_config as port_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch
from repro_torch.models.layers import Params
from repro_torch.models.model import Model
import torch_parity

torch_parity.one_thread()

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
STATE_TOL = TOL["float32"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
jax_ssd_chunked = jax.jit(jax_mamba2.ssd_chunked, static_argnums=(6,))
jax_ssm_apply = jax.jit(jax_mamba2.ssm_apply, static_argnums=(2,))


def rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def ssd_inputs(b, s, h, p, g, n, seed=0, with_h0=False):
    """numpy float32 inputs of the model layout: dt after softplus, A < 0."""
    dt = np.log1p(np.exp(rnd(seed + 1, (b, s, h))))
    A = -np.exp(rnd(seed + 2, (h,), 0.2))
    return dict(x=rnd(seed, (b, s, h, p)), dt=dt, A=A,
                Bm=rnd(seed + 3, (b, s, g, n)), Cm=rnd(seed + 4, (b, s, g, n)),
                D=rnd(seed + 5, (h,)),
                h0=rnd(seed + 6, (b, h, p, n)) if with_h0 else None)


def port_args(inp, dtype):
    """The inputs as torch tensors: x, Bm, Cm in ``dtype``, the rest
    float32 (the model's types)."""
    out = {k: None if v is None else torch.from_numpy(v)
           for k, v in inp.items()}
    for k in ("x", "Bm", "Cm"):
        out[k] = out[k].to(TORCH[dtype])
    return out


def jax_args(inp, dtype):
    out = {k: None if v is None else jnp.asarray(v) for k, v in inp.items()}
    for k in ("x", "Bm", "Cm"):
        out[k] = out[k].astype(JNP[dtype])
    return out


# ------------------------------------------------------ K8's plain version
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 8, 1, 16, 16),          # whole chunks
    (1, 45, 4, 8, 2, 8, 16),           # ragged last chunk, two groups
    (2, 21, 6, 4, 2, 16, 8),           # ragged, three heads a group
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_plain_matches_jax_ssd_chunked(dtype, b, s, h, p, g, n, chunk,
                                           with_h0):
    inp = ssd_inputs(b, s, h, p, g, n, seed=b * 100 + s, with_h0=with_h0)
    pa, ja = port_args(inp, dtype), jax_args(inp, dtype)
    y, state = ssd_scan_torch(pa["x"], pa["dt"], pa["A"], pa["Bm"],
                              pa["Cm"], pa["D"], pa["h0"], chunk=chunk)
    jy, jstate = jax_ssd_chunked(ja["x"], ja["dt"], ja["A"], ja["Bm"],
                                 ja["Cm"], ja["D"], chunk, ja["h0"])
    assert y.dtype == TORCH[dtype] and y.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    close(y, jy, **TOL[dtype])
    close(state, jstate, **STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,P,N,G,chunk", [
    (4, 64, 16, 8, 1, 16),
    (6, 128, 8, 16, 2, 32),
    (2, 32, 32, 32, 1, 32),
])
def test_ssd_plain_matches_pallas_kernel(dtype, BH, S, P, N, G, chunk):
    """The TPU kernel in interpret mode, on tests/test_kernels.py's shapes:
    its [BH, S, P] rows are the heads of one batch row, its [BG, S, N]
    rows the groups; it starts from a zero state and returns y only."""
    inp = ssd_inputs(1, S, BH, P, G, N, seed=BH + S)
    ja = jax_args(inp, dtype)
    out = jax_ssd_kernel(
        ja["x"][0].transpose(1, 0, 2), ja["dt"][0].T, ja["A"][:, None],
        ja["D"][:, None], ja["Bm"][0].transpose(1, 0, 2),
        ja["Cm"][0].transpose(1, 0, 2), chunk=chunk, nheads=BH // G,
        interpret=True)
    pa = port_args(inp, dtype)
    y, _ = ssd_scan_torch(pa["x"], pa["dt"], pa["A"], pa["Bm"], pa["Cm"],
                          pa["D"], chunk=chunk)
    close(y[0].transpose(0, 1), out, **TOL[dtype])


@pytest.mark.parametrize("s,chunk", [(45, 16), (32, 32), (7, 16)])
def test_ssd_plain_matches_sequential_ref(s, chunk):
    """The sequential recurrence ``ssd_scan_ref`` (one token at a time,
    no chunks), on a ragged sequence with two groups of two heads."""
    h, p, g, n = 4, 8, 2, 16
    inp = ssd_inputs(1, s, h, p, g, n, seed=s)
    ja = jax_args(inp, "float32")
    ref = ssd_scan_ref(ja["x"][0].transpose(1, 0, 2), ja["dt"][0].T,
                       ja["A"][:, None], ja["D"][:, None],
                       ja["Bm"][0].transpose(1, 0, 2),
                       ja["Cm"][0].transpose(1, 0, 2))
    pa = port_args(inp, "float32")
    y, _ = ssd_scan_torch(pa["x"], pa["dt"], pa["A"], pa["Bm"], pa["Cm"],
                          pa["D"], chunk=chunk)
    close(y[0].transpose(0, 1), ref, **TOL["float32"])


def test_ssd_plain_carries_the_state_across_calls():
    """Scanning 40 tokens at once equals scanning 24 and then 16 from the
    first call's final state, whatever the chunk boundaries."""
    pa = port_args(ssd_inputs(2, 40, 4, 8, 2, 16, seed=9), "float32")
    y, state = ssd_scan_torch(*(pa[k] for k in ("x", "dt", "A", "Bm", "Cm",
                                                 "D")), chunk=16)
    first = {k: v[:, :24] if k in ("x", "dt", "Bm", "Cm") else v
             for k, v in pa.items()}
    rest = {k: v[:, 24:] if k in ("x", "dt", "Bm", "Cm") else v
            for k, v in pa.items()}
    y1, s1 = ssd_scan_torch(*(first[k] for k in ("x", "dt", "A", "Bm", "Cm",
                                                 "D")), chunk=16)
    y2, s2 = ssd_scan_torch(*(rest[k] for k in ("x", "dt", "A", "Bm", "Cm",
                                                "D")), s1, chunk=16)
    close(torch.cat([y1, y2], dim=1), y, **TOL["float32"])
    close(s2, state, **STATE_TOL)


def test_ssd_plain_does_not_overflow_on_long_chunks():
    """At chunk 256 with large steps ``cum`` falls far below -88, where
    ``exp(-cum)`` is inf in float32: the output stays finite."""
    inp = ssd_inputs(1, 256, 2, 4, 1, 8, seed=3)
    inp["dt"] = inp["dt"] + 2.0
    inp["A"] = np.full(2, -4.0, np.float32)
    pa = port_args(inp, "float32")
    y, state = ssd_scan_torch(pa["x"], pa["dt"], pa["A"], pa["Bm"],
                              pa["Cm"], pa["D"], chunk=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    ja = jax_args(inp, "float32")
    ref = ssd_scan_ref(ja["x"][0].transpose(1, 0, 2), ja["dt"][0].T,
                       ja["A"][:, None], ja["D"][:, None],
                       ja["Bm"][0].transpose(1, 0, 2),
                       ja["Cm"][0].transpose(1, 0, 2))
    close(y[0].transpose(0, 1), ref, **TOL["float32"])


def test_ssd_shapes_are_checked():
    pa = port_args(ssd_inputs(1, 8, 4, 8, 2, 16), "float32")
    args = [pa[k] for k in ("x", "dt", "A", "Bm", "Cm", "D")]
    with pytest.raises(ValueError, match="h0"):
        ssd_scan_torch(*args, torch.zeros(1, 4, 8, 8), chunk=8)
    with pytest.raises(ValueError, match="multiple of g"):
        three = torch.zeros(1, 8, 3, 16)           # 4 heads, 3 groups
        ssd_scan_torch(args[0], args[1], args[2], three, three, args[5],
                       chunk=8)


# ------------------------------------------------------------- the block
def ssm_params(seed):
    """The JAX package's ssm parameters of the smoke config, with A_log, D
    and dt_bias drawn (their initializer gives constants), and a port
    ``Params`` holding the same numbers."""
    cfg = smoke_config("mamba2-2.7b")
    tree = jax_layers.materialize(jax_mamba2.ssm_defs(cfg),
                                  jax.random.key(seed))
    arrays = {k: np.array(v, np.float32) for k, v in tree.items()}
    nh = cfg.ssm_nheads
    arrays["A_log"] = rnd(seed + 1, (nh,), 0.5)
    arrays["D"] = rnd(seed + 2, (nh,))
    arrays["dt_bias"] = rnd(seed + 3, (nh,), 0.5)
    mod = Params(mamba2.ssm_defs(port_smoke("mamba2-2.7b")), torch.float32,
                 "cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()})
    return cfg, {k: jnp.asarray(v) for k, v in arrays.items()}, mod


def close_state(st, jst):
    assert set(st) == set(jst) == {"convx", "convbc", "ssd"}
    for k in st:
        close(st[k], jst[k], **TOL["float32"])


def test_ssm_apply_prefill_then_decode():
    """A prefill of 19 tokens (a ragged last chunk of 3; K8's plain
    version from a zero state) and three O(1) decode steps carry the same
    output and state as the JAX block."""
    cfg, jp, mod = ssm_params(1)
    pcfg = port_smoke("mamba2-2.7b")
    x = rnd(10, (2, 19, cfg.d_model))
    st = mamba2.init_ssm_state(pcfg, 2)
    jst = jax_mamba2.init_ssm_state(cfg, 2)
    y, st = mamba2.ssm_apply(mod, torch.from_numpy(x), pcfg, state=st)
    jy, jst = jax_ssm_apply(jp, x, cfg, state=jst)
    close(y, jy, **TOL["float32"])
    close_state(st, jst)
    for i in range(3):
        xd = rnd(20 + i, (2, 1, cfg.d_model))
        y, st = mamba2.ssm_apply(mod, torch.from_numpy(xd), pcfg, state=st)
        jy, jst = jax_ssm_apply(jp, xd, cfg, state=jst)
        close(y, jy, **TOL["float32"])
        close_state(st, jst)


def test_ssm_apply_prefill_continues_from_a_state():
    """A second prefill of 13 tokens starts from the first one's state
    (non-zero ``h0`` and conv states), on both sides."""
    cfg, jp, mod = ssm_params(2)
    pcfg = port_smoke("mamba2-2.7b")
    x1, x2 = rnd(30, (2, 11, cfg.d_model)), rnd(31, (2, 13, cfg.d_model))
    y, st = mamba2.ssm_apply(mod, torch.from_numpy(x1), pcfg,
                             state=mamba2.init_ssm_state(pcfg, 2))
    jy, jst = jax_ssm_apply(jp, x1, cfg,
                            state=jax_mamba2.init_ssm_state(cfg, 2))
    assert float(st["ssd"].abs().max()) > 0.1
    y, st = mamba2.ssm_apply(mod, torch.from_numpy(x2), pcfg, state=st)
    jy, jst = jax_ssm_apply(jp, x2, cfg, state=jst)
    close(y, jy, **TOL["float32"])
    close_state(st, jst)


def test_ssm_apply_without_a_state_is_the_prefill_from_zero():
    cfg, jp, mod = ssm_params(3)
    pcfg = port_smoke("mamba2-2.7b")
    x = rnd(40, (1, 17, cfg.d_model))
    y, st = mamba2.ssm_apply(mod, torch.from_numpy(x), pcfg)
    jy, jst = jax_ssm_apply(jp, x, cfg)
    close(y, jy, **TOL["float32"])
    close_state(st, jst)


def test_conv_state_does_not_hold_the_whole_input():
    """The state ``causal_conv`` returns for the cache owns its K - 1 rows:
    a view into the padded input would keep all of it alive in the cache
    (at mamba2-2.7b's serve, 64 layers x 84 MB)."""
    x = torch.from_numpy(rnd(50, (2, 300, 16)))
    _, state = mamba2.causal_conv(x, torch.from_numpy(rnd(51, (4, 16))),
                                  torch.zeros(16))
    assert state.shape == (2, 3, 16)
    assert state.untyped_storage().nbytes() == state.numel() * 4
    assert torch.equal(state, x[:, -3:])


@pytest.mark.parametrize("arch,smoke", [("mamba2-2.7b", True),
                                        ("mamba2-2.7b", False)])
def test_init_ssm_state_matches_jax(arch, smoke):
    cfg = smoke_config(arch) if smoke else get_config(arch)
    pcfg = port_smoke(arch) if smoke else port_config(arch)
    st = mamba2.init_ssm_state(pcfg, 3)
    jst = jax_mamba2.init_ssm_state(cfg, 3)
    assert set(st) == set(jst)
    for k in st:
        assert tuple(st[k].shape) == tuple(jst[k].shape), k
        assert str(st[k].dtype).split(".")[-1] == str(jst[k].dtype), k
        assert not bool(st[k].any())


# ------------------------------------------------------------ the weights
def test_ssm_weights_cross_through_convert():
    """The JAX ``Model.init`` tree of mamba2's smoke config lands in the
    port's model name for name, ``D`` included (which also names the
    ``ParamDef`` helper in ``models/layers.py``)."""
    cfg = smoke_config("mamba2-2.7b")
    params = jax_build(cfg).init(jax.random.key(4), cfg.dtype)
    tree = jax.tree.map(np.asarray, params)
    pcfg = port_smoke("mamba2-2.7b")
    sd = lm_params_from_numpy(pcfg, tree)
    model = Model(pcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    for layer in range(pcfg.n_layers):
        for name in ("D", "A_log", "in_bc", "out_proj"):
            got = model.state_dict()[f"layers.{layer}.ssm.{name}"]
            want = tree["stack"]["groups"]["p0"]["ssm"][name][layer]
            assert np.array_equal(got.numpy(), want), (layer, name)


# -------------------------------------------------------------- dispatch
def test_ops_ssd_scan_on_the_cpu_runs_the_plain_version():
    pa = port_args(ssd_inputs(1, 12, 2, 4, 1, 8, with_h0=True), "float32")
    args = [pa[k] for k in ("x", "dt", "A", "Bm", "Cm", "D", "h0")]
    before = ssd_scan_cuda.launches
    for ctx in (torch.no_grad(), ops.plain_versions()):
        with ctx:
            got = ops.ssd_scan(*args, chunk=8)
            want = ssd_scan_torch(*args, chunk=8)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssd_scan_cuda.launches == before


# ---------------------------------- the tensor-core kernel's rounding plan
# (rtol, atol) the kernel is held to against its plain version on the card
# (chip_smoke.py: SSD_TOL): y in its own type, the state in float32
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def split_bf16(v):
    """A float32 operand as the kernel feeds it to mma.sync: bfloat16 hi
    (the rounding of v) and lo (the rounding of v - hi), in float32."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def ssd_tc_emulation(x, dt, A, Bm, Cm, D, h0=None, *, chunk):
    """csrc/ssd_scan_tc.cu's arithmetic in torch on the CPU, stage by
    stage: cum in float64 rounded once a position; (1) every chunk's own
    state from zero, (w x)^T B with w x split into hi + lo; (2) the chain
    over the chunks from h0; (3) exp(cum_i) (C . state) with the state
    split, then M = (C B^T) exp(cum_i - cum_j) dt_j for j <= i, split, times
    x; y = that + D x, rounded once.  Products of bfloat16 operands,
    accumulated in float32."""
    f32 = torch.float32
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg, nc = h // g, -(-s // chunk)
    xf, Bf, Cf = x.to(f32), Bm.to(f32), Cm.to(f32)
    states, decays, cums = [], [], []
    for c in range(nc):                                   # stage 1
        t0, L = c * chunk, min(chunk, s - c * chunk)
        dtc = torch.zeros((b, chunk, h), dtype=f32)
        dtc[:, :L] = dt[:, t0:t0 + L]
        cum = torch.cumsum((dtc * A).to(torch.float64), dim=1).to(f32)
        w = dtc * torch.exp(cum[:, -1:] - cum)            # [b, q, h]
        hi, lo = split_bf16(xf[:, t0:t0 + L] * w[:, :L, :, None])
        Bh = Bf[:, t0:t0 + L].repeat_interleave(hg, dim=2)
        states.append(torch.einsum("blhp,blhn->bhpn", hi, Bh)
                      + torch.einsum("blhp,blhn->bhpn", lo, Bh))
        decays.append(torch.exp(cum[:, -1]))              # [b, h]
        cums.append(cum)
    state = torch.zeros((b, h, p, n), dtype=f32) if h0 is None else h0
    entering = []
    for c in range(nc):                                   # stage 2: chain
        entering.append(state)
        state = state * decays[c][:, :, None, None] + states[c]
    ys = []
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    for c in range(nc):                                   # stage 3
        t0, L = c * chunk, min(chunk, s - c * chunk)
        cum = cums[c][:, :L]                              # [b, l, h]
        Ch = Cf[:, t0:t0 + L].repeat_interleave(hg, dim=2)
        Bh = Bf[:, t0:t0 + L].repeat_interleave(hg, dim=2)
        st_hi, st_lo = split_bf16(entering[c])
        y_off = (torch.einsum("blhn,bhpn->blhp", Ch, st_hi)
                 + torch.einsum("blhn,bhpn->blhp", Ch, st_lo)) \
            * torch.exp(cum)[..., None]
        scores = torch.einsum("blhn,bmhn->blmh", Ch, Bh)
        seg = (cum[:, :, None] - cum[:, None]).masked_fill(
            ~causal[:L, :L, None], float("-inf"))
        m = scores * torch.exp(seg) * dt[:, None, t0:t0 + L]
        m_hi, m_lo = split_bf16(m)
        xc = xf[:, t0:t0 + L]
        ys.append(y_off + torch.einsum("blmh,bmhp->blhp", m_hi, xc)
                  + torch.einsum("blmh,bmhp->blhp", m_lo, xc))
    y = torch.cat(ys, dim=1) + xf * D[None, None, :, None]
    return y.to(x.dtype), state


EMULATED = [(2, 64, 4, 16, 1, 32, 16, False),     # whole chunks, one group
            (1, 45, 4, 8, 2, 8, 16, True),        # ragged chunk, two groups
            (2, 37, 6, 24, 3, 40, 10, True),      # every width off the tiles
            (1, 70, 8, 16, 8, 16, 32, True)]      # a group a head


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_h0", EMULATED)
def test_tc_rounding_plan_holds_to_the_plain_version(dtype, b, s, h, p, g,
                                                     n, chunk, with_h0):
    """The split float32 operands add no rounding point: y within the
    kernel's tolerance of the plain version, the state within 1e-4."""
    inp = ssd_inputs(b, s, h, p, g, n, seed=7 * s + h, with_h0=with_h0)
    pa = port_args(inp, dtype)
    args = [pa[k] for k in ("x", "dt", "A", "Bm", "Cm", "D", "h0")]
    y, state = ssd_tc_emulation(*args, chunk=chunk)
    py, pstate = ssd_scan_torch(*args, chunk=chunk)
    assert y.dtype == py.dtype and y.shape == py.shape
    close(y, py, **SSD_TOL[dtype])
    close(state, pstate, **SSD_TOL["float32"])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_h0", EMULATED)
def test_tc_rounding_plan_matches_jax_ssd_chunked(b, s, h, p, g, n, chunk,
                                                  with_h0):
    inp = ssd_inputs(b, s, h, p, g, n, seed=3 * s + g, with_h0=with_h0)
    pa, ja = port_args(inp, "bfloat16"), jax_args(inp, "bfloat16")
    y, state = ssd_tc_emulation(*(pa[k] for k in ("x", "dt", "A", "Bm", "Cm",
                                                  "D", "h0")), chunk=chunk)
    jy, jstate = jax_ssd_chunked(ja["x"], ja["dt"], ja["A"], ja["Bm"],
                                 ja["Cm"], ja["D"], chunk, ja["h0"])
    close(y, jy, **TOL["bfloat16"])
    close(state, jstate, **STATE_TOL)


@pytest.mark.parametrize("BH,S,P,N,G,chunk", [(4, 64, 16, 8, 1, 16),
                                              (6, 128, 8, 16, 2, 32)])
def test_tc_rounding_plan_matches_pallas_kernel(BH, S, P, N, G, chunk):
    """The TPU kernel in interpret mode (zero state, y only), bfloat16."""
    inp = ssd_inputs(1, S, BH, P, G, N, seed=BH * S)
    ja = jax_args(inp, "bfloat16")
    out = jax_ssd_kernel(
        ja["x"][0].transpose(1, 0, 2), ja["dt"][0].T, ja["A"][:, None],
        ja["D"][:, None], ja["Bm"][0].transpose(1, 0, 2),
        ja["Cm"][0].transpose(1, 0, 2), chunk=chunk, nheads=BH // G,
        interpret=True)
    pa = port_args(inp, "bfloat16")
    y, _ = ssd_tc_emulation(pa["x"], pa["dt"], pa["A"], pa["Bm"], pa["Cm"],
                            pa["D"], chunk=chunk)
    close(y[0].transpose(0, 1), out, **TOL["bfloat16"])


def test_one_pass_bfloat16_rounding_would_miss_the_state_tolerance():
    """Why the float32 operands are split: rounded once to bfloat16, the
    chunk states alone leave the float32 tolerance at chunk 256."""
    inp = ssd_inputs(1, 256, 2, 16, 1, 32, seed=11)
    pa = port_args(inp, "bfloat16")
    args = [pa[k] for k in ("x", "dt", "A", "Bm", "Cm", "D", "h0")]
    _, pstate = ssd_scan_torch(*args, chunk=256)
    cum = torch.cumsum((pa["dt"] * pa["A"]).double(), dim=1).float()
    w = pa["dt"] * torch.exp(cum[:, -1:] - cum)
    xw = pa["x"].float() * w[..., None]
    Bh = pa["Bm"].float().repeat_interleave(2, dim=2)
    once = torch.einsum("blhp,blhn->bhpn", xw.to(torch.bfloat16).float(), Bh)
    hi, lo = split_bf16(xw)
    split = (torch.einsum("blhp,blhn->bhpn", hi, Bh)
             + torch.einsum("blhp,blhn->bhpn", lo, Bh))
    tol = SSD_TOL["float32"]
    assert torch.allclose(split, pstate, **tol)
    assert not torch.allclose(once, pstate, **tol)
