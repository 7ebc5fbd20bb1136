"""The LM kernels' plain versions in the port (K6 flash attention, K7 fused
MLP block, K9 RG-LRU scan; K8's, the SSD scan, is held in
test_torch_mamba2.py) against the JAX package: its Pallas kernels in
interpret mode, as tests/test_kernels.py runs them, its pure-jnp oracles
(``kernels/ref.py``) and the model functions each kernel is the twin of.
Inputs are made from a seed with numpy and handed to both packages; in
bfloat16 both round the same float32 numbers to nearest even.  Tolerances
are those of tests/test_kernels.py: float32 2e-5 (K9 1e-4), bfloat16 2e-2.

On the CPU ``kernels/ops.py`` dispatches to the plain versions; the CUDA
wrappers refuse CPU tensors (they launch or raise), and the kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.fused_block import fused_block as jax_fused
from repro.kernels.ref import flash_attention_ref, fused_block_ref
from repro.kernels.rglru_scan import rglru_scan_kernel as jax_rglru_kernel
from repro.models.attention import blocked_attention as jax_blocked
from repro.models.rglru import rglru_scan

jax_rglru_model = jax.jit(rglru_scan)

from repro_torch.kernels import _build, kernel_wrappers, ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)
from repro_torch.kernels.fused_block import (fused_block_cuda,
                                             fused_block_torch)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_torch
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch
from repro_torch.models.attention import blocked_attention
from torch_parity import chip_smoke
import torch_parity

torch_parity.one_thread()

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def both(a, dtype):
    """The same numbers as a jax and a torch array of ``dtype``."""
    return (jnp.asarray(a).astype(JNP[dtype]),
            torch.from_numpy(a).to(TORCH[dtype]))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


# ------------------------------------------------------------------- K6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,NKV,hd,bq", [
    (2, 128, 4, 2, 32, 64),        # GQA
    (1, 64, 2, 1, 64, 32),         # MQA
    (2, 96, 4, 4, 16, 32),
])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 32, 0.0), (True, 0, 50.0), (False, 0, 0.0),
])
def test_flash_plain_matches_jax_kernel_and_ref(dtype, B, S, NH, NKV, hd,
                                                bq, causal, window, softcap):
    qj, qt = both(rnd(0, (B, S, NH, hd)), dtype)
    kj, kt = both(rnd(1, (B, S, NKV, hd)), dtype)
    vj, vt = both(rnd(2, (B, S, NKV, hd)), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention_torch(qt, kt, vt, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (B, S, NH, hd)
    close(got, flash_attention_ref(qj, kj, vj, **kw), **TOL[dtype])
    close(got, jax_flash(qj, kj, vj, block_q=bq, block_k=bq, interpret=True,
                         **kw), **TOL[dtype])


@pytest.mark.parametrize("window", [0, 24])
def test_flash_plain_matches_model_blocked_attention(window):
    """K6's plain version, the JAX model's blocked attention and the port's
    blocked attention agree (float32, 2e-5), with a ragged length."""
    q = rnd(3, (2, 72, 4, 32))
    k = rnd(4, (2, 72, 2, 32))
    v = rnd(5, (2, 72, 2, 32))
    got = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window)
    close(got, jax_blocked(q, k, v, causal=True, window=window),
          **TOL["float32"])
    close(got, blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=window),
          **TOL["float32"])


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,f,bm,bf", [
    (64, 128, 256, 32, 128),
    (128, 96, 384, 64, 96),
])
@pytest.mark.parametrize("gated,act,sandwich", [
    (True, "silu", False), (True, "gelu", True), (False, "gelu", False),
])
def test_fused_block_plain_matches_jax_kernel_and_ref(dtype, m, d, f, bm, bf,
                                                      gated, act, sandwich):
    xj, xt = both(rnd(0, (m, d)), dtype)
    sj, st = both(rnd(1, (d,), 0.1), "float32")
    pj, pt = both(rnd(5, (d,), 0.1), "float32")
    gj, gt = both(rnd(2, (d, f), d ** -0.5), dtype)
    uj, ut = both(rnd(3, (d, f), d ** -0.5), dtype)
    dj, dt = both(rnd(4, (f, d), f ** -0.5), dtype)
    kw = dict(act=act, gated=gated, sandwich=sandwich)
    got = fused_block_torch(xt, st, gt, ut, dt, pt, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (m, d)
    close(got, fused_block_ref(xj, sj, gj, uj, dj, pj, **kw), **TOL[dtype])
    close(got, jax_fused(xj, sj, gj, uj, dj, pj, block_m=bm, block_f=bf,
                         interpret=True, **kw), **TOL[dtype])


@pytest.mark.parametrize("gated,act,sandwich", [
    (True, "gelu", False), (True, "silu", True), (False, "gelu", False)])
def test_fused_block_plain_matches_model_mlp_apply(gated, act, sandwich):
    """In float32 the fused block and the JAX model's ``mlp_apply`` (which
    rounds nowhere) agree to 2e-5; through the port's ``mlp_apply``, on a
    [B, S, d] input, too."""
    from repro.configs import smoke_config
    from repro.models.layers import mlp_apply as jax_mlp

    from repro_torch.configs import smoke_config as port_smoke
    from repro_torch.models.layers import Params, mlp_apply, mlp_defs

    over = dict(act=act, mlp_gated=gated, sandwich_norm=sandwich)
    cfg = smoke_config("gemma2-2b").replace(**over)
    d, f = cfg.d_model, cfg.d_ff
    x = rnd(0, (2, 5, d))
    p = {"pre_norm": rnd(1, (d,), 0.1), "post_norm": rnd(5, (d,), 0.1),
         "w_gate": rnd(2, (d, f), d ** -0.5),
         "w_up": rnd(3, (d, f), d ** -0.5),
         "w_down": rnd(4, (f, d), f ** -0.5)}
    want = jax_mlp({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), cfg)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = fused_block_torch(torch.from_numpy(x.reshape(-1, d)),
                            pt["pre_norm"], pt["w_gate"], pt["w_up"],
                            pt["w_down"], pt["post_norm"], act=act,
                            gated=gated, sandwich=sandwich)
    close(got.reshape(x.shape), want, **TOL["float32"])
    port_cfg = port_smoke("gemma2-2b").replace(**over)
    mod = Params(mlp_defs(port_cfg), torch.float32, "cpu")
    mod.load_state_dict({k: pt[k] for k in mlp_defs(port_cfg)})
    close(mlp_apply(mod, torch.from_numpy(x), port_cfg), want,
          **TOL["float32"])


# ------------------------------------------------------------------- K9
@pytest.mark.parametrize("B,S,W,q,bw", [
    (2, 64, 32, 16, 32), (1, 128, 64, 64, 32), (3, 32, 16, 32, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_matches_jax_kernel_and_model_scan(B, S, W, q, bw, dtype):
    """Inputs rounded to ``dtype`` (the TPU kernel's test feeds bfloat16
    too); the port's scan runs in float32 on the same numbers."""
    aj, at = both(np.array(jax.nn.sigmoid(rnd(0, (B, S, W)))), dtype)
    bj, bt = both(rnd(1, (B, S, W)), dtype)
    got = rglru_scan_torch(at, bt)
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    close(got, jax_rglru_model(aj.astype(jnp.float32),
                               bj.astype(jnp.float32)), **SCAN_TOL)
    close(got, jax_rglru_kernel(aj.astype(jnp.float32),
                                bj.astype(jnp.float32), chunk=q,
                                block_w=bw, interpret=True), **SCAN_TOL)


def test_rglru_plain_is_the_sequential_recurrence():
    a = torch.tensor([[[0.5], [0.25], [2.0]]])
    b = torch.tensor([[[1.0], [2.0], [-1.0]]])
    h = rglru_scan_torch(a, b)
    assert h[0, :, 0].tolist() == [1.0, 2.25, 3.5]


# ------------------------------------------- K9's ring schedule, on the CPU
def ring_replay(a, b, plan):
    """``csrc/rglru_scan.cu`` as it runs, in numpy: block ``blk`` (one warp)
    owns channels ``c0 .. c0 + CHANNELS - 1`` of batch row ``bi``; its lanes
    issue each stage's copies (``stage_copies``) into ring slot ``stage %
    RING_STAGES``, ``RING_STAGES - 1`` stages ahead, a copy past S or W
    filling zeros; a stage lands when the wait leaves at most
    ``RING_STAGES - 1`` groups in flight; the chain lanes then run ``h =
    a h + b`` in float32 from the slot.  Asserts that no copy overwrites a
    slot before its stage was consumed and that a stage is consumed only
    after it landed.  Returns h and how often each element of a and b was
    copied."""
    from repro_torch.kernels.rglru_scan import (CHANNELS, RING_STAGES,
                                                STAGE_STEPS, WARP,
                                                stage_copies)
    B, S, W = a.shape
    K, T, cpw, vec = RING_STAGES, STAGE_STEPS, CHANNELS, plan.vec
    src = (a, b)
    h = np.full(a.shape, np.nan, dtype=np.float32)
    copied = np.zeros((2,) + a.shape, dtype=np.int64)
    copies = [stage_copies(plan, lane) for lane in range(WARP)]
    for blk in range(plan.blocks):
        bi, grp = divmod(blk, plan.groups_per_row)
        c0 = grp * cpw
        ring = np.full((K, 2, T, cpw), np.nan, dtype=np.float32)
        holds = [None] * K             # the stage each slot was last given
        groups = []                    # committed, not landed: (stage, writes)

        def issue(stage):
            assert holds[stage % K] is None, "slot overwritten unconsumed"
            holds[stage % K] = stage
            writes = []
            t0 = stage * T
            for lane in range(WARP):
                for arr, step, ch in copies[lane]:
                    ok = t0 + step < S and c0 + ch < W
                    if ok:
                        # a 16-byte copy lies wholly inside the row
                        assert c0 + ch + vec <= W
                        vals = src[arr][bi, t0 + step, c0 + ch:c0 + ch + vec]
                        copied[arr, bi, t0 + step, c0 + ch:c0 + ch + vec] += 1
                    else:
                        vals = np.zeros(vec, dtype=np.float32)
                    writes.append((stage % K, arr, step, ch, vals))
            return writes

        def land(keep):
            while len(groups) > keep:
                _, writes = groups.pop(0)
                for slot, arr, step, ch, vals in writes:
                    ring[slot, arr, step, ch:ch + vec] = vals

        for s in range(K - 1):
            groups.append((s, issue(s) if s < plan.stages else []))
        hv = np.zeros(cpw, dtype=np.float32)
        lanes = np.arange(cpw)
        chain = c0 + lanes < W
        for i in range(plan.stages):
            ahead = i + K - 1
            groups.append((ahead, issue(ahead) if ahead < plan.stages
                           else []))
            land(K - 1)
            assert all(st > i for st, _ in groups), "consumed before landing"
            assert holds[i % K] == i
            for s in range(T):
                t = i * T + s
                if t >= S:
                    break
                hv = ring[i % K, 0, s] * hv + ring[i % K, 1, s]
                h[bi, t, c0 + lanes[chain]] = hv[chain]
            holds[i % K] = None
    return h, copied


@pytest.mark.parametrize("B,S,W", [
    (2, 300, 40),       # more than the ring of 128 steps, ragged last stage
    (1, 5, 16),         # S shorter than a stage
    (2, 100, 20),       # S shorter than the ring; W ragged in 8 and 16
    (1, 130, 10),       # W not a multiple of 4: 4-byte copies
    (3, 17, 3),         # B * W below a warp
])
def test_rglru_ring_replay_is_the_plain_recurrence(B, S, W):
    """K9's schedule (channel groups, ring slots, stages ahead, masks) on
    the CPU: every element of a and b copied exactly once, and h equal
    bit for bit to the plain version."""
    from repro_torch.kernels.rglru_scan import rglru_scan_plan
    a = np.array(jax.nn.sigmoid(rnd(2, (B, S, W))))
    b = rnd(3, (B, S, W))
    plan = rglru_scan_plan(B, S, W)
    assert plan.vec == (4 if W % 4 == 0 else 1)
    h, copied = ring_replay(a, b, plan)
    assert (copied == 1).all()
    want = rglru_scan_torch(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(h.view(np.int32), want.numpy().view(np.int32))


def test_rglru_ring_replay_unaligned_and_against_jax():
    """Unaligned base pointers take 4-byte copies: the same h; and the
    replay within the JAX kernel's tolerance of its doubling scan."""
    from repro_torch.kernels.rglru_scan import rglru_scan_plan
    B, S, W = 2, 64, 32
    a = np.array(jax.nn.sigmoid(rnd(4, (B, S, W))))
    b = rnd(5, (B, S, W))
    plan = rglru_scan_plan(B, S, W, aligned=False)
    assert plan.vec == 1
    h, copied = ring_replay(a, b, plan)
    assert (copied == 1).all()
    h16, _ = ring_replay(a, b, rglru_scan_plan(B, S, W))
    assert np.array_equal(h.view(np.int32), h16.view(np.int32))
    close(h, jax_rglru_kernel(jnp.asarray(a), jnp.asarray(b), chunk=16,
                              block_w=32, interpret=True), **SCAN_TOL)


@pytest.mark.parametrize("B,S,W,aligned,vec,blocks,stages", [
    (2, 3072, 2560, True, 4, 320, 192),     # recurrentgemma-2b's serve
    (2, 3071, 2561, True, 1, 2 * 161, 192),
    (1, 5, 16, True, 4, 1, 1),
    (3, 17, 3, True, 1, 3, 2),
    (2, 3072, 2560, False, 1, 320, 192),
])
def test_rglru_scan_plan(B, S, W, aligned, vec, blocks, stages):
    """Every channel in exactly one warp's group, the ring within a block's
    227 KB of shared memory, 16-byte copies only on aligned rows."""
    from repro_torch.kernels.rglru_scan import (CHANNELS, RING_STAGES,
                                                STAGE_STEPS, rglru_scan_plan)
    plan = rglru_scan_plan(B, S, W, aligned=aligned)
    assert (plan.vec, plan.blocks, plan.stages) == (vec, blocks, stages)
    groups = plan.groups_per_row
    assert groups * CHANNELS >= W > (groups - 1) * CHANNELS
    assert plan.smem_bytes == RING_STAGES * 2 * STAGE_STEPS * CHANNELS * 4
    assert plan.smem_bytes <= 227 * 1024


# --------------------------------------------------------------- dispatch
def test_ops_dispatch_on_the_cpu_runs_the_plain_versions():
    q = torch.from_numpy(rnd(0, (1, 20, 2, 16)))
    k = torch.from_numpy(rnd(1, (1, 20, 1, 16)))
    x = torch.from_numpy(rnd(2, (6, 16)))
    s = torch.zeros(16)
    w1 = torch.from_numpy(rnd(3, (16, 24), 0.25))
    w2 = torch.from_numpy(rnd(4, (24, 16), 0.2))
    a = torch.sigmoid(torch.from_numpy(rnd(5, (2, 9, 4))))
    xs = torch.from_numpy(rnd(6, (1, 11, 2, 4)))
    dt = torch.sigmoid(torch.from_numpy(rnd(7, (1, 11, 2))))
    bc = torch.from_numpy(rnd(8, (1, 11, 1, 8)))
    ssd = (xs, dt, -dt[0, 0], bc, bc, dt[0, 1])
    before = {n: fn.launches for n, fn in kernel_wrappers().items()}
    for ctx in (torch.no_grad(), ops.plain_versions()):
        with ctx:
            assert torch.equal(ops.flash_attention(q, k, k, window=5),
                               flash_attention_torch(q, k, k, window=5))
            assert torch.equal(ops.fused_block(x, s, w1, w1, w2),
                               fused_block_torch(x, s, w1, w1, w2))
            assert torch.equal(ops.rglru_scan(a, a), rglru_scan_torch(a, a))
            got, want = ops.ssd_scan(*ssd, chunk=4), ssd_scan_torch(*ssd,
                                                                    chunk=4)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert not ops._PLAIN
    assert {n: fn.launches for n, fn in kernel_wrappers().items()} == before


@pytest.mark.parametrize("call", [
    lambda t: flash_attention_cuda(t((1, 8, 2, 16)), t((1, 8, 1, 16)),
                                   t((1, 8, 1, 16))),
    lambda t: fused_block_cuda(t((4, 16)), t((16,)), t((16, 8)), t((16, 8)),
                               t((8, 16))),
    lambda t: rglru_scan_cuda(t((1, 4, 8)), t((1, 4, 8))),
    lambda t: ssd_scan_cuda(t((1, 8, 2, 4)), t((1, 8, 2)), t((2,)),
                            t((1, 8, 1, 16)), t((1, 8, 1, 16)), t((2,)),
                            chunk=4),
], ids=["flash_attention", "fused_block", "rglru_scan", "ssd_scan"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: given CPU tensors it raises
    before building anything, and counts no launch of any variant."""
    from repro_torch.kernels import launch_counts_by_variant
    before = {n: fn.launches for n, fn in kernel_wrappers().items()}
    variants = launch_counts_by_variant()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(torch.zeros)
    assert {n: fn.launches for n, fn in kernel_wrappers().items()} == before
    assert launch_counts_by_variant() == variants
    assert _build._LIB is None


# ------------------------------------------------- variants and the build
SMS = 132                      # an H100 SXM's SMs


@pytest.mark.parametrize("dtype,m,d,f,aligned,want", [
    # the bfloat16 prefill of recurrentgemma-2b and gemma2's widths
    (torch.bfloat16, 6144, 2560, 7680, True, "tensor_core"),
    (torch.bfloat16, 300, 2304, 9216, True, "tensor_core"),
    (torch.bfloat16, 333, 200, 344, True, "tensor_core"),
    (torch.bfloat16, 64, 8, 8, True, "tensor_core"),
    # decode (M = batch) too
    (torch.bfloat16, 2, 2560, 7680, True, "tensor_core"),
    (torch.bfloat16, 1, 8, 8, True, "tensor_core"),
    # rows that 16-byte copies cannot take
    (torch.bfloat16, 6144, 2560, 7684, True, "simt"),
    (torch.bfloat16, 333, 200, 333, True, "simt_split"),
    (torch.bfloat16, 333, 204, 344, True, "simt_split"),
    (torch.bfloat16, 6144, 2560, 7680, False, "simt"),
    # float32 never takes the tensor cores (TF32)
    (torch.float32, 6144, 2560, 7680, True, "simt"),
    (torch.float32, 2048, 2560, 7680, True, "simt"),
    (torch.float32, 8 * SMS - 1, 2560, 7680, True, "simt"),
    (torch.float32, 8 * SMS - 7, 2560, 7680, True, "simt"),
    (torch.float32, 8 * SMS - 8, 2560, 7680, True, "simt_split"),
    (torch.float32, 2, 2560, 7680, True, "simt_split"),
    # rows wider than the SIMT row tiles hold: gemma2-27b (d 4,608) and
    # granite-20b (d 6,144) in float32, prefill and decode
    (torch.float32, 1024, 4608, 36864, True, "simt_wide"),
    (torch.float32, 2, 4608, 36864, True, "simt_wide"),
    (torch.float32, 1024, 6144, 24576, True, "simt_wide"),
    (torch.float32, 1, 2561, 100, True, "simt_wide"),
    (torch.bfloat16, 1024, 4609, 36864, True, "simt_wide"),
    (torch.bfloat16, 1024, 4608, 36864, False, "simt_wide"),
    # ... while aligned bfloat16 stays on the tensor cores at any width
    (torch.bfloat16, 1024, 4608, 36864, True, "tensor_core"),
    (torch.bfloat16, 2, 6144, 24576, True, "tensor_core"),
])
def test_fused_block_variant_rule(dtype, m, d, f, aligned, want):
    from repro_torch.kernels.fused_block import VARIANTS, fused_block_variant
    got = fused_block_variant(dtype, m, d, f, SMS, aligned=aligned)
    assert got == want and got in VARIANTS


@pytest.mark.parametrize("variant,m,f,want", [
    ("simt", 2048, 7680, (256, 1)),
    ("simt_split", 2, 7680, (64, 120)),       # F's 120 slabs cap the split
    ("simt_split", 37, 333, (64, 6)),
    ("simt_split", 3, 9216, (64, 144)),       # two blocks a SM
])
def test_fused_block_simt_slabs(variant, m, f, want):
    from repro_torch.kernels.fused_block import simt_slabs
    assert simt_slabs(variant, m, f, SMS) == want


@pytest.mark.parametrize("m,d,f,want", [
    (1024, 4608, 36864, 1),      # gemma2-27b prefill: 16 x 72 tiles of y
    (1024, 6144, 24576, 1),      # granite-20b prefill: 16 x 96
    (2, 4608, 36864, 4),         # gemma2-27b decode: 72 tiles, 4 splits
    (1, 6144, 24576, 3),         # 96 tiles
    (1, 2561, 20, 2),            # capped by F's 2 steps of 16
    (4096, 2561, 100, 1),
])
def test_fused_block_simt_wide_splits(m, d, f, want):
    """The wide path's split of F in its down product: one split when the
    tiles of y fill two blocks an SM, else enough to, at most one a K step
    of F; a pure function of the shape.  With the rule above, no width is
    refused before the launch any more (the kernel itself runs on the card,
    in ``chip_smoke.py``)."""
    from repro_torch.kernels.fused_block import simt_wide_splits
    assert simt_wide_splits(m, d, f, SMS) == want


def test_fused_block_plain_matches_jax_kernel_at_gemma2_27b_width():
    """The plain version against the JAX K7 (interpret mode) and its oracle
    at gemma2-27b's d 4,608 (gated gelu, sandwich norm), at a small M and
    F, in float32: the width the wide path exists for."""
    m, d, f = 8, 4608, 128
    xj, xt = both(rnd(0, (m, d)), "float32")
    sj, st = both(rnd(1, (d,), 0.1), "float32")
    pj, pt = both(rnd(5, (d,), 0.1), "float32")
    gj, gt = both(rnd(2, (d, f), d ** -0.5), "float32")
    uj, ut = both(rnd(3, (d, f), d ** -0.5), "float32")
    dj, dt = both(rnd(4, (f, d), f ** -0.5), "float32")
    kw = dict(act="gelu", gated=True, sandwich=True)
    got = fused_block_torch(xt, st, gt, ut, dt, pt, **kw)
    assert got.shape == (m, d)
    close(got, fused_block_ref(xj, sj, gj, uj, dj, pj, **kw),
          **TOL["float32"])
    close(got, jax_fused(xj, sj, gj, uj, dj, pj, block_m=8, block_f=128,
                         interpret=True, **kw), **TOL["float32"])


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    (torch.bfloat16, 256, True, "tensor_core"),
    (torch.bfloat16, 96, True, "tensor_core"),
    (torch.bfloat16, 16, True, "tensor_core"),
    (torch.bfloat16, 20, True, "simt"),
    (torch.bfloat16, 256, False, "simt"),
    (torch.float32, 256, True, "simt"),
    (torch.float32, 16, True, "simt"),
])
def test_flash_attention_variant_rule(dtype, hd, aligned, want):
    from repro_torch.kernels.flash_attention import (
        VARIANTS, flash_attention_variant)
    got = flash_attention_variant(dtype, hd, aligned=aligned)
    assert got == want and got in VARIANTS


REPO = Path(__file__).resolve().parents[1]


def _global_functions():
    pattern = re.compile(r"__global__\s+void\s+"
                         r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {path.name: pattern.findall(path.read_text())
            for path in sorted(_build.CSRC.glob("*.cu"))}


def test_every_kernel_is_named_in_the_trace_names():
    """chip_smoke.py sums each wrapper's device time over the trace entries
    that name one of its kernels: a __global__ function missing there would
    drop its time silently."""
    smoke = chip_smoke()
    names = {n for names in smoke.TRACE_NAMES.values() for n in names}
    found = _global_functions()
    for source, kernels in found.items():
        for kernel in kernels:
            assert kernel in names, f"{source}: {kernel}"
    # and no trace name is stale
    assert names == {k for kernels in found.values() for k in kernels}
    assert set(smoke.TRACE_NAMES) == set(kernel_wrappers())
    # no name is a substring of another wrapper's kernel
    for wrapper, own in smoke.TRACE_NAMES.items():
        for other, theirs in smoke.TRACE_NAMES.items():
            if other != wrapper:
                assert not any(a in b for a in own for b in theirs)


def test_every_cuda_source_is_built():
    sources = {p.name for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SOURCES)
    assert {"flash_attention_tc.cu", "fused_block_tc.cu",
            "ssd_scan_tc.cu"} <= sources
    assert (_build.CSRC / "tensor_core.cuh").exists()


def test_chip_smoke_names_each_variant_it_expects():
    from repro_torch.kernels.flash_attention import VARIANTS as FA
    from repro_torch.kernels.fused_block import VARIANTS as FB
    from repro_torch.kernels.ssd_scan import VARIANTS as SS
    smoke = chip_smoke()
    known = {"flash_attention": set(FA), "fused_block": set(FB),
             "ssd_scan": set(SS)}
    for arch, serve in {**smoke.LM_SERVES, **smoke.LM_CHECKS}.items():
        for key in ("launches_by_variant", "check_launches_by_variant"):
            total = "launches" if key == "launches_by_variant" else \
                "check_launches"
            for name, by_variant in serve.get(key, {}).items():
                assert set(by_variant) <= known[name], (arch, key)
                assert sum(by_variant.values()) == serve[total][name]
    rg = smoke.LM_SERVES["recurrentgemma-2b"]
    assert rg["launches_by_variant"]["flash_attention"] == {"tensor_core": 8}
    assert rg["check_launches_by_variant"]["fused_block"].get(
        "tensor_core", 0) == 0
    # gemma2-27b's float32 MLPs (d 4,608) take only the wide SIMT path
    g27 = smoke.LM_CHECKS["gemma2-27b"]
    assert g27["check_launches_by_variant"]["fused_block"] == {
        "simt_wide": g27["check_launches"]["fused_block"]}
    assert {arch for arch, _m in smoke.K7_WIDE} == {"gemma2-27b",
                                                     "granite-20b"}
    m2 = smoke.LM_SERVES["mamba2-2.7b"]
    assert m2["launches_by_variant"]["ssd_scan"] == {"tensor_core": 64}
    assert m2["check_launches_by_variant"]["ssd_scan"] == {"simt": 4}
    for name, info in smoke.KERNEL_INFO.items():
        for source in [info["source"], *info.get("variants", {}).values()]:
            assert (REPO / source).exists(), (name, source)


def test_per_variant_counts_start_at_zero_after_reset():
    from repro_torch.kernels import (launch_counts, launch_counts_by_variant,
                                     reset_launch_counts)
    flash_attention_cuda.launches_by_variant["tensor_core"] += 3
    fused_block_cuda.launches_by_variant["simt_split"] += 2
    fused_block_cuda.launches += 2
    ssd_scan_cuda.launches_by_variant["tensor_core"] += 1
    ssd_scan_cuda.launches += 1
    reset_launch_counts()
    by_variant = launch_counts_by_variant()
    assert set(by_variant) == {"flash_attention", "fused_block", "ssd_scan",
                               "score_batch"}
    assert all(n == 0 for v in by_variant.values() for n in v.values())
    assert all(n == 0 for n in launch_counts().values())
    assert set(by_variant["fused_block"]) == {"tensor_core", "simt",
                                              "simt_split", "simt_wide"}
    assert set(by_variant["ssd_scan"]) == {"tensor_core", "simt"}
    assert set(by_variant["score_batch"]) == {"thread", "split"}


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "simt")])
def test_ssd_scan_variant_rule(dtype, want):
    from repro_torch.kernels.ssd_scan import VARIANTS, ssd_scan_variant
    got = ssd_scan_variant(dtype)
    assert got == want and got in VARIANTS


def test_per_variant_counts_are_read_by_variant():
    """``launch_counts_by_variant`` reads each wrapper's own per-variant
    counter: what one variant counts shows under its name only."""
    from repro_torch.kernels import (launch_counts, launch_counts_by_variant,
                                     reset_launch_counts)
    reset_launch_counts()
    ssd_scan_cuda.launches_by_variant["tensor_core"] += 2
    ssd_scan_cuda.launches_by_variant["simt"] += 1
    ssd_scan_cuda.launches += 3
    assert launch_counts_by_variant()["ssd_scan"] == {"tensor_core": 2,
                                                      "simt": 1}
    assert launch_counts()["ssd_scan"] == 3
    assert launch_counts_by_variant()["fused_block"] == {
        "tensor_core": 0, "simt": 0, "simt_split": 0, "simt_wide": 0}
    reset_launch_counts()
    assert launch_counts_by_variant()["ssd_scan"] == {"tensor_core": 0,
                                                      "simt": 0}
