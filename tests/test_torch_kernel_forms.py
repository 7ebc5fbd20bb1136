"""The two forms the model axis adds to the LM kernels, in their plain
versions, against the JAX package on the CPU:

* K6 with a query offset (``q_offset``: query ``i`` at position
  ``q_offset + i``, keys from 0), the context-parallel slice of
  ``cp_attention``: against the JAX model's ``blocked_attention(q_offset=)``
  and, slice by slice, against the whole prefill;
* K7's partial sum (``partial=True``: the float32 ``h @ Wd`` of an F
  slice, no residual, no post-norm): the slices' partial sums, added, then
  the sandwich norm and the residual, against the JAX package's
  ``fused_block_ref``.

Both run through their operators and ``autograd.Function``s (float64
``gradcheck``); the CUDA wrappers refuse CPU tensors in the new forms as
in the old, and the per-form launch counts start at 0 after a reset.  The
CUDA forms are held against these plain versions on the card
(``chip_smoke.py``, phase 2).  Inputs are made from a seed with numpy;
float32 tolerance 2e-5, as ``test_torch_lm_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from repro.kernels.ref import fused_block_ref
from repro.models.attention import blocked_attention as jax_blocked
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)
from repro_torch.kernels.fused_block import (fused_block_cuda,
                                             fused_block_torch)
from repro_torch.models.layers import rms_norm

torch_parity.one_thread()

TOL = dict(rtol=2e-5, atol=2e-5)


def rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


# ------------------------------------------------------------------- K6
@pytest.mark.parametrize("offset,window,s,t", [
    (0, 0, 16, 16), (8, 0, 8, 16), (24, 0, 24, 48), (24, 10, 24, 48),
    (37, 5, 11, 48), (5, 0, 40, 45)])
def test_flash_q_offset_plain_matches_jax_blocked_attention(offset, window,
                                                            s, t):
    q, k, v = rnd(1, (2, s, 4, 16)), rnd(2, (2, t, 2, 16)), rnd(3,
                                                               (2, t, 2, 16))
    got = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window,
                                q_offset=offset)
    close(got, jax_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_offset=offset, causal=True, window=window))


@pytest.mark.parametrize("n,window", [(2, 0), (4, 0), (4, 7)])
def test_flash_q_offset_slices_are_the_whole_prefill(n, window):
    """``cp_attention``'s decomposition: slice ``i`` of the queries from
    offset ``i * S / n`` against every key, concatenated, is the prefill."""
    q, k, v = (torch.from_numpy(rnd(i, (1, 32, 2, 8))) for i in (4, 5, 6))
    whole = flash_attention_torch(q, k, v, window=window)
    c = 32 // n
    parts = [ops.flash_attention(q[:, i * c:(i + 1) * c], k, v,
                                 window=window, q_offset=i * c)
             for i in range(n)]
    close(torch.cat(parts, dim=1), whole)


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("gated,act,sandwich", [
    (True, "silu", False), (True, "gelu", True), (False, "gelu", False)])
def test_fused_block_partial_slices_sum_to_the_jax_block(splits, gated, act,
                                                         sandwich):
    m, d, f = 24, 32, 64
    x, s, post = rnd(0, (m, d)), rnd(1, (d,), 0.1), rnd(5, (d,), 0.1)
    wg, wu = rnd(2, (d, f), d ** -0.5), rnd(3, (d, f), d ** -0.5)
    wd = rnd(4, (f, d), f ** -0.5)
    kw = dict(act=act, gated=gated, sandwich=sandwich)
    want = fused_block_ref(*(jnp.asarray(a) for a in (x, s, wg, wu, wd,
                                                      post)), **kw)
    t = {n: torch.from_numpy(a) for n, a in dict(
        x=x, s=s, wg=wg, wu=wu, wd=wd, post=post).items()}
    c = f // splits
    parts = [fused_block_torch(t["x"], t["s"], t["wg"][:, i * c:(i + 1) * c],
                               t["wu"][:, i * c:(i + 1) * c],
                               t["wd"][i * c:(i + 1) * c], t["post"],
                               partial=True, **kw)
             for i in range(splits)]
    assert all(p.dtype == torch.float32 and p.shape == (m, d) for p in parts)
    y = sum(parts[1:], parts[0])
    if sandwich:
        y = rms_norm(y, t["post"])
    close(t["x"] + y, want)


def test_fused_block_partial_operator_and_gradient():
    """``ops.fused_block(partial=True)`` is the plain version on the CPU,
    and its ``autograd.Function`` passes ``gradcheck`` in float64 (the
    backward differentiates ``mlp_unfused(partial=True)``; the plain
    version computes in float32 inside, so eps 1e-3, rtol 1e-2 and atol
    1e-3, as ``test_torch_train.py``'s)."""
    gen = torch.Generator().manual_seed(0)
    f64 = torch.float64
    x, s = (torch.randn(5, 6, dtype=f64, generator=gen),
            0.1 * torch.randn(6, dtype=f64, generator=gen))
    wg, wu, wd = (torch.randn(a, b, dtype=f64, generator=gen) * 0.3
                  for a, b in ((6, 8), (6, 8), (8, 6)))
    kw = dict(act="gelu", gated=True)
    got = ops.fused_block(x, s, wg, wu, wd, None, partial=True, **kw)
    assert torch.equal(got, fused_block_torch(x, s, wg, wu, wd, partial=True,
                                              **kw))
    ins = [t.clone().requires_grad_() for t in (x, s, wg, wu, wd)]
    assert torch.autograd.gradcheck(
        lambda *a: ops.fused_block(*a, None, partial=True, **kw), ins,
        eps=1e-3, atol=1e-3, rtol=1e-2)


def test_flash_q_offset_operator_gradient():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, n, 2, 4, dtype=torch.float64, generator=gen
                           ).requires_grad_() for n in (3, 7, 7))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention(a, b, c, window=3, q_offset=4),
        (q, k, v), eps=1e-3, atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("call", ["flash_attention", "fused_block"])
def test_cuda_wrappers_refuse_cpu_tensors_in_the_new_forms(call):
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "flash_attention":
            q = torch.zeros(1, 4, 2, 8)
            flash_attention_cuda(q, q, q, q_offset=4)
        else:
            w = torch.zeros(8, 16)
            fused_block_cuda(x, torch.zeros(8), w, w, w.t().contiguous(),
                             partial=True)


def test_per_form_counts_start_at_zero_after_reset():
    from repro_torch.kernels import launch_counts_by_form, reset_launch_counts
    flash_attention_cuda.launches_by_form["q_offset"] += 2
    fused_block_cuda.launches_by_form["partial"] += 3
    assert launch_counts_by_form() == {"flash_attention": {"q_offset": 2},
                                       "fused_block": {"partial": 3}}
    reset_launch_counts()
    assert launch_counts_by_form() == {"flash_attention": {"q_offset": 0},
                                       "fused_block": {"partial": 0}}
