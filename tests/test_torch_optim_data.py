"""The training path's host-side modules in the port against the JAX
package: the data pipeline (``data/pipeline.py``, byte for byte), AdamW
(``optim/adamw.py``: the schedule, one update, clipping; float32, rtol
1e-6) and the int8 gradient compression (``optim/compression.py``: codes
and scales equal, the carried error within 1 ulp).  Inputs are made from a
seed with numpy and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression

from repro_torch.data import pipeline
from repro_torch.optim import adamw, compression
import torch_parity

torch_parity.one_thread()

RTOL = 1e-6


def rnd(seed, shape, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(
        shape), dtype=np.float32)


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("host", [0, 1])
def test_synthetic_batches_are_the_jax_packages_bytes(seed, host):
    kw = dict(seq_len=33, global_batch=8, vocab=49152, seed=seed, n_hosts=2,
              host_id=host)
    mine = pipeline.SyntheticSource(pipeline.DataConfig(**kw))
    ref = jax_pipeline.SyntheticSource(jax_pipeline.DataConfig(**kw))
    for step in (0, 1, 7):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes(), (step, k)


def test_bin_token_source_is_the_jax_packages(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 2**32, 5000, dtype=np.uint32
                                      ).tofile(path)
    kw = dict(seq_len=15, global_batch=4, vocab=1000, path=str(path),
              n_hosts=2, host_id=1)
    mine = pipeline.BinTokenSource(pipeline.DataConfig(**kw))
    ref = jax_pipeline.BinTokenSource(jax_pipeline.DataConfig(**kw))
    assert mine.n_batches == ref.n_batches
    for step in (0, 1, mine.n_batches, mine.n_batches + 3):
        got, want = mine.batch_at(step), ref.batch_at(step)
        for k in got:
            assert got[k].tobytes() == want[k].tobytes(), (step, k)


def test_fast_forward_resumes_the_stream():
    cfg = pipeline.DataConfig(seq_len=9, global_batch=2, vocab=512, seed=4)
    pipe = pipeline.Pipeline(cfg)
    pipe.fast_forward(5)
    try:
        it = iter(pipe)
        for step in (5, 6, 7):
            got = next(it)
            want = pipeline.SyntheticSource(cfg).batch_at(step)
            assert all(np.array_equal(got[k], want[k]) for k in want)
        assert pipe.step == 8
        with pytest.raises(RuntimeError, match="after iteration"):
            pipe.fast_forward(0)
    finally:
        pipe.close()


def test_pipeline_rejects_bad_configs(tmp_path):
    with pytest.raises(ValueError, match="multiple"):
        _ = pipeline.DataConfig(seq_len=4, global_batch=3, vocab=9,
                                n_hosts=2).host_batch
    path = tmp_path / "short.bin"
    np.zeros(5, np.uint32).tofile(path)
    with pytest.raises(ValueError, match="too small"):
        pipeline.BinTokenSource(pipeline.DataConfig(
            seq_len=8, global_batch=2, vocab=9, path=str(path)))


# ------------------------------------------------------------------ AdamW
OPT = dict(lr=6e-4, warmup_steps=4, total_steps=12)


@pytest.mark.parametrize("kw", [OPT, {}, dict(warmup_steps=0, total_steps=3,
                                             min_lr_frac=0.0)])
def test_schedule_matches_jax(kw):
    mine, ref = adamw.AdamWConfig(**kw), jax_adamw.AdamWConfig(**kw)
    for step in (0, 1, 3, 4, 7, 12):
        want = float(jax_adamw.schedule(ref, jnp.int32(step)))
        assert adamw.schedule(mine, step) == pytest.approx(want, rel=RTOL)


def random_tree(seed, grad_scale=0.01):
    """{name: (param, grad, m, v)} of a few shapes, as float32 numpy."""
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2), "d": ()}
    out = {}
    for i, (n, s) in enumerate(shapes.items()):
        out[n] = (rnd(seed + 4 * i, s), rnd(seed + 4 * i + 1, s, grad_scale),
                  rnd(seed + 4 * i + 2, s, 0.01),
                  np.asarray(np.abs(rnd(seed + 4 * i + 3, s, 1e-4))))
    return out


@pytest.mark.parametrize("grad_scale,step", [(0.01, 0), (0.01, 5),
                                             (30.0, 2)])
def test_one_update_matches_jax(grad_scale, step):
    """One update from a state at ``step``: the parameters, m, v and the
    metrics within rtol 1e-6 (and, for an element that cancels, 1e-6 of
    its tensor's largest magnitude: XLA may fuse ``b1 m + (1 - b1) g``
    into one rounding).  Gradients of norm ~30 x the clip (1.0) must be
    clipped on both sides."""
    tree = random_tree(11, grad_scale)
    params = {n: torch.from_numpy(v[0].copy()) for n, v in tree.items()}
    grads = {n: torch.from_numpy(v[1]) for n, v in tree.items()}
    state = {"m": {n: torch.from_numpy(v[2].copy()) for n, v in tree.items()},
             "v": {n: torch.from_numpy(v[3].copy()) for n, v in tree.items()},
             "step": step}
    cfg = adamw.AdamWConfig(**OPT)
    got = adamw.adamw_update(cfg, params, grads, state)
    jp = {n: jnp.asarray(v[0]) for n, v in tree.items()}
    jg = {n: jnp.asarray(v[1]) for n, v in tree.items()}
    jstate = {"m": {n: jnp.asarray(v[2]) for n, v in tree.items()},
              "v": {n: jnp.asarray(v[3]) for n, v in tree.items()},
              "step": jnp.int32(step)}
    new_p, new_state, want = jax_adamw.adamw_update(
        jax_adamw.AdamWConfig(**OPT), jp, jg, jstate)
    assert state["step"] == int(new_state["step"]) == step + 1
    for k in ("grad_norm", "lr"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL)
    clipped = float(want["grad_norm"]) > cfg.clip_norm
    assert clipped == (grad_scale > 1)
    for n in tree:
        for got_t, want_t in ((params[n], new_p[n]),
                              (state["m"][n], new_state["m"][n]),
                              (state["v"][n], new_state["v"][n])):
            want_t = np.asarray(want_t)
            np.testing.assert_allclose(
                got_t.numpy(), want_t, rtol=RTOL,
                atol=RTOL * float(np.abs(want_t).max()))


def test_init_opt_state_and_global_norm():
    params = {"w": torch.ones(3, 2), "b": torch.full((4,), 2.0)}
    state = adamw.init_opt_state(params)
    assert state["step"] == 0
    for k in ("m", "v"):
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in state[k].values())
    assert float(adamw.global_norm(params.values())) == pytest.approx(
        float(jax_adamw.global_norm({"w": jnp.ones((3, 2)),
                                     "b": jnp.full((4,), 2.0)})), rel=RTOL)


# ------------------------------------------------------------ compression
def test_compress_matches_jax():
    grads = {"a": rnd(0, (40, 9)), "b": rnd(1, (17,), 1e-3),
             "c": np.zeros((3,), np.float32)}
    error = {"a": rnd(2, (40, 9), 1e-3), "b": rnd(3, (17,), 1e-5),
             "c": np.zeros((3,), np.float32)}
    q, s, e = compression.compress(
        {n: torch.from_numpy(g) for n, g in grads.items()},
        {n: torch.from_numpy(x) for n, x in error.items()})
    jq, js, je = jax_compression.compress(
        {n: jnp.asarray(g) for n, g in grads.items()},
        {n: jnp.asarray(x) for n, x in error.items()})
    for n in grads:
        assert q[n].dtype == torch.int8
        assert np.array_equal(q[n].numpy(), np.asarray(jq[n]))
        assert float(s[n]) == float(js[n])
        ulp = np.spacing(np.abs(np.asarray(je[n]))).max()
        assert np.abs(e[n].numpy() - np.asarray(je[n])).max() <= ulp
    back = compression.decompress(q, s)
    jback = jax_compression.decompress(jq, js)
    for n in grads:
        np.testing.assert_array_equal(back[n].numpy(), np.asarray(jback[n]))


def test_error_feedback_state_and_psum():
    """The error state; ``compressed_psum`` needs a process group, so it
    is held to the JAX package's across ranks
    (``test_torch_mesh_reference.py``)."""
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16)}
    err = compression.init_error_state(params)
    assert err["w"].dtype == torch.float32 and not err["w"].any()
