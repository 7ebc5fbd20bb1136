"""The port's LM layers against the JAX package's, function by function:
``rms_norm``, RoPE, ``causal_conv``, the RG-LRU block (prefill and decode),
the attention sub-block (prefill, decode against a linear cache and against
a ring cache) and the KV cache's ``cache_update`` / ``ring_positions``.
Weights and inputs are made from a seed with numpy and handed to both
packages; float32 throughout, so the tolerances are float32 rounding
(stated per test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attn
import repro.models.layers as jax_layers
import repro.models.mamba2 as jax_mamba2
import repro.models.rglru as jax_rglru
import repro.models.transformer as jax_tf
from repro.configs import smoke_config

import repro_torch.models.attention as attn
import repro_torch.models.layers as layers
import repro_torch.models.mamba2 as mamba2
import repro_torch.models.rglru as rglru
import repro_torch.models.transformer as tf
from repro_torch.configs import smoke_config as port_smoke
import torch_parity

torch_parity.one_thread()

TOL = dict(rtol=2e-5, atol=2e-5)      # float32, a few ops deep
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)  # a whole sub-block with residual
# the JAX blocks jitted (the config and layer kind static), as its model
# runs them
jax_rglru_apply = jax.jit(jax_rglru.rglru_apply, static_argnums=(2,))
jax_attn_apply = jax.jit(jax_tf.attn_apply, static_argnums=(2, 3))


def rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def params_for(jax_defs, port_defs, seed):
    """The JAX package's parameters of ``jax_defs`` (its initializer, from
    a seeded key) as numpy, and a port ``Params`` of ``port_defs`` holding
    the same numbers."""
    tree = jax_layers.materialize(jax_defs, jax.random.key(seed))
    arrays = {k: np.asarray(v) for k, v in tree.items()}
    mod = layers.Params(port_defs, torch.float32, "cpu")
    mod.load_state_dict({k: t(v) for k, v in arrays.items()})
    return {k: jnp.asarray(v) for k, v in arrays.items()}, mod


# ------------------------------------------------------------ small pieces
def test_rms_norm():
    x, s = rnd(0, (3, 7, 48)), rnd(1, (48,), 0.1)
    close(layers.rms_norm(t(x), t(s)), jax_layers.rms_norm(x, s), **TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    pos = np.arange(5, 17)
    sin, cos = layers.rope_angles(torch.from_numpy(pos), 32, theta)
    jsin, jcos = jax_layers.rope_angles(jnp.asarray(pos), 32, theta)
    close(sin, jsin, **TOL)
    close(cos, jcos, **TOL)
    x = rnd(2, (2, 12, 3, 32))
    close(layers.apply_rope(t(x), sin, cos),
          jax_layers.apply_rope(x, jsin, jcos), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_and_softcap(act):
    x = rnd(3, (64,), 3.0)
    close(layers.act_fn(act)(t(x)), jax_layers.act_fn(act)(x), **TOL)
    close(layers.softcap(t(x), 5.0), jax_layers.softcap(x, 5.0), **TOL)


def test_embed_and_unembed():
    cfg = smoke_config("gemma2-2b")
    jp, mod = params_for(jax_layers.embed_defs(cfg),
                         layers.embed_defs(port_smoke("gemma2-2b")), 0)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9))
    x = layers.embed_lookup(mod, torch.from_numpy(tokens), cfg)
    close(x, jax_layers.embed_lookup(jp, jnp.asarray(tokens), cfg), **TOL)
    close(layers.unembed(mod, x, cfg),
          jax_layers.unembed(jp, jnp.asarray(x.numpy()), cfg), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    x, w, b = rnd(5, (2, 11, 24)), rnd(6, (4, 24)), rnd(7, (24,))
    state = rnd(8, (2, 3, 24)) if with_state else None
    y, ns = mamba2.causal_conv(t(x), t(w), t(b),
                               None if state is None else t(state))
    jy, jns = jax_mamba2.causal_conv(x, w, b, state)
    close(y, jy, **TOL)
    close(ns, jns, **TOL)


# --------------------------------------------------------------- RG-LRU
def test_rglru_apply_prefill_then_decode():
    """A prefill of 13 tokens (K9's plain version, from a zero state) and
    three O(1) decode steps carry the same state and output as the JAX
    block's associative scan."""
    cfg = smoke_config("recurrentgemma-2b")
    pcfg = port_smoke("recurrentgemma-2b")
    jp, mod = params_for(jax_rglru.rglru_defs(cfg), rglru.rglru_defs(pcfg), 1)
    x = rnd(9, (2, 13, cfg.d_model))
    st = rglru.init_rglru_state(pcfg, 2)
    jst = jax_rglru.init_rglru_state(cfg, 2)
    y, st = rglru.rglru_apply(mod, t(x), pcfg, state=st)
    jy, jst = jax_rglru_apply(jp, x, cfg, state=jst)
    close(y, jy, **BLOCK_TOL)
    close(st["h"], jst["h"], **BLOCK_TOL)
    close(st["conv"], jst["conv"], **BLOCK_TOL)
    for i in range(3):
        xd = rnd(20 + i, (2, 1, cfg.d_model))
        y, st = rglru.rglru_apply(mod, t(xd), pcfg, state=st)
        jy, jst = jax_rglru_apply(jp, xd, cfg, state=jst)
        close(y, jy, **BLOCK_TOL)
        close(st["h"], jst["h"], **BLOCK_TOL)


def test_rglru_scan_folds_the_initial_state():
    a = np.array(jax.nn.sigmoid(rnd(10, (2, 9, 8))))
    b, h0 = rnd(11, (2, 9, 8)), rnd(12, (2, 8))
    close(rglru.rglru_scan(t(a), t(b), h0=t(h0)),
          jax.jit(jax_rglru.rglru_scan)(jnp.asarray(a), jnp.asarray(b),
                                        h0=jnp.asarray(h0)), **BLOCK_TOL)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("arch,kind,max_seq,window", [
    ("smollm-360m", "global", 24, 0),          # linear cache
    ("gemma2-2b", "local", 24, 8),             # ring cache, window 8 < 20
    ("gemma2-2b", "global", 24, 8),            # softcap, sandwich, linear
    ("recurrentgemma-2b", "local", 24, 16),    # MQA-like, ring 16 < 24
])
def test_attn_apply_prefill_and_decode(arch, kind, max_seq, window):
    """Prefill 17 tokens into a fresh cache (K6's plain version), then three
    decode steps against the cache (ring: blocked attention over slot
    positions; linear: plain attention over the valid entries)."""
    cfg = smoke_config(arch).replace(max_seq=max_seq, window=window or 16)
    pcfg = port_smoke(arch).replace(max_seq=max_seq, window=window or 16)
    jp, mod = params_for(jax_tf.attn_defs(cfg, kind),
                         tf.attn_defs(pcfg, kind), 2)
    cache = tf.layer_cache(pcfg, kind, 2, max_seq, torch.float32)
    jcache = jax_tf.layer_cache(cfg, kind, 2, max_seq, jnp.float32)
    assert cache["k"].shape == jcache["k"].shape
    x = rnd(13, (2, 17, cfg.d_model))
    y, cache = tf.attn_apply(mod, t(x), pcfg, kind, cache=cache, pos=0)
    jy, jcache = jax_attn_apply(jp, x, cfg, kind, cache=jcache, pos=0)
    close(y, jy, **BLOCK_TOL)
    close(cache["k"], jcache["k"], **BLOCK_TOL)
    for i in range(3):
        xd = rnd(30 + i, (2, 1, cfg.d_model))
        y, cache = tf.attn_apply(mod, t(xd), pcfg, kind, cache=cache,
                                 pos=17 + i)
        jy, jcache = jax_attn_apply(jp, xd, cfg, kind, cache=jcache,
                                    pos=17 + i)
        close(y, jy, **BLOCK_TOL)
        close(cache["v"], jcache["v"], **BLOCK_TOL)


def test_attn_apply_without_cache_is_plain_attention():
    cfg = smoke_config("gemma2-2b")
    pcfg = port_smoke("gemma2-2b")
    jp, mod = params_for(jax_tf.attn_defs(cfg, "local"),
                         tf.attn_defs(pcfg, "local"), 3)
    x = rnd(14, (2, 20, cfg.d_model))
    y, _ = tf.attn_apply(mod, t(x), pcfg, "local", pos=0)
    jy, _ = jax_attn_apply(jp, x, cfg, "local", pos=0)
    close(y, jy, **BLOCK_TOL)


@pytest.mark.parametrize("ring,pos,s_new", [
    (False, 0, 5), (False, 7, 1), (True, 0, 5), (True, 6, 1), (True, 0, 11),
    (True, 9, 3)])
def test_cache_update(ring, pos, s_new):
    k0, v0 = rnd(15, (2, 8, 2, 4)), rnd(16, (2, 8, 2, 4))
    kn, vn = rnd(17, (2, s_new, 2, 4)), rnd(18, (2, s_new, 2, 4))
    got = attn.cache_update({"k": t(k0), "v": t(v0)}, t(kn), t(vn), pos,
                            ring=ring)
    want = jax_attn.cache_update({"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                 jnp.asarray(kn), jnp.asarray(vn), pos,
                                 ring=ring)
    close(got["k"], want["k"], rtol=0, atol=0)
    close(got["v"], want["v"], rtol=0, atol=0)


@pytest.mark.parametrize("pos", [0, 1, 5, 8, 9, 23])
def test_ring_positions(pos):
    assert attn.ring_positions(pos, 8).tolist() == np.asarray(
        jax_attn.ring_positions(pos, 8)).tolist()
