"""Per-architecture sharding plans: logical-axis -> mesh-axis rules plus
batch placement, derived from divisibility against the mesh.

The counterpart of the JAX package's ``launch/sharding.py``, rule for
rule.  A spec is a plain tuple with one entry a dimension: a mesh-axis
name, a tuple of names (the dimension spread over several axes), or None
(replicated) -- the entries of the JAX package's ``PartitionSpec``.
Parameter specs are keyed by the port's parameter names
(``Model.pspecs``), cache specs follow the cache's own structure.

Parallelism map:
  TP plan (default): heads/kv/ff/vocab -> 'model' where the dimension
    divides the axis; experts -> 'model' (EP); batch -> ('pod','data');
    'embed' -> 'data' (FSDP) when a replicated copy would not fit
    (``FSDP_THRESHOLD_BYTES`` of float32 parameters a model shard).
  HYBRID plan (head counts that the model axis does not divide and that
    are not attention-free, e.g. smollm's 15 heads on 16): the MLP and
    the vocabulary shard over 'model', attention runs batch-parallel,
    replicated over 'model'; no FSDP.

The 'pod' axis always carries pure data parallelism.  ``to_named`` has no
twin: what a mesh run holds on a rank is its shard as a plain tensor
(``launch/distributed.py``), not a ``DTensor``; :func:`shard_shape` gives
that shard's shape.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh

FSDP_THRESHOLD_BYTES = 1.5e9     # replicated fp32 params per model-shard


@dataclass(frozen=True)
class ShardingPlan:
    kind: str                     # 'tp' | 'hybrid'
    rules: dict
    batch_axis_pref: tuple        # candidate batch axis tuples, best first
    fsdp: bool

    def batch_spec(self, mesh: Mesh, global_batch: int) -> tuple:
        """The spec of the batch dimension: ``(axes,)`` (one name, or a
        tuple of several) for the first candidate of ``batch_axis_pref``
        on ``mesh`` whose shards divide ``global_batch``, else ``()``
        (replicated)."""
        avail = set(mesh.axis_names)
        for cand in self.batch_axis_pref:
            axes = tuple(a for a in cand if a in avail)
            if not axes:
                continue
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            if global_batch % n == 0:
                return (axes if len(axes) > 1 else axes[0],)
        return ()


def _div(n: int, k: int) -> bool:
    return n > 0 and n % k == 0


def make_plan(cfg: ModelConfig, mesh: Mesh) -> ShardingPlan:
    model_n = mesh.shape.get("model", 1)
    heads_ok = _div(cfg.n_heads, model_n)
    attn_free = cfg.family == "ssm"
    param_bytes = cfg.param_count() * 4

    if not heads_ok and not attn_free:
        rules = {"embed": None,
                 "vocab": "model" if _div(cfg.vocab, model_n) else None,
                 "heads": None, "kv": None,
                 "ff": "model" if _div(cfg.d_ff, model_n) else None,
                 "experts": None, "layers": None, None: None}
        return ShardingPlan(
            kind="hybrid", rules=rules,
            batch_axis_pref=(("pod", "data"), ("data",), ()),
            fsdp=False)

    fsdp = param_bytes / model_n > FSDP_THRESHOLD_BYTES
    rules = {
        "vocab": "model" if _div(cfg.vocab, model_n) else None,
        "heads": "model" if heads_ok or attn_free else None,
        "kv": "model" if _div(cfg.n_kv_heads, model_n) else None,
        "ff": "model",
        "experts": "model" if _div(cfg.n_experts, model_n) else None,
        "embed": "data" if fsdp else None,
        "layers": None,
        None: None,
    }
    return ShardingPlan(
        kind="tp", rules=rules,
        batch_axis_pref=(("pod", "data"), ("data",), ()),
        fsdp=fsdp)


def needs_fsdp(cfg: ModelConfig, mesh: Mesh) -> bool:
    return make_plan(cfg, mesh).fsdp


def force_fsdp(plan: ShardingPlan) -> ShardingPlan:
    """``plan`` with FSDP on whatever the model's size: the ``embed``
    axis over ``data`` (to run the gathers and reduce-scatters of a model
    that fits without them)."""
    return dataclasses.replace(plan, fsdp=True,
                               rules={**plan.rules, "embed": "data"})


def param_pspecs(model, mesh: Mesh, plan: ShardingPlan | None = None
                 ) -> dict:
    plan = plan or make_plan(model.cfg, mesh)
    return model.pspecs(plan.rules)


def batch_pspecs(model, mesh: Mesh, batch_spec: dict, global_batch: int,
                 plan: ShardingPlan | None = None) -> dict:
    """``{input name: spec}``: the batch dimension as ``batch_spec``
    places it, then one None for every dimension after the first (so a
    replicated batch's spec is one entry short, as the JAX package's)."""
    plan = plan or make_plan(model.cfg, mesh)
    bp = plan.batch_spec(mesh, global_batch)
    return {k: (*bp, *([None] * (len(v.shape) - 1)))
            for k, v in batch_spec.items()}


def cache_pspecs(cache, mesh: Mesh, global_batch: int,
                 plan: ShardingPlan):
    """The specs of a decode cache, in its structure (dicts and lists;
    a leaf is anything with a ``shape``, or a host number such as the
    port's ``pos``, whose spec is ``()``), by each leaf's name -- the key
    it sits under: ``k v ck cv`` (batch, sequence, kv heads, head dim),
    ``convx convbc conv`` (batch, taps, channels), ``ssd`` (batch, heads,
    head dim, state), ``h`` (batch, width).  A leaf under a ``groups`` key
    has a leading layers dimension (the JAX package's stacked groups; the
    port's caches are a list a layer and never stack)."""
    bp = plan.batch_spec(mesh, global_batch)
    b = bp[0] if len(bp) else None
    kv_ax = plan.rules.get("kv")
    ff_ax = plan.rules.get("ff")
    b_axes = set(b) if isinstance(b, tuple) else ({b} if b else set())
    model_n = mesh.shape.get("model", 1)

    def one(name, stacked, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        shape = tuple(leaf.shape)
        nd = len(shape)
        # When kv heads cannot shard on the model axis, shard the cache's
        # sequence dim instead (context-parallel cache); not when the
        # batch spec already takes the model axis or the length does not
        # divide.
        seq_len = shape[2] if nd >= 4 and name in (
            "k", "v", "ck", "cv") and nd == 5 else (
            shape[1] if nd >= 2 else 0)
        seq_ax = "model" if (kv_ax is None and "model" not in b_axes
                             and seq_len % model_n == 0) else None
        base = {"k": (b, seq_ax, kv_ax, None),
                "v": (b, seq_ax, kv_ax, None),
                "ck": (b, seq_ax, kv_ax, None),
                "cv": (b, seq_ax, kv_ax, None),
                "convx": (b, None, ff_ax),
                "convbc": (b, None, ff_ax),
                "conv": (b, None, ff_ax),
                "ssd": (b, ff_ax, None, None),
                "h": (b, ff_ax)}.get(name)
        if base is None:
            return (None,) * nd                   # pos etc.
        if stacked and nd == len(base) + 1:
            return (None, *base)
        if nd != len(base):
            raise ValueError(f"cache leaf {name!r} of shape {shape}: "
                             f"expected {len(base)} dims")
        return base

    def walk(node, name, stacked):
        if isinstance(node, dict):
            return {k: walk(v, k, stacked or k == "groups")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name, stacked) for v in node)
        return one(name, stacked, node)

    return walk(cache, None, False)


def hidden_batch_axes(plan: ShardingPlan, mesh: Mesh,
                      global_batch: int) -> tuple | None:
    bp = plan.batch_spec(mesh, global_batch)
    if len(bp) == 0:
        return None
    ax = bp[0]
    return ax if isinstance(ax, tuple) else (ax,)


def shard_shape(shape, spec: tuple, mesh: Mesh) -> tuple[int, ...]:
    """The shape of one shard of a ``shape`` array placed by ``spec`` on
    ``mesh`` (dimensions past the spec's end are replicated); a dimension
    its axes do not divide raises ``ValueError``, as the JAX package's
    ``NamedSharding.shard_shape`` does."""
    out = []
    for i, n in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        k = 1
        for a in (axes if isinstance(axes, tuple) else
                  () if axes is None else (axes,)):
            k *= mesh.shape[a]
        if n % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} ({n}) does "
                             f"not divide into {k} shards under {spec}")
        out.append(n // k)
    return tuple(out)
