"""Compile-as-a-service: a long-lived daemon serving ExecutionPlans from
a persistent, content-addressed plan cache.

Public surface:

* :class:`~repro_torch.service.daemon.CompileService` -- the daemon (bounded
  request queue, coalescing, warm-started misses, per-ticket timing).
* :class:`~repro_torch.service.cache.PlanCache` -- the on-disk store (atomic
  msgpack+zstd or msgpack+zlib records, digest-verified, schema-versioned,
  LRU-bounded), the JAX package's record layout.
* :func:`~repro_torch.service.canonical.request_key` /
  :func:`~repro_torch.service.canonical.graph_fingerprint` -- deterministic
  request hashing (insertion-order- and PYTHONHASHSEED-independent).
* :func:`~repro_torch.service.codec.encode_plan` /
  :func:`~repro_torch.service.codec.decode_plan` -- the ExecutionPlan codec
  behind the byte-identity contract.
* :mod:`~repro_torch.service.packing` -- msgpack's wire format in the
  standard library (``packb`` / ``unpackb``): the machine with the GPU has
  no msgpack package.

A miss compiles on the GPU unless its options say ``device="cpu"``.  The
JAX package's ``docs/architecture.md`` ("Compile service") has the design.
"""
from repro_torch.service.cache import PlanCache
from repro_torch.service.canonical import (CACHE_SCHEMA_VERSION,
                                           canonical_graph,
                                           graph_fingerprint, hw_signature,
                                           request_key)
from repro_torch.service.codec import (PlanCodecError, decode_plan,
                                       encode_plan)
from repro_torch.service.daemon import (CompileService, ServiceClosed,
                                        ServiceOverloaded, Ticket)

__all__ = [
    "CACHE_SCHEMA_VERSION", "CompileService", "PlanCache",
    "PlanCodecError", "ServiceClosed", "ServiceOverloaded", "Ticket",
    "canonical_graph", "decode_plan", "encode_plan", "graph_fingerprint",
    "hw_signature", "request_key",
]
