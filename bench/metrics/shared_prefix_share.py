"""shared_prefix_share: the share of the allocator replay's group steps
that K1 runs once a chunk instead of once a candidate, from the program's
``alloc.shared_prefix_steps`` counter (each chunk's shared prefix ``g0``
times its candidates, ``repro_torch/kernels/search_pipeline.py``) over
every group step of the traced window's compiles (``compiles_run`` x G x
the candidates of the window's chunks), in percent."""


def read(window):
    try:
        from repro_torch.utils.tracing import counters
    except ImportError:             # a program that counts nothing
        return None
    n = counters().get("alloc.shared_prefix_steps")
    steps = (window.compiles_run * window.shape.get("groups", 0)
             * sum(window.chunks))
    if n is None or not steps:
        return None
    return 100.0 * n / steps
