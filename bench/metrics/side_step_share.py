"""side_step_share: the share of the allocator replay's group steps that are
SE side steps (a squeeze or excite fc, or a classifier fc on the pooled
map: groups the allocator keeps off the frame buffers), from the program's
``alloc.side_steps`` counter (each chunk's side groups at or past its
shared prefix ``g0`` times its candidates,
``repro_torch/kernels/search_pipeline.py``) over every group step of the
traced window's compiles (``compiles_run`` x G x the candidates a compile
searches: an exhaustive compile searches the configuration's whole cut
space, whatever its chunk), in percent."""


def read(window):
    try:
        from repro_torch.utils.tracing import counters
    except ImportError:             # a program that counts nothing
        return None
    n = counters().get("alloc.side_steps")
    steps = (window.compiles_run * window.shape.get("groups", 0)
             * window.shape.get("space", 0))
    if n is None or not steps:
        return None
    return 100.0 * n / steps
