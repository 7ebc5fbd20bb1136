"""uploads_per_compile: host-to-device copies a compile makes of the
search's tables, from the program's ``pipeline.uploads`` counter
(``repro_torch/utils/tracing.py``) over the compiles of the traced window."""


def read(window):
    try:
        from repro_torch.utils.tracing import counters
    except ImportError:             # a program that counts no uploads
        return None
    n = counters().get("pipeline.uploads")
    if not n or not window.compiles_run:
        return None
    return n / window.compiles_run
