"""group_ms: mean time a compile spends grouping (the graph's check and
``group_nodes``), from the program's spans
(``repro_torch/utils/tracing.py``): the seconds of ``compile.group`` over
the compiles of the traced window, in ms."""

SPANS = ("compile.group",)


def read(window):
    try:
        from repro_torch.utils.tracing import totals
    except ImportError:             # a program that marks no spans
        return None
    spans = totals()
    if not window.compiles_run or not any(n in spans for n in SPANS):
        return None
    seconds = sum(spans[n]["seconds"] for n in SPANS if n in spans)
    return 1e3 * seconds / window.compiles_run
