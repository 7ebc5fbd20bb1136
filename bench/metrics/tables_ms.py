"""tables_ms: mean time a compile spends building the search's tables
(blocks, runs, the engine's host tables) and packing and uploading the
pipeline's, the allocator's and the sub-space's, from the program's spans
(``repro_torch/utils/tracing.py``): the seconds of ``search.engine`` and
``pipeline.tables`` over the compiles of the traced window, in ms."""

SPANS = ("search.engine", "pipeline.tables")


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
