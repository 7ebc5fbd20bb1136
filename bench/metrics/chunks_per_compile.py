"""chunks_per_compile: K3 (``cost_rows``) launches per compile, from the
program's launch counters: one a chunk of the fused search pipeline."""


def read(window):
    n = window.launches.get("cost_rows", 0)
    if not n or not window.compiles_run:
        return None
    return n / window.compiles_run
