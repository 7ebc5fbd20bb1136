"""search_ms: mean time in ``core/cutpoint.py::search`` per compile, from
the harness's spans around the compiler's call into it (traced runs)."""


def read(window):
    if not window.searches:
        return None
    return 1e3 * sum(window.searches) / len(window.searches)
