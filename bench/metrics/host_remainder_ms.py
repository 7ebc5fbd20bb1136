"""host_remainder_ms: mean time per compile in ``compile_graph`` outside
the search (grouping, the reports, the instructions), wall minus the
search's span (traced runs)."""


def read(window):
    if not window.searches or len(window.searches) != len(window.walls):
        return None
    rest = [w - s for w, s in zip(window.walls, window.searches)]
    return 1e3 * sum(rest) / len(rest)
