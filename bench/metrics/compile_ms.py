"""compile_ms: all compile wall time in the window over the compiles
completed in it (host clock around each ``compile_graph`` call)."""


def read(window):
    if not window.walls:
        return None
    return 1e3 * sum(window.walls) / len(window.walls)
