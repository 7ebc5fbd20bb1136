"""Crash-atomic records on disk: the search pool's task journal and the
plan cache's codec helpers (``checkpoint.py``)."""
