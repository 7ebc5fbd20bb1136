"""Crash-atomic records on disk: the search pool's task journal
(``checkpoint.py``)."""
