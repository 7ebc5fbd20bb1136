"""The port's benchmark (see ``bench/run.py``).  A package so that pytest
imports its ``conftest`` as ``bench.conftest``, apart from ``tests/``'s."""
