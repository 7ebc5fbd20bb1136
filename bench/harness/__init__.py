"""The benchmark's harness: one cell, one run (``bench/run.py``)."""
