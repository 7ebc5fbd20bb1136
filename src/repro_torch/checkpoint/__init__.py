"""Crash-atomic records on disk: training checkpoints in the JAX package's
format, the search pool's task journal and the codec helpers
(``checkpoint.py``)."""
