"""The search pool's runtime: deterministic fault injection (``chaos.py``)
and preemption / straggler handling (``fault_tolerance.py``)."""
