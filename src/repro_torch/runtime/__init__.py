"""The search pool's and the training loop's runtime: deterministic fault
injection (``chaos.py``), preemption / straggler handling and restart
(``fault_tolerance.py``)."""
