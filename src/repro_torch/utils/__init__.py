"""Host-side utilities of the port: the analytic cost model
(``costmodel.py``) and the compile path's spans and counters
(``tracing.py``)."""
