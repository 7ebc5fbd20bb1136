"""Host-side utilities of the port: the analytic cost model
(``costmodel.py``)."""
