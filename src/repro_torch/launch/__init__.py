"""Drivers of the LM substrate: the serving loop (``serve.py``)."""
