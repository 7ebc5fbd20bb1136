"""Entry points of the LM substrate: the serving loop (``serve.py``), the
training loop (``train.py``) and its step (``steps.py``)."""
