"""The optimizer of the LM training path: AdamW (``adamw.py``) and int8
gradient compression with error feedback (``compression.py``)."""
