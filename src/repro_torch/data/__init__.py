"""The LM data pipeline (``pipeline.py``), numpy only."""
