"""Scoring across several devices (``parallel/sharded.py``)."""
