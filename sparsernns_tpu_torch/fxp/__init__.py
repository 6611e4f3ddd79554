"""Helpers shared with the fixed-point derivation (``derive.py``)."""
