"""Precision policy (``core/precision.py``)."""
