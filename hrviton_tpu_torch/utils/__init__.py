"""Visualization and image saving (``utils/vis.py``)."""
