"""Losses: LPIPS for evaluation (``lpips.py``) and the training objectives
(``gan.py``, ``matching.py``, ``tv.py``, ``seg.py``, ``perceptual.py``)."""
