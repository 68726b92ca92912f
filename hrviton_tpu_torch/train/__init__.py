"""Checkpoint reading (``train/checkpoint.py``); the trainers are not ported
yet."""
