"""Visualization and image saving (``utils/vis.py``), TensorBoard logging
(``logging.py``), profiling hooks (``profiling.py``) and the reference's
legacy helpers (``legacy.py``)."""
