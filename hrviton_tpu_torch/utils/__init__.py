"""Visualization and image saving (``utils/vis.py``), TensorBoard logging
(``logging.py``), the port's tracer of host and device spans
(``profiling.py``) and the reference's legacy helpers (``legacy.py``)."""
