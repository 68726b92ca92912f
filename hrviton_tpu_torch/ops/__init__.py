"""Primitive ops of the try-on path (NHWC public functions)."""
