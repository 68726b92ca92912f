"""Layers with the JAX package's semantics."""
