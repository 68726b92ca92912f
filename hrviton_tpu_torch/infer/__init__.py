"""Discriminator rejection and the offline evaluation metrics."""
