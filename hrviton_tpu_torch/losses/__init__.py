"""Perceptual distances (LPIPS) for evaluation."""
