"""Quantizer, likelihood, rank-R reconstruction, metrics and kernels."""
