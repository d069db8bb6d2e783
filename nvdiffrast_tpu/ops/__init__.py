"""Differentiable rendering primitive ops."""
