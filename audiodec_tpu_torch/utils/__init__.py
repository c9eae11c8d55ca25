"""Utilities: weights carried in from JAX and from the reference."""
