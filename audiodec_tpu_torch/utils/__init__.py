"""Utilities: configs, checkpoints, and weights carried in from JAX and from
the reference."""
