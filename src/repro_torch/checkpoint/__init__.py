"""Checkpoints of nested tensor/array trees, in the JAX package's format."""
