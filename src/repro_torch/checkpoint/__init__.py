"""Torn-write-safe checkpoints in the JAX package's layout."""
