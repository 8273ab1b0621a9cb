"""Optimizers of the port: AdamW (`optim.adamw`)."""
