"""LM serving: prefill and a batched generation engine."""
