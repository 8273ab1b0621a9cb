"""Sharding rules and the pipeline schedule of the port."""
