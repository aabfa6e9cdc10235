"""Whole-scene fusion of the port (one GPU; multi-GPU comes later)."""
