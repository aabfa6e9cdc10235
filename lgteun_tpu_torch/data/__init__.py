"""Eval data pipeline of the port (numpy)."""
