"""Datasets and the input pipeline of the port (numpy only)."""
