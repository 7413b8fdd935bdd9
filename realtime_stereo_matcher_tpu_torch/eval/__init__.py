"""Benchmark validators of the port (``eval/validators.py``)."""
