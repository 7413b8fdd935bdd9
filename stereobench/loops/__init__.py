"""Generators of the benchmark's traffic, one a kind of loop."""
