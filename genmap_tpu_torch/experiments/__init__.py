"""Measurement harnesses of the port (ports of `benchmarks/`)."""
