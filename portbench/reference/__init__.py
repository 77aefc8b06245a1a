"""The plain reference of the benchmark: (k,e)-frequencies by brute force.

Imports torch and numpy only, never the port, JAX or the JAX package.
"""
