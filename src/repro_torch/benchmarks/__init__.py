"""Runners of the paper-claim benchmarks on the port (the JAX package's
root ``benchmarks/`` keeps its own; this package imports none of it)."""
