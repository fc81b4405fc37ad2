"""PyTorch/CUDA port of the M-AVG system (the JAX package ``repro`` is the
reference and stays beside it). Imports torch and numpy, never JAX."""
