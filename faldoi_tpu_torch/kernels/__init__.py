"""The hand-written CUDA kernels: ``build`` compiles, loads and counts them."""
