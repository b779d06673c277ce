"""Conic operators, their CUDA kernels, and the iterative solvers built on them."""
