"""Operators of the port: attention dispatch, the CUDA kernels and their plain versions."""
