"""Microbenchmarks of the port's hand-written kernels against their library counterparts."""
