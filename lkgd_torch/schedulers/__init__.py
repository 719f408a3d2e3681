"""Samplers of the port."""
