"""Pipelines of the port."""
