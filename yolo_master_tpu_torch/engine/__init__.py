"""Inference engine of the port."""
