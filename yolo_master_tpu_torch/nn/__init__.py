"""Layers, heads and graph assembly of the port."""
