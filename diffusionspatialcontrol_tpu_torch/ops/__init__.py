"""Attention and region-map ops."""
