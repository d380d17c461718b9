"""Introspection of a generation: DAAM cross-attention heatmaps."""
