"""Multi-prompt grids (one device; meshes wait for multi-GPU)."""
