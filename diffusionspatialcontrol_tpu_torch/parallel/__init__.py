"""Data parallelism over ranks: the mesh (``mesh``), the explicit-SPMD
sampler (``spmd``) and multi-prompt grids on one device or a mesh
(``batched``)."""
