"""End-to-end demos of the port, run as modules: ``python -m
diffusionspatialcontrol_tpu_torch.examples.spatial_control_demo`` and
``... .controlnet_hires_demo``."""
