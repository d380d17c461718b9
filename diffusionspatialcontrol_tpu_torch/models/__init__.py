"""Model definitions: layers, CLIP text encoder, UNet, VAE decoder."""
