"""Models of the port: configs, layers, CLIP vision tower, temporal VAE, SVD UNet."""
