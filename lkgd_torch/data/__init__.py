"""Data of the port: video and image IO, the training datasets and loaders, the tensor
cache and the random masks of mask-conditioned training."""
