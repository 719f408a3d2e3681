"""Evaluation of the port: pixel, Frechet, CLIP and depth metrics, and the InceptionV3 and
I3D feature networks of FID and FVD."""
