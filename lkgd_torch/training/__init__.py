"""Training of the port: EDM noise math, the SVD train step, the trainer loop."""
