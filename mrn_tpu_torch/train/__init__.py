"""Training: optimizer, step and learners of the PyTorch port."""
