"""Data of the PyTorch port (the synthetic renderer and its loader so far)."""
