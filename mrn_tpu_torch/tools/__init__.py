"""Offline tools of the PyTorch port."""
