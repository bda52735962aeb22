"""Incremental-learning strategies of the PyTorch port (MRN so far)."""
