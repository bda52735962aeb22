"""Data of the PyTorch port: LMDB crop files, the PIL-free image codec and transform, datasets, the incremental stream and the synthetic renderer."""
