"""eval of the PyTorch port."""
