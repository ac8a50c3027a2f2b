"""ckpt of the PyTorch port."""
