"""Command line of the PyTorch port (`python -m controlvar_tpu_torch.cli.main`)."""
