"""data subpackage of the PyTorch port."""
