"""ops subpackage of the PyTorch port."""
