"""train subpackage of the PyTorch port."""
