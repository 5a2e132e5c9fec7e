"""metrics subpackage of the PyTorch port."""
