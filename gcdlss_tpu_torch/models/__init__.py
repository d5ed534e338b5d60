"""Sparse layers and the MinkUNet family of the PyTorch port."""
