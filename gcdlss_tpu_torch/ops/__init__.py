"""Coordinates, plan building and sparse-conv kernels of the PyTorch port."""
