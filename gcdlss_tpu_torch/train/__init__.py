"""Training steps and host orchestration of the PyTorch port."""
