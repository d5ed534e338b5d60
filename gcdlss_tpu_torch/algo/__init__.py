"""Stage-2 discovery algorithms of the PyTorch port: k-means, Hungarian, queue."""
