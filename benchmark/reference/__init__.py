"""Plain PyTorch and NumPy reference of what the benchmark's cells run: it
imports nothing of the program and takes nothing the program made."""
