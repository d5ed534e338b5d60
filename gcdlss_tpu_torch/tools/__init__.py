"""Measurement scripts for the port on a CUDA device."""
