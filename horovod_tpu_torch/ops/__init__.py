"""Collectives and kernels of the PyTorch port."""
