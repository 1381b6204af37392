"""Shared utilities of the PyTorch port (logging, retry, device)."""
