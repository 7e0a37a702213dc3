"""Framework iterators of the port (PyTorch)."""
