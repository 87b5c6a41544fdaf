"""PyTorch device operations and the kernel wrappers."""
