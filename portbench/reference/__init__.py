"""Plain PyTorch reference of the measured paths (imports nothing of the port)."""
