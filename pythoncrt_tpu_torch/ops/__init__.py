"""Plain PyTorch ops: the CPU path and each kernel's twin."""
