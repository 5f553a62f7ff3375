"""Operators of the port.  Kernel modules hold the wrapper, the plain
PyTorch version beside it, and a count of launches."""
