"""Kernels of the port and their wrappers."""
