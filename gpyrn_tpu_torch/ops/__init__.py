"""Kernel, mean and linear-algebra operations of the port."""
