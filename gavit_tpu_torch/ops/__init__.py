"""Ops: plain PyTorch versions and the Hopper kernel wrappers."""
