"""Datasets of the port (the label list and the synthetic dataset)."""
