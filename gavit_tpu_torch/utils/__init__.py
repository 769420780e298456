"""Utilities: the weight bridge."""
