"""Synthetic vector datasets and exact ground truth."""
