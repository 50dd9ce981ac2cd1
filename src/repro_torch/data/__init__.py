"""Synthetic vector datasets and exact ground truth (``vectors``), and the
seeded batches of the model families (``synthetic``)."""
