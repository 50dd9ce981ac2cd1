"""Training: AdamW, checkpoints, elastic restore plans and the trainer."""
