"""Optimizer: AdamW with schedules and global-norm clipping."""
