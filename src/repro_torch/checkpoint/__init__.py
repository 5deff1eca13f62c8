"""Atomic checkpoints of a training state."""
