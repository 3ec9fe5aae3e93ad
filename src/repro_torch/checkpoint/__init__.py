"""Checkpointing (checkpoint/ckpt.py)."""
