"""Checkpointing for the training substrate."""
