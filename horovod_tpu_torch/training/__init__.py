"""Training: the trainer, its state, the distributed optimizer and the
callbacks."""
