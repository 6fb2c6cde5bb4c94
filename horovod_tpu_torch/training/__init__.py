"""Training: the trainer core, its state and the distributed optimizer."""
