"""Collectives over `torch.distributed` and world-size helpers."""
