"""Attention ops: the plain PyTorch references and the CUDA flash kernel."""
