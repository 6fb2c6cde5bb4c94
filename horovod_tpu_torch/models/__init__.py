"""Models: the decoder-only `TransformerLM`, its decode loop and the flax
param converter."""
