"""Models: the decoder-only `TransformerLM` and its decode loop, the MNIST
CNN, and the flax param converters."""
