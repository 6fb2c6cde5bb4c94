"""Models: the decoder-only `TransformerLM` and its decode loop, the
encoder-decoder `Seq2SeqTransformer`, LoRA adapters, the MNIST CNN, and
the flax param converters."""
