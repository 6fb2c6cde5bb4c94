"""The JAX package's entry scripts on the port's API: twins of
``examples/tf2_style_mnist.py``, ``tf1_style_mnist.py``,
``cifar10_resnet.py``, ``lm_generate.py``, ``lm_packed_pretraining.py``
and ``seq2seq_translation.py``."""
