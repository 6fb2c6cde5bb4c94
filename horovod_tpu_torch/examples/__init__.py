"""The reference MNIST entry scripts on the port's API (twins of
``examples/tf2_style_mnist.py`` and ``examples/tf1_style_mnist.py``)."""
