"""Entry points of the PyTorch port, run as
``python -m horovod_tpu_torch.examples.<name>``: twins of the JAX package's
``examples/synthetic_benchmark.py`` and ``examples/mnist.py``."""
