"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell,
a model configuration under a traffic mix, run once by ``run.py``."""
