"""The benchmark of the PyTorch and CUDA port (``miotts_tpu_torch``): see ``run.py``."""
