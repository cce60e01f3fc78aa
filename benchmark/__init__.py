"""The benchmark of the PyTorch and CUDA port, ``xraytracer_tpu_torch``."""
