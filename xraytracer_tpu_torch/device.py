"""Device resolution shared by every entry point that allocates.

The port runs on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and asking for CUDA on a machine without a card raises
instead of silently falling back (the tests pass ``device="cpu"``).
"""

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xraytracer_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
