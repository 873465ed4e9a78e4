"""Device choice and numeric precision for every entry point of the port.

The JAX reference runs in float32 throughout (no x64).  Its float32
convolutions and matrix products are full float32, so the port turns
TF32 off for both cuDNN convolutions and CUDA matrix products wherever a
device is chosen: with TF32 on, PyTorch's float32 convolutions keep only
about three decimal digits.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  Raises when CUDA is asked for (or implied)
    and absent: the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev

