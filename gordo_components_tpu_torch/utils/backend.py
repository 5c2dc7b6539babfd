"""Device resolution: the one place that decides where the port runs.

The port runs on the card. ``device=None`` means ``cuda``; a machine
without one raises instead of quietly scoring on the CPU. The CPU is taken
only when a caller asks for it by name (the CPU tests do, and so does the
plain-path comparison in ``chip_smoke.py``).

Float32 on the card is full float32: TF32 is switched off for matrix
products and for cuDNN, so a served score does not depend on a library
default (TF32 keeps about three decimal digits).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; anything on CUDA requires
    a visible card. Raises ``RuntimeError`` rather than falling back."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gordo_components_tpu_torch runs on a CUDA device, and none "
                "is available; pass device='cpu' to run the plain path on "
                "the CPU explicitly"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif resolved.type != "cpu":
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    return resolved
