"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU. A
missing CUDA device is an error, never a silent fallback: a CPU run of a
program meant for the card would report host numbers as device numbers.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


class NoCudaDevice(RuntimeError):
    """Raised when an entry point needs the card and none is present."""


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device (raises :class:`NoCudaDevice` when
    there is none); anything else is taken as given (``"cpu"`` for tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(f"device {dev} requested but CUDA is unavailable")
    return dev


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
