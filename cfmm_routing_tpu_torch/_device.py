"""Device selection and host copies shared by the package's entry points."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "host"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks.

    ``None`` means the current CUDA device; without one this raises instead
    of continuing on the CPU.  Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def host(x) -> np.ndarray:
    """A numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
