"""Device selection for the port's entry points."""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`cuda` unless the caller asks for another device. A CUDA device that
    is not available raises: there is no silent fallback to the CPU. Under
    torchrun (`LOCAL_RANK` set) the default is the rank's own card, made
    the current device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device is None and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev
