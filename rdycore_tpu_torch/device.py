"""Where the package's entry points run.

`Simulation`, `build_operator` and the CLI run on the CUDA device unless the
caller asks for the CPU. Without a CUDA device they raise rather than carry
on on the CPU: the CPU runs the kernels' plain PyTorch versions, which is
what the tests want and never what a user who asked for the card wants.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device of an entry point: the current CUDA device when
    `device` is None, else `device` itself ("cpu", "cuda", "cuda:1", ...).
    Raises RuntimeError when CUDA is asked for (or implied) but absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or --cpu) "
                "to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is absent")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """A device's name for logs: the card's name for CUDA, 'cpu' else."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
