"""Device choice for the port's entry points."""

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    current CUDA device. Raises when no device was named and CUDA is not
    available: the port never drops to the CPU on its own (the CPU path
    runs the kernels' plain PyTorch versions, which only a caller that
    asks for ``device="cpu"`` gets)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
