"""The device the port's entry points build on."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; the CUDA card when it is None. Raises
    when no card is present: the port runs on the card unless the caller
    asks for the CPU (``device="cpu"``, which runs every kernel's plain
    version)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card by default; pass "
            "device='cpu' to run it on the CPU with the kernels' plain "
            "versions")
    return torch.device("cuda")
