"""Device resolution: ``"cuda"`` means the card, and never silently the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the ``torch.device`` for ``device``.

    ``"cuda"`` (the default of every entry point) raises when no CUDA device
    is present; the CPU runs only when a caller asks for ``"cpu"``, which is
    what the tests do to reach the kernels' plain twins.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
