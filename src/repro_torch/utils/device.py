"""Device resolution: the card by default, the CPU only on request.

Every entry point of the port takes a ``device`` argument whose default
is ``"cuda"`` and passes it through ``resolve_device``. Without a CUDA
device that raises; nothing falls back to the CPU unless the caller
asks for ``device="cpu"`` (as the CPU tests do), where every kernel
dispatch runs its plain PyTorch version.

Resolving a CUDA device also turns TF32 off for matmuls and cuDNN: the
port is fp32 throughout, and the Gram's norm expansion
``|a|^2 + |b|^2 - 2 a.b`` cancels badly at TF32's 10-bit mantissa.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"`` / ``"cuda:1"`` / ``"cpu"`` / a ``torch.device`` ->
    a checked ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
