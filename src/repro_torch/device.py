"""Where the port's entry points run: the card unless the caller says so.

Every entry point (``count_to_store``, ``count_list_scan_segment``,
``QueryEngine``, ``launch.cooc_serve.serve``) takes ``device="cuda"`` by
default and resolves it here. Without a CUDA device that default raises: the
port never carries on quietly on the host. ``device="cpu"`` runs the plain
PyTorch versions of the kernels, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device when none is available and ``ValueError`` for other device types.

    Example::

        resolve_device("cpu")      # device(type='cpu')
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path "
                "on the host"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; have 'cuda', 'cpu'")
    return dev
