"""Device selection: ``cuda`` by default, the CPU only when asked for.

There is no "cuda if available else cpu" anywhere in the port: an entry
point left at its default on a machine without a CUDA device raises, so a
run can never report host numbers under a device's name.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device`` (a string or torch.device).

    Raises RuntimeError when a CUDA device is asked for (the default) and
    none is present; pass ``device="cpu"`` to run on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch: device='cuda' requested but no CUDA device "
            "is available (pass device='cpu' explicitly to run on the host)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
