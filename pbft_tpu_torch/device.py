"""Device selection for every entry point of the port, in one place.

``None`` means the card: the port runs on CUDA unless its caller asks for
the CPU by name (as the tests do). Nothing falls back to the CPU on its own:
a machine without CUDA raises instead of silently running the plain path.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); ``"cpu"`` or a
    ``torch.device`` -> that device, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
