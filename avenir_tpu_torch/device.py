"""The one device a job runs on.

A job that takes a ``device`` runs on it; the multi-device engines take a
mesh of devices instead (``parallel/mesh.py``, which also holds
``pad_rows``, re-exported here for the callers that import it from this
module).
"""

from __future__ import annotations

from typing import Union

import torch

from .parallel.mesh import pad_rows  # noqa: F401


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``cuda:0`` when no device is asked for; the asked device otherwise.
    Raises when a CUDA device is needed and none is present: a job never
    carries on quietly on the CPU unless the caller asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but no CUDA device "
                               f"is available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev

