"""The one device a job runs on: the port's counterpart of
``avenir_tpu/parallel/mesh.py``.

The TPU package shards rows over a mesh of chips; the port runs on one
CUDA card, so the mesh reduces to a device and the shard padding to
``pad_rows`` with a multiple of 1.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


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


def pad_rows(arr: np.ndarray, multiple: int,
             fill=0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 to a multiple of ``multiple``; returns the padded array
    and a bool validity mask (False on the padding rows, which the count
    kernels drop)."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    mask = np.zeros(target, dtype=bool)
    mask[:n] = True
    if target == n:
        return arr, mask
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill), mask
