"""Device choice for the port's entry points.

Every function that creates tensors takes ``device=``.  Left at None it means
the card: the port is built for CUDA, and a silent CPU run would hide a
missing card behind numbers from the wrong device.  Passing ``device="cpu"``
(what the tests do) runs the same code on the plain PyTorch versions.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "device_kind", "DeviceLike"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, as ``cuda:N`` so that it compares
    equal to a tensor's ``.device``; raises RuntimeError when CUDA is asked
    for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_NAMES: dict = {}


def device_kind(device: DeviceLike = None) -> str:
    """The namespace of measured data (tuned tiles, calibrations) for
    ``device`` (None: CUDA when there is a card, else the CPU):
    ``cuda|<card name>`` or ``cpu``.  Numbers taken on one card never rank
    or pick for another.  A kind given as ``device`` is returned as it is."""
    if isinstance(device, str) and "|" in device:
        return device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _NAMES:  # asking CUDA costs far more than the dict
        _NAMES[idx] = torch.cuda.get_device_name(idx)
    return f"cuda|{_NAMES[idx]}"
