"""Device helpers shared by every layer of the port.

The port's entry points run on the card unless the caller asks for the
CPU: a tensor operand brings its own device, anything else defaults to
``"cuda"``, and a CUDA device on a machine without one raises instead
of quietly running somewhere else.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The device a computation runs on.

    ``device`` wins when given; otherwise ``like``'s device when it is a
    tensor; otherwise ``"cuda"``.  Raises if that is a CUDA device and
    this process sees none.
    """
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass a CPU tensor or "
            "device='cpu' to run on the CPU")
    return dev


def is_hopper() -> bool:
    """True when the current CUDA device is an sm_90 (Hopper) card."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0))


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """``x`` (tensor or array-like) as a tensor on ``device``.

    A float64 host array becomes float32 unless ``dtype`` says
    otherwise, as ``jnp.asarray`` makes it in the reference.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if dtype is None and arr.dtype == np.float64:
        dtype = torch.float32
    return torch.as_tensor(arr, device=device, dtype=dtype)


def host_f32(a) -> np.ndarray:
    """An operand or a worker's array as a host f32 numpy array.  A CUDA
    tensor costs one device-to-host copy, which synchronises with the
    stream."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def host_mask(done) -> np.ndarray:
    """A done mask as a host bool array.  A CUDA mask costs one
    device-to-host copy, which synchronises with the stream."""
    if isinstance(done, torch.Tensor):
        return done.detach().to("cpu", torch.bool).numpy()
    return np.asarray(done, dtype=bool)
