"""Public wrappers for the kernels package.

They take host arrays or tensors, put them on ``device`` (default: the
card; ``device="cpu"`` runs the plain versions, as the reference's
``interpret=True`` runs the Pallas bodies off-TPU) and call the kernel
wrappers.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from .bcsr_matmul import bcsr_matmul
from .cyclic_encode import cyclic_encode
from .decode_matmul import decode_matmul
from .ref import pack_bcsr


def coded_worker_matmul(a_dense, b, *, bk: int = 32, bm: int = 32,
                        device=None) -> torch.Tensor:
    """Worker-side C = A^T B for a block-sparse coded submatrix A.

    Packs A on the host (the edge server does this once when
    dispatching the coded task), then runs the block-skipping kernel.
    """
    dev = resolve_device(device, a_dense)
    a_np = (a_dense.detach().cpu().numpy() if isinstance(a_dense, torch.Tensor)
            else np.asarray(a_dense))
    a_data, a_idx, _ = pack_bcsr(a_np, bk, bm)
    return bcsr_matmul(as_tensor(a_data, dev), as_tensor(a_idx, dev),
                       as_tensor(b, dev).contiguous())


def encode_submatrices(blocks, sup, coef, *, device=None) -> torch.Tensor:
    """Server-side encoding of stacked block-columns (Alg. 1/2)."""
    dev = resolve_device(device, blocks)
    return cyclic_encode(as_tensor(blocks, dev).contiguous(),
                         as_tensor(sup, dev, torch.int32).contiguous(),
                         as_tensor(coef, dev, torch.float32).contiguous())


def decode_unknowns(hinv, y, *, device=None) -> torch.Tensor:
    """Server-side decode U = Hinv @ Y for a fixed straggler pattern."""
    dev = resolve_device(device, y)
    return decode_matmul(as_tensor(hinv, dev, torch.float32).contiguous(),
                         as_tensor(y, dev).contiguous())
