"""Hand-written Hopper (sm_90a) kernels for the coded-computation hot spots.

Three CUDA C++ kernels (``csrc/``), each with a wrapper, a launch
counter and a plain PyTorch version beside it:

  * ``bcsr_matmul``   -- block-sparse worker product C = A^T B
  * ``cyclic_encode`` -- weight-omega encoding gather/accumulate
  * ``decode_matmul`` -- fastest-k decode U = Hinv @ Y

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel (built at first use by ``_build.library()``) or
raises.
"""

from .bcsr_matmul import bcsr_matmul, bcsr_matmul_plain  # noqa: F401
from .cyclic_encode import cyclic_encode, cyclic_encode_plain  # noqa: F401
from .decode_matmul import decode_matmul, decode_matmul_plain  # noqa: F401
from .ops import coded_worker_matmul, decode_unknowns, encode_submatrices  # noqa: F401
from .ref import pack_bcsr  # noqa: F401

KERNELS = (bcsr_matmul, cyclic_encode, decode_matmul)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    bcsr_matmul.narrow_launches = bcsr_matmul.wide_launches = 0
