"""Runtime: the sparsity-aware coded execution engine.

A weight-omega encoding guarantees each coded shard mixes only
``omega`` of the ``k_A`` source block-columns, so a worker's nonzero
tiles -- and hence its work -- scale with ``omega / k_A`` of the dense
cost.  The executor realises that scaling end to end:

  * ``pack``         -- coded shards -> packed block-sparse (a_data, a_idx)
    operands; only nonzero tiles are stored or multiplied.
  * ``decode_cache`` -- per-straggler-pattern decode plans (cached k x k
    inverse), so repeated applies under the same ``done`` mask never
    re-run a solve.
  * ``executor``     -- ``CodedExecutor`` with ``reference`` / ``packed``
    / ``cuda`` backends.

Force a backend with the ``REPRO_CODED_BACKEND`` environment variable or
pass ``backend=``; the device default is ``cuda`` for an operand on a
CUDA device and ``reference`` elsewhere.
"""

from .decode_cache import DecodeCache, DecodePlan  # noqa: F401
from .executor import (  # noqa: F401
    BACKENDS,
    ENV_BACKEND,
    CodedExecutor,
    encode_blocks,
    merge_unknowns,
    resolve_backend,
    support_tables,
    tracks_grad,
)
from .pack import (  # noqa: F401
    PackedShards,
    bsr_shards,
    pack_coded_blocks,
    unpack_coded_blocks,
)
