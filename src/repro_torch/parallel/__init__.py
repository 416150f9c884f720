"""Distribution: meshes, sharding rules, coded layers, collectives."""

from .coded_grads import CodedAggregator  # noqa: F401
from .coded_layer import CodedLinear  # noqa: F401
from .ctx import activation_sharding, ep_context, expert_parallel, shard  # noqa: F401
from .sharding import (  # noqa: F401
    batch_shardings,
    cache_shardings,
    dp_axes,
    make_activation_sharder,
    param_shardings,
    replicated,
    zero1_shardings,
)
