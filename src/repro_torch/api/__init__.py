"""Public API: scheme registry + precompiled coded plans.

    from repro_torch.api import compile_plan, list_schemes

    plan = compile_plan(A, scheme="proposed", n=16, s=2)   # on the card
    y = plan.matvec(x, done=mask)

``schemes``  -- ``@register_scheme`` registry over the paper's family of
encodings (the reference's 14 names);
``backends`` -- automatic backend choice (``cuda`` on a CUDA device,
else the block-density pick);
``plan``     -- ``compile_plan`` -> ``CodedPlan`` with ``matvec`` /
``matmat`` / ``aggregate`` and a pre-warmed LRU decode cache;
``fleet``    -- ``CodedFleet`` shared-worker sessions: attach many
plans to one persistent worker set, submit rounds as ``CodedFuture``s
with in-flight pipelining and matvec microbatching.
"""

from .backends import (  # noqa: F401
    DEFAULT_DENSITY_CROSSOVER,
    block_zero_fraction,
    choose_backend,
    density_crossover,
)
from .fleet import (  # noqa: F401
    CodedFleet,
    CodedFuture,
    FleetDegraded,
    PlanHandle,
)
from .plan import CodedPlan, compile_plan  # noqa: F401
from .schemes import (  # noqa: F401
    SchemeInfo,
    list_schemes,
    make_scheme,
    register_scheme,
    scheme_info,
    scheme_names,
)
