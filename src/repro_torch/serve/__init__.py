"""Serving: the batched engine with the coded LM head, and the
multi-tenant front door (``Router``) over coded fleet replicas."""

from .engine import Request, ServeEngine  # noqa: F401
from .router import (  # noqa: F401
    ENV_BALANCER,
    ENV_MAX_COLS,
    ENV_QUEUE_CAP,
    Router,
    default_balancer,
    default_max_cols,
    default_queue_cap,
)
