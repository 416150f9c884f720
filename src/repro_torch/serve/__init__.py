"""Serving: the batched engine with the coded LM head.  The router
front door waits for the cluster layer."""

from .engine import Request, ServeEngine  # noqa: F401
