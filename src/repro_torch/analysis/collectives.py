"""The collectives a step dispatches, counted as they are dispatched.

The counterpart of ``repro.analysis.hlo``.  The reference parses the
compiled XLA HLO, where each op is listed once even inside a ``while``
body, so it multiplies by loop trip counts.  Torch runs eagerly and has
no HLO: ``CollectiveCounter`` is a ``TorchDispatchMode`` that sees every
functional collective as it is issued (on each rank's local tensors,
under DTensor too), so every executed instance is counted once and loops
need no trip-count multiplication.

Returned bytes are the summed OUTPUT sizes of all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute ops, i.e. the payload
each rank receives per executed instance -- the quantity the collective
roofline term divides by link bandwidth (the reference's definition).
Torch's functional collectives have no collective-permute; its count
stays 0.
"""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective op (c10d_functional namespaces) -> kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional")


def _nbytes(out) -> int:
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return out.numel() * out.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Counts every functional collective dispatched while active.
    ``result()`` is the reference's dict: bytes per kind and
    ``counts``."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor  # noqa: PLC0415

        if any(issubclass(t, DTensor) for t in types):
            # let DTensor lower the op; its local ops come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        namespace = func.namespace
        name = func._schema.name.split("::")[-1].rstrip("_")
        kind = _KINDS.get(name) if namespace in _NAMESPACES else None
        if kind is not None:
            self.bytes[kind] += _nbytes(out)
            self.counts[kind] += 1
        return out

    def result(self) -> dict:
        res = {c: float(self.bytes[c]) for c in COLLECTIVES}
        res["counts"] = {c: int(self.counts[c]) for c in COLLECTIVES}
        return res
