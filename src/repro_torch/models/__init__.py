"""Model zoo: the dense decoder-only LM (other families raise
``NotImplementedError`` until they are ported)."""

from .api import (  # noqa: F401
    build_model,
    decode_specs,
    prefill_specs,
    supports_shape,
    train_batch_specs,
)
from .transformer import TransformerLM  # noqa: F401
