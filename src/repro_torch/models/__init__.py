"""Model zoo: unified LM covering dense / moe / ssm / hybrid / vlm / audio."""

from .api import (  # noqa: F401
    build_model,
    decode_specs,
    prefill_specs,
    supports_shape,
    train_batch_specs,
)
from .transformer import TransformerLM, join_caches  # noqa: F401
from .whisper import WhisperLM  # noqa: F401
