from .adamw import AdamWConfig, apply_updates, init_state, schedule  # noqa: F401
from .compress import CompressionConfig, compress_tree, init_residual  # noqa: F401
