from .pipeline import DataConfig, PrefetchIterator, SyntheticTokens, make_pipeline  # noqa: F401
