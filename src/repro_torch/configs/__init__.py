"""Architecture configs: one module per assigned arch + shape cells."""

from .base import SHAPES, AttnConfig, CodedConfig, EncoderConfig, LatentModelConfig, MLAConfig, ModelConfig, MoEConfig, ShapeConfig, SigmoidMoEConfig, SSMConfig  # noqa: F401
from .registry import ARCH_IDS, get_config, get_shape, get_smoke_config  # noqa: F401
