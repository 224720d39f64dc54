"""Models of the ported slices."""

from .resnet import ResNet, ResNet50, load_jax_params  # noqa: F401
from .transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    gpt_small,
    gpt_tiny,
)
