"""Models of the ported slices."""

from .mnist import MnistCNN, MnistMLP  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet,
    ResNet50,
    ResNet101,
    ResNet152,
    load_jax_params,
)
from .transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    gpt_small,
    gpt_tiny,
)
