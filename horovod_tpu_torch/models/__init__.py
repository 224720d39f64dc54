"""Models of the ported slice."""

from .resnet import ResNet, ResNet50, load_jax_params  # noqa: F401
