"""Models of the port — plain functions over parameter dicts of tensors
(``init(seed, ..., device) -> params`` and ``apply(params, x, ...)``) in
the JAX package's layouts (NHWC images, HWIO conv kernels, ``(in, out)``
dense kernels), each with its ``SHARDING_RULES`` table.

The names below are JAX's (``models/__init__.py:19-31``)."""
from torchbooster_tpu_torch.models import layers
from torchbooster_tpu_torch.models.lenet import LeNet
from torchbooster_tpu_torch.models.resnet import ResNet
from torchbooster_tpu_torch.models.vae import VAE
from torchbooster_tpu_torch.models.gan import GAN
from torchbooster_tpu_torch.models.vgg import VGGFeatures
from torchbooster_tpu_torch.models.stylenet import StyleNet
from torchbooster_tpu_torch.models.gpt import GPT
from torchbooster_tpu_torch.models.unet import UNet

__all__ = [
    "GAN", "GPT", "LeNet", "ResNet", "StyleNet", "UNet", "VAE",
    "VGGFeatures", "layers",
]
