"""Models of the port — plain functions over parameter dicts of tensors
(``init(seed, ..., device) -> params`` and ``apply(params, x, ...)``) in
the JAX package's layouts (NHWC images, HWIO conv kernels, ``(in, out)``
dense kernels), each with its ``SHARDING_RULES`` table.

The names below are JAX's (``models/__init__.py:19-31``) but for the
generative and style family (``VAE``, ``GAN``, ``StyleNet``, ``UNet``),
which is not ported yet."""
from torchbooster_tpu_torch.models import layers
from torchbooster_tpu_torch.models.gpt import GPT
from torchbooster_tpu_torch.models.lenet import LeNet
from torchbooster_tpu_torch.models.resnet import ResNet
from torchbooster_tpu_torch.models.vgg import VGGFeatures

__all__ = ["GPT", "LeNet", "ResNet", "VGGFeatures", "layers"]
