"""Model catalog (counterpart of ``blades_tpu/models/catalog.py``): a name,
matched exactly for the ResNets (``resnet10`` ... ``resnet152``), else by
substring as in the reference ("resnet" -> ResNet-10, "mlp", "cnn"), or an
``nn.Module`` instance, resolved to a module for a given input shape."""

from __future__ import annotations

import math

from torch import nn

from blades_tpu_torch.models.cnn import FashionCNN
from blades_tpu_torch.models.mlp import MLP
from blades_tpu_torch.models.resnet import (
    ResNet10,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

_RESNETS = {"resnet10": ResNet10, "resnet18": ResNet18, "resnet34": ResNet34,
            "resnet50": ResNet50, "resnet101": ResNet101,
            "resnet152": ResNet152}


def get_model(spec, num_classes: int = 10, input_shape=(28, 28, 1)) -> nn.Module:
    """Resolve ``spec`` for NHWC inputs of ``input_shape``."""
    if isinstance(spec, nn.Module):
        return spec
    name = str(spec).lower()
    if name in _RESNETS:
        return _RESNETS[name](num_classes, input_shape[-1])
    if "cct" in name:
        raise NotImplementedError(
            f"model {spec!r} is not in the port yet (CCT comes with a later "
            "slice)")
    if "resnet" in name:
        return ResNet10(num_classes, input_shape[-1])
    if "mlp" in name:
        return MLP(math.prod(input_shape), num_classes=num_classes)
    if "cnn" in name:
        return FashionCNN(num_classes, input_shape[-1], input_shape[:2])
    raise NotImplementedError(
        f"model {spec!r} is not in the port yet (the ResNets, the MLP and "
        "the CNN are)")
