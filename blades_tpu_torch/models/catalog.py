"""Model catalog (counterpart of ``blades_tpu/models/catalog.py``): a name,
matched by substring as in the reference ("resnet" -> ResNet-10, "mlp",
"cnn"), or an ``nn.Module`` instance, resolved to a module for a given
input shape.  The reference's deeper ResNets are named exactly and raise
until the port has them, so none of them falls through to ResNet-10."""

from __future__ import annotations

import math

from torch import nn

from blades_tpu_torch.models.cnn import FashionCNN
from blades_tpu_torch.models.mlp import MLP
from blades_tpu_torch.models.resnet import ResNet10, ResNet18

_RESNETS = {"resnet10": ResNet10, "resnet18": ResNet18}
# The reference's other exact names (blades_tpu/models/catalog.py:29-36):
# each builds its own network there, so here each raises rather than
# reaching the "resnet" substring rule.
_LATER_RESNETS = ("resnet34", "resnet50", "resnet101", "resnet152")


def get_model(spec, num_classes: int = 10, input_shape=(28, 28, 1)) -> nn.Module:
    """Resolve ``spec`` for NHWC inputs of ``input_shape``."""
    if isinstance(spec, nn.Module):
        return spec
    name = str(spec).lower()
    if name in _RESNETS:
        return _RESNETS[name](num_classes, input_shape[-1])
    if name in _LATER_RESNETS:
        raise NotImplementedError(
            f"model {spec!r} is not in the port yet (the Bottleneck ResNets "
            "and ResNet-34 come with ROADMAP Queue A 6)")
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
        f"model {spec!r} is not in the port yet (ResNet-10/18, the MLP and "
        "the CNN are)")
