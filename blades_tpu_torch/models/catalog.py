"""Model catalog (counterpart of ``blades_tpu/models/catalog.py``): resolves
a model spec for NHWC inputs of a given shape to an ``nn.Module``.

A spec is an ``nn.Module`` (returned as is), a callable (called with no
arguments), or a name, tried in the JAX package's order: a name given to
:func:`register_model`, then the ResNets (``resnet10`` ... ``resnet152``)
and the CCT / CVT variants (``cct_2_3x2_32`` ... , exact names), then by
substring as in the reference ("cct" -> ``cct_2_3x2_32``, "resnet" ->
ResNet-10, "mlp", "cnn").  ``num_classes=None`` keeps each builder's own
default, so ``cct_7_3x1_32_c100`` keeps its 100 classes.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Dict

from torch import nn

from blades_tpu_torch.models.cct import VARIANTS as _CCT_VARIANTS
from blades_tpu_torch.models.cct import cct_2_3x2_32
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

_CUSTOM: Dict[str, Callable[..., nn.Module]] = {}

_RESNETS = {"resnet10": ResNet10, "resnet18": ResNet18, "resnet34": ResNet34,
            "resnet50": ResNet50, "resnet101": ResNet101,
            "resnet152": ResNet152}


def register_model(name: str, builder: Callable[..., nn.Module]) -> None:
    """Register a custom model builder under ``name`` (matched
    case-insensitively, before every built-in name).  The builder is
    called with ``num_classes`` when one is given, and with
    ``input_shape`` when its signature takes that argument."""
    _CUSTOM[name.lower()] = builder


def _takes(builder, arg: str) -> bool:
    try:
        params = inspect.signature(builder).parameters
    except (TypeError, ValueError):
        return False
    return arg in params or any(p.kind is p.VAR_KEYWORD
                                for p in params.values())


def get_model(spec, num_classes=None, input_shape=(28, 28, 1)) -> nn.Module:
    """Resolve ``spec`` for NHWC inputs of ``input_shape``."""
    if isinstance(spec, nn.Module):
        return spec
    if callable(spec) and not isinstance(spec, str):
        return spec()
    kw = {} if num_classes is None else {"num_classes": num_classes}
    name = str(spec).lower()
    if name in _CUSTOM:
        builder = _CUSTOM[name]
        if _takes(builder, "input_shape"):
            kw["input_shape"] = tuple(input_shape)
        return builder(**kw)
    if name in _RESNETS:
        return _RESNETS[name](**kw, in_channels=input_shape[-1])
    if name in _CCT_VARIANTS:
        return _CCT_VARIANTS[name](**kw, input_shape=tuple(input_shape))
    if "cct" in name:
        return cct_2_3x2_32(**kw, input_shape=tuple(input_shape))
    if "resnet" in name:
        return ResNet10(**kw, in_channels=input_shape[-1])
    if "mlp" in name:
        return MLP(math.prod(input_shape), **kw)
    if "cnn" in name:
        return FashionCNN(**kw, in_channels=input_shape[-1],
                          input_hw=input_shape[:2])
    raise KeyError(f"unknown model {spec!r}")
