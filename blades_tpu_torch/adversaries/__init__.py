"""Adversaries: the update-forging attacks of the port (ALIE, IPM, Noise,
Adaptive, MinMax, SignGuard, Lazy, Attackclippedclustering) and the
training-corruption attacks (LabelFlip, SignFlip)."""

import inspect

from blades_tpu_torch.adversaries.base import (  # noqa: F401
    Adversary,
    benign_mean_std,
    make_malicious_mask,
)
from blades_tpu_torch.adversaries.training_attacks import (  # noqa: F401
    LabelFlipAdversary,
    SignFlipAdversary,
)
from blades_tpu_torch.adversaries.update_attacks import (  # noqa: F401
    AdaptiveAdversary,
    ALIEAdversary,
    AttackclippedclusteringAdversary,
    IPMAdversary,
    LazyAdversary,
    MinMaxAdversary,
    NoiseAdversary,
    SignGuardAdversary,
)

ADVERSARIES = {
    "ALIE": ALIEAdversary,
    "IPM": IPMAdversary,
    "LabelFlip": LabelFlipAdversary,
    "SignFlip": SignFlipAdversary,
    "Noise": NoiseAdversary,
    "Adaptive": AdaptiveAdversary,
    "MinMax": MinMaxAdversary,
    "SignGuard": SignGuardAdversary,
    "Attackclippedclustering": AttackclippedclusteringAdversary,
    "Lazy": LazyAdversary,
}
# The reference's adversaries the port does not have yet, by either name.
_LATER = {"DiurnalALIE", "LazyRamp", "TopologyAttack",
          "DiurnalALIECampaign", "LazyRampCampaign",
          "TopologyAttackAdversary"}
_ALIASES = {cls.__name__: cls for cls in ADVERSARIES.values()}


def get_adversary(spec, **context) -> Adversary:
    """Resolve a name / ``{"type": ..., **kwargs}`` / instance (a dotted
    reference-style path resolves by its last part); ``context`` supplies
    build-time knowledge (``num_clients``, ``num_byzantine``,
    ``num_classes``) where the attack's constructor takes it."""
    if spec is None:
        return None
    if isinstance(spec, Adversary):
        return spec
    if isinstance(spec, str):
        spec = {"type": spec}
    spec = dict(spec)
    name = spec.pop("type").rsplit(".", 1)[-1]
    if name in _LATER:
        raise NotImplementedError(
            f"{name} is not in the port yet (a later slice)")
    cls = ADVERSARIES.get(name) or _ALIASES.get(name)
    if cls is None:
        raise KeyError(f"unknown adversary {name!r}; known: "
                       f"{sorted(ADVERSARIES)}")
    accepted = set(inspect.signature(cls).parameters)
    for k, v in context.items():
        if k in accepted and k not in spec:
            spec[k] = v
    return cls(**spec)
