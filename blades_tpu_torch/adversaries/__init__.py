"""Adversaries: the update-forging attacks of the port (ALIE, IPM, Noise,
Adaptive, MinMax, SignGuard, Lazy, Attackclippedclustering), the campaign
attacks scheduled over the async engine's virtual ticks (DiurnalALIE,
LazyRamp), the training-corruption attacks (LabelFlip, SignFlip) and the
gossip round's per-receiver wrapper (TopologyAttack)."""

import inspect

from blades_tpu_torch.adversaries.base import (  # noqa: F401
    Adversary,
    benign_mean_std,
    make_malicious_mask,
)
from blades_tpu_torch.adversaries.campaigns import (  # noqa: F401
    DiurnalALIECampaign,
    LazyRampCampaign,
)
from blades_tpu_torch.adversaries.topology_attacks import (  # noqa: F401
    TopologyAttackAdversary,
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
    "DiurnalALIE": DiurnalALIECampaign,
    "LazyRamp": LazyRampCampaign,
    "TopologyAttack": TopologyAttackAdversary,
}
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
    cls = ADVERSARIES.get(name) or _ALIASES.get(name)
    if cls is None:
        raise KeyError(f"unknown adversary {name!r}; known: "
                       f"{sorted(ADVERSARIES)}")
    accepted = set(inspect.signature(cls).parameters)
    for k, v in context.items():
        if k in accepted and k not in spec:
            spec[k] = v
    return cls(**spec)
