"""Fluent algorithm config (counterpart of
``blades_tpu/algorithms/config.py``), for the fields that reach the dense
and streamed rounds.

The reference's builder surface -- ``.data() .training() .client()
.adversary() .evaluation() .resources()`` each returning ``self``, a dict
shim (``__getitem__`` / ``get`` / ``items`` / ``update_from_dict`` with the
reference's nested ``dataset_config`` / ``client_config`` /
``server_config`` keys), ``validate()`` and ``freeze()`` before
``build()``.  A field of the reference's config that the port does not
have yet (codecs, faults, async, meshes, ...) raises
``NotImplementedError`` naming it when it is set to anything but the
reference's default; an unknown key raises ``KeyError``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

from blades_tpu_torch.adversaries import get_adversary
from blades_tpu_torch.core.callbacks import ClippingCallback, get_callback
from blades_tpu_torch.core.round import FedRound
from blades_tpu_torch.core.server import Server
from blades_tpu_torch.core.task import TaskSpec

_INPUT_SHAPES = {
    "mnist": (28, 28, 1),
    "fashionmnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "cifar100": (32, 32, 3),
}
_NUM_CLASSES = {"mnist": 10, "fashionmnist": 10, "cifar10": 10, "cifar100": 100}

# The port's fields and their defaults (the reference's).
_FIELDS = {
    "dataset": "mnist", "num_clients": 10, "iid": True,
    "dirichlet_alpha": 0.1, "seed": 122,
    "global_model": "mlp", "num_classes": 10, "input_shape": None,
    "client_lr": 0.1, "client_momentum": 0.0, "num_batch_per_round": 1,
    "train_batch_size": 32,
    # Benign gradient clipping and the client callback chain ({"type":
    # ...} specs), composed before the adversary's hooks.
    "clip_gradient_norm": None, "client_callbacks": None,
    "aggregator": {"type": "Mean"}, "server_lr": 0.1, "server_momentum": 0.0,
    "server_dampening": 0.0, "server_weight_decay": 0.0, "lr_schedule": None,
    "num_malicious_clients": 0, "adversary_config": None,
    "evaluation_interval": 50, "evaluation_num_samples": None,
    "augment": "auto", "compute_dtype": None,
    # "auto" | "dense" | "streamed"
    "execution": "auto", "client_block": 50, "d_chunk": 1 << 17,
    "update_dtype": "bfloat16", "health_check": False,
    "fltrust_root_size": 100,
    # FL rounds per train() call (one result row); each round draws from
    # its own round seed, so the chained and unchained forms are one.
    "rounds_per_dispatch": 1, "chained_dispatch": False,
    # Per-client DP (FedavgDPConfig sets both from its privacy budget).
    "dp_clip_threshold": None, "dp_noise_factor": None,
}

# The reference's other fields, with its defaults: setting one to another
# value raises NotImplementedError (a later slice of the port).
_LATER = {
    "donate_buffers": True, "prefetch": "auto", "mxu_finish": None,
    "autotune": False, "autotune_cache_dir": None, "tuned_plan": None,
    "client_packing": "off", "state_store": "resident", "state_window": None,
    "state_dir": None, "data_store": "resident", "data_dir": None,
    "eval_chunk_clients": 256, "fault_config": None, "codec_config": None,
    "agg_domain": "f32", "async_config": None, "forensics": False,
    "ledger": False, "ledger_dir": None, "watchdog_rules": None,
    "control_config": None, "num_devices": None, "mesh_shape": None,
    "preagg": "bucket", "bucket_size": 1, "topology_config": None,
}
_LATER_EXECUTION = ("dsharded", "async", "hier", "gossip")

_NESTED = {
    "dataset_config": {"type": "dataset", "num_clients": "num_clients",
                       "iid": "iid", "alpha": "dirichlet_alpha",
                       "train_bs": "train_batch_size",
                       "num_classes": "num_classes", "seed": "seed"},
    "client_config": {"lr": "client_lr", "momentum": "client_momentum",
                      "num_batch_per_round": "num_batch_per_round",
                      "clip_gradient_norm": "clip_gradient_norm",
                      "callbacks": "client_callbacks"},
    "server_config": {"lr": "server_lr", "momentum": "server_momentum",
                      "dampening": "server_dampening",
                      "weight_decay": "server_weight_decay",
                      "aggregator": "aggregator",
                      "lr_schedule": "lr_schedule"},
}


def _dataset_name(dataset) -> Optional[str]:
    if isinstance(dataset, str):
        name = dataset
    elif isinstance(dataset, dict):
        name = dataset.get("type")
    else:
        name = getattr(dataset, "name", None)
    return name.lower() if isinstance(name, str) else None


class FedavgConfig:
    """Builder for :class:`~blades_tpu_torch.algorithms.fedavg.Fedavg`."""

    # A subclass's own fields and their defaults (FedavgDPConfig's budget).
    _EXTRA_FIELDS: Dict[str, Any] = {}

    def __init__(self, algo_class=None):
        from blades_tpu_torch.algorithms import fedavg as _fedavg

        self.algo_class = algo_class or _fedavg.Fedavg
        for k, v in {**_FIELDS, **self._EXTRA_FIELDS}.items():
            setattr(self, k, copy.deepcopy(v))
        self._frozen = False
        # Fields validate() inferred from the dataset, reset when the
        # dataset changes.
        self._inferred: set = set()

    # -- setters -------------------------------------------------------------

    def _assign(self, k, v):
        if k in _LATER:
            if v != _LATER[k]:
                raise NotImplementedError(
                    f"config field {k!r} is not in the port yet (a later "
                    "slice)")
            return
        if k not in _FIELDS and k not in self._EXTRA_FIELDS:
            raise KeyError(f"unknown config key {k!r}")
        if k == "dataset":
            if "input_shape" in self._inferred:
                self.input_shape = None
            if "num_classes" in self._inferred:
                self.num_classes = 10
            self._inferred.clear()
        setattr(self, k, v)
        self._inferred.discard(k)

    def _set(self, **kw):
        if self._frozen:
            raise RuntimeError("config is frozen")
        for k, v in kw.items():
            if v is not None:
                self._assign(k, v)
        return self

    def data(self, *, dataset=None, num_clients=None, iid=None,
             dirichlet_alpha=None, seed=None):
        return self._set(dataset=dataset, num_clients=num_clients, iid=iid,
                         dirichlet_alpha=dirichlet_alpha, seed=seed)

    def training(self, *, global_model=None, num_classes=None,
                 input_shape=None, aggregator=None, server_lr=None,
                 server_momentum=None, server_dampening=None,
                 server_weight_decay=None, lr_schedule=None,
                 num_batch_per_round=None, train_batch_size=None):
        return self._set(
            global_model=global_model, num_classes=num_classes,
            input_shape=input_shape, aggregator=aggregator,
            server_lr=server_lr, server_momentum=server_momentum,
            server_dampening=server_dampening,
            server_weight_decay=server_weight_decay, lr_schedule=lr_schedule,
            num_batch_per_round=num_batch_per_round,
            train_batch_size=train_batch_size)

    def client(self, *, lr=None, momentum=None, clip_gradient_norm=None,
               callbacks=None):
        return self._set(client_lr=lr, client_momentum=momentum,
                         clip_gradient_norm=clip_gradient_norm,
                         client_callbacks=callbacks)

    def adversary(self, *, num_malicious_clients=None, adversary_config=None):
        return self._set(num_malicious_clients=num_malicious_clients,
                         adversary_config=adversary_config)

    def evaluation(self, *, evaluation_interval=None, num_samples=None):
        return self._set(evaluation_interval=evaluation_interval,
                         evaluation_num_samples=num_samples)

    def resources(self, *, execution=None, client_block=None, d_chunk=None,
                  update_dtype=None, compute_dtype=None):
        return self._set(execution=execution, client_block=client_block,
                         d_chunk=d_chunk, update_dtype=update_dtype,
                         compute_dtype=compute_dtype)

    def fault_tolerance(self, *, health_check=None):
        return self._set(health_check=health_check)

    # -- dict shim -----------------------------------------------------------

    def keys(self):
        return list(_FIELDS) + list(self._EXTRA_FIELDS)

    def __getitem__(self, k):
        return getattr(self, k)

    def get(self, k, default=None):
        return getattr(self, k, default)

    def items(self):
        return [(k, getattr(self, k)) for k in self.keys()]

    def update_from_dict(self, d: Dict[str, Any]) -> "FedavgConfig":
        """Partial-dict merge of flat keys and the reference's YAML nesting
        (``dataset_config``, ``client_config``, ``server_config``)."""
        if self._frozen:
            raise RuntimeError("config is frozen")
        d = copy.deepcopy(dict(d))
        for nk, mapping in _NESTED.items():
            for sk, sv in (d.pop(nk, None) or {}).items():
                if sk not in mapping:
                    raise KeyError(f"unknown {nk} key {sk!r}")
                self._assign(mapping[sk], sv)
        for k, v in d.items():
            self._assign(k, v)
        return self

    # -- validation / build --------------------------------------------------

    def validate(self) -> None:
        if self.num_malicious_clients > self.num_clients // 2:
            raise ValueError(
                f"num_malicious_clients={self.num_malicious_clients} is a "
                f"majority of num_clients={self.num_clients}; Byzantine "
                "robustness is undefined past 50%")
        if self.num_malicious_clients > 0 and not self.adversary_config:
            raise ValueError("num_malicious_clients > 0 requires "
                             "adversary_config")
        name = _dataset_name(self.dataset)
        if self.input_shape is None:
            if name not in _INPUT_SHAPES:
                raise ValueError("input_shape could not be inferred; set "
                                 ".training(input_shape=...)")
            self.input_shape = _INPUT_SHAPES[name]
            self._inferred.add("input_shape")
        if name in _NUM_CLASSES and self.num_classes == 10:
            self.num_classes = _NUM_CLASSES[name]
            self._inferred.add("num_classes")
        if self.execution in _LATER_EXECUTION:
            raise NotImplementedError(
                f"execution={self.execution!r} is not in the port yet (a "
                "later slice); the port runs 'auto', 'dense' and 'streamed'")
        if self.execution not in ("auto", "dense", "streamed"):
            raise ValueError("execution must be auto|dense|streamed, got "
                             f"{self.execution!r}")
        if self.client_momentum and self.execution == "streamed":
            raise NotImplementedError(
                "client momentum on the streamed round is not in the port "
                "yet (a later slice); use execution='dense'")
        if str(self.update_dtype) not in ("bfloat16", "float32"):
            raise ValueError("update_dtype must be 'bfloat16' or 'float32', "
                             f"got {self.update_dtype!r}")
        if self.compute_dtype not in (None, "bfloat16", "float32"):
            raise ValueError("compute_dtype must be None, 'bfloat16' or "
                             f"'float32', got {self.compute_dtype!r}")
        if self.d_chunk < 1024:
            raise ValueError(f"d_chunk must be >= 1024, got {self.d_chunk}")
        if int(self.rounds_per_dispatch) < 1:
            raise ValueError("rounds_per_dispatch must be >= 1, got "
                             f"{self.rounds_per_dispatch}")
        if self.client_block < 1:
            raise ValueError(f"client_block must be >= 1, got "
                             f"{self.client_block}")
        if self.dp_clip_threshold is not None and self.dp_clip_threshold <= 0:
            raise ValueError("dp_clip_threshold must be > 0, got "
                             f"{self.dp_clip_threshold}")
        if (self.evaluation_num_samples is not None
                and self.evaluation_num_samples < 1):
            raise ValueError("evaluation_num_samples must be >= 1 (or None "
                             "for the full per-client shard), got "
                             f"{self.evaluation_num_samples}")
        self.get_adversary()  # an attack the port lacks fails here
        self.get_client_callbacks()  # so does an unknown callback

    def freeze(self) -> None:
        self._frozen = True

    def copy(self) -> "FedavgConfig":
        c = copy.deepcopy(self)
        c._frozen = False
        return c

    def get_task_spec(self) -> TaskSpec:
        augment = self.augment
        if augment == "auto":
            name = _dataset_name(self.dataset) or ""
            augment = "cifar" if name in ("cifar10", "cifar100") else None
        return TaskSpec(
            model=self.global_model, num_classes=self.num_classes,
            input_shape=tuple(self.input_shape), lr=self.client_lr,
            momentum=self.client_momentum, augment=augment,
            compute_dtype=self.compute_dtype)

    def get_server(self) -> Server:
        return Server.from_config(
            aggregator=self.aggregator,
            num_byzantine=self.num_malicious_clients, lr=self.server_lr,
            momentum=self.server_momentum, dampening=self.server_dampening,
            weight_decay=self.server_weight_decay,
            lr_schedule_points=self.lr_schedule)

    def get_client_callbacks(self) -> tuple:
        """The callback chain: the ``client_callbacks`` specs, then a
        :class:`ClippingCallback` when ``clip_gradient_norm`` is set."""
        cbs = [get_callback(s) for s in (self.client_callbacks or [])]
        if self.clip_gradient_norm:
            cbs.append(ClippingCallback(float(self.clip_gradient_norm)))
        return tuple(cbs)

    def get_adversary(self):
        return get_adversary(
            self.adversary_config, num_clients=self.num_clients,
            num_byzantine=self.num_malicious_clients,
            num_classes=self.num_classes)

    def resolve_augment_for_data(self, fed_round, dataset):
        """'auto' augmentation is the dataset's canonical train transform
        (CIFAR crop + flip), except on the synthetic fallback, whose
        Gaussian class patterns random crops destroy: there it resolves to
        none.  An explicit ``augment`` is honoured as given."""
        if not (getattr(dataset, "synthetic", False)
                and self.augment == "auto"):
            return fed_round
        task = fed_round.task
        task = dataclasses.replace(
            task, spec=dataclasses.replace(task.spec, augment=None))
        return dataclasses.replace(fed_round, task=task)

    def get_fed_round(self) -> FedRound:
        return FedRound(
            task=self.get_task_spec().build(), server=self.get_server(),
            adversary=self.get_adversary(),
            batch_size=self.train_batch_size,
            num_batches_per_round=self.num_batch_per_round,
            num_clients=self.num_clients, health_check=self.health_check,
            client_block=self.client_block,
            client_callbacks=self.get_client_callbacks(),
            dp_clip_threshold=self.dp_clip_threshold,
            dp_noise_factor=self.dp_noise_factor)

    def build(self, device=None):
        """Validate, freeze and build the driver on ``device`` (``None`` =
        the card)."""
        self.validate()
        self.freeze()
        return self.algo_class(self, device=device)
