"""Fluent algorithm config (counterpart of
``blades_tpu/algorithms/config.py``), for the fields that reach the dense
and streamed rounds.

The reference's builder surface -- ``.data() .training() .client()
.adversary() .evaluation() .resources()`` each returning ``self``, a dict
shim (``__getitem__`` / ``get`` / ``items`` / ``update_from_dict`` with the
reference's nested ``dataset_config`` / ``client_config`` /
``server_config`` keys), ``validate()`` and ``freeze()`` before
``build()``.  ``num_devices`` / ``mesh_shape`` run the rounds on the
ranks of a ``torch.distributed`` process group (one process per rank:
the client-sharded dense round, under ``execution="hier"`` the
hierarchical round with ``preagg`` and ``bucket_size``, under
``execution="dsharded"`` the width-sharded round); the autotuner tunes
on a mesh too, its ranks in lockstep, rank 0 deciding.  An unknown key
raises ``KeyError``.  The execution autotuner's fields (``autotune``,
``autotune_cache_dir``, ``tuned_plan``) are the reference's;
``mxu_finish`` takes only ``None`` or ``""`` (the port has no MXU route)
and ``donate_buffers`` either value (the port updates in place, so it
changes nothing).  ``validate()`` refuses the codec, fault, wire-domain,
buffered-async, participation-window, data-store, forensics, ledger,
control, gossip and client-packing combinations the reference refuses,
with its reasons, and ``get_fed_round()`` resolves the ``client_packing``
request (:func:`~blades_tpu_torch.parallel.packed.resolve_client_packing`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

from blades_tpu_torch.adversaries import get_adversary
from blades_tpu_torch.comm import get_codec
from blades_tpu_torch.core.callbacks import ClippingCallback, get_callback
from blades_tpu_torch.core.round import FedRound
from blades_tpu_torch.core.server import Server
from blades_tpu_torch.core.task import TaskSpec
from blades_tpu_torch.faults import FaultInjector

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
    # "auto" | "dense" | "streamed" | "async" | "gossip" | "hier"
    "execution": "auto", "client_block": 50, "d_chunk": 1 << 17,
    "update_dtype": "bfloat16", "health_check": False,
    "fltrust_root_size": 100,
    # FL rounds per train() call (one result row); each round draws from
    # its own round seed, so the chained and unchained forms are one.
    "rounds_per_dispatch": 1, "chained_dispatch": False,
    # Per-client DP (FedavgDPConfig sets both from its privacy budget).
    "dp_clip_threshold": None, "dp_noise_factor": None,
    # The fault injector's and the update codec's specs ({"type": ...}
    # for the codec) and the aggregation domain ("f32" | "wire").
    "fault_config": None, "codec_config": None, "agg_domain": "f32",
    # Buffered-async arrivals (AsyncSpec knobs, execution="async").
    "async_config": None,
    # The participation window: the cohort size (None = every client, 0 =
    # stateless clients), where the off-cohort state rows live and the
    # disk store's directory; the training-data store and its directory;
    # the streaming evaluation's chunk; cohort staging ("auto" = on the
    # card, True / "on", False / "off").
    "state_store": "resident", "state_window": None, "state_dir": None,
    "data_store": "resident", "data_dir": None, "eval_chunk_clients": 256,
    "prefetch": "auto",
    # Observability: defense forensics, the client ledger (False / True =
    # "resident" / "disk") and the disk ledger's directory, the watchdog's
    # rule table (None = default_rules()); the control plane's spec
    # (ControlPolicy knobs plus "enabled" and "rules"; None = off).
    "forensics": False, "ledger": False, "ledger_dir": None,
    "watchdog_rules": None, "control_config": None,
    # Decentralized gossip (execution="gossip"): the peer-graph spec, a
    # dict of TopologyConfig knobs (graph / k / p / graph_seed / mixing;
    # num_nodes is num_clients) or a bare graph name; None runs the
    # TopologyConfig defaults (ring).  Set via .topology(...).
    "topology_config": None,
    # Client lane-packing: "off" | "auto" (pack 2 clients per lane of
    # grouped kernels when eligible, else a loud fallback) | an int P >= 2
    # (forced).  Updates are unpacked before anything reads them.
    "client_packing": "off",
    # Accepted with either value; the port updates the state in place.
    "donate_buffers": True,
    # The reference's MXU finish: None or "" (the port has no MXU route).
    "mxu_finish": None,
    # The execution autotuner (perf/autotune.py): False / "off", True /
    # "on" (the bit-exact default tier) or "reassociating"; the plan
    # cache's directory; a pinned plan dict (Plan.as_dict()).
    "autotune": False, "autotune_cache_dir": None, "tuned_plan": None,
    # Ranks of the process group (None = one process) and their
    # (clients, d) grid; the hierarchical round's pre-aggregation flavor
    # ("bucket" | "nnm") and bucket size (1 = the identity).
    "num_devices": None, "mesh_shape": None,
    "preagg": "bucket", "bucket_size": 1,
}

_NO_MXU = ("the port has no MXU route: the JAX package's mxu_finish "
           "'counts' / 'all' pick a TPU unit, and the card's finish takes "
           "neither -- set mxu_finish=None or ''")
_EXECUTIONS = ("auto", "dense", "streamed", "dsharded", "async", "hier",
               "gossip")

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
        # get_fed_round()'s packing decision (requested / pack_factor /
        # packed_lanes / fallback), which sweep summaries carry.
        self._packing_decision = None
        # Fields the user set (setters and dict merge), as opposed to
        # defaults: the autotuner never varies an explicit knob.
        self._explicit: set = set()
        # The scan windows the sweep hands the autotuner (eligible
        # chained windows, descending).
        self._autotune_windows = None

    # -- setters -------------------------------------------------------------

    def _assign(self, k, v):
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
        self._explicit.add(k)

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
                  update_dtype=None, compute_dtype=None, state_store=None,
                  window=None, state_dir=None, data_store=None,
                  data_dir=None, eval_chunk_clients=None,
                  client_packing=None, mxu_finish=None, autotune=None,
                  autotune_cache_dir=None, tuned_plan=None, num_devices=None,
                  mesh_shape=None, preagg=None, bucket_size=None):
        """``num_devices`` ranks of the process group run the round
        (``mesh_shape=(c, dd)`` their grid), ``preagg`` / ``bucket_size``
        the hierarchical round's pre-aggregation; ``autotune`` (``"on"`` /
        True, ``"reassociating"``, ``"off"``) arms the execution autotuner,
        ``autotune_cache_dir`` its plan cache's directory, ``tuned_plan`` pins a plan dict instead of
        tuning; ``client_packing`` packs clients into lanes of grouped kernels
        (``"off"``, ``"auto"`` or an int P >= 2); ``window`` is the
        participation window's cohort size (0 =
        stateless clients), ``state_store`` where the off-cohort state
        rows live (``resident`` | ``host`` | ``disk``, in ``state_dir``);
        ``data_store`` (``resident`` | ``memmap``, in ``data_dir``) the
        training shards' store, and ``eval_chunk_clients`` the streaming
        evaluation's chunk under ``memmap``."""
        if window is not None:
            self._set(state_window=int(window))
        return self._set(execution=execution, client_block=client_block,
                         d_chunk=d_chunk, update_dtype=update_dtype,
                         compute_dtype=compute_dtype, state_store=state_store,
                         state_dir=state_dir, data_store=data_store,
                         data_dir=data_dir,
                         eval_chunk_clients=eval_chunk_clients,
                         client_packing=client_packing,
                         mxu_finish=mxu_finish, autotune=autotune,
                         autotune_cache_dir=autotune_cache_dir,
                         tuned_plan=tuned_plan, num_devices=num_devices,
                         mesh_shape=mesh_shape, preagg=preagg,
                         bucket_size=bucket_size)

    def arrivals(self, *, rate=None, rate_schedule=None, slow_fraction=None,
                 slow_factor=None, agg_every=None, buffer_capacity=None,
                 staleness_cap=None, weight_schedule=None, weight_power=None,
                 weight_cutoff=None, seed=None, max_ticks_per_cycle=None,
                 ticks_per_sec=None):
        """The buffered-async arrival spec
        (:class:`~blades_tpu_torch.arrivals.AsyncSpec`) for
        ``execution="async"``, merged into ``async_config``."""
        spec = dict(self.async_config or {})
        for k, v in (("rate", rate), ("rate_schedule", rate_schedule),
                     ("slow_fraction", slow_fraction),
                     ("slow_factor", slow_factor), ("agg_every", agg_every),
                     ("buffer_capacity", buffer_capacity),
                     ("staleness_cap", staleness_cap),
                     ("weight_schedule", weight_schedule),
                     ("weight_power", weight_power),
                     ("weight_cutoff", weight_cutoff), ("seed", seed),
                     ("max_ticks_per_cycle", max_ticks_per_cycle),
                     ("ticks_per_sec", ticks_per_sec)):
            if v is not None:
                spec[k] = v
        return self._set(async_config=spec or None)

    def fault_tolerance(self, *, health_check=None, faults=None):
        """The in-round health check and the fault injector's spec
        (``faults=``, the keywords of
        :class:`~blades_tpu_torch.faults.FaultInjector`)."""
        return self._set(health_check=health_check, fault_config=faults)

    def observability(self, *, forensics=None, ledger=None, ledger_dir=None,
                      watchdog_rules=None):
        """Defense forensics (per-lane diagnostics and the detection
        precision / recall / FPR of every round), the client ledger
        (``ledger=True`` for the resident backend, ``"disk"`` to memmap
        its columns in ``ledger_dir``) and the watchdog's rule table
        (``watchdog_rules=`` a list of rule dicts replacing
        ``default_rules()``)."""
        return self._set(forensics=forensics, ledger=ledger,
                         ledger_dir=ledger_dir,
                         watchdog_rules=watchdog_rules)

    def control(self, *, enabled=None, rules=None, cooldown_rounds=None,
                quarantine_rounds=None, quarantine_max=None,
                max_quarantine_fraction=None, min_agg_every=None,
                agg_every_factor=None, buffer_factor=None,
                max_buffer_capacity=None, cutoff_factor=None,
                max_weight_cutoff=None, min_window=None,
                window_factor=None):
        """The closed-loop control plane (:mod:`blades_tpu_torch.control`):
        watchdog events drive bounded, rate-limited, journaled actuator
        moves.  ``rules=`` maps watchdog rule names to actuator families
        (``agg_every`` | ``buffer`` | ``quarantine`` | ``replan`` |
        ``window`` | ``"off"``) over the default table; the other knobs
        are :class:`~blades_tpu_torch.control.ControlPolicy` bounds.
        Merged into ``control_config``; a bare ``.control()`` arms the
        defaults."""
        spec = dict(self.control_config or {})
        for k, v in (("enabled", enabled), ("rules", rules),
                     ("cooldown_rounds", cooldown_rounds),
                     ("quarantine_rounds", quarantine_rounds),
                     ("quarantine_max", quarantine_max),
                     ("max_quarantine_fraction", max_quarantine_fraction),
                     ("min_agg_every", min_agg_every),
                     ("agg_every_factor", agg_every_factor),
                     ("buffer_factor", buffer_factor),
                     ("max_buffer_capacity", max_buffer_capacity),
                     ("cutoff_factor", cutoff_factor),
                     ("max_weight_cutoff", max_weight_cutoff),
                     ("min_window", min_window),
                     ("window_factor", window_factor)):
            if v is not None:
                spec[k] = v
        if not spec:
            spec = {"enabled": True}  # a bare .control() arms the defaults
        return self._set(control_config=spec)

    def topology(self, *, graph=None, k=None, p=None, graph_seed=None,
                 mixing=None):
        """The peer graph of ``execution="gossip"``
        (:class:`~blades_tpu_torch.topology.TopologyConfig`): the graph
        family (``ring`` | ``torus`` | ``kregular`` | ``erdos`` |
        ``complete``), its size knob (``k`` for kregular, ``p`` for
        erdos), the Erdős–Rényi draw's seed and the doubly-stochastic
        mixing (``metropolis`` | ``uniform``).  Merged into
        ``topology_config``."""
        spec = dict(self.topology_config or {})
        for key, v in (("graph", graph), ("k", k), ("p", p),
                       ("graph_seed", graph_seed), ("mixing", mixing)):
            if v is not None:
                spec[key] = v
        return self._set(topology_config=spec or None)

    def communication(self, *, codec=None, agg_domain=None):
        """The uplink codec (``codec=``, e.g. ``{"type": "topk",
        "topk_ratio": 0.01}``) and the aggregation domain (``"f32"`` or
        ``"wire"``: a quant payload stays packed through the defenses)."""
        return self._set(codec_config=codec, agg_domain=agg_domain)

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
        self._validate_autotune()
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
        if self.execution not in _EXECUTIONS:
            raise ValueError("execution must be " + "|".join(_EXECUTIONS)
                             + f", got {self.execution!r}")
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
        adv = self.get_adversary()  # an attack the port lacks fails here
        self.get_client_callbacks()  # so does an unknown callback
        self._validate_gossip()
        self._validate_mesh()
        self._validate_comm_and_faults()
        self._validate_async()
        self._validate_window()
        self._validate_observability()
        self._validate_packing()
        if getattr(adv, "requires_virtual_time", False) \
                and self.execution != "async":
            raise ValueError(
                f"adversary {self.adversary_config.get('type')!r} is a "
                "campaign attack scheduled over virtual arrival time; "
                f"execution={self.execution!r} has no tick clock -- set "
                ".resources(execution='async')")
        # Topology-scoped attacks poison per RECEIVER over the peer graph:
        # only the gossip round has receivers to scope.
        if getattr(adv, "topology_scoped", False) \
                and self.execution != "gossip":
            raise ValueError(
                f"adversary {self.adversary_config.get('type')!r} is "
                "topology-scoped (per-receiver poisoning over the "
                f"peer graph); execution={self.execution!r} has no "
                "peer graph — set .resources(execution='gossip')")

    def _validate_mesh(self) -> None:
        """The reference's checks of ``num_devices``, ``mesh_shape``,
        ``preagg``, ``bucket_size`` and ``execution='hier'`` and of every
        pair it refuses on a mesh, with its words (the autotuner only with
        an explicit ``execution='hier'`` or ``'dsharded'`` pin)."""
        from blades_tpu_torch.ops.preagg import PREAGG_FLAVORS

        multi = bool(self.num_devices and self.num_devices > 1)
        if self.num_devices is not None and (
                not isinstance(self.num_devices, int)
                or isinstance(self.num_devices, bool)
                or self.num_devices < 1):
            raise ValueError(f"num_devices must be None or an int >= 1, got "
                             f"{self.num_devices!r}")
        if self.preagg not in PREAGG_FLAVORS:
            raise ValueError(
                f"preagg must be one of {PREAGG_FLAVORS}, got "
                f"{self.preagg!r}")
        if (not isinstance(self.bucket_size, int)
                or isinstance(self.bucket_size, bool) or self.bucket_size < 1):
            raise ValueError(
                f"bucket_size must be an int >= 1, got {self.bucket_size!r}")
        if self.mesh_shape is not None:
            ms = tuple(int(v) for v in self.mesh_shape)
            if len(ms) != 2 or min(ms) < 1:
                raise ValueError(
                    f"mesh_shape must be a (clients, d) pair of positive "
                    f"ints, got {self.mesh_shape!r}")
            self.mesh_shape = ms
            if not multi:
                raise ValueError(
                    "mesh_shape × single-chip is an unsupported pair: the "
                    "2-D (clients, d) layout tiles a multi-chip mesh — "
                    "set .resources(num_devices=...) > 1, or drop "
                    "mesh_shape")
            if ms[0] * ms[1] != self.num_devices:
                raise ValueError(
                    f"mesh_shape {ms[0]}x{ms[1]} must tile exactly "
                    f"num_devices={self.num_devices} chips — fix one of "
                    "the two in .resources(...)")
        if self.execution == "dsharded" and not multi:
            raise ValueError(
                "execution='dsharded' width-shards the update matrix "
                "over a mesh; set .resources(num_devices=...) > 1")
        if self.execution == "hier":
            if not multi:
                raise ValueError(
                    "execution='hier' pre-aggregates per chip and gathers "
                    "representatives over a mesh; set "
                    ".resources(num_devices=...) > 1")
            if int(self.rounds_per_dispatch or 1) != 1:
                raise ValueError(
                    "execution='hier' × rounds_per_dispatch>1 is an "
                    "unsupported pair: the hierarchical round is dispatched "
                    "per-round (no chained-scan formulation yet) — set "
                    "rounds_per_dispatch=1, or use a flat mesh path")
        if not multi:
            return
        for execution, why, flip in (
                ("streamed", "execution='streamed' × num_devices>1 is an "
                 "unsupported pair: streamed is the single-chip "
                 "giant-federation path", "use a mesh execution "
                 "(dsharded/hier) for multi-chip"),
                ("async", "execution='async' × num_devices>1 is an "
                 "unsupported pair: the buffered cycle program has no mesh "
                 "formulation", "use a synchronous execution path on the "
                 "mesh")):
            if self.execution == execution:
                raise ValueError(f"{why} — set .resources(num_devices=None), "
                                 f"or {flip}")
        if self.execution == "dsharded":
            self._validate_dsharded()
        if self.forensics:
            raise ValueError(
                "forensics × num_devices>1 is an unsupported pair: "
                "per-lane diagnostics under shard_map would shard "
                "the lane axis — set .resources(num_devices=None), "
                "or flip .observability(forensics=False)")
        if self.fault_config:
            injector = self.get_fault_injector()
            if self.execution not in ("hier", "gossip"):
                raise ValueError(
                    "fault injection × num_devices>1 is an "
                    "unsupported pair on the flat mesh paths: the "
                    "participation mask under shard_map would shard "
                    "the lane axis — set .resources(num_devices=None) "
                    "or .resources(execution='hier'), or drop faults")
            if self.execution == "hier":
                if injector is not None and injector.needs_stale_buffer:
                    raise ValueError(
                        "execution='hier' × straggler faults is an "
                        "unsupported pair: the stale ring buffer is "
                        "sized per lane and has no hierarchical "
                        "formulation — set num_stragglers=0, or run "
                        "single-chip")
                if self.preagg == "bucket" and self.bucket_size != 1:
                    raise ValueError(
                        "execution='hier' × fault injection needs an "
                        "identity-height pre-aggregation (bucketing "
                        f"with bucket_size={self.bucket_size} shrinks "
                        "the matrix) — set .resources(bucket_size=1) "
                        "or preagg='nnm', or drop faults")
        if self.codec_config:
            raise ValueError(
                "update codecs are single-chip for now: top-k selection "
                "and per-row scales under shard_map would shard the "
                "lane axis — run the compressed pass without "
                "num_devices, or disable the codec")
        w = self.state_window
        if w == 0:
            raise ValueError(
                "window=0 (stateless clients) × num_devices>1 is an "
                "unsupported pair: the mesh rounds thread per-client "
                "state through their own bodies — set "
                ".resources(num_devices=None), or drop window=0")
        if w is not None and w >= 1:
            raise ValueError(
                f"state_window={w} × num_devices>1 is an unsupported "
                "pair: cohort gather/scatter has no mesh formulation "
                "— set .resources(num_devices=None), or drop the "
                "window")
        if self.ledger_backend:
            raise ValueError(
                "ledger × num_devices>1 is an unsupported pair: the "
                "ledger folds per-lane diagnosis host-side and the "
                "mesh paths never materialise per-lane decisions — "
                "set .resources(num_devices=None), or flip "
                ".observability(ledger=False)")
        if self.get_control_policy() is not None:
            raise ValueError(
                "control × num_devices>1 is an unsupported pair "
                "(same lane-axis constraint as forensics/ledger) — "
                "set .resources(num_devices=None), or drop .control()")
        if self.autotune_mode and self.execution == "hier":
            raise ValueError(
                "autotune × execution='hier' is an unsupported pair: "
                "the tuner selects INTO the hierarchical path via its "
                "collective knob (reassociating tier) — set "
                ".resources(execution='auto') to let it, pin the plan "
                "via tuned_plan, or disable autotune")
        if self.chained_dispatch:
            raise ValueError(
                "chained_dispatch (the sweep's scan-window key discipline) "
                "has no mesh formulation; run without num_devices or drop "
                "chained_dispatch")
        if self.autotune_mode and self.execution == "dsharded":
            raise ValueError(
                "autotune × execution='dsharded' is an unsupported "
                "pair: the plan space has no d-sharded vocabulary (a "
                "plan would silently rewrite the pin) — set "
                ".resources(autotune='off'), or drop the explicit "
                "execution pin")

    def _validate_dsharded(self) -> None:
        """The reference's refusals of the width-sharded round's pairs
        (forensics, faults, codecs, control), with its words; they come
        before the generic ``num_devices>1`` ones there too."""
        if self.forensics:
            raise ValueError(
                "forensics × execution='dsharded' is an unsupported pair: "
                "the streamed/d-sharded paths never materialise the "
                "per-lane decisions forensics reports — set "
                ".resources(execution='dense') (or 'auto' within the "
                "dense budget), or flip .observability(forensics=False)")
        if self.fault_config:
            self.get_fault_injector()
            raise ValueError(
                "fault injection (fault_config) is only formulated for "
                "the dense round — the streamed/d-sharded paths never "
                "materialise the participation mask the masked "
                "aggregators consume; use execution='dense' (or 'auto' "
                "within the dense budget) or disable faults")
        if self.codec_config:
            self.get_codec()
            raise ValueError(
                "update codecs (codec_config) are only formulated for "
                "the dense round — the streamed/d-sharded paths never "
                "materialise the full (n, d) matrix the encode->decode "
                "transform consumes; use execution='dense' (or 'auto' "
                "within the dense budget) or disable the codec")
        if self.get_control_policy() is not None:
            raise ValueError(
                "control × execution='dsharded' is an unsupported pair: "
                "the controller's sensors ride forensics/ledger row "
                "fields those paths never produce — use "
                "execution='dense'/'async', or drop .control()")

    def _validate_gossip(self) -> None:
        """The reference's checks of ``topology_config`` and
        ``execution='gossip'``, with its words."""
        if self.topology_config and self.execution != "gossip":
            raise ValueError(
                "topology_config is set but execution="
                f"{self.execution!r}: the peer-graph spec only drives the "
                "decentralized gossip path — set "
                ".resources(execution='gossip') or drop .topology(...)")
        if self.execution != "gossip":
            return
        # Build the topology now: a bad (graph, knob) pair fails here.
        self.get_topology()
        for knob, why, flip in (
                (self.codec_config, "update codecs",
                 ".communication(codec=None)"),
                (self.agg_domain != "f32", "wire-domain aggregation",
                 ".communication(agg_domain='f32')"),
                (self.client_packing not in ("off", None),
                 "client lane-packing", ".resources(client_packing='off')"),
                (self.state_window is not None,
                 "the participation-window store", ".resources(window=None)"),
                (self.state_store != "resident", "out-of-core client state",
                 ".resources(state_store='resident')"),
                (self.forensics, "defense forensics",
                 ".observability(forensics=False)"),
                (self.ledger_backend, "the client ledger",
                 ".observability(ledger=False)"),
                (self.control_config, "the control plane", "drop .control()"),
                (int(self.rounds_per_dispatch or 1) != 1,
                 "rounds_per_dispatch > 1", "rounds_per_dispatch=1"),
                (self.chained_dispatch, "chained_dispatch",
                 "chained_dispatch=False"),
                (self.autotune_mode, "the execution autotuner",
                 ".resources(autotune='off')"),
                (self.mesh_shape is not None, "2-D mesh_shape",
                 ".resources(mesh_shape=None)")):
            if knob:
                raise ValueError(
                    f"execution='gossip' × {why} is an unsupported "
                    "pair: the decentralized round has no central "
                    "server matrix for that stage to rewrite — set "
                    f"{flip}, or use a server execution path")
        injector = self.get_fault_injector()
        if injector is not None:
            if injector.needs_stale_buffer:
                raise ValueError(
                    "execution='gossip' × straggler faults is an "
                    "unsupported pair: the stale ring buffer is a "
                    "server-path process — gossip faults are EDGE "
                    "dropout (dropout_rate/dropout_schedule); set "
                    "num_stragglers=0")
            if injector.corrupt_rate > 0.0:
                raise ValueError(
                    "execution='gossip' × corruption faults is an "
                    "unsupported pair: lane corruption models "
                    "server-bound transfers — gossip faults are EDGE "
                    "dropout; set corrupt_rate=0")

    def _validate_observability(self) -> None:
        """The reference's checks of forensics, the ledger, the watchdog
        rules and the control plane, with its words."""
        if self.forensics and self.execution == "streamed":
            raise ValueError(
                f"forensics × execution={self.execution!r} is an "
                "unsupported pair: the streamed/d-sharded paths never "
                "materialise the per-lane decisions forensics reports "
                "— set .resources(execution='dense') (or 'auto' "
                "within the dense budget), or flip "
                ".observability(forensics=False)")
        if not self.ledger_backend and self.ledger_dir:
            raise ValueError(
                "ledger_dir is set but the ledger is disabled — set "
                ".observability(ledger='disk') (ledger_dir names the "
                "disk backend's live directory) or drop ledger_dir")
        if self.watchdog_rules is not None:
            self.get_watchdog_rules()
        policy = self.get_control_policy()
        if policy is None:
            return
        if int(self.rounds_per_dispatch or 1) != 1:
            raise ValueError(
                "control × rounds_per_dispatch > 1 is an unsupported "
                "pair: the controller observes and actuates between "
                "HOST-VISIBLE rounds, and a fused dispatch gives it "
                "none — set rounds_per_dispatch=1, or drop .control()")
        if self.execution == "streamed":
            raise ValueError(
                f"control × execution={self.execution!r} is an "
                "unsupported pair: the controller's sensors ride "
                "forensics/ledger row fields those paths never "
                "produce — use execution='dense'/'async', or drop "
                ".control()")
        quarantine_armed = policy.quarantine_rounds > 0 and any(
            fam == "quarantine" for _, fam in policy.rule_table)
        if quarantine_armed:
            for missing, why, flip in (
                    (self.execution != "async",
                     "an async ingest path to mask clients at",
                     ".resources(execution='async')"),
                    (not self.forensics,
                     "per-lane diagnoses to probe against",
                     ".observability(forensics=True)"),
                    (not self.ledger_backend,
                     "the ledger's reputation ranking to pick suspects",
                     ".observability(ledger=True)")):
                if missing:
                    raise ValueError(
                        "control quarantine moves need " + why +
                        f" — set {flip}, or disable them with "
                        ".control(quarantine_rounds=0) or "
                        ".control(rules={'fpr_collapse': 'off', "
                        "'reputation_collapse': 'off'})")
            spec = self.get_async_spec()
            ceiling = int(policy.max_quarantine_fraction * self.num_clients)
            if self.num_clients - ceiling < spec.agg_every:
                raise ValueError(
                    f"control max_quarantine_fraction="
                    f"{policy.max_quarantine_fraction} could "
                    f"quarantine {ceiling} of {self.num_clients} "
                    f"clients, starving agg_every={spec.agg_every} "
                    "(a cycle buffers at most one event per free "
                    "client) — lower the fraction or agg_every")
        if self.execution == "async" and self.state_store != "resident" \
                and any(fam in ("agg_every", "buffer")
                        for _, fam in policy.rule_table):
            raise ValueError(
                f"control agg_every/buffer moves × state_store="
                f"{self.state_store!r} is an unsupported pair: the "
                "out-of-core store sizes its staging rows by the "
                "initial agg_every, and both families can GROW the "
                "staged set — map those rules to the shrink-only "
                "'window' family in .control(rules=...) (bounded by "
                "min_window/window_factor), map them 'off', or set "
                "state_store='resident'")

    @property
    def autotune_mode(self) -> Optional[str]:
        """The autotune request: ``None`` (off), ``"default"`` (the
        numerics-preserving tier) or ``"reassociating"`` (the opt-in tier
        too)."""
        v = self.autotune
        if v in (False, None, 0, "off", ""):
            return None
        if v in (True, 1, "on", "default"):
            return "default"
        if v == "reassociating":
            return "reassociating"
        raise ValueError(
            f"autotune must be off|on|reassociating (or bool), got {v!r}")

    @property
    def ledger_backend(self) -> Optional[str]:
        """The ledger request: ``None`` (off), ``"resident"`` (host-RAM
        columns; what ``ledger=True`` means) or ``"disk"`` (memmapped
        columns)."""
        v = self.ledger
        if v in (False, None, 0, "off", ""):
            return None
        if v in (True, 1, "on", "resident"):
            return "resident"
        if v == "disk":
            return "disk"
        raise ValueError(
            f"ledger must be off|resident|disk (or bool), got {v!r}")

    @property
    def control_enabled(self) -> bool:
        """Whether the control plane is armed: a ``control_config`` dict
        whose ``enabled`` (True by default) is truthy."""
        cfg = self.control_config
        if cfg is None:
            return False
        if not isinstance(cfg, dict):
            raise ValueError(
                f"control_config must be a dict, got {type(cfg).__name__}")
        return bool(cfg.get("enabled", True))

    def get_watchdog_rules(self) -> tuple:
        """The watchdog's rule table: ``watchdog_rules`` resolved through
        :func:`~blades_tpu_torch.obs.watchdog.rules_from_config` (unknown
        keys, kinds and fields fail), or ``default_rules()``."""
        from blades_tpu_torch.obs.watchdog import rules_from_config

        return rules_from_config(self.watchdog_rules)

    def get_control_policy(self):
        """The :class:`~blades_tpu_torch.control.ControlPolicy` of
        ``control_config`` (None when the control plane is off)."""
        if not self.control_enabled:
            return None
        from blades_tpu_torch.control import ControlPolicy

        return ControlPolicy.from_config(self.control_config)

    def _validate_async(self) -> None:
        """The reference's checks of ``async_config`` and
        ``execution='async'``."""
        if self.async_config and self.execution != "async":
            raise ValueError(
                "async_config is set but execution="
                f"{self.execution!r}: the arrival spec only drives the "
                "buffered-async path -- set .resources(execution='async') "
                "or drop .arrivals(...)")
        if self.execution != "async":
            return
        spec = self.get_async_spec()  # a bad knob fails here
        if spec.agg_every > self.num_clients:
            raise ValueError(
                f"async agg_every={spec.agg_every} > num_clients="
                f"{self.num_clients}: a cycle aggregates at most one "
                "event per client")
        for knob, why, flip in (
                (self.codec_config, "update codecs",
                 ".communication(codec=None)"),
                (self.agg_domain != "f32", "wire-domain aggregation",
                 ".communication(agg_domain='f32')"),
                (self.client_packing not in ("off", None),
                 "client lane-packing", ".resources(client_packing='off')"),
                (self.autotune_mode, "the execution autotuner",
                 ".resources(autotune='off')"),
                (int(self.rounds_per_dispatch or 1) != 1,
                 "rounds_per_dispatch > 1", "rounds_per_dispatch=1"),
                (self.chained_dispatch, "chained_dispatch",
                 "chained_dispatch=False"),
                (self.health_check, "the in-round health check",
                 ".fault_tolerance(health_check=False)"),
                (self.dp_clip_threshold, "client DP",
                 "dp_clip_threshold=None")):
            if knob:
                raise ValueError(
                    f"execution='async' x {why} is an unsupported pair: "
                    "the buffered cycle aggregates arrival EVENTS, not the "
                    "lockstep (n, d) round that stage is formulated over "
                    f"-- set {flip}, or use a synchronous execution path")
        injector = self.get_fault_injector()
        if injector is not None and injector.num_stragglers:
            raise ValueError(
                "execution='async' subsumes the straggler fault process "
                "(staleness is first-class in the arrival model); set "
                "num_stragglers=0 -- dropout and corruption compose with "
                "async arrivals as-is")

    def _validate_packing(self) -> None:
        """The reference's checks of a forced ``client_packing`` int, with
        its words; ``get_fed_round()`` resolves the rest against the
        model."""
        if self.client_packing in ("off", "auto", None):
            return
        try:
            p = int(self.client_packing)
        except (TypeError, ValueError):
            raise ValueError(
                "client_packing must be 'off', 'auto' or an int >= 2, "
                f"got {self.client_packing!r}")
        if p < 2:
            raise ValueError(f"client_packing int must be >= 2, got {p}")
        if self.num_clients % p:
            raise ValueError(
                f"client_packing={p} does not divide num_clients="
                f"{self.num_clients}")
        num_devices = getattr(self, "num_devices", None)
        if num_devices and num_devices > 1:
            raise ValueError(
                "client_packing × num_devices>1 is an unsupported "
                "pair: the grouped-kernel lanes have no mesh "
                "formulation — set .resources(num_devices=None), or "
                ".resources(client_packing='off')")
        if self.execution in ("streamed", "dsharded"):
            raise ValueError(
                "client_packing needs the dense round; execution="
                f"{self.execution!r} never runs the packed local round")

    def _validate_window(self) -> None:
        """The reference's checks of the participation window, the state
        store and the data store."""
        from blades_tpu_torch.data.store import DATA_STORE_BACKENDS
        from blades_tpu_torch.state.store import STORE_BACKENDS

        if self.state_store not in STORE_BACKENDS:
            raise ValueError(f"state_store must be one of {STORE_BACKENDS}, "
                             f"got {self.state_store!r}")
        w = self.state_window
        if w is not None and (not isinstance(w, int) or isinstance(w, bool)
                              or w < 0):
            raise ValueError(
                f"state_window must be None, 0 (stateless) or a positive "
                f"cohort size, got {w!r}")
        if (w is None and self.state_store != "resident"
                and self.execution != "async"):
            raise ValueError(
                f"state_store={self.state_store!r} needs a participation "
                "window: set .resources(window=...) -- without one there "
                "is no cohort to stage (the async path alone windows by "
                "its event batch instead)")
        if w == 0:
            if self.state_store != "resident":
                raise ValueError(
                    "window=0 is the STATELESS degenerate case -- clients "
                    "keep no state, so there is nothing for a "
                    f"{self.state_store!r} store to hold; drop state_store "
                    "or use window >= 1")
            codec = self.get_codec()
            if codec is not None and codec.needs_residual:
                raise ValueError(
                    "window=0 (stateless clients) cannot compose with a "
                    "top-k error-feedback codec: the EF residual is "
                    "persistent per-client state by definition")
            if self.execution not in ("auto", "dense"):
                raise ValueError(
                    "window=0 (stateless clients) is formulated for the "
                    f"dense round only; execution={self.execution!r} "
                    "carries its own per-client state threading")
        if w is not None and w >= 1:
            if w > self.num_clients:
                raise ValueError(
                    f"window={w} > num_clients={self.num_clients}: the "
                    "cohort samples without replacement from the "
                    "registered population")
            if self.execution not in ("auto", "dense"):
                raise ValueError(
                    "the participation-window store is formulated for the "
                    "dense single-card round (the cohort matrix is "
                    f"(window, d)); execution={self.execution!r} has no "
                    "windowed formulation -- drop the window or use "
                    "execution='dense'")
            for knob, why, flip in (
                    (self.fault_config, "fault injection (the straggler "
                     "ring and participation mask are keyed by lane, not "
                     "registered id)", ".fault_tolerance(faults=None)"),
                    (self.client_packing not in ("off", None),
                     "client lane-packing",
                     ".resources(client_packing='off')"),
                    (self.agg_domain != "f32", "wire-domain aggregation",
                     ".communication(agg_domain='f32')"),
                    (int(self.rounds_per_dispatch or 1) != 1,
                     "rounds_per_dispatch > 1 (cohort staging happens "
                     "between dispatches)", "rounds_per_dispatch=1"),
                    (self.chained_dispatch, "chained_dispatch",
                     "chained_dispatch=False")):
                if knob:
                    raise ValueError(
                        f"state_window={w} x {why} is an unsupported pair "
                        f"-- set {flip}, or run without the participation "
                        "window")
        if self.data_store not in DATA_STORE_BACKENDS:
            raise ValueError(
                f"data_store must be one of {DATA_STORE_BACKENDS}, got "
                f"{self.data_store!r}")
        if self.data_store == "memmap":
            ooc_async = (self.execution == "async"
                         and self.state_store != "resident")
            if not ((w is not None and w >= 1) or ooc_async):
                raise ValueError(
                    "data_store='memmap' needs a per-cohort staging path: "
                    "set .resources(window=...) >= 1 (windowed dense) or "
                    "execution='async' with an out-of-core state_store -- "
                    "the full-participation rounds hold the whole "
                    "partition on the card and never stage cohort data")
        elif self.data_dir:
            raise ValueError(
                "data_dir is set but data_store='resident' -- set "
                ".resources(data_store='memmap') (data_dir names the "
                "memmap backend's live shard directory) or drop data_dir")
        if (not isinstance(self.eval_chunk_clients, int)
                or isinstance(self.eval_chunk_clients, bool)
                or self.eval_chunk_clients < 1):
            raise ValueError(
                f"eval_chunk_clients must be an int >= 1, got "
                f"{self.eval_chunk_clients!r}")
        if self.prefetch not in ("auto", True, False, "on", "off"):
            raise ValueError(
                "prefetch must be 'auto', True / 'on' or False / 'off', "
                f"got {self.prefetch!r}")

    def _validate_autotune(self) -> None:
        """The reference's checks of ``mxu_finish``, ``autotune`` and
        ``tuned_plan``, with the port's refusal of the MXU finishes."""
        if self.mxu_finish not in (None, "", "counts", "all"):
            raise ValueError(
                "mxu_finish must be None (env default), '', 'counts' or "
                f"'all', got {self.mxu_finish!r}")
        if self.mxu_finish:
            raise ValueError(f"mxu_finish={self.mxu_finish!r}: {_NO_MXU}")
        self.autotune_mode  # fail fast on a bad autotune value
        if self.tuned_plan is not None:
            from blades_tpu_torch.perf.autotune import Plan

            plan = Plan.from_dict(self.tuned_plan)
            if plan.mxu_finish:
                raise ValueError(
                    f"tuned_plan carries mxu_finish={plan.mxu_finish!r}: "
                    f"{_NO_MXU}")

    def _validate_comm_and_faults(self) -> None:
        """The reference's checks of ``fault_config``, ``codec_config``
        and ``agg_domain`` (meshes are refused by name elsewhere)."""
        for spec, what, build in (
                (self.fault_config, "fault injection (fault_config)",
                 self.get_fault_injector),
                (self.codec_config, "update codecs (codec_config)",
                 self.get_codec)):
            if not spec:
                continue
            build()  # a bad spec fails here
            if self.execution == "streamed":
                raise ValueError(
                    f"{what} is only formulated for the dense round: the "
                    "streamed path never materialises the full (n, d) "
                    "matrix it needs; use execution='dense' (or 'auto' "
                    "within the dense budget)")
        if self.agg_domain not in ("f32", "wire"):
            raise ValueError(f"agg_domain must be 'f32' or 'wire', got "
                             f"{self.agg_domain!r}")
        if self.agg_domain != "wire":
            return
        codec = self.get_codec()
        if codec is None or not codec.supports_deferred:
            raise ValueError(
                "agg_domain='wire' needs a deferrable codec (identity or "
                "quant int8/int4): the defense statistics traverse the "
                f"packed wire payload, and "
                f"{'no codec' if codec is None else repr(codec.name)} has "
                "no packed-integer matrix to aggregate; set "
                ".communication(codec={'type': 'quant', ...}) or keep "
                "agg_domain='f32'")
        for knob, why, flip in (
                (self.fault_config, "fault injection",
                 ".fault_tolerance(faults=None)"),
                (self.health_check, "the in-round health check",
                 ".fault_tolerance(health_check=False)"),
                (self.forensics, "defense forensics",
                 ".observability(forensics=False)"),
                (self.dp_clip_threshold, "client DP",
                 "dp_clip_threshold=None")):
            if knob:
                raise ValueError(
                    f"agg_domain='wire' × {why} is an unsupported pair: "
                    "that stage rewrites/inspects dense f32 rows the "
                    f"wire domain never materializes — set {flip}, or run "
                    "under .communication(agg_domain='f32')")
        from blades_tpu_torch.parallel.streamed_geometry import (
            WIRE_AGGREGATORS,
        )

        agg = self.get_server().aggregator
        if not isinstance(agg, WIRE_AGGREGATORS):
            raise ValueError(
                f"aggregator {type(agg).__name__} has no wire-domain "
                "formulation (aggregate_wire covers "
                f"{sorted(c.__name__ for c in WIRE_AGGREGATORS)}); use "
                "agg_domain='f32'")

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

    def get_fault_injector(self):
        """The :class:`~blades_tpu_torch.faults.FaultInjector` of
        ``fault_config`` (None when off); its seed defaults to the trial
        seed, so a seed grid sweeps the failure realizations too."""
        if not self.fault_config:
            return None
        spec = dict(self.fault_config)
        spec.setdefault("seed", int(self.seed))
        return FaultInjector(**spec)

    def get_async_spec(self):
        """The :class:`~blades_tpu_torch.arrivals.AsyncSpec` of
        ``async_config`` (None unless ``execution="async"``); its seed
        defaults to the trial seed."""
        if self.execution != "async":
            return None
        from blades_tpu_torch.arrivals import AsyncSpec

        spec = dict(self.async_config or {})
        spec.setdefault("seed", int(self.seed))
        if spec.get("rate_schedule") is not None:
            spec["rate_schedule"] = tuple(
                tuple(p) for p in spec["rate_schedule"])
        return AsyncSpec(**spec)

    def get_codec(self):
        """The :class:`~blades_tpu_torch.comm.CodecConfig` of
        ``codec_config`` (None when off)."""
        if not self.codec_config:
            return None
        return get_codec(self.codec_config)

    def get_topology(self):
        """The gossip round's
        :class:`~blades_tpu_torch.topology.TopologyConfig` of
        ``topology_config`` (None unless ``execution="gossip"``), its
        ``num_nodes`` pinned to ``num_clients``: on the gossip path every
        client is a node."""
        if self.execution != "gossip":
            return None
        from blades_tpu_torch.topology import get_topology

        return get_topology(self.topology_config, int(self.num_clients))

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
        """The round, its ``client_packing`` request resolved against the
        model (a loud fallback under ``"auto"``, an error for a forced P
        that cannot run); the decision is kept for the sweep's
        summaries."""
        from blades_tpu_torch.parallel.packed import resolve_client_packing

        fr = FedRound(
            task=self.get_task_spec().build(), server=self.get_server(),
            adversary=self.get_adversary(),
            batch_size=self.train_batch_size,
            num_batches_per_round=self.num_batch_per_round,
            num_clients=self.num_clients, health_check=self.health_check,
            client_block=self.client_block,
            client_callbacks=self.get_client_callbacks(),
            dp_clip_threshold=self.dp_clip_threshold,
            dp_noise_factor=self.dp_noise_factor,
            faults=self.get_fault_injector(), codec=self.get_codec(),
            agg_domain=self.agg_domain, agg_d_chunk=self.d_chunk,
            stateless_clients=self.state_window == 0,
            forensics=bool(self.forensics))
        fr, self._packing_decision = resolve_client_packing(
            fr, self.client_packing, num_clients=self.num_clients,
            num_devices=getattr(self, "num_devices", None),
            execution=self.execution)
        return fr

    def build(self, device=None):
        """Validate, freeze and build the driver on ``device`` (``None`` =
        the card)."""
        self.validate()
        self.freeze()
        return self.algo_class(self, device=device)
