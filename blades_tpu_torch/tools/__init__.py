"""Offline tools of the port, each a ``python -m`` entry point that loads
no JAX (counterparts of the JAX package's ``tools/``):

- :mod:`~blades_tpu_torch.tools.replay_round`: re-run a flight-recorder
  dump's round through the port's driver and compare its digest bit for
  bit (``--action``: re-derive the journaled control actions);
- :mod:`~blades_tpu_torch.tools.validate_metrics`: schema-check
  ``metrics.jsonl`` streams (with the async-tick, mesh-row and gossip-row
  contracts), flight-recorder dumps, span traces, ledger checkpoints and
  data-store shard directories;
- :mod:`~blades_tpu_torch.tools.ledger_report`: fleet summary, suspects
  and per-client timelines of a client-ledger checkpoint;
- :mod:`~blades_tpu_torch.tools.control_report`: the control plane's
  action timeline, tallies and quarantine histories;
- :mod:`~blades_tpu_torch.tools.show_plan`: list, show and invalidate the
  autotuner's plan cache;
- :mod:`~blades_tpu_torch.tools.gossip_curves`: gossip against
  centralized convergence curves on a synthetic federation;
- :mod:`~blades_tpu_torch.tools.lint`: blades-lint over the port (host
  syncs in the round, raw clocks, uncounted collectives, raw traversals
  and decodes, schema drift, artifact stamps);
- :mod:`~blades_tpu_torch.tools.check_tier1_budget`: the tier-1 wall-time
  guard;
- :mod:`~blades_tpu_torch.tools.restamp_curves`: the completeness stamps of
  ``curves.json`` artifacts, recomputed from their rows.
"""
