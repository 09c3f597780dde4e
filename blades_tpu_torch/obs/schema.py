"""Round-record schema for the structured metrics pipeline (counterpart
of ``blades_tpu/obs/schema.py``, field for field: the port's rows carry
no key the JAX package's schema lacks, so each package's validator reads
the other's streams; fields only the JAX package stamps stay registered).

One JSONL record per FL round (the Tune ``result.json`` row enriched with
defense forensics).  The schema is deliberately STRICT — unknown top-level
keys are rejected — so that adding a new metric without registering it
here fails a fast tier-1 test instead of silently drifting the on-disk
format every downstream consumer (visualize, BENCH graders, dashboards)
parses.

Hand-rolled on purpose: the image has no ``jsonschema`` and the record
shape is flat enough that a table of ``name -> (types, required)`` plus
two nested checks (``timers``, ``lane_forensics``) covers it.

Validate a stream from the CLI::

    python -m blades_tpu_torch.obs.schema path/to/metrics.jsonl
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

_NUM = (int, float)

# name -> (allowed value types, required)
ROUND_RECORD_FIELDS: Dict[str, Tuple[tuple, bool]] = {
    # identity
    "experiment": ((str,), True),
    "trial": ((str,), True),
    "training_iteration": ((int,), True),
    # lane knobs (tune/lanes.py stamps each laned row with its overrides
    # via the DYNAMIC `lane_overrides[i].items()` path — invisible to the
    # static schema-drift stamp scan, hence the per-line pragmas).
    "seed": ((int,), False),
    "client_lr": (_NUM, False),  # blades-lint: disable=schema-drift — stamped dynamically via lane_overrides (tune/lanes.py)
    "server_lr": (_NUM, False),  # blades-lint: disable=schema-drift — stamped dynamically via lane_overrides (tune/lanes.py)
    "dp_epsilon": (_NUM, False),  # blades-lint: disable=schema-drift — stamped dynamically via lane_overrides (tune/lanes.py)
    "dp_clip_threshold": (_NUM, False),  # blades-lint: disable=schema-drift — stamped dynamically via lane_overrides (tune/lanes.py)
    "dp_noise_factor": (_NUM, False),  # blades-lint: disable=schema-drift — stamped dynamically via lane_overrides (tune/lanes.py)
    "adversary_scale": (_NUM, False),  # blades-lint: disable=schema-drift — stamped dynamically via lane_overrides (tune/lanes.py)
    # training metrics (core/round.py).  Optional: the sweep runner logs
    # whatever the trainable returns, and a custom/mock trainable may not
    # report a loss — strictness lives in the unknown-key rejection.
    "train_loss": (_NUM, False),
    "agg_norm": (_NUM, False),
    "update_norm_mean": (_NUM, False),
    # evaluation (core/round.py::evaluate)
    "test_loss": (_NUM, False),
    "test_acc": (_NUM, False),
    "test_acc_top3": (_NUM, False),
    # health (core/health.py)
    "num_unhealthy": ((int,), False),
    "round_ok": ((bool,), False),
    # chaos layer (blades_tpu_torch/faults): per-round participation telemetry.
    # When these are present, the detection metrics below are CONDITIONED
    # on participation — byz_precision/recall/fpr score only the lanes
    # that delivered an update this round (a dropped malicious client was
    # neither caught nor missed).
    "num_participating": ((int,), False),
    "num_straggled": ((int,), False),
    "num_dropped": ((int,), False),
    "fault_seed": ((int,), False),
    # Buffered-async execution (blades_tpu_torch/arrivals): per-cycle ingest
    # telemetry, stamped host-side by the driver.  Rows are TICK-indexed
    # on top of round-indexed: `tick` is the virtual arrival clock when
    # the aggregation fired (training_iteration stays the server round /
    # model version).  staleness_* summarize the aggregated buffer's
    # staleness k = server_version - version each row was computed
    # against; the SYNC straggler path stamps the same staleness_mean/
    # staleness_max so sync-vs-async rows compare in one schema.
    # staleness_hist is the bucket counts [k=0, ..., k=H, k>H]
    # (list-typed; the CSV sink skips it like watchdog_events).
    # buffer_fill is the pending-event occupancy after the cycle;
    # buffer_overflow / arrivals_dropped are cumulative full-buffer and
    # chaos-dropout losses; updates_per_sec is the wall-clock ingest
    # rate (the ONE non-replayable field — excluded from
    # flightrec.REPLAY_FIELDS); arrival_seed pins the traffic
    # realization like fault_seed pins the failure process.
    "tick": ((int,), False),
    "staleness_mean": (_NUM, False),
    "staleness_max": ((int,), False),
    "staleness_hist": ((list,), False),
    "buffer_fill": ((int,), False),
    "buffer_overflow": ((int,), False),
    "arrivals_dropped": ((int,), False),
    "updates_per_sec": (_NUM, False),
    "arrival_seed": ((int,), False),
    # cycle_ticks is the DETERMINISTIC ingest sensor: virtual ticks the
    # arrival process consumed filling this cycle's aggregation buffer
    # (pure in (arrival_seed, tick), unlike updates_per_sec) — the
    # ingest_stall watchdog rule and with it the control plane's
    # buffer-growth response key off it.  arrivals_quarantined is the
    # cumulative count of arrivals dropped at ingest because their
    # client sat in the controller's quarantine set.
    "cycle_ticks": ((int,), False),
    "arrivals_quarantined": ((int,), False),
    # Out-of-core per-client state (blades_tpu_torch/state): participation-
    # window staging telemetry, stamped host-side by the driver on
    # windowed (and async out-of-core) rounds.  state_store names the
    # backend holding the off-cohort rows ("resident"|"host"|"disk"),
    # cohort_size the per-round participation window (the async event
    # batch under execution="async"), state_stage_ms the wall time the
    # staging job spent gathering the cohort (measured via the span
    # layer's sanctioned clock — like updates_per_sec, the one
    # non-replayable slice), state_bytes_staged the host->device bytes
    # it moved, and state_peak_hbm_bytes the analytic ceiling on
    # device-resident per-client state (store-held bytes + the staged/
    # live/write-back cohort slots) — window-proportional by
    # construction, never O(n_registered * d).
    "state_store": ((str,), False),
    "cohort_size": ((int,), False),
    "state_stage_ms": (_NUM, False),
    "state_bytes_staged": ((int,), False),
    "state_peak_hbm_bytes": ((int,), False),
    # Out-of-core TRAINING DATA (blades_tpu_torch/data/store.py): the data-
    # plane twin of the state block above, stamped host-side whenever a
    # DataStore serves the cohort gathers.  data_store names the backend
    # holding the partition ("resident"|"memmap"), data_stage_ms the
    # wall time the last cohort gather spent assembling rows (the same
    # sanctioned-clock caveat as state_stage_ms), data_bytes_staged the
    # bytes that gather moved, and eval_chunks how many device-sized
    # chunks the streaming evaluator dispatched (stamped on eval rounds
    # under data_store="memmap"; the monolithic evaluator never sets it).
    "data_store": ((str,), False),
    "data_stage_ms": (_NUM, False),
    "data_bytes_staged": ((int,), False),
    "eval_chunks": ((int,), False),
    # comm subsystem (blades_tpu_torch/comm): per-round uplink byte accounting
    # for compressed-update codecs.  comm_bytes_up is the client->server
    # wire payload (reconciled against parallel/comm_model.uplink_bytes),
    # codec_bits the per-coordinate wire width, and the ratio is dense-
    # f32 bytes over comm_bytes_up.
    "comm_bytes_up": ((int,), False),
    "codec_bits": ((int,), False),
    "comm_compression_ratio": (_NUM, False),
    # Wire-domain aggregation (agg_domain="wire"): which domain the
    # defense statistics ran in ("f32" | "wire"), the storage width of
    # the matrix they traversed (32 = dense f32; 8 = packed int8 wire
    # payload — int4 codec values ride int8 storage, so their wire width
    # lives in codec_bits while agg_domain_bits stays 8), and the
    # decode honesty counter: full-width f32 rows materialized from the
    # packed payload this round (selected/reduced slices + the forge's
    # sanctioned full read).  Stamped host-side whenever a codec is
    # configured (agg_domain/agg_domain_bits) / whenever the wire round
    # ran (dequant_rows).
    "agg_domain": ((str,), False),
    "agg_domain_bits": ((int,), False),
    "dequant_rows": ((int,), False),
    # Client lane-packing (parallel/packed.py): static per-round
    # provenance stamped host-side when the dense round runs P clients
    # per grouped-kernel vmap lane.  pack_factor = clients per lane,
    # packed_lanes = n / pack_factor dispatch lanes.  Absent on unpacked
    # runs (including "auto" fallbacks, whose reason lands in the sweep
    # summary's "packing" block instead).
    "pack_factor": ((int,), False),
    "packed_lanes": ((int,), False),
    # Malicious-lane training elision (streamed/d-sharded paths): lanes
    # whose training was skipped this round.  Surfaced so the optimistic
    # num_unhealthy basis — elided lanes can never trip health counters —
    # is visible in telemetry.
    "elided_lanes": ((int,), False),
    # Row-geometry pass fusion (parallel/streamed_geometry.py): planned
    # full-matrix HBM traversals the streamed row-geometry finish runs
    # this round under the fused pass plan, vs what the
    # one-traversal-per-statistic baseline would run.  Static per config
    # (data-dependent Weiszfeld loops count their maxiter bound), so the
    # fused/unfused ratio is visible in metrics.jsonl without a card.
    "hbm_passes": ((int,), False),
    "hbm_passes_unfused": ((int,), False),
    # Pod-scale hierarchical round (parallel/hier.py): per-round ICI
    # wire bytes (trace-time static — counted on the PassRecorder while
    # the round program was built, reconciled both ways against
    # parallel/comm_model.hier_round_volumes), the pre-aggregated
    # matrix height the global defense actually saw, and the engaged
    # (clients, d) device layout as "CxD".
    "ici_bytes": ((int,), False),
    "preagg_kept": ((int,), False),
    "mesh_shape": ((str,), False),
    # Decentralized gossip round (blades_tpu_torch/topology): graph provenance
    # (family name, random-family seed, spectral gap of the mixing
    # matrix — static per run), the neighborhood-exchange ICI bytes
    # (trace-time static, reconciled both ways against
    # parallel/comm_model.gossip_round_volumes), the consensus diameter
    # over round-input replicas, and how many nodes fell below their
    # aggregator's breakdown bound after edge dropout this round.
    "topology": ((str,), False),
    "graph_seed": ((int,), False),
    "spectral_gap": (_NUM, False),
    "gossip_ici_bytes": ((int,), False),
    "num_partitioned_nodes": ((int,), False),
    "consensus_dist": (_NUM, False),
    # perf layer (blades_tpu_torch/perf): AOT executable-cache traffic,
    # cumulative per trial — a trial whose round program was served from
    # the cache reports misses == 0 from its first row.
    "compile_cache_hits": ((int,), False),
    "compile_cache_misses": ((int,), False),
    # Execution autotuner (perf/autotune.py): the plan this round ran
    # under (plan_id, compact knob encoding) and how it was selected —
    # served from the persistent plan cache (autotune_cache_hit),
    # measured vs the deterministic heuristic fallback (autotune_timed),
    # over how many enumerated candidates.  Static per trial; the full
    # per-candidate timing breakdown rides the sweep summary's
    # "autotune" block.  Absent on untuned runs.
    "plan_id": ((str,), False),
    "autotune_cache_hit": ((bool,), False),
    "autotune_timed": ((bool,), False),
    "autotune_candidates": ((int,), False),
    # Anomaly watchdog (obs/watchdog.py): host-side rule evaluations
    # over this row — a list of event dicts (rule, kind, field, round,
    # value, limit, message).  Present only on rounds where an armed
    # watchdog fired; list-typed, so the CSV sink skips it like the
    # nested dicts.
    "watchdog_events": ((list,), False),
    # Closed-loop control plane (blades_tpu_torch/control): journaled
    # controller decisions for this round.  control_actions is the list
    # of action dicts (seq, round, tick, rule, actuator, old, new,
    # clients, until, pre, message — list-typed, CSV sink skips it);
    # control_actions_total the cumulative journal length (monotone,
    # replay-comparable); quarantine_size the post-step quarantine set
    # size.  Present only on controller-armed rounds.
    "control_actions": ((list,), False),
    "control_actions_total": ((int,), False),
    "quarantine_size": ((int,), False),
    # defense forensics (obs/forensics.py)
    "byz_precision": (_NUM, False),
    "byz_recall": (_NUM, False),
    "byz_fpr": (_NUM, False),
    "num_flagged": ((int,), False),
    "lane_forensics": ((dict,), False),
    # Client-lifetime ledger (obs/ledger.py): fleet-level longitudinal
    # telemetry stamped host-side on ledger-armed rounds.
    # suspected_fraction = seen clients whose lifetime flag rate
    # exceeds 0.5; flagged_churn = cohort clients whose flag status
    # flipped vs their OWN previous participation; reputation_p* are
    # percentiles of (1 - lifetime flag rate) over seen clients —
    # reputation_collapse / flagger_churn watchdog rules watch them.
    # ledger_top_suspects is list-typed (client ids; the CSV sink
    # skips it like watchdog_events).
    "suspected_fraction": (_NUM, False),
    "flagged_churn": ((int,), False),
    "reputation_p10": (_NUM, False),
    "reputation_p50": (_NUM, False),
    "reputation_p90": (_NUM, False),
    "ledger_clients_seen": ((int,), False),
    "ledger_top_suspects": ((list,), False),
    # host-side timings (utils/timers.py)
    "timers": ((dict,), False),
}

# lane_forensics sub-keys -> allowed element types.  `clients` is the
# round's cohort id-vector: lane i of every other array diagnoses
# registered client clients[i] (dense full-participation rounds stamp
# the identity arange, so pre-cohort consumers read unchanged).
# `update_norms` are the per-lane post-corruption update L2 norms the
# ledger folds into its longitudinal running stats.
_LANE_FIELDS: Dict[str, tuple] = {
    "benign_mask": (bool,),
    "healthy": (bool,),
    "scores": _NUM,
    "clients": (int,),
    "update_norms": _NUM,
}


class SchemaError(ValueError):
    """A metrics record that does not match :data:`ROUND_RECORD_FIELDS`."""


def _type_ok(value: Any, types: tuple) -> bool:
    # bool is an int subclass; only accept it where bool is explicitly
    # allowed (a True leaking into train_loss is a bug, not a number).
    if isinstance(value, bool):
        return bool in types
    return isinstance(value, types)


def validate_record(record: Any) -> Dict[str, Any]:
    """Validate one round record; returns it unchanged or raises
    :class:`SchemaError` naming every violation at once."""
    if not isinstance(record, dict):
        raise SchemaError(f"record must be a dict, got {type(record).__name__}")
    problems: List[str] = []
    unknown = sorted(set(record) - set(ROUND_RECORD_FIELDS))
    if unknown:
        problems.append(
            f"unknown keys {unknown} (register new metrics in "
            "blades_tpu_torch/obs/schema.py::ROUND_RECORD_FIELDS)"
        )
    for name, (types, required) in ROUND_RECORD_FIELDS.items():
        if name not in record:
            if required:
                problems.append(f"missing required key {name!r}")
            continue
        if not _type_ok(record[name], types):
            problems.append(
                f"{name!r} must be {'/'.join(t.__name__ for t in types)}, "
                f"got {type(record[name]).__name__}"
            )
    lanes = record.get("lane_forensics")
    if isinstance(lanes, dict):
        problems.extend(_validate_lanes(lanes))
    timers = record.get("timers")
    if timers is not None and isinstance(timers, dict):
        for phase, stats in timers.items():
            if not isinstance(stats, dict):
                problems.append(f"timers[{phase!r}] must be a dict")
    events = record.get("watchdog_events")
    if isinstance(events, list):
        for i, ev in enumerate(events):
            if not isinstance(ev, dict):
                problems.append(f"watchdog_events[{i}] must be a dict")
    actions = record.get("control_actions")
    if isinstance(actions, list):
        for i, act in enumerate(actions):
            if not isinstance(act, dict):
                problems.append(f"control_actions[{i}] must be a dict")
            elif not {"seq", "actuator", "rule"} <= set(act):
                problems.append(
                    f"control_actions[{i}] must carry seq/actuator/rule")
    hist = record.get("staleness_hist")
    if isinstance(hist, list):
        for i, v in enumerate(hist):
            if not _type_ok(v, (int,)):
                problems.append(f"staleness_hist[{i}] must be an int "
                                f"bucket count, got {type(v).__name__}")
    suspects = record.get("ledger_top_suspects")
    if isinstance(suspects, list):
        for i, v in enumerate(suspects):
            if not _type_ok(v, (int,)):
                problems.append(f"ledger_top_suspects[{i}] must be an "
                                f"int client id, got {type(v).__name__}")
    if problems:
        raise SchemaError("; ".join(problems))
    return record


def _validate_lanes(lanes: Dict[str, Any]) -> List[str]:
    problems: List[str] = []
    unknown = sorted(set(lanes) - set(_LANE_FIELDS))
    if unknown:
        problems.append(f"unknown lane_forensics keys {unknown}")
    lengths = set()
    for name, types in _LANE_FIELDS.items():
        vals = lanes.get(name)
        if vals is None:
            continue
        if not isinstance(vals, list):
            problems.append(f"lane_forensics[{name!r}] must be a list")
            continue
        lengths.add(len(vals))
        if not all(_type_ok(v, types) for v in vals):
            problems.append(
                f"lane_forensics[{name!r}] elements must be "
                f"{'/'.join(t.__name__ for t in types)}"
            )
    if len(lengths) > 1:
        problems.append(
            f"lane_forensics arrays disagree on lane count: {sorted(lengths)}"
        )
    return problems


def validate_jsonl(
    path, max_errors: Optional[int] = None
) -> Tuple[int, List[Tuple[int, str]]]:
    """Validate every line of a JSONL metrics stream.

    Returns ``(num_valid, errors)`` where ``errors`` is a list of
    ``(1-based line number, message)``.  A torn final line (a killed run)
    is reported like any other violation; its message is a
    ``json.JSONDecodeError`` string, distinguishable from the
    :class:`SchemaError` messages validation produces.
    """
    errors: List[Tuple[int, str]] = []
    num_valid = 0
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                validate_record(json.loads(line))
                num_valid += 1
            except (json.JSONDecodeError, SchemaError) as exc:
                errors.append((lineno, str(exc)))
                if max_errors is not None and len(errors) >= max_errors:
                    break
    return num_valid, errors


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.obs.schema",
        description="validate a metrics.jsonl stream against the round-record schema",
    )
    p.add_argument("paths", nargs="+")
    args = p.parse_args(argv)
    rc = 0
    for path in args.paths:
        num_valid, errors = validate_jsonl(path)
        print(f"{path}: {num_valid} valid record(s), {len(errors)} error(s)")
        for lineno, msg in errors:
            print(f"  line {lineno}: {msg}")
            rc = 1
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
