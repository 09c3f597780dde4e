"""Experiment sweeps (counterpart of ``blades_tpu/tune/``): YAML
experiment files, read by the port's own reader
(:mod:`~blades_tpu_torch.tune.yaml_subset`), ``grid_search`` expansion and
the sequential trial runner with its result rows, checkpoints and
resume."""

from blades_tpu_torch.tune.sweep import (  # noqa: F401
    expand_grid,
    load_experiments_from_file,
    run_experiments,
    verify_result_rounds,
)
