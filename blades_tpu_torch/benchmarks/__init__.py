"""Standalone training sanity baselines and robustness grids of the port
(counterpart of ``blades_tpu/benchmarks``): :mod:`.main` (centralized
training) and :mod:`.accuracy_curves` (robust accuracy against the number
of malicious clients)."""
