"""Out-of-core per-client state, the participation-window store
(counterpart of ``blades_tpu/state``): :mod:`.store` holds the backends
and their shard checkpoints, :mod:`.prefetch` the double-buffered staging
of the next cohort.  Configure with ``FedavgConfig().resources(
state_store=..., window=...)``."""

from blades_tpu_torch.state.prefetch import StagedCohort, StatePrefetcher
from blades_tpu_torch.state.store import (
    COHORT_KEY_FOLD,
    STORE_BACKENDS,
    ClientStateStore,
    DiskStore,
    HostStore,
    ResidentStore,
    StateStoreError,
    StoreStats,
    client_state_template,
    cohort_seed,
    make_store,
    read_checkpoint_rows,
    sample_cohort,
)

__all__ = [
    "COHORT_KEY_FOLD", "STORE_BACKENDS", "ClientStateStore", "DiskStore",
    "HostStore", "ResidentStore", "StagedCohort", "StatePrefetcher",
    "StateStoreError", "StoreStats", "client_state_template", "cohort_seed",
    "make_store", "read_checkpoint_rows", "sample_cohort",
]
