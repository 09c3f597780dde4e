"""IID / Dirichlet client partitioning into stacked rectangular arrays
(counterpart of ``blades_tpu/data/partition.py``, numpy and bit-identical
to it for the same seed).

Replaces the reference's shard-construction logic
(ref: fllib/datasets/fldataset.py:159-228): ``iid`` is ``np.array_split``
over a shuffled index range, ``dirichlet`` draws per-class client
proportions from Dirichlet(alpha) with the same min-shard-size-10 rejection
loop (ref: fldataset.py:177-196).  The output is not a list of ragged
Subsets but a single padded ``(num_clients, max_shard, ...)`` array pair
plus per-client lengths — the rectangular layout ``vmap`` needs.

Everything here is host-side numpy: partitioning happens once at setup, the
arrays then live on the device for the whole run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

MIN_SHARD_SIZE = 10  # ref: fllib/datasets/fldataset.py:183 (min_size < 10 loop)


@dataclasses.dataclass
class Partition:
    """Per-client padded data shards.

    Attributes:
        x: ``(num_clients, max_shard, *feature_shape)`` padded inputs.
        y: ``(num_clients, max_shard)`` padded integer labels.
        lengths: ``(num_clients,)`` true shard sizes; entries past
            ``lengths[i]`` in row ``i`` are padding (copies of real rows, so
            accidental use skews statistics instead of crashing — but the
            samplers never index past ``lengths``).
    """

    x: np.ndarray
    y: np.ndarray
    lengths: np.ndarray

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def max_shard(self) -> int:
        return self.x.shape[1]


def iid_partition(
    num_samples: int, num_clients: int, seed: int = 0
) -> list[np.ndarray]:
    """Shuffle then evenly split indices (ref: fldataset.py:199-204)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_samples)
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
    min_size: int = MIN_SHARD_SIZE,
    max_tries: int = 1000,
) -> list[np.ndarray]:
    """Non-IID label-skew partition via Dirichlet(alpha) class proportions.

    Re-draws the whole partition until every client holds at least
    ``min_size`` samples — the reference's rejection loop
    (ref: fldataset.py:177-196).  Lower ``alpha`` = more skew.

    At giant-federation scale the rejection loop is hopeless: with ~50
    samples/client and alpha=0.1 a draw where all 1000 clients clear
    min_size=10 essentially never happens (the reference only ever ran 60
    clients).  After a bounded number of redraws the last draw is
    REPAIRED instead: starved clients take rows from the largest shards
    (never dragging a donor below ``min_size``), preserving the drawn
    skew everywhere else.  Deterministic per seed.
    """
    labels = np.asarray(labels)
    num_samples = labels.shape[0]
    if num_samples < num_clients * min_size:
        raise ValueError(
            f"{num_samples} samples cannot give {num_clients} clients "
            f"min_size={min_size} each"
        )
    classes = np.unique(labels)
    rng = np.random.default_rng(seed)
    # Rejection redraws are cheap at canonical scales (60 clients x 800+
    # samples: the first draw virtually always clears min_size) and futile
    # at giant ones (1000 clients x 50 samples: no draw ever does, and
    # 1000 doomed redraws cost ~25 s).  Bound redraws unless samples are
    # plentiful enough that rejection is the expected exit.
    tries = max_tries if num_samples // num_clients >= 10 * min_size else 20
    shards: list[np.ndarray] = []
    for _ in range(tries):
        idx_per_client: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.repeat(alpha, num_clients))
            # Balance cap: zero out clients already holding >= fair share
            # (ref: fldataset.py:185-188).
            sizes = np.array([sum(len(a) for a in parts) for parts in idx_per_client])
            props = np.where(sizes >= num_samples / num_clients, 0.0, props)
            if props.sum() <= 0:
                props = np.repeat(1.0 / num_clients, num_clients)
            else:
                props = props / props.sum()
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].append(part)
        shards = [np.sort(np.concatenate(p)) for p in idx_per_client]
        if min(len(s) for s in shards) >= min_size:
            return shards
    # Repair the final draw: move rows from the largest shards into the
    # starved ones.
    sizes = np.array([len(s) for s in shards])
    while sizes.min() < min_size:
        small = int(sizes.argmin())
        big = int(sizes.argmax())
        need = min(min_size - sizes[small], sizes[big] - min_size)
        if need <= 0:
            break  # donors exhausted (can't happen given the total check)
        donor = shards[big]
        give = rng.choice(len(donor), size=need, replace=False)
        keep = np.ones(len(donor), dtype=bool)
        keep[give] = False
        shards[small] = np.sort(np.concatenate([shards[small], donor[give]]))
        shards[big] = donor[keep]
        sizes[small] += need
        sizes[big] -= need
    return shards


def partition_dataset(
    x: np.ndarray,
    y: np.ndarray,
    num_clients: int,
    *,
    iid: bool = True,
    alpha: float = 0.1,
    seed: int = 0,
    max_shard: Optional[int] = None,
) -> Partition:
    """Partition ``(x, y)`` into a padded :class:`Partition`.

    Padding replicates each client's own rows cyclically, so every row is a
    real sample from that client's shard; ``lengths`` marks the true sizes.
    ``max_shard`` can force a common shard capacity (e.g. across train/test).
    """
    if iid:
        shards = iid_partition(len(x), num_clients, seed)
    else:
        shards = dirichlet_partition(y, num_clients, alpha, seed)
    cap = max_shard or max(len(s) for s in shards)
    xs = np.empty((num_clients, cap) + x.shape[1:], dtype=x.dtype)
    ys = np.empty((num_clients, cap), dtype=y.dtype)
    lengths = np.empty((num_clients,), dtype=np.int32)
    for i, s in enumerate(shards):
        reps = np.resize(s, cap)  # cyclic pad with the client's own indices
        xs[i] = x[reps]
        ys[i] = y[reps]
        lengths[i] = min(len(s), cap)
    return Partition(x=xs, y=ys, lengths=lengths)


def partition_proportions(partition: Partition, labels_per_class: int) -> np.ndarray:
    """Per-client class histograms ``(num_clients, num_classes)`` for tests."""
    out = np.zeros((partition.num_clients, labels_per_class), dtype=np.int64)
    for i in range(partition.num_clients):
        n = partition.lengths[i]
        vals, counts = np.unique(partition.y[i, :n], return_counts=True)
        out[i, vals] = counts
    return out
