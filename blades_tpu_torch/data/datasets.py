"""Dataset catalog: MNIST / FashionMNIST / CIFAR-10 / CIFAR-100 + custom
registration (counterpart of ``blades_tpu/data/datasets.py``, numpy and
bit-identical to it for the same seed).

Each built-in loads the standard raw files from a local cache when present
(``BLADES_TPU_DATA_ROOT``, default ``~/.blades_tpu/data``; nothing is ever
downloaded) and otherwise falls back to a *deterministic synthetic* dataset
with the real shapes and label structure, marked by ``FLDataset.synthetic``.

Normalisation happens here (host, once); CIFAR train-time augmentation
(random crop + flip) is :func:`blades_tpu_torch.data.augment.random_crop_flip`,
applied per batch inside local training (``TaskSpec(augment="cifar")``).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import zlib
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from blades_tpu_torch.data.partition import Partition, partition_dataset


def data_root() -> Path:
    return Path(os.environ.get("BLADES_TPU_DATA_ROOT", "~/.blades_tpu/data")).expanduser()


@dataclasses.dataclass
class FLDataset:
    """A federated dataset: partitioned train shards + shared test set.

    One padded train :class:`Partition` and the global test arrays;
    per-client test shards are a second Partition (evaluation is
    per-client on the client test splits).
    """

    name: str
    train: Partition
    test_x: np.ndarray
    test_y: np.ndarray
    test: Optional[Partition]
    num_classes: int
    input_shape: Tuple[int, ...]
    synthetic: bool = False

    @property
    def num_clients(self) -> int:
        return self.train.num_clients


# ---------------------------------------------------------------------------
# Raw-file readers (standard formats, no torchvision)
# ---------------------------------------------------------------------------


def _read_idx(path: Path) -> np.ndarray:
    """Parse an (optionally gzipped) IDX file (MNIST's native format)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find(root: Path, names) -> Optional[Path]:
    for n in names:
        for cand in (root / n, root / (n + ".gz")):
            if cand.exists():
                return cand
    return None


def _load_mnist_like(subdir: str) -> Optional[Tuple[np.ndarray, ...]]:
    root = data_root() / subdir
    paths = [
        _find(root, ["train-images-idx3-ubyte"]),
        _find(root, ["train-labels-idx1-ubyte"]),
        _find(root, ["t10k-images-idx3-ubyte"]),
        _find(root, ["t10k-labels-idx1-ubyte"]),
    ]
    if any(p is None for p in paths):
        return None
    tx, ty, vx, vy = (_read_idx(p) for p in paths)
    return tx, ty.astype(np.int32), vx, vy.astype(np.int32)


def _load_cifar10() -> Optional[Tuple[np.ndarray, ...]]:
    root = data_root() / "cifar10" / "cifar-10-batches-py"
    if not root.exists():
        root = data_root() / "cifar-10-batches-py"
    if not root.exists():
        return None

    def read_batch(p: Path):
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.array(d[b"labels"], np.int32)

    train = [read_batch(root / f"data_batch_{i}") for i in range(1, 6)]
    tx = np.concatenate([b[0] for b in train])
    ty = np.concatenate([b[1] for b in train])
    vx, vy = read_batch(root / "test_batch")
    return tx, ty, vx, vy


def _load_cifar100() -> Optional[Tuple[np.ndarray, ...]]:
    """CIFAR-100 python pickles (``cifar-100-python/{train,test}`` with
    ``fine_labels``).  Not in the reference's catalog, but named by the
    benchmark targets (BASELINE.json config 5: CIFAR-100/ResNet-34)."""
    root = data_root() / "cifar100" / "cifar-100-python"
    if not root.exists():
        root = data_root() / "cifar-100-python"
    if not root.exists():
        return None

    def read_split(p: Path):
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.array(d[b"fine_labels"], np.int32)

    tx, ty = read_split(root / "train")
    vx, vy = read_split(root / "test")
    return tx, ty, vx, vy


def _synthetic_classification(
    n_train: int,
    n_test: int,
    input_shape: Tuple[int, ...],
    num_classes: int,
    seed: int,
    noise: float = 0.5,
) -> Tuple[np.ndarray, ...]:
    """Deterministic learnable synthetic data: class-dependent means + noise.

    Each class c gets a fixed random direction mu_c; samples are
    ``mu_c + noise * eps`` so simple models reach high accuracy quickly —
    which is what integration tests need (the reference's SimpleDataset
    plays the same role, ref: blades/algorithms/fedavg/tests/test_fedavg.py:26-55).

    ``noise`` (default 0.5, the historical value) is the difficulty dial:
    at 0.5 the task is so separable that no update-forging attack can
    dent any aggregator; the robustness harness
    (:mod:`blades_tpu.benchmarks.accuracy_curves`) raises it (Bayes error
    grows with ``noise``) so attack/defense orderings become visible.
    """
    rng = np.random.default_rng(seed)
    mus = rng.normal(0.0, 1.0, size=(num_classes,) + input_shape).astype(np.float32)

    def make(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        x = mus[y] + noise * rng.normal(0.0, 1.0, size=(n,) + input_shape).astype(np.float32)
        return x.astype(np.float32), y

    tx, ty = make(n_train)
    vx, vy = make(n_test)
    return tx, ty, vx, vy, mus


def _heterogenize_partition(
    train: Partition,
    mus: np.ndarray,
    noise: float,
    heterogeneity: float,
    seed: int,
) -> None:
    """Per-client FEATURE heterogeneity for the synthetic fallback.

    On the homogeneous synthetic stand-in every benign client estimates the same class means, so benign updates cluster
    tightly and ALIE's forged rows (mean + z*std of that narrow spread)
    stay separable by sign/cluster statistics — the filtering defenses
    never collapse the way the published CIFAR-10 figure shows.  Real
    non-IID CIFAR adds feature-level client drift on top of Dirichlet
    label skew; this reproduces that drift: client ``i``'s samples of
    class ``c`` are redrawn in place as

        mu_c + h * delta_{i,c} + noise * exp(h/2 * g_i) * eps

    where ``delta_{i,c}`` is a fixed per-(client, class) random mean
    shift (each client sees its OWN version of every class),
    ``g_i ~ N(0,1)`` jitters the per-client noise scale log-normally,
    and ``h`` is the single dial.  ``h=0`` is a no-op (the historical
    generator).  Labels — and therefore the Dirichlet skew — are
    untouched; padding rows stay cyclic copies of the client's own real
    rows.  Deterministic per seed.
    """
    if heterogeneity <= 0.0:
        return
    base = np.random.default_rng(seed)
    cap = train.max_shard
    for i in range(train.num_clients):
        ri = np.random.default_rng(base.integers(2**31))
        delta = ri.normal(0.0, heterogeneity, size=mus.shape).astype(np.float32)
        sigma_i = noise * np.exp(0.5 * heterogeneity * ri.normal())
        n_i = int(train.lengths[i])
        y_i = train.y[i, :n_i]
        eps = ri.normal(0.0, 1.0, size=(n_i,) + mus.shape[1:]).astype(np.float32)
        xi = mus[y_i] + delta[y_i] + np.float32(sigma_i) * eps
        reps = np.resize(np.arange(n_i), cap)
        train.x[i] = xi[reps]


# ---------------------------------------------------------------------------
# Built-in dataset builders
# ---------------------------------------------------------------------------

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
FMNIST_MEAN, FMNIST_STD = 0.286, 0.353
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)


def _norm_gray(x: np.ndarray, mean: float, std: float) -> np.ndarray:
    return ((x.astype(np.float32) / 255.0) - mean) / std


def _build_image_dataset(
    name: str,
    loader: Callable[[], Optional[Tuple[np.ndarray, ...]]],
    normalize: Callable[[np.ndarray], np.ndarray],
    input_shape: Tuple[int, ...],
    num_classes: int,
    num_clients: int,
    iid: bool,
    alpha: float,
    seed: int,
    train_frac: float,
    synth_train: int,
    synth_test: int,
    synth_noise: float = 0.5,
    synth_heterogeneity: float = 0.0,
) -> FLDataset:
    raw = loader()
    synthetic = raw is None
    mus = None
    if synthetic:
        # Process-stable, caller-seed-dependent (str hash is randomized).
        synth_seed = (zlib.crc32(name.encode()) ^ (seed * 0x9E3779B1)) % (2**31)
        # Giant federations: keep the real datasets' per-client density
        # (~50 train / ~10 test rows per client at n=1000 on CIFAR-10)
        # instead of starving 1000 clients on a fixed 5000-sample stand-in.
        synth_train = max(synth_train, num_clients * 50)
        synth_test = max(synth_test, num_clients * 10)
        tx, ty, vx, vy, mus = _synthetic_classification(
            synth_train, synth_test, input_shape, num_classes,
            seed=synth_seed, noise=synth_noise,
        )
    else:
        tx, ty, vx, vy = raw
        tx, vx = normalize(tx), normalize(vx)
        if tx.shape[1:] != input_shape:
            tx = tx.reshape((-1,) + input_shape)
            vx = vx.reshape((-1,) + input_shape)
    if not (0.0 < train_frac <= 1.0):
        raise ValueError(f"train_frac must be in (0, 1], got {train_frac}")
    if train_frac < 1.0:
        # Subsample the TRAIN pool before partitioning (a seeded random
        # subset, like the reference's random dataset subsetting) — the
        # data-scarcity dial: train on a fraction of the data, evaluate
        # on the full test set.
        rng = np.random.default_rng(seed ^ 0xF4AC)
        keep = rng.choice(len(ty), size=max(1, int(len(ty) * train_frac)),
                          replace=False)
        tx, ty = tx[np.sort(keep)], ty[np.sort(keep)]
    train = partition_dataset(tx, ty, num_clients, iid=iid, alpha=alpha, seed=seed)
    if synthetic and synth_heterogeneity > 0.0:
        # Per-client class-conditional mean shifts + noise-scale jitter
        # on top of the Dirichlet label skew (see _heterogenize_partition).
        _heterogenize_partition(train, mus, synth_noise, synth_heterogeneity,
                                seed=synth_seed ^ 0x5EED)
    test = partition_dataset(vx, vy, num_clients, iid=True, seed=seed + 1)
    return FLDataset(
        name=name,
        train=train,
        test_x=vx,
        test_y=vy,
        test=test,
        num_classes=num_classes,
        input_shape=input_shape,
        synthetic=synthetic,
    )


def build_mnist(num_clients=60, iid=True, alpha=0.1, seed=0, **kw) -> FLDataset:
    return _build_image_dataset(
        "mnist", _load_mnist_like_factory("mnist"),
        lambda x: _norm_gray(x, MNIST_MEAN, MNIST_STD)[..., None],
        (28, 28, 1), 10, num_clients, iid, alpha, seed,
        kw.get("train_frac", 1.0), 6000, 1000,
        synth_noise=kw.get("synthetic_noise", 0.5),
        synth_heterogeneity=kw.get("synthetic_heterogeneity", 0.0),
    )


def build_fashionmnist(num_clients=60, iid=True, alpha=0.1, seed=0, **kw) -> FLDataset:
    return _build_image_dataset(
        "fashionmnist", _load_mnist_like_factory("fashionmnist"),
        lambda x: _norm_gray(x, FMNIST_MEAN, FMNIST_STD)[..., None],
        (28, 28, 1), 10, num_clients, iid, alpha, seed,
        kw.get("train_frac", 1.0), 6000, 1000,
        synth_noise=kw.get("synthetic_noise", 0.5),
        synth_heterogeneity=kw.get("synthetic_heterogeneity", 0.0),
    )


def build_cifar10(num_clients=60, iid=True, alpha=0.1, seed=0, **kw) -> FLDataset:
    def norm(x):
        return ((x.astype(np.float32) / 255.0) - CIFAR_MEAN) / CIFAR_STD

    return _build_image_dataset(
        "cifar10", _load_cifar10, norm,
        (32, 32, 3), 10, num_clients, iid, alpha, seed,
        kw.get("train_frac", 1.0), 5000, 1000,
        synth_noise=kw.get("synthetic_noise", 0.5),
        synth_heterogeneity=kw.get("synthetic_heterogeneity", 0.0),
    )


def build_cifar100(num_clients=60, iid=True, alpha=0.1, seed=0, **kw) -> FLDataset:
    def norm(x):
        return ((x.astype(np.float32) / 255.0) - CIFAR100_MEAN) / CIFAR100_STD

    return _build_image_dataset(
        "cifar100", _load_cifar100, norm,
        (32, 32, 3), 100, num_clients, iid, alpha, seed,
        kw.get("train_frac", 1.0), 5000, 1000,
        synth_noise=kw.get("synthetic_noise", 0.5),
        synth_heterogeneity=kw.get("synthetic_heterogeneity", 0.0),
    )


def _load_mnist_like_factory(subdir: str):
    return lambda: _load_mnist_like(subdir)


# ---------------------------------------------------------------------------
# Catalog (ref: fllib/datasets/catalog.py)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., FLDataset]] = {
    "mnist": build_mnist,
    "fashionmnist": build_fashionmnist,
    "cifar10": build_cifar10,
    "cifar100": build_cifar100,
}


def register_dataset(name: str, builder: Callable[..., FLDataset]) -> None:
    """Register a custom dataset builder
    (ref: fllib/datasets/catalog.py:90-100)."""
    _REGISTRY[name.lower()] = builder


class DatasetCatalog:
    """String → :class:`FLDataset` resolution (ref: catalog.py:46-88)."""

    @staticmethod
    def get_dataset(spec, **overrides) -> FLDataset:
        if isinstance(spec, FLDataset):
            return spec
        if isinstance(spec, str):
            spec = {"type": spec}
        cfg = {**dict(spec), **overrides}
        name = cfg.pop("type").lower()
        if name not in _REGISTRY:
            raise KeyError(f"unknown dataset {name!r}; known: {sorted(_REGISTRY)}")
        cfg.pop("custom_dataset_config", None)
        return _REGISTRY[name](**cfg)
