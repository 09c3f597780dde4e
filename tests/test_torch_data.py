"""The port's data layer (blades_tpu_torch/data/) against the JAX package's
(blades_tpu/data/).

Partitions and the synthetic datasets are numpy on both sides and must be
equal bit for bit for the same seed.  Augmentation is held against
``random_crop_flip`` with the JAX draw's offsets and flips fed to the port
(exact: it only moves values).  The whole-federation batch draw returns
every client's batches from indices inside its true shard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.data import augment as jax_augment
from blades_tpu.data import datasets as jax_datasets
from blades_tpu.data import partition as jax_partition
from blades_tpu_torch.data import augment, datasets, partition, sampler


def _same_partition(a, b):
    for k in ("x", "y", "lengths"):
        u, v = getattr(a, k), getattr(b, k)
        assert u.dtype == v.dtype and u.shape == v.shape, k
        np.testing.assert_array_equal(u, v, err_msg=k)


@pytest.mark.parametrize("n,clients,seed", [(1000, 7, 0), (503, 10, 3)])
def test_iid_partition_is_bit_identical(n, clients, seed):
    want = jax_partition.iid_partition(n, clients, seed)
    got = partition.iid_partition(n, clients, seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clients,alpha,seed", [
    (10, 0.1, 0), (20, 0.5, 4), (60, 0.1, 122)])
def test_dirichlet_partition_is_bit_identical(clients, alpha, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 4000)
    want = jax_partition.dirichlet_partition(labels, clients, alpha, seed)
    got = partition.dirichlet_partition(labels, clients, alpha, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dirichlet_repair_path_is_bit_identical():
    """A federation the rejection loop cannot satisfy takes the repair of
    the last draw on both sides."""
    labels = np.random.default_rng(1).integers(0, 10, 2500)
    want = jax_partition.dirichlet_partition(labels, 200, 0.1, 5)
    got = partition.dirichlet_partition(labels, 200, 0.1, 5)
    assert min(len(s) for s in got) >= 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("iid", [True, False])
def test_partition_dataset_is_bit_identical(iid):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(900, 3, 3, 1)).astype(np.float32)
    y = rng.integers(0, 10, 900).astype(np.int32)
    kw = dict(iid=iid, alpha=0.3, seed=9)
    _same_partition(partition.partition_dataset(x, y, 12, **kw),
                    jax_partition.partition_dataset(x, y, 12, **kw))


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(num_clients=6)),
    ("fashionmnist", dict(num_clients=5, iid=False, alpha=0.5, seed=3)),
    ("cifar10", dict(num_clients=8, iid=False, alpha=0.1, seed=122)),
    ("cifar10", dict(num_clients=4, seed=1, train_frac=0.5,
                     synthetic_noise=2.0, synthetic_heterogeneity=0.7)),
])
def test_synthetic_datasets_are_bit_identical(name, kw, monkeypatch,
                                              tmp_path):
    """The synthetic fallback (no raw files under the data root), with
    Dirichlet skew, subsampling and per-client heterogeneity."""
    monkeypatch.setenv("BLADES_TPU_DATA_ROOT", str(tmp_path))
    want = jax_datasets.DatasetCatalog.get_dataset(name, **kw)
    got = datasets.DatasetCatalog.get_dataset(name, **kw)
    assert got.synthetic and want.synthetic
    assert (got.name, got.num_classes, got.input_shape) == (
        want.name, want.num_classes, want.input_shape)
    _same_partition(got.train, want.train)
    _same_partition(got.test, want.test)
    np.testing.assert_array_equal(got.test_x, want.test_x)
    np.testing.assert_array_equal(got.test_y, want.test_y)


def test_mnist_idx_files_load_as_the_reference_loads_them(monkeypatch,
                                                          tmp_path):
    """Raw IDX files under the data root are read (never downloaded) and
    normalised as the reference does."""
    root = tmp_path / "mnist"
    root.mkdir()
    rng = np.random.default_rng(0)

    def write(name, arr):
        dims = arr.shape
        head = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
            d.to_bytes(4, "big") for d in dims)
        (root / name).write_bytes(head + arr.astype(np.uint8).tobytes())

    write("train-images-idx3-ubyte", rng.integers(0, 256, (120, 28, 28)))
    write("train-labels-idx1-ubyte", rng.integers(0, 10, (120,)))
    write("t10k-images-idx3-ubyte", rng.integers(0, 256, (30, 28, 28)))
    write("t10k-labels-idx1-ubyte", rng.integers(0, 10, (30,)))
    monkeypatch.setenv("BLADES_TPU_DATA_ROOT", str(tmp_path))
    want = jax_datasets.DatasetCatalog.get_dataset("mnist", num_clients=3)
    got = datasets.DatasetCatalog.get_dataset("mnist", num_clients=3)
    assert not got.synthetic and not want.synthetic
    _same_partition(got.train, want.train)
    _same_partition(got.test, want.test)


def test_random_crop_flip_matches_jax_with_fed_draws():
    """The port's crop + flip with the JAX draw's offsets and flips (its
    split chain: ``k_off, k_flip = split(key)``) moves the same values."""
    key = jax.random.PRNGKey(4)
    x = np.random.default_rng(5).normal(size=(6, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax_augment.random_crop_flip(key, jnp.asarray(x)))
    k_off, k_flip = jax.random.split(key)
    offs = np.array(jax.random.randint(k_off, (6, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(k_flip, 0.5, (6,)))
    assert flips.any() and not flips.all()
    got = augment.random_crop_flip(torch.from_numpy(x),
                                   offsets=torch.from_numpy(offs),
                                   flips=torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), want)
    # Leading batch dims (G, nb, B) and a generator draw keep the shape.
    gen = torch.Generator().manual_seed(0)
    xb = torch.from_numpy(x).reshape(2, 3, 8, 8, 3)
    out = augment.random_crop_flip(xb, gen)
    assert out.shape == xb.shape
    assert augment.get_augmentation("none") is None


def test_whole_federation_draw_stays_inside_each_shard():
    gen = torch.Generator().manual_seed(1)
    x = torch.arange(5 * 9, dtype=torch.float32).reshape(5, 9, 1)
    y = torch.arange(5 * 9).reshape(5, 9)
    lengths = torch.tensor([9, 1, 4, 9, 2])
    bx, by = sampler.sample_client_batches(gen, x, y, lengths, 6, 3)
    assert bx.shape == (5, 3, 6, 1) and by.shape == (5, 3, 6)
    idx = by - 9 * torch.arange(5)[:, None, None]
    assert bool((idx >= 0).all())
    assert bool((idx < lengths[:, None, None]).all())
    assert torch.equal(bx[..., 0].long(), by)
