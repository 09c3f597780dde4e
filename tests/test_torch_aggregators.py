"""The port's dense row-geometry aggregators, forgers and clustering
(blades_tpu_torch/ops/aggregators.py, adversaries/update_attacks.py,
ops/clustering.py) against the JAX package's, on identical numpy-made
matrices at small n.

Random draws come from the JAX key and are fed to the port (DnC's column
subsamples, SignGuard-attack's permutation and uniforms).  Tolerance
``rtol=2e-4, atol=2e-5``: f32 sums in another order.  Cluster masks are
compared exactly, on inputs whose clusters are far apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.adversaries import update_attacks as JU
from blades_tpu.ops import aggregators as JA
from blades_tpu.ops import clustering as JC
from blades_tpu.ops.layout import ChunkInfo as JaxChunkInfo
from blades_tpu_torch.adversaries import get_adversary
from blades_tpu_torch.adversaries import update_attacks as TU
from blades_tpu_torch.ops import aggregators as TA
from blades_tpu_torch.ops import clustering as TC
from blades_tpu_torch.ops.layout import ChunkInfo

RTOL, ATOL = 2e-4, 2e-5
N, D = 12, 200
KEY = jax.random.PRNGKey(5)


def _matrix(seed=0, n=N, d=D):
    """Benign rows around +0.2, three outliers far on the other side."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.5 + 0.2).astype(np.float32)
    x[-3:] = (-(x[:3].mean(0) * 4) - 0.5
              + 0.3 * rng.normal(size=(3, d))).astype(np.float32)
    return x


AGGREGATORS = [
    ("GeoMed", dict(maxiter=5)),
    ("DnC", dict(num_byzantine=3, sub_dim=40, num_iters=3)),
    ("Multikrum", dict(num_byzantine=3, k=4)),
    ("Centeredclipping", dict(tau=2.0)),
    ("Signguard", {}),
    ("Signguard", dict(agg="median")),
    ("Clippedclustering", {}),
    ("Clippedclustering", dict(signguard=True, linkage="single",
                               agg="median")),
    ("FLTrust", {}),
]


@pytest.mark.parametrize("name,kw", AGGREGATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(AGGREGATORS)])
def test_dense_aggregators_match_jax(name, kw):
    x = _matrix()
    ja, ta = getattr(JA, name)(**kw), getattr(TA, name)(**kw)
    jstate, tstate = ja.init(D, N), ta.init(D, N)
    draws = None
    if name == "DnC":
        keys = jax.random.split(KEY, ja.num_iters)
        draws = torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.permutation(k, D)[:ja.sub_dim])(keys)))
    for _ in range(2):  # the stateful ones carry their state across calls
        jout, jstate = ja(jnp.asarray(x), jstate, key=KEY)
        tout, tstate = ta(torch.from_numpy(x), tstate, draws=draws)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                                   atol=ATOL)
    if name == "Clippedclustering":
        assert int(tstate["count"]) == int(jstate["count"])


def test_get_aggregator_resolves_every_aggregator():
    for name in JA.AGGREGATORS:
        kw = {"num_byzantine": 2} if name in ("DnC", "Multikrum",
                                             "Trimmedmean") else {}
        agg = TA.get_aggregator({"type": name, **kw})
        assert type(agg).__name__ == name
    with pytest.raises(ValueError, match="num_byzantine"):
        TA.get_aggregator("Multikrum")


FORGERS = [
    ("ALIEAdversary", dict(num_clients=N, num_byzantine=4), "Multikrum"),
    ("ALIEAdversary", dict(num_clients=N, num_byzantine=4), "Signguard"),
    ("MinMaxAdversary", {}, "Multikrum"),
    ("MinMaxAdversary", {}, "Signguard"),
    ("SignGuardAdversary", {}, "Signguard"),
    ("AttackclippedclusteringAdversary", {}, "Clippedclustering"),
]


@pytest.mark.parametrize("adv,kw,agg", FORGERS,
                         ids=[f"{a}-{g}" for a, _, g in FORGERS])
def test_dense_forgers_match_jax(adv, kw, agg):
    x = _matrix(seed=1)
    mal = np.arange(N) < 4
    agg_kw = {"num_byzantine": 4} if agg == "Multikrum" else {}
    jout = getattr(JU, adv)(**kw).on_updates_ready(
        jnp.asarray(x), jnp.asarray(mal), KEY,
        aggregator=getattr(JA, agg)(**agg_kw))
    noise = None
    if adv == "SignGuardAdversary":
        k_perm, k_mag = jax.random.split(KEY)
        noise = (torch.from_numpy(np.array(jax.random.permutation(k_perm, D))),
                 torch.from_numpy(np.array(jax.random.uniform(k_mag, (D,)))))
    tout = getattr(TU, adv)(**kw).on_updates_ready(
        torch.from_numpy(x), torch.from_numpy(mal), noise=noise,
        aggregator=getattr(TA, agg)(**agg_kw))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)


def test_alie_under_signguard_negates_the_global_first_half():
    """The repaired fault: under Signguard, ALIE negates the first half of
    the GLOBAL deviation, also when it forges one column chunk at a time
    (the streamed round's in-place pass) -- as the JAX package does."""
    x = _matrix(seed=2)
    mal = np.arange(N) < 4
    kw = dict(num_clients=N, num_byzantine=4)
    jadv, tadv = JU.ALIEAdversary(**kw), TU.ALIEAdversary(**kw)
    want = np.asarray(jadv.on_updates_ready(
        jnp.asarray(x), jnp.asarray(mal), KEY, aggregator=JA.Signguard()))
    got = tadv.on_updates_ready(torch.from_numpy(x), torch.from_numpy(mal),
                                aggregator=TA.Signguard()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = tadv.on_updates_ready(torch.from_numpy(x), torch.from_numpy(mal),
                                  aggregator=TA.Median()).numpy()
    half = D // 2
    assert not np.allclose(got[0, :half], plain[0, :half])
    np.testing.assert_allclose(got[0, half:], plain[0, half:], rtol=1e-6)
    # Chunk by chunk (width 64, the tail overlapping), as the round runs it.
    c = 64
    chunked = np.zeros_like(x)
    for i, start in enumerate(min(i * c, D - c) for i in range(-(-D // c))):
        out = tadv.on_updates_ready(
            torch.from_numpy(x[:, start:start + c]), torch.from_numpy(mal),
            aggregator=TA.Signguard(),
            shard=ChunkInfo(global_d=D, width=c, start=start, index=i))
        jchunk = jadv.on_updates_ready(
            jnp.asarray(x[:, start:start + c]), jnp.asarray(mal), KEY,
            aggregator=JA.Signguard(),
            shard=JaxChunkInfo(global_d=D, width=c, start=jnp.int32(start),
                               index=jnp.int32(i)))
        np.testing.assert_allclose(out.numpy(), np.asarray(jchunk),
                                   rtol=RTOL, atol=ATOL)
        chunked[:, start:start + c] = out.numpy()
    np.testing.assert_allclose(chunked, got, rtol=RTOL, atol=ATOL)


def test_get_adversary_resolves_the_row_geometry_forgers():
    for name, cls in (("MinMax", TU.MinMaxAdversary),
                      ("SignGuard", TU.SignGuardAdversary),
                      ("Attackclippedclustering",
                       TU.AttackclippedclusteringAdversary)):
        assert isinstance(get_adversary(name), cls)
        assert isinstance(get_adversary(cls.__name__), cls)


def _two_clusters(seed, n=14, sizes=(9, 5), d=6):
    """Unit rows around two far directions: a clear 2-cluster split."""
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=d), rng.normal(size=d)
    rows = [a + 0.05 * rng.normal(size=d) for _ in range(sizes[0])]
    rows += [-a + b + 0.05 * rng.normal(size=d) for _ in range(sizes[1])]
    x = np.array(rows, np.float32)[rng.permutation(n)]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_matches_jax(seed):
    x = _two_clusters(seed)
    dist = (1.0 - np.clip(x @ x.T, -1, 1)).astype(np.float32)
    for linkage, thr in (("single", 2048), ("average", 2048),
                         ("average", 4)):  # 4: the spectral branch
        want = np.asarray(JC.agglomerative_majority(
            jnp.asarray(dist), linkage=linkage, exact_threshold=thr))
        got = TC.agglomerative_majority(torch.from_numpy(dist),
                                        linkage=linkage,
                                        exact_threshold=thr).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{linkage} {thr}")
        assert got.sum() == 9
    feats = np.asarray(JC.sign_features(jnp.asarray(x)))
    np.testing.assert_array_equal(
        TC.sign_features(torch.from_numpy(x)).numpy(), feats)
    np.testing.assert_array_equal(
        TC.kmeans_majority(torch.from_numpy(x)).numpy(),
        np.asarray(JC.kmeans_majority(jnp.asarray(x))))
