"""The port's one-shot baselines against the reference's, on the CPU.

The Threefry key chain is held to jax's bit for bit on over 1,000
(seed, t, n) triples; the Pegasos fit to the reference's within 1e-5 (w
and b); parameter averaging bitwise, with the reference's refusals; FedAvg's
client draws and bytes exactly; cohort labels equal and their AUCs within
1e-4. Also the leftovers of earlier slices: ``dirichlet_partition``,
``make_cohort_dataset``, ``validation_auc``, ``list_solvers`` and the
packages' export surfaces.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import averaging as ref_avg
from repro.core import cohorts as ref_cohorts
from repro.core import fedavg as ref_fedavg
from repro.core.svm import validation_auc as ref_validation_auc
from repro.data import federated as ref_fed
from repro.data import partition as ref_partition
from repro.distill import list_solvers as ref_list_solvers
from repro.sim.engine import train_population as ref_train
from repro.utils import trees as ref_trees
from repro.utils.seeds import derive_stream_seed
from repro_torch import convert
from repro_torch.core import averaging as pt_avg
from repro_torch.core import cohorts as pt_cohorts
from repro_torch.core import fedavg as pt_fedavg
from repro_torch.core.svm import validation_auc as pt_validation_auc
from repro_torch.data import federated as pt_fed
from repro_torch.data import partition as pt_partition
from repro_torch.distill import list_solvers as pt_list_solvers
from repro_torch.sim.engine import train_population as pt_train
from repro_torch.utils import threefry
from repro_torch.utils import trees as pt_trees

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

PEGASOS_TOL = 1e-5
AUC_TOL = 1e-4


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(31, purpose, index))


# ----------------------------------------------------------------------
# Threefry: jax's draws, bit for bit
# ----------------------------------------------------------------------

@jax.jit
def _jax_draws(seed, ts, n):
    key = jax.random.PRNGKey(seed)
    return jax.vmap(lambda t: jax.random.randint(jax.random.fold_in(key, t), (), 0, n))(ts)


# n: 1, powers of two, non-powers of two, a 2^16+ span (the multiplier wraps)
SPANS = (1, 2, 3, 7, 64, 100, 127, 1000, 4096, 65_537, 1_000_003)
SEEDS = (0, 1, 3, 17, 12_345, 2**31 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_draws_are_jaxs_bits(seed):
    """randint(fold_in(PRNGKey(seed), t), (), 0, n) for 16 t up to 2^20
    (float32 t, as the Pegasos scan passes it) at each span: 6 seeds x 11
    spans x 16 t = 1,056 triples."""
    rng = _rng("threefry", seed)
    ts = np.concatenate([[0, 1, 2**20], rng.integers(0, 2**20, 13)]).astype(np.float32)
    for n in SPANS:
        want = np.asarray(_jax_draws(seed, jnp.asarray(ts), n))
        got = threefry.randint(threefry.fold_in(threefry.prng_key(seed), ts.astype(np.uint32)),
                               0, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_threefry_keys_fold_and_split_are_jaxs():
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(key))
        for data in (0, 5, 2**32 - 1):
            np.testing.assert_array_equal(threefry.fold_in(threefry.prng_key(seed), data),
                                          np.asarray(jax.random.fold_in(key, data)))
        a, b = jax.random.split(key)
        pa, pb = threefry.split(threefry.prng_key(seed))
        np.testing.assert_array_equal(pa, np.asarray(a))
        np.testing.assert_array_equal(pb, np.asarray(b))
    with pytest.raises(ValueError, match="seed"):
        threefry.prng_key(-1)


def test_pegasos_indices_are_the_reference_scans():
    """The whole index stream of a fit: the reference's float32 arange of
    ``epochs * bucket`` steps through fold_in and randint."""
    steps, n = 5 * 128, 100
    ts = jnp.arange(steps, dtype=jnp.float32)
    want = np.asarray(_jax_draws(7, ts, n))
    np.testing.assert_array_equal(threefry.pegasos_indices(7, steps, n), want)


# ----------------------------------------------------------------------
# Pegasos and parameter averaging
# ----------------------------------------------------------------------

PEGASOS_CASES = {   # name -> (n, d, seed, lam, epochs)
    "n128 d32 e5": (128, 32, 0, 0.01, 5),
    "n100 d7": (100, 7, 3, 0.01, 5),
    "n37 d5 e3": (37, 5, 11, 0.05, 3),
    "n200 d16 e2": (200, 16, 5, 0.001, 2),
}


def _linear_data(n, d, seed):
    rng = _rng("pegasos", seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(x[:, 0] + 0.5 * rng.normal(size=n) > 0, 1.0, -1.0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", sorted(PEGASOS_CASES))
def test_pegasos_fit_matches_the_reference(name):
    n, d, seed, lam, epochs = PEGASOS_CASES[name]
    x, y = _linear_data(n, d, seed)
    ref = ref_avg.train_linear_svm(x, y, lam=lam, epochs=epochs, seed=seed)
    pt = pt_avg.train_linear_svm(x, y, lam=lam, epochs=epochs, seed=seed, device="cpu")
    assert pt.w.dtype == np.float32 and pt.w.shape == (d,)
    np.testing.assert_allclose(pt.w, np.asarray(ref.w), atol=PEGASOS_TOL, rtol=0)
    assert abs(pt.b - ref.b) <= PEGASOS_TOL
    probe = _rng("probe").normal(size=(50, d)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(probe), ref.predict(probe), atol=1e-4, rtol=0)


def _trees(kind):
    rng = _rng("trees")
    w = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    v = [rng.normal(size=5).astype(np.float32) for _ in range(3)]
    trees = [{"w": a, "b": (b, np.float32(i))} for i, (a, b) in enumerate(zip(w, v))]
    if kind == "torch":
        trees = [pt_trees.tree_map(lambda a: torch.from_numpy(np.asarray(a)), t) for t in trees]
    return trees


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("weights", [None, [0.2, 0.5, 0.3], [3.0, 1.0, 1.0]])
def test_average_params_is_bitwise_the_references(kind, weights):
    """numpy leaves average under numpy's promotion (float64 weights make
    float64 leaves) in both packages; torch float32 leaves stay float32,
    as the reference's float32 JAX leaves do."""
    trees = _trees("numpy")
    ref_in = trees if kind == "numpy" else [jax.tree.map(jnp.asarray, t) for t in trees]
    want = ref_avg.average_params(ref_in, weights)
    got = pt_avg.average_params(_trees(kind), weights)
    assert pt_trees.tree_structure(got) == pt_trees.tree_structure(_trees(kind)[0])
    for g, w in zip(pt_trees.tree_leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype == (np.float32 if kind == "torch" else np.float64)
        assert g.tobytes() == w.tobytes()


BAD_AVERAGES = {   # name -> (trees, weights, message)
    "empty": ([], None, "no models to average"),
    "structure": ([{"w": np.zeros(3)}, {"v": np.zeros(3)}], None,
                  "identical model structures"),
    "nesting": ([{"w": np.zeros(3)}, {"w": [np.zeros(3)]}], None,
                "identical model structures"),
    "leaf shape": ([{"w": np.zeros(3)}, {"w": np.zeros(4)}], None, "identical leaf shapes"),
    "negative": ([{"w": np.zeros(3)}, {"w": np.ones(3)}], [0.5, -0.5], "non-negative"),
    "zero sum": ([{"w": np.zeros(3)}, {"w": np.ones(3)}], [0.0, 0.0], "zero/near-zero"),
    "count": ([{"w": np.zeros(3)}, {"w": np.ones(3)}], [1.0], "expected 2 weights"),
    "nan": ([{"w": np.zeros(3)}, {"w": np.ones(3)}], [np.nan, 1.0], "finite"),
}


@pytest.mark.parametrize("name", sorted(BAD_AVERAGES))
def test_average_params_refuses_as_the_reference_does(name):
    """The paper's infeasibility argument: mismatched structures and leaf
    shapes (kernel SVMs, heterogeneous nets) and bad weights raise the
    reference's ValueError in both packages."""
    trees, weights, message = BAD_AVERAGES[name]
    with pytest.raises(ValueError, match=message) as ref_err:
        ref_avg.average_params(trees, weights)
    with pytest.raises(ValueError, match=message) as pt_err:
        pt_avg.average_params(trees, weights)
    assert str(pt_err.value) == str(ref_err.value)


def test_one_shot_average_linear_and_normalize_weights_are_bitwise():
    rng = _rng("linear-average")
    arrays = [(rng.normal(size=6).astype(np.float32), float(rng.normal())) for _ in range(4)]
    ref = [ref_avg.LinearSVM(w=w, b=b) for w, b in arrays]
    pt = [convert.linear_from_arrays(w, b, device="cpu") for w, b in arrays]
    for weights in (None, [0.1, 0.2, 0.3, 0.4]):
        a = ref_avg.one_shot_average_linear(ref, weights)
        b = pt_avg.one_shot_average_linear(pt, weights)
        assert (b.w.tobytes(), b.b) == (np.asarray(a.w).tobytes(), a.b)
        assert b.device == "cpu"
    for w in ([1, 2, 3], [0.0, 5.0], [1e-3]):
        assert pt_avg.normalize_weights(w).tobytes() == ref_avg.normalize_weights(w).tobytes()


def test_linear_scorers_match_the_reference():
    rng = _rng("linear-scorer")
    w, b = rng.normal(size=9).astype(np.float32), 0.375
    x = rng.normal(size=(300, 9)).astype(np.float32)
    ref = ref_avg.LinearSVM(w=w, b=b)
    pt = convert.linear_from_arrays(w, b, device="cpu")
    np.testing.assert_allclose(pt.predict(x), ref.predict(x), atol=1e-5, rtol=0)
    stacked = pt_avg.StackedLinear.from_model(pt)
    ref_stacked = ref_avg.StackedLinear(w=w, b=b)
    assert (stacked.k, stacked.n_max, stacked.d) == (ref_stacked.k, ref_stacked.n_max, 9)
    np.testing.assert_allclose(stacked.predict(x, chunk=128), ref_stacked.predict(x, chunk=128),
                               atol=1e-5, rtol=0)
    assert pt.predict(x[:0]).shape == (0,)
    assert pt.nbytes == ref.nbytes  # repro: allow[wire-cost-honesty] reason=compares the in-memory footprint properties of the two packages, not a wire price


def test_tree_utilities_match_the_reference():
    tree = {"b": np.zeros((2, 3), np.float16), "a": [np.ones(4, np.int32), np.float32(2.0)]}
    assert pt_trees.tree_size_bytes(tree) == ref_trees.tree_size_bytes(tree)
    assert pt_trees.tree_count_params(tree) == ref_trees.tree_count_params(tree)
    ttree = pt_trees.tree_map(torch.from_numpy, {"w": np.zeros((3, 5), np.float32)})
    assert pt_trees.tree_size_bytes(ttree) == 60
    assert [np.asarray(x).tolist() for x in pt_trees.tree_leaves(tree)] == \
        [np.asarray(x).tolist() for x in jax.tree.leaves(tree)]
    mean = pt_trees.tree_mean([{"w": np.ones(2)}, {"w": 3 * np.ones(2)}])
    np.testing.assert_array_equal(mean["w"], [2.0, 2.0])
    with pytest.raises(ValueError, match="different structures"):
        pt_trees.tree_add({"w": np.ones(2)}, {"v": np.ones(2)})


# ----------------------------------------------------------------------
# FedAvg and cohorts
# ----------------------------------------------------------------------

def _clients(m=9, d=6):
    rng = _rng("fedavg-clients")
    out = []
    for c in range(m):
        n = int(rng.integers(20, 60))
        x = rng.normal(size=(n, d)).astype(np.float32) + c * 0.05
        y = np.where(x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
        out.append((x, y))
    return out


def _local_step(params, data, r, seen):
    """Two logistic-loss gradient steps in float64 numpy (either package's
    averaged leaves in), float32 leaves out."""
    x, y = data
    seen.append(len(y))
    w, b = np.asarray(params["w"], np.float64), float(np.asarray(params["b"]))
    for _ in range(2):
        z = y * (x @ w + b)
        g = -(y / (1.0 + np.exp(z)))
        w = w - 0.1 * (x.T @ g) / len(y)
        b = b - 0.1 * g.mean()
    return {"w": w.astype(np.float32), "b": np.float32(b)}


def test_fedavg_draws_prices_and_learns_as_the_reference():
    clients = _clients()
    test_x, test_y = np.concatenate([c[0] for c in clients]), np.concatenate([c[1] for c in clients])
    init = {"w": np.zeros(6, np.float32), "b": np.float32(0.0)}

    def eval_fn(p):
        from repro_torch.utils.metrics import roc_auc

        return roc_auc(test_y, test_x @ np.asarray(p["w"]) + np.asarray(p["b"]))

    runs = {}
    for name, mod in (("ref", ref_fedavg), ("pt", pt_fedavg)):
        seen = []
        res = mod.run_fedavg(init, clients, functools.partial(_local_step, seen=seen),
                             rounds=4, clients_per_round=3, eval_fn=eval_fn,
                             weights_fn=lambda c: len(c[1]), seed=5)
        runs[name] = res, seen
    (ref, ref_seen), (pt, pt_seen) = runs["ref"], runs["pt"]
    assert pt_seen == ref_seen and len(pt_seen) == 12
    assert pt.comm_bytes == ref.comm_bytes == 2.0 * 28 * 12
    assert pt.rounds == ref.rounds == 4
    np.testing.assert_allclose(pt.history, ref.history, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pt.params["w"], np.asarray(ref.params["w"]), atol=1e-6, rtol=0)


def test_fedavg_averages_torch_parameter_trees():
    clients = _clients(m=4)

    def local(params, data, r):
        x = torch.from_numpy(data[0])
        return {"w": params["w"] + x.mean(0), "b": params["b"] + 1.0}

    init = {"w": torch.zeros(6), "b": torch.zeros(())}
    res = pt_fedavg.run_fedavg(init, clients, local, rounds=2, clients_per_round=2, seed=1)
    assert isinstance(res.params["w"], torch.Tensor)
    assert res.comm_bytes == 2.0 * 28 * 4
    assert float(res.params["b"]) == pytest.approx(2.0)


@functools.lru_cache(maxsize=None)
def _cohort_outcomes():
    ref = ref_train(ref_fed.make_cohort_dataset(seed=2, n_devices=30), seed=2).outcomes
    pt = pt_train(pt_fed.make_cohort_dataset(seed=2, n_devices=30), seed=2,
                  device="cpu").outcomes
    return ref, pt


def test_make_cohort_dataset_is_the_references_bits():
    for kw in (dict(seed=0), dict(seed=4, n_cohorts=4, n_devices=20, dim=8)):
        ref, pt = ref_fed.make_cohort_dataset(**kw), pt_fed.make_cohort_dataset(**kw)
        assert (pt.name, pt.min_samples, pt.dim, pt.n_devices) == \
            (ref.name, ref.min_samples, ref.dim, ref.n_devices)
        for a, b in zip(pt.devices, ref.devices):
            assert a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes()
            assert a.y.dtype == b.y.dtype and a.y.tobytes() == b.y.tobytes()


def test_cohort_protocol_labels_and_aucs_match():
    ref_out, pt_out = _cohort_outcomes()
    probe = _rng("cohort-probe").normal(size=(64, 16)).astype(np.float32)
    ref = ref_cohorts.run_cohort_protocol(ref_out, n_cohorts=3, probe_x=probe, seed=1)
    pt = pt_cohorts.run_cohort_protocol(pt_out, n_cohorts=3, probe_x=probe, seed=1)
    np.testing.assert_array_equal(pt.labels, ref.labels)
    assert abs(pt.cohort_auc - ref.cohort_auc) <= AUC_TOL
    assert abs(pt.global_auc - ref.global_auc) <= AUC_TOL
    np.testing.assert_allclose(pt.per_device_cohort, ref.per_device_cohort, atol=AUC_TOL)
    np.testing.assert_allclose(pt.per_device_global, ref.per_device_global, atol=AUC_TOL)
    embs = pt_cohorts.prediction_embeddings([o.model for o in pt_out], probe)
    want = ref_cohorts.prediction_embeddings([o.model for o in ref_out], probe)
    np.testing.assert_allclose(embs, want, atol=1e-5, rtol=0)
    x = embs.astype(np.float64)
    np.testing.assert_array_equal(pt_cohorts.kmeans(x, 3, seed=4), ref_cohorts.kmeans(x, 3, seed=4))


# ----------------------------------------------------------------------
# leftovers of earlier slices, and the export surfaces
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_devices,alpha", [(0, 5, 0.3), (3, 12, 0.1), (9, 40, 1.0)])
def test_dirichlet_partition_gives_the_references_indices(seed, n_devices, alpha):
    rng = _rng("dirichlet", seed)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    y = rng.integers(0, 3, 200).astype(np.float32)
    ref = ref_partition.dirichlet_partition(x, y, n_devices, alpha=alpha, seed=seed)
    pt = pt_partition.dirichlet_partition(x, y, n_devices, alpha=alpha, seed=seed)
    assert len(pt) == len(ref) == n_devices
    for a, b in zip(pt, ref):
        assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()
    with pytest.raises(ValueError, match="cannot give"):
        pt_partition.dirichlet_partition(x[:3], y[:3], 5)


def test_validation_auc_and_list_solvers_are_the_references():
    assert pt_list_solvers() == ref_list_solvers()
    ref_out, pt_out = _cohort_outcomes()
    va = ref_out[0].splits["val"]
    assert abs(pt_validation_auc(pt_out[0].model, va.x, va.y)
               - ref_validation_auc(ref_out[0].model, va.x, va.y)) <= AUC_TOL


# the reference's names the port does not export yet: the LM mesh
# factories of ``repro.launch`` (ROADMAP queue 1 item 15.2); ``core``,
# ``utils`` and ``obs`` are whole
UNPORTED_EXPORTS = {
    "core": set(),
    "utils": set(),
    "obs": set(),
    "launch": {"make_production_mesh", "make_debug_mesh"},
}


@pytest.mark.parametrize("package", sorted(UNPORTED_EXPORTS))
def test_export_surfaces_mirror_the_references(package):
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    pt = importlib.import_module(f"repro_torch.{package}")
    want = set(ref.__all__) - UNPORTED_EXPORTS[package]
    assert set(pt.__all__) >= want
    for name in pt.__all__:
        assert getattr(pt, name) is not None
