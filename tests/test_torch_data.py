"""The port's host-side copies (seeds, data, splits, metrics) give the
reference's answers byte for byte."""
import numpy as np
import pytest

from repro.data import federated as ref_fed
from repro.data import partition as ref_part
from repro.utils import metrics as ref_metrics
from repro.utils import seeds as ref_seeds
from repro_torch.data import federated as pt_fed
from repro_torch.data import partition as pt_part
from repro_torch.utils import metrics as pt_metrics
from repro_torch.utils import seeds as pt_seeds

DATASETS = ("emnist", "gleam", "sent140")
SCALES = {"emnist": 0.01, "gleam": 0.5, "sent140": 0.01}


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(ref_seeds.derive_stream_seed(11, purpose, index))


@pytest.mark.parametrize("seed", [0, 3, 2**40 + 7])
@pytest.mark.parametrize("index", [0, 1, 3461])
def test_seed_derivation_matches(seed, index):
    assert pt_seeds.derive_device_seed(seed, index) == ref_seeds.derive_device_seed(seed, index)
    assert (pt_seeds.derive_stream_seed(seed, "proxy", index)
            == ref_seeds.derive_stream_seed(seed, "proxy", index))


@pytest.mark.parametrize("name", DATASETS)
def test_make_dataset_is_byte_identical(name):
    ref = ref_fed.make_dataset(name, seed=1, scale=SCALES[name])
    pt = pt_fed.make_dataset(name, seed=1, scale=SCALES[name])
    assert (pt.name, pt.n_devices, pt.min_samples, pt.dim) == (
        ref.name, ref.n_devices, ref.min_samples, ref.dim)
    for a, b in zip(ref.devices, pt.devices):
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
        assert a.x.tobytes() == b.x.tobytes()
        assert a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize("name", DATASETS)
def test_splits_and_pool_are_identical(name):
    ref = ref_fed.make_dataset(name, seed=0, scale=SCALES[name])
    pt = pt_fed.make_dataset(name, seed=0, scale=SCALES[name])
    trains_ref, trains_pt = [], []
    for i, (a, b) in enumerate(zip(ref.devices, pt.devices)):
        seed = ref_part.derive_device_seed(0, i)
        sa = ref_part.split_train_test_val(a, seed=seed)
        sb = pt_part.split_train_test_val(b, seed=seed)
        assert sorted(sa) == sorted(sb)
        for split in sa:
            assert sa[split].x.tobytes() == sb[split].x.tobytes()
            assert sa[split].y.tobytes() == sb[split].y.tobytes()
        trains_ref.append(sa["train"])
        trains_pt.append(sb["train"])
    pa, pb = ref_part.pool_devices(trains_ref), pt_part.pool_devices(trains_pt)
    assert pa.x.tobytes() == pb.x.tobytes() and pa.y.tobytes() == pb.y.tobytes()


@pytest.mark.parametrize("n", [2, 9, 57, 400])
def test_roc_auc_matches(n):
    rng = _rng("auc", n)
    y = np.where(rng.random(n) < 0.4, 1.0, -1.0)
    s = np.round(rng.normal(size=n), 1)  # ties on purpose
    assert pt_metrics.roc_auc(y, s) == ref_metrics.roc_auc(y, s)


@pytest.mark.parametrize("bins", [None, 64])
def test_streaming_grouped_auc_matches(bins):
    rng = _rng("grouped", 0 if bins is None else bins)
    groups = []
    for g in range(7):
        n = int(rng.integers(0, 40))
        groups.append((g, rng.normal(size=(n, 3)).astype(np.float32),
                       np.where(rng.random(n) < 0.5, 1.0, -1.0)))
    w = np.arange(3, dtype=np.float32)

    def score(x):
        return x @ w

    ref = ref_metrics.streaming_grouped_auc(score, iter(groups), chunk=16,
                                            acc=ref_metrics.GroupedAUC(bins=bins))
    pt = pt_metrics.streaming_grouped_auc(score, iter(groups), chunk=16,
                                          acc=pt_metrics.GroupedAUC(bins=bins))
    assert pt.compute() == ref.compute()
    assert pt.mean() == ref.mean()
