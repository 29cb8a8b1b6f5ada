"""The port's hand-written CUDA kernels, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build at
first use) and skips without one: a CUDA kernel has no CPU mode. The
file imports only ``torch``, ``numpy`` and the port, so it runs on a
machine without JAX; from the repository root::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

The CPU tests hold each plain version to the JAX reference
(``tests/test_torch_kernels.py``); these hold each kernel to its plain
version on the same card tensors, at the registry's tolerance, and the
round on the card to the round on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.utils.seeds import derive_stream_seed

NAMES = sorted(ops.KERNEL_REGISTRY)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(7, purpose, index))


def _on(args, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in args)


@pytest.mark.parametrize("shape", ["registry", "ragged"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain(cuda_device, name, shape):
    spec = ops.KERNEL_REGISTRY[name]
    rng = _rng(name + shape)
    args = _on((spec.make_inputs if shape == "registry" else spec.make_ragged)(rng),
               cuda_device)
    before = spec.counter.count
    got = spec.dispatch(*args)
    torch.cuda.synchronize()
    assert spec.counter.count == before + 1
    want = spec.plain(*args)
    assert got.shape == want.shape and got.device == want.device
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)


def test_sdca_ideal_bucket(cuda_device):
    """The pooled-data ideal's bucket: 2000 real rows padded to 2048."""
    args = _on(ops.make_sdca_problem(_rng("ideal"), g=1, b=2048, d=32, n_real=[2000]),
               cuda_device)
    got = ops.sdca(*args)
    want = ops.KERNEL_REGISTRY["sdca"].plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    assert float(got[0, 2000:].abs().max()) == 0.0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(2, 8, 4, device=cuda_device)
    g = torch.ones(2, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ops.batched_rbf_gram(x.double(), x.double(), g.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.batched_rbf_gram(x.transpose(1, 2), x.transpose(1, 2), g)
    with pytest.raises(ValueError, match="on cpu"):
        ops.batched_rbf_gram(x, x.cpu(), g)


def test_train_population_matches_cpu(cuda_device):
    from repro_torch.data import make_dataset
    from repro_torch.sim.engine import train_population

    ds = make_dataset("gleam", seed=0, scale=0.5)
    on_card = train_population(ds, device=cuda_device).outcomes
    on_cpu = train_population(ds, device="cpu").outcomes
    for a, b in zip(on_card, on_cpu):
        assert a.report == b.report
        np.testing.assert_allclose(a.val_scores, b.val_scores, atol=1e-4)
        np.testing.assert_allclose(a.local_test_scores, b.local_test_scores, atol=1e-4)


def test_round_matches_cpu(cuda_device):
    from repro_torch.core.protocol import run_protocol
    from repro_torch.data import make_dataset

    ds = make_dataset("gleam", seed=0, scale=0.4)
    ops.reset_launch_counts()
    card = run_protocol(ds, ks=(1, 3, 10), random_trials=2, device=cuda_device)
    assert all(v > 0 for v in ops.launch_counts().values()), ops.launch_counts()
    cpu = run_protocol(ds, ks=(1, 3, 10), random_trials=2, device="cpu")
    assert card.ledger.as_dict() == cpu.ledger.as_dict()
    assert ([(e.tag, e.device_id) for e in card.ledger.events]
            == [(e.tag, e.device_id) for e in cpu.ledger.events])
    assert card.best.keys() == cpu.best.keys()
    for s in card.ensemble_auc:
        assert card.ensemble_auc[s].keys() == cpu.ensemble_auc[s].keys()
        for k in card.ensemble_auc[s]:
            assert abs(card.ensemble_auc[s][k] - cpu.ensemble_auc[s][k]) <= 1e-4
    for key in card.per_device:
        np.testing.assert_allclose(card.per_device[key], cpu.per_device[key], atol=1e-4)
