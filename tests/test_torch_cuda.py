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
    xq = torch.randn(8, 4, device=cuda_device)
    q = torch.zeros(5, 4, dtype=torch.int8, device=cuda_device)
    sc, ze = torch.ones(4, device=cuda_device), torch.zeros(4, device=cuda_device)
    assert ops.rbf_gram_q8(xq, q, sc, ze, 0.5).shape == (8, 5)
    with pytest.raises(TypeError, match="int8"):
        ops.rbf_gram_q8(xq, q.float(), sc, ze, 0.5)


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


def test_int8_distilled_round_matches_cpu(cuda_device):
    """The int8 round with CG distillation: ledgers (the student's
    download included) and ids equal, AUCs within 1e-4, and the three
    int8/distillation kernels launched."""
    from repro_torch.core.protocol import run_protocol
    from repro_torch.data import make_dataset
    from repro_torch.distill import DistillConfig

    ds = make_dataset("gleam", seed=0, scale=0.4)
    kw = dict(ks=(1, 3, 10), random_trials=2, codec="int8",
              distill=DistillConfig(proxy_size=4096, solver="cg"))
    ops.reset_launch_counts()
    card = run_protocol(ds, device=cuda_device, **kw)
    counts = ops.launch_counts()
    assert all(counts[n] > 0 for n in ("gram_matvec", "rbf_gram_q8", "ensemble_score_q8"))
    cpu = run_protocol(ds, device="cpu", **kw)
    assert card.ledger.as_dict() == cpu.ledger.as_dict()
    assert ([(e.tag, e.device_id) for e in card.ledger.events]
            == [(e.tag, e.device_id) for e in cpu.ledger.events])
    np.testing.assert_array_equal(card.student.q, cpu.student.q)
    for s in cpu.ensemble_auc:
        for k in cpu.ensemble_auc[s]:
            assert abs(card.ensemble_auc[s][k] - cpu.ensemble_auc[s][k]) <= 1e-4
    for key in cpu.per_device:
        np.testing.assert_allclose(card.per_device[key], cpu.per_device[key], atol=1e-4)


FLASH_CASES = [
    # (B, Sq, Skv, H, K, hd), causal, window
    ((2, 77, 77, 6, 2, 32), True, 0),
    ((2, 130, 130, 8, 2, 64), True, 40),
    ((1, 100, 100, 12, 2, 128), False, 0),
    ((2, 150, 150, 4, 4, 16), False, 24),
    ((1, 96, 40, 4, 1, 32), False, 8),   # queries past every key's window: keyless rows
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(FLASH_CASES)), ids=lambda i: f"case{i}")
def test_flash_attention_matches_plain(cuda_device, case, dtype):
    """fp32 at the registry's 2e-5; bf16 compared in fp32 at 1e-4 + 2^-7 of
    the plain value (bf16 keeps 8 significant bits, so two fp32 results a
    rounding error apart may round one bf16 step apart)."""
    (B, Sq, Skv, H, K, hd), causal, window = FLASH_CASES[case]
    rng = _rng("flash", case)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device,
                                                                          getattr(torch, dtype))
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    before = spec.counter.count
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert spec.counter.count == before + 1 and got.dtype == q.dtype
    want = spec.plain(q, k, v, causal, window)
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert float(diff.max()) <= spec.tol
    else:
        assert bool((diff <= 1e-4 + 2.0 ** -7 * want.float().abs()).all())


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.randn(1, 8, 4, 32, device=cuda_device)
    k = torch.randn(1, 8, 2, 32, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.randn(1, 8, 3, 32, device=cuda_device), k, k)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                            k[..., :24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, k)


def test_reduced_serve_matches_cpu(cuda_device):
    """The reduced llama through ``serve_prompts`` with the flash kernel
    on the card and its plain version on the CPU: equal greedy tokens,
    one flash launch per layer on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import init_params

    cfg = get_config("llama3.2-1b").reduced().replace(use_pallas=True)
    prompts = _rng("serve").integers(1, cfg.vocab, size=(3, 48)).astype(np.int32)
    params = init_params(cfg, seed=0, device="cpu")
    cpu, _ = serve_prompts(cfg, params, prompts, 6)
    ops.reset_launch_counts()
    card, _ = serve_prompts(cfg, params.to(cuda_device), prompts, 6)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    np.testing.assert_array_equal(card, cpu)
