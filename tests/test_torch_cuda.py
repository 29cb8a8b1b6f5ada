"""The port's hand-written CUDA kernels, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build at
first use) and skips without one: a CUDA kernel has no CPU mode. The
file imports only ``torch``, ``numpy`` and the port, so it runs on a
machine without JAX; from the repository root::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

The CPU tests hold each plain version to the JAX reference
(``tests/test_torch_kernels.py``); these hold each kernel to its plain
version on the same card tensors, at the registry's tolerance, the
round on the card to the round on the CPU, and the serving path
(``EnsembleScorer``, a ``ServeFleet`` cell) on the card to the CPU's.
"""
import importlib.util
from pathlib import Path

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
    """The pooled-data ideal's bucket: 2000 real rows padded to 2048. On
    random normals at gamma 1/32 every alpha ends at 0 or 1, so this case
    holds the padding and the shape, not the order of summation (the emnist
    case below does)."""
    args = _on(ops.make_sdca_problem(_rng("ideal"), g=1, b=2048, d=32, n_real=[2000]),
               cuda_device)
    got = ops.sdca(*args)
    want = ops.KERNEL_REGISTRY["sdca"].plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    assert float(got[0, 2000:].abs().max()) == 0.0


def test_sdca_emnist_ideal(cuda_device):
    """The round's own ideal (2,000 pooled emnist rows, bucket 2048), whose
    alphas are not all 0 or 1: the kernel within the registry's 1e-5 of the
    plain version on the card, the padding 0."""
    args = _on(ops.make_ideal_sdca_problem(seed=0), cuda_device)
    got = ops.sdca(*args)
    want = ops.KERNEL_REGISTRY["sdca"].plain(*args)
    assert int(((want > 0) & (want < 1)).sum()) >= 50
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ops.KERNEL_REGISTRY["sdca"].tol, rtol=0)
    assert float(got[0, 2000:].abs().max()) == 0.0


def _sdca_group(g, b, lo, hi, device):
    rng = _rng(f"sdca-g{g}-b{b}")
    return _on(ops.make_sdca_problem(rng, g=g, b=b, d=32,
                                     n_real=rng.integers(lo, hi + 1, size=g)), device)


@pytest.mark.parametrize("g,b,lo,hi", [(256, 64, 33, 64), (128, 256, 193, 256)],
                         ids=["g256-b64", "g128-b256"])
def test_sdca_group_shapes(cuda_device, g, b, lo, hi):
    args = _sdca_group(g, b, lo, hi, cuda_device)
    got = ops.sdca(*args)
    want = ops.KERNEL_REGISTRY["sdca"].plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ops.KERNEL_REGISTRY["sdca"].tol, rtol=0)


@pytest.mark.parametrize("case", ["emnist-ideal", "g256-b64"])
def test_sdca_two_launches_are_bit_identical(cuda_device, case):
    args = (_on(ops.make_ideal_sdca_problem(seed=0), cuda_device) if case == "emnist-ideal"
            else _sdca_group(256, 64, 33, 64, cuda_device))
    assert torch.equal(ops.sdca(*args), ops.sdca(*args))


def test_sdca_member_does_not_depend_on_its_group(cuda_device):
    """Member 17 of a g256 b64 group solved alone (g = 1) equals, bit for
    bit, its alpha in the group: the block's shape depends on b alone."""
    K, y, n_real, lam, epochs = _sdca_group(256, 64, 33, 64, cuda_device)
    group = ops.sdca(K, y, n_real, lam, epochs)
    alone = ops.sdca(K[17:18].contiguous(), y[17:18].contiguous(),
                     n_real[17:18].contiguous(), lam, epochs)
    assert torch.equal(alone[0], group[17])


def _cg_matvec(case, device):
    """The CG's l = 4096 matvec inputs: random normals at gamma 1 / (d var),
    or the round's own validation-pool proxy rows at default_gamma."""
    if case == "cg emnist l4096 d32":
        return _on(ops.make_cg_matvec_problem(seed=0), device)
    rng = _rng("cg-normals")
    xp = rng.normal(size=(4096, 32)).astype(np.float32)
    v = rng.normal(size=4096).astype(np.float32)
    return _on((xp, xp, v, float(1.0 / (32 * xp.var()))), device)


CG_CASES = ["cg l4096 d32", "cg emnist l4096 d32"]


@pytest.mark.parametrize("case", CG_CASES, ids=[c.replace(" ", "-") for c in CG_CASES])
def test_gram_matvec_cg_inputs(cuda_device, case):
    """The clustered kernel within the registry's 1e-5 of the plain version
    at the CG's shape, and bit for bit the same in two launches."""
    spec = ops.KERNEL_REGISTRY["gram_matvec"]
    args = _cg_matvec(case, cuda_device)
    got = ops.gram_matvec(*args)
    want = spec.plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)
    assert torch.equal(got, ops.gram_matvec(*args))


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
    wide = torch.zeros(5, 129, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="d <= 128"):
        ops.rbf_gram_q8(torch.randn(8, 129, device=cuda_device), wide,
                        torch.ones(129, device=cuda_device), torch.zeros(129, device=cuda_device),
                        0.5)
    K = torch.zeros(1, 30, 30, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.sdca(K, torch.ones(1, 30, device=cuda_device),
                 torch.tensor([30], dtype=torch.int32, device=cuda_device), 0.01)


def test_rbf_gram_q8_student(cuda_device):
    """The round's own int8 student (``ops.make_q8_student_problem``: 8,192
    pooled test rows against 4,096 proxy supports as the codec sends them)
    within the registry's 1e-5 of the plain version; two launches equal bit
    for bit, and the first 1,000 rows of the 8,192-row call equal to a
    1,000-row call (``QuantizedSVM.predict``'s last chunk is shorter)."""
    spec = ops.KERNEL_REGISTRY["rbf_gram_q8"]
    x, q, scale, zero, gamma = _on(ops.make_q8_student_problem(seed=0), cuda_device)
    got = ops.rbf_gram_q8(x, q, scale, zero, gamma)
    want = spec.plain(x, q, scale, zero, gamma)
    assert got.shape == (8192, 4096)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)
    assert torch.equal(got, ops.rbf_gram_q8(x, q, scale, zero, gamma))
    head = ops.rbf_gram_q8(x[:1000].contiguous(), q, scale, zero, gamma)
    assert torch.equal(got[:1000], head)


GRAM_MEMBER = 17   # chip_smoke.py's device of the fit group taken alone


def _fit_group(device):
    """The round's first bucket-64 fit input on ``device``, x2 the same
    tensor as x1 as the engine's fit passes it."""
    xp, _, gammas = ops.make_fit_group_problem(seed=0)
    x = torch.from_numpy(xp).to(device)
    return x, x, torch.from_numpy(gammas).to(device)


def test_batched_rbf_gram_emnist_fit_group(cuda_device):
    """The round's own fit group (256 emnist devices, train rows
    zero-padded to 64, each at its default_gamma) within the registry's
    1e-5 of the plain version."""
    spec = ops.KERNEL_REGISTRY["batched_rbf_gram"]
    args = _fit_group(cuda_device)
    got = ops.batched_rbf_gram(*args)
    assert got.shape == (256, 64, 64)
    np.testing.assert_allclose(got.cpu().numpy(), spec.plain(*args).cpu().numpy(),
                               atol=spec.tol, rtol=0)


def test_batched_rbf_gram_device_does_not_depend_on_its_group(cuda_device):
    """A device's Gram is the same bits alone (g = 1) and in the g256 group,
    and two launches of the group give the same bits."""
    x, _, gammas = _fit_group(cuda_device)
    group = ops.batched_rbf_gram(x, x, gammas)
    one = x[GRAM_MEMBER:GRAM_MEMBER + 1].contiguous()
    alone = ops.batched_rbf_gram(one, one, gammas[GRAM_MEMBER:GRAM_MEMBER + 1].contiguous())
    assert torch.equal(alone[0], group[GRAM_MEMBER])
    assert torch.equal(group, ops.batched_rbf_gram(x, x, gammas))


def test_rbf_gram_equals_batched_with_one_device(cuda_device):
    """``rbf_gram(x1, x2, gamma)`` is ``batched_rbf_gram`` of the same rows
    with g = 1 and the same gamma, bit for bit, at the ideal's shape."""
    x, _ = ops.ideal_rows(seed=0)
    x1 = torch.from_numpy(x).to(cuda_device)
    x2 = torch.from_numpy(np.ascontiguousarray(x[::-1])).to(cuda_device)
    gamma = 1.0 / (32 * float(x.var()))
    single = ops.rbf_gram(x1, x2, gamma)
    batched = ops.batched_rbf_gram(x1[None], x2[None],
                                   torch.tensor([gamma], dtype=torch.float32, device=cuda_device))
    assert torch.equal(single, batched[0])


# shapes off every tile multiple (64 columns; 16, 32 and 64 rows; 64 staged
# features; d > 128 in chunks of 128), with 16-byte copies (d % 4 == 0) and
# 4-byte ones
OFF_TILE = [("batched_rbf_gram", (5, 41, 71, 140)), ("rbf_gram", (133, 70, 150)),
            ("batched_rbf_gram", (3, 120, 130, 48)), ("rbf_gram", (60, 200, 61))]


@pytest.mark.parametrize("name,shape", OFF_TILE,
                         ids=[f"{n}-{'x'.join(map(str, s))}" for n, s in OFF_TILE])
def test_rbf_grams_off_every_tile_multiple(cuda_device, name, shape):
    spec = ops.KERNEL_REGISTRY[name]
    rng = _rng("off-tile-" + name, len(shape))
    *lead, m, n, d = shape
    x1 = rng.normal(size=(*lead, m, d)).astype(np.float32)
    x2 = rng.normal(size=(*lead, n, d)).astype(np.float32)
    gam = (1.0 / (d * rng.uniform(0.5, 2.0, size=lead))).astype(np.float32) if lead else 1.0 / d
    args = _on((x1, x2, gam), cuda_device)
    got = spec.dispatch(*args)
    np.testing.assert_allclose(got.cpu().numpy(), spec.plain(*args).cpu().numpy(),
                               atol=spec.tol, rtol=0)


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


def test_streamed_tier_equals_bucketed_on_the_card(cuda_device):
    """A quantity-skew population (device sizes vary, so chunk-local
    groups differ from the population-wide ones in bucket, g and q): the
    streamed tier in chunks of 1, 5 and 13 devices gives the bucketed
    tier's outcomes bit for bit on the card, and ``train_selected`` the
    full pass's."""
    from repro_torch.sim import device_stream, train_population, train_selected

    stream = device_stream("quantity_skew", n_devices=40, seed=3, mean_samples=60,
                           min_samples=40, dim=16, sigma=1.2)
    want = train_population(stream, mode="bucketed", seed=3, device=cuda_device).outcomes
    assert sum(o.report.eligible for o in want) >= 10
    picked = train_selected(stream, [2, 7, 19, 31], seed=3, device=cuda_device)
    for chunk in (1, 5, 13):
        got = train_population(stream, mode="streamed", seed=3, chunk_devices=chunk,
                               device=cuda_device).outcomes
        for a, b in zip(got, want):
            assert a.report == b.report
            assert a.val_scores.tobytes() == b.val_scores.tobytes()
            assert a.local_test_scores.tobytes() == b.local_test_scores.tobytes()
            if a.report.eligible:
                assert a.model.coef.tobytes() == b.model.coef.tobytes()
    for i, o in picked.items():
        assert o.val_scores.tobytes() == want[i].val_scores.tobytes()


def test_a_querys_score_is_the_same_at_every_tile_height(cuda_device):
    """One device's val rows scored in groups whose query pad q selects
    the Gram's 16-, 32- and 64-row tiles give the bits they give alone
    (``chip_smoke.py``'s ``population_identity`` at a test's size)."""
    from repro_torch.kernels.batched_gram import tile_plan
    from repro_torch.sim import engine

    rng = _rng("tile-heights")
    d, b, n = 16, 64, 8
    sup = rng.normal(size=(8, b, d)).astype(np.float32)
    coef = (rng.normal(size=(8, b)) / b).astype(np.float32)
    gam = (1.0 / (d * rng.uniform(0.5, 2.0, size=8))).astype(np.float32)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    alone = engine._score_group(*_on((rows[None], sup[3:4].copy(), coef[3:4].copy(),
                                      gam[3:4].copy()), cuda_device))
    tiles = set()
    for q in (8, 32, 48, 64):
        xq = rng.normal(size=(8, q, d)).astype(np.float32)
        xq[3] = 0.0
        xq[3, :n] = rows
        tiles.add(tile_plan(q, b, d)[0])
        got = engine._score_group(*_on((xq, sup, coef, gam), cuda_device))
        assert torch.equal(got[3, :n], alone[0]), q
    assert tiles == {16, 32, 64}


def test_population_round_matches_cpu(cuda_device):
    """A small streamed population round on the card: equal to the
    bucketed round on the card in every field, and to the CPU round in
    ``comm``, ids and headcounts with AUCs within 1e-4."""
    from repro_torch.sim import PopulationConfig, run_population

    base = dict(scenario="availability", n_devices=64, seed=3, mean_samples=60,
                min_samples=40, dim=16, ks=(3, 8), codec="int8", eval_device_cap=24)
    card = run_population(PopulationConfig(engine="bucketed", **base), device=cuda_device)
    strm = run_population(PopulationConfig(engine="streamed", chunk_devices=9, **base),
                          device=cuda_device)
    cpu = run_population(PopulationConfig(engine="bucketed", **base), device="cpu")
    for field in ("n_available", "n_eligible", "mean_val_auc", "mean_local_auc",
                  "ensemble_auc", "comm", "time_to_aggregate"):
        assert getattr(strm, field) == getattr(card, field), field
    assert card.comm == cpu.comm and (card.n_available, card.n_eligible) == \
        (cpu.n_available, cpu.n_eligible)
    assert ([(e.tag, e.device_id) for e in card.ledger.events]
            == [(e.tag, e.device_id) for e in cpu.ledger.events])
    for s in card.ensemble_auc:
        for k in card.ensemble_auc[s]:
            assert abs(card.ensemble_auc[s][k] - cpu.ensemble_auc[s][k]) <= 1e-4


@pytest.mark.parametrize("agg", ["fisher", "reweight", "feature_stats"])
def test_aggregator_population_rounds_match_cpu(cuda_device, agg):
    """Each aggregator's small population round on the card: the streamed
    round equal to the bucketed one in every field, and the card's round
    equal to the CPU's in ``comm`` (its extras included) and ids, AUCs
    within 1e-4."""
    from repro_torch.sim import PopulationConfig, run_population

    base = dict(scenario="dirichlet", n_devices=64, seed=3, mean_samples=60, min_samples=40,
                dim=16, ks=(3, 8), codec="int8", eval_device_cap=24, aggregator=agg)
    card = run_population(PopulationConfig(engine="bucketed", **base), device=cuda_device)
    strm = run_population(PopulationConfig(engine="streamed", chunk_devices=9, **base),
                          device=cuda_device)
    cpu = run_population(PopulationConfig(engine="bucketed", **base), device="cpu")
    for field in ("n_eligible", "mean_val_auc", "mean_local_auc", "ensemble_auc", "comm"):
        assert getattr(strm, field) == getattr(card, field), field
    assert card.comm == cpu.comm and card.comm["total_agg_extra"] > 0
    assert ([(e.tag, e.device_id) for e in card.ledger.events]
            == [(e.tag, e.device_id) for e in cpu.ledger.events])
    for s in card.ensemble_auc:
        for k in card.ensemble_auc[s]:
            assert abs(card.ensemble_auc[s][k] - cpu.ensemble_auc[s][k]) <= 1e-4


def test_pegasos_fit_matches_cpu(cuda_device):
    from repro_torch.core.averaging import train_linear_svm

    rng = _rng("pegasos")
    x = rng.normal(size=(128, 32)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    card = train_linear_svm(x, y, seed=4, device=cuda_device)
    cpu = train_linear_svm(x, y, seed=4, device="cpu")
    np.testing.assert_allclose(card.w, cpu.w, atol=1e-5, rtol=0)
    assert abs(card.b - cpu.b) <= 1e-5
    np.testing.assert_allclose(card.predict(x), cpu.predict(x), atol=1e-4, rtol=0)


def test_round_matches_cpu(cuda_device):
    from repro_torch.core.protocol import run_protocol
    from repro_torch.data import make_dataset

    ds = make_dataset("gleam", seed=0, scale=0.4)
    ops.reset_launch_counts()
    card = run_protocol(ds, ks=(1, 3, 10), random_trials=2, device=cuda_device)
    counts = ops.launch_counts()   # the fp32 round's four kernels
    assert all(counts[n] > 0 for n in ("batched_rbf_gram", "rbf_gram", "ensemble_score",
                                       "sdca")), counts
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


def _smoke_flash_shapes():
    """chip_smoke.py's FLASH_SHAPES (it imports nothing but the standard library)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_SHAPES


SMOKE_FLASH = _smoke_flash_shapes()


def _bf16_close(got, want):
    diff = (got.float() - want.float()).abs()
    return bool((diff <= 1e-4 + 2.0 ** -7 * want.float().abs()).all())


@pytest.mark.parametrize("case", range(len(SMOKE_FLASH)), ids=[c[0] for c in SMOKE_FLASH])
def test_flash_tc_matches_plain_at_smoke_shapes(cuda_device, case):
    """The bf16 tensor-core kernel at chip_smoke.py's shapes (hd 32, 64 and
    128, the serve shape included) within 1e-4 + 2^-7 |plain|."""
    _, (B, S, H, K, hd), causal, window = SMOKE_FLASH[case]
    rng = _rng("flash-tc", case)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for h in (H, K, K))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ops.KERNEL_REGISTRY["flash_attention"].plain(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16 and _bf16_close(got, want)


@pytest.mark.parametrize("shape", ["registry", "ragged"])
def test_flash_tc_matches_plain_at_registry_inputs(cuda_device, shape):
    """hd 16 (registry) and hd 32 with 3 query heads per KV head on 77 rows
    (ragged), in bf16, under every mask."""
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    args = (spec.make_inputs if shape == "registry" else spec.make_ragged)(_rng("tc-" + shape))
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in args)
    for causal, window in ((True, 0), (True, 16), (False, 0), (False, 16)):
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert _bf16_close(got, spec.plain(q, k, v, causal, window)), (causal, window)


def _ensemble(rng, b, k, n_max, d, q8):
    """Scorer inputs as a trained ensemble gives them: coef = alpha y /
    (lam n), int8 supports quantised by the port's own codec."""
    x = rng.normal(size=(b, d)).astype(np.float32)
    sup = rng.normal(size=(k, n_max, d)).astype(np.float32)
    sign = np.where(rng.random((k, n_max)) < 0.5, -1.0, 1.0)
    coef = (rng.random((k, n_max)) * sign / (0.01 * n_max)).astype(np.float32)
    gam = (1.0 / (d * rng.uniform(0.5, 2.0, size=k))).astype(np.float32)
    if not q8:
        return x, sup, coef, gam
    from repro_torch.comm.wire import _quantize_columns

    q = np.empty((k, n_max, d), np.int8)
    scale = np.empty((k, d), np.float32)
    zero = np.empty((k, d), np.float32)
    for t in range(k):
        q[t], scale[t], zero[t] = _quantize_columns(sup[t])
    return x, q, scale, zero, coef, gam


SCORER_SHAPES = {   # (b, k, n_max, d)
    "ideal k1 n2000": (8192, 1, 2000, 32),
    "k100 n230": (8192, 100, 230, 32),
    "full k2821 n230": (8192, 2821, 230, 32),
    "d12 ragged": (37, 5, 77, 12),
    "d24 ragged": (37, 5, 77, 24),
    "d37 ragged": (300, 7, 77, 37),
}
SCORERS = ("ensemble_score", "ensemble_score_q8")


@pytest.mark.parametrize("shape", sorted(SCORER_SHAPES))
@pytest.mark.parametrize("name", SCORERS)
def test_scorer_matches_plain(cuda_device, name, shape):
    spec = ops.KERNEL_REGISTRY[name]
    args = _on(_ensemble(_rng(name + shape), *SCORER_SHAPES[shape], q8=name.endswith("q8")),
               cuda_device)
    got = spec.kernel(*args)
    want = spec.plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)


@pytest.mark.parametrize("name", ["flash_attention", *SCORERS])
def test_two_launches_are_bit_identical(cuda_device, name):
    spec = ops.KERNEL_REGISTRY[name]
    if name == "flash_attention":
        rng = _rng("twice-flash")
        args = tuple(torch.from_numpy(rng.normal(size=(2, 300, h, 64)).astype(np.float32))
                     .to(cuda_device, torch.bfloat16) for h in (8, 2, 2))
    else:
        args = _on(_ensemble(_rng("twice" + name), *SCORER_SHAPES["k100 n230"],
                             q8=name.endswith("q8")), cuda_device)
    assert torch.equal(spec.kernel(*args), spec.kernel(*args))


@pytest.mark.parametrize("name", SCORERS)
def test_score_does_not_depend_on_the_batch(cuda_device, name):
    """The first 1,000 rows of an 8,192-row call equal, bit for bit, a
    1,000-row call: the split plan never depends on b."""
    spec = ops.KERNEL_REGISTRY[name]
    x, *rest = _on(_ensemble(_rng("rows" + name), *SCORER_SHAPES["full k2821 n230"],
                             q8=name.endswith("q8")), cuda_device)
    full = spec.kernel(x, *rest)
    head = spec.kernel(x[:1000].contiguous(), *rest)
    assert torch.equal(full[:1000], head)


# ----------------------------------------------------------------------
# the serving path: EnsembleScorer and the fleet on the card
# ----------------------------------------------------------------------

def _served_model(codec, d, device, k=4):
    """A ragged RBF ensemble at d (its int8 wire form for ``int8``),
    decoded onto ``device``."""
    from repro_torch.comm.wire import decode, encode
    from repro_torch.core import Ensemble, SVMModel

    rng = _rng(f"served {codec} d{d}")
    members = []
    for _ in range(k):
        n = int(rng.integers(20, 61))
        members.append(SVMModel(rng.normal(size=(n, d)).astype(np.float32),
                                rng.normal(0, 0.1, n).astype(np.float32),
                                float(1.0 / (d * rng.uniform(0.5, 2.0))), device="cpu"))
    return decode(encode(Ensemble(members), codec), device=device)


@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_ensemble_scorer_on_the_card_matches_cpu(cuda_device, codec, d):
    """``EnsembleScorer`` on cuda against cpu behind a scheduler with
    buckets 8/32/256 (LRU on): scores within the scorer's tol, one kernel
    launch per batch, equal stats; a row's bits equal in every bucket."""
    from repro_torch.serve import EnsembleScorer, MicroBatchScheduler, ServeConfig

    name = "ensemble_score_q8" if codec == "int8" else "ensemble_score"
    config = ServeConfig(max_batch=256, buckets=(8, 32, 256), cache_size=64)
    rng = _rng(f"requests d{d}")
    uniq = rng.normal(size=(90, d)).astype(np.float32)
    rows = [uniq[i] for i in rng.integers(0, 90, size=400)]
    runs = {}
    for dev in ("cuda", "cpu"):
        scorer = EnsembleScorer(_served_model(codec, d, dev), device=dev)
        sched = MicroBatchScheduler(scorer, config)
        before = ops.KERNEL_REGISTRY[name].counter.count
        outs = [sched.run(rows[a:b]) for a, b in ((0, 5), (5, 35), (35, 300), (300, 400))]
        runs[dev] = (np.concatenate(outs), vars(sched.stats),
                     ops.KERNEL_REGISTRY[name].counter.count - before, scorer)
    (got, stats, launches, scorer), (want, want_stats, _, _) = runs["cuda"], runs["cpu"]
    tol = ops.KERNEL_REGISTRY[name].tol
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert stats == want_stats and launches == stats["batches"] == 4
    x = np.stack(rows[:256])
    by_bucket = [scorer(x[:b]) for b in (8, 32, 256)]
    assert all(np.array_equal(by_bucket[0], s[:8]) for s in by_bucket[1:])


def test_fleet_cell_on_the_card_is_the_cpu_cell(cuda_device):
    """One ``ServeFleet`` cell (2 tenants, 2 shards each, d 8, overload)
    with ``keep_results`` on cuda and on cpu: the summaries byte for byte
    equal (simulated time: scores never enter them), the cuda results
    bitwise the direct cuda scores of their rows, and within the scorer's
    tol of the cpu results."""
    import json

    from repro_torch.fleet import (FleetConfig, ServeFleet, TenantRegistry, TenantSLO,
                                   nominal_capacity_qps, open_loop_trace)
    from repro_torch.serve import ServeConfig

    serve = ServeConfig(max_batch=32, max_queue=4096, buckets=(8, 32), cache_size=256)
    config = FleetConfig(n_servers=2, max_global_queue=1024)
    rate = 1.5 * nominal_capacity_qps(config.n_servers, serve, config.cost) / 2
    runs = {}
    for dev in ("cuda", "cpu"):
        reg = TenantRegistry(device=dev)
        for i, codec in enumerate(("fp32", "int8")):
            reg.register(f"t{i}", _served_model(codec, 8, dev), serve=serve, n_shards=2,
                         slo=TenantSLO(deadline_ms=(20.0, 100.0)[i], priority=1 - i, quota=256))
        trace = open_loop_trace({n: rate for n in reg.names()}, horizon_ms=40.0, dim=8,
                                seed=7, pool_size=256)
        fleet = ServeFleet(reg, config, keep_results=True)
        runs[dev] = (json.dumps(fleet.run(trace, horizon_ms=40.0), sort_keys=True),
                     fleet, trace)
    (summary, fleet, trace), (cpu_summary, cpu_fleet, _) = runs["cuda"], runs["cpu"]
    assert summary == cpu_summary and json.loads(summary)["global"]["conserved"]
    assert sorted(fleet.results) == sorted(cpu_fleet.results) and fleet.results
    for name in ("t0", "t1"):
        rids = [rid for rid in sorted(fleet.results) if trace[rid].tenant == name]
        kept = np.array([fleet.results[rid] for rid in rids])
        direct = fleet.registry.get(name).scorer(np.stack([trace[rid].row for rid in rids]))
        assert np.array_equal(kept, direct)
        np.testing.assert_allclose(kept, [cpu_fleet.results[rid] for rid in rids],
                                   atol=ops.KERNEL_REGISTRY["ensemble_score"].tol, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_refuses_inputs_that_require_grad(cuda_device, name):
    """A kernel has no backward: under grad mode an input that requires
    grad raises instead of cutting the gradient; under no_grad it runs."""
    spec = ops.KERNEL_REGISTRY[name]
    args = _on(spec.make_inputs(_rng("grad" + name)), cuda_device)
    args = (args[0].clone().requires_grad_(),) + args[1:]
    before = spec.counter.count
    with pytest.raises(RuntimeError, match="no backward"):
        spec.dispatch(*args)
    assert spec.counter.count == before
    with torch.no_grad():
        got = spec.dispatch(*args)
    assert got.grad_fn is None and spec.counter.count == before + 1


def test_pallas_train_step_on_the_card_raises(cuda_device):
    """``use_pallas`` training on the card raises at the first attention
    and leaves the parameters as they were; ``_sdpa``'s step trains, and
    its loss matches the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import init_params, make_train_step, param_tree

    cfg = get_config("llama3.2-1b").reduced()
    tokens = _rng("train").integers(0, cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    losses = {}
    for dev in ("cpu", cuda_device):
        params = init_params(cfg, seed=0, device="cpu", trainable=True).to(dev)
        opt = make_optimizer(1e-3)
        state = opt.init(param_tree(params))
        before = [p.detach().clone() for p in params.parameters()]
        if dev != "cpu":
            with pytest.raises(RuntimeError, match="no backward"):
                make_train_step(cfg.replace(use_pallas=True), opt)(params, state, batch)
            assert all(torch.equal(a, p) for a, p in zip(before, params.parameters()))
        _, _, m = make_train_step(cfg, opt)(params, state, batch)
        losses[str(dev)] = float(m["loss"])
        assert not all(torch.equal(a, p) for a, p in zip(before, params.parameters()))
    assert abs(losses["cpu"] - losses[str(cuda_device)]) <= 1e-4 * losses["cpu"]
