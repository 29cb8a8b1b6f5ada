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

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

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
    """What stays refused: a tensor on another device, float codes where
    the kernel takes int8. A float64 or transposed input is now cast or
    copied and held to the plain version, and a bucket of 30 is padded
    (the tests below take each such input for every wrapper)."""
    x = torch.randn(2, 8, 4, device=cuda_device)
    g = torch.ones(2, device=cuda_device)
    gram = ops.KERNEL_REGISTRY["batched_rbf_gram"]
    want = gram.plain(x, x, g)
    for args in ((x.double(), x.double(), g.double()), (x.transpose(1, 2).contiguous()
                 .transpose(1, 2), x, g)):
        np.testing.assert_allclose(ops.batched_rbf_gram(*args).cpu().numpy(),
                                   want.cpu().numpy(), atol=gram.tol, rtol=0)
    with pytest.raises(ValueError, match="on cpu"):
        ops.batched_rbf_gram(x, x.cpu(), g)
    xq = torch.randn(8, 4, device=cuda_device)
    q = torch.zeros(5, 4, dtype=torch.int8, device=cuda_device)
    sc, ze = torch.ones(4, device=cuda_device), torch.zeros(4, device=cuda_device)
    assert ops.rbf_gram_q8(xq, q, sc, ze, 0.5).shape == (8, 5)
    with pytest.raises(TypeError, match="int8"):
        ops.rbf_gram_q8(xq, q.float(), sc, ze, 0.5)
    # d 129, past the staged kernel's 128, launches the chunked kernel
    wide = (q.new_ones(5, 129) * torch.arange(5, dtype=torch.int8, device=cuda_device)[:, None])
    wargs = (torch.randn(8, 129, device=cuda_device), wide,
             torch.full((129,), 0.01, device=cuda_device), torch.zeros(129, device=cuda_device),
             1.0 / 129)
    got = ops.rbf_gram_q8(*wargs)
    want = ops.KERNEL_REGISTRY["rbf_gram_q8"].plain(*wargs)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ops.KERNEL_REGISTRY["rbf_gram_q8"].tol, rtol=0)
    args = _on(ops.make_sdca_problem(_rng("sdca30"), g=2, b=30, d=12, n_real=[30, 19]),
               cuda_device)
    got = ops.sdca(*args)
    assert got.shape == (2, 30)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ops.KERNEL_REGISTRY["sdca"].plain(*args).cpu().numpy(),
                               atol=ops.KERNEL_REGISTRY["sdca"].tol, rtol=0)


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
    """A query head count that is not a multiple of the KV heads' stays
    refused. Mixed types, fp16, hd 24 and a transposed view, refused
    before, are taken now and held to the plain version."""
    q = torch.randn(1, 8, 4, 32, device=cuda_device)
    k = torch.randn(1, 8, 2, 32, device=cuda_device)
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.randn(1, 8, 3, 32, device=cuda_device), k, k)
    for args in ((q, k.bfloat16(), k), (q.half(), k.half(), k.half()),
                 (q[..., :24].contiguous(), k[..., :24].contiguous(), k[..., :24].contiguous()),
                 (q.transpose(1, 2).contiguous().transpose(1, 2), k, k)):
        got = ops.flash_attention(*args)
        want = spec.plain(*args)
        assert got.dtype == args[0].dtype and _flash_close(got, want)


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


def _chip_smoke():
    """chip_smoke.py as a module (it imports nothing but the standard
    library at import)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
SMOKE_FLASH = CHIP_SMOKE.FLASH_SHAPES


def _bf16_close(got, want):
    diff = (got.float() - want.float()).abs()
    return bool((diff <= 1e-4 + 2.0 ** -7 * want.float().abs()).all())


def _flash_close(got, want):
    """chip_smoke.py's tolerance for the output's type: fp32 (and fp64)
    2e-5; bf16 and fp16 1e-4 + 2^-7 or 2^-10 of the plain value."""
    atol, rtol = CHIP_SMOKE.flash_tolerance(got.dtype)
    diff = (got.float() - want.float()).abs()
    return bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.float().abs()).all())


# head dims past the four the kernels took before, in every type: the one-pass
# widths (1 -> 16, 24 -> 32, 72, 80 and 96 -> 96, 100 -> 128, 160 and 192 ->
# 192, 256) and the chunked kernels (320, 512)
NEW_HEAD_DIMS = (1, 8, 24, 72, 80, 96, 100, 160, 192, 256, 320, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
def test_flash_attention_at_every_head_dim(cuda_device, hd, dtype):
    """Causal with a window on 333 rows (off the 64- and 128-row tiles),
    4 query heads per KV head, and non-causal on 200 rows: within the
    tolerance, one launch a call, two launches bitwise equal."""
    rng = _rng("flash-hd", hd)
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    for (B, S, H, K), causal, window in (((2, 333, 8, 2), True, 77), ((1, 200, 2, 2), False, 0)):
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32))
                   .to(cuda_device, getattr(torch, dtype)) for h in (H, K, K))
        before = spec.counter.count
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert spec.counter.count == before + 1
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal, window=window))
        assert got.dtype == q.dtype and _flash_close(got, spec.plain(q, k, v, causal, window))


# the chunked kernels' head dims: clusters of 2 (257-512), 3 (640) and 4
# (1,000, 1,024) CTAs, ragged slices (257, 333, 1,000) and hd 2,100, past the
# 2,048 up to which S is summed once (three O groups in fp32 and bf16 alike)
CHUNKED_HEAD_DIMS = (257, 333, 384, 512, 640, 1000, 1024, 2100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", CHUNKED_HEAD_DIMS)
def test_flash_chunked_at_wide_head_dims(cuda_device, hd, dtype):
    """The cluster kernels past hd 256: causal with a window on 333 rows and
    non-causal on 200, within the tolerance, one launch a call, two launches
    bitwise equal."""
    rng = _rng("flash-chunked", hd)
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    for (B, S, H, K), causal, window in (((2, 333, 4, 2), True, 77), ((1, 200, 2, 1), False, 0)):
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32))
                   .to(cuda_device, getattr(torch, dtype)) for h in (H, K, K))
        before = spec.counter.count
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert spec.counter.count == before + 1
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal, window=window))
        assert got.dtype == q.dtype and _flash_close(got, spec.plain(q, k, v, causal, window))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", (333, 512))
def test_flash_chunked_row_does_not_depend_on_the_batch(cuda_device, hd, dtype):
    """A B 3 call's first batch row is bitwise the same input's B 1 call."""
    rng = _rng("flash-chunked-batch", hd)
    t = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 300, h, hd)).astype(np.float32))
               .to(cuda_device, t) for h in (4, 2, 2))
    whole = ops.flash_attention(q, k, v, causal=True, window=0)
    alone = ops.flash_attention(q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous(),
                                causal=True, window=0)
    assert torch.equal(whole[:1], alone)


def test_flash_chunked_reads_a_q_2_bytes_off_16(cuda_device):
    """A bf16 q 2 bytes off a 16-byte boundary at hd 333: the chunked kernel's
    plain 2-byte loads, read in place."""
    rng = _rng("flash-chunked-align")
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    q32, k32, v32 = (torch.from_numpy(rng.normal(size=(1, 150, h, 333)).astype(np.float32))
                     .to(cuda_device) for h in (4, 2, 2))
    buf = torch.empty(q32.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    q = buf[1:1 + q32.numel()].view(q32.shape)
    q.copy_(q32.bfloat16())
    assert q.data_ptr() % 16 == 2
    k, v = k32.bfloat16(), v32.bfloat16()
    got = ops.flash_attention(q, k, v, causal=True, window=0)
    assert _flash_close(got, spec.plain(q, k, v, True, 0))
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True, window=0))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_reads_rows_off_16_byte_boundaries(cuda_device, dtype):
    """Rows the 16-byte copies cannot take, read in place: q 2, 4 and 8
    bytes off a 16-byte boundary at hd 64 (plain 2-byte loads, 4- and
    8-byte cp.async), an odd hd (plain loads), hd 100 (8-byte rows) and
    hd 98 (4-byte rows)."""
    rng = _rng("flash-align-" + dtype)
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    t = getattr(torch, dtype)
    for hd, off in ((64, 1), (64, 2), (64, 4), (37, 0), (100, 0), (98, 0)):
        q32, k32, v32 = (torch.from_numpy(rng.normal(size=(1, 150, h, hd)).astype(np.float32))
                         .to(cuda_device) for h in (4, 2, 2))
        buf = torch.empty(q32.numel() + 8, dtype=t, device=cuda_device)
        q = buf[off:off + q32.numel()].view(q32.shape)
        q.copy_(q32.to(t))
        assert q.data_ptr() % 16 == 2 * off
        got = ops.flash_attention(q, k32.to(t), v32.to(t), causal=True, window=0)
        assert _flash_close(got, spec.plain(q, k32.to(t), v32.to(t), True, 0)), (hd, off)


def test_flash_attention_past_65535_batch_heads_is_one_launch(cuda_device):
    """B x H = 70,400 query heads, folded into one grid dimension."""
    rng = _rng("flash-grid")
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = (torch.from_numpy(rng.normal(size=(1100, 3, h, 8)).astype(np.float32))
                   .to(cuda_device, dtype) for h in (64, 16, 16))
        before = spec.counter.count
        got = ops.flash_attention(q, k, v)
        assert spec.counter.count == before + 1
        assert _flash_close(got, spec.plain(q, k, v, True, 0))


def test_flash_attention_takes_mixed_types_and_float64(cuda_device):
    """As the reference: each input cast to fp32, the fp32 kernel, the
    output in q's type."""
    rng = _rng("flash-mixed")
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 130, h, 96)).astype(np.float32))
               .to(cuda_device) for h in (4, 2, 2))
    for args in ((q.bfloat16(), k, v), (q.half(), k.bfloat16(), v), (q, k.half(), v.half()),
                 (q.double(), k.double(), v.double())):
        got = ops.flash_attention(*args, causal=True, window=40)
        assert got.dtype == args[0].dtype
        assert _flash_close(got, spec.plain(*args, True, 40))


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


# the VLM's prefill (2,880 patches + 2,048 tokens) and the audio encoder's
# (1,500 frames, non-causal, ragged against the 128-row tile)
FAMILY_PREFILLS = [c for c in SMOKE_FLASH if c[0].startswith(("llava", "whisper"))]


@pytest.mark.parametrize("case", FAMILY_PREFILLS, ids=[c[0] for c in FAMILY_PREFILLS])
def test_flash_fp32_matches_plain_at_the_vlm_and_audio_prefills(cuda_device, case):
    """The fp32 kernel at the new families' prefill shapes within the
    registry's 2e-5 (the bf16 kernel's cases are in the test above)."""
    _, (B, S, H, K, hd), causal, window = case
    rng = _rng("flash-fp32-" + case[0])
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32))
               .to(cuda_device) for h in (H, K, K))
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = spec.plain(q, k, v, causal, window)
    assert float((got - want).abs().max()) <= spec.tol


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-base"])
def test_reduced_vlm_and_audio_serve_matches_cpu(cuda_device, arch):
    """The reduced VLM (zero patches) and encoder-decoder (zero frames)
    through ``serve_prompts`` with the flash kernel on the card and its
    plain version on the CPU: equal greedy tokens, one flash launch per
    attention layer, the encoder's included."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import init_params

    cfg = get_config(arch).reduced().replace(use_pallas=True)
    prompts = _rng("serve-" + arch).integers(1, cfg.vocab, size=(3, 48)).astype(np.int32)
    params = init_params(cfg, seed=0, device="cpu")
    cpu, _ = serve_prompts(cfg, params, prompts, 6)
    ops.reset_launch_counts()
    card, _ = serve_prompts(cfg, params.to(cuda_device), prompts, 6)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers + cfg.encoder_layers
    np.testing.assert_array_equal(card, cpu)


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


SVM_NAMES = [n for n in NAMES if n != "flash_attention"]


def _off_boundary(t):
    """t's values in a tensor that starts one element past an aligned
    allocation: 4 bytes off 16 for fp32, 1 byte for int8."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _strided(t):
    """t's values in a non-contiguous view of the same shape."""
    if t.dim() < 2:
        return torch.stack([t, t], dim=-1)[..., 0]
    return t.transpose(0, -1).contiguous().transpose(0, -1)


@pytest.mark.parametrize("form", ["float64", "strided", "off 16 bytes"])
@pytest.mark.parametrize("name", SVM_NAMES)
def test_svm_wrappers_take_any_float_type_and_layout(cuda_device, name, form):
    """The reference's kernels cast their inputs (``astype(jnp.float32)``)
    and take any layout: each wrapper casts, or copies a non-contiguous or
    misaligned tensor once, and holds the plain version on the fp32
    inputs at the registry's tolerance, in one launch."""
    spec = ops.KERNEL_REGISTRY[name]
    args = _on(spec.make_ragged(_rng("forms" + name)), cuda_device)
    change = {"float64": lambda t: t.double() if t.is_floating_point() else t.long(),
              "strided": _strided, "off 16 bytes": _off_boundary}[form]
    moved = tuple(change(a) if isinstance(a, torch.Tensor) else a for a in args)
    before = spec.counter.count
    got = spec.dispatch(*moved)
    assert spec.counter.count == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), spec.plain(*args).cpu().numpy(),
                               atol=spec.tol, rtol=0)


@pytest.mark.parametrize("b,n_real", [(30, [30, 17, 1]), (61, [61, 40, 33]), (2, [2, 1, 2])])
def test_sdca_pads_a_bucket_off_the_multiple_of_4(cuda_device, b, n_real):
    args = _on(ops.make_sdca_problem(_rng("sdca-pad", b), g=3, b=b, d=12, n_real=n_real),
               cuda_device)
    got = ops.sdca(*args)
    assert got.shape == (3, b)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ops.KERNEL_REGISTRY["sdca"].plain(*args).cpu().numpy(),
                               atol=ops.KERNEL_REGISTRY["sdca"].tol, rtol=0)


def test_grams_past_the_grid_run_in_several_launches(cuda_device):
    """65,537 devices (two launches), and 4,194,245 rows of 64-row tiles
    (65,536 tiles: two launches a device): every output the plain
    version's, each launch counted."""
    from repro_torch.kernels import batched_gram as bg

    rng = _rng("grid")
    x1 = torch.from_numpy(rng.normal(size=(65_537, 4, 4)).astype(np.float32)).to(cuda_device)
    x2 = torch.from_numpy(rng.normal(size=(65_537, 8, 4)).astype(np.float32)).to(cuda_device)
    gam = torch.full((65_537,), 0.25, device=cuda_device)
    tall = torch.from_numpy(rng.normal(size=(2, bg.MAX_GRID_Y * 64 + 5, 4)).astype(np.float32))
    tall = tall.to(cuda_device)
    spec = ops.KERNEL_REGISTRY["batched_rbf_gram"]
    for args, launches in (((x1, x2, gam), 2), ((tall, x2[:2], gam[:2]), 4)):
        rows = bg.tile_plan(args[0].shape[1], args[1].shape[1], 4)[0]
        assert len(bg.launch_slices(args[0].shape[0], args[0].shape[1], rows)) == launches
        before = spec.counter.count
        got = ops.batched_rbf_gram(*args)
        assert spec.counter.count == before + launches
        np.testing.assert_allclose(got.cpu().numpy(), spec.plain(*args).cpu().numpy(),
                                   atol=spec.tol, rtol=0)
    one = ops.KERNEL_REGISTRY["rbf_gram"]
    before = one.counter.count
    got = ops.rbf_gram(tall[0], x2[0], 0.25)
    assert one.counter.count == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), one.plain(tall[0], x2[0], 0.25).cpu().numpy(),
                               atol=one.tol, rtol=0)


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


def test_top_k_breaks_ties_on_the_card_as_on_the_cpu(cuda_device):
    """The MoE's selection (``models.layers.top_k``, a stable descending
    sort) puts the lower index first among equal values on the card too:
    tied routing weights select the same tokens on both devices."""
    from repro_torch.models.layers import top_k

    x = torch.from_numpy(_rng("ties").integers(0, 4, size=(16, 8192)).astype(np.float32))
    for k in (2, 1280, 8191):
        vals, idx = top_k(x.to(cuda_device), k)
        want_vals, want_idx = top_k(x, k)
        assert torch.equal(idx.cpu(), want_idx) and torch.equal(vals.cpu(), want_vals)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "jamba-1.5-large-398b"])
def test_reduced_family_on_the_card_matches_cpu(cuda_device, arch):
    """A reduced MoE, SSM or hybrid model (fp32, flash on its attention
    layers) on the card against the CPU: the training forward within 1e-4,
    the aux loss within 1e-5, and greedy serving tokens equal."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import forward_train, init_params

    cfg = get_config(arch).reduced(max_decode_len=64).replace(use_pallas=True)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = _rng("family prompts").integers(1, cfg.vocab, size=(4, 40)).astype(np.int32)
    runs = {}
    for dev, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(cuda_device))):
        with torch.no_grad():
            logits, aux = forward_train(p, cfg, {"tokens": torch.from_numpy(prompts).to(dev)})
        tokens, _ = serve_prompts(cfg, p, prompts, gen=6)
        runs[dev] = (logits.cpu(), float(aux), tokens)
    assert float((runs["cuda"][0] - runs["cpu"][0]).abs().max()) <= 1e-4
    assert abs(runs["cuda"][1] - runs["cpu"][1]) <= 1e-5
    assert np.array_equal(runs["cuda"][2], runs["cpu"][2])


def test_sharded_population_on_the_card_is_the_bucketed_one(cuda_device):
    """The sharded tier on a one-rank ``nccl`` world that ``make_sim_mesh``
    starts in this process: the bucketed tier's outcomes on the card, bit
    for bit, with the fit and SDCA kernels launched."""
    import torch.distributed as dist

    from repro_torch.sim import engine, make_federation, make_shard_ctx

    fed = make_federation("quantity_skew", n_devices=48, seed=3, mean_samples=60,
                          min_samples=40, dim=8, sigma=1.2)
    want = engine.train_population(fed.dataset, mode="bucketed", seed=3,
                                   device=cuda_device).outcomes
    assert make_shard_ctx(device=cuda_device).n_shards == 1
    assert "nccl" in dist.get_backend()
    ops.reset_launch_counts()
    got = engine.train_population(fed.dataset, mode="sharded", seed=3,
                                  device=cuda_device).outcomes
    counts = ops.launch_counts()
    assert counts["batched_rbf_gram"] > 0 and counts["sdca"] > 0
    assert [o.device_id for o in got] == [o.device_id for o in want]
    for a, b in zip(got, want):
        assert a.report == b.report
        assert a.val_scores.tobytes() == b.val_scores.tobytes()
        assert a.local_test_scores.tobytes() == b.local_test_scores.tobytes()
        if hasattr(b.model, "coef"):
            assert a.model.coef.tobytes() == b.model.coef.tobytes()


# ----------------------------------------------------------------------
# the wide paths: every feature dim and SDCA bucket the reference takes
# ----------------------------------------------------------------------

WIDE_DS = [129, 220, 221, 256, 784, 1024]
WIDE_KERNELS = list(CHIP_SMOKE.WIDE_KERNELS)


def wide_case(name, d, device, seed=0):
    """``name``'s arguments at feature dim d, drawn on ``device``: the
    scorers at b 300, k 7, n 77; gram_matvec at l 600; rbf_gram_q8 at
    300 x 260; normals at gamma 1/d (the scorers' per member 1/(d u), u in
    [0.5, 2]), coefficients at a trained model's scale."""
    g = torch.Generator(device=device).manual_seed(seed * 10_000 + d)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    if name in ("ensemble_score", "ensemble_score_q8"):
        b, k, n = 300, 7, 77
        x, sup = randn(b, d), randn(k, n, d)
        sign = torch.where(torch.rand(k, n, generator=g, device=device) < 0.5, -1.0, 1.0)
        coef = torch.rand(k, n, generator=g, device=device) * sign / (0.01 * n)
        gam = 1.0 / (d * (0.5 + 1.5 * torch.rand(k, generator=g, device=device)))
        if name == "ensemble_score":
            return x, sup, coef, gam
        return (x, *CHIP_SMOKE.quantize_columns_on(sup), coef, gam)
    if name == "gram_matvec":
        xp = randn(600, d)
        return xp, xp, randn(600), float(1.0 / (d * float(xp.var())))
    x = randn(300, d)
    q, scale, zero = CHIP_SMOKE.quantize_columns_on(randn(260, d))
    return x, q, scale, zero, 1.0 / d


@pytest.mark.parametrize("d", WIDE_DS)
@pytest.mark.parametrize("name", WIDE_KERNELS)
def test_wide_kernels_match_plain(cuda_device, name, d):
    """Each kernel past its staged limits launches its own CUDA code
    (the launch counted), within the registry's tol of its plain version,
    and two launches equal bit for bit."""
    spec = ops.KERNEL_REGISTRY[name]
    args = wide_case(name, d, cuda_device)
    before = spec.counter.count
    got = spec.dispatch(*args)
    torch.cuda.synchronize()
    assert spec.counter.count == before + 1
    want = spec.plain(*args)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)
    assert torch.equal(got, spec.dispatch(*args))


@pytest.mark.parametrize("d", [32, 64, 128, 220])
@pytest.mark.parametrize("name", WIDE_KERNELS)
def test_chunked_paths_against_the_staged_ones(cuda_device, name, d):
    """Through the private entries, where both run: the scorers' and
    rbf_gram_q8's chunked kernels give the staged kernels' bits (q8's
    staged kernel takes d <= 128, the scorers' d <= 220); gram_matvec's
    chunked route runs the cross term on the tensor cores (three bf16
    planes, fp32 a 64-feature step, fp64 across steps), so it is held
    within the registry's tol of the staged kernel (d <= 64) and of the
    plain version instead."""
    spec = ops.KERNEL_REGISTRY[name]
    args = wide_case(name, d, cuda_device, seed=1)
    staged, chunked = spec.kernel(*args), CHIP_SMOKE.wide_private(name)(*args)
    if name == "gram_matvec":
        np.testing.assert_allclose(chunked.cpu().numpy(), staged.cpu().numpy(), atol=spec.tol,
                                   rtol=0)
        np.testing.assert_allclose(chunked.cpu().numpy(), spec.plain(*args).cpu().numpy(),
                                   atol=spec.tol, rtol=0)
    elif name != "rbf_gram_q8" or d <= 128:
        assert torch.equal(staged, chunked)


SCORERS = ["ensemble_score", "ensemble_score_q8"]


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("d", [221, 784, 1023])
@pytest.mark.parametrize("name", SCORERS)
def test_chunked_scorers_match_plain(cuda_device, name, d, offset):
    """The chunked scorers (16-byte copies at d 784, 4-byte copies and
    byte loads at the ragged 221 and 1,023) within the registry's tol of
    the plain version. With ``offset`` the C launcher itself gets an x one
    float off 16 bytes, so at d 784 it takes the 4-byte instantiation: the
    wrappers would hand it an aligned copy (``native.kernel_inputs``)."""
    from repro_torch.kernels import ensemble_score as ens
    from repro_torch.kernels import native

    spec = ops.KERNEL_REGISTRY[name]
    args = wide_case(name, d, cuda_device)
    if offset:
        x, *sup, coef, gam = args
        view = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x)
        view.copy_(x)
        assert view.data_ptr() % 16 and all(t.data_ptr() % 16 == 0 for t in sup)
        lib = native.library("ensemble_score")
        launcher = {"ensemble_score": lib.ensemble_score_chunked_launch,
                    "ensemble_score_q8": lib.ensemble_score_q8_chunked_launch}[name]
        got = ens.launch_scores(name, native.LaunchCounter(name), launcher, view, tuple(sup),
                                coef, gam)
    else:
        got = CHIP_SMOKE.wide_private(name)(*args)
    np.testing.assert_allclose(got.cpu().numpy(), spec.plain(*args).cpu().numpy(),
                               atol=spec.tol, rtol=0)


@pytest.mark.parametrize("d", [64, 220])
@pytest.mark.parametrize("name", SCORERS)
def test_chunked_scorers_are_the_staged_bits_at_the_rounds_shape(cuda_device, name, d):
    """At b 8,192, k 282, n 230 (five items a split: two pairs and an odd
    item, tiles of 64, 64, 64 and 38 rows) the chunked kernel gives the
    staged kernel's bits."""
    spec = ops.KERNEL_REGISTRY[name]
    args = CHIP_SMOKE.wide_inputs(name, d, cuda_device, k=282)
    assert torch.equal(CHIP_SMOKE.wide_private(name)(*args), spec.kernel(*args))


@pytest.mark.parametrize("d", [784, 1023])
@pytest.mark.parametrize("name", SCORERS)
def test_chunked_scorers_bitwise_across_b_and_launches(cuda_device, name, d):
    """A row's score is the same bits in an 8,192-row call and in a call
    of the first 100 rows, and in two launches."""
    spec = ops.KERNEL_REGISTRY[name]
    args = CHIP_SMOKE.wide_inputs(name, d, cuda_device, k=282)
    full = spec.kernel(*args)
    assert torch.equal(full, spec.kernel(*args))
    assert torch.equal(full[:100], spec.kernel(args[0][:100].contiguous(), *args[1:]))


def _ideal_bucket(cap, device, epochs):
    """The pooled emnist ideal at ``cap`` rows (scale 0.1 pools ~24,000
    train rows): ``train_svm``'s SDCA problem, bucket ceil(cap / 64) * 64."""
    K, y, n_real, lam, _ = ops.make_ideal_sdca_problem(seed=0, scale=0.1, cap=cap)
    return _on((K, y, n_real, lam, epochs), device)


@pytest.mark.parametrize("cap,bucket", [(12_400, 12_416), (16_384, 16_384)])
def test_sdca_past_the_shared_memory_bucket(cuda_device, cap, bucket):
    """Buckets past 12,384 launch the cluster kernel: within the registry's
    1e-5 of the plain version at 2 epochs, padding 0, twice bitwise."""
    spec = ops.KERNEL_REGISTRY["sdca"]
    args = _ideal_bucket(cap, cuda_device, epochs=2)
    assert args[0].shape == (1, bucket, bucket)
    before = spec.counter.count
    got = ops.sdca(*args)
    assert spec.counter.count == before + 1
    want = spec.plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)
    assert cap == bucket or float(got[0, cap:].abs().max()) == 0.0
    assert torch.equal(got, ops.sdca(*args))


@pytest.mark.parametrize("case", ["emnist-ideal", "g256-b64"])
def test_sdca_global_instantiation_is_the_shared_one(cuda_device, case):
    """At buckets both take (the emnist ideal's 2,048, the g256 b64 group),
    the cluster kernel (its private entry) sums in another order than the
    one-block kernel: within the registry's tol of it and of the plain
    version."""
    from repro_torch.kernels.sdca import sdca_global_cuda

    spec = ops.KERNEL_REGISTRY["sdca"]
    args = (_on(ops.make_ideal_sdca_problem(seed=0), cuda_device) if case == "emnist-ideal"
            else _sdca_group(256, 64, 33, 64, cuda_device))
    got = sdca_global_cuda(*args).cpu().numpy()
    for want in (ops.sdca(*args), spec.plain(*args)):
        np.testing.assert_allclose(got, want.cpu().numpy(), atol=spec.tol, rtol=0)


def test_sdca_cluster_member_alone_equals_in_a_group_of_2(cuda_device):
    """At bucket 12,416 a device's alphas are the same bits solved alone and
    as either member of a group of 2 (the ideal at 12,400 rows and the same
    Gram cut to 12,000)."""
    K, y, n_real, lam, _ = _ideal_bucket(12_400, cuda_device, epochs=1)
    cut = torch.tensor([12_000], dtype=torch.int32, device=cuda_device)
    alone = ops.sdca(K, y, n_real, lam, 1)
    alone_cut = ops.sdca(K, y, cut, lam, 1)
    for order in ((n_real, cut), (cut, n_real)):
        group = ops.sdca(K.expand(2, -1, -1).contiguous(), y.expand(2, -1).contiguous(),
                         torch.cat(order), lam, 1)
        first, second = (alone, alone_cut) if order[0] is n_real else (alone_cut, alone)
        assert torch.equal(group[0], first[0]) and torch.equal(group[1], second[0])
    assert float(alone_cut[0, 12_000:].abs().max()) == 0.0


@pytest.mark.parametrize("g,b,lo,hi,epochs", [(4, 256, 193, 256, 3), (3, 320, 130, 301, 3),
                                              (1, 2048, 2000, 2000, 2)],
                         ids=["g4-b256", "g3-b320", "g1-b2048"])
def test_sdca_cluster_kernel_is_its_emulated_order(cuda_device, g, b, lo, hi, epochs):
    """The cluster kernel's alphas are, bit for bit, its order emulated on
    the CPU (``tests/test_torch_sdca_order.py``: the slices, the lanes, the ranks in
    order, then the carry; the reference's fp32 step)."""
    from test_torch_sdca_order import sdca_cluster_emulated
    from repro_torch.kernels.sdca import sdca_global_cuda

    rng = _rng(f"sdca-cluster-g{g}-b{b}")
    args = ops.make_sdca_problem(rng, g=g, b=b, d=32, n_real=rng.integers(lo, hi + 1, size=g),
                                 epochs=epochs)
    got = sdca_global_cuda(*_on(args, cuda_device)).cpu()
    assert torch.equal(got, sdca_cluster_emulated(*args))


@pytest.mark.parametrize("m,n,d", [(600, 600, 129), (1000, 777, 300), (130, 4097, 65)])
def test_gram_matvec_chunked_scratch_and_operands(cuda_device, m, n, d):
    """The chunked route's scratch as the launcher lays it out
    (``gram_matvec_scratch_rows``, ``gram_matvec_padded_dim``), for x2 = x1
    and apart; with x2 apart from x1 (two prologue launches, x2's planes
    after x1's) within the registry's tol of the plain version, twice
    bitwise, one launch counted a call."""
    from repro_torch.kernels import gram_matvec as gmv
    from repro_torch.kernels import native

    lib = native.library("gram_matvec")
    for same in ((0, 1) if m == n else (0,)):
        elems, rows = gmv.chunked_scratch(m, n, d, bool(same))
        assert rows == lib.gram_matvec_scratch_rows(m, n, same)
        assert elems == gmv.PLANES * rows * lib.gram_matvec_padded_dim(d)
    g = torch.Generator(device=cuda_device).manual_seed(m + n + d)
    x1 = torch.randn(m, d, generator=g, device=cuda_device)
    x2 = torch.randn(n, d, generator=g, device=cuda_device)
    v = torch.randn(n, generator=g, device=cuda_device)
    spec = ops.KERNEL_REGISTRY["gram_matvec"]
    before = spec.counter.count
    got = gmv.gram_matvec_cuda(x1, x2, v, 1.0 / d)
    torch.cuda.synchronize()
    assert spec.counter.count == before + 1
    want = gmv.gram_matvec_plain(x1, x2, v, 1.0 / d)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=spec.tol, rtol=0)
    assert torch.equal(got, gmv.gram_matvec_cuda(x1, x2, v, 1.0 / d))


def test_smem_mirrors_match_the_libraries(cuda_device):
    """The libraries' shared-memory sizes: the staged scorers' and
    gram_matvec's tiles fit up to d 220 (the scorers' launcher leaves its
    staged kernel there, gram_matvec's already past d 64), the shared SDCA
    arrays up to bucket 12,384, the SDCA cluster's past it; the chunked
    kernels' one size for every d."""
    from repro_torch.kernels import native

    ens, gmv, sd = (native.library(n) for n in ("ensemble_score", "gram_matvec", "sdca"))
    for lib, fn in ((ens, ens.ensemble_score_smem_bytes), (gmv, gmv.gram_matvec_smem_bytes)):
        fits = [d for d in range(1, 1025) if fn(d) <= native.MAX_SMEM_BYTES]
        assert fits == list(range(1, 221))
    assert ens.ensemble_score_chunked_smem_bytes() <= native.MAX_SMEM_BYTES
    assert ens.ensemble_score_q8_chunked_smem_bytes() <= native.MAX_SMEM_BYTES
    assert gmv.gram_matvec_chunked_smem_bytes() <= native.MAX_SMEM_BYTES
    shared = [b for b in range(4, 65_537, 4) if sd.sdca_smem_bytes(b) <= native.MAX_SMEM_BYTES]
    assert shared == list(range(4, 12_385, 4))
    # the SDCA cluster's: its fixed part, a slice's v and alpha and a ring of
    # at least one 32 KB stage at every bucket whose K fits the card
    from repro_torch.kernels.sdca import slice_cols

    for b in range(12_416, 141_313, 64):
        fixed = 42_496 + 12 * slice_cols(b)
        assert fixed + 32_784 <= sd.sdca_cluster_smem_bytes(b) <= native.MAX_SMEM_BYTES, b
    assert sd.sdca_cluster_smem_bytes(16_384) == 218_704
