"""Design choices of the port's redesigned CUDA kernels, checked on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
What can be held here is the plan and the arithmetic they follow:

- ``ensemble_score``'s split plan (``kernels/ensemble_score.py::split_plan``)
  covers every (member, support tile) work item exactly once and is chosen
  without the query count, so a query's score cannot depend on b;
- the bf16 tensor-core flash kernel's arithmetic (``csrc/flash_attention_tc.cu``),
  emulated in plain PyTorch: bf16 products summed in fp32, the online softmax
  in the log2 domain over 64-key tiles, P split into two bf16 parts for P V.
  The emulation stays within the on-card bf16 tolerance of the plain version
  and of the JAX reference's oracle.
"""
import importlib.util
import inspect
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.utils.seeds import derive_stream_seed
from repro_torch.kernels import ensemble_score as ens
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain

ROOT = Path(__file__).resolve().parents[1]
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4   # chip_smoke.py's bf16 tolerance
BQ, BK = 128, 64                         # query rows and keys per tile, as the kernel
LOG2E = 1.4426950408889634


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(11, purpose, index))


def _flash_shapes():
    """chip_smoke.py's FLASH_SHAPES (it imports nothing but the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_SHAPES


# ----------------------------------------------------------------------
# the scorer's split plan
# ----------------------------------------------------------------------

def test_split_plan_does_not_take_the_query_count():
    assert list(inspect.signature(ens.split_plan).parameters) == ["k", "n_max"]


@pytest.mark.parametrize("n_max", [48, 77, 230, 2000])
@pytest.mark.parametrize("k", [1, 3, 100, 2821])
def test_split_plan_covers_every_item_once(k, n_max):
    plan = ens.split_plan(k, n_max)
    assert plan.tiles == -(-n_max // ens.SUPPORT_TILE)
    assert 1 <= plan.splits <= ens.SPLIT_TARGET
    seen = [item for s in range(plan.splits) for item in plan.work(s)]
    want = [(t, j) for t in range(k) for j in range(plan.tiles)]
    assert seen == want                      # each once, member-major, in split order
    assert all(plan.work(s) for s in range(plan.splits))   # no empty split
    assert plan.work(plan.splits) == []
    # one item a split while the items are few; else close to the target
    if plan.items <= ens.SPLIT_TARGET:
        assert plan.per_split == 1 and plan.splits == plan.items
    else:
        assert 2 * plan.splits > ens.SPLIT_TARGET


# ----------------------------------------------------------------------
# the bf16 tensor-core flash kernel's arithmetic
# ----------------------------------------------------------------------

def _tile_range(q0, q_last, Skv, causal, window):
    """The kernel's kv tiles for a query tile (flash_attention_tc.cu)."""
    t_lo, t_hi = 0, -(-Skv // BK)
    if not (window > 0 and q_last - window + 1 >= Skv):
        if causal:
            t_hi = min(t_hi, q_last // BK + 1)
        if window > 0:
            t_lo = max(0, q0 - window + 1) // BK
    return t_lo, t_hi


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_tc_emulated(q, k, v, causal=True, window=0):
    """The tensor-core kernel's arithmetic in plain PyTorch, one 128-row
    query tile at a time: fp32 scores from the bf16 inputs, scaled into the log2
    domain and masked (-inf past Skv, -1e9 for causal and window), the
    online softmax over 64-key tiles with exp2, P V as P_hi V + P_lo V with
    P_hi = bf16(p) and P_lo = bf16(p - P_hi), the output acc / max(l, 1e-20)
    rounded once to bf16."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rep = H // K
    scale2 = np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E)
    qf = q.float().permute(0, 2, 1, 3)                                    # (B, H, Sq, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)      # (B, H, Skv, hd)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        t_lo, t_hi = _tile_range(q0, int(rows[-1]), Skv, causal, window)
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), hd))
        for t in range(t_lo, t_hi):
            keys = torch.arange(t * BK, min(t * BK + BK, Skv))
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows], kf[:, :, keys]) * scale2
            kp, qp = keys[None, :], rows[:, None]
            masked = torch.zeros((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                masked |= kp > qp
            if window > 0:
                masked |= kp <= qp - window
            s = torch.where(masked, torch.tensor(NEG_INF), s)
            # the kernel's tile is 64 keys wide: keys past Skv are -inf, p = 0
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = corr * l + p.sum(-1)
            p_hi = _bf16(p)
            p_lo = _bf16(p - p_hi)
            vt = vf[:, :, keys]
            acc = corr[..., None] * acc + (p_hi @ vt + p_lo @ vt)
            m = mx
        out[:, :, rows] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _flash_cases():
    cases = [("registry", ops.KERNEL_REGISTRY["flash_attention"].make_inputs, True, 0),
             ("ragged", ops.KERNEL_REGISTRY["flash_attention"].make_ragged, True, 0),
             ("ragged non-causal window16", ops.KERNEL_REGISTRY["flash_attention"].make_ragged,
              False, 16)]
    for label, (B, S, H, K, hd), causal, window in _flash_shapes():
        if label.startswith("serve"):   # the full serve shape runs on the card only
            continue
        cases.append((label, (B, S, H, K, hd), causal, window))
    return cases


FLASH_CASES = _flash_cases()


def _flash_inputs(case, rng):
    _, shape, causal, window = case
    if callable(shape):
        q, k, v = shape(rng)
    else:
        B, S, H, K, hd = shape
        q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, K, K))
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal, window


@pytest.mark.parametrize("case", range(len(FLASH_CASES)),
                         ids=[c[0].replace(" ", "-") for c in FLASH_CASES])
def test_flash_tc_arithmetic_holds_the_bf16_tolerance(case):
    """The emulated kernel against the plain version (both in bf16, compared
    in fp32) at chip_smoke.py's bf16 tolerance, 1e-4 + 2^-7 |plain|, and
    against the reference's oracle on the same bf16 values at the same
    tolerance."""
    (q, k, v), causal, window = _flash_inputs(FLASH_CASES[case], _rng("flash-tc", case))
    got = flash_tc_emulated(q, k, v, causal, window).float()
    want = flash_attention_plain(q, k, v, causal, window).float()
    assert bool(((got - want).abs() <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    oracle = np.asarray(ref.flash_attention_ref(  # repro: allow[kernel-registry-bypass] reason=parity test against the reference's oracle, as tests/test_kernels.py does
        *(t.float().numpy() for t in (q, k, v)), causal=causal, window=window))
    assert np.all(np.abs(got.numpy() - oracle) <= BF16_ATOL + BF16_RTOL * np.abs(oracle))


def test_two_part_p_keeps_sixteen_bits():
    """P_hi + P_lo is within 2^-16 of p relative, where one bf16 is only
    within 2^-8: the reason the kernel runs P V twice."""
    p = torch.from_numpy(_rng("p-split").random(100_000).astype(np.float32))
    p_hi = _bf16(p)
    two = p_hi + _bf16(p - p_hi)
    assert float(((two - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((p_hi - p).abs() / p).max()) > 2.0 ** -10
