"""Kernel dispatch and registry of the port.

Dispatch policy: a call whose tensors lie on the CPU runs the kernel's
plain PyTorch version; a call whose tensors lie on a CUDA device
launches the hand-written kernel, which raises if it cannot take the
inputs. There is no fallback from one to the other. Every dispatcher
goes through ``obs.profile.maybe_profile``, as the reference's do: with
a tracer installed each call is timed to completion and becomes a
``kernel.<name>`` span with its roofline accounting; without one the
hook is a tail call.

``KERNEL_REGISTRY`` mirrors ``repro/kernels/ops.py``'s: each entry holds
the kernel, its plain version, the dispatcher, ``make_inputs(rng)`` (a
positional numpy argument tuple the reference's dispatcher of the same
name also accepts, SDCA aside), ``make_ragged(rng)`` (the same on shapes
off every tile multiple of the CUDA kernels: the Grams' 16-, 32- and
64-row by 64-column tiles and 32-feature staging, 128-row blocks and
128-query blocks over 64-support tiles, 64- and 128-row query tiles over
64-key tiles) and the
tolerance the parity tests and ``chip_smoke.py`` hold the pair to. ``replaces`` names the TPU kernel
(or, for SDCA, the XLA loop) each entry ports.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.kernels import batched_gram, ensemble_score as _ens, rbf_gram as _rbf, sdca as _sdca
from repro_torch.kernels import ensemble_score_q8 as _ens_q8, gram_matvec as _gmv
from repro_torch.kernels import flash_attention as _flash, rbf_gram_q8 as _q8
from repro_torch.obs.profile import maybe_profile


def _pick(name: str, t: torch.Tensor, cuda: Callable, plain: Callable) -> Callable:
    """The CUDA wrapper for a CUDA tensor, the plain version for a CPU one."""
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def batched_rbf_gram(x1, x2, gammas):
    """Per-device RBF Grams: x1 (g, m, d), x2 (g, n, d), gammas (g,) ->
    (g, m, n) fp32. Callers mask padded rows/cols themselves."""
    fn = _pick("batched_rbf_gram", x1, batched_gram.batched_rbf_gram_cuda,
               batched_gram.batched_rbf_gram_plain)
    return maybe_profile("batched_rbf_gram", fn, x1, x2, gammas)


def rbf_gram(x1, x2, gamma: float):
    """RBF Gram for one bandwidth: x1 (m, d), x2 (n, d) -> (m, n) fp32."""
    fn = _pick("rbf_gram", x1, _rbf.rbf_gram_cuda, _rbf.rbf_gram_plain)
    return maybe_profile("rbf_gram", fn, x1, x2, gamma)


def ensemble_score(x, sup, coef, gammas):
    """Mean-of-member RBF-SVM scores: x (b, d), sup (k, n_max, d),
    coef (k, n_max), gammas (k,) -> (b,) fp32."""
    fn = _pick("ensemble_score", x, _ens.ensemble_score_cuda, _ens.ensemble_score_plain)
    return maybe_profile("ensemble_score", fn, x, sup, coef, gammas)


def gram_matvec(x1, x2, v, gamma: float):
    """Streaming ``K(x1, x2; gamma) @ v``: x1 (m, d), x2 (n, d), v (n,)
    -> (m,) fp32, without the (m, n) Gram."""
    fn = _pick("gram_matvec", x1, _gmv.gram_matvec_cuda, _gmv.gram_matvec_plain)
    return maybe_profile("gram_matvec", fn, x1, x2, v, gamma)


def rbf_gram_q8(x, q, scale, zero, gamma: float):
    """RBF Gram against per-column affine int8 supports: x (m, d) fp32,
    q (n, d) int8, scale and zero (d,) -> (m, n) fp32."""
    fn = _pick("rbf_gram_q8", x, _q8.rbf_gram_q8_cuda, _q8.rbf_gram_q8_plain)
    return maybe_profile("rbf_gram_q8", fn, x, q, scale, zero, gamma)


def ensemble_score_q8(x, q, scale, zero, coef, gammas):
    """Mean-of-member scores from int8 supports: x (b, d), q (k, n_max, d)
    int8, scale and zero (k, d), coef (k, n_max), gammas (k,) -> (b,)."""
    fn = _pick("ensemble_score_q8", x, _ens_q8.ensemble_score_q8_cuda,
               _ens_q8.ensemble_score_q8_plain)
    return maybe_profile("ensemble_score_q8", fn, x, q, scale, zero, coef, gammas)


def sdca(K, y, n_real, lam: float, epochs: int = 20):
    """Batched cyclic SDCA: K (g, b, b), y (g, b), n_real (g,) int32 ->
    alpha (g, b)."""
    fn = _pick("sdca", K, _sdca.sdca_cuda, _sdca.sdca_plain)
    return maybe_profile("sdca", fn, K, y, n_real, lam, epochs)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """GQA attention: q (B, Sq, H, hd), k and v (B, Skv, K, hd) ->
    (B, Sq, H, hd) in q's dtype, with causal and sliding-window masks, at
    any head dim and float types (mixed ones computed in fp32, as the
    reference's kernel computes them). On a CUDA tensor the kernel has no
    backward: under grad mode with an input that requires grad it raises
    (``native.refuse_grad``)."""
    fn = _pick("flash_attention", q, _flash.flash_attention_cuda, _flash.flash_attention_plain)
    return maybe_profile("flash_attention", fn, q, k, v, causal, window)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ported kernel: CUDA wrapper + plain version + dispatcher."""

    name: str
    kernel: Callable
    plain: Callable
    dispatch: Callable
    make_inputs: Callable[[np.random.Generator], tuple]
    make_ragged: Callable[[np.random.Generator], tuple]
    counter: object
    replaces: str
    source: str
    tol: float = 1e-5


def _mk_rbf_gram(rng):
    return (rng.normal(size=(48, 12)).astype(np.float32),
            rng.normal(size=(40, 12)).astype(np.float32), 0.4)


def _mk_batched_rbf_gram(rng):
    return (rng.normal(size=(4, 48, 12)).astype(np.float32),
            rng.normal(size=(4, 40, 12)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=4).astype(np.float32))


def _mk_ensemble_score(rng):
    return (rng.normal(size=(40, 12)).astype(np.float32),
            rng.normal(size=(3, 48, 12)).astype(np.float32),
            (rng.normal(size=(3, 48)) / 48).astype(np.float32),
            rng.uniform(0.1, 1.0, size=3).astype(np.float32))


def _mk_gram_matvec(rng):
    return (rng.normal(size=(48, 12)).astype(np.float32),
            rng.normal(size=(40, 12)).astype(np.float32),
            rng.normal(size=(40,)).astype(np.float32), 0.4)


def _mk_rbf_gram_q8(rng):
    return (rng.normal(size=(48, 12)).astype(np.float32),
            rng.integers(-127, 128, size=(40, 12)).astype(np.int8),
            rng.uniform(0.005, 0.1, size=12).astype(np.float32),
            rng.normal(size=12).astype(np.float32), 0.4)


def _mk_ensemble_score_q8(rng):
    return (rng.normal(size=(40, 12)).astype(np.float32),
            rng.integers(-127, 128, size=(3, 48, 12)).astype(np.int8),
            rng.uniform(0.005, 0.05, size=(3, 12)).astype(np.float32),
            rng.normal(size=(3, 12)).astype(np.float32),
            (rng.normal(size=(3, 48)) / 48).astype(np.float32),
            rng.uniform(0.1, 1.0, size=3).astype(np.float32))


def make_sdca_problem(rng, g: int, b: int, d: int, n_real, lam: float = 0.01,
                      epochs: int = 20) -> tuple:
    """A padded batch of SDCA problems as the engine builds them: masked
    RBF Grams of random data, labels padded with +1, int32 counts."""
    n_real = np.asarray(n_real, np.int32)
    x = rng.normal(size=(g, b, d)).astype(np.float32)
    y = np.where(rng.random((g, b)) < 0.5, 1.0, -1.0).astype(np.float32)
    gam = np.float32(1.0 / d)
    sq = (x * x).sum(-1)
    d2 = np.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * x @ x.transpose(0, 2, 1), 0.0)
    K = np.exp(-gam * d2).astype(np.float32)
    valid = np.arange(b)[None, :] < n_real[:, None]
    K = K * (valid[:, :, None] & valid[:, None, :])
    y = np.where(valid, y, np.float32(1.0)).astype(np.float32)
    return K.astype(np.float32), y, n_real, lam, epochs


def ideal_rows(seed: int = 0, scale: float = 0.05, cap: int = 2000) -> tuple:
    """(x, y): the pooled-data ideal's training rows as ``run_protocol``'s
    ``round.ideal`` draws them on ``make_dataset("emnist", seed, scale)``:
    every device's train split pooled, ``cap`` rows drawn by
    ``default_rng(seed)``. ``train_svm`` takes their RBF Gram at
    ``default_gamma(x)`` with one ``rbf_gram`` launch."""
    from repro_torch.data import make_dataset
    from repro_torch.data.partition import derive_device_seed, split_train_test_val

    ds = make_dataset("emnist", seed=seed, scale=scale)
    trains = [split_train_test_val(dev, seed=derive_device_seed(seed, i))["train"]
              for i, dev in enumerate(ds.devices)]
    x = np.concatenate([t.x for t in trains])
    y = np.concatenate([t.y for t in trains])
    if len(y) > cap:
        idx = np.random.default_rng(seed).choice(len(y), cap, replace=False)
        x, y = x[idx], y[idx]
    return np.ascontiguousarray(x, np.float32), y


def make_ideal_sdca_problem(seed: int = 0, scale: float = 0.05, cap: int = 2000,
                            lam: float = 0.01, epochs: int = 20) -> tuple:
    """The pooled-data ideal's SDCA problem as ``run_protocol``'s
    ``round.ideal`` builds it on ``make_dataset("emnist", seed, scale)``:
    ``ideal_rows``' rows, the RBF Gram at ``default_gamma`` (its plain
    version, on the host), padded as ``train_svm`` pads it (2,000 rows
    to a bucket of 2,048). Unlike ``make_sdca_problem``'s random data,
    many of its alphas end strictly inside (0, 1)."""
    from repro_torch.core.svm import SDCA_BUCKET, default_gamma

    x, y = ideal_rows(seed, scale, cap)
    n = len(y)
    b = max(-(-n // SDCA_BUCKET) * SDCA_BUCKET, SDCA_BUCKET)
    xt = torch.from_numpy(x)
    K = np.zeros((1, b, b), np.float32)
    K[0, :n, :n] = _rbf.rbf_gram_plain(xt, xt, default_gamma(x)).numpy()
    yp = np.ones((1, b), np.float32)
    yp[0, :n] = y
    return K, yp, np.asarray([n], np.int32), lam, epochs


def bucket_groups(dataset, seed: int = 0, group_cap: int = 256) -> list:
    """The bucketed engine's groups on ``dataset``, in the order it trains
    them (``sim/engine.py::iter_population``): ``[(bucket, members,
    pad_floor)]`` with members ``[(dev_id, splits)]``."""
    from repro_torch.sim.engine import _bucket_group_caps, _classify_device

    by_bucket: Dict[int, list] = {}
    for i, dev in enumerate(dataset.devices):
        bucket, payload = _classify_device(i, dev, dataset.min_samples, seed=seed)
        if bucket is not None:
            by_bucket.setdefault(bucket, []).append((i, payload))
    groups = []
    for bucket in sorted(by_bucket):
        members = by_bucket[bucket]
        cap = _bucket_group_caps(bucket, group_cap)
        groups += [(bucket, members[lo:lo + cap], min(8, cap))
                   for lo in range(0, len(members), cap)]
    return groups


def round_gram_launches(dataset, seed: int = 0, group_cap: int = 256) -> list:
    """The bucketed round's ``batched_rbf_gram`` launches on ``dataset``,
    in order: per group a fit ``(g, b, b)`` with x2 = x1, then the val
    and test scores ``(g, q, b)`` (``_train_bucket_group``'s padding).
    Returns ``[(kind, g, m, n, d)]`` with kind "fit", "val" or "test"."""
    from repro_torch.sim.engine import QUERY_PAD, _pad_pow2

    out = []
    for bucket, members, pad_floor in bucket_groups(dataset, seed, group_cap):
        g = _pad_pow2(len(members), lo=pad_floor)
        d = members[0][1]["train"].x.shape[1]
        out.append(("fit", g, bucket, bucket, d))
        for split in ("val", "test"):
            q = -(-max(sp[split].n for _, sp in members) // QUERY_PAD) * QUERY_PAD
            out.append((split, g, q, bucket, d))
    return out


def pack_fit_group(bucket: int, members: list, pad_floor: int) -> tuple:
    """One group's fit Gram input packed as
    ``sim/engine.py::_train_bucket_group`` packs it: each member's train
    rows zero-padded to ``bucket`` rows, the group padded with zero
    devices to a power of two, gammas each member's ``default_gamma``
    (1 for a padding device). Returns ``(xp, xp, gammas)``,
    ``batched_rbf_gram``'s arguments, x2 the same array as x1 as the fit
    passes it."""
    from repro_torch.core.svm import default_gamma
    from repro_torch.sim.engine import _pad_pow2

    trains = [sp["train"] for _, sp in members]
    g = _pad_pow2(len(members), lo=pad_floor)
    xp = np.zeros((g, bucket, trains[0].x.shape[1]), np.float32)
    gammas = np.ones(g, np.float32)
    for i, t in enumerate(trains):
        xp[i, :t.n] = t.x
        gammas[i] = default_gamma(t.x)
    return xp, xp, gammas


def make_fit_group_problem(seed: int = 0, scale: float = 1.0) -> tuple:
    """The first bucket-64 group's fit Gram input of the bucketed round on
    ``make_dataset("emnist", seed, scale)``, packed by ``pack_fit_group``.
    At scale 1.0 that is g 256 x b 64 x d 32 of real emnist-like rows
    with padded rows, which random normals never have."""
    from repro_torch.data import make_dataset

    groups = bucket_groups(make_dataset("emnist", seed=seed, scale=scale), seed)
    return pack_fit_group(*next(grp for grp in groups if grp[0] == 64))


def population_fit_group(seed: int = 0, chunk_devices: int = 1024) -> tuple:
    """``(bucket, members, pad_floor)`` of the first group the streamed
    round trains on the dirichlet population (alpha 0.3, 80 samples a
    device, d 16): the first bucket-64 group of its first chunk of
    ``chunk_devices`` devices (device i does not depend on the
    population's size, so a stream of one chunk holds it)."""
    from repro_torch.sim.scenarios import device_stream

    fed = device_stream("dirichlet", n_devices=chunk_devices, seed=seed, mean_samples=80,
                        dim=16, alpha=0.3).materialize()
    return next(grp for grp in bucket_groups(fed.dataset, seed) if grp[0] == 64)


def make_population_fit_group_problem(seed: int = 0) -> tuple:
    """``population_fit_group``'s fit Gram input (g 256 x b 64 x d 16),
    packed by ``pack_fit_group``."""
    return pack_fit_group(*population_fit_group(seed))


def make_population_sdca_problem(seed: int = 0, lam: float = 0.01,
                                 epochs: int = 20) -> tuple:
    """``population_fit_group``'s SDCA problem as ``sim/engine.py::_fit_group``
    builds it: the fit Gram (its plain version, on the host) with padded
    rows and columns zeroed, labels padded with +1, int32 counts. Returns
    ``sdca``'s arguments ``(K, y, n_real, lam, epochs)``, g 256 x b 64."""
    bucket, members, pad_floor = population_fit_group(seed)
    xp, _, gammas = pack_fit_group(bucket, members, pad_floor)
    g = len(xp)
    n_real = np.zeros(g, np.int32)
    n_real[:len(members)] = [sp["train"].n for _, sp in members]
    yp = np.ones((g, bucket), np.float32)
    for i, (_, sp) in enumerate(members):
        yp[i, :sp["train"].n] = sp["train"].y
    x = torch.from_numpy(xp)
    K = batched_gram.batched_rbf_gram_plain(x, x, torch.from_numpy(gammas)).numpy()
    valid = np.arange(bucket)[None, :] < n_real[:, None]
    K = K * (valid[:, :, None] & valid[:, None, :])
    return np.ascontiguousarray(K, np.float32), yp, n_real, lam, epochs


def _emnist_devices(seed: int, scale: float) -> list:
    """Each device of ``make_dataset("emnist", seed, scale)`` with its
    train / test / val splits, as ``run_protocol`` splits them."""
    from types import SimpleNamespace

    from repro_torch.data import make_dataset
    from repro_torch.data.partition import derive_device_seed, split_train_test_val

    ds = make_dataset("emnist", seed=seed, scale=scale)
    return [SimpleNamespace(splits=split_train_test_val(dev, derive_device_seed(seed, i)))
            for i, dev in enumerate(ds.devices)]


def _cg_proxy(devices: list, seed: int, l: int):
    """(deduped proxy rows, the generator that drew them): ``l`` rows of
    the ``validation`` proxy source with ``default_rng(seed)``, deduped as
    ``distill_teacher`` dedupes them."""
    from repro_torch.distill.proxy import make_proxy
    from repro_torch.distill.solvers import dedupe_proxy

    rng = np.random.default_rng(seed)
    return dedupe_proxy(make_proxy("validation", n=l, rng=rng, devices=devices)), rng


def make_cg_matvec_problem(seed: int = 0, scale: float = 0.15, l: int = 4096) -> tuple:
    """The distillation CG's matvec input on ``make_dataset("emnist", seed,
    scale)``: every device's validation split pooled, ``l`` rows drawn by
    the ``validation`` proxy source with ``default_rng(seed)``, deduped
    as ``distill_teacher`` dedupes them, gamma = ``default_gamma`` of the
    rows (about 1 / |x|^2), and v seeded normal from the same generator.
    Returns ``(xp, xp, v, gamma)``, the matvec's arguments."""
    from repro_torch.core.svm import default_gamma

    xp, rng = _cg_proxy(_emnist_devices(seed, scale), seed, l)
    v = rng.normal(size=len(xp)).astype(np.float32)
    return xp, xp, v, default_gamma(xp)


def make_q8_student_problem(seed: int = 0, scale: float = 0.15, l: int = 4096,
                            b: int = 8192) -> tuple:
    """The int8 student's scoring input on the same federation as
    ``make_cg_matvec_problem``: its supports are that problem's deduped
    validation-pool proxy rows, quantised by the int8 codec
    (``comm/wire.py::_quantize_columns``, as ``encode(student, "int8")``
    does), gamma is their ``default_gamma``, and the queries are the first
    ``b`` pooled test rows, the first chunk ``QuantizedSVM.predict`` gets
    from the round's evaluation. Returns ``(x, q, scale, zero, gamma)``,
    ``rbf_gram_q8``'s arguments."""
    from repro_torch.comm.wire import _quantize_columns
    from repro_torch.core.svm import default_gamma

    devices = _emnist_devices(seed, scale)
    xp, _ = _cg_proxy(devices, seed, l)
    q, sc, ze = _quantize_columns(xp)
    x = np.concatenate([dev.splits["test"].x for dev in devices])[:b]
    return np.ascontiguousarray(x, np.float32), q, sc, ze, default_gamma(xp)


def _mk_sdca(rng):
    return make_sdca_problem(rng, g=3, b=64, d=12, n_real=[64, 40, 17])


def _ragged_rbf_gram(rng):
    return (rng.normal(size=(130, 37)).astype(np.float32),
            rng.normal(size=(67, 37)).astype(np.float32), 0.03)


def _ragged_batched_rbf_gram(rng):
    return (rng.normal(size=(3, 77, 24)).astype(np.float32),
            rng.normal(size=(3, 45, 24)).astype(np.float32),
            rng.uniform(0.02, 0.2, size=3).astype(np.float32))


def _ragged_ensemble_score(rng):
    return (rng.normal(size=(37, 24)).astype(np.float32),
            rng.normal(size=(5, 77, 24)).astype(np.float32),
            (rng.normal(size=(5, 77)) / 77).astype(np.float32),
            rng.uniform(0.02, 0.2, size=5).astype(np.float32))


def _ragged_gram_matvec(rng):
    return (rng.normal(size=(77, 37)).astype(np.float32),
            rng.normal(size=(131, 37)).astype(np.float32),
            rng.normal(size=(131,)).astype(np.float32), 0.03)


def _ragged_rbf_gram_q8(rng):
    return (rng.normal(size=(130, 37)).astype(np.float32),
            rng.integers(-127, 128, size=(67, 37)).astype(np.int8),
            rng.uniform(0.002, 0.02, size=37).astype(np.float32),
            rng.normal(size=37).astype(np.float32), 0.03)


def _ragged_ensemble_score_q8(rng):
    return (rng.normal(size=(37, 24)).astype(np.float32),
            rng.integers(-127, 128, size=(5, 77, 24)).astype(np.int8),
            rng.uniform(0.002, 0.02, size=(5, 24)).astype(np.float32),
            rng.normal(size=(5, 24)).astype(np.float32),
            (rng.normal(size=(5, 77)) / 77).astype(np.float32),
            rng.uniform(0.02, 0.2, size=5).astype(np.float32))


def _mk_flash_attention(rng):
    return tuple(rng.normal(size=(4, 64, 2, 16)).astype(np.float32) for _ in range(3))


def _ragged_flash_attention(rng):
    return (rng.normal(size=(2, 77, 6, 32)).astype(np.float32),
            rng.normal(size=(2, 77, 2, 32)).astype(np.float32),
            rng.normal(size=(2, 77, 2, 32)).astype(np.float32))


def _ragged_sdca(rng):
    return make_sdca_problem(rng, g=4, b=100, d=24, n_real=[100, 63, 1, 31])


KERNEL_REGISTRY: Dict[str, KernelSpec] = {
    spec.name: spec
    for spec in (
        KernelSpec("batched_rbf_gram", batched_gram.batched_rbf_gram_cuda,
                   batched_gram.batched_rbf_gram_plain, batched_rbf_gram,
                   _mk_batched_rbf_gram, _ragged_batched_rbf_gram, batched_gram.LAUNCHES,
                   replaces="src/repro/kernels/batched_gram.py:54",
                   source="src/repro_torch/kernels/csrc/gram.cu"),
        KernelSpec("rbf_gram", _rbf.rbf_gram_cuda, _rbf.rbf_gram_plain, rbf_gram,
                   _mk_rbf_gram, _ragged_rbf_gram, _rbf.LAUNCHES,
                   replaces="src/repro/kernels/rbf_gram.py:35",
                   source="src/repro_torch/kernels/csrc/gram.cu"),
        KernelSpec("ensemble_score", _ens.ensemble_score_cuda,
                   _ens.ensemble_score_plain, ensemble_score,
                   _mk_ensemble_score, _ragged_ensemble_score, _ens.LAUNCHES,
                   replaces="src/repro/kernels/ensemble_score.py:74",
                   source="src/repro_torch/kernels/csrc/ensemble_score.cu",
                   tol=1e-4),
        KernelSpec("sdca", _sdca.sdca_cuda, _sdca.sdca_plain, sdca, _mk_sdca,
                   _ragged_sdca, _sdca.LAUNCHES, replaces="src/repro/core/svm.py:45",
                   source="src/repro_torch/kernels/csrc/sdca.cu"),
        KernelSpec("gram_matvec", _gmv.gram_matvec_cuda, _gmv.gram_matvec_plain,
                   gram_matvec, _mk_gram_matvec, _ragged_gram_matvec, _gmv.LAUNCHES,
                   replaces="src/repro/kernels/gram_matvec.py:65",
                   source="src/repro_torch/kernels/csrc/gram_matvec.cu"),
        KernelSpec("rbf_gram_q8", _q8.rbf_gram_q8_cuda, _q8.rbf_gram_q8_plain,
                   rbf_gram_q8, _mk_rbf_gram_q8, _ragged_rbf_gram_q8, _q8.LAUNCHES,
                   replaces="src/repro/kernels/rbf_gram_q8.py:53",
                   source="src/repro_torch/kernels/csrc/gram_q8.cu"),
        KernelSpec("ensemble_score_q8", _ens_q8.ensemble_score_q8_cuda,
                   _ens_q8.ensemble_score_q8_plain, ensemble_score_q8,
                   _mk_ensemble_score_q8, _ragged_ensemble_score_q8, _ens_q8.LAUNCHES,
                   replaces="src/repro/kernels/ensemble_score_q8.py:72",
                   source="src/repro_torch/kernels/csrc/ensemble_score.cu",
                   tol=1e-4),
        KernelSpec("flash_attention", _flash.flash_attention_cuda,
                   _flash.flash_attention_plain, flash_attention,
                   _mk_flash_attention, _ragged_flash_attention, _flash.LAUNCHES,
                   replaces="src/repro/kernels/flash_attention.py:68",
                   # the serve path's bf16 kernel (fp16: csrc/flash_attention_tc_f16.cu,
                   # the same code; fp32 and mixed types: csrc/flash_attention.cu)
                   source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                   tol=2e-5),
    )
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per registered kernel since the last reset."""
    return {name: spec.counter.count for name, spec in KERNEL_REGISTRY.items()}


def reset_launch_counts() -> None:
    for spec in KERNEL_REGISTRY.values():
        spec.counter.reset()
