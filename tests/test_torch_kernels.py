"""The port's kernel layer against the reference's dispatchers.

On the CPU each plain PyTorch version is held to the JAX package's
``repro.kernels.ops`` dispatcher (its jnp oracle off the TPU) on the
registry's ``make_inputs`` and on a ragged shape, at the registry's
tolerance; the plain SDCA is held to ``repro.core.svm._sdca``. The
hand-written CUDA kernels run only on the card, where
``tests/test_torch_cuda.py`` holds each against its plain version.
"""
import numpy as np
import pytest
import torch

from repro.core.svm import _sdca as ref_sdca
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.utils.seeds import derive_stream_seed
from repro_torch.kernels import native
from repro_torch.kernels import ops

NAMES = sorted(ops.KERNEL_REGISTRY)
JAX_DISPATCH = {
    "batched_rbf_gram": ref_ops.batched_rbf_gram,
    "rbf_gram": ref_ops.rbf_gram,
    "ensemble_score": ref_ops.ensemble_score,
    "gram_matvec": ref_ops.gram_matvec,
    "rbf_gram_q8": ref_ops.rbf_gram_q8,
    "ensemble_score_q8": ref_ops.ensemble_score_q8,
    "flash_attention": ref_ops.flash_attention,
}


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(5, purpose, index))


def _torch_args(args, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in args)


def _sdca_reference(K, y, n_real, lam, epochs):
    return np.stack([np.asarray(ref_sdca(K[t], y[t], int(n_real[t]), lam, epochs))
                     for t in range(len(K))])


def _reference(name, args):
    if name == "sdca":
        return _sdca_reference(*args)
    return np.asarray(JAX_DISPATCH[name](*args))


@pytest.mark.parametrize("shape", ["registry", "ragged"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_reference(name, shape):
    spec = ops.KERNEL_REGISTRY[name]
    rng = _rng(name + shape)
    args = (spec.make_inputs if shape == "registry" else spec.make_ragged)(rng)
    want = _reference(name, args)
    got = spec.dispatch(*_torch_args(args)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=spec.tol, rtol=0)


FLASH_MASKS = {
    "causal-window16": dict(causal=True, window=16),
    "non-causal": dict(causal=False, window=0),
    "non-causal-window16": dict(causal=False, window=16),
}


@pytest.mark.parametrize("shape", ["registry", "ragged"])
@pytest.mark.parametrize("mask", sorted(FLASH_MASKS))
def test_plain_flash_attention_matches_the_oracle_under_every_mask(mask, shape):
    """Against ``flash_attention_ref`` at 2e-5. The ragged shape (77 keys,
    off every 64-tile) with a window and no causal mask is the case the
    TPU kernel gets wrong (it attends to its zero-padded keys)."""
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    q, k, v = (spec.make_inputs if shape == "registry" else spec.make_ragged)(
        _rng("flash-" + mask + shape))
    kw = FLASH_MASKS[mask]
    want = np.asarray(ref.flash_attention_ref(q, k, v, **kw))  # repro: allow[kernel-registry-bypass] reason=parity test against the reference's oracle, as tests/test_kernels.py does
    got = ops.flash_attention(*_torch_args((q, k, v)), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=spec.tol, rtol=0)


def test_plain_flash_attention_matches_the_interpreted_pallas_kernel():
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    args = spec.make_inputs(_rng("flash-interpret"))
    want = np.asarray(flash_attention_pallas(*args, interpret=True))  # repro: allow[kernel-registry-bypass] reason=parity test against the TPU kernel in interpret mode, as tests/test_kernels.py does
    got = ops.flash_attention(*_torch_args(args)).numpy()
    np.testing.assert_allclose(got, want, atol=spec.tol, rtol=0)


def test_plain_flash_attention_keeps_bf16_and_refuses_bad_heads():
    spec = ops.KERNEL_REGISTRY["flash_attention"]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in spec.make_ragged(_rng("flash-bf16")))
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :5], k, v)


@pytest.mark.parametrize("bucket,n_real", [(64, [64, 40, 17, 2]), (128, [128, 65, 100, 70]),
                                           (192, [150, 191, 129, 130])])
def test_plain_sdca_matches_reference_on_engine_buckets(bucket, n_real):
    """Padded problems as the engine builds them: zero Gram rows/cols
    past n_real, +1 label padding; alpha within 1e-5."""
    args = ops.make_sdca_problem(_rng("sdca-bucket", bucket), g=4, b=bucket, d=32,
                                 n_real=n_real)
    got = ops.sdca(*_torch_args(args)).numpy()
    want = _sdca_reference(*args)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got >= 0) and np.all(got <= 1)
    for t, n in enumerate(n_real):
        assert np.all(got[t, n:] == 0)


def test_batched_gram_keeps_the_padding_contract():
    """A zero-padded row is NOT masked: exp(-gamma |x|^2) != 0."""
    x = np.zeros((1, 3, 4), np.float32)
    x[0, 0] = 1.0
    g = np.array([0.5], np.float32)
    out = ops.batched_rbf_gram(*_torch_args((x, x, g))).numpy()
    np.testing.assert_allclose(out[0, 0, 1], np.exp(-0.5 * 4.0), rtol=1e-6)
    np.testing.assert_allclose(out[0, 1, 2], 1.0)


def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing():
    ops.reset_launch_counts()
    for name in NAMES:
        spec = ops.KERNEL_REGISTRY[name]
        spec.dispatch(*_torch_args(spec.make_inputs(_rng("count", len(name)))))
    assert ops.launch_counts() == {name: 0 for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_refuses_cpu_tensors(name):
    """The CUDA wrappers take CUDA tensors only; no silent CPU path."""
    spec = ops.KERNEL_REGISTRY[name]
    with pytest.raises(ValueError, match="CUDA"):
        spec.kernel(*_torch_args(spec.make_inputs(_rng("refuse"))))


def test_registry_names_sources_and_replaced_kernels():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert NAMES == ["batched_rbf_gram", "ensemble_score", "ensemble_score_q8",
                     "flash_attention", "gram_matvec", "rbf_gram", "rbf_gram_q8", "sdca"]
    for spec in ops.KERNEL_REGISTRY.values():
        assert (root / spec.source).is_file()
        path, line = spec.replaces.split(":")
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), (spec.name, text)
    assert {s.tol for s in ops.KERNEL_REGISTRY.values()} == {1e-5, 2e-5, 1e-4}
    assert ops.KERNEL_REGISTRY["flash_attention"].tol == 2e-5
    assert ops.KERNEL_REGISTRY["ensemble_score"].tol == 1e-4
    assert ops.KERNEL_REGISTRY["ensemble_score_q8"].tol == 1e-4
    assert ops.KERNEL_REGISTRY["gram_matvec"].tol == ops.KERNEL_REGISTRY["rbf_gram_q8"].tol == 1e-5


def test_build_is_keyed_by_source_content():
    h = native.source_hash()
    assert len(h) == 16 and native.build_dir().name == h
    assert sorted(p.stem for p in native.CSRC.glob("*.cu")) == sorted(native.SOURCES)


def test_every_bound_function_is_exported_by_its_source():
    import re

    assert sorted(native.SIGNATURES) == sorted(native.SOURCES)
    for name, fns in native.SIGNATURES.items():
        text = (native.CSRC / f"{name}.cu").read_text()
        exported = set(re.findall(r'extern "C" int (\w+)\(', text))
        assert exported == set(fns), name

