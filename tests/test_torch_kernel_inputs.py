"""What the SVM kernels' wrappers do with inputs the kernels do not read as they are, on the CPU.

The reference's kernels cast their inputs with ``astype(jnp.float32)``
(int8 codes with ``astype(jnp.int8)``) and take any layout, grid and
bucket. The port's CUDA kernels read contiguous, 16-byte aligned rows of
one type, SDCA's K rows 4 columns at a time, and the Grams' devices and
row tiles along grid dimensions of at most 65,535; so the wrappers:

- cast each tensor to the kernel's type and copy a non-contiguous or
  misaligned one once, and leave a tensor that needs neither as it is, so
  the port's own paths copy nothing (``native.kernel_inputs``);
- pad an SDCA bucket to a multiple of 4 with masked rows
  (``sdca.pad_bucket``): the padded problem's alphas are the unpadded
  problem's (held through the plain version, and against the reference's
  ``_sdca`` at a bucket of 30);
- split a Gram call past the grid into launches that cover every output
  once (``batched_gram.launch_slices``).

The kernels themselves take these inputs on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.core.svm import _sdca as ref_sdca
from repro.utils.seeds import derive_stream_seed
from repro_torch.kernels import batched_gram as bg
from repro_torch.kernels import native, ops
from repro_torch.kernels import sdca as sdca_mod

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(31, purpose, index))


def test_inputs_the_kernels_read_as_they_are_are_not_copied():
    x = torch.randn(8, 5)
    q = torch.zeros(4, 5, dtype=torch.int8)
    got = native.kernel_inputs("k", {"q": torch.int8}, x=x, q=q, x2=x)
    assert got[0] is x and got[1] is q and got[2] is x


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16, torch.int64])
def test_other_types_are_cast_to_fp32(dtype):
    x = (torch.randn(8, 5) * 4).to(dtype)
    (got,) = native.kernel_inputs("k", x=x)
    assert got.dtype == torch.float32 and got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, x.float())


def test_layouts_get_one_contiguous_aligned_copy_and_an_alias_stays_one_tensor():
    x = torch.randn(5, 8).t()                        # not contiguous
    off = torch.randn(41)[1:].view(8, 5)             # 4 bytes off a 16-byte boundary
    assert not x.is_contiguous() and off.data_ptr() % 16
    a, a2, b = native.kernel_inputs("k", x1=x, x2=x, other=off)
    assert a is a2 and a.is_contiguous() and torch.equal(a, x)
    assert b.data_ptr() % 16 == 0 and torch.equal(b, off)
    codes = torch.tensor([[300, -2]], dtype=torch.int32)
    (q,) = native.kernel_inputs("k", {"q": torch.int8}, q=codes)   # astype(int8): wraps
    assert q.dtype == torch.int8 and q.tolist() == [[44, -2]]


def test_types_no_cast_makes_sense_of_are_refused():
    with pytest.raises(TypeError, match="int8"):
        native.kernel_inputs("k", {"q": torch.int8}, q=torch.zeros(2, 2))
    with pytest.raises(TypeError, match="float32"):
        native.kernel_inputs("k", x=torch.zeros(2, 2, dtype=torch.bool))
    with pytest.raises(TypeError, match="float32"):
        native.kernel_inputs("k", x=torch.zeros(2, 2, dtype=torch.complex64))


@pytest.mark.parametrize("b,n_real", [(30, [30, 17, 1]), (61, [61, 40, 33]), (2, [2, 1, 2])])
def test_a_padded_bucket_gives_the_unpadded_alphas(b, n_real):
    K, y, nr, lam, epochs = ops.make_sdca_problem(_rng("pad", b), g=3, b=b, d=12, n_real=n_real)
    K, y, nr = (torch.from_numpy(a) for a in (K, y, nr))
    Kp, yp = sdca_mod.pad_bucket(K, y)
    assert Kp.shape[1] % sdca_mod.GROUP == 0 and Kp.shape[1] - b < sdca_mod.GROUP
    assert torch.equal(Kp[:, :b, :b], K) and not Kp[:, b:].any() and not Kp[:, :, b:].any()
    assert torch.all(yp[:, b:] == 1.0)
    padded = sdca_mod.sdca_plain(Kp, yp, nr, lam, epochs)
    want = sdca_mod.sdca_plain(K, y, nr, lam, epochs)
    np.testing.assert_allclose(padded[:, :b].numpy(), want.numpy(), atol=1e-7, rtol=0)
    assert not padded[:, b:].any()
    ref = np.stack([np.asarray(ref_sdca(K[t].numpy(), y[t].numpy(), int(nr[t]), lam, epochs))
                    for t in range(3)])
    np.testing.assert_allclose(padded[:, :b].numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("g,m,rows", [(3, 100, 16), (65_535, 8, 16), (65_536, 8, 64),
                                      (140_000, 3, 32), (2, 65_535 * 16 + 1, 16),
                                      (1, 65_535 * 64 * 2 + 5, 64)])
def test_launch_slices_cover_every_output_once(g, m, rows):
    parts = bg.launch_slices(g, m, rows)
    assert (len(parts) == 1) == (g <= bg.MAX_GRID_Z and -(-m // rows) <= bg.MAX_GRID_Y)
    seen = {}
    for dev, rs in parts:
        assert dev.stop - dev.start <= bg.MAX_GRID_Z
        assert -(-(rs.stop - rs.start) // rows) <= bg.MAX_GRID_Y
        assert rs.start % rows == 0   # a run of rows starts on a tile
        for t in range(dev.start, dev.stop):
            seen.setdefault(t, []).append((rs.start, rs.stop))
    assert sorted(seen) == list(range(g))
    for spans in seen.values():
        assert sorted(spans)[0][0] == 0 and sorted(spans)[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(sorted(spans), sorted(spans)[1:]))
