"""Flash attention at every head dim and float type the reference takes, on the CPU.

The port's flash kernels (``kernels/flash_attention.py``) take any head dim
(built for the padded widths ``HEAD_DIMS``, chunked past 256) and q, k, v
in fp32, bf16 or fp16, or of mixed types (cast to fp32, as the reference's
kernel casts them). The CUDA kernels run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``head_dims`` phase
hold them to the plain version there); here:

- the plain version against the reference's Pallas kernel
  (``flash_attention_pallas``) run in interpret mode, at hd 1, 8, 24, 72,
  96, 100, 160, 256 and 320, in fp32, bf16, fp16 and mixed types, causal
  and causal with a window, on 40 queries and keys in 32-row blocks (GQA
  2). Non-causal calls on that ragged length are held to the reference's
  oracle, ``flash_attention_ref``, instead: the interpreted kernel refuses
  one without a window and attends to its padded keys with one.
  Tolerances: fp32 the registry's 2e-5; a 16-bit output 1e-4 plus 2^-7
  (bf16) or 2^-10 (fp16) of the reference's value, since two fp32 results
  a rounding error apart may round one step apart in a type of 8 or 11
  significant bits;
- the wrapper's rules for its inputs (``kernel_inputs``), the type a
  call runs and is priced in (``run_dtype``, ``obs.profile``), and the
  widths the two CUDA sources dispatch to;
- a reduced dense config at hd 96 with a 16-token window (2 layers,
  d_model 192, 2 heads on 1 KV head), through both packages with
  ``use_pallas``, the reference's parameters carried by ``convert.py``:
  ``forward_train`` logits, prefill and decode logits.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.config import ModelConfig as RefConfig
from repro.utils.seeds import derive_stream_seed
from repro_torch import models as pt_models
from repro_torch.convert import lm_params_from_arrays
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig as PtConfig

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
HDS = (1, 8, 24, 72, 96, 100, 160, 256, 320)
SHAPE = (1, 40, 4, 2)   # B, S, H, K: 40 is off the 32-row blocks
BLOCK = 32
WINDOW = 9
TOLS = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-4, 2.0 ** -7),
        torch.float16: (1e-4, 2.0 ** -10)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
# (q, k, v) types of each case; the interpreted kernel runs each case
# causal, and the fp32 ones also with a window
TYPES = {"fp32": (torch.float32,) * 3, "bf16": (torch.bfloat16,) * 3,
         "fp16": (torch.float16,) * 3,
         "mixed": (torch.bfloat16, torch.float32, torch.float32),
         "fp16 q bf16 k fp32 v": (torch.float16, torch.bfloat16, torch.float32)}
INTERPRETED = ([(hd, "fp32", w) for hd in HDS for w in (0, WINDOW)]
               + [(hd, t, WINDOW if t == "bf16" else 0) for hd in HDS
                  for t in ("bf16", "fp16")]
               + [(hd, "mixed", 0) for hd in (24, 96, 320)]
               + [(96, "fp16 q bf16 k fp32 v", WINDOW)])


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(30, purpose, index))


def _inputs(hd: int, types, purpose: str):
    """Seeded normals of SHAPE at ``hd``, rounded to each input's type, as
    (torch tensors, jax arrays)."""
    B, S, H, K = SHAPE
    rng = _rng(purpose, hd)
    arrays = [rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, K, K)]
    tensors = tuple(torch.from_numpy(a).to(t) for a, t in zip(arrays, types))
    return tensors, tuple(jnp.asarray(a).astype(JNP[t]) for a, t in zip(arrays, types))


def _assert_close(got: torch.Tensor, want: np.ndarray, dtype):
    atol, rtol = TOLS[dtype]
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert np.all(np.isfinite(got.float().numpy()))
    assert np.all(diff <= atol + rtol * np.abs(want)), float(diff.max())


@pytest.mark.parametrize("hd,types,window", INTERPRETED,
                         ids=[f"hd{hd}-{t.replace(' ', '-')}-w{w}" for hd, t, w in INTERPRETED])
def test_plain_flash_matches_the_interpreted_pallas_kernel(hd, types, window):
    (q, k, v), (jq, jk, jv) = _inputs(hd, TYPES[types], "interpret-" + types)
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window, block_q=BLOCK,  # repro: allow[kernel-registry-bypass] reason=parity test against the TPU kernel in interpret mode, as tests/test_kernels.py does
                                  block_k=BLOCK, interpret=True)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert want.dtype == JNP[q.dtype]   # the reference writes q's type too
    _assert_close(got, want, q.dtype)


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("hd", HDS)
def test_plain_flash_non_causal_matches_the_oracle(hd, window):
    (q, k, v), (jq, jk, jv) = _inputs(hd, TYPES["fp32"], "oracle")
    if window == 0:   # the interpreted kernel takes no ragged non-causal call
        with pytest.raises(ValueError, match="bk-aligned"):
            flash_attention_pallas(jq, jk, jv, causal=False, block_q=BLOCK, block_k=BLOCK,  # repro: allow[kernel-registry-bypass] reason=parity test against the TPU kernel in interpret mode, as tests/test_kernels.py does
                                   interpret=True)
    want = ref.flash_attention_ref(jq, jk, jv, causal=False, window=window)  # repro: allow[kernel-registry-bypass] reason=parity test against the reference's oracle, as tests/test_kernels.py does
    got = ops.flash_attention(q, k, v, causal=False, window=window)
    _assert_close(got, want, torch.float32)


# the wrapper's inputs and the sources' widths
# ----------------------------------------------------------------------

def test_kernel_inputs_pass_one_type_through_and_cast_mixed_types_to_fp32():
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = (torch.zeros(1, 4, 2, 24, dtype=dtype) for _ in range(3))
        assert all(a is b for a, b in zip(flash.kernel_inputs(q, k, v), (q, k, v)))
    q = torch.randn(1, 4, 2, 24).bfloat16()
    k = torch.randn(1, 4, 2, 24)
    for args in ((q, k, k), (q.double(), k.double(), k.double()), (q, k.half(), k)):
        got = flash.kernel_inputs(*args)
        assert all(t.dtype == torch.float32 and t.is_contiguous() for t in got)
        assert all(torch.equal(a, b.float()) for a, b in zip(got, args))
    with pytest.raises(TypeError, match="float"):
        flash.kernel_inputs(q, k.int(), k)


@pytest.mark.parametrize("types,run", [
    ((torch.bfloat16,) * 3, torch.bfloat16), ((torch.float16,) * 3, torch.float16),
    ((torch.float32,) * 3, torch.float32), ((torch.float64,) * 3, torch.float32),
    ((torch.float16, torch.bfloat16, torch.bfloat16), torch.float32),
    ((torch.bfloat16, torch.float32, torch.float32), torch.float32)])
def test_a_call_is_priced_in_the_type_its_kernel_runs(types, run):
    """``run_dtype`` is the type ``kernel_inputs`` hands the kernel, and
    the roofline prices the call on that type's sheet: fp16 q with bf16 k
    and v runs (and is priced) in fp32."""
    from repro_torch.obs.profile import (H100_SXM, H100_SXM_FP32, hardware_for, kernel_bound,
                                         kernel_cost)

    # the serve prefill's shape, on the meta device: only types and shapes are read
    q, k, v = (torch.empty(4, 2048, h, 64, dtype=t, device="meta")
               for h, t in zip((32, 8, 8), types))
    assert flash.run_dtype(q, k, v) == run
    assert all(t.dtype == run for t in flash.kernel_inputs(q, k, v))
    sheet = H100_SXM if run in (torch.bfloat16, torch.float16) else H100_SXM_FP32
    args = (q, k, v, True, 0)
    assert hardware_for(args, "flash_attention") is sheet
    flops, _ = kernel_cost("flash_attention", None, args)
    assert kernel_bound("flash_attention", args) == (flops / sheet.peak_flops, "operations")


def test_kernel_inputs_copy_a_transposed_view_and_read_a_misaligned_one_in_place():
    base = torch.randn(1, 2, 8, 24).bfloat16()
    view = base.transpose(1, 2)   # (1, 8, 2, 24), not contiguous
    k = torch.zeros(1, 8, 2, 24, dtype=torch.bfloat16)
    got, _, _ = flash.kernel_inputs(view, k, k)
    assert got.is_contiguous() and torch.equal(got, view)
    buf = torch.zeros(1 + 8 * 2 * 24, dtype=torch.bfloat16)
    off = buf[1:].view(1, 8, 2, 24)   # 2 bytes off a 16-byte boundary
    assert off.data_ptr() % 16 and flash.kernel_inputs(off, k, k)[0] is off


def test_the_sources_dispatch_to_the_padded_widths():
    """Both sources run each hd at the next of HEAD_DIMS (its columns past
    hd zero), in that order, and past 256 their chunked kernels, in slabs
    of CHUNK columns; the fp16 library is the bf16 source built again."""
    for name, macro in (("flash_attention_tc", "FLASH_TC_WIDTH"), ("flash_attention", "FLASH_WIDTH")):
        src = (CSRC / f"{name}.cu").read_text()
        widths = tuple(int(w) for w in re.findall(rf"^  {macro}\((\d+)\)$", src, re.M))
        assert widths == flash.HEAD_DIMS, name
        assert f"constexpr int CW = {flash.CHUNK};" in src
    assert '#include "flash_attention_tc.cu"' in (CSRC / "flash_attention_tc_f16.cu").read_text()


# a reduced dense config at hd 96 with a window, through both packages
# ----------------------------------------------------------------------

BATCH, PROMPT, GEN = 2, 40, 6
KV_LEN = PROMPT + GEN + 1
DENSE_HD96 = dict(name="dense-hd96-smoke", family="dense", n_layers=2, d_model=192, n_heads=2,
                  n_kv_heads=1, head_dim=96, d_ff=256, vocab=512, rope_theta=10000.0,
                  rms_eps=1e-5, sliding_window=16, max_decode_len=64, use_pallas=True)
LOGIT_TOL, TRAIN_TOL = 1e-4, 1e-5   # tests/test_torch_lm.py's bars


def _cfgs():
    return (RefConfig(**DENSE_HD96, dtype=jnp.float32),
            PtConfig(**DENSE_HD96, dtype=torch.float32))


def _params():
    ref_cfg, pt_cfg = _cfgs()
    tree = jax.tree.map(np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, tree), lm_params_from_arrays(tree, pt_cfg, device="cpu")


def test_hd96_config_forward_train_matches():
    ref_cfg, pt_cfg = _cfgs()
    ref_params, pt_params = _params()
    seq = _rng("train").integers(0, ref_cfg.vocab, size=(BATCH, PROMPT + 1)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    want, _ = jax.jit(lambda p, b: ref_models.forward_train(p, ref_cfg, ref_models.ShardCtx(),
                                                            b))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, _ = pt_models.forward_train(pt_params, pt_cfg,
                                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (BATCH, PROMPT, pt_cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAIN_TOL, rtol=0)


def test_hd96_config_prefill_and_decode_match():
    """Prefill, then GEN decode steps fed the reference's greedy tokens;
    the 16-slot window is shorter than the 47-slot cache, so its ring
    wraps."""
    ref_cfg, pt_cfg = _cfgs()
    ref_params, pt_params = _params()
    prompts = _rng("prompts").integers(1, ref_cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    ctx = ref_models.ShardCtx()
    prefill = jax.jit(ref_models.make_prefill_step(ref_cfg, ctx))
    decode = jax.jit(ref_models.make_decode_step(ref_cfg, ctx))
    cache = ref_models.init_cache(ref_cfg, BATCH, KV_LEN)
    logits, cache = prefill(ref_params, {"tokens": jnp.asarray(prompts)}, cache)
    want, tokens = [np.asarray(logits)], []
    for _ in range(GEN):
        tok = np.asarray(jnp.argmax(logits, axis=-1))[:, None].astype(np.int32)
        tokens.append(tok)
        logits, cache = decode(ref_params, jnp.asarray(tok), cache)
        want.append(np.asarray(logits))
    pt_cache = pt_models.init_cache(pt_cfg, BATCH, KV_LEN, device="cpu")
    before = ops.KERNEL_REGISTRY["flash_attention"].counter.count
    logits, pt_cache = pt_models.forward_prefill(pt_params, pt_cfg,
                                                 {"tokens": torch.from_numpy(prompts)}, pt_cache)
    got = [logits.numpy()]
    for tok in tokens:
        logits, pt_cache = pt_models.forward_decode(pt_params, pt_cfg, torch.from_numpy(tok),
                                                    pt_cache)
        got.append(logits.numpy())
    # the plain version on the CPU: no kernel launched
    assert ops.KERNEL_REGISTRY["flash_attention"].counter.count == before
    assert pt_cache["blocks"][0]["attn"]["pos"].shape == (BATCH, 16)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=0, err_msg=f"step {step}")
