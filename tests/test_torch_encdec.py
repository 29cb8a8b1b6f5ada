"""The port's encoder-decoder pieces and the VLM's serve cache against the
reference, on the CPU.

``encode`` (the learned positions, non-causal self-attention blocks with
RoPE, ``rms_norm``) and ``cross_attention`` / ``encode_kv`` (dense
``_sdpa`` over the encoder's keys and values, with and without q/k/v
biases) on the reduced whisper-base, from the reference's parameters
(``convert.lm_params_from_arrays``) and the same seeded inputs: within
1e-5. The whole audio and VLM models (prefill, decode, caches, training
forward and steps) are held in ``test_torch_lm.py`` and
``test_torch_train.py``.

The reference's LM serve sizes its KV cache ``prompt_len + gen + 1``,
without the VLM's patch prefix (``repro/launch/serve.py``), so its
ring-slot cache loses the prefix: the prefill keeps only the last
``kv_len`` positions and each decode step overwrites the oldest. The
port's serve sizes it ``n_patches + prompt_len + gen + 1``. Driven at the
same ``kv_len``, both packages' model functions give the same answers:
at the reference's sizing the decode logits are far from the full
forward's, at the port's within 1e-5.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.utils.seeds import derive_stream_seed
from repro_torch import configs as pt_configs
from repro_torch import models as pt_models
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as pt_serve
from repro_torch.models import layers as pt_layers

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

AUDIO, VLM = "whisper-base", "llava-next-mistral-7b"
TOL = 1e-5
# ROADMAP's repro of the reference's serve sizing: a prompt of 8 tokens,
# 3 greedy tokens; the prefix loss moves the decode logits by 2.6-3.1
PROMPT, GEN = 8, 3
LOST_PREFIX_GAP = 0.5


def _rng(purpose: str) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(17, purpose, 0))


@functools.lru_cache(maxsize=None)
def _models(name: str, use_pallas: bool = False):
    """Both packages' reduced configs and the reference's parameters in
    both packages' forms."""
    ref_cfg = ref_configs.get_config(name).reduced().replace(use_pallas=use_pallas)
    cfg = pt_configs.get_config(name).reduced().replace(use_pallas=use_pallas)
    tree = jax.tree.map(np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), lm_params_from_arrays(
        tree, cfg, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["sdpa", "flash"])
def test_encode_matches_reference(use_pallas):
    """The encoder over 2 clips of 24 random frames: within 1e-5 of the
    reference's, through dense ``_sdpa`` and through the flash route (its
    plain version on the CPU, non-causal) alike."""
    ref_cfg, cfg, ref_params, params = _models(AUDIO, use_pallas)
    frames = 0.5 * _rng("frames").normal(size=(2, cfg.encoder_seq, cfg.d_model))
    frames = frames.astype(np.float32)
    want = jax.jit(lambda p, f: ref_model.encode(p, f, ref_cfg, ref_models.ShardCtx()))(
        ref_params["encoder"], jnp.asarray(frames))
    with torch.no_grad():
        got = pt_models.encode(params.encoder, torch.from_numpy(frames), cfg)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["no_bias", "bias"])
def test_cross_attention_and_encode_kv_match_reference(qkv_bias):
    """One decoder layer's cross-attention: 3 queries against 24 encoder
    rows, random weights (and biases): ``encode_kv``'s keys and values and
    ``cross_attention``'s output within 1e-5."""
    _, cfg, _, _ = _models(AUDIO)
    cfg = cfg.replace(qkv_bias=qkv_bias)
    ref_cfg = ref_configs.get_config(AUDIO).reduced(qkv_bias=qkv_bias)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = _rng("xattn")
    shapes = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd), "wo": (H, hd, d)}
    if qkv_bias:
        shapes.update(bq=(H, hd), bk=(K, hd), bv=(K, hd))
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    enc_out = rng.normal(size=(2, cfg.encoder_seq, d)).astype(np.float32)
    ctx = ref_models.ShardCtx()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_kv = ref_layers.encode_kv(jnp.asarray(enc_out), jp, ref_cfg, ctx)
    want = ref_layers.cross_attention(jnp.asarray(x), jp, ref_cfg, ctx, want_kv)
    tp = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in p.items()})
    got_kv = pt_layers.encode_kv(torch.from_numpy(enc_out), tp, cfg)
    got = pt_layers.cross_attention(torch.from_numpy(x), tp, cfg, got_kv)
    for a, b in zip(got_kv, want_kv):
        assert a.shape == (2, cfg.encoder_seq, K, hd)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)
    assert got.shape == (2, 3, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_reference_serve_sizing_loses_the_patch_prefix(monkeypatch):
    """Reduced llava (16 patches): the kv_len each package's serve asks
    for, then both packages' prefill of 8 tokens and 3 decode steps at each
    of the two sizes, each step against ``forward_train``'s logits at its
    position. At the reference's 12 slots the prefill keeps 12 of its 24
    positions: the decode steps are far off, in both packages alike; at
    the port's 28 every step is within 1e-5."""
    ref_cfg, cfg, ref_params, params = _models(VLM)
    rng = _rng("sizing")
    tokens = rng.integers(0, cfg.vocab, size=(1, PROMPT + GEN)).astype(np.int32)
    patches = (0.5 * rng.normal(size=(1, cfg.n_patches, cfg.d_model))).astype(np.float32)
    ctx = ref_models.ShardCtx()
    prefill = jax.jit(ref_models.make_prefill_step(ref_cfg, ctx))
    decode = jax.jit(ref_models.make_decode_step(ref_cfg, ctx))

    sizes = {}
    for label, module in (("ref", ref_serve), ("pt", pt_serve)):
        def sized(c, batch, kv_len, *args, _init=module.init_cache, _label=label, **kw):
            sizes[_label] = kv_len
            return _init(c, batch, kv_len, *args, **kw)

        monkeypatch.setattr(module, "init_cache", sized)
    ref_serve.make_lm_score_fn(ref_cfg, ref_params, prefill, decode, GEN)(tokens[:, :PROMPT])
    pt_serve.make_lm_score_fn(cfg, params, pt_models.make_prefill_step(cfg),
                              pt_models.make_decode_step(cfg), GEN)(tokens[:, :PROMPT])
    assert sizes == {"ref": PROMPT + GEN + 1, "pt": cfg.n_patches + PROMPT + GEN + 1}

    full_ref, _ = jax.jit(lambda p, b: ref_models.forward_train(p, ref_cfg, ctx, b))(
        ref_params, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    with torch.no_grad():
        full_pt, _ = pt_models.forward_train(params, cfg, {"tokens": torch.from_numpy(tokens),
                                                           "patches": torch.from_numpy(patches)})
    np.testing.assert_allclose(full_pt.numpy(), np.asarray(full_ref), atol=TOL, rtol=0)

    def steps_ref(kv_len):
        cache = ref_models.init_cache(ref_cfg, 1, kv_len)
        logits, cache = prefill(ref_params, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                                             "patches": jnp.asarray(patches)}, cache)
        out = [np.asarray(logits)]
        for t in range(PROMPT, PROMPT + GEN):
            logits, cache = decode(ref_params, jnp.asarray(tokens[:, t:t + 1]), cache)
            out.append(np.asarray(logits))
        return out

    def steps_pt(kv_len):
        cache = pt_models.init_cache(cfg, 1, kv_len, device="cpu")
        logits, cache = pt_models.forward_prefill(
            params, cfg, {"tokens": torch.from_numpy(tokens[:, :PROMPT]),
                          "patches": torch.from_numpy(patches)}, cache)
        out = [logits.numpy()]
        for t in range(PROMPT, PROMPT + GEN):
            logits, cache = pt_models.forward_decode(params, cfg,
                                                     torch.from_numpy(tokens[:, t:t + 1]), cache)
            out.append(logits.numpy())
        return out

    want = [np.asarray(full_ref[:, t]) for t in range(PROMPT - 1, PROMPT + GEN)]
    for label, kv_len in sizes.items():
        ref_steps, pt_steps = steps_ref(kv_len), steps_pt(kv_len)
        for a, b in zip(pt_steps, ref_steps):   # the same model functions, the same answers
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        gaps = [float(np.abs(a - w).max()) for a, w in zip(pt_steps, want)]
        assert gaps[0] <= TOL, (label, gaps)   # the prefill attends over everything
        if label == "ref":
            assert min(gaps[1:]) > LOST_PREFIX_GAP, gaps
        else:
            assert max(gaps) <= TOL, gaps
