"""The port's LM serving path against the reference's, on the CPU.

Reduced dense configs (``get_config(name).reduced(max_decode_len=64)``
with ``use_pallas=True``, fp32) carry the JAX package's parameters across
with ``convert.lm_params_from_arrays``; the port runs the plain version
of every kernel. On two prompts of 40 tokens the port gives: prefill and
decode logits within 1e-4 of the reference's, the KV cache's k and v
within 1e-5 and its positions and step exactly, the same greedy tokens
through both packages' ``make_lm_score_fn`` and schedulers, and the
training forward's logits and ``lm_loss`` within 1e-5. ``llama3.2-1b-swa8k``
reduces to a 16-token window, shorter than the 47-slot cache, so its
ring buffer wraps; ``qwen2-1.5b`` has q/k/v biases, drawn here non-zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.launch.serve import make_lm_score_fn as ref_score_fn
from repro.models import layers as ref_layers
from repro.serve import MicroBatchScheduler as RefScheduler, ServeConfig as RefServeConfig
from repro.utils.seeds import derive_stream_seed
from repro_torch import configs as pt_configs
from repro_torch import models as pt_models
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as pt_serve
from repro_torch.models import layers as pt_layers
from repro_torch.serve import MicroBatchScheduler as PtScheduler, ServeConfig as PtServeConfig

SERVED = ("llama3.2-1b", "llama3.2-1b-swa8k", "qwen2-1.5b")
DENSE = ("llama3.2-1b", "llama3.2-1b-swa8k", "qwen2-1.5b", "qwen2.5-14b", "glm4-9b")
ALL = sorted(ref_configs.ARCHS) + sorted(ref_configs.VARIANTS)
BATCH, PROMPT, GEN = 2, 40, 6
KV_LEN = PROMPT + GEN + 1
LOGIT_TOL, CACHE_TOL, TRAIN_TOL = 1e-4, 1e-5, 1e-5


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(13, purpose, index))


def _cfgs(name: str, use_pallas: bool = True):
    ref = ref_configs.get_config(name).reduced(max_decode_len=64).replace(use_pallas=use_pallas)
    pt = pt_configs.get_config(name).reduced(max_decode_len=64).replace(use_pallas=use_pallas)
    return ref, pt


@functools.lru_cache(maxsize=None)
def _params(name: str):
    """The reference's seeded parameters as numpy (q/k/v biases drawn
    non-zero so the bias terms count), and the same values in both
    packages' forms."""
    ref_cfg, pt_cfg = _cfgs(name)
    tree = jax.tree.map(np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    if ref_cfg.qkv_bias:
        rng = _rng("bias")
        mixer = tree["blocks"][0]["mixer"]
        for key in ("bq", "bk", "bv"):
            mixer[key] = (0.1 * rng.normal(size=mixer[key].shape)).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, tree)
    return ref_params, lm_params_from_arrays(tree, pt_cfg, device="cpu")


def _prompts(vocab: int) -> np.ndarray:
    return _rng("prompts").integers(1, vocab, size=(BATCH, PROMPT)).astype(np.int32)


def _cache_arrays(cache, layer: int, ref: bool):
    if ref:
        c = cache["blocks"][0]["attn"]
        return {k: np.asarray(v[layer]) for k, v in c.items()}
    return {k: v.numpy() for k, v in cache["blocks"][layer]["attn"].items()}


@functools.lru_cache(maxsize=None)
def _serve_runs(name: str, use_pallas: bool = True):
    """Prefill, then GEN decode steps fed the reference's greedy tokens,
    in both packages: logits of every step and both final caches."""
    ref_cfg, pt_cfg = _cfgs(name, use_pallas)
    ref_params, pt_params = _params(name)
    prompts = _prompts(ref_cfg.vocab)
    ctx = ref_models.ShardCtx()
    prefill = jax.jit(ref_models.make_prefill_step(ref_cfg, ctx))
    decode = jax.jit(ref_models.make_decode_step(ref_cfg, ctx))
    cache = ref_models.init_cache(ref_cfg, BATCH, KV_LEN)
    logits, cache = prefill(ref_params, {"tokens": jnp.asarray(prompts)}, cache)
    ref_logits, tokens = [np.asarray(logits)], []
    ref_prefill_cache = jax.tree.map(np.asarray, cache)
    for _ in range(GEN):
        tok = np.asarray(jnp.argmax(logits, axis=-1))[:, None].astype(np.int32)
        tokens.append(tok)
        logits, cache = decode(ref_params, jnp.asarray(tok), cache)
        ref_logits.append(np.asarray(logits))

    pt_cache = pt_models.init_cache(pt_cfg, BATCH, KV_LEN, device="cpu")
    logits, pt_cache = pt_models.forward_prefill(pt_params, pt_cfg,
                                                 {"tokens": torch.from_numpy(prompts)}, pt_cache)
    pt_logits = [logits.numpy()]
    pt_prefill_cache = {"blocks": [{"attn": {k: v.clone() for k, v in b["attn"].items()}}
                                   for b in pt_cache["blocks"]], "step": pt_cache["step"]}
    for tok in tokens:
        logits, pt_cache = pt_models.forward_decode(pt_params, pt_cfg, torch.from_numpy(tok),
                                                    pt_cache)
        pt_logits.append(logits.numpy())
    return {"ref_logits": ref_logits, "pt_logits": pt_logits,
            "ref_prefill_cache": ref_prefill_cache, "pt_prefill_cache": pt_prefill_cache,
            "ref_cache": jax.tree.map(np.asarray, cache), "pt_cache": pt_cache}


def _assert_caches_match(ref_cache, pt_cache, n_layers: int):
    assert int(ref_cache["step"]) == pt_cache["step"]
    for layer in range(n_layers):
        want = _cache_arrays(ref_cache, layer, ref=True)
        got = _cache_arrays(pt_cache, layer, ref=False)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        assert got["pos"].dtype == np.int32
        for key in ("k", "v"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("name", SERVED)
def test_prefill_logits_and_cache_match(name):
    run = _serve_runs(name)
    got, want = run["pt_logits"][0], run["ref_logits"][0]
    assert got.shape == want.shape == (BATCH, _cfgs(name)[1].vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    _assert_caches_match(run["ref_prefill_cache"], run["pt_prefill_cache"],
                         _cfgs(name)[1].n_layers)
    assert run["pt_prefill_cache"]["step"] == PROMPT


@pytest.mark.parametrize("name", SERVED)
def test_decode_logits_and_cache_match(name):
    run = _serve_runs(name)
    for step, (got, want) in enumerate(zip(run["pt_logits"][1:], run["ref_logits"][1:])):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0, err_msg=f"step {step}")
    _assert_caches_match(run["ref_cache"], run["pt_cache"], _cfgs(name)[1].n_layers)
    assert run["pt_cache"]["step"] == PROMPT + GEN


def test_sliding_window_cache_wraps():
    """The reduced swa8k config keeps a 16-slot ring: after prefill the
    slots hold positions 24..39 at ``pos % 16``."""
    cfg = _cfgs("llama3.2-1b-swa8k")[1]
    assert cfg.sliding_window == 16 < KV_LEN
    pos = _serve_runs("llama3.2-1b-swa8k")["pt_prefill_cache"]["blocks"][0]["attn"]["pos"]
    assert pos.shape == (BATCH, 16)
    want = sorted(range(24, 40), key=lambda p: p % 16)   # slot s holds the p with p % 16 == s
    np.testing.assert_array_equal(pos.numpy(), np.tile(want, (BATCH, 1)))


def test_dense_route_without_the_kernel_matches():
    """``use_pallas=False`` takes ``_sdpa`` (S <= 2048) in both packages."""
    run = _serve_runs("llama3.2-1b", use_pallas=False)
    for got, want in zip(run["pt_logits"], run["ref_logits"]):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("name", SERVED)
def test_score_fn_tokens_match_through_the_scheduler(name):
    ref_cfg, pt_cfg = _cfgs(name)
    ref_params, pt_params = _params(name)
    prompts = _prompts(ref_cfg.vocab)
    ctx = ref_models.ShardCtx()
    ref_fn = ref_score_fn(ref_cfg, ref_params, jax.jit(ref_models.make_prefill_step(ref_cfg, ctx)),
                          jax.jit(ref_models.make_decode_step(ref_cfg, ctx)), GEN)
    ref_sched = RefScheduler(ref_fn, RefServeConfig(max_batch=4, max_queue=16, buckets=(4,)))
    want = ref_sched.run(list(prompts))
    pt_fn = pt_serve.make_lm_score_fn(pt_cfg, pt_params, pt_models.make_prefill_step(pt_cfg),
                                      pt_models.make_decode_step(pt_cfg), GEN)
    pt_sched = PtScheduler(pt_fn, PtServeConfig(max_batch=4, max_queue=16, buckets=(4,)))
    got = pt_sched.run(list(prompts))
    assert got.shape == (BATCH, GEN)
    np.testing.assert_array_equal(got, want)
    assert vars(pt_sched.stats) == vars(ref_sched.stats)
    assert pt_sched.stats.padded_rows == 2
    (t,) = pt_fn.timings
    assert (t["bucket"], t["prompt_len"], t["gen"]) == (4, PROMPT, GEN)


@pytest.mark.parametrize("name", SERVED)
def test_forward_train_and_loss_match(name):
    ref_cfg, pt_cfg = _cfgs(name)
    ref_params, pt_params = _params(name)
    seq = _rng("train").integers(0, ref_cfg.vocab, size=(BATCH, PROMPT + 1)).astype(np.int32)
    labels = seq[:, 1:].copy()
    labels[0, :5] = -1   # ignored positions
    batch = {"tokens": seq[:, :-1], "labels": labels}
    ctx = ref_models.ShardCtx()
    want_logits, _ = jax.jit(lambda p, b: ref_models.forward_train(p, ref_cfg, ctx, b))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    want_loss = jax.jit(ref_models.make_eval_step(ref_cfg, ctx))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_logits, aux = pt_models.forward_train(pt_params, pt_cfg, tbatch)
    got_loss = pt_models.make_eval_step(pt_cfg)(pt_params, tbatch)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=TRAIN_TOL, rtol=0)
    assert abs(float(got_loss) - float(want_loss)) <= TRAIN_TOL
    assert float(aux) == 0.0
    assert abs(float(pt_models.lm_loss(got_logits, tbatch["labels"]))
               - float(ref_models.lm_loss(want_logits, jnp.asarray(labels)))) <= TRAIN_TOL


@pytest.mark.parametrize("causal,window,block_skip", [(True, 0, False), (True, 0, True),
                                                      (True, 20, True), (False, 0, False)])
def test_blocked_attention_matches_reference(causal, window, block_skip):
    """The plain online-softmax loop (the route above 2048 tokens without
    the kernel), at small chunks on a ragged length."""
    rng = _rng("blocked", window)
    q = rng.normal(size=(2, 77, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 77, 2, 32)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=32, block_skip=block_skip)
    want = np.asarray(ref_layers.blocked_attention(*map(jnp.asarray, (q, k, v)), **kw))
    got = pt_layers.blocked_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ALL)
def test_configs_and_param_counts_match_reference(name):
    ref, pt = ref_configs.get_config(name), pt_configs.get_config(name)
    for field in ref.__dataclass_fields__:
        if field != "dtype":
            assert getattr(pt, field) == getattr(ref, field), field
    assert pt.dtype == torch.bfloat16 and pt.reduced().dtype == torch.float32
    assert pt_models.param_count(pt) == ref_models.param_count(ref)
    assert pt_models.active_param_count(pt) == ref_models.active_param_count(ref)
    assert pt.sublayer_kinds() == ref.sublayer_kinds()
    assert pt_configs.SHAPES == {k: type(pt_configs.SHAPES[k])(**vars(v))
                                 for k, v in ref_configs.SHAPES.items()}


def test_llama_is_the_published_width():
    cfg = pt_configs.get_config("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab, cfg.rope_theta) == (16, 2048, 32, 8, 64, 8192, 128256, 500_000.0)
    assert pt_models.param_count(cfg) == 1_498_482_688


@pytest.mark.parametrize("name", DENSE)
def test_built_module_has_param_count_parameters(name):
    cfg = pt_configs.get_config(name).reduced()
    params = pt_models.init_params(cfg, seed=0, device="cpu")
    assert sum(p.numel() for p in params.parameters()) == pt_models.param_count(cfg)
    assert params.embed.dtype == torch.float32 and not params.embed.requires_grad
    again = pt_models.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(params.blocks[0].mixer.wq, again.blocks[0].mixer.wq)


@pytest.mark.parametrize("name", sorted(set(ALL) - set(DENSE)))
def test_unported_families_raise_naming_their_item(name):
    cfg = pt_configs.get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        pt_models.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        pt_models.init_cache(cfg, 1, 8, device="cpu")


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        pt_configs.get_config("gpt-5")


def test_main_serves_a_reduced_model_on_the_cpu(capsys):
    gen = pt_serve.main(["--arch", "llama3.2-1b", "--reduced", "--batch", "3",
                         "--prompt-len", "16", "--gen", "5"], device="cpu")
    assert gen.shape == (3, 5) and gen.dtype.kind == "i"
    assert np.all((gen >= 0) & (gen < 512))
    assert capsys.readouterr().out.count("req") == 2
