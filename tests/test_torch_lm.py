"""The port's LM serving path against the reference's, on the CPU.

Reduced configs (``get_config(name).reduced(max_decode_len=64)`` with
``use_pallas=True``, fp32) of the dense family and of the MoE
(mixtral-8x22b, phi3.5-moe), SSM (mamba2), hybrid (jamba), VLM (llava:
16 random patches in front of the prompt) and audio (whisper: 24 random
frames through the encoder) families carry the JAX package's parameters
across with ``convert.lm_params_from_arrays``; the port runs the plain
version of every kernel. On two prompts of 40 tokens the port gives:
prefill and decode logits within 1e-4 of the reference's, the KV cache's
k and v, the cross-attention's cached xk and xv and the Mamba cache's
SSD state and conv tail within 1e-5 and its positions and step exactly,
the same greedy tokens through both packages' ``make_lm_score_fn`` and
schedulers (the reference's cache for llava sized with its patch prefix,
as the port's serve sizes it: ``tests/test_torch_encdec.py`` shows what
the reference's own sizing loses), and the training forward's logits,
``lm_loss`` and the MoE aux loss within 1e-5. Jamba is cut to 5 layers,
which hold every sub-layer kind it has.
``llama3.2-1b-swa8k`` reduces to a 16-token window, shorter than the
47-slot cache, so its ring buffer wraps (and mixtral's too); ``qwen2-1.5b``
has q/k/v biases, drawn here non-zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.launch import serve as ref_serve
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

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

DENSE_SERVED = ("llama3.2-1b", "llama3.2-1b-swa8k", "qwen2-1.5b")
DENSE = ("llama3.2-1b", "llama3.2-1b-swa8k", "qwen2-1.5b", "qwen2.5-14b", "glm4-9b")
# the MoE, SSM, hybrid, VLM and audio families (mixtral also has a
# sliding window)
FAMILIES = ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "jamba-1.5-large-398b",
            "llava-next-mistral-7b", "whisper-base")
SERVED = DENSE_SERVED + FAMILIES
PORTED = DENSE + FAMILIES
ALL = sorted(ref_configs.ARCHS) + sorted(ref_configs.VARIANTS)
BATCH, PROMPT, GEN = 2, 40, 6
KV_LEN = PROMPT + GEN + 1
LOGIT_TOL, CACHE_TOL, TRAIN_TOL = 1e-4, 1e-5, 1e-5
# jamba cut to the card's serve depth, (mamba, mlp), (mamba, moe),
# (mamba, mlp), (mamba, moe), (attn, mlp): every sub-layer kind it has.
# Deeper, fp32 rounding passes the bars on both sides: at one period
# (8 layers) the training logits of the two packages are 1.1e-5 apart,
# and each is ~1e-5 from an fp64 run of the same layers.
DEPTH = {"jamba-1.5-large-398b": 5}


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(13, purpose, index))


def _cfgs(name: str, use_pallas: bool = True):
    cut = {"n_layers": DEPTH[name]} if name in DEPTH else {}
    ref = ref_configs.get_config(name).reduced(max_decode_len=64, **cut).replace(
        use_pallas=use_pallas)
    pt = pt_configs.get_config(name).reduced(max_decode_len=64, **cut).replace(
        use_pallas=use_pallas)
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


def _extra(cfg, purpose: str = "extra") -> dict:
    """The VLM's patch embeddings and the encoder's frame embeddings
    (the stub frontends' outputs) for BATCH rows, seeded normals at half
    scale."""
    rng, extra = _rng(purpose), {}
    if cfg.n_patches:
        extra["patches"] = 0.5 * rng.normal(size=(BATCH, cfg.n_patches, cfg.d_model))
    if cfg.encoder_layers:
        extra["frames"] = 0.5 * rng.normal(size=(BATCH, cfg.encoder_seq, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in extra.items()}


def _kv_len(cfg) -> int:
    """The cache's length: the patch prefix, the prompt and the decode."""
    return cfg.n_patches + KV_LEN


def _flat(entry, prefix=""):
    """A cache entry's leaves as {"kind/name" or "xk": leaf}."""
    if isinstance(entry, dict):
        return {path: leaf for key, sub in entry.items()
                for path, leaf in _flat(sub, prefix + key + "/").items()}
    return {prefix[:-1]: entry}


def _cache_arrays(cache, layer: int, period: int, ref: bool):
    """Layer ``layer``'s cache entry as {"kind/name": array}: the
    reference stacks layer i at index i // period of its kind i % period."""
    if ref:
        sub = _flat(cache["blocks"][layer % period])
        return {k: np.asarray(v[layer // period]) for k, v in sub.items()}
    return {k: v.numpy() for k, v in _flat(cache["blocks"][layer]).items()}


def _clone_cache(cache):
    def clone(entry):
        if isinstance(entry, dict):
            return {k: clone(v) for k, v in entry.items()}
        return entry.clone()

    return {"blocks": [clone(sub) for sub in cache["blocks"]], "step": cache["step"]}


@functools.lru_cache(maxsize=None)
def _serve_runs(name: str, use_pallas: bool = True):
    """Prefill, then GEN decode steps fed the reference's greedy tokens,
    in both packages: logits of every step and both final caches."""
    ref_cfg, pt_cfg = _cfgs(name, use_pallas)
    ref_params, pt_params = _params(name)
    prompts = _prompts(ref_cfg.vocab)
    extra = _extra(ref_cfg)
    ctx = ref_models.ShardCtx()
    prefill = jax.jit(ref_models.make_prefill_step(ref_cfg, ctx))
    decode = jax.jit(ref_models.make_decode_step(ref_cfg, ctx))
    cache = ref_models.init_cache(ref_cfg, BATCH, _kv_len(ref_cfg))
    batch = {"tokens": prompts, **extra}
    logits, cache = prefill(ref_params, jax.tree.map(jnp.asarray, batch), cache)
    ref_logits, tokens = [np.asarray(logits)], []
    ref_prefill_cache = jax.tree.map(np.asarray, cache)
    for _ in range(GEN):
        tok = np.asarray(jnp.argmax(logits, axis=-1))[:, None].astype(np.int32)
        tokens.append(tok)
        logits, cache = decode(ref_params, jnp.asarray(tok), cache)
        ref_logits.append(np.asarray(logits))

    pt_cache = pt_models.init_cache(pt_cfg, BATCH, _kv_len(pt_cfg), device="cpu")
    logits, pt_cache = pt_models.forward_prefill(
        pt_params, pt_cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, pt_cache)
    pt_logits = [logits.numpy()]
    pt_prefill_cache = _clone_cache(pt_cache)
    for tok in tokens:
        logits, pt_cache = pt_models.forward_decode(pt_params, pt_cfg, torch.from_numpy(tok),
                                                    pt_cache)
        pt_logits.append(logits.numpy())
    return {"ref_logits": ref_logits, "pt_logits": pt_logits,
            "ref_prefill_cache": ref_prefill_cache, "pt_prefill_cache": pt_prefill_cache,
            "ref_cache": jax.tree.map(np.asarray, cache), "pt_cache": pt_cache}


def _assert_caches_match(ref_cache, pt_cache, cfg, tol):
    """KV entries: positions exactly, k and v (and an encoder-decoder's
    xk and xv) within ``tol``; Mamba entries: the SSD state (fp32) and the
    conv tail within ``tol``."""
    assert int(ref_cache["step"]) == pt_cache["step"]
    period = len(cfg.sublayer_kinds())
    for layer in range(cfg.n_layers):
        want = _cache_arrays(ref_cache, layer, period, ref=True)
        got = _cache_arrays(pt_cache, layer, period, ref=False)
        kind = cfg.sublayer_kinds()[layer % period][0]
        cross = {"xk", "xv"} if cfg.is_encdec else set()
        assert got.keys() == want.keys()
        assert {key.split("/")[0] for key in got} == {kind} | cross
        for key, arr in got.items():
            assert arr.shape == want[key].shape and arr.dtype == want[key].dtype, key
            if key.endswith("pos"):
                np.testing.assert_array_equal(arr, want[key])
            else:
                np.testing.assert_allclose(arr, want[key], atol=tol, rtol=0,
                                           err_msg=f"layer {layer} {key}")


@pytest.mark.parametrize("name", SERVED)
def test_prefill_logits_and_cache_match(name):
    run = _serve_runs(name)
    got, want = run["pt_logits"][0], run["ref_logits"][0]
    assert got.shape == want.shape == (BATCH, _cfgs(name)[1].vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    _assert_caches_match(run["ref_prefill_cache"], run["pt_prefill_cache"], _cfgs(name)[1],
                         CACHE_TOL)
    assert run["pt_prefill_cache"]["step"] == _cfgs(name)[1].n_patches + PROMPT


@pytest.mark.parametrize("name", SERVED)
def test_decode_logits_and_cache_match(name):
    run = _serve_runs(name)
    for step, (got, want) in enumerate(zip(run["pt_logits"][1:], run["ref_logits"][1:])):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0, err_msg=f"step {step}")
    _assert_caches_match(run["ref_cache"], run["pt_cache"], _cfgs(name)[1], CACHE_TOL)
    assert run["pt_cache"]["step"] == _cfgs(name)[1].n_patches + PROMPT + GEN


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
def test_score_fn_tokens_match_through_the_scheduler(name, monkeypatch):
    ref_cfg, pt_cfg = _cfgs(name)
    ref_params, pt_params = _params(name)
    prompts = _prompts(ref_cfg.vocab)
    ctx = ref_models.ShardCtx()
    if ref_cfg.n_patches:   # the reference's cache with room for the patch prefix
        sized = ref_serve.init_cache
        monkeypatch.setattr(ref_serve, "init_cache", lambda cfg, batch, kv_len: sized(
            cfg, batch, kv_len + cfg.n_patches))
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
    batch = {"tokens": seq[:, :-1], "labels": labels, **_extra(ref_cfg, purpose="train")}
    ctx = ref_models.ShardCtx()
    want_logits, want_aux = jax.jit(lambda p, b: ref_models.forward_train(p, ref_cfg, ctx, b))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    want_loss = jax.jit(ref_models.make_eval_step(ref_cfg, ctx))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_logits, aux = pt_models.forward_train(pt_params, pt_cfg, tbatch)
    got_loss = pt_models.make_eval_step(pt_cfg)(pt_params, tbatch)
    tol = TRAIN_TOL
    assert got_logits.shape == (BATCH, PROMPT, pt_cfg.vocab)   # the patch prefix dropped
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=tol, rtol=0)
    assert abs(float(got_loss) - float(want_loss)) <= tol
    if ref_cfg.n_experts:   # the MoE layers' Switch losses, summed
        assert float(aux) > 0 and abs(float(aux) - float(want_aux)) <= tol
    else:
        assert float(aux) == float(want_aux) == 0.0
    assert abs(float(pt_models.lm_loss(got_logits, tbatch["labels"]))
               - float(ref_models.lm_loss(want_logits, jnp.asarray(labels)))) <= tol


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


@pytest.mark.parametrize("name", PORTED)
def test_built_module_has_param_count_parameters(name):
    """``param_count`` (the reference's formula) leaves out the Mamba
    conv's bias, ``d_inner + 2 * ssm_state`` a Mamba layer, which both
    packages build (``uncounted_params``)."""
    cfg = pt_configs.get_config(name).reduced()
    params = pt_models.init_params(cfg, seed=0, device="cpu")
    built = sum(p.numel() for p in params.parameters())
    assert built == pt_models.param_count(cfg) + pt_models.uncounted_params(cfg)
    ref_cfg = ref_configs.get_config(name).reduced()
    ref_tree = jax.eval_shape(lambda: ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    assert built == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref_tree))
    assert params.embed.dtype == torch.float32 and not params.embed.requires_grad
    again = pt_models.init_params(cfg, seed=0, device="cpu")
    for a, b in zip(params.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["llava-next-mistral-7b", "whisper-base"])
def test_vlm_and_audio_build_the_reference_trees(name):
    """The parameter and cache trees of the VLM and the encoder-decoder
    have the reference's leaves, shapes and dtypes, path by path (the
    port's layer i is the reference's superblock i of its one kind), and
    ``cache_nbytes`` is the bytes of the reference's cache."""
    ref_cfg = ref_configs.get_config(name).reduced()
    cfg = pt_configs.get_config(name).reduced()
    kv_len = _kv_len(cfg)
    ref_params = jax.eval_shape(lambda: ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    ref_cache = jax.eval_shape(lambda: ref_models.init_cache(ref_cfg, BATCH, kv_len))

    def ref_leaves(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def ref_key(path):   # the port's (path, layer) as the reference's stacked key
        parts = path.split(".")
        if parts[0] == "blocks":
            return "/".join(["blocks", "0"] + parts[2:]), int(parts[1])
        if parts[:2] == ["encoder", "blocks"]:
            return "/".join(parts[:2] + parts[3:]), int(parts[2])
        return "/".join(parts), None

    params = pt_models.init_params(cfg, seed=0, device="cpu")
    want = ref_leaves(ref_params)
    got = {}
    for path, t in params.named_parameters():
        key, layer = ref_key(path)
        got.setdefault(key, {})[layer] = t
    assert got.keys() == want.keys()
    for key, layers in got.items():
        stacked = None not in layers
        assert sorted(layers) == (list(range(want[key].shape[0])) if stacked else [None]), key
        shape = want[key].shape[1:] if stacked else want[key].shape
        assert all(tuple(t.shape) == shape and t.dtype == torch.float32
                   for t in layers.values()), key
    if cfg.is_encdec:
        assert {"encoder/pos", "blocks/0/xattn/wq", "blocks/0/norm_x"} <= got.keys()
    cache = pt_models.init_cache(cfg, BATCH, kv_len, device="cpu")
    want = ref_leaves(ref_cache)
    assert len(cache["blocks"]) == want["blocks/0/attn/k"].shape[0] == cfg.n_layers
    for sub in cache["blocks"]:
        for key, t in _flat(sub).items():
            ref = want["blocks/0/" + key]
            assert tuple(t.shape) == ref.shape[1:] and str(t.dtype)[6:] == str(ref.dtype), key
    assert {key.split("/", 2)[2] for key in want if key != "step"} == set(
        _flat(cache["blocks"][0]))
    ref_bytes = sum(
        leaf.size * leaf.dtype.itemsize  # repro: allow[wire-cost-honesty] reason=a cache's bytes in device memory, not a wire price
        for key, leaf in want.items() if key != "step")
    assert pt_models.cache_nbytes(pt_models.cache_spec(cfg, BATCH, kv_len)) == ref_bytes


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        pt_configs.get_config("gpt-5")


def test_main_serves_a_reduced_model_on_the_cpu(capsys):
    gen = pt_serve.main(["--arch", "llama3.2-1b", "--reduced", "--batch", "3",
                         "--prompt-len", "16", "--gen", "5"], device="cpu")
    assert gen.shape == (3, 5) and gen.dtype.kind == "i"
    assert np.all((gen >= 0) & (gen < 512))
    assert capsys.readouterr().out.count("req") == 2
