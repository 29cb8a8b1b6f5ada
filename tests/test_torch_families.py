"""The port's MoE FFN and Mamba2 mixer (the MoE, SSM and hybrid families)
against the reference's, on the CPU.

``moe`` and ``moe_local`` of reduced phi3.5-moe (4 experts, top 2) on the
reference's parameters: at 16 tokens (dropless) and at 320 (above 256,
so each expert keeps its top C and drops the rest), outputs and the
Switch aux loss within 1e-5, and with exactly tied inputs (repeated
tokens competing for an expert's capacity, two identical router columns)
the selected ids equal the reference's: ``top_k`` breaks ties to the
lower index as ``jax.lax.top_k`` does. The SSD pieces (``ssd_chunked``,
``ssd_decode_step``, ``causal_conv``, ``conv_decode_step``) within 1e-5
at chunks 8 and 16, with sequence lengths that are not chunk multiples.
At the full configs' chunk of 256 the reference's ``ssd_chunked``
overflows (``exp`` of positive exponents above the diagonal, times a 0
mask: NaN); the port masks before the exponential and stays finite and
equal to its own token-by-token recurrence within 1e-3. One deep-round
local step and ``ensemble_eval_loss`` of an MoE arch (the shape of
``tests/test_torch_deepfed.py`` with 4 experts, top 2) meet the
reference's at that file's bars.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as ref_configs
from repro import models as ref_models
from repro.core import deepfed as ref_deepfed
from repro.data import make_federated_lm_data, token_batches
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models.config import ModelConfig as RefConfig
from repro.models.layers import ShardCtx
from repro.utils.seeds import derive_stream_seed
from repro_torch import configs as pt_configs
from repro_torch.convert import lm_params_from_arrays, lm_stacked_from_arrays
from repro_torch.core import deepfed
from repro_torch.models import forward_train, lm_loss, param_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as pt_layers
from repro_torch.models import ssm as pt_ssm
from repro_torch.utils.trees import (
    tree_flatten_with_path,
    tree_leaves,
    tree_structure,
    tree_unflatten,
)

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

MOE_ARCH, SSM_ARCH = "phi3.5-moe-42b-a6.6b", "mamba2-2.7b"
MOE_TOL = SSD_TOL = 1e-5
RECURRENCE_TOL = 1e-3
# tests/test_torch_deepfed.py's bars
LOSS_RTOL, PARAM_TOL, NLL_TOL = 1e-5, 1e-5, 1e-6
NEAR_ZERO_GRAD = 1e-6   # AdamW's first step is lr * sign(g) where |g| >> eps


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(29, purpose, index))


def _cfgs(name: str, **kw):
    return (ref_configs.get_config(name).reduced(**kw),
            pt_configs.get_config(name).reduced(**kw))


@functools.lru_cache(maxsize=None)
def _moe_params(tied_router: bool = False):
    """Layer 0's MoE FFN of reduced phi3.5-moe in both packages' forms;
    with ``tied_router`` router columns 1 and 2 are equal."""
    ref_cfg, pt_cfg = _cfgs(MOE_ARCH)
    tree = jax.tree.map(np.array, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    ffn = tree["blocks"][0]["ffn"]
    if tied_router:
        ffn["router"][:, :, 2] = ffn["router"][:, :, 1]
    pt = lm_params_from_arrays(tree, pt_cfg, device="cpu").blocks[0].ffn
    return jax.tree.map(lambda a: jnp.asarray(a[0]), ffn), pt


def _moe_inputs(B: int, S: int, tied: bool) -> np.ndarray:
    x = _rng("moe", B * S).normal(size=(B, S, 128)).astype(np.float32)
    if tied:   # the back half of every row repeats one token
        x[:, S // 2:] = x[:, S // 2:S // 2 + 1]
    return x


def _ref_selection(x, ffn, cfg, local: bool):
    """The reference's ids, computed as its ``moe`` / ``moe_local`` do:
    each token's top-k experts and each expert's top-C tokens."""
    xt = x if local else x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("...d,de->...e", xt.astype(jnp.float32), ffn["router"]),
                           axis=-1)
    topv, topi = jax.lax.top_k(probs, cfg.top_k)
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    w_te = jnp.sum(jax.nn.one_hot(topi, cfg.n_experts) * topv[..., None], axis=-2)
    C = pt_layers.moe_capacity(cfg, xt.shape[-2])
    return topi, jax.lax.top_k(jnp.swapaxes(w_te, -1, -2), C)[1]


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("B,S,tied", [(2, 8, False), (1, 320, False), (1, 320, True),
                                      (2, 300, True)],
                         ids=["T16_dropless", "T320_drops", "T320_tied", "T600_tied"])
def test_moe_matches_reference(B, S, tied, local):
    ref_cfg, pt_cfg = _cfgs(MOE_ARCH, moe_local_dispatch=local)
    ref_p, pt_p = _moe_params(tied_router=tied)
    x = _moe_inputs(B, S, tied)
    want, want_aux = jax.jit(lambda a, p: ref_layers.moe(a, p, ref_cfg, ShardCtx()))(
        jnp.asarray(x), ref_p)
    got, aux = pt_layers.moe(torch.from_numpy(x), pt_p, pt_cfg)
    tokens = S if local else B * S
    if tokens > 256:   # capacity binds: some token-expert pairs are dropped
        assert pt_layers.moe_capacity(pt_cfg, tokens) < tokens * pt_cfg.top_k
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MOE_TOL, rtol=0)
    assert abs(float(aux) - float(want_aux)) <= MOE_TOL
    # the ids: each token's top-k experts and each expert's top-C tokens
    ref_topi, ref_sel = _ref_selection(jnp.asarray(x), ref_p, ref_cfg, local)
    xt = torch.from_numpy(x) if local else torch.from_numpy(x).reshape(B * S, -1)
    probs, w_te = pt_layers._route(xt, pt_p, pt_cfg)
    _, topi = pt_layers.top_k(probs, pt_cfg.top_k)
    _, sel = pt_layers.top_k(w_te.transpose(-1, -2), pt_layers.moe_capacity(pt_cfg, tokens))
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ref_topi))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    if tied:   # the ties are real: equal weights straddle the capacity's cut
        w = np.sort(w_te.transpose(-1, -2).detach().numpy(), axis=-1)[..., ::-1]
        C = pt_layers.moe_capacity(pt_cfg, tokens)
        assert np.any((w[..., C - 1] == w[..., C]) & (w[..., C] > 0))


def test_top_k_breaks_ties_as_jax_does():
    rng = _rng("ties")
    x = rng.integers(0, 4, size=(6, 500)).astype(np.float32)   # many exact ties
    x[0] = 0.0
    for k in (1, 2, 7, 499):
        vals, idx = pt_layers.top_k(torch.from_numpy(x), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


@pytest.mark.parametrize("n_tokens", [256, 257, 320, 8192])
def test_moe_capacity_is_the_references(n_tokens):
    cfg = pt_configs.get_config(MOE_ARCH)
    want = n_tokens if n_tokens <= 256 else min(
        max(int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts), 1), n_tokens)
    assert pt_layers.moe_capacity(cfg, n_tokens) == want
    assert pt_layers.moe_capacity(cfg, 8192) == 1280   # the serve prefill's capacity


def _ssd_inputs(B, S, H=8, P=32, N=32, seed=0):
    """dt and A as the Mamba2 init draws them (dt_bias from U(1e-3, 1e-1),
    a_log from log U(1, 16)), x, B and C of unit scale."""
    rng = _rng("ssd", seed)
    dt_bias = np.log(np.expm1(rng.uniform(1e-3, 1e-1, size=H)))
    dt = np.logaddexp(rng.normal(size=(B, S, H)) + dt_bias, 0.0).astype(np.float32)
    a_neg = -rng.uniform(1.0, 16.0, size=H).astype(np.float32)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    bm, cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return x, dt, a_neg, bm, cm, h0


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("S", [37, 48], ids=["S37", "S48"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "carried_state"])
def test_ssd_chunked_matches_reference(chunk, S, with_h0):
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, S, seed=S)
    h0 = h0 if with_h0 else None
    want_y, want_h = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                                         None if h0 is None else jnp.asarray(h0))
    got_y, got_h = pt_ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk,
                                      None if h0 is None else torch.from_numpy(h0))
    assert got_y.shape == (2, S, 8, 32) and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=SSD_TOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=SSD_TOL, rtol=0)


def test_ssd_decode_and_conv_steps_match_reference():
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, 12, seed=1)
    h_ref, h_pt = jnp.asarray(h0), torch.from_numpy(h0)
    for t in range(12):
        y_ref, h_ref = ref_ssm.ssd_decode_step(*map(jnp.asarray, (x[:, t], dt[:, t], a,
                                                                  bm[:, t], cm[:, t])), h_ref)
        y_pt, h_pt = pt_ssm.ssd_decode_step(*map(torch.from_numpy, (x[:, t], dt[:, t], a,
                                                                    bm[:, t], cm[:, t])), h_pt)
        np.testing.assert_allclose(y_pt.numpy(), np.asarray(y_ref), atol=SSD_TOL, rtol=0)
        np.testing.assert_allclose(h_pt.numpy(), np.asarray(h_ref), atol=SSD_TOL, rtol=0)
    rng = _rng("conv")
    seq = rng.normal(size=(2, 19, 40)).astype(np.float32)
    w, b = rng.normal(size=(4, 40)).astype(np.float32), rng.normal(size=40).astype(np.float32)
    want = ref_ssm.causal_conv(*map(jnp.asarray, (seq, w, b)))
    got = pt_ssm.causal_conv(*map(torch.from_numpy, (seq, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSD_TOL, rtol=0)
    state_ref, state_pt = jnp.zeros((2, 3, 40)), torch.zeros((2, 3, 40))
    for t in range(19):   # the step-by-step conv is the full conv's row t
        y_ref, state_ref = ref_ssm.conv_decode_step(jnp.asarray(seq[:, t]), jnp.asarray(w),
                                                    jnp.asarray(b), state_ref)
        y_pt, state_pt = pt_ssm.conv_decode_step(torch.from_numpy(seq[:, t]),
                                                 torch.from_numpy(w), torch.from_numpy(b),
                                                 state_pt)
        np.testing.assert_allclose(y_pt.numpy(), np.asarray(y_ref), atol=SSD_TOL, rtol=0)
        np.testing.assert_allclose(y_pt.numpy(), got[:, t].numpy(), atol=SSD_TOL, rtol=0)
    np.testing.assert_array_equal(state_pt.numpy(), np.asarray(state_ref))


def _recurrence(x, dt, a, bm, cm, h):
    ys = []
    for t in range(x.shape[1]):
        y, h = pt_ssm.ssd_decode_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def test_ssd_at_chunk_256_is_finite_and_meets_its_recurrence():
    """The full configs' chunk: 512 tokens in two chunks whose summed
    log-decay passes fp32's exp range. The reference's scan is NaN there;
    the port's is finite and equals its own recurrence."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 512, seed=2)
    la = np.cumsum(dt * a, axis=1)
    assert (-la[:, 255]).max() > 88.8   # exp(-la) overflows fp32 within the first chunk
    want_y, _ = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), 256)
    assert np.isnan(np.asarray(want_y)).any()
    args = tuple(map(torch.from_numpy, (x, dt, a, bm, cm)))
    y, h = pt_ssm.ssd_chunked(*args, 256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    rec_y, rec_h = _recurrence(*args, torch.zeros((1, 8, 32, 32)))
    np.testing.assert_allclose(y.numpy(), rec_y.numpy(), atol=RECURRENCE_TOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), rec_h.numpy(), atol=RECURRENCE_TOL, rtol=0)


def test_reference_forward_is_nan_at_its_default_chunk():
    """The recorded fault: reduced mamba2 at ``ssm_chunk=256`` (d 256,
    state 64, head dim 64, 2 layers), 64 tokens: the reference's logits
    are all NaN; the port's, on the same parameters, are finite."""
    shape = dict(ssm_chunk=256, n_layers=2, d_model=256, ssm_state=64, ssm_head_dim=64)
    ref_cfg, pt_cfg = _cfgs(SSM_ARCH, **shape)
    tree = ref_models.init_params(ref_cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0, ref_cfg.vocab)
    logits, _ = jax.jit(lambda p, t: ref_models.forward_train(p, ref_cfg, ShardCtx(),
                                                              {"tokens": t}))(tree, tokens)
    assert np.isnan(np.asarray(logits)).all()
    params = lm_params_from_arrays(jax.tree.map(np.asarray, tree), pt_cfg, device="cpu")
    with torch.no_grad():
        got, _ = forward_train(params, pt_cfg, {"tokens": torch.from_numpy(np.asarray(tokens))})
    assert torch.isfinite(got).all()


def test_mamba_mixer_prefill_then_decode_meets_the_full_forward():
    """The conv tail and SSD state a prefill leaves carry decode to the
    full forward's outputs, at chunk 256 on 40 tokens: prefills of 2
    tokens (fewer than the conv's K - 1 = 3, so the tail is zero-padded
    at the front), 3 and 17."""
    _, cfg = _cfgs(SSM_ARCH, ssm_chunk=256)
    params = lm_params_from_arrays(
        jax.tree.map(np.asarray, ref_models.init_params(_cfgs(SSM_ARCH)[0],
                                                        jax.random.PRNGKey(3))),
        cfg, device="cpu").blocks[0].mixer
    x = torch.from_numpy(_rng("mixer").normal(size=(2, 40, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        full, _ = pt_ssm.mamba_mixer(x, params, cfg)
        for n_prefill in (2, 3, 17):
            cache = {"ssm": torch.zeros((2, cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim)),
                     "conv": torch.zeros((2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state))}
            out, cache = pt_ssm.mamba_mixer(x[:, :n_prefill], params, cfg, cache=cache)
            outs = [out]
            for t in range(n_prefill, 40):
                o, cache = pt_ssm.mamba_mixer(x[:, t:t + 1], params, cfg, cache=cache,
                                              decode=True)
                outs.append(o)
            np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                                       atol=SSD_TOL, rtol=0, err_msg=f"prefill {n_prefill}")


@pytest.mark.parametrize("n_layers,period", [(5, 5), (16, 8)], ids=["period5", "period8"])
def test_convert_carries_hybrid_leaves_exactly(n_layers, period):
    """jamba cut to 5 layers (the card's serve cut: its kinds do not repeat,
    so the period is 5) and reduced to 16 (period 8): every leaf of port
    layer i, the router, the stacked experts and the Mamba leaves among
    them, is the reference's superblock i // period of kind i % period,
    bit for bit; ``lm_stacked_from_arrays`` slices members the same way."""
    ref_cfg, pt_cfg = _cfgs("jamba-1.5-large-398b", n_layers=n_layers)
    assert len(pt_cfg.sublayer_kinds()) == period
    stacked = jax.tree.map(np.asarray, ref_deepfed.stacked_init(ref_cfg, 2, jax.random.PRNGKey(4)))
    members = lm_stacked_from_arrays(stacked, pt_cfg, device="cpu")
    kinds_seen = set()
    for m, params in enumerate(members):
        for i, block in enumerate(params.blocks):
            ref_block = stacked["blocks"][i % period]
            kinds_seen.add(pt_cfg.sublayer_kinds()[i % period])
            for path, leaf in tree_flatten_with_path(param_tree(block)):
                node = ref_block
                for key in path.split("/"):
                    node = node[key]
                np.testing.assert_array_equal(leaf.detach().numpy(), node[m, i // period],
                                              err_msg=f"member {m} layer {i} {path}")
    assert kinds_seen == {("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp")}


def test_init_params_draws_in_blocks(monkeypatch):
    """``init_params`` draws each normal leaf in blocks along its first
    axis (jamba's experts are 12.9 GB of fp32 in one draw). With a block
    of one expert, jamba cut to 5 layers keeps every spec's shape, dtype
    and scale, no block repeats its neighbour's draw, the Mamba inits stay
    in their ranges, and a second build is bit for bit the first."""
    from repro_torch.models import init_params
    from repro_torch.models import params as pt_params

    cfg = pt_configs.get_config("jamba-1.5-large-398b").reduced(n_layers=5)
    block_bytes = 4 * cfg.d_model * cfg.d_ff
    monkeypatch.setattr(pt_params, "_DRAW_BLOCK_BYTES", block_bytes)
    built = init_params(cfg, seed=3, device="cpu")
    leaves = dict(tree_flatten_with_path(param_tree(built)))
    specs = dict(tree_flatten_with_path(pt_params.model_specs(cfg)))
    assert leaves.keys() == specs.keys()
    split = 0
    for path, spec in specs.items():
        leaf = leaves[path].detach()
        assert tuple(leaf.shape) == spec.shape and leaf.dtype == spec.dtype, path
        if spec.init == "a_log":
            assert bool(((leaf.exp() >= 1) & (leaf.exp() <= 16)).all()), path
        elif spec.init == "dt_bias":
            u = F.softplus(leaf)
            assert bool(((u >= 1e-3 - 1e-7) & (u <= 1e-1 + 1e-7)).all()), path
        elif spec.init not in ("zeros", "ones"):
            std = float(spec.init)
            assert abs(float(leaf.std()) / std - 1) < 0.1, path
            rows = max(1, block_bytes // (4 * int(np.prod(spec.shape[1:]))))
            if spec.shape[0] > rows:
                split += 1
                assert not torch.equal(leaf[:rows], leaf[rows:2 * rows]), path
    assert split >= 3   # the experts, the embedding and the head at least
    again = init_params(cfg, seed=3, device="cpu")
    for a, b in zip(built.parameters(), again.parameters()):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the deep round with a MoE arch
# ----------------------------------------------------------------------

# tests/test_torch_deepfed.py's shape (the reference's test_system.py
# settings) with 4 experts, top 2, on every layer
DEEP_SHAPE = dict(name="t-moe", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
                  d_ff=96, vocab=61, family="moe", n_experts=4, top_k=2)
DEEP_M, DEEP_B, DEEP_S, DEEP_LR = 2, 4, 24, 4e-3


@functools.lru_cache(maxsize=None)
def _deep_setup():
    ref_cfg = RefConfig(**DEEP_SHAPE, dtype=jnp.float32)
    pt_cfg = ModelConfig(**DEEP_SHAPE, dtype=torch.float32)
    clients = make_federated_lm_data(DEEP_M, ref_cfg.vocab, 3000, seed=0)
    wins = np.stack([np.stack([next(it) for _ in range(2)])
                     for it in (token_batches(c, DEEP_B, DEEP_S, seed=1) for c in clients)])
    init = jax.tree.map(np.asarray, ref_deepfed.stacked_init(ref_cfg, DEEP_M,
                                                             jax.random.PRNGKey(0)))
    test = np.stack([next(token_batches(clients[i % DEEP_M], DEEP_B, DEEP_S, seed=7))
                     for i in range(2)])
    return ref_cfg, pt_cfg, init, wins, test


def _flat(trees):
    return torch.cat([t.detach().flatten() for t in tree_leaves(trees)])


def test_deepfed_local_step_with_moe_matches_reference():
    """Step 1 of each member from the same init: its loss (aux included)
    within 1e-5 relative and the parameters after it within 1e-5, save
    elements whose gradient is below 1e-6 (AdamW's first step is
    ``lr * sign(g)``: there the sign is the rounding's)."""
    ref_cfg, pt_cfg, init, wins, _ = _deep_setup()
    one = wins[:, :1]
    ref_trained, ref_losses = ref_deepfed.make_local_train(ref_cfg, lr=DEEP_LR)(
        jax.tree.map(jnp.asarray, init), jnp.asarray(one))
    members = lm_stacked_from_arrays(init, pt_cfg, device="cpu", trainable=True)
    members, losses = deepfed.make_local_train(pt_cfg, lr=DEEP_LR)(members, one)
    rel = np.abs(losses.numpy() - np.asarray(ref_losses)) / np.abs(np.asarray(ref_losses))
    assert rel.max() <= LOSS_RTOL, rel
    want = lm_stacked_from_arrays(jax.tree.map(np.asarray, ref_trained), pt_cfg, device="cpu")
    grads = []
    for m in range(DEEP_M):
        p = lm_params_from_arrays(jax.tree.map(lambda a, m=m: np.asarray(a)[m], init), pt_cfg,
                                  device="cpu", trainable=True)
        batch = {"tokens": torch.from_numpy(one[m, 0, :, :-1]),
                 "labels": torch.from_numpy(one[m, 0, :, 1:])}
        logits, aux = forward_train(p, pt_cfg, batch)
        assert float(aux) > 0
        loss = lm_loss(logits, batch["labels"]) + pt_cfg.router_aux_coef * aux
        tree = param_tree(p)
        grads.append(tree_unflatten(tree_structure(tree),
                                    torch.autograd.grad(loss, tree_leaves(tree))))
    diff = (_flat([param_tree(m) for m in members]) - _flat([param_tree(m) for m in want])).abs()
    off = diff > PARAM_TOL
    assert bool((_flat(grads).abs()[off] < NEAR_ZERO_GRAD).all())
    assert int(off.sum()) <= 16 and float(diff.max()) <= 2 * DEEP_LR
    print(f"{int(off.sum())} of {diff.numel()} parameters off by more than {PARAM_TOL}")


def test_deepfed_ensemble_eval_loss_with_moe_matches_reference():
    ref_cfg, pt_cfg, init, _, test = _deep_setup()
    members = lm_stacked_from_arrays(init, pt_cfg, device="cpu")
    stacked = jax.tree.map(jnp.asarray, init)
    ens = ref_deepfed.ensemble_eval_loss(stacked, ref_cfg, jnp.asarray(test))
    single = ref_deepfed.ensemble_eval_loss(jax.tree.map(lambda a: a[:1], stacked), ref_cfg,
                                            jnp.asarray(test))
    assert abs(deepfed.ensemble_eval_loss(members, pt_cfg, test) - ens) <= NLL_TOL
    assert abs(deepfed.ensemble_eval_loss(members[:1], pt_cfg, test) - single) <= NLL_TOL
