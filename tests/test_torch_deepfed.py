"""The port's deep one-shot round (``core/deepfed.py``) and few-shot rounds
(``core/fewshot.py``) against the reference's, on the CPU.

The settings are the reference's own (``tests/test_system.py``: 2 layers,
d 48, vocab 61, 3 members, 25 local steps of 4 x 24 tokens at lr 4e-3;
``tests/test_futurework.py`` for the few-shot rounds). The port's draws
are not JAX's, so every test starts the port from the reference's:
``stacked_init`` / ``init_params`` of ``repro_torch.core.deepfed`` are
monkeypatched to return ``convert``'s copy of the reference's
``stacked_init(cfg, M, PRNGKey(seed))`` / ``init_params(cfg,
PRNGKey(seed))``.

Local training is held two ways. Step by step: each member's step from
the reference's parameters and optimizer state at that step (the
trajectory of ``jit(vmap(train_one))``) gives the reference's loss within
1e-5 relative and its next parameters within 1e-5, save a bounded few
elements whose second moment is within 100x of AdamW's eps (1e-8): there
``m / (sqrt(v) + eps)`` turns the last-place rounding of the gradient
into a visible change of the update (as in ``test_torch_train.py``; 3
elements in 75 steps here). Free-running: ``train_many`` against ``jit(vmap)`` from the
same inits, losses within 1e-5 at step 1 and within 1e-3 after, since
such an element starts a drift that 25 steps at lr 4e-3 carry on (member
1 reaches 2.8e-4 by step 25; members 0 and 2 stay within 4e-7).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.core import deepfed as ref_deepfed
from repro.core.fewshot import run_few_shot as ref_run_few_shot
from repro.data import make_federated_lm_data, token_batches
from repro.models.config import ModelConfig as RefConfig
from repro.models.layers import ShardCtx
from repro.optim import adamw as ref_adamw
from repro.optim import chain as ref_chain
from repro.optim import clip_by_global_norm as ref_clip
from repro_torch import configs as pt_configs
from repro_torch.convert import lm_params_from_arrays, lm_stacked_from_arrays
from repro_torch.core import deepfed
from repro_torch.core.fewshot import run_few_shot
from repro_torch.models import make_train_step, param_tree
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.utils.trees import tree_leaves

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

SHAPE = dict(name="t", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96,
             vocab=61)
M, STEPS, BATCH, SEQ, LR = 3, 25, 4, 24, 4e-3
LOSS_RTOL, PARAM_TOL, NLL_TOL, DRIFT_RTOL = 1e-5, 1e-5, 1e-6, 1e-3
NEAR_EPS = 1e-6          # sqrt(v_hat) within 100x of AdamW's eps
MAX_AMPLIFIED = 16       # elements over the 75 steps (3 seen)
FEWSHOT_TOL = 1e-4


def _cfgs(**shape):
    shape = shape or SHAPE
    return RefConfig(**shape, dtype=jnp.float32), ModelConfig(**shape, dtype=torch.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def inject_reference_inits(monkeypatch, ref_cfg):
    """Route the port's ``stacked_init`` and ``init_params`` to the
    reference's draws for ``ref_cfg``'s shapes."""

    def stacked(cfg, n_members, seed=0, device="cuda"):
        tree = _np(ref_deepfed.stacked_init(ref_cfg, n_members, jax.random.PRNGKey(seed)))
        return lm_stacked_from_arrays(tree, cfg, device=device, trainable=True)

    def init(cfg, seed=0, device="cuda", trainable=False):
        tree = _np(ref_models.init_params(ref_cfg, jax.random.PRNGKey(seed)))
        return lm_params_from_arrays(tree, cfg, device=device, trainable=trainable)

    monkeypatch.setattr(deepfed, "stacked_init", stacked)
    monkeypatch.setattr(deepfed, "init_params", init)


@functools.lru_cache(maxsize=None)
def _reference_round():
    """The reference's ``deep_run``: inits, windows, trained members,
    losses and test windows, as numpy."""
    ref_cfg, _ = _cfgs()
    clients = make_federated_lm_data(M, ref_cfg.vocab, 3000, seed=0)
    wins = np.stack([np.stack([next(it) for _ in range(STEPS)])
                     for it in (token_batches(c, BATCH, SEQ, seed=1) for c in clients)])
    init = _np(ref_deepfed.stacked_init(ref_cfg, M, jax.random.PRNGKey(0)))
    trained, losses = ref_deepfed.make_local_train(ref_cfg, lr=LR)(
        jax.tree.map(jnp.asarray, init), jnp.asarray(wins))
    test = np.stack([next(token_batches(clients[i % M], BATCH, SEQ, seed=7)) for i in range(4)])
    return init, wins, _np(trained), np.asarray(losses), test


def test_train_many_matches_jit_vmap():
    _, cfg = _cfgs()
    init, wins, _, ref_losses, _ = _reference_round()
    members = lm_stacked_from_arrays(init, cfg, device="cpu", trainable=True)
    got, losses = deepfed.make_local_train(cfg, lr=LR)(members, wins)
    assert got is members and losses.shape == (M, STEPS) and losses.dtype == torch.float32
    rel = np.abs(losses.numpy() - ref_losses) / np.abs(ref_losses)
    assert rel[:, 0].max() <= LOSS_RTOL, rel[:, 0]
    assert rel.max() <= DRIFT_RTOL, rel.max(axis=1)
    assert float(losses[:, -1].mean()) < float(losses[:, 0].mean()) - 0.3   # it learns


def _flat(tree):
    return torch.cat([t.detach().flatten() for t in tree_leaves(tree)])


def test_local_steps_match_the_references_trajectory():
    """Each of the 75 member steps from the reference's own state."""
    ref_cfg, cfg = _cfgs()
    init, wins, trained, ref_losses, _ = _reference_round()
    ref_opt = ref_chain(ref_clip(1.0), ref_adamw(LR))
    ref_step = jax.jit(ref_models.make_train_step(ref_cfg, ref_opt, ShardCtx()))
    step = make_train_step(cfg, chain(clip_by_global_norm(1.0), adamw(LR)))

    def port(tree, trainable=False):
        return lm_params_from_arrays(_np(tree), cfg, device="cpu", trainable=trainable)

    amplified = []
    for m in range(M):
        p = jax.tree.map(lambda a, m=m: jnp.asarray(a[m]), init)
        s = ref_opt.init(p)
        for i, w in enumerate(wins[m]):
            batch = {"tokens": w[:, :-1], "labels": w[:, 1:]}
            adam = s[1]
            state = ({}, {"step": torch.tensor(int(adam["step"]), dtype=torch.int32),
                          "mu": param_tree(port(adam["mu"])), "nu": param_tree(port(adam["nu"]))})
            got, _, metrics = step(port(p, trainable=True), state,
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
            p, s, ref_metrics = ref_step(p, s, {k: jnp.asarray(v) for k, v in batch.items()})
            want = float(ref_metrics["loss"])
            assert want == float(ref_losses[m, i])   # the step loop is jit(vmap)'s trajectory
            assert abs(float(metrics["loss"]) - want) <= LOSS_RTOL * want, (m, i)
            diff = (_flat(param_tree(got)) - _flat(param_tree(port(p)))).abs()
            off = diff > PARAM_TOL
            if off.any():
                vhat = _flat(param_tree(port(s[1]["nu"]))) / (1 - 0.95 ** (i + 1))
                assert bool((vhat[off].sqrt() < NEAR_EPS).all()), (m, i, float(diff.max()))
                assert float(diff.max()) <= 2 * LR, (m, i)
                amplified += [(m, i, float(d)) for d in diff[off]]
        assert torch.equal(_flat(param_tree(port(p))),
                           _flat(param_tree(port(jax.tree.map(lambda a, m=m: a[m], trained)))))
    assert len(amplified) <= MAX_AMPLIFIED, amplified
    print(f"{len(amplified)} elements off by more than {PARAM_TOL} in {M * STEPS} steps, "
          f"each after a second moment within 100x of eps: {amplified}")


def test_ensemble_eval_loss_of_the_references_members():
    ref_cfg, cfg = _cfgs()
    _, _, trained, _, test = _reference_round()
    members = lm_stacked_from_arrays(trained, cfg, device="cpu")
    stacked = jax.tree.map(jnp.asarray, trained)
    ens = ref_deepfed.ensemble_eval_loss(stacked, ref_cfg, jnp.asarray(test))
    single = ref_deepfed.ensemble_eval_loss(jax.tree.map(lambda x: x[:1], stacked), ref_cfg,
                                            jnp.asarray(test))
    assert abs(deepfed.ensemble_eval_loss(members, cfg, test) - ens) <= NLL_TOL
    assert abs(deepfed.ensemble_eval_loss(members[:1], cfg, test) - single) <= NLL_TOL
    assert ens < single   # mixture data: the ensemble wins, as the reference's test asks
    lp = deepfed.ensemble_log_probs(members, cfg, test[0, :, :-1])
    np.testing.assert_allclose(torch.logsumexp(lp, dim=-1).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("loss_kind", ["kl", "l2"])
def test_distill_to_student_matches_reference(loss_kind, monkeypatch):
    ref_cfg, cfg = _cfgs()
    _, _, trained, _, test = _reference_round()
    inject_reference_inits(monkeypatch, ref_cfg)
    stacked = jax.tree.map(jnp.asarray, trained)
    ref_student, ref_losses = ref_deepfed.distill_to_student(
        ref_cfg, ref_cfg, stacked, jnp.asarray(test), steps=15, lr=LR, loss_kind=loss_kind)
    members = lm_stacked_from_arrays(trained, cfg, device="cpu")
    student, losses = deepfed.distill_to_student(cfg, cfg, members, test, steps=15, lr=LR,
                                                 loss_kind=loss_kind, device="cpu")
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]
    assert deepfed.one_shot_comm_bytes(members, M, student, n_devices=M) == \
        ref_deepfed.one_shot_comm_bytes(stacked, M, ref_student, n_devices=M)
    assert deepfed.one_shot_comm_bytes(members, M) == ref_deepfed.one_shot_comm_bytes(stacked, M)
    assert deepfed.fedavg_comm_bytes(student, 10, M) == \
        ref_deepfed.fedavg_comm_bytes(ref_student, 10, M)
    # a flash teacher runs on the CPU through the plain flash version
    _, flash_losses = deepfed.distill_to_student(cfg, cfg.replace(use_pallas=True), members,
                                                 test, steps=15, lr=LR, loss_kind=loss_kind,
                                                 device="cpu")
    np.testing.assert_allclose(flash_losses, losses, rtol=LOSS_RTOL, atol=0)


def test_stacked_init_builds_distinct_trainable_members():
    _, cfg = _cfgs()
    members = deepfed.stacked_init(cfg, 3, seed=5, device="cpu")
    again = deepfed.stacked_init(cfg, 3, seed=5, device="cpu")
    assert all(p.requires_grad for m in members for p in m.parameters())
    assert torch.equal(members[1].embed, again[1].embed)
    assert not torch.equal(members[0].embed, members[1].embed)


def test_few_shot_matches_reference(monkeypatch):
    """``tests/test_futurework.py::test_fewshot_matches_oneshot_at_budget``'s
    settings through both packages."""
    shape = dict(name="fs", n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab=61)
    ref_cfg, cfg = _cfgs(**shape)
    inject_reference_inits(monkeypatch, ref_cfg)
    n_clients, B, S, R, wpr = 2, 4, 16, 2, 6
    clients = make_federated_lm_data(n_clients, cfg.vocab, 3000, seed=0)
    wins = np.stack([np.stack([next(it) for _ in range(R * wpr)])
                     for it in (token_batches(c, B, S, seed=1) for c in clients)])
    proxy, test = wins[:, 0], wins[0, :2]
    kw = dict(rounds=R, lr=4e-3, distill_steps=10, windows_per_round=wpr)
    want = ref_run_few_shot(ref_cfg, jnp.asarray(wins), jnp.asarray(proxy), jnp.asarray(test),
                            **kw)
    got = run_few_shot(cfg, wins, proxy, test, device="cpu", **kw)
    assert got.rounds == want.rounds == R and len(got.round_nll) == R
    np.testing.assert_allclose(got.round_nll, want.round_nll, rtol=0, atol=FEWSHOT_TOL)
    assert got.comm_bytes_per_round == want.comm_bytes_per_round > 0
    assert all(np.isfinite(got.round_nll))


def test_vlm_and_audio_in_the_deep_round():
    """The round feeds tokens alone, in both packages: the reduced llava's
    members (the reference's draws) give the reference's ensemble
    log-probabilities (magnitude ~5 at the reduced width) within the
    training logits' 1e-5 and held-out NLL within 1e-6, without their patch
    prefix; whisper's encoder needs frames, and both packages raise
    ``KeyError`` naming them."""
    ref_cfg = ref_configs.get_config("llava-next-mistral-7b").reduced()
    cfg = pt_configs.get_config("llava-next-mistral-7b").reduced()
    tree = _np(ref_deepfed.stacked_init(ref_cfg, 2, jax.random.PRNGKey(0)))
    members = lm_stacked_from_arrays(tree, cfg, device="cpu")
    windows = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 2, 13)).astype(np.int32)
    stacked = jax.tree.map(jnp.asarray, tree)
    want = ref_deepfed.ensemble_log_probs(stacked, ref_cfg, jnp.asarray(windows[0, :, :-1]))
    got = deepfed.ensemble_log_probs(members, cfg, torch.from_numpy(windows[0, :, :-1]))
    assert got.shape == (2, 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want_nll = ref_deepfed.ensemble_eval_loss(stacked, ref_cfg, jnp.asarray(windows))
    assert abs(deepfed.ensemble_eval_loss(members, cfg, windows) - want_nll) <= NLL_TOL

    ref_cfg = ref_configs.get_config("whisper-base").reduced()
    cfg = pt_configs.get_config("whisper-base").reduced()
    tree = _np(ref_deepfed.stacked_init(ref_cfg, 1, jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match="frames"):
        ref_deepfed.ensemble_log_probs(jax.tree.map(jnp.asarray, tree), ref_cfg,
                                       jnp.asarray(windows[0, :, :-1]))
    with pytest.raises(KeyError, match="frames"):
        deepfed.ensemble_log_probs(lm_stacked_from_arrays(tree, cfg, device="cpu"), cfg,
                                   torch.from_numpy(windows[0, :, :-1]))
