"""The port's LM train step and training driver against the reference's,
on the CPU.

Reduced llama3.2-1b (fp32) starts from the reference's seeded parameters
(carried across by ``convert.lm_params_from_arrays(trainable=True)``)
and takes 3 steps of ``make_optimizer(1e-3)`` on the same
``token_batches`` windows in both packages (``jax.jit(make_train_step)``
against the port's step): losses within 1e-5 relative, every parameter
within 1e-5 absolute. A few elements are held only to a looser bound:
where a gradient is near zero (|g| < 1e-6, within 100x of AdamW's eps
1e-8), ``m / (sqrt(v) + eps)`` turns the last-place rounding of the
gradient into a visible change of the update. The test names them and
bounds their number and size. ``cast_grads`` and ``remat`` full / dots
give the ``remat="none"`` losses within 1e-6, and ``launch.train.main``
on the CPU gets the loss below 6.0 in 180 steps, as
``tests/test_system.py`` asks of the reference's driver.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro import models as ref_models
from repro.data import make_federated_lm_data, token_batches
from repro.launch import specs as ref_specs
from repro.models.layers import ShardCtx
from repro_torch import configs as pt_configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.convert import lm_params_from_arrays
from repro_torch.kernels import ops
from repro_torch.launch import train as pt_train
from repro_torch.models import forward_train, init_params, lm_loss, make_train_step, param_tree
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

ARCH, STEPS, BATCH, SEQ, LR = "llama3.2-1b", 3, 4, 32, 1e-3
LOSS_RTOL, PARAM_TOL, KNOB_TOL = 1e-5, 1e-5, 1e-6
# AdamW's normalisation amplifies the rounding of a gradient within 100x of eps
NEAR_ZERO_GRAD = 1e-6
MAX_AMPLIFIED = 16            # elements of 426,624 (7 seen)
MAX_AMPLIFIED_DIFF = 2 * STEPS * LR   # the most 3 steps can move two parameters apart


def _cfgs():
    return (ref_configs.get_config(ARCH).reduced(), pt_configs.get_config(ARCH).reduced())


@functools.lru_cache(maxsize=None)
def _ref_tree():
    ref_cfg, _ = _cfgs()
    return jax.tree.map(np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))


def _batches(vocab: int):
    clients = make_federated_lm_data(8, vocab, 2000, seed=0)
    stream = token_batches(np.concatenate(clients), BATCH, SEQ, seed=0)
    for _ in range(STEPS):
        w = next(stream)
        yield {"tokens": w[:, :-1], "labels": w[:, 1:]}


def _port_losses(cfg, steps=STEPS):
    params = lm_params_from_arrays(_ref_tree(), cfg, device="cpu", trainable=True)
    opt = pt_train.make_optimizer(LR)
    state = opt.init(param_tree(params))
    step = make_train_step(cfg, opt)
    losses = []
    for b in _batches(cfg.vocab):
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, params


def _flat(params):
    return [(k, v.detach()) for k, v in tree_flatten_with_path(param_tree(params))]


def test_train_step_matches_reference():
    ref_cfg, pt_cfg = _cfgs()
    ctx = ShardCtx()
    ref_opt = ref_specs.make_optimizer(LR)
    ref_p = jax.tree.map(jnp.asarray, _ref_tree())
    ref_s = ref_opt.init(ref_p)
    ref_step = jax.jit(ref_models.make_train_step(ref_cfg, ref_opt, ctx))
    ref_grad = jax.jit(jax.grad(
        lambda p, b: ref_models.lm_loss(ref_models.forward_train(p, ref_cfg, ctx, b)[0],
                                        b["labels"])))
    pt_opt = pt_train.make_optimizer(LR)
    pt_p = lm_params_from_arrays(_ref_tree(), pt_cfg, device="cpu", trainable=True)
    pt_s = pt_opt.init(param_tree(pt_p))
    pt_step = make_train_step(pt_cfg, pt_opt)
    near_zero = None   # per leaf: some step's reference gradient was near zero
    for b in _batches(ref_cfg.vocab):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = lm_params_from_arrays(jax.tree.map(np.asarray, ref_grad(ref_p, jb)), pt_cfg,
                                  device="cpu")
        small = [v.abs() < NEAR_ZERO_GRAD for _, v in _flat(g)]
        near_zero = small if near_zero is None else [a | s for a, s in zip(near_zero, small)]
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, jb)
        pt_p, pt_s, pt_m = pt_step(pt_p, pt_s, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "ce", "aux"):
            want, got = float(ref_m[key]), float(pt_m[key])
            assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1e-30), (key, got, want)
    ref_back = lm_params_from_arrays(jax.tree.map(np.asarray, ref_p), pt_cfg, device="cpu")
    amplified, total = [], 0
    for (key, want), (_, got), nz in zip(_flat(ref_back), _flat(pt_p), near_zero):
        diff = (got - want).abs()
        total += diff.numel()
        off = diff > PARAM_TOL
        if off.any():
            # only where the gradient was near zero, and never beyond what 3 steps allow
            assert bool(nz[off].all()), f"{key}: off by {diff.max()} without a near-zero gradient"
            assert float(diff.max()) <= MAX_AMPLIFIED_DIFF, key
            amplified += [(key, float(d)) for d in diff[off]]
    assert len(amplified) <= MAX_AMPLIFIED, amplified
    print(f"{len(amplified)} of {total} parameters off by more than {PARAM_TOL} after a "
          f"near-zero gradient: {amplified}")


def test_bf16_train_step_tracks_reference():
    """The card's training dtype: reduced llama3.2-1b in bf16 (parameters
    rounded to bf16 in both packages), 4 steps of ``make_optimizer(1e-3)``:
    losses within 2^-8 relative, one bf16 rounding, since bf16 products
    and sums round in another order in each package."""
    ref_cfg, pt_cfg = (c.reduced(dtype=d) for c, d in
                       ((ref_configs.get_config(ARCH), jnp.bfloat16),
                        (pt_configs.get_config(ARCH), torch.bfloat16)))
    tree = jax.tree.map(np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))
    ref_opt, pt_opt = ref_specs.make_optimizer(LR), pt_train.make_optimizer(LR)
    ref_p = jax.tree.map(jnp.asarray, tree)
    pt_p = lm_params_from_arrays(jax.tree.map(lambda a: np.asarray(a, np.float32), tree),
                                 pt_cfg, device="cpu", trainable=True)
    ref_s, pt_s = ref_opt.init(ref_p), pt_opt.init(param_tree(pt_p))
    ref_step = jax.jit(ref_models.make_train_step(ref_cfg, ref_opt, ShardCtx()))
    pt_step = make_train_step(pt_cfg, pt_opt)
    clients = make_federated_lm_data(8, ref_cfg.vocab, 2000, seed=0)
    stream = token_batches(np.concatenate(clients), BATCH, SEQ, seed=0)
    for _ in range(4):
        w = next(stream)
        b = {"tokens": w[:, :-1], "labels": w[:, 1:]}
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, {k: jnp.asarray(v) for k, v in b.items()})
        pt_p, pt_s, pt_m = pt_step(pt_p, pt_s, {k: torch.from_numpy(v) for k, v in b.items()})
        want = float(ref_m["loss"])
        assert abs(float(pt_m["loss"]) - want) <= 2.0 ** -8 * want
    assert pt_p.embed.dtype == torch.bfloat16 and pt_s[1]["mu"]["embed"].dtype == torch.float32


@pytest.mark.parametrize("knobs", [dict(remat="full"), dict(remat="dots"), dict(cast_grads=True),
                                   dict(remat="dots", cast_grads=True)],
                         ids=["remat_full", "remat_dots", "cast_grads", "dots_cast"])
def test_train_knobs_change_no_number(knobs):
    _, cfg = _cfgs()
    base, base_params = _port_losses(cfg)
    got, params = _port_losses(cfg.replace(**knobs))
    np.testing.assert_allclose(got, base, rtol=0, atol=KNOB_TOL)
    for (key, a), (_, b) in zip(_flat(base_params), _flat(params)):
        assert float((a - b).abs().max()) <= KNOB_TOL, key


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_in_the_backward():
    """What the backward runs again: nothing of the forward without remat,
    the blocks' elementwise work but none of their matmuls with "dots"
    (their outputs were saved), the whole blocks with "full"."""
    _, cfg = _cfgs()
    params = lm_params_from_arrays(_ref_tree(), cfg, device="cpu", trainable=True)
    b = next(_batches(cfg.vocab))
    counts = {}
    for remat in ("none", "dots", "full"):
        logits, _ = forward_train(params, cfg.replace(remat=remat), b)
        loss = lm_loss(logits, b["labels"])
        with _OpCounter() as counter:
            torch.autograd.grad(loss, tree_leaves(param_tree(params)))
        counts[remat] = counter.ops
    silu, mm = torch.ops.aten.silu.default, torch.ops.aten.mm.default
    assert counts["none"][silu] == 0
    assert counts["dots"][silu] == counts["full"][silu] == cfg.n_layers
    assert counts["dots"][mm] == counts["none"][mm]
    # the blocks' projections run again (all but the last, whose output
    # nothing saved depends on: the recompute stops early)
    assert counts["full"][mm] >= counts["none"][mm] + 6 * cfg.n_layers


def test_pallas_step_on_the_cpu_is_differentiable():
    """On the CPU the plain flash version carries the gradient, as the
    reference's CPU oracle does: the use_pallas step equals _sdpa's."""
    _, cfg = _cfgs()
    base, base_params = _port_losses(cfg)
    got, params = _port_losses(cfg.replace(use_pallas=True))
    np.testing.assert_allclose(got, base, rtol=LOSS_RTOL, atol=0)
    for (key, a), (_, b) in zip(_flat(base_params), _flat(params)):
        assert float((a - b).abs().max()) <= 10 * PARAM_TOL, key


@pytest.mark.parametrize("name", sorted(ops.KERNEL_REGISTRY))
def test_cuda_wrappers_refuse_inputs_that_require_grad(name):
    """The CUDA wrappers have no backward: an input that requires grad
    under grad mode raises before anything else (here before the device
    check, so it shows on the CPU); under no_grad the wrapper goes on to
    refuse the CPU tensor as before."""
    spec = ops.KERNEL_REGISTRY[name]
    args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in spec.make_inputs(np.random.default_rng(0)))
    args = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="no backward"):
        spec.kernel(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        spec.kernel(*args)


def test_frozen_params_refused():
    _, cfg = _cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    opt = pt_train.make_optimizer(LR)
    b = next(_batches(cfg.vocab))
    with pytest.raises(ValueError, match="trainable=True"):
        make_train_step(cfg, opt)(params, opt.init(param_tree(params)), b)


def test_train_driver_reduces_loss():
    """Twin of tests/test_system.py::test_train_driver_reduces_loss."""
    loss = pt_train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "180",
                          "--batch", "16", "--seq", "32", "--lr", "3e-3"], device="cpu")
    assert loss < 6.0  # well below uniform ln(512) = 6.24 on mixed-chain data


def test_train_driver_spans_and_checkpoint(tmp_path):
    tracer = Tracer()
    with use_tracer(tracer):
        loss = pt_train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--ckpt", str(tmp_path)], device="cpu")
    steps = [e for e in tracer.events if e["name"] == "train.step" and e["ph"] == "B"]
    metrics = [e["args"] for e in tracer.events if e["name"] == "train.metrics"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    assert [m["step"] for m in metrics] == [0, 1, 2] and metrics[-1]["loss"] == loss
    _, cfg = _cfgs()
    like = param_tree(init_params(cfg, seed=1, device="cpu"))
    restored = restore_checkpoint(str(tmp_path / "step_00000003"), {"params": like})
    assert all(torch.isfinite(t).all() for t in tree_leaves(restored))


def test_bf16_params_checkpoint_round_trip(tmp_path):
    from repro_torch.checkpoint import save_checkpoint

    _, cfg = _cfgs()
    tree = param_tree(init_params(cfg.replace(dtype=torch.bfloat16), seed=0, device="cpu"))
    save_checkpoint(str(tmp_path), {"params": tree}, step=1)
    back = restore_checkpoint(str(tmp_path), {"params": tree})["params"]
    for (key, a), (_, b) in zip(tree_flatten_with_path(tree), tree_flatten_with_path(back)):
        assert b.dtype == a.dtype and torch.equal(a.detach(), b), key


@pytest.mark.parametrize("argv,err", [
    (["--arch", "llama3.2-1b", "--reduced", "--mesh", "debug"], "queue 1 item 15"),
    (["--arch", "mixtral-8x22b", "--reduced"], "not ported yet"),
])
def test_train_driver_refuses_what_is_not_ported(argv, err):
    with pytest.raises(NotImplementedError, match=err):
        pt_train.main(argv + ["--steps", "1"], device="cpu")

