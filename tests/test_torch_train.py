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
bounds their size, and their number by a share of the elements that can
flip: those with a nonzero gradient this small (``AMPLIFIED_SHARE``). Reduced phi3.5-moe (the router's aux loss
in the loss), mamba2, llava (random patch embeddings in front of each
batch) and whisper (random frames through the encoder) are held to the
same bars step by step, each step from the reference's own state. ``cast_grads`` and
``remat`` full / dots give the ``remat="none"`` losses within 1e-6 (for
the two families too), and ``launch.train.main``
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

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

ARCH, STEPS, BATCH, SEQ, LR = "llama3.2-1b", 3, 4, 32, 1e-3
LOSS_RTOL, PARAM_TOL, KNOB_TOL = 1e-5, 1e-5, 1e-6
# AdamW's normalisation amplifies the rounding of a gradient within 100x of eps
NEAR_ZERO_GRAD = 1e-6
# Which of the near-zero elements flip is set by the last-place rounding
# of the gradient's sums, and both packages' sums follow the host's
# instruction set (ATen/MKL's kernel dispatch; XLA's codegen), so their
# count moves from host to host: phi3.5-moe flips 20 of its 5,730
# elements with 0 < sqrt(vhat) < 1e-6 on AVX-512 code paths, 14 with both
# packages held to AVX2 and 18 to SSE4.2. Over the five train-step cases
# and the three instruction sets the largest share was 0.69 % (llava,
# 9 of 1,297, SSE4.2). The bound is a share of that candidate set, about
# 3x the largest share seen.
AMPLIFIED_SHARE = 0.02
MAX_AMPLIFIED_DIFF = 2 * STEPS * LR   # the most 3 steps can move two parameters apart


# the MoE, SSM, VLM and audio families' reduced train steps, held as
# llama3.2-1b's
FAMILIES = ("phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "llava-next-mistral-7b", "whisper-base")


def _cfgs(arch=ARCH):
    return (ref_configs.get_config(arch).reduced(), pt_configs.get_config(arch).reduced())


@functools.lru_cache(maxsize=None)
def _ref_tree(arch=ARCH):
    ref_cfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(0)))


def _batches(cfg):
    """STEPS windows of the pooled synthetic data, with the VLM's patch
    embeddings and the encoder's frames (seeded normals) as the config
    asks."""
    clients = make_federated_lm_data(8, cfg.vocab, 2000, seed=0)
    stream = token_batches(np.concatenate(clients), BATCH, SEQ, seed=0)
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        w = next(stream)
        b = {"tokens": w[:, :-1], "labels": w[:, 1:]}
        if cfg.n_patches:
            b["patches"] = rng.normal(size=(BATCH, cfg.n_patches, cfg.d_model))
        if cfg.encoder_layers:
            b["frames"] = rng.normal(size=(BATCH, cfg.encoder_seq, cfg.d_model))
        yield {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in b.items()}


def _port_losses(cfg, steps=STEPS, arch=ARCH):
    params = lm_params_from_arrays(_ref_tree(arch), cfg, device="cpu", trainable=True)
    opt = pt_train.make_optimizer(LR)
    state = opt.init(param_tree(params))
    step = make_train_step(cfg, opt)
    losses = []
    for b in _batches(cfg):
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, params


def _flat(params):
    return [(k, v.detach()) for k, v in tree_flatten_with_path(param_tree(params))]


def _ref_loss(p, cfg, ctx, b):
    """The reference train step's loss: CE plus ``router_aux_coef * aux``."""
    logits, aux = ref_models.forward_train(p, cfg, ctx, b)
    return ref_models.lm_loss(logits, b["labels"]) + cfg.router_aux_coef * aux


def test_train_step_matches_reference():
    ref_cfg, pt_cfg = _cfgs()
    ctx = ShardCtx()
    ref_opt = ref_specs.make_optimizer(LR)
    ref_p = jax.tree.map(jnp.asarray, _ref_tree())
    ref_s = ref_opt.init(ref_p)
    ref_step = jax.jit(ref_models.make_train_step(ref_cfg, ref_opt, ctx))
    ref_grad = jax.jit(jax.grad(lambda p, b: _ref_loss(p, ref_cfg, ctx, b)))
    pt_opt = pt_train.make_optimizer(LR)
    pt_p = lm_params_from_arrays(_ref_tree(), pt_cfg, device="cpu", trainable=True)
    pt_s = pt_opt.init(param_tree(pt_p))
    pt_step = make_train_step(pt_cfg, pt_opt)
    near_zero = None   # per leaf: some step's reference gradient was near zero
    candidates = None  # per leaf: some step's 0 < sqrt(vhat) < 1e-6, the ones that can flip
    for b in _batches(ref_cfg):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = lm_params_from_arrays(jax.tree.map(np.asarray, ref_grad(ref_p, jb)), pt_cfg,
                                  device="cpu")
        small = [v.abs() < NEAR_ZERO_GRAD for _, v in _flat(g)]
        near_zero = small if near_zero is None else [a | s for a, s in zip(near_zero, small)]
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, jb)
        vhat = lm_params_from_arrays(jax.tree.map(np.asarray, ref_s[1]["nu"]), pt_cfg,
                                     device="cpu")
        can = [(v > 0) & (v.sqrt() < NEAR_ZERO_GRAD * (1 - 0.95 ** int(ref_s[1]["step"])) ** 0.5)
               for _, v in _flat(vhat)]
        candidates = can if candidates is None else [a | c for a, c in zip(candidates, can)]
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
    n_candidates = sum(int(c.sum()) for c in candidates)
    assert len(amplified) <= AMPLIFIED_SHARE * n_candidates, (n_candidates, amplified)
    print(f"{len(amplified)} of {total} parameters off by more than {PARAM_TOL} after a "
          f"near-zero gradient ({n_candidates} nonzero ones): {amplified}")


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


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_matches_reference(arch):
    """3 steps, each from the reference's own parameters and AdamW state
    at that step (as ``tests/test_torch_deepfed.py`` holds local steps):
    loss, ce and aux (the MoE's ``router_aux_coef * aux`` is in the loss)
    within 1e-5 relative, the next parameters within 1e-5 save a bounded
    few whose second moment is within 100x of AdamW's eps. Step by step,
    because an expert's gradient comes from a few tokens: once such an
    element has flipped, a free run moves later steps' small gradients
    too (phi3.5-moe: one element whose gradient never fell below 2.6e-6
    ended 2.1e-5 off after 3 free steps)."""
    ref_cfg, pt_cfg = _cfgs(arch)
    ref_opt = ref_specs.make_optimizer(LR)
    ref_p = jax.tree.map(jnp.asarray, _ref_tree(arch))
    ref_s = ref_opt.init(ref_p)
    ref_step = jax.jit(ref_models.make_train_step(ref_cfg, ref_opt, ShardCtx()))
    pt_step = make_train_step(pt_cfg, pt_train.make_optimizer(LR))

    def port(tree, trainable=False):
        return lm_params_from_arrays(jax.tree.map(np.asarray, tree), pt_cfg, device="cpu",
                                     trainable=trainable)

    def flat(params):
        return torch.cat([v.flatten() for _, v in _flat(params)])

    amplified, n_candidates = [], 0
    for i, b in enumerate(_batches(ref_cfg)):
        adam = ref_s[1]
        state = ({}, {"step": torch.tensor(int(adam["step"]), dtype=torch.int32),
                      "mu": param_tree(port(adam["mu"])), "nu": param_tree(port(adam["nu"]))})
        got, _, pt_m = pt_step(port(ref_p, trainable=True), state,
                               {k: torch.from_numpy(v) for k, v in b.items()})
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, {k: jnp.asarray(v) for k, v in b.items()})
        for key in ("loss", "ce", "aux"):
            want, have = float(ref_m[key]), float(pt_m[key])
            assert abs(have - want) <= LOSS_RTOL * max(abs(want), 1e-30), (i, key, have, want)
        assert (float(pt_m["aux"]) > 0) == bool(pt_cfg.n_experts)
        diff = (flat(got) - flat(port(ref_p))).abs()
        off = diff > PARAM_TOL
        vhat = flat(port(ref_s[1]["nu"])) / (1 - 0.95 ** (i + 1))
        n_candidates += int(((vhat.sqrt() < NEAR_ZERO_GRAD) & (vhat > 0)).sum())
        if off.any():
            assert bool((vhat[off].sqrt() < NEAR_ZERO_GRAD).all()), (i, float(diff.max()))
            assert float(diff.max()) <= 2 * LR, i
            amplified += [(i, float(d)) for d in diff[off]]
    assert len(amplified) <= AMPLIFIED_SHARE * n_candidates, (n_candidates, amplified)
    print(f"{len(amplified)} elements off by more than {PARAM_TOL} in {STEPS} steps, each "
          f"after a second moment within 100x of eps ({n_candidates} nonzero ones): "
          f"{amplified}")


@pytest.mark.parametrize("knobs", [dict(remat="full"), dict(remat="dots"), dict(cast_grads=True),
                                   dict(remat="dots", cast_grads=True)],
                         ids=["remat_full", "remat_dots", "cast_grads", "dots_cast"])
def test_train_knobs_change_no_number(knobs):
    _check_knobs(ARCH, knobs)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_remat_changes_no_number(arch, remat):
    _check_knobs(arch, dict(remat=remat))


@functools.lru_cache(maxsize=None)
def _knobless_run(arch):
    """The port's losses and parameters with no knob set, which every knob
    case of ``arch`` is held to."""
    return _port_losses(_cfgs(arch)[1], arch=arch)


def _check_knobs(arch, knobs):
    _, cfg = _cfgs(arch)
    base, base_params = _knobless_run(arch)
    got, params = _port_losses(cfg.replace(**knobs), arch=arch)
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
    b = next(_batches(cfg))
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


def test_remat_dots_recomputes_the_experts_products():
    """With "dots" the MoE's batched expert products (``aten.bmm``, a
    batch dimension: not saved, as ``dots_with_no_batch_dims_saveable``
    would not) run again in the backward; its router and projections
    (``aten.mm``) do not."""
    arch = FAMILIES[0]
    _, cfg = _cfgs(arch)
    params = lm_params_from_arrays(_ref_tree(arch), cfg, device="cpu", trainable=True)
    b = next(_batches(cfg))
    counts = {}
    for remat in ("none", "dots"):
        logits, aux = forward_train(params, cfg.replace(remat=remat), b)
        loss = lm_loss(logits, b["labels"]) + cfg.router_aux_coef * aux
        with _OpCounter() as counter:
            torch.autograd.grad(loss, tree_leaves(param_tree(params)))
        counts[remat] = counter.ops
    bmm, mm = torch.ops.aten.bmm.default, torch.ops.aten.mm.default
    # three expert products a MoE layer are recomputed
    assert counts["dots"][bmm] >= counts["none"][bmm] + 3 * cfg.n_layers
    assert counts["dots"][mm] == counts["none"][mm]


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
    b = next(_batches(cfg))
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
    (["--arch", "llama3.2-1b", "--reduced", "--mesh", "single"], "needs 256 ranks"),
    (["--arch", "llama3.2-1b", "--reduced", "--mesh", "multi", "--fsdp"], "needs 512 ranks"),
])
def test_train_driver_refuses_what_is_not_ported(argv, err):
    """Every ``--mesh`` is ported (``tests/test_torch_launch.py`` runs
    ``debug``); the production meshes need a world of 256 or 512 ranks,
    and in the CPU's one-rank world the driver refuses, naming them."""
    with pytest.raises(ValueError, match=err):
        pt_train.main(argv + ["--steps", "1"], device="cpu")


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-base"])
def test_train_driver_runs_the_vlm_and_audio_families(arch):
    """``launch.train.main`` on the reduced VLM (zero patches in each
    batch) and encoder-decoder (zero frames), as the reference's driver
    feeds them: 3 steps, each loss finite and within 1 of ln(vocab), the
    cross-entropy of a model at its random init."""
    tracer = Tracer()
    with use_tracer(tracer):
        loss = pt_train.main(["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--lr", "3e-3"], device="cpu")
    losses = [e["args"]["loss"] for e in tracer.events if e["name"] == "train.metrics"]
    assert len(losses) == 3 and losses[-1] == loss
    assert all(abs(x - np.log(_cfgs(arch)[1].vocab)) < 1.0 for x in losses), losses

