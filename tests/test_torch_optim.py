"""The port's optimizers, schedules, tree helpers and small losses against
the reference's, on the CPU.

The same seeded numpy trees and gradients go through ``repro.optim`` and
``repro_torch.optim``: updates, optimizer states and the parameters after
``apply_updates`` within 1e-6 over 5 updates (fp32 arithmetic in the same
order; pow and sqrt may round differently in the last place), schedules
within 1e-7 at steps 0-120 (relative where the rate exceeds 1). Tree helpers, ``accuracy``,
``binary_cross_entropy`` and the distillation losses agree within 1e-6;
the substrate tests' twins run the port's optimizers on torch autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import distill as ref_distill
from repro.utils import metrics as ref_metrics
from repro.utils import trees as ref_trees
from repro_torch import optim as pt_optim
from repro_torch.core import distill as pt_distill
from repro_torch.utils import metrics as pt_metrics
from repro_torch.utils import trees as pt_trees

UPDATE_TOL, SCHEDULE_TOL, LOSS_TOL = 1e-6, 1e-7, 1e-6
N_UPDATES = 5


def _tree(rng) -> dict:
    """A nested tree of fp32 arrays: dicts, a list and a tuple."""
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"layer": {"w": f(4, 3), "b": f(3)}, "stack": [f(5), f(2, 2)], "pair": (f(3), f(1, 6))}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return pt_trees.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves_np(tree, ref: bool):
    leaves = jax.tree.leaves(tree) if ref else pt_trees.tree_leaves(tree)
    return [np.asarray(leaf) for leaf in leaves]


def _close(ref_tree, pt_tree, tol):
    a, b = _leaves_np(ref_tree, True), _leaves_np(pt_tree, False)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, x.dtype, y.shape, y.dtype)
        np.testing.assert_allclose(y, x, rtol=0, atol=tol)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.05),
    "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_decay": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "clip": lambda m: m.clip_by_global_norm(1.0),
    "chain": lambda m: m.chain(m.clip_by_global_norm(1.0), m.adamw(1e-2, weight_decay=0.1)),
    "adamw_schedule": lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 2, 5)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_and_states_match_reference(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    ref_opt, pt_opt = OPTIMIZERS[name](ref_optim), OPTIMIZERS[name](pt_optim)
    ref_p, pt_p = _to_jax(params), _to_torch(params)
    ref_s, pt_s = ref_opt.init(ref_p), pt_opt.init(pt_p)
    _close(ref_s, pt_s, 0.0)
    for _ in range(N_UPDATES):
        grads = pt_trees.tree_map(lambda a: (3.0 * rng.normal(size=a.shape)).astype(np.float32),
                                  params)
        ref_u, ref_s = ref_opt.update(_to_jax(grads), ref_s, ref_p)
        pt_u, pt_s = pt_opt.update(_to_torch(grads), pt_s, pt_p)
        _close(ref_u, pt_u, UPDATE_TOL)
        _close(ref_s, pt_s, UPDATE_TOL)
        ref_p = ref_optim.apply_updates(ref_p, ref_u)
        pt_p = pt_optim.apply_updates(pt_p, pt_u)
        _close(ref_p, pt_p, UPDATE_TOL)


def test_apply_updates_adds_in_fp32_and_keeps_the_dtype():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(64,)).astype(np.float32)
    u = (1e-3 * rng.normal(size=(64,))).astype(np.float32)
    ref = ref_optim.apply_updates({"p": jnp.asarray(p, jnp.bfloat16)}, {"p": jnp.asarray(u)})
    pt = pt_optim.apply_updates({"p": torch.from_numpy(p).to(torch.bfloat16)},
                                {"p": torch.from_numpy(u)})
    assert pt["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pt["p"].float().numpy(), np.asarray(ref["p"], np.float32))


SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "cosine": lambda m: m.cosine_decay(2.0, 100, floor=0.5),
    "warmup_cosine": lambda m: m.linear_warmup_cosine(1.0, 10, 110),
    "warmup_cosine_floor": lambda m: m.linear_warmup_cosine(3e-4, 7, 50, floor=1e-5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    ref_fn, pt_fn = SCHEDULES[name](ref_optim), SCHEDULES[name](pt_optim)
    for step in range(121):
        want = float(ref_fn(jnp.asarray(step, jnp.int32)))
        got = pt_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        # relative above 1: cos rounds one fp32 ulp apart (1.2e-7 at 1.97)
        assert abs(float(got) - want) <= SCHEDULE_TOL * max(1.0, abs(want)), (step, float(got), want)


# ---------------- twins of tests/test_substrate.py's optimizer tests ----------------

def _rosenbrockish(params):
    return torch.sum((params["w"] - 3.0) ** 2) + torch.sum(params["b"] ** 2)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw", "chained"])
def test_optimizers_minimize_quadratic(opt_name):
    opt = {
        "sgd": pt_optim.sgd(0.1, momentum=0.9),
        "adamw": pt_optim.adamw(0.3),
        "chained": pt_optim.chain(pt_optim.clip_by_global_norm(10.0), pt_optim.adamw(0.3)),
    }[opt_name]
    params = {"w": torch.zeros(4), "b": torch.ones(3)}
    state = opt.init(params)
    for _ in range(200):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(_rosenbrockish(leaves), list(leaves.values()))))
        upd, state = opt.update(g, state, params)
        params = pt_optim.apply_updates(params, upd)
    assert float(_rosenbrockish(params)) < 1e-2


def test_clip_by_global_norm_bounds():
    opt = pt_optim.clip_by_global_norm(1.0)
    g = {"a": torch.full((100,), 10.0)}
    upd, _ = opt.update(g, {}, None)
    assert float(pt_trees.tree_global_norm(upd)) <= 1.0 + 1e-5


def test_schedules_shapes():
    s = pt_optim.linear_warmup_cosine(1.0, 10, 110)
    assert float(s(torch.tensor(0))) == 0.0
    assert float(s(torch.tensor(10))) == pytest.approx(1.0, abs=1e-6)
    assert float(s(torch.tensor(110))) == pytest.approx(0.0, abs=1e-6)
    c = pt_optim.cosine_decay(2.0, 100, floor=0.5)
    assert float(c(torch.tensor(0))) == pytest.approx(2.0)
    assert float(c(torch.tensor(1000))) == pytest.approx(0.5)


def test_adamw_weight_decay_shrinks_params():
    opt = pt_optim.adamw(1e-2, weight_decay=0.5)
    params = {"w": torch.full((3,), 10.0)}
    state = opt.init(params)
    upd, state = opt.update({"w": torch.zeros(3)}, state, params)
    params2 = pt_optim.apply_updates(params, upd)
    assert float(params2["w"][0]) < 10.0


# ---------------- tree helpers, metrics, distillation losses ----------------

def test_tree_stack_unstack_index_match_reference():
    rng = np.random.default_rng(2)
    members = [_tree(rng) for _ in range(3)]
    ref = ref_trees.tree_stack([_to_jax(m) for m in members])
    for pt in (pt_trees.tree_stack([_to_torch(m) for m in members]), pt_trees.tree_stack(members)):
        _close(ref, pt, 0.0)
        for i, (r, p) in enumerate(zip(ref_trees.tree_unstack(ref), pt_trees.tree_unstack(pt))):
            _close(r, p, 0.0)
            _close(ref_trees.tree_index(ref, i), pt_trees.tree_index(pt, i), 0.0)
            assert pt_trees.tree_structure(p) == pt_trees.tree_structure(members[0])


def test_tree_global_norm_and_cast_match_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    tree["count"] = np.arange(4, dtype=np.int32)
    want = float(ref_trees.tree_global_norm(_to_jax(tree)))
    for pt in (_to_torch(tree), tree):
        got = pt_trees.tree_global_norm(pt)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-6 * want
    ref_cast = ref_trees.tree_cast(_to_jax(tree), jnp.float16)
    pt_cast = pt_trees.tree_cast(_to_torch(tree), torch.float16)
    assert pt_cast["count"].dtype == torch.int32 and pt_cast["layer"]["w"].dtype == torch.float16
    for x, y in zip(_leaves_np(ref_cast, True), _leaves_np(pt_cast, False)):
        np.testing.assert_array_equal(y, x)
    np_cast = pt_trees.tree_cast(tree, np.float16)
    assert np_cast["layer"]["b"].dtype == np.float16 and np_cast["count"].dtype == np.int32


def test_accuracy_and_bce_match_reference():
    rng = np.random.default_rng(4)
    labels = np.where(rng.random(257) < 0.5, 1.0, -1.0).astype(np.float32)
    scores = rng.normal(size=257).astype(np.float32)
    scores[:5] = 0.0   # sign 0 counts as +1 in both
    assert pt_metrics.accuracy(labels, scores) == ref_metrics.accuracy(labels, scores)
    logits = (4.0 * rng.normal(size=257)).astype(np.float32)
    for lab in (labels, (labels > 0).astype(np.int32)):
        want = float(ref_metrics.binary_cross_entropy(lab, logits))
        got = pt_metrics.binary_cross_entropy(lab, torch.from_numpy(logits))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= LOSS_TOL * max(want, 1.0)


@pytest.mark.parametrize("name,kw", [("l2", {}), ("kl", {}), ("kl", {"temperature": 2.5})],
                         ids=["l2", "kl", "kl_t2.5"])
def test_distill_losses_match_reference(name, kw):
    rng = np.random.default_rng(5)
    student = (2.0 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    teacher = (2.0 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    want = float(ref_distill.DISTILL_LOSSES[name](jnp.asarray(student), jnp.asarray(teacher), **kw))
    got = pt_distill.DISTILL_LOSSES[name](torch.from_numpy(student), torch.from_numpy(teacher), **kw)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_TOL * max(want, 1.0)
