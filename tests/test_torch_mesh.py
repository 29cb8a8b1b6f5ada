"""The LM mesh of the port (``ShardCtx``, ``sharding.rules``' spec trees
and placements, ``launch.mesh``' LM meshes, ``launch.specs``) against the
reference, on the CPU.

* Spec parity, with no world at all: for every arch, on duck-typed
  (16, 16) and (2, 16, 16) meshes, under the default rules, FSDP and each
  dry-run lever's rules, the port's ``spec_tree`` of ``abstract_params``
  and of the cache equals the reference's with its leading ``"layers"``
  entry dropped (the port keeps one entry per layer; layer i is the
  reference's sub-layer kind i % period).
* The reference's specs matrix (10 archs x train_4k, prefill_32k,
  decode_32k), its long-context applicability matrix and the optimizer
  state's logical axes, against ``launch.specs`` and ``configs``.
* Numerics on spawned gloo worlds (``tests/_mesh_world.py``) of 1, 2 and
  4 ranks: meshes (1, 1), (2, 1), (1, 2) and (2, 2), FSDP off and on
  where the data axis has 2 ranks (FSDP shards over it; on a 1-rank data
  axis it would shard over one rank), on
  reduced llama3.2-1b, phi3.5-moe and mamba2 carried from the
  reference's init, and GQA at 4 q heads over 1 kv head on (1, 2). Each
  sharded result is held to the port's unsharded run and the
  reference's: logits, prefill and decode logits (``use_pallas``) within
  1e-5 of their largest magnitude; loss, ce and aux within 1e-5
  relative; the next parameters within 1e-5 save the near-eps elements
  ``tests/test_torch_train.py`` allows, at most its share of them.
"""
import functools
import pickle
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _mesh_world
from repro import configs as ref_configs
from repro import models as ref_models
from repro.launch import specs as ref_specs
from repro.models.layers import ShardCtx as RefShardCtx
from repro.sharding.rules import ShardingRules as RefRules
from repro.sharding.rules import spec_tree as ref_spec_tree
from repro_torch import configs as pt_configs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import dryrun as pt_dryrun
from repro_torch.launch import specs as pt_specs
from repro_torch.models import (
    abstract_cache,
    abstract_params,
    cache_logical_axes,
    forward_train,
    init_cache,
    logical_axes,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    param_tree,
)
from repro_torch.sharding.rules import ShardingRules, placements, spec_tree
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

from test_torch_train import AMPLIFIED_SHARE, NEAR_ZERO_GRAD  # noqa: E402

TOL = 1e-5
LR = _mesh_world.LR
B, S = 4, 16


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"16x16": _FakeMesh((16, 16), ("data", "model")),
          "2x16x16": _FakeMesh((2, 16, 16), ("pod", "data", "model"))}

LEVERS = {
    "default": {},
    "fsdp": {"fsdp": True},
    "shard_kv_seq": {"shard_kv_seq": True},
    "replicate_embed": {"replicate_embed": True},
    "shard_attn_seq": {"shard_attn_seq": True},
    "expert_parallel": {"expert_parallel": True},
}


def _ref_lever_rules(fsdp=False, shard_kv_seq=False, replicate_embed=False,
                     shard_attn_seq=False, expert_parallel=False):
    """The rules of the reference's ``dryrun.run_one``, built as it builds them."""
    rules = RefRules(fsdp=fsdp)
    updates = {}
    if shard_kv_seq:
        updates["kv_seq"] = "data"
    if replicate_embed:
        updates["vocab_in"] = None
    if shard_attn_seq:
        updates["attn_q_seq"] = "model"
    if expert_parallel:
        updates["experts"] = "model"
    return rules.replace(table_updates=updates) if updates else rules


def _rules(lever):
    kw = dict(LEVERS[lever])
    fsdp = kw.pop("fsdp", False)
    port = pt_dryrun.lever_rules(fsdp, **kw)
    ref = _ref_lever_rules(fsdp, **kw)
    assert port.table == ref.table and port.fsdp == ref.fsdp
    return port, ref


def _ref_specs(tree):
    """{path: spec tuple} of the reference's spec tree, P leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(path, simple=True, separator="/"): tuple(spec)
            for path, spec in leaves}


def _port_path(path, period):
    """The reference's path of a port leaf: blocks/i/... -> blocks/(i % period)/...;
    the encoder's layers are one stacked kind."""
    parts = path.split("/")
    if parts[0] == "blocks":
        parts[1] = str(int(parts[1]) % period)
    elif parts[0] == "encoder" and parts[1] == "blocks":
        parts[2:3] = []
    return "/".join(parts)


def _check_parity(port_tree, ref_tree, period, what):
    ref = _ref_specs(ref_tree)
    port = dict(_spec_items(port_tree))
    seen = set()
    for path, spec in port.items():
        key = _port_path(path, period)
        want = ref[key]
        if key.startswith(("blocks/", "encoder/blocks/")):   # stacked on "layers"
            assert want[0] is None, (what, key, want)       # which maps to no mesh axis
            want = want[1:]
        assert tuple(spec) == tuple(want), (what, path, spec, want)
        seen.add(key)
    assert seen == set(ref), (what, set(ref) - seen)


def _spec_items(tree, prefix=""):
    """(path, spec) pairs of a port spec or logical-axes tree: dicts and
    lists are walked, tuples are the leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_items(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("lever", sorted(LEVERS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_parity_with_the_reference(mesh_name, lever):
    mesh = MESHES[mesh_name]
    port_rules, ref_rules = _rules(lever)
    for arch in sorted(pt_configs.ARCHS):
        pt_cfg, ref_cfg = pt_configs.get_config(arch), ref_configs.get_config(arch)
        period = len(pt_cfg.sublayer_kinds())
        port = spec_tree(mesh, abstract_params(pt_cfg), logical_axes(pt_cfg), port_rules)
        ref = ref_spec_tree(mesh, ref_models.abstract_params(ref_cfg),
                            ref_models.logical_axes(ref_cfg), ref_rules)
        _check_parity(port, ref, period, (arch, "params"))
        shape = pt_configs.SHAPES["decode_32k"]
        Bd, Sd = shape.global_batch, shape.seq_len
        port = spec_tree(mesh, abstract_cache(pt_cfg, Bd, Sd)["blocks"],
                         cache_logical_axes(pt_cfg, Bd, Sd)["blocks"], port_rules)
        ref = ref_spec_tree(mesh, ref_models.abstract_cache(ref_cfg, Bd, Sd)["blocks"],
                            ref_models.cache_logical_axes(ref_cfg, Bd, Sd)["blocks"], ref_rules)
        _check_parity({"blocks": port}, {"blocks": ref}, period, (arch, "cache"))


def test_placements_of_a_spec():
    """One placement per mesh dim; a dim over (pod, data) takes both mesh
    dims in the mesh's order, and the reverse order is refused."""
    mesh = MESHES["2x16x16"]
    assert placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)


@pytest.mark.parametrize("arch", sorted(pt_configs.ARCHS))
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_specs_shapes(arch, shape_name):
    """The reference's ``test_specs_shapes``, against the port's specs:
    every shape, dtype and logical-axis tuple equal."""
    pt_cfg, ref_cfg = pt_configs.get_config(arch), ref_configs.get_config(arch)
    shape = pt_configs.SHAPES[shape_name]
    if shape.kind == "decode":
        (toks, cache), (tla, cla) = pt_specs.decode_specs(pt_cfg, shape)
        (rtoks, rcache), (rtla, rcla) = ref_specs.decode_specs(ref_cfg, ref_configs.SHAPES[shape_name])
        assert tuple(toks.shape) == rtoks.shape == (shape.global_batch, 1) and tla == rtla
        leaves = dict(_spec_items(cache["blocks"]))
        logical = dict(_spec_items(cla["blocks"]))
        assert leaves.keys() == logical.keys()
        period = len(pt_cfg.sublayer_kinds())
        ref_shapes = {jax.tree_util.keystr(path, simple=True, separator="/"): leaf.shape
                      for path, leaf in jax.tree_util.tree_flatten_with_path(rcache["blocks"])[0]}
        for path, t in leaves.items():
            assert t.is_meta and t.ndim == len(logical[path]), path
            want = ref_shapes[_port_path("blocks/" + path, period)[len("blocks/"):]]
            assert tuple(t.shape) == want[1:], path   # the reference's leading "layers" dim
    else:
        batch, la = pt_specs.batch_specs(pt_cfg, shape)
        rbatch, rla = ref_specs.batch_specs(ref_cfg, ref_configs.SHAPES[shape_name])
        assert set(batch) == set(la) == set(rbatch) and la == rla
        for k, t in batch.items():
            assert t.is_meta and tuple(t.shape) == rbatch[k].shape, k
            assert str(t.dtype).split(".")[-1] == str(rbatch[k].dtype), k


def test_long_context_applicability_matrix():
    for name, shape in pt_configs.SHAPES.items():
        for arch in pt_configs.arch_names():
            assert pt_configs.shape_applicable(pt_configs.get_config(arch), shape) == \
                ref_configs.shape_applicable(ref_configs.get_config(arch),
                                             ref_configs.SHAPES[name]), (arch, name)
    longs = {a for a in pt_configs.ARCHS
             if pt_configs.shape_applicable(pt_configs.ARCHS[a], pt_configs.SHAPES["long_500k"])}
    assert longs == {"mamba2-2.7b", "jamba-1.5-large-398b", "mixtral-8x22b"}
    assert pt_configs.supports_long_context(pt_configs.VARIANTS["llama3.2-1b-swa8k"])
    assert pt_configs.arch_names() == ref_configs.arch_names()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b", "whisper-base"])
def test_opt_state_logical_matches_structure(arch):
    """``opt_state_logical`` mirrors ``abstract_opt_state`` leaf for leaf
    (one name per dim), and the moments are meta fp32 of the parameters'
    shapes."""
    cfg = pt_configs.get_config(arch)
    state, la = pt_specs.abstract_opt_state(cfg), pt_specs.opt_state_logical(cfg)
    assert la[0] == {} and state[0] == {} and la[1]["step"] == ()
    assert state[1]["step"].ndim == 0
    for key in ("mu", "nu"):
        leaves, names = dict(_spec_items(state[1][key])), dict(_spec_items(la[1][key]))
        params = dict(_spec_items(abstract_params(cfg)))
        assert leaves.keys() == names.keys() == params.keys()
        for path, t in leaves.items():
            assert t.is_meta and t.dtype == torch.float32, path
            assert t.ndim == len(names[path]) and t.shape == params[path].shape, path


# ----------------------------------------------------------------------
# numerics on spawned gloo worlds
# ----------------------------------------------------------------------

CASES = [("llama3.2-1b", ()), ("phi3.5-moe-42b-a6.6b", ()), ("mamba2-2.7b", ())]
GQA = ("llama3.2-1b", (("n_heads", 4), ("n_kv_heads", 1)))
WORLDS = {(1, 1): CASES, (2, 1): CASES, (1, 2): CASES + [GQA], (2, 2): CASES}


def _ref_cfg(case):
    arch, over = case
    return ref_configs.get_config(arch).reduced(**dict(over))


@functools.lru_cache(maxsize=None)
def _case_inputs(case):
    """(reference parameters as numpy, batch) of a case."""
    cfg = _ref_cfg(case)
    tree = jax.tree.map(np.asarray, ref_models.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    w = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": w[:, :-1], "labels": w[:, 1:],
             "next": rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)}
    return tree, batch


def _flat(tree, case):
    """A reference-layout tree as one flat fp32 vector in the port's order."""
    p = lm_params_from_arrays(jax.tree.map(np.asarray, tree), _mesh_world.config(case),
                              device="cpu")
    return torch.cat([t.detach().flatten().float() for t in tree_leaves(param_tree(p))]).numpy()


@functools.lru_cache(maxsize=None)
def _ref_results(case):
    """The reference's unsharded results of a case."""
    cfg = _ref_cfg(case)
    tree, batch = _case_inputs(case)
    ctx = RefShardCtx()
    p = jax.tree.map(jnp.asarray, tree)
    tokens, labels = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    logits, _ = ref_models.forward_train(p, cfg, ctx, {"tokens": tokens})
    opt = ref_specs.make_optimizer(LR)
    step = jax.jit(ref_models.make_train_step(cfg, opt, ctx))
    p2, s2, m = step(p, opt.init(p), {"tokens": tokens, "labels": labels})
    pcfg = cfg.replace(use_pallas=True)
    cache = ref_models.init_cache(pcfg, B, S + _mesh_world.GEN)
    lp, cache = ref_models.forward_prefill(p, pcfg, ctx, {"tokens": tokens}, cache)
    ld, _ = ref_models.forward_decode(p, pcfg, ctx, jnp.asarray(batch["next"]), cache)
    return {"logits": np.asarray(logits), "metrics": {k: float(v) for k, v in m.items()},
            "params": _flat(p2, case), "nu": _flat(s2[1]["nu"], case),
            "prefill": np.asarray(lp), "decode": np.asarray(ld)}


@functools.lru_cache(maxsize=None)
def _port_results(case):
    """The port's unsharded results of a case."""
    cfg = _mesh_world.config(case)
    tree, batch = _case_inputs(case)
    tokens, labels = (torch.from_numpy(batch[k]) for k in ("tokens", "labels"))
    out = {}
    with torch.no_grad():
        out["logits"] = forward_train(lm_params_from_arrays(tree, cfg, device="cpu"), cfg,
                                      {"tokens": tokens})[0].numpy()
    params = lm_params_from_arrays(tree, cfg, device="cpu", trainable=True)
    opt = pt_specs.make_optimizer(LR)
    params, state, m = make_train_step(cfg, opt)(params, opt.init(param_tree(params)),
                                                 {"tokens": tokens, "labels": labels})
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = torch.cat([p.detach().flatten().float()
                               for p in tree_leaves(param_tree(params))]).numpy()
    out["nu"] = torch.cat([v.flatten() for v in tree_leaves(state[1]["nu"])]).numpy()
    pcfg = cfg.replace(use_pallas=True)
    pp = lm_params_from_arrays(tree, pcfg, device="cpu")
    cache = init_cache(pcfg, B, S + _mesh_world.GEN, device="cpu")
    lp, cache = make_prefill_step(pcfg)(pp, {"tokens": tokens}, cache)
    ld, _ = make_decode_step(pcfg)(pp, torch.from_numpy(batch["next"]), cache)
    out["prefill"], out["decode"] = lp.numpy(), ld.numpy()
    return out


@functools.lru_cache(maxsize=None)
def _worlds():
    """Rank 0's results of every world, the four worlds spawned at once.
    A world that fails or hangs past its deadline fails the tests."""
    ctx = torch.multiprocessing.get_context("spawn")
    dirs, procs = {}, {}
    with tempfile.TemporaryDirectory(prefix="mesh_worlds_") as top:
        for shape, cases in WORLDS.items():
            tmp = Path(top) / f"{shape[0]}x{shape[1]}"
            tmp.mkdir()
            # FSDP shards over the data axis: on and off where it has 2 ranks
            inputs = {case: (*_case_inputs(case), case != GQA and shape[0] > 1)
                      for case in cases}
            (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
            n = shape[0] * shape[1]
            procs[shape] = [ctx.Process(target=_mesh_world.rank_main,
                                        args=(str(tmp), r, n, shape), daemon=True)
                            for r in range(n)]
            dirs[shape] = tmp
        for ps in procs.values():
            for p in ps:
                p.start()
        for case in {c for cases in WORLDS.values() for c in cases}:
            _ref_results(case), _port_results(case)   # while the worlds run
        results = {}
        for shape, ps in procs.items():
            for p in ps:
                p.join(300)
            hung = [r for r, p in enumerate(ps) if p.is_alive()]
            for p in ps:
                if p.is_alive():
                    p.kill()
                    p.join()
            errors = {f.name: f.read_text() for f in dirs[shape].glob("rank*.err")}
            codes = [p.exitcode for p in ps]
            results[shape] = (pickle.loads((dirs[shape] / "out.pkl").read_bytes())
                              if not hung and codes == [0] * len(ps) else
                              f"world {shape}: hung ranks {hung}, exit codes {codes}, "
                              f"errors {errors}")
    return results


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _params_rule(got, want_params, want_nu, what):
    """``tests/test_torch_train.py``'s rule for the next parameters."""
    diff = np.abs(got - want_params)
    off = diff > TOL
    vhat = want_nu / (1 - 0.95)
    candidates = int(((np.sqrt(vhat) < NEAR_ZERO_GRAD) & (vhat > 0)).sum())
    if off.any():
        assert (np.sqrt(vhat[off]) < NEAR_ZERO_GRAD).all(), (what, float(diff.max()))
        assert float(diff.max()) <= 2 * LR, what
    assert int(off.sum()) <= AMPLIFIED_SHARE * candidates, (what, int(off.sum()), candidates)


@pytest.mark.parametrize("shape", sorted(WORLDS), ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_runs_match_the_unsharded_ones(shape):
    res = _worlds()[shape]
    assert not isinstance(res, str), res
    for (case, fsdp), got in res.items():
        for label, want in (("port", _port_results(case)), ("reference", _ref_results(case))):
            what = (shape, case, fsdp, label)
            for key in ("logits", "prefill", "decode"):
                _close(got[key], want[key], what + (key,))
            for key in ("loss", "ce", "aux"):
                w, g = want["metrics"][key], got["metrics"][key]
                assert abs(g - w) <= TOL * max(abs(w), 1e-30), what + (key, g, w)
            _params_rule(got["params"], want["params"], want["nu"], what + ("params",))
    assert {c for c, _ in res} == set(WORLDS[shape])
    assert {f for _, f in res} == ({False, True} if shape[0] > 1 else {False})
