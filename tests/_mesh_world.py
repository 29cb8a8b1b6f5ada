"""The rank side of ``tests/test_torch_mesh.py``'s spawned gloo worlds.

Kept apart from the test file so a spawned rank imports torch and the
port, not JAX. Each rank rebuilds the reduced models from the
reference's parameters (``convert.lm_params_from_arrays``), places them
on a (data, model) LM mesh with and without FSDP, runs the forward, one
train step, a prefill and a decode step with ``use_pallas`` (the plain
flash version on the CPU, through ``_attend``'s ``local_map``), and
returns each result whole (``full_tensor``) for the test to hold
against the unsharded runs.
"""
from __future__ import annotations

import pickle
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as pt_configs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import make_optimizer
from repro_torch.models import (
    ShardCtx,
    cache_logical_axes,
    forward_train,
    init_cache,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    param_tree,
)
from repro_torch.models.params import distribute_params
from repro_torch.sharding.rules import ShardingRules, distribute
from repro_torch.utils.trees import tree_leaves

LR = 1e-3
GEN = 4     # kv_len beyond the prompt


def config(case):
    """(arch, config overrides) -> the port's reduced config."""
    arch, over = case
    return pt_configs.get_config(arch).reduced(**dict(over))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def run_case(case, tree, batch, mesh, fsdp):
    """The sharded results of one case on ``mesh``: logits, the step's
    metrics, next parameters and second moments (flat, fp32), prefill
    and decode logits."""
    cfg = config(case)
    rules = ShardingRules(fsdp=fsdp)
    ctx = ShardCtx(mesh, rules)
    tokens, labels = (torch.from_numpy(batch[k]) for k in ("tokens", "labels"))
    B, S = tokens.shape
    out = {}
    params = distribute_params(lm_params_from_arrays(tree, cfg, device="cpu"), cfg, mesh, rules)
    with torch.no_grad():
        logits, _ = forward_train(params, cfg, {"tokens": tokens}, ctx=ctx)
    out["logits"] = _whole(logits).numpy()

    params = distribute_params(lm_params_from_arrays(tree, cfg, device="cpu", trainable=True),
                               cfg, mesh, rules)
    opt = make_optimizer(LR)
    state = opt.init(param_tree(params))
    params, state, m = make_train_step(cfg, opt, ctx=ctx)(params, state,
                                                           {"tokens": tokens, "labels": labels})
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = torch.cat([_whole(p.detach()).flatten().float()
                               for p in tree_leaves(param_tree(params))]).numpy()
    out["nu"] = torch.cat([_whole(v).flatten() for v in tree_leaves(state[1]["nu"])]).numpy()

    pcfg = cfg.replace(use_pallas=True)
    params = distribute_params(lm_params_from_arrays(tree, pcfg, device="cpu"), pcfg, mesh, rules)
    cache = init_cache(pcfg, B, S + GEN, device="cpu")
    cache["blocks"] = distribute(cache["blocks"], mesh,
                                 cache_logical_axes(pcfg, B, S + GEN)["blocks"], rules)
    lp, cache = make_prefill_step(pcfg, ctx=ctx)(params, {"tokens": tokens}, cache)
    ld, cache = make_decode_step(pcfg, ctx=ctx)(params, torch.from_numpy(batch["next"]), cache)
    out["prefill"], out["decode"] = _whole(lp).numpy(), _whole(ld).numpy()
    return out


def rank_main(tmp, rank, world, shape):
    """A spawned rank: join the gloo world, run every case of the input
    file on a ``shape`` mesh with FSDP off and on, write rank 0's results
    (or the traceback) under ``tmp``."""
    tmp = Path(tmp)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=240))
        inputs = pickle.loads((tmp / "inputs.pkl").read_bytes())
        mesh = make_debug_mesh(*shape, device="cpu")
        res = {(case, fsdp): run_case(case, tree, batch, mesh, fsdp)
               for case, (tree, batch, fsdp_too) in inputs.items()
               for fsdp in ((False, True) if fsdp_too else (False,))}
        if rank == 0:
            (tmp / "out.pkl").write_bytes(pickle.dumps(res))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
