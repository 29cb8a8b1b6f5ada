"""Dry-run: price every (arch x shape x mesh) step on the production
meshes without a card.

A port of ``repro.launch.dryrun``, with its flags, levers and record
keys. The reference lowers and compiles each step over 512 placeholder
XLA devices and reads XLA's cost analysis; the port runs the step
itself, on tensors that hold no data:

  * a world of 256 (``--mesh single``) or 512 ranks (``multi``, ``both``)
    on PyTorch's fake process group (backend ``"fake"``, whose
    collectives move nothing), started in this process; it refuses to run
    if a world is already up (``run_one``'s ``"debug"`` mesh is its first
    rank alone, 1 x 1);
  * parameters, optimizer state, batches and caches are ``meta``
    ``DTensor``s on the LM mesh (``launch.mesh``), placed by the
    logical-axis rules as ``launch.train`` places the real ones;
  * ``StepCounter``, a dispatch mode under which one step runs, counts
    per chip what rank 0 would do. ``DTensor`` lowers each op to the
    rank's local op and its collectives, and the counter sees those:
      - ``hlo_flops_per_chip``: the FLOPs of the matmul-class ops
        (``torch.utils.flop_counter``'s formulas: mm, bmm, convolution,
        attention) on the local shapes, forward and backward;
      - ``hlo_bytes_per_chip``: each local op's tensor operands read once
        and results written once (views and in-place writes aside), an
        unfused count, so an upper bound on what fused kernels move;
      - ``collectives``: each collective's result bytes by kind, as the
        reference's HLO parser counts them (``all-gather``: the gathered
        tensor; ``reduce-scatter``: the shard);
      - ``temp_size_in_bytes``: the peak of the local tensors the step
        makes and holds at once (the activations' peak); beside it
        ``argument_size_in_bytes``, the local shards of the step's
        inputs, and ``output_size_in_bytes``, of its outputs.
        ``peak_bytes_per_chip`` is their sum with the arguments, as in
        the reference.

There is no scan in the port: every layer runs, so there is no depth
probe or extrapolation (``raw_*`` equal the counted figures, and
``t_probe_s`` is 0). The blocked attention's and the SSD's chunk loops
are Python loops whose ops the counter sees, so
``roofline.analytic.inner_scan_cost`` is added nowhere. ``t_lower_s`` is
the seconds to build the meta state, ``t_compile_s`` the seconds of the
counted step (the port compiles nothing; ``generated_code_size_in_bytes``
is 0). The roofline prices the counts on the port's ``H100_SXM`` sheet
(``roofline/analysis.py``): they are estimates for one H100 SXM at its
specification, not timings.

Usage::

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results.json
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k \
      --fsdp --remat dots --tag fsdp_remat
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, mesh_chips
from repro_torch.models import (
    ShardCtx,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    model_specs,
    param_tree,
)
from repro_torch.models.config import active_param_count
from repro_torch.models.params import distribute_params, materialize
from repro_torch.obs.trace import stopwatch
from repro_torch.roofline import H100_SXM, roofline_report
from repro_torch.sharding.rules import ShardingRules, distribute
from repro_torch.utils.logging import get_logger
from repro_torch.utils.trees import tree_leaves

log = get_logger("dryrun")

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# the functional collectives DTensor lowers to, by the reference's HLO names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_WORLD = {"single": 256, "multi": 512}
MESH_NAMES = {"debug": "1x1", "single": "16x16", "multi": "2x16x16"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _bytes(t) -> int:
    """A tensor's bytes in device memory (what the step moves or holds)."""
    return t.numel() * t.element_size()


def local_nbytes(tree) -> int:
    """The bytes of each tensor leaf's local shard."""
    return sum(_bytes(_local(t)) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class StepCounter(TorchDispatchMode):
    """Counts per chip the work of what runs under it (module docstring):
    ``flops``, ``bytes``, ``collectives`` by kind and ``peak`` local bytes
    held at once. An op on ``DTensor``s is handed back to ``DTensor``
    (``NotImplemented``), whose local ops and collectives then come
    here, as ``CommDebugMode`` sees them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0 for k in _KINDS}
        self.live = 0
        self.peak = 0
        # DTensor infers an op's output shape by running it once on fresh
        # global-shape tensors (``empty_strided``) before the rank's local
        # op: what reads such a tensor is that inference, not the rank's
        # work, and is not counted
        self._fresh = set()     # ids of such tensors while they live

    def _free(self, n: int) -> None:
        self.live -= n

    def _mark_fresh(self, t) -> None:
        self._fresh.add(id(t))
        weakref.finalize(t, self._fresh.discard, id(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten.empty_strided.default:
            self._mark_fresh(out)
            return out
        ins = list(_tensors(list(args) + list(kwargs.values())))
        if any(id(t) in self._fresh for t in ins):
            for t in _tensors(out):
                self._mark_fresh(t)
            return out
        namespace, _, name = func._schema.name.partition("::")
        if namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.collectives[kind] += sum(_bytes(t) for t in _tensors(out))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if getattr(func, "is_view", False) or name.split(".")[0].endswith("_"):
            return out
        outs = list(_tensors(out))
        self.bytes += sum(_bytes(t) for t in ins)
        for t in outs:
            n = _bytes(t)
            self.bytes += n
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out

    def collectives_record(self) -> dict:
        rec = dict(self.collectives)
        rec["start_ops"] = 0
        rec["total"] = sum(self.collectives.values())
        return rec


def _meta_params(cfg, trainable: bool):
    return materialize(model_specs(cfg),
                       lambda _path, spec: torch.empty(spec.shape, dtype=spec.dtype,
                                                       device="meta"),
                       trainable=trainable)


def build_step(cfg, shape, mesh, rules):
    """(step, its arguments) for ``shape``'s kind on ``mesh`` (``None``:
    plain meta tensors, the unsharded step), every tensor ``meta``."""
    ctx = ShardCtx(mesh=mesh, rules=rules)

    def place(tree, logical):
        return tree if mesh is None else distribute(tree, mesh, logical, rules)

    params = _meta_params(cfg, trainable=shape.kind == "train")
    if mesh is not None:
        distribute_params(params, cfg, mesh, rules)
    if shape.kind == "train":
        opt = S.make_optimizer()
        opt_state = opt.init(param_tree(params))
        batch = place(*S.batch_specs(cfg, shape))
        return make_train_step(cfg, opt, ctx=ctx), (params, opt_state, batch)
    if shape.kind == "prefill":
        batch = place(*S.batch_specs(cfg, shape))
        cache, la = S.prefill_cache_specs(cfg, shape)
        cache = {"blocks": place(cache["blocks"], la["blocks"]), "step": 0}
        return make_prefill_step(cfg, ctx=ctx), (params, batch, cache)
    (tokens, cache), (tok_la, cache_la) = S.decode_specs(cfg, shape)
    # the cache holds seq_len - 1 tokens; this step writes the last slot
    cache = {"blocks": place(cache["blocks"], cache_la["blocks"]), "step": shape.seq_len - 1}
    return make_decode_step(cfg, ctx=ctx), (params, place(tokens, tok_la), cache)


def count_step(cfg, shape, mesh, rules) -> dict:
    """Run one step under ``StepCounter``; its counts and seconds."""
    elapsed = stopwatch()
    step, args = build_step(cfg, shape, mesh, rules)
    t_build = elapsed()
    arg_trees = [param_tree(args[0])] + list(args[1:])
    arg_bytes = sum(local_nbytes(t) for t in arg_trees)
    counter = StepCounter()
    elapsed = stopwatch()
    with counter:
        out = step(*args)
    out_trees = [param_tree(out[0]) if isinstance(out[0], torch.nn.Module) else out[0]]
    out_trees += list(out[1:])
    return {"t_build": t_build, "t_run": elapsed(), "flops": counter.flops,
            "bytes": counter.bytes, "collectives": counter.collectives_record(),
            "argument_size_in_bytes": arg_bytes, "output_size_in_bytes":
            sum(local_nbytes(t) for t in out_trees), "temp_size_in_bytes": counter.peak}


def model_flops(cfg, shape) -> float:
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def lever_rules(fsdp: bool, shard_kv_seq: bool = False, replicate_embed: bool = False,
                shard_attn_seq: bool = False, expert_parallel: bool = False) -> ShardingRules:
    """The reference's ``run_one`` rules for ``--fsdp`` and the levers."""
    rules = ShardingRules(fsdp=fsdp)
    updates = {}
    if shard_kv_seq:
        updates["kv_seq"] = "data"
    if replicate_embed:
        updates["vocab_in"] = None
    if shard_attn_seq:
        updates["attn_q_seq"] = "model"
    if expert_parallel:
        # experts claim the model axis; the expert ffn dim falls back to
        # replicated (used-axis dedup in logical_to_spec)
        updates["experts"] = "model"
    return rules.replace(table_updates=updates) if updates else rules


def run_one(arch: str, shape_name: str, mesh_kind: str, fsdp: bool, remat: str, tag: str,
            cast_grads: bool = False, moe_local: bool = False, block_skip: bool = False,
            shard_kv_seq: bool = False, replicate_embed: bool = False,
            shard_attn_seq: bool = False, expert_parallel: bool = False,
            layers: int = 0) -> dict:
    """One combination's record (the reference's keys). ``mesh_kind``:
    debug, single or multi, on the fake world ``start_fake_world``
    started; ``layers`` > 0 cuts the model to that depth."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH_NAMES[mesh_kind],
        "tag": tag,
        "fsdp": fsdp,
        "remat": remat,
        "levers": {
            "cast_grads": cast_grads,
            "moe_local": moe_local,
            "block_skip": block_skip,
            "shard_kv_seq": shard_kv_seq,
            "replicate_embed": replicate_embed,
            "shard_attn_seq": shard_attn_seq,
            "expert_parallel": expert_parallel,
        },
    }
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k requires sub-quadratic attention; "
                         f"{arch} is pure full-attention")
        return rec
    cfg = cfg.replace(remat=remat, cast_grads=cast_grads, moe_local_dispatch=moe_local,
                      attn_block_skip=block_skip, shard_attn_seq=shard_attn_seq)
    if layers:
        cfg = cfg.replace(n_layers=layers)
        rec["layers"] = layers
    if mesh_kind == "debug":
        mesh = make_debug_mesh(device="cpu")
    else:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device="cpu")
    chips = mesh_chips(mesh)
    rules = lever_rules(fsdp, shard_kv_seq, replicate_embed, shard_attn_seq, expert_parallel)
    try:
        c = count_step(cfg, shape, mesh, rules)
    except Exception as e:  # a combination that cannot run is a record, as in the reference
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    rec["status"] = "ok"
    rec["t_lower_s"] = round(c["t_build"], 2)
    rec["t_compile_s"] = round(c["t_run"], 2)
    for key in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"):
        rec[key] = int(c[key])
    rec["generated_code_size_in_bytes"] = 0
    rec["peak_bytes_per_chip"] = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    rec["raw_hlo_flops_per_chip"] = rec["hlo_flops_per_chip"] = float(c["flops"])
    rec["raw_hlo_bytes_per_chip"] = rec["hlo_bytes_per_chip"] = float(c["bytes"])
    rec["raw_collectives"] = dict(c["collectives"])
    rec["collectives"] = dict(c["collectives"])
    rec["t_probe_s"] = 0.0
    rl = roofline_report(flops_per_chip=c["flops"], bytes_per_chip=c["bytes"],
                         collective_bytes_per_chip=float(c["collectives"]["total"]),
                         hw=H100_SXM, model_flops=model_flops(cfg, shape), chips=chips)
    rec["roofline"] = {k: (v if isinstance(v, str) else float(v)) for k, v in rl.items()}
    return rec


def start_fake_world(ranks: int) -> None:
    """A world of ``ranks`` ranks on the fake process group, this process
    rank 0. Refuses when a world is already up: the dry-run must not
    run its fake collectives on a real one."""
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()!r} world of {dist.get_world_size()} ranks "
                           "is already up; run the dry-run in a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="full (arch x shape) matrix")
    ap.add_argument("--fsdp", action="store_true", help="shard params+opt over data axis")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--cast-grads", action="store_true", help="bf16 trunk activation grads")
    ap.add_argument("--moe-local", action="store_true", help="per-row MoE dispatch")
    ap.add_argument("--block-skip", action="store_true", help="skip masked attention KV blocks")
    ap.add_argument("--shard-kv-seq", action="store_true", help="shard KV cache along sequence")
    ap.add_argument("--replicate-embed", action="store_true",
                    help="replicate the input embedding table (kills lookup all-reduce)")
    ap.add_argument("--shard-attn-seq", action="store_true",
                    help="context-parallel attention over the model axis")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="shard MoE experts over the model axis (weights E/16 per chip)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every model to this many layers (0: the full depth)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=None, help="append results to this JSON file")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]
    start_fake_world(max(_WORLD[m] for m in meshes))

    results = []
    store = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            store = json.load(f)
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                key = f"{arch}|{shape_name}|{mesh_kind}|{args.tag}"
                if key in store and store[key].get("status") == "ok":
                    log.info("cached: %s", key)
                    results.append(store[key])
                    continue
                log.info("counting %s", key)
                rec = run_one(arch, shape_name, mesh_kind, args.fsdp, args.remat, args.tag,
                              cast_grads=args.cast_grads, moe_local=args.moe_local,
                              block_skip=args.block_skip, shard_kv_seq=args.shard_kv_seq,
                              replicate_embed=args.replicate_embed,
                              shard_attn_seq=args.shard_attn_seq,
                              expert_parallel=args.expert_parallel, layers=args.layers)
                log.info("%s -> %s (build %.1fs count %.1fs) %s", key, rec["status"],
                         rec.get("t_lower_s", 0), rec.get("t_compile_s", 0),
                         rec.get("roofline", {}).get("dominant",
                                                     rec.get("reason", rec.get("error", ""))))
                results.append(rec)
                store[key] = rec
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(store, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skipped")
    err = sum(1 for r in results if r["status"] == "error")
    print(f"\ndry-run complete: {ok} ok, {skip} skipped, {err} errors / {len(results)} combos")
    for r in results:
        if r["status"] == "error":
            print(f"  ERROR {r['arch']}|{r['shape']}|{r['mesh']}: {r['error'][:200]}")
    if err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
