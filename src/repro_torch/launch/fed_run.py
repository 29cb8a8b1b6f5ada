"""One-shot federated learning driver, a port of ``repro.launch.fed_run``
with the same flags, JSON keys and ``--out`` file. It runs on the card
unless the caller passes ``device="cpu"``.

Two modes share this entry point:

``--mode lm`` (default): the transformer instantiation (``core.deepfed``).
M clients train the reduced model of ``--arch`` (``get_config(arch)
.reduced()``: fp32, head dim 32) to completion one after another, the
server ensembles their predictions, then distills them into a student in
one round::

  PYTHONPATH=src python -m repro_torch.launch.fed_run --arch llama3.2-1b \\
      --clients 4 --local-steps 30 --distill-steps 30

``--mode sim``: the population-scale SVM round (``sim.run_population``)
on any registered scenario, with the engines (``bucketed``, ``loop``,
``sharded`` with ``--mesh``, ``streamed`` with ``--chunk-devices``), the
wire codecs (``--codec``),
the per-selection byte cap (``--budget-bytes``), server-side
distillation (``--distill-*``, ``--proxy-source``, ``--student-codec``),
the aggregators (``--aggregator``) and, with ``--serve-fleet``, the
round's artifact deployed behind the multi-tenant fleet
(``fleet.serve_round_artifact``; its SLO metrics under ``"fleet"``)::

  PYTHONPATH=src python -m repro_torch.launch.fed_run --mode sim \\
      --scenario dirichlet --devices 512 --k 10 50

``--trace PATH`` writes a Chrome trace-event JSON of the run (the fleet's
simulated-ms events on their own process track, pid 2).

``--engine sharded`` lays the bucket groups over the ranks of a
``torch.distributed`` world (``--mesh N`` caps the mesh; results are
bitwise the bucketed tier's). Every rank runs the whole round; rank 0
alone prints the JSON and writes ``--out`` and ``--trace``. Two ranks,
one card each::

  torchrun --nproc_per_node 2 -m repro_torch.launch.fed_run --mode sim \\
      --scenario dirichlet --devices 4096 --engine sharded --mesh 2

``--mode lm`` ignores ``--engine`` and ``--mesh`` and feeds tokens
alone, as the reference does: the VLM runs without patches, and
``whisper-base``, whose encoder needs frames, raises ``KeyError`` naming
them (the reference raises ``KeyError: 'frames'``).
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import deepfed
from repro_torch.data import make_federated_lm_data, token_batches
from repro_torch.obs import (Tracer, current_tracer, default_registry, envelope, stopwatch,
                             use_tracer)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("fed_run")


def _writes_output() -> bool:
    """Rank 0 of a ``torch.distributed`` world, or a process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def run_sim(args, device) -> dict:
    """Scenario-driven population round on ``device``."""
    from repro_torch.sim import PopulationConfig, list_scenarios, run_population

    if args.scenario == "list":
        for name, doc in list_scenarios().items():
            print(f"{name:16s} {doc}")
        return {}
    params = dict(kv.split("=", 1) for kv in args.scenario_param)
    params = {k: float(v) if v.replace(".", "", 1).isdigit() else v
              for k, v in params.items()}
    distill = None
    if args.distill_proxy > 0:
        from repro_torch.distill import DistillConfig

        distill = DistillConfig(
            proxy_size=args.distill_proxy,
            solver=args.distill_solver,
            proxy=args.proxy_source,
            codec=args.student_codec,
        )
    cfg = PopulationConfig(
        scenario=args.scenario,
        n_devices=args.devices,
        seed=args.seed,
        mean_samples=args.mean_samples,
        ks=tuple(args.k),
        engine=args.engine,
        mesh_shards=args.mesh,
        chunk_devices=args.chunk_devices,
        scenario_params=params,
        codec=args.codec,
        budget_bytes=args.budget_bytes,
        aggregator=args.aggregator,
        distill=distill,
    )

    def progress(u):
        log.info("bucket %4d: +%3d devices (%d/%d done)",
                 u.bucket, len(u.outcomes), u.done, u.total)

    # the shard count actually built (make_sim_mesh caps the request at
    # the world size and floors it to a power of two), not the flag
    mesh_used = None
    if args.engine == "sharded":
        from repro_torch.sim import make_shard_ctx

        mesh_used = make_shard_ctx(args.mesh, device=device).n_shards

    # --trace: one wall-clock tracer for the round, one explicit-ts
    # sub-tracer (pid 2, its own process track) for the fleet's
    # simulated-ms events, merged into one trace file
    tracer = fleet_tracer = None
    stack = contextlib.ExitStack()
    if args.trace:
        tracer = Tracer(pid=1, process_name="fed_run")
        fleet_tracer = Tracer(pid=2, process_name="fleet (simulated ms)")
        stack.enter_context(use_tracer(tracer))

    with stack:
        report = run_population(cfg, on_update=progress, device=device)
    out = {
        "mode": "sim",
        "scenario": report.scenario,
        "engine": args.engine,
        "mesh": mesh_used,
        "mesh_requested": args.mesh,
        "devices": report.n_devices,
        "available": report.n_available,
        "eligible": report.n_eligible,
        "mean_local_auc": report.mean_local_auc,
        "mean_val_auc": report.mean_val_auc,
        "ensemble_auc": {s: dict(v) for s, v in report.ensemble_auc.items()},
        "best": report.best,
        "train_seconds": report.train_seconds,
        "devices_per_second": report.devices_per_second,
        "codec": report.codec,
        "budget_bytes": report.budget_bytes,
        "aggregator": report.aggregator,
        "comm": report.comm,
    }
    if report.student is not None:
        out["student_codec"] = report.student_codec
        out["distill_solver"] = args.distill_solver
        out["proxy_source"] = args.proxy_source
    if report.time_to_aggregate:
        out["time_to_aggregate"] = {
            s: dict(v) for s, v in report.time_to_aggregate.items()
        }
    if args.serve_fleet:
        # deploy what the round produced: the distilled student when
        # distillation ran, otherwise the chosen aggregator's server
        # scorer (the best selected cell)
        artifact = report.student if report.student is not None \
            else report.server_scorer
        if artifact is None:
            raise SystemExit(
                "--serve-fleet deploys the round's artifact (distilled "
                "student or aggregated server scorer), but the round "
                "produced neither: no selection cell had any members"
            )
        from repro_torch.fleet import serve_round_artifact

        # wire -> checkpoint -> fleet, measured under load in simulated
        # time (this adds metrics, not wall-clock minutes)
        out["fleet"] = serve_round_artifact(
            artifact,
            seed=args.seed,
            horizon_ms=args.fleet_horizon_ms,
            load=args.fleet_load,
            tracer=fleet_tracer,
            device=device,
        )
        out["fleet"]["handoff"]["artifact"] = (
            "student" if report.student is not None else "server_scorer"
        )
    # the schema-versioned observability envelope: registry counters
    # (engine chunks/groups/devices) and the round's exact comm ledger
    out["obs"] = envelope(
        default_registry(),
        comm=report.ledger,
        fleet=out.get("fleet"),
    )
    if not _writes_output():
        return out
    if tracer is not None:
        tracer.merge(fleet_tracer)
        if tracer.export(args.trace):
            log.info("trace written to %s (open at https://ui.perfetto.dev)",
                     args.trace)
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


def run_lm(args, device) -> dict:
    """The deep one-shot round on the reduced ``--arch`` on ``device``."""
    cfg = get_config(args.arch).reduced()
    M, B, S = args.clients, args.batch, args.seq
    log.info("one-shot FL: %d clients of reduced %s", M, args.arch)

    tracer = Tracer(process_name="fed_run") if args.trace else None
    stack = contextlib.ExitStack()
    if tracer is not None:
        stack.enter_context(use_tracer(tracer))
    with stack:
        clients = make_federated_lm_data(M, cfg.vocab, args.tokens_per_client, seed=args.seed)
        wins = []
        for c in clients:
            it = token_batches(c, B, S, seed=args.seed + 1)
            wins.append(np.stack([next(it) for _ in range(args.local_steps)]))
        wins = torch.from_numpy(np.stack(wins)).to(device)  # (M, steps, B, S+1)

        # --- phase 1: local training to completion (one client at a time) ---
        members = deepfed.stacked_init(cfg, M, args.seed, device=device)
        train = deepfed.make_local_train(cfg, lr=args.lr)
        elapsed = stopwatch()
        with current_tracer().span("lm.local_train", cat="round", clients=M):
            members, losses = train(members, wins)
            first, last = float(losses[:, 0].mean()), float(losses[:, -1].mean())
        t_local = elapsed()
        log.info("local training: loss %.3f -> %.3f in %.1fs (%d clients)",
                 first, last, t_local, M)

        # --- held-out eval data: a mix of every client's distribution ---
        test = np.stack([next(token_batches(clients[i % M], B, S, seed=args.seed + 7))
                         for i in range(2 * M)])
        single_nll = deepfed.ensemble_eval_loss(members[:1], cfg, test)
        ens_nll = deepfed.ensemble_eval_loss(members, cfg, test)
        log.info("NLL: best-effort single member %.4f | %d-member ensemble %.4f",
                 single_nll, M, ens_nll)

        # --- phase 2: the single communication round + server distillation ---
        proxy = np.stack([next(token_batches(clients[i % M], B, S, seed=args.seed + 13))
                          for i in range(M)])
        elapsed = stopwatch()
        with current_tracer().span("lm.distill", cat="distill", steps=args.distill_steps):
            student, dlosses = deepfed.distill_to_student(
                cfg, cfg, members, proxy, steps=args.distill_steps, lr=args.lr,
                loss_kind=args.distill_loss, seed=args.seed, device=device)
        t_distill = elapsed()
        student_nll = deepfed.ensemble_eval_loss([student], cfg, test)
        log.info("distilled student NLL %.4f (distill loss %.4f -> %.4f, %.1fs)",
                 student_nll, dlosses[0], dlosses[-1], t_distill)

    comm = deepfed.one_shot_comm_bytes(members, n_selected=M, student_params=student,
                                       n_devices=M)
    fedavg_equiv = deepfed.fedavg_comm_bytes(student, rounds=10, clients_per_round=M)
    report = {
        "arch": args.arch,
        "clients": M,
        "single_member_nll": float(single_nll),
        "ensemble_nll": float(ens_nll),
        "student_nll": float(student_nll),
        "one_shot_comm_bytes": comm,
        "fedavg10_comm_bytes": fedavg_equiv,
        "comm_reduction_vs_fedavg10": fedavg_equiv["total"] / max(comm["upload"], 1.0),
    }
    if tracer is not None and tracer.export(args.trace):
        log.info("trace written to %s", args.trace)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="lm", choices=["lm", "sim"])
    ap.add_argument("--scenario", default="dirichlet",
                    help="sim mode: registered scenario name, or 'list'")
    ap.add_argument("--devices", type=int, default=256, help="sim mode")
    ap.add_argument("--mean-samples", type=int, default=80, help="sim mode")
    ap.add_argument("--k", type=int, nargs="+", default=[10], help="sim mode")
    ap.add_argument("--engine", default="bucketed",
                    choices=["bucketed", "sharded", "loop", "streamed"],
                    help="sim mode: bucketed (one device) | sharded "
                         "(mesh-parallel over the torch.distributed world) | "
                         "loop (sequential oracle) | streamed (lazy "
                         "chunked federation, O(chunk) host memory)")
    ap.add_argument("--mesh", type=int, default=None,
                    help="sim mode, --engine sharded: cap the sim mesh "
                         "at this many ranks (default: the whole world)")
    ap.add_argument("--chunk-devices", type=int, default=1024,
                    help="sim mode, --engine streamed: devices resident "
                         "at once (peak host memory is O(this))")
    ap.add_argument("--scenario-param", action="append", default=[],
                    metavar="KEY=VALUE", help="sim mode: e.g. alpha=0.1")
    ap.add_argument("--codec", default="fp32",
                    help="sim mode: wire codec for model uploads "
                         "(fp32 | fp16 | int8 | topk[:ratio])")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="sim mode: upload byte budget per selection "
                         "(strategy-rank greedy knapsack over encoded sizes)")
    ap.add_argument("--aggregator", default="mean",
                    help="sim mode: server aggregation strategy from the "
                         "repro_torch.agg registry (mean | fisher | "
                         "reweight[:T] | feature_stats); extras ride "
                         "the ledger under kind=agg_extra")
    ap.add_argument("--distill-proxy", type=int, default=0,
                    help="sim mode: distill the best ensemble on this "
                         "many proxy points (0 disables)")
    ap.add_argument("--distill-solver", default="auto",
                    help="sim mode: distill solver "
                         "(dense | cg | nystrom | auto)")
    ap.add_argument("--proxy-source", default="validation",
                    help="sim mode: proxy registry source "
                         "(validation | public | gaussian | scenario)")
    ap.add_argument("--student-codec", default=None,
                    help="sim mode: student download codec "
                         "(default: the round's --codec)")
    ap.add_argument("--serve-fleet", action="store_true",
                    help="sim mode: after the round, deploy its artifact "
                         "behind the multi-tenant serve fleet "
                         "(repro_torch.fleet) and report SLO metrics under "
                         "load: the distilled student when --distill-proxy "
                         "ran, otherwise the chosen --aggregator's server scorer")
    ap.add_argument("--fleet-horizon-ms", type=float, default=250.0,
                    help="--serve-fleet: simulated traffic window (ms)")
    ap.add_argument("--fleet-load", type=float, default=1.0,
                    help="--serve-fleet: offered load as a multiple of "
                         "the fleet's nominal scoring capacity")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=30)
    ap.add_argument("--distill-steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--tokens-per-client", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--distill-loss", default="kl", choices=["kl", "l2"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(spans from engine/round/comm/distill/fleet; "
                         "open at https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    if args.mode == "sim":
        return run_sim(args, dev)
    return run_lm(args, dev)


if __name__ == "__main__":
    main()
    if dist.is_initialized():   # a world the sharded engine started ends with the run
        dist.destroy_process_group()
