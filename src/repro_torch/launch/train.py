"""Training driver: real steps on real data, on the card.

A port of ``repro.launch.train`` with the same flags. It runs on the
card unless the caller passes ``device="cpu"``::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 8 --batch 4 --seq 1024

(``main([...], device="cpu")`` with ``--reduced`` runs the smoke-scale
model on the CPU, as the tests do.) The optimizer is the reference's
``make_optimizer``: global-norm clipping at 1.0, then AdamW with weight
decay 0.1. Data are the pooled synthetic federated LM tokens
(``make_federated_lm_data``, ``token_batches``). Each step is a
``train.step`` span on the current tracer, followed by a
``train.metrics`` instant with its loss, ce and aux; the loss is read
back every step, so a span ends when the step's work on the card is
done.

``--mesh`` picks the LM mesh, as in the reference: ``debug`` is
``make_debug_mesh()`` (1 x 1; on one card a one-rank world), ``single``
and ``multi`` the 16 x 16 and 2 x 16 x 16 production meshes, which need
a world of 256 or 512 ranks (``torchrun``) and raise naming it
otherwise. On a mesh the parameters are ``DTensor``s placed by the
logical-axis rules (``--fsdp`` adds the data axis to each weight's
``embed`` dim), the AdamW moments take their placements, each batch is
sharded over the data axis, and the step runs on the mesh
(``make_train_step(ctx=ShardCtx(mesh, rules))``). ``--fsdp`` without a
mesh has no effect, as in the reference. Every family trains (the MoE's router aux loss in the loss); the VLM's batches
carry zero patches and the encoder-decoder's zero frames, as the
reference's do.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_federated_lm_data, token_batches
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.specs import make_optimizer
from repro_torch.models import ShardCtx, init_params, make_train_step, param_tree
from repro_torch.models.params import distribute_params
from repro_torch.obs.trace import current_tracer, stopwatch
from repro_torch.sharding.rules import ShardingRules, distribute
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("train")

__all__ = ["build_mesh", "main", "make_optimizer"]

# each batch tensor's logical axes
_BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "patches": ("batch", None, "embed"), "frames": ("batch", None, "embed")}


def build_mesh(kind: str, device="cuda"):
    if kind == "none":
        return None
    if kind == "debug":
        return make_debug_mesh(device=device)
    return make_production_mesh(multi_pod=(kind == "multi"), device=device)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="none", choices=["none", "debug", "single", "multi"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(remat=args.remat)
    mesh = build_mesh(args.mesh, dev)
    rules = ShardingRules(fsdp=args.fsdp)
    ctx = ShardCtx(mesh=mesh, rules=rules)

    params = init_params(cfg, seed=args.seed, device=dev, trainable=True)
    if mesh is not None:
        distribute_params(params, cfg, mesh, rules)
    opt = make_optimizer(args.lr)
    opt_state = opt.init(param_tree(params))   # the moments take the parameters' placements
    step_fn = make_train_step(cfg, opt, ctx=ctx)

    # pooled synthetic federated LM data (per-client Markov sources)
    clients = make_federated_lm_data(8, cfg.vocab, 20_000, seed=args.seed)
    stream = token_batches(np.concatenate(clients), args.batch, args.seq, seed=args.seed)
    extra = {}
    if cfg.n_patches:
        extra["patches"] = torch.zeros((args.batch, cfg.n_patches, cfg.d_model), device=dev)
    if cfg.is_encdec:
        extra["frames"] = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model), device=dev)

    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    tracer = current_tracer()
    elapsed = stopwatch()
    for step in range(args.steps):
        window = torch.from_numpy(next(stream)).to(dev)
        batch = {"tokens": window[:, :-1], "labels": window[:, 1:], **extra}
        if mesh is not None:
            batch = distribute(batch, mesh, {k: _BATCH_AXES[k] for k in batch}, rules)
        with tracer.span("train.step", cat="train", step=step):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
        tracer.instant("train.metrics", cat="train", step=step, loss=loss,
                       ce=float(metrics["ce"]), aux=float(metrics["aux"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info(
                "step %4d  loss %.4f  ce %.4f  aux %.4f  (%.2f s/step)",
                step, loss, float(metrics["ce"]), float(metrics["aux"]),
                elapsed() / (step + 1),
            )
        if ckpt and (step + 1) % 50 == 0:
            ckpt.save(step + 1, {"params": param_tree(params)})
    if ckpt:
        ckpt.save(args.steps, {"params": param_tree(params)})
    print(f"final loss: {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
