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

Only ``--mesh none`` runs: the sharded tier is ROADMAP queue 1 item 15.
``--fsdp`` without a mesh has no effect, as in the reference. The
families the port does not build yet raise (``check_buildable``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_federated_lm_data, token_batches
from repro_torch.models import init_params, make_train_step, param_tree
from repro_torch.obs.trace import current_tracer, stopwatch
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("train")


def make_optimizer(lr: float = 3e-4):
    """``repro.launch.specs.make_optimizer``: clip at global norm 1.0, then
    AdamW with weight decay 0.1."""
    return chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=0.1))


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

    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh}: the sharded tier is not ported yet "
                                  "(ROADMAP queue 1 item 15)")
    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(remat=args.remat)

    params = init_params(cfg, seed=args.seed, device=dev, trainable=True)
    opt = make_optimizer(args.lr)
    opt_state = opt.init(param_tree(params))
    step_fn = make_train_step(cfg, opt)

    # pooled synthetic federated LM data (per-client Markov sources)
    clients = make_federated_lm_data(8, cfg.vocab, 20_000, seed=args.seed)
    stream = token_batches(np.concatenate(clients), args.batch, args.seq, seed=args.seed)

    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    tracer = current_tracer()
    elapsed = stopwatch()
    for step in range(args.steps):
        window = torch.from_numpy(next(stream)).to(dev)
        batch = {"tokens": window[:, :-1], "labels": window[:, 1:]}
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
