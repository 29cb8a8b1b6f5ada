"""One-shot federated learning for the transformer families (the "deep
path"), a port of ``repro.core.deepfed``.

The paper's protocol applied to an LM: each of M clients trains a model
of the same family from its own init on its own tokens, uploads it once,
and the server ensembles the members' token distributions (the mean of
their probabilities) and distills them into one student on proxy tokens.

The reference stacks the members' parameters on a leading axis and
trains them with ``jax.jit(jax.vmap(train_one))``. The port keeps a list
of M parameter modules (``models.init_params``' layout, built with
``trainable=True``) and trains them one after another with
``models.make_train_step``. A loop, not ``torch.func.vmap``: one member's
step at full width keeps the card busy on its own, and a member's AdamW
moments (fp32, twice its parameters: ~12 GB for llama3.2-1b) are freed
before the next member starts, so M of them are never held together.

The teacher (``member_log_probs`` / ``ensemble_log_probs``) and the
evaluation run ``forward_train`` under ``torch.no_grad()``. The reference
never differentiates the teacher either, and here it is required: the
members are trainable, and the CUDA flash kernel (``use_pallas``) has no
backward, so its wrapper refuses inputs that require grad under grad
mode.

Every family runs (a MoE member's or student's router aux loss enters
its step's loss, as in the reference). The round feeds tokens alone, as
the reference's does: the VLM runs without its patch prefix, and the
encoder-decoder, which needs frames, raises ``KeyError`` naming them
(the reference raises ``KeyError: 'frames'``).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from repro_torch.core.distill import DISTILL_LOSSES
from repro_torch.models import ShardCtx, forward_train, init_params, make_train_step, param_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import optimizer_step
from repro_torch.models.params import check_buildable
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.utils.device import resolve_device
from repro_torch.utils.seeds import derive_device_seed
from repro_torch.utils.trees import tree_size_bytes


def stacked_init(cfg: ModelConfig, n_members: int, seed: int = 0,
                 device="cuda") -> List[torch.nn.Module]:
    """M trainable members on ``device``; member m is ``init_params`` at
    ``derive_device_seed(seed, m)``. The draws come from a
    ``torch.Generator`` and are not the reference's (``jax.random``);
    carry reference members across with ``convert.lm_stacked_from_arrays``."""
    dev = resolve_device(device)
    return [init_params(cfg, seed=derive_device_seed(seed, m), device=dev, trainable=True)
            for m in range(n_members)]


def _optimizer(lr: float):
    return chain(clip_by_global_norm(1.0), adamw(lr))


def _window(w, device) -> Dict[str, torch.Tensor]:
    t = torch.as_tensor(w, device=device).long()
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def make_local_train(cfg: ModelConfig, lr: float = 1e-3, ctx: ShardCtx = ShardCtx()):
    """``train_many(members, windows) -> (members, losses)``: member m
    takes ``steps`` steps of clip-1.0 + AdamW(lr) from a fresh optimizer
    state on ``windows[m]`` ((M, steps, B, S+1) int tokens), in place.
    ``losses`` is (M, steps) fp32 on the members' device. On a mesh
    (``ctx``) each member's parameters are ``DTensor``s on it."""
    opt = _optimizer(lr)
    step_fn = make_train_step(cfg, opt, ctx=ctx)

    def train_many(members, windows):
        if len(windows) != len(members):
            raise ValueError(f"{len(members)} members, windows for {len(windows)}")
        losses = []
        for params, member_windows in zip(members, windows):
            opt_state = opt.init(param_tree(params))
            member_losses = []
            for w in member_windows:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     _window(w, params.embed.device))
                member_losses.append(metrics["loss"])
            del opt_state
            losses.append(torch.stack(member_losses))
        return members, torch.stack(losses)

    return train_many


@torch.no_grad()
def member_log_probs(members, cfg: ModelConfig, tokens,
                     ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """(M, B, S, V) fp32 log-probs of each member on tokens (B, S)."""
    out = []
    with ctx.scope():
        for params in members:
            logits, _ = forward_train(params, cfg, {"tokens": tokens}, ctx=ctx)
            out.append(torch.log_softmax(logits.float(), dim=-1))
            del logits
        return torch.stack(out)


@torch.no_grad()
def ensemble_log_probs(members, cfg: ModelConfig, tokens,
                       ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """Log of the mean member distribution (the paper's mean-prediction
    ensemble in token-distribution space), (B, S, V) fp32."""
    lp = member_log_probs(members, cfg, tokens, ctx)
    with ctx.scope():
        return torch.logsumexp(lp, dim=0) - math.log(lp.shape[0])


@torch.no_grad()
def ensemble_eval_loss(members, cfg: ModelConfig, windows) -> float:
    """Mean next-token NLL of the ensemble over (N, B, S+1) windows."""
    total, count = 0.0, 0
    for w in windows:
        batch = _window(w, members[0].embed.device)
        lp = ensemble_log_probs(members, cfg, batch["tokens"])
        gold = torch.gather(lp, -1, batch["labels"][..., None])[..., 0]
        total += float(-gold.mean())
        count += 1
    return total / max(count, 1)


def make_distill_step(student_cfg: ModelConfig, optimizer, loss_kind: str = "kl",
                      temperature: float = 2.0):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "distill"})``: the student against precomputed teacher log-probs,
    ``batch = {tokens (B, S), labels (B, S), teacher_logits (B, S, V)}``;
    the loss is the ``DISTILL_LOSSES[loss_kind]`` term (``kl`` at
    ``temperature``) plus ``router_aux_coef * aux``."""
    check_buildable(student_cfg)
    loss_fn_t = DISTILL_LOSSES[loss_kind]

    def loss_fn(params, batch):
        logits, aux = forward_train(params, student_cfg, batch)
        if loss_kind == "kl":
            dl = loss_fn_t(logits, batch["teacher_logits"], temperature)
        else:
            dl = loss_fn_t(logits, batch["teacher_logits"])
        loss = dl + student_cfg.router_aux_coef * aux
        return loss, {"loss": loss, "distill": dl}

    def step(params, opt_state, batch):
        return optimizer_step(params, opt_state, optimizer, lambda p: loss_fn(p, batch))

    return step


def distill_to_student(student_cfg: ModelConfig, teacher_cfg: ModelConfig, members,
                       proxy_windows, steps: int, lr: float = 1e-3, loss_kind: str = "kl",
                       seed: int = 0, device="cuda"):
    """Server-side distillation of the member ensemble into one student:
    ``init_params(student_cfg, seed, trainable=True)`` on ``device``, then
    ``steps`` distill steps of clip-1.0 + AdamW(lr), step i on proxy window
    ``i % N`` of (N, B, S+1) against ``ensemble_log_probs`` of the members
    under ``teacher_cfg``. Returns (student, [loss of each step])."""
    dev = resolve_device(device)
    check_buildable(teacher_cfg)
    params = init_params(student_cfg, seed=seed, device=dev, trainable=True)
    opt = _optimizer(lr)
    opt_state = opt.init(param_tree(params))
    step_fn = make_distill_step(student_cfg, opt, loss_kind)
    losses = []
    n = len(proxy_windows)
    for i in range(steps):
        batch = _window(proxy_windows[i % n], dev)
        batch["teacher_logits"] = ensemble_log_probs(members, teacher_cfg, batch["tokens"])
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        del batch
        losses.append(float(metrics["loss"]))
    return params, losses


# ----------------------------------------------------------------------
# communication accounting (protocol bytes, not collectives)
# ----------------------------------------------------------------------

def _nbytes(params) -> int:
    return tree_size_bytes(param_tree(params))


def one_shot_comm_bytes(members, n_selected: int, student_params=None,
                        n_devices: int = 0) -> Dict[str, float]:
    """One upload of a member from each of ``n_selected`` clients, and
    the student's download to ``n_devices`` devices when given."""
    out = {"upload": float(_nbytes(members[0]) * n_selected), "rounds": 1.0}
    if student_params is not None and n_devices:
        out["download"] = float(_nbytes(student_params) * n_devices)
    return out


def fedavg_comm_bytes(params, rounds: int, clients_per_round: int) -> Dict[str, float]:
    """FedAvg's bytes for the same model: a download and an upload a
    client a round."""
    b = _nbytes(params)
    return {"total": float(2.0 * b * rounds * clients_per_round), "rounds": float(rounds)}
