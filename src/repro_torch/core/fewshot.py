"""Few-shot federated learning, the paper's future-work item (3):

    "improving accuracy by moving from one-shot to few-shot federated
     learning."

A port of ``repro.core.fewshot``. Round r: the server broadcasts the
current student to the clients; the clients resume local training from
it (round 0 is a fresh random init, exactly one-shot FL); the server
ensembles the returned members and distills a new student on proxy data.
R rounds cost R x (k uploads + m downloads); R = 1 is the paper's
protocol.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List

from repro_torch.core import deepfed
from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class FewShotResult:
    student_params: object
    round_nll: List[float]  # student NLL after each round
    comm_bytes_per_round: float
    rounds: int


def run_few_shot(
    cfg: ModelConfig,
    client_windows,  # (M, steps, B, S+1)
    proxy_windows,  # (N, B, S+1)
    eval_windows,  # (N, B, S+1)
    rounds: int = 3,
    lr: float = 3e-3,
    distill_steps: int = 30,
    loss_kind: str = "kl",
    seed: int = 0,
    windows_per_round: int = 0,  # 0 = reuse all windows every round;
    # else round r trains on slice [r*wpr : (r+1)*wpr] (fresh device data)
    device="cuda",
) -> FewShotResult:
    dev = resolve_device(device)
    M = client_windows.shape[0]
    train = deepfed.make_local_train(cfg, lr=lr)
    members = deepfed.stacked_init(cfg, M, seed, device=dev)  # round 0: fresh inits
    student = None
    nlls = []
    for r in range(rounds):
        if student is not None:
            # broadcast: every client resumes from the distilled student
            members = [copy.deepcopy(student) for _ in range(M)]
        if windows_per_round:
            wins_r = client_windows[:, r * windows_per_round:(r + 1) * windows_per_round]
        else:
            wins_r = client_windows
        members, _ = train(members, wins_r)
        student, _ = deepfed.distill_to_student(
            cfg, cfg, members, proxy_windows, steps=distill_steps, lr=lr,
            loss_kind=loss_kind, seed=seed + r, device=dev)
        nlls.append(float(deepfed.ensemble_eval_loss([student], cfg, eval_windows)))
    comm = deepfed.one_shot_comm_bytes(members, M, student_params=student, n_devices=M)
    return FewShotResult(
        student_params=student,
        round_nll=nlls,
        comm_bytes_per_round=comm["upload"] + comm.get("download", 0.0),  # up + down a round
        rounds=rounds,
    )
