"""FedAvg — the iterative multi-round baseline the paper positions
against [McMahan et al. 2017].

Port of ``repro.core.fedavg``: generic over any parameter tree
(``utils.trees``); the caller's ``local_train_fn`` runs wherever it puts
its tensors. The client draw (numpy ``default_rng(seed)``) and the price
(``2 * model_bytes`` a chosen client a round: down, then up) are the
reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.core.averaging import average_params
from repro_torch.utils.trees import tree_size_bytes


@dataclasses.dataclass
class FedAvgResult:
    params: object
    rounds: int
    comm_bytes: float  # total protocol bytes (up + down), all rounds
    history: List[float]  # per-round eval metric


def run_fedavg(
    init_params,
    client_datasets: Sequence,
    local_train_fn: Callable,  # (params, client_data, round) -> params
    rounds: int = 10,
    clients_per_round: int = 10,
    eval_fn: Callable = None,  # (params) -> float
    weights_fn: Callable = len,  # client_data -> averaging weight
    seed: int = 0,
) -> FedAvgResult:
    params = init_params
    model_bytes = tree_size_bytes(params)
    rng = np.random.default_rng(seed)
    comm = 0.0
    history = []
    n_clients = len(client_datasets)
    for r in range(rounds):
        chosen = rng.choice(n_clients, size=min(clients_per_round, n_clients), replace=False)
        locals_ = []
        weights = []
        for c in chosen:
            locals_.append(local_train_fn(params, client_datasets[c], r))
            weights.append(float(weights_fn(client_datasets[c])))
        params = average_params(locals_, weights)
        # down to chosen clients + up from chosen clients
        comm += 2.0 * model_bytes * len(chosen)
        if eval_fn is not None:
            history.append(float(eval_fn(params)))
    return FedAvgResult(params=params, rounds=rounds, comm_bytes=comm, history=history)
