"""The distillation leg of one one-shot round, in one place.

Port of ``repro.distill.round``: draw proxy data on the distillation
stage's own seed stream, distill the best selected cell, push the
student through its download codec onto the ledger at exact wire size,
and hand back the DECODED student for evaluation, all inside one
``distill.round`` span.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.comm.wire import decode, encode
from repro_torch.distill.config import DistillConfig
from repro_torch.distill.proxy import make_proxy
from repro_torch.distill.solvers import distill_rng, distill_teacher
from repro_torch.obs.trace import current_tracer


@dataclasses.dataclass
class DistilledRound:
    """What the distillation leg hands back to a runner."""

    student: object      # the student AS DEVICES DECODE IT
    codec: str           # the download codec actually used
    nbytes: int          # exact wire size, as recorded on the ledger
    proxy_size: int      # proxy rows actually drawn


def distill_round(
    teacher_predict: Callable[[np.ndarray], np.ndarray],
    devices: Optional[Sequence],
    cfg: DistillConfig,
    seed: int,
    round_codec: str,
    ledger,
    dim: Optional[int] = None,
    default_proxy_params: Optional[Mapping] = None,
    split_counts=None,
    fetch_split=None,
    device="cuda",
) -> DistilledRound:
    """Proxy draw -> solve on ``device`` -> wire -> ledger, for one round.

    ``default_proxy_params`` backstop the config's ``proxy_params``
    (the population runner defaults the ``scenario`` source to its own
    federation); the student download codec defaults to the round's
    upload codec. Streamed rounds pass ``devices=None`` plus the lazy
    ``split_counts``/``fetch_split`` pair (see ``proxy.ProxyContext``).
    """
    with current_tracer().span("distill.round", cat="distill",
                               solver=cfg.solver, proxy=cfg.proxy,
                               proxy_size=cfg.proxy_size):
        params = dict(cfg.proxy_params)
        for key, val in dict(default_proxy_params or {}).items():
            params.setdefault(key, val)
        proxy = make_proxy(cfg.proxy, n=cfg.proxy_size, rng=distill_rng(seed),
                           devices=devices, dim=dim,
                           split_counts=split_counts, fetch_split=fetch_split,
                           **params)
        student = distill_teacher(teacher_predict, proxy, cfg=cfg, seed=seed,
                                  device=device)
        codec = cfg.codec or round_codec
        wire = encode(student, codec)
        ledger.record("down", "student_download", len(wire),
                      codec=codec, tag="download_distilled")
    return DistilledRound(decode(wire, device=device), codec, len(wire), len(proxy))
