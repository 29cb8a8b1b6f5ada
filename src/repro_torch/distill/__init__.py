"""repro_torch.distill — server-side distillation of the selected
ensemble into one kernel expansion on proxy data (the paper's Eq. 3).

solvers.py  kernel-ridge solver registry: dense, CG (its matvec the
            ``gram_matvec`` kernel), Nystrom, auto
proxy.py    proxy-data registry: validation, public, gaussian, scenario
sweep.py    batched multi-l distillation (the fig-3 sweep in one solve)
round.py    the round's distillation leg: proxy, solve, wire, ledger
config.py   ``DistillConfig``, the knob object ``run_protocol`` takes
"""
from repro_torch.distill.config import DistillConfig
from repro_torch.distill.proxy import (
    PROXIES,
    ProxyContext,
    list_proxies,
    make_proxy,
    register_proxy,
)
from repro_torch.distill.round import DistilledRound, distill_round
from repro_torch.distill.solvers import (
    SOLVERS,
    dedupe_proxy,
    distill_rng,
    distill_teacher,
    get_solver,
    list_solvers,
    register_solver,
)
from repro_torch.distill.sweep import distill_sweep

__all__ = [
    "DistillConfig",
    "DistilledRound",
    "PROXIES",
    "ProxyContext",
    "SOLVERS",
    "dedupe_proxy",
    "distill_rng",
    "distill_round",
    "distill_sweep",
    "distill_teacher",
    "get_solver",
    "list_proxies",
    "list_solvers",
    "make_proxy",
    "register_proxy",
    "register_solver",
]
