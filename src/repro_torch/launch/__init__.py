"""Launchers of the port: the meshes (``make_sim_mesh``,
``make_debug_mesh``, ``make_production_mesh``, ``mesh_chips``), the
meta-tensor step specs (``specs``) and the command-line drivers
(``python -m repro_torch.launch.<name>``): ``serve`` (batched prefill +
greedy decode), ``train`` (LM training steps, on an LM mesh with
``--mesh``), ``fed_run`` (the one-shot round: the deep LM round or the
population-scale SVM round) and ``dryrun`` (every arch x shape x mesh
step priced on a fake world of 256 or 512 ranks). The drivers load on
first access, so ``python -m`` runs each without importing it twice."""
import importlib

from repro_torch.launch.mesh import (
    make_debug_mesh,
    make_production_mesh,
    make_sim_mesh,
    mesh_chips,
)

_DRIVERS = ("serve", "train", "fed_run", "dryrun")
__all__ = ["make_production_mesh", "make_debug_mesh", "make_sim_mesh", "mesh_chips",
           *_DRIVERS]


def __getattr__(name):
    if name in _DRIVERS:
        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(f"module 'repro_torch.launch' has no attribute {name!r}")
