"""Launchers of the port: the sim mesh (``make_sim_mesh``,
``mesh_chips``) and the command-line drivers (``python -m
repro_torch.launch.<name>``): ``serve`` (batched prefill + greedy
decode), ``train`` (LM training steps) and ``fed_run`` (the one-shot
round: the deep LM round or the population-scale SVM round). The drivers
load on first access, so ``python -m`` runs each without importing it
twice."""
import importlib

from repro_torch.launch.mesh import make_sim_mesh, mesh_chips

_DRIVERS = ("serve", "train", "fed_run")
__all__ = ["make_sim_mesh", "mesh_chips", *_DRIVERS]


def __getattr__(name):
    if name in _DRIVERS:
        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(f"module 'repro_torch.launch' has no attribute {name!r}")
