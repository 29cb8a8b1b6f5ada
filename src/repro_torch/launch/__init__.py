"""Command-line drivers of the port (``python -m repro_torch.launch.<name>``):
``serve`` (batched prefill + greedy decode) and ``train`` (LM training
steps). The modules load on first access, so ``python -m`` runs each
without importing it twice."""
import importlib

__all__ = ["serve", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(f"module 'repro_torch.launch' has no attribute {name!r}")
