"""The PyTorch port stands alone: it imports neither JAX nor the reference
package ``repro``, and its entry points run on the card unless the caller
asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_with_jax_and_repro_blocked():
    """Every module imports in a fresh interpreter in which ``jax``,
    ``jaxlib`` and ``repro`` cannot be imported at all."""
    mods = _port_modules()
    assert len(mods) > 20
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
        " and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA every entry point called without ``device`` raises;
    nothing quietly moves to the CPU."""
    from repro_torch.comm.wire import QuantizedSVM, _quantize_columns
    from repro_torch.convert import linear_from_arrays
    from repro_torch.core.averaging import LinearSVM, StackedLinear, train_linear_svm
    from repro_torch.core.ensemble import StackedEnsemble
    from repro_torch.core.protocol import run_protocol
    from repro_torch.distill import distill_teacher
    from repro_torch.comm.wire import encode
    from repro_torch.fleet import TenantRegistry, serve_round_artifact
    from repro_torch.launch import train
    from repro_torch.serve import EnsembleScorer
    from repro_torch.core.svm import SVMModel, train_svm
    from repro_torch.data import make_dataset
    from repro_torch.sim import PopulationConfig, device_stream, run_population
    from repro_torch.sim.engine import train_population, train_selected
    from repro_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("gleam", seed=0, scale=0.2)
    x = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    y = np.where(np.arange(10) % 2 == 0, 1.0, -1.0).astype(np.float32)
    calls = [
        lambda: resolve_device("cuda"),
        lambda: run_protocol(ds, ks=(1,)),
        lambda: train_population(ds),
        lambda: train_population(ds, mode="streamed"),
        lambda: train_selected(device_stream("iid", n_devices=4), [0]),
        lambda: run_population(PopulationConfig(n_devices=8)),
        lambda: run_population(PopulationConfig(n_devices=8, engine="streamed")),
        lambda: train_svm(x, y),
        lambda: SVMModel(x, y * 0.1, 0.5).predict(x),
        lambda: StackedEnsemble.from_members([SVMModel(x, y * 0.1, 0.5)]),
        lambda: QuantizedSVM(*_quantize_columns(x), y * 0.1, 0.5).predict(x),
        lambda: distill_teacher(lambda q: q[:, 0], x),
        lambda: run_protocol(ds, ks=(1,), aggregator="reweight"),
        lambda: run_population(PopulationConfig(n_devices=8, aggregator="fisher")),
        lambda: train_linear_svm(x, y),
        lambda: LinearSVM(x[0], 0.5).predict(x),
        lambda: StackedLinear.from_model(LinearSVM(x[0], 0.5)),
        lambda: linear_from_arrays(x[0], 0.5),
        lambda: EnsembleScorer(SVMModel(x, y * 0.1, 0.5)),
        lambda: TenantRegistry().register_wire("t", encode(SVMModel(x, y * 0.1, 0.5))),
        lambda: serve_round_artifact(SVMModel(x, y * 0.1, 0.5)),
        lambda: train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cpu_on_request_and_unknown_devices_rejected():
    from repro_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
