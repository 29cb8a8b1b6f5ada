"""The port's launch layer on the LM mesh, on the CPU: ``launch.train``
with ``--mesh`` and ``--fsdp``, and the dry-run (``launch.dryrun``).

* ``train.main(["--mesh", "debug"], device="cpu")`` (a 1 x 1 mesh in a
  one-rank gloo world) gives the ``--mesh none`` run's losses, with and
  without FSDP; ``--mesh single`` / ``multi`` in that world raise naming
  the 256 / 512 ranks they need.
* The dry-run, in a subprocess of its own (its fake world of 256 ranks
  must not meet the gloo world of this process): one combination cut to
  1 layer on the 16 x 16 mesh, ``train_4k``. Its record has the
  reference's keys and roofline keys; on a 1 x 1 mesh its FLOPs per chip
  equal the unsharded step's, counted by the same counter and by
  ``torch.utils.flop_counter.FlopCounterMode``; on 16 x 16 the per-chip
  FLOPs times 256 are at least that; its collective bytes are 0 on 1 x 1
  and above 0 on 16 x 16.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.roofline import roofline_report as ref_roofline_report
from repro_torch.launch import train as pt_train
from repro_torch.obs.trace import Tracer, use_tracer

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
# the keys ``repro.launch.dryrun.run_one`` writes into an "ok" record
REFERENCE_RECORD_KEYS = {
    "arch", "shape", "mesh", "tag", "fsdp", "remat", "levers", "status", "t_lower_s",
    "t_compile_s", "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
    "generated_code_size_in_bytes", "peak_bytes_per_chip", "raw_hlo_flops_per_chip",
    "raw_hlo_bytes_per_chip", "raw_collectives", "t_probe_s", "hlo_flops_per_chip",
    "hlo_bytes_per_chip", "collectives", "roofline",
}
REFERENCE_LEVERS = {"cast_grads", "moe_local", "block_skip", "shard_kv_seq", "replicate_embed",
                    "shard_attn_seq", "expert_parallel"}


@functools.lru_cache(maxsize=None)
def _losses(argv):
    argv = list(argv)
    tracer = Tracer()
    with use_tracer(tracer):
        pt_train.main(argv, device="cpu")
    return [e["args"]["loss"] for e in tracer.events if e["name"] == "train.metrics"]


ARGV = ["--arch", "llama3.2-1b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16"]


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
def test_train_on_the_debug_mesh_gives_the_unsharded_losses(fsdp):
    """A 1 x 1 mesh shards nothing: every local op is the unsharded op,
    so the losses are the same bits."""
    base = _losses(tuple(ARGV))
    got = _losses(tuple(ARGV + ["--mesh", "debug"] + (["--fsdp"] if fsdp else [])))
    assert len(got) == 2 and got == base


@pytest.mark.parametrize("mesh,ranks", [("single", 256), ("multi", 512)])
def test_production_meshes_need_their_worlds(mesh, ranks):
    with pytest.raises(ValueError, match=f"needs {ranks} ranks; the world has 1"):
        pt_train.main(ARGV + ["--mesh", mesh], device="cpu")


_DRYRUN = """
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
out = sys.argv[1]
dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--layers", "1", "--out", out])
cfg = get_config("llama3.2-1b").replace(n_layers=1)
shape, rules = SHAPES["train_4k"], dryrun.lever_rules(False)
one = dryrun.run_one("llama3.2-1b", "train_4k", "debug", False, "none", "baseline", layers=1)
with FlopCounterMode(display=False) as fc:   # torch's own count of the same ops
    plain = dryrun.count_step(cfg, shape, None, rules)
json.dump({"one": one, "plain": {k: plain[k] for k in ("flops", "collectives")},
           "torch_flops": fc.get_total_flops()}, open(out + ".more", "w"))
"""


def test_dryrun_prices_a_combination(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _DRYRUN, str(out)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dry-run complete: 1 ok, 0 skipped, 0 errors / 1 combos" in proc.stdout
    (rec,) = json.loads(out.read_text()).values()
    more = json.loads(Path(str(out) + ".more").read_text())
    one, plain = more["one"], more["plain"]
    assert rec["status"] == one["status"] == "ok", (rec.get("error"), one.get("error"))
    assert set(rec) == REFERENCE_RECORD_KEYS | {"layers"} and rec["layers"] == 1
    assert set(rec["levers"]) == REFERENCE_LEVERS
    assert (rec["arch"], rec["shape"], rec["mesh"], one["mesh"]) == \
        ("llama3.2-1b", "train_4k", "16x16", "1x1")
    want_roofline = ref_roofline_report(1.0, 1.0, 1.0, model_flops=1.0, chips=1)
    assert set(rec["roofline"]) == set(want_roofline)
    assert rec["roofline"]["chips"] == 256 and one["roofline"]["chips"] == 1
    # FLOPs per chip: the unsharded step's on one chip, at least their share on 256
    assert plain["flops"] == more["torch_flops"] > 0
    assert one["hlo_flops_per_chip"] == plain["flops"]
    assert rec["hlo_flops_per_chip"] * 256 >= plain["flops"]
    assert rec["hlo_flops_per_chip"] < plain["flops"] / 16
    # collectives: none on one chip, some on 256
    assert one["collectives"]["total"] == plain["collectives"]["total"] == 0
    assert rec["collectives"]["total"] > 0
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                                        "all-to-all", "collective-permute"))
    assert rec["peak_bytes_per_chip"] == rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    assert 0 < rec["argument_size_in_bytes"] < one["argument_size_in_bytes"]


def test_dryrun_refuses_a_world_that_is_up():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_sim_mesh

    make_sim_mesh(device="cpu")   # the one-rank gloo world of this process
    with pytest.raises(RuntimeError, match="already up"):
        dryrun.start_fake_world(256)
