"""The port's kernel profiling hooks and roofline package against the
reference's, on the CPU.

Every ``kernels.ops`` dispatcher becomes a ``kernel.<name>`` span under a
tracer, with the reference's attribute keys, and returns bitwise the
untraced result. ``roofline_report``, ``collective_bytes_from_hlo``,
``inner_scan_cost`` and the report renderers give the reference's
numbers and text exactly, on one sheet and one duck-typed mesh.
``kernel_cost`` is pinned to the analytic work that ``chip_smoke.py``'s
bounds were computed from before they moved into the package.
"""
import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES, VARIANTS as REF_VARIANTS
from repro.configs import get_config as ref_get_config
from repro.roofline import analysis as ref_analysis
from repro.roofline import analytic as ref_analytic
from repro.roofline import report as ref_report
from repro_torch.configs import SHAPES as PT_SHAPES, get_config as pt_get_config
from repro_torch.kernels import ops
from repro_torch.obs import kernel_cost, set_hardware, timed_call
from repro_torch.obs.profile import hardware_for, kernel_bound
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.roofline import H100_SXM, H100_SXM_FP32, V5E, collective_bytes_from_hlo, roofline_report
from repro_torch.roofline import analytic as pt_analytic
from repro_torch.roofline import report as pt_report
from test_sharding import HLO_SAMPLE, FakeMesh

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

ROOFLINE_KEYS = ("flops", "bytes_accessed", "achieved_gflops", "roofline_bound_us",
                 "roofline_frac", "dominant")


def _tensors(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                 for a in args)


# ------------------------------------------------------- kernel spans

def test_kernel_spans_carry_roofline_attrs():
    """Twin of tests/test_obs.py::test_kernel_spans_carry_roofline_attrs."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32))
    t = Tracer()
    with use_tracer(t):
        ops.rbf_gram(x, x, 0.5)
    spans = [e for e in t.events if e["name"] == "kernel.rbf_gram"]
    assert len(spans) == 1
    args = spans[0]["args"]
    assert args["flops"] > 0 and args["bytes_accessed"] > 0
    assert args["achieved_gflops"] > 0
    assert 0 < args["roofline_frac"]
    assert args["dominant"] in ("compute", "memory", "collective")
    assert args["backend"] == "cpu" and spans[0]["cat"] == "kernel"
    out_off = ops.rbf_gram(x, x, 0.5)
    with use_tracer(Tracer()):
        out_on = ops.rbf_gram(x, x, 0.5)
    assert torch.equal(out_off, out_on)


@pytest.mark.parametrize("name", sorted(ops.KERNEL_REGISTRY))
def test_every_dispatcher_is_profiled_and_unperturbed(name):
    spec = ops.KERNEL_REGISTRY[name]
    args = _tensors(spec.make_inputs(np.random.default_rng(1)))
    untraced = spec.dispatch(*args)
    t = Tracer()
    with use_tracer(t):
        traced = spec.dispatch(*args)
    assert torch.equal(untraced, traced)
    (span,) = [e for e in t.events if e["name"] == f"kernel.{name}"]
    attrs = span["args"]
    assert set(ROOFLINE_KEYS) <= set(attrs) and attrs["dur_s"] > 0
    flops, nbytes = kernel_cost(name, spec.dispatch, args)
    assert (attrs["flops"], attrs["bytes_accessed"]) == (flops, nbytes)
    bound_s, _ = kernel_bound(name, args)
    assert attrs["roofline_bound_us"] == bound_s * 1e6
    assert attrs["roofline_frac"] == pytest.approx(bound_s / attrs["dur_s"])
    assert span["dur"] == pytest.approx(attrs["dur_s"] * 1e6)


def test_timed_call_times_and_emits_bench_spans():
    """Twin of tests/test_obs.py::test_timed_call_times_and_emits_bench_spans."""
    t = Tracer()
    with use_tracer(t):
        us = timed_call("toy", lambda: torch.ones(4) + 1, repeats=3, warmup=1)
    assert us > 0
    bench = [e for e in t.events if e["name"] == "bench.toy"]
    assert len(bench) == 3
    assert sorted(e["args"]["repeat"] for e in bench) == [0, 1, 2]


# make_inputs / make_ragged of each registry entry: (operations, bytes) as
# chip_smoke.py's work_of counted them when the bounds lived there
PINNED_WORK = {
    "batched_rbf_gram": ((238848, 47632), (578898, 76728)),
    "rbf_gram": ((59712, 11904), (711378, 63996)),
    "ensemble_score": ((188776, 9580), (818013, 42220)),
    "sdca": ((264745, 50700), (643371, 163216)),
    "gram_matvec": ((63552, 4576), (842526, 31616)),
    "rbf_gram_q8": ((60672, 10560), (716336, 56855)),
    "ensemble_score_q8": ((192232, 4684), (836493, 15460)),
    "flash_attention": ((1064960, 131072), (4612608, 315392)),
}


@pytest.mark.parametrize("name", sorted(PINNED_WORK))
def test_kernel_cost_pinned(name):
    spec = ops.KERNEL_REGISTRY[name]
    for make, want in zip((spec.make_inputs, spec.make_ragged), PINNED_WORK[name]):
        args = make(np.random.default_rng(2))
        assert kernel_cost(name, None, args) == tuple(float(v) for v in want)
        assert kernel_cost(name, None, _tensors(args)) == tuple(float(v) for v in want)
    assert kernel_cost("no_such_kernel", None, (np.zeros(3),)) is None


@pytest.mark.parametrize("d,want_ms", [(784, 0.1596), (32, 0.00651), (16, 0.00326)])
def test_gram_matvec_bound_prices_the_plane_products(d, want_ms):
    """``gram_matvec`` at the CG's l 4,096: the cross term's 2 m n d
    operations at 989 / 6 TFLOP/s (an fp32-accurate product from three bf16
    planes), above the rest at the fp32 rate and the bytes: an operations
    bound, the same for the span and the timing table, whichever
    instantiation runs; ``set_hardware`` still prices on its one sheet."""
    x = torch.empty((4096, d), device="meta")
    args = (x, x, torch.empty((4096,), device="meta"), 1.0)
    bound_s, by = kernel_bound("gram_matvec", args)
    assert by == "operations" and round(1e3 * bound_s, 6) == pytest.approx(want_ms, abs=5e-6)
    assert bound_s == 2 * 4096 * 4096 * d / (989e12 / 6)
    flops, nbytes = kernel_cost("gram_matvec", None, args)
    fp32 = roofline_report(flops, nbytes, 0.0, hw=H100_SXM_FP32)["step_lower_bound_s"]
    assert bound_s < fp32 / 2
    set_hardware(H100_SXM_FP32)
    try:
        assert kernel_bound("gram_matvec", args)[0] == fp32
    finally:
        set_hardware(None)


def test_kernel_cost_reads_shapes_only():
    """Meta tensors (no data) price a Gram launch as real ones do, and a
    fit (x2 is x1) reads its operand once."""
    x = torch.empty((8, 64, 32), device="meta")
    g = torch.empty((8,), device="meta")
    fit = kernel_cost("batched_rbf_gram", None, (x, x, g))
    score = kernel_cost("batched_rbf_gram", None, (x, torch.empty((8, 64, 32), device="meta"), g))
    assert fit[0] < score[0] and fit[1] == score[1] - 4 * 8 * 64 * 32


def test_sheets_by_dtype_and_set_hardware():
    q = torch.zeros((1, 16, 2, 16), dtype=torch.bfloat16)
    x = torch.zeros((4, 8))
    assert hardware_for((q,)) is H100_SXM and hardware_for((x,)) is H100_SXM_FP32
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM_FP32.peak_flops) == (989e12, 3.35e12, 67e12)
    set_hardware(V5E)
    try:
        assert hardware_for((q,)) is V5E and hardware_for((x,)) is V5E
        t = Tracer()
        with use_tracer(t):
            ops.rbf_gram(x, x, 0.5)
        attrs = t.events[0]["args"]
        rl = ref_analysis.roofline_report(attrs["flops"], attrs["bytes_accessed"], 0.0,
                                          hw=ref_analysis.V5E)
        assert attrs["roofline_bound_us"] == rl["step_lower_bound_s"] * 1e6
    finally:
        set_hardware(None)
    assert hardware_for((x,)) is H100_SXM_FP32


# ------------------------------------------------------- roofline package

def _ref_sheet(hw):
    return ref_analysis.HardwareSpec(name=hw.name, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                                     link_bw=hw.link_bw)


@pytest.mark.parametrize("hw", [V5E, H100_SXM, H100_SXM_FP32], ids=lambda h: h.name)
def test_roofline_report_matches_reference(hw):
    grid = [(0.0, 0.0, 0.0), (197e12, 819e9 * 2, 0.0), (3.2e13, 3.6e10, 1e9), (1e9, 1e12, 5e10),
            (5e12, 1e6, 1e11)]
    for flops, nbytes, coll in grid:
        for model_flops in (None, 0.0, 3.2e13, flops * 256):
            for chips in (1, 4, 256):
                want = ref_analysis.roofline_report(flops, nbytes, coll, hw=_ref_sheet(hw),
                                                    model_flops=model_flops, chips=chips)
                got = roofline_report(flops, nbytes, coll, hw=hw, model_flops=model_flops,
                                      chips=chips)
                assert got == want


def test_roofline_report_default_sheet_is_the_reference_s():
    assert roofline_report(1e12, 1e9, 0.0) == ref_analysis.roofline_report(1e12, 1e9, 0.0)


def test_collective_bytes_parser_matches_reference():
    out = collective_bytes_from_hlo(HLO_SAMPLE)
    assert out == ref_analysis.collective_bytes_from_hlo(HLO_SAMPLE)
    assert out["all-gather"] == 256 * 2048 * 4
    assert out["all-reduce"] == 16 * 512 * 2 + 100 * 4
    assert out["start_ops"] == 1


MESHES = [FakeMesh((1, 1, 1), ("pod", "data", "model")), FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model")), FakeMesh((4, 3), ("data", "model"))]


@pytest.mark.parametrize("name", sorted(REF_ARCHS) + sorted(REF_VARIANTS))
def test_inner_scan_cost_matches_reference(name):
    ref_cfg, pt_cfg = ref_get_config(name), pt_get_config(name)
    knobs = [{}, {"attn_block_skip": True}, {"attn_block_skip": True, "shard_attn_seq": True}]
    for kw in knobs:
        for shape in REF_SHAPES:
            for mesh in MESHES:
                want = ref_analytic.inner_scan_cost(ref_cfg.replace(**kw), REF_SHAPES[shape], mesh)
                got = pt_analytic.inner_scan_cost(pt_cfg.replace(**kw), PT_SHAPES[shape], mesh)
                assert got == want, (name, kw, shape, mesh.devices.shape)
            # no mesh: every axis of size 1
            assert pt_analytic.inner_scan_cost(pt_cfg.replace(**kw), PT_SHAPES[shape]) == \
                ref_analytic.inner_scan_cost(ref_cfg.replace(**kw), REF_SHAPES[shape], MESHES[0])


def _store():
    rl = lambda c, m, k, d: {"t_compute_s": c, "t_memory_s": m, "t_collective_s": k,
                             "dominant": d, "useful_flops_ratio": 0.71, "mfu_at_bound": c / 0.9}
    return {
        "llama3.2-1b|train_4k|single|baseline": {
            "arch": "llama3.2-1b", "shape": "train_4k", "mesh": "single", "tag": "baseline",
            "status": "ok", "roofline": rl(0.0123, 0.004, 2e-4, "compute"),
            "peak_bytes_per_chip": 3.2 * 2**30},
        "qwen2-1.5b|prefill_32k|multi|baseline": {
            "arch": "qwen2-1.5b", "shape": "prefill_32k", "mesh": "multi", "tag": "baseline",
            "status": "ok", "roofline": rl(4e-4, 2.5, 0.031, "memory")},
        "mamba2-2.7b|decode_32k|single|baseline": {
            "arch": "mamba2-2.7b", "shape": "decode_32k", "mesh": "single", "tag": "baseline",
            "status": "skipped"},
        "glm4-9b|train_4k|single|baseline": {
            "arch": "glm4-9b", "shape": "train_4k", "mesh": "single", "tag": "baseline",
            "status": "error"},
        "glm4-9b|train_4k|single|other": {
            "arch": "glm4-9b", "shape": "train_4k", "mesh": "single", "tag": "other",
            "status": "ok", "roofline": rl(0.0, 0.0, 0.0, "compute")},
    }


def test_report_renders_as_the_reference(tmp_path, monkeypatch):
    store = _store()
    for mesh in ("single", "multi"):
        for tag in ("baseline", "other"):
            assert pt_report.render_table(store, mesh, tag) == ref_report.render_table(store, mesh, tag)
    for tag in ("baseline", "other"):
        assert pt_report.render_summary(store, tag) == ref_report.render_summary(store, tag)
    path = tmp_path / "store.json"
    path.write_text(json.dumps(store))
    out_pt, out_ref = io.StringIO(), io.StringIO()
    with redirect_stdout(out_pt):
        pt_report.main([str(path)])
    monkeypatch.setattr(sys, "argv", ["report", str(path)])
    with redirect_stdout(out_ref):
        ref_report.main()
    assert out_pt.getvalue() == out_ref.getvalue() and "llama3.2-1b" in out_pt.getvalue()
