"""Render roofline markdown tables from dry-run result JSON files.

A copy of ``repro.roofline.report``: the store maps
``"arch|shape|mesh|tag"`` to a result with ``status`` and, when ``ok``,
a ``roofline`` block from ``roofline_report`` (the reference's dry-run
writes such stores; its meshes are the two TPU pod layouts named in the
headings). Runnable as::

  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_baseline.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List


def _fmt_s(v: float) -> str:
    if v == 0:
        return "0"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def render_table(store: Dict, mesh: str = "single", tag: str = "baseline") -> str:
    rows: List[str] = [
        "| arch | shape | compute | memory | collective | dominant | useful/HLO | MFU@bound | peak GiB/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in sorted(store.items()):
        a, s, m, t = key.split("|")
        if m != mesh or t != tag:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {a} | {s} | — | — | — | n/a (skip: full attention) | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {a} | {s} | ERROR | | | | | | |")
            continue
        rl = r["roofline"]
        peak = r.get("peak_bytes_per_chip", 0) / 2**30
        rows.append(
            f"| {a} | {s} | {_fmt_s(rl['t_compute_s'])} | {_fmt_s(rl['t_memory_s'])} "
            f"| {_fmt_s(rl['t_collective_s'])} | **{rl['dominant']}** "
            f"| {min(rl.get('useful_flops_ratio', 0), 99):.2f} "
            f"| {rl.get('mfu_at_bound', 0) * 100:.1f}% | {peak:.1f} |"
        )
    return "\n".join(rows)


def render_summary(store: Dict, tag: str = "baseline") -> str:
    ok = [r for r in store.values() if r["status"] == "ok" and r["tag"] == tag]
    skipped = [r for r in store.values() if r["status"] == "skipped" and r["tag"] == tag]
    dom = {}
    for r in ok:
        dom[r["roofline"]["dominant"]] = dom.get(r["roofline"]["dominant"], 0) + 1
    lines = [
        f"combos: {len(ok)} compiled ok, {len(skipped)} skipped (documented), tag={tag}",
        f"dominant-term histogram: {dom}",
    ]
    worst = sorted(
        (r for r in ok),
        key=lambda r: r["roofline"].get("mfu_at_bound", 0),
    )[:5]
    lines.append("lowest MFU-at-bound (hillclimb candidates):")
    for r in worst:
        lines.append(
            f"  {r['arch']}|{r['shape']}|{r['mesh']}: mfu={r['roofline'].get('mfu_at_bound', 0) * 100:.2f}% dominant={r['roofline']['dominant']}"
        )
    coll = sorted(ok, key=lambda r: -r["roofline"]["t_collective_s"])[:5]
    lines.append("most collective-bound:")
    for r in coll:
        lines.append(
            f"  {r['arch']}|{r['shape']}|{r['mesh']}: t_coll={_fmt_s(r['roofline']['t_collective_s'])} dominant={r['roofline']['dominant']}"
        )
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    path = argv[0] if argv else "results/dryrun_baseline.json"
    tag = argv[1] if len(argv) > 1 else "baseline"
    with open(path) as f:
        store = json.load(f)
    print(f"## Roofline — single pod (16x16 = 256 chips), tag={tag}\n")
    print(render_table(store, "single", tag))
    print(f"\n## Roofline — multi-pod (2x16x16 = 512 chips), tag={tag}\n")
    print(render_table(store, "multi", tag))
    print("\n## Summary\n")
    print(render_summary(store, tag))


if __name__ == "__main__":
    main()
