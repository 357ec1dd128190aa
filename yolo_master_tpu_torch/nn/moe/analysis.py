"""MoE observability, the port's copy of ``yolo_master_tpu/nn/moe/analysis.py``:
usage tracking, collapse detection, routing history and its HTML dashboard
(reference: ultralytics/nn/modules/moe/analysis.py:26,432,515 + history.py +
utils/routing_interpreter.py). numpy only.

All consumers read the train step's ``moe_stats`` (block path ->
{"expert_usage": [E], ...}, ``engine/train_step.py``); ``diagnose_model``
reads the usage of ``nn/moe/pruning.py:collect_usage_stats``'s pass.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from .scheduler import compute_gini

LOGGER = logging.getLogger(__name__)


class ExpertUsageTracker:
    """Accumulates per-block expert usage across steps (reference analysis.py:26)."""

    def __init__(self):
        self.totals: Dict[str, np.ndarray] = {}
        self.counts: Dict[str, int] = {}

    def update(self, ctx_stats: Dict[str, dict]) -> None:
        for path, stats in ctx_stats.items():
            usage = stats.get("expert_usage")
            if usage is None:
                continue
            u = np.asarray(usage, np.float64)
            self.totals[path] = self.totals.get(path, 0.0) + u
            self.counts[path] = self.counts.get(path, 0) + 1

    def mean_usage(self) -> Dict[str, np.ndarray]:
        return {k: v / max(self.counts[k], 1) for k, v in self.totals.items()}

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> Dict[str, dict]:
        out = {}
        for path, usage in self.mean_usage().items():
            out[path] = {
                "usage": usage.tolist(),
                "gini": compute_gini(usage),
                "max_share": float(usage.max() / max(usage.sum(), 1e-9)),
                "active_experts": int((usage > 0.01).sum()),
            }
        return out


class RoutingCollapseDetector:
    """Flags blocks whose routing has collapsed onto few experts
    (reference analysis.py:515 RoutingCollapseDetector)."""

    def __init__(self, max_share_threshold: float = 0.9, min_active_fraction: float = 0.25):
        self.max_share_threshold = max_share_threshold
        self.min_active_fraction = min_active_fraction

    def check(self, usage_by_block: Dict[str, np.ndarray]) -> List[dict]:
        findings = []
        for path, usage in usage_by_block.items():
            u = np.asarray(usage, np.float64)
            total = max(u.sum(), 1e-9)
            share = float(u.max() / total)
            active = int((u / total > 0.01).sum())
            if share > self.max_share_threshold or active < max(1, int(len(u) * self.min_active_fraction)):
                findings.append({"block": path, "max_share": share, "active_experts": active, "num_experts": len(u)})
        return findings


class RoutingHistory:
    """Per-epoch CSV/JSON persistence of routing usage (reference moe/history.py)."""

    def __init__(self, save_dir: str):
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.rows: List[dict] = []

    def record(self, epoch: int, usage_by_block: Dict[str, np.ndarray]) -> None:
        for path, usage in usage_by_block.items():
            self.rows.append({"epoch": epoch, "block": path, "gini": compute_gini(usage),
                              "usage": json.dumps(np.asarray(usage).round(5).tolist())})

    def save(self) -> str:
        csv_path = self.dir / "routing_history.csv"
        if self.rows:
            with open(csv_path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(self.rows[0]))
                writer.writeheader()
                writer.writerows(self.rows)
        return str(csv_path)


def diagnose_model(model, batches, max_batches: int = 8) -> dict:
    """One-call MoE health report (reference analysis.py:432 diagnose_model): each
    MoE block's usage over ``batches`` (train-mode forwards at step 0, the model
    left as it was), its Gini and share summary, and the blocks whose routing
    collapsed. The JAX function's ``params`` argument has no counterpart: the
    model holds its weights."""
    from .pruning import collect_usage_stats

    usage = collect_usage_stats(model, batches, max_batches)
    tracker = ExpertUsageTracker()
    tracker.totals = {k: np.asarray(v) for k, v in usage.items()}
    tracker.counts = {k: 1 for k in usage}
    collapse = RoutingCollapseDetector().check(usage)
    report = {"blocks": tracker.summary(), "collapsed": collapse}
    if collapse:
        LOGGER.warning(f"routing collapse detected in {len(collapse)} blocks")
    return report


def render_dashboard(history: "RoutingHistory | str", out_path: str | None = None) -> str:
    """Self-contained HTML routing dashboard (reference moe/viz.py): per-block
    expert-usage bars for the latest epoch plus the Gini trend per block.
    Pure HTML/CSS (no JS/deps) so it opens anywhere. Accepts a RoutingHistory
    or a routing_history.csv path; returns the written HTML path."""
    if isinstance(history, str):
        with open(history, newline="") as f:
            rows = [dict(r) for r in csv.DictReader(f)]
        out_dir = Path(history).parent
    else:
        rows = history.rows
        out_dir = history.dir
    out = Path(out_path) if out_path else out_dir / "routing_dashboard.html"

    by_block: Dict[str, list] = {}
    for r in rows:
        by_block.setdefault(r["block"], []).append(r)

    def bar(frac: float, color: str = "#4a90d9") -> str:
        return (f'<div style="background:#eee;width:240px;height:12px;display:inline-block">'
                f'<div style="background:{color};width:{max(1, int(frac * 240))}px;height:12px"></div></div>')

    parts = ["<html><head><meta charset='utf-8'><title>MoE routing dashboard</title>",
             "<style>body{font-family:monospace;margin:24px}td,th{padding:2px 10px;text-align:left}</style>",
             "</head><body><h2>MoE routing dashboard</h2>"]
    for block, rs in sorted(by_block.items()):
        rs = sorted(rs, key=lambda r: int(r["epoch"]))
        last = rs[-1]
        usage = np.asarray(json.loads(last["usage"]), np.float64)
        share = usage / max(usage.sum(), 1e-9)
        collapse = float(share.max()) > 0.9
        parts.append(f"<h3>{block}{' &#9888; collapsed' if collapse else ''}</h3>")
        parts.append(f"<p>epoch {last['epoch']} &middot; E={len(usage)} &middot; gini={float(last['gini']):.3f}</p><table>")
        for e, s in enumerate(share):
            parts.append(f"<tr><td>expert {e}</td><td>{bar(float(s), '#d9534f' if collapse else '#4a90d9')}</td>"
                         f"<td>{s:.1%}</td></tr>")
        parts.append("</table><p>gini trend: " +
                     " ".join(f"e{r['epoch']}:{float(r['gini']):.2f}" for r in rs[-12:]) + "</p>")
    parts.append("</body></html>")
    out.write_text("\n".join(parts))
    return str(out)
