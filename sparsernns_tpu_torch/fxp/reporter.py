"""Golden-activation verification reporter (counterpart of
``sparsernns_tpu/fxp/reporter.py``): per-block abs / rel error statistics
between the fixed-point model's activations and the float model's dump,
a markdown report (``README.md``) and ``stats.json``; a summary plot only
where ``matplotlib`` imports. Host-side numpy throughout."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np


def error_stats(reference: np.ndarray, candidate: np.ndarray,
                eps: float = 1e-9) -> Dict[str, float]:
    """Abs / rel error statistics of ``candidate`` against ``reference``."""
    ref = np.asarray(reference, np.float64).ravel()
    cand = np.asarray(candidate, np.float64).ravel()
    abs_err = np.abs(ref - cand)
    denom = np.maximum(np.abs(ref), eps)
    rel_err = abs_err / denom
    return {
        "abs_max": float(abs_err.max(initial=0.0)),
        "abs_mean": float(abs_err.mean() if abs_err.size else 0.0),
        "abs_p99": float(np.percentile(abs_err, 99) if abs_err.size else 0.0),
        "rel_mean": float(rel_err.mean() if rel_err.size else 0.0),
        "rel_median": float(np.median(rel_err) if rel_err.size else 0.0),
        "ref_absmax": float(np.abs(ref).max(initial=0.0)),
        "n": int(ref.size),
    }


class Reporter:
    """Accumulates per-block comparisons; a complex block, an (re, im)
    pair, is compared as two entries ``.re`` and ``.im``."""

    def __init__(self, output_dir: str = "verification"):
        self.output_dir = output_dir
        self.blocks: List[Tuple[str, Dict[str, float]]] = []

    def add_block(self, name: str, reference, candidate):
        if isinstance(reference, tuple) and len(reference) == 2:
            self.add_block(f"{name}.re", reference[0], candidate[0])
            self.add_block(f"{name}.im", reference[1], candidate[1])
            return
        ref = np.asarray(reference)
        cand = np.asarray(candidate)
        if ref.shape != cand.shape:
            # a leading batch dim that differs: compare the common rows
            n = min(ref.shape[0], cand.shape[0]) if ref.ndim else 0
            ref, cand = ref[:n], cand[:n]
        self.blocks.append((name, error_stats(ref, cand)))

    def summary(self) -> Dict[str, Any]:
        if not self.blocks:
            return {"blocks": 0}
        worst = max(self.blocks, key=lambda b: b[1]["rel_mean"])
        return {
            "blocks": len(self.blocks),
            "worst_block": worst[0],
            "worst_rel_mean": worst[1]["rel_mean"],
            "mean_rel_mean": float(np.mean(
                [b[1]["rel_mean"] for b in self.blocks])),
        }

    def write(self, plots: bool = False) -> str:
        """Write ``README.md`` and ``stats.json`` (and, with ``plots``,
        ``summary.png``) under the output directory; returns the README's
        path."""
        os.makedirs(self.output_dir, exist_ok=True)
        lines = ["# Fxp verification report", ""]
        s = self.summary()
        lines += [f"- blocks compared: {s.get('blocks', 0)}",
                  f"- worst block: {s.get('worst_block', '-')} "
                  f"(rel_mean={s.get('worst_rel_mean', 0):.3e})", "",
                  "| block | abs_max | abs_mean | abs_p99 | rel_mean "
                  "| rel_median | ref_absmax |",
                  "|---|---|---|---|---|---|---|"]
        for name, st in self.blocks:
            lines.append(
                f"| {name} | {st['abs_max']:.3e} | {st['abs_mean']:.3e} "
                f"| {st['abs_p99']:.3e} | {st['rel_mean']:.3e} "
                f"| {st['rel_median']:.3e} | {st['ref_absmax']:.3e} |")
        path = os.path.join(self.output_dir, "README.md")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(self.output_dir, "stats.json"), "w") as f:
            json.dump({"summary": s, "blocks": dict(self.blocks)}, f,
                      indent=2)
        if plots:
            self._write_plots()
        return path

    def _write_plots(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        names = [b[0] for b in self.blocks]
        rel = [b[1]["rel_mean"] for b in self.blocks]
        fig, ax = plt.subplots(figsize=(10, max(3, len(names) * 0.3)))
        ax.barh(names, rel)
        ax.set_xlabel("mean relative error")
        ax.set_xscale("log")
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, "summary.png"), dpi=120)
        plt.close(fig)
