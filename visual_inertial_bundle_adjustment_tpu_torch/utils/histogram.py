"""Log-bucketed terminal histograms + percentile stats containers (numpy).

Port of `visual_inertial_bundle_adjustment_tpu/utils/histogram.py`
(reference viba/common/Histogram.{h,cpp}, UTF-8 bar rendering, and
viba/common/StatsValueContainer.{h,cpp}, lazy percentile/mean/rmse)."""

from __future__ import annotations

import numpy as np

_BARS = " ▏▎▍▌▋▊▉█"


def render_histogram(values, title="", num_buckets=18, width=50, log_scale=True):
    """Render a log-bucketed histogram of positive values as terminal text."""
    values = np.asarray(values, float)
    values = values[np.isfinite(values)]
    if values.size == 0:
        return f"{title}: <empty>\n"
    pos = values[values > 0]
    # the lower edge is clamped before the upper one is set from it: the JAX
    # package clamps it after, so values all below 1e-11 (a prior's residual
    # at its reference) gave decreasing edges and np.histogram raised
    lo = max(np.percentile(pos, 0.5) if pos.size else 1e-6, 1e-12)
    hi = np.percentile(values, 99.9) if values.size else 1.0
    hi = max(hi, lo * 10)
    if log_scale:
        edges = np.logspace(np.log10(lo), np.log10(hi), num_buckets + 1)
    else:
        edges = np.linspace(values.min(), hi, num_buckets + 1)
    counts, _ = np.histogram(values, bins=edges)
    peak = max(counts.max(), 1)
    lines = [f"{title}  (n={values.size}, med={np.median(values):.4g}, "
             f"p95={np.percentile(values, 95):.4g}, max={values.max():.4g})"]
    for i, c in enumerate(counts):
        frac = c / peak * width
        full = int(frac)
        rem = int((frac - full) * 8)
        bar = "█" * full + (_BARS[rem] if rem else "")
        lines.append(f"  {edges[i]:>10.3g} ┤{bar} {c}")
    return "\n".join(lines) + "\n"


class StatsValueContainer:
    """Percentile/mean/rmse container (StatsValueContainer.h)."""

    def __init__(self, name="", unit=""):
        self.name = name
        self.unit = unit
        self._values = []

    def add(self, values):
        self._values.append(np.asarray(values, float).reshape(-1))

    @property
    def values(self):
        return np.concatenate(self._values) if self._values else np.zeros(0)

    def percentile(self, p):
        v = self.values
        return float(np.percentile(v, p)) if v.size else float("nan")

    def mean(self):
        v = self.values
        return float(v.mean()) if v.size else float("nan")

    def rmse(self):
        v = self.values
        return float(np.sqrt((v**2).mean())) if v.size else float("nan")

    def summary(self):
        v = self.values
        if not v.size:
            return f"{self.name}: <empty>"
        return (
            f"{self.name}: n={v.size} mean={v.mean():.4g}{self.unit} "
            f"rmse={self.rmse():.4g}{self.unit} p50={np.percentile(v, 50):.4g} "
            f"p90={np.percentile(v, 90):.4g} p99={np.percentile(v, 99):.4g}"
        )
