"""Residual histograms and stats per factor class.

Port of `visual_inertial_bundle_adjustment_tpu/problem/histograms.py`
(reference viba/problem/{Histograms,Stats}.{h,cpp}): batches carry explicit
kind/label, so classification is direct. The same groups: visual
reprojection errors in px, inertial rot/vel/pos splits (deg, cm/s, cm),
random walks, factory priors, omega priors.

Divergence from the JAX package, which counts the padded slots of a blocked
batch as observations (its residual_batch marks them valid, and its
histograms keep every valid slot): here only the real slots count
(`_pad < 0.5`).
"""

from __future__ import annotations

import numpy as np

from ..utils.histogram import StatsValueContainer, render_histogram
from . import factors as fct


def residuals(problem):
    """(cfg, whitened residuals (n, d), valid (n,) bool) of every batch's real
    slots, as host numpy (one device-to-host copy a batch)."""
    out = []
    for cfg, data in zip(problem.cfgs, problem.datas):
        res, valid = fct.residual_batch(cfg, data, problem.variables)
        res, valid = res.double().cpu().numpy(), valid.double().cpu().numpy() > 0.5
        if "_pad" in data:
            real = data["_pad"].cpu().numpy() < 0.5
            res, valid = res[real], valid[real]
        out.append((cfg, res, valid))
    return out


def collect(problem):
    """Per-group stats containers (reference collectStats, Stats.h:16-35)."""
    stats = {}

    def get(name, unit=""):
        if name not in stats:
            stats[name] = StatsValueContainer(name, unit)
        return stats[name]

    for cfg, res, ok in residuals(problem):
        if cfg.kind in ("visual", "rs_visual"):
            # the whitened magnitude (the reference's "weighted" histograms)
            get(f"{cfg.label or cfg.kind}/px", "px").add(np.linalg.norm(res[ok], axis=-1))
            get("visual/invalid", "").add(np.asarray([float((~ok).sum())]))
        elif cfg.kind in ("inertial", "inertial_secondary"):
            lbl = cfg.label or cfg.kind
            get(f"{lbl}/rot_deg", "deg").add(np.linalg.norm(res[ok, 0:3], axis=-1) * 180 / np.pi)
            get(f"{lbl}/vel", "").add(np.linalg.norm(res[ok, 3:6], axis=-1))
            get(f"{lbl}/pos", "").add(np.linalg.norm(res[ok, 6:9], axis=-1))
        elif cfg.kind.startswith("rw_"):
            get(f"rw/{cfg.label or cfg.kind}", "").add(np.linalg.norm(res[ok], axis=-1))
        elif cfg.kind.endswith("_prior") and cfg.kind != "omega_prior":
            get(f"prior/{cfg.label or cfg.kind}", "").add(np.linalg.norm(res[ok], axis=-1))
        elif cfg.kind == "omega_prior":
            get("omega_prior", "").add(np.linalg.norm(res[ok], axis=-1))
    return stats


def show_histograms(problem, log=print):
    """Render terminal histograms per factor class
    (reference SingleSessionProblem::showHistogram)."""
    for cfg, res, ok in residuals(problem):
        mag = np.linalg.norm(res[ok], axis=-1)
        if mag.size:
            log(render_histogram(mag, title=f"[{cfg.label or cfg.kind}] |whitened residual|"))


def summarize(problem, log=print):
    for s in collect(problem).values():
        log(s.summary())
