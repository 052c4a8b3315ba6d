"""Machine-checkable artifact parity: compare a results directory against
a reference artifact directory with explicit tolerances (the port's own
copy of the JAX package's ``results/parity.py``).

``cptorch-parity out/ --ref <reference data dir>`` runs the comparison,
prints a PASS/FAIL table and exits non-zero on a failure. The reference may
be the reference's shipped ``data/``, a JAX package run or another port
run.

Artifact set compared (reference ``results.py:42-62`` + the sweep stage):

* ``y_true.npy``          — exact equality (canonical task ordering;
  any mismatch means the candidate ran a different split policy).
* ``y_pred.npy``          — voted accuracy |Δ| ≤ ``tol_acc``.
* ``voting.npy``          — group-mean voting curve max |Δ| ≤ ``tol_curve``.
* ``confusion_matrix.npy``— trace/total |Δ| ≤ ``tol_acc`` and per-class
  accuracy max |Δ| ≤ ``tol_class`` (per-class is noisier: 48 samples).
* ``{mean,min,max,std}_grasp`` (xlsx, or npy fallback) — set-size curves;
  mean/min/max max |Δ| ≤ ``tol_curve``; std max |Δ| ≤ ``tol_std``.

``logs.npy`` (raw logits) is deliberately NOT compared: it is stripped
from the reference snapshot (``.MISSING_LARGE_BLOBS``) and bitwise logits
never match across frameworks anyway — the derived artifacts above are
the parity contract.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Tolerances:
    """Explicit comparison tolerances.

    Defaults are calibrated to the reference's own run-to-run spread: the
    recorded AdaBN vs no-AdaBN gap is 0.013 (go.sh:1-4), and 48-group
    binomial noise at p≈0.34 is σ≈0.068 per class — so 0.05 on aggregate
    accuracies/curves and 0.25 per class are "same machine" bands, not
    bitwise bands."""

    tol_acc: float = 0.05
    tol_curve: float = 0.05
    tol_class: float = 0.25
    tol_std: float = 0.05


@dataclass
class Row:
    check: str
    ours: str
    ref: str
    delta: str
    tol: str
    ok: bool


@dataclass
class ParityReport:
    rows: list[Row] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.rows)

    def add(self, check, ours, ref, delta, tol, ok) -> None:
        fmt = lambda v: v if isinstance(v, str) else f"{v:.4f}"
        self.rows.append(
            Row(check, fmt(ours), fmt(ref), fmt(delta), fmt(tol), bool(ok))
        )

    def table(self) -> str:
        headers = ("check", "ours", "ref", "|delta|", "tol", "verdict")
        data = [
            (r.check, r.ours, r.ref, r.delta, r.tol,
             "PASS" if r.ok else "FAIL")
            for r in self.rows
        ]
        widths = [
            max(len(headers[i]), *(len(d[i]) for d in data)) if data
            else len(headers[i])
            for i in range(6)
        ]
        line = lambda cells: "  ".join(
            c.ljust(w) for c, w in zip(cells, widths)
        ).rstrip()
        out = [line(headers), line(tuple("-" * w for w in widths))]
        out += [line(d) for d in data]
        out.append(
            f"\n{'PASS' if self.ok else 'FAIL'}: "
            f"{sum(r.ok for r in self.rows)}/{len(self.rows)} checks passed"
        )
        return "\n".join(out)


def _load_curve(dirpath: str, stem: str) -> Optional[np.ndarray]:
    """A 41-row set-size curve from ``<stem>.xlsx`` (preferred: the
    reference ships xlsx only) or ``<stem>.npy``."""
    xlsx = os.path.join(dirpath, f"{stem}.xlsx")
    npy = os.path.join(dirpath, f"{stem}.npy")
    if os.path.exists(xlsx):
        from contrastiveprosthetics_torch.utils.xlsx import read_xlsx

        arr = read_xlsx(xlsx)
        return arr[:, 0] if arr.ndim == 2 else arr
    if os.path.exists(npy):
        return np.load(npy).ravel()
    return None


def compare_results(
    results_dir: str,
    ref_dir: str,
    tols: Tolerances = Tolerances(),
) -> ParityReport:
    """Compare every shared artifact; missing required files FAIL."""
    rep = ParityReport()

    def load_pair(name):
        a, b = (os.path.join(d, name) for d in (results_dir, ref_dir))
        ours = np.load(a) if os.path.exists(a) else None
        ref = np.load(b) if os.path.exists(b) else None
        return ours, ref

    def require(name, ours, ref) -> bool:
        if ours is None or ref is None:
            rep.add(
                f"{name} present",
                "yes" if ours is not None else "MISSING",
                "yes" if ref is not None else "MISSING",
                "-", "-", False,
            )
            return False
        if ours.shape != ref.shape:
            rep.add(
                f"{name} shape", str(ours.shape), str(ref.shape),
                "-", "equal", False,
            )
            return False
        rep.add(f"{name} shape", str(ours.shape), str(ref.shape),
                "-", "equal", True)
        return True

    # --- y_true: exact (split policy / canonical ordering) ---
    yt_o, yt_r = load_pair("y_true.npy")
    if require("y_true", yt_o, yt_r):
        same = bool(np.array_equal(yt_o, yt_r))
        rep.add("y_true exact", "-", "-",
                f"{int((np.asarray(yt_o) != np.asarray(yt_r)).sum())} diffs",
                "0", same)

    # --- voted accuracy from y_pred vs y_true ---
    yp_o, yp_r = load_pair("y_pred.npy")
    if (yt_o is not None and yp_o is not None
            and yt_r is not None and yp_r is not None
            and require("y_pred", yp_o, yp_r)):
        acc_o = float((yp_o == yt_o).mean())
        acc_r = float((yp_r == yt_r).mean())
        d = abs(acc_o - acc_r)
        rep.add("voted accuracy", acc_o, acc_r, d, tols.tol_acc,
                d <= tols.tol_acc)

    # --- voting curve (group mean over prefixes) ---
    v_o, v_r = load_pair("voting.npy")
    if require("voting", v_o, v_r):
        c_o, c_r = v_o.mean(0), v_r.mean(0)
        d = float(np.abs(c_o - c_r).max())
        rep.add(
            f"voting curve ({v_o.shape[1]} cols, max)",
            float(c_o[-1]), float(c_r[-1]), d, tols.tol_curve,
            d <= tols.tol_curve,
        )

    # --- confusion matrix: trace/total + per-class ---
    cm_o, cm_r = load_pair("confusion_matrix.npy")
    if require("confusion_matrix", cm_o, cm_r):
        t_o = float(cm_o.trace() / max(cm_o.sum(), 1))
        t_r = float(cm_r.trace() / max(cm_r.sum(), 1))
        d = abs(t_o - t_r)
        rep.add("confusion trace/total", t_o, t_r, d, tols.tol_acc,
                d <= tols.tol_acc)
        pc_o = cm_o.diagonal() / np.maximum(cm_o.sum(1), 1)
        pc_r = cm_r.diagonal() / np.maximum(cm_r.sum(1), 1)
        d = float(np.abs(pc_o - pc_r).max())
        rep.add("per-class accuracy (max)", "-", "-", d, tols.tol_class,
                d <= tols.tol_class)

    # --- set-size sweep curves ---
    for stem, tol in (
        ("mean_grasp", tols.tol_curve),
        ("min_grasp", tols.tol_curve),
        ("max_grasp", tols.tol_curve),
        ("std_grasp", tols.tol_std),
    ):
        c_o = _load_curve(results_dir, stem)
        c_r = _load_curve(ref_dir, stem)
        if c_o is None or c_r is None:
            rep.add(
                f"{stem} present",
                "yes" if c_o is not None else "MISSING",
                "yes" if c_r is not None else "MISSING",
                "-", "-", False,
            )
            continue
        if c_o.shape != c_r.shape:
            rep.add(f"{stem} shape", str(c_o.shape), str(c_r.shape),
                    "-", "equal", False)
            continue
        # row 0 is the 0.0 placeholder on both sides; compare sizes 1..40
        d = float(np.abs(c_o[1:] - c_r[1:]).max())
        rep.add(f"{stem} curve (max)", float(c_o[1]), float(c_r[1]),
                d, tol, d <= tol)

    return rep
