"""Results export (the JAX package's ``results/export.py``; reference
``results.py:24-64`` and the sweep stage its snapshot lacks).

Writes the same artifact set under the same file names and dtypes, so a
directory diffs mechanically against the reference's ``data/`` and against
the JAX package's:
  logs.npy                 raw eval logits (D*25, 41, 41), float32
  y_pred.npy / y_true.npy  flattened 24-frame-vote predictions (D*41,), int32
  voting.npy               per-item voting curves (D, 24), float32
  voting{,_avg,_std}.xlsx  curve spreadsheets
  confusion_matrix.{npy,xlsx}  (41, 41), int32
  {mean,min,max,std}_grasp.{npy,xlsx}  the set-size sweep (41 rows, row 0 = 0)
  results.png              accuracy against set size, where matplotlib imports
  per_subject_acc.{npy,xlsx}  per-subject accuracy (``export_per_subject``)

The set-size sweep runs on the logits' device; the result's tensors come
off the device here and nowhere before.
"""
from __future__ import annotations

import os

import numpy as np

from contrastiveprosthetics_torch.eval.subset_sweep import subset_size_sweep
from contrastiveprosthetics_torch.eval.voting import confusion_matrix
from contrastiveprosthetics_torch.train.engine import EvalResult
from contrastiveprosthetics_torch.utils.xlsx import write_xlsx


def _host(t, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype, copy=False)


def export_results(result: EvalResult, out_dir: str, n_classes: int = 41,
                   sweep_trials: int = 144, sweep_seed: int = 0,
                   plot: bool = True) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    logs = _host(result.logits, np.float32)
    curve = _host(result.curve, np.float32)
    y_pred = _host(result.y_pred, np.int32).flatten()
    y_true = _host(result.y_true, np.int32).flatten()

    np.save(os.path.join(out_dir, "logs.npy"), logs)
    np.save(os.path.join(out_dir, "y_pred.npy"), y_pred)
    np.save(os.path.join(out_dir, "y_true.npy"), y_true)
    np.save(os.path.join(out_dir, "voting.npy"), curve)
    write_xlsx(os.path.join(out_dir, "voting.xlsx"), curve)
    write_xlsx(os.path.join(out_dir, "voting_avg.xlsx"), curve.mean(axis=0))
    write_xlsx(os.path.join(out_dir, "voting_std.xlsx"), curve.std(axis=0))

    cm = _host(confusion_matrix(result.y_true, result.y_pred, n_classes),
               np.int32)
    np.save(os.path.join(out_dir, "confusion_matrix.npy"), cm)
    write_xlsx(os.path.join(out_dir, "confusion_matrix.xlsx"), cm)

    sweep = subset_size_sweep(result.logits, trials=sweep_trials,
                              seed=sweep_seed)
    for name in ("mean", "min", "max", "std"):
        v = getattr(sweep, name)
        np.save(os.path.join(out_dir, f"{name}_grasp.npy"), v)
        write_xlsx(os.path.join(out_dir, f"{name}_grasp.xlsx"), v)

    if plot:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            sizes = np.arange(1, n_classes)
            fig, ax = plt.subplots(figsize=(6.2, 5))
            ax.plot(sizes, sweep.mean[1:], label="mean")
            ax.fill_between(sizes, sweep.mean[1:] - sweep.std[1:],
                            sweep.mean[1:] + sweep.std[1:], alpha=0.3,
                            label="±std")
            ax.plot(sizes, sweep.min[1:], ":", label="min")
            ax.plot(sizes, sweep.max[1:], ":", label="max")
            ax.set_xlabel("prediction set size")
            ax.set_ylabel("accuracy")
            ax.set_title(
                f"Accuracy per prediction-set size ({sweep_trials} trials)")
            ax.legend()
            fig.savefig(os.path.join(out_dir, "results.png"), dpi=120)
            plt.close(fig)
        except Exception as e:  # no matplotlib, or a headless backend fails
            print(f"plot skipped: {e}")

    return {
        "accuracy": float((y_pred == y_true).mean()),
        "voting_curve": curve.mean(axis=0),
        "sweep_mean": sweep.mean,
        "confusion_matrix": cm,
    }


def export_per_subject(result: EvalResult, out_dir: str, people_ids) -> dict:
    """Per-subject test accuracy (``--per_subject_eval``): ``result`` comes
    from ``Trainer.evaluate_per_subject``, whose rows are in (person, rep,
    group) item order, so each subject's rows are one block.
    ``people_ids``: the person-axis indices of the evaluated view
    (``Config.people_mask``), which label the rows. Writes
    ``per_subject_acc.npy`` (n_people,) and ``per_subject_acc.xlsx``
    (person id, accuracy per row)."""
    os.makedirs(out_dir, exist_ok=True)
    people_ids = np.asarray(people_ids)
    acc_rows = _host(result.curve, np.float32)[:, -1]
    per_subject = acc_rows.reshape(len(people_ids), -1).mean(axis=1)
    np.save(os.path.join(out_dir, "per_subject_acc.npy"), per_subject)
    write_xlsx(os.path.join(out_dir, "per_subject_acc.xlsx"),
               np.stack([people_ids.astype(np.float64), per_subject], axis=1))
    return {"per_subject_acc": per_subject, "people_ids": people_ids,
            "mean": float(per_subject.mean())}
