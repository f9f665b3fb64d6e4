"""Top-k accuracies on the device; the VGG-Sound test metrics on the host.

Counterparts of ``asf_tpu/engine/metrics.py:24-62``: ``topks_correct``,
``topk_accuracies`` and the joint (every task right) multitask pair. Each
returns 0-d float32 tensors on the input's device, so the train step reads
nothing back to the host.

``d_prime``, ``vggsound_stats`` and ``get_map`` (``:208-252``) score the
ensembled test predictions. The JAX package takes average precision and
ROC AUC from scikit-learn, which the machine with the card may lack; here
they are numpy with scikit-learn's definitions: average precision steps
over the distinct scores (a run of tied scores is one threshold), and the
AUC is the trapezoid over the ROC points of those thresholds, so a tied
run counts as half right.

The sliding-window metrics (``:103-159``: ``topks_correct_slide``,
``topk_accuracies_slide`` and their multitask pair) are numpy copies: a
window's (N, L) labels hold every action that overlaps it, any of which
counts, with an optional weight a window.

``state_metrics`` (``:168-201``) scores the state head on the host, in
numpy for the same reason: for each chain's first and last real window,
the macro and micro F1, recall and precision over its P attributes
(scikit-learn's definitions with ``zero_division=0``: per class
``2 tp / (true + predicted)``, ``tp / predicted``, ``tp / true``, macro the
mean over the classes present in the labels or the predictions), and the
accuracy, each averaged over the chains.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _top_idx(preds: torch.Tensor, max_k: int) -> torch.Tensor:
    """(N, C) -> (N, max_k) indices of the top-k scores."""
    return torch.topk(preds, max_k, dim=1).indices


def topks_correct(preds: torch.Tensor, labels: torch.Tensor, ks: Sequence[int]):
    """Number of correct top-k predictions for each k. preds (N, C), labels (N,)."""
    top = _top_idx(preds, max(ks))
    correct = top == labels[:, None]
    return [correct[:, :k].any(dim=1).sum().float() for k in ks]


def topk_accuracies(preds, labels, ks=(1, 5)):
    n = preds.shape[0]
    return [c / n * 100.0 for c in topks_correct(preds, labels, ks)]


def multitask_topks_correct(preds, labels, ks=(1,)):
    """A sample is correct at k iff every task's label is in that task's top-k."""
    max_k = int(max(ks))
    all_correct = 0
    for output, label in zip(preds, labels):
        all_correct = all_correct + (_top_idx(output, max_k).T == label[None, :]).int()
    task_count = len(preds)
    return [(all_correct[:k].sum(dim=0) >= task_count).float().sum() for k in ks]


def multitask_topk_accuracies(preds, labels, ks=(1, 5)):
    n = preds[0].shape[0]
    return [c / n * 100.0 for c in multitask_topks_correct(preds, labels, ks)]


# ---------------------------------------------------------------------------
# VGG-Sound test metrics (host, numpy)
# ---------------------------------------------------------------------------

def _binary_curve(y_true: np.ndarray, score: np.ndarray):
    """(true positives, false positives) at each distinct score, highest
    first: scikit-learn's ``_binary_clf_curve``."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y_true = score[order], y_true[order]
    last = np.r_[np.flatnonzero(np.diff(score)), score.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    return tps, last + 1 - tps


def average_precision(y_true: np.ndarray, score: np.ndarray) -> float:
    """scikit-learn's ``average_precision_score`` of one binary column:
    the sum over thresholds of (recall step) x precision."""
    tps, fps = _binary_curve(np.asarray(y_true, np.float64), np.asarray(score, np.float64))
    if tps[-1] == 0:
        return 0.0
    recall = np.r_[0.0, tps / tps[-1]]
    return float(np.sum(np.diff(recall) * (tps / (tps + fps))))


def roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """scikit-learn's ``roc_auc_score`` of one binary column; raises
    ``ValueError`` when the column holds one class only, as it does."""
    tps, fps = _binary_curve(np.asarray(y_true, np.float64), np.asarray(score, np.float64))
    if tps[-1] == 0 or fps[-1] == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined.")
    tpr, fpr = np.r_[0.0, tps / tps[-1]], np.r_[0.0, fps / fps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def d_prime(auc: float) -> float:
    """sqrt(2) x the standard normal quantile of ``auc`` (``scipy.special.ndtri``
    is ``scipy.stats.norm.ppf``'s function)."""
    from scipy.special import ndtri

    return (2.0 ** 0.5) * float(ndtri(auc))


def vggsound_stats(preds, labels) -> dict:
    """mAP, mean AUC and d' of (N, C) scores against (N,) class ids, one-hot;
    classes with no positive are left out, and a class every clip belongs to
    has no AUC."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    if not np.isfinite(preds).all():
        raise ValueError("Input contains NaN or infinity.")
    one_hot = np.eye(preds.shape[1])[labels]
    aps, aucs = [], []
    for k in range(preds.shape[1]):
        if one_hot[:, k].sum() == 0:
            continue
        aps.append(average_precision(one_hot[:, k], preds[:, k]))
        try:
            aucs.append(roc_auc(one_hot[:, k], preds[:, k]))
        except ValueError:
            pass
    m_auc = float(np.mean(aucs)) if aucs else 0.0
    return {
        "mAP": float(np.mean(aps)) if aps else 0.0,
        "AUC": m_auc,
        "d_prime": d_prime(m_auc) if 0.0 < m_auc < 1.0 else 0.0,
    }


def get_map(preds, labels) -> float:
    """Multi-label mAP: classes with no positive dropped, then the mean of
    each class's average precision; 0.0 for labels that are not 0/1 or
    scores that are not finite (where scikit-learn raises)."""
    preds = np.asarray(preds, np.float64)
    labels = np.asarray(labels)
    keep = ~np.all(labels == 0, axis=0)
    preds, labels = preds[:, keep], labels[:, keep]
    if not np.isin(labels, (0, 1)).all() or not np.isfinite(preds).all():
        return 0.0
    return float(np.mean([average_precision(labels[:, k], preds[:, k])
                          for k in range(labels.shape[1])]))


# ---------------------------------------------------------------------------
# Sliding-window (untrimmed video) test metrics (host, numpy)
# ---------------------------------------------------------------------------

def _slide_correct(top: np.ndarray, labels: np.ndarray, per_action_instance: bool) -> np.ndarray:
    """(max_k, N) hits of the top-k class ids ``top``: against (N,) labels,
    or against any column of (N, L) labels (-1 slots never hit)."""
    labels = np.asarray(labels)
    if per_action_instance:
        return top == labels[None, :]
    correct = np.zeros_like(top, dtype=bool)
    for col in range(labels.shape[1]):
        correct |= top == labels[:, col][None, :]
    return correct


def topks_correct_slide(preds, labels, ks, per_action_instance=True, weight=None):
    """Weighted top-k hits of (N, C) window scores for each k, the weights
    normalised to sum 1 (uniform when ``weight`` is None): against (N,)
    labels with ``per_action_instance``, else against (N, L) labels, where a
    window counts once for each of its label slots in its top-k (any
    overlapping action counts)."""
    preds = np.asarray(preds)
    weight = (np.ones(preds.shape[0]) / preds.shape[0] if weight is None
              else np.asarray(weight, np.float64) / np.sum(weight))
    top = np.argsort(-preds, axis=1)[:, : max(ks)].T  # (max_k, N)
    correct = _slide_correct(top, labels, per_action_instance)
    return [float((weight * correct[:k, :]).sum()) for k in ks]


def topk_accuracies_slide(preds, labels, ks, per_action_instance=True, weight=None):
    return [x * 100.0 for x in topks_correct_slide(preds, labels, ks, per_action_instance, weight)]


def multitask_topks_correct_slide(preds, labels, ks=(1,), per_action_instance=True, weight=None):
    """Weighted count of windows whose hits over the tasks' top-k reach the
    number of tasks, for each k."""
    weight = (np.ones(np.asarray(preds[0]).shape[0]) if weight is None
              else np.asarray(weight, np.float64))
    weight = weight / weight.sum()
    max_k = int(max(ks))
    all_correct = np.zeros((max_k, np.asarray(labels[0]).shape[0]), dtype=np.int32)
    for output, label in zip(preds, labels):
        top = np.argsort(-np.asarray(output), axis=1)[:, :max_k].T
        all_correct += _slide_correct(top, label, per_action_instance).astype(np.int32)
    task_count = len(preds)
    return [float((weight * (all_correct[:k].sum(axis=0) >= task_count)).sum()) for k in ks]


def multitask_topk_accuracies_slide(preds, labels, ks, per_action_instance=True, weight=None):
    return [x * 100.0
            for x in multitask_topks_correct_slide(preds, labels, ks, per_action_instance, weight)]


STATE_METRICS = ("f1_macro", "f1_micro", "recall_macro", "recall_micro", "precision_macro",
                 "precision_micro", "accuracy")


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (scikit-learn's ``zero_division=0``)."""
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


def _state_scores(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """The ``STATE_METRICS`` of one window's (P,) class ids."""
    classes = np.union1d(y_true, y_pred)
    true = (y_true[None, :] == classes[:, None])
    pred = (y_pred[None, :] == classes[:, None])
    tp = (true & pred).sum(axis=1).astype(np.float64)
    n_true, n_pred = true.sum(axis=1).astype(np.float64), pred.sum(axis=1).astype(np.float64)
    out = {}
    for avg, (t, nt, np_) in (("macro", (tp, n_true, n_pred)),
                              ("micro", (tp.sum(keepdims=True), n_true.sum(keepdims=True),
                                         n_pred.sum(keepdims=True)))):
        out[f"f1_{avg}"] = float(np.mean(_divide(2.0 * t, nt + np_)))
        out[f"recall_{avg}"] = float(np.mean(_divide(t, nt)))
        out[f"precision_{avg}"] = float(np.mean(_divide(t, np_)))
    out["accuracy"] = float(np.mean(y_true == y_pred))
    return out


def state_metrics(preds, labels, lengths, split: str = "Val") -> dict:
    """``{split}/state/{metric}_{precs,posts}``: the ``STATE_METRICS`` of the
    first window (preconditions) and of the last real window
    (postconditions) of each chain, averaged over the chains. ``preds``
    (B, N, P, 3) are the state head's outputs (softmaxed, then the arg max
    over the last axis), ``labels`` the (B, N, P, 3) one-hot labels of
    ``steps.prepare_state_labels``, ``lengths`` (B,) the chains' windows.

    The JAX package's 3-D branch (``asf_tpu/engine/metrics.py:178-182``)
    takes the mean of the logits over the class axis as the class, a quirk
    of the reference that its loops never reach (they pass windows); here a
    3-D input raises."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    if preds.ndim != 4:
        raise ValueError(f"state_metrics takes (B, N, P, 3) windows, not {preds.shape}: pass a "
                         "single clip's (B, P, 3) as one window, preds[:, None]")
    e = np.exp(preds - preds.max(axis=3, keepdims=True))
    preds_cls = (e / e.sum(axis=3, keepdims=True)).argmax(axis=3)  # (B, N, P)
    labels_cls = labels.argmax(axis=3)
    acc = {f"{n}_{kind}": [] for n in STATE_METRICS for kind in ("precs", "posts")}
    for i, length in enumerate(np.asarray(lengths)):
        for kind, w in (("precs", 0), ("posts", length - 1)):
            for n, v in _state_scores(labels_cls[i, w], preds_cls[i, w]).items():
                acc[f"{n}_{kind}"].append(v)
    return {f"{split}/state/{k}": float(np.mean(v)) for k, v in acc.items()}
