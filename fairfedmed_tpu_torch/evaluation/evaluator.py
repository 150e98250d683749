"""Evaluators (mirror Dassl/dassl/evaluation/evaluator.py:27-125 and
evaluation/evaluator_oph.py:10-151).

The port's own copy of ``fairfedmed_tpu/evaluation/evaluator.py``.
Accumulate host outputs per batch; finalize on host with numpy.
The ordering of the result dict is load-bearing: the FL server consumes
``list(results.values())`` positionally as [accuracy, error_rate, macro_f1,
auc, ...] (federated_main.py:686-690).
"""

from __future__ import annotations

import os
from collections import OrderedDict, defaultdict

import numpy as np

from ..utils.registry import EVALUATOR_REGISTRY
from . import metrics as M


def _softmax(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@EVALUATOR_REGISTRY.register()
class Classification:
    """acc / err / macro_f1 (+ optional per-class and confusion matrix)."""

    def __init__(self, cfg, lab2cname=None, **kwargs):
        self.cfg = cfg
        self._lab2cname = lab2cname
        self._per_class_res = None
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0
        self._y_true = []
        self._y_pred = []
        if self.cfg.TEST.PER_CLASS_RESULT:
            assert self._lab2cname is not None
            self._per_class_res = defaultdict(list)

    def process(self, mo, gt, attr=None):
        mo = np.asarray(mo, np.float32)
        gt = np.asarray(gt)
        if mo.shape == gt.shape:
            # binary logit outputs [B]: sigmoid+threshold, don't argmax —
            # argmax over a 1-D batch collapses it to ONE index (same guard
            # as Classification_oph.process; the reference's mo.max(1)
            # crashes)
            pred = (_sigmoid(mo) >= 0.5).astype(gt.dtype)
        else:
            pred = mo.argmax(-1)
        matches = (pred == gt).astype(np.int64)
        self._correct += int(matches.sum())
        self._total += int(gt.shape[0])
        self._y_true.extend(gt.tolist())
        self._y_pred.extend(pred.tolist())
        if self._per_class_res is not None:
            for label, match in zip(gt.tolist(), matches.tolist()):
                self._per_class_res[label].append(int(match))

    def evaluate(self):
        results = OrderedDict()
        if self._total == 0:
            # a fully filtered-out test split: the reference's sklearn
            # f1_score crashes here; report zeros instead
            print("=> result\n* total: 0 (empty test set — zeroed metrics)")
            return OrderedDict(accuracy=0.0, error_rate=100.0, macro_f1=0.0)
        acc = 100.0 * self._correct / max(self._total, 1)
        err = 100.0 - acc
        macro_f1 = 100.0 * M.macro_f1_score(self._y_true, self._y_pred)
        results["accuracy"] = acc
        results["error_rate"] = err
        results["macro_f1"] = macro_f1
        print(
            "=> result\n"
            f"* total: {self._total:,}\n"
            f"* correct: {self._correct:,}\n"
            f"* accuracy: {acc:.2f}%\n"
            f"* error: {err:.2f}%\n"
            f"* macro_f1: {macro_f1:.2f}%"
        )
        if self._per_class_res is not None:
            labels = sorted(self._per_class_res)
            accs = []
            for label in labels:
                res = self._per_class_res[label]
                acc_c = 100.0 * sum(res) / len(res)
                accs.append(acc_c)
                print(f"* class: {label} ({self._lab2cname[label]})\t"
                      f"total: {len(res):,}\tcorrect: {sum(res):,}\tacc: {acc_c:.2f}%")
            results["perclass_accuracy"] = float(np.mean(accs))
        if getattr(self.cfg.TEST, "COMPUTE_CMAT", False):
            # row-normalized confusion matrix over the observed label set
            # (Dassl evaluator.py:117-124, sklearn normalize="true"); saved
            # as .npy — numpy array, no torch — instead of torch's cmat.pt
            labels = sorted(set(self._y_true) | set(self._y_pred))
            lut = {lb: j for j, lb in enumerate(labels)}
            cmat = np.zeros((len(labels), len(labels)), np.float64)
            for t, p in zip(self._y_true, self._y_pred):
                cmat[lut[t], lut[p]] += 1
            with np.errstate(invalid="ignore"):
                cmat /= cmat.sum(axis=1, keepdims=True)
            save_path = os.path.join(self.cfg.OUTPUT_DIR, "cmat.npy")
            np.save(save_path, cmat)
            print(f"Confusion matrix is saved to {save_path}")
        return results


@EVALUATOR_REGISTRY.register()
class Classification_oph:
    """Classification + per-attribute fairness block (evaluator_oph.py)."""

    def __init__(self, cfg, lab2cname=None, **kwargs):
        self.cfg = cfg
        self._lab2cname = lab2cname
        self.reset()

    def reset(self):
        self._pred_prob = []
        self._gt = []
        self._attr = []
        self._correct = 0
        self._total = 0
        self._y_true = []
        self._y_pred = []

    def process(self, mo, gt, attr=None):
        """mo: logits [B, C] (device or host); gt: [B]; attr: [num_attrs, B]."""
        mo = np.asarray(mo, np.float32)
        gt = np.asarray(gt)
        if mo.shape == gt.shape:
            # binary sigmoid outputs [B]: threshold, don't argmax (which
            # would collapse over the batch)
            prob = _sigmoid(mo)
            self._pred_prob.append(prob)
            pred = (prob >= 0.5).astype(gt.dtype)
        else:
            self._pred_prob.append(_softmax(mo))
            pred = mo.argmax(-1)
        self._gt.append(gt)
        if attr is not None:
            self._attr.append(np.asarray(attr))
        self._correct += int((pred == gt).sum())
        self._total += int(gt.shape[0])
        self._y_true.extend(gt.tolist())
        self._y_pred.extend(pred.tolist())

    def evaluate(self):
        results = OrderedDict()
        if self._total == 0:
            # empty client test set: the downstream concatenate/f1/AUC all
            # raise on empty input (as does the reference); zeroed metrics
            # keep the positional [accuracy, error_rate, macro_f1, auc, ...]
            # contract the FL server consumes
            print("=> result\n* total: 0 (empty test set — zeroed metrics)")
            return OrderedDict(accuracy=0.0, error_rate=100.0, macro_f1=0.0,
                               auc=0.0)
        acc = 100.0 * self._correct / max(self._total, 1)
        err = 100.0 - acc
        macro_f1 = 100.0 * M.macro_f1_score(self._y_true, self._y_pred)
        pred_prob = np.concatenate(self._pred_prob)
        gt = np.concatenate(self._gt)
        attr = np.concatenate(self._attr, axis=1) if self._attr else None
        auc = 100.0 * M.compute_auc(pred_prob, gt)

        results["accuracy"] = acc
        results["error_rate"] = err
        results["macro_f1"] = macro_f1
        results["auc"] = auc
        print(
            "=> result\n"
            f"* total: {self._total:,}\n"
            f"* correct: {self._correct:,}\n"
            f"* accuracy: {acc:.2f}%\n"
            f"* error: {err:.2f}%\n"
            f"* macro_f1: {macro_f1:.2f}%\n"
            f"* auc: {auc:.2f}%"
        )

        if attr is not None:
            (overall_acc, esaccs, overall_auc, esaucs, aucs_by_attrs,
             dpds, eods, aods, bgd) = M.evalute_comprehensive_perf_scores(pred_prob, gt, attr)
            print(
                "=> result_oph\n"
                f"* overall_acc: {100 * overall_acc:.2f}%\n"
                f"* overall_auc: {100 * overall_auc:.2f}%"
            )
            for idx in range(attr.shape[0]):
                name = self.cfg.DATASET.ATTRIBUTES[idx]
                print(
                    f"* esacc_{name}: {100 * esaccs[idx]:.2f}%\n"
                    f"* esauc_{name}: {100 * esaucs[idx]:.2f}%\n"
                    f"* dpd_{name}: {100 * dpds[idx]:.2f}%\n"
                    f"* eod_{name}: {100 * eods[idx]:.2f}%\n"
                    f"* aod_{name}: {100 * aods[idx]:.2f}%"
                )
                print("\n".join(
                    f"* auc_{name}_{j}: {100 * a:.2f}%" for j, a in enumerate(aucs_by_attrs[idx])
                ))
                print("".join(
                    f"* between_group_disparity_{name}_{j}: {x:.4f}\n" for j, x in enumerate(bgd[idx])
                ))
            results["overall_acc"] = overall_acc
            results["esaccs_by_attrs"] = esaccs
            results["overall_auc"] = overall_auc
            results["esaucs_by_attrs"] = esaucs
            results["aucs_by_attrs"] = aucs_by_attrs
            results["dpds"] = dpds
            results["eods"] = eods
            results["aods"] = aods
            results["between_group_disparity"] = bgd
        return results


def build_evaluator(cfg, lab2cname=None, **kwargs):
    return EVALUATOR_REGISTRY.get(cfg.TEST.EVALUATOR)(cfg, lab2cname=lab2cname, **kwargs)
