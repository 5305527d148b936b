"""Averaged-perceptron NER: the trained default model of
:class:`~keystone_tpu_torch.nodes.nlp.corenlp.NER` (the reference's
``nodes/nlp/NER.scala:20-31`` wraps Epic's ``NerSelector``).

Counterpart of ``keystone_tpu/nodes/nlp/perceptron_ner.py``. Greedy
left-to-right token labeling (PERSON / LOCATION / ORGANIZATION / NUMBER
/ O) over history features, trained as ``perceptron_pos.py`` is, with
the rule-based NER's label as a stacked prior. Adjacent tokens of one
label merge into a span of the
:class:`~keystone_tpu_torch.nodes.nlp.corenlp.Segmentation` output, so
two distinct adjacent entities of one type come back as one span
(token-level labels are exact), as in the JAX package.

Shipped weights: ``data/ner_perceptron.json.gz``, a byte-for-byte copy
of the JAX package's, trained on ``tests/resources/ner_train_corpus.txt``
and held out on ``tests/resources/ner_tagged_sample.txt``. ``save()``
writes this package's copy only.
"""
from __future__ import annotations

import gzip
import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .corenlp import Segmentation
from .perceptron_pos import _shape

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data",
                          "ner_perceptron.json.gz")

_RULE_MODEL = None


def _rule_labels(words: Sequence[str]) -> List[str]:
    global _RULE_MODEL
    if _RULE_MODEL is None:
        from .corenlp import RuleBasedNerModel

        _RULE_MODEL = RuleBasedNerModel()
    return _RULE_MODEL.best_sequence(list(words)).labels


def _features(words: Sequence[str], rule: Sequence[str], i: int,
              prev: str, prev2: str) -> List[str]:
    """Feature strings for position i given decoded label history."""
    w = words[i]
    lw = w.lower()
    prior = words[i - 1] if i > 0 else "<s>"
    prior2 = words[i - 2] if i > 1 else "<s>"
    nxt = words[i + 1] if i + 1 < len(words) else "</s>"
    nxt2 = words[i + 2] if i + 2 < len(words) else "</s>"
    feats = [
        "b",
        "w=" + lw,
        "suf3=" + lw[-3:],
        "pre3=" + lw[:3],
        "shape=" + _shape(w),
        "l-1=" + prev,
        "l-2l-1=" + prev2 + "|" + prev,
        "w-1=" + prior.lower(),
        "w-2=" + prior2.lower(),
        "w+1=" + nxt.lower(),
        "w+2=" + nxt2.lower(),
        "l-1w=" + prev + "|" + lw,
        "w-1w=" + prior.lower() + "|" + lw,
        "first" if i == 0 else "mid",
        "rule=" + rule[i],
        "rule,l-1=" + rule[i] + "|" + prev,
        "rule,w-1=" + rule[i] + "|" + prior.lower(),
    ]
    if w[:1].isupper():
        feats.append("cap")
        if i > 0:
            feats.append("cap-mid")
        if nxt[:1].isupper():
            feats.append("cap-next-cap")
        if prior[:1].isupper() and i > 0:
            feats.append("cap-prev-cap")
    if w.isupper() and len(w) > 1:
        feats.append("allcaps")
    if any(c.isdigit() for c in w):
        feats.append("hasdigit")
    if w.isdigit():
        feats.append("alldigit")
    return feats


class AveragedPerceptronNerModel:
    """``best_sequence(words) -> Segmentation`` — protocol-compatible
    with :class:`~keystone_tpu_torch.nodes.nlp.corenlp.RuleBasedNerModel`
    (and so with the reference's Epic SemiCRF wrapper)."""

    def __init__(self, weights: Optional[Dict[str, Dict[str, float]]] = None,
                 labels: Optional[List[str]] = None):
        self.weights = weights or {}
        self.labels = labels or []

    # -- inference --------------------------------------------------------
    def _score_label(self, feats) -> str:
        scores = defaultdict(float)
        for f in feats:
            wf = self.weights.get(f)
            if not wf:
                continue
            for lab, weight in wf.items():
                scores[lab] += weight
        if not scores:
            return "O"
        return max(self.labels, key=lambda t: (scores[t], t)) if self.labels \
            else max(sorted(scores), key=scores.get)

    def label_sequence(self, words: Sequence[str]) -> List[str]:
        rule = _rule_labels(words)
        prev, prev2 = "<s>", "<s>"
        out: List[str] = []
        for i in range(len(words)):
            lab = self._score_label(_features(words, rule, i, prev, prev2))
            out.append(lab)
            prev2, prev = prev, lab
        return out

    def best_sequence(self, words: Sequence[str]) -> Segmentation:
        words = list(words)
        labels = self.label_sequence(words)
        spans: List[Tuple[str, int, int]] = []
        i = 0
        while i < len(words):
            if labels[i] == "O":
                i += 1
                continue
            j = i
            while j < len(words) and labels[j] == labels[i]:
                j += 1
            spans.append((labels[i], i, j))
            i = j
        return Segmentation(words, spans)

    # -- training ---------------------------------------------------------
    @classmethod
    def train(cls, sentences: Sequence[List[Tuple[str, str]]],
              epochs: int = 8, seed: int = 0) -> "AveragedPerceptronNerModel":
        """Averaged-perceptron training on (word, label) sentences with
        decoded history (same accumulate-and-average scheme as
        ``AveragedPerceptronPosModel.train``)."""
        rng = random.Random(seed)
        labels = sorted({lab for sent in sentences for _, lab in sent})
        model = cls(weights={}, labels=labels)
        totals: Dict[Tuple[str, str], float] = defaultdict(float)
        stamps: Dict[Tuple[str, str], int] = defaultdict(int)
        step = 0

        def upd(feat, lab, delta):
            key = (feat, lab)
            cur = model.weights.setdefault(feat, {}).get(lab, 0.0)
            totals[key] += (step - stamps[key]) * cur
            stamps[key] = step
            model.weights[feat][lab] = cur + delta

        data = list(sentences)
        for _ in range(epochs):
            rng.shuffle(data)
            for sent in data:
                words = [w for w, _ in sent]
                rule = _rule_labels(words)
                prev, prev2 = "<s>", "<s>"
                for i, (_, gold) in enumerate(sent):
                    feats = _features(words, rule, i, prev, prev2)
                    guess = model._score_label(feats)
                    step += 1
                    if guess != gold:
                        for f in feats:
                            upd(f, gold, +1.0)
                            upd(f, guess, -1.0)
                    prev2, prev = prev, guess
        for feat, per in model.weights.items():
            for lab, cur in per.items():
                key = (feat, lab)
                total = totals[key] + (step - stamps[key]) * cur
                per[lab] = round(total / step, 5)
        model.weights = {
            f: {t: w for t, w in per.items() if w}
            for f, per in model.weights.items()
        }
        model.weights = {f: per for f, per in model.weights.items() if per}
        return model

    # -- persistence ------------------------------------------------------
    def save(self, path: str = _DATA_PATH) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            json.dump({"labels": self.labels, "weights": self.weights}, f)

    @classmethod
    def load(cls, path: str = _DATA_PATH) -> "AveragedPerceptronNerModel":
        with gzip.open(path, "rt") as f:
            blob = json.load(f)
        return cls(weights=blob["weights"], labels=blob["labels"])


_PRETRAINED_CACHE: List[Optional[AveragedPerceptronNerModel]] = []


def load_pretrained() -> Optional[AveragedPerceptronNerModel]:
    """The shipped trained model (process-wide singleton, so identical
    default pipelines CSE-merge on model identity), or None when the
    artifact is absent (callers fall back to the rule-based model)."""
    if not _PRETRAINED_CACHE:
        _PRETRAINED_CACHE.append(
            AveragedPerceptronNerModel.load()
            if os.path.exists(_DATA_PATH) else None)
    return _PRETRAINED_CACHE[0]


def read_labeled_file(path: str) -> List[List[Tuple[str, str]]]:
    """word|LABEL lines -> [(word, label)] sentences (comments skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append([tuple(tok.split("|")) for tok in line.split()])
    return out
