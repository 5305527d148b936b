"""Averaged-perceptron POS tagger: the trained default model of
:class:`~keystone_tpu_torch.nodes.nlp.corenlp.POSTagger` (the reference's
``nodes/nlp/POSTagger.scala:24-35`` wraps Epic's ``PosTagSelector``).

Counterpart of ``keystone_tpu/nodes/nlp/perceptron_pos.py``. Greedy
left-to-right decoding over history features (the previous tag and tag
pair) with averaged-perceptron training. Features are the word, its
affixes, its orthographic shape, a window of two words either side and
the rule-based model's guess as a stacked prior; weights are a
dict-of-dicts stored as gzip JSON, so training and inference need only
the standard library.

Shipped weights: ``data/pos_perceptron.json.gz``, a byte-for-byte copy
of the JAX package's, trained on ``tests/resources/pos_train_corpus.txt``
and held out on ``tests/resources/pos_tagged_sample.txt``. ``save()``
writes this package's copy only.
"""
from __future__ import annotations

import gzip
import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .corenlp import TaggedSequence

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data",
                          "pos_perceptron.json.gz")


def _shape(word: str) -> str:
    """Collapsed orthographic shape: 'Xxx', 'dd', 'x-x', ..."""
    out = []
    for ch in word[:8]:
        if ch.isupper():
            tok = "X"
        elif ch.islower():
            tok = "x"
        elif ch.isdigit():
            tok = "d"
        else:
            tok = ch
        if not out or out[-1] != tok:
            out.append(tok)
    return "".join(out)


#: The rule-based tagger doubles as a feature generator: its lexicon +
#: suffix + shape guess (0.839 on the gold sample by itself) enters the
#: perceptron as a stacked prior the training can trust, override, or
#: condition on — the standard model-stacking trick for small corpora.
_RULE_MODEL = None


def _rule_guess(word: str, sentence_initial: bool) -> str:
    global _RULE_MODEL
    if _RULE_MODEL is None:
        from .corenlp import RuleBasedPosModel

        _RULE_MODEL = RuleBasedPosModel()
    return _RULE_MODEL._tag(word, sentence_initial=sentence_initial)


def _features(words: Sequence[str], i: int, prev: str, prev2: str):
    """Feature strings for position i given decoded history. Mirrors the
    classic averaged-perceptron tagger feature set (word window,
    affixes, shape, tag history) plus the stacked rule-based guess."""
    w = words[i]
    lw = w.lower()
    prior = words[i - 1].lower() if i > 0 else "<s>"
    prior2 = words[i - 2].lower() if i > 1 else "<s>"
    nxt = words[i + 1].lower() if i + 1 < len(words) else "</s>"
    nxt2 = words[i + 2].lower() if i + 2 < len(words) else "</s>"
    feats = [
        "b",                      # bias
        "w=" + lw,
        "suf3=" + lw[-3:],
        "suf2=" + lw[-2:],
        "suf1=" + lw[-1:],
        "pre1=" + lw[:1],
        "shape=" + _shape(w),
        "t-1=" + prev,
        "t-2t-1=" + prev2 + "|" + prev,
        "w-1=" + prior,
        "w-2=" + prior2,
        "w+1=" + nxt,
        "w+2=" + nxt2,
        "t-1w=" + prev + "|" + lw,
        "first" if i == 0 else "mid",
        "rule=" + _rule_guess(w, i == 0),
        "rule,t-1=" + _rule_guess(w, i == 0) + "|" + prev,
    ]
    if any(c.isdigit() for c in w):
        feats.append("hasdigit")
    if "-" in w:
        feats.append("hyphen")
    if w[:1].isupper():
        feats.append("cap")
        if i > 0:
            feats.append("cap-mid")
    return feats


class AveragedPerceptronPosModel:
    """``best_sequence(words)`` protocol-compatible with
    :class:`~keystone_tpu_torch.nodes.nlp.corenlp.RuleBasedPosModel` (and so
    with the reference's Epic CRF wrapper)."""

    def __init__(self, weights: Optional[Dict[str, Dict[str, float]]] = None,
                 tags: Optional[List[str]] = None):
        # weights: feature -> {tag -> weight}
        self.weights = weights or {}
        self.tags = tags or []

    # -- inference --------------------------------------------------------
    def _score_tag(self, feats) -> str:
        scores = defaultdict(float)
        for f in feats:
            wf = self.weights.get(f)
            if not wf:
                continue
            for tag, weight in wf.items():
                scores[tag] += weight
        if not scores:
            return "NN"
        # deterministic tie-break on the tag name
        return max(self.tags, key=lambda t: (scores[t], t)) if self.tags \
            else max(sorted(scores), key=scores.get)

    def best_sequence(self, words: Sequence[str]) -> TaggedSequence:
        prev, prev2 = "<s>", "<s>"
        tags: List[str] = []
        for i in range(len(words)):
            tag = self._score_tag(_features(words, i, prev, prev2))
            tags.append(tag)
            prev2, prev = prev, tag
        return TaggedSequence(list(words), tags)

    # -- training ---------------------------------------------------------
    @classmethod
    def train(cls, sentences: Sequence[List[Tuple[str, str]]],
              epochs: int = 8, seed: int = 0) -> "AveragedPerceptronPosModel":
        """Averaged-perceptron training on (word, tag) sentences —
        greedy decoding against gold history, accumulate-and-average to
        resist overfitting on small corpora."""
        rng = random.Random(seed)
        tags = sorted({t for sent in sentences for _, t in sent})
        model = cls(weights={}, tags=tags)
        totals: Dict[Tuple[str, str], float] = defaultdict(float)
        stamps: Dict[Tuple[str, str], int] = defaultdict(int)
        step = 0

        def upd(feat, tag, delta):
            nonlocal step
            key = (feat, tag)
            cur = model.weights.setdefault(feat, {}).get(tag, 0.0)
            totals[key] += (step - stamps[key]) * cur
            stamps[key] = step
            model.weights[feat][tag] = cur + delta

        data = list(sentences)
        for _ in range(epochs):
            rng.shuffle(data)
            for sent in data:
                words = [w for w, _ in sent]
                prev, prev2 = "<s>", "<s>"
                for i, (_, gold) in enumerate(sent):
                    feats = _features(words, i, prev, prev2)
                    guess = model._score_tag(feats)
                    step += 1
                    if guess != gold:
                        for f in feats:
                            upd(f, gold, +1.0)
                            upd(f, guess, -1.0)
                    # decoded history: training sees the same noisy
                    # tag context inference will (no exposure bias)
                    prev2, prev = prev, guess
        # average
        for feat, per_tag in model.weights.items():
            for tag, cur in per_tag.items():
                key = (feat, tag)
                total = totals[key] + (step - stamps[key]) * cur
                per_tag[tag] = round(total / step, 5)
        # prune zeros (smaller artifact)
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
            json.dump({"tags": self.tags, "weights": self.weights}, f)

    @classmethod
    def load(cls, path: str = _DATA_PATH) -> "AveragedPerceptronPosModel":
        with gzip.open(path, "rt") as f:
            blob = json.load(f)
        return cls(weights=blob["weights"], tags=blob["tags"])


_PRETRAINED_CACHE: List[Optional[AveragedPerceptronPosModel]] = []


def load_pretrained() -> Optional[AveragedPerceptronPosModel]:
    """The shipped trained model (process-wide singleton, so identical
    default pipelines CSE-merge on model identity), or None when the
    artifact is absent (callers fall back to the rule-based model)."""
    if not _PRETRAINED_CACHE:
        _PRETRAINED_CACHE.append(
            AveragedPerceptronPosModel.load()
            if os.path.exists(_DATA_PATH) else None)
    return _PRETRAINED_CACHE[0]


def read_tagged_file(path: str) -> List[List[Tuple[str, str]]]:
    """word_TAG lines -> [(word, tag)] sentences (comments skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append([tuple(tok.rsplit("_", 1)) for tok in line.split()])
    return out
