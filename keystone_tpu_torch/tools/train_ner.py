"""Train the port's averaged-perceptron NER and ship its weights.

    python -m keystone_tpu_torch.tools.train_ner [--no-save]

Counterpart of the repository's ``tools/train_ner.py``. Trains
``nodes/nlp/perceptron_ner.py::AveragedPerceptronNerModel`` on
``tests/resources/ner_train_corpus.txt`` for 5, 8 and 12 epochs, prints
each one's token-level F1 (precision, recall) on the training set and on
the held-out ``tests/resources/ner_tagged_sample.txt`` beside the
rule-based stand-in's (``nodes/nlp/corenlp.py::RuleBasedNerModel``), and
writes the best held-out model to ``nodes/nlp/data/ner_perceptron.json.gz``
only when its held-out F1 beats the stand-in's (the condition of
``tools/train_pos.py``; exit 1 when it does not). ``--no-save`` writes
nothing. Host-only: no device is involved.
"""
from __future__ import annotations

import argparse
from pathlib import Path

RESOURCES = Path(__file__).resolve().parents[2] / "tests" / "resources"
TRAIN = RESOURCES / "ner_train_corpus.txt"
EVAL = RESOURCES / "ner_tagged_sample.txt"
EPOCH_CHOICES = (5, 8, 12)


def token_f1(model, sentences):
    """Token-level (F1, precision, recall) of the non-O labels."""
    tp = fp = fn = 0
    for sent in sentences:
        gold = [lab for _, lab in sent]
        pred = model.best_sequence([w for w, _ in sent]).labels
        assert len(pred) == len(gold)
        for g, p in zip(gold, pred):
            if p != "O" and p == g:
                tp += 1
            elif p != "O":
                fp += 1
            if g != "O" and p != g:
                fn += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return f1, precision, recall


def train_best(sentences, heldout):
    """(held-out F1, epochs, model) of the best of ``EPOCH_CHOICES``, the
    first on a tie."""
    from ..nodes.nlp.perceptron_ner import AveragedPerceptronNerModel

    best = None
    for epochs in EPOCH_CHOICES:
        model = AveragedPerceptronNerModel.train(sentences, epochs=epochs)
        tf1, _, _ = token_f1(model, sentences)
        hf1, hp, hr = token_f1(model, heldout)
        print(f"epochs {epochs:2d}: train F1 {tf1:.4f}, held-out F1 "
              f"{hf1:.4f} (P {hp:.3f} R {hr:.3f})")
        if best is None or hf1 > best[0]:
            best = (hf1, epochs, model)
    return best


def main(argv=None) -> int:
    from ..nodes.nlp.corenlp import RuleBasedNerModel
    from ..nodes.nlp.perceptron_ner import _DATA_PATH, read_labeled_file

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-save", action="store_true",
                    help="evaluate only; write no weights")
    args = ap.parse_args(argv)
    sentences = read_labeled_file(str(TRAIN))
    heldout = read_labeled_file(str(EVAL))
    print(f"train: {len(sentences)} sentences, heldout: {len(heldout)}")
    rf1, rp, rr = token_f1(RuleBasedNerModel(), heldout)
    print(f"rule-based held-out: F1 {rf1:.4f} (P {rp:.3f} R {rr:.3f})")
    hf1, epochs, model = train_best(sentences, heldout)
    print(f"best: epochs={epochs} held-out F1 {hf1:.4f} "
          f"(rule-based {rf1:.4f})")
    if hf1 <= rf1:
        print("NOT saving: the perceptron does not beat the rule-based model")
        return 1
    if not args.no_save:
        model.save()
        print(f"saved {_DATA_PATH}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
