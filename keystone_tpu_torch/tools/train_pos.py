"""Train the port's averaged-perceptron POS tagger and ship its weights.

    python -m keystone_tpu_torch.tools.train_pos [--no-save]

Counterpart of the repository's ``tools/train_pos.py``. Trains
``nodes/nlp/perceptron_pos.py::AveragedPerceptronPosModel`` for 8 epochs
on ``tests/resources/pos_train_corpus.txt``, prints its accuracy there
and on the held-out ``tests/resources/pos_tagged_sample.txt`` beside the
rule-based stand-in's (``nodes/nlp/corenlp.py::RuleBasedPosModel``), and
writes ``nodes/nlp/data/pos_perceptron.json.gz`` only when the held-out
accuracy beats the stand-in's (exit 1 when it does not). ``--no-save``
writes nothing. Host-only: no device is involved.
"""
from __future__ import annotations

import argparse
from pathlib import Path

RESOURCES = Path(__file__).resolve().parents[2] / "tests" / "resources"
TRAIN = RESOURCES / "pos_train_corpus.txt"
EVAL = RESOURCES / "pos_tagged_sample.txt"
EPOCHS = 8


def accuracy(model, sentences) -> float:
    total = correct = 0
    for sent in sentences:
        pred = model.best_sequence([w for w, _ in sent]).tags
        total += len(sent)
        correct += sum(g == p for (_, g), p in zip(sent, pred))
    return correct / total


def train(sentences):
    from ..nodes.nlp.perceptron_pos import AveragedPerceptronPosModel

    return AveragedPerceptronPosModel.train(sentences, epochs=EPOCHS)


def main(argv=None) -> int:
    from ..nodes.nlp.corenlp import RuleBasedPosModel
    from ..nodes.nlp.perceptron_pos import _DATA_PATH, read_tagged_file

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-save", action="store_true",
                    help="evaluate only; write no weights")
    args = ap.parse_args(argv)
    sentences = read_tagged_file(str(TRAIN))
    heldout = read_tagged_file(str(EVAL))
    print(f"train: {len(sentences)} sentences, "
          f"{sum(len(s) for s in sentences)} tokens")
    print(f"eval (held out): {len(heldout)} sentences, "
          f"{sum(len(s) for s in heldout)} tokens")
    model = train(sentences)
    held_acc = accuracy(model, heldout)
    rule_acc = accuracy(RuleBasedPosModel(), heldout)
    print(f"perceptron train accuracy:    {accuracy(model, sentences):.4f}")
    print(f"perceptron held-out accuracy: {held_acc:.4f}")
    print(f"rule-based held-out accuracy: {rule_acc:.4f}")
    if held_acc <= rule_acc:
        print("NOT saving: the perceptron does not beat the rule-based model")
        return 1
    if not args.no_save:
        model.save()
        print(f"saved {_DATA_PATH}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
