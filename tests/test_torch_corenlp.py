"""The port's linguistic annotation nodes and trained perceptrons against
the JAX package's.

Mirrors ``tests/test_corenlp_nodes.py`` and ``tests/test_nlp_quality.py``.
The same words go through both packages' lemmatizer, rule-based and
perceptron taggers, NER and ``CoreNLPFeatureExtractor``; tags, labels,
spans, lemmas and extracted n-grams must be equal. The quality floors
are the JAX package's, on the in-tree gold samples
(``tests/resources/{pos,ner}_tagged_sample.txt``). The port reads its
own copy of the trained models (``keystone_tpu_torch/nodes/nlp/data``).
"""
import os

import numpy as np
import pytest

import keystone_tpu.nodes.nlp as jnlp
from keystone_tpu.nodes.nlp import perceptron_ner as jner
from keystone_tpu.nodes.nlp import perceptron_pos as jpos
from keystone_tpu_torch.nodes.nlp import (
    CoreNLPFeatureExtractor,
    NER,
    POSTagger,
    RuleBasedNerModel,
    RuleBasedPosModel,
    english_lemmatize,
)
from keystone_tpu_torch.nodes.nlp import perceptron_ner as tner
from keystone_tpu_torch.nodes.nlp import perceptron_pos as tpos
from keystone_tpu_torch.nodes.nlp.corenlp import TaggedSequence

RES = os.path.join(os.path.dirname(__file__), "resources")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(name):
    return [line.strip() for line in open(os.path.join(RES, name))
            if line.strip() and not line.startswith("#")]


def _pos_sample():
    out = []
    for line in _lines("pos_tagged_sample.txt"):
        pairs = [t.rsplit("_", 1) for t in line.split()]
        out.append(([w for w, _ in pairs], [t for _, t in pairs]))
    return out


def _ner_sample():
    out = []
    for line in _lines("ner_tagged_sample.txt"):
        pairs = [t.split("|") for t in line.split()]
        out.append(([w for w, _ in pairs], [t for _, t in pairs]))
    return out


def _all_words():
    words = [w for ws, _ in _pos_sample() + _ner_sample() for w in ws]
    words += [w for s in tpos.read_tagged_file(
        os.path.join(RES, "pos_train_corpus.txt")) for w, _ in s]
    return sorted(set(words))


# -- lemmatizer ---------------------------------------------------------------

def test_lemmatizer_rules():
    assert english_lemmatize("was") == "be"
    assert english_lemmatize("children") == "child"
    assert english_lemmatize("cities") == "city"
    assert english_lemmatize("running") == "run"
    assert english_lemmatize("making") == "make"
    assert english_lemmatize("faster", "JJR") == "fast"
    assert english_lemmatize("corner", "NN") == "corner"
    assert english_lemmatize("analysis") == "analysis"


def test_lemmas_equal_the_jax_ones():
    tags = [None, "VBG", "NN", "JJR", "JJS", "RBR", "VBD"]
    for w in _all_words():
        for tag in tags:
            assert english_lemmatize(w, tag) == jnlp.english_lemmatize(
                w, tag), (w, tag)


# -- POS -----------------------------------------------------------------------

def test_rule_based_tags_equal_the_jax_ones():
    port, jax_ = RuleBasedPosModel(), jnlp.RuleBasedPosModel()
    for words, _ in _pos_sample() + _ner_sample():
        assert port.best_sequence(words).tags == jax_.best_sequence(
            words).tags


def test_perceptron_tags_equal_the_jax_ones():
    port, jax_ = tpos.load_pretrained(), jpos.load_pretrained()
    assert port is not None and jax_ is not None
    assert port.tags == jax_.tags and port.weights == jax_.weights
    for words, _ in _pos_sample() + _ner_sample():
        assert port.best_sequence(words).tags == jax_.best_sequence(
            words).tags


def test_pos_tagger_sentence_and_pluggable_model():
    tagged = POSTagger().apply("The quick dogs are running quickly".split())
    got = dict(tagged.pairs())
    assert (got["The"], got["dogs"], got["are"], got["running"],
            got["quickly"]) == ("DT", "NNS", "VBP", "VBG", "RB")

    class Upper:
        def best_sequence(self, words):
            return TaggedSequence(list(words), ["X"] * len(words))

    assert POSTagger(Upper()).apply(["a", "b"]).tags == ["X", "X"]


def _accuracy(model):
    total = correct = 0
    for words, gold in _pos_sample():
        pred = model.best_sequence(words).tags
        assert len(pred) == len(words)
        total += len(words)
        correct += sum(g == p for g, p in zip(gold, pred))
    return correct / total, total


def test_pos_accuracy_floors():
    acc, total = _accuracy(RuleBasedPosModel())
    assert total > 400 and acc >= 0.80, acc
    acc, _ = _accuracy(tpos.load_pretrained())
    assert acc >= 0.95, acc
    assert isinstance(POSTagger().model, tpos.AveragedPerceptronPosModel)


def test_perceptron_pos_training_equals_the_jax_one():
    """Trained from the in-tree corpus with the same seed, both packages'
    perceptrons hold the same weights and tag the held-out sample alike."""
    train = tpos.read_tagged_file(os.path.join(RES, "pos_train_corpus.txt"))
    port = tpos.AveragedPerceptronPosModel.train(train, epochs=3)
    jax_ = jpos.AveragedPerceptronPosModel.train(train, epochs=3)
    assert port.tags == jax_.tags and port.weights == jax_.weights
    assert _accuracy(port)[0] >= 0.90


# -- NER -----------------------------------------------------------------------

def _f1(model):
    tp = fp = fn = 0
    for words, gold in _ner_sample():
        pred = model.best_sequence(words).labels
        assert len(pred) == len(words)
        for g, p in zip(gold, pred):
            if p != "O" and p == g:
                tp += 1
            elif p != "O":
                fp += 1
            if g != "O" and p != g:
                fn += 1
    precision, recall = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
    return 2 * precision * recall / max(precision + recall, 1e-12)


def test_ner_labels_and_spans_equal_the_jax_ones():
    for port, jax_ in ((RuleBasedNerModel(), jnlp.RuleBasedNerModel()),
                       (tner.load_pretrained(), jner.load_pretrained())):
        for words, _ in _ner_sample() + _pos_sample():
            got, want = port.best_sequence(words), jax_.best_sequence(words)
            assert got.spans == want.spans and got.labels == want.labels


def test_ner_floors_and_default():
    assert _f1(RuleBasedNerModel()) >= 0.90
    assert _f1(tner.load_pretrained()) >= 0.97
    assert isinstance(NER().model, tner.AveragedPerceptronNerModel)
    seg = NER().apply(
        "Yesterday Dr. Alice Smith flew to Paris with 3 colleagues".split())
    spans = {label: seg.words[s:e] for label, s, e in seg.spans}
    assert spans["PERSON"] == ["Dr.", "Alice", "Smith"]
    assert spans["LOCATION"] == ["Paris"]


def test_perceptron_ner_training_equals_the_jax_one():
    train = tner.read_labeled_file(os.path.join(RES, "ner_train_corpus.txt"))
    port = tner.AveragedPerceptronNerModel.train(train, epochs=3)
    jax_ = jner.AveragedPerceptronNerModel.train(train, epochs=3)
    assert port.labels == jax_.labels and port.weights == jax_.weights


def test_ner_adjacent_same_type_entities_merge_into_one_span():
    model = tner.AveragedPerceptronNerModel(
        weights={"w=alice": {"PERSON": 5.0}, "w=bob": {"PERSON": 5.0},
                 "w=visited": {"O": 5.0}, "w=paris": {"LOCATION": 5.0}},
        labels=["LOCATION", "O", "PERSON"])
    seg = model.best_sequence(["Alice", "Bob", "visited", "Paris"])
    assert seg.labels == ["PERSON", "PERSON", "O", "LOCATION"]
    assert seg.spans == [("PERSON", 0, 2), ("LOCATION", 3, 4)]


# -- the models' files -----------------------------------------------------------

def test_models_are_read_from_and_saved_to_the_ports_copy(tmp_path):
    data = os.path.join(REPO, "keystone_tpu_torch", "nodes", "nlp", "data")
    # load_pretrained() reads, and save() with no path writes, the port's
    # copy only
    for mod, cls, name in (
            (tpos, tpos.AveragedPerceptronPosModel, "pos_perceptron.json.gz"),
            (tner, tner.AveragedPerceptronNerModel, "ner_perceptron.json.gz")):
        assert mod._DATA_PATH == os.path.join(data, name)
        assert cls.save.__defaults__ == (os.path.join(data, name),)
        assert cls.load.__defaults__ == (os.path.join(data, name),)
    target = str(tmp_path / "pos.json.gz")
    model = tpos.AveragedPerceptronPosModel({"b": {"NN": 1.0}}, ["NN"])
    model.save(target)
    loaded = tpos.AveragedPerceptronPosModel.load(target)
    assert loaded.weights == model.weights and loaded.tags == model.tags


# -- CoreNLPFeatureExtractor -------------------------------------------------------

TEXTS = [
    "Alice visited Paris. The dogs were running.",
    "Cats sleep. Dogs bark.",
    "big red cars stopped",
    "He joined Acme Corp last year and studied at Berkeley in 1999!",
    "The C++ compilers were faster than ever; Dr. Smith said so.",
    "",
]


@pytest.mark.parametrize("orders", [[1], [2], [1, 2], [1, 2, 3]])
def test_extractor_output_equals_the_jax_one(orders):
    sentences = [" ".join(ws) for ws, _ in _pos_sample()[:20]]
    for text in TEXTS + sentences:
        assert CoreNLPFeatureExtractor(orders).apply(text) == \
            jnlp.CoreNLPFeatureExtractor(orders).apply(text), text


def test_extractor_lemmatizes_types_entities_and_keeps_sentences():
    out = CoreNLPFeatureExtractor([1]).apply(TEXTS[0])
    assert {"PERSON", "LOCATION", "dog", "run", "be"} <= set(out)
    assert "dogs" not in out
    out = CoreNLPFeatureExtractor([2]).apply(TEXTS[1])
    assert "cat sleep" in out and "dog bark" in out
    assert "sleep dog" not in out


def test_extractor_rejects_length_mismatched_model():
    class Short:
        def best_sequence(self, words):
            return TaggedSequence(list(words)[:-1], ["NN"] * (len(words) - 1))

    with pytest.raises(ValueError):
        CoreNLPFeatureExtractor([1], pos_model=Short()).apply("a b c d")


def test_eq_key_distinguishes_custom_models_by_token():
    class Custom:
        def best_sequence(self, words):
            return TaggedSequence(list(words), ["NN"] * len(words))

    model = Custom()
    a = CoreNLPFeatureExtractor([1], pos_model=model)
    b = CoreNLPFeatureExtractor([1], pos_model=Custom())
    assert a.eq_key() != b.eq_key()
    assert a.eq_key() == CoreNLPFeatureExtractor([1], pos_model=model).eq_key()
    assert CoreNLPFeatureExtractor([1]).eq_key() == \
        CoreNLPFeatureExtractor([1]).eq_key()
    rb = CoreNLPFeatureExtractor([1], RuleBasedPosModel(), RuleBasedNerModel())
    assert rb.eq_key() == CoreNLPFeatureExtractor(
        [1], RuleBasedPosModel(), RuleBasedNerModel()).eq_key()


def test_lemmatized_newsgroups_trains_end_to_end():
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
    from keystone_tpu_torch.pipelines.text.newsgroups import (
        NewsgroupsConfig,
        run,
    )

    docs = ["The spacecraft orbited Mars. Rockets launched daily.",
            "The pitchers threw fastballs. Baseball games ended late."] * 6
    labels = np.asarray([0, 1] * 6, np.int32)
    train = LabeledData(HostDataset(docs),
                        ArrayDataset.from_numpy(labels, "cpu"))
    _, ev = run(NewsgroupsConfig(n_grams=2, common_features=500,
                                 lemmatize=True),
                train=train, test=train, num_classes=2, device="cpu")
    assert ev.total_error < 0.2
