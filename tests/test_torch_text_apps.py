"""The port's text and NLP apps and their loaders against the JAX
package's.

Mirrors ``tests/test_text_pipelines.py``. The three apps run on
``bench.py``'s small corpora (Newsgroups and Amazon 512 / 128 documents,
StupidBackoff 4,000 lines, as ``loaders/surrogate.py`` copies them) in
both packages, the port with ``device="cpu"``: the same predictions, the
same test error, the same language-model scores. The loaders read
directories and JSON-lines files the surrogate's writers lay out: the
same texts and labels in the same order. Each app's ``main`` runs from
files through ``python -m keystone_tpu_torch``'s dispatch with
``--device cpu`` and raises without a card when no device is given.
"""
import json

import bench
import numpy as np
import pytest
import torch

from keystone_tpu.loaders import (
    amazon_reviews_loader as j_amazon_loader,
    newsgroups_loader as j_newsgroups_loader,
)
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.parallel.dataset import (
    ArrayDataset as JArrayDataset,
    HostDataset as JHostDataset,
)
from keystone_tpu.pipelines.nlp import stupid_backoff_pipeline as jsb
from keystone_tpu.pipelines.text import amazon_reviews as jam
from keystone_tpu.pipelines.text import newsgroups as jng
from keystone_tpu_torch import __main__ as tmain
from keystone_tpu_torch.loaders import (
    NEWSGROUPS_CLASSES,
    amazon_reviews_loader,
    newsgroups_loader,
)
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import (
    make_amazon_corpus,
    make_backoff_corpus,
    make_newsgroups_corpus,
    write_amazon_reviews,
    write_newsgroups_split,
)
from keystone_tpu_torch.parallel.dataset import (
    ArrayDataset,
    HostDataset,
    to_numpy,
)
from keystone_tpu_torch.pipelines.nlp import stupid_backoff_pipeline as sb
from keystone_tpu_torch.pipelines.text import amazon_reviews as am
from keystone_tpu_torch.pipelines.text import newsgroups as ng
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _both(make, n, seed):
    docs, y = make(n, seed)
    return (JLabeledData(JHostDataset(docs), JArrayDataset.from_numpy(y)),
            LabeledData(HostDataset(docs), ArrayDataset.from_numpy(y, CPU)))


# -- the corpora -------------------------------------------------------------

class _Captured(Exception):
    pass


def _bench_inputs(monkeypatch, bench_fn, module):
    """The data ``bench_fn`` hands its app's ``run`` (at the bench's
    small size), captured before anything runs."""
    seen = {}

    def capture(config, *args, **kw):
        seen["config"], seen["args"], seen["kw"] = config, args, kw
        raise _Captured

    monkeypatch.setattr(bench, "SMALL", True)
    monkeypatch.setattr(module, "run", capture)
    with pytest.raises(_Captured):
        bench_fn()
    return seen


def test_newsgroups_and_amazon_corpora_are_bench_pys(monkeypatch):
    for bench_fn, module, make in (
            (bench.newsgroups_bench, jng, make_newsgroups_corpus),
            (bench.amazon_bench, jam, make_amazon_corpus)):
        seen = _bench_inputs(monkeypatch, bench_fn, module)
        train, test = seen["kw"]["train"], seen["kw"]["test"]
        assert (len(train.data), len(test.data)) == (512, 128)
        for data, seed in ((train, 1), (test, 2)):
            docs, y = make(len(data.data), seed)
            assert docs == data.data.collect()
            np.testing.assert_array_equal(y, np.asarray(data.labels.numpy()))


def test_backoff_corpus_is_bench_pys(monkeypatch):
    seen = _bench_inputs(monkeypatch, bench.stupid_backoff_bench, jsb)
    lines = seen["kw"]["text"].collect()
    assert lines == make_backoff_corpus(len(lines))
    assert seen["config"].n == 3


# -- the apps against the JAX package ----------------------------------------------

def test_newsgroups_equals_the_jax_app():
    (jtr, tr), (jte, te) = (_both(make_newsgroups_corpus, 512, 1),
                            _both(make_newsgroups_corpus, 128, 2))
    config = dict(n_grams=2, common_features=100_000)
    jpred, jev = jng.run(jng.NewsgroupsConfig(**config), jtr, jte,
                         num_classes=20)
    pred, ev = ng.run(ng.NewsgroupsConfig(**config), tr, te, num_classes=20,
                      device=CPU)
    np.testing.assert_array_equal(to_numpy(pred(te.data)),
                                  np.asarray(jpred(jte.data).numpy()))
    assert ev.total_error == jev.total_error
    assert 0.02 < ev.total_error < 0.90


def test_amazon_reviews_equals_the_jax_app():
    (jtr, tr), (jte, te) = (_both(make_amazon_corpus, 512, 1),
                            _both(make_amazon_corpus, 128, 2))
    jpred, jev = jam.run(jam.AmazonReviewsConfig(), jtr, jte)
    pred, ev = am.run(am.AmazonReviewsConfig(), tr, te, device=CPU)
    assert am.AmazonReviewsConfig().num_iters == 20
    np.testing.assert_array_equal(
        to_numpy(pred(te.data)).ravel(),
        np.asarray(jpred(jte.data).numpy()).ravel())
    assert (ev.tp, ev.fp, ev.tn, ev.fn) == (jev.tp, jev.fp, jev.tn, jev.fn)
    assert 0.02 < ev.error < 0.90


def test_stupid_backoff_equals_the_jax_app():
    lines = make_backoff_corpus(4_000)
    model = sb.run(sb.StupidBackoffConfig(n=3), HostDataset(lines),
                   device=CPU)
    jmodel = jsb.run(jsb.StupidBackoffConfig(n=3), JHostDataset(lines))
    assert model.scores == jmodel.scores
    assert model.num_tokens == jmodel.num_tokens == 80_000
    assert model.unigram_counts == jmodel.unigram_counts


# -- the loaders ------------------------------------------------------------------

@pytest.fixture(scope="module")
def newsgroups_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("news")
    for split, (n, seed) in (("train", (96, 1)), ("test", (40, 2))):
        docs, y = make_newsgroups_corpus(n, seed)
        write_newsgroups_split(str(d / split), docs, y)
    (d / "train" / NEWSGROUPS_CLASSES[0] / "notes").mkdir()  # not a file
    return d


def test_newsgroups_loader_equals_the_jax_one(newsgroups_dirs):
    for split in ("train", "test"):
        path = str(newsgroups_dirs / split)
        got, want = newsgroups_loader(path, device=CPU), j_newsgroups_loader(
            path)
        assert got.data.collect() == want.data.collect()
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels.numpy()))
        assert got.labels.device == torch.device(CPU)
    classes = ["rec.autos", "nope", "sci.med"]
    got = newsgroups_loader(str(newsgroups_dirs / "train"), classes, CPU)
    want = j_newsgroups_loader(str(newsgroups_dirs / "train"), classes)
    assert got.data.collect() == want.data.collect()
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels.numpy()))
    # a split written from the corpus loads its documents back, class by
    # class in corpus order
    docs, y = make_newsgroups_corpus(96, 1)
    loaded = newsgroups_loader(str(newsgroups_dirs / "train"), device=CPU)
    order = np.argsort(y, kind="stable")
    assert loaded.data.collect() == [docs[i] for i in order]


def test_amazon_loader_equals_the_jax_one(tmp_path):
    reviews, y = make_amazon_corpus(50, 3)
    write_amazon_reviews(str(tmp_path / "a.json"), reviews[:30], y[:30])
    write_amazon_reviews(str(tmp_path / "b.json"), reviews[30:], y[30:],
                         seed=1)
    (tmp_path / "notes.txt").write_text("not read")
    for path in (str(tmp_path), str(tmp_path / "a.json"),
                 str(tmp_path / "*.json")):
        for threshold in (3.5, 2.0):
            got = amazon_reviews_loader(path, threshold, device=CPU)
            want = j_amazon_loader(path, threshold)
            assert got.data.collect() == want.data.collect()
            np.testing.assert_array_equal(got.labels.numpy(),
                                          np.asarray(want.labels.numpy()))
    got = amazon_reviews_loader(str(tmp_path), device=CPU)
    assert got.data.collect() == reviews
    np.testing.assert_array_equal(got.labels.numpy(), y)
    stars = [json.loads(line)["overall"]
             for line in open(tmp_path / "a.json")]
    assert set(stars) <= {1.0, 2.0, 3.0, 4.0, 5.0}


# -- the mains from files ------------------------------------------------------------

def _printed(capsys, prefix):
    out = capsys.readouterr().out
    return next(line for line in out.splitlines() if line.startswith(prefix))


def test_newsgroups_main_reads_directories(newsgroups_dirs, capsys):
    d = newsgroups_dirs
    assert tmain.main(["text.newsgroups", "--trainLocation", str(d / "train"),
                       "--testLocation", str(d / "test"), "--commonFeatures",
                       "5000", "--device", "cpu"]) == 0
    err = float(_printed(capsys, "TEST Error is").split()[-1].rstrip("%"))
    config = ng.NewsgroupsConfig(str(d / "train"), str(d / "test"),
                                 common_features=5000)
    PipelineEnv.reset()
    _, ev = ng.run(config, device=CPU)
    assert err == pytest.approx(100 * ev.total_error, abs=0.005)
    PipelineEnv.reset()
    _, jev = jng.run(jng.NewsgroupsConfig(str(d / "train"), str(d / "test"),
                                          common_features=5000))
    assert ev.total_error == jev.total_error


def test_amazon_main_reads_json_lines(tmp_path, capsys):
    for name, (n, seed) in (("train", (200, 1)), ("test", (60, 2))):
        reviews, y = make_amazon_corpus(n, seed)
        write_amazon_reviews(str(tmp_path / f"{name}.json"), reviews, y)
    argv = ["--trainLocation", str(tmp_path / "train.json"),
            "--testLocation", str(tmp_path / "test.json"), "--numIters", "8"]
    assert tmain.main(["text.amazon_reviews", *argv, "--device", "cpu"]) == 0
    assert "TEST Error is" in capsys.readouterr().out
    PipelineEnv.reset()
    _, ev = am.run(am.AmazonReviewsConfig(str(tmp_path / "train.json"),
                                          str(tmp_path / "test.json"),
                                          num_iters=8), device=CPU)
    _, jev = jam.run(jam.AmazonReviewsConfig(str(tmp_path / "train.json"),
                                             str(tmp_path / "test.json"),
                                             num_iters=8))
    assert (ev.tp, ev.fp, ev.tn, ev.fn) == (jev.tp, jev.fp, jev.tn, jev.fn)


def test_stupid_backoff_main_reads_a_text_file(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(
        "the cat sat on the mat\nthe cat ran\n\nthe dog sat on the rug\n")
    assert tmain.main(["nlp.stupid_backoff", "--trainData", str(corpus),
                       "--device", "cpu"]) == 0
    assert _printed(capsys, "number of tokens") == "number of tokens: 15"
    model = sb.run(sb.StupidBackoffConfig(str(corpus), n=3), device=CPU)
    jmodel = jsb.run(jsb.StupidBackoffConfig(str(corpus), n=3))
    assert len(model.unigram_counts) == 8
    assert model.scores == jmodel.scores


@pytest.mark.parametrize("app", ["text.newsgroups", "text.amazon_reviews",
                                 "nlp.stupid_backoff"])
def test_text_mains_raise_without_a_card(app, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b c\n")
    argv = (["--trainData", str(corpus)] if app == "nlp.stupid_backoff"
            else ["--trainLocation", str(tmp_path), "--testLocation",
                  str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main([app, *argv])
