"""The port's NLP nodes, TermFrequency and text vectorizers against the
JAX package's.

Mirrors ``tests/test_nlp_nodes.py`` (the reference's TokenizerSuite,
NGramsFeaturizerSuite, NGramsHashingTFSuite, WordFrequencyEncoderSuite,
StupidBackoffSuite, NaiveBitPackIndexerSuite) and feeds the same seeded
inputs (``bench.py``'s text corpora, as ``loaders/surrogate.py`` copies
them) through both packages. Everything here is host work on strings,
ints and dicts, so every comparison is exact: tokens, n-grams, term
frequency pairs, hashes, the ``CommonSparseFeatures`` feature -> index
map, SparseVector indices and values, and Stupid Backoff scores.
"""
import pickle

import numpy as np
import pytest

import keystone_tpu.nodes.nlp as jnlp
from keystone_tpu.nodes.stats import TermFrequency as JTermFrequency
from keystone_tpu.nodes.util import (
    AllSparseFeatures as JAllSparseFeatures,
    CommonSparseFeatures as JCommonSparseFeatures,
)
from keystone_tpu.parallel.dataset import HostDataset as JHostDataset
from keystone_tpu_torch.loaders.surrogate import (
    make_amazon_corpus,
    make_backoff_corpus,
    make_newsgroups_corpus,
)
from keystone_tpu_torch.nodes.nlp import (
    HashingTF,
    LowerCase,
    NaiveBitPackIndexer,
    NGram,
    NGramsCounts,
    NGramsFeaturizer,
    NGramsHashingTF,
    NO_ADD_MODE,
    StupidBackoffEstimator,
    Tokenizer,
    Trim,
    WordFrequencyEncoder,
    java_string_hash,
    scala_hash,
)
from keystone_tpu_torch.nodes.stats import TermFrequency
from keystone_tpu_torch.nodes.util import (
    AllSparseFeatures,
    CommonSparseFeatures,
    SparseFeatureVectorizer,
    SparseVector,
    Sparsify,
    sparse_batch,
)
from keystone_tpu_torch.parallel.dataset import HostDataset
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.fixture(scope="module")
def docs():
    """Raw documents: the Newsgroups and Amazon corpora, and odd text."""
    news, _ = make_newsgroups_corpus(64, seed=1)
    reviews, _ = make_amazon_corpus(32, seed=2)
    odd = ["  Hello, World! it's FINE  ", "a__b--c", "", "trailing,,, ",
           "Ünïcödé wörds, 日本語 and 🚀rocket", "1999 was 2.5x faster"]
    return news + reviews + odd


def _featurize(mod, docs, orders, tf):
    """Trim -> LowerCase -> Tokenizer -> NGrams -> TermFrequency in
    ``mod``'s package, item by item."""
    trim, lower, tok = mod.Trim(), mod.LowerCase(), mod.Tokenizer()
    grams = mod.NGramsFeaturizer(orders)
    return [tf.apply(grams.apply(tok.apply(lower.apply(trim.apply(d)))))
            for d in docs]


# -- string stages -----------------------------------------------------------

def test_tokenizer_trim_lowercase():
    assert Trim().apply("  hi there ") == "hi there"
    assert LowerCase().apply("MiXeD") == "mixed"
    assert Tokenizer().apply("Hello, world! it's fine") == [
        "Hello", "world", "it", "s", "fine"]
    assert Tokenizer(r"\s+").apply("a b  c") == ["a", "b", "c"]


def test_tokens_and_ngrams_equal_the_jax_ones(docs):
    for sep in (r"[\W_\s]+", r"\s+"):
        for d in docs:
            assert Tokenizer(sep).apply(d) == jnlp.Tokenizer(sep).apply(d)
            assert Trim().apply(d) == jnlp.Trim().apply(d)
            assert LowerCase().apply(d) == jnlp.LowerCase().apply(d)
    tokens = [Tokenizer().apply(d.lower()) for d in docs]
    for orders in ([1], [1, 2], [2, 3], [1, 2, 3, 4]):
        for t in tokens:
            got = NGramsFeaturizer(orders).apply(t)
            assert got == jnlp.NGramsFeaturizer(orders).apply(t)
            assert all(type(g) is NGram for g in got)


def test_tokenizer_pickles_without_its_regex():
    tok = pickle.loads(pickle.dumps(Tokenizer(r"\s+")))
    assert tok.apply("a b") == ["a", "b"]


def test_ngrams_featurizer_orders():
    grams = NGramsFeaturizer([1, 2, 3]).apply(["a", "b", "c"])
    assert grams == [("a",), ("a", "b"), ("a", "b", "c"),
                     ("b",), ("b", "c"), ("c",)]
    assert NGramsFeaturizer([2]).apply(["a", "b", "c"]) == [
        ("a", "b"), ("b", "c")]


def test_ngrams_featurizer_rejects_bad_orders():
    with pytest.raises(AssertionError):
        NGramsFeaturizer([1, 3])
    with pytest.raises(AssertionError):
        NGramsFeaturizer([0, 1])


@pytest.mark.parametrize("mode", ["default", NO_ADD_MODE])
def test_ngrams_counts_equal_the_jax_ones(docs, mode):
    grams = [NGramsFeaturizer([1, 2]).apply(Tokenizer().apply(d))
             for d in docs]
    got = NGramsCounts(mode).apply_dataset(HostDataset(grams)).collect()
    want = jnlp.NGramsCounts(mode).apply_dataset(
        JHostDataset(grams)).collect()
    assert got == want
    if mode == "default":
        assert [c for _, c in got] == sorted((c for _, c in got),
                                             reverse=True)


def test_ngrams_counts_sorted_desc():
    docs = HostDataset([NGramsFeaturizer([1]).apply("a b a c a b".split())])
    pairs = NGramsCounts().apply_dataset(docs).collect()
    assert pairs[:3] == [(NGram(("a",)), 3), (NGram(("b",)), 2),
                         (NGram(("c",)), 1)]


# -- hashing -----------------------------------------------------------------

def test_java_string_hash():
    # values of the JVM's String.hashCode
    assert java_string_hash("Seq") == 83007
    assert java_string_hash("a") == 97
    assert java_string_hash("ab") == 3105
    assert java_string_hash("") == 0


def test_hashes_equal_the_jax_ones(docs):
    rng = np.random.RandomState(0)
    terms = [t for d in docs for t in Tokenizer(r"\s+").apply(d)]
    terms += ["", "Seq", "wörld", "日本語", "🚀rocket", "x" * 100]
    ints = [int(v) for v in rng.randint(-2**40, 2**40, 64)] + [0, -1,
                                                              2**31, 2**32]
    grams = [tuple(terms[i:i + n]) for n in (1, 2, 3, 5)
             for i in range(0, 40, 3)] + [tuple(ints[:4]), ()]
    for t in terms:
        assert java_string_hash(t) == jnlp.java_string_hash(t), t
    for term in terms + ints + grams:
        h = scala_hash(term)
        assert h == jnlp.scala_hash(term), term
        assert -2**31 <= h < 2**31 and type(h) is int
    from keystone_tpu.nodes.nlp import hashing as jh
    from keystone_tpu_torch.nodes.nlp import hashing as th

    assert th.SEQ_SEED == jh.SEQ_SEED
    for h, k in zip(rng.randint(0, 2**32, 64, dtype=np.uint64),
                    rng.randint(0, 2**32, 64, dtype=np.uint64)):
        h, k = int(h), int(k)
        assert th.murmur_mix(h, k) == jh.murmur_mix(h, k)
        assert th.murmur_mix_last(h, k) == jh.murmur_mix_last(h, k)
        assert th.murmur_finalize(h, k % 9) == jh.murmur_finalize(h, k % 9)
        assert th.non_negative_mod(h - 2**31, 1000) == jh.non_negative_mod(
            h - 2**31, 1000)


@pytest.mark.parametrize("orders", [[1], [1, 2], [2, 3], [1, 2, 3, 4]])
def test_ngrams_hashing_tf_equals_the_jax_one(docs, orders):
    for d in docs:
        tokens = Tokenizer().apply(d)
        got = NGramsHashingTF(orders, 1 << 12).apply(tokens)
        want = jnlp.NGramsHashingTF(orders, 1 << 12).apply(tokens)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.size == want.size
        staged = HashingTF(1 << 12).apply(NGramsFeaturizer(orders).apply(
            tokens))
        assert got == staged


def test_hashing_tf_counts():
    sv = HashingTF(1000).apply(["x", "y", "x"])
    assert sv.size == 1000 and sv.values.sum() == 3.0
    want = jnlp.HashingTF(1000).apply(["x", "y", "x"])
    np.testing.assert_array_equal(sv.indices, want.indices)


# -- term frequency and vectorizers ---------------------------------------------

def test_term_frequency_weighting():
    out = TermFrequency(lambda x: np.log(x) + 1).apply(["a", "a", "b"])
    assert out[0][0] == "a" and abs(out[0][1] - (np.log(2) + 1)) < 1e-12
    assert out[1] == ("b", 1.0)


def test_term_frequency_pairs_equal_the_jax_ones(docs):
    for fun in (None, lambda x: 1, lambda x: np.log(x) + 1):
        got = _featurize(jnlp, docs, [1, 2], TermFrequency(fun))
        want = _featurize(jnlp, docs, [1, 2], JTermFrequency(fun))
        assert got == want
    assert TermFrequency().apply([["a", "b"], ("a", "b"), "c"]) == [
        (("a", "b"), 2.0), ("c", 1.0)]


def test_common_sparse_features_map_equals_the_jax_one():
    """The whole feature -> index map at the Newsgroups app's settings
    (bigrams, binary term frequency) on bench.py's 512-document corpus,
    with a cut that falls inside a run of equal counts."""
    docs, _ = make_newsgroups_corpus(512, seed=1)
    pairs = _featurize(jnlp, docs, [1, 2], TermFrequency(lambda x: 1))
    for k in (100_000, 3_000, 37):
        got = CommonSparseFeatures(k).fit(HostDataset(pairs))
        want = JCommonSparseFeatures(k).fit(JHostDataset(pairs))
        assert list(got.feature_space.items()) == list(
            want.feature_space.items())
        for p in pairs[:64]:
            sv, jsv = got.apply(p), want.apply(p)
            np.testing.assert_array_equal(sv.indices, jsv.indices)
            np.testing.assert_array_equal(sv.values, jsv.values)
            assert sv.size == jsv.size == len(got.feature_space)


def test_all_sparse_features_map_equals_the_jax_one():
    docs, _ = make_amazon_corpus(128, seed=1)
    pairs = _featurize(jnlp, docs, [1, 2], TermFrequency(lambda x: 1))
    got = AllSparseFeatures().fit(HostDataset(pairs))
    want = JAllSparseFeatures().fit(JHostDataset(pairs))
    assert list(got.feature_space.items()) == list(
        want.feature_space.items())


def test_sparse_vectorizer_and_common_features():
    data = HostDataset([
        [("a", 1.0), ("b", 2.0)],
        [("a", 1.0), ("c", 1.0)],
        [("a", 1.0), ("b", 1.0)],
    ])
    vec = CommonSparseFeatures(2).fit(data)
    sv = vec.apply([("a", 5.0), ("c", 9.0), ("b", 1.0)])
    assert sv.size == 2
    np.testing.assert_array_equal(sv.indices, [0, 1])
    np.testing.assert_array_equal(sv.values, [5.0, 1.0])
    vec_all = AllSparseFeatures().fit(data)
    assert vec_all.apply([("c", 1.0)]).todense().tolist() == [0.0, 0.0, 1.0]
    # list n-gram keys are tuples
    vec = SparseFeatureVectorizer({("a", "b"): 0})
    assert vec.apply([(["a", "b"], 2.0)]).values.tolist() == [2.0]


def test_sparse_vectorizer_is_keyed_by_a_token_not_by_id():
    """Two vectorizers over equal spaces are distinct nodes (the JAX
    package keys them by ``id()`` of the space, which a freed space can
    hand on: ROADMAP C1); one vectorizer keeps its key, and a pickled
    copy gets a fresh one."""
    a = SparseFeatureVectorizer({"x": 0})
    b = SparseFeatureVectorizer({"x": 0})
    assert a.eq_key() != b.eq_key()
    assert a.eq_key() == a.eq_key() and a == a
    c = pickle.loads(pickle.dumps(a))
    assert "_keystone_token" not in c.__dict__
    assert c.eq_key() != a.eq_key()
    assert c.apply([("x", 3.0)]) == a.apply([("x", 3.0)])


def test_sparsify_and_batch():
    sv = Sparsify().apply(np.array([0.0, 3.0, 0.0, 2.0], np.float32))
    assert sv.nnz == 2
    idx, vals, size = sparse_batch([sv, SparseVector([0], [1.0], 4)])
    assert idx.shape == vals.shape == (2, 2) and size == 4
    np.testing.assert_array_equal(idx[0], [1, 3])
    np.testing.assert_array_equal(vals[1], [1.0, 0.0])


# -- word frequency, indexers, stupid backoff -----------------------------------

def test_word_frequency_encoder():
    docs = HostDataset(["b a a c a b".split(), "a d".split()])
    model = WordFrequencyEncoder().fit(docs)
    # 'a' x4 -> 0, 'b' x2 -> 1, then 'c', 'd' by first appearance
    assert model.apply(["a", "b", "c", "d", "zzz"]) == [0, 1, 2, 3, -1]
    assert model.unigram_counts[0] == 4
    assert model.unigram_counts[1] == 2


def test_word_frequency_encoder_equals_the_jax_one():
    tokens = [Tokenizer().apply(line) for line in make_backoff_corpus(300)]
    got = WordFrequencyEncoder().fit(HostDataset(tokens))
    want = jnlp.WordFrequencyEncoder().fit(JHostDataset(tokens))
    assert list(got.word_index.items()) == list(want.word_index.items())
    assert got.unigram_counts == want.unigram_counts
    assert [got.apply(t) for t in tokens] == [want.apply(t) for t in tokens]
    other = WordFrequencyEncoder().fit(HostDataset(tokens))
    assert got.eq_key() != other.eq_key()  # a token each, not id()


def test_naive_bitpack_indexer():
    idx = NaiveBitPackIndexer()
    jidx = jnlp.NaiveBitPackIndexer()
    for ngram in ([5], [5, 9], [5, 9, 123], [2**20 - 1, 0, 7]):
        packed = idx.pack(ngram)
        assert packed == jidx.pack(ngram)
        assert idx.ngram_order(packed) == len(ngram)
        for pos, w in enumerate(ngram):
            assert idx.unpack(packed, pos) == w
    tri = idx.pack([5, 9, 123])
    assert idx.ngram_order(idx.remove_farthest_word(tri)) == 2
    assert idx.unpack(idx.remove_farthest_word(tri), 0) == 9
    assert idx.unpack(idx.remove_current_word(tri), 1) == 9
    with pytest.raises(AssertionError):
        idx.pack([2**20])


def _fit_backoff(corpus, orders=(2, 3)):
    tokens = [line.split() for line in corpus]
    unigrams = {}
    for line in tokens:
        for w in line:
            unigrams[w] = unigrams.get(w, 0) + 1
    grams = HostDataset([NGramsFeaturizer(list(orders)).apply(t)
                         for t in tokens])
    counts = NGramsCounts().apply_dataset(grams)
    return StupidBackoffEstimator(unigrams).fit(counts), unigrams


def test_stupid_backoff_seen_trigram_and_backoff():
    model, unigrams = _fit_backoff(["a b c d", "a b c e"])
    n = sum(unigrams.values())
    assert model.score(NGram(("a", "b", "c"))) == pytest.approx(1.0)
    assert model.score(NGram(("b", "c", "d"))) == pytest.approx(0.5)
    assert model.score(NGram(("d", "b", "c"))) == pytest.approx(0.4 * 1.0)
    assert model.score(NGram(("e", "d", "a"))) == pytest.approx(
        0.4 * 0.4 * unigrams["a"] / n)
    for s in model.scores.values():
        assert 0.0 <= s <= 1.0


def test_stupid_backoff_scores_equal_the_jax_ones():
    lines = make_backoff_corpus(400)
    model, unigrams = _fit_backoff(lines)
    tokens = [line.split() for line in lines]
    jgrams = JHostDataset([jnlp.NGramsFeaturizer([2, 3]).apply(t)
                           for t in tokens])
    want = jnlp.StupidBackoffEstimator(unigrams).fit(
        jnlp.NGramsCounts().apply_dataset(jgrams))
    assert model.scores == want.scores
    assert model.num_tokens == want.num_tokens
    rng = np.random.RandomState(3)
    vocab = sorted(unigrams)
    for _ in range(200):  # unseen n-grams back off alike
        g = tuple(vocab[i] for i in rng.randint(0, len(vocab), 3))
        assert model.score(g) == want.score(g)
        assert model.apply((g, 1)) == want.apply((g, 1))
