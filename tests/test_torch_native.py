"""The port's native host shim (``keystone_tpu_torch/native``) against the
JAX package's shim and against its own pure-Python branches.

Mirrors ``tests/test_native.py``. The shim compiles the repository's
``native/keystone_native.cpp`` with ``g++`` into a build directory (here
a temporary one) and never writes under ``native/``, whose library
belongs to the JAX package. Hashes, decoded records and parsed values
must be equal, not close. ``CALLS`` must name the branch that served
each call.
"""
import hashlib
import os

import numpy as np
import pytest

import keystone_tpu.native as jn
import keystone_tpu_torch.native as tn
from keystone_tpu.nodes.nlp.hashing import java_string_hash as jhash
from keystone_tpu_torch.loaders.surrogate import make_newsgroups_corpus
from keystone_tpu_torch.nodes.nlp import NGramsHashingTF, Tokenizer
from keystone_tpu_torch.nodes.nlp.hashing import ngram_feature_indices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
#: what the JAX package's own shim may write into native/ (its library,
#: built there on first use by its tests in another process)
JAX_ARTIFACTS = ("libkeystone_native.so",)
DEFAULT_BUILD_DIR = tn.BUILD_DIR

TOKENS = ["", "a", "Seq", "hello world", "wörld", "日本語", "🚀rocket",
          "x" * 300]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's shim built into a fresh temporary directory, with the
    listing and mtimes of ``native/`` before the build."""
    before = _native_listing()
    build_dir = tmp_path_factory.mktemp("native_build")
    saved = tn.BUILD_DIR, tn._lib, tn._load_failed, tn._build_error
    tn.BUILD_DIR, tn._lib, tn._load_failed, tn._build_error = (
        build_dir, None, False, None)
    try:
        assert tn.available(), tn.build_error()
        yield build_dir, before
    finally:
        tn.BUILD_DIR, tn._lib, tn._load_failed, tn._build_error = saved


@pytest.fixture
def python_branch(monkeypatch):
    """The shim with its library unavailable: every call takes the
    pure-Python branch."""
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_load_failed", True)


def _native_listing():
    return {name: os.stat(os.path.join(NATIVE, name)).st_mtime_ns
            for name in os.listdir(NATIVE)
            if not name.startswith(JAX_ARTIFACTS)}


def test_the_shim_builds_outside_native_and_leaves_it_as_it_was(built):
    build_dir, before = built
    path = tn.loaded_path()
    assert os.path.dirname(path) == str(build_dir)
    assert os.path.basename(path).startswith("libkeystone_native-")
    assert _native_listing() == before
    assert sorted(before) == ["Makefile", "keystone_native.cpp"]
    # by default the library goes to the repository's build/ tree
    assert str(DEFAULT_BUILD_DIR) == os.path.join(REPO, "build",
                                                  "keystone_tpu_torch")


def test_string_hashes_equal_the_jax_ones(built):
    tn.reset_calls()
    got = tn.java_hash_tokens(TOKENS)
    assert got.tolist() == [jhash(t) for t in TOKENS]
    if jn.available():
        assert got.tolist() == jn.java_hash_tokens(TOKENS).tolist()
    assert tn.CALLS["java_hash_tokens"] == {"native": 1, "python": 0}


def test_string_hashes_python_branch(python_branch):
    tn.reset_calls()
    assert tn.java_hash_tokens(TOKENS).tolist() == [jhash(t) for t in TOKENS]
    assert tn.CALLS["java_hash_tokens"] == {"native": 0, "python": 1}


@pytest.mark.parametrize("orders", [[1], [1, 2], [2, 3, 4]])
def test_ngram_features_native_python_and_jax_agree(built, orders):
    docs, _ = make_newsgroups_corpus(40, seed=3)
    tn.reset_calls()
    for doc in docs + ["", "one", "the quick brown fox jumps over the lazy"]:
        tokens = Tokenizer().apply(doc)
        feats = tn.ngram_hash_features(tokens, orders, 1 << 14)
        lo, hi = min(orders), max(orders)
        np.testing.assert_array_equal(
            feats, ngram_feature_indices(tokens, lo, hi, 1 << 14))
        if jn.available():
            np.testing.assert_array_equal(
                feats, jn.ngram_hash_features(tokens, orders, 1 << 14))
    assert tn.CALLS["ngram_hash_features"] == {"native": 43, "python": 0}


def test_ngram_hashing_node_native_equals_python(built, monkeypatch):
    doc = "a b c a b a".split()
    node = NGramsHashingTF([1, 2], 64)
    with_native = node.apply(doc)
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_load_failed", True)
    tn.reset_calls()
    assert node.apply(doc) == with_native
    assert tn.CALLS["ngram_hash_features"] == {"native": 0, "python": 1}


def test_cifar_decode_equals_the_jax_one(built):
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, 7 * 3073, dtype=np.uint8).tobytes()
    tn.reset_calls()
    imgs, labels = tn.cifar_decode(raw)
    want_imgs, want_labels = jn.cifar_decode(raw)
    np.testing.assert_array_equal(imgs, want_imgs)
    np.testing.assert_array_equal(labels, want_labels)
    arr = np.frombuffer(raw, np.uint8).reshape(7, 3073)
    np.testing.assert_array_equal(
        imgs, arr[:, 1:].reshape(7, 3, 32, 32).transpose(0, 2, 3, 1))
    assert tn.CALLS["cifar_decode"]["native"] == 1
    with pytest.raises(ValueError):
        tn.cifar_decode(raw[:-1])


def test_cifar_decode_python_branch(python_branch):
    raw = np.random.RandomState(1).randint(
        0, 256, 3 * 3073, dtype=np.uint8).tobytes()
    imgs, labels = tn.cifar_decode(raw)
    want_imgs, want_labels = jn.cifar_decode(raw)
    np.testing.assert_array_equal(imgs, want_imgs)
    np.testing.assert_array_equal(labels, want_labels)
    assert tn.CALLS["cifar_decode"]["python"] >= 1


def test_csv_parse(tmp_path, built):
    p = tmp_path / "m.csv"
    p.write_text("1.5,2.25,3\n-4,5e-3,6\n")
    tn.reset_calls()
    out = tn.csv_parse(str(p))
    np.testing.assert_array_equal(out, jn.csv_parse(str(p)))
    np.testing.assert_allclose(out, [[1.5, 2.25, 3], [-4, 5e-3, 6]])
    assert tn.CALLS["csv_parse"] == {"native": 1, "python": 0}


def test_csv_parse_rejects_empty_trailing_field(tmp_path, built):
    # "1,\n2,\n" has an empty trailing field a row; the strict parser
    # refuses it and numpy raises
    p = tmp_path / "bad.csv"
    p.write_text("1,\n2,\n")
    with pytest.raises(ValueError):
        tn.csv_parse(str(p), num_cols=2)


def test_a_failed_build_names_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_load_failed", False)
    monkeypatch.setattr(tn, "_build_error", None)
    assert not tn.available()
    assert "g++ failed" in tn.build_error()
    assert not list((tmp_path / "out").glob("*.so"))


def test_perceptron_models_are_the_jax_files_byte_for_byte():
    for name in ("pos_perceptron.json.gz", "ner_perceptron.json.gz"):
        digests = [hashlib.sha256(open(os.path.join(
            REPO, pkg, "nodes", "nlp", "data", name), "rb").read()
        ).hexdigest() for pkg in ("keystone_tpu", "keystone_tpu_torch")]
        assert digests[0] == digests[1], name
