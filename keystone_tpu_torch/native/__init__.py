"""ctypes bindings for the native host runtime, ``native/keystone_native.cpp``.

Counterpart of ``keystone_tpu/native/__init__.py`` (the reference loads
its C++ code over JNI). Host code, not a device kernel: the CIFAR record
decode (and ``cifar_decode_u8``, numpy only, which keeps the bytes), the JVM string hash and the rolling MurmurHash3 n-gram hash of
``nodes/nlp/hashing.py``, and a float32 CSV parse.

The library is compiled from the repository's C++ source with ``g++``
at first use, into ``BUILD_DIR`` (``build/keystone_tpu_torch/``, under a
name carrying a digest of the source and flags), never into ``native/``,
whose ``libkeystone_native.so`` belongs to the JAX package. Each entry
point has a pure-Python branch that gives the same values, taken when
the library cannot be built or loaded (``available()`` is False; the
compiler's output is in ``build_error()``). ``CALLS`` counts which
branch served each call, so a run can show that the native one did.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO_ROOT / "native" / "keystone_native.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "keystone_tpu_torch"
GXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared")

#: entry point -> calls served by each branch
CALLS: Dict[str, Dict[str, int]] = {
    name: {"native": 0, "python": 0}
    for name in ("cifar_decode", "cifar_decode_u8", "java_hash_tokens",
                 "ngram_hash_features", "csv_parse")}

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_build_error: Optional[str] = None


def reset_calls() -> None:
    for branches in CALLS.values():
        for branch in branches:
            branches[branch] = 0


def _served(name: str, branch: str) -> None:
    CALLS[name][branch] += 1


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return Path(BUILD_DIR) / f"libkeystone_native-{digest}.so"


def build(quiet: bool = True) -> Path:
    """Compile the library into ``BUILD_DIR`` and return its path. The
    compiler writes a temporary file that is renamed into place, so
    concurrent first uses never leave a torn library. ``quiet`` False
    lets the compiler write to the terminal. Raises ``RuntimeError`` on
    failure, with the compiler's output where it was captured."""
    target = library_path()
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=quiet, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed (exit {proc.returncode}):\n{proc.stderr or ''}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _declare(lib: ctypes.CDLL) -> None:
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.cifar_decode.restype = None
    lib.cifar_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, f32, i32]
    lib.java_string_hash.restype = ctypes.c_int32
    lib.java_string_hash.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.java_string_hash_batch.restype = None
    lib.java_string_hash_batch.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_int64, i32]
    lib.ngram_hash_doc.restype = ctypes.c_int64
    lib.ngram_hash_doc.argtypes = [
        i32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32, ctypes.c_int64]
    lib.csv_parse_f32.restype = ctypes.c_int64
    lib.csv_parse_f32.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32,
                                  ctypes.c_int64]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, _build_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        path = library_path()
        if not path.exists():
            path = build()
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:
        _load_failed, _build_error = True, str(e)
        return None
    _declare(lib)
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built (building it on first call)
    and loaded."""
    return _load() is not None


def loaded_path() -> Optional[str]:
    """The file the loaded library came from, or None."""
    lib = _load()
    return None if lib is None else lib._name


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load()
    return _build_error


# ---------------- CIFAR decode ----------------

def cifar_decode(raw: bytes, rows: int = 32, cols: int = 32, chans: int = 3):
    """CIFAR binary records -> (images float32 (n, rows, cols, chans) in
    [0, 255], labels int32 (n,))."""
    rec = 1 + rows * cols * chans
    if len(raw) % rec:
        raise ValueError("corrupt CIFAR buffer: not a whole number of "
                         f"{rec}-byte records")
    n = len(raw) // rec
    lib = _load()
    if lib is not None:
        _served("cifar_decode", "native")
        images = np.empty((n, rows, cols, chans), np.float32)
        labels = np.empty(n, np.int32)
        lib.cifar_decode(raw, n, rows, cols, chans, images, labels)
        return images, labels
    _served("cifar_decode", "python")
    arr = np.frombuffer(raw, np.uint8).reshape(n, rec)
    labels = arr[:, 0].astype(np.int32)
    planes = arr[:, 1:].reshape(n, chans, rows, cols)
    return planes.transpose(0, 2, 3, 1).astype(np.float32), labels


def cifar_decode_u8(raw: bytes, rows: int = 32, cols: int = 32,
                    chans: int = 3):
    """CIFAR binary records -> (images uint8 (n, rows, cols, chans),
    labels int32 (n,)), without widening the pixels to float: the
    byte-packed form the JAX package's ``cifar_decode_u8`` keeps (the
    reference's ``RowColumnMajorByteArrayVectorizedImage``); the float
    cast happens on the device. The images are row-major and contiguous
    (the device kernels read rows in place). numpy only, as in the JAX
    package."""
    rec = 1 + rows * cols * chans
    if len(raw) % rec:
        raise ValueError("corrupt CIFAR buffer: not a whole number of "
                         f"{rec}-byte records")
    _served("cifar_decode_u8", "python")
    arr = np.frombuffer(raw, np.uint8).reshape(len(raw) // rec, rec)
    labels = arr[:, 0].astype(np.int32)
    planes = arr[:, 1:].reshape(-1, chans, rows, cols)
    return np.ascontiguousarray(planes.transpose(0, 2, 3, 1)), labels


# ---------------- text hashing ----------------

def _native_hashes(lib: ctypes.CDLL, tokens: Sequence[str]) -> np.ndarray:
    encoded = [t.encode("utf-8") for t in tokens]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    out = np.empty(len(encoded), np.int32)
    lib.java_string_hash_batch(b"".join(encoded), offsets, len(encoded), out)
    return out


def java_hash_tokens(tokens: Sequence[str]) -> np.ndarray:
    """JVM ``String.hashCode`` of each token (int32)."""
    lib = _load()
    if lib is not None:
        _served("java_hash_tokens", "native")
        return _native_hashes(lib, tokens)
    from ..nodes.nlp.hashing import java_string_hash

    _served("java_hash_tokens", "python")
    return np.asarray([java_string_hash(t) for t in tokens], np.int32)


def ngram_hash_features(tokens: Sequence[str], orders: Sequence[int],
                        num_features: int) -> np.ndarray:
    """The feature index of every n-gram of the given orders, in
    ``NGramsHashingTF``'s order (int32, with repeats): its native core."""
    from ..nodes.nlp.hashing import SEQ_SEED, ngram_feature_indices

    lo, hi = min(orders), max(orders)
    n = len(tokens)
    lib = _load()
    if lib is None:
        _served("ngram_hash_features", "python")
        return np.asarray(ngram_feature_indices(tokens, lo, hi, num_features),
                          np.int32)
    _served("ngram_hash_features", "native")
    if n < lo:
        return np.zeros(0, np.int32)
    hashes = _native_hashes(lib, tokens)
    cap = (n - lo + 1) * (hi - lo + 1)
    out = np.empty(cap, np.int32)
    wrote = lib.ngram_hash_doc(hashes, n, lo, hi, num_features, SEQ_SEED,
                               out, cap)
    return out[:wrote]


# ---------------- CSV ----------------

def csv_parse(path: str, num_cols: Optional[int] = None) -> np.ndarray:
    """A float CSV file as an (n, num_cols) float32 array. A file the
    strict native parser refuses (an empty field, ragged rows) goes to
    ``np.loadtxt``, which raises a descriptive error."""
    with open(path, "rb") as f:
        buf = f.read()
    lib = _load()
    if lib is not None:
        cols = num_cols or (buf.split(b"\n", 1)[0].count(b",") + 1)
        cap = buf.count(b",") + buf.count(b"\n") + 2
        out = np.empty(cap, np.float32)
        wrote = lib.csv_parse_f32(buf, len(buf), out, cap)
        if wrote >= 0 and wrote % cols == 0:
            _served("csv_parse", "native")
            return out[:wrote].reshape(-1, cols)
    _served("csv_parse", "python")
    return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
