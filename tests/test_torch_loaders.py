"""The port's tar and CSV loaders against the JAX package's.

Every tar and CSV is written by the test from seeded numpy arrays, at a
few images of 12 x 16 to 20 x 24 pixels. Both packages decode the same
bytes with the same PIL, so names, labels, order and image bits must be
equal (no tolerance), with 1 and 4 decode threads
(``KEYSTONE_TORCH_LOADER_THREADS`` for the port,
``KEYSTONE_LOADER_THREADS`` for the JAX package). The CSV loaders parse
with the same ``np.loadtxt``: equal values. The decode pool's threads
are joined on every exit; the tests wait at most 5 s for them.
"""
import io
import os
import sys
import tarfile
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from keystone_tpu.loaders import csv_loader as jcsv
from keystone_tpu.loaders import image_loader_utils as jilu
from keystone_tpu.loaders import imagenet as jinet
from keystone_tpu.loaders import voc as jvoc
from keystone_tpu.resilience import faults as jfaults
from keystone_tpu.resilience import quarantine as jquar
from keystone_tpu.resilience import retry as jretry
from keystone_tpu_torch import loaders
from keystone_tpu_torch.loaders import image_loader_utils as ilu
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.parallel.dataset import HostDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.resilience import (
    FaultPlan,
    Quarantine,
    QuarantineBudgetExceededError,
    RetryPolicy,
)


def _encode(img, fmt):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **(
        {"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _image(rng, h=12, w=16):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


def _archives(tmp_path, seed=0, n_tars=2, per_tar=5, prefix="",
              corrupt=()):
    """``n_tars`` tars of ``per_tar`` images (JPEG and PNG, two sizes)
    under ``prefix``, a labels.txt beside them; members whose global
    index is in ``corrupt`` hold garbage bytes. Returns the directory
    and the images by member name."""
    rng = np.random.RandomState(seed)
    images = {}
    k = 0
    for t in range(n_tars):
        members = []
        for i in range(per_tar):
            img = _image(rng, *((12, 16) if k % 2 else (20, 24)))
            name = f"{prefix}img{k:03d}.{'png' if k % 3 else 'jpg'}"
            data = (b"not an image" if k in corrupt
                    else _encode(img, "PNG" if k % 3 else "JPEG"))
            members.append((name, data))
            images[name] = img
            k += 1
        _write_tar(tmp_path / f"part{t}.tar", members)
    (tmp_path / "labels.txt").write_text("not an archive\n")
    return str(tmp_path), images


@pytest.fixture(autouse=True)
def postmortems_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR",
                       str(tmp_path / "postmortems"))
    monkeypatch.setenv("KEYSTONE_POSTMORTEM_DIR",
                       str(tmp_path / "jax-postmortems"))


@pytest.fixture(params=[1, 4], ids=["1-thread", "4-threads"])
def threads(request, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_LOADER_THREADS", str(request.param))
    monkeypatch.setenv("KEYSTONE_LOADER_THREADS", str(request.param))
    return request.param


def _decode_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("keystone-torch-decode")]


def _pool_joined():
    deadline = time.time() + 5.0
    while _decode_threads() and time.time() < deadline:
        time.sleep(0.01)
    return not _decode_threads()


def _same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.filename == w.filename
        assert getattr(g, "label", None) == getattr(w, "label", None)
        assert getattr(g, "labels", None) == getattr(w, "labels", None)
        assert g.image.dtype == w.image.dtype == np.float32
        assert np.array_equal(g.image, np.asarray(w.image))


# -- the tar loaders ---------------------------------------------------------

def test_load_tar_files_matches_jax(tmp_path, threads):
    root, _ = _archives(tmp_path)
    args = (lambda name: len(name), lambda img, label, name:
            ilu.LabeledImage(img, label, name))
    got = ilu.load_tar_files(ilu.list_archive_paths(root), *args).collect()
    want = jilu.load_tar_files(jilu.list_archive_paths(root), args[0],
                               lambda img, label, name: jilu.LabeledImage(
                                   img, label, name)).collect()
    assert [it.filename for it in got] == sorted(it.filename for it in got)
    _same_items(got, want)
    assert _pool_joined()


def test_iter_tar_images_matches_jax(tmp_path):
    root, images = _archives(tmp_path)
    path = os.path.join(root, "part1.tar")
    got = list(ilu.iter_tar_images(path))
    want = list(jilu.iter_tar_images(path))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)
        if name.endswith(".png"):
            assert np.array_equal(g, images[name])


def test_iter_decoded_chunks_matches_jax(tmp_path, threads):
    root, _ = _archives(tmp_path, n_tars=3, per_tar=4)
    paths = ilu.list_archive_paths(root)
    got = list(ilu.iter_decoded_chunks(paths, 5))
    want = list(jilu.iter_decoded_chunks(paths, 5))
    assert [len(c) for c in got] == [len(c) for c in want] == [5, 5, 2]
    for gc, wc in zip(got, want):
        assert [n for n, _ in gc] == [n for n, _ in wc]
        assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(gc, wc))
    assert _pool_joined()


def test_a_consumer_that_stops_early_joins_the_pool(tmp_path, threads):
    root, _ = _archives(tmp_path, n_tars=3, per_tar=6)
    gen = ilu.iter_decoded_chunks(ilu.list_archive_paths(root), 2)
    assert len(next(gen)) == 2
    gen.close()
    assert _pool_joined()


def _voc_layout(tmp_path, threads_dir):
    rng = np.random.RandomState(3)
    members, rows = [], ["header,cls,x,y,file"]
    for i in range(6):
        name = f"{i:06d}.jpg"
        members.append((f"VOCdevkit/VOC2007/JPEGImages/{name}",
                        _encode(_image(rng), "JPEG")))
        for c in sorted(set(rng.randint(1, 21, 2))):
            rows.append(f'x,{c},a,b,"{name}"')
    members.append(("VOCdevkit/VOC2007/Annotations/000000.xml", b"<xml/>"))
    members.append(("VOCdevkit/VOC2007/JPEGImages/unlabeled.jpg",
                    _encode(_image(rng), "JPEG")))
    d = tmp_path / threads_dir
    d.mkdir()
    _write_tar(d / "voc.tar", members[:4])
    _write_tar(d / "voc2.tar", members[4:])
    labels = tmp_path / "labels.csv"
    labels.write_text("\n".join(rows) + "\n")
    return str(d), str(labels)


def test_voc_loader_matches_jax(tmp_path, threads):
    data, labels = _voc_layout(tmp_path, "voc")
    prefix = "VOCdevkit/VOC2007/JPEGImages/"
    got = loaders.voc_loader(loaders.VOCDataPath(data, prefix),
                             loaders.VOCLabelPath(labels)).collect()
    want = jvoc.voc_loader(jvoc.VOCDataPath(data, prefix),
                           jvoc.VOCLabelPath(labels)).collect()
    assert len(got) == 7  # the annotation member is outside the prefix
    assert got[-1].labels == []  # a member missing from the CSV
    assert all(it.labels for it in got[:-1])
    _same_items(got, want)


def test_imagenet_loader_matches_jax(tmp_path, threads):
    rng = np.random.RandomState(5)
    classes = ["n01440764", "n01443537", "n01484850"]
    for t in range(2):
        _write_tar(tmp_path / f"train{t}.tar", [
            (f"{classes[(t + i) % 3]}/{classes[(t + i) % 3]}_{t}{i}.JPEG",
             _encode(_image(rng), "JPEG")) for i in range(4)])
    labels = tmp_path / "labels" / "map.txt"
    labels.parent.mkdir()
    labels.write_text("".join(f"{c} {i}\n" for i, c in enumerate(classes)))
    got = loaders.imagenet_loader(str(tmp_path), str(labels)).collect()
    want = jinet.imagenet_loader(str(tmp_path), str(labels)).collect()
    assert [it.label for it in got] == [
        classes.index(it.filename.split("/")[0]) for it in got]
    _same_items(got, want)


def test_a_non_archive_is_skipped_and_nothing_opened_raises(tmp_path,
                                                            caplog):
    root, _ = _archives(tmp_path, n_tars=1)
    paths = ilu.list_archive_paths(root)
    assert [os.path.basename(p) for p in paths] == ["labels.txt",
                                                    "part0.tar"]
    build = (lambda name: 0, lambda img, label, name: name)
    assert len(ilu.load_tar_files(paths, *build)) == 5
    assert "Skipping non-archive file" in caplog.text
    only = [os.path.join(root, "labels.txt")]
    with pytest.raises(tarfile.ReadError, match="None of 1 file"):
        ilu.load_tar_files(only, *build)
    with pytest.raises(tarfile.ReadError, match="None of 1 file"):
        jilu.load_tar_files(only, *build)
    assert _pool_joined()


def test_a_truncated_archive_keeps_what_was_read(tmp_path, threads, caplog):
    root, _ = _archives(tmp_path, n_tars=1, per_tar=6)
    path = os.path.join(root, "part0.tar")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    build = (lambda name: 0, lambda img, label, name: name)
    got = ilu.load_tar_files([path], *build).collect()
    want = jilu.load_tar_files([path], *build).collect()
    assert got == want and 0 < len(got) < 6
    assert "truncated/corrupt" in caplog.text


def test_list_archive_paths_takes_the_process_share(tmp_path, monkeypatch):
    root, _ = _archives(tmp_path, n_tars=3)
    assert ilu.list_archive_paths(root) == jilu.list_archive_paths(root)
    monkeypatch.setattr(ilu, "_process_share", lambda: (1, 2))
    assert [os.path.basename(p) for p in ilu.list_archive_paths(root)] == \
        ["part1.tar"]
    assert len(ilu.list_archive_paths(root, process_shard=False)) == 4
    monkeypatch.setattr(ilu, "_process_share", lambda: (3, 4))
    with pytest.raises(ValueError, match="process 3/4 has no archives"):
        ilu.list_archive_paths(root)


# -- decode, quarantine and retry -----------------------------------------------

def test_decode_image_matches_jax_and_refuses_without_pillow(monkeypatch):
    img = _image(np.random.RandomState(9))
    for fmt in ("PNG", "JPEG"):
        data = _encode(img, fmt)
        for dt in (np.float32, np.uint8):
            got = ilu.decode_image(data, dt)
            assert got.dtype == dt
            assert np.array_equal(got, jilu.decode_image(data, dt))
    assert ilu.decode_image(b"garbage") is None
    assert ilu.decode_image(_encode(img, "JPEG")[:40]) is None
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        ilu.decode_image(_encode(img, "PNG"))


def test_quarantine_counts_corrupt_members_like_jax(tmp_path, threads):
    root, _ = _archives(tmp_path, n_tars=2, per_tar=5, corrupt=(2, 7))
    paths = ilu.list_archive_paths(root)
    build = (lambda name: 0, lambda img, label, name: name)
    q = Quarantine(max_bad_fraction=0.5, min_records=1)
    jq = jquar.Quarantine(max_bad_fraction=0.5, min_records=1)
    got = ilu.load_tar_files(paths, *build, quarantine=q).collect()
    want = jilu.load_tar_files(paths, *build, quarantine=jq).collect()
    assert got == want and len(got) == 8
    assert (q.bad_count, q.ok_count) == (jq.bad_count, jq.ok_count) == (2, 8)
    assert sorted(r["source"] for r in q.records) == sorted(
        r["source"] for r in jq.records)


def test_a_blown_quarantine_budget_raises_and_joins_the_pool(tmp_path,
                                                             threads):
    root, _ = _archives(tmp_path, n_tars=2, per_tar=6, corrupt=(1, 3, 5))
    q = Quarantine(max_bad_fraction=0.1, min_records=1)
    with pytest.raises(QuarantineBudgetExceededError):
        list(ilu.iter_decoded_chunks(ilu.list_archive_paths(root), 4,
                                     quarantine=q))
    assert _pool_joined()


@pytest.mark.parametrize("site", ["ingest.read", "ingest.decode"])
def test_retries_under_a_seeded_fault_plan_match_jax(tmp_path, monkeypatch,
                                                     site):
    """One decode thread, so both packages visit the site in the same
    order and draw the plan's RandomState in the same order."""
    monkeypatch.setenv("KEYSTONE_TORCH_LOADER_THREADS", "1")
    monkeypatch.setenv("KEYSTONE_LOADER_THREADS", "1")
    root, _ = _archives(tmp_path, n_tars=2, per_tar=6)
    paths = ilu.list_archive_paths(root)
    build = (lambda name: 0, lambda img, label, name: (name, img))
    with FaultPlan(seed=4).add(site, rate=0.3) as plan:
        got = ilu.load_tar_files(paths, *build, retry_policy=RetryPolicy(
            max_attempts=6, backoff_s=0.0)).collect()
    with jfaults.FaultPlan(seed=4).add(site, rate=0.3) as jplan:
        want = jilu.load_tar_files(paths, *build,
                                   retry_policy=jretry.RetryPolicy(
                                       max_attempts=6,
                                       backoff_s=0.0)).collect()
    assert plan.injections(site) == jplan.injections(site) > 0
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
    assert len(got) == 12


def test_retries_with_four_threads_absorb_every_injection(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_LOADER_THREADS", "4")
    root, _ = _archives(tmp_path, n_tars=2, per_tar=6)
    paths = ilu.list_archive_paths(root)
    build = (lambda name: 0, lambda img, label, name: name)
    with FaultPlan(seed=0).add("ingest.decode", count=2) \
            .add("ingest.read", count=2) as plan:
        got = ilu.load_tar_files(paths, *build,
                                 retry_policy=RetryPolicy(backoff_s=0.0))
    assert plan.injections("ingest.decode") == 2
    assert plan.injections("ingest.read") == 2
    assert len(got) == 12
    assert _pool_joined()


# -- the streamed source --------------------------------------------------------

def _uniform_archives(tmp_path, n=10, corrupt=()):
    rng = np.random.RandomState(7)
    imgs = [_image(rng, 8, 10) for _ in range(n)]
    _write_tar(tmp_path / "u.tar", [
        (f"u{i:02d}.png", b"\x89PNG broken" if i in corrupt
         else _encode(img, "PNG")) for i, img in enumerate(imgs)])
    return [str(tmp_path / "u.tar")], imgs


def test_stream_tar_images_puts_uint8_on_the_wire(tmp_path, threads):
    paths, imgs = _uniform_archives(tmp_path)
    stream = ilu.stream_tar_images(paths, 4, device="cpu")
    with PipelineTrace("tar") as tr:
        chunks = [(c.n, c.data.clone()) for c in stream.chunks()]
    assert [n for n, _ in chunks] == [4, 4, 2]
    assert all(d.dtype == torch.float32 for _, d in chunks)
    got = torch.cat([d[:n] for n, d in chunks]).numpy()
    assert np.array_equal(got, np.stack(imgs).astype(np.float32))
    assert [c["h2d_bytes"] for c in tr.chunks] == [4 * 8 * 10 * 3] * 3
    assert all(c["nbytes"] == 4 * c["h2d_bytes"] for c in tr.chunks)
    assert stream.n == 10 and stream.quarantine.ok_count == 10
    # the JAX package's decode of the same archive, chunk by chunk
    want = [np.stack([img for _, img in c]) for c in
            jilu.iter_decoded_chunks(paths, 4, decode_dtype=np.uint8)]
    assert np.array_equal(got, np.concatenate(want).astype(np.float32))
    assert _pool_joined()


def test_stream_tar_images_quarantines_a_corrupt_member(tmp_path, threads):
    paths, imgs = _uniform_archives(tmp_path, corrupt=(3,))
    q = Quarantine()  # one bad record in the first 100 is in its budget
    stream = ilu.stream_tar_images(paths, 4, device="cpu", quarantine=q)
    got = np.concatenate([c.data[:c.n].numpy() for c in stream.chunks()])
    assert got.shape[0] == 9 and stream.n == 9
    assert (q.bad_count, q.ok_count) == (1, 9)
    assert q.records[0]["source"].endswith("::u03.png")
    keep = [img for i, img in enumerate(imgs) if i != 3]
    assert np.array_equal(got, np.stack(keep).astype(np.float32))


def test_stream_tar_images_with_prepare_decodes_float32(tmp_path):
    paths, imgs = _uniform_archives(tmp_path, n=6)
    seen = []

    def prepare(batch):
        seen.append(batch[0][1].dtype)
        return np.stack([img[..., 0] for _, img in batch])

    stream = ilu.stream_tar_images(paths, 4, prepare=prepare, device="cpu")
    got = np.concatenate([c.data[:c.n].numpy() for c in stream.chunks()])
    assert seen == [np.float32, np.float32]
    assert np.array_equal(got, np.stack(imgs)[..., 0].astype(np.float32))


def test_from_host_dataset_stacks_on_the_host(threads):
    rng = np.random.RandomState(2)
    items = [rng.randint(0, 256, (3, 5)).astype(np.uint8) for _ in range(7)]
    stream = StreamingDataset.from_host_dataset(
        HostDataset(items), 3, device="cpu", compute_dtype=np.float32)
    assert len(stream) == 7
    assert stream.element() == (((3, 5), "float32"),)
    with PipelineTrace("items") as tr:
        got = np.concatenate([c.data[:c.n].numpy() for c in stream.chunks()])
    assert np.array_equal(got, np.stack(items).astype(np.float32))
    assert [c["h2d_bytes"] for c in tr.chunks] == [45, 45, 45]
    # a wire of the items' own uint8: the plan charges a float32 working
    # chunk and the uint8 staged ones
    assert stream.static_plan_nbytes() == 2 * 45 + 4 * 45 + 45
    via_source = StreamingDataset.from_items(source=lambda: iter(items),
                                             chunk_size=3, device="cpu")
    assert np.array_equal(via_source.materialize().numpy(), np.stack(items))
    assert via_source.n == 7
    with pytest.raises(TypeError, match="exactly one"):
        StreamingDataset.from_items(items, source=lambda: iter(items))


# -- CSV ------------------------------------------------------------------------

def _csv(tmp_path, rows, name="d.csv"):
    path = tmp_path / name
    np.savetxt(path, rows, delimiter=",", fmt="%g")
    return str(path)


@pytest.mark.parametrize("label_col,label_offset", [(0, 1), (2, 0)])
def test_csv_labeled_loader_matches_jax(tmp_path, label_col, label_offset):
    rng = np.random.RandomState(label_col)
    rows = rng.randint(0, 256, (9, 6)).astype(np.float64)
    rows[:, label_col] = rng.randint(1, 11, 9)
    path = _csv(tmp_path, rows)
    got = loaders.csv_labeled_loader(path, label_col, label_offset,
                                     device="cpu")
    want = jcsv.csv_labeled_loader(path, label_col, label_offset)
    assert got.data.numpy().dtype == np.float32
    assert got.labels.numpy().dtype == np.int32
    np.testing.assert_array_equal(got.data.numpy(), want.data.numpy())
    np.testing.assert_array_equal(got.labels.numpy(), want.labels.numpy())
    assert got.labels.numpy().min() >= 1 - label_offset


def test_csv_data_loader_reads_a_directory_like_jax(tmp_path):
    rng = np.random.RandomState(1)
    (tmp_path / "parts").mkdir()
    for i in range(2):
        _csv(tmp_path / "parts", rng.rand(4, 3), f"p{i}.csv")
    got = loaders.csv_data_loader(str(tmp_path / "parts"), device="cpu")
    want = jcsv.csv_data_loader(str(tmp_path / "parts"))
    assert len(got) == 8
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_loader_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _csv(tmp_path, np.ones((2, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaders.csv_labeled_loader(path)
    paths, _ = _uniform_archives(tmp_path, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ilu.stream_tar_images(paths, 2)
