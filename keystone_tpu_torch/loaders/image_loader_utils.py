"""Tar-archive image loading.

Counterpart of ``keystone_tpu/loaders/image_loader_utils.py`` (reference
``loaders/ImageLoaderUtils.scala``): tar archives of images are read
member by member, decoded with PIL on a thread pool (PIL releases the
interpreter lock while it decodes) and yielded as labeled image items.
Images keep the reference's convention: (H, W, C) arrays in [0, 255],
float32 unless a caller decodes uint8. They stay on the host; the apps
stage them on their device.

Resilience (``keystone_tpu_torch/resilience``): tar-member reads and
image decodes retry transient failures under a `RetryPolicy` (the
``ingest.read`` and ``ingest.decode`` fault sites sit inside the
attempts), and undecodable members go to a `Quarantine`, skipped but
accounted, the load failing once the bad-record budget is passed.

``stream_tar_images`` feeds the decode pool into a `StreamingDataset`:
with no ``prepare`` hook it decodes uint8, ships uint8 over the link
(a quarter of the float32 bytes) and hands float32 chunks to the
consumers, cast on the device. ``stream_tar_shards`` streams this
rank's rank-strided share of the archives onto its local mesh: the
ingest half of the world's streamed fit (``parallel/distributed.py``).
"""
from __future__ import annotations

import collections
import gzip
import io
import logging
import os
import tarfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from ..parallel.dataset import HostDataset
from ..resilience.faults import inject
from ..resilience.quarantine import Quarantine
from ..resilience.retry import RetryPolicy, default_retry_policy

#: the suffixes ``list_archive_paths`` strides over on a multi-process run
ARCHIVE_SUFFIXES = (".tar", ".tar.gz", ".tgz", ".tar.bz2")

#: what an archive that ends early or is not an archive raises while read
_ARCHIVE_ERRORS = (tarfile.ReadError, gzip.BadGzipFile, EOFError, zlib.error)


@dataclass
class LabeledImage:
    """Image + single int label (reference ``Image.scala:371-380``)."""

    image: np.ndarray
    label: int
    filename: Optional[str] = None


@dataclass
class MultiLabeledImage:
    """Image + multiple labels (reference ``Image.scala:383-394``)."""

    image: np.ndarray
    labels: List[int] = field(default_factory=list)
    filename: Optional[str] = None


def decode_image(data: bytes, dtype=np.float32) -> Optional[np.ndarray]:
    """JPEG / PNG bytes -> ``dtype`` (H, W, 3) RGB in [0, 255] on the host,
    None if the bytes do not decode (the reference's ``loadImage``
    returns an Option). PIL decodes in uint8, so ``dtype=np.uint8`` is
    lossless and skips the widening copy. A missing Pillow raises: it
    must not turn every image into an undecodable one."""
    from PIL import Image as PILImage

    try:
        img = PILImage.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img, dtype=dtype)
    except (OSError, ValueError, SyntaxError):
        return None


def _process_share():
    """``(rank, world size)`` of the live world, else ``(0, 1)``."""
    from ..parallel.mesh import process_count, process_index

    return process_index(), process_count()


def list_archive_paths(data_path: str,
                       process_shard: bool = True) -> List[str]:
    """Every non-directory file under a path, sorted (reference
    ``ImageLoaderUtils.getFilePathsRDD`` filters only directories);
    :func:`load_tar_files` skips the non-archives (labels, READMEs) when
    it opens them. In a world of more than one rank
    (``parallel.mesh.initialize_distributed``), each rank keeps its strided
    share of the archives (``process_shard=False``: the full listing),
    and a process left with none raises."""
    if os.path.isfile(data_path):
        paths = [data_path]
    else:
        paths = sorted(
            os.path.join(data_path, f) for f in os.listdir(data_path)
            if os.path.isfile(os.path.join(data_path, f)))
    if process_shard:
        rank, world = _process_share()
        if world > 1:
            archives = [p for p in paths if p.endswith(ARCHIVE_SUFFIXES)]
            paths = archives[rank::world]
            if not paths:
                raise ValueError(
                    f"process {rank}/{world} has no archives: only "
                    f"{len(archives)} archive(s) under {data_path!r}. Repack "
                    "the data into at least as many archives as processes, "
                    "or pass process_shard=False.")
    return paths


def _iter_tar_entries(tar_path: str, name_prefix: Optional[str] = None,
                      retry: Optional[RetryPolicy] = None
                      ) -> Iterator[tuple]:
    """``(member name, raw bytes)`` of each file member of a tar whose
    name starts with ``name_prefix``. Each member's read retries under
    ``retry``; the ``ingest.read`` fault site sits inside the attempt."""
    mode = "r:gz" if tar_path.endswith(".gz") else "r"
    with tarfile.open(tar_path, mode) as tf:
        for entry in tf:
            if not entry.isfile():
                continue
            if name_prefix and not entry.name.startswith(name_prefix):
                continue

            def read(entry=entry):
                inject("ingest.read", context=f"{tar_path}::{entry.name}")
                fobj = tf.extractfile(entry)
                return None if fobj is None else fobj.read()

            raw = (read() if retry is None
                   else retry.call(read, site="ingest.read"))
            if raw is not None:
                yield entry.name, raw


def _decode_with_retry(raw: bytes, context: str,
                       retry: Optional[RetryPolicy],
                       decode_dtype=np.float32) -> Optional[np.ndarray]:
    """One member's decode under ``retry``; the ``ingest.decode`` fault
    site sits inside the attempt. None for bytes that do not decode (the
    quarantine's case)."""

    def attempt():
        inject("ingest.decode", context=context)
        return decode_image(raw, dtype=decode_dtype)

    if retry is None:
        return attempt()
    return retry.call(attempt, site="ingest.decode")


def iter_tar_images(tar_path: str, name_prefix: Optional[str] = None,
                    quarantine: Optional[Quarantine] = None,
                    retry_policy: Optional[RetryPolicy] = None
                    ) -> Iterator[tuple]:
    """``(member name, float32 image)`` for each image of one tar, decoded
    serially (reference ``ImageLoaderUtils.loadFile``). With a
    ``quarantine`` an undecodable member is skipped but accounted;
    without one it is dropped."""
    for name, raw in _iter_tar_entries(tar_path, name_prefix,
                                       retry=retry_policy):
        img = _decode_with_retry(raw, f"{tar_path}::{name}", retry_policy)
        if img is not None:
            if quarantine is not None:
                quarantine.record_ok()
            yield name, img
        elif quarantine is not None:
            quarantine.quarantine(f"{tar_path}::{name}",
                                  "undecodable image bytes")


def _loader_threads() -> int:
    """Decode workers: ``KEYSTONE_TORCH_LOADER_THREADS`` (1 decodes one
    image at a time), else the host's cores, at most 32."""
    env = os.environ.get("KEYSTONE_TORCH_LOADER_THREADS")
    if env:
        return max(1, int(env))
    return min(32, os.cpu_count() or 4)


def _pooled_decoded(
    archive_paths: Sequence[str],
    name_prefix: Optional[str] = None,
    on_archive_end: Optional[
        Callable[[str, Optional[Exception], int], None]] = None,
    quarantine: Optional[Quarantine] = None,
    retry_policy: Optional[RetryPolicy] = None,
    decode_dtype=np.float32,
) -> Iterator[tuple]:
    """``(member name, image)`` from every archive, decoded on a thread
    pool behind a window of 4 x workers decodes in flight: the one home
    of the pool shared by :func:`iter_decoded_chunks` and
    :func:`load_tar_files`.

    Items come out in archive order, then member order, whatever the
    worker count. Undecodable members go to ``quarantine`` (dropped
    without one). An archive that raises while read (not an archive,
    truncated) stops there and keeps what was read;
    ``on_archive_end(path, error or None, images yielded)`` fires once an
    archive, after a full drain, so the count is exact. The pool's
    threads are joined on every exit: the end, an error (a retry or the
    quarantine's budget exhausted) and a consumer that stops early
    (closing the generator cancels the decodes not yet started)."""
    workers = _loader_threads()
    window = 4 * workers
    pending: collections.deque = collections.deque()
    pool = ThreadPoolExecutor(workers,
                              thread_name_prefix="keystone-torch-decode")

    def drain(keep: int) -> List[tuple]:
        out = []
        while len(pending) > keep:
            name, ctx, fut = pending.popleft()
            img = fut.result()  # a retry's exhaustion raises here
            if img is not None:
                if quarantine is not None:
                    quarantine.record_ok()
                out.append((name, img))
            elif quarantine is not None:
                # raises once the bad-record budget is passed
                quarantine.quarantine(ctx, "undecodable image bytes")
        return out

    try:
        for path in archive_paths:
            n_from_archive = 0
            err: Optional[Exception] = None
            try:
                for name, raw in _iter_tar_entries(path, name_prefix,
                                                   retry=retry_policy):
                    ctx = f"{path}::{name}"
                    pending.append((name, ctx, pool.submit(
                        _decode_with_retry, raw, ctx, retry_policy,
                        decode_dtype)))
                    for item in drain(window):
                        n_from_archive += 1
                        yield item
            except _ARCHIVE_ERRORS as e:
                err = e
            for item in drain(0):
                n_from_archive += 1
                yield item
            if on_archive_end is not None:
                on_archive_end(path, err, n_from_archive)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def iter_decoded_chunks(
    archive_paths: Sequence[str],
    chunk_size: int,
    name_prefix: Optional[str] = None,
    quarantine: Optional[Quarantine] = None,
    retry_policy: Optional[RetryPolicy] = None,
    decode_dtype=np.float32,
) -> Iterator[List[tuple]]:
    """The archives as lists of ``chunk_size`` ``(member name, image)``
    pairs (the last list shorter): the loader half of a loader-device
    pipeline, the pool decoding the next window while the consumer's
    device works on the current chunk. An unreadable or truncated archive
    is skipped with a warning, keeping the members read before the
    error."""
    log = logging.getLogger(__name__)

    def on_end(path, err, n):
        if err is not None:
            log.warning("Skipping unreadable/truncated archive %s (%s); "
                        "kept %d entries read before the error", path, err, n)

    out: list = []
    for item in _pooled_decoded(archive_paths, name_prefix, on_end,
                                quarantine=quarantine,
                                retry_policy=retry_policy,
                                decode_dtype=decode_dtype):
        out.append(item)
        if len(out) == chunk_size:
            yield out
            out = []
    if out:
        yield out


def stream_tar_images(
    archive_paths: Sequence[str],
    chunk_size: int,
    prepare: Optional[Callable[[List[tuple]], np.ndarray]] = None,
    name_prefix: Optional[str] = None,
    n: Optional[int] = None,
    quarantine: Optional[Quarantine] = None,
    retry_policy: Optional[RetryPolicy] = None,
    decode_dtype=None,
    **stream_kw,
):
    """tar archives -> decode pool -> prefetched device stream: chunk i + 1
    is decoded and staged while chunk i computes.

    With no ``prepare``, images are decoded uint8 (lossless for [0, 255]
    pixels), cross the link as uint8 and reach the consumers as float32
    [0, 255] chunks, the stream's ``compute_dtype`` casting on the
    device; the default stacks the chunk's images as they are (archives
    of one image size). A ``prepare`` maps a decoded chunk (a list of
    ``(member name, image)`` pairs) to a stacked host array (resize,
    crop, grayscale); it gets float32 images, and what it returns is what
    crosses the link. ``decode_dtype`` overrides the decode width either
    way; ``wire_dtype``, ``compute_dtype``, ``device`` and the other
    `StreamingDataset` options pass through. ``n`` is the image count
    when known (a completed pass pins it).

    Reads and decodes retry under ``retry_policy`` (the shared default
    when None); corrupt members go to ``quarantine`` (a fresh default
    one when None), which the stream carries as ``.quarantine`` for a
    streamed fit to checkpoint."""
    from ..parallel.streaming import StreamingDataset

    if prepare is None:
        if decode_dtype is None:
            decode_dtype = np.uint8
            stream_kw.setdefault("compute_dtype", np.float32)

        def prepare(batch):
            return np.stack([img for _, img in batch])
    elif decode_dtype is None:
        decode_dtype = np.float32

    tag = f"tar:{archive_paths[0]}" if archive_paths else "tar"
    if quarantine is None:
        quarantine = Quarantine(label=tag)
    if retry_policy is None:
        retry_policy = default_retry_policy()

    def factory():
        for batch in iter_decoded_chunks(
                archive_paths, chunk_size, name_prefix,
                quarantine=quarantine, retry_policy=retry_policy,
                decode_dtype=decode_dtype):
            yield prepare(batch)

    return StreamingDataset.from_chunks(
        factory, chunk_size, n=n, tag=tag, retry_policy=retry_policy,
        quarantine=quarantine, **stream_kw)


def load_tar_files(
    archive_paths: Sequence[str],
    labels_map: Callable[[str], object],
    image_builder: Callable[[np.ndarray, object, str], object],
    name_prefix: Optional[str] = None,
    quarantine: Optional[Quarantine] = None,
    retry_policy: Optional[RetryPolicy] = None,
) -> HostDataset:
    """Every image of every archive, through ``labels_map(member name)``
    and ``image_builder(image, label, member name)`` (reference
    ``ImageLoaderUtils.loadFiles``), decoded on the shared pool. A file
    that is not an archive is skipped with a warning, a truncated one
    warned about and kept as far as it was read; when nothing under the
    listing opened as an archive, ``tarfile.ReadError``."""
    log = logging.getLogger(__name__)
    items: list = []
    opened_any = False

    def on_end(path, err, n):
        nonlocal opened_any
        if err is None:
            opened_any = True
        elif n == 0:
            log.warning("Skipping non-archive file %s", path)
        else:
            log.warning("Archive %s truncated/corrupt (%s); kept %d items "
                        "from it", path, err, n)
            opened_any = True

    for name, img in _pooled_decoded(archive_paths, name_prefix, on_end,
                                     quarantine=quarantine,
                                     retry_policy=retry_policy):
        opened_any = True
        items.append(image_builder(img, labels_map(name), name))
    if archive_paths and not opened_any:
        raise tarfile.ReadError(
            f"None of {len(archive_paths)} file(s) under the data path could "
            f"be opened as tar archives (first: {archive_paths[0]})")
    return HostDataset(items)


def stream_tar_shards(data_path: str, chunk_size: int, **stream_kw):
    """Shard-local tar streaming: this rank's rank-strided share of the
    archives under ``data_path`` (:func:`list_archive_paths`) through
    :func:`stream_tar_images` on this rank's local mesh, the ingest half
    of the world's streamed fit (each rank decodes only its archives and
    the carries merge at finalize).

    The stream is tagged ``tarshard:h<rank>/<world>`` and marked
    ``process_sharded`` (its row count is this rank's share: the static
    analyzer reports the flag, and only the world loop of
    ``fit_streaming`` understands it); ``shard_archives`` lists its
    archives. Keyword arguments pass through to
    :func:`stream_tar_images`. Without a world this is the plain tar
    stream of the whole listing. An empty share raises at listing time:
    repack the data into at least as many archives as ranks."""
    from ..parallel.mesh import local_mesh, process_count, process_index

    paths = list_archive_paths(data_path, process_shard=True)
    pid, nproc = process_index(), process_count()
    if "mesh" not in stream_kw and nproc > 1:
        stream_kw["mesh"] = local_mesh()
    stream = stream_tar_images(paths, chunk_size, **stream_kw)
    stream.tag = f"tarshard:h{pid}/{nproc}"
    stream.process_sharded = True
    stream.shard_archives = list(paths)
    return stream
