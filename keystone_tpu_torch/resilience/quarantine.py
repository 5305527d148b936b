"""Corrupt-record quarantine with a bad-fraction budget.

Counterpart of ``keystone_tpu/resilience/quarantine.py``. A bad record
is skipped but accounted: its source identity and reason go into the
manifest (in memory and, with ``manifest_path``, an append-only JSONL
file), the ``resilience.quarantine`` counter and the active trace. The
fit fails loudly, naming the last quarantined source, once bad records
pass ``max_bad_fraction`` of ``max(seen, min_records)``. Records are
keyed by source identity, so a resumed pass that meets the same bad
record again counts it once. The ingest user is the tar loader of a
later slice (ROADMAP A7); ``fit_streaming`` carries a quarantine's
``state`` in its checkpoints.
"""
from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.guarded import TracedLock, guarded_by
from .events import record_event


class CorruptRecordError(Exception):
    """A record that can never be read correctly (truncated image,
    garbage bytes): not worth a retry, worth a quarantine."""


class QuarantineBudgetExceededError(RuntimeError):
    """Quarantined records passed ``max_bad_fraction``."""


@guarded_by("_lock", "records", "bad_count", "ok_count", "_keys")
class Quarantine:
    """Skip-but-account sink for corrupt records; see the module
    docstring. Counts, keys, the manifest tail and the JSONL append all
    happen under one lock, so a checkpoint's ``state()`` never sees a
    half-applied record."""

    #: raw manifest entries kept in memory (counts stay exact)
    MANIFEST_TAIL = 1000

    def __init__(self, max_bad_fraction: float = 0.01,
                 min_records: int = 100,
                 manifest_path: Optional[str] = None,
                 label: str = "ingest"):
        if not 0.0 <= max_bad_fraction <= 1.0:
            raise ValueError("max_bad_fraction must be in [0, 1]")
        self.max_bad_fraction = float(max_bad_fraction)
        self.min_records = int(min_records)
        self.manifest_path = manifest_path
        self.label = label
        self.records: List[Dict[str, Any]] = []
        self.bad_count = 0
        self.ok_count = 0
        self._keys: set = set()
        self._lock = TracedLock("quarantine")

    def record_ok(self, n: int = 1) -> None:
        """Count ``n`` good records (the budget's honest denominator)."""
        with self._lock:
            self.ok_count += int(n)

    def quarantine(self, source: str, reason: str,
                   site: str = "ingest.decode") -> None:
        """Quarantine one bad record, then enforce the budget; a source
        already quarantined is not counted again."""
        entry = {"source": str(source), "reason": str(reason), "site": site}
        with self._lock:
            if entry["source"] in self._keys:
                return
            self._keys.add(entry["source"])
            self.bad_count += 1
            self.records.append(entry)
            if len(self.records) > self.MANIFEST_TAIL:
                del self.records[: len(self.records) - self.MANIFEST_TAIL]
            if self.manifest_path:
                try:
                    with open(self.manifest_path, "a") as f:
                        f.write(json.dumps(entry) + "\n")
                except OSError as exc:
                    logging.getLogger(__name__).warning(
                        "quarantine manifest %s unwritable (%s); entry kept "
                        "in memory only", self.manifest_path, exc)
            violation = self._budget_violation(entry["source"])
        # outside the lock: the event feeds metrics and the trace
        record_event("quarantine", **entry)
        if violation is not None:
            raise QuarantineBudgetExceededError(violation)

    def seen(self) -> int:
        with self._lock:
            return self.bad_count + self.ok_count

    def _budget_violation(self, last_source: Optional[str] = None
                          ) -> Optional[str]:
        """The violation message, or None; the caller holds ``_lock``."""
        seen = self.bad_count + self.ok_count
        if self.bad_count <= self.max_bad_fraction * max(seen,
                                                         self.min_records):
            return None
        last = last_source or (self.records[-1]["source"] if self.records
                               else "?")
        return (f"{self.label}: {self.bad_count} corrupt record(s) out of "
                f"{seen} seen exceeds the quarantine budget "
                f"(max_bad_fraction={self.max_bad_fraction:g}, "
                f"min_records={self.min_records}). Last quarantined source: "
                f"{last}. The data is worse than the budget allows — fix "
                "the source or raise max_bad_fraction explicitly.")

    def state(self) -> Dict[str, Any]:
        """Checkpoint snapshot: the bad-record manifest and keys. Good
        counts are not kept: a resume replays the source and recounts
        them."""
        with self._lock:
            return {"records": list(self.records),
                    "keys": sorted(self.records and self._keys or ()),
                    "bad_count": self.bad_count}

    def restore(self, state: Dict[str, Any]) -> None:
        """Restore a :meth:`state` snapshot; good counts restart at 0."""
        with self._lock:
            self.records = list(state.get("records", ()))
            self._keys = set(state.get("keys", ()))
            self.bad_count = int(state.get("bad_count", len(self.records)))
            self.ok_count = 0

    def summary(self) -> str:
        return (f"quarantine[{self.label}]: {self.bad_count} bad / "
                f"{self.seen()} seen (budget {self.max_bad_fraction:g})")

    def quarantined_keys(self) -> set:
        with self._lock:
            return set(self._keys)


def drop_quarantined_rows(labels: Any, record_keys: Any,
                          quarantine: Quarantine) -> np.ndarray:
    """Align resident labels with a quarantine-shrunk stream: drop the
    label rows whose record key (one per row, in stream order) the
    quarantine holds."""
    arr = np.asarray(labels)
    keys = [str(k) for k in record_keys]
    if arr.shape[0] != len(keys):
        raise ValueError(
            f"labels have {arr.shape[0]} rows but {len(keys)} record keys "
            "were given: record_keys must name every record the labels "
            "were built for, in stream order")
    bad = quarantine.quarantined_keys()
    return arr[np.array([k not in bad for k in keys], dtype=bool)]
