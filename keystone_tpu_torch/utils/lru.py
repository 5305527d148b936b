"""Bounded LRU memo.

Counterpart of ``keystone_tpu/utils/lru.py``. The JAX package bounds its
memos of jitted executables with it; the port bounds the serving plane's
captured CUDA graphs, keyed ``(model, bucket)``. An entry pins its
graph, the graph's static buffers and, through them, its memory pool, so
a memo that only grew would leak device memory across admissions.
:meth:`LruMemo.put`, :meth:`LruMemo.pop_where` and :meth:`LruMemo.clear`
return the entries they drop, so the owner can release what those held
once its last reference to them is gone.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, List, Optional, Tuple

Dropped = List[Tuple[Hashable, Any]]

#: the miss marker, distinct from any storable value; ``get`` returns
#: None for a miss, so ``put`` refuses to store None
_MISS = object()


class LruMemo:
    def __init__(self, max_entries: int = 256):
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.max_entries = max_entries
        # serving workers and admissions share the memo
        self._lock = threading.Lock()

    def get(self, key: Hashable) -> Optional[Any]:
        """Value for key (LRU-touched), or None. May raise TypeError for
        unhashable keys; callers treat that as uncacheable."""
        with self._lock:
            value = self._entries.get(key, _MISS)
            if value is _MISS:
                return None
            self._entries.move_to_end(key)
            return value

    def put(self, key: Hashable, value: Any) -> Dropped:
        """Store ``value``; returns the entries dropped for room (and an
        older value of ``key``)."""
        if value is None:  # not an assert: must survive python -O
            raise ValueError("LruMemo cannot store None (reserved for miss)")
        dropped: Dropped = []
        with self._lock:
            old = self._entries.pop(key, _MISS)
            if old is not _MISS and old is not value:
                dropped.append((key, old))
            self._entries[key] = value
            while len(self._entries) > self.max_entries:
                dropped.append(self._entries.popitem(last=False))
        return dropped

    def pop_where(self, predicate: Callable[[Hashable], bool]) -> Dropped:
        """Remove every entry whose key satisfies ``predicate``; returns
        them."""
        with self._lock:
            keys = [k for k in self._entries if predicate(k)]
            return [(k, self._entries.pop(k)) for k in keys]

    def clear(self) -> Dropped:
        with self._lock:
            dropped = list(self._entries.items())
            self._entries.clear()
        return dropped

    def keys(self) -> List[Hashable]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)
