"""The bench-regression gate, under the repository's tools name.

    python -m keystone_tpu_torch.tools.bench_compare OLD.json NEW.json \
        [--force] [--band FRACTION]

Counterpart of the repository's ``tools/bench_compare.py``: a thin
wrapper over ``observability/benchdiff.py::main`` (also ``python -m
keystone_tpu_torch benchdiff``). Exit 0: every shared metric improved or
stayed within its noise band; 1: a usage or load error, or runs from
different hosts (``--force`` compares them anyway); 2: at least one
metric regressed beyond its band.
"""
from __future__ import annotations

import sys

from ..observability.benchdiff import main

if __name__ == "__main__":
    sys.exit(main())
