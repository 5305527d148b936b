"""``python -m keystone_tpu_torch serve ...``: the port's command line.

Counterpart of the ``serve`` subcommand of ``keystone_tpu/__main__.py``
(see ``serving/http.py`` for its flags). The other subcommands come
with ROADMAP A12.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        print("usage: python -m keystone_tpu_torch serve "
              "NAME=PATH@SHAPE[:DTYPE] ... (see keystone_tpu_torch/"
              "serving/http.py)", file=sys.stderr)
        return 2
    from .serving.http import main as serve_main

    return serve_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
