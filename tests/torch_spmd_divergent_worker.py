"""A deliberately divergent rank: rank 0 enters a collective that rank 1
never matches (the hazard the ``collective-divergence`` pass of
``keystone_tpu_torch/analysis/spmd.py`` flags; ``tests/test_torch_spmd.py``
holds the flag on this file, ``tests/test_torch_elastic.py`` the run).

    python tests/torch_spmd_divergent_worker.py <pid> <nproc> <store>
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch.distributed as dist  # noqa: E402

from keystone_tpu_torch.parallel.dryrun_worker import coordinator_of  # noqa
from keystone_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed,
    process_index,
)


def main(pid, nproc, store):
    initialize_distributed(coordinator_of(store), int(nproc), int(pid),
                           device="cpu", quiet=True)
    dist.barrier()  # matched by every rank
    print(f"DIVERGE_ENTER pid={process_index()}", flush=True)
    if process_index() == 0:
        dist.barrier()  # rank 1 never calls this one
    print(f"DIVERGE_DONE pid={process_index()}", flush=True)
    os._exit(0)


if __name__ == "__main__":
    main(*sys.argv[1:4])
