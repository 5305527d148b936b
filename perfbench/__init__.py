"""The benchmark of ``keystone_tpu_torch`` on one NVIDIA GPU.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name:

- ``workloads/<cell>.json``: its configuration, traffic, chips, why, how
  many units the traced run profiles and the limit of its check;
- ``configs/<config>.json``: the configuration's values, what was cut
  from its source and why, what was assumed, its precision, and the
  adapter that drives the program for it;
- ``traffic/<traffic>.json``: the traffic's parameters and the driver
  (``drivers/<driver>.py``) that runs the window from them;
- ``adapters/<adapter>.py``: the glue between a configuration and the
  program (inputs, fit, apply, counted work, the reference's scores);
- ``metrics/<kind>.py``: one reader per kind of per-layer metric, found
  by the metric's name before its first dot (``idle_share.fit`` and
  ``idle_share.apply`` are both read by ``idle_share.py``); a file named
  after a metric's whole name takes precedence;
- ``data/``, ``work/``, ``reference/``: the seeded generators, the
  frozen operation and byte counts, and the plain reference, none of
  which imports the program.

Nothing here imports ``jax`` or the JAX package ``keystone_tpu``.
"""
