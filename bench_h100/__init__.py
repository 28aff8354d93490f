"""The H100 benchmark of ``flexdiffuse_tpu_torch``.

One cell a run: ``python -m bench_h100.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root (``run.py``).
Everything a cell is made of is found by name: ``configs/<config>.json``
(the sizes as run), ``workloads/<cell>.json`` (configuration, traffic kind,
the mix's parameters, the correctness limits), ``traffic/<kind>.py`` (the
generator), ``metrics/<metric>.py`` (one reader per per-layer metric);
``BENCHMARK.json`` at the root lists the cells and metrics.

The yardstick lives here too: ``seeded.py`` (weights and inputs from the
seed, frozen copies of the program's own draws), ``work.py`` (operations,
bytes and bounds of the hand-written kernels, model FLOPs), ``reference/``
(the plain fp32 reference), ``check.py`` (the image comparison),
``knee.py`` (the serving cell's rate sweep) and ``control.py`` (the
readings behind each limit). Nothing here imports JAX or the JAX package.
"""
