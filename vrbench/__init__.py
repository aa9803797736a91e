"""vrbench: the benchmark of the PyTorch and CUDA renderer
(``volumetric_renderer_torch``).

Run one cell from the root of a checkout, on a machine with the cards it
asks for::

    python3 -m vrbench.run --workload fit-32x256 --seed 7 --seconds 20 \\
        --trace 0

``BENCHMARK.json`` at the root lists the cells, configurations and
metrics.  Everything a cell needs is found by name, so a new cell, a new
configuration or a new per-layer metric is a new file and a new entry:

* ``configs/<name>.json``: a deployment (volume, march, camera);
* ``workloads/<name>.json``: a cell (configuration, traffic kind, its
  parameters, chips, the limits of its correctness check);
* ``traffic/<kind>.py``: one kind of traffic (``run(cell)``);
* ``metrics/<name>.py``: one per-layer metric (``read(run)``).

The yardstick lives here and nowhere else: the inputs made from the seed
(``inputs``), the plain reference (``reference/``), the frozen count of the
work the inputs need (``work``), the comparison that decides ``correct``
(``checks``) and the reading of the profiler's trace (``metrics/``).
None of it imports JAX or the JAX package, and ``reference/``, ``work``
and ``inputs`` import nothing of the renderer.
"""
