"""The benchmark of the PyTorch/CUDA port, ``noise_gnn_tpu_torch``.

Run one cell (one configuration under one traffic mix) on a CUDA card:

    python3 -m gnnbench.run --workload products_sage_co --seed 1 --seconds 30 --trace 0

``BENCHMARK.json`` at the repository's root lists the cells, the metrics and
their bounds. Everything else is found by name under this directory:
``configs/<config>.yaml`` (every setting the program reads, as run),
``traffic/<mix>.yaml`` (the entry that drives the program and its
parameters), ``entries/<entry>.py`` (the driver of one program entry),
``metrics/<metric>.py`` (a reader per metric), ``limits/<cell>.json`` (the
check's limits and the readings they were set from) and ``reference/``
(the plain reference the check judges the program against). A new cell,
mix or metric is new files here and entries added to ``BENCHMARK.json``.

``python3 -m gnnbench.calibrate`` reads the check's numbers for the
program, the control and planted faults over many seeds, to set a cell's
limits; benchmark runs never run it. The tests (``gnnbench/tests``) run
every cell on the CPU at small sizes: ``python -m pytest gnnbench/tests``;
those marked ``gpu`` need a card. Nothing here imports JAX or the JAX
package ``noise_gnn_tpu``.
"""
