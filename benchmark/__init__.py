"""The benchmark of ``epic_tpu_torch`` on one NVIDIA H100.

``BENCHMARK.json`` at the root of the repository lists the configurations,
the cells (a configuration under a traffic mix), the end-to-end metrics with
their bounds and the per-layer metrics. This package holds everything else,
each piece found by name:

- ``configs/<config>.json``: a deployment of the upstream planner (its map
  in ``data/``, resolution, epsilon, stagger, what was assumed);
- ``traffic/<mix>.json``: a traffic mix's parameters, read by the driver it
  names in ``drivers/``; a mix may name its own comparison (``"check":
  "<name>"``, the module ``checks/<name>.py``), else ``check.py`` judges it;
- ``metrics/<metric>.py``: a reader of one metric;
- ``run.py``: one run of one cell (``python3 -m benchmark.run --workload
  <cell> --seed <n> --seconds <s> --trace <0|1>``); ``harness.py`` its
  set-up, window and check; ``spans.py`` and ``trace.py`` the spans and the
  profiler's trace; ``roofline.py`` the least time of a solve;
  ``reference.py`` the plain reference and ``check.py`` the comparison that
  decides ``correct`` where the mix names none; ``reference_anytime.py``
  the replay of the node's loop that ``checks/anytime.py`` compares with;
  ``control.py`` each comparison's control (its reference in bfloat16),
  run on the card by hand.

Tests: ``python -m pytest benchmark/tests`` on the CPU; the ones marked
``cuda`` run the cells on the card and skip without one.
"""
