"""The benchmark of ``igcn_cf_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: its
configuration under ``configs/``, its traffic mix under ``traffic/`` (which
names a driver under ``drivers/``), its correctness limits under
``limits/`` and each per-layer metric's reader under ``metrics/``. The plain
reference that decides ``correct`` lives under ``reference/`` and imports
nothing of the program.
"""
