"""The H100 benchmark of stnls_tpu_torch: a data-driven harness.

`run.py` runs one cell of BENCHMARK.json (a configuration under one
traffic mix) on one card and prints one JSON line. Everything that
belongs to one configuration, cell or per-layer metric is a file of its
own, found by its name: `configs/<config>.json` and `configs/<config>.py`,
`workloads/<cell>.json`, `metrics/<metric>.py` and
`reference/<config>.py`.
"""
