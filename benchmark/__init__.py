"""The stereo engine's benchmark: cells, traffic, trace reduction, reference.

Run a cell with ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root; ``BENCHMARK.json``
lists the cells and metrics.
"""
