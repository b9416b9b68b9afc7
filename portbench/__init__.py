"""The benchmark of the PyTorch and CUDA port (anime_recommendations_tpu_torch).

One run measures one cell of BENCHMARK.json, one configuration under one
traffic mix, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that defines a cell is data found by name: the configuration in
configs/<config>.json, the traffic mix in traffic/<traffic>.json (its
``kind`` names the general driver in kinds/<kind>.py), the limits of its
correctness check in limits/<cell>.json, and each per-layer metric's reader
in metrics/<metric>.py. The yardstick lives here too: the seeded data
(datagen.py), the plain reference (reference.py), the comparison that decides
``correct`` (compare.py), the operation and byte counts (work.py), the
table of peaks (peaks.py) and the reduction of the profiler's trace
(trace.py). From the port the benchmark takes only the system under test.
"""
