"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are found by the names in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
``runner`` names ``runners/<kind>.py``) and ``metrics/<metric>.py``.  The
plain float32 reference the results are judged against is
``reference/``; it imports nothing of the port.
"""
