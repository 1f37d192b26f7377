"""The benchmark of the PyTorch / CUDA port (``compv_tpu_torch``): one cell
run once by ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Configurations, traffic mixes, metrics and
cells are found by name (``BENCHMARK.json``, ``configs/``, ``traffic/``,
``metrics/``, ``systems/``); ``reference/`` is the plain comparison side.
"""
