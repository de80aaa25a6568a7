"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 -m agentbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
Everything that belongs to one configuration, traffic mix, metric or
kernel count sits in a file of its own, found by the name in
``BENCHMARK.json``.
"""
