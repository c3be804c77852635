"""The benchmark of the PyTorch and CUDA port (``ldpc_toolbox_torch``):
``ber`` steps of the configurations in ``BENCHMARK.json``, timed on one
card and checked against the plain reference in ``reference/``. Run
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root."""
