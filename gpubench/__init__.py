"""The benchmark of the PyTorch and CUDA port (``textgcn_tpu_torch``):
``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
