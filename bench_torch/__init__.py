"""The benchmark of the PyTorch and CUDA port (``efficientq_tpu_torch``):
``python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, with the cells in ``BENCHMARK.json`` at the repository's
root."""
