"""pinot_tpu_torch — the PyTorch/CUDA port of pinot_tpu.

Single-stage aggregation, dense GROUP BY and sparse (sort-based) GROUP BY
queries over immutable segments, segments of one shape batched into one
dispatch, run on one NVIDIA H100 (or on the CPU, with the kernels' plain
PyTorch versions). The entry point is
`pinot_tpu_torch.engine.query_executor.QueryExecutor`.
"""
