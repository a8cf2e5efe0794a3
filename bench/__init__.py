"""The benchmark of the PyTorch and CUDA port (`repro_torch`): DLRM
inference on one NVIDIA H100. `bench/run.py` runs one cell of
`BENCHMARK.json`; `bench/calibrate.py` takes the readings that the
correctness limits in `bench/limits/` were set from."""
