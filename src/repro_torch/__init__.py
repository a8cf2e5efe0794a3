"""PyTorch/CUDA port of the DLRM inference system in `repro`.

The package mirrors `repro`'s layout file for file: the counterpart of
`repro/x/y.py` is `repro_torch/x/y.py`. It imports `torch` and numpy and
nothing of `repro` or JAX. Every kernel that `repro` wrote in Pallas for
the TPU is a CUDA kernel here, built from `csrc/` at first use; its plain
PyTorch version sits beside it and serves tensors that lie on the CPU.

Entry points take an explicit `device=` that defaults to `"cuda"`.
"""
