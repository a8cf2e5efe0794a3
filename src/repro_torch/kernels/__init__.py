"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of
`repro.kernels`, each with its plain PyTorch version beside it."""
