"""Hand-written CUDA kernels for Hopper: one package per TPU kernel of
`repro.kernels` (`embedding_bag`), and `interaction`, DLRM's dot
interaction, which replaces no TPU kernel; each with its plain PyTorch
version beside it."""
