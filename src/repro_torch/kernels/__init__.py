"""Hand-written CUDA kernels for Hopper: one package per TPU kernel of
`repro.kernels` (`embedding_bag`), and `interaction` (DLRM's dot
interaction), `hstu_attention` (HSTU's attention and its time codes) and
`mips_topk` (HSTU retrieval's exact top-K scan), which replace no TPU
kernel; each with its plain PyTorch version beside it."""
