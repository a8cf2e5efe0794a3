"""Plain PyTorch references, one file a model; each imports nothing of the
program under test."""
