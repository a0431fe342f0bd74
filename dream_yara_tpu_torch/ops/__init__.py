"""Device operations of the port: plain PyTorch functions on tensors, and the
hand-written CUDA kernels behind `banded_verify_cuda` and `row_gather_cuda`.
Nothing is imported eagerly: a kernel builds at first use, never at import."""
