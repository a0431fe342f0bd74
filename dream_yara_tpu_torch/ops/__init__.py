"""Device operations of the port: plain PyTorch functions on tensors, and the
hand-written CUDA kernel behind `banded_verify_cuda`. Nothing is imported
eagerly: the kernel builds at first use, never at import."""
