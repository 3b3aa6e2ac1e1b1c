"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Only the frontier relax kernel is ported so far; flash
attention and the SSD intra-chunk form are queued (ROADMAP Queue 2)."""
