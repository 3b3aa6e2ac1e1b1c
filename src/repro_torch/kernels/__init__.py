"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: the frontier relax step (`frontier`), flash attention and its
backward (`attention`) and the SSD intra-chunk form (`ssd`). `_build`
compiles them with nvcc at first use; `_grad` holds the raw wrappers'
grad-mode guard."""
