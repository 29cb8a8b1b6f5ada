"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions,
and the dispatch (``ops``) that picks one by the tensors' device."""
