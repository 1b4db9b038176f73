"""Hand-written CUDA kernels of the port (see ``kernels/l1inf``)."""
