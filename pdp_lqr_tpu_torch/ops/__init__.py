"""Stage-level operations of the port: plain-torch recursions and the CUDA kernels."""
