"""Hand-written CUDA kernels of the torch port and their nvcc build step."""
