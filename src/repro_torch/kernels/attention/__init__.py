"""Paged attention: CUDA kernels, plain torch versions, dispatch."""
