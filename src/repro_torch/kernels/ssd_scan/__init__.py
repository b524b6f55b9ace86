"""Mamba-2 SSD chunked scan: CUDA kernel, plain torch version, oracle."""
