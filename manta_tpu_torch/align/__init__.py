"""Contig jump scoring: the plain PyTorch form and the CUDA kernel."""
