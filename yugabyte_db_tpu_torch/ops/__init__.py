"""Scan-path operators: expression compiler, device batches, the scan
kernel and the hand-written Hopper kernels."""
