"""Tensor ops of the port: FFT preprocessing, the augmenter and the kernels."""
