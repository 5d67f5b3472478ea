"""Stencil bodies and the build of the hand-written CUDA kernels."""
