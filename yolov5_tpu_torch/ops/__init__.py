"""Tensor ops: box geometry, NMS, and the hand-written CUDA kernels' wrappers."""
