"""Utilities of the port: CUDA-event timing (``timing``)."""
