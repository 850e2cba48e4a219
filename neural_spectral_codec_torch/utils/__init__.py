"""Utilities of the port: configs (``config``), stage timing
(``profiler``), CUDA-event timing (``timing``) and logging set-up
(``logging_setup``)."""
