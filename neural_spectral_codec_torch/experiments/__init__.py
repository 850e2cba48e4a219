"""Measurement entry points of the port (``python -m
neural_spectral_codec_torch.experiments.<name> --help``), each on
``--device cuda`` unless the caller names the CPU:

- kernel and stage probes: ``ring_stage_probe``, ``profile_hotpath``,
  ``kernel_ab``, ``parallel_profile``, ``capture_probe`` (a card only);
- latency and scale: ``online_latency``, ``retrieval_latency``,
  ``scale_100k``;
- quality on synthetic streams: ``degraded_recall``,
  ``cross_sensor_uplift``, ``density_defense``, and
  ``selection_divergence`` (host numpy only).

Each prints its results and writes them with ``--json``; none writes
into the repository.
"""
