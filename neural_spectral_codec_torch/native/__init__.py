"""Host C++ helpers of the port, built with g++ from the repository's
``native/`` sources into ``neural_spectral_codec_torch/_build/``
(``_gxx.py``) and bound with ctypes: the geometry library (``geom``,
``native/nsc_geom.cpp``) and the IO library (``io``, ``native/nsc_io.cpp``:
record decode and the read-ahead frame source).

The geometry entry points are re-exported here under the names of
``neural_spectral_codec_tpu.native``. Importing builds nothing: a library
is compiled at its first call.
"""

from neural_spectral_codec_torch.native.geom import (  # noqa: F401
    available, estimate_covariances, estimate_normals, gicp, icp,
    voxel_downsample, voxel_overlap)
