"""Host C++ helpers of the port, built with g++ from the repository's
``native/`` sources into ``neural_spectral_codec_torch/_build/``
(``_gxx.py``) and bound with ctypes: the geometry library (``geom``,
``native/nsc_geom.cpp``) and the IO library (``io``, ``native/nsc_io.cpp``:
record decode and the read-ahead frame source).
"""
