"""Host C++ helpers of the port: the geometry library (``geom``).

``geom`` compiles the repository's ``native/nsc_geom.cpp`` with g++ into
``neural_spectral_codec_torch/_build/`` and binds it with ctypes. The IO
half of the JAX package's native code (``libnsc_io.so``, the read-ahead
frame source) is not ported yet.
"""
