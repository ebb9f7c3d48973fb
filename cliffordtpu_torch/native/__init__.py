"""Native host components (port of ``cliffordtpu/native``): the data
engine ``dataio.cc``, built by ``build.py``."""
