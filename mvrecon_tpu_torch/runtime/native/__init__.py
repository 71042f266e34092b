"""Native (C++) host code of the port, built with ``g++`` at first use into
``build/native/`` and loaded with ``ctypes``: the Kruskal walk of the
view-graph MST (``mst.cpp``, ``mst_native.py``)."""
