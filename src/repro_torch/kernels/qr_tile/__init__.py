"""Tiled-QR tile kernels: plain versions (``ref``), the CUDA kernels'
binding (``kernel``), and the device-dispatching wrappers (``ops``)."""
