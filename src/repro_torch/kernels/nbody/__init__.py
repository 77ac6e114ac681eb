"""N-body interaction kernels of the Barnes-Hut tree code: plain versions
(``ref``), the CUDA kernels' binding (``kernel``), and the
device-dispatching wrappers (``ops``)."""
