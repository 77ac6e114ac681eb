"""Task-graph applications of the port: the tiled QR (``qr``) and the
Barnes-Hut tree code (``barneshut``)."""
