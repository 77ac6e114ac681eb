"""Task-graph applications of the port (tiled QR; Barnes-Hut is still to
be ported)."""
