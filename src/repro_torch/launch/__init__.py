"""Entry points of the port: ``serve`` (serving from the command line)."""
