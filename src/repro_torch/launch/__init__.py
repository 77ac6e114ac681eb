"""Entry points of the port: ``serve`` and ``train`` (from the command
line), ``mesh`` (the production meshes) and ``dryrun`` (the multi-pod dry
run)."""
