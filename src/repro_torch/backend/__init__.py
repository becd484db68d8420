"""Kernel front doors of the port (``dispatch``)."""
