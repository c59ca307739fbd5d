"""Utilities of the port: a copy of the tracer the verify service needs, and
the compile step (``graphs``: CUDA graphs of fixed window shapes)."""
