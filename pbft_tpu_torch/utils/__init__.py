"""Utilities of the port: copies of the tracer, the metrics registry and the
schema manifest that the verify service needs, and the compile step
(``graphs``: CUDA graphs of fixed window shapes)."""
