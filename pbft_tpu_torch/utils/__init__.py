"""Utilities of the port (a copy of the tracer the verify service needs)."""
