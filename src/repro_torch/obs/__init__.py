"""Observability of the port (a disabled plane for now; see serving.py)."""
