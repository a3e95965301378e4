"""Decode-path models of the port (attention-only architectures)."""
