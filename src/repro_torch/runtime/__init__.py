"""Serving engine (runtime/server.py)."""
