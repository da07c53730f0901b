"""Seed matchers and match-list tools of the port (host code, numpy/scipy)."""
