"""Binaries of the port."""
