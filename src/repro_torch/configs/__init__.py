"""Configurations of the port (copies of the reference's plain-Python ones)."""
