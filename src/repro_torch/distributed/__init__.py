"""Distributed runtime pieces of the port (``fault_tolerance``)."""
