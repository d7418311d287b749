"""Profiling and timing hooks of dprast_torch."""
