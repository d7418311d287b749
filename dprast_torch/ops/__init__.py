"""Kernels and backends of dprast_torch."""
