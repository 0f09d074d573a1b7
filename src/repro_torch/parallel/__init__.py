"""Parallelism of the port (counterpart of ``repro.parallel``)."""
