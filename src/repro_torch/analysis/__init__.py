"""Runtime checks of the port (counterpart of ``repro.analysis``)."""
