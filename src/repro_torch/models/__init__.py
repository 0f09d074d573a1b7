"""Model layers of the port (dense decoder-only LM)."""
