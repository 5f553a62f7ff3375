"""Examples that ship with the port (``mx.library`` plugins)."""
