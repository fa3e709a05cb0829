"""Image output of the port: PNG and NPZ writers."""
