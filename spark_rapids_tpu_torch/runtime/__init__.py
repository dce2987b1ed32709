"""Runtime services of the port: the shared retry policy."""
