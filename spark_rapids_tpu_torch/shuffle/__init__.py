"""The in-process shuffle of the port."""
