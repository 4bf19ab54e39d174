"""Models of the port."""
