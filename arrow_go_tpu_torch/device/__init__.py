"""Device block format of the port."""
