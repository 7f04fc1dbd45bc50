"""User-facing inference classes of the port."""
