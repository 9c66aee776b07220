"""Model pieces of the dense serving path."""
