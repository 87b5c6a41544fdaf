"""Gates built on the bootstrap."""
