"""numpy-seeded graph generators for the port."""
