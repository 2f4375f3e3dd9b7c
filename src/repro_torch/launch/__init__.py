"""Launch helpers: the world a sharded run spans (``mesh``)."""
