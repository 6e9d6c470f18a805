"""Architecture tables shared by the port's stores and arenas."""
