"""Expert providers and generation loops of the port."""
