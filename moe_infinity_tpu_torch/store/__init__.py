"""Expert stores of the port: the record blob, a synthetic store and the
page-locked host tier."""
