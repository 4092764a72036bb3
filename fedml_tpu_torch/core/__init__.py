"""Config flags, RNG streams, tree helpers and device selection of the port."""
