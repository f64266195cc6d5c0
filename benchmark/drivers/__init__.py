"""One driver per algorithm, found by the configuration's `algo`."""
