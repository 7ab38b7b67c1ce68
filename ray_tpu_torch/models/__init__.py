"""Model configuration, parameters and the paged serving programs."""
