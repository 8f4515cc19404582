"""Multi-file datasets: the read half of the versioned manifest
(:mod:`.manifest`)."""
