"""Traffic drivers, one a file, found by the ``driver`` a cell names."""
