"""Plan nodes and their conversion to execs."""
