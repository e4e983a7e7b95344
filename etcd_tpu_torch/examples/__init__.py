"""Programs built on the port's public API (the repo-root examples/ of the
JAX package): raftexample."""
