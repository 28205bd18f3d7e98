"""Training driver of the port, its mesh, and the dry run."""
