"""Traffic kinds: one module per kind, the class that runs it as KIND."""
