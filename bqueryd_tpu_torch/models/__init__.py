"""Query model and single-shard engine of the port."""
