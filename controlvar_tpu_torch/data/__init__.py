"""The data layer: datasets, the threaded loader, token shards."""
