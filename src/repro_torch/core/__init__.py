"""The prompt-cache core: keys, prompt ranges, Bloom catalog, cache
server, state blobs, transport and the edge client."""
