"""The prompt-cache core: keys, prompt ranges, Bloom catalog, cache
server, state blobs, the simulated and TCP network, the multi-peer
fabric and the edge client."""
