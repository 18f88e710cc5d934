"""The prompt-cache core: keys, prompt ranges, Bloom catalog, cache
server, state blobs, the simulated and TCP network, the multi-peer
fabric (in process, or supervised daemons behind the ``Fabric`` facade),
deadlines, the fetch policy, the edge client and the session pool."""
