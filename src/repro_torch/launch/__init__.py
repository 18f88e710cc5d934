"""Launchers: ``serve`` runs the cache server or an edge client over TCP
(``python -m repro_torch.launch.serve``)."""
