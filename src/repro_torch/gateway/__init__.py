"""OpenAI-compatible HTTP front door for the edge prompt-cache fabric.

The port's counterpart of ``repro.gateway``. One :class:`Gateway` wires
three layers:

* :class:`~repro_torch.gateway.admission.AdmissionController` — per-tenant
  quotas and load shedding (429/503 with ``Retry-After``);
* :class:`~repro_torch.gateway.engine.GatewayEngine` — the one thread
  that owns the :class:`~repro_torch.serving.engine.BatchedEngine`, the
  continuous-batching scheduler, and the blocking prompt-cache resolve
  and upload against a :class:`~repro_torch.core.fabric.Fabric`;
* :class:`~repro_torch.gateway.server.GatewayServer` — asyncio HTTP/1.1
  and SSE on a daemon thread, OpenAI request and response shapes.

Quickstart::

    from repro_torch.core.fabric import Fabric
    from repro_torch.gateway import Gateway

    with Fabric.tcp(n_peers=2) as fabric:
        gw = Gateway(model, fabric=fabric).start()
        # POST http://127.0.0.1:{gw.port}/v1/chat/completions
        gw.stop()

Unlike the reference it takes no ``params`` (the port's ``Model`` holds
its weights) and no ``cache_dtype`` (the batched engine's cache takes the
model's dtype). Its one tracer (``Gateway.tracer``) is the engine's:
``GET /v1/traces/<id>`` reads it.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.config import CacheConfig
from repro_torch.core.fetch_policy import FetchPolicy
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.gateway.admission import (  # noqa: F401
    AdmissionController, ShedError, TenantQuota,
)
from repro_torch.gateway.engine import (  # noqa: F401
    GatewayClosed, GatewayEngine, GatewayJob, PrefixFetcher,
)
from repro_torch.gateway.server import GatewayServer
from repro_torch.gateway import protocol  # noqa: F401


class Gateway:
    """The assembled front door: admission, engine and HTTP server.

    ``max_inflight`` defaults to the engine's slot count and
    ``queue_depth`` to one more batch; beyond that, requests are shed with
    503 instead of queueing without bound.
    """

    def __init__(self, model, fabric=None, batch_size: int = 4,
                 max_len: int = 512,
                 cache_cfg: CacheConfig = CacheConfig(),
                 policy: Optional[FetchPolicy] = None, tokenizer=None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_inflight: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 default_quota: TenantQuota = TenantQuota(),
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 model_name: str = "repro-edge-cache",
                 request_timeout_s: float = 120.0):
        self.tokenizer = tokenizer or WordHashTokenizer(model.cfg.vocab)
        self.admission = AdmissionController(
            max_inflight=max_inflight or batch_size,
            queue_depth=batch_size if queue_depth is None else queue_depth,
            default_quota=default_quota, quotas=quotas)
        self.engine = GatewayEngine(
            model, batch_size=batch_size, max_len=max_len, fabric=fabric,
            cache_cfg=cache_cfg, policy=policy, admission=self.admission)
        self.server = GatewayServer(
            self.engine, self.admission, self.tokenizer, host=host,
            port=port, model_name=model_name,
            request_timeout_s=request_timeout_s)

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def tracer(self):
        """The gateway's one tracer (``GET /v1/traces/<id>`` reads it)."""
        return self.engine.tracer

    def start(self, timeout_s: float = 120.0) -> "Gateway":
        """Start the engine thread (a failure to build it raises here),
        then the HTTP server."""
        self.engine.start(timeout_s)
        try:
            self.server.start()
        except BaseException:
            self.engine.stop()
            raise
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self.server.close()
        self.engine.stop(timeout_s)

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def report(self):
        return self.engine.report()
