"""External wire connector: SchedulerCache over a remote API server.

The seam the reference fills with client-go informers + REST clients
(cache.go:256-336, :447-487): list+watch ingestion in, Binder/Evictor/
StatusUpdater RPCs out, failure -> resync.  Ingestion speaks one of two
protocols (``SCHEDULER_TORCH_WIRE``, docs/INGEST.md): the bespoke journal
(``client.ApiConnector``) or Kubernetes-conformant per-resource LIST+WATCH
reflectors (``reflector.K8sApiConnector``).  ``mock_server`` is the
system-of-record stand-in for e2e tests and local development — it serves
both protocols.
"""

from scheduler_tpu_torch.connector.client import (
    ApiConnector,
    Backoff,
    ConnectorBase,
    HttpBinder,
    HttpEvictor,
    HttpStatusUpdater,
    TokenBucket,
    connect_cache,
    wire_from_env,
)
from scheduler_tpu_torch.connector.reflector import K8sApiConnector, Reflector

__all__ = [
    "ApiConnector",
    "Backoff",
    "ConnectorBase",
    "HttpBinder",
    "HttpEvictor",
    "HttpStatusUpdater",
    "K8sApiConnector",
    "Reflector",
    "TokenBucket",
    "connect_cache",
    "wire_from_env",
]
