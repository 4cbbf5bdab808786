"""HTTP service (reference: src/http/)."""

from pegasus_tpu_torch.http.http_server import MetricsHttpServer
