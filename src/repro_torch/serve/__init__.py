"""repro_torch.serve -- serving harness: bucket routing, warmup, latency."""
from .buckets import Bucket, as_bucket, bucket_grid, route
from .server import DEFAULT_BUCKETS, Server, ServeResult, warmup

__all__ = [
    "Bucket", "as_bucket", "bucket_grid", "route",
    "Server", "ServeResult", "warmup", "DEFAULT_BUCKETS",
]
