"""ttft_p95_ms: 95th percentile of the time to first token over every request
whose first token came inside the window (host clock); a failed request
counts as never."""

from portbench.readers import ttft_p95_ms as read  # noqa: F401
