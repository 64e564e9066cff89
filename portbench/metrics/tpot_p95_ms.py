"""tpot_p95_ms: 95th percentile over every request that finished inside the
window of (finish - first token) / (outputs - 1) (host clock)."""

from portbench.readers import tpot_p95_ms as read  # noqa: F401
