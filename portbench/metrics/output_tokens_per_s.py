"""output_tokens_per_s: every output token produced inside the window, first
tokens included, over the window's seconds (host clock)."""

from portbench.readers import output_tokens_per_s as read  # noqa: F401
