"""setup_s: seconds from the process's start to the window's start (host clock)."""

from portbench.readers import setup_s as read  # noqa: F401
