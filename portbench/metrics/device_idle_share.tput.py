"""device_idle_share.tput: per cent of the traced sub-window in which no
kernel ran on the card (1 - union of kernel intervals / its length)."""

from portbench.readers import idle_share as read  # noqa: F401
