"""mfu.ttft: per cent of the card's int8 peak (1,979 TOP/s) that the
operations the window's served tokens need are, over the window's wall time
(``yardstick.Model``: padding and idle rows not counted)."""

from portbench.readers import mfu as read  # noqa: F401
