"""The share of the traced window in which no operation ran on the device,
in percent."""

from benchmark.trace import idle_percent as read  # noqa: F401
