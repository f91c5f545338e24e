"""The device's idle share of the traced window, %."""

from perfbench.metrics._common import idle_share as read  # noqa: F401
