"""Device operations a step in the traced window."""

from perfbench.metrics._common import launches_per_step as read  # noqa: F401
