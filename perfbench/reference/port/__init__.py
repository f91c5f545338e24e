"""Frozen copy of the port's plain arithmetic (see ``perfbench/reference``)."""
