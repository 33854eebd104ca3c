"""Cluster-state encoding: dictionary, compiled selectors, NodeInfo, cache, snapshot."""

from .dictionary import MISSING, Dictionary  # noqa: F401
