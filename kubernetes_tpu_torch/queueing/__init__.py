"""Scheduling queue."""

from .priority_queue import PriorityQueue, QueuedPodInfo  # noqa: F401
