"""In-process control plane: a plain object store with watch fan-out plays
the apiserver role for the scheduler."""

from .store import ObjectStore, WatchEvent  # noqa: F401
