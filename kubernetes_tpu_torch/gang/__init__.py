"""Gang scheduling: only the in-batch all-or-nothing mask is ported (gang
members themselves are outside this slice; ROADMAP Queue A item 8)."""

from .device import gang_all_or_nothing

# pods join a gang through this label (the JAX package's gang/directory.py)
POD_GROUP_LABEL = "pod-group.scheduling/name"

__all__ = ["POD_GROUP_LABEL", "gang_all_or_nothing"]
