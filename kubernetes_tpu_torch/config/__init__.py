"""ComponentConfig on the port (reference: the JAX package's config/)."""

from .componentconfig import (  # noqa: F401
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    PluginEnable,
    PluginSet,
    build_plugins_for_profile,
    load_config,
    scheduler_from_config,
)
