"""Registers the builtin plugins this port carries (reference
``plugins/factory.go:33-42``): priority, gang, drf and binpack."""

from scheduler_tpu_torch.framework.registry import register_plugin_builder
from scheduler_tpu_torch.plugins import binpack, drf, gang, priority

register_plugin_builder("gang", gang.new)
register_plugin_builder("priority", priority.new)
register_plugin_builder("drf", drf.new)
register_plugin_builder("binpack", binpack.new)
