"""Registers the builtin plugins (reference ``plugins/factory.go:33-42``):
every builtin of the JAX package.  The proportion plugin solves its deserved
shares with the host water-fill (the JAX package's ``SCHEDULER_TPU_QFAIR=host``
flavor); the device water-fill is not ported."""

from scheduler_tpu_torch.framework.registry import register_plugin_builder
from scheduler_tpu_torch.plugins import (
    binpack,
    conformance,
    drf,
    gang,
    nodeorder,
    predicates,
    priority,
    proportion,
)

register_plugin_builder("gang", gang.new)
register_plugin_builder("priority", priority.new)
register_plugin_builder("drf", drf.new)
register_plugin_builder("proportion", proportion.new)
register_plugin_builder("predicates", predicates.new)
register_plugin_builder("nodeorder", nodeorder.new)
register_plugin_builder("conformance", conformance.new)
register_plugin_builder("binpack", binpack.new)
