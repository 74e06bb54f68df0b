"""Registers the builtin actions this port carries (reference
``actions/factory.go:29-35``): allocate only."""

from scheduler_tpu_torch.actions import allocate
from scheduler_tpu_torch.framework.registry import register_action

register_action(allocate.new())
