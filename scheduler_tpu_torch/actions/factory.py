"""Registers the builtin actions this port carries (reference
``actions/factory.go:29-35``): enqueue, allocate and backfill."""

from scheduler_tpu_torch.actions import allocate, backfill, enqueue
from scheduler_tpu_torch.framework.registry import register_action

register_action(enqueue.new())
register_action(allocate.new())
register_action(backfill.new())
