"""Registers the builtin actions (reference ``actions/factory.go:29-35``):
enqueue, allocate, backfill, preempt and reclaim, as the JAX package does."""

from scheduler_tpu_torch.actions import allocate, backfill, enqueue, preempt, reclaim
from scheduler_tpu_torch.framework.registry import register_action

register_action(enqueue.new())
register_action(allocate.new())
register_action(backfill.new())
register_action(preempt.new())
register_action(reclaim.new())
