"""Scheduling actions (reference ``pkg/scheduler/actions``).

Importing this package registers every builtin action, mirroring the blank
imports in ``cmd/kube-batch/main.go:36-41``.
"""

from scheduler_tpu_torch.actions import factory as _factory  # noqa: F401
