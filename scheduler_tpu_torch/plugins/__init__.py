"""Builtin scheduling policies (reference ``pkg/scheduler/plugins``).

Importing this package registers every builtin plugin builder — the analogue of
the reference's blank imports in ``cmd/kube-batch/main.go:36-41``.
"""

from scheduler_tpu_torch.plugins import factory as _factory  # noqa: F401
