"""The port stands alone: ``scheduler_tpu_torch`` imports neither JAX nor any
module of the JAX package, and its entry points run on the GPU unless the
caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "scheduler_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "scheduler_tpu"


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter (this process already holds JAX): import every
    module of the port, then no jax or scheduler_tpu module may be loaded."""
    code = """
import importlib, pkgutil, sys
before = set(sys.modules)
import scheduler_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scheduler_tpu_torch.__path__, "scheduler_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in set(sys.modules) - before
                if m.split(".")[0] in ("jax", "jaxlib", "scheduler_tpu"))
print(len(names), loaded)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.strip().split(" ", 1)
    assert int(count) > 40
    assert loaded == "[]"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import open_session
    from scheduler_tpu_torch.harness import make_synthetic_cluster
    from scheduler_tpu_torch.ops.fused import FusedAllocator
    from scheduler_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = make_synthetic_cluster(4, 20, tasks_per_job=5).cache
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(cache)
    ssn = open_session(cache, parse_scheduler_conf(
        'actions: "allocate"\ntiers:\n- plugins:\n  - name: gang\n').tiers)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedAllocator(ssn, collect_candidates(ssn), device=None)
    engine = FusedAllocator(ssn, collect_candidates(ssn), device="cpu")
    assert engine.device.type == "cpu" and engine.use_mega
