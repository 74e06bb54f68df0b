"""The XLA step arm of the ``fused_allocate`` loop: one step's selection,
batch sizing and node-row update as plain PyTorch operations on the device.

The JAX loop (``scheduler_tpu/ops/fused.py:175-1030``) takes this arm where
the placement-step kernel is gated off: the session has releasing capacity
(the pipeline arm needs each node's idle and releasing fit), the top-2
score bound is live (runs batch under scorers other than binpack alone:
the bound needs the whole masked score vector), or the node state outgrows
the kernel's budget.  There it is XLA code outside any Pallas kernel, so
here it is tensor operations on the engine's device, each JAX operation
one PyTorch operation in the same order:

* the epsilon fit ``init < avail | |avail - init| < min`` on every dim,
  against idle alone or jointly against idle and releasing
  (``fused.py:704-725``), the node gate, the static mask row and the pod
  count (``:726-731``);
* ``ops/scoring.py::dynamic_score`` plus the static score row, the masked
  lowest-index argmax and the winner's feasibility (``:732-743``);
* the alloc / pipe split at the winner (``:745-753``);
* with run batching, the batch size: the ``MAX_BATCH`` candidate grid of
  sequential fits on the winner and, under the score bound, the runner-up
  (``others``, ``second``, ``second_idx``) and the grid's scores against it
  with a running product (``:757-833``);
* the winner's node-row add, ``-req * (alloc * m)`` on idle, ``-req *
  pipe`` on releasing, the placed copies on the task count (``:846-864``).

The node state ``[N, 2R + 1]`` (idle | releasing | task count) stays on
the device for the whole loop.  Each step reads back five integers in one
copy: the winner, whether it was feasible, whether it was allocated or
pipelined, and the copies placed.  Everything else of the loop (job and
queue selection, the job ledger, the codes) is the host's
(``ops/fused.py``).  On CUDA the events around each step's device work
are summed into ``xla_ms``.
"""

from __future__ import annotations

import torch

from scheduler_tpu_torch.ops.scoring import dynamic_score

# Upper bound on placements a step (``ops/fused.py`` MAX_BATCH).
MAX_BATCH = 128


class XlaStep:
    """The arm bound for one loop: the node state staged on ``allocatable``'s
    device from the host's ``idle`` / ``releasing`` / ``task_count``; the
    other operands are the loop's device tensors (``static_mask`` /
    ``static_score`` [S, N] rows, read at the row the caller names).

    ``step(t_idx, s_idx, hi0)`` runs one step for task row ``t_idx`` with
    static row ``s_idx`` and the host's batch cap ``hi0`` (the run length,
    ``MAX_BATCH`` and the gang room; read only with ``batch_runs``, and a
    cap of 1 places one copy without the candidate grid) and
    returns ``(best, feasible, alloc_here, pipe_here, m)`` as Python
    values, after adding the winner's row to the node state."""

    def __init__(self, idle, releasing, task_count, allocatable, pods_limit, node_gate, mins,
                 init_resreq, resreq, static_mask, static_score, *, weights, use_static,
                 enforce_pod_count, has_releasing, batch_runs, score_bound):
        dev = allocatable.device
        f32 = torch.float32
        self.device = dev
        n, r_dim = allocatable.shape
        self.n, self.r_dim = n, r_dim
        self.node_state = torch.cat([
            torch.as_tensor(idle, dtype=f32).reshape(n, r_dim),
            torch.as_tensor(releasing, dtype=f32).reshape(n, r_dim),
            torch.as_tensor(task_count).to(f32).reshape(n, 1),
        ], dim=1).to(dev).contiguous()
        self.allocatable = allocatable
        self.safe_alloc = torch.where(allocatable > 0, allocatable, 1.0)
        self.pods_limit = pods_limit
        self.pods_limit_f = pods_limit.to(f32)
        self.node_gate = node_gate
        self.mins = mins
        self.init_resreq, self.resreq = init_resreq, resreq
        self.static_mask, self.static_score = static_mask, static_score
        self.weights = tuple(float(w) for w in weights)
        self.use_static = use_static
        self.enforce_pod_count = enforce_pod_count
        self.has_releasing = has_releasing
        self.batch_runs = batch_runs
        self.score_bound = score_bound
        self.lanes = torch.arange(n, device=dev)
        self.js = torch.arange(1, MAX_BATCH + 1, dtype=torch.int32, device=dev)
        self.js_f = (self.js - 1).to(f32)
        self.neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
        self.false = torch.zeros((), dtype=torch.bool, device=dev)
        self.one = torch.ones((), dtype=torch.int32, device=dev)
        self.cuda = dev.type == "cuda"
        self.xla_ms = 0.0 if self.cuda else None
        self.steps = 0
        if self.cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))

    def _fit(self, init_req, avail):
        """The epsilon fit of ``init_req`` [R] against avail [..., R] on
        every dim (``scheduler_tpu/ops/predicates.py:20-27``)."""
        return ((init_req < avail) | ((avail - init_req).abs() < self.mins)).all(dim=-1)

    def step(self, t_idx: int, s_idx: int, hi0: int):
        if self.cuda:
            self._ev[0].record()
        r_dim, ns = self.r_dim, self.node_state
        init_req, req = self.init_resreq[t_idx], self.resreq[t_idx]
        idle = ns[:, :r_dim]
        if self.has_releasing:
            # Joint fit against idle and releasing in one op chain.
            avail2 = ns[:, : 2 * r_dim].reshape(-1, 2, r_dim)
            ok2 = self._fit(init_req, avail2)
            fit_idle, fit_rel = ok2[:, 0], ok2[:, 1]
            feasible = (fit_idle | fit_rel) & self.node_gate
        else:
            fit_idle = fit_rel = None
            feasible = self._fit(init_req, idle) & self.node_gate
        if self.use_static:
            feasible = feasible & self.static_mask[s_idx]
        if self.enforce_pod_count:
            feasible = feasible & (ns[:, 2 * r_dim] < self.pods_limit_f)
        score = dynamic_score(req, idle, self.allocatable, *self.weights,
                              safe_alloc=self.safe_alloc)
        if self.use_static:
            score = score + self.static_score[s_idx]
        masked = torch.where(feasible, score, self.neg_inf)
        best = torch.argmax(masked)
        any_feasible = masked[best] > self.neg_inf
        if self.has_releasing:
            alloc_here = any_feasible & fit_idle[best]
            pipe_here = any_feasible & ~fit_idle[best] & fit_rel[best]
        else:
            alloc_here = any_feasible
            pipe_here = self.false
        if self.batch_runs and hi0 > 1:
            # (With a host cap of 1 the grid's answer is 1 whatever it
            # holds: the batch block is skipped.)
            if self.enforce_pod_count:
                tc_best = ns[best, 2 * r_dim]
                room = self.pods_limit[best] - tc_best.to(torch.int32)
                hi = torch.clamp(torch.clamp(room, max=hi0), min=1)
            else:
                hi = max(hi0, 1)
            idle_b = idle[best]
            avail = idle_b[None, :] - self.js_f[:, None] * req[None, :]
            ok_js = self._fit(init_req, avail)
            if self.score_bound:
                # Top-2 bound: placement j still picks best while its score
                # after j - 1 placements beats the runner-up (lowest index on
                # ties); a prefix, since non-binpack scores are not monotone.
                others = torch.where(self.lanes == best, self.neg_inf, masked)
                second = others.max()
                second_idx = torch.argmax(others)
                alloc_b = self.allocatable[best][None, :].expand(MAX_BATCH, r_dim)
                safe_b = self.safe_alloc[best][None, :].expand(MAX_BATCH, r_dim)
                s_js = dynamic_score(req, avail, alloc_b, *self.weights, safe_alloc=safe_b)
                if self.use_static:
                    s_js = s_js + self.static_score[s_idx, best]
                ok_s = (s_js > second) | ((s_js == second) & (best < second_idx))
                ok_js = ok_js & (torch.cumprod(ok_s.to(torch.int32), 0, dtype=torch.int32) > 0)
            fit_count = torch.where(ok_js & (self.js <= hi), self.js, 1).max()
            m = torch.where(alloc_here, fit_count, 1).to(torch.int32)
        else:
            m = self.one
        # The winner's node row: idle -= req * m if allocated, releasing -=
        # req if pipelined, task count += the copies placed.
        m_f = m.to(torch.float32)
        copies = torch.where(alloc_here, m, 1)
        row = torch.cat([
            -req * (alloc_here * m_f),
            -req * pipe_here,
            ((alloc_here | pipe_here) * copies).to(torch.float32)[None],
        ])
        ns.index_add_(0, best.reshape(1), row[None, :])
        packed = torch.stack([best.to(torch.int32), any_feasible.to(torch.int32),
                              alloc_here.to(torch.int32), pipe_here.to(torch.int32), m])
        if self.cuda:
            self._ev[1].record()
        best_i, ok, alloc_i, pipe_i, m_i = packed.tolist()
        if self.cuda:
            self.xla_ms += self._ev[0].elapsed_time(self._ev[1])
        self.steps += 1
        return best_i, bool(ok), bool(alloc_i), bool(pipe_i), m_i

    def close(self) -> None:
        """Nothing to release: the node state is dropped with the arm."""
