"""Array-level aggregates of one device placement, for the bulk commit path.

The fused engine returns an int32 result code per task (ops/fused.py); turning
that into cluster state touches four ledgers — node idle/releasing/used, job
allocated, DRF per-job shares, proportion per-queue shares.  Computing each
ledger's delta per task through ``ResourceVec`` costs ~100k Python object
round-trips per ledger per cycle; a ``CommitPlan`` computes every ledger in a
handful of segment reductions over the snapshot tensors instead (C++ kernels
via ``scheduler_tpu_torch.native`` with numpy fallbacks), and the object-model code
only applies the resulting dense rows.

Numerical identity: the request matrix rows ARE copies of each task's
``resreq.array`` (tensors.build_task_tensors_columnar), and segment summation performs
the same f64 adds ``sum_rows`` would — byte-identical results, not epsilon-
close ones.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from scheduler_tpu_torch import native


class CommitPlan:
    """Per-ledger dense deltas for one fused placement result.

    Arrays are aligned to the engine's flat task order:
      matrix   f64 [T, R]  raw request rows (resreq, not init_resreq — every
                           ledger in the commit path accounts resreq)
      node_id  i32 [T]     target node index, -1 when unplaced/failed
      pipelined bool [T]   placed onto releasing resources
      job_ids  i32 [T]     index into job_uids
      queue_ids i32 [T]    index into queue_uids (-1 when unknown)
    """

    def __init__(
        self,
        matrix: np.ndarray,
        node_id: np.ndarray,
        pipelined: np.ndarray,
        job_ids: np.ndarray,
        queue_ids: np.ndarray,
        node_names: Sequence[str],
        job_uids: Sequence[str],
        queue_uids: Sequence[str],
    ) -> None:
        self.matrix = matrix
        self.node_id = node_id
        self.pipelined = pipelined
        self.job_ids = job_ids
        self.queue_ids = queue_ids
        self.node_names = list(node_names)
        self.job_uids = list(job_uids)
        self.queue_uids = list(queue_uids)

        placed = node_id >= 0
        self._alloc_seg = np.where(placed & ~pipelined, node_id, -1).astype(np.int32)
        self._pipe_seg = np.where(placed & pipelined, node_id, -1).astype(np.int32)
        self._placed = placed
        self._node_deltas: Optional[Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]]] = None
        self._job_alloc: Optional[Dict[str, np.ndarray]] = None
        self._job_all: Optional[Dict[str, np.ndarray]] = None
        self._queue_all: Optional[Dict[str, np.ndarray]] = None

    # -- ledgers -------------------------------------------------------------

    def node_deltas(self) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]]:
        """name -> (idle_sub, releasing_sub, used_add, n_alloc, n_pipe) for
        every node that received at least one placement.  Matches the
        accounting of ``NodeInfo.add_task`` folded over the batch: allocated
        tasks subtract idle, pipelined tasks subtract releasing, both add used."""
        if self._node_deltas is None:
            s = len(self.node_names)
            idle_sub = native.segment_sum(self.matrix, self._alloc_seg, s)
            rel_sub = native.segment_sum(self.matrix, self._pipe_seg, s)
            alloc_n = native.segment_count(self._alloc_seg, s)
            pipe_n = native.segment_count(self._pipe_seg, s)
            out: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]] = {}
            for k in np.nonzero(alloc_n + pipe_n)[0]:
                out[self.node_names[k]] = (
                    idle_sub[k], rel_sub[k], idle_sub[k] + rel_sub[k],
                    int(alloc_n[k]), int(pipe_n[k]),
                )
            self._node_deltas = out
        return self._node_deltas

    def _job_sums(self, seg_source: np.ndarray) -> Dict[str, np.ndarray]:
        s = len(self.job_uids)
        seg = np.where(seg_source >= 0, self.job_ids, -1).astype(np.int32)
        sums = native.segment_sum(self.matrix, seg, s)
        counts = native.segment_count(seg, s)
        return {self.job_uids[k]: sums[k] for k in np.nonzero(counts)[0]}

    def job_alloc(self) -> Dict[str, np.ndarray]:
        """uid -> summed resreq of this batch's ALLOCATED placements (the
        ``JobInfo.allocated`` delta; pipelined tasks are not allocated-status)."""
        if self._job_alloc is None:
            self._job_alloc = self._job_sums(self._alloc_seg)
        return self._job_alloc

    def job_alloc_counts(self) -> Dict[str, int]:
        """uid -> number of ALLOCATED placements in this batch — lets the
        commit path detect Allocated tasks that predate this plan (and fall
        back to per-task accounting for the bind ledger)."""
        s = len(self.job_uids)
        seg = np.where(self._alloc_seg >= 0, self.job_ids, -1).astype(np.int32)
        counts = native.segment_count(seg, s)
        return {self.job_uids[k]: int(counts[k]) for k in np.nonzero(counts)[0]}

    def job_all(self) -> Dict[str, np.ndarray]:
        """uid -> summed resreq of ALL placements (DRF shares grow on
        pipeline too, drf.go:135-154)."""
        if self._job_all is None:
            self._job_all = self._job_sums(
                np.where(self._placed, np.int32(0), np.int32(-1))
            )
        return self._job_all

    def queue_all(self) -> Dict[str, np.ndarray]:
        """queue uid -> summed resreq of ALL placements (proportion shares)."""
        if self._queue_all is None:
            s = len(self.queue_uids)
            seg = np.where(self._placed, self.queue_ids, -1).astype(np.int32)
            sums = native.segment_sum(self.matrix, seg, s)
            counts = native.segment_count(seg, s)
            self._queue_all = {self.queue_uids[k]: sums[k] for k in np.nonzero(counts)[0]}
        return self._queue_all

    def bind_deltas(
        self, ready_job_uids: Iterable[str]
    ) -> Tuple[Dict[str, Tuple[np.ndarray, int]], Dict[str, np.ndarray]]:
        """Cache-side aggregates for dispatching ready jobs' allocated tasks:
        (node name -> (idle_sub/used_add row, count), job uid -> allocated sum).
        Only allocated (non-pipelined) rows of ready jobs dispatch."""
        ready = set(ready_job_uids)
        ready_mask = np.asarray(
            [uid in ready for uid in self.job_uids], dtype=bool
        )
        row_ready = ready_mask[np.clip(self.job_ids, 0, None)] & (self.job_ids >= 0)
        seg = np.where(row_ready, self._alloc_seg, -1).astype(np.int32)
        s = len(self.node_names)
        sums = native.segment_sum(self.matrix, seg, s)
        counts = native.segment_count(seg, s)
        nodes = {
            self.node_names[k]: (sums[k], int(counts[k]))
            for k in np.nonzero(counts)[0]
        }
        jobs = {uid: row for uid, row in self.job_alloc().items() if uid in ready}
        return nodes, jobs
