#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scheduler_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

What it does, one JSON line per phase:

1. device: the card, the CUDA version, the one build of every kernel of
   the port from ``scheduler_tpu_torch/csrc`` (seconds, registers per
   thread), and the host commit's C++ library
   (``scheduler_tpu_torch/native``, built with ``$CXX``), which must build
   and load.
2. main_path, on paths a to r', each on a freshly built cluster that no
   other session has touched, through ``Scheduler.run_once`` on the card,
   with every kernel's launch count set to 0 just before and read just
   after: a to k, n to p and r, r' a cold cycle each (a scheduler's first
   cycle after start-up), l and m the cycles after it (the engine resident
   across cycles), q and q' the daemon's:
   a. BASELINE config 2, the kubemark density scenario (priority, gang, drf,
      predicates, nodeorder; 1,000 nodes x 5,000 bare pods, half of them
      selecting a zone): ``static_predicate_mask`` builds the selector mask
      rows and ``mega_allocate`` runs in its static-row mode.  Checks: no
      node overcommitted or past 110 pods, every zone selector honoured.
   b. the flagship, BASELINE config 3 (priority, gang, drf, binpack; 10,000
      nodes x 100,000 pods in gangs of 100): ``mega_allocate`` in cursor
      mode.  Checks: no node overcommitted, every gang bound whole or not at
      all.
   c. config3_templates: config 3's nodes and conf, 5,000 gangs of 20 pods,
      each gang with its own request template (``job_template_request``):
      5,000 request signatures close the mega gate, and the engine runs the
      ``fused_allocate`` loop with one ``placement_step`` launch a step.
      Checks as for b.
   d. the multi-queue flagship (``bench.py`` with three queues): config 3's
      cluster with its gangs dealt to queues q0, q1, q2 of weights 1:2:3
      and proportion in the conf: ``mega_allocate`` in multi-queue mode.
      Checks: 100,000 binds in 1,000 whole gangs, no node overcommitted, the
      queue chain's evidence.
   e. BASELINE config 5, GPU topology gangs (config 2's plugins; 1,500
      nodes of 8 GPUs x 1,000 gangs of 8 one-GPU pods, each gang selecting
      one of 8 zones): ``static_predicate_mask`` and ``mega_allocate`` in
      static-row mode at r_dim 3.  Checks: 8,000 binds, every pod in its
      zone, no node past its 8 GPUs.
   f. config 2 under the plugin tiers of the JAX package's default conf
      (conformance and proportion join; allocate only): one queue, but
      ``mega_allocate`` runs in multi-queue mode with static rows after
      ``static_predicate_mask``.  Checks: config 2's, and binds equal to the
      port's host loop on a twin cluster.
   g. the qfair ladder flagship (``bench.py``'s multi-queue family at the
      widest and deepest shape the ladder admits,
      ``harness.make_mq_ladder_cluster``: 10,000 nodes, 100 queues of
      weights 1..100, one request class a queue, r_dim 8; the multi-queue
      conf; at a quarter of the flagship's depth, ``LADDER_PATH_PODS``:
      25,000 single-pod jobs, 250 a queue): proportion's water-fill as one
      ``qfair_solve`` launch, then ``mega_allocate`` in multi-queue mode
      with the qfair ladder.  Checks: the ladder engaged (251 rungs, 100
      classes, a converged solve), one rung lookup a placement, no node
      overcommitted in any of its 8 dims or past 110 pods; then, on a
      session of the same cluster, the device water-fill's deserved rows
      bit for bit the host water-fill's.
   h. BASELINE config 4 after its reclaim
      (``harness.make_reclaim_aftermath_cluster``: queues fat and thin of
      weight 1, 1,000 nodes of 26 x (2 cpu, 4 GiB), 25,000 running fat pods
      of which the 12,500 of every odd-numbered gang are evicted and still
      releasing, 50,000 pending thin pods in gangs of 50; allocate over
      priority, gang and proportion): ``mega_allocate`` in multi-queue mode
      with releasing capacity.  Checks: one launch, the ladder declined
      for releasing capacity, tasks both allocated and pipelined, on every
      node the allocated requests within its idle and the pipelined ones
      within its releasing capacity in every dim and at most 110 pods;
      later, the binds, pipelined tasks and statuses equal to the port's
      host loop on a twin cluster (a child beside the kernel phases).
   i. config3_templates' gangs under the default conf's tiers
      (``TIERS_TEMPLATES``: 1,000 nodes x 5,000 gangs of 6, the largest
      shape the fused gate admits with the predicates plugin's static
      rows): proportion makes the one queue multi-queue, nodeorder's
      weights with runs turn the top-2 score bound on, and the 5,000
      templates close the mega gate, so the ``fused_allocate`` loop runs
      its XLA step arm: one ``xla_step`` launch a step
      (``csrc/xla_step.cu``).  Checks: one launch a step and no other loop
      kernel, K3's rows, no node overcommitted, gangs whole, proportion's
      overused gate; after the cycle, every step of the arm replayed from
      its starting state, each result the main path's and the kernel held
      to its plain version on a clone of the node state at the first step
      and every 200th; the first ``XLA_CHECK_STEPS`` steps replayed again,
      the kernel held to its plain version at each, and timed (profiler
      device time, events, the host round trip; the plain version's
      events); later the codes bitwise those of the same loop on the CPU
      (a child beside the kernel phases), and at 0.1 scale of the nodes the
      fused route's binds equal to the host loop's.
   j. config3_templates (10,000 nodes x 5,000 gangs of 20) dealt to
      queues q0, q1, q2 of weights 1:2:3 under the multi-queue conf: the
      loop with one ``placement_step`` launch a step and the loop's
      multi-queue pop.  Checks as for i, one launch a step; then, in the
      same child, the loop on a second cluster with the kernel held to its
      plain version every 200 steps, and with the plain version on the
      card: equal codes.  At 0.1 scale its fused route and host loop are
      compared and the binds that differ counted (the JAX package's fused
      route and host loop disagree on such sessions too).
   k. config 4's aftermath at half scale (``RECLAIM_TEMPLATES_SCALE``: 500
      nodes) whose 25,000 thin pods ask 5,000 distinct requests
      (``RECLAIM_THIN_REQUESTS``): the mega gate closes and the
      loop runs its releasing arm on the XLA step arm (``xla_step``).
      Checks as for h, one ``xla_step`` launch a step, the replays as for
      i; later the codes bitwise the CPU loop's, and
      the binds, pipelined tasks and statuses the host loop's.
   l. the flagship by the JAX package's steady protocol
      (``harness.measure.steady_cycle_phases``: b's cluster and conf, the
      engine built once through the engine cache, then a timed cycle that
      hits it and launches ``mega_allocate`` before the host rebinds), then
      five cycles of config 3's churn (``harness.config3_churn``: a tenth
      of the gangs retired and as many new gangs of 100), each timed as it
      comes.  Checks: the steady cycle hits with one K2 launch, binds all
      100,000 pods in whole gangs, and its bind map's digest is b's; each
      churn cycle rebuilds with one K2 launch; no node overcommitted.
      Prints the steady cycle's phases, uploads and K2's events ms, and
      the churn cycles' p50 and p99 seconds.  Then the steady hit again on
      a fresh cluster with ``SCHEDULER_TORCH_NATIVE=0`` (the numpy halves of
      the host commit): the same binds, its ``apply`` beside the native
      run's (``native_ab``).
   m. the JAX default conf's loop: six cycles of ``Scheduler.run_once``
      with no conf (enqueue, allocate, backfill over the default tiers) on
      config 2's cluster plus 1,000 BestEffort pods and a backlog of gangs
      created Pending (``default_conf_cluster``), 50 pods completing on 50
      nodes before each of cycles 3-6.  Checks: the engine cache's outcomes
      ``DEFAULT_CONF_OUTCOMES`` (miss, rebuild, four hits, each hit's
      refresh sparse), K2 once a cycle, K3 in cycle 1 only, enqueue's
      admissions, backfill's binds, every backlog gang whole and the
      waiting ones pending, no node overcommitted or past 110 pods, every
      selector honoured; later, per cycle, binds and task statuses equal to
      a cold twin (``SCHEDULER_TORCH_ENGINE_CACHE=0``, a child beside the
      untimed phases).
   n. the production conf (``deploy/scheduler-conf.yaml``: enqueue,
      reclaim, allocate, backfill, preempt over the JAX default tiers) on
      b's cluster: the static rows (5 bytes x 131,072 x 16,384) are far
      past the fused limit, so allocate takes the device route, the per-pop
      engine (``ops/allocator.py``): K3 builds the predicates' mask rows on
      the card and ``place_scan`` runs once a job pop.  Checks: the route,
      one ``place_scan`` launch a pop, K3, no node overcommitted, every gang
      whole or unbound.  Prints pops, tasks scanned, the scan's summed event
      ms (events recorded by the kernel's entry point immediately around
      each launch), the host ms in its wrapper, ``device_pops`` split into
      scan, wrapper and the rest, and reclaim's and preempt's phase
      seconds.  Then, after the timed cycle, ``place_scan`` replays the
      first ``SCAN_CHECK_POPS`` pops from the engine's starting node state
      against its plain version (codes and node state bitwise, codes equal
      to the main path's) and is timed on the first (events and profiler
      device time; its launch plan: 16 CTAs, the node slice on chip).
   n'. f's cluster with ``SCHEDULER_TORCH_FUSED_STATIC_LIMIT=1``: the
      device route on the default tiers.  Checks: the route, config 2's;
      later the binds equal to the host loop's (the twin f is held to).
      Prints the same split as n, and replays and times its first
      ``SCAN_CHECK_POPS`` pops the same way (one-task pops: the small-n
      plan, one CTA on the global arm).
   o. BASELINE config 4 before its reclaim (``harness.make_reclaim_cluster``,
      at half scale, ``RECLAIM_O_SCALE``: 500 nodes, 12,500
      running fat pods, 25,000 pending thin ones) through ``reclaim,
      allocate`` over priority, gang, proportion.
      Checks: evictions only from the queue overused when reclaim began, no
      gang below its floor, on every node the pipelined requests within its
      victims' (``reclaim_invariants``), allocate's one ``mega_allocate``
      launch; later the evictions in order, binds and statuses equal to the
      same cycle on the CPU (a child beside the untimed phases).
   o'. o's cluster built anew, with ``SCHEDULER_TORCH_EVICT=device``: the
      eviction engine (``ops/evict.py::EvictEngine``) plans every hunt
      (about 500 evictions) and the action replays the plans; then K2 as in o.
      Checks: the engine engaged, o's checks, the evictions in order, binds
      and statuses equal to o's; prints ``action:reclaim`` beside o's and
      the engine's phase split (score, mask, plan, replay).  It runs in o's
      twin, after the go, beside the untimed phases.
   p. the backfill wave (``harness.backfill_wave.BackfillWaveConfig()`` at
      half its size, ``BACKFILL_WAVE``: 1,024 nodes of pod limit 22 with 14
      running pods each, 10,000 BestEffort pods, every third one
      zone-pinned, seed 0) through
      backfill over the predicates plugin with
      ``SCHEDULER_TORCH_BACKFILL=device``: K3 builds the class rows of the
      engine (``ops/backfill.py::BackfillEngine``), which fills the runs
      and replays them.  Checks: engaged on 5 classes, 8,192 binds, no
      node past its pod limit, every pinned pod in its zone, 1,808 pods
      left pending with a FitErrors each, one K3 launch; K3 on the wave's
      signature operands against its plain version (timed); the two
      flavors on an eighth of the wave (256 nodes, 2,500 pods) on the card:
      binds, FitErrors strings and counters equal.  In a child beside the
      untimed phases.
   q. the daemon over the wire (``daemon_config2``): a's cluster as
      ``kubectl``-shaped documents (``harness.kubemark_density_documents``)
      in the port's mock API server, a process of its own; then
      ``scheduler_tpu_torch.cli.main`` in the child's main thread with
      ``--api-server``, the k8s wires in and out (one bind POST a pod), the
      CUDA default device and a 0.5 s schedule period, until a watcher
      thread sees every pod bound on the server (300 s at most), reads
      ``/healthz``, ``/metrics`` and ``/debug/cycles`` and sends SIGTERM.
      Checks: 5,000 binds, K3 and K2 launched, ``main`` returned, the binds
      those of one ``Scheduler.run_once`` on the same documents preloaded
      through ``cli.load_cluster_state`` in the server's LIST order (a's
      checks on them).  Prints the seconds to the first cycle, its time and
      phases, the seconds to the last bind, bind POSTs, retries, resyncs,
      K3's and K2's launches and device ms.
   q'. the churn rig (``harness.churn.run_churn_bench``) on the daemon's
      event loop: k8s LIST+WATCH in, the batched legacy dialect out,
      ``CHURN_CONF`` (K2 in cursor mode through the engine cache), at
      ``CHURN_CARD`` (1,000 nodes, 10,000 placed pods in gangs of 50, 32
      pending, 16 lanes, 1,000 arrivals/s for 8 s after a 1.5 s warmup,
      4x bursts of 0.25 s every 2 s, seed 0).  Checks: drained, K2
      launched, no node overcommitted, no pending pod that fits.  Prints
      p50, p99 and max cycle ms, the sustained rate, events a cycle, the
      engine cache's outcomes and the dirty counts.  q and q' run in one
      child (``--child daemon_wire``) started after ``e2e_small``, beside
      the kernel cases and the checks.
   r. the flagship under the LP flavor: b's cluster and conf with
      ``SCHEDULER_TORCH_ALLOCATOR=lp`` and signature classes (the default
      ``auto``): ``lp_relax`` iterates over the class rows, then the repair,
      the ``fused_allocate`` loop on its XLA step arm with the marginals as
      its static score, one ``xla_step`` launch a step.  Checks: one
      ``lp_relax`` launch, classes engaged (their count printed), no node
      overcommitted, every gang whole or unbound, binds at least (1 -
      ``LP_BIND_TOLERANCE``) x b's, the ``lp`` quality block printed; the
      kernel on r's own operands against its plain version (the
      marginals within ``LP_KERNEL_RTOL`` of the plain version's plus
      ``LP_KERNEL_ATOL``; pref and evidence equal; two launches bitwise;
      all-zero marginals fail the same check), timed beside
      ``torch.matmul`` for the load product.
   r'. config 2 under the LP flavor task by task (a's cluster and conf,
      ``SCHEDULER_TORCH_SIG_COMPRESS=off``: [8,192 x 1,024] rows, K3's
      mask rows as the static mask).  Checks: a's, binds at least (1 -
      ``LP_BIND_TOLERANCE``) x a's, K3 launched, two cycles on twin
      clusters give the same codes; the kernel on r''s operands as for r.
      On r and r' no node's load passes its capacity, so the projection
      never binds (``converged_at`` 0); the kernel is therefore also held
      to its plain version on ``lp_operands`` at r''s shape and capacity
      columns with requests of twice the cluster (``LP_TIGHT_SEED``): the
      projection must bind there, and the first iteration's marginals (no
      projection) must fail the check.
      r and r' run in one child (``--child lp_paths``) after the storms.
   Each prints the phase seconds and the engine's time from CUDA events
   (the kernel's; for i and k the ``xla_step`` launches summed, and per
   step, beside the host time of the arm's C calls);
   d, f, i, j and k also the water-fill's evidence and why the ladder
   declined.  d to o each run in a child process of the script, after one
   config-1 cycle there (``--child``, ``child_main``), so that the garbage
   collection at the head of the cycle walks that path's cluster alone.
   Then the preempt storms (``STORM_CASES``: ``tests/test_evict_parity.py``'s
   storm clusters, ``storm_spec``, through reclaim and preempt, and the JAX
   bench's saturated storm, ``PreemptStormConfig()``, through allocate and
   preempt), in a child, each on the card and on the CPU in both flavors
   of the victim hunt (``SCHEDULER_TORCH_EVICT``): evictions in order,
   statuses and binds equal, the device flavor engaged.  A flavor set to
   ``device`` whose engine declines where the script expects it to engage
   fails the run.
3. kernel_vs_plain: each kernel's wrapper against its plain PyTorch version
   on the same CUDA tensors, bitwise.  ``mega_allocate`` (codes and stats):
   BASELINE config 1, a 1,000 x 10,000 flagship session, a case with
   non-binpack weights and the pod-count gate, a 12,000-job case whose job
   ledger lives in global scratch, four small static-row sessions, seven
   synthetic cases across the launch plans (``MEGA_SYNTHETIC``), four in
   multi-queue mode (``MEGA_SYNTHETIC_MQ``), the 1:9 starvation session
   (also on the full-recompute queue chain, timed), three with the qfair
   ladder (``MEGA_SYNTHETIC_LADDER``, both instantiations), the ladder
   flagship's shape at 1,000 nodes x 20 queues x 200 jobs a queue (also on
   the full-recompute chain, timed), sixteen with releasing capacity
   (``MEGA_SYNTHETIC_REL``: the four releasing instantiations up to the
   16-CTA plan, ties across CTAs, releasing-only winners, the pod-count
   gate), the one-queue mid-evict session and config 4's aftermath at 2 %,
   and the operands of the main paths a to f and h that run it at full
   size from second clusters built the same way (timed: profiler device
   time and events, µs a step, the launch plan; their plain
   versions run on third clusters built the same way in a child,
   ``--child full_size_plain``, which builds them beside the timed phases
   and runs the plain K2 after the script's go, and the timed kernel's
   stats must equal its twin's).
   Path g's operands (100 queues of 250 job lanes): the ladder against the
   delta chain on the same operands, equal codes, each timed three times in
   turns; and against its plain version on the same operands (timed; its
   25,001 steps take minutes, so in a child process of the script,
   ``--child mq_ladder_plain``, which builds its cluster and engine beside
   the timed phases and runs the kernel and its plain version beside the
   untimed ones, as do the
   synthetic cases, ``--child kernel_cases_synthetic``).  ``qfair_solve``:
   the ladder flagship's water-fill (timed, beside the host water-fill's
   time and bits, with its chain floor: rounds x 2 x Q x the latency of a
   float64 add, ``DADD_NS``) and random fleets of 0 to 1,100 queues and 2
   to 40 dims.
   ``static_predicate_mask``: config 2's real operands
   (timed), a wide random case (4,096 signatures x 10,000 nodes, timed) and
   empty label / taint vocabularies.  ``placement_step`` (all four outputs;
   its device duration from a profiler trace, the events around each
   launch, launches queued back to back and the host round trip of a loop
   step with a push, 200 launches each): the templates loop's first step,
   config 2's operands, a random case at 65,536 nodes and an all-infeasible
   one; and
   loop_parity (``--child loop_parity``, after the last timed phase): the
   templates loops of c and j on second clusters, once with the kernel
   (held to its plain version at the first step and every 200th) and once
   with the plain version on the card, equal codes.  The node mesh's arms,
   timed on the main paths' operands: K2's mesh mode on b's (its plain
   check in ``full_size_plain``), K1 on the first of four node blocks of
   c's first step, the XLA arm's shard mode at i's shape
   (``xla_shard_record``, each shard held to its plain version) and
   ``lp_relax`` over four blocks of r''s logits (in ``lp_paths``, held to
   its plain version and to the one-device kernel).  ``xla_step``
   (the five results and the node state): the planted cases
   (``XLA_STEP_PLANTS``: ties across threads and strides, the winner and
   runner-up on stride edges, a runner-up tie, nothing feasible, pod room 0 and 1, a
   grid fit that fails and passes again, a score prefix that cuts the
   batch), each checked with the plain version to hold its property, then
   timed (profiler device time, events, round trip) beside the plain
   version's events.
4. e2e_small: the fused route on the card against the host loop on small
   clusters, bind for bind (one of them, 4,200 single-pod jobs of distinct
   requests, on the loop route with K1; one with releasing capacity; one
   with both, on the loop's releasing arm).
5. mesh paths s-v (``--child mesh_paths``, after the last timed phase): the
   node mesh (``SCHEDULER_TORCH_MESH``) over four copies of the card, each
   path a cold ``Scheduler.run_once`` on a fresh cluster whose codes must
   equal one device's on the same cluster and whose engine must run on the
   mesh (``_mesh`` engaged, four devices): s. b on ``4`` (K2's mesh mode;
   also b's binds); t. c on ``2x2`` (the loop's K1 on every shard, each
   held to its plain version every 200th step) and on ``4``; u. i and k
   on ``4`` (the XLA arm's shard mode, checked likewise); v. r' on ``4``
   (``lp_relax`` over node blocks, held to its plain version and to one
   device).  Then the saturated storm under the device eviction flavor and
   p's eighth under the device backfill flavor, on ``4`` and on one device:
   equal evictions, statuses and binds.

Then the ``kernels`` line (with each kernel's launches on every path that
runs it, l's to p's included; ``place_scan``'s entry below the TPU
kernels' from paths n and n', with its launch plan; ``xla_step``'s from
paths i and k and the planted cases; ``qfair_solve``'s with its chain
floor; ``lp_relax``'s from paths r' and r, its plan, a solve of one
kernel launch and an iteration;
then the mesh arms' entries with their launches on paths s-v),
the card's name and power
limit as nvidia-smi prints them, and as the last line ``{"ok": true,
"device": {...}}``.  Any
failure exits non-zero; with no CUDA device, or without the port beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import random
import subprocess
import sys
import time

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, float32 and float64 rates outside the tensor cores, and the int8
# tensor-core rate (dense).  They set each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
INT8_OPS_PER_S = 1979e12

GIB = 2.0**30

FLAGSHIP_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: binpack
"""

CONFIG1_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
"""

# BASELINE config 2 (scripts/scenario_ladder.py scenario 2).
CONFIG2_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: predicates
  - name: nodeorder
"""

# The multi-queue flagship (bench.py with SCHEDULER_TPU_BENCH_QUEUES=3):
# proportion's share order and overused gate join the flagship's plugins.
MULTIQ_CONF = FLAGSHIP_CONF.replace("  - name: binpack\n",
                                    "  - name: proportion\n  - name: binpack\n")
# Its queues: config 3's gangs dealt round-robin to three queues of weights
# 1:2:3, as bench.py builds them.
MQ_QUEUES = ("q0", "q1", "q2")
MQ_WEIGHTS = {"q0": 1, "q1": 2, "q2": 3}

# BASELINE config 5 (scripts/scenario_ladder.py): 1,500 nodes, 1,000 gangs of 8.
CONFIG5_NODES = 1500
CONFIG5_GANGS = 1000

# The qfair ladder flagship (bench.py's multi-queue family, one_mq_cycle, at
# the widest and deepest shape the mega kernel and the ladder admit):
# 10,000 nodes, queues q0..q99 of weights 1..100, 100,000 single-pod jobs
# (1,000 a queue: 1,001 rungs), one request class a queue over 6 scalars
# (r_dim 8), the multi-queue flagship's conf.
LADDER_NODES = 10_000
LADDER_PODS = 100_000
LADDER_QUEUES = 100
LADDER_VOCAB = 6
# Path g runs the ladder flagship at its width and a quarter of its depth
# (the same nodes and queues, 250 jobs a queue: 25,001 steps), and K2's
# plain check runs on path g's own operands: at the full depth the 100,001
# plain steps took 488 s beside the daemon child, past the script's limit,
# and at half depth the 50,001 bounded the script's tail beside the mesh
# paths' children.
LADDER_PATH_PODS = LADDER_PODS // 4
# The ladder session at the size its plain version runs in seconds.
LADDER_SMALL = (1000, 4000, 20, 6)

# Path i: config3_templates' gangs (one request template a gang, 5,000
# templates close the mega gate) under the JAX default conf's tiers.  With
# the predicates plugin on, both packages' fused gate
# (``FusedAllocator.supported``) admits at most 160 MiB of [T, N] static rows
# (5 bytes x task bucket x node bucket): at 10,000 x 100,000 the session
# would take the host loop, so path i runs at the largest shape the gate
# admits with the 5,000 templates, 1,000 nodes x 5,000 gangs of 6 (buckets
# 1,024 x 32,768: exactly 160 MiB).
TIERS_TEMPLATES = (1000, 5000, 6)
# The host-loop twins of paths i and j at 0.1 scale of their nodes; 5,000
# gangs of 2 keep the mega gate closed.
TIERS_TEMPLATES_TWIN = (100, 5000, 2)
MQ_TEMPLATES_TWIN = (1000, 5000, 2)
# Path k: config 4's aftermath with 5,000 distinct thin requests.
RECLAIM_THIN_REQUESTS = 5000
# Path k at half config 4's scale (500 nodes, 25,000 pending thin pods of
# the 5,000 requests), with its CPU and host-loop twins: the host loop's twin
# bounded the script's time.
RECLAIM_TEMPLATES_SCALE = 0.5
# Paths o and o' (and o's CPU twin) at half config 4's scale: 500 nodes,
# 12,500 running fat pods, 25,000 pending thin pods, about 500 evictions.
RECLAIM_O_SCALE = 0.5
# Path p at half the JAX bench's wave: 1,024 nodes, 10,000 BestEffort pods.
BACKFILL_WAVE = {"nodes": 1024, "wave_pods": 10_000}

# BASELINE config 4 after its reclaim (``harness.make_reclaim_aftermath_cluster``):
# the next cycle's allocate over config 4's plugins.
RECLAIM_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: proportion
"""

# BASELINE config 4 through a real reclaim (scripts/scenario_ladder.py
# scenario 4's conf, then allocate): path o.
RECLAIM_ALLOCATE_CONF = RECLAIM_CONF.replace('actions: "allocate"',
                                             'actions: "reclaim, allocate"')

# The production conf the deploy manifests pass (all five actions over the
# JAX default tiers): path n, at the flagship's cluster.
PRODUCTION_CONF = os.path.join("deploy", "scheduler-conf.yaml")
# Path n's first pops whose operands hold place_scan to its plain version.
SCAN_CHECK_POPS = 64
# The LP flavor's quality gate: its binds at least (1 - this) x greedy's
# (``scripts/bench_gate.py`` LP_BIND_TOLERANCE, docs/LP_PLACEMENT.md).
LP_BIND_TOLERANCE = 0.02

# tests/test_evict_parity.py's storm clusters (seed, queues) through its
# full conf's tiers, reclaim then preempt: the preempt phase.
STORM_CASES = ((7, 1), (7, 2), (42, 1), (42, 2), (1234, 1), (1234, 2))
STORM_CONF = """
actions: "reclaim, preempt"
tiers:
- plugins:
  - name: conformance
  - name: gang
  - name: priority
  - name: drf
  - name: proportion
  - name: binpack
"""

# The plugin tiers of the JAX package's default conf (scheduler_tpu/conf.py),
# allocate only: one queue, but proportion makes the session multi-queue.
DEFAULT_TIERS_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# The static-row sessions of the JAX package's tests.
PREDICATES_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: predicates
  - name: nodeorder
"""

# Config 2's plugins with the memory-pressure gate on.
# tests/test_lp_place.py's STATIC_CONF: the predicates' static rows under
# nodeorder, no proportion.
PREDICATES_LP_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: predicates
  - name: nodeorder
"""
PRESSURE_CONF = CONFIG2_CONF.replace(
    "  - name: predicates\n",
    "  - name: predicates\n    arguments:\n      predicate.MemoryPressureEnable: \"true\"\n",
)


def emit(obj, stamp=True) -> None:
    """One JSON line of the script's output, stamped with the wall clock
    (``time``, seconds since the epoch: the children's lines share it) but
    the contract's ``kernels`` and last lines."""
    print(json.dumps(dict(obj, time=round(time.time(), 3)) if stamp else obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# -- clusters -------------------------------------------------------------------

def config1_cluster():
    """BASELINE config 1 (example/job.yaml): a 3-task gang on 3 nodes."""
    from scheduler_tpu_torch.api.vocab import ResourceVocabulary
    from scheduler_tpu_torch.apis.objects import (
        GROUP_NAME_ANNOTATION, NodeSpec, PodGroup, PodSpec, Queue,
    )
    from scheduler_tpu_torch.cache.cache import SchedulerCache

    cache = SchedulerCache(vocab=ResourceVocabulary(), async_io=False)
    cache.run()
    cache.add_queue(Queue(name="default", weight=1))
    for i in range(3):
        cache.add_node(NodeSpec(name=f"n{i}", allocatable={
            "cpu": 2000.0, "memory": 4 * 2.0**30, "pods": 110}))
    pg = PodGroup(name="qj", namespace="default", queue="default", min_member=3)
    pg.status.phase = "Inqueue"
    pg.creation_timestamp = 1_700_000_000.0
    cache.add_pod_group(pg)
    for t in range(3):
        pod = PodSpec(name=f"qj-{t}", namespace="default",
                      containers=[{"cpu": 1000.0, "memory": 2.0**30}],
                      annotations={GROUP_NAME_ANNOTATION: "qj"})
        pod.creation_timestamp = 1_700_000_000.0 + (t + 1) * 1e-6
        cache.add_pod(pod)
    return cache


def uniform_gang_request(j: int, t: int):
    """Identical requests within each gang (so runs batch and cohorts spill),
    three shapes across gangs."""
    del t
    return {"cpu": [250.0, 500.0, 1000.0][j % 3],
            "memory": [256.0, 512.0, 1024.0][j % 3] * 2.0**20}


def job_template_request(n_jobs: int, seed: int = 0):
    """Per-job request templates (``harness.job_template_request`` of the
    port): job j's pods ask cpu 125m * (1 + c % 64) and memory 256 MiB * (1
    + c // 64) for a cell c drawn without replacement from a 64 x 128 grid."""
    from scheduler_tpu_torch.harness import job_template_request as requests

    return requests(n_jobs, seed)


def template_cluster(n_nodes: int, n_jobs: int, tasks_per_job: int,
                     pkg: str = "scheduler_tpu_torch", **kw):
    """The flagship's nodes and gangs (``make_synthetic_cluster`` of package
    ``pkg``) with per-job request templates (``job_template_request``):
    ``n_jobs`` gangs of ``tasks_per_job`` pods, min_member the whole gang;
    ``kw`` goes to ``make_synthetic_cluster`` (queues, node sizes)."""
    harness = importlib.import_module(f"{pkg}.harness")
    return harness.make_synthetic_cluster(
        n_nodes, n_jobs * tasks_per_job, tasks_per_job=tasks_per_job,
        request_fn=job_template_request(n_jobs), **kw).cache


def releasing_templates_cluster(pkg: str = "scheduler_tpu_torch"):
    """More than 4,096 request signatures (``template_cluster(16, 4200, 1)``:
    4,200 single-pod jobs of distinct requests) and one evicted 8-cpu pod
    whose node still releases its capacity: a releasing session that the
    mega gate closes, so the loop runs its releasing arm."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    cache = template_cluster(16, 4200, 1, pkg)
    pg = objects.PodGroup(name="old", namespace="default", queue="default", min_member=1)
    pg.status.phase = "Running"
    cache.add_pod_group(pg)
    cache.add_pod(objects.PodSpec(
        name="old-0", namespace="default", containers=[{"cpu": 8000.0, "memory": 16 * GIB}],
        annotations={objects.GROUP_NAME_ANNOTATION: "old"}, node_name=sorted(cache.nodes)[0],
        phase="Running"))
    for task in list(cache.jobs["default/old"].tasks.values()):
        cache.evict(task, "reclaim")
    return cache


def step_operands(seed, n, r_dim, *, infeasible=False, ties=False, exact=False):
    """Placement-step operands in the JAX layout, as numpy arrays drawn from
    ``numpy.random.default_rng(seed)``: cpu in millicores and memory in MiB
    (the device units), idle a random share of allocatable, task counts
    against pod limits, static rows; ``infeasible`` asks more cpu than any
    node has, ``ties`` makes every node alike.

    By default capacities, requests and idle shares are arbitrary, so the
    score terms round in float32 and a change of operation order shows.
    With ``exact`` capacities and requests are powers of two and idle a
    multiple of allocatable / 64, so every score term is exact in float32.
    The CPU tests need that for one combination only: under all three
    weights with static rows, XLA's CPU backend contracts the JAX kernel's
    balanced term into a fused multiply-add (1 ulp apart on rounding
    operands), which the port, like its CUDA build (``--fmad=false``),
    never does."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r8 = 8
    alloc = np.zeros((r8, n), np.float32)
    if exact:
        alloc[0] = rng.choice([4096, 16384, 65536], n)
        alloc[1] = rng.choice([8192, 65536, 262144], n)
    else:
        alloc[0] = rng.choice([4000, 16000, 64000], n) - rng.integers(0, 1000, n)
        alloc[1] = rng.choice([8000, 64000, 262144], n) - rng.integers(0, 4000, n)
    if r_dim > 2:
        alloc[2:r_dim] = rng.integers(0, 8, (r_dim - 2, n))
    if exact:
        idle = (alloc * rng.integers(0, 65, (r8, n)) / 64).astype(np.float32)
    else:
        idle = (alloc * rng.random((r8, n))).astype(np.float32)
    if ties:
        alloc[:, :] = alloc[:, :1]
        idle[:, :] = idle[:, :1]
    ns = np.zeros((r8 + 8, n), np.float32)
    ns[:r8] = idle
    ns[r8] = rng.integers(0, 30, n)
    req = np.zeros((r8, 1), np.float32)
    if exact:
        req[0, 0], req[1, 0] = rng.choice([128, 512, 2048]), rng.choice([256, 1024, 8192])
    else:
        req[0, 0], req[1, 0] = rng.integers(100, 3000), rng.integers(100, 9000)
    if r_dim > 2:
        req[2:r_dim, 0] = rng.integers(0, 2, r_dim - 2)
    initq = np.full((r8, 1), -1.0, np.float32)
    initq[:r_dim] = req[:r_dim]
    if infeasible:
        initq[0, 0] = 1e9
    mins = np.zeros((r8, 1), np.float32)
    mins[:r_dim, 0] = [10.0, 10.0] + [0.1] * (r_dim - 2)
    gate = (rng.random((1, n)) < 0.9) | ties
    plim = rng.integers(10, 40, (1, n)).astype(np.float32)
    smask = (rng.random((1, n)) < 0.8) | ties
    sscore = (rng.integers(0, 5, (1, n)) * (0 if ties else 1)).astype(np.float32)
    return [ns, alloc, smask, sscore, gate, plim, initq, req, mins]


def lp_operands(seed, rows, n, r_dim=2, *, pod_count=True, static=True, classes=False,
                tight=True):
    """The LP relaxation's session operands (``ops/lp_place.py::lp_relax``),
    as numpy arrays drawn from ``numpy.random.default_rng(seed)`` in the
    device units: ``rows`` request rows over ``n`` nodes (a tenth of the
    nodes gated off, pod limits against task counts, static mask rows with
    a few all-infeasible rows and static scores), ``r_dim`` resource dims.
    With ``tight`` the requests ask about twice what the cluster holds, so
    the projection scales nodes down.  With ``classes`` the rows are
    signature classes and ``class_count`` (f32, the last eighth 0: pad
    classes) weights their load.  Returns a dict of the keyword names of
    ``lp_relax``'s operands."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r_dim), np.float32)
    alloc[:, 0] = rng.choice([4000, 16000, 64000], n) - rng.integers(0, 1000, n)
    alloc[:, 1] = rng.choice([8000, 64000, 262144], n) - rng.integers(0, 4000, n)
    if r_dim > 2:
        alloc[:, 2:] = rng.integers(0, 8, (n, r_dim - 2))
    idle = (alloc * rng.random((n, r_dim))).astype(np.float32)
    req = np.zeros((rows, r_dim), np.float32)
    req[:, 0] = rng.integers(100, 3000, rows)
    req[:, 1] = rng.integers(100, 9000, rows)
    if r_dim > 2:
        req[:, 2:] = rng.integers(0, 2, (rows, r_dim - 2))
    count = None
    if classes:
        count = rng.integers(1, 400, rows).astype(np.float32)
        count[rows - rows // 8:] = 0.0
    if tight:
        # Scale the requests (to at most half the largest idle cpu a node
        # has) and then the class counts so that the rows ask about twice
        # the cluster's idle cpu.
        mult = count if count is not None else np.ones(rows, np.float32)
        goal = 2.0 * float(idle[:, 0].sum())
        factor = min(goal / max(float(mult @ req[:, 0]), 1.0),
                     0.5 * float(idle[:, 0].max()) / float(req[:, 0].max()))
        req[:, :2] = np.floor(req[:, :2] * np.float32(factor)) + 1.0
        if count is not None:
            count[count > 0] = np.ceil(
                count[count > 0] * max(goal / float(count @ req[:, 0]), 1.0))
    mask = rng.random((rows, n)) < 0.85
    mask[rng.random(rows) < 0.05] = False
    return dict(
        idle=idle, allocatable=alloc,
        task_count=rng.integers(0, 30, n).astype(np.int32),
        pods_limit=rng.integers(20, 40, n).astype(np.int32),
        node_gate=rng.random(n) < 0.9,
        static_mask=mask if static else np.ones((1, n), bool),
        static_score=(rng.integers(0, 5, (rows, n)).astype(np.float32) if static
                      else np.zeros((1, n), np.float32)),
        mins=np.asarray([10.0, 10.0] + [0.1] * (r_dim - 2), np.float32),
        init_resreq=req.copy(), resreq=req, class_count=count,
        flags=dict(weights=(1.0, 0.0, 2.0), enforce_pod_count=pod_count, use_static=static),
    )


def lp_iterate_operands(ops, device, tau=0.25):
    """``(logits, cap, req_aug)`` of ``lp_operands`` on ``device``: the
    iteration's operands as ``lp_relax`` builds them."""
    import torch

    from scheduler_tpu_torch.ops import lp_place

    t = {k: torch.as_tensor(v, device=device) for k, v in ops.items()
         if k not in ("flags", "class_count")}
    flags = ops["flags"]
    logits, _ = lp_place.logits_and_feasibility(
        t["idle"], t["allocatable"], t["task_count"], t["pods_limit"], t["node_gate"],
        t["static_mask"], t["static_score"], t["mins"], t["init_resreq"], t["resreq"],
        tau=tau, **flags)
    cap, req_aug = lp_place.capacity(t["idle"], t["task_count"], t["pods_limit"], t["resreq"],
                                     flags["enforce_pod_count"])
    if ops["class_count"] is not None:
        req_aug = req_aug * torch.as_tensor(ops["class_count"], device=device)[:, None]
    return logits, cap.contiguous(), req_aug.contiguous()


# The lp_relax kernel against its plain version on the card: the row sums and
# the load sums run in other orders (a block tree and chunks of rows in the
# kernel, torch's reductions and matmul in the plain version), so a
# projection differs in the last bits and 200 iterations carry them into
# log_v, which scales a marginal: the error is relative.  A marginal may be
# as small as 1 / nodes (10,000 equal nodes give 1e-4), so the limit is
# relative, with an absolute floor far under any marginal that counts.
# pref and the evidence row are equal.
LP_KERNEL_RTOL = 1e-4
LP_KERNEL_ATOL = 1e-8

# The seed of the tight operands at r''s shape (``lp_operands``).
LP_TIGHT_SEED = 16


def lp_marginal_errors(x, ref) -> dict:
    """The kernel's marginals ``x`` against the plain version's ``ref``: the
    largest absolute error and the largest error over its limit
    (``over_tol``, passing at most 1: |x - ref| <= LP_KERNEL_RTOL * |ref| +
    LP_KERNEL_ATOL in every cell)."""
    d = (x - ref).abs()
    limit = LP_KERNEL_RTOL * ref.abs() + LP_KERNEL_ATOL
    return {"max_abs_err": float(d.max()), "over_tol": float((d / limit).max())}

# Kernel cases: (seed, rows, n, r_dim, classes, pod_count, static, tight, iters),
# across the launch plan (``lp_place.lp_plan``: whole rows a CTA and node
# tiles, one row tile and many, every capacity column count up to r_dim 8
# plus the pod count, r''s 16 classes over 16,384 nodes).
LP_KERNEL_CASES = {
    "one_row": (27, 1, 5, 2, False, True, True, True, 200),
    "small": (1, 16, 64, 2, False, True, True, False, 200),
    "chunks": (2, 600, 300, 2, False, True, True, True, 200),
    "classes": (3, 40, 2000, 3, True, True, False, True, 200),
    "wide": (4, 8, 20_000, 2, True, False, False, True, 200),
    "dims9": (5, 64, 128, 8, False, True, True, True, 200),
    "one_iteration": (6, 300, 257, 2, False, True, True, True, 1),
    "two_iterations": (7, 300, 257, 4, True, True, True, True, 2),
    "flagship_classes": (8, 16, 16_384, 2, True, False, False, True, 200),
}


def scan_operands(seed, n, t, r_dim=2, *, exact=False, score=True, infeasible=False,
                  n_rows=None):
    """Placement-scan operands in the JAX layout (``scheduler_tpu/ops/
    placement.py``'s ``_place_scan``), as numpy arrays drawn from
    ``numpy.random.default_rng(seed)``: ``n`` nodes with cpu in millicores
    and memory in MiB (the device units), idle a share of allocatable that
    runs out within a few placements, releasing capacity beside it (so the
    scan pipelines), task counts against pod limits, ``n_rows`` task rows
    (default ``t``) of which the scan takes the first ``t`` in a shuffled
    order (``rows``), their static mask rows (about 80 % feasible) and, with
    ``score``, static score rows (else None).  ``infeasible`` makes the
    first task ask more cpu than any node has.

    With ``exact`` capacities and requests are powers of two and idle and
    releasing multiples of allocatable / 64, so every score term and every
    sum of them is exact in float32: the CPU tests need that wherever two
    terms meet, since XLA's CPU backend contracts a product into the sum
    that follows it (a fused multiply-add, 1 ulp apart on rounding
    operands), which the port, like its CUDA build (``--fmad=false``),
    never does."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_rows = t if n_rows is None else n_rows
    alloc = np.zeros((n, r_dim), np.float32)
    if exact:
        alloc[:, 0] = rng.choice([4096, 16384, 65536], n)
        alloc[:, 1] = rng.choice([8192, 65536, 262144], n)
        idle = alloc * rng.integers(0, 9, (n, r_dim)) / 64
        releasing = alloc * rng.integers(0, 17, (n, r_dim)) / 64
    else:
        alloc[:, 0] = rng.choice([4000, 16000, 64000], n) - rng.integers(0, 1000, n)
        alloc[:, 1] = rng.choice([8000, 64000, 262144], n) - rng.integers(0, 4000, n)
        idle = alloc * rng.random((n, r_dim)) * 0.15
        releasing = alloc * rng.random((n, r_dim)) * 0.3
    if r_dim > 2:
        alloc[:, 2:] = rng.integers(0, 8, (n, r_dim - 2))
        idle[:, 2:] = alloc[:, 2:]
        releasing[:, 2:] = 0.0
    req = np.zeros((n_rows, r_dim), np.float32)
    if exact:
        req[:, 0] = rng.choice([128, 512, 2048], n_rows)
        req[:, 1] = rng.choice([256, 1024, 8192], n_rows)
    else:
        req[:, 0] = rng.integers(100, 3000, n_rows)
        req[:, 1] = rng.integers(100, 9000, n_rows)
    if r_dim > 2:
        req[:, 2:] = rng.integers(0, 2, (n_rows, r_dim - 2))
    init = req.copy()
    if infeasible:
        init[0, 0] = 1e9
    rows = rng.permutation(n_rows)[:t].astype(np.int32)
    return {
        "idle": idle.astype(np.float32), "releasing": releasing.astype(np.float32),
        "task_count": rng.integers(0, 30, n).astype(np.int32), "allocatable": alloc,
        "pods_limit": rng.integers(10, 40, n).astype(np.int32),
        "mins": np.asarray([10.0, 10.0] + [0.1] * (r_dim - 2), np.float32),
        "init_resreq": init, "resreq": req,
        "static_mask": rng.random((n_rows, n)) < 0.8,
        "static_score": (rng.integers(0, 5, (n_rows, n)).astype(np.float32) if score else None),
        "rows": rows,
    }


PLANT_SCORE = 5.0


# -- the loop's XLA step arm: operands and planted cases -------------------------------

# The step's flags on the planted cases (the default conf's nodeorder weights
# with the pod count, static rows, releasing capacity, batching and the
# score bound: every branch of the kernel), per case overrides below.
XLA_STEP_FLAGS = dict(weights=(1.0, 1.0, 0.0), use_static=True, enforce_pod_count=True,
                      has_releasing=True, batch_runs=True, score_bound=True)


def xla_step_operands(seed, n, r_dim=2, *, t_rows=4, s_rows=3, releasing=True):
    """XLA-step operands as numpy arrays drawn from
    ``numpy.random.default_rng(seed)``: cpu in millicores and memory in MiB,
    idle (and, with ``releasing``, releasing) a random share of
    allocatable, task counts against pod limits, ``t_rows`` task rows and
    ``s_rows`` static rows.  Keys are ``XlaStep``'s operand names, the node
    state ``[n, 2 r + 1]`` (idle | releasing | task count) under
    ``node_state``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r_dim), np.float32)
    alloc[:, 0] = rng.choice([4000, 16000, 64000], n) - rng.integers(0, 1000, n)
    alloc[:, 1] = rng.choice([8000, 64000, 262144], n) - rng.integers(0, 4000, n)
    alloc[:, 2:] = rng.integers(0, 8, (n, r_dim - 2))
    idle = (alloc * rng.random((n, r_dim))).astype(np.float32)
    rel = (alloc * rng.random((n, r_dim)) * 0.5).astype(np.float32) if releasing else \
        np.zeros((n, r_dim), np.float32)
    tc = rng.integers(0, 30, n).astype(np.float32)
    req = np.zeros((t_rows, r_dim), np.float32)
    req[:, 0] = rng.integers(100, 3000, t_rows)
    req[:, 1] = rng.integers(100, 9000, t_rows)
    req[:, 2:] = rng.integers(0, 2, (t_rows, r_dim - 2))
    return {
        "node_state": np.concatenate([idle, rel, tc[:, None]], axis=1),
        "allocatable": alloc,
        "pods_limit": rng.integers(10, 40, n).astype(np.int32),
        "node_gate": rng.random(n) < 0.9,
        "mins": np.array([10.0, 10.0] + [0.1] * (r_dim - 2), np.float32),
        "init_resreq": req.copy(), "resreq": req,
        "static_mask": rng.random((s_rows, n)) < 0.8,
        "static_score": rng.integers(0, 5, (s_rows, n)).astype(np.float32),
    }


# kind -> (nodes, resource dims, flag overrides, host cap hi0).  Each plants
# the property its name says on task row 0 and static row 0, with the
# planted nodes placed by the launch plan's thread count (node j is thread
# j mod threads's, in stride j div threads); ``xla_plant_failures`` checks
# the property with the plain version.
XLA_STEP_PLANTS = {
    "ties_across_strides": (3000, 2, {}, 128),
    "stride_edges": (3000, 2, {}, 128),
    "runner_up_tie": (3000, 2, {}, 128),
    "infeasible": (3000, 2, {}, 128),
    "pod_room_0": (3000, 2, {}, 128),
    "pod_room_1": (3000, 2, {}, 128),
    # A request of -inf on a scalar dim: the grid's j = 1 reads idle - 0 *
    # -inf (NaN, no fit) and every later j +inf (a fit), so the fit is not
    # a prefix; with finite requests it always is.  Binpack alone: no score
    # bound, whose prefix would hide the max.
    "grid_gap": (3000, 3, dict(weights=(0.0, 0.0, 1.0), score_bound=False), 128),
    "score_cut": (3000, 2, dict(weights=(1.0, 0.0, 0.0)), 128),
}


def plant_xla_step(ops, kind, threads):
    """Plant ``kind`` (``XLA_STEP_PLANTS``) into ``xla_step_operands``'s
    arrays in place, the nodes placed by the plan's ``threads``: the same
    thread's nodes in two strides, different warps, the first stride's last
    thread and the last node.  Returns the planted nodes by role."""
    import numpy as np

    ns, alloc = ops["node_state"], ops["allocatable"]
    n, r_dim = alloc.shape
    mid, last = threads // 2, n - 1
    if last <= mid + threads:
        raise ValueError(f"XLA-step plant {kind!r}: {n} nodes are under two strides of {threads}")
    if kind == "infeasible":
        ops["init_resreq"][0, 0] = 1e9
        return {}

    def only(nodes, scores):
        # Every node infeasible but ``nodes``: empty big nodes alike but for
        # their static score row.
        ops["node_gate"][:] = False
        for j, sc in zip(nodes, scores):
            ops["node_gate"][j] = True
            alloc[j] = [64000.0, 262144.0] + [8.0] * (r_dim - 2)
            ns[j, :r_dim] = alloc[j]
            ns[j, r_dim:2 * r_dim] = 0.0
            ns[j, 2 * r_dim] = 0.0
            ops["pods_limit"][j] = 100
            ops["static_mask"][0, j] = True
            ops["static_score"][0, j] = sc
        ops["resreq"][0] = [1000.0, 2000.0] + [1.0] * (r_dim - 2)
        ops["init_resreq"][0] = ops["resreq"][0]

    if kind == "ties_across_strides":
        nodes = sorted({mid, mid + threads, threads - 1, last})
        only(nodes, [3.0] * len(nodes))
        return {"tied": nodes}
    if kind == "stride_edges":
        w, r = last, threads - 1
        only([w, r], [4.0, 2.0])
        return {"best": w, "second": r}
    if kind == "runner_up_tie":
        a, b, c = mid, threads, last
        only([a, b, c], [4.0, 2.0, 2.0])
        return {"best": a, "second": min(b, c), "tied": sorted({b, c})}
    if kind in ("pod_room_0", "pod_room_1"):
        p, q = last, threads
        only([p, q], [4.0, 2.0])
        if kind == "pod_room_0":
            ns[p, 2 * r_dim] = ops["pods_limit"][p] = 20
            return {"full": p, "best": q}
        ns[p, 2 * r_dim] = ops["pods_limit"][p] - 1
        return {"best": p}
    if kind == "grid_gap":
        w = last
        only([w], [1.0])
        ops["resreq"][0, 2] = -np.inf
        ops["init_resreq"][0, 2] = 0.0
        return {"best": w}
    if kind == "score_cut":
        w, r = threads, 0
        only([w, r], [0.0, 0.0])
        ns[r, 0] -= 5 * ops["resreq"][0, 0]
        return {"best": w, "second": r}
    raise ValueError(f"unknown XLA-step plant {kind!r}")


def xla_plant_case(kind, plan=None, seed=0):
    """A planted case's numpy operands, flags, host cap and planted roles,
    for ``plan`` (default: ``xla_step.step_plan``'s for its size)."""
    from scheduler_tpu_torch.ops import xla_step

    n, r_dim, overrides, hi0 = XLA_STEP_PLANTS[kind]
    ops = xla_step_operands(seed, n, r_dim)
    plan = plan or xla_step.step_plan(n)
    roles = plant_xla_step(ops, kind, plan.threads)
    return ops, dict(XLA_STEP_FLAGS, **overrides), hi0, roles


def xla_plant_failures(kind, ops, flags, hi0, roles):
    """The plain version on a CPU copy of a planted case: the properties
    its kind claims that do not hold (an empty list: all hold)."""
    import numpy as np
    import torch

    from scheduler_tpu_torch.ops import xla_step

    t = {k: torch.from_numpy(np.array(v)) for k, v in ops.items()}
    detail = {}
    best, ok, alloc_here, pipe, m = xla_step.xla_step_reference(
        t["node_state"], t["allocatable"], t["pods_limit"], t["node_gate"], t["mins"],
        t["init_resreq"], t["resreq"], t["static_mask"], t["static_score"], 0, 0, hi0,
        detail=detail, **flags)
    masked = detail["masked"]
    top = masked.max()
    wrong = []

    def need(cond, what):
        if not cond:
            wrong.append(what)

    if kind == "infeasible":
        need(not ok and best == 0, "nothing feasible gives node 0")
        return wrong
    need(ok, "a node is feasible")
    if "best" in roles:
        need(best == roles["best"], f"best {best} is the planted {roles['best']}")
    if kind == "ties_across_strides":
        tied = [int(j) for j in torch.nonzero(masked == top).flatten()]
        need(tied == roles["tied"] and len(tied) >= 2 and best == tied[0],
             f"the tie {tied} is the planted {roles['tied']}, won by its lowest index")
    if "second" in roles:
        need(detail["second_idx"] == roles["second"],
             f"runner-up {detail['second_idx']} is the planted {roles['second']}")
    if kind == "runner_up_tie":
        b, c = roles["tied"]
        need(bool(masked[b] == masked[c]), "the runner-up tie holds")
    if kind == "pod_room_0":
        p = roles["full"]
        need(float(ops["node_state"][p, -1]) == float(ops["pods_limit"][p]),
             "the full node has pod room 0")
    if kind == "pod_room_1":
        need(detail["hi"] == 1 and detail["ok_js"][1] and m == 1,
             f"pod room 1 caps the batch at 1 (hi {detail.get('hi')}, m {m})")
    if kind == "grid_gap":
        fits = detail["ok_js"]
        need(not fits[0] and any(fits[1:]) and m > 1,
             f"the fit fails at j = 1 and passes past it (m {m})")
    if kind == "score_cut":
        ok_s, fits = detail["ok_s"], detail["ok_js"]
        need(1 <= m < 127 and not ok_s[m] and fits[m],
             f"the score prefix cuts the batch at {m} while the fit goes on")
    if kind in ("stride_edges", "runner_up_tie", "pod_room_0", "pod_room_1", "grid_gap",
                "score_cut"):
        need(alloc_here and not pipe, "the winner is allocated")
    return wrong


def xla_arm_on(ops, flags, device, **kw):
    """An ``XlaStep`` bound to ``xla_step_operands``-style numpy arrays on
    ``device`` (keywords: ``plan``, ``plain``, ``check_every``)."""
    import numpy as np
    import torch

    from scheduler_tpu_torch.ops import xla_step

    t = {k: torch.from_numpy(np.array(v)).to(device) for k, v in ops.items()
         if k != "node_state"}
    ns = ops["node_state"]
    r_dim = ops["allocatable"].shape[1]
    return xla_step.XlaStep(ns[:, :r_dim], ns[:, r_dim:2 * r_dim], ns[:, 2 * r_dim],
                            t["allocatable"], t["pods_limit"], t["node_gate"], t["mins"],
                            t["init_resreq"], t["resreq"], t["static_mask"], t["static_score"],
                            **flags, **kw)


def xla_shard_arm_on(ops, flags, mesh, **kw):
    """An ``XlaShardStep`` over ``mesh`` bound to ``xla_step_operands``-style
    numpy arrays, the node operands split into the mesh's blocks
    (keywords: ``plan``, ``plain``, ``check_every``)."""
    import numpy as np
    import torch

    from scheduler_tpu_torch.ops import xla_step
    from scheduler_tpu_torch.ops.mesh import Sharded, family_on

    t = {k: torch.from_numpy(np.array(v)).to(mesh.first) for k, v in ops.items()
         if k != "node_state"}
    for k in ("allocatable", "pods_limit", "node_gate"):
        t[k] = Sharded.split(mesh, t[k], 0, family_on(mesh, "node_major"))
    for k in ("static_mask", "static_score"):
        t[k] = Sharded.split(mesh, t[k], 1, family_on(mesh, "node_trailing"))
    ns = ops["node_state"]
    r_dim = ops["allocatable"].shape[1]
    return xla_step.XlaShardStep(mesh, ns[:, :r_dim], ns[:, r_dim:2 * r_dim], ns[:, 2 * r_dim],
                                 t["allocatable"], t["pods_limit"], t["node_gate"], t["mins"],
                                 t["init_resreq"], t["resreq"], t["static_mask"],
                                 t["static_score"], **flags, **kw)


def plant_scan(ops, kind, slices):
    """Plant winners at a launch plan's node slices (``slices``: each CTA's
    (first node, node count), ``place_scan_kernel.node_slices``) in
    ``scan_operands``' arrays, in place.  Every static score becomes 0 but
    ``PLANT_SCORE`` on the planted nodes, which every task may take (mask
    set, cpu and memory at the largest allocatable, idle at allocatable)
    until their pod room (``task_count`` below
    ``pods_limit`` by the room) runs out; then the rest tie at 0.  Kinds:
    ``ties``, the middle node of every slice after the first, room 2
    (equal scores in different CTAs: the lowest index wins); ``edges``, the
    first and the last node of every slice, room 1 (winners on slice edges,
    one after the other across CTAs); ``ranks``, the first three nodes of
    rank 0 and the last three of the last non-empty slice, room 1
    (consecutive winners in rank 0, then in rank C - 1).  Meant for score
    weights (0, 0, 0) and the pod-count gate, so the static score is the
    whole score and the room holds.  Returns the planted nodes."""
    import numpy as np

    full = [(b, c) for b, c in slices if c > 0]
    if kind == "ties":
        nodes, room = [b + c // 2 for b, c in full[1:]], 2
    elif kind == "edges":
        nodes, room = sorted({x for b, c in full for x in (b, b + c - 1)}), 1
    elif kind == "ranks":
        (b0, c0), (bl, cl) = full[0], full[-1]
        nodes, room = sorted(set(range(b0, b0 + min(3, c0)))
                             | set(range(bl + cl - min(3, cl), bl + cl))), 1
    else:
        raise ValueError(f"plant_scan: unknown kind {kind!r}")
    nodes = np.asarray(nodes, np.int64)
    ops["static_score"][:] = 0.0
    ops["static_score"][:, nodes] = PLANT_SCORE
    ops["static_mask"][:, nodes] = True
    ops["allocatable"][nodes, :2] = (64000.0, 262144.0)
    ops["idle"][nodes] = ops["allocatable"][nodes]
    ops["task_count"][nodes] = ops["pods_limit"][nodes] - room
    return nodes


def mega_operands(seed, nb, r_dim, n_jobs, *, n_nodes=None, gated=None, alike=False,
                  infeasible_job=False, use_static=False, exact=False,
                  weights=(0.0, 0.0, 1.0), score_bound=False, enforce_pod_count=False,
                  cohort=1, max_tasks=6, comparators=("priority", "gang", "drf"),
                  queues=0, starved=False, tied=False, releasing=False, rel_only=()):
    """``mega_allocate`` operands (numpy, by ``OPERAND_NAMES``) and static
    arguments for a synthetic session drawn from
    ``numpy.random.default_rng(seed)``: ``nb`` node lanes of which the first
    ``n_nodes`` are real (90 % of them ready), ``r_dim`` resources, and
    ``n_jobs`` jobs of 1 to ``max_tasks`` tasks, each with one or two
    request signatures (so runs break inside a job), a gang deficit,
    priority, creation rank and drf usage.  Run batching, cross-job
    batching and ``cohort`` chunks are on.

    ``gated`` lists the only nodes whose gate is set; ``alike`` makes every
    node the same (equal scores: ties); ``infeasible_job`` adds a job that
    no node can hold (its chunk fails); ``use_static`` adds three static
    signatures (mask and score rows).  ``queues`` > 0 makes a multi-queue
    session (proportion's share order and overused gate, no cross-job
    batching): jobs spread over the queues but the second, which stays
    empty where there are three or more; each queue deserves a power-of-two
    fraction of the cluster and starts with none, a quarter or half of it
    allocated; ``starved`` makes queue 0 deserve almost nothing (overused
    after its first placements) and ``tied`` gives queues 1 and 2 the same
    deserved and allocated (equal shares: the lower queue index wins).
    ``releasing`` gives every real node releasing capacity (the kernel's
    releasing mode): none, half or all of what its idle leaves of
    allocatable; the nodes of ``rel_only`` have no idle and all of
    allocatable releasing (a task fits them by pipelining only).
    With ``exact`` capacities, idle
    shares and requests are powers of two or multiples of them, so every
    score term is exact in float32 (the CPU tests need that: XLA's CPU
    backend contracts the JAX kernel's multi-term score into fused
    multiply-adds)."""
    import numpy as np

    from scheduler_tpu_torch.ops.megakernel import MAX_BATCH, pack_lane_i32, pack_task_table_i32

    rng = np.random.default_rng(seed)
    f32 = np.float32
    n_nodes = nb if n_nodes is None else n_nodes
    # Nodes: cpu in cores, memory in GiB, other resources in units.
    scale = np.array([16.0, 64.0] + [4.0] * 6, f32)[:r_dim, None]
    alloc = np.zeros((8, nb), f32)
    ns0 = np.zeros((16, nb), f32)
    if alike:
        alloc[:r_dim] = scale
        ns0[:r_dim] = scale
    else:
        alloc[:r_dim, :n_nodes] = scale * rng.choice([0.5, 1.0, 2.0], (r_dim, n_nodes))
        if exact:
            share = rng.integers(0, 65, (r_dim, n_nodes)) / 64.0
        else:
            share = rng.random((r_dim, n_nodes))
        ns0[:r_dim, :n_nodes] = alloc[:r_dim, :n_nodes] * share
        ns0[8, :n_nodes] = rng.integers(0, 6, n_nodes)
    rel0 = np.zeros((8, nb), f32)
    if releasing:
        rel0[:r_dim, :n_nodes] = ((alloc[:r_dim, :n_nodes] - ns0[:r_dim, :n_nodes])
                                  * rng.choice([0.0, 0.5, 1.0], (1, n_nodes)))
        for i in rel_only:
            ns0[:r_dim, i] = 0.0
            rel0[:r_dim, i] = alloc[:r_dim, i]
    plim = np.zeros((1, nb), f32)
    plim[0, :n_nodes] = 110.0 if alike else rng.integers(6, 30, n_nodes)
    gate = np.zeros((1, nb), bool)
    if gated is None:
        gate[0, :n_nodes] = rng.random(n_nodes) < 0.9
    else:
        gate[0, list(gated)] = True

    # Request signatures; signature 0 asks more than any node holds.
    n_sig = 48
    req = np.zeros((n_sig, r_dim), f32)
    req[:, 0] = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0], n_sig)
    req[:, 1] = rng.choice([0.5, 1.0, 2.0, 8.0], n_sig)
    if r_dim > 2:
        req[:, 2:] = rng.choice([0.0, 0.5, 1.0], (n_sig, r_dim - 2))
    if not exact:
        req[:, :2] *= rng.choice([1.0, 1.1, 0.7], (n_sig, 2)).astype(f32)
    req[0, 0] = 1e6
    init = req.copy()
    s_pad = 128
    sig_req = np.zeros((16, s_pad), f32)
    sig_req[0:r_dim, :n_sig] = req.T
    sig_req[8:8 + r_dim, :n_sig] = init.T

    # Jobs and their tasks, in lane order.
    sizes = rng.integers(1, max_tasks + 1, n_jobs)
    n_static = 3
    task_sig, task_static, task_job, offsets = [], [], [], []
    a = b = 1
    st = 0
    for j, k in enumerate(sizes):
        offsets.append(len(task_sig))
        if k > 1 or rng.random() < 0.2:  # single-task jobs share runs of signatures
            a, b = rng.integers(1, n_sig, 2)
            st = int(rng.integers(0, n_static))
        if infeasible_job and j == n_jobs // 2:
            a = b = 0
        cut = int(rng.integers(1, k + 1)) if rng.random() < 0.3 else k
        task_sig += [a] * cut + [b] * (k - cut)
        task_static += [st] * k
        task_job += [j] * k
    # A run: equal signatures in one job, or across consecutive single-task
    # jobs (the cross-job batch, cursor mode only).
    n_tasks = len(task_sig)
    run_len = [1] * n_tasks
    for t in range(n_tasks - 2, -1, -1):
        same_job = task_job[t + 1] == task_job[t]
        singles = not queues and sizes[task_job[t]] == 1 and sizes[task_job[t + 1]] == 1
        if ((same_job or singles) and task_sig[t + 1] == task_sig[t]
                and task_static[t + 1] == task_static[t]):
            run_len[t] = run_len[t + 1] + 1
    j_pad = -(-(n_jobs + MAX_BATCH) // 128) * 128
    deficit = np.array([rng.integers(1, k + 1) for k in sizes])
    js_drf0 = np.zeros((8, j_pad), f32)
    js_drf0[:r_dim, :n_jobs] = rng.choice([0.0, 1.0, 2.0], (r_dim, n_jobs))
    total = alloc[:r_dim].sum(axis=1)
    drf_safe = np.ones((8, 1), f32)
    drf_safe[:r_dim, 0] = np.where(total > 0, total, 1.0)
    drf_mask = np.zeros((8, 1), f32)
    drf_mask[:r_dim, 0] = total > 0
    job_tb = np.full((1, j_pad), 2**31 - 1, np.int32)
    job_tb[0, :n_jobs] = rng.permutation(n_jobs)
    misc = np.zeros((1, 8), np.int32)
    misc[0, 0] = n_jobs

    rows_pad = 8
    smask = np.zeros((rows_pad, nb), f32)
    sscore = np.zeros((rows_pad, nb), f32)
    if use_static:
        smask[:n_static] = rng.random((n_static, nb)) < 0.85
        sscore[:n_static] = rng.integers(0, 10, (n_static, nb))
    zeros8 = np.zeros((8, 128), f32)
    jqueue, jq_des, jq_alloc0 = np.zeros((1, 128), np.int32), zeros8, zeros8
    if queues:
        names = [q for q in range(queues) if q != 1] if queues > 2 else list(range(queues))
        jq = rng.choice(names, n_jobs).astype(np.int32)
        des = (total[None, :] * rng.choice([1 / 64, 1 / 8, 1 / 2], (queues, 1))).astype(f32)
        if starved:
            des[0] = total / 4096
        held = (des * rng.choice([0.0, 0.25, 0.5], (queues, 1))).astype(f32)
        if tied:
            des[2], held[2] = des[1], held[1]
        jqueue = pack_lane_i32(jq, j_pad)
        jq_des = np.zeros((8, j_pad), f32)
        jq_des[:r_dim, :n_jobs] = des[jq].T
        jq_alloc0 = np.zeros((8, j_pad), f32)
        jq_alloc0[:r_dim, :n_jobs] = held[jq].T
    ops = {
        "ns0": ns0, "alloc_t": alloc, "rel0": rel0, "gate": gate,
        "plim": plim, "sig_req": sig_req,
        "task_sig": pack_task_table_i32(np.array(task_sig, np.int32), n_tasks),
        "run_len": pack_task_table_i32(np.array(run_len, np.int32), n_tasks, fill=1),
        "job_off": pack_lane_i32(np.array(offsets, np.int32), j_pad),
        "job_num": pack_lane_i32(sizes.astype(np.int32), j_pad),
        "job_deficit": pack_lane_i32(deficit.astype(np.int32), j_pad),
        "job_gang": pack_lane_i32(deficit.astype(np.int32), j_pad),
        "job_prio": pack_lane_i32(rng.integers(0, 3, n_jobs).astype(np.int32), j_pad),
        "job_tb": job_tb, "js_drf0": js_drf0, "drf_safe": drf_safe, "drf_mask": drf_mask,
        "msig": pack_task_table_i32(np.array(task_static if use_static else [], np.int32),
                                    n_tasks),
        "smask": smask, "sscore": sscore,
        "jqueue": jqueue, "jq_des": jq_des, "jq_alloc0": jq_alloc0,
        "qf_share": zeros8, "qf_over": zeros8, "misc": misc,
    }
    kw = dict(
        r_dim=r_dim, weights=tuple(float(w) for w in weights),
        enforce_pod_count=enforce_pod_count, comparators=tuple(comparators),
        cross_batch=not queues, batch_runs=True, has_releasing=releasing, use_static=use_static,
        score_bound=score_bound, mins=tuple([0.01] * r_dim), cpu_idx=0, mem_idx=1,
        multi_queue=bool(queues), queue_proportion=bool(queues), overused_gate=bool(queues),
        queue_delta=True,
        qfair_ladder=False, cohort=cohort, t_cap=n_tasks, mesh=None,
    )
    return ops, kw


# Synthetic K2 cases at the widths the launch plan distinguishes:
# case id -> mega_operands arguments.  The cluster's CTAs hold equal shares
# of the gated prefix, so nodes far apart in index lie in different CTAs.
MEGA_SYNTHETIC = {
    "nb1024-r8": dict(seed=1, nb=1024, r_dim=8, n_jobs=300, n_nodes=1000,
                      weights=(1.0, 1.0, 1.0), score_bound=True, enforce_pod_count=True,
                      cohort=4),
    "nb16384-r8": dict(seed=2, nb=16384, r_dim=8, n_jobs=400, n_nodes=10000,
                       weights=(0.0, 0.0, 1.0), cohort=4),
    "nb32768-r8": dict(seed=3, nb=32768, r_dim=8, n_jobs=1000, n_nodes=30000,
                       weights=(1.0, 1.0, 1.0), score_bound=True, use_static=True),
    "ties-across-ctas": dict(seed=4, nb=16384, r_dim=2, n_jobs=200, alike=True,
                             gated=(15000, 9000, 3800, 1800), weights=(0.0, 0.0, 1.0)),
    "second-best-other-cta": dict(seed=5, nb=16384, r_dim=2, n_jobs=200, alike=True,
                                  gated=(100, 12000), weights=(0.0, 1.0, 0.0),
                                  score_bound=True, cohort=4),
    "infeasible-chunk": dict(seed=6, nb=4096, r_dim=3, n_jobs=200, infeasible_job=True,
                             weights=(1.0, 0.0, 1.0), score_bound=True, cohort=4),
    "job-ledger-on-chip-8320": dict(seed=7, nb=1024, r_dim=2, n_jobs=8100, max_tasks=1,
                                    weights=(0.0, 1.0, 1.0), score_bound=True,
                                    enforce_pod_count=True, use_static=True, cohort=4),
}


# Synthetic K2 cases in multi-queue mode (``mega_operands(queues=...)``):
# two to eight queues, one of them empty where there are three or more, a
# queue starved by its overused gate, equal shares across queues (the lower
# queue index wins), both instantiations, nb 1,024 and 16,384, and config
# 2's j_pad of 8,320 with the queue ledger beside the job ledger on chip.
MEGA_SYNTHETIC_MQ = {
    "mq2-nb1024-all-terms-pods": dict(seed=21, nb=1024, r_dim=2, n_jobs=300, n_nodes=1000,
                                      queues=2, weights=(1.0, 1.0, 1.0), score_bound=True,
                                      enforce_pod_count=True, cohort=4),
    "mq3-starved-nb16384": dict(seed=22, nb=16384, r_dim=3, n_jobs=400, n_nodes=10000,
                                queues=3, starved=True, cohort=4),
    "mq8-tied-static-nb16384": dict(seed=23, nb=16384, r_dim=2, n_jobs=400, n_nodes=10000,
                                    queues=8, tied=True, weights=(0.0, 1.0, 1.0),
                                    score_bound=True, use_static=True),
    "mq5-static-8320": dict(seed=24, nb=1024, r_dim=2, n_jobs=8100, max_tasks=1, queues=5,
                            weights=(0.0, 1.0, 1.0), score_bound=True,
                            enforce_pod_count=True, use_static=True, cohort=4),
}


# Synthetic K2 cases with releasing capacity (``mega_operands(releasing=
# True)``), the kernel's four REL instantiations at r_dim 8 and nb 1,024,
# 16,384 and 32,768 (there the node slice with its releasing rows takes the
# 16-CTA plan); an idle-fit node and a releasing-only node on equal scores
# in different CTAs, either of them first (the lowest index wins, and the
# winner's idle fit decides alloc or pipe); releasing-only nodes that
# binpack scores best; and eight nodes filled to their pod limits (a
# pipelined copy counts against it).
REL_MODES = {"cursor": {}, "static": dict(use_static=True),
             "mq": dict(queues=3, starved=True), "mq-static": dict(queues=2, use_static=True)}
REL_SIZES = {1024: (1000, 150), 16384: (10000, 200), 32768: (30000, 300)}
MEGA_SYNTHETIC_REL = {
    f"rel-{mode}-nb{nb}-r8": dict(
        seed=41 + 4 * i + j, nb=nb, r_dim=8, n_jobs=jobs, n_nodes=nodes, releasing=True,
        **(dict(weights=(1.0, 1.0, 1.0), score_bound=True, enforce_pod_count=True, cohort=4)
           if (i + j) % 2 == 0 else dict(weights=(0.0, 0.0, 1.0))),
        **extra)
    for j, (mode, extra) in enumerate(REL_MODES.items())
    for i, (nb, (nodes, jobs)) in enumerate(REL_SIZES.items())
}
MEGA_SYNTHETIC_REL.update({
    "rel-tie-releasing-first": dict(seed=61, nb=16384, r_dim=2, n_jobs=200, alike=True,
                                    gated=(12000, 3000), rel_only=(3000,), releasing=True,
                                    weights=(0.0, 0.0, 0.0), cohort=4),
    "rel-tie-idle-first": dict(seed=62, nb=16384, r_dim=2, n_jobs=200, alike=True,
                               gated=(12000, 3000), rel_only=(12000,), releasing=True,
                               weights=(0.0, 0.0, 0.0)),
    "rel-best-releasing-only": dict(seed=63, nb=16384, r_dim=3, n_jobs=300, n_nodes=10000,
                                    rel_only=(70, 5000, 9999), releasing=True),
    "rel-pods-gate": dict(seed=64, nb=1024, r_dim=2, n_jobs=300, n_nodes=8, releasing=True,
                          enforce_pod_count=True, weights=(0.0, 1.0, 0.0), score_bound=True),
})


def ladder_operands(seed, nb, r_dim, n_jobs, queues, **flags):
    """``mega_allocate`` operands in multi-queue mode with the qfair ladder:
    ``mega_operands(queues=...)`` with single-task jobs, every job of queue q
    asking request signature 1 + q (one class a queue), no run batching, and
    the rung tables that ``ops/qfair.build_ladder`` makes from each queue's
    deserved and allocated rows, class request and job count (queues on the
    128 columns, rungs on the rows, padded to 8)."""
    import numpy as np

    from scheduler_tpu_torch.ops.megakernel import pack_task_table_i32
    from scheduler_tpu_torch.ops.qfair import build_ladder

    ops, kw = mega_operands(seed, nb, r_dim, n_jobs, queues=queues, max_tasks=1, **flags)
    jq = ops["jqueue"][0, :n_jobs].astype(np.int64)
    ops["task_sig"] = pack_task_table_i32((1 + jq).astype(np.int32), n_jobs)
    ops["run_len"] = pack_task_table_i32(np.ones(n_jobs, np.int32), n_jobs, fill=1)
    des = np.zeros((queues, r_dim), np.float32)
    held = np.zeros((queues, r_dim), np.float32)
    lanes = np.unique(jq, return_index=True)
    des[lanes[0]] = ops["jq_des"][:r_dim, lanes[1]].T
    held[lanes[0]] = ops["jq_alloc0"][:r_dim, lanes[1]].T
    req_rows = ops["sig_req"][:r_dim, 1:1 + queues].T.copy()
    counts = np.bincount(jq, minlength=queues)
    share, over = build_ladder(des, held, req_rows, counts,
                               np.asarray(kw["mins"], np.float32), r_dim)
    k_pad = -(-share.shape[1] // 8) * 8
    ops["qf_share"] = np.zeros((k_pad, 128), np.float32)
    ops["qf_share"][: share.shape[1], :queues] = share.T
    ops["qf_over"] = np.zeros((k_pad, 128), np.float32)
    ops["qf_over"][: share.shape[1], :queues] = over.T
    kw.update(batch_runs=False, cross_batch=False, cohort=1, qfair_ladder=True)
    return ops, kw


# Synthetic K2 cases with the qfair ladder (``ladder_operands``): both
# instantiations, a queue starved by its overused gate, equal shares, one
# queue empty, and queues of 900 job lanes (more than a CTA's 512 threads,
# so each rescan of a queue takes two strided passes).
MEGA_SYNTHETIC_LADDER = {
    "ladder-q3-starved-nb1024": dict(seed=31, nb=1024, r_dim=3, n_jobs=600, n_nodes=1000,
                                     queues=3, starved=True, weights=(0.0, 0.0, 1.0)),
    "ladder-q3-deep-nb1024": dict(seed=33, nb=1024, r_dim=4, n_jobs=1800, n_nodes=1000,
                                  queues=3, starved=True, weights=(1.0, 0.0, 1.0)),
    "ladder-q8-tied-static-nb16384": dict(seed=32, nb=16384, r_dim=2, n_jobs=2000,
                                          n_nodes=10000, queues=8, tied=True,
                                          weights=(0.0, 1.0, 1.0), use_static=True,
                                          enforce_pod_count=True),
}


def many_jobs_cluster():
    """12,000 single-task jobs on 64 nodes: the compact job ledger
    (j_pad 12,160, r_dim 2: 243,200 bytes) outgrows a CTA's shared memory
    and lives in global scratch, one copy a CTA; the cluster is too small
    for them all, so some jobs fail."""
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    return make_synthetic_cluster(64, 12_000, tasks_per_job=1).cache


def mid_evict_cluster(pkg: str = "scheduler_tpu_torch"):
    """``tests/test_megakernel.py``'s session with releasing capacity (the
    JAX engine takes its mega kernel on it) as a cache of package ``pkg``:
    one queue, 6 nodes of 4 cpu and 8 GiB, each running a 3-cpu pod, four
    pending 2.5-cpu pods; the running pods on n0, n1 and n2 are evicted
    (their capacity is releasing), so the pending pods pipeline onto it."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache_mod = importlib.import_module(f"{pkg}.cache.cache")
    ts0 = 1_700_000_000.0
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    queue = objects.Queue(name="default", weight=1)
    queue.creation_timestamp = ts0
    cache.add_queue(queue)
    for i in range(6):
        cache.add_node(objects.NodeSpec(name=f"n{i}", allocatable={
            "cpu": 4000.0, "memory": 8 * GIB, "pods": 110}))
    for k, (name, cpu, mem, node) in enumerate(
            [(f"run{j}", 3000.0, 6 * GIB, f"n{j}") for j in range(6)]
            + [(f"want{j}", 2500.0, 5 * GIB, "") for j in range(4)]):
        pg = objects.PodGroup(name=name, namespace="default", queue="default", min_member=1)
        pg.status.phase = "Running" if node else "Inqueue"
        pg.creation_timestamp = ts0 + (2 * k + 1) * 1e-6
        cache.add_pod_group(pg)
        pod = objects.PodSpec(name=f"{name}-0", namespace="default",
                              containers=[{"cpu": cpu, "memory": mem}],
                              annotations={objects.GROUP_NAME_ANNOTATION: name}, node_name=node,
                              phase="Running" if node else "Pending")
        pod.creation_timestamp = ts0 + (2 * k + 2) * 1e-6
        cache.add_pod(pod)
    for j in range(3):
        for task in list(cache.jobs[f"default/run{j}"].tasks.values()):
            cache.evict(task, "reclaim")
    return cache


def static_spec():
    """tests/test_megakernel.py ``_static_cluster``: 6 zoned nodes, four
    2-of-4 gangs of distinct requests, one gang selecting a zone."""
    nodes = [(f"n{i}", {"cpu": 8000.0, "memory": 16 * GIB, "pods": 20},
              {"labels": {"zone": "za" if i % 2 else "zb"}}) for i in range(6)]
    groups, pods = [], []
    for g in range(4):
        groups.append((f"g{g}", 2))
        for i in range(4):
            extra = {"node_selector": {"zone": "za"}} if g == 1 else {}
            pods.append((f"g{g}-{i}", f"g{g}",
                         {"cpu": float(200 + 40 * g + 10 * i), "memory": GIB}, g % 2, extra))
    return {"nodes": nodes, "groups": groups, "pods": pods}


def lp_spec(n_nodes=8, node_cpu=4000, n_gangs=4, gang_size=5, req_cpu=900,
            queues=("default",), unique_reqs=False, selectors=False, pods_cap=20):
    """``tests/test_lp_place.py`` / ``tests/test_sig_compress.py``
    ``_cluster``: ``n_nodes`` nodes of ``node_cpu`` millicores and 64 GiB,
    ``n_gangs`` gangs of ``gang_size`` pods (minMember the gang size,
    priority alternating 0 / 1) dealt round-robin to ``queues`` (weight the
    length of the name).  ``unique_reqs`` gives every pod its own cpu
    request; ``selectors`` labels the nodes with zones and pins odd gangs to
    ``za``, even ones to ``zb``."""
    nodes = [(f"n{i:02d}", {"cpu": float(node_cpu), "memory": 64 * GIB, "pods": pods_cap},
              {"labels": {"zone": "za" if i % 2 else "zb"}} if selectors else {})
             for i in range(n_nodes)]
    groups, pods, flat = [], [], 0
    for g in range(n_gangs):
        groups.append((f"g{g}", gang_size, queues[g % len(queues)]))
        for i in range(gang_size):
            cpu = req_cpu + 10 * flat if unique_reqs else req_cpu
            extra = {"node_selector": {"zone": "za" if g % 2 else "zb"}} if selectors else {}
            pods.append((f"g{g}-{i}", f"g{g}", {"cpu": float(cpu), "memory": GIB}, g % 2, extra))
            flat += 1
    return {"queues": [(q, len(q)) for q in queues], "nodes": nodes, "groups": groups,
            "pods": pods}


def selector_bound_spec():
    """tests/test_megakernel.py:215-244: identical-request gangs, each
    selecting one of four zones, under nodeorder scoring: runs batch and the
    top-2 score bound cuts them."""
    nodes = [(f"n{i}", {"cpu": 64000.0, "memory": 128 * GIB, "pods": 110},
              {"labels": {"zone": f"z{i % 4}"}}) for i in range(8)]
    groups, pods = [], []
    for g in range(8):
        groups.append((f"g{g}", 4))
        pods += [(f"g{g}-{i}", f"g{g}", {"cpu": 2000.0, "memory": 4 * GIB}, 0,
                  {"node_selector": {"zone": f"z{g % 4}"}}) for i in range(8)]
    return {"nodes": nodes, "groups": groups, "pods": pods}


def multi_queue_spec(weights=(1, 3, 2), n_nodes=8):
    """tests/test_megakernel.py ``_multi_queue_cluster``: queues q0, q1, ...
    of the given weights on ``n_nodes`` nodes of 4 cpu and 8 GiB, and nine
    gangs of four pods (minMember 2, mixed cpu requests) dealt round-robin
    to the queues.  With weights (1, 9) on 3 nodes, queue q0's share
    crosses its deserved partway: its overused gate denies it the rest."""
    rnd = random.Random(7)
    queues = [(f"q{i}", w) for i, w in enumerate(weights)]
    nodes = [(f"n{i}", {"cpu": 4000.0, "memory": 8 * GIB, "pods": 30}) for i in range(n_nodes)]
    groups, pods = [], []
    for g in range(9):
        groups.append((f"g{g}", 2, queues[g % len(queues)][0]))
        pods += [(f"g{g}-{i}", f"g{g}", {"cpu": float(rnd.choice([500, 1000, 1500])),
                                          "memory": GIB}, g % 3) for i in range(4)]
    return {"queues": queues, "nodes": nodes, "groups": groups, "pods": pods}


def _node_extra(i: int) -> dict:
    """Zone and disk labels, and on the first nodes every static predicate:
    NoSchedule / NoExecute / PreferNoSchedule taints, an unschedulable node,
    a not-ready node and a memory-pressured node."""
    extra = {"labels": {"zone": f"z{i % 4}", "disk": "ssd" if i % 3 == 0 else "hdd"}}
    if i in (0, 6):
        extra["taints"] = [("dedicated", "gpu", "NoSchedule")]
    if i in (1, 6):
        extra.setdefault("taints", []).append(("maint", "", "NoExecute"))
    if i == 2:
        extra["taints"] = [("soft", "x", "PreferNoSchedule")]
    if i == 3:
        extra["unschedulable"] = True
    if i == 4:
        extra["conditions"] = {"Ready": "False"}
    if i == 5:
        extra["conditions"] = {"MemoryPressure": "True"}
    return extra


# Pod-side constraints of the predicates clusters: zone selectors, matching,
# blanket and non-matching tolerations, a selector pair no node has, and
# required and preferred node affinity.
POD_EXTRAS = [
    {"node_selector": {"zone": "z0"}},
    {"tolerations": [("dedicated", "Equal", "gpu", "NoSchedule")]},
    {"tolerations": [("", "Exists", "", "")]},
    {"node_selector": {"zone": "nowhere"}},
    {"affinity": {"node_required": [[("disk", "In", ["ssd"])]]}},
    {"affinity": {"node_preferred": [(5, [("zone", "In", ["z1"])]),
                                     (2, [("disk", "In", ["ssd"])])]}},
    {"node_selector": {"zone": "z1"},
     "tolerations": [("maint", "Exists", "", "NoExecute")]},
    {"tolerations": [("dedicated", "Equal", "cpu", "NoSchedule")]},
    {},
    {"affinity": {"node_required": [[("zone", "In", ["z2", "z3"])],
                                    [("disk", "In", ["ssd"])]],
                  "node_preferred": [(3, [("zone", "In", ["z3"])])]}},
]


def predicates_spec():
    """Every static predicate and scorer at once on 16 small nodes
    (``_node_extra``, ``POD_EXTRAS``), ten 2-of-4 gangs (one of 8)."""
    nodes = [(f"n{i:02d}", {"cpu": 4000.0, "memory": 8 * GIB, "pods": 6}, _node_extra(i))
             for i in range(16)]
    groups, pods = [], []
    for g, extra in enumerate(POD_EXTRAS):
        size = 8 if g == 8 else 4
        groups.append((f"g{g}", 2))
        pods += [(f"g{g}-{i}", f"g{g}", {"cpu": float(500 + 250 * (i % 3)), "memory": GIB},
                  g % 3, extra) for i in range(size)]
    return {"nodes": nodes, "groups": groups, "pods": pods}


def config2_predicates_spec(n_nodes: int = 64, n_pods: int = 600, seed: int = 0):
    """Config 2's shape (hollow nodes of 16 cpu / 64 GiB / 110 pods, bare
    sleep pods of cpu {100, 200, 500}m and memory {1, 2} GiB, every even pod
    selecting its zone) with the predicates cluster's node constraints on
    the first nodes and its pod constraints on every fifth pod."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nodes = [(f"hollow-{i:05d}", {"cpu": 16000.0, "memory": 64 * GIB, "pods": 110},
              _node_extra(i)) for i in range(n_nodes)]
    pods = []
    for t in range(n_pods):
        req = {"cpu": float(rng.choice([100, 200, 500])),
               "memory": float(rng.choice([1, 2])) * GIB}
        extra = dict(POD_EXTRAS[(t // 5) % len(POD_EXTRAS)]) if t % 5 == 0 else {}
        if t % 2 == 0 and "node_selector" not in extra:
            extra["node_selector"] = {"zone": f"z{t % 4}"}
        pods.append((f"sleep-{t:05d}", None, req, 0, extra))
    return {"nodes": nodes, "groups": [], "pods": pods}


def _objects_of(objects, kind: str, value):
    """A spec's plain description of taints, tolerations or affinity as the
    package's own objects."""
    if kind == "taints":
        return [objects.Taint(key=k, value=v, effect=e) for k, v, e in value]
    if kind == "tolerations":
        return [objects.Toleration(key=k, operator=op, value=v, effect=e)
                for k, op, v, e in value]

    def reqs(terms):
        return [objects.NodeSelectorRequirement(key=k, operator=op, values=list(vals))
                for k, op, vals in terms]

    def pod_terms(terms):
        return [objects.PodAffinityTerm(label_selector=dict(sel), topology_key=topo)
                for sel, topo in terms]

    return objects.Affinity(
        node_required=[reqs(group) for group in value.get("node_required", ())],
        node_preferred=[(w, reqs(terms)) for w, terms in value.get("node_preferred", ())],
        pod_affinity=pod_terms(value.get("pod_affinity", ())),
        pod_anti_affinity=pod_terms(value.get("pod_anti_affinity", ())),
    )


def storm_spec(seed: int, n_queues: int = 1) -> dict:
    """``tests/test_evict_parity.py::storm_cluster``'s recipe as a spec
    (``spec_cluster``), drawing the same numbers from ``seed``: queues q0,
    q1, ... of weights 1, 2, ...; 4-7 nodes of 4 cpu / 8 GiB; 3-6 RUNNING
    filler gangs of 2-4 pods (500 or 1000 millicpu, 256 MiB, priority 0)
    with mixed ``min_member`` floors (1 / half / full), mostly in queue q0,
    placed under the nodes' capacity; and per queue one ``storm`` gang of
    1-3 pending pods (1 or 2 cpu, 128 MiB, priority 5-10).  Preempt and
    reclaim both find work there."""
    import numpy as np

    rng = np.random.default_rng(seed)
    queues = [f"q{i}" for i in range(n_queues)]
    n_nodes = int(rng.integers(4, 8))
    names = [f"n{i:02d}" for i in range(n_nodes)]
    nodes = [(name, {"cpu": 4000.0, "memory": 8 * GIB, "pods": 110}) for name in names]
    room = {name: 4000.0 for name in names}
    groups, pods = [], []
    for g in range(int(rng.integers(3, 7))):
        size = int(rng.integers(2, 5))
        mm = int(rng.choice([1, max(1, size // 2), size]))
        queue = queues[0] if n_queues > 1 and g % 3 else queues[g % n_queues]
        groups.append((f"fill{g}", mm, queue, "Running"))
        for t in range(size):
            cpu = float(rng.choice([500, 1000]))
            target = names[int(rng.integers(0, len(names)))]
            if room[target] < cpu:
                continue
            room[target] -= cpu
            pods.append((f"fill{g}-{t}", f"fill{g}", {"cpu": cpu, "memory": 256 * 1024.0**2}, 0,
                         {"node_name": target, "phase": "Running"}))
    for queue in queues:
        lane = f"storm-{queue}"
        groups.append((lane, 1, queue))
        for p in range(int(rng.integers(1, 4))):
            pods.append((f"{lane}-{p}", lane,
                         {"cpu": float(rng.choice([1000, 2000])), "memory": 128 * 1024.0**2},
                         int(rng.integers(5, 11))))
    return {"queues": [(q, i + 1) for i, q in enumerate(queues)], "nodes": nodes,
            "groups": groups, "pods": pods}


def spec_cluster(spec: dict, pkg: str = "scheduler_tpu_torch"):
    """The cluster ``spec`` as a cache of package ``pkg`` (the port; the CPU
    tests build the same spec in the JAX package too, so objects and
    timestamps are identical in both).  A node is ``(name,
    allocatable[, extra])`` with extra keys ``labels``, ``taints`` ([(key,
    value, effect)]), ``unschedulable`` and ``conditions``; a group is
    ``(name, min_member[, queue[, phase]])`` (phase default ``Inqueue``);
    ``queues`` (optional, default ``[("default", 1)]``) lists ``(name,
    weight)`` in creation order; a pod is ``(name, group, request, priority[,
    extra])``, group None for a bare pod (a shadow PodGroup, stamped with the
    pod's creation time), with extra keys ``node_selector``, ``tolerations``
    ([(key, operator, value, effect)]), ``affinity`` (see ``_objects_of``),
    ``host_ports``, ``labels``, and ``node_name`` and ``phase`` for a pod
    that already runs (phase default ``Pending``)."""
    from scheduler_tpu_torch.harness.synthetic import pin_shadow_timestamps

    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache_mod = importlib.import_module(f"{pkg}.cache.cache")
    ts0 = 1_700_000_000.0
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    for k, (qname, weight) in enumerate(spec.get("queues", [("default", 1)])):
        queue = objects.Queue(name=qname, weight=weight)
        queue.creation_timestamp = ts0 + k * 1e-6
        cache.add_queue(queue)
    for name, alloc, *rest in spec["nodes"]:
        extra = rest[0] if rest else {}
        cache.add_node(objects.NodeSpec(
            name=name, allocatable=dict(alloc), labels=dict(extra.get("labels", {})),
            taints=_objects_of(objects, "taints", extra.get("taints", ())),
            unschedulable=extra.get("unschedulable", False),
            conditions=dict(extra.get("conditions", {})),
        ))
    for k, (name, min_member, *rest) in enumerate(spec["groups"]):
        pg = objects.PodGroup(name=name, namespace="default",
                              queue=rest[0] if rest else "default", min_member=min_member)
        pg.status.phase = rest[1] if len(rest) > 1 else "Inqueue"
        pg.creation_timestamp = ts0 + (k + 1) * 1e-6
        cache.add_pod_group(pg)
    for k, (name, group, req, prio, *rest) in enumerate(spec["pods"]):
        extra = rest[0] if rest else {}
        pod = objects.PodSpec(
            name=name, namespace="default", containers=[dict(req)],
            phase=extra.get("phase", "Pending"), node_name=extra.get("node_name", ""),
            priority=prio,
            annotations={objects.GROUP_NAME_ANNOTATION: group} if group else {},
            scheduler_name="" if group else "volcano",
            node_selector=dict(extra.get("node_selector", {})),
            tolerations=_objects_of(objects, "tolerations", extra.get("tolerations", ())),
            host_ports=list(extra.get("host_ports", ())),
            labels=dict(extra.get("labels", {})),
        )
        if "affinity" in extra:
            pod.affinity = _objects_of(objects, "affinity", extra["affinity"])
        pod.creation_timestamp = ts0 + 1.0 + k * 1e-6
        cache.add_pod(pod)
    pin_shadow_timestamps(cache)
    return cache


def engine_for(cache, conf_text, device, engine="mega"):
    """Open a session on ``cache`` and build the fused engine over its
    allocate candidates (the session is left open: nothing is committed);
    the engine's gates must choose ``engine`` ("mega", "step" or "xla")."""
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import open_session
    from scheduler_tpu_torch.ops.fused import FusedAllocator

    ssn = open_session(cache, parse_scheduler_conf(conf_text).tiers, device=device)
    eng = FusedAllocator(ssn, collect_candidates(ssn), device=device)
    if eng.engine != engine:
        raise RuntimeError(f"the fused engine chose {eng.engine}, not {engine}")
    return ssn, eng


# -- mega_allocate against its plain version ----------------------------------------

def read_inputs(args, kw):
    """The operands the kernel reads in its mode (the others are dummies)."""
    from scheduler_tpu_torch.ops.megakernel import OPERAND_NAMES

    unread = set() if kw.get("has_releasing") else {"rel0"}
    if not kw.get("qfair_ladder"):
        unread |= {"qf_share", "qf_over"}
    if not kw["multi_queue"]:
        unread |= {"jqueue", "jq_des", "jq_alloc0"}
    if not kw["use_static"]:
        unread |= {"msig", "smask", "sscore"}
    return [a for name, a in zip(OPERAND_NAMES, args) if name not in unread]


def node_step_ops(kw) -> int:
    """Float32 operations per node per placement step of the kernel's node
    loop, counted from its source: the epsilon fit (6 a dimension; with
    releasing capacity once more on the releasing rows, and the or of the
    two), the pod-count gate, the static mask and score, the score terms
    and the masked argmax."""
    ops = 6 * kw["r_dim"] + 1 + 3
    if kw.get("has_releasing"):
        ops += 6 * kw["r_dim"] + 1
    if kw["enforce_pod_count"]:
        ops += 1
    if kw["use_static"]:
        ops += 2
    lr_w, bal_w, bp_w = kw["weights"]
    if lr_w or bal_w or bp_w:
        ops += 6  # safe divisors and the post-placement request per dimension
    ops += 13 * bool(lr_w) + 12 * bool(bal_w) + 11 * bool(bp_w)
    return ops


def queue_chain_ops(args, kw, codes, stats, n_queues=0) -> int:
    """Operations of multi-queue mode's queue chain in this run.  At each
    pop, over the real job lanes of the queue whose job was placed since
    the last pop (all lanes before the first): the eligibility test (3
    compares, 2 ands) and the job chain (2 a priority or gang key, 2 per dim
    for drf, the rank: 2); then over the queues, the pop (the overused flag
    and share, their compares, the index: 6).  Per placement: the delta
    chain's refresh of the queue (r_dim adds; a dim's division, selects,
    maximum, difference and compare: 7 each), or the ladder's count add and
    two reads (3); at each pop of the full-recompute chain, every queue's
    derive (7 a dim).  Pops are counted from below, as the jobs that
    consumed a task (each took at least one pop)."""
    import torch

    from scheduler_tpu_torch.ops.layout import STATS
    from scheduler_tpu_torch.ops.megakernel import OPERAND_NAMES

    ops = dict(zip(OPERAND_NAMES, args))
    n_jobs = int(ops["misc"][0, 0])
    num = ops["job_num"][0, :n_jobs].long()
    queue = ops["jqueue"][0, :n_jobs].long()
    job_of_task = torch.repeat_interleave(torch.arange(n_jobs, device=num.device), num)
    touched = codes[: job_of_task.numel()] != -1
    popped = torch.unique(job_of_task[touched])
    lanes_of = torch.bincount(queue, minlength=max(1, n_queues))
    rescanned = int(lanes_of[queue[popped]].sum()) + n_jobs
    r = kw["r_dim"]
    lane_ops = 5 + sum(2 * r if name == "drf" else 2 for name in kw["comparators"]) + 2
    return (rescanned * lane_ops + popped.numel() * max(1, n_queues) * 6
            + int(stats[STATS.QDELTA_UPDATES]) * 8 * r + int(stats[STATS.QFAIR_LOOKUPS]) * 3
            + bool(int(stats[STATS.QFULL_RECOMPUTES])) * popped.numel() * n_queues * 7 * r)


def mega_bound_ms(args, kw, codes, stats, n_real: int, n_queues: int = 0):
    """The least time the card could take for this run: each input read
    once and each output written once at the memory rate, against the node
    loop's float32 operations (steps x real nodes x ops), with releasing
    capacity each pipelined copy's update of its node's releasing rows and
    task count (r_dim + 1), and in multi-queue mode the queue chain's
    (``queue_chain_ops``), at the peak rate."""
    from scheduler_tpu_torch.ops.layout import STATS

    nbytes = sum(a.numel() * a.element_size() for a in read_inputs(args, kw))
    nbytes += codes.numel() * codes.element_size() + stats.numel() * stats.element_size()
    ops = int(stats[STATS.STEPS]) * n_real * node_step_ops(kw)
    if kw.get("has_releasing"):
        ops += int((codes <= -3).sum()) * (kw["r_dim"] + 1)
    if kw["multi_queue"]:
        ops += queue_chain_ops(args, kw, codes, stats, n_queues)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def mega_mode(kw) -> str:
    """The kernel instantiation a call runs (``_releasing`` with releasing
    capacity), and in multi-queue mode the queue chain where it is not the
    delta chain (``_ladder``, ``_full``)."""
    rel = "_releasing" if kw.get("has_releasing") else ""
    if kw["multi_queue"]:
        mode = ("multi_queue_static" if kw["use_static"] else "multi_queue") + rel
        if kw.get("qfair_ladder"):
            return mode + "_ladder"
        return mode if kw.get("queue_delta", True) else mode + "_full"
    return ("static" if kw["use_static"] else "cursor") + rel


def events():
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def compare(case, args, kw, n_real, n_queues=0, timed=False, repeats=3, plain=True,
            mesh=None):
    """mega_allocate and its plain version on the same CUDA operands: codes
    and stats must be bitwise equal; the record carries the kernel's launch
    plan.  ``n_queues``: the queue count, as the engine passes it (multi-queue
    mode).  With ``timed`` the kernel's device time a launch comes from a
    profiler trace (``device_ms``, also ``ms``) beside CUDA events around
    ``repeats`` launches (``event_ms``), with ``us_per_step`` = ms /
    STATS.STEPS.  The plain version is timed with events (``plain_ms``),
    and the record carries the run's bound (``mega_bound_ms``).  Without
    ``plain`` the plain version does not run here (the ``full_size_plain``
    child holds the kernel to it on twin operands): the record has no
    ``equal``, ``max_abs_err`` or ``plain_ms``.  With ``mesh`` (and
    ``plain``) the kernel also runs in mesh mode on the same operands, held
    to the same plain run (``rec["mesh"]``)."""
    import torch

    from scheduler_tpu_torch.ops import megakernel as mk

    codes_k, stats_k = mk.mega_allocate(*args, n_queues=n_queues, **kw)
    torch.cuda.synchronize()
    start, stop = events()
    rec = {
        "phase": "kernel_vs_plain", "kernel": "mega_allocate", "case": case,
        "mode": mega_mode(kw),
        "placed": int((codes_k >= 0).sum()), "pipelined": int((codes_k <= -3).sum()),
        "stats": stats_k.tolist(),
        "nb": int(args[0].shape[1]), "t_pad": int(codes_k.numel()),
        "static_rows": int(args[18].shape[0]) if kw["use_static"] else 0,
        "cohort": kw["cohort"], "score_bound": kw["score_bound"],
        "enforce_pod_count": kw["enforce_pod_count"],
        "plan": mk.plan_for(args, kw, n_queues).summary(),
    }
    if plain:
        start.record()
        codes_r, stats_r = mk.mega_allocate_reference(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        rec["equal"] = bool(torch.equal(codes_k, codes_r) and torch.equal(stats_k, stats_r))
        rec["max_abs_err"] = (int((codes_k.long() - codes_r.long()).abs().max())
                              if codes_k.numel() else 0)
        rec["plain_ms"] = start.elapsed_time(stop)
        rec["plain_stats"] = stats_r.tolist()
        if mesh is not None:
            codes_m, stats_m = mk.mega_allocate(*args, n_queues=n_queues,
                                                **dict(kw, mesh=mesh))
            torch.cuda.synchronize()
            rec["mesh"] = {
                "shards": mesh.size,
                "equal": bool(torch.equal(codes_m, codes_r) and torch.equal(stats_m, stats_r)),
                "max_abs_err": (int((codes_m.long() - codes_r.long()).abs().max())
                                if codes_m.numel() else 0)}
            if not rec["mesh"]["equal"]:
                emit(rec)
                raise SystemExit(f"mega_allocate's mesh mode and the plain version disagree: "
                                 f"{case}")
    rec["bound_ms"], rec["bound_by"] = mega_bound_ms(args, kw, codes_k, stats_k, n_real, n_queues)
    if timed:
        start.record()
        for _ in range(repeats):
            mk.mega_allocate(*args, n_queues=n_queues, **kw)
        stop.record()
        torch.cuda.synchronize()
        rec["event_ms"] = start.elapsed_time(stop) / repeats
        rec["device_ms"], _ = device_ms_per_call(
            lambda: mk.mega_allocate(*args, n_queues=n_queues, **kw), repeats,
            match="mega_allocate_kernel")
        rec["ms"] = rec["device_ms"] if rec["device_ms"] is not None else rec["event_ms"]
        rec["us_per_step"] = 1e3 * rec["ms"] / max(1, int(stats_k[0]))
    emit(rec)
    if plain and not rec["equal"]:
        raise SystemExit(f"kernel and plain version disagree: {case}")
    return rec


def compare_chains(case, args, kw, n_real, n_queues, repeats=3):
    """K2 in qfair-ladder mode against the same launch on the delta chain
    (``qfair_ladder=False``) on one session's staged operands: equal codes
    and steps, the ladder's lookups and the delta chain's refreshes each
    equal to the placements.  Each chain is timed: CUDA events around one
    launch, ``repeats`` times, the chains in turns (ladder, delta, ladder,
    ...), and the profiler's device time over ``repeats`` launches.
    Returns {chain: record}."""
    import torch

    from scheduler_tpu_torch.ops import megakernel as mk

    chains = {"ladder": kw, "delta": dict(kw, qfair_ladder=False)}
    runs = {c: mk.mega_allocate(*args, n_queues=n_queues, **ckw) for c, ckw in chains.items()}
    torch.cuda.synchronize()
    times = {c: [] for c in chains}
    for _ in range(repeats):
        for c, ckw in chains.items():
            start, stop = events()
            start.record()
            mk.mega_allocate(*args, n_queues=n_queues, **ckw)
            stop.record()
            torch.cuda.synchronize()
            times[c].append(start.elapsed_time(stop))
    (codes_l, stats_l), (codes_d, stats_d) = runs["ladder"], runs["delta"]
    placed = int((codes_l >= 0).sum())
    equal = bool(torch.equal(codes_l, codes_d)) and int(stats_l[0]) == int(stats_d[0])
    recs = {}
    for c, ckw in chains.items():
        codes, stats = runs[c]
        device_ms, _ = device_ms_per_call(
            lambda: mk.mega_allocate(*args, n_queues=n_queues, **ckw), repeats,
            match="mega_allocate_kernel")
        ms = device_ms if device_ms is not None else sum(times[c]) / repeats
        bound_ms, bound_by = mega_bound_ms(args, ckw, codes, stats, n_real, n_queues)
        recs[c] = {"phase": "ladder_vs_delta", "case": case, "chain": c, "mode": mega_mode(ckw),
                   "equal_codes": equal, "placed": placed, "stats": stats.tolist(),
                   "event_ms": times[c], "device_ms": device_ms, "ms": ms,
                   "us_per_step": 1e3 * ms / max(1, int(stats[0])),
                   "us_per_step_events": [1e3 * t / max(1, int(stats[0])) for t in times[c]],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plan": mk.plan_for(args, ckw, n_queues).summary()}
        emit(recs[c])
    if not equal:
        raise SystemExit(f"{case}: the ladder and the delta chain place apart")
    if (int(stats_l[mk.STATS.QFAIR_LOOKUPS]) != placed
            or int(stats_d[mk.STATS.QDELTA_UPDATES]) != placed or placed < 1):
        raise SystemExit(f"{case}: lookups {stats_l.tolist()} / refreshes {stats_d.tolist()} "
                         f"are not the {placed} placements")
    return recs


# -- qfair_solve against its plain version ---------------------------------------------

def qfair_fleet(q_n, r_n, seed, device):
    """Random water-fill operands (``qfair_solve``'s, as tensors on
    ``device``): integer weights, about a third of the queues asking far
    less than their slice (capped), scalar requests on half the cells, a
    pool that grows with the queue count."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f64 = torch.float64
    request = rng.uniform(100.0, 4000.0, (q_n, r_n))
    request[rng.random(q_n) < 0.3] *= 0.05
    request[:, 2:][rng.random((q_n, r_n - 2)) < 0.5] = 0.0
    return (torch.tensor(rng.integers(1, 10, q_n), dtype=f64, device=device),
            torch.tensor(request, dtype=f64, device=device),
            torch.tensor(rng.uniform(2000.0, 90_000.0, r_n) * max(1, q_n // 8), dtype=f64,
                         device=device),
            torch.tensor(request[:, 2:].sum(axis=1) > 0, device=device), bool(seed % 2),
            torch.full((r_n,), 1e-2, dtype=f64, device=device))


def qfair_bound_ms(ops, qf_raw):
    """The least time for the water-fill: its inputs read and outputs
    written once at the memory rate, against its float64 operations (each
    round run: the weight fold, and about 10 a dim a queue) at the peak."""
    weights, request = ops[0], ops[1]
    q_n, r_n = request.shape
    rounds = max(0, int(qf_raw[1]))
    nbytes = 8 * (q_n + 2 * q_n * r_n + 2 * r_n + 1) + 2 * q_n
    flops = rounds * q_n * (1 + 10 * r_n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


# The latency of a dependent float64 add on the H100 (NVIDIA H100 80GB
# HBM3): 8.27-8.34 SM clocks at its highest SM clock, 1,980 MHz, as
# scripts/qfair_ab.py measures it (PERF.md, qfair_solve's row).
DADD_NS = 8.3 / 1.98


def qfair_chain_floor(ops, qf_raw):
    """The water-fill's chain floor beside its bound: each round run folds
    the unmet weights and then the increased (or decreased) sums, two
    chains of Q dependent float64 adds, so rounds x 2 x Q x the add's
    latency (``DADD_NS``)."""
    q_n = int(ops[1].shape[0])
    rounds = max(0, int(qf_raw[1]))
    return {"rounds": rounds, "dadd_ns": DADD_NS,
            "chain_floor_ms": rounds * 2 * q_n * DADD_NS * 1e-6}


def compare_qfair(case, ops, iters, timed=False, repeats=20):
    """qfair_solve and its plain version on the same CUDA operands: deserved
    bit for bit, met and the evidence equal.  With ``timed``: the kernel's
    device time (profiler) and events around ``repeats`` launches, the
    plain version's events, the bound."""
    import torch

    from scheduler_tpu_torch.ops import qfair as qf

    got = qf.qfair_solve(*ops, iters=iters)
    torch.cuda.synchronize()
    start, stop = events()
    start.record()
    ref = qf.qfair_solve_reference(*ops, iters=iters)
    stop.record()
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[0].view(torch.int64), ref[0].view(torch.int64))
                 and torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]))
    diff = (got[0] - ref[0]).abs()
    rec = {"phase": "kernel_vs_plain", "kernel": "qfair_solve", "case": case,
           "queues": int(ops[1].shape[0]), "dims": int(ops[1].shape[1]), "iterations": iters,
           "converged_at": int(got[2][1]), "met": int(got[1].sum()), "equal": equal,
           "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
           "plain_ms": start.elapsed_time(stop)}
    if timed:
        start.record()
        for _ in range(repeats):
            qf.qfair_solve(*ops, iters=iters)
        stop.record()
        torch.cuda.synchronize()
        rec["event_ms"] = start.elapsed_time(stop) / repeats
        rec["device_ms"], _ = device_ms_per_call(lambda: qf.qfair_solve(*ops, iters=iters),
                                                 repeats, match="qfair_solve_kernel")
        rec["ms"] = rec["device_ms"] if rec["device_ms"] is not None else rec["event_ms"]
        rec["bound_ms"], rec["bound_by"] = qfair_bound_ms(ops, got[2])
        rec.update(qfair_chain_floor(ops, got[2]))
        rec["plan"] = dict(zip(("threads", "on_chip", "smem_bytes"),
                               qf.qfair_plan(*ops[1].shape)))
    emit(rec)
    if not equal:
        raise SystemExit(f"qfair_solve and its plain version disagree: {case}")
    return rec


def proportion_solve_operands(ssn, device):
    """The water-fill's operands of an open session, as proportion passes
    them (``ProportionPlugin.solve_inputs``), as tensors on ``device``."""
    import torch

    vocab = next(iter(ssn.jobs.values())).vocab
    weights, request, total, req_hs, total_hs, mins = (
        ssn.plugins["proportion"].solve_inputs(vocab))
    return (torch.from_numpy(weights).to(device), torch.from_numpy(request).to(device),
            torch.from_numpy(total).to(device), torch.from_numpy(req_hs).to(device), total_hs,
            torch.from_numpy(mins).to(device))


def device_vs_host_solve(ssn):
    """The open session's proportion ran the device water-fill; run the host
    water-fill on the same queue attributes and hold the deserved rows to
    each other bit for bit.  Returns a record (raises if they differ)."""
    import numpy as np

    from scheduler_tpu_torch.api.resource import ResourceVec

    plugin = ssn.plugins["proportion"]
    evidence = dict(plugin._qfair_evidence)
    vocab = next(iter(ssn.jobs.values())).vocab
    device = {uid: a.deserved.array.copy() for uid, a in plugin.queue_attrs.items()}
    for attr in plugin.queue_attrs.values():
        attr.deserved = ResourceVec.empty(vocab)
    plugin._qfair_evidence = {}
    plugin._solve_host(vocab)
    host_ms = plugin._qfair_evidence["solve_ms"]
    equal = all(np.array_equal(device[uid].view(np.int64), a.deserved.array.view(np.int64))
                for uid, a in plugin.queue_attrs.items())
    rec = {"phase": "device_solve_vs_host", "queues": len(device), "equal": equal,
           "evidence": evidence, "device_solve_ms": evidence.get("solve_ms"),
           "host_solve_ms": host_ms}
    emit(rec)
    if evidence.get("flavor") != "device" or not equal:
        raise SystemExit(f"the device water-fill and the host's disagree: {rec}")
    return rec


def phase_qfair_cases(device):
    """qfair_solve against its plain version on random fleets: 0 to 1,100
    queues (more than the CTA's threads), 2 to 40 dims (past a warp's
    lanes; 1,100 x 40 past shared memory: the global arm), capped and
    uncapped.  Returns the worst error."""
    worst = 0.0
    for q_n, r_n, seed in ((1, 2, 0), (3, 4, 1), (8, 8, 2), (40, 18, 3), (100, 8, 4),
                           (128, 18, 5), (128, 2, 6), (0, 2, 7), (1, 40, 9), (33, 3, 11),
                           (33, 40, 12), (300, 40, 14), (1100, 8, 15), (1100, 40, 16)):
        rec = compare_qfair(f"random_{q_n}q_{r_n}r", qfair_fleet(q_n, r_n, seed, device),
                            q_n + 4)
        worst = max(worst, rec["max_abs_err"])
    return worst


# -- static_predicate_mask against its plain version ------------------------------------

def predicate_operands(st, device):
    """The kernel's operands as the predicates plugin builds them for the
    session tensors ``st``: task rows at signature width, every node."""
    import numpy as np
    import torch

    from scheduler_tpu_torch.plugins.predicates import signature_rows

    _, sel, unk, tol = signature_rows(st)
    nodes = st.nodes

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=bool)).to(device)

    return (dev(sel), dev(unk), dev(nodes.labels), dev(nodes.unschedulable),
            dev(nodes.taints), dev(tol))


def random_predicate_operands(s, n, l, k, device, seed=7):
    """Random 0/1 operands with a mix of passing and failing pairs: about
    two required label pairs a task, each present on 90 % of the nodes, and
    taints on 5 % of the (node, taint) pairs, half of them tolerated."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrays = (rng.random((s, l)) < 2.0 / max(l, 1), rng.random(s) < 0.01,
              rng.random((n, l)) < 0.9, rng.random(n) < 0.01,
              rng.random((n, k)) < 0.05, rng.random((s, k)) < 0.5)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


# The timed fields of a static_predicate_mask case in the kernels line.
PREDICATE_TIMES = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library_call_ms")


def predicate_bound_ms(ops):
    """Each input read once and the [S, N] bool output written once at the
    memory rate, against 2*S*N*(L+K) operations at the int8 tensor-core rate
    (0/1 operands are exact there)."""
    sel, _, _, _, taints, _ = ops
    s, l = sel.shape
    n, k = taints.shape
    nbytes = sum(t.numel() * t.element_size() for t in ops) + s * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * s * n * (l + k) / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def predicate_library_ms(ops, repeats):
    """One torch.matmul of [sel | untolerated] by [missing ; taints] in
    float32 with TF32 off: the contraction alone, without the gates.
    Returns (events around ``repeats`` calls, over ``repeats``; the device
    time a call from a profiler trace)."""
    import torch

    sel, _, labels, _, taints, tol = ops
    a = torch.cat([sel, ~tol], dim=1).to(torch.float32)
    b = torch.cat([~labels, taints], dim=1).to(torch.float32).T.contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.matmul(a, b)
    start, stop = events()
    start.record()
    for _ in range(repeats):
        torch.matmul(a, b)
    stop.record()
    torch.cuda.synchronize()
    device_ms, _ = device_ms_per_call(lambda: torch.matmul(a, b), repeats)
    return start.elapsed_time(stop) / repeats, device_ms


def compare_predicate(case, ops, timed=False, repeats=20):
    """static_predicate_mask and its plain version on the same CUDA
    operands: equal masks (tolerance: none).  With ``timed``: the kernel's
    and ``torch.matmul``'s device time a call from a profiler trace
    (``device_ms`` = ``ms``, ``library_device_ms`` = ``library_ms``) and
    CUDA events around ``repeats`` calls of each, host dispatch included
    (``call_ms``, ``library_call_ms``)."""
    import torch

    from scheduler_tpu_torch.ops import predicate_kernel as pk

    mask_k = pk.static_predicate_mask(*ops)
    torch.cuda.synchronize()
    start, stop = events()
    start.record()
    mask_r = pk.static_predicate_mask_reference(*ops)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    equal = bool(torch.equal(mask_k, mask_r))
    s, l = ops[0].shape
    n, k = ops[4].shape
    rec = {"phase": "kernel_vs_plain", "kernel": "static_predicate_mask", "case": case,
           "S": s, "N": n, "L": l, "K": k, "equal": equal,
           "max_abs_err": int((mask_k.to(torch.int8) - mask_r.to(torch.int8)).abs().max())
           if mask_k.numel() else 0,
           "true_share": float(mask_k.float().mean()) if mask_k.numel() else None}
    if timed:
        start.record()
        for _ in range(repeats):
            pk.static_predicate_mask(*ops)
        stop.record()
        torch.cuda.synchronize()
        rec["call_ms"] = start.elapsed_time(stop) / repeats
        start.record()
        for _ in range(repeats):
            pk.static_predicate_mask_reference(*ops)
        stop.record()
        torch.cuda.synchronize()
        rec["plain_ms"] = start.elapsed_time(stop) / repeats
        rec["plain_first_ms"] = plain_ms
        rec["device_ms"], _ = device_ms_per_call(lambda: pk.static_predicate_mask(*ops), repeats,
                                                 match="static_predicate_mask")
        rec["bound_ms"], rec["bound_by"] = predicate_bound_ms(ops)
        rec["library_call_ms"], rec["library_device_ms"] = predicate_library_ms(ops, repeats)
        # The kernel's time and the library's: device time where the trace
        # has it (a call's events at small shapes time the host's dispatch).
        rec["ms"] = rec["device_ms"] if rec["device_ms"] is not None else rec["call_ms"]
        rec["library_ms"] = (rec["library_device_ms"] if rec["library_device_ms"] is not None
                             else rec["library_call_ms"])
        rec["library"] = "torch.matmul [S, L+K] x [L+K, N] f32, TF32 off (contraction only)"
    emit(rec)
    if not equal:
        raise SystemExit(f"kernel and plain version disagree: {case}")
    return rec


# -- placement_step against its plain version ------------------------------------------

def step_node_ops(kw) -> int:
    """Float32 operations per node that the step's function needs: the
    epsilon fit (6 a row over the r_dim real rows; pad rows always fit),
    the gates, the score terms and the masked argmax."""
    ops = 6 * kw["r_dim"] + 1 + 3
    ops += 2 * bool(kw["enforce_pod_count"]) + 2 * bool(kw["use_static"])
    lr_w, bal_w, bp_w = kw["weights"]
    if lr_w or bal_w or bp_w:
        ops += 6  # the requested columns and the safe divisors
    return ops + 13 * bool(lr_w) + 12 * bool(bal_w) + 11 * bool(bp_w)


def step_bytes(n, kw) -> int:
    """Bytes that the step's function needs, each read once, and its
    16-byte result: the r_dim real idle rows (pad rows always fit), the gate,
    the cpu and memory rows of allocatable only when a score weight is
    non-zero, the task-count row and the pod limit only under the pod-count
    gate, the static mask and score rows only with static rows, and the
    task's request, init request and epsilon rows."""
    r_dim = kw["r_dim"]
    nbytes = 4 * r_dim * n + n + 3 * 4 * r_dim + 16
    if any(kw["weights"]):
        nbytes += 2 * 4 * n
    if kw["enforce_pod_count"]:
        nbytes += 2 * 4 * n
    if kw["use_static"]:
        nbytes += n + 4 * n
    return nbytes


def step_bound_ms(ops, kw):
    """``step_bytes`` at the memory rate against n x ``step_node_ops``
    float32 operations at the peak rate."""
    n = ops[0].shape[1]
    t_bytes, t_ops = step_bytes(n, kw) / HBM_BYTES_PER_S, n * step_node_ops(kw) / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _step_tuple(res):
    best, score, cap, pods = res
    return int(best), float(score), int(cap), int(pods)


def device_ms_per_call(fn, repeats, match=None):
    """The device time a call of ``fn`` takes: ``repeats`` calls under
    ``torch.profiler`` (CUDA activity), the self device time in
    ``key_averages()`` of the device events (kernels) whose name holds
    ``match`` (all of them when None), over ``repeats``.  None where the
    trace shows no device time.  Returns (ms, the calls' results)."""
    ms, _, results = device_trace(fn, repeats, match)
    return ms, results


def device_trace(fn, repeats, match=None):
    """``device_ms_per_call``'s trace, with the launches a call it counted
    of the kernels whose name holds ``match``.  Returns (ms, launches a
    call, the calls' results)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = [fn() for _ in range(repeats)]
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for evt in prof.key_averages():
        # Device events only: a CPU op's self device time repeats its kernels'.
        if evt.device_type == DeviceType.CUDA and (match is None or match in evt.key):
            total_us += (getattr(evt, "self_device_time_total", 0)
                         or getattr(evt, "self_cuda_time_total", 0))
            launches += evt.count
    # A named kernel is averaged over the launches the trace holds (a trace
    # can miss one of a few long launches); a call of several kernels over
    # the calls.
    per = launches if match is not None and launches else repeats
    return (1e-3 * total_us / per if total_us > 0 else None), launches / repeats, results


def step_device_ms(loop, repeats):
    """K1's device duration a launch over ``repeats`` loop steps (see
    ``device_ms_per_call``).  Returns (ms, results seen)."""
    ms, results = device_ms_per_call(lambda: loop.step(0, -1), repeats,
                                     match="placement_step_kernel")
    return ms, set(results)


def step_queued_ms(loop, repeats):
    """CUDA events around ``repeats`` launches queued back to back with no
    wait between them: the kernel's time a launch where the launches
    overlap their submission."""
    import torch

    loop.step(0, -1)
    start, stop = events()
    start.record()
    loop.queue(0, repeats)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def step_round_trip_ms(loop, repeats, push_col):
    """Host clock over ``repeats`` loop steps that each push node column
    ``push_col`` (its values unchanged): one ``StepLoop.step`` as the loop
    makes it, from the call to the four results on the host."""
    seen = set()
    t0 = time.perf_counter()
    for _ in range(repeats):
        seen.add(loop.step(0, push_col))
    return 1e3 * (time.perf_counter() - t0) / repeats, seen


def compare_step(case, ops, kw, repeats=200, plain_repeats=20):
    """placement_step and its plain version on the same CUDA operands: all
    four outputs bitwise equal.  The kernel is timed four ways over
    ``repeats`` launches each: CUDA events around each launch, summed
    (``event_ms``: it counts the host's launch submission too); its device
    duration from a profiler trace (``device_ms``, also ``ms``); events
    around launches queued back to back (``queued_ms``); and the host's
    round trip of a loop step that pushes a node column
    (``round_trip_ms``).  The plain version over ``plain_repeats`` calls."""
    import torch

    from scheduler_tpu_torch.ops import step_kernel as sk

    got = _step_tuple(sk.placement_step(*ops, **kw))
    ref = _step_tuple(sk.placement_step_reference(*ops, **kw))
    ns = ops[0]
    loop = sk.StepLoop.for_one_task(*ops, **kw)
    try:
        seen = {loop.step(0, -1) for _ in range(repeats)}
    finally:
        loop.close()
    event_ms = loop.k1_ms / repeats
    loop = sk.StepLoop.for_one_task(*ops, **kw)
    try:
        device_ms, seen_p = step_device_ms(loop, repeats)
        queued_ms = step_queued_ms(loop, repeats)
        round_trip_ms, seen_r = step_round_trip_ms(loop, repeats, push_col=got[0])
    finally:
        loop.close()
    seen |= seen_p | seen_r
    start, stop = events()
    start.record()
    for _ in range(plain_repeats):
        sk.placement_step_reference(*ops, **kw)
    stop.record()
    torch.cuda.synchronize()
    equal = sk.same_result(got, ref) and all(sk.same_result(r, got) for r in seen)
    bound_ms, bound_by = step_bound_ms(ops, kw)
    rec = {"phase": "kernel_vs_plain", "kernel": "placement_step", "case": case,
           "n": int(ns.shape[1]), "equal": equal, "max_abs_err": sk.max_abs_err(got, ref),
           "result": list(got), "plain_result": list(ref),
           "ms": device_ms if device_ms is not None else event_ms, "device_ms": device_ms,
           "event_ms": event_ms, "queued_ms": queued_ms, "round_trip_ms": round_trip_ms,
           "launches_timed": repeats, "plain_ms": start.elapsed_time(stop) / plain_repeats,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           **{k: kw[k] for k in ("weights", "use_static", "enforce_pod_count",
                                 "with_capacity")}}
    emit(rec)
    if not equal:
        raise SystemExit(f"placement_step and its plain version disagree: {case}")
    return rec


def loop_step_operands(eng, t_idx=0, **overrides):
    """The placement-step operands of the engine's loop at its first state,
    for task row ``t_idx``, and the kernel's static arguments."""
    import torch

    from scheduler_tpu_torch.ops.fused import FUSED_OPERAND_NAMES, stage_step_operands

    named = dict(zip(FUSED_OPERAND_NAMES, eng.args))
    lkw = eng._allocate_kw()
    names = ("idle", "task_count", "allocatable", "pods_limit", "node_gate", "mins",
             "init_resreq", "resreq", "static_mask", "static_score", "sig_of_task")
    (ns_host, alloc, smask, sscore, gate, plim, task_initq, task_req, mins, r8,
     k1_row) = stage_step_operands(*(named[k] for k in names), use_static=lkw["use_static"])
    row = t_idx if k1_row is None else int(k1_row[t_idx])
    srow = row if lkw["use_static"] else 0
    ops = (torch.from_numpy(ns_host).to(alloc.device), alloc, smask[srow:srow + 1],
           sscore[srow:srow + 1], gate, plim, task_initq[row][:, None].contiguous(),
           task_req[row][:, None].contiguous(), mins)
    kw = dict(r_dim=int(named["idle"].shape[1]), r8=r8,
              weights=tuple(float(w) for w in lkw["weights"]), use_static=lkw["use_static"],
              enforce_pod_count=lkw["enforce_pod_count"], cpu_idx=0, mem_idx=1,
              with_capacity=lkw["batch_runs"])
    kw.update(overrides)
    return ops, kw


def phase_loop_parity(cache, device, check_every, conf_text=FLAGSHIP_CONF,
                      case="config3_templates"):
    """A main path's loop (``case``) on operands staged from a second
    cluster built the same way: once with the kernel (held to its plain
    version at the first step and every ``check_every``-th), once with the
    plain version on the card; the codes must be equal."""
    import torch

    from scheduler_tpu_torch.ops import fused as fused_mod

    t0 = time.perf_counter()
    _, eng = engine_for(cache, conf_text, device, engine="step")
    init_s = time.perf_counter() - t0
    args, kw = eng.args, eng._allocate_kw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes_k, stats_k = fused_mod.fused_allocate(*args, **kw, check_every=check_every)
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes_p, stats_p = fused_mod.fused_allocate(*args, **kw, plain_step=True)
    plain_s = time.perf_counter() - t0
    equal = bool(torch.equal(codes_k, codes_p))
    rec = {"phase": "loop_parity", "case": case, "engine_init_s": init_s,
           "equal": equal, "placed": int((codes_k >= 0).sum()), "steps": stats_k["steps"],
           "plain_steps": stats_p["steps"], "checked_steps": stats_k["checked"],
           "loop_s": kernel_s,
           "plain_loop_s": plain_s, "k1_ms": stats_k["k1_ms"],
           "us_per_step": 1e6 * kernel_s / stats_k["steps"]}
    emit(rec)
    if not equal:
        raise SystemExit("the loop with placement_step and with its plain version disagree")
    if stats_k["checked"] < 100:
        raise SystemExit(f"only {stats_k['checked']} loop steps were checked")
    return eng, rec


def phase_step_kernel_cases(eng3, eng2, device):
    """placement_step against its plain version: the templates loop's first
    step (nb 16,384, with capacity), config 2's operands (static rows, pod
    count, weights (1, 1, 0), no capacity), a random case at nb 65,536 (the
    largest bucket the step-kernel gate admits) and an all-infeasible one."""
    import torch

    def random_case(n, **flags):
        arrays = step_operands(n, n, 2, **flags)
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    full = dict(r_dim=2, r8=8, weights=(1.0, 1.0, 1.0), use_static=True,
                enforce_pod_count=True, cpu_idx=0, mem_idx=1, with_capacity=True)
    recs = [compare_step("config3_templates_first_step", *loop_step_operands(eng3)),
            compare_step("config2_operands", *loop_step_operands(eng2, with_capacity=False)),
            compare_step("random_65536", random_case(65536), full),
            compare_step("infeasible_16384", random_case(16384, infeasible=True), full)]
    if recs[-1]["result"][1] != float("-inf") or recs[-1]["result"][0] != 0:
        raise SystemExit("the infeasible case must give best 0 and score -inf")
    return recs


# -- checks of what a main path bound ---------------------------------------------

def check_binds(cache, n_nodes, n_pods, tasks_per_job, request_fn=None):
    """Flagship-shaped clusters: no node overcommitted (by the pods' own
    requests, ``request_fn(j, t)`` or the flagship's mix, and by the cache's
    idle ledger) and every gang bound whole or not at all."""
    from scheduler_tpu_torch.harness.synthetic import GIB as H_GIB, mixed_request

    binds = dict(cache.binder.binds)
    used = {}
    per_gang = {}
    for key, host in binds.items():
        name = key.split("/", 1)[1]
        group, t = name.rsplit("-", 1)
        j = int(group.split("-")[1])
        req = (request_fn(j, int(t)) if request_fn is not None
               else mixed_request(j * tasks_per_job + int(t), False))
        cpu, mem = used.get(host, (0.0, 0.0))
        used[host] = (cpu + req["cpu"], mem + req["memory"])
        per_gang[j] = per_gang.get(j, 0) + 1
    over = [h for h, (c, m) in used.items() if c > 64_000.0 or m > 256.0 * H_GIB]
    if over:
        raise SystemExit(f"overcommitted nodes: {over[:5]}")
    # Every pod of a fixture gang counts toward minMember: gang == size.
    for j, bound in per_gang.items():
        size = min(tasks_per_job, n_pods - j * tasks_per_job)
        if bound < size:
            raise SystemExit(f"gang job-{j:05d} bound {bound} of minMember {size}")
    check_idle_ledger(cache)
    return len(binds), len(per_gang)


def check_idle_ledger(cache):
    mins = cache.vocab.min_thresholds()
    idle_min = min(float((n.idle.array[:2] + mins[:2]).min()) for n in cache.nodes.values())
    if idle_min < 0.0:
        raise SystemExit("a node's idle ledger is below -epsilon after commit")


def check_config2_binds(cache):
    """Configs 2 and 5: no node overcommitted in any resource its pods
    request (cpu, memory, GPUs) or past its pod limit, and every bound pod
    with a zone selector on a node of that zone.  Returns (binds, most pods
    on one node)."""
    binds = dict(cache.binder.binds)
    pods = {f"{t.namespace}/{t.name}": t.pod
            for job in cache.jobs.values() for t in job.tasks.values()}
    used, count = {}, {}
    for key, host in binds.items():
        pod = pods[key]
        on_host = used.setdefault(host, {})
        for name, qty in pod.containers[0].items():
            on_host[name] = on_host.get(name, 0.0) + qty
        count[host] = count.get(host, 0) + 1
        labels = cache.nodes[host].node.labels
        for k, v in pod.node_selector.items():
            if labels.get(k) != v:
                raise SystemExit(f"{key} selects {k}={v} but sits on {host} ({labels})")
    for host, on_host in used.items():
        alloc = cache.nodes[host].node.allocatable
        if any(qty > alloc.get(name, 0.0) for name, qty in on_host.items()) or \
                count[host] > alloc["pods"]:
            raise SystemExit(f"node {host} overcommitted: {on_host}, {count[host]} pods")
    check_idle_ledger(cache)
    return len(binds), max(count.values(), default=0)


def host_loop_binds(cache, conf_text):
    """The port's host loop (``AllocateAction._heap_loop``) on ``cache``, on
    the CPU: its binds."""
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session

    ssn = open_session(cache, parse_scheduler_conf(conf_text).tiers, device="cpu")
    AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
    close_session(ssn)
    return dict(cache.binder.binds)


# -- phases -------------------------------------------------------------------------

def phase_device():
    import torch

    from scheduler_tpu_torch.ops import cuda_build

    cuda_build.load(verbose=True)
    info = cuda_build.build_info
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "stack frame" in ln or ln.endswith(".cu:")]
    # Registers a thread of each kernel entry (its mangled name: the
    # template arguments of mega_allocate_kernel<USE_STATIC, MQ, REL> read
    # as Lb0 / Lb1 in order).
    by_entry, entry = {}, None
    for ln in info["log"].splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln and entry is not None:
            by_entry[entry] = int(ln.split("Used")[1].split()[0])
            entry = None
    # The host commit's C++ library (scheduler_tpu_torch/native), built
    # with $CXX at first use: it must build and load (the flag is on).
    from scheduler_tpu_torch import native

    t0 = time.perf_counter()
    lib = {"path": native.build(), "loaded": native.available(), "enabled": native.enabled(),
           "build_s": time.perf_counter() - t0}
    if not (lib["loaded"] and lib["enabled"]):
        raise SystemExit(f"the native library did not build and load: {lib}")
    emit({"phase": "device", "gpu": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sources": info["sources"],
          "build_s": info["seconds"], "ptxas": regs, "registers": by_entry,
          "native": lib})


def reset_counts():
    from scheduler_tpu_torch.actions import allocate
    from scheduler_tpu_torch.ops import megakernel as mk
    from scheduler_tpu_torch.ops import predicate_kernel as pk
    from scheduler_tpu_torch.ops import qfair as qf
    from scheduler_tpu_torch.ops import step_kernel as sk

    from scheduler_tpu_torch.ops import lp_place as lp
    from scheduler_tpu_torch.ops import place_scan_kernel as psk
    from scheduler_tpu_torch.ops import xla_step as xs

    for route in allocate.routes:
        allocate.routes[route] = 0
    lp.launches = 0
    lp.block_launches = 0
    mk.launches = 0
    pk.launches = 0
    qf.launches = 0
    sk.launches = 0
    psk.launches = 0
    xs.launches = 0
    xs.shard_launches = 0


def read_counts():
    from scheduler_tpu_torch.actions import allocate
    from scheduler_tpu_torch.ops import megakernel as mk
    from scheduler_tpu_torch.ops import predicate_kernel as pk
    from scheduler_tpu_torch.ops import qfair as qf
    from scheduler_tpu_torch.ops import step_kernel as sk

    from scheduler_tpu_torch.ops import lp_place as lp
    from scheduler_tpu_torch.ops import place_scan_kernel as psk
    from scheduler_tpu_torch.ops import xla_step as xs

    return ({"mega_allocate": mk.launches, "static_predicate_mask": pk.launches,
             "placement_step": sk.launches, "qfair_solve": qf.launches,
             "place_scan": psk.launches, "xla_step": xs.launches, "lp_relax": lp.launches,
             "xla_step_shards": xs.shard_launches, "lp_relax_blocks": lp.block_launches},
            dict(allocate.routes))


def run_cycle(cache, conf_path, engine="mega", after_action=None, shards=1):
    """One ``Scheduler.run_once`` on the card with the launch counts set to
    0 just before and read just after (``conf_path`` None: the default
    conf); the fused route must run ``engine``: one ``mega_allocate``
    launch, one ``placement_step`` launch a loop step and none of
    ``mega_allocate`` (``step``), or the loop's XLA step arm,
    one ``xla_step`` launch a step and none of the others (``xla``); or,
    with ``engine`` ``device``, the device route
    (the per-pop engine) must run once, with one ``place_scan`` launch a
    pop and no fused engine.  ``after_action(ssn)``, where given, reads the open
    session after each action.  With ``shards`` > 1 the engine runs on a
    node mesh of that many shards (``ops/mesh.py``): K1 launches once a
    shard a step, the XLA arm's shard mode (``xla_step_shards``) in place of
    ``xla_step``, the LP relaxation over node blocks (``lp_relax_blocks``)
    in place of ``lp_relax``; K2's mesh mode launches once.  Returns (record, launches); the record's
    ``notes`` hold the engine cache's outcome, the ``dirty`` refresh
    evidence and backfill's evidence."""
    import torch

    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils import phases

    sched = Scheduler(cache, scheduler_conf=conf_path)  # device None: the card
    if after_action is not None:
        sched._load_conf()  # the action list, as run_once would resolve it
        for action in sched.actions:
            def execute(ssn, run=action.execute):
                run(ssn)
                after_action(ssn)

            action.execute = execute
    reset_counts()
    phases.begin()
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    notes = phases.take_notes()
    spent = phases.end()
    launches, routes = read_counts()
    evidence = notes.get("device_pops" if engine == "device" else "cohort") or {}
    rec = {"cycle_s": cycle_s, "phases_s": spent, "engine": evidence.get("engine"),
           "kernel_ms": evidence.get("kernel_ms"), "steps": evidence.get("steps"),
           "cohort": evidence, "launches": launches, "routes": routes,
           "notes": {k: notes.get(k) for k in ("engine_cache", "dirty", "backfill")}}
    if evidence.get("engine") != engine or evidence.get("kernel_ms") is None:
        raise SystemExit(f"the main path did not run the {engine} engine: {evidence}")
    if engine == "device":
        if not (routes["device"] == 1 and routes["fused"] == routes["host"] == 0
                and launches["place_scan"] == evidence["pops"] > 0
                and launches["mega_allocate"] == launches["placement_step"]
                == launches["xla_step"] == 0):
            raise SystemExit(f"the device route did not launch place_scan once a pop: "
                             f"{routes}, {launches}, {evidence}")
        return rec, launches
    xla_key, lp_key = (("xla_step_shards", "lp_relax_blocks") if shards > 1
                       else ("xla_step", "lp_relax"))
    other_xla = "xla_step" if shards > 1 else "xla_step_shards"
    if launches[other_xla] or launches["lp_relax" if shards > 1 else "lp_relax_blocks"]:
        raise SystemExit(f"the main path ran an arm of another mesh: {launches} ({shards} "
                         f"shards)")
    if engine == "lp" and not (launches[lp_key] == 1
                               and 0 < rec["steps"] * shards == launches[xla_key]
                               and launches["mega_allocate"] == launches["placement_step"] == 0):
        raise SystemExit(f"the LP flavor did not launch {lp_key} once and {xla_key} once a "
                         f"repair step and shard: {launches}, {rec['steps']} steps")
    if engine == "mega" and not (launches["mega_allocate"] == 1
                                 and launches["xla_step"] == launches["placement_step"] == 0):
        raise SystemExit(f"the main path did not launch mega_allocate once: {launches}")
    if engine == "step" and not (0 < rec["steps"] * shards == launches["placement_step"]
                                 and launches["mega_allocate"] == launches[xla_key] == 0):
        raise SystemExit(f"the loop did not launch placement_step once a step and shard: "
                         f"{launches}, {rec['steps']} steps, {shards} shards")
    if engine == "xla" and not (0 < rec["steps"] * shards == launches[xla_key]
                                and launches["placement_step"] == 0
                                and launches["mega_allocate"] == 0):
        raise SystemExit(f"the loop's XLA step arm did not launch {xla_key} once a step and "
                         f"shard: {launches}, {rec['steps']} steps, {shards} shards")
    if routes["host"] != 0 or routes["fused"] < 1:
        raise SystemExit(f"the main path took the host route: {routes}")
    return rec, launches


def phase_main_path_config2(cache, conf_path, n_nodes, n_pods):
    rec, launches = run_cycle(cache, conf_path)
    binds, most = check_config2_binds(cache)
    emit({"phase": "main_path", "config": "config2", "nodes": n_nodes, "pods": n_pods,
          "binds": binds, "most_pods_on_a_node": most, **rec})
    if launches["static_predicate_mask"] < 1:
        raise SystemExit("the config-2 main path did not launch static_predicate_mask")
    if binds < 1:
        raise SystemExit("the config-2 main path bound nothing")
    return launches, binds


def binds_digest(binds) -> str:
    """A digest of a bind map (pod namespace/name -> node)."""
    import hashlib

    return hashlib.sha256(json.dumps(sorted(dict(binds).items())).encode()).hexdigest()


def phase_main_path_flagship(cache, conf_path, n_nodes, n_pods, tasks_per_job):
    """Path b, a cold cycle.  Returns (launches, the binds' digest, binds)."""
    rec, launches = run_cycle(cache, conf_path)
    binds, gangs = check_binds(cache, n_nodes, n_pods, tasks_per_job)
    digest = binds_digest(cache.binder.binds)
    emit({"phase": "main_path", "config": "config3", "nodes": n_nodes, "pods": n_pods,
          "binds": binds, "gangs_bound": gangs, "binds_digest": digest, **rec})
    if binds < 1:
        raise SystemExit("the main path bound nothing")
    return launches, digest, binds


def phase_main_path_templates(cache, conf_path, n_nodes, n_jobs, tasks_per_job):
    """BASELINE config 3's nodes and gangs with one request template a job:
    more than 4,096 signatures close the mega gate, and the loop runs with
    one placement-step launch a step."""
    rec, launches = run_cycle(cache, conf_path, engine="step")
    binds, gangs = check_binds(cache, n_nodes, n_jobs * tasks_per_job, tasks_per_job,
                               request_fn=job_template_request(n_jobs))
    steps, k1_ms, loop_ms = rec["steps"], rec["kernel_ms"], rec["cohort"]["loop_ms"]
    emit({"phase": "main_path", "config": "config3_templates", "nodes": n_nodes,
          "pods": n_jobs * tasks_per_job, "jobs": n_jobs, "binds": binds, "gangs_bound": gangs,
          "k1_ms": k1_ms, "loop_ms": loop_ms, "us_per_step": 1e3 * loop_ms / steps,
          "k1_us_per_launch": 1e3 * k1_ms / steps, **rec})
    if binds < 1:
        raise SystemExit("the templates main path bound nothing")
    return launches, rec


def phase_main_path_mq_flagship(cache, conf_path, n_nodes, n_pods, tasks_per_job):
    """The multi-queue flagship: config 3's cluster with its gangs dealt to
    three queues of weights 1:2:3 and proportion in the conf; the mega
    kernel in multi-queue mode.  Every gang must bind whole."""
    rec, launches = run_cycle(cache, conf_path)
    binds, gangs = check_binds(cache, n_nodes, n_pods, tasks_per_job)
    chain = rec["cohort"].get("queue_chain") or {}
    emit({"phase": "main_path", "config": "config3_multi_queue", "nodes": n_nodes,
          "pods": n_pods, "queues": len(MQ_QUEUES), "binds": binds, "gangs_bound": gangs,
          "queue_chain": chain, "qfair": rec["cohort"].get("qfair"), **rec})
    n_gangs = -(-n_pods // tasks_per_job)
    if binds != n_pods or gangs != n_gangs:
        raise SystemExit(f"the multi-queue flagship bound {binds} pods in {gangs} gangs, "
                         f"not {n_pods} in {n_gangs}")
    if chain.get("queues") != len(MQ_QUEUES) or not chain.get("delta_updates"):
        raise SystemExit(f"the multi-queue flagship did not run the queue chain: {chain}")
    check_declined_qfair(rec["cohort"].get("qfair"), launches, "the multi-queue flagship")
    return launches


# The JAX engine's reasons for not building the qfair ladder on a session.
QFAIR_DECLINES = ("run batching (multi-copy placements)", "mixed request classes within a queue")


def check_declined_qfair(qf, launches, path):
    """A multi-queue main path that the ladder does not admit: proportion
    solved on the card (one qfair_solve launch), and the engine says why
    the ladder declined, in the JAX engine's words."""
    qf = qf or {}
    if (qf.get("flavor") != "device" or qf.get("engaged") is not False
            or qf.get("reason") not in QFAIR_DECLINES or launches["qfair_solve"] != 1):
        raise SystemExit(f"{path}: unexpected qfair evidence {qf}, launches {launches}")


def phase_main_path_ladder(cache, conf_path):
    """The qfair ladder flagship: proportion's device water-fill, then the
    mega kernel in multi-queue mode with the ladder.  Checks: the ladder
    engaged with a rung a placement of a queue plus one (251) and 100
    classes after a converged solve, one
    rung lookup a placement, no node overcommitted in any of its 8 dims or
    past 110 pods."""
    rec, launches = run_cycle(cache, conf_path)
    binds, most = check_config2_binds(cache)
    evidence = rec["cohort"]
    qf = evidence.get("qfair") or {}
    chain = evidence.get("queue_chain") or {}
    emit({"phase": "main_path", "config": "mq_ladder", "nodes": LADDER_NODES,
          "pods": LADDER_PATH_PODS, "queues": LADDER_QUEUES, "binds": binds,
          "most_pods_on_a_node": most, "queue_chain": chain, "qfair": qf, **rec})
    rungs = LADDER_PATH_PODS // LADDER_QUEUES + 1
    wrong = []
    if qf.get("flavor") != "device" or qf.get("engaged") is not True:
        wrong.append("the ladder did not engage on the device flavor")
    if qf.get("converged_at", -1) < 0:
        wrong.append("the water-fill did not converge")
    if qf.get("rungs") != rungs or qf.get("classes") != LADDER_QUEUES:
        wrong.append(f"not {rungs} rungs and {LADDER_QUEUES} classes")
    if not 0 < binds == qf.get("ladder_lookups") == evidence.get("placed"):
        wrong.append("the lookups are not the placements")
    if launches["qfair_solve"] != 1:
        wrong.append("qfair_solve did not run once")
    if wrong:
        raise SystemExit(f"the ladder flagship: {'; '.join(wrong)}: {qf}, {launches}")
    return launches


def phase_main_path_config5(cache, conf_path, n_nodes, n_gangs):
    """BASELINE config 5, GPU topology gangs: K3 for the zone selectors, the
    mega kernel in static-row mode at r_dim 3.  Every pod must bind, in its
    zone, with no node past its 8 GPUs."""
    rec, launches = run_cycle(cache, conf_path)
    binds, most = check_config2_binds(cache)
    emit({"phase": "main_path", "config": "config5", "nodes": n_nodes, "gangs": n_gangs,
          "pods": 8 * n_gangs, "binds": binds, "most_pods_on_a_node": most, **rec})
    if launches["static_predicate_mask"] < 1:
        raise SystemExit("the config-5 main path did not launch static_predicate_mask")
    if binds != 8 * n_gangs:
        raise SystemExit(f"config 5 bound {binds} pods, not {8 * n_gangs}")
    return launches


def phase_main_path_default_tiers(cache, conf_path, n_nodes, n_pods):
    """BASELINE config 2 under the JAX default conf's plugin tiers
    (conformance and proportion join): one queue, but the mega kernel runs
    in multi-queue mode with static rows.  Checks as config 2's; the binds
    are held to the host loop's later (``check_host_loop``).  Returns (launches,
    binds)."""
    rec, launches = run_cycle(cache, conf_path)
    binds, most = check_config2_binds(cache)
    chain = rec["cohort"].get("queue_chain") or {}
    emit({"phase": "main_path", "config": "config2_default_tiers", "nodes": n_nodes,
          "pods": n_pods, "binds": binds, "most_pods_on_a_node": most,
          "queue_chain": chain, "qfair": rec["cohort"].get("qfair"), **rec})
    if launches["static_predicate_mask"] < 1:
        raise SystemExit("the default-tiers main path did not launch static_predicate_mask")
    if binds < 1:
        raise SystemExit("config 2 under the default tiers bound nothing")
    if chain.get("queues") != 1 or not chain.get("delta_updates"):
        raise SystemExit(f"the default-tiers main path did not run the queue chain: {chain}")
    check_declined_qfair(rec["cohort"].get("qfair"), launches, "the default tiers")
    return launches, dict(cache.binder.binds)


def pending_outcome(ssn, pending):
    """name -> [status, node] of the session's tasks named in ``pending``."""
    return {t.name: [t.status.name, t.node_name]
            for job in ssn.jobs.values() for t in job.tasks.values() if t.name in pending}


def reclaim_host_loop(thin_requests=0, scale=1.0):
    """The port's host loop (``AllocateAction._heap_loop``) on the CPU on
    config 4's aftermath (``harness.make_reclaim_aftermath_cluster``, with
    ``thin_requests`` distinct thin requests): the pending tasks' statuses
    and nodes after the action, and the binds."""
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.harness import make_reclaim_aftermath_cluster

    cache = make_reclaim_aftermath_cluster(scale, thin_requests=thin_requests).cache
    pending = {t.name for job in cache.jobs.values() for t in job.tasks.values()
               if t.status.name == "PENDING"}
    ssn = open_session(cache, parse_scheduler_conf(RECLAIM_CONF).tiers, device="cpu")
    AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
    outcome = pending_outcome(ssn, pending)
    close_session(ssn)
    return {"statuses": outcome, "binds": dict(cache.binder.binds)}


def phase_main_path_reclaim(cache, conf_path, config="config4_reclaim_aftermath", engine="mega",
                            codes_path=None):
    """BASELINE config 4 after its reclaim (``harness.make_reclaim_aftermath_cluster``):
    the mega kernel in multi-queue mode with releasing capacity (path h),
    or, with distinct thin requests past the mega gate, the loop's
    releasing arm on its XLA step arm (path k, ``engine`` "xla"; the codes
    go to ``codes_path``).  Checks: the engine; the ladder declined for
    releasing capacity; tasks both
    allocated and pipelined, as many as the kernel placed; on every node the
    allocated requests within its idle, the pipelined ones within its
    releasing capacity (every dim, to the vocabulary's epsilon) and no more
    than its pod limit; binds and pipelines equal to the host loop's on a
    twin (``check_reclaim_host_loop``).  Returns (launches, outcome)."""
    import numpy as np

    mins = cache.vocab.min_thresholds()
    before = {name: (n.idle.array.copy(), n.releasing.array.copy(), len(n.tasks),
                     n.allocatable.array.copy())
              for name, n in cache.nodes.items()}
    pending = {t.name for job in cache.jobs.values() for t in job.tasks.values()
               if t.status.name == "PENDING"}
    seen = {}

    def after_allocate(ssn):
        seen["statuses"] = pending_outcome(ssn, pending)
        seen["requests"] = {t.name: t.resreq.array.copy() for job in ssn.jobs.values()
                            for t in job.tasks.values() if t.name in pending}

    with ReadbackSpy() as spy:
        rec, launches = run_cycle(cache, conf_path, engine=engine, after_action=after_allocate)
    if codes_path is not None:
        np.save(codes_path, spy.codes)
    statuses, requests = seen["statuses"], seen["requests"]
    on_node = {name: [np.zeros_like(b[0]), np.zeros_like(b[0]), 0]
               for name, b in before.items()}
    split = {}
    for name, (status, node) in statuses.items():
        split[status] = split.get(status, 0) + 1
        if status in ("BINDING", "ALLOCATED", "PIPELINED"):
            acc = on_node[node]
            req = requests[name]
            acc[1 if status == "PIPELINED" else 0][: req.shape[0]] += req
            acc[2] += 1
    wrong = []
    for name, (alloc, pipe, count) in on_node.items():
        idle0, rel0, tasks0, allocatable = before[name]
        if (alloc - idle0 > mins[: alloc.shape[0]]).any():
            wrong.append(f"{name}: allocated {alloc.tolist()} past idle {idle0.tolist()}")
        if (pipe - rel0 > mins[: pipe.shape[0]]).any():
            wrong.append(f"{name}: pipelined {pipe.tolist()} past releasing {rel0.tolist()}")
        if tasks0 + count > 110:
            wrong.append(f"{name}: {tasks0 + count} pods")
    evidence = rec["cohort"]
    qf = evidence.get("qfair") or {}
    allocated = split.get("BINDING", 0) + split.get("ALLOCATED", 0)
    pipelined = split.get("PIPELINED", 0)
    binds = len(cache.binder.binds)
    arm = xla_arm_record(config, rec, loop_kw(spy.engine)) if engine == "xla" else None
    extra = {"xla_ms_per_step": arm["ms_per_step"],
             "loop_ms": rec["cohort"]["loop_ms"]} if arm else {}
    emit({"phase": "main_path", "config": config,
          "nodes": len(cache.nodes), "running": sum(b[2] for b in before.values()),
          "releasing": sum(1 for job in cache.jobs.values() for t in job.tasks.values()
                           if t.status.name == "RELEASING"),
          "pending": len(pending), "allocated": allocated, "pipelined": pipelined,
          "binds": binds, "statuses": split, "queue_chain": evidence.get("queue_chain"),
          "qfair": qf, **extra, **rec})
    if qf.get("reason") != "releasing capacity (pipeline arm)" or qf.get("engaged") is not False:
        wrong.append(f"the ladder did not decline for releasing capacity: {qf}")
    if not (allocated > 0 and pipelined > 0 and allocated + pipelined == evidence.get("placed")):
        wrong.append(f"{allocated} allocated and {pipelined} pipelined, the kernel placed "
                     f"{evidence.get('placed')}")
    if binds != allocated:
        wrong.append(f"{binds} binds for {allocated} allocated tasks")
    if wrong:
        raise SystemExit(f"{config}: {'; '.join(wrong[:5])}")
    return launches, {"statuses": statuses, "binds": dict(cache.binder.binds)}, arm


def check_reclaim_host_loop(twin, outcome, config="config4_reclaim_aftermath"):
    """Path h's (or k's) binds, pipelined tasks and statuses against the
    port's host loop on a twin cluster (``twin``: the ``reclaim_host_loop``
    child, on the CPU beside the kernel phases)."""
    host = twin.result()
    equal = host == outcome
    pipe = sum(1 for status, _ in outcome["statuses"].values() if status == "PIPELINED")
    host_pipe = sum(1 for status, _ in host["statuses"].values() if status == "PIPELINED")
    emit({"phase": "host_loop_parity", "config": config,
          "binds": len(outcome["binds"]), "host_loop_binds": len(host["binds"]),
          "pipelined": pipe, "host_loop_pipelined": host_pipe, "equal_to_host_loop": equal,
          "wall_s": time.perf_counter() - twin.t0})
    if not equal:
        raise SystemExit(f"{config}: binds or pipelines differ from the host loop's")


# -- the loop's arms at full size: paths i, j and k -----------------------------------

class ReadbackSpy:
    """Within the ``with`` block, keeps the last ``FusedAllocator`` of this
    process that read its codes back (``engine``) and a copy of its codes
    (``codes``)."""

    def __enter__(self):
        from scheduler_tpu_torch.ops.fused import FusedAllocator

        self.cls, self.orig = FusedAllocator, FusedAllocator.readback
        self.engine = self.codes = None

        def readback(eng, orig=self.orig):
            out = orig(eng)
            self.engine, self.codes = eng, out.copy()
            return out

        FusedAllocator.readback = readback
        return self

    def __exit__(self, *exc):
        self.cls.readback = self.orig


def proportion_state(ssn):
    """Queue uid -> (deserved, allocated) host vectors of proportion."""
    plugin = ssn.plugins["proportion"]
    return {uid: (attr.deserved.array.copy(), attr.allocated.array.copy())
            for uid, attr in plugin.queue_attrs.items()}


def check_overused_gate(cache, queues, binds, gang_of, request_of):
    """Proportion's overused gate, as far as the binds can show it: before
    its last gang a queue was not overused, so some dim kept its allocation
    then (the end's less that gang) at least eps below its deserved share.
    The largest gang a queue took bounds its last in every dim, so every
    queue that took gangs must keep a dim where deserved - (allocated - the
    largest gang) is at least eps.  ``gang_of(name)`` is a bound pod's
    (queue, gang) and ``request_of(gang)`` a pod's request vector in that
    gang; ``queues`` maps a queue to proportion's (deserved, allocated)
    after the action."""
    import numpy as np

    mins = cache.vocab.min_thresholds()
    gangs = {}
    for key in binds:
        queue, gang = gang_of(key.split("/", 1)[1])
        bound = gangs.setdefault(queue, {})
        bound[gang] = bound.get(gang, 0) + 1
    for queue, bound in gangs.items():
        deserved, allocated = queues[queue]
        r = min(deserved.shape[0], 2)
        largest = np.max([request_of(g)[:r] * n for g, n in bound.items()], axis=0)
        if np.all(deserved[:r] - (allocated[:r] - largest) < mins[:r]):
            raise SystemExit(f"queue {queue} took a gang while overused: deserved "
                             f"{deserved[:r].tolist()}, allocated {allocated[:r].tolist()}")
    return len(gangs)


def template_gang_of(queues):
    """``(queue, gang)`` of a templates cluster's pod name (job-JJJJJ-TTTT),
    its gangs dealt round-robin to ``queues``."""
    def gang_of(name):
        j = int(name.split("-")[1])
        return queues[j % len(queues)], j
    return gang_of


def template_request_of(n_jobs):
    """A templates cluster's pod request of gang j as a (cpu, memory)
    vector."""
    import numpy as np

    request = job_template_request(n_jobs)

    def request_of(j):
        req = request(j, 0)
        return np.asarray([req["cpu"], req["memory"]], dtype=np.float64)
    return request_of


def xla_step_bytes(n, r_dim, use_static, enforce_pod_count):
    """Bytes the loop's XLA step arm must move a step at node bucket ``n``:
    the node state's idle, releasing and task-count rows, allocatable and
    the gate read once, the pod limits and the static mask and score rows
    where they are on, and the winner's row written."""
    per_node = (2 * r_dim + 1) * 4 + r_dim * 4 + 1
    if enforce_pod_count:
        per_node += 4
    if use_static:
        per_node += 5
    return n * per_node + (2 * r_dim + 1) * 4


def xla_arm_record(path, rec, kw):
    """The XLA arm's numbers on a main path: steps, its summed event time
    (the kernel's launches) and host time (the C calls and their waits),
    each also a step, and the per-step bound by bytes."""
    steps = rec["steps"]
    ev = rec["cohort"]
    nbytes = xla_step_bytes(kw["n"], kw["r_dim"], kw["use_static"], kw["enforce_pod_count"])
    return {"path": path, "steps": steps, "xla_ms": ev["xla_ms"],
            "ms_per_step": ev["xla_ms"] / steps, "xla_host_ms": ev.get("xla_host_ms"),
            "host_ms_per_step": ev.get("xla_host_ms", 0.0) / steps, "loop_ms": ev["loop_ms"],
            "loop_ms_per_step": ev["loop_ms"] / steps, "node_bucket": kw["n"],
            "bytes_per_step": nbytes, "bound_ms_per_step": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"}


# The first steps of paths i and k that are replayed after the cycle: the
# kernel held to its plain version at each, and both timed.
XLA_CHECK_STEPS = 64
# The whole loop's replay holds the kernel to its plain version at the
# first step and every XLA_CHECK_EVERY-th.
XLA_CHECK_EVERY = 200
# The flags an ``XlaStep`` is bound with.
XLA_FLAG_KEYS = ("weights", "use_static", "enforce_pod_count", "has_releasing", "batch_runs",
                 "score_bound")


class XlaCapture:
    """The loop's XLA arm on a main path, recorded while the path runs
    without any work on the card: the arguments the first arm was built
    from (copies of the host's node arrays, the device operands by
    reference), and that arm's first ``limit`` steps (task row, static row,
    host cap; every step where ``limit`` is None) and their results.
    ``xla_step_record`` replays them after the cycle, outside its clock."""

    def __init__(self, limit=None):
        self.limit = limit
        self.args = self.flags = self.first = None
        self.steps, self.results = [], []
        self.arms = 0

    def __enter__(self):
        import numpy as np

        from scheduler_tpu_torch.ops import xla_step

        self._orig = orig = xla_step.XlaStep
        cap = self

        class Spy(orig):
            def __init__(self, *args, **kw):
                cap.arms += 1
                if cap.args is None:
                    cap.args = tuple(np.array(a) if isinstance(a, np.ndarray) else a
                                     for a in args)
                    cap.flags = {k: kw[k] for k in XLA_FLAG_KEYS}
                    cap.first = self
                super().__init__(*args, **kw)

            def step(self, t_idx, s_idx, hi0):
                result = super().step(t_idx, s_idx, hi0)
                if self is cap.first and (cap.limit is None or len(cap.steps) < cap.limit):
                    cap.steps.append((t_idx, s_idx, hi0))
                    cap.results.append(result)
                return result

        xla_step.XlaStep = Spy
        return self

    def __exit__(self, *exc):
        from scheduler_tpu_torch.ops import xla_step

        xla_step.XlaStep = self._orig
        self.first = None
        return False

    def arm(self, **kw):
        """A fresh arm at the captured starting state."""
        return self._orig(*self.args, **self.flags, **kw)


def _replay(arm, steps):
    """The steps through ``arm``; returns (results, host ms a step)."""
    try:
        t0 = time.perf_counter()
        results = [arm.step(*c) for c in steps]
        host_ms = 1e3 * (time.perf_counter() - t0) / len(steps)
    finally:
        arm.close()
    return results, host_ms


def xla_loop_check(path, cap):
    """Every step of a main path's XLA arm (``cap``: an ``XlaCapture`` of
    the whole loop) replayed from the arm's starting state: each result
    must be the main path's, and the kernel is held to its plain version on
    a clone of the node state (results and the node state it writes,
    bitwise) at the first step and every ``XLA_CHECK_EVERY``-th."""
    if cap.arms != 1:
        raise SystemExit(f"{path}: {cap.arms} XLA arms in one cycle (one expected)")
    arm = cap.arm(check_every=XLA_CHECK_EVERY)
    t0 = time.perf_counter()
    got, _ = _replay(arm, cap.steps)
    rec = {"phase": "loop_parity", "case": path, "steps": len(got),
           "checked_steps": arm.checked, "equal_to_main_path": got == cap.results,
           "replay_s": time.perf_counter() - t0}
    emit(rec)
    if not rec["equal_to_main_path"]:
        raise SystemExit(f"{path}: the replayed loop's results differ from the main path's")
    if arm.checked != -(-len(got) // XLA_CHECK_EVERY):
        raise SystemExit(f"{path}: only {arm.checked} loop steps were checked")
    return rec


def xla_step_record(path, cap):
    """The XLA step kernel on a main path's first ``XLA_CHECK_STEPS`` steps
    (``cap``: an ``XlaCapture``), replayed from the arm's starting state:
    the kernel held to its plain version at every step on a clone of the
    node state; its device time a step (profiler), the events around each
    launch, the host round trip of a step; the plain version on the card
    over the same steps; the bound by bytes."""
    import torch

    from scheduler_tpu_torch.ops import xla_step

    steps = cap.steps[:XLA_CHECK_STEPS]
    arm = cap.arm(check_every=1)
    got, _ = _replay(arm, steps)
    checked = arm.checked
    arm = cap.arm()
    again, round_trip_ms = _replay(arm, steps)
    event_ms = arm.xla_ms / len(steps)
    arm = cap.arm()
    feed = iter(steps)
    try:
        device_ms, _ = device_ms_per_call(lambda: arm.step(*next(feed)), len(steps) - 1,
                                          match="xla_step_kernel")
    finally:
        arm.close()
    arm = cap.arm(plain=True)
    plain, plain_host_ms = _replay(arm, steps)
    plain_ms = arm.xla_ms / len(steps)
    torch.cuda.synchronize()
    alloc = cap.args[3]
    n, r_dim = alloc.shape
    nbytes = xla_step_bytes(n, r_dim, cap.flags["use_static"], cap.flags["enforce_pod_count"])
    errs = [abs(a - b) for x, y in zip(got, plain) for a, b in zip(x, y)]
    rec = {"phase": "kernel_vs_plain", "kernel": "xla_step", "case": f"{path}_first_steps",
           "steps": len(steps), "checked_steps": checked,
           "equal": got == plain == again == cap.results[:len(steps)],
           "max_abs_err": float(max(errs, default=0)), "n": n, "r_dim": r_dim,
           "plan": xla_step.step_plan(n).describe(), "flags": cap.flags,
           "ms": device_ms if device_ms is not None else event_ms, "device_ms": device_ms,
           "event_ms": event_ms, "round_trip_ms": round_trip_ms, "plain_ms": plain_ms,
           "plain_host_ms": plain_host_ms, "bytes": nbytes,
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": None,
           "placed": sum(1 for r in got if r[2] or r[3])}
    emit(rec)
    if not rec["equal"] or checked != len(steps):
        raise SystemExit(f"{path}: xla_step and its plain version disagree on the first steps")
    return rec


def phase_xla_step_cases(device, repeats=50, plain_repeats=10):
    """xla_step against its plain version on the planted cases
    (``XLA_STEP_PLANTS``, default plan): the first step's five results and
    node state bitwise; then ``repeats`` steps of the same task on the
    evolving state, timed by profiler device time, events and the host
    round trip, beside the plain version's events over ``plain_repeats``."""
    import torch

    from scheduler_tpu_torch.ops import xla_step

    recs = {}
    for kind in sorted(XLA_STEP_PLANTS):
        ops, flags, hi0, roles = xla_plant_case(kind)
        failures = xla_plant_failures(kind, ops, flags, hi0, roles)
        arm = xla_arm_on(ops, flags, device, check_every=1)
        first, _ = _replay(arm, [(0, 0, hi0)])
        arm = xla_arm_on(ops, flags, device)
        _, round_trip_ms = _replay(arm, [(0, 0, hi0)] * repeats)
        event_ms = arm.xla_ms / repeats
        arm = xla_arm_on(ops, flags, device)
        try:
            device_ms, _ = device_ms_per_call(lambda: arm.step(0, 0, hi0), repeats,
                                              match="xla_step_kernel")
        finally:
            arm.close()
        arm = xla_arm_on(ops, flags, device, plain=True)
        _replay(arm, [(0, 0, hi0)] * plain_repeats)
        torch.cuda.synchronize()
        n, r_dim = ops["allocatable"].shape
        nbytes = xla_step_bytes(n, r_dim, flags["use_static"], flags["enforce_pod_count"])
        rec = {"phase": "kernel_vs_plain", "kernel": "xla_step", "case": kind, "n": n,
               "plan": xla_step.step_plan(n).describe(), "result": list(first[0]),
               "roles": roles, "property_failures": failures, "equal": not failures,
               "max_abs_err": 0.0, "ms": device_ms if device_ms is not None else event_ms,
               "device_ms": device_ms, "event_ms": event_ms, "round_trip_ms": round_trip_ms,
               "plain_ms": arm.xla_ms / plain_repeats,
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
        emit(rec)
        if failures:
            raise SystemExit(f"xla_step planted case {kind}: {failures}")
        recs[kind] = rec
    return recs


def loop_kw(eng):
    """The loop's shape facts of an engine, for ``xla_arm_record``."""
    return {"n": eng.n_bucket, "r_dim": len(eng.st.nodes.allocatable[0]),
            "use_static": eng.use_static, "enforce_pod_count": eng.enforce_pod_count}


def phase_main_path_tiers_templates(cache, conf_path, codes_path):
    """Path i: config3_templates' gangs under the JAX default conf's tiers
    (``TIERS_TEMPLATES``): proportion makes the one queue multi-queue,
    nodeorder's weights with runs turn the top-2 score bound on, and 5,000
    templates close the mega gate, so the loop runs its XLA step arm.
    Checks: no kernel of the loop launched, K3 built the static rows, the
    water-fill on the card and the ladder declined, no node overcommitted,
    gangs whole, proportion's overused gate.  Writes the codes to
    ``codes_path`` for the CPU twin (``check_cpu_codes``)."""
    import numpy as np

    n_nodes, n_jobs, tasks = TIERS_TEMPLATES
    seen = {}
    with ReadbackSpy() as spy:
        rec, launches = run_cycle(cache, conf_path, engine="xla",
                                  after_action=lambda ssn: seen.update(q=proportion_state(ssn)))
    np.save(codes_path, spy.codes)
    binds_map = dict(cache.binder.binds)
    binds, gangs = check_binds(cache, n_nodes, n_jobs * tasks, tasks,
                               request_fn=job_template_request(n_jobs))
    check_overused_gate(cache, seen["q"], binds_map, template_gang_of(("default",)),
                        template_request_of(n_jobs))
    ev = rec["cohort"]
    arm = xla_arm_record("templates_default_tiers", rec, loop_kw(spy.engine))
    emit({"phase": "main_path", "config": "templates_default_tiers", "nodes": n_nodes,
          "pods": n_jobs * tasks, "jobs": n_jobs, "binds": binds, "gangs_bound": gangs,
          "allocated": binds, "pipelined": 0, "xla_ms_per_step": arm["ms_per_step"],
          "loop_ms": ev["loop_ms"], "queue_chain": ev.get("queue_chain"),
          "qfair": ev.get("qfair"), **rec})
    if launches["static_predicate_mask"] < 1:
        raise SystemExit("path i did not launch static_predicate_mask")
    if binds < 1:
        raise SystemExit("path i bound nothing")
    check_declined_qfair(ev.get("qfair"), launches, "path i")
    return launches, arm


def phase_main_path_mq_templates(cache, conf_path, opts):
    """Path j: config3_templates' gangs dealt to queues q0, q1, q2 of
    weights 1:2:3 under the multi-queue conf (binpack alone): K1 with the
    loop's multi-queue pop.  Checks: one K1 launch a step, no node
    overcommitted, gangs whole, proportion's overused gate, the water-fill
    on the card and the ladder declined."""
    n_nodes, n_jobs, tasks = opts.nodes, opts.template_jobs, opts.template_tasks
    seen = {}
    rec, launches = run_cycle(cache, conf_path, engine="step",
                              after_action=lambda ssn: seen.update(q=proportion_state(ssn)))
    binds_map = dict(cache.binder.binds)
    binds, gangs = check_binds(cache, n_nodes, n_jobs * tasks, tasks,
                               request_fn=job_template_request(n_jobs))
    queues_hit = check_overused_gate(cache, seen["q"], binds_map, template_gang_of(MQ_QUEUES),
                                     template_request_of(n_jobs))
    ev = rec["cohort"]
    steps = rec["steps"]
    emit({"phase": "main_path", "config": "templates_multi_queue", "nodes": n_nodes,
          "pods": n_jobs * tasks, "jobs": n_jobs, "queues": len(MQ_QUEUES), "binds": binds,
          "gangs_bound": gangs, "queues_bound": queues_hit, "allocated": binds, "pipelined": 0,
          "k1_ms": ev["k1_ms"], "loop_ms": ev["loop_ms"],
          "us_per_step": 1e3 * ev["loop_ms"] / steps,
          "k1_us_per_launch": 1e3 * ev["k1_ms"] / steps, "queue_chain": ev.get("queue_chain"),
          "qfair": ev.get("qfair"), **rec})
    chain = ev.get("queue_chain") or {}
    if binds < 1 or chain.get("queues") != len(MQ_QUEUES) or not chain.get("delta_updates"):
        raise SystemExit(f"path j: {binds} binds, queue chain {chain}")
    check_declined_qfair(ev.get("qfair"), launches, "path j")
    return launches


def cpu_loop_codes(cache, conf_text, codes_path):
    """The fused route's engine on ``cache`` on the CPU (its loop's arms on
    CPU tensors): writes its codes to ``codes_path``; returns its engine,
    steps and seconds."""
    import numpy as np

    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.ops.fused import FusedAllocator

    ssn = open_session(cache, parse_scheduler_conf(conf_text).tiers, device="cpu")
    t0 = time.perf_counter()
    eng = FusedAllocator(ssn, collect_candidates(ssn), device="cpu")
    codes = eng.readback()
    seconds = time.perf_counter() - t0
    np.save(codes_path, codes)
    out = {"engine": eng.engine, "steps": eng.run_stats().get("steps"), "seconds": seconds}
    close_session(ssn)
    return out


def check_cpu_codes(twin, card_codes_path, path):
    """A main path's codes on the card against the same loop on the CPU
    (``twin``: the CPU child, on a cluster built the same way): bitwise."""
    import numpy as np

    cpu = twin.result()
    card = np.load(card_codes_path)
    mine = np.load(cpu["codes"])
    equal = card.dtype == mine.dtype and np.array_equal(card, mine)
    emit({"phase": "loop_cpu_parity", "config": path, "tasks": int(card.shape[0]),
          "cpu_engine": cpu["engine"], "cpu_steps": cpu["steps"], "cpu_loop_s": cpu["seconds"],
          "placed": int(((card >= 0) | (card <= -3)).sum()), "equal": bool(equal),
          "wall_s": time.perf_counter() - twin.t0})
    if not equal:
        raise SystemExit(f"{path}: the codes on the card differ from the CPU loop's")


def loop_host_twins():
    """Paths i and j at 0.1 scale (``TIERS_TEMPLATES_TWIN``,
    ``MQ_TEMPLATES_TWIN``), on the CPU: the fused route (the loop's XLA arm,
    K1's plain version with the multi-queue pop) and the host loop on twin
    clusters; their binds, the counts that differ, and each route's
    seconds."""
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session

    out = {}
    for path, shape, conf_text, kw in (
            ("templates_default_tiers", TIERS_TEMPLATES_TWIN, DEFAULT_TIERS_CONF, {}),
            ("templates_multi_queue", MQ_TEMPLATES_TWIN, MULTIQ_CONF,
             dict(queues=MQ_QUEUES, queue_weights=MQ_WEIGHTS))):
        rec = {"shape": list(shape)}
        for route in ("fused", "host"):
            cache = template_cluster(*shape, **kw)
            ssn = open_session(cache, parse_scheduler_conf(conf_text).tiers, device="cpu")
            t0 = time.perf_counter()
            if route == "host":
                AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
            else:
                AllocateAction().execute(ssn)
            close_session(ssn)
            rec[f"{route}_s"] = time.perf_counter() - t0
            rec[route] = dict(cache.binder.binds)
        out[path] = rec
    return out


def check_loop_host_twins(twin):
    """Paths i and j at 0.1 scale against the host loop (``twin``: the
    ``loop_host_twins`` child).  Path i's binds must equal the host loop's.
    Path j's are reported: on multi-queue sessions of per-gang templates
    the JAX package's fused route and host loop differ too (its own
    disagreement, which the port reproduces on both sides)."""
    res = twin.result()
    for path, rec in res.items():
        fused, host = rec["fused"], rec["host"]
        differ = sum(1 for k in set(fused) | set(host) if fused.get(k) != host.get(k))
        emit({"phase": "host_loop_parity", "config": f"{path}_0.1", "shape": rec["shape"],
              "binds": len(fused), "host_loop_binds": len(host), "binds_that_differ": differ,
              "equal_to_host_loop": differ == 0, "fused_s": rec["fused_s"],
              "host_loop_s": rec["host_s"], "wall_s": time.perf_counter() - twin.t0})
        if path == "templates_default_tiers" and differ:
            raise SystemExit(f"path i at 0.1 scale: {differ} binds differ from the host loop's")


# -- paths l and m: the resident engine across cycles ------------------------------

# Path l's churn: cycles after the steady one, each retiring a tenth of the
# gangs and submitting as many (the scenario ladder's config 3 churn).
STEADY_CHURN_CYCLES = 5

# Path m: config 2's cluster under the default conf, with BestEffort pods
# for backfill and a backlog of gangs created Pending (minimum resources
# set) for enqueue: (gangs, pods a gang, cpu milli, memory) of gangs that
# fit, and of gangs whose 20-cpu pods no 16-cpu node can hold, which stay
# pending in every cycle.
DEFAULT_CONF_BEST_EFFORT = 1000
DEFAULT_CONF_BACKLOG = (100, 8, 1000.0, 2 * GIB)
DEFAULT_CONF_WAITING = (10, 8, 20_000.0, 8 * GIB)
DEFAULT_CONF_CYCLES = 6
# Pods completing before each of cycles 3-6 (1 % of config 2's 5,000), one a
# node on as many nodes.
DEFAULT_CONF_COMPLETIONS = 50
# The engine cache's outcome in each cycle: the first build, the rebuild
# after cycle 1 placed the workload, then hits (a sparse refresh of the
# completions' nodes) while the backlog waits.
DEFAULT_CONF_OUTCOMES = ("miss", "rebuild", "hit", "hit", "hit", "hit")


def default_conf_cluster(n_nodes, n_pods):
    """Path m's cluster: ``make_kubemark_density_cluster(n_nodes, n_pods)``
    (BASELINE config 2) plus ``DEFAULT_CONF_BEST_EFFORT`` bare BestEffort
    pods (every odd one selecting zone ``z{t % 4}``) and the gangs of
    ``DEFAULT_CONF_BACKLOG`` and ``DEFAULT_CONF_WAITING``, their PodGroups
    created Pending with their minimum resources, as a submission is.
    Timestamps are fixed, so every build orders its jobs alike."""
    from scheduler_tpu_torch.apis.objects import GROUP_NAME_ANNOTATION, PodGroup, PodSpec
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster
    from scheduler_tpu_torch.harness.synthetic import KUBEMARK_TS0, pin_shadow_timestamps

    cache = make_kubemark_density_cluster(n_nodes, n_pods).cache
    stamp = iter(KUBEMARK_TS0 + 1.0 + k * 1e-6 for k in range(1 << 30))
    for t in range(DEFAULT_CONF_BEST_EFFORT):
        pod = PodSpec(name=f"be-{t:04d}", namespace="d", scheduler_name="volcano",
                      containers=[], node_selector={"zone": f"z{t % 4}"} if t % 2 else {})
        pod.creation_timestamp = next(stamp)
        cache.add_pod(pod)
    for kind, (n_gangs, size, cpu, mem) in (("backlog", DEFAULT_CONF_BACKLOG),
                                            ("waiting", DEFAULT_CONF_WAITING)):
        for g in range(n_gangs):
            name = f"{kind}-{g:03d}"
            pg = PodGroup(name=name, namespace="d", queue="default", min_member=size,
                          min_resources={"cpu": size * cpu, "memory": size * mem})
            pg.creation_timestamp = next(stamp)
            cache.add_pod_group(pg)
            for t in range(size):
                pod = PodSpec(name=f"{name}-{t}", namespace="d",
                              containers=[{"cpu": cpu, "memory": mem}],
                              annotations={GROUP_NAME_ANNOTATION: name})
                pod.creation_timestamp = next(stamp)
                cache.add_pod(pod)
    pin_shadow_timestamps(cache)
    return cache


def complete_pods(cache, count):
    """``count`` bound sleep pods complete (deleted through the cache), one
    a node: the first by pod name on each node, nodes in the order of their
    pods' names.  Returns the nodes touched."""
    bound = sorted((t for job in cache.jobs.values() for t in job.tasks.values()
                    if t.node_name and t.name.startswith("sleep-")), key=lambda t: t.name)
    nodes, pods = set(), []
    for task in bound:
        if task.node_name not in nodes:
            nodes.add(task.node_name)
            pods.append(task.pod)
            if len(pods) == count:
                break
    for pod in pods:
        cache.delete_pod(pod)
    return sorted(nodes)


def check_live_placements(cache, pod_limit=True):
    """No node past its capacity in any resource or (``pod_limit``: where
    the conf's predicates plugin gates it) past its pod limit, and every
    placed pod with a zone selector in its zone, over the pods the cache
    holds on nodes now.  Returns (pods placed, most pods on a node)."""
    used, count, placed = {}, {}, 0
    for job in cache.jobs.values():
        for task in job.tasks.values():
            host = task.node_name
            if not host:
                continue
            placed += 1
            on_host = used.setdefault(host, {})
            for container in task.pod.containers:
                for name, qty in container.items():
                    on_host[name] = on_host.get(name, 0.0) + qty
            count[host] = count.get(host, 0) + 1
            labels = cache.nodes[host].node.labels
            for k, v in task.pod.node_selector.items():
                if labels.get(k) != v:
                    raise SystemExit(f"{task.name} selects {k}={v} but sits on {host}")
    for host, on_host in used.items():
        alloc = cache.nodes[host].node.allocatable
        if any(qty > alloc.get(name, 0.0) for name, qty in on_host.items()) or \
                (pod_limit and count[host] > alloc["pods"]):
            raise SystemExit(f"node {host} overcommitted: {on_host}, {count[host]} pods")
    check_idle_ledger(cache)
    return placed, max(count.values(), default=0)


def phase_steady_flagship(opts):
    """Path l: BASELINE config 3 by the JAX package's steady protocol
    (``harness.measure.steady_cycle_phases``: the engine built once through
    the engine cache, then one timed cycle that hits it and launches K2
    before the host rebinds), then ``STEADY_CHURN_CYCLES`` cycles of config
    3's churn (``harness.config3_churn``), each timed as it comes
    (``timed_cycle_phases``: they rebuild).  Checks: the steady cycle hits
    with one K2 launch, binds every gang whole with no node overcommitted,
    and its bind map's digest is returned for path b's; each churn cycle
    rebuilds with one K2 launch; no node overcommitted at the end."""
    import numpy as np

    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.harness import config3_churn
    from scheduler_tpu_torch.harness.measure import steady_cycle_phases, timed_cycle_phases

    conf = parse_scheduler_conf(FLAGSHIP_CONF)
    build, churn = config3_churn(opts.nodes, opts.pods, opts.tasks_per_job)
    t0 = time.perf_counter()
    cache = build()
    emit({"phase": "cluster", "config": "config3_steady", "nodes": opts.nodes,
          "pods": opts.pods, "build_s": time.perf_counter() - t0})
    reset_counts()
    cycle_s, rec = steady_cycle_phases(cache, conf, ("allocate",))
    launches, routes = read_counts()
    notes = rec.pop("notes")
    evidence = notes.get("cohort") or {}
    binds, gangs = check_binds(cache, opts.nodes, opts.pods, opts.tasks_per_job)
    digest = binds_digest(cache.binder.binds)
    steady = {"cycle_s": cycle_s, "engine_cache": notes.get("engine_cache"),
              "dirty": notes.get("dirty"), "engine": evidence.get("engine"),
              "kernel_ms": evidence.get("kernel_ms"), "steps": evidence.get("steps"),
              "phases_s": {k: v for k, v in rec.items() if not k.startswith("upload")},
              "uploads": rec["uploads"], "upload_bytes": rec["upload_bytes"],
              "upload_hits": rec["upload_hits"], "launches": launches, "routes": routes,
              "binds": binds, "gangs_bound": gangs, "binds_digest": digest}
    emit({"phase": "main_path", "config": "config3_steady", "nodes": opts.nodes,
          "pods": opts.pods, **steady})
    if (steady["engine_cache"] != "hit" or steady["engine"] != "mega"
            or launches["mega_allocate"] != 1 or "overlap_host" not in rec
            or steady["kernel_ms"] is None):
        raise SystemExit(f"path l: the steady cycle did not hit the resident engine with one "
                         f"eager K2 launch: {steady}")
    if routes["host"] != 0 or routes["fused"] != 1 or binds != opts.pods:
        raise SystemExit(f"path l: the steady cycle bound {binds} of {opts.pods}: {routes}")
    rng = np.random.default_rng(42)
    churn_s, churn_launches = [], 0
    for i in range(1, STEADY_CHURN_CYCLES + 1):
        churn(cache, rng, i)
        before = len(cache.binder.binds)
        reset_counts()
        el, r = timed_cycle_phases(cache, conf, ("allocate",))
        lc, routes = read_counts()
        n = r.pop("notes")
        churn_s.append(el)
        churn_launches += lc["mega_allocate"]
        emit({"phase": "churn_cycle", "config": "config3_steady", "cycle": i, "cycle_s": el,
              "engine_cache": n.get("engine_cache"), "placed": len(cache.binder.binds) - before,
              "kernel_ms": (n.get("cohort") or {}).get("kernel_ms"), "phases_s": r,
              "launches": lc})
        if n.get("engine_cache") != "rebuild" or lc["mega_allocate"] != 1 or routes["host"]:
            raise SystemExit(f"path l: churn cycle {i} did not rebuild with one K2 launch: "
                             f"{n.get('engine_cache')}, {lc}, {routes}")
    # The flagship's conf has no predicates plugin: no pod-count gate.
    placed, _ = check_live_placements(cache, pod_limit=False)
    churn_rec = {"cycles": STEADY_CHURN_CYCLES, "cycle_s": churn_s,
                 "p50_s": float(np.percentile(churn_s, 50)),
                 "p99_s": float(np.percentile(churn_s, 99)), "placed_live": placed}
    emit({"phase": "churn", "config": "config3_steady", **churn_rec})
    native_ab = steady_native_ab(opts, conf, steady)
    return {"launches": launches, "churn_launches": churn_launches, "digest": digest,
            "steady": steady, "churn": churn_rec, "native_ab": native_ab}


def steady_native_ab(opts, conf, steady):
    """Path l's steady hit again on a fresh cluster with
    ``SCHEDULER_TORCH_NATIVE=0`` (the numpy halves of the host commit):
    the same binds, and its ``apply`` and cycle seconds beside the native
    run's."""
    from scheduler_tpu_torch.harness import config3_churn
    from scheduler_tpu_torch.harness.measure import steady_cycle_phases
    from scheduler_tpu_torch.ops import engine_cache

    engine_cache.clear()
    gc.collect()
    cache = config3_churn(opts.nodes, opts.pods, opts.tasks_per_job)[0]()
    with env_flag("SCHEDULER_TORCH_NATIVE", "0"):
        cycle_s, rec = steady_cycle_phases(cache, conf, ("allocate",))
    digest = binds_digest(cache.binder.binds)
    ab = {"native": {"cycle_s": steady["cycle_s"], "apply_s": steady["phases_s"].get("apply"),
                     "decode_s": steady["phases_s"].get("decode")},
          "numpy": {"cycle_s": cycle_s, "apply_s": rec.get("apply"), "decode_s": rec.get("decode"),
                    "engine_cache": rec["notes"].get("engine_cache")},
          "binds_digest_equal": digest == steady["binds_digest"]}
    emit({"phase": "native_ab", "config": "config3_steady", **ab})
    if not ab["binds_digest_equal"]:
        raise SystemExit("path l: the numpy commit bound differently from the native one")
    return ab


def phase_default_conf_loop(opts):
    """Path m: ``DEFAULT_CONF_CYCLES`` cycles of ``Scheduler.run_once`` with
    no conf (the default: enqueue, allocate and backfill over the default
    tiers) on ``default_conf_cluster``, ``DEFAULT_CONF_COMPLETIONS`` pods
    completing before each cycle from the third on, launch counts set to 0
    before each cycle and read after it.  Checks: the engine cache's
    outcomes are ``DEFAULT_CONF_OUTCOMES`` with a sparse refresh on every
    hit (with ``SCHEDULER_TORCH_ENGINE_CACHE=0``, the cold twin: every cycle
    ``off``), K2 once a cycle, K3 in cycle 1 only, the backlog admitted by
    enqueue and bound whole, the waiting gangs pending, backfill's binds,
    and no node overcommitted or past its pod limit, every selector
    honoured.  Returns each cycle's record with the digests of its binds
    and of the session's task statuses."""
    cold = os.environ.get("SCHEDULER_TORCH_ENGINE_CACHE") == "0"
    t0 = time.perf_counter()
    cache = default_conf_cluster(opts.config2_nodes, opts.config2_pods)
    n_pods = (opts.config2_pods + DEFAULT_CONF_BEST_EFFORT
              + DEFAULT_CONF_BACKLOG[0] * DEFAULT_CONF_BACKLOG[1]
              + DEFAULT_CONF_WAITING[0] * DEFAULT_CONF_WAITING[1])
    emit({"phase": "cluster", "config": "default_conf_loop", "nodes": opts.config2_nodes,
          "pods": n_pods, "cache": "off" if cold else "on",
          "build_s": time.perf_counter() - t0})
    cycles = []
    for cycle in range(DEFAULT_CONF_CYCLES):
        completed = (complete_pods(cache, DEFAULT_CONF_COMPLETIONS)
                     if cycle >= 2 else [])
        seen = {}

        def after_action(ssn, seen=seen):
            seen["statuses"] = sorted((t.name, t.status.name, t.node_name)
                                      for job in ssn.jobs.values() for t in job.tasks.values())
            seen["phases"] = sorted((uid, job.pod_group.status.phase)
                                    for uid, job in ssn.jobs.items()
                                    if job.pod_group is not None)

        before = len(cache.binder.binds)
        rec, launches = run_cycle(cache, None, after_action=after_action)
        notes = rec["notes"]
        phases_of = dict(seen["phases"])
        waiting = [uid for uid in phases_of if uid.startswith("d/waiting-")]
        backlog = [uid for uid in phases_of if uid.startswith("d/backlog-")]
        out = {"cycle": cycle + 1, "cycle_s": rec["cycle_s"], "phases_s": rec["phases_s"],
               "kernel_ms": rec["kernel_ms"], "engine_cache": notes["engine_cache"],
               "dirty": notes["dirty"], "backfill": notes["backfill"],
               "completed_on_nodes": len(completed), "binds": len(cache.binder.binds),
               "new_binds": len(cache.binder.binds) - before,
               "admitted": sum(phases_of[u] != "Pending" for u in backlog + waiting),
               "launches": launches,
               "binds_digest": binds_digest(cache.binder.binds),
               "statuses_digest": binds_digest({f"{n}": [s, h] for n, s, h in seen["statuses"]})}
        emit({"phase": "main_path", "config": "default_conf_loop",
              "cache": "off" if cold else "on", **out})
        want = "off" if cold else DEFAULT_CONF_OUTCOMES[cycle]
        if out["engine_cache"] != want:
            raise SystemExit(f"path m cycle {cycle + 1}: engine cache {out['engine_cache']}, "
                             f"expected {want}")
        if want == "hit" and (out["dirty"] or {}).get("mode") != "sparse":
            raise SystemExit(f"path m cycle {cycle + 1}: the hit's refresh was not sparse: "
                             f"{out['dirty']}")
        if launches["mega_allocate"] != 1:
            raise SystemExit(f"path m cycle {cycle + 1}: K2 launched "
                             f"{launches['mega_allocate']} times")
        k3_ok = launches["static_predicate_mask"] >= 1 if cycle == 0 else \
            launches["static_predicate_mask"] == 0
        if not k3_ok:
            raise SystemExit(f"path m cycle {cycle + 1}: K3 launched "
                             f"{launches['static_predicate_mask']} times")
        if out["admitted"] != len(backlog) + len(waiting):
            raise SystemExit(f"path m cycle {cycle + 1}: enqueue admitted {out['admitted']} "
                             f"of {len(backlog) + len(waiting)} gangs")
        cycles.append(out)
    placed, most = check_live_placements(cache)
    per_gang = {}
    for job in cache.jobs.values():
        if job.name.startswith(("backlog-", "waiting-")):
            per_gang[job.name] = sum(1 for t in job.tasks.values() if t.node_name)
    whole = sum(n == DEFAULT_CONF_BACKLOG[1] for g, n in per_gang.items() if g.startswith("b"))
    waiting_bound = sum(n for g, n in per_gang.items() if g.startswith("w"))
    be_bound = cycles[0]["backfill"]["host_binds"]
    summary = {"placed_live": placed, "most_pods_on_a_node": most, "backlog_gangs_whole": whole,
               "waiting_pods_bound": waiting_bound, "best_effort_bound": be_bound}
    emit({"phase": "default_conf_loop", "cache": "off" if cold else "on", **summary})
    if whole != DEFAULT_CONF_BACKLOG[0] or waiting_bound or \
            be_bound != DEFAULT_CONF_BEST_EFFORT:
        raise SystemExit(f"path m: unexpected placements: {summary}")
    if any(0 < n < DEFAULT_CONF_BACKLOG[1] for n in per_gang.values()):
        raise SystemExit(f"path m: a gang bound in part: {per_gang}")
    return {"cycles": cycles, "summary": summary}


def check_default_conf_twin(twin, result):
    """Path m against its cold twin (``--child default_conf_cold``, the
    same cycles with ``SCHEDULER_TORCH_ENGINE_CACHE=0``): per cycle, equal
    binds and equal task statuses."""
    cold = twin.result()
    differ = [c["cycle"] for c, d in zip(result["cycles"], cold["cycles"])
              if (c["binds_digest"], c["statuses_digest"]) != (d["binds_digest"],
                                                               d["statuses_digest"])]
    emit({"phase": "default_conf_twin", "cycles": len(cold["cycles"]),
          "equal_to_cold_twin": not differ, "differ": differ,
          "wall_s": time.perf_counter() - twin.t0})
    if differ or len(cold["cycles"]) != DEFAULT_CONF_CYCLES:
        raise SystemExit(f"path m: cycles {differ} differ from the cold twin")


# -- the per-pop engine, reclaim and preempt (paths n, n', o and the storms) --------

def scan_node_ops(r_dim, weights, enforce_pod_count, has_score) -> int:
    """Float32 operations a node and scanned task that place_scan's
    function needs (``step_node_ops``'s count, K1's, with the fit against
    both idle and releasing): the epsilon fits (6 a row each), their OR,
    the static mask, the pod-count gate, the static score's add, the score
    terms and the masked argmax."""
    ops = 12 * r_dim + 1 + 1 + 3 + 2 * bool(enforce_pod_count) + bool(has_score)
    lr_w, bal_w, bp_w = weights
    if lr_w or bal_w or bp_w:
        ops += 6  # the requested columns and the safe divisors
    return ops + 13 * bool(lr_w) + 12 * bool(bal_w) + 11 * bool(bp_w)


def scan_bound_ms(n, r_dim, t, scanned, placed, weights, enforce_pod_count, has_score):
    """place_scan's least time for one pop on this card: the larger of its
    bytes at the memory rate and its operations at the float32 peak.  The
    work is what this pop's data needs: the ``scanned`` tasks before the
    scan stopped (a ready break or a failure) and the ``placed`` ones.
    Bytes, each read or written once: the node state of the ``n`` real
    nodes (idle and releasing; allocatable's cpu and memory columns where a
    score weight is non-zero; task counts and pod limits under the
    pod-count gate) and the epsilon row; a scanned task's mask row (and
    score row), request rows and row index; the written idle or releasing
    row and task count of each placement, and the ``t`` results.
    Operations: ``scan_node_ops`` over every node for each scanned task."""
    state = n * 2 * r_dim * 4 + 4 * r_dim
    if any(weights):
        state += n * 2 * 4
    if enforce_pod_count:
        state += n * 2 * 4
    rows = scanned * (n * (1 + (4 if has_score else 0)) + 2 * r_dim * 4 + 4)
    written = placed * (r_dim * 4 + 4) + 3 * t * 4
    t_bytes = (state + rows + written) / HBM_BYTES_PER_S
    t_ops = (scanned * n * scan_node_ops(r_dim, weights, enforce_pod_count, has_score)
             / FP32_OPS_PER_S)
    return ("bytes" if t_bytes > t_ops else "operations"), 1e3 * max(t_bytes, t_ops)


class ScanCapture:
    """The per-pop engine's (``ops/allocator.py``) first ``limit`` pops,
    recorded while the main path runs without any work on the card: the
    arguments the engine built its node state from (its host snapshot) and,
    for each pop, references to its spec and the codes it returned.
    ``scan_record`` rebuilds the starting node state after the cycle and
    runs the pops again, outside the cycle's clock."""

    def __init__(self, limit):
        self.limit = limit
        self.pops = []
        self.snapshot = None
        self.weights = self.enforce = None

    def __enter__(self):
        from scheduler_tpu_torch.ops import allocator

        self._orig = build, place = (allocator.node_state_from_tensors,
                                     allocator.sequential_place_job)

        def build_spy(*args):
            if self.snapshot is None:
                self.snapshot = args
            return build(*args)

        def place_spy(state, spec, weights=(0.0, 0.0, 0.0), enforce_pod_count=False,
                      events=None):
            state, result = place(state, spec, weights, enforce_pod_count, events)
            if len(self.pops) < self.limit:
                self.weights, self.enforce = weights, enforce_pod_count
                self.pops.append((spec, result))
            return state, result

        allocator.node_state_from_tensors = build_spy
        allocator.sequential_place_job = place_spy
        return self

    def __exit__(self, *exc):
        from scheduler_tpu_torch.ops import allocator

        allocator.node_state_from_tensors, allocator.sequential_place_job = self._orig
        return False

    def start_state(self):
        """The engine's node state before its first pop, rebuilt from its
        host snapshot: (idle, releasing, task counts) copies the scan may
        write, and (allocatable, pod limits, mins)."""
        from scheduler_tpu_torch.ops import allocator

        state = allocator.node_state_from_tensors(*self.snapshot)
        return ([state.idle.clone(), state.releasing.clone(), state.task_count.clone()],
                [state.allocatable, state.pods_limit, state.mins])

    def operands(self, i):
        """Pop ``i``'s operands of ``place_scan`` after the node state."""
        spec = self.pops[i][0]
        return [spec.init_resreq, spec.resreq, spec.static_mask, spec.static_score, spec.rows,
                int(spec.ready_deficit), self.weights, self.enforce, spec.n_active]


def scan_record(capture, repeats=20):
    """place_scan against its plain version on the captured pops, replayed
    in order from the engine's starting node state: each pop's codes equal
    to the plain version's and to the codes the pop returned on the main
    path, the node state it writes bitwise the plain version's.  Its time a
    pop on the first pop's operands, the node state restored before each
    launch: CUDA events recorded by the kernel's entry point immediately
    around each of ``repeats`` launches (``event_ms``) and the profiler's
    device time (``device_ms``; ``ms`` is it where the trace has it); the
    plain version's time once; the first pop's launch plan and bound
    (``scan_bound_ms``)."""
    import numpy as np
    import torch

    from scheduler_tpu_torch.ops import place_scan_kernel as psk

    dyn, fixed = capture.start_state()
    saved = [x.clone() for x in dyn]
    worst, tasks, first = 0.0, 0, None
    for i, (spec, result) in enumerate(capture.pops):
        rest = fixed + capture.operands(i)
        dyn_p = [x.clone() for x in dyn]
        codes = psk.place_scan(*dyn, *rest)
        plain = psk.place_scan_reference(*dyn_p, *rest)
        torch.cuda.synchronize()
        main = np.stack([result.chosen, result.pipelined, result.failed]).astype(np.int32)
        if not torch.equal(codes, plain):
            raise SystemExit(f"place_scan: pop {i}'s codes differ from its plain version")
        if not np.array_equal(codes.cpu().numpy(), main):
            raise SystemExit(f"place_scan: pop {i}'s replay differs from the main path's codes")
        for a, b in zip(dyn, dyn_p):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise SystemExit(f"place_scan: pop {i}'s node state differs from its plain "
                                 f"version's")
            worst = max(worst, float((a.double() - b.double()).abs().max()))
        first = codes if first is None else first
        tasks += int(spec.rows.shape[0])
    dyn = [x.clone() for x in saved]
    rest = fixed + capture.operands(0)
    evs = events()
    total = 0.0
    for _ in range(repeats):
        for x, y in zip(dyn, saved):
            x.copy_(y)
        psk.place_scan(*dyn, *rest, events=evs)
        evs[1].synchronize()
        total += evs[0].elapsed_time(evs[1])

    def restored_launch():
        for x, y in zip(dyn, saved):
            x.copy_(y)
        return psk.place_scan(*dyn, *rest)

    device_ms, _ = device_ms_per_call(restored_launch, repeats, match="place_scan_kernel")
    for x, y in zip(dyn, saved):
        x.copy_(y)
    e0, e1 = events()
    e0.record()
    psk.place_scan_reference(*dyn, *rest)
    e1.record()
    e1.synchronize()
    spec = capture.pops[0][0]
    t = int(spec.rows.shape[0])
    n = int(spec.n_active)
    r_dim = int(dyn[0].shape[1])
    placed = int((first[0] >= 0).sum())
    scanned = placed + int(first[2].sum())
    has_score = spec.static_score is not None
    bound_by, bound_ms = scan_bound_ms(n, r_dim, t, scanned, placed, capture.weights,
                                       capture.enforce, has_score)
    event_ms = total / repeats
    ms = device_ms if device_ms is not None else event_ms
    plan = psk.scan_plan(n, r_dim, t, capture.weights, capture.enforce)
    return {"checked_pops": len(capture.pops), "checked_tasks": tasks, "max_abs_err": worst,
            "codes_equal": True, "nodes": n, "r_dim": r_dim, "pop_tasks": t,
            "scanned_tasks": scanned, "placed_tasks": placed, "weights": list(capture.weights),
            "enforce_pod_count": capture.enforce, "static_score_rows": has_score,
            "plan": plan.describe(), "ms": ms, "event_ms": event_ms, "device_ms": device_ms,
            "us_per_task": 1e3 * ms / max(scanned, 1), "plain_ms": e0.elapsed_time(e1),
            "bound_ms": bound_ms, "bound_by": bound_by}


def device_pops_split(rec):
    """The device route's ``device_pops`` phase split into the scan
    kernel's events, the host time in its wrapper and the rest (the pops'
    host work: heaps, commits, uploads, readbacks), in seconds."""
    total = rec["phases_s"].get("device_pops")
    scan_s = rec["kernel_ms"] / 1e3
    wrapper_s = rec["cohort"].get("wrapper_ms", 0.0) / 1e3
    return {"device_pops_s": total, "scan_s": scan_s, "wrapper_s": wrapper_s,
            "rest_s": None if total is None else total - scan_s - wrapper_s}


def phase_production_conf(opts, conf_path):
    """Path n: the production conf (``deploy/scheduler-conf.yaml``: enqueue,
    reclaim, allocate, backfill and preempt over the JAX default tiers) on
    b's cluster, one cold ``Scheduler.run_once``.  The static rows (5 bytes
    x 131,072 x 16,384) are far past the fused limit, so allocate takes the
    device route: K3 builds the predicates' mask rows and ``place_scan``
    runs once a job pop.  Checks: the route and the launches, no node
    overcommitted, every gang bound whole or not at all.  Then, outside
    the cycle's clock, ``place_scan`` against its plain version on the
    first ``SCAN_CHECK_POPS`` pops replayed, and timed (``scan_record``)."""
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    t0 = time.perf_counter()
    cache = make_synthetic_cluster(opts.nodes, opts.pods,
                                   tasks_per_job=opts.tasks_per_job).cache
    emit({"phase": "cluster", "config": "production_conf", "nodes": opts.nodes,
          "pods": opts.pods, "build_s": time.perf_counter() - t0})
    with ScanCapture(SCAN_CHECK_POPS) as capture:
        rec, launches = run_cycle(cache, conf_path, engine="device")
    binds, gangs = check_binds(cache, opts.nodes, opts.pods, opts.tasks_per_job)
    phases_s = rec["phases_s"]
    emit({"phase": "main_path", "config": "production_conf", "nodes": opts.nodes,
          "pods": opts.pods, "binds": binds, "gangs_bound": gangs,
          "pops": rec["cohort"]["pops"], "tasks_scanned": rec["cohort"]["tasks_scanned"],
          "place_scan_event_ms": rec["kernel_ms"],
          "place_scan_wrapper_ms": rec["cohort"].get("wrapper_ms"),
          "device_pops_split": device_pops_split(rec),
          "reclaim_s": phases_s.get("action:reclaim"),
          "preempt_s": phases_s.get("action:preempt"), **rec})
    if launches["static_predicate_mask"] < 1:
        raise SystemExit("path n did not launch static_predicate_mask")
    if binds < 1:
        raise SystemExit("path n bound nothing")
    scan = scan_record(capture)
    emit({"phase": "kernel_vs_plain", "kernel": "place_scan",
          "case": "production_conf_first_pops", **scan})
    return {"launches": launches, "routes": rec["routes"], "scan": scan,
            "cycle_s": rec["cycle_s"]}


def phase_default_tiers_device(opts, conf_path):
    """Path n': f's cluster (config 2 under the default tiers) with
    ``SCHEDULER_TORCH_FUSED_STATIC_LIMIT=1``: the fused gate declines and
    allocate takes the device route.  Checks: the route, config 2's bind
    checks; later its binds equal the host loop's (``check_host_loop``).
    Then its first ``SCAN_CHECK_POPS`` pops replayed (``scan_record``: the
    small-n plan).  Returns (launches, binds, the scan's record)."""
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster

    os.environ["SCHEDULER_TORCH_FUSED_STATIC_LIMIT"] = "1"
    cache = make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache
    with ScanCapture(SCAN_CHECK_POPS) as capture:
        rec, launches = run_cycle(cache, conf_path, engine="device")
    binds, most = check_config2_binds(cache)
    emit({"phase": "main_path", "config": "config2_default_tiers_device",
          "nodes": opts.config2_nodes, "pods": opts.config2_pods, "binds": binds,
          "most_pods_on_a_node": most, "pops": rec["cohort"]["pops"],
          "tasks_scanned": rec["cohort"]["tasks_scanned"],
          "place_scan_event_ms": rec["kernel_ms"],
          "place_scan_wrapper_ms": rec["cohort"].get("wrapper_ms"),
          "device_pops_split": device_pops_split(rec), **rec})
    if launches["static_predicate_mask"] < 1 or binds < 1:
        raise SystemExit(f"path n': {binds} binds, launches {launches}")
    scan = scan_record(capture)
    emit({"phase": "kernel_vs_plain", "kernel": "place_scan",
          "case": "config2_default_tiers_device_first_pops", **scan})
    return launches, dict(cache.binder.binds), scan


def reclaim_invariants(ssn, running_before):
    """After a reclaim action: evictions come only from queues that were
    overused when it began (recorded by the caller as ``running_before``:
    job uid -> (queue, running tasks)), no gang fell below its min_member
    or its own starting count, and on every node the pipelined requests
    fit in what its victims free (every dim, to the vocabulary's epsilon).
    Returns the counts."""
    import numpy as np

    mins = ssn.cache.vocab.min_thresholds()
    freed, piped, wrong = {}, {}, []
    evicted_queues = set()
    for job in ssn.jobs.values():
        ready = job.ready_task_num()
        queue, before = running_before.get(job.uid, (job.queue, 0))
        if ready < min(job.min_available, before):
            wrong.append(f"{job.uid} fell to {ready} of min_member {job.min_available}")
        for t in job.tasks.values():
            if t.status.name == "RELEASING":
                evicted_queues.add(queue)
                acc = freed.setdefault(t.node_name, np.zeros_like(mins))
                acc[: t.resreq.array.shape[0]] += t.resreq.array[: acc.shape[0]]
            elif t.status.name == "PIPELINED":
                acc = piped.setdefault(t.node_name, np.zeros_like(mins))
                acc[: t.init_resreq.array.shape[0]] += t.init_resreq.array[: acc.shape[0]]
    for node, need in piped.items():
        if (need - freed.get(node, np.zeros_like(mins)) > mins).any():
            wrong.append(f"{node}: pipelined {need.tolist()} past its victims' "
                         f"{freed.get(node, np.zeros_like(mins)).tolist()}")
    return wrong, evicted_queues, sum(1 for job in ssn.jobs.values()
                                      for t in job.tasks.values()
                                      if t.status.name == "PIPELINED")


def reclaim_cycle(cache, conf_path, device):
    """One cycle of ``conf_path`` (reclaim, then allocate) on ``device``
    (None: the card), reading the session after reclaim: evictions in order
    (the cache's), the invariants (``reclaim_invariants``), whether K2 meets
    releasing capacity, and the task statuses.  Returns (record, launches,
    outcome)."""
    import torch

    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils import phases

    running_before = {uid: (job.queue, job.ready_task_num()) for uid, job in cache.jobs.items()}
    overused = {}
    seen = {}
    sched = Scheduler(cache, scheduler_conf=conf_path, device=device)
    sched._load_conf()
    for action in sched.actions:
        def execute(ssn, run=action.execute, name=action.name()):
            if name == "reclaim":
                overused.update({q.name: ssn.overused(q) for q in ssn.queues.values()})
            run(ssn)
            if name == "reclaim":
                seen["reclaim"] = reclaim_invariants(ssn, running_before)
                seen["releasing_nodes"] = sum(
                    1 for n in ssn.nodes.values()
                    if (n.releasing.array[:2] > cache.vocab.min_thresholds()[:2]).any())
            seen["statuses"] = sorted((t.name, t.status.name, t.node_name)
                                      for job in ssn.jobs.values() for t in job.tasks.values())

        action.execute = execute
    reset_counts()
    phases.begin()
    t0 = time.perf_counter()
    sched.run_once()
    if device is None:
        torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    notes = phases.take_notes()
    spent = phases.end()
    launches, routes = read_counts()
    wrong, evicted_queues, pipelined = seen["reclaim"]
    statuses = {}
    for _, status, _ in seen["statuses"]:
        statuses[status] = statuses.get(status, 0) + 1
    bad_queues = sorted(q for q in evicted_queues if not overused.get(q))
    if bad_queues:
        wrong.append(f"evictions from queues not overused: {bad_queues}")
    evictions = list(cache.evictor.evicts)
    rec = {"cycle_s": cycle_s, "phases_s": spent, "routes": routes,
           "evictions": len(evictions), "pipelined_by_reclaim": pipelined,
           "binds": len(cache.binder.binds), "statuses": statuses,
           "overused_at_reclaim": overused,
           "releasing_nodes_at_allocate": seen["releasing_nodes"],
           "engine": (notes.get("cohort") or {}).get("engine"),
           "kernel_ms": (notes.get("cohort") or {}).get("kernel_ms"),
           "evict": notes.get("evict"), "victims": notes.get("victims")}
    outcome = {"evictions": evictions, "binds": dict(cache.binder.binds),
               "statuses": binds_digest({n: [s, h] for n, s, h in seen["statuses"]})}
    return rec, launches, outcome, wrong


def phase_config4_reclaim(conf_path):
    """Path o: BASELINE config 4 before its reclaim
    (``harness.make_reclaim_cluster``), ``reclaim, allocate`` over priority,
    gang and proportion on the card.  Checks (``reclaim_invariants``):
    evictions only from the overused queue, no gang below its floor,
    nothing pipelined past what its node's victims free; then allocate's
    one ``mega_allocate`` launch; later the evictions in order, the binds
    and the statuses equal to the same cycle on the CPU (``--child
    config4_reclaim_twin``)."""
    from scheduler_tpu_torch.harness import make_reclaim_cluster

    t0 = time.perf_counter()
    built = make_reclaim_cluster(RECLAIM_O_SCALE)
    emit({"phase": "cluster", "config": "config4_reclaim", "nodes": built.n_nodes,
          "pods": built.n_pods, "build_s": time.perf_counter() - t0})
    rec, launches, outcome, wrong = reclaim_cycle(built.cache, conf_path, None)
    emit({"phase": "main_path", "config": "config4_reclaim", "launches": launches, **rec})
    if rec["evictions"] < 1 or rec["pipelined_by_reclaim"] < 1:
        wrong.append(f"reclaim evicted {rec['evictions']}, pipelined "
                     f"{rec['pipelined_by_reclaim']}")
    if launches["mega_allocate"] != 1 or rec["engine"] != "mega" or launches["qfair_solve"] < 1:
        wrong.append(f"allocate after reclaim: engine {rec['engine']}, launches {launches}")
    if wrong:
        raise SystemExit(f"path o: {'; '.join(wrong[:5])}")
    return {"launches": launches, "outcome": outcome, "record": rec}


def check_config4_reclaim_twin(twin, card):
    """Path o against the same cycle on the CPU (``--child
    config4_reclaim_twin``): evictions in order, binds and statuses; then
    path o', which the twin ran on the card after the go, against o: the
    same outcome, ``action:reclaim`` beside o's.  Returns o''s record."""
    res = twin.result()
    cpu, dev = res, res["device_flavor"]
    equal = {k: cpu["outcome"][k] == card["outcome"][k] for k in card["outcome"]}
    emit({"phase": "cpu_parity", "config": "config4_reclaim", **equal,
          "cpu_cycle_s": cpu["record"]["cycle_s"], "wall_s": time.perf_counter() - twin.t0})
    if not all(equal.values()):
        raise SystemExit(f"path o differs from its CPU run: {equal}")
    equal = {k: dev["outcome"][k] == card["outcome"][k] for k in card["outcome"]}
    emit({"phase": "evict_flavors", "config": "config4_reclaim", **equal,
          "reclaim_s": {"host": card["record"]["phases_s"].get("action:reclaim"),
                        "device": dev["record"]["phases_s"].get("action:reclaim")},
          "cycle_s": {"host": card["record"]["cycle_s"], "device": dev["record"]["cycle_s"]},
          "engine": evict_summary(dev["record"]["evict"])})
    if not all(equal.values()):
        raise SystemExit(f"path o' differs from path o: {equal}")
    return dev


class env_flag:
    """Set environment variable ``name`` to ``value`` for a block."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


# The evidence counters of an engaged eviction engine that the script prints.
EVICT_COUNTERS = ("hunts", "planned_nodes", "evictions", "pipelined", "segments")


def check_engaged(evidence, path, kinds):
    """Fail when a flavor set to ``device`` did not engage its engine on a
    path that expects it to (``evidence``: the ``evict`` note, by kind):
    the run is not a quiet host run."""
    for kind in kinds:
        stats = (evidence or {}).get(kind) or {}
        if not stats.get("engaged"):
            raise SystemExit(f"{path}: the {kind} eviction engine did not engage: "
                             f"{stats.get('reason', 'no evidence')}")


def evict_session(cache, conf_text, device, flavor="host"):
    """One session of ``conf_text``'s actions on ``cache`` under the victim
    hunt's ``flavor`` (``SCHEDULER_TORCH_EVICT``) on ``device`` (None: the
    card): the evictions in commit order (captured at the cache), the task
    statuses and nodes, the binds, the launches and the ``evict`` note."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, get_action, open_session
    from scheduler_tpu_torch.utils import phases

    evlog = []
    evict, evict_bulk = cache.evict, cache.evict_bulk

    def one(task, reason):
        evlog.append([task.name, reason])
        return evict(task, reason)

    def bulk(tasks, reason):
        out = evict_bulk(tasks, reason)
        evlog.extend([t.name, reason] for t in out)
        return out

    cache.evict, cache.evict_bulk = one, bulk
    conf = parse_scheduler_conf(conf_text)
    with env_flag("SCHEDULER_TORCH_EVICT", flavor):
        reset_counts()
        phases.begin()
        t0 = time.perf_counter()
        ssn = open_session(cache, conf.tiers, device=device)
        for name in conf.actions:
            get_action(name).execute(ssn)
        session_s = time.perf_counter() - t0
        statuses = sorted([t.name, t.status.name, t.node_name]
                          for job in ssn.jobs.values() for t in job.tasks.values())
        close_session(ssn)
        evidence = phases.take_notes().get("evict") or {}
        phases.end()
        launches, _ = read_counts()
    return {"evictions": evlog, "statuses": statuses, "binds": dict(cache.binder.binds),
            "launches": launches, "evict": evidence, "session_s": session_s}


def storm_run(seed, n_queues, device, flavor="host"):
    """One session of ``STORM_CONF`` on ``storm_spec(seed, n_queues)``
    (``evict_session``)."""
    return evict_session(spec_cluster(storm_spec(seed, n_queues)), STORM_CONF, device, flavor)


def saturated_storm_run(device, flavor):
    """The JAX bench's own storm, ``PreemptStormConfig()``: 32 saturated
    nodes, 256 filler pods in gangs of 8 with minMember 4, and its 96
    SLA-tiered arrivals, through ``PREEMPT_CONF`` (allocate, preempt)
    (``evict_session``)."""
    from scheduler_tpu_torch.harness import preempt_storm

    cfg = preempt_storm.PreemptStormConfig()
    cache = preempt_storm.seed_saturated_cache(cfg)
    preempt_storm.add_storm(cache, cfg)
    return evict_session(cache, preempt_storm.PREEMPT_CONF, device, flavor)


def evict_summary(evidence):
    """The engine's counters and phase split, by kind, for a JSON line."""
    return {kind: {**{k: stats.get(k) for k in EVICT_COUNTERS}, "phase": stats.get("phase")}
            for kind, stats in (evidence or {}).items()}


def phase_preempt_storms():
    """The preempt phase: every ``STORM_CASES`` storm through reclaim and
    preempt on the card and on the CPU, in each flavor of the victim hunt
    (``SCHEDULER_TORCH_EVICT``); then the JAX bench's saturated storm
    (``saturated_storm_run``) in both flavors on the card and in the device
    flavor on the CPU.  Evictions (in commit order), statuses and binds
    must be equal: the card's device flavor to its host flavor and to the
    CPU's device flavor (and the card's host flavor to the CPU's), with
    the engine engaged for every kind.  Returns the card's launches
    summed."""
    total = {}
    keys = ("evictions", "statuses", "binds")

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    runs = [(f"storm seed {seed}, {n_queues} queues", ("reclaim", "preempt"),
             lambda dev, fl, seed=seed, q=n_queues: storm_run(seed, q, dev, fl),
             {"seed": seed, "queues": n_queues}) for seed, n_queues in STORM_CASES]
    runs.append(("the saturated storm", ("preempt",), saturated_storm_run,
                 {"config": "PreemptStormConfig()"}))
    for name, kinds, run, ident in runs:
        card = run(None, "host")
        card_dev = run(None, "device")
        cpu_dev = run("cpu", "device")
        check_engaged(card_dev["evict"], name, kinds)
        equal = {"device_equal_to_host": all(card_dev[k] == card[k] for k in keys),
                 "device_equal_to_cpu": all(card_dev[k] == cpu_dev[k] for k in keys)}
        if "seed" in ident:
            cpu = run("cpu", "host")
            equal["equal_to_cpu"] = all(card[k] == cpu[k] for k in keys)
        pipelined = sum(1 for _, s, _ in card["statuses"] if s == "PIPELINED")
        emit({"phase": "preempt_storm", **ident, "evictions": len(card["evictions"]),
              "evicted_by": sorted({r for _, r in card["evictions"]}),
              "pipelined": pipelined, **equal, "launches": card["launches"],
              "device_launches": card_dev["launches"],
              "session_s": {"host": card["session_s"], "device": card_dev["session_s"]},
              "evict": evict_summary(card_dev["evict"])})
        if not all(equal.values()):
            raise SystemExit(f"{name}: the runs differ: {equal}")
        if "seed" not in ident and not card["evictions"]:
            raise SystemExit(f"{name}: no evictions")
        add(card["launches"])
        add(card_dev["launches"])
    return total


# -- path o': config 4's reclaim planned by the eviction engine -------------------------

def phase_config4_reclaim_device(conf_path, host):
    """Path o': o's cluster (``harness.make_reclaim_cluster``, built anew)
    through ``reclaim, allocate`` with ``SCHEDULER_TORCH_EVICT=device``: the
    eviction engine plans every hunt (about 500 evictions at
    ``RECLAIM_O_SCALE``), then
    ``mega_allocate``.  Checks: the engine engaged; o's checks
    (``reclaim_invariants``, K2's one launch); the evictions in order, binds
    and statuses equal to the host hunt's (``host``: o's record, of the
    card or the CPU).  Prints the engine's phase split."""
    from scheduler_tpu_torch.harness import make_reclaim_cluster

    t0 = time.perf_counter()
    built = make_reclaim_cluster(RECLAIM_O_SCALE)
    emit({"phase": "cluster", "config": "config4_reclaim_device", "nodes": built.n_nodes,
          "pods": built.n_pods, "build_s": time.perf_counter() - t0})
    with env_flag("SCHEDULER_TORCH_EVICT", "device"):
        rec, launches, outcome, wrong = reclaim_cycle(built.cache, conf_path, None)
    check_engaged(rec["evict"], "path o'", ("reclaim",))
    equal = {k: outcome[k] == host["outcome"][k] for k in outcome}
    emit({"phase": "main_path", "config": "config4_reclaim_device", "launches": launches,
          **rec, "equal_to_host_hunt": equal, "engine": evict_summary(rec["evict"])})
    if rec["evictions"] < 1 or rec["pipelined_by_reclaim"] < 1:
        wrong.append(f"reclaim evicted {rec['evictions']}, pipelined "
                     f"{rec['pipelined_by_reclaim']}")
    if launches["mega_allocate"] != 1 or rec["engine"] != "mega" or launches["qfair_solve"] < 1:
        wrong.append(f"allocate after reclaim: engine {rec['engine']}, launches {launches}")
    if not all(equal.values()):
        wrong.append(f"the device hunt differs from o's host hunt: {equal}")
    if wrong:
        raise SystemExit(f"path o': {'; '.join(wrong[:5])}")
    return {"launches": launches, "record": rec, "outcome": outcome}


# -- path p: the backfill wave --------------------------------------------------------

BACKFILL_EIGHTH = {"nodes": 256, "wave_pods": 2500}


class MaskCapture:
    """Within the block, keeps the snapshot tensors and class
    representatives of every ``BackfillEngine`` class mask built."""

    def __enter__(self):
        from scheduler_tpu_torch.ops.backfill import BackfillEngine

        self.calls = []
        self.orig = orig = BackfillEngine._task_mask

        def capture(engine, st, rep_rows):
            self.calls.append((st, rep_rows))
            return orig(engine, st, rep_rows)

        BackfillEngine._task_mask = capture
        return self

    def __exit__(self, *exc):
        from scheduler_tpu_torch.ops.backfill import BackfillEngine

        BackfillEngine._task_mask = self.orig


def backfill_cycle(cache, conf_path, device, flavor):
    """One ``Scheduler.run_once`` of ``conf_path`` on ``cache`` under
    backfill's ``flavor`` (``SCHEDULER_TORCH_BACKFILL``) on ``device``
    (None: the card), reading the session after backfill: the FitErrors
    strings of the tasks left pending, each node's pods against its limit,
    the zone of every pinned pod's node.  Returns (record, launches,
    outcome, problems)."""
    import torch

    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils import phases

    seen = {}
    sched = Scheduler(cache, scheduler_conf=conf_path, device=device)
    sched._load_conf()
    for action in sched.actions:
        def execute(ssn, run=action.execute, name=action.name()):
            run(ssn)
            if name != "backfill":
                return
            wrong, fes, pending = [], {}, 0
            for node in ssn.nodes.values():
                if len(node.tasks) > node.pods_limit:
                    wrong.append(f"{node.name}: {len(node.tasks)} pods past {node.pods_limit}")
            for job in ssn.jobs.values():
                for t in job.tasks.values():
                    zone = t.pod.node_selector.get("zone") if t.pod is not None else None
                    if t.node_name and zone is not None and \
                            ssn.nodes[t.node_name].node.labels.get("zone") != zone:
                        wrong.append(f"{t.name} on {t.node_name} outside zone {zone}")
                    if t.status.name == "PENDING":
                        pending += 1
                        if t.uid in job.nodes_fit_errors:
                            fes[t.name] = job.nodes_fit_errors[t.uid].error()
            seen.update(wrong=wrong, fit_errors=fes, pending=pending)

        action.execute = execute
    with env_flag("SCHEDULER_TORCH_BACKFILL", flavor):
        reset_counts()
        phases.begin()
        t0 = time.perf_counter()
        sched.run_once()
        if device is None:
            torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        notes = phases.take_notes()
        spent = phases.end()
        launches, _ = read_counts()
    rec = {"cycle_s": cycle_s, "phases_s": spent, "binds": len(cache.binder.binds),
           "pending": seen["pending"], "with_fit_errors": len(seen["fit_errors"]),
           "backfill": notes.get("backfill")}
    outcome = {"binds": dict(cache.binder.binds), "fit_errors": seen["fit_errors"]}
    return rec, launches, outcome, seen["wrong"]


def phase_backfill_wave(conf_path):
    """Path p: the JAX bench's backfill wave, ``BackfillWaveConfig()``
    at half its size (``BACKFILL_WAVE``: 1,024 nodes of pod limit 22 with 14
    running pods each; 10,000
    BestEffort pods, every third one zone-pinned, seed 0) through
    ``BACKFILL_CONF`` with ``SCHEDULER_TORCH_BACKFILL=device``: one cycle on
    a fresh cache, so the predicates' mask memo is empty and K3 builds the
    class rows.  Checks: the engine engaged on its 5 classes, 8,192 binds
    (the room), no node past its pod limit, every pinned pod in its zone,
    1,808 pods left pending, each with a FitErrors, K3 launched.  Then K3 on
    the wave's signature operands against its plain version (bitwise,
    timed), and the two flavors on an eighth of the wave (256 nodes, 2,500
    pods, the same seed and shape) on the card: binds, FitErrors strings
    and the evidence counters equal."""
    import torch

    from scheduler_tpu_torch.harness.backfill_wave import BackfillWaveConfig, seed_wave_cache

    cfg = BackfillWaveConfig(**BACKFILL_WAVE)
    t0 = time.perf_counter()
    cache = seed_wave_cache(cfg)
    emit({"phase": "cluster", "config": "backfill_wave", "nodes": cfg.nodes,
          "pods": cfg.nodes * cfg.fill_per_node + cfg.wave_pods,
          "build_s": time.perf_counter() - t0})
    with MaskCapture() as cap:
        rec, launches, _, wrong = backfill_cycle(cache, conf_path, None, "device")
    bf = rec["backfill"] or {}
    emit({"phase": "main_path", "config": "backfill_wave", "launches": launches, **rec})
    if not bf.get("engaged"):
        raise SystemExit(f"path p: the backfill engine did not engage: "
                         f"{bf.get('reason', 'no evidence')}")
    unplaced = cfg.wave_pods - cfg.capacity
    if rec["binds"] != cfg.capacity or rec["pending"] != unplaced or \
            rec["with_fit_errors"] != unplaced:
        wrong.append(f"binds {rec['binds']}, pending {rec['pending']}, with FitErrors "
                     f"{rec['with_fit_errors']} (want {cfg.capacity}, {unplaced}, {unplaced})")
    if bf.get("classes") != 5 or bf.get("unplaceable") != unplaced:
        wrong.append(f"classes {bf.get('classes')}, unplaceable {bf.get('unplaceable')}")
    if launches["static_predicate_mask"] < 1 or len(cap.calls) != 1:
        wrong.append(f"K3 launches {launches['static_predicate_mask']}, class masks "
                     f"{len(cap.calls)}")
    if wrong:
        raise SystemExit(f"path p: {'; '.join(wrong[:5])}")
    st, rep_rows = cap.calls[0]
    k3 = compare_predicate("backfill_wave_main_path_operands",
                           predicate_operands(st, torch.device("cuda")), timed=True)
    del cache, cap, st
    gc.collect()
    # The two flavors on an eighth of the wave, on the card.
    small = {}
    for flavor in ("host", "device"):
        c = seed_wave_cache(BackfillWaveConfig(**BACKFILL_EIGHTH))
        r, l, o, w = backfill_cycle(c, conf_path, None, flavor)
        if w:
            raise SystemExit(f"path p, an eighth, {flavor}: {'; '.join(w[:5])}")
        b = r["backfill"] or {}
        counters = {"tasks": b.get("tasks"), "unplaceable": b.get("unplaceable"),
                    "binds": (b.get("device_binds") or 0) + (b.get("host_binds") or 0)}
        small[flavor] = {"outcome": o, "counters": counters, "record": r, "launches": l}
    equal = {"binds": small["device"]["outcome"]["binds"] == small["host"]["outcome"]["binds"],
             "fit_errors": small["device"]["outcome"]["fit_errors"]
             == small["host"]["outcome"]["fit_errors"],
             "counters": small["device"]["counters"] == small["host"]["counters"]}
    emit({"phase": "backfill_flavors", "config": "backfill_wave_eighth", **BACKFILL_EIGHTH,
          **equal, "counters": small["device"]["counters"],
          "cycle_s": {f: small[f]["record"]["cycle_s"] for f in small},
          "backfill_s": {f: small[f]["record"]["phases_s"].get("backfill") for f in small},
          "predicate_calls_host": {f: (small[f]["record"]["backfill"] or {}).get(
              "predicate_calls_host") for f in small},
          "device_launches": small["device"]["launches"]})
    if not all(equal.values()):
        raise SystemExit(f"path p, an eighth: the flavors differ: {equal}")
    return {"launches": launches, "record": rec, "k3": k3,
            "eighth_launches": small["device"]["launches"]}


class LaunchTimer:
    """Within the block, CUDA events around every launch of K3's kernel
    (``predicate_kernel._launch``, its C entry point resolved beforehand, so
    that the first launch's events hold no symbol lookup); ``ms()`` is
    their summed time."""

    def __enter__(self):
        from scheduler_tpu_torch.ops import predicate_kernel as pk

        pk._entry()
        self.pairs = []
        self.orig = orig = pk._launch

        def timed(*args):
            import torch

            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = orig(*args)
            stop.record()
            self.pairs.append((start, stop))
            return out

        pk._launch = timed
        return self

    def __exit__(self, *exc):
        from scheduler_tpu_torch.ops import predicate_kernel as pk

        pk._launch = self.orig

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class _NoTimer:
    """``LaunchTimer``'s stand-in where no kernel launches (the CPU)."""

    pairs = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def daemon_config2(n_nodes, n_pods, work_dir, device=None, limit_s=300.0):
    """Path q: BASELINE config 2 (``kubemark_density_documents``: 1,000
    nodes x 5,000 bare pods at full size, half of them selecting a zone) in
    the port's mock API server, a process of its own, in ``kubectl``
    shapes; then the daemon, ``scheduler_tpu_torch.cli.main`` in this
    thread, with ``--api-server``, the default k8s wires in and out (one
    bind POST a pod), ``--device`` left at its CUDA default (``device``:
    the tests' ``cpu``), a 0.5 s schedule period and config 2's conf.  A
    watcher thread polls the server until every pod carries a node (or
    ``limit_s`` runs out, which fails the path), reads the daemon's
    ``/healthz``, ``/metrics`` and ``/debug/cycles`` once, and sends SIGTERM
    to this process: ``main`` must return.  Then the same documents, in the
    server's LIST order, preloaded through ``cli.load_cluster_state`` into
    a cache of this process, and one ``Scheduler.run_once`` on the same
    device: its binds must be the daemon's, pod for pod, and pass config
    2's checks (``check_config2_binds``).  Both caches stamp shadow
    PodGroups under one ``ObjectClock``.  Returns the record."""
    import signal
    import threading

    import scheduler_tpu_torch.apis.objects as objects_mod
    from scheduler_tpu_torch import cli
    from scheduler_tpu_torch.cache.cache import SchedulerCache
    from scheduler_tpu_torch.harness import kubemark_density_documents
    from scheduler_tpu_torch.harness.wire_rig import (
        ObjectClock, free_port, http_json, post_documents, server_node_name,
        spawn_mock_server)
    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils import obs

    docs = kubemark_density_documents(n_nodes, n_pods)
    conf_path = os.path.join(work_dir, "daemon_config2_conf.yaml")
    with open(conf_path, "w") as f:
        f.write(CONFIG2_CONF)
    proc, base = spawn_mock_server()
    try:
        t0 = time.perf_counter()
        post_documents(base, docs, threads=8)
        seed_s = time.perf_counter() - t0
        listed = http_json(base, "/state")  # the server's LIST order
        port = free_port()
        watched = {"polls": 0}

        def watch():
            deadline = time.perf_counter() + limit_s
            try:
                # The bind log is the cheap poll (a /state read serializes
                # the whole store under the server's lock); the store
                # confirms once.
                while time.perf_counter() < deadline:
                    if len(http_json(base, "/bind-log")["binds"]) >= n_pods:
                        watched["all_bound_s"] = time.perf_counter() - t_start
                        pods = http_json(base, "/state")["pods"]
                        watched["polls"] += 1
                        if all(server_node_name(p) for p in pods):
                            break
                    time.sleep(0.25)
                else:
                    watched["timeout"] = True
                daemon = f"http://127.0.0.1:{port}"
                import urllib.request

                with urllib.request.urlopen(daemon + "/healthz", timeout=10) as resp:
                    watched["healthz"] = resp.read().decode()
                with urllib.request.urlopen(daemon + "/metrics", timeout=30) as resp:
                    watched["metrics"] = resp.read().decode()
                watched["cycles"] = http_json(daemon, "/debug/cycles")["cycles"]
            except Exception as exc:  # reported below; the daemon must stop all the same
                watched["error"] = repr(exc)
            finally:
                # Only once main's handler is in place (a SIGTERM before it,
                # or after main has restored ours, is a no-op).
                while signal.getsignal(signal.SIGTERM) is ignore and not done.is_set():
                    time.sleep(0.05)
                os.kill(os.getpid(), signal.SIGTERM)

        argv = ["--api-server", base, "--scheduler-conf", conf_path,
                "--schedule-period", "0.5", "--listen-address", f"127.0.0.1:{port}"]
        if device is not None:
            argv += ["--device", str(device)]
        obs.reset()
        reset_counts()
        done = threading.Event()

        def ignore(signum, frame):
            pass

        watcher = threading.Thread(target=watch, name="daemon-watcher", daemon=True)
        previous = signal.signal(signal.SIGTERM, ignore)
        try:
            with ObjectClock(objects_mod), LaunchTimer() if device is None else \
                _NoTimer() as k3_timer:
                t_start, t_wall = time.perf_counter(), time.time()
                watcher.start()
                try:
                    cli.main(argv)
                finally:
                    done.set()
                main_s = time.perf_counter() - t_start
            watcher.join(timeout=60)
        finally:
            signal.signal(signal.SIGTERM, previous)
        launches, routes = read_counts()
        k3_ms = k3_timer.ms() if device is None and k3_timer.pairs else None
        stats = http_json(base, "/stats")
        daemon_binds = {b["pod"]: b["node"] for b in http_json(base, "/bind-log")["binds"]}
        applied = len(http_json(base, "/bind-log")["binds"])
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    if watched.get("timeout") or "error" in watched:
        raise SystemExit(f"path q: not every pod bound in {limit_s} s "
                         f"({watched.get('error', 'timeout')})")
    cycles = watched["cycles"]
    first = cycles[0] if cycles else {}
    k2_ms = [((c.get("notes") or {}).get("cohort") or {}).get("kernel_ms") for c in cycles]
    metrics_ok = "volcano_binds_total" in watched["metrics"] and \
        "volcano_e2e_scheduling_latency_milliseconds" in watched["metrics"]
    # The twin: the same documents, preloaded in the server's LIST order.
    state_path = os.path.join(work_dir, "daemon_config2_state.json")
    with open(state_path, "w") as f:
        json.dump({k: listed[k] for k in ("queues", "nodes", "podGroups", "pods")}, f)
    twin = SchedulerCache(async_io=False)
    with ObjectClock(objects_mod):
        cli.load_cluster_state(twin, state_path)
    Scheduler(twin, conf_path, device=device).run_once()
    twin_binds = dict(twin.binder.binds)
    n_binds, most = check_config2_binds(twin)
    rec = {"nodes": n_nodes, "pods": n_pods, "seed_s": seed_s,
           "sync_s": first["ts"] - t_wall if first else None,
           "first_cycle_s": first.get("s"), "first_cycle_phases": first.get("phases"),
           "cycles": len(cycles), "all_bound_s": watched["all_bound_s"], "main_s": main_s,
           "bind_posts": stats["bind_calls"], "binds_applied": applied,
           "retries": stats["bind_calls"] - applied, "resync_gets": stats["get_calls"],
           # The LISTs and relists the daemon paid (the watcher's polls and
           # the twin's LIST are /state reads too).
           "lists": stats["list_calls"] - watched["polls"] - 1, "k8s_calls": stats["k8s_calls"],
           "legacy_calls": stats["legacy_calls"], "launches": launches, "routes": routes,
           "k3_ms": k3_ms, "k2_ms": [ms for ms in k2_ms if ms is not None],
           "healthz": watched["healthz"], "metrics_families_ok": metrics_ok,
           "binds": len(daemon_binds), "twin_binds": n_binds,
           "most_pods_on_a_node": most, "equal_to_twin": daemon_binds == twin_binds}
    wrong = []
    if len(daemon_binds) != n_pods:
        wrong.append(f"{len(daemon_binds)} of {n_pods} pods bound")
    if not rec["equal_to_twin"]:
        differ = sum(1 for k in set(daemon_binds) | set(twin_binds)
                     if daemon_binds.get(k) != twin_binds.get(k))
        wrong.append(f"{differ} binds differ from the preloaded run_once's")
    if device is None and (launches["static_predicate_mask"] < 1
                           or launches["mega_allocate"] < 1):
        wrong.append(f"launches {launches}")
    if watched["healthz"] != "ok" or not metrics_ok:
        wrong.append("the daemon's /healthz or /metrics did not answer as expected")
    if stats["k8s_calls"] < n_pods or stats["legacy_calls"]:
        wrong.append(f"the binds did not cross as k8s calls: {stats}")
    if wrong:
        raise SystemExit(f"path q: {'; '.join(wrong)}")
    return rec


# Path q': the churn rig on a 1,000-node cluster.  The arrival rate is 1,000
# a second, the highest that drains: the rig runs its mock server, replay,
# reflectors and scheduler in one interpreter, and at 2,000 its replay falls
# behind its own history and the scheduler does not drain
# (``scripts/churn_rates.py``).
CHURN_CARD = dict(seed=0, nodes=1000, placed_pods=10_000, tasks_per_job=50, pending_pods=32,
                  lanes=16, rate=1000.0, duration_s=8.0, warm_s=1.5, burst_every_s=2.0,
                  burst_len_s=0.25, burst_factor=4.0)


def phase_churn(cfg_kw=None, device=None):
    """Path q': ``harness.churn.run_churn_bench`` with the port's daemon
    loop on ``device`` (None: the card): the event trigger, the k8s
    LIST+WATCH wire in, the batched legacy dialect out (the JAX churn
    bench's), ``CHURN_CONF`` (K2 in cursor mode through the engine cache
    each cycle), at ``CHURN_CARD``.  Checks: cycles measured, the scheduler
    drained, the server's store (``wire_rig.churn_state``).  Returns the record."""
    from scheduler_tpu_torch.connector.mock_server import MockState
    from scheduler_tpu_torch.harness.churn import ChurnConfig, run_churn_bench
    from scheduler_tpu_torch.harness.wire_rig import churn_state

    cfg = ChurnConfig(**(cfg_kw or CHURN_CARD))
    state = MockState()
    reset_counts()
    t0 = time.perf_counter()
    doc = run_churn_bench(cfg, wire="k8s", device=device, state=state)
    wall_s = time.perf_counter() - t0
    launches, routes = read_counts()
    d = doc["detail"]
    if not d["cycles_measured"]:
        raise SystemExit("path q': the scheduler never drained the measured traffic")
    if device is None and launches["mega_allocate"] < 1:
        raise SystemExit(f"path q': mega_allocate was not launched: {launches}")
    faults, bound, pending = churn_state(state)
    if faults:
        raise SystemExit(f"path q': {'; '.join(faults)}")
    return {"wall_s": wall_s, "p50_ms": d["p50_ms"], "p99_ms": d["p99_ms"],
            "max_ms": d["max_ms"], "rate_target": d["rate_target"],
            "rate_sustained": d["rate_sustained"], "replay": d["replay"],
            "cycles_measured": d["cycles_measured"], "events_per_cycle": d["events_per_cycle"],
            "fallback_cycles": d["fallback_cycles"], "engine_cache": d["engine_cache"],
            "hit_rate": d["hit_rate"], "dirty": d["dirty"], "trigger": d["trigger"],
            "ingest": d["ingest"], "launches": launches, "routes": routes,
            "server_bound": bound, "server_pending": pending}


def place_scan_entry(launches_by_path, scan, small):
    """place_scan's entry of the kernels line (no TPU Pallas kernel: it
    replaces the JAX package's XLA scan): launches on each path that runs
    it, its error against the plain version on path n's first pops, its
    time a pop and launch plan on path n's operands, and the same on path
    n''s (``small``)."""
    keys = ("nodes", "pop_tasks", "scanned_tasks", "plan", "ms", "event_ms", "device_ms",
            "us_per_task", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "checked_pops")
    return {"name": "place_scan", "route": "cuda",
            "source": "scheduler_tpu_torch/csrc/place_scan.cu",
            "replaces": "scheduler_tpu/ops/placement.py:71-137",
            "launches": launches_by_path["production_conf"],
            "launches_by_path": launches_by_path,
            "max_abs_err": max(scan["max_abs_err"], small["max_abs_err"]),
            "checked_pops": scan["checked_pops"], "checked_tasks": scan["checked_tasks"],
            "nodes": scan["nodes"], "pop_tasks": scan["pop_tasks"], "plan": scan["plan"],
            "ms": scan["ms"], "event_ms": scan["event_ms"], "device_ms": scan["device_ms"],
            "us_per_task": scan["us_per_task"], "plain_ms": scan["plain_ms"],
            "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"], "library_ms": None,
            "config2_default_tiers_device": {k: small[k] for k in keys}}


def lp_entry(lp_paths):
    """lp_relax's entry of the kernels line (no TPU Pallas kernel: it
    replaces the JAX package's XLA iteration): launches on paths r and r',
    its error against the plain version on each path's own operands and on
    the tight operands at r''s shape (the largest of the three, absolute
    and over the limit, on top; each path's below), and r''s plan and
    times (a solve, an iteration, the profiler's device time and count of
    kernel launches a solve) beside its bound, the plain version's and
    ``torch.matmul``'s for the load product; r's below."""
    keys = ("rows", "n", "cols", "iters", "plan", "kernel_launches", "ms", "iteration_ms",
            "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "iteration_bytes_ms", "max_abs_err", "over_tol")
    main, flag = lp_paths["r'"]["kernel"], lp_paths["r"]["kernel"]
    tight = lp_paths["r'_tight"]["kernel"]
    return {"name": "lp_relax", "route": "cuda",
            "source": "scheduler_tpu_torch/csrc/lp_relax.cu",
            "replaces": "scheduler_tpu/ops/lp_place.py:212-265",
            "launches": lp_paths["r'"]["launches"]["lp_relax"],
            "launches_by_path": {"config2_lp": lp_paths["r'"]["launches"]["lp_relax"],
                                 "config3_lp": lp_paths["r"]["launches"]["lp_relax"]},
            **{k: main[k] for k in keys[3:]},
            "max_abs_err": max(main["max_abs_err"], flag["max_abs_err"], tight["max_abs_err"]),
            "over_tol": max(main["over_tol"], flag["over_tol"], tight["over_tol"]),
            "rtol": LP_KERNEL_RTOL, "atol": LP_KERNEL_ATOL,
            "rows": main["rows"], "n": main["n"], "cols": main["cols"],
            "config3_lp": {k: flag[k] for k in keys},
            "config2_lp_tight": {**{k: tight[k] for k in keys}, "evidence": tight["evidence"],
                                 "faults_over_tol": tight["faults_over_tol"]}}


# -- paths s-v: the node mesh on the one card ------------------------------------------
#
# The node mesh (ops/mesh.py) over MESH_SHARDS copies of the one card: the
# shards are real node blocks with real offsets and the real merge, but they
# share the card, so their times are not those of MESH_SHARDS cards.  Each
# path runs on a fresh cluster built as the path it shadows, first on one
# device (the engine alone, nothing committed), then on the mesh through
# ``Scheduler.run_once``; the codes must be equal.

MESH_SHARDS = 4
MESH_CHECK_EVERY = 200


def mesh_of(shards, spec=None):
    """The port's mesh of ``shards`` copies of the card (``spec``: the 2-D
    spec; default 1-D), built as ``get_mesh`` builds it."""
    import torch

    from scheduler_tpu_torch.ops import mesh as M

    shape = {"nodes": shards}
    if spec and "x" in spec:
        r, c = M.parse_2d_spec(spec)
        shape = {"replica": r, "nodes": c}
    return M.NodeMesh([torch.device("cuda", 0)] * shards, shape)


def mesh_set(spec):
    """``SCHEDULER_TORCH_MESH=spec`` over ``MESH_SHARDS`` copies of the card;
    the mesh ``get_mesh`` then gives (None for ``1``).  A spec that degrades
    fails the run."""
    import torch

    from scheduler_tpu_torch.ops import mesh as M

    os.environ["SCHEDULER_TORCH_MESH"] = spec
    M.set_mesh_devices([torch.device("cuda", 0)] * MESH_SHARDS)
    mesh = M.get_mesh()
    if spec != "1" and (mesh is None or mesh.size != MESH_SHARDS):
        raise SystemExit(f"mesh {spec}: got {mesh} over {MESH_SHARDS} copies of the card")
    return mesh


def check_mesh_engine(eng, path, spec):
    """The engine ran on the mesh ``spec``: ``_mesh`` engaged, its topology
    ``MESH_SHARDS`` devices, the node operands split.  Returns the
    topology."""
    from scheduler_tpu_torch.ops.mesh import mesh_topology

    if eng is None or eng._mesh is None:
        raise SystemExit(f"path {path}: the engine ran without the mesh {spec}")
    topo = mesh_topology(eng._mesh)
    stats = eng.run_stats().get("mesh") or {}
    if topo["devices"] != MESH_SHARDS or topo["spec"] != spec or not stats.get("sharded"):
        raise SystemExit(f"path {path}: the mesh is {topo}, {stats}")
    return topo


def engine_codes(cache, conf_text, engine, check_every=0):
    """The fused engine on a session of ``cache`` on the card (nothing is
    committed; the session is closed after): ``(codes, run_stats, the
    engine)``.  The engine must choose ``engine``; with ``check_every`` its
    loop holds its arm to the plain version at every ``check_every``-th
    step (``fused_allocate``'s check)."""
    import torch

    from scheduler_tpu_torch.framework import close_session
    from scheduler_tpu_torch.ops import fused as fused_mod

    ssn, eng = engine_for(cache, conf_text, torch.device("cuda"), engine)
    if check_every:
        codes, stats = fused_mod.fused_allocate(*eng.args, **eng._allocate_kw(),
                                                check_every=check_every)
        codes = codes.numpy()[:eng.flat_count]
        if stats["checked"] < 10:
            raise SystemExit(f"only {stats['checked']} loop steps were checked")
    else:
        codes = eng.readback().copy()[:eng.flat_count]
        stats = eng.run_stats()
    close_session(ssn)
    return codes, stats, eng


def codes_equal(path, spec, got, want):
    import numpy as np

    equal = got is not None and got.shape == want.shape and bool(np.array_equal(got, want))
    placed = int(((want >= 0) | (want <= -3)).sum())
    emit({"phase": "mesh_parity", "path": path, "spec": spec, "tasks": int(want.shape[0]),
          "placed": placed, "equal": equal})
    if not equal:
        raise SystemExit(f"path {path}: the codes on mesh {spec} differ from one device's")
    if placed < 1:
        raise SystemExit(f"path {path}: nothing placed")
    return placed


def mesh_path_s(opts, conf_path):
    """Path s: b on the mesh, K2 in mesh mode (one launch, every operand
    whole on the first device): a cold cycle's codes equal one device's on
    the same cluster, 100,000 binds (K2's mesh mode is timed on b's
    operands in ``phase_full_size`` and held to its plain version in
    ``full_size_plain``)."""
    import gc as _gc

    cache = full_size_cluster("config3", opts)
    mesh_set("1")
    single, _, _ = engine_codes(cache, FLAGSHIP_CONF, "mega")
    _gc.collect()
    spec = str(MESH_SHARDS)
    mesh_set(spec)
    with open(conf_path, "w") as f:
        f.write(FLAGSHIP_CONF)
    with ReadbackSpy() as spy:
        rec, launches = run_cycle(cache, conf_path)
    topo = check_mesh_engine(spy.engine, "s", spec)
    codes_equal("s", spec, spy.codes[:spy.engine.flat_count], single)
    binds, gangs = check_binds(cache, opts.nodes, opts.pods, opts.tasks_per_job)
    digest = binds_digest(cache.binder.binds)
    emit({"phase": "main_path", "config": "config3_mesh", "path": "s", "mesh": topo,
          "binds": binds, "gangs_bound": gangs, "binds_digest": digest, **rec})
    return {"launches": launches, "binds": binds, "digest": digest, "mesh": topo}


def mesh_path_t(opts, conf_path):
    """Path t: c on the mesh, K1 on every shard: the loop on 2x2 (held to
    K1's plain version at every ``MESH_CHECK_EVERY``-th step, each shard)
    and a cold cycle on 4, both equal to one device's codes (K1 on a
    shard's block is timed in ``phase_step_kernel_cases``)."""
    cache = template_cluster(opts.nodes, opts.template_jobs, opts.template_tasks)
    mesh_set("1")
    single, _, _ = engine_codes(cache, FLAGSHIP_CONF, "step")
    out = {}
    mesh_set("2x2")
    codes, stats, eng = engine_codes(cache, FLAGSHIP_CONF, "step", MESH_CHECK_EVERY)
    check_mesh_engine(eng, "t", "2x2")
    codes_equal("t", "2x2", codes, single)
    out["check"] = {"spec": "2x2", "steps": stats["steps"], "checked_steps": stats["checked"],
                    "shards": stats["shards"]}
    del eng
    spec = str(MESH_SHARDS)
    mesh_set(spec)
    with open(conf_path, "w") as f:
        f.write(FLAGSHIP_CONF)
    with ReadbackSpy() as spy:
        rec, launches = run_cycle(cache, conf_path, engine="step", shards=MESH_SHARDS)
    out["mesh"] = check_mesh_engine(spy.engine, "t", spec)
    codes_equal("t", spec, spy.codes[:spy.engine.flat_count], single)
    binds, gangs = check_binds(cache, opts.nodes, opts.template_jobs * opts.template_tasks,
                               opts.template_tasks,
                               request_fn=job_template_request(opts.template_jobs))
    emit({"phase": "main_path", "config": "config3_templates_mesh", "path": "t",
          "binds": binds, "gangs_bound": gangs, **rec})
    out.update(launches=launches, binds=binds, steps=rec["steps"])
    return out


def k1_shard_record(eng):
    """K1 on one shard's block: the first step of a loop engine's operands
    cut to the first of ``MESH_SHARDS`` node blocks (``compare_step``)."""
    ops, kw = loop_step_operands(eng)
    n = ops[0].shape[1]
    n_local = n // MESH_SHARDS
    shard = tuple(o[:, :n_local].contiguous() if o.shape[1] == n else o for o in ops)
    return compare_step("config3_templates_shard0_first_step", shard, kw)


def xla_shard_operands():
    """Operands at path i's shape (1,024 nodes, cpu and memory) for the XLA
    arm's shard mode: ``xla_step_operands`` with requests a sixteenth, so
    that a step places a batch."""
    import numpy as np

    ops = xla_step_operands(0, 1024, 2)
    ops["resreq"][:, :2] = ops["init_resreq"][:, :2] = np.floor(ops["resreq"][:, :2] / 16)
    return ops


def xla_shard_record(case, ops, flags, repeats=64, plain_repeats=10):
    """The XLA arm's shard mode on ``xla_step_operands``-style arrays over
    ``MESH_SHARDS`` copies of the card: the first step of every shard held
    to its plain version (candidate and node block, bitwise), then the
    device time a launch (profiler, ``repeats`` steps of every shard), the
    plain version's time a shard launch (events), and the bound of one
    shard's step (its block's bytes and its candidate)."""
    import torch

    from scheduler_tpu_torch.ops import xla_step as xs

    hi0 = 128
    arm = xla_shard_arm_on(ops, flags, mesh_of(MESH_SHARDS), check_every=1)
    try:
        first = arm.step(0, 0, hi0)
        arm.check_every = 0
        ms, _ = device_ms_per_call(lambda: arm.step(0, 0, hi0), repeats,
                                   match="xla_shard_kernel")
        sh = arm.shards[0]
        start, stop = events()
        start.record()
        for _ in range(plain_repeats):
            arm._plain(sh, sh.node_state.clone(), 0, 0, hi0, None)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop) / plain_repeats
    finally:
        arm.close()
    nbytes = (xla_step_bytes(arm.n_local, arm.r_dim, flags["use_static"],
                             flags["enforce_pod_count"]) + 4 * xs.SHARD_CAND.WORDS)
    rec = {"phase": "kernel_vs_plain", "kernel": "xla_step_shard", "case": case,
           "n": arm.n, "n_local": arm.n_local, "shards": len(arm.shards),
           "result": list(first), "checked": arm.checked, "max_abs_err": 0.0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "bound_by": "bytes", "bytes": nbytes, "plan": arm.plan.describe()}
    emit(rec)
    return rec


def mesh_path_u(opts, conf_path):
    """Path u: i's and k's loops (the XLA arm, k's with releasing capacity)
    on the mesh, the arm's shard mode: each loop held to the plain version
    at every ``MESH_CHECK_EVERY``-th step (candidates and node blocks,
    bitwise), then a cold cycle whose codes equal one device's."""
    import gc as _gc

    from scheduler_tpu_torch.harness import make_reclaim_aftermath_cluster

    out = {"launches": {}, "checks": {}}
    spec = str(MESH_SHARDS)
    for path, build, conf_text in (
            ("templates_default_tiers", lambda: template_cluster(*TIERS_TEMPLATES),
             DEFAULT_TIERS_CONF),
            ("reclaim_aftermath_templates", lambda: make_reclaim_aftermath_cluster(
                RECLAIM_TEMPLATES_SCALE, thin_requests=RECLAIM_THIN_REQUESTS).cache,
             RECLAIM_CONF)):
        cache = build()
        mesh_set("1")
        single, _, _ = engine_codes(cache, conf_text, "xla")
        mesh_set(spec)
        codes, stats, eng = engine_codes(cache, conf_text, "xla", MESH_CHECK_EVERY)
        check_mesh_engine(eng, "u", spec)
        codes_equal(f"u:{path}", spec, codes, single)
        out["checks"][path] = {"steps": stats["steps"], "checked_steps": stats["checked"]}
        del eng
        with open(conf_path, "w") as f:
            f.write(conf_text)
        with ReadbackSpy() as spy:
            rec, launches = run_cycle(cache, conf_path, engine="xla", shards=MESH_SHARDS)
        check_mesh_engine(spy.engine, "u", spec)
        codes_equal(f"u:{path}", spec, spy.codes[:spy.engine.flat_count], single)
        emit({"phase": "main_path", "config": f"{path}_mesh", "path": "u",
              "pipelined": int((single <= -3).sum()), **rec})
        if path == "reclaim_aftermath_templates" and not (single <= -3).any():
            raise SystemExit("path u: k's loop pipelined nothing")
        out["launches"][path] = launches
        del cache, spy
        _gc.collect()
    return out


class LpBlocksCapture:
    """Within the ``with`` block, keeps a copy of every
    ``lp_iterate_blocks`` call's operands (``calls``: logits blocks, cap
    blocks, req_aug, iters, tol)."""

    def __enter__(self):
        from scheduler_tpu_torch.ops import lp_place

        self.mod, self.orig = lp_place, lp_place.lp_iterate_blocks
        self.calls = []

        def capture(logits_b, cap_b, req_aug, *, iters, tol, plain=False, orig=self.orig):
            self.calls.append(([x.clone() for x in logits_b], [c.clone() for c in cap_b],
                               req_aug.clone(), iters, tol))
            return orig(logits_b, cap_b, req_aug, iters=iters, tol=tol, plain=plain)

        lp_place.lp_iterate_blocks = capture
        return self

    def __exit__(self, *exc):
        self.mod.lp_iterate_blocks = self.orig


def split_lp_call(call, blocks):
    """An ``LpCapture`` call's operands as ``lp_iterate_blocks`` takes them:
    the logits' and capacities' node axis cut into ``blocks`` equal
    blocks (the blocks a node mesh of that size builds from them)."""
    logits, cap, req_aug, iters, tol = call
    nl = logits.shape[1] // blocks
    return ([logits[:, k * nl:(k + 1) * nl].contiguous() for k in range(blocks)],
            [cap[k * nl:(k + 1) * nl].contiguous() for k in range(blocks)], req_aug, iters, tol)


def lp_blocks_record(path, call, repeats=3, timed=True):
    """``lp_relax`` over node blocks on a path's own operands: the kernel
    twice (bitwise equal), against its plain version over the same blocks
    and against the one-device kernel on the blocks laid side by side, the
    marginals held by ``lp_marginal_errors`` (PR 16's tolerance), pref and
    the evidence row equal.  With ``timed``: events, a solve and a launch,
    beside the plain version's solve and ``torch.matmul``'s load product;
    the plan, and the profiler's device time and its count of kernel
    launches a solve (``kernel_launches``), which must be one."""
    import torch

    from scheduler_tpu_torch.ops import lp_place

    logits_b, cap_b, req_aug, iters, tol = call
    d = len(logits_b)
    plan = lp_place.lp_plan(logits_b[0].shape[0], logits_b[0].shape[1], cap_b[0].shape[1], d,
                            lp_place.device_sms(logits_b[0].device))
    got = lp_place.lp_iterate_blocks(logits_b, cap_b, req_aug, iters=iters, tol=tol)
    again = lp_place.lp_iterate_blocks(logits_b, cap_b, req_aug, iters=iters, tol=tol)
    start, stop = events()
    start.record()
    ref = lp_place.lp_iterate_blocks(logits_b, cap_b, req_aug, iters=iters, tol=tol,
                                     plain=True)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    one = lp_place.lp_iterate(torch.cat(logits_b, dim=1).contiguous(),
                              torch.cat(cap_b, dim=0).contiguous(), req_aug, iters=iters,
                              tol=tol)
    errs = lp_marginal_errors(torch.cat(got[0], dim=1), torch.cat(ref[0], dim=1))
    errs_one = lp_marginal_errors(torch.cat(got[0], dim=1), one[0])
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got[0] + [got[1], got[2]], again[0] + [again[1], again[2]]))
    equal = torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    errs_one.update(pref_equal=bool(torch.equal(got[1], one[1])),
                    evidence_equal=bool(torch.equal(got[2], one[2])))
    if not (bitwise and equal and errs["over_tol"] <= 1.0 and errs_one["over_tol"] <= 1.0):
        raise SystemExit(f"path {path}: lp_relax over {d} blocks: bitwise {bitwise}, pref and "
                         f"evidence equal {equal}, against plain {errs}, against one device "
                         f"{errs_one}")
    x = torch.cat(got[0], dim=1)
    rows, n = x.shape
    rec = {"case": f"{path}_main_path_operands", "blocks": d, "rows": rows, "n": n,
           "cols": cap_b[0].shape[1], "iters": iters, "plan": lp_plan_record(plan),
           **errs,
           "vs_one_device": errs_one,
           "rtol": LP_KERNEL_RTOL, "atol": LP_KERNEL_ATOL, "pref_equal": True,
           "bitwise_rerun": True, "evidence": got[2].tolist()}
    if not timed:
        emit({"phase": "kernel_vs_plain", "kernel": "lp_relax_blocks", **rec})
        return rec
    start.record()
    for _ in range(repeats):
        lp_place.lp_iterate_blocks(logits_b, cap_b, req_aug, iters=iters, tol=tol)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / repeats
    device_ms, rec["kernel_launches"], rec["launch_traces"] = lp_launches_a_solve(
        lambda: lp_place.lp_iterate_blocks(logits_b, cap_b, req_aug, iters=iters, tol=tol),
        f"path {path}: lp_relax over {d} blocks")
    torch.matmul(x.T, req_aug)
    start.record()
    for _ in range(20):
        torch.matmul(x.T, req_aug)
    stop.record()
    torch.cuda.synchronize()
    rec.update(ms=ms, iteration_ms=ms / iters, device_ms=device_ms, plain_ms=plain_ms,
               library_ms=start.elapsed_time(stop) / 20,
               library="torch.matmul(x.T, req_aug), one iteration's load product",
               **lp_bound_ms(rows, n, cap_b[0].shape[1], iters))
    emit({"phase": "kernel_vs_plain", "kernel": "lp_relax_blocks", **rec})
    return rec


def mesh_path_v(opts, conf_path):
    """Path v: r' on the mesh, the LP relaxation over node blocks and its
    repair on the XLA arm's shard mode: a cold cycle's codes equal one
    device's, and the block solve held to its plain version and to the
    one-device kernel (timed on r''s operands in ``phase_lp_paths``)."""
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster

    os.environ["SCHEDULER_TORCH_ALLOCATOR"] = "lp"
    os.environ["SCHEDULER_TORCH_SIG_COMPRESS"] = "off"
    try:
        cache = make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache
        mesh_set("1")
        single, _, _ = engine_codes(cache, CONFIG2_CONF, "lp")
        spec = str(MESH_SHARDS)
        mesh_set(spec)
        with open(conf_path, "w") as f:
            f.write(CONFIG2_CONF)
        with LpBlocksCapture() as cap, ReadbackSpy() as spy:
            rec, launches = run_cycle(cache, conf_path, engine="lp", shards=MESH_SHARDS)
        check_mesh_engine(spy.engine, "v", spec)
        placed = codes_equal("v", spec, spy.codes[:spy.engine.flat_count], single)
        binds, most = check_config2_binds(cache)
        emit({"phase": "main_path", "config": "config2_lp_mesh", "path": "v", "binds": binds,
              "lp": rec["cohort"].get("lp"), **rec})
        if len(cap.calls) != 1:
            raise SystemExit(f"path v: {len(cap.calls)} block solves")
        check = lp_blocks_record("config2_lp_mesh", cap.calls[0], timed=False)
    finally:
        os.environ.pop("SCHEDULER_TORCH_ALLOCATOR", None)
        os.environ.pop("SCHEDULER_TORCH_SIG_COMPRESS", None)
    return {"launches": launches, "binds": binds, "placed": placed, "check": check}


def mesh_flavors(conf_dir):
    """p's eighth under the device backfill flavor and the saturated storm
    (``saturated_storm_run``) under the device eviction flavor, each on one
    device and on the mesh: the same binds, evictions and statuses, the
    picks and fills through the mesh."""
    from scheduler_tpu_torch.harness.backfill_wave import (
        BACKFILL_CONF,
        BackfillWaveConfig,
        seed_wave_cache,
    )

    out = {}
    keys = ("evictions", "statuses", "binds")
    runs = {}
    for spec in ("1", str(MESH_SHARDS)):
        mesh_set(spec)
        runs[spec] = saturated_storm_run(None, "device")
    if not all(runs["1"][k] == runs[str(MESH_SHARDS)][k] for k in keys):
        raise SystemExit("the storm on the mesh differs from one device's")
    picks = {kind: stats.get("device_picks") for kind, stats in
             runs[str(MESH_SHARDS)]["evict"].items()}
    if not runs["1"]["evictions"] or not sum(v or 0 for v in picks.values()):
        raise SystemExit(f"the storm on the mesh: {len(runs['1']['evictions'])} evictions, "
                         f"picks {picks}")
    out["storm"] = {"evictions": len(runs["1"]["evictions"]), "device_picks": picks,
                    "launches": runs[str(MESH_SHARDS)]["launches"]}
    bf_conf = os.path.join(conf_dir, "mesh_backfill_conf.yaml")
    with open(bf_conf, "w") as f:
        f.write(BACKFILL_CONF)
    waves = {}
    for spec in ("1", str(MESH_SHARDS)):
        mesh_set(spec)
        cache = seed_wave_cache(BackfillWaveConfig(**BACKFILL_EIGHTH))
        rec, launches, outcome, wrong = backfill_cycle(cache, bf_conf, None, "device")
        if wrong:
            raise SystemExit(f"p's eighth on mesh {spec}: {'; '.join(wrong[:5])}")
        waves[spec] = (rec, launches, outcome)
    if waves["1"][2] != waves[str(MESH_SHARDS)][2]:
        raise SystemExit("p's eighth on the mesh differs from one device's")
    bf = waves[str(MESH_SHARDS)][0]["backfill"] or {}
    if not bf.get("engaged") or not bf.get("device_binds"):
        raise SystemExit(f"p's eighth on the mesh: the device fill did not engage: {bf}")
    out["backfill_eighth"] = {"binds": waves["1"][0]["binds"],
                              "device_binds": bf.get("device_binds"),
                              "launches": waves[str(MESH_SHARDS)][1]}
    emit({"phase": "mesh_flavors", **out})
    return out


def phase_mesh_paths(opts, out_dir):
    """The ``mesh_paths`` child: paths s, t, u and v and the device flavors
    on the mesh, after one config-1 cycle that warms the card up."""
    conf_path = os.path.join(out_dir, "mesh_paths_conf.yaml")
    with open(conf_path, "w") as f:
        f.write(CONFIG1_CONF)
    run_cycle(config1_cluster(), conf_path)
    gc.collect()
    out = {}
    for name, run in (("s", mesh_path_s), ("t", mesh_path_t), ("u", mesh_path_u),
                      ("v", mesh_path_v)):
        t0 = time.perf_counter()
        out[name] = run(opts, conf_path)
        out[name]["wall_s"] = time.perf_counter() - t0
        emit({"phase": "mesh_path_wall", "path": name, "wall_s": out[name]["wall_s"]})
        gc.collect()
    t0 = time.perf_counter()
    out["flavors"] = mesh_flavors(out_dir)
    out["flavors"]["wall_s"] = time.perf_counter() - t0
    mesh_set("1")
    return out


def mesh_entries(mesh, plain_rec, k2, k1, xs, lp):
    """The kernels line's entries of the mesh arms: launches from paths s-v
    (``mesh``: the ``mesh_paths`` child's result), times from the timed
    phases (``k2``: K2's mesh mode on b's operands; ``k1``: K1 on a shard's
    block of c's first step; ``xs``: the XLA shard mode at i's shape;
    ``lp``: the block solve on r''s operands), and ``plain_rec``:
    ``full_size_plain``'s record of b's operands, whose plain run also held
    K2's mesh mode."""
    s, t, u, v = mesh["s"], mesh["t"], mesh["u"], mesh["v"]
    return [
        {"name": "mega_allocate", "mode": "mesh", "path": "config3_mesh", "route": "cuda",
         "source": "scheduler_tpu_torch/csrc/mega_allocate.cu",
         "replaces": "scheduler_tpu/ops/megakernel.py:994-1015",
         "launches": s["launches"]["mega_allocate"], "shards": MESH_SHARDS,
         "max_abs_err": plain_rec["mesh"]["max_abs_err"], "ms": k2["ms"],
         "device_ms": k2["device_ms"], "event_ms": k2["event_ms"], "steps": k2["stats"][0],
         "us_per_step": k2["us_per_step"], "plan": k2["plan"],
         "plain_ms": plain_rec["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "placement_step", "mode": "per_shard", "path": "config3_templates_mesh",
         "route": "cuda", "source": "scheduler_tpu_torch/csrc/placement_step.cu",
         "replaces": "scheduler_tpu/ops/fused.py:355-450",
         "launches": t["launches"]["placement_step"], "shards": MESH_SHARDS,
         "launches_by_path": {"config3_templates_mesh_4": t["launches"]["placement_step"]},
         "checked_loop_steps_2x2": t["check"]["checked_steps"],
         "max_abs_err": k1["max_abs_err"], "n": k1["n"], "ms": k1["ms"],
         "event_ms": k1["event_ms"], "round_trip_ms": k1["round_trip_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None},
        {"name": "xla_step", "mode": "shard", "path": "templates_default_tiers_mesh",
         "route": "cuda", "source": "scheduler_tpu_torch/csrc/xla_step.cu",
         "replaces": "scheduler_tpu/ops/fused.py:683-700",
         "launches": sum(c["xla_step_shards"] for c in u["launches"].values()),
         "launches_by_path": {p: c["xla_step_shards"] for p, c in u["launches"].items()},
         "checked_loop_steps": {p: c["checked_steps"] for p, c in u["checks"].items()},
         "shards": MESH_SHARDS, "max_abs_err": xs["max_abs_err"], "n": xs["n"],
         "n_local": xs["n_local"],
         "ms": xs["ms"], "plain_ms": xs["plain_ms"], "bound_ms": xs["bound_ms"],
         "bound_by": xs["bound_by"], "plan": xs["plan"], "library_ms": None},
        {"name": "lp_relax", "mode": "node_blocks", "path": "config2_lp_mesh", "route": "cuda",
         "source": "scheduler_tpu_torch/csrc/lp_relax.cu",
         "replaces": "scheduler_tpu/ops/lp_place.py:359-513",
         "launches": v["launches"]["lp_relax_blocks"], "blocks": lp["blocks"],
         "max_abs_err": max(lp["max_abs_err"], v["check"]["max_abs_err"]),
         "over_tol": max(lp["over_tol"], v["check"]["over_tol"]),
         "vs_one_device": lp["vs_one_device"], "rtol": LP_KERNEL_RTOL, "atol": LP_KERNEL_ATOL,
         "rows": lp["rows"], "n": lp["n"], "cols": lp["cols"], "iters": lp["iters"],
         "plan": lp["plan"], "kernel_launches": lp["kernel_launches"], "ms": lp["ms"],
         "iteration_ms": lp["iteration_ms"], "device_ms": lp["device_ms"],
         "plain_ms": lp["plain_ms"],
         "bound_ms": lp["bound_ms"], "bound_by": lp["bound_by"],
         "library_ms": lp["library_ms"]},
    ]


def child_argv(child, path, opts):
    """The command line of this script's child process ``child`` (see
    ``--child``), writing its result to ``path``."""
    return [sys.executable, os.path.abspath(__file__), "--child", child, "--out", path,
            "--nodes", str(opts.nodes), "--pods", str(opts.pods),
            "--tasks-per-job", str(opts.tasks_per_job),
            "--config2-nodes", str(opts.config2_nodes), "--config2-pods", str(opts.config2_pods)]


def run_child(out_dir, child, opts):
    """Run child process ``child`` to its end (its JSON lines go to this
    script's standard output) and return the result it wrote."""
    path = os.path.join(out_dir, f"{child}.json")
    t0 = time.perf_counter()
    rc = subprocess.run(child_argv(child, path, opts)).returncode
    if rc != 0:
        raise SystemExit(f"the {child} process failed: rc {rc}")
    emit({"phase": "child_wall", "child": child, "wall_s": time.perf_counter() - t0})
    with open(path) as f:
        return json.load(f)


class BackgroundChild:
    """Child process ``child`` of this script (see ``--child``), started now
    and running beside the phases that follow; ``result`` waits for it and
    returns what it wrote."""

    def __init__(self, out_dir, child, opts):
        self.child = child
        self.path = os.path.join(out_dir, f"{child}.json")
        if os.path.exists(self.path + ".go"):
            os.remove(self.path + ".go")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(child_argv(child, self.path, opts))

    def go(self):
        """Let a child that waits in ``wait_for_go`` go on."""
        self.t_go = time.perf_counter()
        with open(self.path + ".go", "w") as f:
            f.write("go\n")

    def stop(self):
        """End the child process if it still runs (a phase failed first)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self):
        t0 = time.perf_counter()
        rc = self.proc.wait()
        if rc != 0:
            raise SystemExit(f"the {self.child} process failed: rc {rc}")
        emit({"phase": "child_wall", "child": self.child, "background": True,
              "wall_s": time.perf_counter() - self.t0, "waited_s": time.perf_counter() - t0,
              "ended": os.path.getmtime(self.path)})
        with open(self.path) as f:
            return json.load(f)


def wait_for_go(path, limit_s=1200.0):
    """In a child process: wait until the script calls ``go`` on it."""
    t0 = time.perf_counter()
    while not os.path.exists(path + ".go"):
        if time.perf_counter() - t0 > limit_s:
            raise SystemExit(f"{path}: no go from the script in {limit_s} s")
        time.sleep(0.2)


def check_host_loop(twin, binds, config="config2_default_tiers"):
    """The port's host loop on a twin of a config-2 cluster under the
    default tiers (``twin``: the ``host_loop`` child, on the CPU; at full
    size it takes minutes of one core, so it runs beside the kernel phases
    that follow the main paths): the main path's binds (f's on the fused
    route, n''s on the device route) must be its own."""
    host = twin.result()
    equal = binds == host
    emit({"phase": "host_loop_parity", "config": config,
          "binds": len(binds), "host_loop_binds": len(host), "equal_to_host_loop": equal,
          "wall_s": time.perf_counter() - twin.t0})
    if not equal:
        raise SystemExit(f"{config}: binds differ from the host loop's")


# -- paths r and r': the LP-relaxed allocator ---------------------------------------

class LpCapture:
    """Within the ``with`` block, keeps a copy of every ``lp_iterate`` call's
    operands (``calls``: logits, cap, req_aug, iters, tol), the relaxation's
    operands as the main path gave them to the kernel."""

    def __enter__(self):
        from scheduler_tpu_torch.ops import lp_place

        self.mod, self.orig = lp_place, lp_place.lp_iterate
        self.calls = []

        def lp_iterate(logits, cap, req_aug, *, iters, tol, plain=False, orig=self.orig):
            self.calls.append((logits.clone(), cap.clone(), req_aug.clone(), iters, tol))
            return orig(logits, cap, req_aug, iters=iters, tol=tol, plain=plain)

        lp_place.lp_iterate = lp_iterate
        return self

    def __exit__(self, *exc):
        self.mod.lp_iterate = self.orig


def lp_bound_ms(rows, n, r, iters):
    """The least time of one solve: its bytes (the logits, capacity and
    request columns read once, the marginals and preferred nodes written
    once) at the memory rate, against its float32 operations, each counted
    once (a cell an iteration: the add of log_v, the max's compare, the
    subtract, the exponential, the sum's add and the marginal's product;
    a multiply and an add a capacity column but in the last iteration) at
    the float32 rate.  Also the model of reading the logits from device
    memory twice an iteration, as the earlier four-launch design did
    (``iteration_bytes_ms``)."""
    nbytes = 4 * (2 * rows * n + n * r + rows * r + rows) + 8
    ops = rows * n * (6 * iters + 2 * r * (iters - 1))
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": ops,
            "iteration_bytes_ms": 1e3 * iters * 8 * rows * n / HBM_BYTES_PER_S}


def lp_launches_a_solve(solve, what):
    """The profiler's device ms a solve and its count of ``lp_`` kernel
    launches a solve, over three solves (``device_trace``), traced again
    (three traces at most) while the count is under one: a trace can miss
    a long launch but never adds one.  Exits unless the last trace counts
    exactly one.  Returns (ms, launches a solve, every trace's count)."""
    counts = []
    for _ in range(3):
        ms, per_solve, _ = device_trace(solve, 3, match="lp_")
        counts.append(per_solve)
        if per_solve >= 1:
            break
    if counts[-1] != 1:
        raise SystemExit(f"{what}: the profiler counted {counts} kernel launches a solve (each "
                         f"trace), not one")
    return ms, counts[-1], counts


def lp_plan_record(plan) -> dict:
    """The parts of an ``lp_place.LpPlan`` a record shows."""
    return {k: getattr(plan, k) for k in ("mode", "ctas", "tr", "tn", "node_tiles", "batch",
                                          "l_rows", "e_rows", "smem_bytes")}


def lp_kernel_record(path, call, repeats=5, binds=False, case="main_path_operands"):
    """``lp_relax`` on a main path's own operands (``LpCapture``), or on
    operands made for the check: the kernel twice (bitwise equal) and its
    plain version on the card, the marginals held by ``lp_marginal_errors``
    (pref and the evidence row equal), and all-zero marginals must fail
    that check.  With ``binds`` the projection must bind (``converged_at``
    not 0) and the first iteration's marginals, before any projection,
    must fail it too.  Then timed by events, a solve (``ms``, on the plan
    ``plan``) and an iteration (``iteration_ms``), and by the profiler
    (``device_ms``, a solve, and ``kernel_launches``, its count of kernel
    launches a solve, which must be one), beside the plain version's
    solve and
    ``torch.matmul``'s time for the load product ``x^T @ req_aug`` at the
    same shape (``library_ms``)."""
    import torch

    from scheduler_tpu_torch.ops import lp_place

    logits, cap, req_aug, iters, tol = call
    rows, n = logits.shape
    plan = lp_place.lp_plan(rows, n, cap.shape[1], 1, lp_place.device_sms(logits.device))
    got = lp_place.lp_iterate(logits, cap, req_aug, iters=iters, tol=tol)
    again = lp_place.lp_iterate(logits, cap, req_aug, iters=iters, tol=tol)
    start, stop = events()
    start.record()
    ref = lp_place.lp_iterate(logits, cap, req_aug, iters=iters, tol=tol, plain=True)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    errs = lp_marginal_errors(got[0], ref[0])
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, again))
    equal = torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    faults = {"zero_marginals": lp_marginal_errors(torch.zeros_like(ref[0]), ref[0])["over_tol"]}
    if binds:
        first = lp_place.lp_iterate(logits, cap, req_aug, iters=1, tol=tol, plain=True)[0]
        faults["unprojected"] = lp_marginal_errors(first, ref[0])["over_tol"]
    converged_at = int(got[2][1])
    if not (bitwise and equal and errs["over_tol"] <= 1.0
            and all(v > 1.0 for v in faults.values()) and (converged_at != 0 or not binds)):
        raise SystemExit(f"path {path}: lp_relax against its plain version: bitwise "
                         f"{bitwise}, pref and evidence equal {equal}, {errs}, faults' error "
                         f"over the limit {faults} (each must pass 1), converged_at "
                         f"{converged_at} (binds {binds})")
    start.record()
    for _ in range(repeats):
        lp_place.lp_iterate(logits, cap, req_aug, iters=iters, tol=tol)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / repeats
    device_ms, per_solve, traces = lp_launches_a_solve(
        lambda: lp_place.lp_iterate(logits, cap, req_aug, iters=iters, tol=tol),
        f"path {path}: lp_relax")
    x = got[0]
    torch.matmul(x.T, req_aug)
    start.record()
    for _ in range(20):
        torch.matmul(x.T, req_aug)
    stop.record()
    torch.cuda.synchronize()
    rec = {"case": f"{path}_{case}", "rows": rows, "n": n, "cols": cap.shape[1],
           "iters": iters, "plan": lp_plan_record(plan),
           "kernel_launches": per_solve, "launch_traces": traces, "ms": ms,
           "iteration_ms": ms / iters, "device_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": start.elapsed_time(stop) / 20,
           "library": "torch.matmul(x.T, req_aug), one iteration's load product",
           **errs, "rtol": LP_KERNEL_RTOL, "atol": LP_KERNEL_ATOL,
           "faults_over_tol": faults, "pref_equal": True, "bitwise_rerun": True,
           "evidence": got[2].tolist(), **lp_bound_ms(rows, n, cap.shape[1], iters)}
    emit({"phase": "kernel_vs_plain", "kernel": "lp_relax", **rec})
    return rec


def lp_cycle(cache, conf_path, path):
    """One cold LP cycle through ``run_cycle`` (engine ``lp``), its
    relaxation's operands captured and its codes kept: (record, launches,
    the capture, codes)."""
    with LpCapture() as cap, ReadbackSpy() as spy:
        rec, launches = run_cycle(cache, conf_path, engine="lp")
    cohort = rec["cohort"]
    lp, sig = cohort.get("lp") or {}, cohort.get("sig") or {}
    if len(cap.calls) != 1 or lp.get("iterations") != cap.calls[0][3]:
        raise SystemExit(f"path {path}: {len(cap.calls)} relaxations, evidence {lp}")
    return rec, launches, cap, spy.codes


def phase_lp_paths(opts, out_dir):
    """Paths r and r': the LP flavor (``SCHEDULER_TORCH_ALLOCATOR=lp``) on
    b's cluster and conf with signature classes (``auto``), then on a's with
    none (``off``), each one cold cycle on a fresh cluster; checks in the
    module docstring."""
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster, make_synthetic_cluster

    os.environ["SCHEDULER_TORCH_ALLOCATOR"] = "lp"
    conf_path = os.path.join(out_dir, "lp_paths_conf.yaml")
    out = {}
    # r: the flagship, on classes.
    with open(conf_path, "w") as f:
        f.write(FLAGSHIP_CONF)
    t0 = time.perf_counter()
    cache = make_synthetic_cluster(opts.nodes, opts.pods, tasks_per_job=opts.tasks_per_job).cache
    emit({"phase": "cluster", "config": "config3_lp", "nodes": opts.nodes, "pods": opts.pods,
          "build_s": time.perf_counter() - t0})
    rec, launches, cap, _ = lp_cycle(cache, conf_path, "r")
    binds, gangs = check_binds(cache, opts.nodes, opts.pods, opts.tasks_per_job)
    cohort = rec["cohort"]
    if not (cohort.get("sig") or {}).get("engaged"):
        raise SystemExit(f"path r: signature classes did not engage: {cohort.get('sig')}")
    emit({"phase": "main_path", "config": "config3_lp", "nodes": opts.nodes, "pods": opts.pods,
          "binds": binds, "gangs_bound": gangs, "classes": cohort["sig"]["classes"],
          "lp": cohort["lp"], "sig": cohort["sig"], "lp_ms": cohort.get("lp_ms"), **rec})
    out["r"] = {"launches": launches, "binds": binds, "lp": cohort["lp"], "sig": cohort["sig"],
                "phases_s": rec["phases_s"], "cycle_s": rec["cycle_s"],
                "kernel": lp_kernel_record("config3_lp", cap.calls[0])}
    del cache, cap
    gc.collect()
    # r': config 2, task by task, twice on twin clusters.
    os.environ["SCHEDULER_TORCH_SIG_COMPRESS"] = "off"
    with open(conf_path, "w") as f:
        f.write(CONFIG2_CONF)
    codes = []
    for twin in range(2):
        cache = make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache
        rec2, launches2, cap2, c = lp_cycle(cache, conf_path, "r'")
        binds2, most = check_config2_binds(cache)
        codes.append(c)
        if twin == 0:
            cohort2 = rec2["cohort"]
            if "sig" in cohort2 or launches2["static_predicate_mask"] < 1:
                raise SystemExit(f"path r': classes {cohort2.get('sig')}, K3 "
                                 f"{launches2['static_predicate_mask']}")
            emit({"phase": "main_path", "config": "config2_lp", "nodes": opts.config2_nodes,
                  "pods": opts.config2_pods, "binds": binds2, "most_pods_on_a_node": most,
                  "lp": cohort2["lp"], "lp_ms": cohort2.get("lp_ms"), **rec2})
            out["r'"] = {"launches": launches2, "binds": binds2, "lp": cohort2["lp"],
                         "phases_s": rec2["phases_s"], "cycle_s": rec2["cycle_s"],
                         "kernel": lp_kernel_record("config2_lp", cap2.calls[0]),
                         # v's relaxation: the same logits over four node blocks.
                         "blocks": lp_blocks_record("config2_lp_blocks",
                                                    split_lp_call(cap2.calls[0], MESH_SHARDS))}
            shape, iters, tol = cap2.calls[0][0].shape, cap2.calls[0][3], cap2.calls[0][4]
            cols = cap2.calls[0][1].shape[1]
        del cache, cap2
        gc.collect()
    if codes[0] is None or codes[1] is None or not (codes[0] == codes[1]).all():
        raise SystemExit("path r': two cycles on twin clusters gave different codes")
    emit({"phase": "lp_twin_cycles", "config": "config2_lp", "codes_equal": True,
          "tasks": int(codes[0].shape[0])})
    # r''s shape with requests of twice the cluster: the projection binds.
    import torch

    ops = lp_operands(LP_TIGHT_SEED, shape[0], shape[1], cols - 1, tight=True)
    call = (*lp_iterate_operands(ops, torch.device("cuda")), iters, tol)
    if call[1].shape[1] != cols:
        raise SystemExit(f"path r': the tight operands have {call[1].shape[1]} capacity "
                         f"columns, r' {cols}")
    out["r'_tight"] = {"kernel": lp_kernel_record("config2_lp", call, binds=True,
                                                  case="tight_operands")}
    return out


def child_main(child, path, opts) -> int:
    """``--child``: ``host_loop`` writes the host loop's binds on a config-2
    cluster under the default tiers (for ``check_host_loop``);
    ``mq_ladder_plain`` writes K2's ladder check against its plain version,
    ``kernel_cases_synthetic`` ``phase_kernel_synthetic``'s case count; each other
    child is one main path's cold cycle in a process of its own, after one
    config-1 cycle that warms the card, the kernel library and PyTorch up.
    ``Scheduler.run_once`` collects garbage at the head of every cycle: in
    a process of its own the phase walks the path's cluster alone, whatever
    the script built before.  It writes the path's launch counts (and the
    default tiers' binds, or the ladder flagship's water-fill check)."""
    from scheduler_tpu_torch.harness import (
        make_gpu_topology_cluster,
        make_kubemark_density_cluster,
        make_mq_ladder_cluster,
        make_reclaim_aftermath_cluster,
        make_synthetic_cluster,
    )

    if child == "full_size_plain":
        out = phase_full_size_plain(path, opts)
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "loop_parity":
        # c's and j's loops on second clusters built the same way, with K1
        # and with its plain version on the card (after the timed phases).
        import torch

        out = {}
        for name, kw, conf_text, case in (
                ("c", {}, FLAGSHIP_CONF, "config3_templates"),
                ("j", dict(queues=MQ_QUEUES, queue_weights=MQ_WEIGHTS), MULTIQ_CONF,
                 "templates_multi_queue")):
            cache = template_cluster(opts.nodes, opts.template_jobs, opts.template_tasks, **kw)
            _, out[name] = phase_loop_parity(cache, torch.device("cuda"), 200, conf_text, case)
            del cache
            gc.collect()
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "mesh_paths":
        out = phase_mesh_paths(opts, os.path.dirname(path))
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "lp_paths":
        # Paths r and r', after one config-1 cycle that warms the card up.
        conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
        with open(conf_path, "w") as f:
            f.write(CONFIG1_CONF)
        run_cycle(config1_cluster(), conf_path)
        gc.collect()
        out = phase_lp_paths(opts, os.path.dirname(path))
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "host_loop":
        binds = host_loop_binds(
            make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache,
            DEFAULT_TIERS_CONF)
        with open(path, "w") as f:
            json.dump(binds, f)
        return 0
    if child in ("reclaim_host_loop", "reclaim_templates_host_loop"):
        args = ((RECLAIM_THIN_REQUESTS, RECLAIM_TEMPLATES_SCALE)
                if child == "reclaim_templates_host_loop" else ())
        with open(path, "w") as f:
            json.dump(reclaim_host_loop(*args), f)
        return 0
    if child == "loop_host_twins":
        with open(path, "w") as f:
            json.dump(loop_host_twins(), f)
        return 0
    if child in ("templates_default_tiers_cpu", "reclaim_aftermath_templates_cpu"):
        if child == "templates_default_tiers_cpu":
            cache, conf_text = template_cluster(*TIERS_TEMPLATES), DEFAULT_TIERS_CONF
        else:
            cache = make_reclaim_aftermath_cluster(RECLAIM_TEMPLATES_SCALE,
                                                   thin_requests=RECLAIM_THIN_REQUESTS).cache
            conf_text = RECLAIM_CONF
        codes = path[:-len(".json")] + ".npy"
        out = dict(cpu_loop_codes(cache, conf_text, codes), codes=codes)
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child in ("config3_steady", "default_conf_loop", "default_conf_cold"):
        # Paths l and m, and m's cold twin, after one config-1 cycle that
        # warms the card, the kernel library and PyTorch up.
        if child == "default_conf_cold":
            os.environ["SCHEDULER_TORCH_ENGINE_CACHE"] = "0"
        conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
        with open(conf_path, "w") as f:
            f.write(CONFIG1_CONF)
        run_cycle(config1_cluster(), conf_path)
        gc.collect()
        out = phase_steady_flagship(opts) if child == "config3_steady" else \
            phase_default_conf_loop(opts)
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "config4_reclaim_twin":
        # o's twin: o's cycle on the CPU; then, once the script says go
        # (beside the untimed phases), path o' on the card after one
        # config-1 cycle there.
        from scheduler_tpu_torch.harness import make_reclaim_cluster

        conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
        with open(conf_path, "w") as f:
            f.write(RECLAIM_ALLOCATE_CONF)
        rec, _, outcome, wrong = reclaim_cycle(make_reclaim_cluster(RECLAIM_O_SCALE).cache,
                                               conf_path, "cpu")
        if wrong:
            raise SystemExit(f"path o on the CPU: {'; '.join(wrong[:5])}")
        out = {"outcome": outcome, "record": rec}
        gc.collect()
        wait_for_go(path)
        warm_conf = os.path.join(os.path.dirname(path), f"{child}_warm_conf.yaml")
        with open(warm_conf, "w") as f:
            f.write(CONFIG1_CONF)
        run_cycle(config1_cluster(), warm_conf)
        gc.collect()
        out["device_flavor"] = phase_config4_reclaim_device(conf_path, out)
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "preempt_storm":
        with open(path, "w") as f:
            json.dump({"launches": phase_preempt_storms()}, f)
        return 0
    if child in ("production_conf", "config2_default_tiers_device", "config4_reclaim"):
        # Paths n, n' and o, after one config-1 cycle that warms the card,
        # the kernel library and PyTorch up.
        conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
        with open(conf_path, "w") as f:
            f.write(CONFIG1_CONF)
        run_cycle(config1_cluster(), conf_path)
        gc.collect()
        if child == "production_conf":
            root = os.path.dirname(os.path.abspath(__file__))
            out = phase_production_conf(opts, os.path.join(root, PRODUCTION_CONF))
        elif child == "config2_default_tiers_device":
            with open(conf_path, "w") as f:
                f.write(DEFAULT_TIERS_CONF)
            launches, binds, scan = phase_default_tiers_device(opts, conf_path)
            out = {"launches": launches, "binds": binds, "scan": scan}
        else:
            with open(conf_path, "w") as f:
                f.write(RECLAIM_ALLOCATE_CONF)
            out = phase_config4_reclaim(conf_path)
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "backfill_wave":
        # Path p, after one config-1 cycle that warms the card, the kernel
        # library and PyTorch up.
        from scheduler_tpu_torch.harness.backfill_wave import BACKFILL_CONF

        conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
        with open(conf_path, "w") as f:
            f.write(CONFIG1_CONF)
        run_cycle(config1_cluster(), conf_path)
        gc.collect()
        with open(conf_path, "w") as f:
            f.write(BACKFILL_CONF)
        out = phase_backfill_wave(conf_path)
        with open(path, "w") as f:
            json.dump(out, f)
        return 0
    if child == "daemon_wire":
        # Paths q and q', after one config-1 cycle that warms the card, the
        # kernel library and PyTorch up.
        conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
        with open(conf_path, "w") as f:
            f.write(CONFIG1_CONF)
        run_cycle(config1_cluster(), conf_path)
        gc.collect()
        q = daemon_config2(opts.config2_nodes, opts.config2_pods, os.path.dirname(path))
        emit({"phase": "main_path", "config": "daemon_config2", **q})
        gc.collect()
        churn = phase_churn()
        emit({"phase": "main_path", "config": "daemon_churn", **churn})
        with open(path, "w") as f:
            json.dump({"q": q, "churn": churn}, f)
        return 0
    if child == "kernel_cases_synthetic":
        import torch

        with open(path, "w") as f:
            json.dump({"cases": phase_kernel_synthetic(torch.device("cuda"))}, f)
        return 0
    if child == "mq_ladder_plain":
        # K2 in ladder mode against its plain version on path g's operands
        # (a cluster built as the main path's): codes and stats bitwise,
        # and the plain version's time.  The cluster and the engine are
        # host work (and the operands' upload), built at once beside the
        # timed phases; the 25,001 steps run once the script says the last
        # of those has ended.
        import torch

        cache = make_mq_ladder_cluster(LADDER_NODES, LADDER_PATH_PODS, LADDER_QUEUES,
                                       LADDER_VOCAB).cache
        _, eng = engine_for(cache, MULTIQ_CONF, torch.device("cuda"))
        if not eng._mega_kw["qfair_ladder"]:
            raise SystemExit(f"the ladder flagship declined the ladder: {eng.qfair_reason}")
        wait_for_go(path)
        rec = compare("mq_ladder_main_path_operands", eng._mega_args, eng._mega_kw,
                      eng.st.nodes.count, len(eng.queue_uids))
        with open(path, "w") as f:
            json.dump(rec, f)
        return 0
    conf_path = os.path.join(os.path.dirname(path), f"{child}_conf.yaml")
    with open(conf_path, "w") as f:
        f.write(CONFIG1_CONF)
    run_cycle(config1_cluster(), conf_path)
    gc.collect()
    conf = {"config3_multi_queue": MULTIQ_CONF, "config5": CONFIG2_CONF,
            "config2_default_tiers": DEFAULT_TIERS_CONF, "mq_ladder": MULTIQ_CONF,
            "reclaim_aftermath": RECLAIM_CONF, "templates_default_tiers": DEFAULT_TIERS_CONF,
            "templates_multi_queue": MULTIQ_CONF,
            "reclaim_aftermath_templates": RECLAIM_CONF}[child]
    with open(conf_path, "w") as f:
        f.write(conf)  # config 5's plugins are config 2's
    t0 = time.perf_counter()
    if child == "config3_multi_queue":
        cache = make_synthetic_cluster(opts.nodes, opts.pods, tasks_per_job=opts.tasks_per_job,
                                       queues=MQ_QUEUES, queue_weights=MQ_WEIGHTS).cache
        nodes, pods = opts.nodes, opts.pods
    elif child == "config5":
        cache = make_gpu_topology_cluster(CONFIG5_NODES, CONFIG5_GANGS).cache
        nodes, pods = CONFIG5_NODES, 8 * CONFIG5_GANGS
    elif child == "mq_ladder":
        cache = make_mq_ladder_cluster(LADDER_NODES, LADDER_PATH_PODS, LADDER_QUEUES,
                                       LADDER_VOCAB).cache
        nodes, pods = LADDER_NODES, LADDER_PATH_PODS
    elif child in ("reclaim_aftermath", "reclaim_aftermath_templates"):
        built = (make_reclaim_aftermath_cluster(RECLAIM_TEMPLATES_SCALE,
                                                thin_requests=RECLAIM_THIN_REQUESTS)
                 if child == "reclaim_aftermath_templates" else make_reclaim_aftermath_cluster())
        cache, nodes, pods = built.cache, built.n_nodes, built.n_pods
    elif child == "templates_default_tiers":
        cache = template_cluster(*TIERS_TEMPLATES)
        nodes, pods = TIERS_TEMPLATES[0], TIERS_TEMPLATES[1] * TIERS_TEMPLATES[2]
    elif child == "templates_multi_queue":
        cache = template_cluster(opts.nodes, opts.template_jobs, opts.template_tasks,
                                 queues=MQ_QUEUES, queue_weights=MQ_WEIGHTS)
        nodes, pods = opts.nodes, opts.template_jobs * opts.template_tasks
    else:
        cache = make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache
        nodes, pods = opts.config2_nodes, opts.config2_pods
    emit({"phase": "cluster", "config": child, "nodes": nodes, "pods": pods,
          "build_s": time.perf_counter() - t0})
    out = {}
    if child == "config3_multi_queue":
        out["launches"] = phase_main_path_mq_flagship(cache, conf_path, nodes, pods,
                                                      opts.tasks_per_job)
    elif child == "config5":
        out["launches"] = phase_main_path_config5(cache, conf_path, nodes, CONFIG5_GANGS)
    elif child == "mq_ladder":
        out["launches"] = phase_main_path_ladder(cache, conf_path)
        # The main path's cluster after its cycle: proportion's device
        # water-fill against the host's, on a session of its own (on the
        # card: the device None).
        from scheduler_tpu_torch.conf import parse_scheduler_conf
        from scheduler_tpu_torch.framework import close_session, open_session

        ssn = open_session(cache, parse_scheduler_conf(MULTIQ_CONF).tiers)
        out["solve"] = device_vs_host_solve(ssn)
        close_session(ssn)
    elif child == "reclaim_aftermath":
        out["launches"], out["outcome"], _ = phase_main_path_reclaim(cache, conf_path)
    elif child == "reclaim_aftermath_templates":
        out["codes"] = os.path.join(os.path.dirname(path), f"{child}_codes.npy")
        with XlaCapture() as cap:
            out["launches"], out["outcome"], out["arm"] = phase_main_path_reclaim(
                cache, conf_path, child, "xla", out["codes"])
        out["check"] = xla_loop_check(child, cap)
        out["xla"] = xla_step_record(child, cap)
    elif child == "templates_default_tiers":
        out["codes"] = os.path.join(os.path.dirname(path), f"{child}_codes.npy")
        with XlaCapture() as cap:
            out["launches"], out["arm"] = phase_main_path_tiers_templates(cache, conf_path,
                                                                          out["codes"])
        out["check"] = xla_loop_check(child, cap)
        out["xla"] = xla_step_record(child, cap)
    elif child == "templates_multi_queue":
        out["launches"] = phase_main_path_mq_templates(cache, conf_path, opts)
    else:
        out["launches"], out["binds"] = phase_main_path_default_tiers(cache, conf_path, nodes,
                                                                      pods)
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def phase_kernel_synthetic(device):
    """mega_allocate against its plain version on the synthetic operands
    (no session: ``MEGA_SYNTHETIC``, ``MEGA_SYNTHETIC_MQ``,
    ``MEGA_SYNTHETIC_LADDER``, ``MEGA_SYNTHETIC_REL``), untimed: the script
    runs this in a child process beside ``phase_kernel_cases``.  Returns
    the count of cases."""
    from scheduler_tpu_torch.interop import mega_operands_from_numpy

    count = 0
    # Across the launch plans (r_dim 8 up to nb 32,768 on 16 CTAs, ties and
    # second-best across CTAs, an infeasible chunk, config 2's j_pad with the
    # job ledger on chip); multi-queue mode.
    for case, spec in MEGA_SYNTHETIC.items():
        args, kw = mega_operands_from_numpy(*mega_operands(**spec), device)
        compare(f"synthetic_{case}", args, kw, spec.get("n_nodes") or spec["nb"])
        count += 1
    for case, spec in MEGA_SYNTHETIC_MQ.items():
        args, kw = mega_operands_from_numpy(*mega_operands(**spec), device)
        compare(f"synthetic_{case}", args, kw, spec.get("n_nodes") or spec["nb"], spec["queues"])
        count += 1
    # The qfair ladder in both instantiations.
    for case, spec in MEGA_SYNTHETIC_LADDER.items():
        args, kw = mega_operands_from_numpy(*ladder_operands(**spec), device)
        compare(f"synthetic_{case}", args, kw, spec.get("n_nodes") or spec["nb"], spec["queues"])
        count += 1
    # Releasing mode in the four instantiations up to the 16-CTA plan, ties,
    # releasing-only winners and the pod-count gate.
    for case, spec in MEGA_SYNTHETIC_REL.items():
        args, kw = mega_operands_from_numpy(*mega_operands(**spec), device)
        compare(f"synthetic_{case}", args, kw, spec.get("n_nodes") or spec["nb"],
                spec.get("queues", 0))
        count += 1
    return count


def phase_kernel_cases(device):
    """mega_allocate against its plain version on every small session (the
    synthetic operands run in a child, ``phase_kernel_synthetic``).
    Returns the timed records of the full-recompute queue chain (no main
    path runs it)."""
    from scheduler_tpu_torch.harness import (
        make_kubemark_density_cluster,
        make_mq_ladder_cluster,
        make_reclaim_aftermath_cluster,
        make_synthetic_cluster,
    )
    from scheduler_tpu_torch.ops import megakernel as mk

    _, eng = engine_for(config1_cluster(), CONFIG1_CONF, device)
    compare("config1", eng._mega_args, eng._mega_kw, eng.st.nodes.count, len(eng.queue_uids))

    cl = make_synthetic_cluster(1000, 10_000, tasks_per_job=100)
    _, eng = engine_for(cl.cache, FLAGSHIP_CONF, device)
    compare("flagship_1k_x_10k", eng._mega_args, eng._mega_kw, eng.st.nodes.count,
            len(eng.queue_uids))

    # Kernel level: identical-request gangs on a tight cluster, with the
    # least-requested and balanced weights (so the top-2 score bound cuts
    # batches) and the pod-count gate on, and four cohort chunks.
    cl = make_synthetic_cluster(100, 10_000, tasks_per_job=100,
                                request_fn=uniform_gang_request)
    _, eng = engine_for(cl.cache, FLAGSHIP_CONF, device)
    kw = dict(eng._mega_kw, weights=(1.0, 1.0, 1.0), score_bound=True,
              enforce_pod_count=True, cohort=4)
    if not kw["batch_runs"]:
        raise SystemExit("the kernel-level case must batch runs")
    compare("score_bound_pod_count", eng._mega_args, kw, eng.st.nodes.count)

    _, eng = engine_for(many_jobs_cluster(), FLAGSHIP_CONF, device)
    if not mk.plan_for(eng._mega_args, eng._mega_kw, len(eng.queue_uids)).job_ledger_in_global:
        raise SystemExit("the many-jobs case must put the job ledger in global scratch")
    compare("global_job_ledger", eng._mega_args, eng._mega_kw, eng.st.nodes.count)

    # Multi-queue mode on the 1:9 starvation session at one and four cohort
    # chunks.
    _, eng = engine_for(spec_cluster(multi_queue_spec((1, 9), 3)), MULTIQ_CONF, device)
    for cohort in (1, 4):
        compare(f"mq_starvation_cohort_{cohort}", eng._mega_args,
                dict(eng._mega_kw, cohort=cohort), eng.st.nodes.count, len(eng.queue_uids))
    # The full-recompute queue chain on the same session (timed: the
    # kernels line's full-recompute entry).
    full = {"starvation": compare("mq_starvation_full_recompute", eng._mega_args,
                                  dict(eng._mega_kw, queue_delta=False), eng.st.nodes.count,
                                  len(eng.queue_uids), timed=True)}
    # The qfair ladder at the ladder flagship's shape, at the size its plain
    # version runs in seconds (also on the full-recompute chain).
    _, eng = engine_for(make_mq_ladder_cluster(*LADDER_SMALL).cache, MULTIQ_CONF, device)
    if not eng._mega_kw["qfair_ladder"]:
        raise SystemExit(f"the small ladder session declined the ladder: {eng.qfair_reason}")
    case = "ladder_{}_x_{}_{}q".format(*LADDER_SMALL)
    compare(case, eng._mega_args, eng._mega_kw, eng.st.nodes.count, len(eng.queue_uids))
    full["ladder_small"] = compare(
        case + "_full_recompute", eng._mega_args,
        dict(eng._mega_kw, qfair_ladder=False, queue_delta=False), eng.st.nodes.count,
        len(eng.queue_uids), timed=True)
    # Releasing mode: the one-queue mid-evict session and config 4's
    # aftermath at 2 %.
    for case, cache, conf in (
            ("mid_evict", mid_evict_cluster(), FLAGSHIP_CONF),
            ("reclaim_aftermath_20_x_1000", make_reclaim_aftermath_cluster(0.02).cache,
             RECLAIM_CONF)):
        _, eng = engine_for(cache, conf, device)
        if not eng._mega_kw["has_releasing"]:
            raise SystemExit(f"{case}: the engine did not stage releasing capacity")
        compare(case, eng._mega_args, eng._mega_kw, eng.st.nodes.count, len(eng.queue_uids))

    # Static-row mode on small sessions, at one and four cohort chunks.
    for case, cache_fn, conf in (
        ("static", lambda: spec_cluster(static_spec()), PREDICATES_CONF),
        ("static_score_bound", lambda: spec_cluster(selector_bound_spec()), PREDICATES_CONF),
        ("static_predicates", lambda: spec_cluster(predicates_spec()), PRESSURE_CONF),
        ("config2_64_x_600", lambda: make_kubemark_density_cluster(64, 600).cache,
         CONFIG2_CONF),
    ):
        _, eng = engine_for(cache_fn(), conf, device)
        if not eng._mega_kw["use_static"]:
            raise SystemExit(f"{case}: the engine did not stage static rows")
        for cohort in (1, 4):
            compare(f"{case}_cohort_{cohort}", eng._mega_args,
                    dict(eng._mega_kw, cohort=cohort), eng.st.nodes.count)
    return full


def phase_ladder_full_size(cache, device):
    """The ladder flagship's operands, from a second cluster built as the
    main path's: K2 in ladder mode against the delta chain (equal codes;
    each timed), then proportion's water-fill of that session on the card
    against its plain version (timed) and against the host water-fill
    (bitwise, and the host's time)."""
    t0 = time.perf_counter()
    ssn, eng = engine_for(cache, MULTIQ_CONF, device)
    init_s = time.perf_counter() - t0
    if not eng._mega_kw["qfair_ladder"]:
        raise SystemExit(f"the ladder flagship declined the ladder: {eng.qfair_reason}")
    case = "mq_ladder_main_path_operands"
    recs = compare_chains(case, eng._mega_args, eng._mega_kw, eng.st.nodes.count,
                          len(eng.queue_uids))
    ops = proportion_solve_operands(ssn, device)
    solve = compare_qfair(case, ops, int(ops[1].shape[0]) + 4, timed=True)
    host = device_vs_host_solve(ssn)
    solve["host_solve_ms"] = host["host_solve_ms"]
    solve["device_solve_ms"] = host["device_solve_ms"]
    emit({"phase": "full_size", "case": case, "engine_init_s": init_s,
          "plan": recs["ladder"]["plan"], "qfair": eng.run_stats()["qfair"]})
    return recs, solve


# The main paths whose K2 operands are timed again at full size (from a
# second cluster built as the main path's was), with their confs; the
# ``full_size_plain`` child holds K2 to its plain version on a third twin
# of each after the timed phases.
FULL_SIZE_CASES = (
    ("config2_main_path_operands", "config2", CONFIG2_CONF),
    ("main_path_operands", "config3", FLAGSHIP_CONF),
    ("multi_queue_main_path_operands", "config3_multi_queue", MULTIQ_CONF),
    ("config5_main_path_operands", "config5", CONFIG2_CONF),
    ("config2_default_tiers_main_path_operands", "config2_default_tiers", DEFAULT_TIERS_CONF),
    ("reclaim_aftermath_main_path_operands", "config4_reclaim_aftermath", RECLAIM_CONF),
)


def full_size_cluster(config, opts):
    """A cluster of main path ``config`` (``FULL_SIZE_CASES``), built as the
    main path's was."""
    from scheduler_tpu_torch.harness import (
        make_gpu_topology_cluster,
        make_kubemark_density_cluster,
        make_reclaim_aftermath_cluster,
        make_synthetic_cluster,
    )

    if config in ("config2", "config2_default_tiers"):
        return make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache
    if config == "config3":
        return make_synthetic_cluster(opts.nodes, opts.pods,
                                      tasks_per_job=opts.tasks_per_job).cache
    if config == "config3_multi_queue":
        return make_synthetic_cluster(opts.nodes, opts.pods, tasks_per_job=opts.tasks_per_job,
                                      queues=MQ_QUEUES, queue_weights=MQ_WEIGHTS).cache
    if config == "config5":
        return make_gpu_topology_cluster(CONFIG5_NODES, CONFIG5_GANGS).cache
    return make_reclaim_aftermath_cluster().cache


def phase_full_size_plain(path, opts):
    """The ``full_size_plain`` child: K2 against its plain version on the
    operands of each ``FULL_SIZE_CASES`` path (a cluster built as the main
    path's), codes and stats bitwise, the plain version timed.  The
    clusters and engines are host work, built at once beside the timed
    phases; the plain runs wait for the script's go (after the last timed
    phase).  Returns the records by case."""
    import torch

    engines = []
    for case, config, conf_text in FULL_SIZE_CASES:
        _, eng = engine_for(full_size_cluster(config, opts), conf_text, torch.device("cuda"))
        engines.append((case, eng))
    wait_for_go(path)
    out = {}
    for case, eng in engines:
        # b's operands also hold K2's mesh mode (path s) to the same plain run.
        mesh = mesh_of(MESH_SHARDS) if case == "main_path_operands" else None
        rec = compare(case, eng._mega_args, eng._mega_kw, eng.st.nodes.count,
                      len(eng.queue_uids), mesh=mesh)
        out[case] = {k: rec[k] for k in ("mode", "stats", "equal", "max_abs_err", "plain_ms")}
        if mesh is not None:
            out[case]["mesh"] = rec["mesh"]
    return out


def merge_plain(recs, plain):
    """The timed full-size records with the plain version's check on their
    twins (``full_size_plain``): the same mode and kernel stats, the codes
    and stats equal to the plain version's, and its time."""
    for rec in recs:
        other = plain[rec["case"]]
        if other["mode"] != rec["mode"] or other["stats"] != rec["stats"] or not other["equal"]:
            raise SystemExit(f"{rec['case']}: the plain check's twin ran {other['mode']} "
                             f"{other['stats']} (equal {other['equal']}), the timed kernel "
                             f"{rec['mode']} {rec['stats']}")
        rec.update(max_abs_err=other["max_abs_err"], plain_ms=other["plain_ms"])


def phase_full_size(cache, conf_text, device, case):
    """A main path's operands (a session opened on a cluster built as the
    main path's was): the kernel timed (its plain version runs on a twin in
    the ``full_size_plain`` child, ``merge_plain``)."""
    from scheduler_tpu_torch.ops import megakernel as mk

    t0 = time.perf_counter()
    _, eng = engine_for(cache, conf_text, device)
    init_s = time.perf_counter() - t0
    rec = compare(case, eng._mega_args, eng._mega_kw, eng.st.nodes.count, len(eng.queue_uids),
                  timed=True, plain=False)
    emit({"phase": "full_size", "case": case, "engine_init_s": init_s, "plan": rec["plan"],
          "covered_nodes": mk.covered_nodes(dict(zip(mk.OPERAND_NAMES, eng._mega_args))["gate"])})
    return rec, eng


def phase_predicate_cases(st, device):
    """static_predicate_mask on config 2's real operands (timed), on a wide
    random case (timed) and on empty label / taint vocabularies."""
    main = compare_predicate("config2_operands", predicate_operands(st, device), timed=True)
    wide = compare_predicate("wide_4096_x_10000",
                             random_predicate_operands(4096, 10_000, 512, 16, device),
                             timed=True)
    worst = max(main["max_abs_err"], wide["max_abs_err"])
    for case, shape in (("no_labels", (40, 70, 0, 5)), ("no_taints", (40, 70, 9, 0)),
                        ("no_vocabulary", (3, 5, 0, 0))):
        rec = compare_predicate(case, random_predicate_operands(*shape, device))
        worst = max(worst, rec["max_abs_err"])
    return main, wide, worst


def phase_e2e_small(conf_path):
    """The fused route on the card against the host loop on the CPU, on
    clusters small enough for the host loop: equal binds."""
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.harness import (
        make_gpu_topology_cluster,
        make_kubemark_density_cluster,
        make_mq_ladder_cluster,
        make_reclaim_aftermath_cluster,
        make_synthetic_cluster,
    )
    from scheduler_tpu_torch.scheduler import Scheduler

    cases = (
        ("config1", lambda: config1_cluster(), CONFIG1_CONF, "mega"),
        ("flagship_64_x_600", lambda: make_synthetic_cluster(64, 600, tasks_per_job=10).cache,
         FLAGSHIP_CONF, "mega"),
        ("flagship_8_x_600", lambda: make_synthetic_cluster(8, 600, tasks_per_job=10).cache,
         FLAGSHIP_CONF, "mega"),
        ("config2_64_x_600", lambda: make_kubemark_density_cluster(64, 600).cache,
         CONFIG2_CONF, "mega"),
        ("config2_predicates_64_x_600", lambda: spec_cluster(config2_predicates_spec()),
         PRESSURE_CONF, "mega"),
        # 4,200 single-pod jobs of distinct requests: the loop route.
        ("templates_64_x_4200", lambda: template_cluster(64, 4200, 1), FLAGSHIP_CONF, "step"),
        # Multi-queue mode: three queues, the 1:9 starvation shape, config 2
        # under the default tiers; and config 5.
        ("mq3_64_x_600", lambda: make_synthetic_cluster(
            64, 600, tasks_per_job=10, queues=MQ_QUEUES, queue_weights=MQ_WEIGHTS).cache,
         MULTIQ_CONF, "mega"),
        ("mq_starvation", lambda: spec_cluster(multi_queue_spec((1, 9), 3)), MULTIQ_CONF,
         "mega"),
        ("config2_default_tiers_64_x_600", lambda: make_kubemark_density_cluster(64, 600).cache,
         DEFAULT_TIERS_CONF, "mega"),
        ("config5_75_x_50", lambda: make_gpu_topology_cluster(75, 50).cache, CONFIG2_CONF,
         "mega"),
        # The ladder flagship's shape: 12 queues of 100 single-pod jobs.
        ("mq_ladder_64_x_1200", lambda: make_mq_ladder_cluster(64, 1200, 12, 6).cache,
         MULTIQ_CONF, "mega"),
        # Releasing capacity: config 4's aftermath (idle slots bind, the rest
        # pipelines); past the mega gate, the loop's releasing arm.
        ("reclaim_aftermath_20_x_1000", lambda: make_reclaim_aftermath_cluster(0.02).cache,
         RECLAIM_CONF, "mega"),
        ("releasing_templates_16_x_4200", releasing_templates_cluster, FLAGSHIP_CONF, "xla"),
    )
    for name, build, conf_text, engine in cases:
        with open(conf_path, "w") as f:
            f.write(conf_text)
        gpu = build()
        reset_counts()
        Scheduler(gpu, scheduler_conf=conf_path).run_once()
        launches, _ = read_counts()
        host = build()
        ssn = open_session(host, parse_scheduler_conf(conf_text).tiers, device="cpu")
        AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
        close_session(ssn)
        equal = dict(gpu.binder.binds) == dict(host.binder.binds)
        emit({"phase": "e2e_small", "case": name, "engine": engine,
              "binds": len(gpu.binder.binds), "launches": launches,
              "equal_to_host_loop": equal})
        if not equal or not gpu.binder.binds:
            raise SystemExit(f"fused route and host loop disagree: {name}")
        ran = {"mega": launches["mega_allocate"] >= 1 and launches["placement_step"] == 0,
               "step": launches["mega_allocate"] == 0 and launches["placement_step"] > 0,
               "xla": launches["mega_allocate"] == 0 and launches["placement_step"] == 0
               and launches["xla_step"] > 0}
        if not ran[engine]:
            raise SystemExit(f"{name}: the fused route did not run the {engine} engine")


# The fields of each placement_step case in the kernels line.
STEP_CASE_TIMES = ("n", "ms", "device_ms", "event_ms", "queued_ms", "round_trip_ms", "plain_ms",
                   "bound_ms", "bound_by")


def step_entry(launches_by_path, slice_rec, recs, parities):
    """K1's entry of the kernels line: its launches on each main path that
    runs it (``launches``: their sum); every loop step that ``parities``
    checked was bitwise equal (a disagreement stops the run)."""
    return {"name": "placement_step", "route": "cuda",
            "source": "scheduler_tpu_torch/csrc/placement_step.cu",
            "replaces": "scheduler_tpu/ops/pallas_kernels.py:117",
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "checked_loop_steps": {p["case"]: p["checked_steps"] for p in parities},
            "ms": slice_rec["ms"], "device_ms": slice_rec["device_ms"],
            "event_ms": slice_rec["event_ms"], "queued_ms": slice_rec["queued_ms"],
            "round_trip_ms": slice_rec["round_trip_ms"],
            "plain_ms": slice_rec["plain_ms"],
            "bound_ms": slice_rec["bound_ms"], "bound_by": slice_rec["bound_by"],
            "library_ms": None,
            "cases": {r["case"]: {k: r[k] for k in STEP_CASE_TIMES} for r in recs}}


def mega_entry(mode, launches, rec, path=None, by_path=None):
    """K2's entry of the kernels line for one instantiation on one main
    path (``path``: the main path, where the mode has more than one;
    ``by_path``: its launches on every path that runs it)."""
    if rec["mode"] != mode:
        raise SystemExit(f"the {path or mode} operands ran {rec['mode']}, not {mode}")
    return {"name": "mega_allocate", "mode": mode, "path": path, "route": "cuda",
            "launches_by_path": by_path or {path: launches},
            "source": "scheduler_tpu_torch/csrc/mega_allocate.cu",
            "replaces": "scheduler_tpu/ops/megakernel.py:181",
            "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "event_ms": rec["event_ms"],
            "steps": rec["stats"][0], "us_per_step": rec["us_per_step"], "plan": rec["plan"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None}


def ladder_entry(launches, recs, plain):
    """K2's entry of the kernels line for the qfair ladder on the ladder
    flagship: its time on the main path's operands (and the delta chain's
    on the same operands), and its plain version's error and time on those
    operands (``plain``: ``compare``'s record)."""
    lad, delta = recs["ladder"], recs["delta"]
    if plain["mode"] != lad["mode"] or plain["stats"] != lad["stats"]:
        raise SystemExit(f"the ladder's records differ: {lad['mode']} {lad['stats']}, "
                         f"{plain['mode']} {plain['stats']}")
    entry = mega_entry("multi_queue_ladder", launches,
                       dict(lad, max_abs_err=plain["max_abs_err"], plain_ms=plain["plain_ms"]),
                       "mq_ladder")
    entry.update(delta_chain_ms=delta["ms"], delta_chain_us_per_step=delta["us_per_step"])
    return entry


def qfair_entry(launches_by_path, solve, worst):
    """qfair_solve's entry of the kernels line: timed on the ladder
    flagship's water-fill (100 queues), beside the host water-fill's time
    on the same queue attributes."""
    return {"name": "qfair_solve", "route": "cuda",
            "source": "scheduler_tpu_torch/csrc/qfair_solve.cu",
            "replaces": "scheduler_tpu/ops/qfair.py:93",
            "launches": launches_by_path["mq_ladder"],
            "launches_by_path": launches_by_path,
            "max_abs_err": max(worst, solve["max_abs_err"]), "queues": solve["queues"],
            "dims": solve["dims"], "ms": solve["ms"], "device_ms": solve["device_ms"],
            "event_ms": solve["event_ms"], "plain_ms": solve["plain_ms"],
            "bound_ms": solve["bound_ms"], "bound_by": solve["bound_by"], "library_ms": None,
            "chain_floor_ms": solve["chain_floor_ms"], "rounds": solve["rounds"],
            "dadd_ns": solve["dadd_ns"],
            "plan": solve["plan"], "host_solve_ms": solve["host_solve_ms"],
            "device_solve_ms": solve["device_solve_ms"]}


def xla_entry(launches_by_path, paths, planted, checks):
    """The XLA step kernel's entry of the kernels line: its launches on each
    main path that runs it, its time a step on path i's first steps
    (``paths``: ``xla_step_record``'s records by path; k's beside it), the
    planted cases' times, and the loop steps each path's check held to the
    plain version."""
    i = paths["templates_default_tiers"]
    return {"name": "xla_step", "route": "cuda", "source": "scheduler_tpu_torch/csrc/xla_step.cu",
            "replaces": "scheduler_tpu/ops/fused.py:704-864", "plan": i["plan"],
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "max_abs_err": max([r["max_abs_err"] for r in paths.values()]
                               + [r["max_abs_err"] for r in planted.values()]),
            "ms": i["ms"], "device_ms": i["device_ms"], "event_ms": i["event_ms"],
            "round_trip_ms": i["round_trip_ms"], "plain_ms": i["plain_ms"],
            "bound_ms": i["bound_ms"], "bound_by": i["bound_by"], "library_ms": None,
            "paths": {p: {k: r[k] for k in ("n", "steps", "ms", "device_ms", "event_ms",
                                             "round_trip_ms", "plain_ms", "bound_ms", "plan")}
                      for p, r in paths.items()},
            "planted": {k: {f: r[f] for f in ("ms", "event_ms", "round_trip_ms", "plain_ms",
                                              "bound_ms")} for k, r in planted.items()},
            "checked_loop_steps": {c["case"]: c["checked_steps"] for c in checks}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nodes", type=int, default=10_000)
    parser.add_argument("--pods", type=int, default=100_000)
    parser.add_argument("--tasks-per-job", type=int, default=100)
    parser.add_argument("--config2-nodes", type=int, default=1000)
    parser.add_argument("--config2-pods", type=int, default=5000)
    parser.add_argument("--template-jobs", type=int, default=5000)
    parser.add_argument("--template-tasks", type=int, default=20)
    parser.add_argument("--child", choices=("host_loop", "config3_multi_queue", "config5",
                                            "config2_default_tiers", "mq_ladder",
                                            "mq_ladder_plain", "kernel_cases_synthetic",
                                            "reclaim_aftermath",
                                            "reclaim_host_loop", "templates_default_tiers",
                                            "templates_multi_queue",
                                            "reclaim_aftermath_templates",
                                            "templates_default_tiers_cpu",
                                            "reclaim_aftermath_templates_cpu",
                                            "reclaim_templates_host_loop",
                                            "loop_host_twins", "config3_steady",
                                            "default_conf_loop", "default_conf_cold",
                                            "production_conf", "config2_default_tiers_device",
                                            "config4_reclaim", "config4_reclaim_twin",
                                            "preempt_storm", "backfill_wave", "daemon_wire",
                                            "lp_paths", "full_size_plain", "mesh_paths",
                                            "loop_parity"),
                        help="run only this child process of the script (child_main) and "
                             "write its result to --out")
    parser.add_argument("--out", metavar="PATH")
    opts = parser.parse_args()

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import scheduler_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 2
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401

    if opts.child:
        return child_main(opts.child, opts.out, opts)
    from scheduler_tpu_torch.harness import make_mq_ladder_cluster

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    conf_path = os.path.join(out_dir, "chip_smoke_conf.yaml")

    t_start = time.perf_counter()
    phase_device()
    smi = nvidia_smi_line()

    def timed_build(config, build, nodes, pods):
        t0 = time.perf_counter()
        cache = build()
        emit({"phase": "cluster", "config": config, "nodes": nodes, "pods": pods,
              "build_s": time.perf_counter() - t0})
        return cache

    def config2_cluster():
        return timed_build("config2", lambda: full_size_cluster("config2", opts),
                           opts.config2_nodes, opts.config2_pods)

    def flagship_cluster():
        return timed_build("config3", lambda: full_size_cluster("config3", opts),
                           opts.nodes, opts.pods)

    def mq_flagship_cluster():
        return timed_build("config3_multi_queue",
                           lambda: full_size_cluster("config3_multi_queue", opts),
                           opts.nodes, opts.pods)

    def config5_cluster():
        return timed_build("config5", lambda: full_size_cluster("config5", opts),
                           CONFIG5_NODES, 8 * CONFIG5_GANGS)

    def default_tiers_cluster():
        return timed_build("config2_default_tiers",
                           lambda: full_size_cluster("config2_default_tiers", opts),
                           opts.config2_nodes, opts.config2_pods)

    def ladder_cluster():
        return timed_build(
            "mq_ladder",
            lambda: make_mq_ladder_cluster(LADDER_NODES, LADDER_PATH_PODS, LADDER_QUEUES,
                                           LADDER_VOCAB).cache,
            LADDER_NODES, LADDER_PATH_PODS)

    def reclaim_cluster():
        return timed_build("config4_reclaim_aftermath",
                           lambda: full_size_cluster("config4_reclaim_aftermath", opts),
                           1000, 75_000)

    def templates_cluster():
        return timed_build(
            "config3_templates",
            lambda: template_cluster(opts.nodes, opts.template_jobs, opts.template_tasks),
            opts.nodes, opts.template_jobs * opts.template_tasks)

    # The main paths first, each on a cluster no other session has touched:
    # one cold cycle each, as a scheduler's first cycle after start-up.
    with open(conf_path, "w") as f:
        f.write(CONFIG2_CONF)
    config2_launches, config2_binds = phase_main_path_config2(
        config2_cluster(), conf_path, opts.config2_nodes, opts.config2_pods)
    gc.collect()
    with open(conf_path, "w") as f:
        f.write(FLAGSHIP_CONF)
    flagship_launches, flagship_digest, flagship_binds = phase_main_path_flagship(
        flagship_cluster(), conf_path, opts.nodes, opts.pods, opts.tasks_per_job)
    gc.collect()
    templates_launches, _ = phase_main_path_templates(
        templates_cluster(), conf_path, opts.nodes, opts.template_jobs, opts.template_tasks)
    gc.collect()
    # The paths of multi-queue mode and config 5, each in a process of its
    # own, one after another (child_main).
    mq_launches = run_child(out_dir, "config3_multi_queue", opts)["launches"]
    config5_launches = run_child(out_dir, "config5", opts)["launches"]
    tiers = run_child(out_dir, "config2_default_tiers", opts)
    tiers_launches, tiers_binds = tiers["launches"], tiers["binds"]
    ladder_launches = run_child(out_dir, "mq_ladder", opts)["launches"]
    reclaim = run_child(out_dir, "reclaim_aftermath", opts)
    # The loop's arms: the XLA step arm (i), K1 with the multi-queue pop (j)
    # and the releasing arm (k).
    tiers_tpl = run_child(out_dir, "templates_default_tiers", opts)
    mq_tpl = run_child(out_dir, "templates_multi_queue", opts)
    reclaim_tpl = run_child(out_dir, "reclaim_aftermath_templates", opts)
    # The resident engine across cycles: config 3 by the steady protocol,
    # then churn (l); the default conf's loop over six cycles (m).
    steady = run_child(out_dir, "config3_steady", opts)
    if steady["digest"] != flagship_digest:
        raise SystemExit("path l: the steady cycle's binds differ from path b's cold cycle's")
    emit({"phase": "steady_vs_cold", "binds_digest_equal": True,
          "steady_cycle_s": steady["steady"]["cycle_s"]})
    default_loop = run_child(out_dir, "default_conf_loop", opts)
    # The per-pop engine on the production conf at the north-star shape (n)
    # and on f's cluster (n'), config 4 through a real reclaim (o), and the
    # preempt storms.
    production = run_child(out_dir, "production_conf", opts)
    tiers_device = run_child(out_dir, "config2_default_tiers_device", opts)
    reclaim_o = run_child(out_dir, "config4_reclaim", opts)
    storms = run_child(out_dir, "preempt_storm", opts)
    # The LP flavor on b's cluster with signature classes (r) and on a's
    # task by task (r'), each bound within LP_BIND_TOLERANCE of greedy.
    lp_paths = run_child(out_dir, "lp_paths", opts)
    for path, greedy in (("r", flagship_binds), ("r'", config2_binds)):
        got = lp_paths[path]["binds"]
        emit({"phase": "lp_quality_gate", "path": path, "lp_binds": got, "greedy_binds": greedy,
              "ratio": got / max(greedy, 1), "tolerance": LP_BIND_TOLERANCE})
        if got < (1.0 - LP_BIND_TOLERANCE) * greedy:
            raise SystemExit(f"path {path}: the LP flavor bound {got}, greedy {greedy}")
    # After the timed cycles: the host loops' and the CPU loops' twins,
    # beside the kernel phases.
    twins = [BackgroundChild(out_dir, child, opts) for child in (
        "host_loop", "reclaim_host_loop", "reclaim_templates_host_loop", "loop_host_twins",
        "templates_default_tiers_cpu", "reclaim_aftermath_templates_cpu",
        "config4_reclaim_twin")]
    (host_twin, reclaim_twin, reclaim_tpl_twin, loop_twins, tiers_cpu,
     reclaim_tpl_cpu, reclaim_o_twin) = twins
    # K2's plain version on the ladder flagship's shape: its child builds
    # the cluster now and waits for the last timed phase.
    ladder_plain = BackgroundChild(out_dir, "mq_ladder_plain", opts)
    # K2's plain version on twins of the full-size operands below, likewise.
    full_plain = BackgroundChild(out_dir, "full_size_plain", opts)
    default_twin = synthetic = wave = daemon = mesh_child = parity_child = None

    try:
        # The same operands again, from second clusters built the same way (K2
        # first: its profiler traces come before the other kernels' many).
        static_full, eng2 = phase_full_size(config2_cluster(), CONFIG2_CONF, device,
                                            "config2_main_path_operands")
        cursor_full, eng_b = phase_full_size(flagship_cluster(), FLAGSHIP_CONF, device,
                                             "main_path_operands")
        # K2's mesh mode (path s) on the same operands, timed.
        mesh_k2 = compare("mesh_main_path_operands", eng_b._mega_args,
                          dict(eng_b._mega_kw, mesh=mesh_of(MESH_SHARDS)), eng_b.st.nodes.count,
                          len(eng_b.queue_uids), timed=True, plain=False)
        del eng_b
        gc.collect()
        mq_full, _ = phase_full_size(mq_flagship_cluster(), MULTIQ_CONF, device,
                                     "multi_queue_main_path_operands")
        gc.collect()
        config5_full, _ = phase_full_size(config5_cluster(), CONFIG2_CONF, device,
                                          "config5_main_path_operands")
        tiers_full, _ = phase_full_size(default_tiers_cluster(), DEFAULT_TIERS_CONF, device,
                                        "config2_default_tiers_main_path_operands")
        gc.collect()
        ladder_recs, ladder_solve = phase_ladder_full_size(ladder_cluster(), device)
        gc.collect()
        reclaim_full, _ = phase_full_size(reclaim_cluster(), RECLAIM_CONF, device,
                                          "reclaim_aftermath_main_path_operands")
        gc.collect()
        qfair_err = phase_qfair_cases(device)
        pred_main, pred_wide, pred_err = phase_predicate_cases(eng2.st, device)
        # c's operands (its loop parity runs after the go, ``loop_parity``).
        _, eng3 = engine_for(templates_cluster(), FLAGSHIP_CONF, device, engine="step")
        step_recs = phase_step_kernel_cases(eng3, eng2, device)
        k1_shard = k1_shard_record(eng3)
        xla_cases = phase_xla_step_cases(device)
        xla_shard = xla_shard_record("xla_step_operands_1024_r2", xla_shard_operands(),
                                     XLA_STEP_FLAGS)
        del eng2, eng3
        gc.collect()
        # After the last timed phase: K2's plain version on the ladder
        # flagship's operands and on the full-size twins, beside the untimed
        # phases.
        ladder_plain.go()
        full_plain.go()
        # The mesh paths s-v and c's and j's loop parity, beside the untimed
        # phases that follow.
        mesh_child = BackgroundChild(out_dir, "mesh_paths", opts)
        parity_child = BackgroundChild(out_dir, "loop_parity", opts)
        synthetic = BackgroundChild(out_dir, "kernel_cases_synthetic", opts)
        # Path o' (in o's twin, on the card), path p (the backfill wave) and
        # paths q and q' (the daemon over the wire), host-bound: beside the
        # small cases, the kernel cases, the checks, the plain checks and
        # the longest twin.
        reclaim_o_twin.go()
        wave = BackgroundChild(out_dir, "backfill_wave", opts)
        daemon = BackgroundChild(out_dir, "daemon_wire", opts)
        phase_e2e_small(conf_path)
        full_chain = phase_kernel_cases(device)
        gc.collect()
        # Path m's cold twin beside the untimed phases that follow.
        default_twin = BackgroundChild(out_dir, "default_conf_cold", opts)
        check_host_loop(host_twin, tiers_binds)
        check_host_loop(host_twin, tiers_device["binds"], "config2_default_tiers_device")
        check_reclaim_host_loop(reclaim_twin, reclaim["outcome"])
        check_cpu_codes(tiers_cpu, tiers_tpl["codes"], "templates_default_tiers")
        check_cpu_codes(reclaim_tpl_cpu, reclaim_tpl["codes"], "reclaim_aftermath_templates")
        check_reclaim_host_loop(reclaim_tpl_twin, reclaim_tpl["outcome"],
                                "reclaim_aftermath_templates")
        check_loop_host_twins(loop_twins)
        check_default_conf_twin(default_twin, default_loop)
        emit({"phase": "kernel_cases_synthetic", "cases": synthetic.result()["cases"],
              "wall_s": time.perf_counter() - synthetic.t0})
        o_dev = check_config4_reclaim_twin(reclaim_o_twin, reclaim_o)
        wave_rec = wave.result()
        emit({"phase": "backfill_wave", "wall_s": time.perf_counter() - wave.t0})
        daemon_rec = daemon.result()
        emit({"phase": "daemon_wire", "wall_s": time.perf_counter() - daemon.t0})
        ladder_plain_rec = ladder_plain.result()
        emit({"phase": "mq_ladder_plain", "wall_s": time.perf_counter() - ladder_plain.t0,
              "after_go_s": time.perf_counter() - ladder_plain.t_go})
        plain_recs = full_plain.result()
        merge_plain([static_full, cursor_full, mq_full, config5_full, tiers_full, reclaim_full],
                    plain_recs)
        parities = parity_child.result()
        mesh = mesh_child.result()
        if mesh["s"]["digest"] != flagship_digest or mesh["s"]["binds"] != flagship_binds:
            raise SystemExit("path s: the mesh cycle's binds differ from path b's")
    finally:
        for twin in twins + [ladder_plain, full_plain, default_twin, synthetic, wave, daemon,
                             mesh_child, parity_child]:
            if twin is not None:
                twin.stop()
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    m_launches = {k: sum(c["launches"][k] for c in default_loop["cycles"])
                  for k in ("mega_allocate", "static_predicate_mask", "qfair_solve")}
    # Path o's K2 runs in releasing mode only where its reclaim leaves
    # releasing capacity at allocate (its pipelines take what they free).
    o_mode = ("multi_queue_releasing"
              if reclaim_o["record"]["releasing_nodes_at_allocate"] else "multi_queue")
    o_k2 = {"config4_reclaim": reclaim_o["launches"]["mega_allocate"],
            "config4_reclaim_device": o_dev["launches"]["mega_allocate"]}
    emit({"kernels": [
        mega_entry("cursor", flagship_launches["mega_allocate"], cursor_full, by_path={
            "config3": flagship_launches["mega_allocate"],
            "config3_steady": steady["launches"]["mega_allocate"],
            "config3_churn": steady["churn_launches"],
            "daemon_churn": daemon_rec["churn"]["launches"]["mega_allocate"]}),
        mega_entry("static", config2_launches["mega_allocate"], static_full,
                   by_path={"config2": config2_launches["mega_allocate"],
                            "daemon_config2": daemon_rec["q"]["launches"]["mega_allocate"]}),
        mega_entry("static", config5_launches["mega_allocate"], config5_full, "config5"),
        mega_entry("multi_queue", mq_launches["mega_allocate"], mq_full,
                   "config3_multi_queue", by_path={
                       "config3_multi_queue": mq_launches["mega_allocate"],
                       **(o_k2 if o_mode == "multi_queue" else {})}),
        mega_entry("multi_queue_static", tiers_launches["mega_allocate"], tiers_full,
                   "config2_default_tiers", by_path={
                       "config2_default_tiers": tiers_launches["mega_allocate"],
                       "default_conf_loop": m_launches["mega_allocate"]}),
        ladder_entry(ladder_launches["mega_allocate"], ladder_recs, ladder_plain_rec),
        mega_entry("multi_queue_releasing", reclaim["launches"]["mega_allocate"], reclaim_full,
                   "config4_reclaim_aftermath", by_path={
                       "config4_reclaim_aftermath": reclaim["launches"]["mega_allocate"],
                       **(o_k2 if o_mode != "multi_queue" else {})}),
        # The full-recompute chain is the kill-switch: no main path runs it.
        mega_entry("multi_queue_full", 0, full_chain["ladder_small"],
                   "ladder_{}_x_{}_{}q kernel case".format(*LADDER_SMALL)),
        qfair_entry({"mq_ladder": ladder_launches["qfair_solve"],
                     "config3_multi_queue": mq_launches["qfair_solve"],
                     "config2_default_tiers": tiers_launches["qfair_solve"],
                     "default_conf_loop": m_launches["qfair_solve"],
                     "production_conf": production["launches"]["qfair_solve"],
                     "config2_default_tiers_device": tiers_device["launches"]["qfair_solve"],
                     "config4_reclaim": reclaim_o["launches"]["qfair_solve"],
                     "config4_reclaim_device": o_dev["launches"]["qfair_solve"],
                     "preempt_storm": storms["launches"]["qfair_solve"]},
                    ladder_solve, qfair_err),
        {"name": "static_predicate_mask", "route": "cuda",
         "source": "scheduler_tpu_torch/csrc/static_predicate_mask.cu",
         "replaces": "scheduler_tpu/ops/pallas_kernels.py:292",
         "launches": config2_launches["static_predicate_mask"],
         "launches_by_path": {
             "config2": config2_launches["static_predicate_mask"],
             "daemon_config2": daemon_rec["q"]["launches"]["static_predicate_mask"],
             "config5": config5_launches["static_predicate_mask"],
             "config2_default_tiers": tiers_launches["static_predicate_mask"],
             "default_conf_loop": m_launches["static_predicate_mask"],
             "production_conf": production["launches"]["static_predicate_mask"],
             "config2_default_tiers_device":
                 tiers_device["launches"]["static_predicate_mask"],
             "backfill_wave": wave_rec["launches"]["static_predicate_mask"],
             "backfill_wave_eighth": wave_rec["eighth_launches"]["static_predicate_mask"]},
         "max_abs_err": max(pred_err, wave_rec["k3"]["max_abs_err"]),
         **{k: pred_main[k] for k in PREDICATE_TIMES},
         "wide": {k: pred_wide[k] for k in ("S", "N", "L", "K") + PREDICATE_TIMES},
         "backfill_wave": {k: wave_rec["k3"][k] for k in ("S", "N", "L", "K") + PREDICATE_TIMES}},
        step_entry({"config3_templates": templates_launches["placement_step"],
                    "templates_multi_queue": mq_tpl["launches"]["placement_step"]},
                   step_recs[0], step_recs, [parities["c"], parities["j"]]),
        place_scan_entry({"production_conf": production["launches"]["place_scan"],
                          "config2_default_tiers_device": tiers_device["launches"]["place_scan"]},
                         production["scan"], tiers_device["scan"]),
        xla_entry({"templates_default_tiers": tiers_tpl["launches"]["xla_step"],
                   "reclaim_aftermath_templates": reclaim_tpl["launches"]["xla_step"]},
                  {"templates_default_tiers": tiers_tpl["xla"],
                   "reclaim_aftermath_templates": reclaim_tpl["xla"]},
                  xla_cases, [tiers_tpl["check"], reclaim_tpl["check"]]),
        lp_entry(lp_paths),
        *mesh_entries(mesh, plain_recs["main_path_operands"], mesh_k2, k1_shard, xla_shard,
                      lp_paths["r'"]["blocks"]),
    ]}, stamp=False)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}, stamp=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
