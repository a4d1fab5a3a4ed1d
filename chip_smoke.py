#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kubegpu_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kubegpu_tpu_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives the port's two main paths: serving at the width of the
repository's serving benchmark (vocab 8192, d_model 2048, 16 heads, 6
layers, d_ff 8192, max_seq 1024) and training at the width of its
headline training configuration (``bench.py``'s first ``tpu`` candidate:
vocab 8192, d_model 2304, 18 heads, 6 layers, d_ff 12288, batch 4,
T = 2048, no remat), random weights from a seed:

1. device: the card's name and power limit (nvidia-smi);
2. build: the nvcc build and its seconds;
3. kernel: the flash-attention forward against ``flash_attention_plain``
   at the shape of every path that launches it (serving, training, MoE
   training, the entry) and at masking edge cases (one tile; several
   stages over a ragged T = 2085), each row naming the kernel instance
   that ran, with its time (and through the ``torch.ops.kgt.flash_fwd``
   operator the model calls), the previous (mma.sync) design's time at the
   same shape, the plain version's, ``scaled_dot_product_attention``'s (a
   yardstick the port never calls) and the least time the card could
   take; then decode_attn: K4, the decode attention over the bf16 KV
   cache, against ``decode_attention_plain`` at the serving cells' shapes
   (B 128 and 64, S_max 4096, 32 query heads over 8 kv heads of 128;
   reasoning's with positions uniform over 300-1500 and with the pool
   full, the chat's and longprompt's), each row with its ms, its bound
   (the live K/V bytes over the card's bandwidth), the plain version's
   ms, ``scaled_dot_product_attention``'s (a yardstick the port never
   calls) and the ms at each split length of the sweep that chose
   ``decode_attn.SPLIT_LEN``; each case's relative L2 error must stay
   under TOL_DECODE_REL and the same case with K/V rounded through
   float8 e4m3 must exceed it;
4. forward: the full-width forward pass on tokens [4, 1024] through the
   kernel (one launch per layer), against the same forward with the plain
   attention;
5. entry: the port's ``entry()`` forward on the card;
6. serve: the continuous-batching server on the benchmark's traffic (4
   slots, 8 prompts of 16..512 tokens, 64 new tokens each, greedy); the
   fused data plane's streams against the per-token oracle's;
7. kernel_bwd: the flash backward (K2 dQ with the row term delta, K3
   dK/dV) through the autograd Function against
   ``flash_attention_bwd_plain`` at the training and MoE training shapes
   and at masking edge cases (the same new ones as the forward's), each
   row naming K2's and K3's instances and holding the delta K2 hands K3
   against ``_delta``; with K2's, K3's and K1's times there, their previous
   designs' (K2's with the ``_delta`` pre-pass it needs), the pre-pass's
   alone, their plain versions', ``scaled_dot_product_attention``'s
   backward (a yardstick the port never calls; it includes its own
   pre-pass, so it stands against K2 + K3) and the bounds;
8. train: per-leaf gradient errors of the bf16 kernel path and the bf16
   plain-attention path against a float32 plain-attention reference on
   one batch, then 5 AdamW steps of ``make_train_step`` (step ms,
   tokens/s, MFU, losses, kernel launches per step, calls of the
   ``_delta`` pre-pass, which the sm90 K2 leaves none of), then
   ``remat="full"`` against ``remat="none"`` on one batch (loss and
   per-leaf gradients) and one step with ``remat="full"``; the batches
   come from the native token loader (``make_loader``);
9. train_remat_dots: ``remat="dots"`` against ``remat="none"`` on one
   batch at the training config (loss and per-leaf gradients, and the
   flash launches of the dots pass: one K1, K2 and K3 a layer, all sm90,
   so the recompute never reruns K1), then AdamW steps of each of none,
   dots and full with their median time and peak memory;
10. loader: the native token loader's first 8 batches against
   ``PyTokenLoader``'s, bit for bit;
11. serve_sampled: the server on the serve phase's traffic, sampling
   (temperature 0.8, top_k 50, top_p 0.95): the fused streams against the
   per-token oracle's, against another chunk size and against the reverse
   admission order, and the key hash's bits on the card against the CPU's;
12. serve_spec: the speculative server on the same traffic with a 1-layer
   draft (d_model 512, d_ff 2048, lookahead 4, 4 rounds a dispatch): in
   float32 its greedy streams against the plain server's and a self-draft
   (draft = target) sampled run whose acceptance must be 1.0; in bf16 its
   tokens/s and acceptance, sampled;
13. serve_prefix: 8 requests sharing a 128-token system prompt with tails
   of 16..256 tokens, greedy in float32, with ``prefix_cache_size`` 8
   against no cache: equal streams and 7 prefix hits;
14. train_lora: LoRA fine-tuning at the training config (rank 16 on wq and
   wv, ``make_lora_train_step``, batches from the native loader), 5 steps:
   falling finite losses, 6 K1, K2 and K3 sm90 launches a step, every base
   leaf without a gradient and with its bits unchanged, step ms and peak
   memory beside the train phase's (remat none);
15. checkpoint: the LoRA state saved after 2 of 4 steps and resumed (the
   resumed losses equal the uninterrupted run's, bit for bit), and the
   training config's full ``{params, opt_state}`` (8.1 GB) saved and
   restored as serve_demo restores it (params only, the AdamW moments as
   shapes), with the seconds of each: the leaves' bits and the greedy
   streams served from the restored params equal the in-memory ones;
16. moe: the ``moe`` preset's routing (4 experts, top-2) at the serving
   width: a forward at [4, 1024] (6 K1 launches), 3 AdamW steps at B 4,
   T = 2048 (6 K1, K2 and K3 sm90 launches each, falling finite losses, the
   aux term at least 1 a layer, step ms and peak memory), and a float32
   greedy drain whose fused streams equal the per-token oracle's;
17. ring_kernels: K1, K2 and K3 as ring attention runs them, at the
   training shape (B 4, T 2048, 18 heads, head_dim 128, bf16, causal) with
   sp = 4 and sp = 2 through the in-process seq axis
   (``ring.InProcessSeqAxis``): every (q_offset, kv_offset) pair the ring
   gives, with a random lse cotangent, against the plain versions (the
   blocks of the future give O = 0, lse <= -1e20 and zero gradients);
   then the merged ring (sp^2 sm90 launches of each kernel a pass) and its
   q/k/v gradients against a float32 plain reference of the whole
   sequence: the output within 1.25x (mean) and 2x (max) of the
   single-shard kernels' error, the gradients within the same ratios of
   the same ring run through the plain versions; its forward + backward
   ms beside the single-shard kernels';
18. tp_heads: K1, K2 and K3 on the head spans of tensor parallelism over
   head counts tp does not divide, at the training shape (B 4, T 2048, 18
   heads, head_dim 128, bf16, causal) with tp = 4 (576 columns a rank,
   4.5 heads; each rank attends the 5 heads its columns overlap) and tp =
   2, every virtual rank in one process (``model.tp_attention_in_process``:
   every virtual rank's ``model.span_attention`` times its ``wo`` rows,
   summed; autograd sums the ranks' q/k/v cotangents as the sharded
   block's reduce-scatter does): the sum and the q/k/v gradients against a
   float32 plain reference, within 1.25x (mean) and 2x (max) of the
   error of the single-device kernels over all 18 heads (the product with
   ``wo`` split into the same partial sums) and of the same in-process
   pass through the plain versions; tp sm90 launches of each kernel a pass;
   each rank's K1 and K2 + K3 ms beside the 18-head kernels' ms over tp;
19. train_mesh: a world-size-1 NCCL process group (a ``file://`` store
   in a temporary directory), ``dryrun_multichip`` over the card, then the
   sharded train step at the training config (dp = sp = tp = 1): its loss
   and per-leaf gradients on one batch against the single-device step's
   (the remat tolerances), 6 K1, K2 and K3 sm90 launches, and 5 AdamW
   steps from the native loader, median step ms beside the train phase's;
20. serve_mesh: in the same group, the serving config in float32 over the
   (1, 1, 1) mesh: the sharded ``make_generate`` on 4 rows of the serve
   phase's prompts, the sharded server on its traffic and the sharded
   speculative server (the serve_spec phase's draft, sharded over the same
   mesh), each equal to the same call without a mesh; bf16 tokens/s of the
   mesh server and the plain one, beside the serve phase's. Then
   the sharded resume at the training config: 2 steps of the sharded train
   step, ``save_checkpoint(..., mesh)``, 2 more; freshly initialised shards
   restored with ``restore_checkpoint(..., mesh)`` take the same 2 steps,
   their losses equal to the uninterrupted run's bit for bit, with 6 K1,
   K2 and K3 sm90 launches a step; the save and restore seconds beside the
   checkpoint phase's. Last, ``dryrun_multichip`` over the card, with its
   serving leg;
21. device_side: ``NVMLBackend().enumerate()`` on the card, its index,
   UUID, memory (MiB) and PCI bus id equal to what ``nvidia-smi
   --query-gpu=index,uuid,memory.total,pci.bus_id`` prints (N/A where the
   NVML withholds the bus id, on both sides) and ``/dev/nvidia<minor>``
   present; ``GPUDeviceManager.update_node_info`` advertising every card,
   the node annotation equal after the codec's round trip;
   ``GPUScheduler.pod_fits_device`` placing a ``numgpu: 1`` pod and
   refusing one card more than the host has with a reason naming
   ``alpha.gpu/numgpu``; ``GPURuntimeHook`` over a dict-backed API
   rewriting a config with a stale ``/dev/nvidia9`` entry and a one-rank
   gang annotation (the card's ``/dev/nvidia<minor>``, ``nvidiactl``,
   ``nvidia-uvm``; ``CUDA_VISIBLE_DEVICES`` = the UUID, ``MASTER_ADDR``,
   ``MASTER_PORT``, ``WORLD_SIZE`` 1, ``RANK`` 0, ``LOCAL_RANK`` 0); then,
   with exactly the hook's env, a subprocess that sees one card whose UUID
   is the allocated one. Then the port's own node agent
   (``python -m kubegpu_tpu_torch.cmd.node_agent --backend nvml``, started
   without the device and process variables, from the checkout's root)
   on its default wire, the stream wire, over the port's own API server
   in this process (``serve_api`` over the port's ``InMemoryAPIServer``,
   both wires): the server dispatched the agent's requests
   (``api_requests_total``) and the agent's ``/metrics`` shows
   ``transport_bytes_total`` under ``wire="stream"`` alone; its
   advertised inventory equals the
   in-process one, with a heartbeat, and ``/healthz`` answers 200; the
   tx and rx bytes of an advertise pass, and the median round trip of 50
   ``patch_node_metadata`` calls carrying the card's real annotation on
   each wire in turns (the port's client in this process);
   ``python -m kubegpu_tpu_torch.cmd.cri_hook --server``
   rewrites the stale config as the in-process hook does, and exits
   non-zero with a 409 naming ``AllocationMismatch`` for a pod that asks
   for one card more than it was allocated; the port's scheduling engine
   (``scheduler/core.py``, in this process, over the server's store)
   places the agent's pod, a gang of one, on the
   node from the annotation the agent advertised and writes its process
   contract; ``POST /v1/launch-container`` runs ``python -m
   kubegpu_tpu_torch.cmd.train_demo`` at the training config for 3 steps
   (the sharded step over an NCCL group formed from the hook's env of the
   engine's contract), which exits 0 with finite
   losses and 18 sm90 launches each of K1, K2 and K3, counted in that
   process from zero (``launches_node_agent_run``), and whose
   ``pod.alpha/ContainerStatus`` in the server says exited 0; SIGTERM
   stops the agent with exit 0 within 10 s, and the server poisoned no
   stream connection and refused no upgrade. Last, a second agent against
   the port's server without the stream wire, which answers the upgrade
   with plain HTTP: it negotiates down to JSON once (the server refused
   one upgrade; no stream byte, no stream subscriber or pushed batch) and
   advertises the same annotations. The
   ``control_plane_wire`` line gives, for each wire, start to first
   advertise, bytes per advertise pass and the patch round trip, beside
   the card's name and power limit;
22. scheduler: first the allocator core on this host (its
   ``scheduler_allocator`` line): ``os.cpu_count()``, the median ms per
   search of the native route and of the plain Python path on 1-, 2-, 4-
   and 8-card pods over one HGX host with the C call's share, and 120
   seeded random problems on which both agree in fit, score, placements
   and reasons. Then the port's scheduling engine in process, over dicts,
   on its default path (the batch cycle and the masked pass), every
   allocator search counted: the phase fails unless all went to the
   native core (``allocator_searches``). A gang of one
   1-card pod more than the card's host (NVML) has cards leaves every
   member unbound; with a ``fake.rig_inventory`` host added the gang
   binds, one card each, ranks 0.. in name order, the count the gang's
   size and the coordinator rank 0's node. Then host times of this
   machine: p50, p95 and max ms of a scheduling cycle for 256 count-mode
   pods of 1, 2, 4 and 8 cards over 64 ``fake.hgx_h100_inventory`` hosts,
   submitted one at a time, on the default path and on the scalar oracle
   (``KGTPU_BATCH=0 KGTPU_VECTORIZE=0``): placements equal card for card,
   the masked pass serving at least 90% of the default path's cycles with
   no node falling back to the scalar chain; the plan ms and commit ms of
   a 16-member gang of 8-card pods over 16 HGX hosts; the auto-topology
   stream (4-card pods a and b on an HGX board, then c) with c bound to
   the PCIe host; and a mass arrival, 1000 pods of 1, 2, 4, 1 cards
   (2000 cards) created before the first pass onto 1024 HGX hosts (8192
   cards): every pod bound on the default path, its seconds and pods/s,
   the oracle's pods/s over what it binds in 30 s, and the allocator
   searches a bound pod on each path (counted at ``pod_fits_device``).
   Then two legs, each printing its own line: gang preemption (16 HGX
   hosts full of 1-card pods, priority 10 but on 4 hosts priority 0, one
   of those under a PDB allowing no disruption; a gang of 3 x 8 cards at
   priority 5 evicts the 24 pods of the 3 unguarded hosts and binds
   there: the ``gang_preempt`` span's ms, sets tried, plans and victims,
   and first eviction to the gang bound), and the tenant quota gate (64
   HGX hosts, weights a:b = 2:1, 400 one-card pods of each tenant before
   the first pass: a binds 341 cards and b 170, the seconds to that state
   and ``quota_parked_total``; the 256-pod stream of one tenant with the
   gate on and off, equal placements and each one's p50);
   scheduler_binary: ``kgtpu-gpu-scheduler`` over the port's API server
   in this process: two
   ``--leader-elect`` binaries, the leader binds the node agent's pod,
   which trains 3 steps (18 sm90 launches of each kernel), the standby
   takes over after a SIGKILL, a ``--wire json`` binary binds over the
   long poll; then the node lifecycle leg: ``--node-grace-s 3
   --node-stale-s 1`` with two agents on the card under two node names,
   a gang of one bound to A, A's agent SIGKILLed, A Stale then Lost and
   deleted, the pod requeued without cards or contract and bound to B,
   the requeued copy's cleared allocation refused by B's hook with
   ``AllocationMismatch``, and the pod trained 3 steps through B's hook
   (18 sm90 launches of each, ``launches_lifecycle_run``): kill to Lost
   and Lost to rebound seconds, the pod's seconds, and the binary's
   ``scheduler_node_lost_total`` and ``scheduler_evictions_total``; then
   the repair leg (its own line): ``--repair --tenant-quota`` with a
   config declaring a filter extender (a stub here) that vetoes a third
   node with no agent, the pod bound to A trains 3 steps with
   ``--checkpoint-dir D --checkpoint-every 3`` (one save, of the step
   the resume reads), A's card is reported
   failed (A's agent SIGSTOPped, this process running the advertiser's
   pass with the card failed), the controller stamps the checkpoint
   request, evicts and requeues the pod, which binds to B and resumes
   from the step-3 checkpoint for 3 more steps (18 sm90 launches of
   each, ``launches_repair_run``): failure to eviction seconds, eviction
   to rebind ms, the resumed first step, ``scheduler_repairs_total`` and
   the extender's calls;
   control_plane: the port's own control plane, every part a subprocess:
   ``kgtpu-gpu-apiserver --wal-dir D --apf`` on the stream wire, 1024
   fake HGX hosts registered through the port's client, the node agent
   on this card, and two ``kgtpu-gpu-scheduler --replicas 2 --shard I``;
   a 1-card pod placed on the card's node trains 3 steps through the
   agent (18 sm90 launches of each, ``launches_control_plane_run``); the
   mass arrival's 1000 pods each bound once with no card held twice
   (seconds to all bound, pods/s, each replica's commits and conflicts);
   the server SIGKILLed and restarted on its port and WAL (seconds to
   ``/healthz``, nodes and pods equal to before, a new pod bound by the
   replicas, a ``/bindmany`` claiming the trained pod's card refused 409
   naming it); one tenant's create flood shed with 429s while node
   PATCHes pass (their p50/p99, idle and under the flood); and the same
   burst with one replica on a fresh server;
   proxy_simulate: the watch-cache proxy tier with the card behind it,
   every process the port's: ``kgtpu-gpu-apiserver --wal-dir D`` and two
   ``kgtpu-gpu-proxy --apf`` replicas (p0, p1); 256 fake HGX hosts
   registered through p0, the node agent on this card against p1, one
   ``kgtpu-gpu-scheduler`` against p0; a 1-card pod created through p1,
   bound as p1's watch shows, trains 3 steps through the agent (18 sm90
   launches of each, ``launches_proxy_run``); 512 stream watchers, 256 on
   each proxy, see each of 200 new pods bound in seq order with no relist
   while the API server holds no more connections than without them (their
   delivery p50/p99 from the create, each proxy's upstream lag, upstream
   bytes against the bytes the watchers received); then
   ``kgtpu-gpu-simulate --json`` runs: the default mix on 4 hosts with 2
   replicas, node-loss, chip-kill, the HA scenario and the tenant flood
   behind 2 proxies, each document checked and printed;
   explorer: every race twin of ``analysis/races.py`` under the
   interleaving explorer on this host, the card scenarios keyed by this
   card's UUID (a fake HGX card beside it on a one-card machine): each
   mutant rediscovered within its budget, each clean scenario passing
   every schedule, a ``twin`` line each (schedules, failing index,
   schedules/s); then ``kgtpu-gpu-apiserver``, 8 fake HGX hosts, the node
   agent on this card and two ``kgtpu-gpu-scheduler --replicas 2
   --lease-ttl 1`` on each wire in turn: a 1-card pod on the card trains
   3 steps through the agent (18 sm90 launches of each,
   ``launches_explorer_run``), then the sharded test's mix (a gang of two
   4-card members and 40 one-card pods) bound 10 times in a row, each pod
   once, no card twice, both replicas committing;
   kube: the port's real-Kubernetes client (``cluster/kubeclient.py``)
   against its mock Kubernetes API server (``cluster/mock_kube.py``,
   bearer auth, a JSON kubeconfig through ``KubeConfig.load``): the port's
   advertiser patches the card's node from NVML and 16 fake HGX hosts, the
   port's engine binds a 1-card pod on the card through the Binding
   subresource, the runtime hook gives it ``CUDA_VISIBLE_DEVICES`` and the
   port's supervisor trains it 3 steps (18 sm90 launches of each,
   ``launches_kube_run``); a burst of 200 pods of 1-8 cards onto the fake
   hosts (each deleted once bound: its seconds, create-to-bound p50/p99,
   the engine's requests per bind); a fresh engine replaying the watch
   charges no card twice; a card taken behind the engine's back refuses
   its bind, the stamp is withdrawn and the pod binds to another card;
23. checkers: ``python -m kubegpu_tpu_torch.analysis --stats`` over the
   port's tree (0 findings from 17 rules, twin-coverage,
   mirror-maintenance and reason-parity among them; their seconds); then
   the full mutation sweep, ``python -m kubegpu_tpu_torch.analysis
   --mutate --format json`` (its own line, ``checkers_mutation``:
   mutants, killed, waived, survivors, seconds; no unwaived survivor);
   then, under the dispatch/sync/build counter
   (``analysis/dispatchcount.py``), a float32 greedy drain of the serve
   phase's traffic at full width, fused and through the per-token oracle:
   equal streams, the fused syncs one a chunk plus one an admission and
   within 1.5/chunk a token, the oracle's at least one a decode step, no
   kernel build after a warm-up drain; then one training step at the
   training config, whose ``kgt.flash_fwd`` and ``kgt.flash_bwd``
   dispatches (the backward's on the autograd engine's thread) equal K1's
   and K2's own launch counts, 6 each (``launches_checkers_step``,
   ``dispatches_checkers_step``).

The ``kernels`` line names each kernel's instance on the main path and
the launches that went to each instance (``launches_serve_mesh_step``:
the last resumed sharded step's; ``launches_tp_heads_pass`` (``_tp2``):
the tp_heads in-process pass at tp = 4 (2)). Every phase prints one JSON line
and raises on failure. The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

# (B, T, H, D) and traffic of the serving benchmark's chip sizing
MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=6, d_ff=8192,
             max_seq=1024)
SLICE_SHAPE = (4, 1024, 16, 128)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_MAX_NEW = 4, 8, 64
FORWARD_TOKENS = (4, 1024)
# the training path: bench.py's headline training config (tpu ladder, first
# candidate), batch 4 at T = 2048, no remat
TRAIN_MODEL = dict(vocab=8192, d_model=2304, n_heads=18, n_layers=6,
                   d_ff=12288, max_seq=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 18, 128)

# H100 SXM published peaks (dense): bf16 tensor cores, float32 FMA, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances. float32: the kernel and the plain version differ only in
# summation order. bf16: both round O to bf16 (one ulp is 1.6e-2 for
# |O| in [2, 4); |O| <= max |v|) after rounding P to bf16 at different
# points (the kernel against its running max, the plain version against
# the row max); lse stays float32 in both.
TOL_F32 = 1e-4
TOL_BF16_O = 2e-2
TOL_BF16_LSE = 1e-3
# K4 against its plain version: the largest relative L2 error of a row of
# the bf16 output. Both round O to bf16 after rounding P to bf16 at
# different points (the kernel against its split's running max, the plain
# version after normalising): about 0.3% at the serving shapes. K/V stored in float8
# e4m3, the control each case also runs, give about 3.7%; V at each row's
# pos and window start is set to DECODE_EDGE_V, so a dropped key there
# errs by 20% or more.
TOL_DECODE_REL = 1e-2
DECODE_EDGE_V = 16.0
# Full forward (logits of unit scale): in bf16 the kernel's path may be
# at most 1.25x (mean) and 2x (max) as far from the float32 forward as the
# plain attention's bf16 path is; in float32 the two paths differ only in
# summation order, amplified through 6 random layers, so 1e-3.
TOL_FWD_MEAN_RATIO = 1.25
TOL_FWD_MAX_RATIO = 2.0
TOL_FWD_F32 = 1e-3
# Backward kernels against the plain backward, per output (dq, dk, dv):
# max |delta| over max |ref|. bf16: both versions round P and dS to bf16
# after float32 sums taken in another order, and round the output to
# bf16; float32: summation order only.
TOL_BWD_BF16 = 1e-2
TOL_BWD_F32 = 1e-4
# The delta K2 emits against `_delta` on the same (o, dO, dlse): both sum
# float32 products of the same bf16 or float32 values, in another order,
# so within 1e-4 of the largest |delta|.
TOL_DELTA = 1e-4
# Training gradients: the bf16 kernel path's per-leaf relative L2 error
# against the float32 plain-attention gradients may be at most 1.25x the
# bf16 plain path's, in the median over leaves and for the worst leaf.
# Remat "full" replays the same forward in the backward: on the same params
# and batch its loss within 1e-3 (relative) of remat "none"'s, and every
# leaf's gradient within 1e-2 relative L2 of remat "none"'s, under half
# the bf16 path's own error against float32 (median 0.025); a recompute
# that breaks errs by order 1.
TOL_GRAD_RATIO = 1.25
TOL_REMAT_LOSS = 1e-3
TOL_REMAT_GRAD = 1e-2
# Remat "dots" replays the same operations with the kept outputs returned
# as they were, so the same tolerances hold for it.
# The serving phases of this slice: sampling settings, the draft model,
# and the prefix traffic (a 128-token system prompt, tails of 16..256).
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
DRAFT_MODEL = dict(MODEL, d_model=512, d_ff=2048, n_layers=1)
SPEC_LOOKAHEAD, SPEC_ROUNDS = 4, 4
PREFIX_SYSTEM, PREFIX_TAILS, PREFIX_CACHE = 128, (16, 256), 8
LOADER_BATCHES = 8
REMAT_STEPS = 3
# LoRA: rank 16 on the default targets (wq, wv), alpha = rank. The
# optimizer is AdamW at lr 1e-2, the rate of the reference's own LoRA test
# (tests/test_lora.py): at the full-tuning rate of 3e-4 five steps move a
# zero-initialised B too little to lower the loss beyond batch-to-batch
# noise.
LORA_RANK, LORA_STEPS, LORA_LR = 16, 5, 1e-2
# checkpoint: the LoRA run saves after CKPT_SAVE_AT of CKPT_STEPS steps; the
# full train state's round trip is the training config's (675M parameters,
# an 8.1 GB file with the AdamW moments) after CKPT_FULL_STEPS steps
CKPT_SAVE_AT, CKPT_STEPS, CKPT_FULL_STEPS = 2, 4, 2
# moe: the moe preset's routing at the serving width
MOE_MODEL = dict(MODEL, n_experts=4, moe_top_k=2)
MOE_STEPS = 3
# (B, T, H, D) of the MoE steps: the kernel phases hold K1-K3 against their
# plain versions at the shape of every path that launches them (forward
# and serving: SLICE_SHAPE; training, LoRA, checkpoint: TRAIN_SHAPE; moe:
# SLICE_SHAPE and MOE_TRAIN_SHAPE; entry: ENTRY_SHAPE)
MOE_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, MOE_MODEL["n_heads"],
                   MOE_MODEL["d_model"] // MOE_MODEL["n_heads"])
ENTRY_SHAPE = (2, 128, 8, 32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, runs: int = 20, batch: int = 5, warmup: int = 3) -> float:
    """Median over ``runs`` of the mean CUDA-event time of ``batch``
    back-to-back calls of ``fn``, after warm-up. Back to back, the host
    enqueues the next call while the device runs this one, so the
    wrapper's host overhead stays out of the time unless it exceeds the
    device's."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    times.sort()
    return times[len(times) // 2]


def visible_pairs(tq, tk, q_offset, kv_offset, causal, window) -> int:
    """(q, k) pairs the mask lets through: the work the kernel must do."""
    from kubegpu_tpu_torch.workload.kernels.flash import _mask

    mask = _mask(tq, tk, q_offset, kv_offset, causal, window, "cpu")
    return tq * tk if mask is None else int(mask.sum())


def attention_bound_ms(b, tq, tk, h, d, dtype, pairs) -> tuple:
    """Least time for the forward on an H100 SXM: the larger of q, k, v,
    o and lse moved once over the memory rate and 4 * D operations per
    visible pair over the tensor-core (bf16) or FMA (float32) peak."""
    import torch

    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    flops = 4 * d * pairs * b * h
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def case_qkv(gen, dev, b, tq, tk, h, d, dt, strided=False):
    """Random q [B, Tq, H, D], k, v [B, Tk, H, D] of type ``dt``; strided:
    views of one packed [B, T, 3, H, D] tensor (Tq = Tk)."""
    import torch

    f32 = torch.float32
    if strided:
        qkv = torch.randn((b, tq, 3, h, d), generator=gen, device=dev,
                          dtype=f32).to(dt)
        return qkv.unbind(2)
    q = torch.randn((b, tq, h, d), generator=gen, device=dev,
                    dtype=f32).to(dt)
    k, v = (torch.randn((b, tk, h, d), generator=gen, device=dev,
                        dtype=f32).to(dt) for _ in range(2))
    return q, k, v


def kernel_phase(dev) -> dict:
    """K1 against its plain version at the shapes of the paths and edge
    cases; times at the serving shape."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        _instance, _launch, flash_attention_plain, flash_attention_with_lse)

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, (B, Tq, Tk, H, D), dtype, kwargs
        *((name, (b, t, t, h, d), bf16, {}) for name, (b, t, h, d) in (
            ("slice_causal", SLICE_SHAPE), ("train_causal", TRAIN_SHAPE),
            ("moe_train_causal", MOE_TRAIN_SHAPE),
            ("entry_causal", ENTRY_SHAPE))),
        ("single_tile", (1, 64, 64, 1, 128), bf16, {}),
        ("ragged_multistage", (1, 2085, 2085, 2, 128), bf16, {}),
        ("non_causal", (2, 256, 256, 4, 128), bf16, dict(causal=False)),
        ("window_64", (2, 512, 512, 4, 128), bf16, dict(window=64)),
        ("offsets_96_32", (1, 256, 256, 4, 64), bf16,
         dict(q_offset=96, kv_offset=32)),
        ("all_future", (1, 128, 128, 2, 64), bf16,
         dict(q_offset=0, kv_offset=1000)),
        ("ragged_200", (2, 200, 200, 4, 64), bf16, {}),
        ("ragged_q70_k300_noncausal", (1, 70, 300, 2, 128), bf16,
         dict(causal=False)),
        ("head_dim_32", (2, 256, 256, 4, 32), bf16, {}),
        ("strided_qkv", (2, 256, 256, 4, 64), bf16, dict(strided=True)),
        ("f32_causal_window", (2, 200, 200, 4, 64), f32, dict(window=48)),
        ("f32_offsets", (1, 130, 96, 2, 128), f32,
         dict(q_offset=40, kv_offset=0)),
        ("f32_non_causal_d32", (2, 64, 100, 2, 32), f32,
         dict(causal=False)),
    ]
    out = {}
    for name, (b, tq, tk, h, d), dt, kw in cases:
        kw = dict(kw)
        q, k, v = case_qkv(gen, dev, b, tq, tk, h, d, dt,
                           kw.pop("strided", False))
        scale = d ** -0.5
        before = _instance_counts()
        o, lse = flash_attention_with_lse(q, k, v, scale, **kw)
        torch.cuda.synchronize()
        instance = _ran(before)[0]
        o_ref, lse_ref = flash_attention_plain(q, k, v, scale, **kw)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        if name == "all_future":
            ok = err_o == 0.0 and o.abs().max().item() == 0.0 \
                and lse.max().item() <= -1e20
            err_l = 0.0
        else:
            err_l = (lse - lse_ref).abs().max().item()
            tol_o, tol_l = (TOL_F32, TOL_F32) if dt == f32 \
                else (TOL_BF16_O, TOL_BF16_LSE)
            ok = err_o <= tol_o and err_l <= tol_l \
                and bool(torch.isfinite(o).all())
        ok = ok and instance == _instance(dt, d)
        row = {"phase": "kernel", "case": name, "dtype": str(dt)[6:],
               "shape": [b, tq, tk, h, d], "instance": instance,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l, "ok": ok}
        if name == "slice_causal":
            pairs = visible_pairs(tq, tk, 0, 0, True, 0)
            bound, bound_by = attention_bound_ms(b, tq, tk, h, d, dt, pairs)
            # the kernel through its wrapper, as K2 and K3 are timed;
            # "op_ms" adds the operator layer (torch.ops.kgt.flash_fwd)
            # that the model calls
            row.update(
                ms=time_ms(lambda: _launch(q, k, v, scale, 0, 0, True, 0)),
                op_ms=time_ms(lambda: flash_attention_with_lse(q, k, v,
                                                               scale)),
                previous_ms=time_ms(lambda: _launch(
                    q, k, v, scale, 0, 0, True, 0, instance="mma")),
                plain_ms=time_ms(
                    lambda: flash_attention_plain(q, k, v, scale)),
                library_ms=time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True)),
                bound_ms=bound, bound_by=bound_by)
            out = dict(row)
        emit(row)
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version on {name}: {row}")
    return out


# K4's cases: (name, B, S_max, Hq, Hkv, D, window, positions low, high):
# reasoning (Mistral, 128 slots, prompts 128-512 plus what they decoded),
# the same with the pool full, the chat (prompts lognormal about 1020
# tokens plus answers of about 129: "chat" draws them so) and longprompt
# (Mixtral, 64 slots, prompts 2048-3840 plus up to 160 decoded)
DECODE_ATTN_CASES = (
    ("reasoning", 128, 4096, 32, 8, 128, 4096, 300, 1500),
    ("reasoning_full", 128, 4096, 32, 8, 128, 4096, 4095, 4095),
    ("chat", 128, 4096, 32, 8, 128, 4096, None, None),
    ("longprompt", 64, 4096, 32, 8, 128, 0, 2048, 4000),
)
DECODE_ATTN_SPLITS = (64, 128, 256, 512, 1024)


def _decode_positions(b, lo, hi, seed=0):
    """Per-row positions: uniform over [lo, hi], or (lo None) the chat's
    prompt lengths (lognormal, median 1020, sigma 0.8, 32-3072) plus up
    to 129 decoded tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if lo is None:
        prompt = np.clip(rng.lognormal(np.log(1020), 0.8, b), 32, 3072)
        return (prompt + rng.integers(0, 130, b)).astype(np.int64)
    return rng.integers(lo, hi + 1, b).astype(np.int64)


def _rel_l2(got, want):
    """The largest relative L2 error of a row of ``got`` (all its heads)
    against ``want``'s, in float32, as a device scalar; a row where both
    are zero errs by 0. Per row, so one row's fault is not diluted by the
    others, nor hidden by a row that a planted edge value dominates."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    return ((got - want).norm(dim=1)
            / want.norm(dim=1).clamp_min(1e-30)).max()


@contextlib.contextmanager
def checked_decode_attn():
    """Inside, every K4 launch of the decode step also runs
    ``decode_attention_plain`` on its operands; after the block the
    yielded dict holds the launches checked and their largest relative L2
    error (None without a launch)."""
    from kubegpu_tpu_torch.workload import decode
    from kubegpu_tpu_torch.workload.kernels import decode_attn as da

    errs, real, seen = [], decode.decode_attention, {}

    def checked(q, k_cache, v_cache, pos, scale, window=0):
        out = real(q, k_cache, v_cache, pos, scale, window)
        errs.append(_rel_l2(out, da.decode_attention_plain(
            q, k_cache, v_cache, pos, scale, window)))
        return out

    decode.decode_attention = checked
    try:
        yield seen
    finally:
        decode.decode_attention = real
    seen["checked"] = len(errs)
    seen["max_rel_err"] = max(float(e) for e in errs) if errs else None


def _k4_checked_ok(seen) -> bool:
    return seen["checked"] > 0 and seen["max_rel_err"] <= TOL_DECODE_REL


def decode_attn_phase(dev) -> dict:
    """K4 against its plain version at the serving cells' shapes, with
    the float8 K/V control, timed beside its bytes bound, the plain
    version and SDPA, with the split sweep; returns the rows by case."""
    import torch

    from kubegpu_tpu_torch.workload.kernels import decode_attn as da

    rows = {}
    for name, b, s_max, hq, hkv, d, window, lo, hi in DECODE_ATTN_CASES:
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((b, 1, hq, d), generator=gen, device=dev)\
            .to(torch.bfloat16)
        k, v = (torch.randn((b, s_max, hkv, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        pos_np = _decode_positions(b, lo, hi)
        pos = torch.from_numpy(pos_np).to(dev)
        rows_ = torch.arange(b, device=dev)
        v[rows_, pos] = DECODE_EDGE_V
        if window:
            v[rows_, (pos - window + 1).clamp(min=0)] = DECODE_EDGE_V
        scale = d ** -0.5
        before = da.decode_attention.launches
        o = da.decode_attention(q, k, v, pos, scale, window)
        torch.cuda.synchronize()
        launched = da.decode_attention.launches - before
        ref = da.decode_attention_plain(q, k, v, pos, scale, window)
        err = (o.float() - ref.float()).abs().max().item()
        rel = _rel_l2(o, ref).item()
        k8, v8 = (x.to(torch.float8_e4m3fn).to(torch.bfloat16)
                  for x in (k, v))
        control = _rel_l2(da.decode_attention(q, k8, v8, pos, scale, window),
                          ref).item()
        del k8, v8
        ok = rel <= TOL_DECODE_REL < control \
            and bool(torch.isfinite(o).all()) and launched == 1
        first = (pos_np - window + 1).clip(0) if window else 0 * pos_np
        live = int((pos_np + 1 - first).sum())
        # each live K and V row of every kv head read once, q read and o
        # written once; 4 * D operations a (query head, live key) pair
        nbytes = 2 * live * hkv * d * 2 + 2 * b * hq * d * 2 + 8 * b
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 4 * d * live * hq / PEAK_FLOPS["bfloat16"] * 1e3
        kv_pos = torch.arange(s_max, device=dev)
        mask = kv_pos[None, :] <= pos[:, None]
        if window:
            mask &= kv_pos[None, :] > pos[:, None] - window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sweep = {}
        real = da.SPLIT_LEN
        try:
            for length in DECODE_ATTN_SPLITS:
                da.SPLIT_LEN = length
                sweep[str(length)] = time_ms(
                    lambda: da.decode_attention(q, k, v, pos, scale, window))
        finally:
            da.SPLIT_LEN = real
        row = {"phase": "decode_attn", "case": name,
               "shape": [b, s_max, hq, hkv, d], "window": window,
               "pos_min": int(pos_np.min()), "pos_max": int(pos_np.max()),
               "live_positions": live, "launches": launched,
               "split_len": da.SPLIT_LEN, "max_abs_err": err,
               "max_abs_ref": ref.float().abs().max().item(),
               "rel_err": rel, "fp8_control_rel_err": control,
               "tol_rel": TOL_DECODE_REL,
               "ms": time_ms(lambda: da.decode_attention(q, k, v, pos, scale,
                                                         window)),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes,
               "plain_ms": time_ms(lambda: da.decode_attention_plain(
                   q, k, v, pos, scale, window), runs=5, batch=1),
               "library_ms": time_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask[:, None, None, :],
                       scale=scale, enable_gqa=True), runs=5, batch=1),
               "ms_by_split_len": sweep, "ok": ok}
        row["bound_x"] = row["ms"] / row["bound_ms"]
        emit(row)
        rows[name] = row
        del q, k, v, o, ref, qt, kt, vt, mask
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"decode attention kernel disagrees with "
                                 f"its plain version, or the float8 "
                                 f"control passes, on {name}: {row}")
    return rows


def forward_phase(dev, cfg, params) -> dict:
    """The full-width forward through the kernel, against plain attention.

    bf16 rounds differently on the two attention paths, so each is held
    against the float32 forward with plain attention: the kernel's path
    must come as close to it as the plain bf16 path does. The float32
    forward through the kernel's float32 instance must match the float32
    plain forward closely (summation order only)."""
    import dataclasses

    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import \
        flash_attention_with_lse
    from kubegpu_tpu_torch.workload.model import make_forward

    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, FORWARD_TOKENS, generator=gen,
                           device=dev)
    fwd = make_forward(cfg)                      # attn_impl "auto"
    with torch.no_grad():
        _zero_launch_counts()
        logits = fwd(params, tokens)
        torch.cuda.synchronize()
        launches = flash_attention_with_lse.launches
        by_instance = dict(flash_attention_with_lse.launches_by_instance)
        plain = make_forward(dataclasses.replace(cfg, attn_impl="xla"))
        ref = plain(params, tokens)
        f32 = dataclasses.replace(cfg, dtype="float32")
        truth = make_forward(dataclasses.replace(f32, attn_impl="xla"))(
            params, tokens)
        f32_flash = make_forward(dataclasses.replace(f32, attn_impl="flash"))(
            params, tokens)
        fwd_ms = time_ms(lambda: fwd(params, tokens), runs=5, batch=1,
                         warmup=1)
        plain_ms = time_ms(lambda: plain(params, tokens), runs=5, batch=1,
                           warmup=1)
    err_k = (logits - truth).abs()
    err_p = (ref - truth).abs()
    row = {"phase": "forward", "tokens": list(FORWARD_TOKENS),
           "kernel_launches": launches,
           "kernel_launches_by_instance": by_instance,
           "finite": bool(torch.isfinite(logits).all()),
           "bf16_kernel_vs_f32": [err_k.mean().item(), err_k.max().item()],
           "bf16_plain_vs_f32": [err_p.mean().item(), err_p.max().item()],
           "bf16_kernel_vs_plain_max": (logits - ref).abs().max().item(),
           "argmax_agreement": (logits.argmax(-1) == ref.argmax(-1))
           .float().mean().item(),
           "f32_kernel_vs_f32_plain_max":
               (f32_flash - truth).abs().max().item(),
           "forward_ms": fwd_ms, "forward_plain_attention_ms": plain_ms}
    row["ok"] = (
        launches == cfg.n_layers == by_instance["sm90"] and row["finite"]
        and tuple(logits.shape) == FORWARD_TOKENS + (cfg.vocab,)
        and row["bf16_kernel_vs_f32"][0]
        <= TOL_FWD_MEAN_RATIO * row["bf16_plain_vs_f32"][0]
        and row["bf16_kernel_vs_f32"][1]
        <= TOL_FWD_MAX_RATIO * row["bf16_plain_vs_f32"][1]
        and row["f32_kernel_vs_f32_plain_max"] <= TOL_FWD_F32)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"forward phase failed: {row}")
    return row


def entry_phase() -> None:
    """The port's ``entry()`` (the reference entry's config, tokens
    [2, 128]) on the card: one kernel launch per layer, finite logits."""
    import torch

    from kubegpu_tpu_torch.entry import entry
    from kubegpu_tpu_torch.workload.kernels.flash import \
        flash_attention_with_lse

    fwd, (params, tokens) = entry()
    before = flash_attention_with_lse.launches
    with torch.no_grad():
        logits = fwd(params, tokens)
    torch.cuda.synchronize()
    row = {"phase": "entry", "shape": list(logits.shape),
           "kernel_launches": flash_attention_with_lse.launches - before,
           "finite": bool(torch.isfinite(logits).all())}
    row["ok"] = row["finite"] and row["kernel_launches"] == 4 \
        and row["shape"] == [2, 128, 512]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"entry phase failed: {row}")


def _serve_prompts(cfg) -> list:
    """The serving traffic: 8 prompts of 16..max_seq/2 tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab, int(n)).tolist()
            for n in np.linspace(16, cfg.max_seq // 2, SERVE_REQUESTS)]


def _drain(cfg, params, prompts, fused=True, reverse=False, **kw) -> dict:
    """One drain of ``prompts`` (SERVE_MAX_NEW tokens each) through a
    fresh server on ``SERVE_SLOTS`` slots: the streams in submission
    order, the wall time, TTFT and ITL p50 and the server. ``reverse``
    admits the requests in the reverse of their submission order (each
    keeps its request id, so its keys)."""
    import torch

    from kubegpu_tpu_torch import metrics
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    os.environ["KGTPU_FUSED_SERVE"] = "1" if fused else "0"
    try:
        srv = DecodeServer(cfg, params, slots=SERVE_SLOTS, **kw)
    finally:
        os.environ.pop("KGTPU_FUSED_SERVE", None)
    assert srv.fused == fused
    metrics.reset_all()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    if reverse:
        srv._queue.reverse()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [srv.result(r) for r in rids]
    n_tok = sum(len(o) for o in outs)
    return {"outs": outs, "wall_s": wall, "tokens": n_tok,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": metrics.SERVE_TTFT_MS.percentile(0.5),
            "itl_p50_ms": metrics.SERVE_ITL_MS.percentile(0.5), "srv": srv}


def serve_phase(dev, cfg, params) -> dict:
    """DecodeServer on the benchmark's traffic; fused against oracle."""
    from kubegpu_tpu_torch.workload.kernels import decode_attn

    prompts = _serve_prompts(cfg)
    _drain(cfg, params, prompts)                 # warm-up pass
    before = decode_attn.decode_attention.launches
    fused = _drain(cfg, params, prompts)
    k4_launches = decode_attn.decode_attention.launches - before
    oracle = _drain(cfg, params, prompts, fused=False)
    row = {"phase": "serve", "slots": SERVE_SLOTS,
           "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
           "prompt_lens": [len(p) for p in prompts],
           "tokens": fused["tokens"], "wall_s": fused["wall_s"],
           "tokens_per_s": fused["tokens_per_s"],
           "ttft_p50_ms": fused["ttft_p50_ms"],
           "itl_p50_ms": fused["itl_p50_ms"],
           "oracle_tokens_per_s": oracle["tokens_per_s"],
           "all_full_length": all(len(o) == SERVE_MAX_NEW
                                  for o in fused["outs"]),
           "fused_equals_oracle": fused["outs"] == oracle["outs"],
           "first_output": fused["outs"][0][:8],
           # K4 a layer and token step of the fused drain
           "decode_attn_launches": k4_launches}
    row["ok"] = row["all_full_length"] and row["fused_equals_oracle"] \
        and k4_launches > 0
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve phase failed: {row}")
    return row


def serve_sampled_phase(dev, cfg, params) -> dict:
    """Sampled serving: fused against the oracle, another chunk size and
    the reverse admission order (position-keyed draws make all four
    equal), and the key hash on the card against the CPU."""
    import torch

    from kubegpu_tpu_torch.workload import keys
    from kubegpu_tpu_torch.workload.kernels import decode_attn

    prompts = _serve_prompts(cfg)
    kw = dict(SAMPLING, rng=7)
    _drain(cfg, params, prompts, **kw)           # warm-up pass
    before = decode_attn.decode_attention.launches
    fused = _drain(cfg, params, prompts, **kw)
    k4_launches = decode_attn.decode_attention.launches - before
    oracle = _drain(cfg, params, prompts, fused=False, **kw)
    # the untimed drains: each K4 launch checked against the plain version
    with checked_decode_attn() as k4_checked:
        chunk5 = _drain(cfg, params, prompts, chunk=5, **kw)
        # each request lands in another slot, next to other requests
        rev = _drain(cfg, params, prompts, reverse=True, **kw)
    seeds = torch.arange(4096, dtype=torch.int64) * 2654435761
    cpu_bits = keys.bits(keys.fold(seeds, 12345), 64)
    dev_bits = keys.bits(keys.fold(seeds.to(dev), 12345), 64).cpu()
    row = {"phase": "serve_sampled", **SAMPLING,
           "tokens": fused["tokens"], "wall_s": fused["wall_s"],
           "tokens_per_s": fused["tokens_per_s"],
           "ttft_p50_ms": fused["ttft_p50_ms"],
           "itl_p50_ms": fused["itl_p50_ms"],
           "oracle_tokens_per_s": oracle["tokens_per_s"],
           "all_full_length": all(len(o) == SERVE_MAX_NEW
                                  for o in fused["outs"]),
           "fused_equals_oracle": fused["outs"] == oracle["outs"],
           "chunk5_equals_chunk16": chunk5["outs"] == fused["outs"],
           "reverse_admission_equals": rev["outs"] == fused["outs"],
           "key_bits_cuda_equal_cpu": bool(torch.equal(cpu_bits, dev_bits)),
           "first_output": fused["outs"][0][:8],
           # K4 in the fused drain; its launches in the chunk-5 and
           # reverse drains, each checked against the plain version
           "decode_attn_launches": k4_launches,
           "decode_attn_checked": k4_checked}
    row["ok"] = all(row[k] for k in (
        "all_full_length", "fused_equals_oracle", "chunk5_equals_chunk16",
        "reverse_admission_equals", "key_bits_cuda_equal_cpu")) \
        and k4_launches > 0 and _k4_checked_ok(k4_checked)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_sampled phase failed: {row}")
    return row


def serve_spec_phase(dev, cfg, params) -> dict:
    """The speculative server on the serving traffic with a 1-layer draft:
    in float32, greedy streams equal to the plain server's and a
    self-draft sampled acceptance of 1.0; in bf16, sampled tokens/s and
    acceptance, the draft's K4 launches counted in the timed drain and
    checked against the plain version in the warm-up drain."""
    import dataclasses

    import torch

    from kubegpu_tpu_torch.workload.kernels import decode_attn
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)

    prompts = _serve_prompts(cfg)
    dcfg = TransformerConfig(**DRAFT_MODEL)
    draft = init_params(torch.Generator(device=dev).manual_seed(1), dcfg)
    spec = dict(lookahead=SPEC_LOOKAHEAD, spec_rounds=SPEC_ROUNDS)
    f32, df32 = (dataclasses.replace(c, dtype="float32") for c in (cfg, dcfg))
    plain = _drain(f32, params, prompts)
    greedy = _drain(f32, params, prompts, draft_params=draft,
                    draft_cfg=df32, **spec)
    self_draft = _drain(f32, params, prompts, draft_params=params,
                        draft_cfg=f32, rng=5, **spec, **SAMPLING)
    bf16 = dict(draft_params=draft, draft_cfg=dcfg, rng=5, **spec,
                **SAMPLING)
    with checked_decode_attn() as k4_checked:
        _drain(cfg, params, prompts, **bf16)     # warm-up pass
    before = decode_attn.decode_attention.launches
    timed = _drain(cfg, params, prompts, **bf16)
    k4_launches = decode_attn.decode_attention.launches - before
    row = {"phase": "serve_spec", "draft": DRAFT_MODEL, **spec,
           **SAMPLING,
           "f32_greedy_equals_plain": greedy["outs"] == plain["outs"],
           "f32_plain_tokens_per_s": plain["tokens_per_s"],
           "f32_spec_greedy_tokens_per_s": greedy["tokens_per_s"],
           "f32_spec_greedy_acceptance": greedy["srv"].spec_acceptance,
           "f32_self_draft_acceptance": self_draft["srv"].spec_acceptance,
           "f32_self_draft_proposed": self_draft["srv"].spec_proposed,
           "bf16_sampled_tokens_per_s": timed["tokens_per_s"],
           "bf16_sampled_acceptance": timed["srv"].spec_acceptance,
           "bf16_ttft_p50_ms": timed["ttft_p50_ms"],
           "bf16_itl_p50_ms": timed["itl_p50_ms"],
           # the draft's single-token steps, n_layers K4 each
           "bf16_decode_attn_launches": k4_launches,
           "bf16_decode_attn_checked": k4_checked,
           "all_full_length": all(
               len(o) == SERVE_MAX_NEW for r in (greedy, self_draft, timed)
               for o in r["outs"])}
    row["ok"] = (row["f32_greedy_equals_plain"]
                 and row["f32_self_draft_acceptance"] == 1.0
                 and row["f32_self_draft_proposed"] > 0
                 and row["all_full_length"]
                 and k4_launches > 0 and _k4_checked_ok(k4_checked))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_spec phase failed: {row}")
    return row


def serve_prefix_phase(dev, cfg, params) -> dict:
    """Requests sharing a system prompt, greedy in float32, through the
    server with a prefix cache and without: equal streams, 7 hits."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(4)
    system = rng.integers(1, cfg.vocab, PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in np.linspace(*PREFIX_TAILS, SERVE_REQUESTS)]
    f32 = dataclasses.replace(cfg, dtype="float32")
    cold = _drain(f32, params, prompts)
    warm = _drain(f32, params, prompts, prefix_cache_size=PREFIX_CACHE)
    srv = warm["srv"]
    row = {"phase": "serve_prefix", "system_tokens": PREFIX_SYSTEM,
           "prompt_lens": [len(p) for p in prompts],
           "prefix_cache_size": PREFIX_CACHE,
           "prefix_hits": srv.prefix_hits,
           "prefix_misses": srv.prefix_misses,
           "streams_equal_uncached": warm["outs"] == cold["outs"],
           "tokens_per_s": warm["tokens_per_s"],
           "ttft_p50_ms": warm["ttft_p50_ms"],
           "uncached_tokens_per_s": cold["tokens_per_s"],
           "uncached_ttft_p50_ms": cold["ttft_p50_ms"]}
    row["ok"] = (row["streams_equal_uncached"]
                 and (srv.prefix_hits, srv.prefix_misses)
                 == (SERVE_REQUESTS - 1, 1))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_prefix phase failed: {row}")
    return row


def _token_shards(vocab: int, tmp: str) -> list:
    """Two shards of a seeded bigram chain in ``tmp``."""
    from kubegpu_tpu_torch.workload.data import write_token_shard

    return [write_token_shard(os.path.join(tmp, f"shard{i}.kgtd"),
                              bigram_tokens(vocab, 100_000, seed=i))
            for i in range(2)]


def loader_phase(cfg) -> dict:
    """The native loader (built at first use) against PyTokenLoader."""
    import shutil
    import tempfile

    import numpy as np

    from kubegpu_tpu_torch.workload.data import (NativeTokenLoader,
                                                 PyTokenLoader, make_loader)

    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-loader-")
    try:
        paths = _token_shards(cfg.vocab, tmp)
        t0 = time.perf_counter()
        native = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=11)
        build_s = time.perf_counter() - t0
        py = PyTokenLoader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=11)
        try:
            same = [np.array_equal(next(native), next(py))
                    for _ in range(LOADER_BATCHES)]
        finally:
            native.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "loader", "loader": type(native).__name__,
           "batches": LOADER_BATCHES, "batch_shape": [TRAIN_BATCH,
                                                      TRAIN_SEQ + 1],
           "first_use_seconds": build_s, "bit_identical": all(same)}
    row["ok"] = isinstance(native, NativeTokenLoader) and all(same)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"loader phase failed: {row}")
    return row


def backward_bound_ms(b, tq, tk, h, d, dtype, pairs, kernel) -> tuple:
    """Least time for K2 ("dq", with the row term delta it computes) or K3
    ("dkv") on an H100 SXM: the larger of their tensors moved once over
    the memory rate (K2: q, k, v, dO, O, dQ; K3: q, k, v, dO, dK, dV; both
    lse and delta in float32) and their operations (K2: 6 D a visible pair
    for S, dP, dQ on the tensor cores, and 2 D a row for delta in float32
    FMAs; K3: 8 D a pair for S, dP, dV, dK) over the peak of their type
    (the tensor cores for bf16 products, the FMA units for float32)."""
    import torch

    esize = torch.finfo(dtype).bits // 8
    rows = (4 * tq + 2 * tk) if kernel == "dq" else (2 * tq + 4 * tk)
    nbytes = esize * b * h * d * rows + 2 * 4 * b * h * tq
    flops = (6 if kernel == "dq" else 8) * d * pairs * b * h
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    if kernel == "dq":
        t_ops += 2 * d * tq * b * h / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _launch_counts() -> tuple:
    from kubegpu_tpu_torch.workload.kernels import flash

    return (flash.flash_attention_with_lse.launches,
            flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches)


def _zero_launch_counts() -> None:
    from kubegpu_tpu_torch.workload.kernels import flash

    for fn in (flash.flash_attention_with_lse, flash.flash_bwd_dq,
               flash.flash_bwd_dkv):
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(fn.launches_by_instance, 0)


def _instance_counts() -> tuple:
    """K1's, K2's and K3's launches per instance."""
    from kubegpu_tpu_torch.workload.kernels import flash

    return (dict(flash.flash_attention_with_lse.launches_by_instance),
            dict(flash.flash_bwd_dq.launches_by_instance),
            dict(flash.flash_bwd_dkv.launches_by_instance))


def _ran(before) -> tuple:
    """The instance of K1, K2 and K3 launched since ``before`` (an
    `_instance_counts` reading), None where it did not launch, a list where
    several did."""
    out = []
    for was, now in zip(before, _instance_counts()):
        hit = [k for k in now if now[k] > was[k]]
        out.append(hit[0] if len(hit) == 1 else (hit or None))
    return tuple(out)


def kernel_bwd_phase(dev) -> dict:
    """K2 and K3 through the autograd Function against the plain backward,
    at the training and MoE training shapes and edge cases, and the delta
    K2 gives K3 against
    `_delta`; times at the training shape."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        _delta, _dkv_plain, _dq_plain, _instance, _launch, _p_ds,
        flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq)

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        *((name, (b, t, t, h, d), bf16, {}) for name, (b, t, h, d) in (
            ("train_causal", TRAIN_SHAPE),
            ("moe_train_causal", MOE_TRAIN_SHAPE))),
        ("single_tile", (1, 64, 64, 1, 128), bf16, {}),
        ("ragged_multistage", (1, 2085, 2085, 2, 128), bf16, {}),
        ("non_causal", (2, 256, 256, 4, 128), bf16, dict(causal=False)),
        ("window_64", (2, 512, 512, 4, 128), bf16, dict(window=64)),
        ("offsets_96_32", (1, 256, 256, 4, 64), bf16,
         dict(q_offset=96, kv_offset=32)),
        ("all_future", (1, 128, 128, 2, 64), bf16,
         dict(q_offset=0, kv_offset=1000)),
        ("ragged_200", (2, 200, 200, 4, 64), bf16, {}),
        ("ragged_q70_k300_noncausal", (1, 70, 300, 2, 128), bf16,
         dict(causal=False)),
        ("head_dim_32", (2, 256, 256, 4, 32), bf16, {}),
        ("strided_qkv", (2, 256, 256, 4, 64), bf16, dict(strided=True)),
        ("lse_cotangent", (2, 256, 256, 4, 128), bf16, dict(dlse=True)),
        ("f32_causal_window", (2, 200, 200, 4, 64), f32, dict(window=48)),
        ("f32_offsets", (1, 130, 96, 2, 128), f32,
         dict(q_offset=40, kv_offset=0)),
        ("f32_non_causal_d32", (2, 64, 100, 2, 32), f32,
         dict(causal=False)),
        ("f32_lse_cotangent_ragged", (1, 77, 77, 2, 64), f32,
         dict(dlse=True, window=20)),
    ]
    out = {}
    for name, (b, tq, tk, h, d), dt, kw in cases:
        kw = dict(kw)
        q, k, v = case_qkv(gen, dev, b, tq, tk, h, d, dt,
                           kw.pop("strided", False))
        with_dlse = kw.pop("dlse", False)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        scale = d ** -0.5
        do = torch.randn((b, tq, h, d), generator=gen, device=dev,
                         dtype=f32).to(dt)
        dlse = torch.randn((b, h, tq), generator=gen, device=dev,
                           dtype=f32) if with_dlse else None
        o, lse = flash_attention_with_lse(q, k, v, scale, **kw)
        before = _launch_counts()
        before_instance = _instance_counts()
        if dlse is None:
            grads = torch.autograd.grad(o, (q, k, v), do)
        else:
            grads = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        torch.cuda.synchronize()
        after = _launch_counts()
        launched = [after[i] - before[i] for i in range(3)]
        _, dq_instance, instance = _ran(before_instance)
        # the delta K2 hands K3, from a direct call on the same inputs
        _, delta_k = flash_bwd_dq(q.detach(), k.detach(), v.detach(),
                                  o.detach(), do, lse.detach(), dlse, scale,
                                  **kw)
        delta_ref = _delta(o.detach(), do, dlse)
        delta_err = (delta_k - delta_ref).abs().max().item()
        delta_top = delta_ref.abs().max().item()
        refs = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o.detach(), lse.detach(), do, dlse,
                                         scale, **kw)
        errs = [(g.float() - r.float()).abs().max().item()
                for g, r in zip(grads, refs)]
        tops = [r.float().abs().max().item() for r in refs]
        if name == "all_future":
            ok = all(not g.any() for g in grads) and max(tops) == 0.0
        else:
            tol = TOL_BWD_F32 if dt == f32 else TOL_BWD_BF16
            ok = all(e <= tol * t for e, t in zip(errs, tops)) and all(
                bool(torch.isfinite(g).all()) for g in grads)
        ok = (ok and launched == [0, 1, 1] and instance == _instance(dt, d)
              and dq_instance == _instance(dt, d)
              and delta_err <= TOL_DELTA * delta_top)
        row = {"phase": "kernel_bwd", "case": name, "dtype": str(dt)[6:],
               "shape": [b, tq, tk, h, d], "dlse": with_dlse,
               "dq_instance": dq_instance, "dkv_instance": instance,
               "delta_max_abs_err": delta_err, "delta_max_abs": delta_top,
               "max_abs_err_dq_dk_dv": errs, "max_abs_ref_dq_dk_dv": tops,
               "launches_fwd_dq_dkv": launched, "ok": ok}
        if name == "train_causal":
            qd, kd, vd, od = q.detach(), k.detach(), v.detach(), o.detach()
            delta = _delta(od, do, None)
            lsed = lse.detach()
            pairs = visible_pairs(tq, tk, 0, 0, True, 0)
            dq_bound = backward_bound_ms(b, tq, tk, h, d, dt, pairs, "dq")
            dkv_bound = backward_bound_ms(b, tq, tk, h, d, dt, pairs, "dkv")
            fwd_bound = attention_bound_ms(b, tq, tk, h, d, dt, pairs)
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            do_t = do.transpose(1, 2)
            row.update(
                dq_ms=time_ms(lambda: flash_bwd_dq(qd, kd, vd, od, do, lsed,
                                                   None, scale)),
                dq_previous_ms=time_ms(lambda: flash_bwd_dq(
                    qd, kd, vd, od, do, lsed, None, scale, instance="mma")),
                dkv_ms=time_ms(lambda: flash_bwd_dkv(qd, kd, vd, do, lsed,
                                                     delta, scale)),
                dkv_previous_ms=time_ms(lambda: flash_bwd_dkv(
                    qd, kd, vd, do, lsed, delta, scale, instance="mma")),
                delta_ms=time_ms(lambda: _delta(od, do, None)),
                fwd_ms=time_ms(lambda: _launch(qd, kd, vd, scale, 0, 0,
                                               True, 0)),
                fwd_previous_ms=time_ms(lambda: _launch(
                    qd, kd, vd, scale, 0, 0, True, 0, instance="mma")),
                dq_plain_ms=time_ms(lambda: _dq_plain(qd, kd, _p_ds(
                    qd, kd, vd, lsed, do, _delta(od, do, None), scale, 0, 0,
                    True, 0)[1], scale), runs=5, batch=2, warmup=1),
                dkv_plain_ms=time_ms(lambda: _dkv_plain(
                    qd, kd, vd, do, *_p_ds(qd, kd, vd, lsed, do, delta,
                                           scale, 0, 0, True, 0), scale),
                    runs=5, batch=2, warmup=1),
                library_bwd_ms=time_ms(lambda: torch.autograd.grad(
                    lib_out, (qt, kt, vt), do_t, retain_graph=True)),
                library_fwd_ms=time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt.detach(), kt.detach(), vt.detach(),
                        is_causal=True)),
                plain_fwd_ms=time_ms(
                    lambda: flash_attention_plain(qd, kd, vd, scale),
                    runs=5, batch=2, warmup=1),
                dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1])
            out = dict(row)
            del lib_out, qt, kt, vt
        emit(row)
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"their plain version on {name}: {row}")
    return out


def bigram_tokens(vocab: int, n: int, seed: int, fanout: int = 4):
    """``n`` tokens of a seeded Markov chain in which every token has
    ``fanout`` possible successors: a corpus with structure to learn (its
    entropy is log(fanout) a token), so a few steps lower the loss by more
    than the batch-to-batch noise of uniform random tokens."""
    import numpy as np

    rng = np.random.default_rng(1000 + seed)
    succ = rng.integers(0, vocab, (vocab, fanout))
    pick = rng.integers(0, fanout, n)
    out = np.empty(n, np.uint32)
    cur = int(rng.integers(vocab))
    for i in range(n):
        cur = int(succ[cur, pick[i]])
        out[i] = cur
    return out


def _grad_errors(got, ref) -> list:
    """Per-leaf relative L2 error of ``got`` against ``ref``."""
    return [((g.float() - r).norm() / r.norm().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]


@contextlib.contextmanager
def _counting_delta_prepass():
    """Counts, in the list it yields, the calls of the ``_delta`` pre-pass
    made inside the block: the mma K2 needs it, the sm90 K2 computes delta
    itself."""
    from kubegpu_tpu_torch.workload.kernels import flash

    prepass, calls = flash._delta, [0]

    def counted(*args):
        calls[0] += 1
        return prepass(*args)

    flash._delta = counted
    try:
        yield calls
    finally:
        flash._delta = prepass


def _loss_and_grads(cfg, params, tokens) -> tuple:
    """The loss of ``cfg`` on ``tokens`` and its gradient in every leaf of
    ``params`` (leaves that require grad; their ``.grad`` stays as is)."""
    import torch

    from kubegpu_tpu_torch.workload.model import make_loss_fn
    from kubegpu_tpu_torch.workload.train import param_leaves

    loss = make_loss_fn(cfg)(params, tokens)
    g = torch.autograd.grad(loss, param_leaves(params))
    torch.cuda.synchronize()
    return loss.item(), g


def train_phase(dev) -> dict:
    """The training path at the headline training config: gradient
    accuracy against a float32 reference, then AdamW steps."""
    import dataclasses
    import statistics
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  train_step_model_flops)

    cfg = TransformerConfig(**TRAIN_MODEL)
    gen = torch.Generator(device=dev).manual_seed(3)

    # -- gradient accuracy on one batch: three paths, one at a time
    params, _, _ = init_sharded(torch.Generator(device=dev).manual_seed(2),
                                cfg, init_optimizer=False)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    loss_ref, g_ref = _loss_and_grads(
        dataclasses.replace(cfg, attn_impl="xla", dtype="float32"), params,
        tokens)
    _zero_launch_counts()
    loss_k, g_k = _loss_and_grads(dataclasses.replace(cfg, attn_impl="flash"),
                                  params, tokens)
    grad_launches = list(_launch_counts())
    err_k = _grad_errors(g_k, g_ref)
    del g_k
    loss_p, g_p = _loss_and_grads(dataclasses.replace(cfg, attn_impl="xla"),
                                  params, tokens)
    err_p = _grad_errors(g_p, g_ref)
    finite = all(np.isfinite(err_k)) and all(np.isfinite(err_p))
    del g_p, g_ref, params
    torch.cuda.empty_cache()
    med_k, med_p = statistics.median(err_k), statistics.median(err_p)
    grad_row = {"phase": "train_grad", "layers": cfg.n_layers,
                "loss_f32_plain": loss_ref, "loss_bf16_kernel": loss_k,
                "loss_bf16_plain": loss_p,
                "launches_fwd_dq_dkv": grad_launches,
                "rel_l2_err_kernel_median_max": [med_k, max(err_k)],
                "rel_l2_err_plain_median_max": [med_p, max(err_p)],
                "leaves": len(err_k)}
    grad_row["ok"] = (finite and grad_launches == [cfg.n_layers] * 3
                      and med_k <= TOL_GRAD_RATIO * med_p
                      and max(err_k) <= TOL_GRAD_RATIO * max(err_p))
    emit(grad_row)
    if not grad_row["ok"]:
        raise AssertionError(f"train gradient check failed: {grad_row}")

    # -- AdamW steps through the user's entry points
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-tokens-")
    paths = _token_shards(cfg.vocab, tmp)
    loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(0), cfg)
    step = make_train_step(cfg, optimizer=optimizer)
    losses, step_s, launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    with _counting_delta_prepass() as delta_calls:
        for _ in range(TRAIN_STEPS):
            batch = torch.from_numpy(next(loader)).to(dev)
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(loss.item())              # waits for the step
            step_s.append(time.perf_counter() - t0)
            after = _launch_counts()
            launches.append([after[i] - before[i] for i in range(3)])
    run_launches = list(_launch_counts())
    run_by_instance = _instance_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # remat "full" against remat "none" on the same params and batch: the
    # loss and every leaf's gradient, then one train step with remat "full"
    batch = torch.from_numpy(next(loader)).to(dev)
    full_cfg = dataclasses.replace(cfg, remat="full")
    loss_none, g_none = _loss_and_grads(cfg, params, batch)
    loss_full, g_full = _loss_and_grads(full_cfg, params, batch)
    remat_err = _grad_errors(g_full, g_none)
    del g_none, g_full
    full = make_train_step(full_cfg, optimizer=optimizer)
    _zero_launch_counts()
    params, opt_state, loss = full(params, opt_state, batch)
    loss_full_step = loss.item()
    full_launches = list(_launch_counts())
    loader.close()
    for path in paths:
        os.remove(path)
    os.rmdir(tmp)
    del params, opt_state, optimizer, step, full
    torch.cuda.empty_cache()

    step_ms = statistics.median(step_s[1:]) * 1e3
    flops = train_step_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    n = cfg.n_layers
    row = {"phase": "train", "model": TRAIN_MODEL, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": cfg.remat, "steps": TRAIN_STEPS,
           "loader": type(loader).__name__,
           "losses": losses, "step_ms_each": [t * 1e3 for t in step_s],
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
           "launches_fwd_dq_dkv_per_step": launches,
           "run_launches_by_instance_fwd_dq_dkv": run_by_instance,
           "delta_prepass_calls": delta_calls[0],
           "peak_memory_gb": peak_gb,
           "remat_full_launches_fwd_dq_dkv": full_launches,
           "remat_full_loss": loss_full, "remat_none_loss": loss_none,
           "remat_full_step_loss": loss_full_step,
           "remat_full_vs_none_grad_rel_l2_max": max(remat_err)}
    row["ok"] = (
        all(np.isfinite(losses)) and losses[-1] < losses[0]
        and row["loader"] == "NativeTokenLoader"
        and all(x == [n, n, n] for x in launches)
        and all(c["sm90"] == TRAIN_STEPS * n for c in run_by_instance)
        and delta_calls[0] == 0
        and full_launches == [2 * n, n, n]
        and all(abs(x - loss_none) <= TOL_REMAT_LOSS * abs(loss_none)
                for x in (loss_full, loss_full_step))
        and all(np.isfinite(remat_err))
        and max(remat_err) <= TOL_REMAT_GRAD)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train phase failed: {row}")
    row["run_launches"] = run_launches
    row["run_by_instance"] = run_by_instance
    return row


def train_remat_dots_phase(dev) -> dict:
    """Remat "dots" at the training config: loss and gradients against
    remat "none" on one batch, the flash launches of the dots pass (a
    rerun K1 would show 2 a layer), then AdamW steps of each mode: the
    median time of REMAT_STEPS after a warm-up step, and their peak
    memory."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.model import TransformerConfig
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    cfg = TransformerConfig(**TRAIN_MODEL)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(5), cfg)
    batch = torch.from_numpy(bigram_tokens(
        cfg.vocab, TRAIN_BATCH * (TRAIN_SEQ + 1), seed=7).astype(
            np.int64).reshape(TRAIN_BATCH, -1)).to(dev)
    mode = {r: dataclasses.replace(cfg, remat=r)
            for r in ("none", "dots", "full")}
    loss_none, g_none = _loss_and_grads(mode["none"], params, batch)
    _zero_launch_counts()
    loss_dots, g_dots = _loss_and_grads(mode["dots"], params, batch)
    launches = list(_launch_counts())
    by_instance = _instance_counts()
    err = _grad_errors(g_dots, g_none)
    del g_none, g_dots
    step_ms, peak_gb = {}, {}
    for r, c in mode.items():
        step = make_train_step(c, optimizer=optimizer)
        params, opt_state, loss = step(params, opt_state, batch)
        loss.item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms[r] = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            loss.item()                          # waits for the step
            step_ms[r].append((time.perf_counter() - t0) * 1e3)
        peak_gb[r] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, optimizer
    torch.cuda.empty_cache()
    n = cfg.n_layers
    row = {"phase": "train_remat_dots", "model": TRAIN_MODEL,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "loss_none": loss_none, "loss_dots": loss_dots,
           "dots_vs_none_grad_rel_l2_max": max(err),
           "launches_fwd_dq_dkv": launches,
           "launches_by_instance_fwd_dq_dkv": by_instance,
           "step_ms": {r: statistics.median(t) for r, t in step_ms.items()},
           "step_ms_each": step_ms, "peak_memory_gb": peak_gb}
    row["ok"] = (
        launches == [n, n, n]
        and all(c["sm90"] == n for c in by_instance)
        and abs(loss_dots - loss_none) <= TOL_REMAT_LOSS * abs(loss_none)
        and all(np.isfinite(err)) and max(err) <= TOL_REMAT_GRAD
        and peak_gb["dots"] <= peak_gb["none"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_remat_dots phase failed: {row}")
    return row


def _lora_optimizer():
    from kubegpu_tpu_torch.workload.train import default_optimizer

    return default_optimizer(lr=LORA_LR)


def train_lora_phase(dev, train) -> tuple:
    """LoRA at the training config: 5 steps from the native loader, the
    base frozen (no gradient, bits unchanged), 6 sm90 K1, K2 and K3
    launches a step, step ms and peak memory beside remat none's from the
    ``train`` row. Returns the row and the base params (the checkpoint
    phase resumes LoRA runs over them)."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.lora import (count_params, init_lora,
                                                 make_lora_train_step,
                                                 merge_lora)
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  make_loss_fn)
    from kubegpu_tpu_torch.workload.train import init_sharded, param_leaves

    cfg = TransformerConfig(**TRAIN_MODEL)
    params, _, _ = init_sharded(torch.Generator(device=dev).manual_seed(0),
                                cfg, init_optimizer=False)
    base = param_leaves(params)
    base_bits = [x.detach().cpu() for x in base]
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), params,
                     LORA_RANK)
    adapter_params = count_params(lora)
    optimizer = _lora_optimizer()
    opt_state = optimizer(param_leaves(lora))
    step = make_lora_train_step(cfg, None, LORA_RANK, optimizer)
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-lora-")
    paths = _token_shards(cfg.vocab, tmp)
    loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    losses, step_s, launches, instances = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(LORA_STEPS):
            batch = torch.from_numpy(next(loader)).to(dev)
            if i == 0:
                first = batch
            _zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lora, opt_state, loss = step(lora, opt_state, params, batch)
            losses.append(loss.item())              # waits for the step
            step_s.append(time.perf_counter() - t0)
            launches.append(list(_launch_counts()))
            instances.append(_instance_counts())
    finally:
        loader.close()
        for path in paths:
            os.remove(path)
        os.rmdir(tmp)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        first_after = make_loss_fn(cfg)(merge_lora(params, lora, 1.0),
                                        first).item()
    frozen = all(not x.requires_grad and x.grad is None for x in base)
    unchanged = all(torch.equal(x.detach().cpu(), b)
                    for x, b in zip(base, base_bits))
    del base_bits, opt_state, lora
    torch.cuda.empty_cache()
    n = cfg.n_layers
    step_ms = statistics.median(step_s[1:]) * 1e3
    row = {"phase": "train_lora", "model": TRAIN_MODEL,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "rank": LORA_RANK,
           "targets": ["wq", "wv"], "lr": LORA_LR,
           "adapter_params": adapter_params,
           "base_params": count_params(params),
           "losses": losses, "first_batch_loss_after": first_after,
           "step_ms_each": [t * 1e3 for t in step_s], "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak_gb,
           "remat_none_step_ms": train["step_ms"],
           "remat_none_peak_memory_gb": train["peak_memory_gb"],
           "launches_fwd_dq_dkv_per_step": launches,
           "base_grads_none": frozen, "base_bits_unchanged": unchanged}
    row["ok"] = (
        all(np.isfinite(losses)) and losses[-1] < losses[0]
        and first_after < losses[0]
        and all(x == [n, n, n] for x in launches)
        and all(c["sm90"] == n for ins in instances for c in ins)
        and frozen and unchanged)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_lora phase failed: {row}")
    return row, params


def checkpoint_phase(dev, params) -> dict:
    """A LoRA run over ``params`` saved after CKPT_SAVE_AT of CKPT_STEPS
    steps and resumed: equal losses. Then the training config's full train
    state saved after CKPT_FULL_STEPS AdamW steps and restored as
    serve_demo restores it: equal bits, equal greedy streams, and the
    seconds of each."""
    import shutil
    import tempfile

    import torch

    from kubegpu_tpu_torch.workload.checkpoint import (
        adamw_state, adamw_template, load_train_state, restore_checkpoint,
        save_checkpoint, tree_map)
    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.lora import (init_lora,
                                                 make_lora_train_step)
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  param_leaves)

    cfg = TransformerConfig(**TRAIN_MODEL)
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-ckpt-")
    try:
        paths = _token_shards(cfg.vocab, tmp)
        lora_dir = os.path.join(tmp, "lora")

        def lora_run(resume: bool) -> tuple:
            """train_demo's loop: resume from ``lora_dir`` or start fresh
            and save after CKPT_SAVE_AT steps; the losses and the start."""
            optimizer = _lora_optimizer()
            lora = init_lora(torch.Generator(device=dev).manual_seed(1),
                             params, LORA_RANK)
            opt_state = optimizer(param_leaves(lora))
            step = make_lora_train_step(cfg, None, LORA_RANK, optimizer)
            start = 0
            if resume:
                state, start = restore_checkpoint(
                    lora_dir, {"params": lora,
                               "opt_state": adamw_template(lora)})
                load_train_state(opt_state, lora, state)
            loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
            losses = []
            try:
                for _ in range(start):
                    next(loader)
                for i in range(start, CKPT_STEPS):
                    batch = torch.from_numpy(next(loader)).to(dev)
                    lora, opt_state, loss = step(lora, opt_state, params,
                                                 batch)
                    losses.append(loss.item())
                    if i + 1 == CKPT_SAVE_AT and not resume:
                        save_checkpoint(lora_dir, {
                            "params": lora,
                            "opt_state": adamw_state(opt_state, lora)},
                            step=i + 1)
            finally:
                loader.close()
            return losses, start

        whole, _ = lora_run(resume=False)
        resumed, start = lora_run(resume=True)

        # the training config's full train state after CKPT_FULL_STEPS
        # AdamW steps at the training shape: save, then restore the params
        # only against a shape-only optimizer template, as serve_demo does
        p, opt_state, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(4), cfg)
        step = make_train_step(cfg, optimizer=optimizer)
        gen = torch.Generator(device=dev).manual_seed(5)
        for _ in range(CKPT_FULL_STEPS):
            batch = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                                  generator=gen, device=dev)
            p, opt_state, loss = step(p, opt_state, batch)
        for x in param_leaves(p):
            x.grad = None
        p = tree_map(lambda x: x.detach(), p)
        saved = {"params": p, "opt_state": adamw_state(opt_state, p)}
        full_dir = os.path.join(tmp, "full")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(full_dir, saved, step=CKPT_FULL_STEPS)
        save_s = time.perf_counter() - t0
        file_gb = os.path.getsize(os.path.join(path, "leaves.npz")) / 1e9
        fresh = init_params(torch.Generator(device=dev).manual_seed(6), cfg)
        t0 = time.perf_counter()
        state, at = restore_checkpoint(
            full_dir, {"params": fresh, "opt_state": adamw_template(fresh)})
        restored = tree_map(lambda x: x.to(dev), state["params"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bits_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
            param_leaves(saved), param_leaves(state)))
        del state, saved, opt_state, optimizer, fresh
        torch.cuda.empty_cache()
        prompts = _serve_prompts(cfg)
        want = _drain(cfg, p, prompts)["outs"]
        got = _drain(cfg, restored, prompts)["outs"]
        del p, restored
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "checkpoint", "lora_steps": CKPT_STEPS,
           "lora_saved_at": CKPT_SAVE_AT, "lora_resumed_from": start,
           "lora_losses_uninterrupted": whole, "lora_losses_resumed": resumed,
           "lora_resumed_equal": resumed == whole[CKPT_SAVE_AT:],
           "full_model": TRAIN_MODEL, "full_steps": CKPT_FULL_STEPS,
           "full_restored_step": at,
           "full_file_gb": file_gb, "full_save_s": save_s,
           "full_restore_s": restore_s, "full_leaves_bit_equal": bits_equal,
           "full_streams_equal": got == want,
           "full_tokens": sum(len(o) for o in got),
           "temp_dir_removed": not os.path.exists(tmp)}
    row["ok"] = (start == CKPT_SAVE_AT and row["lora_resumed_equal"]
                 and at == CKPT_FULL_STEPS and bits_equal
                 and row["full_streams_equal"]
                 and row["full_tokens"] == SERVE_REQUESTS * SERVE_MAX_NEW
                 and row["temp_dir_removed"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"checkpoint phase failed: {row}")
    return row


def moe_phase(dev) -> dict:
    """The moe preset's routing at the serving width: a forward through K1,
    AdamW steps through K1-K3, a float32 greedy drain against the oracle."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params,
                                                  make_forward_with_aux)
    from kubegpu_tpu_torch.workload.train import (make_train_step,
                                                  param_leaves)

    cfg = TransformerConfig(**MOE_MODEL)
    n, n_exp = cfg.n_layers, cfg.n_experts
    params = init_params(torch.Generator(device=dev).manual_seed(6), cfg)
    n_params = sum(x.numel() for x in param_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, FORWARD_TOKENS, generator=gen,
                           device=dev)
    fwd = make_forward_with_aux(cfg)
    with torch.no_grad():
        _zero_launch_counts()
        logits, aux = fwd(params, tokens)
        torch.cuda.synchronize()
        fwd_launches = list(_launch_counts())
        fwd_by_instance = _instance_counts()[0]
        fwd_ms = time_ms(lambda: fwd(params, tokens), runs=5, batch=1,
                         warmup=1)
    fwd_ok = (fwd_launches == [n, 0, 0] and fwd_by_instance["sm90"] == n
              and bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == FORWARD_TOKENS + (cfg.vocab,)
              and n <= aux.item() <= n * n_exp)
    fwd_aux = aux.item()
    del logits

    # AdamW steps at the training shape (max_seq is the serving cache's
    # length; the forward itself takes any T)
    tcfg = dataclasses.replace(cfg, max_seq=TRAIN_SEQ)
    step = make_train_step(tcfg)
    chain = bigram_tokens(cfg.vocab, MOE_STEPS * TRAIN_BATCH
                          * (TRAIN_SEQ + 1), seed=8)
    batches = torch.from_numpy(chain.astype(np.int64)).reshape(
        MOE_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1).to(dev)
    train_fwd = make_forward_with_aux(tcfg)
    opt_state, losses, auxes, step_s, launches, instances = \
        None, [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        with torch.no_grad():                    # this step's aux term
            auxes.append(train_fwd(params, batch[:, :-1])[1].item())
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())                  # waits for the step
        step_s.append(time.perf_counter() - t0)
        launches.append(list(_launch_counts()))
        instances.append(_instance_counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for x in param_leaves(params):
        x.grad = None
    del opt_state, batches
    torch.cuda.empty_cache()

    # float32 greedy serving: fused streams against the per-token oracle
    f32 = dataclasses.replace(cfg, dtype="float32")
    prompts = _serve_prompts(cfg)
    fused = _drain(f32, params, prompts)
    oracle = _drain(f32, params, prompts, fused=False)
    del params
    torch.cuda.empty_cache()
    step_ms = statistics.median(step_s[1:]) * 1e3
    row = {"phase": "moe", "model": MOE_MODEL, "params": n_params,
           "forward_tokens": list(FORWARD_TOKENS),
           "forward_launches_fwd_dq_dkv": fwd_launches,
           "forward_ms": fwd_ms, "forward_aux": fwd_aux,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
           "aux_per_step": auxes,
           "step_ms_each": [t * 1e3 for t in step_s], "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak_gb,
           "launches_fwd_dq_dkv_per_step": launches,
           "f32_fused_equals_oracle": fused["outs"] == oracle["outs"],
           "f32_all_full_length": all(len(o) == SERVE_MAX_NEW
                                      for o in fused["outs"]),
           "f32_tokens_per_s": fused["tokens_per_s"],
           "f32_oracle_tokens_per_s": oracle["tokens_per_s"],
           "f32_ttft_p50_ms": fused["ttft_p50_ms"],
           "f32_itl_p50_ms": fused["itl_p50_ms"]}
    row["ok"] = (
        fwd_ok and all(np.isfinite(losses)) and losses[-1] < losses[0]
        and all(n <= a <= n * n_exp for a in auxes)
        and all(x == [n, n, n] for x in launches)
        and all(c["sm90"] == n for ins in instances for c in ins)
        and row["f32_fused_equals_oracle"] and row["f32_all_full_length"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"moe phase failed: {row}")
    return row


# ring_kernels: the ring's sequence-parallel degrees at the training shape
RING_SPS = (4, 2)


def _plain_flash_with_lse(q, k, v, scale, **kw):
    """The flash attention's plain versions as one autograd Function on
    the card (``flash_attention_plain`` forward, ``flash_attention_bwd_plain``
    backward, with the lse cotangent): it stands in for the kernels'
    operator inside the ring, so the ring runs through the plain versions,
    rounding where the kernels round."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        flash_attention_bwd_plain, flash_attention_plain)

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = flash_attention_plain(q, k, v, scale, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
            return o, lse

        @staticmethod
        def backward(ctx, do, dlse):
            return flash_attention_bwd_plain(*ctx.saved_tensors, do, dlse,
                                             scale, **kw)

    return Fn.apply(q, k, v)


def ring_pass(leaves, do, sp: int, scale: float) -> list:
    """One pass of ring attention over every virtual rank of a ring of
    ``sp`` in this process (``ring.InProcessSeqAxis``), on the whole
    sequence's q, k, v (``leaves``): ``[o, dq, dk, dv]``, the gradients of
    ``o`` against the cotangent ``do``."""
    import torch

    from kubegpu_tpu_torch.workload import ring

    qs, ks, vs = (x.chunk(sp, 1) for x in leaves)
    o = torch.cat([ring.ring_flash_attention(
        qs[i], ks[i], vs[i], ring.InProcessSeqAxis(i, ks, vs), scale)
        for i in range(sp)], 1)
    return [o, *torch.autograd.grad(o, leaves, do)]


def _errors(got, ref) -> list:
    """[mean, max] absolute error of ``got`` against ``ref``."""
    e = (got.float() - ref.float()).abs()
    return [e.mean().item(), e.max().item()]


def ring_kernels_phase(dev) -> dict:
    """K1, K2 and K3 as the ring runs them, at the training shape with sp
    = 4 and 2 through the in-process seq axis: every (q_offset, kv_offset)
    pair of the ring against the plain versions (blocks of the future: O =
    0, lse <= -1e20, zero gradients), then the merged ring against a
    float32 plain reference of the whole sequence, with its launches and
    times beside the single-shard kernels'."""
    import torch

    from kubegpu_tpu_torch.workload import ring
    from kubegpu_tpu_torch.workload.kernels.flash import (
        flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq, merge_partials)

    b, t_all, h, d = TRAIN_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = case_qkv(gen, dev, b, t_all, t_all, h, d, bf16)
    do = torch.randn((b, t_all, h, d), generator=gen, device=dev,
                     dtype=f32).to(bf16)

    # the float32 plain reference of the whole sequence, and the single-
    # shard kernels (K1, then K2 and K3 through autograd)
    qf, kf, vf = (x.float() for x in (q, k, v))
    o_ref, lse_ref = flash_attention_plain(qf, kf, vf, scale)
    refs = [o_ref, *flash_attention_bwd_plain(qf, kf, vf, o_ref, lse_ref,
                                              do.float(), None, scale)]
    del qf, kf, vf, lse_ref
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def single():
        o = flash_attention_with_lse(*leaves, scale)[0]
        return [o, *torch.autograd.grad(o, leaves, do)]

    err_single = [_errors(g, r) for g, r in zip(single(), refs)]
    single_ms = time_ms(single, runs=10, batch=2)
    out = {}
    for sp in RING_SPS:
        t = t_all // sp
        pairs, pairs_ok = [], True
        # every pair the ring gives: rank i attends the block of src at
        # some step, src > i a block of the future
        for i in range(sp):
            for src in range(sp):
                kw = dict(q_offset=i * t, kv_offset=src * t)
                qb, dob = (x[:, i * t:(i + 1) * t] for x in (q, do))
                kb, vb = (x[:, src * t:(src + 1) * t] for x in (k, v))
                dlse = torch.randn((b, h, t), generator=gen, device=dev)
                before = _instance_counts()
                o, lse = flash_attention_with_lse(qb, kb, vb, scale, **kw)
                dq, delta = flash_bwd_dq(qb, kb, vb, o, dob, lse, dlse,
                                         scale, **kw)
                dk, dv = flash_bwd_dkv(qb, kb, vb, dob, lse, delta, scale,
                                       **kw)
                torch.cuda.synchronize()
                ran = _ran(before)
                ro, rl = flash_attention_plain(qb, kb, vb, scale, **kw)
                want = flash_attention_bwd_plain(qb, kb, vb, o, lse, dob,
                                                 dlse, scale, **kw)
                grads = (dq, dk, dv)
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(grads, want)]
                tops = [w.float().abs().max().item() for w in want]
                finite = all(bool(torch.isfinite(x).all())
                             for x in (o, lse, *grads))
                if src > i:
                    ok = (o.abs().max().item() == 0.0
                          and lse.max().item() <= -1e20
                          and all(not g.any() for g in grads))
                else:
                    ok = ((o.float() - ro.float()).abs().max().item()
                          <= TOL_BF16_O
                          and (lse - rl).abs().max().item() <= TOL_BF16_LSE
                          and all(e <= TOL_BWD_BF16 * top
                                  for e, top in zip(errs, tops)))
                ok = ok and finite and ran == ("sm90",) * 3
                pairs.append({"q_offset": i * t, "kv_offset": src * t,
                              "future": src > i, "max_abs_err_dq_dk_dv":
                              errs, "ok": ok})
                pairs_ok = pairs_ok and ok

        # the merged ring through the kernels, counted from zero; then the
        # same ring through the plain versions
        _zero_launch_counts()
        got = ring_pass(leaves, do, sp, scale)
        torch.cuda.synchronize()
        launches = list(_launch_counts())
        by_instance = _instance_counts()
        err_ring = [_errors(g, r) for g, r in zip(got, refs)]
        kernel_attend = ring.flash_attention_with_lse
        ring.flash_attention_with_lse = _plain_flash_with_lse
        try:
            err_plain = [_errors(g, r) for g, r in
                         zip(ring_pass(leaves, do, sp, scale), refs)]
        finally:
            ring.flash_attention_with_lse = kernel_attend
        ring_ms = time_ms(lambda: ring_pass(leaves, do, sp, scale), runs=10,
                          batch=2)
        # one merge of a step's partial into the float32 carry (the ring
        # runs sp per virtual rank, sp^2 a pass, and their backward)
        o_r, lse_r = flash_attention_with_lse(q[:, :t], k[:, :t], v[:, :t],
                                              scale)
        carry = (o_r.float(), lse_r.clone())
        merge_ms = time_ms(lambda: merge_partials(*carry, o_r, lse_r))
        # forward: the single-shard path's rule; gradients: the plain
        # ring's (each step rounds its partial dK/dV, and the dO the merge
        # hands back, to bf16, so no block-wise bf16 ring keeps within
        # 1.25x of the single-shard path's mean gradient error)
        base = [err_single[0]] + err_plain[1:]
        merged_ok = all(
            r[0] <= TOL_FWD_MEAN_RATIO * s[0]
            and r[1] <= TOL_FWD_MAX_RATIO * s[1]
            for r, s in zip(err_ring, base))
        n2 = sp * sp
        row = {"phase": "ring_kernels", "sp": sp,
               "shape": [b, t_all, h, d], "block": t, "dtype": "bfloat16",
               "pairs": len(pairs), "future_pairs": sum(
                   p["future"] for p in pairs),
               "pair_max_abs_err_dq_dk_dv_max": [
                   max(p["max_abs_err_dq_dk_dv"][j] for p in pairs)
                   for j in range(3)],
               "pairs_ok": pairs_ok,
               "err_mean_max_o_dq_dk_dv": {
                   "ring": err_ring, "plain_ring": err_plain,
                   "single_shard": err_single},
               "ratio_to_single_mean_o_dq_dk_dv": [
                   r[0] / s[0] for r, s in zip(err_ring, err_single)],
               "launches_fwd_dq_dkv_per_pass": launches,
               "launches_by_instance": by_instance,
               "ring_fwd_bwd_ms": ring_ms, "single_fwd_bwd_ms": single_ms,
               "merge_ms": merge_ms}
        row["ok"] = (pairs_ok and merged_ok and launches == [n2] * 3
                     and all(c["sm90"] == n2 for c in by_instance))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"ring kernels failed at sp={sp}: {row}")
        out[sp] = row
        del got
    return out


# tp_heads: tensor parallelism over the training config's 18 heads, tp = 4
# (576 columns a rank, 4.5 heads; each attends the 5 they overlap) and 2
TP_HEADS_TPS = (4, 2)


def tp_heads_pass(cfg, leaves, wo, do, tp: int, attend) -> list:
    """One pass of every virtual rank of a tensor-parallel group of ``tp``
    in this process (``model.tp_attention_in_process``: each rank's heads
    ``[lo, hi)`` attended, its columns of the output times its ``wo``
    rows, summed) on the whole q, k, v (``leaves``): ``[out, dq, dk,
    dv]``, the gradients of ``out`` against the cotangent ``do``."""
    import torch

    from kubegpu_tpu_torch.workload.model import tp_attention_in_process

    out = tp_attention_in_process(cfg, *leaves, wo, tp, attend)
    return [out, *torch.autograd.grad(out, leaves, do)]


def tp_heads_phase(dev) -> dict:
    """K1, K2 and K3 on the head spans of tensor parallelism over head
    counts tp does not divide, at the training shape (18 heads, tp = 4 and
    2), every virtual rank in one process: one pass (tp launches of each)
    held against the single-device kernels over all 18 heads and against
    the same pass through the plain versions, then each rank's kernel times
    beside the 18-head kernels' over tp."""
    import torch

    from kubegpu_tpu_torch.workload.kernels.flash import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq)
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  head_span)

    cfg = TransformerConfig(**TRAIN_MODEL)
    b, t, h, d = TRAIN_SHAPE
    width = h * d
    bf16 = torch.bfloat16
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = case_qkv(gen, dev, b, t, t, h, d, bf16)
    wo = (torch.randn((width, width), generator=gen, device=dev)
          * width ** -0.5).to(bf16)
    do = torch.randn((b, t, width), generator=gen, device=dev).to(bf16)

    # the float32 plain reference over all heads
    qf, kf, vf, wof = (x.float() for x in (q, k, v, wo))
    o_ref, lse_ref = flash_attention_plain(qf, kf, vf, scale)
    refs = [o_ref.reshape(b, t, width) @ wof, *flash_attention_bwd_plain(
        qf, kf, vf, o_ref, lse_ref,
        (do.float() @ wof.T).reshape(b, t, h, d), None, scale)]
    del qf, kf, vf, wof, o_ref, lse_ref
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def kernels(q, k, v):
        return flash_attention(q, k, v, scale)

    def plain(q, k, v):
        return _plain_flash_with_lse(q, k, v, scale)[0]

    def single(tp):
        """The single-device kernels over all 18 heads, the product with
        ``wo`` split into the pass's tp partial sums (so the comparison
        sees the head spans, not the bf16 rounding of the partials)."""
        o = flash_attention(*leaves, scale).reshape(b, t, width)
        out = sum(o[..., c0:c1] @ wo[c0:c1] for c0, c1, _, _ in
                  (head_span(cfg, tp, r) for r in range(tp)))
        return [out, *torch.autograd.grad(out, leaves, do)]

    # the 18-head kernels' times: K1, and K2 + K3 on its output
    o_all, lse_all = flash_attention_with_lse(*leaves, scale)
    do_all = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf16)
    dlse = torch.zeros((b, h, t), device=dev)

    def bwd(q, k, v, o, dob, lse, dl):
        delta = flash_bwd_dq(q, k, v, o, dob, lse, dl, scale)[1]
        flash_bwd_dkv(q, k, v, dob, lse, delta, scale)

    with torch.no_grad():
        fwd_all_ms = time_ms(lambda: flash_attention_with_lse(q, k, v,
                                                              scale))
        bwd_all_ms = time_ms(lambda: bwd(q, k, v, o_all.detach(), do_all,
                                         lse_all.detach(), dlse))
    out = {}
    for tp in TP_HEADS_TPS:
        one = single(tp)
        err_single = [_errors(g, r) for g, r in zip(one, refs)]
        _zero_launch_counts()
        got = tp_heads_pass(cfg, leaves, wo, do, tp, kernels)
        torch.cuda.synchronize()
        launches = list(_launch_counts())
        by_instance = _instance_counts()
        err_got = [_errors(g, r) for g, r in zip(got, refs)]
        err_plain = [_errors(g, r) for g, r in
                     zip(tp_heads_pass(cfg, leaves, wo, do, tp, plain),
                         refs)]
        max_vs_single = [(a.float() - w.float()).abs().max().item()
                         for a, w in zip(got, one)]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        within = all(
            g[0] <= TOL_FWD_MEAN_RATIO * base[0]
            and g[1] <= TOL_FWD_MAX_RATIO * base[1]
            for errs in (err_single, err_plain)
            for g, base in zip(err_got, errs))
        ranks = []
        with torch.no_grad():
            for r in range(tp):
                c0, c1, lo, hi = head_span(cfg, tp, r)
                qs, ks, vs = (x[:, :, lo:hi] for x in (q, k, v))
                o_r, lse_r = flash_attention_with_lse(qs, ks, vs, scale)
                dl_r = dlse[:, lo:hi]
                ranks.append({
                    "rank": r, "columns": [c0, c1], "heads": [lo, hi],
                    "k1_ms": time_ms(lambda: flash_attention_with_lse(
                        qs, ks, vs, scale)),
                    "k2_k3_ms": time_ms(lambda: bwd(
                        qs, ks, vs, o_r, do_all[:, :, lo:hi], lse_r,
                        dl_r))})
        pass_ms = time_ms(lambda: tp_heads_pass(cfg, leaves, wo, do, tp,
                                                kernels), runs=10, batch=2)
        single_ms = time_ms(lambda: single(tp), runs=10, batch=2)
        row = {"phase": "tp_heads", "tp": tp, "shape": [b, t, h, d],
               "dtype": "bfloat16", "columns_per_rank": width // tp,
               "heads_attended": sum(x["heads"][1] - x["heads"][0]
                                     for x in ranks),
               "err_mean_max_out_dq_dk_dv": {
                   "in_process": err_got, "plain_in_process": err_plain,
                   "single_device": err_single},
               "ratio_to_single_mean_out_dq_dk_dv": [
                   g[0] / s[0] for g, s in zip(err_got, err_single)],
               "max_abs_diff_to_single_out_dq_dk_dv": max_vs_single,
               "launches_fwd_dq_dkv_per_pass": launches,
               "launches_by_instance": by_instance,
               "ranks": ranks,
               "k1_18_heads_ms_over_tp": fwd_all_ms / tp,
               "k2_k3_18_heads_ms_over_tp": bwd_all_ms / tp,
               "k1_ranks_ms_sum": sum(x["k1_ms"] for x in ranks),
               "k2_k3_ranks_ms_sum": sum(x["k2_k3_ms"] for x in ranks),
               "k1_18_heads_ms": fwd_all_ms, "k2_k3_18_heads_ms": bwd_all_ms,
               "pass_fwd_bwd_ms": pass_ms, "single_fwd_bwd_ms": single_ms}
        row["ok"] = (within and finite and launches == [tp] * 3
                     and all(c["sm90"] == tp for c in by_instance))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"tp_heads failed at tp={tp}: {row}")
        out[tp] = row
        del got, one
    return out


@contextlib.contextmanager
def world_of_one(dev):
    """A world-size-1 process group (NCCL on the card; a ``file://`` store
    in a temporary directory) for the mesh phases; yields the directory,
    which they may use, and removes it after."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from kubegpu_tpu_torch.workload import spmd

    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-mesh-")
    dist.init_process_group(spmd.backend_for(dev),
                            init_method=f"file://{tmp}/store",
                            world_size=1, rank=0)
    try:
        yield tmp
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def train_mesh_phase(dev, train, tmp) -> dict:
    """The sharded training path on the card at world size 1 (NCCL, in
    `world_of_one`): the multi-device dry run, then the sharded step at the
    training config (dp = sp = tp = 1) against the single-device step on
    one batch (loss and per-leaf gradients, 6 K1, K2 and K3 sm90
    launches), and its AdamW steps' median ms beside the ``train``
    phase's."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubegpu_tpu_torch.entry import dryrun_multichip
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  make_loss_fn)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step,
                                                  param_leaves)

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    backend = dist.get_backend()
    t0 = time.perf_counter()
    dryrun_multichip(n_dev, device=dev)
    dryrun_s = time.perf_counter() - t0

    cfg = TransformerConfig(**TRAIN_MODEL)
    mesh = spmd.make_mesh(1, 1, 1, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    params, _, _ = init_sharded(
        torch.Generator(device=dev).manual_seed(2), cfg,
        init_optimizer=False)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    loss_one, g_one = _loss_and_grads(cfg, params, tokens)
    local = spmd.shard_params(params, cfg, mesh)
    del params
    leaves = param_leaves(local)
    for x in leaves:
        x.requires_grad_(True)
    _zero_launch_counts()
    loss = make_loss_fn(cfg, mesh)(local, spmd.global_batch(mesh, tokens))
    loss.backward()
    spmd.all_reduce_grads(leaves, mesh)
    torch.cuda.synchronize()
    grad_launches = list(_launch_counts())
    grad_by_instance = _instance_counts()
    loss_mesh = loss.item()
    grad_err = _grad_errors([x.grad for x in leaves], g_one)
    del g_one, local, leaves, loss
    torch.cuda.empty_cache()

    # AdamW steps through the user's entry points, from the loader
    paths = _token_shards(cfg.vocab, tmp)
    loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    params, opt_state, optimizer = init_sharded(
        torch.Generator(device=dev).manual_seed(0), cfg, mesh)
    step = make_train_step(cfg, mesh, optimizer)
    losses, step_s, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = next(loader)                 # the global batch, numpy
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())              # waits for the step
        step_s.append(time.perf_counter() - t0)
        launches.append(list(_launch_counts()))
    by_instance = _instance_counts()
    loader.close()
    del params, opt_state, optimizer, step
    torch.cuda.empty_cache()
    n = cfg.n_layers
    step_ms = statistics.median(step_s[1:]) * 1e3
    row = {"phase": "train_mesh", "backend": backend, "world_size": 1,
           "mesh": [1, 1, 1], "dryrun_devices": n_dev,
           "dryrun_s": dryrun_s, "model": TRAIN_MODEL,
           "loss_single": loss_one, "loss_mesh": loss_mesh,
           "grad_rel_l2_max": max(grad_err),
           "grad_launches_fwd_dq_dkv": grad_launches,
           "losses": losses, "step_ms_each": [x * 1e3 for x in step_s],
           "step_ms": step_ms, "train_step_ms": train["step_ms"],
           "launches_fwd_dq_dkv_per_step": launches}
    row["ok"] = (
        backend == spmd.backend_for(dev)
        and abs(loss_mesh - loss_one) <= TOL_REMAT_LOSS * abs(loss_one)
        and all(np.isfinite(grad_err)) and max(grad_err) <= TOL_REMAT_GRAD
        and grad_launches == [n] * 3
        and all(c["sm90"] == n for c in grad_by_instance)
        and all(np.isfinite(losses)) and losses[-1] < losses[0]
        and all(x == [n] * 3 for x in launches)
        and all(c["sm90"] == n for c in by_instance))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_mesh phase failed: {row}")
    return row


def serve_mesh_phase(dev, serve, ckpt, tmp) -> dict:
    """The sharded serving paths and the sharded resume on the card at
    world size 1 (in `world_of_one`): the serving config's sharded
    generate, server and speculative server against the unsharded ones in
    float32, and the bf16 generate (K4 at each decode step) against the
    unsharded one, tokens/s in bf16 in turns; the training config's sharded
    save, restore and resumed steps against the uninterrupted run; the dry
    run with its serving leg."""
    import dataclasses

    import numpy as np
    import torch

    from kubegpu_tpu_torch.entry import dryrun_multichip
    from kubegpu_tpu_torch.workload import spmd
    from kubegpu_tpu_torch.workload.checkpoint import (
        adamw_state, adamw_template, load_train_state, restore_checkpoint,
        save_checkpoint, train_state_specs)
    from kubegpu_tpu_torch.workload.data import make_loader
    from kubegpu_tpu_torch.workload.decode import make_generate
    from kubegpu_tpu_torch.workload.kernels import decode_attn
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    mesh = spmd.make_mesh(1, 1, 1, 1, device=dev)
    # the serving config (the serve phase's params: the same seed)
    cfg = TransformerConfig(**MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    local = spmd.shard_params(params, cfg, mesh)
    dcfg = TransformerConfig(**DRAFT_MODEL)
    dlocal = spmd.shard_params(
        init_params(torch.Generator(device=dev).manual_seed(1), dcfg),
        dcfg, mesh)
    f32, df32 = (dataclasses.replace(c, dtype="float32") for c in (cfg, dcfg))
    prompts = _serve_prompts(cfg)
    # 4 rows of equal length: the 4 longest prompts cut to the shortest
    rows = [p[:len(prompts[4])] for p in prompts[4:]]
    gen_mesh = make_generate(f32, mesh)(local, rows, SERVE_MAX_NEW)
    gen_one = make_generate(f32)(params, torch.tensor(rows, device=dev),
                                 SERVE_MAX_NEW)
    # bf16: whole heads over the mesh take K4 at every decode step, each
    # launch checked against the plain version
    with checked_decode_attn() as k4_checked:
        before = decode_attn.decode_attention.launches
        gen_mesh_bf16 = make_generate(cfg, mesh)(local, rows, SERVE_MAX_NEW)
        k4_launches = decode_attn.decode_attention.launches - before
    gen_one_bf16 = make_generate(cfg)(params, torch.tensor(rows, device=dev),
                                      SERVE_MAX_NEW)
    plain = _drain(f32, params, prompts)["outs"]
    sharded = _drain(f32, local, prompts, mesh=mesh)["outs"]
    spec = _drain(f32, local, prompts, mesh=mesh, draft_params=dlocal,
                  draft_cfg=df32, lookahead=SPEC_LOOKAHEAD,
                  spec_rounds=SPEC_ROUNDS)["outs"]
    # bf16 greedy tokens/s, one drain each (in turns over several pairs:
    # tools/mesh_serve_ab.py)
    mesh_rate = _drain(cfg, local, prompts, mesh=mesh)["tokens_per_s"]
    plain_rate = _drain(cfg, params, prompts)["tokens_per_s"]
    del params, local, dlocal
    torch.cuda.empty_cache()

    # the sharded resume at the training config
    tcfg = TransformerConfig(**TRAIN_MODEL)
    specs = train_state_specs(spmd.param_pspecs(tcfg))
    paths = _token_shards(tcfg.vocab, tmp)
    ckpt_dir = os.path.join(tmp, "ckpt")

    def run(seed, start, n, save_at=None, restore=False) -> tuple:
        """``n`` sharded steps from batch ``start`` of the loader from
        fresh shards (``seed``), restored first if asked, saved after
        ``save_at`` steps: the losses, launches a step, save and restore
        seconds."""
        params, opt, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(seed), tcfg, mesh)
        secs = {}
        if restore:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, at = restore_checkpoint(
                ckpt_dir, {"params": params,
                           "opt_state": adamw_template(params)},
                mesh=mesh, specs=specs)
            load_train_state(opt, params, state)
            torch.cuda.synchronize()
            secs["restore_s"] = time.perf_counter() - t0
            secs["restored_step"] = at
            del state
        step = make_train_step(tcfg, mesh, optimizer)
        loader = make_loader(paths, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        losses, launches = [], []
        try:
            for _ in range(start):
                next(loader)
            for i in range(start, start + n):
                batch = next(loader)
                _zero_launch_counts()
                params, opt, loss = step(params, opt, batch)
                losses.append(loss.item())
                launches.append(list(_launch_counts()))
                if save_at == i + 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    save_checkpoint(ckpt_dir, {
                        "params": params,
                        "opt_state": adamw_state(opt, params)},
                        step=i + 1, mesh=mesh, specs=specs)
                    secs["save_s"] = time.perf_counter() - t0
        finally:
            loader.close()
        return losses, launches, _instance_counts(), secs

    whole, _, _, saved = run(0, 0, 4, save_at=2)
    torch.cuda.empty_cache()
    resumed, launches, by_instance, restored = run(7, 2, 2, restore=True)
    torch.cuda.empty_cache()
    file_gb = os.path.getsize(os.path.join(ckpt_dir, "step_2",
                                           "leaves.npz")) / 1e9
    t0 = time.perf_counter()
    dryrun_multichip(1, device=dev)
    dryrun_s = time.perf_counter() - t0
    n = tcfg.n_layers
    row = {"phase": "serve_mesh", "mesh": [1, 1, 1],
           "generate_rows": [len(r) for r in rows],
           "generate_equal": bool(torch.equal(gen_mesh, gen_one)),
           "bf16_generate_equal": bool(torch.equal(gen_mesh_bf16,
                                                   gen_one_bf16)),
           "bf16_generate_decode_attn_launches": k4_launches,
           "bf16_generate_decode_attn_checked": k4_checked,
           "server_equal": sharded == plain,
           "spec_server_equal": spec == plain,
           "all_full_length": all(len(o) == SERVE_MAX_NEW
                                  for o in sharded + spec),
           "bf16_mesh_tokens_per_s": mesh_rate,
           "bf16_plain_tokens_per_s": plain_rate,
           "serve_phase_tokens_per_s": serve["tokens_per_s"],
           "resume_model": TRAIN_MODEL, "losses_uninterrupted": whole,
           "losses_resumed": resumed,
           "restored_step": restored["restored_step"],
           "resumed_equal": resumed == whole[2:],
           "launches_fwd_dq_dkv_per_step": launches,
           "file_gb": file_gb, "save_s": saved["save_s"],
           "restore_s": restored["restore_s"],
           "checkpoint_phase_save_s": ckpt["full_save_s"],
           "checkpoint_phase_restore_s": ckpt["full_restore_s"],
           "dryrun_s": dryrun_s}
    row["ok"] = (row["generate_equal"] and row["server_equal"]
                 and row["bf16_generate_equal"]
                 and k4_launches == (SERVE_MAX_NEW - 1) * cfg.n_layers
                 and _k4_checked_ok(k4_checked)
                 and row["spec_server_equal"] and row["all_full_length"]
                 and row["restored_step"] == 2 and row["resumed_equal"]
                 and all(np.isfinite(whole))
                 and all(x == [n] * 3 for x in launches)
                 and all(c["sm90"] == n for c in by_instance))
    row["bf16_mesh_over_plain"] = mesh_rate / plain_rate
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve_mesh phase failed: {row}")
    return row


# the device side: the hooked pod trains DEVICE_STEPS steps at the training
# config (TRAIN_MODEL, TRAIN_BATCH, TRAIN_SEQ)
DEVICE_STEPS = 3
NODE = "smoke-rig"
# The pod's command: ``python -m kubegpu_tpu_torch.cmd.train_demo ARGS``
# (runpy, as -m runs it), with K1-K3's launch counts set to 0 before it and
# printed as the last line after it.
POD_RUNNER = """\
import json, runpy, sys
from kubegpu_tpu_torch.workload.kernels import flash
kernels = (flash.flash_attention_with_lse, flash.flash_bwd_dq,
           flash.flash_bwd_dkv)
for k in kernels:
    k.launches = 0
    k.launches_by_instance = dict.fromkeys(k.launches_by_instance, 0)
rc = 0
try:
    runpy.run_module("kubegpu_tpu_torch.cmd.train_demo", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print(json.dumps({"launches": [k.launches for k in kernels],
                  "by_instance": [dict(k.launches_by_instance)
                                  for k in kernels]}))
sys.exit(rc)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _StubAPI:
    """The two reads the runtime hook makes of the API server, from
    dicts."""

    def __init__(self, pods: dict, nodes: dict):
        self.pods, self.nodes = pods, nodes

    def get_pod(self, name: str) -> dict:
        return json.loads(json.dumps(self.pods[name]))

    def get_node(self, name: str) -> dict:
        return json.loads(json.dumps(self.nodes[name]))


def _free_gang_id(start: int = 733) -> int:
    """A gang id from ``start`` on whose coordinator port
    (``scheduler/gang.py``) is free on this machine: the engine's contract
    names it, and the pod's process group binds it."""
    import socket

    from kubegpu_tpu_torch.scheduler.gang import gang_coordinator_port

    for gid in range(start, start + 200):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", gang_coordinator_port(gid)))
                return gid
            except OSError:
                continue
    raise AssertionError("no free gang coordinator port")


def _gpu_pod(name: str, numgpu: int, gang: int | None = None,
             size: int | None = None, auto: bool = False) -> dict:
    """An unbound pod asking for ``numgpu`` cards (a gang member when
    ``gang`` is given; auto-topology when ``auto``)."""
    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.core.types import ContainerInfo, PodInfo

    info = PodInfo(name=name, running_containers={"main": ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: numgpu})})
    if gang is not None:
        info.requests[grammar.RESOURCE_GANG] = gang
        info.requests[grammar.RESOURCE_GANG_SIZE] = size
    if auto:
        info.requests[grammar.GPU_TOPOLOGY_GENERATION] = 1
    meta = {"name": name}
    codec.pod_info_to_annotation(meta, info)
    return {"metadata": meta, "spec": {"containers": [{"name": "main"}]}}


def _gpu_node(name: str, backend) -> dict:
    """A node object advertising ``backend``'s cards, as the node agent
    writes it."""
    from kubegpu_tpu_torch.core import codec
    from kubegpu_tpu_torch.core.types import NodeInfo
    from kubegpu_tpu_torch.node.manager import GPUDeviceManager

    info = NodeInfo(name=name)
    GPUDeviceManager(backend).update_node_info(info)
    meta = {"name": name, "annotations": {
        codec.NODE_ADDRESS_ANNOTATION: "127.0.0.1"}}
    codec.node_info_to_annotation(meta, info)
    return {"metadata": meta,
            "status": {"allocatable": {"cpu": "64", "pods": 256}}}


class _EngineFace:
    """A dict-backed API for the port's scheduling engine in this process:
    the calls it makes (nodes and pods listed and read; pods created,
    bound, annotated and deleted; a gang bound at once with
    ``bind_many``; events recorded; PDBs listed; watch callbacks), over
    the dicts and lock it is given. Callbacks run after the lock is
    released."""

    def __init__(self, nodes: dict, pods: dict, lock):
        self.nodes, self.pods, self._lock = nodes, pods, lock
        self._watchers: list = []
        self.events: dict = {}          # pod name -> [(reason, message)]
        self.pdbs: list = []            # PodDisruptionBudgets, as listed

    @staticmethod
    def _copy(obj: dict) -> dict:
        return json.loads(json.dumps(obj))

    def add_watcher(self, fn) -> None:
        self._watchers.append(fn)

    def notify(self, kind: str, event: str, obj: dict) -> None:
        for fn in list(self._watchers):
            fn(kind, event, obj)

    def _pod(self, name: str) -> dict:
        from kubegpu_tpu_torch.cluster.httpapi import NotFound

        if name not in self.pods:
            raise NotFound(f"pod {name} not found")
        return self.pods[name]

    def list_nodes(self) -> list:
        with self._lock:
            return [self._copy(n) for n in self.nodes.values()]

    def get_node(self, name: str) -> dict:
        with self._lock:
            return self._copy(self.nodes[name])

    def add_node(self, node: dict) -> None:
        with self._lock:
            self.nodes[node["metadata"]["name"]] = node
            obj = self._copy(node)
        self.notify("node", "added", obj)

    def list_pods(self, node_name=None, phase=None, bound=False) -> list:
        with self._lock:
            return [self._copy(p) for p in self.pods.values()
                    if (not bound or (p.get("spec") or {}).get("nodeName"))
                    and node_name in (None, (p.get("spec") or {}).get(
                        "nodeName"))
                    and phase in (None, (p.get("status") or {}).get(
                        "phase"))]

    def get_pod(self, name: str) -> dict:
        with self._lock:
            return self._copy(self._pod(name))

    def create_pod(self, pod: dict) -> None:
        with self._lock:
            self.pods[pod["metadata"]["name"]] = self._copy(pod)
            obj = self._copy(pod)
        self.notify("pod", "added", obj)

    def bind_pod(self, name: str, node_name: str) -> None:
        from kubegpu_tpu_torch.cluster.httpapi import Conflict

        with self._lock:
            spec = self._pod(name).setdefault("spec", {})
            if spec.get("nodeName") not in (None, node_name):
                raise Conflict(f"pod {name} is bound to {spec['nodeName']}")
            spec["nodeName"] = node_name
            obj = self._copy(self.pods[name])
        self.notify("pod", "modified", obj)

    def bind_many(self, bindings: dict, annotations: dict) -> None:
        """A gang's commit, all or nothing: every pod's annotations and
        node, or none when any pod is missing or bound elsewhere."""
        from kubegpu_tpu_torch.cluster.httpapi import Conflict

        with self._lock:
            for name, node_name in bindings.items():
                bound = (self._pod(name).get("spec") or {}).get("nodeName")
                if bound not in (None, node_name):
                    raise Conflict(f"pod {name} is bound to {bound}",
                                   per_pod={name: "bound elsewhere"})
            changed = []
            for name, node_name in sorted(bindings.items()):
                pod = self.pods[name]
                pod.setdefault("metadata", {})["annotations"] = dict(
                    annotations.get(name) or {})
                pod.setdefault("spec", {})["nodeName"] = node_name
                changed.append(self._copy(pod))
        for obj in changed:
            self.notify("pod", "modified", obj)

    def update_pod_annotations(self, name: str, annotations: dict) -> dict:
        with self._lock:
            self._pod(name).setdefault("metadata", {})["annotations"] = \
                dict(annotations)
            obj = self._copy(self.pods[name])
        self.notify("pod", "modified", obj)
        return obj

    def update_pod_annotations_many(self, annotations: dict) -> None:
        """{pod: annotations}, all or none (every pod must exist)."""
        with self._lock:
            for name in annotations:
                self._pod(name)
            changed = []
            for name, ann in sorted(annotations.items()):
                self.pods[name].setdefault("metadata", {})["annotations"] = \
                    dict(ann)
                changed.append(self._copy(self.pods[name]))
        for obj in changed:
            self.notify("pod", "modified", obj)

    def delete_pod(self, name: str) -> None:
        with self._lock:
            obj = self._pod(name)
            del self.pods[name]
        self.notify("pod", "deleted", obj)

    def list_pdbs(self) -> list:
        with self._lock:
            return self._copy(self.pdbs)

    def record_event(self, kind: str, name: str, event_type: str,
                     reason: str, message: str) -> None:
        with self._lock:
            self.events.setdefault(name, []).append((reason, message))


class _PortAPIServer:
    """The port's own API server in this process: `serve_api` over the
    port's `InMemoryAPIServer` on loopback, on both of its wires (or,
    with ``stream_wire=False``, refusing the upgrade as a server without
    the stream wire does). ``api`` is the store itself, which the engine
    and the gates read; ``log`` is the server's event log (its live
    stream subscribers, the batches it encoded for them). What the gates
    read besides: `node_patches`, the node PATCHes that changed a node,
    from the store's own watch (every advertise pass stamps a new
    heartbeat, so each lands as one event); `requests`, the server's
    ``api_requests_total{server="apiserver"}`` (process-wide: one server
    at a time when it is read); and the log's own fault counts,
    ``stream_poisoned`` (stream connections dropped on a protocol fault)
    and ``upgrades_refused`` (upgrades answered with plain HTTP)."""

    def __init__(self, stream_wire: bool = True):
        import threading

        from kubegpu_tpu_torch.cluster.apiserver import InMemoryAPIServer
        from kubegpu_tpu_torch.cluster.httpapi import serve_api

        self.api = InMemoryAPIServer()
        self._server, self.url = serve_api(self.api,
                                           stream_wire=stream_wire)
        self.log = self._server.event_log
        self._lock = threading.Lock()
        self._patches: dict = {}
        outer = self

        def count(kind, event, obj):
            if kind == "node" and event == "modified":
                with outer._lock:
                    name = obj["metadata"]["name"]
                    outer._patches[name] = outer._patches.get(name, 0) + 1

        self.api.add_watcher(count)

    def node_patches(self, name: str) -> int:
        with self._lock:
            return self._patches.get(name, 0)

    def node_annotations(self, name: str) -> dict:
        """A node's annotations; {} while it is not registered."""
        from kubegpu_tpu_torch.cluster.apiserver import NotFound

        try:
            node = self.api.get_node(name)
        except NotFound:
            return {}
        return (node.get("metadata") or {}).get("annotations") or {}

    def bound_to(self, name: str):
        from kubegpu_tpu_torch.cluster.apiserver import NotFound

        try:
            return (self.api.get_pod(name).get("spec") or {}).get("nodeName")
        except NotFound:
            return None

    def event_reasons(self, name: str) -> set:
        return {e["reason"] for e in self.api.list_events(involved_name=name)}

    @staticmethod
    def requests() -> float:
        from kubegpu_tpu_torch import metrics

        return metrics.API_REQUESTS.labels("apiserver").value

    def close(self) -> None:
        self._server.shutdown()


def _wait_for(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _http_json(url: str, body=None) -> dict:
    import urllib.request

    req = urllib.request.Request(
        url, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _pod_result(logs: str) -> tuple:
    """The pod runner's two result lines in its log: train_demo's JSON
    summary and the launch counts it prints last."""
    docs = []
    for line in logs.splitlines():
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict):
            docs.append(doc)
    summary = [d for d in docs if "losses_full" in d]
    counted = [d for d in docs if "launches" in d and "by_instance" in d]
    if not summary or not counted:
        raise AssertionError(f"the pod's log has no result: {logs[-3000:]}")
    return summary[-1], counted[-1]


def _smi_inventory() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,memory.total,pci.bus_id",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [[f.strip() for f in ln.split(",")]
            for ln in out.strip().splitlines()]


def _transport_bytes(healthz: int) -> dict:
    """A node agent's or scheduler binary's ``transport_bytes_total`` from
    the ``/metrics`` of its health port, as ``{(wire, dir): bytes}``."""
    import re
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{healthz}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    return {(m[1], m[2]): int(m[3]) for m in re.finditer(
        r'^transport_bytes_total\{wire="(\w+)",dir="(\w+)"\} (\d+)$', text,
        re.M)}


def _bytes_per_advertise(server, healthz: int, wire: str,
                         passes: int = 2) -> dict:
    """The tx and rx bytes one advertise pass (GET the node, PATCH its
    metadata) moves on ``wire``, from the agent's own counters read at two
    quiet points ``passes`` passes apart: the agent advertises every
    second, and each point is read 0.2 s after a pass landed in the
    server (`_PortAPIServer.node_patches`)."""
    def quiet_point(after: int):
        _wait_for(lambda: server.node_patches(NODE) > after, 10,
                  "an advertise pass")
        time.sleep(0.2)
        return server.node_patches(NODE), _transport_bytes(healthz)

    c0, b0 = quiet_point(server.node_patches(NODE))
    c1, b1 = quiet_point(c0 + passes - 1)
    return {d + "_bytes_per_advertise":
            (b1.get((wire, d), 0) - b0.get((wire, d), 0)) / (c1 - c0)
            for d in ("tx", "rx")}


def _patch_round_trips(url: str, annotations: dict, calls: int = 50) -> dict:
    """Median ms of the port client's ``patch_node_metadata`` carrying
    ``annotations`` (the card's real advertisement) to the server at ``url``
    over ``calls`` calls on each wire, the wires in turns, each client
    warmed by one call first."""
    import statistics

    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient

    name = NODE + "-wire"
    clients = {w: HTTPAPIClient(url, wire=w) for w in ("json", "stream")}
    times = {w: [] for w in clients}
    patch = {"annotations": dict(annotations)}
    try:
        clients["json"].create_node({"metadata": {"name": name}})
        for c in clients.values():
            c.patch_node_metadata(name, patch)
        for _ in range(calls):
            for w, c in clients.items():
                t = time.perf_counter()
                c.patch_node_metadata(name, patch)
                times[w].append((time.perf_counter() - t) * 1e3)
        if clients["stream"].wire != "stream":
            raise AssertionError("the stream client negotiated down")
    finally:
        for c in clients.values():
            c.close()
    return {w: statistics.median(v) for w, v in times.items()}


def _negotiation_leg(root: str, base_env: dict, want: dict) -> dict:
    """The port's node agent on its default wire against the port's
    server without the stream wire (``serve_api(stream_wire=False)``),
    which answers the upgrade with plain HTTP: the agent negotiates down
    once (one upgrade the server refused over all its advertise passes,
    no stream byte in its counters, no stream subscriber or pushed batch
    in the server's log), advertises ``want`` (the stream run's
    annotations, heartbeat aside) over JSON, and stops on SIGTERM with
    exit 0. Returns the JSON wire's first advertise and bytes per
    advertise pass."""
    import signal
    import tempfile

    from kubegpu_tpu_torch.core import codec

    server = _PortAPIServer(stream_wire=False)
    healthz = _free_port()
    err = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.cmd.node_agent",
         "--api", server.url, "--node-name", NODE, "--node-address",
         "127.0.0.1", "--backend", "nvml", "--register-node",
         "--healthz-port", str(healthz), "--advertise-interval", "1"],
        cwd=root, env=base_env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        def advertised():
            ann = server.node_annotations(NODE)
            return ann if codec.NODE_ANNOTATION_KEY in ann else None

        try:
            ann = _wait_for(advertised, 60, "the negotiated advertise")
        except AssertionError:
            err.seek(0)
            raise AssertionError(f"no advertise over the negotiated wire: "
                                 f"{err.read()[-3000:]}") from None
        first_advertise_s = time.perf_counter() - t0
        strip = {codec.NODE_HEARTBEAT_ANNOTATION}
        got = {k: v for k, v in ann.items() if k not in strip}
        if got != {k: v for k, v in want.items() if k not in strip}:
            raise AssertionError(f"over json the agent advertised {got}, "
                                 f"over stream {want}")
        per_pass = _bytes_per_advertise(server, healthz, "json")
        moved = _transport_bytes(healthz)
        refused = server.log.upgrades_refused
        pushed = (server.log.stream_subscriber_count(),
                  server.log.stream_encodes)
        if refused != 1 or pushed != (0, 0) or \
                not moved.get(("json", "tx")) or \
                any(w != "json" for w, _ in moved):
            raise AssertionError(f"negotiation: {refused} upgrades refused, "
                                 f"(subscribers, batches) {pushed}, the "
                                 f"agent moved {moved}")
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=10) != 0:
            raise AssertionError(f"the agent exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
        server.close()
    return {"first_advertise_s": first_advertise_s,
            "upgrades_refused": refused, **per_pass,
            "seconds": time.perf_counter() - t0}


def device_side_phase() -> dict:
    """NVML discovery, advertising, placement and the runtime hook on this
    card, then a subprocess with the hook's env that trains on the card it
    was given. Raises on any mismatch."""
    import torch

    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.core.types import ContainerInfo, NodeInfo, PodInfo
    from kubegpu_tpu_torch.node.manager import CONTROL_DEVICES, GPUDeviceManager
    from kubegpu_tpu_torch.node.nvml import NVMLBackend
    from kubegpu_tpu_torch.runtime.hook import (GANG_PROCESS_ANNOTATION,
                                                GPURuntimeHook)
    from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # 1. NVML against nvidia-smi
    backend = NVMLBackend()
    t = time.perf_counter()
    inv = backend.enumerate()
    enumerate_ms = (time.perf_counter() - t) * 1e3
    smi = _smi_inventory()
    if len(smi) != len(inv.gpus) or not inv.gpus:
        raise AssertionError(f"NVML lists {len(inv.gpus)} cards, "
                             f"nvidia-smi {len(smi)}")
    for gpu, (index, uuid, mem, bus) in zip(inv.gpus, smi):
        want_bus = None if bus.upper() in ("[N/A]", "N/A") else bus.upper()
        got = (str(gpu.index), gpu.uuid, f"{gpu.memory_bytes // 2**20} MiB",
               gpu.pci_bus_id.upper() if gpu.pci_bus_id else None)
        if got != (index, uuid, mem, want_bus):
            raise AssertionError(f"NVML {got} != nvidia-smi "
                                 f"{(index, uuid, mem, want_bus)}")
        if not os.path.exists(f"/dev/nvidia{gpu.minor}"):
            raise AssertionError(f"/dev/nvidia{gpu.minor} does not exist")
    # 2. advertise, and the codec's round trip
    mgr = GPUDeviceManager(backend)
    info = NodeInfo(name=NODE)
    mgr.update_node_info(info)
    if info.allocatable.get(grammar.RESOURCE_NUM_GPU) != len(inv.gpus):
        raise AssertionError(f"advertised {info.allocatable}")
    meta = {"name": NODE}
    codec.node_info_to_annotation(meta, info)
    node = codec.annotation_to_node_info(meta)
    if node.to_json() != info.to_json():
        raise AssertionError("the node annotation did not round-trip")
    # 3. placement: one card fits, one more than the host has does not
    sched = GPUScheduler()
    sched.add_node(NODE, node)

    def pod(name, n):
        return PodInfo(name=name, running_containers={
            "main": ContainerInfo(requests={grammar.RESOURCE_NUM_GPU: n})})

    one = pod("smoke-pod", 1)
    fits, reasons, score = sched.pod_fits_device(node, one, True, True)
    alloc = one.running_containers["main"].allocate_from
    cards = [grammar.gpu_id_from_path(p) for p in alloc.values()
             if grammar.gpu_id_from_path(p)]
    if not fits or len(cards) != 1:
        raise AssertionError(f"numgpu 1 did not fit: {reasons}")
    sched.take_pod_resources(node, one, True)
    too_many = pod("smoke-too-many", len(inv.gpus) + 1)
    fits2, reasons2, _ = sched.pod_fits_device(node, too_many, False, True)
    if fits2 or not any(grammar.RESOURCE_NUM_GPU in str(r.resource_name)
                        for r in reasons2):
        raise AssertionError(f"numgpu {len(inv.gpus) + 1} fit: {reasons2}")
    # 4. the hook, over a dict-backed API: a stale /dev/nvidia9 entry and a
    # one-rank gang coordinated on this node
    one.node_name = NODE
    pod_meta = {"name": one.name, "annotations": {
        GANG_PROCESS_ANNOTATION: json.dumps({
            "gang": 0, "rank": 0, "count": 1, "coordinator_node": NODE,
            "coordinator_port": _free_port()})}}
    codec.pod_info_to_annotation(pod_meta, one)
    api = _StubAPI(
        {one.name: {"metadata": pod_meta, "spec": {
            "nodeName": NODE, "containers": [{"name": "main"}]}}},
        {NODE: {"metadata": {"name": NODE, "annotations": {
            codec.NODE_ADDRESS_ANNOTATION: "127.0.0.1"}}}})
    config = {"devices": [
        {"host_path": "/dev/nvidia9", "container_path": "/dev/nvidia9"},
        {"host_path": "/dev/null", "container_path": "/dev/null"}],
        "envs": [{"key": "CUDA_VISIBLE_DEVICES", "value": "9"}]}
    cfg = GPURuntimeHook(api, mgr).create_container(one.name, "main", config)
    env = {e["key"]: e["value"] for e in cfg["envs"]}
    gpu = inv.gpu(cards[0])
    devices = [d["host_path"] for d in cfg["devices"]]
    want_devices = ["/dev/null", f"/dev/nvidia{gpu.minor}", *CONTROL_DEVICES]
    if devices[:len(want_devices)] != want_devices or \
            any(d.startswith("/dev/nvidia") and d not in want_devices
                and d != "/dev/nvidia-uvm-tools" for d in devices):
        raise AssertionError(f"hook devices {devices}")
    want_env = {"CUDA_VISIBLE_DEVICES": gpu.uuid,
                "NVIDIA_VISIBLE_DEVICES": gpu.uuid, "MASTER_ADDR": "127.0.0.1",
                "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    if any(env.get(k) != v for k, v in want_env.items()) or \
            "MASTER_PORT" not in env:
        raise AssertionError(f"hook env {env}")
    # 5. the probe: the parent's environment with every variable of the
    # device and process contract replaced by exactly the hook's
    base_env = {k: v for k, v in os.environ.items() if k not in (
        "CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    child_env = dict(base_env, **env)
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    seen = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.cuda.device_count(), "
         "torch.cuda.get_device_properties(0).uuid)"],
        env=child_env, cwd=root, capture_output=True, text=True, timeout=120)
    if seen.returncode != 0:
        raise AssertionError(f"the pod's probe failed: {seen.stderr[-2000:]}")
    count, uuid = seen.stdout.split()
    if count != "1" or f"GPU-{uuid}" != gpu.uuid:
        raise AssertionError(f"the pod sees {count} card(s), "
                             f"GPU-{uuid} against {gpu.uuid}")
    probe_s = time.perf_counter() - t
    # 6. the port's node agent, over the port's API server, runs the pod
    agent = _node_agent_run(root, base_env, info, mgr, config)
    # 7. against a server without the stream wire it negotiates down
    json_wire = _negotiation_leg(root, base_env,
                                 agent.pop("advertised_annotations"))
    stream_wire = agent["wire_stream"]
    emit({"phase": "control_plane_wire", "nvidia_smi": smi_line(),
          "note": "host times on the card's machine; stream bytes are whole "
                  "frames (13-byte header included), json bytes are HTTP "
                  "bodies only (headers left out); json's first advertise "
                  "includes the refused upgrade",
          "wires": {w: dict(leg, patch_rtt_ms_median=agent["patch_rtt_ms"][w])
                    for w, leg in (("stream", stream_wire),
                                   ("json", json_wire))}})
    row = {"phase": "device_side",
           "inventory": [{"index": g.index, "uuid": g.uuid, "minor": g.minor,
                          "memory_bytes": g.memory_bytes,
                          "pci_bus_id": g.pci_bus_id} for g in inv.gpus],
           "nvidia_smi": smi, "nvml_enumerate_ms": enumerate_ms,
           "advertised": sorted(info.allocatable),
           "allocation": alloc, "score": score,
           "too_many_reasons": [str(r) for r in reasons2],
           "devices": devices, "env": env, "pod_uuid": f"GPU-{uuid}",
           "pod_probe_s": probe_s, **agent, "wire_json": json_wire,
           "seconds": time.perf_counter() - t0, "ok": True}
    emit(row)
    return row


def _start_agent(root: str, base_env: dict, server, tmp: str,
                 backend: str = "nvml", node: str = NODE) -> tuple:
    """``python -m kubegpu_tpu_torch.cmd.node_agent --backend <backend>``
    over ``server`` (registering ``node``, its CRI hook on a free loopback
    port, its stderr in ``tmp``), waited for until it serves the hook and
    says it advertises: ``(process, hook url, healthz port, stderr file,
    watchdog)``. The watchdog, started before the first read, kills the
    agent after 600 s; the caller cancels it. Raises, with the agent's
    stderr, when it exits first."""
    import threading

    healthz = _free_port()
    err = open(os.path.join(tmp, f"agent-{node}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.cmd.node_agent",
         "--api", server.url, "--node-name", node, "--node-address",
         "127.0.0.1", "--backend", backend, "--register-node", "--cri-port",
         "0", "--healthz-port", str(healthz), "--advertise-interval", "1",
         "--launch-log-dir", os.path.join(tmp, f"logs-{node}")],
        cwd=root, env=base_env, stdout=subprocess.PIPE, stderr=err, text=True)
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    cri = None
    ready = False
    for line in proc.stdout:
        if line.startswith("cri-hook serving on "):
            cri = "http://" + line.split()[-1]
        if line.startswith("node-agent advertising"):
            ready = True
            break
    if cri is None or not ready:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()
        err.close()
        with open(err.name) as f:
            raise AssertionError(f"the agent exited {proc.returncode}: "
                                 f"{f.read()[-3000:]}")
    return proc, cri, healthz, err, watchdog


def _run_training_pod(cri: str, pod: str, config: dict,
                      extra: tuple = ()) -> tuple:
    """Launch the training pod (train_demo at the training config,
    DEVICE_STEPS steps and ``extra`` arguments, under POD_RUNNER's launch
    counts) through the agent's hook at ``cri`` for ``pod``, and wait for
    it: ``(seconds, train_demo's summary, the launch counts)``. Raises
    unless it exits 0 with finite losses and 18 sm90 launches of each of
    K1-K3."""
    import math

    t = time.perf_counter()
    launched = _http_json(f"{cri}/v1/launch-container", {
        "pod": pod, "container": "main", "config": config,
        "command": [
            sys.executable, "-c", POD_RUNNER, "--steps",
            str(DEVICE_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--vocab", str(TRAIN_MODEL["vocab"]),
            "--d-model", str(TRAIN_MODEL["d_model"]),
            "--d-ff", str(TRAIN_MODEL["d_ff"]),
            "--n-layers", str(TRAIN_MODEL["n_layers"]),
            "--n-heads", str(TRAIN_MODEL["n_heads"]), *extra]})
    cid = launched["id"]

    def exited():
        st = _http_json(f"{cri}/v1/container-status?id={cid}")
        return st if st["state"] == "exited" else None

    status = _wait_for(exited, 300, "the training pod to exit")
    pod_s = time.perf_counter() - t
    logs = _http_json(f"{cri}/v1/container-logs?id={cid}")["logs"]
    if status["exit_code"] != 0:
        raise AssertionError(f"the pod exited {status['exit_code']}: "
                             f"{logs[-3000:]}")
    out, counted = _pod_result(logs)
    losses = out["losses_full"]
    if len(losses) != DEVICE_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_demo losses {losses}")
    # one K1, K2 and K3 a layer and step, all on the Hopper instance
    want = TRAIN_MODEL["n_layers"] * DEVICE_STEPS
    if counted["launches"] != [want] * 3 or any(
            by.get("sm90") != want for by in counted["by_instance"]):
        raise AssertionError(f"the pod's K1-K3 launches {counted}")
    return pod_s, out, counted


def _node_agent_run(root, base_env, info, mgr, config) -> dict:
    """``python -m kubegpu_tpu_torch.cmd.node_agent --backend nvml`` over
    the port's API server in this process (`_PortAPIServer`): it
    advertises over the stream wire, and its advertised inventory equals
    the in-process one
    (``info``), ``/healthz`` answers 200, ``cmd.cri_hook --server`` rewrites
    ``config`` as the in-process hook does and exits non-zero with a 409
    naming AllocationMismatch for a pod short of a card, ``launch-container``
    runs the training pod (train_demo at the training config, DEVICE_STEPS
    steps, a gang of one) to exit 0 with finite losses, 18 sm90 launches
    each of K1-K3 and the pod's ``pod.alpha/ContainerStatus`` in the
    server, and SIGTERM stops the agent with exit 0 within 10 s, the
    server having poisoned no stream connection and refused no upgrade.
    Returns the fields of the device_side row."""
    import signal
    import tempfile
    import urllib.request

    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.core.types import ContainerInfo, PodInfo
    from kubegpu_tpu_torch.runtime.hook import (GANG_PROCESS_ANNOTATION,
                                                GPURuntimeHook)
    from kubegpu_tpu_torch.runtime.launcher import STATUS_ANNOTATION_KEY
    from kubegpu_tpu_torch.scheduler.core import Scheduler
    from kubegpu_tpu_torch.scheduler.gang import gang_coordinator_port
    from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler

    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-agent-")
    server = _PortAPIServer()
    api = server.api
    requests0 = server.requests()
    t0 = time.perf_counter()
    proc, cri, healthz, err, watchdog = _start_agent(root, base_env, server,
                                                     tmp, "nvml")
    try:
        def advertised_annotations():
            ann = server.node_annotations(NODE)
            return ann if codec.NODE_ANNOTATION_KEY in ann else None

        ann = _wait_for(advertised_annotations, 60,
                        "the agent's first advertise")
        first_advertise_s = time.perf_counter() - t0
        advertised = codec.annotation_to_node_info({"annotations": ann})
        if advertised.to_json() != info.to_json():
            raise AssertionError(f"the agent advertised {advertised.to_json()}"
                                 f", in-process {info.to_json()}")
        heartbeat = codec.annotation_to_heartbeat({"annotations": ann})
        if heartbeat is None:
            raise AssertionError(f"no heartbeat in {sorted(ann)}")
        with urllib.request.urlopen(f"http://127.0.0.1:{healthz}/healthz",
                                    timeout=10) as r:
            healthz_status = r.status
        # the agent's default wire: it upgraded, the server dispatched its
        # requests, and its own counters moved under wire="stream" alone
        moved = _transport_bytes(healthz)
        n_served = server.requests() - requests0
        if not n_served or not moved.get(("stream", "tx")) or \
                not moved.get(("stream", "rx")) or \
                any(w != "stream" for w, _ in moved):
            raise AssertionError(f"the agent did not advertise over the "
                                 f"stream wire: {n_served} requests served, "
                                 f"{moved}")
        stream_wire = {"first_advertise_s": first_advertise_s,
                       **_bytes_per_advertise(server, healthz, "stream")}
        patch_rtt_ms = _patch_round_trips(server.url, ann)
        # the engine places the pod, a gang of one, on the node the agent
        # advertised and writes its process contract; a pod that asks for
        # one card more than it was allocated is written by hand
        engine = Scheduler(api, build_device_scheduler())
        gid = _free_gang_id()
        t = time.perf_counter()
        api.create_pod(_gpu_pod("agent-pod", 1, gang=gid, size=1))
        engine.run_until_idle()
        engine_place_ms = (time.perf_counter() - t) * 1e3
        engine.stop()
        placed = api.get_pod("agent-pod")
        contract = json.loads(placed["metadata"].get("annotations", {}).get(
            GANG_PROCESS_ANNOTATION) or "{}")
        want = {"gang": gid, "rank": 0, "count": 1, "coordinator_node": NODE,
                "coordinator_port": gang_coordinator_port(gid)}
        if placed["spec"].get("nodeName") != NODE or contract != want:
            raise AssertionError(
                f"the engine placed agent-pod on "
                f"{placed['spec'].get('nodeName')} with contract {contract}"
                f": {sorted(server.event_reasons('agent-pod'))}")
        pod = codec.kube_pod_to_pod_info(placed, invalidate_existing=False)
        alloc = pod.running_containers["main"].allocate_from
        cards = [grammar.gpu_id_from_path(p) for p in alloc.values()
                 if grammar.gpu_id_from_path(p)]
        if len(cards) != 1 or cards[0] not in {
                grammar.gpu_id_from_path(r) for r in advertised.allocatable}:
            raise AssertionError(f"agent-pod's allocation {alloc}")
        short = PodInfo(name="agent-short", running_containers={
            "main": ContainerInfo(
                requests={grammar.RESOURCE_NUM_GPU: 2},
                allocate_from=dict(alloc))})
        meta = {"name": short.name, "annotations": {
            GANG_PROCESS_ANNOTATION: json.dumps({
                "gang": 1, "rank": 0, "count": 1, "coordinator_node": NODE,
                "coordinator_port": _free_port()})}}
        codec.pod_info_to_annotation(meta, short)
        api.create_pod({"metadata": meta, "spec": {
            "nodeName": NODE, "containers": [{"name": "main"}]}})

        served = _hook_cli(root, base_env, cri, pod.name, config)
        if served.returncode != 0:
            raise AssertionError(f"cri_hook failed: {served.stderr[-2000:]}")
        in_process = GPURuntimeHook(api, mgr).create_container(
            pod.name, "main", json.loads(json.dumps(config)))
        served_cfg = json.loads(served.stdout)
        if served_cfg != in_process:
            raise AssertionError(f"served {served_cfg} != in-process "
                                 f"{in_process}")
        refused = _hook_cli(root, base_env, cri, short.name, config)
        if refused.returncode == 0 or "409" not in refused.stderr or \
                "AllocationMismatch" not in refused.stderr:
            raise AssertionError(f"numgpu 2 on one card was not refused: "
                                 f"{refused.returncode} {refused.stderr}")
        # the training pod, launched through the agent
        pod_s, out, counted = _run_training_pod(cri, pod.name, config)

        def reported_exit():
            raw = api.get_pod(pod.name)["metadata"]["annotations"].get(
                STATUS_ANNOTATION_KEY)
            main = json.loads(raw or "{}").get("main") or {}
            return main if main.get("state") == "exited" else None

        reported = _wait_for(reported_exit, 30, "the pod's status annotation")
        if reported["exit_code"] != 0:
            raise AssertionError(f"status annotation {reported}")
        # SIGTERM: the agent stops cleanly
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=10)
        stop_s = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"the agent exited {rc} on SIGTERM")
        if server.log.stream_poisoned or server.log.upgrades_refused:
            raise AssertionError(f"stream wire: {server.log.stream_poisoned}"
                                 f" connections poisoned, "
                                 f"{server.log.upgrades_refused} refusals")
        n_served = server.requests() - requests0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
        server.close()
    return {"agent_first_advertise_s": first_advertise_s,
            "agent_wire": "stream", "server_requests": n_served,
            "wire_stream": stream_wire, "patch_rtt_ms": patch_rtt_ms,
            "advertised_annotations": ann,
            "agent_healthz": healthz_status, "agent_heartbeat": heartbeat,
            "served_config": served_cfg,
            "engine_placed": {"node": NODE, "contract": contract,
                              "allocate_from": alloc,
                              "ms": engine_place_ms},
            "refused": refused.stderr.strip().splitlines()[-1],
            "pod_s": pod_s, "pod_status": reported,
            "launches_fwd_dq_dkv": counted["launches"],
            "launches_by_instance": counted["by_instance"], "train_demo": {
                k: out[k] for k in ("devices", "losses_full", "tokens_per_s",
                                    "device", "loader")},
            "agent_stop_s": stop_s}


MASS_HOSTS = 1024
MASS_PODS = 1000
MASS_SIZES = (1, 2, 4, 1)
MASS_ORACLE_S = 30.0
PATH_SWITCHES = {"default": "1", "oracle": "0"}


@contextlib.contextmanager
def _engine_path(path: str):
    """``KGTPU_BATCH`` and ``KGTPU_VECTORIZE`` for an engine built inside:
    both on (``"default"``) or both off (``"oracle"``, the scalar path);
    an engine reads them once, when it is built."""
    saved = {k: os.environ.get(k) for k in ("KGTPU_BATCH",
                                            "KGTPU_VECTORIZE")}
    os.environ.update(dict.fromkeys(saved, PATH_SWITCHES[path]))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _counted_searches():
    """The allocator searches made inside, counted at the GPU plugin's
    ``pod_fits_device``: a list that grows by one a call."""
    from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler

    calls: list = []
    real = GPUScheduler.pod_fits_device

    def counted(self, *args):
        calls.append(1)
        return real(self, *args)
    GPUScheduler.pod_fits_device = counted
    try:
        yield calls
    finally:
        GPUScheduler.pod_fits_device = real


def _mass_arrival(engine, hgx, path: str, budget_s) -> dict:
    """MASS_PODS pods of MASS_SIZES cards, cycling, created before the
    first pass onto MASS_HOSTS HGX hosts, scheduled on ``path``: until
    all bind (``budget_s`` None; any left unbound fails the phase) or
    for ``budget_s`` seconds of pod-at-a-time cycles (the oracle's rate).
    Pods bound, seconds, pods/s and allocator searches a bound pod."""
    with _engine_path(path):
        face, sched = engine([hgx(i) for i in range(MASS_HOSTS)])
    for i in range(MASS_PODS):
        face.create_pod(_gpu_pod(f"ma{i}", MASS_SIZES[i % 4]))
    with _counted_searches() as calls:
        t = time.perf_counter()
        if budget_s is None:
            sched.run_until_idle()
        else:
            deadline = t + budget_s
            while time.perf_counter() < deadline and \
                    sched.schedule_one(timeout=0.0):
                pass
        wall = time.perf_counter() - t
    sched.stop()
    with face._lock:
        bound = [p for p in face.pods.values() if p["spec"].get("nodeName")]
    if budget_s is None and len(bound) != MASS_PODS:
        raise AssertionError(f"mass arrival on the {path} path bound "
                             f"{len(bound)} of {MASS_PODS}")
    if not bound:
        raise AssertionError(f"mass arrival on the {path} path bound none")
    return {"bound": len(bound), "seconds": wall,
            "pods_per_s": len(bound) / wall,
            "searches_per_pod": len(calls) / len(bound)}


def _cards_of(pod: dict) -> list:
    """The card paths a bound pod's containers hold."""
    from kubegpu_tpu_torch.core import codec, grammar

    info = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
    return [p for c in info.running_containers.values()
            for p in c.allocate_from.values() if grammar.gpu_id_from_path(p)]


def _stream_256(engine, hgx, path: str, tenant: str | None = None,
                **kw) -> tuple:
    """256 count-mode pods of 1, 2, 4 and 8 cards (of ``tenant``, when
    given) submitted one at a time onto 64 HGX hosts, one scheduling cycle
    each, by an engine on ``path`` built with ``kw`` (``quota=``):
    ``(cycle times, [(node, cards)] per pod)``. Raises unless every card
    is used once and some pod binds."""
    import numpy as np

    from kubegpu_tpu_torch import metrics

    with _engine_path(path):
        face, sched = engine([hgx(i) for i in range(64)], **kw)
    passes = metrics.FIT_VECTOR_PASS_MS.n
    fallback = metrics.FIT_SCALAR_FALLBACK.value
    cycle_ms = []
    for i in range(256):
        pod = _gpu_pod(f"p{i}", (1, 2, 4, 8)[i % 4])
        if tenant:
            pod["metadata"]["labels"] = {"kgtpu.io/tenant": tenant}
        face.create_pod(pod)
        t = time.perf_counter()
        if not sched.schedule_one(timeout=0.0):
            raise AssertionError(f"{path}: p{i} was not queued")
        cycle_ms.append((time.perf_counter() - t) * 1e3)
    sched.stop()
    placed = [face.get_pod(f"p{i}") for i in range(256)]
    n_bound = sum(1 for p in placed if p["spec"].get("nodeName"))
    used = [c for p in placed for c in _cards_of(p)]
    if len(used) != len(set(used)) or len(used) > 512 or n_bound == 0:
        raise AssertionError(f"{path}: {n_bound} bound over {len(used)} "
                             f"cards ({len(set(used))} distinct)")
    return ({"p50": float(np.percentile(cycle_ms, 50)),
             "p95": float(np.percentile(cycle_ms, 95)),
             "max": max(cycle_ms), "bound": n_bound, "cards_used": len(used),
             "masked_passes": metrics.FIT_VECTOR_PASS_MS.n - passes,
             "scalar_fallback_nodes":
                 metrics.FIT_SCALAR_FALLBACK.value - fallback},
            [(p["spec"].get("nodeName"), _cards_of(p)) for p in placed])


PREEMPT_HOSTS = 16
PREEMPT_LOW = (3, 7, 11, 15)     # the hosts of priority-0 pods
PREEMPT_GUARDED = 7              # ... of which a PDB guards this one
PREEMPT_GANG = (3, 8, 5)         # members, cards each, priority


def _gang_preempt_leg(engine, hgx) -> dict:
    """Gang preemption on the default path: PREEMPT_HOSTS HGX hosts full
    of 1-card pods, of priority 10 but on PREEMPT_LOW, where they are of
    priority 0 and a PDB with no disruption allowed covers PREEMPT_GUARDED's.
    A gang of 3 members of 8 cards at priority 5 places nowhere; the
    engine evicts the 24 pods of the three unguarded low hosts (the
    cheapest set: no PDB violated, priority 0; equal-cost units taken by
    name) and binds the gang there. Raises unless exactly those pods went
    and the gang bound on those hosts. Prints and returns the search's
    span (ms, sets tried, plans, victims) and the ms from the first
    eviction to the last member's bind."""
    from kubegpu_tpu_torch import obs
    from kubegpu_tpu_torch.core import codec, grammar

    obs.RECORDER.clear()
    nodes = [hgx(i) for i in range(PREEMPT_HOSTS)]
    face, sched = engine(nodes)
    face.pdbs.append({"metadata": {"name": "guarded"}, "spec": {
        "selector": {"matchLabels": {"app": "guarded"}}, "minAvailable": 8}})
    for i, node in enumerate(nodes):
        cards = sorted(p for p in codec.annotation_to_node_info(
            node["metadata"]).allocatable if grammar.gpu_id_from_path(p))
        low = i in PREEMPT_LOW
        for c, path in enumerate(cards):
            pod = _gpu_pod(f"{'low' if low else 'high'}{i:02d}-{c}", 1)
            info = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
            cont = info.running_containers["main"]
            cont.dev_requests[path] = 1
            cont.allocate_from[path] = path
            info.node_name = node["metadata"]["name"]
            codec.pod_info_to_annotation(pod["metadata"], info)
            pod["spec"].update(nodeName=info.node_name,
                               priority=0 if low else 10)
            if i == PREEMPT_GUARDED:
                pod["metadata"]["labels"] = {"app": "guarded"}
            face.create_pod(pod)
    before = set(face.pods)
    n_members, n_cards, prio = PREEMPT_GANG
    members = [f"pg{r}" for r in range(n_members)]
    stamps: dict = {}
    bound: set = set()

    def watch(kind, event, obj):
        name = obj["metadata"]["name"]
        if kind == "pod" and event == "deleted":
            stamps.setdefault("evicted", time.perf_counter())
        if kind == "pod" and name in members and \
                (obj.get("spec") or {}).get("nodeName"):
            bound.add(name)
            if len(bound) == n_members:
                stamps.setdefault("bound", time.perf_counter())

    face.add_watcher(watch)
    for name in members:
        pod = _gpu_pod(name, n_cards, gang=31, size=n_members)
        pod["spec"]["priority"] = prio
        face.create_pod(pod)
    t = time.perf_counter()
    sched.run_until_idle()
    wall = time.perf_counter() - t
    sched.stop()
    gone = sorted(before - set(face.pods))
    freed = [f"hgx{i}" for i in PREEMPT_LOW if i != PREEMPT_GUARDED]
    want = sorted(f"low{int(h[3:]):02d}-{c}" for h in freed
                  for c in range(8))
    placed = sorted(face.get_pod(m)["spec"].get("nodeName") or ""
                    for m in members)
    spans = [sp for sp in obs.RECORDER.spans() if sp.name == "gang_preempt"]
    plans = [sp.dur_s * 1e3 for sp in obs.RECORDER.spans()
             if sp.name == "gang_plan"]
    if gone != want or placed != sorted(freed) or len(spans) != 1 or \
            spans[0].attrs.get("victims") != len(want):
        raise AssertionError(f"gang preemption evicted {gone}, placed the "
                             f"gang on {placed}, spans "
                             f"{[sp.attrs for sp in spans]}")
    row = {"leg": "gang_preempt", "hosts": PREEMPT_HOSTS,
           "gang": {"members": n_members, "cards": n_cards,
                    "priority": prio},
           "evicted_hosts": freed, "victims": len(gone),
           "gang_nodes": placed,
           "gang_preempt_ms": spans[0].dur_s * 1e3,
           "sets_tried": spans[0].attrs["sets_tried"],
           "plans": spans[0].attrs["plans"], "units": spans[0].attrs["units"],
           "gang_plan_ms": plans,
           "first_eviction_to_bound_ms":
               (stamps["bound"] - stamps["evicted"]) * 1e3,
           "run_until_idle_s": wall}
    emit(row)
    return row


QUOTA_HOSTS = 64
QUOTA_PODS = 400                 # one-card pods a tenant
QUOTA_WEIGHTS = {"a": 2.0, "b": 1.0}


def _quota_leg(engine, hgx, unlabelled: dict) -> dict:
    """The tenant quota gate on the default path: QUOTA_HOSTS HGX hosts
    (512 cards), weights a:b = 2:1, and QUOTA_PODS one-card pods of each
    tenant created before the first pass. a binds 341 cards and b 170:
    each holds its weighted share rounded down, and the last card stays
    free, for either tenant's next pod would overshoot its share while
    the other, below its own, is still demanding (the gate does not
    preempt). Then the 256-pod stream of one tenant with the gate on and
    off: equal placements, and each one's cycle p50 beside that of the
    unlabelled stream (``unlabelled``; a tenant label alone moves
    placements, through the priorities that read pod labels). Raises on
    any other outcome."""
    from kubegpu_tpu_torch import metrics
    from kubegpu_tpu_torch.scheduler.quota import DRFQuotaGate

    gate = DRFQuotaGate(weights=QUOTA_WEIGHTS)
    with _engine_path("default"):
        face, sched = engine([hgx(i) for i in range(QUOTA_HOSTS)],
                             quota=gate)
    for i in range(QUOTA_PODS):
        for tenant in sorted(QUOTA_WEIGHTS):
            pod = _gpu_pod(f"{tenant}{i}", 1)
            pod["metadata"]["labels"] = {"kgtpu.io/tenant": tenant}
            face.create_pod(pod)
    parked = metrics.QUOTA_PARKED.value
    t = time.perf_counter()
    sched.run_until_idle()
    wall = time.perf_counter() - t
    sched.stop()
    with face._lock:
        placed = [p for p in face.pods.values() if p["spec"].get("nodeName")]
    cards = {t: sum(len(_cards_of(p)) for p in placed
                    if p["metadata"]["labels"]["kgtpu.io/tenant"] == t)
             for t in sorted(QUOTA_WEIGHTS)}
    used = [c for p in placed for c in _cards_of(p)]
    if cards != {"a": 341, "b": 170} or len(set(used)) != len(used):
        raise AssertionError(f"the quota gate bound {cards} "
                             f"({len(used)} cards, {len(set(used))} "
                             f"distinct)")
    gated, gated_placed = _stream_256(
        engine, hgx, "default", tenant="a",
        quota=DRFQuotaGate(weights=QUOTA_WEIGHTS))
    plain, plain_placed = _stream_256(engine, hgx, "default", tenant="a")
    if gated_placed != plain_placed:
        raise AssertionError("one tenant's stream placed otherwise with the "
                             "gate on")
    row = {"leg": "quota", "hosts": QUOTA_HOSTS,
           "cards": QUOTA_HOSTS * 8, "weights": QUOTA_WEIGHTS,
           "pods_per_tenant": QUOTA_PODS, "cards_bound": cards,
           "cards_idle": QUOTA_HOSTS * 8 - len(used),
           "seconds_to_steady_state": wall,
           "quota_parked_total": metrics.QUOTA_PARKED.value - parked,
           "stream_256_cycle_ms_gate_on": gated,
           "stream_256_cycle_ms_gate_off": plain,
           "stream_256_p50_ms": {"gate_on": gated["p50"],
                                 "gate_off": plain["p50"],
                                 "unlabelled_gate_off": unlabelled["p50"]}}
    emit(row)
    return row


ALLOC_PROBLEMS = 120
ALLOC_SEARCHES = 200


def alloc_problem(rng) -> dict:
    """A random group-allocation problem in the GPU grammar, as plain data
    (``alloc``, ``used``, ``containers`` of ``(name, init, requests)``):
    0-2 group levels over 1-4 cards a group, cards and memory leaves,
    enum attributes on some cards, cards already used, and 1-2 containers
    whose request paths match the tree by name pattern with indices of
    their own."""
    g = "alpha/grpresource"
    depth = rng.choice([0, 1, 2])
    alloc, used, leaves = {}, {}, []

    def build(prefix, level):
        if level == depth:
            for d in range(rng.randint(1, 4)):
                p = f"{prefix}/gpu/dev{d}"
                alloc[f"{p}/cards"] = 1
                alloc[f"{p}/memory"] = rng.choice([80000, 96000])
                if rng.random() < 0.3:
                    alloc[f"{p}/enumType"] = rng.randint(1, 15)
                leaves.append(p)
            return
        for i in range(rng.randint(1, 2)):
            build(f"{prefix}/gpugrp{depth - 1 - level}/{i}", level + 1)

    build(g, 0)
    for p in leaves:
        if rng.random() < 0.25:
            used[f"{p}/cards"] = 1
    containers = []
    for ci in range(rng.randint(1, 2)):
        reqs = {}
        for j, p in enumerate(rng.sample(leaves,
                                         rng.randint(1, len(leaves)))):
            parts = p[len(g) + 1:].split("/")
            req = g
            for k in range(0, len(parts) - 2, 2):
                idx = j if rng.random() < 0.5 else parts[k + 1]
                req += f"/{parts[k]}/{idx}"
            req += f"/{parts[-2]}/r{j}"
            reqs[f"{req}/cards"] = 1
            if rng.random() < 0.6:
                reqs[f"{req}/memory"] = rng.choice([40000, 80000])
            if rng.random() < 0.2:
                reqs[f"{req}/enumType"] = rng.randint(1, 15)
        containers.append((f"c{ci}", ci > 0 and rng.random() >= 0.7, reqs))
    return {"alloc": alloc, "used": used, "containers": containers}


def alloc_objects(types, problem: dict) -> tuple:
    """``(NodeInfo, PodInfo)`` of ``types`` (a ``core.types`` module) for
    an `alloc_problem`."""
    node = types.NodeInfo(name="n", capacity=dict(problem["alloc"]),
                          allocatable=dict(problem["alloc"]),
                          used=dict(problem["used"]))
    pod = types.PodInfo(name="p")
    for name, init, reqs in problem["containers"]:
        phase = pod.init_containers if init else pod.running_containers
        phase[name] = types.ContainerInfo(requests=dict(reqs),
                                          dev_requests=dict(reqs))
    return node, pod


def _allocator_leg() -> dict:
    """The native allocator core on this host: ms per search of the
    native route (``grpalloc.pod_fits_group_constraints``) and of the
    plain Python path on 1-, 2-, 4- and 8-card pods over one HGX host
    (each the median of ALLOC_SEARCHES), with the share of the native
    route spent in the C call (``native.grp_allocate``, timed inside each
    search: the median of the per-search ratio); then ALLOC_PROBLEMS seeded random problems through both,
    which must agree in fit, score (bit for bit), placements and reasons.
    Prints the ``scheduler_allocator`` line and returns it."""
    import random
    import statistics

    from kubegpu_tpu_torch import native
    from kubegpu_tpu_torch.allocator import grpalloc
    from kubegpu_tpu_torch.core import codec, types
    from kubegpu_tpu_torch.node import fake
    from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler

    t0 = time.perf_counter()
    sched = GPUScheduler()
    host = codec.annotation_to_node_info(_gpu_node("hgx0", fake.FakeGPUBackend(
        fake.hgx_h100_inventory(0)))["metadata"])
    sched.add_node("hgx0", host)

    def median_ms(fn, *args):
        times = []
        for _ in range(ALLOC_SEARCHES):
            t = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def native_ms_and_share(pod):
        """Median ms of a native search, and the median share of each
        search that its ``native.grp_allocate`` call took."""
        real, inside = native.grp_allocate, []

        def timed(payload):
            t = time.perf_counter()
            try:
                return real(payload)
            finally:
                inside.append(time.perf_counter() - t)

        times, shares = [], []
        native.grp_allocate = timed
        try:
            for _ in range(ALLOC_SEARCHES):
                inside.clear()
                t = time.perf_counter()
                grpalloc.pod_fits_group_constraints(host, pod, False)
                total = time.perf_counter() - t
                times.append(total * 1e3)
                shares.append(sum(inside) / total)
        finally:
            native.grp_allocate = real
        return statistics.median(times), statistics.median(shares)

    per_search = {}
    for cards in (1, 2, 4, 8):
        pod = codec.kube_pod_to_pod_info(_gpu_pod(f"a{cards}", cards),
                                         invalidate_existing=True)
        ok, reasons = sched._translate(host, pod)
        native_fit = grpalloc.pod_fits_group_constraints(host, pod.clone(),
                                                         False)
        python_fit = grpalloc._pod_fits_group_constraints_py(
            host, pod.clone(), False)
        if not ok or not native_fit[0] or native_fit != python_fit:
            raise AssertionError(f"{cards} cards: native {native_fit}, "
                                 f"python {python_fit}, {reasons}")
        native_ms, share = native_ms_and_share(pod)
        per_search[cards] = {
            "native_ms": native_ms,
            "python_ms": median_ms(grpalloc._pod_fits_group_constraints_py,
                                   host, pod, False),
            "c_call_share": share}

    rng = random.Random(11)
    fits = 0
    for trial in range(ALLOC_PROBLEMS):
        problem = alloc_problem(rng)
        got, want = [], []
        for fit, out in ((grpalloc.pod_fits_group_constraints, got),
                         (grpalloc._pod_fits_group_constraints_py, want)):
            node, pod = alloc_objects(types, problem)
            ok, reasons, score = fit(node, pod, True)
            out.extend([ok, score, sorted(r.info() for r in reasons),
                        [dict(c.allocate_from)
                         for _, c, _ in pod.all_containers()]])
        if got != want:
            raise AssertionError(f"allocator differential, problem {trial}: "
                                 f"native {got}, python {want}")
        fits += got[0]
    row = {"phase": "scheduler_allocator", "nvidia_smi": smi_line(),
           "note": "host times of the card's machine, one thread",
           "cpu_count": os.cpu_count(), "per_search": per_search,
           "differential": {"problems": ALLOC_PROBLEMS, "equal": True,
                            "fitting": fits},
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


@contextlib.contextmanager
def _counting_searches():
    """Count the allocator's searches while the block runs: ``native``
    calls of ``native.grp_allocate`` (any thread) and ``python``, the
    ``allocator_native_fallbacks_total`` it adds."""
    import threading

    from kubegpu_tpu_torch import metrics, native

    real = native.grp_allocate
    lock = threading.Lock()
    counts = {"native": 0, "python": 0}
    before = metrics.NATIVE_FALLBACKS.value

    def counted(payload):
        with lock:
            counts["native"] += 1
        return real(payload)

    native.grp_allocate = counted
    try:
        yield counts
    finally:
        native.grp_allocate = real
        counts["python"] = metrics.NATIVE_FALLBACKS.value - before


def scheduler_phase(backend=None) -> dict:
    """The allocator core on this host (`_allocator_leg`, its own line),
    then the engine's legs (`_scheduler_legs`) with every allocator
    search counted: the phase fails unless they all went to the native
    core. ``backend`` stands in for the card's NVML (a CPU rehearsal)."""
    allocator = _allocator_leg()
    with _counting_searches() as searches:
        row = _scheduler_legs(backend)
    if searches["python"] or not searches["native"]:
        raise AssertionError(f"the scheduler phase's searches: {searches}")
    row.update(allocator_searches=searches,
               seconds=row["seconds"] + allocator["seconds"])
    emit(row)
    return row


def _scheduler_legs(backend=None) -> dict:
    """The port's scheduling engine in process, over dicts
    (`_EngineFace`): a gang of one pod more than this card's host has
    cards binds none of its members, and all of them once a
    ``fake.rig_inventory`` host joins; then the engine's host times on
    this machine: the 256-pod stream on the default path and on the
    scalar oracle (equal placements), a 16-member gang, the
    auto-topology stream, the mass arrival (`_mass_arrival`), gang
    preemption (`_gang_preempt_leg`) and the tenant quota gate
    (`_quota_leg`).
    ``backend`` stands in for the card's NVML (a CPU rehearsal). Raises on
    any mismatch."""
    import threading

    from kubegpu_tpu_torch import obs
    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.node import fake
    from kubegpu_tpu_torch.scheduler.core import Scheduler
    from kubegpu_tpu_torch.scheduler.gang import (GANG_PROCESS_ANNOTATION,
                                                  gang_coordinator_port)
    from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler

    t0 = time.perf_counter()
    if backend is None:
        from kubegpu_tpu_torch.node.nvml import NVMLBackend

        backend = NVMLBackend()

    def engine(nodes, **kw):
        face = _EngineFace({n["metadata"]["name"]: n for n in nodes}, {},
                           threading.Lock())
        return face, Scheduler(face, build_device_scheduler(), **kw)

    def hgx(i):
        return _gpu_node(f"hgx{i}", fake.FakeGPUBackend(
            fake.hgx_h100_inventory(host=i)))

    # 1. all or nothing on the card's host, then with a rig host beside it
    real = _gpu_node(NODE, backend)
    n_cards = sum(1 for r in codec.annotation_to_node_info(
        real["metadata"]).allocatable if grammar.gpu_id_from_path(r))
    face, sched = engine([real])
    members = [f"member{r}" for r in range(n_cards + 1)]
    for m in members:
        face.create_pod(_gpu_pod(m, 1, gang=21, size=len(members)))
    sched.run_until_idle()
    alone = [face.get_pod(m)["spec"].get("nodeName") for m in members]
    if any(alone) or sched.gang_buffer.pending() != len(members):
        raise AssertionError(f"a gang of {len(members)} on {n_cards} "
                             f"card(s) bound {alone}")
    face.add_node(_gpu_node("rig1", fake.FakeGPUBackend(
        fake.rig_inventory(1))))
    sched.run_until_idle()
    sched.stop()
    bound = {m: face.get_pod(m) for m in members}
    contracts = {m: json.loads(p["metadata"]["annotations"][
        GANG_PROCESS_ANNOTATION]) for m, p in bound.items()}
    nodes = {m: p["spec"].get("nodeName") for m, p in bound.items()}
    cards = [c for p in bound.values() for c in _cards_of(p)]
    want = [{"gang": 21, "rank": r, "count": len(members),
             "coordinator_node": nodes[members[0]],
             "coordinator_port": gang_coordinator_port(21)}
            for r in range(len(members))]
    if sorted(nodes.values()) != sorted([NODE] * n_cards + ["rig1"]) or \
            len(set(cards)) != len(members) or \
            [contracts[m] for m in members] != want:
        raise AssertionError(f"the gang over {NODE} and rig1: {nodes}, "
                             f"{cards}, {contracts}")

    # 2. host times: 256 count-mode pods of 1, 2, 4 and 8 cards over 64
    # HGX hosts, submitted one at a time, one scheduling cycle each, on
    # the default path and on the scalar oracle: equal card for card
    cycles = {}
    placements = {}
    for path in ("default", "oracle"):
        cycles[path], placements[path] = _stream_256(engine, hgx, path)
    if placements["default"] != placements["oracle"]:
        diff = [i for i, (a, b) in enumerate(zip(placements["default"],
                                                 placements["oracle"]))
                if a != b]
        raise AssertionError(f"the default path placed p{diff[0]} "
                             f"{placements['default'][diff[0]]}, the oracle "
                             f"{placements['oracle'][diff[0]]} "
                             f"({len(diff)} differ)")
    # the masked pass must have served the stream, not fallen back
    if cycles["default"]["masked_passes"] < 0.9 * 256 or \
            cycles["default"]["scalar_fallback_nodes"] or \
            cycles["oracle"]["masked_passes"]:
        raise AssertionError(f"masked passes {cycles}")

    # 3. a 16-member gang of 8-card pods over 16 HGX hosts
    obs.RECORDER.clear()
    face, sched = engine([hgx(i) for i in range(16)])
    for r in range(15):
        face.create_pod(_gpu_pod(f"g{r:02d}", 8, gang=5, size=16))
    sched.run_until_idle()
    if sched.gang_buffer.pending() != 15:
        raise AssertionError(f"{sched.gang_buffer.pending()} buffered")
    # the last member's cycle plans and commits the whole gang
    face.create_pod(_gpu_pod("g15", 8, gang=5, size=16))
    t = time.perf_counter()
    sched.schedule_one(timeout=0.0)
    gang_ms = (time.perf_counter() - t) * 1e3
    sched.stop()
    plan_ms = [sp.dur_s * 1e3 for sp in obs.RECORDER.spans()
               if sp.name == "gang_plan"]
    gang_pods = [face.get_pod(f"g{r:02d}") for r in range(16)]
    gang_cards = [c for p in gang_pods for c in _cards_of(p)]
    if len(plan_ms) != 1 or \
            len({p["spec"].get("nodeName") for p in gang_pods}) != 16 or \
            len(set(gang_cards)) != 128:
        raise AssertionError(f"the 16-member gang: {len(plan_ms)} plans, "
                             f"{len(set(gang_cards))} cards")

    # 4. auto-topology: a and b fill the HGX board, c lands on the PCIe host
    face, sched = engine([
        _gpu_node("host0", fake.FakeGPUBackend(fake.pcie_h100_inventory())),
        _gpu_node("host1", fake.FakeGPUBackend(
            fake.hgx_h100_inventory(host=1)))])
    for name in ("a", "b", "c"):
        face.create_pod(_gpu_pod(name, 4, auto=True))
        sched.run_until_idle()
    sched.stop()
    auto = {n: face.get_pod(n)["spec"].get("nodeName") for n in "abc"}
    if auto != {"a": "host1", "b": "host1", "c": "host0"}:
        raise AssertionError(f"auto-topology stream {auto}")

    # 5. mass arrival: MASS_PODS pods created before the first pass onto
    # MASS_HOSTS HGX hosts, on the default path; the oracle's rate from
    # as many of the same pods as it binds in MASS_ORACLE_S
    mass = {"hosts": MASS_HOSTS, "pods": MASS_PODS,
            "cards_asked": sum(MASS_SIZES[i % 4] for i in range(MASS_PODS)),
            "default": _mass_arrival(engine, hgx, "default", None),
            "oracle": _mass_arrival(engine, hgx, "oracle", MASS_ORACLE_S)}

    # 6. gang preemption, and 7. the tenant quota gate (each prints its
    # own line)
    preempt = _gang_preempt_leg(engine, hgx)
    quota = _quota_leg(engine, hgx, cycles["default"])

    row = {"phase": "scheduler", "nvidia_smi": smi_line(),
           "note": "host times of the card's machine, the engine in one "
                   "process over dicts",
           "gang_on_card_host": {"cards": n_cards, "members": len(members),
                                 "nodes": nodes, "contracts": contracts},
           "cycle_ms_256_pods_64_hgx": cycles["default"],
           "cycle_ms_256_pods_64_hgx_oracle": cycles["oracle"],
           "placements_equal": True,
           "mass_arrival": mass,
           "gang_16x8_on_16_hgx": {"plan_ms": plan_ms[0],
                                   "commit_ms": gang_ms - plan_ms[0],
                                   "cycle_ms": gang_ms},
           "auto_topology": auto, "gang_preempt": preempt, "quota": quota,
           "seconds": time.perf_counter() - t0, "ok": True}
    return row


class _SchedulerBinary:
    """``python -m kubegpu_tpu_torch.cmd.scheduler_main ARGS`` against
    ``url`` with its health server on a free port, waited for until it
    says it runs (killed, and the phase failed with its stderr, when it
    has not within 120 s); its later stdout lines collect in ``lines``."""

    def __init__(self, root: str, env: dict, tmp: str, url: str, *args):
        import threading

        self.healthz = _free_port()
        self.err_path = os.path.join(tmp, f"scheduler-{self.healthz}.err")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubegpu_tpu_torch.cmd.scheduler_main",
             "--api", url, "--healthz-port", str(self.healthz), *args],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=self._err,
            text=True)
        watchdog = threading.Timer(120, self.proc.kill)
        watchdog.start()
        self.lines: list = []
        for line in self.proc.stdout:
            self.lines.append(line.strip())
            if line.startswith(("scheduler running", "scheduler candidate",
                                "scheduler replica")):
                break
        else:
            watchdog.cancel()
            self.stop()
            raise AssertionError(f"the scheduler exited: {self.stderr()}")
        watchdog.cancel()
        self._reader = threading.Thread(
            target=lambda: self.lines.extend(
                ln.strip() for ln in self.proc.stdout), daemon=True)
        self._reader.start()

    def said(self, text: str) -> bool:
        return any(text in line for line in list(self.lines))

    def stderr(self) -> str:
        if not self._err.closed:
            self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def get(self, path: str) -> str:
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.healthz}{path}", timeout=10) as r:
            return r.read().decode()

    def metric(self, name: str) -> float:
        for line in self.get("/metrics").splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
        raise AssertionError(f"no {name} in the scheduler's /metrics")

    def stop(self, sig=None) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(sig or signal.SIGTERM)
        try:
            return self.proc.wait(timeout=10)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            if getattr(self, "_reader", None) is not None:
                self._reader.join(timeout=5)
            self.proc.stdout.close()
            self._err.close()


def _create_to_bound_ms(server, pod: dict, timeout: float,
                        what: str) -> float:
    """Create ``pod`` in the server's store and wait until a scheduler
    binds it: ms from the create to the bind landing in the store (stamped
    by a watcher of the store, not by the polling)."""
    name = pod["metadata"]["name"]
    stamp: dict = {}

    def watch(kind, event, obj):
        if kind == "pod" and obj["metadata"]["name"] == name and \
                (obj.get("spec") or {}).get("nodeName"):
            stamp.setdefault("bound", time.perf_counter())

    server.api.add_watcher(watch)
    t = time.perf_counter()
    server.api.create_pod(pod)
    _wait_for(lambda: "bound" in stamp, timeout, what)
    return (stamp["bound"] - t) * 1e3


LIFECYCLE_GRACE_S = 3.0
LIFECYCLE_STALE_S = 1.0


def _hook_cli(root: str, env: dict, cri: str, pod: str, config: dict):
    """``python -m kubegpu_tpu_torch.cmd.cri_hook --server cri`` for
    ``pod``'s container ``main``: the finished process."""
    return subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.cmd.cri_hook",
         "--server", cri, "--pod", pod, "--container", "main"],
        input=json.dumps(config), cwd=root, env=env, capture_output=True,
        text=True, timeout=120)


def _lifecycle_leg(root: str, base_env: dict, tmp: str, backend: str,
                   train: bool) -> dict:
    """The node lifecycle controller of ``kgtpu-gpu-scheduler
    --node-grace-s 3 --node-stale-s 1`` over a port API server of its own
    (`_PortAPIServer`), with two
    node agents on the card under two names: the binary binds a gang of
    one to node A (then the only node), node B registers, and A's agent is
    SIGKILLed before anything launches the pod. The controller marks A
    Stale, then Lost, deletes it and requeues the pod with its cards and
    gang contract stripped (its gang keys kept); the binary binds the copy
    to B with a contract naming B. B's hook refuses the requeued copy's
    cleared allocation (``AllocationMismatch``, 409), and ``train`` runs
    the rebound pod through B's hook (18 sm90 launches of each of K1-K3).
    Returns the lifecycle fields of the scheduler_binary row."""
    import signal

    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.runtime.hook import GANG_PROCESS_ANNOTATION

    node_a, node_b = "smoke-node-a", "smoke-node-b"
    server = _PortAPIServer()
    api = server.api
    agents: list = []
    binary = None
    stamps: dict = {}
    requeued: list = []

    def watch(kind, event, obj):
        name = obj["metadata"]["name"]
        now = time.perf_counter()
        if kind == "node" and event == "deleted" and name == node_a:
            stamps.setdefault("lost", now)
        if kind == "pod" and name == "life-pod":
            if event == "added" and "kill" in stamps:
                requeued.append(json.loads(json.dumps(obj)))
            if (obj.get("spec") or {}).get("nodeName") == node_b:
                stamps.setdefault("rebound", now)

    def advertised(node):
        return codec.NODE_ANNOTATION_KEY in server.node_annotations(node)

    try:
        agents.append(_start_agent(root, base_env, server, tmp, backend,
                                   node=node_a))
        _wait_for(lambda: advertised(node_a), 60, "node A's advertise")
        binary = _SchedulerBinary(
            root, base_env, tmp, server.url, "--wire", "stream",
            "--node-grace-s", str(LIFECYCLE_GRACE_S), "--node-stale-s",
            str(LIFECYCLE_STALE_S))
        api.add_watcher(watch)
        gid = _free_gang_id()
        _create_to_bound_ms(server,
                            _gpu_pod("life-pod", 1, gang=gid, size=1),
                            30, "the pod's bind to node A")
        first = api.get_pod("life-pod")
        if first["spec"]["nodeName"] != node_a:
            raise AssertionError(f"life-pod bound to {first['spec']}")
        agents.append(_start_agent(root, base_env, server, tmp, backend,
                                   node=node_b))
        cri_b = agents[-1][1]
        _wait_for(lambda: advertised(node_b), 60, "node B's advertise")
        stamps["kill"] = time.perf_counter()
        agents[0][0].send_signal(signal.SIGKILL)
        _wait_for(lambda: "lost" in stamps, 30, "node A Lost")
        _wait_for(lambda: "rebound" in stamps, 30, "the rebind on node B")
        placed = api.get_pod("life-pod")
        contract = json.loads(placed["metadata"].get("annotations", {}).get(
            GANG_PROCESS_ANNOTATION) or "{}")
        if contract.get("coordinator_node") != node_b or \
                contract.get("gang") != gid:
            raise AssertionError(f"the rebound pod's contract {contract}")
        # the copy the controller created: unbound, no cards, no contract,
        # its numgpu and gang keys kept
        if not requeued:
            raise AssertionError("no requeued copy of life-pod was created")
        copy = requeued[0]
        info = codec.kube_pod_to_pod_info(copy, invalidate_existing=False)
        cont = info.running_containers["main"]
        if (copy.get("spec") or {}).get("nodeName") or cont.allocate_from \
                or GANG_PROCESS_ANNOTATION in copy["metadata"].get(
                    "annotations", {}) or \
                cont.requests.get(grammar.RESOURCE_NUM_GPU) != 1 or \
                info.requests.get(grammar.RESOURCE_GANG) != gid:
            raise AssertionError(f"the requeued copy {copy}")
        node_a_left = any(n["metadata"]["name"] == node_a
                          for n in api.list_nodes())
        reasons = server.event_reasons(node_a) | \
            server.event_reasons("life-pod")
        if node_a_left or not {"NodeLost", "Evicted"} <= reasons:
            raise AssertionError(f"node A left {node_a_left}, events "
                                 f"{sorted(reasons)}")
        # A's allocation, stripped by the eviction, does not start on B
        stale = json.loads(json.dumps(copy))
        stale["metadata"]["name"] = "life-stale"
        stale["spec"]["nodeName"] = node_b
        api.create_pod(stale)
        refused = _hook_cli(root, base_env, cri_b, "life-stale",
                            {"devices": [], "envs": []})
        if refused.returncode == 0 or "409" not in refused.stderr or \
                "AllocationMismatch" not in refused.stderr:
            raise AssertionError(f"B's hook ran the stale allocation: "
                                 f"{refused.returncode} {refused.stderr}")
        lost_total = binary.metric("scheduler_node_lost_total")
        evictions = binary.metric("scheduler_evictions_total")
        if lost_total != 1 or evictions != 1:
            raise AssertionError(f"scheduler_node_lost_total {lost_total}, "
                                 f"scheduler_evictions_total {evictions}")
        alloc = codec.kube_pod_to_pod_info(
            placed, invalidate_existing=False).running_containers[
            "main"].allocate_from
        pod_s = out = counted = None
        if train:
            pod_s, out, counted = _run_training_pod(
                cri_b, "life-pod", {"devices": [], "envs": []})
        if binary.stop() != 0:
            raise AssertionError(f"the lifecycle binary exited "
                                 f"{binary.proc.returncode}: "
                                 f"{binary.stderr()}")
        agents[1][0].send_signal(signal.SIGTERM)
        if agents[1][0].wait(timeout=10) != 0:
            raise AssertionError(f"agent B exited {agents[1][0].returncode}")
    finally:
        if binary is not None:
            binary.stop()
        for proc, _, _, err, watchdog in agents:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
            err.close()
        server.close()
    return {"lifecycle": {
        "grace_s": LIFECYCLE_GRACE_S, "stale_s": LIFECYCLE_STALE_S,
        "kill_to_lost_s": stamps["lost"] - stamps["kill"],
        "lost_to_rebound_s": stamps["rebound"] - stamps["lost"],
        "node_lost_total": lost_total, "evictions_total": evictions,
        "refused": refused.stderr.strip().splitlines()[-1],
        "contract": contract, "allocate_from": alloc, "pod_s": pod_s,
        "launches_fwd_dq_dkv": counted and counted["launches"],
        "launches_by_instance": counted and counted["by_instance"],
        "losses": out and out["losses_full"]}}


class _ExtenderStub:
    """A filter extender on loopback (the scheduler extender protocol of
    ``scheduler/extender.py``) that vetoes node ``veto``; ``calls`` counts
    the filter requests it answered."""

    def __init__(self, veto: str):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        stub = self
        self.calls = 0
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                with stub._lock:
                    stub.calls += 1
                names = body.get("nodeNames") or []
                data = json.dumps({
                    "nodeNames": [n for n in names if n != veto],
                    "failedNodes": {veto: "vetoed by the smoke extender"}
                    if veto in names else {}}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True).start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _repair_leg(root: str, base_env: dict, tmp: str, backend: str,
                train: bool) -> dict:
    """The repair controller of ``kgtpu-gpu-scheduler --repair
    --tenant-quota`` with a config declaring one filter extender
    (`_ExtenderStub`, which vetoes node C, registered with a fake rig
    inventory and no agent), over a port API server of its own
    (`_PortAPIServer`), with two node agents
    on the card under the names A and B. The pod (tenant ``smoke``; not a
    gang, whose planner consults no extender) binds to A; ``train`` runs
    train_demo 3 steps with
    ``--checkpoint-dir D --checkpoint-every 3`` through A's hook (one save,
    of step 3, the one B resumes from). Then A's
    card is reported failed: NVML reports every card healthy and A's
    agent stamps its health every second, so A's agent is SIGSTOPped (the
    lifecycle controller is off, so its still heartbeat is no fault) and
    this process runs the advertiser's own pass (`DeviceAdvertiser`) over
    the card's inventory with the card failed, which patches A's node
    exactly as A's agent would: the card out of the allocatable inventory
    and in the ChipHealth annotation. The controller stamps the checkpoint
    request, evicts the pod and requeues it; the binary binds the copy to
    B, where the same command resumes from the step-3 checkpoint in D and
    trains 3 more steps (18 sm90 launches of each of K1-K3). Returns the
    ``repair`` field of the scheduler_binary row, also printed as a line
    of its own."""
    import shutil
    import signal

    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
    from kubegpu_tpu_torch.cmd.common import build_backend
    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.node import fake
    from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser
    from kubegpu_tpu_torch.node.manager import (DevicesManager,
                                                GPUDeviceManager)
    from kubegpu_tpu_torch.scheduler.lifecycle import \
        CHECKPOINT_REQUEST_ANNOTATION

    node_a, node_b, node_c = "smoke-node-a", "smoke-node-b", "smoke-node-c"
    ckpt = os.path.join(tmp, "repair-ckpt")
    # one save a pod, of the step the resume reads: A saves its last step
    # (DEVICE_STEPS), B resumes there and saves its own last step
    extra = ("--checkpoint-dir", ckpt, "--checkpoint-every",
             str(DEVICE_STEPS))
    server = _PortAPIServer()
    api = server.api
    ext = _ExtenderStub(node_c)
    config = os.path.join(tmp, "repair-config.json")
    with open(config, "w") as f:
        json.dump({"extenders": [{"urlPrefix": ext.url,
                                  "filterVerb": "filter"}],
                   "tenantWeights": {"smoke": 1.0}}, f)
    agents: list = []
    binary = None
    stamps: dict = {}
    requests: list = []

    def watch(kind, event, obj):
        if kind != "pod" or obj["metadata"]["name"] != "repair-pod":
            return
        now = time.perf_counter()
        ann = obj["metadata"].get("annotations") or {}
        if CHECKPOINT_REQUEST_ANNOTATION in ann and not requests:
            requests.append(json.loads(ann[CHECKPOINT_REQUEST_ANNOTATION]))
            stamps.setdefault("checkpoint_request", now)
        if event == "deleted" and "degraded" in stamps:
            stamps.setdefault("evicted", now)
        if (obj.get("spec") or {}).get("nodeName") == node_b:
            stamps.setdefault("rebound", now)

    def advertised(node):
        return codec.NODE_ANNOTATION_KEY in server.node_annotations(node)

    try:
        agents.append(_start_agent(root, base_env, server, tmp, backend,
                                   node=node_a))
        _wait_for(lambda: advertised(node_a), 60, "node A's advertise")
        api.create_node(_gpu_node(node_c, fake.FakeGPUBackend(
            fake.rig_inventory(7))))
        binary = _SchedulerBinary(
            root, base_env, tmp, server.url, "--wire", "stream", "--repair",
            "--tenant-quota", "--lease-ttl", "2", "--config", config)
        api.add_watcher(watch)
        pod = _gpu_pod("repair-pod", 1)
        pod["metadata"]["labels"] = {"kgtpu.io/tenant": "smoke"}
        _create_to_bound_ms(server, pod, 30, "the pod's bind to node A")
        first = api.get_pod("repair-pod")
        if first["spec"]["nodeName"] != node_a:
            raise AssertionError(f"repair-pod bound to {first['spec']}")
        alloc = codec.kube_pod_to_pod_info(
            first, invalidate_existing=False).running_containers[
            "main"].allocate_from
        uuid = next(grammar.gpu_id_from_path(p) for p in alloc.values()
                    if grammar.gpu_id_from_path(p))
        agents.append(_start_agent(root, base_env, server, tmp, backend,
                                   node=node_b))
        cri_a, cri_b = agents[0][1], agents[1][1]
        _wait_for(lambda: advertised(node_b), 60, "node B's advertise")
        pod_s_a = out_a = None
        if train:
            pod_s_a, out_a, _ = _run_training_pod(
                cri_a, "repair-pod", {"devices": [], "envs": []}, extra)
        # A's card fails: A's agent stops, and the advertiser's own pass
        # reports the card as A's agent would
        agents[0][0].send_signal(signal.SIGSTOP)
        reported = fake.FakeGPUBackend(build_backend(backend).enumerate())
        reported.set_chip_health(uuid, "failed")
        mgr = DevicesManager()
        mgr.add_device(GPUDeviceManager(reported))
        mgr.start()
        client = HTTPAPIClient(server.url, wire="json")
        try:
            stamps["degraded"] = time.perf_counter()
            DeviceAdvertiser(client, mgr, node_a,
                             address="127.0.0.1").advertise_once()
        finally:
            client.close()
        _wait_for(lambda: "rebound" in stamps, 30,
                  "the repaired pod's bind to node B")
        placed = api.get_pod("repair-pod")
        reasons = server.event_reasons("repair-pod")
        if not {"CheckpointRequested", "Evicted"} <= reasons or \
                not requests or requests[0].get("dir") != \
                "ckpt/repair-pod" or CHECKPOINT_REQUEST_ANNOTATION in \
                placed["metadata"].get("annotations", {}):
            raise AssertionError(f"the repair's events {sorted(reasons)}, "
                                 f"checkpoint requests {requests}")
        metrics_text = binary.get("/metrics")
        repaired = [float(line.split()[-1])
                    for line in metrics_text.splitlines()
                    if line.startswith('scheduler_repairs_total{outcome='
                                       '"repaired"}')]
        if repaired != [1.0]:
            raise AssertionError(f"scheduler_repairs_total {repaired}")
        pod_s_b = out_b = counted = None
        if train:
            # the older steps are not read again: only the newest stays
            for step in sorted(os.listdir(ckpt))[:-1]:
                shutil.rmtree(os.path.join(ckpt, step), ignore_errors=True)
            pod_s_b, out_b, counted = _run_training_pod(
                cri_b, "repair-pod", {"devices": [], "envs": []}, extra)
            if out_b["resumed_from_step"] != DEVICE_STEPS:
                raise AssertionError(f"the repaired pod resumed from step "
                                     f"{out_b['resumed_from_step']}")
        if binary.stop() != 0:
            raise AssertionError(f"the repair binary exited "
                                 f"{binary.proc.returncode}: "
                                 f"{binary.stderr()}")
        with ext._lock:
            ext_calls = ext.calls
        if ext_calls < 2:
            raise AssertionError(f"the extender answered {ext_calls} calls")
    finally:
        if binary is not None:
            binary.stop()
        for i, (proc, _, _, err, watchdog) in enumerate(agents):
            watchdog.cancel()
            if proc.poll() is None:
                if i == 0:
                    proc.send_signal(signal.SIGCONT)
                proc.kill()
            proc.wait()
            proc.stdout.close()
            err.close()
        server.close()
        ext.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    row = {"leg": "repair", "nodes": [node_a, node_b, node_c],
           "vetoed": node_c, "failed_card": uuid,
           "degraded_to_evicted_s": stamps["evicted"] - stamps["degraded"],
           "evicted_to_rebound_ms":
               (stamps["rebound"] - stamps["evicted"]) * 1e3,
           "checkpoint_request": requests[0],
           "scheduler_repairs_total": repaired[0],
           "extender_calls": ext_calls,
           "pod_s": {"node_a": pod_s_a, "node_b": pod_s_b},
           "first_step_on_b": out_b and out_b["resumed_from_step"] + 1,
           "losses": {"node_a": out_a and out_a["losses_full"],
                      "node_b": out_b and out_b["losses_full"]},
           "launches_fwd_dq_dkv": counted and counted["launches"],
           "launches_by_instance": counted and counted["by_instance"]}
    emit(row)
    return {"repair": row}


def scheduler_binary_phase(backend: str = "nvml", train: bool = True) -> dict:
    """``kgtpu-gpu-scheduler`` (the port's binary, a subprocess) places the
    node agent's pod on this card: the agent over NVML (``backend``) and
    two binaries ``--leader-elect --lease-ttl 2 --wire stream`` against
    the port's API server in this process (`_PortAPIServer`); the leader
    binds the agent's pod, a gang of one, with
    its gang contract, and the agent runs it through the CRI hook
    (train_demo, DEVICE_STEPS steps, 18 sm90 launches of each of K1-K3);
    the leader is killed and the standby takes the lease and binds a
    second pod (placed only), each binary's watch having subscribed over
    the stream wire in turn; a third binary ``--wire json`` binds a pod
    over the long poll of a port server without the stream wire. Then the
    node
    lifecycle leg (`_lifecycle_leg`): a pod requeued off a killed node
    rebinds on another and trains there; and the repair leg
    (`_repair_leg`): a pod moved off a failed card by the repair
    controller resumes its checkpoint on another node. ``train=False``
    leaves the pods
    unrun (a CPU rehearsal with ``backend="fake-rig"``). Raises on any
    mismatch."""
    import signal
    import tempfile

    from kubegpu_tpu_torch.cmd.common import build_backend
    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.runtime.hook import GANG_PROCESS_ANNOTATION
    from kubegpu_tpu_torch.scheduler.gang import gang_coordinator_port

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items() if k not in (
        "CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-scheduler-")
    server = _PortAPIServer()
    api = server.api
    json_server = None
    binaries: list = []
    agent = watchdog = None
    ttl = 2.0
    try:
        agent, cri, _, agent_err, watchdog = _start_agent(
            root, base_env, server, tmp, backend)
        _wait_for(lambda: codec.NODE_ANNOTATION_KEY in
                  server.node_annotations(NODE), 60, "the agent's advertise")
        subs = {"agent": server.log.stream_subscriber_count()}
        # two candidates for one lease, over the stream wire
        binaries = [_SchedulerBinary(root, base_env, tmp, server.url,
                                     "--leader-elect", "--lease-ttl",
                                     str(ttl), "--wire", "stream")
                    for _ in range(2)]
        leader = _wait_for(lambda: next(
            (b for b in binaries if b.said("became leader")), None), 30,
            "a leader")
        standby = next(b for b in binaries if b is not leader)
        # the agent's pod, a gang of one: the leader binds it
        gid = _free_gang_id()
        stream_ms = _create_to_bound_ms(
            server, _gpu_pod("sched-pod", 1, gang=gid, size=1), 30,
            "the leader's bind")
        # the leader's watch is subscribed; the standby builds its engine,
        # and subscribes, only once it leads
        subs["leader"] = server.log.stream_subscriber_count()
        leader_moved = _transport_bytes(leader.healthz)
        placed = api.get_pod("sched-pod")
        contract = json.loads(placed["metadata"].get("annotations", {}).get(
            GANG_PROCESS_ANNOTATION) or "{}")
        want = {"gang": gid, "rank": 0, "count": 1, "coordinator_node": NODE,
                "coordinator_port": gang_coordinator_port(gid)}
        if placed["spec"]["nodeName"] != NODE or contract != want:
            raise AssertionError(f"the binary placed sched-pod on "
                                 f"{placed['spec']['nodeName']} with "
                                 f"contract {contract}")
        pod = codec.kube_pod_to_pod_info(placed, invalidate_existing=False)
        alloc = pod.running_containers["main"].allocate_from
        cards = [grammar.gpu_id_from_path(p) for p in alloc.values()
                 if grammar.gpu_id_from_path(p)]
        if len(cards) != 1:
            raise AssertionError(f"sched-pod's allocation {alloc}")
        if standby.said("became leader") or \
                standby.metric("scheduler_schedule_attempts_total") != 0:
            raise AssertionError("the standby scheduled")
        transitions = leader.metric("lease_transitions_total")
        span_doc = json.loads(leader.get("/debug/pod/sched-pod"))
        spans = [s["name"] for s in span_doc["spans"]]
        # a gang's member is planned with its gang, then committed
        if transitions != 1 or not {"gang_plan", "bind_commit"} <= \
                set(spans) or span_doc["state"] != "bound":
            raise AssertionError(f"the leader's lease_transitions_total "
                                 f"{transitions}, /debug/pod {span_doc}")
        pod_s = out = counted = None
        if train:
            pod_s, out, counted = _run_training_pod(
                cri, "sched-pod", {"devices": [], "envs": []})
        # the pod is done: its card goes back, and the leader dies
        api.delete_pod("sched-pod")
        t = time.perf_counter()
        leader.stop(signal.SIGKILL)
        api.create_pod(_gpu_pod("failover-pod", 1))
        _wait_for(lambda: server.bound_to("failover-pod"), 4 * ttl,
                  "the standby's bind")
        failover_s = time.perf_counter() - t
        if not standby.said("became leader") or failover_s > 3 * ttl:
            raise AssertionError(f"failover took {failover_s} s")
        # the killed leader's subscription is gone, the new leader's live
        _wait_for(lambda: server.log.stream_subscriber_count() ==
                  subs["agent"] + 1, 10, "the new leader's subscription")
        subs["standby"] = server.log.stream_subscriber_count()
        standby_moved = _transport_bytes(standby.healthz)
        pushed = server.log.stream_encodes
        if server.log.stream_poisoned or server.log.upgrades_refused or \
                subs["leader"] != subs["agent"] + 1 or \
                not pushed or any(
                    not moved.get(("stream", "rx")) or
                    any(w != "stream" for w, _ in moved)
                    for moved in (leader_moved, standby_moved)):
            raise AssertionError(
                f"stream wire: {server.log.stream_poisoned} connections "
                f"poisoned, {server.log.upgrades_refused} refusals, "
                f"subscribers {subs}, {pushed} batches pushed, the "
                f"binaries moved {leader_moved} and {standby_moved}")
        if standby.stop() != 0:
            raise AssertionError(f"the standby exited {standby.proc.returncode}"
                                 f": {standby.stderr()}")
        # the JSON wire: a binary against a server without the stream wire,
        # which sees the pod through its long poll alone
        json_server = _PortAPIServer(stream_wire=False)
        json_server.api.create_node(_gpu_node(NODE, build_backend(backend)))
        solo = _SchedulerBinary(root, base_env, tmp, json_server.url,
                                "--wire", "json")
        binaries.append(solo)
        json_ms = _create_to_bound_ms(json_server, _gpu_pod("json-pod", 1),
                                      30, "the JSON binary's bind")
        solo_moved = _transport_bytes(solo.healthz)
        if not solo_moved.get(("json", "rx")) or \
                any(w != "json" for w, _ in solo_moved) or \
                json_server.log.stream_subscriber_count() or \
                json_server.log.stream_encodes or \
                json_server.log.upgrades_refused:
            raise AssertionError(f"the JSON binary did not long-poll: it "
                                 f"moved {solo_moved}")
        if solo.stop() != 0:
            raise AssertionError(f"the JSON binary exited "
                                 f"{solo.proc.returncode}: {solo.stderr()}")
        agent.send_signal(signal.SIGTERM)
        if agent.wait(timeout=10) != 0:
            raise AssertionError(f"the agent exited {agent.returncode}")
        life = _lifecycle_leg(root, base_env, tmp, backend, train)
        repair = _repair_leg(root, base_env, tmp, backend, train)
    finally:
        for b in binaries:
            b.stop()
        if watchdog is not None:
            watchdog.cancel()
        if agent is not None:
            if agent.poll() is None:
                agent.kill()
                agent.wait()
            agent.stdout.close()
            agent_err.close()
        server.close()
        if json_server is not None:
            json_server.close()
    row = {"phase": "scheduler_binary", "nvidia_smi": smi_line(),
           "note": "host times on the card's machine: create is the "
                   "server's write, bound the binary's bind landing in "
                   "the server's store",
           "create_to_bound_ms": {"stream": stream_ms, "json": json_ms},
           "failover_s": failover_s, "lease_ttl_s": ttl,
           "stream_subscribers": subs, "stream_batches_pushed": pushed,
           "leader_lease_transitions": transitions,
           "debug_pod_spans": len(spans), "contract": contract,
           "allocate_from": alloc, "pod_s": pod_s,
           "launches_fwd_dq_dkv": counted and counted["launches"],
           "launches_by_instance": counted and counted["by_instance"],
           "losses": out and out["losses_full"], **life, **repair,
           "seconds": time.perf_counter() - t0, "ok": True}
    emit(row)
    return row


CP_TTL_S = 3.0
CP_LABEL = {"kgtpu.io/smoke": "card"}
CP_FLOOD_THREADS = 400
CP_FLOOD_S = 3.0
CP_PATCHES = 100


class _APIServerProc:
    """``python -m kubegpu_tpu_torch.cmd.apiserver_main ARGS`` on a fixed
    loopback port, waited for until it says it listens (killed, and the
    phase failed with its stderr, when it has not within 60 s); `start`
    again after `stop` restarts it on the same port and arguments."""

    def __init__(self, root: str, env: dict, tmp: str, *args):
        self.port = self.url = None  # chosen at the first start
        self.root, self.env, self.tmp, self.args = root, env, tmp, args
        self.proc = self._err = None
        self.lives = 0

    def start(self) -> None:
        import threading

        if self.port is None:
            # picked just before the first bind: a port picked at the
            # phase's start can meanwhile become the local port of one of
            # the phase's client connections (the flood opens hundreds)
            self.port = _free_port()
            self.url = f"http://127.0.0.1:{self.port}"
        self.lives += 1
        self.err_path = os.path.join(
            self.tmp, f"apiserver-{self.port}-{self.lives}.err")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubegpu_tpu_torch.cmd.apiserver_main",
             "--port", str(self.port), *self.args],
            cwd=self.root, env=self.env, stdout=subprocess.PIPE,
            stderr=self._err, text=True)
        watchdog = threading.Timer(60, self.proc.kill)
        watchdog.start()
        line = self.proc.stdout.readline()
        watchdog.cancel()
        if not line.startswith("apiserver listening at "):
            self.stop()
            raise AssertionError(f"the apiserver said {line!r}: "
                                 f"{self.stderr()}")

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def metric(self, line_start: str) -> float:
        import urllib.request

        with urllib.request.urlopen(self.url + "/metrics", timeout=30) as r:
            for line in r.read().decode().splitlines():
                if line.startswith(line_start + " "):
                    return float(line.split()[-1])
        return 0.0

    def stop(self, sig=None) -> int:
        import signal

        if self.proc is None:
            return 0
        if self.proc.poll() is None:
            self.proc.send_signal(sig or signal.SIGTERM)
        try:
            return self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.proc.stdout.close()
            self._err.close()


def _register_hosts(client, hosts: int) -> float:
    """``hosts`` fake HGX hosts (``cp-hgx<i>``, eight cards each) created
    through ``client``; their seconds."""
    from kubegpu_tpu_torch.node import fake

    nodes = [_gpu_node(f"cp-hgx{i}", fake.FakeGPUBackend(
        fake.hgx_h100_inventory(i))) for i in range(hosts)]
    t = time.perf_counter()
    for node in nodes:
        client.create_node(node)
    return time.perf_counter() - t


class _BindWatch:
    """A watcher of pod binds through the port's client: every node each
    pod was seen bound to, and the last bind's host clock."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.nodes: dict = {}
        self.last = 0.0

    def __call__(self, kind, event, obj):
        node = (obj.get("spec") or {}).get("nodeName")
        if kind == "pod" and node:
            with self.lock:
                self.nodes.setdefault(obj["metadata"]["name"],
                                      set()).add(node)
                self.last = time.perf_counter()

    def bound(self, names) -> int:
        with self.lock:
            return sum(1 for n in names if n in self.nodes)


def _burst(client, watch, pods: int, timeout: float) -> dict:
    """MASS_SIZES cards a pod, cycling, ``pods`` pods created one by one
    through ``client``, then waited for until every one is bound: its
    seconds from the first create to the last bind, and pods/s."""
    names = [f"ma{i}" for i in range(pods)]
    t = time.perf_counter()
    for i, name in enumerate(names):
        client.create_pod(_gpu_pod(name, MASS_SIZES[i % 4]))
    created = time.perf_counter() - t
    _wait_for(lambda: watch.bound(names) == pods, timeout,
              f"{pods} pods bound")
    wall = watch.last - t
    with watch.lock:
        twice = [n for n in names if len(watch.nodes[n]) != 1]
    if twice:
        raise AssertionError(f"pods bound to two nodes: {twice[:5]}")
    return {"pods": pods, "create_s": created, "all_bound_s": wall,
            "pods_per_s": pods / wall}


def _cards_held_once(client) -> int:
    """Raise unless no ``(node, card UUID)`` is in two bound pods'
    allocations; the cards held."""
    from kubegpu_tpu_torch.core import grammar

    held: dict = {}
    for pod in client.list_pods(bound=True):
        node = pod["spec"]["nodeName"]
        for path in _cards_of(pod):
            key = (node, grammar.gpu_id_from_path(path))
            if key in held:
                raise AssertionError(f"card {key} held by {held[key]} and "
                                     f"{pod['metadata']['name']}")
            held[key] = pod["metadata"]["name"]
    return len(held)


def _pctl(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _patch_ms(client, node: str, n: int) -> list:
    """``n`` PATCHes of ``node``'s metadata, each one's ms; raises if one
    is refused."""
    out = []
    for i in range(n):
        t = time.perf_counter()
        client.patch_node_metadata(node, {"annotations": {
            "kgtpu.io/smoke-patch": str(i)}})
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _flood(url: str, node: str, threads: int, min_s: float) -> dict:
    """One tenant floods pod creates from ``threads`` connections for at
    least ``min_s`` seconds (and until one is shed, at most 20 s) while
    this thread PATCHes ``node``'s metadata (the system band): the
    creates admitted and shed (with the advised retry), and the PATCH
    p50/p99 under the flood against idle."""
    import threading

    from kubegpu_tpu_torch.cluster.httpapi import (HTTPAPIClient,
                                                    TooManyRequests)

    client = HTTPAPIClient(url, wire="stream")
    idle = _patch_ms(client, node, CP_PATCHES)
    stop = threading.Event()
    lock = threading.Lock()
    tally = {"admitted": 0, "shed": 0, "retry_after_s": set(), "errors": []}

    def flood(k: int) -> None:
        c = HTTPAPIClient(url, wire="stream")
        i = 0
        try:
            while not stop.is_set():
                pod = _gpu_pod(f"flood-{k}-{i}", 1)
                pod["metadata"]["labels"] = {"kgtpu.io/tenant": "flood"}
                i += 1
                try:
                    c.create_pod(pod)
                    with lock:
                        tally["admitted"] += 1
                except TooManyRequests as err:
                    with lock:
                        tally["shed"] += 1
                        tally["retry_after_s"].add(err.retry_after_s)
        except Exception as err:  # noqa: BLE001
            with lock:
                tally["errors"].append(f"{type(err).__name__}: {err}")
        finally:
            c.close()

    workers = [threading.Thread(target=flood, args=(k,), daemon=True,
                                name=f"tenant-flood-{k}")
               for k in range(threads)]
    t = time.perf_counter()
    for w in workers:
        w.start()
    loaded: list = []
    while True:
        loaded += _patch_ms(client, node, 10)
        elapsed = time.perf_counter() - t
        with lock:
            shed = tally["shed"]
        if elapsed >= 20 or (elapsed >= min_s and shed and
                             len(loaded) >= CP_PATCHES):
            break
    stop.set()
    for w in workers:
        w.join(timeout=60)
    client.close()
    if tally["errors"]:
        raise AssertionError(f"the flood's clients failed: "
                             f"{tally['errors'][:3]}")
    if not tally["shed"] or not all(r > 0 for r in tally["retry_after_s"]):
        raise AssertionError(f"the flood was not shed with retry_after_s: "
                             f"{tally}")
    return {"threads": threads, "seconds": elapsed,
            "admitted": tally["admitted"], "shed_429": tally["shed"],
            "retry_after_s": sorted(tally["retry_after_s"]),
            "patches_idle": len(idle), "patches_loaded": len(loaded),
            "patch_ms_idle": {"p50": _pctl(idle, 0.5),
                              "p99": _pctl(idle, 0.99)},
            "patch_ms_loaded": {"p50": _pctl(loaded, 0.5),
                                "p99": _pctl(loaded, 0.99)}}


def _replica_metrics(reps) -> dict:
    return {"commits": [r.metric("scheduler_binding_latency_microseconds"
                                 "_count") for r in reps],
            "conflicts": [r.metric("sched_conflicts_total") for r in reps]}


def control_plane_phase(backend: str = "nvml", train: bool = True,
                        hosts: int = MASS_HOSTS,
                        pods: int = MASS_PODS) -> dict:
    """The port's own control plane, every part a subprocess: a
    ``kgtpu-gpu-apiserver --wal-dir D --apf`` on the stream wire, ``hosts``
    fake HGX hosts registered through the port's client, the node agent
    on this card (``backend``), and two ``kgtpu-gpu-scheduler --replicas 2
    --shard I`` replicas. A 1-card pod is placed on the card's node (a
    nodeSelector on a label of it) and, with ``train``, trains DEVICE_STEPS
    steps through the agent (18 sm90 launches of each of K1-K3,
    ``launches_control_plane_run``). Then the mass arrival: ``pods`` pods
    of MASS_SIZES cards, each bound once, no card in two pods; seconds to
    all bound, pods/s, each replica's commits and conflicts. The server
    is SIGKILLed and restarted on its port and directory: seconds to the
    first ``/healthz`` 200, nodes and pods equal to before, a pod created
    after bound by the replicas (their watches resumed), and a
    ``/bindmany`` that claims the trained pod's card for another pod
    answered 409 naming the card. With the replicas stopped, one tenant
    floods creates (`_flood`): at least one 429 with ``retry_after_s``,
    every node PATCH answered, their p50/p99. Last, the same burst with
    one replica on a fresh server. Raises on any mismatch."""
    import signal
    import tempfile
    import types
    import urllib.request

    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
    from kubegpu_tpu_torch.cluster.lease import SHARD_LEASE_PREFIX
    from kubegpu_tpu_torch.core import codec, grammar

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items() if k not in (
        "CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-control-plane-")
    server = _APIServerProc(root, base_env, tmp, "--wal-dir",
                            os.path.join(tmp, "wal"), "--apf")
    solo_server = _APIServerProc(root, base_env, tmp, "--wal-dir",
                                 os.path.join(tmp, "wal-solo"), "--apf")
    clients: list = []
    reps: list = []
    agent = watchdog = agent_err = None
    try:
        server.start()
        client = HTTPAPIClient(server.url, wire="stream")
        clients.append(client)
        register_s = _register_hosts(client, hosts)
        agent, cri, _, agent_err, watchdog = _start_agent(
            root, base_env, types.SimpleNamespace(url=server.url), tmp,
            backend)
        _wait_for(lambda: codec.NODE_ANNOTATION_KEY in (
            client.get_node(NODE)["metadata"].get("annotations") or {}),
            60, "the agent's advertise")
        client.patch_node_metadata(NODE, {"labels": CP_LABEL})
        reps = [_SchedulerBinary(root, base_env, tmp, server.url,
                                 "--replicas", "2", "--shard", str(s),
                                 "--lease-ttl", str(CP_TTL_S),
                                 "--wire", "stream") for s in range(2)]
        # each replica takes the other's vacant shard until it sees its
        # lease: the pods come once both are held and a tick has passed
        _wait_for(lambda: all(client.lease_holder(
            f"{SHARD_LEASE_PREFIX}-{s}") for s in range(2)), 30,
            "both shard leases held")
        time.sleep(CP_TTL_S / 3 + 0.5)
        watch = _BindWatch()
        client.add_watcher(watch)
        # the pod on the card, first: its node's one card is then taken
        pod = _gpu_pod("cp-pod", 1)
        pod["spec"]["nodeSelector"] = dict(CP_LABEL)
        t = time.perf_counter()
        client.create_pod(pod)
        _wait_for(lambda: watch.bound(["cp-pod"]), 60, "cp-pod bound")
        cp_bound_ms = (watch.last - t) * 1e3
        placed = client.get_pod("cp-pod")
        alloc = codec.kube_pod_to_pod_info(
            placed, invalidate_existing=False).running_containers[
            "main"].allocate_from
        card = [grammar.gpu_id_from_path(p) for p in alloc.values()
                if grammar.gpu_id_from_path(p)]
        if placed["spec"]["nodeName"] != NODE or len(card) != 1:
            raise AssertionError(f"cp-pod on {placed['spec']['nodeName']} "
                                 f"with {alloc}")
        pod_s = out = counted = None
        if train:
            pod_s, out, counted = _run_training_pod(
                cri, "cp-pod", {"devices": [], "envs": []})
        before = _replica_metrics(reps)
        two = _burst(client, watch, pods, 300)
        after = _replica_metrics(reps)
        commits = [a - b for a, b in zip(after["commits"],
                                         before["commits"])]
        conflicts = [a - b for a, b in zip(after["conflicts"],
                                           before["conflicts"])]
        if sum(commits) != pods or not all(commits):
            raise AssertionError(f"the replicas committed {commits} of "
                                 f"{pods}")
        two.update(cards_held=_cards_held_once(client),
                   commits_per_replica=commits,
                   conflicts_per_replica=conflicts,
                   api_requests_total=server.metric(
                       'api_requests_total{server="apiserver"}'))
        # the crash: the agent stops first, so nothing moves meanwhile
        agent.send_signal(signal.SIGTERM)
        if agent.wait(timeout=10) != 0:
            raise AssertionError(f"the agent exited {agent.returncode}")
        nodes, listed = client.list_nodes(), client.list_pods()
        client.close()
        t = time.perf_counter()
        server.stop(signal.SIGKILL)
        server.start()

        def healthy():
            try:
                with urllib.request.urlopen(server.url + "/healthz",
                                            timeout=5) as r:
                    return r.status == 200
            except OSError:
                return False
        _wait_for(healthy, 60, "the restarted server's /healthz")
        recover_s = time.perf_counter() - t
        client = HTTPAPIClient(server.url, wire="stream")
        clients.append(client)
        if client.list_nodes() != nodes or client.list_pods() != listed:
            raise AssertionError("the recovered nodes or pods differ")
        watch = _BindWatch()
        client.add_watcher(watch)
        t = time.perf_counter()
        client.create_pod(_gpu_pod("after-restart", 1))
        _wait_for(lambda: watch.bound(["after-restart"]), 60,
                  "a pod created after the restart bound")
        after_restart_ms = (watch.last - t) * 1e3
        # a claim on the trained pod's card for another pod (one no
        # replica will place): refused by the recovered arbiter
        thief = _gpu_pod("thief", 1)
        thief["spec"]["nodeSelector"] = {"kgtpu.io/smoke": "none"}
        client.create_pod(thief)
        status, doc = client.forward("POST", "/bindmany", {
            "bindings": {"thief": NODE},
            "annotations": {"thief": placed["metadata"]["annotations"]}})
        if status != 409 or card[0] not in str(doc.get("per_pod", {}).get(
                "thief")):
            raise AssertionError(f"the stolen card's bind got {status} "
                                 f"{doc}")
        for r in reps:
            if r.stop() != 0:
                raise AssertionError(f"a replica exited {r.proc.returncode}"
                                     f": {r.stderr()}")
        flood = _flood(server.url, NODE, CP_FLOOD_THREADS, CP_FLOOD_S)
        flood["apf_rejects_total"] = server.metric(
            'apf_rejects_total{band="workload"}')
        flood["apf_rejects_total_system"] = server.metric(
            'apf_rejects_total{band="system"}')
        if flood["apf_rejects_total_system"]:
            raise AssertionError("the front door shed system traffic")
        client.close()
        if server.stop() != 0:
            raise AssertionError(f"the apiserver exited "
                                 f"{server.proc.returncode}: "
                                 f"{server.stderr()}")
        # the same burst, one replica, a fresh server
        solo_server.start()
        client = HTTPAPIClient(solo_server.url, wire="stream")
        clients.append(client)
        _register_hosts(client, hosts)
        solo = _SchedulerBinary(root, base_env, tmp, solo_server.url,
                                "--wire", "stream")
        reps = [solo]
        watch = _BindWatch()
        client.add_watcher(watch)
        one = _burst(client, watch, pods, 300)
        one.update(cards_held=_cards_held_once(client),
                   commits=solo.metric(
                       "scheduler_binding_latency_microseconds_count"))
        if one["commits"] != pods:
            raise AssertionError(f"the replica committed {one['commits']}")
    finally:
        for r in reps:
            r.stop()
        for c in clients:
            c.close()
        if watchdog is not None:
            watchdog.cancel()
        if agent is not None:
            if agent.poll() is None:
                agent.kill()
                agent.wait()
            agent.stdout.close()
            agent_err.close()
        server.stop()
        solo_server.stop()
    row = {"phase": "control_plane", "nvidia_smi": smi_line(),
           "note": "host times on the card's machine; every process is the "
                   "port's (apiserver --wal-dir --apf, two --replicas 2 "
                   "schedulers, the node agent)",
           "hosts": hosts, "register_s": register_s,
           "cp_pod_create_to_bound_ms": cp_bound_ms, "card": card[0],
           "pod_s": pod_s,
           "launches_fwd_dq_dkv": counted and counted["launches"],
           "launches_by_instance": counted and counted["by_instance"],
           "losses": out and out["losses_full"],
           "replicas_2": two, "replicas_1": one,
           "sigkill_to_healthz_s": recover_s, "recovered_equal": True,
           "after_restart_create_to_bound_ms": after_restart_ms,
           "stolen_card_status": status, "flood": flood,
           "seconds": time.perf_counter() - t0, "ok": True}
    emit(row)
    return row


PX_HOSTS = 256
PX_WATCHERS = 512                # downstream watchers, half on each proxy
PX_PODS = 200
# each `kgtpu-gpu-simulate --json` run of the phase: (name, arguments)
PX_SCENARIOS = (("default", ("--hosts", "4", "--schedulers", "2")),
                ("node-loss", ("--chaos", "node-loss")),
                ("chip-kill", ("--chaos", "chip-kill", "--seed", "0")),
                ("ha", ("--chaos-ha",)),
                ("tenant-flood", ("--chaos-tenant-flood", "--proxies", "2")))
# A fleet of downstream watchers in one process: ``python -c WATCHERS URL N
# PREFIX COUNT TIMEOUT``. Each subscribes on the stream wire at the proxy's
# head (pods only) and reads until it has seen each of pods PREFIX000..
# bound; the process prints "ready" once all are subscribed, then one JSON
# line: per pod the last watcher's wall-clock receipt of its first event
# and of its bind, the watchers that saw every pod bound, the order or
# relist faults, the stream bytes the watchers received and the fleet's
# CPU seconds. Each watcher reads and CRC-checks its own frames; a payload
# is decoded once a fleet (watchers at one cursor get the same bytes), so
# the fleet's decoding does not stand in for the proxy's delivery.
WATCHERS = """\
import json, sys, threading, time, urllib.request
from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.cluster import stream
from kubegpu_tpu_torch.core import codec
url, n, prefix, count, timeout = (sys.argv[1], int(sys.argv[2]),
                                  sys.argv[3], int(sys.argv[4]),
                                  float(sys.argv[5]))
with urllib.request.urlopen(url + "/watch?since=%d&timeout=0" % (1 << 62),
                            timeout=30) as r:
    head = json.loads(r.read())["seq"]
names = {"%s%03d" % (prefix, i) for i in range(count)}
conns = [stream.StreamConn.connect(url, 30.0) for _ in range(n)]
for c in conns:
    c.subscribe(head, ("pod",), 0.0, timeout=30.0)
lock = threading.Lock()
first, bound, faults, done, decoded = {}, {}, [], [0], {}

def read_push(conn, timeout):
    conn._sock.settimeout(timeout)
    ftype, _rid, payload = stream.read_frame(conn._rfile)
    if ftype == stream.PING:
        return None
    if ftype != stream.PUSH:
        raise stream.FrameError("frame type %d on a watch" % ftype)
    out = decoded.get(payload)
    if out is None:
        out = decoded[payload] = codec.decode_watch_batch(payload)
    return out

def watch(conn):
    last, seqs, seen, got = head, {}, set(), set()
    deadline = time.monotonic() + timeout
    try:
        while len(got) < count and time.monotonic() < deadline:
            out = read_push(conn, max(0.1, deadline - time.monotonic()))
            if out is None:
                continue
            now = time.time()
            bad = []
            if out.get("relist"):
                bad.append("relist")
            if out["seq"] < last:
                bad.append("batch seq %d after %d" % (out["seq"], last))
            last = out["seq"]
            for seq, kind, event, obj in out["events"]:
                name = obj["metadata"]["name"]
                if name not in names:
                    continue
                if seq <= seqs.get(name, head):
                    bad.append("%s seq %d after %d"
                               % (name, seq, seqs.get(name, head)))
                seqs[name] = seq
                with lock:
                    if name not in seen:
                        seen.add(name)
                        first[name] = max(first.get(name, 0.0), now)
                    if (obj.get("spec") or {}).get("nodeName") and \\
                            name not in got:
                        got.add(name)
                        bound[name] = max(bound.get(name, 0.0), now)
            if bad:
                with lock:
                    faults.extend(bad)
    except Exception as e:
        with lock:
            faults.append("%s: %s" % (type(e).__name__, e))
    with lock:
        done[0] += len(got) == count

threads = [threading.Thread(target=watch, args=(c,), daemon=True)
           for c in conns]
print("ready", head, flush=True)
cpu0 = time.process_time()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"first": first, "bound": bound, "complete": done[0],
                  "faults": faults[:5], "n_faults": len(faults),
                  "cpu_s": time.process_time() - cpu0,
                  "rx_bytes": sum(c.value for (w, d), c in
                                  metrics.TRANSPORT_BYTES.children()
                                  if w == stream.WIRE_STREAM and d == "rx")}),
      flush=True)
"""


class _ProxyProc:
    """``python -m kubegpu_tpu_torch.cmd.proxy_main --upstream URL --apf
    --name NAME`` on a free loopback port, waited for until it says it
    listens (killed, and the phase failed with its stderr, when it has not
    within 60 s)."""

    def __init__(self, root: str, env: dict, tmp: str, upstream: str,
                 name: str):
        import threading

        self.name = name
        self.err_path = os.path.join(tmp, f"proxy-{name}.err")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubegpu_tpu_torch.cmd.proxy_main",
             "--upstream", upstream, "--port", str(_free_port()), "--name",
             name, "--apf"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=self._err,
            text=True)
        watchdog = threading.Timer(60, self.proc.kill)
        watchdog.start()
        line = self.proc.stdout.readline()
        watchdog.cancel()
        if not line.startswith(f"proxy {name} listening at "):
            self.stop()
            with open(self.err_path) as f:
                raise AssertionError(f"the proxy said {line!r}: "
                                     f"{f.read()[-3000:]}")
        self.url = line.split()[4]

    def metrics(self) -> str:
        import urllib.request

        with urllib.request.urlopen(self.url + "/metrics", timeout=30) as r:
            return r.read().decode()

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.proc.stdout.close()
            self._err.close()


def _metric_value(text: str, line_start: str) -> float:
    for line in text.splitlines():
        if line.startswith(line_start + " "):
            return float(line.split()[-1])
    return 0.0


def _buckets(text: str, name: str) -> list:
    """``[(upper bound, cumulative count)]`` of a histogram in Prometheus
    text."""
    out = []
    for line in text.splitlines():
        if line.startswith(name + '_bucket{le="'):
            le = line.split('"')[1]
            out.append((float("inf") if le == "+Inf" else float(le),
                        float(line.split()[-1])))
    return out


def _bucket_pctl(before: list, after: list, q: float) -> float:
    """The upper bound of the bucket that holds quantile ``q`` of the
    observations between two scrapes of one histogram."""
    counts = [(le, a - b) for (le, a), (_, b) in zip(after, before)]
    total = counts[-1][1] if counts else 0
    if not total:
        return 0.0
    for le, n in counts:
        if n >= q * total:
            return le
    return counts[-1][0]


def _established(port: int) -> int:
    """TCP connections in ESTABLISHED state whose local port is ``port``
    (the server side of a loopback server's connections)."""
    n = 0
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if cols[3] == "01" and int(cols[1].rsplit(":", 1)[1], 16) == port:
                n += 1
    return n


def _cpu_s(pid: int) -> float:
    """User and system CPU seconds of process ``pid`` so far."""
    with open(f"/proc/{pid}/stat") as f:
        cols = f.read().rsplit(")", 1)[1].split()
    return (int(cols[11]) + int(cols[12])) / os.sysconf("SC_CLK_TCK")


def _fanout(root: str, env: dict, proxies: list, client, apiserver_port: int,
            watchers: int, pods: int) -> dict:
    """``watchers`` stream watchers, split over ``proxies`` (one process
    of watchers a proxy), then ``pods`` pods created through ``client``:
    every watcher sees every pod bound, in seq order, with no relist; the
    API server holds the same connections with the watchers as without;
    the last watcher's delivery p50/p99 from the create; each proxy's
    upstream lag over the burst; upstream bytes against the bytes the
    watchers received."""
    import threading

    per = watchers // len(proxies)
    before_conns = _established(apiserver_port)
    before = [_buckets(p.metrics(), "proxy_upstream_lag_ms") for p in proxies]
    fleets = [subprocess.Popen(
        [sys.executable, "-c", WATCHERS, p.url, str(per), "fo", str(pods),
         "240"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for p in proxies]
    try:
        for fleet in fleets:
            watchdog = threading.Timer(120, fleet.kill)
            watchdog.start()
            line = fleet.stdout.readline()
            watchdog.cancel()
            if not line.startswith("ready"):
                raise AssertionError(f"a watcher fleet said {line!r}: "
                                     f"{fleet.stderr.read()[-3000:]}")
        with_conns = _established(apiserver_port)
        if with_conns != before_conns:
            raise AssertionError(f"the API server held {before_conns} "
                                 f"connections without the watchers and "
                                 f"{with_conns} with them")
        up_before = [_metric_value(p.metrics(), 'transport_bytes_total{wire='
                                   '"proxy",dir="rx"}') for p in proxies]
        cpu_before = [_cpu_s(p.proc.pid) for p in proxies]
        created = {}
        for i in range(pods):
            name = f"fo{i:03d}"
            created[name] = time.time()
            client.create_pod(_gpu_pod(name, 1))
        # the gauge is read at each applied upstream batch (the burst's
        # binds among them): it counts the fleet and each proxy's own
        # clients' watches while the fleets still hold their connections
        downstream = [_wait_for(
            lambda p=p: (lambda n: n >= per and n)(_metric_value(
                p.metrics(), f'proxy_downstream_watchers{{proxy="{p.name}"}}')),
            60, f"{p.name}'s downstream watchers") for p in proxies]
        results = []
        for fleet in fleets:
            out, err = fleet.communicate(timeout=300)
            if fleet.returncode != 0:
                raise AssertionError(f"a watcher fleet exited "
                                     f"{fleet.returncode}: {err[-3000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for fleet in fleets:
            if fleet.poll() is None:
                fleet.kill()
                fleet.wait()
    texts = [p.metrics() for p in proxies]
    cpu = [_cpu_s(p.proc.pid) - c for p, c in zip(proxies, cpu_before)]
    for r in results:
        if r["n_faults"] or r["complete"] != per:
            raise AssertionError(f"{r['complete']} of {per} watchers saw "
                                 f"every pod bound; faults {r['faults']}")
    first = {n: max(r["first"][n] for r in results) - created[n]
             for n in created}
    bound = {n: max(r["bound"][n] for r in results) - created[n]
             for n in created}
    up_rx = sum(_metric_value(t, 'transport_bytes_total{wire="proxy",'
                              'dir="rx"}') for t in texts) - sum(up_before)
    down_rx = sum(r["rx_bytes"] for r in results)
    return {"watchers": per * len(proxies), "pods": pods,
            "downstream_watchers": downstream,
            "apiserver_connections": {"without_watchers": before_conns,
                                      "with_watchers": with_conns,
                                      "after_pods": _established(
                                          apiserver_port)},
            "delivery_first_event_ms": {
                "p50": _pctl(list(first.values()), 0.5) * 1e3,
                "p99": _pctl(list(first.values()), 0.99) * 1e3},
            "delivery_bound_ms": {
                "p50": _pctl(list(bound.values()), 0.5) * 1e3,
                "p99": _pctl(list(bound.values()), 0.99) * 1e3},
            "proxy_upstream_lag_ms": [
                {"proxy": p.name,
                 "p50_le": _bucket_pctl(b, _buckets(t, "proxy_upstream_lag"
                                                    "_ms"), 0.5),
                 "p99_le": _bucket_pctl(b, _buckets(t, "proxy_upstream_lag"
                                                    "_ms"), 0.99)}
                for p, b, t in zip(proxies, before, texts)],
            "upstream_proxy_rx_bytes": up_rx,
            "downstream_watchers_rx_bytes": down_rx,
            "fanout_bytes_ratio": down_rx / up_rx if up_rx else None,
            "cpu_s": {"proxies": cpu,
                      "watcher_fleets": [r["cpu_s"] for r in results]}}


def _scenario(root: str, env: dict, name: str, args: tuple) -> dict:
    """One ``kgtpu-gpu-simulate ARGS --json`` run: its document, checked,
    with its seconds."""
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.cmd.simulate", *args,
         "--json"], cwd=root, env=env, capture_output=True, text=True,
        timeout=240)
    if out.returncode != 0:
        raise AssertionError(f"simulate {name} exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    doc = json.loads(out.stdout)
    if name == "default":
        pending = [r["pod"] for r in doc["placements"]
                   if r["node"] == "<pending>"]
        if pending or doc["ha"]["schedulers"] != 2:
            raise AssertionError(f"simulate default left {pending}")
    elif name == "chip-kill":
        if doc["repairs"] < 1 or doc["relists"] or \
                doc["injected"][0][0] != "chip-kill":
            raise AssertionError(f"simulate chip-kill: {doc}")
    elif name == "ha":
        if doc["placed"] != 14 or doc["watch_relists"] or \
                sorted(doc["stolen_shards"]) != [0, 1]:
            raise AssertionError(f"simulate ha: {doc}")
    elif name == "tenant-flood":
        if set(doc["proxies"]["downstream_watchers"]) != {"proxy0",
                                                          "proxy1"} or \
                doc["evictions"] or doc["watch_relists"]:
            raise AssertionError(f"simulate tenant-flood: {doc}")
    elif doc["recovery_ms"] <= 0:
        raise AssertionError(f"simulate {name}: {doc}")
    return {"seconds": time.perf_counter() - t, "doc": doc}


def proxy_simulate_phase(backend: str = "nvml", train: bool = True,
                         hosts: int = PX_HOSTS, watchers: int = PX_WATCHERS,
                         pods: int = PX_PODS) -> dict:
    """The proxy tier with the card behind it, every process the port's: a
    ``kgtpu-gpu-apiserver --wal-dir D`` on the stream wire and two
    ``kgtpu-gpu-proxy --apf`` replicas, p0 and p1; ``hosts`` fake HGX
    hosts registered through p0 (forwarded writes), the node agent on this
    card (``backend``) against p1 and one ``kgtpu-gpu-scheduler`` against
    p0. A 1-card pod created through p1 is placed by a nodeSelector and,
    with ``train``, trains DEVICE_STEPS steps through the agent (18 sm90
    launches of each of K1-K3, ``launches_proxy_run``). The agent's hook
    reads the pod from p1's mirror, which a proxy updates before its window
    announces the batch: the phase waits for the bind on p1's own watch
    before it launches, so the read finds the allocation. Then the fan-out
    (`_fanout`): ``watchers`` watchers, half on each proxy, and ``pods``
    pods. Last, each `PX_SCENARIOS` run of ``kgtpu-gpu-simulate``. Raises
    on any failed check."""
    import tempfile
    import types

    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
    from kubegpu_tpu_torch.core import codec, grammar

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items() if k not in (
        "CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-proxy-")
    server = _APIServerProc(root, base_env, tmp, "--wal-dir",
                            os.path.join(tmp, "wal"))
    clients: list = []
    proxies: list = []
    sched = agent = watchdog = agent_err = None
    try:
        server.start()
        proxies = [_ProxyProc(root, base_env, tmp, server.url, f"p{i}")
                   for i in range(2)]
        p0 = HTTPAPIClient(proxies[0].url, wire="stream")
        p1 = HTTPAPIClient(proxies[1].url, wire="stream")
        clients += [p0, p1]
        register_s = _register_hosts(p0, hosts)
        agent, cri, _, agent_err, watchdog = _start_agent(
            root, base_env, types.SimpleNamespace(url=proxies[1].url), tmp,
            backend)
        _wait_for(lambda: codec.NODE_ANNOTATION_KEY in (
            p1.get_node(NODE)["metadata"].get("annotations") or {}),
            60, "the agent's advertise, through p1")
        p1.patch_node_metadata(NODE, {"labels": CP_LABEL})
        sched = _SchedulerBinary(root, base_env, tmp, proxies[0].url,
                                 "--wire", "stream")
        watch = _BindWatch()
        p1.add_watcher(watch)
        pod = _gpu_pod("px-pod", 1)
        pod["spec"]["nodeSelector"] = dict(CP_LABEL)
        t = time.perf_counter()
        p1.create_pod(pod)
        _wait_for(lambda: watch.bound(["px-pod"]), 60,
                  "px-pod bound, on p1's watch")
        bound_ms = (watch.last - t) * 1e3
        placed = p1.get_pod("px-pod")   # p1's mirror, as the hook reads it
        alloc = codec.kube_pod_to_pod_info(
            placed, invalidate_existing=False).running_containers[
            "main"].allocate_from
        card = [grammar.gpu_id_from_path(p) for p in alloc.values()
                if grammar.gpu_id_from_path(p)]
        if placed["spec"]["nodeName"] != NODE or len(card) != 1:
            raise AssertionError(f"px-pod on {placed['spec']['nodeName']} "
                                 f"with {alloc}")
        pod_s = out = counted = None
        if train:
            pod_s, out, counted = _run_training_pod(
                cri, "px-pod", {"devices": [], "envs": []})
        fanout = _fanout(root, base_env, proxies, p0,
                         server.port, watchers, pods)
        fanout["cards_held"] = _cards_held_once(p0)
        for c in clients:
            c.close()
        if sched.stop() != 0:
            raise AssertionError(f"the scheduler exited "
                                 f"{sched.proc.returncode}: {sched.stderr()}")
        sched = None
        for p in proxies:
            if p.stop() != 0:
                raise AssertionError(f"proxy {p.name} exited "
                                     f"{p.proc.returncode}")
        proxies = []
    finally:
        if sched is not None:
            sched.stop()
        for c in clients:
            c.close()
        if watchdog is not None:
            watchdog.cancel()
        if agent is not None:
            if agent.poll() is None:
                agent.kill()
                agent.wait()
            agent.stdout.close()
            agent_err.close()
        for p in proxies:
            p.stop()
        server.stop()
    scenarios = {name: _scenario(root, base_env, name, args)
                 for name, args in PX_SCENARIOS}
    row = {"phase": "proxy_simulate", "nvidia_smi": smi_line(),
           "note": "host times on the card's machine; every process is the "
                   "port's (apiserver --wal-dir, two proxies --apf, the "
                   "scheduler against p0, the node agent against p1)",
           "hosts": hosts, "register_through_p0_s": register_s,
           "px_pod_create_to_bound_ms": bound_ms, "card": card[0],
           "pod_s": pod_s,
           "launches_fwd_dq_dkv": counted and counted["launches"],
           "launches_by_instance": counted and counted["by_instance"],
           "losses": out and out["losses_full"], "fanout": fanout,
           "simulate": scenarios, "seconds": time.perf_counter() - t0,
           "ok": True}
    emit(row)
    return row


# the explorer phase's sharded-replica leg: the mix of
# tests/test_torch_scheduler_main.py::test_sharded_replicas_bind_every_pod_once
# (eight fake HGX hosts; a gang of two 4-card members, then 40 one-card
# pods; `--lease-ttl 1`), bound EXPLORER_ROUNDS times in a row, half the
# rounds on each wire, each within the test's 60 s
EXPLORER_HOSTS, EXPLORER_SINGLES, EXPLORER_GANG = 8, 40, (2, 4)
EXPLORER_ROUNDS, EXPLORER_WAIT_S, EXPLORER_TTL_S = 10, 60.0, 1.0


def _shard_round(client, watch, reps, tag: str, gid: int) -> dict:
    """One round of the sharded-replica mix through ``client``: the gang
    first, then the one-card pods, each bound once on one node, no card
    held twice, the plain pods committed by both replicas between them,
    the gang by the replica owning its shard; then every pod deleted. Its
    seconds from the first create to the last bind."""
    from kubegpu_tpu_torch.cluster.lease import shard_of

    members, cards = EXPLORER_GANG
    gang = [f"{tag}-g-{i}" for i in range(members)]
    singles = [f"{tag}-r{i}" for i in range(EXPLORER_SINGLES)]
    names = gang + singles
    before = _replica_metrics(reps)["commits"]
    t = time.perf_counter()
    for name in gang:
        client.create_pod(_gpu_pod(name, cards, gang=gid, size=members))
    for name in singles:
        client.create_pod(_gpu_pod(name, 1))
    _wait_for(lambda: watch.bound(names) == len(names), EXPLORER_WAIT_S,
              f"every pod of round {tag} bound")
    wall = watch.last - t
    with watch.lock:
        twice = [n for n in names if len(watch.nodes[n]) != 1]
    if twice:
        raise AssertionError(f"round {tag}: bound to two nodes: {twice}")
    held = _cards_held_once(client)
    commits = [a - b for a, b in zip(_replica_metrics(reps)["commits"],
                                     before)]
    if sum(commits) != EXPLORER_SINGLES or not all(commits):
        raise AssertionError(f"round {tag}: the replicas committed "
                             f"{commits} of {EXPLORER_SINGLES}")
    owner = reps[shard_of(f"gang:{gid}", 2)]
    state = json.loads(owner.get(f"/debug/pod/{gang[0]}"))["state"]
    if state != "bound":
        raise AssertionError(f"round {tag}: the gang's owner says {state}")
    for name in names:
        client.delete_pod(name)
    _wait_for(lambda: not any(p["metadata"]["name"] in names
                              for p in client.list_pods()), 30,
              f"round {tag}'s pods deleted")
    return {"round": tag, "gang": gid, "all_bound_s": wall,
            "commits_per_replica": commits, "cards_held": held}


def explorer_phase(backend: str = "nvml", train: bool = True) -> dict:
    """The interleaving explorer on the card machine's host, then the
    sharded-replica repair end to end.

    Every twin of ``analysis/races.py``'s catalog: each mutant (a fixed
    race put back) rediscovered within its budget, each clean scenario
    passing every schedule. The card scenarios key the node's cards as
    NVML (``backend``) gives them; on a one-card machine a fake HGX card
    stands beside the real one, which is the contended card. Each prints a
    ``twin`` line: schedules, the failing index, schedules/s.

    Then the repaired commit race under the real processes: a
    ``kgtpu-gpu-apiserver`` (both wires), EXPLORER_HOSTS fake HGX hosts,
    the node agent on this card, and two ``kgtpu-gpu-scheduler --replicas
    2`` on each wire in turn. A 1-card pod placed on the card's node (a
    nodeSelector) trains DEVICE_STEPS steps through the agent, as in
    ``control_plane`` (with ``train``; 18 sm90 launches of each of K1-K3,
    ``launches_explorer_run``), and keeps the card. Then the mix of the
    CPU test, EXPLORER_ROUNDS rounds (`_shard_round`). Raises on any
    failure."""
    import tempfile
    import types

    from kubegpu_tpu_torch.analysis import races
    from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
    from kubegpu_tpu_torch.cluster.lease import SHARD_LEASE_PREFIX
    from kubegpu_tpu_torch.cmd.common import build_backend
    from kubegpu_tpu_torch.core import codec, grammar

    t0 = time.perf_counter()
    own = races.card_paths(build_backend(backend))
    if not own:
        raise AssertionError(f"the {backend} backend advertises no card")
    cards = (own + [p for p in races.hgx_cards(7) if p not in own])[:2]
    twins = []
    for twin in races.catalog(cards):
        row = races.run_twin(twin)
        twins.append(row)
        emit({"phase": "explorer", "twin": row})
    explore_s = time.perf_counter() - t0

    root = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items() if k not in (
        "CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-explorer-")
    server = _APIServerProc(root, base_env, tmp)
    client = None
    reps: list = []
    agent = watchdog = agent_err = None
    rounds: list = []
    pod_s = out = counted = None
    try:
        server.start()
        client = HTTPAPIClient(server.url, wire="stream")
        _register_hosts(client, EXPLORER_HOSTS)
        agent, cri, _, agent_err, watchdog = _start_agent(
            root, base_env, types.SimpleNamespace(url=server.url), tmp,
            backend)
        _wait_for(lambda: codec.NODE_ANNOTATION_KEY in (
            client.get_node(NODE)["metadata"].get("annotations") or {}),
            60, "the agent's advertise")
        client.patch_node_metadata(NODE, {"labels": CP_LABEL})
        watch = _BindWatch()
        client.add_watcher(watch)
        gid = 733
        for wire in ("stream", "json"):
            reps = [_SchedulerBinary(root, base_env, tmp, server.url,
                                     "--replicas", "2", "--shard", str(s),
                                     "--lease-ttl", str(EXPLORER_TTL_S),
                                     "--wire", wire) for s in range(2)]
            # each replica takes the other's vacant shard until it sees
            # its lease: the pods come once both are held and a tick passed
            _wait_for(lambda: all(client.lease_holder(
                f"{SHARD_LEASE_PREFIX}-{s}") for s in range(2)), 30,
                "both shard leases held")
            time.sleep(EXPLORER_TTL_S)
            if wire == "stream":
                pod = _gpu_pod("explorer-pod", 1)
                pod["spec"]["nodeSelector"] = dict(CP_LABEL)
                client.create_pod(pod)
                _wait_for(lambda: watch.bound(["explorer-pod"]), 60,
                          "the card's pod bound")
                placed = client.get_pod("explorer-pod")
                alloc = codec.kube_pod_to_pod_info(
                    placed, invalidate_existing=False).running_containers[
                    "main"].allocate_from
                card = [grammar.gpu_id_from_path(p) for p in alloc.values()
                        if grammar.gpu_id_from_path(p)]
                if placed["spec"]["nodeName"] != NODE or len(card) != 1:
                    raise AssertionError(
                        f"the card's pod on {placed['spec']['nodeName']} "
                        f"with {alloc}")
                if train:
                    pod_s, out, counted = _run_training_pod(
                        cri, "explorer-pod", {"devices": [], "envs": []})
            for k in range(EXPLORER_ROUNDS // 2):
                gid = _free_gang_id(gid + 1)
                row = _shard_round(client, watch, reps,
                                   f"{wire[0]}{k}", gid)
                row["wire"] = wire
                rounds.append(row)
            for r in reps:
                if r.stop() != 0:
                    raise AssertionError(f"a replica exited "
                                         f"{r.proc.returncode}: "
                                         f"{r.stderr()}")
            reps = []
        _cards_held_once(client)
    finally:
        for r in reps:
            r.stop()
        if client is not None:
            client.close()
        if watchdog is not None:
            watchdog.cancel()
        if agent is not None:
            if agent.poll() is None:
                agent.terminate()
                try:
                    agent.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    agent.kill()
                    agent.wait()
            agent.stdout.close()
            agent_err.close()
        server.stop()
    row = {"phase": "explorer", "nvidia_smi": smi_line(),
           "note": "host times on the card's machine; the twins run in "
                   "this process, the rounds' processes are the port's "
                   "(apiserver, two --replicas 2 schedulers a wire, the "
                   "node agent)",
           "cards": [grammar.gpu_id_from_path(c) for c in cards],
           "twins": len(twins),
           "mutants_found": sum(1 for t in twins
                                if t["failing_index"] is not None),
           "explore_s": explore_s, "pod_s": pod_s,
           "launches_fwd_dq_dkv": counted and counted["launches"],
           "launches_by_instance": counted and counted["by_instance"],
           "losses": out and out["losses_full"],
           "rounds": len(rounds),
           "round_all_bound_s": [r["all_bound_s"] for r in rounds],
           "round_commits": [r["commits_per_replica"] for r in rounds],
           "seconds": time.perf_counter() - t0, "ok": True}
    emit(row)
    return row


# The kube phase: the port's real-Kubernetes client against its mock
# Kubernetes API server, KUBE_HOSTS fake HGX hosts (8 cards each) beside
# the card's node, and a burst of KUBE_BURST pods of KUBE_SIZES cards (a
# pod completes, and is deleted, as soon as the phase sees it bound, so
# 128 cards carry the burst's 750).
KUBE_HOSTS, KUBE_BURST, KUBE_SIZES = 16, 200, (1, 2, 4, 8)
KUBE_WAIT_S, KUBE_TOKEN = 60.0, "smoke-token"
KUBE_LABEL = {"kgtpu.io/smoke": "kube"}


def _counting_kube_client():
    """``KubeAPIClient`` with a count of the requests it makes (its
    ``_req``: every list, patch, bind and delete; the informers' four
    long-lived watch streams are not among them). The bind pool and the
    informers' relists call ``_req`` from several threads, so the count is
    taken under a lock."""
    import threading

    from kubegpu_tpu_torch.cluster.kubeclient import KubeAPIClient

    class Counting(KubeAPIClient):
        requests = 0
        _count_lock = threading.Lock()

        def _req(self, *args, **kwargs):
            with self._count_lock:
                self.requests += 1
            return super()._req(*args, **kwargs)

    return Counting


def kube_phase(backend: str = "nvml", train: bool = True) -> dict:
    """The port on a Kubernetes API: ``cluster/kubeclient.py`` against
    ``cluster/mock_kube.py`` (the port's `InMemoryAPIServer` behind the
    real wire grammar, bearer auth on), every component configured from a
    JSON kubeconfig through ``KubeConfig.load(path)``.

    The card's pod: ``DeviceAdvertiser`` over ``KubeAPIClient`` patches the
    card's node from ``backend`` (NVML) and KUBE_HOSTS fake HGX hosts;
    ``Scheduler`` with ``GPUScheduler`` over its own client binds a 1-card
    pod pinned to the card's node (a nodeSelector) through the Binding
    subresource; ``GPURuntimeHook`` over the client gives it
    ``CUDA_VISIBLE_DEVICES`` for that card and the port's
    ``WorkloadSupervisor`` runs it: DEVICE_STEPS training steps (with
    ``train``; 18 sm90 launches of each of K1-K3, ``launches_kube_run``).
    The burst: KUBE_BURST pods of KUBE_SIZES cards, cycling, created at
    once onto the fake hosts and each deleted once seen bound; the seconds
    until all were bound, create-to-bound p50/p99 and the scheduler's
    requests per bind. The restart leg: a pod of 4 cards on a labelled
    fake host, the scheduler replaced by a fresh one whose informers
    replay the watch, then a second 4-card pod must bind there, each card
    held once. The refused-bind leg: a card taken behind the scheduler's
    back (a rival bound through the server between its assume and its
    bind) refuses the bind; the pod keeps no stamp and binds to another
    card. Raises on any failure."""
    import tempfile
    import threading

    from kubegpu_tpu_torch.cluster.kubeclient import KubeConfig
    from kubegpu_tpu_torch.cluster.mock_kube import serve_mock_kube
    from kubegpu_tpu_torch.cmd.common import build_backend
    from kubegpu_tpu_torch.core import codec, grammar
    from kubegpu_tpu_torch.node import fake
    from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser
    from kubegpu_tpu_torch.node.manager import (DevicesManager,
                                                GPUDeviceManager)
    from kubegpu_tpu_torch.runtime.hook import GPURuntimeHook
    from kubegpu_tpu_torch.runtime.launcher import WorkloadSupervisor
    from kubegpu_tpu_torch.scheduler.core import Scheduler
    from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kgtpu-smoke-kube-")
    server, url, api = serve_mock_kube(token=KUBE_TOKEN)
    kubeconfig = os.path.join(tmp, "kubeconfig")
    with open(kubeconfig, "w") as f:
        json.dump({"current-context": "smoke",
                   "contexts": [{"name": "smoke", "context": {
                       "cluster": "mock", "user": "smoke"}}],
                   "clusters": [{"name": "mock",
                                 "cluster": {"server": url}}],
                   "users": [{"name": "smoke",
                              "user": {"token": KUBE_TOKEN}}]}, f)
    config = KubeConfig.load(kubeconfig)
    counting = _counting_kube_client()
    client = counting(config)
    scheds: list = []
    sup = None
    pod_s = out = counted = None

    def scheduler():
        sched = Scheduler(counting(config), build_device_scheduler())
        sched.start()
        scheds.append(sched)
        return sched

    def stop(sched):
        sched.stop()
        sched.api.close()
        scheds.remove(sched)

    def bound(name):
        return (client.get_pod(name).get("spec") or {}).get("nodeName")

    def uuids(pod):
        return sorted(grammar.gpu_id_from_path(p) for p in _cards_of(pod))

    try:
        # the card's node and the fake hosts, each advertised by the port's
        # advertiser over the client
        t = time.perf_counter()
        gpus = {}
        hosts = [(NODE, build_backend(backend))] + [
            (f"kube-hgx{i}", fake.FakeGPUBackend(fake.hgx_h100_inventory(i)))
            for i in range(KUBE_HOSTS)]
        for name, be in hosts:
            client.create_node({"metadata": {"name": name}, "status": {
                "allocatable": {"cpu": "64", "pods": 110}}})
            gpus[name] = GPUDeviceManager(be)
            mgr = DevicesManager()
            mgr.add_device(gpus[name])
            mgr.start()
            DeviceAdvertiser(client, mgr, name).advertise_once()
        advertise_s = time.perf_counter() - t
        client.patch_node_metadata(NODE, {"labels": dict(KUBE_LABEL)})
        sched = scheduler()

        # the card's pod
        pod = _gpu_pod("kube-pod", 1)
        pod["spec"]["nodeSelector"] = dict(KUBE_LABEL)
        client.create_pod(pod)
        _wait_for(lambda: bound("kube-pod"), KUBE_WAIT_S, "the card's pod")
        placed = client.get_pod("kube-pod")
        card = uuids(placed)
        own = {g.uuid for g in gpus[NODE].backend.enumerate().gpus}
        if placed["spec"]["nodeName"] != NODE or len(card) != 1 or \
                card[0] not in own:
            raise AssertionError(f"the card's pod on "
                                 f"{placed['spec']['nodeName']} with {card}")
        cfg = GPURuntimeHook(client, gpus[NODE]).create_container(
            "kube-pod", "main", {"devices": [], "envs": []})
        env = {e["key"]: e["value"] for e in cfg["envs"]}
        if env.get("CUDA_VISIBLE_DEVICES") != card[0]:
            raise AssertionError(f"the hook's env {env} for card {card}")
        if train:
            import math

            sup = WorkloadSupervisor(api=client, log_dir=tmp)
            # the pod's command imports the port from this checkout
            cfg["envs"].append({"key": "PYTHONPATH", "value": os.path.dirname(
                os.path.abspath(__file__))})
            t = time.perf_counter()
            cont = sup.launch("kube-pod", "main", cfg, [
                sys.executable, "-c", POD_RUNNER, "--steps",
                str(DEVICE_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--vocab", str(TRAIN_MODEL["vocab"]),
                "--d-model", str(TRAIN_MODEL["d_model"]),
                "--d-ff", str(TRAIN_MODEL["d_ff"]),
                "--n-layers", str(TRAIN_MODEL["n_layers"]),
                "--n-heads", str(TRAIN_MODEL["n_heads"])])
            status = sup.wait(cont.cid, timeout=300)
            pod_s = time.perf_counter() - t
            logs = sup.logs(cont.cid)
            if status["exit_code"] != 0:
                raise AssertionError(f"the pod exited {status['exit_code']}"
                                     f": {logs[-3000:]}")
            out, counted = _pod_result(logs)
            want = TRAIN_MODEL["n_layers"] * DEVICE_STEPS
            if len(out["losses_full"]) != DEVICE_STEPS or not all(
                    map(math.isfinite, out["losses_full"])) or \
                    counted["launches"] != [want] * 3 or any(
                        by.get("sm90") != want
                        for by in counted["by_instance"]):
                raise AssertionError(f"the pod's run {out} {counted}")

        # the burst: every pod deleted as soon as it is seen bound
        names = [f"kb{i}" for i in range(KUBE_BURST)]
        created: dict = {}
        seen: dict = {}
        lock = threading.Lock()
        done = threading.Event()

        def on_bind(kind, event, obj):
            name = obj["metadata"]["name"]
            if kind != "pod" or event == "deleted" or \
                    name not in created or \
                    not (obj.get("spec") or {}).get("nodeName"):
                return
            with lock:
                if name in seen:
                    return
                seen[name] = time.perf_counter()
                if len(seen) == KUBE_BURST:
                    done.set()
            # the job completes: its cards go back to the burst
            threading.Thread(target=client.delete_pod, args=(name,),
                             daemon=True).start()

        watch = counting(config)
        watch.add_watcher(on_bind)
        try:
            requests0 = sched.api.requests
            t = time.perf_counter()
            for i, name in enumerate(names):
                created[name] = time.perf_counter()
                client.create_pod(_gpu_pod(name, KUBE_SIZES[i % 4]))
            if not done.wait(KUBE_WAIT_S * 2):
                raise AssertionError(f"{len(seen)} of {KUBE_BURST} burst "
                                     f"pods bound")
            burst_s = max(seen.values()) - t
            burst_requests = sched.api.requests - requests0
            lat = [(seen[n] - created[n]) * 1e3 for n in names]
        finally:
            watch.close()
        _wait_for(lambda: not [p for p in client.list_pods()
                               if p["metadata"]["name"] in created],
                  KUBE_WAIT_S, "the burst's pods deleted")
        _cards_held_once(client)

        # the restart leg: a fresh scheduler replays the watch
        host = "kube-hgx0"
        restart_label = {"kgtpu.io/smoke": "restart"}
        client.patch_node_metadata(host, {"labels": restart_label})
        for name in ("kube-ra", "kube-rb"):
            p = _gpu_pod(name, 4)
            p["spec"]["nodeSelector"] = dict(restart_label)
            if name == "kube-rb":
                t = time.perf_counter()
                stop(sched)
                sched = scheduler()
                restart_s = time.perf_counter() - t
            client.create_pod(p)
            _wait_for(lambda: bound(name), KUBE_WAIT_S,
                      f"{name} bound after the restart")
        restart_cards = uuids(client.get_pod("kube-ra")) + \
            uuids(client.get_pod("kube-rb"))
        if len(set(restart_cards)) != 8 or bound("kube-rb") != host:
            raise AssertionError(f"the restart leg's cards {restart_cards}")
        _cards_held_once(client)

        # the refused-bind leg: a card taken behind the scheduler's back
        host = "kube-hgx1"
        refuse_label = {"kgtpu.io/smoke": "refuse"}
        client.patch_node_metadata(host, {"labels": refuse_label})
        real = sched.api.bind_many
        taken: list = []

        def racing_bind_many(bindings, annotations):
            if not taken and "kube-refused" in bindings:
                stamp = json.loads(json.dumps(annotations["kube-refused"]))
                rival = _gpu_pod("kube-rival", 1)
                rival["metadata"]["annotations"] = stamp
                api.create_pod(rival)
                api.bind_many({"kube-rival": bindings["kube-refused"]},
                              {"kube-rival": stamp})
                taken.extend(uuids(api.get_pod("kube-rival")))
            return real(bindings, annotations)

        sched.api.bind_many = racing_bind_many
        # every state of the pod, in order: (node, its cards)
        states: list = []
        states_watch = counting(config)
        states_watch.add_watcher(lambda kind, event, obj: states.append(
            ((obj.get("spec") or {}).get("nodeName"), uuids(obj)))
            if kind == "pod" and obj["metadata"]["name"] == "kube-refused"
            else None)
        try:
            p = _gpu_pod("kube-refused", 1)
            p["spec"]["nodeSelector"] = dict(refuse_label)
            client.create_pod(p)
            _wait_for(lambda: bound("kube-refused"), KUBE_WAIT_S,
                      "the refused pod bound on a later cycle")
            _wait_for(lambda: states and states[-1][0], KUBE_WAIT_S,
                      "the refused pod's bind event")
        finally:
            states_watch.close()
        final = uuids(client.get_pod("kube-refused"))
        # the refused stamp (the rival's card, unbound), then its
        # withdrawal (unbound, no card) before any later stamp
        at = next((i for i, (node, c) in enumerate(states)
                   if node is None and c == taken), None)
        withdrawn = at is not None and len(states) > at + 1 and \
            states[at + 1] == (None, [])
        if not taken or not withdrawn or len(final) != 1 or \
                final == taken:
            raise AssertionError(f"the refused pod's states {states}, the "
                                 f"rival {taken}")
        _cards_held_once(client)
    finally:
        if sup is not None:
            sup.shutdown()
        for sched in list(scheds):
            stop(sched)
        client.close()
        server.shutdown()
    row = {"phase": "kube", "nvidia_smi": smi_line(),
           "note": "host times on the card's machine; the mock Kubernetes "
                   "API server, the scheduler, the advertisers, the hook "
                   "and the supervisor run in this process",
           "hosts": KUBE_HOSTS + 1, "advertise_s": advertise_s,
           "card": card[0], "pod_s": pod_s,
           "launches_fwd_dq_dkv": counted and counted["launches"],
           "launches_by_instance": counted and counted["by_instance"],
           "losses": out and out["losses_full"],
           "burst": {"pods": KUBE_BURST, "sizes": list(KUBE_SIZES),
                     "all_bound_s": burst_s,
                     "create_to_bound_p50_ms": _pctl(lat, 0.5),
                     "create_to_bound_p99_ms": _pctl(lat, 0.99),
                     "requests_per_bind": burst_requests / KUBE_BURST},
           "restart": {"restart_s": restart_s, "cards": len(restart_cards),
                       "held_once": True},
           "refused_bind": {"taken": taken, "withdrawn": withdrawn,
                            "states": len(states), "bound_card": final},
           "seconds": time.perf_counter() - t0, "ok": True}
    emit(row)
    return row


# the port's static rules: 17, the three twin rules among them
STATIC_RULES = 17
TWIN_RULES = ("twin-coverage", "mirror-maintenance", "reason-parity")


def _static_rules() -> dict:
    """``python -m kubegpu_tpu_torch.analysis --stats`` over the port's
    tree on this machine's Python: its findings (0 for a clean tree), the
    rules that ran and the analysis's own seconds (its ``--stats``)."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--stats",
         "kubegpu_tpu_torch"], cwd=root, capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t
    stats = re.search(r"analysis stats: (\d+) file\(s\), parse (\d+) ms, "
                      r"total (\d+) ms", proc.stderr)
    rules = re.findall(r"^  (\S+) +[\d.]+ ms$", proc.stderr, re.M)
    found = re.search(r"^(\d+) finding\(s\)", proc.stdout, re.M)
    findings = int(found.group(1)) if found else (
        0 if "clean: no findings" in proc.stdout else None)
    if proc.returncode != 0 or findings != 0 or stats is None:
        raise AssertionError(f"the static rules exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]} {proc.stderr[-2000:]}")
    if len(rules) != STATIC_RULES or not set(TWIN_RULES) <= set(rules):
        raise AssertionError(f"the static rules ran {len(rules)} rules "
                             f"({rules}), not {STATIC_RULES} with "
                             f"{TWIN_RULES}")
    return {"findings": findings, "rules": len(rules), "rule_names": rules,
            "twin_rules": list(TWIN_RULES), "files": int(stats.group(1)),
            "analysis_s": int(stats.group(3)) / 1e3, "process_s": wall}


def _mutation_sweep(tmp: str) -> dict:
    """``python -m kubegpu_tpu_torch.analysis --mutate --format json``, the
    full mutation sweep over the masked pass's twin closure, on this
    machine's Python: its mutants, kills, waivers, survivors and seconds
    (the sweep's own and the process's), printed as a line of its own.
    Raises on a non-zero exit or an unwaived survivor."""
    root = os.path.dirname(os.path.abspath(__file__))
    report_path = os.path.join(tmp, "mutation-sweep.json")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.analysis", "--mutate",
         "--format", "json", "--output", report_path], cwd=root,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    report = None
    if os.path.exists(report_path):
        with open(report_path) as f:
            report = json.load(f)
    if proc.returncode != 0 or report is None or report["survived"] or \
            report["skipped"]:
        raise AssertionError(f"the mutation sweep exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    kills: dict = {}
    for m in report["mutants"]:
        if m["status"] == "killed":
            kills[m["killed_by"]] = kills.get(m["killed_by"], 0) + 1
    row = {"phase": "checkers_mutation", "mutants": report["total"],
           "killed": report["killed"], "waived": report["waived"],
           "survivors": report["survived"], "kill_rate": report["kill_rate"],
           "modules": len(report["targets"]), "checks": report["checks"],
           "kills_by_check": kills, "sweep_s": report["elapsed_s"],
           "process_s": wall}
    emit(row)
    return row


def _counted_drain(cfg, params, prompts, fused) -> dict:
    """One greedy drain of ``prompts`` under the counter, in the section
    "fused" or "oracle": the streams, the server's decode steps (a chunk
    each when fused, a token step each on the oracle) and the section's
    counts."""
    import torch

    from kubegpu_tpu_torch.analysis import dispatchcount as dc
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    os.environ["KGTPU_FUSED_SERVE"] = "1" if fused else "0"
    try:
        srv = DecodeServer(cfg, params, slots=SERVE_SLOTS)
    finally:
        os.environ.pop("KGTPU_FUSED_SERVE", None)
    name = "fused" if fused else "oracle"
    steps = 0
    t0 = time.perf_counter()
    with dc.section(name):
        rids = [srv.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
        while srv.pending:
            srv.step()
            steps += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [srv.result(r) for r in rids]
    tokens = sum(map(len, outs))
    got = dc.section_counts(name)
    return {"outs": outs, "tokens": tokens, "steps": steps,
            "chunk": srv.chunk, "wall_s": wall, **got,
            "dispatches_per_token": got["dispatches"] / tokens,
            "syncs_per_token": got["syncs"] / tokens}


def checkers_phase(dev) -> dict:
    """The port's static rules over its own tree on this machine
    (`_static_rules`: 17 rules, the twin rules among them, 0 findings) and
    the full mutation sweep (`_mutation_sweep`: no unwaived survivor),
    then the dispatch/sync/build counter on the card. Serving: a float32
    greedy drain of the serve phase's traffic at full width, fused and
    through the per-token oracle, after a warm-up drain: equal streams,
    one sync a chunk plus one an admission on the fused path and its
    syncs per token within the reference's 1.5/chunk budget, at least one
    sync a decode step on the oracle (a step decodes every active slot at
    once, so per generated token that is 1/slots), and no kernel build
    after the warm-up. Training: one step at the training config, whose
    ``kgt.flash_fwd`` and ``kgt.flash_bwd`` dispatches (the backward's on
    the autograd engine's thread) equal the kernels' own launch counts,
    6 each."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.analysis import dispatchcount as dc
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)
    from kubegpu_tpu_torch.workload.train import (init_sharded,
                                                  make_train_step)

    t0 = time.perf_counter()
    rules = _static_rules()
    with tempfile.TemporaryDirectory(prefix="kgt-mutate-") as tmp:
        sweep = _mutation_sweep(tmp)
    cfg = dataclasses.replace(TransformerConfig(**MODEL), dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = _serve_prompts(cfg)
    _drain(cfg, params, prompts)                 # warm-up, not counted
    tcfg = TransformerConfig(**TRAIN_MODEL)
    dc.install()
    try:
        dc.reset()
        fused = _counted_drain(cfg, params, prompts, True)
        oracle = _counted_drain(cfg, params, prompts, False)
        serve_builds = dc.counts()["builds_total"]
        del params
        torch.cuda.empty_cache()
        tparams, opt_state, optimizer = init_sharded(
            torch.Generator(device=dev).manual_seed(11), tcfg)
        step = make_train_step(tcfg, optimizer=optimizer)
        batch = torch.from_numpy(bigram_tokens(
            tcfg.vocab, TRAIN_BATCH * (TRAIN_SEQ + 1), seed=13).astype(
                np.int64).reshape(TRAIN_BATCH, -1)).to(dev)
        _zero_launch_counts()
        with dc.section("train"):
            tparams, opt_state, loss = step(tparams, opt_state, batch)
            loss = float(loss)
        train_launches = list(_launch_counts())
        train_ops = dc.op_counts("train")
        train = dc.section_counts("train")
    finally:
        dc.uninstall()
    del tparams, opt_state, optimizer
    torch.cuda.empty_cache()
    budget = 1.5 / fused["chunk"]
    n = tcfg.n_layers
    row = {"phase": "checkers", "static_rules": rules,
           "mutation_sweep": {k: sweep[k] for k in (
               "mutants", "killed", "waived", "survivors", "sweep_s")},
           "slots": SERVE_SLOTS,
           "requests": SERVE_REQUESTS, "max_new": SERVE_MAX_NEW,
           "dtype": "float32", "tokens": fused["tokens"],
           "fused_equals_oracle": fused["outs"] == oracle["outs"]}
    for name, d in (("fused", fused), ("oracle", oracle)):
        row.update({f"{name}_{k}": d[k] for k in (
            "dispatches", "syncs", "builds", "steps", "wall_s",
            "dispatches_per_token", "syncs_per_token")})
    row.update({
        "fused_sync_budget_per_token": budget,
        "oracle_syncs_per_step": oracle["syncs"] / oracle["steps"],
        "serve_builds_after_warmup": serve_builds,
        "train_loss": loss, "train_dispatches": train["dispatches"],
        "train_syncs": train["syncs"],
        "train_kgt_flash_fwd": train_ops.get("kgt.flash_fwd", 0),
        "train_kgt_flash_bwd": train_ops.get("kgt.flash_bwd", 0),
        "launches_fwd_dq_dkv": train_launches,
        "seconds": time.perf_counter() - t0})
    row["ok"] = bool(
        row["fused_equals_oracle"]
        and all(len(o) == SERVE_MAX_NEW for o in fused["outs"])
        and fused["syncs_per_token"] <= budget
        and fused["syncs"] == fused["steps"] + SERVE_REQUESTS
        and row["oracle_syncs_per_step"] >= 1.0
        and serve_builds == 0 and train["builds"] == 0
        and train_launches == [n] * 3
        and row["train_kgt_flash_fwd"] == train_launches[0]
        and row["train_kgt_flash_bwd"] == train_launches[1]
        and np.isfinite(loss))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"checkers phase failed: {row}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubegpu_tpu_torch._device import resolve_device
    from kubegpu_tpu_torch.workload.kernels import _build
    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params)

    dev = resolve_device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for name in libs for ln in
             _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "ptxas": ptxas})

    k1 = kernel_phase(dev)
    k4 = decode_attn_phase(dev)
    cfg = TransformerConfig(**MODEL)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    fwd = forward_phase(dev, cfg, params)
    entry_phase()
    serve = serve_phase(dev, cfg, params)
    sampled = serve_sampled_phase(dev, cfg, params)
    spec = serve_spec_phase(dev, cfg, params)
    serve_prefix_phase(dev, cfg, params)
    del params                      # the training phases need the memory
    torch.cuda.empty_cache()

    kb = kernel_bwd_phase(dev)
    loader_phase(cfg)
    train = train_phase(dev)
    dots = train_remat_dots_phase(dev)
    lora, base = train_lora_phase(dev, train)
    ckpt = checkpoint_phase(dev, base)
    del base
    torch.cuda.empty_cache()
    moe = moe_phase(dev)
    ring_rows = ring_kernels_phase(dev)
    tp_rows = tp_heads_phase(dev)
    with world_of_one(dev) as tmp:
        mesh = train_mesh_phase(dev, train, tmp)
        serve_mesh = serve_mesh_phase(dev, serve, ckpt, tmp)
    device = device_side_phase()
    scheduler_phase()
    sched_bin = scheduler_binary_phase()
    cp = control_plane_phase()
    px = proxy_simulate_phase()
    explorer = explorer_phase()
    kube = kube_phase()
    checkers = checkers_phase(dev)
    # each path's own launches, counted from zero: K1's "launches" is the
    # forward path's (slice 1), K2's and K3's the training run's; the LoRA
    # and MoE steps' are their last step's; the ring's its kernel pass at
    # sp = 4 (and 2), the sharded step's its last step's
    # each kernel's instance is the main path's (bf16, head_dim 128: sm90);
    # "previous_ms" times their mma.sync instance at the same shape, K2's
    # with the `_delta` pre-pass it needs ("delta_ms" alone)
    run = train["run_launches"]
    lora_step = lora["launches_fwd_dq_dkv_per_step"][-1]
    moe_step = moe["launches_fwd_dq_dkv_per_step"][-1]
    # the ring's pass over every virtual rank (sp^2 launches of each), and
    # the last sharded step's
    ring_pass = ring_rows[4]["launches_fwd_dq_dkv_per_pass"]
    ring_pass_sp2 = ring_rows[2]["launches_fwd_dq_dkv_per_pass"]
    # the in-process tensor-parallel pass over 18 heads (tp launches of
    # each) at tp = 4 (and 2)
    tp_pass = tp_rows[4]["launches_fwd_dq_dkv_per_pass"]
    tp_pass_tp2 = tp_rows[2]["launches_fwd_dq_dkv_per_pass"]
    mesh_step = mesh["launches_fwd_dq_dkv_per_step"][-1]
    resume_step = serve_mesh["launches_fwd_dq_dkv_per_step"][-1]
    k1_run, k2_run, k3_run = train["run_by_instance"]
    src = "kubegpu_tpu_torch/csrc/"
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": src + "flash_fwd_sm90.cu", "instance": k1["instance"],
        "previous_source": src + "flash_fwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:126",
        "launches": fwd["kernel_launches"],
        "launches_by_instance": fwd["kernel_launches_by_instance"],
        "launches_train_run": run[0],
        "launches_train_run_by_instance": k1_run,
        "launches_remat_dots_step": dots["launches_fwd_dq_dkv"][0],
        "launches_lora_step": lora_step[0], "launches_moe_step": moe_step[0],
        "launches_moe_forward": moe["forward_launches_fwd_dq_dkv"][0],
        "launches_ring_pass": ring_pass[0],
        "launches_ring_pass_sp2": ring_pass_sp2[0],
        "launches_tp_heads_pass": tp_pass[0],
        "launches_tp_heads_pass_tp2": tp_pass_tp2[0],
        "launches_train_mesh_step": mesh_step[0],
        "launches_serve_mesh_step": resume_step[0],
        "launches_node_agent_run": device["launches_fwd_dq_dkv"][0],
        "launches_scheduler_binary_run":
            sched_bin["launches_fwd_dq_dkv"][0],
        "launches_lifecycle_run":
            sched_bin["lifecycle"]["launches_fwd_dq_dkv"][0],
        "launches_repair_run": sched_bin["repair"]["launches_fwd_dq_dkv"][0],
        "launches_control_plane_run": cp["launches_fwd_dq_dkv"][0],
        "launches_proxy_run": px["launches_fwd_dq_dkv"][0],
        "launches_explorer_run": explorer["launches_fwd_dq_dkv"][0],
        "launches_kube_run": kube["launches_fwd_dq_dkv"][0],
        "launches_checkers_step": checkers["launches_fwd_dq_dkv"][0],
        "dispatches_checkers_step": checkers["train_kgt_flash_fwd"],
        "max_abs_err": k1["max_abs_err_o"], "ms": k1["ms"],
        "op_ms": k1["op_ms"], "previous_ms": k1["previous_ms"],
        "serve_shape_previous_ms": k1["previous_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "train_shape_ms": kb["fwd_ms"],
        "train_shape_previous_ms": kb["fwd_previous_ms"],
        "train_shape_library_ms": kb["library_fwd_ms"],
        "train_shape_bound_ms": kb["fwd_bound_ms"]}, {
        "name": "flash_bwd_dq", "route": "cuda",
        "source": src + "flash_bwd_dq_sm90.cu",
        "instance": kb["dq_instance"],
        "previous_source": src + "flash_bwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:213",
        "launches": run[1], "launches_train_run": run[1],
        "launches_train_run_by_instance": k2_run,
        "launches_remat_dots_step": dots["launches_fwd_dq_dkv"][1],
        "launches_lora_step": lora_step[1], "launches_moe_step": moe_step[1],
        "launches_ring_pass": ring_pass[1],
        "launches_ring_pass_sp2": ring_pass_sp2[1],
        "launches_tp_heads_pass": tp_pass[1],
        "launches_tp_heads_pass_tp2": tp_pass_tp2[1],
        "launches_train_mesh_step": mesh_step[1],
        "launches_serve_mesh_step": resume_step[1],
        "launches_node_agent_run": device["launches_fwd_dq_dkv"][1],
        "launches_scheduler_binary_run":
            sched_bin["launches_fwd_dq_dkv"][1],
        "launches_lifecycle_run":
            sched_bin["lifecycle"]["launches_fwd_dq_dkv"][1],
        "launches_repair_run": sched_bin["repair"]["launches_fwd_dq_dkv"][1],
        "launches_control_plane_run": cp["launches_fwd_dq_dkv"][1],
        "launches_proxy_run": px["launches_fwd_dq_dkv"][1],
        "launches_explorer_run": explorer["launches_fwd_dq_dkv"][1],
        "launches_kube_run": kube["launches_fwd_dq_dkv"][1],
        "launches_checkers_step": checkers["launches_fwd_dq_dkv"][1],
        "dispatches_checkers_step": checkers["train_kgt_flash_bwd"],
        "max_abs_err": kb["max_abs_err_dq_dk_dv"][0],
        "delta_max_abs_err": kb["delta_max_abs_err"], "ms": kb["dq_ms"],
        "previous_ms": kb["dq_previous_ms"], "delta_ms": kb["delta_ms"],
        "plain_ms": kb["dq_plain_ms"], "bound_ms": kb["dq_bound_ms"],
        "bound_by": kb["dq_bound_by"],
        "library_ms": kb["library_bwd_ms"],
        "k2_k3_ms": kb["dq_ms"] + kb["dkv_ms"]}, {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": src + "flash_bwd_dkv_sm90.cu",
        "instance": kb["dkv_instance"],
        "previous_source": src + "flash_bwd.cu",
        "replaces": "kubegpu_tpu/workload/kernels/flash.py:244",
        "launches": run[2], "launches_train_run": run[2],
        "launches_train_run_by_instance": k3_run,
        "launches_remat_dots_step": dots["launches_fwd_dq_dkv"][2],
        "launches_lora_step": lora_step[2], "launches_moe_step": moe_step[2],
        "launches_ring_pass": ring_pass[2],
        "launches_ring_pass_sp2": ring_pass_sp2[2],
        "launches_tp_heads_pass": tp_pass[2],
        "launches_tp_heads_pass_tp2": tp_pass_tp2[2],
        "launches_train_mesh_step": mesh_step[2],
        "launches_serve_mesh_step": resume_step[2],
        "launches_node_agent_run": device["launches_fwd_dq_dkv"][2],
        "launches_scheduler_binary_run":
            sched_bin["launches_fwd_dq_dkv"][2],
        "launches_lifecycle_run":
            sched_bin["lifecycle"]["launches_fwd_dq_dkv"][2],
        "launches_repair_run": sched_bin["repair"]["launches_fwd_dq_dkv"][2],
        "launches_control_plane_run": cp["launches_fwd_dq_dkv"][2],
        "launches_proxy_run": px["launches_fwd_dq_dkv"][2],
        "launches_explorer_run": explorer["launches_fwd_dq_dkv"][2],
        "launches_kube_run": kube["launches_fwd_dq_dkv"][2],
        "launches_checkers_step": checkers["launches_fwd_dq_dkv"][2],
        "dispatches_checkers_step": checkers["train_kgt_flash_bwd"],
        "max_abs_err": max(kb["max_abs_err_dq_dk_dv"][1:]),
        "ms": kb["dkv_ms"], "previous_ms": kb["dkv_previous_ms"],
        "plain_ms": kb["dkv_plain_ms"],
        "bound_ms": kb["dkv_bound_ms"], "bound_by": kb["dkv_bound_by"],
        "library_ms": kb["library_bwd_ms"]}, {
        "name": "decode_attn", "route": "cuda",
        "source": src + "decode_attn_sm90.cu", "replaces": None,
        "launches_serve_run": serve["decode_attn_launches"],
        "launches_serve_sampled_run": sampled["decode_attn_launches"],
        "launches_serve_spec_bf16_run": spec["bf16_decode_attn_launches"],
        "launches_mesh_generate_bf16":
            serve_mesh["bf16_generate_decode_attn_launches"],
        # the launches of those paths checked against the plain version
        "checked_launches_max_rel_err": {
            "serve_sampled": sampled["decode_attn_checked"],
            "serve_spec_bf16": spec["bf16_decode_attn_checked"],
            "mesh_generate_bf16":
                serve_mesh["bf16_generate_decode_attn_checked"]},
        "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
        "max_rel_err": max(r["rel_err"] for r in k4.values()),
        "min_fp8_control_rel_err": min(r["fp8_control_rel_err"]
                                       for r in k4.values()),
        **{key: k4["reasoning_full"][key] for key in (
            "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")},
        "by_case": {name: {key: r[key] for key in (
            "ms", "bound_ms", "plain_ms", "library_ms", "split_len",
            "rel_err", "fp8_control_rel_err")}
            for name, r in k4.items()}}]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
