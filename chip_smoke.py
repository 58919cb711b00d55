#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels from
   the sources in this checkout (one nvcc per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (full llama3.2-1b, 32 KB chunks: p (150860, 8192) f32,
   g (4, 150860, 8192) for 4 workers; (150857, 8192) for 1), bitwise, and
   times kernel, plain version, HBM bound and the torch.optim step closest
   to the same update (a yardstick the port never calls):
   - Nesterov (agg_opt_chunks W=1, multi_agg_opt_chunks W=4) against
     torch.optim.SGD(nesterov, fused);
   - sgd_opt_chunks and adam_opt_chunks, W=4 and W=1, against
     torch.optim.SGD(fused) and torch.optim.Adam(fused).  Adam updates its
     slots in place, so its inputs are drawn span by span from seeds and
     drawn again for the comparison, which runs span by span.
   Small bf16, W=3 and ragged cases are held bitwise too.  The stacked
   rules (multi_agg_opt_chunks, and sgd/adam_opt_chunks at W=4) run again
   with the mean's divisor read from the card (set to W: the same bits).
   health_chunks (the sanity gate's sum of squares per chunk) at the
   gated W=4 step's domain (4 x 150860 chunks of 8192) with a NaN, an Inf,
   an overflowing (1e20) and an all-zero chunk in it, and at W=1 (150857
   chunks), against its plain version (the kernel's order, step by step),
   beside torch.linalg.vector_norm per chunk (it takes the root too: a
   yardstick); a small bf16 case.
   The int8 wire's kernels at the int8 W=4 main path's shapes (the whole
   stacked domain, 150860 chunks of 8192): quantize_chunks and
   dequantize_chunks (payload and scales equal), and dequant_agg_opt_chunks
   reading the owners' rows on the block diagonal of the (4, n) buffer,
   each against its plain version span by span, timed beside its bound
   and a PyTorch yardstick (torch.quantize_per_channel, QTensor.dequantize,
   the fused nesterov SGD step on a decoded g: none the same function).
   The update kernels as the windowed exchange launches them: one
   (window, shard) strip of the stacked gradient read in place (rows
   `padded` apart), p' into a given buffer and the slots in place, for
   multi_agg_opt_chunks and adam_opt_chunks at W=4 in 5 windows (a (4,
   61,792,256) view) and agg_opt_chunks at W=1 in 7 windows, bitwise
   against their plain versions on the same view, timed beside the
   strip's bound; and dequant_agg_opt_chunks as the int8 wire's windows
   launch it: one launch over window 2 of 5's strip of all four shards (p
   and m rows 308,961,280 apart, the owners' rows read on the block
   diagonal of the (4, n) buffer, rows n + L apart), p' into a given
   buffer and m in place, with inv_n 1/4 and with the sanity gate's
   device divisor set to 3 (a division), each bitwise against its plain
   version and timed beside the strip's bound.
3. Holds one 4-worker step of a reduced llama3.2-1b on the card against
   the same step on the CPU (plain versions), from the same weights, under
   Nesterov and under Adam (eps 1e-3, where the step is Lipschitz in the
   gradient: |dp| <= lr * |dg| / eps), and under Nesterov over the int8
   and the bf16 wires, within a bound built from the grid steps the
   script measures (a card-vs-CPU difference of an ulp can move an encoded
   entry by one step).  The sanity-gated step with worker 1 NaN-poisoned,
   under Nesterov, SGD and Adam, at f32 activations (so the two devices'
   gradients differ by summation order only): ok_mask [1, 0, 1, 1] and
   n_live 3 exact, grad_norms within rtol 1e-5, parameters within the
   rule's bound above (SGD's first step moves less than Nesterov's: the
   Nesterov bound); on the card the gated step equals the static k-of-n
   step with worker 1 dead, bitwise.  A reduced rwkv6-3b step (f32
   activations, T 128: the chunked scan under autograd, two chunks) card
   vs CPU under Nesterov and Adam within the same bounds, launching
   rwkv_scan_kernel no time.
4. Rollback, on a reduced llama3.2-1b (a full-model snapshot is 9.9 GB of
   disk I/O, not device work): 4 workers, a snapshot every step, keep_k 2,
   every worker NaN-pushing for divergence_patience steps and the newest
   snapshot truncated: the supervisor skips the corrupt snapshot by name,
   restores the last verified one (parameters and every slot bitwise
   equal to load_checkpoint's) and finishes.
5. Main paths: PHubEngine + fit, sharded_ps, full-width full-depth
   llama3.2-1b, global batch 8 x 512 tokens:
   - Nesterov at the TrainConfig defaults, 4 stacked workers, 3 steps
     (multi_agg_opt_chunks), and 1 worker, 1 step (agg_opt_chunks);
   - Adam at lr 3e-4, 4 workers, 3 steps, and 1 worker, 1 step
     (adam_opt_chunks);
   - SGD at lr 1e-2, 4 workers, 1 step, and 1 worker, 1 step
     (sgd_opt_chunks);
   - over the int8 wire: Nesterov, 4 workers, 3 steps (each step 4
     quantize_chunks, 3 dequantize_chunks, 1 dequant_agg_opt_chunks) and
     1 worker, 1 step (1, 1 and agg_opt_chunks); SGD and Adam, 4 workers,
     1 step each (4 quantize, 4 dequantize and the rule's kernel);
   - the self-healing path: fit(supervisor=TrainSupervisor), Nesterov, 4
     workers, 4 steps, a FaultSchedule NaN-poisoning worker 1 at steps 1
     and 2, demote_after 2: ok_mask [1,1,1,1], [1,0,1,1], [1,0,1,1], a
     demotion at step 2, step 3 on the static 3-of-4 program (each step
     one health_chunks and one multi_agg_opt_chunks launch).
   - PHub's gradient processing pipeline, from the same seed and batches:
     Nesterov W=4 in 5 windows with flat parameter residency, 3 steps;
     Nesterov W=4 in 5 windows with chunk-ready dispatch, 3 steps; Adam
     W=4 in 5 windows, flat, 1 step; Nesterov W=1 in 7 windows, flat, 1
     step.  Each launches its rule's kernel once per (window, shard) a
     step (20 and 7), asserts that the requested window count takes
     effect, and equals its monolithic path bitwise: every step's loss,
     and after every step each leaf's f64 sum, the int64 sum of its bit
     patterns and every 1009th element (1.22M); its step ms, tokens/s
     and peak GiB are logged beside the monolithic path's.
   - the int8 wire in every mode (llama3.2-1b, W=4): in 5 windows (3
     steps; each step 16 quantize_chunks, 11 dequantize_chunks, 5
     dequant_agg_opt_chunks) and in 5 windows chunk-ready and
     flat-resident (2 steps), each equal to the one-window int8 path
     bitwise; a static 3-of-4 membership, worker 1 dead (1 step, the tail
     kernel with inv_n 1/3); the supervised path with worker 1
     NaN-poisoned and demoted as above (4 steps; the tail kernel reads
     the gate's live count from the card).
   - rwkv6-3b training (full width and depth, 32 layers, 3,073,313,280
     f32 parameters in the tree; batch 8 x 512; chunked scan under
     autograd), flat-resident: Nesterov W=1 (1 step, agg_opt_chunks 1),
     W=2 in one window (2 steps, multi_agg_opt_chunks 1 a step), W=2 in
     3 windows (2 steps, 6 a step) and chunk-ready in 3 windows (1 step),
     both bitwise equal to one window; Adam W=1 at 24 of the 32 layers (1
     step: at full depth Adam's slots, the gradient row and one worker's
     gradients are 7 parameter copies, 80.1 GiB); rwkv_scan_kernel 0 on
     every path.
   Each checks finite losses, changed parameters, and that every kernel
   launched as often as the path's expected counts say, every other count
   staying 0.
6. The serving path's attention kernels at its shapes, against their plain
   versions within a stated tolerance (the kernels sum in another order):
   swa_attention_kernel (the prefill's flash attention, 3xTF32 on the
   tensor cores) at llama3.2-1b's (B 8, T 2048, 32/8 heads, hd 64, causal)
   and h2o-danube-3-4b's (B 2, T 4608, hd 120, window 4096), f32 as the
   path computes them, within 2e-5 * max(1, max|want|);
   decode_attention_kernel (flash-decoding in one launch) against llama's
   ring cache (B 8, C 2080, bf16) and danube's rotated one (B 2, C 4096,
   window 4096), f32 queries, within 3e-5, and a second call bitwise equal
   to the first.  Each is timed beside its plain version, its bound and
   F.scaled_dot_product_attention (enable_gqa, causal or a boolean mask; a
   yardstick the port never calls): the prefill with CUDA events (median
   of 10), its bound 3x the allowed pairs' flops at 495 TFLOP/s TF32 (the
   f32 SIMT bound, at 67 TFLOP/s, beside it), with its resident blocks a
   SM; decode as CUDA graphs of 20 calls (median of 10 replays: an eager
   call's Python outlasts the kernel), its bound the cache's bytes at
   3.35 TB/s, with its splits, blocks and the wrapper's host time a call.
   Small edge cases: ragged T, windows 1, 40, 64, 70 and 100 (q tiles that
   straddle the diagonal and the window's edge), hd 32, 64, 120 and 128,
   bf16; decode at B 1, C below one split, C 4096 with window 300 (most
   splits empty), empty leading slots and splits, each call twice
   (bitwise) and on the cache rolled by 37 slots (within 1e-5).
7. Reduced llama3.2-1b (prompt 40) and reduced h2o-danube-3-4b (window 64,
   prompt 96 > 64: the ring's roll branch, evicting decode steps): prefill
   and 4 teacher-forced decode steps on the card (kernels) and on the CPU
   (plain versions) from one parameter tree, logits within SERVE_TOL.
8. Serving main paths through launch/serve.generate (PHubEngine's prefill
   and serve steps, StackedComm(1)), weights from seed 0, prompts from
   SyntheticTokens(seed=7): full llama3.2-1b, batch 8, prompt 2048, 32
   greedy decode tokens (C = 2080: 16 swa_attention_kernel launches in the
   prefill, 16 decode_attention_kernel launches in each of the 31 decode
   steps); full h2o-danube-3-4b, batch 2, prompt 4608 (> window 4096: C =
   4096, the roll branch), 16 decode tokens evicting the oldest slots (24 +
   24 a step).  Each checks finite logits, the exact launch counts (every
   other kernel 0) and that a second greedy run gives the same tokens and
   logits; prints prefill ms and tok/s, decode ms a step and tok/s, peak
   GiB.
9. The attention-free (ssm) path's kernel and model: rwkv_scan_kernel
   (B8) against its plain version at rwkv6-3b's serving shape (B 8, T
   2048, 40 heads of 64, f32, from a zero and from a nonzero state) within
   RWKV_TOL * max(1, max|want|), timed (CUDA events, median of 10) beside
   its plain version and its bound (the strict-triangle flops at 67
   TFLOP/s f32 or its bytes at 3.35 TB/s, the larger; no PyTorch call
   computes the scan, so library_ms is null); edge cases T 1, 40, 100 and
   257 (ragged chunks), bf16 inputs, and a uniform decay of 0.3 (finite)
   and 0.1 (the cumulative decay underflows: inf and NaN in the same
   places as the plain version), T 64, 128 and 2048 at B 1 and H 1 (f32
   and bf16) and a mixed decay (0.1 on channels 0-31); two calls at the
   serving shape bitwise equal; its GB/s and share of the bound, ptxas
   registers and spills, grid and blocks an SM.  Reduced rwkv6-3b,
   prompts 40 (one ragged chunk) and 128 (two chunks): prefill and 4
   teacher-forced decode steps card vs CPU, logits within SERVE_TOL, the
   state cache's dtypes (S and x_prev_ffn f32, x_prev_att bf16) on both.
10. Full rwkv6-3b (32 layers, d_model 2560, 3,073,313,280 f32 parameters
   in the tree) through launch/serve.generate, batch 8, prompt 2048, 32
   greedy tokens: exactly 32 rwkv_scan_kernel launches in the run and
   every other kernel 0, a prefill alone launching 32 and a decode step
   alone none; finite logits, a second greedy run equal in tokens and
   logits; prefill and decode times, peak GiB.
11. PHub across processes (``launch/dist.py``, one worker a process over
   ``core/comm.py::ProcessGroupComm``), after the llama3.2-1b paths, each
   bitwise against the stacked step of this call (losses, and the
   parameters' fingerprints after every step):
   (a) NCCL at world = the card count (1 on a one-card machine), full
   llama3.2-1b, Nesterov, 1 step, beside a stacked step of that world:
   one agg_opt_chunks launch a rank (multi_agg_opt_chunks at world > 1);
   (b) gloo, 2 processes sharing cuda:0 (collectives staged through
   pinned host buffers), full llama3.2-1b in 64 KB chunks, after the
   stacked W=2 runs of the same chunk size (Nesterov 2 steps, Adam 1,
   int8 2): Nesterov 2 steps, Nesterov in 5 windows flat-resident 2 (5
   windows take effect at S=2: 37,715 chunks a shard), Adam 1, int8 in 5
   windows 2, each rank's launches equal to ``GLOO_PATHS``' prediction;
   (c) gloo, 4 processes on cuda:0, reduced llama3.2-1b and rwkv6-3b, 2
   steps each of Nesterov, SGD and Adam, identity and int8, 1 and 2
   windows, against ``StackedComm(4)``'s (losses, every parameter, every
   rank's slots).  In (b) and (c) the exchange alone runs on identical
   pushed rows too ((W, 2^24) f32, every rule, wire and 1 or 2 windows),
   p', the slots and wire_ef bitwise equal to the stacked Comm's.  Step
   ms, tokens/s, the exchange's wall ms and the collectives' part of it
   (staging copies included), and each rank's peak GiB are logged beside
   the stacked step's.  Every collective runs under DIST_TIMEOUT; a rank
   that fails brings its group down and the script with it.
12. PHub's rack deployment and its baselines (``TrainConfig.strategy``
   hierarchical, allreduce, centralized_ps; ``wire_format_dcn``), Nesterov
   unless named:
   (d) stacked, full llama3.2-1b, 4 workers (``STRATEGY_PATHS``):
   allreduce and centralized_ps, 2 steps each, bitwise equal to the
   sharded_ps W=4 path (losses and parameters after every step);
   hierarchical as 2 pods x 2, 2 steps, held against the sharded_ps step
   (the sum is grouped differently: after one step its sampled parameters
   within 1e-4 of the step's largest change, step 1's loss within 1e-4
   relative); its 3-window flat and chunk-ready modes bitwise equal to it;
   the int8 DCN tier, 2 steps, and in 3 windows bitwise equal to it; the
   int8 ring inside the pods (1 step); a static 3-of-4 membership (1); the
   supervised gated step with worker 1 poisoned (2); Adam (1).  Each
   path's launches exact (multi_agg_opt_chunks once a step, 6 in 3
   windows; the DCN tier one quantize_chunks and one dequantize_chunks a
   window).
   (e) gloo, 2 processes on cuda:0 laid out 2 pods x 1, full llama3.2-1b
   in 64 KB chunks: allreduce and centralized_ps (2 steps each) bitwise
   equal to the stacked W=2 sharded_ps path, hierarchical (2) and its int8
   DCN tier with 5 windows asked for (3 take effect: 75,429 chunks a
   shard; 2 steps) bitwise equal to the stacked 2 x 1 paths; each rank's
   launches exact (centralized_ps: rank 0, the PS, alone updates); the
   collectives' calls, bytes and ms by operation (the cross-pod leg's
   bytes among them), step ms and peak GiB a rank.
   (f) gloo, 4 processes on cuda:0 as 2 pods x 2, reduced llama3.2-1b and
   rwkv6-3b: hierarchical over the identity wire, the int8 DCN tier and
   the int8 ring in the pods, and centralized_ps, 2 steps each, bitwise
   equal to ``StackedComm(4, 2)``'s (losses, parameters, every slot row a
   rank keeps); allreduce, whose ``all_reduce`` adds 4 ranks in gloo's
   order, one step: step 0's loss equal, the parameters within 1e-4 of
   the step's largest change.
13. PHub's framework-agnostic client (``core/client.py::PHubClient``), the
   engine's exchange without the engine: an external loop treats the full
   llama3.2-1b ``DecoderLM`` as an ordinary ``nn.Module`` (its own forward
   and ``chunked_cross_entropy`` per worker slice, ``torch.autograd.grad``,
   the push built by the caller) and calls only the client
   (``client_phase``, ``CLIENT_PATHS``), Nesterov unless named:
   (g) stacked, 4 workers, batch 8 x 512: ``push_pull`` in tree mode (the
   caller's (4, *leaf) push tree; the parameters written in place) 2
   steps, ``push_pull_flat`` (each worker's gradients flattened into the
   caller's own (4, padded) rows; the parameters views of the flat
   store) 2, the int8 wire in 5 windows 2, hierarchical 2 pods x 2 1, and
   a static 3-of-4 membership (``set_membership``, hierarchical 2 x 2) 1,
   each bitwise equal to the engine's run of this call from the same seed
   and batches (losses and the fingerprint after every step), launches
   exact; W=1 ``push_pull`` under Nesterov, SGD and Adam (eps 1e-3), 1
   step each, against the tree-level ``make_optimizer`` update on the
   same gradients: Nesterov and SGD every leaf bitwise (and equal to the
   engine's W=1 step), Adam within 1e-6; the external MLP loop of
   ``examples/torch_external_loop.py`` (4 stacked workers, Adam, 200
   steps): its last mse at most 1/4 of its first, every mse finite.
   (h) gloo, 2 processes sharing cuda:0, full llama3.2-1b in 64 KB chunks:
   each rank pushes its own slice's gradients through
   ``PHubClient(tc, ProcessGroupComm)``, 2 steps (a fresh rank's first
   step is cold), bitwise equal to the stacked client at W=2 after each
   (and to the engine's stacked W=2 steps).  Step ms,
   tokens/s and peak GiB of every path beside the engine's.
14. PHub's multi-tenant rack (``core/api.py::PHubConnectionManager``,
   ``co_phase``, ``CO_PATHS``): tenant A is the full llama3.2-1b at the
   TrainConfig defaults (Nesterov, lr 1e-2, momentum 0.9, seed 0: the main
   paths' weights and data), tenant B llama3.2-1b at full width and 4
   layers (lr 1e-2 / 3, momentum 0.8, seed 1), batch 8 x 512 each, both
   attached to one packed rack chunk domain and stepped by ``co_step``,
   2 steps unless named:
   (i) stacked W=4 in one window and in 5, hierarchical 2 pods x 2, W=4
   with worker 3 left (``leave(3)``), B under SGD (W=4), B under Adam
   (W=2), W=1 (1 step): each tenant equal to its solo run of this call
   bitwise (losses and the fingerprint after every step; A's solo runs
   are the main paths' where they exist), each rule's kernel launched
   once on each (window strip, tenant run) that meet (``tenant_launches``
   predicts the counts from the layout); the int8 wire in 5 windows
   bitwise equal to itself in one (16 quantize_chunks, 11
   dequantize_chunks and one dequant_agg_opt_chunks a (window row,
   tenant run) a step), and each tenant after one step within
   CO_INT8_BOUND of its solo int8 run (the packed layout moves a tenant's
   chunks to other owner shards, whose ring starts at another worker); the
   lifecycle (A 2 solo steps, attached with its momentum, 2 co-steps,
   detached, 2 solo steps) bitwise equal to 6 solo steps;
   ``launch/train.py --tenants 2 --workers 2 --steps 2`` on the full model
   (4 multi_agg_opt_chunks launches a step); gloo, 2 processes on cuda:0,
   reduced tenants, bitwise equal to ``StackedComm(2)``'s co-step.  Step
   ms, aggregate tokens/s and peak GiB beside the solo steps', the packed
   layout and ``accounting()`` (model bytes, domain share, push and pull
   bytes a step).  Then each kernel of the co-step on a tenant run of the
   packed domain (``co_kernel_phase``), bitwise against its plain version
   and timed beside the run's bytes bound.
15. PHub's elastic rack resize (``PHubConnectionManager.resize``,
   ``resize_phase``), full llama3.2-1b services of 4 stacked workers moved
   to 3 workers and back through the user's entry point, the state moving
   on the card: (a) Nesterov over the int8 wire in 5 windows (3 take
   effect at 3 workers), 2 steps, 4 -> 3 -> 4: m and wire_ef bitwise on
   their live regions after each move, and the round trip plus 2 steps
   bitwise equal to 4 steps that never resized (losses, the parameters'
   fingerprint, every slot's full buffer, pad included); (b) Adam over the
   identity wire, 1 step, 4 -> 3 -> 4: all four slots bitwise on their
   live regions; (c) phase 14's pair, one solo step each, attached with
   its momentum, 4 -> 3 -> 4, detached: each tenant's slot bitwise on its
   live region, ``last_rebalance``'s ``moved_bytes`` equal to the count
   from the two packed layouts; (d) a snapshot written at 4 workers
   (Nesterov, full width at 1 layer) restored at 3 and at 2: the slot
   bitwise on its live region, the parameters' fingerprint equal.  After
   each, a step at 3 workers (batch 6 x 512: 8 does not split over 3) and
   one back at 4, launches exact and losses finite.  Each resize's ms (host clock ending
   in a synchronization), the bytes it must move and their rate against
   the HBM bound, ``moved_bytes`` and ``moved_fraction``, and the GiB
   allocated before, at the peak and after.
16. PHub's characterization (``characterization_phase``), full
   llama3.2-1b: (a) the ZeroComputeEngine
   (``PHubEngine.make_zero_compute_step``, the exchange alone) at 4
   stacked workers (1 warm + 10 timed steps), at 1 worker (1 + 5) and at 4
   over the int8 wire in 5 windows (1 + 5): after every step the
   parameters and every slot bitwise equal to ``exchange_stage`` run by
   hand on rows filled with p * 1e-4, launches exact; ms a step, the push
   and pull bytes a second, and for the identity paths the step's bytes
   bound at 3.35 TB/s beside the rule's kernel alone; (b) the calibration
   probes (``tuning/calibrate.py``) on ``StackedComm(4)`` at
   ``CARD_PROBE_ELEMS`` a row, solved from the card's base topology: the
   constants, residuals and tolerance beside the card's name and power
   limit, the record saved to a temporary directory; (c)
   ``launch/train.py --telemetry --calibrate --workers 4`` (3 steps: the
   attribution table and the agreement band; "OUTSIDE TOLERANCE" is a
   finding, not a failure), its artifacts read back by ``launch/trace.py``
   (the records must validate), then ``--telemetry --supervise`` over the
   calibration the first run saved (the supervisor's spans, B5); (d) the
   same 2 steps at W=4 over the identity wire and over int8 in 5 windows
   with telemetry off, on, on, off: the first off and on runs' losses,
   fingerprints and every slot bitwise equal, every run's losses and
   launches equal, the step-time overhead as the median on-step over the
   median off-step (a finding); (e) ``launch/serve.py`` (llama3.2-1b, B 8,
   prompt 2048, 32 tokens) with telemetry off and on: greedy tokens equal,
   launches exact, the span totals and the decode-dispatch histogram.
17. The other model families (``families_phase``): (a) B9 and B10 at
   each new (nh/kv, hd), within their tolerances, timed beside their bound
   and SDPA: hymba-1.5b 25/5 hd 64 (window 1024 and its global layers'
   0, B 8, prompt 2048, 32 tokens), musicgen-medium 24/24 hd 64 and
   internvl2-2b 16/8 hd 128 (B 8, a prefix of 256 and a prompt of 512, 8
   tokens), grok-1-314b 48/8 and arctic-480b 56/8 hd 128 (B 8, prompt
   2048, 16 tokens); (b) agg_opt_chunks over grok-1-314b's one-layer W=1
   row (6.5G bf16 elements), bitwise on a strip at its start and one at
   its far end; (c) reduced card-vs-CPU checks of the five at f32
   activations (the experts at capacity factor 0.5, so every layer drops;
   hymba at 4 layers, windows [0, 64, 64, 0], and with 10/2 heads): one
   2-worker Nesterov step and a prefill plus 4 decode steps, within the
   earlier phases' bounds, each run twice on the card and bitwise equal;
   (d) full-width training through ``fit``: hymba-1.5b full size at 4
   stacked workers (Nesterov 2 steps, Adam 1), grok-1-314b at 1 layer
   W=1 flat (2 steps), arctic-480b at 1 layer with its experts cut to 32,
   W=2 flat (2), internvl2-2b and musicgen-medium at 4 layers W=4 with a
   seed-drawn prefix (1 each), batch 8 x 512, launches exact; (e) serving
   through ``launch.serve.generate``, each twice (greedy, the same bits):
   hymba-1.5b (B 8, prompt 2048, 32 tokens), grok-1-314b and
   arctic-480b with all 128 experts at 1 layer (B 8, prompt 2048, 16),
   the frontends at 4 layers after their prefix (B 8, prompt 512, 8).  A
   bf16 model's norm scales, still all ones, may keep every bit (their
   updates fall under half an ulp); every other leaf must change.
   Where a hymba step and a grok step spend their time is
   ``scripts/torch_step_profile.py``'s work, not this script's.
18. Weight decay, gradient accumulation and the fsdp_stream strategy:
   (a) agg_opt_chunks, multi_agg_opt_chunks, adam_opt_chunks and
   dequant_agg_opt_chunks with decay 1e-4 and 0.1 bitwise against their
   plain versions (f32 and bf16, a ragged length, NaN and Inf in p and g,
   g a strip of a wider buffer, the windowed form, B7 on a window strip of
   every shard with inv_n and the divisor 3), B1 and B2 with decay 0.1 at
   the main paths' shapes bitwise too, and each of the four timed with and
   without decay in this call (off, on, on, off); (b) full llama3.2-1b, 4
   stacked workers, batch 8 x 512, through ``fit``: Nesterov with decay
   (3 steps), Adam with decay (2), Nesterov with decay over int8 in 5
   windows (2), ``microbatch=2`` (2) and fsdp_stream Nesterov (3, one
   agg_opt_chunks a leaf), each run again for one step and bitwise equal,
   launches exact; fsdp_stream held within 3e-4 (loss) and 2e-4 (sampled
   parameters) of the sharded_ps W=4 path of this call, beside its step
   ms and peak; (c) rwkv6-3b at 4 workers under fsdp_stream (2 steps: its
   sharded_ps gradient rows do not fit the card); (d) reduced card-vs-CPU
   steps with decay (Nesterov, Adam), ``microbatch=2`` and fsdp_stream
   with decay (Nesterov, Adam) within phase 3's bounds, two card runs
   bitwise.
19. PHub's exchange autotuner (``tune_phase``), full llama3.2-1b at 4
   stacked workers, every output in a temporary directory: (a) this
   card's topology calibrated (``launch/tune.py``'s
   ``calibrate_topology``: the probes at ``CARD_PROBE_ELEMS`` a row); (b)
   the 111 candidates of the space ranked on it (the host time printed);
   (c) ``autotune`` times the top 3 and the incumbent (sharded_ps, 1
   window, identity, 32 KB, 1x4) at 2 warm-up and 5 timed steps, plus
   two pinned candidates whatever the ranking, int8 on one pod in 4
   windows at 64 KB (3 effective) and hierarchical 2x2 in 1 window at
   32 KB on the identity wire (so B6a/B6b/B7 and B2's pod stride run
   here), and lint-gates
   the winner; every timed candidate is linted (R1/R3/R5): predicted and
   measured us, peak GiB and the verdict of each; (d) a second request
   hits the cache (nothing timed, linted or launched); (e)
   ``launch/train.py --auto-tune`` on that cache trains 2 steps, its
   losses, parameters and launches bitwise equal to the winner's flags
   given directly.
20. Prints the kernels line, then the device line last.

Any failed check raises and the script exits non-zero.  It needs one CUDA
card and refuses to run without one.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
CARD_SOURCE = "src/repro_torch/kernels/agg_opt/csrc/agg_opt.cu"
QUANT_SOURCE = "src/repro_torch/kernels/quant/csrc/quant.cu"
SWA_SOURCE = "src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu"
DECODE_SOURCE = "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu"
RWKV_SOURCE = "src/repro_torch/kernels/rwkv_scan/csrc/rwkv_scan.cu"
REPLACES = {"agg_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:38",
            "multi_agg_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:187",
            "sgd_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:60",
            "adam_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:100",
            "quantize_chunks": "src/repro/kernels/quant/kernel.py:34",
            "dequantize_chunks": "src/repro/kernels/quant/kernel.py:55",
            "dequant_agg_opt_chunks":
                "src/repro/kernels/agg_opt/kernel.py:139",
            "health_chunks": "src/repro/kernels/agg_opt/kernel.py:173",
            "swa_attention_kernel": "src/repro/kernels/swa_attn/kernel.py:73",
            "decode_attention_kernel":
                "src/repro/kernels/decode_attn/kernel.py:60",
            "rwkv_scan_kernel": "src/repro/kernels/rwkv_scan/kernel.py:70"}

ARCH, WORKERS, BATCH, SEQ, STEPS = "llama3.2-1b", 4, 8, 512, 3
# the int8 wire at one window, W=4: 4 quantizes (3 ring hops, the pull), 3
# dequantizes (2 hops, the pull), the tail kernel once
INT8_W4 = {"quantize_chunks": WORKERS, "dequantize_chunks": WORKERS - 1,
           "dequant_agg_opt_chunks": 1}
# the gradient processing pipeline's paths: window counts that take effect
# on llama3.2-1b's domain (37,715 chunks a shard at S=4, 150,857 at S=1)
WINDOWS_W4, WINDOWS_W1 = 5, 7
SAMPLE_STRIDE = 1009             # every 1009th parameter: 1.22M of them
ADAM_LR, SGD_LR = 3e-4, 1e-2
ADAM_REF_EPS = 1e-3              # card-vs-CPU Adam step (docstring, 3.)
SPAN = 1 << 26                   # elements per span of the Adam/SGD checks
NORM_RTOL = 1e-5                 # card vs CPU grad_norms (f32 sums' order)
POISONED = 1                     # the worker the gated phases poison
# the models' RMS-norm scales (initialised to ones)
NORM_SCALES = ("ln1", "ln2", "ln_x", "ln_attn", "ln_ssm", "final_norm")
# serving: (arch, batch, prompt, decode tokens); the kernels' tolerances
SERVE_PATHS = (("llama3.2-1b", 8, 2048, 32), ("h2o-danube-3-4b", 2, 4608, 16))
SWA_RTOL = 2e-5                  # f32: within 2e-5 * max(1, max|want|)
DECODE_TOL = 3e-5                # f32 queries
BF16_TOL = 3e-2
SERVE_TOL = 5e-3                 # reduced serving, card vs CPU (item 7)
# the attention-free path (item 10): (arch, batch, prompt, decode tokens)
SSM_SERVE_PATH = ("rwkv6-3b", 8, 2048, 32)
RWKV_TOL, RWKV_BF16_TOL = 1e-5, 1e-2     # * max(1, max|want|)
# rwkv6-3b training (the memory plan is in PERF.md): 375,161 chunks of 8192
# at W=1 (one effective window for any count), 187,581 = 3 * 31 * 2,017 a
# shard at W=2 (3 windows), all flat-resident.  Adam at W=1 holds p, m, v,
# k1, k2, the gradient row and one worker's gradients (or p'): 7 x 11.45
# GiB = 80.1 GiB of the card's 79.1, so it runs at 24 of the 32 layers
# (full width).  (label, workers, steps, rule, pipeline fields, launches
# per step, layers (0: all))
SSM_ARCH, SSM_REF_SEQ, SSM_WINDOWS, SSM_ADAM_LAYERS = "rwkv6-3b", 128, 3, 24
SSM_TRAIN_PATHS = (
    ("W=1 flat", 1, 1, "nesterov", dict(flat_residency=True),
     {"agg_opt_chunks": 1}, 0),
    ("W=2 flat", 2, 2, "nesterov", dict(flat_residency=True),
     {"multi_agg_opt_chunks": 1}, 0),
    (f"W=1 flat, {SSM_ADAM_LAYERS} layers", 1, 1, "adam",
     dict(flat_residency=True), {"adam_opt_chunks": 1}, SSM_ADAM_LAYERS),
)
# (label, workers, steps, rule, pipeline fields, launches per step, the
# monolithic path, arch): equal to it bitwise
SSM_PIPELINE_PATHS = (
    (f"windows {SSM_WINDOWS} flat W=2", 2, 2, "nesterov",
     dict(pipeline_windows=SSM_WINDOWS, flat_residency=True),
     {"multi_agg_opt_chunks": SSM_WINDOWS * 2},
     f"{SSM_ARCH} nesterov W=2 flat", SSM_ARCH),
    (f"windows {SSM_WINDOWS} chunk-ready flat W=2", 2, 1, "nesterov",
     dict(pipeline_windows=SSM_WINDOWS, flat_residency=True,
          overlap_backward=True),
     {"multi_agg_opt_chunks": SSM_WINDOWS * 2},
     f"{SSM_ARCH} nesterov W=2 flat", SSM_ARCH),
)
# PHub across processes (one worker a process, launch/dist.py), each path
# bitwise against the stacked step of the same call: (a) NCCL at world =
# the card count; (b) GLOO_W gloo ranks sharing cuda:0 at full width, in
# 64 KB chunks (37,715 a shard at S=2 = 5 * 19 * 397: 5 windows take
# effect); (c) REDUCED_W gloo ranks on cuda:0, reduced configs in 24 KB
# chunks (2 windows take effect on both).  Every collective runs under
# DIST_TIMEOUT, and a failed rank brings its group down.
DIST_TIMEOUT = 600.0
GLOO_W, DIST_CHUNK = 2, 64 * 1024
REDUCED_W, REDUCED_CHUNK, REDUCED_SEQ, REDUCED_STEPS = 4, 24 * 1024, 64, 2
ROWS_N = 1 << 24                 # the exchange alone: (W, 2^24) f32 rows
_CHUNK = {"chunk_size_bytes": DIST_CHUNK}
# the stacked GLOO_W paths (label, steps, rule, wire, TrainConfig fields,
# launches per step); int8 at one window, S=2: one quantize on the ring
# and one for the pull, one dequantize (the pull), the tail kernel once
GLOO_BASES = (
    ("nesterov", 2, "nesterov", "identity", _CHUNK,
     {"multi_agg_opt_chunks": 1}),
    ("adam", 1, "adam", "identity", _CHUNK, {"adam_opt_chunks": 1}),
    ("int8", 2, "nesterov", "int8", _CHUNK,
     {"quantize_chunks": 2, "dequantize_chunks": 1,
      "dequant_agg_opt_chunks": 1}),
)
# the gloo paths, each rank's launches per step (PERF.md's prediction) and
# the stacked path they equal; int8 in 5 windows: each window's ring
# encodes once and its tail runs once, then the pull encodes and decodes
GLOO_PATHS = (
    ("nesterov", 2, "nesterov", "identity", _CHUNK,
     {"multi_agg_opt_chunks": 1}, "nesterov"),
    ("nesterov in 5 windows, flat", 2, "nesterov", "identity",
     dict(_CHUNK, pipeline_windows=5, flat_residency=True),
     {"multi_agg_opt_chunks": 5}, "nesterov"),
    ("adam", 1, "adam", "identity", _CHUNK, {"adam_opt_chunks": 1}, "adam"),
    ("int8 in 5 windows", 2, "nesterov", "int8",
     dict(_CHUNK, pipeline_windows=5),
     {"quantize_chunks": 6, "dequantize_chunks": 1,
      "dequant_agg_opt_chunks": 5}, "int8"),
)

# PHub's rack deployment and its baselines (phases (d)-(f)).  (d) stacked,
# full llama3.2-1b, 4 workers, Nesterov: hierarchical as PODS pods x 2 (D
# = 2 shards: 75,429 chunks a shard = 3^2 * 17^2 * 29, so 3 windows take
# effect).  (label, steps, rule, wire, TrainConfig fields, launches per
# step, the path of ``runs`` it equals bitwise (or None), a static dead
# worker, a FaultSchedule's poisoned worker)
PODS, HIER_WINDOWS = 2, 3
B2, B6A, B6B = ("multi_agg_opt_chunks", "quantize_chunks",
                "dequantize_chunks")
HIER = dict(strategy="hierarchical")
DCN = dict(HIER, wire_format_dcn="int8")
HIER_BOUND = 1e-4       # hierarchical vs sharded_ps after one step: of the
#                         step's largest change (docstring, 12.)
STRATEGY_PATHS = (
    ("allreduce W=4", 2, "nesterov", "identity", dict(strategy="allreduce"),
     {B2: 1}, "nesterov W=4", None, None),
    ("centralized_ps W=4", 2, "nesterov", "identity",
     dict(strategy="centralized_ps"), {B2: 1}, "nesterov W=4", None, None),
    ("hierarchical 2x2", 2, "nesterov", "identity", HIER, {B2: 1}, None,
     None, None),
    (f"hierarchical 2x2 in {HIER_WINDOWS} windows, flat", 2, "nesterov",
     "identity", dict(HIER, pipeline_windows=HIER_WINDOWS,
                      flat_residency=True),
     {B2: HIER_WINDOWS * 2}, "nesterov hierarchical 2x2", None, None),
    (f"hierarchical 2x2 in {HIER_WINDOWS} windows, chunk-ready", 2,
     "nesterov", "identity", dict(HIER, pipeline_windows=HIER_WINDOWS,
                                  overlap_backward=True),
     {B2: HIER_WINDOWS * 2}, "nesterov hierarchical 2x2", None, None),
    ("hierarchical 2x2, int8 DCN", 2, "nesterov", "identity", DCN,
     {B6A: 1, B6B: 1, B2: 1}, None, None, None),
    (f"hierarchical 2x2, int8 DCN in {HIER_WINDOWS} windows", 2,
     "nesterov", "identity", dict(DCN, pipeline_windows=HIER_WINDOWS),
     {B6A: HIER_WINDOWS, B6B: HIER_WINDOWS, B2: HIER_WINDOWS * 2},
     "nesterov hierarchical 2x2, int8 DCN", None, None),
    ("hierarchical 2x2, int8 in the pods", 1, "nesterov", "int8", HIER,
     {B6A: 2, B6B: 2, B2: 1}, None, None, None),
    ("hierarchical 2x2, worker 1 dead", 1, "nesterov", "identity", HIER,
     {B2: 1}, None, POISONED, None),
    ("hierarchical 2x2 supervised", 2, "nesterov", "identity", HIER,
     {"health_chunks": 1, B2: 1}, None, None, POISONED),
    ("hierarchical 2x2", 1, "adam", "identity", HIER,
     {"adam_opt_chunks": 1}, None, None, None),
)
# (e) gloo, GLOO_W ranks sharing cuda:0 laid out as 2 pods x 1, full
# llama3.2-1b in 64 KB chunks: hierarchical has D = 1 shard of 75,429
# chunks, so 5 windows asked for take effect as 3.  The stacked paths
# first: (label, steps, rule, wire, fields, launches per step); then the
# ranks' paths: (..., launches per step a rank (centralized_ps: the PS,
# rank 0, alone), the window count that takes effect, the stacked path
# they equal bitwise)
DCN_ASKED, DCN_EFFECTIVE = 5, 3
GLOO_STRATEGY_BASES = (
    ("hierarchical 2x1", 2, "nesterov", "identity", dict(_CHUNK, **HIER),
     {B2: 1}),
    ("hierarchical 2x1, int8 DCN", 2, "nesterov", "identity",
     dict(_CHUNK, **DCN), {B6A: 1, B6B: 1, B2: 1}),
)
GLOO_STRATEGY_PATHS = (
    ("allreduce", 2, "nesterov", "identity",
     dict(_CHUNK, strategy="allreduce"), {B2: 1}, None, "nesterov"),
    ("centralized_ps", 2, "nesterov", "identity",
     dict(_CHUNK, strategy="centralized_ps"),
     {"rank0": {B2: 1}, "others": {}}, None, "nesterov"),
    ("hierarchical 2x1", 2, "nesterov", "identity", dict(_CHUNK, **HIER),
     {B2: 1}, None, "hierarchical 2x1"),
    (f"hierarchical 2x1, int8 DCN, {DCN_ASKED} windows asked", 2,
     "nesterov", "identity",
     dict(_CHUNK, pipeline_windows=DCN_ASKED, **DCN),
     {B6A: DCN_EFFECTIVE, B6B: DCN_EFFECTIVE, B2: DCN_EFFECTIVE},
     DCN_EFFECTIVE, "hierarchical 2x1, int8 DCN"),
)
# (f) gloo, REDUCED_W ranks on cuda:0 as 2 pods x 2, reduced configs:
# (label, TrainConfig fields); allreduce at 4 ranks sums in gloo's order,
# so it runs one step, held within ALLREDUCE_BOUND of the step's largest
# change (docstring, 12.)
REDUCED_STRATEGIES = (
    ("hierarchical", HIER), ("hierarchical, int8 DCN", DCN),
    ("hierarchical, int8 in the pods", dict(HIER, wire_format="int8")),
    ("centralized_ps", dict(strategy="centralized_ps")),
    ("allreduce", dict(strategy="allreduce")),
)
ALLREDUCE_BOUND = 1e-4

# 13. the client (``client_phase``): full llama3.2-1b as a user's
# nn.Module through PHubClient.  (g) stacked, 4 workers: (label, steps,
# TrainConfig fields, pods, flat mode, a static dead worker, launches per
# step, the engine's run of this call it equals bitwise); W=1 against
# make_optimizer: (rule, launches, the engine's W=1 run it equals, or None:
# Adam runs at eps CLIENT_ADAM_EPS, the engine's W=1 Adam at 1e-8); (h)
# gloo, GLOO_W ranks on the card, 64 KB chunks, against the stacked client
# at GLOO_W; the external MLP loop (examples/torch_external_loop.py: 5,256
# f32 parameters in 4 KB chunks, 2 windows asked for)
INT8_W4_WINDOWS = {"quantize_chunks": 3 * WINDOWS_W4 + 1,
                   "dequantize_chunks": 2 * WINDOWS_W4 + 1,
                   "dequant_agg_opt_chunks": WINDOWS_W4}
CLIENT_PATHS = (
    ("tree W=4", 2, {}, 1, False, None, {B2: 1}, "nesterov W=4"),
    ("flat W=4", 2, {}, 1, True, None, {B2: 1}, "nesterov W=4"),
    (f"int8 in {WINDOWS_W4} windows W=4", 2,
     dict(wire_format="int8", pipeline_windows=WINDOWS_W4), 1, False, None,
     INT8_W4_WINDOWS, "nesterov int8 W=4"),
    ("hierarchical 2x2", 1, HIER, PODS, False, None, {B2: 1},
     "nesterov hierarchical 2x2"),
    ("hierarchical 2x2, worker 1 dead", 1, HIER, PODS, False, POISONED,
     {B2: 1}, "nesterov hierarchical 2x2, worker 1 dead"),
)
CLIENT_W1 = (("nesterov", {"agg_opt_chunks": 1}, "nesterov W=1"),
             ("sgd", {"sgd_opt_chunks": 1}, "sgd W=1"),
             ("adam", {"adam_opt_chunks": 1}, None))
CLIENT_ADAM_EPS = 1e-3
CLIENT_ADAM_ATOL = 1e-6   # textbook vs residual-form EMAs (ROADMAP queue C)
MLP_PARAMS, MLP_CHUNK = 32 * 128 + 128 + 128 * 8 + 8, 4096
CLIENT_GLOO_STEPS = 2     # the first step of a fresh rank is cold


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int, n: int = 20) -> float:
    """Median device time of one ``fn`` call for calls shorter than their
    Python: ``n`` calls captured in a CUDA graph, the graph replayed
    ``reps`` times between CUDA events (events around one eager call time
    the host's enqueue instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def host_us(torch, fn, n: int = 100) -> float:
    """Host time of one ``fn`` call (enqueue only), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def max_ulp(torch, a, b) -> int:
    """Largest distance in units in the last place between two float
    tensors of one dtype (f32 or bf16), in slices to bound memory."""
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    a, b = a.reshape(-1), b.reshape(-1)
    worst, step = 0, 1 << 26
    for i in range(0, a.numel(), step):
        ia = a[i:i + step].view(ity).to(torch.int64)
        ib = b[i:i + step].view(ity).to(torch.int64)
        sign = torch.iinfo(ity).min
        oa = torch.where(ia < 0, sign - ia, ia)
        ob = torch.where(ib < 0, sign - ib, ib)
        worst = max(worst, int((oa - ob).abs().max()))
    return worst


def compare(torch, got, want) -> tuple[float, int]:
    """(max |got - want|, max ulp) over pairs of tensors."""
    err, ulp = 0.0, 0
    for g, w in zip(got, want):
        err = max(err, float((g.float() - w.float()).abs().max()))
        if not torch.equal(g, w):
            ulp = max(ulp, max_ulp(torch, g, w))
    return err, ulp


def bound(n: int, n_bytes_per: int, n_ops_per: int,
          extra_bytes: int = 0) -> tuple[float, str]:
    """(least ms, what bounds it) for n elements (and ``extra_bytes``
    beside them, such as one scale a chunk)."""
    t_bytes = (n * n_bytes_per + extra_bytes) / HBM_BYTES_PER_S
    t_ops = n * n_ops_per / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(torch, sizes: dict, lr: float, mu: float) -> dict:
    """Kernels vs plain versions at the main path's shapes ({kernel name:
    padded domain length}); timings."""
    from repro_torch.kernels.agg_opt import (agg_opt_ref, fused_agg_opt,
                                             fused_multi_agg_opt,
                                             multi_agg_opt_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_elems = max(sizes.values())
    p = torch.empty(n_elems, device=dev).normal_(0, 0.02, generator=gen)
    m = torch.empty(n_elems, device=dev).normal_(0, 1e-3, generator=gen)
    g = torch.empty(WORKERS, n_elems, device=dev).normal_(0, 1e-3,
                                                          generator=gen)
    n1, nw = sizes["agg_opt_chunks"], sizes["multi_agg_opt_chunks"]
    check(nw == n_elems, "the stacked domain is the largest")
    cases = {
        "agg_opt_chunks": (fused_agg_opt, agg_opt_ref, p[:n1], g[0, :n1],
                           m[:n1], 1),
        "multi_agg_opt_chunks": (fused_multi_agg_opt, multi_agg_opt_ref, p,
                                 g, m, WORKERS),
    }
    out = {}
    for name, (kern, plain, pp, gg, mm, W) in cases.items():
        got = kern(pp, gg, mm, lr=lr, momentum=mu)
        want = plain(pp, gg, mm, lr=lr, momentum=mu)
        torch.cuda.synchronize()
        err, ulp = compare(torch, got, want)
        del got, want
        log(f"{name}: p/m {(pp.numel() // 8192, 8192)} g "
            f"{(*gg.shape[:-1], pp.numel() // 8192, 8192)} f32: "
            f"max_abs {err:.3e} max_ulp {ulp}")
        check(ulp == 0, f"{name} differs from its plain version "
                        f"(max_ulp {ulp}); the kernel claims bitwise")
        divisor_ms = None
        if W > 1:
            # the mean's divisor read from the card, set to W: same bits
            d = torch.tensor([float(W)], device=dev)
            got = kern(pp, gg, mm, lr=lr, momentum=mu)
            got_d = kern(pp, gg, mm, lr=lr, momentum=mu, divisor=d)
            check(all(torch.equal(a, b) for a, b in zip(got, got_d)),
                  f"{name} with the device divisor {W} differs from /W")
            del got, got_d
            divisor_ms = median_ms(torch, lambda: kern(
                pp, gg, mm, lr=lr, momentum=mu, divisor=d), reps=10)
        kernel_ms = median_ms(torch, lambda: kern(pp, gg, mm, lr=lr,
                                                  momentum=mu), reps=10)
        plain_ms = median_ms(torch, lambda: plain(pp, gg, mm, lr=lr,
                                                  momentum=mu), reps=3)
        lp = torch.nn.Parameter(pp.clone())
        sgd = torch.optim.SGD([lp], lr=lr, momentum=mu, nesterov=True,
                              fused=True)

        def library_step():
            lp.grad = gg.mean(0) if W > 1 else gg
            sgd.step()
        library_ms = median_ms(torch, library_step, reps=5)
        del lp, sgd
        gc.collect()
        torch.cuda.empty_cache()
        n_bytes = (W + 4) * pp.element_size()
        bound_ms, bound_by = bound(pp.numel(), n_bytes, W - 1 + 7)
        log(f"{name}: kernel {kernel_ms:.3f} ms"
            + (f" ({divisor_ms:.3f} ms with the device divisor)"
               if divisor_ms else "")
            + f", bound {bound_ms:.3f} ms "
            f"({bound_by}, {n_bytes * pp.numel() / 1e9:.2f} GB), plain "
            f"{plain_ms:.3f} ms, "
            f"library {library_ms:.3f} ms (SGD nesterov fused"
            f"{' after g.mean(0)' if W > 1 else ''})")
        out[name] = {"name": name, "route": "cuda", "source": CARD_SOURCE,
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        if divisor_ms:
            out[name]["divisor_ms"] = divisor_ms
    del p, m, g, pp, gg, mm, cases
    gc.collect()
    torch.cuda.empty_cache()

    # small bitwise cases: bf16, W=3 (division, not 1/W), a ragged tail
    n = 8192 * 37 + 100
    for dtype, W in ((torch.bfloat16, 1), (torch.bfloat16, 4),
                     (torch.float32, 3)):
        p = torch.randn(n, device=dev, generator=gen).to(dtype)
        m = torch.randn(n, device=dev, generator=gen).to(dtype)
        g = torch.randn(W, n, device=dev, generator=gen).to(dtype)
        if W == 1:
            got = fused_agg_opt(p, g[0], m, lr=lr, momentum=mu)
            want = agg_opt_ref(p, g[0], m, lr=lr, momentum=mu)
        else:
            got = fused_multi_agg_opt(p, g, m, lr=lr, momentum=mu)
            want = multi_agg_opt_ref(p, g, m, lr=lr, momentum=mu)
        err, ulp = compare(torch, got, want)
        log(f"small case {dtype} W={W} n={n}: max_abs {err:.3e} "
            f"max_ulp {ulp}")
        check(ulp == 0, f"small case {dtype} W={W} not bitwise")
    return out


def window_kernel_phase(torch, sizes: dict, lr: float, mu: float,
                        ce: int) -> dict:
    """The update kernels as the windowed exchange launches them on the
    new main paths: one (window, shard) strip, ``[j*L + w*Lw, j*L +
    (w+1)*Lw)``, with the stacked gradient read in place (a (4, Lw) view
    whose rows lie ``padded`` apart) and p' into a given buffer, the slots
    updated in place: multi_agg_opt_chunks and adam_opt_chunks at W=4 in 5
    windows, agg_opt_chunks at W=1 in 7 (a contiguous strip).  Each is
    held bitwise against its plain version on the same strided view, and
    timed (CUDA events, median of 10) beside its bound for the strip.
    Returns {kernel: {"window": {...}}} for the kernels line."""
    from repro_torch.kernels.agg_opt import (adam_opt_ref, agg_opt_ref,
                                             fused_adam_opt, fused_agg_opt,
                                             fused_multi_agg_opt,
                                             multi_agg_opt_ref)
    n4 = sizes[WORKERS]
    g = torch.empty(WORKERS, n4, device="cuda")
    for w in range(WORKERS):
        g[w].copy_(draw(torch, "g", n4, 77 + w))
    out = {}
    for name, W, windows in (("multi_agg_opt_chunks", WORKERS, WINDOWS_W4),
                             ("adam_opt_chunks", WORKERS, WINDOWS_W4),
                             ("agg_opt_chunks", 1, WINDOWS_W1)):
        n = sizes[W]
        L = n // W                       # shard_len (S = W)
        Lw = L // windows
        w, j = windows // 2, W // 2      # a middle window and shard
        lo = j * L + w * Lw
        gw = g[:, lo:lo + Lw] if W > 1 else g[0, lo:lo + Lw]
        p = draw(torch, "p", Lw, 91)
        kinds = ("m", "v", "k1", "k2") if name == "adam_opt_chunks" else ("m",)
        slots = [draw(torch, k, Lw, 92 + i) for i, k in enumerate(kinds)]
        p_out = torch.empty_like(p)
        if name == "adam_opt_chunks":
            kw = dict(lr=ADAM_LR, b1=0.9, b2=0.999, eps=1e-8)
            want = adam_opt_ref(p, gw, *slots, **kw)

            def run():
                return fused_adam_opt(p, gw, *slots, p_out=p_out, **kw)
            n_bytes, n_ops = 4 * (W + 10), W + 22
        else:
            kw = dict(lr=lr, momentum=mu)
            plain = multi_agg_opt_ref if W > 1 else agg_opt_ref
            kern = fused_multi_agg_opt if W > 1 else fused_agg_opt
            want = plain(p, gw, slots[0], **kw)

            def run():
                return kern(p, gw, slots[0], p_out=p_out, **kw)
            n_bytes, n_ops = 4 * (W + 4), W - 1 + 7
        got = run()
        torch.cuda.synchronize()
        check(got[0] is p_out and all(a is b for a, b in zip(got[1:],
                                                              slots)),
              f"{name}: p' not in p_out, or the slots not updated in place")
        err, ulp = compare(torch, got, want)
        del got, want
        check(ulp == 0, f"{name} on a strided window differs from its plain "
                        f"version (max_ulp {ulp})")
        ms = median_ms(torch, run, reps=10)
        bound_ms, bound_by = bound(Lw, n_bytes, n_ops)
        log(f"{name} windowed: W={W}, window {w} of {windows}, shard {j}: "
            f"p ({Lw // 8192}, 8192) f32, g {tuple(gw.shape)} with row "
            f"stride {gw.stride(0) if W > 1 else Lw}: max_abs {err:.3e} "
            f"max_ulp {ulp}; kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}); {windows * W} such launches a step")
        out[name] = {"window": {
            "windows": windows, "workers": W, "elements": Lw,
            "g_row_stride": gw.stride(0) if W > 1 else Lw,
            "max_abs_err": err, "max_ulp": ulp, "ms": ms,
            "bound_ms": bound_ms, "bound_by": bound_by}}
        del p, p_out, slots, gw
    out["dequant_agg_opt_chunks"] = dequant_window_phase(torch, g, lr, mu,
                                                         ce)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dequant_window_phase(torch, g, lr: float, mu: float, ce: int) -> dict:
    """dequant_agg_opt_chunks (B7) as the int8 wire's windowed exchange
    launches it at W=4 in 5 windows: one launch over window w's strip of
    all four shards, p and m (4, Lw) views whose rows lie L apart, the
    owners' rows the block diagonal of the stacked buffer ``g`` read in
    place (rows padded + L apart), q and the scales the window's packed
    ring payload, p' into a given buffer and m in place; with the static
    ``inv_n = 1/4`` and with the sanity gate's device divisor set to 3 (a
    division).  Each bitwise against its plain version, timed (CUDA
    events, median of 10) beside the strip's bound: p, m and g_own read
    (4 bytes each), q read (1), p and m written, one f32 scale a chunk."""
    from repro_torch.core.pipeline import own_strips
    from repro_torch.kernels.agg_opt import (dequant_agg_opt_ref,
                                             fused_dequant_agg_opt)
    from repro_torch.kernels.quant import quantize_int8
    S, n = g.shape
    windows, w = WINDOWS_W4, WINDOWS_W4 // 2
    L = n // S
    Lw = L // windows
    p, m = draw(torch, "p", n, 95), draw(torch, "m", n, 96)
    strip = lambda v: v.view(S, L)[:, w * Lw:(w + 1) * Lw]
    own = own_strips(g, windows, w)
    q, sc = quantize_int8(draw(torch, "g", S * Lw, 97), chunk_elems=ce)
    p_out = torch.empty_like(p)
    entry = {}
    for label, inv_n, divisor in (
            ("window", 1.0 / S, None),
            ("divisor", 1.0 / S, torch.tensor([3.0], device="cuda"))):
        kw = dict(lr=lr, momentum=mu, inv_n=inv_n, chunk_elems=ce,
                  divisor=divisor)
        want = dequant_agg_opt_ref(strip(p), q, sc, own, strip(m), **kw)
        m_in = m.clone()
        po, mi = strip(p_out), strip(m_in)
        got = fused_dequant_agg_opt(strip(p), q, sc, own, mi, p_out=po,
                                    **kw)
        torch.cuda.synchronize()
        check(got[0] is po and got[1] is mi,
              "B7's p' not in p_out, or m not updated in place")
        err, ulp = compare(torch, [po, mi], want)
        del want, got
        check(ulp == 0, f"dequant_agg_opt_chunks on a window ({label}) "
                        f"differs from its plain version (max_ulp {ulp})")
        ms = median_ms(torch, lambda: fused_dequant_agg_opt(
            strip(p), q, sc, own, mi, p_out=po, **kw), reps=10)
        bound_ms, bound_by = bound(S * Lw, 21, 9, 4 * (S * Lw // ce))
        log(f"dequant_agg_opt_chunks windowed ({label}: "
            + (f"divisor {float(divisor)}" if divisor is not None
               else f"inv_n 1/{S}")
            + f"): window {w} of {windows}, p/m {tuple(strip(p).shape)} rows "
            f"{L} apart, g_own rows {own.stride(0)} apart, q "
            f"({S * Lw // ce}, {ce}) int8: max_abs {err:.3e} max_ulp {ulp}; "
            f"kernel {ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
            f"{windows} such launches a step")
        entry[label] = {"windows": windows, "workers": S, "elements": S * Lw,
                        "pm_row_stride": L, "own_row_stride": own.stride(0),
                        "max_abs_err": err, "max_ulp": ulp, "ms": ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        del m_in, po, mi
    del p, m, q, sc, p_out, own
    return entry


def draw(torch, kind: str, n: int, seed: int):
    """``n`` f32 values of one kernel-phase input, from their own seed, so
    a span drawn into a full vector can be drawn again to compare it.
    Gradients have exact zeros (every 17th entry) and k1/k2 dead runs
    (every 11th), so Adam's alive gate and its k1' == 0 mask both fire."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.empty(n, device="cuda")
    if kind == "p":
        x.normal_(0, 0.02, generator=gen)
    elif kind in ("g", "m"):
        x.normal_(0, 1e-3, generator=gen)
    elif kind == "v":
        x.uniform_(0, 1e-6, generator=gen)
    else:                                       # k1, k2
        x.uniform_(0, 1, generator=gen)
    if kind in ("g", "k1", "k2"):
        x[::17 if kind == "g" else 11] = 0
    return x


KINDS = ("p", "g", "m", "v", "k1", "k2")


def span_seed(kind: str, w: int, i: int) -> int:
    return 1_000_000 + 1000 * i + 10 * KINDS.index(kind) + w


def spans(n: int):
    return [(i, lo, min(lo + SPAN, n)) for i, lo in enumerate(range(0, n,
                                                                    SPAN))]


def fill(torch, t, kind: str, w: int = 0) -> None:
    for i, lo, hi in spans(t.numel()):
        t[lo:hi].copy_(draw(torch, kind, hi - lo, span_seed(kind, w, i)))


def rule_kernel_phase(torch, sizes: dict) -> dict:
    """sgd_opt_chunks and adam_opt_chunks against their plain versions at
    the main paths' shapes (W=4 over ``sizes[4]`` elements, W=1 over
    ``sizes[1]``), span by span; timings.  Returns the kernels-line
    entries, with the W=4 numbers at the top level and the W=1 ones under
    "w1"."""
    from repro_torch.kernels.agg_opt import (adam_opt_ref, fused_adam_opt,
                                             fused_sgd_opt, sgd_opt_ref)
    n4 = sizes[WORKERS]
    check(sizes[1] <= n4, "the stacked domain is the largest")
    adam_kw = dict(lr=ADAM_LR, b1=0.9, b2=0.999, eps=1e-8)
    p = torch.empty(n4, device="cuda")
    g = torch.empty(WORKERS, n4, device="cuda")
    slots = [torch.empty(n4, device="cuda") for _ in range(4)]
    fill(torch, p, "p")
    for w in range(WORKERS):
        fill(torch, g[w], "g", w)

    def fill_slots():
        for t, kind in zip(slots, KINDS[2:]):
            fill(torch, t, kind)

    def drawn(i, lo, hi, W):
        """The inputs of span i, drawn again: p, g ((W, len) or (len,)),
        m, v, k1, k2."""
        gs = torch.stack([draw(torch, "g", hi - lo, span_seed("g", w, i))
                          for w in range(W)])
        return (draw(torch, "p", hi - lo, span_seed("p", 0, i)),
                gs if W > 1 else gs[0],
                *(draw(torch, k, hi - lo, span_seed(k, 0, i))
                  for k in KINDS[2:]))

    def held(name, W, n, run, plain, n_bytes, n_ops, state, timed=True):
        """Run the kernel once over n elements, hold every output against
        ``plain`` on the span's inputs drawn again, then time both (the
        plain version span by span over the current ``state``)."""
        got = run()
        torch.cuda.synchronize()
        err, ulp = 0.0, 0
        for i, lo, hi in spans(n):
            e, u = compare(torch, [t[lo:hi] for t in got],
                           plain(*drawn(i, lo, hi, W)))
            err, ulp = max(err, e), max(ulp, u)
        del got
        log(f"{name} W={W}: p ({n // 8192}, 8192) f32, g "
            f"{(W, n // 8192, 8192) if W > 1 else (n // 8192, 8192)}"
            f"{'' if timed else ', divisor read from the card'}: "
            f"max_abs {err:.3e} max_ulp {ulp}")
        check(ulp == 0, f"{name} W={W} differs from its plain version "
                        f"(max_ulp {ulp}); the kernel claims bitwise")
        kernel_ms = median_ms(torch, run, reps=10)
        if not timed:
            return {"divisor_ms": kernel_ms}

        def plain_spans():
            for _, lo, hi in spans(n):
                plain(*(t[..., lo:hi] for t in state))
        plain_ms = median_ms(torch, plain_spans, reps=3, warmup=1)
        bound_ms, bound_by = bound(n, n_bytes, n_ops)
        return {"max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    out = {name: {"name": name, "route": "cuda", "source": CARD_SOURCE,
                  "replaces": REPLACES[name], "launches": 0}
           for name in ("adam_opt_chunks", "sgd_opt_chunks")}
    for W in (WORKERS, 1):
        n = sizes[W]
        pp, gg = p[:n], (g[:, :n] if W > 1 else g[0, :n])
        check(gg.is_contiguous(), "the gradients are whole rows")
        ss = [t[:n] for t in slots]
        fill_slots()          # Adam updates them in place: draw them afresh
        nums = {
            "adam_opt_chunks": held(
                "adam_opt_chunks", W, n,
                lambda: (fused_adam_opt(pp, gg, *ss, **adam_kw)[0], *ss),
                lambda *a: adam_opt_ref(*a, **adam_kw),
                4 * (W + 10), W + 22, (pp, gg, *ss)),
            "sgd_opt_chunks": held(
                "sgd_opt_chunks", W, n,
                lambda: (fused_sgd_opt(pp, gg, lr=SGD_LR),),
                lambda p_, g_, *_: (sgd_opt_ref(p_, g_, lr=SGD_LR),),
                4 * (W + 2), W + 2, (pp, gg))}
        if W > 1:
            # the mean's divisor read from the card, set to W: the plain
            # version divides by W too, so the bits are the /W path's
            d = torch.tensor([float(W)], device="cuda")
            fill_slots()
            nums["adam_opt_chunks"].update(held(
                "adam_opt_chunks", W, n,
                lambda: (fused_adam_opt(pp, gg, *ss, divisor=d,
                                        **adam_kw)[0], *ss),
                lambda *a: adam_opt_ref(*a, **adam_kw),
                0, 0, (), timed=False))
            nums["sgd_opt_chunks"].update(held(
                "sgd_opt_chunks", W, n,
                lambda: (fused_sgd_opt(pp, gg, lr=SGD_LR, divisor=d),),
                lambda p_, g_, *_: (sgd_opt_ref(p_, g_, lr=SGD_LR),),
                0, 0, (), timed=False))
        for name, e in nums.items():
            if W > 1:
                out[name].update(e)
            else:
                out[name]["w1"] = e
    del slots, ss
    gc.collect()
    torch.cuda.empty_cache()

    # the closest torch.optim steps: textbook Adam (scalar bias correction,
    # eps outside the root) moves 7 arrays, not 11; SGD without momentum
    for W in (WORKERS, 1):
        n = sizes[W]
        gg = g[:, :n] if W > 1 else g[0, :n]
        for name, make in (
                ("adam_opt_chunks", lambda ps: torch.optim.Adam(
                    ps, lr=ADAM_LR, fused=True)),
                ("sgd_opt_chunks", lambda ps: torch.optim.SGD(
                    ps, lr=SGD_LR, fused=True))):
            lp = torch.nn.Parameter(p[:n].clone())
            opt = make([lp])

            def library_step():
                lp.grad = gg.mean(0) if W > 1 else gg
                opt.step()
            library_ms = median_ms(torch, library_step, reps=5)
            del lp, opt
            gc.collect()
            torch.cuda.empty_cache()
            nums = out[name] if W > 1 else out[name]["w1"]
            nums["library_ms"] = library_ms
    for name, e in out.items():
        for W, nums in ((WORKERS, e), (1, e["w1"])):
            if "divisor_ms" in nums:
                log(f"{name} W={W}: {nums['divisor_ms']:.3f} ms with the "
                    f"device divisor")
            log(f"{name} W={W}: kernel {nums['ms']:.3f} ms, bound "
                f"{nums['bound_ms']:.3f} ms ({nums['bound_by']}), plain "
                f"{nums['plain_ms']:.3f} ms, library {nums['library_ms']:.3f}"
                f" ms (torch.optim.{'Adam' if 'adam' in name else 'SGD'} "
                f"fused{' after g.mean(0)' if W > 1 else ''})")
    del p, g
    gc.collect()
    torch.cuda.empty_cache()

    # small bitwise cases: bf16, W=3 (division, not 1/W), ragged tails
    # (the wrapper pads copies of the slots and copies them back)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for dtype, W, n in ((torch.bfloat16, 1, 8192 * 37 + 100),
                        (torch.bfloat16, 4, 8192 * 37),
                        (torch.float32, 3, 8192 * 37 + 100)):
        pp = torch.randn(n, device="cuda", generator=gen).to(dtype)
        gs = (torch.randn(W, n, device="cuda", generator=gen) * 1e-2)
        gs[:, ::13] = 0
        gs = gs.to(dtype)
        gg = gs if W > 1 else gs[0]
        m = (torch.randn(n, device="cuda", generator=gen) * 1e-2).to(dtype)
        v = (torch.rand(n, device="cuda", generator=gen) * 1e-4).to(dtype)
        k1, k2 = (torch.rand(n, device="cuda", generator=gen)
                  for _ in range(2))
        k1[::7] = 0
        k2[::7] = 0
        want = adam_opt_ref(pp, gg, m, v, k1, k2, **adam_kw)
        got = fused_adam_opt(pp, gg, m, v, k1, k2, **adam_kw)
        check(all(a is b for a, b in zip(got[1:], (m, v, k1, k2))),
              "fused_adam_opt returns its slots, updated in place")
        err, ulp = compare(torch, got, want)
        e2, u2 = compare(torch, (fused_sgd_opt(pp, gg, lr=SGD_LR),),
                         (sgd_opt_ref(pp, gg, lr=SGD_LR),))
        log(f"small case {dtype} W={W} n={n}: adam max_abs {err:.3e} "
            f"max_ulp {ulp}; sgd max_abs {e2:.3e} max_ulp {u2}")
        check(ulp == 0 and u2 == 0, f"small case {dtype} W={W} not bitwise")
    return out


def diag_span(torch, g, lo: int, hi: int):
    """Elements [lo, hi) of the block diagonal of the stacked (S, n)
    buffer g: element i of shard j = i // (n / S) lies in row j."""
    S, n = g.shape
    L = n // S
    return torch.cat([g[j, max(lo, j * L):min(hi, (j + 1) * L)]
                      for j in range(S) if j * L < hi and lo < (j + 1) * L])


def wire_kernel_phase(torch, n: int, ce: int, lr: float, mu: float) -> dict:
    """The int8 wire's kernels at the int8 W=4 main path's shapes: the
    whole (n,) stacked domain in chunks of ``ce``; span by span against
    their plain versions; timings.  Returns the kernels-line entries."""
    from repro_torch.kernels.agg_opt import (dequant_agg_opt_ref,
                                             fused_dequant_agg_opt)
    from repro_torch.kernels.quant import (dequantize_int8,
                                           dequantize_int8_ref,
                                           quantize_int8, quantize_int8_ref)
    check(SPAN % ce == 0, "spans are whole chunks")
    nc = n // ce
    x = torch.empty(n, device="cuda")
    fill(torch, x, "g")
    x[:ce] = 0                                 # an all-zero chunk: scale 1
    q, s = quantize_int8(x, chunk_elems=ce)
    d = dequantize_int8(q, s, chunk_elems=ce)
    torch.cuda.synchronize()
    q_err = s_ulp = d_err = d_ulp = 0
    for _, lo, hi in spans(n):
        qr, sr = quantize_int8_ref(x[lo:hi], ce)
        q_err = max(q_err, int((q[lo:hi].int() - qr.int()).abs().max()))
        s_ulp = max(s_ulp, compare(torch, [s[lo // ce:hi // ce]], [sr])[1])
        e, u = compare(torch, [d[lo:hi]],
                       [dequantize_int8_ref(q[lo:hi], s[lo // ce:hi // ce],
                                            ce)])
        d_err, d_ulp = max(d_err, e), max(d_ulp, u)
    log(f"quantize_chunks: x ({nc}, {ce}) f32 -> q int8, scales ({nc},): "
        f"max |dq| {q_err}, scales max_ulp {s_ulp}; scale of the zero chunk "
        f"{float(s[0])}")
    log(f"dequantize_chunks: ({nc}, {ce}) int8 -> f32: max_abs {d_err:.3e} "
        f"max_ulp {d_ulp}")
    check(q_err == 0 and s_ulp == 0 and float(s[0]) == 1.0,
          "quantize_chunks differs from its plain version")
    check(d_ulp == 0, "dequantize_chunks differs from its plain version")
    del d
    out = {}

    def timed(name, run, plain_spans, library, library_label, n_bytes,
              n_ops, extra_bytes, err, ulp, source):
        kernel_ms = median_ms(torch, run, reps=10)
        plain_ms = median_ms(torch, plain_spans, reps=3, warmup=1)
        library_ms = median_ms(torch, library, reps=5)
        bound_ms, bound_by = bound(n, n_bytes, n_ops, extra_bytes)
        log(f"{name}: kernel {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}, {(n * n_bytes + extra_bytes) / 1e9:.2f} GB), "
            f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms "
            f"({library_label})")
        out[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "library": library_label}

    def plain_quant():
        for _, lo, hi in spans(n):
            quantize_int8_ref(x[lo:hi], ce)

    def plain_dequant():
        for _, lo, hi in spans(n):
            dequantize_int8_ref(q[lo:hi], s[lo // ce:hi // ce], ce)

    zeros = torch.zeros(nc, dtype=torch.int64, device="cuda")
    x2 = x.view(nc, ce)
    # read 4 bytes and write 1 an element, one f32 scale a chunk; abs, max,
    # divide, round, two clamps an element
    timed("quantize_chunks", lambda: quantize_int8(x, chunk_elems=ce),
          plain_quant,
          lambda: torch.quantize_per_channel(x2, s, zeros, 0, torch.qint8),
          "torch.quantize_per_channel qint8 at the kernel's scales: "
          "multiplies by 1/scale and clamps to [-128, 127], not the same "
          "function", 5, 6, 4 * nc, float(q_err), s_ulp, QUANT_SOURCE)
    qt = torch.quantize_per_channel(x2, s, zeros, 0, torch.qint8)
    del x, x2
    timed("dequantize_chunks", lambda: dequantize_int8(q, s, chunk_elems=ce),
          plain_dequant, lambda: qt.dequantize(),
          "QTensor.dequantize of the per-channel qint8 tensor: "
          "(q - 0) * scale, the same values", 5, 1, 4 * nc, d_err, d_ulp,
          QUANT_SOURCE)
    del qt, zeros
    gc.collect()
    torch.cuda.empty_cache()

    # the tail: p, m, the (4, n) stacked gradients read on the diagonal
    p = torch.empty(n, device="cuda")
    m = torch.empty(n, device="cuda")
    g = torch.empty(WORKERS, n, device="cuda")
    fill(torch, p, "p")
    fill(torch, m, "m")
    for w in range(WORKERS):
        fill(torch, g[w], "g", w)
    kw = dict(lr=lr, momentum=mu, inv_n=1.0 / WORKERS, chunk_elems=ce)
    got = fused_dequant_agg_opt(p, q, s, g, m, **kw)
    torch.cuda.synchronize()
    err, ulp = 0.0, 0
    for _, lo, hi in spans(n):
        e, u = compare(torch, [t[lo:hi] for t in got], dequant_agg_opt_ref(
            p[lo:hi], q[lo:hi], s[lo // ce:hi // ce],
            diag_span(torch, g, lo, hi), m[lo:hi], **kw))
        err, ulp = max(err, e), max(ulp, u)
    del got
    log(f"dequant_agg_opt_chunks: p/m ({nc}, {ce}) f32, q int8, g_own on "
        f"the diagonal of g ({WORKERS}, {nc}, {ce}): max_abs {err:.3e} "
        f"max_ulp {ulp}")
    check(ulp == 0, f"dequant_agg_opt_chunks differs from its plain version "
                    f"(max_ulp {ulp}); the kernel claims bitwise")

    def plain_tail():
        for _, lo, hi in spans(n):
            dequant_agg_opt_ref(p[lo:hi], q[lo:hi], s[lo // ce:hi // ce],
                                diag_span(torch, g, lo, hi), m[lo:hi], **kw)

    lp = torch.nn.Parameter(p.clone())
    sgd = torch.optim.SGD([lp], lr=lr, momentum=mu, nesterov=True,
                          fused=True)
    dq = dequantize_int8(q, s, chunk_elems=ce)

    def library_step():
        lp.grad = dq
        sgd.step()
    # read p, m, g_own (4 bytes each) and q (1), write p and m; per element
    # a product, a sum and a product for g, then the 5 of Nesterov
    timed("dequant_agg_opt_chunks",
          lambda: fused_dequant_agg_opt(p, q, s, g, m, **kw), plain_tail,
          library_step, "torch.optim.SGD nesterov fused, on the decoded "
          "partial as g: not the same function (no own rows, no mean)",
          21, 9, 4 * nc, err, ulp, CARD_SOURCE)
    del p, m, g, q, s, lp, sgd, dq
    gc.collect()
    torch.cuda.empty_cache()
    return out


def health_kernel_phase(torch, sizes: dict, ce: int) -> dict:
    """health_chunks at the gated steps' domains: the stacked (W, padded)
    buffer's W * n_chunks rows at W=4 and the n_chunks rows at W=1, each a
    chunk of ``ce`` f32; partials against the plain version span by span
    (it does not write its input, so the same tensor is read again);
    timings.  Returns the kernels-line entry (W=4 at the top, W=1 under
    "w1")."""
    from repro_torch.kernels.agg_opt import (fused_health_scan,
                                             health_chunks_ref,
                                             health_partials)
    check(SPAN % ce == 0, "spans are whole chunks")
    n4 = sizes[WORKERS]
    g = torch.empty(WORKERS, n4, device="cuda")
    for w in range(WORKERS):
        fill(torch, g[w], "g", w)
    rows4 = g.view(-1, ce)
    # special chunks of worker 0: one NaN, one Inf, 1e20 values whose
    # squares overflow, and all zeros
    rows4[0, 7] = float("nan")
    rows4[1, 100] = float("inf")
    rows4[2] = 1e20
    rows4[3] = 0
    out = {"name": "health_chunks", "route": "cuda", "source": CARD_SOURCE,
           "replaces": REPLACES["health_chunks"], "launches": 0}
    for W, rows in ((WORKERS, rows4), (1, g[1, :sizes[1]].view(-1, ce))):
        nc = rows.shape[0]
        got = health_partials(rows)
        torch.cuda.synchronize()
        err, ulp, nonfinite_ok = 0.0, 0, True
        for _, lo, hi in spans(nc * ce):
            a, b = got[lo // ce:hi // ce], health_chunks_ref(
                rows[lo // ce:hi // ce])
            fin = torch.isfinite(b)
            nonfinite_ok &= (torch.equal(torch.isnan(a), torch.isnan(b))
                             and torch.equal(torch.isposinf(a),
                                             torch.isposinf(b)))
            e, u = compare(torch, [a[fin]], [b[fin]])
            err, ulp = max(err, e), max(ulp, u)
        if W == WORKERS:
            special = got[:4].tolist()
            check(math.isnan(special[0]) and special[1] == math.inf
                  and special[2] == math.inf and special[3] == 0.0,
                  f"special chunks: {special}, want [nan, inf, inf, 0]")
            sums = fused_health_scan(g, chunk_elems=ce)
            check(math.isnan(float(sums[0]))
                  and bool(torch.isfinite(sums[1:]).all()),
                  f"per-worker sums {sums.tolist()}")
        log(f"health_chunks W={W}: g ({nc}, {ce}) f32 -> ({nc},) partials: "
            f"max_abs {err:.3e} max_ulp {ulp}, NaN and Inf where the plain "
            f"version has them: {nonfinite_ok}"
            + (f"; special chunks {special}" if W == WORKERS else ""))
        check(ulp == 0 and nonfinite_ok, f"health_chunks W={W} differs from "
                                         f"its plain version (max_ulp {ulp})")
        del got
        kernel_ms = median_ms(torch, lambda: health_partials(rows), reps=10)

        def plain_spans():
            for _, lo, hi in spans(nc * ce):
                health_chunks_ref(rows[lo // ce:hi // ce])
        plain_ms = median_ms(torch, plain_spans, reps=3, warmup=1)
        library_ms = median_ms(torch, lambda: torch.linalg.vector_norm(
            rows, dim=1, dtype=torch.float32), reps=10)
        # read 4 bytes an element, write 4 a chunk; a product and a sum
        bound_ms, bound_by = bound(nc * ce, 4, 2, 4 * nc)
        log(f"health_chunks W={W}: kernel {kernel_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}, {(4 * nc * ce + 4 * nc) / 1e9:.2f}"
            f" GB), plain {plain_ms:.3f} ms, library {library_ms:.3f} ms "
            f"(torch.linalg.vector_norm per chunk: takes the root too)")
        e = {"max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms,
             "library": "torch.linalg.vector_norm(rows, dim=1): the root of "
                        "each chunk's sum of squares, not the same function"}
        if W == WORKERS:
            out.update(e)
        else:
            out["w1"] = e
    del g, rows4, rows
    gc.collect()
    torch.cuda.empty_cache()

    # a small bf16 case: a bf16 group's chunk (16384), a ragged tail
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    gb = torch.randn(2, 16384 * 5 + 77, device="cuda",
                     generator=gen).bfloat16()
    rows = torch.nn.functional.pad(gb, (0, -gb.shape[1] % 16384)) \
        .reshape(-1, 16384)
    got, want = health_partials(rows), health_chunks_ref(rows)
    ulp = compare(torch, [got], [want])[1]
    sums_ok = torch.equal(fused_health_scan(gb, chunk_elems=16384),
                          want.view(2, -1).sum(1))
    log(f"health_chunks small bf16 case {tuple(rows.shape)}: max_ulp {ulp}, "
        f"sums equal {sums_ok}")
    check(ulp == 0 and sums_ok, "health_chunks bf16 case not bitwise")
    return out


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.detach().clone().to(device) for k, v in tree.items()}


def reference_phase(torch, optimizer: str, gated: bool = False,
                    arch: str = ARCH, seq: int = 64) -> None:
    """One 4-worker step of a reduced ``arch``: card (kernel) vs CPU (plain
    versions), same weights and batch of ``seq`` tokens.  The attention-free
    family runs at f32 activations and T 128, so its chunked scan (two
    chunks of 64) runs under autograd on both devices and their gradients
    differ by summation order only.  ``gated``: the sanity-gated step
    with worker ``POISONED`` NaN-injected; its verdicts must agree, and on
    the card it must equal the static k-of-n step with that worker dead,
    bitwise.  The gated step runs at f32 activations: with bf16 ones the
    two devices' gradients differ by up to 2e-2 of a leaf's largest entry
    (tests/test_torch_model.py), so their norms would test the model's
    precision, not the scan; at f32 they differ by summation order only,
    and the norms are held within NORM_RTOL."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.elastic import Membership
    from repro_torch.models import DecoderLM
    from repro_torch.resilience import SanityConfig

    reset_all_launches()
    cfg = reduced(get_arch(arch))
    if gated or cfg.attn_free:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if optimizer == "adam":
        tc = TrainConfig(loss_chunk=64, optimizer="adam", lr=ADAM_LR,
                         adam_eps=ADAM_REF_EPS)
    elif optimizer == "sgd":
        tc = TrainConfig(loss_chunk=64, optimizer="sgd", lr=SGD_LR)
    else:
        tc = TrainConfig(loss_chunk=64)
    eng_cpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cpu")
    eng_gpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
    model_c, opt_c = eng_cpu.init_state()
    init = model_c.param_tree()
    model_g = DecoderLM(cfg, device="cuda", params=tree_to(init, "cuda"))
    opt_g = eng_gpu.init_opt()
    data = SyntheticTokens(cfg, BATCH, seq, seed=0)
    extra = ()
    if gated:
        inject = np.ones(WORKERS, np.float32)
        inject[POISONED] = np.nan
        extra = ({"norm_hi": np.float32(np.inf), "inject": inject},)
        sanity = SanityConfig(allow_injection=True)
        # the static k-of-n step from the same weights, on the card
        eng_dead = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
        model_d = DecoderLM(cfg, device="cuda", params=tree_to(init, "cuda"))
        _, opt_d, met_d = eng_dead.make_train_step(
            membership=Membership.full(WORKERS).leave(POISONED))(
                model_d, eng_dead.init_opt(), data.torch_batch(0, "cuda"))
    else:
        sanity = None
    _, opt_c, met_c = eng_cpu.make_train_step(sanity=sanity)(
        model_c, opt_c, data.torch_batch(0, "cpu"), *extra)
    _, opt_g, met_g = eng_gpu.make_train_step(sanity=sanity)(
        model_g, opt_g, data.torch_batch(0, "cuda"), *extra)
    if gated:
        ok_c, ok_g = met_c["ok_mask"].tolist(), met_g["ok_mask"].cpu().tolist()
        nl_c, nl_g = float(met_c["n_live"]), float(met_g["n_live"])
        want_ok = [0.0 if w == POISONED else 1.0 for w in range(WORKERS)]
        norms_c = met_c["grad_norms"].numpy()
        norms_g = met_g["grad_norms"].cpu().numpy()
        live = [w for w in range(WORKERS) if w != POISONED]
        drel = float(np.max(np.abs(norms_g[live] - norms_c[live])
                            / norms_c[live]))
        log(f"gated {optimizer} step, worker {POISONED} NaN-injected: "
            f"ok_mask card {ok_g} CPU {ok_c}, n_live card {nl_g:g} CPU "
            f"{nl_c:g}, grad_norms card {norms_g.tolist()} (max rel diff "
            f"to the CPU's {drel:.2e})")
        check(ok_c == ok_g == want_ok and nl_c == nl_g == WORKERS - 1,
              "gated verdicts differ from the expected [1, 0, 1, 1], n_live 3")
        check(np.isnan(norms_c[POISONED]) and np.isnan(norms_g[POISONED])
              and drel <= NORM_RTOL, f"grad_norms differ by {drel}")
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaf_paths(model_g.param_tree()), leaf_paths(model_d.param_tree())))
        same &= all(torch.equal(opt_g["float32"][n], opt_d["float32"][n])
                    for n in opt_g["float32"])
        same &= torch.equal(met_g["loss"], met_d["loss"])
        log(f"  gated card step == static k-of-n card step (worker "
            f"{POISONED} dead), parameters, slots and loss bitwise: {same}")
        check(same, "the gated step differs from the static k-of-n step")
        del model_d, opt_d, eng_dead
    dloss = abs(float(met_c["loss"]) - float(met_g["loss"]))
    dparam = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for (_, a), (_, b) in zip(leaf_paths(model_g.param_tree()),
                                           leaf_paths(model_c.param_tree())))
    dslot = {n: float((t.cpu().float() - opt_c["float32"][n].float())
                      .abs().max()) for n, t in opt_g["float32"].items()}
    scans = all_launches()["rwkv_scan_kernel"]
    check(scans == 0, f"a train step launched rwkv_scan_kernel {scans} "
                      f"times: training runs autograd of the chunked form")
    log(f"reduced {arch} (d_model={cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.dtype} activations, T {seq}), {WORKERS} workers, 1 "
        f"{'gated ' if gated else ''}{optimizer} step, card vs CPU: loss "
        f"{float(met_g['loss']):.6f} |dloss| {dloss:.3e}, max |dparam| "
        f"{dparam:.3e}, "
        + ", ".join(f"max |d{n}| {d:.3e}" for n, d in dslot.items()))
    # f32 products summed in another order on each device, bf16 activations
    check(dloss <= 1e-3, f"card loss differs from CPU loss by {dloss}")
    if optimizer == "sgd":
        # p' = p - lr g moves less than Nesterov's first p - lr (1 + mu) g
        check(dparam <= 1e-4, f"card SGD step differs from CPU step: "
                              f"params {dparam}")
        return
    if optimizer == "nesterov":
        dmom = dslot["m"]
        check(dparam <= 1e-4 and dmom <= 1e-2,
              f"card step differs from CPU step: params {dparam}, "
              f"momentum {dmom}")
        return
    # from zero slots m' = (1-b1) g, and the first Adam step is
    # lr * g / (|g| + eps): |dp| <= lr * |dg| / eps, |dg| = |dm'| / (1-b1)
    dg = dslot["m"] / (1 - tc.adam_b1)
    bound = tc.lr * dg / tc.adam_eps * 1.01 + 1e-6
    k1_c, k1_g = opt_c["float32"]["k1"], opt_g["float32"]["k1"].cpu()
    log(f"  Adam bound: |dg| {dg:.3e} -> |dparam| <= {bound:.3e}; k1 "
        f"differs at {int((k1_c != k1_g).sum())} of {k1_c.numel()} positions")
    check(dg <= 1e-2, f"card gradients differ from CPU gradients by {dg}")
    check(dparam <= bound, f"card Adam step differs from CPU step: params "
                           f"{dparam} > {bound}")


def wire_reference_phase(torch, wire_name: str) -> None:
    """One 4-worker Nesterov step of a reduced model over an encoded wire:
    card (kernels) vs CPU (plain versions), same weights and batch.  The
    gradients differ by f32 summation order, and an ulp can move an
    encoded entry across a rounding boundary: by one grid step of a pushed
    partial, which moves p' by lr * (1 + mu) / N times it, or by one grid
    step of the pull's delta.  The bound sums those steps, as measured
    here on the CPU's run (for int8 a chunk's scale, max|x| / 127; for
    bf16 an ulp, at most 2^-7 max|x|), plus the identity wire's 1e-4."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import (flatten_groups, flatten_leaves,
                                           leaf_paths)
    from repro_torch.core.pipeline import add_ring_rows_, ring_rows
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM

    cfg = reduced(get_arch(ARCH))
    tc = TrainConfig(loss_chunk=64, wire_format=wire_name)
    eng_cpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cpu")
    eng_gpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
    model_c, opt_c = eng_cpu.init_state()
    model_g = DecoderLM(cfg, device="cuda",
                        params=tree_to(model_c.param_tree(), "cuda"))
    opt_g = eng_gpu.init_opt()
    check(list(opt_g["float32"]) == ["m", "wire_ef"], "the wire_ef slot")
    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    batch = data.torch_batch(0, "cpu")
    (group,) = eng_cpu.chunk_plan.groups
    ce, wire = group.chunk_elems, eng_cpu.wire

    def grid(x):
        amax = float(x.detach().abs().max())
        return amax / 127 if wire.has_scales else amax * 2.0 ** -7

    # the CPU's stacked gradients, to measure the push's grid steps
    loss_fn = eng_cpu.build_loss_fn()
    paths, leaves = zip(*leaf_paths(model_c.param_tree()))
    bw = BATCH // WORKERS
    G = torch.empty(WORKERS, group.padded)
    for w in range(WORKERS):
        sl = slice(w * bw, (w + 1) * bw)
        grads = torch.autograd.grad(loss_fn(model_c, batch["tokens"][sl],
                                            batch["labels"][sl])[0], leaves)
        (G[w],) = flatten_leaves(eng_cpu.chunk_plan,
                                 dict(zip(paths, grads))).values()
    acc = ring_rows(G, 1)
    push = grid(acc)
    for k in range(2, WORKERS):
        acc = add_ring_rows_(wire.decode(wire.encode(acc, ce), ce), G, k)
        push += grid(acc)
    del acc, grads

    (p_prev,) = flatten_groups(eng_cpu.chunk_plan,
                               model_c.param_tree()).values()
    p_prev = p_prev.clone()
    _, opt_c, met_c = eng_cpu.make_train_step()(model_c, opt_c, batch)
    _, opt_g, met_g = eng_gpu.make_train_step()(model_g, opt_g,
                                                data.torch_batch(0, "cuda"))
    (p_c,) = flatten_groups(eng_cpu.chunk_plan, model_c.param_tree()).values()
    (p_g,) = flatten_groups(eng_gpu.chunk_plan, model_g.param_tree()).values()
    ef_c = opt_c["float32"]["wire_ef"].reshape(-1)
    ef_g = opt_g["float32"]["wire_ef"].reshape(-1).cpu()
    pull = grid((p_c - p_prev) + ef_c)
    limit = pull + tc.lr * (1 + tc.momentum) / WORKERS * push + 1e-4
    dloss = abs(float(met_c["loss"]) - float(met_g["loss"]))
    dparam = float((p_g.detach().cpu() - p_c.detach()).abs().max())
    def_ = float((ef_g - ef_c).abs().max())
    dmom = float((opt_g["float32"]["m"].cpu() - opt_c["float32"]["m"])
                 .abs().max())
    log(f"reduced {ARCH}, {WORKERS} workers, 1 nesterov step over the "
        f"{wire_name} wire, card vs CPU: loss {float(met_g['loss']):.6f} "
        f"|dloss| {dloss:.3e}, max |dparam| {dparam:.3e}, max |dwire_ef| "
        f"{def_:.3e}, max |dm| {dmom:.3e}; grid steps: pull {pull:.3e}, "
        f"push (sum over {WORKERS - 1} hops) {push:.3e} -> bound "
        f"{limit:.3e}; max |wire_ef| {float(ef_c.abs().max()):.3e}")
    check(dloss <= 1e-3, f"card loss differs from CPU loss by {dloss}")
    check(float(ef_c.abs().max()) > 0, "error feedback did not engage")
    check(dparam <= limit and def_ <= limit,
          f"card {wire_name} step differs from CPU step: params {dparam}, "
          f"wire_ef {def_} > {limit}")
    # m' = g (from zero momentum), so |dm| <= one push grid step / N
    check(dmom <= push / WORKERS + 1e-2, f"momentum differs by {dmom}")


def bit_sum(torch, t) -> int:
    """The int64 sum of an f32 (or bf16) tensor's bit patterns: any one
    changed element changes it (an untied embedding's rows of tokens the
    batch does not hold keep their values, so a prefix is no test)."""
    ity = torch.int16 if t.element_size() == 2 else torch.int32
    with torch.no_grad():
        return int(t.detach().reshape(-1).view(ity).sum(dtype=torch.int64))


def fingerprint(torch, model) -> list:
    """The parameters' fingerprint after a step: per leaf its f64 sum, the
    int64 sum of its f32 bit patterns (any one changed element changes
    it) and every SAMPLE_STRIDE-th element (on the host)."""
    from repro_torch.core.chunking import leaf_paths
    out = []
    with torch.no_grad():
        for path, t in leaf_paths(model.param_tree()):
            flat = t.detach().reshape(-1)
            out.append((path, float(flat.sum(dtype=torch.float64)),
                        bit_sum(torch, flat),
                        flat[::SAMPLE_STRIDE].to("cpu", copy=True)))
    return out


def same_fingerprint(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        pa == pb and sa == sb and ia == ib and torch.equal(xa, xb)
        for (pa, sa, ia, xa), (pb, sb, ib, xb) in zip(a, b))


def path_tc(optimizer: str, wire: str, fields: dict):
    """A main path's TrainConfig: ``loss_chunk`` at most the sequence, the
    rule's lr (Adam ADAM_LR, SGD SGD_LR, Nesterov the default) and
    ``fields``."""
    from repro_torch.configs import TrainConfig
    lr = {"adam": ADAM_LR, "sgd": SGD_LR}.get(optimizer)
    return TrainConfig(loss_chunk=min(1024, SEQ), optimizer=optimizer,
                       wire_format=wire, **({"lr": lr} if lr else {}),
                       **fields)


def main_path(torch, workers: int, steps: int, expect: dict,
              optimizer: str = "nesterov", wire: str = "identity",
              faults=None, pipeline=None, arch: str = ARCH,
              layers: int = 0, dead: int | None = None, comm=None,
              time_exchange: bool = False, pods: int = 1,
              want_windows: int | None = None,
              cfg_fields: dict | None = None) -> dict:
    """PHubEngine + fit on the full ``arch`` (full width; ``layers``, if
    given, cuts its depth; ``cfg_fields`` replaces more of its fields,
    such as the expert count) under ``optimizer`` over ``wire``; a
    frontend architecture's batches carry its prefix of seed-drawn
    embeddings (``data.PrefixedTokens``); ``expect``
    holds each kernel's launches per step and group (every other count
    must stay 0).  ``faults``: a FaultSchedule; the run then goes through
    fit(supervisor=TrainSupervisor) with injection on and demote_after 2,
    and the supervisor's record is checked.  ``pipeline``: more
    TrainConfig fields (the pipeline's ``pipeline_windows``,
    ``flat_residency``, ``overlap_backward``; ``strategy``,
    ``wire_format_dcn``); the requested window count (or
    ``want_windows``) must take effect.  ``pods``: the stacked Comm's
    pods.  ``dead``: a static k-of-n membership with that worker left out.
    ``comm``: a ProcessGroupComm (one worker this process, ``workers`` its
    world) instead of ``StackedComm(workers, pods)``; its launches are
    this rank's.  ``time_exchange``: the exchange stage timed between two
    synchronizations a step, beside the Comm's own collective time.
    Returns the run's launch counts, its losses, the parameters'
    fingerprint before and after every step, step ms, peak GiB, the
    exchange's and collectives' ms a step and the Comm's calls, bytes and
    seconds per operation over the run."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import PrefixedTokens, SyntheticTokens
    from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                        TrainSupervisor)
    from repro_torch.training import TrainState, fit

    import dataclasses

    from repro_torch.elastic import Membership
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg_fields:
        cfg = dataclasses.replace(cfg, **cfg_fields)
    from repro_torch.core.pipeline import effective_windows
    tc = path_tc(optimizer, wire, pipeline or {})
    engine = PHubEngine(cfg, tc, comm or StackedComm(workers, pods),
                        device="cuda")
    where = (f"rank {comm.rank} of {workers} ({comm.backend}) "
             if comm is not None else "")
    exchange_s = exchange_timer(torch, engine) if time_exchange else []
    model, opt = engine.init_state()
    # fsdp_stream has no chunk domain: its rule runs leaf by leaf
    groups = engine.chunk_plan.groups if engine.chunk_plan else ()
    windows = [effective_windows(g, tc.pipeline_windows) for g in groups]
    want_w = want_windows or tc.pipeline_windows
    check(windows == [want_w] * len(windows),
          f"{tc.pipeline_windows} windows asked for, {windows} take effect, "
          f"want {want_w}")
    check((model.flat_store is not None) == tc.flat_residency,
          "the model's residency is not the engine's")
    state = TrainState(params=model, opt=opt)
    del opt          # fit replaces state.opt; a second reference would
    #                  keep the first step's slots alive through the run
    rule = {"nesterov": f"momentum {tc.momentum}",
            "adam": f"b1 {tc.adam_b1}, b2 {tc.adam_b2}, eps {tc.adam_eps}",
            "sgd": "no momentum"}[optimizer]
    sup = None
    if faults is not None:
        sup = TrainSupervisor(engine, SupervisorConfig(
            sanity=SanityConfig(allow_injection=True), demote_after=2),
            faults=faults, log_fn=log)
    n_tree = sum(t.numel() for _, t in leaf_paths(model.param_tree()))
    membership_fn = None
    if dead is not None:
        members = Membership.full(workers).leave(dead)
        membership_fn = lambda step: members        # noqa: E731
    P = comm.pods if comm is not None else pods
    log(f"{where}main path: {arch} {n_tree:,} parameters in the tree, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}; {tc.strategy}"
        f"{f' ({P} pods x {workers // P})' if P > 1 else ''}"
        f"{f', DCN wire {tc.wire_format_dcn}' if tc.wire_format_dcn else ''}"
        f", {workers} {'process' if comm else 'stacked'} worker(s)"
        f"{f', worker {dead} dead (static k-of-n)' if dead is not None else ''}"
        f", {wire} wire, batch {BATCH} x {SEQ}, {steps} step(s), "
        f"{optimizer} at lr {tc.lr}, {rule}"
        f"{'; supervised, faults ' + str(faults.events) if sup else ''}; "
        f"windows {tc.pipeline_windows} (effective {windows}), flat "
        f"residency {tc.flat_residency}, chunk-ready "
        f"{tc.overlap_backward}; "
        + (f"groups " + ", ".join(f"{g.key}: {g.total:,} -> {g.padded:,} "
                                  f"({g.n_chunks} chunks of {g.chunk_elems})"
                                  for g in groups) if groups else
           f"{tc.strategy}: the rule leaf by leaf, no chunk domain")
        + (f"; weight decay {tc.weight_decay}" if tc.weight_decay else "")
        + (f"; microbatch {tc.microbatch}" if tc.microbatch > 1 else ""))
    before = {p: bit_sum(torch, t) for p, t in leaf_paths(model.param_tree())}
    init_print = fingerprint(torch, model)
    data = (PrefixedTokens if cfg.frontend else SyntheticTokens)(
        cfg, BATCH, SEQ, seed=tc.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]

    health, step_ms, peaks, prints, coll_ms = [], [], [], [], []

    def collective_s() -> float:
        """The exchange's collectives so far (not the loss's gather)."""
        return sum(st["seconds"] for op, st in comm.stats.items()
                   if op != "gather_small") if comm else 0.0

    stats0 = ({op: dict(st) for op, st in comm.stats.items()} if comm
              else {})

    coll = [collective_s()]

    def on_step(state, metrics):
        torch.cuda.synchronize()
        ms = (time.perf_counter() - marks[-1]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms.append(ms)
        peaks.append(peak)
        coll.append(collective_s())
        coll_ms.append((coll[-1] - coll[-2]) * 1e3)
        timed = (f"  exchange {exchange_s[-1] * 1e3:.1f} ms, collectives "
                 f"{coll_ms[-1]:.1f} ms" if time_exchange else "")
        gated = ""
        if sup is not None:
            health.append(metrics)
            gated = (f"  ok_mask {metrics['ok_mask'].tolist()} n_live "
                     f"{metrics['n_live']:g} grad_norms "
                     f"{metrics['grad_norms'].tolist()}")
        log(f"{where}step {state.step - 1}: loss {state.losses[-1]!r}  "
            f"{ms:.1f} ms  {BATCH * SEQ / (ms / 1e3):,.0f} tokens/s  "
            f"peak {peak:.2f} GiB" + timed + gated)
        # the fingerprint is outside the step's time and peak
        prints.append(fingerprint(torch, state.params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks.append(time.perf_counter())

    reset_all_launches()
    state = fit(engine, state, data, steps=steps, log_every=0,
                hooks=[on_step], supervisor=sup,
                membership_fn=membership_fn)
    launches = all_launches()
    if sup is not None:
        masks = [h["ok_mask"].tolist() for h in health]
        live = [h["n_live"] for h in health]
        demotes = [(e["step"], e["worker"], e["status"])
                   for e in sup.incident_history("demote")]
        log(f"supervised: ok_mask {masks}, n_live {live}, demotions "
            f"{demotes}, live ranks {sup.membership.live_ranks}, "
            f"{len(sup._steps)} step functions, events {sup.event_kinds()}")
        check(masks == [[1, 1, 1, 1], [1, 0, 1, 1], [1, 0, 1, 1],
                        [1, 0, 1, 1]][:steps]
              and live == [4, 3, 3, 3][:steps],
              f"verdicts {masks}, n_live {live}")
        if steps >= 4:
            check(demotes == [(2, POISONED, "slow")],
                  f"demotions {demotes}, want worker {POISONED} at step 2")
            check(sup.membership.live_ranks == (0, 2, 3)
                  and len(sup._steps) == 2 and sup.rollbacks == 0,
                  "step 3 did not run on the static 3-of-4 program")
        else:
            check(demotes == [] and sup.rollbacks == 0,
                  f"demotions {demotes} before step 2")
    check(all(math.isfinite(x) for x in state.losses),
          f"non-finite loss {state.losses}")
    check(len(state.losses) == steps, f"{len(state.losses)} losses")
    # every leaf moves; in bf16 an update under half an ulp of the value
    # rounds away (a norm scale at 1.0 moves by 2^-8 or not at all), so
    # there a norm scale still all ones may keep every bit, and no other
    # leaf (the router, the SSM's a_log and dt_bias included)
    kept = [p for p, t in leaf_paths(model.param_tree())
            if bit_sum(torch, t) == before[p]]
    if cfg.param_dtype == "bfloat16":
        tree = dict(leaf_paths(model.param_tree()))
        scales = [p for p in kept if p.rsplit("[", 1)[-1].strip("]'")
                  in NORM_SCALES and bool((tree[p] == 1).all())]
        log(f"{where}bf16 norm scales still all ones that kept every bit: "
            f"{scales}")
        kept = [p for p in kept if p not in scales]
    check(not kept, f"parameters {kept} did not change")
    for name, count in launches.items():
        want = expect.get(name, 0) * steps * max(len(groups), 1)
        check(count == want, f"{where}{name} launched {count} times on "
                             f"the {arch} {workers}-worker {optimizer} "
                             f"{wire} path, want {want}")
    log(f"{where}{arch} {workers}-worker {optimizer} {wire}-wire path: "
        f"launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + " as expected; parameters changed, losses finite")
    losses = list(state.losses)
    del model, state, engine, sup
    gc.collect()
    torch.cuda.empty_cache()
    stats = {op: {k: v - stats0.get(op, {}).get(k, 0) for k, v in st.items()}
             for op, st in (comm.stats.items() if comm else ())}
    return {"launches": launches, "losses": losses, "prints": prints,
            "init_print": init_print, "step_ms": step_ms, "peak_gib": peaks,
            "exchange_ms": [x * 1e3 for x in exchange_s],
            "collective_ms": coll_ms, "stats": stats}


def exchange_timer(torch, engine) -> list:
    """Wrap ``engine.exchange_stage`` in two synchronizations; returns the
    list each call's wall seconds are appended to."""
    spent, inner = [], engine.exchange_stage

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out
    engine.exchange_stage = timed
    return spent


def rollback_phase(torch) -> None:
    """The supervisor's recovery on the card, at reduced size (a
    full-model snapshot is 9.9 GB of disk I/O, not device work): 4
    workers, a snapshot after every step (keep_k 2), every worker
    NaN-pushing at steps 3-5 (divergence_patience 3) and the newest
    snapshot truncated at step 5.  The supervisor must skip the corrupt
    step-5 snapshot by name, restore step 4 (parameters and every slot
    bitwise equal to load_checkpoint's) and finish the 6 steps."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.elastic import (CKPT_CORRUPT, FaultEvent, FaultSchedule,
                                     NAN_PUSH)
    from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                        TrainSupervisor)
    from repro_torch.training import TrainState, fit

    d = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    shutil.rmtree(d, ignore_errors=True)
    cfg = reduced(get_arch(ARCH))
    engine = PHubEngine(cfg, TrainConfig(loss_chunk=64), StackedComm(WORKERS),
                        device="cuda")
    model, opt = engine.init_state()
    faults = FaultSchedule((*(FaultEvent(3, NAN_PUSH, w, duration=3)
                              for w in range(WORKERS)),
                            FaultEvent(5, CKPT_CORRUPT)), world=WORKERS)
    sup = TrainSupervisor(engine, SupervisorConfig(
        sanity=SanityConfig(allow_injection=True), checkpoint_dir=d,
        checkpoint_every=1, keep_k=2, divergence_patience=3),
        faults=faults, log_fn=log)
    restored = []

    def on_step(state, host):
        if sup.rollbacks and not restored:
            step, tree = load_checkpoint(d, state.step)
            saved = dict(leaf_paths(tree["params"]))
            same = all(torch.equal(t.detach().cpu(), saved[p])
                       for p, t in leaf_paths(state.params.param_tree()))
            same &= all(torch.equal(t.cpu(), tree["opt"]["float32"][n])
                        for n, t in state.opt["float32"].items())
            restored.append((step, same))

    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    state = fit(engine, TrainState(params=model, opt=opt), data, steps=6,
                log_every=0, supervisor=sup, hooks=[on_step])
    rb = sup.incident_history("rollback")
    log(f"rollback: {[(e['step'], e['restored_step'], e['skipped']) for e in rb]}"
        f" (step, restored, skipped); restored state bitwise equal to "
        f"load_checkpoint's: {restored}; finished at step {state.step}, "
        f"losses {state.losses}")
    check(len(rb) == 1 and rb[0]["restored_step"] == 4
          and rb[0]["skipped"] == [5], f"rollback record {rb}")
    check(restored == [(4, True)], f"restored state {restored}")
    check(state.step == 6 and all(math.isfinite(x) for x in state.losses),
          "the supervised run did not finish")
    shutil.rmtree(d)


def digest(t) -> str:
    """sha1 of a tensor's bytes (copied to the host)."""
    import hashlib

    import torch
    return hashlib.sha1(t.detach().contiguous().view(-1).view(torch.uint8)
                        .cpu().numpy().tobytes()).hexdigest()


def exchange_rows(torch, comm, world: int) -> dict:
    """The exchange alone on identical pushed rows, on the card: (world,
    ROWS_N) f32 gradient rows, p and the slots drawn from a seed a case,
    every rule x wire x windows 1/2, as the engine dispatches it
    (``run_exchange`` / ``run_wire_exchange``) over ``comm`` (a rank takes
    its row and its shard's slots).  Returns per case the digest of p' and
    {shard: digests of its slot runs and wire_ef run} for the shards this
    process keeps."""
    import itertools
    from repro_torch.configs import TrainConfig
    from repro_torch.core import chunking
    from repro_torch.core.pipeline import run_exchange, run_wire_exchange
    from repro_torch.core.wire import WireFormat
    from repro_torch.optim.protocol import make_sharded_optimizer

    (group,) = chunking.build_plan(
        {"w": torch.empty(ROWS_N, device="meta")}, chunk_bytes=32768,
        n_shards=world).groups
    n, L, ce = group.padded, group.shard_len, group.chunk_elems
    k = comm.local_workers()
    r0 = comm.rank * k
    sh = slice(r0 * L, (r0 + k) * L)
    out = {}
    for i, (rule, wire, windows) in enumerate(itertools.product(
            ("nesterov", "sgd", "adam"), ("identity", "int8"), (1, 2))):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + i)

        def draw(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        g, p = draw(world, n), draw(n)
        slots = {"nesterov": lambda: (0.1 * draw(n),), "sgd": tuple,
                 "adam": lambda: (0.1 * draw(n), 0.01 * draw(n).abs(),
                                  0.1 + 0.8 * draw(n).abs().clamp(max=1),
                                  1e-3 + 0.1 * draw(n).abs().clamp(max=1))
                 }[rule]()
        res = 1e-3 * draw(n)
        tc = TrainConfig(optimizer=rule, wire_format=wire, adam_eps=1e-3,
                         lr={"adam": ADAM_LR, "sgd": SGD_LR}.get(rule, 0.1))
        sopt = make_sharded_optimizer(tc)
        upd = sopt.kernel_update(ce, sopt.coefs(tc))
        mine = tuple(s[sh].clone() for s in slots)
        if wire == "identity":
            p2, s2 = run_exchange("sharded_ps", comm, g[r0:r0 + k], p, mine,
                                  upd, group, windows)
            s2 = tuple(s2)
        else:
            fused = sopt.kernel_dequant_update(ce, sopt.coefs(tc),
                                               1.0 / world)
            p2, s2, r2 = run_wire_exchange(
                "sharded_ps", comm, g[r0:r0 + k], p, mine, upd, group,
                WireFormat(wire), res[sh].clone(), fused, windows)
            s2 = tuple(s2) + (r2,)
        out[(rule, wire, windows)] = {
            "p": digest(p2),
            "shards": {r0 + j: [digest(s.reshape(-1)[j * L:(j + 1) * L])
                                for s in s2] for j in range(k)}}
    return out


def hold_rows(torch, world: int, ranks: list, want: dict) -> None:
    """Every rank's ``exchange_rows`` equal to the stacked Comm's."""
    for r, got in enumerate(ranks):
        for case, w in want.items():
            check(got[case]["p"] == w["p"],
                  f"rank {r} of {world}: the exchange {case} on identical "
                  f"rows gives another p' than the stacked Comm")
            check(got[case]["shards"] == {r: w["shards"][r]},
                  f"rank {r} of {world}: the exchange {case} on identical "
                  f"rows gives other slots than the stacked Comm's shard")
    log(f"the exchange alone on identical pushed rows ({world} x "
        f"{ROWS_N:,} f32; Nesterov, SGD, Adam x identity, int8 x 1, 2 "
        f"windows): every rank's p', slots and wire_ef bitwise equal to "
        f"StackedComm({world})'s")


def rank_expect(expect: dict, rank: int) -> dict:
    """A path's launches per step for ``rank``: the dict itself, or its
    "rank0" / "others" entry (centralized_ps: the PS, rank 0, alone
    launches the update)."""
    if "rank0" in expect:
        return expect["rank0" if rank == 0 else "others"]
    return expect


def dist_rank(comm, device, paths: tuple, rows: bool):
    """A spawned rank of the process-group phases: each of ``paths``
    (label, steps, rule, wire, TrainConfig fields, launches per step, the
    window count that takes effect or None) through ``main_path`` over
    ``comm``, then (``rows``) the exchange alone on identical rows.
    Returns (main_path's records, exchange_rows)."""
    import torch
    runs = [main_path(torch, comm.n_workers, steps,
                      rank_expect(expect, comm.rank), rule, wire,
                      pipeline=pipe, comm=comm, time_exchange=True,
                      want_windows=want)
            for label, steps, rule, wire, pipe, expect, want in paths]
    return runs, (exchange_rows(torch, comm, comm.n_workers) if rows
                  else None)


def reduced_runs(torch, comm, world: int) -> dict:
    """REDUCED_STEPS steps of every (arch, rule, wire, windows) of the
    4-process phase on reduced configs over ``comm``: per case the losses,
    a digest of every parameter and {shard: digests of its slots}."""
    import itertools
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.core.pipeline import effective_windows
    from repro_torch.data import SyntheticTokens
    from repro_torch.training import TrainState, fit

    out = {}
    for arch, rule, wire, windows in itertools.product(
            (ARCH, SSM_ARCH), ("nesterov", "sgd", "adam"),
            ("identity", "int8"), (1, 2)):
        cfg = reduced(get_arch(arch))
        tc = TrainConfig(optimizer=rule, wire_format=wire,
                         pipeline_windows=windows, loss_chunk=REDUCED_SEQ,
                         chunk_size_bytes=REDUCED_CHUNK,
                         **({"lr": ADAM_LR} if rule == "adam" else {}))
        engine = PHubEngine(cfg, tc, comm, device="cuda")
        eff = [effective_windows(g, windows) for g in
               engine.chunk_plan.groups]
        check(eff == [windows], f"reduced {arch}: {windows} windows asked "
                                f"for, {eff} take effect")
        model, opt = engine.init_state()
        data = SyntheticTokens(cfg, BATCH, REDUCED_SEQ, seed=0)
        state = fit(engine, TrainState(params=model, opt=opt), data,
                    steps=REDUCED_STEPS, log_every=0,
                    hooks=[lambda s, m: None])
        k = comm.local_workers()
        out[(arch, rule, wire, windows)] = {
            "losses": list(state.losses),
            "params": [digest(t) for _, t in
                       leaf_paths(model.param_tree())],
            "shards": {comm.rank * k + j: [digest(v[j]) for slots in
                                           state.opt.values()
                                           for v in slots.values()]
                       for j in range(k)}}
    return out


def reduced_rank(comm, device):
    """A spawned rank of the 4-process phase."""
    import torch
    return (reduced_runs(torch, comm, comm.n_workers),
            exchange_rows(torch, comm, comm.n_workers))


def hold_run(torch, label: str, run: dict, base: dict, steps: int) -> None:
    """A process-group path's losses and parameters after every step
    bitwise equal to the stacked path's."""
    check(run["losses"] == base["losses"][:steps],
          f"{label}: losses {run['losses']} differ from the stacked "
          f"path's {base['losses'][:steps]}")
    for i in range(steps):
        check(same_fingerprint(torch, run["prints"][i], base["prints"][i]),
              f"{label}: the parameters after step {i} differ from the "
              f"stacked path's")


def timing_note(run: dict) -> str:
    """Step ms, tokens/s, exchange and collective ms, peak GiB of a run."""
    def r3(xs):
        return [round(x, 3) for x in xs]
    return (f"step ms {r3(run['step_ms'])}, tokens/s "
            f"{[round(BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]}, "
            f"exchange ms {r3(run['exchange_ms'])} of which collectives "
            f"{r3(run['collective_ms'])} (the rest the update kernels, the "
            f"codec and packing), peak GiB {r3(run['peak_gib'])}")


def process_group_phases(torch) -> list:
    """The sharded_ps step over ``torch.distributed``, one worker a process
    (``launch/dist.py``), each path bitwise against the stacked step of
    this call: (a) NCCL at world = the card count, full llama3.2-1b, 1
    Nesterov step; (b) gloo, GLOO_W processes sharing cuda:0, full
    llama3.2-1b in 64 KB chunks (5 windows take effect at S=2), after the
    stacked GLOO_W runs: Nesterov 2 steps, Nesterov in 5 windows
    flat-resident 2, Adam 1, int8 in 5 windows 2, each rank's launches
    exact; the exchange alone on identical rows; (c) gloo, 4 processes on
    cuda:0, reduced llama3.2-1b and rwkv6-3b, 2 steps of every rule, wire
    and 1 or 2 windows, and the exchange alone.  Returns (label, rank 0's
    launches) for the kernels line."""
    from repro_torch.core import StackedComm
    from repro_torch.launch import dist

    counted = []
    world = torch.cuda.device_count()
    expect = ({"agg_opt_chunks": 1} if world == 1
              else {"multi_agg_opt_chunks": 1})
    base = main_path(torch, world, 1, expect, time_exchange=True)
    log(f"(a) NCCL, {world} process(es), one card each: full {ARCH}, "
        f"Nesterov, 1 step; the stacked W={world} step: "
        + timing_note(base))
    ranks = dist.run(dist_rank, world, "nccl", "cuda", DIST_TIMEOUT,
                     args=((("nccl", 1, "nesterov", "identity", {},
                             expect, None),), False), timing=True)
    for r, (runs, _) in enumerate(ranks):
        hold_run(torch, f"NCCL rank {r} of {world}", runs[0], base, 1)
        log(f"(a) NCCL rank {r} of {world}: launches "
            f"{ {k: v for k, v in runs[0]['launches'].items() if v} }, "
            f"losses and parameters bitwise equal to StackedComm({world})'s; "
            + timing_note(runs[0]))
    counted.append((f"nccl world {world}, rank 0", ranks[0][0][0]["launches"]))

    bases = {}
    for label, steps, rule, wire, pipe, expect in GLOO_BASES:
        bases[label] = main_path(torch, GLOO_W, steps, expect, rule, wire,
                                 pipeline=pipe, time_exchange=True)
        log(f"(b) stacked W={GLOO_W} {label}: " + timing_note(bases[label]))
    rows_want = exchange_rows(torch, StackedComm(GLOO_W), GLOO_W)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = dist.run(dist_rank, GLOO_W, "gloo", "cuda", DIST_TIMEOUT,
                     args=(tuple(p[:6] + (None,) for p in GLOO_PATHS),
                           True), timing=True)
    for i, (label, steps, rule, wire, pipe, expect, base_label) in \
            enumerate(GLOO_PATHS):
        for r, (runs, _) in enumerate(ranks):
            hold_run(torch, f"gloo rank {r} of {GLOO_W} {label}", runs[i],
                     bases[base_label], steps)
            log(f"(b) gloo rank {r} of {GLOO_W}, {label}: launches "
                f"{ {k: v for k, v in runs[i]['launches'].items() if v} } "
                f"as predicted; losses and parameters bitwise equal to the "
                f"stacked {base_label} path's over {steps} step(s); "
                + timing_note(runs[i]))
        counted.append((f"gloo W={GLOO_W} {label}, rank 0",
                        ranks[0][0][i]["launches"]))
    hold_rows(torch, GLOO_W, [rows for _, rows in ranks], rows_want)

    want = reduced_runs(torch, StackedComm(REDUCED_W), REDUCED_W)
    rows_want = exchange_rows(torch, StackedComm(REDUCED_W), REDUCED_W)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = dist.run(reduced_rank, REDUCED_W, "gloo", "cuda", DIST_TIMEOUT)
    for r, (got, _) in enumerate(ranks):
        for case, w in want.items():
            check(got[case]["losses"] == w["losses"]
                  and got[case]["params"] == w["params"],
                  f"(c) rank {r} of {REDUCED_W}, reduced {case}: losses "
                  f"or parameters differ from StackedComm({REDUCED_W})'s")
            check(got[case]["shards"] == {r: w["shards"][r]},
                  f"(c) rank {r} of {REDUCED_W}, reduced {case}: slots "
                  f"differ from the stacked shard's")
    log(f"(c) gloo, {REDUCED_W} processes on one card: reduced {ARCH} and "
        f"{SSM_ARCH}, {REDUCED_STEPS} steps each of "
        f"{len(want) // 2} cases (Nesterov, SGD, Adam x identity, int8 x "
        f"1, 2 windows): every rank's losses, parameters and slots bitwise "
        f"equal to StackedComm({REDUCED_W})'s")
    hold_rows(torch, REDUCED_W, [rows for _, rows in ranks], rows_want)
    return counted, bases


def sampled_step(torch, run: dict, i: int) -> float:
    """The largest change of a run's sampled parameters in step i."""
    before = run["init_print"] if i == 0 else run["prints"][i - 1]
    return max(float((a[3] - b[3]).abs().max())
               for a, b in zip(run["prints"][i], before))


def sampled_gap(torch, a: list, b: list) -> float:
    """The largest difference of two fingerprints' sampled parameters."""
    return max(float((x[3] - y[3]).abs().max()) for x, y in zip(a, b))


def strategy_phase(torch, runs: dict, count) -> None:
    """(d) PHub's rack deployment and its baselines, stacked: full
    llama3.2-1b, 4 workers, ``STRATEGY_PATHS``.  allreduce and
    centralized_ps equal the sharded_ps W=4 path bitwise; hierarchical 2 x
    2 stays within HIER_BOUND of its step after one step; its windowed,
    flat and chunk-ready modes equal it bitwise, and so does the DCN
    tier's windowed path its monolithic one."""
    from repro_torch.elastic import FaultEvent, FaultSchedule, NAN_PUSH
    base = runs["nesterov W=4"]
    for (label, steps, rule, wire, fields, expect, same, dead,
         poisoned) in STRATEGY_PATHS:
        faults = (FaultSchedule((FaultEvent(1, NAN_PUSH, poisoned,
                                            duration=2),), world=WORKERS)
                  if poisoned is not None else None)
        run = main_path(torch, WORKERS, steps, expect, rule, wire, faults,
                        pipeline=dict(fields), dead=dead, pods=PODS,
                        time_exchange=True)
        key = f"{rule} {label}"
        runs[key] = run
        count(key, run["launches"])
        note = timing_note(run)
        if same is not None:
            mono = runs[same]
            hold_run(torch, key, run, mono, steps)
            log(f"(d) {key}: losses and parameters bitwise equal to "
                f"{same}'s over {steps} step(s); " + note + "; "
                + timing_note(mono))
        elif key == "nesterov hierarchical 2x2":
            check(run["losses"][0] == base["losses"][0],
                  "hierarchical 2x2: step 0's loss differs")
            gap = sampled_gap(torch, run["prints"][0], base["prints"][0])
            step = sampled_step(torch, base, 0)
            check(0 < gap <= HIER_BOUND * step,
                  f"hierarchical 2x2 after one step: {gap} from the "
                  f"sharded_ps step, bound {HIER_BOUND} x {step}")
            rel = abs(run["losses"][1] - base["losses"][1]) / base[
                "losses"][1]
            check(rel <= HIER_BOUND, f"hierarchical 2x2 step 1's loss "
                                     f"differs by {rel} (relative)")
            log(f"(d) {key}: after one step its sampled parameters lie "
                f"{gap!r} from the sharded_ps W=4 step's, "
                f"{gap / step!r} of the step's largest change {step!r} "
                f"(bound {HIER_BOUND}); step 1's loss {rel!r} apart "
                f"(relative); " + note)
        else:
            log(f"(d) {key}: " + note)


def strategy_process_phases(torch, bases: dict, count) -> None:
    """(e) gloo, GLOO_W ranks on cuda:0 as 2 pods x 1, full llama3.2-1b
    in 64 KB chunks: allreduce and centralized_ps against the stacked W=2
    sharded_ps path, hierarchical and its int8 DCN tier against the
    stacked 2 x 1 paths, bitwise, each rank's launches exact, the
    collectives' calls, bytes and seconds by operation.  (f) gloo,
    REDUCED_W ranks as 2 pods x 2, reduced llama3.2-1b and rwkv6-3b."""
    from repro_torch.core import StackedComm
    from repro_torch.launch import dist

    for label, steps, rule, wire, pipe, expect in GLOO_STRATEGY_BASES:
        bases[label] = main_path(torch, GLOO_W, steps, expect, rule, wire,
                                 pipeline=pipe, pods=GLOO_W,
                                 time_exchange=True)
        log(f"(e) stacked {label}: " + timing_note(bases[label]))
    gc.collect()
    torch.cuda.empty_cache()
    paths = tuple(p[:7] for p in GLOO_STRATEGY_PATHS)
    ranks = dist.run(dist_rank, GLOO_W, "gloo", "cuda", DIST_TIMEOUT,
                     args=(paths, False), timing=True, pods=GLOO_W)
    for i, (label, steps, rule, wire, pipe, expect, want,
            base_label) in enumerate(GLOO_STRATEGY_PATHS):
        for r, (runs, _) in enumerate(ranks):
            run = runs[i]
            hold_run(torch, f"gloo rank {r} of {GLOO_W} {label}", run,
                     bases[base_label], steps)
            ops = ", ".join(
                f"{op} {st['calls']} calls {st['bytes']:,} B "
                f"{st['seconds'] * 1e3:.1f} ms"
                for op, st in sorted(run["stats"].items()) if st["calls"])
            log(f"(e) gloo rank {r} of {GLOO_W}, {label}: launches "
                f"{ {k: v for k, v in run['launches'].items() if v} } "
                f"as predicted; losses and parameters bitwise equal to "
                f"the stacked {base_label} path's over {steps} step(s); "
                + timing_note(run) + f"; collectives over the run: {ops}")
        count(f"gloo W={GLOO_W} {label}, rank 0",
              ranks[0][0][i]["launches"])

    want = reduced_strategy_runs(torch, StackedComm(REDUCED_W, PODS))
    gc.collect()
    torch.cuda.empty_cache()
    ranks = dist.run(reduced_strategy_rank, REDUCED_W, "gloo", "cuda",
                     DIST_TIMEOUT, pods=PODS)
    D = REDUCED_W // PODS
    for r, got in enumerate(ranks):
        q, d = divmod(r, D)
        for case, w in want.items():
            g = got[case]
            check(g["losses"] == w["losses"],
                  f"(f) rank {r}, reduced {case}: losses {g['losses']} "
                  f"differ from the stacked {w['losses']}")
            if case[1] == "allreduce":
                gap = max(float((a - b).abs().max())
                          for a, b in zip(g["params"], w["params"]))
                step = max(float((a - b).abs().max())
                           for a, b in zip(w["params"], w["init"]))
                check(gap <= ALLREDUCE_BOUND * step,
                      f"(f) rank {r}, reduced {case}: {gap} from the "
                      f"stacked step, bound {ALLREDUCE_BOUND} x {step}")
                log(f"(f) rank {r}, reduced {case}, one step: parameters "
                    f"{gap!r} from StackedComm's, {gap / step!r} of the "
                    f"step's largest change (bound {ALLREDUCE_BOUND})")
                continue
            check(g["params"] == w["params"],
                  f"(f) rank {r}, reduced {case}: parameters differ")
            for name, rows in w["slots"].items():
                if case[1] == "centralized_ps":
                    mine = rows if r == 0 else []
                elif name.endswith("wire_ef") and "DCN" in case[1]:
                    mine = [rows[q * D + d]]      # pod q's residual
                else:
                    mine = [rows[d]]
                check(g["slots"][name] == mine,
                      f"(f) rank {r}, reduced {case}: slot {name} differs "
                      f"from its stacked row")
    log(f"(f) gloo, {REDUCED_W} processes as {PODS} pods x {D} on one "
        f"card: reduced {ARCH} and {SSM_ARCH}, {REDUCED_STEPS} steps each "
        f"of {'; '.join(l for l, _ in REDUCED_STRATEGIES[:-1])}: every "
        f"rank's losses, parameters and slots bitwise equal to "
        f"StackedComm({REDUCED_W}, {PODS})'s; allreduce one step within "
        f"its bound")


def reduced_strategy_runs(torch, comm) -> dict:
    """The REDUCED_STRATEGIES on reduced configs over ``comm``: per (arch,
    label) the losses, a digest of every parameter (allreduce: the
    parameters before and after its one step, on the host) and {slot:
    digests of the rows this process keeps}."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.training import TrainState, fit

    out = {}
    for arch in (ARCH, SSM_ARCH):
        cfg = reduced(get_arch(arch))
        for label, fields in REDUCED_STRATEGIES:
            tc = TrainConfig(loss_chunk=REDUCED_SEQ,
                             chunk_size_bytes=REDUCED_CHUNK, **fields)
            engine = PHubEngine(cfg, tc, comm, device="cuda")
            model, opt = engine.init_state()
            steps = 1 if label == "allreduce" else REDUCED_STEPS
            init = [t.detach().to("cpu", copy=True)
                    for _, t in leaf_paths(model.param_tree())]
            data = SyntheticTokens(cfg, BATCH, REDUCED_SEQ, seed=0)
            state = fit(engine, TrainState(params=model, opt=opt), data,
                        steps=steps, log_every=0, hooks=[lambda s, m: None])
            params = [t.detach() for _, t in leaf_paths(model.param_tree())]
            out[(arch, label)] = {
                "losses": list(state.losses),
                "params": ([t.to("cpu", copy=True) for t in params]
                           if label == "allreduce"
                           else [digest(t) for t in params]),
                "init": init if label == "allreduce" else None,
                "slots": {f"{key}/{name}": [digest(row) for row in v]
                          for key, slots in state.opt.items()
                          for name, v in slots.items()}}
            del engine, model, opt, state
    return out


def reduced_strategy_rank(comm, device):
    """A spawned rank of phase (f)."""
    import torch
    return reduced_strategy_runs(torch, comm)


def launch_modules():
    from repro_torch.kernels import (agg_opt, decode_attn, quant, rwkv_scan,
                                     swa_attn)
    return (agg_opt, quant, swa_attn, decode_attn, rwkv_scan)


def reset_all_launches() -> None:
    for mod in launch_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in launch_modules():
        out.update(mod.LAUNCHES)
    return out


def allowed_pairs(T: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention over T tokens
    computes per head: key p' attended by p when p - window < p' <= p."""
    return sum(min(p + 1, window) if window > 0 else p + 1 for p in range(T))


def attention_bound(flops: float, n_bytes: float,
                    flops_per_s: float = F32_FLOPS_PER_S
                    ) -> tuple[float, str]:
    t_ops, t_bytes = flops / flops_per_s, n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ring_positions(torch, B: int, C: int, n_seen: int):
    """pos (B, C) int32 of a ring of C slots after n_seen tokens (slot s
    holds position p with p % C == s, the newest ones; -1 where none)."""
    s = torch.arange(C, dtype=torch.int32, device="cuda")
    if n_seen >= C:
        p = n_seen - 1 - ((n_seen - 1 - s) % C)
    else:
        p = torch.where(s < n_seen, s, -1)
    return p.expand(B, C).contiguous()


def swa_plain(q, k, v, window):
    """swa_attention's plain version in the model layout."""
    from repro_torch.kernels.swa_attn import swa_attention_ref
    return swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2),
                             window=window).transpose(1, 2)


def dec_plain(q, k, v, pos, qp, window):
    """decode_attention's plain version in the model layout."""
    from repro_torch.kernels.decode_attn import decode_attention_ref
    B, _, nh, hd = q.shape
    kv = k.shape[2]
    return decode_attention_ref(q.reshape(B, kv, nh // kv, hd), k, v,
                                pos, qp.reshape(B, 1),
                                window=window).reshape(B, 1, nh, hd)


def attention_at(torch, randn, arch: str, B: int, T: int, steps: int,
                 nh: int, kv: int, hd: int, w: int, C: int
                 ) -> tuple[dict, dict]:
    """swa_attention_kernel on a prefill of T tokens and
    decode_attention_kernel on the cache of C slots at the last of
    ``steps`` tokens, at (nh, kv, hd, window w): each within its tolerance
    of its plain version, timed beside its bound and SDPA.  Returns the
    two kernels-line entries."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.decode_attn.ops import split_len
    from repro_torch.kernels.swa_attn import swa_attention
    from repro_torch.kernels.swa_attn.ops import occupancy
    # --- prefill: f32 q/k/v as the path computes them
    q, k, v = randn(B, T, nh, hd), randn(B, T, kv, hd), randn(B, T, kv, hd)
    got = swa_attention(q, k, v, window=w)
    want = swa_plain(q, k, v, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = SWA_RTOL * max(1.0, float(want.abs().max()))
    del got, want
    check(err <= tol, f"swa_attention_kernel at {arch}'s shape: max_abs "
                      f"{err:.3e} > tol {tol:.3e}")
    ms = median_ms(torch, lambda: swa_attention(q, k, v, window=w), 10)
    plain_ms = median_ms(torch, lambda: swa_plain(q, k, v, w), 10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if w:
        p = torch.arange(T, device="cuda")
        mask = (p[None, :] <= p[:, None]) & (p[None, :] > p[:, None] - w)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        label = "SDPA, f32, boolean window mask, enable_gqa"
    else:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        label = "SDPA, f32, is_causal, enable_gqa"
    library_ms = median_ms(torch, sdpa, 10)
    pairs = allowed_pairs(T, w)
    flops = 4.0 * hd * pairs * B * nh
    n_bytes = 4 * (2 * B * T * nh * hd + 2 * B * T * kv * hd)
    simt_ms, _ = attention_bound(flops, n_bytes)
    bound_ms, bound_by = attention_bound(flops, n_bytes,
                                         flops_per_s=TF32_FLOPS_PER_S / 3)
    blocks = occupancy(hd)
    log(f"swa_attention_kernel {arch}: q ({B}, {T}, {nh}, {hd}) f32, "
        f"k/v {kv} heads, window {w}: max_abs {err:.3e} (tol "
        f"{tol:.3e}); kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} "
        f"TFLOP/s f32-equivalent, {3 * flops / ms / 1e9:.2f} TFLOP/s "
        f"TF32), bound {bound_ms:.3f} ms (3xTF32 {bound_by}, "
        f"{flops / 1e12:.3f} TFLOP of {pairs:,} pairs a head; "
        f"{100 * bound_ms / ms:.1f}% of it), f32 SIMT bound "
        f"{simt_ms:.3f} ms ({100 * simt_ms / ms:.1f}%), {blocks} "
        f"block(s) of 8 warps a SM, plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms ({label})")
    e = {"max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by,
         "bound_f32_simt_ms": simt_ms, "blocks_per_sm": blocks,
         "library_ms": library_ms, "library": label,
         "shape": f"B {B} T {T} nh {nh} kv {kv} hd {hd} window {w} f32"}
    swa_e = e
    del q, k, v, qt, kt, vt
    gc.collect()
    torch.cuda.empty_cache()

    # --- decode: the cache at the last decode step of the path
    n_seen = T + steps - 1
    q = randn(B, 1, nh, hd)
    k = randn(B, C, kv, hd, dtype=torch.bfloat16)
    v = randn(B, C, kv, hd, dtype=torch.bfloat16)
    pos = ring_positions(torch, B, C, n_seen)
    qp = torch.full((B,), n_seen - 1, dtype=torch.int32, device="cuda")
    got = decode_attention(q, k, v, pos, qp, window=w)
    want = dec_plain(q, k, v, pos, qp, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= DECODE_TOL, f"decode_attention_kernel at {arch}'s "
                             f"shape: max_abs {err:.3e}")
    check(torch.equal(decode_attention(q, k, v, pos, qp, window=w), got),
          f"decode_attention_kernel at {arch}'s shape: two calls differ")
    L = split_len(B, C, kv)
    n_split = -(-C // L)
    kernel = lambda: decode_attention(q, k, v, pos, qp,  # noqa: E731
                                      window=w)
    ms = graph_ms(torch, kernel, 10)
    wrapper_us = host_us(torch, kernel)
    plain_ms = graph_ms(torch, lambda: dec_plain(q, k, v, pos, qp, w),
                        10)
    valid = (pos >= 0) & (pos <= qp[:, None])
    if w:
        valid &= pos > qp[:, None] - w
    n_valid = int(valid.sum())
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.float().transpose(1, 2).contiguous() for t in (k, v))
    mask = valid[:, None, None, :]
    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)
    label = ("SDPA, f32 q on the cache converted to f32 beforehand, "
             "boolean position mask, enable_gqa")
    # k/v of the attended slots only (a hybrid's window layer reads the
    # window of a ring sized for its global layers), positions of all
    n_bytes = 2 * n_valid * kv * hd * 2 + 4 * B * C + 2 * 4 * B * nh * hd
    flops = 4.0 * hd * n_valid * nh     # each slot, every query head
    bound_ms, bound_by = attention_bound(flops, n_bytes)
    log(f"decode_attention_kernel {arch}: q ({B}, 1, {nh}, {hd}) f32, "
        f"cache ({B}, {C}, {kv}, {hd}) bf16, {n_valid:,} of {B * C:,} "
        f"slots attended, window {w}: max_abs {err:.3e} (tol "
        f"{DECODE_TOL:.0e}), two calls bitwise equal; kernel "
        f"{ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s; {n_split} splits "
        f"of {L} slots, {n_split * kv * B} blocks on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs; {100 * bound_ms / ms:.1f}% of the bound; the wrapper "
        f"{wrapper_us:.1f} us of host time a call), bound "
        f"{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.2f} MB), plain "
        f"{plain_ms:.3f} ms, library {library_ms:.4f} ms ({label}); "
        f"kernel, plain and library timed as CUDA graphs of 20 calls")
    e = {"max_abs_err": err, "tol": DECODE_TOL, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": library_ms,
         "library": label, "splits": n_split, "split_slots": L,
         "timing": "CUDA graph of 20 calls, median of 10 replays",
         "wrapper_host_us": wrapper_us,
         "shape": f"B {B} C {C} nh {nh} kv {kv} hd {hd} window {w}, "
                  f"bf16 cache, f32 q"}
    dec_e = e
    del q, k, v, pos, qt, kt, vt, mask
    gc.collect()
    torch.cuda.empty_cache()
    return swa_e, dec_e


def attention_kernel_phase(torch) -> dict:
    """swa_attention_kernel and decode_attention_kernel at the serving
    paths' shapes against their plain versions, within a tolerance; times
    of kernel, plain version, bound and SDPA; the small edge cases.
    Returns the kernels-line entries (llama's shape at the top, danube's
    under "danube")."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.decode_attn.ops import split_len
    from repro_torch.kernels.swa_attn import swa_attention
    from repro_torch.models import cache_capacity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    out = {name: {"name": name, "route": "cuda", "source": src,
                  "replaces": REPLACES[name], "launches": 0}
           for name, src in (("swa_attention_kernel", SWA_SOURCE),
                             ("decode_attention_kernel", DECODE_SOURCE))}
    out["swa_attention_kernel"]["design"] = (
        "3xTF32 on the tensor cores (mma.sync m16n8k8), f32 accuracy")
    log("swa_attention_kernel design: 3xTF32 on the tensor cores "
        "(mma.sync.m16n8k8 tf32, three products a product); bound_ms is "
        "3x its flops at 495 TFLOP/s TF32, bound_f32_simt_ms its flops at "
        "67 TFLOP/s f32")
    for arch, B, T, steps in SERVE_PATHS:
        cfg = get_arch(arch)
        swa_e, dec_e = attention_at(
            torch, randn, arch, B, T, steps, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.sliding_window, cache_capacity(cfg, T + steps))
        if arch == SERVE_PATHS[0][0]:
            out["swa_attention_kernel"].update(swa_e)
            out["decode_attention_kernel"].update(dec_e)
        else:
            out["swa_attention_kernel"]["danube"] = swa_e
            out["decode_attention_kernel"]["danube"] = dec_e

    # edge cases, small: (T, nh, kv, hd, window, dtype); T not a multiple
    # of the 128-row q tile or the 64-key tile, window 1, hd 32 / 64 / 120 /
    # 128, bf16, and windows of 40 and 70 (q tiles whose warps straddle the
    # diagonal and the window's edge in one key tile)
    worst = []
    for T, nh, kv, hd, w, dt in ((100, 4, 2, 64, 0, torch.float32),
                                 (300, 4, 2, 120, 100, torch.float32),
                                 (257, 32, 8, 120, 64, torch.bfloat16),
                                 (128, 8, 1, 32, 0, torch.bfloat16),
                                 (65, 32, 8, 64, 1, torch.float32),
                                 (300, 4, 2, 128, 40, torch.float32),
                                 (129, 4, 2, 32, 1, torch.float32),
                                 (200, 8, 2, 120, 1, torch.bfloat16),
                                 (333, 4, 2, 64, 70, torch.bfloat16)):
        q = randn(2, T, nh, hd, dtype=dt)
        k, v = randn(2, T, kv, hd, dtype=dt), randn(2, T, kv, hd, dtype=dt)
        got, want = swa_attention(q, k, v, window=w), swa_plain(q, k, v, w)
        err = float((got.float() - want.float()).abs().max())
        tol = (SWA_RTOL * max(1.0, float(want.float().abs().max()))
               if dt == torch.float32 else BF16_TOL)
        worst.append(("swa", T, nh, kv, hd, w, str(dt), err, tol))
        check(got.dtype == dt and err <= tol,
              f"swa edge case T {T} hd {hd} window {w} {dt}: {err:.3e}")
    # (B, S, nh, kv, hd, window, q dtype, cache dtype, empty leading
    # slots): B 1, C below one split, C 4096 with window 300 (most splits
    # wholly outside it), 1500 empty leading slots (whole splits empty);
    # each call twice (bitwise), and the cache rolled by 37 slots (the
    # ring's rotation) within 1e-5 of the unrolled answer
    for B, S, nh, kv, hd, w, qdt, kdt, lead in (
            (2, 640, 8, 2, 64, 0, torch.float32, torch.bfloat16, 200),
            (2, 640, 8, 2, 64, 300, torch.float32, torch.bfloat16, 200),
            (2, 700, 32, 8, 120, 500, torch.float32, torch.bfloat16, 0),
            (2, 300, 4, 2, 64, 100, torch.float32, torch.float32, 0),
            (2, 513, 32, 8, 128, 0, torch.bfloat16, torch.bfloat16, 64),
            (1, 40, 4, 2, 64, 0, torch.float32, torch.bfloat16, 0),
            (1, 50, 32, 8, 120, 0, torch.bfloat16, torch.bfloat16, 0),
            (2, 4096, 32, 8, 120, 300, torch.float32, torch.bfloat16, 0),
            (1, 4096, 32, 8, 120, 0, torch.float32, torch.bfloat16, 1500),
            (1, 3000, 8, 1, 128, 1000, torch.float32, torch.float32, 0)):
        q = randn(B, 1, nh, hd, dtype=qdt)
        k, v = randn(B, S, kv, hd, dtype=kdt), randn(B, S, kv, hd, dtype=kdt)
        pos = ring_positions(torch, B, S, S).clone()
        pos[:, :lead] = -1
        qp = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        got = decode_attention(q, k, v, pos, qp, window=w)
        want = dec_plain(q, k, v, pos, qp, w)
        err = float((got.float() - want.float()).abs().max())
        tol = DECODE_TOL if qdt == torch.float32 else BF16_TOL
        L = split_len(B, S, kv)
        worst.append(("decode", B, S, nh, kv, hd, w,
                      f"{qdt}/{kdt} lead {lead}, {-(-S // L)} splits of {L}",
                      err, tol))
        again = decode_attention(q, k, v, pos, qp, window=w)
        rolled = decode_attention(
            q, *(torch.roll(t, 37, dims=1).contiguous() for t in (k, v, pos)),
            qp, window=w)
        roll_err = float((rolled.float() - got.float()).abs().max())
        check(got.dtype == qdt and bool(torch.isfinite(got).all())
              and err <= tol and torch.equal(again, got)
              and roll_err <= (1e-5 if qdt == torch.float32 else BF16_TOL),
              f"decode edge case B {B} S {S} hd {hd} window {w} lead "
              f"{lead}: {err:.3e}, rolled {roll_err:.3e}, bitwise "
              f"{torch.equal(again, got)}")
    for case in worst:
        log(f"  edge case {case[0]} {case[1:-2]}: max_abs {case[-2]:.3e} "
            f"(tol {case[-1]:.0e})")
    return out


def rwkv_inputs(torch, B: int, T: int, H: int, seed: int, *,
                dtype=None, zero_state: bool = False, w_value=None,
                mixed: bool = False):
    """r, k, v ~ N(0, 0.5); the model's decay exp(-exp(w0 + N(0, 0.5))),
    w0 spread over [-6, -4.5] as rwkv6-3b's init (or a uniform
    ``w_value``; ``mixed``: 0.1 on channels 0-31 and the model's decay on
    the rest); u ~ N(0, 0.5); a state ~ N(0, 0.3) or zero.  On the card,
    r/k/v/w in ``dtype`` (f32 by default)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    r, k, v = (randn(B, T, H, 64) * 0.5 for _ in range(3))
    if w_value is None:
        w0 = torch.linspace(-6.0, -4.5, H * 64, device="cuda").reshape(H, 64)
        w = torch.exp(-torch.exp(w0 + randn(B, T, H, 64) * 0.5))
    else:
        w = torch.full((B, T, H, 64), w_value, device="cuda")
    if mixed:
        w[..., :32] = 0.1
    u = randn(H, 64) * 0.5
    S = (torch.zeros(B, H, 64, 64, device="cuda") if zero_state
         else randn(B, H, 64, 64) * 0.3)
    dt = dtype or torch.float32
    return (*(x.to(dt) for x in (r, k, v, w)), u, S)


def rwkv_work(B: int, T: int, H: int, hd: int, itemsize: int
              ) -> tuple[float, float]:
    """(flops, bytes) of the chunked scan on these inputs: per (b, h) and
    chunk of n rows, the strict triangles of rq kd^T and att v (n(n-1)/2
    pairs, 2 hd each), rq S and kd^T v (2 n hd^2 each), a_last * S and its
    sum (2 hd^2) and ten elementwise operations a row and channel; each
    input read once (r, k, v, w, u, the state) and y and the state written
    once."""
    flops = 0.0
    for c0 in range(0, T, 64):
        n = min(64, T - c0)
        flops += (2 * hd * n * (n - 1) + 4 * n * hd * hd + 2 * hd * hd
                  + 10 * n * hd)
    flops *= B * H
    n_bytes = (5 * B * T * H * hd * itemsize + 4 * H * hd
               + 2 * 4 * B * H * hd * hd)
    return flops, n_bytes


def rwkv_kernel_phase(torch) -> dict:
    """rwkv_scan_kernel at the serving path's shape (B 8, T 2048, 40 heads
    of 64, f32, from a zero and from a nonzero state) against its plain
    version within RWKV_TOL * max(1, max|want|); timed beside the plain
    version and the bound (no single PyTorch call computes this function:
    library_ms null), with its GB/s and share of the bound, its ptxas
    registers and spills, its grid and blocks resident on an SM; two calls
    at the serving shape compared bitwise.  Edge cases: T 1, 40 and 100
    (ragged chunks), bf16 inputs, and a uniform decay of 0.3 (finite) and
    0.1 (the chunked form's cumulative decay underflows: inf and NaN in the
    same places as the plain version, the finite entries within
    tolerance); then T 64, 128 and 2048 at B 1 and H 1 (f32 and bf16) and a
    mixed decay (0.1 on channels 0-31, the model's on the rest: finite and
    inf kd in one chunk)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv_scan import rwkv_scan, rwkv_scan_ref
    from repro_torch.kernels.rwkv_scan.ops import launch_shape

    arch, B, T, _ = SSM_SERVE_PATH
    H = get_arch(arch).n_heads

    def err(got, want):
        """(max |got - want|, max(1, max |want|)); (0, 1) when empty."""
        if want.numel() == 0:
            return 0.0, 1.0
        return (float((got.float() - want.float()).abs().max()),
                max(1.0, float(want.float().abs().max())))

    entry = {"name": "rwkv_scan_kernel", "route": "cuda",
             "source": RWKV_SOURCE, "replaces": REPLACES["rwkv_scan_kernel"],
             "launches": 0}
    worst = 0.0
    for zero in (True, False):
        inputs = rwkv_inputs(torch, B, T, H, seed=11 + zero, zero_state=zero)
        y, s = rwkv_scan(*inputs)
        want_y, want_s = rwkv_scan_ref(*inputs)
        torch.cuda.synchronize()
        (ey, sy), (es, ss) = err(y, want_y), err(s, want_s)
        check(ey <= RWKV_TOL * sy and es <= RWKV_TOL * ss,
              f"rwkv_scan_kernel at the serving shape (zero state {zero}): "
              f"y {ey:.3e} / scale {sy:.3e}, state {es:.3e} / {ss:.3e}")
        log(f"rwkv_scan_kernel ({B}, {T}, {H}, 64) f32, "
            f"{'zero' if zero else 'nonzero'} state: max_abs y {ey:.3e} "
            f"(max|y| {sy:.3e}), state {es:.3e} (max|S| {ss:.3e}); tol "
            f"{RWKV_TOL:.0e} * max(1, max|want|)")
        worst = max(worst, ey, es)
        del y, s, want_y, want_s
    y, s = rwkv_scan(*inputs)
    y2, s2 = rwkv_scan(*inputs)
    bitwise = torch.equal(y, y2) and torch.equal(s, s2)
    log(f"rwkv_scan_kernel: two calls at the serving shape bitwise equal "
        f"{bitwise}")
    check(bitwise, "rwkv_scan_kernel: two calls at the serving shape differ")
    del y, s, y2, s2
    ms = median_ms(torch, lambda: rwkv_scan(*inputs), 10)
    plain_ms = median_ms(torch, lambda: rwkv_scan_ref(*inputs), 10)
    flops, n_bytes = rwkv_work(B, T, H, 64, 4)
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"rwkv_scan_kernel: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} "
        f"TFLOP/s, {n_bytes / ms / 1e6:.1f} GB/s), bound {bound_ms:.3f} ms "
        f"({bound_by}: {flops / 1e9:.2f} GFLOP f32 at 67 TFLOP/s = "
        f"{t_ops * 1e3:.3f} ms, {n_bytes / 1e9:.3f} GB at 3.35 TB/s = "
        f"{t_bytes * 1e3:.3f} ms), plain {plain_ms:.3f} ms, library: none "
        f"(no single PyTorch call computes the scan)")
    shape = launch_shape(B, H, torch.float32)
    ptxas = [line.strip() for line in
             _build.library_path("rwkv_scan").with_suffix(".log")
             .read_text().splitlines()
             if "registers" in line or "spill" in line]
    log(f"rwkv_scan_kernel: {n_bytes / ms / 1e6:.1f} GB/s, "
        f"{100 * bound_ms / ms:.1f}% of its bound; grid {shape['grid']}, "
        f"{shape['threads']} threads and {shape['smem_bytes']} bytes of "
        f"shared memory a block, {shape['blocks_per_sm']} block(s) "
        f"resident an SM; ptxas: {' | '.join(ptxas)}")
    entry.update(gb_per_s=n_bytes / ms / 1e6, bound_share=bound_ms / ms,
                 grid=list(shape["grid"]), threads=shape["threads"],
                 smem_bytes=shape["smem_bytes"],
                 blocks_per_sm=shape["blocks_per_sm"], ptxas=ptxas,
                 bitwise_repeat=bitwise)
    entry.update(max_abs_err=worst, tol=RWKV_TOL, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 library="none: no single PyTorch call computes the scan",
                 shape=f"B {B} T {T} H {H} hd 64 f32, zero and nonzero "
                       f"state")
    del inputs
    gc.collect()
    torch.cuda.empty_cache()

    # edge cases: (B, T, H, dtype, uniform decay or None)
    for b, t, h, dt, wv in ((2, 1, H, torch.float32, None),
                            (2, 40, H, torch.float32, None),
                            (2, 100, H, torch.float32, None),
                            (3, 257, 5, torch.float32, None),
                            (2, 100, H, torch.bfloat16, None),
                            (2, 130, 4, torch.float32, 0.3),
                            (2, 130, 4, torch.float32, 0.1)):
        inputs = rwkv_inputs(torch, b, t, h, seed=b * t + h, dtype=dt,
                             w_value=wv)
        y, s = rwkv_scan(*inputs)
        want_y, want_s = rwkv_scan_ref(*inputs)
        same = all(torch.equal(torch.isnan(g), torch.isnan(w_))
                   and torch.equal(torch.isinf(g), torch.isinf(w_))
                   for g, w_ in ((y, want_y), (s, want_s)))
        fin_y, fin_s = torch.isfinite(want_y), torch.isfinite(want_s)
        (ey, sy), (es, ss) = (err(y[fin_y], want_y[fin_y]),
                              err(s[fin_s], want_s[fin_s]))
        tol_y = RWKV_TOL if dt == torch.float32 else RWKV_BF16_TOL
        n_bad = int((~fin_y).sum())
        log(f"  edge case rwkv_scan ({b}, {t}, {h}, 64) {dt}, decay "
            f"{wv or 'model'}: max_abs y {ey:.3e} (tol {tol_y:.0e} * "
            f"{sy:.2e}), state {es:.3e}; non-finite y {n_bad} of "
            f"{y.numel()}, same places {same}")
        check(same and y.dtype == dt and ey <= tol_y * sy
              and es <= RWKV_TOL * ss,
              f"rwkv_scan edge case T {t} {dt} decay {wv}")
        check((n_bad == 0) == (wv is None or wv >= 0.3),
              f"rwkv_scan edge case T {t} decay {wv}: {n_bad} non-finite")

    # more edge cases: (B, T, H, dtype, mixed decay)
    for b, t, h, dt, mixed in ((1, 64, 1, torch.float32, False),
                               (1, 128, 1, torch.float32, False),
                               (1, 2048, 1, torch.float32, False),
                               (1, 64, 1, torch.bfloat16, False),
                               (1, 128, 1, torch.bfloat16, False),
                               (1, 2048, 1, torch.bfloat16, False),
                               (2, 130, 4, torch.float32, True),
                               (2, 2048, 4, torch.float32, True)):
        inputs = rwkv_inputs(torch, b, t, h, seed=b * t + h + 1, dtype=dt,
                             mixed=mixed)
        y, s = rwkv_scan(*inputs)
        want_y, want_s = rwkv_scan_ref(*inputs)
        same = all(torch.equal(torch.isnan(g), torch.isnan(w_))
                   and torch.equal(torch.isinf(g), torch.isinf(w_))
                   for g, w_ in ((y, want_y), (s, want_s)))
        fin_y, fin_s = torch.isfinite(want_y), torch.isfinite(want_s)
        (ey, sy), (es, ss) = (err(y[fin_y], want_y[fin_y]),
                              err(s[fin_s], want_s[fin_s]))
        tol_y = RWKV_TOL if dt == torch.float32 else RWKV_BF16_TOL
        n_bad = int((~fin_y).sum())
        log(f"  edge case rwkv_scan ({b}, {t}, {h}, 64) {dt}, decay "
            f"{'mixed' if mixed else 'model'}: max_abs y {ey:.3e} (tol "
            f"{tol_y:.0e} * {sy:.2e}), state {es:.3e}; non-finite y "
            f"{n_bad} of {y.numel()}, same places {same}")
        check(same and y.dtype == dt and ey <= tol_y * sy
              and es <= RWKV_TOL * ss,
              f"rwkv_scan edge case T {t} {dt} mixed {mixed}")
        check((n_bad > 0) == mixed and bool(fin_y.any()),
              f"rwkv_scan edge case T {t} mixed {mixed}: {n_bad} non-finite")
    return {"rwkv_scan_kernel": entry}


def serve_reference_phase(torch, arch: str, prompt: int, steps: int = 4
                          ) -> None:
    """Reduced ``arch``: prefill and ``steps`` teacher-forced decode steps
    on the card (kernels) and on the CPU (plain versions), one parameter
    tree; the last position's logits within SERVE_TOL of their largest
    entry at every step (bf16 activations: a residual entry near a bf16
    rounding boundary can round the other way on the other device, 2^-8
    relative; the CPU parity tests measure 8.9e-4 against the reference)."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM

    cfg = reduced(get_arch(arch))
    eng_c = PHubEngine(cfg, TrainConfig(), StackedComm(1), device="cpu")
    eng_g = PHubEngine(cfg, TrainConfig(), StackedComm(1), device="cuda")
    model_c = eng_c.init_model(seed=0)
    model_g = DecoderLM(cfg, device="cuda",
                        params=tree_to(model_c.param_tree(), "cuda"))
    tok = torch.from_numpy(SyntheticTokens(cfg, 2, prompt + steps, seed=7)
                           .batch_at(0)["tokens"]).long()

    def run(engine, model, device):
        """Logits of the prefill and of each decode step, and the cache."""
        logits, cache = engine.make_prefill_step(prompt, steps)(
            model, tok[:, :prompt].to(device))
        out = [logits.cpu()]
        step = engine.make_serve_step()
        for i in range(steps):
            logits, cache = step(model, cache,
                                 tok[:, prompt + i:prompt + i + 1].to(device))
            out.append(logits.cpu())
        return out, cache

    want, cache_c = run(eng_c, model_c, "cpu")
    reset_all_launches()
    got, cache_g = run(eng_g, model_g, "cuda")
    launches = all_launches()
    rels = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    L = cfg.n_layers
    if cfg.attn_free:
        # the state cache: the dtypes the reference's holds after prefill
        dt = {"S": torch.float32, "x_prev_att": getattr(torch, cfg.dtype),
              "x_prev_ffn": torch.float32}
        same_cache = all(cache_g[n].dtype == cache_c[n].dtype == d
                         for n, d in dt.items())
        s_rel = float((cache_g["S"].cpu() - cache_c["S"]).abs().max()
                      / cache_c["S"].abs().max())
        names = [str(cache_g[n].dtype) for n in dt]
        cache_note = (f"state cache dtypes {names} as expected "
                      f"{same_cache}, S card vs CPU "
                      f"{s_rel:.3e}; card launches rwkv_scan "
                      f"{launches['rwkv_scan_kernel']}")
        expect = {"rwkv_scan_kernel": L}
    else:
        C = cache_g["k"].shape[2]
        same_cache = torch.equal(cache_g["pos"].cpu(), cache_c["pos"])
        cache_note = (f"C {C}; cache pos equal {same_cache}; card launches "
                      f"swa {launches['swa_attention_kernel']} decode "
                      f"{launches['decode_attention_kernel']}")
        expect = {"swa_attention_kernel": L,
                  "decode_attention_kernel": L * steps}
    log(f"reduced {arch} serving (d_model {cfg.d_model}, {L} layers, window "
        f"{cfg.sliding_window}, prompt {prompt}), card vs CPU: max |dlogits| "
        f"/ max |logits| prefill {rels[0]:.3e}, decode "
        f"{', '.join(f'{r:.3e}' for r in rels[1:])}; {cache_note}")
    check(max(rels) <= SERVE_TOL, f"reduced {arch} serving: card vs CPU "
                                  f"{max(rels):.3e} > {SERVE_TOL}")
    check(same_cache, f"reduced {arch} serving: cache {cache_note}")
    for name, count in launches.items():
        check(count == expect.get(name, 0),
              f"reduced {arch} serving launches {launches}")


def serve_path(torch, arch: str, batch: int, prompt: int, steps: int,
               layers: int = 0) -> dict:
    """The serving main path at full width (and depth, unless ``layers``
    cuts it) through launch.serve.generate: greedy, ``steps`` tokens (the
    prefill's and ``steps - 1`` decode steps); a frontend architecture's
    prompt follows its prefix of seed-drawn embeddings
    (``data.frontend_embeds``).  Checks finite logits, exact launches (L
    in the prefill, L a decode step, every other kernel 0) and that a
    second greedy run gives the same tokens and logits.  Returns the first
    run's launch counts."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens, frontend_embeds
    from repro_torch.launch.serve import generate
    from repro_torch.models import cache_capacity

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    engine = PHubEngine(cfg, TrainConfig(), StackedComm(1), device="cuda")
    model = engine.init_model(seed=0)
    prompts = torch.from_numpy(SyntheticTokens(cfg, batch, prompt, seed=7)
                               .batch_at(0)["tokens"]).to("cuda",
                                                          torch.int64)
    extra, F = None, 0
    if cfg.frontend:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        extra = frontend_embeds(cfg, batch, generator=gen, device="cuda")
        F = cfg.frontend_tokens
    C = cache_capacity(cfg, F + prompt + steps)
    if cfg.attn_free:
        n_tree = sum(p.numel() for p in model.parameters())
        state = (cfg.n_layers * batch * cfg.n_heads * cfg.hd ** 2 * 4
                 + cfg.n_layers * batch * cfg.d_model * (2 + 4))
        cache_note = (f"{n_tree:,} in the tree ({n_tree * 4 / 1e9:.2f} GB "
                      f"f32); state cache {state / 1e6:.1f} MB")
    else:
        cache_note = (f"cache {C} slots a layer"
                      + (" (prompt > window: the ring's roll branch, decode "
                         "evicts)" if prompt >= C else ""))
    log(f"serve {arch}: {cfg.n_params():,} params, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, window {cfg.sliding_window}; batch {batch}, "
        f"{f'a prefix of {F} frontend embeddings, ' if F else ''}"
        f"prompt {prompt}, {steps} greedy tokens ({steps - 1} decode steps), "
        f"{cache_note}")
    runs = []
    for run in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        res = generate(engine, model, prompts, steps, greedy=True,
                       extra_embeds=extra)
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_dec = steps - 1
        log(f"  run {run}: prefill {res['prefill_s'] * 1e3:.1f} ms "
            f"({batch * (F + prompt) / res['prefill_s']:,.0f} tok/s); decode "
            f"{n_dec} steps in {res['decode_s'] * 1e3:.1f} ms "
            f"({res['decode_s'] * 1e3 / n_dec:.2f} ms/step, "
            f"{batch * n_dec / res['decode_s']:,.0f} tok/s); peak "
            f"{peak:.2f} GiB; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        runs.append((res, launches))
    (a, launches), (b, _) = runs
    L = cfg.n_layers
    if cfg.attn_free:
        # the prefill's scan once a layer; decode is plain recurrence steps
        want = {"rwkv_scan_kernel": L}
        per_step = "0 a decode step"
        reset_all_launches()
        logits, cache = engine.make_prefill_step(prompt, steps)(model,
                                                                prompts)
        in_prefill = all_launches()
        reset_all_launches()
        engine.make_serve_step()(model, cache, logits.argmax(-1)[:, None])
        in_step = all_launches()
        torch.cuda.synchronize()
        log(f"  serve {arch}: a prefill alone launched "
            f"{ {k: v for k, v in in_prefill.items() if v} }, a decode step "
            f"alone {sum(in_step.values())} kernels")
        check(in_prefill == {**{k: 0 for k in in_prefill},
                             "rwkv_scan_kernel": L}
              and not any(in_step.values()),
              f"serve {arch}: prefill {in_prefill}, decode step {in_step}")
        del logits, cache
    else:
        want = {"swa_attention_kernel": L,
                "decode_attention_kernel": L * (steps - 1)}
        per_step = f"{L} a step"
    for name, count in launches.items():
        check(count == want.get(name, 0), f"{name} launched {count} times on "
                                          f"the serve {arch} path, want "
                                          f"{want.get(name, 0)}")
    check(bool(torch.isfinite(a["first_logits"]).all()
               and torch.isfinite(a["last_logits"]).all()),
          "non-finite logits")
    check(tuple(a["tokens"].shape) == (batch, steps), "token shape")
    same = (torch.equal(a["tokens"], b["tokens"])
            and torch.equal(a["last_logits"], b["last_logits"]))
    log(f"  serve {arch}: launches as expected ({L} + {per_step}), logits "
        f"finite, second greedy run equal (tokens and logits): {same}; "
        f"tokens[0][:8] {a['tokens'][0, :8].tolist()}")
    check(same, "greedy serving is not deterministic")
    del model, engine, runs, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def expect_launches(launches: dict, expect: dict, steps: int,
                    label: str) -> None:
    """Every kernel launched ``expect[name] * steps`` times, every other
    one 0."""
    for name, count in launches.items():
        want = expect.get(name, 0) * steps
        check(count == want, f"{label}: {name} launched {count} times, "
                             f"want {want}")


def client_model(torch, tc, arch: str = ARCH):
    """The full ``arch`` as a user's ``nn.Module``: weights drawn from
    ``tc.seed`` on the card, as ``PHubEngine.init_model`` draws them."""
    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(tc.seed)
    return DecoderLM(get_arch(arch), device="cuda", generator=gen)


def worker_grads(torch, model, tc, tokens, labels):
    """One worker's loss and gradients, as an external loop takes them:
    the module's forward, ``chunked_cross_entropy``, ``autograd.grad``."""
    from repro_torch.models import chunked_cross_entropy
    params = [p for _, p in model.named_parameters()]
    x = model(tokens, remat=tc.remat)
    loss = chunked_cross_entropy(x, model.lm_head_weight(), labels,
                                 chunk=tc.loss_chunk)
    return loss.detach(), torch.autograd.grad(loss, params)


def client_path(torch, label: str, steps: int, fields: dict, pods: int,
                flat: bool, dead, expect: dict, workers: int = WORKERS
                ) -> dict:
    """The external loop on the stacked Comm: full llama3.2-1b as a plain
    ``nn.Module``, each worker's forward and backward on its slice of the
    batch, the push stacked by the caller, and only ``PHubClient``:
    ``push_pull`` (tree mode: the caller's ``(W, *leaf)`` push tree, the
    parameters written in place) or ``push_pull_flat`` (the caller's own
    ``(W, padded)`` rows, each worker's gradients flattened into its row,
    and the parameters views of the flat store).  Returns the losses, the
    parameters' fingerprint after every step, per-worker losses, step ms,
    peak GiB and the launches."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubClient, StackedComm, module_tree, nest
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.elastic import Membership

    tc = TrainConfig(loss_chunk=min(1024, SEQ), **fields)
    model = client_model(torch, tc)
    client = PHubClient(tc, StackedComm(workers, pods),
                        device="cuda").register(module_tree(model))
    if dead is not None:
        client.set_membership(Membership.full(workers).leave(dead))
    opt = client.init_state()
    names = [n for n, _ in model.named_parameters()]

    def adopt(store):
        views = dict(leaf_paths(client.unflatten(store)))
        with torch.no_grad():
            for path, p in leaf_paths(module_tree(model)):
                p.data = views[path]

    if flat:
        pstore = client.flatten(module_tree(model))
        adopt(pstore)
        gstore = {k: torch.zeros((workers,) + v.shape, device="cuda")
                  for k, v in pstore.items()}
    else:
        push = {n: torch.empty((workers,) + p.shape, device="cuda")
                for n, p in model.named_parameters()}
        grads_tree = nest(push.items())
    data = SyntheticTokens(model.cfg, BATCH, SEQ, seed=tc.seed)
    bw = BATCH // workers
    losses, worker_losses, prints, step_ms, peaks = [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = data.torch_batch(i, "cuda")
        ls = []
        for w in range(workers):
            sl = slice(w * bw, (w + 1) * bw)
            loss, grads = worker_grads(torch, model, tc,
                                       batch["tokens"][sl],
                                       batch["labels"][sl])
            if flat:
                client.flatten(nest(zip(names, grads)),
                               out={k: v[w] for k, v in gstore.items()})
            else:
                for n, g in zip(names, grads):
                    push[n][w].copy_(g)
            del grads
            ls.append(loss)
        if flat:
            pstore, opt = client.push_pull_flat(gstore, pstore, opt)
            adopt(pstore)
        else:
            _, opt = client.push_pull(grads_tree, module_tree(model), opt)
        losses.append(float(torch.stack(ls).mean()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        worker_losses.append([float(x) for x in ls])
        prints.append(fingerprint(torch, model))
        log(f"(g) client {label} step {i}: loss {losses[-1]!r}  "
            f"{step_ms[-1]:.1f} ms  "
            f"{BATCH * SEQ / (step_ms[-1] / 1e3):,.0f} tokens/s  peak "
            f"{peaks[-1]:.2f} GiB")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches = all_launches()
    expect_launches(launches, expect, steps, f"client {label}")
    del model, client, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "worker_losses": worker_losses,
            "prints": prints, "step_ms": step_ms, "peak_gib": peaks,
            "launches": launches}


def client_one_worker(torch, rule: str) -> dict:
    """(g) W=1, full width: one worker's gradients on the whole batch,
    ``push_pull`` against the tree-level ``make_optimizer`` update on the
    same gradients: Nesterov and SGD bitwise (every leaf), Adam within
    CLIENT_ADAM_ATOL.  The client's step (forward, backward, push_pull)
    is timed; the reference update runs after it, on a copy of the
    parameters taken before it."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubClient, StackedComm, module_tree, nest
    from repro_torch.data import SyntheticTokens
    from repro_torch.optim import make_optimizer

    lr = {"adam": ADAM_LR, "sgd": SGD_LR}.get(rule)
    tc = TrainConfig(loss_chunk=min(1024, SEQ), optimizer=rule,
                     adam_eps=CLIENT_ADAM_EPS, **({"lr": lr} if lr else {}))
    model = client_model(torch, tc)
    names = [n for n, _ in model.named_parameters()]
    p0 = nest((n, p.detach().clone()) for n, p in model.named_parameters())
    client = PHubClient(tc, StackedComm(1), device="cuda").register(
        module_tree(model))
    opt = client.init_state()
    batch = SyntheticTokens(model.cfg, BATCH, SEQ, seed=tc.seed
                            ).torch_batch(0, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    loss, grads = worker_grads(torch, model, tc, batch["tokens"],
                               batch["labels"])
    _, opt = client.push_pull(nest(zip(names, (g[None] for g in grads))),
                              module_tree(model), opt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = all_launches()
    del opt, client
    gc.collect()
    init, update = make_optimizer(tc)
    ref, _ = update(p0, nest(zip(names, grads)), init(p0))
    del grads, p0
    from repro_torch.core.chunking import leaf_paths
    got = dict(leaf_paths(module_tree(model)))
    gap = 0.0
    for path, want in leaf_paths(ref):
        if rule == "adam":
            gap = max(gap, float((got[path].detach() - want).abs().max()))
        else:
            check(torch.equal(got[path], want),
                  f"(g) client W=1 {rule}: {path} differs from "
                  f"make_optimizer's update")
    if rule == "adam":
        check(gap <= CLIENT_ADAM_ATOL,
              f"(g) client W=1 adam: {gap} from make_optimizer's update, "
              f"bound {CLIENT_ADAM_ATOL}")
    print_after = fingerprint(torch, model)
    log(f"(g) client W=1 {rule}: loss {float(loss)!r}  {ms:.1f} ms  "
        f"{BATCH * SEQ / (ms / 1e3):,.0f} tokens/s  peak {peak:.2f} GiB "
        f"(with the reference's copy of the parameters, 4.60 GiB); "
        + (f"{gap!r} from make_optimizer's update (bound "
           f"{CLIENT_ADAM_ATOL})" if rule == "adam" else
           "every leaf bitwise equal to make_optimizer's update"))
    del model, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": [float(loss)], "prints": [print_after],
            "step_ms": [ms], "peak_gib": [peak], "launches": launches}


def client_rank(comm, device):
    """(h) a spawned rank: its own slice of the batch through the full
    model, the (1, *leaf) push, ``PHubClient`` over its
    ``ProcessGroupComm``, CLIENT_GLOO_STEPS steps.  Returns per step its
    loss, the fingerprint, step ms (and the forward/backward's and
    push_pull's parts, and the collectives' ms) and peak GiB, and its
    launches."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubClient, module_tree, nest
    from repro_torch.data import SyntheticTokens

    tc = TrainConfig(loss_chunk=min(1024, SEQ), chunk_size_bytes=DIST_CHUNK)
    model = client_model(torch, tc)
    names = [n for n, _ in model.named_parameters()]
    client = PHubClient(tc, comm, device=device).register(
        module_tree(model))
    opt = client.init_state()
    data = SyntheticTokens(model.cfg, BATCH, SEQ, seed=tc.seed)
    bw = BATCH // comm.n_workers
    sl = slice(comm.rank * bw, (comm.rank + 1) * bw)

    def collective_s():
        return sum(st["seconds"] for st in comm.stats.values())

    out = {k: [] for k in ("loss", "print", "step_ms", "backward_ms",
                           "push_pull_ms", "collective_ms", "peak_gib")}
    reset_all_launches()
    for i in range(CLIENT_GLOO_STEPS):
        batch = data.torch_batch(i, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0, t0 = collective_s(), time.perf_counter()
        loss, grads = worker_grads(torch, model, tc, batch["tokens"][sl],
                                   batch["labels"][sl])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, opt = client.push_pull(nest(zip(names, (g[None] for g in grads))),
                                  module_tree(model), opt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        for k, v in (("loss", float(loss)), ("step_ms", (t2 - t0) * 1e3),
                     ("backward_ms", (t1 - t0) * 1e3),
                     ("push_pull_ms", (t2 - t1) * 1e3),
                     ("collective_ms", (collective_s() - c0) * 1e3),
                     ("peak_gib", torch.cuda.max_memory_allocated() / 2**30),
                     ("print", fingerprint(torch, model))):
            out[k].append(v)
    out["launches"] = all_launches()
    return out


def client_phase(torch, runs: dict, bases: dict, count) -> None:
    """13. The framework-agnostic client: (g) stacked, full llama3.2-1b
    (``CLIENT_PATHS``), each path bitwise equal to the engine's run of
    this call; W=1 against ``make_optimizer``; (h) gloo, GLOO_W ranks
    sharing the card, against the stacked client at GLOO_W; the external
    MLP loop of ``examples/torch_external_loop.py``."""
    import importlib.util

    from repro_torch.core import chunking
    from repro_torch.core.pipeline import effective_windows
    from repro_torch.launch import dist

    t_phase = time.perf_counter()
    for (label, steps, fields, pods, flat, dead, expect,
         base) in CLIENT_PATHS:
        run = client_path(torch, label, steps, fields, pods, flat, dead,
                          expect)
        count(f"client {label}", run["launches"])
        hold_run(torch, f"client {label}", run, runs[base], steps)
        eng = runs[base]
        log(f"(g) client {label}: losses and parameters bitwise equal to "
            f"the engine's {base} over {steps} step(s); launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }; step "
            f"ms {[round(x, 3) for x in run['step_ms']]} against the "
            f"engine's {[round(x, 3) for x in eng['step_ms'][:steps]]}, "
            f"tokens/s "
            f"{[round(BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]} "
            f"against "
            f"{[round(BATCH * SEQ / (x / 1e3)) for x in eng['step_ms'][:steps]]}"
            f", peak GiB {[round(x, 3) for x in run['peak_gib']]} against "
            f"{[round(x, 3) for x in eng['peak_gib'][:steps]]}")
    for rule, expect, base in CLIENT_W1:
        run = client_one_worker(torch, rule)
        expect_launches(run["launches"], expect, 1, f"client W=1 {rule}")
        count(f"client W=1 {rule}", run["launches"])
        if base is not None:
            hold_run(torch, f"client W=1 {rule}", run, runs[base], 1)
            eng = runs[base]
            log(f"(g) client W=1 {rule}: also bitwise equal to the "
                f"engine's {base} step; its step {eng['step_ms'][0]:.1f} "
                f"ms, peak {eng['peak_gib'][0]:.2f} GiB")

    # (h) across processes: the stacked client at GLOO_W first
    steps = CLIENT_GLOO_STEPS
    stacked = client_path(torch, f"W={GLOO_W} in 64 KB chunks", steps,
                          {"chunk_size_bytes": DIST_CHUNK}, 1, False, None,
                          {"multi_agg_opt_chunks": 1}, workers=GLOO_W)
    hold_run(torch, f"client W={GLOO_W}", stacked, bases["nesterov"], steps)
    count(f"client W={GLOO_W}", stacked["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    ranks = dist.run(client_rank, GLOO_W, "gloo", "cuda", DIST_TIMEOUT,
                     timing=True)
    for r, res in enumerate(ranks):
        for i in range(steps):
            check(res["loss"][i] == stacked["worker_losses"][i][r],
                  f"(h) gloo rank {r} step {i}: loss {res['loss'][i]!r}, "
                  f"the stacked client's worker {r} "
                  f"{stacked['worker_losses'][i][r]!r}")
            check(same_fingerprint(torch, res["print"][i],
                                   stacked["prints"][i]),
                  f"(h) gloo rank {r}: the parameters after step {i} "
                  f"differ from the stacked client's")
        expect_launches(res["launches"], {"multi_agg_opt_chunks": 1},
                        steps, f"(h) gloo rank {r}")

        def r1(k):
            return [round(x, 1) for x in res[k]]
        log(f"(h) client over gloo, rank {r} of {GLOO_W} on one card, "
            f"{steps} steps: losses and parameters bitwise equal to the "
            f"stacked client's (and the engine's stacked W={GLOO_W} "
            f"steps); launches "
            f"{ {k: v for k, v in res['launches'].items() if v} }; step ms "
            f"{r1('step_ms')} (the first cold), tokens/s of the global "
            f"batch {[round(BATCH * SEQ / (x / 1e3)) for x in res['step_ms']]}"
            f"; forward and backward {r1('backward_ms')} ms, push_pull "
            f"{r1('push_pull_ms')} ms of which collectives "
            f"{r1('collective_ms')} ms; peak GiB "
            f"{[round(x, 3) for x in res['peak_gib']]}; the stacked client "
            f"{[round(x, 1) for x in stacked['step_ms']]} ms, "
            f"{[round(x, 3) for x in stacked['peak_gib']]} GiB")
    count(f"client gloo W={GLOO_W}, rank 0", ranks[0]["launches"])

    # the external MLP loop, imported from the example
    path = os.path.join(ROOT, "examples", "torch_external_loop.py")
    spec = importlib.util.spec_from_file_location("torch_external_loop",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    (group,) = chunking.build_plan(
        {"w": torch.empty(MLP_PARAMS, device="meta")},
        chunk_bytes=MLP_CHUNK, n_shards=WORKERS).groups
    launches_a_step = effective_windows(group, 2) * WORKERS
    reset_all_launches()
    t0 = time.perf_counter()
    losses = mod.main(["--device", "cuda"])
    ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    launches = all_launches()
    check(all(math.isfinite(x) for x in losses), "the MLP loop's mse is "
                                                 "not finite")
    check(losses[-1] <= losses[0] / 4,
          f"the MLP loop's mse fell from {losses[0]!r} to {losses[-1]!r}, "
          f"less than 4x")
    expect_launches(launches, {"adam_opt_chunks": launches_a_step},
                    len(losses), "the external MLP loop")
    count("client external MLP loop", launches)
    log(f"(g) external MLP loop (examples/torch_external_loop.py, 4 "
        f"stacked workers, Adam, {len(losses)} steps): mse "
        f"{losses[0]!r} -> {losses[-1]!r} ({losses[0] / losses[-1]:.1f}x), "
        f"adam_opt_chunks {launches['adam_opt_chunks']} launches "
        f"({launches_a_step} a step), {ms:.3f} ms a step")
    log(f"13. the client phase took {time.perf_counter() - t_phase:.1f} s")


# 14. PHub's multi-tenant rack (``core/api.py::PHubConnectionManager``):
# tenant A the full llama3.2-1b at the TrainConfig defaults (Nesterov, lr
# 1e-2, momentum 0.9, seed 0: the data and weights of the main paths), B
# llama3.2-1b at full width and CO_B_LAYERS layers (lr / 3, momentum 0.8,
# seed 1).  (label, workers, pods, the tenants' TrainConfig fields {ns:
# (rule, wire, fields)}, steps, a static dead worker, the pipeline windows,
# the solo runs of ``runs`` (or None: run here) each tenant equals)
CO_B_LAYERS, CO_STEPS, CO_DEAD = 4, 2, 3
_CO_B = dict(lr=1e-2 / 3, momentum=0.8, seed=1)
CO_PATHS = (
    ("W=4", WORKERS, 1, {"A": ("nesterov", "identity", {}),
                         "B": ("nesterov", "identity", _CO_B)},
     CO_STEPS, None, 1, {"A": "nesterov W=4", "B": "co B W=4"}),
    (f"W=4 in {WINDOWS_W4} windows", WORKERS, 1,
     {"A": ("nesterov", "identity", dict(pipeline_windows=WINDOWS_W4)),
      "B": ("nesterov", "identity", dict(_CO_B,
                                         pipeline_windows=WINDOWS_W4))},
     CO_STEPS, None, WINDOWS_W4, {"A": "nesterov W=4", "B": "co B W=4"}),
    ("hierarchical 2x2", WORKERS, PODS,
     {"A": ("nesterov", "identity", HIER),
      "B": ("nesterov", "identity", dict(_CO_B, **HIER))},
     CO_STEPS, None, 1, {"A": "nesterov hierarchical 2x2",
                         "B": "co B hierarchical 2x2"}),
    (f"W=4, worker {CO_DEAD} dead", WORKERS, 1,
     {"A": ("nesterov", "identity", {}),
      "B": ("nesterov", "identity", _CO_B)}, CO_STEPS, CO_DEAD, 1,
     {"A": f"co A W=4, worker {CO_DEAD} dead",
      "B": f"co B W=4, worker {CO_DEAD} dead"}),
    ("W=4, B under SGD", WORKERS, 1,
     {"A": ("nesterov", "identity", {}),
      "B": ("sgd", "identity", dict(seed=1))}, CO_STEPS, None, 1,
     {"A": "nesterov W=4", "B": "co B sgd W=4"}),
    ("W=2, B under Adam", 2, 1,
     {"A": ("nesterov", "identity", {}),
      "B": ("adam", "identity", dict(seed=1))}, CO_STEPS, None, 1,
     {"A": "nesterov stacked W=2", "B": "co B adam W=2"}),
    ("W=1", 1, 1, {"A": ("nesterov", "identity", {}),
                   "B": ("nesterov", "identity", _CO_B)}, 1, None, 1,
     {"A": "nesterov W=1", "B": "co B W=1"}),
)
# the int8 wire: the co-step in CO_INT8_WINDOWS windows against itself in
# one (bitwise), and each tenant against its solo int8 run within
# CO_INT8_BOUND of the step's largest change: the packed layout puts a
# tenant's chunks on other owner shards than its solo layout, whose ring
# starts at another worker, so the re-quantized partials differ by steps
# of the int8 grid (1/127 of a chunk's peak)
CO_INT8_WINDOWS, CO_INT8_BOUND = WINDOWS_W4, 0.02
CO_LIFECYCLE = (2, 2, 2)         # A solo, co-scheduled, solo again
CO_GLOO_W, CO_GLOO_CHUNK, CO_GLOO_SEQ = 2, 24 * 1024, 64


def tenant_launches(domain, windows: int, kernels: dict) -> dict:
    """Each kernel's launches a step of a co-scheduled exchange: one per
    (window strip of a shard, tenant run) that meet; ``kernels``: {tenant:
    its rule's kernel}."""
    out: dict = {}
    for g in domain.groups.values():
        L = g.shard_len
        Lw = L // windows
        for s in g.slots:
            for _, off, n in s.runs:
                for j in range(g.n_shards):
                    for w in range(windows):
                        lo = j * L + w * Lw
                        if off < lo + Lw and lo < off + n:
                            name = kernels[s.tenant]
                            out[name] = out.get(name, 0) + 1
    return out


def co_configs(tenants: dict) -> dict:
    """{ns: (ModelConfig, TrainConfig)} of ``CO_PATHS``' tenant fields,
    the TrainConfig as ``main_path`` builds it."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    return {ns: (cfg if ns == "A" else dataclasses.replace(
                     cfg, n_layers=CO_B_LAYERS),
                 path_tc(rule, wire, fields))
            for ns, (rule, wire, fields) in tenants.items()}


def co_run(torch, label: str, comm, configs: dict, steps: int,
           dead=None, lifecycle=None, device="cuda") -> dict:
    """Two tenants co-scheduled by a ``PHubConnectionManager`` over
    ``comm`` for ``steps`` steps, each on its own data (``SyntheticTokens``
    from its seed, batch BATCH x SEQ): per tenant its losses and the
    fingerprint after every step, step ms, peak GiB, the launches, the
    packed domain and ``accounting()``.  ``lifecycle``: (s1, s2, s3):
    tenant A trains s1 solo steps first, attaches with its momentum, the
    pair co-steps s2, and A detaches and trains s3 solo steps."""
    from repro_torch.core import PHubConnectionManager
    from repro_torch.data import SyntheticTokens

    cm = PHubConnectionManager()
    hs, models, data = [], {}, {}
    for ns, (cfg, tc) in configs.items():
        h = cm.create_service(ns, cfg, tc, comm, device=device)
        models[ns] = cm.init_service(h)[0]
        data[ns] = SyntheticTokens(cfg, BATCH, SEQ, seed=tc.seed)
        hs.append(h)
    if dead is not None:
        cm.leave(dead)
    out = {ns: {"losses": [], "prints": []} for ns in configs}
    hA = hs[0]
    s1, steps, s3 = lifecycle or (0, steps, 0)
    optA = cm.connect_service(hA).init_opt() if s1 else None
    for i in range(s1):
        models["A"], optA, met = cm.push_pull(
            hA, models["A"], optA, data["A"].torch_batch(i, device))
        out["A"]["losses"].append(float(met["loss"]))
        out["A"]["prints"].append(fingerprint(torch, models["A"]))
    cm.attach_services(hs, {"A": optA} if s1 else None)
    del optA
    dom = cm.packed_domain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    step_ms, peaks = [], []
    for i in range(steps):
        batches = {ns: data[ns].torch_batch(s1 + i if ns == "A" else i,
                                            device) for ns in configs}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models, met = cm.co_step(hs, models, batches)
        losses = {ns: float(m["loss"]) for ns, m in met.items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        for ns in configs:
            out[ns]["losses"].append(losses[ns])
            out[ns]["prints"].append(fingerprint(torch, models[ns]))
        log(f"(i) {label} co-step {i}: losses {losses}  {step_ms[-1]:.1f} ms"
            f"  {len(configs) * BATCH * SEQ / (step_ms[-1] / 1e3):,.0f} "
            f"aggregate tokens/s  peak {peaks[-1]:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
    launches = all_launches()
    acct = cm.accounting()
    if s1:
        optA = cm.detach_service(hA)
        cm.detach_service(hs[1])
        for i in range(s1 + steps, s1 + steps + s3):
            models["A"], optA, met = cm.push_pull(
                hA, models["A"], optA, data["A"].torch_batch(i, device))
            out["A"]["losses"].append(float(met["loss"]))
            out["A"]["prints"].append(fingerprint(torch, models["A"]))
        del optA
    res = {"tenants": out, "step_ms": step_ms, "peak_gib": peaks,
           "launches": launches, "domain": dom, "accounting": acct}
    del models, cm, hs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def co_note(run: dict) -> str:
    dom = run["domain"]
    acct = {ns: {"model_bytes": a["model_bytes"],
                 "domain_share": round(a["domain_share"], 6),
                 "push_bytes_a_step": a["per_step"]["push_bytes"],
                 "pull_bytes_a_step": a["per_step"]["pull_bytes"],
                 "wire_push_bytes_a_step": a["per_step"]["wire_push_bytes"]}
            for ns, a in run["accounting"].items()}
    return (f"packed domain "
            + ", ".join(f"{k}: {g.padded:,} ({g.n_shards} shards of "
                        f"{g.chunks_per_shard} chunks, chunks a shard "
                        f"{dom.shard_loads(k)})"
                        for k, g in dom.groups.items())
            + f"; co-step ms {[round(x, 3) for x in run['step_ms']]}, "
            f"aggregate tokens/s "
            f"{[round(2 * BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]}"
            f", peak GiB {[round(x, 3) for x in run['peak_gib']]}; "
            f"launches { {k: v for k, v in run['launches'].items() if v} }"
            f"; accounting {acct}")


def hold_tenant(torch, label: str, got: dict, solo: dict, steps: int,
                first: int = 0) -> None:
    """A co-scheduled tenant's losses and fingerprints equal to its solo
    run's steps first .. first+steps-1, bitwise."""
    check(got["losses"][first:first + steps] ==
          solo["losses"][first:first + steps],
          f"{label}: losses {got['losses']} differ from the solo run's "
          f"{solo['losses']}")
    for i in range(first, first + steps):
        check(same_fingerprint(torch, got["prints"][i], solo["prints"][i]),
              f"{label}: the parameters after step {i} differ from the "
              f"solo run's")


def co_solo(torch, runs: dict, key: str, label: str, W: int, pods: int,
            rule: str, wire: str, fields: dict, steps: int, layers: int,
            dead=None) -> dict:
    """A tenant's solo run: ``runs[key]`` when the main paths ran it, else
    ``main_path`` now (stored there); its launches are checked by
    ``main_path`` against one rule launch a step."""
    if key in runs:
        return runs[key]
    kernel = {"adam": "adam_opt_chunks", "sgd": "sgd_opt_chunks"}.get(
        rule, "multi_agg_opt_chunks" if W > 1 else "agg_opt_chunks")
    expect = dict(INT8_W4, **({} if rule == "nesterov" else
                              {"dequant_agg_opt_chunks": 0,
                               "dequantize_chunks": W, kernel: 1})) \
        if wire == "int8" else {kernel: 1}
    runs[key] = main_path(torch, W, steps, expect, rule, wire,
                          pipeline=dict(fields), layers=layers, dead=dead,
                          pods=pods)
    log(f"(i) solo {label}: step ms "
        f"{[round(x, 3) for x in runs[key]['step_ms']]}, peak GiB "
        f"{[round(x, 3) for x in runs[key]['peak_gib']]}")
    return runs[key]


def co_phase(torch, runs: dict, bases: dict, count) -> dict:
    """14. PHub's multi-tenant rack (module docstring).  Returns the
    packed W=4 domain's runs for ``co_kernel_phase``."""
    from repro_torch.core import StackedComm
    from repro_torch.core.pipeline import effective_windows
    from repro_torch.launch import dist
    from repro_torch.launch import train as train_cli

    if "nesterov" in bases:
        runs.setdefault("nesterov stacked W=2", bases["nesterov"])
    kernel_of = {"nesterov": "multi_agg_opt_chunks", "sgd": "sgd_opt_chunks",
                 "adam": "adam_opt_chunks"}
    domains = {}
    for (label, W, pods, tenants, steps, dead, windows,
         solo_keys) in CO_PATHS:
        configs = co_configs(tenants)
        solos = {}
        for ns, (rule, wire, fields) in tenants.items():
            # windows give the same bits: the solo run has one
            fields = {k: v for k, v in fields.items()
                      if k != "pipeline_windows"}
            solos[ns] = co_solo(torch, runs, solo_keys[ns],
                                f"{ns} of {label}", W, pods, rule, wire,
                                fields, steps,
                                0 if ns == "A" else CO_B_LAYERS, dead)
        run = co_run(torch, label, StackedComm(W, pods), configs, steps,
                     dead)
        g = next(iter(run["domain"].groups.values()))
        check(effective_windows(g, windows) == windows,
              f"(i) {label}: {windows} windows do not take effect")
        want = tenant_launches(run["domain"], windows, {
            ns: (kernel_of[rule] if W > 1 or rule != "nesterov"
                 else "agg_opt_chunks")
            for ns, (rule, _, _) in tenants.items()})
        expect_launches(run["launches"], want, steps, f"(i) {label}")
        for ns in tenants:
            hold_tenant(torch, f"(i) {label}, tenant {ns}",
                        run["tenants"][ns], solos[ns], steps)
        count(f"co-scheduled {label}", run["launches"])
        solo_ms = [a + b for a, b in zip(solos["A"]["step_ms"],
                                         solos["B"]["step_ms"])]
        log(f"(i) {label}: both tenants bitwise equal to their solo runs "
            f"over {steps} step(s) (losses, parameters); launches as "
            f"predicted {want} a step; solo A + B step ms "
            f"{[round(x, 3) for x in solo_ms[:steps]]}; " + co_note(run))
        domains[label] = run["domain"]

    # the int8 wire in CO_INT8_WINDOWS windows and in one
    tenants = {"A": ("nesterov", "int8", {}),
               "B": ("nesterov", "int8", _CO_B)}
    int8 = {}
    for windows in (CO_INT8_WINDOWS, 1):
        configs = co_configs({ns: (r, w, dict(f, pipeline_windows=
                                                      windows))
                                     for ns, (r, w, f) in tenants.items()})
        run = co_run(torch, f"int8 in {windows} window(s)",
                     StackedComm(WORKERS), configs, CO_STEPS)
        g = next(iter(run["domain"].groups.values()))
        check(effective_windows(g, windows) == windows,
              f"int8: {windows} windows do not take effect")
        want = tenant_launches(run["domain"], windows,
                               {ns: "dequant_agg_opt_chunks"
                                for ns in tenants})
        want.update(quantize_chunks=3 * windows + 1,
                    dequantize_chunks=2 * windows + 1)
        expect_launches(run["launches"], want, CO_STEPS,
                        f"(i) int8 in {windows} windows")
        count(f"co-scheduled int8 in {windows} window(s)", run["launches"])
        int8[windows] = run
        log(f"(i) int8 in {windows} window(s): launches as predicted {want}"
            f" a step; " + co_note(run))
    for ns in tenants:
        hold_tenant(torch, f"(i) int8 in {CO_INT8_WINDOWS} windows, tenant "
                           f"{ns}", int8[CO_INT8_WINDOWS]["tenants"][ns],
                    int8[1]["tenants"][ns], CO_STEPS)
    solos = {"A": co_solo(torch, runs, "nesterov int8 W=4", "A int8 W=4",
                          WORKERS, 1, "nesterov", "int8", {}, CO_STEPS, 0),
             "B": co_solo(torch, runs, "co B int8 W=4", "B int8 W=4",
                          WORKERS, 1, "nesterov", "int8", _CO_B, CO_STEPS,
                          CO_B_LAYERS)}
    for ns, solo in solos.items():
        got = int8[1]["tenants"][ns]
        check(got["losses"][0] == solo["losses"][0],
              f"int8 tenant {ns}: step 0's loss differs from the solo run's")
        gap = sampled_gap(torch, got["prints"][0], solo["prints"][0])
        step = sampled_step(torch, solo, 0)
        check(gap <= CO_INT8_BOUND * step,
              f"int8 tenant {ns} after one step: {gap} from its solo run, "
              f"bound {CO_INT8_BOUND} x {step}")
        log(f"(i) int8 tenant {ns}: in {CO_INT8_WINDOWS} windows bitwise "
            f"equal to one window; after one step its sampled parameters "
            f"lie {gap!r} from its solo int8 run's, {gap / step!r} of the "
            f"step's largest change {step!r} (bound {CO_INT8_BOUND}); "
            f"solo step ms {[round(x, 3) for x in solo['step_ms']]}")

    # the lifecycle: A solo, attached with its momentum, co-stepped, back
    solo6 = co_solo(torch, runs, "co A lifecycle", "A, 6 steps", WORKERS, 1,
                    "nesterov", "identity", {}, sum(CO_LIFECYCLE), 0)
    run = co_run(torch, "lifecycle", StackedComm(WORKERS),
                 co_configs({"A": ("nesterov", "identity", {}),
                                    "B": ("nesterov", "identity", _CO_B)}),
                 CO_LIFECYCLE[1], lifecycle=CO_LIFECYCLE)
    hold_tenant(torch, "(i) lifecycle, tenant A", run["tenants"]["A"], solo6,
                sum(CO_LIFECYCLE))
    want = tenant_launches(run["domain"], 1, {"A": "multi_agg_opt_chunks",
                                              "B": "multi_agg_opt_chunks"})
    expect_launches(run["launches"], want, CO_LIFECYCLE[1], "(i) lifecycle")
    count("co-scheduled lifecycle", run["launches"])
    log(f"(i) lifecycle: A {CO_LIFECYCLE[0]} solo steps, attached with its "
        f"momentum, {CO_LIFECYCLE[1]} co-steps beside B, detached, "
        f"{CO_LIFECYCLE[2]} solo steps: bitwise equal to "
        f"{sum(CO_LIFECYCLE)} solo steps (losses, parameters); "
        + co_note(run))

    # the launcher: --tenants 2 --workers 2 on the full model
    reset_all_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_cli.main(["--arch", ARCH, "--tenants", "2", "--workers",
                             "2", "--steps", str(CO_STEPS), "--batch",
                             str(BATCH), "--seq", str(SEQ), "--device",
                             "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    check(set(losses) == {"job0", "job1"} and all(
        len(v) == CO_STEPS and all(math.isfinite(x) for x in v)
        for v in losses.values()), f"launcher losses {losses}")
    check(launches["multi_agg_opt_chunks"] == 4 * CO_STEPS
          and sum(launches.values()) == 4 * CO_STEPS,
          f"launcher launches {launches}")
    count("co-scheduled launcher --tenants 2 --workers 2", launches)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(i) launch/train.py --tenants 2 --workers 2 --steps {CO_STEPS} "
        f"(full {ARCH} twice): losses {losses}, {wall:.1f} s in all, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # gloo, CO_GLOO_W ranks on cuda:0, reduced, against the stacked co-step
    want = co_reduced_run(torch, StackedComm(CO_GLOO_W))
    ranks = dist.run(co_reduced_rank, CO_GLOO_W, "gloo", "cuda",
                     DIST_TIMEOUT)
    for r, got in enumerate(ranks):
        check(got["losses"] == want["losses"]
              and got["params"] == want["params"],
              f"(i) gloo rank {r}: losses or parameters differ from the "
              f"stacked co-step's")
        check(got["launches"]["multi_agg_opt_chunks"] * CO_GLOO_W
              == want["launches"]["multi_agg_opt_chunks"],
              f"(i) gloo rank {r}: launches {got['launches']}, the stacked "
              f"step's {want['launches']}")
    log(f"(i) gloo, {CO_GLOO_W} processes on one card: reduced {ARCH} "
        f"tenants (d_model 256 and 512), {CO_STEPS} co-steps, every rank's "
        f"losses and parameters bitwise equal to StackedComm({CO_GLOO_W})'s;"
        f" a rank's launches {ranks[0]['launches']}")
    return domains


def co_reduced_run(torch, comm, device="cuda") -> dict:
    """Two reduced tenants co-stepped CO_STEPS steps over ``comm``:
    losses, per-leaf bit-pattern sums of both tenants, launches."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubConnectionManager
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens

    cm = PHubConnectionManager()
    hs, models, data = [], {}, {}
    for ns, d in (("A", 256), ("B", 512)):
        cfg = dataclasses.replace(reduced(get_arch(ARCH), d_model=d),
                                  dtype="float32")
        tc = TrainConfig(loss_chunk=CO_GLOO_SEQ,
                         chunk_size_bytes=CO_GLOO_CHUNK,
                         **(_CO_B if ns == "B" else {}))
        h = cm.create_service(ns, cfg, tc, comm, device=device)
        models[ns] = cm.init_service(h)[0]
        data[ns] = SyntheticTokens(cfg, BATCH, CO_GLOO_SEQ, seed=tc.seed)
        hs.append(h)
    cm.attach_services(hs)
    reset_all_launches()
    losses = []
    for i in range(CO_STEPS):
        models, met = cm.co_step(hs, models, {
            ns: d.torch_batch(i, device) for ns, d in data.items()})
        losses.append({ns: float(m["loss"]) for ns, m in met.items()})
    return {"losses": losses, "launches": all_launches(),
            "params": {ns: [bit_sum(torch, t) for _, t in
                            leaf_paths(m.param_tree())]
                       for ns, m in models.items()}}


def co_reduced_rank(comm, device):
    import torch
    return co_reduced_run(torch, comm, device)


def co_kernel_phase(torch, domains: dict, ce: int) -> dict:
    """Each kernel of the co-scheduled step on a tenant run of the packed
    full-width domains of ``co_phase`` (A + B), as ``RunUpdate`` launches
    it, bitwise against its plain version on the same views and timed
    (CUDA events, median of 10) beside the run's bytes bound: B2 and B3 on
    B's run of shard 1 at W=4, the (4, run) gradient read at the packed
    row stride; B4 on B's run of shard 1 at W=2 (2 rows at that stride);
    B1 on B's run of the W=1 domain, pre-aggregated; B7 on B's part of
    window 3 of 5 of shard 0 at W=4 (after A's tail); B6a and B6b on a
    window's packed strips of all four shards.  Returns {kernel:
    {"tenant_run": {...}}} for the kernels line."""
    from repro_torch.kernels.agg_opt import (adam_opt_ref, agg_opt_ref,
                                             dequant_agg_opt_ref,
                                             fused_adam_opt, fused_agg_opt,
                                             fused_dequant_agg_opt,
                                             fused_multi_agg_opt,
                                             fused_sgd_opt,
                                             multi_agg_opt_ref, sgd_opt_ref)
    from repro_torch.kernels.quant import (dequantize_int8,
                                           dequantize_int8_ref,
                                           quantize_int8, quantize_int8_ref)
    out = {}

    def hold(name, run, plain, where, elems, n_bytes, n_ops, extra=0,
             timed=None):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err, ulp = compare(torch, got, want)
        del got, want
        check(ulp == 0, f"{name} on a tenant run differs from its plain "
                        f"version (max_ulp {ulp})")
        ms = median_ms(torch, timed or run, reps=10)
        plain_ms = median_ms(torch, plain, reps=3)
        bound_ms, bound_by = bound(elems, n_bytes, n_ops, extra)
        log(f"(i) {name} on {where}: {elems:,} elements, max_abs {err:.3e} "
            f"max_ulp {ulp}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}; "
            f"{100 * bound_ms / ms:.1f}% of it)")
        out[name] = {"tenant_run": {
            "where": where, "elements": elems, "max_abs_err": err,
            "max_ulp": ulp, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}}

    g4 = domains["W=4"].groups["float32"]
    gbuf = torch.empty(WORKERS, g4.padded, device="cuda")
    lr, mu = 1e-2 / 3, 0.8

    def run_of(label, i):
        g = domains[label].groups["float32"]
        (_, off, n) = g.slot("B").runs[i]
        return g, off, n

    # B2, B3: B's run of shard 1 at W=4
    g, off, n = run_of("W=4", 1)
    for w in range(WORKERS):
        gbuf[w, off:off + n].copy_(draw(torch, "g", n, 177 + w))
    gv = gbuf[:, off:off + n]
    p, m = draw(torch, "p", n, 191), draw(torch, "m", n, 192)
    where = (f"B's run of shard 1 at W=4, g (4, {n:,}) at row stride "
             f"{gv.stride(0):,}")
    hold("multi_agg_opt_chunks",
         lambda: fused_multi_agg_opt(p, gv, m, lr=lr, momentum=mu),
         lambda: multi_agg_opt_ref(p, gv, m, lr=lr, momentum=mu), where, n,
         4 * (WORKERS + 4), WORKERS - 1 + 7)
    hold("sgd_opt_chunks", lambda: (fused_sgd_opt(p, gv, lr=SGD_LR),),
         lambda: (sgd_opt_ref(p, gv, lr=SGD_LR),), where, n,
         4 * (WORKERS + 2), WORKERS + 1)
    del p, m
    # B7: the window where B's first run starts holds A's tail, then B's
    # head (window 3 of 5 of shard 0)
    L, Lw = g.shard_len, g.shard_len // CO_INT8_WINDOWS
    (_, b0, bn) = g.slot("B").runs[0]
    j, w = b0 // L, b0 % L // Lw
    k = min(j * L + (w + 1) * Lw, b0 + bn) - b0
    q, s = quantize_int8(draw(torch, "g", k, 201), chunk_elems=ce)
    own = gbuf[0, b0:b0 + k]
    own.copy_(draw(torch, "g", k, 202))
    p, m0, p_out = draw(torch, "p", k, 203), draw(torch, "m", k, 204), \
        torch.empty(k, device="cuda")
    m = m0.clone()
    kw = dict(lr=1e-2, momentum=0.9, inv_n=1 / WORKERS, chunk_elems=ce)
    hold("dequant_agg_opt_chunks",
         lambda: fused_dequant_agg_opt(p, q, s, own, m, p_out=p_out, **kw),
         lambda: dequant_agg_opt_ref(p, q, s, own, m0, **kw),
         f"B's part of window {w} of {CO_INT8_WINDOWS}, shard {j} at W=4",
         k,
         4 * 5 + 1, 9, extra=4 * (k // ce))
    del q, s, own, p, m, m0, p_out
    # B6a, B6b: a window's packed strips of all four shards
    nw = g.n_shards * Lw
    x = gbuf[1:3].reshape(-1)[:nw]
    x.copy_(draw(torch, "g", nw, 211))
    where = f"a window's packed strips at W=4 ({g.n_shards} x {Lw:,})"
    hold("quantize_chunks", lambda: quantize_int8(x, chunk_elems=ce),
         lambda: quantize_int8_ref(x, ce), where, nw, 5, 2,
         extra=4 * (nw // ce))
    qw, sw = quantize_int8(x, chunk_elems=ce)
    hold("dequantize_chunks",
         lambda: (dequantize_int8(qw, sw, chunk_elems=ce),),
         lambda: (dequantize_int8_ref(qw, sw, ce),), where, nw, 5, 1,
         extra=4 * (nw // ce))
    del x, qw, sw
    # B4: B's run of shard 1 at W=2, its slots in place
    g, off, n = run_of("W=2, B under Adam", 1)
    for w in range(2):
        gbuf[w, off:off + n].copy_(draw(torch, "g", n, 221 + w))
    g2 = gbuf[:2, off:off + n]
    p, p_out = draw(torch, "p", n, 231), torch.empty(n, device="cuda")
    saved = [draw(torch, kind, n, 232 + i)
             for i, kind in enumerate(("m", "v", "k1", "k2"))]
    slots = [t.clone() for t in saved]
    akw = dict(lr=ADAM_LR, b1=0.9, b2=0.999, eps=1e-8)
    hold("adam_opt_chunks",
         lambda: fused_adam_opt(p, g2, *slots, p_out=p_out, **akw),
         lambda: adam_opt_ref(p, g2, *saved, **akw),
         f"B's run of shard 1 at W=2, g (2, {n:,}) at row stride "
         f"{g2.stride(0):,}", n, 4 * (2 + 10), 2 + 22)
    del gbuf, g2, p, p_out, saved, slots
    # B1: B's run of the W=1 domain, pre-aggregated
    g, off, n = run_of("W=1", 0)
    p, m, g1 = (draw(torch, kind, n, 241 + i)
                for i, kind in enumerate(("p", "m", "g")))
    hold("agg_opt_chunks",
         lambda: fused_agg_opt(p, g1, m, lr=lr, momentum=mu),
         lambda: agg_opt_ref(p, g1, m, lr=lr, momentum=mu),
         "B's run at W=1, pre-aggregated", n, 4 * 5, 7)
    del p, m, g1
    gc.collect()
    torch.cuda.empty_cache()
    return out


# 15. PHub's elastic rack resize (``PHubConnectionManager.resize``,
# ``resize_phase``): full llama3.2-1b services of 4 stacked workers moved
# to 3 and back.  A step at 3 workers takes RESIZE_BATCH_W3 sequences (8
# does not split over 3; 2 a worker, as at 4); (d) cuts depth to
# RESIZE_CKPT_LAYERS: writing, verifying and reading a snapshot back costs
# ~12 s a GB (4 layers, 4.05 GB: 12.5 s to write, 16.6-17.7 s a restore,
# 49 s of the phase), and the full depth is 9.9 GB.
RESIZE_W, RESIZE_W3, RESIZE_BATCH_W3 = WORKERS, 3, 6
RESIZE_PADTAIL_STEPS = 4          # (a): 2 steps, the round trip, 2 steps
RESIZE_CKPT_LAYERS, RESIZE_CKPT_WORLDS = 1, (3, 2)


def rs_live(eng, opt) -> dict:
    """{slot: (R, live_elems)} views of each slot's live region."""
    return {f"{g.key}/{n}": v.view(-1, g.padded)[:, :g.live_elems]
            for g in eng.chunk_plan.groups
            for n, v in opt[g.key].items()}


def rs_same(torch, eng, opt, pre: dict) -> bool:
    now = rs_live(eng, opt)
    return set(now) == set(pre) and all(torch.equal(now[k], pre[k])
                                        for k in pre)


def rs_solo_bytes(old, new) -> int:
    """The bytes a solo resize must move: each slot's live region read
    once and its new buffer (pad included) written once."""
    out = 0
    for g_old, g in zip(old.chunk_plan.groups, new.chunk_plan.groups):
        for spec in new.exchange_slots:
            rows = math.prod(new.slot_shape(g, spec)) // g.padded
            item = spec.resolve_dtype(g.dtype).itemsize
            out += rows * (g.live_elems + g.padded) * item
    return out


def rs_co_bytes(old_dom, new_dom, slots) -> int:
    """The bytes a packed re-pack must move: each tenant's runs read out of
    the old domain and written to a flat, the flat read and the new packed
    buffer (pad included) written, for every slot."""
    out = 0
    for key, g in new_dom.groups.items():
        item = sum(s.resolve_dtype(g.dtype).itemsize for s in slots)
        tenants = sum(s.padded for s in old_dom.groups[key].slots)
        out += (3 * tenants + g.padded) * item
    return out


def rs_moved_host(old_dom, new_dom, slots) -> int:
    """The bytes a re-pack moves, counted from the two layouts: every
    tenant chunk whose packed position changed drags its parameter and
    one stripe a slot (``cost_model.rebalance_traffic``'s definition,
    counted here without the plan)."""
    out = 0
    for key, g in old_dom.groups.items():
        ce = g.chunk_elems
        item = g.dtype.itemsize + sum(s.resolve_dtype(g.dtype).itemsize
                                      for s in slots)

        def where(dom, tenant):
            m = {}
            for toff, poff, n in dom.groups[key].slot(tenant).runs:
                for k in range(0, n, ce):
                    m[toff + k] = poff + k
            return m
        for s in g.slots:
            a, b = where(old_dom, s.tenant), where(new_dom, s.tenant)
            out += sum(ce for t in a if a[t] != b[t]) * item
    return out


def rs_resize(torch, cm, W: int, states=None):
    """``cm.resize(StackedComm(W), states)`` between two synchronizations:
    (result, ms, GiB allocated before, peak GiB, GiB allocated after)."""
    from repro_torch.core import StackedComm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cm.resize(StackedComm(W), states=states)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, ms, before, torch.cuda.max_memory_allocated() / 2**30,
            torch.cuda.memory_allocated() / 2**30)


def rs_step(torch, fn):
    """One step ``fn()`` between two synchronizations: (its result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rs_note(label: str, ms: float, moved: int, before: float, peak: float,
            after: float, cm) -> str:
    lr = cm.last_rebalance
    traffic = lr["co"] or next(iter(lr["solo"].values()))
    bound = moved / HBM_BYTES_PER_S * 1e3
    return (f"{label}: {ms:.3f} ms, {moved:,} bytes moved, "
            f"{moved / (ms / 1e3) / 1e9:.1f} GB/s against the HBM bound "
            f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s ({bound:.3f} ms, "
            f"{bound / ms:.1%}); moved_bytes "
            f"{traffic['moved_bytes']:.0f}, moved_fraction "
            f"{traffic['moved_fraction']!r}; GiB allocated {before:.2f} "
            f"before, peak {peak:.2f}, {after:.2f} after; world "
            f"{lr['world']}, epoch {lr['epoch']}")


def rs_int8_expect(S: int, w: int) -> dict:
    """The int8 wire's launches a step at S shards in w effective windows:
    S-1 ring encodes and S-2 decodes a window, one of each for the pull,
    the tail kernel once a window."""
    return {"quantize_chunks": (S - 1) * w + 1,
            "dequantize_chunks": (S - 2) * w + 1,
            "dequant_agg_opt_chunks": w}


def resize_solo(torch, label: str, rule: str, wire: str, fields: dict,
                expect, count, padtail: bool) -> dict:
    """(a) / (b): one solo service of the full model trained at W=4, moved
    to 3 and back with its caller-held state; every slot bitwise on the
    live region after each move.  ``padtail``: the round trip sits between
    steps 2 and 3 of RESIZE_PADTAIL_STEPS, and the run must equal one that
    never resized (losses, the parameters' fingerprint, every slot's full
    buffer, pad included).  Then a step at W=3 and one back at W=4.
    ``expect(S, windows)``: launches a step."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PHubConnectionManager, StackedComm
    from repro_torch.core.pipeline import effective_windows
    from repro_torch.data import SyntheticTokens

    cfg = get_arch(ARCH)
    tc = path_tc(rule, wire, fields)
    data = SyntheticTokens(cfg, BATCH, SEQ, seed=tc.seed)
    data3 = SyntheticTokens(cfg, RESIZE_BATCH_W3, SEQ, seed=tc.seed)
    before = RESIZE_PADTAIL_STEPS // 2 if padtail else 1

    def service():
        cm = PHubConnectionManager()
        h = cm.create_service("job", cfg, tc, StackedComm(RESIZE_W),
                              device="cuda")
        return (cm, h) + cm.init_service(h)

    def steps(cm, h, m, o, first, n, tag):
        eng = cm.connect_service(h)
        S = eng.comm.n_shards(tc.strategy)
        w = effective_windows(eng.chunk_plan.groups[0], tc.pipeline_windows)
        losses, ms = [], []
        reset_all_launches()
        for i in range(first, first + n):
            b = (data if eng.comm.n_workers == RESIZE_W else data3
                 ).torch_batch(i, "cuda")
            (m, o, met), t = rs_step(torch, lambda: cm.push_pull(h, m, o, b))
            losses.append(float(met["loss"]))
            ms.append(t)
        launches = all_launches()
        expect_launches(launches, expect(S, w), n, f"(a-b) {label} {tag}")
        count(f"resize {label} {tag}", launches)
        check(all(math.isfinite(x) for x in losses),
              f"{label} {tag}: losses {losses}")
        return m, o, losses, ms

    out = {}
    ref = None
    if padtail:
        cm, h, m, o = service()
        m, o, ref_losses, ref_ms = steps(cm, h, m, o, 0,
                                         RESIZE_PADTAIL_STEPS,
                                         "never resized")
        ref = (ref_losses, fingerprint(torch, m), o)
        del cm, h, m
        gc.collect()
    cm, h, m, o = service()
    m, o, losses, ms4 = steps(cm, h, m, o, 0, before, "at W=4")
    old = cm.connect_service(h)
    pre = {k: v.clone() for k, v in rs_live(old, o).items()}
    for W in (RESIZE_W3, RESIZE_W):
        move = f"{label} resize {RESIZE_W + RESIZE_W3 - W}->{W}"
        res, ms, b, peak, a = rs_resize(torch, cm, W, {"job": (m, o)})
        m, o = res["job"]
        new = cm.connect_service(h)
        moved = rs_solo_bytes(old, new)
        check(all(v.device.type == new.device.type for d in o.values()
                  for v in d.values()), f"{label}: a slot left the card")
        check(rs_same(torch, new, o, pre),
              f"{label}: a slot's live region changed in the resize to "
              f"W={W}")
        check(cm.last_rebalance["solo"]["job"]["moved_bytes"] == 0,
              f"{label}: a solo resize moved chunks")
        log(f"15. {rs_note(move, ms, moved, b, peak, a, cm)}; every slot "
            f"({', '.join(pre)}) bitwise on its live region")
        out[f"resize ->{W}"] = dict(ms=ms, bytes=moved, peak=peak,
                                    before=b, after=a)
        old = new
    del pre
    check(cm.membership.epoch == 2 and cm.membership.world == RESIZE_W,
          f"{label}: membership {cm.membership}")
    if padtail:
        ref_losses, ref_print, ref_o = ref
        m, o, more, ms_more = steps(cm, h, m, o, before,
                                    RESIZE_PADTAIL_STEPS - before,
                                    "after the round trip")
        check(losses + more == ref_losses,
              f"{label}: losses {losses + more} differ from the run that "
              f"never resized {ref_losses}")
        check(same_fingerprint(torch, fingerprint(torch, m), ref_print),
              f"{label}: the parameters differ from the run that never "
              f"resized")
        for key, d in o.items():
            for n, v in d.items():
                check(torch.equal(v, ref_o[key][n]),
                      f"{label}: slot {key}/{n} (full buffer) differs from "
                      f"the run that never resized")
        log(f"15. {label} padtail: {before} steps, W={RESIZE_W}->"
            f"{RESIZE_W3}->{RESIZE_W}, {RESIZE_PADTAIL_STEPS - before} "
            f"steps: losses {ref_losses}, the parameters' fingerprint and "
            f"every slot's full buffer (pad included) bitwise equal to the "
            f"run that never resized; step ms "
            f"{[round(x, 3) for x in ms4 + ms_more]} against "
            f"{[round(x, 3) for x in ref_ms]}")
        del ref_o, ref
        ms4 = ms4 + ms_more
    res = rs_resize(torch, cm, RESIZE_W3, {"job": (m, o)})[0]
    m, o = res["job"]
    m, o, l3, ms3 = steps(cm, h, m, o, 0, 1, f"at W={RESIZE_W3}")
    m, o = rs_resize(torch, cm, RESIZE_W, {"job": (m, o)})[0]["job"]
    m, o, lb, msb = steps(cm, h, m, o, RESIZE_PADTAIL_STEPS, 1,
                          "back at W=4")
    log(f"15. {label}: step ms at W={RESIZE_W} {[round(x, 3) for x in ms4]},"
        f" at W={RESIZE_W3} (batch {RESIZE_BATCH_W3}) {ms3[0]:.3f} "
        f"({RESIZE_BATCH_W3 * SEQ / (ms3[0] / 1e3):,.0f} tokens/s), back at "
        f"W={RESIZE_W} {msb[0]:.3f} ({BATCH * SEQ / (msb[0] / 1e3):,.0f} "
        f"tokens/s); losses {l3} at W={RESIZE_W3}, {lb} back")
    out.update(step_ms=ms4, step_ms_w3=ms3, step_ms_back=msb)
    del cm, h, m, o, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resize_co(torch, count) -> dict:
    """(c): phase 14's pair (A full, B at CO_B_LAYERS layers, Nesterov),
    one solo step each, attached with its momentum, moved to 3 workers and
    back, detached: each tenant's slot bitwise on its live region;
    ``moved_bytes`` equal to the count from the two layouts; then a
    co-step at W=3 and one back at W=4."""
    from repro_torch.core import PHubConnectionManager, StackedComm
    from repro_torch.core.engine import co_slot_specs
    from repro_torch.data import SyntheticTokens

    configs = co_configs({"A": ("nesterov", "identity", {}),
                          "B": ("nesterov", "identity", _CO_B)})
    cm = PHubConnectionManager()
    hs, models, opts, data, data3 = [], {}, {}, {}, {}
    for ns, (cfg, tc) in configs.items():
        h = cm.create_service(ns, cfg, tc, StackedComm(RESIZE_W),
                              device="cuda")
        models[ns], o = cm.init_service(h)
        data[ns] = SyntheticTokens(cfg, BATCH, SEQ, seed=tc.seed)
        data3[ns] = SyntheticTokens(cfg, RESIZE_BATCH_W3, SEQ, seed=tc.seed)
        reset_all_launches()
        models[ns], opts[ns], _ = cm.push_pull(h, models[ns], o,
                                               data[ns].torch_batch(0,
                                                                    "cuda"))
        expect_launches(all_launches(), {"multi_agg_opt_chunks": 1}, 1,
                        f"(c) {ns} solo")
        count(f"resize co {ns} solo step", all_launches())
        hs.append(h)
    pre = {h.namespace: {k: v.clone() for k, v in rs_live(
        cm.connect_service(h), opts[h.namespace]).items()} for h in hs}
    cm.attach_services(hs, opts)
    opts = {}
    out = {}
    slots = co_slot_specs({h.namespace: cm.connect_service(h) for h in hs})
    for W in (RESIZE_W3, RESIZE_W):
        old_dom = cm.packed_domain
        _, ms, b, peak, a = rs_resize(torch, cm, W)
        new_dom = cm.packed_domain
        host = rs_moved_host(old_dom, new_dom, slots)
        co = cm.last_rebalance["co"]
        check(co["moved_bytes"] == host and host > 0,
              f"(c) moved_bytes {co['moved_bytes']}, the layouts' count "
              f"{host}")
        moved = rs_co_bytes(old_dom, new_dom, slots)
        note = rs_note(f"co-scheduled pair resize ->{W}", ms, moved, b,
                       peak, a, cm)
        log(f"15. {note}; moved_bytes equal to the layouts' count; packed "
            f"domain {new_dom.groups['float32'].padded:,}, chunks a shard "
            f"{new_dom.shard_loads('float32')}")
        out[f"resize ->{W}"] = dict(ms=ms, bytes=moved, peak=peak,
                                    before=b, after=a,
                                    moved_bytes=co["moved_bytes"],
                                    moved_fraction=co["moved_fraction"])
    for h in hs:
        opts[h.namespace] = cm.detach_service(h)
        check(rs_same(torch, cm.connect_service(h), opts[h.namespace],
                      pre[h.namespace]),
              f"(c) tenant {h.namespace}: a slot's live region changed "
              f"across the resize")
    del pre
    cm.attach_services(hs, opts)
    opts = {}
    cm.resize(StackedComm(RESIZE_W3))
    ms = {}
    for W, src, i in ((RESIZE_W3, data3, 0), (RESIZE_W, data, 1)):
        if W != RESIZE_W3:
            cm.resize(StackedComm(W))
        reset_all_launches()
        batches = {ns: d.torch_batch(i, "cuda") for ns, d in src.items()}
        (models, met), ms[W] = rs_step(
            torch, lambda: cm.co_step(hs, models, batches))
        launches = all_launches()
        want = tenant_launches(cm.packed_domain, 1, {
            "A": "multi_agg_opt_chunks", "B": "multi_agg_opt_chunks"})
        expect_launches(launches, want, 1, f"(c) co-step at W={W}")
        count(f"resize co-step at W={W}", launches)
        losses = {ns: float(v["loss"]) for ns, v in met.items()}
        check(all(math.isfinite(x) for x in losses.values()),
              f"(c) co-step at W={W}: losses {losses}")
        log(f"15. co-scheduled pair: co-step at W={W} "
            f"(batch {len(batches['A']['tokens'])} each) {ms[W]:.3f} ms, "
            f"losses {losses}, launches {want}")
    log("15. co-scheduled pair: each tenant's slot bitwise equal to its "
        "pre-resize value on the live region after W=4->3->4 and detach")
    out.update(step_ms_w3=ms[RESIZE_W3], step_ms_back=ms[RESIZE_W])
    del cm, hs, models
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resize_checkpoint(torch, count) -> dict:
    """(d): a snapshot written at W=4 (Nesterov, RESIZE_CKPT_LAYERS
    layers) restored at each of RESIZE_CKPT_WORLDS: the slot bitwise on
    its live region, the parameters' fingerprint equal, a step after
    finite."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import (restore_train_state, save_checkpoint,
                                        snapshot_tree)
    from repro_torch.configs import get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens
    from repro_torch.elastic import Membership

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=RESIZE_CKPT_LAYERS)
    tc = path_tc("nesterov", "identity", {})
    d = os.path.join(ROOT, "build", "chip_smoke_resize_checkpoints")
    shutil.rmtree(d, ignore_errors=True)
    eng = PHubEngine(cfg, tc, StackedComm(RESIZE_W), device="cuda")
    m, o = eng.init_state()
    reset_all_launches()
    m, o, _ = eng.make_train_step()(m, o, SyntheticTokens(
        cfg, BATCH, SEQ, seed=tc.seed).torch_batch(0, "cuda"))
    expect_launches(all_launches(), {"multi_agg_opt_chunks": 1}, 1,
                    "(d) step at W=4")
    count("resize checkpoint step at W=4", all_launches())
    pre = {k: v.clone() for k, v in rs_live(eng, o).items()}
    want = fingerprint(torch, m)
    _, t_save = rs_step(torch, lambda: save_checkpoint(
        d, 1, snapshot_tree(m, o), membership=Membership.full(RESIZE_W)))
    size = sum(os.path.getsize(os.path.join(d, "step_00000001", f))
               for f in os.listdir(os.path.join(d, "step_00000001")))
    del m, o, eng
    gc.collect()
    out = {"save_ms": t_save, "bytes": size}
    for W in RESIZE_CKPT_WORLDS:
        eng = PHubEngine(cfg, tc, StackedComm(W), device="cuda")
        (step, m, o), ms = rs_step(torch, lambda: restore_train_state(
            d, eng, membership=Membership.full(W)))
        check(step == 1 and rs_same(torch, eng, o, pre),
              f"(d) restore at W={W}: step {step}, or a slot's live region "
              f"differs from the snapshot's")
        check(same_fingerprint(torch, fingerprint(torch, m), want),
              f"(d) restore at W={W}: the parameters differ")
        batch = SyntheticTokens(cfg, RESIZE_BATCH_W3 if W == 3 else BATCH,
                                SEQ, seed=tc.seed).torch_batch(1, "cuda")
        reset_all_launches()
        (m, o, met), t = rs_step(torch,
                                 lambda: eng.make_train_step()(m, o, batch))
        expect_launches(all_launches(), {"multi_agg_opt_chunks": 1}, 1,
                        f"(d) step at W={W}")
        count(f"resize checkpoint step at W={W}", all_launches())
        check(math.isfinite(float(met["loss"])),
              f"(d) step at W={W}: loss {float(met['loss'])}")
        log(f"15. checkpoint ({cfg.n_layers} layers, {size:,} bytes on "
            f"disk, written at W={RESIZE_W} in {t_save:.1f} ms, read warm) "
            f"restored at W={W} in {ms:.1f} ms: the slot bitwise on its "
            f"live region, the parameters' fingerprint equal; a step after "
            f"{t:.3f} ms, loss {float(met['loss'])!r}")
        out[f"restore W={W}"] = dict(ms=ms, step_ms=t)
        del m, o, eng
        gc.collect()
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def resize_phase(torch, count) -> dict:
    """15. PHub's elastic rack resize (module docstring)."""
    t_phase = time.perf_counter()
    out = {}
    out["a"] = resize_solo(
        torch, "(a) nesterov int8", "nesterov", "int8",
        dict(pipeline_windows=WINDOWS_W4), rs_int8_expect, count,
        padtail=True)
    out["b"] = resize_solo(
        torch, "(b) adam", "adam", "identity", {},
        lambda S, w: {"adam_opt_chunks": 1}, count, padtail=False)
    out["c"] = resize_co(torch, count)
    out["d"] = resize_checkpoint(torch, count)
    log(f"15. the resize phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------- 16. characterization

TEL_STEPS = 2                    # (d): steps a telemetry on/off run
TEL_MODES = ("off", "on", "on", "off")     # (d): interleaved runs
# (a): (label, workers, TrainConfig fields, warm steps, timed steps,
# launches a step)
ZC_PATHS = (
    ("W=4", WORKERS, {}, 1, 10, {"multi_agg_opt_chunks": 1}),
    ("W=1", 1, {}, 1, 5, {"agg_opt_chunks": 1}),
    (f"int8 W=4 in {WINDOWS_W4} windows", WORKERS,
     dict(wire_format="int8", pipeline_windows=WINDOWS_W4), 1, 5,
     INT8_W4_WINDOWS),
)


def zc_bytes(W: int, n: int) -> int:
    """The bytes one identity zero-compute step must move over an n-element
    f32 domain: the parameters flattened (read, write), W rows filled with
    p * 1e-4 (p read and a row written each), the rule's kernel (W rows, p
    and m read, p' and m' written) and p' written back into the leaves."""
    return 4 * n * (2 + 2 * W + (W + 4) + 2)


def zero_compute_path(torch, label: str, W: int, fields: dict, warm: int,
                      timed: int, expect: dict, kernels: dict) -> dict:
    """16 (a): ``make_zero_compute_step`` on the full model, each step
    held bitwise against ``exchange_stage`` run by hand on rows filled with
    p * 1e-4 from the same state; the timed steps between two
    synchronizations."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PHubEngine, StackedComm
    tc = path_tc("nesterov", fields.get("wire_format", "identity"),
                 {k: v for k, v in fields.items() if k != "wire_format"})
    engine = PHubEngine(get_arch(ARCH), tc, StackedComm(W), device="cuda")
    (group,) = engine.chunk_plan.groups
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, opt = engine.init_state()
    step = engine.make_zero_compute_step()
    ms, launches = [], {}
    for i in range(warm + timed):
        with torch.no_grad():
            flat0 = engine.client.flatten(model.param_tree())
            opt0 = {k: {n: t.clone() for n, t in d.items()}
                    for k, d in opt.items()}
            rows = engine.grad_buffers()
            for k, v in flat0.items():
                for w in range(W):
                    rows[k][w].copy_(v).mul_(1e-4)
        want_p, want_opt = engine.exchange_stage(rows, flat0, opt0)
        del flat0, opt0
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        model, opt = step(model, opt)
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3
        got = all_launches()
        expect_launches(got, expect, 1, f"zero-compute {label} step {i}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        got_p = engine.client.flatten(model.param_tree())
        same = all(torch.equal(got_p[k], want_p[k]) for k in got_p) and all(
            torch.equal(opt[k][n], want_opt[k][n])
            for k in opt for n in opt[k])
        check(same, f"zero-compute {label} step {i}: p or a slot differs "
                    f"from exchange_stage by hand")
        del got_p, want_p, want_opt
        if i >= warm:
            ms.append(t)
    model_bytes = group.padded * 4
    med = statistics.median(ms)
    note = ""
    if "wire_format" not in fields:
        b = zc_bytes(W, group.padded)
        bound = b / HBM_BYTES_PER_S * 1e3
        kname = "multi_agg_opt_chunks" if W > 1 else "agg_opt_chunks"
        note = (f"; bytes {b / 1e9:.2f} GB, bound {bound:.3f} ms at 3.35 "
                f"TB/s ({bound / med:.1%} of it reached); the rule's kernel "
                f"alone ({kname}, kernel phase) "
                f"{kernels[kname]['ms']:.3f} ms, bound "
                f"{kernels[kname]['bound_ms']:.3f} ms")
    log(f"16 (a) zero-compute {label}: {group.padded:,} elements "
        f"({model_bytes / 1e9:.2f} GB a row), {warm} warm + {timed} timed "
        f"steps, p and every slot bitwise equal to exchange_stage by hand "
        f"after each; ms a step {[round(x, 3) for x in ms]} (median "
        f"{med:.3f}); push+pull {2 * W * model_bytes / 1e9:.2f} GB a step, "
        f"{2 * W * model_bytes / (med / 1e3) / 1e9:.1f} GB/s PS throughput"
        + note + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (the by-hand check's copies included); launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    del model, opt, engine, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": launches}


def calibration_probe_phase(torch, smi: str) -> tuple:
    """16 (b): the three probe flavors on StackedComm(4) at
    CARD_PROBE_ELEMS a row, solved from the card's base topology; then
    the probes once more, back to back, for the spread between two
    calibrations of one card."""
    import tempfile

    from repro_torch.core import StackedComm
    from repro_torch.tuning import (CARD_PROBE_ELEMS, card_base_topology,
                                    run_probe_programs, save_calibration,
                                    solve_topology)
    comm = StackedComm(WORKERS)
    reset_all_launches()
    probe = run_probe_programs(comm, elems=CARD_PROBE_ELEMS, device="cuda")
    launches = all_launches()
    # 2 warm + 5 timed push_pulls a flavor: ring and allreduce one
    # multi_agg_opt_chunks each, int8 the one-window int8 step
    expect_launches(launches, {"multi_agg_opt_chunks": 2, **{
        k: v for k, v in INT8_W4.items()}}, 7, "16 (b) calibration probes")
    out = solve_topology(probe, card_base_topology(comm))
    out["card"] = smi
    reset_all_launches()
    again = solve_topology(run_probe_programs(
        comm, elems=CARD_PROBE_ELEMS, device="cuda"),
        card_base_topology(comm))
    check(all_launches() == launches, "16 (b): the second calibration "
                                      "launched other kernels")
    with tempfile.TemporaryDirectory() as d:
        path = save_calibration(out, os.path.join(d, "calibration_4w.json"))
        saved = json.load(open(path))
    check(saved["base"]["lat_ici"] == saved["base"]["lat_dcn"] == 0.0,
          "the calibration record's base latencies are not 0")
    c = out["constants"]
    log(f"16 (b) calibration on {smi}: {probe['devices']} stacked workers, "
        f"{probe['elems']:,} f32 a row ({probe['elems'] * 4 / 2**30:.2f} "
        f"GiB); probe medians "
        + ", ".join(f"{fl} {f['us'] / 1e3:.3f} ms (reps "
                    f"{[round(x / 1e3, 3) for x in f['us_reps']]})"
                    for fl, f in probe["flavors"].items())
        + f"; solved bw_ici {c['bw_ici']:.6g} B/s, allreduce_factor "
        f"{c['allreduce_factor']:.6g}, bw_codec {c['bw_codec']:.6g} B/s "
        f"(lat_ici = lat_dcn = 0, the base's bandwidths 3.35e12); "
        f"residuals "
        + ", ".join(f"{fl} {r['rel_err']:.4f}"
                    for fl, r in out["residuals"].items())
        + f"; tolerance {out['tolerance']}; calibrated again back to back: "
        + ", ".join(f"{k} {v:.6g} ({v / c[k] - 1:+.2%})"
                    for k, v in again["constants"].items())
        + f", probe medians "
        + ", ".join(f"{fl} {f['us'] / 1e3:.3f} ms"
                    for fl, f in again["probe"]["flavors"].items()))
    return out, launches


def telemetry_launcher_phase(torch, count) -> None:
    """16 (c): ``launch/train.py --telemetry --calibrate --workers 4`` on
    the full model, 3 steps; the port's trace reader on its artifacts;
    then ``--supervise`` over the calibration it saved."""
    import tempfile

    from repro_torch import telemetry
    from repro_torch.launch import trace
    from repro_torch.launch.train import main as train_main
    base = ["--arch", ARCH, "--workers", str(WORKERS), "--steps", "3",
            "--batch", str(BATCH), "--seq", str(SEQ), "--log-every", "1",
            "--device", "cuda"]
    with tempfile.TemporaryDirectory() as d:
        for label, extra, want in (
                ("--telemetry --calibrate", ["--calibrate"],
                 # calibration 14 + 7 x INT8_W4, zero-compute 1 + 3, the
                 # step probe 1 + 3, 3 training steps
                 {"multi_agg_opt_chunks": 14 + 4 + 4 + 3,
                  **{k: 7 * v for k, v in INT8_W4.items()}}),
                ("--telemetry --supervise", ["--supervise"],
                 {"multi_agg_opt_chunks": 4 + 4 + 3, "health_chunks": 3})):
            reset_all_launches()
            t0 = time.perf_counter()
            losses = train_main(base + ["--telemetry", "--telemetry-out", d]
                                + extra)
            took = time.perf_counter() - t0
            launches = all_launches()
            check(not telemetry.enabled(),
                  f"16 (c) {label}: telemetry still on after main")
            check(len(losses) == 3 and all(math.isfinite(x)
                                           for x in losses),
                  f"16 (c) {label}: losses {losses}")
            expect_launches(launches, want, 1, f"16 (c) {label}")
            count(f"launch/train.py {label}", launches)
            records, meta = trace.load_trace(os.path.join(d, "trace.json"))
            issues = trace.validate(records)
            check(issues == [], f"16 (c) {label}: trace malformed {issues}")
            log(f"16 (c) {label}: {took:.1f} s, losses {losses}; the "
                f"trace's breakdown:\n" + trace.render_breakdown(records,
                                                                 meta))
            att = meta["attribution"]
            ag = trace.check_model(records, meta)
            check(ag.get("checked", False),
                  f"16 (c) {label}: model check impossible: {ag}")
            verdict = ("ok" if ag["ok"] else "OUTSIDE TOLERANCE (a "
                       "finding, not a failure)")
            log(f"16 (c) {label}: calibrated {att['calibrated']}, topology "
                f"{att['topology']}; --check-model: measured "
                f"{ag['measured_s'] * 1e3:.3f} ms vs predicted "
                f"{ag['predicted_s'] * 1e3:.3f} ms, ratio {ag['ratio']:.4f} "
                f"in [{ag['band'][0]:.4f}, {ag['band'][1]:.4f}] -> "
                f"{verdict}")
            names = {r.name for r in records}
            if "--supervise" in extra:
                check({"digest", "sync", "dispatch"} <= names
                      and all(r.args.get("supervised") for r in records
                              if r.name == "dispatch"),
                      f"16 (c) {label}: supervisor spans missing: {names}")
            lines = [json.loads(x) for x in open(os.path.join(
                d, "metrics.jsonl"))]
            log(f"16 (c) {label}: {len(records)} spans ({sorted(names)}), "
                f"{len(lines)} metric lines; report.txt:\n"
                + open(os.path.join(d, "report.txt")).read())
    gc.collect()
    torch.cuda.empty_cache()


def telemetry_run(torch, fields: dict, on: bool, keep: bool) -> dict:
    """One fit of TEL_STEPS steps at W=4 from the seed, telemetry on or
    off: losses, step ms, fingerprints, launches (and the slots, if
    ``keep``)."""
    from repro_torch import telemetry
    from repro_torch.configs import get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens
    from repro_torch.training import TrainState, fit
    wire = fields.get("wire_format", "identity")
    tc = path_tc("nesterov", wire,
                 {k: v for k, v in fields.items() if k != "wire_format"})
    cfg = get_arch(ARCH)
    engine = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
    state = TrainState(*engine.init_state())
    data = SyntheticTokens(cfg, BATCH, SEQ, seed=tc.seed)
    step_ms, prints, marks = [], [], []

    def on_step(st, metrics):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - marks[-1]) * 1e3)
        prints.append(fingerprint(torch, st.params))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    if on:
        telemetry.enable(seed=tc.seed)
    try:
        reset_all_launches()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        state = fit(engine, state, data, steps=TEL_STEPS, log_every=0,
                    hooks=[on_step])
        launches = all_launches()
    finally:
        tracer = telemetry.disable()[0]
    out = {"losses": list(state.losses), "ms": step_ms, "prints": prints,
           "launches": launches, "spans": len(tracer.records)}
    if keep:
        out["opt"] = {k: {n: t.clone() for n, t in d.items()}
                      for k, d in state.opt.items()}
    del state, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def telemetry_pair(torch, label: str, fields: dict, expect: dict,
                   count) -> None:
    """16 (d): the same TEL_STEPS steps with telemetry off and on, in the
    order TEL_MODES: the first off and on runs' losses, fingerprints and
    every slot bitwise equal, every run's losses and launches equal; the
    overhead is the median on-step over the median off-step."""
    runs = [telemetry_run(torch, fields, mode == "on", i < 2)
            for i, mode in enumerate(TEL_MODES[:2])]
    off, on = runs
    check(all(torch.equal(on["opt"][k][n], off["opt"][k][n])
              for k in off["opt"] for n in off["opt"][k]),
          f"16 (d) {label}: a slot differs between telemetry on and off")
    del off["opt"], on["opt"]          # the slots' copies, before the rest
    runs += [telemetry_run(torch, fields, mode == "on", False)
             for mode in TEL_MODES[2:]]
    check(off["spans"] == 0 and on["spans"] > 0,
          f"16 (d) {label}: spans off {off['spans']}, on {on['spans']}")
    for r in runs:
        check(r["losses"] == off["losses"] and r["launches"] ==
              off["launches"], f"16 (d) {label}: losses or launches differ "
                               f"between telemetry on and off")
    expect_launches(off["launches"], expect, TEL_STEPS, f"16 (d) {label}")
    for i in range(TEL_STEPS):
        check(same_fingerprint(torch, on["prints"][i], off["prints"][i]),
              f"16 (d) {label}: parameters differ after step {i}")
    ms = {m: [x for r, mm in zip(runs, TEL_MODES) if mm == m for x in r["ms"]]
          for m in ("off", "on")}
    med = {m: statistics.median(v) for m, v in ms.items()}
    log(f"16 (d) telemetry on vs off, {label}: losses {off['losses']}, the "
        f"fingerprint after each step and every slot bitwise equal, "
        f"launches equal ({', '.join(f'{k} {v}' for k, v in off['launches'].items() if v)}); "
        f"{on['spans']} spans a traced run; step ms off "
        f"{[round(x, 3) for x in ms['off']]}, on "
        f"{[round(x, 3) for x in ms['on']]} (runs {'/'.join(TEL_MODES)}); "
        f"median off {med['off']:.3f}, on {med['on']:.3f}: overhead "
        f"{med['on'] / med['off'] - 1:+.4%} (a finding, not a gate)")
    for i, (mode, r) in enumerate(zip(TEL_MODES, runs)):
        count(f"telemetry {mode} (run {i}) {label}", r["launches"])


def telemetry_serve_phase(torch, count) -> None:
    """16 (e): ``launch/serve.py`` on the full llama3.2-1b (B 8, prompt
    2048, 32 tokens) with telemetry off and on: greedy tokens equal,
    launches exact and equal; the span totals and the decode-dispatch
    histogram."""
    import tempfile

    from repro_torch import telemetry
    from repro_torch.configs import get_arch
    from repro_torch.launch import trace
    from repro_torch.launch.serve import main as serve_main
    arch, batch, prompt, steps = SERVE_PATHS[0]
    L = get_arch(arch).n_layers
    want = {"swa_attention_kernel": L,
            "decode_attention_kernel": L * (steps - 1)}
    args = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--decode-steps", str(steps), "--device", "cuda"]
    toks = {}
    with tempfile.TemporaryDirectory() as d:
        for mode, extra in (("off", []),
                            ("on", ["--telemetry", "--telemetry-out", d])):
            reset_all_launches()
            toks[mode] = serve_main(args + extra)
            launches = all_launches()
            check(not telemetry.enabled(), "16 (e): telemetry still on")
            expect_launches(launches, want, 1, f"16 (e) serve {mode}")
            count(f"launch/serve.py telemetry {mode}", launches)
        records, meta = trace.load_trace(os.path.join(d,
                                                      "serve_trace.json"))
        check(trace.validate(records) == [], "16 (e): trace malformed")
        totals = {}
        for r in records:
            if r.depth == 0:
                totals[r.name] = totals.get(r.name, 0.0) + r.dur
        hist = {}
        for line in open(os.path.join(d, "serve_metrics.jsonl")):
            x = json.loads(line)
            hist.setdefault(x["labels"]["phase"], []).append(x["value"])
    check(bool((toks["on"] == toks["off"]).all()),
          "16 (e): greedy tokens differ with telemetry on")
    dd = hist["decode_dispatch"]
    log(f"16 (e) serve {arch} B {batch} prompt {prompt}, {steps} tokens: "
        f"greedy tokens equal with telemetry on and off, launches exact; "
        f"span totals "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in totals.items())
        + f"; serve.latency: prefill {hist['prefill'][0] * 1e3:.3f} ms, "
        f"decode_dispatch count {len(dd)} mean "
        f"{statistics.mean(dd) * 1e3:.3f} ms median "
        f"{statistics.median(dd) * 1e3:.3f} min {min(dd) * 1e3:.3f} max "
        f"{max(dd) * 1e3:.3f}, decode_total "
        f"{hist['decode_total'][0] * 1e3:.3f} ms")


def characterization_phase(torch, count, kernels: dict, smi: str) -> None:
    """16. PHub's characterization (module docstring)."""
    t_phase = time.perf_counter()
    for label, W, fields, warm, timed, expect in ZC_PATHS:
        run = zero_compute_path(torch, label, W, fields, warm, timed,
                                expect, kernels)
        count(f"zero-compute {label}", run["launches"])
    _, launches = calibration_probe_phase(torch, smi)
    for run in (0, 1):
        count(f"calibration probes (run {run})", launches)
    telemetry_launcher_phase(torch, count)
    telemetry_pair(torch, "W=4", {}, {"multi_agg_opt_chunks": 1}, count)
    telemetry_pair(torch, f"int8 W=4 in {WINDOWS_W4} windows",
                   dict(wire_format="int8", pipeline_windows=WINDOWS_W4),
                   INT8_W4_WINDOWS, count)
    telemetry_serve_phase(torch, count)
    log(f"16. the characterization phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# 17. the other model families (module docstring): the kernels at the new
# shapes (arch, window, batch, tokens before decode, decode tokens), the
# frontends' prefix ahead of a 512-token prompt
HYMBA, GROK, ARCTIC = "hymba-1.5b", "grok-1-314b", "arctic-480b"
FRONTENDS = ("internvl2-2b", "musicgen-medium")
FRONTEND_PROMPT, FRONTEND_LAYERS, FRONTEND_TOKENS = 512, 4, 8
FAMILY_SHAPES = (
    (HYMBA, 1024, 8, 2048, 32), (f"{HYMBA} global", 0, 8, 2048, 32),
    ("musicgen-medium", 0, 8, 256 + FRONTEND_PROMPT, FRONTEND_TOKENS),
    ("internvl2-2b", 0, 8, 256 + FRONTEND_PROMPT, FRONTEND_TOKENS),
    (GROK, 0, 8, 2048, 16), (ARCTIC, 0, 8, 2048, 16))
MOE_LAYERS = 1                   # grok and arctic: full width, one layer
ARCTIC_TRAIN_EXPERTS = 32        # arctic training: 128 experts do not fit
B1_STRIP = 1 << 24               # elements of each strip B1 is held on
FAMILY_REF_SEQ = 64              # reduced card-vs-CPU checks: tokens
FAMILY_REF_PROMPT = 40           #   and the serving prompt


def family_cfg(arch: str, heads=None):
    """The reduced config of a card-vs-CPU check at f32 activations (the
    two devices' results then differ by summation order only, so a
    router's choice cannot flip on a bf16 rounding): the experts at
    capacity factor 0.5 (every layer drops assignments), the hybrid at 4
    layers with windows [0, 64, 64, 0] and, with ``heads`` (nh, kv), at
    d_model 320 with hymba's 5 query heads a KV head."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    cfg = get_arch(arch)
    if cfg.family == "hybrid":
        d = 320 if heads else 256
        cfg = dataclasses.replace(reduced(cfg, layers=4, d_model=d),
                                  global_layer_every=3)
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=heads[0],
                                      n_kv_heads=heads[1],
                                      head_dim=d // heads[0])
    else:
        cfg = reduced(cfg)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    return dataclasses.replace(cfg, dtype="float32")


def family_reference_phase(torch, label: str, cfg) -> None:
    """A reduced config: one 2-worker Nesterov step and a prefill plus 4
    teacher-forced decode steps on the card (kernels) and on the CPU
    (plain versions) from one parameter tree and one batch (a frontend's
    prefix drawn on the CPU and copied), within the bounds of the earlier
    phases (``reference_phase``, ``serve_reference_phase``); the card's
    step and serving run twice and must give the same bits (the experts'
    scatter and gather included)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import PrefixedTokens, SyntheticTokens
    from repro_torch.models import DecoderLM

    W, L = 2, cfg.n_layers
    tc = TrainConfig(loss_chunk=64)
    eng_c = PHubEngine(cfg, tc, StackedComm(W), device="cpu")
    eng_g = PHubEngine(cfg, tc, StackedComm(W), device="cuda")
    model_c, opt_c = eng_c.init_state()
    init = tree_to(model_c.param_tree(), "cpu")
    data = (PrefixedTokens if cfg.frontend else SyntheticTokens)(
        cfg, BATCH, FAMILY_REF_SEQ, seed=0)
    batch_c = data.torch_batch(0, "cpu")
    batch_g = {k: v.to("cuda") for k, v in batch_c.items()}
    reset_all_launches()
    runs = []
    for _ in range(2):
        model_g = DecoderLM(cfg, device="cuda", params=tree_to(init, "cuda"))
        _, opt_g, met_g = eng_g.make_train_step()(model_g, eng_g.init_opt(),
                                                  batch_g)
        runs.append((model_g, opt_g, met_g))
    expect_launches(all_launches(), {"multi_agg_opt_chunks": 2}, 1,
                    f"reduced {label} step, twice")
    _, opt_c, met_c = eng_c.make_train_step()(model_c, opt_c, batch_c)
    (ma, oa, mea), (mb, ob, meb) = runs
    same = torch.equal(mea["loss"], meb["loss"]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            leaf_paths(ma.param_tree()), leaf_paths(mb.param_tree())))
    same &= all(torch.equal(oa[k][n], ob[k][n]) for k in oa for n in oa[k])
    dloss = abs(float(met_c["loss"]) - float(mea["loss"]))
    dparam = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for (_, a), (_, b) in zip(leaf_paths(ma.param_tree()),
                                           leaf_paths(model_c.param_tree())))
    dmom = max(float((oa[k]["m"].cpu() - opt_c[k]["m"]).abs().max())
               for k in oa)
    log(f"reduced {label} (d_model {cfg.d_model}, {L} layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, f32 activations"
        f"{f', {cfg.n_experts} experts top-{cfg.top_k} at capacity factor {cfg.capacity_factor}' if cfg.n_experts else ''}"
        f"{f', a prefix of {cfg.frontend_tokens}' if cfg.frontend else ''}"
        f"), {W} workers, 1 Nesterov step, card vs CPU: loss "
        f"{float(mea['loss']):.6f} |dloss| {dloss:.3e}, max |dparam| "
        f"{dparam:.3e}, max |dm| {dmom:.3e}; two card runs bitwise equal "
        f"(loss, parameters, slots): {same}")
    check(same, f"reduced {label}: two card steps differ")
    check(dloss <= 1e-3 and dparam <= 1e-4 and dmom <= 1e-2,
          f"reduced {label}: card step differs from the CPU step: loss "
          f"{dloss}, params {dparam}, momentum {dmom}")
    del runs, ma, mb, oa, ob, opt_c

    # serving: prefill (after the prefix) + teacher-forced decode steps
    steps, prompt = 4, FAMILY_REF_PROMPT
    tok = torch.from_numpy(SyntheticTokens(cfg, 2, prompt + steps, seed=7)
                           .batch_at(0)["tokens"]).long()
    extra = (PrefixedTokens(cfg, 2, prompt, seed=7).torch_batch(
        0, "cpu")["extra_embeds"] if cfg.frontend else None)

    def serve(engine, model, device):
        logits, cache = engine.make_prefill_step(prompt, steps)(
            model, tok[:, :prompt].to(device),
            None if extra is None else extra.to(device))
        out = [logits.cpu()]
        step = engine.make_serve_step()
        for i in range(steps):
            logits, cache = step(model, cache,
                                 tok[:, prompt + i:prompt + i + 1].to(device))
            out.append(logits.cpu())
        return out, cache

    eng_c1 = PHubEngine(cfg, tc, StackedComm(1), device="cpu")
    eng_g1 = PHubEngine(cfg, tc, StackedComm(1), device="cuda")
    model_c = DecoderLM(cfg, device="cpu", params=tree_to(init, "cpu"))
    model_g = DecoderLM(cfg, device="cuda", params=tree_to(init, "cuda"))
    want, cache_c = serve(eng_c1, model_c, "cpu")
    reset_all_launches()
    got, cache_g = serve(eng_g1, model_g, "cuda")
    again, _ = serve(eng_g1, model_g, "cuda")
    expect_launches(all_launches(), {"swa_attention_kernel": 2 * L,
                                     "decode_attention_kernel":
                                         2 * L * steps}, 1,
                    f"reduced {label} serving, twice")
    rels = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    same_pos = torch.equal(cache_g["pos"].cpu(), cache_c["pos"])
    note = ""
    if "ssm_S" in cache_g:
        s_rel = float((cache_g["ssm_S"].cpu() - cache_c["ssm_S"]).abs().max()
                      / cache_c["ssm_S"].abs().max())
        note = (f", ssm_S {cache_g['ssm_S'].dtype} card vs CPU "
                f"{s_rel:.3e}")
        check(cache_g["ssm_S"].dtype == torch.float32 and s_rel <= SERVE_TOL,
              f"reduced {label}: ssm_S {s_rel}")
    log(f"  reduced {label} serving (prompt {prompt}"
        f"{f' after a prefix of {cfg.frontend_tokens}' if cfg.frontend else ''}"
        f", {steps} decode steps), card vs CPU: max |dlogits| / max |logits| "
        f"prefill {rels[0]:.3e}, decode "
        f"{', '.join(f'{r:.3e}' for r in rels[1:])}; cache pos equal "
        f"{same_pos}{note}; two card runs bitwise equal: {same}")
    check(max(rels) <= SERVE_TOL and same_pos and same,
          f"reduced {label} serving: {rels}, pos {same_pos}, bitwise {same}")


def family_attention_phase(torch, kernels: dict) -> None:
    """B9 and B10 at the new families' shapes (FAMILY_SHAPES), each within
    its tolerance, timed beside its bound and SDPA; the entries go under
    the kernels' ``families``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import cache_capacity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    for label, w, B, T, steps in FAMILY_SHAPES:
        cfg = get_arch(label.split()[0])
        swa_e, dec_e = attention_at(
            torch, randn, label, B, T, steps, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, w, cache_capacity(cfg, T + steps))
        for name, e in (("swa_attention_kernel", swa_e),
                        ("decode_attention_kernel", dec_e)):
            kernels[name].setdefault("families", {})[label] = e


def family_b1_phase(torch, kernels: dict) -> None:
    """agg_opt_chunks on grok-1-314b's one-layer W=1 domain, the row the
    grok training path updates (bf16, the largest any kernel sees): p, g,
    m drawn on the card, p' into a given buffer and m in place, held
    bitwise against the plain version on a strip at the row's start and
    one at its far end (offsets past 2^32 elements), timed beside the
    row's bytes bound (the plain version on a strip: the whole row's
    temporaries would not fit beside it)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.kernels.agg_opt import agg_opt_ref, fused_agg_opt

    cfg = dataclasses.replace(get_arch(GROK), n_layers=MOE_LAYERS)
    tc = path_tc("nesterov", "identity", dict(flat_residency=True))
    (group,) = PHubEngine(cfg, tc, StackedComm(1),
                          device="cuda").chunk_plan.groups
    n, ce, dt = group.padded, group.chunk_elems, group.dtype
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    log(f"agg_opt_chunks on grok-1-314b's row: {n:,} {dt} elements "
        f"({group.n_chunks:,} chunks of {ce}), {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated before")
    p = torch.empty(n, dtype=dt, device="cuda").normal_(0, 0.02,
                                                        generator=gen)
    g = torch.empty(n, dtype=dt, device="cuda").normal_(0, 1e-3,
                                                        generator=gen)
    m = torch.empty(n, dtype=dt, device="cuda").normal_(0, 1e-3,
                                                        generator=gen)
    p_out = torch.empty_like(p)
    strips = ((0, B1_STRIP), (n - B1_STRIP, n))
    m0 = [m[lo:hi].clone() for lo, hi in strips]
    fused_agg_opt(p, g, m, lr=tc.lr, momentum=tc.momentum, chunk_elems=ce,
                  p_out=p_out)
    torch.cuda.synchronize()
    worst = 0
    for (lo, hi), mm in zip(strips, m0):
        want = agg_opt_ref(p[lo:hi], g[lo:hi], mm, lr=tc.lr,
                           momentum=tc.momentum)
        err, ulp = compare(torch, (p_out[lo:hi], m[lo:hi]), want)
        worst = max(worst, ulp)
        log(f"  strip [{lo:,}, {hi:,}): max_abs {err:.3e} max_ulp {ulp}")
    check(worst == 0, f"agg_opt_chunks on grok's row differs from its "
                      f"plain version (max_ulp {worst})")
    ms = median_ms(torch, lambda: fused_agg_opt(
        p, g, m, lr=tc.lr, momentum=tc.momentum, chunk_elems=ce,
        p_out=p_out), reps=5, warmup=1)
    lo, hi = strips[1]
    plain_strip_ms = median_ms(torch, lambda: agg_opt_ref(
        p[lo:hi], g[lo:hi], m[lo:hi], lr=tc.lr, momentum=tc.momentum), 5)
    n_bytes = 5 * p.element_size()
    bound_ms, bound_by = bound(n, n_bytes, 7)
    log(f"agg_opt_chunks on grok-1-314b's row: kernel {ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}, {n * n_bytes / 1e9:.2f} GB; "
        f"{100 * bound_ms / ms:.1f}% of it); plain version on a strip of "
        f"{B1_STRIP:,} {plain_strip_ms:.3f} ms ({plain_strip_ms * n / B1_STRIP:.1f} ms "
        f"scaled to the row)")
    kernels["agg_opt_chunks"]["grok_row"] = {
        "elements": n, "dtype": str(dt), "max_ulp": worst, "ms": ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "plain_strip_ms": plain_strip_ms, "plain_strip": B1_STRIP}
    del p, g, m, p_out, m0
    gc.collect()
    torch.cuda.empty_cache()


def families_phase(torch, count, kernels: dict) -> None:
    """17. The other model families (module docstring)."""
    t_phase = time.perf_counter()
    family_attention_phase(torch, kernels)
    family_b1_phase(torch, kernels)
    for arch in (GROK, ARCTIC, HYMBA) + FRONTENDS:
        family_reference_phase(torch, arch, family_cfg(arch))
    family_reference_phase(torch, f"{HYMBA} heads 10/2",
                           family_cfg(HYMBA, heads=(10, 2)))
    t_ref = time.perf_counter()

    flat = dict(flat_residency=True)
    nesterov = {"multi_agg_opt_chunks": 1}
    # (label, workers, steps, rule, launches a step, arch, pipeline,
    # layers, config fields)
    train = (
        ("W=4", WORKERS, 2, "nesterov", nesterov, HYMBA, None, 0, None),
        ("W=4", WORKERS, 1, "adam", {"adam_opt_chunks": 1}, HYMBA, None, 0,
         None),
        (f"W=1 flat, {MOE_LAYERS} layer", 1, 2, "nesterov",
         {"agg_opt_chunks": 1}, GROK, flat, MOE_LAYERS, None),
        (f"W=2 flat, {MOE_LAYERS} layer, {ARCTIC_TRAIN_EXPERTS} experts", 2,
         2, "nesterov", nesterov, ARCTIC, flat, MOE_LAYERS,
         dict(n_experts=ARCTIC_TRAIN_EXPERTS)),
    ) + tuple((f"W=4, {FRONTEND_LAYERS} layers", WORKERS, 1, "nesterov",
               nesterov, a, None, FRONTEND_LAYERS, None) for a in FRONTENDS)
    for label, W, steps, rule, expect, arch, pipe, layers, fields in train:
        run = main_path(torch, W, steps, expect, rule, pipeline=pipe,
                        arch=arch, layers=layers, cfg_fields=fields)
        count(f"{arch} {rule} {label}", run["launches"])
        log(f"{arch} {rule} {label}: losses {run['losses']}, step ms "
            f"{[round(x, 3) for x in run['step_ms']]}, tokens/s "
            f"{[round(BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]}, "
            f"peak GiB {[round(x, 3) for x in run['peak_gib']]}")
    t_train = time.perf_counter()
    serve = ((HYMBA, 8, 2048, 32, 0), (GROK, 8, 2048, 16, MOE_LAYERS),
             (ARCTIC, 8, 2048, 16, MOE_LAYERS)) + tuple(
        (a, 8, FRONTEND_PROMPT, FRONTEND_TOKENS, FRONTEND_LAYERS)
        for a in FRONTENDS)
    for arch, batch, prompt, steps, layers in serve:
        count(f"serve {arch}", serve_path(torch, arch, batch, prompt, steps,
                                          layers=layers))
    log(f"17. the families phase took {time.perf_counter() - t_phase:.1f} s "
        f"(kernels and reduced checks {t_ref - t_phase:.1f}, training "
        f"{t_train - t_ref:.1f}, serving "
        f"{time.perf_counter() - t_train:.1f})")


# 18. weight decay through the rule kernels, gradient accumulation and
# the fsdp_stream strategy (module docstring)
DECAYS = (1e-4, 0.1)             # the decay coefficients the kernels take
DECAY_N = 8192 * 37 + 100        # the small cases: a ragged length
FSDP = dict(strategy="fsdp_stream")
FSDP_PARAM_ATOL, FSDP_LOSS_ATOL = 2e-4, 3e-4    # check_engine.py's bounds
# (label, steps, rule, TrainConfig fields, launches a step (None: one
# agg_opt_chunks a leaf, the fsdp_stream update))
DECAY_PATHS = (
    ("decay 0.1 W=4", 3, "nesterov", dict(weight_decay=0.1),
     {"multi_agg_opt_chunks": 1}),
    ("decay 0.1 W=4", 2, "adam", dict(weight_decay=0.1),
     {"adam_opt_chunks": 1}),
    (f"decay 0.1 int8 windows {WINDOWS_W4} W=4", 2, "nesterov",
     dict(weight_decay=0.1, wire_format="int8",
          pipeline_windows=WINDOWS_W4), None),
    ("microbatch 2 W=4", 2, "nesterov", dict(microbatch=2),
     {"multi_agg_opt_chunks": 1}),
    ("fsdp_stream W=4", STEPS, "nesterov", FSDP, None),
)
# the reduced card-vs-CPU cases: (rule, TrainConfig fields)
DECAY_REF_CASES = (
    ("nesterov", dict(weight_decay=0.1)), ("adam", dict(weight_decay=0.1)),
    ("nesterov", dict(microbatch=2)),
    ("nesterov", dict(FSDP, weight_decay=0.1)),
    ("adam", dict(FSDP, weight_decay=0.1)),
)


def decay_small_cases(torch, lr: float, mu: float, ce: int) -> dict:
    """B1, B2, B4 and B7 with decay against their plain versions, bitwise:
    f32 and bf16, a ragged length, NaN and Inf in p and g, the stacked g a
    strip of a wider buffer read in place (rows 4096 elements further
    apart), the windowed form (p' into a given buffer, the slots in
    place), B7 on a window's strip of every shard.  {kernel: worst ulp}."""
    from repro_torch.core.pipeline import own_strips
    from repro_torch.kernels.agg_opt import ops
    from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                                 dequant_agg_opt_ref,
                                                 multi_agg_opt_ref)
    from repro_torch.kernels.quant import quantize_int8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    n, W, lo = DECAY_N, WORKERS, 1024
    worst = {k: 0 for k in ("agg_opt_chunks", "multi_agg_opt_chunks",
                            "adam_opt_chunks", "dequant_agg_opt_chunks")}

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(dtype)

    def hold(name, got, want, what):
        err, ulp = compare(torch, got, want)
        worst[name] = max(worst[name], ulp)
        check(ulp == 0, f"{name} with decay ({what}) differs from its "
                        f"plain version (max_ulp {ulp})")

    for dtype in (torch.float32, torch.bfloat16):
        for wd in DECAYS:
            what = f"{dtype}, wd {wd}"
            p, m = rnd(n, dtype=dtype), rnd(n, dtype=dtype)
            p[5], p[17], p[101] = float("nan"), float("inf"), -float("inf")
            # rows of whole 16-byte vectors in bf16 too, lo + 4096 wider
            buf = rnd(W, -(-n // 64) * 64 + lo + 4096, scale=1e-2,
                      dtype=dtype)
            buf[:, lo::7] = 0
            buf[2, lo + 23] = float("inf")
            g = buf[:, lo:lo + n]
            kw = dict(lr=lr, momentum=mu, weight_decay=wd)
            hold("agg_opt_chunks", ops.fused_agg_opt(p, g[0], m, **kw),
                 agg_opt_ref(p, g[0], m, **kw), what)
            hold("multi_agg_opt_chunks",
                 ops.fused_multi_agg_opt(p, g, m, **kw),
                 multi_agg_opt_ref(p, g, m, **kw), what + ", strip")
            # the windowed form: p' into a given buffer, m in place
            po, mi = torch.empty_like(p), m.clone()
            ops.fused_multi_agg_opt(p, g, mi, p_out=po, chunk_elems=ce,
                                    divisor=torch.tensor([3.0], device=dev),
                                    **kw)
            hold("multi_agg_opt_chunks", (po, mi), multi_agg_opt_ref(
                p, g, m, divisor=torch.tensor([3.0], device=dev), **kw),
                what + ", p_out, divisor 3")
            v, k1, k2 = (rnd(n, dtype=dtype).abs(),
                         torch.rand(n, device=dev, generator=gen),
                         torch.rand(n, device=dev, generator=gen))
            k1[::5] = 0
            akw = dict(lr=ADAM_LR, eps=1e-8, weight_decay=wd)
            for gg, label in ((g[0], "W=1"), (g, "W=4 strip")):
                want = adam_opt_ref(p, gg, m, v, k1, k2, **akw)
                slots = [t.clone() for t in (m, v, k1, k2)]
                got = ops.fused_adam_opt(p, gg, *slots, **akw)
                hold("adam_opt_chunks", got, want, f"{what}, {label}")
            # B7 on window 1 of 2 of every shard of S = 4, in place
            S, L = W, 4 * ce
            Lw = L // 2
            pd, md = rnd(S * L, dtype=dtype), rnd(S * L, dtype=dtype)
            pd[3] = float("inf")
            own_buf = rnd(S, S * L, scale=1e-2, dtype=dtype)
            strip = lambda t: t.view(S, L)[:, Lw:]        # noqa: E731
            own = own_strips(own_buf, 2, 1)
            q, sc = quantize_int8(rnd(S * Lw, scale=1e-2), chunk_elems=ce)
            for div in (None, torch.tensor([3.0], device=dev)):
                dkw = dict(lr=lr, momentum=mu, inv_n=1 / S, chunk_elems=ce,
                           divisor=div, weight_decay=wd)
                want = dequant_agg_opt_ref(strip(pd), q, sc, own, strip(md),
                                           **dkw)
                po, mi = torch.empty_like(pd), md.clone()
                ops.fused_dequant_agg_opt(strip(pd), q, sc, own, strip(mi),
                                          p_out=strip(po), **dkw)
                hold("dequant_agg_opt_chunks", (strip(po), strip(mi)), want,
                     f"{what}, window strip, divisor {div is not None}")
    torch.cuda.synchronize()
    log(f"18a. B1, B2, B4 and B7 with decay {DECAYS} bitwise against their "
        f"plain versions: f32 and bf16, n {DECAY_N} (ragged), NaN/Inf in p "
        f"and g, g a strip of a wider buffer, the windowed form, B7 on a "
        f"window strip of 4 shards, inv_n and divisor 3")
    return worst


def decay_kernel_phase(torch, padded: dict, ce: int, lr: float, mu: float,
                       kernels: dict) -> None:
    """18a. The four kernels with decay: the small bitwise cases, then at
    the main paths' shapes B1 and B2 with decay 0.1 bitwise against their
    plain versions, and each kernel timed with and without decay in this
    call, interleaved (off, on, on, off; CUDA events, median of 10 each).
    The bound does not move: p is read already."""
    from repro_torch.kernels.agg_opt import ops
    from repro_torch.kernels.agg_opt.ref import agg_opt_ref, multi_agg_opt_ref
    from repro_torch.kernels.quant import quantize_int8
    worst = decay_small_cases(torch, lr, mu, ce)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(180)
    nw, n1 = padded[WORKERS], padded[1]

    def normal(*shape, std):
        return torch.empty(*shape, device=dev).normal_(0, std, generator=gen)

    def timed(name, fn):
        """fn(wd) timed off, on, on, off: (ms without, ms with decay)."""
        off, on = [], []
        for wd in (0.0, 0.1, 0.1, 0.0):
            (on if wd else off).append(median_ms(torch, lambda: fn(wd),
                                                 reps=10))
        kernels[name].update(decay_ms=statistics.median(on),
                             nodecay_ms_same_call=statistics.median(off),
                             decay_max_ulp=worst[name])
        log(f"18a. {name}: {statistics.median(off):.3f} ms without decay, "
            f"{statistics.median(on):.3f} ms with decay 0.1 (runs "
            f"{[round(x, 3) for x in off]} / {[round(x, 3) for x in on]}); "
            f"{(statistics.median(on) / statistics.median(off) - 1) * 100:+.2f}%"
            f"; the row's {kernels[name]['ms']:.3f} ms, bound "
            f"{kernels[name]['bound_ms']:.3f} ms")

    p, m = normal(nw, std=0.02), normal(nw, std=1e-3)
    g = normal(WORKERS, nw, std=1e-3)
    kw = dict(lr=lr, momentum=mu, weight_decay=0.1)
    for name, kern, plain, gg, pp, mm in (
            ("agg_opt_chunks", ops.fused_agg_opt, agg_opt_ref, g[0, :n1],
             p[:n1], m[:n1]),
            ("multi_agg_opt_chunks", ops.fused_multi_agg_opt,
             multi_agg_opt_ref, g, p, m)):
        got = kern(pp, gg, mm, **kw)
        want = plain(pp, gg, mm, **kw)
        err, ulp = compare(torch, got, want)
        del got, want
        check(ulp == 0, f"{name} with decay 0.1 at {tuple(gg.shape)} differs "
                        f"from its plain version (max_ulp {ulp})")
        log(f"18a. {name} with decay 0.1, g {tuple(gg.shape)} f32: max_abs "
            f"{err:.3e} max_ulp {ulp}")
        gc.collect()
        torch.cuda.empty_cache()
        timed(name, lambda wd, kern=kern, pp=pp, gg=gg, mm=mm: kern(
            pp, gg, mm, lr=lr, momentum=mu, weight_decay=wd))
    # B7 over the whole W=4 domain, the owners' rows on g's block diagonal
    q, sc = quantize_int8(g[1], chunk_elems=ce)
    po = torch.empty_like(p)
    timed("dequant_agg_opt_chunks", lambda wd: ops.fused_dequant_agg_opt(
        p, q, sc, g, m, lr=lr, momentum=mu, inv_n=1 / WORKERS,
        chunk_elems=ce, p_out=po, weight_decay=wd))
    del q, sc, po, m
    gc.collect()
    torch.cuda.empty_cache()
    # B4 at W=4, the slots in place (their values do not matter to time)
    slots = [normal(nw, std=1e-3), normal(nw, std=1e-3).abs(),
             torch.full((nw,), 0.1, device=dev),
             torch.full((nw,), 1e-3, device=dev)]
    po = torch.empty_like(p)
    timed("adam_opt_chunks", lambda wd: ops.fused_adam_opt(
        p, g, *slots, lr=ADAM_LR, p_out=po, weight_decay=wd))
    del p, g, slots, po
    gc.collect()
    torch.cuda.empty_cache()


def decay_reference_phase(torch, rule: str, fields: dict) -> None:
    """18d. One 4-worker step of a reduced llama3.2-1b with ``fields``
    (decay, microbatch, fsdp_stream): the card twice (bitwise equal) and
    the CPU once (plain versions), from the same weights, within the
    earlier phases' bounds (loss 1e-3; Nesterov parameters 1e-4 and
    momentum 1e-2; Adam at eps 1e-3 within lr * |dg| / eps)."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM
    cfg = reduced(get_arch(ARCH))
    kw = dict(loss_chunk=64, **fields)
    if rule == "adam":
        kw.update(optimizer="adam", lr=ADAM_LR, adam_eps=ADAM_REF_EPS)
    tc = TrainConfig(**kw)
    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    out = []                    # the CPU's run, then the card's two
    init = None
    for dev in ("cpu", "cuda", "cuda"):
        eng = PHubEngine(cfg, tc, StackedComm(WORKERS), device=dev)
        if init is None:
            model, opt = eng.init_state()
            init = tree_to(model.param_tree(), "cpu")
        else:
            model = DecoderLM(cfg, device=dev, params=tree_to(init, dev))
            opt = eng.init_opt()
        model, opt, met = eng.make_train_step()(model, opt,
                                                 data.torch_batch(0, dev))
        # Nesterov's and Adam's m: {dtype: {"m": rows}}, or fsdp_stream's
        # {"m": tree}
        moms = [t for p, t in leaf_paths(opt)
                if p.startswith("['m']") or p.endswith("['m']")]
        out.append(
            (float(met["loss"]),
             [t.detach().to("cpu", copy=True)
              for _, t in leaf_paths(model.param_tree())],
             [t.to("cpu", copy=True) for t in moms]))
    (l_c, p_c, m_c), (l_g, p_g, m_g), (l_g2, p_g2, m_g2) = out
    same = l_g == l_g2 and all(torch.equal(a, b) for a, b in
                               zip(p_g + m_g, p_g2 + m_g2))
    check(same, f"reduced {rule} {fields}: two card steps differ")
    dloss = abs(l_g - l_c)
    dparam = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c))
    dmom = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(m_g, m_c))
    log(f"18d. reduced {ARCH} {WORKERS} workers, {rule} {fields}, card vs "
        f"CPU: |dloss| {dloss:.3e}, max |dparam| {dparam:.3e}, max |dm| "
        f"{dmom:.3e}; two card runs bitwise: {same}")
    check(dloss <= 1e-3, f"card loss differs from CPU loss by {dloss}")
    if rule == "nesterov":
        check(dparam <= 1e-4 and dmom <= 1e-2,
              f"card step differs from CPU step: params {dparam}, "
              f"momentum {dmom}")
        return
    dg = dmom / (1 - tc.adam_b1)
    lim = tc.lr * dg / tc.adam_eps * 1.01 + 1e-6
    check(dg <= 1e-2 and dparam <= lim,
          f"card Adam step differs from CPU step: params {dparam} > {lim}")


def decay_phase(torch, count, kernels: dict, runs: dict, padded: dict,
                ce: int, smi: str) -> None:
    """18. Weight decay, gradient accumulation and fsdp_stream (module
    docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import param_specs
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.configs import TrainConfig
    t_phase = time.perf_counter()
    tc = TrainConfig()
    decay_kernel_phase(torch, padded, ce, tc.lr, tc.momentum, kernels)
    t_kern = time.perf_counter()
    leaves = {a: len(leaf_paths(param_specs(get_arch(a))))
              for a in (ARCH, SSM_ARCH)}
    mono = runs["nesterov W=4"]
    for label, steps, rule, fields, expect in DECAY_PATHS:
        fields = dict(fields)
        wire = fields.pop("wire_format", "identity")
        if expect is None:
            expect = (INT8_W4_WINDOWS if wire == "int8"
                      else {"agg_opt_chunks": leaves[ARCH]})
        run = main_path(torch, WORKERS, steps, expect, rule, wire,
                        pipeline=fields)
        again = main_path(torch, WORKERS, 1, expect, rule, wire,
                          pipeline=fields)
        key = f"{rule} {label}"
        count(key, run["launches"])
        count(key + " (again)", again["launches"])
        check(again["losses"][0] == run["losses"][0]
              and same_fingerprint(torch, again["prints"][0],
                                   run["prints"][0]),
              f"{key}: a second run's first step differs")
        runs[key] = run
        log(f"18b. {key}: losses {run['losses']}, step ms "
            f"{[round(x, 3) for x in run['step_ms']]}, tokens/s "
            f"{[round(BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]}, "
            f"peak GiB {[round(x, 3) for x in run['peak_gib']]}; a second "
            f"run's first step bitwise equal ({again['step_ms'][0]:.1f} ms)")
    fs = runs[f"nesterov fsdp_stream W=4"]
    dloss = max(abs(a - b) for a, b in zip(fs["losses"], mono["losses"]))
    dparam = max(float((xa - xb).abs().max())
                 for (_, _, _, xa), (_, _, _, xb) in
                 zip(fs["prints"][0], mono["prints"][0]))
    bitwise = all(same_fingerprint(torch, a, b)
                  for a, b in zip(fs["prints"], mono["prints"]))
    log(f"18b. fsdp_stream W=4 against the sharded_ps W=4 path of this call "
        f"(nesterov W=4): |dloss| {dloss:.3e} over {STEPS} steps, sampled "
        f"|dparam| after step 0 {dparam:.3e}, every step bitwise: {bitwise};"
        f" step ms {[round(x, 3) for x in fs['step_ms']]} against "
        f"{[round(x, 3) for x in mono['step_ms']]}, peak GiB "
        f"{[round(x, 3) for x in fs['peak_gib']]} against "
        f"{[round(x, 3) for x in mono['peak_gib']]} ({smi})")
    check(dloss <= FSDP_LOSS_ATOL and dparam <= FSDP_PARAM_ATOL,
          f"fsdp_stream W=4 differs from sharded_ps W=4: loss {dloss}, "
          f"params {dparam}")
    t_llama = time.perf_counter()
    # rwkv6-3b at W=4: its sharded_ps exchange rows do not fit the card
    run = main_path(torch, WORKERS, 2, {"agg_opt_chunks": leaves[SSM_ARCH]},
                    "nesterov", pipeline=FSDP, arch=SSM_ARCH)
    count(f"{SSM_ARCH} nesterov fsdp_stream W=4", run["launches"])
    log(f"18c. {SSM_ARCH} fsdp_stream W=4: loss {run['losses']}, step ms "
        f"{[round(x, 3) for x in run['step_ms']]}, tokens/s "
        f"{[round(BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]}, peak "
        f"GiB {[round(x, 3) for x in run['peak_gib']]} ({smi})")
    t_rwkv = time.perf_counter()
    for rule, fields in DECAY_REF_CASES:
        decay_reference_phase(torch, rule, fields)
    log(f"18. the decay/microbatch/fsdp_stream phase took "
        f"{time.perf_counter() - t_phase:.1f} s (kernels "
        f"{t_kern - t_phase:.1f}, llama paths {t_llama - t_kern:.1f}, "
        f"{SSM_ARCH} {t_rwkv - t_llama:.1f}, reduced checks "
        f"{time.perf_counter() - t_rwkv:.1f})")


# 19. the exchange autotuner (module docstring): the full llama3.2-1b W=4
# space on this card's calibration, the top candidates and the incumbent
# timed and every timed candidate linted, the cache, --auto-tune
TUNE_SPACE_W4 = 111              # the reference's count at 4 devices
TUNE_TOP_K, TUNE_WARMUP, TUNE_STEPS = 3, 2, 5
TUNE_TRAIN_STEPS = 2
# timed and linted whatever the ranking says (its predictions tie within
# 0.1 us, so a pick from it follows the calibration's noise): int8 at
# 64 KB, whose shard of full llama3.2-1b splits into 3 of the 4 windows
# asked (no chunk size of the space gives 4: 8 and 32 KB give 1), and
# hierarchical 2x2 over the identity wire, B2 through its pod stride
TUNE_PINNED = (("sharded_ps", 4, "int8", None, 64 * 1024, 1, 4),
               ("hierarchical", 1, "identity", None, 32 * 1024, 2, 2))
TUNE_INT8_WINDOWS = 3
TUNE_KERNELS = ("multi_agg_opt_chunks", "quantize_chunks",
                "dequantize_chunks", "dequant_agg_opt_chunks")


def tune_label(c) -> str:
    return (f"{c.strategy} W={c.pipeline_windows} wire={c.wire_format}/"
            f"{c.wire_format_dcn or '-'} chunk={c.chunk_size_bytes // 1024}KB"
            f" {c.pods}x{c.data}")


def tune_train(torch, args: list) -> tuple:
    """``launch/train.py`` on ``args``: (losses, the parameters'
    fingerprint after its last step, launches), ``fit``'s final state
    caught on its way out."""
    import repro_torch.training as training
    from repro_torch.launch.train import main as train_main
    real_fit, states = training.fit, []

    def fit(*a, **k):
        state = real_fit(*a, **k)
        states.append(fingerprint(torch, state.params))
        return state
    training.fit = fit
    reset_all_launches()
    try:
        losses = train_main(args)
    finally:
        training.fit = real_fit
    launches = all_launches()
    gc.collect()
    torch.cuda.empty_cache()
    return losses, states[-1], launches


def tune_phase(torch, count, smi: str) -> None:
    """19. The exchange autotuner (module docstring)."""
    import tempfile

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core.chunking import build_plan
    from repro_torch.core.pipeline import effective_windows
    from repro_torch.launch.tune import calibrate_topology
    from repro_torch.models import param_specs
    from repro_torch.tuning import (Candidate, autotune, enumerate_space,
                                    lint_candidate, rank_candidates,
                                    time_candidate)
    from repro_torch.tuning.tuner import _incumbent
    t_phase = time.perf_counter()
    like = param_specs(get_arch(ARCH))
    tc = TrainConfig()
    total = {}

    def tally(label, launches):
        count(label, launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as d:
        # (a) this card's topology at W=4, saved beside the cache
        reset_all_launches()
        t0 = time.perf_counter()
        topo = calibrate_topology(WORKERS, "cuda", d, say=log)
        tally("19 calibration probes", all_launches())
        t_cal = time.perf_counter() - t0
        # (b) the whole space ranked on it, host arithmetic only
        space = enumerate_space(WORKERS)
        check(len(space) == TUNE_SPACE_W4,
              f"19: {len(space)} candidates at W={WORKERS}, want "
              f"{TUNE_SPACE_W4}")
        t0 = time.perf_counter()
        ranked = rank_candidates(like, space, topo)
        rank_s = time.perf_counter() - t0
        log(f"19 (b) {len(space)} candidates ranked in {rank_s:.6f} s on "
            f"the host ({len(ranked)} priced), on {topo}; top 5: "
            + "; ".join(f"{tune_label(c)} {p['seconds'] * 1e6:.1f} us"
                        for c, p in ranked[:5]))
        extra = tuple(Candidate(*c) for c in TUNE_PINNED)
        pred = dict(ranked)
        check(all(c in pred for c in extra),
              f"19: a pinned candidate {extra} is not priced")
        (g8,) = build_plan(like, chunk_bytes=extra[0].chunk_size_bytes,
                           n_shards=WORKERS).groups
        check(effective_windows(g8, extra[0].pipeline_windows)
              == TUNE_INT8_WINDOWS,
              f"19: the int8 candidate does not run "
              f"{TUNE_INT8_WINDOWS} windows")
        timed, verdicts = {}, {}

        def timer(c):
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            reset_all_launches()
            us = time_candidate(like, c, steps=TUNE_STEPS,
                                warmup=TUNE_WARMUP, device="cuda")
            launches = all_launches()
            timed[c] = {"us": us, "launches": launches, "base_gib": base,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2**30}
            tally(f"19 timed {tune_label(c)}", launches)
            return us

        def linter(c):
            if c not in verdicts:
                reset_all_launches()
                t0 = time.perf_counter()
                verdicts[c] = lint_candidate(c, arch=ARCH, d_model=0,
                                             device="cuda")
                verdicts[c]["lint_s"] = time.perf_counter() - t0
                tally(f"19 lint {tune_label(c)}", all_launches())
                gc.collect()
                torch.cuda.empty_cache()
            return verdicts[c]

        # (c) time the top 3 and the incumbent, lint-gate the winner
        t0 = time.perf_counter()
        report = autotune(like, tc, WORKERS, topo=topo, top_k=TUNE_TOP_K,
                          steps=TUNE_STEPS, warmup=TUNE_WARMUP, cache_dir=d,
                          arch=ARCH, d_model=0, device="cuda", timer=timer,
                          linter=linter, log=log)
        t_tune = time.perf_counter() - t0
        for c in extra:
            if c not in timed:
                timer(c)
        for c in timed:
            linter(c)
        inc = _incumbent(tc, WORKERS)
        check(inc in timed, f"19: the incumbent {inc} was not timed")
        check(report["lint"].get("ok") and not report["cache_hit"],
              f"19: the winner is not lint-green: {report['lint']}")
        win = report["candidate"]
        for c, t in sorted(timed.items(), key=lambda ct: ct[1]["us"]):
            v = verdicts[c]
            log(f"19 (c) {tune_label(c)}: predicted "
                f"{pred[c]['seconds'] * 1e6:.1f} us, measured "
                f"{t['us']:.1f} us (median of {TUNE_STEPS}, ratio "
                f"{t['us'] / (pred[c]['seconds'] * 1e6):.3f}), peak "
                f"{t['peak_gib']:.3f} GiB ({t['base_gib']:.3f} before), "
                f"lint {'green' if v.get('ok') else 'RED'} in "
                f"{v['lint_s']:.1f} s (errors {v.get('errors')}, warnings "
                f"{[w['message'] for w in v.get('warnings', [])]}), "
                f"launches {t['launches']}"
                + (" <- winner" if c.to_dict() == win else "")
                + (" <- incumbent" if c == inc else "") + f" ({smi})")
        i_us = timed[inc]["us"]
        log(f"19 (c) winner {win} measured {report['measured_us']:.1f} us "
            f"against the incumbent's {i_us:.1f} us "
            f"({report['measured_us'] / i_us - 1:+.2%}); autotune took "
            f"{t_tune:.1f} s, {report['timed_candidates']} timed, "
            f"rejected {len(report['rejected'])}")
        # (d) a second request hits the cache: nothing timed or launched
        reset_all_launches()

        def refuse(c):
            raise AssertionError(f"19: the cache hit timed or linted {c}")
        again = autotune(like, tc, WORKERS, topo=None, cache_dir=d,
                         device="cuda", timer=refuse, linter=refuse,
                         log=log)
        check(again["cache_hit"] and again["timed_candidates"] == 0
              and again["candidate"] == win
              and not any(all_launches().values()),
              f"19 (d): the second call did not hit the cache: {again}")
        # (e) --auto-tune on the seeded cache against the winner's flags
        base = ["--arch", ARCH, "--workers", str(WORKERS), "--steps",
                str(TUNE_TRAIN_STEPS), "--batch", str(BATCH), "--seq",
                str(SEQ), "--log-every", "1", "--device", "cuda"]
        t0 = time.perf_counter()
        tuned = tune_train(torch, base + ["--auto-tune", "--tune-cache-dir",
                                          d])
        flags = ["--strategy", win["strategy"], "--windows",
                 str(win["pipeline_windows"]), "--wire-format",
                 win["wire_format"], "--chunk-kb",
                 str(win["chunk_size_bytes"] // 1024), "--pods",
                 str(win["pods"])]
        if win["wire_format_dcn"]:
            flags += ["--wire-format-dcn", win["wire_format_dcn"]]
        direct = tune_train(torch, base + flags)
        t_train = time.perf_counter() - t0
        for label, run in (("--auto-tune", tuned), ("direct", direct)):
            tally(f"19 launch/train.py {label}", run[2])
            check(len(run[0]) == TUNE_TRAIN_STEPS
                  and all(math.isfinite(x) for x in run[0]),
                  f"19 (e) {label}: losses {run[0]}")
        check(tuned[0] == direct[0]
              and same_fingerprint(torch, tuned[1], direct[1])
              and tuned[2] == direct[2],
              f"19 (e): --auto-tune's run differs from the winner's flags "
              f"given directly: losses {tuned[0]} vs {direct[0]}")
        log(f"19 (e) launch/train.py --auto-tune (cache hit) and {flags}: "
            f"losses {tuned[0]}, parameters and launches {tuned[2]} "
            f"bitwise equal ({t_train:.1f} s for both)")
    for name in TUNE_KERNELS:
        check(total.get(name, 0) > 0, f"19: {name} never launched")
    log(f"19. the autotuner phase took {time.perf_counter() - t_phase:.1f} "
        f"s (calibration {t_cal:.1f}, ranking {rank_s:.3f}, autotune "
        f"{t_tune:.1f}, train {t_train:.1f}); its launches {total}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script drives the "
                         "port on the card and has no CPU mode")
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build(["agg_opt", "quant", "swa_attn", "decode_attn",
                         "rwkv_scan"])
    log(f"kernels built from source in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name} ptxas: {line.strip()}")

    tc = TrainConfig()
    padded = {}
    for W in (1, WORKERS):
        (group,) = PHubEngine(get_arch(ARCH), tc, StackedComm(W),
                              device="cuda").chunk_plan.groups
        padded[W] = group.padded
    ce = group.chunk_elems
    kernels = kernel_phase(torch, {"agg_opt_chunks": padded[1],
                                   "multi_agg_opt_chunks": padded[WORKERS]},
                           tc.lr, tc.momentum)
    kernels.update(rule_kernel_phase(torch, padded))
    kernels.update(wire_kernel_phase(torch, padded[WORKERS], ce, tc.lr,
                                     tc.momentum))
    for name, entry in window_kernel_phase(torch, padded, tc.lr,
                                           tc.momentum, ce).items():
        kernels[name].update(entry)
    kernels["health_chunks"] = health_kernel_phase(torch, padded, ce)
    kernels.update(attention_kernel_phase(torch))
    kernels.update(rwkv_kernel_phase(torch))
    reference_phase(torch, "nesterov")
    reference_phase(torch, "adam")
    wire_reference_phase(torch, "int8")
    wire_reference_phase(torch, "bf16")
    for rule in ("nesterov", "sgd", "adam"):
        reference_phase(torch, rule, gated=True)
    for rule in ("nesterov", "adam"):
        reference_phase(torch, rule, arch=SSM_ARCH, seq=SSM_REF_SEQ)
    rollback_phase(torch)
    serve_reference_phase(torch, "llama3.2-1b", prompt=40)
    serve_reference_phase(torch, "h2o-danube-3-4b", prompt=96)
    serve_reference_phase(torch, "rwkv6-3b", prompt=40)
    serve_reference_phase(torch, "rwkv6-3b", prompt=128)

    from repro_torch.elastic import FaultEvent, FaultSchedule, NAN_PUSH
    # (label, workers, steps, rule, wire, launches per step, faults)
    paths = (
        ("W=4", WORKERS, STEPS, "nesterov", "identity",
         {"multi_agg_opt_chunks": 1}),
        ("supervised W=4", WORKERS, 4, "nesterov", "identity",
         {"health_chunks": 1, "multi_agg_opt_chunks": 1},
         FaultSchedule((FaultEvent(1, NAN_PUSH, POISONED, duration=2),),
                       world=WORKERS)),
        ("W=1", 1, 1, "nesterov", "identity", {"agg_opt_chunks": 1}),
        ("W=4", WORKERS, STEPS, "adam", "identity", {"adam_opt_chunks": 1}),
        ("W=1", 1, 1, "adam", "identity", {"adam_opt_chunks": 1}),
        ("W=4", WORKERS, 1, "sgd", "identity", {"sgd_opt_chunks": 1}),
        ("W=1", 1, 1, "sgd", "identity", {"sgd_opt_chunks": 1}),
        ("int8 W=4", WORKERS, STEPS, "nesterov", "int8", INT8_W4),
        ("int8 W=1", 1, 1, "nesterov", "int8",
         {"quantize_chunks": 1, "dequantize_chunks": 1,
          "agg_opt_chunks": 1}),
        ("int8 W=4", WORKERS, 1, "sgd", "int8",
         {"quantize_chunks": WORKERS, "dequantize_chunks": WORKERS,
          "sgd_opt_chunks": 1}),
        ("int8 W=4", WORKERS, 1, "adam", "int8",
         {"quantize_chunks": WORKERS, "dequantize_chunks": WORKERS,
          "adam_opt_chunks": 1}),
        ("int8 supervised W=4", WORKERS, 4, "nesterov", "int8",
         dict(INT8_W4, health_chunks=1),
         FaultSchedule((FaultEvent(1, NAN_PUSH, POISONED, duration=2),),
                       world=WORKERS)),
    )
    # the gradient processing pipeline: (label, workers, steps, rule,
    # TrainConfig's pipeline fields, launches per step, the monolithic
    # path whose losses and parameters it must equal bitwise); the int8
    # wire's windows: 3 quantizes and 2 dequantizes on each window's ring
    # hops, one of each for the pull, one tail launch a window
    S4 = WORKERS
    int8_windows = INT8_W4_WINDOWS
    pipeline_paths = (
        (f"windows {WINDOWS_W4} flat W=4", WORKERS, STEPS, "nesterov",
         dict(pipeline_windows=WINDOWS_W4, flat_residency=True),
         {"multi_agg_opt_chunks": WINDOWS_W4 * S4}, "nesterov W=4", ARCH),
        (f"windows {WINDOWS_W4} chunk-ready W=4", WORKERS, STEPS,
         "nesterov", dict(pipeline_windows=WINDOWS_W4,
                          overlap_backward=True),
         {"multi_agg_opt_chunks": WINDOWS_W4 * S4}, "nesterov W=4", ARCH),
        (f"windows {WINDOWS_W4} flat W=4", WORKERS, 1, "adam",
         dict(pipeline_windows=WINDOWS_W4, flat_residency=True),
         {"adam_opt_chunks": WINDOWS_W4 * S4}, "adam W=4", ARCH),
        (f"windows {WINDOWS_W1} flat W=1", 1, 1, "nesterov",
         dict(pipeline_windows=WINDOWS_W1, flat_residency=True),
         {"agg_opt_chunks": WINDOWS_W1}, "nesterov W=1", ARCH),
        (f"int8 windows {WINDOWS_W4} W=4", WORKERS, STEPS, "nesterov",
         dict(wire_format="int8", pipeline_windows=WINDOWS_W4),
         int8_windows, "nesterov int8 W=4", ARCH),
        (f"int8 windows {WINDOWS_W4} chunk-ready flat W=4", WORKERS, 2,
         "nesterov", dict(wire_format="int8", pipeline_windows=WINDOWS_W4,
                          overlap_backward=True, flat_residency=True),
         int8_windows, "nesterov int8 W=4", ARCH),
    )
    for k in kernels.values():
        k["launches_by_path"] = {}
    runs = {}

    def count(label, launches):
        for name, n in launches.items():
            if n:
                kernels[name]["launches_by_path"][label] = n
                kernels[name]["launches"] += n

    for label, workers, steps, rule, wire, expect, *faults in paths:
        run = main_path(torch, workers, steps, expect, rule, wire, *faults)
        runs.setdefault(f"{rule} {label}", run)
        count(f"{rule} {label}", run["launches"])
    count("nesterov int8 W=4, worker 1 dead", main_path(
        torch, WORKERS, 1, INT8_W4, "nesterov", "int8",
        dead=POISONED)["launches"])
    strategy_phase(torch, runs, count)
    counted, bases = process_group_phases(torch)
    for label, launches in counted:
        count(label, launches)
    strategy_process_phases(torch, bases, count)

    # rwkv6-3b training (the ssm family, chunked scan under autograd): one
    # window at W=2 first, the monolithic path the windowed ones must equal
    for label, workers, steps, rule, pipe, expect, layers in SSM_TRAIN_PATHS:
        run = main_path(torch, workers, steps, expect, rule, pipeline=pipe,
                        layers=layers, arch=SSM_ARCH)
        runs[f"{SSM_ARCH} {rule} {label}"] = run
        count(f"{SSM_ARCH} {rule} {label}", run["launches"])
    for label, workers, steps, rule, pipe, expect, base, arch in (
            pipeline_paths + SSM_PIPELINE_PATHS):
        pipe = dict(pipe)
        wire = pipe.pop("wire_format", "identity")
        run = main_path(torch, workers, steps, expect, rule, wire,
                        pipeline=pipe, arch=arch)
        label = f"{rule} {label}" if arch == ARCH else \
            f"{arch} {rule} {label}"
        count(label, run["launches"])
        mono = runs[base]
        check(run["losses"] == mono["losses"][:steps],
              f"{label}: losses {run['losses']} differ from the "
              f"monolithic path's {mono['losses'][:steps]}")
        for i in range(steps):
            check(same_fingerprint(torch, run["prints"][i],
                                   mono["prints"][i]),
                  f"{label}: the parameters after step {i} differ "
                  f"from the monolithic path's")
        log(f"{label}: losses and parameters (f64 sums, bit-pattern "
            f"sums and {sum(x[3].numel() for x in run['prints'][0]):,} "
            f"sampled elements a step) bitwise equal to the monolithic "
            f"path's ({base}) over {steps} step(s); step ms "
            f"{[round(x, 3) for x in run['step_ms']]} against "
            f"{[round(x, 3) for x in mono['step_ms'][:steps]]}, tokens/s "
            f"{[round(BATCH * SEQ / (x / 1e3)) for x in run['step_ms']]} "
            f"against {[round(BATCH * SEQ / (x / 1e3)) for x in mono['step_ms'][:steps]]}, "
            f"peak GiB {[round(x, 3) for x in run['peak_gib']]} against "
            f"{[round(x, 3) for x in mono['peak_gib'][:steps]]}")
    for arch, batch, prompt, steps in SERVE_PATHS + (SSM_SERVE_PATH,):
        count(f"serve {arch}", serve_path(torch, arch, batch, prompt, steps))
    client_phase(torch, runs, bases, count)
    domains = co_phase(torch, runs, bases, count)
    for name, entry in co_kernel_phase(torch, domains, ce).items():
        kernels[name].update(entry)
    resize_phase(torch, count)
    characterization_phase(torch, count, kernels, smi.splitlines()[0])
    families_phase(torch, count, kernels)
    decay_phase(torch, count, kernels, runs, padded, ce, smi.splitlines()[0])
    tune_phase(torch, count, smi.splitlines()[0])
    for k in kernels.values():
        if "tol" in k:            # checked against its tolerance above
            k["verdict"] = "within_tol"
        else:
            k["verdict"] = "bitwise" if k["max_ulp"] == 0 else "differs"
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
