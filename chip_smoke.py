#!/usr/bin/env python3
"""GPU check of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use).  Imports
torch and the port only — nothing of JAX or of the JAX package.  Every
line of standard output but the last is one JSON object (the card's
``nvidia-smi`` name/power line excepted); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without printing that line.

Phases:
  build    nvcc for every CUDA source, all started at once; build seconds;
           flash attention's ``-Xptxas -v`` readings (registers, stack,
           spills per instantiation) and the tensor-core instructions
           (HMMA / HGMMA) in each instantiation's SASS; the segmented
           sum's and the chain probe's ``-Xptxas -v`` readings.
  (each)   every phase ends with a ``{"phase": ..., "phase_s": s}`` line;
           a ``{"phase": "seconds", "by_phase": ...}`` line before the
           kernels summary adds them up.
  kernels  each kernel against its plain PyTorch version on the same card
           inputs, at full size and at a ragged size: the six bucket
           kernels at the main path's shape (W=4 workers x 934,040 rows x
           128, float32: paper-lm's bucket) and at 3,101 rows; the three
           per-tensor kernels on one tensor of paper-lm's parameter count
           (119,556,864; fused SGD in float32 and bfloat16) and of
           1,000,003 elements; flash attention at paper-lm's attention
           (B 32, S 512, 12 heads, D 64, causal, f32), at gemma3-1b's local
           layer (B 1, S 4096, 4 heads, 1 kv head, D 256, window 512; f32
           and bf16) and at two ragged shapes.  Max errors against the
           stated tolerance, and times (median of CUDA-event-timed runs):
           kernel, plain version, the one PyTorch call that computes the
           same function where there is one (timed only, never used by
           the port), and the bound (bytes; for flash attention the
           operations of the unmasked pairs at the tensor-core rate of its
           route: 3xTF32 in f32, bf16 q·k and split-bf16 p·v in bf16).
           Flash attention, abs_sum and sq_sum also give device time per
           call over back-to-back calls (``device_ms``, and the library
           call's ``library_device_ms``, the two timed in turns), beside
           the per-call time; abs_sum and sq_sum must give the same bits
           twice.  The port's segmented sum (no TPU kernel) on (W, rows)
           row sums of paper-lm's leaves, per worker and chained: equal
           to its plain version (the host's index_add_) bit for bit, and
           twice; ``index_add_`` on the card is its library call; timed
           per worker and chained, each beside its byte bound and its
           chain bound (the longest leaf's index-order adds times one
           add's latency, from the chain probe: one thread's dependent
           __fadd_rn, with the SM clock nvidia-smi reads meanwhile).  The
           three kernels of the paper harness's path (fused
           SGD, row_abs_sum, scale_sign_rows) also at its bucket: K=8
           workers x 624 rows x 128 (the width-256 MLP), timed.
  A        the main path: paper-lm at full width, W=4 stacked on the card,
           post-local SGD, mean sync, 12 steps; launch counts.
  B        the same with EF-sign sync; the compressor kernels launch once
           per global sync, the segmented sum once a sync.
  B2       phase B once more: losses and every bucket (params, momentum,
           anchor, EF memory) equal phase B's bit for bit (every sum of
           the port runs in a fixed order on the card).
  L        the same with LARS (the paper's Table 5 optimizer) and telemetry:
           the two LARS kernels every step, their stats form feeding the
           round statistics, grad_clip set and ignored (no sq_sum launch);
           the last round's summary.
  F        the reference's default per-leaf tree path at phase A's width
           and schedule: F1 ``build_train(use_kernel=False)`` (plain
           per-leaf PyTorch) with the mean sync against phase A, F2
           ``build_train(resident=False)`` (the tree-in/tree-out kernel
           form: pack, kernels 1-4 and the segmented sum, unpack, every
           step and sync) with EF-sign against phase B, F3 the same with
           LARS + EF-sign + telemetry against phase L: per-step losses
           (rtol 1e-4), the final params (F1 their worker mean; all but
           1e-4 of the elements within 1e-4 x the largest, F3 1e-3),
           whether bit for bit, comm rounds, launches (F1 none), the step
           time beside the resident phase's and the pack / unpack passes'
           bytes over the card's rate as their bound (the reference's 10
           passes a step, the port's 8); then the quickstart twin
           (``repro_torch.examples.quickstart``, 40 steps at smoke size)
           on the card.
  H        hierarchical local SGD (Alg. 5) at phase A's settings with
           block_steps=2 (blocks of 2 of the 4 workers): syncs at
           (0 block) (1 global) (2 block) (3 global) (7 block) (11 global);
           launch counts as in A; the comms ledger's rounds and ring-model
           bytes per topology and scope (a block round one bucket, a
           global round 1.5 buckets); step time beside phase A's.
  E        the elastic worker pool at phase A's settings, through the
           backend seam (``LocalBackend`` / ``SimulatedBackend``, the
           ``elastic`` controller).  E1: W = 4 -> 2 -> 4 under the mean
           sync (resizes after global rounds 3 and 5; W=2 runs steps 3-7),
           12 steps: two resizes, syncs as phase A's, final buckets
           (4, 934,040, 128), the ledger per worker set (a W=2 round one
           bucket, a W=4 round 1.5), launches 12 / 12, per-step losses
           against a hand-driven fresh-run oracle on the card (1e-6
           relative), sq_sum on the live buckets after each resize against
           its plain version; median step time per W, each fenced resize
           span's seconds, peak memory.  E2: LARS + EF-sign with
           telemetry, W = 4 -> 2 after round 3, 8 steps: the oracle within
           1e-4, ``num_workers`` 2 in the rounds after the resize, the
           LARS pair 8 launches each, the compressor pair one a sync.  E3:
           a ``SimulatedBackend`` straggler (worker 2, +0.05 s a step,
           cleared by an eval hook every 3 steps), 12 steps: demoted at
           round ``skew_patience``, block syncs at steps 2 and 7 under
           hierarchical(block_size=2) while demoted, promoted back at the
           last round, flat topology and an empty demoted set after; the
           decision stream (the step times are the backend's model, not
           the card's).  JSONL in ``build/phase_e{1,2,3}.jsonl``.
  R        phase B's run traced (``Tracer(fence=True, annotate=True)``
           with a metrics registry; artifacts in ``build/phase_r/``): the
           trace directory passes ``export.check_trace_dir``, per-step
           losses equal phase B's bit for bit (every sum in a fixed
           order), the ledger's sync seconds equal the sync spans'
           and the JSONL's stage seconds, each round's ``sync_s`` is its
           span's duration; span census, median span seconds, the fenced
           step time beside phase B's.
  W        the 1-bit wire format: phase B's run with ``wire_pack=True``,
           traced with a fenced tracer: per-step losses against phase B's
           (1e-4 relative), the packed payload (934,040 rows x 16 bytes a
           worker, 1/32 of the f32 bucket, plus one f32 scale a leaf), the
           plan's and the ledger's wire bytes against B's (a payload and a
           scale all-gather a round: 1/16 of B's all-reduce), the fenced
           sync seconds against phase R's, launches as B's but kernel 3
           twice a sync (the pack's row sums are the compressor's); the first
           sync's uint8 payload on the card byte for byte against the same
           pack of the same bucket on the CPU, its row sums taken in the
           kernel's order (``cpu_pack``: scales bit for bit, the same adds
           in the same order); then 4 steps with ``sync_coalesce`` as
           well: the same plan stages (one bucket: nothing to coalesce on
           one card) and the same losses.
  Y        workers across processes: ``DistributedBackend`` ranks spawned
           with ``torch.multiprocessing``, over ``gloo`` with every rank on
           card 0 (the machine's one card; NCCL takes one rank a card),
           paper-lm at full width, W=4, local batch 8, seq 512, 12 steps.
           Y1: 4 ranks x 1 worker at phase W's settings (EF-sign +
           ``wire_pack``): per-step losses against phase W's
           (``Y_LOSS_TOL``: equal for Y1), comm rounds, the first sync's gathered ``uint8``
           payload byte for byte against phase W's first payload, the
           scales bit for bit (rank 0's own scales too against the CPU's
           pack of its bucket: the same adds in the same order), the
           ledger's measured
           bytes (W x (rows x 16 + 4 a leaf) a sync) equal to the tensors
           handed to the collectives.  Y2: 4 x 1 at phase H's settings
           (Alg. 5, blocks of two workers on two ranks: a two-member
           sub-group): losses and every worker's final params rows bit for
           bit (the dense means are ``Collectives.ordered_mean``'s, which
           add the workers in worker order), block / global rounds; then,
           on the same ranks, the ordered mean of the trained bucket
           against a plain ``dist.all_reduce`` of it, fenced (a probe
           here only).  Y3: 2 ranks x 2 workers at phase L's settings
           (LARS + EF-sign + telemetry): losses and the gathered
           ``round_summary`` at phase C's tolerances.  Y4: 4 x 1, the
           tree path's tree-in/tree-out kernel form
           (``build(run, resident=False)``) at phase W's settings:
           losses and rows bit for bit against phase W's, launches as
           Y1's.  Y5: 4 x 1, the plain per-leaf tree form
           (``use_kernel=False``) at phase H's settings (its blocks of two
           across ranks): losses within 1e-4 of phase H's, no launch.
           Each part: fenced sync seconds by scope, measured against
           ring-model bytes, median step per rank, peak memory per rank,
           launches per rank, the ops staged through the host; then the
           dense mean (Y2) against the packed all-gather (Y1).
           With two or more cards Y1 also runs over NCCL, one rank a card;
           with one, a line says why it did not.  The four ranks then run
           phase U's U4.  Results in ``build/phase_y/``.
  V        workers split over shard ranks: ``DistributedBackend(
           within_worker_size=2)``, four ``gloo`` ranks on card 0 = 2
           workers x 2 shards (rank = group * 2 + shard), paper-lm at full
           width and ``V_LAYERS`` (1) of its 12 layers, W=2, local batch
           8, seq 512, 12 steps.  The layout puts the layers' and the
           embedding's leaves in a ("model",) sub-bucket (at 12 layers
           933,888 rows, 466,944 a rank) and 3 in a replicated one of
           152.  V1: FSDP (each shard
           rank differentiates half a worker's batch; gradients
           reduce-scattered) at phase A's settings; V2: tensor parallel
           (every shard rank the whole batch) at phase W's with
           ``sync_coalesce`` (both sub-buckets in one payload gather); V3:
           FSDP at phase L's (LARS + EF-sign + telemetry).  Each part is
           first run in one process on the same sharded layout (V1 also
           on the replicated one): per-step losses within ``V_LOSS_TOL``,
           comm rounds, every rank's params rows (V1: and momentum)
           against the matching rows of the one-process buckets (the
           share beyond 1e-4 of the largest within ``V_FRAC_TOL``), V2's
           first gathered payload byte for byte against the one-process
           pack's shard-0 rows, V3's gathered ``round_summary`` within
           1e-3 (1e-2 on the fields read from ||mean x||^2, phase C's
           rule), launches per rank, the ledger's measured bytes
           (shard-local rows) and the within-worker traffic under its own
           scope.  V4-V6 run the tree path (``V_BUILD``), each rank
           holding its shard's slice of every sharded leaf: V4 its kernel
           form under tensor parallel at V2's settings (losses, params
           and momentum bit for bit), V5 its plain form and V6 its kernel
           form (with the sign compressor) under FSDP at V3's, whose
           every sync is also replayed on the ranks from the one-process
           run's pre-sync state (``V_PINNED``: anchor and EF memory within
           1e-6 / 1e-5 of the largest entry, no element beyond); their
           launches a rank, row P's included, are held exactly.  Rank 0
           holds kernels 1-6 against their plain versions on its
           shard-local trained buckets (a tree part's slices packed into
           its region rows).  Each part: fenced step and
           sync seconds per rank, the shard group's gathers and
           reductions fenced apart, peak memory per rank against the
           layout's reckoning.  Results in ``build/phase_v/`` (removed
           after the checks).
  Q        resizes and checkpoints across ranks (``Q_PARTS``): paper-lm
           at full width and ``Q_LAYERS`` (1) of its 12 layers, W = 4 ->
           2 -> 4 by ``ElasticController(
           resize_at=Q_RESIZE)``, Q1 on 2 ``gloo`` ranks x 2 workers at
           phase W's settings, Q2 on 2 worker groups x 2 FSDP shard ranks
           at phase L's; a ``checkpoint_fn`` after step ``Q_CKPT_STEP``
           gathers the whole state to rank 0 and writes it.  Each part
           against its one-process run (``LocalBackend``, the part's
           layout): losses within ``Q_LOSS_TOL``, every rank's params rows
           within ``Q_FRAC_TOL``, the resizes, steps at each W, worker
           sets and comm rounds equal, decisions equal on every rank; rank
           0 restores the snapshot on the card at W=4 and by the elastic
           restore at W=2, each equal to the gathered state bit for bit,
           and holds kernels 1-6 and the segmented sum against their plain
           versions on its rows after the resizes.  Q3: Q1 once more in
           the tree path's kernel form (``DistributedBackend(
           resident=False)``: tree states, a gathered tree snapshot),
           held against Q1's one-process run bit for bit.  Prints the fenced
           resize spans per rank, the checkpoint's gather and write
           seconds and GB/s, the bytes handed to collectives and the peaks
           a rank against the layout's reckoning.
  K        checkpoints at full width: ``save_flat`` of the resident state
           after 6 steps of phase A's settings (3.83 GB), ``restore_flat``
           into a fresh state: buckets bit-equal, 2 more steps from each
           give the same losses; GB/s both ways; ``save`` / ``restore``
           of the worker-mean param tree.  Files in a temporary directory
           under ``build/``, removed.
  S        serving from the trainer: ``fit`` at phase A's settings for 8
           steps publishes versions 0 and 1 (``checkpoint_every=4``); the
           paged continuous-batching engine (16 slots, max_len 512, page
           16, prefill 128; a 605 MB pool) serves 48 markov-corpus
           requests (prompts 16-128, 16-96 new tokens) from version 0 and
           hot-swaps to version 1 once half have finished: every request
           completes, the null page stays zero, every page comes back; the
           logits of requests served on one version equal the contiguous
           path's (``build_serve``) teacher-forced on their tokens; the
           swapped resident continues as a fresh engine on version 1;
           decode steps, tokens/s, decode and prefill ms, swap seconds,
           peak memory, and torch.profiler's split of a decode step.
  S2       the serving twins on the card at their reference sizes
           (gemma3-1b smoke, their own seeded weights): ``serve_lm``
           (prefill + 15 greedy decode steps of 4 prompts of 32; the
           first tokens against the CPU's prefill of the same weights)
           and ``serve_continuous`` (12 mixed requests on 4 slots, a
           published version hot-swapped in once half have finished:
           every request completes at its length, the residents at the
           swap end on the new version).
  M        the MoE and MLA decoders at their published widths, depth cut to
           2 layers (1 when the peak reckoned from the bucket layout's rows
           passes 72 GB): M1 olmoe-1b-7b (64 experts top-8, mean sync, W=4),
           M2 deepseek-v2-lite-16b (MLA, 64 routed + 2 shared experts top-6,
           EF-sign sync, W=2), each phase A's settings for 8 steps: losses
           finite and falling, aux, comm rounds equal to the schedule's,
           median step, peak memory, launches (update and sq_sum every step,
           the compressor pair every EF-sign sync), the capacity drops per
           step (counted on the card); M1's step under torch.profiler split
           into expert bmm / dispatch / attention / head; the trained model
           on the card against the port on the CPU on a (1, 128) batch (loss
           1e-4 relative, routing flips counted); 16 markov requests served
           on 8 slots (max_len 256, pages of 16) by the paged engine, timed,
           then again beside the contiguous path run on the engine's own
           batches (an MoE layer's capacity drops depend on its batch):
           logits within 1e-4 x (1 + |logit|).
  D        the dense variants at their published widths, phase A's
           settings (mean sync) at W=2, depth cut by the reckoning in
           ``D_RUNS``: D1 gemma3-1b (2 of 26 layers, both of the
           sliding window; of 5 sliding : 1 global; GeGLU, post-norm, scaled
           embeddings, tied head; seq 1024 past its window of 512, local
           batch 4), D2
           qwen3-32b (1 layer), D3 phi4-mini-3.8b (4), D4 minitron-4b (1),
           8 steps each: losses finite and falling from about
           ln V, comm rounds equal to the schedule's, median step, tokens/s,
           peak memory against the reckoning, launches (the update and
           sq_sum every step); D1's step under torch.profiler split into
           matmuls, the S x S score ops and the elementwise tail; the
           worker-mean model on the card against the port on the CPU (loss
           1e-4 relative; D1 on 768 tokens, past its window of 512); 16
           requests on the paged engine (D1 up to 648 tokens, past the
           window), timed, then beside the contiguous path on the engine's
           own batches: logits within 1e-4 x (1 + |logit|).
  Z        the recurrent families at their published widths (``Z_RUNS``),
           phase A's settings at W=2, seq 512 x local batch 8, 8 steps:
           Z1 xlstm-1.3b, 8 of 48 layers (7 mLSTM + 1 sLSTM), EF-sign;
           Z2 zamba2-7b, 12 of 81 layers (10 mamba2 + 2 invocations of
           the shared attention block), mean sync.  The memory reckoning
           printed before each part; losses finite and falling, comm
           rounds equal to the schedule's, median step, tokens/s, peak
           memory against the reckoning, launches (the update and sq_sum
           every step, the compressor pair every EF-sign sync); one step
           under torch.profiler split by part (the mLSTM chunk loop, the
           sLSTM cell loop and mamba2's Q x Q decay by their profiler
           spans; attention, head and other matmuls, the tail); the
           worker-mean model on the card against the port on the CPU (a
           (1, 128) batch: loss 1e-4 relative, logits 1e-4 x (1 +
           |logit|)); served through the contiguous path
           (``build_serve``): 8 prompts of 128 tokens prefilled in one
           batch, 32 greedy decode steps timed, every step's logits held
           against the train-mode forward over the same tokens within
           2e-4 x (1 + |logit|); ``build_engine`` refuses both (the paged
           pool needs a kv_seq axis on every cache leaf).
  X        the encoder-decoder and prefix-token families at their
           published widths (``X_RUNS``), phase A's settings, 8 steps:
           X1 whisper-small, 12 encoder + 4 of 12 decoder layers, 8 examples of 1,500
           frames (the stubbed conv frontend's output) + 448 decoder
           tokens a worker, EF-sign, W=4; X2 internvl2-76b, 256 stubbed
           patch embeddings + 256 text tokens x 8, mean sync, W=1 (W=2
           does not fit the card at any depth), its depth the deepest
           whose reckoning stays under 72 GB (``x_depth``: 2 of 80).  The
           reckoning printed first; losses finite and falling, comm rounds
           equal to the schedule's, median step, tokens/s, peak memory,
           launches; kernels 1-4 against their plain versions on the
           trained buckets (X2's is 3.88 G elements); one step under
           torch.profiler split by part (the ``encoder``,
           ``cross_attention`` and ``prefix_projection`` spans); the
           worker-mean model on the card against the port on the CPU on
           one example (loss 1e-4 relative, logits 1e-4 x (1 + |logit|));
           8 prompts (with their frames / prefix) served through
           ``build_serve``, 32 greedy decode steps timed and held against
           the train-mode forward within 2e-4 x (1 + |logit|); whisper
           refused by ``build_engine`` (it feeds no frames), internvl2
           served text-only on the paged engine (16 requests), held
           against the contiguous path on the engine's own batches.
  J        the long shapes through block remat and the blockwise
           attention (``models.layers.chunked_attention``: 512 x 512
           blocks, the causal / window band only).  J1: paper-lm at full
           width and depth, train_4k's 4,096 tokens, W=4 x local batch 4,
           ``remat="block"``, EF-sign and grad clip 1.0, H=2: 2 local
           steps and 1 sync; the reckonings first (``dryrun.reckon_card``
           with remat "block"; not run: "none", and the retired
           whole-square attention); losses finite near ln V, one sync,
           kernels 1-4 launched (the update and sq_sum a step, the
           compressor pair and the segmented sum once), step seconds
           beside the meta FLOPs' f32 bound, the peak within
           ``J_PEAK_BAND`` of the reckoning; J1b one layer and one
           sequence of 4,096, the gradients with remat against those
           without (rtol 1e-4 of each leaf's largest entry).  J2:
           gemma3-1b at full width and all 26 layers, one 32,768-token
           prompt through ``lm.prefill`` twice: logits finite, the last
           512 query rows of a sliding and a global layer against
           ``reference_attention`` (end-aligned) on those rows and the keys
           they reach (1e-4 of the largest entry); seconds, tokens/s and
           the peak beside a reckoning.
  T        the per-tensor kernel API at full width: paper-lm's parameter
           tree (W=1) on the card; one SGD step with ops.fused_sgd on every
           leaf against the same step by the bucket kernel on the flat bus;
           ops.sign_compress on every leaf of a delta tree against the
           bucket compressor; ops.flash_attention against the training
           path's attention (models.layers.chunked_attention, one 512 x 512
           block) at paper-lm's attention shape; launch counts (one per
           leaf, one flash).
  N        noise-adaptive post-local SGD at full width: phase B's settings
           with the noise_adaptive controller (NOISE_CC), 12 steps; per
           round the H, compressor, batch and LR scale it ran under, the
           speculative / measured sign error, the decisions and each
           sensor's margin to its threshold; at least one actuation, the
           launch counts (the update and sq_sum every step, the compressor
           pair once per global round), the ledger's scaling block against
           the decisions; median step time per batch scale beside phase
           B's, peak memory.
  noise    gradient noise at full width: the bucket noise on a zero
           (W, 934,040, 128) grad bucket at t = 0 and 10 against
           sigma_t^2 = eta / (1+t)^gamma (variance within 1e-3 relative,
           mean below 1e-3 sigma_t, padding exactly zero, one seed the
           same bits), then 4 full-width steps with noise_eta = 0.01.
  P        torch.profiler over two full-width local steps and one EF-sign
           sync, for SGD (phase B's run) and for LARS with telemetry
           (phase L's): device busy time by kernel family and the idle
           share (profiler overhead included; not a timing of record), and
           the gradient assembly's float add / fill kernels and aten ops.
           SGD's window must show no reduce_rows_kernel (sq_sum folds its
           partials in its one launch; only the update's stats form uses
           the second pass).
  C        the trainer on the card against the trainer on the CPU (the
           kernels' plain versions) at smoke size, from the same weights:
           SGD + EF-sign, hierarchical SGD (block_steps=2, mean sync), and
           LARS with telemetry, mean and EF-sign sync; then the
           auto_compress and noise_adaptive policies with EF-sign: the same
           decisions round by round, with each sensor's margin to its
           threshold; then sq_sum and fused SGD against their plain
           versions at W = 4 -> 2 -> 4 -> 8 on one stream (sq_sum's scratch
           reused across the changes), and the elastic trainer with phase
           E's resizes and straggler together: the same resize and
           demotion decisions, losses within 1e-4; the two MoE smoke
           configs (phase M's sync modes and widths), the two
           recurrent ones (phase Z's) and whisper / internvl2 (phase X's,
           with 64 frames / 8 prefix embeddings): one local step and a sync, loss
           and params within the tolerances above (the recurrent ones'
           params counted over the elements whose EF-sign input has the
           same sign on both devices), decode logits within 1e-4 x (1 +
           |logit|).
  G        the paper's experiments (``repro_torch.benchmarks``) at the
           harness's full size (MLP width 256, 1,536 train / 2,048 test
           examples, K up to 8): Fig. 1's A5 and Table 4's EFsign_post_H8
           for 24 steps on the card against the CPU from the same weights;
           then 240 steps of five rows (G_ROUNDS: Fig. 1 A1, A2, A5, Table
           4's EFsign_post_H8, Table 16's H1_Hb8; the CLI runs them all):
           test accuracy, global / block syncs pinned to the reference's
           schedule, wall µs per step (as the CLI's rows), first and final
           loss, launch counts (one fused SGD a step, one compressor pair a
           compressed sync); and torch.profiler over 24 steps of A2 and of H1_Hb8
           (device busy, idle share, the host's busiest ops).
  U        the dry-run and roofline analogues (``launch.dryrun``,
           ``roofline``) at paper-lm's full width.  U1: the dry run's
           one-card reckoning (``dryrun.reckon_card``: the state copies,
           one worker's bytes saved for the backward, traced on the meta
           device, and its logits' gradient; J1's under block remat, the
           replayed layer's transient added) of phase A, of every
           M / D / Z / X part at its cut depth and of J1, beside the peak
           that part measured: the state at most the peak, the total within
           ``U_PEAK_BAND`` of it.  U2: FlopCounterMode over one paper-lm
           worker's loss and gradient (batch 8, seq 512) on the card, equal
           to the meta count, within ``U_FLOP_BAND`` of 3 x the analytic
           forward (``roofline.analysis.forward_flops``); phase A's median
           step against W x that count at the card's f32 rate.  U3:
           ``roofline.probe.probe_card`` at 1 and 2 layers, phase A's
           settings for 12 steps each: the step extrapolated to 12 layers
           beside phase A's, the extrapolated FLOPs equal to the 12-layer
           count.  U4: ``roofline.sync_probe``'s five rows (compression x
           wire_pack x bucket_sync), one sync each on phase Y's four ranks
           (4 x 1, 12 layers, gloo, no new spawn) under torch.profiler: the
           bytes each c10d call was handed (``roofline.hlo.parse_collectives``)
           equal what ``Collectives`` counted (a single-call collective's
           measured bytes; the ordered mean's sends), beside the count of
           collectives and the ring model's bytes.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

W = 4
FULL_ROWS = 934_040          # paper-lm: one f32 bucket, 478.2 MB a copy
RAGGED_ROWS = 3_096 + 5
FULL_N = 119_556_864         # paper-lm's parameter count, as one tensor
RAGGED_N = 1_000_003
STEPS = 12
TOL = {"elementwise": 2e-6, "reduction": 1e-5, "sign": 0.0,
       # flash: f32 against the largest entry; bf16 elementwise, one bf16
       # rounding of the entry (both round an f32 result once) plus that
       "flash_f32": 2e-5, "flash_bf16_rtol": 2 ** -7,
       # phase T: the bucket compressor's per-leaf |x| totals (a float32
       # sum of up to 221,184 row sums, one after another, in index order)
       # against the per-leaf abs_sum's tree; 7.9e-6 on an H100 80GB HBM3
       # at 700 W (1e-4 while the card's sums were atomic)
       "scatter_add": 2e-5}
# flash attention checks: (label, B, S, H, KH, D, window, dtype), causal
FLASH_MAIN = ("paper-lm", 32, 512, 12, 12, 64, 0, "float32")
FLASH_FULL = (FLASH_MAIN,
              ("gemma3-1b local", 1, 4096, 4, 1, 256, 512, "float32"),
              ("gemma3-1b local", 1, 4096, 4, 1, 256, 512, "bfloat16"))
FLASH_RAGGED = (("ragged", 2, 333, 12, 4, 64, 0, "float32"),
                ("ragged", 1, 1000, 4, 1, 256, 100, "bfloat16"))
# each kernel: (the TPU kernel it replaces, under src/repro/kernels/; its
# source, under src/repro_torch/kernels/csrc/)
KERNELS = {
    "fused_sgd_bucket": ("fused_bucket.py:107", "fused_bucket.cu"),
    "sq_sum": ("fused_bucket.py:153", "fused_bucket.cu"),
    "row_abs_sum": ("fused_bucket.py:177", "fused_bucket.cu"),
    "scale_sign_rows": ("fused_bucket.py:304", "fused_bucket.cu"),
    "lars_row_norms": ("fused_bucket.py:204", "fused_bucket.cu"),
    "fused_lars_bucket": ("fused_bucket.py:258", "fused_bucket.cu"),
    "fused_sgd_2d": ("fused_sgd.py:48", "per_tensor.cu"),
    "abs_sum": ("sign_compress.py:34", "per_tensor.cu"),
    "scale_sign": ("sign_compress.py:56", "per_tensor.cu"),
    "flash_attention_bhsd": ("flash_attention.py:74", "flash_attention.cu"),
    # port-only: no TPU kernel; the reference's jax.ops.segment_sum
    "segment_sum": ("ops.py:151 (jax.ops.segment_sum, no TPU kernel: "
                    "port-only)", "fused_bucket.cu"),
}
# phase L: LARS step size; the update of a layer is about lr * trust * ||w||
LARS_LR, LARS_TRUST = 0.3, 0.02
# phase N: noise-adaptive post-local SGD; patience / err_budget / h0 from a
# CPU probe at full width cut to 2 layers (decisions at rounds 1-2: H 2 -> 1,
# none -> sign, batch x2; sign errors 0.49-0.58 against the 0.95 budget)
NOISE_CC = dict(kind="noise_adaptive", max_batch_scale=2, patience=2,
                err_budget=0.95, noise_grow=1.0, h0=2)
# phase C: the two compression-escalating policies at smoke size
C_CONTROLLERS = (dict(kind="auto_compress", patience=1, err_budget=0.95),
                 NOISE_CC)
# the gradient-noise check: eta of the noisy steps; steps t of the draws
NOISE_ETA, NOISE_GAMMA, NOISE_STEPS = 0.01, 0.55, (0, 10)
# phase G: the paper harness's bucket (the width-256 MLP's 76,810 params,
# padded, as one f32 bucket) at K = 8 workers, and its run length
MLP_W, MLP_ROWS = 8, 624
G_STEPS = 240
# the full rows phase G runs (every row of Fig. 1, Tables 4 and 16 runs
# through `python -m repro_torch.benchmarks.run`): the K=1 baseline, large
# mini-batch, Alg. 5 with the most block syncs, post-local SGD and post-local
# EF-sign; each with its (global, block) syncs in 240 steps, the reference's
# schedule, read from `python -m benchmarks.run` of the JAX package on the CPU
G_ROUNDS = {"fig1/A1_small_mb": (240, 0), "fig1/A2_large_mb": (240, 0),
            "table16/H1_Hb8": (30, 210), "fig1/A5_post_local": (150, 0),
            "table4/EFsign_post_H8": (135, 0)}
# round_summary fields computed from ||mean_k x_k||^2 (post_sync_sq)
SYNC_MEAN_KEYS = ("post_sync_sq", "dispersion", "diversity", "signal_sq",
                  "noise_sq", "noise_ratio")


# what later phases hold against: phase -> its losses, rounds, ... (A, B,
# L, H, W fill it; phase Y reads it)
REFS: dict = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


class Laps:
    """Seconds of each phase of :func:`main`: ``laps(tag)`` at the end of a
    phase emits the seconds since the previous call (or since the clock
    started) as ``{"phase": tag, "phase_s": s}``; ``by_phase`` sums them."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.by_phase: dict = {}

    def __call__(self, tag: str):
        now = time.perf_counter()
        self.by_phase[tag] = self.by_phase.get(tag, 0.0) + now - self.last
        self.last = now
        emit({"phase": tag, "phase_s": self.by_phase[tag]})


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=25, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def device_ms(fn, library, calls=20, rounds=3):
    """Device time per call of ``fn`` and of ``library`` (the PyTorch call
    computing the same function), each over ``calls`` back-to-back calls
    between two events (the host's launch latency hidden behind the
    queue), beside ``time_ms``, which times one call at a time.  Taken in
    turns (fn, library, library, fn, ...) so that a drift of the card's
    state falls on both; medians of ``2 * rounds`` runs each."""
    import torch
    fn()
    library()
    times = ([], [])
    for _ in range(rounds):
        for which in (0, 1, 1, 0):
            f = (fn, library)[which]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                f()
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end) / calls)
    return statistics.median(times[0]), statistics.median(times[1])


def flash_instance(symbol: str):
    """``f32/D64``, ``bf16/D256``... for a mangled flash_kernel symbol,
    else None."""
    k = re.search(r"flash_kernelI(\w+?)Li(\d+)E", symbol)
    return f"{'f32' if k.group(1) == 'f' else 'bf16'}/D{k.group(2)}" if k else None


def ptxas_table(log: str) -> dict:
    """Registers, stack and spills per flash instantiation from nvcc
    ``-Xptxas -v`` output."""
    table, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = flash_instance(m.group(1)) or m.group(1)
            table[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            table[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            table[cur]["registers"] = int(m.group(1))
    return table


def sass_mma_counts(lib: Path) -> dict:
    """HMMA (tensor-core) instructions per flash instantiation in the
    built library's SASS (``cuobjdump -sass``); None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = flash_instance(m.group(1))
            if cur:
                counts[cur] = {"HMMA": 0, "HGMMA": 0}
        elif cur:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[cur][op] += 1
                    break
    return counts


def rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    d = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return d, d / scale if scale else d


def check_kernels(rows: int, bw: float, flops_peak: float, timed: bool):
    """Every kernel against its plain version at (W, rows, 128)."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(rows)
    mk = lambda: torch.randn((W, rows, 128), generator=gen, device=dev)
    n = W * rows * 128
    nbytes = 4 * n
    res = {}

    # fused SGD (Nesterov, decay mask, clip scale, stats), in place on p/u
    p, g, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=gen, device=dev) < 0.9).float()
    gscale = torch.tensor([1.0, 0.5, 0.25, 0.125], device=dev)
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True, gscale=gscale,
              stats=True)
    pk, uk, pp, up = p.clone(), u.clone(), p.clone(), u.clone()
    sk = fb.fused_sgd_bucket(pk, g, uk, 0.05, wd_row, **kw)
    sp = fb.fused_sgd_bucket_plain(pp, g, up, 0.05, wd_row, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(pk, pp), rel_err(uk, up)]
    serr = [rel_err(a, b) for a, b in zip(sk, sp)]
    ok = (all(e[1] <= TOL["elementwise"] for e in errs)
          and all(e[1] <= TOL["reduction"] for e in serr))
    res["fused_sgd_bucket"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        stats_rel_err=max(e[1] for e in serr), tol=TOL["elementwise"],
        stats_tol=TOL["reduction"], ok=ok, bytes=5 * nbytes + 4 * rows,
        flops=10 * n)
    if timed:
        res["fused_sgd_bucket"].update(
            ms=time_ms(lambda: fb.fused_sgd_bucket(pk, g, uk, 0.05, wd_row, **kw)),
            plain_ms=time_ms(lambda: fb.fused_sgd_bucket_plain(pp, g, up, 0.05,
                                                               wd_row, **kw)),
            library_ms=None)
    del p, g, u, pk, uk, pp, up

    x = mk()
    x[:, :7] = 0.0                        # exact zeros: sign(0) must be 0
    a, b = fb.sq_sum(x), fb.sq_sum_plain(x)
    e = rel_err(a, b)
    repeat = bool(torch.equal(a, fb.sq_sum(x)))         # no atomics
    res["sq_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                         tol=TOL["reduction"], same_bits_twice=repeat,
                         ok=e[1] <= TOL["reduction"] and repeat,
                         bytes=nbytes + 4 * W, flops=2 * n)
    a, b = fb.row_abs_sum(x), fb.row_abs_sum_plain(x)
    e = rel_err(a, b)
    res["row_abs_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                              tol=TOL["reduction"], ok=e[1] <= TOL["reduction"],
                              bytes=nbytes + 4 * W * rows, flops=2 * n)
    s = torch.rand((rows,), generator=gen, device=dev)
    a, b = fb.scale_sign_rows(x, s), fb.scale_sign_rows_plain(x, s)
    e = rel_err(a, b)
    res["scale_sign_rows"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                                  tol=TOL["sign"], ok=bool(torch.equal(a, b)),
                                  bytes=2 * nbytes + 4 * rows, flops=n)
    if timed:
        lib = lambda: torch.linalg.vector_norm(x, 2, dim=(-2, -1)).square()
        dev_ms, lib_dev_ms = device_ms(lambda: fb.sq_sum(x), lib)
        res["sq_sum"].update(
            ms=time_ms(lambda: fb.sq_sum(x)),
            plain_ms=time_ms(lambda: fb.sq_sum_plain(x)),
            library_ms=time_ms(lib), device_ms=dev_ms,
            library_device_ms=lib_dev_ms)
        res["row_abs_sum"].update(
            ms=time_ms(lambda: fb.row_abs_sum(x)),
            plain_ms=time_ms(lambda: fb.row_abs_sum_plain(x)),
            library_ms=time_ms(lambda: torch.linalg.vector_norm(x, 1, dim=-1)))
        res["scale_sign_rows"].update(
            ms=time_ms(lambda: fb.scale_sign_rows(x, s)),
            plain_ms=time_ms(lambda: fb.scale_sign_rows_plain(x, s)),
            library_ms=None)
    del x

    # LARS: row norms, then the update with a per-worker, per-row ratio
    p, g, u = mk(), mk(), 0.1 * mk()
    ratio = 0.01 + 2 * torch.rand((W, rows), generator=gen, device=dev)
    a, b = (fb.lars_row_norms(p, g, wd_row, weight_decay=1e-4),
            fb.lars_row_norms_plain(p, g, wd_row, weight_decay=1e-4))
    errs = [rel_err(x, y) for x, y in zip(a, b)]
    res["lars_row_norms"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        tol=TOL["reduction"], ok=all(e[1] <= TOL["reduction"] for e in errs),
        bytes=2 * nbytes + 4 * rows + 2 * 4 * W * rows, flops=6 * n)
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True, stats=True)
    pk, uk, pp, up = p.clone(), u.clone(), p.clone(), u.clone()
    sk = fb.fused_lars_bucket(pk, g, uk, 0.05, wd_row, ratio, **kw)
    sp = fb.fused_lars_bucket_plain(pp, g, up, 0.05, wd_row, ratio, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(pk, pp), rel_err(uk, up)]
    serr = [rel_err(x, y) for x, y in zip(sk, sp)]
    res["fused_lars_bucket"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        stats_rel_err=max(e[1] for e in serr), tol=TOL["elementwise"],
        stats_tol=TOL["reduction"],
        ok=(all(e[1] <= TOL["elementwise"] for e in errs)
            and all(e[1] <= TOL["reduction"] for e in serr)),
        bytes=5 * nbytes + 4 * rows + 4 * W * rows, flops=12 * n)
    if timed:
        res["lars_row_norms"].update(
            ms=time_ms(lambda: fb.lars_row_norms(p, g, wd_row, weight_decay=1e-4)),
            plain_ms=time_ms(lambda: fb.lars_row_norms_plain(p, g, wd_row,
                                                             weight_decay=1e-4)),
            library_ms=None)
        res["fused_lars_bucket"].update(
            ms=time_ms(lambda: fb.fused_lars_bucket(pk, g, uk, 0.05, wd_row,
                                                    ratio, **kw)),
            plain_ms=time_ms(lambda: fb.fused_lars_bucket_plain(
                pp, g, up, 0.05, wd_row, ratio, **kw)),
            library_ms=None)
    del p, g, u, pk, uk, pp, up

    # the port's segmented sum of the per-row totals (kernels 3 and 5 feed
    # it): per worker, and chained over the workers, on paper-lm's leaves
    res["segment_sum"] = check_segment_sum(rows, gen, timed, bw)
    return report(res, bw, flops_peak, W=W, rows=rows)


def segment_layout_index(rows: int, gen):
    """The ``SegmentIndex`` on the card for ``rows`` rows: paper-lm's
    leaves of its one f32 bucket at FULL_ROWS, else leaves of random sizes
    (multiples of 8 rows) with some padding rows left to leaf 0."""
    import torch
    from repro_torch.kernels import fused_bucket as fb
    if rows == FULL_ROWS:
        from repro_torch import configs
        from repro_torch.core import flatbuf
        from repro_torch.models import base as mbase
        from repro_torch.models import lm
        specs = lm.param_specs(configs.get("paper-lm"))
        lay = flatbuf.build_layout(mbase.abstract(specs, torch.float32),
                                   wd_mask=mbase.norm_param_mask(specs))
        assert lay.bucket_rows[0] == rows, lay.bucket_rows
        return flatbuf.segment_index(lay, 0, "cuda")
    sizes = 8 * torch.randint(1, 64, (200,), generator=gen, device="cuda")
    sizes = sizes[torch.cumsum(sizes, 0) <= rows - 5]
    seg = torch.zeros((rows,), dtype=torch.int32, device="cuda")
    seg[:int(sizes.sum())] = torch.repeat_interleave(
        torch.arange(len(sizes), device="cuda", dtype=torch.int32), sizes)
    return fb.segment_index(seg, len(sizes))


def chain_probe() -> dict:
    """The latency of one dependent ``__fadd_rn`` on this card
    (``fused_bucket.fadd_chain_s_per_add``: one thread, 2^25 adds a
    launch, the median of 7), and the SM clock ``nvidia-smi`` reads while
    those chains run (queried from a thread once the probe has started)."""
    import threading
    from repro_torch.kernels import fused_bucket as fb
    clock = {}

    def read_clock():
        time.sleep(0.1)
        out = subprocess.run(["nvidia-smi",
                              "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        lines = out.stdout.strip().splitlines()
        clock["line"] = lines[0] if lines else ""
    reader = threading.Thread(target=read_clock)
    reader.start()
    s_per_add = fb.fadd_chain_s_per_add(1 << 25, reps=7)
    reader.join()
    mhz = re.findall(r"(\d+) MHz", clock["line"])
    rec = {"s_per_add": s_per_add, "sm_clock_MHz": int(mhz[0]) if mhz else None,
           "nvidia_smi_clocks_sm_max_sm": clock["line"]}
    if mhz:
        rec["cycles_per_add"] = s_per_add * int(mhz[0]) * 1e6
    if not (math.isfinite(s_per_add) and s_per_add > 0):
        raise AssertionError(f"the chain probe read no time: {rec}")
    return rec


def check_segment_sum(rows: int, gen, timed: bool, bw: float) -> dict:
    """``fused_bucket.segment_sum`` of (W, rows) row sums, per worker and
    chained over the workers, against its plain version (the host's
    index_add_): the same adds, so the same bits (tolerance 0), and the
    same bits twice.  Timed per worker (``ms``) and chained (``chain_ms``),
    each beside two bounds: the bytes (``bound_ms``, ``chained_bound_ms``)
    and the chain (``chain_bound_ms``, ``chained_chain_bound_ms``: the
    longest chain's adds times the probe's seconds an add, the bound
    under the index-order contract); ``library_ms`` is index_add_ on the
    card (atomic adds) over the same rows."""
    import torch
    from repro_torch.kernels import fused_bucket as fb
    index = segment_layout_index(rows, gen)
    n_seg = index.offsets.numel() - 1
    vals = torch.rand((W, rows), generator=gen, device="cuda")
    init = torch.rand((n_seg,), generator=gen, device="cuda")
    per, chain = fb.segment_sum(vals, index), fb.segment_sum(
        vals, index, chain=True, init=init)
    per_p = fb.segment_sum_plain(vals, index.seg_ids, n_seg)
    chain_p = fb.segment_sum_plain(vals, index.seg_ids, n_seg, chain=True,
                                   init=init)
    e = rel_err(torch.cat([per.reshape(-1), chain]),
                torch.cat([per_p.reshape(-1), chain_p]))
    twice = bool(torch.equal(per, fb.segment_sum(vals, index))
                 and torch.equal(chain, fb.segment_sum(vals, index, chain=True,
                                                       init=init)))
    same = bool(torch.equal(per, per_p) and torch.equal(chain, chain_p))
    longest = int((index.offsets[1:] - index.offsets[:-1]).max())
    # what the sums must move: the row sums once, the index (runs, their
    # offsets, the row offsets, the order of lengths), the totals
    index_bytes = 8 * sum(t.numel() for t in index[1:])
    rec = dict(max_abs_err=e[0], max_rel_err=e[1], tol=0.0,
               equal_plain=same, same_bits_twice=twice, ok=same and twice,
               segments=n_seg, runs=int(index.runs.shape[0]),
               largest_segment_rows=longest,
               bytes=4 * W * rows + index_bytes + 4 * W * n_seg,
               flops=W * rows)
    if timed:
        ids = (index.seg_ids[None] + n_seg * torch.arange(
            W, device="cuda")[:, None]).reshape(-1)
        flat = vals.reshape(-1)
        lib = lambda: torch.zeros((W * n_seg,), device="cuda").index_add_(
            0, ids, flat)
        probe = chain_probe()
        per_dev, lib_dev = device_ms(lambda: fb.segment_sum(vals, index), lib)
        chain_dev, _ = device_ms(
            lambda: fb.segment_sum(vals, index, chain=True), lib)
        rec.update(
            ms=time_ms(lambda: fb.segment_sum(vals, index)),
            chain_ms=time_ms(lambda: fb.segment_sum(vals, index, chain=True)),
            device_ms=per_dev, chain_device_ms=chain_dev,
            plain_ms=time_ms(lambda: fb.segment_sum_plain(vals, index.seg_ids,
                                                          n_seg), reps=5),
            library_ms=time_ms(lib), library_device_ms=lib_dev,
            chain_probe=probe, nvidia_smi=nvidia_smi_line(),
            chain_bound_ms=1e3 * longest * probe["s_per_add"],
            chained_chain_bound_ms=1e3 * W * longest * probe["s_per_add"],
            chained_bound_ms=1e3 * (4 * W * rows + index_bytes + 4 * n_seg)
            / bw)
        rec.update(chain_bound_share=rec["chain_bound_ms"] / rec["ms"],
                   chained_chain_bound_share=(rec["chained_chain_bound_ms"]
                                              / rec["chain_ms"]))
    return rec


def check_mlp_bucket(bw: float, flops_peak: float):
    """The kernels of the paper harness's path against their plain versions
    at its bucket, (MLP_W, MLP_ROWS, 128) f32, as the harness calls them:
    the update without a clip scale or stats (grad_clip 0, telemetry off)."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    dev, W_, rows = "cuda", MLP_W, MLP_ROWS
    gen = torch.Generator(device=dev).manual_seed(rows)
    mk = lambda: torch.randn((W_, rows, 128), generator=gen, device=dev)
    n = W_ * rows * 128
    nbytes = 4 * n
    res = {}
    p, g, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=gen, device=dev) < 0.9).float()
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    pk, uk, pp, up = p.clone(), u.clone(), p.clone(), u.clone()
    fb.fused_sgd_bucket(pk, g, uk, 0.15, wd_row, **kw)
    fb.fused_sgd_bucket_plain(pp, g, up, 0.15, wd_row, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(pk, pp), rel_err(uk, up)]
    res["fused_sgd_bucket"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        tol=TOL["elementwise"], ok=all(e[1] <= TOL["elementwise"] for e in errs),
        bytes=5 * nbytes + 4 * rows, flops=10 * n,
        ms=time_ms(lambda: fb.fused_sgd_bucket(pk, g, uk, 0.15, wd_row, **kw)),
        plain_ms=time_ms(lambda: fb.fused_sgd_bucket_plain(pp, g, up, 0.15,
                                                           wd_row, **kw)),
        library_ms=None)
    x = mk()
    x[:, :7] = 0.0                        # exact zeros: sign(0) must be 0
    a, b = fb.row_abs_sum(x), fb.row_abs_sum_plain(x)
    e = rel_err(a, b)
    res["row_abs_sum"] = dict(
        max_abs_err=e[0], max_rel_err=e[1], tol=TOL["reduction"],
        ok=e[1] <= TOL["reduction"], bytes=nbytes + 4 * W_ * rows, flops=2 * n,
        ms=time_ms(lambda: fb.row_abs_sum(x)),
        plain_ms=time_ms(lambda: fb.row_abs_sum_plain(x)),
        library_ms=time_ms(lambda: torch.linalg.vector_norm(x, 1, dim=-1)))
    s_ = torch.rand((rows,), generator=gen, device=dev)
    a, b = fb.scale_sign_rows(x, s_), fb.scale_sign_rows_plain(x, s_)
    e = rel_err(a, b)
    res["scale_sign_rows"] = dict(
        max_abs_err=e[0], max_rel_err=e[1], tol=TOL["sign"],
        ok=bool(torch.equal(a, b)), bytes=2 * nbytes + 4 * rows, flops=n,
        ms=time_ms(lambda: fb.scale_sign_rows(x, s_)),
        plain_ms=time_ms(lambda: fb.scale_sign_rows_plain(x, s_)),
        library_ms=None)
    return report(res, bw, flops_peak, W=W_, rows=rows, shape="mlp bucket")


def report(res: dict, bw: float, flops_peak: float, **where):
    """Add each record's bound, emit it, and raise on a disagreement."""
    import torch
    for name, r in res.items():
        ops_s = r.pop("ops_s", r["flops"] / flops_peak)
        r["bound_ms"] = 1e3 * max(r["bytes"] / bw, ops_s)
        r["bound_by"] = "bytes" if r["bytes"] / bw >= ops_s else "operations"
        emit({"phase": "kernels", "kernel": name, **where, **r})
        if not r["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"{where}: {r}")
    torch.cuda.empty_cache()
    return res


def kernel_order_row_abs_sum(x):
    """Per-row sum |x| of a (*lead, rows, 128) f32 tensor in
    ``fb_row_abs_sum``'s order (one warp a row: each lane adds its 4
    neighbouring |x| as (a + b) + (c + d), then the lanes add in a
    butterfly, 16 apart, 8, 4, 2, 1), so the card's row sums and these take
    the same bits.  The port's plain version sums in torch's order, within
    rounding of the kernel's."""
    a = x.float().abs().unflatten(-1, (32, 4))
    s = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
    for half in (16, 8, 4, 2, 1):
        s = s[..., :half] + s[..., half:2 * half]
    return s[..., 0]


def cpu_pack(x, seg, sizes):
    """``compression.pack_bucket_signs`` of ``x`` on the CPU with its row
    sums in the kernel's order: the card's pack (the kernel's row sums, the
    index-order segmented sum, the division by the sizes), bit for bit."""
    from repro_torch.core import compression as comp
    from repro_torch.kernels import fused_bucket as fb
    plain = fb.row_abs_sum_plain
    fb.row_abs_sum_plain = kernel_order_row_abs_sum
    try:
        return comp.pack_bucket_signs(x.cpu(), seg, sizes)
    finally:
        fb.row_abs_sum_plain = plain


def bf16_ulp(x):
    """One bfloat16 ulp at each entry of x (as f32)."""
    import torch
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_per_tensor(n: int, bw: float, flops_peak: float, timed: bool):
    """The three per-tensor kernels against their plain versions on one
    tensor of n elements."""
    import torch
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import sign_compress as sc

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(n)
    res = {}
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    for dt in (torch.float32, torch.bfloat16):
        p, g, u = (torch.randn((n,), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        got = fs.fused_sgd_2d(p, g, u, 0.05, **kw)
        want = fs.fused_sgd_2d_plain(p, g, u, 0.05, **kw)
        torch.cuda.synchronize()
        errs = [rel_err(a.float(), b.float()) for a, b in zip(got, want)]
        r = dict(dtype=str(dt).removeprefix("torch."),
                 max_abs_err=max(e[0] for e in errs),
                 max_rel_err=max(e[1] for e in errs),
                 bytes=5 * p.element_size() * n, flops=8 * n)
        if dt == torch.float32:
            r.update(tol=TOL["elementwise"],
                     ok=all(e[1] <= TOL["elementwise"] for e in errs))
        else:
            ulps = max(float(((a.float() - b.float()).abs() / bf16_ulp(b)).max())
                       for a, b in zip(got, want))
            r.update(tol="1 bf16 ulp", max_ulps=ulps, ok=ulps <= 1.0)
        if timed:
            # torch._fused_sgd_ (SGD(fused=True)'s kernel) computes the same
            # update in place: timed on clones, never used by the port
            lib = [[t.clone()] for t in (p, g, u)]
            sgd = lambda: torch._fused_sgd_(
                *lib, weight_decay=1e-4, momentum=0.9, lr=0.05, dampening=0.0,
                nesterov=True, maximize=False, is_first_step=False)
            sgd()
            lib_err = max(rel_err(a[0].float(), b.float())[1]
                          for a, b in zip((lib[0], lib[2]), want))
            r.update(ms=time_ms(lambda: fs.fused_sgd_2d(p, g, u, 0.05, **kw)),
                     plain_ms=time_ms(lambda: fs.fused_sgd_2d_plain(p, g, u, 0.05,
                                                                   **kw)),
                     library_ms=time_ms(sgd), library_max_rel_err=lib_err)
            del lib
        res["fused_sgd_2d" + ("" if dt == torch.float32 else "_bf16")] = r
        del p, g, u, got, want

    x = torch.randn((n,), generator=gen, device=dev)
    x[::7] = 0.0                          # exact zeros: sign(0) must be 0
    a, b = sc.abs_sum(x), sc.abs_sum_plain(x)
    e = rel_err(a, b)
    repeat = bool(torch.equal(a, sc.abs_sum(x)))        # no atomics
    res["abs_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                          tol=TOL["reduction"], same_bits_twice=repeat,
                          ok=e[1] <= TOL["reduction"] and repeat,
                          bytes=4 * n + 4, flops=2 * n)
    s = a / n
    y, yp = sc.scale_sign(x, s), sc.scale_sign_plain(x, s)
    e = rel_err(y, yp)
    res["scale_sign"] = dict(max_abs_err=e[0], max_rel_err=e[1], tol=TOL["sign"],
                             ok=bool(torch.equal(y, yp)), bytes=8 * n + 4,
                             flops=n)
    if timed:
        lib = lambda: torch.linalg.vector_norm(x, 1)
        dev_ms, lib_dev_ms = device_ms(lambda: sc.abs_sum(x), lib)
        res["abs_sum"].update(
            ms=time_ms(lambda: sc.abs_sum(x)),
            plain_ms=time_ms(lambda: sc.abs_sum_plain(x)),
            library_ms=time_ms(lib), device_ms=dev_ms,
            library_device_ms=lib_dev_ms)
        res["scale_sign"].update(
            ms=time_ms(lambda: sc.scale_sign(x, s)),
            plain_ms=time_ms(lambda: sc.scale_sign_plain(x, s)),
            library_ms=None)
    del x, y, yp
    return report(res, bw, flops_peak, n=n)


def sdpa_call(q, k, v, window: int):
    """``scaled_dot_product_attention`` on the same inputs, causal (and
    banded by an explicit mask with a window), kv heads repeated outside
    the call: the yardstick, never used by the port."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    G = q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2)
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1)
    mask = (fa.band_mask(q.shape[1], k.shape[1], causal=True, window=window,
                         device=q.device) if window else None)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  is_causal=mask is None)


def check_flash(spec, bw: float, flops_peak: float, bf16_peak: float,
                tf32_peak: float, timed: bool):
    """The flash kernel (through ops.flash_attention) against its plain
    version, causal, on random (B, S, H, D) inputs.  The bound is the
    least time for a result of f32 accuracy on the tensor cores, over the
    unmasked (q, k) pairs of this mask counted exactly, 2·D flops a pair
    for q·k and 2·D for p·v: f32 both products in 3xTF32 (three TF32
    products each, so a third of the TF32 rate); bf16 q·k at the bf16
    rate (a product of bf16 values is exact in f32) and p·v at half of it
    (p split into two bf16 parts)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    label, B, S, H, KH, D, window, dtype = spec
    dev, dt = "cuda", getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(S + D)
    mk = lambda h: torch.randn((B, S, h, D), generator=gen, device=dev).to(dt)
    q, k, v = mk(H), mk(KH), mk(KH)
    run = lambda: ops.flash_attention(q, k, v, causal=True, window=window)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window)
    got, want = run(), plain()
    torch.cuda.synchronize()
    e = rel_err(got.float(), want.float())
    rtol = 0.0 if dtype == "float32" else TOL["flash_bf16_rtol"]
    bound = TOL["flash_f32"] * want.float().abs().max() + rtol * want.float().abs()
    ratio = float(((got.float() - want.float()).abs() / bound).max())
    pairs = int(fa.band_mask(S, S, causal=True, window=window,
                             device=dev).sum()) * B * H
    qk_rate, pv_rate = ((tf32_peak / 3, tf32_peak / 3) if dtype == "float32"
                        else (bf16_peak, bf16_peak / 2))
    r = dict(max_abs_err=e[0], max_rel_err=e[1], tol=TOL["flash_f32"],
             elementwise_rtol=rtol, max_err_over_tol=ratio, ok=ratio <= 1.0,
             unmasked_pairs=pairs, flops=4 * D * pairs,
             ops_s=2 * D * pairs / qk_rate + 2 * D * pairs / pv_rate,
             bytes=q.element_size() * 2 * (q.numel() + k.numel()))
    if timed:
        lib = sdpa_call(q, k, v, window)
        dev_ms, lib_dev_ms = device_ms(run, lib)
        r.update(ms=time_ms(run), plain_ms=time_ms(plain), library_ms=time_ms(lib),
                 device_ms=dev_ms, library_device_ms=lib_dev_ms,
                 library_max_rel_err=rel_err(lib().transpose(1, 2).float(),
                                             want.float())[1])
    del q, k, v, got, want
    name = "flash_attention_bhsd" + ("" if spec == FLASH_MAIN else
                                     f"@{label}/{dtype}")
    return report({name: r}, bw, flops_peak, shape=label, B=B, S=S, H=H, KH=KH,
                  D=D, causal=True, window=window, dtype=dtype)


def train_run(run, *, device, steps, params0=None, seed=0, telemetry_path=None,
              tracer=None, manifest_path=None, workers=W, bundle=None, data=None,
              backend=None):
    """fit() on markov_lm data at ``workers`` workers (through ``bundle``
    when given, else a fresh ``build_train``), or on ``data`` (a dict of
    example arrays) when given; returns (state, history, summary,
    step_s): host seconds per step, each from one local step's start to
    the next's (a device synchronize before each), the sync included on
    sync steps."""
    import torch
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_train

    S = run.shape.seq_len
    B = run.shape.global_batch // workers
    if data is None:
        data = lm_examples(markov_lm(vocab=run.model.vocab_size,
                                     num_seqs=workers * B * 4, seq_len=S, seed=seed))
    if bundle is None:
        bundle = build_train(run, num_workers=workers, device=device)
    step_s = []
    local_step = bundle.local_step

    def timed_step(*args):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter())
        return local_step(*args)

    bundle.local_step = timed_step
    try:
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(data, workers, B, seed=seed), bundle=bundle,
            num_steps=steps, seed=seed, params0=params0, log=lambda *a: None,
            telemetry_path=telemetry_path, tracer=tracer,
            manifest_path=manifest_path, backend=backend)
    finally:
        bundle.local_step = local_step
    step_s.append(summ["wall_s"] + step_s[0])
    return state, hist, summ, [b - a for a, b in zip(step_s, step_s[1:])]


# aten ops of the gradient assembly, read from phase P's profile
ASSEMBLY_OPS = ("aten::add", "aten::add_", "aten::slice_backward",
                "aten::zeros_like", "aten::copy_", "aten::fill_")
BUCKET_KERNELS = ("update_kernel", "sq_sum_kernel", "reduce_rows_kernel",
                  "row_abs_sum_kernel", "scale_sign_rows_kernel",
                  "lars_row_norms_kernel")


def kernel_family(name: str) -> str:
    if any(k in name for k in BUCKET_KERNELS):
        return "bucket kernels (this port)"
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "other (elementwise, reductions, copies)"


def profile_phase(run):
    """Device time by kernel under torch.profiler for 2 local steps + 1
    sync of the full-width trainer (after 3 warm-up steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch.steps import build_train
    from repro_torch.models import base as mbase

    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=run.model.vocab_size, num_seqs=W * B * 2,
                                 seq_len=run.shape.seq_len))
    it = ShardedBatches(data, W, B)
    bundle = build_train(run, num_workers=W, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = bundle.init(mbase.materialize(bundle.specs, gen, "cuda"))
    for _ in range(3):
        state = bundle.local_step(state, next(it))[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state = bundle.local_step(state, next(it))[0]
        state = bundle.sync(state, plan=bundle.sync_plan)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    fam: dict = {}
    for e in kern:
        f = kernel_family(e.key)
        fam[f] = fam.get(f, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    reduce_rows = sum(e.count for e in kern if "reduce_rows_kernel" in e.key)
    # the gradient assembly's share: the float add and fill kernels, and
    # the aten ops that launch them, with their device time
    kernel_calls = {f: [sum(e.count for e in kern if f in e.key),
                        sum(e.self_device_time_total for e in kern
                            if f in e.key) / 1e3]
                    for f in ("CUDAFunctor_add<float>", "FillFunctor<float>")}
    aten = {e.key: [e.count, e.device_time_total / 1e3]
            for e in prof.key_averages() if e.key in ASSEMBLY_OPS}
    emit({"phase": "P", "optimizer": run.optim.optimizer,
          "telemetry": run.controller.wants_telemetry,
          "window": "2 local steps + 1 ef_sign sync",
          "wall_ms_under_profiler": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "idle_share": 1 - busy_ms / wall_ms if kern else None,
          "by_family_ms": fam,
          "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                          for e in top],
          "reduce_rows_launches": reduce_rows,
          "kernel_calls_ms": kernel_calls, "aten_calls_device_ms": aten})
    if not run.controller.wants_telemetry and reduce_rows:
        raise AssertionError(f"phase P: {reduce_rows} reduce_rows_kernel "
                             "launches in an SGD window without stats")
    del state


def phase_t(cfg) -> dict:
    """Phase T: the per-tensor kernel API at full width on paper-lm's
    parameter tree (W=1), each result held against the path it mirrors;
    returns the launch counts of the driven calls."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import sign_compress as sc
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.models.layers import chunked_attention
    from repro_torch.utils import tree_leaves, tree_map

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)
    params = mbase.materialize(lm.param_specs(cfg), gen, dev)
    noise = lambda scale: tree_map(
        lambda t: scale * torch.randn(t.shape, generator=gen, device=dev), params)
    grads, mom, delta = noise(1e-2), noise(1e-3), noise(1e-3)
    layout = flatbuf.build_layout(params)
    n_leaves = layout.num_leaves
    lr, kw = 0.05, dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lr_dev = torch.tensor(lr, device=dev)
    B, S, H, KH, D = FLASH_MAIN[1:6]
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               for h in (H, KH, KH))
    leaves = list(zip(*(tree_leaves(t) for t in (params, grads, mom))))
    per_leaf_sgd = lambda: [ops.fused_sgd(p, g, u, lr=lr_dev, **kw)
                            for p, g, u in leaves]
    per_leaf_sign = lambda: [ops.sign_compress(d) for d in tree_leaves(delta)]

    for mod in (fs, sc, fa):
        mod.reset_launches()
    upd = per_leaf_sgd()
    ys = per_leaf_sign()
    o_flash = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = {**fs.LAUNCHES, **sc.LAUNCHES, **fa.LAUNCHES}

    # the same SGD step by the bucket kernel: lead (), decay on every row
    P, G, U = (flatbuf.flatten(layout, t)[0] for t in (params, grads, mom))
    wd_row = torch.ones((P.shape[0],), device=dev)
    bucket_sgd = lambda: fb.fused_sgd_bucket(P, G, U, lr, wd_row, **kw)
    bucket_sgd()
    pb = tree_leaves(flatbuf.unflatten(layout, [P]))
    ub = tree_leaves(flatbuf.unflatten(layout, [U]))
    p_err = max(float((a - b).abs().max()) for (a, _), b in zip(upd, pb))
    u_err = max(float((a - b).abs().max()) for (_, a), b in zip(upd, ub))
    p_max = max(float(b.abs().max()) for b in pb)
    u_max = max(float(b.abs().max()) for b in ub)

    # the same compressor by the bucket kernels, per-segment scales
    X = flatbuf.flatten(layout, delta)[0]
    seg = flatbuf.const("row_segments", layout, 0, dev)
    sizes = flatbuf.const("segment_sizes", layout, 0, dev)
    bucket_sign = lambda: ops.bucket_sign_compress(X, seg, sizes)
    yb, scales = bucket_sign()
    leaf_scales = torch.stack([y.abs().amax() for y in ys])
    exact = torch.stack([d.double().abs().sum() / d.numel()
                         for d in tree_leaves(delta)])
    rel = lambda a, b: float(((a.double() - b).abs() / b).max())
    scale_rel = rel(leaf_scales, scales.double())
    leaf_rel, bucket_rel = rel(leaf_scales, exact), rel(scales, exact)
    signs_equal = all(torch.equal(torch.sign(a), torch.sign(b)) for a, b in
                      zip(ys, tree_leaves(flatbuf.unflatten(layout, [yb]))))

    o_train = chunked_attention(q, k, v)
    f_err = rel_err(o_flash, o_train)
    rec = {"phase": "T", "model": cfg.name, "leaves": n_leaves,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "launches": counts,
           "sgd_p_max_abs_err": p_err, "sgd_p_rel": p_err / p_max,
           "sgd_u_max_abs_err": u_err, "sgd_u_rel": u_err / u_max,
           "sgd_tol": TOL["elementwise"],
           "sign_scale_max_rel_err": scale_rel, "sign_scale_tol": TOL["scatter_add"],
           "leaf_scale_vs_f64_rel": leaf_rel, "leaf_scale_vs_f64_tol": TOL["reduction"],
           "bucket_scale_vs_f64_rel": bucket_rel,
           "signs_equal": signs_equal,
           "flash_vs_training_attention_max_abs_err": f_err[0],
           "flash_vs_training_attention_rel": f_err[1],
           "flash_tol": TOL["flash_f32"],
           "per_leaf_sgd_ms": time_ms(per_leaf_sgd),
           "bucket_sgd_ms": time_ms(bucket_sgd),
           "per_leaf_sign_ms": time_ms(per_leaf_sign),
           "bucket_sign_ms": time_ms(bucket_sign),
           "flash_ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
           "training_attention_ms": time_ms(lambda: chunked_attention(q, k, v)),
           "library_ms": time_ms(sdpa_call(q, k, v, 0))}
    emit(rec)
    want = {"fused_sgd_2d": n_leaves, "abs_sum": n_leaves,
            "scale_sign": n_leaves, "flash_attention_bhsd": 1}
    bad = [k for k, ok in (
        ("launches", counts == want),
        ("sgd", max(p_err / p_max, u_err / u_max) <= TOL["elementwise"]),
        ("sign scales", scale_rel <= TOL["scatter_add"]),
        ("per-leaf scales", leaf_rel <= TOL["reduction"]), ("signs", signs_equal),
        ("flash", f_err[1] <= TOL["flash_f32"])) if not ok]
    if bad:
        raise AssertionError(f"phase T: {', '.join(bad)} (launches {counts}, "
                             f"want {want})")
    return counts


def phase_run(mode: str, cfg, seq: int, local_batch: int, *, steps=STEPS,
              lars: bool = False, block_steps: int = 1, controller=None,
              noise_eta: float = 0.0, workers: int = W,
              wire_pack: bool = False, coalesce: bool = False):
    """The phases' RunConfig (``workers`` x ``local_batch`` sequences a
    step); ``lars`` switches to LARS with telemetry
    (grad_clip stays set: LARS ignores it); ``block_steps`` > 1 is
    hierarchical local SGD (Alg. 5, the default two blocks);
    ``controller`` a ``ControllerConfig`` keyword dict (an adaptive
    policy); ``noise_eta`` the gradient noise; ``wire_pack`` /
    ``coalesce`` the 1-bit wire format and coalesced syncs."""
    from repro_torch.configs.base import (ControllerConfig, InputShape,
                                          LocalSGDConfig, OptimConfig, RunConfig)
    opt = (dict(optimizer="lars", base_lr=LARS_LR, lars_trust=LARS_TRUST)
           if lars else dict(base_lr=0.3))
    return RunConfig(
        model=cfg, shape=InputShape("chip", seq, workers * local_batch, "train"),
        local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4,
                                 sync_compression=mode,
                                 block_steps=block_steps, wire_pack=wire_pack,
                                 sync_coalesce=coalesce),
        optim=OptimConfig(base_batch=32, lr_warmup_steps=2, grad_clip=1.0,
                          noise_eta=noise_eta, **opt),
        controller=ControllerConfig(**(controller or dict(telemetry=lars))),
        steps=steps)


def b_repeat(state, b_state, losses: list, b_losses: list) -> dict:
    """Phase B's run against itself: losses, and every bucket of params,
    momentum, anchor and EF memory, bit for bit; where a bucket differs,
    its largest difference over its largest entry."""
    import torch
    fields = {}
    for f in ("params", "momentum", "anchor", "ef_memory"):
        a, b = getattr(state, f), getattr(b_state, f)
        for i, (x, y) in enumerate(zip(a.buckets, b.buckets)):
            eq = bool(torch.equal(x, y))
            fields[f"{f}.{i}"] = 0.0 if eq else float(
                (x - y).abs().max() / y.abs().max().clamp_min(1e-30))
    return {"losses_equal": losses == b_losses,
            "loss_max_abs_diff": max(abs(a - b) for a, b in zip(losses, b_losses)),
            "buckets_max_rel_diff": fields,
            "bit_for_bit": losses == b_losses and not any(fields.values())}


def phase_h(cfg, a_step_s: float) -> dict:
    """Phase H: hierarchical local SGD (Alg. 5) at full width with phase
    A's settings and block_steps=2; returns its launch counts."""
    import torch
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.kernels import fused_bucket as fb

    run = phase_run("none", cfg, seq=512, local_batch=8, block_steps=2)
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    syncs = [(h["step"], h["synced"]) for h in hist if h["synced"]]
    want_syncs = [(t, "block" if level == 1 else "global")
                  for t, level in sync_boundaries(run.local_sgd, STEPS)]
    bucket = FULL_ROWS * 128 * 4          # one worker copy of the f32 bucket
    led = summ["ledger"]
    topo = {k: (v["rounds"], v["wire_bytes"], v["collectives"])
            for k, v in led["topologies"].items()}
    # ring all-reduce over n workers: 2 (n - 1) / n x the bucket each
    want_topo = {"hierarchical/block": (3, 3 * 1.0 * bucket, 3),
                 "hierarchical/global": (3, 3 * 1.5 * bucket, 3)}
    median = statistics.median(step_s[1:])
    tokens = run.shape.global_batch * run.shape.seq_len
    emit({"phase": "H", "model": cfg.name, "W": W, "local_batch": 8, "seq": 512,
          "block_steps": 2, "topology": summ["topology"], "steps": STEPS,
          "loss": losses, "comm_rounds": summ["comm_rounds"], "syncs": syncs,
          "ledger_topologies": led["topologies"],
          "ledger_wire_MB": led["wire_bytes"] / 1e6,
          "flat_rounds_wire_MB": 6 * 1.5 * bucket / 1e6,
          "step_s": step_s, "step_s_median": median,
          "phase_A_step_s_median": a_step_s, "step_s_over_phase_A": median / a_step_s,
          "tokens_per_s": tokens / median, "wall_s": summ["wall_s"],
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS)
    bad = [k for k, ok in (
        ("loss not finite or not falling",
         all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("syncs", syncs == want_syncs == [(0, "block"), (1, "global"), (2, "block"),
                                          (3, "global"), (7, "block"), (11, "global")]),
        ("comm rounds", summ["comm_rounds"] == {"block": 3, "global": 3}),
        ("topology", summ["topology"] == "hierarchical(block_size=2)"),
        ("ledger", topo == want_topo and led["wire_bytes"] == 7.5 * bucket),
        ("launches", counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase H: {', '.join(bad)} (syncs {syncs}, ledger "
                             f"{topo}, launches {counts})")
    REFS["H"] = {"loss": losses, "comm_rounds": summ["comm_rounds"],
                 "syncs": syncs, "row_sha": row_digests(state.params.buckets[0])}
    del state
    return counts


# phase F: the reference's default per-leaf tree path (use_kernel=False) and
# its tree-in/tree-out kernel form, at phase A's width and schedule.  Each
# part: (tag, sync compression, LARS, the resident phase it is held against,
# build_train's keywords, the share of params elements allowed beyond 1e-4
# of the largest: 1e-4 where EF-sign may flip a delta within rounding of 0,
# 1e-3 for LARS + EF-sign, phase C's rules)
F_PARTS = (("F1", "none", False, "A", dict(use_kernel=False), 1e-4),
           ("F2", "ef_sign", False, "B", dict(resident=False), 1e-4),
           ("F3", "ef_sign", True, "L", dict(resident=False), 1e-3))
# the pack / unpack passes over the whole stacked state that a kernel-form
# step makes and a resident step does not: the reference's count (pack p, g,
# u and unpack p, u: a read and a write each, local_sgd.py:35-36) and the
# port's (its unpack is a view: the packs of p, g and u, and the stack of
# the W workers' gradients)
F_REF_PASSES, F_PORT_PASSES = 10, 8
F_QUICKSTART_STEPS = 40


def f_pack_timing(state, wd_mask, bw: float) -> dict:
    """Device ms of what a kernel-form SGD step adds to a resident one, on
    phase F2's final tree state (its momentum stands in for the gradient:
    only shapes and bytes matter here): the stack of the W workers'
    gradients, the packs of p, g and u (``flatbuf.flatten``: a zero fill
    and a copy each), the kernels on the packed buckets
    (``apply_sgd_buckets``: ``sq_sum`` and the fused update) and the whole
    tree-in/tree-out call (``apply_sgd(use_kernel=True)``: packs, kernels,
    the unpack's views); medians of 10 calls timed one at a time with CUDA
    events, beside the bytes the stack and the packs must move (each
    input read once, each output written once) at the card's rate."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.optim import sgd as osgd
    from repro_torch.utils import tree_leaves, tree_map

    p, u = state.params, state.momentum
    g = tree_map(torch.clone, u)
    per_worker = [[x[w] for x in tree_leaves(g)] for w in range(W)]
    layout = flatbuf.build_layout(p, wd_mask=wd_mask, leading=1)
    pb, gb, ub = (flatbuf.flatten(layout, t, leading=1) for t in (p, g, u))
    kw = dict(lr=0.01, momentum_coef=0.9, weight_decay=1e-4, nesterov=True,
              grad_clip=1.0)
    calls = {
        "stack": lambda: [torch.stack(xs) for xs in zip(*per_worker)],
        "pack": lambda: [flatbuf.flatten(layout, t, leading=1)
                         for t in (p, g, u)],
        "kernels": lambda: osgd.apply_sgd_buckets(layout, pb, gb, ub, **kw),
        "tree_call": lambda: osgd.apply_sgd(p, g, u, wd_mask=wd_mask,
                                            use_kernel=True, leading=1, **kw)}
    ms = {k: time_ms(f, reps=10, warmup=2) for k, f in calls.items()}
    state_bytes = W * FULL_ROWS * 128 * 4
    out = {f"{k}_ms": v for k, v in ms.items()}
    out.update(stack_bound_ms=1e3 * 2 * state_bytes / bw,
               pack_bound_ms=1e3 * 6 * state_bytes / bw,
               tree_call_minus_kernels_ms=ms["tree_call"] - ms["kernels"])
    return out


def phase_f(cfg, step_median: dict, bw: float) -> dict:
    """Phase F: the tree path at paper-lm's full width, W=4, local batch 8,
    seq 512, phase A's schedule, through ``build_train(use_kernel=False)``
    (F1, plain per-leaf PyTorch, mean sync) and ``build_train(
    resident=False)`` (F2 EF-sign, F3 LARS + EF-sign with telemetry: the
    tree-in/tree-out kernel form), each held against its resident phase
    (``REFS[...]["rows"]``, its final params bucket): losses rtol 1e-4, the
    final params rows (their worker mean for F1), whether bit for bit;
    launch counts (F1 none); the step time beside the resident phase's and
    the pack / unpack passes' bytes at the card's rate as their bound.
    Then the quickstart twin on the card.  Returns the launch counts."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.core.local_sgd import is_resident
    from repro_torch.examples import quickstart
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.steps import build_train
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.telemetry.stats import round_summary

    total = {k: 0 for k in KERNELS}
    state_bytes = W * FULL_ROWS * 128 * 4
    for tag, mode, lars, ref, kw, frac_tol in F_PARTS:
        run = phase_run(mode, cfg, seq=512, local_batch=8, lars=lars)
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launches()
        bundle = build_train(run, num_workers=W, device="cuda", **kw)
        state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS,
                                              bundle=bundle)
        counts = dict(fb.LAUNCHES)
        seg = fb.PORT_LAUNCHES["segment_sum"]
        losses = [h["loss"] for h in hist]
        want_losses = REFS[ref]["loss"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        lay = flatbuf.build_layout(state.params, leading=1)
        rows = flatbuf.flatten(lay, state.params, leading=1)[0]
        want_rows = REFS[ref]["rows"]
        got_p, want_p = ((rows.mean(dim=0), want_rows.mean(dim=0))
                         if tag == "F1" else (rows, want_rows))
        d = (got_p - want_p).abs()
        scale = float(want_p.abs().max())
        frac = float((d > 1e-4 * scale).float().mean())
        median = statistics.median(step_s[1:])
        ref_median = step_median[ref]
        kernel_form = "resident" in kw
        rec = {"phase": tag, "model": cfg.name, "W": W, "local_batch": 8,
               "seq": 512, "form": ("tree-in/tree-out kernels" if kernel_form
                                    else "per-leaf plain PyTorch"),
               "build_train": kw, "sync_compression": mode,
               "optimizer": run.optim.optimizer, "steps": STEPS,
               "loss": losses, "held_against": ref,
               "loss_max_rel_diff": loss_rel, "loss_tol": 1e-4,
               "params": "worker mean" if tag == "F1" else "rows of every worker",
               "params_max_abs_diff": float(d.max()),
               "params_frac_beyond_1e-4_of_max": frac, "frac_tol": frac_tol,
               "bit_for_bit": (losses == want_losses
                               and bool(torch.equal(got_p, want_p))),
               "comm_rounds": summ["comm_rounds"], "step_s": step_s,
               "step_s_median": median, f"phase_{ref}_step_s_median": ref_median,
               "step_s_over_resident": median / ref_median,
               "step_s_minus_resident": median - ref_median,
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts, "segment_sum_launches": seg}
        if kernel_form:
            rec.update(
                reference_pack_passes=F_REF_PASSES,
                reference_pack_bytes=F_REF_PASSES * state_bytes,
                reference_pack_bound_ms=1e3 * F_REF_PASSES * state_bytes / bw,
                port_pack_passes=F_PORT_PASSES,
                port_pack_bytes=F_PORT_PASSES * state_bytes,
                port_pack_bound_ms=1e3 * F_PORT_PASSES * state_bytes / bw)
        if tag == "F2":
            rec["pack_timing"] = f_pack_timing(
                state, mbase.norm_param_mask(lm.param_specs(cfg)), bw)
        summary = round_summary(state.stats) if lars else None
        if lars:
            want_s = REFS[ref]["round_summary"]
            rec["round_summary"] = summary
            rec["round_summary_rel_diff_vs_" + ref] = {
                k: abs(v - want_s[k]) / abs(want_s[k]) if want_s[k] else abs(v)
                for k, v in summary.items() if isinstance(v, float)}
        emit(rec)
        syncs = summ["comm_rounds"]["global"]
        comp = syncs if mode != "none" else 0
        want = {k: 0 for k in fb.LAUNCHES}
        want_seg = 0
        if kernel_form:
            want.update(row_abs_sum=comp, scale_sign_rows=comp)
            if lars:
                want.update(lars_row_norms=STEPS, fused_lars_bucket=STEPS)
            else:
                want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS)
            want_seg = comp + (STEPS if lars else 0)
        bad = [k for k, ok in (
            ("tree state", not is_resident(state)),
            ("loss not finite or not falling",
             all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
            ("losses", loss_rel <= 1e-4),
            ("params", frac <= frac_tol),
            ("comm rounds", summ["comm_rounds"] == REFS[ref]["comm_rounds"]),
            ("launches", counts == want and seg == want_seg),
            ("pack timing", tag != "F2" or all(
                math.isfinite(v) and (v > 0 or k == "tree_call_minus_kernels_ms")
                for k, v in rec["pack_timing"].items())),
            ("telemetry", not lars or (
                summary["rounds"] == syncs and summary["comp_measured"]
                and all(math.isfinite(v) for v in summary.values()
                        if isinstance(v, float))))) if not ok]
        if bad:
            raise AssertionError(f"phase {tag}: {', '.join(bad)} (launches "
                                 f"{counts}, segment_sum {seg})")
        for k, v in counts.items():
            total[k] += v
        total["segment_sum"] += seg
        del state, rows, got_p, want_p, d, bundle
        gc.collect()
        torch.cuda.empty_cache()

    # the quickstart twin, on the card by default (no --device)
    fb.reset_launches()
    t0 = time.perf_counter()
    out = quickstart.main(["--steps", str(F_QUICKSTART_STEPS)],
                          log=lambda *a: None)
    wall = time.perf_counter() - t0
    counts = dict(fb.LAUNCHES)
    losses = out["losses"]
    emit({"phase": "F-quickstart", "module": "repro_torch.examples.quickstart",
          "device": out["device"], "steps": F_QUICKSTART_STEPS,
          "loss_first": losses[0], "loss_last": losses[-1],
          "eval_xent": out["eval_xent"], "comm_rounds": out["comm_rounds"],
          "fit_wall_s": out["wall_s"], "wall_s": wall, "launches": counts})
    if not (out["device"].startswith("cuda")
            and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and counts["fused_sgd_bucket"] == F_QUICKSTART_STEPS
            and out["comm_rounds"]["global"] < F_QUICKSTART_STEPS):
        raise AssertionError(f"phase F: the quickstart twin on the card: {out}")
    for k, v in counts.items():
        total[k] += v
    total["segment_sum"] += fb.PORT_LAUNCHES["segment_sum"]
    return total


# phase E: the elastic worker pool (resizes, straggler demotion)
E_STEPS = 12
E_RESIZE = {3: 2, 5: 4}         # global round -> worker-set width (E1)
E2_STEPS, E2_RESIZE = 8, {3: 2}
E3_LATENCY = {2: 0.05}          # simulated seconds per step of worker 2 (E3)
E3_STEPS, E3_HEAL_EVERY = 12, 3
E3_BLOCKS = [2, 7]               # block syncs while worker 2 is demoted
C_E_STEPS, C_E_RESIZE = 16, {3: 2, 4: 4}    # phase C: straggler + resizes


def elastic_fit(run, *, device, steps, resize_at=None, latency_s=None,
                heal_every=0, params0=None, seed=0, telemetry_path=None,
                tracer=None, on_resize=None):
    """fit() through a LocalBackend (a SimulatedBackend with
    ``latency_s``, cleared by an eval hook every ``heal_every`` steps
    when that is set) and the elastic controller, on markov_lm data.  The
    backend's ``build_fn`` wraps every (re)built bundle's local_step, so
    the step timer survives a resize; ``on_resize(state, W)`` runs at the
    first step of each rebuilt bundle, before its timer starts.  Returns
    (state, history, summary, backend, step_s, step_w): host seconds per
    step (one local step's start to the next's, a device synchronize
    before each, the sync and any resize included) and each step's W."""
    import torch
    from repro_torch.backend import LocalBackend, SimulatedBackend
    from repro_torch.core.controller import ElasticController
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_train

    S = run.shape.seq_len
    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=run.model.vocab_size, num_seqs=W * B * 4,
                                 seq_len=S, seed=seed))
    starts, widths, builds = [], [], []

    def build(run_, ws):
        bundle = build_train(run_, worker_set=ws, device=device)
        local_step, first = bundle.local_step, [bool(builds)]
        builds.append(ws.num_workers)

        def timed_step(state, *args):
            if first[0] and on_resize is not None:
                on_resize(state, ws.num_workers)
            first[0] = False
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            starts.append(time.perf_counter())
            widths.append(ws.num_workers)
            return local_step(state, *args)

        bundle.local_step = timed_step
        return bundle

    kw = dict(device=device, build_fn=build)
    be = (SimulatedBackend(W, latency_s=latency_s, **kw) if latency_s
          else LocalBackend(W, **kw))
    ctl = ElasticController(run, resize_at=resize_at)

    def heal(state):                    # the straggler recovers
        be.latency_s.clear()
        return {}

    state, hist, summ = ttrain.fit(
        run, ShardedBatches(data, W, B, seed=seed), backend=be, controller=ctl,
        num_steps=steps, seed=seed, params0=params0, log=lambda *a: None,
        telemetry_path=telemetry_path, tracer=tracer,
        eval_fn=heal if heal_every else None, eval_every=heal_every)
    starts.append(summ["wall_s"] + starts[0])
    return (state, hist, summ, be,
            [b - a for a, b in zip(starts, starts[1:])], widths)


def elastic_oracle(run, *, device, steps, resize_at, params0, seed=0):
    """The fresh-run oracle of a resize (the reference test's
    ``_reference_elastic``): local steps and syncs driven by hand on the
    schedule, and at each scripted round the resized state handed to a
    FRESH bundle at the new W, the data re-partitioned and the LR scaled
    by new_w / 4.  Returns the per-step losses."""
    from repro_torch.core import elastic
    from repro_torch.core.schedule import DynamicSchedule, local_steps_at
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch.steps import build_train

    S = run.shape.seq_len
    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=run.model.vocab_size, num_seqs=W * B * 4,
                                 seq_len=S, seed=seed))
    it = ShardedBatches(data, W, B, seed=seed)
    bundle = build_train(run, num_workers=W, device=device)
    state = bundle.init(params0, seed=seed)
    sched = DynamicSchedule(run.local_sgd, lambda t: local_steps_at(run.local_sgd, t))
    rounds, lr_scale, losses = 0, 1.0, []
    for t in range(steps):
        batch = next(it)
        state, m = (bundle.local_step(state, batch) if lr_scale == 1.0
                    else bundle.local_step(state, batch, lr_scale))
        losses.append(float(m["loss"]))
        if sched.advance(t) != 2:
            continue
        state = bundle.sync(state)
        rounds += 1
        new_w = resize_at.get(rounds)
        if new_w is not None and new_w != bundle.num_workers:
            lr_scale *= new_w / bundle.num_workers
            state = elastic.resize_state(state, new_w)
            bundle = build_train(run, num_workers=new_w, device=device)
            it.resize(new_w)
    del state
    return losses


def _sq_sum_on_live(checks: list):
    """``on_resize`` hook: sq_sum on the live resized buckets (params and
    momentum) against sq_sum_plain, launches not counted (a comparison,
    not the path)."""
    from repro_torch.kernels import fused_bucket as fb

    def check(state, w):
        before = dict(fb.LAUNCHES)
        for f in ("params", "momentum"):
            x = getattr(state, f).buckets[0]
            got, want = fb.sq_sum(x), fb.sq_sum_plain(x)
            checks.append({"W": w, "buffer": f, "shape": list(x.shape),
                           "max_rel_err": rel_err(got, want)[1]})
        fb.LAUNCHES.update(before)
    return check


def phase_e(cfg) -> dict:
    """Phase E: the elastic worker pool at full width (phase A's settings,
    the markov corpus).  E1 resizes W = 4 -> 2 -> 4 under the mean sync;
    E2 resizes 4 -> 2 under LARS + EF-sign with telemetry; E3 demotes a
    simulated straggler and promotes it back.  Returns the launch counts
    of the three runs."""
    import torch
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.telemetry import trace as ttrace
    from repro_torch.telemetry.stats import round_summary

    launches = {k: 0 for k in fb.LAUNCHES}
    bucket = FULL_ROWS * 128 * 4            # one worker copy of the f32 bucket
    gen = torch.Generator(device="cuda").manual_seed(0)
    p0 = mbase.materialize(lm.param_specs(cfg), gen, "cuda")
    (ROOT / "build").mkdir(exist_ok=True)

    # ---- E1: W = 4 -> 2 -> 4, mean sync ----
    run = phase_run("none", cfg, seq=512, local_batch=8,
                    controller=dict(kind="elastic"))
    checks = []
    tracer = ttrace.Tracer(fence=True)
    jsonl = ROOT / "build" / "phase_e1.jsonl"
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    state, hist, summ, be, step_s, step_w = elastic_fit(
        run, device="cuda", steps=E_STEPS, resize_at=E_RESIZE, params0=p0,
        telemetry_path=str(jsonl), tracer=tracer,
        on_resize=_sq_sum_on_live(checks))
    counts = dict(fb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    shape = list(state.params.buckets[0].shape)
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    oracle = elastic_oracle(run, device="cuda", steps=E_STEPS,
                            resize_at=E_RESIZE, params0=p0)
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, oracle))
    recs = read_jsonl(jsonl)
    syncs = [(h["step"], h["synced"]) for h in hist if h["synced"]]
    resize_steps = {r["step"] for r in recs if "next_workers" in r}
    by_w = {w: statistics.median(s for t, (s, ww) in enumerate(zip(step_s, step_w))
                                 if ww == w and t and t not in resize_steps)
            for w in (2, 4)}
    resize_s = [s.dur_s for s in tracer.spans if s.name == "resize"]
    wsets = summ["ledger"]["worker_sets"]
    for k, v in counts.items():
        launches[k] += v
    emit({"phase": "E1", "model": cfg.name, "local_batch": 8, "seq": 512,
          "resize_at": E_RESIZE, "steps": E_STEPS, "loss": losses,
          "oracle_loss": oracle, "loss_max_rel_diff": loss_rel, "loss_tol": 1e-6,
          "syncs": syncs, "next_workers": [r["next_workers"] for r in recs
                                           if "next_workers" in r],
          "resizes": summ["resizes"], "backend": summ["backend"],
          "final_bucket_shape": shape, "ledger_worker_sets": wsets,
          "sq_sum_after_resize": checks, "step_s": step_s, "step_w": step_w,
          "step_s_median_W4": by_w[4], "step_s_median_W2": by_w[2],
          "W2_over_W4": by_w[2] / by_w[4], "resize_span_s_fenced": resize_s,
          "peak_mem_GB": peak, "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=E_STEPS, sq_sum=E_STEPS)
    a_syncs = [(0, "global"), (1, "global"), (2, "global"), (3, "global"),
               (7, "global"), (11, "global")]
    bad = [k for k, ok in (
        ("loss not finite", all(math.isfinite(v) for v in losses)),
        ("oracle", loss_rel <= 1e-6),
        ("resizes", summ["resizes"] == 2 and be.worker_set.num_workers == 4),
        ("next_workers", [r["next_workers"] for r in recs
                          if "next_workers" in r] == [2, 4]),
        ("syncs", syncs == a_syncs),
        ("final shape", shape == [W, FULL_ROWS, 128]),
        ("ledger", set(wsets) == {"W=2", "W=4"}
         and wsets["W=2"]["rounds"] == 2 and wsets["W=4"]["rounds"] == 4
         and wsets["W=2"]["bytes_per_round"] == bucket
         and wsets["W=4"]["bytes_per_round"] == 1.5 * bucket),
        ("sq_sum after resize", [c["W"] for c in checks] == [2, 2, 4, 4]
         and all(c["max_rel_err"] <= TOL["reduction"] for c in checks)),
        ("resize spans", len(resize_s) == 2),
        ("launches", counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase E1: {', '.join(bad)} (losses {losses}, "
                             f"oracle {oracle}, syncs {syncs}, ledger {wsets}, "
                             f"checks {checks}, launches {counts})")

    # ---- E2: LARS + EF-sign with telemetry, W = 4 -> 2 ----
    run = phase_run("ef_sign", cfg, seq=512, local_batch=8, steps=E2_STEPS,
                    lars=True, controller=dict(kind="elastic"))
    jsonl = ROOT / "build" / "phase_e2.jsonl"
    fb.reset_launches()
    state, hist, summ, be, step_s, step_w = elastic_fit(
        run, device="cuda", steps=E2_STEPS, resize_at=E2_RESIZE, params0=p0,
        telemetry_path=str(jsonl))
    counts = dict(fb.LAUNCHES)
    summary = round_summary(state.stats)
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    oracle = elastic_oracle(run, device="cuda", steps=E2_STEPS,
                            resize_at=E2_RESIZE, params0=p0)
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, oracle))
    recs = read_jsonl(jsonl)
    syncs = summ["comm_rounds"]["global"]
    for k, v in counts.items():
        launches[k] += v
    emit({"phase": "E2", "model": cfg.name, "optimizer": "lars",
          "sync_compression": "ef_sign", "resize_at": E2_RESIZE,
          "steps": E2_STEPS, "loss": losses, "oracle_loss": oracle,
          "loss_max_rel_diff": loss_rel, "loss_tol": 1e-4,
          "round_num_workers": [r["num_workers"] for r in recs],
          "round_summary": summary, "step_s": step_s, "step_w": step_w,
          "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(lars_row_norms=E2_STEPS, fused_lars_bucket=E2_STEPS,
                row_abs_sum=syncs, scale_sign_rows=syncs)
    bad = [k for k, ok in (
        ("loss not finite", all(math.isfinite(v) for v in losses)),
        ("oracle", loss_rel <= 1e-4),
        ("resizes", summ["resizes"] == 1 and be.worker_set.num_workers == 2),
        ("num_workers", [r["num_workers"] for r in recs] == [4, 4, 4, 2, 2]
         and summary["num_workers"] == 2),
        ("launches", syncs == 5 and counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase E2: {', '.join(bad)} (losses {losses}, "
                             f"oracle {oracle}, launches {counts})")

    # ---- E3: a simulated straggler, demoted and promoted back ----
    run = phase_run("none", cfg, seq=512, local_batch=8, steps=E3_STEPS,
                    controller=dict(kind="elastic"))
    jsonl = ROOT / "build" / "phase_e3.jsonl"
    fb.reset_launches()
    state, hist, summ, be, step_s, step_w = elastic_fit(
        run, device="cuda", steps=E3_STEPS, latency_s=dict(E3_LATENCY),
        heal_every=E3_HEAL_EVERY, params0=p0, telemetry_path=str(jsonl))
    counts = dict(fb.LAUNCHES)
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    recs = read_jsonl(jsonl)
    keys = ("round", "step", "worker_step_s", "worker_step_skew",
            "worker_slowest", "worker_step_s_by_id", "demote", "promote",
            "topology", "decisions")
    stream = [{k: r[k] for k in keys if k in r} for r in recs]
    syncs = [(h["step"], h["synced"]) for h in hist if h["synced"]]
    blocks = [t for t, s in syncs if s == "block"]
    demoted = [r for r in recs if "demote" in r]
    promoted = [r for r in recs if "promote" in r]
    for k, v in counts.items():
        launches[k] += v
    emit({"phase": "E3", "model": cfg.name, "latency_s": E3_LATENCY,
          "latency_cleared_every": E3_HEAL_EVERY, "steps": E3_STEPS,
          "step_times": "the simulated backend's model "
                        "(h x (base_step_s + latency)), not the card's",
          "loss": losses, "syncs": syncs, "comm_rounds": summ["comm_rounds"],
          "topology": summ["topology"], "backend": summ["backend"],
          "decisions": stream, "step_s": step_s, "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=E3_STEPS, sq_sum=E3_STEPS)
    d_step = demoted[0]["step"] if demoted else E3_STEPS
    p_step = promoted[0]["step"] if promoted else E3_STEPS
    bad = [k for k, ok in (
        ("loss not finite", all(math.isfinite(v) for v in losses)),
        ("demotion", len(demoted) == 1 and demoted[0]["demote"] == 2
         and demoted[0]["round"] == run.controller.skew_patience),
        ("block syncs while demoted", blocks == E3_BLOCKS
         and all(d_step < t < p_step for t in blocks)),
        ("promotion", len(promoted) == 1 and promoted[0]["promote"] == 2),
        ("restored", summ["topology"] == "flat"
         and be.worker_set.demoted == ()),
        ("launches", counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase E3: {', '.join(bad)} (syncs {syncs}, "
                             f"decisions {stream}, launches {counts})")
    del p0
    return launches

def phase_r(cfg, b_losses: list, b_step_s: float):
    """Phase R: phase B's run (EF-sign, full width, 12 steps) traced with a
    fenced, annotating tracer and a metrics registry, its artifacts in
    ``build/phase_r/``; returns its launch counts and the median fenced
    global sync's seconds."""
    import torch
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.telemetry import export as texport
    from repro_torch.telemetry.metrics import MetricsRegistry
    from repro_torch.telemetry.trace import Tracer

    out = ROOT / "build" / "phase_r"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    run = phase_run("ef_sign", cfg, seq=512, local_batch=8)
    tracer = Tracer(fence=True, annotate=True, metrics=MetricsRegistry())
    fb.reset_launches()
    state, hist, summ, step_s = train_run(
        run, device="cuda", steps=STEPS, tracer=tracer,
        telemetry_path=out / "telemetry.jsonl",
        manifest_path=out / "manifest.json")
    counts = dict(fb.LAUNCHES)
    texport.write_perfetto(str(out / "trace.json"), tracer,
                           extra={"wall_s": summ["wall_s"]})
    texport.write_prometheus(str(out / "metrics.prom"), tracer.metrics)
    problems = texport.check_trace_dir(str(out))
    losses = [h["loss"] for h in hist]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, b_losses))
    spans = tracer.spans
    census: dict = {}
    for sp in spans:
        census[sp.name] = census.get(sp.name, 0) + 1
    dur = lambda name, **kw: [sp.dur_s for sp in spans if sp.name == name
                              and all(sp.attrs.get(k) == v for k, v in kw.items())]
    syncs = dur("sync", scope="global")
    recs = read_jsonl(out / "telemetry.jsonl")
    led = summ["ledger"]
    stage_total = sum(v for r in recs for v in r["stage_s"].values())
    emit({"phase": "R", "model": cfg.name, "W": W, "local_batch": 8, "seq": 512,
          "sync_compression": "ef_sign", "steps": STEPS, "fenced": True,
          "span_census": census, "trace_dir_problems": problems,
          "loss": losses, "phase_B_loss": b_losses,
          "loss_max_rel_diff_vs_B": loss_rel,
          "loss_bitwise_equal_B": losses == b_losses,
          "local_steps_s_median": statistics.median(dur("local_steps")),
          "sync_s_median": statistics.median(syncs),
          "round_s_median": statistics.median(dur("round")),
          "controller_s_median": statistics.median(dur("controller")),
          "fenced_step_s_median": statistics.median(step_s[1:]),
          "phase_B_step_s_median": b_step_s,
          "ledger_sync_seconds": led.get("sync_seconds"),
          "jsonl_stage_s_total": stage_total,
          "sync_s_by_round": [r["sync_s"] for r in recs],
          "round_s_by_round": [r["round_s"] for r in recs],
          "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS, row_abs_sum=6,
                scale_sign_rows=6)
    sync_ok = (len(recs) == len(syncs) == 6
               and [r["sync_s"] for r in recs] == syncs)
    bad = [k for k, ok in (
        ("trace dir", not problems),
        # every sum of the port runs in a fixed order on the card: the
        # traced run is the untraced one, bit for bit (1e-4 relative while
        # EF-sign's scale totals were atomic; 0.0 since, H100 80GB HBM3,
        # 700 W)
        ("loss vs phase B", losses == b_losses),
        ("sync_seconds", led.get("sync_seconds", 0) > 0
         and math.isclose(led["sync_seconds"], stage_total, rel_tol=1e-9)
         and math.isclose(led["sync_seconds"], sum(syncs), rel_tol=1e-9)),
        ("sync_s per round", sync_ok),
        ("spans", census.get("local_steps") == STEPS
         and census.get("round") == 6 and census.get("controller") == 6),
        ("launches", counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase R: {', '.join(bad)} (problems {problems}, "
                             f"loss diff {loss_rel}, launches {counts})")
    del state
    return counts, statistics.median(syncs)


def phase_k(cfg) -> dict:
    """Phase K: save_flat of the full-width resident state after 6 steps
    of phase A's settings, restore_flat into a fresh state, bit-equal
    buckets, and 2 more steps from each giving the same losses; then
    save / restore of the worker-mean param tree.  The files go into a
    temporary directory under build/ that the phase removes.  Returns
    the launch counts."""
    import tempfile

    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.steps import build_train
    from repro_torch.models import base as mbase
    from repro_torch.utils import tree_leaves, tree_map

    run = phase_run("none", cfg, seq=512, local_batch=8)
    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=W * B * 4,
                                 seq_len=512))
    it = iter(ShardedBatches(data, W, B))
    bundle = build_train(run, num_workers=W, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p0 = mbase.materialize(bundle.specs, gen, "cuda")
    fb.reset_launches()
    syncs = dict(sync_boundaries(run.local_sgd, 8))

    def steps(state, batches, t0):
        losses = []
        for t, batch in enumerate(batches, start=t0):
            state, m = bundle.local_step(state, batch)
            losses.append(float(m["loss"]))
            if syncs.get(t) == 2:
                state = bundle.sync(state, plan=bundle.sync_plan)
        return state, losses

    state, _ = steps(bundle.init(p0, seed=0), [next(it) for _ in range(6)], 0)
    tail = [next(it) for _ in range(2)]
    rec = {"phase": "K", "model": cfg.name, "W": W, "steps_before_save": 6}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "state")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_flat(path, state, step=state.step)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path + ".npz")
        fresh = bundle.init(tree_map(torch.zeros_like, p0), seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = ckpt.restore_flat(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del fresh
        equal = all(torch.equal(a, b) for f in ("params", "momentum")
                    for a, b in zip(getattr(state, f).buckets,
                                    getattr(back, f).buckets))
        equal = equal and back.step == state.step == 6
        _, live = steps(state, tail, 6)
        _, resumed = steps(back, tail, 6)
        del back
        # the worker-mean param tree, per-leaf format
        tree = mean_params(state)
        tpath = os.path.join(tmp, "params")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(tpath, tree, step=8)
        tsave_s = time.perf_counter() - t0
        tbytes = os.path.getsize(tpath + ".npz")
        t0 = time.perf_counter()
        tback = ckpt.restore(tpath, mbase.abstract(bundle.specs), device="cuda")
        torch.cuda.synchronize()
        trestore_s = time.perf_counter() - t0
        tree_equal = all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(tree), tree_leaves(tback)))
    counts = dict(fb.LAUNCHES)
    rec.update(file_GB=nbytes / 1e9, save_s=save_s, restore_s=restore_s,
               save_GBps=nbytes / 1e9 / save_s,
               restore_GBps=nbytes / 1e9 / restore_s,
               buckets_bit_equal=equal, losses_live=live,
               losses_restored=resumed,
               param_tree_GB=tbytes / 1e9, param_tree_save_GBps=tbytes / 1e9 / tsave_s,
               param_tree_restore_GBps=tbytes / 1e9 / trestore_s,
               param_tree_bit_equal=tree_equal,
               temp_dir_removed=not os.path.exists(tmp), launches=counts)
    emit(rec)
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=10, sq_sum=10)
    bad = [k for k, ok in (("buckets", equal), ("resumed losses", live == resumed),
                           ("param tree", tree_equal),
                           ("size", nbytes >= 2 * W * FULL_ROWS * 128 * 4),
                           ("temp dir", rec["temp_dir_removed"]),
                           ("launches", counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase K: {', '.join(bad)} ({rec})")
    del state, tree, tback
    return counts


# phase S: the serving engine's shape and its traffic
S_SLOTS, S_MAX_LEN, S_PAGE, S_PREFILL = 16, 512, 16, 128
S_REQUESTS, S_PROMPT, S_NEW = 48, (16, 128), (16, 96)
S_CHECKED = 3                 # requests a version held against the contiguous path
S_TOL = 1e-4                  # logits: |a - b| <= S_TOL * (1 + |b|)


def _close(a, b, reduce="max") -> float:
    """max (or ``reduce="mean"``: mean) |a - b| / (1 + |b|) of two logit
    rows (tensors)."""
    a, b = a.double(), b.double()
    r = (a - b).abs() / (1 + b.abs())
    return float(r.mean() if reduce == "mean" else r.max())


def _forced_logits(cfg, params, prompt, tokens, max_len=S_MAX_LEN):
    """The contiguous path's logits teacher-forced on ``tokens``
    (``build_serve``: prefill of the prompt, then one decode per token)."""
    import torch
    from repro_torch.launch.steps import build_serve
    from repro_torch.models import lm

    sb = build_serve(cfg, device="cuda")
    lg, cache = sb.prefill(params, {"tokens": torch.tensor([list(prompt)],
                                                           device="cuda")})
    cache = lm.grow_cache(cfg, cache, max_len)
    out = [lg[0, -1]]
    n = len(prompt) + 1
    for t in tokens[:-1]:
        lg, cache = sb.decode_step(params, {"tokens": torch.tensor(
            [[t]], device="cuda")}, cache, n)
        out.append(lg[0, -1])
        n += 1
    return out


def phase_s(cfg) -> dict:
    """Phase S: train paper-lm (phase A's settings, 8 steps) publishing
    versions 0 and 1 through the trainer's checkpoint hook; serve 48
    requests from version 0 with the paged continuous-batching engine;
    hot-swap to version 1 once half have finished.  Returns the
    training's launch counts."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import InputShape
    from repro_torch.core import flatbuf
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_engine
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.serving import NULL_PAGE, WeightPublisher, WeightSubscriber
    from repro_torch.telemetry.metrics import MetricsRegistry
    from repro_torch.telemetry.trace import Tracer

    run = phase_run("none", cfg, seq=512, local_batch=8, steps=8)
    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=W * B * 4,
                                 seq_len=512))
    rec = {"phase": "S", "model": cfg.name}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as pub_dir:
        pub = WeightPublisher(pub_dir)
        fb.reset_launches()
        t0 = time.perf_counter()
        _, hist, summ = ttrain.fit(
            run, ShardedBatches(data, W, B), num_steps=8, log=lambda *a: None,
            checkpoint_every=4,
            checkpoint_fn=lambda s, t: pub.publish(s.params, step=t))
        counts = dict(fb.LAUNCHES)
        rec.update(train_s=time.perf_counter() - t0,
                   train_loss=[h["loss"] for h in hist],
                   published=pub.last_version, launches=counts)
        specs = lm.param_specs(cfg)
        layout = flatbuf.build_layout(mbase.abstract(specs))
        template = flatbuf.BucketState(layout, tuple(flatbuf.abstract_buckets(layout)))
        manifest = json.loads(Path(pub_dir, "manifest.json").read_text())
        v0 = ckpt.restore_flat(os.path.join(pub_dir, manifest["versions"]["0"]["path"]),
                               template, device="cuda")
        sub = WeightSubscriber(pub_dir, specs, device="cuda")

        shape = InputShape("serve", S_MAX_LEN, S_SLOTS, "decode")
        tracer, reg = Tracer(), MetricsRegistry()
        kept: dict = {}          # uid -> its logit rows, on the card

        def on_logits(kind, rows, logits, inputs):
            for slot, uid in rows:
                kept.setdefault(uid, []).append(logits[slot, -1].clone())

        eng = build_engine(cfg, shape, v0.unpack(), page_size=S_PAGE,
                           prefill_len=S_PREFILL, tracer=tracer, metrics=reg,
                           on_logits=on_logits)
        eng.install_weights(v0, version=0)
        v0_params = eng.params
        rng = np.random.default_rng(7)
        corpus = markov_lm(vocab=cfg.vocab_size, num_seqs=S_REQUESTS,
                           seq_len=S_PROMPT[1], seed=3)
        reqs = []
        for i in range(S_REQUESTS):
            L = int(rng.integers(S_PROMPT[0], S_PROMPT[1] + 1))
            reqs.append((corpus[i, :L].tolist(),
                         int(rng.integers(S_NEW[0], S_NEW[1] + 1))))
        uids = [eng.submit(p, max_new=n) for p, n in reqs]
        torch.cuda.reset_peak_memory_stats()
        swap = None
        t0 = time.perf_counter()
        while not eng.idle:
            eng.step()
            if swap is None and len(eng.completed) >= S_REQUESTS // 2:
                resident = [b for b in range(S_SLOTS) if eng.lens[b] > 0]
                # the resident with the most tokens still to come
                b = max(resident, key=lambda b: eng.slot_req[b].max_new - eng.gen[b])
                swap = {"residents": len(resident), "uid": eng.slot_req[b].uid,
                        "k": int(eng.gen[b]), "hist": list(eng.hist[b]),
                        "max_new": eng.slot_req[b].max_new,
                        "version": eng.poll_weights(sub)}
                kept.pop(swap["uid"])            # keep only post-swap rows
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        results = {r.uid: r for r in eng.completed}
        desc = eng.describe()
        null_zero = not any(bool(pool[NULL_PAGE].any()) for pool in eng.pools)
        pages_back = len(eng.free_pages) == eng.pl.num_pages - 1
        spans = lambda name: [sp.dur_s for sp in tracer.spans if sp.name == name]

        # teacher-forced contiguous logits: the first S_CHECKED requests
        # served wholly on version 0, and on version 1
        worst, checked = 0.0, []
        for version, params in ((0, v0_params), (1, eng.params)):
            done = [u for u in uids if results[u].weight_versions == (version,)]
            for uid in done[:S_CHECKED]:
                want = _forced_logits(cfg, params, reqs[uid][0],
                                      results[uid].tokens)
                assert len(want) == len(kept[uid])
                worst = max(worst, max(_close(a, b)
                                       for a, b in zip(kept[uid], want)))
                checked.append((uid, version))
        # the swapped resident against a fresh engine on version 1
        got = kept[swap["uid"]]
        cont = results[swap["uid"]].tokens[swap["k"]:]
        fresh_rows: list = []
        fresh = build_engine(cfg, shape, eng.params, page_size=S_PAGE,
                             prefill_len=S_PREFILL,
                             on_logits=lambda k, rows, lg, inp: fresh_rows.extend(
                                 lg[s, -1].clone() for s, _ in rows))
        fuid = fresh.submit(swap["hist"], max_new=swap["max_new"] - swap["k"])
        fcont = {r.uid: r for r in fresh.run()}[fuid].tokens
        same, swap_err = 0, 0.0
        for a, b, ta, tb in zip(got, fresh_rows, cont, fcont):
            swap_err = max(swap_err, _close(a, b))
            top2 = torch.topk(b.double(), 2).values
            if ta != tb or float(top2[0] - top2[1]) <= 2 * S_TOL * (1 + float(top2[0].abs())):
                break
            same += 1

        # where a decode step's time goes: torch.profiler over 4 steps of
        # a full engine (16 residents, prompts 128, long budgets)
        prof_eng = build_engine(cfg, shape, eng.params, page_size=S_PAGE,
                                prefill_len=S_PREFILL)
        for i in range(S_SLOTS):
            prof_eng.submit(corpus[i % S_REQUESTS, :S_PREFILL].tolist(),
                            max_new=S_MAX_LEN - S_PREFILL)
        for _ in range(3):
            prof_eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(4):
                prof_eng.step()
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t1) / 4
        from torch.autograd import DeviceType
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == DeviceType.CUDA) / 1e3 / 4
        op_ms = {k: sum(e.device_time_total for e in ev if e.key == k) / 1e3 / 4
                 for k in ("aten::index", "aten::copy_", "aten::bmm",
                           "aten::mm", "aten::index_put_")}
        top = sorted((e for e in ev if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:8]
        del prof_eng, fresh
    rec.update(
        requests=S_REQUESTS, completed=len(results), slots=S_SLOTS,
        max_len=S_MAX_LEN, page_size=S_PAGE, prefill_len=S_PREFILL,
        decode_steps=len(spans("decode")), tokens_out=desc["tokens_out"],
        wall_s=wall, tokens_per_s=desc["tokens_out"] / wall,
        decode_step_ms_median=1e3 * statistics.median(spans("decode")),
        prefill_ms_median=1e3 * statistics.median(spans("prefill")),
        admission_waves=len(spans("admit")),
        swap_s=spans("swap")[-1], swap=dict(swap, hist=len(swap["hist"])),
        pool_bytes=desc["pool_bytes"], num_pages=desc["num_pages"],
        peak_mem_GB=peak / 1e9, null_page_zero=null_zero,
        free_pages_full=pages_back, logits_checked=checked,
        logits_max_rel_err=worst, logits_tol=S_TOL,
        swap_tokens_equal_fresh=same, swap_tokens=len(cont),
        swap_logits_max_rel_err=swap_err,
        profile={"step_ms": prof_ms, "device_busy_ms": busy,
                 "op_device_ms": op_ms,
                 "gather_and_copies_share_of_busy":
                     (op_ms["aten::index"] + op_ms["aten::copy_"]) / busy
                     if busy else None,
                 "top_kernels": [[e.key[:80], e.self_device_time_total / 4e3,
                                  e.count / 4] for e in top]})
    emit(rec)
    bad = [k for k, ok in (
        ("completed", len(results) == S_REQUESTS
         and set(results) == set(uids)),
        ("swap", swap is not None and swap["version"] == 1
         and swap["residents"] > 0 and desc["weight_version"] == 1),
        ("null page", null_zero), ("free pages", pages_back),
        ("logits", worst <= S_TOL and len(checked) == 2 * S_CHECKED),
        ("swap continuation", swap_err <= S_TOL and same >= min(8, len(cont))),
        ("pool bytes", desc["pool_bytes"] == 513 * 16 * 144 * 128 * 4),
        ("launches", counts == {**{k: 0 for k in fb.LAUNCHES},
                                "fused_sgd_bucket": 8, "sq_sum": 8}))
        if not ok]
    if bad:
        raise AssertionError(f"phase S: {', '.join(bad)} ({rec})")
    return counts


def phase_s2() -> dict:
    """Phase S2: the serving twins on the card at their reference sizes
    (see the module docstring); returns their launch counts (none: the
    serving path runs no bucket kernel)."""
    import torch
    from repro_torch import configs
    from repro_torch.examples import serve_continuous, serve_lm
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    quiet = lambda *a, **k: None
    gc.collect()
    t0 = time.perf_counter()
    out = serve_lm.main([], log=quiet)
    lm_s = time.perf_counter() - t0
    # the same weights (the twin's seeded draw on the card) on the CPU: the
    # prefill's greedy tokens, from one forward each
    cfg = configs.get_smoke("gemma3-1b")
    params = mbase.materialize(lm.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    del params
    with torch.no_grad():
        logits, _ = lm.prefill(cfg, cpu_params,
                               torch.as_tensor(out["prompts"]),
                               max_len=out["prompts"].shape[1] + 16)
    first_cpu = logits.argmax(-1)[:, 0].numpy()
    t0 = time.perf_counter()
    cont = serve_continuous.main([], log=quiet)
    cont_s = time.perf_counter() - t0
    done = {r["uid"]: r for r in cont["completed"]}
    swap = cont["swap"] or {}
    lengths_ok = len(done) == 12 and all(
        len(r["tokens"]) == (24 if uid % 4 == 0 else 3)
        for uid, r in done.items())
    residents_ok = bool(swap.get("residents")) and all(
        done[u]["weight_versions"][-1] == swap["version"]
        and len(done[u]["weight_versions"]) >= 2 for u in swap["residents"])
    tokens = out["tokens"]
    rec = {"phase": "S2", "arch": out["arch"],
           "serve_lm": {"device": out["device"], "batch": 4, "prompt_len": 32,
                        "gen": 16, "tokens_shape": list(tokens.shape),
                        "prefill_s": out["prefill_s"],
                        "decode_s": out["decode_s"],
                        "first_tokens_equal_cpu": bool(
                            (tokens[:, 0] == first_cpu).all()),
                        "wall_s": lm_s},
           "serve_continuous": {"device": cont["device"],
                                "requests": len(done),
                                "tokens_out": cont["tokens_out"],
                                "steps": cont["steps"],
                                "tokens_per_s": cont["tokens_out"]
                                / cont["seconds"],
                                "swap": swap, "lengths_ok": lengths_ok,
                                "residents_on_new_version": residents_ok,
                                "wall_s": cont_s}}
    emit(rec)
    bad = [k for k, ok in (
        ("serve_lm on the card", out["device"].startswith("cuda")
         and tokens.shape == (4, 16)
         and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())),
        ("serve_lm first tokens", rec["serve_lm"]["first_tokens_equal_cpu"]),
        ("serve_continuous on the card", cont["device"].startswith("cuda")),
        ("request lengths", lengths_ok),
        ("hot-swap residents", residents_ok)) if not ok]
    if bad:
        raise AssertionError(f"phase S2: {', '.join(bad)}")
    return {}


def read_jsonl(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def round_modes(recs: list) -> list:
    """Per global round, the (h, compression, batch_scale, lr_scale) the
    round RAN under: the previous record's next_* (the first round runs
    under the controller's initial decision)."""
    out, prev = [], None
    for r in recs:
        out.append(prev)
        prev = (r["next_h"], r["next_compression"], r["next_batch_scale"],
                r["next_lr_scale"])
    return out


def sensor_margins(recs: list, cc: dict, global_batch: int) -> dict:
    """Relative distance of each sensor a decision read to its threshold,
    per round: the diversity EMA to low / high (diversity_h and
    noise_adaptive), each compression error to err_budget, the
    critical-batch EMA to noise_grow x the total batch."""
    from repro_torch.configs.base import ControllerConfig
    c = ControllerConfig(**cc)
    out, ema, scale = [], None, 1
    for r in recs:
        m = {}
        if c.kind in ("diversity_h", "noise_adaptive") and "diversity" in r:
            d = r["diversity"]
            ema = d if ema is None else c.ema * ema + (1 - c.ema) * d
            m["diversity_ema"] = min(abs(ema - t) / t for t in (c.low, c.high))
        if c.kind in ("auto_compress", "noise_adaptive") and r["comp_measured"]:
            m["comp_rel_err"] = min(abs(e - c.err_budget) / c.err_budget
                                    for e in r["comp_rel_err"])
        bn = r.get("decisions", {}).get("b_noise")
        if bn:
            total = c.noise_grow * global_batch * scale
            m["b_noise_ema"] = abs(bn["ema"] - total) / total
        scale = r["next_batch_scale"]
        out.append(m)
    return out


def decision_trace(recs: list) -> list:
    """Per round: the next decisions and the non-float provenance."""
    keep = lambda d: {k: {f: v for f, v in d[k].items()
                          if not isinstance(v, float) and f != "comp_rel_err"}
                      for k in d if k != "b_noise"}
    return [(r["next_h"], r["next_compression"], r["next_batch_scale"],
             r["next_lr_scale"], keep(r.get("decisions", {}))) for r in recs]


def phase_n(cfg, b_step_s: float) -> dict:
    """Phase N: noise-adaptive post-local SGD at full width (phase B's
    settings with NOISE_CC): the controller actuates H, the compressor and
    the batch from the round telemetry; every global sync launches the
    compressor pair once, speculatively while the bucket is uncompressed.
    Returns the launch counts."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    run = phase_run("ef_sign", cfg, seq=512, local_batch=8, controller=NOISE_CC)
    path = ROOT / "build" / "phase_n.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS,
                                          telemetry_path=path)
    counts = dict(fb.LAUNCHES)
    recs = read_jsonl(path)
    ran = round_modes(recs)
    margins = sensor_margins(recs, NOISE_CC, run.shape.global_batch)
    for r, under, m in zip(recs, ran, margins):
        mode = under[1] if under else "none"
        emit({"phase": "N", "round": r["round"], "step": r["step"], "h": r["h"],
              "compression": mode, "batch_scale": under[2] if under else 1,
              "lr_scale": under[3] if under else 1.0,
              "comp_rel_err": r["comp_rel_err"],
              "comp_err_kind": "speculative" if mode == "none" else "measured",
              "diversity": r["diversity"], "signal_sq": r["signal_sq"],
              "noise_sq": r["noise_sq"], "loss": r["loss"],
              "next": [r["next_h"], r["next_compression"], r["next_batch_scale"],
                       r["next_lr_scale"]],
              "decisions": r.get("decisions", {}), "margins": m})
    # the batch scale each step ran at: a round's decision holds from the
    # step after its sync
    scale_at, scale = [], 1
    by_step = {r["step"]: r["next_batch_scale"] for r in recs}
    for t in range(STEPS):
        scale_at.append(scale)
        scale = by_step.get(t, scale)
    med = {s: statistics.median([x for t, x in enumerate(step_s)
                                 if scale_at[t] == s and t > 0] or [float("nan")])
           for s in sorted(set(scale_at))}
    losses = [h["loss"] for h in hist]
    rounds = summ["comm_rounds"]["global"]
    led = summ["ledger"]["scaling"]
    ran_scales = [u[2] if u else 1 for u in ran]
    ran_lr = [u[3] if u else 1.0 for u in ran]
    actuated = [r["round"] for r in recs
                if set(r.get("decisions", {})) & {"h", "compression", "batch", "lr"}]
    emit({"phase": "N", "model": cfg.name, "W": W, "local_batch": 8, "seq": 512,
          "controller": NOISE_CC, "steps": STEPS, "loss": losses,
          "comm_rounds": summ["comm_rounds"], "actuated_rounds": actuated,
          "batch_scale_at_step": scale_at, "step_s": step_s,
          "step_s_median_by_scale": {str(k): v for k, v in med.items()},
          "phase_B_step_s_median": b_step_s,
          "tokens_per_s_by_scale": {str(k): W * 8 * k * 512 / v
                                    for k, v in med.items()},
          "ledger_scaling": led, "summary_controller": summ["controller"],
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts,
          "min_margin": min((v for m in margins for v in m.values()),
                            default=None)})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS, row_abs_sum=rounds,
                scale_sign_rows=rounds)
    bad = [k for k, ok in (
        ("no decision changed an actuator", bool(actuated)),
        ("loss not finite", all(math.isfinite(v) for v in losses)),
        ("launches", counts == want),
        ("rounds", rounds == len(recs) > 0),
        ("ledger scaling", led["batch_scale_range"] == [min(ran_scales),
                                                        max(ran_scales)]
         and led["lr_scale_range"] == [min(ran_lr), max(ran_lr)]),
        ("summary", summ["controller"]["batch_scale"] == recs[-1]["next_batch_scale"]
         and summ["controller"]["lr_scale"] == recs[-1]["next_lr_scale"]))
        if not ok]
    if bad:
        raise AssertionError(f"phase N: {', '.join(bad)} (launches {counts}, want "
                             f"{want}; ledger {led}; decisions {actuated})")
    del state
    return counts


def noise_check(cfg) -> dict:
    """Gradient noise at full width: ``_bucket_noise`` on a zero grad bucket
    (W x 934,040 x 128) at t = 0 and t = 10 against sigma_t^2 = eta /
    (1+t)^gamma (per-element variance within 1e-3 relative, mean below
    1e-3 sigma_t, padding exactly zero, one seed the same bits), then 4
    full-width steps with noise; returns the launch counts of the steps."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.core.local_sgd import _bucket_noise
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.models import base as mbase
    from repro_torch.models import lm

    dev = "cuda"
    layout = flatbuf.build_layout(mbase.abstract(lm.param_specs(cfg), torch.float32))
    rows = layout.bucket_rows[0]
    valid = flatbuf.const("valid_mask", layout, 0, dev)
    n = float(valid.sum()) * W
    bad = []
    for t in NOISE_STEPS:
        sigma = math.sqrt(NOISE_ETA / (1.0 + t) ** NOISE_GAMMA)
        draw = lambda: _bucket_noise(
            layout, [torch.zeros((W, rows, 128), device=dev)],
            torch.Generator(device=dev).manual_seed(t), step=t, eta=NOISE_ETA,
            gamma=NOISE_GAMMA)[0]
        g = draw()
        mean = float(g.sum(dtype=torch.float64)) / n
        var = float((g.double() ** 2).sum()) / n - mean ** 2
        pad_max = float((g * (1 - valid)).abs().max())
        same = bool(torch.equal(g.view(torch.int32), draw().view(torch.int32)))
        rec = {"phase": "noise", "shape": [W, rows, 128], "step": t,
               "eta": NOISE_ETA, "gamma": NOISE_GAMMA, "sigma": sigma,
               "var_rel_err": abs(var / sigma ** 2 - 1), "var_tol": 1e-3,
               "mean_over_sigma": abs(mean) / sigma, "mean_tol": 1e-3,
               "padding_max_abs": pad_max, "same_bits_same_seed": same}
        emit(rec)
        if not (rec["var_rel_err"] <= 1e-3 and rec["mean_over_sigma"] <= 1e-3
                and pad_max == 0.0 and same):
            bad.append(f"t={t}")
        del g
    run = phase_run("none", cfg, seq=512, local_batch=8, steps=4,
                    noise_eta=NOISE_ETA)
    fb.reset_launches()
    state, hist, _, step_s = train_run(run, device="cuda", steps=4)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    emit({"phase": "noise", "model": cfg.name, "noise_eta": NOISE_ETA,
          "steps": 4, "loss": losses, "step_s": step_s, "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=4, sq_sum=4)
    if not all(math.isfinite(v) for v in losses) or counts != want:
        bad.append(f"noisy steps: losses {losses}, launches {counts}")
    if bad:
        raise AssertionError(f"gradient noise check failed: {bad}")
    del state
    return counts


def phase_c_controllers(smoke, p0):
    """Phase C for the compression-escalating policies: the trainer with
    auto_compress / noise_adaptive on the card and on the CPU at smoke
    size, from the same weights: the same decision sequence, and losses
    and params within phase C's EF-sign tolerances."""
    import torch
    from repro_torch.utils import tree_map

    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    for cc in C_CONTROLLERS:
        run = phase_run("ef_sign", smoke, seq=64, local_batch=2, steps=8,
                        controller=cc)
        out = {}
        for dev in ("cuda", "cpu"):
            path = ROOT / "build" / f"phase_c_{cc['kind']}_{dev}.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            st, hist, summ, _ = train_run(
                run, device=dev, steps=8, telemetry_path=path,
                params0=tree_map(lambda t: t.to(dev).clone(), p0))
            out[dev] = (st.params.buckets[0].cpu(), [h["loss"] for h in hist],
                        summ, read_jsonl(path))
        (pg, lg, sg, rg), (pc, lc, sc, rc) = out["cuda"], out["cpu"]
        loss_rel = max(rel(a, b) for a, b in zip(lg, lc))
        d = (pg - pc).abs()
        frac = float((d > 1e-4 * pc.abs().max()).float().mean())
        dg, dc = decision_trace(rg), decision_trace(rc)
        margins = sensor_margins(rg, cc, run.shape.global_batch)
        low = [(i + 1, k, v) for i, m in enumerate(margins)
               for k, v in m.items() if v < 1e-3]
        emit({"phase": "C", "model": smoke.name, "controller": cc,
              "sync_compression": "ef_sign", "steps": 8,
              "comm_rounds": sg["comm_rounds"], "decisions_gpu": dg,
              "decisions_cpu": dc, "decisions_equal": dg == dc,
              "loss_gpu": lg, "loss_cpu": lc, "loss_max_rel_diff": loss_rel,
              "loss_tol": 1e-4, "params_frac_beyond_1e-4_of_max": frac,
              "frac_tol": 1e-4, "sensor_margins": margins,
              "margins_below_1e-3": low})
        from repro_torch.core.controller import make_controller
        d0 = make_controller(run, n_comp=1).plan_delta(0)
        actuated = any(x[1] != "|".join(d0.compression) or x[2] != 1
                       or x[3] != 1.0 or "h" in x[4] for x in dc)
        if dg != dc or loss_rel > 1e-4 or frac > 1e-4 or not actuated \
                or sg["comm_rounds"] != sc["comm_rounds"]:
            raise AssertionError(f"phase C ({cc['kind']}): the controller on "
                                 f"the card disagrees with the CPU's (or never "
                                 f"actuated): {dg} vs {dc}")
        torch.cuda.empty_cache()


def check_resized_kernels(rows: int = RAGGED_ROWS) -> list:
    """sq_sum and fused_sgd_bucket against their plain versions at a
    worker count that shrinks and grows on one stream (W = 4 -> 2 -> 4 ->
    8): sq_sum's scratch (per device and stream, grown only for a larger
    W, its tickets left zeroed by the kernel) is reused across the
    changes.  Returns one record per W."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    g = torch.Generator(device="cuda").manual_seed(rows)
    out = []
    for w in (4, 2, 4, 8):
        mk = lambda: torch.randn((w, rows, 128), generator=g, device="cuda")
        p, gr, u = mk(), mk(), 0.1 * mk()
        wd_row = (torch.rand((rows,), generator=g, device="cuda") < 0.7).float()
        gscale = torch.rand((w,), generator=g, device="cuda")
        kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=True,
                  gscale=gscale, stats=True)
        p1, u1, p2, u2 = p.clone(), u.clone(), p.clone(), u.clone()
        sk = fb.fused_sgd_bucket(p1, gr, u1, 0.05, wd_row, **kw)
        sp = fb.fused_sgd_bucket_plain(p2, gr, u2, 0.05, wd_row, **kw)
        errs = {"sq_sum": rel_err(fb.sq_sum(p), fb.sq_sum_plain(p))[1],
                "sq_sum_again": rel_err(fb.sq_sum(gr), fb.sq_sum_plain(gr))[1],
                "fused_sgd_p": rel_err(p1, p2)[1], "fused_sgd_u": rel_err(u1, u2)[1],
                "fused_sgd_stats": max(rel_err(a, b)[1] for a, b in zip(sk, sp))}
        tol = {"sq_sum": TOL["reduction"], "sq_sum_again": TOL["reduction"],
               "fused_sgd_p": TOL["elementwise"], "fused_sgd_u": TOL["elementwise"],
               "fused_sgd_stats": TOL["reduction"]}
        out.append({"W": w, "rows": rows, "max_rel_err": errs, "tol": tol})
        bad = [k for k in errs if not errs[k] <= tol[k]]
        if bad:
            raise AssertionError(f"kernels after a resize to W={w}: "
                                 f"{', '.join(bad)} ({errs})")
    return out


def phase_c_elastic(smoke, p0):
    """Phase C for the elastic worker pool: the resized-W kernel check,
    then the elastic trainer at smoke size on the card and on the CPU from
    the same weights, with phase E3's simulated straggler and two resizes
    (W = 4 -> 2 -> 4 after global rounds 3 and 4: the demotion's block
    syncs thin the global rounds) together: the same resize and demotion
    decisions, losses within 1e-4."""
    import torch
    from repro_torch.utils import tree_map

    kernels = check_resized_kernels()
    run = phase_run("none", smoke, seq=64, local_batch=2, steps=C_E_STEPS,
                    controller=dict(kind="elastic"))
    out = {}
    for dev in ("cuda", "cpu"):
        path = ROOT / "build" / f"phase_c_elastic_{dev}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        _, hist, summ, _, _, _ = elastic_fit(
            run, device=dev, steps=C_E_STEPS, resize_at=C_E_RESIZE,
            latency_s=dict(E3_LATENCY), telemetry_path=str(path),
            params0=tree_map(lambda t: t.to(dev).clone(), p0))
        keys = ("round", "step", "next_workers", "demote", "promote",
                "topology", "num_workers")
        out[dev] = ([h["loss"] for h in hist], summ,
                    [{k: r[k] for k in keys if k in r} for r in read_jsonl(path)])
    (lg, sg, dg), (lc, sc, dc) = out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    emit({"phase": "C", "model": smoke.name, "controller": "elastic",
          "resize_at": C_E_RESIZE, "latency_s": E3_LATENCY, "steps": C_E_STEPS,
          "resized_kernels": kernels, "decisions_gpu": dg,
          "decisions_equal": dg == dc, "comm_rounds": sg["comm_rounds"],
          "backend_gpu": sg["backend"], "loss_gpu": lg, "loss_cpu": lc,
          "loss_max_rel_diff": loss_rel, "loss_tol": 1e-4})
    if dg != dc or loss_rel > 1e-4 or not sg["resizes"] == sc["resizes"] == 2 \
            or sg["comm_rounds"] != sc["comm_rounds"] \
            or sg["backend"] != sc["backend"] \
            or not any("demote" in r for r in dg):
        raise AssertionError(f"phase C (elastic): the card disagrees with the "
                             f"CPU: {dg} vs {dc}, losses {lg} vs {lc}")
    torch.cuda.empty_cache()


def _leaf_paths(tree, pre=""):
    """'/'-joined key paths of ``tree``'s leaves in tree-flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{pre}/{i}")
    elif tree is not None:
        yield pre


def slstm_igate_mask(cfg, layout, params):
    """bool (rows, LANE) mask of bucket 0: the sLSTM input-gate bias
    entries (``mix/b``, the only ``b`` of a mixer, in its (H, 4, Dh) gate
    layout, gate 1).  Their gradient is zero in exact arithmetic: the bias
    shifts the input gate of every step alike, which scales the cell state
    c and the normalizer n alike, and h = o c / n does not move."""
    import torch
    from repro_torch.core.flatbuf import LANE

    Dh = cfg.d_model // cfg.num_heads
    mask = torch.zeros(layout.bucket_rows[0] * LANE, dtype=torch.bool)
    paths = list(_leaf_paths(params))
    for s in layout.bucket_slots(0):
        if paths[s.index].endswith("/mix/b"):
            j = torch.arange(s.size)
            lo = s.row_offset * LANE
            mask[lo:lo + s.size] = (j % (4 * Dh)) // Dh == 1
    return mask.view(-1, LANE)


def family_inputs(cfg, n: int, frames: int, seed: int) -> dict:
    """The float inputs of ``n`` examples of ``cfg``'s family (numpy
    float32, standard normal from ``seed``): whisper's ``frames`` (n,
    ``frames``, E), the stub of its conv frontend's output; internvl2's
    ``prefix_embed`` (n, Np, E), the stub of its ViT patch embeddings;
    none for a decoder-only family."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((n, frames, cfg.d_model),
                                              dtype=np.float32)}
    if cfg.num_prefix_tokens:
        return {"prefix_embed": rng.standard_normal(
            (n, cfg.num_prefix_tokens, cfg.d_model), dtype=np.float32)}
    return {}


def model_kw(extra: dict, device) -> dict:
    """``lm``'s keyword arguments for a batch's float inputs, on
    ``device`` (a batch's ``frames`` are the model's ``enc_frames``)."""
    import torch
    return {("enc_frames" if k == "frames" else k): torch.as_tensor(v).to(device)
            for k, v in extra.items()}


def phase_c_smoke(runs):
    """Phase C for the models of ``runs`` (M_RUNS, Z_RUNS, X_RUNS) at smoke
    size (whisper's batches and prompts with 64 frames, internvl2's with
    its 8 prefix embeddings),
    the card against the CPU from the same weights (the runs' sync modes
    and worker counts): one local step and one global sync, loss and
    params within phase C's tolerances (loss 1e-4 relative; all but 1e-4
    of the param elements within 1e-4 x the largest); then a prefill and 4
    decode steps of the synced model, logits within M_TOL x (1 + |logit|).
    Under EF-sign the elements of the sLSTM input-gate bias whose
    compressor input takes another sign on the card than on the CPU in
    some worker are left out of the params count (``slstm_igate_mask``:
    that input is the rounding of a zero, and the sync sends each worker
    the mean, so a flip in one worker moves the element for all); the
    flips are counted inside and outside that bias."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch.steps import build_train
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    for tag, arch, mode, workers, *_ in runs:
        smoke = configs.get_smoke(arch)
        run = phase_run(mode, smoke, seq=64, local_batch=2, steps=1,
                        workers=workers)
        p0 = mbase.materialize(lm.param_specs(smoke),
                               torch.Generator().manual_seed(0), "cpu")
        data = lm_examples(markov_lm(vocab=smoke.vocab_size,
                                     num_seqs=workers * 2, seq_len=64))
        data.update(family_inputs(smoke, workers * 2, 64, seed=1))
        batch = next(iter(ShardedBatches(data, workers, 2)))
        rng = np.random.default_rng(1)
        prompt = torch.from_numpy(rng.integers(0, smoke.vocab_size, (2, 12)))
        forced = torch.from_numpy(rng.integers(0, smoke.vocab_size, (2, 4)))
        extra = family_inputs(smoke, 2, 64, seed=2)
        Np = smoke.num_prefix_tokens if "prefix_embed" in extra else 0
        out = {}
        for dev in ("cuda", "cpu"):
            tb = build_train(run, num_workers=workers, device=dev)
            st = tb.init(tree_map(lambda t: t.to(dev).clone(), p0))
            st, m = tb.local_step(st, batch)
            inp = None
            if st.ef_memory is not None:
                inp = (st.anchor.buckets[0][None] - st.params.buckets[0]
                       + st.ef_memory.buckets[0]).cpu()
            st = tb.sync(st, plan=tb.sync_plan)
            params = mean_params(st)
            with torch.no_grad():
                lg, cache = lm.prefill(smoke, params, prompt.to(dev),
                                       max_len=Np + 16, **model_kw(extra, dev))
                rows = [lg[:, -1].cpu()]
                for i in range(forced.shape[1]):
                    lg, cache = lm.decode_step(smoke, params,
                                               forced[:, i:i + 1].to(dev),
                                               cache, Np + prompt.shape[1] + 1 + i)
                    rows.append(lg[:, -1].cpu())
            out[dev] = (float(m["loss"]), float(m["aux"]),
                        st.params.buckets[0].cpu(), rows, inp)
        (lg, ag, pg, rg, ig), (lc, ac, pc, rc, ic) = out["cuda"], out["cpu"]
        loss_rel = abs(lg - lc) / abs(lc)
        beyond = (pg - pc).abs() > 1e-4 * pc.abs().max()
        rec = {}
        if ig is not None:
            flipped = (ig >= 0) != (ic >= 0)
            gate = slstm_igate_mask(smoke, tb.layout, p0)
            beyond &= ~(flipped.any(dim=0) & gate)
            rec.update(sign_flips=int(flipped.sum()),
                       sign_flips_slstm_igate_bias=int((flipped & gate).sum()),
                       slstm_igate_bias_elements=int(gate.sum()))
        frac = float(beyond.float().mean())
        logit_err = max(_close(a, b) for a, b in zip(rg, rc))
        emit({"phase": "C", "part": tag, "model": smoke.name, "W": workers,
              "sync_compression": mode, "steps": 1, "loss_gpu": lg,
              "loss_cpu": lc, "aux_gpu": ag, "aux_cpu": ac,
              "loss_rel_diff": loss_rel, "loss_tol": 1e-4, **rec,
              "params_frac_beyond_1e-4_of_max": frac, "frac_tol": 1e-4,
              "decode_logits_max_rel_err": logit_err, "logits_tol": M_TOL})
        if loss_rel > 1e-4 or frac > 1e-4 or logit_err > M_TOL:
            raise AssertionError(f"phase C ({smoke.name}): the card disagrees "
                                 "with the CPU")
        torch.cuda.empty_cache()



def phase_g() -> dict:
    """Phase G: the paper's experiments through the port's harness
    (``repro_torch.benchmarks``) at its full size: card vs CPU, the full
    rows of G_ROUNDS, two profiles; returns the full rows' launch counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks import common as hc
    from repro_torch.benchmarks import paper_tables as pt
    from repro_torch.kernels import fused_bucket as fb

    train, test = hc.dataset()
    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    # card vs CPU from the same weights (drawn on the CPU, then moved)
    for name, kw in (("fig1/A5_post_local", dict(pt.fig1_rows(24))["A5_post_local"]),
                     ("table4/EFsign_post_H8",
                      dict(pt.table4_rows(24))["EFsign_post_H8"])):
        out = {}
        for dev in ("cuda", "cpu"):
            st, comm, hist = hc.train_local_sgd(steps=24, train=train, device=dev,
                                                return_history=True, **kw)
            out[dev] = (st.params.buckets[0].cpu(), comm,
                        [h["loss"] for h in hist], hc.test_acc(st, test))
        (pg, cg, lg, ag), (pc, cc, lc, ac) = out["cuda"], out["cpu"]
        loss_rel = max(rel(a, b) for a, b in zip(lg, lc))
        frac = float(((pg - pc).abs() > 1e-4 * pc.abs().max()).float().mean())
        emit({"phase": "G", "check": "card vs cpu", "row": name, **kw,
              "steps": 24, "comm_rounds_gpu": cg, "comm_rounds_cpu": cc,
              "loss_gpu": lg, "loss_cpu": lc, "loss_max_rel_diff": loss_rel,
              "loss_tol": 1e-4, "params_frac_beyond_1e-4_of_max": frac,
              "frac_tol": 1e-4, "test_acc_gpu": ag, "test_acc_cpu": ac})
        if cg != cc or loss_rel > 1e-4 or frac > 1e-4:
            raise AssertionError(f"phase G ({name}): the harness on the card "
                                 f"disagrees with the CPU's")

    rows = dict([("fig1/" + n, kw) for n, kw in pt.fig1_rows(G_STEPS)]
                + [("table4/" + n, kw) for n, kw in pt.table4_rows(G_STEPS)]
                + [("table16/" + n, kw) for n, kw in pt.table16_rows()])
    launches = {k: 0 for k in fb.LAUNCHES}
    t0 = time.perf_counter()
    for name in G_ROUNDS:
        kw = rows[name]
        fb.reset_launches()
        with hc.wall_timer() as w:
            st, comm, hist = hc.train_local_sgd(steps=G_STEPS, train=train,
                                                return_history=True,
                                                device="cuda", **kw)
        counts = dict(fb.LAUNCHES)
        rounds = pt.sync_split(comm, kw.get("block_steps", 1))
        losses = [h["loss"] for h in hist]
        acc = hc.test_acc(st, test)
        comp = rounds[0] if kw.get("sync_compression", "none") != "none" else 0
        want = {k: 0 for k in fb.LAUNCHES}
        want.update(fused_sgd_bucket=G_STEPS, row_abs_sum=comp, scale_sign_rows=comp)
        emit({"phase": "G", "row": name, **kw, "steps": G_STEPS,
              "test_acc": acc, "global_sync": rounds[0], "block_sync": rounds[1],
              "us_per_step": w["us"] / G_STEPS,
              "loss_first": losses[0], "loss_final": losses[-1],
              "launches": counts})
        bad = [k for k, ok in (
            ("comm rounds", rounds == G_ROUNDS[name]),
            ("loss not finite or not falling",
             all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
            ("test acc <= 0.5", acc > 0.5),
            ("launches", counts == want)) if not ok]
        if bad:
            raise AssertionError(f"phase G ({name}): {', '.join(bad)} (rounds "
                                 f"{rounds}, want {G_ROUNDS[name]}; launches "
                                 f"{counts}, want {want})")
        for k, v in counts.items():
            launches[k] += v
        del st
    rows_s = time.perf_counter() - t0

    # device busy, idle share and the host's busiest ops over 24 steps of
    # two K=8 rows: B_loc 64 and 32
    for name in ("fig1/A2_large_mb", "table16/H1_Hb8"):
        kw = dict(rows[name], steps=24, train=train, device="cuda")
        hc.train_local_sgd(**dict(kw, steps=4))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            hc.train_local_sgd(**kw)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        ev = prof.key_averages()
        kern = [e for e in ev
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        host = [e for e in ev if e.device_type == DeviceType.CPU]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        emit({"phase": "G", "profile": name, "steps": 24,
              "wall_ms_under_profiler": wall_ms,
              "device_busy_ms": busy_ms if kern else None,
              "idle_share": 1 - busy_ms / wall_ms if kern else None,
              "kernel_launches": sum(e.count for e in kern),
              "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                              for e in sorted(kern, key=lambda e:
                                              -e.self_device_time_total)[:6]],
              "top_host_ops_self_ms": [
                  [e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                  for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]]})
    emit({"phase": "G", "full_rows_s": rows_s})
    return launches


# ---------------------------------------------------------------------------
# phase M: the MoE and MLA decoders at full published width
# ---------------------------------------------------------------------------

M_STEPS = 8
# (part, arch, sync, W, layers): published widths, depth cut.  deepseek runs
# 1 layer: m_reckon's peak at 2 layers (1,589,128,192 params, 6.36 GB a
# copy, 15 copies with EF-sign's 4W sync temporaries) is 95.3 GB, past the card
M_RUNS = (("M1", "olmoe-1b-7b", "none", 4, 2),
          ("M2", "deepseek-v2-lite-16b", "ef_sign", 2, 1))
M_SLOTS, M_MAX_LEN, M_PAGE, M_PREFILL = 8, 256, 16, 128
M_REQUESTS, M_PROMPT, M_NEW = 16, (16, 128), (16, 48)
M_CPU_SEQ = 128                # the card-vs-CPU forward: a (1, 128) batch
M_TOL = 1e-4                   # loss (relative); logits |a-b| <= M_TOL (1+|b|)
M_CHUNK_ROWS = 1 << 18         # rows of a bucket one plain-version call covers


def _event_ms(fn):
    """(fn(), its device ms) between two CUDA events."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def m_check_kernels(state, run, layout, *, lars: bool = False) -> list:
    """Kernels 1-4 against their plain versions on phase M's own trained
    buckets, at the (W, rows, 128) shape the path gives them (olmoe at
    W=4 is past 2^31 elements): fused SGD on clones of the params and
    momentum, with the momentum (a running mean of the run's gradients)
    as its gradient, the run's SGD settings at the base LR, the layout's
    decay rows, a clip scale per worker and stats; sq_sum and
    row_abs_sum on the momentum; scale_sign_rows on it with worker 0's
    row sums / 128 as the row scale.  With ``lars`` kernels 5-6 as well:
    lars_row_norms of the params and momentum, and the fused LARS update
    with a per-row ratio from 1.0 down to 0.5.  A bucket may hold one
    shard region's rows (a rank of a within-worker grid): it then takes
    the region's decay rows.  The plain versions run on chunks
    of M_CHUNK_ROWS rows of the same inputs (one plain pass over the
    whole bucket would need several more bucket copies), their sums
    folded in f64.  One timed launch per kernel; check_kernels'
    tolerances.  Returns one record per bucket."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.kernels import fused_bucket as fb

    def fold(acc, got, want):             # acc: [max |got - want|, max |want|]
        acc[0] = max(acc[0], float((got - want).abs().max()))
        acc[1] = max(acc[1], float(want.abs().max()))

    ls, out = run.local_sgd, []
    for b, (p0, u0) in enumerate(zip(state.params.buckets, state.momentum.buckets)):
        W_, rows = p0.shape[0], p0.shape[1]
        chunks = [slice(r, r + M_CHUNK_ROWS) for r in range(0, rows, M_CHUNK_ROWS)]
        wd_row = flatbuf.const("wd_rows" if rows == layout.bucket_rows[b]
                               else "wd_rows_local", layout, b, p0.device)
        kw = dict(momentum=ls.local_momentum, weight_decay=run.optim.weight_decay,
                  nesterov=ls.nesterov, stats=True,
                  gscale=torch.linspace(1.0, 0.25, W_, device=p0.device))
        lr = run.optim.base_lr
        ms, err = {}, {}

        pk, uk = p0.clone(), u0.clone()
        sk, ms["fused_sgd_bucket"] = _event_ms(
            lambda: fb.fused_sgd_bucket(pk, u0, uk, lr, wd_row, **kw))
        acc_p, acc_u = [0.0, 0.0], [0.0, 0.0]
        stats = [torch.zeros(W_, dtype=torch.float64, device=p0.device)
                 for _ in range(2)]
        for sl in chunks:
            pc, uc = p0[:, sl].clone(), u0[:, sl].clone()
            sp = fb.fused_sgd_bucket_plain(pc, u0[:, sl], uc, lr, wd_row[sl], **kw)
            for acc, x in zip(stats, sp):
                acc += x.double()
            fold(acc_p, pk[:, sl], pc)
            fold(acc_u, uk[:, sl], uc)
            del pc, uc
        del pk, uk
        err["fused_sgd_bucket"] = max(acc_p[0] / acc_p[1], acc_u[0] / acc_u[1])
        err["fused_sgd_bucket_stats"] = max(rel_err(a, w)[1] for a, w in zip(sk, stats))

        got, ms["sq_sum"] = _event_ms(lambda: fb.sq_sum(u0))
        err["sq_sum"] = rel_err(got, sum(fb.sq_sum_plain(u0[:, sl]).double()
                                         for sl in chunks))[1]
        rsum, ms["row_abs_sum"] = _event_ms(lambda: fb.row_abs_sum(u0))
        acc = [0.0, 0.0]
        for sl in chunks:
            fold(acc, rsum[:, sl], fb.row_abs_sum_plain(u0[:, sl]))
        err["row_abs_sum"] = acc[0] / acc[1]
        scale = (rsum[0] / 128).contiguous()
        y, ms["scale_sign_rows"] = _event_ms(lambda: fb.scale_sign_rows(u0, scale))
        err["scale_sign_rows"] = float(not all(
            torch.equal(y[:, sl], fb.scale_sign_rows_plain(u0[:, sl], scale[sl]))
            for sl in chunks))
        del y, rsum, scale
        tol = {"fused_sgd_bucket": TOL["elementwise"],
               "fused_sgd_bucket_stats": TOL["reduction"],
               "sq_sum": TOL["reduction"], "row_abs_sum": TOL["reduction"],
               "scale_sign_rows": TOL["sign"]}
        if lars:
            wd = run.optim.weight_decay
            (pn, gn), ms["lars_row_norms"] = _event_ms(
                lambda: fb.lars_row_norms(p0, u0, wd_row, weight_decay=wd))
            acc_p, acc_g = [0.0, 0.0], [0.0, 0.0]
            for sl in chunks:
                pp, gp = fb.lars_row_norms_plain(p0[:, sl], u0[:, sl], wd_row[sl],
                                                 weight_decay=wd)
                fold(acc_p, pn[:, sl], pp)
                fold(acc_g, gn[:, sl], gp)
            err["lars_row_norms"] = max(acc_p[0] / acc_p[1], acc_g[0] / acc_g[1])
            del pn, gn
            ratio = torch.linspace(1.0, 0.5, W_ * rows, device=p0.device
                                   ).reshape(W_, rows)
            lkw = {k: v for k, v in kw.items() if k != "gscale"}
            pk, uk = p0.clone(), u0.clone()
            sk, ms["fused_lars_bucket"] = _event_ms(
                lambda: fb.fused_lars_bucket(pk, u0, uk, lr, wd_row, ratio, **lkw))
            acc_p, acc_u = [0.0, 0.0], [0.0, 0.0]
            stats = [torch.zeros(W_, dtype=torch.float64, device=p0.device)
                     for _ in range(2)]
            for sl in chunks:
                pc, uc = p0[:, sl].clone(), u0[:, sl].clone()
                sp = fb.fused_lars_bucket_plain(pc, u0[:, sl], uc, lr, wd_row[sl],
                                                ratio[:, sl].contiguous(), **lkw)
                for acc, x in zip(stats, sp):
                    acc += x.double()
                fold(acc_p, pk[:, sl], pc)
                fold(acc_u, uk[:, sl], uc)
                del pc, uc
            del pk, uk, ratio
            err["fused_lars_bucket"] = max(acc_p[0] / acc_p[1], acc_u[0] / acc_u[1])
            err["fused_lars_bucket_stats"] = max(rel_err(a, w)[1]
                                                 for a, w in zip(sk, stats))
            tol.update(lars_row_norms=TOL["reduction"],
                       fused_lars_bucket=TOL["elementwise"],
                       fused_lars_bucket_stats=TOL["reduction"])
        out.append({"bucket": b, "shape": [W_, rows, 128],
                    "elements": W_ * rows * 128, "max_rel_err": err, "tol": tol,
                    "ms": ms, "ok": all(err[k] <= tol[k] for k in err)})
    torch.cuda.empty_cache()
    return out


def shadowed_engine(cfg, shape, params, **kw):
    """``build_engine``'s engine with the contiguous path run beside it on
    the engine's own batches, through its ``on_logits`` hook: each
    admission wave's padded prompts and lengths (the hook's inputs) are
    prefilled into a contiguous (slots, max_tokens) cache, each decode
    step runs ``lm.decode_step`` on it with the step's tokens and
    lengths (idle rows zeroed, as their null pages read), and the live
    rows' logits are held against the paged step's.  An MoE layer routes
    the whole batch at once, and its capacity drops depend on the batch,
    so the contiguous path is held on the same batches, not request by
    request.  Returns (engine, check): ``check`` has the worst
    |a - b| / (1 + |b|), the rows compared and each uid's logit rows."""
    import torch
    from repro_torch.launch.steps import build_engine
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

    eng = build_engine(cfg, shape, params, **kw)
    is_axes = lambda x: isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)
    bdim = [ax.index("batch") for ax in
            tree_leaves(lm.cache_axes_tree(cfg), is_leaf=is_axes)]
    # the hook holds what it reads, not the engine: an engine -> hook ->
    # engine cycle would keep the engine's weights on the card until the
    # cyclic garbage collector ran, into the next phase
    weights, device, max_tokens = eng.params, eng.device, eng.pl.max_tokens
    cont, treedef = tree_flatten(lm.init_cache(
        cfg, eng.max_batch, max_tokens, dtype=torch.float32, device=device))
    check = {"worst": 0.0, "rows": 0, "kept": {}}

    @torch.no_grad()
    def hook(kind, rows, logits, inputs):
        tok, lens = inputs
        for slot, uid in rows:
            check["kept"].setdefault(uid, []).append(logits[slot, -1].clone())
        if kind == "prefill":
            _, c = lm.prefill(cfg, weights, tok, lengths=lens, max_len=max_tokens)
            idx = torch.tensor([s for s, _ in rows], device=device)
            for dst, src, d in zip(cont, tree_leaves(c), bdim):
                dst.index_copy_(d, idx, src.index_select(d, idx).to(dst.dtype))
            return
        idle = torch.nonzero(lens == 0)[:, 0]
        for leaf, d in zip(cont, bdim):
            leaf.index_fill_(d, idle, 0.0)
        want, _ = lm.decode_step(cfg, weights, tok,
                                 tree_unflatten(treedef, cont), lens)
        live = lens > 0
        err = ((logits.double() - want.double()).abs()
               / (1 + want.double().abs()))[live]
        check["worst"] = max(check["worst"], float(err.max()))
        check["rows"] += int(live.sum())

    eng.on_logits = hook
    return eng, check


# the profiler spans of the port's models, each with the part it books to
# (the innermost span an op runs under: the attention inside the encoder
# and the cross-attention books to "attention"):
# the blockwise attention (layers.chunked_attention), blocks.moe_apply's
# routing + dispatch and its combine, the mLSTM chunk loop, the sLSTM cell
# loop, mamba2's Q x Q decay product, whisper's encoder (lm._encode: the
# frontend, positions and every encoder layer) and cross-attention
# (blocks.cross_attn_apply), and internvl2's prefix projection
M_SPANS = {"attention": "attention", "moe.dispatch": "moe_dispatch",
           "moe.combine": "moe_dispatch", "mlstm.chunks": "mlstm_chunks",
           "slstm.cells": "slstm_cells", "mamba2.decay": "mamba2_decay",
           "encoder": "encoder", "cross_attention": "cross_attention",
           "prefix_projection": "prefix_projection"}
# index ops outside the spans: the embedding lookup and its accumulating
# scatter, chunked_xent's label gather and its backward
M_INDEX_OPS = ("aten::index", "aten::index_put_", "aten::_index_put_impl_",
               "aten::gather", "aten::scatter_add_", "aten::index_select",
               "aten::index_add_", "aten::embedding_dense_backward")
EVAL_FN = "autograd::engine::evaluate_function: "


def m_profile_step(bundle, state, batch, cfg) -> dict:
    """torch.profiler over one full-width local step: device time by
    part, each kernel booked to the op that launched it (read from the
    profiler's raw events: building the event tree of an xlstm step, 0.7
    M events with the sLSTM loop, takes minutes).  In order: the spans of
    M_SPANS take the ops under them in the forward and, in the backward,
    the ops under an ``evaluate_function`` whose node a forward op in the
    span created (its sequence number); then the experts' batched matmuls
    (``aten::bmm`` with a 3-D operand whose batch is the expert count),
    the other matmuls by whether they touch the vocabulary (the head) or
    not, the index ops (embedding, the loss's gather), the port's bucket
    kernels (launched through ctypes, under no op), and the rest (the
    elementwise tail)."""
    import bisect
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    X = cfg.moe.num_experts if cfg.moe is not None else None
    V = cfg.vocab_size
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, _ = bundle.local_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    raw = prof.profiler.kineto_results.events()
    ops = [e for e in raw if e.device_type() == DeviceType.CPU]
    by_corr = {e.correlation_id(): e for e in ops if e.correlation_id() > 0}
    # per thread: span intervals (forward) and evaluate_function intervals
    spans, evals = {}, {}
    for e in ops:
        key = e.start_thread_id()
        if e.name() in M_SPANS:
            spans.setdefault(key, []).append((e.start_ns(), e.end_ns(), M_SPANS[e.name()]))
        elif e.name().startswith(EVAL_FN):
            evals.setdefault(key, []).append((e.start_ns(), e.end_ns(), e.sequence_nr()))
    for d in (spans, evals):
        for v in d.values():
            v.sort()

    def enclosing(table, e):
        iv = table.get(e.start_thread_id(), [])
        i = bisect.bisect_right(iv, (e.start_ns(), float("inf"), "")) - 1
        while i >= 0 and iv[i][1] < e.end_ns():
            i -= 1          # intervals of one thread nest or are disjoint
        return iv[i] if i >= 0 else None

    seq_part = {}
    for e in ops:
        if e.sequence_nr() >= 0 and not e.name().startswith(EVAL_FN):
            sp = enclosing(spans, e)
            if sp is not None:
                seq_part[e.sequence_nr()] = sp[2]

    def part_of(op):
        sp = enclosing(spans, op)
        if sp is not None:
            return sp[2]
        ev = enclosing(evals, op)
        if ev is not None and ev[2] in seq_part:
            return seq_part[ev[2]]
        name = op.name()
        shapes = [tuple(x) for x in (op.shapes() or []) if x]
        if name == "aten::bmm" and X is not None and any(
                len(x) == 3 and x[0] == X for x in shapes):
            return "expert_bmm"
        if name in ("aten::mm", "aten::addmm", "aten::bmm"):
            return "head_mm" if any(V in x for x in shapes) else "other_mm"
        if name in M_INDEX_OPS:
            return "embed_xent_index"
        return "other"

    parts = {p: 0.0 for p in (
        "expert_bmm", "moe_dispatch", "attention", "mlstm_chunks",
        "slstm_cells", "mamba2_decay", "encoder", "cross_attention",
        "prefix_projection", "head_mm", "other_mm",
        "embed_xent_index", "bucket_kernels", "other")}
    # kernels, copies and fills (not the spans' device-side ranges)
    busy = 0.0
    for e in raw:
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.name() in M_SPANS):
            continue
        ms = e.duration_ns() / 1e6
        busy += ms
        if kernel_family(e.name()) == "bucket kernels (this port)":
            parts["bucket_kernels"] += ms
            continue
        op = by_corr.get(e.linked_correlation_id())
        parts[part_of(op) if op is not None else "other"] += ms
    return {"window": "1 local step", "wall_ms_under_profiler": wall_ms,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "by_part_ms": {k: v for k, v in parts.items() if v},
            "span_ops": len(seq_part), "parts_sum_ms": sum(parts.values()),
            "unattributed_ms": busy - sum(parts.values())}, state


def engine_check(cfg, params):
    """M_REQUESTS markov-corpus requests on the paged engine (M_SLOTS
    slots, max_len M_MAX_LEN, pages of M_PAGE, prefill M_PREFILL): timed,
    then again on ``shadowed_engine`` beside the contiguous path on the
    engine's own batches.  Returns (record, ok, (reqs, suids, shadow,
    check)): ``ok`` when every request completes, the logits hold within
    M_TOL x (1 + |logit|), the null page stays zero and every page comes
    back."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import markov_lm
    from repro_torch.launch.steps import build_engine
    from repro_torch.telemetry.trace import Tracer

    shape = InputShape("serve", M_MAX_LEN, M_SLOTS, "decode")
    rng = np.random.default_rng(7)
    corpus = markov_lm(vocab=cfg.vocab_size, num_seqs=M_REQUESTS,
                       seq_len=M_PROMPT[1], seed=3)
    reqs = [(corpus[i, :int(rng.integers(M_PROMPT[0], M_PROMPT[1] + 1))].tolist(),
             int(rng.integers(M_NEW[0], M_NEW[1] + 1))) for i in range(M_REQUESTS)]
    tracer = Tracer()
    eng = build_engine(cfg, shape, params, page_size=M_PAGE,
                       prefill_len=M_PREFILL, tracer=tracer)
    uids = [eng.submit(p, max_new=n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = {r.uid: r.tokens for r in eng.run()}
    wall = time.perf_counter() - t0
    spans = lambda name: [sp.dur_s for sp in tracer.spans if sp.name == name]
    desc = eng.describe()
    del eng
    sh, check = shadowed_engine(cfg, shape, params, page_size=M_PAGE,
                                prefill_len=M_PREFILL)
    suids = [sh.submit(p, max_new=n) for p, n in reqs]
    shadow = {r.uid: r for r in sh.run()}
    null_zero = not any(bool(pool[0].any()) for pool in sh.pools)
    pages_back = len(sh.free_pages) == sh.pl.num_pages - 1
    same_tokens = all(shadow[b].tokens == timed[a] for a, b in zip(uids, suids))
    del sh
    rec = {
        "requests": M_REQUESTS, "completed": len(shadow), "slots": M_SLOTS,
        "max_len": M_MAX_LEN, "page_size": M_PAGE, "prefill_len": M_PREFILL,
        "prompt": list(M_PROMPT), "new_tokens": list(M_NEW),
        "tokens_out": desc["tokens_out"], "wall_s": wall,
        "tokens_per_s": desc["tokens_out"] / wall,
        "decode_steps": len(spans("decode")),
        "decode_step_ms_median": 1e3 * statistics.median(spans("decode")),
        "prefill_ms_median": 1e3 * statistics.median(spans("prefill")),
        "pool_bytes": desc["pool_bytes"],
        "logits_vs_contiguous_max_rel_err": check["worst"],
        "logit_rows_compared": check["rows"], "logits_tol": M_TOL,
        "tokens_equal_timed_run": same_tokens,
        "null_page_zero": null_zero, "free_pages_full": pages_back}
    ok = (len(shadow) == M_REQUESTS and set(shadow) == set(suids)
          and check["worst"] <= M_TOL and check["rows"] > 0
          and null_zero and pages_back)
    return rec, ok, (reqs, suids, shadow, check)


def phase_m(tag: str, arch: str, mode: str, workers: int, layers: int) -> dict:
    """Phase M: ``arch`` at its published width, cut in depth only (to
    ``layers``): post-local SGD at phase A's settings with ``mode`` sync
    at ``workers`` workers for M_STEPS steps; kernels 1-4 against their
    plain versions on the trained buckets; the trained model on the card
    against the port on the CPU; then M_REQUESTS requests served from it
    by the paged engine, held against the contiguous path.  Returns the
    training's launch counts."""
    import torch
    from repro_torch import configs
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.launch.dryrun import m_reckon
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.steps import build_train
    from repro_torch.models import blocks, lm
    from repro_torch.utils import tree_map

    t_start = time.perf_counter()
    published = configs.get(arch)
    cfg = published.replace(num_layers=layers)
    run = phase_run(mode, cfg, seq=512, local_batch=8, steps=M_STEPS,
                    workers=workers)
    want_syncs = sum(1 for _, lvl in sync_boundaries(run.local_sgd, M_STEPS)
                     if lvl == 2)
    rec = {"phase": "M", "part": tag, "model": arch, "W": workers,
           "local_batch": 8, "seq": 512, "sync_compression": mode,
           "base_lr": run.optim.base_lr, "grad_clip": run.optim.grad_clip,
           "post_local_switch": run.local_sgd.post_local_switch,
           "local_steps": run.local_sgd.local_steps,
           "reduced": {"num_layers": [published.num_layers, cfg.num_layers],
                       "steps": M_STEPS, "requests": M_REQUESTS,
                       "widths": "published (unchanged)"},
           "memory_reckoning": m_reckon(cfg, workers, mode)}

    # -- train (the counts zeroed just before, read just after); step 0's
    #    routing is kept to count its capacity drops on the card (step 0
    #    is outside every time reported below)
    bundle = build_train(run, num_workers=workers, device="cuda")
    local_step, step0 = bundle.local_step, []

    def first_step_routed(*args):
        if step0:
            return local_step(*args)
        with blocks.record_routes() as routes:
            out = local_step(*args)
        step0.append(sum((~torch.stack(r.valids)).sum() for r in routes))
        return out

    bundle.local_step = first_step_routed
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    try:
        state, hist, summ, step_s = train_run(run, device="cuda", steps=M_STEPS,
                                              workers=workers, bundle=bundle)
    finally:
        bundle.local_step = local_step
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    T = 8 * 512
    rec.update(loss=losses, aux=[h["aux"] for h in hist],
               xent=[h["xent"] for h in hist], comm_rounds=summ["comm_rounds"],
               comm_rounds_scheduled=want_syncs, step_s=step_s,
               step_s_median=statistics.median(step_s[1:]),
               tokens_per_s=workers * T * len(step_s[1:]) / sum(step_s[1:]),
               tokens_per_s_window="steps 1-%d: their tokens over their summed "
                                   "seconds" % (len(step_s) - 1),
               peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, capacity_drops_step0=int(step0[0]),
               routed_choices_per_step=workers * cfg.num_layers * T * cfg.moe.top_k,
               capacity_per_expert=blocks.moe_capacity(cfg, T))
    REFS.setdefault("peak_GB", {})[tag] = rec["peak_mem_GB"]

    # -- kernels 1-4 on the trained buckets (the step and sync temporaries
    #    freed first), then the worker-mean model and one profiled M1 step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec["mem_before_kernel_check_GB"] = torch.cuda.memory_allocated() / 1e9
    rec["kernels_vs_plain"] = m_check_kernels(state, run, bundle.layout)
    rec["peak_mem_kernel_check_GB"] = torch.cuda.max_memory_allocated() / 1e9
    params = mean_params(state)
    if tag == "M1":
        it = ShardedBatches(lm_examples(markov_lm(
            vocab=cfg.vocab_size, num_seqs=workers * 8, seq_len=512, seed=9)),
            workers, 8)
        rec["profile"], state = m_profile_step(bundle, state, next(it), cfg)
    del state, bundle
    torch.cuda.empty_cache()

    # -- the card against the port on the CPU: one (1, 128) forward
    toks = torch.from_numpy(markov_lm(vocab=cfg.vocab_size, num_seqs=1,
                                      seq_len=M_CPU_SEQ + 1, seed=5)).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev, p in (("cuda", params), ("cpu", None)):
        if p is None:
            p = tree_map(lambda t: t.cpu(), params)
        with torch.no_grad(), blocks.record_routes() as routes:
            loss, m = lm.loss_fn(cfg, p, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(loss), float(m["aux"]),
                    [(r.top_i.cpu(), r.probs.cpu()) for r in routes])
        del p
    (lg, ag, rg), (lc, ac, rc) = out["cuda"], out["cpu"]
    flips, near = 0, 0
    for (ig, _), (ic, pc) in zip(rg, rc):
        flips += int((ig != ic).any(dim=-1).sum())
        srt = pc.sort(dim=-1, descending=True).values[:, :cfg.moe.top_k + 1]
        near += int(((srt[:, :-1] - srt[:, 1:]).min(dim=-1).values <= 1e-6).sum())
    loss_rel = abs(lg - lc) / abs(lc)
    rec["card_vs_cpu"] = {"batch": [1, M_CPU_SEQ], "loss_gpu": lg,
                          "loss_cpu": lc, "aux_gpu": ag, "aux_cpu": ac,
                          "loss_rel_diff": loss_rel, "loss_tol": M_TOL,
                          "routing_flips": flips,
                          "near_ties_within_1e-6": near,
                          "tokens_x_layers": M_CPU_SEQ * cfg.num_layers}

    # -- serve: a timed engine run, then the same requests on the shadowed
    #    engine, held against the contiguous path on the engine's batches
    rec["serve"], serve_ok, (reqs, suids, shadow, check) = engine_check(cfg, params)
    # request by request (batch of one), for the record: capacity drops
    # depend on the batch, so this is a reading, not a check
    iso = []
    for uid in suids[:2]:
        want = _forced_logits(cfg, params, reqs[uid][0], shadow[uid].tokens,
                              max_len=M_MAX_LEN)
        iso.append(max(_close(a, b) for a, b in zip(check["kept"][uid], want)))
    del params
    torch.cuda.empty_cache()
    rec["serve"].update(isolated_request_max_rel_err=iso,
                        moe_capacity_decode=blocks.moe_capacity(cfg, M_SLOTS))
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec)
    comp = want_syncs if mode != "none" else 0
    want_launches = {k: 0 for k in fb.LAUNCHES}
    want_launches.update(fused_sgd_bucket=M_STEPS, sq_sum=M_STEPS,
                         row_abs_sum=comp, scale_sign_rows=comp)
    bad = [k for k, ok in (
        ("loss", all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("aux", all(math.isfinite(h["aux"]) and h["aux"] > 0 for h in hist)),
        ("comm rounds", summ["comm_rounds"] == {"block": 0, "global": want_syncs}),
        ("launches", counts == want_launches),
        ("kernels vs plain", all(k["ok"] for k in rec["kernels_vs_plain"])),
        ("card vs cpu", loss_rel <= M_TOL),
        ("served", serve_ok)) if not ok]
    if bad:
        raise AssertionError(f"phase {tag}: {', '.join(bad)} ({rec})")
    return counts

# phase W: the 1-bit wire format at phase B's settings; the coalesced run's
# steps (4: the syncs of steps 0-3, before the post-local switch)
W_COALESCE_STEPS = 4


def phase_w(cfg, b_losses: list, b_wire_bytes: float, b_sync_s: float,
            b_step_s: float) -> dict:
    """Phase W: phase B's run (EF-sign, paper-lm at full width, W=4, 12
    steps) with ``wire_pack=True``, traced with a fenced tracer: per-step
    losses against phase B's (1e-4 relative), the plan's and the ledger's
    wire bytes against B's, the fenced sync seconds against phase R's
    (B traced the same way), launches (kernel 3 twice a sync: the
    compressor's and the pack's row sums); the first sync's uint8 payload on
    the card held byte for byte against the same pack of the same bucket
    on the CPU, its row sums in the kernel's order (``cpu_pack``; scales
    bit for bit: the same adds); then W_COALESCE_STEPS steps
    with ``sync_coalesce=True`` too: the same plan stages and losses.
    Returns the launch counts of the first run."""
    import torch
    from repro_torch.core import compression as comp
    from repro_torch.core import flatbuf
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.steps import build_train
    from repro_torch.telemetry.trace import Tracer

    run = phase_run("ef_sign", cfg, seq=512, local_batch=8, wire_pack=True)
    bundle = build_train(run, num_workers=W, device="cuda")
    layout, plan = bundle.layout, bundle.sync_plan
    first = {}
    pack = comp.pack_bucket_signs

    def capture(x, seg, sizes, **kw):
        # the first sync's bucket and payload, kept on the card (nothing
        # writes to them after the pack) and moved off it after the run
        out = pack(x, seg, sizes, **kw)
        if not first:
            first.update(x=x, packed=out[0], scales=out[1])
        return out

    tracer = Tracer(fence=True)
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    comp.pack_bucket_signs = capture
    try:
        state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS,
                                              bundle=bundle, tracer=tracer)
    finally:
        comp.pack_bucket_signs = pack
    counts = dict(fb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # every worker's final params rows, for phase Y's bitwise checks
    row_sha = row_digests(state.params.buckets[0])
    del state
    first = {k: v.cpu() for k, v in first.items()}
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, b_losses))
    syncs = [sp.dur_s for sp in tracer.spans
             if sp.name == "sync" and sp.attrs.get("scope") == "global"]
    led = summ["ledger"]
    round_bytes, round_colls = plan.scope_cost("global")
    rows = layout.bucket_rows[0]

    # the card's payload against the same pack on the CPU
    t0 = time.perf_counter()
    seg = flatbuf.const("row_segments", layout, 0, "cpu")
    sizes = flatbuf.const("segment_sizes", layout, 0, "cpu")
    packed_cpu, scales_cpu = cpu_pack(first["x"], seg, sizes)
    cpu_pack_s = time.perf_counter() - t0
    payload_equal = torch.equal(first["packed"], packed_cpu)
    scale_rel = float(((first["scales"] - scales_cpu).abs()
                       / scales_cpu.abs().clamp_min(1e-30)).max())

    # coalesced: on one card every bucket is its own dtype class, so the
    # plan and the trajectory are the wire-packed run's
    crun = phase_run("ef_sign", cfg, seq=512, local_batch=8, wire_pack=True,
                     coalesce=True, steps=W_COALESCE_STEPS)
    cb = build_train(crun, num_workers=W, device="cuda")
    stage = lambda p: [(s.kind, s.scope, s.buckets, s.compression, s.wire_bytes,
                        s.collectives, s.coalesced) for s in p.stages]
    cstate, chist, csumm, _ = train_run(crun, device="cuda", steps=W_COALESCE_STEPS,
                                        bundle=cb)
    del cstate
    torch.cuda.empty_cache()
    closses = [h["loss"] for h in chist]
    c_rel = max(abs(a - b) / abs(b) for a, b in zip(closses, losses))
    emit({"phase": "W", "model": cfg.name, "W": W, "local_batch": 8, "seq": 512,
          "sync_compression": "ef_sign", "wire_pack": True, "steps": STEPS,
          "loss": losses, "phase_B_loss": b_losses,
          "loss_max_rel_diff_vs_B": loss_rel, "loss_tol": 1e-4,
          "comm_rounds": summ["comm_rounds"],
          "payload_bytes_per_worker": first["packed"][0].numel(),
          "payload_shape": list(first["packed"].shape),
          "f32_bytes_per_worker": rows * flatbuf.LANE * 4,
          "scales_per_worker": first["scales"].shape[-1],
          "payload_equal_cpu_pack": payload_equal,
          "scales_max_rel_diff_cpu": scale_rel, "scales_tol": 0.0,
          "cpu_pack_s": cpu_pack_s,
          "plan": plan.describe(), "plan_round_wire_bytes": round_bytes,
          "plan_round_collectives": round_colls,
          "ledger_wire_bytes": led["wire_bytes"],
          "phase_B_ledger_wire_bytes": b_wire_bytes,
          "ledger_over_B": led["wire_bytes"] / b_wire_bytes,
          "sync_s_fenced": syncs, "sync_s_median": statistics.median(syncs),
          "phase_R_sync_s_median": b_sync_s,
          "sync_s_over_phase_R": statistics.median(syncs) / b_sync_s,
          "step_s": step_s, "step_s_median": statistics.median(step_s[1:]),
          "phase_B_step_s_median": b_step_s, "peak_mem_GB": peak,
          "launches": counts,
          "coalesce": {"steps": W_COALESCE_STEPS, "plan": cb.sync_plan.describe(),
                       "stages_equal_W": stage(cb.sync_plan) == stage(plan),
                       "loss": closses, "loss_max_rel_diff_vs_W": c_rel,
                       "comm_rounds": csumm["comm_rounds"]}})
    want = {k: 0 for k in fb.LAUNCHES}
    # kernel 3 twice a sync: the compressor's row sums, then the pack's
    want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS, row_abs_sum=12,
                scale_sign_rows=6)
    bad = [k for k, ok in (
        ("loss", all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("loss vs phase B", loss_rel <= 1e-4),
        ("comm rounds", summ["comm_rounds"] == {"block": 0, "global": 6}),
        ("payload", payload_equal and first["packed"].dtype == torch.uint8
         and tuple(first["packed"].shape) == (W, rows, 16)),
        ("scales", scale_rel == 0.0),
        ("plan", plan.wire_pack and round_colls == 2),
        ("ledger", math.isclose(led["wire_bytes"], 6 * round_bytes, rel_tol=1e-12)
         and led["wire_bytes"] < b_wire_bytes / 15),
        ("syncs", len(syncs) == 6),
        ("launches", counts == want),
        ("coalesce plan", stage(cb.sync_plan) == stage(plan)
         and cb.sync_plan.coalesce),
        ("coalesce loss", c_rel <= 1e-4
         and csumm["comm_rounds"] == {"block": 0, "global": W_COALESCE_STEPS})) if not ok]
    if bad:
        raise AssertionError(f"phase W: {', '.join(bad)} (loss diff {loss_rel}, "
                             f"scales {scale_rel}, launches {counts})")
    REFS["W"] = {"loss": losses, "comm_rounds": summ["comm_rounds"],
                 "packed": first["packed"], "scales": first["scales"],
                 "sync_s_median": statistics.median(syncs),
                 "row_sha": row_sha}
    return counts


D_SLOTS, D_PAGE, D_PREFILL, D_REQUESTS, D_NEW = 8, 16, 128, 16, (16, 48)
D_STEPS = 8     # phase M's count: the 4 sync steps before the post-local
                # switch, then 4 local steps (the loss first falls there)
# (part, arch, W, layers, serving max_len, prompt lengths, the card-vs-CPU
# forward's length).  Published widths; only depth, W and steps are cut.
# m_reckon counts 7 copies of the params at the mean sync (W=2); a step
# adds the leaf gradients (one copy), several (8, 512, V) f32 tensors in
# the loss's backward (2.5-4.3 GB each) and the layers' activations.
# Peaks measured at these depths and at one more layer (H100 80GB HBM3,
# 700 W, expandable segments): qwen3-32b 1 layer 73.9 GB (57.2 reckoned;
# its untied embedding and head alone are 1.56 B params, so 1 layer is
# the floor); phi4-mini-3.8b 4 layers 67.8 GB (45.7 reckoned);
# minitron-4b 2 layers 74.3 GB (50.2), so it runs 1 (47.1 reckoned).
# gemma3-1b ran all 26 layers (28.0 reckoned) until the script's time
# limit cut it to 12, two of its 5 sliding : 1 global groups (all 26 took
# 66-70 s of the script), then to 6, one group (12 took 41-64 s; phase J
# took the script to 1,049.8 s of its 930 s target), then to 2 sliding
# layers (6 took 48.2 s on an H100 80GB HBM3 at 700.00 W; phase V's tree
# parts took the script to 991.8 s of that target; the global layer's
# rope_theta_global is held against the reference on the CPU,
# tests/test_torch_dense.py); its window is 512, so it
# trains at seq 1024 with local batch 4 (phase A's tokens a step), and its
# sliding layers' mask and its backward run in every step; its serving
# prompts and its CPU forward run past the window too.  The last two
# fields are each part's training seq and local batch.
D_RUNS = (("D1", "gemma3-1b", 2, 2, 768, (16, 600), 768, 1024, 4),
          ("D2", "qwen3-32b", 2, 1, 256, (16, 128), 128, 512, 8),
          ("D3", "phi4-mini-3.8b", 2, 4, 256, (16, 128), 128, 512, 8),
          ("D4", "minitron-4b", 2, 1, 256, (16, 128), 128, 512, 8))


def phase_d(tag: str, arch: str, workers: int, layers: int, max_len: int,
            prompt: tuple, cpu_seq: int, seq: int, local_batch: int,
            steps: int = D_STEPS) -> dict:
    """Phase D: a dense variant at its published width, depth cut to
    ``layers``: post-local SGD at phase A's settings (mean sync) at
    ``workers`` workers of ``local_batch`` x ``seq`` tokens a step for
    ``steps`` steps: losses finite and falling
    from about ln V, comm rounds equal to the schedule's, median step,
    tokens/s, peak memory against the reckoning, launches (the update
    and sq_sum every step); D1's step under torch.profiler split by part;
    the worker-mean model on the card against the port on the CPU on a
    (1, cpu_seq) batch (loss 1e-4 relative); D_REQUESTS requests served on
    the paged engine, timed, then beside the contiguous path on the
    engine's own batches (logits within 1e-4 x (1 + |logit|)).  Returns
    the training's launch counts."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.launch.dryrun import m_reckon
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.steps import build_engine, build_train
    from repro_torch.models import lm
    from repro_torch.telemetry.trace import Tracer
    from repro_torch.utils import tree_map

    # what an earlier phase left in reference cycles (an engine and its
    # weights) is freed before this one's peak is read
    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    published = configs.get(arch)
    cfg = published.replace(num_layers=layers)
    run = phase_run("none", cfg, seq=seq, local_batch=local_batch, steps=steps,
                    workers=workers)
    want_syncs = sum(1 for _, lvl in sync_boundaries(run.local_sgd, steps)
                     if lvl == 2)
    reckon = m_reckon(cfg, workers, "none")
    rec = {"phase": "D", "part": tag, "model": arch, "W": workers,
           "local_batch": local_batch, "seq": seq, "sync_compression": "none",
           "train_past_window": bool(cfg.sliding_window
                                     and seq > cfg.sliding_window),
           "base_lr": run.optim.base_lr, "grad_clip": run.optim.grad_clip,
           "post_local_switch": run.local_sgd.post_local_switch,
           "local_steps": run.local_sgd.local_steps,
           "reduced": {"num_layers": [published.num_layers, cfg.num_layers],
                       "W": workers, "steps": steps, "requests": D_REQUESTS,
                       "widths": "published (unchanged)"},
           "memory_reckoning": reckon, "ln_vocab": math.log(cfg.vocab_size)}

    bundle = build_train(run, num_workers=workers, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    rec["mem_before_GB"] = torch.cuda.memory_allocated() / 1e9
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=steps,
                                          workers=workers, bundle=bundle)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    T = local_batch * seq
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec.update(loss=losses, comm_rounds=summ["comm_rounds"],
               comm_rounds_scheduled=want_syncs, step_s=step_s,
               step_s_median=statistics.median(step_s[1:]),
               tokens_per_s=workers * T * len(step_s[1:]) / sum(step_s[1:]),
               tokens_per_s_window="steps 1-%d: their tokens over their summed "
                                   "seconds" % (len(step_s) - 1),
               peak_mem_GB=peak,
               peak_over_reckoned=peak * 1e9 / reckon["reckoned_peak_bytes"],
               launches=counts)
    REFS.setdefault("peak_GB", {})[tag] = peak
    params = mean_params(state)
    if tag == "D1":
        it = ShardedBatches(lm_examples(markov_lm(
            vocab=cfg.vocab_size, num_seqs=workers * local_batch, seq_len=seq,
            seed=9)), workers, local_batch)
        rec["profile"], state = m_profile_step(bundle, state, next(it), cfg)
    del state, bundle
    torch.cuda.empty_cache()

    # -- the card against the port on the CPU: one (1, cpu_seq) forward
    toks = torch.from_numpy(markov_lm(vocab=cfg.vocab_size, num_seqs=1,
                                      seq_len=cpu_seq + 1, seed=5)).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev, p in (("cuda", params), ("cpu", None)):
        if p is None:
            p = tree_map(lambda t: t.cpu(), params)
        with torch.no_grad():
            loss, _ = lm.loss_fn(cfg, p, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = float(loss)
        del p
    loss_rel = abs(out["cuda"] - out["cpu"]) / abs(out["cpu"])
    rec["card_vs_cpu"] = {"batch": [1, cpu_seq], "loss_gpu": out["cuda"],
                          "loss_cpu": out["cpu"], "loss_rel_diff": loss_rel,
                          "loss_tol": M_TOL,
                          "past_window": bool(cfg.sliding_window
                                              and cpu_seq > cfg.sliding_window)}

    # -- serve: a timed engine run, then the shadowed engine
    shape = InputShape("serve", max_len, D_SLOTS, "decode")
    rng = np.random.default_rng(7)
    corpus = markov_lm(vocab=cfg.vocab_size, num_seqs=D_REQUESTS,
                       seq_len=prompt[1], seed=3)
    reqs = [(corpus[i, :int(rng.integers(prompt[0], prompt[1] + 1))].tolist(),
             int(rng.integers(D_NEW[0], D_NEW[1] + 1))) for i in range(D_REQUESTS)]
    tracer = Tracer()
    eng = build_engine(cfg, shape, params, page_size=D_PAGE, prefill_len=D_PREFILL,
                       tracer=tracer)
    uids = [eng.submit(p, max_new=n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = {r.uid: r.tokens for r in eng.run()}
    wall = time.perf_counter() - t0
    spans = lambda name: [sp.dur_s for sp in tracer.spans if sp.name == name]
    desc = eng.describe()
    del eng
    sh, check = shadowed_engine(cfg, shape, params, page_size=D_PAGE,
                                prefill_len=D_PREFILL)
    suids = [sh.submit(p, max_new=n) for p, n in reqs]
    shadow = {r.uid: r for r in sh.run()}
    null_zero = not any(bool(pool[0].any()) for pool in sh.pools)
    pages_back = len(sh.free_pages) == sh.pl.num_pages - 1
    same_tokens = all(shadow[b].tokens == timed[a] for a, b in zip(uids, suids))
    longest = max(len(p) + n for p, n in reqs)
    del sh, params
    torch.cuda.empty_cache()
    rec["serve"] = {
        "requests": D_REQUESTS, "completed": len(shadow), "slots": D_SLOTS,
        "max_len": max_len, "page_size": D_PAGE, "prefill_len": D_PREFILL,
        "prompt": list(prompt), "new_tokens": list(D_NEW),
        "longest_sequence": longest,
        "past_window": bool(cfg.sliding_window and longest > cfg.sliding_window),
        "tokens_out": desc["tokens_out"], "wall_s": wall,
        "tokens_per_s": desc["tokens_out"] / wall,
        "decode_steps": len(spans("decode")),
        "decode_step_ms_median": 1e3 * statistics.median(spans("decode")),
        "prefill_ms_median": 1e3 * statistics.median(spans("prefill")),
        "pool_bytes": desc["pool_bytes"],
        "logits_vs_contiguous_max_rel_err": check["worst"],
        "logit_rows_compared": check["rows"], "logits_tol": M_TOL,
        "tokens_equal_timed_run": same_tokens,
        "null_page_zero": null_zero, "free_pages_full": pages_back}
    rec["seconds"] = time.perf_counter() - t_start
    emit(rec)
    want_launches = {k: 0 for k in fb.LAUNCHES}
    want_launches.update(fused_sgd_bucket=steps, sq_sum=steps)
    bad = [k for k, ok in (
        ("loss", all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("comm rounds", summ["comm_rounds"] == {"block": 0, "global": want_syncs}),
        ("launches", counts == want_launches),
        ("card vs cpu", loss_rel <= M_TOL),
        ("served", len(shadow) == D_REQUESTS and set(shadow) == set(suids)),
        ("logits", check["worst"] <= M_TOL and check["rows"] > 0),
        ("null page", null_zero), ("free pages", pages_back)) if not ok]
    if bad:
        raise AssertionError(f"phase {tag}: {', '.join(bad)} ({rec})")
    return counts


# phase Z: the recurrent families at their published widths.  (part, arch,
# sync, W, layers, seq, local batch, float32 rule).  Only depth, W, steps
# (and, had a probe run out of memory, the local batch) are cut.  The depth
# floors are part of what is run: xlstm needs 8 layers for one sLSTM block
# (its pattern is 7 mLSTM : 1 sLSTM) and zamba2 12 for two invocations of
# the shared attention block (every 6th layer).  Z1 xlstm-1.3b runs at
# that floor, 8 of 48 layers (7 mLSTM + 1 sLSTM), to keep the script in its
# time limit (at 16 layers, 14 mLSTM + 2 sLSTM, 785,487,984 params and
# m_reckon's 47.1 GB, it took 134-146 s of the script, a third of it
# profiling one step's sLSTM event tree); Z2 zamba2-7b at 12 of
# 81 (10 mamba2 + 2 shared-block invocations, 1,522,983,968 params, 6.09
# GB a copy; 7 copies at the mean sync, 42.6 GB).
Z_RUNS = (("Z1", "xlstm-1.3b", "ef_sign", 2, 8, 512, 8, "cpu"),
          ("Z2", "zamba2-7b", "none", 2, 12, 512, 8, "tol"))
Z_STEPS = 8                    # phase M's count
Z_PROMPTS, Z_PROMPT_LEN, Z_NEW = 8, 128, 32
Z_DECODE_TOL = 2e-4            # decode vs the train-mode forward, x (1 + |logit|)
# The card-vs-CPU forward and the decode are held at their tolerances
# twice: in float32, and with the same weights widened to float64 (the
# float64 checks bind every part).  A part's float32 rule says how its
# float32 logits are held.  "tol": at the tolerances (zamba2).  "cpu":
# xlstm is ill-conditioned in float32 (read at 16 layers: the per-head
# norm of the mLSTM output divides by an RMS as small as 4e-4, the sLSTM
# layers amplify rounding further), so its float32 logits sit 3e-4 to 0.5 from
# their float64 values on the CPU as on the card, beyond both tolerances.
# There the card's float32 logits, forward and decode, are held within
# Z_F32_FACTOR times the CPU's own float32 error against the float64
# logits (the CPU evaluating the same weights and tokens: the forward's
# batch, and the first Z_CPU_PROMPTS prompts of the decode), and their
# error at the tolerances is recorded.  Over this script's runs on an
# H100 (700 W) the card/CPU ratio of those errors read 0.06-4.7 for the
# forward and 1.0-3.9 for the decode; with TF32 matmuls on the card,
# 1,389-1,500 and 940-2,619 (PERF.md section 6).
Z_F32_FACTOR = 16.0
Z_CPU_PROMPTS = 2


def phase_z(tag: str, arch: str, mode: str, workers: int, layers: int, seq: int,
            local_batch: int, f32_rule: str) -> dict:
    """Phase Z: a recurrent family at its published width, depth cut to
    ``layers``: post-local SGD at phase A's settings with ``mode`` sync at
    ``workers`` workers of ``local_batch`` x ``seq`` tokens for Z_STEPS
    steps: losses finite and falling, comm rounds equal to the schedule's,
    median step, tokens/s, peak memory against the reckoning (printed
    before the run), launches (the update and sq_sum every step, the
    compressor pair every EF-sign sync); one step under torch.profiler
    split by part; the worker-mean model on the card against the port on
    the CPU on a (1, M_CPU_SEQ) batch (loss 1e-4 relative, logits within
    1e-4 x (1 + |logit|)); then served through the contiguous path
    (``build_serve``): Z_PROMPTS prompts of Z_PROMPT_LEN tokens prefilled
    in one batch (exact length), Z_NEW greedy decode steps timed, every
    step's logits held against the train-mode forward over prompt +
    generated tokens within Z_DECODE_TOL x (1 + |logit|).  Both checks run
    in float32 and in float64 (the weights widened), as ``f32_rule`` says
    (see Z_F32_FACTOR); ``build_engine`` refuses the model (ValueError:
    the paged pool needs a kv_seq axis).  Returns the training's launch
    counts."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.launch.dryrun import m_reckon
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.steps import build_engine, build_serve, build_train
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    published = configs.get(arch)
    cfg = published.replace(num_layers=layers)
    run = phase_run(mode, cfg, seq=seq, local_batch=local_batch, steps=Z_STEPS,
                    workers=workers)
    want_syncs = sum(1 for _, lvl in sync_boundaries(run.local_sgd, Z_STEPS)
                     if lvl == 2)
    reckon = m_reckon(cfg, workers, mode)
    schedule = [bd.mixer for bd in cfg.layer_schedule()]
    emit({"phase": "Z", "part": tag, "model": arch, "before": "training",
          "memory_reckoning": reckon, "layer_mixers": schedule})
    rec = {"phase": "Z", "part": tag, "model": arch, "W": workers,
           "local_batch": local_batch, "seq": seq, "sync_compression": mode,
           "base_lr": run.optim.base_lr, "grad_clip": run.optim.grad_clip,
           "post_local_switch": run.local_sgd.post_local_switch,
           "local_steps": run.local_sgd.local_steps,
           "layer_mixers": {m: schedule.count(m) for m in sorted(set(schedule))},
           "reduced": {"num_layers": [published.num_layers, cfg.num_layers],
                       "W": workers, "steps": Z_STEPS,
                       "local_batch": local_batch,
                       "widths": "published (unchanged)"},
           "memory_reckoning": reckon}

    bundle = build_train(run, num_workers=workers, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    rec["mem_before_GB"] = torch.cuda.memory_allocated() / 1e9
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=Z_STEPS,
                                          workers=workers, bundle=bundle)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    T = local_batch * seq
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec.update(loss=losses, comm_rounds=summ["comm_rounds"],
               comm_rounds_scheduled=want_syncs, step_s=step_s,
               step_s_median=statistics.median(step_s[1:]),
               tokens_per_s=workers * T * len(step_s[1:]) / sum(step_s[1:]),
               tokens_per_s_window="steps 1-%d: their tokens over their summed "
                                   "seconds" % (len(step_s) - 1),
               peak_mem_GB=peak,
               peak_over_reckoned=peak * 1e9 / reckon["reckoned_peak_bytes"],
               launches=counts)
    REFS.setdefault("peak_GB", {})[tag] = peak
    split = {"train": time.perf_counter() - t_start}
    it = ShardedBatches(lm_examples(markov_lm(
        vocab=cfg.vocab_size, num_seqs=workers * local_batch, seq_len=seq,
        seed=9)), workers, local_batch)
    t0 = time.perf_counter()
    rec["profile"], state = m_profile_step(bundle, state, next(it), cfg)
    split["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = mean_params(state)
    del state, bundle
    gc.collect()
    torch.cuda.empty_cache()

    # -- the card against the port on the CPU: one (1, M_CPU_SEQ) forward,
    #    in float32 and, the same weights widened, in float64
    toks = torch.from_numpy(markov_lm(vocab=cfg.vocab_size, num_seqs=1,
                                      seq_len=M_CPU_SEQ + 1, seed=5)).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    f32, f64 = torch.float32, torch.float64
    out = {}
    for dev, dt in (("cuda", f32), ("cpu", f32), ("cuda", f64), ("cpu", f64)):
        p = tree_map(lambda t: t.to(dev, dt), params)
        with torch.no_grad():
            b = {k: v.to(dev) for k, v in batch.items()}
            loss, _ = lm.loss_fn(cfg, p, b)
            lg = lm.logits_from_hidden(cfg, p, lm.forward(cfg, p, b["tokens"]))
        out[dev, dt] = (float(loss), lg.cpu())
        del p, lg
    (lg_, ag), (lc, ac) = out["cuda", f32], out["cpu", f32]
    (lg64, ag64), (lc64, ac64) = out["cuda", f64], out["cpu", f64]
    loss_rel, logit_err = abs(lg_ - lc) / abs(lc), _close(ag, ac)
    loss_rel64, logit_err64 = abs(lg64 - lc64) / abs(lc64), _close(ag64, ac64)
    card32, cpu32 = _close(ag, ac64), _close(ac, ac64)
    f32_ok = (logit_err <= M_TOL if f32_rule == "tol"
              else card32 <= Z_F32_FACTOR * cpu32)
    cv_ok = (loss_rel <= M_TOL and loss_rel64 <= M_TOL and logit_err64 <= M_TOL
             and f32_ok)
    rec["card_vs_cpu"] = {"batch": [1, M_CPU_SEQ], "float32_rule": f32_rule,
                          "loss_gpu": lg_, "loss_cpu": lc,
                          "loss_rel_diff": loss_rel, "loss_tol": M_TOL,
                          "logits_max_rel_err": logit_err, "logits_tol": M_TOL,
                          "float32_logits_within_tol": logit_err <= M_TOL,
                          "float64": {"loss_rel_diff": loss_rel64,
                                      "logits_max_rel_err": logit_err64},
                          "float32_vs_float64_logits": {
                              "card": card32, "cpu": cpu32,
                              "card_over_cpu": card32 / cpu32,
                              "card_mean": _close(ag, ac64, "mean"),
                              "cpu_mean": _close(ac, ac64, "mean")},
                          "ok": cv_ok}
    if f32_rule == "cpu":
        rec["card_vs_cpu"]["factor"] = Z_F32_FACTOR
    del out, ag, ac, ag64, ac64
    split["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- serve through the contiguous path: prefill, greedy decode; then the
    #    same tokens through prefill + decode against the train-mode forward
    #    in float64 (and, under the "cpu" rule, through the CPU's float32)
    serve = build_serve(cfg, device="cuda")
    prompt = torch.from_numpy(markov_lm(vocab=cfg.vocab_size, num_seqs=Z_PROMPTS,
                                        seq_len=Z_PROMPT_LEN, seed=3)
                              [:, :Z_PROMPT_LEN]).long()

    def decode_rows(serve, p, prompt, tokens):
        """Prefill and decode logits over ``tokens`` fed after the prompt
        (row i: the logits after prompt + i tokens)."""
        lg, cache = serve.prefill(p, {"tokens": prompt})
        cache = lm.grow_cache(cfg, cache, Z_PROMPT_LEN + Z_NEW)
        rows = [lg[:, -1].cpu()]
        for i in range(Z_NEW):
            lg, cache = serve.decode_step(p, {"tokens": tokens[:, i:i + 1]}, cache,
                                          Z_PROMPT_LEN + 1 + i)
            rows.append(lg[:, -1].cpu())
        return torch.stack(rows)

    def forward_rows(p, prompt, tokens):
        """The train-mode forward's logits at the same positions."""
        full = lm.logits_from_hidden(cfg, p, lm.forward(
            cfg, p, torch.cat([prompt, tokens], dim=1)))
        return full[:, Z_PROMPT_LEN - 1:].transpose(0, 1).cpu()

    with torch.no_grad():
        prompt_d = prompt.cuda()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache = serve.prefill(params, {"tokens": prompt_d})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t1)
        cache = lm.grow_cache(cfg, cache, Z_PROMPT_LEN + Z_NEW)
        rows, tokens, dec_s = [lg[:, -1].cpu()], [], []
        nxt = lg[:, -1].argmax(-1)
        for i in range(Z_NEW):
            tokens.append(nxt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, cache = serve.decode_step(params, {"tokens": nxt[:, None]}, cache,
                                          Z_PROMPT_LEN + 1 + i)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t1)
            rows.append(lg[:, -1].cpu())
            nxt = lg[:, -1].argmax(-1)
        del cache
        tokens = torch.stack(tokens, dim=1)
        rows = torch.stack(rows)
        want = forward_rows(params, prompt_d, tokens)
        p64 = tree_map(lambda t: t.double(), params)
        rows64 = decode_rows(serve, p64, prompt_d, tokens)
        want64 = forward_rows(p64, prompt_d, tokens)
        del p64
        if f32_rule == "cpu":
            k = Z_CPU_PROMPTS
            rows_cpu = decode_rows(build_serve(cfg, device="cpu"),
                                   tree_map(lambda t: t.cpu(), params),
                                   prompt[:k], tokens[:k].cpu())
    decode_err, decode_err64 = _close(rows, want), _close(rows64, want64)
    dec_card32 = _close(rows, want64)
    f32_dec = {"decode": dec_card32, "train_forward": _close(want, want64),
               "decode_mean": _close(rows, want64, "mean"),
               "train_forward_mean": _close(want, want64, "mean")}
    if f32_rule == "tol":
        dec32_ok = decode_err <= Z_DECODE_TOL
    else:
        sub = _close(rows[:, :k], want64[:, :k])
        dec_cpu32 = _close(rows_cpu, want64[:, :k])
        f32_dec.update(cpu_prompts=k, decode_card_those_prompts=sub,
                       decode_cpu=dec_cpu32, decode_card_over_cpu=sub / dec_cpu32,
                       decode_cpu_mean=_close(rows_cpu, want64[:, :k], "mean"))
        dec32_ok = sub <= Z_F32_FACTOR * dec_cpu32
    decode_ok = decode_err64 <= Z_DECODE_TOL and dec32_ok
    refused = []
    for kw in (dict(), dict(page_size=16)):
        try:
            build_engine(cfg, InputShape("serve", Z_PROMPT_LEN + Z_NEW, Z_PROMPTS,
                                         "decode"), params, device="cuda", **kw)
        except ValueError as e:
            refused.append(str(e)[:160])
    del params, serve
    gc.collect()
    torch.cuda.empty_cache()
    rec["serve"] = {
        "route": "launch.steps.build_serve (contiguous cache)",
        "prompts": Z_PROMPTS, "prompt_len": Z_PROMPT_LEN, "new_tokens": Z_NEW,
        "prefill_ms": prefill_ms,
        "decode_step_ms_median": 1e3 * statistics.median(dec_s),
        "decode_steps": len(dec_s),
        "decode_tokens_per_s": Z_PROMPTS * len(dec_s) / sum(dec_s),
        "float32_rule": f32_rule,
        "decode_vs_train_forward_max_rel_err": decode_err,
        "float32_decode_within_tol": decode_err <= Z_DECODE_TOL,
        "logit_rows_compared": rows.shape[0], "decode_tol": Z_DECODE_TOL,
        "float64": {"decode_vs_train_forward_max_rel_err": decode_err64},
        "float32_vs_float64_logits": f32_dec,
        "ok": decode_ok,
        "build_engine_refused": refused}
    if f32_rule == "cpu":
        rec["serve"]["factor"] = Z_F32_FACTOR
    split["serve"] = time.perf_counter() - t0
    rec["seconds"] = time.perf_counter() - t_start
    rec["seconds_by_part"] = split
    emit(rec)
    comp = want_syncs if mode != "none" else 0
    want_launches = {k: 0 for k in fb.LAUNCHES}
    want_launches.update(fused_sgd_bucket=Z_STEPS, sq_sum=Z_STEPS,
                         row_abs_sum=comp, scale_sign_rows=comp)
    bad = [k for k, ok in (
        ("loss", all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("comm rounds", summ["comm_rounds"] == {"block": 0, "global": want_syncs}),
        ("launches", counts == want_launches),
        ("card vs cpu", cv_ok),
        ("decode", decode_ok),
        ("engine refusal", len(refused) == 2)) if not ok]
    if bad:
        raise AssertionError(f"phase {tag}: {', '.join(bad)} ({rec})")
    return counts


# phase X: the encoder-decoder and prefix-token families at their published
# widths.  (part, arch, sync, W, layers, seq, local batch): X1 whisper-small
# at its 12 encoder layers and 4 of its 12 decoder layers (all 12 took
# 51.7 s on an H100 80GB HBM3 at 700.00 W; cut with D1 after phase V's
# tree parts took the script to 991.8 s of its 930 s target), 1,500 frames (Whisper's 30-second window
# after the conv stride) under 448 decoder tokens (``train_batch_shapes``),
# EF-sign at W=4 (m_reckon at 12 + 12 layers: 1.11 GB a copy, 29 copies at
# the sync, 32.3 GB); X2 internvl2-76b, 256 prefix embeddings + 256 text tokens, mean
# sync at W=1 (W=2 reckons 7 copies at the sync, 84.7 GB at 1 layer), its
# depth the deepest whose reckoning stays under 72 GB (None: found by
# ``launch.dryrun.x_depth``; 2 layers, 15.5 GB a copy, 62.1 GB).
X_RUNS = (("X1", "whisper-small", "ef_sign", 4, 4, 1500, 8),
          ("X2", "internvl2-76b", "none", 1, None, 512, 8))
X_STEPS = 8                    # phase M's count
X_PROMPTS, X_NEW = 8, 32
X_PROMPT_LEN = {"X1": 16, "X2": 64}   # text tokens (after 1,500 frames / 256 prefix)
X_CPU_TEXT = {"X1": 448, "X2": 128}   # the card-vs-CPU batch's text tokens
X_DECODE_TOL = 2e-4            # decode vs the train-mode forward, x (1 + |logit|)


def phase_x(tag: str, arch: str, mode: str, workers: int, layers, seq: int,
            local_batch: int) -> dict:
    """Phase X: an encoder-decoder (whisper) or prefix-token (internvl2)
    family at its published width, depth ``layers`` (None: ``x_depth``),
    fed its stubbed modality (``family_inputs``: frames or patch
    embeddings, standard normal from the seed) beside markov-corpus text:
    post-local SGD at phase A's settings with ``mode`` sync at ``workers``
    workers of ``local_batch`` examples (``seq`` as ``train_batch_shapes``
    reads it) for X_STEPS steps: losses finite and falling, comm rounds
    equal to the schedule's, median step, tokens/s, peak memory against
    the reckoning (printed before the run), launches (the update and
    sq_sum every step, the compressor pair every EF-sign sync); kernels
    1-4 against their plain versions on the trained buckets
    (``m_check_kernels``); one step under torch.profiler split by part
    (the encoder, the cross-attention and the prefix projection by their
    spans); the worker-mean model on the card against the port on the CPU
    (one example: whisper 1,500 frames + 448 tokens, internvl2 256 prefix
    + 128 text; loss 1e-4 relative, logits 1e-4 x (1 + |logit|)); served
    through ``build_serve``: X_PROMPTS prompts (with their frames /
    prefix) prefilled in one batch, X_NEW greedy decode steps timed, every
    step's logits held against the train-mode forward over the same
    inputs within X_DECODE_TOL x (1 + |logit|); whisper refused by
    ``build_engine`` (ValueError: the engine feeds no frames), internvl2
    served text-only on the paged engine (phase M's requests), timed,
    then beside the contiguous path on the engine's own batches.  Returns
    the training's launch counts."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.launch.dryrun import m_reckon, x_depth
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.inputs import train_batch_shapes
    from repro_torch.launch.steps import build_engine, build_serve, build_train
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    published = configs.get(arch)
    if layers is None:
        layers = x_depth(published, workers, mode)
    cfg = published.replace(num_layers=layers)
    run = phase_run(mode, cfg, seq=seq, local_batch=local_batch, steps=X_STEPS,
                    workers=workers)
    shapes = train_batch_shapes(cfg, run.shape, workers)
    S_text = shapes["tokens"][0][-1]
    audio = cfg.family == "audio"
    S_x = seq if audio else cfg.num_prefix_tokens      # frames / prefix rows
    Np = 0 if audio else cfg.num_prefix_tokens
    want_syncs = sum(1 for _, lvl in sync_boundaries(run.local_sgd, X_STEPS)
                     if lvl == 2)
    reckon = m_reckon(cfg, workers, mode)
    emit({"phase": "X", "part": tag, "model": arch, "before": "training",
          "memory_reckoning": reckon,
          "batch_shapes": {k: list(v[0]) for k, v in shapes.items()}})
    rec = {"phase": "X", "part": tag, "model": arch, "W": workers,
           "local_batch": local_batch, "seq": seq, "text_tokens": S_text,
           ("frames" if audio else "prefix_tokens"): S_x,
           "sync_compression": mode, "base_lr": run.optim.base_lr,
           "grad_clip": run.optim.grad_clip,
           "post_local_switch": run.local_sgd.post_local_switch,
           "local_steps": run.local_sgd.local_steps,
           "reduced": {"num_layers": [published.num_layers, cfg.num_layers],
                       "encoder_layers": published.encoder_layers,
                       "W": workers, "steps": X_STEPS,
                       "local_batch": local_batch,
                       "widths": "published (unchanged)"},
           "memory_reckoning": reckon}

    # -- train: markov text, the modality stub beside it
    n = workers * local_batch * 4
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=n,
                                 seq_len=S_text, seed=0))
    data.update(family_inputs(cfg, n, S_x, seed=11))
    bundle = build_train(run, num_workers=workers, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    rec["mem_before_GB"] = torch.cuda.memory_allocated() / 1e9
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=X_STEPS,
                                          workers=workers, bundle=bundle,
                                          data=data)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    T = local_batch * S_text
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec.update(loss=losses, ln_vocab=math.log(cfg.vocab_size),
               comm_rounds=summ["comm_rounds"], comm_rounds_scheduled=want_syncs,
               step_s=step_s, step_s_median=statistics.median(step_s[1:]),
               tokens_per_s=workers * T * len(step_s[1:]) / sum(step_s[1:]),
               tokens_per_s_window="steps 1-%d: their text tokens over their "
                                   "summed seconds" % (len(step_s) - 1),
               peak_mem_GB=peak,
               peak_over_reckoned=peak * 1e9 / reckon["reckoned_peak_bytes"],
               launches=counts)
    REFS.setdefault("peak_GB", {})[tag] = peak
    split = {"train": time.perf_counter() - t_start}
    del data

    # -- kernels 1-4 on the trained buckets, then one profiled step
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec["mem_before_kernel_check_GB"] = torch.cuda.memory_allocated() / 1e9
    rec["kernels_vs_plain"] = m_check_kernels(state, run, bundle.layout)
    rec["peak_mem_kernel_check_GB"] = torch.cuda.max_memory_allocated() / 1e9
    split["kernels_vs_plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=workers * local_batch,
                               seq_len=S_text, seed=9))
    pb.update(family_inputs(cfg, workers * local_batch, S_x, seed=12))
    rec["profile"], state = m_profile_step(
        bundle, state, next(iter(ShardedBatches(pb, workers, local_batch))), cfg)
    split["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = mean_params(state)
    del state, bundle, pb
    gc.collect()
    torch.cuda.empty_cache()

    # -- the card against the port on the CPU: one example
    toks = torch.from_numpy(markov_lm(vocab=cfg.vocab_size, num_seqs=1,
                                      seq_len=X_CPU_TEXT[tag] + 1, seed=5)).long()
    extra = family_inputs(cfg, 1, S_x, seed=13)
    out = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else tree_map(lambda t: t.cpu(), params)
        with torch.no_grad():
            kw = model_kw(extra, dev)
            b = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev),
                 **{k: torch.from_numpy(v).to(dev) for k, v in extra.items()}}
            loss, _ = lm.loss_fn(cfg, p, b)
            lg = lm.logits_from_hidden(cfg, p, lm.forward(cfg, p, b["tokens"], **kw))
        out[dev] = (float(loss), lg.cpu())
        del p, lg
    (lg_, ag), (lc, ac) = out["cuda"], out["cpu"]
    loss_rel, logit_err = abs(lg_ - lc) / abs(lc), _close(ag, ac)
    cv_ok = loss_rel <= M_TOL and logit_err <= M_TOL
    rec["card_vs_cpu"] = {"batch": {"text": [1, X_CPU_TEXT[tag]],
                                    ("frames" if audio else "prefix"): [1, S_x]},
                          "loss_gpu": lg_, "loss_cpu": lc,
                          "loss_rel_diff": loss_rel, "loss_tol": M_TOL,
                          "logits_max_rel_err": logit_err, "logits_tol": M_TOL,
                          "ok": cv_ok}
    del out, ag, ac
    split["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- serve through the contiguous path: prefill with the modality,
    #    greedy decode; each step against the train-mode forward
    P = X_PROMPT_LEN[tag]
    serve = build_serve(cfg, device="cuda")
    prompt = torch.from_numpy(markov_lm(vocab=cfg.vocab_size, num_seqs=X_PROMPTS,
                                        seq_len=P, seed=3)[:, :P]).long().cuda()
    sx = {k: torch.from_numpy(v).cuda()
          for k, v in family_inputs(cfg, X_PROMPTS, S_x, seed=14).items()}
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache = serve.prefill(params, {"tokens": prompt, **sx})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t1)
        cache = lm.grow_cache(cfg, cache, Np + P + X_NEW)
        rows, tokens, dec_s = [lg[:, -1].cpu()], [], []
        nxt = lg[:, -1].argmax(-1)
        for i in range(X_NEW):
            tokens.append(nxt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, cache = serve.decode_step(params, {"tokens": nxt[:, None]}, cache,
                                          Np + P + 1 + i)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t1)
            rows.append(lg[:, -1].cpu())
            nxt = lg[:, -1].argmax(-1)
        del cache
        tokens = torch.stack(tokens, dim=1)
        rows = torch.stack(rows)
        full = lm.logits_from_hidden(cfg, params, lm.forward(
            cfg, params, torch.cat([prompt, tokens], dim=1), **model_kw(sx, "cuda")))
        want = full[:, Np + P - 1:].transpose(0, 1).cpu()
        del full
    decode_err = _close(rows, want)
    refused = []
    if audio:
        try:
            build_engine(cfg, InputShape("serve", M_MAX_LEN, M_SLOTS, "decode"),
                         params, device="cuda")
        except ValueError as e:
            refused.append(str(e)[:200])
    rec["serve"] = {
        "route": "launch.steps.build_serve (contiguous cache)",
        "prompts": X_PROMPTS, "prompt_text_len": P,
        ("frames" if audio else "prefix_tokens"): S_x, "new_tokens": X_NEW,
        "prefill_ms": prefill_ms,
        "decode_step_ms_median": 1e3 * statistics.median(dec_s),
        "decode_steps": len(dec_s),
        "decode_tokens_per_s": X_PROMPTS * len(dec_s) / sum(dec_s),
        "decode_vs_train_forward_max_rel_err": decode_err,
        "logit_rows_compared": rows.shape[0] * rows.shape[1],
        "decode_tol": X_DECODE_TOL, "build_engine_refused": refused}
    del serve, sx, prompt
    split["serve"] = time.perf_counter() - t0
    engine_ok = bool(refused)

    # -- internvl2 on the paged engine, text-only (as the reference's):
    #    timed, then shadowed by the contiguous path on its own batches
    if not audio:
        t0 = time.perf_counter()
        rec["engine"], engine_ok, _ = engine_check(cfg, params)
        rec["engine"]["inputs"] = "text only (no prefix), as the reference's engine"
        split["engine"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    rec["seconds_by_part"] = split
    emit(rec)
    comp = want_syncs if mode != "none" else 0
    want_launches = {k: 0 for k in fb.LAUNCHES}
    want_launches.update(fused_sgd_bucket=X_STEPS, sq_sum=X_STEPS,
                         row_abs_sum=comp, scale_sign_rows=comp)
    bad = [k for k, ok in (
        ("loss", all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("comm rounds", summ["comm_rounds"] == {"block": 0, "global": want_syncs}),
        ("launches", counts == want_launches),
        ("kernels vs plain", all(k["ok"] for k in rec["kernels_vs_plain"])),
        ("card vs cpu", cv_ok),
        ("decode", decode_err <= X_DECODE_TOL),
        ("engine", engine_ok)) if not ok]
    if bad:
        raise AssertionError(f"phase {tag}: {', '.join(bad)} ({rec})")
    return counts


# phase Y: workers across processes (DistributedBackend over gloo, all
# ranks on card 0; over NCCL one rank a card when the machine has two or
# more).  Each part: (tag, ranks, the phase it is held against)
Y_PARTS = (("Y1", 4, "W"), ("Y2", 4, "H"), ("Y3", 2, "L"), ("Y4", 4, "W"),
           ("Y5", 4, "H"))
Y_TIMEOUT_S = 300              # a collective that waits longer fails the rank
# losses against the one-process phase (relative), readings on an H100
# 80GB HBM3 at 700 W: Y1 adds what one process adds (0.0, each worker's
# kernel grid fixed by its rows; 2.2e-7 while it was sized by W).  Y2's
# dense means add the workers in worker order (Collectives.ordered_mean)
# as one process's mean(dim=0) does on the card: 0.0 (1.1e-7 while they
# were all-reduces, in gloo's ring order, its rows 59 % unequal).  Y3
# (LARS + EF-sign; its dense mean of +-scale values was an all-reduce)
# 6.1e-6 and 1.8e-6.  Y4, the tree kernel form, adds what phase W adds:
# 0.0.  Y5, the plain per-leaf form, against the resident phase H: phase
# F1's 1e-4
Y_LOSS_TOL = {"Y1": 0.0, "Y2": 0.0, "Y3": 1e-4, "Y4": 0.0, "Y5": 1e-4}
# the parts whose final params rows are held bit for bit against their
# phase's (SHA-256 of each worker's rows)
Y_ROWS_EQUAL = ("Y1", "Y2", "Y4")
# build keywords of the tree path's parts (DistributedBackend.build)
Y_BUILD = {"Y4": dict(resident=False), "Y5": dict(use_kernel=False)}
Y_PROBE_REPS = 3               # the ordered mean and the all-reduce, each
# the parts after which the ordered mean is probed against an all-reduce:
# one worker a rank (Y2) and two (Y3)
Y_PROBED = ("Y2", "Y3")


def y_run(tag: str, cfg, seq: int = 512, local_batch: int = 8):
    """Phase W's (Y1, Y4), H's (Y2, Y5) and L's (Y3) RunConfig."""
    ref = dict((t, ph) for t, _, ph in Y_PARTS)[tag]
    if ref == "W":
        return phase_run("ef_sign", cfg, seq=seq, local_batch=local_batch,
                         wire_pack=True)
    if ref == "H":
        return phase_run("none", cfg, seq=seq, local_batch=local_batch,
                         block_steps=2)
    return phase_run("ef_sign", cfg, seq=seq, local_batch=local_batch, lars=True)


def y_probe(bundle, x, reps: int = Y_PROBE_REPS) -> dict:
    """Fenced seconds, on every rank together, of the ordered mean of the
    rank's rows ``x`` and of a plain ``dist.all_reduce`` of their f32 sum
    (the ring's order; a probe here, not a path of the port)."""
    import torch
    import torch.distributed as dist

    def fenced(fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize(x.device) if x.is_cuda else None
            dist.barrier()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize(x.device) if x.is_cuda else None
            dist.barrier()
            ts.append(time.perf_counter() - t0)
            del y
        return ts

    def all_reduce():
        y = x.float().sum(dim=0)
        dist.all_reduce(y)
        return y
    om = fenced(lambda: bundle.dist.ordered_mean(x, scope="probe"))
    ar = fenced(all_reduce)
    return {"ordered_mean_s": om, "all_reduce_s": ar,
            "ordered_mean_s_median": statistics.median(om),
            "all_reduce_s_median": statistics.median(ar),
            "ratio": statistics.median(om) / statistics.median(ar),
            "bucket_bytes_a_rank": x.numel() * x.element_size()}


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def y_rank(r: int, port: int, P: int, tags: tuple, backend: str, out: str,
           spec: dict):
    """One rank of phase Y (``torch.multiprocessing.spawn``'s target):
    builds each part through ``DistributedBackend`` on this rank's device
    (card 0 under gloo with one card, card r under NCCL; ``spec["device"]``
    overrides it for a CPU rehearsal), trains it with ``train_run`` under a
    fenced tracer and writes what it measured to ``out/rank{r}.json``; rank
    0 also keeps Y1's first gathered payload (``out/y1_payload.pt``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.backend.distributed import DistributedBackend
    from repro_torch.core import compression as comp
    from repro_torch.core import flatbuf
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.telemetry.stats import round_summary
    from repro_torch.telemetry.trace import Tracer

    from repro_torch.core.local_sgd import is_resident

    cfg = paper_lm(spec)
    be = DistributedBackend(W, backend=backend, process_id=r, num_processes=P,
                            coordinator_address=f"localhost:{port}",
                            local_rank=r, device=spec.get("device"),
                            timeout_s=Y_TIMEOUT_S)
    results = {}
    try:
        for tag in tags:
            run = y_run(tag, cfg, spec.get("seq", 512), spec.get("local_batch", 8))
            bundle = be.build(run, **Y_BUILD.get(tag, {}))
            dev = bundle.device
            cuda = dev.type == "cuda"
            if cuda:
                torch.cuda.set_device(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            first, own = {}, {}
            pack = comp.pack_bucket_signs
            if tag == "Y1" and r == 0:
                gather = bundle.dist.gather_workers

                def capture(x, *, scope, stage=None):
                    # the first sync's payload and scales, as gathered
                    g = gather(x, scope=scope, stage=stage)
                    key = "packed" if g.dtype == torch.uint8 else "scales"
                    if scope == "global" and key not in first:
                        first[key] = g.cpu()
                    return g

                def capture_pack(x, seg, sizes, **kw):
                    # this rank's first bucket and its own pack, kept on
                    # the device until the run ends
                    out = pack(x, seg, sizes, **kw)
                    if not own:
                        own.update(x=x, scales=out[1])
                    return out
                bundle.dist.gather_workers = capture
                comp.pack_bucket_signs = capture_pack
            fb.reset_launches()
            tracer = Tracer(fence=True)
            try:
                state, hist, summ, step_s = train_run(
                    run, device=dev, steps=STEPS, bundle=bundle, tracer=tracer,
                    backend=be)
            finally:
                comp.pack_bucket_signs = pack
            counts = dict(fb.LAUNCHES)
            seg = fb.PORT_LAUNCHES["segment_sum"]
            syncs = {}
            for sp in tracer.spans:
                if sp.name == "sync":
                    syncs.setdefault(sp.attrs["scope"], []).append(sp.dur_s)
            # this rank's final params rows as a (W_local, rows, 128) bucket
            # (a tree state's leaves packed in the resident layout)
            rows = (state.params.buckets[0] if is_resident(state) else
                    flatbuf.flatten(flatbuf.build_layout(state.params,
                                                         leading=1),
                                    state.params, leading=1)[0])
            led = summ["ledger"]
            rec = {"rank": r, "device": str(dev), "backend": backend,
                   "workers": list(bundle.worker_ids),
                   "loss": [h["loss"] for h in hist],
                   "synced": [h["synced"] for h in hist],
                   "comm_rounds": summ["comm_rounds"],
                   "step_s_median": statistics.median(step_s[1:]),
                   "sync_s": syncs,
                   "ledger": {k: led[k] for k in ("sync_rounds", "wire_bytes",
                                                  "measured_bytes",
                                                  "cost_sources", "topologies")},
                   "collectives": bundle.dist.describe(),
                   "peak_mem_GB": (torch.cuda.max_memory_allocated(dev) / 1e9
                                   if cuda else None),
                   "launches": counts, "segment_sum_launches": seg,
                   "tree_state": not is_resident(state),
                   "row_sha": row_digests(rows)}
            if tag in Y_PROBED:
                rec["probe"] = y_probe(bundle, rows)
            del rows
            if bundle.telemetry:
                rec["round_summary"] = round_summary(state.stats,
                                                     dist=bundle.dist)
            if own:
                # this rank's own scales on the card against the same pack
                # of the same bucket on the CPU, its row sums in the
                # kernel's order (phase W's check)
                seg = flatbuf.const("row_segments", bundle.layout, 0, "cpu")
                sizes = flatbuf.const("segment_sizes", bundle.layout, 0, "cpu")
                cpu = cpu_pack(own["x"], seg, sizes)[1]
                rec["own_scales_max_rel_diff_cpu"] = float(
                    ((own["scales"].cpu() - cpu).abs()
                     / cpu.abs().clamp_min(1e-30)).max())
                own.clear()
            if first:
                torch.save(first, f"{out}/y1_payload.pt")
            results[tag] = rec
            del state, bundle
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        if "Y1" in tags:
            # phase U's U4 on these ranks: one sync of each of the
            # reference's five sync-probe rows, under the profiler
            from repro_torch.roofline.sync_probe import probe_rows
            t0 = time.perf_counter()
            results["U4"] = {"rows": probe_rows(
                be, cfg, local_batch=spec.get("local_batch", 8),
                seq=spec.get("seq", 512)), "s": time.perf_counter() - t0}
    finally:
        with open(f"{out}/rank{r}.json", "w") as f:
            json.dump(results, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def y_spawn(P: int, tags: tuple, backend: str, out: Path, spec: dict) -> list:
    """Spawn P ranks of ``y_rank``; returns each rank's results.  A rank
    that raises ends the spawn (the others are stopped) and fails the
    phase."""
    import torch.multiprocessing as mp
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    mp.spawn(y_rank, args=(free_port(), P, tags, backend, str(out), spec),
             nprocs=P)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(P)]


def y_check(tag: str, P: int, ranks: list, ref: dict, layout, *,
            payload=None) -> list:
    """Phase Y's checks of one part against its one-process phase; returns
    the failures."""
    recs = [rk[tag] for rk in ranks]
    r0 = recs[0]
    rows = layout.bucket_rows[0]
    bucket = rows * 128 * 4
    packed = rows * 16 + 4 * len(layout.bucket_slots(0))
    rounds = r0["comm_rounds"]["global"] + r0["comm_rounds"]["block"]
    wl = W // P
    want_launch = {k: 0 for k in r0["launches"]}
    if tag == "Y3":
        want_launch.update(lars_row_norms=STEPS, fused_lars_bucket=STEPS,
                           row_abs_sum=6, scale_sign_rows=6)
    elif tag != "Y5":           # the plain per-leaf form launches nothing
        want_launch.update(fused_sgd_bucket=STEPS, sq_sum=STEPS)
    if tag in ("Y1", "Y4"):
        # kernel 3 twice a sync: the compressor's row sums, then the pack's
        want_launch.update(row_abs_sum=12, scale_sign_rows=6)
    wire = tag in ("Y1", "Y4")
    # the dense means: an ordered mean over the P ranks (global) or over a
    # block's two (Alg. 5, one worker a rank), to which every rank hands
    # one f32 bucket, its running total
    measured = (r0["comm_rounds"]["global"] * (W * packed if wire else P * bucket)
                + r0["comm_rounds"]["block"] * P * bucket)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
    tot = r0["collectives"]["totals"]
    handed = sum(v["bytes"] for k, v in tot.items()
                 if k.endswith("/global") or k.endswith("/block"))
    bad = [k for k, ok in (
        ("ranks disagree", all(rc["loss"] == r0["loss"]
                               and rc["comm_rounds"] == r0["comm_rounds"]
                               and rc["ledger"] == r0["ledger"] for rc in recs)),
        ("workers", [rc["workers"] for rc in recs]
         == [list(range(p * wl, (p + 1) * wl)) for p in range(P)]),
        ("loss", loss_rel <= Y_LOSS_TOL[tag]),
        ("comm rounds", r0["comm_rounds"] == ref["comm_rounds"]),
        ("measured bytes", r0["ledger"]["cost_sources"] == ["measured"]
         and r0["ledger"]["measured_bytes"] == measured
         and handed * P == r0["ledger"]["measured_bytes"]),
        ("tree state", all(rc["tree_state"] == (tag in Y_BUILD)
                           for rc in recs)),
        ("rows", tag not in Y_ROWS_EQUAL
         or sum((rc["row_sha"] for rc in recs), []) == ref["row_sha"]),
        ("launches", all(rc["launches"] == want_launch for rc in recs))) if not ok]
    out = {"loss_max_rel_diff": loss_rel, "loss_tol": Y_LOSS_TOL[tag],
           "rows_bit_for_bit": (sum((rc["row_sha"] for rc in recs), [])
                                == ref["row_sha"] if tag in Y_ROWS_EQUAL
                                else None),
           "measured_bytes_per_round": r0["ledger"]["measured_bytes"] / rounds,
           # what the ranks' point-to-point sends carried (the ordered
           # mean's chain): all ranks together, a round
           "sent_bytes_per_round_all_ranks": sum(
               sum(rc["collectives"]["sent"].get(f"ordered_mean/{s}", 0)
                   for s in ("global", "block")) for rc in recs) / rounds,
           "ring_bytes_per_round_per_rank": r0["ledger"]["wire_bytes"] / rounds}
    if tag == "Y1" and payload is not None:
        # the signs do not depend on the scale: byte for byte.  The scales,
        # rank 0's own against the CPU's pack of its bucket and all W
        # workers' against phase W's, bit for bit: every total adds in
        # index order on the card (TOL["scatter_add"] and 2e-5 while the
        # sums were atomic; 0.0 since, H100 80GB HBM3, 700 W)
        ok = torch_equal(payload["packed"], ref["packed"])
        rel = float(((payload["scales"] - ref["scales"]).abs()
                     / ref["scales"].abs().clamp_min(1e-30)).max())
        own = r0["own_scales_max_rel_diff_cpu"]
        out.update(payload_equal_phase_W=ok, scales_max_rel_diff=rel,
                   scales_tol=0.0,
                   own_scales_max_rel_diff_cpu=own, own_scales_tol=0.0,
                   payload_shape=list(payload["packed"].shape))
        if not ok or rel > 0.0 or own > 0.0:
            bad.append("payload")
    if tag == "Y3":
        got, want = r0["round_summary"], ref["round_summary"]
        rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
        errs = {k: rel(got[k], v) for k, v in want.items() if isinstance(v, float)}
        errs["comp_rel_err"] = max(rel(a, b) for a, b in
                                   zip(got["comp_rel_err"], want["comp_rel_err"]))
        # phase C's tolerances for LARS + EF-sign (its flips move the
        # fields read from ||mean_k x_k||^2 by about an element's share)
        tols = {k: 1e-2 if k in SYNC_MEAN_KEYS else 1e-4 for k in errs}
        out.update(round_summary_rel_diff=errs, round_summary_tol=tols)
        if [k for k in errs if errs[k] > tols[k]] or \
                got["rounds"] != want["rounds"] or \
                got["num_workers"] != want["num_workers"]:
            bad.append("round_summary")
    out["bad"] = bad
    return out


def row_digests(x) -> list:
    """The SHA-256 of each worker's rows of a stacked ``(W, rows, 128)``
    bucket (its bytes, copied to the host one worker at a time): a bit
    for bit comparison of rows held in other processes."""
    import hashlib
    return [hashlib.sha256(x[w].contiguous().cpu().numpy().tobytes())
            .hexdigest() for w in range(x.shape[0])]


def torch_equal(a, b) -> bool:
    import torch
    return bool(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))


def paper_lm(spec: dict):
    """The rank's model: paper-lm (its smoke config with ``spec["smoke"]``)
    cut to ``spec["layers"]`` layers where that is set (phases V and Q)."""
    from repro_torch import configs
    cfg = (configs.get_smoke if spec.get("smoke") else configs.get)("paper-lm")
    return cut_depth(cfg, spec.get("layers"))


def cut_depth(cfg, layers):
    """``cfg`` at ``layers`` layers, or as it is when that is None or not
    fewer than its own."""
    if layers is None or layers >= cfg.num_layers:
        return cfg
    return cfg.replace(num_layers=layers)


def phase_y(cfg, spec: dict | None = None) -> dict:
    """Phase Y: workers across processes at full width (see the module
    docstring); returns the summed launch counts of every rank."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.models import base as mbase
    from repro_torch.models import lm

    spec = dict(spec or {})
    specs = lm.param_specs(cfg)
    layout = flatbuf.build_layout(
        mbase.abstract(specs, flatbuf.torch_dtype(cfg.param_dtype)),
        wd_mask=mbase.norm_param_mask(specs))
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    launches: dict = {}
    parts = {}
    base = ROOT / "build" / "phase_y"
    for P, tags in ((4, ("Y1", "Y2", "Y4", "Y5")), (2, ("Y3",))):
        t0 = time.perf_counter()
        out = base / f"gloo{P}"
        ranks = y_spawn(P, tags, "gloo", out, spec)
        spawn_s = time.perf_counter() - t0
        payload = (torch.load(out / "y1_payload.pt") if "Y1" in tags else None)
        if "Y1" in tags:
            REFS["U4"] = [rk["U4"] for rk in ranks]
        for tag in tags:
            ref = REFS[dict((t, ph) for t, _, ph in Y_PARTS)[tag]]
            chk = y_check(tag, P, ranks, ref, layout, payload=payload)
            r0 = ranks[0][tag]
            rec = {"phase": "Y", "part": tag, "model": cfg.name, "W": W,
                   "ranks": P, "workers_per_rank": W // P, "backend": "gloo",
                   "build": Y_BUILD.get(tag, {}),
                   "devices": [rk[tag]["device"] for rk in ranks],
                   "loss": r0["loss"], "reference_loss": ref["loss"],
                   "comm_rounds": r0["comm_rounds"],
                   "sync_s_fenced": {s: statistics.median(v)
                                     for s, v in r0["sync_s"].items()},
                   "sync_s_fenced_max_rank": {
                       s: max(statistics.median(rk[tag]["sync_s"][s])
                              for rk in ranks) for s in r0["sync_s"]},
                   "step_s_median": [rk[tag]["step_s_median"] for rk in ranks],
                   "peak_mem_GB": [rk[tag]["peak_mem_GB"] for rk in ranks],
                   "ledger_measured_bytes": r0["ledger"]["measured_bytes"],
                   "ledger_ring_bytes_per_rank": r0["ledger"]["wire_bytes"],
                   "collectives": r0["collectives"]["totals"],
                   # the ordered mean's chain crosses the port's own host
                   # buffers (gloo's send / recv take host tensors); the
                   # other ops hand gloo CUDA tensors, which it copies
                   # through host memory itself
                   "staged_through_host": {
                       "by_the_port": sorted(
                           {k.split("/")[0] for k in r0["collectives"]["sent"]}),
                       "by_gloo": sorted(
                           {k.split("/")[0] for k in r0["collectives"]["totals"]}
                           - {k.split("/")[0] for k in r0["collectives"]["sent"]})},
                   "spawn_s": spawn_s, **chk}
            if tag == "Y1":
                rec["phase_W_sync_s_median"] = REFS["W"].get("sync_s_median")
            if tag in Y_PROBED:
                rec["probe_every_rank"] = [rk[tag]["probe"] for rk in ranks]
            parts[tag] = rec
            emit(rec)
            for rk in ranks:
                for k, v in rk[tag]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
                launches["segment_sum"] = (launches.get("segment_sum", 0)
                                           + rk[tag]["segment_sum_launches"])
    bad = [f"{t}: {', '.join(r['bad'])}" for t, r in parts.items() if r["bad"]]
    # the dense all-reduce (Y2's global syncs) against the packed all-gather
    # (Y1's), both over four ranks
    y1 = parts["Y1"]["sync_s_fenced"]["global"]
    y2 = parts["Y2"]["sync_s_fenced"]["global"]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    nccl = {"phase": "Y", "part": "Y1-nccl"}
    if spec.get("device") == "cpu" or count < 2:
        nccl["ran"] = False
        nccl["why"] = (f"{count} card(s): NCCL takes one rank a card, and "
                       f"W=4 workers need 2 or 4 ranks")
    else:
        P = 4 if count >= 4 else 2
        ranks = y_spawn(P, ("Y1",), "nccl", base / f"nccl{P}", spec)
        chk = y_check("Y1", P, ranks, REFS["W"], layout)
        r0 = ranks[0]["Y1"]
        nccl.update(ran=True, ranks=P, loss=r0["loss"],
                    sync_s_fenced=statistics.median(r0["sync_s"]["global"]),
                    devices=[rk["Y1"]["device"] for rk in ranks], **chk)
        for rk in ranks:
            for k, v in rk["Y1"]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if chk["bad"]:
            bad.append(f"Y1-nccl: {', '.join(chk['bad'])}")
    emit(nccl)
    emit({"phase": "Y", "summary": True,
          "packed_sync_s_Y1": y1, "dense_sync_s_Y2": y2,
          "dense_over_packed": y2 / y1,
          "ordered_mean_vs_all_reduce": {
              f"{t} ({W // dict((a, b) for a, b, _ in Y_PARTS)[t]} workers a "
              f"rank)": {k: parts[t]["probe_every_rank"][0][k] for k in
                         ("ordered_mean_s_median", "all_reduce_s_median",
                          "ratio")} for t in Y_PROBED}})
    if bad:
        raise AssertionError(f"phase Y: {'; '.join(bad)}")
    return launches


# phase V: within-worker sharded sub-buckets across processes
# (DistributedBackend(within_worker_size=2) over gloo, the four ranks on
# card 0: 2 workers x 2 shards, rank = group * 2 + shard).  Each part:
# (tag, layout, sync compression, LARS, wire pack + coalesce)
V_PARTS = (("V1", "fsdp", "none", False, False),
           ("V2", "tp", "ef_sign", False, True),
           ("V3", "fsdp", "ef_sign", True, False),
           ("V4", "tp", "ef_sign", False, True),
           ("V5", "fsdp", "ef_sign", True, False),
           ("V6", "fsdp", "sign", True, False))
# the tree path (DistributedBackend keywords): V4 its kernel form under
# tensor parallel at V2's settings, V5 its plain form and V6 its kernel
# form under FSDP at V3's (V6 with the sign compressor); each rank holds
# its shard's slice of every sharded leaf
V_BUILD = {"V4": dict(resident=False), "V5": dict(use_kernel=False),
           "V6": dict(resident=False)}
# the FSDP tree parts whose every sync is also replayed on the ranks from
# the one-process run's own pre-sync state
V_PINNED = ("V5", "V6")
V_W, V_S = 2, 2
# paper-lm's depth in phase V (and Q_LAYERS in phase Q): each part is held
# against its own one-process run at the same depth, so one of the 12 layers
# checks the same sharding, syncs and sums in less of the script's time
# limit (12 layers: phase V 75-105 s, phase Q 189-195 s on an H100; 4
# layers: V 42-58 s; cut to 2 when the long shapes' phase J took the
# script to 1,049.8 s of its 930 s target; to 1, the embedding and one
# layer's leaves, when the tree parts V4-V6 took it to 991.8 s and, with D1
# and X1 cut, 1,065.7 s: V 73.9 / 97.7 s, Q 90.1 / 100.7 s at 2 layers;
# H100 80GB HBM3, 700.00 W)
V_LAYERS = 1
# losses against the one-process run (relative); V2 0.0 (see V_FRAC_TOL)
V_LOSS_TOL = {"V1": 1e-4, "V2": 0.0, "V3": 1e-4, "V4": 0.0, "V5": 1e-4,
              "V6": 1e-4}
# params rows against the one-process run: the share of elements beyond
# 1e-4 x the largest.  V1 has no compressor: every element, momentum too,
# within 1e-4 of the largest.  V2 (tensor parallel: every shard rank
# differentiates the whole batch) adds what one process adds: 0, its
# losses equal too.  V3 (FSDP, LARS): a shard rank differentiates half a
# batch, so a delta within rounding of 0 takes the other sign, moves its
# element by a whole scale, and the next steps carry it: 3.45e-3.
# Readings on an H100 80GB HBM3 at 700 W: V2 0.0 and losses 0.0 with
# each worker's kernel grid fixed by its rows (1.99e-4 while it was sized
# by W, 2e-3 / 2e-2 while the scatter-adds were atomic)
V_FRAC_TOL = {"V1": 0.0, "V2": 0.0, "V3": 7e-3, "V4": 0.0, "V5": 7e-3,
              "V6": 7e-3}


def v_fields(tag: str) -> tuple:
    """The state fields whose rows part ``tag`` holds against the one
    process's: params (after the last sync every worker holds the
    anchor), and momentum where no compressor flips a sign (V1) or every
    sum adds what one process adds (V4)."""
    return ("params", "momentum") if tag in ("V1", "V4") else ("params",)


def v_rows(state, f: str) -> list:
    """Field ``f`` of a state on the host, f32: its buckets, or a tree
    state's leaves."""
    from repro_torch.core import flatbuf
    from repro_torch.utils import tree_leaves
    x = getattr(state, f)
    return [b.float().cpu() for b in (
        x.buckets if flatbuf.is_bucket_state(x) else tree_leaves(x))]


def v_layout(kind: str):
    """Tensor parallel over "model", or FSDP over it; sizes unset (the
    backend gives them)."""
    from repro_torch.sharding import layout as sl
    if kind == "tp":
        return sl.train_layout(("data", "model"), worker_axes=("data",))
    return sl.fsdp_within_worker_layout(("data", "model"),
                                        worker_axes=("data",),
                                        shard_axes=("model",))


def v_part(tag: str):
    return next(p for p in V_PARTS if p[0] == tag)


def v_run(tag: str, cfg, seq: int = 512, local_batch: int = 8):
    """Part ``tag``'s RunConfig: phase A's (V1), phase W's with
    ``sync_coalesce`` (V2, V4) or phase L's (V3, V5; V6 with sign) settings
    at W=2."""
    _, _, mode, lars, wire = v_part(tag)
    return phase_run(mode, cfg, seq=seq, local_batch=local_batch, lars=lars,
                     workers=V_W, wire_pack=wire, coalesce=wire)


def v_reckon(layout, run, wl: int, split: bool, tree: dict | None = None) -> dict:
    """Bytes a rank holds by the layout: state (params, momentum and EF
    memory of its workers, the anchor, all on its shard's rows) and the
    whole-row buffers of a local step (the gathered params, the sharded
    leaves' copies the model reads, the gradient; FSDP also its
    reduce-scatter's input and output).  The tree path (``tree``: its
    ``V_BUILD`` keywords) also makes a new params and momentum a step, and
    its kernel form packs params, gradient and momentum into buckets."""
    ls = run.local_sgd
    held = sum(layout.bucket_local_rows(b) for b in range(layout.num_buckets))
    sharded = sum(layout.bucket_rows[b] for b in range(layout.num_buckets)
                  if layout.bucket_shard_count(b) > 1)
    whole = sum(layout.bucket_rows)
    row = 128 * 4
    state = (2 + (ls.sync_compression == "ef_sign")) * wl * held * row + \
        (ls.sync_compression != "none") * held * row
    bufs = (2 * wl * sharded + wl * whole + split * wl * (sharded + held)) * row
    if tree is not None:
        bufs += (2 + 3 * tree.get("use_kernel", True)) * wl * held * row
    return {"state_GB": state / 1e9, "whole_row_buffers_GB": bufs / 1e9,
            "total_GB": (state + bufs) / 1e9}


def v_pin(bundle, base: Path, tag: str, post: list):
    """Part ``tag``'s one-process syncs pinned: before each, its params,
    anchor and EF memory leaves (whole) saved to ``base/{tag}_pin{i}.pt``;
    after it, its anchor and EF memory leaves kept on the host in
    ``post``."""
    import torch
    from repro_torch.utils import tree_leaves
    sync = bundle.sync

    def pinned(state, *, plan=None, scope="global"):
        torch.save({f: [x.cpu() for x in tree_leaves(getattr(state, f))]
                    for f in ("params", "anchor", "ef_memory")
                    if getattr(state, f) is not None},
                   base / f"{tag}_pin{len(post)}.pt")
        state = sync(state, plan=plan, scope=scope)
        post.append({f: [x.cpu() for x in tree_leaves(getattr(state, f))]
                     for f in ("anchor", "ef_memory")
                     if getattr(state, f) is not None})
        return state
    bundle.sync = pinned


def v_replay(bundle, state, base: Path, tag: str, r: int, dev) -> int:
    """Every pinned sync of part ``tag`` on this rank: its part of the one
    process's pre-sync state through the rank's sync; its anchor and EF
    memory after it saved to ``base/{tag}_r{r}_pin{i}.pt``.  Returns the
    number of syncs replayed."""
    import torch
    from repro_torch.core.local_sgd import LocalSGDState, local_state
    from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten
    treedef = tree_flatten(state.params)[1]
    i = 0
    while (base / f"{tag}_pin{i}.pt").exists():
        pre = torch.load(base / f"{tag}_pin{i}.pt")
        full = LocalSGDState(
            momentum=None, global_u=None, step=state.step, rng=None,
            stats=None,
            **{f: (tree_unflatten(treedef, pre[f]) if f in pre else None)
               for f in ("params", "anchor", "ef_memory")})
        st = local_state(full, bundle.dist, dev,
                         shard_classes=bundle.shard_classes)
        del full, pre
        st.stats = state.stats
        st = bundle.sync(st, plan=bundle.sync_plan, scope="global")
        torch.save({f: [x.cpu() for x in tree_leaves(getattr(st, f))]
                    for f in ("anchor", "ef_memory")
                    if getattr(st, f) is not None},
                   base / f"{tag}_r{r}_pin{i}.pt")
        del st
        i += 1
    return i


def v_one_process(tag: str, cfg, spec: dict, base: Path) -> dict:
    """Part ``tag`` in one process (``build_train(layout=)``, both workers
    and both shard regions on the device; a tree part's leaves whole): the
    reference of the ranks' run.  Keeps its losses, final buckets or
    leaves (on the host), the first sync's packed payload of shard 0's
    rows (V2), for V1 the same settings on the replicated layout, and for
    the pinned tree parts (``V_PINNED``) every sync's state before it (in
    ``base``) and after it."""
    import torch
    from repro_torch.core import compression as comp
    from repro_torch.launch.steps import build_train
    from repro_torch.telemetry.stats import round_summary
    from repro_torch.telemetry.trace import Tracer

    dev = spec.get("device", "cuda")
    cuda = torch.device(dev).type == "cuda"
    _, kind, _, lars, wire = v_part(tag)
    run = v_run(tag, cfg, spec.get("seq", 512), spec.get("local_batch", 8))
    lay = v_layout(kind).with_sizes({"data": V_W, "model": V_S})
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bundle = build_train(run, num_workers=V_W, device=dev, layout=lay,
                         **V_BUILD.get(tag, {}))
    post: list = []
    if tag in V_PINNED:
        v_pin(bundle, base, tag, post)
    first, pack = {}, comp.pack_bucket

    def capture(layout, b, x, *, across=None):
        out = pack(layout, b, x, across=across)
        if b not in first:            # shard 0's region rows of the pack
            first[b] = out[0][..., :layout.bucket_local_rows(b), :].cpu()
        return out
    comp.pack_bucket = capture
    tracer = Tracer(fence=True)
    try:
        state, hist, summ, step_s = train_run(run, device=dev, steps=STEPS,
                                              workers=V_W, bundle=bundle,
                                              tracer=tracer)
    finally:
        comp.pack_bucket = pack
    layout = bundle.layout if tag in V_BUILD else state.params.layout
    rec = {"loss": [h["loss"] for h in hist], "comm_rounds": summ["comm_rounds"],
           "layout": layout, "pinned_post": post,
           "rows": {f: v_rows(state, f) for f in v_fields(tag)},
           "step_s_median": statistics.median(step_s[1:]),
           "sync_s_median": statistics.median(
               sp.dur_s for sp in tracer.spans if sp.name == "sync"),
           "peak_mem_GB": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None),
           "ledger_wire_bytes": summ["ledger"]["wire_bytes"],
           "round_summary": (round_summary(state.stats) if bundle.telemetry
                             else None)}
    if wire and tag not in V_BUILD:
        rec["payload"] = torch.cat([first[b] for b in sorted(first)], dim=1)
    del state, bundle
    gc.collect()
    if tag == "V1":
        # the same settings on the replicated layout (one bucket)
        state, hist, _, _ = train_run(run, device=dev, steps=STEPS, workers=V_W)
        rec["replicated_loss"] = [h["loss"] for h in hist]
        del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def v_rank(r: int, port: int, tags: tuple, out: str, spec: dict):
    """One rank of phase V (``torch.multiprocessing.spawn``'s target): each
    part through its own ``DistributedBackend(within_worker_size=2)`` on
    card 0 (``spec["device"]`` overrides it for a CPU rehearsal), trained
    by ``train_run`` under a fenced tracer, the shard group's gathers and
    reductions fenced and timed apart; writes what it measured to
    ``out/rank{r}.json`` and its final buckets to ``out/{tag}_r{r}.pt``;
    rank 0 also holds kernels 1-6 against their plain versions on its
    shard-local trained buckets and keeps V2's first gathered payload.  A
    tree part (``V_BUILD``) builds the tree path; rank 0 checks the kernels
    on its slices packed into its shard's region rows (the kernel form's
    buckets), and the pinned parts replay the one process's syncs."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.backend.distributed import DistributedBackend
    from types import SimpleNamespace

    from repro_torch.core import flatbuf
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.telemetry.stats import round_summary
    from repro_torch.telemetry.trace import Tracer
    from repro_torch.utils import tree_leaves

    cfg = paper_lm(spec)
    results = {}
    try:
        for tag in tags:
            _, kind, _, lars, wire = v_part(tag)
            be = DistributedBackend(V_W, backend="gloo", process_id=r,
                                    num_processes=V_W * V_S,
                                    coordinator_address=f"localhost:{port}",
                                    local_rank=r, device=spec.get("device"),
                                    timeout_s=Y_TIMEOUT_S,
                                    within_worker_size=V_S,
                                    layout=v_layout(kind),
                                    **V_BUILD.get(tag, {}))
            run = v_run(tag, cfg, spec.get("seq", 512), spec.get("local_batch", 8))
            bundle = be.build(run)
            dev = bundle.device
            cuda = dev.type == "cuda"
            if cuda:
                torch.cuda.set_device(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            d = bundle.dist
            within: dict = {}

            def fenced(name, fn):
                # the local step's shard-group collectives, fenced
                def f(*a, **k):
                    if k.get("scope", "within") != "within":
                        return fn(*a, **k)
                    if cuda:
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    y = fn(*a, **k)
                    if cuda:
                        torch.cuda.synchronize(dev)
                    within.setdefault(name, []).append(time.perf_counter() - t0)
                    return y
                return f
            d.gather_shards = fenced("gather", d.gather_shards)
            d.reduce_scatter_shards = fenced("reduce_scatter",
                                             d.reduce_scatter_shards)
            d.all_reduce_shards = fenced("all_reduce", d.all_reduce_shards)
            first = {}
            if wire and r == 0 and tag not in V_BUILD:
                gather = d.gather_workers

                def capture(x, *, scope, stage=None):
                    g = gather(x, scope=scope, stage=stage)
                    if scope == "global" and g.dtype == torch.uint8 \
                            and "packed" not in first:
                        first["packed"] = g.cpu()
                    return g
                d.gather_workers = capture
            fb.reset_launches()
            tracer = Tracer(fence=True)
            state, hist, summ, step_s = train_run(
                run, device=dev, steps=STEPS, workers=V_W, bundle=bundle,
                tracer=tracer, backend=be)
            counts = dict(fb.LAUNCHES)
            seg_launches = fb.PORT_LAUNCHES["segment_sum"]
            syncs = [sp.dur_s for sp in tracer.spans if sp.name == "sync"]
            led = summ["ledger"]
            tree = tag in V_BUILD
            layout = bundle.layout if tree else state.params.layout
            rec = {"rank": r, "device": str(dev), "group": d.layout.group,
                   "shard": d.layout.shard, "workers": list(bundle.worker_ids),
                   "loss": [h["loss"] for h in hist],
                   "comm_rounds": summ["comm_rounds"],
                   "step_s_median": statistics.median(step_s[1:]),
                   "sync_s_median": statistics.median(syncs),
                   "within_s_per_step": {k: sum(v) / STEPS
                                         for k, v in within.items()},
                   "within_calls": {k: len(v) for k, v in within.items()},
                   "ledger": {k: led[k] for k in ("sync_rounds", "wire_bytes",
                                                  "measured_bytes",
                                                  "cost_sources", "topologies")},
                   "collectives": d.describe()["totals"],
                   "held_rows": ([list(x.shape) for x in tree_leaves(state.params)]
                                 if tree else
                                 [int(b.shape[-2]) for b in state.params.buckets]),
                   "peak_mem_GB": (torch.cuda.max_memory_allocated(dev) / 1e9
                                   if cuda else None),
                   "reckoned": v_reckon(layout, run, d.layout.w_local,
                                        be.mesh_layout(V_W * V_S).batch_split() > 1,
                                        V_BUILD.get(tag)),
                   "launches": counts, "segment_sum_launches": seg_launches}
            if bundle.telemetry:
                rec["round_summary"] = round_summary(state.stats, dist=d)
            # the rows held against the one process's: params (after the
            # last sync the anchor's copy), and V1's momentum
            torch.save({f: v_rows(state, f) for f in v_fields(tag)},
                       f"{out}/{tag}_r{r}.pt")
            if state.anchor is not None:
                pa = ((tree_leaves(state.params), tree_leaves(state.anchor))
                      if tree else (state.params.buckets, state.anchor.buckets))
                rec["params_equal_anchor"] = all(
                    torch.equal(p[w], a) for p, a in zip(*pa)
                    for w in range(p.shape[0]))
            if first:
                torch.save(first, f"{out}/{tag}_payload.pt")
            if r == 0 and cuda and V_BUILD.get(tag, {}).get("use_kernel", True):
                # launches of these checks are not counted: read above.  A
                # tree part's slices in its region rows: the kernel form's
                # buckets on this rank
                checked = state
                if tree:
                    bs = lambda t: SimpleNamespace(buckets=flatbuf.flatten(
                        layout, t, leading=1, region=True))
                    checked = SimpleNamespace(params=bs(state.params),
                                              momentum=bs(state.momentum))
                rec["kernels_vs_plain"] = m_check_kernels(checked, run, layout,
                                                          lars=True)
                del checked
            if tag in V_PINNED:
                t0 = time.perf_counter()
                rec["pinned_syncs"] = v_replay(bundle, state, Path(out), tag,
                                               r, dev)
                rec["pinned_replay_s"] = time.perf_counter() - t0
            results[tag] = rec
            del state, bundle
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        with open(f"{out}/rank{r}.json", "w") as f:
            json.dump(results, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def v_check(tag: str, ranks: list, ref: dict, out: Path, run) -> dict:
    """Phase V's checks of one part against its one-process run."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.models import lm
    recs = [rk[tag] for rk in ranks]
    r0 = recs[0]
    layout = ref["layout"]
    P = V_W * V_S
    wl = V_W // (P // V_S)
    _, kind, mode, lars, wire = v_part(tag)
    nb = layout.num_buckets
    held = [layout.bucket_local_rows(b) for b in range(nb)]
    nseg = sum(len(layout.bucket_slots(b)) for b in range(nb))
    rounds = r0["comm_rounds"]["global"]
    syncs = rounds
    # launches a rank: every kernel on both sub-buckets; the compressor
    # pair a sync a bucket, the wire pack's row sums once more
    want = {k: 0 for k in r0["launches"]}
    upd = ("lars_row_norms", "fused_lars_bucket") if lars else \
        ("sq_sum", "fused_sgd_bucket")
    want.update({k: STEPS * nb for k in upd})
    if mode != "none":
        want.update(row_abs_sum=syncs * nb * (2 if wire else 1),
                    scale_sign_rows=syncs * nb)
    per_rank = (wl * sum(held) * 16 + wl * nseg * 4 if wire
                else sum(held) * 128 * 4)
    tree = tag in V_BUILD
    seg_want = None
    sharded = [sl for sl in layout.slots
               if layout.bucket_shard_count(sl.bucket) > 1]
    if tree:
        # the tree path: its kernel form launches kernels 1-2 or 5-6 on
        # both sub-buckets a step (LARS also a segment_sum a bucket), and
        # the compressor's kernels on the replicated leaves' bucket of each
        # dtype (cb; the sharded leaves take the per-leaf compressor): a
        # row_abs_sum, a chained segment_sum and a scale_sign_rows a sync,
        # the wire pack's row sums and segment_sum once more; the plain
        # form none
        kern = V_BUILD[tag].get("use_kernel", True)
        cb = len({layout.bucket_dtypes[b] for b in range(nb)
                  if layout.bucket_shard_count(b) == 1})
        want = {k: 0 for k in r0["launches"]}
        seg_want = 0
        if kern:
            want.update({k: STEPS * nb for k in upd})
            seg_want = STEPS * nb if lars else 0
            if mode != "none":
                want.update(row_abs_sum=syncs * cb * (2 if wire else 1),
                            scale_sign_rows=syncs * cb)
                seg_want += syncs * cb * (2 if wire else 1)
        cls = flatbuf.shard_classes(lm.param_specs(run.model), v_layout(
            kind).with_sizes({"data": V_W, "model": V_S}))
        leaf = [flatbuf.LeafShards.of(cls, s) for s in range(V_S)]
        local = [[wl] + [d // dict(sl.shard_dims).get(j, 1)
                         for j, d in enumerate(sl.shape)]
                 for sl in layout.slots]

    def part(f, b, y, g, s):
        """Rank (g, s)'s part of the one-process bucket (or tree leaf) b
        of field f: its workers' rows, its shard's region (or slice)."""
        if f != "anchor":
            y = y[g * wl:(g + 1) * wl]
        if tree:
            return leaf[s].take(b, y, 0 if f == "anchor" else 1)
        if layout.bucket_shard_count(b) > 1:
            y = y[..., s * held[b]:(s + 1) * held[b], :]
        return y
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
    # each rank's rows against the one-process buckets' matching rows
    rows_rel, frac = {}, {}
    for rk in recs:
        got = torch.load(out / f"{tag}_r{rk['rank']}.pt")
        g, s = rk["group"], rk["shard"]
        for f, bufs in got.items():
            for b, x in enumerate(bufs):
                y = part(f, b, ref["rows"][f][b], g, s)
                scale = float(y.abs().max()) or 1e-30
                dd = (x - y).abs()
                key = f"{f}.{b}"
                rows_rel[key] = max(rows_rel.get(key, 0.0),
                                    float(dd.max()) / scale)
                frac[key] = max(frac.get(key, 0.0),
                                float((dd > 1e-4 * scale).float().mean()))
        del got
    held_frac = max(frac.values())
    # a worker's replicated sub-bucket on its two shard ranks
    rep_equal = True
    for g in range(P // V_S):
        a, c = (torch.load(out / f"{tag}_r{g * V_S + s}.pt")["params"]
                for s in range(V_S))
        rep_equal &= all(torch.equal(a[b], c[b]) for b in range(len(a))
                         if (not leaf[0].sharded(b) if tree else
                             layout.bucket_shard_count(b) == 1))
    tot = r0["collectives"]
    # the pinned syncs: every rank's anchor and EF memory after its sync of
    # the one process's pre-sync state, against the one process's after
    # it: elements beyond 1e-6 x the largest (EF memory 1e-5)
    pinned_beyond = None
    if tag in V_PINNED:
        pinned_beyond = 0
        for i, want_post in enumerate(ref["pinned_post"]):
            for rk in recs:
                got = torch.load(out / f"{tag}_r{rk['rank']}_pin{i}.pt")
                for f, leaves in got.items():
                    tol = 1e-5 if f == "ef_memory" else 1e-6
                    for b, x in enumerate(leaves):
                        y = part(f, b, want_post[f][b], rk["group"],
                                 rk["shard"])
                        scale = float(y.abs().max()) or 1e-30
                        pinned_beyond += int(((x - y).abs()
                                              > tol * scale).sum())
                del got
    bad = [k for k, ok in (
        ("ranks disagree", all(rc["loss"] == r0["loss"]
                               and rc["comm_rounds"] == r0["comm_rounds"]
                               and rc["ledger"] == r0["ledger"] for rc in recs)),
        ("grid", [(rc["group"], rc["shard"], rc["workers"]) for rc in recs]
         == [(p // V_S, p % V_S, [p // V_S]) for p in range(P)]),
        ("held rows", all(rc["held_rows"] == (local if tree else held)
                          for rc in recs)),
        ("params vs anchor", all(rc.get("params_equal_anchor", True)
                                 for rc in recs)),
        ("replicated copies", rep_equal),
        ("loss", loss_rel <= V_LOSS_TOL[tag]),
        ("comm rounds", r0["comm_rounds"] == ref["comm_rounds"]),
        ("rows", held_frac <= V_FRAC_TOL[tag]),
        ("measured bytes", r0["ledger"]["cost_sources"] == ["measured"]
         and r0["ledger"]["measured_bytes"] == (
             P * sum(v["bytes"] for k, v in tot.items()
                     if k.endswith("/global")) if tree
             else rounds * P * per_rank)
         and r0["ledger"]["wire_bytes"] == ref["ledger_wire_bytes"]),
        ("within", tot["all_gather/within"]["calls"] == STEPS
         and ("reduce_scatter/within" in tot) == (kind == "fsdp")
         and (not tree or tot["all_gather/within"]["bytes"] == STEPS * wl * 4
              * sum(sl.size // V_S for sl in sharded))),
        ("launches", all(rc["launches"] == want for rc in recs)),
        ("segment_sum launches", seg_want is None or all(
            rc["segment_sum_launches"] == seg_want for rc in recs)),
        ("pinned syncs", tag not in V_PINNED or (
            pinned_beyond == 0 and all(rc["pinned_syncs"] == syncs
                                       == len(ref["pinned_post"])
                                       for rc in recs))),
        ("kernels vs plain", all(k["ok"] for k in r0.get("kernels_vs_plain", [])))
    ) if not ok]
    res = {"loss_max_rel_diff": loss_rel, "loss_tol": V_LOSS_TOL[tag],
           "rows_max_rel_diff": rows_rel,
           "rows_frac_beyond_1e-4_of_max": frac,
           "rows_frac_tol": V_FRAC_TOL[tag],
           "replicated_equal_across_shards": rep_equal,
           "measured_bytes_per_round": r0["ledger"]["measured_bytes"] / rounds,
           "ring_bytes_per_round_per_rank": r0["ledger"]["wire_bytes"] / rounds,
           "launches_per_rank_want": want,
           "segment_sum_launches_per_rank_want": seg_want,
           "pinned_syncs_beyond_tol": pinned_beyond}
    if wire and not tree:
        got = torch.load(out / f"{tag}_payload.pt")["packed"]
        same = torch_equal(got, ref["payload"])
        res.update(payload_equal_one_process=same,
                   payload_shape=list(got.shape),
                   payload_bytes_differing=int((got != ref["payload"]).sum())
                   if got.shape == ref["payload"].shape else None)
        if not same:
            bad.append("payload")
    if lars:
        gotr, wantr = r0["round_summary"], ref["round_summary"]
        rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
        errs = {k: rel(gotr[k], v) for k, v in wantr.items() if isinstance(v, float)}
        # phase C's rule for LARS + EF-sign (1e-2 on the fields read from
        # ||mean_k x_k||^2), 1e-3 on the others: the split batch's flips
        # move the next steps' gradients (grad_sq measured 5.8e-5, 7.1e-5
        # and 1.7e-4 in three card runs of this part)
        tols = {k: 1e-2 if k in SYNC_MEAN_KEYS else 1e-3 for k in errs}
        res.update(round_summary_rel_diff=errs, round_summary_tol=tols)
        if [k for k in errs if errs[k] > tols[k]] or \
                not gotr["num_workers"] == wantr["num_workers"] == V_W:
            bad.append("round_summary")
    if tag == "V1":
        rl = max(abs(a - b) / abs(b) for a, b in
                 zip(ref["loss"], ref["replicated_loss"]))
        res["one_process_sharded_vs_replicated_loss_rel"] = rl
        if rl > V_LOSS_TOL["V1"]:
            bad.append("sharded vs replicated")
    res["bad"] = bad
    return res


def phase_v(cfg, spec: dict | None = None) -> dict:
    """Phase V: within-worker sharded sub-buckets across processes at full
    width (see the module docstring); returns the summed launch counts
    of every rank."""
    import torch
    spec = dict(spec or {})
    spec.setdefault("layers", V_LAYERS)
    published, cfg = cfg, cut_depth(cfg, spec["layers"])
    base = ROOT / "build" / "phase_v"
    if base.exists():
        shutil.rmtree(base)
    base.mkdir(parents=True)
    refs = {}
    for tag, *_ in V_PARTS:
        t0 = time.perf_counter()
        refs[tag] = v_one_process(tag, cfg, spec, base)
        refs[tag]["one_process_s"] = time.perf_counter() - t0
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    tags = tuple(t for t, *_ in V_PARTS)
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.spawn(v_rank, args=(free_port(), tags, str(base), spec),
             nprocs=V_W * V_S)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((base / f"rank{r}.json").read_text())
             for r in range(V_W * V_S)]
    launches: dict = {}
    bad = []
    for tag in tags:
        ref = refs[tag]
        run = v_run(tag, cfg, spec.get("seq", 512), spec.get("local_batch", 8))
        chk = v_check(tag, ranks, ref, base, run)
        recs = [rk[tag] for rk in ranks]
        r0 = recs[0]
        _, kind, mode, lars, wire = v_part(tag)
        layout = ref["layout"]
        rec = {"phase": "V", "part": tag, "model": cfg.name,
               "reduced": {"num_layers": [published.num_layers,
                                          cfg.num_layers]},
               "layout": kind,
               "path": ("resident" if tag not in V_BUILD else
                        "tree, plain" if V_BUILD[tag].get("use_kernel", True)
                        is False else "tree, kernel form"),
               "W": V_W, "within_worker_size": V_S, "ranks": V_W * V_S,
               "backend": "gloo", "sync_compression": mode,
               "optimizer": run.optim.optimizer, "wire_pack": wire,
               "sync_coalesce": wire,
               "sub_buckets": [{"class": list(layout.bucket_class(b)),
                                "shards": layout.bucket_shard_count(b),
                                "rows": layout.bucket_rows[b],
                                "rows_a_rank": layout.bucket_local_rows(b),
                                "leaves": len(layout.bucket_slots(b))}
                               for b in range(layout.num_buckets)],
               "devices": [rc["device"] for rc in recs],
               "loss": r0["loss"], "one_process_loss": ref["loss"],
               "comm_rounds": r0["comm_rounds"],
               "step_s_median": [rc["step_s_median"] for rc in recs],
               "sync_s_fenced_median": [rc["sync_s_median"] for rc in recs],
               "within_s_per_step_fenced": [rc["within_s_per_step"] for rc in recs],
               "within_calls": r0["within_calls"],
               "one_process_step_s_median": ref["step_s_median"],
               "one_process_sync_s_median": ref["sync_s_median"],
               "peak_mem_GB": [rc["peak_mem_GB"] for rc in recs],
               "reckoned_GB_a_rank": r0["reckoned"],
               "one_process_peak_mem_GB": ref["peak_mem_GB"],
               "ledger_measured_bytes": r0["ledger"]["measured_bytes"],
               "ledger_ring_bytes_per_rank": r0["ledger"]["wire_bytes"],
               "collectives": r0["collectives"],
               "launches_per_rank": [rc["launches"] for rc in recs],
               "segment_sum_launches_per_rank": [rc["segment_sum_launches"]
                                                 for rc in recs],
               "pinned_replay_s": [rc.get("pinned_replay_s") for rc in recs],
               "kernels_vs_plain": r0.get("kernels_vs_plain"),
               "one_process_s": ref["one_process_s"], **chk}
        emit(rec)
        if chk["bad"]:
            bad.append(f"{tag}: {', '.join(chk['bad'])}")
        for rc in recs:
            for k, v in rc["launches"].items():
                launches[k] = launches.get(k, 0) + v
            launches["segment_sum"] = (launches.get("segment_sum", 0)
                                       + rc["segment_sum_launches"])
    emit({"phase": "V", "summary": True, "spawn_s": spawn_s})
    shutil.rmtree(base, ignore_errors=True)
    if bad:
        raise AssertionError(f"phase V: {'; '.join(bad)}")
    return launches


# phase Q: resizes, demotion's census and checkpoints across ranks
# (DistributedBackend over gloo, every rank on card 0), W 4 -> 2 -> 4 by
# ElasticController(resize_at=Q_RESIZE) at phase A's batch and sequence.
# Each part: (tag, ranks, within-worker size, layout kind, sync
# compression, LARS, wire pack)
Q_PARTS = (("Q1", 2, 1, None, "ef_sign", False, True),
           ("Q2", 4, 2, "fsdp", "ef_sign", True, False),
           ("Q3", 2, 1, None, "ef_sign", False, True))
# the tree path's kernel form (DistributedBackend keywords): Q3 is Q1 on
# tree states, held against Q1's one-process run (the same settings)
Q_BUILD = {"Q3": dict(resident=False)}
# paper-lm's depth here (see V_LAYERS): 2 since the script's run from
# `git archive` with phase U added took 937.7 s against its 930 s target
# (phase Q 145.5 s of it at 4 layers; H100 80GB HBM3, 700.00 W); 1 since
# the tree parts of phase V (see V_LAYERS)
Q_LAYERS = 1
Q_RESIZE = {2: 2, 4: 4}        # global round -> W: W=2 runs steps 2-3
Q_CKPT_STEP = 7                # the checkpoint after round 5's sync (W=4)
# losses against the one-process run (relative), and the params rows' share
# of elements beyond 1e-4 x the largest (phase V's measure): Q1 adds what
# one process adds; FSDP's shard ranks differentiate half a batch each.
# Readings on an H100 80GB HBM3 at 700 W: Q1 0.0 / 0.0 with each worker's
# kernel grid fixed by its rows (3.3e-7 / 8.7e-5 while it was sized by W),
# Q2 4.7e-6 / 6.0e-3, then 8.2e-6 / 5.1e-3, and 1.04e-5 / 5.5e-3 once
# the update kernel's operations rounded one by one (the half-batch
# rounding carried along another trajectory): its loss bound is about twice
# the largest reading
Q_LOSS_TOL = {"Q1": 0.0, "Q2": 2e-5, "Q3": 0.0}
Q_FRAC_TOL = {"Q1": 0.0, "Q2": 1.2e-2, "Q3": 0.0}


def q_part(tag: str):
    return next(p for p in Q_PARTS if p[0] == tag)


def q_run(tag: str, cfg, seq: int = 512, local_batch: int = 8):
    """Part ``tag``'s RunConfig: phase W's (Q1) or phase V3's (Q2) settings
    at W=4 (the elastic controller's telemetry on)."""
    _, _, _, _, mode, lars, wire = q_part(tag)
    return phase_run(mode, cfg, seq=seq, local_batch=local_batch, lars=lars,
                     wire_pack=wire, controller=dict(kind="elastic"))


def q_fit(run, backend, *, tracer, checkpoint_fn=None):
    """fit() of phase Q's run through ``backend`` with the resizing
    controller, on train_run's data (seed 0)."""
    from repro_torch.core.controller import ElasticController
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch import train as ttrain
    S, B = run.shape.seq_len, run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=run.model.vocab_size,
                                 num_seqs=W * B * 4, seq_len=S, seed=0))
    return ttrain.fit(
        run, ShardedBatches(data, W, B, seed=0), backend=backend,
        num_steps=STEPS, seed=0, log=lambda *a: None, tracer=tracer,
        controller=ElasticController(run, resize_at=Q_RESIZE),
        checkpoint_every=Q_CKPT_STEP + 1 if checkpoint_fn else 0,
        checkpoint_fn=checkpoint_fn)


def q_steps_at(tracer) -> dict:
    """Local steps at each W, from the resize spans."""
    cuts = [(sp.attrs["step"], sp.attrs["to_workers"]) for sp in tracer.spans
            if sp.name == "resize"]
    w, out = W, {}
    for t in range(STEPS):
        out[f"W={w}"] = out.get(f"W={w}", 0) + 1
        w = next((nw for st, nw in cuts if st == t), w)
    return out


def q_one_process(tag: str, cfg, spec: dict) -> dict:
    """Part ``tag`` in one process (``LocalBackend``, the part's layout):
    the reference of the ranks' run; its losses and final params rows."""
    import torch
    from repro_torch.backend.local import LocalBackend
    from repro_torch.telemetry.trace import Tracer
    dev = spec.get("device", "cuda")
    _, P, S, kind, *_ = q_part(tag)
    run = q_run(tag, cfg, spec.get("seq", 512), spec.get("local_batch", 8))
    lay = None if kind is None else v_layout(kind).with_sizes(
        {"data": P // S, "model": S})
    tracer = Tracer(fence=True)
    state, hist, summ = q_fit(run, LocalBackend(W, device=dev, layout=lay),
                              tracer=tracer)
    rec = {"loss": [h["loss"] for h in hist], "comm_rounds": summ["comm_rounds"],
           "layout": state.params.layout, "resizes": summ["resizes"],
           "worker_sets": summ["ledger"]["worker_sets"],
           "params": [b.float().cpu() for b in state.params.buckets],
           "steps_at": q_steps_at(tracer)}
    del state
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return rec


def q_check_segment_sum(state, layout) -> list:
    """C.1's segmented sum on the rank's own rows after the resizes: the
    row sums of its momentum, per worker and chained, against the plain
    version (the same bits) and twice (the same bits)."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.kernels import fused_bucket as fb
    out = []
    for b, x in enumerate(state.momentum.buckets):
        index = flatbuf.segment_index(layout, b, x.device)
        rs = fb.row_abs_sum(flatbuf.shard_regions(layout, b, x.contiguous()))
        rs = rs.reshape(-1, rs.shape[-1]).contiguous()
        n_seg = index.offsets.numel() - 1
        per, chain = fb.segment_sum(rs, index), fb.segment_sum(rs, index,
                                                               chain=True)
        ok = bool(torch.equal(per, fb.segment_sum_plain(rs, index.seg_ids,
                                                        n_seg))
                  and torch.equal(chain, fb.segment_sum_plain(
                      rs, index.seg_ids, n_seg, chain=True))
                  and torch.equal(per, fb.segment_sum(rs, index)))
        out.append({"bucket": b, "shape": list(rs.shape), "segments": n_seg,
                    "ok": ok})
    return out


def q_rank(r: int, port: int, tag: str, out: str, spec: dict):
    """One rank of phase Q's part ``tag`` (``torch.multiprocessing.spawn``'s
    target): the resizing run with a checkpoint through
    ``DistributedBackend`` on card 0 under a fenced tracer; writes what it
    measured to ``out/rank{r}.json`` and its final params rows to
    ``out/r{r}.pt``.  Rank 0 restores the snapshot on the card in this
    process (at W=4, and at W=2 by the elastic restore) against the state
    the checkpoint gathered, and holds kernels 1-6 and the segmented sum
    against their plain versions on its rows after the resizes."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.backend.distributed import DistributedBackend
    from repro_torch.checkpoint.checkpoint import restore_flat, save_flat
    from repro_torch.core.elastic import resize_state
    from repro_torch.core.local_sgd import (is_resident, pack_state,
                                            state_template)
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.telemetry.trace import Tracer
    from repro_torch.utils import tree_leaves

    cfg = paper_lm(spec)
    _, P, S, kind, *_ = q_part(tag)
    rec = {}

    def leaves(field):
        """A field's tensors: a resident state's buckets, a tree's leaves."""
        return (field.buckets if hasattr(field, "buckets")
                else tree_leaves(field))
    try:
        be = DistributedBackend(W, backend="gloo", process_id=r, num_processes=P,
                                coordinator_address=f"localhost:{port}",
                                local_rank=r, device=spec.get("device"),
                                timeout_s=Y_TIMEOUT_S, within_worker_size=S,
                                layout=None if kind is None else v_layout(kind),
                                **Q_BUILD.get(tag, {}))
        run = q_run(tag, cfg, spec.get("seq", 512), spec.get("local_batch", 8))
        dev = be.rank_device()
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.set_device(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        path = f"{out}/ckpt"
        held = {}

        def checkpoint_fn(full, t):
            t0 = time.perf_counter()
            save_flat(path, full, step=t)
            held.update(write_s=time.perf_counter() - t0, state=full,
                        bytes=os.path.getsize(path + ".npz"))
        fb.reset_launches()
        tracer = Tracer(fence=True)
        state, hist, summ = q_fit(run, be, tracer=tracer,
                                  checkpoint_fn=checkpoint_fn)
        counts = {**fb.LAUNCHES, **fb.PORT_LAUNCHES}
        d = be.collectives
        tree = not is_resident(state)
        # a tree state's rows in the resident layout (its kernels' checks
        # and its rows against the one-process buckets)
        rstate = (pack_state(state, wd_mask=mbase.norm_param_mask(
            lm.param_specs(cfg))) if tree else state)
        layout = rstate.params.layout
        ck = [sp.dur_s for sp in tracer.spans if sp.name == "checkpoint"]
        rec.update({
            "rank": r, "device": str(dev), "group": d.layout.group,
            "shard": d.layout.shard, "workers": list(d.layout.worker_ids),
            "loss": [h["loss"] for h in hist], "lr": [h["lr"] for h in hist],
            "comm_rounds": summ["comm_rounds"], "resizes": summ["resizes"],
            "worker_sets": summ["ledger"]["worker_sets"],
            "ledger": {k: summ["ledger"][k] for k in
                       ("measured_bytes", "cost_sources", "wire_bytes")},
            "resize_s": [[sp.attrs["from_workers"], sp.attrs["to_workers"],
                          sp.dur_s] for sp in tracer.spans if sp.name == "resize"],
            "decisions": [sp.attrs.get("decisions") for sp in tracer.spans
                          if sp.name == "controller"],
            "steps_at": q_steps_at(tracer),
            "step_s_median": statistics.median(
                sp.dur_s for sp in tracer.spans if sp.name == "local_steps"),
            "checkpoint_s": ck, "collectives": d.describe()["totals"],
            "peak_mem_GB": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if cuda else None),
            "reckoned": v_reckon(layout, run, d.layout.w_local,
                                 S > 1 and be.mesh_layout(P).batch_split() > 1),
            "tree_state": tree, "launches": counts})
        torch.save([b.float().cpu() for b in rstate.params.buckets],
                   f"{out}/r{r}.pt")
        if r == 0:
            full = held.pop("state")
            total = ck[0]
            rec["checkpoint"] = {
                "step": Q_CKPT_STEP, "file_bytes": held["bytes"],
                "span_s": total, "write_s": held["write_s"],
                "gather_s": total - held["write_s"],
                "write_GBps": held["bytes"] / held["write_s"] / 1e9,
                "gather_GBps": held["bytes"] / max(total - held["write_s"],
                                                   1e-9) / 1e9}
            same = {}
            for w in (W, 2):
                t0 = time.perf_counter()
                if tree:
                    # a tree snapshot at W, then W=2 by the slicing fold
                    back = restore_flat(path, state_template(state, d, W),
                                        device=dev)
                    if w != W:
                        back = resize_state(back, w, fold="slice")
                else:
                    back = restore_flat(path, state_template(state, d, w),
                                        device=dev)
                restore_s = time.perf_counter() - t0
                eq = all(
                    torch.equal(x.cpu(), (y if f in ("anchor", "global_u")
                                          else y[:w]))
                    for f in ("params", "momentum", "anchor", "global_u",
                              "ef_memory") if getattr(full, f) is not None
                    for x, y in zip(leaves(getattr(back, f)),
                                    leaves(getattr(full, f))))
                eq &= back.step == full.step
                same[f"W={w}"] = {"equal_gathered": eq, "restore_s": restore_s,
                                  "device": str(leaves(back.params)[0].device)}
                del back
            rec["restore"] = same
            del full
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                # launches of these checks are not counted: read above
                rec["kernels_vs_plain"] = m_check_kernels(rstate, run, layout,
                                                          lars=True)
                rec["segment_sum_vs_plain"] = q_check_segment_sum(rstate,
                                                                  layout)
        del state, rstate
    finally:
        with open(f"{out}/rank{r}.json", "w") as f:
            json.dump(rec, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_q(cfg, spec: dict | None = None) -> dict:
    """Phase Q: W 4 -> 2 -> 4 across ranks with a checkpoint (see Q_PARTS):
    each part's one-process run, then its ranks; every rank's losses,
    decisions and rows held against the one-process run, the snapshot
    restored on the card against the gathered state, the kernels on the
    rows after the resizes.  Returns the summed launch counts of every
    rank (the segmented sum's among them)."""
    import torch
    import torch.multiprocessing as mp
    spec = dict(spec or {})
    spec.setdefault("layers", Q_LAYERS)
    published, cfg = cfg, cut_depth(cfg, spec["layers"])
    base = ROOT / "build" / "phase_q"
    launches: dict = {}
    bad = []
    refs = {}          # settings -> the one-process run (Q3 takes Q1's)
    for tag, P, S, kind, mode, lars, wire in Q_PARTS:
        t0 = time.perf_counter()
        key = (P, S, kind, mode, lars, wire)
        if key not in refs:
            refs[key] = (tag, q_one_process(tag, cfg, spec))
        held_against, ref = refs[key]
        one_s = time.perf_counter() - t0
        out = base / tag
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        t0 = time.perf_counter()
        mp.spawn(q_rank, args=(free_port(), tag, str(out), spec), nprocs=P)
        spawn_s = time.perf_counter() - t0
        recs = [json.loads((out / f"rank{r}.json").read_text())
                for r in range(P)]
        r0 = recs[0]
        layout = ref["layout"]
        wl = W // (P // S)
        frac, rows_rel = 0.0, 0.0
        for rc in recs:
            got = torch.load(out / f"r{rc['rank']}.pt")
            g, sh = rc["group"], rc["shard"]
            for b, x in enumerate(got):
                y = ref["params"][b][g * wl:(g + 1) * wl]
                if S > 1 and layout.bucket_shard_count(b) > 1:
                    lr = layout.bucket_local_rows(b)
                    y = y[..., sh * lr:(sh + 1) * lr, :]
                scale = float(y.abs().max()) or 1e-30
                dd = (x - y).abs()
                rows_rel = max(rows_rel, float(dd.max()) / scale)
                frac = max(frac, float((dd > 1e-4 * scale).float().mean()))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
        bad_part = [k for k, ok in (
            ("ranks disagree", all(rc["loss"] == r0["loss"]
                                   and rc["decisions"] == r0["decisions"]
                                   and rc["comm_rounds"] == r0["comm_rounds"]
                                   and rc["worker_sets"] == r0["worker_sets"]
                                   for rc in recs)),
            ("resizes", r0["resizes"] == ref["resizes"] == 2
             and [x[:2] for x in r0["resize_s"]] == [[4, 2], [2, 4]]),
            ("worker sets", r0["worker_sets"] == ref["worker_sets"]),
            ("steps at each W", r0["steps_at"] == ref["steps_at"]),
            ("comm rounds", r0["comm_rounds"] == ref["comm_rounds"]),
            ("loss", loss_rel <= Q_LOSS_TOL[tag]),
            ("rows", frac <= Q_FRAC_TOL[tag]),
            ("restore", all(v["equal_gathered"] for v in r0["restore"].values())),
            ("kernels vs plain", all(k["ok"] for k in r0.get("kernels_vs_plain", []))
             and all(k["ok"] for k in r0.get("segment_sum_vs_plain", []))),
            ("launches", all(rc["launches"]["segment_sum"] > 0 for rc in recs)),
            ("tree state", all(rc["tree_state"] == (tag in Q_BUILD)
                               for rc in recs))
        ) if not ok]
        emit({"phase": "Q", "part": tag, "model": cfg.name, "W": W,
              "reduced": {"num_layers": [published.num_layers,
                                         cfg.num_layers]},
              "resize_at": Q_RESIZE, "ranks": P, "within_worker_size": S,
              "layout": kind or "one worker group a rank", "backend": "gloo",
              "build": Q_BUILD.get(tag, {}),
              "held_against_one_process_run_of": held_against,
              "sync_compression": mode, "lars": lars, "wire_pack": wire,
              "local_batch": spec.get("local_batch", 8),
              "seq": spec.get("seq", 512),
              "loss": r0["loss"], "one_process_loss": ref["loss"],
              "loss_max_rel_diff": loss_rel, "loss_tol": Q_LOSS_TOL[tag],
              "rows_max_rel_diff": rows_rel,
              "rows_frac_beyond_1e-4_of_max": frac,
              "rows_frac_tol": Q_FRAC_TOL[tag],
              "lr": r0["lr"], "comm_rounds": r0["comm_rounds"],
              "steps_at": r0["steps_at"], "worker_sets": r0["worker_sets"],
              "resize_s_fenced": [rc["resize_s"] for rc in recs],
              "step_s_median_fenced": [rc["step_s_median"] for rc in recs],
              "checkpoint": r0["checkpoint"],
              "checkpoint_s_fenced": [rc["checkpoint_s"] for rc in recs],
              "restore": r0["restore"],
              "ledger_measured_bytes": r0["ledger"]["measured_bytes"],
              "collectives": r0["collectives"],
              "peak_mem_GB": [rc["peak_mem_GB"] for rc in recs],
              "reckoned_GB_a_rank": r0["reckoned"],
              "launches_per_rank": [rc["launches"] for rc in recs],
              "kernels_vs_plain": r0.get("kernels_vs_plain"),
              "segment_sum_vs_plain": r0.get("segment_sum_vs_plain"),
              "one_process_s": one_s, "spawn_s": spawn_s, "bad": bad_part})
        if bad_part:
            bad.append(f"{tag}: {', '.join(bad_part)}")
        for rc in recs:
            for k, v in rc["launches"].items():
                launches[k] = launches.get(k, 0) + v
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase Q: {'; '.join(bad)}")
    return launches


# ---------------------------------------------------------------------------
# phase J: the long shapes, train_4k's and prefill_32k's lengths, through
# block remat (lm.loss_fn(remat="block")) and the blockwise attention
# (models.layers.chunked_attention)
# ---------------------------------------------------------------------------

# J1: paper-lm at full width and depth, train_4k's 4,096 tokens, W = 4 x
# local batch 4, phase B's EF-sign sync and grad clip, H = 2 from the
# first step: 2 local steps and 1 sync, remat "block"
J1_SEQ, J1_LOCAL_BATCH, J1_STEPS = 4096, 4, 2
# the measured peak against dryrun.reckon_card's (remat "block"): U1's band
J_PEAK_BAND = (0.5, 1.5)
# J1b: one layer, one sequence of 4,096: the gradients with remat against
# those without, phase C's rtol (of each leaf's largest entry)
J1B_RTOL = 1e-4
# J2: gemma3-1b at full width and all 26 layers, prefill_32k's 32,768
# tokens, batch 1; the last q block's rows of a sliding layer (call 0) and
# of a global one (call 5) against reference_attention, end-aligned
J2_ARCH, J2_SEQ, J2_ROWS = "gemma3-1b", 32768, 512
J2_CHECKED = {0: "sliding", 5: "global"}
J2_TOL = 1e-4                  # of the oracle's largest entry


def j1_run(cfg):
    """J1's RunConfig: phase B's settings at 4,096 tokens and local batch
    4, H = 2 with no post-local switch (one sync after 2 steps), block
    remat."""
    import dataclasses
    run = phase_run("ef_sign", cfg, seq=J1_SEQ, local_batch=J1_LOCAL_BATCH,
                    steps=J1_STEPS)
    return dataclasses.replace(
        run, remat="block", local_sgd=dataclasses.replace(
            run.local_sgd, local_steps=J1_STEPS, post_local_switch=-1))


def j_square_saved(cfg, local_batch: int, seq: int) -> dict:
    """What one worker's attention keeps for the backward a layer: the
    blockwise form's (traced on ``meta``), and the retired whole-square
    form's: its softmax output (B, H, S, S) float32 and the (S, S) mask."""
    import torch
    from repro_torch.launch.dryrun import _saved_by
    from repro_torch.models.layers import chunked_attention
    H, KH, D = cfg.num_heads, cfg.num_kv_heads or cfg.num_heads, \
        cfg.resolved_head_dim
    q = torch.empty((local_batch, seq, H, D), device="meta", requires_grad=True)
    k, v = (torch.empty((local_batch, seq, KH, D), device="meta",
                        requires_grad=True) for _ in range(2))
    skip = {t.untyped_storage()._cdata for t in (q, k, v)}
    _, saved = _saved_by(lambda: chunked_attention(q, k, v), skip)
    return {"blockwise": sum(saved.values()),
            "square": local_batch * H * seq * seq * 4 + seq * seq}


def phase_j1(cfg, flops_peak: float) -> dict:
    """J1: train_4k's length on the main path with block remat.  The
    reckonings first (``dryrun.reckon_card`` with remat "block", and,
    not run, with "none" and with the whole-square attention); then 2
    steps and 1 EF-sign sync at W = 4: losses finite near ln V, the sync,
    kernels 1-4 launched, the peak beside the reckoning; J1b the
    gradients of one layer with and without remat.  Returns the launch
    counts."""
    import torch
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.dryrun import reckon_card, trace_train
    from repro_torch.launch.steps import build_train
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_unflatten

    gc.collect()
    torch.cuda.empty_cache()
    run = j1_run(cfg)
    lb, seq = J1_LOCAL_BATCH, J1_SEQ
    t0 = time.perf_counter()
    traces = {r: trace_train(cfg, lb, seq, device="meta", flops=False,
                             remat=r) for r in ("block", "none")}
    REFS.setdefault("trace", {})["J1"] = traces["block"]
    rc = {k: reckon_card(cfg, t, workers=W, mode="ef_sign")
          for k, t in traces.items()}
    # a worker's FLOPs (the replay in): traced at 1 and 2 layers on meta,
    # exactly affine in the depth
    f1, f2 = (trace_train(cfg.replace(num_layers=n), lb, seq, device="meta",
                          remat="block")["flops"] for n in (1, 2))
    flops_worker = f1 + (f2 - f1) * (cfg.num_layers - 1)
    att = j_square_saved(cfg, lb, seq)
    square = dict(traces["none"])
    square["saved_bytes"] += cfg.num_layers * (att["square"] - att["blockwise"])
    rc["square"] = reckon_card(cfg, square, workers=W, mode="ef_sign")
    reckon_s = time.perf_counter() - t0

    bundle = build_train(run, num_workers=W, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() / 1e9
    fb.reset_launches()
    seg0 = fb.PORT_LAUNCHES["segment_sum"]
    state, hist, summ, step_s = train_run(run, device="cuda", steps=J1_STEPS,
                                          bundle=bundle)
    counts = dict(fb.LAUNCHES)
    seg = fb.PORT_LAUNCHES["segment_sum"] - seg0
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    del state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    REFS.setdefault("peak_GB", {})["J1"] = peak / 1e9
    flops_step = W * flops_worker
    GB = lambda r: {k: r[k] / 1e9 for k in (
        "state_bytes", "activation_bytes", "recompute_bytes",
        "logits_grad_bytes", "step_peak_bytes", "sync_peak_bytes", "peak_bytes")}
    rec = {"phase": "J", "part": "J1", "model": cfg.name, "W": W,
           "local_batch": lb, "seq": seq, "layers": cfg.num_layers,
           "remat": run.remat, "sync_compression": "ef_sign",
           "grad_clip": run.optim.grad_clip,
           "local_steps": run.local_sgd.local_steps, "steps": J1_STEPS,
           "loss": losses, "ln_vocab": math.log(cfg.vocab_size),
           "comm_rounds": summ["comm_rounds"], "step_s": step_s,
           "tokens_per_s": W * lb * seq * len(step_s) / sum(step_s),
           "flops_step_meta": flops_step,
           "step_f32_bound_s": flops_step / flops_peak,
           "share_of_f32_bound": [flops_step / flops_peak / s for s in step_s],
           "mem_before_GB": mem0, "measured_peak_GB": peak / 1e9,
           "reckoned_GB": {k: GB(r) for k, r in rc.items()},
           "reckoned_over_measured": rc["block"]["peak_bytes"] / peak,
           "attention_saved_GB_a_layer": {k: v / 1e9 for k, v in att.items()},
           "fits_card": {k: bool(r["fits"]) for k, r in rc.items()},
           "reckon_s": reckon_s, "launches": counts,
           "segment_sum_launches": seg}
    bad = []
    if not (all(math.isfinite(v) for v in losses)
            and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0):
        bad.append(f"losses {losses}")
    if summ["comm_rounds"]["global"] != 1:
        bad.append(f"comm rounds {summ['comm_rounds']}")
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=J1_STEPS, sq_sum=J1_STEPS, row_abs_sum=1,
                scale_sign_rows=1)
    if counts != want or seg != 1:
        bad.append(f"launches {counts} (segment_sum {seg}), want {want}")
    ratio = rec["reckoned_over_measured"]
    if not (J_PEAK_BAND[0] <= ratio <= J_PEAK_BAND[1]
            and rc["block"]["state_bytes"] <= peak):
        bad.append(f"peak {peak / 1e9:.2f} GB against "
                   f"{rc['block']['peak_bytes'] / 1e9:.2f} reckoned")

    # -- J1b: one layer, one sequence: remat against none
    one = cfg.replace(num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(31)
    params = mbase.materialize(lm.param_specs(one), gen, "cuda")
    tok = torch.randint(0, one.vocab_size, (1, seq + 1), generator=gen,
                        device="cuda")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    grads = {}
    for remat in ("none", "block"):
        leaves, treedef = tree_flatten(params)
        leaves = [a.clone().requires_grad_(True) for a in leaves]
        loss, _ = lm.loss_fn(one, tree_unflatten(treedef, leaves), batch,
                             remat=remat)
        loss.backward()
        grads[remat] = (float(loss), [a.grad for a in leaves])
    (l0, g0), (l1, g1) = grads["none"], grads["block"]
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(g1, g0)]
    rec["J1b"] = {"layers": 1, "tokens": seq, "loss": [l0, l1],
                  "grad_max_rel_err": max(errs), "rtol": J1B_RTOL,
                  "bit_for_bit": l0 == l1 and all(torch.equal(a, b)
                                                  for a, b in zip(g1, g0))}
    del params, grads, g0, g1
    torch.cuda.empty_cache()
    if abs(l1 - l0) > J1B_RTOL * abs(l0) or max(errs) > J1B_RTOL:
        bad.append(f"J1b: remat against none {rec['J1b']}")
    emit(rec)
    if bad:
        raise AssertionError(f"phase J1: {'; '.join(bad)}")
    return counts


def phase_j2() -> dict:
    """J2: prefill_32k's length on the serving path: gemma3-1b at full
    width and depth, one prompt of 32,768 tokens through ``lm.prefill``
    (the attention's ``differentiable=False`` form), twice: the logits
    finite, 26 attention calls, the last 512 query rows of a sliding and
    a global layer against ``reference_attention`` on those rows and the
    keys they reach (the last 1,024, or all); seconds and the peak beside
    a reckoning."""
    import torch
    from repro_torch import configs
    from repro_torch.models import base as mbase
    from repro_torch.models import blocks
    from repro_torch.models import lm
    from repro_torch.models.layers import reference_attention
    from repro_torch.utils import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get(J2_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(37)
    params = mbase.materialize(lm.param_specs(cfg), gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, J2_SEQ), generator=gen,
                           device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    KH, D = cfg.num_kv_heads, cfg.resolved_head_dim
    cache_bytes = cfg.num_layers * J2_SEQ * KH * D * 2 * 4
    reckon = {"weights": n_params * 4, "cache": cache_bytes,
              "cache_stacked_copy": cache_bytes,
              "ffn_transient": 3 * J2_SEQ * cfg.d_ff * 4,
              "scores_a_block": 512 * cfg.num_heads * 512 * 4,
              "square_scores_a_global_layer": cfg.num_heads * J2_SEQ ** 2 * 4}
    reckoned_peak = sum(v for k, v in reckon.items()
                        if k not in ("square_scores_a_global_layer",))
    captured, calls = {}, [0]
    orig = blocks.chunked_attention

    def spy(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        i = calls[0]
        calls[0] += 1
        if i in J2_CHECKED:
            captured[i] = (q[:, -J2_ROWS:].clone(), k, v,
                           out[:, -J2_ROWS:].clone(), kw)
        return out

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    seconds = []
    blocks.chunked_attention = spy
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(cfg, params, tokens)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            blocks.chunked_attention = orig
            del cache
    finally:
        blocks.chunked_attention = orig
    peak = torch.cuda.max_memory_allocated()
    checks = {}
    for i, (q, k, v, got, kw) in captured.items():
        keys = 2 * J2_ROWS if kw["window"] else J2_SEQ
        want = reference_attention(q, k[:, -keys:], v[:, -keys:],
                                   window=kw["window"], softcap=kw["softcap"],
                                   scale=kw["scale"])
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        checks[J2_CHECKED[i]] = {"call": i, "window": kw["window"],
                                 "keys": keys, "max_abs_err": err,
                                 "oracle_max": scale,
                                 "ok": err <= J2_TOL * scale}
    del captured, params
    torch.cuda.empty_cache()
    rec = {"phase": "J", "part": "J2", "model": cfg.name,
           "layers": cfg.num_layers, "batch": 1, "tokens": J2_SEQ,
           "block": 512, "prefill_s": seconds,
           "tokens_per_s": J2_SEQ / min(seconds),
           "attention_calls": calls[0],
           "logits_shape": list(logits.shape),
           "logits_finite": bool(torch.isfinite(logits).all()),
           "mem_before_GB": mem0 / 1e9, "measured_peak_GB": peak / 1e9,
           "reckoned_GB": {k: v / 1e9 for k, v in reckon.items()},
           "reckoned_peak_GB": reckoned_peak / 1e9,
           "reckoned_over_measured": reckoned_peak / peak,
           "oracle": checks, "tol": J2_TOL}
    emit(rec)
    bad = [k for k, c in checks.items() if not c["ok"]]
    if (len(checks) != len(J2_CHECKED) or bad or not rec["logits_finite"]
            or rec["logits_shape"] != [1, 1, cfg.vocab_size]
            or calls[0] != cfg.num_layers):
        raise AssertionError(f"phase J2: oracle {checks}, logits "
                             f"{rec['logits_shape']} finite "
                             f"{rec['logits_finite']}, {calls[0]} calls")
    return {}


# ---------------------------------------------------------------------------
# phase U: the dry-run and roofline analogues on the card (launch.dryrun,
# roofline.{analysis,probe,sync_probe,hlo})
# ---------------------------------------------------------------------------

# U1: a reckoning (state copies + one worker's saved activations + its
# logits' gradient) must fall within this band of the peak its phase
# measured
U_PEAK_BAND = (0.5, 1.5)
# U2: FlopCounterMode's count of a worker's loss and gradient against 3 x
# the analytic forward, the band of the reference's
# test_analytic_flops_vs_cost_analysis (the port's attention computes the
# whole S x S square, the analytic count the causal band)
U_FLOP_BAND = (0.5, 2.0)


# the parts U1 reckons under block remat
U_REMAT = {"J1": "block"}


def u_runs() -> list:
    """(tag, arch, sync, W, layers, seq, local batch) of phase A, of
    every family part at its cut depth, and of J1, as those phases ran
    them."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import x_depth
    runs = [("A", "paper-lm", "none", W, 12, 512, 8)]
    runs += [(t, a, m, w, n, 512, 8) for t, a, m, w, n in M_RUNS]
    runs += [(t, a, "none", w, n, seq, lb)
             for t, a, w, n, _, _, _, seq, lb in D_RUNS]
    runs += [(t, a, m, w, n, seq, lb) for t, a, m, w, n, seq, lb, _ in Z_RUNS]
    runs += [(t, a, m, w, n or x_depth(configs.get(a), w, m), seq, lb)
             for t, a, m, w, n, seq, lb in X_RUNS]
    runs.append(("J1", "paper-lm", "ef_sign", W, 12, J1_SEQ, J1_LOCAL_BATCH))
    return runs


def phase_u1() -> list:
    """U1: the dry run's one-card reckoning of phase A and of every family
    part beside the peak that part measured; returns the failures."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import reckon_card, trace_train
    bad = []
    for tag, arch, mode, workers, layers, seq, lb in u_runs():
        cfg = cut_depth(configs.get(arch), layers)
        t0 = time.perf_counter()
        remat = U_REMAT.get(tag, "none")
        trace = REFS.get("trace", {}).get(tag) or trace_train(
            cfg, lb, seq, device="meta", flops=False, remat=remat)
        rc = reckon_card(cfg, trace, workers=workers, mode=mode)
        peak = REFS["peak_GB"][tag] * 1e9
        ratio = rc["peak_bytes"] / peak
        ok = (rc["state_bytes"] <= peak
              and U_PEAK_BAND[0] <= ratio <= U_PEAK_BAND[1])
        emit({"phase": "U", "part": "U1", "run": tag, "model": arch,
              "layers": cfg.num_layers, "W": workers, "local_batch": lb,
              "seq": seq, "sync_compression": mode, "remat": remat,
              "reckoned_GB": {k: rc[k] / 1e9 for k in (
                  "state_bytes", "activation_bytes", "logits_grad_bytes",
                  "recompute_bytes", "step_peak_bytes", "sync_peak_bytes",
                  "peak_bytes")},
              "measured_peak_GB": peak / 1e9,
              "reckoned_over_measured": ratio,
              "state_over_measured": rc["state_bytes"] / peak,
              "band": U_PEAK_BAND, "ok": ok,
              "trace_s": time.perf_counter() - t0})
        if not ok:
            bad.append(f"U1 {tag}: reckoned {rc['peak_bytes'] / 1e9:.2f} GB "
                       f"(state {rc['state_bytes'] / 1e9:.2f}) against "
                       f"{peak / 1e9:.2f} GB measured")
    return bad


def phase_u(cfg, a_step_s: float, flops_peak: float) -> dict:
    """Phase U: the dry-run and roofline analogues on the card at paper-lm's
    full width; returns U3's launch counts.  U1 the one-card reckonings
    against the measured peaks; U2 FlopCounterMode on the card against the
    meta trace and the analytic count, and phase A's step against the f32
    compute bound; U3 the layer-period probe on the card (1 and 2 layers,
    phase A's settings) extrapolated to 12 layers beside phase A's step;
    U4 the sync probe's five rows on phase Y's four ranks."""
    import torch
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.roofline import probe
    from repro_torch.roofline.analysis import forward_flops

    bad = phase_u1()

    # -- U2: one worker's loss and gradient counted on the card and on meta
    meta = trace_train(cfg, 8, 512, device="meta")
    card = trace_train(cfg, 8, 512, device="cuda")
    torch.cuda.empty_cache()
    analytic = 3 * forward_flops(cfg, 8, 512)
    ratio = meta["flops"] / analytic
    bound_s = W * meta["flops"] / flops_peak
    rec = {"phase": "U", "part": "U2", "model": cfg.name, "local_batch": 8,
           "seq": 512, "flops_worker_card": card["flops"],
           "flops_worker_meta": meta["flops"],
           "flops_by_op_equal": card["flops_by_op"] == meta["flops_by_op"],
           "saved_bytes_card": card["saved_bytes"],
           "saved_bytes_meta": meta["saved_bytes"],
           "analytic_3x_forward": analytic, "counted_over_analytic": ratio,
           "band": U_FLOP_BAND, "f32_peak_flops": flops_peak,
           "W": W, "step_f32_bound_s": bound_s,
           "phase_A_step_s_median": a_step_s,
           "phase_A_share_of_bound": bound_s / a_step_s}
    emit(rec)
    if card["flops"] != meta["flops"] or not rec["flops_by_op_equal"]:
        bad.append(f"U2: the card counts {card['flops']} FLOPs, meta "
                   f"{meta['flops']}")
    if not U_FLOP_BAND[0] <= ratio <= U_FLOP_BAND[1]:
        bad.append(f"U2: counted / 3 x analytic = {ratio:.3f}")

    # -- U3: 1 and 2 layers on the card, extrapolated to 12
    fb.reset_launches()
    seg0 = fb.PORT_LAUNCHES["segment_sum"]
    out = probe.probe_card(phase_run("none", cfg, seq=512, local_batch=8),
                           workers=W, device="cuda", steps=STEPS)
    counts = dict(fb.LAUNCHES)
    counts["segment_sum"] = fb.PORT_LAUNCHES["segment_sum"] - seg0
    torch.cuda.empty_cache()
    rec = {"phase": "U", "part": "U3", "model": cfg.name, "W": W,
           "layers": cfg.num_layers, "probe_layers": [1, 2], "steps": STEPS,
           **{k: out[k] for k in out if not k.startswith("probe")},
           "step_s_probe": [out["probe1"]["step_s_median"],
                            out["probe2"]["step_s_median"]],
           "phase_A_step_s_median": a_step_s,
           "extrapolated_over_A": out["step_s_median_full"] / a_step_s,
           "flops_full_equals_12_layer_count":
               out["flops_full"] == W * meta["flops"],
           "launches": counts}
    emit(rec)
    if not rec["flops_full_equals_12_layer_count"]:
        bad.append(f"U3: extrapolated {out['flops_full']} FLOPs, the 12-layer "
                   f"count {W * meta['flops']}")
    if counts["fused_sgd_bucket"] != 2 * STEPS or counts["sq_sum"] != 2 * STEPS:
        bad.append(f"U3: launches {counts}")

    # -- U4: the sync probe's rows, run on phase Y's ranks
    ranks = REFS["U4"]
    for i, row in enumerate(ranks[0]["rows"]):
        held = [rk["rows"][i]["held_equal"] for rk in ranks]
        emit({"phase": "U", "part": "U4", "ranks": len(ranks),
              "held_every_rank": held,
              "probe_s": [rk["s"] for rk in ranks],
              **{k: row[k] for k in (
                  "compression", "wire_pack", "bucket_sync", "workers",
                  "count", "coll_bytes", "by_op", "handed_by_op",
                  "c10d_calls", "collectives_handed", "collectives_sent",
                  "ledger_measured_bytes", "ring_model_bytes",
                  "ring_model_collectives", "held")}})
        if not all(held):
            bad.append(f"U4 row {i}: the trace's bytes differ from the "
                       f"counted ones: {row['held']}")
    if bad:
        raise AssertionError(f"phase U: {'; '.join(bad)}")
    return counts


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run this from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # the CUDA allocator maps memory in growable segments: phase D's steps
    # run within a few GB of the card, where a fragmented cache fails
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import configs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.launch.mesh import card_rates

    laps = Laps()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    bw, flops_peak, bf16_peak, tf32_peak = card_rates(name)
    emit({"phase": "card", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_bw_Bps": bw,
          "f32_peak_flops": flops_peak, "bf16_tensor_peak_flops": bf16_peak,
          "tf32_tensor_peak_flops": tf32_peak,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) if v.is_relative_to(ROOT)
                        else str(v) for k, v in libs.items()}})
    # flash attention's instantiations: nvcc -Xptxas -v, and tensor-core
    # instructions in the SASS (HMMA: mma.sync, HGMMA: wgmma)
    ptxas = ptxas_table(kbuild.build_log("flash_attention"))
    sass = sass_mma_counts(libs["flash_attention"])
    emit({"phase": "build", "source": "flash_attention.cu", "ptxas": ptxas,
          "sass_tensor_core_instructions": sass})
    if not ptxas or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                        for r in ptxas.values()):
        print(f"chip_smoke: flash attention spills registers: {ptxas}",
              file=sys.stderr, flush=True)
    if sass is not None and not all(c["HMMA"] + c["HGMMA"] for c in sass.values()):
        raise AssertionError(f"a flash instantiation has no tensor-core "
                             f"instruction: {sass}")
    # the segmented sum's kernel and the chain probe: registers, spills
    seg_ptxas = {k: v for k, v in
                 ptxas_table(kbuild.build_log("fused_bucket")).items()
                 if "segment_sum" in k or "fadd_chain" in k}
    emit({"phase": "build", "source": "fused_bucket.cu", "ptxas": seg_ptxas})
    laps("build")

    check_kernels(RAGGED_ROWS, bw, flops_peak, timed=False)
    full = check_kernels(FULL_ROWS, bw, flops_peak, timed=True)
    check_mlp_bucket(bw, flops_peak)
    check_per_tensor(RAGGED_N, bw, flops_peak, timed=False)
    full.update(check_per_tensor(FULL_N, bw, flops_peak, timed=True))
    for spec in FLASH_RAGGED:
        check_flash(spec, bw, flops_peak, bf16_peak, tf32_peak, timed=False)
    for spec in FLASH_FULL:
        full.update(check_flash(spec, bw, flops_peak, bf16_peak, tf32_peak,
                                timed=True))
    laps("kernels")

    # ---- the main path: phases A (mean), B (EF-sign), L (LARS) ----
    from repro_torch.telemetry.stats import round_summary
    cfg = configs.get("paper-lm")
    launches = {k: 0 for k in KERNELS}
    step_median, phase_losses, phase_wire = {}, {}, {}
    for phase, mode, lars in (("A", "none", False), ("B", "ef_sign", False),
                              ("B2", "ef_sign", False), ("L", "ef_sign", True)):
        run = phase_run(mode, cfg, seq=512, local_batch=8, lars=lars)
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launches()
        state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS)
        counts = dict(fb.LAUNCHES)
        seg_launches = fb.PORT_LAUNCHES["segment_sum"]
        losses = [h["loss"] for h in hist]
        syncs = summ["comm_rounds"]["global"]
        tokens = run.shape.global_batch * run.shape.seq_len
        rec = {"phase": phase, "model": cfg.name, "W": W, "local_batch": 8,
               "seq": 512, "sync_compression": mode,
               "optimizer": run.optim.optimizer, "base_lr": run.optim.base_lr,
               "lars_trust": run.optim.lars_trust if lars else None,
               "grad_clip": run.optim.grad_clip, "steps": STEPS,
               "loss": losses, "comm_rounds": summ["comm_rounds"],
               "step_s": step_s, "step_s_median": statistics.median(step_s[1:]),
               "tokens_per_s": tokens / statistics.median(step_s[1:]),
               "wall_s": summ["wall_s"],
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts, "segment_sum_launches": seg_launches}
        if phase == "B2":
            # phase B once more: with every sum of the port in a fixed
            # order, the same losses and buckets bit for bit
            rec.update(repeat_of="B", **b_repeat(state, b_state, losses,
                                                 phase_losses["B"]))
            del b_state
            if not rec["bit_for_bit"]:
                emit(rec)
                raise AssertionError("phase B2: phase B's run once more is "
                                     "not phase B's bit for bit")
        step_median[phase] = rec["step_s_median"]
        REFS.setdefault("peak_GB", {})[phase] = rec["peak_mem_GB"]
        phase_losses[phase] = losses
        phase_wire[phase] = summ["ledger"]["wire_bytes"]
        summary = round_summary(state.stats) if lars else None
        if lars:
            rec["round_summary"] = summary
        REFS[phase] = {"loss": losses, "comm_rounds": summ["comm_rounds"],
                       "round_summary": summary}
        if phase in ("A", "B", "L"):
            # the final params bucket, held by phase F and dropped after it
            REFS[phase]["rows"] = state.params.buckets[0]
        emit(rec)
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase {phase}: loss not finite or not "
                                 f"falling: {losses}")
        if syncs != 6:
            raise AssertionError(f"phase {phase}: {syncs} global syncs, want 6")
        comp = syncs if mode != "none" else 0
        # the segmented sum: once a compressed sync, once a LARS step
        seg_want = comp + (STEPS if lars else 0)
        if seg_launches != seg_want:
            raise AssertionError(f"phase {phase}: {seg_launches} segment_sum "
                                 f"launches, want {seg_want}")
        want = {k: 0 for k in fb.LAUNCHES}
        want.update(row_abs_sum=comp, scale_sign_rows=comp)
        if lars:
            want.update(lars_row_norms=STEPS, fused_lars_bucket=STEPS)
        else:
            want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS)
        if counts != want:
            raise AssertionError(f"phase {phase}: launches {counts}, want {want}")
        if lars:
            floats = [v for k, v in summary.items() if isinstance(v, float)]
            floats += summary["comp_rel_err"]
            if (summary["rounds"] != syncs or not summary["comp_measured"]
                    or not all(math.isfinite(v) for v in floats)):
                raise AssertionError(f"phase {phase}: telemetry {summary}")
        for k, v in counts.items():
            launches[k] += v
        launches["segment_sum"] += seg_launches
        if phase == "B":
            b_state = state
        del state
        torch.cuda.empty_cache()
        laps(phase)

    # ---- F: the tree path (plain per-leaf, tree-in/tree-out kernels) ----
    for k, v in phase_f(cfg, step_median, bw).items():
        launches[k] += v
    for p in ("A", "B", "L"):
        REFS[p].pop("rows")
    torch.cuda.empty_cache()
    laps("F")

    for k, v in phase_h(cfg, step_median["A"]).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("H")

    # ---- E: the elastic worker pool (resizes, straggler demotion) ----
    for k, v in phase_e(cfg).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("E")

    # ---- R (traced training), W (the wire pack), K (checkpoints),
    #      S (serving) ----
    r_counts, r_sync_s = phase_r(cfg, phase_losses["B"], step_median["B"])
    for k, v in r_counts.items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("R")
    for tag, run_phase in (
            ("W", lambda: phase_w(cfg, phase_losses["B"], phase_wire["B"],
                                  r_sync_s, step_median["B"])),
            ("K", lambda: phase_k(cfg)), ("S", lambda: phase_s(cfg)),
            ("S2", phase_s2)):
        for k, v in run_phase().items():
            launches[k] += v
        torch.cuda.empty_cache()
        laps(tag)

    # ---- Y: workers across processes (held against phases W, H, L) ----
    for k, v in phase_y(cfg).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("Y")

    # ---- V: workers split over shard ranks (FSDP and TP sub-buckets) ----
    for k, v in phase_v(cfg).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("V")

    # ---- Q: resizes and checkpoints across ranks (2 ranks; 2 x 2 FSDP) ----
    for k, v in phase_q(cfg).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("Q")

    # ---- M: the MoE and MLA decoders at full published width ----
    for m_run in M_RUNS:
        for k, v in phase_m(*m_run).items():
            launches[k] += v
        torch.cuda.empty_cache()
        laps(m_run[0])

    # ---- D: the dense variants at full published width ----
    for d_run in D_RUNS:
        for k, v in phase_d(*d_run).items():
            launches[k] += v
        torch.cuda.empty_cache()
        laps(d_run[0])

    # ---- Z: the recurrent families at full published width ----
    for z_run in Z_RUNS:
        for k, v in phase_z(*z_run).items():
            launches[k] += v
        torch.cuda.empty_cache()
        laps(z_run[0])

    # ---- X: the encoder-decoder and prefix-token families ----
    for x_run in X_RUNS:
        for k, v in phase_x(*x_run).items():
            launches[k] += v
        torch.cuda.empty_cache()
        laps(x_run[0])

    # ---- J: the long shapes (train_4k, prefill_32k) on the card ----
    for k, v in phase_j1(cfg, flops_peak).items():
        launches[k] += v
    laps("J1")
    phase_j2()
    laps("J2")

    launches.update(phase_t(cfg))
    torch.cuda.empty_cache()
    laps("T")

    for k, v in phase_n(cfg, step_median["B"]).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("N")
    for k, v in noise_check(cfg).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("noise")

    for lars in (False, True):
        profile_phase(phase_run("ef_sign", cfg, seq=512, local_batch=8, lars=lars))
        torch.cuda.empty_cache()
    laps("P")

    # ---- C: the trainer on the card vs on the CPU (plain versions) ----
    # Loss 1e-4 relative per step; params: all but frac_tol of the elements
    # within 1e-4 x the largest; summary floats 1e-4 relative.  Under
    # EF-sign a delta within rounding of 0 may take the other sign on the
    # other device and move its element by a whole scale.  LARS + EF-sign
    # flips more of them than SGD + EF-sign (on the CPU, rounding-level
    # changes of the starting weights alone flip more than 1e-4 of the
    # elements), so it takes frac_tol 1e-3, and the summary fields read
    # from ||mean_k x_k||^2, which each flip moves by about one element's
    # share, take 1e-2.  LARS + mean sync has no flips and takes them all.
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.utils import tree_map
    smoke = configs.get_smoke("paper-lm")
    p0 = mbase.materialize(lm.param_specs(smoke),
                           torch.Generator().manual_seed(0), "cpu")
    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    for optimizer, mode, block_steps in (("sgd", "ef_sign", 1), ("sgd", "none", 2),
                                         ("lars", "none", 1), ("lars", "ef_sign", 1)):
        lars = optimizer == "lars"
        flips = lars and mode == "ef_sign"
        frac_tol = 1e-3 if flips else 1e-4
        run = phase_run(mode, smoke, seq=64, local_batch=2, steps=6, lars=lars,
                        block_steps=block_steps)
        sg, hg, sumg, _ = train_run(run, device="cuda", steps=6,
                                    params0=tree_map(lambda t: t.to("cuda"), p0))
        sc, hc, sumc, _ = train_run(run, device="cpu", steps=6,
                                    params0=tree_map(lambda t: t.clone(), p0))
        lg, lc = [h["loss"] for h in hg], [h["loss"] for h in hc]
        loss_rel = max(rel(a, b) for a, b in zip(lg, lc))
        pg, pc = sg.params.buckets[0].cpu(), sc.params.buckets[0]
        d = (pg - pc).abs()
        frac = float((d > 1e-4 * pc.abs().max()).float().mean())
        rec = {"phase": "C", "model": smoke.name, "optimizer": optimizer,
               "sync_compression": mode, "block_steps": block_steps,
               "topology": sumg["topology"], "comm_rounds": sumg["comm_rounds"],
               "steps": 6, "loss_gpu": lg,
               "loss_cpu": lc, "loss_max_rel_diff": loss_rel, "loss_tol": 1e-4,
               "params_max_abs_diff": float(d.max()),
               "params_frac_beyond_1e-4_of_max": frac, "frac_tol": frac_tol}
        bad = []
        if lars:
            ssg, ssc = round_summary(sg.stats), round_summary(sc.stats)
            errs = {k: rel(ssg[k], v) for k, v in ssc.items() if isinstance(v, float)}
            errs["comp_rel_err"] = max(rel(a, b) for a, b in
                                       zip(ssg["comp_rel_err"], ssc["comp_rel_err"]))
            tols = {k: 1e-2 if flips and k in SYNC_MEAN_KEYS else 1e-4 for k in errs}
            bad = [k for k in errs if errs[k] > tols[k]]
            rec.update(round_summary_gpu=ssg, round_summary_cpu=ssc,
                       stats_rel_diff=errs, stats_tol=tols)
        if sumg["comm_rounds"] != sumc["comm_rounds"]:
            bad.append("comm_rounds")
        emit(rec)
        if loss_rel > 1e-4 or frac > frac_tol or bad:
            raise AssertionError(f"phase C ({optimizer}, {mode}): the trainer on "
                                 f"the card disagrees with the trainer on the CPU"
                                 f"{': ' + ', '.join(bad) if bad else ''}")

    phase_c_controllers(smoke, p0)
    phase_c_elastic(smoke, p0)
    phase_c_smoke(M_RUNS + Z_RUNS + X_RUNS)
    laps("C")

    for k, v in phase_g().items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("G")

    # ---- U: the dry-run and roofline analogues on the card ----
    for k, v in phase_u(cfg, step_median["A"], flops_peak).items():
        launches[k] += v
    torch.cuda.empty_cache()
    laps("U")

    # launches: phases A, B, L, F, H, E, R, W, K, S, Y, V and Q (every
    # rank; Y4, V4, V6 and Q3 the tree kernel form), M, D, Z, X, J1, N, G, U
    # and the noise check for the bucket kernels, T for the others; the
    # segmented sum's from phases A, B, L, F, Y, V and Q
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel was not launched on its path: {launches}")
    emit({"phase": "seconds", "by_phase": laps.by_phase,
          "script_s": time.perf_counter() - laps.start})
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/" + KERNELS[k][1],
         "replaces": "src/repro/kernels/" + KERNELS[k][0],
         "launches": launches[k], "max_abs_err": full[k]["max_abs_err"],
         "ms": full[k]["ms"], "plain_ms": full[k]["plain_ms"],
         "bound_ms": full[k]["bound_ms"], "bound_by": full[k]["bound_by"],
         "library_ms": full[k]["library_ms"]}
        for k in KERNELS]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
