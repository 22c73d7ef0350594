#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --signsgd-round   # only the signSGD round's phases
    python3 chip_smoke.py --paper-codecs    # only phase 7
    python3 chip_smoke.py --buffered        # only phase 8
    python3 chip_smoke.py --chunked         # only phase 9
    python3 chip_smoke.py --drift-witness   # phase 9's runs, one ulp apart
    python3 chip_smoke.py --events          # only phase 10
    python3 chip_smoke.py --mesh            # only phase 11
    python3 chip_smoke.py --serve           # only phase 12
    python3 chip_smoke.py --moe             # only phase 13
    python3 chip_smoke.py --zoo             # only phase 14
    python3 chip_smoke.py --dryrun          # only phase 15
    python3 chip_smoke.py --tensor-parallel # only phase 16
    python3 chip_smoke.py --select-study    # bin_select's routes and steps
    python3 chip_smoke.py --wire-study      # golomb_decode and pack_chunks

Needs one CUDA card and ``nvcc``; fails without them.  Phases:

1. build the nine CUDA sources from ``src/repro_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, in parallel) and print the
   registers and shared memory (``-Xptxas -v``) of the histogram,
   ``bin_select``, ``pack_bits``, ``pack_chunks``, ``unpack_bits``,
   ``golomb_decode``, ``threshold_stats`` and ``bisect_select``, the
   atomics, conversions and fp64 adds in the histogram's SASS, and the
   atomics, votes, cluster barriers and bulk copies in ``bin_select``'s;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and on adversarial inputs: ``stc_apply`` bitwise,
   histogram counts exact and sums within rtol 1e-6 (normal, skewed and
   all-zero rows; two calls identical; one device operation a call),
   the candidate-bin select ``bin_select`` ``v`` and count bitwise and sums
   within rtol 1e-6 (two calls identical) on normal, carried-like (~99 %
   in bin 0), skewed, tied, constant, all-zero and fewer-non-zeros-than-k
   rows and per-row k, selection threshold and count exact (also against
   the ``"torch"`` route and the CPU), ``pack_bits`` (one plane and
   batches whose rows start off 16-byte boundaries),
   ``pack_sign_planes`` (rows of ±step with -0.0, subnormals, ±inf and
   NaN) and ``pack_chunks`` words identical (also to the host packer),
   ``unpack_bits`` bits and zero counts identical (also to the host
   unpack, one plane and batches), ``sign_plane_tally`` bitwise its plain
   version and the host accumulator's loop, ``golomb_decode``
   fields identical and raising on the same inputs (valid batches, the
   decoder's chunk-boundary traps, a cnn round, 300 corrupt batches and
   the 60 mutations of the reference's wire fuzz test), ``threshold_stats``
   counts exact and sums within rtol 1e-6 (two calls identical), the fused
   bisection ``bisect_select`` ``lo`` and count bitwise its plain version's
   (on the card and on the CPU) and sums within rtol 1e-6 (two calls
   identical) at the cnn's n, on the edge cases of
   ``tests/_bisect_cases.py``, a subnormal row and 4,000,037 elements,
   ``selector="bisect"`` under ``set_sync_debug_mode("error")`` and giving
   the ``"hist"`` mask; every selection check also runs on rows of
   subnormals, which count as zeros (the reference's flush-to-zero);
3. the dense path: train the paper CNN at full width with STC (the
   configuration of ``examples/federated_noniid.py``: 10 clients, 2
   classes each, p = 1/50 up and down, lr 0.05, 40 rounds) through
   ``backend="kernel"`` and ``wire_backend="kernel"``, with the launch
   counters set to 0 just before; then the same run on the CPU with the
   plain versions; final accuracy must agree within 0.03 and upstream bits
   within 2 %, and ``stc_apply``, the histogram, ``bin_select`` and
   ``pack_chunks`` must have launched (the histogram and ``bin_select``
   twice a round: the clients' encode and the server's STC; ``pack_chunks``
   twice a round: the upstream batch and the downstream message); the card
   run prints, round by round, each selection's candidate bin and its
   population, and how many of them the old refinement (``torch.topk``
   with ``cap = 8192``) would have sent to its full-row ``torch.sort``;
   then, from the trained state, 3 lock-step rounds of
   the card's encode, apply and ledger phases against the CPU's on the
   same inputs (positions, signs, counts and wire words exact, µ within
   rtol 1e-6, residuals and parameters within 1e-6 of ``|value| + µ``),
   ``pack_chunks`` on the chunks of the last round's upstream batch, and
   ``bin_select`` against its plain version on the last round's carried
   matrices, the clients' (10, n) and the server's (1, n); then
   ``stc_compress_batch`` on those matrices under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronization)
   and the selection under ``torch.profiler`` (no ``aten::topk``,
   ``aten::sort`` or ``aten::kthvalue``);
4. the ingest path: the same run with ``TrainerConfig(ingest=True)`` (the
   fused server ingest, decoding the ternary wire through
   ``golomb_decode``), card against CPU as in 3, with ``golomb_decode``
   launched at least once a round, ``unpack_bits`` never, and the three
   kernels of 3 launched; then 3 lock-step ingest rounds on the card's
   messages (accumulator sum bitwise the CPU's, global-delta positions and
   signs exact, µ within rtol 1e-6), and ``golomb_decode`` on the last
   one's batch against its plain version and the numpy scan; then signSGD
   through the same ingest (``wire_backend="kernel"``): one
   ``pack_sign_planes`` launch (the round's upstream batch) and one
   ``sign_plane_tally`` launch (the ingest) a round and no ``pack_bits``
   or ``unpack_bits``, 3 lock-step rounds card against CPU with wire
   batches (also the host packer's), unpacked bits, accumulator (also the
   host backend's) and global delta identical, and both kernels on the
   last one's messages and words;
5. the bisection path: ``stc_compress_kernel(selector="bisect")`` at the
   cnn's width, which must launch ``bisect_select`` once, ``stc_apply``
   once and ``threshold_stats`` never; then ``threshold_stats`` through
   its own entry point at the selected threshold (one launch, a check
   only: no path launches ``threshold_stats``, and its row's count is the
   path's, 0);
6. time each kernel and its plain version with CUDA events (device time:
   the stream is held while the host enqueues) beside the library call
   that computes the same function where there is one (the histogram on
   the carried matrices of a lock-step round and on a normal matrix, and
   at 1, 2 and 4 CTAs an SM; ``bin_select`` on those carried matrices
   beside ``torch.topk``, with its route (``select_plan``) and the
   kernel's own count of the elements of x it read: one read a row on the
   cluster route, and three on a constant (1, 4,000,037) row, the
   two-read route's overflow path; then in a fresh process
   (``--select-passes``) each route's launches by ``torch.profiler`` at
   the paths' shapes: the cluster route's one kernel, the two-read route's
   three passes, one launch each and nothing else;
   ``pack_chunks`` on a real round's upstream chunks and ``golomb_decode``
   on an ingest round's batch, with the plan, the wrapper and the wire
   backend's decode host included, and in a fresh process
   (``--wire-passes``) the decode's launches at the paths' shapes (one
   launch of one kernel) and ``pack_chunks``'s device operations (exactly
   one, no memset); the sign-plane
   kernels on a signSGD round's messages and words, beside ten one-plane
   launches and, for the tally, the host loop it replaces;
   ``bisect_select`` per step and host included, beside ``torch.topk``,
   and at n = 17 and n = 4,000,037 beside it),
   the k-selections beside ``torch.topk`` (on the carried matrices host
   included and in device time, on a normal matrix host included), and a
   dense and an
   ingest round split into phases (with the ``"kernel"`` and the host
   wire backends, in turns), and the ingest decode of one round's batch
   split into words up, the decode with its fields down (one copy) and
   ``np.add.at``, beside
   the numpy field scan on the same batch, and a signSGD ingest round split
   into phases (both wire backends, in turns).

7. the paper's comparison codecs on the same cnn and data: ``baseline``,
   ``fedavg`` (10 local iterations a round), ``topk`` (p = 1/50 up) and
   ``ternquant``, at lr 0.01 (at the demo's 0.05 their training is
   unstable: FedAvg reaches NaN, in the JAX package too, and card and CPU
   part ways), 20 local iterations each (fedavg: 2 rounds) on the card
   (counters set to 0 just before) and on the CPU from the same initial
   parameters: accuracy within 0.03 and the four analytic ledger columns
   equal; top-k launches the histogram and ``bin_select`` exactly once a
   round and nothing else, the other three no kernel; then 3 lock-step
   rounds card vs CPU (top-k messages, masks, counts and residuals
   bitwise; baseline and FedAvg messages bitwise; TernQuant masks exact,
   client and server side, and µ within rtol 1e-6), and each codec's
   round split into ``local_sgd``, ``encode``, ``apply`` and ``ledger``;
8. the buffered trainer: STC (p = 1/50 both ways) under
   ``BufferedFederatedTrainer`` with the default ``LatencyModel`` and a
   deadline of 0.5 (its median latency), 10 rounds on the dense route and
   with ``TrainerConfig(ingest=True)``, card and CPU: ``arrival_log``
   identical, accuracy within 0.03, ``bits_up`` within 2 %, and the
   launches the arrival log implies (the clients' STC every round, the
   server's each round that aggregated, one ``golomb_decode`` an ingested
   arrival); whole rounds timed; then ``deadline=inf`` against the
   synchronous trainer on the card, 3 rounds a route: parameters, ledger
   and wire log bitwise;
9. the chunked codec states and the adaptive controllers on the same cnn
   at lr 0.05: ``chunks="whole"`` against the flat trainer on the card (5
   rounds; parameters, ledger and wire log bitwise); then
   ``chunks=4096`` (79 chunks in 6 width groups), 40 rounds on the dense
   and the ingest route, card (counters set to 0 just before) against CPU
   (accuracy within 0.03, ``bits_up`` within 2 %, analytic columns equal,
   the upstream messages' non-zeros summed over the run within rtol 1e-4:
   every chunk keeps its fixed k, ties aside), the launch log showing one
   histogram, ``bin_select`` and ``stc_apply`` launch a round at (790,
   4096) and at (79, 4096), two ``pack_chunks`` a width group a round (up
   and down) and on the ingest route one ``golomb_decode`` a width group a
   round; one round of each under
   ``torch.profiler`` (two of each STC kernel, no ``topk``/``sort``); 3
   lock-step rounds from the trained dense state (both selections'
   thresholds and counts, masks, wire words and the ingest accumulator
   exact, µ within rtol 1e-6), ``bin_select`` against its plain version at
   both shapes and ``stc_compress_blocks`` with host and device ks under
   ``set_sync_debug_mode("error")``; then ``residual_mass`` (budget 1.0)
   and ``snr_constant`` (snr 3, ema 0.5), 40 dense rounds card against CPU
   (at 10 and 20 rounds the cnn is still unconverged and card and CPU
   parted by up to 0.21 in accuracy while their lock-step rounds were
   exact; ``--drift-witness`` measures how far one ulp moves a run there),
   each with 2 lock-step rounds (per-chunk ks and EMA states identical, the
   dynamic selection exact, the adaptive encode under
   ``set_sync_debug_mode("error")`` with one launch of each STC kernel);
   then the chunked rounds split into phases and the STC kernels timed at
   the chunked shapes beside their bounds, ``golomb_decode`` on the largest
   width group's sub-streams.

10. the event-driven server (``EventDrivenTrainer``) on the same cnn and
   STC setting as 3: with its defaults (K = cohort, scenario "steady") 10
   aggregations on the dense and the ingest route, parameters, ledger and
   wire log bitwise the card's ``FederatedTrainer`` of 10 rounds; an
   asynchronous fleet (K = 5, concurrency 10, max_staleness 8) on the
   ingest route at lr 0.01 (at 0.05 its two aggregations a cohort make
   training swing), 40 aggregations card against CPU: the event schedule (the
   event log but its measured ``bits_up``) and the aggregation log
   identical, accuracy within 0.03, ``bits_up`` within 2 %, and exactly
   the launches the logs imply (two ``golomb_decode`` an admitted arrival:
   validation and ingest); ``mean``, ``coordinate_median`` and
   ``trimmed_mean`` under a 20 % sign-flip attack at 10x, 20 aggregations
   each (accuracies printed), with 3 lock-step combines of the same buffer
   card against CPU, bitwise; the norm screen (reject above 3x the median
   honest wire norm of aggregation 0) on the ingest route under a 20 %
   scale attack at 100x, 20 aggregations card against CPU: the screened
   counts equal, above 0 in every aggregation with a Byzantine arrival;
   a server kill at event 37 with a checkpoint every 5 events, resumed
   into a fresh trainer to 20 aggregations: parameters, ledger, event,
   aggregation and quarantine logs bitwise an uninterrupted card run; and
   each route's aggregation split into phases.

11. the mesh trainer (``repro_torch.launch.train``) at SmolLM-135M's full
   width (d 576, 9 heads with 3 kv heads, d_ff 1536, vocab 49,152, tied),
   its depth cut from 30 layers to 10 (63,713,088 parameters; the whole
   script's time), the reference CLI's STC
   setting (p = 1/50 both ways, lr 0.05, bf16 compute) on
   ``make_lm_tokens(seed=0)`` in a 4 x 128 batch: one client with no
   client axes, 10 steps (counters set to 0 just before): the loss finite
   and falling, ``nnz_up`` / ``nnz_down`` k = 1,274,261 or k plus ties
   (printed), and the histogram, ``bin_select`` and ``stc_apply`` each
   launched exactly twice a step at (1, 63,713,088) and nothing else; from
   that state the card's tree STC (encode and decode, also through the
   codec) against the ``"torch"`` route on the CPU on the same trees
   (thresholds, counts, positions and signs exact, µ within rtol 1e-6, the
   excess over k ties at the threshold); the three kernels held against
   their plain versions at (1, 63,713,088) and timed beside their bounds
   and library calls (``bin_select`` on its two-read route, the kernel's
   own count of reads exactly two reads of x, beside the floor of two
   reads; so at every mesh row of phases 13 and 14); the
   step split into phases (median of 5) and the
   ``WireLedger`` over 2 steps; then two client ranks (gloo, both on the
   card, half the batch each), 3 steps and a masked step (1, 0), bitwise
   the same composition in one process (two local steps, two
   ``tree_encode``, (a + b) / 2, ``tree_decode``), rank 1's residual
   unchanged by the masked step, and ``all_gather`` of CUDA tensors
   through gloo checked.

12. the LM's serve path (``repro_torch.launch.serve``) at SmolLM-135M's
   full width and phase 11's depth (10 layers), serving phase 11's
   trained weights (alone: ``init_model`` of that config, seed 0),
   counters set to 0 just before and none of the port's kernels launched
   (the serve path has no Pallas kernel in the reference either): the
   weights through ``save_checkpoint`` ->
   ``restore_checkpoint``, bitwise (file bytes and seconds printed); a
   64-token prompt (batch 2) teacher-forced through ``make_decode_step``
   at fp32, each step's logits against ``forward``'s within rtol 5e-3 /
   atol 2e-3 (the reference's own decode test), and against the same
   steps on the CPU within rtol 1e-4 / atol 1e-4 (about 25x the fp32
   summation-order gap of decode against forward, which it prints); 32 greedy
   steps on the card with the CPU decoding the card's tokens, argmax equal
   wherever the top-2 gap exceeds twice that tolerance; a sliding window
   of 64 (``s_cache`` 256: rings of 64) over 200 tokens against the
   windowed ``forward``; bf16 ``make_prefill_step`` at (4, 512) against a
   bf16 teacher-forced decode's last logits within 0.05 of the largest
   logit; then the prefill of one 32,768-token prompt (prefill_32k's
   length, batch cut from 32 to 1) and the decode step at batch 64 (cut
   from decode_32k's 128) against a 32,768-slot bf16 cache of 16.1 GB,
   seeded random, ``idx`` at 32,768 - 24: 8
   warm-up steps, one under ``set_sync_debug_mode("error")`` (no host sync
   in a step) and one under ``torch.profiler`` (device time, idle share,
   longest operations), then 16 timed steps beside the bytes bound.

13. the MoE family (``models/moe.py``, ``models/mla.py``): DeepSeek-V2-Lite
   at full width (d 2,048, 16 heads, MLA kv_lora 512, qk 128 + 64, v 128;
   64 routed experts, top-6, d_expert 1,408, 2 shared; the first layer
   dense at d_ff 10,944; vocab 102,400, untied), depth cut from 27 to 3
   layers (1,670,133,760 parameters; the trainer holds about seven fp32
   copies of them).  One MoE FFN at full width on a (2, 128) fp32 input
   card against CPU (experts equal wherever the 6th and 7th router
   probabilities are more than 1e-6 apart, outputs and aux loss within
   1e-4 of the largest magnitude) and ragged against capacity dispatch at
   factor 8 within 3e-5; the mesh trainer in phase 11's setting, one
   client, 5 steps (counters set to 0 just before): the loss finite and
   falling, ``nnz`` k = 33,402,675 plus ties, the histogram, ``bin_select``
   and ``stc_apply`` each exactly twice a step at (1, 1,670,133,760) and
   nothing else; two local SGD runs from one state bitwise equal with no
   deterministic-mode warning; the step split into phases with its host
   syncs counted; the three kernels against their plain versions at that
   row and timed beside their bounds; then serving the trained weights
   from memory: a 64-token fp32 prompt teacher-forced against ``forward``
   on the card and for 16 steps against the CPU, bf16 prefill at (4, 512)
   against a bf16 decode, the prefill of one 32,768-token prompt and the
   decode step at decode_32k's batch of 128 against a 32,768-slot bf16
   latent cache of 14.5 GB (exactly one host sync a MoE layer, under
   ``torch.profiler``, 16 timed steps beside the bytes bound); and
   ``granite-moe-3b-a800m`` and ``moonshot-v1-16b-a3b`` at their smoke
   configs card against CPU at fp32 (a forward, a train step, 8 decode
   steps).

14. the rest of the model zoo (``models/ssm.py``, ``models/rglru.py``, the
   encoder and the prefix): Mamba-2-370M at full width (d 1,024, 32 SSD
   heads of 64, d_state 128, chunk 256; vocab 50,280, tied), depth cut
   from 48 to 24 layers (209,857,792 parameters), and RecurrentGemma-2B
   at full width (d 2,560, 10 heads of 256 with one kv head, window
   2,048, d_ff 7,680 gelu; vocab 256,000, tied), depth cut from 26 to 6
   layers, two (rglru, rglru, local) periods (1,025,067,520 parameters);
   whisper-medium at full width, 12 encoder and 12 decoder layers of 24
   (458,604,544), and internvl2-2b at full width, 12 layers of 24
   (1,138,317,312): the depths cut for the script's time.  For each:
   its recurrent block at full width on a (2, 512) fp32 input (two SSD
   chunks) card against CPU within 1e-4 of the largest magnitude; the mesh
   trainer in phase 11's STC setting on a 4 x 1,024 batch (four SSD chunks
   a sequence), one client, 5 steps (counters set to 0 just before): the
   loss finite and falling, ``nnz`` k plus ties, the histogram,
   ``bin_select`` and ``stc_apply`` each exactly twice a step at (1,
   numel) and nothing else; two local SGD runs bitwise equal with no
   deterministic-mode warning; the step split into phases with its host
   syncs counted; the three kernels against their plain versions at that
   row and timed beside their bounds; serving the trained weights from
   memory: a 64-token fp32 prompt teacher-forced against ``forward`` (the
   SSD at rtol 5e-3 / atol 5e-3, the reference's SSD tolerance) and for
   16 steps against the CPU, bf16 prefill at (4, 512) against a bf16
   decode, the prefill of one 32,768-token prompt, the decode step at
   decode_32k's batch of 128 against the recurrent states (the hybrid's
   local layers: rings of 2,048) under ``set_sync_debug_mode("error")``
   and ``torch.profiler``, 16 timed steps beside the bytes bound (the
   states read and written back); ``init_cache`` at long_500k's length
   allocating on the card what it does at decode_32k's.  Then
   ``whisper-medium`` (stub frames, decode against ``encode_frames``'
   memory) and ``internvl2-2b`` (a patch prefix) at their smoke configs
   card against CPU at fp32 as in 13.

15. the dry run (``repro_torch.launch.dryrun``): ``lower_combo`` for every
   arch x input shape on the production mesh (16x16), the multi-pod mesh
   (2x16x16) and one card (``make_debug_mesh(1, 1)``), on the meta
   device, a line a record (argument GiB, FLOPs a device, the H100
   roofline terms, whether the arguments fit in 80 GB); then
   ``measured_ingest_bytes`` through the ``"kernel"`` wire backend on the
   card (counters set to 0 just before: ``pack_chunks`` launched) equal
   to the numpy route's bytes.  Phases 11, 13 and 14 hold the dry run to
   the card: the bytes ``init_train_state`` asks the caching allocator
   for (its ``requested_bytes`` stat) equal the record's state bytes for
   the same cut config on one card (within 512 B a leaf), and so do the
   recurrent archs' decode_32k caches; phase 11 counts one step of the
   SmolLM trainer under ``torch.utils.flop_counter.FlopCounterMode``,
   requires the record's ``flops`` exactly, and prints the count over the
   step's median time as TFLOP/s and as a share of the 989 TFLOP/s bf16
   peak.
16. tensor parallelism in the mesh trainer: Qwen2-0.5B at full width and
   depth (494,032,768 parameters), on
   ``make_debug_mesh(data=1, model=2)``, two gloo ranks on ``cuda:0``, STC
   p = 1/50 both ways (k = 9,880,655),
   lr 0.05, bf16, remat, the 4 x 128 batch of ``make_lm_tokens(seed=0)``.
   Each rank: ``init_train_state`` asks the allocator for exactly the dry
   run's per-device state bytes on that mesh; the first step's carried
   tree, selected split across the ranks, against the flat
   ``stc_compress_rows`` of the joined row (threshold, count, positions,
   signs exact; µ within rtol 1e-6); the three STC kernels at the path's
   rows (the owned and local rows, the gathered candidate row) against
   their plain versions and timed; 5 steps with the counters at 0: the
   loss finite and falling, the histogram, ``bin_select`` and
   ``stc_apply`` exactly twice a step on each rank, the replicated leaves
   bitwise equal across the ranks after every step, what each rank hands
   gloo by kind; one step's ``FlopCounterMode`` count equal to the dry
   run's per-device ``flops``; 2 steps under ``measure_wire`` whose
   ``WireLedger`` bits on the card (``pack_chunks``) equal the numpy
   route's; an fp32 step against the ``model = 1`` step of the same
   parameters and batch (loss within rtol 1e-5, ``nnz_up`` within the
   magnitudes at the threshold); the step's and local SGD's times, the
   device idle share, each rank's peak memory.  Then each rank serves its
   trained shard from head-sharded caches (one KV head a rank):
   fp32 prefill and decode (a 64-token prompt, 8 greedy steps) against the
   ``model = 1`` steps on the joined weights (rtol 1e-4 / atol 1e-4, greedy
   tokens equal where the top-2 gap exceeds twice that), bf16 prefill
   against bf16 decode (within 0.05 of the largest logit), both ranks'
   logits bitwise equal, the caches' requested bytes equal to
   ``serve_state_structs``' per-device stand-ins, the prefill at (1, 8,192)
   and the decode at batch 64 against 4,096 slots timed, a decode step
   with no host sync but gloo's own staging (``set_sync_debug_mode`` off
   only inside each collective), its ``2·24 + 2`` collectives equal to the
   dry run's, its device time and idle share.  Then the same on heads cut
   mid-head (the attention's gather route): SmolLM-135M at full width, its
   depth cut to phase 11's 10 layers (63,713,088 parameters, k =
   1,274,261), on ``make_debug_mesh(data=1, model=4)``, four gloo ranks,
   each with 144 of ``wq``'s 576 columns (2.25 query heads) and 48 of
   ``wk``'s 192 (0.75 of a KV head); every check above but the
   ``WireLedger``, the fp32 step on a 4 x 32 batch, what a step hands
   gloo (the gather route's ``all_gather`` s too) equal to the dry run's,
   the four ranks' logits bitwise equal, a whole cache on every rank, and
   ``3·10 + 2`` collectives a decode step.

``--signsgd-round`` runs the last of the timings of 6 alone on the package
of the tree the file sits in: a copy inside a parent checkout unpacked
beside the change times the parent.  ``--paper-codecs``, ``--buffered``,
``--chunked``, ``--events``, ``--mesh``, ``--serve``, ``--moe``, ``--zoo``
``--dryrun`` and ``--tensor-parallel`` run phase 7, 8, 9, 10, 11, 12, 13,
14, 15 or 16 alone.
``--select-study`` times ``bin_select`` at the paths' shapes (like
``--signsgd-round``, on the package of the tree the file sits in) and, on
a package of two routes, each cnn and chunked shape on the two-read route
and in clusters of 16 beside its own route, the clusters' occupancy and
the cluster kernel's steps from a stamped build.  ``--select-passes`` is
the fresh process in which phase 6 profiles ``bin_select``'s launches.
``--wire-study`` times ``golomb_decode``'s launch and the wire backend's
decode (host included) at the paths' shapes and on a segment longer than
a cluster's tile, and ``pack_chunks`` on a cnn round's upstream chunks, on
the package of the tree the file sits in (like ``--signsgd-round``), and
on a package with ``decode_plan`` also the decode in every cluster size.
``--wire-passes`` profiles the two wire kernels' device operations; phase
6 runs it and ``--select-passes`` in one fresh process, and the passes
left in a new one (at most ``PASS_PROCESSES``) where the profiler
recorded no device activity at all in a process.
``--drift-witness`` trains phase 9's dense and ``residual_mass`` runs 20
rounds on the card twice, on the card and the CPU with one parameter and
with every parameter moved by one ulp, on the CPU, and on the CPU with one
thread, and prints their accuracies every 5 rounds: how far the card's own
variation and ulps on one device part two runs, beside the card-CPU gap.

Prints the timing lines, the TF32 flags, the card's name and power limit,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 peak
FLT_MIN = 1.1754943508222875e-38  # the least normal fp32
MAIN_ROWS, MAIN_N = 10, 307_434  # cohort x cnn parameters
P_STC = 1 / 50
ROUNDS = 40


class Failure(Exception):
    pass


class ProfilerBlind(Failure):
    """``torch.profiler`` recorded no device activity at all, in every
    session, for a call that launches kernels: the measurement failed, not
    the kernel.  A pass process exits with ``BLIND_RC`` on it, and the
    passes it did not finish run again in a fresh process."""


BLIND_RC = 75          # a pass process's exit code on ProfilerBlind
PASS_PROCESSES = 3     # fresh processes a pass flag may take


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1

FP64_SHARED_ATOMIC_PROBE = r"""
__global__ void probe(const double* x, double* out) {
  __shared__ double acc;
  if (threadIdx.x == 0) acc = 0.0;
  __syncthreads();
  atomicAdd(&acc, x[threadIdx.x]);
  __syncthreads();
  if (threadIdx.x == 0) *out = acc;
}
"""


def sass_opcodes(cuobjdump: str, binary: Path, prefixes) -> dict:
    """Counts of the SASS instructions of ``binary`` whose opcode starts
    with one of ``prefixes``."""
    import re
    out = subprocess.run([cuobjdump, "-sass", str(binary)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    ops = re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", out)
    counts: dict = {}
    for op in ops:
        if op.startswith(tuple(prefixes)):
            counts[op] = counts.get(op, 0) + 1
    return counts


def print_build_notes() -> None:
    """``-Xptxas -v`` of the eight redesigned kernels, the atomics,
    conversions, fp64 adds and votes in the histogram's SASS, the atomics,
    votes, cluster barriers and bulk copies in ``bin_select``'s, and the SASS
    of a plain fp64 ``atomicAdd`` to shared memory (whether it compiles to
    a compare-and-swap loop)."""
    from repro_torch.kernels import _build
    for name in ("histogram", "bin_select", "pack_bits", "pack_chunks",
                 "unpack_bits", "golomb_decode", "threshold_stats",
                 "bisect_select"):
        notes = [line.split(":", 1)[-1].strip()
                 for line in _build.build_log(name).splitlines()
                 if "Used" in line or "spill" in line]
        print(f"ptxas -v {name}: {' | '.join(notes)}")
    nvcc = Path(_build._nvcc())
    cuobjdump = str(nvcc.parent / "cuobjdump")
    atomics = ("ATOM", "RED.", "CAS")
    try:
        lib = _build.build_all(("histogram",))["histogram"]
        ops = sass_opcodes(cuobjdump, lib,
                           atomics + ("F2I", "F2F", "DADD", "VOTE"))
        print(f"histogram SASS atomics, conversions, fp64 adds and votes: "
              f"{json.dumps(ops)}")
        lib = _build.build_all(("bin_select",))["bin_select"]
        ops = sass_opcodes(cuobjdump, lib, atomics + ("VOTE", "MATCH",
                                                      "UCGABAR", "UBLKCP"))
        print(f"bin_select SASS atomics, votes, cluster barriers and bulk "
              f"copies: {json.dumps(ops)}")
        src = _build.BUILD_DIR / "probe_fp64_shared_atomic.cu"
        src.write_text(FP64_SHARED_ATOMIC_PROBE)
        cubin = src.with_suffix(".cubin")
        subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-cubin", "-O3", "-o", str(cubin), str(src)],
                       capture_output=True, text=True, timeout=120,
                       check=True)
        print(f"fp64 atomicAdd to shared memory, SASS atomics: "
              f"{json.dumps(sass_opcodes(cuobjdump, cubin, atomics))}")
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"SASS not read: {exc}")


# ---------------------------------------------------------------- phase 2

def check_kernels(torch, np, rk):
    """Each kernel against its plain version on the same card inputs."""
    from repro_torch.core.compression import get_stc_backend
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {}

    def rows(shape, scale=1e-3):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    n_adv = 20_000
    ties = np.where(rng.random(n_adv) < 0.5, 1.0, rng.uniform(0, 0.5, n_adv))
    extreme = 10.0 ** rng.uniform(-30, 30, n_adv)
    few = np.zeros(n_adv)
    few[rng.choice(n_adv, 7, replace=False)] = rng.standard_normal(7)
    adversarial = torch.from_numpy(np.stack([
        ties * np.sign(rng.standard_normal(n_adv)),
        np.full(n_adv, 0.25),                       # constant row
        extreme * np.sign(rng.standard_normal(n_adv)),
        np.zeros(n_adv),                            # all-zero row
        few,                                        # fewer non-zeros than k
        rng.standard_normal(n_adv),
        subnormal_row(np, rng, n_adv),              # subnormals as zeros
        rng.standard_normal(n_adv) * 1e-40,         # all subnormal
    ]).astype(np.float32)).to(dev)

    torch_select = get_stc_backend("torch").select_batch
    k_main = max(int(MAIN_N * P_STC), 1)
    sets = [(rows((MAIN_ROWS, MAIN_N)), k_main),
            (rows((1, MAIN_N), 1e-4), k_main),
            (skewed(torch, np, rng, MAIN_ROWS, MAIN_N), k_main),
            (carried_like(torch, np, rng, MAIN_ROWS, MAIN_N), k_main),
            (carried_like(torch, np, rng, 1, MAIN_N), k_main),
            (adversarial, 100),
            (adversarial, 1),
            (adversarial, n_adv),
            (adversarial, np.array([1, 100, 7, 20_000, 5_000, 6_148, 300,
                                    5]))]
    hist_err = sel_err = apply_err = select_err = 0.0
    for x, k in sets:
        scale = row_scale(torch, x)
        hist_err = max(hist_err, check_histogram(torch, rk, x, scale))

        t_k, c_k, s_k = rk.hist_topk_threshold_batched(x, k)
        t_o, c_o, s_o = torch_select(x, k)
        t_c, c_c, _ = rk.hist_topk_threshold_batched(x.cpu(), k)
        require(torch.equal(t_k, t_o) and torch.equal(t_k.cpu(), t_c),
                f"selection threshold differs k={k}")
        require(torch.equal(c_k, c_o) and torch.equal(c_k.cpu(), c_c),
                f"selection count differs k={k}")
        require(torch.allclose(s_k, s_o, rtol=1e-6, atol=0.0),
                f"selection sum beyond rtol 1e-6 k={k}")
        sel_err = max(sel_err, float((s_k - s_o).abs().max()))
        select_err = max(select_err, check_bin_select(torch, rk, x, k))

        mu = s_k / torch.clamp(c_k, min=1).to(torch.float32)
        tern_k, res_k = rk.stc_apply_batched(x, t_k, mu)
        tern_p, res_p = rk.stc_apply_plain(x, t_k, mu)
        require(torch.equal(tern_k, tern_p) and torch.equal(res_k, res_p),
                f"stc_apply not bitwise equal k={k}")
        apply_err = max(apply_err, float((tern_k - tern_p).abs().max()))
    errs["stc_apply"], errs["histogram"] = apply_err, hist_err
    errs["selection"], errs["bin_select"] = sel_err, select_err

    x, scale = skewed(torch, np, rng, MAIN_ROWS, MAIN_N, scale=True)
    ops = device_ops(torch, lambda: rk.magnitude_histogram_batched(x, scale))
    require(ops is None or len(ops) == 1,
            f"the histogram ran {len(ops or ())} device operations, not 1: "
            f"{ops}")
    print(f"histogram: device operations in one call (torch.profiler): "
          f"{ops if ops is not None else 'not seen by the profiler'}")
    errs["pack_bits"] = max(
        [check_pack_bits(torch, np, rk, rng, m)
         for m in (1, 31, 32, 1_000_003, 2_400_000)]
        + [check_pack_bits(torch, np, rk, rng, m, rows)
           for rows, m in ((3, 1), (3, 33), (10, 1000), (10, MAIN_N),
                           (4, 4096), (2, 1_000_003))])
    errs["pack_sign_planes"] = max(
        check_pack_sign_planes(torch, np, rk, sign_rows(np, rng, rows, n))
        for rows, n in ((1, 1), (3, 31), (3, 33), (10, 1000),
                        (1, MAIN_N), (MAIN_ROWS, MAIN_N), (2, 1_000_003)))
    errs["pack_chunks"] = max(
        check_pack_chunks(torch, np, rk, *chunk_set(np, rng, count, gaps))
        for count, gaps in ((1, False), (33, True), (61_480, True),
                            (1_000_003, False)))
    t0 = time.perf_counter()
    errs["pack_chunks"] = max(
        [errs["pack_chunks"]] + [check_pack_chunks(torch, np, rk, *edge)
                                 for edge in pack_edge_sets(np, rng)])
    print(f"pack_chunks: 4 random sets and 5 edge sets bitwise its plain "
          f"version and the host scatter, one launch a call, two calls "
          f"identical (edge sets {time.perf_counter() - t0:.2f} s)")
    errs["unpack_bits"] = max(
        [check_unpack_bits(torch, np, rk, rng, w)
         for w in (1, 2, 9608, 1_000_003)]
        + [check_unpack_bits(torch, np, rk, rng, w, rows)
           for rows, w in ((3, 1), (MAIN_ROWS, 9608))])
    errs["sign_plane_tally"] = max(
        check_sign_plane_tally(
            torch, np, rk, rng, rng.integers(0, 1 << 32, (rows, w),
                                             dtype=np.uint64)
            .astype(np.uint32), rng.uniform(0, 2, rows))
        for rows, w in ((1, 1), (3, 2), (MAIN_ROWS, 32), (MAIN_ROWS, 9608),
                        (64, 9608)))
    errs["golomb_decode"] = check_golomb_cases(torch, np, rk)
    errs["threshold_stats"] = check_threshold_stats(torch, np, rk, rng)
    errs["bisection"] = check_bisection(torch, np, rk, rng)
    torch.cuda.synchronize()
    return errs


def skewed(torch, np, rng, n_rows, n, scale=False):
    """Rows like the carried deltas at their most skewed: one outlier a row
    and every other magnitude below 1/256 of it (bin 0); the last row all
    zero.  With ``scale`` also the k-selection's scale."""
    x = np.clip(rng.standard_normal((n_rows, n)) * 1e-3, -3e-3, 3e-3)
    x[np.arange(n_rows), rng.integers(0, n, n_rows)] = 1.0
    x[-1] = 0.0
    x = torch.from_numpy(x.astype(np.float32)).to("cuda")
    if not scale:
        return x
    return x, row_scale(torch, x)


def subnormal_row(np, rng, n):
    """N(0, 1)·1e-40 subnormals with ~1 % N(0, 1) values and ~1 % values
    within a factor 4 of FLT_MIN on either side (float64; the caller
    casts)."""
    x = rng.standard_normal(n) * 1e-40
    x[rng.integers(0, n, n // 100)] = rng.standard_normal(n // 100)
    x[rng.integers(0, n, n // 100)] = rng.uniform(-4, 4, n // 100) * FLT_MIN
    return x


def carried_like(torch, np, rng, n_rows, n):
    """Rows like a trained cnn's carried residuals: one outlier a row,
    about 1 % of the row in the bins above 0 and the rest, about 99 %, in
    bin 0."""
    x = np.clip(rng.standard_normal((n_rows, n)) * 1e-3, -3e-3, 3e-3)
    x[:, rng.integers(0, n, n // 100)] *= 200.0
    x[np.arange(n_rows), rng.integers(0, n, n_rows)] = 1.0
    return torch.from_numpy(x.astype(np.float32)).to("cuda")


def select_inputs(torch, x, k):
    """``(scale, b, r, cnt_b)``: what ``hist_topk_threshold_batched`` hands the
    candidate-bin select for ``x`` and ``k``, made on the card."""
    from repro_torch.core.selection import locate_bin
    from repro_torch.kernels import hist_select
    rows, n = x.shape
    kj = hist_select._row_ks(k, rows, n, x.device)
    scale = row_scale(torch, x)
    cnt, sums = hist_select.magnitude_histogram_batched(x, scale)
    b, cnt_gt, _, cnt_b = locate_bin(cnt, sums, kj, 256)
    return scale, b, kj - cnt_gt.to(torch.int64), cnt_b


def check_bin_select(torch, rk, x, k) -> float:
    """``bin_select`` against its plain version on the k-selection's inputs
    for ``x`` and ``k``: ``v`` and the count bitwise, the sum within rtol
    1e-6, one launch a call, and a second call identical to the first.
    Returns the sums' largest abs difference."""
    scale, b, r, _ = select_inputs(torch, x, k)
    before = rk.LAUNCHES.counts["bin_select"]
    got = rk.candidate_select_batched(x, scale, b, r)
    require(rk.LAUNCHES.counts["bin_select"] == before + 1,
            "one bin_select call is not one launch")
    want = rk.candidate_select_plain(x, scale, b, r)
    shape = tuple(x.shape)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"bin_select v or count differs from its plain version at "
            f"{shape}")
    require(torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0),
            f"bin_select sums beyond rtol 1e-6 at {shape}")
    again = rk.candidate_select_batched(x, scale, b, r)
    require(all(torch.equal(g, a) for g, a in zip(got, again)),
            f"two bin_select calls differ at {shape}")
    return float((got[2] - want[2]).abs().max())


SELECT_PASSES = {"cluster": {"cluster_select_kernel"},
                 "two_read": {"level0_pass_kernel", "level1_pass_kernel",
                              "level2_pass_kernel"}}


def select_structure(torch, rk, x, scale, b, r, full_reads):
    """``bin_select``'s route at ``x``'s shape (``select_plan``) and the
    kernel's own count of the elements of x that one call loaded
    (``select_counters``), required to be ``full_reads`` times n in every
    row: one read on the cluster route, two on the two-read route, three
    where the level-0 digit held more than the buffer (``seen`` above
    ``capacity``).  Returns the keys for the kernels line."""
    from repro_torch.kernels import hist_select
    rows, n = x.shape
    plan = hist_select.select_plan(rows, n, hist_select._sms(x.device))
    rk.candidate_select_batched(x, scale, b, r)
    got = hist_select.select_counters(x.device, rows)
    require(got["reads"] == [full_reads * n] * rows,
            f"bin_select at {(rows, n)} loaded {sorted(set(got['reads']))} "
            f"elements of x a row, not {full_reads} x {n}")
    keys = {"select_route": (f"cluster({plan.cluster})"
                             if plan.route == "cluster" else "two_read"),
            "x_reads": max(got["reads"]) / n}
    if plan.route == "two_read":
        keys.update({"seen": max(got["seen"]), "capacity": plan.capacity})
    return keys


def select_witness(torch, rk, n=4_000_037):
    """The two-read route's third read of x: a constant (1, n) row, whose
    level-0 digit holds the whole row, above the candidate buffer.  The
    kernel against its plain version, its count of reads, and its time."""
    x = torch.full((1, n), 0.25, device="cuda")
    err = check_bin_select(torch, rk, x, max(int(n * P_STC), 1))
    scale, b, r, _ = select_inputs(torch, x, max(int(n * P_STC), 1))
    keys = select_structure(torch, rk, x, scale, b, r, full_reads=3)
    keys["ms"] = event_ms(torch, lambda: rk.candidate_select_batched(
        x, scale, b, r), iters=20)
    print(f"bin_select overflow witness, a constant (1, {n}) row: "
          f"{json.dumps(keys)}")
    return keys, err


def carried_rows(torch, rows, n, seed=5):
    """Rows like the trainers' carried residuals, made on the card from a
    seed: normal x 1e-3 clipped to 3e-3, 1 % of the columns x 200, and one
    1.0 a row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.clamp(torch.randn((rows, n), generator=gen, device="cuda")
                    * 1e-3, -3e-3, 3e-3)
    x[:, torch.randint(0, n, (max(n // 100, 1),), generator=gen,
                       device="cuda")] *= 200.0
    x[:, 0] = 1.0
    return x


# bin_select's shapes on the paths, by route: the cnn's (clients, server),
# the chunked groups', the mesh row (SmolLM at MESH_LAYERS), the largest
# LM row (DeepSeek-V2-Lite at 3 layers), and the constant overflow witness
SELECT_PASS_SHAPES = (("carried", 10, 307_434), ("carried", 1, 307_434),
                      ("carried", 790, 4096), ("carried", 79, 4096),
                      ("carried", 1, 63_713_088),
                      ("carried", 1, 1_670_133_760),
                      ("constant", 1, 4_000_037))


def select_passes(torch, rk):
    """``--select-passes``, which ``select_row`` runs in a fresh process
    (after many profiler sessions in one process, this card's profiler has
    shown none or only some of a call's kernels; a process in which it
    showed none raises ``ProfilerBlind`` and is made again): ``bin_select``
    at each of
    ``SELECT_PASS_SHAPES``, one call a ``torch.profiler`` session.  Fails
    unless the cluster route ran exactly one launch of its kernel and the
    two-read route one launch of each of its three passes, and nothing
    else, and unless the kernel's count of reads is one, two or (on the
    constant row) three reads of x a row.  Prints the passes' device times
    (ms) as one JSON line."""
    from repro_torch.kernels import hist_select
    out = {}
    for kind, rows, n in SELECT_PASS_SHAPES:
        x = (carried_rows(torch, rows, n) if kind == "carried"
             else torch.full((rows, n), 0.25, device="cuda"))
        scale, b, r, _ = select_inputs(torch, x, max(int(n * P_STC), 1))
        plan = hist_select.select_plan(rows, n, hist_select._sms(x.device))
        calls = launch_profile(torch, lambda: rk.candidate_select_batched(
            x, scale, b, r))
        want = SELECT_PASSES[plan.route]
        require(set(calls) == want
                and all(c["launches"] == 1 for c in calls.values()),
                f"bin_select at {(rows, n)} ({kind}) ran {calls}, not one "
                f"launch of each of {sorted(want)}")
        reads = 1 if plan.route == "cluster" else (
            3 if kind == "constant" else 2)
        keys = select_structure(torch, rk, x, scale, b, r, reads)
        out[f"{rows}x{n}" + ("_constant" if kind == "constant" else "")] = {
            **{name: c["ms"] for name, c in calls.items()}, **keys}
        del x, scale, b, r
        torch.cuda.empty_cache()
    print(f"select passes: {json.dumps(out)}")
    return out


_PASSES: dict = {}


PASS_FLAGS = (("wire", "--wire-passes", "wire passes: "),
              ("select", "--select-passes", "select passes: "))


def run_passes() -> dict:
    """``--wire-passes --select-passes`` in one fresh process (once a run;
    the wire kernels first, while the profiler has seen few sessions):
    ``{"select": ..., "wire": ...}``, their JSON lines.  Where a process
    exits with ``BLIND_RC`` (the profiler saw no device activity at all),
    the flags whose line it did not print run again in a fresh process, at
    most ``PASS_PROCESSES`` processes; any other failure fails at once."""
    for attempt in range(1, PASS_PROCESSES + 1):
        todo = [entry for entry in PASS_FLAGS if entry[0] not in _PASSES]
        if not todo:
            break
        flags = [flag for _, flag, _ in todo]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               *flags], capture_output=True, text=True,
                              timeout=400)
        wall = time.perf_counter() - t0
        for key, _, prefix in todo:
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith(prefix)]
            if lines:
                print(lines[-1])
                _PASSES[key] = json.loads(lines[-1][len(prefix):])
        print(f"{' '.join(flags)}: {wall:.1f} s with the process's start "
              f"(process {attempt} of at most {PASS_PROCESSES}, rc "
              f"{proc.returncode})")
        if proc.returncode == 0 and len(_PASSES) == len(PASS_FLAGS):
            break
        require(proc.returncode == BLIND_RC and attempt < PASS_PROCESSES,
                f"{' '.join(flags)} failed (rc {proc.returncode}, process "
                f"{attempt}): {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        print(f"process {attempt}: the profiler recorded no device activity "
              f"at all; the passes left run again in a fresh process")
    return _PASSES


def run_select_passes():
    """``--select-passes``' JSON line, from ``run_passes``."""
    return run_passes()["select"]


# --select-study: the paths' shapes, SmolLM-135M's full row among them
STUDY_SHAPES = ((10, 307_434), (1, 307_434), (790, 4096), (79, 4096),
                (1, 134_515_008), (1, 368_227_840), (1, 1_670_133_760))
STAMP_STEPS = ("copied", "level0_counted", "d0", "level1_counted", "d1",
               "level2_counted", "merged", "done")


def stamped_select(torch):
    """``csrc/bin_select.cu`` built with ``-DBIN_SELECT_STAMPS``: a function
    that runs its cluster route on ``(x, scale, b, r)`` in clusters of C
    and returns the steps of CTA (0, 0)'s last launch, µs from its start."""
    import ctypes
    import hashlib
    from repro_torch.kernels import _build
    src = _build.CSRC / "bin_select.cu"
    lib_path = _build.BUILD_DIR / (
        f"libbin_select_stamps-"
        f"{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so")
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DBIN_SELECT_STAMPS", "-o", str(lib_path), str(src)],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = lib.candidate_select_cluster_f32
    launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.candidate_select_stamps.argtypes = [ctypes.c_void_p]

    def steps(x, scale, b, r, cluster):
        rows, n = x.shape
        outs = (torch.empty(rows, device="cuda"),
                torch.empty(rows, dtype=torch.int32, device="cuda"),
                torch.empty(rows, device="cuda"),
                torch.empty(rows, dtype=torch.int64, device="cuda"))
        for _ in range(5):
            require(launch(*(t.data_ptr() for t in (x, scale, b, r, *outs)),
                           rows, n, cluster,
                           torch.cuda.current_stream().cuda_stream) == 0,
                    f"the stamped select failed at {(rows, n)}")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        require(lib.candidate_select_stamps(buf) == 0, "stamps not read")
        return {step: (buf[i + 1] - buf[0]) / 1e3
                for i, step in enumerate(STAMP_STEPS)}
    return steps


def study_routes(torch, rk, hist_select, x, scale, b, r, k, steps):
    """At a cluster-route shape: the kernel and the whole selection (device,
    and host included) on its own plan, on the two-read route and (for
    rows above 4 CTAs' slices) in clusters of 16, each held bitwise
    against the plain version; the occupancy of each cluster size that
    holds the row; the stamped kernel's steps at each cluster size."""
    rows, n = x.shape
    sms = hist_select._sms(x.device)
    plan = hist_select.select_plan(rows, n, sms)
    plans = {"own": plan,
             "two_read": hist_select.two_read_plan(rows, n, sms)}
    if n > 4 * hist_select._CLUSTER_KEYS:
        plans["cluster16"] = hist_select.SelectPlan("cluster", 16, 16, 0)
    want = rk.candidate_select_plain(x, scale, b, r)
    out = {}
    chosen = hist_select.select_plan
    try:
        for name, pl in plans.items():
            hist_select.select_plan = lambda rows, n, sms, pl=pl: pl
            got = rk.candidate_select_batched(x, scale, b, r)
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])
                    and torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0),
                    f"bin_select on {pl} differs from its plain version")

            def select():
                return rk.hist_topk_threshold_batched(x, k)
            out[name] = {
                "plan": list(pl),
                "ms": event_ms(torch, lambda: rk.candidate_select_batched(
                    x, scale, b, r), iters=50),
                "selection_device_ms": event_ms(torch, select, iters=50),
                "selection_host_ms": event_ms(torch, select, iters=50,
                                              hold_stream=False)}
    finally:
        hist_select.select_plan = chosen
    import ctypes
    from repro_torch.kernels import _build
    occupancy = _build.entry("bin_select", "candidate_select_max_clusters",
                             [ctypes.c_longlong, ctypes.c_int])
    sizes = [c for c in (1, 2, 4, 8, 16)
             if -(-n // c) <= hist_select._CLUSTER_KEYS]
    out["max_active_clusters"] = {c: occupancy(n, c) for c in sizes}
    out["steps_us"] = {c: steps(x, scale, b, r, c)
                       for c in sorted({plan.cluster, *(
                           [16] if "cluster16" in plans else [])})}
    return out


def select_study(torch, rk):
    """``--select-study``: ``bin_select`` of the package of the tree the
    file sits in timed by CUDA events at ``STUDY_SHAPES`` on
    ``carried_rows`` (a copy inside a parent checkout times the parent).
    With a package of two routes, at the cluster-route shapes also
    ``study_routes``.  Prints one JSON line a shape."""
    from repro_torch.kernels import hist_select
    print(f"card: {card_line()}; package "
          f"{Path(rk.__file__).resolve().parents[1]}", flush=True)
    routes = hasattr(hist_select, "two_read_plan")
    steps = stamped_select(torch) if routes else None
    for rows, n in STUDY_SHAPES:
        x = carried_rows(torch, rows, n)
        k = max(int(n * P_STC), 1)
        scale, b, r, _ = select_inputs(torch, x, k)
        rec = {"ms": event_ms(torch, lambda: rk.candidate_select_batched(
            x, scale, b, r), iters=50 if n < 10**7 else 5)}
        longest = hist_select._MAX_CLUSTER * hist_select._CLUSTER_KEYS
        if routes and n <= longest:
            rec.update(study_routes(torch, rk, hist_select, x, scale, b, r,
                                    k, steps))
        print(f"select study ({rows}, {n}): {json.dumps(rec)}", flush=True)
        del x, scale, b, r
        torch.cuda.empty_cache()


def check_histogram(torch, rk, x, scale) -> float:
    """The histogram kernel against its plain version (counts exact, sums
    within rtol 1e-6), one launch a call, and a second call identical to
    the first.  Returns the sums' largest abs difference."""
    before = rk.LAUNCHES.counts["histogram"]
    cnt_k, sum_k = rk.magnitude_histogram_batched(x, scale)
    require(rk.LAUNCHES.counts["histogram"] == before + 1,
            "one histogram call is not one launch")
    cnt_p, sum_p = rk.magnitude_histogram_plain(x, scale)
    shape = tuple(x.shape)
    require(torch.equal(cnt_k, cnt_p), f"histogram counts differ at {shape}")
    require(torch.allclose(sum_k, sum_p, rtol=1e-6, atol=0.0),
            f"histogram sums beyond rtol 1e-6 at {shape}")
    cnt_2, sum_2 = rk.magnitude_histogram_batched(x, scale)
    require(torch.equal(cnt_k, cnt_2) and torch.equal(sum_k, sum_2),
            f"two histogram calls differ at {shape}")
    return float((sum_k - sum_p).abs().max())


def device_ops(torch, fn):
    """Names of the device operations (kernels, memsets, copies) that one
    call of ``fn`` runs, by ``torch.profiler``; None if the profiler sees
    no device activity at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return names or None


def kernel_times(torch, fn, calls=10, launches=False):
    """Device time (ms) of each kernel that a call of ``fn`` runs, mean over
    ``calls`` calls, by ``torch.profiler``; None if it sees none.  With
    ``launches``, each kernel's ``{"launches": a call, "ms": a call}``."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    counts: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel = re.search(r"(\w+)(<\d+>)?\(", e.name)  # kernel's name
            name = kernel.group(1) + (kernel.group(2) or "") if kernel \
                else e.name
            times[name] = (times.get(name, 0.0)
                           + e.time_range.elapsed_us() / calls / 1e3)
            counts[name] = counts.get(name, 0) + 1 / calls
    if launches:
        return {name: {"launches": counts[name], "ms": ms}
                for name, ms in times.items()} or None
    return times or None


def launch_profile(torch, fn, sessions=3):
    """``kernel_times(fn, calls=1, launches=True)``, in a new profiler
    session while a session records no device activity at all (this card's
    profiler has come back empty in a process that had run other
    sessions), at most ``sessions`` of them; each empty session is
    printed.  Raises ``ProfilerBlind`` if every session was empty: ``fn``
    is only ever a call that launches kernels."""
    for session in range(sessions):
        calls = kernel_times(torch, fn, calls=1, launches=True)
        if calls is not None:
            return calls
        print(f"torch.profiler session {session + 1} of {sessions} "
              f"recorded no device activity")
    raise ProfilerBlind(f"torch.profiler recorded no device activity in "
                        f"{sessions} sessions")


def chunk_set(np, rng, count, gaps=False):
    """``count`` Golomb-like chunks (lengths 1-63, a fifth of them 32-one
    chunks), back to back or with word-aligned client gaps, and a total
    that is not a multiple of 32: ``(vals, lens, offs, total_bits)``."""
    lens = rng.integers(1, 64, count)
    lens[rng.random(count) < 0.2] = 32
    offs = np.cumsum(lens) - lens
    if gaps and count > 1:
        for cut in sorted(rng.choice(np.arange(1, count), min(8, count - 1),
                                     replace=False)):
            offs[cut:] += (-int(offs[cut]) % 32) + 32 * int(rng.integers(3))
    vals = rng.integers(0, 1 << 63, count, dtype=np.uint64)
    vals &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    vals[lens == 32] = np.uint64(0xFFFFFFFF)
    return vals, lens, offs, int(offs[-1] + lens[-1]) + 17


def pack_edge_sets(np, rng):
    """``pack_chunks``'s edges (a CTA takes 224 chunks and owns the words
    from its first chunk's on): one-bit chunks (31 before a CTA's first
    chunk share its first word), 63-bit chunks over three words, gaps of
    whole words and longer than a pass (1,024 words) among 63-bit and zero
    chunks, no chunk at all, one chunk at the end; totals not multiples of
    32."""
    one_bit = (rng.integers(0, 2, 5000).astype(np.uint64),
               np.ones(5000, np.int64), np.arange(5000))
    straddle = (rng.integers(0, 1 << 63, 2000, dtype=np.uint64),
                np.full(2000, 63), 96 * np.arange(2000) + 31)
    lens = rng.integers(1, 64, 3000)
    lens[::3] = 63
    offs = np.cumsum(lens) - lens + 32 * (np.arange(3000) // 500) * 1500
    vals = rng.integers(0, 1 << 63, 3000, dtype=np.uint64)
    vals &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    vals[::7] = 0
    none = (np.zeros(0, np.uint64), np.zeros(0, np.int64),
            np.zeros(0, np.int64))
    last = (np.array([5], np.uint64), np.array([3]), np.array([99_990]))
    return [(*one_bit, 5000 + 7),
            (*straddle, int(straddle[2][-1]) + 63 + 5),
            (vals, lens, offs, int(offs[-1] + lens[-1]) + 3),
            (*none, 100_001), (*last, 99_993)]


def chunk_tensors(torch, np, vals, lens, offs):
    """The chunk fields as the card tensors ``pack_chunks`` takes."""
    return (torch.from_numpy(np.ascontiguousarray(vals).view(np.int64))
            .to("cuda"),
            torch.from_numpy(lens.astype(np.int32)).to("cuda"),
            torch.from_numpy(offs.astype(np.int64)).to("cuda"))


def check_pack_chunks(torch, np, rk, vals, lens, offs, total_bits) -> float:
    """``pack_chunks`` on the card against its plain version and the host
    scatter, one launch a call, two calls identical; returns the words' max
    abs difference (0.0)."""
    from repro_torch.core.wire import _scatter_chunks_numpy
    t = chunk_tensors(torch, np, vals, lens, offs)
    before = rk.LAUNCHES.counts["pack_chunks"]
    got = rk.pack_chunks(*t, total_bits)
    again = rk.pack_chunks(*t, total_bits)
    require(rk.LAUNCHES.counts["pack_chunks"] == before + 2,
            f"one pack_chunks call is not one launch at {len(vals)} chunks")
    require(torch.equal(got, again),
            f"two pack_chunks calls differ at {len(vals)} chunks")
    w_k = got.cpu().numpy().view(np.uint32)
    w_p = rk.pack_chunks_plain(*t, total_bits).cpu().numpy().view(np.uint32)
    w_np = _scatter_chunks_numpy(vals, lens, offs, total_bits)
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_chunks words differ at {len(vals)} chunks "
                        f"(max {err})")
    return err


def words_err(np, got, want) -> float:
    """Largest |difference| between two uint32 word streams."""
    require(got.shape == want.shape,
            f"word streams differ in length: {got.shape} vs {want.shape}")
    return float(np.abs(got.astype(np.int64) - want.astype(np.int64))
                 .max(initial=0))


def check_pack_bits(torch, np, rk, rng, m, rows=None) -> float:
    """``pack_bits`` on ``m`` random card bits (or ``pack_bits_batched`` on
    ``rows`` rows of ``m``: rows start off 16-byte boundaries unless 16
    divides m) against its plain version and the host packer, with bytes
    other than 0 and 1 among the bits; one launch a call, two calls
    identical.  Returns the words' max abs difference (0.0)."""
    from repro_torch.core.wire import _pack_bits_numpy
    shape = (m,) if rows is None else (rows, m)
    bits_np = ((rng.random(shape) < 0.3) * rng.integers(1, 256, shape)) \
        .astype(np.uint8)
    bits = torch.from_numpy(bits_np).to("cuda")
    pack = rk.pack_bits if rows is None else rk.pack_bits_batched
    before = rk.LAUNCHES.counts["pack_bits"]
    got = pack(bits)
    again = pack(bits)
    require(rk.LAUNCHES.counts["pack_bits"] == before + 2,
            f"one pack_bits call is not one launch at {shape}")
    require(torch.equal(got, again), f"two pack_bits calls differ at {shape}")
    plain = (rk.pack_bits_plain if rows is None
             else rk.pack_bits_batched_plain)
    w_k = got.cpu().numpy().view(np.uint32)
    w_p = plain(bits).cpu().numpy().view(np.uint32)
    w_np = np.stack([_pack_bits_numpy(r != 0)
                     for r in bits_np.reshape(-1, m)]).reshape(w_k.shape)
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_bits words differ at {shape} (max {err})")
    return err


def sign_rows(np, rng, rows, n):
    """``rows`` fp32 rows of length ``n`` of ±2e-4 and 0 (signSGD messages)
    with the edge values of the sign test among them: -0.0, subnormals of
    both signs, ±inf, NaN of both signs, the least normal and the largest
    float."""
    edge = np.array([2e-4, -2e-4, 0.0, -0.0, 1e-40, -1e-40, 1.4e-45,
                     -1.4e-45, np.inf, -np.inf, np.nan, FLT_MIN, 3.4e38],
                    np.float32)
    x = (np.sign(rng.standard_normal((rows, n))) * 2e-4).astype(np.float32)
    pick = rng.random((rows, n)) < 0.05
    x[pick] = rng.choice(edge, int(pick.sum()))
    flat = x.reshape(-1)
    flat[:min(edge.size, flat.size)] = edge[:flat.size]
    flat[-1] = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    return x


def check_pack_sign_planes(torch, np, rk, x_np) -> float:
    """``pack_sign_planes`` on the card rows ``x_np`` against its plain
    version and numpy's ``x > 0`` through the host packer; one launch a
    call, two calls identical.  Returns the words' max abs difference."""
    from repro_torch.core.wire import _pack_bits_numpy
    x = torch.from_numpy(np.ascontiguousarray(x_np)).to("cuda")
    before = rk.LAUNCHES.counts["pack_sign_planes"]
    got = rk.pack_sign_planes(x)
    again = rk.pack_sign_planes(x)
    shape = tuple(x.shape)
    require(rk.LAUNCHES.counts["pack_sign_planes"] == before + 2,
            f"one pack_sign_planes call is not one launch at {shape}")
    require(torch.equal(got, again),
            f"two pack_sign_planes calls differ at {shape}")
    w_k = got.cpu().numpy().view(np.uint32)
    w_p = rk.pack_sign_planes_plain(x.cpu()).numpy().view(np.uint32)
    w_np = np.stack([_pack_bits_numpy((r > 0).astype(np.uint8))
                     for r in x_np])
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_sign_planes words differ at {shape}")
    return err


def check_sign_plane_tally(torch, np, rk, rng, words_np, weights) -> float:
    """``sign_plane_tally`` on the card words ``words_np`` ((B, W) uint32)
    into a sum that already holds values, against its plain version on the
    CPU and the host accumulator's ``add_sign_plane`` loop, bitwise; one
    launch a call.  Returns the largest abs difference (0.0)."""
    from repro_torch.core.ingest import IngestAccumulator
    from repro_torch.core.wire import words_to_bits
    rows, n_words = words_np.shape
    n = 32 * n_words - int(rng.integers(0, 32))
    start = rng.standard_normal(n) * 1e-4
    acc = IngestAccumulator(n)
    acc.sum[:] = start
    for i in range(rows):
        acc.add_sign_plane(words_to_bits(words_np[i], n), 2e-4,
                           float(weights[i]))
    words = torch.from_numpy(words_np.view(np.int32))
    w = torch.from_numpy(np.asarray(weights, np.float64))
    total = torch.from_numpy(start.copy()).to("cuda")
    before = rk.LAUNCHES.counts["sign_plane_tally"]
    rk.sign_plane_tally(words.to("cuda"), 2e-4, w.to("cuda"), total)
    require(rk.LAUNCHES.counts["sign_plane_tally"] == before + 1,
            f"one sign_plane_tally call is not one launch at {rows} rows")
    plain = rk.sign_plane_tally(words, 2e-4, w,
                                torch.from_numpy(start.copy()))
    got = total.cpu().numpy()
    require(np.array_equal(got.view(np.uint64), plain.numpy().view(np.uint64))
            and np.array_equal(got.view(np.uint64), acc.sum.view(np.uint64)),
            f"sign_plane_tally differs from its plain version or the host "
            f"loop at ({rows}, {n_words}), n={n}")
    return float(np.abs(got - acc.sum).max(initial=0.0))


def check_unpack_bits(torch, np, rk, rng, n_words, rows=None) -> float:
    """``unpack_bits`` on ``n_words`` random card words (or
    ``unpack_words_batched`` on ``rows`` rows of them; the edge words 0, 1,
    0x80000000 and 0xFFFFFFFF first) against its plain version and the
    host unpack: bits and zero counts identical, one launch a call;
    returns 0.0."""
    from repro_torch.core.wire import _unpack_bits_numpy
    shape = (n_words,) if rows is None else (rows, n_words)
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    w.reshape(-1)[:min(w.size, 4)] = edge[:w.size]
    words = torch.from_numpy(w.view(np.int32)).to("cuda")
    unpack = (rk.unpack_words_with_counts if rows is None
              else rk.unpack_words_batched)
    before = rk.LAUNCHES.counts["unpack_bits"]
    bits, zeros = unpack(words)
    require(rk.LAUNCHES.counts["unpack_bits"] == before + 1,
            f"one unpack_bits call is not one launch at {shape}")
    bits_p, zeros_p = rk.unpack_words_plain(words)
    w = w.reshape(-1)
    bits_np = _unpack_bits_numpy(w)
    zeros_np = 32 - bits_np.reshape(-1, 32).sum(axis=1, dtype=np.int64)
    got_bits = bits.cpu().numpy().reshape(-1)
    got_zeros = zeros.cpu().numpy().reshape(-1)
    err = max(float(np.abs(got_bits.astype(np.int64) - bits_np).max()),
              float(np.abs(got_zeros - zeros_np).max()))
    require(torch.equal(bits, bits_p) and torch.equal(zeros, zeros_p)
            and err == 0.0, f"unpack_bits differs at {shape}")
    return err


def golomb_vs_plain(torch, np, rk, words, word_start, bit_len, nnz, numel,
                    b):
    """``golomb_decode`` and its plain version on the same card words:
    ``(raised, max_abs_err)``; fails unless both raise or both give
    identical fields."""
    from repro_torch.core.wire import WireDecodeError
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                         .view(np.int32)).to("cuda")
    table = [torch.from_numpy(np.array(a, np.int64, ndmin=1))
             for a in (word_start, bit_len, nnz)]
    out = []
    for fn in (rk.decode_golomb_fields, rk.decode_golomb_fields_plain):
        try:
            out.append(fn(w, *table, numel, b))
        except WireDecodeError:
            out.append(None)
    torch.cuda.synchronize()
    got, want = out
    require((got is None) == (want is None),
            f"golomb_decode {'raised' if got is None else 'decoded'} where "
            f"its plain version did not (W={w.numel()}, b={b})")
    if got is None:
        return True, 0.0
    want = [h.cpu() for h in want]      # the wrapper's fields are the host's
    require(all(g.dtype == h.dtype and torch.equal(g, h)
                for g, h in zip(got, want)),
            f"golomb_decode fields differ from its plain version "
            f"(W={w.numel()}, b={b})")
    return False, max(float((g.double() - h.double()).abs().max())
                      if g.numel() else 0.0 for g, h in zip(got, want))


def check_golomb_cases(torch, np, rk) -> float:
    """``golomb_decode`` against its plain version on the card: valid
    batches over the P grid and b = 30, the decoder's traps (unary runs over
    chunks and compose tiles, codewords ending on chunk ends, ``bit_len %
    32 == 0``, empty segments, b = 0), a cnn round, all-ones buffers, 300
    corrupt batches and the 60 mutations of the reference's wire fuzz test
    (the case builders of ``tests/_golomb_cases.py``); fields identical,
    verdicts identical.  Returns the largest field difference (0.0)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _golomb_cases as gc
    from repro_torch.core import wire
    t0 = time.perf_counter()
    err, raised, n = 0.0, 0, 0
    for _, bt, p in gc.synthetic_cases():
        r, e = golomb_vs_plain(torch, np, rk, bt.words, bt.word_start,
                               bt.bit_len, bt.nnz, bt.numel,
                               wire._b_star_checked(p))
        raised, err, n = raised + r, max(err, e), n + 1
    t_synthetic = time.perf_counter() - t0
    batches = (gc.valid_cases() + gc.trap_cases() + [("cnn", *gc.cnn_round())]
               + gc.corrupt_cases(300))
    tables = [(bt.words, bt.word_start, bt.bit_len, bt.nnz, bt.numel,
               wire._b_star_checked(p)) for _, bt, p in batches]
    tables += [(m.words, 0, m.bit_len, m.nnz, m.numel,
                wire._b_star_checked(p)) for _, m, p in gc.fuzz_messages()
               if m.bit_len <= 32 * m.words.size]
    tables += [(np.full(40, 0xFFFFFFFF, np.uint32), 0, bl, 0, 10**9, b)
               for b in (0, 5, 30) for bl in (1, 32, 257, 1280)]
    for table in tables:
        r, e = golomb_vs_plain(torch, np, rk, *table)
        raised, err, n = raised + r, max(err, e), n + 1
    require(raised >= 150, f"only {raised} corrupt golomb cases raised")
    cnn, p = gc.cnn_round()
    w = torch.from_numpy(cnn.words.view(np.int32)).to("cuda")
    table = [torch.from_numpy(np.asarray(a, np.int64))
             for a in (cnn.word_start, cnn.bit_len, cnn.nnz)]
    b = wire._b_star_checked(p)
    before = rk.LAUNCHES.counts["golomb_decode"]
    first = rk.decode_golomb_fields(w, *table, cnn.numel, b)
    again = rk.decode_golomb_fields(w, *table, cnn.numel, b)
    require(rk.LAUNCHES.counts["golomb_decode"] == before + 2,
            "one golomb_decode call is not one launch")
    require(all(torch.equal(f, g) for f, g in zip(first, again)),
            "two golomb_decode calls differ on a cnn round")
    print(f"golomb_decode: {n} cases against its plain version on the card, "
          f"{raised} raised on both, the rest identical fields; one launch "
          f"a call, two calls identical ({time.perf_counter() - t0:.1f} s, "
          f"{t_synthetic:.1f} s of it the synthetic cases)")
    return err


def check_threshold_stats(torch, np, rk, rng) -> float:
    """``threshold_stats`` at the cnn's n on a row with zeros and on a
    subnormal row, at t = 0, a subnormal t, two quantiles and above the
    max, and on a short row (n = 17): counts exact, sums within rtol 1e-6,
    one launch a call, and a second call identical to the first.  Returns
    the sums' largest abs difference."""
    x_np = (rng.standard_normal(MAIN_N) * 1e-3).astype(np.float32)
    x_np[rng.random(MAIN_N) < 0.1] = 0.0
    rows = [torch.from_numpy(x_np).to("cuda"),
            torch.from_numpy(subnormal_row(np, rng, MAIN_N).astype(
                np.float32)).to("cuda"),
            torch.from_numpy(rng.standard_normal(17).astype(
                np.float32)).to("cuda")]
    err = 0.0
    for x in rows:
        a = x.abs()
        for t in (torch.zeros((), device="cuda"),
                  torch.full((), 1e-40, device="cuda"), a.quantile(0.5),
                  a.quantile(0.98), a.max() * 2):
            before = rk.LAUNCHES.counts["threshold_stats"]
            cnt, total = rk.threshold_stats(x, t)
            again = rk.threshold_stats(x, t)
            require(rk.LAUNCHES.counts["threshold_stats"] == before + 2,
                    "one threshold_stats call is not one launch")
            cnt_p, total_p = rk.threshold_stats_plain(x, t)
            what = f"n={x.numel()} t={float(t)}"
            require(int(cnt) == int(cnt_p),
                    f"threshold_stats count differs at {what}")
            require(bool(torch.allclose(total, total_p, rtol=1e-6,
                                        atol=0.0)),
                    f"threshold_stats sum beyond rtol 1e-6 at {what}")
            require(torch.equal(cnt, again[0])
                    and torch.equal(total, again[1]),
                    f"two threshold_stats calls differ at {what}")
            err = max(err, float((total - total_p).abs()))
    require(int(rk.threshold_stats(rows[0], torch.zeros((), device="cuda"))
                [0]) == int((x_np != 0).sum()),
            "threshold_stats counted zeros")
    normal = int((rows[1].abs() >= FLT_MIN).sum())
    require(int(rk.threshold_stats(rows[1], 1e-40)[0]) == normal,
            "threshold_stats counted subnormals")
    return err


def bisect_vs_plain(torch, rk, x, k, iters=32) -> float:
    """The fused bisection on the card against its plain version on the
    same card tensor and on the CPU: ``lo`` and the count bitwise, Σ within
    rtol 1e-6, one launch a call, and a second call with identical bits.
    Returns Σ's abs difference."""
    what = f"n={x.numel()} k={k} iters={iters}"
    before = rk.LAUNCHES.counts["bisect_select"]
    got = rk.topk_threshold(x, k, iters=iters)
    again = rk.topk_threshold(x, k, iters=iters)
    require(rk.LAUNCHES.counts["bisect_select"] == before + 2,
            f"one bisection is not one launch at {what}")
    for want in (rk.topk_threshold_plain(x, k, iters),
                 rk.topk_threshold_plain(x.cpu(), k, iters)):
        require(torch.equal(got[0].cpu().view(torch.int32),
                            want[0].cpu().view(torch.int32))
                and int(got[1]) == int(want[1]),
                f"bisection lo or count differs from its plain version at "
                f"{what}")
        require(bool(torch.allclose(got[2].cpu(), want[2].cpu(), rtol=1e-6,
                                    atol=0.0)),
                f"bisection sum beyond rtol 1e-6 at {what}")
    require(all(torch.equal(g.view(torch.int32), a.view(torch.int32))
                for g, a in zip(got, again)),
            f"two bisection calls differ at {what}")
    return float((got[2].cpu() - want[2]).abs())


def check_bisection(torch, np, rk, rng) -> float:
    """The fused bisection against its plain version: at the cnn's n for
    p in {0.001, 1/50, 0.1} (count = k), on
    the edge cases of ``tests/_bisect_cases.py`` (all zero, subnormal,
    k = n, ties, n below 32, fewer non-zeros than k) with ``iters`` 0 and
    32, on a subnormal row, and on a vector larger than the cluster's
    shared memory (4,000,037 elements); ``stc_compress_kernel(selector=
    "bisect")`` under ``set_sync_debug_mode("error")``, and against
    ``"hist"`` at p = 1/50 (the same mask).  Returns the largest sum
    difference."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _bisect_cases as bc
    x = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-3).astype(np.float32)).to("cuda")
    err = 0.0
    for p in (0.001, P_STC, 0.1):
        k = max(int(MAIN_N * p), 1)
        err = max(err, bisect_vs_plain(torch, rk, x, k))
        require(int(rk.topk_threshold(x, k)[1]) == k,
                f"bisection count is not k={k}")
    n_cases = 0
    for case, k in bc.EDGE_CASES:
        row = torch.from_numpy(bc.edge_row(
            case, np.random.default_rng(k))).to("cuda")
        for iters in (0, 32):
            err = max(err, bisect_vs_plain(torch, rk, row, k, iters))
            n_cases += 1
    sub = torch.from_numpy(subnormal_row(np, rng, MAIN_N).astype(
        np.float32)).to("cuda")
    big = torch.from_numpy(
        (rng.standard_normal(4_000_037) * 1e-3).astype(np.float32)).to("cuda")
    for row, k in ((sub, 1000), (sub, 6148), (big, 80_000)):
        err = max(err, bisect_vs_plain(torch, rk, row, k))
    print(f"bisect_select: {n_cases} edge cases, the cnn's n at three k "
          f"a subnormal row and n=4,000,037: lo and "
          f"count bitwise its plain version's, two calls identical")
    res = torch.zeros_like(x)
    rk.stc_compress_kernel(x, res, P_STC, selector="bisect")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rk.stc_compress_kernel(x, res, P_STC, selector="bisect")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    r = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-4).astype(np.float32)).to("cuda")
    bis = rk.stc_compress_kernel(x, r, P_STC, selector="bisect")
    hist = rk.stc_compress_kernel(x, r, P_STC, selector="hist")
    require(torch.equal(torch.sign(bis[0]), torch.sign(hist[0]))
            and int(bis[4]) == int(hist[4]),
            "selector='bisect' and 'hist' select different masks")
    return err


# ---------------------------------------------------------------- phase 3

DENSE_KERNELS = ("stc_apply", "histogram", "bin_select", "pack_chunks")
INGEST_KERNELS = DENSE_KERNELS + ("golomb_decode",)


# each codec's settings on the cnn: examples/federated_noniid.py's
# DEMO_OVERRIDES, and the "kernel" backends where a codec has them
CODEC_KW = {
    "stc": dict(sparsity_up=P_STC, sparsity_down=P_STC, backend="kernel",
                wire_backend="kernel"),
    "signsgd": dict(wire_backend="kernel"),
    "topk": dict(sparsity_up=P_STC),
    "fedavg": dict(local_iters=10),
}


def make_trainer(device, torch, ingest=False, codec="stc", buffered=None,
                 lr=0.05, **cfg):
    """The cnn trainer of ``examples/federated_noniid.py`` with ``codec``;
    ``buffered`` (a dict of ``BufferedFederatedTrainer`` keywords) makes it
    the buffered trainer; ``cfg`` are further ``TrainerConfig`` fields
    (``chunks``, ``controller``)."""
    from repro_torch.core import make_protocol
    from repro_torch.data import make_image_classification
    from repro_torch.fed import FedEnvironment, FederatedTrainer, \
        TrainerConfig
    from repro_torch.models import MODEL_ZOO
    train, test = make_image_classification(seed=0, n=6000)
    env = FedEnvironment(n_clients=10, participation=1.0,
                         classes_per_client=2, batch_size=20)
    proto = make_protocol(codec, **CODEC_KW.get(codec, {}))
    args = (MODEL_ZOO["cnn"], train, test, env, proto,
            TrainerConfig(lr=lr, ingest=ingest, **cfg))
    if buffered is not None:
        from repro_torch.fed import BufferedFederatedTrainer
        return BufferedFederatedTrainer(*args, **buffered, device=device)
    return FederatedTrainer(*args, device=device)


def run_trainers(torch, rk, ingest=False):
    """The cnn on the card (counters set to 0 just before) and on the CPU;
    requires the path's kernels to have launched on the card's run.  The
    dense card run also records every selection's candidate bin
    (``probe_selections``)."""
    from repro_torch.kernels import hist_select
    path, needed = (("ingest", INGEST_KERNELS) if ingest
                    else ("dense", DENSE_KERNELS))
    gpu = make_trainer("cuda", torch, ingest=ingest)
    require(gpu.numel == MAIN_N, f"cnn has {gpu.numel} parameters")
    require(gpu.ingest == ingest, f"the {path} trainer is not on its path")
    located = []
    locate_bin = hist_select.locate_bin

    def recording_locate_bin(*args):
        out = locate_bin(*args)
        located.append((out[0].clone(), out[3].clone()))   # b, cnt_b
        return out

    if not ingest:
        hist_select.locate_bin = recording_locate_bin
    try:
        rk.LAUNCHES.reset()
        t0 = time.perf_counter()
        h_gpu = gpu.run(ROUNDS, eval_every=ROUNDS)[-1]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES.counts)
        shapes = dict(rk.LAUNCHES.shapes)
    finally:
        hist_select.locate_bin = locate_bin
    require(bool(torch.isfinite(gpu.params_vec).all()), "non-finite params")
    for name in needed:
        require(launches[name] > 0,
                f"kernel {name} never launched on the {path} path")
    require(launches["bin_select"] == launches["histogram"] == 2 * ROUNDS,
            f"the {path} path selected {launches['bin_select']} times with "
            f"bin_select and {launches['histogram']} with the histogram in "
            f"{ROUNDS} rounds, not twice a round with both")
    if located:
        probe_selections(located)
    require(launches["pack_chunks"] == 2 * ROUNDS
            and launches["pack_bits"] == 0,
            f"the {path} ledger packed {launches['pack_chunks']} times with "
            f"pack_chunks and {launches['pack_bits']} with pack_bits in "
            f"{ROUNDS} rounds, not twice a round with pack_chunks alone")
    if ingest:
        require(launches["golomb_decode"] >= ROUNDS
                and launches["unpack_bits"] == 0,
                f"the ingest path decoded {launches['golomb_decode']} times "
                f"with golomb_decode and {launches['unpack_bits']} with "
                f"unpack_bits in {ROUNDS} rounds, not at least once a round "
                f"with golomb_decode alone")

    cpu = make_trainer("cpu", torch, ingest=ingest)
    t0 = time.perf_counter()
    h_cpu = cpu.run(ROUNDS, eval_every=ROUNDS)[-1]
    cpu_s = time.perf_counter() - t0
    require(rk.LAUNCHES.counts == launches,
            "the CPU run launched a CUDA kernel")
    d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
    d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
    d_params = float((gpu.params_vec.cpu() - cpu.params_vec).norm()
                     / cpu.params_vec.norm())
    print(f"{path} trainer: cnn {gpu.numel} params, {ROUNDS} rounds | card "
          f"acc={h_gpu['acc']:.4f} bits_up={h_gpu['bits_up']:.0f} "
          f"bits_down={h_gpu['bits_down']:.0f} ({gpu_s:.1f} s) | cpu "
          f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
          f"bits_down={h_cpu['bits_down']:.0f} ({cpu_s:.1f} s) | "
          f"|d acc|={d_acc:.4f} |d bits_up|={d_up:.4%} "
          f"|d params|/|params|={d_params:.3e}")
    print(f"{path}-path launches: {json.dumps(launches)} shapes: "
          f"{json.dumps({k: list(v) for k, v in shapes.items()})}")
    require(d_acc <= 0.03, f"accuracy differs by {d_acc:.4f} > 0.03")
    require(d_up <= 0.02, f"bits_up differs by {d_up:.4%} > 2%")
    return gpu, launches, shapes


def probe_selections(located) -> None:
    """Round by round, the candidate bin ``b`` and its population ``cnt_b``
    of the encode selection (the cohort's rows) and of the server's, and
    how many of them the old refinement would have sent to its full-row
    ``torch.sort`` (a selection sorted when any row's bin held more than
    ``cap`` elements)."""
    from repro_torch.core.selection import DEFAULT_CAP
    require(len(located) == 2 * ROUNDS,
            f"{len(located)} selections recorded in {ROUNDS} rounds")
    sorted_sel = {"encode": 0, "server": 0}
    rows_over = rows_all = 0
    for rnd in range(ROUNDS):
        line = []
        for role, (b, cnt_b) in zip(("encode", "server"),
                                    located[2 * rnd:2 * rnd + 2]):
            b, cnt_b = b.tolist(), cnt_b.tolist()
            require(len(b) == (MAIN_ROWS if role == "encode" else 1),
                    f"round {rnd + 1}: the {role} selection has {len(b)} "
                    f"rows")
            over = sum(c > DEFAULT_CAP for c in cnt_b)
            sorted_sel[role] += over > 0
            if role == "encode":
                rows_over, rows_all = rows_over + over, rows_all + len(b)
            line.append(f"{role} b={b} cnt_b={cnt_b} over cap {over}")
        print(f"selection probe round {rnd + 1}: {'; '.join(line)}")
    print(f"selection probe: {sorted_sel['encode']} of {ROUNDS} encode and "
          f"{sorted_sel['server']} of {ROUNDS} server selections would have "
          f"taken the old route's full-row torch.sort; {rows_over} of "
          f"{rows_all} client rows had a candidate bin over cap = "
          f"{DEFAULT_CAP}")


def check_lockstep(torch, np, rk, tr, rounds=3):
    """The card's encode, apply and ledger phases against the same phases
    on the CPU (plain versions), round by round from the same inputs: the
    card's local-SGD deltas and the card's state (client and server
    residuals, parameters) at the start of the round, from the trained
    state on.  Positions, signs, counts and wire words must be exact; µ
    within rtol 1e-6; residuals and parameters within 1e-6 of
    ``|value| + µ``.  The trainer's parameters and residuals are left as
    they were; only its data stream advances.  Returns the last round's
    carried matrices (clients', server's) and upstream messages, for the
    timings."""
    from repro_torch.core import wire
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.residual import ResidualState
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    be = get_stc_backend(proto.backend)
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    params = tr.params_vec.clone()
    client_res = tr.client_state.residual.clone()
    server_res = tr.server_state.residual.clone()
    worst = {"mu_rtol": 0.0, "residual_abs": 0.0, "params_abs": 0.0,
             "words_abs": 0.0}

    def close(what, got, want, mu):
        want = want.reshape(mu.numel(), -1)
        gap = (got.cpu().reshape(want.shape) - want).abs()
        require(bool((gap <= 1e-6 * (want.abs() + mu.abs().reshape(-1, 1)))
                     .all()), f"lock-step round {r}: {what} beyond 1e-6 of "
                              f"|value| + µ (max gap {float(gap.max())})")
        return float(gap.max())

    def same_message(what, got, want, st_got, st_want):
        require(torch.equal(torch.sign(got.cpu()), torch.sign(want)),
                f"lock-step round {r}: {what} positions or signs differ")
        require(torch.equal(st_got.nnz.cpu(), st_want.nnz),
                f"lock-step round {r}: {what} counts differ")
        mu_want = st_want.mu.reshape(-1)
        rel = float(((st_got.mu.cpu().reshape(-1) - mu_want).abs()
                     / mu_want.abs()).max())
        require(rel <= 1e-6, f"lock-step round {r}: {what} µ off by "
                             f"rtol {rel:.3e} > 1e-6")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)
        close(f"{what} values", got, want, mu_want)

    def same_words(what, got, want):
        require(np.array_equal(got.bit_len, want.bit_len),
                f"lock-step round {r}: {what} stream lengths differ")
        worst["words_abs"] = max(worst["words_abs"],
                                 words_err(np, got.words, want.words))
        require(worst["words_abs"] == 0.0,
                f"lock-step round {r}: {what} wire words differ")

    packs = rk.LAUNCHES.counts["pack_chunks"]
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        msgs, cstate, st = proto.encode_batch(
            deltas, ResidualState(residual=client_res[idx]))
        gd, sstate, sg = proto.aggregate(msgs, ResidualState(server_res),
                                         mask=ones, staleness=zeros)
        mean = proto.combine(msgs, ones, zeros)
        last = {"carried": deltas + client_res[idx],
                "server_carried": (mean + server_res)[None],
                "upstream": msgs.cpu().numpy()}

        msgs_c, cstate_c, st_c = proto.encode_batch(
            deltas.cpu(), ResidualState(residual=client_res[idx].cpu()))
        gd_c, sres_c, sg_c = be.compress_with_residual(
            mean.cpu(), server_res.cpu(), proto.sparsity_down)
        same_message("client messages", msgs, msgs_c, st, st_c)
        worst["residual_abs"] = max(
            worst["residual_abs"],
            close("client residuals", cstate.residual, cstate_c.residual,
                  st_c.mu),
            close("server residual", sstate.residual, sres_c, sg_c.mu))
        same_message("server message", gd, gd_c, sg, sg_c)
        worst["params_abs"] = max(worst["params_abs"], close(
            "parameters", params + gd, params.cpu() + gd_c, sg_c.mu))

        # the ledger: the "kernel" wire backend on the card's messages
        # against the host packer on the same messages
        same_words("upstream", proto.encode_wire_batch(msgs, direction="up"),
                   wire.encode_ternary_words_batch(
                       msgs.cpu().numpy(), proto.sparsity_up))
        same_words("downstream", proto.encode_wire(gd, direction="down"),
                   wire.encode_ternary_words(
                       gd.cpu().numpy(), proto.sparsity_down))

        client_res[idx] = cstate.residual
        server_res = sstate.residual
        params = params + gd
    require(rk.LAUNCHES.counts["pack_chunks"] > packs,
            "the lock-step ledger did not go through pack_chunks")
    print(f"lock-step ({rounds} rounds, card vs CPU from the same inputs): "
          f"{json.dumps(worst)}")
    return last


def check_carried_selection(torch, rk, last) -> float:
    """On the last lock-step round's carried matrices, the clients' (10, n)
    and the server's (1, n): ``bin_select`` against its plain version;
    ``stc_compress_batch`` (the flat trainer's ``"kernel"`` STC, through
    ``stc_compress_rows``) under ``torch.cuda.set_sync_debug_mode("error")``
    (after a first call, which may grow the scratch); and the selection
    under ``torch.profiler``, which must show no ``aten::topk``,
    ``aten::sort`` or ``aten::kthvalue``.  Returns the sums' largest abs
    difference."""
    from torch.profiler import ProfilerActivity, profile
    k = max(int(MAIN_N * P_STC), 1)
    err = 0.0
    for name in ("carried", "server_carried"):
        x = last[name].contiguous()
        err = max(err, check_bin_select(torch, rk, x, k))
        res = torch.zeros_like(x)
        want = rk.stc_compress_batch(x, res, P_STC)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rk.stc_compress_batch(x, res, P_STC)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"two stc_compress_batch calls on the {name} matrix differ")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rk.hist_topk_threshold_batched(x, k)
            torch.cuda.synchronize()
        ops = sorted({e.name for e in prof.events()})
        banned = {"aten::topk", "aten::sort", "aten::kthvalue"} & set(ops)
        require(not banned, f"the card's selection called {sorted(banned)}")
        # host time of the selection's ops, under the profiler (which adds
        # its own overhead to each): where the host-bound selection goes
        avg = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        top = {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 4)]
               for e in avg[:12]}
        calls = sum(e.count for e in avg if e.key.startswith("aten::"))
        print(f"selection on the {name} matrix {tuple(x.shape)}: bin_select "
              f"identical to its plain version; stc_compress_batch ran under "
              f"set_sync_debug_mode('error'); {calls} aten calls (nested ones "
              f"included), host ops "
              f"by self CPU ms under torch.profiler [count, ms]: "
              f"{json.dumps(top)}")
    return err


def check_ingest_lockstep(torch, np, rk, tr, rounds=3):
    """The fused ingest on the card (decode through ``golomb_decode``, STC
    on the card) against the same ingest on the CPU, round by round on the
    card's messages from the trained state: wire words identical, the
    accumulator's sum and weight mass bitwise, the global delta's
    positions, signs and count exact and µ within rtol 1e-6.  The trainer's
    parameters and residuals are left as they were.  Returns the worst
    gaps and the last round's upstream batch."""
    from repro_torch.core.residual import ResidualState
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))
    params = tr.params_vec.clone()
    client_res = tr.client_state.residual.clone()
    server = ResidualState(tr.server_state.residual.clone())
    worst = {"mu_rtol": 0.0, "words_abs": 0.0, "sum_abs": 0.0}
    decodes = rk.LAUNCHES.counts["golomb_decode"]
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        msgs, cstate, _ = proto.encode_batch(
            deltas, ResidualState(residual=client_res[idx]))
        batch = proto.encode_wire_batch(msgs, direction="up")
        batch_c = proto.encode_wire_batch(msgs.cpu(), direction="up")
        worst["words_abs"] = max(worst["words_abs"],
                                 words_err(np, batch.words, batch_c.words))
        require(worst["words_abs"] == 0.0,
                f"ingest lock-step round {r}: wire words differ")
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        acc_c = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc_c, batch_c, w, direction="up",
                                device="cpu")
        worst["sum_abs"] = max(worst["sum_abs"],
                               float(np.abs(acc.sum - acc_c.sum).max()))
        require(np.array_equal(acc.sum, acc_c.sum)
                and acc.weight_mass == acc_c.weight_mass,
                f"ingest lock-step round {r}: accumulators differ")
        gd, server_new, st = proto.aggregate_ingest(acc, server)
        gd_c, _, st_c = proto.aggregate_ingest(
            acc_c, ResidualState(server.residual.cpu()))
        require(torch.equal(torch.sign(gd.cpu()), torch.sign(gd_c))
                and int(st.nnz) == int(st_c.nnz),
                f"ingest lock-step round {r}: global-delta positions, "
                f"signs or count differ")
        rel = abs(float(st.mu) - float(st_c.mu)) / abs(float(st_c.mu))
        require(rel <= 1e-6, f"ingest lock-step round {r}: µ off by rtol "
                             f"{rel:.3e} > 1e-6")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)
        client_res[idx] = cstate.residual
        server = server_new
        params = params + gd
    require(rk.LAUNCHES.counts["golomb_decode"] > decodes,
            "the ingest lock-step did not decode through golomb_decode")
    print(f"ingest lock-step ({rounds} rounds, card vs CPU on the card's "
          f"messages): {json.dumps(worst)}")
    return worst, batch


def check_golomb_at_path(torch, np, rk, proto, batch) -> float:
    """``golomb_decode`` on an ingest round's batch (the path's own W)
    against its plain version on the card and the numpy scan; returns the
    largest field difference (0.0)."""
    from repro_torch.core import wire
    b = wire._b_star_checked(proto.sparsity_up)
    raised, err = golomb_vs_plain(torch, np, rk, batch.words,
                                  batch.word_start, batch.bit_len, batch.nnz,
                                  batch.numel, b)
    require(not raised, "golomb_decode raised on a valid ingest batch")
    got = wire.decode_ternary_fields_batch(batch, proto.sparsity_up,
                                           backend="kernel", device="cuda")
    want = wire.decode_ternary_fields_batch(batch, proto.sparsity_up)
    require(all(g.dtype == h.dtype and np.array_equal(g, h)
                for g, h in zip(got, want)),
            "golomb_decode fields differ from the numpy scan")
    print(f"golomb_decode at the ingest path's W={batch.words.size} "
          f"({got[1].size} codewords, {batch.n_msgs} segments): fields "
          f"identical to its plain version and the numpy scan")
    return err


SIGN_KERNELS = ("pack_sign_planes", "sign_plane_tally")


def check_signsgd_ingest(torch, np, rk, rounds=3):
    """signSGD through the fused ingest: the cnn trainer's rounds on the
    card (counters set to 0 just before): one ``pack_sign_planes`` launch
    (the upstream batch) and one ``sign_plane_tally`` launch a round, and
    no per-plane ``pack_bits`` or ``unpack_bits``; then 3 lock-step rounds
    card against CPU from its state: messages, wire words (also against the
    host packer), unpacked sign bits, accumulator (also against the host
    backend's default loop) and global delta identical.  Returns the launch
    counts and shapes of its rounds, and the last lock-step round's
    messages, batch and weights."""
    from repro_torch.core import wire
    from repro_torch.fed.loop import local_sgd
    tr = make_trainer("cuda", torch, ingest=True, codec="signsgd")
    require(tr.ingest, "the signSGD trainer is not on the ingest path")
    rk.LAUNCHES.reset()
    tr.run(rounds, eval_every=rounds)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES.counts)
    shapes = dict(rk.LAUNCHES.shapes)
    require(all(launches[k] == rounds for k in SIGN_KERNELS)
            and launches["pack_bits"] == launches["unpack_bits"] == 0,
            f"the signSGD ingest path launched pack_sign_planes "
            f"{launches['pack_sign_planes']}, sign_plane_tally "
            f"{launches['sign_plane_tally']}, pack_bits "
            f"{launches['pack_bits']} and unpack_bits "
            f"{launches['unpack_bits']} times in {rounds} rounds, not once "
            f"a round each of the first two and never the last two")
    require(bool(torch.isfinite(tr.params_vec).all()), "non-finite params")
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))
    params = tr.params_vec.clone()
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        msgs, _, _ = proto.encode_batch(deltas, None)
        msgs_c, _, _ = proto.encode_batch(deltas.cpu(), None)
        require(torch.equal(msgs.cpu(), msgs_c),
                f"signSGD lock-step round {r}: messages differ")
        batch = proto.encode_wire_batch(msgs, direction="up")
        batch_c = proto.encode_wire_batch(msgs_c, direction="up")
        batch_h = host.encode_wire_batch(msgs_c, direction="up")
        for other in (batch_c, batch_h):
            require(words_err(np, batch.words, other.words) == 0.0
                    and all(np.array_equal(getattr(batch, f),
                                           getattr(other, f))
                            for f in ("word_start", "word_count", "bit_len",
                                      "mu", "nnz"))
                    and batch.numel == other.numel,
                    f"signSGD lock-step round {r}: wire batches differ")
        for i in range(p):
            bits = wire.sign_plane_bits(batch.message(i), backend="kernel",
                                        device=tr.device)
            bits_c = wire.sign_plane_bits(batch_c.message(i),
                                          backend="kernel", device="cpu")
            require(np.array_equal(bits, bits_c),
                    f"signSGD lock-step round {r}: unpacked bits differ")
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        acc_c = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc_c, batch_c, w, direction="up",
                                device="cpu")
        acc_h = host.make_ingest(tr.numel)
        host.ingest_wire_batch(acc_h, batch_h, w, direction="up")
        for other in (acc_c, acc_h):
            require(np.array_equal(acc.sum.view(np.uint64),
                                   other.sum.view(np.uint64))
                    and (acc.nnz, acc.n_msgs, acc.weight_mass,
                         acc.stream_bits)
                    == (other.nnz, other.n_msgs, other.weight_mass,
                        other.stream_bits),
                    f"signSGD lock-step round {r}: accumulators differ")
        gd, _, _ = proto.aggregate_ingest(acc, None)
        gd_c, _, _ = proto.aggregate_ingest(acc_c, None)
        require(torch.equal(gd, gd_c),
                f"signSGD lock-step round {r}: global deltas differ")
        params = params + gd.to(tr.device)
    print(f"signSGD ingest: {rounds} rounds on the card, launches "
          f"{json.dumps(launches)}; {rounds} lock-step rounds card vs CPU: "
          f"messages, words, unpacked bits, accumulator (also the host "
          f"backend's) and global delta identical")
    return launches, shapes, {"msgs": msgs, "batch": batch, "weights": w,
                              "trainer": tr}


def run_bisection(torch, np, rk):
    """The bisection path through its entry point,
    ``stc_compress_kernel(selector="bisect")``, at the cnn's width, counters
    set to 0 just before: exactly one ``bisect_select`` launch (all iters +
    1 = 33 rounds), one ``stc_apply`` and no ``threshold_stats``; then
    ``threshold_stats`` through its own entry point at the selected
    threshold (one launch, counting k): a check only, whose launch is not
    counted (no path launches ``threshold_stats``).  Returns the path's
    launch counts and shapes."""
    rng = np.random.default_rng(3)
    delta = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-3).astype(np.float32)).to("cuda")
    residual = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-4).astype(np.float32)).to("cuda")
    rk.LAUNCHES.reset()
    tern, res, mu, thresh, cnt = rk.stc_compress_kernel(
        delta, residual, P_STC, selector="bisect")
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES.counts)
    shapes = dict(rk.LAUNCHES.shapes)
    require(launches["bisect_select"] == 1 and launches["stc_apply"] == 1
            and launches["threshold_stats"] == 0,
            f"the bisection path launched bisect_select "
            f"{launches['bisect_select']} times, stc_apply "
            f"{launches['stc_apply']} and threshold_stats "
            f"{launches['threshold_stats']}, not 1, 1 and 0")
    k = max(int(MAIN_N * P_STC), 1)
    require(int(cnt) == k and int((tern != 0).sum()) == k
            and bool(torch.isfinite(res).all()) and float(mu) > 0,
            "the bisection path's message is wrong")
    print(f"bisection path: stc_compress_kernel(selector='bisect') at n="
          f"{MAIN_N}, k={k}: count {int(cnt)}, launches "
          f"{json.dumps(launches)}")
    carried = delta + residual
    rk.LAUNCHES.reset()
    c_t, s_t = rk.threshold_stats(carried, thresh)
    torch.cuda.synchronize()
    require(rk.LAUNCHES.counts["threshold_stats"] == 1 and int(c_t) == k
            and bool(torch.allclose(s_t, mu * k, rtol=1e-6, atol=0.0)),
            "threshold_stats at the selected threshold is not one launch "
            "counting k with the selection's mass")
    return launches, shapes


# ---------------------------------------------------------------- phase 4

KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")

def event_ms(torch, fn, iters=50, hold_stream=True, warm=True) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA events).

    With ``hold_stream`` a sleep kernel holds the stream while the host
    enqueues every launch, so the wrapper's host overhead does not show:
    the events then time the device work alone.  A ``fn`` that
    synchronizes inside must pass ``hold_stream=False`` (host included);
    without ``warm`` (then also without the hold) it is timed from its
    first call, as the plain versions at the LM rows are (each takes
    seconds there).
    """
    t0 = time.perf_counter()
    for _ in range(iters if warm else 0):        # warm-up, and the host's
        fn()                                     # enqueue time for the hold
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_stream:
        torch.cuda._sleep(int(4e6 * host_ms) + 2_000_000)  # ~2 cycles/ns
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def upstream_chunks(np, last):
    """The chunks of the last lock-step round's upstream batch, as the
    ``"kernel"`` backend hands them to ``pack_chunks`` in the per-client
    regime: ``(vals, lens, offs, total_bits)``."""
    from repro_torch.core import wire
    up = last["upstream"]
    vals, lens, offs, batch = wire._client_chunks_batch(
        up, [np.flatnonzero(r) for r in up], wire._b_star_checked(P_STC))
    return vals, lens, offs, 32 * int(batch.word_count.sum())


def row_scale(torch, x):
    """The k-selection's per-row scale, 256 / max|x| (0 for a row of zeros
    and subnormals)."""
    a_max = x.abs().amax(dim=1)
    return torch.where(a_max >= FLT_MIN, 256.0 / a_max,
                       torch.zeros_like(a_max))


def time_histogram(torch, rk, mats):
    """The histogram's device time on each named ``(x, scale)`` at 1, 2 and
    4 CTAs an SM (the launch's grid), printed; returns the times at the
    shipped setting."""
    from repro_torch.kernels import hist_select
    shipped = hist_select._CTAS_PER_SM
    sweep = {}
    try:
        for per_sm in (1, 2, 4):
            hist_select._CTAS_PER_SM = per_sm
            sweep[per_sm] = {
                name: event_ms(torch, lambda x=x, sc=sc:
                               rk.magnitude_histogram_batched(x, sc))
                for name, (x, sc) in mats.items()}
    finally:
        hist_select._CTAS_PER_SM = shipped
    print(f"histogram ms by CTAs an SM (shipped: {shipped}): "
          f"{json.dumps(sweep)}")
    return sweep[shipped]


def golomb_row(torch, np, rk, launches, errs, batch, p, bound, passes):
    """``golomb_decode`` on an ingest round's batch: device time of its one
    launch (the segment table uploaded once) and its plan, the wrapper
    on card words (fields to the host in one copy), the wire backend's
    decode (words up too), the plain version on the card and the numpy
    field scan
    (host included), and the byte bound of this batch; ``passes`` is what
    the profiler saw in ``--wire-passes``."""
    from repro_torch.core import wire
    b = wire._b_star_checked(p)
    ws, bl, nnz = (np.asarray(a, np.int64)
                   for a in (batch.word_start, batch.bit_len, batch.nnz))
    table = [torch.from_numpy(a) for a in (ws, bl, nnz)]
    w = torch.from_numpy(np.ascontiguousarray(batch.words, np.uint32)
                         .view(np.int32)).to("cuda")
    launch, plan = decode_launch(torch, np, batch, b)
    n_words, n_seg, n_out = w.numel(), ws.size, int(nnz.sum())
    backend = wire.get_wire_backend("kernel", "cuda")
    return {
        "name": "golomb_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/golomb_decode.cu",
        "replaces": "src/repro/kernels/wiredecode.py:57",
        "launches": launches["golomb_decode"],
        "max_abs_err": errs["golomb_decode"],
        "ms": event_ms(torch, launch),
        "plain_ms": event_ms(torch, lambda: rk.decode_golomb_fields_plain(
            w, *table, batch.numel, b), iters=10, hold_stream=False),
        # words, the (start, length, nnz) table and the status read once;
        # position and sign written once a codeword
        "bound_ms": bound(4 * n_words + 24 * n_seg + 24 * n_seg
                          + 12 * n_out), "bound_by": "bytes",
        "library_ms": None, "plan": list(plan),
        "wrapper_ms": event_ms(torch, lambda: rk.decode_golomb_fields(
            w, *table, batch.numel, b), iters=20, hold_stream=False),
        "backend_ms": event_ms(torch, lambda: backend.decode_fields(
            batch.words, ws, bl, nnz, batch.numel, b), iters=20,
            hold_stream=False),
        "numpy_ms": event_ms(torch, lambda: wire._decode_fields_numpy(
            batch.words, ws, bl, nnz, batch.numel, b), iters=5,
            hold_stream=False),
        "pass_ms": passes,
        "words": n_words, "codewords": n_out, "segments": n_seg}


# ---------------------------------------------- the wire kernels' launches

def decode_launch(torch, np, batch, b):
    """``golomb_decode``'s launch alone on ``batch`` at Golomb parameter
    ``b`` (words and segment table uploaded once), on the package of the
    tree the file sits in (a copy inside a parent checkout times the
    parent's three passes): ``(launch, plan)``, the plan None for the
    parent."""
    from repro_torch.kernels import wiredecode
    ws, bl, nnz = (np.asarray(a, np.int64)
                   for a in (batch.word_start, batch.bit_len, batch.nnz))
    w = torch.from_numpy(np.ascontiguousarray(batch.words, np.uint32)
                         .view(np.int32)).to("cuda")
    meta_np = wiredecode._segment_meta(ws, bl, nnz)
    meta = torch.from_numpy(meta_np).to("cuda")
    if not hasattr(wiredecode, "decode_plan"):        # the parent's passes
        n_chunks, n_out = int(meta_np[-1, 2]), int(meta_np[-1, 3])
        return (lambda: wiredecode._launch_decode(w, meta, n_chunks, n_out,
                                                  b)), None
    plan = wiredecode.decode_plan(
        int(-(-bl.max(initial=0) // wiredecode._CHUNK_BITS)))
    n_out = int(meta_np[-1, 2])
    return (lambda pl=plan: wiredecode._launch_decode(w, meta, pl, n_out,
                                                      b)), plan


def wire_shapes(np, long_segment=False):
    """The wire kernels' shapes: ``golomb_decode`` on a cnn ingest round's
    batch (10 segments), on one cnn message (the event server's and the
    buffered ingest's launch), on the chunked codec's widest width group
    (740 segments of 4,096 coordinates) and, with ``long_segment``, on one
    segment of 2,000,000 coordinates (longer than a cluster's tile, on no
    path); ``pack_chunks`` on a cnn round's upstream chunks.  Returns
    ``({name: batch}, chunks)``, all at p = 1/50."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _golomb_cases as gc
    from repro_torch.core import wire
    rng = np.random.default_rng(27)
    x = np.stack([gc.ternary(rng, MAIN_N, P_STC) for _ in range(MAIN_ROWS)])
    group = np.stack([gc.ternary(rng, CHUNK, P_STC) for _ in range(740)])
    batches = {
        "cnn_batch": wire.encode_ternary_words_batch(x, P_STC),
        "one_message": wire.encode_ternary_words_batch(x[:1], P_STC),
        "chunked_group": wire.encode_ternary_words_batch(group, P_STC)}
    if long_segment:
        batches["long_segment"] = wire.encode_ternary_words_batch(
            gc.ternary(rng, 2_000_000, P_STC)[None], P_STC)
    vals, lens, offs, up = wire._client_chunks_batch(
        x, [np.flatnonzero(r) for r in x], wire._b_star_checked(P_STC))
    return batches, (vals, lens, offs, 32 * int(up.word_count.sum()))


def wire_passes(torch, np, rk):
    """``--wire-passes``, which phase 6 runs in a fresh process (as
    ``--select-passes``, and again in a new one on ``ProfilerBlind``): one
    call a ``torch.profiler`` session of
    ``golomb_decode``'s launch at each of ``wire_shapes`` and of
    ``pack_chunks`` on the upstream chunks.  Fails unless the decode ran
    exactly one launch of one kernel and ``pack_chunks`` exactly one device
    operation (no memset).  Prints the device times (ms), and the seconds
    the whole check took, as one JSON line."""
    from repro_torch.core import wire
    t0 = time.perf_counter()
    batches, chunks = wire_shapes(np)
    b = wire._b_star_checked(P_STC)
    out = {"golomb_decode": {}}
    for name, batch in batches.items():
        launch, plan = decode_launch(torch, np, batch, b)
        calls = launch_profile(torch, launch)
        require(len(calls) == 1
                and all(c["launches"] == 1 for c in calls.values()),
                f"golomb_decode at {name} ran {calls}, not one launch of "
                f"one kernel")
        out["golomb_decode"][name] = {"plan": list(plan), **{
            kname: c["ms"] for kname, c in calls.items()}}
    t = chunk_tensors(torch, np, *chunks[:3])
    ops = device_ops(torch, lambda: rk.pack_chunks(*t, chunks[3]))
    if ops is None:
        raise ProfilerBlind("torch.profiler recorded no device activity "
                            "for pack_chunks")
    require(len(ops) == 1,
            f"pack_chunks ran {len(ops or ())} device operations, not 1: "
            f"{ops}")
    out["pack_chunks"] = ops
    out["seconds"] = time.perf_counter() - t0
    print(f"wire passes: {json.dumps(out)}")
    return out


def run_wire_passes():
    """``--wire-passes``' JSON line, from ``run_passes``."""
    return run_passes()["wire"]


WIRE_STUDY_CLUSTERS = (1, 2, 4, 8, 16)
DECODE_STEPS = ("table_read", "words_staged", "decoded", "composed",
                "maps_sent", "cluster_barrier", "entries", "written", "done")


def stamped_decode(torch):
    """``csrc/golomb_decode.cu`` built with ``-DGOLOMB_DECODE_STAMPS``: a
    function that runs a launch of the package's wrapper (``decode_launch``)
    five times on the stamped library and returns CTA 0's steps of its
    first tile in the last launch, µs from its start, and its SM clock over
    the launch."""
    import ctypes
    import hashlib
    from repro_torch.kernels import _build
    src = _build.CSRC / "golomb_decode.cu"
    lib_path = _build.BUILD_DIR / (
        f"libgolomb_decode_stamps-"
        f"{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so")
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DGOLOMB_DECODE_STAMPS", "-o", str(lib_path),
                        str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    stamped = lib.golomb_decode
    stamped.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p] * 4)
    stamped.restype = ctypes.c_int
    lib.golomb_decode_stamps.argtypes = [ctypes.c_void_p]
    key = ("golomb_decode", "golomb_decode")

    def steps(launch):
        shipped = _build._ENTRIES.get(key)
        _build._ENTRIES[key] = stamped
        try:
            for _ in range(5):
                launch()
            torch.cuda.synchronize()
        finally:
            if shipped is None:
                del _build._ENTRIES[key]
            else:
                _build._ENTRIES[key] = shipped
        buf = (ctypes.c_ulonglong * 12)()
        require(lib.golomb_decode_stamps(buf) == 0, "stamps not read")
        out = {step: (buf[i + 1] - buf[0]) / 1e3
               for i, step in enumerate(DECODE_STEPS)}
        out["sm_clock_ghz"] = (buf[11] - buf[10]) / max(buf[9] - buf[0], 1)
        return out
    return steps


def wire_study(torch, np, rk):
    """``--wire-study``: the wire kernels of the package of the tree the
    file sits in (a copy inside a parent checkout times the parent) at
    ``wire_shapes``, by CUDA events: ``golomb_decode``'s launch alone (ms)
    and the ``"kernel"`` wire backend's decode, fields to the host (host
    included, ``wrapper_ms``); ``pack_chunks`` (ms).  On a package with
    ``decode_plan``, also the launch in every cluster size (each checked
    against the plain version first) and the steps of its first CTA from a
    stamped build.  One JSON line a shape."""
    from repro_torch.core import wire
    from repro_torch.kernels import wiredecode
    print(f"card: {card_line()}; package "
          f"{Path(rk.__file__).resolve().parents[1]}", flush=True)
    batches, chunks = wire_shapes(np, long_segment=True)
    b = wire._b_star_checked(P_STC)
    backend = wire.get_wire_backend("kernel", "cuda")
    steps = (stamped_decode(torch) if hasattr(wiredecode, "decode_plan")
             else None)
    if steps is not None:
        from repro_torch.kernels import _build
        cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
        lib = _build.build_all(("golomb_decode",))["golomb_decode"]
        print(f"golomb_decode SASS loads, stores, shuffles and barriers: "
              f"""{json.dumps(sass_opcodes(cuobjdump, lib, (
                  "LD.", "LDS", "ST.", "STS", "LDG", "STG", "SHFL", "BAR",
                  "UCGABAR")))}""", flush=True)
    for name, batch in batches.items():
        launch, plan = decode_launch(torch, np, batch, b)
        ws, bl, nnz = (np.asarray(a, np.int64) for a in (
            batch.word_start, batch.bit_len, batch.nnz))
        rec = {"words": int(batch.words.size), "segments": int(ws.size),
               "codewords": int(nnz.sum()),
               "plan": list(plan) if plan else "three passes",
               "ms": event_ms(torch, launch),
               "wrapper_ms": event_ms(torch, lambda: backend.decode_fields(
                   batch.words, ws, bl, nnz, batch.numel, b), iters=20,
                   hold_stream=False)}
        if plan is not None:
            rec["steps_us"] = steps(launch)
            rec["clusters_ms"] = study_clusters(torch, np, rk, wiredecode,
                                                batch, b)
        print(f"wire study golomb_decode {name}: {json.dumps(rec)}",
              flush=True)
    t = chunk_tensors(torch, np, *chunks[:3])
    rec = {"chunks": int(chunks[0].size), "words": chunks[3] // 32,
           "ms": event_ms(torch, lambda: rk.pack_chunks(*t, chunks[3]))}
    print(f"wire study pack_chunks: {json.dumps(rec)}", flush=True)


def study_clusters(torch, np, rk, wiredecode, batch, b):
    """``golomb_decode``'s launch on ``batch`` in each of
    ``WIRE_STUDY_CLUSTERS`` (threads by the plan's rule for the CTA's
    chunks), each first held bitwise against the plain version."""
    ws, bl, nnz = (np.asarray(a, np.int64)
                   for a in (batch.word_start, batch.bit_len, batch.nnz))
    table = [torch.from_numpy(a) for a in (ws, bl, nnz)]
    w = torch.from_numpy(np.ascontiguousarray(batch.words, np.uint32)
                         .view(np.int32)).to("cuda")
    want = rk.decode_golomb_fields_plain(w, *table, batch.numel, b)
    want = [h.cpu() for h in want]
    n_max = int(-(-bl.max(initial=0) // wiredecode._CHUNK_BITS))
    chosen, out = wiredecode.decode_plan, {}
    try:
        for cluster in WIRE_STUDY_CLUSTERS:
            plan = wiredecode._cluster_plan(n_max, cluster)
            wiredecode.decode_plan = lambda *args, pl=plan: pl
            got = rk.decode_golomb_fields(w, *table, batch.numel, b)
            require(all(torch.equal(g, h) for g, h in zip(got, want)),
                    f"golomb_decode on {plan} differs from its plain "
                    f"version")
            launch, _ = decode_launch(torch, np, batch, b)
            out[cluster] = event_ms(torch, launch)
    finally:
        wiredecode.decode_plan = chosen
    return out


def select_row(torch, rk, launches, errs, last, bound):
    """``bin_select`` on the last lock-step round's carried matrices, the
    clients' (10, n) and the server's (1, n), at the inputs the selection
    gives it: device time, its route and its count of reads (one), the
    plain version (host included: it synchronizes), the byte bound and
    ``torch.topk`` of the same matrix; and the whole k-selection, host
    included and in device time, beside ``torch.topk`` in both.  Then the
    two-read route's overflow witness, and each route's launches at the
    paths' shapes by the profiler in a fresh process (``pass_ms``)."""
    k = max(int(MAIN_N * P_STC), 1)
    row = {"name": "bin_select", "route": "cuda",
           "source": "src/repro_torch/csrc/bin_select.cu",
           "replaces": "src/repro/kernels/hist_select.py:292",
           "launches": launches["bin_select"],
           "max_abs_err": errs["bin_select"], "bound_by": "bytes"}
    for name, sfx in (("carried", ""), ("server_carried", "_b1")):
        x = last[name].contiguous()
        rows, n = x.shape
        scale, b, r, cnt_b = select_inputs(torch, x, k)
        a = x.abs()

        def kernel(x=x, scale=scale, b=b, r=r):
            return rk.candidate_select_batched(x, scale, b, r)

        def topk(a=a):
            return torch.topk(a, k, dim=1)

        def select(x=x):
            return rk.hist_topk_threshold_batched(x, k)

        def topk_abs(x=x):
            return torch.topk(x.abs(), k, dim=1)

        row["ms" + sfx] = event_ms(torch, kernel)
        row["plain_ms" + sfx] = event_ms(
            torch, lambda x=x, scale=scale, b=b, r=r:
            rk.candidate_select_plain(x, scale, b, r), iters=10,
            hold_stream=False)
        # x read once; scale, b and r read and v, cnt_in, sum_in written
        row["bound_ms" + sfx] = bound(4 * rows * n + 20 * rows + 12 * rows)
        row["library_ms" + sfx] = event_ms(torch, topk)
        for key, val in select_structure(torch, rk, x, scale, b, r,
                                         full_reads=1).items():
            row[key + sfx] = val
        row["cnt_b" + sfx] = cnt_b.tolist()
        sel = {"host": event_ms(torch, select, iters=20, hold_stream=False),
               "device": event_ms(torch, select, iters=20)}
        ref = {"host": event_ms(torch, topk_abs, iters=20, hold_stream=False),
               "device": event_ms(torch, topk_abs, iters=20)}
        row["selection_ms" + sfx], row["topk_ms" + sfx] = sel, ref
        print(f"selection on the {name} matrix ({rows}, {n}), k={k}: "
              f"histogram route host included {sel['host']:.4f} ms, device "
              f"{sel['device']:.4f} ms; torch.topk of |x| host included "
              f"{ref['host']:.4f} ms, device {ref['device']:.4f} ms")
    witness, err = select_witness(torch, rk)
    row["witness_1x4000037"] = witness
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["pass_ms"] = run_select_passes()
    return row


def bisect_row(torch, rk, launches, errs, x1, bound):
    """The fused bisection on the bisection path's vector: device time and
    host included, and per step (iters + 1 = 33 steps: 32 bisection steps,
    settled two a round, and the final count); the plain loop (device time: its ~300 small launches
    queue behind the hold two calls at a time); the bound, one read of x;
    and ``torch.topk`` of ``|x|``, the library call that selects the same
    k, in device time and host included.  Then both in device time at
    n = 17 (below one warp a CTA) and n = 4,000,037 (past the cluster's
    shared memory, 917,504 elements), where the kernel is not held to its
    bound."""
    n = x1.numel()
    k = max(int(n * P_STC), 1)
    steps = 33

    def kernel():
        return rk.topk_threshold(x1, k)

    def topk():
        return torch.topk(x1.abs(), k)

    row = {"name": "bisect_select", "route": "cuda",
           "source": "src/repro_torch/csrc/bisect_select.cu",
           "replaces": "src/repro/kernels/topk_threshold.py:104",
           "launches": launches["bisect_select"],
           "max_abs_err": errs["bisection"]}
    row["ms"] = event_ms(torch, kernel)
    row["ms_host"] = event_ms(torch, kernel, iters=20, hold_stream=False)
    row["us_per_step"] = row["ms"] * 1e3 / steps
    row["plain_ms"] = event_ms(
        torch, lambda: rk.topk_threshold_plain(x1, k), iters=1)
    row["plain_ms_host"] = event_ms(
        torch, lambda: rk.topk_threshold_plain(x1, k), iters=5,
        hold_stream=False)
    row["bound_ms"] = bound(4 * n + 4 + 4 + 4)   # x once; lo, cnt, sum
    row["bound_by"] = "bytes"
    row["library_ms"] = event_ms(torch, topk)
    row["library_ms_host"] = event_ms(torch, topk, iters=20,
                                      hold_stream=False)
    print(f"bisect_select at n={n}, k={k}, {steps} steps: device "
          f"{row['ms']:.4f} ms ({row['us_per_step']:.3f} us a step), host "
          f"included {row['ms_host']:.4f} ms; torch.topk of |x| device "
          f"{row['library_ms']:.4f} ms, host included "
          f"{row['library_ms_host']:.4f} ms; bound {row['bound_ms']:.5f} ms")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for m in (17, 4_000_037):
        xm = torch.randn(m, generator=gen, device="cuda")
        km = max(int(m * P_STC), 1)
        ms = event_ms(torch, lambda: rk.topk_threshold(xm, km))
        lib = event_ms(torch, lambda: torch.topk(xm.abs(), km))
        row[f"ms_n{m}"], row[f"library_ms_n{m}"] = ms, lib
        print(f"bisect_select at n={m}, k={km}: device {ms:.4f} ms, "
              f"torch.topk of |x| {lib:.4f} ms, bound "
              f"{bound(4 * m + 12):.5f} ms")
    return row


def sign_plane_kernel_rows(torch, np, rk, shapes, launches, errs, signsgd,
                           bound):
    """The four sign-plane rows on the last signSGD lock-step round: the
    path's kernels ``pack_sign_planes`` on its (B, n) messages and
    ``sign_plane_tally`` on its (B, W) words into an fp64 sum of n, and the
    uint8 forms no path launches (``pack_bits``, ``unpack_bits``: 0
    launches, timed at one plane and at the batch, through their own
    entries).  Beside the kernels: their plain versions on the card, ten
    one-plane launches (what the path ran before it was batched), and for
    the tally the host loop it replaces (``add_sign_plane`` over the
    unpacked planes, host clock) and the ingest step host included (words
    and sum up, one launch, sum down)."""
    from repro_torch.core.ingest import IngestAccumulator
    from repro_torch.core.wire import words_to_bits
    msgs = signsgd["msgs"].contiguous()
    rows, n = shapes["pack_sign_planes"]
    require(tuple(msgs.shape) == (rows, n),
            f"signSGD messages {tuple(msgs.shape)} are not the path's "
            f"pack_sign_planes shape {(rows, n)}")
    batch, weights = signsgd["batch"], signsgd["weights"]
    n_words = -(-n // 32)
    words_np = batch.words.reshape(rows, n_words)
    words = torch.from_numpy(words_np.view(np.int32)).to("cuda")
    w64 = torch.from_numpy(np.asarray(weights, np.float64)).to("cuda")
    total = torch.zeros(n, dtype=torch.float64, device="cuda")
    bits = (msgs > 0).to(torch.uint8)
    planes = [bits[i] for i in range(rows)]
    word_rows = [words[i] for i in range(rows)]

    def ten_packs():
        for plane in planes:
            rk.pack_bits(plane)

    def ten_unpacks():
        for row in word_rows:
            rk.unpack_words_with_counts(row)

    def host_loop():
        acc = IngestAccumulator(n)
        for i in range(rows):
            acc.add_sign_plane(words_to_bits(words_np[i], n), 2e-4,
                               float(weights[i]))

    def tally_step():
        host = np.zeros(n)
        t = torch.from_numpy(host).to("cuda")
        rk.sign_plane_tally(torch.from_numpy(words_np.view(np.int32))
                            .to("cuda"), 2e-4, torch.from_numpy(
                                np.asarray(weights, np.float64)).to("cuda"),
                            t)
        torch.from_numpy(host).copy_(t)

    def plain_tally():
        rk.sign_plane_tally_plain(words, 2e-4, w64, total)

    out = [{
        "name": "pack_sign_planes", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_sign_planes"],
        "max_abs_err": errs["pack_sign_planes"],
        "ms": event_ms(torch, lambda: rk.pack_sign_planes(msgs)),
        "plain_ms": event_ms(torch, lambda: rk.pack_sign_planes_plain(msgs)),
        # fp32 values read once, words written once
        "bound_ms": bound(4 * rows * n + 4 * rows * n_words),
        "bound_by": "bytes", "library_ms": None,
        "ms_b1": event_ms(torch, lambda: rk.pack_sign_planes(msgs[:1])),
        "bound_ms_b1": bound(4 * n + 4 * n_words),
        "ms_ten_pack_bits_launches": event_ms(torch, ten_packs)}, {
        "name": "pack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_bits"],
        "max_abs_err": errs["pack_bits"],
        "ms": event_ms(torch, lambda: rk.pack_bits(planes[0])),
        "plain_ms": event_ms(torch, lambda: rk.pack_bits_plain(planes[0])),
        "bound_ms": bound(n + 4 * n_words), "bound_by": "bytes",
        "library_ms": None, "on_path": False,
        "ms_batched": event_ms(torch, lambda: rk.pack_bits_batched(bits)),
        "bound_ms_batched": bound(rows * (n + 4 * n_words))}, {
        "name": "sign_plane_tally", "route": "cuda",
        "source": "src/repro_torch/csrc/unpack_bits.cu",
        "replaces": "src/repro/kernels/wiredecode.py:57",
        "launches": launches["sign_plane_tally"],
        "max_abs_err": errs["sign_plane_tally"],
        "ms": event_ms(torch, lambda: rk.sign_plane_tally(words, 2e-4, w64,
                                                          total)),
        "plain_ms": event_ms(torch, plain_tally, iters=10),
        # words and weights read once, the fp64 sum read and written once
        "bound_ms": bound(4 * rows * n_words + 8 * rows + 16 * n),
        "bound_by": "bytes", "library_ms": None,
        "host_loop_ms": event_ms(torch, host_loop, iters=5,
                                 hold_stream=False),
        "step_ms_host": event_ms(torch, tally_step, iters=20,
                                 hold_stream=False),
        "ms_ten_unpack_bits_launches": event_ms(torch, ten_unpacks)}, {
        "name": "unpack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/unpack_bits.cu",
        "replaces": "src/repro/kernels/wiredecode.py:57",
        "launches": launches["unpack_bits"],
        "max_abs_err": errs["unpack_bits"],
        "ms": event_ms(torch, lambda: rk.unpack_words_with_counts(
            word_rows[0])),
        "plain_ms": event_ms(torch, lambda: rk.unpack_words_plain(
            word_rows[0])),
        "bound_ms": bound(4 * n_words + 32 * n_words + 4 * n_words),
        "bound_by": "bytes", "library_ms": None, "on_path": False,
        "ms_batched": event_ms(torch, lambda: rk.unpack_words_batched(words)),
        "bound_ms_batched": bound(rows * 40 * n_words)}]
    return out


def time_kernels(torch, np, rk, shapes, launches, errs, last, batch_in,
                 signsgd):
    """Device time of each kernel at its path's shapes beside its plain
    version, its byte bound and (where one PyTorch call computes the same
    function) that call; the k-selections beside ``torch.topk``.  ``last``
    is the last lock-step round: the histogram is timed on its carried
    matrices (the main path's inputs) and on a normal matrix,
    ``pack_chunks`` on the chunks of its upstream batch; ``golomb_decode``
    on the last ingest lock-step round's batch; the sign-plane kernels on
    the last signSGD lock-step round's messages and batch (``signsgd``)."""
    from repro_torch.core.selection import bin_index
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, n = MAIN_ROWS, MAIN_N          # the encode phase's (P, n) launch
    x = torch.from_numpy(
        (rng.standard_normal((rows, n)) * 1e-3).astype(np.float32)).to(dev)
    k = max(int(n * P_STC), 1)
    scale = row_scale(torch, x)
    t, c, s = rk.hist_topk_threshold_batched(x, k)
    mu = s / c.to(torch.float32)
    carried = last["carried"].contiguous()
    c_scale = row_scale(torch, carried)
    c_bins = bin_index(carried.abs(), c_scale[:, None], 256)
    print(f"carried matrix of the last lock-step round {tuple(carried.shape)}"
          f": share in bin 0 {float((c_bins == 0).double().mean()):.6f}, "
          f"bin 1 {float((c_bins == 1).double().mean()):.6f}, bins 2-255 "
          f"{float((c_bins >= 2).double().mean()):.6f}")
    server = last["server_carried"].contiguous()
    hist_ms = time_histogram(torch, rk, {
        "carried": (carried, c_scale), "normal": (x, scale),
        "server_carried": (server, row_scale(torch, server))})
    vals, lens, offs, up_bits = upstream_chunks(np, last)
    up_words = up_bits // 32
    chunks = chunk_tensors(torch, np, vals, lens, offs)
    n_stats = shapes["bisect_select"][0]   # threshold_stats's own row
    x1 = x[0, :n_stats].contiguous()
    t1 = x1.abs().quantile(1 - P_STC)

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    # the histogram's library yardstick: two row-offset bincounts (counts;
    # sums through weights=) over the same bins
    a = carried.abs()
    flat_bins = (bin_index(a, c_scale[:, None], 256).to(torch.int64)
                 + 256 * torch.arange(rows, device=dev)[:, None]).reshape(-1)
    flat_a = a.reshape(-1)

    def bincount_hist():
        return (torch.bincount(flat_bins, minlength=256 * rows),
                torch.bincount(flat_bins, weights=flat_a,
                               minlength=256 * rows))

    def hist_bound(b):                   # x and scale read, 8 bytes a bin
        return bound(4 * b * n + 4 * b + 8 * 256 * b)

    out = []
    nb = rows * n * 4
    out.append({
        "name": "stc_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/stc_apply.cu",
        "replaces": "src/repro/kernels/stc_compress.py:56",
        "launches": launches["stc_apply"], "max_abs_err": errs["stc_apply"],
        "ms": event_ms(torch, lambda: rk.stc_apply_batched(x, t, mu)),
        "plain_ms": event_ms(torch, lambda: rk.stc_apply_plain(x, t, mu)),
        "bound_ms": bound(3 * nb + 8 * rows), "bound_by": "bytes",
        "library_ms": None})
    out.append({
        "name": "magnitude_histogram", "route": "cuda",
        "source": "src/repro_torch/csrc/histogram.cu",
        "replaces": "src/repro/kernels/hist_select.py:123",
        "launches": launches["histogram"], "max_abs_err": errs["histogram"],
        "ms": hist_ms["carried"],
        "plain_ms": event_ms(
            torch, lambda: rk.magnitude_histogram_plain(carried, c_scale)),
        "bound_ms": hist_bound(rows), "bound_by": "bytes",
        "library_ms": event_ms(torch, bincount_hist),
        "ms_normal": hist_ms["normal"],
        "ms_server_b1": hist_ms["server_carried"],
        "bound_ms_b1": hist_bound(1)})
    out.append(select_row(torch, rk, launches, errs, last, bound))
    out.append({
        "name": "pack_chunks", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_chunks.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_chunks"],
        "max_abs_err": errs["pack_chunks"],
        "ms": event_ms(torch, lambda: rk.pack_chunks(*chunks, up_bits)),
        # the plain version sizes its bit plane on the host: host included
        "plain_ms": event_ms(
            torch, lambda: rk.pack_chunks_plain(*chunks, up_bits),
            iters=20, hold_stream=False),
        "bound_ms": bound(20 * len(vals) + 4 * up_words), "bound_by": "bytes",
        "library_ms": None, "chunks": len(vals), "words": up_words})
    out.extend(sign_plane_kernel_rows(torch, np, rk, shapes, launches, errs,
                                      signsgd, bound))
    passes = run_wire_passes()
    next(row for row in out if row["name"] == "pack_chunks")[
        "device_ops"] = passes["pack_chunks"]
    out.append(golomb_row(torch, np, rk, launches, errs, batch_in, P_STC,
                          bound, passes["golomb_decode"]))
    out.append({
        "name": "threshold_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/threshold_stats.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:38",
        "launches": launches["threshold_stats"],
        "max_abs_err": errs["threshold_stats"],
        "ms": event_ms(torch, lambda: rk.threshold_stats(x1, t1)),
        "plain_ms": event_ms(torch,
                             lambda: rk.threshold_stats_plain(x1, t1)),
        "bound_ms": bound(4 * n_stats + 4 + 4 + 4), "bound_by": "bytes",
        "library_ms": None, "on_path": False,
        "ms_host": event_ms(torch, lambda: rk.threshold_stats(x1, t1),
                            iters=20, hold_stream=False)})
    out.append(bisect_row(torch, rk, launches, errs, x1, bound))
    # every k-selection is timed with its host work, torch.topk beside them
    # (the bisection synchronizes; the histogram route on the carried
    # matrices is also timed in device time, in select_row)
    sel_ms = event_ms(torch, lambda: rk.hist_topk_threshold_batched(x, k),
                      iters=20, hold_stream=False)
    topk_ms = event_ms(torch, lambda: torch.topk(x.abs(), k, dim=1),
                       iters=20, hold_stream=False)
    print(f"selection at ({rows}, {n}), k={k}, host included: histogram "
          f"route {sel_ms:.4f} ms, torch.topk {topk_ms:.4f} ms")
    k1 = max(int(n_stats * P_STC), 1)
    bis_ms = event_ms(torch, lambda: rk.topk_threshold(x1, k1),
                      iters=20, hold_stream=False)
    bis_dev_ms = event_ms(torch, lambda: rk.topk_threshold(x1, k1))
    hist1_ms = event_ms(torch,
                        lambda: rk.hist_topk_threshold_batched(x1[None], k1),
                        iters=20, hold_stream=False)
    topk1_ms = event_ms(torch, lambda: torch.topk(x1.abs(), k1),
                        iters=20, hold_stream=False)
    print(f"selection at ({n_stats},), k={k1}, host included: bisection "
          f"(one bisect_select launch) {bis_ms:.4f} ms (device time "
          f"{bis_dev_ms:.4f} ms), histogram route {hist1_ms:.4f} ms, "
          f"torch.topk {topk1_ms:.4f} ms")
    for row in out:
        lib = (f", library {row['library_ms']:.4f} ms"
               if row["library_ms"] is not None else "")
        extra = {k: v for k, v in row.items() if k not in KERNEL_KEYS}
        print(f"kernel {row['name']}: {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms"
              f"{lib}){' ' + json.dumps(extra) if extra else ''}")
    return out


def time_round(torch, np, tr):
    """One round split into its phases, state left untouched, median of 5.
    ``ledger`` is the trainer's (``wire_backend="kernel"``);
    ``ledger_numpy`` packs the same messages with the host packer."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    phases = {"local_sgd": [], "encode": [], "apply": [], "ledger": [],
              "ledger_numpy": [], "round": []}

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(5):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        t0 = sync_now()
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        t1 = sync_now()
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        t2 = sync_now()
        _, _, gd = tr._apply_fn(
            tr.params_vec, tr.server_state, msgs,
            torch.ones(p, device=tr.device), torch.zeros(p, device=tr.device))
        t3 = sync_now()
        proto.encode_wire_batch(msgs, direction="up")
        proto.encode_wire(gd, direction="down")
        t4 = sync_now()
        host.encode_wire_batch(msgs, direction="up")
        host.encode_wire(gd, direction="down")
        t5 = sync_now()
        for name, dt in zip(("local_sgd", "encode", "apply", "ledger",
                             "ledger_numpy"),
                            (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            phases[name].append(dt * 1e3)
    for _ in range(5):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print("round phases (median of 5, ms, host clock after synchronize): "
          + json.dumps({k: round(v, 3) for k, v in med.items()}))
    return med


def time_decode_split(torch, np, rk, proto, batch, reps=21):
    """The ingest decode of one round's batch split into its steps, host
    clock after ``synchronize``, median of ``reps``, the two backends in
    turns: ``"kernel"`` = words up, decode and fields down (the wrapper:
    table up, one launch, its one buffer down, the status checked on the
    host), ``np.add.at``; ``"numpy"`` = the
    host field scan (unpack + ``_decode_stream_fields``), ``np.add.at``.
    The two accumulators must be identical."""
    from repro_torch.core import wire
    b = wire._b_star_checked(proto.sparsity_up)
    ws, bl, nnz = (np.asarray(a, np.int64)
                   for a in (batch.word_start, batch.bit_len, batch.nnz))
    table = [torch.from_numpy(a) for a in (ws, bl, nnz)]
    words = np.ascontiguousarray(batch.words, np.uint32).view(np.int32)
    weights = np.full(batch.n_msgs, 0.1)
    names = ("words_up", "decode_down", "add_at", "numpy_scan",
             "numpy_add_at")
    phases = {name: [] for name in names}

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        ts = [sync_now()]
        w = torch.from_numpy(words).to("cuda")
        ts.append(sync_now())
        seg, pos, sign = (f.numpy() for f in rk.decode_golomb_fields(
            w, *table, batch.numel, b))
        ts.append(sync_now())
        acc = proto.make_ingest(batch.numel)
        acc.scatter_ternary_batch(seg, pos, sign, batch.mu, weights)
        ts.append(sync_now())
        fields_n = wire._decode_fields_numpy(batch.words, ws, bl, nnz,
                                             batch.numel, b)
        ts.append(sync_now())
        acc_n = proto.make_ingest(batch.numel)
        acc_n.scatter_ternary_batch(*fields_n, batch.mu, weights)
        ts.append(sync_now())
        require(np.array_equal(acc.sum, acc_n.sum),
                "the decode split's accumulators differ")
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print(f"ingest decode split (W={words.size}, {int(nnz.sum())} "
          f"codewords, median of {reps}, ms, host clock after synchronize): "
          + json.dumps({k: round(v, 4) for k, v in med.items()}))
    return med


def time_ingest_round(torch, np, tr):
    """One ingest round split into its phases, state left untouched, median
    of 5.  ``wire_encode`` + ``decode_scatter`` are the trainer's
    (``wire_backend="kernel"``: ``pack_chunks`` and ``golomb_decode`` on the
    card); the ``*_numpy`` pair runs the same messages through the host wire
    backend; ``ledger`` is the downstream message (the upstream batch is
    reused)."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    names = ("local_sgd", "encode", "wire_encode", "decode_scatter",
             "wire_encode_numpy", "decode_scatter_numpy", "finalize",
             "ledger")
    phases = {name: [] for name in names + ("round",)}
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(5):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        ts.append(sync_now())
        batch = proto.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        ts.append(sync_now())
        batch_n = host.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc_n = host.make_ingest(tr.numel)
        host.ingest_wire_batch(acc_n, batch_n, w, direction="up")
        ts.append(sync_now())
        gd, _, _ = proto.aggregate_ingest(acc, tr.server_state)
        ts.append(sync_now())
        proto.encode_wire(gd, direction="down")
        ts.append(sync_now())
        require(np.array_equal(acc.sum, acc_n.sum),
                "the kernel and host wire backends ingest differently")
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(5):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print("ingest round phases (median of 5, ms, host clock after "
          "synchronize): " + json.dumps({k: round(v, 3)
                                         for k, v in med.items()}))
    return med


def time_signsgd_round(torch, np, tr, reps=5):
    """One signSGD ingest round split into its phases, state left
    untouched, median of ``reps``, host clock after ``synchronize``.
    ``wire_encode`` + ``tally`` are the trainer's (``wire_backend=
    "kernel"``); the ``*_numpy`` pair runs the same messages through the
    host wire backend, in turns with it; ``finalize`` is the sign of the
    accumulated mean, ``ledger`` the downstream message.  Uses only entry
    points that every slice of the port has, so it also times an older
    tree (``--signsgd-round``)."""
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    names = ("local_sgd", "encode", "wire_encode", "tally",
             "wire_encode_numpy", "tally_numpy", "finalize", "ledger")
    phases = {name: [] for name in names + ("round",)}
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas, None)
        ts.append(sync_now())
        batch = proto.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        ts.append(sync_now())
        batch_n = host.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc_n = host.make_ingest(tr.numel)
        host.ingest_wire_batch(acc_n, batch_n, w, direction="up")
        ts.append(sync_now())
        gd, _, _ = proto.aggregate_ingest(acc, tr.server_state)
        gd = gd.to(tr.device)
        ts.append(sync_now())
        proto.encode_wire(gd, direction="down")
        ts.append(sync_now())
        require(np.array_equal(acc.sum, acc_n.sum),
                "the kernel and host wire backends tally differently")
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(reps):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print(f"signSGD ingest round phases (median of {reps}, ms, host clock "
          f"after synchronize): " + json.dumps({k: round(v, 3)
                                                for k, v in med.items()}))
    return med


def signsgd_round_only(torch, np) -> None:
    """``--signsgd-round``: the signSGD ingest round's phases alone, on the
    tree this file sits in (a parent unpacked beside the change runs this
    file's copy against its own package), then the card's line."""
    tr = make_trainer("cuda", torch, ingest=True, codec="signsgd")
    require(tr.ingest, "the signSGD trainer is not on the ingest path")
    tr.run(2, eval_every=2)                      # warm-up: builds, caches
    torch.cuda.synchronize()
    time_signsgd_round(torch, np, tr)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()
    print(f"card after the timing (SM clock, max SM clock, power draw, "
          f"temperature): {clocks}")
    print(card_line())


# ---------------------------------------------------------------- phase 7

PAPER_CODECS = ("baseline", "fedavg", "topk", "ternquant")
SELECTION_KERNELS = ("histogram", "bin_select")
CODEC_ITERS = 20       # local iterations a codec run (fedavg: 2 rounds of 10)
# at the demo's lr 0.05 the dense codecs' cnn training is unstable (FedAvg's
# ten local steps reach NaN in its first round, in the JAX package too, and
# baseline's accuracy swings between evaluations, so that card and CPU part
# ways); at 0.01 all four train stably
CODEC_LR = 0.01
LEDGER_COLS = ("bits_up", "bits_down", "bits_up_analytic",
               "bits_down_analytic")


def ulps_from(np, a, delta):
    """How many fp32 ulps of ``delta`` separate ``a`` from it."""
    return float((np.float64(a) - np.float64(delta))
                 / np.spacing(np.float32(delta)))


def check_codec_lockstep(torch, np, tr, rounds=3):
    """The card's encode and apply phases of a paper codec against the CPU's
    on the same inputs, round by round from the trained state: the card's
    local-SGD deltas, residuals and parameters, and (server side) the
    card's combined mean.  top-k: messages, masks, counts and residuals
    bitwise; baseline and FedAvg: messages bitwise; TernQuant: masks exact
    (a differing element is printed with its distance from Δ in ulps) and
    µ within rtol 1e-6, client and server side.  The trainer's state is
    left as it was; only its data stream advances."""
    from repro_torch.core.compression import ternary_quantize
    from repro_torch.core.residual import (ResidualState,
                                           compress_with_feedback)
    from repro_torch.core.selection import flush_subnormal
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    params = tr.params_vec.clone()
    client_res = (None if tr.client_state is None
                  else tr.client_state.residual.clone())
    server = tr.server_state
    worst = {"mu_rtol": 0.0}

    def bitwise(what, got, want):
        require(np.array_equal(got.cpu().numpy().view(np.int32),
                               want.numpy().view(np.int32)),
                f"{proto.name} lock-step round {r}: {what} differ")

    def same_ternary(what, got, want, st, st_c, carried):
        """Masks exact and µ within rtol 1e-6; ``carried`` (CPU) locates a
        differing element against Δ."""
        mask, mask_c = got.cpu() != 0, want != 0
        if not torch.equal(mask, mask_c):
            a = flush_subnormal(carried).abs().reshape(mask.shape)
            delta = proto.theta * (a.sum(-1, dtype=torch.float64)
                                   .to(torch.float32) / a.shape[-1])
            for row, col in (mask != mask_c).nonzero().tolist()[:20]:
                print(f"{proto.name} lock-step round {r}: {what} mask "
                      f"differs at ({row}, {col}): |x| = "
                      f"{float(a[row, col])!r}, Δ = {float(delta[row])!r}, "
                      f"{ulps_from(np, float(a[row, col]), float(delta[row])):+.2f} ulps")
        require(torch.equal(mask, mask_c),
                f"{proto.name} lock-step round {r}: {what} masks differ")
        require(torch.equal(torch.sign(got.cpu()), torch.sign(want)),
                f"{proto.name} lock-step round {r}: {what} signs differ")
        require(torch.equal(st.nnz.cpu(), st_c.nnz),
                f"{proto.name} lock-step round {r}: {what} counts differ")
        mu_c = st_c.mu.reshape(-1).double()
        rel = float(((st.mu.cpu().reshape(-1).double() - mu_c).abs()
                     / mu_c.abs().clamp(min=1e-300)).max())
        require(rel <= 1e-6, f"{proto.name} lock-step round {r}: {what} µ "
                             f"off by rtol {rel:.3e} > 1e-6")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)

    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        cs = cs_c = None
        if client_res is not None:
            cs = ResidualState(client_res[idx])
            cs_c = ResidualState(client_res[idx].cpu())
        msgs, cst, st = proto.encode_batch(deltas, cs)
        msgs_c, cst_c, st_c = proto.encode_batch(deltas.cpu(), cs_c)
        gd, sst, sg = proto.aggregate(msgs, server, mask=ones,
                                      staleness=zeros)
        if proto.name == "ternquant":
            carried = deltas.cpu() + cs_c.residual
            same_ternary("client messages", msgs, msgs_c, st, st_c, carried)
            # the server's quantization on the card's combined mean
            mean = proto.combine(msgs, ones, zeros)
            gd_c, _, sg_c = compress_with_feedback(
                mean.cpu(), ResidualState(server.residual.cpu()),
                lambda v: ternary_quantize(v, proto.theta))
            same_ternary("server message", gd[None], gd_c[None], sg, sg_c,
                         (mean.cpu() + server.residual.cpu())[None])
        else:
            bitwise("messages", msgs, msgs_c)
        if proto.name == "topk":
            require(torch.equal(msgs.cpu() != 0, msgs_c != 0)
                    and torch.equal(st.nnz.cpu(), st_c.nnz),
                    f"topk lock-step round {r}: masks or counts differ")
            bitwise("residuals", cst.residual, cst_c.residual)
        if client_res is not None:
            client_res[idx] = cst.residual
        server = sst
        params = params + gd
    print(f"{proto.name} lock-step ({rounds} rounds, card vs CPU from the "
          f"same inputs): "
          + ("messages bitwise" if proto.name in ("baseline", "fedavg")
             else "messages, masks, counts and residuals bitwise"
             if proto.name == "topk"
             else f"masks exact, {json.dumps(worst)}"))


def time_codec_round(torch, np, tr, reps=5):
    """One round of a paper codec split into its phases, host clock after
    ``synchronize``, median of ``reps``: ``local_sgd``, ``encode``,
    ``apply`` (the trainer's aggregate and update, state untouched) and
    ``ledger`` (the analytic bits and the update cache's push of the global
    delta, as the trainer books them), then whole rounds."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    names = ("local_sgd", "encode", "apply", "ledger")
    phases = {name: [] for name in names + ("round",)}

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        ts.append(sync_now())
        _, _, gd = tr._apply_fn(tr.params_vec, tr.server_state, msgs,
                                torch.ones(p, device=tr.device),
                                torch.zeros(p, device=tr.device))
        ts.append(sync_now())
        tr._account(sel, msgs, gd)
        ts.append(sync_now())
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(reps):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print(f"{proto.name} round phases (median of {reps}, ms, host clock "
          f"after synchronize): " + json.dumps({k: round(v, 3)
                                                for k, v in med.items()}))
    return med


def run_paper_codecs(torch, np, rk):
    """The paper's comparison codecs on the cnn (``CODEC_ITERS`` local
    iterations each), on the card (counters set to 0 just before) and on the
    CPU from the same initial parameters: accuracy within 0.03 and the four
    (analytic) ledger columns equal; top-k launches the histogram and
    ``bin_select`` exactly once a round and nothing else, the others no
    kernel at all.  Then each codec's lock-step rounds and its round
    phases.  Returns the launch counts and shapes by codec."""
    out = {}
    for name in PAPER_CODECS:
        gpu = make_trainer("cuda", torch, codec=name, lr=CODEC_LR)
        require(gpu.numel == MAIN_N, f"cnn has {gpu.numel} parameters")
        rounds = max(CODEC_ITERS // gpu.protocol.local_iters, 1)
        rk.LAUNCHES.reset()
        t0 = time.perf_counter()
        h_gpu = gpu.run(rounds, eval_every=rounds)[-1]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES.counts)
        shapes = dict(rk.LAUNCHES.shapes)
        require(bool(torch.isfinite(gpu.params_vec).all()),
                f"{name}: non-finite params")
        want = {k: (rounds if name == "topk" and k in SELECTION_KERNELS
                    else 0) for k in launches}
        require(launches == want,
                f"{name} launched {json.dumps(launches)} in {rounds} "
                f"rounds, not {json.dumps(want)}")
        cpu = make_trainer("cpu", torch, codec=name, lr=CODEC_LR)
        t0 = time.perf_counter()
        h_cpu = cpu.run(rounds, eval_every=rounds)[-1]
        cpu_s = time.perf_counter() - t0
        require(rk.LAUNCHES.counts == launches,
                f"{name}: the CPU run launched a CUDA kernel")
        d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
        print(f"{name} trainer: cnn, {rounds} rounds of "
              f"{gpu.protocol.local_iters} local iterations | card "
              f"acc={h_gpu['acc']:.4f} ({gpu_s:.1f} s) | cpu "
              f"acc={h_cpu['acc']:.4f} ({cpu_s:.1f} s) | ledger "
              f"{json.dumps({k: h_gpu[k] for k in LEDGER_COLS})} | "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}"
              f" shapes {json.dumps({k: list(v) for k, v in shapes.items()})}")
        require(d_acc <= 0.03, f"{name}: accuracy differs by {d_acc:.4f}")
        for col in LEDGER_COLS:
            require(h_gpu[col] == h_cpu[col],
                    f"{name}: {col} {h_gpu[col]} on the card, {h_cpu[col]} "
                    f"on the CPU")
        check_codec_lockstep(torch, np, gpu)
        time_codec_round(torch, np, gpu)
        out[name] = (launches, shapes)
    print(f"card: {card_line()}")
    return out


# ---------------------------------------------------------------- phase 8

BUFFERED_ROUNDS = 10
BUFFERED_DEADLINE = 0.5   # the default LatencyModel's median latency


def run_buffered(torch, np, rk):
    """STC (p = 1/50 both ways) under ``BufferedFederatedTrainer`` with the
    default ``LatencyModel`` and a deadline at its median latency, on the
    dense route and with ``TrainerConfig(ingest=True)``, ``BUFFERED_ROUNDS``
    rounds each on the card (counters set to 0 just before) and on the CPU:
    ``arrival_log`` identical, accuracy within 0.03 and ``bits_up`` within
    2 %.  Then ``deadline=inf`` against the synchronous trainer on the card,
    3 rounds: parameters and the ledger bitwise.  Returns the launch counts
    and shapes by route."""
    from repro_torch.fed import LatencyModel
    finite = {"latency": LatencyModel(), "deadline": BUFFERED_DEADLINE}
    out = {}
    for ingest in (False, True):
        route = "ingest" if ingest else "dense"
        gpu = make_trainer("cuda", torch, ingest=ingest, buffered=finite)
        require(gpu.ingest == ingest, f"buffered {route}: not on its route")
        rk.LAUNCHES.reset()
        t0 = time.perf_counter()
        h_gpu = gpu.run(BUFFERED_ROUNDS, eval_every=BUFFERED_ROUNDS)[-1]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES.counts)
        shapes = dict(rk.LAUNCHES.shapes)
        log = gpu.arrival_log
        require(bool(torch.isfinite(gpu.params_vec).all()),
                f"buffered {route}: non-finite params")
        require(any(row["staleness_max"] > 0 for row in log)
                and any(row["arrived"] < row["dispatched"] for row in log),
                f"buffered {route}: no straggler in {BUFFERED_ROUNDS} rounds")
        cpu = make_trainer("cpu", torch, ingest=ingest, buffered=finite)
        t0 = time.perf_counter()
        h_cpu = cpu.run(BUFFERED_ROUNDS, eval_every=BUFFERED_ROUNDS)[-1]
        cpu_s = time.perf_counter() - t0
        require(rk.LAUNCHES.counts == launches,
                f"buffered {route}: the CPU run launched a CUDA kernel")
        require(cpu.arrival_log == log,
                f"buffered {route}: arrival logs differ card vs CPU")
        d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
        d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
        print(f"buffered {route}: cnn, STC, {BUFFERED_ROUNDS} rounds, "
              f"deadline {BUFFERED_DEADLINE} | card acc={h_gpu['acc']:.4f} "
              f"bits_up={h_gpu['bits_up']:.0f} ({gpu_s:.1f} s) | cpu "
              f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
              f"({cpu_s:.1f} s) | |d acc|={d_acc:.4f} "
              f"|d bits_up|={d_up:.4%} | arrivals "
              f"{json.dumps([[r['arrived'], r['aggregated'], r['staleness_max']] for r in log])}"
              f" | launches {json.dumps({k: v for k, v in launches.items() if v})}"
              f" shapes {json.dumps({k: list(v) for k, v in shapes.items()})}")
        require(d_acc <= 0.03, f"buffered {route}: accuracy differs by "
                               f"{d_acc:.4f} > 0.03")
        require(d_up <= 0.02, f"buffered {route}: bits_up differs by "
                              f"{d_up:.4%} > 2%")
        # the clients' STC every round, the server's each round that
        # aggregated; one decode an ingested arrival
        agg = [row["aggregated"] for row in log]
        stc = BUFFERED_ROUNDS + sum(a > 0 for a in agg)
        want = {"histogram": stc, "bin_select": stc, "stc_apply": stc,
                "golomb_decode": sum(agg) if ingest else 0}
        got = {k: launches[k] for k in want}
        require(got == want, f"buffered {route}: launched {json.dumps(got)}"
                             f", not {json.dumps(want)}")
        require(launches["pack_chunks"] > 0 and launches["unpack_bits"] == 0
                and launches["pack_bits"] == 0,
                f"buffered {route}: the wire did not go through pack_chunks "
                f"alone")
        time_buffered_round(torch, gpu, route)
        out[route] = (launches, shapes)
    for ingest in (False, True):
        sync = make_trainer("cuda", torch, ingest=ingest)
        inf = make_trainer("cuda", torch, ingest=ingest,
                           buffered={"latency": LatencyModel()})
        sync.run(3, eval_every=3)
        inf.run(3, eval_every=3)
        torch.cuda.synchronize()
        require(torch.equal(sync.params_vec, inf.params_vec)
                and all(getattr(sync, c) == getattr(inf, c)
                        for c in LEDGER_COLS)
                and sync.wire_log == inf.wire_log,
                f"deadline=inf differs from the synchronous trainer on the "
                f"card ({'ingest' if ingest else 'dense'} route)")
    print("buffered deadline=inf: parameters, ledger and wire log bitwise "
          "the synchronous trainer's on the card, 3 rounds, dense and "
          "ingest routes")
    print(f"card: {card_line()}")
    return out


def time_buffered_round(torch, tr, route, reps=5):
    """Whole buffered rounds on the card, host clock after ``synchronize``,
    median of ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"buffered {route} round (median of {reps}, ms, host clock after "
          f"synchronize): {statistics.median(times):.3f} "
          f"(all: {json.dumps([round(t, 3) for t in times])})")
    return statistics.median(times)


# ---------------------------------------------------------------- phase 9

CHUNK = 4096              # the cnn at 4096: 79 chunks in 6 width groups
# card against CPU compares accuracies only once the cnn has converged:
# at 10 and 20 rounds (accuracy 0.4-0.9) local SGD's ulp drift, and the
# card's own run-to-run variation, moved the two apart by 0.05-0.21
# (``--drift-witness`` shows one ulp on one device doing the same)
CHUNKED_ROUNDS = 40
WITNESS_ROUNDS = 20
CHUNKED_CONTROLLERS = (("residual_mass", {"budget": 1.0}),
                       ("snr_constant", {"snr": 3.0, "ema": 0.5}))
STC_KERNELS = ("histogram", "bin_select", "stc_apply")
BANNED_OPS = {"aten::topk", "aten::sort", "aten::kthvalue"}


class launch_log:
    """Every launch the wrappers record, as ``(name, shape)``, while the
    context is open (the counters count on as always)."""

    def __init__(self, rk):
        self.rk, self.log = rk, []

    def __enter__(self):
        real = type(self.rk.LAUNCHES).record
        counter = self.rk.LAUNCHES

        def record(name, shape):
            self.log.append((name, tuple(shape)))
            real(counter, name, shape)
        counter.record = record
        return self.log

    def __exit__(self, *exc):
        del self.rk.LAUNCHES.record


def chunked_shapes(tr):
    """The chunked STC selections' shapes: the clients' ``(P * C, W)`` and
    the server's ``(C, W)``."""
    spec, p = tr.protocol.spec, tr.env.participants_per_round
    return (p * spec.n_chunks, spec.chunk_numel), (spec.n_chunks,
                                                   spec.chunk_numel)


def require_stc_launches(log, tr, rounds, what):
    """Exactly one histogram, ``bin_select`` and ``stc_apply`` launch a
    round at each of the chunked selections' shapes, and none other."""
    up, down = chunked_shapes(tr)
    for name in STC_KERNELS:
        got = {}
        for n, shape in log:
            if n == name:
                got[shape] = got.get(shape, 0) + 1
        require(got == {up: rounds, down: rounds},
                f"{what}: {name} launched {got} in {rounds} rounds, not "
                f"once a round at {up} and at {down}")


def check_whole_vector(torch):
    """``chunks="whole"`` against the flat trainer on the card, 5 dense
    rounds: parameters, the four ledger columns and the wire log bitwise."""
    flat = make_trainer("cuda", torch)
    whole = make_trainer("cuda", torch, chunks="whole")
    require(whole.protocol.spec.is_whole_vector(),
            "chunks='whole' is not one whole-vector chunk")
    flat.run(5, eval_every=5)
    whole.run(5, eval_every=5)
    torch.cuda.synchronize()
    require(torch.equal(flat.params_vec, whole.params_vec)
            and all(getattr(flat, c) == getattr(whole, c)
                    for c in LEDGER_COLS)
            and flat.wire_log == whole.wire_log,
            "chunks='whole' differs from the flat trainer on the card")
    print("chunked whole vector: parameters, ledger and wire log bitwise the "
          "flat trainer's on the card, 5 rounds")


def count_nnz_up(np, tr):
    """Total the upstream messages' non-zeros of every round ``tr`` runs
    from now on; returns a one-element list that holds the total."""
    total, book = [0], tr._downstream_bits

    def counting(global_delta, up=None, nnz_up=None):
        if nnz_up is not None:
            total[0] += int(np.sum(np.asarray(nnz_up, np.int64)))
        return book(global_delta, up, nnz_up)
    tr._downstream_bits = counting
    return total


def chunked_kw(controller=None):
    """``TrainerConfig`` fields of phase 9's runs: ``chunks=4096`` and a new
    controller instance where one is named."""
    kw = {"chunks": CHUNK}
    if controller:
        from repro_torch.core import make_controller
        kw["controller"] = make_controller(controller[0], **controller[1])
    return kw


def run_chunked_trainers(torch, np, rk, ingest=False, controller=None,
                         rounds=CHUNKED_ROUNDS, lockstep=None):
    """The cnn at ``chunks=4096`` on the card (counters set to 0 just
    before) and on the CPU: accuracy within 0.03, ``bits_up`` within 2 %,
    the analytic columns equal, and with a fixed k a chunk the upstream
    non-zeros of the whole run within rtol 1e-4 (a wrong selection moves
    them by a count a row a round; only ties at a threshold may); one
    histogram, ``bin_select`` and ``stc_apply`` launch a round at each
    selection's shape, two ``pack_chunks`` a width group a round; on the
    ingest route one ``golomb_decode`` a width group a round.
    ``lockstep(tr)`` runs on the card's trained trainer before the CPU
    run.  Returns the card's trainer, its launches, what ``lockstep``
    returned and both runs' accuracies at each evaluation."""
    route = controller[0] if controller else ("ingest" if ingest else "dense")
    gpu = make_trainer("cuda", torch, ingest=ingest, **chunked_kw(controller))
    spec, groups = gpu.protocol.spec, gpu.protocol._groups()
    require(gpu.ingest == ingest and spec.n_chunks == 79 and len(groups) == 6,
            f"chunked {route}: {spec.n_chunks} chunks in {len(groups)} groups")
    evals = max(rounds // 4, 1)
    nnz_gpu = count_nnz_up(np, gpu)
    rk.LAUNCHES.reset()
    t0 = time.perf_counter()
    with launch_log(rk) as log:
        h_gpu = gpu.run(rounds, eval_every=evals)
        torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches, nnz_gpu = dict(rk.LAUNCHES.counts), nnz_gpu[0]
    require(bool(torch.isfinite(gpu.params_vec).all()),
            f"chunked {route}: non-finite params")
    require_stc_launches(log, gpu, rounds, f"chunked {route}")
    require(launches["pack_chunks"] == 2 * len(groups) * rounds
            and launches["pack_bits"] == 0 and launches["unpack_bits"] == 0,
            f"chunked {route}: the wire packed {launches['pack_chunks']} times "
            f"with pack_chunks in {rounds} rounds, not twice a width group a "
            f"round (up and down), {launches['pack_bits']} with pack_bits")
    if ingest:
        require(launches["golomb_decode"] == len(groups) * rounds,
                f"chunked ingest decoded {launches['golomb_decode']} times in "
                f"{rounds} rounds, not once a width group a round")
    params = gpu.params_vec.clone()
    checked = lockstep(gpu) if lockstep is not None else None
    before = dict(rk.LAUNCHES.counts)
    cpu = make_trainer("cpu", torch, ingest=ingest, **chunked_kw(controller))
    nnz_cpu = count_nnz_up(np, cpu)
    t0 = time.perf_counter()
    h_cpu = cpu.run(rounds, eval_every=evals)
    cpu_s = time.perf_counter() - t0
    require(rk.LAUNCHES.counts == before,
            f"chunked {route}: the CPU run launched a CUDA kernel")
    accs = [[round(h["acc"], 4) for h in hist] for hist in (h_gpu, h_cpu)]
    h_gpu, h_cpu = h_gpu[-1], h_cpu[-1]
    d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
    d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
    d_nnz = abs(nnz_gpu / nnz_cpu[0] - 1.0)
    d_params = float((params.cpu() - cpu.params_vec).norm()
                     / cpu.params_vec.norm())
    print(f"chunked {route}: cnn, chunks={CHUNK} ({spec.n_chunks} chunks, "
          f"widths {[g[0] for g in groups]}), {rounds} rounds | card "
          f"acc={h_gpu['acc']:.4f} bits_up={h_gpu['bits_up']:.0f} "
          f"bits_down={h_gpu['bits_down']:.0f} ({gpu_s:.1f} s) | cpu "
          f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
          f"({cpu_s:.1f} s) | |d acc|={d_acc:.4f} |d bits_up|={d_up:.4%} "
          f"nnz_up card {nnz_gpu} cpu {nnz_cpu[0]} (|d|={d_nnz:.3e}) "
          f"|d params|/|params|={d_params:.3e} | acc every {evals} rounds "
          f"card {accs[0]} cpu {accs[1]} | launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    require(d_acc <= 0.03, f"chunked {route}: accuracy differs by {d_acc:.4f}")
    require(d_up <= 0.02, f"chunked {route}: bits_up differs by {d_up:.4%}")
    if controller is None:
        require(d_nnz <= 1e-4,
                f"chunked {route}: the upstream non-zeros differ by "
                f"{d_nnz:.3e} ({nnz_gpu} on the card, {nnz_cpu[0]} on the "
                f"CPU)")
    for col in ("bits_up_analytic", "bits_down_analytic"):
        require(h_gpu[col] == h_cpu[col],
                f"chunked {route}: {col} {h_gpu[col]} on the card, "
                f"{h_cpu[col]} on the CPU")
    return gpu, launches, checked, accs


def perturbed(torch, tr, how):
    """Move ``tr``'s parameters by one ulp: ``"one"`` the first up, ``"all"``
    every non-zero one up or down by a sign drawn from a seeded generator."""
    v = tr.params_vec.clone()
    inf = torch.full_like(v, math.inf)
    if how == "one":
        require(float(v[0]) != 0.0, "the first parameter is zero")
        v[0] = torch.nextafter(v[0], inf[0])
    else:
        up = torch.rand(v.shape, generator=torch.Generator().manual_seed(7))
        away = torch.where(up.to(v.device) < 0.5, inf, -inf)
        v = torch.where(v != 0, torch.nextafter(v, away), v)
    tr.params_vec = v


WITNESS_RUNS = (("card", "cuda", None, None),
                ("card again", "cuda", None, None),
                ("card +1 ulp", "cuda", "one", None),
                ("card +-1 ulp all", "cuda", "all", None),
                ("cpu", "cpu", None, None),
                ("cpu +1 ulp", "cpu", "one", None),
                ("cpu +-1 ulp all", "cpu", "all", None),
                ("cpu 1 thread", "cpu", None, 1))


def drift_witness(torch, np, rk, rounds=WITNESS_ROUNDS):
    """How far runs part at the depths where phase 9 does not compare
    accuracies: the dense and ``residual_mass`` runs of phase 9, ``rounds``
    rounds, accuracy every 5, on the card twice, on the card and on the CPU
    with the first parameter moved up by one ulp and with every parameter
    moved by one ulp, on the CPU, and on the CPU with one thread (another
    reduction order in local SGD).  Prints the accuracies and each run's
    largest gap from the unperturbed run on its device and from the CPU's;
    checks only that every run stays finite."""
    t0 = time.perf_counter()
    out, threads = {}, torch.get_num_threads()
    for controller in (None, CHUNKED_CONTROLLERS[0]):
        route = controller[0] if controller else "dense"
        accs = {}
        for name, device, how, n_threads in WITNESS_RUNS:
            tr = make_trainer(device, torch, **chunked_kw(controller))
            if how:
                perturbed(torch, tr, how)
            torch.set_num_threads(n_threads or threads)
            try:
                hist = tr.run(rounds, eval_every=5)
            finally:
                torch.set_num_threads(threads)
            require(bool(torch.isfinite(tr.params_vec).all()),
                    f"drift witness {route} {name}: non-finite params")
            accs[name] = [round(h["acc"], 4) for h in hist]

        def gap(a, b):
            return round(max(abs(x - y) for x, y in zip(accs[a], accs[b])),
                         4)
        gaps = {"card": {"vs cpu": gap("cpu", "card")}}
        for name, device, *_ in WITNESS_RUNS[1:]:
            if name != "cpu":
                gaps[name] = {"vs cpu": gap("cpu", name)}
                if device == "cuda":
                    gaps[name]["vs card"] = gap("card", name)
        print(f"drift witness, chunked {route}: cnn, chunks={CHUNK}, "
              f"{rounds} rounds, accuracy every 5 rounds "
              f"{json.dumps(accs)} | largest gap "
              f"{json.dumps(gaps)}")
        out[route] = gaps
    print(f"drift witness took {time.perf_counter() - t0:.1f} s "
          f"({threads} CPU threads)")
    print(f"card: {card_line()}")
    return out


def profile_round(torch, tr, what):
    """One whole round under ``torch.profiler``: no ``topk``/``sort`` op,
    and (where the profiler sees the card) one histogram, one ``bin_select``
    (its cluster route's one kernel) and one ``stc_apply`` kernel a
    selection, two selections."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_round()
        torch.cuda.synchronize()
    ops = {e.name for e in prof.events() if e.device_type != DeviceType.CUDA}
    require(not (BANNED_OPS & ops),
            f"{what}: a round called {sorted(BANNED_OPS & ops)}")
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    seen = {k: sum(k in n for n in kernels)
            for k in ("magnitude_histogram_kernel", "cluster_select_kernel",
                      "stc_apply_kernel")}
    if kernels:
        require(all(v == 2 for v in seen.values()),
                f"{what}: the profiler saw {seen} in one round, not two each")
    print(f"{what} round under torch.profiler: no topk/sort op; device "
          f"kernels {json.dumps(seen) if kernels else 'not seen'}")


def check_chunked_lockstep(torch, np, rk, tr, rounds=3):
    """The chunked STC's encode, apply, ledger and ingest on the card
    against the CPU's on the same inputs, round by round from the trained
    state: thresholds and counts of both selections exact, masks and signs
    exact, µ within rtol 1e-6, residuals and parameters within 1e-6 of
    ``|value| + µ``, wire words identical to the host packer's and the
    ingest accumulator bitwise the CPU decode's and the host backend's.
    The server's CPU side runs on the card's combined mean.  Returns the
    last round's carried matrices and upstream batch."""
    from repro_torch.core.chunking import chunk_codec
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.residual import (ResidualState, map_states,
                                           take_states)
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    spec, W = proto.spec, proto.spec.chunk_numel
    host = chunk_codec(dataclasses.replace(proto.base, wire_backend="numpy"),
                       spec)
    be = get_stc_backend("kernel")
    ks_up = np.tile(spec.chunk_ks(proto._chunk_ps("up")), p)
    ks_down = spec.chunk_ks(proto._chunk_ps("down"))
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))
    params = tr.params_vec.clone()
    cstate = map_states(torch.clone, tr.client_state)
    sstate = map_states(torch.clone, tr.server_state)
    cpu = lambda st: map_states(lambda x: x.cpu(), st)   # noqa: E731
    worst = {"mu_rtol": 0.0, "sum_rtol": 0.0, "residual_abs": 0.0}

    def same_selection(what, x, ks):
        got = be.select_batch(x, ks)
        want = be.select_batch(x.cpu(), ks)
        require(torch.equal(got[0].cpu(), want[0])
                and torch.equal(got[1].cpu(), want[1]),
                f"chunked lock-step round {r}: {what} thresholds or counts "
                f"differ card vs CPU")
        rel = float(((got[2].cpu() - want[2]).abs()
                     / want[2].abs().clamp(min=1e-30)).max())
        require(rel <= 1e-6, f"chunked lock-step round {r}: {what} sums off "
                             f"by rtol {rel:.3e}")
        worst["sum_rtol"] = max(worst["sum_rtol"], rel)

    def same_message(what, got, want):
        require(torch.equal(torch.sign(got.cpu()), torch.sign(want)),
                f"chunked lock-step round {r}: {what} masks or signs differ")
        mu = spec.split(got.cpu()).abs().amax(dim=-1)
        mu_c = spec.split(want).abs().amax(dim=-1)
        rel = float(((mu - mu_c).abs() / mu_c.clamp(min=1e-30)).max())
        require(rel <= 1e-6, f"chunked lock-step round {r}: {what} µ off by "
                             f"rtol {rel:.3e}")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)
        return mu_c

    def close(what, got, want, mu):
        gap = (got.cpu() - want).abs()
        tol = 1e-6 * (want.abs() + mu[..., None])
        require(bool((gap <= tol).all()), f"chunked lock-step round {r}: "
                f"{what} beyond 1e-6 of |value| + µ")
        worst["residual_abs"] = max(worst["residual_abs"],
                                    float(gap.max()))

    decodes = rk.LAUNCHES.counts["golomb_decode"]
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        cs = take_states(cstate, idx)
        carried = (spec.split(deltas) + cs.residual).reshape(-1, W)
        same_selection("encode", carried, ks_up)
        msgs, cs_new, _ = proto.encode_batch(deltas, cs)
        msgs_c, cs_c, _ = proto.encode_batch(deltas.cpu(), cpu(cs))
        mu_c = same_message("client messages", msgs, msgs_c)
        close("client residuals", cs_new.residual, cs_c.residual, mu_c)

        # the card's combined mean, as the codec forms it (over the blocks)
        mean = spec.merge(proto.combine(spec.split(msgs), ones, zeros))
        server_carried = spec.split(mean) + sstate.residual
        same_selection("server", server_carried, ks_down)
        gd, ss_new, _ = proto.aggregate(msgs, sstate, mask=ones,
                                        staleness=zeros)
        # one row: the CPU's combine of the card's mean is that mean
        gd_c, ss_c, _ = proto.aggregate(mean.cpu()[None], cpu(sstate))
        mu_s = same_message("server message", gd[None], gd_c[None])
        close("server residual", ss_new.residual, ss_c.residual, mu_s[0])

        batch = proto.encode_wire_batch(msgs, direction="up")
        batch_h = host.encode_wire_batch(msgs.cpu().numpy(), direction="up")
        down = proto.encode_wire(gd, direction="down").batch
        down_h = host.encode_wire(gd.cpu().numpy(), direction="down").batch
        for got, want in ((batch, batch_h), (down, down_h)):
            require(all(np.array_equal(g.words, h.words)
                        and np.array_equal(g.bit_len, h.bit_len)
                        for g, h in zip(got.batches, want.batches)),
                    f"chunked lock-step round {r}: wire words differ from "
                    f"the host packer's")
        accs = []
        for codec, b, dev in ((proto, batch, tr.device), (proto, batch, "cpu"),
                              (host, batch_h, "cpu")):
            acc = codec.make_ingest(tr.numel)
            codec.ingest_wire_batch(acc, b, w, direction="up", device=dev)
            accs.append(acc)
        require(all(a.sum.tobytes() == accs[0].sum.tobytes()
                    and a.weight_mass == accs[0].weight_mass
                    and a.stream_bits == accs[0].stream_bits
                    for a in accs[1:]),
                f"chunked lock-step round {r}: ingest accumulators differ")
        cstate.residual[idx] = cs_new.residual
        sstate = ss_new
        params = params + gd
    require(rk.LAUNCHES.counts["golomb_decode"] > decodes,
            "the chunked lock-step ingest did not decode through "
            "golomb_decode")
    print(f"chunked lock-step ({rounds} rounds, card vs CPU from the same "
          f"inputs): thresholds, counts, masks, words and accumulator exact; "
          f"{json.dumps(worst)}")
    return {"carried": carried.contiguous(),
            "server_carried": server_carried.contiguous(),
            "ks_up": ks_up, "ks_down": ks_down, "batch": batch}


def check_chunked_selection(torch, rk, last):
    """On the last chunked lock-step round's matrices, (790, 4096) and (79,
    4096): ``bin_select`` against its plain version, then
    ``stc_compress_blocks`` with the fixed per-row ks and with ks as a
    device tensor under ``set_sync_debug_mode("error")`` (one histogram, one
    ``bin_select`` and one ``stc_apply`` launch a call; the device ks give
    the fixed ks' result), and the selection under ``torch.profiler``: no
    ``topk`` or ``sort``.  Returns the sums' largest abs difference."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.compression import stc_compress_blocks
    err = 0.0
    for name, ks in (("carried", last["ks_up"]),
                     ("server_carried", last["ks_down"])):
        x = last[name]
        err = max(err, check_bin_select(torch, rk, x, ks))
        kt = torch.as_tensor(ks, dtype=torch.int32).to(x.device)
        want = stc_compress_blocks(x, ks)
        torch.cuda.synchronize()
        before = dict(rk.LAUNCHES.counts)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = stc_compress_blocks(x, ks)
            dyn = stc_compress_blocks(x, kt, k_cap=int(ks.max()))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(rk.LAUNCHES.counts[k] == before[k] + 2
                    for k in STC_KERNELS),
                f"stc_compress_blocks on the {name} matrix did not launch "
                f"each STC kernel once a call")
        require(all(torch.equal(g, w) for g, w in zip(got, want))
                and all(torch.equal(g, w) for g, w in zip(dyn, want)),
                f"stc_compress_blocks on the {name} matrix: fixed and device "
                f"ks differ, or two calls differ")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stc_compress_blocks(x, kt, k_cap=int(ks.max()))
            torch.cuda.synchronize()
        banned = BANNED_OPS & {e.name for e in prof.events()}
        require(not banned, f"the chunked selection called {sorted(banned)}")
        print(f"chunked selection on the {name} matrix {tuple(x.shape)}: "
              f"bin_select identical to its plain version; "
              f"stc_compress_blocks with host and device ks identical, one "
              f"launch of each kernel a call, under "
              f"set_sync_debug_mode('error'); no topk/sort")
    return err


def check_adaptive_lockstep(torch, np, rk, tr, rounds=2):
    """A controller's rounds on the card against the CPU from the same
    inputs: per-chunk ks and (SNR) the EMA state of clients and server
    identical, the dynamic selection's thresholds and counts exact, masks
    exact and µ within rtol 1e-6; the clients' adaptive block encode runs
    under ``set_sync_debug_mode("error")`` and launches one histogram, one
    ``bin_select`` and one ``stc_apply``."""
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.residual import map_states, take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    spec, W, ctrl = proto.spec, proto.spec.chunk_numel, proto.controller
    be = get_stc_backend("kernel")
    base_up, caps_up = proto._ctrl_geometry("up")
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    params = tr.params_vec.clone()
    cstate = map_states(torch.clone, tr.client_state)
    sstate = map_states(torch.clone, tr.server_state)
    cpu = lambda st: map_states(lambda x: x.cpu(), st)   # noqa: E731

    def same(what, got, want):
        require(got is None and want is None
                or got.cpu().numpy().tobytes() == want.numpy().tobytes(),
                f"{ctrl.name} lock-step round {r}: {what} differ card vs CPU")

    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        cs = take_states(cstate, idx)
        base_st, ctrl_st = proto._split_ctrl(cs)
        blocks = spec.split(deltas)
        carried = blocks + base_st.residual
        ks, st_new = ctrl.chunk_ks(carried, ctrl_st, base_ks=base_up,
                                   caps=caps_up)
        ks_c, st_c = ctrl.chunk_ks(carried.cpu(), cpu(ctrl_st),
                                   base_ks=base_up, caps=caps_up)
        same("client ks", ks, ks_c)
        same("client controller states", st_new, st_c)
        k_cap = int(caps_up.max())
        got = be.select_batch_dynamic(carried.reshape(-1, W), ks.reshape(-1),
                                      k_cap)
        want = be.select_batch_dynamic(carried.reshape(-1, W).cpu(),
                                       ks_c.reshape(-1), k_cap)
        same("dynamic thresholds", got[0], want[0])
        same("dynamic counts", got[1], want[1])
        torch.cuda.synchronize()
        before = dict(rk.LAUNCHES.counts)
        torch.cuda.set_sync_debug_mode("error")
        try:
            proto.base.encode_chunk_blocks_adaptive(
                blocks, base_st, ctrl, ctrl_st, base_ks=base_up, caps=caps_up)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(rk.LAUNCHES.counts[k] == before[k] + 1
                    for k in STC_KERNELS),
                f"{ctrl.name}: the adaptive encode did not launch each STC "
                f"kernel once")
        msgs, cs_new, _ = proto.encode_batch(deltas, cs)
        msgs_c, _, _ = proto.encode_batch(deltas.cpu(), cpu(cs))
        require(torch.equal(torch.sign(msgs.cpu()), torch.sign(msgs_c)),
                f"{ctrl.name} lock-step round {r}: masks or signs differ")
        mean = spec.merge(proto.combine(spec.split(msgs), ones, zeros))
        gd, ss_new, _ = proto.aggregate(msgs, sstate, mask=ones,
                                        staleness=zeros)
        gd_c, ss_c, _ = proto.aggregate(mean.cpu()[None], cpu(sstate))
        require(torch.equal(torch.sign(gd.cpu()), torch.sign(gd_c)),
                f"{ctrl.name} lock-step round {r}: server masks differ")
        if ctrl.stateful:
            same("server controller states", ss_new["ctrl"], ss_c["ctrl"])
        map_states(lambda full, new: full.index_copy_(0, idx, new), cstate,
                   cs_new)
        sstate = ss_new
        params = params + gd
    print(f"{ctrl.name} lock-step ({rounds} rounds, card vs CPU from the same "
          f"inputs): per-chunk ks{', EMA states' if ctrl.stateful else ''}, "
          f"dynamic thresholds, counts and masks identical; the adaptive "
          f"encode ran under set_sync_debug_mode('error'), one launch of "
          f"each STC kernel")


def time_chunked_round(torch, np, tr, reps=5):
    """One chunked round (with the trainer's controller, if it has one)
    split into its phases, state left untouched, median of ``reps``, host
    clock after ``synchronize``: ``local_sgd``, ``encode``, ``apply`` and
    ``ledger`` (the upstream batch and the downstream message); on an
    ingest trainer ``wire_encode``,
    ``decode_scatter`` (the fused ingest), ``finalize`` and ``ledger`` (the
    downstream message) in place of ``apply``."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    names = (("local_sgd", "encode", "wire_encode", "decode_scatter",
              "finalize", "ledger") if tr.ingest
             else ("local_sgd", "encode", "apply", "ledger"))
    phases = {name: [] for name in names + ("round",)}
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        ts.append(sync_now())
        if tr.ingest:
            batch = proto.encode_wire_batch(msgs, direction="up")
            ts.append(sync_now())
            acc = proto.make_ingest(tr.numel)
            proto.ingest_wire_batch(acc, batch, w, direction="up",
                                    device=tr.device)
            ts.append(sync_now())
            gd, _, _ = proto.aggregate_ingest(acc, tr.server_state)
            ts.append(sync_now())
            proto.encode_wire(gd, direction="down")
        else:
            _, _, gd = tr._apply_fn(tr.params_vec, tr.server_state, msgs,
                                    torch.ones(p, device=tr.device),
                                    torch.zeros(p, device=tr.device))
            ts.append(sync_now())
            proto.encode_wire_batch(msgs, direction="up")
            proto.encode_wire(gd, direction="down")
        ts.append(sync_now())
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(reps):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    ctrl = proto.controller.name if proto.controller else None
    print(f"chunked {ctrl or ('ingest' if tr.ingest else 'dense')} round "
          f"phases (median of {reps}, ms, host clock after synchronize): "
          + json.dumps({k: round(v, 3) for k, v in med.items()}))
    return med


def time_chunked_kernels(torch, np, rk, last):
    """Device time of the STC kernels at the chunked selections' shapes
    (the last lock-step round's matrices) beside their plain versions,
    their byte bounds and the library call; ``golomb_decode`` on the
    largest width group's upstream sub-streams.  Returns, by kernel, the
    keys to add to its row of the ``kernels`` line."""
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.selection import bin_index

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    out = {"histogram": {}, "bin_select": {}, "stc_apply": {}}
    for name, ks in (("carried", last["ks_up"]),
                     ("server_carried", last["ks_down"])):
        x = last[name]
        rows, n = x.shape
        tag = f"_{rows}x{n}"
        scale, b, r, _ = select_inputs(torch, x, ks)
        t, c, s = get_stc_backend("kernel").select_batch(x, ks)
        mu = s / torch.clamp(c, min=1).to(torch.float32)
        a = x.abs()
        k_max = int(ks.max())
        flat_bins = (bin_index(a, scale[:, None], 256).to(torch.int64)
                     + 256 * torch.arange(rows, device=x.device)[:, None]
                     ).reshape(-1)
        rows_out = {
            "histogram": (lambda: rk.magnitude_histogram_batched(x, scale),
                          lambda: rk.magnitude_histogram_plain(x, scale),
                          4 * rows * n + 4 * rows + 8 * 256 * rows,
                          lambda: (torch.bincount(flat_bins,
                                                  minlength=256 * rows),
                                   torch.bincount(flat_bins,
                                                  weights=a.reshape(-1),
                                                  minlength=256 * rows))),
            "bin_select": (lambda: rk.candidate_select_batched(x, scale, b,
                                                               r),
                           lambda: rk.candidate_select_plain(x, scale, b, r),
                           4 * rows * n + 20 * rows + 12 * rows,
                           lambda: torch.topk(a, k_max, dim=1)),
            "stc_apply": (lambda: rk.stc_apply_batched(x, t, mu),
                          lambda: rk.stc_apply_plain(x, t, mu),
                          3 * 4 * rows * n + 8 * rows, None)}
        for kname, (kernel, plain, nbytes, lib) in rows_out.items():
            out[kname].update({
                "ms" + tag: event_ms(torch, kernel),
                "plain_ms" + tag: event_ms(torch, plain, iters=10,
                                           hold_stream=False),
                "bound_ms" + tag: bound(nbytes),
                "library_ms" + tag: (event_ms(torch, lib) if lib is not None
                                     else None)})
        sel = {"host": event_ms(torch, lambda: rk.hist_topk_threshold_batched(
                   x, ks), iters=20, hold_stream=False),
               "device": event_ms(torch, lambda: rk.hist_topk_threshold_batched(
                   x, ks), iters=20)}
        out["bin_select"]["selection_ms" + tag] = sel
        for key, val in select_structure(torch, rk, x, scale, b, r,
                                         full_reads=1).items():
            out["bin_select"][key + tag] = val
    batch = last["batch"]
    big = max(batch.batches, key=lambda wb: wb.words.size)
    row = golomb_row(torch, np, rk, {"golomb_decode": 0},
                     {"golomb_decode": 0.0}, big, P_STC,
                     lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3, None)
    out["golomb_decode"] = {
        "ms_chunked_group": row["ms"], "plan_chunked_group": row["plan"],
        "bound_ms_chunked_group": row["bound_ms"],
        "plain_ms_chunked_group": row["plain_ms"],
        "words_chunked_group": row["words"],
        "segments_chunked_group": row["segments"]}
    print(f"chunked kernel times (ms, device): {json.dumps(out)}")
    return out


def run_chunked(torch, np, rk):
    """Phase 9: the chunked ``(layer, chunk)`` STC codec and the adaptive
    controllers on the cnn at full width.  Returns ``(launches by path,
    keys by kernel for the kernels line, max errors)``."""
    t0 = time.perf_counter()
    check_whole_vector(torch)
    paths, errs = {}, {"bin_select": 0.0}
    tr_d, paths["chunked_dense"], last, _ = run_chunked_trainers(
        torch, np, rk, lockstep=lambda tr: (
            profile_round(torch, tr, "chunked dense"),
            check_chunked_lockstep(torch, np, rk, tr))[1])
    errs["bin_select"] = check_chunked_selection(torch, rk, last)
    tr_i, paths["chunked_ingest"], _, _ = run_chunked_trainers(
        torch, np, rk, ingest=True,
        lockstep=lambda tr: profile_round(torch, tr, "chunked ingest"))
    adaptive = []
    for controller in CHUNKED_CONTROLLERS:
        tr_a, paths[controller[0]], _, _ = run_chunked_trainers(
            torch, np, rk, controller=controller,
            lockstep=lambda tr: check_adaptive_lockstep(torch, np, rk, tr))
        adaptive.append(tr_a)
    for tr in (tr_d, tr_i, *adaptive):
        time_chunked_round(torch, np, tr)
    extra = time_chunked_kernels(torch, np, rk, last)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    print(f"card: {card_line()}")
    return paths, extra, errs


# --------------------------------------------------------------- phase 10

EVENT_AGGS = 10           # K = cohort against the synchronous trainer
ASYNC_AGGS = 40           # K = 5 of a cohort of 10, card against CPU
ATTACK_AGGS = 20          # the robust rules and the norm screen under attack
RESUME_AGGS = 20          # kill-and-resume against an uninterrupted run
RESUME_KILL_AT = 37       # served events before the kill
ASYNC_KW = {"k_arrivals": 5, "concurrency": 10, "max_staleness": 8}
# two aggregations a cohort double the server's steps: at lr 0.05 the
# asynchronous fleet swings (0.09 to 0.78 accuracy between 40 and 120
# aggregations on the CPU), at 0.01 it converges, as phase 7's codecs do
ASYNC_LR = 0.01
SIGN_FLIP = {"scale": 10.0, "fraction": 0.2}
SCALE_ATTACK = {"factor": 100.0, "fraction": 0.2}
EVENT_PHASES = ("dispatch", "to_host", "validate", "ingest", "combine",
                "ledger")


def make_event_trainer(device, torch, ingest=False, rule=None, lr=0.05,
                       **kw):
    """Phase 3's cnn setting under ``EventDrivenTrainer`` (``kw`` are its
    keywords); ``rule`` is the STC codec's aggregation rule."""
    from repro_torch.core import make_protocol
    from repro_torch.data import make_image_classification
    from repro_torch.fed import (EventDrivenTrainer, FedEnvironment,
                                 TrainerConfig)
    from repro_torch.models import MODEL_ZOO
    train, test = make_image_classification(seed=0, n=6000)
    env = FedEnvironment(n_clients=10, participation=1.0,
                         classes_per_client=2, batch_size=20)
    proto_kw = dict(CODEC_KW["stc"])
    if rule is not None:
        proto_kw["rule"] = rule
    return EventDrivenTrainer(MODEL_ZOO["cnn"], train, test, env,
                              make_protocol("stc", **proto_kw),
                              TrainerConfig(lr=lr, ingest=ingest),
                              device=device, **kw)


def schedule(log):
    """An event log without its billing column: the event schedule."""
    return [{k: v for k, v in r.items() if k != "bits_up"} for r in log]


def run_on_card(torch, rk, tr, aggs):
    """``aggs`` aggregations with the launch counters set to 0 just before;
    returns the counts and the last history row."""
    rk.LAUNCHES.reset()
    h = tr.run(aggs, eval_every=aggs)[-1]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(tr.params_vec).all()),
            "non-finite parameters")
    return dict(rk.LAUNCHES.counts), h


def same_run(torch, a, b, what):
    require(torch.equal(a.params_vec.cpu(), b.params_vec.cpu())
            and all(getattr(a, c) == getattr(b, c) for c in LEDGER_COLS)
            and a.wire_log == b.wire_log,
            f"{what}: parameters, ledger or wire log differ")


def stc_launches(tr):
    """The STC kernels' launches an event run must show: the clients' STC
    at each dispatch and the server's at each aggregation."""
    n_disp = sum(r["kind"] == "dispatch" for r in tr.event_log)
    return n_disp + len(tr.agg_log)


def check_k_cohort(torch, rk):
    """K = cohort: the event trainer with its defaults is the synchronous
    trainer bit for bit on the card, on both routes."""
    out = {}
    for ingest in (False, True):
        route = "ingest" if ingest else "dense"
        sync = make_trainer("cuda", torch, ingest=ingest)
        sync.run(EVENT_AGGS, eval_every=EVENT_AGGS)
        ev = make_event_trainer("cuda", torch, ingest=ingest)
        launches, h = run_on_card(torch, rk, ev, EVENT_AGGS)
        same_run(torch, sync, ev, f"events K=cohort {route}")
        require(ev.n_dropped == ev.n_lost == 0,
                f"events K=cohort {route}: drops or losses")
        stc = stc_launches(ev)
        arrivals = sum(r["kind"] == "arrival" for r in ev.event_log)
        want = {"histogram": stc, "bin_select": stc, "stc_apply": stc,
                "golomb_decode": 2 * arrivals if ingest else 0}
        got = {k: launches[k] for k in want}
        require(got == want, f"events K=cohort {route}: launched "
                             f"{json.dumps(got)}, not {json.dumps(want)}")
        print(f"events K=cohort {route}: {EVENT_AGGS} aggregations, "
              f"parameters, ledger and wire log bitwise the synchronous "
              f"trainer's on the card | acc={h['acc']:.4f} | launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}")
        out[f"events_{route}"] = launches
    return out


def check_async(torch, np, rk):
    """K = 5 of a cohort of 10 on the ingest route, card against CPU: the
    event schedule and the aggregation log identical, accuracy within
    0.03, ``bits_up`` within 2 %, and the exact launches the logs imply."""
    gpu = make_event_trainer("cuda", torch, ingest=True, lr=ASYNC_LR,
                             **ASYNC_KW)
    t0 = time.perf_counter()
    launches, h_gpu = run_on_card(torch, rk, gpu, ASYNC_AGGS)
    gpu_s = time.perf_counter() - t0
    cpu = make_event_trainer("cpu", torch, ingest=True, lr=ASYNC_LR,
                             **ASYNC_KW)
    t0 = time.perf_counter()
    h_cpu = cpu.run(ASYNC_AGGS, eval_every=ASYNC_AGGS)[-1]
    cpu_s = time.perf_counter() - t0
    require(schedule(gpu.event_log) == schedule(cpu.event_log),
            "events async: the event schedules differ card vs CPU")
    require(gpu.agg_log == cpu.agg_log,
            "events async: the aggregation logs differ card vs CPU")
    stale = [r["staleness"] for r in gpu.event_log if r["kind"] == "arrival"]
    require(max(stale) > 0, "events async: no stale arrival")
    d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
    d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
    # each admitted STC arrival: one golomb_decode to validate, one to
    # ingest (a zero-length stream, 32 bits of header alone, decodes none)
    decodes = 2 * sum(r["kind"] == "arrival" and r["bits_up"] > 32
                      for r in gpu.event_log)
    stc = stc_launches(gpu)
    want = {"golomb_decode": decodes, "histogram": stc, "bin_select": stc,
            "stc_apply": stc, "pack_chunks": stc, "unpack_bits": 0,
            "pack_bits": 0}
    got = {k: launches[k] for k in want}
    print(f"events async: cnn, ingest, lr {ASYNC_LR}, {ASYNC_AGGS} "
          f"aggregations of {ASYNC_KW} | card acc={h_gpu['acc']:.4f} "
          f"bits_up={h_gpu['bits_up']:.0f} ({gpu_s:.1f} s) | cpu "
          f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
          f"({cpu_s:.1f} s) | |d acc|={d_acc:.4f} |d bits_up|={d_up:.4%} | "
          f"staleness max {max(stale)}, mean {np.mean(stale):.3f} | "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    require(d_acc <= 0.03, f"events async: accuracy differs by {d_acc:.4f}")
    require(d_up <= 0.02, f"events async: bits_up differs by {d_up:.4%}")
    require(got == want, f"events async: launched {json.dumps(got)}, not "
                         f"{json.dumps(want)}")
    return {"events_async": launches}


def record_combines(np, tr, keep):
    """Keep the last ``keep`` dense aggregations' inputs (the buffer on the
    trainer's device, mask, staleness)."""
    seen = []
    apply_update = tr._apply_update

    def recording(msgs, mask, staleness):
        seen.append((msgs.clone(), np.asarray(mask).copy(),
                     np.asarray(staleness).copy()))
        del seen[:-keep]
        return apply_update(msgs, mask, staleness)

    tr._apply_update = recording
    return seen


def check_robust_rules(torch, np, rk):
    """The order-statistic rules (and the mean) under a 20 % sign-flip
    attack at 10x, dense route on the card; then 3 aggregations' combines
    on the same buffer, card against CPU, bitwise."""
    from repro_torch.fed import make_fault
    out, accs = {}, {}
    for rule in ("mean", "coordinate_median", "trimmed_mean"):
        tr = make_event_trainer("cuda", torch, rule=rule,
                                faults=make_fault("sign-flip", **SIGN_FLIP))
        launches, h = run_on_card(torch, rk, tr, ATTACK_AGGS)
        accs[rule] = h["acc"]
        stc = stc_launches(tr)
        require(launches["histogram"] == launches["bin_select"]
                == launches["stc_apply"] == stc,
                f"events {rule}: STC launched {launches['histogram']} "
                f"times, not {stc}")
        out[f"events_{rule}"] = launches
        if rule == "mean":
            continue
        seen = record_combines(np, tr, 3)
        tr.run(3, eval_every=3)
        for msgs, mask, stale in seen:
            m = torch.from_numpy(mask)
            s = torch.from_numpy(stale)
            card = tr.protocol.combine(msgs, m.cuda(), s.cuda()).cpu()
            host = tr.protocol.combine(msgs.cpu(), m, s)
            require(torch.equal(card.view(torch.int32),
                                host.view(torch.int32)),
                    f"events {rule}: combine differs card vs CPU")
        print(f"events {rule}: 3 lock-step combines of ({seen[0][0].shape[0]}"
              f", {tr.numel}) bitwise card vs CPU")
    print(f"events under sign-flip {json.dumps(SIGN_FLIP)}, "
          f"{ATTACK_AGGS} aggregations, dense route, accuracy: "
          f"{json.dumps(accs)}")
    return out


def screen_bound(torch, np):
    """3x the median wire norm of aggregation 0's honest arrivals under
    the scale attack."""
    from repro_torch.fed import make_fault
    fm = make_fault("scale-attack", **SCALE_ATTACK)
    tr = make_event_trainer("cuda", torch, ingest=True, faults=fm)
    seen = []
    ingest_kept = tr._ingest_kept

    def recording(kept, staleness):
        seen.extend(kept)
        return ingest_kept(kept, staleness)

    tr._ingest_kept = recording
    tr.run_round()
    honest = [tr.protocol.wire_norm(r.payload) for r in seen
              if not fm.is_byzantine(r.client)]
    require(len(honest) < len(seen), "scale attack: no Byzantine arrival "
                                     "in aggregation 0")
    return 3.0 * float(np.median(honest))


def screened_run(torch, rk, device, bound, aggs):
    """The ingest route under the scale attack with the reject screen;
    returns the trainer, its launches (card) and, per aggregation, the
    screened count and whether a Byzantine client arrived."""
    from repro_torch.core import make_rule
    from repro_torch.fed import make_fault
    fm = make_fault("scale-attack", **SCALE_ATTACK)
    tr = make_event_trainer(
        device, torch, ingest=True, faults=fm,
        rule=make_rule("norm_screened_mean", policy="reject", bound=bound))
    per_agg, byz = [], []
    ingest_kept, finalize = tr._ingest_kept, tr._finalize_ingest

    def kept_rec(kept, staleness):
        byz.append(any(fm.is_byzantine(r.client) for r in kept))
        return ingest_kept(kept, staleness)

    def fin_rec(acc):
        per_agg.append(acc.n_screened)
        return finalize(acc)

    tr._ingest_kept, tr._finalize_ingest = kept_rec, fin_rec
    if device == "cuda":
        launches, h = run_on_card(torch, rk, tr, aggs)
    else:
        launches, h = None, tr.run(aggs, eval_every=aggs)[-1]
    return tr, launches, h, per_agg, byz


def check_norm_screen(torch, np, rk):
    bound = screen_bound(torch, np)
    gpu, launches, h_gpu, scr_gpu, byz = screened_run(
        torch, rk, "cuda", bound, ATTACK_AGGS)
    cpu, _, h_cpu, scr_cpu, _ = screened_run(torch, rk, "cpu", bound,
                                             ATTACK_AGGS)
    print(f"events norm screen: reject above {bound:.6g} (3x the median "
          f"honest wire norm of aggregation 0) under scale-attack "
          f"{json.dumps(SCALE_ATTACK)}, ingest, {ATTACK_AGGS} aggregations "
          f"| screened per aggregation card {scr_gpu} cpu {scr_cpu} | acc "
          f"card {h_gpu['acc']:.4f} cpu {h_cpu['acc']:.4f} | launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    require(scr_gpu == scr_cpu, "events norm screen: screened counts "
                                "differ card vs CPU")
    require(all(n > 0 for n, b in zip(scr_gpu, byz) if b) and any(byz),
            "events norm screen: an aggregation with a Byzantine arrival "
            "screened nothing")
    arrivals = sum(r["kind"] == "arrival" for r in gpu.event_log)
    want = 2 * arrivals - sum(scr_gpu)
    require(launches["golomb_decode"] == want,
            f"events norm screen: golomb_decode launched "
            f"{launches['golomb_decode']} times, not {want} (a rejected "
            f"arrival is validated, not decoded)")
    return {"events_screen": launches}


def check_resume(torch, np, rk):
    """Kill at event 37 with a checkpoint every 5 events, resume into a
    fresh trainer with ``faults="none"``, run to 20 aggregations: bitwise
    an uninterrupted card run."""
    import tempfile
    from repro_torch.fed import ServerKilled, make_fault
    ref = make_event_trainer("cuda", torch, ingest=True, faults="none")
    ref.run(RESUME_AGGS, eval_every=RESUME_AGGS)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ck = str(Path(tmp) / "events.ck")
        killed = make_event_trainer(
            "cuda", torch, ingest=True, ckpt_path=ck, ckpt_every=5,
            faults=make_fault("server-kill", at_event=RESUME_KILL_AT))
        t0 = time.perf_counter()
        try:
            killed.run(RESUME_AGGS, eval_every=RESUME_AGGS)
            raise Failure("events resume: the server was not killed")
        except ServerKilled:
            pass
        run_s = time.perf_counter() - t0
        resumed = make_event_trainer("cuda", torch, ingest=True,
                                     faults="none")
        t0 = time.perf_counter()
        resumed.restore_checkpoint(ck)
        restore_s = time.perf_counter() - t0
        size = Path(ck).stat().st_size
    at = resumed.n_events_served
    rk.LAUNCHES.reset()
    while resumed.round < RESUME_AGGS:
        resumed.run_round()
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES.counts)
    same_run(torch, ref, resumed, "events resume")
    require(resumed.event_log == ref.event_log
            and resumed.agg_log == ref.agg_log
            and resumed.loop.quarantine_log == ref.loop.quarantine_log
            and torch.equal(resumed.server_state.residual,
                            ref.server_state.residual),
            "events resume: logs or server state differ from the "
            "uninterrupted run")
    print(f"events resume: killed before event {RESUME_KILL_AT}, resumed at "
          f"event {at} ({killed.round} aggregations done), run to "
          f"{RESUME_AGGS}: bitwise the uninterrupted card run | checkpoint "
          f"{size} bytes; killed run {run_s:.1f} s with "
          f"{at // 5} checkpoints; restore {restore_s * 1e3:.0f} ms")
    return {"events_resume": launches}


def timed(torch, fn, sink, name):
    """``fn`` adding its host-clock time (after ``synchronize``) to
    ``sink[name]``."""
    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink[name] = sink.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def time_event_phases(torch, tr, what, reps=5):
    """The median of ``reps`` aggregations by phase, ms on the host clock
    after ``synchronize``: dispatch (local SGD and encode), to_host (the
    payload copy), validate, ingest or combine, ledger."""
    sink = {}
    tr._dispatch = timed(torch, tr._dispatch, sink, "dispatch")
    tr._host_payloads = timed(torch, tr._host_payloads, sink, "to_host")
    tr.loop.validator = timed(torch, tr.loop.validator, sink, "validate")
    tr._ingest_kept = timed(torch, tr._ingest_kept, sink, "ingest")
    tr._combine_kept = timed(torch, tr._combine_kept, sink, "combine")
    tr._flush_ledger = timed(torch, tr._flush_ledger, sink, "ledger")
    rows, totals = [], []
    for _ in range(reps):
        sink.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        rows.append(dict(sink))
    med = {k: statistics.median(r.get(k, 0.0) for r in rows)
           for k in EVENT_PHASES if any(k in r for r in rows)}
    print(f"events {what} aggregation phases (median of {reps}, ms, host "
          f"clock after synchronize): "
          f"{json.dumps({k: round(v, 3) for k, v in med.items()})} | whole "
          f"aggregation {statistics.median(totals):.3f}")
    return med


def run_events(torch, np, rk):
    """Phase 10: the event-driven server on the card.  Returns the launch
    counts by path."""
    t0 = time.perf_counter()
    paths = {}
    paths.update(check_k_cohort(torch, rk))
    paths.update(check_async(torch, np, rk))
    paths.update(check_robust_rules(torch, np, rk))
    paths.update(check_norm_screen(torch, np, rk))
    paths.update(check_resume(torch, np, rk))
    from repro_torch.fed import make_fault
    for what, kw in (("ingest", {"ingest": True}),
                     ("coordinate_median", {"rule": "coordinate_median",
                                            "faults": make_fault(
                                                "sign-flip", **SIGN_FLIP)}),
                     ("trimmed_mean", {"rule": "trimmed_mean"})):
        tr = make_event_trainer("cuda", torch, **kw)
        tr.run(2, eval_every=2)
        time_event_phases(torch, tr, what)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    print(f"card: {card_line()}")
    return paths


# --------------------------------------------------------------- phase 11

MESH_ARCH = "smollm-135m"
# depth cut from 30 layers to 10 for the whole script's time (phases 11
# and 12 took 227 s of a 997 s run at 30); width, vocab and heads as
# published
MESH_LAYERS = 10
MESH_NUMEL = 63_713_088         # SmolLM-135M's width at MESH_LAYERS
MESH_K = 1_274_261              # int(MESH_NUMEL / 50)
MESH_STEPS = 10
MESH_RANK_STEPS = 3
MESH_TC = {"protocol": "stc", "lr": 0.05, "sparsity_up": 1 / 50,
           "sparsity_down": 1 / 50}
MESH_KERNELS = ("histogram", "bin_select", "stc_apply")
MESH_DIR = ROOT / "build" / "mesh_ranks"
MESH_RANK_TIMEOUT = 420


def mesh_config():
    """SmolLM-135M at full width, its depth cut to ``MESH_LAYERS``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MESH_ARCH), n_layers=MESH_LAYERS)


def mesh_setup(torch, np):
    """SmolLM-135M at full width (``mesh_config``), the reference CLI's STC
    setting (bf16 compute) and ``make_lm_tokens(seed=0)`` in a 4 x 128
    batch: ``(cfg, tc, batch)``."""
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch.train import TrainConfig
    cfg = mesh_config()
    toks = make_lm_tokens(seed=0, n_tokens=4 * 128 + 1, vocab=cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:-1].reshape(4, 128)),
             "labels": torch.from_numpy(toks[1:].reshape(4, 128))}
    return cfg, TrainConfig(**MESH_TC), batch


def mesh_delta(torch, cfg, tc, params, batch, rows, deterministic=True,
               tp=None):
    """One client's local SGD as the trainer computes it: ``-lr·grad`` of
    the loss on ``rows`` of the batch (with its ``frames`` or ``prefix``),
    under the trainer's deterministic algorithms (without them only to
    time what they cost); with ``tp``, a model rank's on its blocks."""
    import contextlib
    from repro_torch.core.compression import _rebuild, tree_leaves
    from repro_torch.launch.train import _deterministic
    from repro_torch.models.transformer import lm_loss
    dev = tree_leaves(params)[0].device
    extra = {name: batch[name][rows].to(dev) for name in ("frames", "prefix")
             if name in batch}
    with (_deterministic(dev) if deterministic
          else contextlib.nullcontext()):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        loss = lm_loss(_rebuild(params, iter(leaves)), cfg,
                       batch["tokens"][rows].to(dev),
                       batch["labels"][rows].to(dev),
                       compute_dtype=tc.compute_dtype, tp=tp, **extra)
        grads = torch.autograd.grad(loss, leaves)
    return _rebuild(params, iter(-tc.lr * g.to(torch.float32)
                                 for g in grads))


def params_digest(torch, np, params) -> str:
    """SHA-256 of the parameters' fp32 bytes in flatten order."""
    import hashlib
    from repro_torch.core.compression import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().to(torch.float32).contiguous().cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def mesh_single(torch, np, rk, cfg, tc, batch, steps, what="mesh"):
    """11a (13b): one client, no client axes, ``steps`` steps on the card
    with the counters set to 0 just before: the loss finite and falling,
    ``nnz`` k or more, the histogram, ``bin_select`` and ``stc_apply``
    exactly twice a step at (1, numel) and nothing else.  Returns
    ``(state, launches)``."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import init_train_state, make_train_step
    numel = cfg.param_count()
    k = max(int(numel * tc.sparsity_up), 1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    before_asked = requested_bytes(torch)
    state = init_train_state(cfg, tc, 1, key=0)
    torch.cuda.synchronize()
    dryrun_state_check(torch, cfg, tc, batch, state,
                       torch.cuda.memory_allocated() - before,
                       requested_bytes(torch) - before_asked, what)
    step = make_train_step(cfg, make_debug_mesh(data=1, model=1), tc)
    torch.cuda.synchronize()
    rk.LAUNCHES.reset()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = dict(rk.LAUNCHES.counts)
    shapes = dict(rk.LAUNCHES.shapes)
    losses = [float(m["loss"]) for m in metrics]
    nnz = [(int(m["nnz_up"]), int(m["nnz_down"])) for m in metrics]
    print(f"{what} single client: {steps} steps in {took:.2f} s, "
          f"losses {json.dumps(losses)}; nnz (up, down) beside k = {k}: "
          f"{nnz}; ties above k (up, down): "
          f"{[(u - k, d - k) for u, d in nnz]}; launches "
          f"{ {n: launches[n] for n in MESH_KERNELS} } at "
          f"{ {n: shapes.get(n) for n in MESH_KERNELS} }; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    require(all(math.isfinite(x) for x in losses), f"loss not finite: "
            f"{losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(all(u >= k and d >= k for u, d in nnz),
            f"a selection kept fewer than k = {k}: {nnz}")
    for name in MESH_KERNELS:
        require(launches[name] == 2 * steps,
                f"{name} launched {launches[name]} times in {steps} "
                f"{what} steps, not twice a step")
        require(shapes.get(name) == (1, numel),
                f"{name}'s last launch was at {shapes.get(name)}, not "
                f"(1, {numel})")
    others = {n: c for n, c in launches.items()
              if c and n not in MESH_KERNELS}
    require(not others, f"the {what} step launched other kernels: {others}")
    return state, launches


def dryrun_record(cfg, tc, shape, **kw):
    """The dry run's record of ``cfg`` (a cut config) at ``shape`` (an
    input shape's name or an ``InputShape``) on one card, sized on the meta
    device."""
    from repro_torch.launch.dryrun import lower_combo
    from repro_torch.launch.mesh import make_debug_mesh
    return lower_combo(cfg.name, shape, mesh=make_debug_mesh(1, 1), cfg=cfg,
                       tc=tc, verbose=False, ingest=False, **kw)


def allocator_slack(leaves: int) -> int:
    """What the card's caching allocator may add to ``leaves`` tensors: it
    rounds each allocation up to a multiple of 512 B."""
    return 512 * leaves


def requested_bytes(torch):
    """The bytes the live tensors asked the caching allocator for (its
    ``requested_bytes`` stat, before rounding)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dryrun_state_check(torch, cfg, tc, batch, state, grown, asked, what):
    """11a (13b, 14a): what ``init_train_state`` asked the card's allocator
    for (``requested_bytes``) against the dry run's state bytes for the
    same config on one card, within 512 B a leaf."""
    from repro_torch.configs import InputShape
    from repro_torch.core.compression import tree_leaves
    t0 = time.perf_counter()
    b, s = batch["tokens"].shape
    rec = dryrun_record(cfg, tc, InputShape("row", s, b, "train"))
    want = rec["memory"]["arguments"]["state"]
    leaves = len(tree_leaves(state))
    print(f"{what} init_train_state: {asked} bytes requested on the card "
          f"({grown} allocated), dry run {want} bytes ({leaves} leaves); "
          f"the dry-run check took {time.perf_counter() - t0:.2f} s")
    require(0 <= asked - want <= allocator_slack(leaves),
            f"{what}: init_train_state took {asked} bytes (requested), the "
            f"dry run sized {want}")


def dryrun_flops_check(torch, cfg, tc, batch, state, step_ms, what="mesh"):
    """11e: one step under ``FlopCounterMode`` counts exactly the dry run's
    ``flops`` for the same config and batch on one card; the count over the
    step's median time as TFLOP/s and as a share of the bf16 peak."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import InputShape
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import make_train_step
    t0 = time.perf_counter()
    step = make_train_step(cfg, make_debug_mesh(data=1, model=1), tc)
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
        torch.cuda.synchronize()
    counted = counter.get_total_flops()
    b, s = batch["tokens"].shape
    want = dryrun_record(cfg, tc, InputShape("row", s, b, "train"))["flops"]
    rate = counted / (step_ms / 1e3)
    print(f"{what} step FLOPs: FlopCounterMode {counted}, dry run "
          f"{want:.0f}; {rate / 1e12:.3f} TFLOP/s over the step's median "
          f"{step_ms:.3f} ms, {rate / BF16_FLOP_PER_S:.5f} of the "
          f"989 TFLOP/s bf16 peak; card: {card_line()}; the dry-run check "
          f"took {time.perf_counter() - t0:.2f} s")
    require(counted == want, f"{what}: the step counted {counted} FLOPs, "
            f"the dry run {want}")


def mesh_lockstep(torch, np, rk, state, cfg, tc, batch):
    """11b: the card's ``tree_encode`` and ``tree_decode`` from the state
    after 11a against the ``"torch"`` route on the CPU, on the same
    trees: thresholds, counts, positions and signs exact, µ within rtol
    1e-6, residuals within 1e-6 of ``|carried| + µ``; the excess of the
    counts over k are ties at the threshold.  Returns the card's carried
    row (for the kernel checks and times) and the excess."""
    from repro_torch.core.compression import flatten_pytree, tree_map
    from repro_torch.core.distributed import (
        stc_compress_tree_with_residual, tree_add)
    from repro_torch.launch.train import codec_for
    numel = cfg.param_count()
    k = max(int(numel * tc.sparsity_up), 1)
    delta = mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4))
    cres = tree_map(lambda x: x[0], state["client_res"])
    carried_up = tree_add(delta, cres)

    def cpu(tree):
        return tree_map(lambda x: x.cpu(), tree)

    t_k, r_k, s_k = stc_compress_tree_with_residual(carried_up, tc.sparsity_up,
                                                    backend="kernel")
    t_c, r_c, s_c = stc_compress_tree_with_residual(cpu(carried_up),
                                                    tc.sparsity_up,
                                                    backend="torch")
    sres = state["server_res"]
    carried_down = tree_add(t_k, sres)
    d_k, dr_k, ds_k = stc_compress_tree_with_residual(
        carried_down, tc.sparsity_down, backend="kernel")
    d_c, dr_c, ds_c = stc_compress_tree_with_residual(
        cpu(carried_down), tc.sparsity_down, backend="torch")
    # the codec's own tree path on the card is this composition
    codec = codec_for(tc)
    msg, _, m_up = codec.tree_encode(delta, cres, numel=numel)
    down, _, m_down = codec.tree_decode(t_k, sres, numel=numel)
    require(torch.equal(flatten_pytree(msg)[0], flatten_pytree(t_k)[0])
            and torch.equal(flatten_pytree(down)[0],
                            flatten_pytree(d_k)[0])
            and int(m_up["nnz_up"]) == int(s_k.nnz)
            and int(m_down["nnz_down"]) == int(ds_k.nnz),
            "the codec's tree_encode / tree_decode differ from the tree "
            "STC on the same trees")
    excess = {}
    for what, (tk, rk_, sk), (tc_, rc, sc), carried in (
            ("encode", (t_k, r_k, s_k), (t_c, r_c, s_c), carried_up),
            ("decode", (d_k, dr_k, ds_k), (d_c, dr_c, ds_c), carried_down)):
        vk, _ = flatten_pytree(tk)
        vc, _ = flatten_pytree(tc_)
        vk = vk.cpu()
        require(float(sk.thresh) == float(sc.thresh),
                f"mesh {what}: thresholds differ card {float(sk.thresh)!r} "
                f"CPU {float(sc.thresh)!r}")
        require(int(sk.nnz) == int(sc.nnz),
                f"mesh {what}: counts differ {int(sk.nnz)} {int(sc.nnz)}")
        require(torch.equal(vk != 0, vc != 0)
                and torch.equal(torch.sign(vk), torch.sign(vc)),
                f"mesh {what}: positions or signs differ")
        mu_k, mu_c = float(sk.mu), float(sc.mu)
        require(abs(mu_k - mu_c) <= 1e-6 * abs(mu_c),
                f"mesh {what}: µ {mu_k!r} against {mu_c!r}")
        ck, _ = flatten_pytree(carried)
        ck = ck.cpu()
        res_k, _ = flatten_pytree(rk_)
        res_c, _ = flatten_pytree(rc)
        tol = 1e-6 * (ck.abs() + abs(mu_c))
        require(bool(((res_k.cpu() - res_c).abs() <= tol).all()),
                f"mesh {what}: residuals beyond 1e-6 of |carried| + µ")
        a = ck.abs()
        t = float(sc.thresh)
        above, at = int((a > t).sum()), int((a >= t).sum())
        require(above < k <= at == int(sc.nnz),
                f"mesh {what}: count {int(sc.nnz)} is not k = {k} plus ties "
                f"(> t: {above}, >= t: {at})")
        excess[what] = at - k
        print(f"mesh lock-step {what}: threshold {t!r}, count {int(sc.nnz)} "
              f"(k = {k}, {at - k} ties at the threshold above k), µ card "
              f"{mu_k!r} CPU {mu_c!r}: exact but µ")
    row, _ = flatten_pytree(carried_up)
    return row[None], excess


def mesh_rank(rank, port, steps, out_dir):
    """11c, one client rank (a spawned process): gloo on ``cuda:0``, the
    full-width state from seed 0, ``steps`` STC steps on its half of the
    batch, then one masked step with mask (1, 0).  Writes the digests of
    the parameters after every step, whether its residual was unchanged by
    the masked step, whether ``all_gather`` of CUDA tensors is right, and
    its step times."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as rd
    from repro_torch.core.compression import tree_leaves
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        cfg, tc, batch = mesh_setup(torch, np)
        mesh = make_debug_mesh(data=2, model=1)
        state = init_train_state(cfg, tc, 2, key=0)
        step = make_train_step(cfg, mesh, tc)
        digests, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            digests.append(params_digest(torch, np, state["params"]))
        masked = make_train_step(cfg, mesh, dataclasses.replace(
            tc, masked=True))
        before = [x.clone() for x in tree_leaves(state["client_res"])]
        new_state, _ = masked(state, batch, torch.tensor([1.0, 0.0]),
                              torch.zeros(2))
        torch.cuda.synchronize()
        unchanged = all(torch.equal(a, b) for a, b in zip(
            before, tree_leaves(new_state["client_res"])))
        digests.append(params_digest(torch, np, new_state["params"]))
        # the order-statistic rules' all_gather, on CUDA tensors too
        probe = torch.arange(4, dtype=torch.float32, device="cuda") + rank
        gathered = rd.all_gather(probe, dist.group.WORLD)
        gather_ok = torch.equal(gathered.cpu(), torch.stack(
            [torch.arange(4, dtype=torch.float32) + r for r in range(2)]))
        (out_dir / f"rank{rank}.json").write_text(json.dumps({
            "digests": digests, "residual_unchanged": unchanged,
            "all_gather_ok": gather_ok, "step_s": times,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    finally:
        dist.destroy_process_group()


def mesh_composition(torch, np, cfg, tc, batch, steps):
    """The two-client composition in one process on the card: two local
    steps, two ``tree_encode``, (a + b) / 2, ``tree_decode``; then the
    masked step (1, 0): ``(1·a + 0·b) / 1``.  Returns the digests of the
    parameters after every step."""
    from repro_torch.core.compression import (flatten_pytree, tree_map,
                                              unflatten_pytree)
    from repro_torch.launch.train import codec_for, init_train_state
    state = init_train_state(cfg, tc, 2, key=0)
    codec = codec_for(tc)
    numel = cfg.param_count()
    dev = torch.device("cuda")
    params = state["params"]
    cres = [tree_map(lambda x: x[0].clone(), state["client_res"])
            for _ in range(2)]
    sres = state["server_res"]
    digests = []
    for i in range(steps + 1):
        msgs = []
        for r, rows in enumerate((slice(0, 2), slice(2, 4))):
            delta = mesh_delta(torch, cfg, tc, params, batch, rows)
            msg, new_cres, _ = codec.tree_encode(delta, cres[r], numel=numel)
            if i < steps or r == 0:
                cres[r] = new_cres
            msgs.append(flatten_pytree(msg))
        (va, spec), (vb, _) = msgs
        if i < steps:
            comb = (va + vb) / torch.tensor(2.0, device=dev)
        else:
            one, zero = (torch.tensor(1.0, device=dev),
                         torch.tensor(0.0, device=dev))
            comb = (one * va + zero * vb) / one
        down, sres, _ = codec.tree_decode(unflatten_pytree(comb, spec), sres,
                                          numel=numel)
        params = tree_map(lambda p, d: (p.to(torch.float32)
                                        + d.to(torch.float32)).to(p.dtype),
                          params, down)
        digests.append(params_digest(torch, np, params))
    return digests


def mesh_two_ranks(torch, np):
    """11c: two client ranks on the card (gloo, ``make_debug_mesh(data=2,
    model=1)``, half the batch each), 3 steps and one masked step, against
    the same composition in one process: bitwise every step."""
    import shutil
    import socket
    import torch.multiprocessing as mp
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(port, MESH_RANK_STEPS,
                                              MESH_DIR),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            require(time.monotonic() < deadline,
                    f"the two mesh ranks did not finish in "
                    f"{MESH_RANK_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    took = time.perf_counter() - t0
    ranks = [json.loads((MESH_DIR / f"rank{r}.json").read_text())
             for r in range(2)]
    cfg, tc, batch = mesh_setup(torch, np)
    want = mesh_composition(torch, np, cfg, tc, batch, MESH_RANK_STEPS)
    for r, out in enumerate(ranks):
        require(out["digests"] == want,
                f"rank {r}'s parameters are not bitwise the in-process "
                f"composition at steps "
                f"{[i for i, (a, b) in enumerate(zip(out['digests'], want)) if a != b]}")
        require(out["all_gather_ok"], f"rank {r}: all_gather of CUDA "
                f"tensors gave wrong values")
    require(ranks[1]["residual_unchanged"],
            "the masked step (1, 0) changed rank 1's residual")
    require(not ranks[0]["residual_unchanged"],
            "the masked step (1, 0) left rank 0's residual unchanged")
    print(f"mesh two ranks on the card: {MESH_RANK_STEPS} steps and one "
          f"masked step bitwise the in-process composition; rank 1's "
          f"residual unchanged under mask (1, 0); gloo's all_reduce and "
          f"all_gather took the CUDA tensors (no host copy); step "
          f"seconds {[o['step_s'] for o in ranks]}; peak GiB "
          f"{[round(o['peak_gib'], 3) for o in ranks]}; {took:.1f} s with "
          f"the ranks' start")
    return ranks


def median_s(torch, fn, reps=5):
    """Median host-clock seconds of ``fn`` over ``reps`` calls, each
    between two ``synchronize``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def count_syncs(torch, fn) -> int:
    """Host synchronizations in one call of ``fn``: the warnings of
    ``set_sync_debug_mode("warn")`` (``.tolist()``, ``.item()``, a copy
    from or to pageable host memory, ...)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def time_mesh_step(torch, np, state, cfg, tc, batch, what="mesh", reps=5,
                   ledger_steps=2, quick=False):
    """11d (13b, 14a): the single-client step split into phases, median of
    ``reps``, state left untouched, and its host syncs counted; the
    WireLedger over ``ledger_steps`` measured steps.  Each phase's inputs
    are made just before it and dropped after (at phase 13's row the card
    holds no more than one phase's).  ``quick`` (phases 13 and 14, for the
    whole script's time) profiles the step alone, in one call, and leaves
    out local SGD's syncs and its run without deterministic algorithms."""
    from repro_torch.core.compression import flatten_pytree, tree_map
    from repro_torch.core.distributed import tree_add
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (WireLedger, codec_for,
                                          make_train_step)
    codec = codec_for(tc)
    numel = cfg.param_count()
    params = state["params"]
    cres = tree_map(lambda x: x[0], state["client_res"])
    sres = state["server_res"]
    step = make_train_step(cfg, make_debug_mesh(data=1, model=1), tc)
    ms = {"step": median_s(torch, lambda: step(state, batch), reps)}
    syncs = count_syncs(torch, lambda: step(state, batch))
    syncs_sgd = None if quick else count_syncs(torch, lambda: mesh_delta(
        torch, cfg, tc, params, batch, slice(0, 4)))
    ms["local_sgd"] = median_s(torch, lambda: mesh_delta(
        torch, cfg, tc, params, batch, slice(0, 4)), reps)
    if not quick:
        ms["local_sgd_not_deterministic"] = median_s(
            torch, lambda: mesh_delta(torch, cfg, tc, params, batch,
                                      slice(0, 4), deterministic=False),
            reps)
    delta = mesh_delta(torch, cfg, tc, params, batch, slice(0, 4))
    carried = tree_add(delta, cres)
    ms["flatten"] = median_s(torch, lambda: flatten_pytree(carried), reps)
    del carried
    ms["tree_encode"] = median_s(torch, lambda: codec.tree_encode(
        delta, cres, numel=numel), reps)
    profiled = {"step": lambda: step(state, batch),
                "local_sgd": lambda: mesh_delta(torch, cfg, tc, params,
                                                batch, slice(0, 4)),
                "tree_encode": lambda: codec.tree_encode(delta, cres,
                                                         numel=numel)}
    for name in ("step",) if quick else ("step", "local_sgd", "tree_encode"):
        # device time of one call by torch.profiler, beside the host clock
        kt = kernel_times(torch, profiled[name], calls=1 if quick else 3) \
            or {}
        dev_ms = sum(kt.values())
        top = sorted(kt.items(), key=lambda kv: -kv[1])[:6]
        print(f"{what} {name}: device {dev_ms:.3f} ms of "
              f"{1e3 * ms[name]:.3f} ms host clock (idle share "
              f"{1 - dev_ms / (1e3 * ms[name]):.3f}); {len(kt)} kernel "
              f"names; longest "
              f"{json.dumps({k: round(v, 4) for k, v in top})}")
        ms[name + "_device"] = dev_ms / 1e3
    del profiled
    msg, _, _ = codec.tree_encode(delta, cres, numel=numel)
    del delta
    ms["tree_reduce"] = median_s(torch, lambda: codec.tree_reduce(
        msg, None, 1), reps)
    ms["tree_decode"] = median_s(torch, lambda: codec.tree_decode(
        msg, sres, numel=numel), reps)
    down, _, _ = codec.tree_decode(msg, sres, numel=numel)
    del msg
    ms["apply"] = median_s(torch, lambda: tree_map(
        lambda p, d: (p.to(torch.float32) + d.to(torch.float32))
        .to(p.dtype), params, down), reps)
    del down
    ms = {k: v * 1e3 for k, v in ms.items()}
    ledger = WireLedger(codec, numel)
    if ledger_steps:
        measured = make_train_step(cfg, make_debug_mesh(data=1, model=1),
                                   dataclasses.replace(tc, measure_wire=True))
        s = state
        ledger_s = []
        for _ in range(ledger_steps):
            s, _, (msgs, gd) = measured(s, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ledger.record_round(msgs, gd)
            ledger_s.append(time.perf_counter() - t0)
        ms[f"wire_ledger_{ledger_steps}_steps"] = 1e3 * sum(ledger_s)
    print(f"{what} step phases (ms, host clock after synchronize, median of "
          f"{reps}): {json.dumps(ms)}; host syncs in a step: {syncs}"
          + (f" ({syncs_sgd} of them in local SGD)" if not quick else "")
          + (f"; WireLedger over {ledger_steps} steps "
             f"{json.dumps(ledger.summary())}" if ledger_steps else ""))
    ms["syncs_per_step"] = syncs
    return ms


def mesh_kernel_rows(torch, rk, row, k, plain_iters=3):
    """The three STC kernels at a mesh path's (1, numel) row: each held
    against its plain version, then device times beside the plain
    versions (``plain_iters`` timed calls), the byte bounds and the
    library calls, whose inputs are made last (at phase 13's row the card
    holds a plain version's temporaries or theirs, not both).  Returns
    ``(keys by kernel, max errors)``."""
    from repro_torch.core.selection import bin_index
    n = row.shape[1]
    tag = f"_1x{n}"
    scale = row_scale(torch, row)
    errs = {"histogram": check_histogram(torch, rk, row, scale),
            "bin_select": check_bin_select(torch, rk, row, k)}
    t, c, s = rk.hist_topk_threshold_batched(row, k)
    mu = s / torch.clamp(c, min=1).to(torch.float32)
    got = rk.stc_apply_batched(row, t, mu)
    want = rk.stc_apply_plain(row, t, mu)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"stc_apply differs from its plain version at (1, {n})")
    errs["stc_apply"] = 0.0
    del got, want
    s_in, b, r, cnt_b = select_inputs(torch, row, k)

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    kernels = {
        "histogram": (lambda: rk.magnitude_histogram_batched(row, scale),
                      lambda: rk.magnitude_histogram_plain(row, scale),
                      4 * n + 4 + 8 * 256),
        "bin_select": (lambda: rk.candidate_select_batched(row, s_in, b, r),
                       lambda: rk.candidate_select_plain(row, s_in, b, r),
                       4 * n + 20 + 12),
        "stc_apply": (lambda: rk.stc_apply_batched(row, t, mu),
                      lambda: rk.stc_apply_plain(row, t, mu),
                      3 * 4 * n + 8)}
    out = {}
    for name, (kernel, plain, nbytes) in kernels.items():
        out[name] = {
            "ms" + tag: event_ms(torch, kernel, iters=20),
            "plain_ms" + tag: event_ms(torch, plain, iters=plain_iters,
                                       hold_stream=False,
                                       warm=plain_iters > 1),
            "bound_ms" + tag: bound(nbytes),
            "library_ms" + tag: None}
    a = row.abs()
    bins = bin_index(a, scale[:, None], 256).to(torch.int64).reshape(-1)
    out["histogram"]["library_ms" + tag] = event_ms(
        torch, lambda: (torch.bincount(bins, minlength=256),
                        torch.bincount(bins, weights=a.reshape(-1),
                                       minlength=256)),
        iters=plain_iters, hold_stream=False)
    del bins
    out["bin_select"]["library_ms" + tag] = event_ms(
        torch, lambda: torch.topk(a, k, dim=1), iters=plain_iters,
        hold_stream=False)
    del a
    out["bin_select"]["cnt_b" + tag] = int(cnt_b[0])
    # the two-read route's floor: two reads of x
    out["bin_select"]["floor_ms" + tag] = 2 * bound(4 * n + 20 + 12)
    for key, val in select_structure(torch, rk, row, s_in, b, r,
                                     full_reads=2).items():
        out["bin_select"][key + tag] = val
    print(f"mesh kernels at (1, {n}), k = {k} (candidate bin holds "
          f"{int(cnt_b[0])}): {json.dumps(out)}")
    return out, errs


def run_mesh(torch, np, rk):
    """Phase 11: the mesh trainer on the card at SmolLM-135M's full width
    (``MESH_LAYERS`` layers).  Returns ``(launches by path, keys by kernel for the
    kernels line, max errors, the trained parameters)``."""
    t0 = time.perf_counter()
    cfg, tc, batch = mesh_setup(torch, np)
    numel = cfg.param_count()
    k = max(int(numel * tc.sparsity_up), 1)
    require(numel == MESH_NUMEL and k == MESH_K,
            f"SmolLM-135M at {MESH_LAYERS} layers has {numel} parameters, "
            f"k = {k}")
    state, launches = mesh_single(torch, np, rk, cfg, tc, batch, MESH_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    row, _ = mesh_lockstep(torch, np, rk, state, cfg, tc, batch)
    extra, errs = mesh_kernel_rows(torch, rk, row.contiguous(), k)
    del row
    ms = time_mesh_step(torch, np, state, cfg, tc, batch)
    dryrun_flops_check(torch, cfg, tc, batch, state, ms["step"])
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    mesh_two_ranks(torch, np)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s (peak memory of "
          f"the 10 single-client steps {peak:.3f} GiB)")
    print(f"card: {card_line()}")
    return {"mesh": launches}, extra, errs, params


# ---------------------------------------------------------------- phase 12

SERVE_PROMPT = 64               # decode against forward, card against CPU
SERVE_GREEDY = 32
SERVE_BATCH = 2
CARD_CPU_TOL = {"rtol": 1e-4, "atol": 1e-4}
DECODE_FORWARD_TOL = {"rtol": 5e-3, "atol": 2e-3}   # tests/test_models.py
RING = (64, 256, 200)           # window, s_cache, teacher-forced tokens
BF16_PREFILL = (4, 512)
BF16_TOL = 0.05                 # of the largest logit
PREFILL = (1, 32_768)           # prefill_32k's length; batch 32 cut to 1
DECODE = (64, 32_768)           # decode_32k's cache; batch 128 cut to 64
DECODE_WARM, DECODE_TIMED = 8, 16
SERVE_DIR = ROOT / "build" / "serve"


def serve_tokens(torch, np, cfg, shape, seed):
    from repro_torch.data import make_lm_tokens
    n = math.prod(shape)
    toks = make_lm_tokens(seed=seed, n_tokens=n, vocab=cfg.vocab_size)
    return torch.from_numpy(toks.reshape(shape).astype(np.int64))


def serve_checkpoint(torch, params):
    """12.1: the weights to serve through ``save_checkpoint`` ->
    ``restore_checkpoint``; every leaf must come back bitwise."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.compression import tree_leaves
    path = SERVE_DIR / "params.ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(path), params)
    t1 = time.perf_counter()
    back = restore_checkpoint(str(path), params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    leaves, got = tree_leaves(params), tree_leaves(back)
    require(len(leaves) == len(got) and all(
        g.device == w.device and g.dtype == w.dtype == torch.float32 and
        torch.equal(g.view(torch.int32), w.view(torch.int32))
        for g, w in zip(got, leaves)),
        "restore_checkpoint did not give the fp32 leaves back bitwise")
    size = path.stat().st_size
    print(f"serve checkpoint: {len(leaves)} leaves, "
          f"{sum(x.numel() for x in leaves)} parameters; file {size} bytes; "
          f"save {t1 - t0:.2f} s, restore {t2 - t1:.2f} s; leaves bitwise")
    path.unlink()
    return back


def serve_fp32_checks(torch, np, cfg, params, cpu_steps=SERVE_PROMPT,
                      greedy=SERVE_GREEDY, what="serve",
                      fwd_tol=DECODE_FORWARD_TOL, cpu_params=None):
    """12.2 and 12.3 (13c, 14): a 64-token prompt teacher-forced through
    ``make_decode_step`` at fp32 on the card, each step's logits against
    ``forward``'s within ``fwd_tol``; the first ``cpu_steps`` of them on
    the CPU; then ``greedy`` greedy steps on the card, and the CPU decoding
    the card's tokens.  An encoder-decoder's forward takes stand-in
    ``frames``, and its decode on each device the memory that
    ``encode_frames`` makes of them there (a VLM's decode takes no prefix,
    so neither does its forward here)."""
    from repro_torch.configs import stand_in_inputs
    from repro_torch.core.compression import tree_map
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import encode_frames, forward, init_cache
    mesh = make_debug_mesh(data=1, model=1)
    toks = serve_tokens(torch, np, cfg, (SERVE_BATCH, SERVE_PROMPT), seed=1)
    steps = SERVE_PROMPT + SERVE_GREEDY
    if cpu_params is None:
        cpu_params = tree_map(lambda t: t.cpu(), params)
    frames = stand_in_inputs(cfg, SERVE_BATCH, scale=ZOO_EXTRA_SCALE,
                             seed=1).get("frames")
    mem_card = mem_cpu = None
    with torch.inference_mode():
        if frames is not None:
            mem_card = encode_frames(params, cfg, frames.cuda())
            mem_cpu = encode_frames(cpu_params, cfg, frames)
            frames = frames.cuda()
        full, _ = forward(params, cfg, toks.cuda(), frames=frames,
                          compute_dtype=torch.float32)
    dec_card = make_decode_step(cfg, mesh, torch.float32, device="cuda")
    dec_cpu = make_decode_step(cfg, mesh, torch.float32, device="cpu")
    c_card = init_cache(cfg, SERVE_BATCH, steps, torch.float32, device="cuda")
    c_cpu = init_cache(cfg, SERVE_BATCH, steps, torch.float32, device="cpu")
    fwd_gap = card_cpu_gap = 0.0
    for t in range(SERVE_PROMPT):
        tok = toks[:, t:t + 1]
        lg, c_card = dec_card(params, tok.cuda(), c_card, memory=mem_card)
        lg = lg[:, 0].cpu()
        want = full[:, t].cpu()
        fwd_gap = max(fwd_gap, float((lg - want).abs().max()))
        require(torch.allclose(lg, want, **fwd_tol),
                f"decode step {t} differs from forward on the card by "
                f"{float((lg - want).abs().max())}")
        if t >= cpu_steps:
            continue
        lc, c_cpu = dec_cpu(cpu_params, tok, c_cpu, memory=mem_cpu)
        lc = lc[:, 0]
        card_cpu_gap = max(card_cpu_gap, float((lg - lc).abs().max()))
        require(torch.allclose(lg, lc, **CARD_CPU_TOL),
                f"decode step {t}: card and CPU differ by "
                f"{float((lg - lc).abs().max())}")
    print(f"{what} fp32, batch {SERVE_BATCH}, {SERVE_PROMPT}-token prompt: "
          f"decode against forward on the card max |gap| {fwd_gap:.3e} "
          f"(tolerance {fwd_tol}); card against CPU over "
          f"{min(cpu_steps, SERVE_PROMPT)} steps max |gap| "
          f"{card_cpu_gap:.3e} (tolerance {CARD_CPU_TOL})")
    if not greedy:
        return {"decode_vs_forward": fwd_gap, "card_vs_cpu": card_cpu_gap}
    same = checked = 0
    greedy_gap = 0.0
    tok = lg.argmax(dim=-1, keepdim=True)
    for _ in range(greedy):
        lg, c_card = dec_card(params, tok.cuda(), c_card, memory=mem_card)
        lc, c_cpu = dec_cpu(cpu_params, tok, c_cpu, memory=mem_cpu)
        lg, lc = lg[:, 0].cpu(), lc[:, 0]
        greedy_gap = max(greedy_gap, float((lg - lc).abs().max()))
        require(torch.allclose(lg, lc, **CARD_CPU_TOL),
                f"greedy decode: card and CPU differ by "
                f"{float((lg - lc).abs().max())}")
        # each logit may move by the tolerance: a top-2 gap above twice it
        # cannot change order between the card and the CPU
        top2 = lg.topk(2, dim=-1).values
        tol = CARD_CPU_TOL["atol"] + CARD_CPU_TOL["rtol"] * top2[:, 0].abs()
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        tok = lg.argmax(dim=-1, keepdim=True)
        agree = tok[:, 0] == lc.argmax(dim=-1)
        require(bool(agree[clear].all()),
                "greedy decode: card and CPU chose other tokens where the "
                "top-2 gap exceeds the tolerance")
        checked += int(clear.sum())
        same += int(agree.sum())
    print(f"{what} greedy, {greedy} steps: card and CPU logits max "
          f"|gap| {greedy_gap:.3e}; tokens equal {same} of "
          f"{greedy * SERVE_BATCH} ({checked} with a top-2 gap above "
          f"twice the tolerance, all of them equal)")
    return {"decode_vs_forward": fwd_gap, "card_vs_cpu": max(
        card_cpu_gap, greedy_gap)}


def serve_ring_check(torch, np, cfg, params):
    """12.4: sliding window 64 at full width, ``s_cache`` 256 (rings of
    64), 200 teacher-forced tokens (the ring wraps three times) against the
    windowed ``forward`` at fp32."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import forward, init_cache
    window, s_cache, n = RING
    cfg_w = dataclasses.replace(cfg, sliding_window=window)
    toks = serve_tokens(torch, np, cfg, (SERVE_BATCH, n), seed=2).cuda()
    with torch.inference_mode():
        full, _ = forward(params, cfg_w, toks, compute_dtype=torch.float32)
    caches = init_cache(cfg_w, SERVE_BATCH, s_cache, torch.float32)
    require(all(c.ring and c.k.shape[1] == window for c in caches),
            f"init_cache gave no rings of {window}")
    dec = make_decode_step(cfg_w, make_debug_mesh(data=1, model=1),
                           torch.float32)
    gap = 0.0
    for t in range(n):
        lg, caches = dec(params, toks[:, t:t + 1], caches)
        d = (lg[:, 0] - full[:, t]).abs().max()
        gap = max(gap, float(d))
        require(torch.allclose(lg[:, 0], full[:, t], **DECODE_FORWARD_TOL),
                f"ring decode step {t} differs from the windowed forward by "
                f"{float(d)}")
    print(f"serve ring: window {window}, s_cache {s_cache}, {n} tokens "
          f"(the ring wrapped {-(-n // window) - 1} times): max |gap| to the "
          f"windowed forward {gap:.3e}")
    return gap


def serve_bf16_check(torch, np, cfg, params, what="serve", seeds=(3,),
                     shape=BF16_PREFILL):
    """12.5 (13c, 14): ``make_prefill_step`` at (4, 512) (or ``shape``)
    in bf16 against
    the last logits of a bf16 teacher-forced decode over the same prompt
    (an encoder-decoder's with stand-in ``frames``, its decode against
    their bf16 memory); with more prompt seeds, their 4-row prompts go as
    one batch and are held each on its own.  Each of the two bf16 paths
    is also held against the fp32 prefill of the same weights and prompt,
    the witness of which path holds the gap."""
    from repro_torch.configs import stand_in_inputs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import encode_frames, init_cache
    b, s = shape
    mesh = make_debug_mesh(data=1, model=1)
    toks = torch.cat([serve_tokens(torch, np, cfg, (b, s), seed=seed)
                      for seed in seeds]).cuda()
    batch = {"tokens": toks}
    memory = None
    if cfg.encoder is not None:
        batch["frames"] = torch.cat([stand_in_inputs(
            cfg, b, scale=ZOO_EXTRA_SCALE, seed=seed)["frames"]
            for seed in seeds]).cuda()
        with torch.inference_mode():
            memory = encode_frames(params, cfg,
                                   batch["frames"].to(torch.bfloat16))
    pre = make_prefill_step(cfg, mesh)(params, batch)[:, 0].float()
    ref = make_prefill_step(cfg, mesh, torch.float32)(params, batch)[:, 0]
    dec = make_decode_step(cfg, mesh)
    caches = init_cache(cfg, b * len(seeds), s)
    for t in range(s):
        lg, caches = dec(params, toks[:, t:t + 1], caches, memory=memory)
    lg = lg[:, 0].float()
    del caches
    worst = 0.0
    for i, seed in enumerate(seeds):
        rows = slice(i * b, (i + 1) * b)
        gap = float((lg[rows] - pre[rows]).abs().max())
        top = float(pre[rows].abs().max())
        top_ref = float(ref[rows].abs().max())
        pre_ref = float((pre[rows] - ref[rows]).abs().max())
        dec_ref = float((lg[rows] - ref[rows]).abs().max())
        same = int((lg[rows].argmax(-1) == pre[rows].argmax(-1)).sum())
        print(f"{what} bf16, prompt seed {seed}: prefill ({b}, {s}) "
              f"against {s} teacher-forced decode steps (batch "
              f"{b * len(seeds)}): last logits max |gap| {gap:.4f} of max "
              f"|logit| {top:.4f}, {gap / top:.4f} of it (tolerance "
              f"{BF16_TOL}); argmax equal in {same} of {b} rows; against "
              f"the fp32 prefill (max |logit| {top_ref:.4f}): bf16 prefill "
              f"{pre_ref:.4f} ({pre_ref / top_ref:.4f} of it), bf16 decode "
              f"{dec_ref:.4f} ({dec_ref / top_ref:.4f})")
        require(gap <= BF16_TOL * top, f"bf16 prefill and decode differ by "
                f"{gap} > {BF16_TOL} x {top} (prompt seed {seed})")
        worst = max(worst, gap)
    return worst


def time_prefill(torch, np, cfg, params, what="serve", shape=PREFILL):
    """12.6a (13c, 14): one ``shape[1]``-token prompt (32,768 unless
    given) through ``make_prefill_step``, with the arch's stand-in
    ``frames`` or ``prefix``."""
    from repro_torch.configs import stand_in_inputs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_prefill_step
    b, s = shape
    toks = serve_tokens(torch, np, cfg, (b, s), seed=4).cuda()
    extra = stand_in_inputs(cfg, b, kind="prefill", scale=ZOO_EXTRA_SCALE,
                            seed=4)
    batch = {"tokens": toks, **{k: v.cuda() for k, v in extra.items()}}
    prefill = make_prefill_step(cfg, make_debug_mesh(data=1, model=1))
    torch.cuda.reset_peak_memory_stats()
    out = prefill(params, batch)
    require(tuple(out.shape) == (b, 1, cfg.vocab_size) and
            bool(torch.isfinite(out).all()), "prefill logits not finite")
    ms = 1e3 * median_s(torch, lambda: prefill(params, batch), reps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with_ = "".join(f" + {k} {tuple(v.shape)}" for k, v in extra.items())
    print(f"{what} prefill ({b}, {s}){with_} bf16: {ms:.1f} ms (median of "
          f"3), {b * s / ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} GiB; "
          f"card: {card_line()}")
    return ms


def time_decode(torch, np, cfg, params, shape=DECODE, syncs=0,
                what="serve"):
    """12.6b (13c): batch ``shape[0]`` against a ``shape[1]``-slot bf16
    cache filled with seeded random values, ``idx`` at the last slot - 24:
    8 warm-up steps (one under ``set_sync_debug_mode``: none with
    ``syncs`` 0, else exactly ``syncs`` host syncs, one a MoE layer; one
    under ``torch.profiler``), then 16 timed steps, each feeding back its
    argmax.  The bound reads the cache and the weights once: all of them
    but an untied embedding table, of which the step reads its batch's
    rows (with 64 experts and top-6, batch 128 routes to every expert of a
    layer but with probability ~1e-5); an SSD or RG-LRU layer's state and
    conv tail are also written back whole, so the bound counts them
    twice.  An encoder-decoder decodes against the bf16 memory that
    ``encode_frames`` makes of stand-in frames for the batch (timed once):
    the bound reads it as well, and is at least the time its
    cross-attention K and V projections take at the bf16 peak, since every
    step repeats them in every layer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import stand_in_inputs
    from repro_torch.core.compression import tree_leaves
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import encode_frames, init_cache
    from repro_torch.models.rglru import RGLRUCache
    from repro_torch.models.ssm import SSMCache
    b, s = shape
    memory, memory_bytes, cross_flops, enc_note = None, 0, 0, ""
    if cfg.encoder is not None:
        frames = stand_in_inputs(cfg, b, scale=ZOO_EXTRA_SCALE,
                                 seed=6)["frames"].cuda().to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            memory = encode_frames(params, cfg, frames)
        torch.cuda.synchronize()
        enc_ms = 1e3 * (time.perf_counter() - t0)
        del frames
        memory_bytes = memory.numel() * memory.element_size()
        kv = cfg.n_heads * cfg.resolved_head_dim
        cross_flops = 2 * 2 * memory.shape[0] * memory.shape[1] * \
            cfg.d_model * kv * cfg.n_layers
        enc_note = (f"; encode_frames {tuple(memory.shape)} bf16 "
                    f"{enc_ms:.1f} ms (one call); cross-attention K, V "
                    f"projections {cross_flops / 1e12:.2f} TFLOP a step, "
                    f"{cross_flops / BF16_FLOP_PER_S * 1e3:.2f} ms at the "
                    f"bf16 peak")
    torch.cuda.reset_peak_memory_stats()
    caches = init_cache(cfg, b, s)
    gen = torch.Generator(device="cuda").manual_seed(5)
    start = torch.tensor(s - DECODE_WARM - DECODE_TIMED, dtype=torch.int32,
                         device="cuda")
    buffers, rewritten = [], []
    for i, c in enumerate(caches):
        for field, buf in zip(c._fields, c):
            if field not in ("idx", "ring"):
                buf.normal_(generator=gen)
                buffers.append(buf)
                if isinstance(c, (SSMCache, RGLRUCache)):
                    rewritten.append(buf)
        caches[i] = c._replace(idx=start.clone())
    cache_bytes = sum(x.numel() * x.element_size() for x in buffers)
    written_bytes = sum(x.numel() * x.element_size() for x in rewritten)
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    if "lm_head" in params:
        emb = params["embed"]
        weight_bytes -= (emb.shape[0] - b) * emb.shape[1] * emb.element_size()
    dec = make_decode_step(cfg, make_debug_mesh(data=1, model=1))
    tok = serve_tokens(torch, np, cfg, (b, 1), seed=6).cuda()
    state = {"tok": tok, "caches": caches}

    def step():
        lg, state["caches"] = dec(params, state["tok"], state["caches"],
                                  memory=memory)
        state["tok"] = lg.argmax(dim=-1)

    for _ in range(DECODE_WARM - 2):
        step()
    torch.cuda.synchronize()
    if syncs:
        got = count_syncs(torch, step)
        require(got == syncs, f"{what} decode step made {got} host syncs, "
                f"not {syncs} (one a MoE layer)")
        sync_note = f"{got} host syncs in a step (one a MoE layer)"
    else:
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync_note = "no host sync in a step (set_sync_debug_mode('error'))"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    dev_ms = sum(times.values())
    require(dev_ms > 0, "the profiler saw no device time in a decode step")
    step_s = []
    for _ in range(DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(step_s)
    require(all(int(c.idx) == s for c in state["caches"]),
            "the caches' idx did not reach the last slot")
    require(bool(torch.isfinite(state["caches"][0][0][:, -1]).all()),
            "decode wrote non-finite cache values")
    bound_cache = (cache_bytes + written_bytes) / HBM_BYTES_PER_S * 1e3
    bound = max((cache_bytes + written_bytes + weight_bytes + memory_bytes)
                / HBM_BYTES_PER_S * 1e3,
                cross_flops / BF16_FLOP_PER_S * 1e3)
    top = [(name[:90], round(t, 3)) for name, t in
           sorted(times.items(), key=lambda kv: -kv[1])[:6]]
    print(f"{what} decode, batch {b}, {s}-slot bf16 cache "
          f"({cache_bytes / 1e9:.2f} GB): {ms:.2f} ms a step (median of "
          f"{DECODE_TIMED}; steps {json.dumps([round(x * 1e3, 2) for x in step_s])}), "
          f"{b / ms * 1e3:.0f} tokens/s; bound {bound:.2f} ms (the cache "
          f"alone {bound_cache:.2f} ms, {written_bytes / 1e9:.2f} GB of it "
          f"written back; + fp32 weights {weight_bytes / 1e9:.3f} GB"
          f"{f' + memory {memory_bytes / 1e9:.3f} GB' if memory_bytes else ''}"
          f"), {ms / bound:.1f}x it; {sync_note}{enc_note}; card: "
          f"{card_line()}")
    print(f"{what} decode step by torch.profiler: device {dev_ms:.2f} ms of "
          f"{ms:.2f} ms (idle share {max(0.0, 1 - dev_ms / ms):.3f}); "
          f"{len(times)} device operation names; longest "
          f"{json.dumps(top)}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"ms": ms, "bound_ms": bound, "device_ms": dev_ms}


def run_serve(torch, np, rk, params=None):
    """Phase 12: the LM's serve path on the card at SmolLM-135M's full
    width (``MESH_LAYERS`` layers), serving ``params`` (phase 11's trained weights in the
    whole run; alone, ``init_model(CONFIG, 0)``).  Returns the serve
    path's launch counts (none of the port's kernels)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    t0 = time.perf_counter()
    cfg = mesh_config()
    require(cfg.param_count() == MESH_NUMEL,
            f"SmolLM-135M at {MESH_LAYERS} layers has {cfg.param_count()} "
            f"parameters")
    source = "phase 11's trained weights"
    if params is None:
        params = init_model(cfg, 0, "cuda")
        source = "init_model(CONFIG, 0)"
    rk.LAUNCHES.reset()
    params = serve_checkpoint(torch, params)
    serve_fp32_checks(torch, np, cfg, params)
    serve_ring_check(torch, np, cfg, params)
    serve_bf16_check(torch, np, cfg, params)
    torch.cuda.empty_cache()
    time_prefill(torch, np, cfg, params)
    torch.cuda.empty_cache()
    time_decode(torch, np, cfg, params)
    launches = dict(rk.LAUNCHES.counts)
    ran = {n: c for n, c in launches.items() if c}
    require(not ran, f"the serve path launched the port's kernels: {ran}")
    torch.cuda.empty_cache()
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s, serving "
          f"{source}; the port's kernels launched on the serve path: none; "
          f"card: {card_line()}")
    return {"serve": launches}


# --------------------------------------------------------------- phase 13

MOE_ARCH = "deepseek-v2-lite-16b"
MOE_LAYERS = 3          # cut from 27: the dense first layer and two MoE ones
MOE_NUMEL = 1_670_133_760
MOE_K = 33_402_675      # int(MOE_NUMEL / 50)
MOE_STEPS = 5
MOE_BLOCK_X = (2, 128)
MOE_BLOCK_TOL = 1e-4    # card against CPU, of the largest magnitude
MOE_TIE_GAP = 1e-6      # 6th against 7th router probability
MOE_DISPATCH_TOL = 3e-5  # ragged against capacity: tests/test_moe_dispatch.py
MOE_CPU_STEPS = 8       # decode steps card against CPU (16 until the
                        # script needed room for phase 16)
MOE_DECODE = (128, 32_768)   # decode_32k's batch and cache length
MOE_SMOKE = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
MOE_SMOKE_SHAPE = (2, 32)
MOE_SMOKE_DECODE = 8


def moe_setup(torch, np):
    """DeepSeek-V2-Lite at full width (d 2,048, 16 heads, MLA kv_lora 512,
    qk 128 + 64, v 128; 64 experts, top-6, d_expert 1,408, 2 shared; the
    first layer dense at d_ff 10,944; vocab 102,400, untied), depth cut
    to 3 layers, phase 11's STC setting and a 4 x 128 batch of
    ``make_lm_tokens(seed=0)``: ``(cfg, tc, batch)``."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch.train import TrainConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    toks = make_lm_tokens(seed=0, n_tokens=4 * 128 + 1, vocab=cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:-1].reshape(4, 128)),
             "labels": torch.from_numpy(toks[1:].reshape(4, 128))}
    return cfg, TrainConfig(**MESH_TC), batch


def moe_block_check(torch, np, cfg):
    """13a: one MoE FFN at full width on a (2, 128) fp32 input, card
    against CPU: the experts chosen equal wherever the 6th and 7th router
    probabilities are more than 1e-6 apart, outputs (of those tokens) and
    the aux loss within 1e-4 of the largest magnitude; on the card the
    ragged dispatch against the capacity dispatch at capacity factor 8
    (no drop) within 3e-5."""
    from repro_torch.core.compression import tree_map
    from repro_torch.models import moe
    mcfg, d, k = cfg.moe, cfg.d_model, cfg.moe.top_k
    p_cpu = moe.moe_init(torch.Generator().manual_seed(0), d, mcfg,
                         cfg.mlp_act)
    p_card = tree_map(lambda t: t.cuda(), p_cpu)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        MOE_BLOCK_X + (d,)).astype(np.float32))
    big = dataclasses.replace(mcfg, dispatch="capacity", capacity_factor=8.0)
    with torch.no_grad():
        out_c, aux_c = moe.moe_apply(p_cpu, x, mcfg, cfg.mlp_act)
        out_g, aux_g = moe.moe_apply(p_card, x.cuda(), mcfg, cfg.mlp_act)
        out_cap, aux_cap = moe.moe_apply(p_card, x.cuda(), big, cfg.mlp_act)
        probs, _, idx_c = moe.route(p_cpu, x.reshape(-1, d), mcfg)
        _, _, idx_g = moe.route(p_card, x.cuda().reshape(-1, d), mcfg)
    top = probs.sort(dim=-1, descending=True).values
    clear = (top[:, k - 1] - top[:, k]) > MOE_TIE_GAP
    require(torch.equal(idx_g.cpu()[clear], idx_c[clear]),
            "the card's router chose other experts than the CPU's")
    out_g, out_c = out_g.cpu().reshape(-1, d), out_c.reshape(-1, d)
    err = float((out_g - out_c)[clear].abs().max())
    scale = float(out_c.abs().max())
    aux_err = abs(float(aux_g) - float(aux_c))
    disp = float((out_cap.cpu().reshape(-1, d) - out_g).abs().max())
    print(f"moe block at full width ({mcfg.n_experts} experts, top-{k}, "
          f"d_expert {mcfg.d_expert}, {mcfg.n_shared} shared) on "
          f"{MOE_BLOCK_X} fp32: {int(clear.sum())} of {clear.numel()} tokens "
          f"clear of a 1e-6 router tie, experts equal there; card against "
          f"CPU max |out gap| {err:.3e} of max |out| {scale:.3e}, aux "
          f"{float(aux_g)!r} against {float(aux_c)!r}; ragged against "
          f"capacity (factor 8) max |gap| {disp:.3e}, aux "
          f"{float(aux_cap)!r}")
    require(err <= MOE_BLOCK_TOL * scale, f"MoE block card against CPU "
            f"{err} > {MOE_BLOCK_TOL} x {scale}")
    require(aux_err <= MOE_BLOCK_TOL * abs(float(aux_c)),
            f"MoE aux loss card {float(aux_g)} against CPU {float(aux_c)}")
    require(disp <= MOE_DISPATCH_TOL, f"ragged and capacity dispatch differ "
            f"by {disp} on the card")
    require(abs(float(aux_cap) - float(aux_g)) <= 1e-5 * abs(float(aux_g)),
            "the capacity dispatch's aux loss differs from the ragged one's")
    return {"card_vs_cpu": err, "dispatch": disp}


def moe_rerun_check(torch, cfg, tc, state, batch, what="moe"):
    """13b (14): two local SGD runs from the same state under the trainer's
    deterministic algorithms give bitwise equal gradients, and the mode
    warns of no operation."""
    import warnings
    from repro_torch.core.compression import tree_leaves
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one = mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4))
        two = mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4))
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(one),
                                                 tree_leaves(two)))
    alerts = sorted({str(w.message)[:160] for w in caught
                     if "determinis" in str(w.message).lower()})
    print(f"{what} reruns: two local SGD runs from one state bitwise equal: "
          f"{same}; deterministic-mode warnings {alerts}; "
          f"{len(caught)} warnings in all")
    require(same, "two local SGD runs from the same state differ")
    require(not alerts, f"the deterministic mode warned: {alerts}")


def smoke_archs(torch, np, archs=MOE_SMOKE, what="moe"):
    """13d (14c): archs at their smoke configs, card against CPU at fp32
    (``granite-moe-3b-a800m`` and ``moonshot-v1-16b-a3b``; ``whisper-medium``
    with stub audio ``frames``, ``internvl2-2b`` with a patch ``prefix``):
    one forward (logits within 1e-4 of the largest, aux loss within rtol
    1e-4), one train step with the dense ``baseline`` codec (the loss
    within rtol 1e-4, the update within 1e-4 of its largest magnitude; STC
    at this size keeps or drops near-ties that ulps decide) and 8 decode
    steps (logits within rtol 1e-4 / atol 1e-4; whisper against the memory
    of ``encode_frames`` on each device)."""
    from repro_torch.configs import get_smoke_config, stand_in_inputs
    from repro_torch.core.compression import flatten_pytree, tree_map
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.models import (encode_frames, forward, init_cache,
                                    init_model)
    mesh = make_debug_mesh(data=1, model=1)
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        p_cpu = init_model(cfg, 0)
        p_card = tree_map(lambda t: t.cuda(), p_cpu)
        toks = serve_tokens(torch, np, cfg, MOE_SMOKE_SHAPE, seed=7)
        extra = stand_in_inputs(cfg, MOE_SMOKE_SHAPE[0],
                                scale=ZOO_EXTRA_SCALE, seed=8)
        extra_card = {k: v.cuda() for k, v in extra.items()}
        with torch.no_grad():
            lg_c, aux_c = forward(p_cpu, cfg, toks,
                                  compute_dtype=torch.float32, **extra)
            lg_g, aux_g = forward(p_card, cfg, toks.cuda(),
                                  compute_dtype=torch.float32, **extra_card)
            memory = {"card": None, "host": None}
            if cfg.encoder is not None:
                memory = {"card": encode_frames(p_card, cfg,
                                                extra_card["frames"]),
                          "host": encode_frames(p_cpu, cfg, extra["frames"])}
        fwd = float((lg_g.cpu() - lg_c).abs().max())
        require(fwd <= 1e-4 * float(lg_c.abs().max()) and
                abs(float(aux_g) - float(aux_c)) <= 1e-4 * float(aux_c),
                f"{arch}: forward card against CPU {fwd}, aux "
                f"{float(aux_g)} against {float(aux_c)}")
        tc = TrainConfig(protocol="baseline", lr=0.05,
                         compute_dtype=torch.float32)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
                 **extra}
        devices = {"card": "cuda", "host": "cpu"}
        runs = {}
        for where, dev in devices.items():
            state = init_train_state(cfg, tc, 1, device=dev,
                                     params=tree_map(lambda t: t.clone(),
                                                     p_cpu))
            new, m = make_train_step(cfg, mesh, tc, device=dev)(state, batch)
            runs[where] = (float(m["loss"]), flatten_pytree(
                new["params"])[0].cpu() - flatten_pytree(p_cpu)[0])
        (loss_g, upd_g), (loss_c, upd_c) = runs["card"], runs["host"]
        upd = float((upd_g - upd_c).abs().max())
        require(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) and
                upd <= 1e-4 * float(upd_c.abs().max()),
                f"{arch}: train step card against CPU: loss {loss_g} "
                f"against {loss_c}, update gap {upd}")
        dec = {where: make_decode_step(cfg, mesh, torch.float32, device=dev)
               for where, dev in devices.items()}
        caches = {where: init_cache(cfg, 2, MOE_SMOKE_DECODE, torch.float32,
                                    device=dev)
                  for where, dev in devices.items()}
        gap = 0.0
        for t in range(MOE_SMOKE_DECODE):
            tok = toks[:, t:t + 1]
            lg, caches["card"] = dec["card"](p_card, tok.cuda(),
                                             caches["card"],
                                             memory=memory["card"])
            lc, caches["host"] = dec["host"](p_cpu, tok, caches["host"],
                                             memory=memory["host"])
            gap = max(gap, float((lg.cpu() - lc).abs().max()))
            require(torch.allclose(lg.cpu(), lc, **CARD_CPU_TOL),
                    f"{arch}: decode step {t} card against CPU "
                    f"{float((lg.cpu() - lc).abs().max())}")
        out[arch] = {"forward": fwd, "train_loss": loss_g,
                     "update_gap": upd, "decode": gap}
    print(f"{what} smoke archs card against CPU at fp32 (max |gap|): "
          f"{json.dumps(out)}")
    return out


def run_moe(torch, np, rk):
    """Phase 13: the MoE family on the card, DeepSeek-V2-Lite at full
    width and 3 layers through the mesh trainer and the serve path, then
    the other two MoE archs at their smoke configs.  Returns ``(launches
    by path, keys by kernel for the kernels line, max errors)``."""
    from repro_torch.core.compression import flatten_pytree, tree_map
    from repro_torch.core.distributed import tree_add
    t0 = time.perf_counter()
    cfg, tc, batch = moe_setup(torch, np)
    numel = cfg.param_count()
    k = max(int(numel * tc.sparsity_up), 1)
    require(numel == MOE_NUMEL and k == MOE_K,
            f"{cfg.name} at {MOE_LAYERS} layers has {numel} parameters, "
            f"k = {k}")
    moe_layers = sum(i >= cfg.moe.first_dense for i in range(cfg.n_layers))
    moe_block_check(torch, np, cfg)
    state, launches = mesh_single(torch, np, rk, cfg, tc, batch, MOE_STEPS,
                                  what="moe")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moe_rerun_check(torch, cfg, tc, state, batch)
    time_mesh_step(torch, np, state, cfg, tc, batch, what="moe", reps=1,
                   ledger_steps=0, quick=True)
    # the kernels at the trainer's row, on the carried row of the next
    # encode; the parameters wait on the host meanwhile, so that the plain
    # versions' temporaries fit
    delta = mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4))
    row = flatten_pytree(tree_add(delta, tree_map(
        lambda x: x[0], state["client_res"])))[0][None]
    params = tree_map(lambda t: t.cpu(), state["params"])
    del delta, state
    torch.cuda.empty_cache()
    extra, errs = mesh_kernel_rows(torch, rk, row, k, plain_iters=1)
    del row
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.cuda(), params)
    t_serve = time.perf_counter()
    rk.LAUNCHES.reset()
    serve_fp32_checks(torch, np, cfg, params, cpu_steps=MOE_CPU_STEPS,
                      greedy=0, what="moe serve")
    serve_bf16_check(torch, np, cfg, params, what="moe serve")
    torch.cuda.empty_cache()
    time_prefill(torch, np, cfg, params, what="moe serve")
    torch.cuda.empty_cache()
    time_decode(torch, np, cfg, params, shape=MOE_DECODE, syncs=moe_layers,
                what="moe serve")
    ran = {n: c for n, c in rk.LAUNCHES.counts.items() if c}
    require(not ran, f"the serve path launched the port's kernels: {ran}")
    del params
    torch.cuda.empty_cache()
    t_smoke = time.perf_counter()
    smoke_archs(torch, np)
    torch.cuda.empty_cache()
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s (serve "
          f"{t_smoke - t_serve:.1f} s, smoke archs "
          f"{time.perf_counter() - t_smoke:.1f} s; peak memory of the "
          f"{MOE_STEPS} trainer steps {peak:.3f} GiB); card: {card_line()}")
    return {"moe": launches}, extra, errs


# --------------------------------------------------------------- phase 14

# Each arch's depth is cut for the script's time: at 48 / 12 / 24 + 24 /
# 20 layers phase 14 took 307-387 s, and the whole script up to 1,205 s of
# its 1,200 s limit on a slow host; at 24 / 6 / 12 + 12 / 12 it took 202.6
# s of a 1,113 s script once phase 16 ran three archs.  Every check still
# runs on each arch.
ZOO_SSM = "mamba2-370m"
ZOO_SSM_LAYERS = 12             # of 48 (368,227,840 parameters)
ZOO_SSM_NUMEL = 130_672_768
ZOO_SSM_K = 2_613_455           # int(ZOO_SSM_NUMEL / 50)
ZOO_HYBRID = "recurrentgemma-2b"
# of 26 layers (2,265,290,240 parameters): two whole (rglru, rglru, local)
# periods; at 26 the trainer would need ~76 GiB (phase 13's 56.2 GiB for
# 1.67 G parameters, scaled), too close to the 80 GB
ZOO_HYBRID_LAYERS = 6
ZOO_HYBRID_NUMEL = 1_025_067_520
ZOO_HYBRID_K = 20_501_350       # int(ZOO_HYBRID_NUMEL / 50)
ZOO_ENC = "whisper-medium"
ZOO_ENC_LAYERS = 6              # encoder and decoder, each of 24
ZOO_ENC_NUMEL = 282_413_056     # (810,987,520 parameters at 24 + 24)
ZOO_ENC_K = 5_648_261           # int(ZOO_ENC_NUMEL / 50)
ZOO_VLM = "internvl2-2b"
# of 24 layers (1,893,341,184 parameters): there the trainer fits (peak
# 63.6 GiB) but the plain bin_select at its (1, 1,893,341,184) row does
# not: its full sort asked for 21.21 GiB beside 58.34 GiB in use
ZOO_VLM_LAYERS = 6
ZOO_VLM_NUMEL = 760_805_376
ZOO_VLM_K = 15_216_107          # int(ZOO_VLM_NUMEL / 50)
ZOO_BATCH = (4, 1024)           # four SSD chunks of 256 a sequence
ZOO_STEPS = 5
ZOO_BLOCK_X = (2, 512)          # two SSD chunks: the recurrence runs
ZOO_BLOCK_TOL = 1e-4            # card against CPU, of the largest magnitude
ZOO_EXTRA_SCALE = 0.1           # stand-in frames and prefix: 0.1 x N(0, 1)
ZOO_FRONT_TOKENS = (1, 32)      # beside the frames / prefix, card vs CPU
SSD_DECODE_TOL = {"rtol": 5e-3, "atol": 5e-3}   # tests/test_models.py, SSD
ZOO_DECODE = (128, 32_768)      # decode_32k's batch and cache length
ZOO_SSM_BF16_SEEDS = (3,)       # one prompt (a second cost 23 s of the
                                # script's limit)
# the attention archs: prefill_32k's prompt cut to 8,192 (the port's flash
# scan ran SmolLM's 32,768-token prefill at ~11 TFLOP/s in phase 12, which
# puts one such prefill at ~10 s for whisper and ~19 s for internvl, and
# the timing makes four); decode_32k's batch 128 against 4,096 slots (24
# layers of K and V 1,024 wide take 12.6 MB a slot: 412 GB at 32,768)
ZOO_ATTN_PREFILL = (1, 8_192)
ZOO_ATTN_DECODE = (128, 4_096)
ZOO_ATTN_CPU_STEPS = 2          # whisper's CPU step re-projects its memory
                                # (4 steps took 38.6 s)
# the attention archs' bf16 prefill-vs-decode prompt: 256 tokens, where
# the SSD needs two chunks of 256; whisper's 512 decode steps took 38 s
ZOO_ATTN_BF16 = (4, 256)
ZOO_STEP_REPS = 1               # step phases: one call each (the run's time)
ZOO_SMOKE = ("whisper-medium", "internvl2-2b")


def zoo_setup(torch, np, arch, layers=None):
    """The arch at full width (depth cut to ``layers`` when given, an
    encoder's too), phase 11's STC setting and a 4 x 1,024 batch of
    ``make_lm_tokens(seed=0)``, with the arch's stand-in ``frames`` or
    ``prefix``: ``(cfg, tc, batch)``."""
    from repro_torch.configs import get_config, stand_in_inputs
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch.train import TrainConfig
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, n_layers=layers))
    b, s = ZOO_BATCH
    toks = make_lm_tokens(seed=0, n_tokens=b * s + 1, vocab=cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:-1].reshape(b, s)),
             "labels": torch.from_numpy(toks[1:].reshape(b, s)),
             **stand_in_inputs(cfg, b, scale=ZOO_EXTRA_SCALE)}
    return cfg, TrainConfig(**MESH_TC), batch


def zoo_block_check(torch, np, cfg, what):
    """14a: the arch's recurrent mixer at full width (an SSD block; an
    RG-LRU block) on a (2, 512) fp32 input, card against CPU within 1e-4
    of the largest magnitude."""
    from repro_torch.core.compression import tree_map
    from repro_torch.models import rglru, ssm
    gen = torch.Generator().manual_seed(0)
    if cfg.ssm is not None:
        p_cpu = ssm.ssd_init(gen, cfg.d_model, cfg.ssm)
        fn = lambda p, x: ssm.ssd_apply(p, x, cfg.ssm, cfg.d_model)
    else:
        p_cpu = rglru.rglru_init(gen, cfg.d_model, cfg.rglru)
        fn = lambda p, x: rglru.rglru_apply(p, x, cfg.rglru, cfg.d_model)
    p_card = tree_map(lambda t: t.cuda(), p_cpu)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        ZOO_BLOCK_X + (cfg.d_model,)).astype(np.float32))
    with torch.no_grad():
        want = fn(p_cpu, x)
        got = fn(p_card, x.cuda()).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"{what} block at full width on {ZOO_BLOCK_X} fp32: card against "
          f"CPU max |gap| {err:.3e} of max |out| {scale:.3e}")
    require(bool(torch.isfinite(got).all()) and err <= ZOO_BLOCK_TOL * scale,
            f"{what} block card against CPU {err} > {ZOO_BLOCK_TOL} x "
            f"{scale}")
    return err


def zoo_front_check(torch, np, cfg, params, cpu_params, what):
    """14c: the trained weights' fp32 ``forward`` at full width on a (1, 32)
    prompt with the arch's stand-in inputs (internvl: a 256-row prefix
    through ``prefix_proj``; whisper: 1,500 frames through
    ``encode_frames`` into the cross-attention), card against CPU within
    1e-4 of the largest logit."""
    from repro_torch.configs import stand_in_inputs
    from repro_torch.models import forward
    b, s = ZOO_FRONT_TOKENS
    toks = serve_tokens(torch, np, cfg, (b, s), seed=8)
    extra = stand_in_inputs(cfg, b, scale=ZOO_EXTRA_SCALE, seed=8)
    with torch.inference_mode():
        want, _ = forward(cpu_params, cfg, toks, compute_dtype=torch.float32,
                          **extra)
        got, _ = forward(params, cfg, toks.cuda(),
                         compute_dtype=torch.float32,
                         **{k: v.cuda() for k, v in extra.items()})
    got = got.cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    with_ = ", ".join(f"{k} {tuple(v.shape)}" for k, v in extra.items())
    print(f"{what} forward at full width on ({b}, {s}) tokens with {with_} "
          f"fp32: logits {tuple(got.shape)}, card against CPU max |gap| "
          f"{err:.3e} of max |logit| {scale:.3e}")
    require(bool(torch.isfinite(got).all()) and err <= ZOO_BLOCK_TOL * scale,
            f"{what} forward card against CPU {err} > {ZOO_BLOCK_TOL} x "
            f"{scale}")
    return err


def zoo_cache_bytes(torch, cfg, what):
    """14: ``init_cache`` at decode_32k's batch allocates on the card the
    same bytes at long_500k's length (524,288) as at decode_32k's
    (32,768): recurrent states, and rings of the window on local layers;
    and the dry run's decode_32k cache bytes for the same config on one
    card, within 512 B a tensor."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.models import init_cache
    batch = INPUT_SHAPES["decode_32k"].global_batch
    got, asked = {}, {}
    for shape in ("decode_32k", "long_500k"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        before_asked = requested_bytes(torch)
        caches = init_cache(cfg, batch, INPUT_SHAPES[shape].seq_len)
        torch.cuda.synchronize()
        got[shape] = torch.cuda.memory_allocated() - before
        asked[shape] = requested_bytes(torch) - before_asked
        del caches
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = dryrun_record(cfg, None, "decode_32k")
    want = rec["memory"]["arguments"]["caches"]
    leaves = sum(isinstance(t, torch.Tensor) for c in
                 init_cache(cfg, batch, 2, device="meta") for t in c)
    print(f"{what} init_cache at batch {batch}: {json.dumps(got)} bytes "
          f"allocated on the card (requested: {json.dumps(asked)}); the dry "
          f"run's decode_32k caches {want} bytes ({leaves} tensors; the "
          f"dry-run check took {time.perf_counter() - t0:.2f} s)")
    require(got["long_500k"] == got["decode_32k"] > 0,
            f"{what}: long_500k's caches take {got['long_500k']} bytes, "
            f"decode_32k's {got['decode_32k']}")
    require(0 <= asked["decode_32k"] - want <= allocator_slack(leaves),
            f"{what}: decode_32k's caches took {asked['decode_32k']} bytes "
            f"(requested), the dry run sized {want}")
    return got


def zoo_arch(torch, np, rk, arch, numel, k, layers=None):
    """14a-c, one arch: a recurrent arch's block card against CPU, the mesh
    trainer (5 steps with the three STC kernels exactly twice a step at
    (1, numel), bitwise reruns, step phases and host syncs, the kernels
    against their plain versions and timed at that row), then serving the
    trained weights from memory: internvl's forward with its prefix card
    against CPU, fp32 decode vs forward and vs the
    CPU, bf16 prefill vs decode (and each against fp32), the prefill, the
    decode at batch 128 with no host sync, and a recurrent arch's caches'
    bytes at long_500k.  Returns ``(launches, keys by kernel, max
    errors)``."""
    from repro_torch.core.compression import flatten_pytree, tree_map
    from repro_torch.core.distributed import tree_add
    t0 = time.perf_counter()
    clock = [t0]

    def stage(name):
        """Each stage's wall seconds and the card's allocated GiB after it,
        printed as it ends."""
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        print(f"{arch} stage {name}: {clock[-1] - clock[-2]:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    cfg, tc, batch = zoo_setup(torch, np, arch, layers)
    got = (cfg.param_count(), max(int(cfg.param_count() * tc.sparsity_up), 1))
    require(got == (numel, k), f"{arch}: {got[0]} parameters, k = {got[1]}")
    recurrent = cfg.ssm is not None or cfg.rglru is not None
    if recurrent:
        zoo_block_check(torch, np, cfg, arch)
    state, launches = mesh_single(torch, np, rk, cfg, tc, batch, ZOO_STEPS,
                                  what=arch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stage("trainer")
    moe_rerun_check(torch, cfg, tc, state, batch, what=arch)
    time_mesh_step(torch, np, state, cfg, tc, batch, what=arch,
                   reps=ZOO_STEP_REPS, ledger_steps=0, quick=True)
    stage("reruns and step phases")
    # the kernels at the trainer's row, on the carried row of the next
    # encode; the parameters wait on the host meanwhile
    delta = mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4))
    row = flatten_pytree(tree_add(delta, tree_map(
        lambda x: x[0], state["client_res"])))[0][None]
    cpu_params = tree_map(lambda t: t.cpu(), state["params"])
    del delta, state
    torch.cuda.empty_cache()
    stage("the carried row")
    extra, errs = mesh_kernel_rows(torch, rk, row, k, plain_iters=1)
    del row
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.cuda(), cpu_params)
    stage("kernels at the row")
    t_serve = time.perf_counter()
    rk.LAUNCHES.reset()
    if cfg.n_prefix_tokens:
        # the prefix has no decode; the encoder is held card vs CPU through
        # the memory that whisper's decode reads in serve_fp32_checks
        zoo_front_check(torch, np, cfg, params, cpu_params, arch)
    fwd_tol = SSD_DECODE_TOL if cfg.ssm is not None else DECODE_FORWARD_TOL
    serve_fp32_checks(torch, np, cfg, params,
                      cpu_steps=MOE_CPU_STEPS if recurrent else
                      ZOO_ATTN_CPU_STEPS, greedy=0, what=f"{arch} serve",
                      fwd_tol=fwd_tol, cpu_params=cpu_params)
    del cpu_params
    stage("fp32 serve checks")
    serve_bf16_check(torch, np, cfg, params, what=f"{arch} serve",
                     seeds=ZOO_SSM_BF16_SEEDS if cfg.ssm is not None
                     else (3,),
                     shape=BF16_PREFILL if recurrent else ZOO_ATTN_BF16)
    torch.cuda.empty_cache()
    stage("bf16 serve check")
    time_prefill(torch, np, cfg, params, what=f"{arch} serve",
                 shape=PREFILL if recurrent else ZOO_ATTN_PREFILL)
    torch.cuda.empty_cache()
    stage("prefill")
    time_decode(torch, np, cfg, params,
                shape=ZOO_DECODE if recurrent else ZOO_ATTN_DECODE,
                syncs=0, what=f"{arch} serve")
    ran = {n: c for n, c in rk.LAUNCHES.counts.items() if c}
    require(not ran, f"the {arch} serve path launched the port's kernels: "
            f"{ran}")
    del params
    torch.cuda.empty_cache()
    stage("decode")
    if recurrent:
        zoo_cache_bytes(torch, cfg, arch)
    print(f"phase 14 {arch}: {time.perf_counter() - t0:.1f} s (serve "
          f"{time.perf_counter() - t_serve:.1f} s; peak memory of the "
          f"{ZOO_STEPS} trainer steps {peak:.3f} GiB)")
    return launches, extra, errs


def run_zoo(torch, np, rk):
    """Phase 14: the rest of the model zoo on the card, through the mesh
    trainer and the serve path, each at full width and a cut depth
    (``ZOO_*_LAYERS``): Mamba-2-370M at 12 layers, RecurrentGemma-2B at
    6, whisper-medium (frames through its encoder into the
    cross-attention) at 6 encoder and 6 decoder layers, internvl2-2b (a
    patch prefix) at 6; then whisper and internvl at
    their smoke configs, the train step card against CPU.  Returns
    ``(launches by path, keys by kernel for the kernels line, max
    errors)``."""
    t0 = time.perf_counter()
    launches, extra, errs = {}, {}, {}
    for arch, numel, k, layers in (
            (ZOO_SSM, ZOO_SSM_NUMEL, ZOO_SSM_K, ZOO_SSM_LAYERS),
            (ZOO_HYBRID, ZOO_HYBRID_NUMEL, ZOO_HYBRID_K, ZOO_HYBRID_LAYERS),
            (ZOO_ENC, ZOO_ENC_NUMEL, ZOO_ENC_K, ZOO_ENC_LAYERS),
            (ZOO_VLM, ZOO_VLM_NUMEL, ZOO_VLM_K, ZOO_VLM_LAYERS)):
        launches[arch], ex, er = zoo_arch(torch, np, rk, arch, numel, k,
                                          layers)
        for name, keys in ex.items():
            extra.setdefault(name, {}).update(keys)
        for name, e in er.items():
            errs[name] = max(errs.get(name, 0.0), e)
    smoke_archs(torch, np, ZOO_SMOKE, what="zoo")
    torch.cuda.empty_cache()
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}")
    return launches, extra, errs


# --------------------------------------------------------------- phase 15

def run_dryrun(torch, np, rk):
    """Phase 15: the dry run of every arch x input shape on the two
    production meshes and on one card, on the meta device (nothing
    allocated on the card), a line a record; then a train record's ingest
    measurement through ``pack_chunks`` on the card against the numpy
    route, and its fleet statistics.  Returns the launches of its path."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.launch.train import TrainConfig
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    meshes = {"16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True),
              "1x1": make_debug_mesh(1, 1)}
    for tag, mesh in meshes.items():
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                rec = dryrun.lower_combo(arch, shape, mesh=mesh,
                                         verbose=False, ingest=False)
                r = rec["roofline"]
                print(f"dryrun {arch} x {shape} x {tag}: args "
                      f"{rec['memory']['argument_size_in_bytes'] / 2**30:.3f}"
                      f" GiB, flops {rec['flops']:.4e} a device, compute "
                      f"{r['t_compute_s']:.3e} s, memory "
                      f"{r['t_memory_s']:.3e} s, collective "
                      f"{r['t_collective_s']:.3e} s ({r['dominant']}), "
                      f"fits {rec['fits']}")
                require(rec["flops"] > 0 and rec["bytes_accessed"] > 0,
                        f"dry run {arch} x {shape} x {tag}: {rec}")
    require(torch.cuda.memory_allocated() == before,
            "the dry run allocated on the card")
    t_sized = time.perf_counter() - t0
    # the ingest measurement of a train record, on the card, counters at 0
    tc = TrainConfig(protocol="stc")
    numel = get_config(MESH_ARCH).param_count()
    rk.LAUNCHES.reset()
    card = dryrun.measured_ingest_bytes(tc, numel, 16)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES.counts)
    host = dryrun.measured_ingest_bytes(tc, numel, 16, wire_backend="numpy")
    fleet = {name: st["drop_rate"] for name, st in
             dryrun.fleet_event_stats(16).items()}
    print(f"dryrun server_ingest ({MESH_ARCH}, 16 clients): card "
          f"{json.dumps(card)}; numpy route {json.dumps(host)}; launches "
          f"{ {n: c for n, c in launches.items() if c} }; fleet scenarios' "
          f"drop rates (16 clients): {json.dumps(fleet)}")
    require(launches.get("pack_chunks", 0) >= 1,
            f"the dry run's ingest did not launch pack_chunks: {launches}")
    require(card == host, "the card's ingest bytes differ from the numpy "
            "route's")
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s (sizing "
          f"{len(meshes) * len(ARCH_IDS) * len(INPUT_SHAPES)} records "
          f"{t_sized:.1f} s); card: {card_line()}")
    return {"dryrun": launches}


# --------------------------------------------------------------- phase 16

# the runs of phase 16: an arch at full width on make_debug_mesh(1, model).
# "local" is each rank's row: its block of every sharded leaf and the whole
# replicated leaves; "owned" the selection's owned row a rank, which keeps
# the replicated leaves on model rank 0 only.  The depths are cut for the
# script's time: with Qwen2 at 24 layers and SmolLM at 10 the three runs
# took 396.4 s of a 1,113 s script
TP_RUNS = {
    # Qwen2-0.5B at full width, depth cut to 12 of 24 layers: 14 query / 2
    # KV heads, whole heads on two ranks; the norms 22,400 entries
    "qwen2": {"arch": "qwen2-0.5b", "model": 2, "layers": 12,
              "numel": 315_084_160, "k": 6_301_683,
              "local": 157_553_280, "owned": (157_553_280, 157_530_880),
              "ledger": True, "fp32_seq": 128, "path": "tp"},
    # SmolLM-135M at full width, depth cut to 5 of 30 layers: 9 query / 3
    # KV heads of 64, so a rank holds 144 of wq's 576 columns (2.25 heads)
    # and 48 of wk's 192 (0.75 of a head): the attention's gather route;
    # the norms 6,336 entries
    "smollm": {"arch": "smollm-135m", "model": 4, "layers": 5,
               "numel": 46_012_608, "k": 920_252,
               "local": 11_507_904, "owned": (11_507_904,) + (11_501_568,) * 3,
               "ledger": False, "fp32_seq": 32, "path": "tp_midhead"},
    # Granite-MoE-3B at full width, depth cut to 4 layers: 24 query / 8 KV
    # heads of 64 (12 and 4 a rank: whole heads), 40 experts top-8 with
    # d_expert 512 (256 a rank), the tied vocabulary of 49,155 whole on both
    # ranks (it does not split two ways); the embedding, the routers and
    # the norms 75,761,664 entries
    "granite": {"arch": "granite-moe-3b-a800m", "model": 2, "layers": 4,
                "numel": 478_414_848, "k": 9_568_296,
                "local": 277_088_256, "owned": (277_088_256, 201_326_592),
                "ledger": False, "fp32_seq": 32, "path": "tp_moe"},
}
TP_STEPS = 5
TP_LEDGER_STEPS = 2
TP_NEAR = 1e-5                  # |x| within this rtol of the threshold
TP_DIR = ROOT / "build" / "tp_ranks"         # a folder a run under it
TP_RANK_TIMEOUT = 900
TP_SERVE_PROMPT = 64            # fp32 TP against model = 1
TP_SERVE_GREEDY = 8
TP_SERVE_BF16 = (4, 16)         # bf16 prefill against bf16 decode (a
                                # step costs 50 gloo collectives: phase
                                # 12's 512 tokens cut for the script's time)
TP_PREFILL = (1, 8_192)         # phase 14's prefill for the attention archs
TP_DECODE = (64, 4_096)         # 0.81 GB (qwen2), 1.01 GB (smollm, whole
                                # caches), 1.07 GB (granite) of bf16 cache
                                # a rank
TP_NEAR_TIE = 1e-6              # router probabilities closer than this may
                                # order their experts either way in fp32


class GlooCalls:
    """Counts what this process hands gloo, by group name, operation and
    dtype: ``[calls, bytes]`` (an all_gather's bytes: what it gathers);
    ``seconds``: the host clock inside the calls (a collective on a CUDA
    tensor waits for the device work before it, stages through the host
    and copies back)."""

    def __init__(self, groups):
        import torch.distributed as dist
        self.dist, self.groups, self.log = dist, groups, {}
        self.saved = dist.all_reduce, dist.all_gather
        self.seconds = 0.0

    def __enter__(self):
        reduce_, gather = self.saved

        def timed(fn, *args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0

        def all_reduce(t, op=self.dist.ReduceOp.SUM, group=None, **kw):
            self._add(group, "all_reduce", t, t.numel() * t.element_size())
            return timed(reduce_, t, op=op, group=group, **kw)

        def all_gather(parts, t, group=None, **kw):
            self._add(group, "all_gather", t,
                      len(parts) * t.numel() * t.element_size())
            return timed(gather, parts, t, group=group, **kw)

        self.dist.all_reduce, self.dist.all_gather = all_reduce, all_gather
        return self

    def _add(self, group, op, t, nbytes):
        key = (f"{self.groups.get(id(group), 'other')} {op} "
               f"{str(t.dtype).replace('torch.', '')}")
        rec = self.log.setdefault(key, [0, 0])
        rec[0] += 1
        rec[1] += nbytes

    def __exit__(self, *exc):
        self.dist.all_reduce, self.dist.all_gather = self.saved


class SyncFreeCollectives:
    """``torch.cuda.set_sync_debug_mode("error")`` for a call, off only
    inside each ``dist.all_reduce`` / ``dist.all_gather``: gloo stages a
    CUDA tensor through the host and synchronizes its copy stream (on its
    worker thread, while the call waits), so any other host sync raises.
    Counts the collectives it let through (``calls``), and the host reads
    of ``Tensor.tolist`` (``reads``: a MoE layer's group sizes), which it
    lets through too."""

    def __init__(self, torch):
        import torch.distributed as dist
        self.torch, self.dist, self.calls, self.reads = torch, dist, 0, 0
        self.saved = dist.all_reduce, dist.all_gather, torch.Tensor.tolist

    def __enter__(self):
        cuda = self.torch.cuda

        def quiet(fn, counter):
            def call(*args, **kw):
                setattr(self, counter, getattr(self, counter) + 1)
                cuda.set_sync_debug_mode(0)
                try:
                    return fn(*args, **kw)
                finally:
                    cuda.set_sync_debug_mode("error")
            return call

        self.dist.all_reduce, self.dist.all_gather = (
            quiet(fn, "calls") for fn in self.saved[:2])
        assert "tolist" not in vars(self.torch.Tensor)
        self.torch.Tensor.tolist = quiet(self.saved[2], "reads")
        cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self.dist.all_reduce, self.dist.all_gather = self.saved[:2]
        del self.torch.Tensor.tolist        # TensorBase's again


def router_calls():
    """``tests/_torch_mesh_worker.py``'s ``RouterCalls``: every call of
    ``repro_torch.models.moe.route`` while entered, its expert choices and
    router probabilities kept on the device."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_mesh_worker import RouterCalls
    return RouterCalls()


def tp_setup(torch, np, run):
    """The run's arch at full width (its depth cut where ``run`` says),
    the reference CLI's STC setting (bf16 compute, remat) and
    ``make_lm_tokens(seed=0)`` in a 4 x 128 batch: ``(cfg, tc, batch)``."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch.train import TrainConfig
    cfg = get_config(run["arch"])
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    toks = make_lm_tokens(seed=0, n_tokens=4 * 128 + 1, vocab=cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:-1].reshape(4, 128)),
             "labels": torch.from_numpy(toks[1:].reshape(4, 128))}
    return cfg, TrainConfig(**MESH_TC), batch


def tp_kernel_rows(torch, rk, full, local, k):
    """16h (rank 0): the three STC kernels at the shapes this rank's path
    gives them, from the first step's carried tree: the histogram at the
    owned row with the joined row's scale, ``bin_select`` at the candidate
    row (the joined row's elements of bin b) with its global rank, the
    apply at the local row with the global threshold and µ; each held
    against its plain version and timed beside it, its byte bound and the
    library call.  Returns ``(keys by kernel, max errors)``."""
    from repro_torch.core.selection import bin_index
    scale, b, r, cnt_b = select_inputs(torch, full, k)
    t, c, s = rk.hist_topk_threshold_batched(full, k)
    mu = s / torch.clamp(c, min=1).to(torch.float32)
    a = full.abs()
    cand = full[0][bin_index(a, scale[:, None], 256)[0] == b[0]][None]
    del a
    n, m_b = local.shape[1], cand.shape[1]
    errs = {"histogram": check_histogram(torch, rk, local, scale)}
    got = rk.candidate_select_batched(cand, scale, b, r)
    want = rk.candidate_select_plain(cand, scale, b, r)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0),
            f"bin_select differs from its plain version at (1, {m_b})")
    errs["bin_select"] = float((got[2] - want[2]).abs().max())
    got = rk.stc_apply_batched(local, t, mu)
    want = rk.stc_apply_plain(local, t, mu)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"stc_apply differs from its plain version at (1, {n})")
    errs["stc_apply"] = 0.0
    del got, want

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    kernels = {
        "histogram": (lambda: rk.magnitude_histogram_batched(local, scale),
                      lambda: rk.magnitude_histogram_plain(local, scale),
                      4 * n + 4 + 8 * 256, n),
        "bin_select": (lambda: rk.candidate_select_batched(cand, scale, b, r),
                       lambda: rk.candidate_select_plain(cand, scale, b, r),
                       4 * m_b + 20 + 12, m_b),
        "stc_apply": (lambda: rk.stc_apply_batched(local, t, mu),
                      lambda: rk.stc_apply_plain(local, t, mu),
                      3 * 4 * n + 8, n)}
    out = {}
    for name, (kernel, plain, nbytes, width) in kernels.items():
        tag = f"_tp_1x{width}"
        out[name] = {"ms" + tag: event_ms(torch, kernel, iters=20),
                     "plain_ms" + tag: event_ms(torch, plain, iters=1,
                                                hold_stream=False,
                                                warm=False),
                     "bound_ms" + tag: bound(nbytes),
                     "library_ms" + tag: None}
    a = local.abs()
    bins = bin_index(a, scale[:, None], 256).to(torch.int64).reshape(-1)
    out["histogram"][f"library_ms_tp_1x{n}"] = event_ms(
        torch, lambda: (torch.bincount(bins, minlength=256),
                        torch.bincount(bins, weights=a.reshape(-1),
                                       minlength=256)),
        iters=1, hold_stream=False)
    del bins, a
    rank = int(r[0])
    ac = cand.abs()
    out["bin_select"][f"library_ms_tp_1x{m_b}"] = event_ms(
        torch, lambda: torch.topk(ac, rank, dim=1), iters=1,
        hold_stream=False)
    out["bin_select"][f"cnt_b_tp_1x{m_b}"] = int(cnt_b[0])
    print(f"tp kernels (rank 0) at the owned and local row (1, {n}) and the "
          f"candidate row (1, {m_b}) (bin {int(b[0])}, rank {rank} in it), "
          f"k = {k}: {json.dumps(out)}", flush=True)
    return out, errs


def tp_lockstep(torch, np, rk, cfg, tc, state, batch, tp, mesh, flags):
    """16b: the split selection of the first step's carried tree against
    the flat ``stc_compress_rows`` of the joined row on the card (rank 0;
    the other rank waits): threshold, count, positions and signs exact, µ
    within rtol 1e-6; then rank 0's kernel rows (16h).  Returns rank 0's
    ``(record, kernel keys, errors)``."""
    import torch.distributed as dist
    from repro_torch.core.compression import flatten_pytree, tree_map
    from repro_torch.core.distributed import (
        ModelShards, stc_compress_tree_with_residual, tree_add)
    from repro_torch.kernels import hist_select
    from repro_torch.kernels.ops import stc_compress_rows
    from repro_torch.launch.train import unshard_tree
    numel = cfg.param_count()
    k = max(int(numel * tc.sparsity_up), 1)
    delta = mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4),
                       tp=tp)
    carried = tree_add(delta, tree_map(lambda x: x[0], state["client_res"]))
    del delta
    shards = ModelShards(tp.group, tp.rank, tuple(flags))
    tern, _, st = stc_compress_tree_with_residual(
        carried, tc.sparsity_up, numel=numel, model=shards)
    m_b = hist_select.SPLIT_CANDIDATES[-1]
    full = flatten_pytree(unshard_tree(carried, cfg, mesh, tp.group))[0]
    tern_full = flatten_pytree(unshard_tree(tern, cfg, mesh, tp.group))[0]
    local = flatten_pytree(carried)[0][None]
    del tern, carried
    rec, extra, errs = {}, {}, {}
    if tp.rank == 0:
        ft, _, fmu, fth, fcnt = stc_compress_rows(full[None], k)
        rec = {"thresh": [float(st.thresh), float(fth[0])],
               "nnz": [int(st.nnz), int(fcnt[0])],
               "mu": [float(st.mu), float(fmu[0])], "m_b": m_b,
               "same_positions_and_signs": bool(
                   torch.equal(tern_full != 0, ft[0] != 0) and
                   torch.equal(torch.sign(tern_full), torch.sign(ft[0])))}
        del ft, tern_full
        torch.cuda.empty_cache()
        extra, errs = tp_kernel_rows(torch, rk, full[None], local, k)
    del full, local
    torch.cuda.empty_cache()
    dist.barrier()
    return rec, extra, errs


def tp_fp32_check(torch, np, rk, cfg, tc, batch, mesh, rank):
    """16f: one fp32 step of the ranks from the seed-0 state against the
    ``model = 1`` step of the same parameters and batch on the card (rank
    0 runs it after the ranks' step; the others wait): the loss
    within rtol 1e-5 and ``nnz_up`` apart by no more than the model = 1
    carried row's magnitudes within rtol ``TP_NEAR`` of its threshold; on
    a MoE config every router call's expert choices (forward and remat's
    recompute) equal to the ``model = 1`` step's for every token whose
    k-th and (k+1)-th probabilities there lie more than ``TP_NEAR_TIE``
    apart, each token that differs inside that gap listed with its gap."""
    import torch.distributed as dist
    from repro_torch.core.compression import flatten_pytree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import init_train_state, make_train_step
    tc32 = dataclasses.replace(tc, compute_dtype=torch.float32)
    state = init_train_state(cfg, tc32, 1, key=0, mesh=mesh)
    with router_calls() as routed_tp:
        _, m_tp = make_train_step(cfg, mesh, tc32)(state, batch)
    m_tp = {k: float(v) for k, v in m_tp.items()}
    del state
    torch.cuda.empty_cache()
    dist.barrier()
    rec = {}
    if rank == 0:
        state = init_train_state(cfg, tc32, 1, key=0)
        with router_calls() as routed_one:
            _, m_one = make_train_step(cfg, make_debug_mesh(1, 1),
                                       tc32)(state, batch)
        row = flatten_pytree(mesh_delta(torch, cfg, tc32, state["params"],
                                        batch, slice(0, 4)))[0][None]
        del state
        k = max(int(cfg.param_count() * tc.sparsity_up), 1)
        t = float(rk.hist_topk_threshold_batched(row, k)[0][0])
        a = row.abs()
        near = int(((a >= t * (1 - TP_NEAR)) & (a <= t * (1 + TP_NEAR)))
                   .sum())
        del row, a
        torch.cuda.empty_cache()
        rec = {"tp": m_tp, "one": {k: float(v) for k, v in m_one.items()},
               "thresh": t, "near": near}
        if cfg.moe is not None:
            rec["choices"] = compare_choices(torch, routed_tp.log,
                                             routed_one.log, cfg.moe.top_k)
    dist.barrier()
    return rec


def compare_choices(torch, got, want, k):
    """Router calls ``got`` (expert choices) against ``want`` (choices and
    probabilities), call by call: the tokens clear of a near-tie (the k-th
    and (k+1)-th probabilities more than ``TP_NEAR_TIE`` apart) must choose
    the same experts; a token inside the gap may differ, and is listed with
    its gap."""
    require(len(got) == len(want), f"{len(got)} router calls against "
            f"{len(want)}")
    clear_tokens, flipped = 0, []
    for call, ((idx, _), (ref, probs)) in enumerate(zip(got, want)):
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        clear = gap > TP_NEAR_TIE
        differ = (idx != ref).any(dim=-1)
        require(not bool((differ & clear).any()),
                f"router call {call}: "
                f"{int((differ & clear).sum())} tokens clear of a near-tie "
                f"chose other experts")
        clear_tokens += int(clear.sum())
        flipped += [{"call": call, "token": int(i), "gap": float(gap[i])}
                    for i in differ.nonzero()[:, 0].tolist()]
    return {"calls": len(got), "tokens_clear": clear_tokens,
            "tokens": sum(int(idx.shape[0]) for idx, _ in got),
            "near_tie_flips": flipped}


def tp_serve_fp32(torch, np, cfg, mesh, tp, trained, digest):
    """16i: the fp32 prefill of a 64-token prompt (batch 2) and its decode,
    teacher-forced through the prompt and then 8 greedy steps, on the
    ranks; rank 0 then runs the ``model = 1`` steps on the joined weights
    over the same tokens (the others wait): prefill and each decode
    step within ``CARD_CPU_TOL``, the greedy tokens equal where the
    ``model = 1`` top-2 gap exceeds twice it.  Returns rank 0's gaps."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.launch.train import unshard_tree
    from repro_torch.models import init_cache
    b, n, g = SERVE_BATCH, TP_SERVE_PROMPT, TP_SERVE_GREEDY
    toks = serve_tokens(torch, np, cfg, (b, n), seed=1).cuda()

    def run(params, step_mesh, model, forced=None):
        pre = make_prefill_step(cfg, step_mesh, torch.float32)(
            params, {"tokens": toks})[:, 0]
        dec = make_decode_step(cfg, step_mesh, torch.float32)
        caches = init_cache(cfg, b, n + g, torch.float32, model=model)
        for t in range(n):
            lg, caches = dec(params, toks[:, t:t + 1], caches)
        logits, chosen = [lg[:, 0]], []
        for i in range(g):
            tok = (lg[:, 0].argmax(dim=-1, keepdim=True) if forced is None
                   else forced[i])
            chosen.append(tok)
            lg, caches = dec(params, tok, caches)
            logits.append(lg[:, 0])
        return pre, logits, chosen

    pre, logits, chosen = run(trained, mesh, tp.size)
    digest("fp32 prefill", pre)
    for i, lg in enumerate(logits):
        digest(f"fp32 decode {i}", lg)
    joined = unshard_tree(trained, cfg, mesh, tp.group)
    rec = {}
    if tp.rank == 0:
        one_pre, one_logits, _ = run(joined, make_debug_mesh(1, 1), 1,
                                     forced=chosen)
        gaps = [float((pre - one_pre).abs().max())]
        require(torch.allclose(pre, one_pre, **CARD_CPU_TOL),
                f"tp fp32 prefill differs from model = 1 by {gaps[0]}")
        checked = 0
        for i, (lg, want) in enumerate(zip(logits, one_logits)):
            gaps.append(float((lg - want).abs().max()))
            require(torch.allclose(lg, want, **CARD_CPU_TOL),
                    f"tp fp32 decode step {i} differs from model = 1 by "
                    f"{gaps[-1]}")
            if i == 0:
                continue
            # the token the tp run chose from step i - 1's logits
            agree = chosen[i - 1][:, 0] == one_logits[i - 1].argmax(dim=-1)
            clear = _clear(one_logits[i - 1])
            require(bool(agree[clear].all()),
                    "tp and model = 1 chose other greedy tokens where the "
                    "top-2 gap exceeds twice the tolerance")
            checked += int(clear.sum())
        rec = {"prefill_gap": gaps[0], "decode_gaps": gaps[1:],
               "greedy_checked": checked, "greedy_steps": g * b,
               "max_logit": float(one_pre.abs().max())}
    del joined
    torch.cuda.empty_cache()
    dist.barrier()
    return rec


def _clear(logits):
    """Rows whose top-2 logits lie more than twice ``CARD_CPU_TOL`` apart:
    each logit may move by the tolerance, so their order cannot change."""
    top2 = logits.topk(2, dim=-1).values
    tol = CARD_CPU_TOL["atol"] + CARD_CPU_TOL["rtol"] * top2[:, 0].abs()
    return (top2[:, 0] - top2[:, 1]) > 2 * tol


def tp_serve_bf16(torch, np, cfg, mesh, tp, trained, digest):
    """16j: the bf16 prefill of a (4, 16) prompt against the last logits
    of its bf16 teacher-forced decode, within ``BF16_TOL`` of the largest
    logit (phase 12's rule)."""
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache
    b, s = TP_SERVE_BF16
    toks = serve_tokens(torch, np, cfg, (b, s), seed=3).cuda()
    pre = make_prefill_step(cfg, mesh)(trained, {"tokens": toks})[:, 0]
    dec = make_decode_step(cfg, mesh)
    caches = init_cache(cfg, b, s, model=tp.size)
    for t in range(s):
        lg, caches = dec(trained, toks[:, t:t + 1], caches)
    del caches
    digest("bf16 prefill", pre)
    digest("bf16 decode", lg[:, 0])
    pre, lg = pre.float(), lg[:, 0].float()
    gap, top = float((lg - pre).abs().max()), float(pre.abs().max())
    require(gap <= BF16_TOL * top, f"tp bf16 prefill and decode differ by "
            f"{gap} > {BF16_TOL} x {top}")
    return {"gap": gap, "max_logit": top,
            "argmax_equal": int((lg.argmax(-1) == pre.argmax(-1)).sum()),
            "rows": b}


def tp_serve_timed(torch, np, cfg, mesh, tp, trained, digest):
    """16k: the rank's caches at batch 64 against 4,096 slots (its KV
    heads, or the whole cache where they do not split; requested bytes
    equal to ``serve_state_structs``' per-device stand-ins, allocated
    within the allocator's rounding), the bf16 prefill at (1, 8,192)
    (median of 3, what it hands gloo counted) and the decode: 6 warm-up
    steps, one under ``SyncFreeCollectives`` and ``GlooCalls`` (exactly
    the collectives of the dry run's ``tp_serve_collectives``: ``2·L + 2``
    on whole heads, ``3·L + 2`` on the gather route, ``2·L`` where the
    vocabulary stays whole; no host sync but one read of the group sizes
    a MoE layer), one under the profiler (device time), 16 timed; each
    step feeds back its argmax."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.compression import tree_leaves
    from repro_torch.launch.dryrun import tp_serve_collectives
    from repro_torch.launch.serve import (make_decode_step,
                                          make_prefill_step,
                                          serve_state_structs)
    from repro_torch.models import init_cache
    from repro_torch.sharding.rules import StandIn
    groups = {id(tp.group): "model"}
    rec = {}
    # the prefill
    pb, ps = TP_PREFILL
    toks = serve_tokens(torch, np, cfg, (pb, ps), seed=4).cuda()
    prefill = make_prefill_step(cfg, mesh)
    with GlooCalls(groups) as calls:
        out = prefill(trained, {"tokens": toks})
        torch.cuda.synchronize()
    require(tuple(out.shape) == (pb, 1, cfg.vocab_size) and
            bool(torch.isfinite(out).all()), "tp prefill logits not finite")
    digest("prefill (1, 8192)", out)
    want = tp_serve_collectives(cfg, mesh, "prefill", pb, ps)
    rec.update(prefill_gloo=calls.log, prefill_gloo_ms=1e3 * calls.seconds)
    require(_as_records(calls.log) == _as_records(want),
            f"tp prefill handed gloo {calls.log}, the dry run lists {want}")
    rec["prefill_ms"] = 1e3 * median_s(
        torch, lambda: prefill(trained, {"tokens": toks}), reps=3)
    del out
    torch.cuda.empty_cache()
    # the caches
    b, s = TP_DECODE
    _, structs = serve_state_structs(cfg, mesh, b, s)
    stand_ins = [x for x in tree_leaves(structs) if isinstance(x, StandIn)]
    want_bytes = sum(x.device_bytes() for x in stand_ins)
    torch.cuda.synchronize()
    before, before_asked = torch.cuda.memory_allocated(), \
        requested_bytes(torch)
    caches = init_cache(cfg, b, s, model=tp.size)
    torch.cuda.synchronize()
    rec["cache_allocated"] = torch.cuda.memory_allocated() - before
    rec["cache_requested"] = requested_bytes(torch) - before_asked
    rec["cache_stand_ins"] = want_bytes
    rec["cache_heads"] = sorted({c.k.shape[2] for c in caches})
    # the KV heads a rank's stand-ins hold (fit_spec's cache_specs)
    heads = sorted({x.sharding.shard_shape(x.shape)[2] for x in stand_ins
                    if len(x.shape) == 4})
    require(rec["cache_heads"] == heads,
            f"tp caches hold {rec['cache_heads']} KV heads a layer, not "
            f"{heads}")
    require(rec["cache_requested"] == want_bytes,
            f"tp caches requested {rec['cache_requested']} bytes, the "
            f"stand-ins {want_bytes}")
    require(0 <= rec["cache_allocated"] - want_bytes
            <= allocator_slack(len(stand_ins)),
            f"tp caches allocated {rec['cache_allocated']} bytes, the "
            f"stand-ins {want_bytes}")
    # the decode
    gen = torch.Generator(device="cuda").manual_seed(5 + tp.rank)
    start = torch.tensor(s - DECODE_WARM - DECODE_TIMED, dtype=torch.int32,
                         device="cuda")
    for i, c in enumerate(caches):
        c.k.normal_(generator=gen)
        c.v.normal_(generator=gen)
        caches[i] = c._replace(idx=start.clone())
    dec = make_decode_step(cfg, mesh)
    state = {"tok": serve_tokens(torch, np, cfg, (b, 1), seed=6).cuda(),
             "caches": caches}

    def step():
        lg, state["caches"] = dec(trained, state["tok"], state["caches"])
        state["tok"] = lg.argmax(dim=-1)
        return lg

    for _ in range(DECODE_WARM - 2):
        step()
    torch.cuda.synchronize()
    with GlooCalls(groups) as calls, SyncFreeCollectives(torch) as free:
        lg = step()
    torch.cuda.synchronize()
    digest("decode step", lg)
    want = tp_serve_collectives(cfg, mesh, "decode", b, s)
    rec.update(decode_gloo=calls.log, decode_collectives=free.calls,
               decode_reads=free.reads, dryrun_decode=want,
               decode_gloo_ms=1e3 * calls.seconds)
    calls_want = sum(c["count"] for c in want.values())
    require(free.calls == calls_want,
            f"a tp decode step issued {free.calls} collectives, not "
            f"{calls_want}")
    # one host read of the group sizes a MoE layer, none elsewhere
    reads_want = (0 if cfg.moe is None else
                  cfg.n_layers - cfg.moe.first_dense)
    require(free.reads == reads_want,
            f"a tp decode step read the host {free.reads} times, not "
            f"{reads_want}")
    require(_as_records(calls.log) == _as_records(want),
            f"a tp decode step handed gloo {calls.log}, the dry run lists "
            f"{want}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    require(dev_ms > 0, "the profiler saw no device time in a tp decode "
            "step")
    step_s = []
    for _ in range(DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    require(all(int(c.idx) == s for c in state["caches"]),
            "the tp caches' idx did not reach the last slot")
    require(bool(torch.isfinite(state["caches"][0].k[:, -1]).all()),
            "tp decode wrote non-finite cache values")
    weights = sum(x.numel() * x.element_size() for x in tree_leaves(trained))
    rec.update(decode_ms=[1e3 * x for x in step_s], device_ms=dev_ms,
               cache_bytes=want_bytes, weight_bytes=weights,
               bound_ms=(want_bytes + weights) / HBM_BYTES_PER_S * 1e3)
    return rec


def _as_records(log, skip=()):
    """A ``GlooCalls`` log, or the dry run's collectives, as ``{op: (calls,
    bytes)}`` over the model group, summed over dtypes and names; a log's
    ``"op dtype"`` keys in ``skip`` left out."""
    out = {}
    for key, val in log.items():
        if isinstance(val, dict):
            op = "all_gather" if key.endswith("all-gather") else "all_reduce"
            val = (val["count"], val["bytes"])
        else:
            group, op, dtype = key.split(" ")
            require(group == "model", f"a collective outside the model "
                    f"group: {key}")
            if f"{op} {dtype}" in skip:
                continue
        calls, nbytes = out.get(op, (0, 0))
        out[op] = (calls + val[0], nbytes + val[1])
    return out


def tp_serve(torch, np, rk, cfg, mesh, tp, trained):
    """16i-k: serving the rank's trained shard from its caches (head-sharded,
    or whole where the KV heads do not split), with the counters at 0 (the
    serve path launches
    none of the port's kernels).  Returns the rank's serve record, with a
    digest of every logits tensor it made (the ranks' must be equal)."""
    import hashlib
    digests = {}

    def digest(name, t):
        digests[name] = hashlib.sha256(
            t.detach().float().cpu().numpy().tobytes()).hexdigest()

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    rk.LAUNCHES.reset()
    rec, stages = {}, {}
    for name, fn in (("fp32", tp_serve_fp32), ("bf16", tp_serve_bf16),
                     ("timed", tp_serve_timed)):
        t1 = time.perf_counter()
        rec[name] = fn(torch, np, cfg, mesh, tp, trained, digest)
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t1, 1)
    rec.update(launches={n: c for n, c in rk.LAUNCHES.counts.items() if c},
               digests=digests, seconds=time.perf_counter() - t0,
               stages=stages)
    require(not rec["launches"], f"the tp serve path launched the port's "
            f"kernels: {rec['launches']}")
    return rec


def tp_rank(rank, port, out_dir, run):
    """16, one of the model ranks of ``make_debug_mesh(1, run["model"])``
    (a spawned process, gloo on ``cuda:0``): the state's requested bytes
    against the dry run (16a), the lock-step selection and kernel rows
    (16b, 16h), ``TP_STEPS`` steps with the counters at 0, what it hands
    gloo counted and each router call's expert choices digested (16c),
    one step under ``FlopCounterMode`` (16d),
    where the run asks for it ``TP_LEDGER_STEPS`` measured steps through
    the ``WireLedger`` (16e: rank 0 on the card's wire route, rank 1 on the
    numpy route, each on the joined messages it holds), the fp32 check on
    the run's rows (16f), the step's times, device share and peak memory
    (16g), and serving the trained shard (16i-k).  Writes its record to
    ``out_dir/rank<rank>.json``."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    import repro_torch.kernels as rk
    from repro_torch.configs import InputShape
    from repro_torch.core.compression import tree_leaves
    from repro_torch.kernels import hist_select
    from repro_torch.launch.dryrun import lower_combo
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (WireLedger, codec_for,
                                          init_train_state, make_train_step)
    from repro_torch.models.transformer import init_model
    from repro_torch.sharding.rules import replicated_leaves
    from repro_torch.sharding.tensor_parallel import TensorParallel
    m = run["model"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=m, rank=rank)
    stages, clock = {}, [time.perf_counter()]

    def stage(name):
        """Each stage's wall seconds, into the record."""
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        stages[name] = round(clock[-1] - clock[-2], 1)

    try:
        t_start = clock[0]
        cfg, tc, batch = tp_setup(torch, np, run)
        mesh = make_debug_mesh(1, m)
        tp = TensorParallel(mesh.model_group(), mesh.model_rank(), m)
        numel = cfg.param_count()
        rec = lower_combo(cfg.name, InputShape("row", 128, 4, "train"),
                          mesh=mesh, cfg=cfg, tc=tc, verbose=False,
                          ingest=False)
        out = {"rank": rank, "numel": numel, "dryrun_flops": rec["flops"],
               "dryrun_state": rec["memory"]["arguments"]["state"],
               "dryrun_collectives": rec["collectives"],
               "dryrun_dependent": rec["collectives_data_dependent"]}
        torch.cuda.synchronize()
        asked = requested_bytes(torch)
        state = init_train_state(cfg, tc, 1, key=0, mesh=mesh)
        torch.cuda.synchronize()
        out["state_asked"] = requested_bytes(torch) - asked
        out["state_leaves"] = len(tree_leaves(state))
        flags = replicated_leaves(init_model(cfg, device="meta"), mesh)
        step = make_train_step(cfg, mesh, tc)
        stage("init")
        out["lockstep"], out["kernel_rows"], out["kernel_errs"] = \
            tp_lockstep(torch, np, rk, cfg, tc, state, batch, tp, mesh, flags)
        stage("lock-step and kernel rows")
        # 16c: the main path, the counters at 0 just before it
        torch.cuda.synchronize()
        rk.LAUNCHES.reset()
        hist_select.SPLIT_CANDIDATES.clear()
        metrics, digests, times, choices = [], [], [], []
        with GlooCalls({id(tp.group): "model"}) as calls:
            for _ in range(TP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with router_calls() as routed:
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                choices.append(routed.digests())
                metrics.append({k: float(v) for k, v in m.items()})
                h = hashlib.sha256()
                for x, r in zip(tree_leaves(state["params"]), flags):
                    if r:
                        h.update(x.detach().cpu().numpy().tobytes())
                digests.append(h.hexdigest())
        out.update(metrics=metrics, digests=digests, step_s=times,
                   choices=choices,
                   launches=dict(rk.LAUNCHES.counts),
                   shapes={k: list(v) for k, v in rk.LAUNCHES.shapes.items()},
                   m_b=list(hist_select.SPLIT_CANDIDATES),
                   gloo={k: [c / TP_STEPS, b / TP_STEPS]
                         for k, (c, b) in calls.log.items()})
        stage("steps")
        # 16d: one step's FLOPs
        with FlopCounterMode(display=False) as counter:
            step(state, batch)
            torch.cuda.synchronize()
        out["flops"] = counter.get_total_flops()
        stage("FLOP step")
        # 16g: the step's phases, device share and peak
        sgd = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh_delta(torch, cfg, tc, state["params"], batch, slice(0, 4),
                       tp=tp)
            torch.cuda.synchronize()
            sgd.append(time.perf_counter() - t0)
        kt = kernel_times(torch, lambda: step(state, batch), calls=1) or {}
        out.update(local_sgd_s=sgd, device_ms=sum(kt.values()))
        stage("timing")
        # 16e: measured steps through the WireLedger on both wire routes
        if run["ledger"]:
            measured = make_train_step(cfg, mesh, dataclasses.replace(
                tc, measure_wire=True))
            codec = codec_for(tc)
            if rank == 0:
                codec = dataclasses.replace(codec, wire_backend="kernel")
            ledger = WireLedger(codec, numel)
            s, packs = state, 0
            for _ in range(TP_LEDGER_STEPS):
                s, _, (msgs, gd) = measured(s, batch)
                before = rk.LAUNCHES.counts["pack_chunks"]
                ledger.record_round(msgs, gd)
                torch.cuda.synchronize()
                packs += rk.LAUNCHES.counts["pack_chunks"] - before
                del msgs, gd
            del s, measured
            out.update(ledger=ledger.summary(), ledger_packs=packs)
            stage("ledger")
        peak = torch.cuda.max_memory_allocated() / 2**30
        trained = state["params"]
        del state, step
        torch.cuda.empty_cache()
        # 16f: fp32 against the model = 1 step, on the run's rows
        seq = run["fp32_seq"]
        out["fp32"] = tp_fp32_check(
            torch, np, rk, cfg, tc, {k: v[:, :seq] for k, v in batch.items()},
            mesh, rank)
        stage("fp32 check")
        # 16i-k: serving the trained shard
        out["serve"] = tp_serve(torch, np, rk, cfg, mesh, tp, trained)
        stage("serve")
        out.update(peak_gib=peak, seconds=time.perf_counter() - t_start,
                   stages=stages)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run_tensor_parallel(torch, np, rk):
    """Phase 16: tensor parallelism in the mesh trainer on the card, each
    run of ``TP_RUNS`` in turn (``tp_run``): Qwen2-0.5B at full width (12
    layers) on ``make_debug_mesh(1, 2)`` (whole heads), then SmolLM-135M
    at full width (5 layers) on ``make_debug_mesh(1, 4)`` (heads cut
    mid-head: the attention's gather route), then Granite-MoE-3B at full
    width (4 layers) on ``make_debug_mesh(1, 2)`` (the experts split on
    their hidden dim), gloo ranks on ``cuda:0``, STC p = 1/50 both ways.
    Returns ``(launches by path, keys by kernel for the kernels line, max
    errors)``."""
    t0 = time.perf_counter()
    rk.build_all()
    launches, keys, errs = {}, {}, {}
    for name, run in TP_RUNS.items():
        paths, rows, run_errs = tp_run(torch, np, rk, name, run)
        launches.update(paths)
        for kernel, kv in rows.items():
            keys.setdefault(kernel, {}).update(kv)
        for kernel, err in run_errs.items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return launches, keys, errs


def tp_run(torch, np, rk, name, run):
    """One run of phase 16: ``run["model"]`` gloo ranks (``tp_rank``), each
    rank's records checked.  Returns ``(launches by path, keys by kernel,
    max errors)``."""
    import shutil
    import socket
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    t0 = time.perf_counter()
    m, arch = run["model"], run["arch"]
    where = TP_DIR / name
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(tp_rank, args=(port, where, run), nprocs=m,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TP_RANK_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            require(time.monotonic() < deadline,
                    f"the {m} tensor-parallel ranks of {arch} did not "
                    f"finish in {TP_RANK_TIMEOUT} s")
    except ProcessException as exc:
        raise Failure(f"a tensor-parallel rank of {arch} failed: "
                      f"{exc}") from exc
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks = [json.loads((where / f"rank{r}.json").read_text())
             for r in range(m)]
    zero = ranks[0]
    numel, k = zero["numel"], max(int(zero["numel"] * P_STC), 1)
    require((numel, k) == (run["numel"], run["k"]),
            f"{arch}: {numel} parameters, k = {k}")
    losses = [x["loss"] for x in zero["metrics"]]
    nnz = [(int(x["nnz_up"]), int(x["nnz_down"])) for x in zero["metrics"]]
    print(f"tp {name}: {TP_STEPS} steps of {arch} on {m} model ranks, "
          f"losses {json.dumps(losses)}; nnz (up, down) beside k = {k}: "
          f"{nnz}; candidate rows m_b a call (rank 0): {zero['m_b']}")
    require(all(math.isfinite(x) for x in losses), f"tp loss not finite: "
            f"{losses}")
    require(losses[-1] < losses[0], f"tp loss did not fall: {losses}")
    require(all(u >= k and d >= k for u, d in nnz),
            f"a tp selection kept fewer than k = {k}: {nnz}")
    for r, out in enumerate(ranks[1:], 1):
        require(out["metrics"] == zero["metrics"],
                f"rank {r}'s metrics differ from rank 0's")
        apart = [i for i, (a, b) in enumerate(zip(out["choices"],
                                                  zero["choices"])) if a != b]
        require(not apart and len(out["choices"]) == len(zero["choices"]),
                f"rank {r}'s expert choices differ from rank 0's at steps "
                f"{apart}")
        require(out["digests"] == zero["digests"],
                f"rank {r}'s replicated leaves differ from rank 0's at "
                f"steps {[i for i, (a, b) in enumerate(zip(out['digests'], zero['digests'])) if a != b]}")
    for r, out in enumerate(ranks):
        for kernel in MESH_KERNELS:
            require(out["launches"].get(kernel) == 2 * TP_STEPS,
                    f"rank {r}: {kernel} launched "
                    f"{out['launches'].get(kernel)} times in {TP_STEPS} "
                    f"steps, not twice a step")
        others = {n: c for n, c in out["launches"].items()
                  if c and n not in MESH_KERNELS}
        require(not others, f"rank {r}'s step launched other kernels: "
                f"{others}")
        want = {"histogram": [1, run["owned"][r]],
                "stc_apply": [1, run["local"]],
                "bin_select": [1, out["m_b"][-1]]}
        got = {n: out["shapes"].get(n) for n in want}
        require(got == want, f"rank {r}: last launch shapes {got}, not "
                f"{want}")
        require(0 <= out["state_asked"] - out["dryrun_state"]
                <= allocator_slack(out["state_leaves"]),
                f"rank {r}: init_train_state asked for "
                f"{out['state_asked']} bytes, the dry run sized "
                f"{out['dryrun_state']}")
        require(out["flops"] == out["dryrun_flops"],
                f"rank {r}: a step counted {out['flops']} FLOPs, the dry "
                f"run {out['dryrun_flops']}")
        # what a step hands gloo: the dry run's counted collectives; the
        # candidates' fp32 gather depends on the data (its calls counted)
        cand = out["gloo"].get("model all_gather float32", [0, 0])
        want_cand = out["dryrun_dependent"].get(
            "model-candidates-all-gather", {"count": 0})["count"]
        require(_as_records(out["gloo"], skip=("all_gather float32",)) ==
                _as_records(out["dryrun_collectives"]) and
                cand[0] == want_cand,
                f"rank {r}: a step handed gloo {json.dumps(out['gloo'])}, "
                f"the dry run lists {json.dumps(out['dryrun_collectives'])}")
        print(f"tp {name} rank {r}: init_train_state requested "
              f"{out['state_asked']} bytes, dry run {out['dryrun_state']}; "
              f"step FLOPs {out['flops']} = dry run "
              f"{out['dryrun_flops']:.0f}; gloo a step by kind "
              f"{json.dumps(out['gloo'])} (= the dry run's counted: "
              f"{json.dumps(out['dryrun_collectives'])}); step seconds "
              f"{out['step_s']}; local SGD seconds {out['local_sgd_s']}; "
              f"peak {out['peak_gib']:.3f} GiB; {out['seconds']:.1f} s "
              f"(stages {json.dumps(out['stages'])})")
    lock = zero["lockstep"]
    print(f"tp {name} lock-step (the first step's carried tree): split "
          f"against the flat stc_compress_rows of the joined row: "
          f"{json.dumps(lock)}")
    require(lock["thresh"][0] == lock["thresh"][1]
            and lock["nnz"][0] == lock["nnz"][1]
            and lock["same_positions_and_signs"],
            f"the split selection differs from the joined row's: {lock}")
    require(abs(lock["mu"][0] - lock["mu"][1]) <= 1e-6 * abs(lock["mu"][1]),
            f"the split selection's µ {lock['mu']}")
    if any(zero["choices"]):
        print(f"tp {name}: every router call's expert choices bitwise equal "
              f"on the {m} ranks ({len(zero['choices'][0])} calls a step: "
              f"the forward's and remat's recompute, {TP_STEPS} steps)")
    fp = zero["fp32"]
    print(f"tp {name} fp32 step (4 x {run['fp32_seq']} tokens) against "
          f"model = 1: {json.dumps(fp)}")
    require(abs(fp["tp"]["loss"] - fp["one"]["loss"])
            <= 1e-5 * abs(fp["one"]["loss"]),
            f"fp32 loss {fp['tp']['loss']!r} against {fp['one']['loss']!r}")
    require(abs(fp["tp"]["nnz_up"] - fp["one"]["nnz_up"]) <= fp["near"],
            f"fp32 nnz_up {fp['tp']['nnz_up']} against "
            f"{fp['one']['nnz_up']}, {fp['near']} magnitudes near the "
            f"threshold")
    if run["ledger"]:
        print(f"tp {name} WireLedger over {TP_LEDGER_STEPS} steps: card "
              f"(rank 0) {json.dumps(zero['ledger'])}, numpy route (rank 1) "
              f"{json.dumps(ranks[1]['ledger'])}; pack_chunks launches "
              f"{zero['ledger_packs']} on the card route, "
              f"{ranks[1]['ledger_packs']} on the numpy route")
        require(zero["ledger"] == ranks[1]["ledger"],
                "the card's ledger differs from the numpy route's")
        require(zero["ledger_packs"] >= 2 * TP_LEDGER_STEPS
                and ranks[1]["ledger_packs"] == 0,
                f"the ledgers launched pack_chunks {zero['ledger_packs']} "
                f"and {ranks[1]['ledger_packs']} times")
    tp_serve_report(ranks, name)
    step_ms = [1e3 * statistics.median(out["step_s"][1:]) for out in ranks]
    sgd_ms = [1e3 * statistics.median(out["local_sgd_s"]) for out in ranks]
    print(f"tp {name} step ms a rank (median of steps 2-{TP_STEPS}) "
          f"{step_ms}, local_sgd ms {sgd_ms}; device ms of one step "
          f"{[round(o['device_ms'], 3) for o in ranks]}, idle share "
          f"{[round(1 - o['device_ms'] / ms, 3) for o, ms in zip(ranks, step_ms)]}"
          f"; peak GiB {[round(o['peak_gib'], 3) for o in ranks]}; card: "
          f"{card_line()}")
    print(f"phase 16 {name} took {time.perf_counter() - t0:.1f} s")
    path = run["path"]
    return ({path: {n: zero["launches"][n] for n in MESH_KERNELS},
             f"{path}_serve": zero["serve"]["launches"]},
            zero["kernel_rows"], zero["kernel_errs"])


def tp_serve_report(ranks, name):
    """16i-k's records of a run's ranks: every logits tensor bitwise equal
    across them; the prefill's and each decode step's times, the device
    time and idle share, what a step hands gloo."""
    serve = [out["serve"] for out in ranks]
    for r, sv in enumerate(serve[1:], 1):
        require(sv["digests"] == serve[0]["digests"],
                f"rank {r}'s serve logits differ from rank 0's: " +
                ", ".join(k for k in serve[0]["digests"]
                          if serve[0]["digests"][k] != sv["digests"].get(k)))
    fp, bf = serve[0]["fp32"], serve[0]["bf16"]
    print(f"tp {name} serve fp32 ({SERVE_BATCH} x {TP_SERVE_PROMPT}-token "
          f"prompt, {TP_SERVE_GREEDY} greedy steps) against model = 1 on the joined "
          f"weights: prefill max |gap| {fp['prefill_gap']:.3e}, decode "
          f"{max(fp['decode_gaps']):.3e} (max |logit| "
          f"{fp['max_logit']:.4f}; tolerance {CARD_CPU_TOL}); greedy tokens "
          f"checked {fp['greedy_checked']} of {fp['greedy_steps']} (top-2 "
          f"gap above twice the tolerance), all equal")
    print(f"tp {name} serve bf16 prefill {TP_SERVE_BF16} against its "
          f"decode: last "
          f"logits max |gap| {bf['gap']:.4f} of max |logit| "
          f"{bf['max_logit']:.4f}, {bf['gap'] / bf['max_logit']:.4f} of it "
          f"(tolerance {BF16_TOL}); argmax equal in {bf['argmax_equal']} of "
          f"{bf['rows']} rows; every logits tensor bitwise equal on the "
          f"{len(serve)} ranks ({len(serve[0]['digests'])} tensors)")
    for r, sv in enumerate(serve):
        t = sv["timed"]
        ms = statistics.median(t["decode_ms"])
        b, s = TP_DECODE
        print(f"tp {name} serve rank {r}: caches at batch {b}, {s} slots: "
              f"{t['cache_requested']} bytes requested, {t['cache_allocated']}"
              f" allocated, stand-ins {t['cache_stand_ins']} "
              f"({t['cache_heads']} KV heads a layer); prefill {TP_PREFILL} "
              f"bf16 {t['prefill_ms']:.1f} ms (median of 3), "
              f"{TP_PREFILL[0] * TP_PREFILL[1] / t['prefill_ms'] * 1e3:.0f} "
              f"tokens/s, gloo {json.dumps(t['prefill_gloo'])} "
              f"({t['prefill_gloo_ms']:.1f} ms inside the calls); decode "
              f"{ms:.2f} ms a step (median of {DECODE_TIMED}; steps "
              f"{json.dumps([round(x, 2) for x in t['decode_ms']])}), "
              f"{b / ms * 1e3:.0f} tokens/s; device {t['device_ms']:.2f} ms "
              f"a step, idle share {max(0.0, 1 - t['device_ms'] / ms):.3f}; "
              f"bound {t['bound_ms']:.3f} ms (the rank's cache "
              f"{t['cache_bytes'] / 1e9:.3f} GB + fp32 weights "
              f"{t['weight_bytes'] / 1e9:.3f} GB; the ranks share the card), "
              f"{ms / t['bound_ms']:.1f}x it; {t['decode_collectives']} "
              f"collectives a step, gloo {json.dumps(t['decode_gloo'])} "
              f"({t['decode_gloo_ms']:.1f} ms inside the calls; dry run: "
              f"{json.dumps(t['dryrun_decode'])}); no host sync but gloo's "
              f"staging and {t['decode_reads']} reads of MoE group sizes; "
              f"{sv['seconds']:.1f} s (stages "
              f"{json.dumps(sv['stages'])}); card: {card_line()}")


# ------------------------------------------------------------------- main

def main() -> int:
    # cuBLAS's deterministic workspace, for the mesh trainer's bitwise ranks
    # (phase 11); read when cuBLAS first starts, so set before torch loads
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import repro_torch.kernels as rk
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    alone = {"--signsgd-round": lambda: signsgd_round_only(torch, np),
             "--paper-codecs": lambda: run_paper_codecs(torch, np, rk),
             "--buffered": lambda: run_buffered(torch, np, rk),
             "--chunked": lambda: run_chunked(torch, np, rk),
             "--events": lambda: run_events(torch, np, rk),
             "--mesh": lambda: run_mesh(torch, np, rk),
             "--serve": lambda: run_serve(torch, np, rk),
             "--moe": lambda: run_moe(torch, np, rk),
             "--zoo": lambda: run_zoo(torch, np, rk),
             "--dryrun": lambda: run_dryrun(torch, np, rk),
             "--tensor-parallel": lambda: run_tensor_parallel(torch, np, rk),
             "--drift-witness": lambda: drift_witness(torch, np, rk),
             "--select-passes": lambda: select_passes(torch, rk),
             "--select-study": lambda: select_study(torch, rk),
             "--wire-passes": lambda: wire_passes(torch, np, rk),
             "--wire-study": lambda: wire_study(torch, np, rk)}
    flags = sys.argv[1:]
    if flags == [flag for _, flag, _ in PASS_FLAGS] or (
            len(flags) == 1 and flags[0] in alone):
        try:
            for flag in flags:
                alone[flag]()
            return 0
        except ProfilerBlind as exc:
            traceback.print_exc()
            print(f"chip_smoke: the profiler was blind: {exc}",
                  file=sys.stderr)
            return BLIND_RC
        except (Failure, RuntimeError, subprocess.SubprocessError) as exc:
            traceback.print_exc()
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; options: "
              f"{', '.join(alone)}", file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        rk.build_all()
        print(f"build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc, one process per source)")
        print_build_notes()
        errs = check_kernels(torch, np, rk)
        print(f"kernel checks passed: {json.dumps(errs)}")
        tr, launches, shapes = run_trainers(torch, rk)
        last = check_lockstep(torch, np, rk, tr)
        chunks = upstream_chunks(np, last)
        errs["pack_chunks"] = max(errs["pack_chunks"], check_pack_chunks(
            torch, np, rk, *chunks))
        print(f"pack_chunks on a lock-step round's upstream batch "
              f"({len(chunks[0])} chunks, {chunks[3] // 32} words): words "
              f"identical to its plain version and the host packer")
        errs["bin_select"] = max(errs["bin_select"],
                                 check_carried_selection(torch, rk, last))
        tr_in, launches_in, shapes_in = run_trainers(torch, rk, ingest=True)
        _, batch_in = check_ingest_lockstep(torch, np, rk, tr_in)
        errs["golomb_decode"] = max(errs["golomb_decode"],
                                    check_golomb_at_path(
                                        torch, np, rk, tr_in.protocol,
                                        batch_in))
        launches_sg, shapes_sg, signsgd = check_signsgd_ingest(torch, np,
                                                              rk)
        msgs_sg = signsgd["msgs"].cpu().numpy()
        errs["pack_sign_planes"] = max(
            errs["pack_sign_planes"],
            check_pack_sign_planes(torch, np, rk, msgs_sg))
        words_sg = signsgd["batch"].words.reshape(msgs_sg.shape[0], -1)
        errs["sign_plane_tally"] = max(
            errs["sign_plane_tally"], check_sign_plane_tally(
                torch, np, rk, np.random.default_rng(4), words_sg,
                signsgd["weights"]))
        print(f"pack_sign_planes at the signSGD path's "
              f"{shapes_sg['pack_sign_planes']} and sign_plane_tally at its "
              f"{shapes_sg['sign_plane_tally']}, on a lock-step round's "
              f"messages and words: identical to their plain versions and "
              f"the host packer and accumulator")
        launches_bis, shapes_bis = run_bisection(torch, np, rk)
        launches = {**launches,
                    "golomb_decode": launches_in["golomb_decode"],
                    "unpack_bits": launches_sg["unpack_bits"],
                    "pack_bits": launches_sg["pack_bits"],
                    "pack_sign_planes": launches_sg["pack_sign_planes"],
                    "sign_plane_tally": launches_sg["sign_plane_tally"],
                    "threshold_stats": launches_bis["threshold_stats"],
                    "bisect_select": launches_bis["bisect_select"]}
        shapes = {**shapes,
                  "pack_sign_planes": shapes_sg["pack_sign_planes"],
                  "sign_plane_tally": shapes_sg["sign_plane_tally"],
                  "bisect_select": shapes_bis["bisect_select"]}
        rows = time_kernels(torch, np, rk, shapes, launches, errs, last,
                            batch_in, signsgd)
        time_round(torch, np, tr)
        time_ingest_round(torch, np, tr_in)
        time_decode_split(torch, np, rk, tr_in.protocol, batch_in)
        time_signsgd_round(torch, np, signsgd["trainer"])
        codecs = run_paper_codecs(torch, np, rk)
        buffered = run_buffered(torch, np, rk)
        chunked, chunked_ms, chunked_errs = run_chunked(torch, np, rk)
        events = run_events(torch, np, rk)
        mesh, mesh_ms, mesh_errs, trained = run_mesh(torch, np, rk)
        serve = run_serve(torch, np, rk, trained)
        del trained
        torch.cuda.empty_cache()
        moe, moe_ms, moe_errs = run_moe(torch, np, rk)
        zoo, zoo_ms, zoo_errs = run_zoo(torch, np, rk)
        dry = run_dryrun(torch, np, rk)
        tp, tp_ms, tp_errs = run_tensor_parallel(torch, np, rk)
        # launches on the paths of phases 7 to 16, beside each kernel's
        # main-path count; the kernels' times at the chunked shapes and at
        # the mesh paths' rows
        for row in rows:
            name = {"magnitude_histogram": "histogram"}.get(row["name"],
                                                            row["name"])
            row["launches_other_paths"] = {
                path: runs[path][0][name]
                for runs in (codecs, buffered) for path in runs
                if runs[path][0].get(name)}
            row["launches_other_paths"].update({
                path: counts[name]
                for runs in (chunked, events, mesh, serve, moe, zoo, dry,
                             tp)
                for path, counts in runs.items() if counts.get(name)})
            for keys in (chunked_ms, mesh_ms, moe_ms, zoo_ms, tp_ms):
                row.update(keys.get(name, {}))
            for errs_of in (chunked_errs, mesh_errs, moe_errs, zoo_errs,
                            tp_errs):
                if name in errs_of:
                    row["max_abs_err"] = max(row["max_abs_err"],
                                             errs_of[name])
        for row in rows:
            require(all(isinstance(row[f], (int, float)) and math.isfinite(
                row[f]) for f in ("ms", "plain_ms", "bound_ms")),
                f"missing timing for {row['name']}")
        card = card_line()
    except (Failure, RuntimeError, subprocess.SubprocessError) as exc:
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"tf32: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
