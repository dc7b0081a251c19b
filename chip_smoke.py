"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and exits non-zero; nothing is caught):

  0. the card's name and power limit; build the four CUDA kernels from
     ``src/repro_torch/csrc`` (one nvcc per source, started together).
  1. each kernel against its plain torch version on the card, at the
     main paths' shapes and at edge shapes (impact_scan and topk
     bit-equal, topk's tie-heavy stage-1 rows, signed zeros and -inf
     scores and impact_scan's doc ranges wider than one block included;
     flash_attention within 2e-5 in float32 and 2e-2 in bfloat16;
     embedding_bag within rtol 1e-5 / atol 1e-6 in float32, and whether
     it was bit-equal, and bit-equal in bfloat16); CUDA-event times of one
     call of the kernel, of the
     plain version and of one library call on an idle card, the host's
     work in the call included (``ms``, ``plain_ms``, ``library_ms``),
     the kernel's time over the library call's and its share of the
     bound; beside them the device time alone and the host time alone
     of the kernel's call and the library call (a sleep kernel holds the
     card while each call is enqueued: ``device_ms``,
     ``library_device_ms``, ``host_ms``, ``library_host_ms``); the
     registers, shared memory and spills ptxas reported for each kernel
     function.  flash_attention is checked folded (BH, S, hd) and in
     BST's (B, S, H, hd) layout read in place (strided, sliced, GQA and
     broadcast operands too, each call one launch with a contiguous
     output); its ``path`` field times the path's call, ``ops`` on
     BST's views, at the labelling and the served shape (``ms``,
     ``device_ms``, ``host_ms``; SDPA on the same views as
     ``library_ms``; ``fold_ms``, the four copies the fold made before),
     ``routes``
     names the route the launcher took for each checked call, and
     ``general`` times the general path (float32, the CUDA-core route)
     at one LM shape; the tensor-core route is held at ragged S (1, 63,
     65, 127, 129, 200, 640), GQA groups 1, 4, 7, 8, hd 64 and 128,
     causal, non-causal and windowed, and on q, k, v sliced from one
     fused projection; two ``phase 1: LM shape`` lines hold it at
     tinyllama-1.1b's and qwen3-4b's prefill shapes (B 8, S 4096, Hq 32,
     Hkv 4 / 8, hd 64 / 128, bf16, causal, through
     ``flash_attention_bshd``, one launch of ``general_tc`` a call, no
     spills) within 2e-2 of the plain version run row by row, with one
     call's time, the device time alone, the plain version's, SDPA's
     (``enable_gqa``) and the bound at the bf16 tensor-core peak.
     impact_scan and topk are also held, bit-equal, at the continuous
     scheduler's shapes
     (a ``phase 1: continuous path's shape`` line each, with the same
     times and bound): impact_scan on one chunk window of the slot table
     ((32, 512) postings, 50 000 docs, per-slot rho in [0, 512], idle
     slots at rho 0 with the empty bounds (n_docs, -1), ``chunk_ms`` the
     whole chunk stage with its ``acc + inc``), topk on one finalize
     group ((8, 50 000), kp 100).  A ``phase 1: LM training shape`` line
     trains flash at tinyllama-1.1b's train_4k attention (B 8, S 4096,
     Hq 32, Hkv 4, hd 64, bf16, causal) through ``ops.FlashAttention``:
     one ``general_tc`` forward, the backward by query blocks of 512
     (``flash_attention_bwd_blocked``), SDPA's forward + backward as the
     library call, the forward's and the backward's bounds (bf16 tensor
     cores; the backward 2.5x the forward's operations), the backward's
     peak memory above its inputs (held under one float32 (B, Hq, S, S),
     17.2 GB), and dq, dk, dv of all 8 rows within 2^-7 of each
     gradient's largest magnitude of the whole-matrix
     ``flash_attention_bwd``, run one batch row at a time (its ``plain_ms``
     times those 8 calls).
  2. the batch-once serving path at the repo's paper-validation scale
     ("paperish": 50 000 docs, 60 000 terms, 8 000 queries, streams of
     4096): build the system, MED tables and envelope labels, train the
     forest cascades, and serve 4 batches of 128 queries per knob through
     ``RetrievalServer(device="cuda")``, with the kernel launch counters
     zeroed just before and read just after.  The ranked lists are held
     against the per-bucket reference on the card and, for one batch,
     against the same server on the CPU.  Then per knob an ``mlp``
     cascade (``core/mlp.py`` nodes trained on the card on the same
     queries and labels) serves the same batches through
     ``RetrievalServer``: well-formed lists, classes equal to the same
     nodes' ``predict_sequential``, and ``serve_fixed`` at each served
     class's cutoff equal to that class's served lists; the replayed
     predict graphs' classes equal to eager calls of the same stage
     function (the margins' largest gap printed beside).
  3. the recsys funnel at full width (BST ``model_config``, two towers
     over 1 M candidates, pool 1000): label 1024 synthetic requests on
     the card in batches of 128 (gold and per-cutoff runs, MED_RBP,
     envelope labels; the flash_attention launches of labelling are
     counted, one per batch), train the forest cascade on the host.
     Then the funnel's programs are warmed as the service warms a shape
     (``FunnelBackend.warmup_shape``): one CUDA graph a cutoff at 128
     (7; a fresh backend's second warmup builds 0), then 7 more at 64,
     all in the funnel's one graph pool.  Then the counted window: 4
     held-out batches of 128 through ``Funnel(device="cuda").serve`` and
     one more batch, its classes spread over every cutoff (k from 10 to
     the pool of 1000), through ``Funnel.execute``, each a replay of its
     program, with the launch counters zeroed just before and read just
     after (one flash_attention launch a batch, nothing else, no program
     built).  After it, each list is held bit for bit against the stage
     function called eagerly on the same inputs; a few requests of one
     batch against the same funnel on the CPU; the mixed batch against
     each of its requests run alone and against the same batch executed
     on the CPU.  ``phase 3: funnel`` gives the replayed ``serve``'s ms
     and requests/s, and the eager stage's three parts (stage 1, stage
     2, the rank) timed apart, each fenced.  ``phase 3: funnel
     programs``: the build s and the ``memory_reserved`` the pool holds
     after 128 and after 128 and 64, ``serve``'s ms replayed beside
     eager, and the stage at the mixed batch's width: one call's wall,
     device and host ms replayed beside eager.  Last
     (``phase 3: funnel top_k``) stage 1 at batch 128, device ms: the
     scores, then at k 50 and 1000 ``top_k`` beside its earlier form (a
     flag read from the card) and the keyed form, all selecting the same
     ids.
  4. the service layer (``RetrievalService``) on the card.  Over phase
     2's servers, per knob, three fresh services (no census, shape 128
     warmed, launch counters zeroed after the warmup): inline
     (``serve_all`` a batch at a time; ``reset_stats`` after the
     warmup) and FIFO-threaded (all 512
     requests queued, then the workers started, so the batches are phase
     2's) must equal phase 2's ``serve_batch`` output bit for bit, with 4
     engine dispatches a batch and phase 2's launches; threaded as the
     CLI serves (workers running, 100 ms deadlines) must give
     well-formed lists and ``predict_classes``' classes.  Over phase 3's
     funnel and batches, inline and FIFO-threaded must equal
     ``Funnel.serve`` bit for bit through the funnel's programs, one
     flash_attention launch a batch and no program built.
     Every trace must balance and validate.  One ``phase 4:`` line per
     knob and for the funnel: p50/p99 of ``total_ms``, ``queue_ms``,
     ``predict_ms`` and ``service_ms``, q/s, ``deadline_met``, per-stage
     ms from the spans, dispatches and launches, threaded over inline
     q/s, and inline over the same batches served just before by
     ``serve_batch`` / ``Funnel.serve`` (``direct``).  Then ``python -m repro_torch.launch.serve`` runs as a
     subprocess at the verify sizes (batch 30, off the pad grid) and its
     trace and metrics snapshot must be valid.  Then the port's drivers
     of the JAX examples as subprocesses: ``python -m
     repro_torch.examples.serve_retrieval --knob rho`` and ``--online``,
     and ``python -m repro_torch.examples.recsys_funnel``, started
     together: exit 0 and the JAX example's lines in order.
  5. the path's flash_attention call at the labelling and the served
     shape under ``torch.profiler``: its CUDA activities must be the
     kernel alone (after every timed phase, phase 6 included, since the
     profiler is left loaded in the process).  Every profiler window
     is bracketed by two marker kernels and taken again until both show
     (``_profiled``): the card's activities can land off on the host's
     clock, and the profiler drops what falls outside its window.
  7. (run after phase 4) the continuous scheduler on the card, per knob
     over phase 2's servers and 512 requests: ``ContinuousBackend``
     (slots 32, grain 8, chunk 512: 8 chunks a stream) behind
     ``RetrievalService``, fresh and warmed, the launch counters zeroed
     after the warmup.  Inline, every ranked list must equal one
     ``engine.serve`` of the 512 rows bit for bit and every class
     ``predict_classes``'; impact_scan launches must equal the chunk
     dispatches and topk launches the finalizes on ρ (0 on k, whose pool
     of 10 000 takes the plain sort).  FIFO-threaded (all 512 queued,
     then the tick thread started) must give the same lists; the fixed
     arm (ρ at 4096, k at 10 000: the dynamic-vs-fixed race) must equal
     ``serve_fixed``.  One ``phase 7:`` line per knob: slot chunks and
     chunk dispatches of each arm and their ratio, q/s of each arm and
     threaded, p50/p99 ``total_ms``, retire reasons, dispatches, span ms
     by stage, and q/s over ``serve_batch`` of the same 512.
  8. (after phase 7) the online loop at paperish on ρ: a fresh server
     with phase 2's cascade serves 768 ``shifted_queries`` ("long" band)
     in chunks of 128 through a service with a ``TelemetryBuffer``, one
     ``OnlineController.step()`` after each (shadow sample 128, a refit
     every 256 labels, forests of phase 6's size), until it has
     retrained and swapped.  The swapped server's ``serve_batch`` must
     equal a fresh server booted with the trainer's last cascade and the
     store's thresholds, bit for bit; the loop's swaps and serves build
     no predict program (``built("predict:rho")`` the same after the
     warmup and after the loop); the first shadow batch's MED table
     must match the same rows labelled on a CPU server within 1e-5 /
     1e-6, its envelope labels equal except in rows with a cell within
     that tolerance of tau (counted and printed).  The ``phase 8:`` line gives the
     labels, retrains, swaps, host refit seconds, the shadow's ms a
     batch (host clock, fenced by its reads) with its launches, and the
     in-envelope share of the labelled traffic before and after the
     swap.  Then ``python -m repro_torch.launch.serve --online`` runs as
     a subprocess at the verify sizes: exit 0 and its ``online:`` line.
  11. (after phase 8) sharded serving on the card, over phase 2's system,
     cascades and batches, the mesh's positions laid over the one card
     by ``force_host_device_count(4)`` (shards sharing one card measure
     no speed of sharding).  First impact_scan and topk at the shard
     shapes of 4 shards (a ``phase 1: shard shape`` line each, timed as
     phase 1): impact_scan on shard 0's (128, shard_cap) partition of
     batch 0's streams over 12 500 docs with rho from
     ``owned_prefix_len`` of the cascade's rho, topk on the (128, 12 500)
     local scores at kp 100, each bit-equal to its plain version.  Then
     per knob and mesh (model=2, model=4, data=2 x model=2),
     ``RetrievalServer(mesh=...)`` serves the 4 batches with the launch
     counters zeroed just before and read just after: the lists must
     equal phase 2's ``serve_batch`` bit for bit, impact_scan must
     launch shards x data groups times a batch, and topk as often on
     rho (0 on k, whose 10 000-wide pool takes the plain sort).  Each
     ``phase 11:`` line gives the per-stage ms beside phase 2's, q/s, and
     the fullest shard's partition over its stream slot (the
     ``partition_slack`` margin; a slack that overflows is raised in
     steps of 0.25 and printed, not changed in the default).  On
     data=2 x model=2 ``ShardedEngineBackend`` inline (6 dispatches a
     batch) and on model=4 ``ContinuousBackend`` over batch 0's 128
     requests must equal phase 2 bit for bit.  The sharded engine's six
     stages and the sharded scheduler's four run as CUDA graphs of the
     engine's program cache: each line's ``programs`` gives
     ``n_compiles``, the graphs and the programs the batches built once
     the shape was warm (0), and the 4 batches served again replayed and
     with the stage functions called eagerly, both bit-equal to phase
     2, with each one's wall ms; the continuous run likewise (its four
     programs, q/s replayed and eager).  Each mesh's graph pools are
     freed before the next mesh.  Then
     ``python -m repro_torch.launch.serve --shards 2
     --force-host-devices 2`` as a subprocess: exit 0 and its ``mesh:``
     line.
  6. (run between phases 11 and 5) the offline end of the main path on
     the card at paperish, over phase 2's system and MED_RBP tables:
     ``run_methods`` (forests fitted on the host, held-out folds
     predicted on the card, 3 folds, forests of 10 trees of depth 6) in
     Table 6's setting (ρ, every method) and Table 4's (k, the cascade
     only).  Every prediction must lie in [0, c] and every table row
     must equal the row recomputed from the labels or predictions; the
     rows, the wall time and its split into host fitting and fenced
     device prediction are printed.  Fold 0 of ρ is refitted with the
     same seeds: its cascade and MultiLabel classes on the card, on the
     CPU from the same forests and from ``run_methods`` must be equal.
     Then per-node thresholds tuned on fold 0 of ρ, Algorithm 2 (``predict_sequential``) equal to
     ``predict_batched`` on 64 rows at t = 0.8, an MLP cascade trained on
     the card whose classes equal the CPU's from the same parameters,
     and ``python -m repro_torch.examples.quickstart`` with ``--device
     cuda`` and ``--device cpu``, whose tables must be equal.
  12. (after phase 6, before phase 5) training on the card.  Each of
     wide-deep, DIEN, BST and MIND at its full ``model_config()`` runs
     ``python -m repro_torch.launch.train --full --steps 6 --batch 65536
     --device cuda`` (the ``train_batch`` shape) as a subprocess, its
     checkpoints in ``build/phase12_ckpt`` (removed after): every loss
     finite, BST launching flash_attention once a step and the others
     never.  One ``phase 12:`` line per arch: the median step ms over
     steps 2-6 and samples/s, the peak device memory, the step's model
     FLOPs and their rate, the checkpoint's bytes and seconds, the flash
     launches.  BST again with ``--preempt-at 3``: its final checkpoint
     must equal the clean run's bit for bit.  Then in this process:
     BST's gradients at the full config (batch 256) through the kernel
     within 2e-5 of the plain attention's (of each leaf's largest
     magnitude), nonzero for the attention's weights and the item table;
     each arch's smoke config trained 8 steps on the card and on the CPU
     from the same seeded parameters and batches, losses within 1e-5
     relative; the gathers' backward (``scatter_rows``) at DIEN's history
     shape bit-equal twice and within 1e-4 of a float64 sum; and
     flash_attention at the training shape (B = 65 536, 8 heads, S 21,
     hd 4) against its plain version and its backward against autograd,
     with one call's times, SDPA's and the backward's, the whole-matrix
     ``flash_attention_bwd`` and the blocked one training runs (a
     ``phase 1: training shape`` line).
  13. (after phase 12, before phase 5) LM serving on the card:
     tinyllama-1.1b at its full ``model_config()`` (bf16, 22 layers,
     seeded random weights) serves 8 prompts of 4096 tokens from the LM
     token pipeline: 4 prefills (one warm-up), the last one's keys and
     values handed to a cache of 4128, then 32 greedy decode steps, the
     kernel launches counted over that window (flash_attention 22 a
     prefill, each on the tensor-core route: the per-route counter
     must hold all of them under ``general_tc``).  Every logit finite;
     row 0's prefill logits against the plain attention path on the
     card, and decode steps 1 and 32 against
     a prefill of the prompt and the generated tokens, within
     ``LM_ATOL`` with the greedy tokens equal wherever the top-2 margin
     exceeds it.  ``phase 13:`` lines give the draw's host seconds, the
     prefill's ms, tokens/s and model TFLOP/s, the decode step's ms,
     tokens/s, bytes read and GB/s, its host (enqueue) time, the peak
     memory; one step at decode_32k's cache length (32 768) and the
     largest batch of 128, 64, 32 that fits, on a seeded random cache
     (timing only); the five LM archs' smoke configs (float32; deepseek's
     MLA and its latent cache, prefill launching no flash) on the card
     against the CPU port, prefill and 8 decode steps, greedy tokens
     equal and logits within 2e-5; last one step at batch 8 and one
     at decode_32k under the profiler, eager and replayed: CUDA
     activities, device-busy ms and idle share.  The replayed decode
     (``serving.decode.DecodePrograms``: ``decode_step`` as one CUDA
     graph a batch and cache length, the parameters and the cache read
     and written in place): the 32 steps again on a copy of the handed
     cache, the program built at step ``LM_REPLAY_FROM`` on its own
     inputs, every step's token and logits bit-equal to the eager run's
     (``phase 13: decode replayed``: programs built, build s, the
     ``memory_reserved`` the build added, a step's wall and host ms
     beside eager's); at decode_32k the step through its program on the
     same cache, logits bit-equal to the eager step's, with the same
     numbers in the shape's ``replayed`` field.
  15. (after phase 13, before phase 5) GraphSAGE on the card.
     ``minibatch_lg`` at full width: the Reddit-scale graph from
     ``make_graph`` (232 965 nodes, 114 615 892 edges, d 602, 41
     classes, seed 0; host seconds), its CSR built on the card (card
     seconds; ``indptr`` against the host's ``bincount`` and a few
     nodes' neighbour lists against the edge list), then
     ``GNN_STEPS`` AdamW steps (lr 1e-3, weight decay 0, as the
     reference bundle's step) of 1024 seeds at fanout (15, 10):
     sampler, feature gather and step ms (medians of steps 2 on),
     seeds/s, model TFLOP/s by the bundle's ``model_flops``, gathered
     GB/s, peak memory and one profiled iteration's idle share.  Every
     loss finite; one step's loss and gradients on the card against the
     same step on the CPU fed the same blocks (``GNN_LOSS_RTOL``,
     ``GNN_GRAD_RTOL``), and bit-equal gradients from two runs of it.
     ``full_graph_sm`` (2708 nodes, d 1433) and ``molecule`` (128 graphs
     of 30 nodes) at their real sizes: ``GNN_SMALL_STEPS`` steps on the
     card and on the CPU from the same parameters, losses within
     ``GNN_SMALL_RTOL``.  Last the driver, ``python -m
     repro_torch.examples.gnn_sage``, as a subprocess: exit 0 and its
     six accuracy lines.
  16. (after phase 15) the sync sanitizer on the card:
     ``analysis.sanitizers.no_syncs`` armed around one ρ and one k
     batch through the engine's stages (phase 2's servers, batch 2,
     ranked lists equal to phase 2's), one continuous-scheduler chunk
     step with its slots filled, one tinyllama-1.1b ``decode_step``
     at full width (phase 13's parameters and cache), eagerly and
     replayed through its decode program, and one funnel batch at phase
     3's classes, as the stage function called eagerly and replayed
     through ``Funnel.execute``, its lists equal to phase 3's.  One
     ``phase 16:`` line per scope gives its syncs by frame, each ``vetted``,
     ``allowed`` (a fault ROADMAP section 4 lists, ``SYNC_FAULTS``) or
     ``unvetted``; an unvetted sync fails the phase.
  18. (after phase 16) the engine's program cache on the card, over
     phase 2's servers (``ServingEngine._compiled``: a CUDA graph per
     stage and padded shape, ``serving/programs.py``).  Per knob: the
     pad grid (8 to 128 in steps of 8) warmed with the depth variant
     (every one of its 5 stages x 16 shapes a graph; a second warmup
     builds 0), ``n_compiles``, the programs built and the
     ``memory_reserved`` the warmup added; 200 mixed batches (sizes 1 to
     128, classes from the cascade, every other one with a depth vector)
     served through ``engine.serve`` under ``sanitizers.hot_path`` (no
     program built, no unvetted sync), each list equal bit for bit to
     eager calls of the same module-level stage functions, as at every
     padded shape with and without depth; per-stage span ms, stage host
     ms (a sleep kernel holding the card) and ``serve``'s wall ms at
     batch 128, replayed beside eager; then phase 7's continuous path on
     the graphs (512 requests inline), its lists equal to an eager
     batch-once serve of the 512.  One ``phase 18: programs`` line per
     knob.
  19. (after phase 18) the server's predict programs on the card
     (``RetrievalServer.predict_programs``: features + cascade + first
     firing node, and the margin, each a CUDA graph a knob and padded
     shape, the node tables copied in).  Per knob, a fresh
     server on phase 2's cascade: the predict and margin grid (8 to 128
     in steps of 8, 32 graphs) warmed, with the programs built, each
     build's seconds, the warmup's seconds and the ``memory_reserved``
     it added, a second warmup building 0; 200 mixed predicts (sizes 1
     to 128) under ``sanitizers.hot_path`` on the predict cache (no
     program built, no unvetted sync), each equal bit for bit to an
     eager call of the same stage function, as are classes and margins
     at every padded shape; at batch 128 the predict's host ms (a sleep
     kernel holding the card), CUDA-event ms and wall ms (queries in,
     classes out), replayed beside eager.  One ``phase 19: predict
     programs`` line per knob, then one line of the predict numbers the
     serving phases printed (phase 2's ``predict_ms`` and ``total_ms``,
     phase 4's ``predict_ms`` p50/p99, phase 7's q/s over
     ``serve_batch``'s, phase 8's predict builds around its swaps).
  14. (last, after phase 5 and the profile, so that its numbers are
     its subprocesses' own) LM training on the card.
     ``python -m repro_torch.launch.train --arch tinyllama-1.1b --full
     --batch 8 --seq-len 4096 --steps 6`` as a subprocess (train_4k's
     global batch of 256 cut to 8; checkpoints in
     ``build/phase14_ckpt``, removed after): every loss finite, flash
     launched 44 times a step (each layer's forward and its recompute
     under ``remat="full"``), all ``general_tc``; a ``phase 14: full
     width`` line with the median step ms of steps 2-6, tokens/s, model
     TFLOP/s, peak memory, and the flash backward's device ms a step
     (CUDA events around each backward inside the CLI's steps) and its
     share of the step, beside 22 of phase 1's isolated backward.  Then
     tinyllama's and deepseek's smoke configs (float32), 6 steps of
     batch 8 x 128 through the CLI on the card, on the card preempted at
     step 3, and on the CPU, all started together: losses within 1e-5
     relative card against CPU, the preempted run's final checkpoint
     equal to the clean run's bit for bit; beside them (started
     together) ``python -m repro_torch.examples.train_lm`` (the JAX
     example's command: 200 steps, preempted at 90) must exit 0 after
     one restart.  Last a profiler canary: three known launches must
     show three CUDA activities (``profiler_canary``).
  17. the distribution layer and the dry run (ROADMAP item 7d).
     (a) right after phase 1's timings, ``python -m
     repro_torch.launch.dryrun --all-cells --mesh both --jobs 4``
     starts in a session of its own on the host's CPU (no card
     visible; its log in ``build/phase17_dryrun/log.txt``), and is
     collected after phase 14: 80 records, 72 ``ok`` and 8 ``skipped``,
     none ``error``, no kernel launched in any trace; one ``phase 17:
     dryrun`` line a cell (peak GiB, fits in 80 GiB, dominant roofline
     term, collective GB a device, ops run replicated, trace s); then
     MIND's ``retrieval_cand`` (single pod) again with
     ``REPRO_SHARDED_TOPK=1`` into ``sharded_topk/``: status ``ok``, its
     all-gather bytes a device the default record's less the (1, 1 M)
     float32 scores plus the 16 shards' (1, 1000) values and ids; and
     mixtral-8x22b's and deepseek-v3-671b's ``train_4k`` (single pod)
     with ``REPRO_MOE_SHARDMAP=1``, traced beside the all-cells run in a
     process of its own into ``shard_map/``: both ``ok``, deepseek's
     (256 experts over the 256 positions: the shard_map dispatch) other
     than its default (gspmd) record, with more all-to-all bytes, and
     mixtral's equal to its default (8 experts do not divide over 256
     positions, so the reference's condition keeps the gspmd dispatch);
     one ``phase 17: dryrun hints`` line a record (each collective
     kind's bytes a device and the temp bytes) for tinyllama-1.1b's
     ``train_4k`` and both MoE cells under both dispatches.  After
     phase 16, on the card: (b) the dry run's peak estimate over fake
     CUDA tensors against ``torch.cuda.max_memory_allocated()`` (peak
     stats reset before the step, both above what was allocated before
     its arguments) for tinyllama-1.1b's training step at 8 x 4096, its
     decode step at batch 64 on decode_32k's cache, and BST's training
     step at batch 65 536, within ``MEM_RTOL``; (c) ``moe_ffn_shard_map``
     on mixtral's smoke MoE over a 2 x 2 mesh laid on the card against
     the local path, forward and gradients within 1e-5; (d)
     ``compressed_allreduce`` over 4 positions on the card, bit-equal
     to the CPU; (e) a BST checkpoint restored onto a 2 x 2 mesh on the
     card by ``restore_elastic``, the shards reassembled equal to the
     saved leaves bit for bit; (f) ogb_products' one-card estimate, and
     one full-batch step only if it is under 90% of the card's memory.
  9. one JSON line with every kernel's launches (phases 2 and 3),
     service launches (the inline and FIFO runs of phase 4), continuous
     launches (phase 7's inline runs), online launches (phase 8's shadow
     steps), sharded launches (phase 11's counted windows), error and
     times; impact_scan's and topk's ``continuous`` and ``shard`` fields
     hold their rows at the continuous path's and the shard shape, and
     flash_attention's ``train`` field its row at the training shape with
     the launches of phase 12's clean BST run, and its ``lm`` field its
     row at tinyllama's prefill shape with phase 13's launches
     (``lm_launches`` on every row), and its ``lm_train`` field phase
     1's LM training row with phase 14's full-width launches; a last
     entry, ``flash_attention general_tc``, gives the tensor-core
     kernel's row at that shape with phase 13's launches of its route.
  10. the last line: {"ok": true, "device": {...}}.

With ``--profile DIR``, after phase 5 each knob's server and the funnel
serve their steady batches again, once on the host clock and once under
``torch.profiler``, and one ``profile:`` line each gives the wall ms
per batch, the device-busy ms per batch (the union of the CUDA activity
intervals), the idle share ``1 - busy / wall``, CUDA activities per
batch and the five items with the most device time; the Chrome traces
go to ``DIR/trace_serving_<name>.json``.

Without a CUDA card, or run outside the repository, it fails before
printing any result.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 ops/s outside
#: the tensor cores, dense bf16 tensor-core ops/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
BF16_OPS_S = 989e12
#: clock cycles of the sleep kernel that holds the card while a call
#: timed for its device work alone is enqueued (about 1 ms at the H100's
#: 1.98 GHz boost clock, longer than any timed call's host work)
HOLD_CYCLES = 2_000_000
#: the paper-validation scale, the port's configs/paper_retrieval.py
#: experiment_config("paperish") (the JAX package's numbers)
from repro_torch.configs.paper_retrieval import PAPERISH  # noqa: E402
BATCH, N_BATCHES, RERANK_DEPTH, TAU = 128, 4, 100, 0.05
#: stage-2 tolerance: log/divide in float32 on two devices
STAGE2_RTOL = 1e-6
#: the funnel: requests labelled for training, re-served on the CPU
FUNNEL_TRAIN, FUNNEL_CPU = 1024, 8
#: funnel stage-2 tolerance (absolute; scores lie in about [0, 1.6]):
#: the BST's float32 products add in another order on the card than on
#: the CPU, or at another batch size
FUNNEL_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 25, warm: int = 3, hold: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after
    ``warm`` runs: one call on an idle card, the host's work before each
    launch included.  With ``hold``, a sleep kernel keeps the card busy
    while the host enqueues each run, so the events time the device's
    work alone."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median host wall time of one call of ``fn`` while a sleep kernel
    holds the card, so that no launch waits for the device: the host's
    work in the call alone."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def timings(kernel, plain, library) -> dict:
    """One call's time of the kernel, its plain version and the library
    call on an idle card (``ms``, ``plain_ms``, ``library_ms``); the
    device time alone (``device_ms``, ``library_device_ms``) and the
    host time alone (``host_ms``, ``library_host_ms``) of the kernel's
    call and the library call."""
    return dict(ms=time_ms(kernel), device_ms=time_ms(kernel, hold=True),
                host_ms=host_ms(kernel), plain_ms=time_ms(plain),
                library_ms=time_ms(library),
                library_device_ms=time_ms(library, hold=True),
                library_host_ms=host_ms(library))


def ptxas_summary(report: str) -> list[dict]:
    """Registers, shared memory and spill bytes of each kernel function
    in an ``nvcc -Xptxas -v`` report."""
    funcs, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            funcs.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur.update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem_bytes"] = int(m.group(1)) if m else 0
    return funcs


def bound_ms(n_bytes: float, n_ops: float,
             ops_s: float = FP32_OPS_S) -> tuple[float, str]:
    """The least time of a call that moves ``n_bytes`` and does ``n_ops``
    operations at ``ops_s`` (fp32 by default; ``BF16_OPS_S`` for a bf16
    row), and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- phase 1 --

def _streams(q, p, n_docs, seed, *, pad_rows=()):
    """Impact-ordered synthetic streams: random docs, integer impacts in
    descending order, a -1 padded tail of random length per query."""
    import numpy as np
    r = np.random.default_rng(seed)
    docs = r.integers(0, n_docs, (q, p)).astype(np.int32)
    imps = -np.sort(-r.integers(0, 256, (q, p)), axis=1).astype(np.float32)
    live = r.integers(p // 4, p + 1, q)
    tail = np.arange(p)[None, :] >= live[:, None]
    docs[tail], imps[tail] = -1, -1.0
    for row in pad_rows:
        docs[row], imps[row] = -1, -1.0
    return docs, imps


def check_impact_scan(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.impact_scan import kernel as K
    from repro_torch.retrieval.index import block_doc_bounds

    max_err = 0.0

    def run(q, p, n_docs, rho, bp, bd, stats, pad_rows=()):
        nonlocal max_err
        docs, imps = _streams(q, p, n_docs, seed=q * p + n_docs,
                              pad_rows=pad_rows)
        d, i = torch.from_numpy(docs).to(dev), torch.from_numpy(imps).to(dev)
        r = torch.from_numpy(np.asarray(rho, np.int32)).to(dev)
        lo, hi = block_doc_bounds(d, block_p=bp, n_docs=n_docs)
        args = (d, i, r, lo, hi)
        kw = dict(n_docs=n_docs, block_p=bp, block_d=bd, with_stats=stats)
        got, want = K.impact_scan(*args, **kw), K.impact_scan_plain(*args, **kw)
        got, want = (got, want) if stats else ((got,), (want,))
        for g, w in zip(got, want):
            max_err = max(max_err, float((g - w).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"impact_scan differs from its plain version at "
                    f"Q={q} P={p} n_docs={n_docs} bp={bp} bd={bd}")
        return args, kw

    q, p, n_docs = BATCH, PAPERISH["stream_cap"], PAPERISH["n_docs"]
    cuts = [max(8, int(f * p)) for f in
            (0.002, 0.004, 0.01, 0.02, 0.04, 0.1, 0.2, 0.4, 1.0)]
    rho = np.resize(cuts, q)
    main_args, main_kw = run(q, p, n_docs, rho, 512, 2048, False)
    run(q, p, n_docs, rho, 512, 2048, True)
    # edge shapes: ragged P, rho 0 and rho > P, all-padding streams,
    # doc tiles that do not divide n_docs, one posting block
    run(5, 1000, 3001, [0, 1, 999, 5000, 512], 512, 2048, True,
        pad_rows=(3,))
    run(3, 65, 40, [0, 64, 65], 32, 16, True, pad_rows=(0,))
    run(2, 4096, 50_000, [4096, 300], 4096, 16384, True)
    run(1, 7, 5, [7], 512, 2048, True)
    # more docs than one block's shared memory holds (three tiles a
    # query), and a stats tile (block_d) that divides neither n_docs nor
    # the kernel's doc tile
    run(6, p, 120_000, [0, 1, p // 2, p, p + 50, 300], 512, 2048, True,
        pad_rows=(3,))
    run(4, p, n_docs, [p, 1000, 9, 0], 512, 777, True)

    d, i, r, lo, hi = main_args
    live = int(torch.minimum(r.long(), torch.full_like(r.long(), p)).sum())
    flat = (torch.arange(q, device=dev)[:, None] * n_docs
            + d.clamp(min=0).long()).reshape(-1)
    pos = torch.arange(p, device=dev)[None, :]
    contrib = torch.where((pos < r[:, None]) & (d >= 0), i,
                          torch.zeros_like(i)).reshape(-1)
    acc = torch.zeros(q * n_docs, device=dev)

    def library():
        acc.zero_()
        acc.scatter_add_(0, flat, contrib)

    n_p = lo.shape[1]
    n_bytes = live * 8 + q * 4 + 2 * q * n_p * 4 + q * n_docs * 4
    b_ms, b_by = bound_ms(n_bytes, live)
    return dict(
        name="impact_scan", route="cuda",
        source="src/repro_torch/csrc/impact_scan.cu",
        replaces="src/repro/kernels/impact_scan/kernel.py:158",
        max_abs_err=max_err,
        **timings(lambda: K.impact_scan(*main_args, **main_kw),
                  lambda: K.impact_scan_plain(*main_args, **main_kw),
                  library),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"Q={q} P={p} n_docs={n_docs} block_p=512 block_d=2048",
        bytes=n_bytes), K.impact_scan(*main_args, **main_kw)


def check_topk(dev, stage1_acc):
    import numpy as np
    import torch
    from repro_torch.kernels.topk import kernel as K
    from repro_torch.kernels.topk import ops
    from repro_torch.kernels.topk.edge_scores import KINDS, edge_scores

    max_err = 0.0

    def run(scores, kp, bn, vs_ref=True):
        nonlocal max_err
        gv, gi = K.block_topk(scores, kp=kp, block_n=bn)
        wv, wi = K.block_topk_plain(scores, kp=kp, block_n=bn)
        if not (torch.equal(gv.view(torch.int32), wv.view(torch.int32))
                and torch.equal(gi, wi)):
            raise AssertionError(f"block_topk differs from its plain "
                                 f"version at {tuple(scores.shape)} "
                                 f"kp={kp} bn={bn}")
        fin = torch.isfinite(wv)
        if fin.any():
            max_err = max(max_err, float((gv[fin] - wv[fin]).abs().max()))
        if vs_ref:      # with at least kp finite scores a row, the
            # merged selection is the exact top-k
            sv, si = ops.topk_select(scores, kp, block_n=bn)
            rv, ri = ops.topk_select(scores, kp, use_kernel=False)
            if not (torch.equal(si, ri) and torch.equal(sv, rv)):
                raise AssertionError("topk_select differs from topk_ref")

    q, n, k = stage1_acc.shape[0], stage1_acc.shape[1], RERANK_DEPTH
    run(stage1_acc, k, 4096)                # the main path's input
    r = np.random.default_rng(4)
    ties = torch.from_numpy(np.round(r.normal(size=(9, 50_000)) * 3)
                            .astype(np.float32)).to(dev)
    for kp in (1, 128):
        run(ties, kp, 4096)
    run(ties[:, :5], 3, 2)                  # kp wider than the block
    run(ties[:2, :4999], 100, 1024)         # ragged last block
    run(ties, k, 32_768)                    # the widest block
    minf = torch.from_numpy(edge_scores("all_neg_inf", 2, 300, 0)).to(dev)
    run(minf, 7, 128, vs_ref=False)         # nothing but -inf
    # tie-heavy stage-1 rows, signed zeros and -inf among finite scores
    # (edge_scores.py); the merged selection is exact where each row has
    # at least kp finite scores
    for kind in KINDS:
        for bn in (4096, 32_768):
            rows = torch.from_numpy(edge_scores(kind, 9, 50_000, bn)).to(dev)
            run(rows, k, bn, vs_ref=kind in ("stage1", "signed_zeros"))

    n_b = -(-n // 4096)
    n_bytes = q * n * 4 + q * n_b * k * 8
    b_ms, b_by = bound_ms(n_bytes, q * n)
    return dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk/kernel.py:94",
        max_abs_err=max_err,
        **timings(lambda: K.block_topk(stage1_acc, kp=k, block_n=4096),
                  lambda: K.block_topk_plain(stage1_acc, kp=k, block_n=4096),
                  lambda: torch.topk(stage1_acc, k, dim=1)),
        bound_ms=b_ms, bound_by=b_by,
        select_ms=time_ms(lambda: ops.topk_select(stage1_acc, k)),
        shape=f"Q={q} N={n} kp={k} block_n=4096", bytes=n_bytes)


#: the continuous scheduler's geometry at paperish: slots, refill and
#: finalize grain (the pad multiple), chunk length (stream_cap / 8) and
#: the segment-bound block (``SchedPrograms.bounds_p``)
SLOTS, GRAIN, CHUNK_P = 32, 8, 512


def check_impact_scan_chunk(dev) -> dict:
    """impact_scan at one chunk dispatch of the slot table: (SLOTS,
    CHUNK_P) windows over 50 000 docs, per-slot rho in [0, CHUNK_P], idle
    slots at rho 0 with the empty bounds (n_docs, -1).  Bit-equal to its
    plain version; ``chunk_ms`` times the whole chunk stage (window
    gathers, the kernel and ``acc + inc``) as the scheduler runs it."""
    import numpy as np
    import torch
    from repro_torch.kernels.impact_scan import kernel as K
    from repro_torch.retrieval.index import block_doc_bounds
    from repro_torch.serving import engine

    q, p, n_docs = SLOTS, CHUNK_P, PAPERISH["n_docs"]
    idle = (3, 11, 12, 29)
    docs, imps = _streams(q, p, n_docs, seed=17, pad_rows=idle)
    rho = np.random.default_rng(18).integers(0, p + 1, q).astype(np.int32)
    rho[list(idle)] = 0
    d, i = torch.from_numpy(docs).to(dev), torch.from_numpy(imps).to(dev)
    r = torch.from_numpy(rho).to(dev)
    lo, hi = block_doc_bounds(d, block_p=p, n_docs=n_docs)
    if not (bool((lo[list(idle)] == n_docs).all())
            and bool((hi[list(idle)] == -1).all())):
        raise AssertionError("idle slots must carry the empty bounds")
    args = (d, i, r, lo, hi)
    kw = dict(n_docs=n_docs, block_p=p, block_d=2048)
    got, want = K.impact_scan(*args, **kw), K.impact_scan_plain(*args, **kw)
    if not torch.equal(got, want):
        raise AssertionError("impact_scan differs from its plain version "
                             "at the chunk window")
    live = int(torch.minimum(r.long(), (d >= 0).sum(1)).sum())
    flat = (torch.arange(q, device=dev)[:, None] * n_docs
            + d.clamp(min=0).long()).reshape(-1)
    pos = torch.arange(p, device=dev)[None, :]
    contrib = torch.where((pos < r[:, None]) & (d >= 0), i,
                          torch.zeros_like(i)).reshape(-1)
    acc = torch.zeros(q * n_docs, device=dev)

    def library():
        acc.zero_()
        acc.scatter_add_(0, flat, contrib)

    # the chunk stage over a full table of 4096-wide streams
    ds_b, im_b = (torch.from_numpy(a).to(dev) for a in _streams(
        q, PAPERISH["stream_cap"], n_docs, seed=19, pad_rows=idle))
    lo_b, hi_b = block_doc_bounds(ds_b, block_p=p, n_docs=n_docs)
    acc_b = torch.zeros((q, n_docs), device=dev)
    pos_b = torch.from_numpy((np.arange(q) % 8 * p).astype(np.int32)).to(dev)
    end_b = pos_b + r

    def chunk_stage():
        return engine._sched_chunk(ds_b, im_b, lo_b, hi_b, acc_b, pos_b,
                                   end_b, chunk_p=p, bounds_p=p,
                                   n_docs=n_docs, block_d=2048)

    n_bytes = live * 8 + q * 4 + 2 * q * 4 + q * n_docs * 4
    b_ms, b_by = bound_ms(n_bytes, live)
    return dict(
        name="impact_scan", route="cuda",
        shape=f"Q={q} P={p} n_docs={n_docs} block_p={p} block_d=2048, "
              f"{len(idle)} idle slots",
        max_abs_err=float((got - want).abs().max()),
        **timings(lambda: K.impact_scan(*args, **kw),
                  lambda: K.impact_scan_plain(*args, **kw), library),
        bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
        chunk_ms=time_ms(chunk_stage),
        chunk_device_ms=time_ms(chunk_stage, hold=True))


def check_topk_finalize(dev, stage1_acc) -> dict:
    """topk at one ρ finalize group: (GRAIN, 50 000) stage-1 rows, kp =
    the rerank depth.  Bit-equal to its plain version, and the merged
    selection equal to the plain stable sort."""
    import torch
    from repro_torch.kernels.topk import kernel as K
    from repro_torch.kernels.topk import ops

    rows = stage1_acc[:GRAIN].contiguous()
    k = RERANK_DEPTH
    gv, gi = K.block_topk(rows, kp=k, block_n=4096)
    wv, wi = K.block_topk_plain(rows, kp=k, block_n=4096)
    if not (torch.equal(gv.view(torch.int32), wv.view(torch.int32))
            and torch.equal(gi, wi)):
        raise AssertionError("block_topk differs from its plain version at "
                             "the finalize group")
    sv, si = ops.topk_select(rows, k)
    rv, ri = ops.topk_select(rows, k, use_kernel=False)
    if not (torch.equal(sv, rv) and torch.equal(si, ri)):
        raise AssertionError("topk_select differs from topk_ref at the "
                             "finalize group")
    fin = torch.isfinite(wv)
    q, n = rows.shape
    n_bytes = q * n * 4 + q * -(-n // 4096) * k * 8
    b_ms, b_by = bound_ms(n_bytes, q * n)
    return dict(
        name="topk", route="cuda", shape=f"Q={q} N={n} kp={k} block_n=4096",
        max_abs_err=float((gv[fin] - wv[fin]).abs().max()),
        **timings(lambda: K.block_topk(rows, kp=k, block_n=4096),
                  lambda: K.block_topk_plain(rows, kp=k, block_n=4096),
                  lambda: torch.topk(rows, k, dim=1)),
        bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
        select_ms=time_ms(lambda: ops.topk_select(rows, k)))


def _bst_qkv(b, bst_cfg, randn):
    """q, k, v as ``bst_logits`` makes them: (B, S, H, hd) views of one
    block's contiguous (B, S, d) products, the weights scaled by d^-0.5
    as ``init_linear`` draws them."""
    s, d = bst_cfg.seq_len + 1, bst_cfg.embed_dim
    x = randn(b, s, d)
    return [(x @ (randn(d, d) * d ** -0.5)).reshape(
        b, s, bst_cfg.n_heads, bst_cfg.head_dim) for _ in range(3)]


#: the profiler places the card's activities on the host's clock and
#: drops what falls outside its window.  After the process sat idle or
#: another process used the card, they landed tens of ms to seconds off
#: (the canary's ``lag_ms``), so a window could lose some or all of them.
#: ``_profiled`` brackets its window with two marker kernels
#: (``torch.cuda._sleep``) and retries, with idle host time (from
#: PROFILE_PAD_S, doubled each try) around the markers, until both show
PROFILE_PAD_S, PROFILE_TRIES, MARK_CYCLES = 0.25, 5, 1000


def _profiled(body) -> tuple:
    """``body()`` under ``torch.profiler`` (CPU and CUDA), bracketed by
    two marker kernels, each after a sync: once both markers show, every
    activity between them is in the window.  Returns the profile, its
    events without the markers, and the tries it took; raises after
    PROFILE_TRIES windows that lost a marker."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def mark():
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    pad = PROFILE_PAD_S
    for tries in range(1, PROFILE_TRIES + 1):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            mark()
            body()
            mark()
            time.sleep(pad)
        events = list(prof.events())
        marks = [e for e in events if e.device_type == DeviceType.CUDA
                 and "spin_kernel" in e.name]
        if len(marks) == 2:
            return prof, [e for e in events if not (
                e.device_type == DeviceType.CUDA
                and "spin_kernel" in e.name)], tries
        pad *= 2
    raise AssertionError(f"the profiler lost a marker kernel in each of "
                         f"{PROFILE_TRIES} windows")


def _cuda_activities(fn, calls: int = 3) -> dict | None:
    """The CUDA activities (kernels, copies, memsets) per call of ``fn``
    over ``calls`` calls, each followed by a sync, under ``torch.profiler``
    (``_profiled``, after one call outside it), their names, the device-busy ms per call (the
    union of their intervals) and the five names with the most device
    ms per call; None if the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType

    def body():
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    events = [e for e in _profiled(body)[1]
              if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    by_name = {}
    for e in events:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / calls
    return dict(per_call=len(events) / calls, names=sorted(by_name),
                busy_ms=_busy_us(events) / 1e3 / calls,
                top_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])


def profiler_canary(dev) -> dict:
    """One known launch, an elementwise multiply of 1 M floats, three
    times under ``_profiled``: it must show one CUDA activity a call, or
    a later profile would read too little.  Returns the tries the window
    took and each kernel's start less its ``aten::mul``'s on the
    profiler's clock (``lag_ms``)."""
    import torch
    from torch.autograd import DeviceType

    x = torch.ones(1 << 20, device=dev)

    def body():
        for _ in range(3):
            x.mul(2)
            torch.cuda.synchronize()

    _, events, tries = _profiled(body)
    cpu = sorted(e.time_range.start for e in events if e.name == "aten::mul")
    gpu = sorted(e.time_range.start for e in events
                 if e.device_type == DeviceType.CUDA)
    if len(gpu) != 3 or len(cpu) != 3:
        raise AssertionError(f"the profiler saw {len(gpu)} CUDA activities "
                             f"of three known launches")
    return dict(cuda_activities=len(gpu), tries=tries,
                lag_ms=[(g - c) / 1e3 for g, c in zip(gpu, cpu)])


def check_flash_attention(dev, bst_cfg, pool: int):
    """The funnel's attention shape at the full pool, as its labelling
    runs give it (BH = batch x pool x heads, S = seq_len + 1, hd =
    head_dim, non-causal): folded (BH, S, hd) and in BST's (B, S, H, hd)
    layout, read in place; strided and GQA operands; and the LM shapes
    of the JAX package's kernel tests, causal and windowed.  Besides the
    folded call's times, ``path`` times the path's call (``ops`` on
    BST's views) at the labelling and the served shape, with SDPA on the
    same views and the four copies the fold made before (``fold_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    routes = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def hold(got, want, what):
        tol = 2e-5 if got.dtype == torch.float32 else 2e-2
        g, w = got.float(), want.float()
        name = str(got.dtype).split(".")[-1]
        errs[name] = max(errs[name], float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version beyond {tol} at {what}")

    def hold_ops(xs, what, **kw):
        before = K.n_launches
        got = ops.flash_attention(*xs, **kw)
        if K.n_launches != before + 1 or not got.is_contiguous():
            raise AssertionError(f"flash_attention at {what}: "
                                 f"{K.n_launches - before} launches, "
                                 f"contiguous {got.is_contiguous()}")
        routes[what] = K.last_route
        hold(got, ops.flash_attention(*xs, use_kernel=False, **kw), what)

    bh = BATCH * pool * bst_cfg.n_heads
    s, hd = bst_cfg.seq_len + 1, bst_cfg.head_dim
    q, k, v = (randn(bh, s, hd) for _ in range(3))
    hold(K.flash_attention_fwd(q, k, v, causal=False),
         K.flash_attention_fwd_plain(q, k, v, causal=False), "funnel")
    part = BATCH * 50 * bst_cfg.n_heads     # a served batch at k = 50
    hold(K.flash_attention_fwd(q[:part], k[:part], v[:part], causal=False),
         K.flash_attention_fwd_plain(q[:part], k[:part], v[:part],
                                     causal=False), "funnel at k = 50")
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    hold(K.flash_attention_fwd(qb, kb, vb, causal=False),
         K.flash_attention_fwd_plain(qb, kb, vb, causal=False),
         "funnel bf16")
    del qb, kb, vb
    # BST's layout, read in place, at the labelling and the served shape
    lab = _bst_qkv(BATCH * pool, bst_cfg, randn)
    srv = [x[:BATCH * 50] for x in lab]
    hold_ops(lab, "bst layout, labelling", causal=False)
    hold_ops(srv, "bst layout, served", causal=False)
    hold_ops([x.to(torch.bfloat16) for x in srv], "bst layout bf16",
             causal=False)
    # strided operands: a transposed view, a sliced batch, a batch
    # stride past S * H * hd, a sliced head dim, broadcast GQA heads
    b, h = 301, bst_cfg.n_heads
    wide = randn(2 * b, s, h, hd)
    hold_ops((randn(b, h, s, hd).transpose(1, 2), wide[::2],
              randn(b + 1, s, h, hd)[1:]), "transposed and sliced",
             causal=False)
    hold_ops((wide[1::2], wide[::2], wide[:b]), "batch stride 2",
             causal=False)
    hold_ops((randn(b, s, h, 2 * hd)[..., hd:], randn(b, s, h, hd),
              randn(b, s, h, 2 * hd)[..., :hd]), "head-dim slice",
             causal=True)
    hold_ops((randn(b, s, h, hd), randn(b, s, 1, hd).expand(b, s, h, hd),
              randn(b, s, 1, hd).expand(b, s, h, hd)), "broadcast heads",
             causal=False)
    for g in (1, 2, 4):
        hold_ops((randn(b, s, 8, hd), randn(b, s, 8 // g, hd),
                  randn(b, s, 8 // g, hd)), f"gqa g={g}", causal=True,
                 window=5)
    for (b, sl, hq, hkv, d) in ((2, 64, 4, 2, 32), (1, 128, 2, 2, 16),
                                (2, 64, 8, 1, 64), (1, 256, 4, 4, 32),
                                (7, 32, 4, 2, 16), (7, 33, 4, 2, 16)):
        xs = (randn(b, sl, hq, d), randn(b, sl, hkv, d), randn(b, sl, hkv, d))
        for causal, window in ((True, None), (False, None), (True, 16)):
            hold_ops(xs, f"{(b, sl, hq, hkv, d)} causal={causal} "
                     f"window={window}", causal=causal, window=window)
        hold_ops(tuple(x.to(torch.bfloat16) for x in xs),
                 f"{(b, sl, hq, hkv, d)} bf16")
    # the tensor-core route (bf16, hd 64 and 128): ragged S around the
    # 64-row warpgroup and the 128-key tile, every GQA group (g = 7:
    # qwen2-0.5b's 14 / 2 heads), causal, non-causal and windowed; then q,
    # k and v sliced from one fused projection
    for d in (64, 128):
        for sl in TC_EDGE_S:
            for g in (1, 4, 7, 8):
                hkv = 1 if g == 8 else 2
                xs = tuple(x.to(torch.bfloat16) for x in (
                    randn(2, sl, g * hkv, d), randn(2, sl, hkv, d),
                    randn(2, sl, hkv, d)))
                for causal, window in TC_EDGE_MASKS:
                    what = (f"{(2, sl, g * hkv, hkv, d)} bf16 causal={causal}"
                            f" window={window}")
                    hold_ops(xs, what, causal=causal, window=window)
                    if routes.pop(what) != "general_tc":
                        raise AssertionError(f"{what} took the "
                                             f"{K.last_route} route")
    fused = randn(2, 300, 8 + 2 * 2, 64).to(torch.bfloat16)
    hold_ops((fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]),
             "fused bf16 projection", causal=True)
    for (n, sl, d, causal, window) in ((3, 300, 128, False, 40),
                                       (5, 7, 8, True, None),
                                       (2, 1, 4, True, 1)):
        xs = tuple(randn(n, sl, d) for _ in range(3))
        hold(K.flash_attention_fwd(*xs, causal=causal, window=window),
             K.flash_attention_fwd_plain(*xs, causal=causal, window=window),
             f"({n}, {sl}, {d}) causal={causal} window={window}")
    for what, want in (("bst layout, labelling", "short_bulk"),
                       ("transposed and sliced", "short_loads"),
                       ("batch stride 2", "short_bulk"),
                       ("(7, 33, 4, 2, 16) bf16", "general"),
                       ("fused bf16 projection", "general_tc")):
        if routes[what] != want:
            raise AssertionError(f"{what} took the {routes[what]} route")

    path = {}
    for name, (qp, kp, vp) in (("labelling", lab), ("served", srv)):
        nb = qp.shape[0]
        q4, k4, v4 = (x.transpose(1, 2) for x in (qp, kp, vp))

        def call(qp=qp, kp=kp, vp=vp, nb=nb):
            return ops.flash_attention(qp, kp, vp, causal=False).reshape(
                nb, s, -1)

        def fold(qp=qp, kp=kp, vp=vp, nb=nb):
            # the copies the path made before: q, k, v folded to
            # (B*H, S, hd), the output's (B, S, H*hd) reshape
            fq, fk, fv = (x.transpose(1, 2).reshape(-1, s, hd)
                          for x in (qp, kp, vp))
            return fq.view(nb, -1, s, hd).transpose(1, 2).reshape(nb, s, -1)

        def sdpa(q4=q4, k4=k4, v4=v4):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  scale=hd ** -0.5)

        t = dict(ms=time_ms(call), device_ms=time_ms(call, hold=True),
                 host_ms=host_ms(call), library_ms=time_ms(sdpa),
                 library_device_ms=time_ms(sdpa, hold=True),
                 fold_ms=time_ms(fold), fold_device_ms=time_ms(fold,
                                                               hold=True))
        n_bytes = 4 * qp.numel() * qp.element_size()
        path[name] = dict(shape=f"B={nb} S={s} H={bst_cfg.n_heads} hd={hd}",
                          route=K.last_route, **t,
                          bound_ms=bound_ms(n_bytes, 4 * nb * bst_cfg.n_heads
                                            * s * s * hd)[0])
    del lab, srv

    q4, k4, v4 = (x.view(bh // bst_cfg.n_heads, bst_cfg.n_heads, s, hd)
                  for x in (q, k, v))
    n_bytes = 4 * bh * s * hd * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * bh * s * s * hd)
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:110",
        max_abs_err=errs["float32"], max_abs_err_bf16=errs["bfloat16"],
        **timings(lambda: K.flash_attention_fwd(q, k, v, causal=False),
                  lambda: K.flash_attention_fwd_plain(q, k, v, causal=False),
                  lambda: F.scaled_dot_product_attention(
                      q4, k4, v4, scale=hd ** -0.5)),
        bound_ms=b_ms, bound_by=b_by, path=path, routes=routes,
        general=time_general(dev),
        shape=f"BH={bh} S={s} hd={hd} float32 non-causal", bytes=n_bytes)


def check_flash_activities(dev, bst_cfg, pool: int) -> dict:
    """The CUDA activities of the path's call (``ops`` on BST's views, as
    ``bst_logits`` makes them) at the labelling and the served shape,
    which must be the flash kernel alone: no copy kernel around it.  It
    runs after phase 3, as ``--profile`` does, so that no phase timed on
    the host follows the profiler in the process."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    lab = _bst_qkv(BATCH * pool, bst_cfg, lambda *shape: torch.randn(
        shape, generator=gen, device=dev))
    out = {}
    for name, (q, k, v) in (("labelling", lab),
                            ("served", [x[:BATCH * 50] for x in lab])):
        def call(q=q, k=k, v=v):
            return ops.flash_attention(q, k, v, causal=False).reshape(
                q.shape[0], q.shape[1], -1)

        activities = _cuda_activities(call)
        if (activities is None or activities["per_call"] != 1
                or any("fa_short_kernel" not in n
                       for n in activities["names"])):
            raise AssertionError(f"the path's call at the {name} shape ran "
                                 f"CUDA activities {activities}, not the "
                                 "kernel alone")
        out[name] = activities
    return out


def time_general(dev) -> dict:
    """flash_attention's general path at one LM shape (BH = 32, S = 2048,
    hd = 64, fp32, causal), folded: held against its plain version at
    2e-5, then one call and the device time alone.  It uses only
    ``flash_attention_fwd`` and its plain version, so it times an older
    tree of the port as well."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((32, 2048, 64), generator=gen, device=dev)
               for _ in range(3))

    def call():
        return K.flash_attention_fwd(q, k, v, causal=True)

    err = float((call() - K.flash_attention_fwd_plain(
        q, k, v, causal=True)).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"flash_attention's general path differs from "
                             f"its plain version by {err}")
    return dict(shape="BH=32 S=2048 hd=64 float32 causal", max_abs_err=err,
                ms=time_ms(call), device_ms=time_ms(call, hold=True))


#: the tensor-core route's edge cases in phase 1: S, and (causal, window)
TC_EDGE_S = (1, 63, 65, 127, 129, 200, 640)
TC_EDGE_MASKS = ((True, None), (False, None), (True, 16), (False, 100))
#: flash_attention at the LM's prefill shapes, (name, B, S, Hq, Hkv, hd):
#: tinyllama-1.1b's (the shape phase 13 launches) and qwen3-4b's
LM_FLASH_SHAPES = (("tinyllama-1.1b prefill", 8, 4096, 32, 4, 64),
                   ("qwen3-4b prefill", 8, 4096, 32, 8, 128))


def check_flash_lm(dev, reports) -> list[dict]:
    """flash_attention's tensor-core route at the LM's prefill shapes, in
    the model layout (``flash_attention_bshd``), bf16, causal, on seeded
    random q, k, v: one launch of ``general_tc`` a call, held within
    2e-2 of the plain version, which runs the batch one row at a time
    (its (B, H, S, S) float32 scores at B = 8 would take 17 GB a
    tensor); one call's time and the device time alone, the plain
    version's and SDPA's time on the same tensors, the bound (bf16
    tensor-core peak for the causal half's 2 B Hq S^2 hd operations) and
    the ptxas line of the instantiation, which must show no spills.
    Prints one ``phase 1: LM shape`` line each and returns the rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

    rows = []
    for name, b, s, hq, hkv, hd in LM_FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(hd)
        q = torch.randn((b, s, hq, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))

        def call(q=q, k=k, v=v):
            return K.flash_attention_bshd(q, k, v, causal=True)

        def plain(q=q, k=k, v=v, b=b):
            return [attention_ref_bshd(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       causal=True) for i in range(b)]

        q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa(q4=q4, k4=k4, v4=v4):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  enable_gqa=True)

        before = K.n_launches
        out = call()
        route, n_calls = K.last_route, K.n_launches - before
        err = max(float((out[i:i + 1].float() - want.float()).abs().max())
                  for i, want in enumerate(plain()))
        lib_err = float((sdpa().transpose(1, 2).float()
                         - out.float()).abs().max())
        if route != "general_tc" or n_calls != 1 or not err <= 2e-2:
            raise AssertionError(f"flash_attention at the {name} shape: "
                                 f"route {route}, {n_calls} launches, {err} "
                                 "from its plain version (2e-2)")
        del out
        n_bytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
        b_ms, b_by = bound_ms(n_bytes, 2 * b * hq * s * s * hd, BF16_OPS_S)
        row = dict(
            name=name, shape=f"B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} bf16 "
                             "causal", route=route, max_abs_err=err,
            library_max_abs_err=lib_err,
            ms=time_ms(call, reps=5, warm=1),
            device_ms=time_ms(call, reps=5, warm=1, hold=True),
            plain_ms=time_ms(plain, reps=3, warm=1),
            plain="the B rows one call each",
            library_ms=time_ms(sdpa, reps=10, warm=2),
            bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
            ptxas=[f for f in ptxas_summary(reports.get("flash_attention",
                                                        ""))
                   if f"fa_tc_kernelILi{hd}E" in f["function"]]
            or "not built here")
        if any(f.get("spill_stores") or f.get("spill_loads")
               for f in row["ptxas"] if isinstance(f, dict)):
            raise AssertionError(f"flash_attention's tensor-core kernel at "
                                 f"hd {hd} spills: {row['ptxas']}")
        row["bound_share"] = b_ms / row["ms"]
        row["device_bound_share"] = b_ms / row["device_ms"]
        row["ms_over_library_ms"] = row["ms"] / row["library_ms"]
        log("phase 1: LM shape: " + json.dumps(row))
        rows.append(row)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    return rows


#: phase 1's LM training line: tinyllama-1.1b's train_4k attention at
#: phase 14's batch (B, S, Hq, Hkv, hd), bf16, causal; the backward's
#: query block (the config's block_q)
LM_TRAIN_SHAPE, LM_TRAIN_BLOCK_Q = (8, 4096, 32, 4, 64), 512
#: the blocked backward against the whole-matrix one, bf16 outputs of
#: float32 sums in another order: two bf16 steps of each gradient's
#: largest magnitude
LM_TRAIN_BWD_RTOL = 2 ** -7


def check_flash_train_lm(dev) -> dict:
    """flash_attention trained at tinyllama-1.1b's training shape
    (LM_TRAIN_SHAPE, bf16, causal) through ``ops.FlashAttention``: one
    forward (one ``general_tc`` launch) and the blocked backward
    (``flash_attention_bwd_blocked``, query blocks of LM_TRAIN_BLOCK_Q);
    SDPA's forward + backward as the library call; the forward's bound
    at the bf16 tensor-core peak and the backward's from its operations
    (five products of the causal half against the forward's two: 2.5x);
    the backward's peak device memory above its inputs, which must stay
    under one float32 (B, Hq, S, S) tensor; and dq, dk, dv of all B rows
    held against the whole-matrix ``flash_attention_bwd`` within
    LM_TRAIN_BWD_RTOL of each gradient's largest magnitude.  The plain
    version runs one batch row at a time, as ``check_flash_lm``'s does:
    at B 8 its float32 (B, Hq, S, S) logits, P, dP and dS would take
    17.2 GB each.  ``max_abs_err`` is the largest absolute difference
    over the three gradients, ``backward_rel_err`` each one's relative
    to its largest magnitude.  Prints the ``phase 1: LM training shape``
    line and returns its row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    b, s, hq, hkv, hd = LM_TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v = randn(b, s, hq, hd), randn(b, s, hkv, hd), randn(b, s, hkv, hd)
    do = randn(b, s, hq, hd)
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    before = K.n_launches
    o = ops.flash_attention(*xs, causal=True, block_q=LM_TRAIN_BLOCK_Q)
    route, n_calls = K.last_route, K.n_launches - before
    if route != "general_tc" or n_calls != 1 or o.grad_fn is None:
        raise AssertionError(f"LM training forward: route {route}, "
                             f"{n_calls} launches")
    o = o.detach()
    for x in xs:
        x.requires_grad_(False)

    def backward():
        return ops.flash_attention_bwd_blocked(
            q, k, v, o, do, causal=True, block_q=LM_TRAIN_BLOCK_Q)

    def plain(i):
        sl = slice(i, i + 1)
        return ops.flash_attention_bwd(q[sl], k[sl], v[sl], o[sl], do[sl],
                                       causal=True)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    grads = backward()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated(dev) - base
    whole_bytes = 4 * b * hq * s * s
    if not all(bool(torch.isfinite(g).all()) for g in grads) \
            or scratch >= whole_bytes:
        raise AssertionError(f"LM training backward: peak {scratch} bytes "
                             f"above its inputs (one float32 (B, Hq, S, S) "
                             f"tensor: {whole_bytes})")
    names = ("dq", "dk", "dv")
    diff, mag = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for i in range(b):
        for n, g, w in zip(names, grads, plain(i)):
            w = w.float()
            diff[n] = max(diff[n], float((g[i:i + 1].float() - w).abs()
                                         .max()))
            mag[n] = max(mag[n], float(w.abs().max()))
        torch.cuda.empty_cache()
    rel = {n: diff[n] / mag[n] for n in names}
    if max(rel.values()) > LM_TRAIN_BWD_RTOL:
        raise AssertionError(f"blocked backward differs from the "
                             f"whole-matrix one: {rel}")
    del grads
    torch.cuda.empty_cache()

    def forward():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        return ops.flash_attention(*xs, causal=True,
                                   block_q=LM_TRAIN_BLOCK_Q)

    q4, k4, v4 = (x.detach().transpose(1, 2) for x in (q, k, v))
    do4 = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        xs = [x.requires_grad_(True) for x in (q4.detach(), k4.detach(),
                                                 v4.detach())]
        out = F.scaled_dot_product_attention(*xs, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, xs, do4)

    fwd_ops = 2 * b * hq * s * s * hd          # the causal half's products
    n_bytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    f_ms, f_by = bound_ms(n_bytes, fwd_ops, BF16_OPS_S)
    bwd_bytes = 2 * (3 * b * s * hq * hd + 4 * b * s * hkv * hd)
    b_ms, b_by = bound_ms(bwd_bytes, 2.5 * fwd_ops, BF16_OPS_S)
    row = dict(
        name="tinyllama-1.1b train", shape=f"B={b} S={s} Hq={hq} "
        f"Hkv={hkv} hd={hd} bf16 causal", route=route,
        max_abs_err=max(diff.values()), backward_rel_err=rel,
        block_q=LM_TRAIN_BLOCK_Q,
        ms=time_ms(forward, reps=5, warm=1),
        backward_ms=time_ms(backward, reps=3, warm=1),
        plain_ms=time_ms(lambda: [plain(i) for i in range(b)], reps=3,
                         warm=1),
        plain="the whole-matrix backward, one batch row at a time",
        library_ms=time_ms(sdpa_fwd_bwd, reps=5, warm=2),
        library="SDPA forward + backward (enable_gqa)",
        library_forward_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), reps=5, warm=2),
        bound_ms=f_ms, bound_by=f_by, backward_bound_ms=b_ms,
        backward_bound_by=b_by, backward_peak_bytes_above_inputs=scratch,
        whole_matrix_float32_bytes=whole_bytes)
    row["fwd_bwd_ms"] = row["ms"] + row["backward_ms"]
    row["fwd_bwd_over_library"] = row["fwd_bwd_ms"] / row["library_ms"]
    row["backward_bound_share"] = b_ms / row["backward_ms"]
    log("phase 1: LM training shape: " + json.dumps(row))
    del q, k, v, o, do, q4, k4, v4, do4, xs
    torch.cuda.empty_cache()
    return row


def check_embedding_bag(dev):
    """262 144 bags of 8 over a 1 000 000 x 32 table (wide_deep's field
    width and vocabulary, the serve_bulk batch) and the JAX benchmark's
    100 000 x 32 table with ids (1024, 8); L = 1, bags of padding only,
    ``mean``, and widths that are not a multiple of 4."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag import ref as R

    max_err, bit_equal = 0.0, True

    def make(v, d, b, l, seed, pad_rows=()):
        r = np.random.default_rng(seed)
        table = r.normal(0, d ** -0.5, (v, d)).astype(np.float32)
        ids = r.integers(0, v, (b, l)).astype(np.int32)
        live = r.integers(0, l + 1, b)         # -1 tails of random length
        ids[np.arange(l)[None, :] >= live[:, None]] = -1
        ids[list(pad_rows)] = -1
        return (torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev))

    def run(table, ids, mean):
        nonlocal max_err, bit_equal
        got = K.embedding_bag_kernel(table, ids, mean=mean)
        want = R.embedding_bag_ref(table, ids, mean=mean)
        max_err = max(max_err, float((got - want).abs().max()))
        bit_equal = bit_equal and torch.equal(got, want)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"embedding_bag differs from its plain "
                                 f"version at {tuple(table.shape)} "
                                 f"{tuple(ids.shape)} mean={mean}")
        empty = (ids < 0).all(dim=1)
        if got[empty].any():
            raise AssertionError("a bag of padding only is not zero")

    table, ids = make(1_000_000, 32, 262_144, 8, seed=1, pad_rows=(0, 5))
    for mean in (False, True):
        run(table, ids, mean)
    bench = make(100_000, 32, 1024, 8, seed=2, pad_rows=(3,))
    for mean in (False, True):
        run(*bench, mean)
    run(*make(100_000, 32, 4096, 1, seed=3), False)
    run(*make(1000, 5, 300, 4, seed=4, pad_rows=(1,)), True)
    run(*make(500, 200, 64, 3, seed=5), False)
    bf16 = check_embedding_bag_bf16(table, ids, make)

    mask = ids >= 0
    flat = ids[mask].long()                    # row-major: slot order
    counts = mask.sum(dim=1)
    offsets = torch.cumsum(counts, 0) - counts
    live = int(counts.sum())
    b, l = ids.shape
    d = table.shape[1]
    n_bytes = live * d * 4 + b * l * 4 + b * d * 4
    b_ms, b_by = bound_ms(n_bytes, live * d)
    return dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:72",
        max_abs_err=max_err, bit_equal=bit_equal,
        **timings(lambda: K.embedding_bag_kernel(table, ids),
                  lambda: R.embedding_bag_ref(table, ids),
                  lambda: F.embedding_bag(flat, table, offsets, mode="sum")),
        bound_ms=b_ms, bound_by=b_by, bf16=bf16,
        shape=f"V=1000000 D=32 B={b} L={l} live={live} sum", bytes=n_bytes)


def check_embedding_bag_bf16(table, ids, make) -> dict:
    """The bfloat16 instantiation: each add rounded to bfloat16, as the
    Pallas kernel accumulates in the table's dtype.  Held bit-equal to
    the plain version, which rounds the same adds in the same order
    (``max_abs_err`` is printed as the reading); at the main shape (the float32 row's table and
    ids cast to bfloat16), the times of the kernel, its plain version
    and ``F.embedding_bag`` on the same bfloat16 table, and the bound
    at 2 bytes an element."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag import ref as R

    max_err = 0.0

    def run(t, i, mean):
        nonlocal max_err
        t = t.to(torch.bfloat16)
        got = K.embedding_bag_kernel(t, i, mean=mean)
        want = R.embedding_bag_ref(t, i, mean=mean)
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"bfloat16 embedding_bag gave {got.dtype}")
        max_err = max(max_err, float((got.float() - want.float()).abs()
                                     .max()))
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"bfloat16 embedding_bag is not bit-equal "
                                 f"to its plain version at {tuple(t.shape)} "
                                 f"{tuple(i.shape)} mean={mean}")

    for mean in (False, True):
        run(table, ids, mean)
    run(*make(100_000, 32, 1024, 8, seed=6, pad_rows=(3,)), True)
    run(*make(1000, 5, 300, 4, seed=7, pad_rows=(1,)), True)
    run(*make(500, 200, 64, 3, seed=8), False)
    run(*make(2000, 8, 99, 20, seed=9), True)

    tb = table.to(torch.bfloat16)
    mask = ids >= 0
    flat = ids[mask].long()
    counts = mask.sum(dim=1)
    offsets = torch.cumsum(counts, 0) - counts
    live = int(counts.sum())
    b, l = ids.shape
    d = tb.shape[1]
    n_bytes = live * d * 2 + b * l * 4 + b * d * 2
    b_ms, b_by = bound_ms(n_bytes, live * d)
    t = timings(lambda: K.embedding_bag_kernel(tb, ids),
                lambda: R.embedding_bag_ref(tb, ids),
                lambda: F.embedding_bag(flat, tb, offsets, mode="sum"))
    return dict(max_abs_err=max_err, **t,
                bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                device_bound_share=b_ms / t["device_ms"])


# ------------------------------------------------------------- phase 2 --

def _stage2(server, qt):
    """The engine's stage-2 scores for one batch (qids = positions)."""
    import torch
    from repro_torch.retrieval import gold, jass
    eng = server.engine
    t = torch.from_numpy(qt).to(eng.device)
    sdocs, s3 = jass.gather_score_streams(eng.offsets, eng.pdoc, eng.pscore,
                                          t, cap=server.cfg.stream_cap)
    acc = jass.scorer_accumulators(sdocs, s3, eng.n_docs,
                                   n_terms=t.shape[1])
    qids = torch.arange(t.shape[0], dtype=torch.int32, device=eng.device)
    return gold.second_stage_scores(*acc, eng.doc_len, qids).cpu().numpy()


def _check_ranked(ranked, n_docs):
    import numpy as np
    if ranked.shape != (BATCH, RERANK_DEPTH):
        raise AssertionError(f"ranked shape {ranked.shape}")
    if ranked.min() < -1 or ranked.max() >= n_docs:
        raise AssertionError("ranked ids out of range")
    for row in ranked:
        docs = row[row >= 0]
        if len(np.unique(docs)) != len(docs):
            raise AssertionError("a ranked list repeats a document")
        if (row[len(docs):] != -1).any():
            raise AssertionError("-1 padding inside a ranked list")


def _compare_within_stage2(name, got, want, s2):
    """Ranked lists equal, or every differing position holds two docs
    whose stage-2 scores agree to STAGE2_RTOL."""
    import numpy as np
    qs, pos = np.nonzero(got != want)
    for q, i in zip(qs, pos):
        a, b = got[q, i], want[q, i]
        if a < 0 or b < 0:
            raise AssertionError(f"{name}: query {q} rank {i}: {a} vs {b}")
        sa, sb = s2[q, a], s2[q, b]
        if abs(sa - sb) > STAGE2_RTOL * max(abs(sa), abs(sb)):
            raise AssertionError(f"{name}: query {q} rank {i}: docs {a}/{b} "
                                 f"stage-2 {sa} vs {sb}")
    return len(qs)


def build_servers():
    """The paperish system, its MED tables and envelope labels, and one
    trained ``RetrievalServer`` per knob on the card.  Cascades train
    on every query but the last ``BATCH * N_BATCHES``, which are served.
    Returns (system, {knob: (server, cascade, config)}, batches,
    {knob: MED_RBP table})."""
    import numpy as np
    from repro_torch.core import cascade as cascade_lib
    from repro_torch.core import experiment as E
    from repro_torch.core import labeling
    from repro_torch.serving import pipeline

    t0 = time.perf_counter()
    cfg = E.ExperimentConfig(**PAPERISH)
    sys_ = E.build_system(cfg, device="cuda")
    log(f"phase 2: build_system paperish {PAPERISH} in "
        f"{time.perf_counter() - t0:.1f} s (nnz={sys_.index.nnz})")
    n_serve = BATCH * N_BATCHES
    n_train = cfg.n_queries - n_serve
    log(f"phase 2: cascades train on queries [0, {n_train}) and serve the "
        f"last {n_serve}")
    servers, meds = {}, {}
    for knob in ("rho", "k"):
        t0 = time.perf_counter()
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        med = meds[knob] = E.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
        t_med = time.perf_counter() - t0
        labels = labeling.envelope_labels(med, TAU).numpy()
        casc = cascade_lib.train_cascade(
            sys_.features[:n_train], labels[:n_train], n_cutoffs=len(cuts),
            forest_kwargs=dict(n_trees=10, max_depth=6), device="cuda")
        scfg = pipeline.ServingConfig(knob=knob, cutoffs=cuts,
                                      rerank_depth=RERANK_DEPTH,
                                      stream_cap=cfg.stream_cap)
        servers[knob] = (pipeline.RetrievalServer(sys_.index, casc, scfg,
                                                  device="cuda"), casc, scfg)
        log(f"phase 2: {knob}: med_tables {t_med:.1f} s, labels "
            f"{np.bincount(labels, minlength=10).tolist()}, cascade "
            f"{time.perf_counter() - t0 - t_med:.1f} s")
    terms = sys_.queries.terms[n_train:]
    batches = [terms[b * BATCH:(b + 1) * BATCH] for b in range(N_BATCHES)]
    return sys_, servers, batches, meds


def main_path(sys_, servers, batches, seen):
    import numpy as np
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.serving import pipeline

    n_docs = sys_.cfg.n_docs
    served = {}
    # ---- the counted window: nothing but the main path runs in it ----
    is_kernel.n_launches = tk_kernel.n_launches = 0
    for knob in ("rho", "k"):
        server = servers[knob][0]
        served[knob] = []
        for qt in batches:
            before = (is_kernel.n_launches, tk_kernel.n_launches)
            out = server.serve_batch(qt)
            out["launches"] = (is_kernel.n_launches - before[0],
                               tk_kernel.n_launches - before[1])
            served[knob].append(out)
    launches = {"impact_scan": is_kernel.n_launches,
                "topk": tk_kernel.n_launches}
    # ---- end of the counted window ----

    report = {}
    for knob in ("rho", "k"):
        server, casc, scfg = servers[knob]
        for b, (qt, out) in enumerate(zip(batches, served[knob])):
            n_is, n_tk = out["launches"]
            if n_is < 1 or (knob == "rho" and n_tk < 1):
                raise AssertionError(f"{knob} batch {b}: kernel launches "
                                     f"impact_scan={n_is} topk={n_tk}")
            _check_ranked(out["ranked"], n_docs)
            ref = server.serve_batch_reference(qt)
            if not np.array_equal(ref["ranked"], out["ranked"]):
                raise AssertionError(f"{knob} batch {b}: ranked differs "
                                     "from serve_batch_reference")
        cpu = pipeline.RetrievalServer(sys_.index.to("cpu"), casc.to("cpu"),
                                       scfg, device="cpu")
        qt = batches[1]
        got = served[knob][1]
        want = cpu.serve_batch(qt)
        if not np.array_equal(want["classes"], got["classes"]):
            raise AssertionError(f"{knob}: classes differ on the CPU")
        n_diff = _compare_within_stage2(f"{knob} cpu", got["ranked"],
                                        want["ranked"], _stage2(server, qt))
        steady = served[knob][1:]
        stages = {k: statistics.mean(o["timings"][k] for o in steady)
                  for k in steady[0]["timings"]}
        report[knob] = dict(
            stage_ms=stages, qps=BATCH / (stages["total_ms"] / 1e3),
            mean_param=statistics.mean(o["mean_param"] for o in steady),
            launches_per_batch=[o["launches"] for o in served[knob]],
            cpu_positions_differing=n_diff,
            cpu_stage_ms={k: v for k, v in want["timings"].items()})
        log(f"phase 2: {knob}: " + json.dumps(report[knob]))
        seen[f"phase 2 {knob}"] = {
            k: stages[k] for k in ("predict_ms", "total_ms")}
    return launches, report, served


#: phase 2's mlp cascade: the reference's MLP node (hidden (64, 32),
#: batch 512), fewer epochs than its default 30
MLP_KW = dict(epochs=10)


def mlp_path(sys_, batches, meds) -> dict:
    """Phase 2, the ``mlp`` node kind: per knob an MLP cascade
    (``core/mlp.py`` nodes trained on the card on phase 2's training
    queries and labels) served through ``RetrievalServer`` over phase
    2's batches.  Its lists must be well formed, its classes equal to
    the same nodes' ``predict_sequential`` (Algorithm 2, one query at a
    time), and ``serve_fixed`` at each served class's cutoff equal to
    the served lists of that class.  Returns per knob the mean stage
    ms, q/s and mean parameter of batches 2-4."""
    import numpy as np
    from repro_torch.core import cascade as cascade_lib
    from repro_torch.core import labeling
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.serving import pipeline

    n_train = sys_.cfg.n_queries - BATCH * N_BATCHES
    x_served = sys_.features[n_train:]
    out = {}
    for knob in ("rho", "k"):
        t0 = time.perf_counter()
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        labels = labeling.envelope_labels(meds[knob], TAU).numpy()
        casc = cascade_lib.train_cascade(
            sys_.features[:n_train], labels[:n_train], n_cutoffs=len(cuts),
            kind="mlp", mlp_kwargs=MLP_KW, device="cuda")
        train_s = time.perf_counter() - t0
        scfg = pipeline.ServingConfig(knob=knob, cutoffs=cuts,
                                      rerank_depth=RERANK_DEPTH,
                                      stream_cap=sys_.cfg.stream_cap)
        server = pipeline.RetrievalServer(sys_.index, casc, scfg,
                                          device="cuda")
        before = is_kernel.n_launches
        served = [server.serve_batch(qt) for qt in batches]
        n_is = is_kernel.n_launches - before
        classes = np.concatenate([o["classes"] for o in served])
        seq = np.array([cascade_lib.predict_sequential(
            casc, x_served[i], scfg.threshold)
            for i in range(len(classes))])
        if not np.array_equal(seq, classes):
            raise AssertionError(f"phase 2: mlp {knob}: served classes "
                                 f"differ from predict_sequential in "
                                 f"{int((seq != classes).sum())} queries")
        n_fixed = 0
        for qt, o in zip(batches, served):
            _check_ranked(o["ranked"], sys_.cfg.n_docs)
            for c in np.unique(o["classes"]):
                param = int(server.params_of(np.array([c]))[0])
                fixed = server.serve_fixed(qt, param)["ranked"]
                sel = o["classes"] == c
                if not np.array_equal(fixed[sel], o["ranked"][sel]):
                    raise AssertionError(
                        f"phase 2: mlp {knob}: serve_fixed({param}) "
                        f"differs from the served lists of class {c}")
                n_fixed += 1
        # the replayed predict and margin graphs against eager calls of
        # the same stage functions: the captured products may take
        # another cuBLAS algorithm, so the gap is measured, not assumed
        n_cls_diff, margin_diff = 0, 0.0
        for qt, o in zip(batches, served):
            eager = _eager_predict(server, qt, knob, pipeline._stage_predict)
            n_cls_diff += int((eager != o["classes"]).sum())
            margin_diff = max(margin_diff, float(np.abs(
                server.predict_margin(qt) - _eager_predict(
                    server, qt, knob, pipeline._stage_margin)).max()))
        if n_cls_diff:
            raise AssertionError(
                f"phase 2: mlp {knob}: {n_cls_diff} replayed classes differ "
                f"from the eager stage (margins by up to {margin_diff})")
        steady = served[1:]
        stages = {k: statistics.mean(o["timings"][k] for o in steady)
                  for k in steady[0]["timings"]}
        out[knob] = dict(
            replayed_vs_eager=dict(classes_differing=n_cls_diff,
                                   margin_max_abs_diff=margin_diff),
            kind=casc.kind, train_s=train_s,
            classes=np.bincount(classes, minlength=len(cuts) + 1).tolist(),
            stage_ms=stages, qps=BATCH / (stages["total_ms"] / 1e3),
            mean_param=statistics.mean(o["mean_param"] for o in steady),
            impact_scan_launches=n_is, predict_sequential_equal=True,
            serve_fixed_classes_checked=n_fixed)
        log(f"phase 2: mlp cascade {knob}: " + json.dumps(out[knob]))
    return out


# ------------------------------------------------------------- phase 3 --

def _requests(n, d_user, seq_len, vocab, seed):
    """Synthetic requests as examples/recsys_funnel.py makes them: normal
    user features, histories with -1 tails of random length (1 to T
    real items)."""
    import numpy as np
    r = np.random.default_rng(seed)
    uf = r.normal(size=(n, d_user)).astype(np.float32)
    hist = r.integers(0, vocab, (n, seq_len)).astype(np.int32)
    hist[np.cumsum(np.ones((n, seq_len)), 1)
         > r.integers(1, seq_len + 1, (n, 1))] = -1
    return uf, hist


def build_funnel():
    """The full-width funnel on the card: seeded parameters, 1024
    labelled training requests and a cascade trained on the host; 4
    held-out batches of 128 to serve, and one more for the mixed-k
    check.  Returns (funnel, batches, mixed batch)."""
    import numpy as np
    import torch
    from repro_torch.configs import recsys as configs
    from repro_torch.core import cascade as cascade_lib
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.recsys import bst, retrieval_tower
    from repro_torch.serving import funnel as F

    t0 = time.perf_counter()
    cfg = configs.funnel_config()
    tower = retrieval_tower.init_tower(cfg.tower, seed=0, device="cuda")
    model = bst.init_bst(cfg.bst, seed=1, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 3: funnel {cfg.tower} {cfg.bst} cutoffs {cfg.cutoffs} "
        f"pool {cfg.pool_depth}: parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    n_serve = BATCH * N_BATCHES
    uf, hist = _requests(FUNNEL_TRAIN + n_serve, cfg.tower.d_user_in,
                         cfg.bst.seq_len, cfg.bst.item_vocab, seed=2)
    t0 = time.perf_counter()
    labels, meds = [], []
    fa_kernel.n_launches = 0
    for b in range(0, FUNNEL_TRAIN, BATCH):
        gold, runs = F.funnel_gold_runs(cfg, tower, model, uf[b:b + BATCH],
                                        hist[b:b + BATCH])
        lab, table = F.label_requests(cfg, gold, runs)
        labels.append(lab)
        meds.append(table)
    labels, meds = np.concatenate(labels), np.concatenate(meds)
    t_label = time.perf_counter() - t0
    n_label = fa_kernel.n_launches
    if n_label != FUNNEL_TRAIN // BATCH * cfg.bst.n_blocks:
        raise AssertionError(f"labelling launched flash_attention {n_label} "
                             "times")
    feats = F.request_features(
        torch.from_numpy(uf[:FUNNEL_TRAIN]).cuda(),
        torch.from_numpy(hist[:FUNNEL_TRAIN]).cuda()).cpu().numpy()
    t0 = time.perf_counter()
    casc = cascade_lib.train_cascade(
        feats, labels, n_cutoffs=len(cfg.cutoffs),
        forest_kwargs=dict(n_trees=10, max_depth=6), device="cuda")
    log(f"phase 3: labels of {FUNNEL_TRAIN} requests in {t_label:.3f} s "
        f"({n_label} flash_attention launches at BH = "
        f"{BATCH * cfg.pool_depth * cfg.bst.n_heads}): "
        f"{np.bincount(labels, minlength=len(cfg.cutoffs) + 1).tolist()}, "
        f"mean MED_RBP per k {np.round(meds.mean(0), 4).tolist()}; "
        f"cascade {time.perf_counter() - t0:.1f} s")
    funnel = F.Funnel(cfg, tower, model, casc, device="cuda")
    batches = [(uf[FUNNEL_TRAIN + i * BATCH:FUNNEL_TRAIN + (i + 1) * BATCH],
                hist[FUNNEL_TRAIN + i * BATCH:FUNNEL_TRAIN + (i + 1) * BATCH])
               for i in range(N_BATCHES)]
    mixed = _requests(BATCH, cfg.tower.d_user_in, cfg.bst.seq_len,
                      cfg.bst.item_vocab, seed=3)
    return funnel, batches, mixed


def _funnel_scores(funnel, uf, hist, ks):
    """Per request {item: stage-2 score} on the funnel's device at the
    served settings (pool of max(k), each request normalised over its
    own k), and the pool ids."""
    import torch
    from repro_torch.models.recsys import retrieval_tower
    from repro_torch.serving import funnel as F
    dev = funnel.device
    ids, vals = retrieval_tower.retrieve_topk(
        funnel.tower_params, funnel.cfg.tower,
        torch.from_numpy(uf).to(dev), int(ks.max()))
    s2 = F._bst_scores(funnel.bst_params, funnel.cfg.bst,
                       torch.from_numpy(hist).to(dev), ids, vals,
                       norm_width=torch.from_numpy(ks).to(dev))
    return [dict(zip(i, s)) for i, s in zip(ids.cpu().tolist(),
                                            s2.cpu().tolist())]


def _compare_funnel(name, got, want, scores) -> tuple[int, float]:
    """Ranked lists equal, or every differing position holds two items
    whose stage-2 scores (``scores``, one device's) lie within
    FUNNEL_ATOL.  Returns (positions differing, largest gap allowed)."""
    import numpy as np
    qs, pos = np.nonzero(got != want)
    worst = 0.0
    for q, i in zip(qs, pos):
        a, b = int(got[q, i]), int(want[q, i])
        if a < 0 or b < 0 or a not in scores[q] or b not in scores[q]:
            raise AssertionError(f"{name}: request {q} rank {i}: {a} vs {b}")
        gap = abs(scores[q][a] - scores[q][b])
        if gap > FUNNEL_ATOL:
            raise AssertionError(f"{name}: request {q} rank {i}: items "
                                 f"{a}/{b} stage-2 gap {gap}")
        worst = max(worst, gap)
    return len(qs), worst


def _check_funnel_ranked(out, cfg):
    import numpy as np
    ranked, ks = out["ranked"], out["k"]
    if ranked.shape != (BATCH, cfg.eval_depth):
        raise AssertionError(f"funnel ranked shape {ranked.shape}")
    if ranked.min() < -1 or ranked.max() >= cfg.tower.n_candidates:
        raise AssertionError("funnel ranked ids out of range")
    for row, k in zip(ranked, ks):
        items = row[row >= 0]
        if len(items) != min(k, cfg.eval_depth):
            raise AssertionError(f"{len(items)} items ranked at k={k}")
        if (row[len(items):] != -1).any():
            raise AssertionError("-1 padding inside a funnel ranked list")
        if len(np.unique(items)) != len(items):
            raise AssertionError("a funnel ranked list repeats an item")


def funnel_path(funnel, batches, mixed):
    """Phase 3's served funnel.  Its programs are warmed first
    (``funnel_warmup``).  Then the counted window: the 4 held-out
    batches through ``Funnel.serve`` and the mixed-k batch (classes over
    every cutoff) through ``Funnel.execute``, each a replay of the
    program of its width, with every launch counter zeroed just before
    and read just after; no program is built in it.  After the window,
    each list is held bit for bit against the stage function called
    eagerly on the same inputs, a few requests against the same funnel
    on the CPU, and the mixed batch against each request alone and the
    CPU (``funnel_mixed_k``).  Returns (the window's launches, the
    report, the served batches)."""
    import numpy as np
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.serving import funnel as F

    cfg = funnel.cfg
    if funnel.has_depth_knob:
        raise AssertionError("phase 3 serves the funnel's k knob alone")
    warm = funnel_warmup(funnel)
    built = funnel.n_compiles
    muf, mhist = mixed
    mclasses = (np.arange(len(muf)) % (len(cfg.cutoffs) + 1)).astype(
        np.int32)
    served = []
    # ---- the counted window: the funnel's programs, nothing else ----
    counters = (fa_kernel, eb_kernel, is_kernel, tk_kernel)
    for mod in counters:
        mod.n_launches = 0
    for uf, hist in batches:
        before = fa_kernel.n_launches
        out = funnel.serve(uf, hist)
        out["launches"] = fa_kernel.n_launches - before
        served.append(out)
    before = fa_kernel.n_launches
    mixed_out = funnel.execute(muf, mhist, mclasses)
    mixed_out["launches"] = fa_kernel.n_launches - before
    launches = {mod.__name__.split(".")[-2]: mod.n_launches
                for mod in counters}
    # ---- end of the counted window ----
    per_batch = [o["launches"] for o in served + [mixed_out]]
    if (per_batch != [cfg.bst.n_blocks] * len(per_batch)
            or launches["flash_attention"] != sum(per_batch)
            or sum(launches.values()) != launches["flash_attention"]):
        raise AssertionError(f"the funnel's window launched {launches}, "
                             f"flash_attention {per_batch} a batch")
    if funnel.n_compiles != built:
        raise AssertionError(f"serving built {funnel.n_compiles - built} "
                             "funnel programs on a warm shape")
    for out in served:
        _check_funnel_ranked(out, cfg)
    # the stage function called eagerly on the same inputs, bit for bit
    eager_walls = []
    for b, ((uf, hist), out) in enumerate(zip(batches, served)):
        classes, ranked, wall = _eager_serve(funnel, uf, hist)
        eager_walls.append(wall)
        if not (np.array_equal(classes, out["classes"])
                and np.array_equal(ranked, out["ranked"])):
            raise AssertionError(f"funnel batch {b}: the replayed lists "
                                 "differ from the eager stage function's")
    if not np.array_equal(
            _funnel_eager_lists(funnel, muf, mhist, mclasses),
            mixed_out["ranked"]):
        raise AssertionError("the replayed mixed-k batch differs from the "
                             "eager stage function's")
    # the same funnel on the CPU, for a few requests of one batch
    uf, hist = (x[:FUNNEL_CPU] for x in batches[1])
    got = {k: v[:FUNNEL_CPU] for k, v in served[1].items()
           if k in ("ranked", "k", "classes")}
    cpu = F.Funnel(cfg, funnel.tower_params, funnel.bst_params,
                   funnel.cascade, device="cpu")
    want = cpu.serve(uf, hist)
    if not (np.array_equal(want["classes"], got["classes"])
            and np.array_equal(want["k"], got["k"])):
        raise AssertionError("funnel classes differ on the CPU")
    card = _funnel_scores(funnel, uf, hist, got["k"])
    host = _funnel_scores(cpu, uf, hist, got["k"])
    n_cpu, worst = _compare_funnel("funnel cpu", got["ranked"],
                                   want["ranked"], card)
    common = [abs(card[q][i] - host[q][i]) for q in range(FUNNEL_CPU)
              for i in card[q] if i in host[q]]
    steady = served[1:]
    stages = {k: statistics.mean(o["timings"][k] for o in steady)
              for k in steady[0]["timings"]}
    split = [_funnel_stage_ms(funnel, *batches[1 + i], o["k"])
             for i, o in enumerate(steady)]
    report = dict(
        stage_ms=stages, requests_per_s=BATCH / (stages["total_ms"] / 1e3),
        eager_stage_parts_ms={k: statistics.mean(t[k] for t in split)
                              for k in split[0]},
        mean_k=statistics.mean(o["mean_k"] for o in steady),
        mean_k_per_batch=[o["mean_k"] for o in served],
        launches_per_batch=[o["launches"] for o in served],
        lists_equal_eager=True,
        cpu_requests=FUNNEL_CPU, cpu_positions_differing=n_cpu,
        cpu_largest_gap_allowed=worst,
        cpu_card_stage2_max_abs_diff=max(common),
        cpu_stage_ms=want["timings"])
    log("phase 3: funnel: " + json.dumps(report))
    log("phase 3: funnel mixed k: " + json.dumps(funnel_mixed_k(
        funnel, cpu, muf, mhist, mixed_out)))
    stats = funnel.programs.stats()
    log("phase 3: funnel programs: " + json.dumps(dict(
        warm, static_gb=stats["static_bytes"] / 1e9,
        serving_built=funnel.n_compiles - built, lists_equal_eager=True,
        flash_launches_per_batch=per_batch, launches=launches,
        serve_total_ms_replayed=[o["timings"]["total_ms"] for o in served],
        serve_total_ms_eager=eager_walls,
        **_stage_replay_vs_eager(funnel, muf, mhist, mixed_out["k"]))))
    log("phase 3: funnel top_k: " + json.dumps(funnel_top_k(
        funnel, batches[1][0])))
    return launches, report, served


def _release_programs(funnel) -> None:
    """Drop the funnel's programs and their graph pool (gigabytes at
    128): the training runs of phase 12 need the card's memory beside
    this process.  A later call at a key builds its program again."""
    import torch
    funnel.programs.clear()
    torch.cuda.empty_cache()


def _funnel_eager_lists(funnel, uf, hist, classes):
    """The ranked lists ``Funnel.execute`` gives at ``classes``, with its
    stage run as the stage function called directly (the eager run its
    program captures) and copied to the host after."""
    import numpy as np
    from repro_torch.serving import funnel as F
    cfg = funnel.cfg
    ks = funnel.params_of(classes)
    _, args, kw = funnel.stage_call(uf, hist, ks,
                                    np.full_like(ks, max(cfg.cutoffs)))
    ranked = F._stage_funnel(*args, **kw).cpu().numpy()
    out = np.full((len(ks), cfg.eval_depth), -1, np.int32)
    out[:, :ranked.shape[1]] = ranked
    return out


def _eager_serve(funnel, uf, hist):
    """``Funnel.serve`` with its stage run eagerly
    (``_funnel_eager_lists``): (classes, ranked lists, total ms on the
    host's clock, fenced)."""
    from repro_torch.device import fence
    fence(funnel.device)
    t0 = time.perf_counter()
    classes = funnel.predict(uf, hist)
    ranked = _funnel_eager_lists(funnel, uf, hist, classes)
    return classes, ranked, (time.perf_counter() - t0) * 1e3


def _funnel_stage_ms(funnel, uf, hist, ks) -> dict:
    """The stage function's three parts run eagerly on one batch at
    cutoffs ``ks``, each fenced and timed on the host's clock: stage 1
    (the towers and the top-k of max(ks)), stage 2 (BST over the pool)
    and the rank (mask, sort, copy of the lists to the host)."""
    import numpy as np
    import torch
    from repro_torch.device import fence
    from repro_torch.models.recsys import retrieval_tower as RT
    from repro_torch.serving import funnel as F
    dev, cfg = funnel.device, funnel.cfg
    _, args, kw = funnel.stage_call(uf, hist, ks,
                                    np.full_like(ks, max(cfg.cutoffs)))
    u, h, kv, dv = args[:4]
    fence(dev)
    t0 = time.perf_counter()
    eff = torch.minimum(kv, dv)
    ids, vals = RT.retrieve_topk(funnel.tower_params, cfg.tower, u,
                                 kw["max_k"])
    fence(dev)
    t1 = time.perf_counter()
    s2 = F._bst_scores(funnel.bst_params, cfg.bst, h, ids, vals,
                       norm_width=eff)
    fence(dev)
    t2 = time.perf_counter()
    F._served_rank(ids, s2, eff, cfg.eval_depth).cpu().numpy()
    t3 = time.perf_counter()
    return dict(stage1_ms=(t1 - t0) * 1e3, stage2_ms=(t2 - t1) * 1e3,
                rank_ms=(t3 - t2) * 1e3)


def funnel_warmup(funnel) -> dict:
    """The funnel's programs warmed as the service warms a shape
    (``FunnelBackend.warmup_shape``, one CUDA graph a cutoff): at 128
    (a second warmup, by a fresh backend, builds none), then at 64, all
    in the cache's one graph pool.  The ``memory_reserved`` each added, after
    ``empty_cache`` (what the pool holds) and, at 128, also with the
    blocks the builds' eager runs left cached."""
    import torch
    from repro_torch.serving.service import FunnelBackend
    cfg = funnel.cfg
    backend = FunnelBackend(funnel, pad_multiple=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    warmed = backend.warmup_shape(BATCH)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cached = torch.cuda.memory_reserved() - reserved0
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() - reserved0
    built = funnel.n_compiles
    if warmed != len(cfg.cutoffs) or built != warmed:
        raise AssertionError(f"funnel warmup: {warmed} cutoffs, {built} "
                             "programs")
    # the same backend skips a warm shape; a fresh one runs it, on the
    # programs built
    if backend.warmup_shape(BATCH):
        raise AssertionError("a warm funnel shape was warmed again")
    FunnelBackend(funnel, pad_multiple=8).warmup_shape(BATCH)
    again = funnel.n_compiles - built
    if again:
        raise AssertionError(f"a second funnel warmup built {again}")
    t0 = time.perf_counter()
    warmed_64 = backend.warmup_shape(BATCH // 2)
    build_64_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_two = torch.cuda.memory_reserved() - reserved0
    if warmed_64 != len(cfg.cutoffs):
        raise AssertionError(f"funnel warmup at {BATCH // 2}: {warmed_64}")
    stats = funnel.programs.stats()
    return dict(
        programs=built, build_s=build_s, memory_reserved_gb=reserved / 1e9,
        memory_reserved_with_cache_gb=cached / 1e9,
        second_warmup_built=again, second_size=BATCH // 2,
        second_size_programs=warmed_64, second_size_build_s=build_64_s,
        memory_reserved_two_sizes_gb=reserved_two / 1e9,
        graphs=stats["graphs"], pool_sizes=funnel.programs.pool_sizes())


def _stage_replay_vs_eager(funnel, uf, hist, ks) -> dict:
    """The stage at cutoffs ``ks`` (the mixed batch's width), replayed
    and called eagerly: one call's wall on an idle card, its device time
    alone and its host time alone (``time_ms``, ``host_ms``)."""
    import numpy as np
    from repro_torch.serving import funnel as F
    name, args, kw = funnel.stage_call(
        uf, hist, ks, np.full_like(ks, max(funnel.cfg.cutoffs)))
    prog = funnel.programs.compiled(name, F._stage_funnel, args, kw)

    def eager():
        return F._stage_funnel(*args, **kw)

    def replay():
        return prog(*args)

    return dict(
        stage_max_k=int(ks.max()),
        stage_ms_replayed=time_ms(replay), stage_ms_eager=time_ms(eager),
        stage_device_ms_replayed=time_ms(replay, hold=True),
        stage_device_ms_eager=time_ms(eager, hold=True),
        stage_host_ms_replayed=host_ms(replay),
        stage_host_ms_eager=host_ms(eager))


def _flag_top_k(scores, k):
    """The port's top-k before the funnel's programs were captured, for
    its time: a float32 ``torch.topk`` of k + 1, a read of one tie flag
    from the card, and the keyed selection where the k-th score ties."""
    import torch
    from repro_torch.models.recsys import retrieval_tower as RT
    n = scores.shape[1]
    vals, idx = torch.topk(scores, min(k + 1, n), dim=1)
    if 0 < k < n and bool((vals[:, k] == vals[:, k - 1]).any()):
        idx = RT._top_k_keyed(scores, k)
    else:
        idx = idx[:, :k]
        idx = idx.gather(1, torch.sort(idx, dim=1, stable=True).indices)
        order = torch.sort(RT._keys(scores.gather(1, idx)), dim=1,
                           descending=True, stable=True).indices
        idx = idx.gather(1, order)
    return idx, scores.gather(1, idx)


def funnel_top_k(funnel, uf) -> dict:
    """Stage 1 at batch 128 on the card, device ms (CUDA events, the card
    held while the host enqueues; the flag form's read of the card
    stalls the stream inside its window): the scores, and at k 50 and
    1000 the selection by ``top_k`` (branch-free), by the earlier flag form
    and by the keyed form alone, each on the same scores and each
    selecting the same ids; the whole stage (``retrieve_topk``) beside
    the scores plus the flag form."""
    import torch
    from repro_torch.models.recsys import retrieval_tower as RT
    tower, cfg = funnel.tower_params, funnel.cfg.tower
    u = torch.from_numpy(uf).to(funnel.device)
    scores = RT.score_candidates(tower, cfg, u)
    row = dict(batch=len(uf), n=cfg.n_candidates,
               scores_ms=time_ms(lambda: RT.score_candidates(tower, cfg, u),
                                 hold=True))
    for k in (50, 1000):
        got = RT.top_k(scores, k)[0]
        if not (torch.equal(got, _flag_top_k(scores, k)[0])
                and torch.equal(got, RT._top_k_keyed(scores, k))):
            raise AssertionError(f"top_k at k {k} differs from the flag or "
                                 "keyed selection")
        row[f"k{k}"] = dict(
            top_k_ms=time_ms(lambda: RT.top_k(scores, k), hold=True),
            flag_ms=time_ms(lambda: _flag_top_k(scores, k), hold=True),
            keyed_ms=time_ms(lambda: RT._top_k_keyed(scores, k),
                             hold=True),
            stage1_ms=time_ms(lambda: RT.retrieve_topk(tower, cfg, u, k),
                              hold=True),
            stage1_flag_ms=time_ms(lambda: _flag_top_k(
                RT.score_candidates(tower, cfg, u), k), hold=True))
    return row


def funnel_mixed_k(funnel, cpu, uf, hist, out) -> dict:
    """The mixed-k batch as the counted window served it (``out``: its
    classes spread over every cutoff and the no-envelope class): held
    against each request alone, the stage function called eagerly (the
    prefix mask and the per-request normalisation width must hide the
    wider pools), and against the same batch executed on the CPU."""
    import numpy as np
    cfg = funnel.cfg
    classes = out["classes"]
    if set(out["k"].tolist()) != set(cfg.cutoffs):
        raise AssertionError(f"mixed-k batch serves k {set(out['k'])}")
    _check_funnel_ranked(out, cfg)
    card = _funnel_scores(funnel, uf, hist, out["k"])
    alone = np.concatenate([
        _funnel_eager_lists(funnel, uf[q:q + 1], hist[q:q + 1],
                            classes[q:q + 1])
        for q in range(len(uf))])
    n_alone, gap_alone = _compare_funnel("mixed-k alone", out["ranked"],
                                         alone, card)
    want = cpu.execute(uf, hist, classes)
    n_cpu, gap_cpu = _compare_funnel("mixed-k cpu", out["ranked"],
                                     want["ranked"], card)
    host = _funnel_scores(cpu, uf, hist, out["k"])
    diff = max(abs(card[q][i] - host[q][i]) for q in range(len(uf))
               for i in card[q] if i in host[q])
    return dict(
        requests=len(uf), max_k=int(out["k"].max()),
        requests_per_k={int(k): int((out["k"] == k).sum())
                        for k in cfg.cutoffs},
        stage_ms=out["timings"],
        eager_stage_parts_ms=_funnel_stage_ms(funnel, uf, hist, out["k"]),
        alone_positions_differing=n_alone, alone_largest_gap_allowed=gap_alone,
        cpu_positions_differing=n_cpu, cpu_largest_gap_allowed=gap_cpu,
        cpu_card_stage2_max_abs_diff=diff, cpu_stage_ms=want["timings"])


# ------------------------------------------------------------- phase 4 --

def _service_run(backend, pad_multiple, payloads, mode, counters=()):
    """Serve the batches of ``payloads`` through a fresh service as the
    CLI builds it (no census, shape 128 warmed): inline (``serve_all`` a
    batch at a time), ``fifo`` (every request queued, then the workers
    started: the batches are the FIFO chunks whatever the threads'
    timing) or ``threaded`` (workers running, ``serve_all`` a batch at a
    time with a 100 ms deadline, as the CLI serves).  The kernel launch
    ``counters`` (modules) are zeroed after the warmup.  Returns
    (results per batch, summary, launches per counter)."""
    import numpy as np
    from repro_torch.obs import Observability, export
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.serving.service import RetrievalService, WarmupPolicy
    obs = Observability.create()
    svc = RetrievalService(
        backend, AdmissionConfig(max_batch=BATCH, pad_multiple=pad_multiple),
        WarmupPolicy(census_path=None), obs=obs)
    svc.warmup_now([BATCH])
    svc.reset_stats()
    if svc.stats().n_queries:
        raise AssertionError("reset_stats left batch records")
    d0 = obs.metrics.counters().get("engine.dispatches", 0)   # the warmup's
    for mod in counters:
        mod.n_launches = 0
    t0 = time.perf_counter()
    if mode == "fifo":
        futs = [svc.submit_many(list(p), deadline_ms=1e6) for p in payloads]
        svc.start()
        results = [[f.result(timeout=600) for f in fs] for fs in futs]
    else:
        if mode == "threaded":
            svc.start()
        results = [svc.serve_all(list(p), deadline_ms=100.0)
                   for p in payloads]
    wall = time.perf_counter() - t0
    launches = [mod.n_launches for mod in counters]
    svc.stop()
    if svc.warmup.failed:
        raise AssertionError(f"warmup failed: {svc.warmup.failed}")
    flat = [r for rs in results for r in rs]

    def pct(key, per_batch=False):
        xs = ([rs[0][key] for rs in results] if per_batch
              else [r[key] for r in flat])
        return [float(np.percentile(xs, 50)), float(np.percentile(xs, 99))]

    stages = {}
    for h in obs.trace.spans():
        if h.name.startswith("engine.") and (h.attrs or {}).get("batch") \
                is not None:
            stages.setdefault(h.name, []).append(h.dur_ms)
    counts = obs.trace.counts()
    summary = dict(
        requests=len(flat), qps=len(flat) / wall,
        total_ms_p50_p99=pct("total_ms"), queue_ms_p50_p99=pct("queue_ms"),
        predict_ms_p50_p99=pct("predict_ms", True),
        service_ms_p50_p99=pct("service_ms", True),
        predict_ms_per_batch=[rs[0]["predict_ms"] for rs in results],
        service_ms_per_batch=[rs[0]["service_ms"] for rs in results],
        deadline_met=sum(r["deadline_met"] for r in flat) / len(flat),
        stage_ms={k: statistics.mean(v) for k, v in sorted(stages.items())},
        batches_formed=dict(svc.queue.shape_counts),
        dispatches_per_batch=(obs.metrics.counters().get(
            "engine.dispatches", 0) - d0) / len(payloads),
        trace=counts)
    if counts["n_open"] or counts["n_begun"] != counts["n_ended"]:
        raise AssertionError(f"{mode}: unbalanced trace {counts}")
    errs = export.validate_chrome_trace(export.chrome_trace(obs.trace))
    if errs:
        raise AssertionError(f"{mode}: invalid Chrome trace {errs[:3]}")
    return results, summary, launches


def _direct(serve, batches) -> dict:
    """The same batches served by the path's own call (``serve_batch``,
    ``Funnel.serve``) just before the service runs, for an adjacent
    comparison: q/s over the calls' wall time, median ``total_ms`` and
    ``predict_ms``."""
    wall, outs = 0.0, []
    for args in batches:
        t0 = time.perf_counter()
        outs.append(serve(*args))
        wall += time.perf_counter() - t0
    return dict(qps=BATCH * len(batches) / wall,
                total_ms_p50=statistics.median(
                    o["timings"]["total_ms"] for o in outs),
                predict_ms_p50=statistics.median(
                    o["timings"]["predict_ms"] for o in outs))


def service_path(sys_, servers, batches, served, funnel, fbatches,
                 fserved, seen):
    """Phase 4: the service layer on the card over phase 2's servers and
    batches and phase 3's funnel and batches.  Inline and FIFO-threaded
    results must equal ``serve_batch`` / ``Funnel.serve`` bit for bit;
    the threaded run as the CLI serves it is checked for well-formed
    lists and classes.  Returns the launches of the inline and FIFO
    windows, per kernel."""
    import numpy as np
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.serving.service import EngineBackend, FunnelBackend

    launches = {"impact_scan": 0, "topk": 0, "flash_attention": 0,
                "embedding_bag": 0}
    for knob in ("rho", "k"):
        server = servers[knob][0]
        backend = EngineBackend(server, query_len=batches[0].shape[1])
        pad = server.engine.batch_multiple
        want = sum(np.array(o["launches"]) for o in served[knob])
        line = {"direct": _direct(server.serve_batch, [(qt,) for qt
                                                       in batches])}
        for mode in ("inline", "fifo", "threaded"):
            results, summary, got = _service_run(
                backend, pad, batches, mode, counters=(is_kernel, tk_kernel))
            for b, (qt, res) in enumerate(zip(batches, results)):
                ranked = np.stack([r["ranked"] for r in res])
                classes = np.array([r["class"] for r in res])
                if mode == "threaded":
                    _check_ranked(ranked, sys_.cfg.n_docs)
                    if not np.array_equal(classes,
                                          server.predict_classes(qt)):
                        raise AssertionError(f"service {knob} {mode} batch "
                                             f"{b}: classes")
                    continue
                out = served[knob][b]
                widths = np.array([r["width"] for r in res])
                if not (np.array_equal(ranked, out["ranked"])
                        and np.array_equal(classes, out["classes"])
                        and np.array_equal(widths, out["widths"])):
                    raise AssertionError(f"service {knob} {mode} batch {b} "
                                         "differs from serve_batch")
            if mode != "threaded":
                if (summary["dispatches_per_batch"] != 4
                        or list(got) != list(want)):
                    raise AssertionError(
                        f"service {knob} {mode}: dispatches per batch "
                        f"{summary['dispatches_per_batch']}, launches "
                        f"{got} (serve_batch: {want.tolist()})")
                launches["impact_scan"] += got[0]
                launches["topk"] += got[1]
            summary["launches"] = dict(impact_scan=got[0], topk=got[1])
            line[mode] = summary
        line["threaded_qps_over_inline"] = (line["threaded"]["qps"]
                                            / line["inline"]["qps"])
        line["inline_qps_over_direct"] = (line["inline"]["qps"]
                                          / line["direct"]["qps"])
        log(f"phase 4: service {knob}: " + json.dumps(line))
        seen[f"phase 4 {knob}"] = {
            mode: line[mode]["predict_ms_p50_p99"]
            for mode in ("inline", "fifo", "threaded")}

    backend = FunnelBackend(funnel, pad_multiple=8)
    payloads = [list(zip(uf, hist)) for uf, hist in fbatches]
    built = funnel.n_compiles               # phase 3 warmed shape 128
    line = {"direct": _direct(funnel.serve, fbatches)}
    for mode in ("inline", "fifo"):
        results, summary, got = _service_run(
            backend, 8, payloads, mode, counters=(fa_kernel,))
        for b, res in enumerate(results):
            out = fserved[b]
            if not (np.array_equal(np.stack([r["ranked"] for r in res]),
                                   out["ranked"])
                    and np.array_equal([r["class"] for r in res],
                                       out["classes"])
                    and np.array_equal([r["width"] for r in res], out["k"])):
                raise AssertionError(f"service funnel {mode} batch {b} "
                                     "differs from Funnel.serve")
        want = sum(o["launches"] for o in fserved)
        if got[0] != want:
            raise AssertionError(f"service funnel {mode}: {got[0]} "
                                 f"flash_attention launches, not {want}")
        launches["flash_attention"] += got[0]
        summary["launches"] = dict(flash_attention=got[0])
        line[mode] = summary
    line["programs_built"] = funnel.n_compiles - built
    if line["programs_built"]:
        raise AssertionError(f"service funnel built {line['programs_built']} "
                             "programs on a warm shape")
    line["fifo_qps_over_inline"] = line["fifo"]["qps"] / line["inline"]["qps"]
    line["inline_qps_over_direct"] = (line["inline"]["qps"]
                                      / line["direct"]["qps"])
    log("phase 4: service funnel: " + json.dumps(line))
    return launches


def serve_cli() -> None:
    """The port's CLI as a user runs it, in a process of its own: its
    exports must be a valid trace and a snapshot with the service and
    engine counters."""
    from repro_torch.obs import export
    out = os.path.join(HERE, "build", "repro_torch")
    os.makedirs(out, exist_ok=True)
    trace = os.path.join(out, "serve_trace.json")
    snap = os.path.join(out, "serve_metrics.jsonl")
    for path in (trace, snap):
        if os.path.exists(path):
            os.remove(path)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--knob", "rho",
           "--batch", "30", "--batches", "3", "--n-docs", "2000",
           "--n-queries", "256", "--census", "", "--trace-out", trace,
           "--metrics-snapshot", snap]
    log("phase 4: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    sys.stdout.flush()
    subprocess.run(cmd, cwd=HERE, check=True, timeout=600,
                   env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    with open(trace) as f:
        errs = export.validate_chrome_trace(json.load(f))
    with open(snap) as f:
        counters = json.loads(f.read().splitlines()[-1])["counters"]
    need = ("service.batches", "service.deadline_met", "engine.dispatches",
            "engine.compiles")
    if errs or any(k not in counters for k in need):
        raise AssertionError(f"serve CLI exports: trace {errs[:3]}, "
                             f"counters {counters}")
    log(f"phase 4: serve CLI exit 0 in {time.perf_counter() - t0:.1f} s, "
        f"trace valid, counters {json.dumps(counters)}")


#: phase 4: the port's drivers of the JAX package's examples, and the
#: lines each must print in order (the JAX example's, by their start)
DRIVERS = (
    ("serve_retrieval", ("--knob", "rho"), (
        "== labeling (rho knob, MED_RBP <= 0.05) ==", "   class histogram:",
        "== training the cascade ==", " ", "dynamic ", "fixed max ",
        "top-10 agreement dynamic vs fixed-max: ", "service: q=256 ",
        "shape census: ")),
    ("serve_retrieval", ("--online", "--trace-out",
                         "build/repro_torch/serve_retrieval_trace.json"), (
        "== labeling (k knob, MED_RBP <= 0.05) ==", "   class histogram:",
        "== training the cascade ==", "   (boot era: ", " ", "dynamic ",
        "fixed max ", "top-10 agreement dynamic vs fixed-max: ",
        "service: q=256 ", "shape census: ",
        "== online adaptation: the query distribution shifts ==",
        "  frozen cascade ", "  adapted (v", "  loop: ",
        "== trace of the replay ==", "  ", "  kinds: ",
        "  attribution for trace_id=", "  counters: ")),
    ("recsys_funnel", (), (
        "== gold + per-k candidate runs (no judgments) ==",
        "   class histogram:", "   mean MED_RBP per k:",
        "== train cascade on request features ==",
        "   dynamic mean k = ", "   held-out realized MED_RBP = ",
        "   retrieval work saved vs fixed: ")),
)


def drivers_cli() -> None:
    """The port's drivers of ``examples/serve_retrieval.py`` (ρ knob, and
    ``--online``) and ``examples/recsys_funnel.py`` as a user runs them
    on the card, each in a process of its own, the three started
    together (the q/s they print share the card and are no
    measurement): exit 0 and the JAX example's lines in order."""
    t0 = time.perf_counter()
    procs = []
    for module, args, want in DRIVERS:
        cmd = [sys.executable, "-m", f"repro_torch.examples.{module}",
               *args]
        log("phase 4: " + " ".join(cmd[1:]))
        procs.append(subprocess.Popen(
            cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))))
    for (module, args, want), proc in zip(DRIVERS, procs):
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{module} exited {proc.returncode}:\n"
                                 f"{stderr[-4000:]}")
        lines = [ln for ln in stdout.splitlines() if ln.strip()]
        i = 0
        for ln in lines:
            if i < len(want) and ln.startswith(want[i]):
                i += 1
        if i != len(want):
            raise AssertionError(f"{module} {args}: line {want[i]!r} not "
                                 f"printed in order:\n{stdout}")
        for ln in lines:
            log(f"phase 4: {module} | " + ln)
        log(f"phase 4: {module} {' '.join(args)}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s, {len(want)} lines in order")


# ------------------------------------------------------------- phase 7 --

def _span_ms(obs, names) -> dict:
    """Summed ms of the trace's spans, by name, for ``names``."""
    out = {}
    for h in obs.trace.spans():
        if h.name in names:
            out[h.name] = out.get(h.name, 0.0) + h.dur_ms
    return out


def _continuous_run(server, qt, mode, fixed_param=None, chunk_p=CHUNK_P):
    """Serve the rows of ``qt`` through a fresh continuous service (slots
    SLOTS, grain GRAIN, chunk ``chunk_p``; None: the default of the
    slot's stream width): warmed, the kernel launch counters
    zeroed after the warmup, then ``inline`` (``serve_all``) or ``fifo``
    (every request queued, then the tick thread started).  Returns
    (results, scheduler stats, wall s, launches, obs)."""
    import torch
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.obs import Observability
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.serving.service import (ContinuousBackend,
                                             RetrievalService, WarmupPolicy)
    obs = Observability.create()
    backend = ContinuousBackend(server, query_len=qt.shape[1], slots=SLOTS,
                                grain=GRAIN, chunk_p=chunk_p,
                                fixed_param=fixed_param)
    svc = RetrievalService(
        backend, AdmissionConfig(max_batch=BATCH, pad_multiple=GRAIN),
        WarmupPolicy(census_path=None), obs=obs)
    if svc.warmup_now([BATCH]) != 1:
        raise AssertionError("continuous warmup did not run")
    torch.cuda.synchronize()
    is_kernel.n_launches = tk_kernel.n_launches = 0
    t0 = time.perf_counter()
    if mode == "fifo":
        futs = svc.submit_many(list(qt), deadline_ms=1e6)
        svc.start()
        results = [f.result(timeout=600) for f in futs]
    else:
        results = svc.serve_all(list(qt), deadline_ms=1e6)
    wall = time.perf_counter() - t0
    launches = dict(impact_scan=is_kernel.n_launches,
                    topk=tk_kernel.n_launches)
    svc.stop()
    if svc.warmup.failed:
        raise AssertionError(f"warmup failed: {svc.warmup.failed}")
    counts = obs.trace.counts()
    if counts["n_open"] or counts["n_begun"] != counts["n_ended"]:
        raise AssertionError(f"continuous {mode}: unbalanced trace {counts}")
    return results, backend.scheduler.stats(), wall, launches, obs


def _arm_summary(results, stats, wall, obs) -> dict:
    import numpy as np
    tot = [r["total_ms"] for r in results]
    return dict(
        qps=len(results) / wall,
        total_ms_p50_p99=[float(np.percentile(tot, 50)),
                          float(np.percentile(tot, 99))],
        slot_chunks=int(sum(r["chunks_executed"] for r in results)),
        chunk_dispatches=stats["n_chunk_calls"],
        refills=stats["n_refill_calls"],
        finalizes=stats["n_finalize_calls"],
        retire_reasons=stats["retire_reasons"],
        dispatches=obs.metrics.counters().get("engine.dispatches", 0),
        span_ms=_span_ms(obs, ("predict", "sched.sgather", "sched.refill",
                               "sched.chunk", "sched.finalize",
                               "tick.refill", "tick.chunk",
                               "tick.finalize")))


def continuous_path(servers, batches, seen) -> dict:
    """Phase 7: the continuous scheduler on the card over phase 2's
    servers and 512 requests, per knob.  The inline run's lists must
    equal one ``engine.serve`` of the 512 rows bit for bit (arrival index
    = batch position), its classes ``predict_classes``'; impact_scan
    launches must equal the chunk dispatches and topk launches the ρ
    finalizes (k's pool of max(cutoffs) > KP_MAX takes the plain sort:
    0).  The FIFO-threaded run must give the same lists; the fixed arm
    (ρ at the stream cap, k at the largest cutoff) must equal
    ``serve_fixed`` of the 512 rows.  Returns the inline runs' launches."""
    import numpy as np
    qt = np.concatenate(batches)
    launches = {"impact_scan": 0, "topk": 0}
    for knob in ("rho", "k"):
        server = servers[knob][0]
        direct = _direct(server.serve_batch, [(b,) for b in batches])
        classes = server.predict_classes(qt)
        ref, _ = server.engine.serve(qt, server.params_of(classes))
        res, st, wall, got, obs = _continuous_run(server, qt, "inline")
        ranked = np.stack([r["ranked"] for r in res])
        if not np.array_equal(ranked, ref):
            raise AssertionError(f"continuous {knob}: ranked differs from "
                                 "one engine.serve of the stream")
        if not np.array_equal([r["class"] for r in res], classes):
            raise AssertionError(f"continuous {knob}: classes differ")
        want_tk = st["n_finalize_calls"] if knob == "rho" else 0
        if got != dict(impact_scan=st["n_chunk_calls"], topk=want_tk):
            raise AssertionError(f"continuous {knob}: launches {got}, "
                                 f"chunks {st['n_chunk_calls']}, "
                                 f"finalizes {st['n_finalize_calls']}")
        for k_ in launches:
            launches[k_] += got[k_]
        dyn = _arm_summary(res, st, wall, obs)
        fres, fst, fwall, _, fobs = _continuous_run(server, qt, "fifo")
        if not np.array_equal(np.stack([r["ranked"] for r in fres]), ranked):
            raise AssertionError(f"continuous {knob}: threaded differs "
                                 "from inline")
        fixed = (server.cfg.stream_cap if knob == "rho"
                 else int(max(server.cfg.cutoffs)))
        xres, xst, xwall, _, xobs = _continuous_run(server, qt, "inline",
                                                    fixed_param=fixed)
        if not np.array_equal(np.stack([r["ranked"] for r in xres]),
                              server.serve_fixed(qt, fixed)["ranked"]):
            raise AssertionError(f"continuous {knob}: the fixed arm differs "
                                 "from serve_fixed")
        fix = _arm_summary(xres, xst, xwall, xobs)
        line = dict(
            requests=len(qt), slots=SLOTS, grain=GRAIN, chunk_p=CHUNK_P,
            chunks_max=st["chunks_max"], dynamic=dyn, fixed_arm=fix,
            fixed_param=fixed, launches=got,
            threaded_qps=len(fres) / fwall,
            slot_chunks_dynamic_over_fixed=(dyn["slot_chunks"]
                                            / fix["slot_chunks"]),
            chunk_dispatches_dynamic_over_fixed=(dyn["chunk_dispatches"]
                                                 / fix["chunk_dispatches"]),
            qps_dynamic_over_fixed=dyn["qps"] / fix["qps"],
            batch_once_qps=direct["qps"],
            qps_over_batch_once=dyn["qps"] / direct["qps"])
        log(f"phase 7: continuous {knob}: " + json.dumps(line))
        seen[f"phase 7 {knob}"] = {
            "qps_over_batch_once": line["qps_over_batch_once"]}
    return launches


# ------------------------------------------------------------- phase 8 --

#: the online loop's stream: shifted ("long" band) queries served in
#: chunks of BATCH, one controller step after each
ONLINE_CHUNKS = 6
ONLINE_RETRAIN_EVERY = 2 * BATCH
#: MED on the card against the CPU (float32 sums in another order), as
#: tests/test_torch_core.py holds MED
MED_RTOL, MED_ATOL = 1e-5, 1e-6


def online_path(sys_, servers, seen) -> dict:
    """Phase 8: the online loop at paperish on ρ.  A fresh server with
    phase 2's cascade serves ``shifted_queries`` through a service with a
    telemetry ring, ``OnlineController.step()`` after each chunk, until
    it has retrained and swapped.  After the swap the server's
    ``serve_batch`` must equal a fresh server booted with the trainer's
    last cascade and the store's thresholds, bit for bit; the first
    shadow batch's MED table must match the same rows labelled on a CPU
    server within MED_RTOL/MED_ATOL, its envelope labels equal except in
    rows with a cell within that tolerance of TAU (float32 sums in
    another order may put such a cell on either side; counted and
    printed).  Returns the shadow steps' launches."""
    import numpy as np
    import torch
    from repro_torch.core import labeling
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.obs import Observability
    from repro_torch.online import (OnlineConfig, OnlineController,
                                    TelemetryBuffer, TrainerConfig,
                                    serving_med_table, shifted_queries)
    from repro_torch.serving import pipeline
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.serving.service import (EngineBackend, RetrievalService,
                                             WarmupPolicy)

    _, casc, scfg = servers["rho"]
    server = pipeline.RetrievalServer(sys_.index, casc, scfg, device="cuda")
    ql = sys_.queries.terms.shape[1]
    obs = Observability.create()
    svc = RetrievalService(
        EngineBackend(server, query_len=ql),
        AdmissionConfig(max_batch=BATCH, pad_multiple=GRAIN),
        WarmupPolicy(census_path=None), telemetry=TelemetryBuffer(),
        obs=obs)
    svc.warmup_now([BATCH])
    # the loop's swaps copy new tables into the warmed predict program:
    # predict keys only (the shadow sampler's margins are its own)
    n_predict0 = server.predict_programs.built("predict:rho")
    if n_predict0 < 1:
        raise AssertionError("online: warmup built no predict program")
    ctl = OnlineController(svc, server, OnlineConfig(
        tau=TAU, shadow_sample=BATCH, trainer=TrainerConfig(
            min_labels=ONLINE_RETRAIN_EVERY,
            retrain_every=ONLINE_RETRAIN_EVERY,
            forest_kwargs=OFFLINE_FOREST)))
    qt = shifted_queries(sys_.corpus, ONLINE_CHUNKS * BATCH, band="long",
                         max_len=ql).terms
    launches = {"impact_scan": 0, "topk": 0}
    steps = []
    for c in range(ONLINE_CHUNKS):
        svc.serve_all(list(qt[c * BATCH:(c + 1) * BATCH]), deadline_ms=1e6)
        torch.cuda.synchronize()
        is_kernel.n_launches = tk_kernel.n_launches = 0
        t0 = time.perf_counter()
        st = ctl.step()
        steps.append(dict(step_s=time.perf_counter() - t0,
                          impact_scan=is_kernel.n_launches,
                          topk=tk_kernel.n_launches,
                          version=st["predictor_version"]))
        launches["impact_scan"] += is_kernel.n_launches
        launches["topk"] += tk_kernel.n_launches
    st = ctl.stats()
    if st["n_retrains"] < 1 or st["n_swaps"] < 1 or st["last_error"]:
        raise AssertionError(f"online loop did not swap: {st}")
    spans = {}
    for h in obs.trace.spans():
        if h.name.startswith("online."):
            spans.setdefault(h.name, []).append(h.dur_ms)

    # the swapped server against a fresh one booted with that cascade
    v = ctl.store.current()
    fresh = pipeline.RetrievalServer(sys_.index, ctl.trainer._prev, scfg,
                                     device="cuda")
    fresh.swap_predictor(fresh._live["rho"][0], v.thresholds)
    for name, rows in (("served", sys_.queries.terms[-BATCH:]),
                       ("shifted", qt[-BATCH:])):
        a, b = server.serve_batch(rows), fresh.serve_batch(rows)
        if not (np.array_equal(a["ranked"], b["ranked"])
                and np.array_equal(a["classes"], b["classes"])):
            raise AssertionError(f"online: the swapped server differs from "
                                 f"a fresh boot ({name} rows)")
    n_predict = server.predict_programs.built("predict:rho")
    if n_predict != n_predict0:
        raise AssertionError(
            f"online: the loop's {st['n_swaps']} swaps and serves built "
            f"{n_predict - n_predict0} predict programs")
    seen["phase 8 rho"] = dict(
        predict_programs_after_warmup=n_predict0,
        predict_programs_after_loop=n_predict, swaps=st["n_swaps"],
        programs=sorted(f"{k[0]}@{k[1][0][0]}"
                        for k in server.predict_programs.keys()),
        graphs=server.predict_programs.stats()["graphs"])

    # the first shadow batch (telemetry seq 0..BATCH-1) against the CPU
    first = ctl.trainer._batches[0]
    cpu = pipeline.RetrievalServer(sys_.index.to("cpu"), casc.to("cpu"),
                                   scfg, device="cpu")
    cpu_med = serving_med_table(cpu, qt[:BATCH], batch=BATCH)
    med_err = float(np.abs(first.med - cpu_med).max())
    if not np.allclose(first.med, cpu_med, rtol=MED_RTOL, atol=MED_ATOL):
        raise AssertionError(f"online: shadow MED on the card differs from "
                             f"the CPU's by {med_err}")
    # a label is the first cell <= TAU; the cells are known to the MED
    # tolerance, so a label may differ only in a row with a cell within
    # that tolerance of TAU on one of the two devices
    diff = np.flatnonzero((labeling.envelope_labels(first.med, TAU)
                           != labeling.envelope_labels(cpu_med, TAU)).numpy())
    tol = MED_ATOL + MED_RTOL * TAU
    near = ((np.abs(first.med - TAU) <= tol)
            | (np.abs(cpu_med - TAU) <= tol)).any(axis=1)
    if not near[diff].all():
        raise AssertionError(f"online: shadow labels differ in rows "
                             f"{diff[~near[diff]].tolist()} with no cell "
                             f"within {tol} of tau")
    at_tau = [dict(row=int(q), card=first.med[q].tolist(),
                   cpu=cpu_med[q].tolist()) for q in diff]

    obs_med = np.concatenate([b.observed_med for b in ctl.trainer._batches])
    ver = np.concatenate([b.predictor_version for b in ctl.trainer._batches])
    line = dict(
        requests=int(qt.shape[0]), labels=st["n_labels"],
        retrains=st["n_retrains"], swaps=st["n_swaps"],
        version=st["predictor_version"], tau_effective=st["tau_effective"],
        med_ema=st["med_ema"], fallback=st["fallback"],
        refit_host_s=[ms / 1e3 for ms in spans.get("online.refit", [])],
        shadow_ms_per_batch=spans.get("online.shadow", []),
        swap_ms=spans.get("online.swap", []), steps=steps,
        shadow_launches_per_batch=[(s["impact_scan"], s["topk"])
                                   for s in steps],
        in_envelope_before_swap=float((obs_med[ver == 0] <= TAU).mean()),
        in_envelope_after_swap=(float((obs_med[ver > 0] <= TAU).mean())
                                if (ver > 0).any() else None),
        labels_after_swap=int((ver > 0).sum()),
        shadow_vs_cpu=dict(max_abs_med_err=med_err,
                           labels_differing=len(diff),
                           rows_with_a_cell_near_tau=int(near.sum()),
                           differing_rows=at_tau),
        published_thresholds=v.thresholds.cpu().tolist())
    log("phase 8: online rho: " + json.dumps(line))
    return launches


def serve_cli_online() -> None:
    """``python -m repro_torch.launch.serve --online`` as a user runs it,
    at the verify sizes: exit 0 and one ``online:`` line."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--knob", "rho",
           "--batch", "30", "--batches", "3", "--n-docs", "2000",
           "--n-queries", "256", "--census", "", "--online"]
    log("phase 8: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=HERE, check=True, timeout=600,
                         capture_output=True, text=True,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(HERE, "src"))
                         ).stdout
    line = [ln for ln in out.splitlines() if ln.startswith("online:")]
    if len(line) != 1 or "last_error" in line[0]:
        raise AssertionError(f"serve --online printed {line}")
    log(f"phase 8: serve CLI --online exit 0 in "
        f"{time.perf_counter() - t0:.1f} s: {line[0]}")


# ------------------------------------------------------------ phase 11 --

#: the sharded phase's meshes, (data, model), laid over the one card by
#: ``force_host_device_count``; the shard count of the kernels' shard
#: shapes
SHARD_MESHES = ((1, 2), (1, 4), (2, 2))
SHARDS = 4


def _partition_need(server, batches, shards) -> dict:
    """The most postings (and score-stream postings) one shard owns in
    one query's streams over ``batches``, and the ``partition_slack``
    that holds them (the default, 2.0, unless it overflows)."""
    import torch
    from repro_torch.retrieval import jass
    from repro_torch.retrieval.index import partition_cap
    e, cap = server.engine, server.cfg.stream_cap
    width = -(-e.n_docs // shards)
    post = score = 0
    for qt in batches:
        q = torch.from_numpy(qt.astype("int32")).to(e.device)
        ds, _ = jass.gather_streams(e.offsets, e.pdoc, e.pimp, q, cap=cap)
        sd, _ = jass.gather_score_streams(e.offsets, e.pdoc, e.pscore, q,
                                          cap=cap)
        for s in range(shards):
            lo = s * width
            post = max(post, int(((ds >= lo) & (ds < lo + width))
                                 .sum(dim=1).max().cpu().numpy()))
            score = max(score, int(((sd >= lo) & (sd < lo + width))
                                   .sum(dim=1).max().cpu().numpy()))
    sw = batches[0].shape[1] * cap
    slack = server.cfg.partition_slack
    while (post > partition_cap(cap, shards, slack)
           or score > partition_cap(sw, shards, slack)):
        slack += 0.25
    return dict(slack=slack, default_holds=slack == server.cfg.partition_slack,
                posting_fill=post / partition_cap(cap, shards, slack),
                score_fill=score / partition_cap(sw, shards, slack),
                shard_cap=partition_cap(cap, shards, slack),
                most_owned=post, most_owned_scores=score)


def check_shard_shapes(server, qt, slack) -> tuple[dict, dict]:
    """impact_scan and topk at the shard shapes of paperish over SHARDS
    shards, on the first shard's partition of one served batch:
    impact_scan on the (Q, shard_cap) local streams over shard_width
    docs, rho from ``owned_prefix_len`` of the cascade's rho; topk on the
    (Q, shard_width) local scores it gives, kp the rerank depth.  Each
    bit-equal to its plain version, timed as phase 1."""
    import torch
    from repro_torch.kernels.impact_scan import kernel as K
    from repro_torch.kernels.impact_scan.ops import owned_prefix_len
    from repro_torch.kernels.topk import kernel as TK
    from repro_torch.kernels.topk import ops
    from repro_torch.retrieval import jass
    from repro_torch.retrieval.index import (block_doc_bounds, partition_cap,
                                             partition_postings)
    e, cfg = server.engine, server.cfg
    dev = e.device
    width = -(-e.n_docs // SHARDS)
    lc = partition_cap(cfg.stream_cap, SHARDS, slack)
    q = torch.from_numpy(qt.astype("int32")).to(dev)
    ds, im = jass.gather_streams(e.offsets, e.pdoc, e.pimp, q,
                                 cap=cfg.stream_cap)
    d, i, gpos, ovf = partition_postings(ds, im, 0, width=width, cap=lc)
    rho = torch.from_numpy(server.params_of(server.predict_classes(qt))
                           .astype("int32")).to(dev)
    r = owned_prefix_len(gpos, rho)
    lo, hi = block_doc_bounds(d, block_p=e.block_p, n_docs=width)
    args = (d, i, r, lo, hi)
    kw = dict(n_docs=width, block_p=e.block_p, block_d=e.block_d)
    got, want = K.impact_scan(*args, **kw), K.impact_scan_plain(*args, **kw)
    if int(ovf.max().cpu().numpy()) or not torch.equal(got, want):
        raise AssertionError("impact_scan differs from its plain version at "
                             "the shard shape")
    qn, p = d.shape
    live = int(r.long().sum().cpu().numpy())
    flat = (torch.arange(qn, device=dev)[:, None] * width
            + d.clamp(min=0).long()).reshape(-1)
    pos = torch.arange(p, device=dev)[None, :]
    contrib = torch.where((pos < r[:, None]) & (d >= 0), i,
                          torch.zeros_like(i)).reshape(-1)
    acc = torch.zeros(qn * width, device=dev)

    def library():
        acc.zero_()
        acc.scatter_add_(0, flat, contrib)

    n_bytes = live * 8 + qn * 4 + 2 * qn * lo.shape[1] * 4 + qn * width * 4
    b_ms, b_by = bound_ms(n_bytes, live)
    is_row = dict(
        name="impact_scan", route="cuda",
        shape=f"Q={qn} P={p} (shard_cap) n_docs={width} (shard_width) "
              f"block_p={e.block_p} block_d={e.block_d}, shard 0 of "
              f"{SHARDS}, rho from owned_prefix_len",
        max_abs_err=float((got - want).abs().max()),
        **timings(lambda: K.impact_scan(*args, **kw),
                  lambda: K.impact_scan_plain(*args, **kw), library),
        bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)

    k = cfg.rerank_depth
    gv, gi = TK.block_topk(got, kp=k, block_n=4096)
    wv, wi = TK.block_topk_plain(got, kp=k, block_n=4096)
    sv, si = ops.topk_select(got, k)
    rv, ri = ops.topk_select(got, k, use_kernel=False)
    if not (torch.equal(gv.view(torch.int32), wv.view(torch.int32))
            and torch.equal(gi, wi) and torch.equal(sv, rv)
            and torch.equal(si, ri)):
        raise AssertionError("topk differs from its plain version at the "
                             "shard shape")
    fin = torch.isfinite(wv)
    n_bytes = qn * width * 4 + qn * -(-width // 4096) * k * 8
    b_ms, b_by = bound_ms(n_bytes, qn * width)
    tk_row = dict(
        name="topk", route="cuda",
        shape=f"Q={qn} N={width} (shard_width) kp={k} block_n=4096",
        max_abs_err=float((gv[fin] - wv[fin]).abs().max()),
        **timings(lambda: TK.block_topk(got, kp=k, block_n=4096),
                  lambda: TK.block_topk_plain(got, kp=k, block_n=4096),
                  lambda: torch.topk(got, k, dim=1)),
        bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
        select_ms=time_ms(lambda: ops.topk_select(got, k)))
    for row in (is_row, tk_row):
        row["ms_over_library_ms"] = row["ms"] / row["library_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
        log("phase 1: shard shape: " + json.dumps(row))
    return is_row, tk_row


def _with_stage_functions(engine, fn):
    """``fn()`` with the engine's stages, and its scheduler's, run as the
    stage functions called directly (the eager path its program cache
    captures) instead of as programs."""
    import functools
    engine._compiled = (lambda name, f, args, kwargs, consts=():
                        functools.partial(f, **kwargs))
    try:
        return fn()
    finally:
        del engine._compiled


def _sharded_programs(sh, batches, ranked) -> dict:
    """Phase 11's programs of one mesh after its counted window: every
    program a CUDA graph, the 4 batches served again replayed and with
    the stage functions called eagerly, each list bit-equal to
    ``ranked``, the wall ms of each (medians over batches 2 on) and the
    programs those batches built (0: the shape is warm)."""
    import numpy as np
    import torch
    e = sh.engine
    stats = e.program_stats()
    if stats["graphs"] != stats["programs"] or not e.n_compiles:
        raise AssertionError(f"phase 11: sharded programs {stats}")
    built0 = e.n_compiles
    walls = {"replayed": [], "eager": []}
    for b, qt in enumerate(batches):
        for how in ("replayed", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (sh.serve_batch(qt) if how == "replayed" else
                   _with_stage_functions(e, lambda: sh.serve_batch(qt)))
            torch.cuda.synchronize()
            walls[how].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(out["ranked"], ranked[b]["ranked"]):
                raise AssertionError(f"phase 11: sharded {how} batch {b} "
                                     "differs from serve_batch")
    if e.n_compiles != built0:
        raise AssertionError(f"phase 11: {e.n_compiles - built0} sharded "
                             "programs built on a warm shape")
    return dict(n_compiles=e.n_compiles, graphs=stats["graphs"],
                static_bytes=stats["static_bytes"],
                built_by_traffic=e.n_compiles - built0,
                lists_bit_equal=True,
                wall_ms={k: statistics.median(v[1:])
                         for k, v in walls.items()})


def sharded_path(sys_, servers, batches, served, report) -> dict:
    """Phase 11: sharded serving on the card, over phase 2's system,
    cascades and batches, each mesh of SHARD_MESHES laid over the card.
    Per knob and mesh, ``RetrievalServer(mesh=...)`` serves the 4 batches
    with the launch counters zeroed just before and read just after:
    the lists must equal phase 2's ``serve_batch`` bit for bit, and
    impact_scan must launch once a shard and data group a batch (topk
    too on rho; k's pool of 10 000 > KP_MAX takes the plain sort).
    Then the mesh's programs (``_sharded_programs``: graphs, replayed
    against eager), ``ShardedEngineBackend`` inline on the data x model
    mesh and ``ContinuousBackend`` over model=4 on the first 128
    requests, replayed and eager, all bit-equal to phase 2.  Each mesh's
    graph pools are freed before the next.  Returns the launches of the
    counted windows."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving import pipeline
    from repro_torch.serving.service import ShardedEngineBackend

    launches = {"impact_scan": 0, "topk": 0}
    shard_rows = None
    mesh_lib.force_host_device_count(4)
    try:
        for knob in ("rho", "k"):
            server, casc, scfg = servers[knob]
            for data, model in SHARD_MESHES:
                need = _partition_need(server, batches, model)
                if not need["default_holds"]:
                    log(f"phase 11: {knob} model={model}: the default "
                        f"partition_slack overflows; serving at "
                        f"{need['slack']}")
                cfg = dataclasses.replace(scfg, partition_slack=need["slack"])
                if knob == "rho" and model == SHARDS and shard_rows is None:
                    shard_rows = check_shard_shapes(server, batches[0],
                                                    need["slack"])
                mesh = mesh_lib.make_serving_mesh(model, data,
                                                  device=server.device)
                sh = pipeline.RetrievalServer(sys_.index, casc, cfg,
                                              device=server.device, mesh=mesh)
                torch.cuda.synchronize()
                outs, per_batch = [], []
                # ---- the counted window: the sharded main path alone ----
                is_kernel.n_launches = tk_kernel.n_launches = 0
                for qt in batches:
                    before = (is_kernel.n_launches, tk_kernel.n_launches)
                    outs.append(sh.serve_batch(qt))
                    per_batch.append((is_kernel.n_launches - before[0],
                                      tk_kernel.n_launches - before[1]))
                got = (is_kernel.n_launches, tk_kernel.n_launches)
                # ---- end of the counted window ----
                want = (data * model, data * model if knob == "rho" else 0)
                if any(pb != want for pb in per_batch):
                    raise AssertionError(f"sharded {knob} {data}x{model}: "
                                         f"launches {per_batch}, not {want}")
                launches["impact_scan"] += got[0]
                launches["topk"] += got[1]
                for b, (out, ref) in enumerate(zip(outs, served[knob])):
                    if not (np.array_equal(out["ranked"], ref["ranked"])
                            and np.array_equal(out["classes"],
                                               ref["classes"])):
                        raise AssertionError(
                            f"sharded {knob} {data}x{model} batch {b} "
                            "differs from serve_batch")
                steady = outs[1:]
                stages = {k: statistics.mean(o["timings"][k] for o in steady)
                          for k in steady[0]["timings"]}
                line = dict(mesh=mesh.shape, shards=model, data_groups=data,
                            shard_width=sh.engine.shard_width,
                            shard_cap=sh.engine.shard_cap,
                            launches_per_batch=per_batch, stage_ms=stages,
                            unsharded_stage_ms=report[knob]["stage_ms"],
                            qps=BATCH / (stages["total_ms"] / 1e3),
                            partition=need,
                            programs=_sharded_programs(sh, batches,
                                                       served[knob]))
                if (data, model) == (2, 2):
                    backend = ShardedEngineBackend(
                        sh, query_len=batches[0].shape[1])
                    res, summary, sgot = _service_run(
                        backend, backend.pad_multiple, batches, "inline",
                        counters=(is_kernel, tk_kernel))
                    for b, rs in enumerate(res):
                        if not np.array_equal(
                                np.stack([r["ranked"] for r in rs]),
                                served[knob][b]["ranked"]):
                            raise AssertionError(
                                f"ShardedEngineBackend {knob} batch {b} "
                                "differs from serve_batch")
                    if (summary["dispatches_per_batch"] != 6
                            or sgot != [w * len(batches) for w in want]):
                        raise AssertionError(
                            f"ShardedEngineBackend {knob}: dispatches "
                            f"{summary['dispatches_per_batch']}, launches "
                            f"{sgot}")
                    line["service_inline"] = dict(
                        qps=summary["qps"], stage_ms=summary["stage_ms"],
                        launches=sgot)
                if (data, model) == (1, SHARDS):
                    qt = batches[0]
                    n0 = sh.engine.n_compiles
                    res, st, wall, cgot, _ = _continuous_run(
                        sh, qt, "inline", chunk_p=None)
                    sched = sorted({k[0] for k in sh.engine._programs.keys()}
                                   & {"sgather", "refill", "chunk",
                                      "finalize"})
                    eres, _, ewall, _, _ = _with_stage_functions(
                        sh.engine, lambda: _continuous_run(
                            sh, qt, "inline", chunk_p=None))
                    for got in (res, eres):
                        if not np.array_equal(
                                np.stack([r["ranked"] for r in got]),
                                served[knob][0]["ranked"]):
                            raise AssertionError(f"sharded continuous {knob} "
                                                 "differs from serve_batch")
                    if len(sched) != 4 or sh.engine.n_compiles - n0 != 4:
                        raise AssertionError(
                            f"sharded continuous {knob}: programs {sched}, "
                            f"built {sh.engine.n_compiles - n0}")
                    cwant = dict(
                        impact_scan=SHARDS * st["n_chunk_calls"],
                        topk=(SHARDS * st["n_finalize_calls"]
                              if knob == "rho" else 0))
                    if cgot != cwant or not st["sharded"]:
                        raise AssertionError(f"sharded continuous {knob}: "
                                             f"launches {cgot}, not {cwant}")
                    line["continuous"] = dict(
                        requests=len(qt), qps=len(qt) / wall,
                        eager_qps=len(qt) / ewall, programs=sched,
                        chunk_p=st["chunk_p"], chunks_max=st["chunks_max"],
                        chunk_dispatches=st["n_chunk_calls"],
                        finalizes=st["n_finalize_calls"], launches=cgot)
                log(f"phase 11: sharded {knob}: " + json.dumps(line))
                # this mesh's graph pools go before the next mesh's
                del sh, outs
                backend = None
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        mesh_lib.force_host_device_count(0)
    return launches, shard_rows


def serve_cli_sharded() -> None:
    """``python -m repro_torch.launch.serve --shards 2
    --force-host-devices 2`` at the verify sizes: exit 0 and its
    ``mesh:`` line."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--knob", "rho",
           "--batch", "30", "--batches", "3", "--n-docs", "2000",
           "--n-queries", "256", "--census", "", "--shards", "2",
           "--force-host-devices", "2"]
    log("phase 11: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=HERE, check=True, timeout=600,
                         capture_output=True, text=True,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(HERE, "src"))
                         ).stdout
    line = [ln for ln in out.splitlines() if ln.startswith("mesh:")]
    if line != ["mesh: {'data': 1, 'model': 2} — candidates over 'model', "
                "batches over data axes (pad grid 8)"]:
        raise AssertionError(f"serve --shards printed {line}")
    log(f"phase 11: serve CLI --shards 2 exit 0 in "
        f"{time.perf_counter() - t0:.1f} s: {line[0]}")


# ------------------------------------------------------------- phase 6 --

#: forests of the offline phase: the phase-2 cascades' size; 3 folds as
#: the JAX package's benchmarks/paper_tables.py runs them
OFFLINE_FOREST = dict(n_trees=10, max_depth=6)
OFFLINE_FOLDS = 3
#: an MLP node's class-0 probability on the card and on the CPU from the
#: same parameters (float32 products in another order)
MLP_P0_ATOL = 1e-6


def _check_methods(name, res, med, cuts):
    """Predictions in [0, c]; the Oracle row and each method's row
    recomputed from the labels and the predictions."""
    import numpy as np
    from repro_torch.core import tradeoff
    c = len(cuts)
    hor = tradeoff.horizon(med, cuts)
    want = [tradeoff.interp_gain(tradeoff.method_point(
        "Oracle", med, res.labels, cuts), hor)]
    for method, pred in res.preds.items():
        if pred.shape != res.labels.shape or pred.min() < 0 \
                or pred.max() > c:
            raise AssertionError(f"{name} {method}: predictions outside "
                                 f"[0, {c}]")
        want.append(tradeoff.interp_gain(tradeoff.method_point(
            method, med, pred, cuts), hor))
    if res.table != want:
        raise AssertionError(f"{name}: table rows differ from the rows "
                             "recomputed from the predictions")
    if not np.isfinite([r["pred_med"] for r in res.table]).all():
        raise AssertionError(f"{name}: a method's MED is not finite")


def offline_path(sys_, meds) -> None:
    """Phase 6: the offline end of the main path on the card at paperish
    (``run_methods``: forests fitted on the host, held-out folds
    predicted on the card): Table 6's setting on the ρ knob with every
    method, Table 4's on the k knob with the cascade only; fold 0's
    cascade and MultiLabel classes on the card, on the CPU and from
    ``run_methods`` (equal); per-node thresholds and Algorithm 2 on one
    fold; an MLP cascade trained on the
    card; the quickstart driver on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import baselines as bl
    from repro_torch.core import cascade as cascade_lib
    from repro_torch.core import experiment as E
    from repro_torch.core import labeling, tradeoff
    from repro_torch.device import fence

    dev = sys_.device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    results = {}
    for knob, table, kinds in (("rho", "table6", ("cascade", "multilabel",
                                                  "metacost")),
                               ("k", "table4", ("cascade",))):
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        t0 = time.perf_counter()
        res = E.run_methods(sys_, meds[knob], cuts, tau=TAU,
                            n_folds=OFFLINE_FOLDS, kinds=kinds,
                            forest_kwargs=OFFLINE_FOREST)
        wall = time.perf_counter() - t0
        _check_methods(f"{table} {knob}", res, meds[knob], cuts)
        results[knob] = res
        rows = [[r["method"], r["pred_k"], r["pred_med"], r["fixed_k"],
                 r["k_gain_pct"], r["fixed_med"], r["med_gain_pct"]]
                for r in res.table]
        log(f"phase 6: {table} ({knob}, MED_RBP <= {TAU}, "
            f"{sys_.queries.n_queries} queries, {OFFLINE_FOLDS} folds, "
            f"{smi}): " + json.dumps({
                "columns": ["method", "mean_cutoff", "realized_med",
                            "fixed_cutoff", "gain_pct", "fixed_med",
                            "med_gain_pct"],
                "rows": rows, "wall_s": wall,
                "host_fit_s": res.seconds["fit"],
                "device_predict_s": res.seconds["predict"],
                "labels": np.bincount(res.labels,
                                      minlength=len(cuts) + 1).tolist()}))

    # per-node thresholds and Algorithm 2 on fold 0 of the rho table
    cuts, med = sys_.rho_cutoffs, meds["rho"]
    labels = labeling.envelope_labels(med, TAU).numpy()
    folds = labeling.stratified_folds(labels, OFFLINE_FOLDS, seed=0)
    tr, te = folds != 0, folds == 0
    x = sys_.features
    casc = cascade_lib.train_cascade(x[tr], labels[tr], n_cutoffs=len(cuts),
                                     forest_kwargs=OFFLINE_FOREST,
                                     device=dev)
    t0 = time.perf_counter()
    tv = cascade_lib.tune_thresholds(casc, x[te], med[te], cuts, TAU)
    t_tune = time.perf_counter() - t0
    xt = torch.from_numpy(x[te]).to(dev)
    tuned = {}
    for name, t in (("tuned", tv), ("t0.8", 0.8), ("t0.85", 0.85)):
        pred = cascade_lib.predict_batched(casc, xt, t).cpu().numpy()
        tuned[name] = dict(
            mean_cutoff=tradeoff.mean_cutoff_value(pred, np.asarray(cuts)),
            in_envelope=tradeoff.pct_under_target(med[te], pred, TAU))
    # run_methods's fold-0 forests refitted (same seed): the card's
    # classes, its CPU classes from the same forests and the rows
    # run_methods gave must all be equal at paperish
    ml = bl.train_multilabel(x[tr], labels[tr], len(cuts) + 1, seed=0)
    xh = torch.from_numpy(x[te])
    host = casc.to("cpu")
    same = {}
    for name, card, cpu in (
            *((f"cascade_t{t}",
               cascade_lib.predict_batched(casc, xt, t),
               cascade_lib.predict_batched(host, xh, t))
              for t in (0.75, 0.80, 0.85)),
            ("multilabel", bl.predict_multilabel(ml, xt),
             bl.predict_multilabel(ml, xh))):
        card = card.cpu().numpy()
        if not (np.array_equal(card, cpu.numpy())
                and np.array_equal(card, results["rho"].preds[name][te])):
            raise AssertionError(f"{name}: fold-0 classes differ between "
                                 "the card, the CPU and run_methods")
        same[name] = int(te.sum())
    n_seq = 64
    batched = cascade_lib.predict_batched(casc, xt[:n_seq], 0.8).cpu().numpy()
    t0 = time.perf_counter()
    seq = [cascade_lib.predict_sequential(casc, row, 0.8)
           for row in x[te][:n_seq]]
    t_seq = time.perf_counter() - t0
    if not np.array_equal(seq, batched):
        raise AssertionError("predict_sequential differs from "
                             "predict_batched at t = 0.8")
    log(f"phase 6: thresholds (rho, fold 0 of {OFFLINE_FOLDS}): "
        + json.dumps({"card_cpu_run_methods_rows_equal": same,
                      "thresholds": tv.tolist(), "tune_s": t_tune,
                      "held_out": int(te.sum()), "by_threshold": tuned,
                      "sequential_rows": n_seq,
                      "sequential_equals_batched": True,
                      "sequential_ms_per_query": t_seq * 1e3 / n_seq}))

    # an MLP cascade trained on the card, its classes against the CPU's
    t0 = time.perf_counter()
    mlp = cascade_lib.train_cascade(x[tr], labels[tr], n_cutoffs=len(cuts),
                                    kind="mlp", device=dev)
    fence(dev)
    t_train = time.perf_counter() - t0
    p_card = mlp.proba0(xt).cpu()
    p_host = mlp.to("cpu").proba0(torch.from_numpy(x[te]))
    diff = float((p_card - p_host).abs().max())
    near = ((p_card - 0.8).abs() <= MLP_P0_ATOL).any(dim=1)
    got = cascade_lib.classes_from_proba(p_card, 0.8)
    want = cascade_lib.classes_from_proba(p_host, 0.8)
    flips = int((got != want).sum())
    if diff > MLP_P0_ATOL or not torch.equal(got[~near], want[~near]):
        raise AssertionError(f"mlp cascade: card and CPU differ (max p0 "
                             f"diff {diff}, {flips} classes)")
    pred = got.numpy()
    log("phase 6: mlp cascade (rho, fold 0, default train_mlp): "
        + json.dumps({
            "train_s": t_train, "max_p0_abs_diff_card_cpu": diff,
            "rows_within_atol_of_t": int(near.sum()),
            "classes_differing": flips,
            "mean_cutoff_t0.8": tradeoff.mean_cutoff_value(
                pred, np.asarray(cuts)),
            "in_envelope_t0.8": tradeoff.pct_under_target(med[te], pred,
                                                          TAU)}))
    quickstart_cli()


def quickstart_cli() -> None:
    """``python -m repro_torch.examples.quickstart`` as a user runs it,
    on the card and on the CPU: the two tables must be equal (forests
    fitted on the host; predictions add the trees in the same order on
    both devices)."""
    tables, walls = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.quickstart",
             "--device", device], cwd=HERE, check=True, timeout=600,
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        ).stdout
        walls[device] = time.perf_counter() - t0
        lines = out.splitlines()
        head = next(i for i, ln in enumerate(lines) if "mean-k" in ln)
        tables[device] = lines[head:head + 6]
    if tables["cuda"] != tables["cpu"] or len(tables["cuda"]) != 6:
        raise AssertionError(f"quickstart tables differ: {tables}")
    for ln in tables["cuda"]:
        log("phase 6: quickstart |" + ln)
    log("phase 6: quickstart " + json.dumps({
        "tables_equal": True, "wall_s_cuda": walls["cuda"],
        "wall_s_cpu": walls["cpu"]}))


# ------------------------------------------------------------ phase 12 --

#: the recsys archs the port trains (``python -m repro_torch.launch.train``)
TRAIN_ARCHS = ("wide-deep", "dien", "bst", "mind")
#: configs/recsys_common.py RECSYS_SHAPES["train_batch"]
TRAIN_BATCH = 65536
TRAIN_STEPS, TRAIN_PREEMPT = 6, 3
#: the card against the CPU at each smoke config: steps, batch, and the
#: relative tolerance of the losses (float32 sums in another order)
TRAIN_CPU_STEPS, TRAIN_CPU_BATCH, TRAIN_CPU_RTOL = 8, 64, 1e-5
#: BST's gradients through the kernel against the plain attention at
#: the full config (float32, relative to each leaf's largest magnitude)
GRAD_BATCH, GRAD_RTOL = 256, 2e-5
#: the gather backward against a float64 sum, relative to the largest
#: row's magnitude (float32 sums of up to 2.4 M values)
GATHER_RTOL = 1e-4


def train_cli(arch: str, ckpt_dir: str, *extra: str):
    """``python -m repro_torch.launch.train`` at the full config on the
    card, as a user runs it: its printed lines and its ``report:``, every
    loss finite."""
    import math
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--full", "--steps", str(TRAIN_STEPS), "--batch",
           str(TRAIN_BATCH), "--device", "cuda", "--ckpt-dir", ckpt_dir,
           *extra]
    log("phase 12: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, cwd=HERE, timeout=900, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    for ln in lines[:-1]:
        log("phase 12: | " + ln)
    report = json.loads(lines[-1].removeprefix("report: "))
    report["wall_s"] = time.perf_counter() - t0
    if len(report["losses"]) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in report["losses"]):
        raise AssertionError(f"{arch}: losses {report['losses']}")
    return lines, report


def _same_checkpoints(a: str, b: str) -> int:
    """Raise unless the newest checkpoints under ``a`` and ``b`` hold the
    same leaves bit for bit; returns their bytes."""
    import numpy as np
    from repro_torch.ckpt import checkpoint as ckpt
    dirs = [os.path.join(p, f"step_{ckpt.latest_step(p):08d}")
            for p in (a, b)]
    manifests = []
    for d in dirs:
        with open(os.path.join(d, "manifest.json")) as f:
            manifests.append(json.load(f))
    if manifests[0]["leaves"] != manifests[1]["leaves"]:
        raise AssertionError("the two checkpoints hold other leaves")
    n_bytes = 0
    for rec in manifests[0]["leaves"]:
        x, y = (np.load(os.path.join(d, rec["file"])) for d in dirs)
        if x.tobytes() != y.tobytes():
            raise AssertionError(f"restart differs from the clean run at "
                                 f"{rec['name']}")
        n_bytes += x.nbytes
    return n_bytes


def train_runs() -> int:
    """Phase 12, part 1: each arch through the CLI at its full config and
    the train_batch shape, 6 steps, checkpoints in a directory the phase
    removes; then BST again with a preemption at step 3, whose final
    checkpoint must equal the clean run's bit for bit.  Returns the flash
    launches of the clean BST run (one a step)."""
    import shutil
    root = os.path.join(HERE, "build", "phase12_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    try:
        launches = None
        for arch in TRAIN_ARCHS:
            _, rep = train_cli(arch, os.path.join(root, arch))
            steady = rep["step_ms"][1:]
            med = statistics.median(steady)
            want = TRAIN_STEPS if arch == "bst" else 0
            if rep["flash_launches"] != want:
                raise AssertionError(f"{arch}: {rep['flash_launches']} flash "
                                     f"launches in {TRAIN_STEPS} steps")
            log(f"phase 12: {arch}: " + json.dumps(dict(
                batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                step_ms_median_2_6=med, step_ms=rep["step_ms"],
                samples_per_s=TRAIN_BATCH / med * 1e3,
                peak_bytes=rep["peak_bytes"],
                model_flops_per_step=rep["model_flops"],
                model_tflops_per_s=rep["model_flops"] / med / 1e9,
                ckpt=[{k: w[k] for k in ("step", "bytes", "seconds")}
                      for w in rep["ckpt"]],
                flash_launches=rep["flash_launches"],
                loss_first=rep["losses"][0], loss_last=rep["losses"][-1],
                wall_s=rep["wall_s"])))
            if arch == "bst":
                launches = rep["flash_launches"]
            else:
                shutil.rmtree(os.path.join(root, arch))
        lines, rep = train_cli("bst", os.path.join(root, "bst_preempt"),
                               "--preempt-at", str(TRAIN_PREEMPT))
        if "restarts=1" not in lines[0]:
            raise AssertionError(f"preempted BST run: {lines[0]}")
        n_bytes = _same_checkpoints(os.path.join(root, "bst"),
                                    os.path.join(root, "bst_preempt"))
        log(f"phase 12: bst restart at step {TRAIN_PREEMPT}: final "
            f"checkpoint equal to the clean run's bit for bit ({n_bytes} "
            f"bytes of parameters and optimizer state)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def bst_grad_check(dev) -> dict:
    """Phase 12, part 2: BST's gradients at the full config (batch 256)
    through the kernel (one launch) equal those through the plain
    attention within GRAD_RTOL of each leaf's largest magnitude, and the
    attention path's leaves get nonzero gradients."""
    import torch
    from repro_torch.configs import bst as bst_configs
    from repro_torch.data import recsys_data
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models.recsys import bst
    from repro_torch.tree import leaves_with_paths

    cfg = bst_configs.model_config()
    params = bst.init_bst(cfg, seed=0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             recsys_data.bst_batch(cfg, GRAD_BATCH, 0).items()}
    flat = leaves_with_paths(params)
    names = ["::".join(map(str, path)) for path, _ in flat]

    def grads(use_kernel):
        for _, p in flat:
            p.requires_grad_(True)
        loss = bst.bst_loss(params, cfg, batch, use_kernel=use_kernel)
        g = torch.autograd.grad(loss, [p for _, p in flat])
        for _, p in flat:
            p.requires_grad_(False)
        return float(loss.detach()), g

    K.n_launches = 0
    loss_k, g_k = grads(True)
    loss_p, g_p = grads(False)
    if K.n_launches != 1:
        raise AssertionError(f"{K.n_launches} flash launches for one "
                             "kernel-path loss and one plain loss")
    rel = {}
    for name, a, b in zip(names, g_k, g_p):
        scale = float(b.abs().max())
        rel[name] = float((a - b).abs().max()) / scale if scale else 0.0
        if rel[name] > GRAD_RTOL:
            raise AssertionError(f"BST gradient of {name} through the kernel "
                                 f"differs by {rel[name]} of its scale")
    for name in ("blocks::0::wq", "blocks::0::wk", "blocks::0::wv",
                 "item_table"):
        if not bool(g_k[names.index(name)].abs().max() > 0):
            raise AssertionError(f"zero gradient of {name} through the "
                                 "kernel")
    return dict(batch=GRAD_BATCH, loss_kernel=loss_k, loss_plain=loss_p,
                launches=1, rel_err={n: rel[n] for n in (
                    "blocks::0::wq", "blocks::0::wk", "blocks::0::wv",
                    "item_table")}, max_rel_err=max(rel.values()))


def train_card_vs_cpu(dev) -> dict:
    """Phase 12, part 3: each arch at its smoke config, 8 steps on the
    card and on the CPU from the same seeded parameters and batches:
    the losses within TRAIN_CPU_RTOL relative."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    out = {}
    for arch in TRAIN_ARCHS:
        cfg = cfgbase.get(arch).smoke_config()
        init_fn, loss_fn, batch_fn = train.FAMILIES[arch]
        losses = []
        for d in (dev, torch.device("cpu")):
            params = init_fn(cfg, seed=0, device=d)
            opt = adamw.init_opt_state(params)
            step = train.make_step(loss_fn, cfg, adamw.AdamWConfig(
                lr=3e-3, weight_decay=1e-5))
            ls = []
            for i in range(TRAIN_CPU_STEPS):
                batch = {k: torch.from_numpy(v).to(d) for k, v in
                         batch_fn(cfg, TRAIN_CPU_BATCH, i, seed=1).items()}
                params, opt, m = step(params, opt, batch)
                ls.append(float(m["loss"]))
            losses.append(ls)
        rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        if rel > TRAIN_CPU_RTOL:
            raise AssertionError(f"{arch}: card losses {losses[0]} against "
                                 f"CPU {losses[1]}")
        out[arch] = rel
    return out


def gather_determinism(dev) -> dict:
    """Phase 12, part 4: the recsys gather's backward (``scatter_rows``)
    at DIEN's full history shape (65 536 x 100 ids over 1 M items, the
    padding read as row 0) must give the same bits twice, within
    GATHER_RTOL of a float64 sum (of the largest row's magnitude: row 0
    adds some 2.4 M values in order); beside it, whether ``index_put_``
    with accumulate (the plain gather's backward) and ``index_add_``
    gave the same bits twice, their errors, and one call's times
    (``unchunked_ms``: ``scatter_rows`` with one chunk a run, each run
    summed by one thread)."""
    import torch
    from repro_torch.configs import dien as dien_configs
    from repro_torch.data import recsys_data
    from repro_torch.models import layers
    from repro_torch.models.layers import scatter_rows

    cfg = dien_configs.model_config()
    ids = torch.from_numpy(recsys_data.dien_batch(
        cfg, TRAIN_BATCH, 0)["hist_items"]).to(dev).clamp(min=0).reshape(-1)
    ids = ids.long()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((ids.numel(), cfg.embed_dim), generator=gen,
                       device=dev)
    v = cfg.item_vocab

    def index_put():
        return torch.zeros((v, cfg.embed_dim), device=dev).index_put_(
            (ids,), rows, accumulate=True)

    def index_add():
        return torch.zeros((v, cfg.embed_dim), device=dev).index_add_(
            0, ids, rows)

    def rel_err(x):
        return float((x.double() - exact).abs().max()) / scale

    exact = torch.zeros((v, cfg.embed_dim), dtype=torch.float64,
                        device=dev).index_add_(0, ids, rows.double())
    scale = float(exact.abs().max())
    a, b = scatter_rows(rows, ids, v), scatter_rows(rows, ids, v)
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("scatter_rows differs between two calls")
    err = rel_err(a)
    if err > GATHER_RTOL:
        raise AssertionError(f"scatter_rows differs from a float64 sum by "
                             f"{err} of the largest row")
    ref = index_put()
    chunk = layers.SCATTER_CHUNK
    layers.SCATTER_CHUNK = ids.numel()         # one chunk a run
    try:
        unchunked_ms = time_ms(lambda: scatter_rows(rows, ids, v), reps=5)
    finally:
        layers.SCATTER_CHUNK = chunk
    return dict(ids=ids.numel(), rows=v, dim=cfg.embed_dim,
                row0_count=int((ids == 0).sum()), rel_err=err,
                index_put_rel_err=rel_err(ref),
                index_put_bit_equal=bool(torch.equal(
                    ref.view(torch.int32), index_put().view(torch.int32))),
                index_add_bit_equal=bool(torch.equal(
                    index_add().view(torch.int32),
                    index_add().view(torch.int32))),
                ms=time_ms(lambda: scatter_rows(rows, ids, v), reps=5),
                unchunked_ms=unchunked_ms,
                index_put_ms=time_ms(index_put, reps=5),
                library_ms=time_ms(index_add, reps=5))


def check_flash_train(dev, bst_cfg) -> dict:
    """flash_attention at BST's training shape (train_batch rows x 8
    heads, S 21, hd 4, on BST's (B, S, H, hd) views): the kernel within
    2e-5 of the plain attention, ``flash_attention_bwd`` and the blocked
    backward training runs (``flash_attention_bwd_blocked``, one block
    at S 21) within 2e-5 (of each gradient's largest magnitude) of
    autograd through the plain attention; one call's times, SDPA's, and
    each backward's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = _bst_qkv(TRAIN_BATCH, bst_cfg, randn)
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    o = ops.flash_attention(q, k, v, causal=False)
    err = float((o - attention_ref_bshd(q, k, v, causal=False)).abs().max())
    if err > 2e-5:
        raise AssertionError(f"flash_attention at the training shape "
                             f"differs by {err}")
    do = randn(*o.shape)
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=False)
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref_bshd(*xs, causal=False), xs, do)
    bwd_err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
    if bwd_err > 2e-5:
        raise AssertionError(f"flash_attention_bwd differs from autograd "
                             f"by {bwd_err} of the gradient's scale")
    blocked = ops.flash_attention_bwd_blocked(q, k, v, o, do, causal=False)
    blocked_err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(blocked, want))
    if blocked_err > 2e-5:
        raise AssertionError(f"flash_attention_bwd_blocked differs from "
                             f"autograd by {blocked_err} of the gradient's "
                             "scale")
    del xs, want, got, blocked
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    n_bytes = 4 * q.numel() * q.element_size()
    b_ms, b_by = bound_ms(n_bytes, 4 * TRAIN_BATCH * h * s * s * hd)

    def call():
        return ops.flash_attention(q, k, v, causal=False)

    return dict(
        shape=f"B={TRAIN_BATCH} S={s} H={h} hd={hd} float32 non-causal",
        max_abs_err=err, backward_max_rel_err=bwd_err,
        ms=time_ms(call), device_ms=time_ms(call, hold=True),
        plain_ms=time_ms(lambda: attention_ref_bshd(q, k, v, causal=False)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=hd ** -0.5)),
        backward_ms=time_ms(lambda: ops.flash_attention_bwd(
            q, k, v, o, do, causal=False), reps=10),
        blocked_backward_max_rel_err=blocked_err,
        blocked_backward_ms=time_ms(lambda: ops.flash_attention_bwd_blocked(
            q, k, v, o, do, causal=False), reps=10),
        bound_ms=b_ms, bound_by=b_by)


def train_path(dev, bst_cfg) -> dict:
    """Phase 12: training on the card.  Returns the flash row's ``train``
    field: the kernel at the training shape and its launches in the
    clean BST run."""
    import torch
    torch.cuda.empty_cache()
    log(f"phase 12: this process holds {torch.cuda.memory_allocated()} "
        f"bytes of device memory ({torch.cuda.memory_reserved()} "
        "reserved) beside the training runs")
    launches = train_runs()
    log("phase 12: bst gradients, kernel against plain: "
        + json.dumps(bst_grad_check(dev)))
    log("phase 12: card against CPU, max relative loss difference over "
        f"{TRAIN_CPU_STEPS} steps: " + json.dumps(train_card_vs_cpu(dev)))
    log("phase 12: gather backward: " + json.dumps(gather_determinism(dev)))
    row = check_flash_train(dev, bst_cfg)
    log("phase 1: training shape: " + json.dumps(row))
    torch.cuda.empty_cache()
    return dict({k: row[k] for k in ("shape", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "backward_ms",
                                     "blocked_backward_ms")},
                launches=launches)


# ------------------------------------------------------------ phase 13 --

#: phase 13: tinyllama-1.1b at full width serves LM_BATCH prompts of
#: train_4k's length, then LM_DECODE greedy decode steps
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "tinyllama-1.1b", 8, 4096, 32
#: prefill calls of the counted window: one warm-up, then the timed ones
LM_PREFILLS = 4
#: the decode_32k shape's cache length, and the batches tried, largest
#: first (the shape's own is 128)
LM_LONG_CACHE, LM_LONG_BATCHES = 32768, (128, 64, 32)
#: smoke configs, card against the CPU port: prompt lengths (mixtral's
#: crosses its window of 16), decode steps and the float32 tolerance of
#: tests/test_torch_lm.py
LM_SMOKE = (("tinyllama-1.1b", 24), ("qwen2-0.5b", 24), ("qwen3-4b", 24),
            ("mixtral-8x22b", 32), ("deepseek-v3-671b", 24))
LM_SMOKE_STEPS, LM_SMOKE_TOL = 8, 2e-5
#: the replayed decode (``serving.decode.DecodePrograms``): the step at
#: which its program is built, on that step's own inputs, in the middle
#: of the generation (the steps before it run eagerly)
LM_REPLAY_FROM = 5
#: bf16 tolerance of tinyllama's logits, absolute: two bf16 steps at
#: |logit| in [4, 8).  The logits are bf16 products widened to float32;
#: the kernel path against the plain one, and a decode step against a
#: prefill, round the bf16 residual stream at other places (0.03125 on
#: each check on an H100 80GB HBM3 at 700 W)
LM_ATOL = 0.0625


def _lm_handoff(cache, pre) -> None:
    """The prefill's keys and values (MLA: its latent and rope key) into
    slots [0, clen) of ``cache``."""
    for g in pre:
        for x in pre[g]:
            cache[g][x][:, :, :pre[g][x].shape[2]] = pre[g][x]


def _fenced(fn):
    """fn's result and its host ms between two device-wide fences."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _step_ms(fn, reps: int = 5) -> tuple[float, float]:
    """Medians over ``reps`` calls of ``fn`` after one: the wall ms from
    a fence to the fence after the call, and the host ms of the call
    alone (its return, before that fence).  A decode step enqueues some
    2000 kernels, more than the launch queue holds, so a sleep kernel
    holding the card would block the host; with the card free the host
    enqueues as the device drains, and where the host is the slower the
    two times are nearly one."""
    import torch
    fn()
    walls, hosts = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        hosts.append((t1 - t0) * 1e3)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), statistics.median(hosts)


def _step_profile(fn, wall_ms: float) -> dict:
    """One step under the profiler: its CUDA activities, the device-busy
    ms (the union of their intervals) and the idle share of ``wall_ms``."""
    act = _cuda_activities(fn, calls=2)
    if act is None:
        return {"cuda_activities_per_step": None}
    return dict(cuda_activities_per_step=act["per_call"],
                activity_kinds=len(act["names"]),
                device_busy_ms=act["busy_ms"],
                idle_share=1 - act["busy_ms"] / wall_ms,
                top_device_ms=act["top_ms"])


def _hold_logits(name, got, want, tol) -> dict:
    """got against want ((B, V) float32): the largest difference within
    ``tol``, and the greedy tokens equal wherever want's top-2 margin
    exceeds ``tol`` (the rows under it are counted)."""
    import torch
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    if not err <= tol or not bool(same[decided].all()):
        raise AssertionError(f"phase 13: {name}: logits differ by {err} "
                             f"(tolerance {tol}); greedy tokens differ in "
                             f"{int((~same & decided).sum())} rows with a "
                             "decided top-2 margin")
    return dict(max_abs_err=err, margins_under_tol=int((~decided).sum()),
                rows=int(want.shape[0]))


def _lm_smoke_serve(cfg, toks, device):
    """Prefill and LM_SMOKE_STEPS greedy steps on ``device``: the
    prefill's and each step's logits and the steps' tokens, on the
    CPU."""
    import torch
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=0, device=device)
    logits, pre = T.prefill(params, cfg, torch.from_numpy(toks).to(device))
    b, s = toks.shape
    cache = T.init_cache(cfg, b, s + LM_SMOKE_STEPS, device=device)
    _lm_handoff(cache, pre)
    out, tokens = [logits.cpu()], []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(LM_SMOKE_STEPS):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
        tok, lg, cache = T.decode_step(params, cfg, cache, tok, pos)
        out.append(lg.cpu())
        tokens.append(tok.cpu())
    return out, tokens


def lm_smoke_card_vs_cpu(dev) -> dict:
    """Each served arch's smoke config (float32) on the card against the
    same calls on the CPU port: greedy tokens equal, logits within
    LM_SMOKE_TOL; a GQA prefill launches flash once a layer, deepseek's
    MLA (value head dim 16 against 24) takes the plain torch path and
    launches none.  Returns the largest difference per arch."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import lm_pipeline
    from repro_torch.kernels.flash_attention import kernel as fa_k
    errs = {}
    for arch, s in LM_SMOKE:
        cfg = cfgbase.get(arch).smoke_config()
        toks = lm_pipeline.LMPipeline(lm_pipeline.LMDataConfig(
            vocab=cfg.vocab, batch=2, seq_len=s, seed=1)).batch(0)["tokens"]
        before = fa_k.n_launches
        card, card_toks = _lm_smoke_serve(cfg, toks, dev)
        want = 0 if cfg.attn_type == "mla" else cfg.n_layers
        if fa_k.n_launches - before != want:
            raise AssertionError(f"phase 13: {arch} smoke prefill launched "
                                 f"flash {fa_k.n_launches - before} times")
        cpu, cpu_toks = _lm_smoke_serve(cfg, toks, torch.device("cpu"))
        for a, b in zip(card_toks, cpu_toks):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 13: {arch} smoke greedy tokens "
                                     "differ, card against CPU")
        errs[arch] = max(float((a - b).abs().max())
                         for a, b in zip(card, cpu))
        if not errs[arch] <= LM_SMOKE_TOL:
            raise AssertionError(f"phase 13: {arch} smoke logits differ by "
                                 f"{errs[arch]}, card against CPU")
    return errs


def lm_long_cache_step(params, cfg, dev):
    """One decode step at decode_32k's cache length and the largest of
    LM_LONG_BATCHES whose cache fits, on a cache filled from a seeded
    generator with every row at position 32 767: timing only (no
    prefill made the cache; every logit must be finite).  Returns its
    row and the step (which holds the cache)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    per_row = (2 * cfg.n_layers * LM_LONG_CACHE * cfg.n_kv_heads
               * cfg.head_dim * torch.finfo(cfg.torch_dtype).bits // 8)
    free = torch.cuda.mem_get_info(dev)[0]
    fits = [b for b in LM_LONG_BATCHES if b * per_row + (4 << 30) < free]
    if not fits:
        raise AssertionError(f"phase 13: no decode_32k batch of "
                             f"{LM_LONG_BATCHES} fits in {free} free bytes")
    b = fits[0]
    gen = torch.Generator(device=dev).manual_seed(32)
    cache = T.init_cache(cfg, b, LM_LONG_CACHE, device=dev)
    for x in leaves(cache):
        x.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos = torch.full((b,), LM_LONG_CACHE - 1, dtype=torch.int32, device=dev)

    def step():
        return T.decode_step(params, cfg, cache, tok, pos)

    _, logits, _ = step()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 13: decode_32k logits are not finite")
    ms, enqueue_ms = _step_ms(step)
    replayed_row, replayed = _decode_replayed_long(params, cfg, cache, tok,
                                                   pos, logits, dev)
    w_bytes = sum(x.numel() * x.element_size() for x in leaves(params))
    e = params["embed"]
    n_bytes = (w_bytes - e.numel() * e.element_size()
               + b * e.shape[1] * e.element_size() + b * per_row)
    row = dict(use="timing only: a cache filled from a seeded generator, "
                   "no prefill", batch=b, batches_tried=list(LM_LONG_BATCHES),
               cache_len=LM_LONG_CACHE, position=LM_LONG_CACHE - 1,
               cache_bytes=b * per_row, step_ms=ms, host_ms=enqueue_ms,
               tokens_per_s=b / (ms / 1e3), bytes_read=n_bytes,
               gb_per_s=n_bytes / ms / 1e6,
               bytes_bound_ms=n_bytes / HBM_BYTES_S * 1e3,
               replayed=replayed_row)
    return row, step, replayed


def _decode_programs_row(progs, build_ms, added) -> dict:
    stats = progs.stats()
    if stats["graphs"] != stats["programs"]:
        raise AssertionError(f"phase 13: a decode program is not a CUDA "
                             f"graph: {stats}")
    return dict(programs_built=progs.n_compiles, build_s=build_ms / 1e3,
                memory_reserved_added_bytes=added,
                static_bytes=stats["static_bytes"])


def _decode_replayed_long(params, cfg, cache, tok, pos, logits, dev):
    """decode_32k's step through ``DecodePrograms`` on the same cache and
    inputs: its build (the first call, which writes the slot the eager
    step wrote), logits bit-equal to the eager step's, and a replayed
    step's wall and host ms.  Returns the row and the replayed step."""
    import torch
    from repro_torch.serving.decode import DecodePrograms
    progs = DecodePrograms(params, cfg)

    def replayed():
        return progs(params, cache, tok, pos)

    torch.cuda.empty_cache()     # the side stream's build takes fresh blocks
    r0 = torch.cuda.memory_reserved(dev)
    (_, got, _), build_ms = _fenced(replayed)
    added = torch.cuda.memory_reserved(dev) - r0
    if not torch.equal(got, logits):
        raise AssertionError("phase 13: decode_32k replayed logits differ "
                             "from the eager step's")
    ms, enqueue_ms = _step_ms(replayed)
    return dict(_decode_programs_row(progs, build_ms, added),
                logits_bit_equal=True, step_ms=ms, host_ms=enqueue_ms), \
        replayed


def lm_replayed_decode(params, cfg, cache, gen_tokens, step_logits, s, dev):
    """The LM_DECODE greedy steps again, through ``DecodePrograms`` on
    ``cache`` (a copy of the eager run's cache as the prefill handed it
    over): steps before LM_REPLAY_FROM eagerly, the program built at
    that step on its own token and positions, the rest replayed.  Every
    step's token and logits must be bit-equal to the eager run's.
    Returns the row (programs built, build s, the ``memory_reserved`` the
    build added, one replayed step's wall and host ms) and that step
    (the last, again) as a call."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import DecodePrograms
    progs = DecodePrograms(params, cfg)
    b = gen_tokens[0].shape[0]
    tok, build_ms, added = gen_tokens[0], None, None
    for i in range(LM_DECODE):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        if i + 1 < LM_REPLAY_FROM:
            tok, lg, _ = T.decode_step(params, cfg, cache, tok, pos)
        elif i + 1 == LM_REPLAY_FROM:
            torch.cuda.synchronize()
            r0 = torch.cuda.memory_reserved(dev)
            (tok, lg, _), build_ms = _fenced(
                lambda tok=tok, pos=pos: progs(params, cache, tok, pos))
            added = torch.cuda.memory_reserved(dev) - r0
        else:
            tok, lg, _ = progs(params, cache, tok, pos)
        if not (torch.equal(tok, gen_tokens[i + 1])
                and torch.equal(lg, step_logits[i])):
            raise AssertionError(f"phase 13: replayed decode step {i + 1} "
                                 "differs from the eager step")
    last = torch.full((b,), s + LM_DECODE - 1, dtype=torch.int32, device=dev)

    def step():
        return progs(params, cache, gen_tokens[-2], last)

    wall_ms, enqueue_ms = _step_ms(step)
    return dict(_decode_programs_row(progs, build_ms, added), batch=b,
                built_at_step=LM_REPLAY_FROM, steps_bit_equal=LM_DECODE,
                replays=progs.stats()["replays"], step_wall_ms=wall_ms,
                host_ms=enqueue_ms), step


def lm_path(dev) -> tuple:
    """Phase 13: tinyllama-1.1b served at full width (``model_config()``,
    bf16, seeded random weights): LM_PREFILLS prefills of LM_BATCH
    prompts of LM_PROMPT tokens (one warm-up, then timed), the last
    one's cache handed to a cache of LM_PROMPT + LM_DECODE, then
    LM_DECODE greedy decode steps; the kernel launches counted over that
    window.  Then the checks (row 0 against the plain path, decode steps
    1 and LM_DECODE against a prefill of the prompt and the generated
    tokens), one step's wall and host time, the decode_32k shape, the
    smoke configs card against CPU, and last the profiler over one step
    at each shape.
    Returns the launches of the counted window, with the flash launches
    by route under ``flash_routes`` (all ``general_tc``), and the one
    decode step at batch 8 as a call (phase 16 arms the sync sanitizer
    around it; it holds the parameters and cache until dropped)."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.configs import lm_common
    from repro_torch.data import lm_pipeline
    from repro_torch.kernels.embedding_bag import kernel as eb_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.impact_scan import kernel as is_k
    from repro_torch.kernels.topk import kernel as tk_k
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, map_tree

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = cfgbase.get(LM_ARCH).model_config()
    b, s = LM_BATCH, LM_PROMPT
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    w_bytes = sum(x.numel() * x.element_size() for x in leaves(params))
    log(f"phase 13: {LM_ARCH} model_config() {cfg.dtype}: "
        f"{cfg.param_count()} parameters, {w_bytes} bytes, drawn in "
        f"{draw_s:.3f} s of host time (seed 0)")
    toks_np = lm_pipeline.LMPipeline(lm_pipeline.LMDataConfig(
        vocab=cfg.vocab, batch=b, seq_len=s, seed=1)).batch(0)["tokens"]
    toks = torch.from_numpy(toks_np).to(dev)

    # ---- the counted window: the served prompts and their decode ----
    for mod in (is_k, tk_k, fa_k, eb_k):
        mod.n_launches = 0
    fa_k.route_launches.clear()
    prefill_ms = []
    for _ in range(LM_PREFILLS):
        pre = None                       # free the last one's cache first
        (logits, pre), ms = _fenced(lambda: T.prefill(params, cfg, toks))
        prefill_ms.append(ms)
    prefill_launches = fa_k.n_launches
    cache = T.init_cache(cfg, b, s + LM_DECODE, device=dev)
    _lm_handoff(cache, pre)
    del pre
    handed = map_tree(torch.clone, cache)     # for the replayed decode
    tok = torch.argmax(logits, -1).to(torch.int32)
    gen_tokens, step_logits, step_ms = [tok], [], []
    for i in range(LM_DECODE):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        (tok, lg, cache), ms = _fenced(
            lambda tok=tok, pos=pos: T.decode_step(params, cfg, cache, tok,
                                                   pos))
        gen_tokens.append(tok)
        step_logits.append(lg)
        step_ms.append(ms)
    launches = {"impact_scan": is_k.n_launches, "topk": tk_k.n_launches,
                "flash_attention": fa_k.n_launches,
                "embedding_bag": eb_k.n_launches}
    flash_routes = dict(fa_k.route_launches)
    # ---- end of the counted window ----
    peak = torch.cuda.max_memory_allocated(dev)
    if (prefill_launches != LM_PREFILLS * cfg.n_layers
            or launches["flash_attention"] != prefill_launches
            or flash_routes != {"general_tc": prefill_launches}):
        raise AssertionError(f"phase 13: flash launched {prefill_launches} "
                             f"times in {LM_PREFILLS} prefills and "
                             f"{launches['flash_attention']} in the window, "
                             f"by route {flash_routes}")
    for name, x in [("prefill", logits)] + [
            (f"decode step {i + 1}", lg) for i, lg in enumerate(step_logits)]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"phase 13: {name} logits are not finite")

    timed = prefill_ms[1:]
    p_ms = statistics.median(timed)
    p_flops = lm_common.model_flops(cfg, "prefill", b, s)
    log("phase 13: prefill " + json.dumps(dict(
        batch=b, prompt=s, ms=timed, median_ms=p_ms,
        warmup_ms=prefill_ms[0], tokens_per_s=b * s / (p_ms / 1e3),
        model_flops=p_flops, model_tflops_per_s=p_flops / p_ms / 1e9,
        flash_launches_per_prefill=prefill_launches / LM_PREFILLS,
        launches=launches, flash_routes=flash_routes)))

    # the plain path on the card for row 0, and the decode steps against
    # the kernel path's prefill of the prompt and the generated tokens
    checks = {}
    plain, _ = T.prefill(params, cfg, toks[:1], use_kernel=False)
    checks["row 0, kernel against plain"] = _hold_logits(
        "row 0, kernel against plain", logits[:1], plain, LM_ATOL)
    del plain
    for i in (1, LM_DECODE):
        seq = torch.cat([toks] + [t[:, None] for t in gen_tokens[:i]],
                        dim=1)
        want, _ = T.prefill(params, cfg, seq)
        checks[f"decode step {i} against a prefill of {s + i}"] = \
            _hold_logits(f"decode step {i}", step_logits[i - 1], want,
                         LM_ATOL)
        del want, seq
    torch.cuda.empty_cache()
    log(f"phase 13: checks at tolerance {LM_ATOL}: " + json.dumps(checks))

    # one decode step alone (the last, again): wall and host time
    last = torch.full((b,), s + LM_DECODE - 1, dtype=torch.int32, device=dev)

    def step():
        return T.decode_step(params, cfg, cache, gen_tokens[-2], last)

    d_ms = statistics.median(step_ms[1:])
    wall_ms, enqueue_ms = _step_ms(step)
    e = params["embed"]
    c_bytes = sum(x.numel() * x.element_size() for x in leaves(cache))
    n_bytes = (w_bytes - e.numel() * e.element_size()
               + b * e.shape[1] * e.element_size() + c_bytes)
    decode = dict(
        batch=b, cache_len=s + LM_DECODE, steps=LM_DECODE,
        median_ms_steps_2_on=d_ms, step1_ms=step_ms[0],
        tokens_per_s=b / (d_ms / 1e3), bytes_read=n_bytes,
        weight_bytes=w_bytes, cache_bytes=c_bytes,
        gb_per_s=n_bytes / d_ms / 1e6,
        bytes_bound_ms=n_bytes / HBM_BYTES_S * 1e3,
        step_wall_ms=wall_ms, host_ms=enqueue_ms,
        max_memory_allocated=peak,
        decode_flops=lm_common.model_flops(cfg, "decode", b, s))
    log("phase 13: decode " + json.dumps(decode))
    rep_row, rep_step = lm_replayed_decode(params, cfg, handed, gen_tokens,
                                           step_logits, s, dev)
    log("phase 13: decode replayed " + json.dumps(dict(
        rep_row, eager=dict(step_wall_ms=wall_ms, host_ms=enqueue_ms))))
    del step_logits
    long_row, long_step, long_rep = lm_long_cache_step(params, cfg, dev)
    log("phase 13: decode_32k shape " + json.dumps(long_row))
    log("phase 13: smoke configs, card against CPU, max abs logit "
        "difference " + json.dumps(lm_smoke_card_vs_cpu(dev)))
    # last, so that the profiler runs after every timed part
    log("phase 13: one decode step under the profiler " + json.dumps(
        {f"batch {b}": _step_profile(step, wall_ms),
         f"batch {b} replayed": _step_profile(rep_step,
                                              rep_row["step_wall_ms"]),
         "decode_32k": _step_profile(long_step, long_row["step_ms"]),
         "decode_32k replayed": _step_profile(
             long_rep, long_row["replayed"]["step_ms"])}))
    del long_step, long_rep
    torch.cuda.empty_cache()
    return dict(launches, flash_routes=flash_routes), step, rep_step


# ------------------------------------------------------------ phase 14 --

#: phase 14: tinyllama-1.1b trained at full width through the CLI (the
#: train_4k shape with its global batch of 256 cut to 8), the steps,
#: the flash launches a step (each layer's forward and its recompute
#: under remat="full"), the checkpoint directory (removed after)
LM_TRAIN_ARCH, LM_TRAIN_STEPS = "tinyllama-1.1b", 6
#: the smoke configs trained card against CPU (float32, full fp32
#: products): steps, preemption step, batch and length, and the relative
#: tolerance of the losses (float32 sums in another order, 6 AdamW steps)
LM_TRAIN_SMOKE = ("tinyllama-1.1b", "deepseek-v3-671b")
LM_TRAIN_SMOKE_BATCH, LM_TRAIN_SMOKE_SEQ, LM_TRAIN_SMOKE_RTOL = 8, 128, 1e-5


def _lm_train_cmd(arch: str, ckpt_dir: str, *extra: str) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
            "--ckpt-dir", ckpt_dir, *extra]


def _lm_train_finish(cmd, proc) -> tuple[list[str], dict]:
    """A train CLI process's lines and ``report:``, every loss finite."""
    import math
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{out[-2000:]}\n"
                             f"{err[-4000:]}")
    lines = out.splitlines()
    report = json.loads(lines[-1].removeprefix("report: "))
    if not all(math.isfinite(x) for x in report["losses"]):
        raise AssertionError(f"{' '.join(cmd[1:])}: losses "
                             f"{report['losses']}")
    return lines, report


def _lm_train_start(cmd, **env):
    log("phase 14: " + " ".join(cmd[1:]))
    return subprocess.Popen(
        cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
                            **env))


def lm_train_full(train_row: dict) -> dict:
    """Phase 14, part 1: ``python -m repro_torch.launch.train --arch
    tinyllama-1.1b --full --batch 8 --seq-len 4096 --steps 6`` as a user
    runs it: every loss finite, the median step ms of steps 2-6,
    tokens/s, model TFLOP/s and peak memory; flash launched only on its
    tensor-core route, 2 x 22 a step; the flash backward's device ms a
    step as the CLI measures it inside each step (CUDA events around
    each ``FlashAttention.backward``, median of steps 2-6) and its share
    of the median step, beside the estimate from phase 1's LM training
    line (22 isolated calls at that shape)."""
    import shutil
    from repro_torch.configs import base as cfgbase
    cfg = cfgbase.get(LM_TRAIN_ARCH).model_config()
    b, s = LM_TRAIN_SHAPE[0], LM_TRAIN_SHAPE[1]
    root = os.path.join(HERE, "build", "phase14_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    cmd = _lm_train_cmd(LM_TRAIN_ARCH, root, "--full", "--batch", str(b),
                        "--seq-len", str(s), "--steps", str(LM_TRAIN_STEPS))
    t0 = time.perf_counter()
    try:
        lines, rep = _lm_train_finish(cmd, _lm_train_start(cmd))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for ln in lines[:-1]:
        log("phase 14: | " + ln)
    want = 2 * cfg.n_layers * LM_TRAIN_STEPS
    if (len(rep["losses"]) != LM_TRAIN_STEPS
            or rep["flash_routes"] != {"general_tc": want}):
        raise AssertionError(f"phase 14: {len(rep['losses'])} losses, flash "
                             f"launches by route {rep['flash_routes']} "
                             f"(want {want} on general_tc)")
    med, bwd_step = rep["median_step_ms"], rep["median_flash_backward_ms"]
    if len(rep["flash_backward_ms"]) != LM_TRAIN_STEPS or not bwd_step > 0:
        raise AssertionError(f"phase 14: flash backward ms a step "
                             f"{rep['flash_backward_ms']}")
    row = dict(
        arch=LM_TRAIN_ARCH, batch=b, seq_len=s, steps=LM_TRAIN_STEPS,
        step_ms=rep["step_ms"], step_ms_median_2_6=med,
        tokens_per_s=rep["tokens_per_s"],
        model_flops_per_step=rep["model_flops"],
        model_tflops_per_s=rep["model_tflop_s"],
        peak_bytes=rep["peak_bytes"], flash_routes=rep["flash_routes"],
        flash_launches_per_step=want // LM_TRAIN_STEPS,
        flash_backward_ms=rep["flash_backward_ms"],
        flash_backward_ms_per_step=bwd_step,
        flash_backward_share_of_step=bwd_step / med,
        flash_backward_ms_per_step_from_phase1=cfg.n_layers
        * train_row["backward_ms"],
        flash_forward_ms_per_step_from_phase1=2 * cfg.n_layers
        * train_row["ms"],
        losses=rep["losses"], grad_norms=rep["grad_norms"],
        ckpt=[{k: w[k] for k in ("step", "bytes", "seconds")}
              for w in rep["ckpt"]], wall_s=time.perf_counter() - t0)
    log("phase 14: full width: " + json.dumps(row))
    return row


def lm_train_smoke() -> dict:
    """Phase 14, part 2: the smoke configs of LM_TRAIN_SMOKE (float32),
    6 steps through the CLI on the card (clean, and preempted at step 3)
    and on the CPU: the card's losses within LM_TRAIN_SMOKE_RTOL of the
    CPU's, and the preempted run's final checkpoint equal to the clean
    run's bit for bit.  Beside them the driver of
    ``examples/train_lm.py`` (the reference's command) on the card must
    exit 0 after one restart.  All are started together."""
    import shutil
    root = os.path.join(HERE, "build", "phase14_smoke")
    shutil.rmtree(root, ignore_errors=True)
    flags = ("--steps", str(TRAIN_STEPS), "--batch",
             str(LM_TRAIN_SMOKE_BATCH), "--seq-len", str(LM_TRAIN_SMOKE_SEQ))
    runs = {}
    for arch in LM_TRAIN_SMOKE:
        for name, extra in (("card", ("--device", "cuda")),
                            ("preempted", ("--device", "cuda", "--preempt-at",
                                           str(TRAIN_PREEMPT))),
                            ("cpu", ("--device", "cpu"))):
            cmd = _lm_train_cmd(arch, os.path.join(root, arch, name),
                                *flags, *extra)
            # the CPU runs share the host's cores with the card's
            env = {"OMP_NUM_THREADS": "2"} if name == "cpu" else {}
            runs[arch, name] = (cmd, _lm_train_start(cmd, **env))
    driver_cmd = [sys.executable, "-m", "repro_torch.examples.train_lm"]
    driver = _lm_train_start(driver_cmd)
    t0 = time.perf_counter()
    out = {}
    try:
        reps = {key: _lm_train_finish(*run) for key, run in runs.items()}
        for arch in LM_TRAIN_SMOKE:
            card, cpu = reps[arch, "card"][1], reps[arch, "cpu"][1]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(card["losses"], cpu["losses"]))
            if rel > LM_TRAIN_SMOKE_RTOL or "restarts=1" not in \
                    reps[arch, "preempted"][0][0]:
                raise AssertionError(f"phase 14: {arch} smoke losses card "
                                     f"{card['losses']} against CPU "
                                     f"{cpu['losses']}")
            if reps[arch, "preempted"][1]["losses"] != card["losses"]:
                raise AssertionError(f"phase 14: {arch} preempted losses "
                                     "differ from the clean run's")
            n_bytes = _same_checkpoints(os.path.join(root, arch, "card"),
                                        os.path.join(root, arch,
                                                     "preempted"))
            out[arch] = dict(max_rel_loss_diff_card_cpu=rel,
                             restart_bit_equal_bytes=n_bytes,
                             losses_card=card["losses"],
                             flash_routes=card["flash_routes"])
            log(f"phase 14: {arch} smoke: " + json.dumps(out[arch]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stdout, stderr = driver.communicate(timeout=600)
    lines = stdout.splitlines()
    if driver.returncode != 0 or not any(
            ln.startswith("arch=tinyllama-1.1b steps=200 restarts=1")
            for ln in lines):
        raise AssertionError(f"train_lm driver exited {driver.returncode}:"
                             f"\n{stdout[-2000:]}\n{stderr[-4000:]}")
    for ln in lines[:3]:
        log("phase 14: train_lm | " + ln[:300])
    log(f"phase 14: smoke runs and train_lm: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def lm_train_path(dev, train_row: dict) -> dict:
    """Phase 14: LM training on the card.  Returns the flash row's
    ``lm_train`` field: phase 1's LM training line with the launches of
    the full-width run."""
    import torch
    torch.cuda.empty_cache()
    full = lm_train_full(train_row)
    lm_train_smoke()
    return dict({k: train_row[k] for k in (
        "shape", "max_abs_err", "backward_rel_err", "ms", "backward_ms",
        "plain_ms", "plain", "library_ms", "library", "library_forward_ms",
        "bound_ms", "bound_by", "backward_bound_ms",
        "backward_peak_bytes_above_inputs")},
        launches=full["flash_launches_per_step"] * LM_TRAIN_STEPS,
        step_ms=full["step_ms_median_2_6"],
        flash_backward_ms_per_step=full["flash_backward_ms_per_step"])


# ------------------------------------------------------------ phase 15 --

#: phase 15: GraphSAGE's minibatch_lg at full width, GNN_STEPS steps
GNN_SHAPE, GNN_STEPS, GNN_LR = "minibatch_lg", 20, 1e-3
#: card against CPU, one step: float32 products and the fixed-order sums
#: add in another order on the two devices (tests/test_torch_gnn.py's
#: tolerances against the JAX package)
GNN_LOSS_RTOL, GNN_GRAD_RTOL, GNN_GRAD_ATOL = 1e-5, 1e-4, 1e-6
#: full_graph_sm and molecule: steps on the card and the CPU, and the
#: losses' tolerance after them (one step's differences, through Adam)
GNN_SMALL_STEPS, GNN_SMALL_RTOL = 5, 1e-4
#: nodes whose neighbour lists are held against the edge list
GNN_CSR_PROBES = 8


def _gnn_grads(loss_fn, params):
    """(loss, gradients in leaf order) of ``loss_fn(params)``."""
    from repro_torch.launch.train import value_and_grad
    from repro_torch.tree import leaves
    loss, grads = value_and_grad(loss_fn, params)
    return loss, leaves(grads)


def _gnn_to(batch, dev):
    return {"feats": [f.to(dev) for f in batch["feats"]],
            "blocks": [{k: (v.to(dev) if hasattr(v, "to") else v)
                        for k, v in b.items()} for b in batch["blocks"]],
            "labels": batch["labels"].to(dev)}


def _gnn_card_vs_cpu(params, cfg, batch, dev) -> dict:
    """One step's loss and gradients on the card against the CPU fed the
    same blocks, and two runs of it on the card bit-equal."""
    import torch
    from repro_torch.examples.gnn_sage import blocks_loss
    from repro_torch.tree import map_tree
    loss_c, g_c = _gnn_grads(lambda p: blocks_loss(p, cfg, batch), params)
    loss_r, g_r = _gnn_grads(lambda p: blocks_loss(p, cfg, batch), params)
    if not (torch.equal(loss_c, loss_r)
            and all(torch.equal(a, b) for a, b in zip(g_c, g_r))):
        raise AssertionError("phase 15: two runs of one step gave other "
                             "gradient bits")
    cpu = torch.device("cpu")
    p_cpu = map_tree(lambda t: t.to(cpu), params)
    b_cpu = _gnn_to(batch, cpu)
    loss_h, g_h = _gnn_grads(lambda p: blocks_loss(p, cfg, b_cpu), p_cpu)
    loss_err = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    grad_err = 0.0
    for a, b in zip(g_c, g_h):
        a = a.cpu()
        if not torch.allclose(a, b, rtol=GNN_GRAD_RTOL, atol=GNN_GRAD_ATOL):
            raise AssertionError(
                f"phase 15: card gradients differ from the CPU's by "
                f"{float((a - b).abs().max())} (rtol {GNN_GRAD_RTOL}, atol "
                f"{GNN_GRAD_ATOL})")
        grad_err = max(grad_err, float((a - b).abs().max()))
    if loss_err > GNN_LOSS_RTOL:
        raise AssertionError(f"phase 15: card loss {float(loss_c)} against "
                             f"the CPU's {float(loss_h)}")
    return dict(loss_rel_err=loss_err, grad_max_abs_err=grad_err,
                repeat_bit_equal=True)


def gnn_minibatch(dev) -> dict:
    """``minibatch_lg`` at full width on the card (phase 15)."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import graph_data
    from repro_torch.examples.gnn_sage import blocks_loss
    from repro_torch.launch.train import make_step
    from repro_torch.models import gnn, sampler
    from repro_torch.optim import adamw

    mod = cfgbase.get("graphsage-reddit")
    sh, cfg = mod.SHAPES[GNN_SHAPE], mod.model_config(GNN_SHAPE)
    n, bn, fanout = sh["n_nodes"], sh["batch_nodes"], sh["fanout"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = graph_data.make_graph(graph_data.GraphConfig(
        n_nodes=n, n_edges=sh["n_edges"], d_feat=sh["d_feat"],
        n_classes=sh["n_classes"], seed=0))
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indptr, indices = sampler.csr_from_edges(g["edges"], n, device=dev)
    feats = torch.from_numpy(g["feats"]).to(dev)
    labels = torch.from_numpy(g["labels"]).to(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    csr_peak = torch.cuda.max_memory_allocated(dev)
    # the CSR against the edge list: every node's offset, and a few
    # nodes' neighbours in edge order (a stable sort's one answer)
    src, dst = g.pop("edges")
    want_ptr = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                          minlength=n))])
    if not np.array_equal(indptr.cpu().numpy(), want_ptr):
        raise AssertionError("phase 15: the card's indptr differs from the "
                             "host's bincount")
    probe = np.random.default_rng(1).choice(n, GNN_CSR_PROBES, replace=False)
    for v in probe:
        got = indices[int(want_ptr[v]):int(want_ptr[v + 1])].cpu().numpy()
        if not np.array_equal(got, src[dst == v]):
            raise AssertionError(f"phase 15: node {v}'s neighbours differ")
    del src, dst, g
    log(f"phase 15: {GNN_SHAPE}: {n} nodes, {indices.numel()} edges, d "
        f"{sh['d_feat']}; graph {host_s:.3f} s on the host, CSR and "
        f"features {card_s:.3f} s to and on the card")

    params = gnn.init_sage(cfg, seed=0, device=dev)
    opt = adamw.init_opt_state(params)
    step_fn = make_step(blocks_loss, cfg,
                        adamw.AdamWConfig(lr=GNN_LR, weight_decay=0.0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)

    def sample():
        seeds = torch.from_numpy(rng.choice(n, bn, replace=False)
                                 .astype(np.int32)).to(dev)
        fr, bl = sampler.sample_blocks(gen, indptr, indices, seeds, fanout)
        return fr, bl, seeds

    def gather(fr, bl, seeds):
        return {"feats": [feats[f.long()] for f in fr], "blocks": bl,
                "labels": labels[seeds.long()]}

    losses, sample_ms, gather_ms, step_ms = [], [], [], []
    for _ in range(GNN_STEPS):
        drawn, ms = _fenced(sample)
        sample_ms.append(ms)
        batch, ms = _fenced(lambda: gather(*drawn))
        gather_ms.append(ms)
        (params, opt, m), ms = _fenced(
            lambda: step_fn(params, opt, batch))
        step_ms.append(ms)
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 15: losses not finite: {losses}")
    peak = torch.cuda.max_memory_allocated(dev)
    s_ms, g_ms, t_ms = (statistics.median(x[1:]) for x in
                        (sample_ms, gather_ms, step_ms))
    flops = mod.model_flops(GNN_SHAPE)
    g_bytes = sum(f.numel() * f.element_size() for f in batch["feats"])
    row = dict(
        shape=GNN_SHAPE, batch=bn, fanout=list(fanout),
        frontiers=[f.numel() for f in drawn[0]], steps=GNN_STEPS,
        graph_host_s=host_s, graph_card_s=card_s, sampler_ms=s_ms,
        gather_ms=g_ms, step_ms=t_ms, seeds_per_s=bn / ((s_ms + g_ms + t_ms)
                                                        / 1e3),
        model_flops=flops, model_tflops_per_s=flops / t_ms / 1e9,
        gathered_bytes=g_bytes, gathered_gb_per_s=g_bytes / g_ms / 1e6,
        peak_bytes=peak, csr_build_peak_bytes=csr_peak,
        loss_first=losses[0], loss_last=losses[-1])
    row.update(_gnn_card_vs_cpu(params, cfg, batch, dev))

    def iteration():
        nonlocal params, opt
        b = gather(*sample())
        params, opt, _ = step_fn(params, opt, b)

    row["profile"] = _step_profile(iteration, s_ms + g_ms + t_ms)
    log("phase 15: minibatch " + json.dumps(row))
    del params, opt, batch, drawn, feats, labels, indptr, indices
    torch.cuda.empty_cache()
    return row


def _gnn_small(dev, shape: str) -> dict:
    """``full_graph_sm`` or ``molecule`` at its real size:
    GNN_SMALL_STEPS steps on the card and on the CPU from the same
    parameters."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import graph_data
    from repro_torch.launch.train import make_step
    from repro_torch.models import gnn
    from repro_torch.optim import adamw

    mod = cfgbase.get("graphsage-reddit")
    sh, cfg = mod.SHAPES[shape], mod.model_config(shape)
    if sh["kind"] == "train_full":
        g = graph_data.make_graph(graph_data.GraphConfig(
            n_nodes=sh["n_nodes"], n_edges=sh["n_edges"],
            d_feat=sh["d_feat"], n_classes=sh["n_classes"], seed=0))
        data = {k: torch.from_numpy(g[k]) for k in
                ("feats", "edges", "labels", "train_mask")}

        def loss_fn(p, c, d):
            return gnn.sage_loss_full(p, c, d["feats"], d["edges"],
                                      d["labels"], d["train_mask"])
    else:
        b = sh["batch"]
        mb = graph_data.molecule_batch(b, sh["n_nodes"], sh["n_edges"],
                                       sh["d_feat"], seed=0)
        data = {k: torch.from_numpy(v) for k, v in mb.items()}

        def loss_fn(p, c, d):
            return gnn.sage_loss_molecule(p, c, d["feats"], d["edges"],
                                          d["graph_id"], d["y"], b)
    def run(d):
        params = gnn.init_sage(cfg, seed=0, device=d)
        opt = adamw.init_opt_state(params)
        step_fn = make_step(loss_fn, cfg,
                            adamw.AdamWConfig(lr=GNN_LR, weight_decay=0.0))
        batch = {k: v.to(d) for k, v in data.items()}
        losses, ms = [], []
        for _ in range(GNN_SMALL_STEPS):
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))     # the step's one read-out
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    (lc, ms_c), (lh, _) = run(dev), run(torch.device("cpu"))
    err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    if not all(np.isfinite(lc)) or err > GNN_SMALL_RTOL:
        raise AssertionError(f"phase 15: {shape} card losses {lc} against "
                             f"the CPU's {lh}")
    return dict(shape=shape, steps=GNN_SMALL_STEPS, losses=lc,
                loss_rel_err_vs_cpu=err, step_ms_2_on=ms_c[1:])


def gnn_driver() -> None:
    """The reference example's driver on the card, as a subprocess."""
    cmd = [sys.executable, "-m", "repro_torch.examples.gnn_sage"]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=600, env=env)
    lines = proc.stdout.splitlines()
    acc = [ln for ln in lines if re.fullmatch(
        r"step +\d+  sampled-loss \d+\.\d{3}  full-graph acc \d\.\d{3}", ln)]
    if proc.returncode != 0 or len(acc) != 6 or not lines[-1].startswith(
            "done"):
        raise AssertionError(f"phase 15: gnn_sage exit {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    for ln in lines:
        log("phase 15: gnn_sage | " + ln)
    log(f"phase 15: python -m repro_torch.examples.gnn_sage exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")


def gnn_path(dev) -> dict:
    """Phase 15: GraphSAGE on the card."""
    row = gnn_minibatch(dev)
    for shape in ("full_graph_sm", "molecule"):
        log("phase 15: card against CPU " + json.dumps(_gnn_small(dev, shape)))
    gnn_driver()
    return row


# ------------------------------------------------------------ phase 16 --

#: syncs in phase 16's scopes that ROADMAP section 4 lists as open
#: faults: (file in the package, scope)
SYNC_FAULTS: tuple[tuple[str, str], ...] = ()


def _no_syncs_scope(name: str, fn):
    """``fn()`` under ``no_syncs``; logs the scope's syncs by frame."""
    import torch
    from repro_torch.analysis.sanitizers import no_syncs
    torch.cuda.synchronize()
    with no_syncs(allowed=SYNC_FAULTS) as rec:
        out = fn()
    torch.cuda.synchronize()
    log(f"phase 16: {name}: " + json.dumps(dict(
        syncs=len(rec.syncs), by_frame=rec.by_frame())))
    return out


def sync_path(servers, batches, served, decode_step, replayed_step,
              funnel, fbatch, fout) -> None:
    """Phase 16: the sync sanitizer around the engine's stages (one ρ and
    one k batch), one continuous chunk step, one full-width decode step
    and one funnel batch (``Funnel.execute`` at phase 3's classes), each
    eager and replayed (``DecodePrograms``, the funnel's programs)."""
    import numpy as np
    import torch
    from repro_torch.obs import Observability
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.serving.service import (ContinuousBackend,
                                             RetrievalService, WarmupPolicy)

    qt = batches[1]
    for knob in ("rho", "k"):
        server = servers[knob][0]
        widths = server.params_of(server.predict_classes(qt))
        _, depths = server.predict_depths(qt)
        ranked, _ = _no_syncs_scope(
            f"engine {knob} batch", lambda: server.engine.serve(
                qt, widths, depth_vec=depths))
        if not np.array_equal(ranked, served[knob][1]["ranked"]):
            raise AssertionError(f"phase 16: {knob} ranked differs from "
                                 "phase 2's")

    server = servers["rho"][0]
    backend = ContinuousBackend(server, query_len=qt.shape[1], slots=SLOTS,
                                grain=GRAIN, chunk_p=CHUNK_P)
    svc = RetrievalService(
        backend, AdmissionConfig(max_batch=BATCH, pad_multiple=GRAIN),
        WarmupPolicy(census_path=None), obs=Observability.create())
    svc.warmup_now([BATCH])
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    sched = backend.scheduler
    while not sched.table.active():
        sched.tick()
    _no_syncs_scope(f"continuous chunk step ({len(sched.table.active())} "
                    "active slots)", lambda: sched._chunk_step(
                        time.perf_counter()))
    while not all(f.done() for f in futs):
        sched.tick()
    svc.stop()
    _no_syncs_scope("tinyllama-1.1b decode_step", decode_step)
    _no_syncs_scope("tinyllama-1.1b decode_step replayed", replayed_step)
    from repro_torch.serving import funnel as F
    ks = funnel.params_of(fout["classes"])
    name, args, kw = funnel.stage_call(
        *fbatch, ks, np.full_like(ks, max(funnel.cfg.cutoffs)))
    # the stage function called eagerly, its lists copied out after the
    # scope; then the program, through ``execute`` (built outside)
    ranked = _no_syncs_scope("funnel batch eager (the stage function)",
                             lambda: F._stage_funnel(*args, **kw))
    funnel.execute(*fbatch, fout["classes"])
    out = _no_syncs_scope("funnel batch replayed",
                          lambda: funnel.execute(*fbatch, fout["classes"]))
    for mode, got in (("eager", ranked.cpu().numpy()),
                      ("replayed", out["ranked"][:, :ranked.shape[1]])):
        if not np.array_equal(got, fout["ranked"][:, :ranked.shape[1]]):
            raise AssertionError(f"phase 16: funnel {mode} ranked differs "
                                 "from phase 3's")
    _release_programs(funnel)


# ------------------------------------------------------------ phase 18 --

#: phase 18: mixed batches served under ``hot_path``, per knob
PROGRAM_BATCHES = 200
#: phase 18: the serving stages of one padded shape, the depth variant's
#: rerank among them
SERVE_STAGES = ("gather", "stage1", "stage2", "rerank", "rerank_dyn")


def _grid_keys(engine) -> set:
    """(stage, padded batch) of every serving program in the cache: the
    gather's batch is its query rows' (its fifth argument), the other
    stages' their first argument's."""
    out = set()
    for key in engine._programs.keys():
        name = key[0].split(":")[0]
        if name in SERVE_STAGES:
            shape = key[5][0] if name == "gather" else key[1][0]
            out.add((name, shape[0]))
    return out


def _stage_calls(e, qt, pv, dv=None, timings=None) -> list:
    """``engine.serve``'s four stages on the padded device tensors of one
    batch, run eagerly: [(cache name, stage function, tensor arguments,
    static keywords, output)], in order.  With ``timings``, each stage
    is fenced and timed as the engine's spans time a replay
    (``timings[<stage>_ms]``)."""
    import torch
    from repro_torch.device import fence
    from repro_torch.serving import engine as eng
    cfg = e.cfg
    q, p = e._to_device(qt, fill=-1), e._to_device(pv, fill=1)
    qids = torch.arange(q.shape[0], dtype=torch.int32, device=e.device)
    kern = dict(n_docs=e.n_docs, block_p=e.block_p, block_d=e.block_d)
    calls = []

    def run(label, name, fn, args, kw):
        if timings is not None:
            fence(e.device)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if timings is not None:
            fence(e.device)
            timings[label] = (time.perf_counter() - t0) * 1e3
        calls.append((name, fn, args, kw, out))
        return out

    ds, im, lo, hi, sd, s3 = run(
        "gather_ms", "gather", eng._stage_gather,
        (e.offsets, e.pdoc, e.pimp, e.pscore, q),
        dict(cap=cfg.stream_cap, block_p=e.block_p, n_docs=e.n_docs))
    if cfg.knob == "rho":
        pool = run("stage1_ms", "stage1", eng._stage1_rho,
                   (ds, im, lo, hi, p), dict(depth=cfg.rerank_depth, **kern))
    else:
        pool = run("stage1_ms", f"stage1:{e.max_k}", eng._stage1_k,
                   (ds, im, lo, hi, p), dict(max_k=e.max_k, **kern))
    s2 = run("stage2_ms", "stage2", eng._stage2, (sd, s3, e.doc_len, qids),
             dict(n_docs=e.n_docs, n_terms=q.shape[1]))
    if dv is None:
        run("rerank_ms", "rerank", eng._stage_rerank, (s2, pool),
            dict(depth=cfg.rerank_depth))
    else:
        run("rerank_ms", "rerank_dyn", eng._stage_rerank_dyn,
            (s2, pool, e._to_device(dv, fill=1)),
            dict(depth=cfg.rerank_depth))
    return calls


def _eager_ranked(e, qt, pv, dv=None, timings=None):
    """The ranked lists of eager calls of the stage functions, as
    ``engine.serve`` returns them (``timings``: as ``_stage_calls``)."""
    from repro_torch.serving import engine as eng
    r = _stage_calls(e, qt, pv, dv, timings)[-1][-1]
    return eng._pad_ranked(r[:qt.shape[0]].cpu().numpy(),
                           e.cfg.rerank_depth)


def programs_path(servers, batches) -> None:
    """Phase 18: the engine's program cache on the card over phase 2's
    servers: the warmed pad grid, 200 mixed batches under ``hot_path``
    held bit for bit against eager stage calls, every padded shape
    likewise, replayed against eager times, and the continuous path on
    the graphs against an eager batch-once serve."""
    import numpy as np
    import torch
    from repro_torch.analysis import sanitizers

    terms = np.concatenate(batches)
    rng = np.random.default_rng(18)
    for knob in ("rho", "k"):
        server = servers[knob][0]
        e = server.engine
        qlen = terms.shape[1]
        grid = list(range(e.batch_multiple, BATCH + 1, e.batch_multiple))
        # ---- the pad grid, the depth variant included ----
        torch.cuda.synchronize()
        n_before, r0 = e.n_compiles, torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        built = e.warmup(grid, qlen, with_depth=True)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        added = torch.cuda.memory_reserved() - r0
        want = {(st, b) for st in SERVE_STAGES for b in grid}
        if not want <= _grid_keys(e):
            raise AssertionError(f"phase 18: {knob}: grid programs missing: "
                                 f"{sorted(want - _grid_keys(e))}")
        if e.warmup(grid, qlen, with_depth=True) != 0:
            raise AssertionError(f"phase 18: {knob}: a warm grid built")
        stats = e.program_stats()
        if stats["graphs"] != stats["programs"]:
            raise AssertionError(f"phase 18: {knob}: a program is not a "
                                 f"CUDA graph: {stats}")
        # ---- 200 mixed batches under hot_path ----
        plan = []
        for i in range(PROGRAM_BATCHES):
            n = int(rng.integers(1, BATCH + 1))
            lo = int(rng.integers(0, terms.shape[0] - n + 1))
            qt = terms[lo:lo + n]
            pv = server.params_of(server.predict_classes(qt))
            dv = (rng.integers(1, RERANK_DEPTH + 1, n) if i % 2 else None)
            plan.append((qt, pv, dv))
        replays0 = e.program_stats()["replays"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sanitizers.hot_path(e, allowed_syncs=SYNC_FAULTS) as rec:
            served = [e.serve(qt, pv, depth_vec=dv)[0] for qt, pv, dv in plan]
        mixed_s = time.perf_counter() - t0
        if rec.new_compiles != 0:
            raise AssertionError(f"phase 18: {knob}: {rec.new_compiles} "
                                 "programs built on a warm grid")
        for i, ((qt, pv, dv), got) in enumerate(zip(plan, served)):
            if not np.array_equal(got, _eager_ranked(e, qt, pv, dv)):
                raise AssertionError(f"phase 18: {knob}: mixed batch {i} "
                                     "differs from the eager stages")
        # ---- every padded shape, replayed against eager ----
        for b in grid:
            qt = terms[:b]
            pv = server.params_of(server.predict_classes(qt))
            dv = rng.integers(1, RERANK_DEPTH + 1, b)
            for d in (None, dv):
                if not np.array_equal(e.serve(qt, pv, depth_vec=d)[0],
                                      _eager_ranked(e, qt, pv, d)):
                    raise AssertionError(
                        f"phase 18: {knob}: batch {b} depth "
                        f"{d is not None}: replayed differs from eager")
        # ---- replayed beside eager at BATCH ----
        qt = batches[1]
        pv = server.params_of(server.predict_classes(qt))
        reps = 15
        rep_stage, rep_wall, eag_stage, eag_wall = [], [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, tm = e.serve(qt, pv)
            rep_wall.append((time.perf_counter() - t0) * 1e3)
            rep_stage.append(tm)
            tm = {}
            t0 = time.perf_counter()
            _eager_ranked(e, qt, pv, timings=tm)
            eag_wall.append((time.perf_counter() - t0) * 1e3)
            eag_stage.append(tm)
        calls = _stage_calls(e, qt, pv)
        host = {}
        for name, fn, a, kw, _ in calls:
            prog = e._compiled(name, fn, a, kw)
            host[name.split(":")[0]] = dict(
                replayed=host_ms(lambda p=prog, a=a: p(*a)),
                eager=host_ms(lambda fn=fn, a=a, kw=kw: fn(*a, **kw)))
        med = statistics.median
        stage_ms = {k: dict(replayed=med(t[k] for t in rep_stage),
                            eager=med(t[k] for t in eag_stage))
                    for k in ("gather_ms", "stage1_ms", "stage2_ms",
                              "rerank_ms")}
        # ---- the continuous path on the graphs ----
        q512 = terms
        ref = _eager_ranked(e, q512, server.params_of(
            server.predict_classes(q512)))
        res, st, wall, got, _ = _continuous_run(server, q512, "inline")
        if not np.array_equal(np.stack([r["ranked"] for r in res]), ref):
            raise AssertionError(f"phase 18: {knob}: continuous on graphs "
                                 "differs from an eager batch-once serve")
        want_tk = st["n_finalize_calls"] if knob == "rho" else 0
        if got != dict(impact_scan=st["n_chunk_calls"], topk=want_tk):
            raise AssertionError(f"phase 18: {knob}: continuous launches "
                                 f"{got}, chunks {st['n_chunk_calls']}")
        stats = e.program_stats()
        line = dict(
            grid=[grid[0], grid[-1], e.batch_multiple],
            n_compiles=e.n_compiles, built_by_warmup=built,
            built_before=n_before, grid_programs=len(want),
            expected_grid_programs=f"{len(SERVE_STAGES)} stages x "
                                   f"{len(grid)} shapes",
            warmup_s=warm_s, memory_reserved_added_bytes=added,
            static_bytes=stats["static_bytes"], graphs=stats["graphs"],
            replays=stats["replays"],
            mixed=dict(batches=PROGRAM_BATCHES, new_compiles=0,
                       replays=stats["replays"] - replays0,
                       syncs=(None if rec.syncs is None
                              else rec.syncs.by_frame()),
                       queries_per_s=sum(len(p[0]) for p in plan) / mixed_s),
            stage_ms=stage_ms, stage_host_ms=host,
            serve_wall_ms=dict(replayed=med(rep_wall), eager=med(eag_wall)),
            continuous=dict(requests=len(q512), launches=got,
                            chunks=st["n_chunk_calls"], qps=len(res) / wall))
        log(f"phase 18: programs {knob}: " + json.dumps(line))


# ------------------------------------------------------------ phase 19 --

#: phase 19: mixed predicts under ``hot_path``, per knob
PREDICT_BATCHES = 200


def _eager_predict(server, rows, knob, stage):
    """A predict stage function called eagerly on the server's padded
    device operands (those its program copies in): the first rows'
    values on the host."""
    args, kw = server._operands(rows, knob)
    return stage(*args, **kw)[:rows.shape[0]].cpu().numpy()


def predict_programs_path(sys_, servers, batches, seen) -> None:
    """Phase 19: the server's predict programs on the card.  Per knob a
    fresh server on phase 2's cascade and config: the predict and margin
    grid warmed (each build timed), a second warmup, 200 mixed predicts
    under ``hot_path`` held bit for bit against eager stage calls, every
    padded shape likewise, and the predict at batch 128 replayed beside
    eager; then the predict numbers of the serving phases."""
    import numpy as np
    import torch
    from repro_torch.analysis import sanitizers
    from repro_torch.serving import pipeline
    from repro_torch.tree import leaves

    terms = np.concatenate(batches)
    qlen = terms.shape[1]
    rng = np.random.default_rng(19)
    stages = {"predict": pipeline._stage_predict,
              "margin": pipeline._stage_margin}
    for knob in ("rho", "k"):
        _, casc, scfg = servers[knob]
        server = pipeline.RetrievalServer(sys_.index, casc, scfg,
                                          device="cuda")
        pp = server.predict_programs
        m = server.engine.batch_multiple
        grid = list(range(m, BATCH + 1, m))
        calls = {"predict": server.predict_classes,
                 "margin": server.predict_margin}
        # ---- the grid: every shape's predict and margin, each build
        # timed (the copy in, the eager run, the capture, one replay) ----
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_reserved()
        build_s = {f: [] for f in calls}
        t0 = time.perf_counter()
        for b in grid:
            dummy = np.full((b, qlen), -1, np.int32)
            for f, call in calls.items():
                t1 = time.perf_counter()
                call(dummy)
                build_s[f].append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        added = torch.cuda.memory_reserved() - r0
        built = pp.n_compiles
        if built != 2 * len(grid):
            raise AssertionError(f"phase 19: {knob}: the grid built "
                                 f"{built} programs, not {2 * len(grid)}")
        t0 = time.perf_counter()
        for b in grid:
            dummy = np.full((b, qlen), -1, np.int32)
            for call in calls.values():
                call(dummy)
        torch.cuda.synchronize()
        rewarm_s = time.perf_counter() - t0
        if pp.n_compiles != built:
            raise AssertionError(f"phase 19: {knob}: a warm grid built")
        stats = pp.stats()
        if not stats["graphs"] == stats["programs"] == built:
            raise AssertionError(f"phase 19: {knob}: a program is not a "
                                 f"CUDA graph: {stats}")
        if sorted(pp.pool_sizes()) != grid:
            raise AssertionError(f"phase 19: {knob}: pools "
                                 f"{pp.pool_sizes()}")
        # ---- 200 mixed predicts under hot_path ----
        plan = []
        for _ in range(PREDICT_BATCHES):
            n = int(rng.integers(1, BATCH + 1))
            lo = int(rng.integers(0, terms.shape[0] - n + 1))
            plan.append(terms[lo:lo + n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sanitizers.hot_path(pp, allowed_syncs=SYNC_FAULTS) as rec:
            got = [server.predict_classes(rows) for rows in plan]
        mixed_s = time.perf_counter() - t0
        if rec.new_compiles != 0:
            raise AssertionError(f"phase 19: {knob}: {rec.new_compiles} "
                                 "programs built on a warm grid")
        for i, (rows, classes) in enumerate(zip(plan, got)):
            want = _eager_predict(server, rows, knob, pipeline._stage_predict)
            if not np.array_equal(classes, want):
                raise AssertionError(f"phase 19: {knob}: mixed predict {i} "
                                     "differs from the eager stage")
        # ---- every padded shape, classes and margins against eager ----
        for b in grid:
            rows = terms[rng.permutation(terms.shape[0])[:b]]
            for f, call in calls.items():
                a = call(rows)
                e = _eager_predict(server, rows, knob, stages[f])
                if not np.array_equal(a, e):
                    gap = float(np.abs(a.astype(np.float64) - e).max())
                    raise AssertionError(f"phase 19: {knob}: {f} at {b} "
                                         f"differs from eager by {gap}")
        # ---- at BATCH: replayed beside eager ----
        rows = batches[1]
        args, kw = server._operands(rows, knob)
        prog = pp.compiled(f"predict:{knob}", pipeline._stage_predict, args,
                           kw)
        replay, eager = (lambda: prog(*args),
                         lambda: pipeline._stage_predict(*args, **kw))
        wall = {"replayed": [], "eager": []}
        for _ in range(15):
            for name, fn in (("replayed", lambda: server.predict_classes(rows)),
                             ("eager", lambda: _eager_predict(
                                 server, rows, knob,
                                 pipeline._stage_predict))):
                t0 = time.perf_counter()
                fn()
                wall[name].append((time.perf_counter() - t0) * 1e3)
        med = statistics.median
        line = dict(
            grid=[grid[0], grid[-1], m], programs=built,
            expected=f"2 functions x {len(grid)} shapes",
            graphs=stats["graphs"],
            build_s=dict(predict=[min(build_s["predict"]),
                                  med(build_s["predict"]),
                                  max(build_s["predict"])],
                         margin=[min(build_s["margin"]),
                                 med(build_s["margin"]),
                                 max(build_s["margin"])]),
            build_s_note=f"min, median, max over the {len(grid)} shapes",
            warmup_s=warm_s, second_warmup_s=rewarm_s, rebuilt=0,
            memory_reserved_added_bytes=added,
            static_bytes=stats["static_bytes"],
            table_bytes=sum(t.numel() * t.element_size()
                            for t in leaves(server._live[knob][0])),
            mixed=dict(predicts=PREDICT_BATCHES, new_compiles=0,
                       syncs=(None if rec.syncs is None
                              else rec.syncs.by_frame()),
                       queries_per_s=sum(len(r) for r in plan) / mixed_s),
            bit_equal_to_eager=True,
            at_batch=BATCH,
            host_ms=dict(replayed=host_ms(replay), eager=host_ms(eager)),
            ms=dict(replayed=time_ms(replay), eager=time_ms(eager)),
            device_ms=dict(replayed=time_ms(replay, hold=True),
                           eager=time_ms(eager, hold=True)),
            wall_ms=dict(replayed=med(wall["replayed"]),
                         eager=med(wall["eager"])),
            phase2_server_programs=servers[knob][0].predict_programs.stats())
        log(f"phase 19: predict programs {knob}: " + json.dumps(line))
        del server, prog, args
    log("phase 19: predict on the serving paths: " + json.dumps(seen))


def _busy_us(events) -> float:
    """Length of the union of the events' [start, end] intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile(targets, trace_dir: str) -> None:
    """Device busy and idle share of each path's steady batches.
    ``targets``: {name: (serve function, list of argument tuples)}."""
    from torch.autograd import DeviceType

    os.makedirs(trace_dir, exist_ok=True)
    for name, (serve, batches) in targets.items():
        steady = batches[1:]
        wall = []
        for args in steady:
            t0 = time.perf_counter()
            serve(*args)
            wall.append((time.perf_counter() - t0) * 1e3)
        def body():
            for args in steady:
                serve(*args)

        prof, events, _ = _profiled(body)
        dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_ms = _busy_us(dev_events) / 1e3 / len(steady)
        by_name = {}
        for e in dev_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        wall_ms = statistics.median(wall)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_serving_{name}.json"))
        log("profile: " + json.dumps({
            "path": name, "batches": len(steady),
            "wall_ms_per_batch": wall_ms,
            "device_busy_ms_per_batch": busy_ms if dev_events else None,
            "idle_share": 1 - busy_ms / wall_ms if dev_events else None,
            "cuda_activities_per_batch": len(dev_events) / len(steady),
            "top_kernels_ms_per_batch": [
                [k[:80], us / 1e3 / len(steady)] for k, us in top]}))


# ------------------------------------------------------------ phase 17 --

#: phase 17 (a): the dry run of every (arch x shape) cell on both
#: production meshes, in worker processes on the host's CPU beside the
#: card's phases (it needs no card)
DRYRUN_JOBS = 4
DRYRUN_DIR = os.path.join(HERE, "build", "phase17_dryrun")
DRYRUN_CELLS, DRYRUN_SKIPS = 72, 8
#: (a): the MoE cells traced again under ``REPRO_MOE_SHARDMAP=1``
#: (single pod), and whether each one's dispatch differs from gspmd's
#: (the reference's condition: the experts divide over every position)
DRYRUN_SHARD_MAP = {"mixtral-8x22b": False, "deepseek-v3-671b": True}
#: (a): the records whose collective kinds and temp bytes are printed
DRYRUN_HINTED = ("tinyllama-1.1b", "mixtral-8x22b", "deepseek-v3-671b")
#: (b): the estimate must be within this share of the measured peak
MEM_RTOL = 0.10
#: (b): tinyllama-1.1b's training step (phase 14's batch), its decode
#: step on decode_32k's cache, BST's training step (phase 12's batch)
MEM_LM_TRAIN = (8, 4096)
MEM_LM_DECODE = (64, 32768)
MEM_BST_BATCH = 65536
#: (c): mixtral's smoke MoE over a 2 x 2 mesh laid on the card; the
#: capacity factor is raised so that no token drops on either side (the
#: shard_map path fills each position's own capacity), as the
#: reference's test does
MOE_TOKENS, MOE_CAPACITY, MOE_TOL = 64, 8.0, 1e-5
#: (f): ogb_products runs a step only if its estimate is under this
#: share of the card's memory
OGB_SHARE = 0.9


def dryrun_start():
    """Start phase 17 (a): ``python -m repro_torch.launch.dryrun
    --all-cells --mesh both`` with no card visible."""
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all-cells",
           "--mesh", "both", "--jobs", str(DRYRUN_JOBS), "--out", DRYRUN_DIR]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    log("phase 17: " + " ".join(cmd[1:]))
    os.makedirs(DRYRUN_DIR)
    out = open(os.path.join(DRYRUN_DIR, "log.txt"), "w")
    # a session of its own: its workers are stopped with it, on any exit
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out,
                            stderr=subprocess.STDOUT, start_new_session=True)
    atexit.register(_stop_group, proc)
    # the switched MoE cells, one after the other in one process
    sm_dir = os.path.join(DRYRUN_DIR, "shard_map")
    sm_cmd = [sys.executable, "-c", (
        "import sys; from repro_torch.launch import dryrun\n"
        "for a in sys.argv[2:]:\n"
        "    dryrun.main(['--arch', a, '--shape', 'train_4k', '--mesh',"
        " 'single', '--out', sys.argv[1]])"), sm_dir, *DRYRUN_SHARD_MAP]
    sm_out = open(os.path.join(DRYRUN_DIR, "shard_map_log.txt"), "w")
    sm_proc = subprocess.Popen(sm_cmd, cwd=HERE, stdout=sm_out,
                               stderr=subprocess.STDOUT,
                               env=dict(env, REPRO_MOE_SHARDMAP="1"),
                               start_new_session=True)
    atexit.register(_stop_group, sm_proc)
    return proc, time.perf_counter(), out, sm_proc, sm_out


def _stop_group(proc) -> None:
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def dryrun_finish(started) -> list[dict]:
    """Phase 17 (a)'s records: 80, none ``error``, no kernel launched in
    any trace (each record holds the launch counters' moves over it);
    one line a cell."""
    proc, t0, out, sm_proc, sm_out = started
    try:
        proc.wait(timeout=900)
        sm_proc.wait(timeout=600)
    finally:
        for p, f in ((proc, out), (sm_proc, sm_out)):
            _stop_group(p)
            f.close()
    for p, f in ((proc, out), (sm_proc, sm_out)):
        if p.returncode != 0:
            with open(f.name) as fh:
                raise AssertionError(f"phase 17: dry run exit "
                                     f"{p.returncode}: {fh.read()[-3000:]}")
    recs = [json.load(open(os.path.join(DRYRUN_DIR, f)))
            for f in sorted(os.listdir(DRYRUN_DIR)) if f.endswith(".json")]
    status = [r["status"] for r in recs]
    bad = [r for r in recs if r["status"] == "error"]
    if bad:
        raise AssertionError("phase 17: dry-run errors: " + "; ".join(
            f"{r['arch']} {r['shape']} {r['mesh']}: {r['error'][:200]}"
            for r in bad))
    if (len(recs), status.count("ok"), status.count("skipped")) != (
            2 * 40, DRYRUN_CELLS, DRYRUN_SKIPS):
        raise AssertionError(f"phase 17: {len(recs)} records, "
                             f"{status.count('ok')} ok")
    for r in recs:
        if r["status"] != "ok":
            continue
        if any(r["kernel_launches"].values()):
            raise AssertionError(f"phase 17: {r['arch']} {r['shape']} "
                                 f"launched {r['kernel_launches']}")
        m = r["memory"]
        log("phase 17: dryrun " + json.dumps(dict(
            cell=f"{r['arch']} {r['shape']} {r['mesh']}",
            peak_gib=m["peak_estimate_bytes"] / 2 ** 30,
            fits_80gib=m["fits_hbm"],
            dominant=r["roofline"].get("dominant", "multi-pod: none"),
            collective_gb=r["collective_bytes_per_device"] / 1e9,
            replicated_ops=sum(r["replicated_ops"].values()),
            trace_s=r["mem_probe_s"])))
    log(f"phase 17: dry run {len(recs)} records, {status.count('ok')} ok, "
        f"{status.count('skipped')} skipped, in "
        f"{time.perf_counter() - t0:.1f} s (beside the card's phases)")
    sharded_topk_record(next(r for r in recs if (
        r["arch"], r["shape"], r["mesh"]) == ("mind", "retrieval_cand",
                                              "single")))
    shard_map_records(recs)
    return recs


def shard_map_records(recs) -> None:
    """Phase 17 (a): the MoE cells' ``REPRO_MOE_SHARDMAP=1`` records
    against their default ones, and one line of collective kinds and
    temp bytes a record for ``DRYRUN_HINTED``'s ``train_4k`` (single
    pod) under each dispatch."""
    def cell(rec, dispatch):
        return dict(cell=f"{rec['arch']} train_4k single", dispatch=dispatch,
                    status=rec["status"],
                    collectives=rec.get("collectives"),
                    temp_bytes=rec.get("memory", {}).get("temp_bytes"),
                    peak_gib=rec.get("memory", {}).get(
                        "peak_estimate_bytes", 0) / 2 ** 30,
                    replicated_ops=rec.get("replicated_ops"),
                    trace_s=rec.get("mem_probe_s"))
    default = {r["arch"]: r for r in recs if r["shape"] == "train_4k"
               and r["mesh"] == "single"}
    for arch in DRYRUN_HINTED:
        log("phase 17: dryrun hints " + json.dumps(cell(
            default[arch], "gspmd" if arch in DRYRUN_SHARD_MAP else "-")))
    bad = []
    for arch, differs in DRYRUN_SHARD_MAP.items():
        rec = json.load(open(os.path.join(
            DRYRUN_DIR, "shard_map", f"{arch}__train_4k__single.json")))
        log("phase 17: dryrun hints " + json.dumps(cell(rec, "shard_map")))
        got, want = rec.get("collectives"), default[arch]["collectives"]
        if rec["status"] != "ok" or (got != want) != differs:
            bad.append(arch)
        if differs and got.get("all-to-all", 0) <= want.get("all-to-all", 0):
            bad.append(arch + " all-to-all")
        if rec.get("kernel_launches") and any(
                rec["kernel_launches"].values()):
            bad.append(arch + " launched")
    if bad:
        raise AssertionError(f"phase 17: the shard_map records: {bad}")


def sharded_topk_record(base) -> None:
    """Phase 17 (a): MIND's ``retrieval_cand`` on the single-pod mesh
    traced again with ``REPRO_SHARDED_TOPK=1`` (into a directory of its
    own): status ``ok``, and its all-gather bytes a device those of the
    default record less the (B, N) float32 scores plus each ``model``
    shard's (B, k) values and int32 ids."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.configs import recsys_common as RC
    from repro_torch.launch.mesh import make_production_mesh
    out = os.path.join(DRYRUN_DIR, "sharded_topk")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "mind", "--shape", "retrieval_cand", "--mesh", "single",
           "--out", out]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", REPRO_SHARDED_TOPK="1")
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=HERE, env=env, check=True, capture_output=True,
                   timeout=600)
    rec = json.load(open(os.path.join(
        out, "mind__retrieval_cand__single.json")))
    sh = RC.RECSYS_SHAPES["retrieval_cand"]
    b, k = sh["batch"], sh["k"]
    n = cfgbase.get("mind").model_config().item_vocab
    shards = make_production_mesh().shape["model"]
    scores, survivors = b * n * 4, shards * b * k * (4 + 4)
    got, want = (rec.get("collectives", {}).get("all-gather"),
                 base["collectives"]["all-gather"])
    row = dict(cell="mind retrieval_cand single REPRO_SHARDED_TOPK=1",
               status=rec["status"], all_gather_bytes=got,
               default_all_gather_bytes=want, scores_bytes=scores,
               survivors_bytes=survivors,
               collective_gb=rec.get("collective_bytes_per_device", 0) / 1e9,
               trace_s=time.perf_counter() - t0)
    log("phase 17: dryrun " + json.dumps(row))
    if rec["status"] != "ok" or got != want - scores + survivors:
        raise AssertionError(f"phase 17: the sharded top-k record: {row}")


def _random_like(fake, dev):
    """Real tensors of ``fake``'s shapes and dtypes on ``dev``, drawn on
    the card (memory is what is measured; the values only need to be
    finite)."""
    import torch
    from repro_torch.tree import leaves, unflatten
    gen = torch.Generator(device=dev).manual_seed(17)
    out = []
    for t in leaves(fake):
        x = torch.empty(t.shape, dtype=t.dtype, device=dev)
        if x.is_floating_point():
            x.normal_(0.0, 0.02, generator=gen)
        else:
            x.zero_()
        out.append(x)
    return unflatten(fake, out)


def mem_check(name: str, fn, make_fake, make_real, dev,
              donate=(0, 1)) -> dict:
    """Phase 17 (b): the dry run's peak estimate of ``fn`` on fake CUDA
    tensors against ``torch.cuda.max_memory_allocated()`` over one real
    call, both above what was allocated before the call's arguments."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with cfgbase.fake_mode():
        est = dryrun.trace(fn, make_fake, donate_argnums=donate)
    t_est = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    args = make_real()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del out, args
    torch.cuda.empty_cache()
    e = est["memory"]["peak_estimate_bytes"]
    row = dict(step=name, estimate_bytes=e, measured_bytes=peak,
               estimate_over_measured=e / peak,
               estimate_args_bytes=est["memory"]["argument_bytes"],
               allocated_before=base, estimate_s=t_est)
    log("phase 17: memory " + json.dumps(row))
    if abs(e / peak - 1) > MEM_RTOL:
        raise AssertionError(f"phase 17: {name}: estimate {e} against "
                             f"measured {peak}")
    return row


def mem_checks(dev, lm_cfg, bst_cfg, lm_train=MEM_LM_TRAIN,
               lm_decode=MEM_LM_DECODE, bst_batch=MEM_BST_BATCH) -> list:
    """Phase 17 (b) for the three one-card steps."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import recsys_data
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.recsys import bst as BS
    from repro_torch.optim import adamw
    rows = []

    def lm_fake():
        return cfgbase.abstract_tree(T.init_params(lm_cfg, abstract=True),
                                     dev)

    fake_params = lm_fake()
    b, s = lm_train
    step = train.make_step(train._lm_loss, lm_cfg, adamw.AdamWConfig())

    def lm_batch(make):
        return {k: make((b, s)) for k in ("tokens", "targets", "mask")}

    def fake_train():
        p = lm_fake()
        return p, adamw.init_opt_state(p), lm_batch(
            lambda sh: torch.empty(sh, dtype=torch.int32, device=dev))

    def real_train():
        p = _random_like(fake_params, dev)
        return p, adamw.init_opt_state(p), lm_batch(
            lambda sh: torch.randint(0, lm_cfg.vocab, sh, device=dev,
                                     dtype=torch.int32))

    rows.append(mem_check(f"{lm_cfg.name} train step {b} x {s}", step,
                          fake_train, real_train, dev))
    b, s = lm_decode

    def decode_args(params, make):
        cache = T.init_cache(lm_cfg, b, s, device=dev)
        return (params, cache, make((b,)), torch.full(
            (b,), s - 1, dtype=torch.int32, device=dev))

    def fake_decode():
        return decode_args(lm_fake(), lambda sh: torch.empty(
            sh, dtype=torch.int32, device=dev))

    def real_decode():
        return decode_args(_random_like(fake_params, dev),
                           lambda sh: torch.randint(
                               0, lm_cfg.vocab, sh, device=dev,
                               dtype=torch.int32))

    rows.append(mem_check(
        f"{lm_cfg.name} decode step, batch {b}, cache {s}",
        lambda p, c, t, q: T.decode_step(p, lm_cfg, c, t, q), fake_decode,
        real_decode, dev, donate=(1,)))
    bstep = train.make_step(BS.bst_loss, bst_cfg,
                            adamw.AdamWConfig(lr=1e-3, weight_decay=1e-5))
    host = recsys_data.bst_batch(bst_cfg, bst_batch, 0)

    def fake_bst():
        p = cfgbase.abstract_tree(BS.init_bst(bst_cfg, abstract=True), dev)
        mode = cfgbase.fake_mode()
        return p, adamw.init_opt_state(p), {
            k: mode.from_tensor(torch.from_numpy(np.asarray(v))).to(dev)
            for k, v in host.items()}

    def real_bst():
        p = BS.init_bst(bst_cfg, seed=0, device=dev)
        return p, adamw.init_opt_state(p), {
            k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in host.items()}

    rows.append(mem_check(f"bst train step {bst_batch}", bstep, fake_bst,
                          real_bst, dev))
    return rows


def moe_shard_map_check(dev, moe_cfg, d_model: int) -> dict:
    """Phase 17 (c): ``moe_ffn_shard_map`` over a 2 x 2 mesh laid on
    ``dev`` against the local path, forward and gradients."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.distrib.sharding import DeviceMesh
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(moe_cfg, capacity_factor=MOE_CAPACITY)
    rng = np.random.default_rng(17)
    p = M.init_moe_params(rng, cfg, d_model, 1, torch.float32, dev)
    params = {k: v[0].detach().clone().requires_grad_(True)
              for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(MOE_TOKENS, d_model))
                         .astype(np.float32)).to(dev).requires_grad_(True)
    mesh = DeviceMesh([dev] * 4, (2, 2), ("data", "model"))
    y_sm, _ = M.moe_ffn_shard_map(params, x, cfg, mesh)
    y_loc, _ = M.moe_ffn(params, x, dataclasses.replace(cfg,
                                                        dispatch="gspmd"))
    keys = [*params, "x"]
    g_sm = torch.autograd.grad(y_sm.sum(), [*params.values(), x])
    g_loc = torch.autograd.grad(y_loc.sum(), [*params.values(), x])
    errs = {"y": float((y_sm - y_loc).detach().abs().max())}
    errs.update({k: float((a - b).abs().max())
                 for k, a, b in zip(keys, g_sm, g_loc)})
    row = dict(check="moe_ffn_shard_map 2x2 on the card vs local",
               tokens=MOE_TOKENS, experts=cfg.n_experts,
               max_abs_err=errs, tol=MOE_TOL)
    log("phase 17: " + json.dumps(row))
    if max(errs.values()) > MOE_TOL:
        raise AssertionError(f"phase 17: shard_map MoE differs: {errs}")
    return row


def compression_check(dev) -> dict:
    """Phase 17 (d): ``compressed_allreduce`` over 4 positions on the
    card, bit-equal to the same call over 4 CPU positions (two rounds
    of error feedback, a bfloat16 leaf among them)."""
    import torch
    from repro_torch.distrib.sharding import DeviceMesh
    from repro_torch.optim import compression
    gen = torch.Generator().manual_seed(17)
    g = {"w": torch.randn(4, 4096, generator=gen),
         "b": torch.randn(4, 64, 33, generator=gen).to(torch.bfloat16)}
    res = []
    for where in ("cpu", dev):
        mesh = DeviceMesh([where] * 4, (4,), ("data",))
        gl = {k: v.to(where) for k, v in g.items()}
        e = {k: torch.zeros_like(v) for k, v in gl.items()}
        outs = []
        for _ in range(2):
            mean, e = compression.compressed_allreduce(mesh, gl, e, "data")
            outs += [mean[k].cpu() for k in sorted(mean)]
            outs += [e[k].cpu() for k in sorted(e)]
        res.append(outs)
    equal = all(torch.equal(a, b) for a, b in zip(*res))
    row = dict(check="compressed_allreduce 4 positions card vs CPU",
               bit_equal=equal)
    log("phase 17: " + json.dumps(row))
    if not equal:
        raise AssertionError("phase 17: compressed_allreduce on the card "
                             "differs from the CPU")
    return row


def _assemble(shards, spec, mesh, shape):
    """The leaf from its per-position shards, each placed at the block
    its position's coordinates give (ceil-divided, first axis major)."""
    import math
    import numpy as np
    import torch
    full = torch.empty(shape, dtype=shards[0].dtype)
    names = mesh.axis_names
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for c, blk in zip(np.ndindex(*mesh.devices.shape), shards):
        idx = []
        for d, e in enumerate(parts):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            if not axes:
                idx.append(slice(None))
                continue
            k = 0
            for a in axes:
                k = k * mesh.shape[a] + c[names.index(a)]
            n = -(-shape[d] // math.prod(mesh.shape[a] for a in axes))
            idx.append(slice(k * n, k * n + blk.shape[d]))
        full[tuple(idx)] = blk.cpu()
    return full


def elastic_check(dev, bst_cfg) -> dict:
    """Phase 17 (e): a BST checkpoint restored onto a 2 x 2 mesh laid on
    the card (``restore_elastic`` with ``recsys_param_specs``): every
    shard on its position's device, the shards reassembled equal to the
    saved leaves bit for bit."""
    import shutil
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.distrib import elastic
    from repro_torch.distrib import sharding as S
    from repro_torch.models.recsys import bst as BS
    from repro_torch.tree import leaves
    path = os.path.join(HERE, "build", "phase17_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    params = BS.init_bst(bst_cfg, seed=3, device="cpu")
    ckpt.save(path, params, step=1)
    mesh = S.DeviceMesh([dev] * 4, (2, 2), ("data", "model"))
    placed, _ = elastic.restore_elastic(path, params, mesh,
                                        S.recsys_param_specs)
    specs = S.spec_leaves(S.recsys_param_specs(params, mesh))
    n_sharded = 0
    for want, shards, spec in zip(leaves(params), _shard_leaves(placed),
                                  specs):
        if any(x.device.type != dev.type for x in shards):
            raise AssertionError("phase 17: a restored shard is off the card")
        got = _assemble(shards, spec, mesh, want.shape)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 17: restored leaf {spec} differs")
        n_sharded += any(e is not None for e in spec)
    shutil.rmtree(path, ignore_errors=True)
    row = dict(check="restore_elastic of a BST checkpoint onto 2x2 on the "
                     "card", leaves=len(specs), sharded_leaves=n_sharded,
               bit_equal=True)
    log("phase 17: " + json.dumps(row))
    return row


def _shard_leaves(tree):
    """The per-position shard lists of a placed tree, in leaf order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shard_leaves(tree[k])]
    if isinstance(tree, list) and tree and not isinstance(tree[0],
                                                          (dict, list)):
        return [tree]
    return [s for v in tree for s in _shard_leaves(v)]


def ogb_check(dev) -> dict:
    """Phase 17 (f): ogb_products' one-card estimate (the bundle on the
    one-position mesh, traced on fake CUDA tensors); one full-batch step
    only where it is under OGB_SHARE of the card's memory."""
    import torch
    from repro_torch.configs import graphsage_reddit as G
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    mesh = make_smoke_mesh()
    bundle = G.dryrun_bundle("ogb_products", mesh)
    est = dryrun.trace_bundle(bundle, mesh, device=dev)["memory"]
    total = torch.cuda.get_device_properties(dev).total_memory
    row = dict(cell="graphsage-reddit ogb_products, one card",
               estimate_bytes=est["peak_estimate_bytes"], card_bytes=total,
               estimate_share=est["peak_estimate_bytes"] / total)
    if est["peak_estimate_bytes"] >= OGB_SHARE * total:
        row["ran"] = (f"no: the estimate is {row['estimate_share']:.2f} of "
                      f"the card's memory, not under {OGB_SHARE}")
    else:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        args = list(_random_like(list(bundle.args), dev))
        n = args[2].shape[0]
        args[3] = torch.randint(0, n, args[3].shape, device=dev,
                                dtype=torch.int32)
        args[4] = torch.randint(0, 47, args[4].shape, device=dev,
                                dtype=torch.int32)
        args[5] = torch.ones_like(args[5], dtype=torch.bool)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _, _, m = bundle.fn(*args)
        torch.cuda.synchronize()
        row.update(ran="yes", measured_bytes=torch.cuda.max_memory_allocated(
            dev) - base, loss=float(m["loss"]))
        row["estimate_over_measured"] = (est["peak_estimate_bytes"]
                                         / row["measured_bytes"])
        del args, m
        torch.cuda.empty_cache()
        if not math.isfinite(row["loss"]):
            raise AssertionError("phase 17: ogb_products loss not finite")
    log("phase 17: " + json.dumps(row))
    return row


def distrib_path(dev) -> dict:
    """Phase 17 (b)-(f) on the card."""
    import torch
    from repro_torch.configs import bst as bst_configs
    from repro_torch.configs import mixtral_8x22b, tinyllama_1_1b
    torch.cuda.empty_cache()
    out = {"memory": mem_checks(dev, tinyllama_1_1b.model_config(),
                                bst_configs.model_config())}
    smoke = mixtral_8x22b.smoke_config()
    out["moe"] = moe_shard_map_check(dev, smoke.moe, smoke.d_model)
    out["compression"] = compression_check(dev)
    out["elastic"] = elastic_check(dev, bst_configs.model_config())
    out["ogb"] = ogb_check(dev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the served batches; traces go here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs its kernels on "
              "the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name!r}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"phase 0: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    from repro_torch.configs import recsys as configs
    from repro_torch.models import layers

    layers.full_fp32_matmul()     # float32 products in full float32,
    #                               set once for the whole run
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    is_row, stage1_acc = check_impact_scan(dev)
    tk_row = check_topk(dev, stage1_acc)
    is_row["continuous"] = check_impact_scan_chunk(dev)
    tk_row["continuous"] = check_topk_finalize(dev, stage1_acc)
    del stage1_acc
    fcfg = configs.funnel_config()
    fa_row = check_flash_attention(dev, fcfg.bst, fcfg.pool_depth)
    eb_row = check_embedding_bag(dev)
    rows = (is_row, tk_row, fa_row, eb_row)
    for row in rows:
        row["ms_over_library_ms"] = row["ms"] / row["library_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
        row["ptxas"] = (ptxas_summary(reports[row["name"]])
                        if row["name"] in reports else "not built here")
        cont = row.pop("continuous", None)
        log("phase 1: " + json.dumps(row))
        if cont is not None:
            cont["ms_over_library_ms"] = cont["ms"] / cont["library_ms"]
            cont["bound_share"] = cont["bound_ms"] / cont["ms"]
            cont["device_bound_share"] = cont["bound_ms"] / cont["device_ms"]
            log("phase 1: continuous path's shape: " + json.dumps(cont))
            row["continuous"] = cont
    lm_rows = check_flash_lm(dev, reports)
    lm_train_row = check_flash_train_lm(dev)
    log(f"phase 1: kernels hold against their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    # after phase 1's timings, which its CPU work would disturb
    dryrun_proc = dryrun_start()
    torch.cuda.empty_cache()

    sys_, servers, batches, meds = build_servers()
    # the predict numbers of the serving phases (2, 4, 7, 8), which
    # replay the server's predict programs; phase 19 prints them
    seen = {}
    launches, report, served = main_path(sys_, servers, batches, seen)
    mlp_path(sys_, batches, meds)
    funnel, fbatches, fmixed = build_funnel()
    f_launches, _, fserved = funnel_path(funnel, fbatches, fmixed)
    launches.update(flash_attention=f_launches["flash_attention"],
                    embedding_bag=f_launches["embedding_bag"])
    t0 = time.perf_counter()
    service_launches = service_path(sys_, servers, batches, served, funnel,
                                    fbatches, fserved, seen)
    _release_programs(funnel)
    serve_cli()
    drivers_cli()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cont_launches = continuous_path(servers, batches, seen)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    online_launches = online_path(sys_, servers, seen)
    serve_cli_online()
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_launches, shard_rows = sharded_path(sys_, servers, batches,
                                                served, report)
    serve_cli_sharded()
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    is_row["shard"], tk_row["shard"] = shard_rows
    t0 = time.perf_counter()
    offline_path(sys_, meds)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fa_row["train"] = train_path(dev, fcfg.bst)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_launches, decode_step, replayed_step = lm_path(dev)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gnn_path(dev)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sync_path(servers, batches, served, decode_step, replayed_step, funnel,
              fbatches[1], fserved[1])
    del decode_step, replayed_step
    torch.cuda.empty_cache()
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    programs_path(servers, batches)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    predict_programs_path(sys_, servers, batches, seen)
    torch.cuda.empty_cache()
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    distrib_path(dev)
    log(f"phase 17: the card's checks {time.perf_counter() - t0:.1f} s")
    # the kernel at tinyllama's prefill shape, with the launches of phase
    # 13's counted window
    fa_row["lm"] = dict({k: lm_rows[0][k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}, launches=lm_launches["flash_attention"])
    # the tensor-core kernel (fa_tc_kernel) on a line of its own: phase
    # 13's prefills launch it alone, at tinyllama's prefill shape
    tc_row = dict(
        {k: lm_rows[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
        name="flash_attention general_tc", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:110",
        launches=lm_launches["flash_routes"].get("general_tc", 0))
    log("phase 5: flash_attention's path call, CUDA activities per call: "
        + json.dumps(check_flash_activities(dev, fcfg.bst, fcfg.pool_depth)))
    if args.profile:
        targets = {knob: (server.serve_batch, [(qt,) for qt in batches])
                   for knob, (server, _, _) in servers.items()}
        targets["funnel"] = (funnel.serve, fbatches)
        profile(targets, args.profile)
    # last, since every number of phase 14 is its subprocesses' own; the
    # profiler still sees the card after their processes used it
    t0 = time.perf_counter()
    fa_row["lm_train"] = lm_train_path(dev, lm_train_row)
    log("phase 14: profiler canary after its processes: "
        + json.dumps(profiler_canary(dev)))
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    dryrun_finish(dryrun_proc)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["service_launches"] = service_launches[row["name"]]
        row["continuous_launches"] = cont_launches.get(row["name"], 0)
        row["online_launches"] = online_launches.get(row["name"], 0)
        row["sharded_launches"] = sharded_launches.get(row["name"], 0)
        row["lm_launches"] = lm_launches[row["name"]]
        # the kernel at the continuous path's shape, with the launches of
        # phase 7's inline runs (both knobs), and at the shard shape, with
        # the launches of phase 11's counted windows; flash_attention's
        # ``train`` (phase 12) and ``lm`` (phase 13) fields hold their own
        for extra, counts in (("continuous", cont_launches),
                              ("shard", sharded_launches)):
            at = row.get(extra)
            if at is not None:
                row[extra] = dict(
                    {k: at[k] for k in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                    launches=counts[row["name"]])
        for extra in ("shape", "bytes", "select_ms", "max_abs_err_bf16",
                      "bit_equal", "ptxas", "device_ms", "library_device_ms",
                      "device_bound_share", "host_ms", "library_host_ms",
                      "path", "routes", "general"):
            row.pop(extra, None)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": list(rows) + [tc_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
