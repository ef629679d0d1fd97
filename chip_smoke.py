"""On-card smoke test of the PyTorch/CUDA port (``torchbooster_tpu_torch``).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases device,build,flash

Phases, in order; any failure exits non-zero and prints no result:

1. device  — require a CUDA card; print ``nvidia-smi`` name and power limit.
2. build   — compile the port's eleven CUDA sources (nvcc, sm_90a), one
   nvcc per source, all started together, and time it; print the
   registers and spills ``-Xptxas -v`` reports for the B4, B1 and B2/B3
   ``"sm90"`` kernels, the one-pass conv + GroupNorm kernel's B7 and B8
   instances and B5's and B6's one-pass kernels.
3. kernel  — hold the paged flash-decode kernel (B4) against its plain
   PyTorch version at GPT-2-small width (H=12, Dh=64, 64-token pages, 129
   pages, 8 slots): MHA and GQA (4 kv heads), bf16/fp32/int8 pools, S=1
   decode, S=5 linear verify, a tree-verify mask, and a prefix page shared
   by two lanes; each case on the route ``plan_paged`` plans (every bf16-q
   case on ``"sm90"``), those also forced to ``"simt"``, each held element
   by element and in norm (every (slot, head) block within 2^-6), and two
   ``"sm90"`` calls bit for bit; then time both routes (profiler device
   time, and CUDA events per call) beside the plain version, the bound and
   ``scaled_dot_product_attention`` over the same context, each timed call
   reading another of 12 layer pools as the decode step does, at bf16 MHA
   decode and at the prefix cache's layout (8 lanes, every slot behind one
   4-page shared prefix). Then the same at gpt-long's decode geometry (16
   heads over 8 kv heads of 48, 1025 pages, 8 slots at the serve_long
   prompts' contexts, 1024-8000 tokens): decode and GQA verify S=5 over a
   bf16 and an int8 pool and an int8 tree at S=5 held on both routes, and
   bf16 decode timed as above (SDPA on the 8 kv heads with enable_gqa,
   and over K/V repeated to 16 heads beside it).
4. flash   — hold the flash kernels B1 (forward: o, lse), B2 (dq) and B3
   (dk, dv) against their plain versions: GPT-2-small training geometry
   (B 8, H 12, S 1024, D 64) causal at bf16 and fp32, GQA with 4 kv heads,
   S_q 256 < S_kv 1024, ragged S 1000, D 32 (the recipe default's heads),
   D 128 at S 1024, non-causal bf16 and fp32 cases, and gpt-long's head
   dim 48 (16 heads over 8: GQA at S 2048 bf16 and S 1024 fp32, S_q 256
   < S_kv 1024, ragged S 200, and non-causal at S 1024, the sp:8 ring's
   visiting chunks); B1 on the route ``plan_flash_fwd`` plans and B2 and
   B3 on the route ``plan_flash_bwd`` plans (every bf16 case on
   ``"sm90"`` but D 32's, which take ``"mma_sync"``), two bf16 calls of
   each bit for bit; then time each kernel at the training geometry
   (profiler device time, or CUDA events around back-to-back calls where
   the profiler loses events) beside its plain version, its bound and
   SDPA (forward, and its backward), B1, B2 and B3 on ``"sm90"`` and on
   ``"mma_sync"`` on the same inputs; the same at gpt-long's geometry (B
   8, H 16 over 8, S 8192, D 48, SDPA over K/V expanded to 16 heads),
   with B1's exponential floor (one ex2 a visible pair at 16 a clock on
   each SM) beside its bound; and sweep S for the ``"auto"`` crossover
   against ``mha_reference``.
5. serve_fp32 — GPT-2 small, random seeded weights with a decisive head
   (tied embeddings x4), ``ServingConfig(page_size=64, n_pages=129,
   max_slots=8).make(...).run(...)`` on 8 requests (prompts 64-512
   tokens, 32 new tokens each); every request must equal the port's
   dense ``generate``, and the kernel must have launched on this path,
   every launch on ``"simt"`` (``"sm90"`` at bf16). The dense control of
   every serving phase is one ``jit_generate`` fn a call (batch 1):
   one cached shape a prompt length and, once a phase at least, a
   repeated shape kept at that and its first request equal to plain
   ``generate``; prints its ms a new token. Every engine on one card
   plans the captured route (``step_route == "graph"``): every serving
   phase but ``tp`` (eager by the plan: gloo through the host) must have
   run B4 from replays of captured steps (``b4_replayed`` in the report).
6. serve_bf16 — the same at bf16; prints decode tok/s, p50 TTFT and peak
   device memory beside the card's name and power limit, then replays the
   trace under the profiler for the device busy share and the top kernels.
6a. serve_spec_bf16 / serve_spec_fp32 — the same model and pool with
   ``speculative: true, draft_len: 4`` (S = 5 verify rows a slot) built
   through ``ServingConfig.make``: 8 requests with repetitive prompts of
   64-512 tokens (tiled patterns), 64 new tokens each. Every request
   equals the dense ``generate``; some draft is accepted; one verify shape
   and no decode step; B4 launches exactly 12 a verify step, all on
   ``"sm90"`` at bf16 and ``"simt"`` at fp32. Prints the accept rate,
   tokens per verify step, decode tok/s and p50 TTFT beside the plain
   decode engine's on the same prompts.
6b. serve_tree — the same at bf16 with ``spec_tree: true,
   spec_tree_width: 2`` on ambiguous repetitive prompts (the final n-gram
   seen twice with two continuations, the older one the model's own
   pick): 8/8 token-exact, at least one side-branch acceptance counted by
   the engine, one verify shape, every launch on ``"sm90"``.
6c. serve_fork — ``parallel_sampling: true`` at bf16: two requests (256
   and 100 prompt tokens), n = best_of = 4, 32 new tokens. Greedy: every
   branch equals the dense ``generate``, prompt pages shared (read
   through 4 lanes) and tail pages copied, every B4 launch on ``"sm90"``;
   seeded (temperature 0.8, top-k 50): each branch equals the engine's
   own run admitted alone with ``(seed, branch)``.
6d. serve_structured — ``structured: {enabled: true}`` at bf16: the five
   ``SCHEMA_LIBRARY`` schemas (prompts of 64-256 tokens, ``max_new_tokens``
   the schema's budget, EOS 50256) and three unconstrained riders (64-512
   tokens, 32 new). Every constrained completion conforms and stops on
   EOS, every rider equals the dense ``generate``, one decode shape,
   every B4 launch on ``"sm90"``. Then ``speculative: true, draft_len: 4``
   on the same trace: the constrained streams equal the plain structured
   run's, one verify shape, 12 B4 launches a verify step. Then one
   constrained request with n = best_of = 4 (temperature 0.8, top-k 50)
   on a parallel-sampling engine: every branch conforms. Prints each
   schema's token-DFA compile ms at vocab 50257, the masked share of the
   vocabulary, decode tok/s with structured on and off (the same prompts
   and budgets unconstrained, in turns), and B4's device µs a call at
   S = 1 and S = 5 from profiled replays of the trace.
6e. serve_wq — ``weights: {dtype: int8}`` and ``{dtype: int4,
   group_size: 64}`` beside the full-precision engine, at fp32 and bf16,
   on the serving trace of phase 5, and int8 weights with ``cache_dtype:
   int8`` at bf16: every arm equals the dense ``generate`` over its own
   (quantized) tree, with ``cache_dtype="int8"`` for the int8 pool; int8
   equals the full-precision engine 8/8 at fp32; one decode shape an
   arm; B4 on ``"simt"`` at fp32 and ``"sm90"`` at bf16, the int8 pool
   included. Prints each arm's matches against the full-precision stream,
   ``weight_stream_bytes`` for bf16, int8 and int4, decode tok/s and peak
   memory.
6f. serve_lora — ``adapters: {rank: 8, max_live: 4}`` with six adapters
   (``random_adapter(1..6, cfg, 8, std=0.25)``) on the trace of phase 5,
   two requests base and six through an adapter each, at fp32 and bf16:
   seating waits on lanes and evicts; base riders equal the LoRA-off
   engine's streams, every adapter changes its stream, and at fp32 each
   adapter request equals the dense ``generate`` over its merged weights
   (``W_qkv + A_q B_q``, ``W_proj + A_p B_p``); one decode shape, one
   lane-writer shape, no pin left, tables consistent, B4 on its planned
   route. Prints the per-adapter metrics and decode tok/s with LoRA on
   and off (the same prompts, all base).
6g. serve_spill — ``prefix_cache: true, host_spill: {enabled: true,
   budget_mb: 256}`` over a 33-page pool, bf16 over an int8 pool (B4
   ``"sm90"``) and fp32 over a wide pool (``"simt"``): five probes (an
   8-page prefix + 16 tokens, 32 new), each driven through the engine
   cold, as an HBM prefix hit and — after rounds of distinct 2-4-page
   prompts have demoted its 8 pages — as a host hit whose pages promote
   through 4-lane staging in two groups. Every stream equals the dense
   ``generate`` at the pool's cache dtype; one decode and one promotion
   shape; promoted bytes equal ``promotion_traffic``; tables consistent.
   Prints TTFT cold / HBM / host (seat to first token), promotion GB/s
   (bytes over the synchronized ``issue_promotions``), spills, host hits,
   peak memory and ``spill_breakeven`` at the measured rate.
6h. serve_disagg — ``cache_dtype: int8``, the spill tier and ``disagg:
   {enabled: true, min_prefill_pages: 4}`` at bf16: a ``DisaggPair``
   (prefill engine and its worker thread on the same card) pumped over 8
   requests at 0 (prompts 640, 800 and 960 through the prefill engine,
   64-192 straight to decode, 32 new), beside the unified batcher on the
   same trace. Streams equal the unified run's; streamed payload bytes
   equal ``disagg_traffic``, pages ``(len - 1) // 64`` each, none
   stranded; the decode engine one decode, prefill and promotion shape,
   the prefill engine no decode; every B4 launch ``"sm90"`` over the int8
   pool. Prints p50 TTFT of the short and the long requests, decode
   tok/s, framed bytes and memory, on and off.
6i. serve_http — the serving geometry of phase 5 at bf16 through
   ``ServingConfig.make`` from a ``serving:`` mapping with a ``frontend:
   {policy: slo, port: 0}`` block, telemetry and request tracing on
   (``ObservabilityConfig``), behind ``ServingFrontend`` in the phase's
   own event loop: the 8 requests of phase 5 as 8 concurrent SSE clients
   over localhost TCP, each equal to the dense ``generate``; a chat and a
   unary completion; a client that leaves after 8 tokens (pages back,
   tables consistent, no new decode shape); 429 + Retry-After for an
   unmeetable deadline; ``/metrics``, ``/healthz?full=1``,
   ``/debug/engine`` and ``/debug/trace`` with the JAX front door's keys;
   then the same 8 requests pumped in-process, and one profiled 2-token
   request whose one ``decode_step`` range holds 12 B4 calls, each a
   partials and a merge kernel on ``"sm90"``. Prints client TTFT and
   TPOT p50/p99, tok/s over the window beside the in-process pump's, and
   the device busy share of a profiled replay of the 8 clients.
6j. serve_replay — a ``LoadgenConfig`` Poisson workload (32 requests,
   interactive:3 / batch:1, 1/8 with a recorded disconnect, prompts
   64-512, 16-32 new) under ``policy: slo``: ``replay_inprocess`` twice
   (identical streams and outcomes; uncancelled streams equal the dense
   ``generate``, cancelled ones prefixes of it), then ``replay_http``
   against a front door with ``capture_path`` (the capture holds the
   offered requests; every request served in full both ways equals its
   in-process stream). Prints both conformance reports.
6k. serve_fleet — two replicas of the serving geometry on the one card,
   built by ``ServingConfig.make`` from a ``router: {n_replicas: 2}``
   block under ``policy: slo``: ``serve_replay``'s workload cut to 16
   requests, replayed twice under ``round_robin`` and twice under
   ``affinity`` (identical assignment logs and streams, equal to a
   one-replica replay and, uncancelled, to the dense ``generate``), a
   shared-prefix workload
   (affinity hits, requests at their key's home, more prefix-hit pages
   than round robin), ``fleet.kill(1)`` mid-replay (readmissions equal
   what ``kill`` returned, streams unchanged), a socket replica served on
   loopback beside an in-process one (the same streams and assignment
   log), and the front door over a fleet (8 SSE clients token-exact,
   ``/debug/router``, ``/healthz?full=1``, ``/metrics``). No replica may
   be buried outside the kill arm; B4's launches equal 12 per decode
   step the batchers' flight rings hold, all ``"sm90"``. Prints the wall
   time of a two-replica replay beside the one-replica one.
7. train  — the GPT recipe's ``main`` (``recipes/gpt.py``) on a config
   built in code from ``examples/lm/gpt/gpt.yml``'s values with the model
   at GPT-2-small width: batch 8 x 1024, 20 steps, bf16 over fp32 masters,
   remat, AdamW + cycle schedule (2-step warmup), clip 1.0, then a
   32-token sample. Every loss finite and the last below the first; the
   flash launch counts exact (B1 2 x 12 per step with remat, plus 12 for
   the sample's prefill; B2 and B3 12 per step; all three on ``"sm90"``);
   one fp32 forward +
   backward with the flash kernels against ``mha_reference`` (loss and
   gradient norm, rtol 1e-4). Prints step ms, tokens/s, the model-FLOP
   share of 989 TFLOP/s, peak memory, and a profiled device busy share
   with the top kernels. Remat here and in every phase below follows
   the JAX policy: the blocks' dense products are saved, everything
   else (B1 among it) is recomputed in backward.
7a. gpt2_import — a GPT-2 small checkpoint laid out as HF's
   ``GPT2LMHeadModel.state_dict()`` (``transformer.`` keys, Conv1D
   ``(in, out)`` weights, ``lm_head.weight`` tied; numpy from a seed,
   wte x4) imported by ``load_torch_gpt2`` onto the card: the config is
   GPT-2 small's and every tensor equals its source bit for bit. Then
   8 steps of ``utils.make_step`` from the imported params with each of
   lamb, lion and adafactor (``gpt2_train_config``'s batch 8 x 1024,
   bf16, remat, chunked head, clip 1.0, ``synthetic_lm``; the lr of
   ``GPT2_LR``): finite losses, the last below the first; B1 24, B2 12
   and B3 12 launches a step, all ``"sm90"``; one more update on the
   card against the same optimizer on the CPU from the same params,
   gradients and state; adafactor's state under 1% of the fp32 params.
   Prints step ms, tokens/s, peak memory and optimizer-state bytes. The
   adafactor-tuned model is then served as phases 5 and 6 serve: 8/8
   token-exact against the dense ``generate`` at bf16 (B4 ``"sm90"``)
   and at fp32 (``"simt"``).
7b. train_long — the GPT recipe's ``setup`` and ``main`` at
   ``examples/lm/gpt/gpt-long.yml``'s widths, built in code with the
   overrides ``LONG_OVERRIDES`` lists (one card, mesh ``dp``; 12 steps, a
   2-step warmup, a checkpoint every 4 steps into a temp dir, one
   validation batch): batch 8 x 8192 byte tokens of the repo's own
   ``*.py`` and ``*.md`` text (``text_file``), 12 layers, d_model 768, 16
   heads over 8 kv heads (D 48), rope, dropout 0.1, remat, chunked head,
   AdamW with decay on matrices only, a cos/cos cycle, then a 128-token
   top-p 0.95 sample. Checks: B1 24, B2 12 and B3 12 launches a step (and
   12 B1 each for the eval batch and the sample's prefill), all on
   ``"sm90"``, and no ``mha_reference`` call;
   finite losses whose last 3 average below the first; ``ckpt_04``,
   ``ckpt_08``, ``ckpt_12``; a fresh ``setup`` resumes at step 12 with
   params, AdamW moments, step and generator bit for bit, and one more
   step from both trainers agrees bit for bit; one generator state gives
   one loss, and the eval loss (no generator) is the dropout-0 loss bit
   for bit; 136 byte tokens printed as text. Prints the median step ms of
   steps 3-12, tokens/s, the model-FLOP share of 989 TFLOP/s (dense and
   causal attention FLOPs stated), peak memory, the checkpoint's bytes
   with the save's blocking and background-write ms, the validation loss,
   and a profiled busy share with B1-B3's share of device time.
7c. serve_long — gpt-long served: ``Config.load("examples/lm/gpt/
   gpt-long.yml")``'s model (12 layers, d_model 768, 16 heads over 8 kv
   heads of 48, rope, vocab 256), random weights of seed 42, bf16, the decisive tied head (x4),
   through ``ServingConfig(page_size=64, n_pages=1025, max_slots=8)
   .make(...)`` and ``ContinuousBatcher.run``: 8 greedy requests whose
   prompts are 1024-8000-byte windows of the repo's text, 32 new tokens
   each. Gates: ``check_paged`` plans ``"sm90"``; every stream equals the
   dense ``generate`` (its prefill B1 at D 48 on ``"sm90"``, 12 a call);
   one decode shape; every B4 launch ``"sm90"``. Prints decode tok/s, ms
   a decode step, TTFT p50/p99, peak memory, and from the decode-only
   tail of a replay through the batcher's session API, under the
   profiler (``device_breakdown``), the device ms a step, busy share,
   B4's µs a call and share of device time and the top kernels.
7d. serve_graph — the captured steps against their eager twins:
   serve_bf16's trace (GPT-2 small) and serve_long's (gpt-long), each
   through a captured bf16 batcher and one under ``eager_steps()``, in
   turns (captured, eager, eager, captured): the first pair's
   decode-only tails timed by the host clock (ms a decode step, decode
   tok/s), the second's profiled (device ms a step, busy share, B4 µs a
   call). Gates: all four runs token-exact, B4 launches equal by route
   (all ``"sm90"``), one captured decode graph and its replays, none in
   the twin. One such pair (timed by the host clock) each at GPT-2 small
   for fp32 (B4 on ``"simt"``), chain and tree verify (repetitive and
   ambiguous prompts, draft 4; the verify graph, and the compaction's in
   tree mode; equal accepted drafts) and a sampled stream (temperature
   0.8, top-k 50, the engines' generators from one seed). Then ``jit_generate`` (its decode step captured a shape)
   against ``generate`` over serve_bf16's trace at batch 1, in turns:
   ms a new token each, token-exact, one cached shape a prompt length
   and one shape cached once.
8. conv    — hold the GroupNorm kernels B5 (forward) and B6 (backward) and
   the fused conv + GroupNorm kernels B7 (1x1, any stride) and B8 (3x3,
   stride 1) against their plain versions, in bf16 and fp32, with and
   without ReLU: every ResNet-18 CIFAR geometry at batch 512 (the stem,
   each stage, the stride-2 projections), ResNet-50 224² bottleneck
   geometries (56²x64->256 1x1, 56²x64 3x3, a 7²x2048 GroupNorm), a
   non-square 7x9 map, and widths off the 16-byte vectors (12 channels
   in, 40 out), B8's one-pass routes at small batch (a cluster at B 3,
   a partial pack at B 5) and B5's packed route at B 3 (the last CTA
   holding one sample); B5-B8 each on the route its plan
   (``plan_gn_fwd``, ``plan_gn_bwd``, ``plan_conv1x1``, ``plan_conv3x3``)
   names, asserted by the per-route counters, every B5 and B6
   ``"one_pass"`` and B7 ``"cluster"``/``"pack"`` case also forced onto the
   older route (``"two_pass"``, ``"mma_sync"``) within the same tolerance,
   and two bf16 calls on the same inputs agreeing bit for bit (B8, B7 on
   both one-pass routes, B6 at a cluster of 4 and of 1, B5 at a cluster of
   2, of 1 and two samples a CTA); then time each kernel
   at every ResNet-18 shape of the training path (profiler device time;
   the port's launches also by replays of a CUDA graph of 20 calls, which
   stands in for a column whose profiler window loses events, the plain
   version and the library call falling back on their own to CUDA events
   around back-to-back calls, and the line says which; and CUDA events
   per call) beside its bound, its plain version, the older
   route's kernel on the same inputs (B5-B8) and a library yardstick
   (``F.group_norm`` on the channels-last view and its backward; for
   B7/B8 the sequence cuDNN conv + ``F.group_norm`` + ReLU), with the
   route, B5's, B6's and B7's CTAs per SM, and B8's TFLOP/s over the
   product counted once; B5's and B6's one-pass kernels are also timed at
   the other plans their rules passed over.
9. resnet_train — the ResNet recipe's ``main`` (``recipes/resnet.py``) on a
   config built in code from ``examples/img_cls/resnet/resnet.yml``'s
   values (ResNet-18, CIFAR stem, batch 512, bf16 over fp32 masters,
   AdamW, cycle schedule, clip 1.0, label smoothing 0.1, host
   augmentation) for 2 epochs of the ``cifar10`` twin (32 steps, and an
   eval pass of 2 batches after each epoch). Every loss finite and the
   last below the first; the launch counts of B5-B8 exact (per train step
   B5 4, B6 4, B7 3, B8 13; per eval forward B5 4, B7 3, B8 13), and by
   route: B5 and B6 all ``"one_pass"``, B7 1 ``"cluster"`` and 2 ``"pack"`` per
   forward, B8 7 ``"cluster"`` and 6 ``"pack"``; one fp32
   forward + backward with the kernels against ``fused=False`` and the
   plain GroupNorm (loss and gradient norm, rtol 1e-4). Prints step ms,
   img/s, the model-FLOP share of 989 TFLOP/s, peak memory, the host data
   time per step and a profiled device busy share with the top kernels.
10. resnet_data — the data path under ResNet-18: a full-size CIFAR-10
   binary release (5 x 10,000 train and 10,000 test records, the
   ``synthetic_cifar10`` twin's images quantized to uint8) written from a
   seed into a temporary directory, which ``cifar10`` resolves as
   ``local:cifar10_bin`` (read back equal to what was written);
   ``BaseDataset.prepare`` turns both splits into ``train.bstore`` /
   ``test.bstore`` under a second root, which resolves as ``store``;
   4,096 records drawn from a seed read equal through the Python and the
   native reader, each alone and in gathers of 512 (write and read MB/s).
   Then the recipe's trainer (``setup``, ``to_device``, ``step``; the
   YAML's values: batch 512, bf16, host augmentation) on the store, 2
   warm-up and 8 timed steps under each loader: (a) ``num_workers: 0``,
   (b) min(8, cpu count) threads, (c) as many spawn processes, (d) the
   faster of (b) and (c) under ``prefetch_to_device(size=2)``. Every loss
   finite, B5-B8's launches exact per step (B5 4, B6 4, B7 3, B8 13) and
   by route, the labels in the same order in every mode; then 8 batches
   without augmentation that (d)'s loader delivers on the card equal the
   ``num_workers: 0`` host batches byte for byte. Prints each mode's step
   ms, img/s, host data ms per step and profiled busy share.
11. train_comms — GPT-2 small through a world-1 NCCL group: 6 steps
   under each of 11 gradient schedules (implicit, ZeRO stages 0-3, fp32,
   bf16 and int8 wires, overlap off and on), a sharded checkpoint's
   bit-exact resume, and the recipe's ``launch_main`` with a ``comms:``
   block.
12. moe     — GPT-2 small's width (12 layers, d 768, 12 heads, vocab
   50257, seq 1024, learned positions) with every MLP an MoE layer of 8
   experts, top-2 at capacity factor 1.25 (JAX ``GPTConfig``'s
   defaults): the recipe's ``launch_main`` on a world-1 NCCL group with
   ``mesh: "ep:1"``, 6 steps at batch 8, bf16, remat on, a sharded
   checkpoint at the last step. Every loss finite, ``aux`` reported and
   >= 0.9 at every step, B1 / B2 / B3 24 / 12 / 12 launches a step, all
   ``"sm90"``. ``setup`` then resumes the trainer from the checkpoint in a
   second world-1 group: each layer's dropped assignments in one
   forward (printed), 2 profiled steps (busy share). The trained tree is
   served on the paged engine at fp32: every stream token-exact against
   the dense ``generate`` at the engine's capacity factor (``max(cf,
   n_experts)``, as JAX's engine serves MoE blocks), B4 launches = 12 x
   decode steps, all ``"simt"``. Prints step ms, tokens/s, peak memory
   and the busy share.
13. sp_fold — the ring's per-rank step functions (``parallel/ring.py``
   ``ring_fwd_step`` / ``ring_bwd_step``) for all eight ranks of
   gpt-long's ``sp:8`` in one process, the rotation done in-process: at
   gpt-long's width (B 8, S 8192 = 8 x 1024, 16 heads over 8 kv heads, D
   48, bf16 causal) and the MoE model's (12 heads, S 1024, D 64); every
   launch of the fold on its kernel's planned route (``"sm90"`` at both
   widths). The fold's out, lse, dQ, dK and dV held
   to the plain versions (``flash_attention_reference``,
   ``flash_attention_backward_reference``) and to one whole-sequence
   B1-B3 call on the same inputs: atol = rtol = 2e-2 element by element,
   and ||err|| / ||ref|| <= 2^-6 in each of the 8 chunks (both printed);
   the same fold with rank 7's visit to chunk 0 left out of the backward
   must fail the norm check. B1 8 causal (diagonal) + 28 non-causal
   launches a pass, B2 and B3 36 each, routes printed. At gpt-long's
   width Ulysses' per-rank local attention (2 query heads over 1 kv
   head, the whole sequence, through the dispatcher, forward and
   backward) held the same way. Prints the
   fold's ms beside one whole-sequence B1 + B2 + B3's (CUDA events a
   call) and each call's B1-B3 kernels alone (profiler), a finding only.
14. tp      — GPT-2 small at full width (12 layers, d 768, 12 heads,
   vocab 50257, seq 1024, learned positions, random weights of seed 42)
   at ``tp:2``: two processes on the one card in a gloo group over
   tensors on the card (NCCL refuses two ranks on one card; gloo takes
   the all-reduces and broadcasts the path issues), spawned after the
   build. Every block runs on 6 of the 12 heads (``_block_core(tp=...)``,
   the rule table holding each rank's slices). fp32 (TF32 off): 2 steps
   of batch 4 x 1024 against the tp:1 run of the same seed and batches
   on the card, losses and the first step's gradients (gathered to the
   canonical layout) within 1e-4 (|err| <= 1e-4 |ref| + 1e-4 max|ref| a
   leaf). bf16: 6 steps at batch 8, remat on: finite falling losses, B1
   / B2 / B3 24 / 12 / 12 a step a rank on ``"sm90"``. The trained tree
   (head x4, decisive) served at tp:2 at fp32 and bf16 (8 requests of
   64-512 prompt tokens, 32 new, page size 64): every stream token-exact
   against the dense ``generate`` at tp:1, B4 = 12 x decode steps a
   rank, each rank's pool half of tp:1's. Then the first 4 requests
   through dense ``jit_generate(mesh=)`` on the rule-sharded tree on
   both ranks: token-exact against tp:1 and equal across ranks, B1 = 12
   a request a rank (``"sm90"`` at bf16, ``"f32"`` at fp32), 24
   all-reduces a token, ms a new token beside tp:1's dense decode.
   Prints step ms, peak GiB a
   rank, busy share, all-reduces a step and a forward, and
   ``step_traffic``'s bytes; the all-reduces go through gloo and the
   host, so no speed is read from this phase.
15. pp_fold — the same model at ``pp:4`` (3 layers a stage), batch 8, so
   8 microbatches of 1 x 1024, every stage in this process: the port's
   ``run_schedule`` (``stage_tick`` each tick, the stages'
   ``stage_runner``s, as ``pipeline_apply`` runs them) through
   ``parallel.pipeline.fold_apply``, the rotation in-process, each (layer, microbatch) through ``models.gpt.
   pipeline_layer`` under remat. Logits and gradients held to the
   un-pipelined ``GPT.apply`` on the card: fp32 (TF32 off) within the
   1e-4 bound above, bf16 at atol = rtol = 2e-2 and ||err|| / ||ref|| <=
   2^-6 a tensor. B1 / B2 / B3 192 / 96 / 96 a step on ``"sm90"``, and no
   stage runs its layers on an inactive tick. Prints the fold's ms and
   device ms beside the un-pipelined step's, a finding only.

16. ddpm — the ddpm recipe (``recipes/ddpm.py``) at ``ddpm.yml``'s
   widths (UNet base 64, mults 1, 2, 2, time_dim 256, one channel, cosine
   T 1000, EMA 0.999, batch 256, bf16 weights over fp32 images) over a
   full-size MNIST IDX release: the UNet's forward and every gradient on
   one batch through B5/B6 against the plain GroupNorm, at fp32 (29 calls
   each way on ``"two_pass"``) and with bf16 images and weights (the first
   norm on ``"one_pass"``, 28 on ``"two_pass"``: the fp32 time projection
   promotes the rest); ``launch_main`` for one epoch (234 steps, cut from
   10 epochs; a checkpoint after it): the loss falling, B5 29 a forward
   and B6 29 a step by route, 16 samples by DDIM 50; ``setup`` resumes
   from the checkpoint and samples from the EMA by DDIM (equal to the
   file launch_main wrote within 1e-5 of the largest entry) and by the
   ancestral chain over all 1000 steps, B5 29 a step; a class-conditional
   model (10 classes, p_uncond 0.1) 8 steps, ``cfg_apply`` checked on the
   card and DDIM 50 at guidance 2 over a doubled batch of 32; a profiled
   window; B5 and B6 timed at the UNet's six GroupNorm shapes at fp32 and
   bf16 beside their plain versions, bounds and ``F.group_norm``.
17. vae_gan — the vae and gan recipes' ``launch_main`` for one epoch each
   (117 steps at batch 512) over the release at their YAMLs' values (vae
   bf16; the GAN in fp32, as JAX's step never casts): the VAE's loss
   falling and ``kld`` >= 0, every GAN metric finite, samples written,
   D's loss gradient with the penalty's double backward on the card
   within 1e-4 of the CPU's largest entry; no B-kernel launches.
18. style — ``offline.yml`` in full (500 Adam steps on a 256² image,
   fp32, random VGG-19; the loss falling), ``online.yml`` (batch 16) and
   ``adain.yml`` (batch 8) at 256², bf16, cut to 24 steps with a preview
   every 12: every loss finite, every output written; no B-kernel.

The last stdout line is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel's route, error, times and launches. Longer
output (ptxas report, per-case errors) goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PHASES = ("device", "build", "kernel", "flash", "serve_fp32", "serve_bf16",
          "serve_spec_bf16", "serve_spec_fp32", "serve_tree", "serve_fork",
          "serve_structured", "serve_wq", "serve_lora", "serve_spill",
          "serve_disagg", "serve_http", "serve_replay", "serve_fleet",
          "train", "gpt2_import", "train_long", "serve_long", "serve_graph",
          "conv",
          "resnet_train",
          "resnet_data", "lenet", "resnet_import", "image_models",
          "ddpm", "vae_gan", "style", "train_comms", "moe", "sp_fold", "tp",
          "pp_fold")
SERVE_PHASES = ("serve_fp32", "serve_bf16", "serve_spec_bf16",
                "serve_spec_fp32", "serve_tree", "serve_fork",
                "serve_structured", "serve_wq", "serve_lora",
                "serve_spill", "serve_disagg", "serve_http",
                "serve_replay", "serve_fleet")
SOURCES = ("paged_attention", "paged_decode_sm90", "flash_attention",
           "flash_fwd_sm90", "flash_bwd_sm90", "group_norm",
           "group_norm_fwd_sm90", "group_norm_bwd_sm90", "fused_block",
           "conv1x1_gn_sm90", "conv3x3_gn_sm90")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core rate
FP32_FLOPS = 67e12               # H100 SXM fp32 rate outside tensor cores
# ex2 an SM does a clock on its special-function units (the CUDA C++
# programming guide's instruction throughput table, compute capability 9.0)
SFU_EX2_PER_CLOCK = 16
DEV = "cuda"
# what a number timed by device_ms is; ``sum_ms`` beside it is the sum of
# the kernels' own times, the measure of the smoke's earlier revisions
DEVICE_TIME = "profiler device time, union of kernel intervals"
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# GPT-2-small serving geometry of phases 3-5
H, DH, PS, N_PAGES, SLOTS, N_LAYERS = 12, 64, 64, 129, 8, 12
PROMPT_LENS = (64, 100, 150, 200, 256, 300, 400, 512)
N_NEW = 32
# gpt-long's serving geometry (phase serve_long, and B4 at head dim 48 in
# phase kernel): 16 heads over 8 kv heads of 48, the same 64-token pages
# and 8 slots, 1025 pages; prompts of 1024-8000 bytes of repo text
LONG_H, LONG_KV, LONG_DH, LONG_N_PAGES = 16, 8, 48, 1025
LONG_PROMPT_LENS = (1024, 2048, 3072, 4096, 5120, 6144, 7168, 8000)
# gpt-long.yml's model, as serve_long checks it
LONG_MODEL = dict(n_layers=12, d_model=768, n_heads=LONG_H,
                  kv_heads=LONG_KV, head_dim=LONG_DH, vocab=256, pos="rope")


def log(msg: str) -> None:
    print(msg, flush=True)


def hold_captured(pa, key: str, before: int, report: dict) -> None:
    """A serving phase on one card ran its decode and verify steps as
    replays of captured graphs: B4 launches came from replays while it
    ran (``launches_replayed`` grew past ``before``)."""
    n = sum(pa.launches_replayed.values()) - before
    report.setdefault("b4_replayed", {})[key] = n
    if n <= 0:
        raise AssertionError(f"{key}: no B4 launch came from a captured "
                             f"step")


def sm_clocks_mhz() -> dict:
    """The SM clock now and its maximum, in MHz, as ``nvidia-smi``
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    now, top = (float(x) for x in out.stdout.strip().splitlines()[0]
                .split(","))
    return {"now": now, "max": top}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(text: str, pattern: str) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``
    output, for the mangled entry names that ``pattern`` (a regex with the
    kernel's name and then its template arguments as groups) matches."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(pattern, m.group(1))
            got = [g for g in k.groups() if g is not None] if k else []
            name = (got[0] + (f"<{','.join(got[1:])}>" if got[1:] else "")
                    if got else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_name(signature: str) -> str:
    """``paged_merge_sm90`` from the profiler's ``void (anonymous
    namespace)::paged_merge_sm90<64>(...)``."""
    import re

    m = re.search(r"(\w+)[<(]", signature)
    return m.group(1) if m else signature


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median milliseconds per call over ``iters`` timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def stream_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call from CUDA events around ``iters`` calls
    issued back to back: where the host enqueues faster than the card
    runs them, this is the card's own time per call, without the host
    gap that :func:`cuda_ms` counts before each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Milliseconds per call from CUDA events around ``replays`` replays of
    one CUDA graph that holds ``calls`` calls of ``fn`` (captured after
    three warm calls on a side stream): the card's own time, without the
    host's cost per call that :func:`stream_ms` counts when the host is
    slower than the card, but with the short gaps between the graph's
    kernels that :func:`device_ms` leaves out. For the port's own launch
    functions, which stream capture takes as they are."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    torch.cuda.empty_cache()
    return a.elapsed_time(b) / (calls * replays)


GRAPH_TIME = "CUDA graph of 20 calls, replayed between CUDA events"


def device_ms(fn, iters: int = 50, by_kernel: dict | None = None) -> float:
    """Milliseconds of device time per call, from the profiler: the union
    of the device intervals (kernels and copies) over ``iters`` calls, so
    a kernel launched early under its predecessor by programmatic
    dependent launch (B4's merge) counts once. ``by_kernel``, when given,
    gets each kernel's own device milliseconds per call; their sum is the
    measure of the smoke's earlier revisions, and equals the union where
    no two kernels overlap. The host-side launch cost, which
    :func:`cuda_ms` includes, is left out. Every call launches at least
    one kernel, so a window that recorded fewer device intervals than
    calls lost events (seen once on the card: a 100 µs kernel read as 3.6
    µs, and later whole windows of one-kernel calls, two in a row in a
    full run); it is profiled again, and 0.0 is returned when four windows
    in a row lose events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = device_spans(prof)
        if len(spans) < iters:
            continue
        if not SPANS_HELD:
            hold_device_spans(prof, spans)
        if by_kernel is not None:
            for start, stop, name in spans:
                by_kernel[name] = by_kernel.get(name, 0.0) \
                    + (stop - start) / iters / 1e3
        return union_us(spans) / iters / 1e3
    return 0.0


def device_spans(prof) -> list:
    """``(start µs, end µs, name)`` of every device activity the profiler
    recorded, in start order, from the profiler's raw records: the same
    intervals and demangled names as ``prof.events()``, with its filter,
    without building an event object a record, which is slow over a long
    serving replay's records. :func:`hold_device_spans` holds the two
    readings together in the run's first :func:`device_ms` window."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    spans = []
    for e in res.events():
        if (e.device_type() != DeviceType.CUDA or e.end_ns() <= e.start_ns()
                or e.name() in ("[memory]", "[OutOfMemory]")
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        spans.append(((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
                      torch._C._demangle(e.name())))
    return sorted(spans)


# the first full window of device_ms, held by hold_device_spans
SPANS_HELD: dict = {}


def hold_device_spans(prof, spans) -> None:
    """Hold :func:`device_spans`' reading of the raw records to the
    profiler's public ``prof.events()`` in one window: the same number of
    device intervals, the same intervals to the nanosecond, the same
    union. Every device time of the smoke comes through
    :func:`device_spans`, so a profiler whose raw records change fails
    here rather than moving every time unseen."""
    from torch.autograd import DeviceType

    public = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.time_range.end > e.time_range.start)
    raw = [(start, stop) for start, stop, _ in spans]
    same = len(public) == len(raw) and all(
        abs(a - c) < 1e-3 and abs(b - d) < 1e-3
        for (a, b), (c, d) in zip(public, raw))
    u_public = union_us([(a, b, "") for a, b in public])
    u_raw = union_us(spans)
    if not same or abs(u_public - u_raw) > 1e-3:
        raise AssertionError(f"device spans: the raw records give "
                             f"{len(raw)} intervals over {u_raw:.3f} us, "
                             f"prof.events() {len(public)} over "
                             f"{u_public:.3f} us")
    SPANS_HELD.update(spans=len(raw), union_us=u_raw)
    log(f"device spans: the raw records agree with prof.events() ({len(raw)} "
        f"device intervals, union {u_raw:.3f} us, each to the nanosecond)")


def union_us(spans) -> float:
    """Microseconds covered by at least one of the sorted ``spans``."""
    busy, end = 0.0, -math.inf
    for start, stop, _ in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


# ---------------------------------------------------------------- kernel
def make_case(rs, *, kv_heads, pool, q_dtype, s_q, tree, shared, lens=None,
              prefix_pages: int = 0, n_heads: int = H, head_dim: int = DH,
              n_pages: int = N_PAGES):
    """A pool, a compacted work list and queries at serving geometry
    (GPT-2 small's heads and pool unless ``n_heads``, ``head_dim`` and
    ``n_pages`` say otherwise). ``shared``: slots 0 and 1 share their
    first two (full) pages, listed once in the work list with both slots
    on its lanes. ``prefix_pages``: every slot shares its first that many
    pages (the prefix cache's layout, one lane per slot)."""
    from torchbooster_tpu_torch.models.gpt import _quantize_kv

    dev = DEV
    lens = np.asarray(lens if lens is not None
                      else rs.randint(64, 600, SLOTS), np.int64)
    if shared:
        lens[:2] = np.maximum(lens[:2], 2 * PS + 1)
    n_lanes = SLOTS if shared or prefix_pages else 1
    free = list(rs.permutation(np.arange(1, n_pages)))
    table = {}
    for s in range(SLOTS):
        need = -(-int(lens[s] + s_q) // PS)
        table[s] = [int(free.pop()) for _ in range(need)]
    if shared:
        table[1][:2] = table[0][:2]
    for s in range(1, SLOTS if prefix_pages else 1):
        table[s][:prefix_pages] = table[0][:prefix_pages]
    holders: dict[int, list[tuple[int, int]]] = {}
    for s in range(SLOTS):
        for idx, p in enumerate(table[s]):
            holders.setdefault(p, []).append((s, idx))
    live = sorted(holders)
    n_w = n_pages - 1
    wp = np.zeros(n_w, np.int32)
    wr = np.full((n_w, n_lanes), -1, np.int32)
    wpos = np.zeros(n_w, np.int32)
    for i, p in enumerate(live):
        wp[i] = p
        wpos[i] = holders[p][0][1]
        for lane, (s, _) in enumerate(holders[p]):
            wr[i, lane] = s
    shape = (n_pages, PS, kv_heads, head_dim)
    k = torch.randn(shape, device=dev)
    v = torch.randn(shape, device=dev)
    if pool == "int8":
        pk, pv = _quantize_kv(k), _quantize_kv(v)
    else:
        dt = torch.bfloat16 if pool == "bf16" else torch.float32
        pk, pv = k.to(dt), v.to(dt)
    del k, v
    q = torch.randn(SLOTS, s_q, n_heads, head_dim, device=dev).to(q_dtype)
    tvis = None
    if tree:
        # a random candidate tree per slot: node j hangs off a parent < j
        tvis = np.zeros((SLOTS, s_q, s_q), np.int32)
        for s in range(SLOTS):
            parent = [0] + [int(rs.randint(0, j)) for j in range(1, s_q)]
            for j in range(s_q):
                node = j
                while True:
                    tvis[s, j, node] = 1
                    if node == 0:
                        break
                    node = parent[node]
        tvis = torch.as_tensor(tvis, device=dev)
    as_dev = lambda a: torch.as_tensor(a, device=dev)
    return dict(q=q, pool_k=pk, pool_v=pv, work_pages=as_dev(wp),
                work_refs=as_dev(wr), work_pos=as_dev(wpos),
                lengths=as_dev(lens.astype(np.int32)), tree_vis=tvis,
                n_live=len(live), lens=lens)


def kernel_inputs(case):
    return ((case["q"], case["pool_k"], case["pool_v"], case["work_pages"],
             case["work_refs"], case["work_pos"], case["lengths"]),
            dict(page_size=PS, tree_vis=case["tree_vis"]))


def kv_dtype_of(pool: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp32": torch.float32,
            "int8": torch.int8}[pool]


def time_paged(rs, lens, prefix_pages: int = 0, plain: bool = True,
               kv_heads: int = H, n_heads: int = H, head_dim: int = DH,
               n_pages: int = N_PAGES) -> dict:
    """B4 at bf16 decode over a serving geometry (GPT-2 small's MHA unless
    the heads, head dim and pool are given), every number from this one
    call: the planned ``"sm90"`` route, ``"simt"`` forced on the same
    inputs, the plain version (``plain``), SDPA over the same context
    gathered dense on the kv heads (a yardstick the port never calls) and
    the bound. Each timed call reads another of
    N_LAYERS layer pools (over 300 MB, past the 50 MB L2), as the decode
    step does."""
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    case = make_case(rs, kv_heads=kv_heads, pool="bf16",
                     q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False,
                     lens=lens, prefix_pages=prefix_pages, n_heads=n_heads,
                     head_dim=head_dim, n_pages=n_pages)
    args, kw = kernel_inputs(case)
    q, pk, pv, rest = args[0], args[1], args[2], args[3:]
    rep = n_heads // kv_heads
    route = pa.plan_paged(q.dtype, pk.dtype, head_dim, PS, 1, rep)
    if route != "sm90":
        raise AssertionError(f"bf16 decode at head dim {head_dim} planned "
                             f"{route!r}, not sm90")
    layers = [(pk.clone(), pv.clone()) for _ in range(N_LAYERS)]
    turn = itertools.count()

    def runner(fn, **extra):
        def run():
            lk, lv = layers[next(turn) % N_LAYERS]
            return fn(q, lk, lv, *rest, **kw, **extra)
        return run

    # SDPA over the same context gathered dense per slot (a shared page is
    # copied into every slot that holds it), padded to the longest slot and
    # masked, on the kv heads with enable_gqa, so it reads each kv head
    # once as B4 does; the gather is outside the timing, and the layer
    # pools are copies of one, so is their gather. Where the query heads
    # share kv heads, SDPA over K/V repeated to the query heads (the
    # yardstick of earlier revisions) is timed beside it.
    wp = case["work_pages"].long()
    wr = case["work_refs"].cpu().numpy()
    wpos = case["work_pos"].cpu().numpy()
    max_len = int(lens.max()) + 1
    lk, lv = layers[0]
    kd = torch.zeros(SLOTS, kv_heads, max_len, head_dim, device="cuda",
                     dtype=torch.bfloat16)
    vd = torch.zeros_like(kd)
    for i in range(case["n_live"]):
        base = int(wpos[i]) * PS
        n = min(PS, max_len - base)
        for s in (int(x) for x in wr[i] if x >= 0):
            if n > 0:
                kd[s, :, base:base + n] = lk[wp[i], :n].transpose(0, 1)
                vd[s, :, base:base + n] = lv[wp[i], :n].transpose(0, 1)
    dense = [(kd, vd)] + [(kd.clone(), vd.clone())
                          for _ in range(N_LAYERS - 1)]
    expanded = [(k.repeat_interleave(rep, dim=1),
                 v.repeat_interleave(rep, dim=1))
                for k, v in dense] if rep > 1 else None
    mask = (torch.arange(max_len, device="cuda")[None, :]
            <= torch.as_tensor(lens, device="cuda")[:, None])
    qd = q.transpose(1, 2)                               # (slots, H, 1, Dh)
    attn_mask = mask[:, None, None, :]

    def library(pools, gqa):
        def run():
            kd, vd = pools[next(turn) % N_LAYERS]
            return torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=attn_mask, enable_gqa=gqa)
        return run

    runs = {"sm90": runner(pa.paged_attention),
            "simt": runner(pa.paged_attention, route="simt"),
            "library": library(dense, rep > 1)}
    if expanded is not None:
        runs["library_expanded"] = library(expanded, False)
    if plain:
        runs["plain"] = runner(pa.paged_attention_reference)
    # device time (profiler) is the kernels' own time (both passes); call
    # time (CUDA events around each call) adds the host launch path
    iters = {"plain": 50}
    call = {k: cuda_ms(f, iters=iters.get(k, 200)) for k, f in runs.items()}
    per_kernel = {k: {} for k in runs}
    dev = {k: device_ms(f, iters=iters.get(k, 200), by_kernel=per_kernel[k])
           for k, f in runs.items()}
    src = dev if all(dev.values()) else call
    # the bound counts what these inputs need: each live page's tokens that
    # some holder sees, read once (a shared page once for all its lanes),
    # q read and the output written once, plus the work list and lengths
    page_tokens = 0
    for i in range(case["n_live"]):
        base = int(wpos[i]) * PS
        page_tokens += max(min(PS, max(0, int(lens[s]) + 1 - base))
                           for s in wr[i] if s >= 0)
    kv_bytes = 2 * page_tokens * kv_heads * head_dim * 2   # K and V, bf16
    io_bytes = (2 * SLOTS * n_heads * head_dim * 2 + wp.numel() * 4 * 2
                + wr.size * 4 + SLOTS * 4)
    flops = 4 * n_heads * head_dim * int((lens + 1).sum())
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    sums = {k: sum(per_kernel[k].values()) if src is dev else None
            for k in ("sm90", "simt")}
    # K and V as SDPA reads them: every slot padded to the longest
    library_kv_bytes = 2 * kd.numel() * kd.element_size()
    del layers, dense, expanded
    torch.cuda.empty_cache()
    return {"ms": src["sm90"], "previous_ms": src["simt"],
            "sum_ms": sums["sm90"], "previous_sum_ms": sums["simt"],
            "plain_ms": src.get("plain"), "library_ms": src["library"],
            "library_expanded_ms": src.get("library_expanded"),
            "library_kv_bytes": library_kv_bytes, "kv_bytes": kv_bytes,
            "timed_route": route,
            "timed_by": DEVICE_TIME if src is dev
            else "CUDA events per call", "call_ms": call, "device_ms": dev,
            "kernel_ms": {k: per_kernel[k] for k in ("sm90", "simt")},
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_pages": case["n_live"], "lanes": int(wr.shape[1]),
            "page_tokens": page_tokens, "bytes": kv_bytes + io_bytes,
            "flops": flops, "heads": n_heads, "kv_heads": kv_heads,
            "head_dim": head_dim}


# B4's output held in norm beside the element-wise check: ||err|| / ||ref||
# over each (slot, head) block of (S, Dh) at most this. At long contexts a
# typical |o| is a few hundredths, about the element-wise allowance, so
# that check alone would pass a kernel that dropped part of a context.
PAGED_REL = 2.0 ** -6


def paged_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ||got - want|| / ||want|| over the (slot, head) blocks of a
    paged output of shape (slots, S, H, Dh)."""
    g, w = got.float(), want.float()
    err = (g - w).square().sum(dim=(1, 3)).sqrt()
    ref = w.square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)
    return (err / ref).max().item()


def phase_kernel(report: dict) -> dict:
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    rs = np.random.RandomState(0)
    cases = [
        ("mha_bf16_decode", dict(kv_heads=12, pool="bf16", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False)),
        ("gqa_bf16_decode", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False)),
        ("mha_fp32_decode", dict(kv_heads=12, pool="fp32", q_dtype=torch.float32, s_q=1, tree=False, shared=False)),
        ("mha_int8_decode", dict(kv_heads=12, pool="int8", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False)),
        ("gqa_int8_fp32q_decode", dict(kv_heads=4, pool="int8", q_dtype=torch.float32, s_q=1, tree=False, shared=False)),
        ("gqa_bf16_verify5", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=5, tree=False, shared=False)),
        ("mha_int8_tree5", dict(kv_heads=12, pool="int8", q_dtype=torch.bfloat16, s_q=5, tree=True, shared=False)),
        ("gqa_bf16_shared_prefix", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=True)),
        ("mha_fp32_shared_tree5", dict(kv_heads=12, pool="fp32", q_dtype=torch.float32, s_q=5, tree=True, shared=True)),
        # 8 lanes x rep 3 x S 5 = 120 query rows on each shared-prefix item:
        # more than a ring slot's 64, so "sm90" stages them in two rounds
        ("gqa_bf16_verify5_prefix", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=5, tree=False, shared=False, prefix_pages=2)),
        ("gqa_int8_tree5_prefix", dict(kv_heads=4, pool="int8", q_dtype=torch.bfloat16, s_q=5, tree=True, shared=False, prefix_pages=2)),
    ]
    # gpt-long's decode geometry (16 heads over 8 of 48, 1025 pages, the
    # serve_long prompts' contexts): decode and GQA verify 5 over a bf16
    # and an int8 pool, an int8 tree at S 5
    long = dict(n_heads=LONG_H, head_dim=LONG_DH, n_pages=LONG_N_PAGES,
                kv_heads=LONG_KV, q_dtype=torch.bfloat16, shared=False,
                lens=LONG_PROMPT_LENS)
    cases += [
        ("gpt_long_d48_bf16_decode", dict(long, pool="bf16", s_q=1, tree=False)),
        ("gpt_long_d48_int8_decode", dict(long, pool="int8", s_q=1, tree=False)),
        ("gpt_long_d48_bf16_verify5", dict(long, pool="bf16", s_q=5, tree=False)),
        ("gpt_long_d48_int8_verify5", dict(long, pool="int8", s_q=5, tree=False)),
        ("gpt_long_d48_int8_tree5", dict(long, pool="int8", s_q=5, tree=True)),
    ]
    worst = worst_rel = 0.0
    per_case = {}
    repeat = {}
    for name, spec in cases:
        case = make_case(rs, **spec)
        args, kw = kernel_inputs(case)
        route = pa.plan_paged(spec["q_dtype"], kv_dtype_of(spec["pool"]),
                              spec.get("head_dim", DH), PS, spec["s_q"],
                              spec.get("n_heads", H) // spec["kv_heads"])
        if (route == "sm90") != (spec["q_dtype"] == torch.bfloat16):
            raise AssertionError(f"kernel case {name}: planned {route!r}")
        want = pa.paged_attention_reference(*args, **kw)
        if spec["q_dtype"] == torch.bfloat16:
            atol = rtol = 2e-2
        else:
            atol, rtol = 1e-4, 1e-4
        # the planned route, then "simt" forced on the same inputs
        errs, rels, outs = {}, {}, {}
        for r in dict.fromkeys((route, "simt")):
            before = pa.launches_by_route[r]
            got = pa.paged_attention(*args, **kw,
                                     route=None if r == route else r)
            torch.cuda.synchronize()
            if pa.launches_by_route[r] != before + 1:
                raise AssertionError(f"kernel case {name}: the {r!r} route "
                                     f"did not launch")
            err = (got.float() - want.float()).abs().max().item()
            rel = paged_rel(got, want)
            ok = torch.allclose(got.float(), want.float(), atol=atol,
                                rtol=rtol)
            if not ok or not math.isfinite(err) or not rel <= PAGED_REL:
                raise AssertionError(f"kernel case {name} ({r}) disagrees "
                                     f"with paged_attention_reference: max "
                                     f"abs {err}, largest (slot, head) "
                                     f"norm ratio {rel} (limit {PAGED_REL})")
            errs[r], rels[r], outs[r] = err, rel, got
        if route == "sm90":
            again = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(outs["sm90"], again):
                raise AssertionError(f"kernel case {name}: two sm90 calls on "
                                     f"the same inputs differ")
            repeat[name] = True
        per_case[name] = {"route": route, "max_abs_err": errs,
                          "norm_ratio": rels, "atol": atol, "rtol": rtol,
                          "rel": PAGED_REL, "live_pages": case["n_live"]}
        log(f"kernel {name}: route {route}, max_abs_err " + ", ".join(
            f"{r} {e:.3e}" for r, e in errs.items())
            + f" (atol {atol}, rtol {rtol}); largest (slot, head) norm "
            f"ratio " + ", ".join(f"{r} {e:.3e}" for r, e in rels.items())
            + f" (limit {PAGED_REL:.3e}) live_pages={case['n_live']}")
        worst = max(worst, errs[route])
        worst_rel = max(worst_rel, *rels.values())
    report["kernel_cases"] = per_case
    log(f"kernel cases: largest (slot, head) norm ratio over every case "
        f"and route {worst_rel:.3e} (limit {PAGED_REL:.3e})")
    log("paged repeat, bit for bit: " + ", ".join(
        f"{n} (sm90) ok" for n in repeat))

    # timing at the main path's shapes: bf16 MHA decode, one lane, the
    # serving prompts mid-decode; then the prefix-cache layout: 8 lanes,
    # all 8 slots behind one 256-token (4-page) shared prompt prefix
    timing = time_paged(rs, np.asarray(PROMPT_LENS) + N_NEW // 2)
    prefix = time_paged(rs, np.asarray(PROMPT_LENS) + N_NEW // 2 + 4 * PS,
                        prefix_pages=4, plain=False)
    # gpt-long's decode step: 16 heads over 8 of 48 at the serve_long
    # prompts' contexts, mid-decode
    long_t = time_paged(rs, np.asarray(LONG_PROMPT_LENS) + N_NEW // 2,
                        kv_heads=LONG_KV, n_heads=LONG_H, head_dim=LONG_DH,
                        n_pages=LONG_N_PAGES)
    for label, t in (("bf16 MHA decode", timing),
                     ("bf16 MHA decode, 8 lanes, 4-page shared prefix",
                      prefix),
                     ("gpt-long bf16 GQA decode, 16 heads over 8 of 48",
                      long_t)):
        plain = (f"; plain {t['plain_ms'] * 1e3:.2f} us"
                 if t["plain_ms"] is not None else "")
        expanded = (f" on the kv heads (enable_gqa), "
                    f"{t['library_expanded_ms'] * 1e3:.2f} us with K/V "
                    f"repeated to the query heads"
                    if t["library_expanded_ms"] is not None else "")
        log(f"kernel timing ({label}, {t['live_pages']} live pages, "
            f"{t['timed_by']}): sm90 {t['ms'] * 1e3:.2f} us; simt "
            f"{t['previous_ms'] * 1e3:.2f} us{plain}; sdpa over dense "
            f"gather {t['library_ms'] * 1e3:.2f} us{expanded} (reads "
            f"{t['library_kv_bytes'] / 1e6:.1f} MB of K/V, padded to the "
            f"longest slot, against B4's {t['kv_bytes'] / 1e6:.1f}); bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); per-call "
            f"(events) " + ", ".join(f"{k} {v * 1e3:.1f} us"
                                     for k, v in t["call_ms"].items())
            + "; each kernel's own device time " + "; ".join(
                f"{r}: " + ", ".join(f"{kernel_name(n)} {v * 1e3:.2f} us"
                                     for n, v in ks.items())
                + f" (sum {sum(ks.values()) * 1e3:.2f} us)"
                for r, ks in t["kernel_ms"].items()))
    report["kernel_timing"] = timing
    report["kernel_timing_prefix"] = prefix
    report["kernel_timing_gpt_long"] = long_t
    return {"max_abs_err": worst, **timing, "gpt_long": long_t}


# ----------------------------------------------------------------- flash
# B1-B3 cases: (name, B, H, H_kv, S_q, S_kv, D, dtype, causal). The first
# is the training path's geometry (GPT-2 small, batch 8 x 1024) and the
# one timed; "d32" is the recipe default's (d_model 256 / 8 heads).
FLASH_CASES = [
    ("mha_bf16_causal", 8, 12, 12, 1024, 1024, 64, torch.bfloat16, True),
    ("mha_fp32_causal", 8, 12, 12, 1024, 1024, 64, torch.float32, True),
    ("gqa4_bf16_causal", 8, 12, 4, 1024, 1024, 64, torch.bfloat16, True),
    ("kvcache_bf16_sq256_skv1024", 8, 12, 12, 256, 1024, 64,
     torch.bfloat16, True),
    ("ragged1000_bf16_causal", 8, 12, 12, 1000, 1000, 64, torch.bfloat16,
     True),
    ("d32_bf16_causal", 32, 8, 8, 256, 256, 32, torch.bfloat16, True),
    ("d128_bf16_causal", 4, 8, 8, 1024, 1024, 128, torch.bfloat16, True),
    ("mha_bf16_noncausal_s512", 4, 12, 12, 512, 512, 64, torch.bfloat16,
     False),
    ("mha_fp32_noncausal_s512", 4, 12, 12, 512, 512, 64, torch.float32,
     False),
    # gpt-long's heads (d_model 768 / 16 = D 48, 16 over 8 kv heads)
    ("gqa2_d48_bf16_causal", 2, 16, 8, 2048, 2048, 48, torch.bfloat16, True),
    ("gqa2_d48_fp32_causal", 1, 16, 8, 1024, 1024, 48, torch.float32, True),
    ("d48_bf16_kvcache_sq256_skv1024", 8, 16, 8, 256, 1024, 48,
     torch.bfloat16, True),
    ("d48_bf16_ragged200", 2, 16, 8, 200, 200, 48, torch.bfloat16, True),
    ("d48_bf16_noncausal_s1024", 2, 16, 8, 1024, 1024, 48, torch.bfloat16,
     False),
    # the tp:2 dense prefill's: one request over a rank's 6 of GPT-2
    # small's heads, at prompt lengths of the tp phase (64 and 100 fit in
    # less than one tile)
    *((f"prefill_tp2_{name}_s{s}", 1, 6, 6, s, s, 64, dtype, True)
      for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))
      for s in (64, 100, 200)),
]
# head dims whose bf16 cases run the "mma_sync" kernels (no "sm90" build
# of B1-B3)
MMA_SYNC_DIMS = (32,)
# gpt-long's attention (examples/lm/gpt/gpt-long.yml): B, H, H_kv, S, D
LONG_GEOMETRY = (8, 16, 8, 8192, 48)
# atol = rtol, per dtype. bf16: the kernels round P and dS to bf16 before
# their second product (tensor-core operands) where the plain version
# keeps fp32, so outputs differ by a few bf16 ulp of their own size;
# fp32: only the summation order differs
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# and in norm: ||err|| / ||ref|| of o, dq, dk and dv in each 128-row chunk
# of the sequence, where the element-wise allowance is as large as a late
# causal row's values
FLASH_REL = 2.0 ** -6


def flash_inputs(gen, b, h, h_kv, s_q, s_kv, d, dtype):
    """(q, k, v, dO) in the kernels' folded (BH, S, D) layout."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    return (rand(b * h, s_q, d), rand(b * h_kv, s_kv, d),
            rand(b * h_kv, s_kv, d), rand(b * h, s_q, d))


def expected_route(dtype, d) -> str:
    """The route both flash plans (B1's, B2/B3's) must give a case:
    ``"f32"`` at fp32, ``"mma_sync"`` at the bf16 head dims without an
    ``"sm90"`` build, ``"sm90"`` at every other bf16 case of
    ``FLASH_CASES``."""
    if dtype == torch.float32:
        return "f32"
    return "mma_sync" if d in MMA_SYNC_DIMS else "sm90"


def visible_pairs(s_q, s_kv, causal):
    """(query, key) pairs the causal mask leaves visible, per head."""
    if not causal:
        return s_q * s_kv
    off = s_kv - s_q
    return sum(min(s_kv, max(0, i + off + 1)) for i in range(s_q))


def phase_flash(report: dict) -> dict:
    """Each of B1, B2 and B3 against its plain version in every case
    (element by element and, in 128-row chunks, in norm), then timed at
    the training geometry and at gpt-long's. Returns the three kernels'
    ``kernels``-line fields."""
    from torchbooster_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(0)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    per_case = {}
    repeat = {}
    for name, b, h, h_kv, s_q, s_kv, d, dtype, causal in FLASH_CASES:
        q, k, v, do = flash_inputs(gen, b, h, h_kv, s_q, s_kv, d, dtype)
        scale = 1.0 / math.sqrt(d)
        # B1 on its planned route: every bf16 case on "sm90" but D 32's,
        # which take "mma_sync"
        fwd_route = fa.plan_flash_fwd(dtype, d, s_q, s_kv, h // h_kv)
        if fwd_route != expected_route(dtype, d):
            raise AssertionError(f"flash case {name}: B1 planned "
                                 f"{fwd_route!r}, not "
                                 f"{expected_route(dtype, d)!r}")
        before = fa.launches_fwd_by_route[fwd_route]
        o, lse = fa.launch_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        if fa.launches_fwd_by_route[fwd_route] != before + 1:
            raise AssertionError(f"flash case {name}: B1 did not take the "
                                 f"{fwd_route!r} route")
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
        # the backward pair on the same inputs: the plain forward's o/lse,
        # on its planned route: every bf16 case on "sm90" but D 32
        route = fa.plan_flash_bwd(dtype, d, s_q, s_kv, h // h_kv)
        if route != expected_route(dtype, d):
            raise AssertionError(f"flash case {name}: planned {route!r}, "
                                 f"not {expected_route(dtype, d)!r}")
        before = (fa.launches_dq_by_route[route],
                  fa.launches_dkv_by_route[route])
        dq, delta = fa.launch_dq(q, k, v, o_ref, lse_ref, do, causal, scale)
        dk, dv = fa.launch_dkv(q, k, v, lse_ref, do, delta, causal, scale)
        torch.cuda.synchronize()
        if (fa.launches_dq_by_route[route], fa.launches_dkv_by_route[route]
                ) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"flash case {name}: B2/B3 did not take "
                                 f"the {route!r} route")
        if dtype == torch.bfloat16:
            # a second call on the same inputs must repeat bit for bit
            o2, lse2 = fa.launch_fwd(q, k, v, causal, scale)
            dq2, delta2 = fa.launch_dq(q, k, v, o_ref, lse_ref, do, causal,
                                       scale)
            dk2, dv2 = fa.launch_dkv(q, k, v, lse_ref, do, delta2, causal,
                                     scale)
            torch.cuda.synchronize()
            repeat[name] = {"fwd_route": fwd_route, "route": route,
                            "fwd_bit_identical": torch.equal(o, o2)
                            and torch.equal(lse, lse2),
                            "bit_identical": all(
                torch.equal(x, y) for x, y in ((dq, dq2), (delta, delta2),
                                               (dk, dk2), (dv, dv2)))}
            if not repeat[name]["fwd_bit_identical"]:
                raise AssertionError(f"flash case {name} ({fwd_route}): two "
                                     f"forward calls on the same inputs "
                                     f"differ")
            if not repeat[name]["bit_identical"]:
                raise AssertionError(f"flash case {name} ({route}): two "
                                     f"backward calls on the same inputs "
                                     f"differ")
        args = (q, k, v, o_ref, lse_ref, do, causal, scale)
        dq_ref = fa.dq_reference(*args)
        dk_ref, dv_ref = fa.dkv_reference(*args)
        tol = FLASH_TOL[dtype]
        errs, used = hold_flash(f"flash case {name}", tol, (
            ("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
            ("dk", dk, dk_ref), ("dv", dv, dv_ref)))
        rel = hold_flash_norm(f"flash case {name}", (
            ("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
            ("dv", dv, dv_ref)))
        worst["fwd"] = max(worst["fwd"], errs["o"], errs["lse"])
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
        per_case[name] = {"max_abs_err": errs, "allowance_used": used,
                          "atol": tol, "rtol": tol, "rel_err": rel,
                          "rel_bound": FLASH_REL, "fwd_route": fwd_route,
                          "bwd_route": route}
        log(f"flash {name}: " + ", ".join(
            f"{k} {errs[k]:.2e} ({100 * used[k]:.0f}%)" for k in errs)
            + f" (max abs err, and % of the allowance atol + rtol|ref| "
            f"used; atol = rtol = {tol}); ||err|| / ||ref|| " + ", ".join(
                f"{k} {r:.2e}" for k, r in rel.items())
            + f" (the largest 128-row chunk's, bound {FLASH_REL}); forward "
            f"route {fwd_route}, backward route {route}")
    report["flash_cases"] = per_case
    report["flash_bwd_repeat"] = repeat
    log("flash forward repeat, bit for bit: " + ", ".join(
        f"{n} ({r['fwd_route']}) ok" for n, r in repeat.items()))
    log("flash backward repeat, bit for bit: " + ", ".join(
        f"{n} ({r['route']}) ok" for n, r in repeat.items()))

    # timing at the training path's shapes (bf16 MHA causal, B 8, H 12,
    # S 1024, D 64), each kernel beside its plain half, SDPA and the
    # "mma_sync" route on the same inputs
    _, b, h, h_kv, s_q, _, d, _, _ = FLASH_CASES[0]
    timing = time_flash(gen, b, h, h_kv, s_q, d, worst, previous=True)
    log(f"flash timing B2 + B3: sm90 {(timing['dq']['ms'] + timing['dkv']['ms']) * 1e3:.1f}"
        f" us, mma_sync {(timing['dq']['previous_ms'] + timing['dkv']['previous_ms']) * 1e3:.1f}"
        f" us, sdpa backward {timing['dq']['library_ms'] * 1e3:.1f} us")
    report["flash_timing"] = timing
    # and at gpt-long's (B 8, H 16 over 8 kv heads, S 8192, D 48), where
    # B1's and B2/B3's planned route is "sm90", beside each on "mma_sync"
    # on the same inputs; its max abs errors are those of the timed inputs
    # alone
    b, h, h_kv, s_len, d = LONG_GEOMETRY
    long = time_flash(gen, b, h, h_kv, s_len, d, None, previous=True,
                      plain_iters=3)
    fwd = long["fwd"]
    log(f"flash timing gpt-long B1: {fwd['timed_route']} "
        f"{fwd['ms'] * 1e3:.1f} us ({fwd['tflops']:.1f} TFLOP/s), "
        f"mma_sync {fwd['previous_ms'] * 1e3:.1f} us, plain "
        f"{fwd['plain_ms'] * 1e3:.1f} us, sdpa forward "
        f"{fwd['library_ms'] * 1e3:.1f} us; bound {fwd['bound_ms'] * 1e3:.1f}"
        f" us ({fwd['bound_by']}), exponential floor "
        f"{fwd['exp_floor_ms'] * 1e3:.1f} us ({fwd['exps'] / 1e9:.3f} G "
        f"ex2 at {SFU_EX2_PER_CLOCK} a clock on {fwd['exp_floor_sms']} SMs "
        f"at {fwd['exp_floor_mhz']:.0f} MHz; SM clock read after the "
        f"timing {fwd['sm_mhz_after']:.0f} MHz)")
    log(f"flash timing gpt-long B2 + B3: sm90 "
        f"{(long['dq']['ms'] + long['dkv']['ms']) * 1e3:.1f} us, mma_sync "
        f"{(long['dq']['previous_ms'] + long['dkv']['previous_ms']) * 1e3:.1f}"
        f" us, sdpa backward {long['dq']['library_ms'] * 1e3:.1f} us; B1 "
        f"({fwd['timed_route']}) + B2 + B3 "
        f"{sum(long[k]['ms'] for k in ('fwd', 'dq', 'dkv')):.3f} ms; sdpa "
        f"forward + backward {long['sdpa_fwd_bwd_ms']:.3f} ms")
    report["flash_timing_long"] = long
    report["auto_crossover"] = crossover()
    return {**timing, "long": long}


def flash_errs(tol: float, pairs) -> tuple[dict, dict]:
    """For each ``(key, got, want)`` of ``pairs``: the max abs error and
    the largest share of its allowance atol + rtol|want| (atol = rtol =
    ``tol``) that any element uses: <= 1 is what torch.allclose
    accepts."""
    errs, used = {}, {}
    for key, got, want in pairs:
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        errs[key] = diff.max().item()
        used[key] = (diff / (tol + tol * want.abs())).max().item()
    return errs, used


def hold_flash(label: str, tol: float, pairs) -> tuple[dict, dict]:
    """Each ``(key, got, want)`` of ``pairs`` held to atol = rtol = ``tol``
    (raises on a miss). Returns :func:`flash_errs`'s max abs errors and
    shares of the allowance."""
    errs, used = flash_errs(tol, pairs)
    for key in errs:
        if not (used[key] <= 1.0 and math.isfinite(errs[key])):
            raise AssertionError(f"{label}: {key} disagrees with the plain "
                                 f"version: max abs err {errs[key]} (atol "
                                 f"= rtol = {tol})")
    return errs, used


def hold_flash_norm(label: str, pairs) -> dict:
    """Each ``(key, got, want)`` of ``pairs`` held in norm: ||got - want||
    / ||want|| at most ``FLASH_REL`` in each 128-row chunk of the sequence
    (dim 1; the whole sequence where its length is no multiple of 128),
    so that an error confined to some rows (a wrong late kv step) shows
    (raises on a miss). Returns each key's largest ratio."""
    rel = {}
    for key, got, want in pairs:
        s_len = got.shape[1]
        rel.update(rel_errs([(key, got, want)],
                            s_len // 128 if s_len % 128 == 0 else 1))
    if not all(r <= FLASH_REL for r in rel.values()):
        raise AssertionError(f"{label}: ||err|| / ||ref|| {rel} in 128-row "
                             f"chunks (bound {FLASH_REL})")
    return rel


def time_flash(gen, b, h, h_kv, s_len, d, worst, previous: bool,
               plain_iters: int = 10) -> dict:
    """B1, B2 and B3 at bf16, causal, ``(B, H, H_kv, S, D)``, each on its
    planned route beside its plain version, its bound and SDPA (the
    forward; its backward, whose dQ, dK and dV stand beside B2 + B3;
    grouped K/V are expanded to the query heads before SDPA's timed
    calls), and with ``previous`` the ``"mma_sync"`` route on the same
    inputs for each kernel planned on ``"sm90"``. Each kernel's output on
    the timed inputs is held to its plain
    version's (bf16 atol = rtol of ``FLASH_TOL``); a kernel's
    ``max_abs_err`` is that error, or the larger of it and ``worst``'s
    (the checked cases' at this head dim) where ``worst`` is given."""
    from torchbooster_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    q, k, v, do = flash_inputs(gen, b, h, h_kv, s_len, s_len, d, dtype)
    scale = 1.0 / math.sqrt(d)
    fwd_route = fa.plan_flash_fwd(dtype, d, s_len, s_len, h // h_kv)
    bwd_route = fa.plan_flash_bwd(dtype, d, s_len, s_len, h // h_kv)
    routes = {"fwd": fwd_route, "dq": bwd_route, "dkv": bwd_route}
    o, lse = fa.launch_fwd(q, k, v, True, scale)
    _, delta = fa.launch_dq(q, k, v, o, lse, do, True, scale)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (t.reshape(b, -1, s_len, d) for t in (q, k, v, do))
    k4, v4 = (t.repeat_interleave(h // h_kv, dim=1) for t in (k4, v4))
    q4g, k4g, v4g = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out4 = sdpa(q4g, k4g, v4g, is_causal=True)
    bwd_args = (q, k, v, o, lse, do, True, scale)
    runs = {
        "fwd": (lambda: fa.launch_fwd(q, k, v, True, scale),
                lambda: fa.flash_attention_reference(q, k, v, True, scale),
                lambda: sdpa(q4, k4, v4, is_causal=True)),
        "dq": (lambda: fa.launch_dq(q, k, v, o, lse, do, True, scale),
               lambda: fa.dq_reference(*bwd_args),
               lambda: torch.autograd.grad(out4, (q4g, k4g, v4g), do4,
                                           retain_graph=True)),
        "dkv": (lambda: fa.launch_dkv(q, k, v, lse, do, delta, True, scale),
                lambda: fa.dkv_reference(*bwd_args), None),
    }
    pairs = b * h * visible_pairs(s_len, s_len, True)
    el = torch.finfo(dtype).bits // 8
    n_q, n_kv = b * h * s_len * d, b * h_kv * s_len * d
    rows = b * h * s_len
    # products per kernel (2 flops per multiply-add over D for each visible
    # pair): B1 QK^T, PV; B2 QK^T, dO V^T, dS K; B3 QK^T, dO V^T, P^T dO,
    # dS^T Q. Bytes: each input read once, each output written once.
    work = {"fwd": (2 * 2, (n_q + 2 * n_kv + n_q) * el + rows * 4),
            "dq": (3 * 2, (3 * n_q + 2 * n_kv + n_q) * el + rows * 8),
            "dkv": (4 * 2, (2 * n_q + 4 * n_kv) * el + rows * 8)}
    # B1, B2 and B3 on their earlier route, on the same inputs (outside
    # the main path's launch counts), where "sm90" is the planned one
    older = {
        "fwd": lambda: fa.launch_fwd(q, k, v, True, scale,
                                     route="mma_sync"),
        "dq": lambda: fa.launch_dq(q, k, v, o, lse, do, True, scale,
                                   route="mma_sync"),
        "dkv": lambda: fa.launch_dkv(q, k, v, lse, do, delta, True, scale,
                                     route="mma_sync")} if previous else {}
    older = {key: fn for key, fn in older.items() if routes[key] == "sm90"}
    # one output of each kernel and of its plain version on these inputs
    tol = FLASH_TOL[dtype]
    label = f"flash timed inputs B{b} H{h} H_kv{h_kv} S{s_len} D{d}"
    o_ref, lse_ref = runs["fwd"][1]()
    dq_ref = runs["dq"][1]()
    delta_ref = (o.float() * do.float()).sum(dim=-1)
    dk, dv = runs["dkv"][0]()
    dk_ref, dv_ref = runs["dkv"][1]()
    dq = runs["dq"][0]()[0]
    errs, used = hold_flash(label, tol, (
        ("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
        ("delta", delta, delta_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)))
    rel = hold_flash_norm(label, (
        ("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
        ("dv", dv, dv_ref)))
    log(f"{label}: " + ", ".join(f"{n} {errs[n]:.2e} ({100 * used[n]:.0f}%)"
                                 for n in errs)
        + f" (max abs err vs the plain version, % of atol + rtol|ref| "
        f"used; atol = rtol = {tol}); ||err|| / ||ref|| " + ", ".join(
            f"{n} {r:.2e}" for n, r in rel.items())
        + f" (the largest 128-row chunk's, bound {FLASH_REL}); B1 route "
        f"{fwd_route}, B2/B3 route {bwd_route}")
    measured = {"fwd": max(errs["o"], errs["lse"]),
                "dq": max(errs["dq"], errs["delta"]),
                "dkv": max(errs["dk"], errs["dv"])}
    del o_ref, lse_ref, dq_ref, delta_ref, dk, dv, dk_ref, dv_ref, dq
    timing = {"checked": {"max_abs_err": errs, "allowance_used": used,
                          "atol": tol, "rtol": tol, "rel_err": rel,
                          "rel_bound": FLASH_REL}}
    for key, (kern, plain, lib) in runs.items():
        call = {"kernel": cuda_ms(kern, iters=50),
                "plain": cuda_ms(plain, iters=plain_iters)}
        own = {}
        dev = {"kernel": device_ms(kern, iters=50, by_kernel=own),
               "plain": device_ms(plain, iters=plain_iters)}
        if lib is not None:
            call["library"] = cuda_ms(lib, iters=50)
            dev["library"] = device_ms(lib, iters=50)
        if key in older:
            call["previous"] = cuda_ms(older[key], iters=50)
            dev["previous"] = device_ms(older[key], iters=50)
        stream = {}
        if all(dev.values()):
            src, timed_by = dev, DEVICE_TIME
        else:
            # the profiler lost events: time the calls back to back
            fns = {"kernel": kern, "plain": plain, "library": lib,
                   "previous": older.get(key)}
            stream = {n: stream_ms(fn, iters=plain_iters if n == "plain"
                                   else 50)
                      for n, fn in fns.items() if fn is not None}
            src, timed_by = stream, "CUDA events over back-to-back calls"
        prods, nbytes = work[key]
        flops = prods * d * pairs
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        timing[key] = {
            "ms": src["kernel"], "plain_ms": src["plain"],
            "sum_ms": sum(own.values()) if src is dev else None,
            "library_ms": src.get("library"), "timed_by": timed_by,
            "call_ms": call, "device_ms": dev, "stream_ms": stream,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "tflops": flops / src["kernel"] / 1e9,
            "timed_route": routes[key],
            "max_abs_err": max(measured[key], worst[key]) if worst
            else measured[key], "timed_inputs_max_abs_err": measured[key]}
        lib_txt = (f"; sdpa {src['library'] * 1e3:.1f} us"
                   if lib is not None else "")
        route_txt = f" (route {routes[key]})"
        if key in older:
            timing[key].update(
                previous_route="mma_sync", previous_ms=src["previous"],
                previous_tflops=flops / src["previous"] / 1e9)
            route_txt += (f"; mma_sync {src['previous'] * 1e3:.1f} us, "
                          f"{timing[key]['previous_tflops']:.1f} TFLOP/s")
        log(f"flash timing {key} (bf16 causal B{b} H{h} H_kv{h_kv} "
            f"S{s_len} D{d}, {timed_by}): kernel {src['kernel'] * 1e3:.1f} "
            f"us{route_txt}; plain {src['plain'] * 1e3:.1f} us{lib_txt}; "
            f"bound {timing[key]['bound_ms'] * 1e3:.1f} us "
            f"({timing[key]['bound_by']}, {flops / 1e12:.3f} TFLOP); "
            f"achieved {timing[key]['tflops']:.1f} TFLOP/s")
    # B1's second floor: one ex2 a visible pair on the special-function
    # units, at the SM clock's maximum (the least time)
    clocks = sm_clocks_mhz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    timing["fwd"].update(
        exps=pairs, exp_floor_sms=n_sm, exp_floor_mhz=clocks["max"],
        sm_mhz_after=clocks["now"],
        exp_floor_ms=pairs / (n_sm * SFU_EX2_PER_CLOCK * clocks["max"] * 1e6)
        * 1e3)
    # the SDPA yardstick's backward computes dQ, dK and dV in one call: it
    # stands beside B2 and B3 together
    timing["dkv"]["library_ms"] = timing["dq"]["library_ms"]
    timing["sdpa_fwd_bwd_ms"] = timing["fwd"]["library_ms"] \
        + timing["dq"]["library_ms"]
    del q, k, v, do, q4g, k4g, v4g, out4
    torch.cuda.empty_cache()
    return timing


def crossover() -> list:
    """Forward + backward through ``attention`` (bf16, causal, B 8, H 12,
    D 64) with the flash kernels and with ``mha_reference``, across S:
    the measurement the ``"auto"`` rule rests on."""
    from torchbooster_tpu_torch.ops.attention import attention

    gen = torch.Generator(device=DEV).manual_seed(1)
    rows = []
    for s_len in (256, 512, 1024, 2048, 4096):
        q, k, v, do = (torch.randn(8, s_len, 12, 64, generator=gen,
                                   device=DEV, dtype=torch.bfloat16)
                       for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()
        row = {"S": s_len}
        for impl in ("flash", "reference"):
            row[f"{impl}_ms"] = cuda_ms(
                lambda: attention(q, k, v, impl=impl).backward(do),
                iters=10, warmup=2)
        rows.append(row)
        log(f"auto crossover S={s_len}: flash fwd+bwd {row['flash_ms']:.3f}"
            f" ms, mha_reference {row['reference_ms']:.3f} ms (CUDA "
            f"events per call)")
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- serving
def gpt2_small():
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig()
    params = GPT.init(0, cfg, device="cuda")
    params["wte"]["table"] *= 4.0       # decisive head
    return params, cfg


def requests(cfg):
    from torchbooster_tpu_torch.serving import Request

    rs = np.random.RandomState(1)
    return [Request(prompt=rs.randint(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=N_NEW, request_id=f"r{i}")
            for i, n in enumerate(PROMPT_LENS)]


def reset_paged_counts() -> None:
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    pa.launches = 0
    pa.launches_by_route.update(dict.fromkeys(pa.launches_by_route, 0))


def serve(params, cfg, dtype: torch.dtype, reqs=None,
          n_pages: int = N_PAGES):
    """Serve ``reqs`` (the serving phases' trace, :func:`requests`, unless
    given) through ``ServingConfig(page_size=PS, n_pages=n_pages,
    max_slots=SLOTS).make(..., on_recompile="raise")`` and
    ``ContinuousBatcher.run``. Gates: the kernel backend; B4 launched, a
    whole number of times a decode step, every launch on the route the
    dtype plans; one decode shape; every stream its full length of
    in-vocabulary tokens; the engine plans the captured route
    (``step_route == "graph"``) and its decode step ran as replays of one
    CUDA graph. Returns the batcher, the requests, the run's metrics (with
    its peak memory and the step route), B4's launches and their
    routes."""
    from torchbooster_tpu_torch.config import ServingConfig
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    batcher = ServingConfig(page_size=PS, n_pages=n_pages,
                            max_slots=SLOTS).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    if batcher.engine.decode_backend != "kernel":
        raise AssertionError("the CUDA engine is not on the kernel backend")
    reqs = requests(cfg) if reqs is None else reqs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_paged_counts()
    metrics = batcher.run(reqs)
    torch.cuda.synchronize()
    launches = pa.launches
    by_route = dict(pa.launches_by_route)
    metrics["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if launches <= 0 or launches % cfg.n_layers:
        raise AssertionError(f"the serving run launched the kernel "
                             f"{launches} times, not {cfg.n_layers} a "
                             f"decode step")
    eng = batcher.engine
    if eng.decode_compiles != 1:
        raise AssertionError(f"decode step took "
                             f"{eng.decode_compiles} shapes")
    if eng.step_route != "graph" or len(eng._graphs) != 1 \
            or eng.graph_replays <= 0:
        raise AssertionError(f"serving ran route {eng.step_route!r} "
                             f"({eng.step_route_reason}), "
                             f"{len(eng._graphs)} graphs, "
                             f"{eng.graph_replays} replays")
    metrics["step_route"] = eng.step_route
    metrics["graph_replays"] = eng.graph_replays
    for r in reqs:
        if len(r.tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{r.request_id}: bad tokens {r.tokens}")
    # bf16 decode plans "sm90", fp32 "simt"; every launch on that route
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    if by_route[want] != launches:
        raise AssertionError(f"{dtype} serving: B4 launches by route "
                             f"{by_route}, not all {want!r}")
    return batcher, reqs, metrics, launches, by_route


def ms_per_token(request_s: list, n_new: int) -> float:
    """ms a new token (prefill included) over requests at batch 1 that
    took ``request_s`` seconds each."""
    return 1e3 * sum(request_s) / (len(request_s) * n_new)


def dense_tokens(params, cfg, reqs, dtype, n_new: int = N_NEW,
                 check: bool = True) -> tuple[list, dict]:
    """The serving phases' dense control: every request, at batch 1,
    through one ``jit_generate`` fn a call. Gate: ``fn._cache_size()``
    is the number of distinct prompt lengths. With ``check`` (once a
    phase at least): the first request again (a shape seen) leaves it
    there with the same ids, which plain ``generate`` gives too, token
    for token. Returns the streams and a record: the cached shapes, each
    request's seconds and the ms a new token."""
    from torchbooster_tpu_torch.models.gpt import generate, jit_generate

    fn = jit_generate(cfg, n_new=n_new, temperature=0.0, compute_dtype=dtype)
    out, request_s = [], []
    for r in reqs:
        ids = torch.as_tensor(r.prompt, device="cuda").long()[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = fn(params, ids)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
        out.append(full[0, len(r.prompt):].tolist())
    shapes = len({len(r.prompt) for r in reqs})
    if fn._cache_size() != shapes:
        raise AssertionError(f"dense control: {fn._cache_size()} cached "
                             f"shapes for {shapes} prompt lengths")
    record = {"dtype": str(dtype), "d_model": cfg.d_model,
              "n_layers": cfg.n_layers, "requests": len(reqs),
              "shapes": shapes, "n_new": n_new, "checked": check,
              "request_s": request_s,
              "ms_per_token": ms_per_token(request_s, n_new)}
    if not check:
        return out, record
    ids = torch.as_tensor(reqs[0].prompt, device="cuda").long()[None]
    again = fn(params, ids)[0, ids.shape[1]:].tolist()
    plain = generate(params, ids, cfg, n_new=n_new, temperature=0.0,
                     compute_dtype=dtype)[0, ids.shape[1]:].tolist()
    if fn._cache_size() != shapes or not again == plain == out[0]:
        raise AssertionError(f"dense control: a repeated shape gave "
                             f"{fn._cache_size()} shapes, or jit_generate "
                             f"{out[0]} / {again} vs generate {plain}")
    return out, record


def device_breakdown(batcher, cfg, reqs=None, decode_only: bool = False,
                     profiled: bool = True) -> dict:
    """Replay a trace (``reqs``, else :func:`requests`) under the profiler
    (CUDA activity only): device busy share of the wall time, B4's time,
    µs a call and share of device time, and the top kernels by their own
    device time. With ``decode_only`` the replay goes through the
    batcher's session API (``start_session``, ``submit``, ``step``,
    ``finish_session``), unprofiled while any prompt still waits or
    prefills, and only its decode-only tail is profiled, where every step
    is one decode step of ``cfg.n_layers`` B4 calls; its new tokens and
    tok/s are reported too. Busy time and B4's time are unions of device
    intervals, so B4's merge, which starts under its first pass
    (programmatic dependent launch), counts once; ``paged_kernel_sum_s``
    is B4's kernels' own times summed, the measure of the smoke's earlier
    revisions. The profiled run is not the one the tok/s figures of the
    serving phases come from. ``profiled=False`` times the same window by
    the host clock alone and reports no device figure."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    reqs = requests(cfg) if reqs is None else reqs
    if decode_only:
        batcher.start_session()
        for r in reqs:
            batcher.submit(r, arrival=0.0)
        while batcher.has_work:
            batcher.step()
            row = batcher.flight.tail(1)[0]
            if row["slots_filling"] == 0 and row["queue_depth"] == 0:
                break
    before, done = pa.launches, sum(len(r.tokens) for r in reqs)
    steps = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) if profiled \
            else nullcontext() as prof:
        t0 = time.perf_counter()
        if decode_only:
            while batcher.has_work:
                batcher.step()
                steps += 1
        else:
            m = batcher.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = pa.launches - before
    if decode_only:
        batcher.finish_session()
        if steps == 0 or calls != cfg.n_layers * steps:
            raise AssertionError(f"decode window: {calls} B4 calls over "
                                 f"{steps} decode-only steps, not "
                                 f"{cfg.n_layers} a step")
    else:
        steps = calls // cfg.n_layers
    tokens = sum(len(r.tokens) for r in reqs) - done
    out = {"decode_only": decode_only, "wall_s": wall, "b4_calls": calls,
           "steps": steps, "wall_ms_per_step": wall / max(steps, 1) * 1e3,
           "tokens": tokens, "tok_s": tokens / wall,
           "decode_s": None if decode_only else m["elapsed_s"]}
    if not profiled:
        return out
    spans = device_spans(prof)
    own: dict = {}
    for start, stop, name in spans:
        own[name] = own.get(name, 0.0) + (stop - start) / 1e6
    busy = union_us(spans) / 1e6
    paged_spans = [sp for sp in spans if "paged_" in sp[2]]
    paged = union_us(paged_spans) / 1e6
    return {**out, "device_busy_s": busy, "device_busy_share": busy / wall,
            "paged_kernel_s": paged,
            "paged_kernel_sum_s": sum(stop - start
                                      for start, stop, _ in paged_spans) / 1e6,
            "paged_share_of_device": paged / max(busy, 1e-12),
            "paged_us_per_call": paged / max(calls, 1) * 1e6,
            "device_ms_per_step": busy / max(steps, 1) * 1e3,
            "top": sorted(own.items(), key=lambda kv: -kv[1])[:8]}


def phase_serve(params, cfg, dtype, smi: str, report: dict, key: str,
                breakdown: bool = False):
    batcher, reqs, m, launches, by_route = serve(params, cfg, dtype)
    dense, dc = dense_tokens(params, cfg, reqs, dtype)
    match = [r.tokens == d for r, d in zip(reqs, dense)]
    n_steps = launches // cfg.n_layers
    report[key] = {"metrics": m, "launches": launches,
                   "launches_per_step": cfg.n_layers,
                   "launches_by_route": by_route,
                   "decode_steps": n_steps, "token_match": match,
                   "dense_control": dc, "card": smi}
    log(f"{key}: {sum(match)}/{len(match)} requests token-exact vs dense "
        f"generate; kernel launches {launches} ({cfg.n_layers} per decode "
        f"step), B4 by route {by_route}; step route {m['step_route']} "
        f"({m['graph_replays']} replays of one captured decode step); decode "
        f"{m['decode_tok_s']} tok/s, p50 TTFT "
        f"{m['ttft_p50_s']} s, peak mem {m['peak_mem_bytes'] / 2**20:.1f} "
        f"MiB [{smi}]")
    log(f"{key} dense control: jit_generate {dc['ms_per_token']:.3f} ms a "
        f"new token (prefill included; batch 1, {dc['requests']} requests, "
        f"{dc['n_new']} new each), {dc['shapes']} cached shapes, a repeated "
        f"shape and plain generate token-exact [{smi}]")
    if breakdown:
        b = report[key]["breakdown"] = device_breakdown(batcher, cfg)
        log(f"{key} profiled replay: wall {b['wall_s']:.3f} s, device busy "
            f"{b['device_busy_s']:.4f} s ({100 * b['device_busy_share']:.1f}"
            f"%), paged kernel {b['paged_kernel_s']:.5f} s "
            f"({100 * b['paged_share_of_device']:.1f}% of device time; its "
            f"kernels' own times summed {b['paged_kernel_sum_s']:.5f} s)")
    return match, launches, by_route


# ---------------------------------------------- speculative and fork serving
SPEC_NEW = 64          # new tokens a request in the speculative phases
DRAFT_LEN = 4          # S = 5 verify rows a slot
FORK_LENS = (256, 100)
FORK_NEW = 32
FORK_N = 4             # n = best_of


def repetitive_prompt(rs, n: int, vocab: int) -> np.ndarray:
    """``n`` tokens of a tiled random pattern of 3-8 tokens (the JAX
    suite's ``_repetitive_prompt``)."""
    pat = rs.randint(0, vocab, int(rs.randint(3, 9))).astype(np.int32)
    return np.resize(pat, n).astype(np.int32)


def ambiguous_prompt(params, cfg, dtype, rs, n: int) -> np.ndarray:
    """About ``n`` tokens of a tiled pattern ``R`` cut by one n-gram ``u v
    f`` seen twice: ``R + [u, v, f, t] + R + [u, v, f, w] + R + [u, v]``,
    where ``f`` and ``t`` are the dense model's own first two greedy picks
    after the whole prompt (found by iterating to a fixed point), and
    ``w`` another token. After the first token (``f``) the tree drafter
    sees two continuations of the suffix: ``w`` (the most recent, the
    primary branch) and ``t`` (the side branch), and the model picks
    ``t``: an ambiguous repetitive prompt whose side branch is right."""
    from torchbooster_tpu_torch.serving import Request

    vocab = cfg.vocab
    for _ in range(8):
        pat = rs.randint(0, vocab, int(rs.randint(3, 9))).astype(np.int32)
        seg = np.resize(pat, max((n - 10) // 3 // len(pat), 1) * len(pat))
        u, v, w = (int(x) for x in rs.randint(0, vocab, 3))
        f = t = v
        for _ in range(4):
            prompt = np.concatenate([seg, [u, v, f, t], seg, [u, v, f, w],
                                     seg, [u, v]]).astype(np.int32)
            got = dense_tokens(params, cfg, [Request(prompt=prompt)], dtype,
                               n_new=2, check=False)[0][0]
            if got == [f, t] and t != w:
                return prompt
            f, t = got
            if t == w:
                w = (w + 1) % vocab
    raise AssertionError("no ambiguous prompt reached a fixed point")


def spec_run(batcher, cfg, dtype, prompts, tree: bool) -> dict:
    """One run of the speculative ``batcher`` over ``prompts`` (SPEC_NEW
    new tokens each), with the exact B4 launch count and route checks."""
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import Request

    eng = batcher.engine
    steps0, slot_steps0 = eng.spec_steps, eng.spec_slot_steps
    side0 = eng.tree_side_accepts
    reqs = [Request(prompt=p, max_new_tokens=SPEC_NEW, request_id=f"s{i}")
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_paged_counts()
    m = batcher.run(reqs)
    torch.cuda.synchronize()
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    steps = eng.spec_steps - steps0
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    if launches != cfg.n_layers * steps or by_route[want] != launches:
        raise AssertionError(
            f"{dtype} speculative serving: {launches} B4 launches by route "
            f"{by_route} over {steps} verify steps, not {cfg.n_layers} a "
            f"step all on {want!r}")
    if eng.verify_compiles != 1 or eng.decode_compiles != 0:
        raise AssertionError(f"verify step took {eng.verify_compiles} "
                             f"shapes, decode {eng.decode_compiles}")
    if m["n_spec_accepted"] <= 0:
        raise AssertionError("no draft was accepted")
    side = eng.tree_side_accepts - side0
    if tree and side <= 0:
        raise AssertionError("no side branch of a tree was accepted")
    eng.tables.check()
    slot_steps = eng.spec_slot_steps - slot_steps0
    # tokens the verify steps delivered (the prefill's first tokens apart)
    delivered = m["new_tokens"] - len(prompts)
    return {"reqs": reqs, "metrics": m, "launches": launches,
            "by_route": by_route, "spec_steps": steps,
            "slot_steps": slot_steps, "side_accepts": side,
            "tokens_per_step": delivered / max(steps, 1),
            "tokens_per_slot_step": delivered / max(slot_steps, 1)}


def phase_serve_spec(params, cfg, dtype, smi: str, report: dict, key: str,
                     tree: bool = False) -> tuple[int, dict]:
    """A speculative serving phase built through ``ServingConfig.make``
    (``speculative: true, draft_len: 4[, spec_tree: true,
    spec_tree_width: 2]``): every request equal to the dense
    ``generate``; the plain decode engine (``serve_bf16``'s
    configuration) on the same prompts in turns with it (plain, spec,
    spec, plain), so their times compare within the call."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving import Request

    rs = np.random.RandomState(7)
    if tree:
        prompts = [ambiguous_prompt(params, cfg, dtype, rs, n)
                   for n in PROMPT_LENS]
    else:
        prompts = [repetitive_prompt(rs, n, cfg.vocab) for n in PROMPT_LENS]
    spec = ServingConfig(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                         speculative=True, draft_len=DRAFT_LEN,
                         spec_tree=tree, spec_tree_width=2).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    if spec.engine.decode_backend != "kernel" \
            or spec.engine.draft_len != DRAFT_LEN:
        raise AssertionError("the CUDA speculative engine is not on the "
                             "kernel backend with draft_len 4")
    plain = ServingConfig(page_size=PS, n_pages=N_PAGES,
                          max_slots=SLOTS).make(params, cfg,
                                                compute_dtype=dtype)
    dense = None
    runs, plain_runs = [], []
    for turn in ("plain", "spec", "spec", "plain"):
        if turn == "spec":
            run = spec_run(spec, cfg, dtype, prompts, tree)
            runs.append(run)
            got = [r.tokens for r in run["reqs"]]
        else:
            reqs = [Request(prompt=p, max_new_tokens=SPEC_NEW)
                    for p in prompts]
            plain_runs.append(plain.run(reqs))
            torch.cuda.synchronize()
            got = [r.tokens for r in reqs]
        if dense is None:
            dense, _ = dense_tokens(params, cfg, [Request(prompt=p)
                                                  for p in prompts],
                                    dtype, n_new=SPEC_NEW)
        match = [g == d for g, d in zip(got, dense)]
        if not all(match):
            raise AssertionError(f"{key} ({turn}): {match.count(False)} of "
                                 f"{len(match)} requests differ from dense "
                                 "generate")
    m = runs[-1]["metrics"]
    report[key] = {
        "runs": [{k: v for k, v in r.items() if k != "reqs"} for r in runs],
        "plain_runs": plain_runs, "token_match": match, "card": smi}
    tok_s = [r["metrics"]["decode_tok_s"] for r in runs]
    plain_tok_s = [pm["decode_tok_s"] for pm in plain_runs]
    log(f"{key}: {len(match)}/{len(match)} requests token-exact vs dense "
        f"generate in both runs; {runs[-1]['spec_steps']} verify steps a "
        f"run, B4 launches {runs[-1]['launches']} ({cfg.n_layers} a step), "
        f"by route {runs[-1]['by_route']}; accept rate "
        f"{m['spec_accept_rate']} ({m['n_spec_accepted']}/"
        f"{m['n_spec_proposed']}), "
        f"{runs[-1]['tokens_per_slot_step']:.2f} tokens a slot a verify "
        f"step, {runs[-1]['tokens_per_step']:.2f} a verify step, "
        + (f"{runs[-1]['side_accepts']} side-branch acceptances, " if tree
           else "")
        + f"decode {tok_s} tok/s, p50 TTFT "
        f"{[r['metrics']['ttft_p50_s'] for r in runs]} s; the plain decode "
        f"engine on the same prompts (before and after) {plain_tok_s} "
        f"tok/s, p50 TTFT {[pm['ttft_p50_s'] for pm in plain_runs]} s "
        f"[{smi}]")
    return (sum(r["launches"] for r in runs),
            {k: sum(r["by_route"][k] for r in runs)
             for k in runs[0]["by_route"]})


def phase_serve_fork(params, cfg, smi: str, report: dict) -> tuple[int, dict]:
    """``parallel_sampling``: two requests (FORK_LENS prompt tokens), n =
    best_of = 4, at bf16. Greedy: every branch equals dense ``generate``,
    full prompt pages are shared through several lanes and tail pages
    copied. Seeded sampling (temperature 0.8, top-k 50): each branch
    equals the engine's own run admitted alone with ``(seed, branch)``."""
    from torchbooster_tpu_torch.config import ServingConfig
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import (ContinuousBatcher, Request,
                                                best_completions)

    dtype = torch.bfloat16
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, cfg.vocab, n).astype(np.int32)
               for n in FORK_LENS]

    def family(batcher) -> tuple[list, int]:
        reqs = [Request(prompt=p, max_new_tokens=FORK_NEW, n=FORK_N,
                        best_of=FORK_N, seed=100 + i, request_id=f"f{i}")
                for i, p in enumerate(prompts)]
        batcher.start_session()
        for r in reqs:
            batcher.submit(r)
        max_lanes = 0
        while any(r.branches is None or any(b.finished_at is None
                                            for b in r.branches)
                  for r in reqs):
            batcher.step()
            refs = batcher.engine.tables.kernel_args()["work_refs"]
            max_lanes = max(max_lanes, int((refs >= 0).sum(axis=1).max()))
        batcher.finish_session()
        return reqs, max_lanes

    conf = dict(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                parallel_sampling=True)
    greedy = ServingConfig(**conf).make(params, cfg, compute_dtype=dtype,
                                        on_recompile="raise")
    eng = greedy.engine
    torch.cuda.synchronize()
    reset_paged_counts()
    reqs, max_lanes = family(greedy)
    torch.cuda.synchronize()
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    dense, _ = dense_tokens(params, cfg, reqs, dtype, n_new=FORK_NEW)
    greedy_match = [b.tokens == d for r, d in zip(reqs, dense)
                    for b in r.branches]
    if not all(greedy_match):
        raise AssertionError(f"serve_fork: {greedy_match.count(False)} greedy "
                             "branches differ from dense generate")
    if eng.forks != len(reqs) or eng.fork_pages <= 0 or eng.cow_copies <= 0:
        raise AssertionError(f"serve_fork: forks {eng.forks}, fork pages "
                             f"{eng.fork_pages}, tail copies "
                             f"{eng.cow_copies}")
    if max_lanes < FORK_N:
        raise AssertionError(f"serve_fork: shared pages were read through "
                             f"at most {max_lanes} lanes")
    if launches <= 0 or launches % cfg.n_layers or by_route["sm90"] \
            != launches or eng.decode_compiles != 1:
        raise AssertionError(f"serve_fork: B4 launches {launches} by route "
                             f"{by_route}, {eng.decode_compiles} decode "
                             "shapes")
    eng.tables.check()
    sampled = ServingConfig(**conf, temperature=0.8, top_k=50).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    reqs_s, _ = family(sampled)
    seeded_match = []
    for r in reqs_s:
        for b in r.branches:
            ind = Request(prompt=r.prompt, max_new_tokens=FORK_NEW,
                          seed=r.seed)
            ind.branch = b.branch
            ContinuousBatcher(sampled.engine).run([ind])
            seeded_match.append(ind.tokens == b.tokens)
    if not all(seeded_match):
        raise AssertionError(f"serve_fork: {seeded_match.count(False)} seeded "
                             "branches differ from their independent runs")
    distinct = [len({tuple(b.tokens) for b in r.branches}) for r in reqs_s]
    best = [[b.branch for b in best_completions(r)] for r in reqs_s]
    report["serve_fork"] = {
        "launches": launches, "launches_by_route": by_route,
        "forks": eng.forks, "fork_pages": eng.fork_pages,
        "cow_copies": eng.cow_copies, "max_lanes": max_lanes,
        "greedy_match": greedy_match, "seeded_match": seeded_match,
        "distinct_sampled_branches": distinct, "best_of_order": best,
        "card": smi}
    log(f"serve_fork: {sum(greedy_match)}/{len(greedy_match)} greedy branches "
        f"token-exact vs dense generate; {sum(seeded_match)}/"
        f"{len(seeded_match)} seeded branches (temperature 0.8, top-k 50) "
        f"equal their independent (seed, branch) runs, {distinct} distinct "
        f"streams a request, best_of order {best}; forks {eng.forks}, pages "
        f"shared {eng.fork_pages}, tail copies {eng.cow_copies}, shared "
        f"pages read through up to {max_lanes} lanes; B4 launches "
        f"{launches} by route {by_route} [{smi}]")
    return launches, by_route


# ------------------------------- structured, quantized and LoRA serving
STRUCT_EOS = 50256     # GPT-2's end-of-text id: outside the byte alphabet
STRUCT_LENS = (64, 100, 150, 200, 256)
RIDER_LENS = (64, 300, 512)
STRUCT_N = 4           # branches of the parallel-sampling request
WQ_GROUP = 64          # int4 scale group
LORA_RANK, LORA_LIVE, LORA_STD = 8, 4, 0.25
LORA_ADAPTERS = 6


def structured_trace(cfg, constrained: bool = True) -> list:
    """The five ``SCHEMA_LIBRARY`` schemas (``max_new_tokens`` their
    budget, EOS 50256) and three unconstrained riders (N_NEW tokens).
    ``constrained=False`` sends the schema requests' prompts unconstrained
    with the same token budget (the structured-off yardstick)."""
    from torchbooster_tpu_torch.serving import Request
    from torchbooster_tpu_torch.serving.structured import (
        SCHEMA_LIBRARY, library_response_format, schema_budget)

    rs = np.random.RandomState(13)
    reqs = []
    for i, (sid, n) in enumerate(zip(sorted(SCHEMA_LIBRARY), STRUCT_LENS)):
        prompt = rs.randint(0, cfg.vocab, n).astype(np.int32)
        kw = (dict(response_format=library_response_format(sid),
                   eos_id=STRUCT_EOS) if constrained else {})
        reqs.append(Request(prompt=prompt, max_new_tokens=schema_budget(sid),
                            request_id=f"{sid}", **kw))
    for i, n in enumerate(RIDER_LENS):
        reqs.append(Request(prompt=rs.randint(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=N_NEW, request_id=f"rider{i}"))
    return reqs


def schema_text(tokens: list) -> str:
    toks = tokens[:-1] if tokens and tokens[-1] == STRUCT_EOS else tokens
    return "".join(chr(int(t)) for t in toks if int(t) < 256)


def paged_us_per_call(run) -> float:
    """B4's device µs a call over one profiled serving run: the union of
    its kernels' intervals over the run, over its launches."""
    from torch.profiler import ProfilerActivity, profile
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    reset_paged_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = [sp for sp in device_spans(prof) if "paged_" in sp[2]]
    return union_us(spans) / max(pa.launches, 1)


def phase_serve_structured(params, cfg, smi: str, report: dict
                           ) -> tuple[int, dict]:
    """``structured: {enabled: true}`` at bf16 on the five library
    schemas and three riders: every constrained completion conforms and
    stops on EOS, every rider equals the dense ``generate``, one decode
    shape, every B4 launch on ``"sm90"``. Then ``speculative: true,
    draft_len: 4`` on the same trace (constrained streams equal the
    plain structured run's, one verify shape, 12 B4 launches a verify
    step) and one constrained ``n = 4`` request on a parallel-sampling
    engine (every branch conforms)."""
    from torchbooster_tpu_torch.config import ServingConfig, StructuredConfig
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import Request
    from torchbooster_tpu_torch.serving.structured import (
        SCHEMA_LIBRARY, conforms, library_response_format, schema_budget)

    dtype = torch.bfloat16
    geo = dict(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
               structured=StructuredConfig(enabled=True))
    batcher = ServingConfig(**geo).make(params, cfg, compute_dtype=dtype,
                                        on_recompile="raise")
    eng = batcher.engine
    if not eng.structured or eng.decode_backend != "kernel":
        raise AssertionError("the structured engine is not on the kernel "
                             "backend")
    compile_ms = {}
    for sid in sorted(SCHEMA_LIBRARY):
        t = time.perf_counter()
        dfa = eng.structured_compile(library_response_format(sid))
        compile_ms[sid] = {"ms": 1e3 * (time.perf_counter() - t),
                           "states": dfa.n_states}
    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)

    def counted_run(b, reqs):
        nonlocal launches
        torch.cuda.synchronize()
        reset_paged_counts()
        m = b.run(reqs)
        torch.cuda.synchronize()
        launches += pa.launches
        for r, n in pa.launches_by_route.items():
            by_route[r] += n
        return m, pa.launches, dict(pa.launches_by_route)

    def check_constrained(reqs, label):
        for r in reqs:
            if r.response_format is None:
                continue
            if r.finish_reason != "stop" or r.tokens[-1] != STRUCT_EOS \
                    or not conforms(r.response_format, schema_text(r.tokens)):
                raise AssertionError(f"{label} {r.request_id}: "
                                     f"{schema_text(r.tokens)!r} "
                                     f"({r.finish_reason}) does not conform")

    torch.cuda.reset_peak_memory_stats()
    reqs = structured_trace(cfg)
    m, n, routes = counted_run(batcher, reqs)
    # the run's masked share of the vocabulary, unrounded
    masked_frac = eng.structured_masked_sum / max(
        eng.structured_masked_rows, 1)
    check_constrained(reqs, "serve_structured")
    if n <= 0 or routes["sm90"] != n or eng.decode_compiles != 1:
        raise AssertionError(f"serve_structured: B4 {n} by route {routes}, "
                             f"{eng.decode_compiles} decode shapes")
    riders = [r for r in reqs if r.response_format is None]
    dense, _ = dense_tokens(params, cfg, riders, dtype)
    rider_match = [r.tokens == d for r, d in zip(riders, dense)]
    if not all(rider_match):
        raise AssertionError(f"serve_structured: riders {rider_match} vs "
                             "dense generate")
    eng.tables.check()
    # the same prompts with structured off (the schema requests sent
    # unconstrained with the same budgets), in turns with it
    plain = ServingConfig(page_size=PS, n_pages=N_PAGES,
                          max_slots=SLOTS).make(params, cfg,
                                                compute_dtype=dtype)
    tok_s_on, tok_s_off = [m["decode_tok_s"]], []
    for turn in ("off", "on", "off"):
        if turn == "on":
            tok_s_on.append(counted_run(batcher, structured_trace(cfg))[0]
                            ["decode_tok_s"])
        else:
            tok_s_off.append(plain.run(structured_trace(
                cfg, constrained=False))["decode_tok_s"])
    want = {r.request_id: r.tokens for r in reqs}
    # speculative verify over the same trace
    spec = ServingConfig(**geo, speculative=True, draft_len=DRAFT_LEN).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    seng = spec.engine
    spec_reqs = structured_trace(cfg)
    sm, sn, sroutes = counted_run(spec, spec_reqs)
    check_constrained(spec_reqs, "serve_structured (speculative)")
    spec_match = {r.request_id: r.tokens == want[r.request_id]
                  for r in spec_reqs}
    if not all(spec_match[r.request_id] for r in spec_reqs
               if r.response_format is not None):
        raise AssertionError(f"serve_structured: speculative streams "
                             f"{spec_match} vs the plain structured run")
    if seng.verify_compiles != 1 or seng.decode_compiles != 0 \
            or sn != cfg.n_layers * seng.spec_steps \
            or sroutes["sm90"] != sn:
        raise AssertionError(
            f"serve_structured (speculative): {sn} B4 launches by route "
            f"{sroutes} over {seng.spec_steps} verify steps, "
            f"{seng.verify_compiles} verify shapes")
    seng.tables.check()
    # B4's device time a call inside the serving trace: decode (S = 1)
    # and verify (S = 5), each over one profiled replay
    us_s1 = paged_us_per_call(lambda: batcher.run(structured_trace(cfg)))
    us_s5 = paged_us_per_call(lambda: spec.run(structured_trace(cfg)))
    # one constrained n = 4 request on a parallel-sampling engine
    par = ServingConfig(**geo, parallel_sampling=True, temperature=0.8,
                        top_k=50).make(params, cfg, compute_dtype=dtype,
                                       on_recompile="raise")
    rf = library_response_format("verdict")
    fam = Request(prompt=np.random.RandomState(17).randint(
        0, cfg.vocab, 100).astype(np.int32),
        max_new_tokens=schema_budget("verdict"), eos_id=STRUCT_EOS,
        response_format=rf, n=STRUCT_N, best_of=STRUCT_N, seed=5)
    counted_run(par, [fam])
    check_constrained(fam.branches, "serve_structured (n = 4)")
    if len(fam.branches) != STRUCT_N or par.engine.decode_compiles != 1:
        raise AssertionError("serve_structured: the n = 4 family did not "
                             "fork or took more than one decode shape")
    par.engine.tables.check()
    texts = {r.request_id: schema_text(r.tokens) for r in reqs
             if r.response_format is not None}
    report["serve_structured"] = {
        "compile_ms": compile_ms, "metrics": m, "spec_metrics": sm,
        "masked_frac": masked_frac,
        "launches": launches, "launches_by_route": by_route,
        "rider_match": rider_match, "spec_match": spec_match,
        "texts": texts,
        "branch_texts": [schema_text(b.tokens) for b in fam.branches],
        "decode_tok_s_on": tok_s_on, "decode_tok_s_off": tok_s_off,
        "spec_decode_tok_s": sm["decode_tok_s"],
        "paged_us_per_call_s1": us_s1, "paged_us_per_call_s5": us_s5,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
    log(f"serve_structured: schema compile at vocab {cfg.vocab} "
        + ", ".join(f"{k} {v['ms']:.1f} ms ({v['states']} states)"
                    for k, v in compile_ms.items())
        + f"; 5/5 constrained completions conform and stop on EOS "
        f"{texts}; riders {sum(rider_match)}/{len(rider_match)} token-exact "
        f"vs dense generate; masked share {masked_frac!r}; "
        f"decode tok/s structured on {tok_s_on}, off {tok_s_off} (same "
        f"prompts and budgets, in turns); speculative (draft_len 4): "
        f"constrained streams equal the plain run's, "
        f"{seng.spec_steps} verify steps, B4 {sn} ({cfg.n_layers} a step) "
        f"by route {sroutes}, accept rate {sm['spec_accept_rate']}, decode "
        f"{sm['decode_tok_s']} tok/s; n = {STRUCT_N}: "
        f"{len(fam.branches)}/{STRUCT_N} branches conform "
        f"{[schema_text(b.tokens) for b in fam.branches]}; B4 device "
        f"{us_s1:.2f} µs a call at S = 1 and {us_s5:.2f} at S = 5 in the "
        f"profiled replays; B4 launches {launches} by route {by_route} "
        f"[{smi}]")
    return launches, by_route


def phase_serve_wq(params, cfg, smi: str, report: dict
                   ) -> tuple[int, dict, int]:
    """``weights: {dtype: int8}`` and ``{dtype: int4, group_size: 64}``
    at fp32 and bf16 on the serving trace: each quantized engine equals
    the dense ``generate`` over the same quantized tree, int8 at fp32
    equals the full-precision engine 8/8, one decode shape an arm; the
    int8-weights + ``cache_dtype: int8`` arm at bf16 puts every B4 launch
    on ``"sm90"`` over the int8 pool and equals the dense ``generate``
    with ``cache_dtype="int8"``. Returns B4's launches, by route, and
    the int8-pool launches."""
    from torchbooster_tpu_torch.config import ServingConfig, WeightsConfig
    from torchbooster_tpu_torch.models.gpt import cast_params, generate
    from torchbooster_tpu_torch.models.quant import (quantize_params,
                                                     weight_stream_bytes)
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    arms, streams = {}, {}
    int8_pool = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = "fp32" if dtype == torch.float32 else "bf16"
        want = "simt" if dtype == torch.float32 else "sm90"
        for wname, kv in (("full", ""), ("int8", ""), ("int4", ""),
                          ("int8", "int8")):
            if kv and dtype == torch.float32:
                continue
            weights = WeightsConfig(dtype="bf16" if wname == "full"
                                    else wname, group_size=WQ_GROUP)
            batcher = ServingConfig(
                page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                cache_dtype=kv, weights=weights).make(
                params, cfg, compute_dtype=dtype, on_recompile="raise")
            reqs = requests(cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_paged_counts()
            m = batcher.run(reqs)
            torch.cuda.synchronize()
            n, routes = pa.launches, dict(pa.launches_by_route)
            peak = torch.cuda.max_memory_allocated()
            launches += n
            for r, c in routes.items():
                by_route[r] += c
            key = f"{dname}_{wname}" + (f"_kv{kv}" if kv else "")
            if n <= 0 or routes[want] != n \
                    or batcher.engine.decode_compiles != 1:
                raise AssertionError(f"serve_wq {key}: B4 {n} by route "
                                     f"{routes}, "
                                     f"{batcher.engine.decode_compiles} "
                                     "decode shapes")
            if kv:
                int8_pool += n
            tree = batcher.engine.params if wname == "full" else \
                quantize_params(params, wname, group_size=WQ_GROUP)
            dense = []
            for r in reqs:
                ids = torch.as_tensor(r.prompt, device="cuda").long()[None]
                dense.append(generate(
                    tree, ids, cfg, n_new=N_NEW, temperature=0.0,
                    compute_dtype=dtype, cache_dtype=kv or None)[
                        0, len(r.prompt):].tolist())
            match = [r.tokens == d for r, d in zip(reqs, dense)]
            if not all(match):
                raise AssertionError(f"serve_wq {key}: {match} vs dense "
                                     "generate over the same tree")
            streams[key] = [r.tokens for r in reqs]
            arms[key] = {"decode_tok_s": m["decode_tok_s"],
                         "ttft_p50_s": m["ttft_p50_s"], "peak_mem_bytes": peak,
                         "launches": n, "launches_by_route": routes,
                         "dense_match": match}
            batcher.engine.tables.check()
            del batcher
            torch.cuda.empty_cache()
    vs_full = {k: sum(a == b for a, b in zip(v, streams[
        "fp32_full" if k.startswith("fp32") else "bf16_full"]))
        for k, v in streams.items() if "full" not in k}
    if vs_full["fp32_int8"] != len(PROMPT_LENS):
        raise AssertionError(f"serve_wq: int8 matches the full-precision "
                             f"engine on {vs_full['fp32_int8']}/8 requests "
                             "at fp32")
    stream_bytes = {"bf16": weight_stream_bytes(cast_params(
        params, torch.bfloat16))}
    for w in ("int8", "int4"):
        stream_bytes[w] = weight_stream_bytes(quantize_params(
            params, w, group_size=WQ_GROUP))
    report["serve_wq"] = {"arms": arms, "match_vs_full": vs_full,
                          "weight_stream_bytes": stream_bytes,
                          "launches": launches, "launches_by_route": by_route,
                          "int8_pool_launches": int8_pool, "card": smi}
    log(f"serve_wq: every arm token-exact vs dense generate over its own "
        f"tree (8/8), int8 8/8 vs the full-precision engine at fp32; "
        f"matches vs the full-precision stream {vs_full}; weight stream "
        f"bytes {stream_bytes}; decode tok/s "
        + ", ".join(f"{k} {a['decode_tok_s']}" for k, a in arms.items())
        + "; peak MiB "
        + ", ".join(f"{k} {a['peak_mem_bytes'] / 2**20:.1f}"
                    for k, a in arms.items())
        + f"; B4 launches {launches} by route {by_route}, {int8_pool} of "
        f"them over the int8 pool on \"sm90\" [{smi}]")
    return launches, by_route, int8_pool


def merged_params(params: dict, adapter: dict) -> dict:
    """The dense model an adapter defines: ``W_qkv + A_q B_q`` and
    ``W_proj + A_p B_p`` per layer (fp32)."""
    def t(a):
        return torch.as_tensor(a, device="cuda")

    blocks = dict(params["blocks"])
    for name, a, b in (("attn_qkv", "a_qkv", "b_qkv"),
                       ("attn_proj", "a_proj", "b_proj")):
        blocks[name] = {**blocks[name], "kernel": blocks[name]["kernel"]
                        + t(adapter[a]) @ t(adapter[b])}
    return {**params, "blocks": blocks}


def phase_serve_lora(params, cfg, smi: str, report: dict
                     ) -> tuple[int, dict]:
    """``adapters: {rank: 8, max_live: 4}`` with six adapters on eight
    requests (two base): seating waits on lanes and evicts. Base riders
    equal the LoRA-off engine at bf16 and fp32, each adapter request at
    fp32 equals the dense ``generate`` over its merged weights; one
    decode shape, one lane-writer shape, no pin left, tables consistent,
    B4 on its planned route."""
    from torchbooster_tpu_torch.config import AdaptersConfig, ServingConfig
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import Request, random_adapter

    adapters = {f"a{i}": random_adapter(i, cfg, LORA_RANK, std=LORA_STD)
                for i in range(1, LORA_ADAPTERS + 1)}
    names = ["", "a1", "a2", "a3", "", "a4", "a5", "a6"]
    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = "fp32" if dtype == torch.float32 else "bf16"
        want = "simt" if dtype == torch.float32 else "sm90"
        conf = dict(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS)
        lora = ServingConfig(**conf, adapters=AdaptersConfig(
            rank=LORA_RANK, max_live=LORA_LIVE)).make(
            params, cfg, compute_dtype=dtype, on_recompile="raise")
        eng = lora.engine
        for name, w in adapters.items():
            eng.adapters.register(name, w)
        reqs = [Request(prompt=r.prompt, max_new_tokens=N_NEW, adapter=a,
                        request_id=f"{a or 'base'}{i}")
                for i, (r, a) in enumerate(zip(requests(cfg), names))]
        torch.cuda.synchronize()
        reset_paged_counts()
        m = lora.run(reqs)
        torch.cuda.synchronize()
        n, routes = pa.launches, dict(pa.launches_by_route)
        launches += n
        for r, c in routes.items():
            by_route[r] += c
        if n <= 0 or routes[want] != n:
            raise AssertionError(f"serve_lora {dname}: B4 {n} by route "
                                 f"{routes}")
        if eng.decode_compiles != 1 or eng.lora_load_compiles != 1 \
                or eng.adapters.pinned_count != 0 \
                or eng.adapters.evictions <= 0:
            raise AssertionError(
                f"serve_lora {dname}: {eng.decode_compiles} decode shapes, "
                f"{eng.lora_load_compiles} writer shapes, "
                f"{eng.adapters.pinned_count} pins left, "
                f"{eng.adapters.evictions} evictions")
        eng.tables.check()
        off = ServingConfig(**conf).make(params, cfg, compute_dtype=dtype,
                                         on_recompile="raise")
        base = [Request(prompt=r.prompt, max_new_tokens=N_NEW)
                for r in reqs]
        m_off = off.run(base)
        base_match = [r.tokens == b.tokens for r, b in zip(reqs, base)
                      if not r.adapter]
        steered = [r.tokens != b.tokens for r, b in zip(reqs, base)
                   if r.adapter]
        if not all(base_match):
            raise AssertionError(f"serve_lora {dname}: base riders "
                                 f"{base_match} vs the LoRA-off engine")
        if not all(steered):
            raise AssertionError(f"serve_lora {dname}: adapters {steered} "
                                 "did not change their streams")
        merged_match = None
        if dtype == torch.float32:
            merged_match = []
            for r in reqs:
                if not r.adapter:
                    continue
                dense = dense_tokens(merged_params(params, adapters[
                    r.adapter]), cfg, [r], dtype,
                    check=not merged_match)[0][0]
                merged_match.append(r.tokens == dense)
            if not all(merged_match):
                raise AssertionError(f"serve_lora fp32: adapters "
                                     f"{merged_match} vs dense generate "
                                     "over the merged weights")
        out[dname] = {"metrics": m, "off_decode_tok_s": m_off["decode_tok_s"],
                      "launches": n, "launches_by_route": routes,
                      "base_match": base_match, "steered": steered,
                      "merged_match": merged_match,
                      "registry": eng.adapters.debug()}
        log(f"serve_lora {dname}: base riders {sum(base_match)}/"
            f"{len(base_match)} equal the LoRA-off engine, "
            f"{sum(steered)}/{len(steered)} adapters steer"
            + (f", {sum(merged_match)}/{len(merged_match)} equal dense "
               "generate over merged weights" if merged_match else "")
            + f"; loads {m['n_adapter_loads']}, evictions "
            f"{m['n_adapter_evictions']}, hits {m['n_adapter_hits']}, per "
            f"adapter {m['adapters']}; decode {m['decode_tok_s']} tok/s with "
            f"LoRA, {m_off['decode_tok_s']} without (same prompts); B4 {n} "
            f"by route {routes} [{smi}]")
        del lora, off
        torch.cuda.empty_cache()
    report["serve_lora"] = {**out, "launches": launches,
                            "launches_by_route": by_route, "card": smi}
    return launches, by_route


# --------------------------------------- host spill tier, disaggregation
SPILL_PREFIX_PAGES = 8     # the probe's shared prefix, in 64-token pages
SPILL_TAIL = 16            # its own tail tokens
SPILL_REPEATS = 5          # probes a tier, each with its own prefix
SPILL_N_PAGES = 33         # a pool the churn overflows (32 usable pages)
SPILL_BUDGET_MB = 256.0
DISAGG_LENS = (640, 64, 800, 96, 128, 960, 160, 192)   # 3 long, 5 short
DISAGG_MIN_PAGES = 4


def n_params_of(params) -> int:
    from torchbooster_tpu_torch.utils import tree_leaves

    return sum(int(p.numel()) for p in tree_leaves(params))


def warm_up(batcher, cfg) -> None:
    """One short request before a timed run, so that first-use costs
    (cuBLAS handles, the kernels' build) fall outside it."""
    from torchbooster_tpu_torch.serving import Request

    prompt = np.random.RandomState(99).randint(0, cfg.vocab, 2 * PS + 5)
    batcher.run([Request(prompt=prompt.astype(np.int32), max_new_tokens=4)])
    torch.cuda.synchronize()


def spill_probe(eng, prompt, n_new: int) -> dict:
    """One request driven through the engine alone: seat, promote (timed
    and synchronized on its own), prefill to the first token (the TTFT:
    seat to first token on the host), then decode to ``n_new``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot = eng.admit_begin(prompt)
    if slot is None:
        raise AssertionError("serve_spill: the probe did not seat")
    b0 = eng.promoted_bytes
    tp = time.perf_counter()
    n_prom = eng.issue_promotions()
    torch.cuda.synchronize()
    prom_s = time.perf_counter() - tp
    while True:
        done = eng.prefill_step()
        if done is not None and done[0] == slot:
            break
    ttft = time.perf_counter() - t0
    toks = [done[1]]
    for _ in range(n_new - 1):
        if eng.grow_slots():
            raise AssertionError("serve_spill: the probe starved for pages")
        toks.append(int(eng.step()[slot]))
    eng.retire(slot)
    return {"tokens": toks, "ttft_s": ttft, "promoted": n_prom,
            "promote_s": prom_s, "promoted_bytes": eng.promoted_bytes - b0}


def spill_churn(batcher, rs, keys, cfg) -> int:
    """Serve rounds of eight distinct 2-4-page prompts until every probe
    key has left the HBM index for the host pool; returns the rounds."""
    from torchbooster_tpu_torch.serving import Request

    tables = batcher.engine.tables
    for rounds in range(1, 41):
        batcher.run([Request(prompt=rs.randint(0, cfg.vocab, int(
            rs.randint(2, 5)) * PS - int(rs.randint(0, 8))).astype(np.int32),
            max_new_tokens=2) for _ in range(SLOTS)])
        if all(k in tables.host_pool and k not in tables._index
               for k in keys):
            return rounds
    raise AssertionError("serve_spill: churn never demoted the probe prefix")


def phase_serve_spill(params, cfg, smi: str, report: dict
                      ) -> tuple[int, dict, int]:
    """The host spill tier at GPT-2 small width: per arm (bf16 over an
    int8 pool, B4 on ``"sm90"``; fp32 over a wide pool, ``"simt"``), five
    probes of an 8-page prefix + 16 tokens, each served cold, as an HBM
    prefix hit and, after churn has demoted its 8 pages, as a host hit
    whose 8 pages promote through 4-lane staging (two groups back to
    back). Every stream equals the dense ``generate`` at the pool's cache
    dtype; one decode and one promotion shape; promoted bytes equal
    ``promotion_traffic``; tables consistent. Returns B4's launches, by
    route, and those over the int8 pool."""
    from torchbooster_tpu_torch.comms.accounting import (promotion_traffic,
                                                         spill_breakeven)
    from torchbooster_tpu_torch.config import HostSpillConfig, ServingConfig
    from torchbooster_tpu_torch.models.gpt import generate
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    int8_pool, arms = 0, {}
    n_par = n_params_of(params)
    for dname, dtype, kv, want in (("bf16_int8", torch.bfloat16, "int8",
                                    "sm90"),
                                   ("fp32_wide", torch.float32, "", "simt")):
        batcher = ServingConfig(
            page_size=PS, n_pages=SPILL_N_PAGES, max_slots=SLOTS,
            cache_dtype=kv, prefix_cache=True,
            host_spill=HostSpillConfig(enabled=True,
                                       budget_mb=SPILL_BUDGET_MB)).make(
            params, cfg, compute_dtype=dtype, on_recompile="raise")
        eng = batcher.engine
        rs = np.random.RandomState(7)
        warm_up(batcher, cfg)
        probes = [np.concatenate([
            rs.randint(0, cfg.vocab, SPILL_PREFIX_PAGES * PS),
            rs.randint(0, cfg.vocab, SPILL_TAIL)]).astype(np.int32)
            for _ in range(SPILL_REPEATS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_paged_counts()
        runs = {"cold": [], "hbm": [], "host": []}
        rounds = []
        for probe in probes:
            keys = [probe[:(i + 1) * PS].tobytes()
                    for i in range(SPILL_PREFIX_PAGES)]
            runs["cold"].append(spill_probe(eng, probe, N_NEW))
            runs["hbm"].append(spill_probe(eng, probe, N_NEW))
            rounds.append(spill_churn(batcher, rs, keys, cfg))
            runs["host"].append(spill_probe(eng, probe, N_NEW))
        torch.cuda.synchronize()
        n, routes = pa.launches, dict(pa.launches_by_route)
        peak = torch.cuda.max_memory_allocated()
        launches += n
        for r, c in routes.items():
            by_route[r] += c
        if kv:
            int8_pool += n
        if n <= 0 or routes[want] != n:
            raise AssertionError(f"serve_spill {dname}: B4 {n} by route "
                                 f"{routes}, not all {want!r}")
        dense = []
        for probe in probes:
            ids = torch.as_tensor(probe, device="cuda").long()[None]
            dense.append(generate(params, ids, cfg, n_new=N_NEW,
                                  temperature=0.0, compute_dtype=dtype,
                                  cache_dtype=kv or None)[
                0, len(probe):].tolist())
        match = {tier: [r["tokens"] == d for r, d in zip(rs_, dense)]
                 for tier, rs_ in runs.items()}
        if not all(all(v) for v in match.values()):
            raise AssertionError(f"serve_spill {dname}: streams vs dense "
                                 f"generate {match}")
        if any(r["promoted"] != SPILL_PREFIX_PAGES for r in runs["host"]) \
                or any(r["promoted"] for r in runs["cold"] + runs["hbm"]):
            raise AssertionError(f"serve_spill {dname}: promoted pages "
                                 + str({t: [r["promoted"] for r in v]
                                        for t, v in runs.items()}))
        lanes = eng._promote_lanes
        groups = -(-SPILL_PREFIX_PAGES // lanes)
        if groups < 2:
            raise AssertionError(f"serve_spill {dname}: {lanes} lanes take "
                                 "the probe's pages in one group")
        model = promotion_traffic(eng.promotions, page_size=PS,
                                  kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                                  n_layers=cfg.n_layers)
        if eng.promoted_bytes != model["total_bytes"]:
            raise AssertionError(f"serve_spill {dname}: promoted "
                                 f"{eng.promoted_bytes} bytes, model "
                                 f"{model['total_bytes']}")
        if eng.promote_compiles != 1 or eng.decode_compiles != 1:
            raise AssertionError(f"serve_spill {dname}: "
                                 f"{eng.promote_compiles} promotion and "
                                 f"{eng.decode_compiles} decode shapes")
        eng.tables.check()
        gbs = [r["promoted_bytes"] / r["promote_s"] / 1e9
               for r in runs["host"]]
        flops = (BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS) / 1e12
        be = spill_breakeven(n_params=n_par, page_size=PS,
                             per_page_bytes=model["per_page_bytes"],
                             h2d_gbs=float(np.median(gbs)),
                             flops_tps=flops, n_pages=SPILL_PREFIX_PAGES)
        ttft = {t: [r["ttft_s"] for r in v] for t, v in runs.items()}
        stats = eng.debug_stats()
        arms[dname] = {
            "ttft_s": ttft, "promote_s": [r["promote_s"] for r in runs["host"]],
            "promotion_gbs": gbs, "lanes": lanes, "groups_per_seat": groups,
            "churn_rounds": rounds, "spills": eng.spills,
            "promotions": eng.promotions, "host_hit_pages": eng.host_hit_pages,
            "promoted_bytes": eng.promoted_bytes,
            "per_page_bytes": model["per_page_bytes"],
            "host_bytes_used": stats["host_bytes_used"],
            "host_evictions": stats["host_evictions"], "peak_mem_bytes": peak,
            "breakeven": be, "launches": n, "launches_by_route": routes,
            "match": match}
        med = {t: float(np.median(v)) * 1e3 for t, v in ttft.items()}
        log(f"serve_spill {dname}: 5 probes x cold/HBM/host token-exact vs "
            f"dense generate (cache {kv or 'wide'}); TTFT ms median cold "
            f"{med['cold']:.2f}, HBM hit {med['hbm']:.2f}, host hit "
            f"{med['host']:.2f} (each "
            + ", ".join(f"{t} " + "/".join(f"{x * 1e3:.2f}" for x in v)
                        for t, v in ttft.items())
            + f"); promotion {SPILL_PREFIX_PAGES} pages in {groups} groups of "
            f"{lanes} lanes, GB/s " + "/".join(f"{g:.2f}" for g in gbs)
            + f"; spills {eng.spills}, promotions {eng.promotions}, host "
            f"hits {eng.host_hit_pages}, promoted bytes {eng.promoted_bytes} "
            f"== promotion_traffic; breakeven {be['breakeven_pages']:.3g} "
            f"pages (host {be['host_s_per_page'] * 1e6:.1f} us/page, "
            f"recompute {be['recompute_s_per_page'] * 1e6:.1f} us/page at "
            f"{flops:.0f} TFLOP/s); peak {peak / 2**20:.1f} MiB; one decode "
            f"and one promotion shape; B4 {n} by route {routes} [{smi}]")
        del batcher, eng
        torch.cuda.empty_cache()
    report["serve_spill"] = {**arms, "launches": launches,
                             "launches_by_route": by_route,
                             "int8_pool_launches": int8_pool, "card": smi}
    return launches, by_route, int8_pool


def pump(srv, reqs) -> tuple[dict, float]:
    """Drive a batcher or a ``DisaggPair`` over requests arriving at 0
    until it drains; returns the metrics and the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.start_session()
    for r in reqs:
        srv.submit(r, arrival=0.0)
    deadline = t0 + 300
    while srv.has_work:
        if time.perf_counter() > deadline:
            raise AssertionError("the serving pump did not drain")
        srv.step()
        decode = getattr(srv, "decode", None)
        if decode is not None and not decode.has_work:
            time.sleep(0.0005)       # only the prefill worker has work
    m = srv.finish_session()
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def pool_bytes(eng) -> int:
    return sum(a.numel() * a.element_size()
               for half in (eng.pool["k"], eng.pool["v"])
               for a in (half if isinstance(half, tuple) else (half,)))


def phase_serve_disagg(params, cfg, smi: str, report: dict
                       ) -> tuple[int, dict, int]:
    """``disagg: {enabled: true, min_prefill_pages: 4}`` over an int8
    pool at bf16 with the spill tier: eight requests at 0 (three of
    640-960 tokens through the prefill engine, five of 64-192 straight to
    decode), 32 new tokens each, beside the same trace through the
    unified batcher in the same call. Every stream equals the unified
    run's; streamed payload bytes equal ``disagg_traffic``; one decode,
    prefill and promotion shape on the decode engine, none decoded on the
    prefill engine; every B4 launch ``"sm90"`` over the int8 pool."""
    from torchbooster_tpu_torch.comms.accounting import disagg_traffic
    from torchbooster_tpu_torch.config import (DisaggConfig, HostSpillConfig,
                                               ServingConfig)
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import DisaggPair, Request

    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, cfg.vocab, n).astype(np.int32)
               for n in DISAGG_LENS]
    longs = [i for i, n in enumerate(DISAGG_LENS)
             if (n - 1) // PS >= DISAGG_MIN_PAGES]
    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    out, streams = {}, {}
    warm_up(ServingConfig(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                          cache_dtype="int8").make(
        params, cfg, compute_dtype=torch.bfloat16), cfg)
    for arm in ("off", "on"):
        conf = ServingConfig(
            page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
            cache_dtype="int8", prefix_cache=True,
            host_spill=HostSpillConfig(enabled=True,
                                       budget_mb=SPILL_BUDGET_MB),
            disagg=DisaggConfig(enabled=arm == "on",
                                min_prefill_pages=DISAGG_MIN_PAGES))
        srv = conf.make(params, cfg, compute_dtype=torch.bfloat16,
                        on_recompile="raise")
        if (arm == "on") != isinstance(srv, DisaggPair):
            raise AssertionError(f"serve_disagg {arm}: make built "
                                 f"{type(srv).__name__}")
        reqs = [Request(prompt=p, max_new_tokens=N_NEW, request_id=f"d{i}")
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_paged_counts()
        m, wall = pump(srv, reqs)
        n, routes = pa.launches, dict(pa.launches_by_route)
        launches += n
        for r, c in routes.items():
            by_route[r] += c
        if n <= 0 or routes["sm90"] != n:
            raise AssertionError(f"serve_disagg {arm}: B4 {n} by route "
                                 f"{routes}, not all \"sm90\"")
        dec = srv.decode.engine if arm == "on" else srv.engine
        if dec.decode_compiles != 1 or dec.prefill_compiles != 1:
            raise AssertionError(f"serve_disagg {arm}: decode engine "
                                 f"{dec.decode_compiles} decode, "
                                 f"{dec.prefill_compiles} prefill shapes")
        ttft = [r.first_token_at - r.arrival for r in reqs]
        res = {"metrics": m, "wall_s": wall, "launches": n,
               "launches_by_route": routes,
               "ttft_long_p50_s": float(np.median([ttft[i] for i in longs])),
               "ttft_short_p50_s": float(np.median(
                   [t for i, t in enumerate(ttft) if i not in longs])),
               "ttft_s": ttft, "peak_mem_bytes":
                   torch.cuda.max_memory_allocated(),
               "decode_pool_bytes": pool_bytes(dec)}
        if arm == "on":
            d = m["disagg"]
            want_bytes = sum(disagg_traffic(
                DISAGG_LENS[i], page_size=PS, kv_heads=cfg.kv_heads,
                head_dim=cfg.head_dim, n_layers=cfg.n_layers)["total_bytes"]
                for i in longs)
            want_pages = sum((DISAGG_LENS[i] - 1) // PS for i in longs)
            if (d["page_bytes_streamed"], d["pages_streamed"],
                    d["stranded"], d["prefill_requests"]) \
                    != (want_bytes, want_pages, 0, len(longs)):
                raise AssertionError(f"serve_disagg: stream {d} vs "
                                     f"{want_bytes} bytes, {want_pages} "
                                     f"pages over {len(longs)} requests")
            if dec.promote_compiles != 1 or srv.prefill.decode_compiles \
                    or srv.prefill.prefill_compiles != 1:
                raise AssertionError(
                    f"serve_disagg: decode engine {dec.promote_compiles} "
                    f"promotion shapes, prefill engine "
                    f"{srv.prefill.decode_compiles} decode and "
                    f"{srv.prefill.prefill_compiles} prefill shapes")
            res["disagg"] = d
            res["prefill_pool_bytes"] = pool_bytes(srv.prefill)
            res["promotions"] = dec.promotions
        dec.tables.check()
        streams[arm] = [r.tokens for r in reqs]
        out[arm] = res
        del srv, dec
        torch.cuda.empty_cache()
    match = [a == b for a, b in zip(streams["off"], streams["on"])]
    if not all(match) or any(len(t) != N_NEW for t in streams["on"]):
        raise AssertionError(f"serve_disagg: disaggregated streams vs the "
                             f"unified batcher's {match}")
    on, off = out["on"], out["off"]
    d = on["disagg"]
    log(f"serve_disagg: 8/8 streams equal the unified batcher's; "
        f"{d['prefill_requests']} long prompts streamed {d['pages_streamed']} "
        f"pages, {d['page_bytes_streamed']} payload bytes == disagg_traffic, "
        f"{d['framed_bytes_streamed']} framed; p50 TTFT short "
        f"{on['ttft_short_p50_s'] * 1e3:.1f} ms on / "
        f"{off['ttft_short_p50_s'] * 1e3:.1f} ms off, long "
        f"{on['ttft_long_p50_s'] * 1e3:.1f} / "
        f"{off['ttft_long_p50_s'] * 1e3:.1f} ms; decode tok/s "
        f"{on['metrics']['decode_tok_s']} on / "
        f"{off['metrics']['decode_tok_s']} off; pools decode "
        f"{on['decode_pool_bytes'] / 2**20:.1f} + prefill "
        f"{on['prefill_pool_bytes'] / 2**20:.1f} MiB (unified "
        f"{off['decode_pool_bytes'] / 2**20:.1f}), peak "
        f"{on['peak_mem_bytes'] / 2**20:.1f} / "
        f"{off['peak_mem_bytes'] / 2**20:.1f} MiB; decode engine one decode, "
        f"prefill and promotion shape, prefill engine no decode; B4 "
        f"{launches} by route {by_route}, all over the int8 pool [{smi}]")
    report["serve_disagg"] = {**out, "match": match, "launches": launches,
                              "launches_by_route": by_route, "card": smi}
    return launches, by_route, launches


# ------------------------------------------------- the HTTP front door
HTTP_CLASSES = "interactive:60000:0,batch:0:0"
HTTP_DISCONNECT_AFTER = 8      # tokens a client reads before it leaves
REPLAY_TTFT_MS = 5000          # the interactive class's TTFT deadline
READINESS_KEYS = {"status", "queue_depth", "pages_free", "pages_cached",
                  "pages_host", "inflight", "occupancy", "est_step_s",
                  "step_seq", "stamped_s"}
ENGINE_DEBUG_KEYS = {"engine", "occupancy", "queue_depth", "flight"}
FLIGHT_KEYS = {"n_recorded", "capacity", "nbytes", "records", "anomalies"}


def http_serving_config(classes: str):
    """``ServingConfig.make``'s input: the GPT-2 small serving geometry
    as a ``serving:`` mapping with a ``frontend:`` block (the SLO policy
    over ``classes``, an ephemeral port)."""
    from torchbooster_tpu_torch.config import ServingConfig

    return ServingConfig.from_dict({
        "page_size": PS, "n_pages": N_PAGES, "max_slots": SLOTS,
        "frontend": {"policy": "slo", "classes": classes,
                     "default_class": "batch", "port": 0}})


async def http_request(port: int, method: str, path: str,
                       payload=None, rid: str | None = None) -> dict:
    """One HTTP exchange over localhost TCP, read to the server's close:
    its status, headers and whole body. Streamed completions go through
    ``replay_http``'s clients instead."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
    if rid:
        head += f"X-Request-Id: {rid}\r\n"
    if body:
        head += f"Content-Length: {len(body)}\r\n"
    writer.write(head.encode() + b"\r\n" + body)
    await writer.drain()
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode().split("\r\n")
    out = {"status": int(lines[0].split(" ")[1]), "headers": {
        k.strip().lower(): v.strip() for k, _, v in
        (ln.partition(":") for ln in lines[1:] if ln)},
        "body": await reader.read()}
    writer.close()
    return out


def client_workload(reqs, tag: str, vocab: int,
                    cancel_after: int | None = None):
    """``reqs`` as a loadgen workload offered all at once (arrival 0,
    class ``batch``), request ids ``<tag><i>``: ``replay_http`` sends
    each as one concurrent SSE client, which leaves after
    ``cancel_after`` tokens when that is set."""
    from torchbooster_tpu_torch.serving.loadgen import (Workload,
                                                        WorkloadRequest)

    return Workload(requests=[WorkloadRequest(
        arrival_s=0.0, max_new_tokens=r.max_new_tokens,
        prompt=np.asarray(r.prompt), priority="batch",
        request_id=f"{tag}{i}", cancel_after_tokens=cancel_after)
        for i, r in enumerate(reqs)], kind="smoke", vocab=vocab)


def served_exact(res, want: dict, where: str) -> None:
    """Every client of the HTTP replay ``res`` was answered 200 and read
    its stream to the end (none shed, errored or gone), and each
    request's streamed tokens equal ``want[request_id]``."""
    failed = {o["request_id"]: o.get("error", "shed" if o["shed"] else
                                     "errored" if o["errored"] else
                                     "cancelled")
              for o in res.outcomes
              if o["shed"] or o["errored"] or o["cancelled"]}
    diff = sorted(rid for rid, toks in want.items()
                  if res.streams.get(rid) != toks)
    if failed or diff or res.report["n_errors"] \
            or len(res.outcomes) != len(want):
        raise AssertionError(f"{where}: HTTP clients failed {failed}; "
                             f"streams differ on {diff}")


async def wait_idle(batcher, timeout: float = 60.0) -> None:
    import asyncio

    deadline = time.perf_counter() + timeout
    while batcher.has_work or batcher.inflight:
        if time.perf_counter() > deadline:
            raise AssertionError("the front door's pump did not go idle")
        await asyncio.sleep(0.01)


def report_line(rep: dict) -> str:
    """The conformance report's counts, rates and per-class latency
    percentiles on one line (the whole report is in the JSON file)."""
    ms = lambda v: "-" if v is None else f"{v * 1e3:.1f}"
    head = (f"{rep['n_completed']} completed, {rep['n_cancelled']} "
            f"cancelled, {rep['n_shed']} shed, {rep['n_errors']} errors, "
            f"deadline hit {rep['deadline_hit_rate']}, {rep['total_tok_s']} "
            f"tok/s, goodput {rep['goodput_tok_s']} tok/s over "
            f"{rep['wall_s']} s")
    classes = "; ".join(
        f"{c} TTFT p50/p99 {ms(b['ttft_p50_s'])}/{ms(b['ttft_p99_s'])} ms, "
        f"TPOT {ms(b['tpot_p50_s'])}/{ms(b['tpot_p99_s'])} ms"
        for c, b in rep["classes"].items())
    return f"{head}; {classes}"


def b4_counts(pa) -> tuple:
    return pa.launches, dict(pa.launches_by_route)


def b4_delta(pa, before: tuple) -> tuple:
    n0, r0 = before
    return pa.launches - n0, {r: c - r0[r]
                              for r, c in pa.launches_by_route.items()}


def phase_serve_http(params, cfg, smi: str, report: dict
                     ) -> tuple[int, dict]:
    """GPT-2 small at bf16 over real localhost HTTP: ``ServingFrontend``
    (``frontend: {policy: slo}``, port 0) in this phase's event loop, with
    telemetry and request tracing on. 8 concurrent SSE clients (the
    serving trace of phase 5) each equal the dense ``generate``; then a
    chat and a unary completion, a client that leaves after 8 tokens
    (pages back, tables consistent, no new decode shape), a 429 with
    Retry-After for an unmeetable deadline (no page moved), ``/metrics``
    with ``serving_*`` and ``span_seconds{name="decode_step"}``,
    ``/healthz?full=1``, ``/debug/engine`` and ``/debug/trace`` with JAX's
    keys, and the allocator gauges of ``record_memory_gauges`` on
    ``/metrics``; the 8 clients again under the profiler for the device busy
    share, each again equal to the dense ``generate``. The SSE clients are
    ``replay_http``'s, and so are the TTFT/TPOT figures. After the front door stops, the same 8 requests are pumped
    in-process (``start_session``/``submit``/``step``) for the cost of the
    HTTP pump, and one profiled 2-token request's one ``decode_step``
    range launches 12 B4 calls (one a layer), each a partials and a merge
    kernel on ``"sm90"``."""
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.config import (ObservabilityConfig,
                                               TracingConfig)
    from torchbooster_tpu_torch.observability import record_memory_gauges
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import Request
    from torchbooster_tpu_torch.serving.loadgen import replay_http

    obs_conf = ObservabilityConfig(enabled=True,
                                   tracing=TracingConfig(enabled=True))
    session = obs_conf.make()
    registry = session.registry
    registry.reset()
    conf = http_serving_config(HTTP_CLASSES)
    batcher = conf.make(params, cfg, compute_dtype=torch.bfloat16,
                        on_recompile="raise",
                        tracer=obs_conf.tracing.make())
    eng = batcher.engine
    if eng.decode_backend != "kernel" or type(batcher.policy).__name__ \
            != "SLOPolicy":
        raise AssertionError(f"serve_http: backend {eng.decode_backend}, "
                             f"policy {type(batcher.policy).__name__}")
    warm_up(batcher, cfg)
    idle_free = int(eng.tables.n_free_pages)
    reqs = requests(cfg)
    dense, _ = dense_tokens(params, cfg, reqs, torch.bfloat16)
    fe = conf.frontend.make(batcher)
    reset_paged_counts()
    out: dict = {"card": smi}

    async def scenario():
        await fe.start()
        port = fe.port
        # 8 concurrent streaming clients
        streams = await replay_http(port, client_workload(reqs, "h",
                                                          cfg.vocab))
        await wait_idle(batcher)
        chat = await http_request(
            port, "POST", "/v1/chat/completions",
            {"messages": [{"role": "user", "content": " ".join(
                str(int(t)) for t in reqs[0].prompt)}], "max_tokens": 8},
            rid="chat0")
        unary = await http_request(
            port, "POST", "/v1/completions",
            {"prompt": [int(t) for t in reqs[1].prompt],
             "max_tokens": N_NEW, "stream": False}, rid="unary0")
        # a client that leaves mid-decode
        d0 = eng.decode_compiles
        gone = await replay_http(port, client_workload(
            reqs[7:], "gone", cfg.vocab, cancel_after=HTTP_DISCONNECT_AFTER))
        await wait_idle(batcher)
        after_gone = json.loads((await http_request(
            port, "GET", "/healthz"))["body"])
        eng.tables.check()          # the pump is idle: host tables only
        gone_state = {"pages_free": after_gone["pages_free"],
                      "decode_compiles_moved": eng.decode_compiles - d0}
        # an unmeetable deadline: 429 before any page moves
        shed = await http_request(
            port, "POST", "/v1/completions",
            {"prompt": [int(t) for t in reqs[2].prompt], "max_tokens": 4,
             "priority": "interactive", "deadline_ms": 1e-6,
             "stream": True}, rid="shed0")
        await wait_idle(batcher)
        free_after_shed = int(eng.tables.n_free_pages)
        # introspection; the allocator gauges first, so /metrics has them
        gauges = record_memory_gauges(registry)
        metrics = (await http_request(port, "GET", "/metrics"))["body"]
        health = await http_request(port, "GET", "/healthz?full=1")
        engine_dbg = await http_request(port, "GET", "/debug/engine")
        trace_dbg = await http_request(port, "GET",
                                       "/debug/trace?id=h3")
        # the same 8 clients under the profiler: the device busy share
        # (their streams are held to the dense generate as the first 8)
        with profile(activities=[ProfilerActivity.CUDA]) as busy_prof:
            tb = time.perf_counter()
            busy_streams = await replay_http(
                port, client_workload(reqs, "p", cfg.vocab))
            await wait_idle(batcher)
            torch.cuda.synchronize()
            busy_wall = time.perf_counter() - tb
        session_metrics = await fe.stop()
        return {"streams": streams, "busy_streams": busy_streams,
                "chat": chat,
                "unary": unary, "gone": gone, "gone_state": gone_state,
                "shed": shed, "free_after_shed": free_after_shed,
                "gauges": gauges,
                "metrics": metrics.decode(), "health": health,
                "engine_dbg": engine_dbg, "trace_dbg": trace_dbg,
                "busy_prof": busy_prof, "busy_wall": busy_wall,
                "session": session_metrics}

    res = asyncio.run(scenario())
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    # token-exact, every streamed request (both windows) and the unary one
    want = {f"h{i}": d for i, d in enumerate(dense)}
    served_exact(res["streams"], want, "serve_http")
    served_exact(res["busy_streams"], {f"p{i}": d for i, d in
                                       enumerate(dense)},
                 "serve_http (profiled window)")
    streams = [res["streams"].streams[rid] for rid in want]
    match = [s == d for s, d in zip(streams, dense)]
    unary = json.loads(res["unary"]["body"])
    if res["unary"]["status"] != 200 \
            or unary["choices"][0]["token_ids"] != dense[1]:
        raise AssertionError(f"serve_http: unary completion {unary}")
    chat = json.loads(res["chat"]["body"])
    if res["chat"]["status"] != 200 or chat["object"] != "chat.completion" \
            or chat["usage"]["completion_tokens"] != 8:
        raise AssertionError(f"serve_http: chat completion {chat}")
    gs = res["gone_state"]
    (gone,), gone_toks = res["gone"].outcomes, res["gone"].streams["gone0"]
    if not gone["cancelled"] or gone["errored"] or gone["shed"] \
            or len(gone_toks) < HTTP_DISCONNECT_AFTER \
            or gone_toks != dense[7][:len(gone_toks)]:
        raise AssertionError(f"serve_http: the client that left read "
                             f"{gone_toks} ({gone})")
    if gs["pages_free"] != idle_free or gs["decode_compiles_moved"]:
        raise AssertionError(f"serve_http: disconnect left {gs} (idle "
                             f"{idle_free} free pages)")
    shed = res["shed"]
    if shed["status"] != 429 or "retry-after" not in shed["headers"] \
            or res["free_after_shed"] != idle_free:
        raise AssertionError(f"serve_http: shed answered {shed['status']} "
                             f"{shed['headers']}, free pages "
                             f"{res['free_after_shed']} / {idle_free}")
    prom = res["metrics"]
    if "serving_decode_tokens_total" not in prom \
            or 'span_seconds_count{name="decode_step"}' not in prom \
            or 'device_bytes_in_use{device="0"}' not in prom:
        raise AssertionError("serve_http: /metrics lacks the serving, "
                             "decode_step span or allocator series")
    mem = res["gauges"].get(0, {})
    if not 0 < mem.get("bytes_in_use", 0) <= mem.get("pool_bytes", 0) \
            <= mem.get("bytes_limit", 0):
        raise AssertionError(f"serve_http: allocator gauges {mem}")
    health = json.loads(res["health"]["body"])
    dbg = json.loads(res["engine_dbg"]["body"])
    trace = json.loads(res["trace_dbg"]["body"])
    if (res["health"]["status"], res["engine_dbg"]["status"],
            res["trace_dbg"]["status"]) != (200, 200, 200) \
            or set(health) != READINESS_KEYS \
            or set(dbg) != ENGINE_DEBUG_KEYS \
            or set(dbg["flight"]) != FLIGHT_KEYS \
            or set(trace) != {"request_id", "events"} \
            or trace["events"][0]["kind"] != "enqueued":
        raise AssertionError(f"serve_http: introspection keys {set(health)}"
                             f", {set(dbg)}, {set(trace)}")
    if by_route["sm90"] != launches or launches <= 0:
        raise AssertionError(f"serve_http: B4 by route {by_route}")
    spans = device_spans(res["busy_prof"])
    busy = union_us(spans) / 1e6
    rep = res["streams"].report
    lat = {k: rep["classes"]["batch"][k] for k in (
        "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s")}
    tokens = sum(len(s) for s in streams)
    out.update({"launches": launches, "launches_by_route": by_route,
                "token_match": match, "wall_s": rep["wall_s"],
                "tok_s": rep["total_tok_s"], **lat,
                "busy_wall_s": res["busy_wall"], "device_busy_s": busy,
                "device_busy_share": busy / res["busy_wall"],
                "disconnect": {**gs, "tokens_read": len(gone_toks)},
                "retry_after": shed["headers"]["retry-after"],
                "allocator": mem, "session": res["session"]})
    # the HTTP pump against the in-process loop on the same requests
    reset_paged_counts()
    in_reqs = requests(cfg)
    m, in_wall = pump(batcher, in_reqs)
    if [r.tokens for r in in_reqs] != dense:
        raise AssertionError("serve_http: the in-process pump's streams "
                             "differ from the dense generate")
    # one decode step under the profiler, on this thread (the profiler
    # records CPU ranges of the thread that started it; the front door's
    # steps run on its pump thread): a 2-token request decodes once after
    # its prefill's first token
    before = b4_counts(pa)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pump(batcher, [Request(prompt=reqs[0].prompt, max_new_tokens=2,
                               request_id="one0")])
    one_step = b4_delta(pa, before)
    # the traced decode step: one decode_step range in the window, 12 B4
    # calls (B4 runs in the decode step only; prefill attends plainly),
    # each a partials and a merge kernel; the runtime launches the
    # profiler places inside the range are reported beside them
    from torch.autograd import DeviceType

    evs = prof.events()
    ranges = [e.time_range for e in evs if e.name == "decode_step"
              and e.device_type == DeviceType.CPU]
    kernels = [e.name for e in evs if e.device_type == DeviceType.CUDA
               and "paged_" in e.name]
    partials = sum("partials" in k for k in kernels)
    merges = sum("merge" in k for k in kernels)
    launches_in = sum(
        1 for e in evs if e.device_type == DeviceType.CPU
        and "LaunchKernel" in e.name and ranges
        and ranges[0].start <= e.time_range.start <= ranges[0].end)
    n1, r1 = one_step
    if len(ranges) != 1 or (partials, merges) != (cfg.n_layers,
                                                  cfg.n_layers) \
            or n1 != cfg.n_layers or r1["sm90"] != cfg.n_layers:
        raise AssertionError(
            f"serve_http: traced step {len(ranges)} decode_step ranges, "
            f"{partials} partials + {merges} merge kernels, B4 {n1} by "
            f"route {r1}, {launches_in} launches inside the range")
    launches += pa.launches
    for r, c in pa.launches_by_route.items():
        by_route[r] += c
    out.update({"launches": launches, "launches_by_route": by_route,
                "inprocess_wall_s": in_wall,
                "inprocess_tok_s": tokens / in_wall,
                "inprocess_ttft_p50_s": m["ttft_p50_s"],
                "one_step": {"decode_step_ranges": len(ranges),
                             "partials": partials, "merges": merges,
                             "launches": n1, "by_route": r1,
                             "runtime_launches_in_range": launches_in}})
    session.close()
    registry.reset()
    registry.enabled = False
    log(f"serve_http: 8/8 SSE streams over localhost token-exact vs dense "
        f"generate, unary and chat 200; client TTFT p50 "
        f"{lat['ttft_p50_s'] * 1e3:.1f} / p99 {lat['ttft_p99_s'] * 1e3:.1f}"
        f" ms, TPOT p50 {lat['tpot_p50_s'] * 1e3:.2f} / p99 "
        f"{lat['tpot_p99_s'] * 1e3:.2f} ms, {out['tok_s']:.1f} tok/s "
        f"over the {out['wall_s']:.3f} s window (in-process pump of the "
        f"same 8: {in_wall:.3f} s, {out['inprocess_tok_s']:.1f} tok/s); "
        f"device busy {100 * out['device_busy_share']:.1f}% of a profiled "
        f"HTTP replay (8/8 token-exact too); disconnect after "
        f"{len(gone_toks)} tokens:"
        f" {gs['pages_free']}/{idle_free} pages free, no new decode shape;"
        f" 429 Retry-After {shed['headers']['retry-after']}; allocator "
        f"gauges {mem['bytes_in_use'] / 2**20:.1f} MiB in use, "
        f"{mem['pool_bytes'] / 2**20:.1f} MiB reserved of "
        f"{mem['bytes_limit'] / 2**30:.1f} GiB; one traced "
        f"decode_step: {partials} partials + {merges} merge kernels, B4 "
        f"{n1} {r1}, {launches_in} runtime launches in the range; B4 "
        f"{launches} by route {by_route} [{smi}]")
    report["serve_http"] = out
    return launches, by_route


def phase_serve_replay(params, cfg, smi: str, report: dict
                       ) -> tuple[int, dict]:
    """The loadgen harness at GPT-2 small, bf16: a ``LoadgenConfig``
    Poisson workload (32 requests, classes interactive:3 / batch:1, 1/8
    with a recorded disconnect, prompts 64-512, 16-32 new) served under
    ``policy: slo``. ``replay_inprocess`` twice on the virtual clock:
    identical streams and outcomes, each uncancelled stream the dense
    ``generate`` and each cancelled one a prefix of it. Then
    ``replay_http`` against a front door with ``capture_path``: the
    capture holds the offered requests (prompts, classes, budgets: its
    fingerprint with the offered arrival and cancel offsets equals the
    offered one); no HTTP client errs or is shed, every request served in
    full over HTTP equals its in-process stream (the dense ``generate``
    where the in-process one was cancelled), and each client that left
    at its recorded offset holds a prefix of the dense ``generate``."""
    import asyncio
    import dataclasses
    import tempfile

    from torchbooster_tpu_torch.config import LoadgenConfig
    from torchbooster_tpu_torch.models.gpt import generate
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving.frontend import parse_classes
    from torchbooster_tpu_torch.serving.loadgen import (Workload,
                                                        replay_http,
                                                        replay_inprocess)

    wl = LoadgenConfig(source="poisson", n_requests=32,
                       classes="interactive:3,batch:1", cancel_frac=0.125,
                       prompt_len=(64, 512), max_new_tokens=(16, 32),
                       vocab=cfg.vocab).make()
    classes = f"interactive:{REPLAY_TTFT_MS}:0,batch:0:0"
    conf = http_serving_config(classes)
    batcher = conf.make(params, cfg, compute_dtype=torch.bfloat16,
                        on_recompile="raise")
    warm_up(batcher, cfg)
    reset_paged_counts()
    t0 = time.perf_counter()
    runs = [replay_inprocess(batcher, wl) for _ in range(2)]
    inproc_s = time.perf_counter() - t0
    views = [(r.streams, r.outcomes) for r in runs]
    if views[0] != views[1]:
        raise AssertionError("serve_replay: two in-process replays differ")
    dense = {}
    for rec in wl:
        ids = torch.as_tensor(rec.prompt_ids(wl.vocab), device="cuda")
        full = generate(params, ids.long()[None], cfg,
                        n_new=rec.max_new_tokens, temperature=0.0,
                        compute_dtype=torch.bfloat16)
        dense[rec.request_id] = full[0, ids.numel():].tolist()
    inproc = runs[0]
    flags = {r.request_id: (r.shed, r.cancelled) for r in inproc.requests}
    bad = [rid for rid, toks in inproc.streams.items()
           if flags[rid][0] or (toks != dense[rid] if not flags[rid][1]
                                else toks != dense[rid][:len(toks)])]
    if bad:
        raise AssertionError(f"serve_replay: in-process streams vs dense "
                             f"generate differ (or shed) on {bad}")
    launches_inproc = pa.launches
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = Path(tmp) / "capture.jsonl"
        fe = dataclasses.replace(conf.frontend,
                                 capture_path=str(cap_path)).make(batcher)

        async def scenario():
            await fe.start()
            res = await replay_http(fe.port, wl,
                                    classes=parse_classes(classes))
            await fe.stop()
            return res

        t1 = time.perf_counter()
        http = asyncio.run(scenario())
        http_s = time.perf_counter() - t1
        cap = Workload.load(cap_path)
    cap_written = cap.fingerprint()
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    if by_route["sm90"] != launches or launches <= launches_inproc:
        raise AssertionError(f"serve_replay: B4 {launches} by route "
                             f"{by_route}")
    offered = {r.request_id: r for r in wl}
    captured = {r.request_id: r for r in cap}
    if set(captured) != set(offered):
        raise AssertionError(f"serve_replay: captured ids "
                             f"{sorted(set(captured) ^ set(offered))} differ")
    for rid, rec in captured.items():
        want = offered[rid]
        if rec.prompt.tolist() != want.prompt.tolist() \
                or (rec.priority, rec.max_new_tokens, rec.eos_id) \
                != (want.priority, want.max_new_tokens, want.eos_id):
            raise AssertionError(f"serve_replay: capture of {rid} differs")
        # the capture times arrivals on the server's clock and records
        # what was delivered before a disconnect landed
        rec.arrival_s = want.arrival_s
        rec.cancel_after_tokens = want.cancel_after_tokens
    cap_fp = Workload(requests=list(captured.values()), kind=cap.kind,
                      vocab=wl.vocab).fingerprint()
    if cap_fp != wl.fingerprint():
        raise AssertionError(f"serve_replay: capture fingerprint {cap_fp} "
                             f"!= offered {wl.fingerprint()}")
    # every HTTP client was answered: none errored, and none shed (none
    # was shed in-process). A client that left holds a prefix of the
    # dense generate and had a recorded disconnect offset it reached;
    # every other HTTP stream equals its in-process stream, or the dense
    # generate where the in-process one was cancelled (a prefix of it)
    rec_of = {r.request_id: r for r in wl}
    failed = {o["request_id"]: o.get("error", "shed" if o["shed"] else
                                     "errored")
              for o in http.outcomes if o["shed"] or o["errored"]}
    if failed or http.report["n_errors"] or http.report["n_shed"] \
            or sorted(http.streams) != sorted(rec_of):
        raise AssertionError(f"serve_replay: HTTP clients failed {failed}")
    left = {o["request_id"] for o in http.outcomes if o["cancelled"]}
    stray = [rid for rid in sorted(left)
             if rec_of[rid].cancel_after_tokens is None
             or len(http.streams[rid]) < rec_of[rid].cancel_after_tokens
             or http.streams[rid] != dense[rid][:len(http.streams[rid])]]
    full = sorted(set(rec_of) - left)
    diff = [rid for rid in full if http.streams[rid] != (
        dense[rid] if flags[rid][1] else inproc.streams[rid])]
    if stray or diff:
        raise AssertionError(f"serve_replay: HTTP streams of clients that "
                             f"left differ on {stray}, of the others on "
                             f"{diff}")
    both = [rid for rid in full if not flags[rid][1]]
    # requests whose client left over HTTP but that ran in full
    # in-process: their offset was reached on the last token
    left_http_only = sorted(rid for rid in left if not flags[rid][1])
    out = {"launches": launches, "launches_by_route": by_route,
           "launches_inprocess": launches_inproc,
           "inprocess_wall_s": inproc_s / 2, "http_wall_s": http_s,
           "offered_fingerprint": wl.fingerprint(),
           "capture_fingerprint_as_written": cap_written,
           "http_streams_compared": len(both),
           "http_streams_vs_dense_only": len(full) - len(both),
           "http_clients_left": len(left),
           "left_over_http_only": left_http_only,
           "inprocess_report": inproc.report, "http_report": http.report,
           "card": smi}
    report["serve_replay"] = out
    log(f"serve_replay: workload {wl.fingerprint()} (32 requests); two "
        f"in-process replays identical, "
        f"{sum(not any(f) for f in flags.values())} uncancelled streams "
        f"equal dense generate, cancelled ones prefixes; capture holds the "
        f"offered requests (fingerprint with the offered arrivals and "
        f"cancel offsets {cap_fp}; as written {cap_written}); no HTTP "
        f"client errored or shed; {len(both)} HTTP streams equal their "
        f"in-process streams, {len(full) - len(both)} more the dense "
        f"generate; {len(left)} clients left at their recorded offsets with "
        f"dense prefixes ({len(left_http_only)} of them served in full "
        f"in-process: {left_http_only}); B4 {launches} by "
        f"route {by_route}; wall in-process {inproc_s / 2:.3f} s a replay, "
        f"HTTP {http_s:.3f} s [{smi}]")
    for name, rep in (("in-process", inproc.report),
                      ("HTTP", http.report)):
        log(f"serve_replay {name} report: " + report_line(rep))
    return launches, by_route


# ------------------------------------------------------------ engine fleet
FLEET_TENANTS = 2             # tenants of the shared-prefix workload
FLEET_PREFIX_PAGES = 2        # their page-aligned shared prefix, in pages
FLEET_KILL_AFTER = 40         # fleet steps before replica 1 may be killed
# requests of the fleet's workload: serve_replay's 32 halved, to keep the
# smoke inside its time limit (the replays are host-bound)
FLEET_REQUESTS = 16
FLEET_FLIGHT = 1 << 15        # a flight ring that holds every step here
FLEET_MERGED_KEYS = {"n_requests", "new_tokens", "elapsed_s",
                     "decode_tok_s", "total_tok_s", "latency_mean_s",
                     "latency_p95_s", "ttft_mean_s", "n_admissions",
                     "n_preemptions", "n_prefill_chunks",
                     "prefix_hit_pages", "n_shed", "n_cancelled",
                     "deadline_hit_rate", "router", "replicas", "classes"}
SLO_GAUGES = ("serving_slo_ttft_hit_rate", "serving_slo_tpot_hit_rate",
              "serving_slo_ttft_quantile", "serving_slo_tpot_quantile")


def fleet_config(classes: str, routing: str, n_replicas: int = 2,
                 prefix_cache: bool = False):
    """The serving geometry as a ``serving:`` mapping with a ``frontend:
    {policy: slo}`` block and a ``router:`` block of ``n_replicas``
    (``affinity_pages: 2``)."""
    from torchbooster_tpu_torch.config import ServingConfig

    return ServingConfig.from_dict({
        "page_size": PS, "n_pages": N_PAGES, "max_slots": SLOTS,
        "prefix_cache": prefix_cache,
        "frontend": {"policy": "slo", "classes": classes,
                     "default_class": "batch", "port": 0},
        "router": {"n_replicas": n_replicas, "policy": routing,
                   "affinity_pages": FLEET_PREFIX_PAGES}})


def dense_streams(params, cfg, wl) -> dict:
    """Each request's dense greedy ``generate`` continuation at bf16."""
    from torchbooster_tpu_torch.models.gpt import generate

    out = {}
    for rec in wl:
        ids = torch.as_tensor(rec.prompt_ids(wl.vocab), device="cuda")
        full = generate(params, ids.long()[None], cfg,
                        n_new=rec.max_new_tokens, temperature=0.0,
                        compute_dtype=torch.bfloat16)
        out[rec.request_id] = full[0, ids.numel():].tolist()
    return out


def phase_serve_fleet(params, cfg, smi: str, report: dict
                      ) -> tuple[int, dict]:
    """The engine fleet at GPT-2 small, bf16: two replicas on the one
    card, built by ``ServingConfig.make`` from a ``router: {n_replicas:
    2}`` block under ``policy: slo``, driven by ``replay_inprocess`` with
    ``serve_replay``'s workload cut to ``FLEET_REQUESTS`` and a
    shared-prefix one (2 tenants, a
    2-page prefix). Gates: two replays under each policy give the same
    ``assignment_log`` and streams, equal across policies and to a
    one-replica replay; uncancelled streams equal the dense ``generate``,
    cancelled ones prefixes of it; affinity finds the shared prefixes
    (hits counted, requests at their key's home, more prefix-hit pages
    than round robin); killing replica 1 mid-replay readmits exactly
    what ``kill`` returned and every stream stays the same; no replica is
    buried in any other arm (a B4 fault would bury one: it fails the
    phase with its exception); a socket replica served on loopback gives
    the in-process fleet's streams and ``assignment_log``; the front door
    over a fleet streams the 8 requests token-exact and answers
    ``/debug/router``, ``/healthz?full=1`` and ``/metrics``; B4's
    launches equal 12 per decode step the batchers' flight rings hold,
    every one on ``"sm90"``."""
    import asyncio
    import re

    from torchbooster_tpu_torch.config import LoadgenConfig
    from torchbooster_tpu_torch.observability import (FlightRecorder,
                                                      get_registry)
    from torchbooster_tpu_torch.observability.export import prometheus_text
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving.frontend import parse_classes
    from torchbooster_tpu_torch.serving.loadgen import (replay_http,
                                                        replay_inprocess)
    from torchbooster_tpu_torch.serving.replica_server import serve_in_thread
    from torchbooster_tpu_torch.serving.router import (EngineFleet,
                                                       diff_routing,
                                                       prefix_affinity_key,
                                                       routing_artifact)

    classes = f"interactive:{REPLAY_TTFT_MS}:0,batch:0:0"
    load = dict(source="poisson", n_requests=FLEET_REQUESTS,
                classes="interactive:3,batch:1", cancel_frac=0.125,
                prompt_len=(64, 512), max_new_tokens=(16, 32),
                vocab=cfg.vocab)
    wl = LoadgenConfig(**load).make()
    shared = LoadgenConfig(**{
        **load, "n_requests": 16, "cancel_frac": 0.0,
        "prompt_len": (64, 256), "tenants": FLEET_TENANTS,
        "prefix_pages": FLEET_PREFIX_PAGES,
        "prefix_page_size": PS}).make()
    registry = get_registry()
    registry.reset()
    registry.enabled = True
    batchers: list = []          # every batcher of the phase, for B4's count

    def own(b):
        b.flight = FlightRecorder(capacity=FLEET_FLIGHT)
        batchers.append(b)
        return b

    def build(routing: str, n: int = 2, prefix_cache: bool = False,
              klass: str = classes):
        srv = fleet_config(klass, routing, n, prefix_cache).make(
            params, cfg, compute_dtype=torch.bfloat16, on_recompile="raise")
        for rep in getattr(srv, "replicas", ()):
            own(rep.batcher)
        if n == 1:
            own(srv)
        return srv

    def counter(name: str, **labels) -> float:
        return registry.counter(name).value(**labels)

    def unburied(fleet, where: str) -> None:
        """Gate 3: a buried replica here is a fault (a failing B4 build
        or launch among them), never something to serve around."""
        if fleet.last_error is not None:
            raise AssertionError(f"serve_fleet {where}: a replica was "
                                 f"buried") from fleet.last_error
        if fleet.n_live != len(fleet.replicas) \
                or counter("router_readmissions_total", reason="death"):
            raise AssertionError(f"serve_fleet {where}: {fleet.n_live} of "
                                 f"{len(fleet.replicas)} replicas live")

    def replay(srv, workload, where: str):
        registry.reset()
        t = time.perf_counter()
        res = replay_inprocess(srv, workload)
        wall = time.perf_counter() - t
        if not hasattr(srv, "replicas"):
            return res, wall, []
        unburied(srv, where)
        return res, wall, list(srv.assignment_log)

    try:
        reset_paged_counts()
        dense = dense_streams(params, cfg, wl)
        dense_shared = dense_streams(params, cfg, shared)
        single = build("affinity", n=1)
        warm_up(single, cfg)
        one, one_wall, _ = replay(single, wl, "one replica")
        flags = {r.request_id: (r.shed, r.cancelled) for r in one.requests}
        bad = [rid for rid, toks in one.streams.items()
               if flags[rid][0] or (toks != dense[rid][:len(toks)]
                                    if flags[rid][1] else toks != dense[rid])]
        if bad:
            raise AssertionError(f"serve_fleet: one-replica streams vs dense "
                                 f"generate differ (or shed) on {bad}")
        # gate 1: determinism and parity, both policies
        runs, walls, arts = {}, {}, {}
        for routing in ("round_robin", "affinity"):
            pair = []
            for i in range(2):
                fleet = build(routing)
                res, wall, order = replay(fleet, wl, f"{routing} run {i}")
                pair.append((order, res.streams))
                walls.setdefault(routing, []).append(wall)
            if pair[0] != pair[1]:
                raise AssertionError(f"serve_fleet: two {routing} replays "
                                     f"differ")
            if pair[0][1] != one.streams:
                raise AssertionError(f"serve_fleet: {routing} streams differ "
                                     f"from the one-replica replay")
            if {rep for _, rep in pair[0][0]} != {0, 1}:
                raise AssertionError(f"serve_fleet: {routing} used one "
                                     f"replica only")
            runs[routing] = (pair[0][0], res)
            arts[routing] = routing_artifact(fleet, wl.fingerprint())
            log(f"serve_fleet {routing}: two replays identical, streams "
                f"equal the one-replica replay; wall {walls[routing]} s "
                f"(one replica {one_wall:.3f} s)")
        # affinity on the shared-prefix workload (prefix cache on), beside
        # round robin on it
        hits, homes = {}, {}
        for routing in ("round_robin", "affinity"):
            fleet = build(routing, prefix_cache=True)
            res, _, order = replay(fleet, shared, f"{routing} shared")
            diff = [rid for rid, toks in res.streams.items()
                    if toks != dense_shared[rid]]
            if diff:
                raise AssertionError(f"serve_fleet: {routing} shared-prefix "
                                     f"streams vs dense generate differ on "
                                     f"{diff}")
            hits[routing] = sum(m["prefix_hit_pages"]
                                for m in res.metrics["replicas"])
            if routing == "affinity":
                aff_hits = counter("router_affinity_hits_total")
                key_of = {rec.request_id: prefix_affinity_key(
                    rec.prompt, PS, FLEET_PREFIX_PAGES) for rec in shared}
                at_home = sum(fleet.routing._map.get(key_of[rid]) == rep
                              for rid, rep in order)
                homes = {"requests_at_home": at_home, "requests": len(order),
                         "hit_pages_by_replica": [
                             m["prefix_hit_pages"]
                             for m in res.metrics["replicas"]]}
        log(f"serve_fleet shared prefix: affinity hits {aff_hits}, {homes},"
            f" prefix-hit pages {hits}")
        if not aff_hits or homes["requests_at_home"] < len(shared) // 2 \
                or hits["affinity"] <= hits["round_robin"]:
            raise AssertionError(f"serve_fleet: affinity hits {aff_hits}, "
                                 f"{homes}, prefix-hit pages {hits}")
        # gate 2: replica death mid-replay
        fleet = build("affinity")
        killed: list = []
        step = fleet.step

        def step_then_kill():
            # replay_inprocess pumps fleet.step(): replica 1 dies between
            # two fleet steps, with work in flight
            step_then_kill.n += 1
            if not killed and step_then_kill.n > FLEET_KILL_AFTER \
                    and fleet.replicas[1].inflight:
                killed.append(fleet.kill(1))
            return step()

        step_then_kill.n = 0
        fleet.step = step_then_kill
        registry.reset()
        dead = replay_inprocess(fleet, wl)
        live_gauge = registry.gauge("router_replicas_live").value()
        readmit = counter("router_readmissions_total", reason="death")
        if not killed or not killed[0] or readmit != killed[0] \
                or fleet.n_live != 1 or live_gauge != 1:
            raise AssertionError(f"serve_fleet: kill returned {killed}, "
                                 f"death readmissions {readmit}, live "
                                 f"{fleet.n_live} (gauge {live_gauge})")
        finished = [r for r in dead.requests if r.finished_at is not None]
        if len(finished) != len(wl) or dead.streams != one.streams \
                or set(dead.metrics) != FLEET_MERGED_KEYS \
                or dead.metrics["n_requests"] != len(wl):
            raise AssertionError(
                f"serve_fleet: after the death {len(finished)}/{len(wl)} "
                f"finished, streams differ on "
                f"{[k for k in one.streams if dead.streams.get(k) != one.streams[k]]}"
                f", merged keys {sorted(set(dead.metrics) ^ FLEET_MERGED_KEYS)}")
        log(f"serve_fleet kill: {killed} readmitted, streams unchanged")
        # gate 4: a socket replica beside an in-process one
        handle = serve_in_thread(own(fleet_config(classes, "affinity", 1).make(
            params, cfg, compute_dtype=torch.bfloat16, on_recompile="raise")))
        try:
            conf = fleet_config(classes, "affinity")
            conf.router.replicas = ["inproc", handle.endpoint]
            fleet = conf.make(params, cfg, compute_dtype=torch.bfloat16,
                              on_recompile="raise")
            own(fleet.replicas[0].batcher)
            remote = fleet.replicas[1]
            if type(remote).__name__ != "RemoteReplica" \
                    or remote.readiness().get("status") != "ok":
                raise AssertionError(f"serve_fleet: the socket replica is "
                                     f"not ready: {remote.readiness()}")
            sock, sock_wall, sock_log = replay(fleet, wl, "socket")
            wire = (remote.wire_tx_bytes, remote.wire_rx_bytes)
            remote.close()
        finally:
            handle.stop()
        routed = diff_routing(arts["affinity"],
                              routing_artifact(fleet, wl.fingerprint()))
        if sock.streams != one.streams or sock_log != runs["affinity"][0] \
                or routed:
            raise AssertionError(f"serve_fleet: the socket fleet differs: "
                                 f"{routed}")
        log(f"serve_fleet socket: streams and assignment log equal, wall "
            f"{sock_wall:.3f} s")
        # gate 5: the front door over a fleet
        fleet = build("affinity", klass=HTTP_CLASSES)
        reqs = requests(cfg)
        want = dict(zip((f"fleet{i}" for i in range(len(reqs))),
                        dense_tokens(params, cfg, reqs, torch.bfloat16)[0]))
        fe = fleet_config(HTTP_CLASSES, "affinity").frontend.make(fleet)

        async def scenario():
            await fe.start()
            res = await replay_http(fe.port,
                                    client_workload(reqs, "fleet", cfg.vocab),
                                    classes=parse_classes(HTTP_CLASSES))
            pages = {path: await http_request(fe.port, "GET", path)
                     for path in ("/debug/router", "/healthz?full=1",
                                  "/metrics")}
            await fe.stop()
            return res, pages

        registry.reset()
        http, pages = asyncio.run(scenario())
        unburied(fleet, "front door")
        served_exact(http, want, "serve_fleet front door")
        routed = json.loads(pages["/debug/router"]["body"])
        health = json.loads(pages["/healthz?full=1"]["body"])
        metrics = pages["/metrics"]["body"].decode()
        per_replica = set(re.findall(
            r'^router_requests_total\{[^}]*replica="(\d+)"', metrics,
            re.MULTILINE))
        if pages["/debug/router"]["status"] != 200 \
                or len(routed["decisions"]) != len(reqs) \
                or len(health["replicas"]) != 2 or per_replica != {"0", "1"}:
            raise AssertionError(f"serve_fleet: /debug/router "
                                 f"{pages['/debug/router']['status']}, "
                                 f"{len(health.get('replicas', ()))} health "
                                 f"rows, router_requests_total on {per_replica}")
        text = prometheus_text(registry)
        gauges = {(name, cls) for name in SLO_GAUGES
                  for cls in ("interactive", "batch")
                  if re.search(rf'^{name}\{{[^}}]*cls="{cls}"', text,
                               re.MULTILINE)}
        if any(f"# TYPE {name} gauge" not in metrics for name in SLO_GAUGES) \
                or not {(n, "batch") for n in SLO_GAUGES} <= gauges:
            raise AssertionError(f"serve_fleet: SLO gauges {sorted(gauges)}")
        # gate 6: B4's launches, exactly 12 per decode step of every batcher
        launches, by_route = pa.launches, dict(pa.launches_by_route)
        steps = sum(sum("decode" in rec["kind"] for rec in b.flight.tail())
                    for b in batchers)
        if any(b.flight.n_recorded > FLEET_FLIGHT for b in batchers) \
                or launches != cfg.n_layers * steps \
                or by_route["sm90"] != launches:
            raise AssertionError(f"serve_fleet: B4 {launches} by route "
                                 f"{by_route}, {steps} decode steps")
    finally:
        registry.reset()
        registry.enabled = False
    out = {"launches": launches, "launches_by_route": by_route,
           "decode_steps": steps, "n_batchers": len(batchers),
           "two_replica_wall_s": walls, "one_replica_wall_s": one_wall,
           "socket_wall_s": sock_wall, "wire_bytes": wire,
           "affinity_hits": aff_hits, "prefix_hit_pages": hits,
           "affinity_homes": homes, "readmissions_death": readmit,
           "killed": killed[0], "http_report": http.report,
           "two_replica_report": runs["affinity"][1].report,
           "one_replica_report": one.report,
           "offered_fingerprint": wl.fingerprint(),
           "shared_fingerprint": shared.fingerprint(), "card": smi}
    report["serve_fleet"] = out
    log(f"serve_fleet: 2 GPT-2 small replicas on one card; workload "
        f"{wl.fingerprint()} ({len(wl)} requests) twice under round_robin and "
        f"twice under affinity: identical assignment logs and streams, "
        f"equal to the one-replica replay and (uncancelled) to dense "
        f"generate; shared-prefix workload {shared.fingerprint()}: affinity "
        f"hits {aff_hits:.0f}, {homes['requests_at_home']}/{homes['requests']}"
        f" requests at their key's home, prefix-hit pages {hits}; killed "
        f"replica 1: {killed[0]} readmitted (death counter {readmit:.0f}), "
        f"streams unchanged; socket replica: streams and assignment log "
        f"equal, {wire[0]} B sent / {wire[1]} B received; front door: 8/8 SSE"
        f" streams token-exact; B4 {launches} = {cfg.n_layers} x {steps} "
        f"decode steps, by route {by_route}; wall a replay: two replicas "
        f"round_robin {walls['round_robin']} s, affinity {walls['affinity']}"
        f" s, one replica {one_wall:.3f} s, socket {sock_wall:.3f} s [{smi}]")
    for name, rep in (("two-replica affinity", runs["affinity"][1].report),
                      ("one-replica", one.report)):
        log(f"serve_fleet {name} report: " + report_line(rep))
    return launches, by_route


# ----------------------------------------------------------------- train
TRAIN_STEPS = 20
TRAIN_B, TRAIN_S = 8, 1024


def gpt2_train_config(n_iter: int, precision: str = "bf16",
                      sample_tokens: int = 32):
    """``examples/lm/gpt/gpt.yml``'s values built in code (the card's
    machine reads no YAML), with the model block at GPT-2-small width
    (chunked LM head), batch 8 x 1024, ``n_iter`` steps, a 2-step warmup
    so that the loss moves, and a log record every step."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.gpt import Config, ModelConfig

    return Config(
        n_iter=n_iter, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=0, checkpoint_root="checkpoints",
        model=ModelConfig(vocab=50257, n_layers=12, d_model=768,
                          n_heads=12, seq_len=TRAIN_S, remat=True,
                          chunked_head=True),
        env=EnvConfig(distributed=False, precision=precision, mesh="dp"),
        loader=LoaderConfig(batch_size=TRAIN_B, num_workers=0,
                            drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                              betas=(0.9, 0.95)),
        scheduler=SchedulerConfig(name="cycle", n_iter=n_iter, warmup=2,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="synthetic_lm", root="dataset/lm"),
        sample_tokens=sample_tokens, sample_temperature=0.8)


def model_flops_per_step(cfg) -> float:
    """6 x parameters x tokens for the matmuls (the tied head counted
    once, the wpe lookup not at all) plus causal attention's two
    products, 6 L S d per token over forward and backward. The remat
    recompute is not counted."""
    d, n_l = cfg.d_model, cfg.n_layers
    n_params = cfg.vocab * d + n_l * (12 * d * d + 13 * d) + 2 * d
    tokens = TRAIN_B * TRAIN_S
    return 6.0 * n_params * tokens + 6.0 * n_l * TRAIN_S * d * tokens


def flash_vs_reference_fp32() -> dict:
    """One fp32 forward + backward of the recipe's loss from the same
    parameters and batch, attention through the flash kernels and
    through ``mha_reference``: loss and gradient norm must agree."""
    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.ops.losses import lm_head_cross_entropy
    from torchbooster_tpu_torch.recipes import gpt as recipe
    from torchbooster_tpu_torch.utils import tree_leaves

    t = recipe.setup(gpt2_train_config(1, "fp32"))
    batch = t.batch(next(t.batches)[1])
    out = {}
    for impl in ("flash", "reference"):
        hidden = GPT.apply(t.state.params, batch["ids"], t.cfg,
                           compute_dtype=torch.float32, remat=True,
                           attn_impl=impl, return_hidden=True)
        loss = lm_head_cross_entropy(hidden, GPT.head_table(t.state.params),
                                     batch["labels"])
        loss.backward()
        leaves = tree_leaves(t.state.params)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in leaves])).item()
        out[impl] = {"loss": loss.item(), "grad_norm": norm}
        for p in leaves:
            p.grad = None
    # both sides are fp32 throughout; they differ in the order of the
    # attention sums (online softmax over 64-key tiles against one
    # softmax over the row), worth ~1e-6 relative per layer
    tol = 1e-4
    for key in ("loss", "grad_norm"):
        a, b = out["flash"][key], out["reference"][key]
        if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
            raise AssertionError(f"fp32 step: flash {key} {a} vs reference "
                                 f"{b} (rtol {tol})")
    out["rtol"] = tol
    log(f"train fp32 flash vs reference: loss {out['flash']['loss']:.6f} / "
        f"{out['reference']['loss']:.6f}, grad norm "
        f"{out['flash']['grad_norm']:.6f} / "
        f"{out['reference']['grad_norm']:.6f} (rtol {tol})")
    return out


def train_breakdown(n_steps: int = 3) -> dict:
    """A fresh bf16 trainer: two warm steps, then ``n_steps`` under the
    profiler (CUDA activity): device busy share of the wall time, kernels
    per step, the flash kernels' share of device time, and the top
    kernels; then one step with host activity traced, for the host ops
    that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.recipes import gpt as recipe

    t = recipe.setup(gpt2_train_config(n_steps + 2, sample_tokens=0))
    for _ in range(2):
        t.state, m = t.step(t.state, t.batch(next(t.batches)[1]))
    m["loss"].item()
    batches = [t.batch(next(t.batches)[1]) for _ in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            t.state, m = t.step(t.state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    flash = sum(v for k, v in per_kernel if "::flash_" in k)
    # one more step with host (CPU) activity traced, apart from the timed
    # ones because the tracing slows the host: where the host time goes
    batch = t.batch(next(t.batches)[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as host_prof:
        t.state, m = t.step(t.state, batch)
        torch.cuda.synchronize()
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e6, e.count)
                       for e in host_prof.key_averages()),
                      key=lambda kv: -kv[1])
    return {"steps": n_steps, "wall_s": wall, "step_ms": wall / n_steps * 1e3,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3, "flash_s": flash,
            "flash_share_of_device": flash / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:10], "host_top_one_step": host_ops[:12]}


def phase_train(report: dict, smi: str) -> dict:
    """The recipe's ``main`` at GPT-2-small width on the card; returns
    the flash kernels' launch counts from this run."""
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe

    conf = gpt2_train_config(TRAIN_STEPS)
    cfg = conf.model.make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    t0 = time.perf_counter()
    res = recipe.main(conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    by_route = {"fwd": dict(fa.launches_fwd_by_route),
                "dq": dict(fa.launches_dq_by_route),
                "dkv": dict(fa.launches_dkv_by_route)}
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in res["log"]]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    n_l = cfg.n_layers
    # remat runs each block's forward twice per step; the sample's
    # prefill adds one forward per layer
    expected = {"fwd": 2 * n_l * TRAIN_STEPS + n_l,
                "dq": n_l * TRAIN_STEPS, "dkv": n_l * TRAIN_STEPS}
    if launches != expected:
        raise AssertionError(f"train: flash launches {launches}, expected "
                             f"{expected}")
    # bf16, D 64, S 1024: every B1-B3 launch on the wgmma kernels
    route_expected = {key: {"sm90": expected[key], "mma_sync": 0, "f32": 0}
                      for key in ("fwd", "dq", "dkv")}
    if by_route != route_expected:
        raise AssertionError(f"train: B1-B3 routes {by_route}, expected "
                             f"{route_expected}")
    # steady state: from the end of step 5 to the end of the last step
    el = [r["elapsed_s"] for r in res["log"]]
    warm = 5
    step_s = (el[-1] - el[warm - 1]) / (TRAIN_STEPS - warm)
    flops = model_flops_per_step(cfg)
    out = {"losses": losses, "launches": launches, "expected": expected,
           "by_route": by_route, "main_wall_s": wall, "step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
           "model_flops_per_step": flops,
           "mfu_of_989_tflops": flops / step_s / BF16_FLOPS,
           "peak_mem_bytes": peak, "sample_len": len(res.get("sample", [])),
           "card": smi}
    log(f"train: GPT-2 small, batch {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{out['step_ms']:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, "
        f"model FLOP share {100 * out['mfu_of_989_tflops']:.2f}% of 989 "
        f"TFLOP/s, peak mem {peak / 2**30:.2f} GiB; flash launches "
        f"{launches}, B1-B3 by route {by_route} [{smi}]")
    out["fp32_flash_vs_reference"] = flash_vs_reference_fp32()
    torch.cuda.empty_cache()
    b = out["breakdown"] = train_breakdown()
    log(f"train profiled: {b['steps']} steps, wall {b['wall_s']:.3f} s "
        f"({b['step_ms']:.1f} ms/step), device {b['device_ms_per_step']:.1f} "
        f"ms/step, busy {100 * b['device_busy_share']:.1f}%, "
        f"{b['kernels_per_step']:.0f} kernels per step, flash kernels "
        f"{100 * b['flash_share_of_device']:.1f}% of device time; top: "
        + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in b["top"][:5]))
    log("train host, one traced step (self CPU ms, calls): " + "; ".join(
        f"{k[:40]} {v * 1e3:.1f} ({n})"
        for k, v, n in b["host_top_one_step"][:8]))
    report["train"] = out
    return {**launches, "by_route": by_route}


# ----------------------------------------------------------- gpt2_import
GPT2_STEPS = 8
# each optimizer's learning rate for the fine-tune (the cycle schedule's
# peak, a 2-step warmup): lion moves every entry by lr, so it takes
# AdamW's; lamb's and adafactor's steps are relative to each leaf's norm
GPT2_LR = {"lamb": 1e-2, "lion": 3e-4, "adafactor": 3e-2}
GPT2_SERVED = "adafactor"       # the fine-tuned model that is served
# one update at the peak lr on the card against the same optimizer on
# the CPU, per leaf: the difference of the updated params over the
# largest entry of the leaf's update. The elementwise rules round alike;
# lamb's norms and adafactor's means sum up to 38.6 M fp32 entries in
# another order on each side (both within ~1e-7 of the exact sum), and
# that factor scales the leaf's whole update; 2 ulp of an entry of size
# 1 (the layer-norm weights), where the updated entry rounds the other
# way, pass in any case
GPT2_UPDATE_RTOL = 1e-5
GPT2_UPDATE_ATOL = 2.4e-7
# HF GPT2LMHeadModel's per-layer keys → the port's (block, leaf)
GPT2_LAYER_KEYS = {
    "ln_1.weight": ("ln1", "scale"), "ln_1.bias": ("ln1", "bias"),
    "attn.c_attn.weight": ("attn_qkv", "kernel"),
    "attn.c_attn.bias": ("attn_qkv", "bias"),
    "attn.c_proj.weight": ("attn_proj", "kernel"),
    "attn.c_proj.bias": ("attn_proj", "bias"),
    "ln_2.weight": ("ln2", "scale"), "ln_2.bias": ("ln2", "bias"),
    "mlp.c_fc.weight": ("mlp_fc1", "kernel"),
    "mlp.c_fc.bias": ("mlp_fc1", "bias"),
    "mlp.c_proj.weight": ("mlp_fc2", "kernel"),
    "mlp.c_proj.bias": ("mlp_fc2", "bias")}
GPT2_TOP_KEYS = {"wte.weight": ("wte", "table"),
                 "wpe.weight": ("wpe", "table"),
                 "ln_f.weight": ("ln_f", "scale"),
                 "ln_f.bias": ("ln_f", "bias")}


def gpt2_shapes(cfg) -> dict:
    """The keys of HF ``GPT2LMHeadModel.state_dict()`` at ``cfg``'s
    widths, with their shapes (Conv1D weights ``(in, out)``)."""
    d, h = cfg.d_model, cfg.mlp_ratio * cfg.d_model
    layer = {"ln_1.weight": (d,), "ln_1.bias": (d,),
             "attn.c_attn.weight": (d, 3 * d), "attn.c_attn.bias": (3 * d,),
             "attn.c_proj.weight": (d, d), "attn.c_proj.bias": (d,),
             "ln_2.weight": (d,), "ln_2.bias": (d,),
             "mlp.c_fc.weight": (d, h), "mlp.c_fc.bias": (h,),
             "mlp.c_proj.weight": (h, d), "mlp.c_proj.bias": (d,)}
    out = {"transformer.wte.weight": (cfg.vocab, d),
           "transformer.wpe.weight": (cfg.seq_len, d)}
    for i in range(cfg.n_layers):
        out.update({f"transformer.h.{i}.{k}": s for k, s in layer.items()})
    out.update({"transformer.ln_f.weight": (d,),
                "transformer.ln_f.bias": (d,),
                "lm_head.weight": (cfg.vocab, d)})
    return out


def gpt2_state_dict(cfg, seed: int = 0) -> dict:
    """A GPT-2 checkpoint laid out as HF ``GPT2LMHeadModel.state_dict()``
    is (the ``transformer.`` prefix, Conv1D ``(in, out)`` weights),
    numpy fp32 drawn from ``np.random.RandomState(seed)``: every tensor
    N(0, 0.02), the layer-norm weights 1 + N(0, 0.02), ``wte`` scaled by
    4 (the decisive head of :func:`gpt2_small`), and ``lm_head.weight``
    the ``wte`` array itself (GPT-2's tied head)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for key, shape in gpt2_shapes(cfg).items():
        if key == "lm_head.weight":
            sd[key] = sd["transformer.wte.weight"]
            continue
        a = (rs.standard_normal(shape) * 0.02).astype(np.float32)
        if key.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            a += 1.0
        elif key == "transformer.wte.weight":
            a *= 4.0
        sd[key] = a
    return sd


def imported_leaf(params: dict, key: str) -> torch.Tensor:
    """The port tensor that HF key ``key`` was imported into."""
    key = key.removeprefix("transformer.")
    if key in GPT2_TOP_KEYS:
        block, leaf = GPT2_TOP_KEYS[key]
        return params[block][leaf]
    _, i, rest = key.split(".", 2)
    block, leaf = GPT2_LAYER_KEYS[rest]
    return params["blocks"][block][leaf][int(i)]


def gpt2_import_check(sd: dict, params: dict, cfg) -> None:
    """The imported config is GPT-2 small's, and every imported tensor
    equals its source bit for bit."""
    from torchbooster_tpu_torch.models.gpt import GPTConfig

    if cfg != GPTConfig():
        raise AssertionError(f"gpt2_import: config {cfg}, expected GPT-2 "
                             f"small's {GPTConfig()}")
    if "head" in params:
        raise AssertionError("gpt2_import: an untied head was imported")
    for key, want in sd.items():
        if key == "lm_head.weight":
            continue
        got = imported_leaf(params, key)
        if got.dtype != torch.float32 or got.device.type != "cuda" or \
                not torch.equal(got.cpu(), torch.from_numpy(want)):
            raise AssertionError(f"gpt2_import: {key} is not its source "
                                 f"bit for bit")


def gpt2_finetune_config(name: str):
    """``gpt2_train_config`` (GPT-2 small, batch 8 x 1024, bf16 over fp32
    masters, remat, chunked head, clip 1.0, ``synthetic_lm``) for
    ``GPT2_STEPS`` steps with optimizer ``name`` at ``GPT2_LR[name]``
    (lamb and lion keep gpt.yml's betas and decay; adafactor ignores
    them, as the JAX package does)."""
    import dataclasses

    conf = gpt2_train_config(GPT2_STEPS, sample_tokens=0)
    return dataclasses.replace(conf, optim=dataclasses.replace(
        conf.optim, name=name, lr=GPT2_LR[name]))


def gpt2_update_check(state, tx, loss_fn, batch, lr: float) -> dict:
    """One more update of the fine-tuned state at learning rate ``lr`` on
    the card, and the same update by the same optimizer on the CPU from
    the same fp32 params, gradients and optimizer state. Returns the
    largest difference of the updated params, and the largest of each
    leaf's difference over the largest entry of its update; raises where
    a leaf differs by more than ``GPT2_UPDATE_RTOL`` of that entry plus
    ``GPT2_UPDATE_ATOL``."""
    from torchbooster_tpu_torch.models.gpt import map_tensors
    from torchbooster_tpu_torch.utils import _paths, tree_leaves

    for p in tree_leaves(state.params):
        p.grad = None
    loss_fn(state.params, batch, state.generator)[0].backward()
    before = map_tensors(state.params, lambda t: t.detach().cpu())
    host = map_tensors(before, torch.clone)
    for p, q in zip(tree_leaves(host), tree_leaves(state.params)):
        p.grad = q.grad.cpu()
    host_opt = tx.init(host)
    host_opt.load_state_dict(state.optimizer.state_dict())
    for opt in (state.optimizer, host_opt):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    out = {"max_abs_err": 0.0, "max_rel_to_update": 0.0, "worst_leaf": None}
    for (path, p0), card, cpu in zip(_paths(before), tree_leaves(
            state.params), tree_leaves(host), strict=True):
        card = card.detach().cpu()
        err = (card - cpu).abs().max().item()
        scale = (card - p0).abs().max().item()
        rel = err / max(scale, 1e-30)
        if not err <= GPT2_UPDATE_RTOL * scale + GPT2_UPDATE_ATOL:
            raise AssertionError(
                f"one update on the card and on the CPU differ by {err} on "
                f"{path}, whose update reaches {scale} (rtol "
                f"{GPT2_UPDATE_RTOL}, atol {GPT2_UPDATE_ATOL})")
        if err > out["max_abs_err"]:
            out["max_abs_err"] = err
        if rel > out["max_rel_to_update"]:
            out.update(max_rel_to_update=rel, worst_leaf=path)
    return out


def gpt2_finetune(name: str, imported: dict, cfg, smi: str) -> tuple:
    """``GPT2_STEPS`` steps of ``utils.make_step`` from the imported
    params with optimizer ``name``; returns ``(report, flash launches by
    kernel and route, the fine-tuned params)``."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.models.gpt import map_tensors
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe

    conf = gpt2_finetune_config(name)
    loss_fn = recipe.make_loss(conf, cfg)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(
        map_tensors(imported, lambda t: t.clone()), tx,
        generator=conf.seed)
    step = utils.make_step(loss_fn, tx, clip=conf.clip)
    data = conf.dataset.make(Split.TRAIN, seq_len=cfg.seq_len + 1,
                             vocab=cfg.vocab)
    batches = utils.iter_loader(conf.loader.make(data, shuffle=True,
                                                 seed=conf.seed))

    def to_card(tokens):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens)).long()
        tokens = tokens.pin_memory().to(DEV, non_blocking=True)
        return {"ids": tokens[:, :-1], "labels": tokens[:, 1:]}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    losses, step_s = [], []
    for _ in range(GPT2_STEPS):
        batch = to_card(next(batches)[1])
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    by_route = {"fwd": dict(fa.launches_fwd_by_route),
                "dq": dict(fa.launches_dq_by_route),
                "dkv": dict(fa.launches_dkv_by_route)}
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt2_import {name}: losses {losses}")
    n_l = cfg.n_layers
    # the remat policy recomputes B1 (its output is no saved product)
    expected = {"fwd": 2 * n_l * GPT2_STEPS, "dq": n_l * GPT2_STEPS,
                "dkv": n_l * GPT2_STEPS}
    route_expected = {k: {"sm90": n, "mma_sync": 0, "f32": 0}
                      for k, n in expected.items()}
    if launches != expected or by_route != route_expected:
        raise AssertionError(f"gpt2_import {name}: flash launches "
                             f"{by_route}, expected {route_expected}")
    state_bytes = sum(v.numel() * v.element_size()
                      for leaf in state.optimizer.state.values()
                      for v in leaf.values())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in utils.tree_leaves(state.params))
    if name == "adafactor" and not state_bytes < 0.01 * param_bytes:
        raise AssertionError(f"gpt2_import adafactor: state {state_bytes} "
                             f"bytes against {param_bytes} of params: the "
                             f"moments did not factor")
    update = gpt2_update_check(state, tx, loss_fn,
                               to_card(next(batches)[1]), conf.optim.lr)
    # steady state: the median of steps 3-8
    steady = sorted(step_s[2:])
    step_ms = (steady[(len(steady) - 1) // 2]
               + steady[len(steady) // 2]) / 2 * 1e3
    out = {"lr": GPT2_LR[name], "losses": losses, "step_ms": step_ms,
           "step_ms_each": [s * 1e3 for s in step_s],
           "tokens_per_s": TRAIN_B * TRAIN_S / step_ms * 1e3,
           "peak_mem_bytes": peak, "optimizer_state_bytes": state_bytes,
           "param_bytes": param_bytes,
           "state_share_of_params": state_bytes / param_bytes,
           "launches": launches, "by_route": by_route,
           "update_vs_cpu": update,
           "update_tol": {"rtol": GPT2_UPDATE_RTOL,
                          "atol": GPT2_UPDATE_ATOL},
           "card": smi}
    log(f"gpt2_import {name} (lr {GPT2_LR[name]}): {GPT2_STEPS} steps at "
        f"batch {TRAIN_B} x {TRAIN_S}, {conf.env.precision}, remat "
        f"policy, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.1f} ms "
        f"(median of steps 3-{GPT2_STEPS}), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak mem {peak / 2**30:.2f} GiB, optimizer state "
        f"{state_bytes} bytes ({100 * out['state_share_of_params']:.3f}% "
        f"of the fp32 params' {param_bytes}); B1-B3 by route {by_route}; "
        f"one update at lr {conf.optim.lr}, card vs CPU: max abs err "
        f"{update['max_abs_err']:.3g}, at most "
        f"{update['max_rel_to_update']:.3g} of a leaf's largest update "
        f"entry ({update['worst_leaf']}; rtol {GPT2_UPDATE_RTOL}) [{smi}]")
    params = state.params
    del state
    return out, {**launches, "by_route": by_route}, params


def phase_gpt2_import(report: dict, smi: str) -> dict:
    """Import a GPT-2 small checkpoint in HF's layout, fine-tune it with
    lamb, lion and adafactor, and serve one fine-tuned model at bf16 and
    fp32. Returns the flash launch counts of the fine-tunes and the
    paged kernel's of the serving runs."""
    from torchbooster_tpu_torch.models.gpt import (
        GPTConfig,
        load_torch_gpt2,
        map_tensors,
    )

    t0 = time.perf_counter()
    sd = gpt2_state_dict(GPTConfig())
    imported, cfg = load_torch_gpt2(sd, device=DEV)
    gpt2_import_check(sd, imported, cfg)
    import_s = time.perf_counter() - t0
    n_params = sum(a.size for k, a in sd.items() if k != "lm_head.weight")
    log(f"gpt2_import: {len(sd)} HF tensors ({n_params} parameters, "
        f"lm_head tied) imported bit for bit into GPT-2 small "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.seq_len} positions), {import_s:.1f} s with the draw")
    del sd
    out: dict = {"import_s": import_s}
    flash = {"fwd": 0, "dq": 0, "dkv": 0,
             "by_route": {k: dict.fromkeys(("sm90", "mma_sync", "f32"), 0)
                          for k in ("fwd", "dq", "dkv")}}
    served = None
    for name in GPT2_LR:
        res, launches, params = gpt2_finetune(name, imported, cfg, smi)
        out[name] = res
        for k in ("fwd", "dq", "dkv"):
            flash[k] += launches[k]
            for r, n in launches["by_route"][k].items():
                flash["by_route"][k][r] += n
        if name == GPT2_SERVED:
            served = map_tensors(params, lambda t: t.detach())
        del params
        torch.cuda.empty_cache()
    del imported
    paged = {"launches": 0, "by_route": {"sm90": 0, "simt": 0}}
    for dtype, key in ((torch.bfloat16, "serve_bf16"),
                       (torch.float32, "serve_fp32")):
        sub: dict = {}
        match, launches, by_route = phase_serve(
            served, cfg, dtype, smi, sub, f"gpt2_import {key} "
            f"({GPT2_SERVED}-tuned)")
        out[key] = next(iter(sub.values()))
        if not all(match):
            raise AssertionError(f"gpt2_import {key}: the {GPT2_SERVED}-"
                                 f"tuned model disagrees with dense "
                                 f"generate on {match.count(False)} "
                                 f"requests")
        paged["launches"] += launches
        for r, n in by_route.items():
            paged["by_route"][r] += n
    out["served"] = GPT2_SERVED
    report["gpt2_import"] = out
    del served
    torch.cuda.empty_cache()
    return {"flash": flash, "paged": paged}


# ------------------------------------------------------------- train_long
LONG_STEPS = 12
LONG_SAVE_EVERY = 4
LONG_SAMPLE = 128
# gpt-long.yml's keys that phase train_long sets otherwise, and why
LONG_OVERRIDES = {
    "env.distributed": "one card; sp:8 takes one process a card",
    "env.mesh": "one card; sp:8 takes one process a card",
    "dataset.root": "the repo's *.py and *.md text, nothing fetched",
    "n_iter": "time", "scheduler.n_iter": "time",
    "scheduler.warmup": "the loss moves within 12 steps",
    "save_every": "saves at 4, 8 and 12", "checkpoint_root": "a temp dir",
    "log_every": "a record a step", "eval_batches": "time"}


def gpt_long_config(corpus, checkpoint_root, n_iter: int = LONG_STEPS):
    """``examples/lm/gpt/gpt-long.yml``'s values built in code (the card's
    machine reads no YAML), with the keys of ``LONG_OVERRIDES`` set for
    one card and a short run."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.gpt import Config, ModelConfig

    return Config(
        n_iter=n_iter, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=LONG_SAVE_EVERY, checkpoint_root=str(checkpoint_root),
        sample_tokens=LONG_SAMPLE, sample_temperature=0.8, sample_top_p=0.95,
        eval_batches=1,
        model=ModelConfig(vocab=256, n_layers=12, d_model=768, n_heads=16,
                          n_kv_heads=8, seq_len=8192, pos="rope",
                          dropout=0.1, remat=True, sp_strategy="auto",
                          chunked_head=True),
        env=EnvConfig(distributed=False, precision="bf16", mesh="dp"),
        loader=LoaderConfig(batch_size=8, num_workers=0, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                              decay_matrices_only=True),
        scheduler=SchedulerConfig(name="cycle", n_iter=n_iter, warmup=2,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="text_file", root=str(corpus)))


def repo_corpus(path: Path) -> int:
    """Every ``*.py`` and ``*.md`` file of this checkout, concatenated in
    sorted path order into ``path`` (hidden directories and build
    outputs left out); returns its bytes."""
    root = Path(__file__).resolve().parent
    skip = {"build", "chiprun_out", "chip_checkout", "__pycache__"}
    files = sorted(f for ext in ("*.py", "*.md") for f in root.rglob(ext)
                   if not any(part.startswith(".") or part in skip
                              for part in f.relative_to(root).parts))
    with path.open("wb") as out:
        for f in files:
            out.write(f.read_bytes())
    return path.stat().st_size


def long_flops_per_step(cfg, n_params: int, b: int) -> dict:
    """Model FLOPs a step: 6 x parameters x tokens for the matmuls (the
    tied head counted once) plus causal attention's products, 2 D per
    visible (query, key) pair each: 2 in the forward and 5 in the
    backward (dV, dP, dQ, dK and the recomputed scores). The remat
    recompute and the backward kernels' second recompute are not
    counted."""
    s, d = cfg.seq_len, cfg.head_dim
    dense = 6.0 * n_params * b * s
    product = 2.0 * d * visible_pairs(s, s, True) * b * cfg.n_heads
    attn = 7 * product * cfg.n_layers
    return {"dense": dense, "attention": attn, "total": dense + attn,
            "causal_product": product}


def reset_flash_counts() -> None:
    from torchbooster_tpu_torch.ops import attention as at
    from torchbooster_tpu_torch.ops import flash_attention as fa

    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    for counts in (fa.launches_fwd_by_route, fa.launches_dq_by_route,
                   fa.launches_dkv_by_route):
        for route in counts:
            counts[route] = 0
    at.reference_calls = 0


def state_diff(a, b) -> dict:
    """Leaves of two train states that differ, by name: parameters,
    AdamW's moments and step count, the step and the generator state."""
    from torchbooster_tpu_torch.utils import tree_leaves

    out = {}
    for i, (x, y) in enumerate(zip(tree_leaves(a.params),
                                   tree_leaves(b.params), strict=True)):
        if not torch.equal(x, y):
            out[f"param{i}"] = (x - y).abs().max().item()
    sa, sb = a.optimizer.state_dict()["state"], \
        b.optimizer.state_dict()["state"]
    for i in sa:
        for key in sa[i]:
            if not torch.equal(sa[i][key], sb[i][key]):
                out[f"optimizer{i}.{key}"] = (
                    sa[i][key] - sb[i][key]).abs().max().item()
    if a.step != b.step:
        out["step"] = (a.step, b.step)
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        out["generator"] = "differs"
    return out


def long_dropout_checks(t, batch) -> dict:
    """The dropout rules on the trainer's params and one batch: the same
    generator state gives the same loss bit for bit (the training
    forward, remat on), another state another loss; the eval loss (no
    generator) equals a dropout-0 forward bit for bit."""
    import dataclasses

    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.ops.losses import lm_head_cross_entropy

    gen = t.state.generator
    start = gen.get_state()
    losses = []
    for _ in range(2):
        gen.set_state(start)
        losses.append(t.loss_fn(t.state.params, batch, gen)[0].detach())
    moved = t.loss_fn(t.state.params, batch, gen)[0].detach()
    gen.set_state(start)
    with torch.no_grad():
        evaluated = t.loss_fn(t.state.params, batch, None)[0]
        cfg0 = dataclasses.replace(t.cfg, dropout=0.0)
        hidden = GPT.apply(t.state.params, batch["ids"], cfg0,
                           compute_dtype=t.conf.env.compute_dtype(),
                           return_hidden=True, generator=gen)
        plain = lm_head_cross_entropy(hidden, GPT.head_table(t.state.params),
                                      batch["labels"])
    gen.set_state(start)
    out = {"same_state": [x.item() for x in losses],
           "other_state": moved.item(), "eval": evaluated.item(),
           "dropout0": plain.item()}
    if not torch.equal(losses[0], losses[1]):
        raise AssertionError(f"train_long: one generator state, two losses "
                             f"{out['same_state']}")
    if torch.equal(moved, losses[0]):
        raise AssertionError("train_long: a moved generator gave the same "
                             "loss: no dropout was drawn")
    if not torch.equal(evaluated, plain):
        raise AssertionError(f"train_long: eval loss {out['eval']} is not "
                             f"the dropout-0 loss {out['dropout0']}")
    return out


def long_breakdown(t, n_steps: int = 2) -> dict:
    """``n_steps`` more steps of a trainer under the profiler (CUDA
    activity): device busy share of the wall time, B1-B3's share of the
    device time and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    batches = [t.batch(next(t.batches)[1]) for _ in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            t.state, m = t.step(t.state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    # B1-B3 on either bf16 route (D 48: "sm90")
    names = (f"flash_{kern}_{route}" for kern in ("fwd", "dq", "dkv")
             for route in ("mma", "sm90"))
    flash = {name: t for name in names
             if (t := sum(v for k, v in per_kernel if f"::{name}<" in k))}
    return {"steps": n_steps, "wall_s": wall, "step_ms": wall / n_steps * 1e3,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3,
            "flash_ms_per_step": {k: v / n_steps * 1e3
                                  for k, v in flash.items()},
            "flash_share_of_device": sum(flash.values()) / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:12]}


def phase_train_long(report: dict, smi: str) -> dict:
    """The GPT recipe's ``main`` at ``gpt-long.yml``'s widths on one card
    (batch 8 x 8192 bytes of the repo's own text, 12 layers, d_model 768,
    16 heads over 8 kv heads, rope, dropout 0.1, remat, chunked head,
    AdamW with decay on matrices only, a cos/cos cycle), 12 steps with a
    checkpoint every 4, one validation batch and a 128-token top-p
    sample; then the resume, dropout and breakdown checks. Returns the
    flash launch counts of the ``main`` run."""
    import tempfile

    from torchbooster_tpu_torch.data.tokenizer import ByteTokenizer
    from torchbooster_tpu_torch.ops import attention as at
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe
    from torchbooster_tpu_torch.utils import tree_leaves

    with tempfile.TemporaryDirectory(prefix="train_long_") as tmp:
        tmp = Path(tmp)
        corpus_bytes = repo_corpus(tmp / "corpus.txt")
        conf = gpt_long_config(tmp / "corpus.txt", tmp / "checkpoints")
        cfg = conf.model.make()
        b, s = conf.loader.batch_size, cfg.seq_len
        # the validation split (5%) must hold one batch of windows
        need = math.ceil(b * (s + 1) / 0.05)
        if corpus_bytes < need:
            raise AssertionError(f"train_long: corpus of {corpus_bytes} "
                                 f"bytes; one validation batch needs {need}")
        t1 = recipe.setup(conf)
        if t1.start_iter != 0:
            raise AssertionError("train_long: a fresh directory resumed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        t0 = time.perf_counter()
        res = recipe.run(t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                    "dkv": fa.launches_dkv}
        by_route = {"fwd": dict(fa.launches_fwd_by_route),
                    "dq": dict(fa.launches_dq_by_route),
                    "dkv": dict(fa.launches_dkv_by_route)}
        reference_calls = at.reference_calls
        peak = torch.cuda.max_memory_allocated()

        # 1. attention routes: per step B1 twice a layer (remat), B2 and B3
        # once; one B1 a layer for the eval batch and for the sample's
        # prefill; at bf16 D 48, B1-B3 on "sm90"; never the reference
        n_l = cfg.n_layers
        expected = {"fwd": 2 * n_l * LONG_STEPS + 2 * n_l,
                    "dq": n_l * LONG_STEPS, "dkv": n_l * LONG_STEPS}
        routes = {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"}
        route_expected = {
            k: {**dict.fromkeys(("sm90", "mma_sync", "f32"), 0),
                routes[k]: n} for k, n in expected.items()}
        if launches != expected or by_route != route_expected:
            raise AssertionError(f"train_long: flash launches {by_route}, "
                                 f"expected {route_expected}")
        if reference_calls:
            raise AssertionError(f"train_long: mha_reference called "
                                 f"{reference_calls} times")
        # 2. the loss: finite, and the mean of the last 3 below the first
        losses = [r["loss"] for r in res["log"]]
        if len(losses) != LONG_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_long: losses {losses}")
        if not sum(losses[-3:]) / 3 < losses[0]:
            raise AssertionError(f"train_long: the loss did not fall: "
                                 f"{losses}")
        # 4. checkpoints at 4, 8 and 12 under the JAX path scheme
        names = sorted(p.name for p in (tmp / "checkpoints").iterdir())
        want_names = [f"ckpt_{i:02d}" for i in range(
            LONG_SAVE_EVERY, LONG_STEPS + 1, LONG_SAVE_EVERY)]
        if names != want_names:
            raise AssertionError(f"train_long: checkpoints {names}, "
                                 f"expected {want_names}")
        saves = [{k: r[k] for k in ("step", "block_s", "bytes", "write_s")}
                 for r in t1.save_cb.saves]
        # 5. the sample: 8 prompt + 128 new byte tokens
        sample = res["sample"]
        if len(sample) != 8 + LONG_SAMPLE or not all(
                0 <= i < 256 for i in sample):
            raise AssertionError(f"train_long: sample {sample}")
        text = ByteTokenizer().decode(sample)

        el = [r["elapsed_s"] for r in res["log"]]
        # steps 3-12: the time between the records of steps 2 and 12
        step_s = sorted(el[i] - el[i - 1] for i in range(2, LONG_STEPS))
        step_med = step_s[len(step_s) // 2 - 1: len(step_s) // 2 + 1]
        step_med = sum(step_med) / len(step_med)
        n_params = sum(p.numel() for p in tree_leaves(t1.state.params))
        flops = long_flops_per_step(cfg, n_params, b)
        out = {"losses": losses, "val_loss": res.get("val_loss"),
               "launches": launches, "by_route": by_route,
               "expected": expected, "reference_calls": reference_calls,
               "main_wall_s": wall, "step_ms_median": step_med * 1e3,
               "step_ms": [x * 1e3 for x in step_s],
               "tokens_per_s": b * s / step_med, "n_params": n_params,
               "flops": flops,
               "mfu_of_989_tflops": flops["total"] / step_med / BF16_FLOPS,
               "peak_mem_bytes": peak, "corpus_bytes": corpus_bytes,
               "checkpoints": names, "saves": saves, "sample": sample,
               "sample_text": text, "overrides": LONG_OVERRIDES,
               "card": smi}
        log(f"train_long: gpt-long.yml at one card (overrides: "
            + "; ".join(f"{k} ({v})" for k, v in LONG_OVERRIDES.items())
            + f"); corpus {corpus_bytes} bytes; {n_params / 1e6:.2f} M "
            f"params; loss {losses[0]:.4f} -> {losses[-1]:.4f} (last 3 "
            f"mean {sum(losses[-3:]) / 3:.4f}); val loss "
            f"{res.get('val_loss', float('nan')):.4f}; step "
            f"{out['step_ms_median']:.1f} ms (median of steps 3-12), "
            f"{out['tokens_per_s']:.0f} tokens/s, model FLOP share "
            f"{100 * out['mfu_of_989_tflops']:.2f}% of 989 TFLOP/s "
            f"({flops['dense'] / 1e12:.1f} TFLOP dense + "
            f"{flops['attention'] / 1e12:.1f} TFLOP causal attention a "
            f"step), peak mem {peak / 2**30:.2f} GiB; flash launches "
            f"{by_route}, mha_reference calls {reference_calls} [{smi}]")
        log("train_long checkpoints: " + ", ".join(names) + "; " + "; ".join(
            f"step {r['step']}: {r['bytes']} bytes, {r['block_s'] * 1e3:.1f} "
            f"ms blocking (device to host), {r['write_s'] * 1e3:.1f} ms "
            f"background write" for r in saves))
        log(f"train_long sample ({len(sample)} tokens): {text!r}")

        # 4. resume: a fresh setup restores step 12 bit for bit, and one
        # more step on one batch from both trainers agrees bit for bit
        t2 = recipe.setup(conf)
        if (t2.start_iter, t2.state.step) != (LONG_STEPS, LONG_STEPS):
            raise AssertionError(f"train_long: resumed at {t2.start_iter}")
        diff = state_diff(t1.state, t2.state)
        if diff:
            raise AssertionError(f"train_long: the restored state differs: "
                                 f"{diff}")
        batch = t1.batch(next(t1.batches)[1])
        t1.state, m1 = t1.step(t1.state, batch)
        t2.state, m2 = t2.step(t2.state, batch)
        after = state_diff(t1.state, t2.state)
        same_loss = torch.equal(m1["loss"], m2["loss"])
        if after or not same_loss:
            raise AssertionError(f"train_long: one step from the original "
                                 f"and the restored trainer: losses "
                                 f"{m1['loss'].item()} / {m2['loss'].item()}"
                                 f", leaves that differ {after}")
        out["resume"] = {"step": t2.state.step, "loss": m1["loss"].item(),
                         "bit_identical": True}
        log(f"train_long resume: setup restored step {LONG_STEPS}, params, "
            f"AdamW moments, step and generator bit for bit; one more step "
            f"from both: loss {m1['loss'].item():.6f}, state bit for bit")
        del t2
        torch.cuda.empty_cache()

        # 3. dropout: reproducible, and off without a generator
        drop = out["dropout"] = long_dropout_checks(t1, batch)
        log(f"train_long dropout: one generator state twice "
            f"{drop['same_state'][0]:.6f} / {drop['same_state'][1]:.6f} "
            f"(bit for bit), a moved state {drop['other_state']:.6f}; eval "
            f"{drop['eval']:.6f} = dropout 0 {drop['dropout0']:.6f} (bit for "
            f"bit)")

        bd = out["breakdown"] = long_breakdown(t1)
        log(f"train_long profiled: {bd['steps']} steps, "
            f"{bd['step_ms']:.1f} ms/step, device "
            f"{bd['device_ms_per_step']:.1f} ms/step, busy "
            f"{100 * bd['device_busy_share']:.1f}%, "
            f"{bd['kernels_per_step']:.0f} kernels a step; B1-B3 "
            f"{100 * bd['flash_share_of_device']:.1f}% of device time ("
            + ", ".join(f"{k} {v:.1f} ms" for k, v in
                        bd["flash_ms_per_step"].items())
            + " a step); top: " + "; ".join(
                f"{k[:60]} {v * 1e3:.1f} ms" for k, v in bd["top"][:6]))
        del t1
        torch.cuda.empty_cache()
    report["train_long"] = out
    return {**launches, "by_route": by_route}


# ------------------------------------------------------------- serve_long
def long_prompts(corpus: Path, rs) -> list:
    """One byte window of the repo's text a length of LONG_PROMPT_LENS,
    each at an offset drawn from ``rs``: byte tokens, as gpt-long.yml's
    ``text_file`` gives them."""
    data = np.frombuffer(corpus.read_bytes(), np.uint8)
    prompts = []
    for n in LONG_PROMPT_LENS:
        at = int(rs.randint(0, data.size - n))
        prompts.append(data[at:at + n].astype(np.int32))
    return prompts


def long_model():
    """gpt-long.yml's model through ``Config.load`` (checked against
    ``LONG_MODEL``), random weights of seed 42 with the decisive tied head
    (x4), and its requests: the 8 windows of the repo's text of
    :func:`long_prompts`, ``N_NEW`` new tokens each. Returns ``(params,
    cfg, make_reqs, corpus_bytes)``; ``make_reqs()`` gives fresh
    requests."""
    import tempfile

    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.recipes.gpt import Config
    from torchbooster_tpu_torch.serving import Request

    with tempfile.TemporaryDirectory(prefix="serve_long_") as tmp:
        corpus = Path(tmp) / "corpus.txt"
        corpus_bytes = repo_corpus(corpus)
        prompts = long_prompts(corpus, np.random.RandomState(42))
    cfg = Config.load(Path(__file__).resolve().parent / "examples" / "lm"
                      / "gpt" / "gpt-long.yml").model.make()
    if {k: getattr(cfg, k) for k in LONG_MODEL} != LONG_MODEL:
        raise AssertionError(f"serve_long: not gpt-long.yml's model: {cfg}")
    params = GPT.init(42, cfg, device=DEV)
    params["wte"]["table"] *= 4.0       # decisive head

    def make_reqs():
        return [Request(prompt=p, max_new_tokens=N_NEW,
                        request_id=f"long{i}")
                for i, p in enumerate(prompts)]

    return params, cfg, make_reqs, corpus_bytes


def phase_serve_long(report: dict, smi: str) -> dict:
    """gpt-long served on one card: ``examples/lm/gpt/gpt-long.yml``'s
    model through ``Config.load`` at full width and depth (12 layers,
    d_model 768, 16 heads over 8 kv heads of 48, rope, vocab 256),
    random weights of seed 42 in bf16 with the decisive tied head (x4),
    served by :func:`serve` over a 1025-page pool: 8 greedy requests,
    prompts of 1024-8000 bytes of the repo's text, 32 new tokens each.
    Gates beside :func:`serve`'s: the engine's construction check plans
    B4's ``"sm90"``; every stream token-exact against the dense
    ``generate``, whose prefill runs B1 at D 48 on ``"sm90"`` (12 a
    call). Reports decode tok/s, TTFT p50/p99, ms a decode step, peak
    memory, and from the decode-only tail of a replay
    (:func:`device_breakdown`) B4's µs a call and share of device time
    and the busy share. Returns B4's launches of the served run and B1's
    of the dense control."""
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    # wall seconds of each part of the phase
    t0, sec = time.perf_counter(), {}

    def lap(name):
        nonlocal t0
        sec[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    params, cfg, make_reqs, corpus_bytes = long_model()
    prompts = [r.prompt for r in make_reqs()]
    planned = pa.check_paged(torch.bfloat16, torch.bfloat16, cfg.head_dim,
                             PS, 1, cfg.n_heads // cfg.kv_heads)
    if planned != "sm90":
        raise AssertionError(f"serve_long: the engine's check planned "
                             f"{planned!r}, not 'sm90'")
    lap("setup")
    batcher, reqs, m, launches, by_route = serve(
        params, cfg, torch.bfloat16, make_reqs(), n_pages=LONG_N_PAGES)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (batcher.engine.pool["k"],
                               batcher.engine.pool["v"]))
    steps = launches // cfg.n_layers
    decoded = sum(len(r.tokens) - 1 for r in reqs)
    decode_ms = decoded / m["decode_tok_s"] / steps * 1e3
    ttft = [r.first_token_at - r.arrival for r in reqs]
    lap("serve")

    # the control: the dense generate, B1 at D 48 in each call's prefill
    reset_flash_counts()
    dense, dc = dense_tokens(params, cfg, reqs, torch.bfloat16, n_new=N_NEW)
    torch.cuda.synchronize()
    b1 = flash_counts()
    calls = len(reqs) + 2            # each request, the repeat, generate
    want_b1 = {**dict.fromkeys(("sm90", "mma_sync", "f32"), 0),
               "sm90": cfg.n_layers * calls}
    if (b1["fwd"], b1["dq"], b1["dkv"]) != (cfg.n_layers * calls, 0, 0) \
            or b1["by_route"]["fwd"] != want_b1:
        raise AssertionError(f"serve_long dense control: flash launches "
                             f"{b1}, expected B1 {want_b1}")
    match = [r.tokens == d for r, d in zip(reqs, dense)]
    if not all(match):
        raise AssertionError(f"serve_long: {match.count(False)} of "
                             f"{len(match)} streams differ from the dense "
                             f"generate: " + "; ".join(
                                 f"{r.request_id} {r.tokens} vs {d}"
                                 for r, d in zip(reqs, dense)
                                 if r.tokens != d))
    lap("dense_control")

    win = device_breakdown(batcher, cfg, make_reqs(), decode_only=True)
    lap("replay")
    out = {"metrics": m, "launches": launches, "by_route": by_route,
           "decode_steps": steps, "decoded_tokens": decoded,
           "decode_ms_per_step": decode_ms,
           "ttft_s": ttft, "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "peak_mem_bytes": m["peak_mem_bytes"], "pool_bytes": pool_bytes,
           "prompt_lens": [len(p) for p in prompts],
           "corpus_bytes": corpus_bytes, "token_match": match,
           "dense_control": dc, "dense_b1": b1, "decode_window": win,
           "seconds": sec, "card": smi}
    report["serve_long"] = out
    log(f"serve_long: gpt-long.yml's model ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.kv_heads} of "
        f"{cfg.head_dim}, {cfg.pos}, vocab {cfg.vocab}; random weights, seed "
        f"42, bf16, tied head x4) over a {LONG_N_PAGES}-page pool of {PS} "
        f"tokens ({pool_bytes / 1e9:.3f} GB), {len(reqs)} requests of "
        f"{min(LONG_PROMPT_LENS)}-{max(LONG_PROMPT_LENS)} prompt bytes of "
        f"repo text, {N_NEW} new each: {sum(match)}/{len(match)} token-"
        f"exact vs dense generate (B1 {b1['by_route']['fwd']}); decode "
        f"{m['decode_tok_s']} tok/s, {decode_ms:.3f} ms a decode step "
        f"({steps} steps, decode compiles {batcher.engine.decode_compiles}"
        f"), TTFT p50 {out['ttft_p50_s']:.4f} s / p99 "
        f"{out['ttft_p99_s']:.4f} s, peak mem "
        f"{m['peak_mem_bytes'] / 2**30:.2f} GiB; B4 by route {by_route} "
        f"[{smi}]")
    log(f"serve_long decode-only tail of a replay, profiled: "
        f"{win['steps']} steps, {win['wall_ms_per_step']:.3f} ms a step, "
        f"device {win['device_ms_per_step']:.3f} ms a step (busy "
        f"{100 * win['device_busy_share']:.1f}%), B4 "
        f"{win['paged_us_per_call']:.2f} us a call ({win['b4_calls']} "
        f"calls), {win['paged_kernel_s'] / win['steps'] * 1e3:.3f} ms a "
        f"step ({100 * win['paged_share_of_device']:.1f}% of device time); "
        f"top a step: " + "; ".join(
            f"{kernel_name(k)[:48]} {v / win['steps'] * 1e3:.3f} ms"
            for k, v in win["top"][:6]))
    log(f"serve_long dense control: jit_generate {dc['ms_per_token']:.3f} "
        f"ms a new token (prefill included; batch 1, {dc['requests']} "
        f"requests, {dc['n_new']} new each), {dc['shapes']} cached shapes; "
        f"phase parts " + ", ".join(f"{k} {v:.1f} s" for k, v in sec.items())
        + f" [{smi}]")
    del batcher, params
    torch.cuda.empty_cache()
    return {"paged": {"launches": launches, "by_route": by_route},
            "flash": {k: b1[k] for k in ("fwd", "dq", "dkv", "by_route")}}


# ------------------------------------------------------------ serve_graph
# the order of a cell's runs: a pair timed by the host clock, then a pair
# under the profiler, each mode first once
GRAPH_RUNS = (("graph", False), ("eager", False), ("eager", True),
              ("graph", True))


# the one-pair cells at GPT-2 small beside serve_bf16's: (name, dtype, the
# engine's options, the prompts' kind, B4's route); each pair's gates are
# graph_cell's
GRAPH_PAIR = (("graph", False), ("eager", False))
GRAPH_MORE = (
    ("gpt2_fp32", torch.float32, {}, "trace", "simt"),
    ("gpt2_chain", torch.bfloat16,
     dict(speculative=True, draft_len=DRAFT_LEN), "repetitive", "sm90"),
    ("gpt2_tree", torch.bfloat16,
     dict(speculative=True, draft_len=DRAFT_LEN, spec_tree=True,
          spec_tree_width=2), "ambiguous", "sm90"),
    ("gpt2_sampled", torch.bfloat16, dict(temperature=0.8, top_k=50),
     "trace", "sm90"))


def graph_cell(name, params, cfg, make_reqs, n_pages: int,
               dtype: torch.dtype = torch.bfloat16, runs=GRAPH_RUNS,
               route: str = "sm90", **engine_kw) -> dict:
    """One trace through two batchers of one configuration
    (``ServingConfig(..., **engine_kw)`` at ``dtype``), one captured and
    one under ``eager_steps()``, in the order of ``runs``, each run's
    decode-only tail through :func:`device_breakdown`: a pair timed by
    the host clock, a pair profiled (busy share, device ms a step, B4 µs
    a call). Sampled engines draw from their generators from the seed
    on, so a sampled cell runs one pair, each engine's first run. Gates:
    every run's streams equal; every run's B4 launches equal by route,
    all on ``route``; the captured engine one graph a step kind (decode;
    verify, and compaction in tree mode), one signature each, and
    replays, the eager twin none."""
    from contextlib import nullcontext

    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving import eager_steps
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    make = lambda: ServingConfig(page_size=PS, n_pages=n_pages,
                                 max_slots=SLOTS, **engine_kw).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    batchers = {"graph": make(), "eager": make()}
    out = []
    for mode, profiled in runs:
        b, reqs = batchers[mode], make_reqs()
        before = b4_counts(pa)
        with eager_steps() if mode == "eager" else nullcontext():
            run = device_breakdown(b, cfg, reqs, decode_only=True,
                                   profiled=profiled)
        torch.cuda.synchronize()
        n, by_route = b4_delta(pa, before)
        out.append({**run, "mode": mode, "profiled": profiled, "b4": n,
                    "b4_by_route": by_route,
                    "streams": [list(r.tokens) for r in reqs]})
    first = out[0]
    for r in out[1:]:
        if r["streams"] != first["streams"]:
            raise AssertionError(f"serve_graph {name}: the {r['mode']} run "
                                 f"(profiled {r['profiled']}) differs from "
                                 f"the first captured run")
        if r["b4_by_route"] != first["b4_by_route"]:
            raise AssertionError(f"serve_graph {name}: B4 by route "
                                 f"{r['b4_by_route']} ({r['mode']}) vs "
                                 f"{first['b4_by_route']}")
    if first["b4_by_route"][route] != first["b4"] or first["b4"] <= 0:
        raise AssertionError(f"serve_graph {name}: B4 {first['b4_by_route']}"
                             f", not all {route!r}")
    g, e = batchers["graph"].engine, batchers["eager"].engine
    kinds = ({"verify", "compact"} if g.spec_tree else {"verify"}) \
        if g.speculative else {"decode"}
    compiles = (g.verify_compiles, g.decode_compiles) if g.speculative \
        else (g.decode_compiles, g.verify_compiles)
    if g.step_route != "graph" or compiles != (1, 0) \
            or sorted(k for k, _ in g._graphs) != sorted(kinds) \
            or g.graph_replays <= 0 or e.graph_replays or e._graphs:
        raise AssertionError(f"serve_graph {name}: captured engine "
                             f"{g.debug_stats()['compiles']}, eager twin "
                             f"{e.debug_stats()['compiles']}")
    n_requests = len(first["streams"])
    for r in out:
        del r["streams"]
    cell = {"runs": out, "requests": n_requests, "dtype": str(dtype),
            "options": engine_kw, "graphs": sorted(kinds),
            "graph_replays": g.graph_replays}
    if g.speculative:
        cell["spec_accepted"] = (g.spec_accepted, e.spec_accepted)
        cell["spec_proposed"] = (g.spec_proposed, e.spec_proposed)
        if g.spec_accepted != e.spec_accepted or g.spec_accepted <= 0:
            raise AssertionError(f"serve_graph {name}: accepted drafts "
                                 f"{cell['spec_accepted']}")
    return cell


def jit_vs_generate(params, cfg, reqs, n_new: int = N_NEW) -> dict:
    """The dense decode at batch 1 over ``reqs``, bf16, in turns
    (``jit_generate``, ``generate``, ``generate``, ``jit_generate``; one
    ``jit_generate`` fn): ms a new token each (prefill included; the
    first turn also captures each shape). Gates: every turn's ids equal
    ``generate``'s; the fn holds one shape a prompt length; a fresh fn
    over two prompts of one shape holds one (``_cache_size() == 1``) and
    gives ``generate``'s ids for both."""
    from torchbooster_tpu_torch.models.gpt import generate, jit_generate

    kw = dict(n_new=n_new, temperature=0.0, compute_dtype=torch.bfloat16)
    fn = jit_generate(cfg, **kw)
    plain = lambda p, ids: generate(p, ids, cfg, **kw)
    turns, outs = [], []
    for name, call in (("jit_generate", fn), ("generate", plain),
                       ("generate", plain), ("jit_generate", fn)):
        out, request_s = [], []
        for r in reqs:
            ids = torch.as_tensor(r.prompt, device="cuda").long()[None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = call(params, ids)
            torch.cuda.synchronize()
            request_s.append(time.perf_counter() - t0)
            out.append(full[0, ids.shape[1]:].tolist())
        turns.append({"fn": name, "request_s": request_s,
                      "ms_per_token": ms_per_token(request_s, n_new)})
        outs.append(out)
    if any(out != outs[1] for out in outs):
        raise AssertionError("serve_graph: jit_generate's ids differ from "
                             "generate's")
    shapes = len({len(r.prompt) for r in reqs})
    if fn._cache_size() != shapes:
        raise AssertionError(f"serve_graph: jit_generate {fn._cache_size()}"
                             f" shapes for {shapes} prompt lengths")
    one = jit_generate(cfg, **kw)
    for r in reqs[:2]:
        ids = torch.as_tensor(r.prompt[:64], device="cuda").long()[None]
        if not torch.equal(one(params, ids), plain(params, ids)):
            raise AssertionError("serve_graph: a replayed shape differs "
                                 "from generate")
    if one._cache_size() != 1:
        raise AssertionError(f"serve_graph: one shape cached "
                             f"{one._cache_size()} times")
    return {"turns": turns, "shapes": shapes, "one_shape_cache": 1}


def phase_serve_graph(report: dict, smi: str) -> dict:
    """The captured serving steps against their eager twins on one card,
    in repeated pairs: serve_bf16's trace (GPT-2 small, 8 requests of
    64-512 tokens, 32 new) and serve_long's (gpt-long, 8 requests of
    1024-8000 bytes, 32 new), each through a captured bf16 batcher and
    one under ``eager_steps()`` (:func:`graph_cell`), then the dense
    decode, ``jit_generate`` against ``generate``, over serve_bf16's
    trace (:func:`jit_vs_generate`). Returns B4's launches and B1's (the
    dense decodes' prefills)."""
    from torchbooster_tpu_torch.serving import Request
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    reset_flash_counts()
    reset_paged_counts()
    params, cfg = gpt2_small()
    cells = {"gpt2_bf16": graph_cell("gpt2_bf16", params, cfg,
                                     lambda: requests(cfg), N_PAGES)}
    for name, dtype, kw, kind, route in GRAPH_MORE:
        rs = np.random.RandomState(7)
        prompts = [ambiguous_prompt(params, cfg, dtype, rs, n)
                   if kind == "ambiguous" else repetitive_prompt(
                       rs, n, cfg.vocab) for n in PROMPT_LENS] \
            if kind != "trace" else None
        make_reqs = (lambda: requests(cfg)) if prompts is None else (
            lambda: [Request(prompt=p, max_new_tokens=N_NEW,
                             request_id=f"r{i}")
                     for i, p in enumerate(prompts)])
        cells[name] = graph_cell(name, params, cfg, make_reqs, N_PAGES,
                                 dtype=dtype, runs=GRAPH_PAIR, route=route,
                                 **kw)
    dense = jit_vs_generate(params, cfg, requests(cfg))
    del params
    torch.cuda.empty_cache()
    params, cfg_long, make_reqs, _ = long_model()
    cells["gpt_long"] = graph_cell("gpt_long", params, cfg_long, make_reqs,
                                   LONG_N_PAGES)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    b1 = flash_counts()
    report["serve_graph"] = {"cells": cells, "dense": dense, "b1": b1,
                             "card": smi}
    for name, cell in cells.items():
        for r in cell["runs"]:
            if r["profiled"]:
                log(f"serve_graph {name} {r['mode']}, profiled decode-only "
                    f"tail: {r['steps']} steps, {r['wall_ms_per_step']:.3f} "
                    f"ms a step, device {r['device_ms_per_step']:.3f} ms a "
                    f"step (busy {100 * r['device_busy_share']:.1f}%), B4 "
                    f"{r['paged_us_per_call']:.2f} us a call [{smi}]")
            else:
                log(f"serve_graph {name} {r['mode']}: decode-only tail "
                    f"{r['steps']} steps, {r['wall_ms_per_step']:.3f} ms a "
                    f"step, "
                    f"{r['tok_s']:.1f} tok/s ({r['tokens']} tokens); B4 by "
                    f"route {r['b4_by_route']} over the whole run [{smi}]")
        spec = (f"; accepted drafts {cell['spec_accepted']} of "
                f"{cell['spec_proposed']} (captured, eager)"
                if "spec_accepted" in cell else "")
        log(f"serve_graph {name} ({cell['dtype']}, {cell['options']}): "
            f"{len(cell['runs'])} runs token-exact and B4 by route equal "
            f"(captured and eager_steps(), in turns); graphs "
            f"{cell['graphs']}, {cell['graph_replays']} replays{spec}")
    log("serve_graph dense decode (GPT-2 small bf16, batch 1, 8 requests, "
        f"{N_NEW} new): " + ", ".join(
            f"{t['fn']} {t['ms_per_token']:.3f}" for t in dense["turns"])
        + f" ms a new token (prefill included), token-exact; "
        f"{dense['shapes']} cached shapes, one shape cached once [{smi}]")
    return {"paged": {"launches": pa.launches,
                      "by_route": dict(pa.launches_by_route)},
            "flash": {k: b1[k] for k in ("fwd", "dq", "dkv", "by_route")}}


# ----------------------------------------------------------- train_comms
COMMS_STEPS = 6
# (name, (stage, wire, overlap)); "implicit" is the recipe's own path, no
# comms: block, the gradient all-reduced over the data axes
COMMS_LADDER = (("implicit", None), ("s0_fp32", (0, "fp32", False)),
                ("s0_bf16", (0, "bf16", False)), ("s0_int8", (0, "int8", False)),
                ("s1_fp32", (1, "fp32", False)), ("s1_int8", (1, "int8", False)),
                ("s2_fp32_off", (2, "fp32", False)),
                ("s2_fp32_on", (2, "fp32", True)),
                ("s2_int8_on", (2, "int8", True)),
                ("s3_fp32", (3, "fp32", True)), ("s3_int8", (3, "int8", True)))
# the ladder runs without clipping: at world 1 the fp32 wires then give
# the implicit run's parameters bit for bit (the elementwise AdamW over a
# flat shard is the per-leaf update of the same elements). The one
# difference clipping makes — the global norm summed over a flat shard
# rather than leaf by leaf, a last-bit change of the clip scale —
# reaches the bf16 casts of the weights and grows into lr-sized
# differences of single entries within a few steps (tiny GPT on the
# CPU: 6e-4 after 6 steps); the checkpoint run and the recipe run clip
COMMS_PARAM_ATOL = 1e-6
COMMS_INT8_RTOL = 5e-3          # JAX's tracking bound, tests/test_comms.py:193
COMMS_CKPT = ("s2_int8_on", (2, "int8", True))
COMMS_BACKEND = "nccl"          # on the card: no gloo, no group-less run
# the profiler's names of the collectives (NCCL 2.28 under torch 2.11:
# "_reduce_scatter_base", "_all_gather_base"), by kind
NCCL_KINDS = {"all_reduce": "all_reduce",
              "_reduce_scatter_base": "reduce_scatter",
              "reduce_scatter": "reduce_scatter",
              "reduce_scatter_tensor": "reduce_scatter",
              "all_to_all": "all_to_all",
              "_all_gather_base": "all_gather",
              "all_gather": "all_gather",
              "all_gather_into_tensor": "all_gather"}


def nccl_profile(prof) -> tuple[dict, float, int]:
    """The NCCL collectives a profiled window issued, by kind (the
    profiler's host-side ``nccl:<op>`` records, one a collective), their
    device microseconds and the number of device-side ``nccl:<op>``
    ranges (an in-place all-reduce over one rank moves nothing and has
    none)."""
    from torch.autograd import DeviceType

    counts = dict.fromkeys(("all_reduce", "reduce_scatter", "all_to_all",
                            "all_gather"), 0)
    device_us, device_ranges = 0.0, 0
    for e in prof.events():
        if not e.name.startswith("nccl:"):
            continue
        if e.device_type == DeviceType.CPU:
            kind = NCCL_KINDS.get(e.name[len("nccl:"):])
            if kind is None:
                raise AssertionError(f"train_comms: unexpected NCCL op "
                                     f"{e.name}")
            counts[kind] += 1
        elif e.device_type == DeviceType.CUDA:
            device_us += e.time_range.end - e.time_range.start
            device_ranges += 1
    return counts, device_us, device_ranges


def comms_batches(cfg) -> list:
    """COMMS_STEPS batches of ids/labels (B x S) on the card, from one
    numpy seed: every schedule trains on the same tokens."""
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (COMMS_STEPS, TRAIN_B, TRAIN_S + 1))).to(DEV)
    return [{"ids": tokens[i, :, :-1], "labels": tokens[i, :, 1:]}
            for i in range(COMMS_STEPS)]


def flat_params(sched, state) -> torch.Tensor:
    """The full parameters as one fp32 vector, in tree order."""
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    params = sched.gather_params(state) if sched is not None \
        else state.params
    return torch.cat([p.detach().reshape(-1).float()
                      for _, p in tree_flatten(params)])


def flash_snapshot() -> tuple:
    from torchbooster_tpu_torch.ops import flash_attention as fa

    return ({"fwd": fa.launches_fwd, "dq": fa.launches_dq,
             "dkv": fa.launches_dkv},
            {"fwd": dict(fa.launches_fwd_by_route),
             "dq": dict(fa.launches_dq_by_route),
             "dkv": dict(fa.launches_dkv_by_route)})


def comms_run(name, spec, mesh, conf, cfg, params0, batches,
              clip=None) -> tuple:
    """``COMMS_STEPS`` steps of the GPT-2 small train step under one
    schedule, from ``params0``: steps 2-5 timed by the host clock around
    a synchronize, step 6 under the profiler. Returns the record and the
    final parameters as one vector."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.comms import accounting, make_schedule
    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.recipes import gpt as recipe

    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    loss_fn = recipe.make_loss(conf, cfg)
    fresh = {k: v for k, v in utils._tree_map(lambda t: t.clone(),
                                              params0).items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = None
    if spec is None:
        state = utils.TrainState.create(fresh, tx, generator=conf.seed)
        step = utils.make_step(loss_fn, tx, clip=clip, mesh=mesh,
                               rules=GPT.SHARDING_RULES)
        planned = {"all_reduce": 2, "reduce_scatter": 0, "all_to_all": 0,
                   "all_gather": 0}
    else:
        stage, wire, overlap = spec
        sched = make_schedule(mesh, stage=stage, wire=wire, overlap=overlap)
        state = sched.create_state(fresh, tx, generator=conf.seed)
        step = utils.make_step(loss_fn, tx, clip=clip, comms=sched)
    del fresh
    before, before_route = flash_snapshot()
    losses = []
    t1 = None
    for i, batch in enumerate(batches[:-1]):
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / (len(batches) - 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t6 = time.perf_counter()
        state, m = step(state, batches[-1])
        losses.append(m["loss"])
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t6
    counts, nccl_us, nccl_ranges = nccl_profile(prof)
    busy_us = union_us(device_spans(prof))
    after, after_route = flash_snapshot()
    n_steps = len(batches)
    per_step = {k: (after[k] - before[k]) / n_steps for k in after}
    by_route = {k: {r: (after_route[k][r] - before_route[k][r]) / n_steps
                    for r in after_route[k]} for k in after_route}
    if sched is not None:
        planned = sched.collectives_per_step(clip is not None)
    n_params = n_params_of(params0)
    flat = flat_params(sched, state)
    rec = {"losses": [float(x) for x in losses], "step_ms": step_s * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "profiled_step_ms": wall6 * 1e3,
           "busy_share": busy_us / (wall6 * 1e6),
           "nccl_device_ms": nccl_us / 1e3, "nccl_collectives": counts,
           "nccl_device_ranges": nccl_ranges,
           "planned_collectives": planned, "flash_per_step": per_step,
           "flash_by_route_per_step": by_route,
           "n_buckets": sched.plan().n_buckets
           if sched is not None and sched.stage >= 2 else None}
    mode = spec[1] if spec else "implicit"
    stage = spec[0] if spec else 0
    kw = dict(stage=stage, overlap=bool(spec and spec[2])) if stage >= 2 \
        else {}
    rec["bytes_per_step_world1"] = accounting.step_traffic(
        n_params, 1, mode, stage >= 1, 512, **kw)["total_bytes"]
    rec["bytes_per_step_world8_model"] = accounting.step_traffic(
        n_params, 8, mode, stage >= 1, 512, **kw)["total_bytes"]
    del state, step
    return rec, flat


def comms_checkpoint(mesh, conf, cfg, params0, batches, root: Path) -> dict:
    """Stage 2 int8 with overlap and clip 1.0: save the sharded state at
    step 3, run on to step 6; restore the save into a fresh state and
    run steps 4-6 again. Losses and parameters must be bit-identical."""
    import shutil

    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.comms import make_schedule
    from torchbooster_tpu_torch.recipes import gpt as recipe

    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    loss_fn = recipe.make_loss(conf, cfg)
    stage, wire, overlap = COMMS_CKPT[1]
    sched = make_schedule(mesh, stage=stage, wire=wire, overlap=overlap)

    def fresh():
        return sched.create_state(utils._tree_map(lambda t: t.clone(),
                                                  params0), tx,
                                  generator=conf.seed)

    step = utils.make_step(loss_fn, tx, clip=conf.clip, comms=sched)
    shutil.rmtree(root, ignore_errors=True)
    cb = SaveCallback(1, COMMS_STEPS, root=root, sharded=True, comms=sched)
    state, losses = fresh(), []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 2:
            torch.cuda.synchronize()
            cb.save(3, state=state)
    t = time.perf_counter()
    cb.wait()
    wait_s = time.perf_counter() - t
    want = flat_params(sched, state)
    want_ef = state.comms["ef1"].clone()
    del state
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored = cb.restore(like={"state": fresh()})["state"]
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    resumed = []
    for batch in batches[3:]:
        restored, m = step(restored, batch)
        resumed.append(float(m["loss"]))
    got = flat_params(sched, restored)
    rec = cb.saves[0]
    out = {"schedule": COMMS_CKPT[0], "clip": conf.clip, "losses": losses,
           "resumed": resumed, "save_block_s": rec["block_s"],
           "save_write_s": rec["write_s"], "save_wait_s": wait_s,
           "bytes": rec["bytes"], "restore_s": restore_s,
           "bit_exact": resumed == losses[3:] and torch.equal(got, want)
           and torch.equal(restored.comms["ef1"], want_ef)}
    shutil.rmtree(root, ignore_errors=True)
    if not out["bit_exact"]:
        raise AssertionError(
            f"train_comms checkpoint: the resumed run differs: losses "
            f"{resumed} vs {losses[3:]}, max param diff "
            f"{float((got - want).abs().max())}")
    return out


def comms_ladder(smi: str) -> dict:
    """Runs inside the world-1 NCCL group ``distributed.launch`` started:
    the group's facts, every schedule of COMMS_LADDER with its gates, and
    the sharded checkpoint's bit-exact resume."""
    import torch.distributed as tdist

    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.config import EnvConfig
    from torchbooster_tpu_torch.models.gpt import GPT

    env = EnvConfig(distributed=True, precision="bf16", mesh="dp")
    mesh = dist.get_mesh(env, device=DEV)
    group = {"backend": tdist.get_backend(), "world": dist.get_world_size(),
             "nccl": ".".join(map(str, torch.cuda.nccl.version())),
             "mesh": mesh.shape, "device": str(mesh.device)}
    if group["backend"] != COMMS_BACKEND or group["world"] != 1 \
            or not mesh.distributed:
        raise AssertionError(f"train_comms: group {group}")
    log(f"train_comms group: backend {group['backend']}, world "
        f"{group['world']}, NCCL {group['nccl']}, mesh {group['mesh']} on "
        f"{group['device']}")
    conf = gpt2_train_config(COMMS_STEPS, sample_tokens=0)
    cfg = conf.model.make()
    params0 = GPT.init(conf.seed, cfg, device=DEV)
    batches = comms_batches(cfg)
    n_l = cfg.n_layers
    flash_want = {"fwd": 2 * n_l, "dq": n_l, "dkv": n_l}
    runs: dict = {}
    ref = None
    t0 = time.perf_counter()
    for name, spec in COMMS_LADDER:
        rec, flat = comms_run(name, spec, mesh, conf, cfg, params0, batches)
        if ref is None:
            ref = flat
        losses = rec["losses"]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_comms {name}: losses {losses}")
        wire = spec[1] if spec else "fp32"
        rec["max_abs_param_diff_vs_implicit"] = float((flat - ref).abs().max())
        if wire == "fp32" and rec["max_abs_param_diff_vs_implicit"] \
                > COMMS_PARAM_ATOL:
            raise AssertionError(
                f"train_comms {name}: parameters differ from the implicit "
                f"run's by {rec['max_abs_param_diff_vs_implicit']} "
                f"(atol {COMMS_PARAM_ATOL})")
        want_l = runs["implicit"]["losses"] if runs else losses
        rec["max_loss_rel_diff_vs_implicit"] = max(
            abs(a - b) / abs(b) for a, b in zip(losses, want_l))
        if wire == "int8" and rec["max_loss_rel_diff_vs_implicit"] \
                > COMMS_INT8_RTOL:
            raise AssertionError(
                f"train_comms {name}: losses {losses} vs implicit {want_l} "
                f"(rtol {COMMS_INT8_RTOL})")
        if rec["flash_per_step"] != flash_want or any(
                rec["flash_by_route_per_step"][k] != {
                    "sm90": flash_want[k], "mma_sync": 0, "f32": 0}
                for k in flash_want):
            raise AssertionError(
                f"train_comms {name}: B1-B3 a step {rec['flash_per_step']} "
                f"by route {rec['flash_by_route_per_step']}, expected "
                f"{flash_want} on sm90")
        if rec["nccl_collectives"] != rec["planned_collectives"]:
            raise AssertionError(
                f"train_comms {name}: NCCL collectives a step "
                f"{rec['nccl_collectives']}, planned "
                f"{rec['planned_collectives']}")
        runs[name] = rec
        log(f"train_comms {name}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"step {rec['step_ms']:.1f} ms, peak mem "
            f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB, busy "
            f"{100 * rec['busy_share']:.1f}% of the profiled step "
            f"({rec['profiled_step_ms']:.1f} ms), NCCL device "
            f"{rec['nccl_device_ms']:.3f} ms over {rec['nccl_device_ranges']}"
            f" device ranges, collectives "
            f"{rec['nccl_collectives']} (planned {rec['planned_collectives']}"
            f", buckets {rec['n_buckets']}), bytes a step {rec['bytes_per_step_world1']}"
            f" at world 1 ({rec['bytes_per_step_world8_model']} modelled at "
            f"8 ranks); param max diff vs implicit "
            f"{rec['max_abs_param_diff_vs_implicit']:.3g}, loss max rel diff "
            f"{rec['max_loss_rel_diff_vs_implicit']:.3g} [{smi}]")
        del flat
    off, on = runs["s2_fp32_off"], runs["s2_fp32_on"]
    if off["losses"] != on["losses"]:
        raise AssertionError(f"train_comms: stage 2 overlap off/on losses "
                             f"{off['losses']} / {on['losses']}")
    # parameters: both equal the implicit run's bit for bit (gated above
    # at COMMS_PARAM_ATOL); record the direct comparison too
    ladder_s = time.perf_counter() - t0
    del ref
    root = Path(__file__).resolve().parent / "checkpoints" / "train_comms"
    ckpt = comms_checkpoint(mesh, conf, cfg, params0, batches, root)
    log(f"train_comms checkpoint ({ckpt['schedule']}, clip {ckpt['clip']}): "
        f"saved at step 3, {ckpt['bytes'] / 2**30:.2f} GiB in "
        f"{ckpt['save_block_s']:.3f} s blocking + {ckpt['save_write_s']:.3f}"
        f" s background write; restored in {ckpt['restore_s']:.3f} s; steps "
        f"4-6 {ckpt['resumed']} bit-identical to the uninterrupted run [{smi}]")
    return {"group": group, "runs": runs, "ladder_s": ladder_s,
            "checkpoint": ckpt}


def phase_train_comms(report: dict, smi: str) -> dict:
    """Data-parallel training through a world-1 NCCL group on the card:
    the schedule ladder and the sharded checkpoint under
    ``distributed.launch``, then the GPT recipe's ``launch_main`` with a
    ``comms:`` block. Returns the flash kernels' launch counts."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.config import CommsConfig, EnvConfig
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe

    reset_flash_counts()
    t0 = time.perf_counter()
    out = dist.launch(comms_ladder, n_devices=1, distributed=True,
                      device=DEV, args=(smi,))
    # the recipe as a user runs it: launch_main with env.distributed and a
    # comms: block (built in code: the card's machine has no PyYAML)
    conf = gpt2_train_config(3, sample_tokens=0)
    conf.env = EnvConfig(distributed=True, precision="bf16", mesh="dp")
    conf.comms = CommsConfig(stage=2, wire="int8", overlap=True)
    t = time.perf_counter()
    res = recipe.launch_main(conf, device=DEV)
    losses = [r["loss"] for r in res["log"]]
    if len(losses) != 3 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_comms recipe: losses {losses}")
    out["recipe"] = {"losses": losses, "wall_s": time.perf_counter() - t}
    log(f"train_comms recipe: launch_main, distributed, mesh dp, comms "
        f"{{stage: 2, wire: int8, overlap: true}}: losses {losses} in "
        f"{out['recipe']['wall_s']:.1f} s [{smi}]")
    out["wall_s"] = time.perf_counter() - t0
    out["card"] = smi
    report["train_comms"] = out
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    by_route = {"fwd": dict(fa.launches_fwd_by_route),
                "dq": dict(fa.launches_dq_by_route),
                "dkv": dict(fa.launches_dkv_by_route)}
    return {**launches, "by_route": by_route}


# ------------------------------------------------------------------- moe
MOE_STEPS = 6
# JAX GPTConfig's MoE defaults
MOE_EXPERTS, MOE_TOP_K, MOE_CF = 8, 2, 1.25
MOE_PROFILED = 2          # steps profiled for the busy share
MOE_LENS = (64, 100, 150, 200)
MOE_NEW = 16


def moe_train_config(n_iter: int, root: Path):
    """``gpt2_train_config`` with every block's MLP an MoE layer of
    ``MOE_EXPERTS`` experts, top-``MOE_TOP_K`` at capacity factor
    ``MOE_CF``, on a world-1 group with ``mesh: "ep:1"``, and a sharded
    checkpoint at the last step under ``root``."""
    from torchbooster_tpu_torch.config import EnvConfig

    conf = gpt2_train_config(n_iter, sample_tokens=0)
    conf.model.n_experts = MOE_EXPERTS
    conf.model.top_k, conf.model.capacity_factor = MOE_TOP_K, MOE_CF
    conf.env = EnvConfig(distributed=True, precision="bf16", mesh="ep:1")
    conf.save_every, conf.checkpoint_root = n_iter, str(root)
    return conf


def flash_counts() -> dict:
    from torchbooster_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
            "dkv": fa.launches_dkv,
            "by_route": {"fwd": dict(fa.launches_fwd_by_route),
                         "dq": dict(fa.launches_dq_by_route),
                         "dkv": dict(fa.launches_dkv_by_route)}}


def moe_resumed(conf) -> tuple[dict, dict]:
    """Inside a world-1 group: the recipe's ``setup`` resumes the
    trainer from ``launch_main``'s checkpoint; the restored parameters
    (the trained tree, cloned), each layer's dropped assignments in one
    no-grad forward over a batch, and ``MOE_PROFILED`` steps under the
    profiler for the busy share."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.models import moe
    from torchbooster_tpu_torch.models.gpt import GPT, map_tensors
    from torchbooster_tpu_torch.recipes import gpt as recipe

    t = recipe.setup(conf, DEV)
    if t.start_iter != conf.n_iter:
        raise AssertionError(f"moe: setup resumed at step {t.start_iter}, "
                             f"not {conf.n_iter}")
    trained = map_tensors(t.state.params, lambda p: p.detach().clone())
    batch = t.batch(next(t.batches)[1])
    n_tok = batch["ids"].numel()
    capacity = max(int(MOE_TOP_K * n_tok / MOE_EXPERTS * MOE_CF + 0.5),
                   MOE_TOP_K)
    # a spy on ``moe._positions`` (looked up by ``moe_apply`` at call
    # time): each layer's positions in expert; those at or past the
    # capacity are the dropped assignments
    real, seen = moe._positions, []

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    moe._positions = spy
    try:
        with torch.no_grad():
            _, aux = GPT.apply(t.state.params, batch["ids"], t.cfg,
                               remat=False, return_aux=True, mesh=t.mesh)
    finally:
        moe._positions = real
    dropped = [int((pos >= capacity).sum()) for pos in seen]
    batches = [t.batch(next(t.batches)[1]) for _ in range(MOE_PROFILED)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            t.state, m = t.step(t.state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = union_us(device_spans(prof)) / 1e6
    top = sorted(((e.key, e.self_device_time_total / 1e3 / MOE_PROFILED)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    return {"dropped_per_layer": dropped,
            "assignments_per_layer": MOE_TOP_K * n_tok, "capacity": capacity,
            "aux_no_grad": float(aux), "profiled_steps": MOE_PROFILED,
            "profiled_step_ms": wall / MOE_PROFILED * 1e3,
            "busy_share": busy / wall,
            "device_ms_per_step": busy / MOE_PROFILED * 1e3,
            "top_device_ms_per_step": top[:10]}, trained


def moe_serve(params, cfg) -> dict:
    """The trained tree on the paged engine at fp32 (B4 ``"simt"``):
    every stream token-exact against the dense ``generate`` at the
    engine's capacity (``serving_capacity``: at least ``n_experts``, JAX
    ``engine.py:760``, so no token drops; the dense ``generate`` prefills
    at ``cfg.capacity_factor`` as JAX's does), B4 launches = layers x
    decode steps."""
    import dataclasses

    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.models.gpt import serving_capacity
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    from torchbooster_tpu_torch.serving import Request

    rs = np.random.RandomState(2)
    reqs = [Request(prompt=rs.randint(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=MOE_NEW, request_id=f"m{i}")
            for i, n in enumerate(MOE_LENS)]
    batcher = ServingConfig(page_size=PS, n_pages=33, max_slots=4).make(
        params, cfg, compute_dtype=torch.float32, on_recompile="raise")
    eng = batcher.engine
    steps = [0]
    real_step = eng.step

    def counted_step():
        steps[0] += 1
        return real_step()

    eng.step = counted_step
    reset_paged_counts()
    t0 = time.perf_counter()
    metrics = batcher.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    served = dataclasses.replace(cfg, capacity_factor=serving_capacity(cfg))
    want, _ = dense_tokens(params, served, reqs, torch.float32,
                           n_new=MOE_NEW)
    match = [r.tokens == w for r, w in zip(reqs, want)]
    out = {"match": match, "b4_launches": launches, "b4_by_route": by_route,
           "decode_steps": steps[0], "wall_s": wall,
           "capacity_factor": served.capacity_factor,
           "decode_tok_s": metrics.get("decode_tok_s"),
           "step_route": eng.step_route,
           "step_route_reason": eng.step_route_reason,
           "graph_replays": eng.graph_replays}
    if not all(match):
        raise AssertionError(f"moe serving: {match.count(False)} of "
                             f"{len(match)} streams differ from the dense "
                             f"generate")
    if launches != cfg.n_layers * steps[0] or by_route["simt"] != launches:
        raise AssertionError(f"moe serving: B4 launches {launches} by route "
                             f"{by_route}, expected {cfg.n_layers} x "
                             f"{steps[0]} decode steps on simt")
    # the routing at serving capacity reads nothing back to the host, so
    # the plan captures the MoE decode step as it does a dense one
    if eng.step_route != "graph" or eng.graph_replays != steps[0] - 1:
        raise AssertionError(f"moe serving: route {eng.step_route!r}, "
                             f"{eng.graph_replays} replays over "
                             f"{steps[0]} decode steps")
    return out


def phase_moe(report: dict, smi: str) -> dict:
    """A GPT-2-small-width MoE trained through the recipe's
    ``launch_main`` on a world-1 NCCL group (``mesh: "ep:1"``), resumed
    from its checkpoint, then served. Returns B1-B3's launches (the
    training, the drop-count forward and the profiled steps) and B4's."""
    import shutil

    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.recipes import gpt as recipe

    root = Path(__file__).resolve().parent / "checkpoints" / "moe"
    shutil.rmtree(root, ignore_errors=True)
    conf = moe_train_config(MOE_STEPS, root)
    cfg = conf.model.make()
    reset_flash_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = recipe.launch_main(conf, device=DEV)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trained_counts = flash_counts()
    losses = [r["loss"] for r in res["log"]]
    auxes = [r["aux"] for r in res["log"]]
    if len(losses) != MOE_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"moe: losses {losses}")
    if not all(a >= 0.9 for a in auxes):
        raise AssertionError(f"moe: aux {auxes} (JAX's gate: >= 0.9)")
    n_l = cfg.n_layers
    # remat runs each block's forward twice a step
    per_step = {"fwd": 2 * n_l, "dq": n_l, "dkv": n_l}
    want = {k: v * MOE_STEPS for k, v in per_step.items()}
    got = {k: trained_counts[k] for k in want}
    if got != want or any(
            trained_counts["by_route"][k] != {"sm90": want[k],
                                              "mma_sync": 0, "f32": 0}
            for k in want):
        raise AssertionError(f"moe: B1-B3 launches {got} by route "
                             f"{trained_counts['by_route']}, expected "
                             f"{per_step} a step on sm90")
    # steps 2 to 5; the last one also takes the checkpoint's host copy
    el = [r["elapsed_s"] for r in res["log"]]
    step_s = (el[-2] - el[0]) / (MOE_STEPS - 2)
    out = {"losses": losses, "aux": auxes, "train_wall_s": train_wall,
           "step_ms": step_s * 1e3,
           "save_step_ms": (el[-1] - el[-2]) * 1e3,
           "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
           "peak_mem_bytes": peak, "flash_per_step": per_step}
    log(f"moe train: launch_main on a world-1 NCCL group, mesh ep:1, "
        f"GPT-2 small width with {MOE_EXPERTS} experts top-{MOE_TOP_K} at "
        f"capacity factor {MOE_CF}, batch {TRAIN_B} x {TRAIN_S}, bf16, "
        f"remat; losses {[round(x, 4) for x in losses]}, aux "
        f"{[round(x, 4) for x in auxes]}; step {out['step_ms']:.1f} ms "
        f"(steps 2-{MOE_STEPS - 1}; step {MOE_STEPS} with the checkpoint "
        f"save {out['save_step_ms']:.1f} ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak "
        f"mem {peak / 2**30:.2f} GiB; B1/B2/B3 a step {per_step} on sm90 "
        f"[{smi}]")
    resumed, trained = dist.launch(moe_resumed, n_devices=1, distributed=True,
                                   device=DEV, args=(conf,))
    after = flash_counts()
    # the resumed trainer: one no-grad forward, then the profiled steps
    more = {k: after[k] - trained_counts[k] for k in want}
    want_more = {k: v * MOE_PROFILED + (n_l if k == "fwd" else 0)
                 for k, v in per_step.items()}
    if more != want_more:
        raise AssertionError(f"moe resumed: B1-B3 launches {more}, expected "
                             f"{want_more}")
    out["resumed"] = resumed
    log(f"moe resumed from its sharded checkpoint at step {MOE_STEPS}: "
        f"dropped assignments a layer {resumed['dropped_per_layer']} of "
        f"{resumed['assignments_per_layer']} (capacity "
        f"{resumed['capacity']} an expert); {MOE_PROFILED} profiled steps "
        f"{resumed['profiled_step_ms']:.1f} ms a step, busy "
        f"{100 * resumed['busy_share']:.1f}% ({resumed['device_ms_per_step']:.1f}"
        f" ms of device time a step); top kernels, ms a step: "
        + "; ".join(f"{k[:60]} {v:.1f}"
                    for k, v in resumed["top_device_ms_per_step"][:6])
        + f" [{smi}]")
    out["n_params"] = n_params_of(trained)
    serve_out = out["serve"] = moe_serve(trained, cfg)
    log(f"moe serve: {len(MOE_LENS)} requests x {MOE_NEW} new tokens at "
        f"fp32, capacity factor {serve_out['capacity_factor']}: "
        f"{sum(serve_out['match'])}/{len(serve_out['match'])} token-exact "
        f"vs the dense generate; B4 {serve_out['b4_launches']} launches = "
        f"{n_l} x {serve_out['decode_steps']} decode steps, by route "
        f"{serve_out['b4_by_route']}; step route {serve_out['step_route']} "
        f"({serve_out['graph_replays']} replays) [{smi}]")
    shutil.rmtree(root, ignore_errors=True)
    out["card"] = smi
    report["moe"] = out
    # the training's launches and the resumed trainer's (its forward and
    # profiled steps): B1-B3 on the MoE model's path
    flash = {k: after[k] for k in ("fwd", "dq", "dkv")}
    return {"flash": {**flash, "by_route": after["by_route"]},
            "paged": {"launches": serve_out["b4_launches"],
                      "by_route": serve_out["b4_by_route"]}}


# --------------------------------------------------------------- sp_fold
SP_RANKS = 8
# (name, B, H, H_kv, S, D): gpt-long's width (examples/lm/gpt/gpt-long.yml,
# mesh "sp:8") and the MoE model's (GPT-2 small's attention)
SP_GEOMETRIES = (("gpt_long", 8, 16, 8, 8192, 48),
                 ("moe_width", 8, 12, 12, 1024, 64))
# the fold against the plain versions and against whole-sequence B1-B3,
# bf16: each chunk's B1 output and B2/B3 gradients are rounded to bf16
# before the fp32 merge or sum, so a few bf16 ulp more than one
# whole-sequence call: atol = rtol, the flash checks' bf16 allowance
SP_FOLD_TOL = FLASH_TOL[torch.bfloat16]
# and per tensor, in each sp chunk of the sequence: ||got - want|| /
# ||want|| at most four bf16 unit roundoffs (2^-8 each). At S 8192 an
# element's allowance (atol 2e-2) is about as large as a late position's
# output or a late key's dK/dV, so the element check sees a lost
# contribution there only through its largest elements; the norm check
# holds each chunk whole, and must fail the planted fault below
SP_FOLD_REL = 4 * 2.0 ** -8
# the planted fault: rank 7's visit to chunk 0 (the last step of the
# ring, the smallest share of chunk 0's dK/dV) left out of the backward
SP_FOLD_DROP = (SP_RANKS - 1, 0)


def ring_fold(qs, ks, vs, dos, scale, drop: tuple | None = None) -> tuple:
    """The port's ring (``parallel/ring.py`` ``ring_fwd_step`` /
    ``ring_bwd_step``) for every rank of an ``sp`` ring in one process:
    rank ``my`` at step ``t`` holds chunk ``(my - t) % n``, the rotation
    done by indexing. The backward feeds each step the fold's global
    out and lse, and each chunk's dK/dV accumulate in the order they
    visit the ranks. ``drop=(my, src)`` leaves that visit out of the
    backward: a planted fault that the checks must catch. Returns
    ``(outs, lses, dqs, dks, dvs)`` per rank."""
    from torchbooster_tpu_torch.parallel import ring

    n = len(qs)
    outs, lses = [], []
    for my in range(n):
        carry = None
        for t in range(n):
            src = (my - t) % n
            carry = ring.ring_fwd_step(qs[my], ks[src], vs[src], src=src,
                                       my=my, causal=True, sm_scale=scale,
                                       carry=carry)
        outs.append(carry[0].to(qs[my].dtype))
        lses.append(carry[1])
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    for t in range(n):
        for my in range(n):
            src = (my - t) % n
            if (my, src) == drop:
                continue
            dq[my], dk[src], dv[src] = ring.ring_bwd_step(
                qs[my], ks[src], vs[src], outs[my], lses[my], dos[my],
                src=src, my=my, causal=True, sm_scale=scale, dq=dq[my],
                dk=dk[src], dv=dv[src])
    return outs, lses, dq, dk, dv


def fold_geometry(gen, name, b, h, h_kv, s_len, d, smi) -> dict:
    """One geometry: the ring fold held to the plain versions and to
    whole-sequence B1-B3 over the same inputs (:func:`hold_fold`), and a
    planted fault (a visit left out of the backward) shown to fail the
    norm check; then (where the heads divide) Ulysses' per-rank local
    attention held the same way; B1's causal and non-causal launches and
    each route counted; the fold's summed flash-kernel device µs beside
    one whole-sequence B1 + B2 + B3."""
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.ops.attention import attention

    n, dtype = SP_RANKS, torch.bfloat16
    q, k, v, do = flash_inputs(gen, b, h, h_kv, s_len, s_len, d, dtype)
    scale = 1.0 / math.sqrt(d)
    sl = s_len // n
    chunk = lambda x: [x[:, r * sl:(r + 1) * sl].contiguous()
                       for r in range(n)]
    qs, ks, vs, dos = chunk(q), chunk(k), chunk(v), chunk(do)
    before = flash_counts()
    mask0 = dict(fa.launches_fwd_by_mask)
    outs, lses, dqs, dks, dvs = ring_fold(qs, ks, vs, dos, scale)
    torch.cuda.synchronize()
    after = flash_counts()
    masks = {m: fa.launches_fwd_by_mask[m] - mask0[m] for m in mask0}
    launches = {key: after[key] - before[key] for key in ("fwd", "dq", "dkv")}
    routes = {key: {r: after["by_route"][key][r] - before["by_route"][key][r]
                    for r in after["by_route"][key]} for key in launches}
    pairs = n * (n - 1) // 2
    want_masks = {"causal": n, "full": pairs}
    if masks != want_masks or launches != dict.fromkeys(launches, n + pairs):
        raise AssertionError(f"sp_fold {name}: B1 by mask {masks}, "
                             f"launches {launches}; expected {want_masks}, "
                             f"{n + pairs} each")
    # every chunk call on its kernel's planned route (S_q == S_kv == S/sp)
    planned = {"fwd": fa.plan_flash_fwd(dtype, d, sl, sl, h // h_kv),
               "dq": fa.plan_flash_bwd(dtype, d, sl, sl, h // h_kv)}
    planned["dkv"] = planned["dq"]
    if any(routes[key][planned[key]] != launches[key] for key in launches):
        raise AssertionError(f"sp_fold {name}: launches by route {routes}, "
                             f"planned {planned}")
    # the whole sequence through the plain versions and through B1-B3,
    # on the same inputs (comparison launches, not counted)
    o_pl, lse_pl = fa.flash_attention_reference(q, k, v, True, scale)
    plain = dict(zip(("o", "lse", "dq", "dk", "dv"), (
        o_pl, lse_pl, *fa.flash_attention_backward_reference(
            q, k, v, o_pl, lse_pl, do, True, scale))))
    o_ref, lse_ref = fa.launch_fwd(q, k, v, True, scale)
    dq_ref, delta = fa.launch_dq(q, k, v, o_ref, lse_ref, do, True, scale)
    dk_ref, dv_ref = fa.launch_dkv(q, k, v, lse_ref, do, delta, True, scale)
    kernels = {"o": o_ref, "lse": lse_ref, "dq": dq_ref, "dk": dk_ref,
               "dv": dv_ref}
    cat = lambda xs: torch.cat(xs, dim=1)
    fold = {"o": cat(outs), "lse": cat(lses), "dq": cat(dqs),
            "dk": cat(dks), "dv": cat(dvs)}
    checks = {ref: hold_fold(f"sp_fold {name} ring vs {ref}", fold, want, n)
              for ref, want in (("plain", plain), ("kernels", kernels))}
    # the planted fault: the same checks must fail it
    _, _, f_dq, f_dk, f_dv = ring_fold(qs, ks, vs, dos, scale,
                                       drop=SP_FOLD_DROP)
    fault = [(key, cat(x), plain[key])
             for key, x in (("dq", f_dq), ("dk", f_dk), ("dv", f_dv))]
    fault_rel = rel_errs(fault, n)
    fault_used = flash_errs(SP_FOLD_TOL, fault)[1]
    if not all(r > SP_FOLD_REL for r in fault_rel.values()):
        raise AssertionError(f"sp_fold {name}: the fold without the visit "
                             f"{SP_FOLD_DROP} passes the norm check: "
                             f"{fault_rel} (bound {SP_FOLD_REL})")
    del fault, f_dq, f_dk, f_dv
    out = {"geometry": {"B": b, "H": h, "H_kv": h_kv, "S": s_len, "D": d,
                        "sp": n, "S_chunk": sl},
           "launches": launches, "b1_by_mask": masks, "routes": routes,
           "planned": planned,
           "ring": checks, "atol": SP_FOLD_TOL, "rtol": SP_FOLD_TOL,
           "rel_bound": SP_FOLD_REL,
           "planted_fault": {"dropped_visit": SP_FOLD_DROP,
                             "rel_err": fault_rel,
                             "allowance_used": fault_used}}
    log(f"sp_fold {name} ring: B {b}, {h} heads over {h_kv}, S {s_len} = "
        f"{n} x {sl}, D {d}, bf16 causal; B1 {masks['causal']} causal + "
        f"{masks['full']} non-causal launches a pass, B2/B3 "
        f"{launches['dq']}/{launches['dkv']}; routes B1 {routes['fwd']}, "
        f"B2 {routes['dq']}, B3 {routes['dkv']}; "
        + "; ".join(f"vs whole-sequence {ref}: {fold_errs_txt(c)}"
                    for ref, c in checks.items())
        + f" (max abs err, % of atol + rtol|ref| with atol = rtol = "
          f"{SP_FOLD_TOL}; the largest ||err|| / ||ref|| over the {n} "
          f"chunks, bound {SP_FOLD_REL}) [{smi}]")
    log(f"sp_fold {name} planted fault (rank {SP_FOLD_DROP[0]}'s visit to "
        f"chunk {SP_FOLD_DROP[1]} left out of the backward), vs plain: "
        + ", ".join(f"{key} rel {fault_rel[key]:.2e}, "
                    f"{100 * fault_used[key]:.0f}% of the element allowance"
                    for key in fault_rel)
        + " — failed by the norm check, as it must be")
    if h % n == 0 and h_kv % n == 0:
        # Ulysses: after its all-to-all rank r holds the whole sequence
        # of query heads [r h/n, (r+1) h/n) and kv heads [r h_kv/n, ...):
        # its local attention through the dispatcher, forward and backward
        hq, hk = h // n, h_kv // n
        heads = lambda x, w, r: x.reshape(b, -1, s_len, d)[
            :, r * w:(r + 1) * w].transpose(1, 2)
        got = {key: [] for key in ("o", "dq", "dk", "dv")}
        for r in range(n):
            qh, kh, vh = (heads(x, w, r).detach().requires_grad_()
                          for x, w in ((q, hq), (k, hk), (v, hk)))
            o_h = attention(qh, kh, vh, causal=True)
            o_h.backward(heads(do, hq, r))
            for key, x in (("o", o_h.detach()), ("dq", qh.grad),
                           ("dk", kh.grad), ("dv", vh.grad)):
                got[key].append(x.transpose(1, 2))
        whole = lambda xs: torch.cat(xs, dim=1).reshape(-1, s_len, d)
        uly = {key: whole(xs) for key, xs in got.items()}
        del got
        u_checks = {
            ref: hold_fold(f"sp_fold {name} ulysses vs {ref}", uly,
                           {key: want[key] for key in uly}, n)
            for ref, want in (("plain", plain), ("kernels", kernels))}
        out["ulysses"] = u_checks
        log(f"sp_fold {name} ulysses: each of {n} ranks {hq} heads over "
            f"{hk} kv head(s) of the whole sequence, through the "
            f"dispatcher; "
            + "; ".join(f"vs whole-sequence {ref}: {fold_errs_txt(c)}"
                        for ref, c in u_checks.items()))
    del plain
    # the fold (its fp32 merges and sums included) beside one
    # whole-sequence B1 + B2 + B3, each by CUDA events around the call;
    # each call's B1-B3 kernels alone from the profiler, kept only from a
    # window that recorded every one of them (late in a full run a
    # window can lose events)
    def whole():
        fa.launch_fwd(q, k, v, True, scale)
        _, dl = fa.launch_dq(q, k, v, o_ref, lse_ref, do, True, scale)
        fa.launch_dkv(q, k, v, lse_ref, do, dl, True, scale)

    timing = {}
    for key, fn, n_kernels in (
            ("fold", lambda: ring_fold(qs, ks, vs, dos, scale),
             3 * (n + pairs)),
            ("whole", whole, 3)):
        timing[key] = {"ms": cuda_ms(fn, iters=3, warmup=1),
                       "flash_ms": flash_kernels_ms(fn, n_kernels),
                       "flash_kernels": n_kernels}
    out["timing"] = timing
    f, w = timing["fold"], timing["whole"]
    fmt = lambda x: "not measured (the profiler lost events)" if x is None \
        else f"{x:.3f} ms"
    log(f"sp_fold {name} timing (CUDA events a call): the fold "
        f"{f['ms']:.3f} ms, its {f['flash_kernels']} B1-B3 kernels "
        f"{fmt(f['flash_ms'])} (profiler device time); one whole-sequence "
        f"B1 + B2 + B3 {w['ms']:.3f} ms, its kernels {fmt(w['flash_ms'])}; "
        f"a finding only: {n} ranks on one card [{smi}]")
    return out


def rel_errs(pairs, chunks: int) -> dict:
    """For each ``(key, got, want)`` of ``pairs``: the largest, over
    ``chunks`` equal slices of the sequence (dim 1), of ||got - want|| /
    ||want||."""
    out = {}
    for key, got, want in pairs:
        g, w = (x.float().unflatten(1, (chunks, -1)).transpose(0, 1)
                .reshape(chunks, -1) for x in (got, want))
        norm = torch.linalg.vector_norm
        out[key] = (norm(g - w, dim=1) / norm(w, dim=1)).max().item()
    return out


def hold_fold(label: str, got: dict, want: dict, chunks: int) -> dict:
    """``got[key]`` held to ``want[key]`` for each key of ``want``:
    element by element at atol = rtol = ``SP_FOLD_TOL``
    (:func:`hold_flash`) and in norm, in each of ``chunks`` sequence
    chunks, at ``SP_FOLD_REL`` (:func:`rel_errs`); raises on a miss."""
    pairs = [(key, got[key], want[key]) for key in want]
    errs, used = hold_flash(label, SP_FOLD_TOL, pairs)
    rel = rel_errs(pairs, chunks)
    if not all(r <= SP_FOLD_REL for r in rel.values()):
        raise AssertionError(f"{label}: ||err|| / ||ref|| {rel} over "
                             f"{chunks} chunks (bound {SP_FOLD_REL})")
    return {"max_abs_err": errs, "allowance_used": used, "rel_err": rel}


def fold_errs_txt(check: dict) -> str:
    return ", ".join(
        f"{key} {err:.2e} ({100 * check['allowance_used'][key]:.0f}%, rel "
        f"{check['rel_err'][key]:.2e})"
        for key, err in check["max_abs_err"].items())


def flash_kernels_ms(fn, expected: int, windows: int = 3):
    """Device ms of the B1-B3 kernels one call of ``fn`` launches, from
    a profiler window that recorded all ``expected`` of them; None when
    ``windows`` windows in a row lost any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "flash" in e.name]
        if len(spans) == expected:
            return sum(r.end - r.start for r in spans) / 1e3
    return None


def phase_sp_fold(report: dict, smi: str) -> dict:
    """The ring's per-rank forward and backward steps for all ranks of
    ``sp:8`` on the card, at gpt-long's width and the MoE model's.
    Returns the folds' B1-B3 launches (the whole-sequence comparisons
    and the timing windows are not counted)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    totals = {"fwd": 0, "dq": 0, "dkv": 0}
    by_route = {key: {"sm90": 0, "mma_sync": 0, "f32": 0} for key in totals}
    out = {}
    for name, *geometry in SP_GEOMETRIES:
        res = out[name] = fold_geometry(gen, name, *geometry, smi)
        for key in totals:
            totals[key] += res["launches"][key]
            for route, count in res["routes"][key].items():
                by_route[key][route] += count
        torch.cuda.empty_cache()
    out["card"] = smi
    report["sp_fold"] = out
    return {**totals, "by_route": by_route}


# ---------------------------------------------------------- tp and pp_fold
TP_FP32_BATCH = 4        # rows of 1024 in the fp32 tp:2 vs tp:1 check
TP_FP32_STEPS = 2
TP_STEPS = 6             # bf16, batch 8, remat: the tp:2 training run
TP_BATCH = 8
TP_SEED = 42
# fp32 gradients, tp:2 against tp:1: |got - want| <= RTOL |want| + RTOL
# max|want| a leaf (sums of the row products in another order)
TP_RTOL = 1e-4
# the flash plans at tp:2's 6 heads, D 64, bf16, one row of 1024 (the
# pipeline's microbatch) and at decode: the routes the phases must take
PP_STAGES, PP_MB = 4, 8


def held_rel(label: str, got: torch.Tensor, want: torch.Tensor,
             rtol: float) -> float:
    """``got`` within ``rtol |want| + rtol max|want|`` of ``want``;
    returns the worst |got - want| / max|want| and raises on a miss."""
    g, w = got.float(), want.float()
    scale = w.abs().max().clamp_min(1e-30)
    err = (g - w).abs()
    if not bool((err <= rtol * w.abs() + rtol * scale).all()):
        raise AssertionError(f"{label}: worst |err| {err.max().item():.3e} "
                             f"against max|ref| {scale.item():.3e} (rtol "
                             f"{rtol})")
    return (err.max() / scale).item()


def canonical(leaf: torch.Tensor, value: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of a rule-sharded leaf's ``value`` (the leaf or
    its gradient), qkv columns canonical (``sharding.full_leaf``)."""
    from torchbooster_tpu_torch.parallel.sharding import full_leaf

    return full_leaf(leaf, mesh, value.detach())


class CountAllReduce:
    """Counts ``torch.distributed.all_reduce`` calls while entered (the
    port's ``distributed.all_reduce`` looks it up at call time)."""

    def __enter__(self):
        import torch.distributed as tdist

        self.n, self._real = 0, tdist.all_reduce

        def counting(*args, **kwargs):
            self.n += 1
            return self._real(*args, **kwargs)

        tdist.all_reduce = counting
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        tdist.all_reduce = self._real


def tp_trainer(mesh, cfg, dtype, remat: bool):
    """A GPT-2 small ``TrainState`` laid out at ``tp:2`` by the rule
    table (seed 42) and its ``make_step``; with ``mesh`` None the one-card
    tp:1 run of the same seed."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import EnvConfig, OptimizerConfig
    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    tx = OptimizerConfig(name="adamw", lr=1e-3, weight_decay=0.1).make()
    state = utils.TrainState.create(GPT.init(TP_SEED, cfg, device=DEV), tx)
    if mesh is not None:
        state = EnvConfig(distributed=True, mesh="tp:2").make(
            state, model=GPT, device=DEV)

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"], cfg, compute_dtype=dtype,
                           remat=remat, mesh=mesh)
        return cross_entropy(logits, b["labels"]), {}

    step = utils.make_step(loss_fn, tx, clip=1.0, mesh=mesh,
                           rules=GPT.SHARDING_RULES if mesh else None)
    return state, loss_fn, step


def tp_batch(cfg, rows: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab, (rows, cfg.seq_len + 1)))
    ids = ids.to(DEV)
    return {"ids": ids[:, :-1], "labels": ids[:, 1:]}


def tp_fp32_check(mesh, cfg) -> dict:
    """tp:2 against tp:1 at fp32 (TF32 off), same seed and batches: the
    first step's gradients (gathered to the canonical layout) and
    ``TP_FP32_STEPS`` losses; rank 0 computes the tp:1 run and holds."""
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    batches = [tp_batch(cfg, TP_FP32_BATCH, 7 + i)
               for i in range(TP_FP32_STEPS)]
    state, loss_fn, step = tp_trainer(mesh, cfg, torch.float32, True)
    loss, _ = loss_fn(state.params, batches[0], None)
    loss.backward()
    grads = {path: canonical(p, p.grad, mesh)
             for path, p in tree_flatten(state.params)}
    for _, p in tree_flatten(state.params):
        p.grad = None
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    out = {"losses": losses}
    if mesh.rank == 0:
        ref, ref_loss_fn, ref_step = tp_trainer(None, cfg, torch.float32,
                                                True)
        ref_loss, _ = ref_loss_fn(ref.params, batches[0], None)
        ref_loss.backward()
        worst = 0.0
        for path, p in tree_flatten(ref.params):
            worst = max(worst, held_rel("tp fp32 grad " + "/".join(path),
                                        grads[path], p.grad, TP_RTOL))
            p.grad = None
        want = []
        for b in batches:
            ref, m = ref_step(ref, b)
            want.append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        if rel > TP_RTOL:
            raise AssertionError(f"tp fp32 losses {losses} against tp:1 "
                                 f"{want} (rtol {TP_RTOL})")
        out.update(ref_losses=want, loss_rel=rel, grad_worst=worst)
        del ref
    del state, grads
    torch.cuda.empty_cache()
    return out


def tp_bf16_train(mesh, cfg, smi: str) -> tuple[dict, dict]:
    """``TP_STEPS`` bf16 steps at batch 8, remat on, at tp:2: finite
    falling losses, B1 / B2 / B3 24 / 12 / 12 a step on ``"sm90"``, step
    ms, peak, busy share, all-reduces a step and in a forward. Returns the
    run's numbers and the trained state's whole tree."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    state, loss_fn, step = tp_trainer(mesh, cfg, torch.bfloat16, True)
    batch = tp_batch(cfg, TP_BATCH, 11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, counts = [], [], []
    for i in range(TP_STEPS):
        reset_flash_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if i == TP_STEPS - 1:
            with CountAllReduce() as per_step:
                state, m = step(state, batch)
        else:
            state, m = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        counts.append(flash_counts())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"tp bf16 losses {losses} not finite and "
                             f"falling")
    for c in counts:
        if (c["fwd"], c["dq"], c["dkv"]) != (24, 12, 12) or \
                c["by_route"]["fwd"]["sm90"] != 24:
            raise AssertionError(f"tp step B1-B3 {c}, not 24 / 12 / 12 "
                                 f"on sm90")
    with torch.no_grad(), CountAllReduce() as fwd:
        loss_fn(state.params, batch, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = union_us(device_spans(prof)) / 1e6 / wall
    with torch.no_grad():
        tree: dict = {}
        for path, p in tree_flatten(state.params):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = canonical(p, p, mesh)
    res = {"losses": losses, "step_ms": ms, "peak_gib": peak,
           "busy": busy, "profiled_wall_s": wall,
           "all_reduces_step": per_step.n, "all_reduces_forward": fwd.n,
           "flash": counts[-1], "flash_total": {
               k: sum(c[k] for c in counts) for k in ("fwd", "dq", "dkv")},
           "flash_routes": {k: {r: sum(c["by_route"][k][r] for c in counts)
                                for r in counts[0]["by_route"][k]}
                            for k in ("fwd", "dq", "dkv")}}
    del state
    torch.cuda.empty_cache()
    return res, tree


# the phase's first 4 requests go through generate(mesh=): all 8 took
# over 20 s a dtype on the card's host
TP_GEN_REQUESTS = 4


def tp_mesh_generate(mesh, params, cfg, dtype, reqs) -> dict:
    """Dense decode at tp:2 on both ranks: ``jit_generate(mesh=)`` over
    ``shard_params(params, mesh, GPT.SHARDING_RULES)``, greedy, each
    request at batch 1. Gates: B1 exactly ``n_layers`` launches a
    request (the prefill, over this rank's 6 heads), all on ``"sm90"``
    at bf16 and ``"f32"`` at fp32; one cached shape a prompt length; the
    first request again under ``CountAllReduce``: 2 all-reduces a layer
    and token (the proj and fc2 row products; GPT-2 small ties its head,
    so no vocabulary gather), the same ids. Returns the streams and ms a
    new token (prefill included)."""
    from torchbooster_tpu_torch.models.gpt import GPT, jit_generate
    from torchbooster_tpu_torch.parallel.sharding import shard_params

    placed = shard_params(params, mesh, GPT.SHARDING_RULES)
    fn = jit_generate(cfg, n_new=N_NEW, temperature=0.0, compute_dtype=dtype,
                      mesh=mesh)
    reset_flash_counts()
    tokens, request_s = [], []
    for r in reqs:
        ids = torch.as_tensor(r.prompt, device=mesh.device).long()[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = fn(placed, ids)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
        tokens.append(full[0, ids.shape[1]:].tolist())
    counts = flash_counts()
    route = "sm90" if dtype == torch.bfloat16 else "f32"
    if counts["fwd"] != cfg.n_layers * len(reqs) \
            or counts["by_route"]["fwd"][route] != counts["fwd"]:
        raise AssertionError(f"tp generate {dtype}: B1 {counts}, not "
                             f"{cfg.n_layers} x {len(reqs)} on {route!r}")
    shapes = len({len(r.prompt) for r in reqs})
    ids = torch.as_tensor(reqs[0].prompt, device=mesh.device).long()[None]
    with CountAllReduce() as ar:
        again = fn(placed, ids)[0, ids.shape[1]:].tolist()
    want_ar = 2 * cfg.n_layers * N_NEW
    if ar.n != want_ar or again != tokens[0] or fn._cache_size() != shapes:
        raise AssertionError(
            f"tp generate {dtype}: {ar.n} all-reduces over {N_NEW} tokens "
            f"(want {want_ar}), {fn._cache_size()} cached shapes for "
            f"{shapes}, repeat equal {again == tokens[0]}")
    del placed
    return {"tokens": tokens, "b1": counts["fwd"], "b1_route": route,
            "all_reduces_token": ar.n / N_NEW, "requests": len(reqs),
            "wall_s": sum(request_s),
            "ms_per_token": ms_per_token(request_s, N_NEW)}


def tp_serve(mesh, params, cfg, dtype) -> dict:
    """The trained tree (its head x4, decisive) served at tp:2: 8
    requests of 64-512 tokens, 32 new, page size 64; B4 launches a rank,
    decode steps, pool bytes, all-reduces a decode step; then the same
    requests through dense ``generate(mesh=)`` (:func:`tp_mesh_generate`).
    Rank 0 holds the engine's and the dense mesh decode's streams
    token-exact against the dense ``generate`` at tp:1."""
    from torchbooster_tpu_torch.config import ServingConfig
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    batcher = ServingConfig(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                            tp=2).make(params, cfg, compute_dtype=dtype,
                                       on_recompile="raise", mesh=mesh,
                                       device=mesh.device)
    eng = batcher.engine
    steps = [0]
    real_step = eng.step

    def counted_step():
        steps[0] += 1
        return real_step()

    eng.step = counted_step
    reqs = requests(cfg)
    reset_paged_counts()
    t0 = time.perf_counter()
    batcher.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    if launches != cfg.n_layers * steps[0]:
        raise AssertionError(f"tp serving: B4 {launches} launches, not "
                             f"{cfg.n_layers} x {steps[0]} decode steps")
    want_route = "sm90" if dtype == torch.bfloat16 else "simt"
    if by_route[want_route] != launches:
        raise AssertionError(f"tp serving B4 by route {by_route}")
    # its all-reduces go through gloo on the host: eager by the plan
    if eng.step_route != "eager" or eng.graph_replays:
        raise AssertionError(f"tp serving: route {eng.step_route!r}, "
                             f"{eng.graph_replays} replays")
    pool = sum(t.numel() * t.element_size()
               for half in ("k", "v") for t in (
                   eng.pool[half] if isinstance(eng.pool[half], tuple)
                   else (eng.pool[half],)))
    full = 2 * cfg.n_layers * N_PAGES * PS * cfg.kv_heads * cfg.head_dim \
        * torch.empty((), dtype=dtype).element_size()
    if pool * 2 != full:
        raise AssertionError(f"tp pool {pool} B, not half of tp:1's {full}")
    eng.admit(np.asarray(reqs[0].prompt[:64]))
    eng.grow_slots()
    with CountAllReduce() as per_step:
        real_step()
    torch.cuda.synchronize()
    out = {"tokens": [list(r.tokens) for r in reqs], "launches": launches,
           "by_route": by_route, "decode_steps": steps[0],
           "pool_bytes": pool, "pool_bytes_tp1": full, "wall_s": wall,
           "all_reduces_decode_step": per_step.n,
           "traffic": eng.tp_step_traffic(1),
           "decode_compiles": eng.decode_compiles,
           "step_route": eng.step_route,
           "step_route_reason": eng.step_route_reason}
    del batcher, eng
    torch.cuda.empty_cache()
    gen = out["mesh_generate"] = tp_mesh_generate(
        mesh, params, cfg, dtype, reqs[:TP_GEN_REQUESTS])
    if mesh.rank == 0:
        want, dc = dense_tokens(params, cfg, reqs, dtype)
        # the tp:1 figure over the requests the mesh decode ran
        gen["tp1_ms_per_token"] = ms_per_token(
            dc["request_s"][:len(gen["tokens"])], dc["n_new"])
        for name, got in (("serving", out["tokens"]),
                          ("generate(mesh=)", gen["tokens"])):
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            if bad:
                raise AssertionError(f"tp:2 {dtype} {name} differs from "
                                     f"the dense generate on requests "
                                     f"{bad}")
    torch.cuda.empty_cache()
    return out


def tp_rank(smi: str) -> dict:
    """One of the two gloo ranks of the ``tp`` phase, on the one card:
    the fp32 check, the bf16 run, then the trained tree served at fp32
    and bf16. Every rank returns its own counts and numbers."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = dist.make_mesh("tp:2", device=DEV)
    if mesh.device.type != torch.device(DEV).type:
        raise AssertionError(f"tp mesh on {mesh.device}, not the card")
    cfg = GPTConfig()
    out = {"rank": mesh.rank, "fp32": tp_fp32_check(mesh, cfg)}
    out["bf16"], params = tp_bf16_train(mesh, cfg, smi)
    params["wte"]["table"] = params["wte"]["table"] * 4.0
    out["serve"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        out["serve"][str(dtype)] = tp_serve(mesh, params, cfg, dtype)
    return out


def phase_tp(report: dict, smi: str) -> dict:
    """GPT-2 small at ``tp:2`` in two processes on the one card, a gloo
    group over tensors on the card (NCCL refuses two ranks on one card;
    gloo takes the all-reduces and broadcasts the path issues). The
    kernels are built before the spawn, so no two ranks race on the
    build. Returns both ranks' B1-B3 and B4 launches."""
    from torchbooster_tpu_torch import distributed as dist
    from torchbooster_tpu_torch.ops import flash_attention as fa
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    log("tp plans at 6 heads, D 64, bf16: B1 "
        f"{fa.plan_flash_fwd(torch.bfloat16, 64, 1024, 1024, 1)} at S 1024 "
        f"(and batch 1 x 1024), B2/B3 "
        f"{fa.plan_flash_bwd(torch.bfloat16, 64, 1024, 1024, 1)}, B4 "
        f"{pa.plan_paged(torch.bfloat16, torch.bfloat16, 64, PS, 1, 1)} "
        f"at decode, {pa.plan_paged(torch.float32, torch.float32, 64, PS, 1, 1)}"
        f" at fp32")
    compute_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    ranks = dist.launch(tp_rank, n_devices=2, device=DEV, backend="gloo",
                        args=(smi,))
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    fp = r0["fp32"]
    log(f"tp fp32 tp:2 vs tp:1 ({TP_FP32_STEPS} steps, batch "
        f"{TP_FP32_BATCH} x 1024, TF32 off): losses {fp['losses']} vs "
        f"{fp['ref_losses']}, worst rel {fp['loss_rel']:.2e}; gradients "
        f"worst |err| / max|ref| {fp['grad_worst']:.2e} (bound {TP_RTOL})")
    for r in ranks:
        b = r["bf16"]
        log(f"tp bf16 rank {r['rank']}: losses "
            f"{[round(x, 4) for x in b['losses']]}; step ms "
            f"{[round(x, 1) for x in b['step_ms']]}; peak "
            f"{b['peak_gib']:.2f} GiB; busy {100 * b['busy']:.1f}% of a "
            f"profiled step's {b['profiled_wall_s']:.3f} s; all-reduces "
            f"{b['all_reduces_step']} a step, {b['all_reduces_forward']} in "
            f"a forward; B1-B3 a step {b['flash']['fwd']} / "
            f"{b['flash']['dq']} / {b['flash']['dkv']} (sm90)")
        for key, sv in r["serve"].items():
            g = sv["mesh_generate"]
            if g["tokens"] != r0["serve"][key]["mesh_generate"]["tokens"]:
                raise AssertionError(f"tp generate {key}: rank {r['rank']}'s "
                                     f"streams differ from rank 0's")
            log(f"tp generate {key} rank {r['rank']}: "
                f"{g['requests']}/{g['requests']} token-exact vs the dense "
                f"generate at tp:1 and equal across ranks; B1 {g['b1']} "
                f"({g['b1_route']}, {g['b1'] // g['requests']} a request); "
                f"all-reduces a token {g['all_reduces_token']:.0f}; "
                f"{g['ms_per_token']:.3f} ms a new token (prefill included, "
                f"batch 1; the dense generate at tp:1 on the same requests "
                f"{r0['serve'][key]['mesh_generate']['tp1_ms_per_token']:.3f}"
                f"); wall {g['wall_s']:.2f} s")
            log(f"tp serve {key} rank {r['rank']}: 8/8 token-exact vs the "
                f"dense generate at tp:1; B4 {sv['launches']} = 12 x "
                f"{sv['decode_steps']} decode steps ({sv['by_route']}); "
                f"pool {sv['pool_bytes'] / 2 ** 20:.1f} MiB = half of tp:1's "
                f"{sv['pool_bytes_tp1'] / 2 ** 20:.1f}; all-reduces a decode "
                f"step {sv['all_reduces_decode_step']}; step_traffic "
                f"{sv['traffic']['wire_bytes']:.0f} B a step; wall "
                f"{sv['wall_s']:.2f} s; decode shapes "
                f"{sv['decode_compiles']}; step route {sv['step_route']} "
                f"({sv['step_route_reason']})")
    log(f"tp: compute mode {compute_mode}; two gloo ranks on one card; "
        f"{wall:.1f} s with the spawn; {smi}")
    report["tp"] = {"ranks": ranks, "wall_s": wall, "card": smi,
                    "compute_mode": compute_mode}
    flash = {k: sum(r["bf16"]["flash_total"][k] for r in ranks)
             for k in ("fwd", "dq", "dkv")}
    flash["by_route"] = {k: {rt: sum(r["bf16"]["flash_routes"][k][rt]
                                     for r in ranks)
                             for rt in ranks[0]["bf16"]["flash_routes"][k]}
                         for k in ("fwd", "dq", "dkv")}
    # the dense mesh decode's prefills add B1 launches on both ranks
    for r in ranks:
        for sv in r["serve"].values():
            g = sv["mesh_generate"]
            flash["fwd"] += g["b1"]
            flash["by_route"]["fwd"][g["b1_route"]] += g["b1"]
    paged = {"launches": sum(sv["launches"] for r in ranks
                             for sv in r["serve"].values()),
             "by_route": {rt: sum(sv["by_route"][rt] for r in ranks
                                  for sv in r["serve"].values())
                          for rt in ("sm90", "simt")}}
    return {"flash": flash, "paged": paged}


def pp_fold_run(params, cfg, ids, labels, dtype, ran: list | None = None):
    """GPT-2 small's forward and backward with its blocks through
    ``fold_apply``: pp:4 (3 layers a stage), 8 microbatches of one row,
    the port's ``pipeline_layer`` under remat. Returns logits and the
    gradients by path."""
    from torchbooster_tpu_torch.models.gpt import (
        _embed,
        _lm_head,
        pipeline_layer,
    )
    from torchbooster_tpu_torch.ops.losses import cross_entropy
    from torchbooster_tpu_torch.parallel.pipeline import fold_apply
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    layer = pipeline_layer(cfg, True, "auto", PP_MB)

    def counted(layer_in, h, mb):
        # the schedule's layer calls, in order (the remat recompute in
        # backward runs inside ``layer``, not through here)
        if ran is not None:
            ran.append((int(layer_in[1]), mb))
        return layer(layer_in, h, mb)

    x = _embed(params, ids, dtype)
    h, _ = fold_apply(counted,
                      (params["blocks"], torch.arange(cfg.n_layers)),
                      x, PP_STAGES, PP_MB, with_mb_index=True, with_aux=True)
    logits = _lm_head(params, h)
    cross_entropy(logits.float(), labels).backward()
    grads = {p: leaf.grad for p, leaf in tree_flatten(params)}
    for _, leaf in tree_flatten(params):
        leaf.grad = None
    return logits.detach(), grads


def pp_plain_run(params, cfg, ids, labels, dtype):
    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.ops.losses import cross_entropy
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    logits = GPT.apply(params, ids, cfg, compute_dtype=dtype, remat=True)
    cross_entropy(logits.float(), labels).backward()
    grads = {p: leaf.grad for p, leaf in tree_flatten(params)}
    for _, leaf in tree_flatten(params):
        leaf.grad = None
    return logits.detach(), grads


def phase_pp_fold(report: dict, smi: str) -> dict:
    """GPT-2 small at ``pp:4`` folded on the one card: all four stages in
    this process, the port's ``stage_tick`` under ``fold_apply`` with the
    rotation in-process. Out and gradients held to the un-pipelined
    ``GPT.apply`` on the card: fp32 (TF32 off) at ``TP_RTOL``, bf16 at
    atol = rtol = 2e-2 and ||err|| / ||ref|| <= 2^-6 a tensor. Returns
    the bf16 fold's B1-B3 launches."""
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
    from torchbooster_tpu_torch.parallel.sharding import tree_flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig()
    params = GPT.init(TP_SEED, cfg, device=DEV)
    for _, leaf in tree_flatten(params):
        leaf.requires_grad_(True)
    b = tp_batch(cfg, PP_MB, 13)
    ids, labels = b["ids"], b["labels"]
    out: dict = {"card": smi}
    want_l, want_g = pp_plain_run(params, cfg, ids, labels, torch.float32)
    got_l, got_g = pp_fold_run(params, cfg, ids, labels, torch.float32)
    worst = held_rel("pp_fold fp32 logits", got_l, want_l, TP_RTOL)
    for path in want_g:
        worst = max(worst, held_rel("pp_fold fp32 grad " + "/".join(path),
                                    got_g[path], want_g[path], TP_RTOL))
    out["fp32_worst"] = worst
    del want_g, got_g
    want_l, want_g = pp_plain_run(params, cfg, ids, labels, torch.bfloat16)
    ran: list = []
    reset_flash_counts()
    got_l, got_g = pp_fold_run(params, cfg, ids, labels, torch.bfloat16,
                               ran)
    torch.cuda.synchronize()
    launches = flash_counts()
    if (launches["fwd"], launches["dq"], launches["dkv"]) != (192, 96, 96) \
            or launches["by_route"]["fwd"]["sm90"] != 192:
        raise AssertionError(f"pp_fold B1-B3 {launches}, not 192 / 96 / 96 "
                             f"on sm90")
    # tick t: stage s runs microbatch t - s where it exists, its layers
    # in order; a stage that ran on an inactive tick adds calls
    per = cfg.n_layers // PP_STAGES
    want_ran = [(s * per + j, t - s) for t in range(PP_MB + PP_STAGES - 1)
                for s in range(PP_STAGES) if 0 <= t - s < PP_MB
                for j in range(per)]
    if ran != want_ran:
        raise AssertionError(f"pp_fold ran {ran}: a stage ran on an "
                             f"inactive tick or skipped an active one")
    pairs = [("logits", got_l, want_l)] + [
        ("/".join(p), got_g[p], want_g[p]) for p in want_g]
    errs, used = hold_flash("pp_fold bf16", SP_FOLD_TOL, pairs)
    norm = torch.linalg.vector_norm
    rel = {k: (norm(g.float() - w.float()) / norm(w.float())).item()
           for k, g, w in pairs}
    if max(rel.values()) > SP_FOLD_REL:
        raise AssertionError(f"pp_fold bf16 ||err|| / ||ref|| "
                             f"{max(rel.values()):.3e} > 2^-6")
    out.update(bf16_max_abs_err=max(errs.values()),
               bf16_allowance_used=max(used.values()),
               bf16_rel=max(rel.values()), launches=launches)

    def fold_step():
        pp_fold_run(params, cfg, ids, labels, torch.bfloat16)

    def plain_step():
        pp_plain_run(params, cfg, ids, labels, torch.bfloat16)

    out["fold_ms"] = cuda_ms(fold_step, iters=3, warmup=1)
    out["plain_ms"] = cuda_ms(plain_step, iters=3, warmup=1)
    out["fold_device_ms"] = call_device_ms(fold_step)
    out["plain_device_ms"] = call_device_ms(plain_step)
    log(f"pp_fold pp:4 x 8 microbatches of 1 x 1024: fp32 worst |err| / "
        f"max|ref| {worst:.2e} (bound {TP_RTOL}); bf16 worst element "
        f"{out['bf16_max_abs_err']:.2e} ({100 * out['bf16_allowance_used']:.0f}% "
        f"of atol = rtol = {SP_FOLD_TOL}), ||err|| / ||ref|| "
        f"{out['bf16_rel']:.2e} (bound 2^-6); B1-B3 192 / 96 / 96 (sm90); "
        f"{len(ran) // per} active (stage, tick) pairs of "
        f"{PP_STAGES * (PP_MB + PP_STAGES - 1)}, none inactive")
    log(f"pp_fold timing (a finding): fold {out['fold_ms']:.1f} ms, "
        f"device {out['fold_device_ms']:.1f} ms; un-pipelined step "
        f"{out['plain_ms']:.1f} ms, device {out['plain_device_ms']:.1f} ms; "
        f"{smi}")
    report["pp_fold"] = out
    del params
    torch.cuda.empty_cache()
    return {**{k: launches[k] for k in ("fwd", "dq", "dkv")},
            "by_route": launches["by_route"]}


def call_device_ms(fn) -> float:
    """Device ms of one call of ``fn``: the union of its kernel intervals
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return union_us(device_spans(prof)) / 1e3


# ------------------------------------------------------------------ conv
RN_B = 512            # the ResNet recipe's batch (examples/img_cls/resnet)
GROUPS = 32
# (name, kind, B, H, W, Cin, Cout, stride); kind "gn" runs B5 and B6,
# "1x1" B7, "3x3" B8. The first eleven are the ResNet-18 CIFAR training
# path at batch 512 (stage s at 32 / 2^s): the stem norm and the stride-2
# 3x3s' norms (B5/B6), the stride-2 projections (B7), the stride-1 3x3s.
CONV_MAIN = [
    ("stem_gn", "gn", RN_B, 32, 32, 64, 64, 1),
    ("stage1_gn", "gn", RN_B, 16, 16, 128, 128, 1),
    ("stage2_gn", "gn", RN_B, 8, 8, 256, 256, 1),
    ("stage3_gn", "gn", RN_B, 4, 4, 512, 512, 1),
    ("stage1_proj", "1x1", RN_B, 32, 32, 64, 128, 2),
    ("stage2_proj", "1x1", RN_B, 16, 16, 128, 256, 2),
    ("stage3_proj", "1x1", RN_B, 8, 8, 256, 512, 2),
    ("stage0_3x3", "3x3", RN_B, 32, 32, 64, 64, 1),
    ("stage1_3x3", "3x3", RN_B, 16, 16, 128, 128, 1),
    ("stage2_3x3", "3x3", RN_B, 8, 8, 256, 256, 1),
    ("stage3_3x3", "3x3", RN_B, 4, 4, 512, 512, 1),
]
# calls of each main-path geometry per training step (forward)
CONV_PER_STEP = {"stem_gn": 1, "stage1_gn": 1, "stage2_gn": 1,
                 "stage3_gn": 1, "stage1_proj": 1, "stage2_proj": 1,
                 "stage3_proj": 1, "stage0_3x3": 4, "stage1_3x3": 3,
                 "stage2_3x3": 3, "stage3_3x3": 3}
# ResNet-50 at 224² (bottleneck geometries, batch 32) and a non-square map
CONV_EXTRA = [
    ("r50_56sq_1x1_64to256", "1x1", 32, 56, 56, 64, 256, 1),
    ("r50_56sq_3x3_64", "3x3", 32, 56, 56, 64, 64, 1),
    ("r50_7sq_gn_2048", "gn", 32, 7, 7, 2048, 2048, 1),
    ("nonsquare_7x9_gn", "gn", 8, 7, 9, 64, 64, 1),
    ("nonsquare_7x9_1x1_s2", "1x1", 8, 7, 9, 64, 128, 2),
    ("nonsquare_7x9_3x3", "3x3", 8, 7, 9, 64, 32, 1),
    # widths off the 16-byte vectors: the one-element load routes, a
    # ragged Cout tile and 20 groups of 2 (``groups`` clipped from 32)
    ("odd_c12_gn", "gn", 8, 7, 9, 12, 12, 1),
    ("odd_cin12_cout40_3x3", "3x3", 8, 7, 9, 12, 40, 1),
    ("odd_cin12_cout40_1x1_s2", "1x1", 8, 7, 9, 12, 40, 2),
    # B8's one-pass routes at small batch: a cluster of 8 CTAs per sample,
    # a pack of 8 whose only pack holds 5 samples
    ("cluster_b3_32sq_3x3", "3x3", 3, 32, 32, 64, 64, 1),
    ("pack_rem_b5_4sq_3x3", "3x3", 5, 4, 4, 512, 512, 1),
    # B5's two samples a CTA, the last CTA holding one
    ("pack_rem_b3_8sq_gn", "gn", 3, 8, 8, 256, 256, 1),
]
# cases whose bf16 calls must repeat bit for bit: B8 on each route, B7 on
# both one-pass routes ("cluster" at 16², "pack" of 8 at 4²), B6 at
# clusters of 4, 2 and 1 CTAs
CONV_REPEAT = ("stage0_3x3", "stage3_3x3", "pack_rem_b5_4sq_3x3",
               "odd_cin12_cout40_3x3", "stage1_proj", "stage3_proj",
               "stem_gn", "stage1_gn", "nonsquare_7x9_gn")
# B5's: a cluster of 2 CTAs (the stem), one CTA of 16 and of 63 positions,
# two samples a CTA
GN_FWD_REPEAT = ("stem_gn", "stage3_gn", "nonsquare_7x9_gn", "stage2_gn")


def groups_for(c: int) -> int:
    """The recipe's 32 groups, clipped to a divisor of ``c`` as
    ``layers.group_norm`` and the fused kernels' wrappers clip them."""
    g = min(GROUPS, c)
    while c % g:
        g -= 1
    return g


# the kernel each kernels-line entry is timed at: the largest main-path call
CONV_TIMED = {"gn_fwd": "stem_gn", "gn_bwd": "stem_gn",
              "conv1x1": "stage1_proj", "conv3x3": "stage0_3x3"}
# atol = rtol, per dtype. bf16: both sides compute in fp32 from the same
# bf16 values and round the output once, so one bf16 ulp of the output;
# fp32: only the summation order differs
CONV_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def conv_inputs(gen, kind, b, h, w, cin, cout, dtype):
    """x (and dy for "gn") in ``dtype``, w (k, k, Cin, Cout) scaled by
    1/sqrt(fan-in) in ``dtype``, scale and bias fp32."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    k = 3 if kind == "3x3" else 1
    x = (randn(b, h, w, cin) * 2.0 + 0.5).to(dtype)
    return dict(x=x, dy=randn(b, h, w, cin).to(dtype),
                w=(randn(k, k, cin, cout) / math.sqrt(k * k * cin)).to(dtype),
                scale=1.0 + 0.1 * randn(cout), bias=0.1 * randn(cout))


def planned_route(case, dtype, key: str = "gn_bwd") -> str:
    """The route ``case``'s kernel takes at ``dtype``: B8's and B7's from
    their plans (``"f32"`` at fp32); for a GroupNorm case, B5's
    (``plan_gn_fwd``) when ``key`` is ``"gn_fwd"``, else B6's
    (``plan_gn_bwd``)."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    _, kind, b, h, w, cin, cout, stride = case
    if kind == "gn":
        plan = gnk.plan_gn_fwd if key == "gn_fwd" else gnk.plan_gn_bwd
        return plan(b, h * w, cin, groups_for(cin), dtype).route
    if dtype != torch.bfloat16:
        return "f32"
    if kind == "1x1":
        return fb.plan_conv1x1(b, h, w, cin, cout, groups_for(cout),
                               stride).route
    return fb.plan_conv3x3(b, h, w, cin, cout, groups_for(cout)).route


# the older route each one-pass route is also forced onto and timed beside
OLDER_ROUTE = {"one_pass": "two_pass", "cluster": "mma_sync",
               "pack": "mma_sync"}


def counted(counter: dict, route: str, call):
    """``call()``, asserting that it moved ``counter`` (a per-route launch
    count) by one on ``route`` and nowhere else."""
    before = dict(counter)
    res = call()
    torch.cuda.synchronize()
    if counter != {**before, route: before[route] + 1}:
        raise AssertionError(f"expected one launch on the {route!r} route: "
                             f"{counter} after {before}")
    return res


def check_conv_case(gen, case, dtype, relu) -> tuple[dict, dict]:
    """One geometry through its kernel(s) and plain version(s): max abs
    error and the share of the allowance atol + rtol|ref| used, per
    output. B5's-B8's per-route counters must move on the planned route; a
    one-pass route's case runs forced onto the older route too (outputs
    keyed ``<name>@<route>``)."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    name, kind, b, h, w, cin, cout, stride = case
    a = conv_inputs(gen, kind, b, h, w, cin, cout, dtype)
    x, s, bi = a["x"], a["scale"], a["bias"]
    g = groups_for(cout)
    route = planned_route(case, dtype)
    routes = [route] + ([OLDER_ROUTE[route]]
                        if route in OLDER_ROUTE and kind != "3x3" else [])
    if kind == "gn":
        y_ref, st_ref = gnk.group_norm_fwd_reference(x, s, bi, g, 1e-5, relu)
        dx_ref, part_ref = gnk.group_norm_bwd_reference(
            x, a["dy"], st_ref, s, bi, g, relu)
        pairs = {}
        fwd = planned_route(case, dtype, "gn_fwd")
        for i, r in enumerate([fwd] + ([OLDER_ROUTE[fwd]]
                                       if fwd in OLDER_ROUTE else [])):
            y, st = counted(gnk.launches_fwd_by_route, r, lambda: (
                gnk.launch_fwd(x, s, bi, g, 1e-5, relu,
                               route=None if i == 0 else r)))
            tag = "" if i == 0 else f"@{r}"
            pairs.update({f"y{tag}": (y, y_ref), f"stats{tag}": (st, st_ref)})
        for i, r in enumerate(routes):
            dx, part = counted(gnk.launches_bwd_by_route, r, lambda: (
                gnk.launch_bwd(x, a["dy"], st_ref, s, bi, g, relu,
                               route=None if i == 0 else r)))
            tag = "" if i == 0 else f"@{r}"
            pairs.update({f"dx{tag}": (dx, dx_ref),
                          f"part{tag}": (part, part_ref)})
    else:
        ref = fb.conv_gn_reference(x, a["w"], s, bi, g, 1e-5, relu, stride)
        pairs = {}
        for i, r in enumerate(routes):
            if kind == "1x1":
                got = counted(fb.launches_1x1_by_route, r, lambda: (
                    fb.launch_1x1(x, a["w"], s, bi, g, 1e-5, relu, stride,
                                  route=None if i == 0 else r)))
            else:
                got = counted(fb.launches_3x3_by_route, r, lambda: (
                    fb.launch_3x3(x, a["w"], s, bi, g, 1e-5, relu)))
            tag = "" if i == 0 else f"@{r}"
            pairs.update({f"{k}{tag}": (o, want) for k, o, want in
                          zip(("out", "mu", "rstd"), got, ref)})
    tol = CONV_TOL[dtype]
    errs, used = {}, {}
    for key, (got, want) in pairs.items():
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        errs[key] = diff.max().item()
        used[key] = (diff / (tol + tol * want.abs())).max().item()
        if not (used[key] <= 1.0 and math.isfinite(errs[key])):
            raise AssertionError(f"conv case {name} {dtype} relu={relu}: "
                                 f"{key} disagrees with the plain version: "
                                 f"max abs err {errs[key]} (atol = rtol = "
                                 f"{tol})")
    return errs, used


def conv_work(case, el: int) -> dict:
    """Bytes each kernel must move (each input read once, each output
    written once) and the operations it does, per call. "gn_fwd": x in, y
    out, stats; about 6 fp32 flops an element (moments, affine, ReLU).
    "gn_bwd": x and dy in, dx out, stats and partials; about 12. "conv":
    the positions the conv reads (the strided quarter for a stride-2 1x1),
    the weight, out, mu/rstd; 2 flops per multiply-add of the product, at
    the tensor-core rate."""
    name, kind, b, h, w, cin, cout, stride = case
    if kind == "gn":
        n = b * h * w * cin
        small = 2 * cin * 4 + b * 2 * cin * 4
        return {"gn_fwd": (2 * n * el + small, 6 * n, FP32_FLOPS),
                "gn_bwd": (3 * n * el + small + b * 2 * cin * 4, 12 * n,
                           FP32_FLOPS)}
    k = 3 if kind == "3x3" else 1
    ho, wo = (h + stride - 1) // stride, (w + stride - 1) // stride
    x_pos = b * (ho * wo if k == 1 else h * w) * cin
    nbytes = (x_pos + k * k * cin * cout + b * ho * wo * cout) * el \
        + 2 * cout * 4 + 2 * b * cout * 4
    flops = 2 * b * ho * wo * cout * k * k * cin
    key = "conv1x1" if kind == "1x1" else "conv3x3"
    return {key: (nbytes, flops, BF16_FLOPS if el == 2 else FP32_FLOPS)}


def time_conv_case(gen, case) -> dict:
    """Each kernel of one main-path geometry at bf16 (ReLU as on the
    path: on for the norms and the 3x3 timed, off for the projections)
    beside its plain version, its bound and the library yardstick."""
    import torch.nn.functional as F

    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    name, kind, b, h, w, cin, cout, stride = case
    dtype = torch.bfloat16
    relu = kind != "1x1"
    a = conv_inputs(gen, kind, b, h, w, cin, cout, dtype)
    x, s, bi = a["x"], a["scale"], a["bias"]
    x4 = x.permute(0, 3, 1, 2)                  # channels-last NCHW view
    s_x, b_x = s.to(dtype), bi.to(dtype)
    runs = {}
    if kind == "gn":
        _, st = gnk.launch_fwd(x, s, bi, GROUPS, 1e-5, relu)
        xg = x4.detach().clone(memory_format=torch.channels_last) \
            .requires_grad_()
        sg, bg = s_x.clone().requires_grad_(), b_x.clone().requires_grad_()
        out_lib = F.group_norm(xg, GROUPS, sg, bg, 1e-5)
        dy4 = a["dy"].permute(0, 3, 1, 2)
        runs["gn_fwd"] = (
            lambda: gnk.launch_fwd(x, s, bi, GROUPS, 1e-5, relu),
            lambda: gnk.group_norm_fwd_reference(x, s, bi, GROUPS, 1e-5,
                                                 relu),
            lambda: F.group_norm(x4, GROUPS, s_x, b_x, 1e-5))
        runs["gn_bwd"] = (
            lambda: gnk.launch_bwd(x, a["dy"], st, s, bi, GROUPS, relu),
            lambda: gnk.group_norm_bwd_reference(x, a["dy"], st, s, bi,
                                                 GROUPS, relu),
            lambda: torch.autograd.grad(out_lib, (xg, sg, bg), dy4,
                                        retain_graph=True))
    else:
        k = 3 if kind == "3x3" else 1
        w4 = a["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pad = (k - 1) // 2

        def library():
            y = F.group_norm(F.conv2d(x4, w4, stride=stride, padding=pad),
                             GROUPS, s_x, b_x, 1e-5)
            return F.relu(y) if relu else y

        if kind == "1x1":
            kern = lambda: fb.launch_1x1(x, a["w"], s, bi, GROUPS, 1e-5,  # noqa: E731
                                         relu, stride)
            key = "conv1x1"
        else:
            kern = lambda: fb.launch_3x3(x, a["w"], s, bi, GROUPS, 1e-5,  # noqa: E731
                                         relu)
            key = "conv3x3"
        runs[key] = (kern, lambda: fb.conv_gn_reference(
            x, a["w"], s, bi, GROUPS, 1e-5, relu, stride), library)
    work = conv_work(case, 2)
    routes = {key: planned_route(case, dtype, key) for key in runs}
    # the older route on the same inputs, timed beside the planned one: B8's
    # two-pass mma_sync kernel (outside the launch counters), B7 forced onto
    # "mma_sync", B5 and B6 onto "two_pass"
    older = {"conv3x3": lambda: fb._launch(x, a["w"], s, bi, GROUPS, 1e-5,
                                           relu, 1)}
    if routes.get("conv1x1") in OLDER_ROUTE:
        older["conv1x1"] = lambda: fb.launch_1x1(
            x, a["w"], s, bi, GROUPS, 1e-5, relu, stride,
            route=OLDER_ROUTE[routes["conv1x1"]])
    if routes.get("gn_fwd") in OLDER_ROUTE:
        older["gn_fwd"] = lambda: gnk.launch_fwd(
            x, s, bi, GROUPS, 1e-5, relu,
            route=OLDER_ROUTE[routes["gn_fwd"]])
    if routes.get("gn_bwd") in OLDER_ROUTE:
        older["gn_bwd"] = lambda: gnk.launch_bwd(
            x, a["dy"], st, s, bi, GROUPS, relu,
            route=OLDER_ROUTE[routes["gn_bwd"]])
    out = {}
    for key, (kern, plain, lib) in runs.items():
        route = routes[key]
        fns = {"kernel": kern, "plain": plain, "library": lib}
        if key in older:
            fns["previous"] = older[key]
        iters = {"plain": 5}
        call = {c: cuda_ms(fn, iters=iters.get(c, 20),
                           warmup=2 if c == "plain" else 5)
                for c, fn in fns.items()}
        own = {}
        dev = {c: device_ms(fn, iters=iters.get(c, 20),
                            by_kernel=own if c == "kernel" else None)
               for c, fn in fns.items()}
        # the port's launches (kernel, older route) are also timed by
        # replays of a CUDA graph; each column whose profiler window lost
        # events takes that time, or, for the plain version and the library
        # call, CUDA events around back-to-back calls
        graphed = {c: graph_ms(fn) for c, fn in fns.items()
                   if c in ("kernel", "previous")}
        stream = {c: stream_ms(fn, iters=iters.get(c, 20),
                               warmup=2 if c == "plain" else 5)
                  for c, fn in fns.items() if not dev[c] and c not in graphed}
        src = {c: dev[c] or graphed.get(c) or stream[c] for c in fns}
        timed_by = {c: DEVICE_TIME if dev[c] else GRAPH_TIME if c in graphed
                    else "CUDA events over back-to-back calls" for c in fns}
        nbytes, flops, peak = work[key]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        out[key] = {"ms": src["kernel"], "plain_ms": src["plain"],
                    "sum_ms": sum(own.values()) if dev["kernel"] else None,
                    "library_ms": src["library"],
                    "previous_ms": src.get("previous"),
                    "timed_by": timed_by["kernel"], "column_timed_by": timed_by,
                    "call_ms": call, "device_ms": dev, "stream_ms": stream,
                    "graph_ms": graphed, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops}
        extra = ""
        out[key]["route"] = route
        if key == "conv3x3":
            # the product counted once, whatever the route computes
            out[key]["tflops"] = flops / (src["kernel"] * 1e-3) / 1e12
            out[key]["two_pass_ms"] = src["previous"]
            extra = (f"; route {route}, {out[key]['tflops']:.1f} TFLOP/s; "
                     f"two-pass mma_sync {src['previous'] * 1e3:.1f} us")
        else:
            if key == "conv1x1":
                plan = fb.plan_conv1x1(b, h, w, cin, cout, GROUPS, stride)
                ctas = (fb.ctas_per_sm_1x1(plan) if route in OLDER_ROUTE
                        else None)
            elif key == "gn_fwd":
                plan = gnk.plan_gn_fwd(b, h * w, cin, GROUPS, dtype)
                ctas = (gnk.ctas_per_sm_fwd(plan, cin, GROUPS)
                        if route in OLDER_ROUTE else None)
            else:
                plan = gnk.plan_gn_bwd(b, h * w, cin, GROUPS, dtype)
                ctas = (gnk.ctas_per_sm_bwd(plan, cin, GROUPS)
                        if route in OLDER_ROUTE else None)
            out[key]["ctas_per_sm"] = ctas
            out[key]["plan"] = plan._asdict()
            extra = f"; {plan}, {ctas} CTAs per SM"
            if "previous" in src:
                extra += (f"; {OLDER_ROUTE[route]} "
                          f"{src['previous'] * 1e3:.1f} us")
            if key == "gn_fwd" and route == "one_pass":
                out[key]["plan_sweep"] = gn_fwd_plan_sweep(
                    x, s, bi, relu, plan)
            if key == "gn_bwd" and route == "one_pass":
                out[key]["plan_sweep"] = gn_bwd_plan_sweep(
                    x, a["dy"], st, s, bi, relu, plan)
            if key == "conv1x1" and route in OLDER_ROUTE:
                out[key]["plan_sweep"] = conv1x1_tile_sweep(
                    x, a["w"], s, bi, relu, stride, plan)
        fell_back = [(how, [c for c in fns if not dev[c] and
                            timed_by[c] == how])
                     for how in (GRAPH_TIME,
                                 "CUDA events over back-to-back calls")]
        extra += (f"; CUDA graph replays: kernel "
                  f"{graphed['kernel'] * 1e3:.1f} us" + (
                      f", {OLDER_ROUTE.get(route, 'two-pass')} "
                      f"{graphed['previous'] * 1e3:.1f} us"
                      if "previous" in graphed else ""))
        log(f"conv timing {key} {name} (bf16, {DEVICE_TIME}"
            + "".join(f"; {how} for {', '.join(cs)}" for how, cs in fell_back
                      if cs) + "): "
            f"kernel {src['kernel'] * 1e3:.1f} us; plain "
            f"{src['plain'] * 1e3:.1f} us; library {src['library'] * 1e3:.1f}"
            f" us; bound {out[key]['bound_ms'] * 1e3:.1f} us "
            f"({out[key]['bound_by']}){extra}")
    return out


def gn_fwd_plan_sweep(x, s, bi, relu, planned) -> list:
    """B5's one-pass kernel at the other plans :func:`gn_fwd_plan` offers
    for these operands (the fewest CTAs a sample that let four, three, two
    or one share an SM; two, four or eight whole samples a CTA where their
    shared memory fits an SM), outside the launch counters, each held to the
    planned route's result and timed in device time: the data behind
    ``plan_gn_fwd``'s rule."""
    from torchbooster_tpu_torch.ops import group_norm as gnk

    n, h, w, c = x.shape
    want = gnk.launch_fwd(x, s, bi, GROUPS, 1e-5, relu)
    rows = []
    for pack, per_sm in itertools.product((1, 2, 4, 8), (4, 3, 2, 1)):
        plan = gnk.gn_fwd_plan(h * w, c, GROUPS, per_sm, pack)
        if plan is None or any(r["plan"] == plan._asdict() for r in rows):
            continue
        call = lambda: gnk._launch_fwd_one_pass(x, s, bi, GROUPS, 1e-5,  # noqa: E731
                                                relu, plan)
        got = call()
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, want))
        if not err <= CONV_TOL[torch.bfloat16]:
            raise AssertionError(f"gn_fwd at {plan}: {err} from the planned "
                                 f"route")
        ms = device_ms(call, iters=20) or graph_ms(call)
        rows.append({"plan": plan._asdict(), "planned": plan == planned,
                     "ctas_per_sm": gnk.ctas_per_sm_fwd(plan, c, GROUPS),
                     "ms": ms, "max_abs_err_vs_planned": err})
    log(f"gn_fwd plan sweep {tuple(x.shape)}: " + "; ".join(
        f"cluster {r['plan']['cluster']} x {r['plan']['rows']} rows, pack "
        f"{r['plan']['pack']}, {r['ctas_per_sm']} CTAs/SM"
        f"{' (planned)' if r['planned'] else ''}: {r['ms'] * 1e3:.1f} us"
        for r in rows))
    return rows


def gn_bwd_plan_sweep(x, dy, st, s, bi, relu, planned) -> list:
    """B6's one-pass kernel at the other plans :func:`gn_bwd_plan` offers
    for these operands (the fewest CTAs a sample that let three, two or one
    share an SM), outside the launch counters, each held to the planned
    route's result and timed in device time: the data behind
    ``plan_gn_bwd``'s rule."""
    from torchbooster_tpu_torch.ops import group_norm as gnk

    n, h, w, c = x.shape
    want = gnk.launch_bwd(x, dy, st, s, bi, GROUPS, relu)
    rows = []
    for per_sm in (3, 2, 1):
        plan = gnk.gn_bwd_plan(h * w, c, GROUPS, per_sm)
        if plan is None or any(r["plan"] == plan._asdict() for r in rows):
            continue
        call = lambda: gnk._launch_one_pass(x, dy, st, s, bi, GROUPS,  # noqa: E731
                                            relu, plan)
        got = call()
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, want))
        if not err <= CONV_TOL[torch.bfloat16]:
            raise AssertionError(f"gn_bwd at {plan}: {err} from the planned "
                                 f"route")
        ms = device_ms(call, iters=20) or graph_ms(call)
        rows.append({"plan": plan._asdict(), "planned": plan == planned,
                     "ctas_per_sm": gnk.ctas_per_sm_bwd(plan, c, GROUPS),
                     "ms": ms, "max_abs_err_vs_planned": err})
    log(f"gn_bwd plan sweep {tuple(x.shape)}: " + "; ".join(
        f"cluster {r['plan']['cluster']} x {r['plan']['rows']} rows, "
        f"{r['ctas_per_sm']} CTAs/SM"
        f"{' (planned)' if r['planned'] else ''}: {r['ms'] * 1e3:.1f} us"
        for r in rows))
    return rows


def conv1x1_tile_sweep(x, w, s, bi, relu, stride, planned) -> list:
    """B7's one-pass kernel at each Cout tile its instances build (64, 128)
    that the group width divides, on the planned route and outside the
    launch counters, held to the planned tile's result and timed in device
    time."""
    from torchbooster_tpu_torch.ops import fused_block as fb

    want = fb.launch_1x1(x, w, s, bi, GROUPS, 1e-5, relu, stride)
    rows = []
    for bn in (64, 128):
        plan = planned._replace(bn=bn)
        if bn % (w.shape[3] // GROUPS):
            continue
        call = lambda: fb._launch_sm90(x, w, s, bi, GROUPS, 1e-5, relu,  # noqa: E731
                                       stride, plan)
        got = call()
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, want))
        if not err <= CONV_TOL[torch.bfloat16]:
            raise AssertionError(f"conv1x1 at {plan}: {err} from the planned "
                                 f"tile")
        ms = device_ms(call, iters=20) or graph_ms(call)
        rows.append({"plan": plan._asdict(), "planned": plan == planned,
                     "ctas_per_sm": fb.ctas_per_sm_1x1(plan), "ms": ms,
                     "max_abs_err_vs_planned": err})
    log(f"conv1x1 tile sweep {tuple(x.shape)} -> {w.shape[3]}: " + "; ".join(
        f"BN {r['plan']['bn']}, {r['ctas_per_sm']} CTAs/SM"
        f"{' (planned)' if r['planned'] else ''}: {r['ms'] * 1e3:.1f} us"
        for r in rows))
    return rows


def repeat_check(gen) -> dict:
    """Two bf16 calls on the same inputs must agree bit for bit (fixed-order
    sums, no atomics, across a cluster's CTAs too): B8's out, mu and rstd;
    B7's on its one-pass routes; B6's dx and part and B5's y and stats on
    ``"one_pass"``."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    cases = {c[0]: c for c in CONV_MAIN + CONV_EXTRA}
    out = {}
    for name, fwd in [(n, False) for n in CONV_REPEAT] + [
            (n, True) for n in GN_FWD_REPEAT]:
        case = cases[name]
        _, kind, b, h, w, cin, cout, stride = case
        a = conv_inputs(gen, kind, b, h, w, cin, cout, torch.bfloat16)
        g = groups_for(cout)
        if fwd:
            call = lambda: gnk.launch_fwd(a["x"], a["scale"], a["bias"],  # noqa: E731
                                          g, 1e-5, True)
            what = "gn_fwd"
        elif kind == "gn":
            _, st = gnk.group_norm_fwd_reference(a["x"], a["scale"],
                                                 a["bias"], g, 1e-5, True)
            call = lambda: gnk.launch_bwd(a["x"], a["dy"], st, a["scale"],  # noqa: E731
                                          a["bias"], g, True)
            what = "gn_bwd"
        elif kind == "1x1":
            call = lambda: fb.launch_1x1(a["x"], a["w"], a["scale"],  # noqa: E731
                                         a["bias"], g, 1e-5, False, stride)
            what = "conv1x1"
        else:
            call = lambda: fb.launch_3x3(a["x"], a["w"], a["scale"],  # noqa: E731
                                         a["bias"], g)
            what = "conv3x3"
        first, second = call(), call()
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(first, second))
        route = planned_route(case, torch.bfloat16, what)
        out[f"{what} {name}"] = {"kernel": what, "route": route,
                                 "bit_identical": same}
        if not same:
            raise AssertionError(f"{what} {name} ({route}): two calls on the "
                                 f"same inputs differ")
    log("conv repeat, bit for bit: " + ", ".join(
        f"{n} ({r['route']}) ok" for n, r in out.items()))
    return out


def phase_conv(report: dict) -> dict:
    """B5-B8 against their plain versions in every case and dtype, with
    and without ReLU; then timed at the ResNet-18 training shapes.
    Returns the four kernels' ``kernels``-line fields."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    worst = {"gn_fwd": 0.0, "gn_bwd": 0.0, "conv1x1": 0.0, "conv3x3": 0.0}
    which = {"y": "gn_fwd", "stats": "gn_fwd", "dx": "gn_bwd",
             "part": "gn_bwd"}
    per_case = {}
    for case in CONV_MAIN + CONV_EXTRA:
        name, kind = case[0], case[1]
        for dtype in (torch.bfloat16, torch.float32):
            for relu in (True, False):
                errs, used = check_conv_case(gen, case, dtype, relu)
                for key, err in errs.items():
                    if "@" in key:   # the older route, held but not reported
                        continue
                    kk = which.get(key, "conv1x1" if kind == "1x1"
                                   else "conv3x3")
                    worst[kk] = max(worst[kk], err)
                tag = f"{name}_{str(dtype)[6:]}_{'relu' if relu else 'norelu'}"
                route = planned_route(case, dtype)
                if kind == "gn":   # B5's route, then B6's
                    route = f"{planned_route(case, dtype, 'gn_fwd')}/{route}"
                per_case[tag] = {"route": route,
                                 "max_abs_err": errs, "allowance_used": used,
                                 "atol": CONV_TOL[dtype],
                                 "rtol": CONV_TOL[dtype]}
                log(f"conv {tag} ({route}): "
                    + ", ".join(f"{k} {errs[k]:.2e} ({100 * used[k]:.0f}%)"
                                for k in errs)
                    + f" (atol = rtol = {CONV_TOL[dtype]})")
        torch.cuda.empty_cache()
    report["conv_cases"] = per_case
    report["conv_repeat"] = repeat_check(gen)
    timing = {}
    for case in CONV_MAIN:
        timing[case[0]] = time_conv_case(gen, case)
        torch.cuda.empty_cache()
    # per training step: every main-path call of each kernel (forward
    # counts; B6 runs once per B5)
    per_step = {}
    for key in worst:
        fields = ("ms", "plain_ms", "library_ms", "bound_ms", "previous_ms")
        per_step[key] = {
            f: sum(CONV_PER_STEP[n] * t[key][f] for n, t in timing.items()
                   if key in t)
            for f in fields}
        log(f"conv per training step {key}: kernel "
            f"{per_step[key]['ms']:.4f} ms, plain "
            f"{per_step[key]['plain_ms']:.4f} ms, library "
            f"{per_step[key]['library_ms']:.4f} ms, bound "
            f"{per_step[key]['bound_ms']:.4f} ms, older route "
            f"{per_step[key]['previous_ms']:.4f} ms")
    report["conv_timing"] = timing
    report["conv_per_step"] = per_step
    res = {key: {**{k: timing[CONV_TIMED[key]][key][k] for k in (
        "ms", "sum_ms", "timed_by", "plain_ms", "library_ms", "bound_ms",
        "bound_by")},
        "max_abs_err": worst[key]} for key in worst}
    for key in ("conv1x1", "conv3x3", "gn_fwd", "gn_bwd"):
        t = timing[CONV_TIMED[key]][key]
        res[key].update(timed_route=t["route"], previous_ms=t["previous_ms"])
    return res


# ---------------------------------------------------------- resnet_train
RESNET_EPOCHS = 2


def resnet_train_config(epochs: int, precision: str = "bf16"):
    """``examples/img_cls/resnet/resnet.yml``'s values built in code (the
    card's machine reads no YAML), with ``epochs`` epochs."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.resnet import Config

    return Config(
        epochs=epochs, seed=42, depth=18, num_classes=10, clip=1.0,
        label_smoothing=0.1, pretrained="", freeze_backbone=False,
        env=EnvConfig(distributed=False, precision=precision, n_devices=0,
                      mesh="dp"),
        loader=LoaderConfig(batch_size=RN_B, num_workers=0, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=1e-3, weight_decay=1e-2),
        scheduler=SchedulerConfig(name="cycle", n_iter=160, warmup=16,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="cifar10", root="dataset/cifar10"))


def resnet_forward_flops(params: dict, size: int = 32) -> float:
    """Forward flops per image of a basic-block ResNet with the CIFAR
    stem: 2 per multiply-add of every conv and the head."""
    flops = 2 * size * size * params["stem"]["conv"]["kernel"].numel()
    hw = size
    for si in range(4):
        stage = params[f"stage{si}"]
        for bi in range(len(stage)):
            block = stage[f"block{bi}"]
            hw = hw // 2 if (bi == 0 and si > 0) else hw
            flops += 2 * hw * hw * sum(block[k]["kernel"].numel() for k in
                                       ("conv1", "conv2", "proj")
                                       if k in block)
    return float(flops + 2 * params["head"]["kernel"].numel())


def resnet_fp32_check() -> dict:
    """One fp32 forward + backward of the recipe's loss from the same
    parameters and batch, through B5-B8 (``fused="auto"``) and through
    ``fused=False`` with the plain GroupNorm: loss and gradient norm must
    agree."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk
    from torchbooster_tpu_torch.recipes import resnet as recipe
    from torchbooster_tpu_torch.utils import tree_leaves

    t = recipe.setup(resnet_train_config(1, "fp32"))
    batch = recipe.to_device(next(iter(t.train_loader)), t.device)
    out = {}
    for route, kw in (("kernels", dict(fused="auto", gn_impl="auto")),
                      ("plain", dict(fused=False, gn_impl="plain"))):
        before = (gnk.launches_fwd, fb.launches_3x3)
        loss, _ = recipe.make_loss_fn(t.conf, train=True, **kw)(
            t.state.params, batch, None)
        loss.backward()
        leaves = tree_leaves(t.state.params)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in leaves])).item()
        out[route] = {"loss": loss.item(), "grad_norm": norm,
                      "launched": (gnk.launches_fwd, fb.launches_3x3)
                      != before}
        for p in leaves:
            p.grad = None
    if not out["kernels"]["launched"] or out["plain"]["launched"]:
        raise AssertionError(f"fp32 check took the wrong routes: {out}")
    # fp32 on both sides (TF32 off); they differ in the order of the conv
    # and moment sums only
    tol = 1e-4
    for key in ("loss", "grad_norm"):
        a, b = out["kernels"][key], out["plain"][key]
        if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
            raise AssertionError(f"resnet fp32: kernels {key} {a} vs plain "
                                 f"{b} (rtol {tol})")
    out["rtol"] = tol
    log(f"resnet_train fp32 kernels vs plain: loss {out['kernels']['loss']:.6f}"
        f" / {out['plain']['loss']:.6f}, grad norm "
        f"{out['kernels']['grad_norm']:.6f} / {out['plain']['grad_norm']:.6f}"
        f" (rtol {tol})")
    return out


def resnet_breakdown(n_steps: int = 3) -> dict:
    """A fresh bf16 trainer: two warm steps, then ``n_steps`` steps as the
    recipe runs them (host fetch and augmentation included) under the
    profiler (CUDA activity): device busy share of the wall time, the
    device's own time per step, kernels per step, the share of B5-B8,
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.recipes import resnet as recipe

    t = recipe.setup(resnet_train_config(1))
    batches = iter(t.train_loader)
    for _ in range(2):
        t.state, m = t.step(t.state, recipe.to_device(next(batches),
                                                      t.device))
    m["loss"].item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            t.state, m = t.step(t.state, recipe.to_device(next(batches),
                                                          t.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    ours = sum(v for k, v in per_kernel if any(
        n in k for n in ("gn_fwd", "gn_bwd", "conv_mma", "conv_f32",
                         "group_moments", "conv_gn_sm90")))
    return {"steps": n_steps, "wall_s": wall, "step_ms": wall / n_steps * 1e3,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3,
            "b5_b8_s": ours, "b5_b8_share_of_device": ours / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:10]}


def reset_conv_counts() -> None:
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    gnk.launches_fwd = gnk.launches_bwd = 0
    fb.launches_1x1 = fb.launches_3x3 = 0
    for counter in (gnk.launches_fwd_by_route, gnk.launches_bwd_by_route,
                    fb.launches_1x1_by_route, fb.launches_3x3_by_route):
        for route in counter:
            counter[route] = 0


def conv_counts() -> tuple[dict, dict]:
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    return ({"gn_fwd": gnk.launches_fwd, "gn_bwd": gnk.launches_bwd,
             "conv1x1": fb.launches_1x1, "conv3x3": fb.launches_3x3},
            {"gn_fwd": dict(gnk.launches_fwd_by_route),
             "gn_bwd": dict(gnk.launches_bwd_by_route),
             "conv1x1": dict(fb.launches_1x1_by_route),
             "conv3x3": dict(fb.launches_3x3_by_route)})


def phase_resnet_train(report: dict, smi: str) -> dict:
    """The ResNet recipe's entry point (``launch_main``) at the YAML's
    configuration on the card; returns B5-B8's launch counts from this
    run."""
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.recipes import resnet as recipe

    conf = resnet_train_config(RESNET_EPOCHS)
    n_eval = RESNET_EPOCHS * (len(conf.dataset.make(Split.TEST)) // RN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_conv_counts()
    t0 = time.perf_counter()
    res = recipe.launch_main(conf, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_route = conv_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in res["steps"]]
    n_steps = len(losses)
    if n_steps != 32 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"resnet_train: {n_steps} steps, losses "
                             f"{losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"resnet_train: the loss did not fall: {losses}")
    fwd = n_steps + n_eval
    expected = {"gn_fwd": 4 * fwd, "gn_bwd": 4 * n_steps,
                "conv1x1": 3 * fwd, "conv3x3": 13 * fwd}
    if launches != expected:
        raise AssertionError(f"resnet_train: launches {launches}, expected "
                             f"{expected} ({n_steps} steps, {n_eval} eval "
                             f"batches)")
    # B8: stages 0-1 (4 + 3 calls a forward) on clusters, 2-3 (3 + 3)
    # packed; B7: the 16² projection on a cluster, the 8² and 4² packed;
    # B5 and B6: every norm's forward and backward in one pass
    route_expected = {
        "gn_fwd": {"one_pass": 4 * fwd, "two_pass": 0},
        "gn_bwd": {"one_pass": 4 * n_steps, "two_pass": 0},
        "conv1x1": {"cluster": fwd, "pack": 2 * fwd, "mma_sync": 0, "f32": 0},
        "conv3x3": {"cluster": 7 * fwd, "pack": 6 * fwd, "mma_sync": 0,
                    "f32": 0}}
    if by_route != route_expected:
        raise AssertionError(f"resnet_train: routes {by_route}, expected "
                             f"{route_expected}")
    # steady state: the second epoch's training loop (its 16 steps, host
    # fetch and augmentation included, ended by reading its metrics)
    last = res["log"][-1]
    step_s = last["train_s"] / last["train_steps"]
    data_s = float(np.mean([st["data_s"] for st in res["steps"]
                            if st["epoch"] == last["epoch"]]))
    params = recipe.ResNet.init(0, 18, 10, "cifar", device="cpu")
    flops = 3.0 * resnet_forward_flops(params) * RN_B
    out = {"losses": losses, "launches": launches, "expected": expected,
           "by_route": by_route, "eval_batches": n_eval, "main_wall_s": wall,
           "step_ms": step_s * 1e3, "img_per_s": RN_B / step_s,
           "host_data_ms_per_step": data_s * 1e3,
           "model_flops_per_step": flops,
           "mfu_of_989_tflops": flops / step_s / BF16_FLOPS,
           "peak_mem_bytes": peak, "test_acc": res.get("test_acc"),
           "card": smi}
    log(f"resnet_train: ResNet-18 CIFAR, batch {RN_B}, {n_steps} steps, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, test acc "
        f"{res.get('test_acc')}; step {out['step_ms']:.1f} ms, "
        f"{out['img_per_s']:.0f} img/s, host data {data_s * 1e3:.1f} ms per "
        f"step, model FLOP share {100 * out['mfu_of_989_tflops']:.2f}% of "
        f"989 TFLOP/s, peak mem {peak / 2**30:.2f} GiB; launches {launches}, "
        f"B5 by route {by_route['gn_fwd']}, "
        f"B6 by route {by_route['gn_bwd']}, B7 by route "
        f"{by_route['conv1x1']}, B8 by route {by_route['conv3x3']} [{smi}]")
    out["fp32_kernels_vs_plain"] = resnet_fp32_check()
    torch.cuda.empty_cache()
    b = out["breakdown"] = resnet_breakdown()
    log(f"resnet_train profiled: {b['steps']} steps, wall {b['wall_s']:.3f} s "
        f"({b['step_ms']:.1f} ms/step), device {b['device_ms_per_step']:.1f} "
        f"ms/step, busy {100 * b['device_busy_share']:.1f}%, "
        f"{b['kernels_per_step']:.0f} kernels per step, B5-B8 "
        f"{100 * b['b5_b8_share_of_device']:.1f}% of device time; top: "
        + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in b["top"][:6]))
    report["resnet_train"] = out
    return {**launches, "by_route": by_route}


# ----------------------------------------------------------- resnet_data
# steps a loader mode: warm-up, then timed (4 and 24 until the generative
# phases joined the smoke and its time limit called for cuts)
RD_WARM, RD_TIMED = 2, 8
RD_SAMPLE, RD_GATHER = 4096, 512   # records read back, records a gather
RD_COPY_BATCHES = 8            # batches held byte for byte, prefetch vs host
RD_TRAIN, RD_TEST, RD_PER_FILE = 50_000, 10_000, 10_000   # CIFAR-10's sizes
# what each B5-B8 launches a train step at batch 512, bf16, and by route
RD_PER_STEP = {"gn_fwd": 4, "gn_bwd": 4, "conv1x1": 3, "conv3x3": 13}
RD_ROUTES = {"gn_fwd": {"one_pass": 4, "two_pass": 0},
             "gn_bwd": {"one_pass": 4, "two_pass": 0},
             "conv1x1": {"cluster": 1, "pack": 2, "mma_sync": 0, "f32": 0},
             "conv3x3": {"cluster": 7, "pack": 6, "mma_sync": 0, "f32": 0}}


def write_cifar10_release(root: Path) -> dict:
    """A CIFAR-10 binary release at full size under ``root``: five
    ``data_batch_*.bin`` of 10,000 records and a ``test_batch.bin`` of
    10,000, each record a label byte and the CHW planes. The images are
    the ``synthetic_cifar10`` twin's class-conditional images (50,000
    train, 10,000 test), quantized to uint8, so the loss can fall."""
    from torchbooster_tpu_torch.data import sources
    from torchbooster_tpu_torch.dataset import Split

    t0 = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    for split, n, names in (
            (Split.TRAIN, RD_TRAIN,
             [f"data_batch_{i}.bin" for i in range(1, 6)]),
            (Split.TEST, RD_TEST, ["test_batch.bin"])):
        twin = sources._synthetic_classification(n, (32, 32, 3), 10, split)
        images, labels = twin.arrays
        pixels = np.clip(np.rint(images * 32.0 + 128.0), 0, 255).astype(
            np.uint8)
        records = np.concatenate(
            [labels.astype(np.uint8)[:, None],
             pixels.transpose(0, 3, 1, 2).reshape(n, 3072)], axis=1)
        for i, name in enumerate(names):
            (root / name).write_bytes(
                records[i * RD_PER_FILE:(i + 1) * RD_PER_FILE].tobytes())
        out[split.value] = (pixels, labels)
    out["bytes"] = sum(f.stat().st_size for f in root.iterdir())
    out["seconds"] = time.perf_counter() - t0
    return out


def store_read_check(path: Path) -> dict:
    """``RD_SAMPLE`` records drawn from a seed, read through the Python
    and the native reader, each alone and in gathers of ``RD_GATHER``: the
    bytes must agree; MB/s of each (the store was just written, so reads
    come from the page cache)."""
    from torchbooster_tpu_torch.store import RecordReader

    rs = np.random.RandomState(7)
    with RecordReader(path) as probe:
        n = len(probe)
    idx = [int(i) for i in rs.randint(0, n, RD_SAMPLE)]
    out, got = {}, {}
    for native in (False, True):
        name = "native" if native else "python"
        with RecordReader(path, native=native) as reader:
            if reader._native is not native:
                raise AssertionError(f"store: the {name} reader read "
                                     f"through the other path")
            t0 = time.perf_counter()
            alone = [reader.get(i) for i in idx]
            t1 = time.perf_counter()
            gathered = [r for s in range(0, RD_SAMPLE, RD_GATHER)
                        for r in reader.get_batch(idx[s:s + RD_GATHER])]
            t2 = time.perf_counter()
        if alone != gathered:
            raise AssertionError(f"store: the {name} reader's get and "
                                 f"get_batch disagree")
        got[name] = alone
        mb = sum(map(len, alone)) / 1e6
        out[name] = {"get_mb_per_s": mb / (t1 - t0),
                     "get_batch_mb_per_s": mb / (t2 - t1)}
    if got["python"] != got["native"]:
        bad = sum(a != b for a, b in zip(got["python"], got["native"]))
        raise AssertionError(f"store: the native and Python readers "
                             f"disagree on {bad} of {RD_SAMPLE} records")
    out["records"], out["mb"] = RD_SAMPLE, sum(map(len, got["native"])) / 1e6
    return out


def resnet_data_config(root: str, num_workers: int):
    from torchbooster_tpu_torch.config import DatasetConfig, LoaderConfig

    conf = resnet_train_config(1)
    conf.dataset = DatasetConfig(name="cifar10", root=root)
    conf.loader = LoaderConfig(batch_size=RN_B, num_workers=num_workers,
                               drop_last=True)
    return conf


def resnet_data_mode(conf, mode: str, n_workers: int, smi: str) -> dict:
    """``RD_WARM + RD_TIMED`` train steps of the recipe's trainer with the
    loader of ``mode``: ``serial`` (``num_workers: 0``), ``thread``,
    ``process``, or ``prefetch_<thread|process>`` (that loader under
    ``prefetch_to_device(size=2)``). The timed steps run under the
    profiler (CUDA activity) for the busy share. Every loss must be finite
    and B5-B8's launches exact per step, by route."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.data import DataLoader, prefetch_to_device
    from torchbooster_tpu_torch.recipes import resnet as recipe

    t = recipe.setup(conf)
    workers = mode.replace("prefetch_", "")
    if workers == "process":
        loader = DataLoader(t.train_loader.dataset, batch_size=RN_B,
                            shuffle=True, seed=conf.seed,
                            num_workers=n_workers, workers="process",
                            prefetch=conf.loader.prefetch)
    else:
        loader = t.train_loader
    if loader.num_workers != (0 if mode == "serial" else n_workers):
        raise AssertionError(f"resnet_data {mode}: the loader runs "
                             f"{loader.num_workers} workers")
    batches = prefetch_to_device(loader, t.device, size=2) \
        if mode.startswith("prefetch") else iter(loader)
    n_steps = RD_WARM + RD_TIMED
    losses, data_s, labels = [], [], []
    torch.cuda.synchronize()
    reset_conv_counts()
    prof = profile(activities=[ProfilerActivity.CUDA])
    for i in range(n_steps):
        if i == RD_WARM:
            torch.cuda.synchronize()
            prof.start()
            t0 = time.perf_counter()
        t_fetch = time.perf_counter()
        batch = next(batches)
        images, y = recipe.to_device(batch, t.device)
        data_s.append(time.perf_counter() - t_fetch)
        if mode.startswith("prefetch") and not (
                images.device.type == y.device.type == t.device.type):
            raise AssertionError("resnet_data: prefetch_to_device yielded "
                                 "tensors off the trainer's device")
        labels.append(y)
        t.state, m = t.step(t.state, (images, y))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    launches, by_route = conv_counts()
    batches.close()
    if workers == "process":
        loader.close()
    losses = torch.stack(losses).tolist()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"resnet_data {mode}: losses {losses}")
    expected = {k: v * n_steps for k, v in RD_PER_STEP.items()}
    route_expected = {k: {r: v * n_steps for r, v in routes.items()}
                      for k, routes in RD_ROUTES.items()}
    if launches != expected or by_route != route_expected:
        raise AssertionError(
            f"resnet_data {mode}: launches {launches} by route {by_route}, "
            f"expected {expected} by route {route_expected}")
    busy_us = union_us(device_spans(prof))
    step_s = wall / RD_TIMED
    out = {"mode": mode, "workers": 0 if mode == "serial" else n_workers,
           "steps": n_steps, "timed_steps": RD_TIMED,
           "step_ms": step_s * 1e3, "img_per_s": RN_B / step_s,
           "host_data_ms_per_step": float(np.mean(data_s[RD_WARM:])) * 1e3,
           "first_batch_s": data_s[0],
           "device_busy_share": busy_us / 1e6 / wall,
           "device_ms_per_step": busy_us / 1e3 / RD_TIMED,
           "losses": losses, "launches": launches, "by_route": by_route,
           "labels": torch.cat(labels).cpu().long().numpy(), "card": smi}
    log(f"resnet_data {mode}: {out['workers']} workers, step "
        f"{out['step_ms']:.1f} ms, {out['img_per_s']:.0f} img/s, host data "
        f"{out['host_data_ms_per_step']:.1f} ms per step, device "
        f"{out['device_ms_per_step']:.1f} ms per step, busy "
        f"{100 * out['device_busy_share']:.1f}%, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, first batch {data_s[0]:.2f} s [{smi}]")
    del t
    torch.cuda.empty_cache()
    return out


def prefetch_copy_check(conf, workers: str, n_workers: int) -> dict:
    """``RD_COPY_BATCHES`` batches of the train split without
    augmentation: what ``prefetch_to_device`` delivers on the card from
    the ``workers`` loader equals, byte for byte, the ``num_workers: 0``
    host batches of the same seed and epoch (images and labels)."""
    from torchbooster_tpu_torch.data import DataLoader, prefetch_to_device
    from torchbooster_tpu_torch.dataset import Split

    ds = conf.dataset.make(Split.TRAIN)
    host = DataLoader(ds, batch_size=RN_B, shuffle=True, seed=conf.seed)
    fast = DataLoader(ds, batch_size=RN_B, shuffle=True, seed=conf.seed,
                      num_workers=n_workers, workers=workers)
    on_card = prefetch_to_device(fast, DEV, size=2)
    try:
        for k, (want, got) in enumerate(zip(host, on_card)):
            for name, w, g in zip(("images", "labels"), want, got):
                if g.device.type != torch.device(DEV).type:
                    raise AssertionError("prefetch_to_device yielded a "
                                         "tensor off the card")
                g = g.cpu().numpy()
                if g.dtype != w.dtype or g.shape != w.shape or \
                        g.tobytes() != w.tobytes():
                    raise AssertionError(f"prefetch copy check: batch {k} "
                                         f"{name} differ from the host "
                                         f"batch")
            if k + 1 == RD_COPY_BATCHES:
                break
    finally:
        on_card.close()
        fast.close()
    return {"batches": RD_COPY_BATCHES, "workers": workers,
            "n_workers": n_workers, "bytes_equal": True}


def phase_resnet_data(report: dict, smi: str) -> dict:
    """The data path under ResNet-18: a full-size CIFAR-10 binary release
    written from a seed, its record store, and the recipe's trainer on
    that store under four loader modes; returns B5-B8's launch counts
    from the four runs."""
    import tempfile

    from torchbooster_tpu_torch.config import DatasetConfig
    from torchbooster_tpu_torch.dataset import BaseDataset, Split

    n_workers = min(8, os.cpu_count() or 1)
    out: dict = {"cpu_count": os.cpu_count(), "n_workers": n_workers,
                 "card": smi}
    log(f"resnet_data: os.cpu_count() {os.cpu_count()}, {n_workers} "
        f"loader workers")
    with tempfile.TemporaryDirectory() as tmp:
        release, store_root = Path(tmp) / "cifar10", Path(tmp) / "store"
        rel = write_cifar10_release(release)
        for split in (Split.TRAIN, Split.TEST):
            ds = DatasetConfig(name="cifar10", root=str(release)).make(split)
            if ds.resolution != "local:cifar10_bin":
                raise AssertionError(f"resnet_data: the release resolved "
                                     f"{ds.resolution}")
            pixels, labels = rel[split.value]
            images, got = ds.arrays
            if len(ds) != len(labels) or \
                    not np.array_equal(got, labels.astype(np.int32)) or \
                    not np.array_equal(np.rint(images[:64] * 255.0),
                                       pixels[:64].astype(np.float32)):
                raise AssertionError("resnet_data: the CIFAR-10 reader "
                                     "disagrees with the written release")
            t0 = time.perf_counter()
            path = BaseDataset.prepare(store_root, split,
                                       (ds[i] for i in range(len(ds))))
            secs = time.perf_counter() - t0
            out[f"store_{split.value}"] = {
                "records": len(ds), "bytes": path.stat().st_size,
                "write_s": secs,
                "write_mb_per_s": path.stat().st_size / 1e6 / secs}
        out["release_bytes"], out["release_write_s"] = rel["bytes"], \
            rel["seconds"]
        del rel
        for split in (Split.TRAIN, Split.TEST):
            res = DatasetConfig(name="cifar10", root=str(store_root)).make(
                split).resolution
            if res != "store":
                raise AssertionError(f"resnet_data: the store root "
                                     f"resolved {res}")
        rd = out["store_read"] = store_read_check(store_root / "train.bstore")
        w = out["store_train"]
        log(f"resnet_data store: release {out['release_bytes'] / 1e6:.1f} MB "
            f"written in {out['release_write_s']:.2f} s; train.bstore "
            f"{w['bytes'] / 1e6:.1f} MB of {w['records']} records at "
            f"{w['write_mb_per_s']:.1f} MB/s (prepare: read, pickle, write); "
            f"{RD_SAMPLE} records read back equal through both readers: "
            f"python get {rd['python']['get_mb_per_s']:.1f} / get_batch "
            f"{rd['python']['get_batch_mb_per_s']:.1f} MB/s, native get "
            f"{rd['native']['get_mb_per_s']:.1f} / get_batch "
            f"{rd['native']['get_batch_mb_per_s']:.1f} MB/s [{smi}]")

        modes = {}
        total = dict.fromkeys(RD_PER_STEP, 0)
        by_route = {k: dict.fromkeys(v, 0) for k, v in RD_ROUTES.items()}

        def run(mode: str) -> None:
            workers = 0 if mode == "serial" else n_workers
            m = modes[mode] = resnet_data_mode(
                resnet_data_config(str(store_root), workers), mode,
                n_workers, smi)
            for k in total:
                total[k] += m["launches"][k]
                for r, n in m["by_route"][k].items():
                    by_route[k][r] += n

        for mode in ("serial", "thread", "process"):
            run(mode)
        best = min(("thread", "process"), key=lambda k: modes[k]["step_ms"])
        run(f"prefetch_{best}")
        # augmentation keys each worker's generator on its thread and
        # process, so pixels differ by design; the labels' order may not
        want = modes["serial"]["labels"]
        for mode, m in modes.items():
            if not np.array_equal(m.pop("labels"), want):
                raise AssertionError(f"resnet_data {mode}: the label order "
                                     f"differs from num_workers: 0's")
        out["modes"] = modes
        out["copy_check"] = prefetch_copy_check(
            resnet_data_config(str(store_root), n_workers), best, n_workers)
        log(f"resnet_data prefetch copy check: {RD_COPY_BATCHES} batches "
            f"of prefetch_to_device over {n_workers} {best} workers equal "
            f"the num_workers: 0 host batches byte for byte (images, "
            f"labels)")
    report["resnet_data"] = out
    return {**total, "by_route": by_route}


# ----------------------------------------------------------------- lenet
LENET_B = 512          # lenet.yml's batch
LENET_TRAIN, LENET_TEST = 60_000, 10_000     # MNIST's sizes
LENET_PROFILED = 5     # steps profiled for the busy share
# kernels vs plain on one batch: fp32 (both norms on "two_pass"), and bf16
# (C 6 on "two_pass", C 16 on "one_pass"); gradients held against the
# largest gradient entry of the model (the conv biases' exact gradient is
# 0: a GroupNorm of one channel a group takes any per-channel constant out)
LENET_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def write_idx(path: Path, array: np.ndarray) -> None:
    """One uncompressed IDX file of unsigned bytes: magic ``0 0 8 ndim``,
    the dims as big-endian int32, the data."""
    header = bytes([0, 0, 0x08, array.ndim]) + np.asarray(
        array.shape, ">i4").tobytes()
    path.write_bytes(header + np.ascontiguousarray(array, np.uint8)
                     .tobytes())


def write_mnist_release(root: Path) -> dict:
    """MNIST's IDX release at full size under ``root``
    (``train-images-idx3-ubyte`` and the rest): 60,000 train and 10,000
    test images of the ``synthetic_mnist`` twin's class-conditional
    images, quantized to uint8, so the loss can fall."""
    from torchbooster_tpu_torch.data import sources
    from torchbooster_tpu_torch.dataset import Split

    t0 = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    for split, n, prefix in ((Split.TRAIN, LENET_TRAIN, "train"),
                             (Split.TEST, LENET_TEST, "t10k")):
        twin = sources._synthetic_classification(n, (28, 28, 1), 10, split)
        images, labels = twin.arrays
        pixels = np.clip(np.rint(images[..., 0] * 32.0 + 128.0), 0,
                         255).astype(np.uint8)
        write_idx(root / f"{prefix}-images-idx3-ubyte", pixels)
        write_idx(root / f"{prefix}-labels-idx1-ubyte",
                  labels.astype(np.uint8))
        out[split.value] = (pixels, labels)
    out["bytes"] = sum(f.stat().st_size for f in root.iterdir())
    out["seconds"] = time.perf_counter() - t0
    return out


def lenet_config(root: Path, precision: str = "bf16"):
    """``examples/img_cls/lenet/lenet.yml``'s values built in code (the
    card's machine reads no YAML), one epoch, over the release at
    ``root``."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.lenet import Config

    return Config(
        epochs=1, seed=42,
        env=EnvConfig(distributed=False, precision=precision, n_devices=0,
                      mesh="dp"),
        loader=LoaderConfig(batch_size=LENET_B, num_workers=0,
                            drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=2e-3, weight_decay=1e-4),
        scheduler=SchedulerConfig(name="cycle", n_iter=0, warmup=10,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="mnist", root=str(root)))


def lenet_kernels_vs_plain(root: Path) -> dict:
    """One batch of the release, the recipe's loss forward and backward
    from the same parameters through B5/B6 (``gn_impl="auto"``) and
    through the plain GroupNorm, at fp32 and at bf16: the loss and every
    parameter gradient must agree (``LENET_TOL``), and each dtype's
    kernel run must take its routes (fp32: two ``"two_pass"`` calls each
    way; bf16: one ``"two_pass"`` and one ``"one_pass"``)."""
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.models import LeNet
    from torchbooster_tpu_torch.recipes import lenet as recipe
    from torchbooster_tpu_torch.recipes.resnet import to_device
    from torchbooster_tpu_torch.utils import _cast_batch, tree_leaves

    conf = lenet_config(root)
    loader = conf.loader.make(conf.dataset.make(Split.TRAIN), shuffle=False)
    batch = to_device(next(iter(loader)), torch.device(DEV))
    params = LeNet.init(0, device=DEV)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    want_routes = {torch.float32: ({"one_pass": 0, "two_pass": 2},) * 2,
                   torch.bfloat16: ({"one_pass": 1, "two_pass": 1},) * 2}
    out = {}
    for dtype, tol in LENET_TOL.items():
        runs = {}
        for impl in ("auto", "plain"):
            before = conv_counts()[1]
            loss, _ = recipe.make_loss_fn(True, gn_impl=impl)(
                _cast_batch(params, dtype), _cast_batch(batch, dtype), None)
            loss.backward()
            after = conv_counts()[1]
            moved = tuple({r: after[k][r] - before[k][r] for r in after[k]}
                          for k in ("gn_fwd", "gn_bwd"))
            runs[impl] = (loss.item(), [p.grad.clone() for p in leaves],
                          moved)
            for p in leaves:
                p.grad = None
        name = str(dtype).split(".")[-1]
        if runs["auto"][2] != want_routes[dtype] or any(
                sum(m.values()) for m in runs["plain"][2]):
            raise AssertionError(f"lenet {name}: routes {runs['auto'][2]} "
                                 f"(plain {runs['plain'][2]}), expected "
                                 f"{want_routes[dtype]}")
        (la, ga, _), (lp, gp, _) = runs["auto"], runs["plain"]
        top = max(g.abs().max().item() for g in gp)
        worst = max((a - b).abs().max().item() for a, b in zip(ga, gp)) / top
        if not (math.isfinite(la) and abs(la - lp) <= tol * abs(lp)
                and worst <= tol):
            raise AssertionError(f"lenet {name}: kernels loss {la} vs plain "
                                 f"{lp}, worst gradient error {worst:.3g} of "
                                 f"the largest entry (tolerance {tol})")
        out[name] = {"loss": la, "plain_loss": lp,
                     "worst_grad_err_of_max": worst, "tol": tol,
                     "routes": runs["auto"][2]}
        log(f"lenet {name} kernels vs plain: loss {la:.6f} / {lp:.6f}, "
            f"worst gradient error {worst:.3g} of the largest entry (tol "
            f"{tol}); B5 routes {runs['auto'][2][0]}, B6 "
            f"{runs['auto'][2][1]}")
    return out


def lenet_breakdown(root: Path, n_steps: int = LENET_PROFILED) -> dict:
    """A fresh bf16 trainer over the release: two warm steps, then
    ``n_steps`` steps as the recipe runs them under the profiler (CUDA
    activity): the device busy share of the wall, device ms per step,
    kernels per step, B5/B6's share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.recipes import lenet as recipe
    from torchbooster_tpu_torch.recipes.resnet import to_device

    t = recipe.setup(lenet_config(root), DEV)
    batches = iter(t.train_loader)
    for _ in range(2):
        t.state, m = t.step(t.state, to_device(next(batches), t.device))
    m["loss"].item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            t.state, m = t.step(t.state, to_device(next(batches), t.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    ours = sum(v for k, v in per_kernel if "gn_fwd" in k or "gn_bwd" in k)
    return {"steps": n_steps, "wall_s": wall,
            "step_ms": wall / n_steps * 1e3,
            "img_per_s": LENET_B * n_steps / wall,
            "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3,
            "b5_b6_share_of_device": ours / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:8]}


def phase_lenet(report: dict, smi: str) -> dict:
    """The lenet recipe's ``launch_main`` at ``lenet.yml``'s values over a
    full-size MNIST IDX release written from a seed: one epoch, the loss
    falling, B5 and B6 launched on both routes by exact counts; then the
    kernels held to the plain GroupNorm on one batch and a profiled
    window. Returns B5-B8's launch counts from the ``launch_main`` run."""
    import tempfile

    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.recipes import lenet as recipe

    out: dict = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mnist"
        rel = write_mnist_release(root)
        conf = lenet_config(root)
        for split in (Split.TRAIN, Split.TEST):
            ds = conf.dataset.make(split)
            pixels, labels = rel[split.value]
            images, got = ds.arrays
            if ds.resolution != "local:mnist_idx" or len(ds) != len(labels) \
                    or not np.array_equal(got, labels.astype(np.int32)) or \
                    not np.array_equal(np.rint(images[:64] * 255.0),
                                       pixels[:64].astype(np.float32)):
                raise AssertionError(f"lenet: the release resolved "
                                     f"{ds.resolution} or reads back "
                                     f"different records")
        n_eval = LENET_TEST // LENET_B
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_conv_counts()
        t0 = time.perf_counter()
        res = recipe.launch_main(conf, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_route = conv_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [st["loss"] for st in res["steps"]]
        n_steps = len(losses)
        if n_steps != LENET_TRAIN // LENET_B or \
                not all(map(math.isfinite, losses)):
            raise AssertionError(f"lenet: {n_steps} steps, losses {losses}")
        if not np.mean(losses[-10:]) < np.mean(losses[:10]):
            raise AssertionError(f"lenet: the loss did not fall: {losses}")
        fwd = n_steps + n_eval
        # B5/B6 a forward/backward: norm1 (C 6, "two_pass") and norm2
        # (C 16 at bf16, "one_pass")
        expected = {"gn_fwd": 2 * fwd, "gn_bwd": 2 * n_steps,
                    "conv1x1": 0, "conv3x3": 0}
        route_expected = {
            "gn_fwd": {"one_pass": fwd, "two_pass": fwd},
            "gn_bwd": {"one_pass": n_steps, "two_pass": n_steps},
            "conv1x1": dict.fromkeys(by_route["conv1x1"], 0),
            "conv3x3": dict.fromkeys(by_route["conv3x3"], 0)}
        if launches != expected or by_route != route_expected:
            raise AssertionError(f"lenet: launches {launches} by route "
                                 f"{by_route}, expected {expected} by route "
                                 f"{route_expected}")
        step_s = res["train_s"] / res["train_steps"]
        out.update({"losses": losses, "launches": launches,
                    "by_route": by_route, "eval_batches": n_eval,
                    "main_wall_s": wall, "epoch_step_ms": step_s * 1e3,
                    "epoch_img_per_s": LENET_B / step_s,
                    "peak_mem_bytes": peak, "test_acc": res.get("test_acc"),
                    "release_bytes": rel["bytes"],
                    "release_write_s": rel["seconds"]})
        log(f"lenet: LeNet-5 over a {rel['bytes'] / 1e6:.1f} MB MNIST IDX "
            f"release (local:mnist_idx), batch {LENET_B}, bf16, {n_steps} "
            f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, test acc "
            f"{res.get('test_acc')}; epoch {step_s * 1e3:.2f} ms per step "
            f"({LENET_B / step_s:.0f} img/s, host fetch included), peak "
            f"mem {peak / 2**30:.3f} GiB; B5 by route {by_route['gn_fwd']}, "
            f"B6 by route {by_route['gn_bwd']} [{smi}]")
        out["kernels_vs_plain"] = lenet_kernels_vs_plain(root)
        b = out["breakdown"] = lenet_breakdown(root)
        log(f"lenet profiled: {b['steps']} steps, {b['step_ms']:.2f} ms per "
            f"step, {b['img_per_s']:.0f} img/s, device "
            f"{b['device_ms_per_step']:.2f} ms per step, busy "
            f"{100 * b['device_busy_share']:.1f}%, "
            f"{b['kernels_per_step']:.0f} kernels per step, B5/B6 "
            f"{100 * b['b5_b6_share_of_device']:.1f}% of device time; top: "
            + "; ".join(f"{k[:50]} {v * 1e3:.2f} ms" for k, v in b["top"][:5])
            + f" [{smi}]")
    report["lenet"] = out
    return {**launches, "by_route": by_route}


# --------------------------------------------------------- resnet_import
IMPORT_B, IMPORT_SIZE = 8, 224     # the held forward's batch, ImageNet
IMPORT_TUNE_EXAMPLES = 4096   # the cifar10 twin's: 8 fine-tune steps at 512
IMPORT_TOL = 1e-4      # fp32, of the largest logit


def torch_resnet18(classes: int = 1000):
    """torchvision's ResNet-18 architecture in plain ``torch.nn``, with
    its ``state_dict`` key names (conv1, bn1, layerN.M.convK/bnK,
    downsample.0/1, fc); no torchvision needed."""
    import torch.nn as nn

    class Basic(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            idn = self.downsample(x) if self.downsample is not None else x
            y = torch.relu(self.bn1(self.conv1(x)))
            return torch.relu(self.bn2(self.conv2(y)) + idn)

    class R18(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            cin = 64
            for si, w in enumerate((64, 128, 256, 512)):
                setattr(self, f"layer{si + 1}", nn.Sequential(
                    Basic(cin, w, 2 if si else 1), Basic(w, w, 1)))
                cin = w
            self.fc = nn.Linear(512, classes)

        def forward(self, x):
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            for si in range(4):
                x = getattr(self, f"layer{si + 1}")(x)
            return self.fc(x.mean(dim=(2, 3)))

    return R18()


def randomized_resnet18(seed: int = 0):
    """:func:`torch_resnet18` with random weights and randomized
    BatchNorm statistics (fresh ones, mean 0 and variance 1, would hide a
    dropped fold), in eval mode."""
    import torch.nn as nn

    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    model = torch_resnet18()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                               + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(
                    m.running_mean.shape, generator=gen) * 0.5)
                m.running_var.copy_(torch.rand(
                    m.running_var.shape, generator=gen) * 2 + 0.5)
    return model.eval()


def phase_resnet_import(report: dict, smi: str) -> dict:
    """A torchvision-layout ResNet-18 saved as ``.pt``, loaded through
    the ResNet recipe's ``pretrained``: its ``norm="affine"`` forward
    held to the module's own ``eval()`` forward on the card (fp32, 224²),
    then a fine-tune of the swapped head through ``launch_main``. The
    frozen-BN affine runs no kernel: B5-B8 must not launch."""
    import tempfile

    from torchbooster_tpu_torch.config import DatasetConfig
    from torchbooster_tpu_torch.models.resnet import ResNet
    from torchbooster_tpu_torch.recipes import resnet as recipe

    out: dict = {"card": smi}
    model = randomized_resnet18()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "resnet18.pt"
        torch.save(model.state_dict(), ckpt)
        conf = resnet_train_config(1, "fp32")
        conf.pretrained, conf.num_classes = str(ckpt), 1000
        reset_conv_counts()
        t0 = time.perf_counter()
        params, norm = recipe.load_pretrained(
            conf, ResNet.init(0, 18, 1000, "imagenet", device=DEV),
            torch.Generator().manual_seed(conf.seed), DEV)
        out["import_s"] = time.perf_counter() - t0
        if norm != "affine":
            raise AssertionError(f"resnet_import: norm {norm!r}")
        x = torch.randn(IMPORT_B, 3, IMPORT_SIZE, IMPORT_SIZE,
                        generator=torch.Generator().manual_seed(1)).to(DEV)
        xh = x.permute(0, 2, 3, 1).contiguous()
        model = model.to(DEV)
        with torch.no_grad():
            want = model(x)
            got = ResNet.apply(params, xh, norm="affine")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            top = want.abs().max().item()
            out["ms"] = cuda_ms(lambda: ResNet.apply(params, xh,
                                                     norm="affine"), 20)
            out["torch_ms"] = cuda_ms(lambda: model(x), 20)
        if not err <= IMPORT_TOL * top:
            raise AssertionError(f"resnet_import: imported forward differs "
                                 f"from eval() by {err} (max |logit| {top},"
                                 f" tolerance {IMPORT_TOL} of it)")
        out.update({"max_abs_err": err, "max_abs_logit": top,
                    "tol_of_max": IMPORT_TOL})
        log(f"resnet_import: a torchvision-layout ResNet-18 .pt through the "
            f"recipe's pretrained ({out['import_s']:.2f} s), norm affine at "
            f"fp32, {IMPORT_B} x {IMPORT_SIZE}²: max |err| {err:.3g} vs torch eval() "
            f"(max |logit| {top:.3g}, tol {IMPORT_TOL} of it); forward "
            f"{out['ms']:.2f} ms vs the module's {out['torch_ms']:.2f} ms "
            f"[{smi}]")
        tune = resnet_train_config(1)
        tune.pretrained, tune.freeze_backbone = str(ckpt), True
        tune.dataset = DatasetConfig(name="synthetic_cifar10",
                                     n_examples=IMPORT_TUNE_EXAMPLES)
        tune.scheduler.n_iter = IMPORT_TUNE_EXAMPLES // RN_B
        res = recipe.launch_main(tune, device=DEV)
    launches, _ = conv_counts()
    losses = [st["loss"] for st in res["steps"]]
    if len(losses) != IMPORT_TUNE_EXAMPLES // RN_B or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"resnet_import fine-tune: losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"resnet_import: norm affine launched "
                             f"{launches}")
    step_s = res["train_s"] / res["train_steps"]
    out.update({"tune_losses": losses, "tune_step_ms": step_s * 1e3,
                "tune_img_per_s": RN_B / step_s,
                "tune_test_acc": res.get("test_acc"), "launches": launches})
    log(f"resnet_import fine-tune: launch_main, head only "
        f"(freeze_backbone), bf16, batch {RN_B}, {len(losses)} steps on the "
        f"cifar10 twin, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{step_s * 1e3:.1f} ms per step, B5-B8 launches {launches} [{smi}]")
    report["resnet_import"] = out
    return out


# ---------------------------------------------------------- image_models
NF_SIZE = 224          # NF-ResNet-50 at ImageNet's resolution
NF_B = 32              # its training batch
NF_HELD_B = 8          # the s2d-vs-plain forward's batch
NF_STEPS = 6           # on one fixed batch: the loss must fall
NF_TOL = 2e-4          # s2d vs plain stem, fp32, of the largest logit
VGG_SIZE = 256         # examples/img_stt/offline/offline.yml
VGG_TAPS = (1, 6, 11, 20, 29)        # its style layers (29: content too)
VGG_STEPS = 10


def nf_train(params, x, y, stem_s2d: bool) -> dict:
    """``NF_STEPS`` SGD-momentum steps (the variant's published pairing)
    of NF-ResNet-50 at bf16 over fp32 masters on one fixed batch."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.models import ResNet
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    tx = OptimizerConfig(name="sgd", lr=0.02, momentum=0.9).make()
    state = utils.TrainState.create(params, tx)

    def loss_fn(p, batch, generator):
        logits = ResNet.apply(p, batch[0], norm="ws", stem_s2d=stem_s2d)
        return cross_entropy(logits, batch[1]), {}

    step = utils.make_step(loss_fn, tx, compute_dtype=torch.bfloat16)
    losses, times = [], []
    for _ in range(NF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, (x, y))
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "step_ms": float(np.median(times[2:])) * 1e3}


def vgg_style_steps(smi: str) -> dict:
    """The offline style-transfer step at ``offline.yml``'s geometry:
    VGG-19 features of one 256² image (fp32, random weights), content
    loss at slot 29, style loss on the grams of the taps, total
    variation, Adam on the image."""
    from torchbooster_tpu_torch.models import VGGFeatures
    from torchbooster_tpu_torch.models.vgg import gram_matrix, \
        total_variation

    gen = torch.Generator().manual_seed(3)
    vgg = VGGFeatures.init(0, 19, device=DEV)
    content = torch.rand(1, VGG_SIZE, VGG_SIZE, 3, generator=gen).to(DEV)
    style = torch.rand(1, VGG_SIZE, VGG_SIZE, 3, generator=gen).to(DEV)
    with torch.no_grad():
        c_feat = VGGFeatures.apply(vgg, VGGFeatures.normalize(content),
                                   taps=[29])[0]
        s_grams = [gram_matrix(f) for f in VGGFeatures.apply(
            vgg, VGGFeatures.normalize(style), taps=VGG_TAPS)]
    image = content.clone().requires_grad_(True)
    opt = torch.optim.Adam([image], lr=5e-2)
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(VGG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = VGGFeatures.apply(vgg, VGGFeatures.normalize(image),
                                  taps=VGG_TAPS)
        loss = (feats[-1] - c_feat).square().mean() + 1e3 * sum(
            (gram_matrix(f) - g).square().sum()
            for f, g in zip(feats, s_grams)) + 1e-2 * total_variation(image)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"image_models vgg: losses {losses}")
    out = {"losses": losses, "step_ms": float(np.median(times[2:])) * 1e3,
           "peak_mem_bytes": peak,
           "tap_shapes": [tuple(f.shape) for f in feats]}
    log(f"image_models vgg19: offline style step, {VGG_SIZE}² fp32, taps "
        f"{list(VGG_TAPS)} with gram_matrix, loss {losses[0]:.4g} -> "
        f"{losses[-1]:.4g} over {VGG_STEPS} Adam steps, "
        f"{out['step_ms']:.2f} ms per step, peak mem "
        f"{peak / 2**30:.2f} GiB [{smi}]")
    return out


def phase_image_models(report: dict, smi: str) -> dict:
    """NF-ResNet-50 (``norm="ws"``, ImageNet stem) at 224²: the
    space-to-depth stem's forward held to the plain stem's at fp32, then
    bf16 training on one fixed batch through each stem; VGG-19 at the
    offline style recipe's geometry. Neither model has a GroupNorm: B5-B8
    must not launch."""
    from torchbooster_tpu_torch.models import ResNet

    out: dict = {"card": smi}
    reset_conv_counts()
    gen = torch.Generator().manual_seed(1)
    params = ResNet.init(0, 50, 1000, "imagenet", device=DEV)
    x = torch.randn(NF_HELD_B, NF_SIZE, NF_SIZE, 3, generator=gen).to(DEV)
    with torch.no_grad():
        plain = ResNet.apply(params, x, norm="ws")
        s2d = ResNet.apply(params, x, norm="ws", stem_s2d=True)
        err = (s2d - plain).abs().max().item()
        top = plain.abs().max().item()
        fwd_ms = {k: cuda_ms(lambda s=s: ResNet.apply(params, x, norm="ws",
                                                      stem_s2d=s), 10)
                  for k, s in (("plain", False), ("s2d", True))}
    if not (math.isfinite(err) and err <= NF_TOL * top):
        raise AssertionError(f"image_models: s2d stem differs from the "
                             f"plain stem by {err} (max |logit| {top}, "
                             f"tolerance {NF_TOL} of it)")
    out["s2d_vs_plain"] = {"max_abs_err": err, "max_abs_logit": top,
                           "tol_of_max": NF_TOL, "fp32_forward_ms": fwd_ms}
    log(f"image_models nf_resnet50 s2d stem vs plain: fp32, {NF_HELD_B} x "
        f"{NF_SIZE}², max |err| {err:.3g} (max |logit| {top:.3g}, tol {NF_TOL} "
        f"of it); forward {fwd_ms['plain']:.2f} ms plain, "
        f"{fwd_ms['s2d']:.2f} ms s2d [{smi}]")
    x = torch.randn(NF_B, NF_SIZE, NF_SIZE, 3, generator=gen).to(DEV)
    y = torch.randint(0, 1000, (NF_B,), generator=gen).to(DEV)
    for stem, s2d_on in (("plain", False), ("s2d", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = nf_train(ResNet.init(0, 50, 1000, "imagenet", device=DEV), x,
                       y, s2d_on)
        run["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        losses = run["losses"]
        if not all(map(math.isfinite, losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"image_models nf_resnet50 {stem}: losses "
                                 f"{losses}")
        out[f"nf_train_{stem}"] = run
        log(f"image_models nf_resnet50 train ({stem} stem): bf16, batch "
            f"{NF_B} x {NF_SIZE}², SGD-momentum, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {NF_STEPS} steps on one batch, "
            f"{run['step_ms']:.1f} ms per step ({NF_B / run['step_ms'] * 1e3:.0f}"
            f" img/s), peak mem {run['peak_mem_bytes'] / 2**30:.2f} GiB "
            f"[{smi}]")
    del params
    torch.cuda.empty_cache()
    out["vgg19"] = vgg_style_steps(smi)
    launches, _ = conv_counts()
    if any(launches.values()):
        raise AssertionError(f"image_models: a model without GroupNorm "
                             f"launched {launches}")
    out["launches"] = launches
    report["image_models"] = out
    return out


# ------------------------------------------------------------------ ddpm
DDPM_B = 256           # ddpm.yml's batch
DDPM_EPOCHS = 1        # ddpm.yml trains 10 epochs; one here (234 steps)
DDPM_SAMPLES = 16      # ddpm.yml's n_samples
DDPM_DDIM = 50         # ddpm.yml's sample_steps
DDPM_COND_STEPS = 8    # the conditional model's training steps
DDPM_PROFILED = 5      # steps profiled for the busy share
# kernels vs plain, of the largest entry: fp32 sums in another order; at
# bf16 the first GroupNorm rounds its output to bf16 on both sides
DDPM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the GroupNorm shapes of ddpm.yml's UNet, (side, C): B5/B6 timed at each
UNET_GN_SHAPES = ((28, 64), (28, 128), (14, 128), (14, 256), (7, 128),
                  (7, 256))


def ddpm_config(root: Path, tmp: Path, **overrides):
    """``examples/img_gen/ddpm/ddpm.yml``'s values built in code (the
    card's machine reads no YAML), ``DDPM_EPOCHS`` epochs over the MNIST
    release at ``root``, a checkpoint after every epoch under ``tmp`` (the
    YAML saves none; the sampling runs restore the EMA from it), samples
    written under ``tmp``; ``overrides`` set top-level fields."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.ddpm import Config, ModelConfig

    conf = Config(
        epochs=DDPM_EPOCHS, seed=42, timesteps=1000, schedule="cosine",
        n_samples=DDPM_SAMPLES, sample_steps=DDPM_DDIM,
        samples_path=str(tmp / "samples" / "ddpm_samples.npy"),
        model=ModelConfig(in_channels=1, base=64, mults=(1, 2, 2),
                          time_dim=256),
        env=EnvConfig(distributed=False, precision="bf16", n_devices=0,
                      mesh="dp"),
        loader=LoaderConfig(batch_size=DDPM_B, num_workers=0,
                            drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=2e-4,
                              decay_matrices_only=True),
        scheduler=SchedulerConfig(name="cycle", n_iter=0, warmup=32,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="mnist", root=str(root)),
        ema_decay=0.999, save_every=1,
        checkpoint_root=str(tmp / "checkpoints"))
    for key, value in overrides.items():
        setattr(conf, key, value)
    return conf


def unet_gn_calls(cfg, size: int, dtype) -> list[tuple]:
    """Each GroupNorm of one UNet forward over ``size``² images with
    weights of ``dtype``, in order, as ``(H·W, C, groups, dtype)``:
    recorded from a one-image forward on the CPU through a hook on the
    plain GroupNorm, which ``layers.group_norm`` calls there with the
    group count it settled on. The forward states the structure; nothing
    here repeats it."""
    from torchbooster_tpu_torch.models.unet import UNet
    from torchbooster_tpu_torch.ops import group_norm as gnk
    from torchbooster_tpu_torch.utils import _cast_batch

    real, seen = gnk.group_norm_fwd_reference, []

    def hook(x, scale, bias, groups, *args):
        seen.append((x.shape[1] * x.shape[2], x.shape[-1], groups, x.dtype))
        return real(x, scale, bias, groups, *args)

    gnk.group_norm_fwd_reference = hook
    try:
        with torch.no_grad():
            UNet.apply(_cast_batch(UNet.init(0, cfg, device="cpu"), dtype),
                       torch.zeros(1, size, size, cfg.in_channels,
                                   dtype=dtype),
                       torch.zeros(1, dtype=torch.long), cfg)
    finally:
        gnk.group_norm_fwd_reference = real
    return seen


def unet_routes(cfg, size: int, n: int, dtype) -> tuple[dict, dict]:
    """B5's and B6's launches by route in one UNet forward and backward of
    ``n`` images, from :func:`unet_gn_calls` and the plan functions."""
    from torchbooster_tpu_torch.ops import group_norm as gnk

    fwd = {"one_pass": 0, "two_pass": 0}
    bwd = dict(fwd)
    for hw, c, groups, dt in unet_gn_calls(cfg, size, dtype):
        fwd[gnk.plan_gn_fwd(n, hw, c, groups, dt).route] += 1
        bwd[gnk.plan_gn_bwd(n, hw, c, groups, dt).route] += 1
    return fwd, bwd


def scaled(routes: dict, k: int) -> dict:
    return {r: k * n for r, n in routes.items()}


def added(*counts: dict) -> dict:
    return {r: sum(c[r] for c in counts) for r in counts[0]}


def ddpm_kernels_vs_plain(root: Path, tmp: Path) -> dict:
    """One batch of the release through the UNet at ``ddpm.yml``'s widths,
    forward and the gradient of every parameter, through B5/B6
    (``gn_impl="auto"``) and through the plain GroupNorm, from the same
    parameters: at fp32 (the recipe's flow, every call ``"two_pass"``)
    and with bf16 images and weights (the first norm ``"one_pass"``, the
    28 after the fp32 time projection ``"two_pass"``). Exact launches by
    route, and the output and every gradient within ``DDPM_TOL`` of the
    largest entry."""
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.models.unet import UNet
    from torchbooster_tpu_torch.recipes import ddpm as recipe
    from torchbooster_tpu_torch.utils import _cast_batch, tree_leaves

    conf = ddpm_config(root, tmp)
    cfg = conf.model.make()
    loader = conf.loader.make(conf.dataset.make(Split.TRAIN), shuffle=False)
    images, _ = recipe.to_device(next(iter(loader)), torch.device(DEV))
    x = recipe.to_unit(images)[..., None]
    t = torch.randint(0, 1000, (DDPM_B,),
                      generator=torch.Generator().manual_seed(3)).to(DEV)
    params = UNet.init(0, cfg, device=DEV)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for dtype, tol in DDPM_TOL.items():
        want = unet_routes(cfg, 28, DDPM_B, dtype)
        runs = {}
        for impl in ("auto", "plain"):
            before = conv_counts()[1]
            y = UNet.apply(_cast_batch(params, dtype), x.to(dtype), t, cfg,
                           gn_impl=impl)
            (y.float() ** 2).mean().backward()
            after = conv_counts()[1]
            moved = tuple({r: after[k][r] - before[k][r] for r in after[k]}
                          for k in ("gn_fwd", "gn_bwd"))
            runs[impl] = (y.detach().float(), [p.grad.clone() for p in leaves],
                          moved)
            for p in leaves:
                p.grad = None
        name = str(dtype).split(".")[-1]
        if runs["auto"][2] != want or any(sum(m.values())
                                          for m in runs["plain"][2]):
            raise AssertionError(f"ddpm {name}: routes {runs['auto'][2]} "
                                 f"(plain {runs['plain'][2]}), expected "
                                 f"{want}")
        (ya, ga, _), (yp, gp, _) = runs["auto"], runs["plain"]
        y_err = (ya - yp).abs().max().item() / yp.abs().max().item()
        top = max(g.abs().max().item() for g in gp)
        worst = max((a - b).abs().max().item() for a, b in zip(ga, gp)) / top
        if not (math.isfinite(y_err) and y_err <= tol and worst <= tol):
            raise AssertionError(f"ddpm {name}: kernels vs plain output "
                                 f"error {y_err:.3g}, worst gradient error "
                                 f"{worst:.3g} of the largest entry "
                                 f"(tolerance {tol})")
        out[name] = {"output_err_of_max": y_err,
                     "worst_grad_err_of_max": worst, "tol": tol,
                     "routes": runs["auto"][2]}
        log(f"ddpm {name} kernels vs plain: UNet forward + backward at batch "
            f"{DDPM_B} x 28², output error {y_err:.3g}, worst gradient "
            f"error {worst:.3g} of the largest entry (tol {tol}); B5 routes "
            f"{runs['auto'][2][0]}, B6 {runs['auto'][2][1]}")
    return out


def ddpm_breakdown(root: Path, tmp: Path,
                   n_steps: int = DDPM_PROFILED) -> dict:
    """A fresh trainer (no checkpoint): two warm steps, then ``n_steps``
    as the recipe runs them under the profiler: busy share, device ms a
    step, kernels a step, B5/B6's share of device time, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.recipes import ddpm as recipe

    t = recipe.setup(ddpm_config(root, tmp, save_every=0), DEV)
    batches = iter(t.loader)
    for _ in range(2):
        t.state, m = t.step(t.state, recipe.to_device(next(batches),
                                                       t.device))
    m["loss"].item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            t.state, m = t.step(t.state, recipe.to_device(next(batches),
                                                           t.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    ours = sum(v for k, v in per_kernel if "gn_fwd" in k or "gn_bwd" in k)
    return {"steps": n_steps, "step_ms": wall / n_steps * 1e3,
            "img_per_s": DDPM_B * n_steps / wall,
            "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3,
            "b5_b6_share_of_device": ours / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:8]}


def counted_run(fn) -> tuple:
    """``fn()`` with B5-B8's counters from 0: its result, the wall ms
    (synchronized) and the launches by route it made."""
    reset_conv_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, conv_counts()[1]


def ddpm_sampling(conf, cfg, saved: np.ndarray) -> tuple[dict, dict]:
    """The trainer ``setup`` resumes from the epoch's checkpoint (no step
    left to train), then samples from its EMA: DDIM at ``sample_steps``
    (the second run from the seed: equal to the file ``launch_main``
    wrote within 1e-5 of the largest entry) and the ancestral chain over
    all T. Exact B5 counts: 29 a step, all ``"two_pass"``."""
    from torchbooster_tpu_torch.recipes import ddpm as recipe

    t = recipe.setup(conf, DEV)
    if t.start_epoch != conf.epochs:
        raise AssertionError(f"ddpm: resumed at epoch {t.start_epoch}, "
                             f"expected {conf.epochs}")
    weights = t.sample_params()
    per_call = unet_routes(cfg, 28, DDPM_SAMPLES, torch.float32)[0]
    out, moved = {}, []
    runs = {}
    for name, steps in (("ddim", conf.sample_steps), ("ancestral", 0)):
        t.conf.sample_steps = steps
        images, ms, by_route = counted_run(lambda: recipe.sample(t, weights))
        n = steps or conf.timesteps
        if by_route["gn_fwd"] != scaled(per_call, n) or \
                sum(by_route["gn_bwd"].values()):
            raise AssertionError(f"ddpm {name}: B5 {by_route['gn_fwd']}, "
                                 f"B6 {by_route['gn_bwd']}; expected "
                                 f"{scaled(per_call, n)} and none")
        images = images.cpu().numpy()
        if images.shape != (DDPM_SAMPLES, 28, 28, 1) or \
                not np.isfinite(images).all():
            raise AssertionError(f"ddpm {name}: samples {images.shape}, "
                                 f"finite {np.isfinite(images).all()}")
        runs[name] = images
        moved.append(by_route)
        out[name] = {"steps": n, "ms": ms, "ms_per_unet_call": ms / n,
                     "by_route": by_route,
                     "range": [float(images.min()), float(images.max())]}
    err = np.abs(runs["ddim"] - saved).max() / np.abs(saved).max()
    out["ddim_vs_saved_err_of_max"] = float(err)
    if not err <= 1e-5:
        raise AssertionError(f"ddpm: the second DDIM run differs from the "
                             f"first by {err:.3g} of the largest entry")
    conf.sample_steps = DDPM_DDIM
    return out, {k: added(*(m[k] for m in moved)) for k in moved[0]}


def ddpm_conditional(root: Path, tmp: Path) -> tuple[dict, dict]:
    """``n_classes: 10``, ``p_uncond`` 0.1: ``DDPM_COND_STEPS`` steps of
    the trainer, ``cfg_apply`` on the card (w = 0 is the conditional
    branch itself; w = 2 equals 3·ε̂(x, y) − 2·ε̂(x, ∅) within 1e-4 of the
    largest entry), then ``sample`` by DDIM at 50 steps with guidance 2
    over one doubled batch of 32 a step."""
    from torchbooster_tpu_torch.ops.diffusion import cfg_apply
    from torchbooster_tpu_torch.recipes import ddpm as recipe

    conf = ddpm_config(root, tmp, save_every=0, p_uncond=0.1, guidance=2.0)
    conf.model.n_classes = 10
    cfg = conf.model.make()
    t = recipe.setup(conf, DEV)
    batches = iter(t.loader)

    def train():
        return [t.step(t.state, recipe.to_device(next(batches),
                                                 t.device))[1]["loss"]
                for _ in range(DDPM_COND_STEPS)]

    losses, train_ms, trained = counted_run(train)
    losses = torch.stack(losses).tolist()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"ddpm conditional: losses {losses}")
    weights = t.sample_params()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(DDPM_SAMPLES, 28, 28, 1, generator=gen).to(DEV)
    steps = torch.randint(0, 1000, (DDPM_SAMPLES,), generator=gen).to(DEV)
    labels = torch.arange(DDPM_SAMPLES, device=DEV) % 10
    null = torch.full_like(labels, 10)

    def guided():
        with torch.no_grad():
            cond = t.apply_fn(weights, x, steps, labels)
            uncond = t.apply_fn(weights, x, steps, null)
            return (cond, uncond,
                    cfg_apply(t.apply_fn, weights, x, steps, labels, 10, 0.0),
                    cfg_apply(t.apply_fn, weights, x, steps, labels, 10,
                              2.0))

    (cond, uncond, w0, w2), _, checked = counted_run(guided)
    want = 3.0 * cond - 2.0 * uncond
    w2_err = ((w2 - want).abs().max() / want.abs().max()).item()
    if not torch.equal(w0, cond) or not w2_err <= 1e-4:
        raise AssertionError(f"ddpm conditional: cfg_apply at w 0 equal "
                             f"{torch.equal(w0, cond)}, at w 2 error "
                             f"{w2_err:.3g} of the largest entry")
    images, sample_ms, sampled = counted_run(lambda: recipe.sample(t,
                                                                   weights))
    images = images.cpu().numpy()
    if images.shape != (DDPM_SAMPLES, 28, 28, 1) or \
            not np.isfinite(images).all():
        raise AssertionError(f"ddpm conditional: samples {images.shape}")
    fwd, bwd = unet_routes(cfg, 28, DDPM_B, torch.float32)
    want = {"gn_fwd": scaled(fwd, DDPM_COND_STEPS),
            "gn_bwd": scaled(bwd, DDPM_COND_STEPS)}
    if {k: trained[k] for k in want} != want:
        raise AssertionError(f"ddpm conditional: training launched "
                             f"{trained}, expected {want}")
    doubled = unet_routes(cfg, 28, 2 * DDPM_SAMPLES, torch.float32)[0]
    for what, got, n in (("cfg check", checked, 4),
                         ("sampling", sampled, DDPM_DDIM)):
        want = scaled(doubled if what == "sampling" else
                      unet_routes(cfg, 28, DDPM_SAMPLES, torch.float32)[0],
                      n)
        if got["gn_fwd"] != want or sum(got["gn_bwd"].values()):
            raise AssertionError(f"ddpm conditional {what}: B5 "
                                 f"{got['gn_fwd']}, expected {want}")
    out = {"losses": losses, "train_ms": train_ms, "w2_err_of_max": w2_err,
           "sample_ms": sample_ms, "ms_per_unet_call": sample_ms / DDPM_DDIM}
    return out, {k: added(trained[k], checked[k], sampled[k])
                 for k in trained}


def time_gn_at(gen, side: int, c: int, dtype) -> dict:
    """B5 and B6 at one of the UNet's GroupNorm shapes (batch 256, 8
    groups, no ReLU) beside their plain versions, the bound and
    ``F.group_norm`` (its forward, and its backward by autograd, on the
    channels-last view of the same tensor)."""
    import torch.nn.functional as F

    from torchbooster_tpu_torch.ops import group_norm as gnk

    x = (torch.randn(DDPM_B, side, side, c, generator=gen, device=DEV)
         * 2.0 + 0.5).to(dtype)
    dy = torch.randn(DDPM_B, side, side, c, generator=gen,
                     device=DEV).to(dtype)
    s = 1.0 + 0.1 * torch.randn(c, generator=gen, device=DEV)
    b = 0.1 * torch.randn(c, generator=gen, device=DEV)
    _, st = gnk.launch_fwd(x, s, b, 8, 1e-5)
    x4, dy4 = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    xg = x4.detach().clone(memory_format=torch.channels_last) \
        .requires_grad_()
    sg = s.to(dtype).requires_grad_()
    bg = b.to(dtype).requires_grad_()
    lib_out = F.group_norm(xg, 8, sg, bg, 1e-5)
    fns = {"gn_fwd": (lambda: gnk.launch_fwd(x, s, b, 8, 1e-5),
                      lambda: gnk.group_norm_fwd_reference(x, s, b, 8),
                      lambda: F.group_norm(x4, 8, sg.detach(), bg.detach(),
                                           1e-5)),
           "gn_bwd": (lambda: gnk.launch_bwd(x, dy, st, s, b, 8),
                      lambda: gnk.group_norm_bwd_reference(x, dy, st, s, b,
                                                           8),
                      lambda: torch.autograd.grad(lib_out, (xg, sg, bg), dy4,
                                                  retain_graph=True))}
    el = 2 if dtype == torch.bfloat16 else 4
    work = conv_work(("unet", "gn", DDPM_B, side, side, c, c, 1), el)
    out = {}
    for key, (kern, plain, lib) in fns.items():
        ms = {}
        for col, fn in (("kernel", kern), ("plain", plain),
                        ("library", lib)):
            iters = 3 if col == "plain" else 10
            ms[col] = device_ms(fn, iters=iters) or stream_ms(fn, iters=iters)
        nbytes, flops, peak = work[key]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        plan = (gnk.plan_gn_fwd if key == "gn_fwd" else gnk.plan_gn_bwd)(
            DDPM_B, side * side, c, 8, dtype)
        out[key] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                    "library_ms": ms["library"],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "route": plan.route, "plan": plan._asdict()}
    return out


def ddpm_gn_timing(smi: str) -> dict:
    """B5 and B6 at every GroupNorm shape of the UNet at ``ddpm.yml``'s
    widths, fp32 (the recipe's route) and bf16."""
    gen = torch.Generator(DEV).manual_seed(11)
    out = {}
    for side, c in UNET_GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = f"{side}x{side}x{c}_{str(dtype).split('.')[-1]}"
            res = out[name] = time_gn_at(gen, side, c, dtype)
            log(f"ddpm gn timing {name} (batch {DDPM_B}, 8 groups): "
                + "; ".join(
                    f"{k} {r['route']} {r['ms'] * 1e3:.1f} us, plain "
                    f"{r['plain_ms'] * 1e3:.1f} us, F.group_norm "
                    f"{r['library_ms'] * 1e3:.1f} us, bound "
                    f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})"
                    for k, r in res.items()) + f" [{smi}]")
    return out


def phase_ddpm(report: dict, smi: str) -> dict:
    """The ddpm recipe on the card at ``ddpm.yml``'s widths over a
    full-size MNIST IDX release: the UNet's kernels held to the plain
    GroupNorm (fp32 and bf16), ``launch_main`` for one epoch (loss
    falling, B5/B6 exact by route, samples by DDIM), sampling from the
    restored EMA (DDIM twice, the ancestral chain), the conditional model
    with guidance, a profiled window and B5/B6 timed at the UNet's
    shapes. Returns B5/B6's launches from the main-path runs."""
    import tempfile

    from torchbooster_tpu_torch.recipes import ddpm as recipe

    out: dict = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        root = tmp / "mnist"
        rel = write_mnist_release(root)
        out["kernels_vs_plain"] = ddpm_kernels_vs_plain(root, tmp)
        conf = ddpm_config(root, tmp)
        cfg = conf.model.make()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, wall_ms, trained = counted_run(
            lambda: recipe.launch_main(conf, device=DEV))
        peak = torch.cuda.max_memory_allocated()
        losses = res["losses"]
        n_steps = len(losses)
        if n_steps != DDPM_EPOCHS * (LENET_TRAIN // DDPM_B) or \
                not all(map(math.isfinite, losses)):
            raise AssertionError(f"ddpm: {n_steps} steps, losses {losses}")
        if not np.mean(losses[-20:]) < np.mean(losses[:20]):
            raise AssertionError(f"ddpm: the loss did not fall: {losses}")
        fwd, bwd = unet_routes(cfg, 28, DDPM_B, torch.float32)
        sample_fwd = unet_routes(cfg, 28, DDPM_SAMPLES, torch.float32)[0]
        want = {"gn_fwd": added(scaled(fwd, n_steps),
                                scaled(sample_fwd, DDPM_DDIM)),
                "gn_bwd": scaled(bwd, n_steps),
                "conv1x1": dict.fromkeys(trained["conv1x1"], 0),
                "conv3x3": dict.fromkeys(trained["conv3x3"], 0)}
        if trained != want:
            raise AssertionError(f"ddpm: launches by route {trained}, "
                                 f"expected {want}")
        saved = np.load(res["samples"])
        step_s = res["train_s"] / res["train_steps"]
        out.update({"losses": losses, "by_route": trained,
                    "main_wall_ms": wall_ms, "epoch_step_ms": step_s * 1e3,
                    "epoch_img_per_s": DDPM_B / step_s,
                    "peak_mem_bytes": peak, "release_bytes": rel["bytes"]})
        log(f"ddpm: UNet (base 64, mults 1,2,2, time_dim 256, cosine T 1000, "
            f"EMA 0.999) over the MNIST IDX release, batch {DDPM_B}, bf16 "
            f"weights over fp32 images, {n_steps} steps, loss "
            f"{np.mean(losses[:20]):.4f} -> {np.mean(losses[-20:]):.4f} "
            f"(first / last 20); epoch {step_s * 1e3:.2f} ms per step "
            f"({DDPM_B / step_s:.0f} img/s, host fetch included), peak mem "
            f"{peak / 2**30:.2f} GiB; B5 by route {trained['gn_fwd']}, B6 "
            f"{trained['gn_bwd']} (train + DDIM {DDPM_DDIM} sampling) [{smi}]")
        sampling, sampled = ddpm_sampling(conf, cfg, saved)
        out["sampling"] = sampling
        log(f"ddpm sampling from the restored EMA ({DDPM_SAMPLES} samples): "
            + "; ".join(f"{k} {v['steps']} steps {v['ms']:.1f} ms "
                        f"({v['ms_per_unet_call']:.2f} ms per UNet call), B5 "
                        f"{v['by_route']['gn_fwd']}"
                        for k, v in sampling.items() if isinstance(v, dict))
            + f"; DDIM vs launch_main's file (the same seed) "
            f"{sampling['ddim_vs_saved_err_of_max']:.3g} of the largest "
            f"entry [{smi}]")
        cond, cond_moved = ddpm_conditional(root, tmp)
        out["conditional"] = cond
        log(f"ddpm conditional (10 classes, p_uncond 0.1): "
            f"{DDPM_COND_STEPS} steps, losses {cond['losses'][0]:.4f} -> "
            f"{cond['losses'][-1]:.4f}; cfg_apply w 0 equal to the "
            f"conditional call, w 2 within {cond['w2_err_of_max']:.3g} of "
            f"the largest entry; DDIM {DDPM_DDIM} at guidance 2.0 (batch "
            f"{2 * DDPM_SAMPLES} a step) {cond['sample_ms']:.1f} ms "
            f"({cond['ms_per_unet_call']:.2f} ms per UNet call) [{smi}]")
        b = out["breakdown"] = ddpm_breakdown(root, tmp)
        log(f"ddpm profiled: {b['steps']} steps, {b['step_ms']:.2f} ms per "
            f"step, {b['img_per_s']:.0f} img/s, device "
            f"{b['device_ms_per_step']:.2f} ms per step, busy "
            f"{100 * b['device_busy_share']:.1f}%, "
            f"{b['kernels_per_step']:.0f} kernels per step, B5/B6 "
            f"{100 * b['b5_b6_share_of_device']:.1f}% of device time; top: "
            + "; ".join(f"{k[:50]} {v * 1e3:.2f} ms" for k, v in b["top"][:5])
            + f" [{smi}]")
    out["gn_timing"] = ddpm_gn_timing(smi)
    report["ddpm"] = out
    by_route = {k: added(trained[k], sampled[k], cond_moved[k])
                if k in sampled else trained[k] for k in trained}
    return {**{k: sum(v.values()) for k, v in by_route.items()},
            "by_route": by_route, "gn_timing": out["gn_timing"]}


# --------------------------------------------------------------- vae_gan
GEN_B = 512            # vae.yml's and gan.yml's batch
GAN_GRAD_TOL = 1e-4    # card vs CPU, fp32 (TF32 off), of the largest entry


def b_counts() -> tuple:
    """Every B-kernel launch counter of the port: B1-B3, B4, B5-B8."""
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")
    fl = flash_counts()
    return (fl["fwd"], fl["dq"], fl["dkv"], pa.launches,
            *conv_counts()[0].values())


def gen_env(precision: str):
    from torchbooster_tpu_torch.config import EnvConfig, LoaderConfig

    return (EnvConfig(distributed=False, precision=precision, n_devices=0,
                      mesh="dp"),
            LoaderConfig(batch_size=GEN_B, num_workers=0, drop_last=True))


def gan_grad_card_vs_cpu(root: Path) -> dict:
    """D's loss (hinge + 10 × penalty) on the release's first batch, its
    gradient with respect to D's parameters (the double backward
    included) on the card against the CPU: the same weights, images, z
    and α."""
    from torchbooster_tpu_torch.config import DatasetConfig
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.models import GAN
    from torchbooster_tpu_torch.models import gan
    from torchbooster_tpu_torch.recipes.vae import to_unit

    ds = DatasetConfig(name="mnist", root=str(root)).make(Split.TRAIN)
    images = torch.as_tensor(ds.arrays[0][:GEN_B])
    x_real = to_unit(images)[..., None]
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(GEN_B, 64, generator=gen)
    alpha = torch.rand(GEN_B, 1, 1, 1, generator=gen)
    out = {}
    for dev in ("cpu", DEV):
        params = GAN.init(1, device=dev)
        d = params["D"]
        leaves = [p.requires_grad_(True) for p in
                  (leaf for block in d.values() for leaf in block.values())]
        with torch.no_grad():
            fake = GAN.generate(params["G"], z.to(dev))
        loss = gan.hinge_d_loss(d, x_real.to(dev), fake) + 10.0 * \
            gan._grad_penalty_core(d, x_real.to(dev), fake, alpha.to(dev))
        loss.backward()
        out[dev] = (loss.item(), [p.grad.cpu() for p in leaves])
    (lc, gc), (lg, gg) = out["cpu"], out[DEV]
    top = max(g.abs().max().item() for g in gc)
    err = max((a - b).abs().max().item() for a, b in zip(gg, gc)) / top
    if not (abs(lg - lc) <= GAN_GRAD_TOL * abs(lc) and err <= GAN_GRAD_TOL):
        raise AssertionError(f"gan: card loss {lg} vs CPU {lc}, gradient "
                             f"error {err:.3g} of the largest entry")
    return {"loss_card": lg, "loss_cpu": lc, "grad_err_of_max": err}


def phase_vae_gan(report: dict, smi: str) -> dict:
    """The vae and gan recipes' ``launch_main`` for one epoch each over a
    full-size MNIST IDX release at their YAMLs' values (vae bf16; the GAN
    fp32, as JAX's step never casts). No B-kernel may launch."""
    import tempfile

    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes import gan, vae

    out: dict = {"card": smi}
    before = b_counts()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        root = tmp / "mnist"
        write_mnist_release(root)
        data = DatasetConfig(name="mnist", root=str(root))
        env, loader = gen_env("bf16")
        conf = vae.Config(
            epochs=1, seed=42, z_dim=32, kld_weight=1.0, n_samples=64,
            samples_path=str(tmp / "vae_samples.npy"), env=env,
            loader=loader, optim=OptimizerConfig(name="adamw", lr=1e-3),
            scheduler=SchedulerConfig(name="cycle", n_iter=160, warmup=16,
                                      decay=("cos", "cos")), dataset=data)
        torch.cuda.reset_peak_memory_stats()
        res = vae.launch_main(conf, device=DEV)
        peak = torch.cuda.max_memory_allocated()
        losses = res["losses"]
        samples = np.load(res["samples"])
        if len(losses) != LENET_TRAIN // GEN_B or not all(
                map(math.isfinite, losses)) or not res["kld"] >= 0.0 or \
                not np.mean(losses[-10:]) < np.mean(losses[:10]) or \
                samples.shape != (64, 28, 28, 1):
            raise AssertionError(f"vae: losses {losses}, kld {res['kld']}, "
                                 f"samples {samples.shape}")
        step_ms = res["train_s"] / len(losses) * 1e3
        out["vae"] = {"losses": losses, "kld": res["kld"], "bce": res["bce"],
                      "step_ms": step_ms, "peak_mem_bytes": peak}
        log(f"vae_gan vae: vae.yml, batch {GEN_B}, bf16 weights over fp32 "
            f"pixels, {len(losses)} steps, loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, kld {res['kld']:.3f}; {step_ms:.2f} ms per "
            f"step (host fetch included), peak mem {peak / 2**30:.3f} GiB; "
            f"64 samples written [{smi}]")
        env, loader = gen_env("bf16")
        conf = gan.Config(
            epochs=1, seed=42, z_dim=64, gp_weight=10.0, n_samples=64,
            samples_path=str(tmp / "gan_samples.npy"), env=env,
            loader=loader,
            g_optim=OptimizerConfig(name="adam", lr=1e-4,
                                    betas=(0.5, 0.999)),
            d_optim=OptimizerConfig(name="adam", lr=4e-4,
                                    betas=(0.5, 0.999)),
            g_scheduler=SchedulerConfig(name="cycle", n_iter=160,
                                        decay=("flat", "cos")),
            d_scheduler=SchedulerConfig(name="cycle", n_iter=160,
                                        decay=("flat", "cos")),
            dataset=data)
        torch.cuda.reset_peak_memory_stats()
        res = gan.launch_main(conf, device=DEV)
        peak = torch.cuda.max_memory_allocated()
        steps = res["steps"]
        samples = np.load(res["samples"])
        if len(steps) != LENET_TRAIN // GEN_B or not all(
                math.isfinite(v) for m in steps for v in m.values()) or \
                samples.shape != (64, 28, 28, 1):
            raise AssertionError(f"gan: steps {steps[:3]}..., samples "
                                 f"{samples.shape}")
        step_ms = res["train_s"] / len(steps) * 1e3
        grad = gan_grad_card_vs_cpu(root)
        out["gan"] = {"steps": steps, "step_ms": step_ms,
                      "peak_mem_bytes": peak, "grad_check": grad}
        log(f"vae_gan gan: gan.yml, batch {GEN_B}, fp32, {len(steps)} "
            f"two-player steps, d_loss {steps[0]['d_loss']:.3f} -> "
            f"{steps[-1]['d_loss']:.3f}, g_loss {steps[0]['g_loss']:.3f} -> "
            f"{steps[-1]['g_loss']:.3f}, gp {steps[-1]['gp']:.4f}; "
            f"{step_ms:.2f} ms per step, peak mem {peak / 2**30:.3f} GiB; "
            f"D-loss gradient card vs CPU {grad['grad_err_of_max']:.3g} of "
            f"the largest entry (tol {GAN_GRAD_TOL}) [{smi}]")
    if b_counts() != before:
        raise AssertionError(f"vae_gan: a B-kernel launched: {before} -> "
                             f"{b_counts()}")
    report["vae_gan"] = out
    return out


# ----------------------------------------------------------------- style
STYLE_ONLINE_ITERS = 24     # online.yml trains 2,000 iterations
STYLE_ADAIN_ITERS = 24      # adain.yml trains 2,000
STYLE_SAMPLE_EVERY = 12     # both YAMLs preview every 200


def phase_style(report: dict, smi: str) -> dict:
    """The three style recipes on the card: ``offline.yml`` in full (500
    Adam steps on a 256² image's logits, fp32, random VGG-19),
    ``online.yml`` and ``adain.yml`` cut to ``STYLE_*_ITERS`` steps
    (previews every ``STYLE_SAMPLE_EVERY``) at their batches and 256²,
    bf16, random VGG-16 / VGG-19 over procedural images. Every loss
    finite, offline's falling, every output written; no B-kernel."""
    import tempfile

    from torchbooster_tpu_torch.config import (
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes import adain, offline, online

    out: dict = {"card": smi}
    before = b_counts()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        env, _ = gen_env("fp32")
        conf = offline.Config(
            n_iter=500, seed=42, image_size=256,
            content_path=str(tmp / "content.jpg"),
            style_path=str(tmp / "style.jpg"), content_layers=[29],
            style_layers=[1, 6, 11, 20, 29], content_weight=1.0,
            style_weight=1e3, tv_weight=1e-2,
            output_path=str(tmp / "out" / "stylized.npy"), env=env,
            optim=OptimizerConfig(name="adam", lr=5e-2))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = offline.main(conf, device=DEV)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = res["losses"]
        image = np.load(conf.output_path)
        if len(losses) != 500 or not all(map(math.isfinite, losses)) or \
                not losses[-1] < losses[0] or image.shape != (256, 256, 3):
            raise AssertionError(f"style offline: losses {losses[:3]} ... "
                                 f"{losses[-3:]}, output {image.shape}")
        out["offline"] = {"losses": losses, "main_s": wall,
                          "step_ms": wall / 500 * 1e3, "peak_mem_bytes": peak}
        log(f"style offline: offline.yml, 256² fp32, random VGG-19, 500 "
            f"Adam steps, loss {losses[0]:.4g} -> {losses[-1]:.4g}; "
            f"{wall / 500 * 1e3:.2f} ms per step (main's wall, set-up "
            f"included), peak mem {peak / 2**30:.2f} GiB [{smi}]")
        for name, recipe, n_iter, batch in (
                ("online", online, STYLE_ONLINE_ITERS, 16),
                ("adain", adain, STYLE_ADAIN_ITERS, 8)):
            env, loader = gen_env("bf16")
            loader.batch_size = batch
            warmup = 100 if name == "online" else 1_000
            common = dict(
                n_iter=n_iter, seed=42, sample_every=STYLE_SAMPLE_EVERY,
                samples_path=str(tmp / f"{name}_samples"), env=env,
                loader=loader,
                optim=OptimizerConfig(name="adam",
                                      lr=1e-3 if name == "online" else 1e-4),
                scheduler=SchedulerConfig(name="cycle", n_iter=2_000,
                                          warmup=warmup,
                                          decay=("lin", "cos")))
            if name == "online":
                conf = online.Config(
                    style_path=str(tmp / "style.jpg"), content_layers=[15],
                    style_layers=[3, 8, 15, 22], content_weight=1.0,
                    style_weight=1e2, tv_weight=1e-2,
                    dataset=online.CocoDatasetConfig(
                        name="coco", root=str(tmp / "coco"),
                        image_size=256, n_images=2_048), **common)
                want = [f"styled_{i:06d}.npy" for i in range(
                    STYLE_SAMPLE_EVERY, n_iter + 1, STYLE_SAMPLE_EVERY)]
            else:
                conf = adain.Config(
                    style_weight=10.0,
                    content=adain.ContentDatasetConfig(
                        name="coco", root=str(tmp / "coco"), image_size=256,
                        n_images=2_048),
                    style=adain.PaintingsDatasetConfig(
                        name="paintings", root=str(tmp / "paintings"),
                        image_size=256, n_images=1_024), **common)
                want = ["adain_final.npy"]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = recipe.launch_main(conf, device=DEV)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            losses = res["losses"]
            written = sorted(p.name for p in Path(conf.samples_path)
                             .glob("*.npy"))
            if len(losses) != n_iter or not all(map(math.isfinite,
                                                    losses)) or \
                    written != want:
                raise AssertionError(f"style {name}: losses {losses}, "
                                     f"written {written}, expected {want}")
            out[name] = {"losses": losses, "main_s": wall,
                         "step_ms": wall / n_iter * 1e3,
                         "peak_mem_bytes": peak, "written": written}
            log(f"style {name}: {name}.yml at batch {batch} x 256², bf16, "
                f"{n_iter} steps (cut from 2,000), loss {losses[0]:.4g} -> "
                f"{losses[-1]:.4g}; {wall / n_iter * 1e3:.1f} ms per step "
                f"(main's wall, set-up and previews included), peak mem "
                f"{peak / 2**30:.2f} GiB; wrote {', '.join(written)} "
                f"[{smi}]")
    if b_counts() != before:
        raise AssertionError(f"style: a B-kernel launched: {before} -> "
                             f"{b_counts()}")
    report["style"] = out
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    # the dataset chain's HuggingFace link (``cifar10`` without a local
    # release) must not reach for the hub: the smoke needs no network
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    root = Path(__file__).resolve().parent
    if not (root / "torchbooster_tpu_torch").is_dir():
        # never drive an installed copy: the smoke tests this checkout
        print(f"chip_smoke: no torchbooster_tpu_torch/ beside {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from torchbooster_tpu_torch.ops import _build
    pa = importlib.import_module("torchbooster_tpu_torch.ops.paged_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    smi = smi_line()
    report["card"] = smi
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(x{torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    blank = {"launches": 0, "max_abs_err": None, "ms": None, "sum_ms": None,
             "timed_by": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    kernel = {"name": "paged_attention", "route": "cuda",
              "source": "torchbooster_tpu_torch/ops/csrc/paged_decode_sm90.cu",
              "replaces": "torchbooster_tpu/ops/paged_attention.py:70",
              **blank, "timed_route": None,
              "launches_by_route": dict.fromkeys(("sm90", "simt"), 0),
              "launches_int8_pool": 0, "previous_ms": None}
    csrc = "torchbooster_tpu_torch/ops/csrc"
    flash = {key: {"name": name, "route": "cuda", "source": f"{csrc}/{src}",
                   "replaces": f"torchbooster_tpu/ops/flash_attention.py:{line}",
                   **blank}
             for key, name, src, line in (
                 ("fwd", "flash_fwd", "flash_fwd_sm90.cu", 104),
                 ("dq", "flash_dq", "flash_bwd_sm90.cu", 227),
                 ("dkv", "flash_dkv", "flash_bwd_sm90.cu", 265))}
    # the file each route's launches come from: "ms" and "source" are the
    # "sm90" kernels' (GPT-2 small's D 64); at gpt-long's D 48 ("gpt_long"
    # below) B1-B3 run the "sm90" kernels too
    for key in flash:
        flash[key].update(timed_route=None, launches_by_route=None,
                          previous_ms=None, sources_by_route={
                              "sm90": flash[key]["source"],
                              "mma_sync": f"{csrc}/flash_attention.cu",
                              "f32": f"{csrc}/flash_attention.cu"})
    conv_kernels = {key: {"name": name, "route": "cuda",
                          "source": f"torchbooster_tpu_torch/ops/csrc/{src}",
                          "replaces": f"torchbooster_tpu/ops/{ref}", **blank}
                    for key, name, src, ref in (
                        ("gn_fwd", "gn_fwd", "group_norm_fwd_sm90.cu",
                         "group_norm.py:69"),
                        ("gn_bwd", "gn_bwd", "group_norm_bwd_sm90.cu",
                         "group_norm.py:106"),
                        ("conv1x1", "conv1x1_gn", "conv1x1_gn_sm90.cu",
                         "fused_block.py:70"),
                        ("conv3x3", "conv3x3_gn", "conv3x3_gn_sm90.cu",
                         "fused_block.py:238"))}
    for key in ("gn_fwd", "gn_bwd", "conv1x1", "conv3x3"):
        conv_kernels[key].update(timed_route=None, launches_by_route=None,
                                 previous_ms=None)
    t0 = time.perf_counter()
    # wall seconds of each phase, in chiprun_out/chip_smoke.json
    phase_s = report["phase_s"] = {}
    if "build" in phases:
        # one nvcc per source, all started together
        from concurrent.futures import ThreadPoolExecutor

        t = time.perf_counter()
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(_build.build, SOURCES))
        report["build_s"] = time.perf_counter() - t
        report["build_s_each"] = dict(_build.build_seconds)
        report["ptxas"] = {n: _build.ptxas_info.get(n, "") for n in SOURCES}
        log(f"build: {', '.join(f'{n}.cu {sec:.1f} s' for n, sec in _build.build_seconds.items())}"
            f" (in parallel, {report['build_s']:.1f} s)")
        for src, pattern in (
                ("paged_decode_sm90",
                 r"(paged_partials_sm90)ILi(\d+)ELi(\d+)E"
                 r"|(paged_merge_sm90)ILi(\d+)E"),
                ("flash_fwd_sm90", r"(flash_fwd_sm90)ILi(\d+)E"),
                ("flash_bwd_sm90", r"(flash_dq_sm90|flash_dkv_sm90)ILi(\d+)E"),
                ("conv1x1_gn_sm90", r"(conv_gn_sm90)ILi(\d+)ELi(\d+)E"),
                ("conv3x3_gn_sm90", r"(conv_gn_sm90)ILi(\d+)ELi(\d+)E"),
                ("group_norm_fwd_sm90", r"(gn_fwd_sm90)E"),
                ("group_norm_bwd_sm90", r"(gn_bwd_sm90)E")):
            regs = report[f"ptxas_{src}"] = ptxas_kernels(
                report["ptxas"][src], pattern)
            log(f"ptxas {src}: " + "; ".join(
                f"{n} {r.get('registers')} registers, spill stores "
                f"{r.get('spill_stores')} / loads {r.get('spill_loads')} "
                f"bytes" for n, r in sorted(regs.items())))
    if "kernel" in phases:
        t = time.perf_counter()
        res = phase_kernel(report)
        phase_s["kernel"] = time.perf_counter() - t
        kernel.update({k: res[k] for k in ("max_abs_err", "ms", "sum_ms",
                                           "timed_by", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "timed_route",
                                           "previous_ms")})
        # the same kernel at gpt-long's decode (D 48, 16 heads over 8):
        # "sm90" with "simt" as previous_ms; its launches are serve_long's
        kernel["gpt_long"] = {k: res["gpt_long"][k] for k in (
            "ms", "timed_by", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "timed_route", "previous_ms")}
    if "flash" in phases:
        t = time.perf_counter()
        res = phase_flash(report)
        phase_s["flash"] = time.perf_counter() - t
        for key in flash:
            flash[key].update({k: res[key][k] for k in (
                "max_abs_err", "ms", "sum_ms", "timed_by", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "timed_route",
                "previous_ms")})
            # the same kernel at gpt-long's geometry (D 48: "sm90", with
            # the "mma_sync" time as previous_ms; B1 with its exponential
            # floor beside bound_ms)
            long = flash[key]["gpt_long"] = {k: res["long"][key].get(k) for k in (
                "max_abs_err", "ms", "timed_by", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "timed_route", "tflops",
                "previous_ms")}
            if key == "fwd":
                long["exp_floor_ms"] = res["long"][key]["exp_floor_ms"]
            long["source"] = flash[key]["sources_by_route"][long["timed_route"]]
    if set(SERVE_PHASES) & set(phases):
        params, cfg = gpt2_small()
        replayed = lambda: sum(pa.launches_replayed.values())
        if "serve_fp32" in phases:
            before = replayed()
            match, launches, by_route = phase_serve(
                params, cfg, torch.float32, smi, report, "serve_fp32")
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
            if not all(match):
                raise AssertionError(f"fp32 paged serving disagrees with "
                                     f"dense generate on "
                                     f"{match.count(False)} requests")
            hold_captured(pa, "serve_fp32", before, report)
        if "serve_bf16" in phases:
            before = replayed()
            _, launches, by_route = phase_serve(
                params, cfg, torch.bfloat16, smi, report, "serve_bf16",
                breakdown=True)
            hold_captured(pa, "serve_bf16", before, report)
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
        for key, dtype, tree in (("serve_spec_bf16", torch.bfloat16, False),
                                 ("serve_spec_fp32", torch.float32, False),
                                 ("serve_tree", torch.bfloat16, True)):
            if key in phases:
                before = replayed()
                launches, by_route = phase_serve_spec(
                    params, cfg, dtype, smi, report, key, tree=tree)
                hold_captured(pa, key, before, report)
                kernel["launches"] += launches
                for r, n in by_route.items():
                    kernel["launches_by_route"][r] += n
        if "serve_fork" in phases:
            before = replayed()
            launches, by_route = phase_serve_fork(params, cfg, smi, report)
            hold_captured(pa, "serve_fork", before, report)
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
        for key, phase in (("serve_structured", phase_serve_structured),
                           ("serve_wq", phase_serve_wq),
                           ("serve_lora", phase_serve_lora),
                           ("serve_spill", phase_serve_spill),
                           ("serve_disagg", phase_serve_disagg),
                           ("serve_http", phase_serve_http),
                           ("serve_replay", phase_serve_replay),
                           ("serve_fleet", phase_serve_fleet)):
            if key not in phases:
                continue
            t, before = time.perf_counter(), replayed()
            launches, by_route, *int8_pool = phase(params, cfg, smi, report)
            phase_s[key] = time.perf_counter() - t
            hold_captured(pa, key, before, report)
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
            kernel["launches_int8_pool"] += sum(int8_pool)
        # freed so that the train phase's peak memory is its own
        del params
        torch.cuda.empty_cache()
    # B1-B3 launch on six paths: GPT-2 small's training on one card and
    # through the NCCL group's schedule ladder, the imported GPT-2's
    # fine-tunes (D 64, "sm90"), gpt-long's (D 48, "sm90"), the MoE
    # model's training, and the sp:8 ring folds; the counts add up, as B4's
    # do with the imported, gpt-long and MoE models' serving (gpt-long's
    # dense control adds B1 at D 48)
    for key, phase in (("train", phase_train),
                       ("gpt2_import", phase_gpt2_import),
                       ("train_long", phase_train_long),
                       ("serve_long", phase_serve_long),
                       ("serve_graph", phase_serve_graph),
                       ("train_comms", phase_train_comms),
                       ("moe", phase_moe), ("sp_fold", phase_sp_fold),
                       ("tp", phase_tp), ("pp_fold", phase_pp_fold)):
        if key not in phases:
            continue
        t, before = time.perf_counter(), sum(pa.launches_replayed.values())
        launches = phase(report, smi)
        phase_s[key] = time.perf_counter() - t
        # the tp phase serves in its ranks' processes, eager by the plan
        # (tp_serve holds that)
        if key in ("gpt2_import", "serve_long", "serve_graph", "moe"):
            hold_captured(pa, key, before, report)
        if key in ("gpt2_import", "serve_long", "serve_graph", "moe", "tp"):
            paged = launches["paged"]
            kernel["launches"] += paged["launches"]
            for r, n in paged["by_route"].items():
                kernel["launches_by_route"][r] += n
            if key == "serve_long":
                kernel.setdefault("gpt_long", {}).update(
                    launches=paged["launches"],
                    launches_by_route=paged["by_route"])
            launches = launches["flash"]
        for k in flash:
            flash[k]["launches"] += launches[k]
            if key in ("train_long", "serve_long"):
                long = flash[k].setdefault("gpt_long", {})
                long["launches"] = long.get("launches", 0) + launches[k]
            counts = flash[k]["launches_by_route"] or dict.fromkeys(
                ("sm90", "mma_sync", "f32"), 0)
            flash[k]["launches_by_route"] = {
                r: n + launches["by_route"][k][r] for r, n in counts.items()}
    if "conv" in phases:
        t = time.perf_counter()
        res = phase_conv(report)
        phase_s["conv"] = time.perf_counter() - t
        for key in conv_kernels:
            conv_kernels[key].update({k: res[key][k] for k in (
                "max_abs_err", "ms", "sum_ms", "timed_by", "plain_ms",
                "bound_ms", "bound_by", "library_ms")})
        for key in ("gn_fwd", "gn_bwd", "conv1x1", "conv3x3"):
            conv_kernels[key].update(timed_route=res[key]["timed_route"],
                                     previous_ms=res[key]["previous_ms"])
    # B5-B8 launch on four paths, the ResNet recipe's entry point over
    # the twin, its trainer over the record store, and the lenet and ddpm
    # recipes' entry points (B5/B6 only); the counts add up
    for key, phase in (("resnet_train", phase_resnet_train),
                       ("resnet_data", phase_resnet_data),
                       ("lenet", phase_lenet), ("ddpm", phase_ddpm)):
        if key not in phases:
            continue
        t = time.perf_counter()
        launches = phase(report, smi)
        phase_s[key] = time.perf_counter() - t
        for k in conv_kernels:
            conv_kernels[k]["launches"] += launches[k]
            counts = conv_kernels[k]["launches_by_route"] or dict.fromkeys(
                launches["by_route"][k], 0)
            conv_kernels[k]["launches_by_route"] = {
                r: n + launches["by_route"][k][r] for r, n in counts.items()}
        if key == "ddpm":
            # B5 and B6 timed at the UNet's GroupNorm shapes
            for k in ("gn_fwd", "gn_bwd"):
                conv_kernels[k]["unet"] = {
                    shape: res[k] for shape, res in
                    launches["gn_timing"].items()}
    # the frozen-BN import, the norm-free ResNet and VGG, and the VAE, GAN
    # and style recipes launch none
    for key, phase in (("resnet_import", phase_resnet_import),
                       ("image_models", phase_image_models),
                       ("vae_gan", phase_vae_gan), ("style", phase_style)):
        if key in phases:
            t = time.perf_counter()
            phase(report, smi)
            phase_s[key] = time.perf_counter() - t
    report["wall_s"] = time.perf_counter() - t0
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    log(smi)
    print(json.dumps({"kernels": [kernel, *flash.values(),
                                  *conv_kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
