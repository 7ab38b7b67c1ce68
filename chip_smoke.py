#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, as the chip check runs it
    python3 chip_smoke.py --only kernels --ptxas   # build + kernel checks
    python3 chip_smoke.py --only kernels,train     # the training slice
    python3 chip_smoke.py --only kernels,engine    # quantized serving
    python3 chip_smoke.py --only kernels,programs,engine,engine_prefix,engine_spec
                          # the prefix cache and speculative decoding
    python3 chip_smoke.py --only kernels,engine,engine_dense,engine_oneshot,engine_drain
                          # dense KV, one-shot prefill, drain and resume
    python3 chip_smoke.py --only engine,engine_warmup,engine_observe,engine_edge
                          # warmup, load row, metrics, spans, max_len, chaos
    python3 chip_smoke.py --only kernels,engine,engine_tp
                          # tensor-parallel serving, every shard on one card
    python3 chip_smoke.py --only kernels,engine,engine_kv
                          # the KV object tier: handoff, drain, resharding
    python3 chip_smoke.py --only kernels,train,train_ring,train_llama
                          # long context (ring) and llama3_8b on one card
    python3 chip_smoke.py --only kernels,train,train_moe,train_pipeline
                          # moe_8x350m with ep, and GPipe, on one card
    python3 chip_smoke.py --only runtime
                          # the runtime: kernels in a task, the object
                          # plane, LLMEngine(opt_1_3b) in an actor
    python3 chip_smoke.py --only serve
                          # the serve plane: LLMDeployment(opt_1_3b)
                          # replicas behind handles and the HTTP proxy,
                          # a prefill→decode split, the orphan sweep
    python3 chip_smoke.py --only serve,serve_chaos,autoscaler
                          # then zero-drop serving under a replica kill
                          # and a drain, and a GPU node autoscaled for a
                          # kernel task
    python3 chip_smoke.py --only kernels,train,train_dist
                          # gpt2_124m through TorchTrainer: world 1 on
                          # NCCL, dp = 2 and fsdp = 2 on gloo ranks
    python3 chip_smoke.py --only train,tune
                          # a Tuner job of four gpt2_124m trials on the
                          # card, through python -m ray_tpu_torch
    python3 chip_smoke.py --only kernels,train,data
                          # the data plane: TorchTrainer fed by a Dataset
                          # through iter_cuda_batches, a BatchPredictor
                          # on a pool of card actors
    python3 chip_smoke.py --only kernels,engine_gptj,train_gpt2_2_7b
                          # head dims 256 and 80: gptj_6b served at full
                          # width and depth, gpt2_2_7b trained at full
                          # width (8 of its 32 layers)
    python3 chip_smoke.py --only kernels,engine_gptj,train_gptj_6b
                          # head dim 256's backward and the prefill at page
                          # size 48: gptj_6b trained at full width and
                          # depth, and served at page size 48
    python3 chip_smoke.py --only kernels --ab OLD_CHECKOUT
                          # the kernels against an older checkout's, in
                          # turns, at the timed shapes and page sizes

Phases, one JSON line each, each with ``at_s``, the seconds since the
script began (the whole record also goes to build/chip_smoke.json):

1. card: the ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: every CUDA kernel compiled from ray_tpu_torch/ops/csrc for
   sm_90a (one nvcc per source, all started together), with the build
   seconds, and per kernel whether its SASS (cuobjdump) holds HGMMA,
   UTMALDG, LDGSTS and HMMA: every instance of the bf16 flash forward, dq
   and dkv kernels and the paged prefill kernel (28 in all) must hold
   wgmma and TMA loads, the 8 prefill instances whose producer gathers
   rows also cp.async copies (and the others none), every instance of the
   paged decode kernel (16) TMA loads, and no kernel of the library
   mma.sync.
3. kernels: each kernel against its plain PyTorch version on the card at
   OPT-1.3B attention shapes (H=32, K=64), page sizes {16, 64}, fp32 and
   bf16, at head dim 128, and at gpt2_2_7b's 32 heads of 80 and gptj_6b's
   16 of 256 (page 64, bf16, float and int8 pools; the pools drawn on the
   card from seeded generators); the ragged cases (length 1, mid-page, page
   boundary, full table, idle all-null slot; prefill C=256 and C=40 at
   ragged offsets, full and width-sliced tables) and the engine's own
   shapes (decode: 16 slots on a 2048-position table, lengths up to 2048;
   prefill: 16-row dispatches of 256, most rows inert); the decode's
   split paths (one slot at 2048, the light-load view, lengths at the
   split edges, past the table and 0, ps 8), each decode call repeated
   for identical bits; the largest error
   printed beside its bound, long rows on their own; then each kernel,
   checked once more on the inputs it is timed on, timed (device time:
   `device_ms`, with CUDA events around calls as the host issues them
   beside it) at B=16, 1024-token contexts, page size 64, bf16, beside
   its bound, its plain version's time and F.scaled_dot_product_attention
   on the gathered timeline (a yardstick only: the port never calls it;
   for prefill with a bool mask and with causal_lower_right, the faster
   is ``library_ms``), the decode also at light load (2 of 16 slots live
   at 2048) and with the wrapper's host µs per call. Then bf16 prefill
   (the wgmma kernel at every page size) at page sizes 16, 32, 64, 128,
   24, 48 and 96 (TMA boxes of gcd(ps, key tile) rows) and 20 and 4 (rows
   gathered by cp.async), at head dims 64 and 128, and 64, 24, 48, 96, 20
   and 4 at head dims 80 and 256, chunks of C = 40, 72 and 200 at ragged
   offsets, float and int8 pools.
   Both paged kernels, float and int8, are then timed at B=16, 1024-token
   contexts, ps 64 at the two new head dims (the kernels line's
   ``at_shapes``), each with a page dropped from its plain version planted
   (and the int8 programs' faults), which must fail the bound; and the
   prefill at page sizes 48 and 20 at gptj_6b's 16 heads of 256 (16
   slots, C 240 at offset 768: engine_gptj's ps-48 engine) and at
   opt_1_3b's 32 of 64 (C 256 at 768), float and int8, the same faults
   planted.
   Then the int8 programs of both paged kernels the same way, on int8
   pools quantized by the port's _quant_write from rows whose pages have
   log-uniform amplitudes in [0.25, 4] (page sizes 16 and 64, head dims
   64 and 128, fp32 and bf16 q); on their timed inputs two planted
   faults in the plain version (scales indexed by table position, a
   page dropped) must fail the bf16 bound; with bf16 q each int8 case
   is also held to the plain version on q.float() (p unrounded, as in
   the Pallas programs), a bound the plain version on bf16 q (p rounded)
   must fail on the timed inputs; timed beside their bounds, plain
   versions and SDPA on the dequantized timeline.
   Then the four flash kernels (flash_fwd, flash_delta, flash_dq,
   flash_dkv), each against its plain version (flash_delta with and
   without the lse cotangent, on a strided dO and, in bf16, on the
   forward's fp32 o): fp32 and bf16, head dims 64, 80, 128 and
   256 (dq and dkv must raise a ValueError naming head dim 96 and the
   ROADMAP item), causal and non-causal, S=77/T=130, S=64/T=256, S=200/T=333, S=T=192,
   S=1/T=64 and S=130/T=1, in bf16 also on q, k, v as strided views of
   packed qkv tensors, the backward with an lse cotangent; then once more
   on the training step's own inputs ([8, 1024, 12, 64] bf16 causal),
   where a dropped 64-wide tile planted in the plain dq, dk and dv, and
   a dropped dlse or the last 16 columns left out of the plain delta,
   must fail their bounds, then timed by device time beside each
   kernel's bound,
   its plain version and its library call: SDPA for the forward; for
   the backward the faster of aten's flash backward
   (`_scaled_dot_product_flash_attention_backward`) and the backward of
   SDPA's graph, each alone and held once to the plain versions, on the
   flash_dq row beside delta + dq + dkv (one call does all three);
   SDPA forward plus backward against the kernels; the four at gptj_6b's
   [2, 1024, 16, 256] causal (delta on the fp32 o), with the same faults
   planted.
   Then the speculative path's shapes: the prefill kernel as the verify
   pass (16 rows of C = 5 and C = 2 at ragged decode cursors, with inert
   rows, on the decode table's width; bf16 q, float and int8 pools) and
   both paged kernels at a draft's 12 heads of 64 (gpt2_124m), held to
   the same bounds; timed: the verify pass at 16 slots of 1024 positions
   (C = 5) beside its bound, its plain version, SDPA and (k+1) x the
   decode call at the same slots, and the decode at 12 heads.
   Then both paged kernels, bf16 and int8, at the heads of a tp shard
   (16 and 8 of opt_1_3b's 32, 6 of the draft's 12: a partial decode
   head group): the engine view, light load and the split edges of
   each head count's grid, prefill at C = 256 and 5; and both float
   kernels timed at 16 heads as above (the kernels line's ``tp_shard``).
4. programs: prefill_chunk_paged, decode_step_paged, verify_chunk_paged
   (the LM head at every row) and spec_draft_propose (the model as its
   own draft, temperature 1, one generator seed: its log-probability
   rows up to each row's first differing proposal) at full opt_1_3b
   width (bf16, random weights from a seed), attn_impl "kernel" vs
   "gather" on copies of one pool; then the same with int8 weights
   (quantized from the same fp32 masters) on an int8 pool, held to a
   logit-MAE limit that a planted fault must exceed, with the int8
   weights' logits against the bf16 weights' as a fidelity reading.
   Then programs_prefix: a 900-token prompt prefilled cold in [16, 160]
   dispatches, its first 800 positions bound into another table (12
   shared pages and a copy_pages of page 12 onto a recycled page) and
   prefilled from 800: the last-token logits equal the cold run's within
   the fp32 bound, float and int8 pools; a copy without the scale planes
   must exceed it 100-fold on the int8 pool (the factor is printed).
   Then programs_oneshot: 8 seeded prompts of 257-511 tokens at bucket
   512 through prefill_batch (dense), prefill_batch_paged (float pool)
   and prefill_chunk_paged (kernel, chunk 256), and decode_step (dense)
   against decode_step_paged (kernel) on each pool at the next position,
   held to the programs' logit-MAE limit; the same with int8 weights and
   int8 pools (one-shot against chunked); a one-shot write with each
   row's first page on the null page must exceed the limit.
5. profile (opt_1_3b cut to its first 8 layers, CUT_DEPTH, full width):
   torch.profiler over one fused decode window and one prefill
   dispatch at the engine's shapes (device busy time, idle share, top
   ops); the decode window's device time with int8 against bf16 weights
   (float and int8 KV), and the window's K/V writes alone into each pool;
   the dense engine's fused window at the same slots and positions (a
   [16, 2048] dense cache), with the count of whole-cache copies one
   dense decode step makes.
6. engine: LLMEngine(opt_1_3b, bf16) serving 16 seeded prompts of 128-1536
   tokens (queued, then start()), 32 greedy tokens each, with the
   kernel launch counters zeroed just before and read just after; then
   LLMEngine(opt_1_3b, weight_dtype="int8", kv_dtype="int8") from the
   fp32 masters on the same prompts: n_layers int8 launches per decode
   step and per prefill dispatch, no float paged launch, the
   kv_pool_bytes identity, weight bytes, and the share of each stream
   that agrees with the bf16 engine's.
   engine_prefix: LLMEngine(opt_1_3b cut to its first 8 layers,
   CUT_DEPTH, full width, prefix_cache=True), chunk 160, 512
   pages, 16 prompts of a shared 900-token system prompt and seeded
   suffixes of 64-512, 32 greedy tokens each, twice on one engine: cold,
   then warm (>= 15 hits, a copy-on-write, fewer prefill tokens), the
   accounting closed with cached pages; warm and cold TTFT, agreement.
   engine_spec: the engine phase's prompts with spec_k 4, (a) a
   gpt2_124m draft at temperature 0.8, (b) the target as its own draft,
   greedy (acceptance >= 0.9); the exact launch counts of both kernels,
   acceptance by draft position, tokens per tick, decode step p50/p95.
   engine_dense: LLMEngine(opt_1_3b, kv_mode="dense", prefill_chunk=0,
   buckets 256-1536), the engine phase's traffic: no paged kernel
   launch, TTFT, decode step, tok/s, the cache's bytes, and the share of
   each stream that agrees with the chunked paged engine's.
   engine_oneshot: the same traffic on the one-shot paged kernel engine,
   bf16 and then int8 weights and KV: exactly n_layers decode launches
   per decode step of its own dtype, no prefill kernel launch, the
   accounting closed.
   engine_drain (opt_1_3b cut to its first 8 layers, CUT_DEPTH, full
   width): the dense engine, then the chunked paged kernel engine:
   16 prompts cut to 1,024 tokens, 64 tokens each, drain(0.0) two ticks
   after half the streams have started, every continuation resumed on a
   fresh engine of the same mode
   (each resumed stream carries exactly the missing tokens, none
   re-emitted; accounting closed on both engines), with the agreement
   of the resumed streams with an uninterrupted run.
   engine_warmup: two fresh child processes of this script
   (``--warmup-child on|off``, run before this process holds the
   engine's pools; they load the library this process built) boot the
   engine phase's chunked kernel engine with warmup=True and with
   warmup=False and serve its first prompt alone: the warmup's wall,
   each dispatch's wall to a synchronize, its launches (gate: 6 widths x
   2 heads = 12 dispatches, n_layers prefill launches each), the first
   request's TTFT and first decode window, and whether the two streams
   agree; then warmup_compile on a float and an int8 pool filled with
   seeded values (gate: every plane outside the null page bitwise
   unchanged), beside this process's library build time.
   engine_observe (cut to the first CUT_DEPTH layers, full width): the
   engine phase's traffic through start() with a
   poller calling load_snapshot() every 50 ms (gate: every snapshot's
   llm_* gauges equal its fields), each finished request's metrics
   observed as a front end does; gates on the Prometheus text (decode
   step count = decode windows, one TTFT sample per request) and the
   per-width dispatch counter (sum = prefill dispatches), and on the
   span ring (ceil(windows / 64) llm.decode_window spans, the first
   request's llm.ttft tree of three children); readings: the load
   series, the hooks' host µs per window, decode step and TTFT. Then a
   drain under load: the same traffic, drain(0.0) with the engine
   thread running once half the streams started, the continuations
   resumed on a fresh engine (each with exactly its missing tokens).
   engine_edge: paged one-shot and chunked kernel engines (opt_1_3b cut
   to its first 8 layers, CUT_DEPTH, full width) at max_len
   256 (a multiple of the page), 2 slots: a request runs into max_len
   beside a short one and must finish truncated after 157 tokens with
   no error and the pages balanced; then a chaos "raise" rule at
   llm.decode_window must end every request with the engine-death
   error, and a later submit must raise.
   engine_tp: tensor-parallel serving with every shard on cuda:0 (the
   shards run in turn: no tp speed-up can show on one card), the engine
   phase's configuration cut to opt_1_3b's first 8 layers (CUT_DEPTH; the
   full width, 32 heads, d 2048: a depth cut that makes room for the
   serve phase): tp=2 on its 16 prompts against a tp=1 engine;
   then on 8 of them tp=4, tp=2 with int8 weights and KV (against a
   tp=1 int8 engine), tp=2 with spec_k 4 and the gpt2_124m draft (6
   heads per shard), and a tp=2 drain(0.0) resumed on a tp=1 engine.
   Gates: exactly n_layers x tp launches of each program per decode step
   and per chunk dispatch (the speculative counts x tp), every request's
   first-token logits within TP_LOGIT_MAE (mean |difference|) of the
   tp=1 engine's, which a planted fault (shard 1's attention partial
   dropped in layer 0) must exceed, the int8 scale planes bitwise equal
   across shards, exact resumes, kv_heads_per_shard = 32 / tp,
   pool_shard_bytes = a shard's own bytes, no request error, pages
   balanced. Readings: greedy agreement with tp=1, decode step p50, and
   one fused window's device time and idle share at tp=2 beside tp=1.
   engine_kv: the KV object tier on the engine phase's configuration
   cut to opt_1_3b's first 8 layers (CUT_DEPTH, full width), through
   the process-global store (reset between parts): (a) a
   pool_role="prefill" engine serves 8 of the prompts, each leaving at
   its first token with its pages donated, and a fresh pool_role="decode"
   engine resumes each (prompt, [first token], kv) for 24 tokens in all;
   (b) a kv_transfer=True engine drained with drain(0.0) mid-decode, every
   continuation resumed with its kv on a decode-role engine; (c) (a) with
   kv_dtype="int8" on 4 prompts; (d) one request handed off from tp=2 to
   tp=1 and one from tp=1 to tp=2 (shards on cuda:0). Gates: every
   request with a full chunk adopts all of its full chunks with no
   adoption failure; after each bind the adopted pages gathered back
   from the pool equal the donated payload bit for bit, every plane (the
   int8 scale planes too); the adopter prefills each request's cold tail
   alone; exactly n_layers x tp launches of the path's programs per
   decode step and per chunk dispatch; exact resumes; no request error;
   accounting closed on every engine with no page in flight. Readings:
   the decode engine's TTFT with adoption against the same continuations
   re-prefilled, the payload's host round trip (gather + .cpu(); stitch
   + .to(device) + scatter) in ms and GB/s, the drain's agreement with an
   uninterrupted run, the phase's seconds and the card's name and power.
   engine_gptj: LLMEngine(gptj_6b) at full width (d 4096, 16 heads of
   256, bf16, random weights drawn in bf16 from seed 0) cut to the first
   CUT_DEPTH of its 28 layers, with the engine phase's knobs and traffic
   (16 prompts of 128-1536 tokens from seed 3, 32 greedy tokens each) on
   the paged kernels, then on attn_impl="gather" over the same weights:
   8 decode launches per decode step and 8 prefill launches per
   dispatch, no plain call and
   no int8 program, pages closed; every stream equal to the gather
   engine's or leaving it where the gather engine's logits of the two
   tokens are within 0.1 (a bf16 near-tie), which a planted wrong token
   must exceed; TTFT, decode step, tok/s, weight and pool bytes. Then
   the same layers at page size 48, chunk 240, budget 480
   (GPTJ_PS48_KNOBS: every prefill
   dispatch on the wgmma kernel in 16-row TMA boxes, 8 launches each,
   every decode step on the decode kernel at ps 48) on the first 8
   prompts, held to the same gates against a gather engine of the same
   cut and knobs.
   runtime: the port's runtime (ray_tpu_torch.init(num_cpus=4,
   resources={"GPU": 1}) starts a GCS, a raylet and worker processes;
   the init wall and whether the store's native arena loaded, which it
   must): (a) a num_gpus=1 task runs both float paged kernels on seeded
   engine-shaped inputs (decode: 16 slots of 1-2048 positions; prefill:
   16 rows of C = 256) and returns their CUDA outputs, which reach this
   process as CPU tensors bitwise equal to the same calls here, with the
   worker's launch counters above 0; (b) a bf16 CPU tensor of engine_kv's
   payload size at full depth (956 MB) is put and read back here and by
   a task on a worker, bitwise both, out-of-band (the pickle stream under 64 KB),
   with put and get GB/s, and a second put of the same bytes after the
   first is freed (into the pages the first put faulted in); (c) LLMEngine(opt_1_3b) from seed 0 on cuda in
   the __init__ of a num_gpus=1 actor, every knob from
   init(_system_config=...) (the engine phase's paged kernel engine and
   llm_tp = 3), serves the engine phase's 16 prompts, 32 greedy tokens
   each: the streams equal the in-process engine's (run first under
   --only runtime), exactly n_layers (24) decode launches per decode
   step and prefill launches inside the actor, llm_tp soft-disabled to 1
   with its reason in the worker's log, the request metrics' replica tag
   the actor id's last 8 hex digits, pages closed; readings: the actor's
   creation wall (spawn, torch import, CUDA context, weights) and the
   free memory it starts with, the round's wall and TTFT p50/p95 beside
   the in-process engine's, an empty method's round trip; (d) kill: a
   later call raises ActorDiedError and the card's free memory comes
   back within 1 GB of what the actor held; then shutdown. The phase
   runs before the training phases.
   serve: the serve plane on the port's runtime (init(num_cpus=8,
   resources={"GPU": 1}, serve_kv_sweep_interval_s 2)): (a)
   LLMDeployment("opt_1_3b", the engine phase's knobs, warmup=True), 2
   replicas at num_gpus=0.5 on the card behind start_proxy(): the
   engine phase's last 8 prompts as SSE posts arriving in turn (each
   once the one before has its first token), then its first 8 as
   concurrent handle streams, 32 greedy tokens each, the launch counters
   of every replica zeroed just before and read just after (24 decode
   launches per decode step and per prefill dispatch in each, both
   replicas served), no request error, every SSE first token before
   half its stream, pages closed; TTFT by route beside the in-process
   engine's, the boot wall, memory per replica, back within 1 GB after
   the delete; (b) kvp (pool_role prefill, pool_peer kvd) and kvd
   (decode), one replica each at num_gpus=0.5: engine_kv's 8 prompts (7
   with a full chunk) by SSE, 24 tokens: 7 adoptions, none failed, the
   decode replica prefilling the cold tails alone, pages closed on both;
   every page set of the cluster store's index, fetched here, bitwise an
   in-process prefill engine's donation of the same prompts, and a page
   set with one page's K plane rolled must differ; the decode leg alone
   (prompt and first token to kvd) adopted against re-prefilled, its
   TTFT; the payloads' get and put GB/s here; (c) the orphan sweep:
   SIGKILL of the kvp replica, its index entries gone within 3 sweep
   intervals, the node store's bytes down. Streams (a) and (b) equal the
   engine phase's, or leave them only where the in-process logits of
   the two tokens are within SERVE_TIE_MARGIN (a bf16 near-tie: a
   replica batches other requests than the engine phase did), which a
   planted wrong token must exceed. Every part runs; the phase fails
   after its line if a gate did.
   serve_chaos: on the serve phase's cluster (serve_drain_timeout_s
   2.0), bench_chaos_torch.run_scenario: opt_1_3b bf16 from seed 0 cut
   to its first CUT_DEPTH layers (full width) saved once as the
   checkpoint the in-process baseline and 3 replicas (num_gpus 1/3, the
   engine phase's knobs, warmed) load, the replicas booting while the
   baseline runs; 32 SSE streams of 128-512-token prompts (seed 0), 32
   greedy tokens; the first replica's
   llm.decode_window kill rule armed 0.6 s into the burst and the
   scale-down to 2 right after. Fails unless 0 streams drop, 32 complete
   with exactly 32 tokens, 2 replicas are live and 0 draining after, a
   stream failed over (serve_failovers_total), the drained replica held
   a live stream when the scale-down began, every replica that served
   the burst and survived launched both paged kernels, n_layers per
   decode step and per prefill dispatch, with its pages closed, and
   every stream equals the baseline's or leaves it at a near-tie
   (SERVE_TIE_MARGIN). Readings: failover gaps p50/p95/max, the kill and
   drain times, the burst's wall, the departures. Alone:
   --only serve_chaos (it boots the cluster itself).
   autoscaler: a head of 2 CPUs and no GPU (ClusterUp from a written
   YAML, or init(num_cpus=2) and a StandardAutoscaler without pyyaml)
   over a LocalSubprocessProvider with one node type {"CPU": 2,
   "GPU": 1} (0-1 workers, idle 10 s, a pass a second); a num_gpus=1
   task that the head cannot place runs the decode kernel at the
   engine's shapes on the launched node. Fails unless exactly one node
   launches, the task ran there, its output holds to the plain version
   within the bf16 bound with its launch counted, the node is
   terminated 10-30 s after going idle and none of its processes is
   left. Readings: seconds from submission to the node registered and
   to the result, from idle to terminated. When a one-card training
   phase runs too, the part runs beside them in a child process of this
   script (--autoscaler-child; its own cluster), since most of it is
   waiting.
7. train: build_training(gpt2_124m(max_seq=1024, remat=True,
   attn_impl="flash"), adamw(3e-4, weight_decay=0.1, mu_dtype=bf16))
   with seeded random weights and a seeded [8, 1024] batch: one step of
   "flash" against "xla" (plain attention) from the same parameters
   (the loss, the whole gradient and each layer's attention weights'
   gradients beside their tolerances; three planted faults in the flash
   backward must fail the same check), then a warm-up step and 12 timed
   steps with the flash launch counters zeroed just before and read just
   after (exactly 24 forward, 12 delta, 12 dq and 12 dkv launches per
   step: remat recomputes each block's forward), step time, tokens/s, MFU, the steps'
   peak memory and the losses; then torch.profiler over one step.
   train_ring: the flash kernels checked and timed at the ring's chunk
   shapes ([2, 1024, 12, 64] bf16, the diagonal causal and the full
   non-causal chunk); then build_training(gpt2_124m(max_seq=4096,
   remat=True, attn_impl="ring") cut to its first 8 of 12 layers
   (CUT_DEPTH, full width), the same adamw, mesh=make_sp_mesh(4) with
   every shard on the card) on a seeded [2, 4096] batch: one step of
   "ring" against "xla" from the same parameters under the train phase's
   three limits, which a dropped rotation planted in the ring's combine
   must fail (its attention weights' gradients past 5e-2; its loss
   difference is printed); then a warm-up and 4 timed
   steps with exactly 160 forward, 80 delta, 80 dq and 80 dkv launches
   per step
   (8 layers x (4 diagonal + 6 full chunks), the forward twice under
   remat); step time, tokens/s, MFU, peak memory, one profiled step, and
   the same step with attn_impl="flash" unsharded beside it.
   train_llama: the flash kernels checked and timed at [1, 4096, 32,
   128] bf16 causal; the port's memory audit of llama3_8b (bf16 masters
   and gradients, adafactor) on "h100" printed and gated on fits, with
   the card's total memory beside HBM_BYTES["h100"] (they must be equal);
   then build_training(llama3_8b(max_seq=4096, attn_impl="flash",
   param_dtype=bf16), adafactor(3e-4), model=llama,
   stochastic_round=True) from seed 0 (full width and depth: 32 layers,
   d 4096, 32 heads over 8 kv heads of 128, d_ff 14336, vocab 128256) on
   a seeded [1, 4096] batch: the loss with flash against plain attention
   within 1e-2, which a tiled GQA repeat planted in the plain path must
   exceed; 4 steps (one warm-up) with exactly 64 forward, 32 delta, 32 dq
   and 32 dkv launches per step, every parameter still bf16, the loss finite
   and falling; peak memory beside the audit, step time, tokens/s, MFU,
   one profiled step and the optimizer's device time against it.
   train_gpt2_2_7b: the flash kernels checked and timed at [8, 1024, 32,
   80] bf16 causal; the port's memory audit of the cut model (bf16
   masters and gradients, adafactor, B 8) on "h100", gated on fits; then
   build_training(gpt2_2_7b(max_seq=1024, attn_impl="flash",
   param_dtype=bf16) cut to its first 8 of 32 layers (CUT_DEPTH; full
   width: d 2560, 32 heads of 80, d_ff 10240, vocab 50304 untied, remat),
   adafactor(3e-4), stochastic_round=True) from seed 0 (bench.py's
   BENCH_MODEL=gpt2_2_7b BENCH_OPT=adafactor_sr step) on a seeded [8,
   1024] batch: one step of "flash" against "xla" under the train
   phase's three limits, which its three planted backward faults must
   fail; 4 steps (one warm-up) with exactly 16 forward, 8 delta, 8 dq and
   8 dkv launches per step and no plain call,
   every parameter still bf16, the loss falling; step p50, tokens/s,
   MFU, peak memory of the steps beside the audit (and of the check
   before them), one profiled step (idle share).
   train_gptj_6b: the same (`train_sr`) for bench.py's
   BENCH_MODEL=gptj_6b BENCH_OPT=adafactor_sr step: the flash kernels
   checked and timed at [8, 1024, 16, 256] bf16 causal, then gptj_6b at
   full width cut to its first 8 of 28 layers (CUT_DEPTH;
   d 4096, 16 heads of 256, rotary 64, d_ff 16384, vocab 50304 untied,
   remat), S 1024, B 8, bf16 SR masters, adafactor(3e-4), from seed 0:
   the audit, flash against xla with the three planted faults, 4 steps
   with exactly 16 forward, 8 delta, 8 dq and 8 dkv launches per step
   and no plain call, every parameter bf16, the
   loss falling; the same readings.
   train_moe: the flash kernels checked and timed at [8, 1024, 16, 64]
   bf16 causal; then build_training(moe_8x350m(max_seq=1024,
   attn_impl="flash"), the train phase's adamw, model=moe_gpt) from seed
   0 (full width and depth: 24 layers, d 1024, 16 heads of 64, 8 experts
   of d_ff 4096, capacity factor 1.5, vocab 50304, remat) on a seeded
   [8, 1024] batch: layer 0's gates (G 8192, E 8) through _top2_dispatch
   on the card and on the host, bitwise equal, at C 3072 and at factor
   0.5 (C 1024, tokens dropped); moe_mlp in fp32 on layer 0's experts
   and a seeded [1, 512, 1024] input against a plain top-2 loop within
   1e-4 relative, which the second expert's combine weight zeroed must
   exceed; one step of "flash" against "xla" with the plain run routed
   as the flash run routes, under the train phase's loss and attention
   limits and 3e-2 on the whole gradient (24 layers), which a zeroed dq
   must fail; the loss with the expert stacks placed on an ep = 4
   mesh (every shard on the card), routed as ep = 1 routes, within 1e-3
   of ep = 1's, which a dropped shard partial must exceed; the held
   steps again with fp32 activations and gradients, flash against plain
   and ep = 4 against ep = 1, within 1e-3 on the whole gradient (and on
   each layer's expert stacks for ep), which a zeroed dq and a dropped
   shard must exceed; 4 steps (one warm-up) with exactly
   48 forward, 24 delta, 24 dq and 24 dkv launches per step, the loss
   falling;
   step time, tokens/s, MFU on the active parameters, peak memory, one
   profiled step, and the routing's device time (the dispatch
   construction and the two routing einsums, forward, recompute and
   backward, per call by device_ms) and FLOPs beside it.
   train_pipeline: the flash kernels checked and timed at [1, 1024, 12,
   64] bf16 causal (one microbatch); then build_pipeline_training(
   gpt2_124m(max_seq=1024, remat=True, attn_impl="flash") cut to its
   first 8 of 12 layers (CUT_DEPTH, full width), the same adamw, mesh of
   pp = 4 with every stage on the card, 8 microbatches of 1) on the train
   phase's batch: the pipeline's loss and gradients against the
   sequential step's on the same parameters under the train
   phase's three limits, which an off-by-one schedule (each later stage
   takes the previous microbatch's activation) must exceed; 4 steps with
   exactly 128 forward, 64 delta, 64 dq and 64 dkv launches per step, the
   loss
   falling; step time beside the train phase's, peak memory, one
   profiled step (pp on one card buys nothing: the stages run in turn).
   train_dist: the flash kernels checked and timed at a dp rank's [4,
   1024, 12, 64], a tp rank's [8, 1024, 6, 64] and a hybrid rank's [4,
   1024, 6, 64] bf16 causal; the single-controller references from seed
   0 on the train phase's batch (the first step's gradients, then 5
   steps' losses under the adamw and under adafactor(3e-4)); then
   TorchTrainer(train_dist_loop) on the port's runtime (init(num_cpus=4,
   resources={"GPU": 1})): world 1 on NCCL (ScalingConfig(num_workers=1,
   use_gpu=True), the default backend), every step's loss within 5e-4 of
   the reference and whether losses and parameters are bitwise equal to
   it printed; then two ranks at num_gpus=0.5 on gloo with CUDA tensors
   (NCCL takes no two ranks on one card; every collective staged through
   host memory, the copies counted): dp = 2 (4 rows each), both ranks'
   parameters bitwise identical (sha256), which a rank that keeps its
   own gradient must break; fsdp = 2 (each layer's embed halves gathered
   inside its checkpointed call), which a reduce-scatter keeping the
   local gradient must fail, its peak memory beside the same step with
   the whole tree gathered before the loss (the earlier design); tp = 2
   (megatron: 6 heads and half the MLP and vocabulary a rank), which a
   tp copy keeping its own gradient must fail; fsdp = 2 under
   adafactor(3e-4) against the single-controller adafactor; then four
   ranks at num_gpus=0.25: fsdp 2 x tp 2 (w_up cut in two dimensions).
   In every topology and rank: the losses within 5e-4 of the reference,
   the first step's gradients gathered whole within 2e-2 of the
   reference's, 24/12/12/12 flash launches per step, each rank's
   parameter and moment bytes equal to what tree_to_shardings assigns it
   (adamw), step p50, the device's idle share (one profiled step; world
   1 and dp), collective bytes per step and the host copies,
   peak memory per rank and worker boot printed. A tp rank's losses are
   held to the single controller's loss on the rank's own parameters
   gathered whole at each step (its partial sums round elsewhere than
   one controller's products: an equally exact bf16 run that five Adam
   steps carry past 5e-4 from the reference run's losses, which are
   printed beside the same drift between flash and plain attention).
   tune: the slice's path as a user takes it, all through ``python -m
   ray_tpu_torch``: ``start --head --num-cpus 8 --resources '{"GPU":
   1}'`` with the dashboard, ``status``, then ``job submit --wait`` of
   this script under ``--tune-driver`` (the spec in build/tune): the job
   attaches through its environment and runs a Tuner of 4 trials
   (``tune_trial``: the train phase's step at lr 1e-4, 3e-4, 1e-3 and
   3e-3, ``resources_per_trial={"CPU": 1, "GPU": 0.25}``, all on the
   card at once) under ASHA (max_t 8, grace 2, factor 2), then a planted
   trial alone (lr 3e-4 on the batch shifted by one token, 2 steps);
   the dashboard's cluster status, jobs and actors read while it runs;
   then ``job status``, ``job logs``, ``list jobs`` and the dashboard's
   job routes, which must agree (SUCCEEDED, the same logs), and
   ``stop``, after which the head has exited 0 and left no record and
   no arena. Gates: every trial on ``cuda:0`` at 24/12/12/12 flash launches
   a step with no call of a plain version; the lr 3e-4 trial's losses
   bitwise the train phase's first ones, the planted trial's not; ASHA
   stopped a trial before max_t and the best ran to it. Per-trial boot
   (fit to the first report), step p50 with four sharing the card beside
   the train phase's alone, peak memory, the job's and the phase's wall
   printed.
   data: one port cluster (``init(num_cpus=4, resources={"GPU": 1})``)
   for (a) and (b). (a) TorchTrainer (world 1, NCCL) with
   ``datasets={"train": ds}``: a seeded int32 token matrix [48, 1025]
   (vocab 50,257) through ``from_numpy`` in 8 blocks, ``map_batches``
   cutting tokens and targets, ``random_shuffle(seed=0)``; the rank
   reads its shard through ``iter_cuda_batches(batch_size=8,
   dtype=torch.int64, prefetch=2)`` and takes the train phase's steps
   from seed 0 (6 steps). Gates: each step's batch digest is that of
   the batch this process's ``ds.iter_batches(batch_size=8)`` yields in
   the same order; every tensor on ``cuda:0`` as int64, each column
   copied from a pinned buffer; each loss bitwise a single-controller
   loop here over those batches from the same parameters, which the
   same dataset shuffled with seed 1 must fail; 24/12/12/12 flash launches
   a step and no plain call. (b) ``BatchPredictor`` of ``GPTScorer``
   (gpt2_124m on the card, flash, from ``Checkpoint.from_params`` of the
   seed-0 parameters; each row's mean next-token log-likelihood under
   ``inference_mode``) over the unshuffled rows in blocks of 16,
   ``batch_size=8``, on ``ActorPoolStrategy(1, 2, resources={"GPU":
   0.5})``. Gates: every score bitwise the same forward here on the same
   batches; each actor built the model once; 12/0/0/0 flash launches a
   batch and no plain call, read from the rows each actor's ``apply``
   returns. The rank's boot, the step p50 beside the train phase's, the
   feeder's wait per batch and H2D GB/s (the copies' device time), the
   actors' boot, rows/s and the device ms per batch printed.
8. with --ab OLD_CHECKOUT: the flash forward, delta, dq and dkv (the
   backward at the training shapes of head dims 64, 80 and 256 and at
   S = T = 1,000 at 256, beside the library backward, each gradient
   compared bit for bit) and the float and int8 paged prefill and decode
   (timed shape and light load, with the wrapper's host µs) against an
   older checkout's kernels, in turns.
9. the kernels line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failure raises: the script exits non-zero without the last line.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import glob
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import types
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch.air import Predictor
from ray_tpu_torch import profiling
from ray_tpu_torch import tracing
from ray_tpu_torch.models import decode as dec
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models import paged_kv as pk
from ray_tpu_torch.models import partition
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve import kv_objects as tkvo
from ray_tpu_torch.serve import llm as serve_llm
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.models import moe_gpt
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel import ring as tring
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.mesh import batch_sharding, device_mesh
from ray_tpu_torch.parallel.pipeline import split_microbatch_count
from ray_tpu_torch.parallel.ring import make_sp_mesh
from ray_tpu_torch.train import memory_audit
from ray_tpu_torch.train.low_precision import sr_apply_updates
from ray_tpu_torch.train.optim import adafactor, adamw, apply_updates
from ray_tpu_torch.train.spmd import (Fp32Leaves, build_pipeline_training,
                                      build_training, make_train_step)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
H, K = 32, 64                  # opt_1_3b attention shape
# The two configurations of head dims 80 and 256: gpt2_2_7b's 32 heads of
# 80 and gptj_6b's 16 of 256 (heads, head dim).
HEADS_2_7B, HEADS_GPTJ = (32, 80), (16, 256)
DRAFT_H = 12                   # gpt2_124m's heads (of 64): the spec draft
# Heads per shard of the tp engines: opt_1_3b at tp=2 and tp=4, the draft
# at tp=2.
TP_SHARD_HEADS = (H // 2, H // 4, DRAFT_H // 2)
SPEC_K = 4                     # proposals per slot per speculative tick
CAP = 2048                     # the engine phase's max_len: longest context
LONG_ROW = 1024                # attended positions from which a row is long
# fp32: reassociation of fp32 sums only.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: a bound from the rounding both sides do (unit roundoff u = 2^-8).
# Each rounds every probability to bf16 before the P.V product (relative
# error <= u each, the kernel against a running maximum, the plain
# version after normalizing) and rounds its output once. Per output
# element, with S = sum_t p_t |v_t| (the attention of |V|, fp32):
#   |out - ref| <= 2u S + 2u |ref| + (fp32 terms, ~1e-5 S),
# so BF16_REL = 8e-3 > 2u = 7.8125e-3 bounds every sound run. A dropped or
# doubled key tile, or a wrong page, moves a long row by the weight of the
# keys it touches, not by the rounding of all of them.
BF16_REL = 8e-3
TOLERANCE = {
    "float32": "|out - ref| <= 1e-5 + 1e-5 |ref|",
    "bfloat16": "|out - ref| <= 8e-3 (|ref| + S), S = attention of |V| "
                "(fp32) at the same element",
    "int8 pools": "the same two bounds, V dequantized in S; with bf16 q "
                  "only the plain version rounds p (the int8 programs, as "
                  "the Pallas ones, do not), which the bound's u S covers",
    "int8 pools, bf16 q, p unrounded": "against the plain version on "
                  "q.float(): |out - ref32| <= half a bf16 ulp of out + "
                  "4e-5 S; the plain version on bf16 q (p rounded) must "
                  "fail it on the timed inputs",
}
# bf16 q on an int8 pool: the int8 programs, as the Pallas ones, do not
# round p, so they are held as well to the plain version run on q.float()
# (p unrounded, fp32 output). Between the two lie the kernel's rounding of
# its output to bf16 (at most half a bf16 ulp of the output) and its
# hi + lo split of p·vs (<= 2^-16 per term: <= 1.6e-5 S), plus fp32
# reassociation: |out - ref32| <= half_ulp(out) + 4e-5 S. Rounding p to
# bf16 (u per term), as the plain version on bf16 q does and as a kernel
# with one bf16 P·V product would, moves a row by up to u S.
P_UNROUNDED_S = 4e-5
PROGRAM_LOGIT_MAE = 2e-2       # kernel vs gather programs, bf16, 24 layers
PROGRAM_INT8_LOGIT_MAE = 2e-2  # the same with int8 weights and KV

RECORD: dict = {"phases": []}
RECORD_PATH = "build/chip_smoke.json"
T_START = time.perf_counter()


def emit(obj: dict) -> None:
    obj["at_s"] = time.perf_counter() - T_START
    RECORD["phases"].append(obj)
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


SPIN_CYCLES_PER_S = 2.0e9   # at most the H100's SM clock: spins no shorter


def device_ms(fn, iters=30) -> float:
    """Device time of one call of fn: CUDA events around ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts the
    host's enqueueing of them all, so the device runs them back to back
    and the wrapper's host time does not count (it is of the order of a
    decode or flash-forward kernel's). The spin doubles until the end
    event of the spin is still pending when the last call is enqueued.
    Not torch.profiler's kernel sums: on the H100 they read some whole
    phases at 0.6x and single windows at 0.5x the same kernel's time."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.perf_counter() - t) / 3 + 1e-3
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        spun = not t0.query()
        torch.cuda.synchronize()
        if spun:
            return t0.elapsed_time(t1) / iters
        spin_s *= 2
    raise AssertionError("the host never enqueued the calls within the spin")


def kernel_ms(fn):
    """A kernel's time per call: its device time (``ms``, `device_ms`),
    and CUDA events around 30 calls as the host issues them
    (``ms_events``), which for a kernel of tens of microseconds read the
    wrapper's launch rate instead."""
    return device_ms(fn), cuda_time_ms(fn)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------- build

# The kernels that must be Hopper kernels: wgmma (HGMMA in the SASS) on
# tiles brought in by TMA (UTMALDG); the paged prefill's producer also
# gathers rows by cp.async (LDGSTS) at page sizes no TMA box fits; and the
# paged decode kernel, fed by TMA tensor loads as well (cuobjdump's
# UTMALDG; the non-tensor bulk copy it tried first is UBLKCP on the H100
# with CUDA 12.8). No kernel of the library runs mma.sync (HMMA).
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "paged_prefill_wgmma_kernel",
                 "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel")
# The prefill instances whose producer gathers (its last template
# argument, GATHER).
GATHER_KERNEL = re.compile(r"paged_prefill_wgmma_kernel<\d+,\w+,true>")
TMA_KERNELS = ("paged_decode_kernel",)
# {fp32, bf16} pools and int8 with {fp32, bf16} q, K 64/80/128/256
TMA_INSTANCES = 16
# flash forward, dq and dkv at K 64/80/128/256, prefill at those x {float,
# int8} x {TMA boxes, gathered rows}
WGMMA_INSTANCES = 28
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA")
_MANGLED_ARGS = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16",
                 "Lb0E": "false", "Lb1E": "true"}


def kernel_name(sym: str) -> str:
    """A mangled kernel symbol → its name and template arguments, e.g.
    ``paged_prefill_wgmma_kernel<64,true>`` (the last name of the nested
    name, then the ints, bools and element types of its arguments)."""
    s, i, name = sym.removeprefix("_ZN"), 0, sym
    while (m := re.match(r"\d+", s[i:])):
        i += len(m.group())
        name, i = s[i:i + int(m.group())], i + int(m.group())
    end = s.find("EEv", i)
    if not s[i:].startswith("I") or end < 0:
        return name
    args = [_MANGLED_ARGS.get(t.group(), t.group()[2:-1]) for t in re.finditer(
        r"L[ib]\d+E|13__nv_bfloat16|[fa]", s[i + 1:end + 1])]
    return f"{name}<{','.join(args)}>"


def sass_ops(lib_path) -> dict:
    """Per kernel of the built library, which of SASS_OPS its SASS holds
    (``cuobjdump -sass``, beside nvcc). Raises unless every instance of
    WGMMA_KERNELS holds HGMMA and UTMALDG (and LDGSTS where it matches
    GATHER_KERNEL, only there), every one of the TMA_INSTANCES instances
    of TMA_KERNELS holds UTMALDG, and no kernel holds HMMA."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops: dict = {}
    for chunk in sass.split("Function : ")[1:]:
        sym, _, body = chunk.partition("\n")
        ops.setdefault(kernel_name(sym.split()[0]), set()).update(
            op for op in SASS_OPS if op in body)
    ops = {fn: sorted(v) for fn, v in sorted(ops.items())}
    hopper = {fn: v for fn, v in ops.items()
              if fn.split("<")[0] in WGMMA_KERNELS}
    want = lambda fn: (["HGMMA", "LDGSTS", "UTMALDG"]
                       if GATHER_KERNEL.fullmatch(fn)
                       else ["HGMMA", "UTMALDG"])
    if len(hopper) != WGMMA_INSTANCES or any(v != want(fn)
                                             for fn, v in hopper.items()):
        raise AssertionError(f"the wgmma kernels' SASS lacks HGMMA, "
                             f"UTMALDG or (prefill) LDGSTS, or holds more: "
                             f"{hopper}")
    mma = [fn for fn, v in ops.items() if "HMMA" in v]
    if mma:
        raise AssertionError(f"mma.sync (HMMA) in the library: {mma}")
    decode = {fn: v for fn, v in ops.items()
              if fn.split("<")[0] in TMA_KERNELS}
    if len(decode) != TMA_INSTANCES or any("UTMALDG" not in v
                                           for v in decode.values()):
        raise AssertionError(f"the decode kernels' SASS lacks TMA loads "
                             f"(UTMALDG): {decode}")
    return ops


# ------------------------------------------------------------------ cases

def int8_plane(rows, device):
    """An int8 page plane and its bf16 scale vector from float rows
    [P, ps, H, K], quantized page by page with the port's own
    `_quant_write` (each page written from offset 0: its scale is its
    rows' max |x| / 127)."""
    n_pages, ps = rows.shape[:2]
    plane = torch.zeros(rows.shape, dtype=torch.int8, device=device)
    scale = torch.zeros(n_pages, dtype=torch.bfloat16, device=device)
    pages = torch.arange(n_pages, device=device).repeat_interleave(ps)
    offs = torch.arange(ps, device=device).repeat(n_pages)
    pk._quant_write(plane, scale, pages, offs, rows.flatten(0, 1))
    return plane, scale


def device_normal(rng, shape, device):
    """N(0, 1) fp32 of ``shape`` drawn on ``device`` by a torch generator
    seeded from ``rng``: the engine-view pools are tens of millions of
    values, whose draw on the host took most of the kernel checks' time."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    return torch.randn(shape, generator=gen, device=device)


def amplitude_rows(rng, n_pages, ps, heads, device):
    """Normal rows whose pages each have their own amplitude, log-uniform
    in [0.25, 4]: with equal amplitudes a wrong page's scale would barely
    move the output."""
    amp = np.exp(rng.uniform(np.log(0.25), np.log(4.0), n_pages))
    amp = torch.from_numpy(amp.astype(np.float32)).to(device)
    return (device_normal(rng, (n_pages, ps, *heads), device)
            * amp[:, None, None, None])


def paged_pool(rng, lengths, *, ps, n_pg, dtype, device, heads=(H, K),
               null_rows=(), quant=False):
    """K/V pools and a [B, n_pg] page table for slots of the given
    lengths. Each slot gets the pages its length needs (a length past the
    table, as an idle slot's cursor walks, fills it), drawn from a
    random permutation of the pool (the engine's pages are scattered);
    the rest of its row is the null page 0, and so is all of a row in
    null_rows (an idle slot, or a mid-prefill slot in a decode view).
    → (k_pool, v_pool, tables, lengths, scales): ``quant`` pools are int8
    from `amplitude_rows` with scales {"k_scale", "v_scale"}, float pools
    N(0, 1) in ``dtype`` with scales {}."""
    need = [0 if b in null_rows else min(-(-int(n) // ps), n_pg)
            for b, n in enumerate(lengths)]
    n_pages = sum(need) + 1
    if quant:
        kp, ks = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                            device)
        vp, vs = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                            device)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = (device_normal(rng, (n_pages, ps, *heads), device).to(dtype)
                  for _ in range(2))
        scales = {}
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((len(lengths), n_pg), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    return kp, vp, tables, np.asarray(lengths, np.int32), scales


def abs_v_attention(reference, q, kp, vp, *args, **scales):
    """S of the bf16 bound: the plain version with |V| in fp32 (an int8
    pool's |codes| with its scales)."""
    if scales:
        return reference(q.float(), kp, vp.abs(), *args, **scales)
    return reference(q.float(), kp.float(), vp.float().abs(), *args)


def check_close(name, out, ref, s_abs, dtype, live, long):
    """Hold the kernel's output to its plain version's on the elements of
    the live rows (``live``: a mask over the leading slot [, row] dims).
    → the largest error, the bound at that element and the largest share
    of the bound, over all live rows and over the long ones on their own
    (``long``: a mask like ``live``)."""
    o, r, s = (t.float()[live] for t in (out, ref, s_abs))
    lg = long[live]
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (o - r).abs()
    if dtype == torch.float32:
        tol = FP32_TOL["atol"] + FP32_TOL["rtol"] * r.abs()
    else:
        tol = BF16_REL * (r.abs() + s)
    share = torch.where(err == 0, torch.zeros_like(err), err / tol)
    worst = int(err.flatten().argmax())
    res = {"max_abs_err": float(err.max()),
           "bound_at_max_err": float(tol.flatten()[worst]),
           "max_share_of_bound": float(share.max()),
           "long_rows": int(lg.sum())}
    if bool(lg.any()):
        res["long_max_abs_err"] = float(err[lg].max())
        res["long_max_share_of_bound"] = float(share[lg].max())
        res["long_median_abs_ref"] = float(r[lg].abs().median())
        res["long_median_bound"] = float(tol[lg].median())
    if res["max_share_of_bound"] > 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: {res}")
    return res


def half_ulp_bf16(y):
    """Half the bf16 spacing at each element of y: the most by which
    rounding a value to bf16 can have moved it to y (0 at y = 0)."""
    y = y.float()
    _, e = torch.frexp(y)
    return torch.where(y == 0, torch.zeros_like(y),
                       torch.ldexp(torch.ones_like(y), e - 9))


def check_p_unrounded(name, out, ref32, p_rounded, s_abs, live, *,
                      fault_must_fail=False):
    """A bf16-q int8 program's output against ``ref32``, the plain
    version on q.float() (p unrounded), on the live rows; ``p_rounded``,
    the plain version on bf16 q, is a planted fault held to the same
    bound. → each one's largest share of 4e-5 S taken by its error beyond
    its output's own rounding (the bound holds iff the share <= 1)."""
    r, s = ref32.float()[live], s_abs.float()[live]

    def share(y):
        y = y.float()[live]
        excess = ((y - r).abs() - half_ulp_bf16(y)).clamp(min=0)
        return float(torch.where(excess == 0, torch.zeros_like(excess),
                                 excess / (P_UNROUNDED_S * s)).max())

    res = {"max_share_of_bound": share(out),
           "p_rounded_plain_share": share(p_rounded)}
    if res["max_share_of_bound"] > 1.0:
        raise AssertionError(f"{name}: the int8 program rounds p or "
                             f"disagrees with the unrounded plain version: "
                             f"{res}")
    if fault_must_fail and res["p_rounded_plain_share"] <= 1.0:
        raise AssertionError(f"{name}: p rounded to bf16 passes the "
                             f"unrounded bound: {res}")
    return res


def check_decode(rng, tag, lengths, *, ps, n_pg, dtype, device, heads,
                 null_rows=(), quant=False):
    kp, vp, tables, lengths, sc = paged_pool(
        rng, lengths, ps=ps, n_pg=n_pg, dtype=dtype, device=device,
        heads=heads, null_rows=null_rows, quant=quant)
    q = torch.from_numpy(rng.normal(size=(len(lengths), *heads)).astype(
        np.float32)).to(device, dtype)
    args = [torch.from_numpy(a).to(device) for a in (tables, lengths)]
    out = pa.paged_attention(q, kp, vp, *args, **sc)
    again = pa.paged_attention(q, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"decode {tag}: a repeat call gave other bits")
    ref = pa.reference_paged_attention(q, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_attention, q, kp, vp, *args,
                            **sc)
    # A slot of length 0: zeros from the kernel (its l == 0 guard), the
    # uniform average of V from the gather version, by definition.
    live = args[1] > 0
    if not torch.all(out[~live].float() == 0):
        raise AssertionError(f"decode {tag}: a length-0 slot not zero")
    long = args[1] >= LONG_ROW
    res = check_close(f"decode {tag}", out, ref, s_abs, dtype, live, long)
    if quant and dtype == torch.bfloat16:
        res["p_unrounded"] = check_p_unrounded(
            f"decode {tag}", out, pa.reference_paged_attention(
                q.float(), kp, vp, *args, **sc), ref, s_abs, live)
    n_sm = pa._sm_count(device)
    res["n_split"] = pa.decode_splits(len(lengths), heads[0], n_pg, n_sm)
    res["n_parts"] = pa.decode_live_splits(
        lengths, ps, n_pg, heads[0], res["n_split"],
        pa.decode_stage_rows(heads[1], kp.element_size()), n_sm)
    return res


def split_edge_lengths(n_split, ps):
    """Seven slot lengths at the decode kernel's split edges on a CAP-
    position table, for a grid of n_split splits per slot: n_split·ps·k
    (on a page boundary that is a split's end when the slot uses all
    n_split), one past and one short of it, n_split - 1 live pages, a
    length past the table (an idle slot's cursor), 0, and 1 (the idle
    slot on the null page: null_rows {6})."""
    whole = n_split * ps * max(1, CAP // (n_split * ps))
    return [whole, whole + 1, whole - 1, (n_split - 1) * ps, CAP + 100, 0, 1]


def check_prefill(rng, tag, rows, C, *, ps, n_pg, width, dtype, device,
                  heads, quant=False):
    """rows: (offset, valid tokens) per slot; (0, 0) is an inert row with
    an all-null table. The pool has the pages of n_pg·ps positions; the
    kernel gets the first ``width`` pages of the table."""
    lens = [o + n for o, n in rows]
    inert = {b for b, n in enumerate(lens) if n == 0}
    kp, vp, tables, lens, sc = paged_pool(
        rng, [n_pg * ps if n else 0 for n in lens], ps=ps, n_pg=n_pg,
        dtype=dtype, device=device, heads=heads, null_rows=inert,
        quant=quant)
    lens = np.array([o + n for o, n in rows], np.int32)
    offs = np.array([o for o, _ in rows], np.int32)
    q = torch.from_numpy(rng.normal(size=(len(rows), C, *heads)).astype(
        np.float32)).to(device, dtype)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (tables[:, :width], offs, lens)]
    out = pa.paged_prefill_attention(q, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    ref = pa.reference_paged_prefill_attention(q, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_prefill_attention,
                            q, kp, vp, *args, **sc)
    # Inert rows (lengths 0) are defined differently by the kernel
    # (zeros, the l == 0 guard) and the gather version (mean of V).
    live_slot = args[2] > 0
    if not torch.all(out[~live_slot].float() == 0):
        raise AssertionError(f"prefill {tag}: inert row not zero")
    c = torch.arange(C, device=device)
    attended = torch.minimum(args[2][:, None], args[1][:, None] + c + 1)
    live = live_slot[:, None].expand(-1, C)
    res = check_close(f"prefill {tag}", out, ref, s_abs, dtype, live,
                      attended >= LONG_ROW)
    if quant and dtype == torch.bfloat16:
        res["p_unrounded"] = check_p_unrounded(
            f"prefill {tag}", out, pa.reference_paged_prefill_attention(
                q.float(), kp, vp, *args, **sc), ref, s_abs, live)
    return res


def phase_kernels(device, errs, at_shapes):
    """Each kernel against its plain version, the float programs and then
    the int8 ones (int8 pools from `amplitude_rows`, quantized by the
    port's `_quant_write`): OPT-1.3B's heads at page sizes 16 and 64 in
    fp32 and bf16, then head dim 128 (the kernels' other tensor-core and
    vector-width instantiation; at both page sizes for int8), then
    gpt2_2_7b's 32 heads of 80 and gptj_6b's 16 of 256 at the engine's
    page size, bf16, float and int8 pools (fp32 q at those head dims is
    held by tests/test_torch_cuda.py). Cases: the
    ragged edge cases on a narrow table; the engine's decode view (16
    slots, a table of CAP positions, ragged lengths up to CAP, an idle and
    a mid-prefill slot); prefill chunks at ragged offsets, full and width-
    sliced tables, C=256 (the engine's chunk) and C=40 (a partial query
    tile); and the engine's prefill dispatches (16 rows of 256, most of
    them inert)."""
    rng = np.random.default_rng(0)
    cases = []
    dts = (torch.float32, torch.bfloat16)
    grid = [((H, K), ps, dt, False) for ps in (16, 64) for dt in dts]
    grid += [((16, 128), 64, dt, False) for dt in dts]
    grid += [(heads, ps, dt, True) for heads in ((H, K), (16, 128))
             for ps in (16, 64) for dt in dts]
    grid += [(heads, 64, torch.bfloat16, quant)
             for heads in (HEADS_2_7B, HEADS_GPTJ) for quant in (False, True)]

    def record(kernel, tag, res):
        errs[kernel] = max(errs[kernel], res["max_abs_err"])
        cases.append({"kernel": kernel, "case": tag, **res})

    for heads, ps, dtype, quant in grid:
        dn = str(dtype).split(".")[1]
        kw = dict(ps=ps, dtype=dtype, device=device, heads=heads,
                  quant=quant)
        sfx = "_int8" if quant else ""
        tag = (f"ps={ps} {dn} heads={heads[0]}x{heads[1]}"
               f"{' int8 pool' if quant else ''}")
        # Decode: length 1, mid-page, page boundary, full table, and an
        # idle slot (length 1 on the null page), table 4 pages wide.
        record("paged_attention" + sfx, f"{tag} edge cases", check_decode(
            rng, tag, [1, ps // 2 + 1, ps, 4 * ps, 1], n_pg=4,
            null_rows={4}, **kw))
        # Decode as the engine runs it: 16 slots, the full table of CAP
        # positions, the last two slots idle and mid-prefill (zeroed
        # row, a length past the null page's).
        n_pg = CAP // ps
        lengths = [1, ps // 2 + 1, ps, ps + 1, 700, 1023, 1024, 1025, 1531,
                   1999, CAP - ps, CAP - ps + 1, CAP - 1, CAP, 1, 1000]
        record("paged_attention" + sfx, f"{tag} engine view B=16 n_pg={n_pg}",
               check_decode(rng, tag, lengths, n_pg=n_pg,
                            null_rows={14, 15}, **kw))
        # The split paths: one slot at CAP (the most splits), the light-
        # load view (2 of 16 slots live at CAP, 14 idle on the null page),
        # and seven slots at the split edges (`split_edge_lengths`).
        record("paged_attention" + sfx, f"{tag} B=1 at {CAP}", check_decode(
            rng, tag, [CAP], n_pg=n_pg, **kw))
        record("paged_attention" + sfx, f"{tag} light load", check_decode(
            rng, tag, [CAP] * 2 + [1] * 14, n_pg=n_pg,
            null_rows=set(range(2, 16)), **kw))
        edges = split_edge_lengths(pa.decode_splits(
            7, heads[0], n_pg, pa._sm_count(device)), ps)
        record("paged_attention" + sfx, f"{tag} split edges {edges}",
               check_decode(rng, tag, edges, n_pg=n_pg, null_rows={6}, **kw))
        # Prefill: chunk rows at ragged offsets against a 1536-token
        # table, full width and width-sliced; C=256 and C=40.
        n_pg = 1536 // ps
        for C, width in ((256, n_pg), (256, n_pg // 2), (40, n_pg // 2)):
            cap = width * ps
            rows = [(0, C), (ps, C), (cap - C, C), (ps + 3, 1),
                    (cap - 40, 40), (0, 0)]   # last: inert row
            ptag = f"{tag} C={C} width={width}"
            record("paged_prefill_attention" + sfx, ptag, check_prefill(
                rng, ptag, rows, C, n_pg=n_pg, width=width, **kw))
        # Prefill as the engine dispatches it: [16, 256] with the live
        # rows first and the rest inert, at the pow-2 width of the
        # bucket (chunks ending past 1024 positions, then within 512).
        for width_tokens, live_rows in (
                (CAP, [(1024, 256), (1280, 256), (1536, 37), (1792, 255)]),
                (512, [(0, 256), (256, 256), (0, 77)])):
            rows = live_rows + [(0, 0)] * (16 - len(live_rows))
            n_pg = width_tokens // ps
            ptag = f"{tag} engine dispatch 16x256 width={n_pg}"
            record("paged_prefill_attention" + sfx, ptag, check_prefill(
                rng, ptag, rows, 256, n_pg=n_pg, width=n_pg, **kw))
    # Decode at ps 8, below a stage's positions for every program (bf16
    # 16, int8 32 at head dim 64), on the engine view's lengths.
    for quant in (False, True):
        lengths = [1, 5, 8, 9, 700, 1023, 1024, 1025, CAP - 1, CAP, 0, 1]
        record("paged_attention" + ("_int8" if quant else ""),
               f"ps=8 bfloat16 heads={H}x{K}{' int8 pool' if quant else ''}",
               check_decode(rng, "ps=8", lengths, ps=8, n_pg=CAP // 8,
                            dtype=torch.bfloat16, device=device,
                            heads=(H, K), null_rows={10, 11}, quant=quant))
    # bf16 q on the wgmma kernel at every kind of page size: TMA boxes of
    # whole pages (16, 32: several pages per key tile; 64; 128: a page of
    # two key tiles at head dims 80-256), boxes of gcd(ps, key tile) rows
    # (24: 8 and 16 boxes a tile, 48: 4 and 8, 96), and rows gathered by
    # cp.async (20, 4); chunks of C = 40, 72 and 200 at ragged offsets on
    # a width-sliced table, with an inert row.
    for heads, sizes in (((H, K), (16, 32, 64, 128) + PS_OFF_RULE),
                         ((16, 128), (16, 32, 64, 128) + PS_OFF_RULE),
                         (HEADS_2_7B, (64,) + PS_OFF_RULE),
                         (HEADS_GPTJ, (64,) + PS_OFF_RULE)):
        for ps in sizes:
            for quant in (False, True):
                n_pg = -(-768 // ps)
                width = n_pg - 1
                cap = width * ps
                sfx = "_int8" if quant else ""
                rows_box = pa.prefill_box_rows(heads[1], ps)
                kern = (f"boxes of {rows_box} rows" if rows_box
                        else "gathered rows")
                for C in (40, 72, 200):
                    rows = [(0, C), (ps + 3, C - 5), (cap - C, C), (11, 1),
                            (0, 0)]
                    ptag = (f"ps={ps} bfloat16 heads={heads[0]}x{heads[1]}"
                            f"{' int8 pool' if quant else ''} C={C} "
                            f"width={width} ({kern})")
                    record("paged_prefill_attention" + sfx, ptag,
                           check_prefill(rng, ptag, rows, C, ps=ps,
                                         n_pg=n_pg, width=width,
                                         dtype=torch.bfloat16, device=device,
                                         heads=heads, quant=quant))
    # The speculative verify pass: 16 rows of C = k+1 = 5 (and 2) queries
    # at ragged decode cursors, none a multiple of the page or the key
    # tile, on the decode table's width (CAP positions), with inert rows;
    # the q tile's 128 rows lie mostly past C. bf16 q, float and int8.
    n_pg = CAP // 64
    for quant in (False, True):
        sfx = "_int8" if quant else ""
        for C in (5, 2):
            rows = [(67, C), (700, C), (1023, C), (CAP - C, C), (1, C),
                    (64, 1), (127, C - 1), (500, C), (0, 0), (0, 0),
                    (333, 1), (1500, C), (0, 0), (5, C), (CAP - 2 * C, C),
                    (0, 0)]
            ptag = (f"verify shape C={C} ps=64 bfloat16 heads={H}x{K}"
                    f"{' int8 pool' if quant else ''} width={n_pg}")
            record("paged_prefill_attention" + sfx, ptag, check_prefill(
                rng, ptag, rows, C, ps=64, n_pg=n_pg, width=n_pg,
                dtype=torch.bfloat16, device=device, heads=(H, K),
                quant=quant))
    # A speculative draft's heads: gpt2_124m's 12 of 64 (three decode head
    # groups of four) beside opt_1_3b, both kernels, bf16 and int8.
    heads = (DRAFT_H, K)
    for quant in (False, True):
        sfx = "_int8" if quant else ""
        tag = f"ps=64 bfloat16 heads={heads[0]}x{K}{' int8 pool' if quant else ''}"
        kw = dict(ps=64, dtype=torch.bfloat16, device=device, heads=heads,
                  quant=quant)
        lengths = [1, 33, 64, 65, 700, 1023, 1024, 1025, 1531, 1999,
                   CAP - 64, CAP - 1, CAP, 17, 1, 1000]
        record("paged_attention" + sfx, f"{tag} engine view B=16",
               check_decode(rng, tag, lengths, n_pg=n_pg, null_rows={14},
                            **kw))
        for C in (256, 5):
            rows = [(0, C), (64, C), (CAP - C, C), (67, 1), (1000, C),
                    (0, 0)]
            ptag = f"{tag} C={C} width={n_pg}"
            record("paged_prefill_attention" + sfx, ptag, check_prefill(
                rng, ptag, rows, C, n_pg=n_pg, width=n_pg, **kw))
    # Tensor parallelism's per-shard heads: opt_1_3b's 32 at tp=2 (16)
    # and tp=4 (8), the draft's 12 at tp=2 (6: the decode kernel's last
    # group of DECODE_HEAD_GROUP heads is partial), both kernels, bf16 and
    # int8; the decode at the engine view, at light load and at the split
    # edges of each head count's own grid (fewer heads, fewer units: more
    # splits), the prefill at C = 256 and at the verify shape C = 5.
    n_pg = CAP // 64
    for n_heads in TP_SHARD_HEADS:
        for quant in (False, True):
            sfx = "_int8" if quant else ""
            tag = (f"tp shard ps=64 bfloat16 heads={n_heads}x{K}"
                   f"{' int8 pool' if quant else ''}")
            kw = dict(ps=64, dtype=torch.bfloat16, device=device,
                      heads=(n_heads, K), quant=quant)
            lengths = [1, 33, 64, 65, 700, 1023, 1024, 1025, 1531, 1999,
                       CAP - 64, CAP - 1, CAP, 17, 1, 1000]
            record("paged_attention" + sfx, f"{tag} engine view B=16",
                   check_decode(rng, tag, lengths, n_pg=n_pg,
                                null_rows={14}, **kw))
            record("paged_attention" + sfx, f"{tag} light load",
                   check_decode(rng, tag, [CAP] * 2 + [1] * 14, n_pg=n_pg,
                                null_rows=set(range(2, 16)), **kw))
            edges = split_edge_lengths(pa.decode_splits(
                7, n_heads, n_pg, pa._sm_count(device)), 64)
            record("paged_attention" + sfx, f"{tag} split edges {edges}",
                   check_decode(rng, tag, edges, n_pg=n_pg, null_rows={6},
                                **kw))
            for C in (256, 5):
                rows = [(0, C), (64, C), (CAP - C, C), (67, 1), (1000, C),
                        (0, 0)]
                ptag = f"{tag} C={C} width={n_pg}"
                record("paged_prefill_attention" + sfx, ptag, check_prefill(
                    rng, ptag, rows, C, n_pg=n_pg, width=n_pg, **kw))
    emit({"phase": "kernels_vs_plain", "tolerance": TOLERANCE,
          "cases": cases})
    timings = {**time_kernels(device, errs), **time_int8_kernels(device, errs)}
    # The kernels line's at_shapes: both paged kernels, float and int8, at
    # gpt2_2_7b's and gptj_6b's heads, with a page dropped from each plain
    # version planted (and the int8 programs' faults).
    for tag, (n_heads, Kd) in (("gpt2_2_7b heads 32x80", HEADS_2_7B),
                               ("gptj_6b heads 16x256", HEADS_GPTJ)):
        at_shapes[tag] = {
            **time_kernels(device, errs, heads=n_heads, light=False, Kd=Kd,
                           planted=True),
            **time_int8_kernels(device, errs, heads=(n_heads, Kd))}
        torch.cuda.empty_cache()
    for tag, heads, ps, C, off in PS_PREFILL_CASES:
        at_shapes[tag] = time_prefill_at_page_size(device, errs, heads, ps,
                                                   C, off)
    # Rows 1t/2t of PERF.md: both float kernels at a tp=2 shard's heads.
    timings.update({f"{name} tp_shard": t for name, t in time_kernels(
        device, errs, heads=H // 2, light=False).items()})
    return {**timings, **time_spec_kernels(device, errs, timings)}


def sdpa_prefill(qp, kt, vt, off):
    """SDPA yardsticks of a prefill chunk at offset ``off`` (q [B, C, H,
    K] against the gathered [B, H, T, K] timeline), by device time with
    CUDA events beside it: with a bool mask, and with
    causal_lower_right(C, T), exactly the prefill mask at offset T - C,
    which may take a flash backend. ``library_ms`` is the faster."""
    from torch.nn.attention.bias import causal_lower_right

    C, T = qp.shape[1], kt.shape[2]
    assert off == T - C, (off, T, C)
    qpt = qp.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=qp.device)[None, :]
            <= (off + torch.arange(C, device=qp.device))[:, None])
    lower_right = causal_lower_right(C, T)
    bool_ms, bool_ev = kernel_ms(lambda: F.scaled_dot_product_attention(
        qpt, kt, vt, attn_mask=mask))
    lr_ms, lr_ev = kernel_ms(lambda: F.scaled_dot_product_attention(
        qpt, kt, vt, attn_mask=lower_right))
    return {"library_ms": min(bool_ms, lr_ms),
            "library_call": ("causal_lower_right" if lr_ms <= bool_ms
                             else "bool mask"),
            "sdpa_bool_mask_ms": bool_ms, "sdpa_bool_mask_ms_events": bool_ev,
            "sdpa_lower_right_ms": lr_ms, "sdpa_lower_right_ms_events": lr_ev}


def host_us(fn, n=200) -> float:
    """The host's time per call of fn in µs, over n calls issued without a
    synchronisation (the wrapper's Python, checks, allocations and
    launches; the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


LIGHT_SLOTS, LIGHT_LIVE = 16, 2    # light load: 2 of the 16-slot view live


def light_load_case(rng, device, *, quant):
    """The engine's 16-slot decode view at light load, ps 64: slots 0 and
    1 live at CAP positions (a full CAP-position table), the other 14 idle
    on the null page (length 1), bf16 q. → (q, k_pool, v_pool, tables,
    lengths, scales, live)"""
    ps = 64
    lengths = [CAP] * LIGHT_LIVE + [1] * (LIGHT_SLOTS - LIGHT_LIVE)
    kp, vp, tables, lengths, sc = paged_pool(
        rng, lengths, ps=ps, n_pg=CAP // ps, dtype=torch.bfloat16,
        device=device, heads=(H, K),
        null_rows=set(range(LIGHT_LIVE, LIGHT_SLOTS)), quant=quant)
    q = torch.from_numpy(rng.normal(size=(LIGHT_SLOTS, H, K)).astype(
        np.float32)).to(device, torch.bfloat16)
    tables, lengths = (torch.from_numpy(a).to(device)
                       for a in (tables, lengths))
    live = torch.arange(LIGHT_SLOTS, device=device) < LIGHT_LIVE
    return q, kp, vp, tables, lengths, sc, live


def time_decode(tag, q, kp, vp, tables, lengths, sc, live):
    """One decode shape: the kernel held to its plain version on every
    slot (with bf16 q on an int8 pool also to the unrounded plain
    version, which the p-rounded one must fail), a repeat call held to
    the same bits; then its device time beside its bound (the positions
    each slot reads, min(length, table), and their pages' scales), its
    plain version, SDPA on the ``live`` slots' gathered timelines (whole
    tables, so no mask; an int8 pool's dequantized to bf16, not timed) and
    the wrapper's host time per call. → the timing record."""
    dt = q.dtype
    args = (tables, lengths)
    call = lambda: pa.paged_attention(q, kp, vp, *args, **sc)
    out = call()
    torch.cuda.synchronize()
    ref = pa.reference_paged_attention(q, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_attention, q, kp, vp, *args,
                            **sc)
    every = torch.ones(len(q), dtype=torch.bool, device=q.device)
    check = check_close(f"decode {tag}", out, ref, s_abs, dt, every,
                        lengths >= LONG_ROW)
    if sc and dt == torch.bfloat16:
        check["p_unrounded"] = check_p_unrounded(
            f"decode {tag}", out, pa.reference_paged_attention(
                q.float(), kp, vp, *args, **sc), ref, s_abs, every,
            fault_must_fail=True)
    if not torch.equal(out, call()):
        raise AssertionError(f"decode {tag}: a repeat call gave other bits")
    ms, ms_events = kernel_ms(call)
    plain = cuda_time_ms(lambda: pa.reference_paged_attention(
        q, kp, vp, *args, **sc), iters=10)
    (B, Hq, Kq), n_pg, ps = q.shape, tables.shape[1], kp.shape[1]
    if not bool((lengths[live] == n_pg * ps).all()):
        raise AssertionError("SDPA's yardstick takes whole tables")
    kt, vt = pa._gather_timeline(kp, vp, tables[live], sc.get("k_scale"),
                                 sc.get("v_scale"))
    kt, vt = (x.transpose(1, 2).to(dt).contiguous() for x in (kt, vt))
    qs = q[live][:, :, None, :]
    lib = device_ms(lambda: F.scaled_dot_product_attention(qs, kt, vt))
    seen = lengths.clamp(min=0, max=n_pg * ps)
    rows = int(seen.sum())
    pages = int(((seen + ps - 1) // ps).sum())
    nbytes = (2 * rows * Hq * Kq * kp.element_size()
              + 2 * q.numel() * q.element_size() + tables.numel() * 4
              + B * 4 + (2 * pages * 2 if sc else 0))
    bms, by = bound_ms(nbytes, 4 * rows * Hq * Kq, BF16_FLOPS)
    n_sm = pa._sm_count(q.device)
    n_split = pa.decode_splits(B, Hq, n_pg, n_sm)
    n_parts = pa.decode_live_splits(lengths.tolist(), ps, n_pg, Hq, n_split,
                                    pa.decode_stage_rows(Kq,
                                                         kp.element_size()),
                                    n_sm)
    return dict(
        ms=ms, ms_events=ms_events, plain_ms=plain, library_ms=lib,
        bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
        host_us=host_us(call), n_split=n_split, n_parts=n_parts,
        bytes=nbytes, check=check,
        shape=(f"B={B} ({int(live.sum())} live) H={Hq} K={Kq} n_pg={n_pg} "
               f"ps={ps} {str(dt).split('.')[1]} q"
               f"{', int8 pool' if sc else ''}"))


def time_kernels(device, errs, heads=H, light=True, Kd=K, planted=False):
    """Kernel, plain version and SDPA at the main path's decode and
    prefill shapes: B=16 slots, 1024-token contexts, ps=64, bf16, at
    ``heads`` heads of ``Kd`` (opt_1_3b's 32 of 64, a tp shard's, or
    gpt2_2_7b's 32 of 80 and gptj_6b's 16 of 256); the decode kernel
    also at light load (`light_load_case`) when ``light``. Each kernel's
    output is first held to its plain version's on these inputs; with
    ``planted``, a page dropped from the plain version must fail the same
    bound."""
    rng = np.random.default_rng(1)
    B, T, ps, dt = 16, 1024, 64, torch.bfloat16
    n_pg = T // ps
    n_pages = B * n_pg + 1
    kp = torch.randn(n_pages, ps, heads, Kd, device=device, dtype=dt)
    vp = torch.randn(n_pages, ps, heads, Kd, device=device, dtype=dt)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(B, n_pg)).to(device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    kt, vt = pa._gather_timeline(kp, vp, tables)       # [B, T, H, K]
    kt = kt.transpose(1, 2).contiguous()               # [B, H, T, K]
    vt = vt.transpose(1, 2).contiguous()
    item = 2
    timings = {}

    q = torch.randn(B, heads, Kd, device=device, dtype=dt)
    every = torch.ones(B, dtype=torch.bool, device=device)
    timings["paged_attention"] = time_decode(
        "timing shape", q, kp, vp, tables, lengths, {}, every)
    if light:
        timings["paged_attention_light_load"] = time_decode(
            "light load", *light_load_case(rng, device, quant=False))
    errs["paged_attention"] = max(
        errs["paged_attention"], *(t["check"]["max_abs_err"]
                                   for t in timings.values()))

    C, off = 256, T - 256
    qp = torch.randn(B, C, heads, Kd, device=device, dtype=dt)
    offs = torch.full((B,), off, dtype=torch.int32, device=device)
    args = (tables, offs, lengths)
    out = pa.paged_prefill_attention(qp, kp, vp, *args)
    torch.cuda.synchronize()
    attended = torch.minimum(
        lengths[:, None], offs[:, None] + torch.arange(C, device=device) + 1)
    check = check_close(
        "prefill timing shape", out, pa.reference_paged_prefill_attention(
            qp, kp, vp, *args), abs_v_attention(
            pa.reference_paged_prefill_attention, qp, kp, vp, *args), dt,
        torch.ones(B, C, dtype=torch.bool, device=device),
        attended >= LONG_ROW)
    errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"],
                                          check["max_abs_err"])
    ms, ms_events = kernel_ms(lambda: pa.paged_prefill_attention(
        qp, kp, vp, *args))
    plain = cuda_time_ms(lambda: pa.reference_paged_prefill_attention(
        qp, kp, vp, *args), iters=5)
    sdpa = sdpa_prefill(qp, kt, vt, off)
    nbytes = (2 * B * T * heads * Kd * item + 2 * B * C * heads * Kd * item
              + tables.numel() * 4 + 2 * B * 4)
    attended = sum(off + c + 1 for c in range(C))
    flops = 4 * B * heads * Kd * attended
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    timings["paged_prefill_attention"] = dict(
        ms=ms, ms_events=ms_events, plain_ms=plain, **sdpa,
        bound_ms=bms, bound_by=by,
        check=check,
        shape=(f"B={B} C={C} H={heads} K={Kd} ctx={T} offset={off} ps={ps} "
               "bf16"))
    if planted:
        timings["planted_faults_vs_bf16_bound"] = {
            "paged_attention": planted_int8_faults(
                pa.reference_paged_attention, q, kp, vp, tables, (lengths,),
                {}, shift_offsets=False),
            "paged_prefill_attention": planted_int8_faults(
                pa.reference_paged_prefill_attention, qp, kp, vp, tables,
                (offs, lengths), {}, shift_offsets=True)}
    emit({"phase": "kernel_timing" if (heads, Kd) == (H, K) else
          f"kernel_timing_tp ({heads} heads per shard)" if Kd == K else
          f"kernel_timing_heads ({heads}x{Kd})", **timings})
    return timings


def share_of_bound(out, ref, s_abs):
    """Largest |out - ref| / (8e-3 (|ref| + S)), the bf16 bound's share
    (0 where out equals ref: a row of zeros, as an idle slot's on an
    unwritten null page, has a bound of 0)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    share = err / (BF16_REL * (r.abs() + s_abs))
    return float(torch.where(err == 0, torch.zeros_like(share), share).max())


def planted_int8_faults(reference, q, kp, vp, tables, args, scales, *,
                        shift_offsets):
    """The bf16 bound against a wrong plain version on the timed inputs
    (``args``: the index arrays after the table) → each fault's largest
    share of the bound, which must exceed 1:
    - int8 pools (``scales``): the scales indexed by table position j
      instead of page id: the plain version given scale vectors s' with
      s'[tables[b, j]] = s[j];
    - one page dropped: page 1 of every slot taken out of its table (the
      rest moved up, a null page appended, lengths and, for prefill, the
      offsets moved back by one page; decode has no positions)."""
    ps = kp.shape[1]
    ref = reference(q, kp, vp, tables, *args, **scales)
    s_abs = abs_v_attention(reference, q, kp, vp, tables, *args, **scales)
    by_pos = {}
    B, n_pg = tables.shape
    idx = tables.long().flatten()
    for name, sc in scales.items():
        fake = sc.clone()
        fake[idx] = sc[torch.arange(n_pg, device=sc.device).repeat(B)]
        by_pos[name] = fake
    dropped = torch.cat([tables[:, :1], tables[:, 2:],
                         torch.zeros_like(tables[:, :1])], dim=1)
    moved = [a - ps for a in args] if shift_offsets else [args[0] - ps]
    out = {"page 1 dropped": share_of_bound(
        reference(q, kp, vp, dropped, *moved, **scales), ref, s_abs)}
    if scales:
        out["scale by table position"] = share_of_bound(
            reference(q, kp, vp, tables, *args, **by_pos), ref, s_abs)
    if min(out.values()) <= 1.0:
        raise AssertionError(f"a planted fault passes the bf16 bound: {out}")
    return out


P_ROUNDED_FAULT = "p rounded to bf16 (the plain version on bf16 q)"


def time_int8_kernels(device, errs, heads=(H, K)):
    """The int8 programs at the float kernels' timed shapes (B=16 slots,
    1024-token contexts, ps=64, bf16 q), the decode program also at light
    load (`light_load_case`), on int8 pools from
    `amplitude_rows`: each held once more to its plain version, two
    planted faults in the plain version held to the same bound, then
    timed beside its bound, its plain version and SDPA on the gathered
    timeline dequantized to bf16 (the dequantization not timed). ``heads``
    (heads, head dim): opt_1_3b's by default, the light-load case then
    too; gpt2_2_7b's or gptj_6b's at the new head dims."""
    rng = np.random.default_rng(6)
    Hh, Kd = heads
    main = heads == (H, K)
    B, T, ps, dt = 16, 1024, 64, torch.bfloat16
    n_pg = T // ps
    n_pages = B * n_pg + 1
    kp, ks = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                        device)
    vp, vs = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                        device)
    sc = {"k_scale": ks, "v_scale": vs}
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(B, n_pg)).to(device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    kt, vt = pa._gather_timeline(kp, vp, tables, ks, vs)   # fp32 [B, T, H, K]
    kt = kt.transpose(1, 2).to(dt).contiguous()            # [B, H, T, K]
    vt = vt.transpose(1, 2).to(dt).contiguous()
    scale_bytes = 2 * B * n_pg * 2       # one bf16 K and V scale per page
    timings, planted = {}, {}

    q = torch.from_numpy(rng.normal(size=(B, *heads)).astype(
        np.float32)).to(device, dt)
    every = torch.ones(B, dtype=torch.bool, device=device)
    timings["paged_attention_int8"] = time_decode(
        "int8 timing shape", q, kp, vp, tables, lengths, sc, every)
    if main:
        timings["paged_attention_int8_light_load"] = time_decode(
            "int8 light load", *light_load_case(rng, device, quant=True))
    check = timings["paged_attention_int8"]["check"]
    errs["paged_attention_int8"] = max(
        errs["paged_attention_int8"], check["max_abs_err"],
        *(t["check"]["max_abs_err"] for t in timings.values()))
    planted["paged_attention_int8"] = {
        **planted_int8_faults(pa.reference_paged_attention, q, kp, vp,
                              tables, (lengths,), sc, shift_offsets=False),
        P_ROUNDED_FAULT: check["p_unrounded"]["p_rounded_plain_share"]}

    C, off = 256, T - 256
    qp = torch.from_numpy(rng.normal(size=(B, C, *heads)).astype(
        np.float32)).to(device, dt)
    offs = torch.full((B,), off, dtype=torch.int32, device=device)
    args = (tables, offs, lengths)
    out = pa.paged_prefill_attention(qp, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    attended = torch.minimum(
        lengths[:, None], offs[:, None] + torch.arange(C, device=device) + 1)
    ref = pa.reference_paged_prefill_attention(qp, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_prefill_attention, qp, kp, vp,
                            *args, **sc)
    every = torch.ones(B, C, dtype=torch.bool, device=device)
    check = check_close("prefill int8 timing shape", out, ref, s_abs, dt,
                        every, attended >= LONG_ROW)
    check["p_unrounded"] = check_p_unrounded(
        "prefill int8 timing shape", out,
        pa.reference_paged_prefill_attention(qp.float(), kp, vp, *args,
                                             **sc), ref, s_abs, every,
        fault_must_fail=True)
    errs["paged_prefill_attention_int8"] = max(
        errs["paged_prefill_attention_int8"], check["max_abs_err"])
    planted["paged_prefill_attention_int8"] = {
        **planted_int8_faults(pa.reference_paged_prefill_attention, qp, kp,
                              vp, tables, (offs, lengths), sc,
                              shift_offsets=True),
        P_ROUNDED_FAULT: check["p_unrounded"]["p_rounded_plain_share"]}
    ms, ms_events = kernel_ms(lambda: pa.paged_prefill_attention(
        qp, kp, vp, *args, **sc))
    plain = cuda_time_ms(lambda: pa.reference_paged_prefill_attention(
        qp, kp, vp, *args, **sc), iters=5)
    sdpa = sdpa_prefill(qp, kt, vt, off)
    nbytes = (2 * B * T * Hh * Kd + 2 * B * C * Hh * Kd * 2 + scale_bytes
              + tables.numel() * 4 + 2 * B * 4)
    flops = 4 * B * Hh * Kd * sum(off + c + 1 for c in range(C))
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    timings["paged_prefill_attention_int8"] = dict(
        ms=ms, ms_events=ms_events, plain_ms=plain, **sdpa,
        bound_ms=bms, bound_by=by,
        bytes=nbytes, flops=flops, check=check,
        shape=f"B={B} C={C} H={Hh} K={Kd} ctx={T} offset={off} ps={ps} "
              "bf16 q, int8 pool")
    emit({"phase": "int8_kernel_timing" if main else
          f"int8_kernel_timing_heads ({Hh}x{Kd})", **timings,
          "planted_faults_vs_bf16_bound": planted,
          "note": f"{P_ROUNDED_FAULT!r} is read against the p-unrounded "
                  "bound (share of 4e-5 S beyond the output's rounding), "
                  "the other faults against the bf16 bound"})
    return timings


# Page sizes off the TMA rule the prefill had before (a divisor or a
# multiple of 64): boxes of gcd(ps, key tile) rows (24, 48, 96) and
# gathered rows (20, 4). The kernels phase checks each at every head dim.
PS_OFF_RULE = (24, 48, 96, 20, 4)
# The prefill timed at such page sizes (the kernels line's at_shapes): 16
# slots, a chunk of C at offset off (lengths off + C), the table as many
# pages as that takes. ps 48 at 16 heads of 256 is engine_gptj's ps-48
# engine's (GPTJ_PS48_KNOBS: chunks of 240).
PS_PREFILL_CASES = (
    ("gptj_6b heads 16x256 ps 48", HEADS_GPTJ, 48, 240, 768),
    ("opt_1_3b heads 32x64 ps 48", (H, K), 48, 256, 768),
    ("gptj_6b heads 16x256 ps 20", HEADS_GPTJ, 20, 240, 768),
    ("opt_1_3b heads 32x64 ps 20", (H, K), 20, 256, 768),
)
# The A/B's prefill at ps 64 at the other head dims (one page piece of one
# to four column boxes a tile), beside PS_PREFILL_CASES.
AB_PS64_CASES = (
    ("gpt2_2_7b heads 32x80 ps 64", HEADS_2_7B, 64, 256, 768),
    ("gptj_6b heads 16x256 ps 64", HEADS_GPTJ, 64, 256, 768),
)


def prefill_case_at(rng, device, heads, ps, C, off, quant):
    """16 slots of off + C live positions on scattered pages of ps
    (`amplitude_rows` int8 pools, or normal bf16 ones), bf16 q of C rows
    at offset off. → (q, k_pool, v_pool, (tables, offsets, lengths),
    scales)"""
    Hh, Kd = heads
    B, L = 16, off + C
    n_pg = -(-L // ps)
    n_pages = B * n_pg + 1
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(B, n_pg)).to(device)
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    offs = torch.full((B,), off, dtype=torch.int32, device=device)
    if quant:
        kp, ks = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                            device)
        vp, vs = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                            device)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = (device_normal(rng, (n_pages, ps, Hh, Kd), device).to(
            torch.bfloat16) for _ in range(2))
        sc = {}
    qp = device_normal(rng, (B, C, Hh, Kd), device).to(torch.bfloat16)
    return qp, kp, vp, (tables, offs, lengths), sc


def time_prefill_at_page_size(device, errs, heads, ps, C, off):
    """The bf16 prefill (wgmma) at page size ps and ``heads`` (heads, head
    dim), 16 slots of off + C positions, C rows at offset off
    (`prefill_case_at`), on a float and an int8 pool: each held once more
    to its plain version (the int8 program also to the unrounded one), a
    page dropped from the plain version (and, int8, the scales by table
    position and p rounded) planted, which must fail the bound; then
    timed beside its bound, its plain version and SDPA on the live
    positions of the gathered timeline. → timings by kernel"""
    rng = np.random.default_rng(21)
    (Hh, Kd), dt = heads, torch.bfloat16
    B, L = 16, off + C
    rows = pa.prefill_box_rows(Kd, ps)
    producer = f"TMA boxes of {rows} rows" if rows else "gathered rows"
    flops = 4 * B * Hh * Kd * sum(off + c + 1 for c in range(C))
    ref_fn = pa.reference_paged_prefill_attention
    timings, planted = {}, {}
    for quant in (False, True):
        name = "paged_prefill_attention" + ("_int8" if quant else "")
        qp, kp, vp, args, sc = prefill_case_at(rng, device, heads, ps, C,
                                               off, quant)
        tables, offs, lengths = args
        every = torch.ones(B, C, dtype=torch.bool, device=device)
        attended = torch.minimum(lengths[:, None], offs[:, None]
                                 + torch.arange(C, device=device) + 1)
        call = lambda: pa.paged_prefill_attention(qp, kp, vp, *args, **sc)
        out = call()
        torch.cuda.synchronize()
        tag = f"prefill ps {ps} {Hh}x{Kd} {name}"
        ref = ref_fn(qp, kp, vp, *args, **sc)
        s_abs = abs_v_attention(ref_fn, qp, kp, vp, *args, **sc)
        check = check_close(tag, out, ref, s_abs, dt, every,
                            attended >= LONG_ROW)
        planted[name] = planted_int8_faults(ref_fn, qp, kp, vp, tables,
                                            (offs, lengths), sc,
                                            shift_offsets=True)
        if quant:
            check["p_unrounded"] = check_p_unrounded(
                tag, out, ref_fn(qp.float(), kp, vp, *args, **sc), ref,
                s_abs, every, fault_must_fail=True)
            planted[name][P_ROUNDED_FAULT] = (
                check["p_unrounded"]["p_rounded_plain_share"])
        errs[name] = max(errs[name], check["max_abs_err"])
        del ref, s_abs
        ms, ms_events = kernel_ms(call)
        plain = cuda_time_ms(lambda: ref_fn(qp, kp, vp, *args, **sc),
                             iters=5)
        kt, vt = pa._gather_timeline(kp, vp, tables, sc.get("k_scale"),
                                     sc.get("v_scale"))
        kt, vt = (x[:, :L].transpose(1, 2).to(dt).contiguous()
                  for x in (kt, vt))
        sdpa = sdpa_prefill(qp, kt, vt, off)
        nbytes = (2 * B * L * Hh * Kd * kp.element_size()
                  + 2 * B * C * Hh * Kd * 2
                  + (2 * B * tables.shape[1] * 2 if quant else 0)
                  + tables.numel() * 4 + 2 * B * 4)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        timings[name] = dict(
            ms=ms, ms_events=ms_events, plain_ms=plain, **sdpa,
            bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
            check=check, producer=producer,
            shape=(f"B={B} C={C} H={Hh} K={Kd} ctx={L} offset={off} "
                   f"ps={ps} bf16 q{', int8 pool' if quant else ''}"))
        del kp, vp, kt, vt, qp
        torch.cuda.empty_cache()
    emit({"phase": f"prefill_timing ({Hh}x{Kd}, ps {ps})", **timings,
          "planted_faults_vs_bf16_bound": planted,
          "note": f"{P_ROUNDED_FAULT!r} is read against the p-unrounded "
                  "bound, the other faults against the bf16 bound"})
    return timings


def time_spec_kernels(device, errs, timed):
    """The speculative path's new shapes, each kernel held once more to its
    plain version on the inputs it is timed on: the prefill kernel as the
    verify pass (16 slots at 1024 positions, C = k+1 = 5 rows at offset
    1019, H 32, K 64, ps 64, bf16 q; float and int8 pools) beside its
    bound, its plain version, SDPA lower-right (or with a bool mask) on
    the gathered timeline and (k+1) x the decode kernel's time at the same
    slots (``timed``: what the verify pass replaces); and the decode
    kernel at the draft's 12 heads (16 slots at 1024 positions)."""
    rng = np.random.default_rng(11)
    B, T, ps, C, dt = 16, 1024, 64, SPEC_K + 1, torch.bfloat16
    n_pg, off = T // ps, T - C
    every = torch.ones(B, dtype=torch.bool, device=device)
    out = {}
    for quant in (False, True):
        sfx = "_int8" if quant else ""
        kp, vp, tables, lengths, sc = paged_pool(
            rng, [T] * B, ps=ps, n_pg=n_pg, dtype=dt, device=device,
            quant=quant)
        tables, lengths = (torch.from_numpy(a).to(device)
                           for a in (tables, lengths))
        offs = torch.full((B,), off, dtype=torch.int32, device=device)
        qp = torch.from_numpy(rng.normal(size=(B, C, H, K)).astype(
            np.float32)).to(device, dt)
        args = (tables, offs, lengths)
        call = lambda: pa.paged_prefill_attention(qp, kp, vp, *args, **sc)
        res = call()
        torch.cuda.synchronize()
        ref = pa.reference_paged_prefill_attention(qp, kp, vp, *args, **sc)
        s_abs = abs_v_attention(pa.reference_paged_prefill_attention, qp, kp,
                                vp, *args, **sc)
        rows = torch.ones(B, C, dtype=torch.bool, device=device)
        attended = offs[:, None] + torch.arange(C, device=device) + 1
        check = check_close(f"prefill{sfx} verify shape", res, ref, s_abs,
                            dt, rows, attended >= LONG_ROW)
        if quant:
            check["p_unrounded"] = check_p_unrounded(
                "prefill int8 verify shape", res,
                pa.reference_paged_prefill_attention(
                    qp.float(), kp, vp, *args, **sc), ref, s_abs, rows)
        name = "paged_prefill_attention" + sfx
        errs[name] = max(errs[name], check["max_abs_err"])
        ms, ms_events = kernel_ms(call)
        plain = cuda_time_ms(lambda: pa.reference_paged_prefill_attention(
            qp, kp, vp, *args, **sc), iters=5)
        kt, vt = pa._gather_timeline(kp, vp, tables, sc.get("k_scale"),
                                     sc.get("v_scale"))
        kt, vt = (x.transpose(1, 2).to(dt).contiguous() for x in (kt, vt))
        sdpa = sdpa_prefill(qp, kt, vt, off)
        del kt, vt
        nbytes = (2 * B * T * H * K * kp.element_size()
                  + 2 * B * C * H * K * 2 + (2 * B * n_pg * 2 if quant else 0)
                  + tables.numel() * 4 + 2 * B * 4)
        flops = 4 * B * H * K * sum(off + c + 1 for c in range(C))
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        decode_ms = timed["paged_attention" + sfx]["ms"]
        out[name + "_verify"] = dict(
            ms=ms, ms_events=ms_events, plain_ms=plain, **sdpa,
            bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
            bytes=nbytes, flops=flops, check=check,
            decode_ms_same_slots=decode_ms,
            k_plus_1_decode_ms=(SPEC_K + 1) * decode_ms,
            shape=f"B={B} C={C} H={H} K={K} ctx={T} offset={off} ps={ps} "
                  f"bf16 q{', int8 pool' if quant else ''} (the verify pass)")
        del kp, vp
    for quant in (False, True):
        sfx = "_int8" if quant else ""
        kp, vp, tables, lengths, sc = paged_pool(
            rng, [T] * B, ps=ps, n_pg=n_pg, dtype=dt, device=device,
            heads=(DRAFT_H, K), quant=quant)
        tables, lengths = (torch.from_numpy(a).to(device)
                           for a in (tables, lengths))
        q = torch.from_numpy(rng.normal(size=(B, DRAFT_H, K)).astype(
            np.float32)).to(device, dt)
        rec = time_decode(f"draft heads{sfx}", q, kp, vp, tables, lengths,
                          sc, every)
        name = "paged_attention" + sfx
        errs[name] = max(errs[name], rec["check"]["max_abs_err"])
        out[name + "_draft_heads"] = rec
    emit({"phase": "spec_kernel_timing", **out})
    return out


# ------------------------------------------------------------ flash kernels
#
# The same bound as the paged kernels'. Forward: S = the attention of |V|.
# Backward: each side computes ds (or p) in fp32 and rounds it to bf16
# before its product, so with W = p (|dP| + |delta|) sm_scale >= |ds|:
#   dq: S = W |K|,  dk: S = W^T |Q|,  dv: S = p^T |dO|   (all fp32),
# and |out - ref| <= 2u (|ref| + S) + (fp32 terms) <= 8e-3 (|ref| + S).

FLASH_SHAPE = (8, 1024, 12, 64)    # the training step's q, k, v [B, S, H, K]
FLASH_LONG = 512     # visible keys (rows) from which a flash row (key) is long
FAULT_LO = 512       # first key (row) of the tile a planted fault drops
FLASH_TOLERANCE = {
    "float32": TOLERANCE["float32"],
    "bfloat16": "|out - ref| <= 8e-3 (|ref| + S); S = attention of |V| (o),"
                " W |K| (dq), W^T |Q| (dk), p^T |dO| (dv), W = p (|dP| + "
                "|delta|) sm_scale, all fp32; lse within 1e-4",
    "flash_delta": "|out - ref| <= 1e-5 (sum_k |dO O| + |dlse|) per row: "
                   "both sides sum the row in fp32, in other orders, over "
                   "at most 256 terms",
}
DELTA_REL = 1e-5
DELTA_FAULT_COLS = 16   # a planted fault leaves a row's last 16 columns out


def delta_share(out, ref, o, do, dlse):
    """The largest share of the delta bound (FLASH_TOLERANCE's
    flash_delta) over every row."""
    s = (do.float() * o.float()).abs().sum(dim=-1)
    if dlse is not None:
        s = s + dlse.float().abs()
    return float(((out - ref).abs() / (DELTA_REL * s)).nan_to_num(0.0).max())


def strided_view(x):
    """x's values in a view whose rows are two rows apart (a packed
    tensor's second slot)."""
    pack = torch.zeros(*x.shape[:2], 2, *x.shape[2:], dtype=x.dtype,
                       device=x.device)
    pack[:, :, 1] = x
    return pack[:, :, 1]


def check_delta(tag, o, do, dlse, o32=None):
    """The delta kernel against its plain version, with and without the
    lse cotangent, on a strided dO, and (bf16) on the forward's fp32 o
    beside bf16 dO, the head-dim-256 training path → {max_abs_err,
    max_share_of_bound, cases}; raises past the bound."""
    cases = {"dlse": (o, do, dlse), "no dlse": (o, do, None),
             "strided dO": (o, strided_view(do), dlse)}
    if o32 is not None and o32.dtype != do.dtype:
        cases["fp32 o"] = (o32, do, dlse)
    res = {"cases": {}}
    for name, (o_, do_, dl) in cases.items():
        out = fa.flash_delta(o_, do_, dl)
        torch.cuda.synchronize()
        ref = fa.reference_flash_delta(o_, do_, dl)
        if out.shape != ref.shape or not out.is_contiguous():
            raise AssertionError(f"flash_delta {tag} {name}: layout")
        res["cases"][name] = {
            "max_abs_err": float((out - ref).abs().max()) if out.numel()
            else 0.0, "max_share_of_bound": delta_share(out, ref, o_, do_, dl)}
    res["max_abs_err"] = max(c["max_abs_err"] for c in res["cases"].values())
    res["max_share_of_bound"] = max(c["max_share_of_bound"]
                                    for c in res["cases"].values())
    if res["max_share_of_bound"] > 1.0:
        raise AssertionError(f"flash_delta {tag} off its plain version: "
                             f"{res}")
    return res


def planted_delta_faults(o, do, dlse):
    """The delta bound against a wrong plain version on the timed inputs:
    row 0's dlse dropped, and each row's last DELTA_FAULT_COLS columns
    left out of the sum → each fault's largest share of the bound, which
    must exceed 1."""
    out = fa.flash_delta(o, do, dlse)
    dropped = dlse.clone()
    dropped[0, 0, 0] = 0.0
    c = do.shape[-1] - DELTA_FAULT_COLS
    wrong = {"row 0's dlse dropped": fa.reference_flash_delta(o, do, dropped),
             f"last {DELTA_FAULT_COLS} columns dropped":
                 fa.reference_flash_delta(o[..., :c], do[..., :c], dlse)}
    res = {name: delta_share(out, ref, o, do, dlse)
           for name, ref in wrong.items()}
    if min(res.values()) <= 1.0:
        raise AssertionError(f"a planted delta fault passes its bound: {res}")
    return res


def flash_inputs(rng, B, S, T, Hh, Kd, dtype, device):
    """q, k, v, dO and an lse cotangent, N(0, 1) from ``rng``; o and lse
    from the plain forward, so the backward kernels and their plain
    versions see the same saved tensors."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)
    q, k, v = (t(B, n, Hh, Kd).to(dtype) for n in (S, T, T))
    do = t(B, S, Hh, Kd).to(dtype)
    dlse = t(B, S, Hh)
    return q, k, v, do, dlse


def flash_abs_sums(q, k, v, do, lse, delta, causal, scale):
    """S of the bf16 bound for o, dq, dk and dv (see above), in fp32."""
    S_, T_ = q.shape[1], k.shape[1]
    s = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    mask = torch.ones(S_, T_, dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(S_, device=q.device)[:, None] >= torch.arange(
            T_, device=q.device)[None, :]
    row = lambda x: x.transpose(1, 2)[..., None]
    p = torch.where(mask, torch.exp(s - row(lse)), torch.zeros_like(s))
    dp = torch.einsum("bshk,bthk->bhst", do.float(), v.float())
    w = p * (dp.abs() + row(delta).abs()) * scale
    del s, dp
    s_o, _ = fa.reference_flash_fwd(q.float(), k.float(), v.float().abs(),
                                    causal, scale)
    return {
        "flash_fwd": s_o,
        "flash_dq": torch.einsum("bhst,bthk->bshk", w, k.float().abs()),
        "flash_dk": torch.einsum("bhst,bshk->bthk", w, q.float().abs()),
        "flash_dv": torch.einsum("bhst,bshk->bthk", p, do.float().abs()),
    }


def flash_close(name, out, ref, s_abs, dtype, long):
    """check_close over every element (no inert rows here); ``long``
    [S] or [T] marks the long rows (or keys) of every batch entry."""
    every = torch.ones(out.shape[:2], dtype=torch.bool, device=out.device)
    return check_close(name, out, ref, s_abs, dtype, every, every & long)


def flash_long(S, T, causal, device):
    """Rows with FLASH_LONG or more visible keys, keys visible to
    FLASH_LONG or more rows → ([S], [T]) bool."""
    s, t = torch.arange(S, device=device), torch.arange(T, device=device)
    rows = torch.clamp(s + 1, max=T) if causal else torch.full_like(s, T)
    keys = torch.clamp(S - t, min=0) if causal else torch.full_like(t, S)
    return rows >= FLASH_LONG, keys >= FLASH_LONG


def dropped_tile(q, k, v, do, lse, delta, scale, lo):
    """What one 64-wide tile adds to each causal gradient, from the plain
    version's rounded p and ds in fp32: keys lo..lo+63 to dq, query rows
    lo..lo+63 to dk and dv. A planted fault subtracts it."""
    hi = lo + 64
    p, ds = fa._p_ds(q, k, v, do, lse, delta, True, scale)
    dq = torch.einsum("bhst,bthk->bshk", ds[..., lo:hi].float(),
                      k[:, lo:hi].float())
    dk = torch.einsum("bhst,bshk->bthk", ds[:, :, lo:hi].float(),
                      q[:, lo:hi].float())
    dv = torch.einsum("bhst,bshk->bthk", p[:, :, lo:hi].to(do.dtype).float(),
                      do[:, lo:hi].float())
    return dq, dk, dv


def planted_flash_faults(q, k, v, do, lse, delta, scale):
    """The bf16 bound against a wrong backward on the timed inputs: the
    plain dq with keys 512-575 dropped, the plain dk and dv with query
    rows 512-575 dropped → each fault's largest share of the bound, over
    every element and over the long rows (or keys). Each must exceed 1."""
    tiles = dict(zip(("flash_dq", "flash_dk", "flash_dv"),
                     dropped_tile(q, k, v, do, lse, delta, scale, FAULT_LO)))
    refs = dict(zip(("flash_dk", "flash_dv"), fa.reference_flash_dkv(
        q, k, v, do, lse, delta, True, scale)))
    refs["flash_dq"] = fa.reference_flash_dq(q, k, v, do, lse, delta, True,
                                             scale)
    sums = flash_abs_sums(q, k, v, do, lse, delta, True, scale)
    long_q, long_k = flash_long(q.shape[1], k.shape[1], True, q.device)
    out = {"dropped": f"dq: keys {FAULT_LO}-{FAULT_LO + 63}; dk, dv: query "
                      f"rows {FAULT_LO}-{FAULT_LO + 63}"}
    for name, tile in tiles.items():
        ref = refs[name].float()
        wrong = (ref - tile).to(q.dtype).float()
        share = (wrong - ref).abs() / (BF16_REL * (ref.abs() + sums[name]))
        long = long_q if name == "flash_dq" else long_k
        out[name] = {"max_share_of_bound": float(share.max()),
                     "long_max_share_of_bound": float(share[:, long].max())}
        if out[name]["max_share_of_bound"] <= 1.0:
            raise AssertionError(f"planted fault passes the bf16 bound: {out}")
    return out


def packed_views(q, k, v):
    """q, k, v as views of packed [B, S, 3, H, K] tensors (q of one, k and
    v of another), as the training step's qkv projection passes them."""
    qkv_q = torch.empty(*q.shape[:2], 3, *q.shape[2:], dtype=q.dtype,
                        device=q.device)
    qkv_kv = torch.empty(*k.shape[:2], 3, *k.shape[2:], dtype=k.dtype,
                         device=k.device)
    qkv_q[:, :, 0] = q
    qkv_kv[:, :, 1] = k
    qkv_kv[:, :, 2] = v
    return qkv_q[:, :, 0], qkv_kv[:, :, 1], qkv_kv[:, :, 2]


def check_flash(rng, tag, B, S, T, Hh, Kd, dtype, causal, device,
                packed=False):
    """Each flash kernel against its plain version on one case →
    {kernel: result}. The backward gets an lse cotangent. ``packed``: q,
    k and v are strided views of packed qkv tensors."""
    scale = 1.0 / np.sqrt(Kd)
    long_q, long_k = flash_long(S, T, causal, device)
    q, k, v, do, dlse = flash_inputs(rng, B, S, T, Hh, Kd, dtype, device)
    if packed:
        q, k, v = packed_views(q, k, v)
    o, lse, o32 = fa.flash_fwd(q, k, v, causal, scale, with_o32=True)
    torch.cuda.synchronize()
    o_ref, lse_ref, o32_ref = fa.reference_flash_fwd(q, k, v, causal, scale,
                                                     with_o32=True)
    if not torch.equal(o, o32.to(dtype)):
        raise AssertionError(f"flash_fwd {tag}: o is not o32 rounded")
    delta = fa.reference_flash_delta(o_ref, do, dlse)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    dq_ref = fa.reference_flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk_ref, dv_ref = fa.reference_flash_dkv(q, k, v, do, lse_ref, delta,
                                            causal, scale)
    sums = flash_abs_sums(q, k, v, do, lse_ref, delta, causal, scale)
    # Outputs take their inputs' layout (torch.empty_like: the same
    # strides for a dense input, contiguous for a packed view).
    like = lambda x: torch.empty_like(x).stride()
    if not (dq.stride() == like(q) and dk.stride() == like(k)
            and dv.stride() == like(v) and o.stride() == like(q)):
        raise AssertionError(f"flash {tag}: outputs lost their inputs' layout")
    res = {"flash_fwd": flash_close(f"flash_fwd {tag}", o, o_ref,
                                    sums["flash_fwd"], dtype, long_q)}
    # lse: fp32 on both sides from the same fp32 statistics.
    lse_err = float((lse - lse_ref).abs().max())
    res["flash_fwd"]["lse_max_abs_err"] = lse_err
    res["flash_fwd"]["o32"] = flash_close(f"flash_fwd o32 {tag}", o32,
                                          o32_ref, sums["flash_fwd"], dtype,
                                          long_q)
    if lse_err > 1e-4:
        raise AssertionError(f"flash_fwd {tag}: lse off by {lse_err}")
    res["flash_delta"] = check_delta(tag, o_ref, do, dlse, o32_ref)
    res["flash_dq"] = flash_close(f"flash_dq {tag}", dq, dq_ref,
                                  sums["flash_dq"], dtype, long_q)
    rk = flash_close(f"flash_dkv dk {tag}", dk, dk_ref, sums["flash_dk"],
                     dtype, long_k)
    rv = flash_close(f"flash_dkv dv {tag}", dv, dv_ref, sums["flash_dv"],
                     dtype, long_k)
    res["flash_dkv"] = {
        "max_abs_err": max(rk["max_abs_err"], rv["max_abs_err"]),
        "max_share_of_bound": max(rk["max_share_of_bound"],
                                  rv["max_share_of_bound"]),
        "dk": rk, "dv": rv}
    return res


def backward_refused(device, Kd=96):
    """dq and dkv at a head dim their kernels do not take: each must
    raise ValueError naming the head dim and the ROADMAP item, launching
    nothing (never the plain version). → the dq message."""
    q = torch.zeros(1, 8, 2, Kd, device=device, dtype=torch.bfloat16)
    rows = torch.zeros(1, 8, 2, device=device)
    counts = (fa.flash_dq.launches, fa.flash_dkv.launches)
    msgs = []
    for fn in (fa.flash_dq, fa.flash_dkv):
        try:
            fn(q, q, q, q, rows, rows)
        except ValueError as e:
            msgs.append(str(e))
        else:
            raise AssertionError(f"{fn.__name__} ran at head dim {Kd}")
    if (not all(f"head dim {Kd}" in m and "ROADMAP" in m for m in msgs)
            or (fa.flash_dq.launches, fa.flash_dkv.launches) != counts):
        raise AssertionError(f"backward refusal at head dim {Kd}: {msgs}")
    return msgs[0]


def phase_flash_kernels(device, errs, at_shapes):
    """The four flash kernels against their plain versions: fp32 and
    bf16, head dims 64, 80, 128 and 256, causal and non-causal,
    S=77/T=130, S=64/T=256 and S=200/T=333 (off the tile sizes, S != T),
    S=T=192, one query row (S=1/T=64) and one key (S=130/T=1); in bf16
    also q, k, v as strided views of packed qkv tensors (S=200/T=333 and
    S=1/T=64); dq and dkv refusing head dim 96; then the timing shapes."""
    rng = np.random.default_rng(4)
    cases = []
    grid = [(Kd, dtype, S, T, causal, False)
            for Kd in (64, 128, 80, 256)
            for dtype in (torch.float32, torch.bfloat16)
            for S, T in ((77, 130), (64, 256), (200, 333), (192, 192),
                         (1, 64), (130, 1))
            for causal in (True, False)]
    grid += [(Kd, torch.bfloat16, S, T, causal, True)
             for Kd in (64, 128, 80, 256)
             for S, T in ((200, 333), (1, 64)) for causal in (True, False)]
    for Kd, dtype, S, T, causal, packed in grid:
        dn = str(dtype).split(".")[1]
        tag = (f"B=2 S={S} T={T} H=3 K={Kd} {dn} "
               f"{'causal' if causal else 'full'}"
               f"{' packed qkv views' if packed else ''}")
        res = check_flash(rng, tag, 2, S, T, 3, Kd, dtype, causal, device,
                          packed)
        for kern, r in res.items():
            errs[kern] = max(errs[kern], r["max_abs_err"])
            cases.append({"kernel": kern, "case": tag, **r})
    emit({"phase": "flash_kernels_vs_plain", "tolerance": FLASH_TOLERANCE,
          "cases": cases, "backward_refused": backward_refused(device)})
    return time_flash(device, errs, at_shapes)


def flash_shape_timings(device, errs, tag, B, S, Hh, Kd, causal, seed):
    """The four flash kernels at one bf16 shape ([B, S, Hh, Kd], T = S;
    delta reads the o the training path's backward reads: the forward's
    fp32 o at `fa.O32_HEAD_DIMS`):
    held once more to their plain versions on these inputs (`check_flash`,
    the largest errors into ``errs``), then timed (`device_ms`, CUDA
    events beside it) beside each kernel's bound, its plain version and
    its library call: SDPA for the forward; for the backward the faster
    of aten's flash backward and the backward of SDPA's graph, each held
    once to the plain versions, on the flash_dq row beside delta + dq +
    dkv (one call does all three). → (timings per kernel, the inputs and
    yardsticks for callers that read more)."""
    dt, item = torch.bfloat16, 2
    scale = 1.0 / np.sqrt(Kd)
    res = check_flash(np.random.default_rng(seed), tag, B, S, S, Hh, Kd, dt,
                      causal, device)
    for kern, r in res.items():
        errs[kern] = max(errs[kern], r["max_abs_err"])
    q, k, v, do, dlse = flash_inputs(np.random.default_rng(seed), B, S, S,
                                     Hh, Kd, dt, device)
    o, lse, o32 = fa.flash_fwd(q, k, v, causal, scale, with_o32=True)
    o_bwd = o32 if Kd in fa.O32_HEAD_DIMS else o
    delta = fa.reference_flash_delta(o_bwd, do)
    n = B * S * Hh * Kd                      # elements of one operand
    rowvec = B * S * Hh * 4                  # one fp32 row vector
    pairs = B * Hh * (S * (S + 1) // 2 if causal else S * S)
    plain_iters = 5 if S * S * Hh * B <= 1 << 27 else 2
    shape = (f"B={B} S=T={S} H={Hh} K={Kd} bf16 "
             f"{'causal' if causal else 'non-causal'}")
    timings = {}
    plan = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, scale),
                      lambda: fa.reference_flash_fwd(q, k, v, causal, scale),
                      4 * n * item + rowvec, 2 * 2 * Kd * pairs),
        # one multiply-add per element, in fp32 on the CUDA cores
        "flash_delta": (lambda: fa.flash_delta(o_bwd, do),
                        lambda: fa.reference_flash_delta(o_bwd, do),
                        n * (item + o_bwd.element_size()) + rowvec, 2 * n),
        "flash_dq": (
            lambda: fa.flash_dq(q, k, v, do, lse, delta, causal, scale),
            lambda: fa.reference_flash_dq(q, k, v, do, lse, delta, causal,
                                          scale),
            5 * n * item + 2 * rowvec, 3 * 2 * Kd * pairs),
        "flash_dkv": (
            lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal, scale),
            lambda: fa.reference_flash_dkv(q, k, v, do, lse, delta, causal,
                                           scale),
            6 * n * item + 2 * rowvec, 4 * 2 * Kd * pairs)}
    for name, (kern, plain, nbytes, flops) in plan.items():
        ms, ms_events = kernel_ms(kern)
        plain_ms = cuda_time_ms(plain, iters=plain_iters, warmup=1)
        bms, by = bound_ms(nbytes, flops, FP32_FLOPS if name == "flash_delta"
                           else BF16_FLOPS)
        timings[name] = dict(ms=ms, ms_events=ms_events, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, bytes=nbytes,
                             flops=flops, check=res[name], shape=shape)
    # SDPA on [B, H, S, K] copies: a yardstick, never called by the port.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    with torch.no_grad():
        sdpa_fwd, sdpa_fwd_events = kernel_ms(sdpa)
    timings["flash_fwd"]["library_ms"] = sdpa_fwd
    timings["flash_fwd"]["library_ms_events"] = sdpa_fwd_events
    refs = (fa.reference_flash_dq(q, k, v, do, lse, delta, causal, scale),
            *fa.reference_flash_dkv(q, k, v, do, lse, delta, causal, scale))
    aten_bwd, aten_check = aten_flash_backward(qt, kt, vt, dot, scale, refs,
                                               causal)
    aten_ms, aten_events = kernel_ms(aten_bwd)
    sdpa_bwd, sdpa_check = sdpa_backward(qt, kt, vt, dot, scale, refs, causal)
    sdpa_bwd_ms, sdpa_bwd_events = kernel_ms(sdpa_bwd)
    lib_bwd_ms, lib_bwd_events, lib_call = min(
        (aten_ms, aten_events, "aten_flash_backward"),
        (sdpa_bwd_ms, sdpa_bwd_events, "sdpa_autograd_backward"))
    delta_ms = timings["flash_delta"]["ms"]
    timings["flash_dq"].update(
        library_ms=lib_bwd_ms, library_ms_events=lib_bwd_events,
        library_call=lib_call, library_covers=list(BWD_PAIR),
        covered_ms=delta_ms + timings["flash_dq"]["ms"]
        + timings["flash_dkv"]["ms"])
    for name in ("flash_delta", "flash_dkv"):
        timings[name].update(library_ms=None, library_see="flash_dq")
    ctx = dict(q=q, k=k, v=v, do=do, o=o_bwd, dlse=dlse, lse=lse,
               delta=delta, scale=scale,
               qt=qt, kt=kt, vt=vt, dot=dot, sdpa=sdpa, sdpa_fwd=sdpa_fwd,
               aten_ms=aten_ms, aten_check=aten_check,
               sdpa_bwd_ms=sdpa_bwd_ms, sdpa_check=sdpa_check,
               sdpa_bwd_kernels=kernel_names(sdpa_bwd), delta_ms=delta_ms)
    return timings, ctx


def time_flash(device, errs, at_shapes):
    """Each flash kernel at the training step's shape, [8, 1024, 12, 64]
    bf16 causal (`flash_shape_timings`), with a dropped key tile planted
    in the plain dq, dk and dv, which must fail the bf16 bound, and a
    dropped dlse and dropped columns in the plain delta, which must fail
    its bound (`planted_delta_faults`), and the device time of the
    forward plus backward beside SDPA's; then the four at gptj_6b's
    heads, [2, 1024, 16, 256] bf16 causal, with the same faults planted
    (``at_shapes``; gpt2_2_7b's and gptj_6b's training shapes are timed by
    their training phases)."""
    B, S, Hh, Kd = FLASH_SHAPE
    timings, c = flash_shape_timings(device, errs, "training shape", B, S,
                                     Hh, Kd, True, 5)
    q, k, v, do, scale = c["q"], c["k"], c["v"], c["do"], c["scale"]
    planted = planted_flash_faults(q, k, v, do, c["lse"], c["delta"], scale)
    planted["flash_delta"] = planted_delta_faults(c["o"], do, c["dlse"])
    # Forward plus backward launches several kernels from the host (SDPA's
    # through autograd), so their gaps depend on the host's speed: compare
    # the device time of their kernels instead.
    sdpa_fwd_bwd = device_ms(
        lambda: torch.autograd.grad(c["sdpa"](), (c["qt"], c["kt"], c["vt"]),
                                    c["dot"]))
    ours = device_ms(lambda: fa.flash_bwd(
        q, k, v, *fa.flash_fwd(q, k, v, True, scale), do, None, True, scale))
    fa.reset_launch_counts()
    emit({"phase": "flash_kernel_timing", **timings,
          "planted_faults_vs_bf16_bound": planted,
          "fwd_dq_dkv_device_ms": ours, "sdpa_fwd_ms": c["sdpa_fwd"],
          "sdpa_fwd_bwd_device_ms": sdpa_fwd_bwd,
          "aten_flash_backward_ms": c["aten_ms"],
          "aten_flash_backward_vs_plain": c["aten_check"],
          "sdpa_backward_ms": c["sdpa_bwd_ms"],
          "sdpa_backward_vs_plain": c["sdpa_check"],
          "sdpa_backward_kernels": c["sdpa_bwd_kernels"],
          "flash_delta_ms": c["delta_ms"],
          "note": "fwd_dq_dkv_device_ms: the kernels of flash_fwd, delta, "
                  "flash_dq and flash_dkv, against those of SDPA (is_causal)"
                  " forward plus backward; sdpa_backward_ms: the backward "
                  "of SDPA's graph alone (autograd.grad, retain_graph); "
                  "aten_flash_backward_ms: aten's _scaled_dot_product_flash"
                  "_attention_backward alone; the faster is flash_dq's "
                  "library_ms, which covers flash_delta, flash_dq and "
                  "flash_dkv (covered_ms: their times summed), and "
                  "flash_dkv's and flash_delta's library_ms are null; "
                  "flash_delta_ms: the port's delta kernel alone; device "
                  "time per call (device_ms)"})
    gptj, c = flash_shape_timings(device, errs, "gptj_6b heads", 2, 1024,
                                  *HEADS_GPTJ, True, 17)
    at_shapes["gptj_6b [2, 1024, 16, 256]"] = gptj
    planted = planted_flash_faults(c["q"], c["k"], c["v"], c["do"], c["lse"],
                                   c["delta"], c["scale"])
    planted["flash_delta"] = planted_delta_faults(c["o"], c["do"], c["dlse"])
    emit({"phase": "flash_kernel_timing_gptj", **gptj,
          "planted_faults_vs_bf16_bound": planted})
    return timings


ATEN_BWD_REL = 2e-2   # the library backward against the plain versions
# The port's backward kernels, which one library call does together.
BWD_PAIR = ("flash_delta", "flash_dq", "flash_dkv")


def hold_to_plain(label, grads, refs):
    """The relative error of each whole gradient (dq, dk, dv as
    [B, H, S, K]) against the plain versions ``refs`` ([B, S, H, K]);
    raises past ATEN_BWD_REL."""
    check = {}
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        ref = ref.float()
        rel = float((g.transpose(1, 2).float() - ref).norm() / ref.norm())
        check[name] = rel
        if not rel <= ATEN_BWD_REL:
            raise AssertionError(f"{label} {name} is {rel} off the plain "
                                 "version")
    return check


def sdpa_backward(qt, kt, vt, dot, scale, refs, causal=True):
    """The backward of SDPA's own graph (is_causal, the same scale) on
    [B, H, S, K] copies, whichever backend SDPA picks: the forward runs
    once, and the call is torch.autograd.grad over its graph, kept for
    every call. A yardstick only, held once to the plain versions like
    `aten_flash_backward`. → (the call, the check's numbers)."""
    qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         scale=scale)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return call, hold_to_plain("SDPA backward", call(), refs)


def kernel_names(fn):
    """The names of the device kernels one call of fn launches (read
    from torch.profiler; names only, no times)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:100] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def aten_flash_backward(qt, kt, vt, dot, scale, refs, causal=True):
    """aten's flash backward (``_scaled_dot_product_flash_attention_
    backward``) on [B, H, S, K] copies, with out, lse and the philox
    arguments of aten's causal flash forward at the same scale: a
    yardstick only, the port never calls it. Its dq, dk and dv are held
    once, loosely, to the plain versions ``refs`` ([B, S, H, K]: the
    relative error of each whole gradient <= ATEN_BWD_REL) so that the
    yardstick is known to compute the same function. → (the call, the
    check's numbers)."""
    qt, kt, vt = (x.detach() for x in (qt, kt, vt))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, causal, False, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]

    def call():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0,
            causal, seed, offset, scale=scale)

    return call, hold_to_plain("aten flash backward", call(), refs)


def old_library(old_dir):
    """The kernels of an older checkout (``old_dir``/ray_tpu_torch/ops/
    csrc) built by nvcc into build/ab/libkernels_old.so, one nvcc per
    source in parallel, with this tree's C ABI (unchanged since the
    decode's split-K redesign but for rtt_flash_fwd's o32 argument, which
    ``fwd_o32`` says the checkout has; ``prefill_every_ps`` says whether
    its bf16 prefill takes tensor maps at every page size, ``has_delta``
    whether it has the delta kernel, ``dq_key_tile`` its dq's key tile)."""
    src = os.path.join(old_dir, "ray_tpu_torch", "ops", "csrc")
    out = os.path.join("build", "ab")
    os.makedirs(out, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for name in sorted(os.listdir(src)):
        if name.endswith(".cu"):
            objs.append(os.path.join(out, name[:-3] + ".o"))
            procs.append(subprocess.Popen(
                [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-c",
                 os.path.join(src, name), "-o", objs[-1]]))
    if any(p.wait() for p in procs):
        raise RuntimeError(f"nvcc failed on {src}")
    lib_path = os.path.join(out, "libkernels_old.so")
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", lib_path,
                    *objs], check=True)
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    lib.has_delta = hasattr(lib, "rtt_flash_delta")
    if not lib.has_delta:   # a checkout whose delta was torch ops
        lib.rtt_flash_delta = types.SimpleNamespace()
    _build._declare(lib)
    with open(os.path.join(src, "flash_fwd.cu")) as f:
        lib.fwd_o32 = "void* o32" in f.read()
    with open(os.path.join(src, "paged_prefill.cu")) as f:
        # a checkout whose bf16 prefill is wgmma at every page size
        lib.prefill_every_ps = "prefill_box_rows" in f.read()
    with open(os.path.join(src, "flash_bwd.cu")) as f:
        # a checkout whose bf16 dq walks 32-key tiles at head dim 256
        dq32 = "KD == 256 ? 32" in f.read()
    lib.dq_key_tile = lambda K: 32 if dq32 and K == 256 else pa.key_tile(K)
    if not lib.fwd_o32:   # a checkout from before rtt_flash_fwd took o32
        argtypes = lib.rtt_flash_fwd.argtypes
        lib.rtt_flash_fwd.argtypes = argtypes[:6] + argtypes[7:]
    return lib


def old_decode(old, q, kp, vp, tables, lengths, sc):
    """The older checkout's decode entry point on its library, called as
    `paged_attention` calls this tree's (the same checks, split count,
    workspace and arrival counters), without the launch counters."""
    quant = pa._quantized(kp, vp, sc.get("k_scale"), sc.get("v_scale"))
    B, Hh, Kd = q.shape
    ps = pa._check_shapes(q, kp, vp, Hh, Kd)
    n_pg = tables.shape[1]
    tables, lengths = pa._cuda_operands(
        q, kp, vp, (("tables", tables), ("lengths", lengths)), quant)
    out = torch.empty_like(q)
    n_split = pa.decode_splits(B, Hh, n_pg, pa._sm_count(q.device))
    stream = torch.cuda.current_stream().cuda_stream
    ws = counters = None
    if n_split > 1:
        ws = torch.empty(n_split * B * Hh * (Kd + 2), dtype=torch.float32,
                         device=q.device)
        counters = pa._decode_counters(
            q.device, stream, B * -(-Hh // pa.DECODE_HEAD_GROUP))
    common = (tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
              pa._ptr(ws), pa._ptr(counters), B, Hh, Kd, ps, n_pg,
              kp.shape[0], n_split, float(1 / np.sqrt(Kd)), stream)
    code = pa._DTYPE_CODES[q.dtype]
    if quant:
        ks, vs = pa._scale_operands(q.device, sc["k_scale"], sc["v_scale"])
        rc = old.rtt_paged_decode_attention_int8(
            code, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), *common)
    else:
        rc = old.rtt_paged_decode_attention(
            code, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *common)
    _build.check(rc, "old decode")
    return out


def add_bwd_ab_cases(old, device, rng, tag, shape, cases, bound_sums,
                     shares, bwd):
    """phase_ab's delta, dq and dkv cases at one bf16 causal shape (T = S)
    on seeded inputs: delta on the o the training path reads (fp32 at
    `fa.O32_HEAD_DIMS`), dq and dkv from the plain delta, so that the old
    and the new kernels read the same bits; and, but for the ragged case,
    the library backward's device time into ``bwd``."""
    B, S, Hh, Kd = shape
    q, k, v, do, _dl = flash_inputs(rng, B, S, S, Hh, Kd, torch.bfloat16,
                                    device)
    scale = 1.0 / np.sqrt(Kd)
    o, lse, o32 = fa.flash_fwd(q, k, v, True, scale, with_o32=True)
    o_bwd = o32 if Kd in fa.O32_HEAD_DIMS else o
    delta = fa.reference_flash_delta(o_bwd, do)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def delta_old():
        if not old.has_delta:      # the older checkout's torch ops
            return fa.reference_flash_delta(o_bwd, do)
        out = torch.empty(B, S, Hh, device=device, dtype=torch.float32)
        rows = fa._rows(do, o_bwd, do)
        _build.check(old.rtt_flash_delta(
            pa._DTYPE_CODES[do.dtype], pa._DTYPE_CODES[o_bwd.dtype],
            do.data_ptr(), o_bwd.data_ptr(), None, out.data_ptr(), B, S, Hh,
            Kd, ctypes.addressof(rows), stream()), "old flash_delta")
        return out

    def dq_old():
        dq = torch.empty_like(q)
        rows = fa._rows(q, k, v, do, dq)
        kt = old.dq_key_tile(Kd)
        maps = pa._c_array(fa._maps((q, pa.WGMMA_ROWS), (k, kt), (v, kt),
                                    (do, pa.WGMMA_ROWS)))
        _build.check(old.rtt_flash_dq(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, S, Hh, Kd,
            ctypes.addressof(rows), 1, float(scale), ctypes.addressof(maps),
            stream()), "old flash_dq")
        return dq

    def dkv_old():
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rows = fa._rows(q, k, v, do, dk, dv)
        maps = pa._c_array(fa.flash_dkv_plan(q, k, v, do))
        _build.check(old.rtt_flash_dkv(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, S, Hh, Kd, ctypes.addressof(rows), 1, float(scale),
            ctypes.addressof(maps), stream()), "old flash_dkv")
        return dk, dv

    args = (q, k, v, do, lse, delta, True, scale)
    cases[f"flash_delta{tag}"] = (
        delta_old, lambda: fa.flash_delta(o_bwd, do),
        lambda: fa.reference_flash_delta(o_bwd, do))
    shares[f"flash_delta{tag}"] = lambda x, ref: delta_share(x, ref, o_bwd,
                                                             do, None)
    cases[f"flash_dq{tag}"] = (dq_old, lambda: fa.flash_dq(*args),
                               lambda: fa.reference_flash_dq(*args))
    cases[f"flash_dkv{tag}"] = (dkv_old, lambda: fa.flash_dkv(*args),
                                lambda: fa.reference_flash_dkv(*args))
    sums = flash_abs_sums(*args)
    bound_sums[f"flash_dq{tag}"] = sums["flash_dq"]
    bound_sums[f"flash_dkv{tag}"] = torch.stack((sums["flash_dk"],
                                                 sums["flash_dv"]))
    if tag == " ragged":
        return
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    refs = (fa.reference_flash_dq(*args), *fa.reference_flash_dkv(*args))
    aten_bwd, _ = aten_flash_backward(qt, kt, vt, dot, scale, refs)
    sdpa_bwd, _ = sdpa_backward(qt, kt, vt, dot, scale, refs)
    bwd[tag] = {"library_ms": min(device_ms(aten_bwd), device_ms(sdpa_bwd)),
                "shape": f"B={B} S=T={S} H={Hh} K={Kd} bf16 causal"}


# The backward's A/B shapes ([B, S, H, K], T = S, bf16 causal): the
# training step's, gpt2_2_7b's and gptj_6b's, and S = T = 1,000 at 256,
# whose ragged edges every output must also hold the bound on (its 128
# heads' walked rows, as gptj_6b's, outgrow the L2: dq and dkv take their
# items in pairs by head group there).
AB_BWD_SHAPES = (("", FLASH_SHAPE), (" gpt2_2_7b", (8, 1024, *HEADS_2_7B)),
                 (" gptj_6b", (8, 1024, *HEADS_GPTJ)),
                 (" ragged", (8, 1000, *HEADS_GPTJ)))


def phase_ab(device, old_dir):
    """The kernels against an older checkout's, at the timed shapes, by
    device time in turns (old, new, new, old) in one process: the bf16
    flash forward at [8, 1024, 12, 64] causal; delta, dq and dkv at each
    of `AB_BWD_SHAPES` (the older checkout's delta: its kernel, or the
    torch ops of the plain version where it has none), their sum beside
    the library backward, and whether each old gradient is bitwise the
    new one; the paged
    prefill (16 slots x C 256 at offset 768, 1024-token contexts, ps 64,
    H 32, K 64; and at `PS_PREFILL_CASES`' and `AB_PS64_CASES`' page sizes
    and heads) and the
    paged decode (16 slots of 1024 positions, and at light load) on a
    bf16 and on an int8 pool; for the decode also the wrapper's host µs
    per call, the parent's wrapper (`old_decode`) against the new one.
    Each old output is held to the new one's plain version first (delta
    to its bound; dq, dkv, the decode and the page-size prefill cases:
    the bf16 bound must hold)."""
    old = old_library(old_dir)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    B, S, Hh, Kd = FLASH_SHAPE
    q, k, v, _do, _dl = flash_inputs(rng, B, S, S, Hh, Kd, torch.bfloat16,
                                     device)
    scale = 1.0 / np.sqrt(Kd)

    def flash_old():
        o = torch.empty_like(q)
        lse = torch.empty(B, S, Hh, device=device, dtype=torch.float32)
        rows = fa._rows(q, k, v, o)
        maps = pa._c_array(fa.flash_plan(q, k, v))
        o32 = (None,) if old.fwd_o32 else ()
        _build.check(old.rtt_flash_fwd(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *o32, B, S, S, Hh, Kd, ctypes.addressof(rows), 1,
            float(scale), ctypes.addressof(maps), stream()), "old flash_fwd")
        return o

    cases = {
        "flash_fwd": (flash_old, lambda: fa.flash_fwd(q, k, v, True, scale)[0],
                      lambda: fa.reference_flash_fwd(q, k, v, True, scale)[0]),
    }
    bound_sums, shares, bwd = {}, {}, {}
    for tag, shape in AB_BWD_SHAPES:
        add_bwd_ab_cases(old, device, rng, tag, shape, cases, bound_sums,
                         shares, bwd)
    T, C, ps = 1024, 256, 64
    n_pg = T // ps

    def prefill_old(qp, kp, vp, args, sc):
        """The older checkout's prefill entry point: tensor maps at every
        page size (``prefill_every_ps``), or at the page sizes its TMA
        rule took (a divisor of 64 that is a multiple of 8, or a multiple
        of 64) and none (its mma.sync kernel) at others."""
        B, Cq, Hh, Kd = qp.shape
        ps = kp.shape[1]
        out = torch.empty_like(qp)
        ptrs = [qp.data_ptr(), kp.data_ptr(), vp.data_ptr()]
        if sc:
            ptrs += [sc["k_scale"].data_ptr(), sc["v_scale"].data_ptr()]
        fn = (old.rtt_paged_prefill_attention_int8 if sc
              else old.rtt_paged_prefill_attention)
        tma = old.prefill_every_ps or (
            ps % 8 == 0 and (64 % ps == 0 or ps % 64 == 0))
        maps = pa._c_array(pa.prefill_plan(qp, kp, vp).maps) if tma else None
        _build.check(fn(1, *ptrs, *(a.data_ptr() for a in args),
                        out.data_ptr(), B, Cq, Hh, Kd, ps, args[0].shape[1],
                        float(1 / np.sqrt(Kd)), pa._addr(maps), stream()),
                     "old prefill")
        return out

    def prefill_case(name, qp, kp, vp, args, sc):
        cases[name] = (
            lambda: prefill_old(qp, kp, vp, args, sc),
            lambda: pa.paged_prefill_attention(qp, kp, vp, *args, **sc),
            lambda: pa.reference_paged_prefill_attention(qp, kp, vp, *args,
                                                         **sc))

    for quant in (False, True):
        kp, vp, tables, lens, sc = paged_pool(
            rng, [T] * 16, ps=ps, n_pg=n_pg, dtype=torch.bfloat16,
            device=device, quant=quant)
        qp = torch.from_numpy(rng.normal(size=(16, C, H, K)).astype(
            np.float32)).to(device, torch.bfloat16)
        args = [torch.from_numpy(a).to(device) for a in (
            tables, np.full(16, T - C, np.int32), lens)]
        prefill_case("paged_prefill_attention" + ("_int8" if quant else ""),
                     qp, kp, vp, args, sc)
    # The prefill at the page sizes the older checkout ran on its mma.sync
    # kernel (`PS_PREFILL_CASES`) and at ps 64 at the other head dims
    # (`AB_PS64_CASES`), each output held to the bf16 bound.
    for tag, heads, ps_case, C_case, off in PS_PREFILL_CASES + AB_PS64_CASES:
        for quant in (False, True):
            qp, kp, vp, args, sc = prefill_case_at(
                rng, device, heads, ps_case, C_case, off, quant)
            name = ("paged_prefill_attention" + ("_int8" if quant else "")
                    + f" {tag}")
            prefill_case(name, qp, kp, vp, args, sc)
            bound_sums[name] = abs_v_attention(
                pa.reference_paged_prefill_attention, qp, kp, vp, *args,
                **sc)
    # The paged decode, float and int8 pools, at the timed shape (16 slots
    # of 1024 positions) and at light load (`light_load_case`).
    for quant in (False, True):
        kp, vp, tables, lens, sc = paged_pool(
            rng, [T] * 16, ps=ps, n_pg=n_pg, dtype=torch.bfloat16,
            device=device, heads=(H, K), quant=quant)
        qd = torch.from_numpy(rng.normal(size=(16, H, K)).astype(
            np.float32)).to(device, torch.bfloat16)
        timed = (qd, kp, vp, *(torch.from_numpy(a).to(device)
                               for a in (tables, lens)), sc)
        light = light_load_case(rng, device, quant=quant)[:6]
        for shape, (qd, kp, vp, tb, ln, sc) in (("", timed),
                                                 ("_light_load", light)):
            name = "paged_attention" + ("_int8" if quant else "") + shape
            cases[name] = (
                lambda a=(qd, kp, vp, tb, ln, sc): old_decode(old, *a),
                lambda a=(qd, kp, vp, tb, ln), sc=sc: pa.paged_attention(
                    *a, **sc),
                lambda a=(qd, kp, vp, tb, ln), sc=sc:
                    pa.reference_paged_attention(*a, **sc))
            bound_sums[name] = abs_v_attention(
                pa.reference_paged_attention, qd, kp, vp, tb, ln, **sc)
    out = {"phase": "ab_old_vs_new", "old": old_dir,
           "order": "old, new, new, old; device ms per call (device_ms); "
                    "decode also the wrapper's host µs per call"}
    # dkv's (dk, dv) are held as one tensor; the timed calls stack nothing.
    one = lambda x: (torch.stack(x) if isinstance(x, tuple) else x).float()
    for name, (fn_old, fn_new, plain) in cases.items():
        ref = one(plain())
        outs = {"old": one(fn_old()), "new": one(fn_new())}
        err = {tag: float((x - ref).abs().max()) for tag, x in outs.items()}
        res = {"max_abs_err_vs_plain": err}
        if name.startswith(("flash_dq", "flash_dkv")):
            res["bitwise_equal_old"] = torch.equal(outs["old"], outs["new"])
            res["max_abs_diff_old"] = float(
                (outs["old"] - outs["new"]).abs().max())
        if name in shares:
            share = {tag: shares[name](x, ref) for tag, x in outs.items()}
            res["max_share_of_bound"] = share
            if max(share.values()) > 1.0:
                raise AssertionError(f"A/B {name} off its plain version: "
                                     f"{share}")
        if name in bound_sums:
            share = {tag: float(share_of_bound(x, ref, bound_sums[name]))
                     for tag, x in outs.items()}
            res["max_share_of_bf16_bound"] = share
            if max(share.values()) > 1.0:
                raise AssertionError(f"A/B {name} off its plain version: "
                                     f"{share}")
        turns = [device_ms(f) for f in (fn_old, fn_new, fn_new, fn_old)]
        out[name] = {"old_ms": [turns[0], turns[3]],
                     "new_ms": [turns[1], turns[2]],
                     "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2]),
                     **res}
        if name.startswith("paged_attention"):
            us = [host_us(f) for f in (fn_old, fn_new, fn_new, fn_old)]
            out[name]["host_us"] = {"old": [us[0], us[3]],
                                    "new": [us[1], us[2]]}
    # delta + dq + dkv per shape, each side the mean of its two turns.
    mean = lambda xs: sum(xs) / len(xs)
    for tag, library in bwd.items():
        parts = [out[f"{kern}{tag}"] for kern in BWD_PAIR]
        out[f"delta+dq+dkv{tag}"] = {
            "old_ms": sum(mean(p["old_ms"]) for p in parts),
            "new_ms": sum(mean(p["new_ms"]) for p in parts), **library}
    emit(out)


def make_params(device):
    """opt_1_3b's fp32 masters from seed 0 and their bf16 serving copy:
    the int8 runs quantize the same masters."""
    cfg = gpt.GPTConfig.opt_1_3b(dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    masters = gpt.init_params(cfg, gen, device)
    return cfg, masters, pk.serving_params(cfg, masters, device)


def run_programs(device, cfg, params, pool, impl):
    """On a copy of ``pool``: one prefill_chunk_paged dispatch (rows: 256
    tokens at offset 0, 200 at 256, 17 at 0, an inert row), one
    decode_step_paged, one verify_chunk_paged (k+1 rows at the cursors
    after it, of 5, 3 and 1 valid tokens, and the inert row), then
    spec_draft_propose with the model as its own draft (budgets k, 2, 0
    and -1, temperature 1, a generator seeded 0) → per program the live
    rows' fp32 logits, for the propose loop (proposals [k, 3], log of the
    probability rows [k, 3, V])."""
    rng = np.random.default_rng(2)
    ps, width = pool["k"].shape[2], 8
    tables = np.zeros((4, width), np.int32)
    tables[:3] = np.arange(1, 3 * width + 1).reshape(3, width)
    offsets = np.array([0, 256, 0, 0], np.int32)
    n_valid = np.array([256, 200, 17, 0], np.int32)
    toks = rng.integers(1, cfg.vocab_size, size=(4, 256)).astype(np.int32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    p = {k: v.clone() for k, v in pool.items()}
    lg, _ = pk.prefill_chunk_paged(cfg, params, dev(toks), p, dev(tables),
                                   dev(offsets), dev(n_valid), attn_impl=impl)
    cursor = (offsets + n_valid).astype(np.int32)
    lg2, _ = pk.decode_step_paged(cfg, params, dev(toks[:, 0]), p,
                                  dev(cursor), dev(tables), attn_impl=impl)
    vtoks = toks[:, 1:SPEC_K + 2]
    v_valid = np.array([SPEC_K + 1, 3, 1, 0], np.int32)
    lg3, _ = pk.verify_chunk_paged(cfg, params, dev(vtoks), p, dev(tables),
                                   dev(cursor + 1), dev(v_valid),
                                   attn_impl=impl)
    props, probs, _ = pk.spec_draft_propose(
        cfg, params, dev(toks[:, 2]), p, dev(cursor + 1), dev(tables),
        dev(np.array([SPEC_K, 2, 0, -1], np.int32)),
        torch.ones(4, device=device),
        torch.Generator(device=device).manual_seed(0), k=SPEC_K,
        attn_impl=impl, need_probs=True)
    torch.cuda.synchronize()
    live = torch.cat([lg3[i, :int(n)] for i, n in enumerate(v_valid[:3])])
    return (lg[:3].float(), lg2[:3].float(), live.float(),
            (props[:, :3], probs[:, :3].clamp(min=1e-30).log()))


PROGRAM_NAMES = ("prefill_chunk_paged", "decode_step_paged",
                 "verify_chunk_paged", "spec_draft_propose")


def logit_diff(a, b, vocab):
    if not (torch.isfinite(a).all() and a.dim() == 2 and a.shape[1] == vocab
            and len(a)):
        raise AssertionError(f"bad logits {tuple(a.shape)}")
    return {"logit_mae": float((a - b).abs().mean()),
            "logit_max_abs": float((a - b).abs().max()),
            "logit_mean_abs": float(b.abs().mean()),
            "argmax_equal": int((a.argmax(-1) == b.argmax(-1)).sum()),
            "rows": len(a)}


def program_diff(name, a, b, vocab):
    """`logit_diff` of one program's outputs. The propose loop's: its log-
    probability rows, at each row's steps up to and including the first
    where the two runs' proposals differ (the steps after it have other
    inputs), beside the count of equal proposals."""
    if name != "spec_draft_propose":
        return logit_diff(a, b, vocab)
    (pa_, la), (pb, lb) = a, b
    same = (pa_ == pb).int()
    upto = torch.cat([torch.ones_like(same[:1]), same[:-1]]).cumprod(0) > 0
    res = logit_diff(la[upto], lb[upto], vocab)
    res["proposals_equal"] = int(same.sum())
    res["proposals"] = same.numel()
    return res


def phase_programs(device, cfg, params):
    pool = pk.init_paged_kv(cfg, 32, 64, device=device)
    logits = {impl: run_programs(device, cfg, params, pool, impl)
              for impl in ("kernel", "gather")}
    out = {"phase": "programs", "config": "opt_1_3b bf16 24 layers",
           "mae_bound": PROGRAM_LOGIT_MAE}
    for i, name in enumerate(PROGRAM_NAMES):
        out[name] = program_diff(name, logits["kernel"][i],
                                 logits["gather"][i], cfg.vocab_size)
        if out[name]["logit_mae"] > PROGRAM_LOGIT_MAE:
            raise AssertionError(f"{name}: kernel vs gather logit MAE "
                                 f"{out[name]['logit_mae']} > "
                                 f"{PROGRAM_LOGIT_MAE}")
    emit(out)


def first_page_nulled(fn):
    """A planted fault in a paged-attention wrapper: every slot's first
    page read from the null page instead (in every layer)."""
    def wrong(q, k_pool, v_pool, tables, *args, **kw):
        tables = tables.clone()
        tables[:, 0] = 0
        return fn(q, k_pool, v_pool, tables, *args, **kw)
    return wrong


def phase_programs_int8(device, cfg, masters, served):
    """The int8 programs at full width: int8 weights quantized from the
    masters, copies of one int8 pool, "kernel" against "gather", held to
    PROGRAM_INT8_LOGIT_MAE, which a planted fault (each slot's first page
    read from the null page, in every layer) must exceed; then, as a
    fidelity reading with no limit, int8 weights against the bf16 weights
    of the same masters (both on the int8 pool, kernel path)."""
    w8 = pk.serving_params(cfg, gpt.quantize_params(masters), device)
    pool = pk.init_paged_kv(cfg, 32, 64, kv_dtype="int8", device=device)
    logits = {impl: run_programs(device, cfg, w8, pool, impl)
              for impl in ("kernel", "gather")}
    real = pk.paged_attention, pk.paged_prefill_attention
    pk.paged_attention, pk.paged_prefill_attention = map(first_page_nulled,
                                                         real)
    try:
        faulty = run_programs(device, cfg, w8, pool, "kernel")
    finally:
        pk.paged_attention, pk.paged_prefill_attention = real
    bf16_w = run_programs(device, cfg, served, pool, "kernel")
    out = {"phase": "programs_int8",
           "config": "opt_1_3b bf16 24 layers, int8 weights, int8 KV",
           "mae_bound": PROGRAM_INT8_LOGIT_MAE,
           "planted_fault": "each slot's first page read from the null page"}
    for i, name in enumerate(PROGRAM_NAMES):
        ref = logits["gather"][i]
        out[name] = {
            **program_diff(name, logits["kernel"][i], ref, cfg.vocab_size),
            "planted_fault_logit_mae": program_diff(
                name, faulty[i], ref, cfg.vocab_size)["logit_mae"],
            "int8_vs_bf16_weights": program_diff(
                name, logits["kernel"][i], bf16_w[i], cfg.vocab_size)}
        if out[name]["logit_mae"] > PROGRAM_INT8_LOGIT_MAE:
            raise AssertionError(f"{name}: int8 kernel vs gather logit MAE "
                                 f"{out[name]['logit_mae']} > "
                                 f"{PROGRAM_INT8_LOGIT_MAE}")
        if out[name]["planted_fault_logit_mae"] <= PROGRAM_INT8_LOGIT_MAE:
            raise AssertionError(f"{name}: the planted fault passes: {out}")
    emit(out)
    del w8
    torch.cuda.empty_cache()


KERNEL_CATEGORIES = (       # first match wins, on the lower-cased name
    ("port kernels", ("rtt::",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("copy / cast", ("copy",)),
    ("reduction / softmax / loss", ("reduce", "softmax", "nll", "norm")),
    ("index / scatter", ("index", "scatter", "gather", "embedding")),
    ("elementwise", ("elementwise",)),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for cat, keys in KERNEL_CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _profiled(fn, top=8):
    """Run fn once without and once under torch.profiler: wall time of
    the plain run (host clock around a synchronized run), the summed time
    of the device's kernels in the profiled one, the device's idle share
    of the plain wall time, and the top kernels by device time and ops by
    host self time. Only kernel events count toward device time: an aten
    op's own device time is that of its kernels, which would count them
    twice."""
    fn()                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_us = sum(dev_us(e) for e in kernels)
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]

    def table(events, ms):
        # Names are cut to 80 characters; events whose cut names collide
        # (template instances of one kernel) are summed.
        out: dict = {}
        for e in events:
            out[e.key[:80]] = out.get(e.key[:80], 0.0) + ms(e)
        return out

    by_cat: dict = {}
    for e in kernels:
        cat = kernel_category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us(e) / 1e3
    return {
        "wall_ms": wall_plain * 1e3,
        "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_ms_by_category": by_cat,
        "device_idle_share": (1.0 - busy_us / 1e3 / (wall_plain * 1e3)
                              if busy_us else None),
        "top_device_ms": table(by_dev, lambda e: dev_us(e) / 1e3),
        "top_host_ms": table(by_cpu, lambda e: e.self_cpu_time_total / 1e3),
        "host_op_calls": sum(e.count for e in ev
                             if e.key.startswith("aten::")),
    }


def large_copies(fn, min_numel):
    """aten::copy_ calls under fn whose source holds >= min_numel
    elements (a copy of a whole cache plane, e.g. a permute made
    contiguous), counted by torch.profiler with shapes recorded."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.name == "aten::copy_" and e.input_shapes
               and int(np.prod(e.input_shapes[0])) >= min_numel)


def dense_window_profile(cfg, params, toks, pos, temps, gen, device):
    """The dense engine's fused window beside the paged one: decode_multi
    (k = 8) over a [16, 2048] dense cache with every slot at ``pos``
    (1008), profiled as `_profiled` does (its device busy time beside
    the paged window's, by the same clock), and the count of whole-cache
    copies made by one decode_step (0 when the scores' and P.V's matmuls read the cache in
    place, n_layers x 2 if each made its plane contiguous)."""
    B = toks.shape[0]
    cache = dec.init_kv_cache(cfg, B, CAP, device=device)
    run = lambda: dec.decode_multi(cfg, params, toks, cache, pos, 8, temps,
                                   gen)
    rec = _profiled(run)
    rec["per_step_wall_ms"] = rec["wall_ms"] / 8
    plane = B * CAP * cfg.n_heads * cfg.head_dim
    rec["cache_plane_copies_per_step"] = large_copies(
        lambda: dec.decode_step(cfg, params, toks, cache, pos), plane // 2)
    rec["cache_bytes"] = 2 * plane * cache["k"].element_size() \
        * cfg.n_layers
    rec["cache_bytes_per_step_ms_at_hbm_rate"] = (
        rec["cache_bytes"] / HBM_BYTES_PER_S * 1e3)
    del cache
    torch.cuda.empty_cache()
    return rec


def phase_profile(device, cfg, masters, params):
    """Where the time goes in the engine's two dispatches at the engine
    phase's shapes: one fused decode window (k=8, 16 slots at 1024-token
    contexts) and one prefill dispatch (16 rows x 256, two live rows);
    then the decode window's device time with int8 weights (quantized
    from the same masters) against bf16 weights, on the float pool and
    with the int8 pool, and the window's K/V writes alone into each pool
    (the float pool's index_put against the int8 pool's _quant_write);
    and the dense engine's window at the same slots and positions
    (`dense_window_profile`). Cut to CUT_DEPTH layers."""
    cfg, (params, masters) = first_layers(cfg, (params, masters), CUT_DEPTH)
    B, T, ps = 16, 1024, 64
    n_pg = T // ps
    pool = pk.init_paged_kv(cfg, B * n_pg, ps, device=device)
    tables = torch.arange(1, B * n_pg + 1, dtype=torch.int32,
                          device=device).reshape(B, n_pg)
    toks = torch.ones(B, dtype=torch.int32, device=device)
    pos = torch.full((B,), T - 16, dtype=torch.int32, device=device)
    temps = torch.zeros(B, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def window(weights, kv):
        return lambda: pk.decode_multi_paged(
            cfg, weights, toks, kv, pos, tables, 8, temps, gen,
            attn_impl="kernel")

    decode = _profiled(window(params, pool))
    decode["per_step_wall_ms"] = decode["wall_ms"] / 8
    dense = dense_window_profile(cfg, params, toks, pos, temps, gen, device)
    w8 = pk.serving_params(cfg, gpt.quantize_params(masters), device)
    pool8 = pk.init_paged_kv(cfg, B * n_pg, ps, kv_dtype="int8",
                             device=device)
    gap = {"bf16 weights, bf16 KV": decode}
    gap["int8 weights, bf16 KV"] = _profiled(window(w8, pool))
    gap["int8 weights, int8 KV"] = _profiled(window(w8, pool8))
    gap["bf16 weights, int8 KV"] = _profiled(window(params, pool8))
    weight_gap = {arm: {k: r[k] for k in ("device_busy_ms", "wall_ms",
                                          "host_op_calls",
                                          "device_ms_by_category")}
                  for arm, r in gap.items()}
    # The window's K/V writes alone (8 steps x n_layers, both sides), into
    # each pool: what _quant_write adds to the int8-KV window on the host.
    rows = torch.randn(B, cfg.n_heads, cfg.head_dim, device=device,
                       dtype=cfg.dtype)
    wpage = tables[:, (T - 16) // ps].long()
    woff = torch.full((B,), (T - 16) % ps, dtype=torch.int64, device=device)

    def writes(kv):
        def run():
            for _ in range(8):
                for l in range(cfg.n_layers):
                    pk._write_rows([kv], l, [wpage], [woff], [rows],
                                   [rows], cfg.dtype, "k_scale" in kv)
        return run
    kv_writes = {arm: {k: r[k] for k in ("wall_ms", "device_busy_ms",
                                         "host_op_calls")}
                 for arm, r in (("bf16 KV", _profiled(writes(pool))),
                                ("int8 KV", _profiled(writes(pool8))))}
    del w8, pool8
    torch.cuda.empty_cache()
    ptoks = torch.ones(B, 256, dtype=torch.int32, device=device)
    offs = torch.zeros(B, dtype=torch.int32, device=device)
    nv = torch.from_numpy(np.array([256, 256] + [0] * (B - 2),
                                   np.int32)).to(device)
    prefill = _profiled(lambda: pk.prefill_chunk_paged(
        cfg, params, ptoks, pool, tables[:, :4].contiguous(), offs, nv,
        attn_impl="kernel"))
    emit({"phase": "profile", "layers": CUT_DEPTH,
          "decode_window_k8": decode,
          "dense_decode_window_k8": dense,
          "prefill_dispatch_16x256": prefill,
          "decode_window_k8_device_ms_by_weights_and_kv": weight_gap,
          "decode_window_k8_kv_writes_alone": kv_writes})


ENGINE_PROMPT_SEED, ENGINE_TOKENS = 3, 32


def engine_prompts(cfg):
    rng = np.random.default_rng(ENGINE_PROMPT_SEED)
    lengths = rng.integers(128, 1537, size=16)
    return [list(map(int, rng.integers(1, cfg.vocab_size, n)))
            for n in lengths]


ENGINE_KNOBS = dict(n_slots=16, max_len=2048, page_size=64, kv_mode="paged",
                    prefill_chunk=256, prefill_token_budget=512,
                    attn_impl="kernel")

CUT_DEPTH = 8          # engine_tp's, engine_prefix's, engine_drain's,
                       # engine_kv's, engine_edge's and profile's layers:
                       # opt_1_3b's first 8 of 24, full width (depth cuts
                       # that make room for `serve`, `tune` and `data`);
                       # gpt2_2_7b's 8 of 32 in train_gpt2_2_7b and
                       # gptj_6b's 8 of 28 in engine_gptj's ps-48 engine
                       # (room for train_gptj_6b); gptj_6b's 8 of 28 in
                       # train_gptj_6b and gpt2_124m's 8 of 12 in
                       # train_ring and train_pipeline (room for
                       # train_dist's four ranks)


def first_layers(cfg, trees, n):
    """``cfg`` and parameter dicts cut to their first ``n`` layers (the
    stacked block leaves sliced, views; every width unchanged)."""
    stacked = {k for k, s in gpt.param_specs(cfg).items()
               if s["axes"] and s["axes"][0] == "layers"}
    return dataclasses.replace(cfg, n_layers=n), [
        {k: v[:n] if k in stacked else v for k, v in tree.items()}
        for tree in trees]


def launch_counts():
    return {"paged_attention": pa.paged_attention.launches,
            "paged_prefill_attention": pa.paged_prefill_attention.launches,
            "paged_attention_int8": pa.paged_attention.int8_launches,
            "paged_prefill_attention_int8":
                pa.paged_prefill_attention.int8_launches}


def check_outputs(cfg, reqs, tokens):
    errors = [r.error for r in reqs if r.error is not None]
    if errors:
        raise AssertionError(f"engine request errors: {errors[:3]}")
    for r in reqs:
        if len(r.out_ids) != tokens or r.truncated or not all(
                0 <= t < cfg.vocab_size for t in r.out_ids):
            raise AssertionError(f"bad output for {r.request_id}: "
                                 f"{len(r.out_ids)} tokens")


def check_pages(eng):
    """Paged engines: every page free or held by the prefix cache alone
    (free + cached-only == total), refs consistent, no live page."""
    if eng.kv_mode != "paged":
        return None
    acc = eng.page_accounting()
    if not (acc["closure"] and acc["refs_consistent"] and acc["live"] == 0
            and acc["free"] + acc["cached_only"] == acc["total"]):
        raise AssertionError(f"page accounting open: {acc}")
    return acc


def run_engine(device, cfg, params, *, prompts=None, rounds=1,
               temperature=0.0, chunk=256, tokens=None, hook=None, **knobs):
    """LLMEngine(opt_1_3b) serving the 16 seeded prompts (or ``prompts``)
    through submit()/start(), ``tokens`` (32) each at ``temperature``, for
    ``rounds`` rounds of the same traffic on one engine; each round with
    the stats reset and every paged launch counter zeroed just before it
    and read just after it (the engine thread stopped, so every tick of
    the round is in). The engine is the paged chunked kernel engine of
    ENGINE_KNOBS (chunk ``chunk``) unless ``knobs`` say otherwise;
    ``hook(engine)``, when given, runs before the first round.
    → (engine, [(requests, launches, wall seconds, metrics)] per round);
    raises on a request error, a bad output or (paged) page accounting
    that does not close."""
    tokens = tokens or ENGINE_TOKENS
    eng = LLMEngine(cfg, params, device=device,
                    **{**ENGINE_KNOBS, "prefill_chunk": chunk, **knobs})
    prompts = engine_prompts(cfg) if prompts is None else prompts
    if hook is not None:
        hook(eng)
    runs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        eng.reset_stats()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        # All requests queue before the engine thread starts, so the first
        # tick admits all of them and the schedule does not depend on the
        # host's timing.
        reqs = [eng.submit(p, max_tokens=tokens,
                           temperature=temperature) for p in prompts]
        eng.start()
        try:
            for r in reqs:
                if not r.done.wait(timeout=600):
                    raise AssertionError("engine request timed out")
        finally:
            eng.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check_outputs(cfg, reqs, tokens)
        check_pages(eng)
        runs.append((reqs, launches, wall, eng.metrics()))
    return eng, runs


def engine_record(cfg, eng, run, decode, prefill):
    """A round's JSON record: counts, launches per step and per dispatch
    of the programs ``decode`` and ``prefill`` ran, and the end-to-end
    metrics."""
    reqs, launches, wall, m = run
    steps, dispatches = m["decode_steps"], m["prefill_dispatches"]
    return {"requests": len(reqs),
            "prompt_tokens": sum(len(r.prompt_ids) for r in reqs),
            "wall_s": wall, "launches": launches,
            "decode_steps": steps, "decode_windows": m["decode_windows"],
            "decode_launches_per_step": launches[decode] / max(1, steps),
            "decode_launches_per_window": (
                launches[decode] / max(1, m["decode_windows"])),
            "prefill_dispatches": dispatches,
            "prefill_launches_per_dispatch": (
                launches[prefill] / max(1, dispatches)),
            **{k: m.get(k) for k in (
                "engine_decode_tok_s", "engine_prefill_tok_s", "ttft_ms_p50",
                "ttft_ms_p95", "decode_step_ms_p50", "decode_step_ms_p95",
                "preemptions", "kv_pages_free_min", "kv_pool_bytes",
                "llm_weight_dtype", "llm_kv_dtype")},
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in eng.params.values()),
            "page_accounting": check_pages(eng)}


def phase_engine(device, cfg, params):
    """The float engine (bf16 weights and KV) on the float programs."""
    eng, (run,) = run_engine(device, cfg, params)
    launches = run[1]
    if min(launches["paged_attention"],
           launches["paged_prefill_attention"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if launches["paged_attention_int8"] or launches[
            "paged_prefill_attention_int8"]:
        raise AssertionError(f"an int8 program ran in the float engine: "
                             f"{launches}")
    out = engine_record(cfg, eng, run, "paged_attention",
                        "paged_prefill_attention")
    emit({"phase": "engine", "config": "opt_1_3b bf16", **out})
    return launches, out, [r.out_ids for r in run[0]]


def agreement(streams, ref):
    """Per request, the share of its tokens before the first one that
    differs from the reference stream's."""
    shares = []
    for a, b in zip(streams, ref):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        shares.append(n / len(a))
    return shares


def phase_engine_int8(device, cfg, masters, float_run, float_streams):
    """The same traffic on LLMEngine(opt_1_3b, weight_dtype="int8",
    kv_dtype="int8") from the fp32 masters (quantized at load): exactly
    n_layers int8 launches per decode step and per prefill dispatch, no
    float paged launch, and kv_pool_bytes = the bf16 engine's / 2 plus
    the two bf16 [L, P+1] scale planes."""
    eng, (run,) = run_engine(device, cfg, masters, weight_dtype="int8",
                             kv_dtype="int8")
    reqs, launches = run[:2]
    out = engine_record(cfg, eng, run, "paged_attention_int8",
                        "paged_prefill_attention_int8")
    L = cfg.n_layers
    if launches["paged_attention"] or launches["paged_prefill_attention"]:
        raise AssertionError(f"a float program ran in the int8 engine: "
                             f"{launches}")
    if (launches["paged_attention_int8"] != L * out["decode_steps"]
            or launches["paged_prefill_attention_int8"]
            != L * out["prefill_dispatches"] or not out["decode_steps"]):
        raise AssertionError(f"int8 launches {launches} are not {L} per "
                             f"decode step and per prefill dispatch: {out}")
    scale_planes = 2 * L * (eng.n_pages + 1) * 2
    expect = float_run["kv_pool_bytes"] // 2 + scale_planes
    if out["kv_pool_bytes"] != expect:
        raise AssertionError(f"kv_pool_bytes {out['kv_pool_bytes']} != "
                             f"{expect} (bf16 engine's / 2 + scale planes)")
    shares = agreement([r.out_ids for r in reqs], float_streams)
    emit({"phase": "engine_int8", "config": "opt_1_3b bf16, int8 weights "
          "(from the fp32 masters), int8 KV", **out,
          "kv_pool_bytes_expected": expect,
          "weight_bytes_bf16_engine": float_run["weight_bytes"],
          "agreement_with_bf16_engine": {
              "share_before_first_divergence": shares,
              "mean": float(np.mean(shares)),
              "identical_streams": sum(x == 1.0 for x in shares)}})
    return launches


# ------------------------------------------------------- gptj_6b serving

GPTJ_TIE_MARGIN = 0.1      # logits within this of each other: a bf16 tie


def gptj_params(cfg, device):
    """gptj_6b's weights from seed 0, drawn in bf16 (the engine's serving
    dtype; fp32 masters of 6 B parameters would take 24 GB for nothing)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return gpt.init_params(
        dataclasses.replace(cfg, param_dtype=torch.bfloat16), gen, device)


def counted_calls(module, names):
    """Wrap the functions ``names`` of ``module`` (the kernels' plain
    versions, where the wrappers reach them) to count their calls → (the
    live counts, the real functions for `restore_plain`)."""
    calls = dict.fromkeys(names, 0)
    real = {name: getattr(module, name) for name in names}
    for name in names:
        def counted(*a, _real=real[name], _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        setattr(module, name, counted)
    return calls, real


def restore_plain(module, real):
    for name, fn in real.items():
        setattr(module, name, fn)


# The ps-48 engine of engine_gptj: a page size that is neither a divisor
# nor a multiple of 64, so its prefill dispatches run the wgmma kernel in
# TMA boxes of 16 rows (`prefill_box_rows`) at head dim 256; chunk 240 is
# five pages.
GPTJ_PS48_KNOBS = dict(page_size=48, prefill_chunk=240,
                       prefill_token_budget=480)
GPTJ_PS48_PROMPTS = 8


def gptj_engine_pair(device, cfg, params, prompts, **knobs):
    """The paged kernel engine (ENGINE_KNOBS updated by ``knobs``) on
    ``prompts``, the plain versions' calls counted, then the gather
    engine on the same weights, knobs and prompts: n_layers decode
    launches per decode step and prefill launches per dispatch, no plain
    call, no int8 program, pages closed; every stream equal to the gather
    engine's or leaving it where the gather logits of the two tokens are
    within GPTJ_TIE_MARGIN (a bf16 near-tie), which a planted wrong token
    must exceed. → (record, launches, failures)"""
    L = cfg.n_layers
    gather = {**knobs, "attn_impl": "gather"}
    plain, real = counted_calls(pa, ("reference_paged_attention",
                                     "reference_paged_prefill_attention"))
    try:
        eng, (run,) = run_engine(device, cfg, params, prompts=prompts,
                                 **knobs)
    finally:
        restore_plain(pa, real)
    reqs, launches = run[:2]
    out = engine_record(cfg, eng, run, "paged_attention",
                        "paged_prefill_attention")
    del eng
    torch.cuda.empty_cache()
    bad = []
    if (launches["paged_attention"] != L * out["decode_steps"]
            or launches["paged_prefill_attention"]
            != L * out["prefill_dispatches"] or not out["decode_steps"]):
        bad.append(f"launches {launches} are not {L} per decode step and "
                   f"per prefill dispatch")
    if launches["paged_attention_int8"] or launches[
            "paged_prefill_attention_int8"]:
        bad.append(f"an int8 program ran: {launches}")
    if any(plain.values()):
        bad.append(f"a plain version ran in the kernel engine: {plain}")
    streams = [r.out_ids for r in reqs]
    geng, (grun,) = run_engine(device, cfg, params, prompts=prompts,
                               **gather)
    ref = [r.out_ids for r in grun[0]]
    gather_rec = engine_record(cfg, geng, grun, "paged_attention",
                               "paged_prefill_attention")
    del geng
    torch.cuda.empty_cache()
    rec, cases = stream_cases(prompts, streams, ref)
    ctx, tok = prompts[0] + ref[0][:1], ref[0][1]
    margins = tie_margins(device, cfg, cases + [
        (ctx, tok, (tok + 1) % cfg.vocab_size)], params=params, **gather)
    rec.update(tie_margins=margins[:-1], tie_margin_bound=GPTJ_TIE_MARGIN,
               planted_wrong_token_margin=margins[-1],
               share_before_first_divergence=agreement(streams, ref))
    if rec["streams"] < len(prompts) or rec["other_length"]:
        bad.append(f"streams compared: {rec}")
    if any(m > GPTJ_TIE_MARGIN for m in margins[:-1]):
        bad.append(f"a kernel stream left the gather one off a tie: {rec}")
    if margins[-1] <= GPTJ_TIE_MARGIN:
        bad.append(f"the planted wrong token passed ({margins[-1]})")
    out.update(plain_calls=plain, vs_gather=rec, gather_engine={
        k: gather_rec[k] for k in ("decode_steps", "prefill_dispatches",
                                   "ttft_ms_p50", "decode_step_ms_p50",
                                   "engine_decode_tok_s")})
    return out, launches, bad


def phase_engine_gptj(device):
    """LLMEngine(gptj_6b) at full width (d 4096, 16 heads of 256, d_ff
    16384, bf16, random weights from seed 0), cut to the first CUT_DEPTH
    of its 28 layers (at full depth the whole script ran 1,226 s on an
    H100 80GB HBM3 at 700 W), on the paged kernels with the engine phase's
    knobs and traffic, against the gather engine (`gptj_engine_pair`);
    then the same layers at page size 48 and chunk 240 (GPTJ_PS48_KNOBS:
    the prefill on the wgmma kernel in 16-row boxes, the decode kernel at
    ps 48) on the first 8 prompts, against its own gather engine. → the
    launches of each engine."""
    t_phase = time.perf_counter()
    cfg = gpt.GPTConfig.gptj_6b(dtype=torch.bfloat16)
    params = gptj_params(cfg, device)
    cut, (cut_params,) = first_layers(cfg, (params,), CUT_DEPTH)
    del params
    torch.cuda.synchronize()
    prompts = engine_prompts(cfg)
    out, launches, bad = gptj_engine_pair(device, cut, cut_params, prompts)
    ps48 = GPTJ_PS48_KNOBS["page_size"]
    kern = pa.prefill_kernel(torch.bfloat16, cfg.head_dim, ps48)
    box = pa.prefill_box_rows(cfg.head_dim, ps48)
    if kern != "wgmma" or box != 16:
        bad.append(f"page size 48 at head dim 256 takes {kern} "
                   f"(box rows {box})")
    p48, p48_launches, p48_bad = gptj_engine_pair(
        device, cut, cut_params, prompts[:GPTJ_PS48_PROMPTS],
        **GPTJ_PS48_KNOBS)
    bad += [f"page size 48: {b}" for b in p48_bad]
    emit({"phase": "engine_gptj", "config": f"gptj_6b bf16 (d 4096, 16 heads "
          f"of 256), the first {CUT_DEPTH} of its 28 layers, random weights "
          "from seed 0", **out,
          "ps48": {"config": f"the first {CUT_DEPTH} layers, "
                             f"{GPTJ_PS48_KNOBS}, prefill kernel {kern} "
                             f"in boxes of {box} rows, "
                             f"{GPTJ_PS48_PROMPTS} prompts", **p48},
          "phase_s": time.perf_counter() - t_phase, "card": card_line()})
    del cut_params
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"engine_gptj: {bad}")
    return launches, p48_launches


# ------------------------------------------- prefix cache, speculation

PREFIX_SHARED, PREFIX_CHUNK, PREFIX_BIND = 900, 160, 800
# Warm against cold last-token logits (fp32, from the same rows through
# the same shapes: equal bits expected): the fp32 bound of the kernels.
PREFIX_LOGIT_TOL = "|warm - cold| <= 1e-5 + 1e-5 |cold|"
PREFIX_FAULT_FACTOR = 100    # the planted fault's least share of that bound


def chunk_prefill_row0(cfg, params, pool, prompt, table, start, device):
    """Chunked prefill of ``prompt[start:]`` into row 0 of fixed [16, 160]
    dispatches at table width 16 (the other rows inert), kernel path →
    the last token's fp32 logits [V]."""
    tables = np.zeros((16, 16), np.int32)
    tables[0, :len(table)] = table
    dev = lambda a: torch.from_numpy(a).to(device)
    for done in range(start, len(prompt), PREFIX_CHUNK):
        n = min(PREFIX_CHUNK, len(prompt) - done)
        toks = np.zeros((16, PREFIX_CHUNK), np.int32)
        toks[0, :n] = prompt[done:done + n]
        offs, nv = np.zeros(16, np.int32), np.zeros(16, np.int32)
        offs[0], nv[0] = done, n
        last, _ = pk.prefill_chunk_paged(
            cfg, params, dev(toks), pool, dev(tables), dev(offs), dev(nv),
            return_logits=done + n >= len(prompt), attn_impl="kernel")
    torch.cuda.synchronize()
    return last[0].float()


def warm_and_cold(cfg, params, kv_dtype, copy, device):
    """A 900-token prompt prefilled cold into pages 1-15; its first 800
    positions bound into another table: pages 1-12 shared and page 13
    (positions 768-799 written, 800-831 not) copied by ``copy`` onto page
    16, a recycled page that held another request's rows (and, int8, its
    scale); pages 17-18 fresh; then prefilled from 800 in the same
    dispatch shape. → (cold, warm) last-token logits."""
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, cfg.vocab_size, PREFIX_SHARED).astype(np.int32)
    stale = rng.integers(1, cfg.vocab_size, 64).astype(np.int32)
    pool = pk.init_paged_kv(cfg, 18, 64, kv_dtype=kv_dtype, device=device)
    chunk_prefill_row0(cfg, params, pool, stale, [16], 0, device)
    cold = chunk_prefill_row0(cfg, params, pool, prompt, list(range(1, 16)),
                              0, device)
    p_full = PREFIX_BIND // 64
    copy(pool, torch.tensor([p_full + 1], device=device),
         torch.tensor([16], device=device))
    warm = chunk_prefill_row0(cfg, params, pool, prompt,
                              list(range(1, p_full + 1)) + [16, 17, 18],
                              PREFIX_BIND, device)
    del pool
    return cold, warm


def share_of_fp32_bound(out, ref):
    err = (out - ref).abs()
    return float((err / (1e-5 + 1e-5 * ref.abs())).max())


def copy_k_v_only(pool, src, dst):
    """The planted fault: copy-on-write of the K/V planes alone, the page
    keeping whatever scale its row holds."""
    for name in ("k", "v"):
        pool[name][:, dst] = pool[name][:, src]
    return pool


def phase_programs_prefix(device, cfg, params):
    """Warm admission at the program level on opt_1_3b (float and int8
    pools, bf16 weights): a warm bind (12 shared pages plus a
    copy_pages of page 12) and a prefill from 800 against the cold 900-
    token prefill; on the int8 pool, a copy without the scale planes must
    fail the bound by PREFIX_FAULT_FACTOR."""
    out = {"phase": "programs_prefix", "config": "opt_1_3b bf16 24 layers",
           "tolerance": PREFIX_LOGIT_TOL,
           "dispatch": f"[16, {PREFIX_CHUNK}] row 0, table width 16, ps 64"}
    for kv in ("bf16", "int8"):
        cold, warm = warm_and_cold(cfg, params, kv, pk.copy_pages, device)
        if not (torch.isfinite(cold).all() and cold.shape
                == (cfg.vocab_size,)):
            raise AssertionError(f"bad logits {tuple(cold.shape)}")
        rec = {"share_of_bound": share_of_fp32_bound(warm, cold),
               "bitwise_equal": bool(torch.equal(warm, cold)),
               "max_abs_diff": float((warm - cold).abs().max()),
               "argmax_equal": int(warm.argmax()) == int(cold.argmax())}
        if rec["share_of_bound"] > 1.0:
            raise AssertionError(f"warm != cold on the {kv} pool: {rec}")
        if kv == "int8":
            cold_f, warm_f = warm_and_cold(cfg, params, kv, copy_k_v_only,
                                           device)
            rec["planted_fault"] = "copy_pages without the scale planes"
            rec["planted_fault_factor"] = share_of_fp32_bound(warm_f, cold_f)
            if rec["planted_fault_factor"] <= PREFIX_FAULT_FACTOR:
                raise AssertionError(f"the planted COW fault passes: {rec}")
        out[f"{kv} pool"] = rec
    emit(out)


def prefix_prompts(cfg):
    """16 prompts: one shared 900-token system prompt and seeded suffixes
    of 64-512 tokens."""
    rng = np.random.default_rng(ENGINE_PROMPT_SEED + 1)
    shared = list(map(int, rng.integers(1, cfg.vocab_size, PREFIX_SHARED)))
    return [shared + list(map(int, rng.integers(1, cfg.vocab_size, n)))
            for n in rng.integers(64, 513, size=16)]


def round_record(run, keys):
    reqs, launches, wall, m = run
    return {"wall_s": wall, "launches": launches,
            **{k: m.get(k) for k in keys}}


PREFIX_KEYS = ("prefix_hits", "prefix_misses", "cow_copies",
               "prefix_cached_tokens", "prefix_evictions",
               "prefix_cache_pages", "prefix_cache_entries",
               "prefill_tokens", "prefill_dispatches", "ttft_ms_p50",
               "ttft_ms_p95", "ttft_warm_ms_p50", "ttft_warm_ms_p95",
               "ttft_cold_ms_p50", "ttft_cold_ms_p95", "decode_step_ms_p50",
               "decode_step_ms_p95", "preemptions", "kv_pages_free_min")


def phase_engine_prefix(device, cfg, params):
    """LLMEngine(opt_1_3b, prefix_cache=True), chunk 160 (cached depths
    of odd multiples of 160 end mid-page: copy-on-write), 512 pages (half
    of them the cache's budget): the 16 shared-prefix prompts at once,
    cold (round 1), then the same 16 again, warm (round 2). Requires no
    request error, >= 15 hits and a copy in round 2, fewer prefill tokens
    than round 1, both kernels launched in each round, and the closed
    accounting with cached pages. Cut to CUT_DEPTH layers."""
    cfg, (params,) = first_layers(cfg, (params,), CUT_DEPTH)
    eng, runs = run_engine(device, cfg, params, prompts=prefix_prompts(cfg),
                           rounds=2, chunk=PREFIX_CHUNK, prefix_cache=True,
                           n_pages=512)
    cold, warm = runs
    for name, (_r, launches, _w, _m) in (("cold", cold), ("warm", warm)):
        if min(launches["paged_attention"],
               launches["paged_prefill_attention"]) <= 0:
            raise AssertionError(f"{name}: a kernel never launched: "
                                 f"{launches}")
    mw, mc = warm[3], cold[3]
    if not (mw["prefix_hits"] >= 15 and mw["cow_copies"] > 0
            and mw["prefill_tokens"] < mc["prefill_tokens"]):
        raise AssertionError(f"warm round: hits {mw['prefix_hits']}, copies "
                             f"{mw['cow_copies']}, prefill tokens "
                             f"{mw['prefill_tokens']} (cold "
                             f"{mc['prefill_tokens']})")
    shares = agreement([r.out_ids for r in warm[0]],
                       [r.out_ids for r in cold[0]])
    emit({"phase": "engine_prefix", "config": "opt_1_3b bf16 cut to its "
          f"first {CUT_DEPTH} layers, prefix cache, chunk {PREFIX_CHUNK}, "
          "512 pages of 64",
          "prompts": f"16 x ({PREFIX_SHARED} shared + 64-512 seeded)",
          "cold_round": round_record(cold, PREFIX_KEYS),
          "warm_round": round_record(warm, PREFIX_KEYS),
          "warm_agreement_with_cold": {
              "share_before_first_divergence": shares,
              "mean": float(np.mean(shares)),
              "identical_streams": sum(x == 1.0 for x in shares)},
          "page_accounting": eng.page_accounting()})
    return warm[1]


SPEC_KEYS = ("spec_ticks", "spec_slot_steps", "spec_proposed",
             "spec_accepted", "spec_emitted", "spec_accept_rate",
             "spec_accepted_per_step", "spec_accept_rate_by_position",
             "prefill_dispatches", "prefill_tokens", "ttft_ms_p50",
             "ttft_ms_p95", "decode_step_ms_p50", "decode_step_ms_p95",
             "engine_decode_tok_s", "preemptions", "kv_pages_free_min")
SELF_DRAFT_ACCEPT = 0.9


def phase_engine_spec(device, cfg, params, float_streams):
    """Speculative decoding on opt_1_3b, the engine phase's 16 prompts,
    spec_k 4: (a) a gpt2_124m draft (12 heads, random weights from seed
    1) at temperature 0.8, the sampling branch with rejection and
    rollback; (b) the target as its own draft, greedy, which must accept
    >= SELF_DRAFT_ACCEPT of its proposals. Each run: launches of the
    prefill kernel = target layers x (chunk dispatches + spec ticks) +
    draft layers x chunk dispatches, of the decode kernel = draft layers
    x (k+1) x spec ticks (every decode tick is a spec tick)."""
    out = {"phase": "engine_spec", "config": "opt_1_3b bf16, spec_k "
           f"{SPEC_K}, chunk 256"}
    draft = gpt.GPTConfig.gpt2_124m(dtype=torch.bfloat16)
    launched = {}
    for arm, knobs, temp in (
            ("gpt2_124m draft, temperature 0.8",
             dict(spec_draft=draft), 0.8),
            ("self-draft, greedy",
             dict(spec_draft=cfg, spec_draft_params=params), 0.0)):
        eng, (run,) = run_engine(device, cfg, params, temperature=temp,
                                 spec_k=SPEC_K, **knobs)
        reqs, launches, _wall, m = run
        dl, tl = eng.draft_cfg.n_layers, cfg.n_layers
        want = {"paged_prefill_attention":
                tl * (m["prefill_dispatches"] + m["spec_ticks"])
                + dl * m["prefill_dispatches"],
                "paged_attention": dl * (SPEC_K + 1) * m["spec_ticks"],
                "paged_attention_int8": 0,
                "paged_prefill_attention_int8": 0}
        if launches != want or not m["spec_ticks"]:
            raise AssertionError(f"{arm}: launches {launches}, expected "
                                 f"{want}")
        rec = round_record(run, SPEC_KEYS)
        rec["draft"] = {"n_layers": dl, "n_heads": eng.draft_cfg.n_heads,
                        "d_model": eng.draft_cfg.d_model}
        if float_streams is not None:
            shares = agreement([r.out_ids for r in reqs], float_streams)
            rec["agreement_with_float_engine"] = {
                "share_before_first_divergence": shares,
                "mean": float(np.mean(shares)),
                "identical_streams": sum(x == 1.0 for x in shares)}
        out[arm] = rec
        launched[arm] = launches
        if temp == 0.0 and m["spec_accept_rate"] < SELF_DRAFT_ACCEPT:
            raise AssertionError(f"{arm}: acceptance {m['spec_accept_rate']}"
                                 f" < {SELF_DRAFT_ACCEPT}")
        del eng
        torch.cuda.empty_cache()
    emit(out)
    return launched


# ------------------------------- dense KV, one-shot prefill, drain/resume

ONESHOT_ROWS, ONESHOT_BUCKET, ONESHOT_CHUNK = 8, 512, 256
DENSE_BUCKETS = (256, 512, 1024, 1536)
ONESHOT_FAULT = "the one-shot write with each row's first page on the null page"


def oneshot_inputs(cfg):
    """8 seeded prompts of 257-511 tokens padded to bucket 512, their
    lengths, a seeded token per row to decode at the next position, and
    the rows' page tables (8 pages of 64 each, pages 1-64)."""
    rng = np.random.default_rng(ENGINE_PROMPT_SEED + 2)
    lengths = rng.integers(ONESHOT_CHUNK + 1, ONESHOT_BUCKET,
                           size=ONESHOT_ROWS).astype(np.int32)
    toks = np.zeros((ONESHOT_ROWS, ONESHOT_BUCKET), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    nxt = rng.integers(1, cfg.vocab_size, ONESHOT_ROWS).astype(np.int32)
    n_pg = ONESHOT_BUCKET // 64
    tables = np.arange(1, ONESHOT_ROWS * n_pg + 1,
                       dtype=np.int32).reshape(ONESHOT_ROWS, n_pg)
    return toks, lengths, nxt, tables


def oneshot_path(device, cfg, params, kv_dtype, *, fault=False):
    """prefill_batch_paged into a fresh pool, then decode_step_paged
    (kernel) at each row's next position → (last-token logits, decode
    logits), fp32. ``fault``: the write goes through tables whose first
    column is the null page (the decode still reads the true tables)."""
    toks, lengths, nxt, tables = oneshot_inputs(cfg)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pool = pk.init_paged_kv(cfg, tables.size, 64, kv_dtype=kv_dtype,
                            device=device)
    pages = tables.copy()
    if fault:
        pages[:, 0] = 0
    last, _ = pk.prefill_batch_paged(cfg, params, dev(toks), pool,
                                     dev(pages), dev(lengths))
    dl, _ = pk.decode_step_paged(cfg, params, dev(nxt), pool, dev(lengths),
                                 dev(tables), attn_impl="kernel")
    torch.cuda.synchronize()
    return last.float(), dl.float()


def chunked_path(device, cfg, params, kv_dtype):
    """The same prompts through prefill_chunk_paged (kernel) in chunks of
    256 (two [8, 256] dispatches), then the same decode step."""
    toks, lengths, nxt, tables = oneshot_inputs(cfg)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pool = pk.init_paged_kv(cfg, tables.size, 64, kv_dtype=kv_dtype,
                            device=device)
    for off in range(0, ONESHOT_BUCKET, ONESHOT_CHUNK):
        nv = np.clip(lengths - off, 0, ONESHOT_CHUNK).astype(np.int32)
        last, _ = pk.prefill_chunk_paged(
            cfg, params, dev(toks[:, off:off + ONESHOT_CHUNK]), pool,
            dev(tables), dev(np.full(ONESHOT_ROWS, off, np.int32)), dev(nv),
            return_logits=off + ONESHOT_CHUNK >= ONESHOT_BUCKET,
            attn_impl="kernel")
    dl, _ = pk.decode_step_paged(cfg, params, dev(nxt), pool, dev(lengths),
                                 dev(tables), attn_impl="kernel")
    torch.cuda.synchronize()
    return last.float(), dl.float()


def dense_path(device, cfg, params):
    """prefill_batch into slots 0-7 of a dense [8, 576] cache, then
    decode_step at each row's next position."""
    toks, lengths, nxt, _ = oneshot_inputs(cfg)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cache = dec.init_kv_cache(cfg, ONESHOT_ROWS, ONESHOT_BUCKET + 64,
                              device=device)
    last, _ = dec.prefill_batch(cfg, params, dev(toks), cache,
                                dev(np.arange(ONESHOT_ROWS)), dev(lengths))
    dl, _ = dec.decode_step(cfg, params, dev(nxt), cache, dev(lengths))
    torch.cuda.synchronize()
    del cache
    return last.float(), dl.float()


def phase_programs_oneshot(device, cfg, masters, params):
    """The one-shot programs at full opt_1_3b width (bf16), 8 prompts of
    bucket 512: prefill_batch (dense) against prefill_batch_paged (float
    pool) and prefill_chunk_paged (kernel, chunk 256), and decode_step
    (dense) against decode_step_paged (kernel) on each of the two pools,
    held to PROGRAM_LOGIT_MAE; then int8 weights (from the same masters)
    on int8 pools, the one-shot path against the chunked one, held to
    PROGRAM_INT8_LOGIT_MAE. A one-shot write with each row's first page
    sent to the null page must exceed the limit at the decode step."""
    V = cfg.vocab_size
    out = {"phase": "programs_oneshot", "config": "opt_1_3b bf16 24 layers",
           "prompts": f"{ONESHOT_ROWS} x {ONESHOT_CHUNK + 1}-"
                      f"{ONESHOT_BUCKET - 1} tokens, bucket {ONESHOT_BUCKET}"
                      f", page 64, chunk {ONESHOT_CHUNK}",
           "mae_bound": PROGRAM_LOGIT_MAE,
           "int8_mae_bound": PROGRAM_INT8_LOGIT_MAE,
           "planted_fault": ONESHOT_FAULT}
    dense = dense_path(device, cfg, params)
    oneshot = oneshot_path(device, cfg, params, "bf16")
    chunked = chunked_path(device, cfg, params, "bf16")
    faulty = oneshot_path(device, cfg, params, "bf16", fault=True)
    w8 = pk.serving_params(cfg, gpt.quantize_params(masters), device)
    oneshot8 = oneshot_path(device, cfg, w8, "int8")
    chunked8 = chunked_path(device, cfg, w8, "int8")
    faulty8 = oneshot_path(device, cfg, w8, "int8", fault=True)
    del w8
    torch.cuda.empty_cache()
    pairs = {
        "prefill_batch_paged vs prefill_batch": (oneshot[0], dense[0]),
        "prefill_chunk_paged (kernel) vs prefill_batch": (chunked[0],
                                                          dense[0]),
        "decode_step_paged (kernel), one-shot pool vs decode_step": (
            oneshot[1], dense[1]),
        "decode_step_paged (kernel), chunked pool vs decode_step": (
            chunked[1], dense[1]),
        "int8: prefill_batch_paged vs prefill_chunk_paged (kernel)": (
            oneshot8[0], chunked8[0]),
        "int8: decode_step_paged (kernel), one-shot pool vs chunked pool": (
            oneshot8[1], chunked8[1]),
    }
    for name, (a, b) in pairs.items():
        out[name] = logit_diff(a, b, V)
        bound = (PROGRAM_INT8_LOGIT_MAE if name.startswith("int8")
                 else PROGRAM_LOGIT_MAE)
        if out[name]["logit_mae"] > bound:
            raise AssertionError(f"{name}: logit MAE {out[name]} > {bound}")
    for name, (a, b), bound in (
            ("planted fault: decode vs decode_step", (faulty[1], dense[1]),
             PROGRAM_LOGIT_MAE),
            ("int8 planted fault: decode vs the chunked pool's",
             (faulty8[1], chunked8[1]), PROGRAM_INT8_LOGIT_MAE)):
        out[name] = logit_diff(a, b, V)
        if out[name]["logit_mae"] <= bound:
            raise AssertionError(f"the planted fault passes: {out[name]}")
    emit(out)


def dense_knobs():
    return dict(kv_mode="dense", prefill_chunk=0,
                prefill_buckets=DENSE_BUCKETS)


def cache_bytes(eng):
    return sum(a.numel() * a.element_size() for a in eng.cache.values())


DENSE_KEYS = ("engine_decode_tok_s", "engine_prefill_tok_s", "ttft_ms_p50",
              "ttft_ms_p95", "decode_step_ms_p50", "decode_step_ms_p95",
              "decode_steps", "decode_windows", "prefill_tokens",
              "completed")


def phase_engine_dense(device, cfg, params, float_streams):
    """LLMEngine(opt_1_3b, kv_mode="dense", prefill_chunk=0) with buckets
    256-1536, 16 slots of 2048 positions: the engine phase's traffic.
    No paged kernel may launch; the share of each stream that agrees with
    the chunked paged engine's is a reading (bf16 rounding differs by
    path), not a gate."""
    eng, (run,) = run_engine(device, cfg, params, **dense_knobs())
    reqs, launches, wall, m = run
    if any(launches.values()):
        raise AssertionError(f"a paged kernel ran in the dense engine: "
                             f"{launches}")
    rec = {"phase": "engine_dense", "config": "opt_1_3b bf16, dense KV, "
           f"one-shot, buckets {list(DENSE_BUCKETS)}, 16 slots x 2048",
           "requests": len(reqs), "wall_s": wall, "launches": launches,
           **{k: m.get(k) for k in DENSE_KEYS},
           "kv_cache_bytes": cache_bytes(eng)}
    if float_streams is not None:
        shares = agreement([r.out_ids for r in reqs], float_streams)
        rec["agreement_with_chunked_paged_engine"] = {
            "share_before_first_divergence": shares,
            "mean": float(np.mean(shares)),
            "identical_streams": sum(x == 1.0 for x in shares)}
    emit(rec)
    del eng
    torch.cuda.empty_cache()


def phase_engine_oneshot(device, cfg, params, masters):
    """The engine phase's traffic on the one-shot paged kernel engine
    (prefill_chunk=0, buckets 256-1536), bf16 and then int8 weights and
    KV: exactly n_layers decode launches per decode step of the engine's
    own dtype, no prefill kernel and no program of the other dtype, page
    accounting closed. → launches of each run."""
    out = {"phase": "engine_oneshot", "config": "opt_1_3b bf16, paged, "
           f"one-shot, buckets {list(DENSE_BUCKETS)}, attn_impl kernel"}
    runs = {}
    L = cfg.n_layers
    for arm, weights, knobs, program, prefill in (
            ("float", params, {}, "paged_attention",
             "paged_prefill_attention"),
            ("int8", masters, dict(weight_dtype="int8", kv_dtype="int8"),
             "paged_attention_int8", "paged_prefill_attention_int8")):
        eng, (run,) = run_engine(device, cfg, weights, prefill_chunk=0,
                                 prefill_buckets=DENSE_BUCKETS, **knobs)
        launches = run[1]
        rec = engine_record(cfg, eng, run, program, prefill)
        want = dict.fromkeys(launches, 0)
        want[program] = L * rec["decode_steps"]
        if launches != want or not rec["decode_steps"]:
            raise AssertionError(f"one-shot {arm}: launches {launches}, "
                                 f"expected {want}")
        out[arm] = rec
        runs[arm] = launches
        del eng
        torch.cuda.empty_cache()
    emit(out)
    return runs


DRAIN_TOKENS, DRAIN_TICKS, DRAIN_CUT = 64, 2, 1024


def drain_round(device, cfg, params, knobs):
    """One mode's drain and resume: the engine phase's prompts cut to
    DRAIN_CUT tokens, DRAIN_TOKENS each; an uninterrupted run, then the
    same traffic on a fresh engine driven by step() until half the
    streams have emitted a token and then DRAIN_TICKS ticks more, drained
    with drain(0.0), every continuation resumed on another fresh
    engine. Gates: no error; each resumed stream carries exactly
    max_tokens - len(generated_ids) new tokens on its stream and keeps
    the generated ones in front; the source's streams ended with what
    they had emitted; paged accounting closed on both engines."""
    prompts = [p[:DRAIN_CUT] for p in engine_prompts(cfg)]
    eng, (run,) = run_engine(device, cfg, params, prompts=prompts,
                             tokens=DRAIN_TOKENS, **knobs)
    full = {i: r.out_ids for i, r in enumerate(run[0])}
    del eng
    torch.cuda.empty_cache()
    engine = lambda: LLMEngine(cfg, params, device=device,
                               **{**ENGINE_KNOBS, **knobs})
    src = engine()
    reqs = [src.submit(p, max_tokens=DRAIN_TOKENS, stream=True,
                       request_id=str(i)) for i, p in enumerate(prompts)]
    ticks = 0
    while sum(bool(r.out_ids) for r in reqs) < len(reqs) // 2:
        src.step()
        ticks += 1
    for _ in range(DRAIN_TICKS):
        src.step()
    t0 = time.perf_counter()
    out = src.drain(0.0)
    drain_s = time.perf_counter() - t0
    check_drained_source(reqs, DRAIN_TOKENS)
    src_pages = check_pages(src)
    del src
    torch.cuda.empty_cache()
    conts = out["continuations"]
    resumed, resume_s, dst_pages = resume_continuations(
        device, cfg, params, knobs, conts, DRAIN_TOKENS)
    shares = agreement([r.out_ids for r in resumed],
                       [full[int(c["request_id"])] for c in conts])
    return {"ticks_before_drain": ticks + DRAIN_TICKS,
            "exported": out["exported"], "drained": out["drained"],
            "generated_at_drain": sorted(len(c["generated_ids"])
                                         for c in conts),
            "drain_s": drain_s, "resume_wall_s": resume_s,
            "resumed_agreement_with_uninterrupted": {
                "share_before_first_divergence": shares,
                "mean": float(np.mean(shares)),
                "identical_streams": sum(x == 1.0 for x in shares)},
            "page_accounting": {"source": src_pages, "destination":
                                dst_pages}}


def check_drained_source(reqs, tokens):
    """After drain(): every source request is done without error, its
    stream carried exactly what it emitted, and it either finished or
    was exported (migrated)."""
    for r in reqs:
        streamed = []
        while (t := r.stream.get(timeout=5)) is not None:
            streamed.append(t)
        if not r.done.is_set() or r.error or streamed != r.out_ids or not (
                r.migrated or len(r.out_ids) == tokens):
            raise AssertionError(f"source request {r.request_id} left "
                                 f"open: {r.error}, {len(streamed)} streamed")


def resume_continuations(device, cfg, params, knobs, conts, tokens, *,
                         kv=False, hook=None):
    """Resume drain() continuations on a fresh engine (ENGINE_KNOBS and
    ``knobs``) through its engine thread; with ``kv`` each carries its
    ``kv`` descriptor; ``hook(engine)``, when given, runs before the
    submits. Gates: no error, ``tokens``
    each, every resumed stream carries exactly max_tokens -
    len(generated_ids) new tokens with the generated ones kept in front,
    the accounting closed. → (requests, wall seconds, page accounting)."""
    dst = LLMEngine(cfg, params, device=device, **{**ENGINE_KNOBS, **knobs})
    if hook is not None:
        hook(dst)
    resumed = [dst.submit(c["prompt_ids"], max_tokens=c["max_tokens"],
                          temperature=c["temperature"], eos_id=c["eos_id"],
                          generated_ids=c["generated_ids"],
                          request_id=c["request_id"], stream=True,
                          kv=c.get("kv") if kv else None)
               for c in conts]
    t0 = time.perf_counter()
    dst.start()
    try:
        for r in resumed:
            if not r.done.wait(timeout=600):
                raise AssertionError("resumed request timed out")
    finally:
        dst.stop()
    resume_s = time.perf_counter() - t0
    check_outputs(cfg, resumed, tokens)
    for c, r in zip(conts, resumed):
        streamed = []
        while (t := r.stream.get(timeout=5)) is not None:
            streamed.append(t)
        gen = c["generated_ids"]
        if (r.out_ids[:len(gen)] != gen or streamed != r.out_ids[len(gen):]
                or len(streamed) != c["max_tokens"] - len(gen)):
            raise AssertionError(f"resume of {c['request_id']} re-emitted "
                                 f"or lost tokens: {len(gen)} generated, "
                                 f"{len(streamed)} streamed")
    dst_pages = check_pages(dst)
    del dst
    torch.cuda.empty_cache()
    return resumed, resume_s, dst_pages


def phase_engine_drain(device, cfg, params):
    """drain/resume on the dense one-shot engine, then on the chunked
    paged kernel engine (`drain_round`), cut to CUT_DEPTH layers."""
    cfg, (params,) = first_layers(cfg, (params,), CUT_DEPTH)
    out = {"phase": "engine_drain", "layers": CUT_DEPTH,
           "traffic": f"16 prompts cut to {DRAIN_CUT} tokens, "
                      f"{DRAIN_TOKENS} tokens each, drain(0.0) "
                      f"{DRAIN_TICKS} ticks after half the streams "
                      "started"}
    out["dense, one-shot"] = drain_round(device, cfg, params, dense_knobs())
    out["paged, chunked, kernel"] = drain_round(device, cfg, params, {})
    emit(out)


# ------------------------------------------------ tensor parallelism

# A tp engine's first-token logits against the tp=1 engine's, per request:
# the mean |difference| over the vocabulary, at most this. The tp bodies
# add each layer's attention-out and MLP-down partials in bf16 (two more
# roundings per layer than the tp=1 body's single product), the same
# order of bf16 noise as between the kernel and gather programs, which
# PROGRAM_LOGIT_MAE bounds at 24 layers.
TP_LOGIT_MAE = PROGRAM_LOGIT_MAE
TP_FAULT_LAYER = 0     # the planted fault drops shard 1's attention partial
TP_FEW = 8             # requests of the later arms (b)-(e)
def tp_mesh(tp):
    """tp shards, every one on cuda:0 (one card)."""
    return [torch.device("cuda", 0)] * tp


def capture_first_logits(rows):
    """A run_engine hook: each request's first-token logits row (the row
    its first token is sampled from at graduation) into ``rows`` by
    request id."""
    def hook(eng):
        last = {}
        sample, emit_token = eng._sample, eng._emit

        def _sample(row, temperature):
            last["row"] = row
            return sample(row, temperature)

        def _emit(req, tok):
            if not req.out_ids and req.request_id not in rows:
                rows[req.request_id] = torch.from_numpy(last["row"].copy())
            return emit_token(req, tok)

        eng._sample, eng._emit = _sample, _emit
    return hook


def first_logit_maes(reqs, rows, ref_reqs, ref_rows, vocab):
    """Per request, the mean |first-token logits - the reference's|."""
    out = []
    for r, ref in zip(reqs, ref_reqs):
        a, b = rows[r.request_id], ref_rows[ref.request_id]
        if not (torch.isfinite(a).all() and a.shape == (vocab,)):
            raise AssertionError(f"bad first-token logits {tuple(a.shape)}")
        out.append(float((a - b).abs().mean()))
    return out


def check_tp_engine(cfg, eng, run, tp, decode, prefill, *, draft=None):
    """The tp gates on one run: launches of the path's two programs are
    exactly n_layers x tp per decode step and per chunk dispatch (with a
    draft: the speculative counts of `phase_engine_spec`, x tp), nothing
    else launches; kv_heads_per_shard is n_heads / tp and
    pool_shard_bytes is the shard's own tensors' bytes, the same on
    every shard. → the run's record."""
    reqs, launches, _wall, m = run
    L = cfg.n_layers
    if draft is None:
        want = {decode: L * tp * m["decode_steps"],
                prefill: L * tp * m["prefill_dispatches"]}
    else:
        dl = draft.n_layers
        want = {prefill: tp * (L * (m["prefill_dispatches"] + m["spec_ticks"])
                               + dl * m["prefill_dispatches"]),
                decode: tp * dl * (SPEC_K + 1) * m["spec_ticks"]}
    want = {k: want.get(k, 0) for k in launches}
    if launches != want or not want[decode] or not want[prefill]:
        raise AssertionError(f"tp={tp}: launches {launches}, expected "
                             f"{want}")
    shard_bytes = [sum(t.numel() * t.element_size() for t in shard.values())
                   for shard in eng.cache]
    if (m["llm_tp"] != tp or m["kv_heads_per_shard"] != cfg.n_heads // tp
            or m["mesh_shape"] != {"tp": tp}
            or len(set(shard_bytes)) != 1
            or m["pool_shard_bytes"] != shard_bytes[0]
            or m["kv_pool_bytes"] != sum(shard_bytes)):
        raise AssertionError(f"tp={tp} topology: {m.get('llm_tp')}, "
                             f"{m.get('kv_heads_per_shard')}, "
                             f"{m.get('pool_shard_bytes')} vs {shard_bytes}")
    return {"launches": launches,
            "decode_launches_per_step": launches[decode]
            / max(1, m["decode_steps"]),
            "prefill_launches_per_dispatch": launches[prefill]
            / max(1, m["prefill_dispatches"]),
            **{k: m.get(k) for k in (
                "decode_steps", "decode_windows", "prefill_dispatches",
                "spec_ticks", "spec_accept_rate", "engine_decode_tok_s",
                "ttft_ms_p50", "decode_step_ms_p50", "decode_step_ms_p95",
                "preemptions", "llm_tp", "mesh_shape", "kv_heads_per_shard",
                "pool_shard_bytes", "kv_pool_bytes")},
            "page_accounting": check_pages(eng)}


def tp_run(device, cfg, params, tp, prompts, *, temperature=0.0, **knobs):
    """One engine run of ``prompts`` (ENGINE_TOKENS greedy tokens each)
    at ``tp`` (every shard on cuda:0; tp=1 on ``device``), capturing the
    first-token logits. → (engine, run, first-token rows)."""
    rows: dict = {}
    eng, (run,) = run_engine(
        tp_mesh(tp) if tp > 1 else device, cfg, params, prompts=prompts,
        tp=tp, temperature=temperature, hook=capture_first_logits(rows),
        **knobs)
    return eng, run, rows


def agreement_record(streams, ref):
    shares = agreement(streams, ref)
    return {"share_before_first_divergence": shares,
            "mean": float(np.mean(shares)),
            "identical_streams": sum(x == 1.0 for x in shares)}


def tp_window_profile(device, cfg, params):
    """One fused decode window (k = 8, 16 slots at 1024-token contexts,
    as `phase_profile`'s) through decode_multi_paged and through
    decode_multi_paged_tp at tp=2 on one card: `_profiled`'s device busy
    time and idle share for each."""
    B, T, ps = 16, 1024, 64
    n_pg = T // ps
    pool = pk.init_paged_kv(cfg, B * n_pg, ps, device=device)
    tables = torch.arange(1, B * n_pg + 1, dtype=torch.int32,
                          device=device).reshape(B, n_pg)
    toks = torch.ones(B, dtype=torch.int32, device=device)
    pos = torch.full((B,), T - 16, dtype=torch.int32, device=device)
    temps = torch.zeros(B, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"tp=1": _profiled(lambda: pk.decode_multi_paged(
        cfg, params, toks, pool, pos, tables, 8, temps, gen,
        attn_impl="kernel"))}
    mesh = tp_mesh(2)
    shards = partition.shard_by_rules(mesh, gpt.partition_rules(), params)
    pools = partition.shard_by_rules(mesh, pk.KV_POOL_PARTITION_RULES, pool)
    del pool
    out["tp=2"] = _profiled(lambda: pk.decode_multi_paged_tp(
        cfg, shards, toks, pools, pos, tables, 8, temps, gen, mesh=mesh,
        attn_impl="kernel"))
    del shards, pools
    torch.cuda.empty_cache()
    return {arm: {k: r[k] for k in ("wall_ms", "device_busy_ms",
                                    "device_idle_share", "host_op_calls",
                                    "device_ms_by_category")}
            for arm, r in out.items()}


def planted_tp_fault(device, cfg, params, prompts, ref_reqs, ref_rows):
    """The logits gate's planted fault: the tp=2 engine with shard 1's
    attention-out partial dropped from the sum in layer TP_FAULT_LAYER
    (every dispatch), one token per request. → each request's first-token
    logit MAE against the tp=1 engine's; the largest must exceed
    TP_LOGIT_MAE."""
    sound, calls = pk._reduce, [0]

    def dropped(parts, dev):
        layer = calls[0] % cfg.n_layers
        calls[0] += 1
        return sound(parts[:1] if layer == TP_FAULT_LAYER else parts, dev)

    pk._reduce = dropped
    try:
        rows: dict = {}
        eng, (run,) = run_engine(tp_mesh(2), cfg, params, prompts=prompts,
                                 tp=2, tokens=1,
                                 hook=capture_first_logits(rows))
    finally:
        pk._reduce = sound
    maes = first_logit_maes(run[0], rows, ref_reqs, ref_rows,
                            cfg.vocab_size)
    del eng
    torch.cuda.empty_cache()
    if max(maes) <= TP_LOGIT_MAE:
        raise AssertionError(f"planted tp fault within the logits bound: "
                             f"{maes}")
    return maes


def tp_drain(device, cfg, params, prompts):
    """drain(0.0) of a tp=2 engine under load (driven by step() until half
    the streams started, DRAIN_TICKS more), every continuation resumed on
    a fresh tp=1 engine (`resume_continuations`: each resumed stream
    carries exactly its missing tokens)."""
    prompts = [p[:DRAIN_CUT] for p in prompts]
    src = LLMEngine(cfg, params, device=tp_mesh(2), tp=2, **ENGINE_KNOBS)
    reqs = [src.submit(p, max_tokens=DRAIN_TOKENS, stream=True,
                       request_id=str(i)) for i, p in enumerate(prompts)]
    ticks = 0
    while sum(bool(r.out_ids) for r in reqs) < len(reqs) // 2:
        src.step()
        ticks += 1
    for _ in range(DRAIN_TICKS):
        src.step()
    out = src.drain(0.0)
    check_drained_source(reqs, DRAIN_TOKENS)
    src_pages = check_pages(src)
    del src
    torch.cuda.empty_cache()
    conts = out["continuations"]
    if not conts:
        raise AssertionError("tp=2 drain exported nothing")
    _resumed, resume_s, dst_pages = resume_continuations(
        device, cfg, params, {}, conts, DRAIN_TOKENS)
    return {"requests": len(prompts), "ticks_before_drain": ticks
            + DRAIN_TICKS, "exported": out["exported"],
            "generated_at_drain": sorted(len(c["generated_ids"])
                                         for c in conts),
            "resume_wall_s": resume_s,
            "page_accounting": {"source": src_pages,
                                "destination": dst_pages}}


def phase_engine_tp(device, cfg, params, masters):
    """Tensor-parallel serving on one card (every shard on cuda:0), the
    engine phase's configuration (cut to CUT_DEPTH layers) and traffic:
    tp=2 against a tp=1 engine
    on the 16 prompts; then, on the first TP_FEW prompts, (b) tp=4, (c)
    tp=2 with int8 weights and KV against a tp=1 int8 engine (the scale
    planes bitwise equal across shards at the end), (d) tp=2 with
    spec_k 4 and the gpt2_124m draft (6 heads per shard), (e) a tp=2
    drain resumed on tp=1. Gates: `check_tp_engine` per run, every
    request's first-token logits within TP_LOGIT_MAE of the tp=1
    engine's (a planted fault must exceed it), no request error, pages
    balanced. Readings: greedy agreement with tp=1, the decode step, and
    one window's device time and idle share at tp=2 beside tp=1. A tp
    time on one card is not tensor parallelism's speed: the shards run
    one after another."""
    prompts = engine_prompts(cfg)
    few = prompts[:TP_FEW]
    cfg, (params, masters) = first_layers(cfg, (params, masters), CUT_DEPTH)
    out = {"phase": "engine_tp", "config": f"opt_1_3b bf16 cut to its "
           f"first {CUT_DEPTH} layers (full width), 16 slots, max_len "
           "2048, page 64, chunk 256, budget 512, every shard on cuda:0",
           "logit_mae_bound": TP_LOGIT_MAE}
    by_path = {}
    eng1, run1, rows1 = tp_run(device, cfg, params, 1, prompts)
    ref = [r.out_ids for r in run1[0]]
    out["tp=1"] = {k: run1[3].get(k) for k in (
        "decode_steps", "prefill_dispatches", "engine_decode_tok_s",
        "ttft_ms_p50", "decode_step_ms_p50", "decode_step_ms_p95")}
    del eng1
    torch.cuda.empty_cache()

    def arm(name, tp, ref_run, ref_rows, decode="paged_attention",
            prefill="paged_prefill_attention", draft=None, prompts=few,
            **knobs):
        eng, run, rows = tp_run(device, cfg, params if "weight_dtype"
                                not in knobs else masters, tp, prompts,
                                **knobs)
        rec = check_tp_engine(cfg, eng, run, tp, decode, prefill,
                              draft=draft)
        maes = first_logit_maes(run[0], rows, ref_run[0], ref_rows,
                                cfg.vocab_size)
        rec["first_token_logit_mae"] = maes
        if max(maes) > TP_LOGIT_MAE:
            raise AssertionError(f"{name}: first-token logits off the tp=1 "
                                 f"engine's: {maes}")
        rec["agreement_with_tp1"] = agreement_record(
            [r.out_ids for r in run[0]], [r.out_ids for r in ref_run[0]])
        by_path[f"engine_tp ({name})"] = run[1]
        out[name] = rec
        return eng

    arm(f"tp=2, {len(prompts)} requests", 2, run1, rows1, prompts=prompts)
    out["planted_fault"] = {
        "fault": f"shard 1's attention partial dropped in layer "
                 f"{TP_FAULT_LAYER}",
        "first_token_logit_mae": planted_tp_fault(
            device, cfg, params, few, run1[0][:TP_FEW], rows1)}
    arm(f"tp=4, {TP_FEW} requests", 4, run1, rows1)
    torch.cuda.empty_cache()
    q = dict(weight_dtype="int8", kv_dtype="int8")
    eng, run8, rows8 = tp_run(device, cfg, masters, 1, few, **q)
    del eng
    torch.cuda.empty_cache()
    eng = arm(f"tp=2 int8, {TP_FEW} requests", 2, run8, rows8,
              decode="paged_attention_int8",
              prefill="paged_prefill_attention_int8", **q)
    equal = {name: all(torch.equal(s[name].view(torch.int16),
                                   eng.cache[0][name].view(torch.int16))
                       for s in eng.cache) for name in ("k_scale", "v_scale")}
    if not all(equal.values()):
        raise AssertionError(f"int8 scale planes differ across shards: "
                             f"{equal}")
    out[f"tp=2 int8, {TP_FEW} requests"]["scale_planes_equal"] = equal
    del eng
    torch.cuda.empty_cache()
    draft = gpt.GPTConfig.gpt2_124m(dtype=torch.bfloat16)
    eng = arm(f"tp=2 spec_k {SPEC_K}, gpt2_124m draft, {TP_FEW} requests",
              2, run1, rows1, draft=draft, spec_draft=draft, spec_k=SPEC_K)
    out[f"tp=2 spec_k {SPEC_K}, gpt2_124m draft, {TP_FEW} requests"][
        "draft_heads_per_shard"] = draft.n_heads // 2
    del eng
    torch.cuda.empty_cache()
    out["drain at tp=2, resumed at tp=1"] = tp_drain(device, cfg, params,
                                                     few)
    out["decode_window_k8_tp2_beside_tp1"] = tp_window_profile(device, cfg,
                                                               params)
    emit(out)
    return by_path


# ------------------------------------------------ KV page-set transfer

KV_FEW = 8            # prompts of the handoff and drain parts
KV_INT8_FEW = 4       # prompts of the int8 handoff
KV_TOKENS = 24        # tokens of each handed-off stream, the first included


def payload_bytes(planes) -> int:
    return sum(a.numel() * a.element_size() for a in planes.values())


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (dtype, shape and every byte)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def time_donations(eng, log):
    """Wrap the engine's donation payload read (the gather on the device
    and the copy to the host): wall ms and bytes per call into ``log``."""
    inner = eng._kv_payload

    def timed(pool, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = inner(pool, ids)        # .cpu() waits for the gather
        log.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "bytes": payload_bytes(host)})
        return host

    eng._kv_payload = timed


def check_binds(eng, store, log):
    """Wrap the engine's adoption bind: its wall (the stitch on the host,
    the copy to the device, the scatter; synchronized) and the payload's
    bytes into ``log``; then the adopted pages gathered back from the
    pool must equal the payloads fetched from the store (a tp > 1
    donor's shards joined) bit for bit, every plane (an int8 pool's
    scale planes too), or it raises."""
    inner = eng._bind_kv_adopt

    def checked(slot, req, plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = inner(slot, req, plan)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"request_id": req.request_id, "adopted_tokens": n}
        log.append(rec)
        if not n:
            return n
        sent = []
        for meta in plan["metas"][:n // eng.prefill_chunk]:
            p = store.fetch(meta)
            if meta["tp"] > 1:
                p = partition.concat_head_planes(p, meta["tp"])
            sent.append(p)
        n_pages = int(eng.slot_n_pages[slot])
        got = eng._rt.gather_pages(eng.cache, eng._to_dev(
            eng.page_table[slot, :n_pages].copy()))
        equal = {name: same_bits(plane.cpu(), torch.cat(
            [p[name] for p in sent], dim=1)) for name, plane in got.items()}
        if not all(equal.values()):
            raise AssertionError(f"adopted pages of {req.request_id} differ "
                                 f"from the donated payload: {equal}")
        rec.update(pages=n_pages, ms=ms, bytes=sum(
            payload_bytes({k: p[k] for k in got}) for p in sent),
            planes_bitwise_equal=sorted(equal))
        return n

    eng._bind_kv_adopt = checked


def count_chunk_tokens(eng, counts):
    """Wrap the chunk dispatch: per request, the offset of its first
    prefilled chunk and the tokens prefilled, into ``counts``."""
    inner = eng._dispatch_chunk_bucket

    def counted(batch, width):
        for _slot, req, done, n in batch:
            first, total = counts.get(req.request_id, (done, 0))
            counts[req.request_id] = (first, total + n)
        return inner(batch, width)

    eng._dispatch_chunk_bucket = counted


def kv_serve(eng, submits):
    """Queue ``submits`` ((args, kwargs) of `submit`) and run the engine
    thread until every request is done, with the stats reset and the
    launch counters zeroed just before and read just after. Raises on a
    request error. → (requests, wall seconds, launches, metrics)."""
    torch.cuda.synchronize()
    eng.reset_stats()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(*a, **kw) for a, kw in submits]
    eng.start()
    try:
        for r in reqs:
            if not r.done.wait(timeout=600):
                raise AssertionError("kv request timed out")
    finally:
        eng.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errors = [r.error for r in reqs if r.error is not None]
    if errors:
        raise AssertionError(f"kv request errors: {errors[:3]}")
    return reqs, wall, launch_counts(), eng.metrics()


def check_kv_pages(eng):
    """`check_pages`, and no page held by a donation in flight."""
    acc = check_pages(eng)
    if acc["exporting"]:
        raise AssertionError(f"pages left in flight: {acc}")
    return acc


def check_kv_launches(cfg, m, launches, tp, int8):
    """Exactly n_layers x tp launches of the path's decode program per
    decode step and of its prefill program per chunk dispatch, none of
    the others. → launches per step and per dispatch."""
    sfx = "_int8" if int8 else ""
    decode, prefill = "paged_attention" + sfx, "paged_prefill_attention" + sfx
    L = cfg.n_layers
    want = {k: 0 for k in launches}
    want[decode] = L * tp * m["decode_steps"]
    want[prefill] = L * tp * m["prefill_dispatches"]
    if launches != want or not want[decode] or not want[prefill]:
        raise AssertionError(f"tp={tp}: launches {launches}, expected {want}")
    return {"decode_launches_per_step": launches[decode] / m["decode_steps"],
            "prefill_launches_per_dispatch":
                launches[prefill] / m["prefill_dispatches"]}


def rate(log):
    """Summed ms and bytes of a timing log, and GB/s."""
    ms = sum(r["ms"] for r in log if "ms" in r)
    nbytes = sum(r["bytes"] for r in log if "bytes" in r)
    return {"calls": sum("ms" in r for r in log), "ms": ms, "bytes": nbytes,
            "GB_per_s": nbytes / ms / 1e6 if ms else None}


def kv_handoff(device, cfg, params, prompts, *, kv_dtype="bf16",
               pre_tp=1, dec_tp=1, timed=False):
    """One prefill→decode pool handoff through the process-global store
    (reset first): a ``pool_role="prefill"`` engine at ``pre_tp`` serves
    ``prompts``, each request leaving at its first token with its pages
    donated; a fresh ``pool_role="decode"`` engine at ``dec_tp``, same
    weights, resumes each ``(prompt, [first token], kv)`` for KV_TOKENS
    tokens in all. A tp > 1 engine has every shard on cuda:0. Gates:
    every request with a full chunk hands off with a descriptor and is
    adopted over all of its full chunks (no adoption failure), its
    adopted pages bitwise the donated payload (`check_binds`), and its
    prefill covers the cold tail alone (the context less the adopted
    tokens, from the first cold token); the launch counts of the
    adopter's tp (`check_kv_launches`); no request error; both engines'
    accounting closed with nothing in flight. With ``timed``, the same
    continuations twice more on the decode engine without the checks,
    with their descriptors and then without (re-prefill), for TTFT."""
    chunk = ENGINE_KNOBS["prefill_chunk"]
    int8 = kv_dtype == "int8"
    tkvo.reset_local_store()
    store = tkvo.get_store()
    knobs = dict(ENGINE_KNOBS, kv_dtype=kv_dtype)
    place = lambda tp: tp_mesh(tp) if tp > 1 else device
    pre = LLMEngine(cfg, params, device=place(pre_tp), tp=pre_tp,
                    pool_role="prefill", **knobs)
    donations = []
    time_donations(pre, donations)
    reqs, pre_wall, pre_launches, pre_m = kv_serve(pre, [
        ((p,), dict(max_tokens=KV_TOKENS, request_id=str(i)))
        for i, p in enumerate(prompts)])
    prefill = "paged_prefill_attention" + ("_int8" if int8 else "")
    want = {k: 0 for k in pre_launches}
    want[prefill] = cfg.n_layers * pre_tp * pre_m["prefill_dispatches"]
    if pre_launches != want or not want[prefill]:
        raise AssertionError(f"prefill engine launches {pre_launches}, "
                             f"expected {want}")
    for r in reqs:
        full = r.n_prompt >= chunk
        if not (r.migrated and len(r.out_ids) == 1
                and (r.kv_handoff is not None) == full):
            raise AssertionError(f"request {r.request_id} did not hand off: "
                                 f"{len(r.out_ids)} tokens, "
                                 f"{r.kv_handoff is not None}")
    depths = {r.request_id: r.n_prompt // chunk for r in reqs}
    if pre_m["kv_donations"] != sum(depths.values()):
        raise AssertionError(f"{pre_m['kv_donations']} donations, "
                             f"expected {sum(depths.values())}")
    pre_pages = check_kv_pages(pre)
    del pre
    torch.cuda.empty_cache()
    dec = LLMEngine(cfg, params, device=place(dec_tp), tp=dec_tp,
                    pool_role="decode", **knobs)
    conts = [((r.prompt_ids[:r.n_prompt],), dict(
        max_tokens=KV_TOKENS, generated_ids=list(r.out_ids),
        request_id=r.request_id, kv=r.kv_handoff,
        prefix_hashes=[h.hex() for h in r.prefix_hashes],
        prefix_chunk=chunk)) for r in reqs]
    binds, chunks = [], {}
    check_binds(dec, store, binds)
    count_chunk_tokens(dec, chunks)
    out, wall, launches, m = kv_serve(dec, conts)
    del dec._bind_kv_adopt, dec._dispatch_chunk_bucket
    check_outputs(cfg, out, KV_TOKENS)
    adopted = {b["request_id"]: b["adopted_tokens"] for b in binds}
    for r in out:
        want = depths[r.request_id] * chunk
        context = r.n_prompt + 1
        if (adopted.get(r.request_id, 0) != want
                or chunks[r.request_id] != (want, context - want)):
            raise AssertionError(
                f"request {r.request_id}: adopted "
                f"{adopted.get(r.request_id)} of {want}, prefilled "
                f"{chunks[r.request_id]} of a {context}-token context")
    want_adoptions = sum(d > 0 for d in depths.values())
    if m["kv_adoptions"] != want_adoptions or m["kv_adopt_failures"]:
        raise AssertionError(f"adoptions {m['kv_adoptions']} of "
                             f"{want_adoptions}, failures "
                             f"{m['kv_adopt_failures']}")
    rec = {"requests": len(prompts),
           "prompt_tokens": [len(p) for p in prompts],
           "tp": f"{pre_tp} -> {dec_tp}", "kv_dtype": kv_dtype,
           "prefill_engine": {"wall_s": pre_wall, "launches": pre_launches,
                              **{k: pre_m[k] for k in (
               "kv_donations", "kv_donated_pages", "prefill_dispatches")},
               "page_accounting": pre_pages},
           "decode_engine": {
               "wall_s": wall, "launches": launches,
               **check_kv_launches(cfg, m, launches, dec_tp, int8),
               **{k: m[k] for k in (
                   "kv_adoptions", "kv_adopted_tokens", "kv_adopt_failures",
                   "prefill_tokens", "prefill_dispatches", "decode_steps")},
               "prefilled_tokens_per_request": {
                   k: v[1] for k, v in sorted(chunks.items())},
               "adopted_planes_bitwise_equal": sorted(
                   {n for b in binds for n in b.get(
                       "planes_bitwise_equal", ())}),
               "page_accounting": check_kv_pages(dec)},
           "payload_device_to_host": rate(donations),
           "payload_host_to_device": rate(binds),
           "store": store.stats()}
    if timed:
        runs = {}
        for arm, with_kv in (("adopted", True), ("re-prefill", False)):
            subs = [(a, dict(kw, kv=kw["kv"] if with_kv else None))
                    for a, kw in conts]
            got, wall, _l, mm = kv_serve(dec, subs)
            check_outputs(cfg, got, KV_TOKENS)
            runs[arm] = (got, mm)
            rec[f"timed_{arm}"] = {"wall_s": wall, **{k: mm.get(k) for k in (
                "ttft_ms_p50", "ttft_ms_p95", "ttft_mean_s",
                "prefill_tokens", "kv_adoptions", "decode_step_ms_p50")}}
        if runs["re-prefill"][1]["kv_adoptions"]:
            raise AssertionError("the re-prefill round adopted")
        rec["adopted_vs_reprefill_agreement"] = agreement_record(
            [r.out_ids for r in runs["adopted"][0]],
            [r.out_ids for r in runs["re-prefill"][0]])
        check_kv_pages(dec)
    del dec
    torch.cuda.empty_cache()
    return rec, {"prefill engine": pre_launches, "decode engine": launches}


def kv_drain(device, cfg, params, prompts):
    """drain(0.0) of a ``kv_transfer=True`` engine under load (the first
    KV_FEW prompts cut to DRAIN_CUT, DRAIN_TOKENS each, driven by step()
    until half the streams started, DRAIN_TICKS more): its export donates
    every slot's written prefix; every continuation resumes with its
    ``kv`` on a fresh ``pool_role="decode"`` engine. Gates: every
    continuation with a descriptor adopts all of it (bitwise,
    `check_binds`), each resumed stream carries exactly its missing
    tokens (`resume_continuations`), accounting closed with nothing in
    flight. Reading: agreement with an uninterrupted run."""
    chunk = ENGINE_KNOBS["prefill_chunk"]
    prompts = [p[:DRAIN_CUT] for p in prompts]
    eng, (run,) = run_engine(device, cfg, params, prompts=prompts,
                             tokens=DRAIN_TOKENS)
    full = {str(i): r.out_ids for i, r in enumerate(run[0])}
    del eng
    torch.cuda.empty_cache()
    tkvo.reset_local_store()
    store = tkvo.get_store()
    src = LLMEngine(cfg, params, device=device, kv_transfer=True,
                    **ENGINE_KNOBS)
    reqs = [src.submit(p, max_tokens=DRAIN_TOKENS, stream=True,
                       request_id=str(i)) for i, p in enumerate(prompts)]
    ticks = 0
    while sum(bool(r.out_ids) for r in reqs) < len(reqs) // 2:
        src.step()
        ticks += 1
    for _ in range(DRAIN_TICKS):
        src.step()
    donations = []
    time_donations(src, donations)
    t0 = time.perf_counter()
    out = src.drain(0.0)
    drain_s = time.perf_counter() - t0
    check_drained_source(reqs, DRAIN_TOKENS)
    src_m = src.metrics()
    src_pages = check_kv_pages(src)
    del src
    torch.cuda.empty_cache()
    conts = out["continuations"]
    described = [c for c in conts if c.get("kv")]
    if not described:
        raise AssertionError("the drain exported no descriptor")
    binds, held = [], []

    def hook(eng):
        held.append(eng)
        check_binds(eng, store, binds)

    resumed, resume_s, dst_pages = resume_continuations(
        device, cfg, params, {"pool_role": "decode"}, conts, DRAIN_TOKENS,
        kv=True, hook=hook)
    dst_m = held.pop().metrics()
    adopted = {b["request_id"]: b["adopted_tokens"] for b in binds}
    for c in conts:
        context = len(c["prompt_ids"]) + len(c["generated_ids"])
        want = (min(c["kv"]["n_tokens"], (context - 1) // chunk * chunk)
                if c.get("kv") else 0)
        if adopted.get(c["request_id"], 0) != want:
            raise AssertionError(f"continuation {c['request_id']} adopted "
                                 f"{adopted.get(c['request_id'])} of {want}")
    if dst_m["kv_adopt_failures"] or dst_m["kv_adoptions"] != len(described):
        raise AssertionError(f"drain resume: {dst_m['kv_adoptions']} "
                             f"adoptions of {len(described)}, "
                             f"{dst_m['kv_adopt_failures']} failures")
    return {"requests": len(prompts), "ticks_before_drain": ticks
            + DRAIN_TICKS, "exported": out["exported"],
            "with_descriptor": len(described), "drain_s": drain_s,
            "generated_at_drain": sorted(len(c["generated_ids"])
                                         for c in conts),
            "source": {k: src_m[k] for k in (
                "kv_donations", "kv_donated_pages")},
            "resume": {"wall_s": resume_s, **{k: dst_m[k] for k in (
                "kv_adoptions", "kv_adopted_tokens", "kv_adopt_failures",
                "prefill_tokens", "ttft_ms_p50")}},
            "payload_device_to_host": rate(donations),
            "payload_host_to_device": rate(binds),
            "resumed_agreement_with_uninterrupted": agreement_record(
                [r.out_ids for r in resumed],
                [full[c["request_id"]] for c in conts]),
            "page_accounting": {"source": src_pages,
                                "destination": dst_pages},
            "store": store.stats()}


def phase_engine_kv(device, cfg, params):
    """The KV object tier on the engine phase's configuration: (a) a
    prefill→decode handoff of KV_FEW prompts, timed with adoption against
    re-prefill; (b) a drain resumed by adoption; (c) an int8-KV handoff
    of KV_INT8_FEW prompts (its scale planes bitwise equal too); (d) one
    request handed off from tp=2 to tp=1 and one from tp=1 to tp=2. The
    store is reset between parts. Cut to CUT_DEPTH layers. → launches by
    path."""
    cfg, (params,) = first_layers(cfg, (params,), CUT_DEPTH)
    prompts = engine_prompts(cfg)
    few = prompts[:KV_FEW]
    out = {"phase": "engine_kv", "card": card_line(), "layers": CUT_DEPTH,
           "config": f"opt_1_3b bf16, first {CUT_DEPTH} layers, 16 slots, "
                     "max_len 2048, page 64, "
                     "chunk 256, budget 512, attn_impl kernel; payloads "
                     "in host memory (the port's LocalKVStore)"}
    by_path = {}

    def part(name, **kw):
        out[name], counts = kv_handoff(device, cfg, params, **kw)
        by_path.update({f"engine_kv ({name}, {engine})": c
                        for engine, c in counts.items()})

    t0 = time.perf_counter()
    part("handoff", prompts=few, timed=True)
    out["drain"] = kv_drain(device, cfg, params, few)
    part("handoff int8", prompts=few[:KV_INT8_FEW], kv_dtype="int8")
    one = [max(few, key=len)]
    for pre_tp, dec_tp in ((2, 1), (1, 2)):
        part(f"reshard tp={pre_tp} -> tp={dec_tp}", prompts=one,
             pre_tp=pre_tp, dec_tp=dec_tp)
    tkvo.reset_local_store()
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return by_path


# --------------------------------------- lifecycle and observability

WARMUP_WIDTHS = 6     # the ladder at max_len 2048, page 64: 1 .. 32 pages
SNAPSHOT_PERIOD_S = 0.05
EDGE_MAX_LEN, EDGE_PROMPT = 256, 100


def first_window_ms():
    """Wall of the engine's first decode window: its ``llm.decode_window``
    span (the first window is always sampled), which ends after the
    window's host copy."""
    spans = [e for e in profiling.peek_events()
             if e["name"] == "llm.decode_window"]
    return spans[0]["dur"] / 1e3 if spans else None


def warmup_child_run(device, cfg, params, warm: bool) -> dict:
    """One engine's boot: LLMEngine(ENGINE_KNOBS, warmup=warm) started,
    then the engine phase's first prompt served alone. With ``warm`` the
    warmup runs inside start(), each of its dispatches timed to a
    synchronize by a wrapper around prefill_chunk_paged (removed before
    the request). Gate (warm): WARMUP_WIDTHS x 2 dispatches, n_layers
    prefill-kernel launches each. → the record."""
    eng = LLMEngine(cfg, params, device=device, warmup=warm, **ENGINE_KNOBS)
    dispatches = []
    real = pk.prefill_chunk_paged

    def timed(cfg_, params_, tokens, pool, tables, *a, **kw):
        t0 = time.perf_counter()
        out = real(cfg_, params_, tokens, pool, tables, *a, **kw)
        torch.cuda.synchronize()
        dispatches.append({"width": int(tables.shape[1]),
                           "head": bool(kw.get("return_logits")),
                           "wall_ms": (time.perf_counter() - t0) * 1e3})
        return out

    torch.cuda.synchronize()
    pa.reset_launch_counts()
    pk.prefill_chunk_paged = timed
    try:
        t0 = time.perf_counter()
        eng.start()
        start_s = time.perf_counter() - t0
    finally:
        pk.prefill_chunk_paged = real
    warm_launches = launch_counts()
    profiling.drain_events()
    try:
        req = eng.submit(engine_prompts(cfg)[0], max_tokens=ENGINE_TOKENS)
        if not req.done.wait(timeout=600):
            raise AssertionError("first request timed out")
    finally:
        eng.stop()
    check_outputs(cfg, [req], ENGINE_TOKENS)
    rec = {"warmup": warm, "start_s": start_s,
           "warmup_dispatches": len(dispatches),
           "warmup_dispatch_wall_ms": dispatches,
           "warmup_launches": warm_launches,
           "first_request_prompt_tokens": len(req.prompt_ids),
           "first_request_ttft_s": req.first_token_at - req.submitted_at,
           "first_window_ms": first_window_ms(),
           "first_stream": req.out_ids}
    if warm:
        want = WARMUP_WIDTHS * 2
        if (len(dispatches) != want or warm_launches[
                "paged_prefill_attention"] != want * cfg.n_layers
                or sorted({d["width"] for d in dispatches})
                != eng._width_ladder() or len(eng._width_ladder())
                != WARMUP_WIDTHS):
            raise AssertionError(f"warmup issued {len(dispatches)} "
                                 f"dispatches, launches {warm_launches}")
    elif dispatches or any(warm_launches.values()):
        raise AssertionError("an unwarmed start dispatched")
    return rec


def warmup_child_main(mode: str) -> int:
    """``--warmup-child on|off``: one fresh process's boot
    (`warmup_child_run` at opt_1_3b), its record as the last stdout
    line. The kernel library is the parent's build (loaded, not built)."""
    device = torch.device("cuda")
    cfg = gpt.GPTConfig.opt_1_3b(dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params = pk.serving_params(cfg, gpt.init_params(cfg, gen, device),
                               device)
    rec = warmup_child_run(device, cfg, params, mode == "on")
    print(json.dumps(rec), flush=True)
    return 0


def warmup_children() -> dict:
    """Child (a) with warmup=True, then child (b) with warmup=False, each
    a fresh process of this script on the same card, one after the
    other. → {"on": record, "off": record}."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    for mode in ("on", "off"):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warmup-child",
             mode], capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"warmup child {mode} failed "
                                 f"({res.returncode}): {res.stderr[-3000:]}")
        out[mode] = json.loads(res.stdout.strip().splitlines()[-1])
        out[mode]["process_wall_s"] = time.perf_counter() - t0
    return out


def fill_pool(pool, seed):
    """Seeded values in every plane of a pool (positive scales), as a live
    pool holds."""
    g = torch.Generator(device=pool["k"].device).manual_seed(seed)
    for name, a in pool.items():
        if name.endswith("_scale"):
            a.copy_(torch.rand(a.shape, generator=g, device=a.device) + 0.01)
        elif a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                  device=a.device))
        else:
            a.copy_(torch.randn(a.shape, generator=g, device=a.device))


def warmup_leaves_pool(device, cfg, params, kv_dtype):
    """Gate: warmup_compile on a pool filled with seeded values leaves
    every plane outside the null page bitwise unchanged (int8: the scale
    planes too)."""
    eng = LLMEngine(cfg, params, device=device, kv_dtype=kv_dtype,
                    **ENGINE_KNOBS)
    fill_pool(eng.cache, 1)
    before = {k: v[:, 1:].clone() for k, v in eng.cache.items()}
    n = eng.warmup_compile()
    changed = [k for k, v in eng.cache.items()
               if not torch.equal(v[:, 1:], before[k])]
    del eng, before
    torch.cuda.empty_cache()
    if n != WARMUP_WIDTHS * 2 or changed:
        raise AssertionError(f"{kv_dtype} warmup: {n} dispatches, planes "
                             f"changed outside the null page: {changed}")
    return {"dispatches": n, "planes_unchanged_outside_null_page": True}


def phase_engine_warmup(device, cfg, params, children, build_s):
    """The two boots' records beside each other, the pool gate on the
    float and the int8 pool, and whether the two first streams agree."""
    on, off = children["on"], children["off"]
    emit({"phase": "engine_warmup",
          "config": "opt_1_3b bf16, 16 slots, max_len 2048, page 64, "
                    "chunk 256, budget 512, kernel",
          "parent_library_build_s": build_s,
          "warmed": {k: v for k, v in on.items() if k != "first_stream"},
          "unwarmed": {k: v for k, v in off.items() if k != "first_stream"},
          "pool_gate": {kv: warmup_leaves_pool(device, cfg, params, kv)
                        for kv in ("bf16", "int8")},
          "first_streams_agree": on["first_stream"] == off["first_stream"],
          "first_stream_agreement": agreement([on["first_stream"]],
                                              [off["first_stream"]])[0]})


def gauge_values():
    return {key: dict(g.snapshot()).get(("local",))
            for key, g in serve_llm._LOAD_GAUGES.items()}


def prom_count(text, metric, tags):
    """A histogram series' _count (0 when absent) in exposition text."""
    label = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    m = re.search(rf"^{metric}_count\{{{re.escape(label)}\}} (\S+)$", text,
                  re.M)
    return float(m.group(1)) if m else 0.0


def hook_host_us(eng, n=20000):
    """Host µs per decode window of the hooks this slice added, each
    timed alone over ``n`` calls: the disarmed chaos point, the span
    sampler (1 in 64 calls records a span), the step histogram with its
    tags, the decode EWMA."""
    tags = eng._impl_tags()

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def sampled_span():
        with eng._sampled_span("llm.hook_probe"):
            pass

    # A histogram of the step histogram's shape, so the probe's samples
    # stay out of the engine's series.
    probe = profiling.Histogram(
        "chip_smoke_hook_probe_s",
        boundaries=serve_llm._DECODE_STEP_HIST.boundaries,
        tag_keys=serve_llm._DECODE_STEP_HIST.tag_keys)
    parts = {
        "chaos_hit": per_call(lambda: tchaos.hit("llm.decode_window")),
        "sampled_span": per_call(sampled_span),
        "decode_step_hist": per_call(lambda: probe.observe(0.01, tags=tags)),
        "decode_ewma": per_call(lambda: eng._ewma(1.0, 2.0)),
    }
    probe.remove(tags=tags)
    profiling.drain_events()
    return {"us_per_window": sum(parts.values()), "parts_us": parts}


def phase_engine_observe(device, cfg, params, engine_out):
    """The engine phase's traffic through start() (the engine thread),
    a poller calling load_snapshot() every SNAPSHOT_PERIOD_S. Gates: each
    snapshot's llm_* gauges equal its fields (0 when absent); the
    Prometheus text's decode-step count grew by the decode windows; the
    per-width dispatch counter grew by prefill_dispatches; the span ring
    holds ceil(windows / 64) llm.decode_window spans and the first
    request's llm.ttft tree (a root and its three children). Then a drain
    under load: the same traffic, drain(0.0) with the thread running once
    half the streams have started, every continuation resumed on a fresh
    engine with exactly its missing tokens. Cut to CUT_DEPTH layers, for
    the whole script's time limit."""
    cfg, (params,) = first_layers(cfg, (params,), CUT_DEPTH)
    tags = {"impl": "paged-kernel", "replica": "local"}
    text0 = profiling.prometheus_text(profiling.metrics_snapshot())
    widths0 = {r["tags"]["width"]: r["value"]
               for r in profiling.metrics_snapshot()
               if r["name"] == "llm_prefill_dispatch_total"}
    profiling.drain_events()
    eng = LLMEngine(cfg, params, device=device, **ENGINE_KNOBS)
    prompts = engine_prompts(cfg)
    series, bad = [], []
    stop = threading.Event()

    def poll():
        t0 = time.perf_counter()
        while not stop.is_set():
            snap = eng.load_snapshot()
            gauges = gauge_values()
            if gauges != {k: float(snap.get(k, 0.0)) for k in gauges}:
                bad.append((snap, gauges))
            series.append({"t_s": round(time.perf_counter() - t0, 3),
                           **{k: snap.get(k) for k in (
                               "queue_depth", "active_slots",
                               "prefilling_slots", "pool_utilization",
                               "ttft_ewma_ms", "decode_tok_s_ewma",
                               "prefill_budget_util")}})
            stop.wait(SNAPSHOT_PERIOD_S)

    torch.cuda.synchronize()
    pa.reset_launch_counts()
    reqs = [eng.submit(p, max_tokens=ENGINE_TOKENS) for p in prompts]
    poller = threading.Thread(target=poll, name="load-poller")
    t0 = time.perf_counter()
    poller.start()
    eng.start()
    try:
        for r in reqs:
            if not r.done.wait(timeout=600):
                raise AssertionError("engine request timed out")
    finally:
        eng.stop()
        stop.set()
        poller.join(timeout=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_outputs(cfg, reqs, ENGINE_TOKENS)
    check_pages(eng)
    m = eng.metrics()
    # As a serving front end does, once per finished request.
    for r in reqs:
        serve_llm._observe_request_metrics(r, serve_llm._request_metric_tags())
    if bad or not series:
        raise AssertionError(f"{len(bad)} snapshots whose gauges differ "
                             f"from their fields: {bad[:1]}")
    text = profiling.prometheus_text(profiling.metrics_snapshot())
    steps = prom_count(text, "serve_llm_decode_step_s", tags) - prom_count(
        text0, "serve_llm_decode_step_s", tags)
    req_tags = {"replica": "local", "route": ""}
    ttfts = prom_count(text, "serve_llm_ttft_s", req_tags) - prom_count(
        text0, "serve_llm_ttft_s", req_tags)
    widths = {r["tags"]["width"]: r["value"] - widths0.get(r["tags"]["width"],
                                                          0.0)
              for r in profiling.metrics_snapshot()
              if r["name"] == "llm_prefill_dispatch_total"}
    if (steps != m["decode_windows"] or ttfts != len(reqs)
            or sum(widths.values()) != m["prefill_dispatches"]):
        raise AssertionError(f"exposition: {steps} decode steps for "
                             f"{m['decode_windows']} windows, {ttfts} TTFT "
                             f"samples, dispatches {widths} for "
                             f"{m['prefill_dispatches']}")
    events = [e for e in profiling.peek_events() if e["cat"] == "serve_llm"]
    n_windows = sum(e["name"] == "llm.decode_window" for e in events)
    roots = [e for e in events if e["name"] == "llm.ttft"]
    first = min(reqs, key=lambda r: r.first_token_at)
    tree = tracing.build_trace_tree(events, roots[0]["args"]["trace_id"]) \
        if roots else None
    kids = ([c["name"] for c in tree["spans"][0]["children"]]
            if tree and len(tree["spans"]) == 1 else [])
    if (n_windows != -(-m["decode_windows"] // eng._SPAN_SAMPLE)
            or len(roots) != -(-len(reqs) // eng._TTFT_SPAN_SAMPLE)
            or roots[0]["args"]["request_id"] != first.request_id
            or kids != ["llm.ttft.queue_wait", "llm.ttft.prefill",
                        "llm.ttft.first_token"]):
        raise AssertionError(f"spans: {n_windows} windows of "
                             f"{m['decode_windows']}, {len(roots)} ttft "
                             f"roots, children {kids}")
    hooks = hook_host_us(eng)
    del eng
    torch.cuda.empty_cache()
    out = {"phase": "engine_observe",
           "config": "opt_1_3b bf16, the engine phase's knobs, start()",
           "wall_s": wall, "launches": launches,
           "decode_windows": m["decode_windows"],
           "prefill_dispatches": m["prefill_dispatches"],
           "snapshots": len(series),
           "snapshot_period_s": SNAPSHOT_PERIOD_S,
           "load_series": series[::max(1, len(series) // 60)],
           "exposition_decode_step_count": steps,
           "exposition_ttft_count": ttfts,
           "dispatches_by_width": widths,
           "decode_window_spans": n_windows, "ttft_roots": len(roots),
           "ttft_tree_children": kids,
           "hook_host_cost": hooks,
           **{k: m.get(k) for k in ("decode_step_ms_p50",
                                    "decode_step_ms_p95", "ttft_ms_p50",
                                    "ttft_ms_p95")},
           "engine_phase_decode_step_ms_p50": (
               engine_out or {}).get("decode_step_ms_p50")}
    out["drain_under_load"] = drain_under_load(device, cfg, params, prompts)
    emit(out)
    return launches


def drain_under_load(device, cfg, params, prompts):
    """The engine phase's traffic through start(); drain(0.0) while the
    thread runs, once half the streams have started; the continuations
    resumed on a fresh engine (`resume_continuations`)."""
    src = LLMEngine(cfg, params, device=device, **ENGINE_KNOBS)
    reqs = [src.submit(p, max_tokens=ENGINE_TOKENS, stream=True,
                       request_id=str(i)) for i, p in enumerate(prompts)]
    src.start()
    deadline = time.monotonic() + 600
    while sum(bool(r.out_ids) for r in reqs) < len(reqs) // 2:
        if time.monotonic() > deadline:
            src.stop()
            raise AssertionError("streams never started")
        time.sleep(0.005)
    started = sum(bool(r.out_ids) for r in reqs)
    t0 = time.perf_counter()
    out = src.drain(0.0)
    drain_s = time.perf_counter() - t0
    check_drained_source(reqs, ENGINE_TOKENS)
    src_pages = check_pages(src)
    del src
    torch.cuda.empty_cache()
    conts = out["continuations"]
    if not conts:
        raise AssertionError("the drain under load exported nothing")
    _resumed, resume_s, dst_pages = resume_continuations(
        device, cfg, params, {}, conts, ENGINE_TOKENS)
    return {"streams_started_at_drain": started,
            "exported": out["exported"], "drain_s": drain_s,
            "generated_at_drain": sorted(len(c["generated_ids"])
                                         for c in conts),
            "resume_wall_s": resume_s,
            "page_accounting": {"source": src_pages,
                                "destination": dst_pages}}


def phase_engine_edge(device, cfg, params):
    """Paged one-shot and chunked kernel engines at max_len EDGE_MAX_LEN
    (a multiple of page 64), 2 slots: a request runs into max_len beside
    a short one. Gates: it finishes truncated with no error after
    max_len - prompt + 1 tokens, the pages balance. Then a chaos raise
    rule at llm.decode_window (after 2 windows) on the chunked engine:
    every request ends with the engine-death error, a later submit
    raises, nothing hangs. Cut to CUT_DEPTH layers."""
    cfg, (params,) = first_layers(cfg, (params,), CUT_DEPTH)
    rng = np.random.default_rng(ENGINE_PROMPT_SEED + 3)
    prompt = list(map(int, rng.integers(1, cfg.vocab_size, EDGE_PROMPT)))
    short = list(map(int, rng.integers(1, cfg.vocab_size, 40)))
    knobs = {"one-shot": dict(prefill_chunk=0),
             "chunked": dict(prefill_chunk=64, prefill_token_budget=128)}
    out = {"phase": "engine_edge", "layers": CUT_DEPTH,
           "config": f"opt_1_3b bf16, first {CUT_DEPTH} layers, kernel, "
                     f"n_slots 2, max_len {EDGE_MAX_LEN}, page 64"}
    counts = {}
    for arm, kw in knobs.items():
        eng = LLMEngine(cfg, params, device=device, **{
            **ENGINE_KNOBS, "n_slots": 2, "max_len": EDGE_MAX_LEN, **kw})
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        long_req = eng.submit(prompt, max_tokens=4 * EDGE_MAX_LEN)
        short_req = eng.submit(short, max_tokens=8)
        eng.start()
        try:
            for r in (long_req, short_req):
                if not r.done.wait(timeout=300):
                    raise AssertionError(f"{arm}: a request hung")
        finally:
            eng.stop()
        counts[arm] = launch_counts()
        want = EDGE_MAX_LEN - EDGE_PROMPT + 1
        if (long_req.error or short_req.error or not long_req.truncated
                or len(long_req.out_ids) != want
                or len(short_req.out_ids) != 8):
            raise AssertionError(f"{arm}: {long_req.error or short_req.error}"
                                 f", truncated {long_req.truncated}, "
                                 f"{len(long_req.out_ids)} tokens of {want}")
        out[arm] = {"tokens": len(long_req.out_ids), "truncated": True,
                    "launches": counts[arm],
                    "page_accounting": check_pages(eng)}
        del eng
        torch.cuda.empty_cache()
    eng = LLMEngine(cfg, params, device=device, **{
        **ENGINE_KNOBS, "n_slots": 2, "max_len": EDGE_MAX_LEN,
        **knobs["chunked"]})
    reqs = [eng.submit(p, max_tokens=64) for p in (prompt, short)]
    tchaos.install([{"site": "llm.decode_window", "action": "raise",
                     "after": 2}])
    t0 = time.perf_counter()
    eng.start()
    try:
        for r in reqs:
            if not r.done.wait(timeout=300):
                raise AssertionError("chaos: a request hung")
    finally:
        eng.stop()
        tchaos.uninstall()
    errors = [r.error for r in reqs]
    if not all(e and e.startswith("engine died: ChaosError(")
               for e in errors):
        raise AssertionError(f"chaos: request errors {errors}")
    try:
        eng.submit(short, max_tokens=1)
        raise AssertionError("chaos: a submit after the death was taken")
    except RuntimeError as e:
        if "engine died" not in str(e):
            raise
    out["chaos"] = {"rule": "raise at llm.decode_window after 2",
                    "errors": errors, "tokens_before_death": [
                        len(r.out_ids) for r in reqs],
                    "death_wall_s": time.perf_counter() - t0}
    del eng
    torch.cuda.empty_cache()
    emit(out)
    return counts


# ----------------------------------------------------------------- runtime

# The engine actor's knobs, given only to init(_system_config=...): the
# engine phase's configuration, and llm_tp = 3, which 32 heads do not
# divide (soft-disabled to 1 in the actor's engine).
RUNTIME_SYSTEM_CONFIG = {"llm_kv_mode": "paged", "llm_prefill_chunk": 256,
                         "llm_prefill_token_budget": 512,
                         "llm_attn_impl": "kernel", "llm_tp": 3}
RUNTIME_KERNEL_SEED = 14
KV_PAYLOAD_BYTES = 956 * 10**6   # engine_kv's adopted payload at full depth
OOB_PICKLE_BYTES = 64 * 1024     # out-of-band: the pickle stream below this
ACTOR_MEMORY_SLACK = 2**30       # a killed actor's memory comes back within
ROUND_TRIPS = 200


def runtime_kernel_calls(device):
    """The two float paged kernels on seeded inputs at the engine's
    shapes (bf16, page 64, opt_1_3b's 32 heads of 64): one decode call
    over 16 slots of 1-2048 positions and one prefill call of 16 rows of
    C = 256 at ragged offsets. The seed gives the same inputs in every
    process. → (decode out, prefill out)."""
    rng = np.random.default_rng(RUNTIME_KERNEL_SEED)
    bf16, n_pg, C = torch.bfloat16, CAP // 64, 256
    kp, vp, tables, lengths, _ = paged_pool(
        rng, rng.integers(1, CAP + 1, 16), ps=64, n_pg=n_pg, dtype=bf16,
        device=device)
    q = torch.from_numpy(rng.normal(size=(16, H, K)).astype(
        np.float32)).to(device, bf16)
    args = [torch.from_numpy(a).to(device) for a in (tables, lengths)]
    dec_out = pa.paged_attention(q, kp, vp, *args)
    offs = rng.integers(0, CAP - C, 16).astype(np.int32)
    kp, vp, tables, lens, _ = paged_pool(
        rng, offs + C, ps=64, n_pg=n_pg, dtype=bf16, device=device)
    q = torch.from_numpy(rng.normal(size=(16, C, H, K)).astype(
        np.float32)).to(device, bf16)
    args = [torch.from_numpy(a).to(device) for a in (tables, offs, lens)]
    pre_out = pa.paged_prefill_attention(q, kp, vp, *args)
    torch.cuda.synchronize(device)
    return dec_out, pre_out


def runtime_kernel_task():
    """Both kernels in a worker. Each CUDA output is a return of its own,
    so the object plane moves it to the host; then the worker's launch
    counters and its pid."""
    pa.reset_launch_counts()
    dec_out, pre_out = runtime_kernel_calls(torch.device("cuda"))
    # The pooled worker keeps its CUDA context after the task; let it keep
    # no cached blocks of the inputs as well.
    torch.cuda.empty_cache()
    return dec_out, pre_out, launch_counts(), os.getpid()


def runtime_digest(t):
    """A task on a worker: the payload's digest, dtype and shape."""
    raw = t.contiguous().view(torch.uint8).numpy()
    return (hashlib.blake2b(raw).hexdigest(), str(t.dtype), tuple(t.shape),
            os.getpid())


def runtime_hold(started, release):
    """A task that keeps its (pooled) worker busy until ``release``
    exists, so that the next lease spawns a fresh worker."""
    open(started, "w").close()
    deadline = time.monotonic() + 600
    while not os.path.exists(release) and time.monotonic() < deadline:
        time.sleep(0.01)
    return os.getpid()


class RuntimeEngine:
    """LLMEngine(opt_1_3b) in an actor's worker, from seed 0 on cuda,
    every knob from the runtime's config (none passed here)."""

    def __init__(self, n_slots, max_len):
        t0 = time.perf_counter()
        self.cuda_was_up = torch.cuda.is_initialized()
        self.free_at_start = torch.cuda.mem_get_info()[0]
        self.cfg = gpt.GPTConfig.opt_1_3b(dtype=torch.bfloat16)
        self.eng = LLMEngine(self.cfg, seed=0, device="cuda",
                             n_slots=n_slots, max_len=max_len)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0

    def ping(self):
        return None

    def info(self):
        e = self.eng
        return {"pid": os.getpid(), "init_s": self.init_s,
                "cuda_was_up": self.cuda_was_up,
                "free_at_start_gb": self.free_at_start / 1e9,
                "knobs": {"kv_mode": e.kv_mode, "page_size": e.page_size,
                          "prefill_chunk": e.prefill_chunk,
                          "prefill_token_budget": e.prefill_budget,
                          "attn_impl": e.attn_impl,
                          "decode_block": e.decode_block, "tp": e.tp},
                "tp_disabled_reason": e._tp_disabled_reason,
                "memory_reserved_gb": torch.cuda.memory_reserved() / 1e9}

    def serve(self, prompts, tokens):
        """run_engine's round inside the actor: launch counters zeroed
        just before, read just after; each finished request's metrics
        observed as a front end does."""
        eng = self.eng
        torch.cuda.synchronize()
        eng.reset_stats()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_tokens=tokens) for p in prompts]
        eng.start()
        try:
            for r in reqs:
                if not r.done.wait(timeout=600):
                    raise AssertionError("engine request timed out")
        finally:
            eng.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check_outputs(self.cfg, reqs, tokens)
        acc = check_pages(eng)
        tags = serve_llm._request_metric_tags()
        for r in reqs:
            serve_llm._observe_request_metrics(r, tags)
        replicas = sorted({dict(row["tags"]).get("replica")
                           for row in profiling.metrics_snapshot()
                           if row["name"] == "serve_llm_ttft_s"})
        m = eng.metrics()
        import ray_tpu_torch

        return {"streams": [r.out_ids for r in reqs], "launches": launches,
                "wall_s": wall, "page_accounting": acc,
                "replicas": replicas,
                "actor_id": (ray_tpu_torch.get_runtime_context()
                             .get_actor_id()),
                **{k: m.get(k) for k in (
                    "decode_steps", "decode_windows", "prefill_dispatches",
                    "ttft_ms_p50", "ttft_ms_p95", "decode_step_ms_p50",
                    "engine_decode_tok_s")}}


def runtime_worker_logs(session_dir, name="worker-*.log") -> str:
    return "".join(open(p, errors="replace").read() for p in sorted(
        glob.glob(os.path.join(session_dir, "logs", name))))


def free_memory() -> int:
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def phase_runtime(device, engine_ref):
    """The port's runtime on the card: init (real GCS, raylet and worker
    subprocesses), the two kernels in a num_gpus=1 task, a payload of
    engine_kv's size on the object plane, LLMEngine(opt_1_3b) in a
    num_gpus=1 actor from the runtime's config, and the actor's kill.
    ``engine_ref``: the engine phase's (record, streams), else the phase
    runs it first. → the actor's launch counts."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import _native
    from ray_tpu_torch import api as rt_api
    from ray_tpu_torch.core import serialization as ser

    t_phase = time.perf_counter()
    if engine_ref is None:
        cfg, _masters, params = make_params(device)
        del _masters
        _, ref_record, ref_streams = phase_engine(device, cfg, params)
        del cfg, params
    else:
        ref_record, ref_streams = engine_ref
    torch.cuda.empty_cache()
    out = {"phase": "runtime", "card": card_line(),
           "system_config": RUNTIME_SYSTEM_CONFIG}
    t0 = time.perf_counter()
    rt.init(num_cpus=4, resources={"GPU": 1},
            _system_config=RUNTIME_SYSTEM_CONFIG)
    try:
        out["init_s"] = time.perf_counter() - t0
        session = rt_api._node.session_dir
        raylet_log = runtime_worker_logs(session, "raylet.log")
        out["native_arena"] = (_native.load() is not None
                               and "Python fallback" not in raylet_log)
        if not out["native_arena"]:
            raise AssertionError("the object store's native arena did not "
                                 "load (Python fallback)")

        # The kernels in a worker, against the same calls here.
        t0 = time.perf_counter()
        refs = rt.remote(num_gpus=1, num_returns=4)(
            runtime_kernel_task).remote()
        w_dec, w_pre, w_counts, task_pid = rt.get(refs, timeout=300)
        task_s = time.perf_counter() - t0
        d_dec, d_pre = runtime_kernel_calls(device)
        bitwise = {"paged_attention": torch.equal(w_dec, d_dec.cpu()),
                   "paged_prefill_attention": torch.equal(w_pre,
                                                          d_pre.cpu())}
        out["kernel_task"] = {
            "wall_s": task_s, "pid": task_pid,
            "outputs_on": sorted({str(w_dec.device), str(w_pre.device)}),
            "shapes": [list(w_dec.shape), list(w_pre.shape)],
            "bitwise_equal_driver": bitwise, "worker_launches": w_counts}
        if not all(bitwise.values()) or w_dec.device.type != "cpu" or (
                w_pre.device.type != "cpu"):
            raise AssertionError(f"worker kernel outputs: "
                                 f"{out['kernel_task']}")
        if min(w_counts["paged_attention"],
               w_counts["paged_prefill_attention"]) <= 0:
            raise AssertionError(f"worker launches: {w_counts}")
        del w_dec, w_pre, d_dec, d_pre, refs
        torch.cuda.empty_cache()

        # The object plane: a bf16 CPU tensor of engine_kv's payload size
        # at full depth.
        gen = torch.Generator().manual_seed(RUNTIME_KERNEL_SEED)
        payload = torch.randint(-2**15, 2**15, (KV_PAYLOAD_BYTES // 2,),
                                dtype=torch.int16, generator=gen).view(
            torch.bfloat16)
        head, views = ser.serialize(payload)
        digest = hashlib.blake2b(
            payload.view(torch.uint8).numpy()).hexdigest()
        t0 = time.perf_counter()
        ref = rt.put(payload, _cache_local=False)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.get(ref, timeout=300)
        get_s = time.perf_counter() - t0
        remote = rt.get(rt.remote(runtime_digest).remote(ref), timeout=300)
        # Beside them, the payload's pageable host<->card copies: the
        # kind of copy engine_kv's KV binds make.
        t0 = time.perf_counter()
        on_card = payload.to(device)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_card.cpu()
        d2h_s = time.perf_counter() - t0
        del on_card
        # A second put of the same bytes once the first is freed: the best
        # fit hands it the first's extent, whose shared-memory pages are
        # already in, so the two puts differ by the first writes' faults.
        rt.free([ref])
        client = rt_api._client
        shm_before_put2 = client._run(
            client.raylet.call("store_stats", {}))["shm_bytes"]
        t0 = time.perf_counter()
        ref = rt.put(payload, _cache_local=False)
        put2_s = time.perf_counter() - t0
        plane = {"bytes": KV_PAYLOAD_BYTES, "pickle_bytes": len(head),
                 "out_of_band_bytes": [len(v) for v in views],
                 "put_s": put_s, "put_GBps": KV_PAYLOAD_BYTES / put_s / 1e9,
                 "put2_s": put2_s,
                 "put2_GBps": KV_PAYLOAD_BYTES / put2_s / 1e9,
                 "shm_bytes_before_put2": shm_before_put2,
                 "get_s": get_s, "get_GBps": KV_PAYLOAD_BYTES / get_s / 1e9,
                 "driver_get_bitwise": torch.equal(
                     back.view(torch.int16), payload.view(torch.int16)),
                 "worker_get_bitwise": remote[0] == digest,
                 "worker": {"dtype": remote[1], "shape": list(remote[2]),
                            "pid": remote[3]},
                 "h2d_GBps": KV_PAYLOAD_BYTES / h2d_s / 1e9,
                 "d2h_GBps": KV_PAYLOAD_BYTES / d2h_s / 1e9}
        out["object_plane"] = plane
        if not (plane["driver_get_bitwise"] and plane["worker_get_bitwise"]
                and len(head) < OOB_PICKLE_BYTES
                and plane["out_of_band_bytes"] == [KV_PAYLOAD_BYTES]):
            raise AssertionError(f"object plane: {plane}")
        del payload, back, head, views
        rt.free([ref])
        del ref
        torch.cuda.empty_cache()

        # The engine actor, on a fresh worker: the pooled one (which ran
        # the tasks and keeps its CUDA context) is held busy meanwhile.
        free0 = free_memory()
        started = os.path.join(session, "hold.started")
        release = os.path.join(session, "hold.release")
        hold = rt.remote(runtime_hold).remote(started, release)
        deadline = time.monotonic() + 120
        while not os.path.exists(started) and time.monotonic() < deadline:
            time.sleep(0.01)
        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(RuntimeEngine).remote(
            ENGINE_KNOBS["n_slots"], ENGINE_KNOBS["max_len"])
        info = rt.get(actor.info.remote(), timeout=600)
        creation_s = time.perf_counter() - t0
        open(release, "w").close()
        hold_pid = rt.get(hold, timeout=60)
        prompts = engine_prompts(gpt.GPTConfig.opt_1_3b())
        served = rt.get(actor.serve.remote(prompts, ENGINE_TOKENS),
                        timeout=900)
        trips = []
        for _ in range(ROUND_TRIPS):
            t0 = time.perf_counter()
            rt.get(actor.ping.remote(), timeout=60)
            trips.append((time.perf_counter() - t0) * 1e6)
        free_held = free_memory()
        launches = served.pop("launches")
        streams = served.pop("streams")
        n_layers = gpt.GPTConfig.opt_1_3b().n_layers
        per_step = launches["paged_attention"] / max(1,
                                                     served["decode_steps"])
        logs = runtime_worker_logs(session)
        out["actor"] = {
            **info, "creation_wall_s": creation_s,
            "fresh_worker": info["pid"] not in (task_pid, hold_pid)
            and not info["cuda_was_up"],
            "launches": launches, "decode_launches_per_step": per_step,
            "streams_equal_in_process": streams == ref_streams,
            "tp_soft_off_logged": "llm_tp soft-disabled to 1" in logs,
            **served,
            "in_process": {k: ref_record.get(k) for k in (
                "wall_s", "ttft_ms_p50", "ttft_ms_p95",
                "decode_step_ms_p50", "engine_decode_tok_s")},
            "method_round_trip_us_p50": float(np.median(trips)),
            "method_round_trip_us_p95": float(np.percentile(trips, 95))}
        a = out["actor"]
        bad = []
        if not a["streams_equal_in_process"]:
            bad.append("streams differ from the in-process engine's")
        if per_step != n_layers or launches["paged_prefill_attention"] <= 0:
            bad.append(f"launches {launches}, {per_step} per decode step")
        if launches["paged_attention_int8"] or launches[
                "paged_prefill_attention_int8"]:
            bad.append(f"an int8 program ran: {launches}")
        if not (a["knobs"]["tp"] == 1 and a["tp_soft_off_logged"]
                and "does not divide the model's n_heads (32)"
                in a["tp_disabled_reason"]):
            bad.append("llm_tp=3 not soft-disabled with its reason logged")
        if a["knobs"] != {"kv_mode": "paged", "page_size": 64,
                          "prefill_chunk": 256, "prefill_token_budget": 512,
                          "attn_impl": "kernel", "decode_block": 8,
                          "tp": 1}:
            bad.append(f"knobs {a['knobs']}")
        if not a["fresh_worker"]:
            bad.append("the actor did not start on a fresh worker")
        if a["replicas"] != [a["actor_id"][-8:]]:
            bad.append(f"replica tags {a['replicas']}")
        if bad:
            raise AssertionError(f"engine actor: {bad}; {a}")

        # Teardown.
        rt.kill(actor)
        try:
            rt.get(actor.ping.remote(), timeout=60)
            died = None
        except rt.ActorDiedError as e:
            died = type(e).__name__
        deadline = time.monotonic() + 60
        while True:
            free_after = free_memory()
            if (abs(free_after - free0) <= ACTOR_MEMORY_SLACK
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)
        out["teardown"] = {
            "later_call_raised": died, "held_gb": (free0 - free_held) / 1e9,
            "returned_gb": (free_after - free_held) / 1e9,
            "free_before_gb": free0 / 1e9, "free_after_gb": free_after / 1e9}
        if died is None or abs(free_after - free0) > ACTOR_MEMORY_SLACK:
            raise AssertionError(f"teardown: {out['teardown']}")
    finally:
        rt.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


# --------------------------------------------------------------- serve

SERVE_SYSTEM_CONFIG = {"serve_kv_sweep_interval_s": 2.0,
                       "serve_kv_object_ttl_s": 3600.0,
                       # serve_chaos's drain window, the reference's
                       "serve_drain_timeout_s": 2.0}
SERVE_ENGINE_KW = {**{k: v for k, v in ENGINE_KNOBS.items()
                      if k not in ("n_slots", "max_len")}, "warmup": True}
SERVE_REPLICA_GPUS = 0.5
SERVE_MODEL = "opt_1_3b"   # the replicas' preset: bf16, from the seed 0
SERVE_DEVICE = None        # the replicas' device: cuda, their default
SERVE_SWEEP_WAIT = 3      # x serve_kv_sweep_interval_s for the orphan sweep
# A served greedy stream may leave the in-process engine's only where
# the in-process logits of the two tokens are this close (a bf16 near-
# tie): the replicas batch other requests than the in-process engine
# did, and the decode kernel's split and the dispatch shapes follow the
# batch, so the rounding of the logits does too.
SERVE_TIE_MARGIN = 0.1


def sse_stream(port, route, payload, timeout_s=600.0, on_first=None):
    """One SSE client of the proxy: POST ``payload`` with stream=True and
    read its events to [DONE]; ``on_first()`` runs at the first token.
    → {"tokens", "arrivals" (seconds since the send), "done", "error"}."""
    import socket

    body = json.dumps(dict(payload, stream=True)).encode()
    req = (b"POST " + route.encode() + b" HTTP/1.1\r\nHost: x\r\n"
           b"Content-Type: application/json\r\nContent-Length: "
           + str(len(body)).encode() + b"\r\n\r\n" + body)
    out = {"tokens": [], "arrivals": [], "done": False, "error": None}
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout_s) as s:
        s.sendall(req)
        buf = b""
        while b"\r\n\r\n" not in buf:
            data = s.recv(65536)
            if not data:
                out["error"] = "closed before the response head"
                return out
            buf += data
        head, buf = buf.split(b"\r\n\r\n", 1)
        if not head.startswith(b"HTTP/1.1 200"):
            out["error"] = head.split(b"\r\n", 1)[0].decode()
            return out
        while True:
            idx = buf.find(b"\n\n")
            if idx < 0:
                data = s.recv(65536)
                if not data:
                    return out
                buf += data
                continue
            event, buf = buf[:idx].strip(), buf[idx + 2:]
            if not event.startswith(b"data: "):
                continue
            data = event[len(b"data: "):]
            if data == b"[DONE]":
                out["done"] = True
                return out
            msg = json.loads(data)
            if "token" in msg:
                out["tokens"].append(int(msg["token"]))
                out["arrivals"].append(time.perf_counter() - t0)
                if on_first is not None and len(out["tokens"]) == 1:
                    on_first()
            elif "error" in msg:
                out["error"] = msg["error"]
                return out


def handle_stream(handle, payload):
    """One DeploymentHandle.stream client, in the SSE reader's shape."""
    out = {"tokens": [], "arrivals": [], "done": False, "error": None}
    t0 = time.perf_counter()
    try:
        for tok in handle.stream(payload):
            out["tokens"].append(int(tok))
            out["arrivals"].append(time.perf_counter() - t0)
        out["done"] = True
    except Exception as e:  # noqa: BLE001 — a request error is a gate
        out["error"] = repr(e)
    return out


def start_clients(jobs):
    """Start every ``(fn, args)`` at once, each on its own thread,
    released together. → (threads, results), the results filled in
    order as the threads finish (`join_clients`)."""
    results = [None] * len(jobs)
    gate = threading.Barrier(len(jobs))

    def run(i, fn, args):
        gate.wait()
        try:
            results[i] = fn(*args)
        except Exception as e:  # noqa: BLE001 — reported as the result
            results[i] = {"tokens": [], "arrivals": [], "done": False,
                          "error": repr(e)}

    threads = [threading.Thread(target=run, args=(i, fn, args))
               for i, (fn, args) in enumerate(jobs)]
    for t in threads:
        t.start()
    return threads, results


def join_clients(started):
    threads, results = started
    for t in threads:
        t.join(timeout=900)
    return results


def run_clients(jobs):
    return join_clients(start_clients(jobs))


def pctl_ms(xs, q):
    return float(np.percentile(xs, q)) * 1e3 if xs else None


def replicas_of(rt, ctrl, name):
    """(actor handle, pid) of each routable replica of ``name``, the pid
    from the controller's load table (polled until every replica has
    been probed)."""
    deadline = time.monotonic() + 60
    while True:
        table = rt.get(ctrl.get_routing.remote(-1), timeout=30)
        reps = table["routes"][name]["replicas"]
        load = rt.get(ctrl.get_load.remote(), timeout=30).get(name, {})
        pids = {r["actor_id"]: r.get("pid")
                for r in load.get("replicas", [])}
        got = [(h, pids.get(h._actor_id.hex())) for h in reps]
        if all(p for _h, p in got) or time.monotonic() > deadline:
            return got
        time.sleep(0.2)


def replica_call(rt, h, method, *args, **kwargs):
    return rt.get(h.handle_request.remote(method, args, kwargs),
                  timeout=300)


def wait_ready(port, route):
    """Poll the proxy until ``route`` resolves: an empty body reaches the
    replica, which rejects it before the engine (no kernel runs)."""
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}{route}", data=b"{}"), timeout=60)
            return
        except urllib.error.HTTPError as e:
            if e.code != 404:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"the proxy never routed {route}")


def first_divergence(a, b):
    """Index of the first token where streams ``a`` and ``b`` differ,
    None when equal."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def tie_margins(device, cfg, cases, params=None, **knobs):
    """For each ``(context, ref token, served token)``, |logit(ref) -
    logit(served)| in the logits an in-process engine (the replicas'
    model and knobs, seed 0; or ``params`` and ENGINE_KNOBS updated by
    ``knobs``) samples the token after ``context`` from."""
    if not cases:
        return []
    rows = {}
    eng = LLMEngine(cfg, params, seed=0, device=device,
                    **{**ENGINE_KNOBS, **knobs})
    capture_first_logits(rows)(eng)
    reqs = [eng.submit(ctx, max_tokens=1, request_id=str(i))
            for i, (ctx, _a, _b) in enumerate(cases)]
    eng.start()
    try:
        for r in reqs:
            if not r.done.wait(timeout=600):
                raise AssertionError("tie-margin request timed out")
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    return [abs(float(rows[str(i)][a] - rows[str(i)][b]))
            for i, (_ctx, a, b) in enumerate(cases)]


def stream_cases(prompts, got, ref):
    """Served greedy streams against the in-process engine's: the first
    index where each differs (None when equal), and for each departure
    the (context, in-process token, served token) `tie_margins` reads.
    → (record, cases)."""
    div = [first_divergence(g, r) for g, r in zip(got, ref)]
    cases = [(prompts[i] + ref[i][:t], ref[i][t], got[i][t])
             for i, t in enumerate(div)
             if t is not None and t < min(len(got[i]), len(ref[i]))]
    return {"equal": sum(t is None for t in div), "streams": len(got),
            "first_divergence": div,
            "other_length": [i for i, (g, r) in enumerate(zip(got, ref))
                             if len(g) != len(r)]}, cases


def check_streams(device, cfg, parts, planted, bad, params=None):
    """Each part's served streams equal the in-process engine's or leave
    them at a near-tie (`SERVE_TIE_MARGIN`), which a planted wrong token
    must exceed: ``planted`` (context, in-process token) is scored
    against the token of the next id. The margins of every part come
    from one in-process engine (on ``params`` when given, else the
    replicas' seed-0 weights). ``parts``: {tag: (record, cases)} from
    `stream_cases`; each record gains its margins. Appends failures to
    ``bad``."""
    cases = [c for _rec, cs in parts.values() for c in cs]
    ctx, tok = planted
    margins = tie_margins(device, cfg, cases + [
        (ctx, tok, (tok + 1) % cfg.vocab_size)], params=params)
    i = 0
    for tag, (rec, cs) in parts.items():
        rec["tie_margins"] = margins[i:i + len(cs)]
        rec["tie_margin_bound"] = SERVE_TIE_MARGIN
        rec["planted_wrong_token_margin"] = margins[-1]
        i += len(cs)
        if rec["other_length"]:
            bad.append(f"{tag}: streams of another length: "
                       f"{rec['other_length']}")
        if any(m > SERVE_TIE_MARGIN for m in rec["tie_margins"]):
            bad.append(f"{tag}: a stream left the in-process one off a "
                       f"tie: {rec['tie_margins']}")
    if margins[-1] <= SERVE_TIE_MARGIN:
        bad.append(f"the planted wrong token passed ({margins[-1]})")


def served_record(results):
    ttft = [r["arrivals"][0] for r in results if r["arrivals"]]
    return {"requests": len(results),
            "errors": [r["error"] for r in results if r["error"]],
            "ttft_ms_p50": pctl_ms(ttft, 50),
            "ttft_ms_p95": pctl_ms(ttft, 95),
            "first_token_before_half": [
                bool(r["arrivals"]) and r["arrivals"][0]
                < 0.5 * r["arrivals"][-1] for r in results]}


def serve_fused(rt, serve, ctrl, cfg, prompts, ref_streams, ref_record,
                device, bad):
    """LLMDeployment(opt_1_3b) with 2 replicas at num_gpus=0.5 behind the
    proxy, warmed (`warmup=True`): 8 SSE posts arriving in turn, then 8
    concurrent handle streams."""
    from ray_tpu_torch.serve.llm import LLMDeployment

    free0 = free_memory()
    t0 = time.perf_counter()
    handle = serve.run(serve.deployment(LLMDeployment, name="llm").options(
        num_replicas=2, route_prefix="/llm",
        ray_actor_options={"num_gpus": SERVE_REPLICA_GPUS}).bind(
        SERVE_MODEL, n_slots=ENGINE_KNOBS["n_slots"],
        max_len=ENGINE_KNOBS["max_len"], device=SERVE_DEVICE,
        engine_kwargs=dict(SERVE_ENGINE_KW)), timeout=600.0)
    boot_s = time.perf_counter() - t0
    _proxy, port = serve.start_proxy()
    wait_ready(port, "/llm")
    free_held = free_memory()
    reps = replicas_of(rt, ctrl, "llm")
    before = [replica_call(rt, h, "metrics") for h, _ in reps]
    for h, _ in reps:
        replica_call(rt, h, "kernel_launches", reset=True)
    half = len(prompts) // 2
    payload = lambda p: {"prompt_ids": p, "max_tokens": ENGINE_TOKENS}
    firsts = threading.Semaphore(0)
    t0 = time.perf_counter()
    # The SSE posts arrive one after another, each once the one before
    # has its first token; then the 8 handle streams all at once. Every
    # stream overlaps others. A burst of all 16 would queue each SSE
    # post's prefill behind the others' (512 tokens a tick beside an
    # 8-step decode window), and a first token that late comes after
    # half the stream whether the proxy streams or buffers.
    sse = []
    for p in prompts[half:]:
        sse.append(start_clients([(sse_stream, (
            port, "/llm", payload(p), 600.0, firsts.release))]))
        if not firsts.acquire(timeout=600):
            break
    handles = run_clients([(handle_stream, (handle, payload(p)))
                           for p in prompts[:half]])
    results = handles + [r for s in sse for r in join_clients(s)]
    wall = time.perf_counter() - t0
    launches = [replica_call(rt, h, "kernel_launches") for h, _ in reps]
    after = [replica_call(rt, h, "metrics") for h, _ in reps]
    per_replica = []
    for (h, pid), b, a, n in zip(reps, before, after, launches):
        steps = a["decode_steps"] - b["decode_steps"]
        disp = a["prefill_dispatches"] - b["prefill_dispatches"]
        per_replica.append({
            "pid": pid, "requests": a["completed"] - b["completed"],
            "launches": n, "decode_steps": steps,
            "prefill_dispatches": disp,
            "decode_launches_per_step":
                n["paged_attention"] / max(1, steps),
            "prefill_launches_per_dispatch":
                n["paged_prefill_attention"] / max(1, disp),
            "page_accounting": replica_call(rt, h, "page_accounting")})
    out = {"replicas": 2, "num_gpus_each": SERVE_REPLICA_GPUS,
           "boot_wall_s": boot_s, "wall_s": wall,
           "memory_held_gb_per_replica": (free0 - free_held) / 2e9,
           "handle": served_record(results[:half]),
           "sse": served_record(results[half:]),
           "in_process": {k: ref_record.get(k) for k in (
               "wall_s", "ttft_ms_p50", "ttft_ms_p95")},
           "per_replica": per_replica}
    for route in ("handle", "sse"):
        if out[route]["errors"]:
            bad.append(f"fused {route} request errors "
                       f"{out[route]['errors'][:2]}")
    if not all(out["sse"]["first_token_before_half"]):
        bad.append("fused: an SSE stream's first token came after half "
                   "its total")
    for r in per_replica:
        n = r["launches"]
        if r["requests"] <= 0:
            bad.append(f"fused: replica {r['pid']} served no request")
        if (r["decode_launches_per_step"] != cfg.n_layers
                or r["prefill_launches_per_dispatch"] != cfg.n_layers
                or n["paged_attention_int8"]
                or n["paged_prefill_attention_int8"]):
            bad.append(f"fused: replica {r['pid']} launches {n}, "
                       f"{r['decode_launches_per_step']} per decode step")
        acc = r["page_accounting"]
        if not (acc["closure"] and acc["refs_consistent"]
                and acc["live"] == 0):
            bad.append(f"fused: replica {r['pid']} pages {acc}")
    counts = {k: sum(r["launches"][k] for r in per_replica)
              for k in per_replica[0]["launches"]}
    serve.delete("llm")
    deadline = time.monotonic() + 60
    while True:
        free_after = free_memory()
        if (abs(free_after - free0) <= ACTOR_MEMORY_SLACK
                or time.monotonic() > deadline):
            break
        time.sleep(0.5)
    out["deleted"] = {"free_before_gb": free0 / 1e9,
                      "free_after_gb": free_after / 1e9,
                      "returned_gb": (free_after - free_held) / 1e9}
    if abs(free_after - free0) > ACTOR_MEMORY_SLACK:
        bad.append(f"fused: memory not back after delete {out['deleted']}")
    out["streams"], cases = stream_cases(
        prompts, [r["tokens"] for r in results], ref_streams)
    return out, counts, cases


def rolled_page(payload):
    """A planted fault: the payload with its first page's K plane rolled
    by one position along the page."""
    bad = dict(payload)
    k = payload["k"].clone()
    k[:, 0] = torch.roll(k[:, 0], 1, dims=1)
    bad["k"] = k
    return bad


def index_vs_in_process(rt_api, device, cfg, prompts, bad):
    """Every page set in the cluster store's index, fetched from the
    driver, against an in-process prefill-role engine's donation of the
    same prompts (its LocalKVStore): bitwise per key and plane, and the
    planted fault (a page's K plane rolled), which must differ. → the
    record, with the driver's get and put GB/s of the payloads (the
    replica's objects read across processes; the same bytes put back)."""
    client = rt_api._client
    store = tkvo.ObjectKVStore(client, budget=10**6)
    metas = [json.loads(client.kv_get(tkvo.INDEX_NS, k))
             for k in client.kv_keys(tkvo.INDEX_NS)]
    t0 = time.perf_counter()
    fetched = {m["key"]: store.fetch(m) for m in metas}
    get_s = time.perf_counter() - t0
    nbytes = sum(payload_bytes(p) for p in fetched.values())
    t0 = time.perf_counter()
    refs = [client.put(p, cache_local=False) for p in fetched.values()]
    put_s = time.perf_counter() - t0
    client.free(refs)
    del refs
    local = tkvo.LocalKVStore(budget=10**6)
    eng = LLMEngine(cfg, seed=0, device=device, pool_role="prefill",
                    kv_store=local, **ENGINE_KNOBS)
    kv_serve(eng, [((p,), dict(max_tokens=KV_TOKENS)) for p in prompts])
    del eng
    torch.cuda.empty_cache()
    mine = {k: e["payload"] for k, e in local._entries.items()}
    equal, worst = {}, {}
    for k, p in fetched.items():
        ref = mine.get(k)
        equal[k] = (ref is not None and set(p) == set(ref)
                    and all(same_bits(p[n], ref[n]) for n in p))
        if ref is not None and set(p) == set(ref):
            worst[k] = max(float((p[n].float() - ref[n].float()).abs()
                                 .max()) for n in p)
    first = next(iter(fetched))
    planted = rolled_page(fetched[first])
    planted_equal = all(same_bits(planted[n], mine[first][n])
                        for n in planted)
    rec = {"entries": len(fetched), "in_process_entries": len(mine),
           "bitwise_equal": sum(equal.values()),
           "max_abs_diff": max(worst.values(), default=None),
           "keys_equal": sorted(fetched) == sorted(mine),
           "planted_rolled_page_equal": planted_equal,
           "planted_max_abs_diff": float(max(
               (planted[n].float() - mine[first][n].float()).abs().max()
               for n in planted)),
           "payload_bytes": nbytes,
           "driver_get_GBps": nbytes / get_s / 1e9,
           "driver_put_GBps": nbytes / put_s / 1e9}
    if not (all(equal.values()) and rec["keys_equal"]):
        bad.append(f"split: cluster page sets differ from the in-process "
                   f"donation: {rec['bitwise_equal']} of {len(fetched)} "
                   f"bitwise, max |diff| {rec['max_abs_diff']}")
    if planted_equal:
        bad.append("split: the planted rolled page passed")
    return rec


def serve_split(rt, rt_api, serve, ctrl, cfg, prompts, ref_streams,
                device, bad):
    """kvp (prefill role, pool_peer kvd) and kvd (decode role), one
    replica each at num_gpus=0.5: engine_kv's prompts streamed through
    the proxy, handed off through the cluster store; then the decode leg
    alone, adopted against re-prefilled."""
    from ray_tpu_torch.serve.llm import LLMDeployment

    chunk = ENGINE_KNOBS["prefill_chunk"]
    common = dict(n_slots=ENGINE_KNOBS["n_slots"],
                  max_len=ENGINE_KNOBS["max_len"], device=SERVE_DEVICE,
                  engine_kwargs=dict(SERVE_ENGINE_KW))
    opts = {"ray_actor_options": {"num_gpus": SERVE_REPLICA_GPUS}}
    t0 = time.perf_counter()
    # Both pools boot at once: the decode deployment is not waited for
    # until the prefill one is up.
    decode = serve.deployment(LLMDeployment, name="kvd",
                              pool_role="decode").options(
        num_replicas=1, route_prefix=None, **opts).bind(
        SERVE_MODEL, pool_role="decode", **common)
    serve.run(decode, _blocking_until_ready=False)
    serve.run(serve.deployment(LLMDeployment, name="kvp",
                               pool_role="prefill").options(
        num_replicas=1, route_prefix="/kv", **opts).bind(
        SERVE_MODEL, pool_role="prefill", pool_peer="kvd", **common),
        timeout=600.0)
    deadline = time.monotonic() + 600
    while serve.status()["kvd"]["live_replicas"] < 1:
        if time.monotonic() > deadline:
            raise AssertionError("the decode deployment never came up")
        time.sleep(0.1)
    boot_s = time.perf_counter() - t0
    _proxy, port = serve.start_proxy()
    wait_ready(port, "/kv")
    (kvp, kvp_pid), = replicas_of(rt, ctrl, "kvp")
    (kvd, _), = replicas_of(rt, ctrl, "kvd")
    for h in (kvp, kvd):
        replica_call(rt, h, "kernel_launches", reset=True)
    before = replica_call(rt, kvd, "metrics")
    pre_before = replica_call(rt, kvp, "metrics")
    results = run_clients([(sse_stream, (port, "/kv", {
        "prompt_ids": p, "max_tokens": KV_TOKENS})) for p in prompts])
    launches = {"kvp": replica_call(rt, kvp, "kernel_launches"),
                "kvd": replica_call(rt, kvd, "kernel_launches")}
    after = replica_call(rt, kvd, "metrics")
    pre_after = replica_call(rt, kvp, "metrics")
    d = {k: after[k] - before[k] for k in (
        "kv_adoptions", "kv_adopt_failures", "kv_adopted_tokens",
        "prefill_tokens", "decode_steps", "prefill_dispatches")}
    full = [len(p) // chunk * chunk for p in prompts]
    cold_tails = sum(len(p) + 1 - f for p, f in zip(prompts, full))
    accounting = {n: replica_call(rt, h, "page_accounting")
                  for n, h in (("kvp", kvp), ("kvd", kvd))}
    out = {"boot_wall_s": boot_s, "requests": len(prompts),
           "with_full_chunk": sum(f > 0 for f in full),
           "errors": [r["error"] for r in results if r["error"]],
           "handed_off_ttft_ms_p50": pctl_ms(
               [r["arrivals"][0] for r in results if r["arrivals"]], 50),
           "decode_replica": {**d, "cold_tail_tokens": cold_tails,
                              "launches": launches["kvd"],
                              "decode_launches_per_step": (
                                  launches["kvd"]["paged_attention"]
                                  / max(1, d["decode_steps"]))},
           "prefill_replica": {
               "kv_donations": (pre_after["kv_donations"]
                                - pre_before["kv_donations"]),
               "launches": launches["kvp"]},
           "page_accounting": accounting}
    if out["errors"]:
        bad.append(f"split: request errors {out['errors'][:2]}")
    if (d["kv_adoptions"] != out["with_full_chunk"]
            or d["kv_adopt_failures"]):
        bad.append(f"split: adoptions {d['kv_adoptions']} of "
                   f"{out['with_full_chunk']}, {d['kv_adopt_failures']} "
                   f"failed")
    if d["prefill_tokens"] != cold_tails:
        bad.append(f"split: decode prefilled {d['prefill_tokens']} tokens, "
                   f"the cold tails are {cold_tails}")
    if out["decode_replica"]["decode_launches_per_step"] != cfg.n_layers:
        bad.append(f"split: decode launches {launches['kvd']}")
    for n, acc in accounting.items():
        if not (acc["closure"] and acc["refs_consistent"]
                and acc["live"] == 0 and not acc["exporting"]):
            bad.append(f"split: {n} pages {acc}")
    # The decode leg alone, sent to kvd by handle as (prompt, [first
    # token]): adopting the page sets (a discovery hint over the index)
    # against the same continuations re-prefilled (no hint). The stream
    # returns the seeded first token at once; its second arrival is the
    # decode leg's first new token.
    kvd_handle = serve.get_deployment_handle("kvd")
    firsts = [r["tokens"][:1] for r in results]
    legs = {}
    for arm, hint in (("adopted", {"discover": True}), ("re-prefill", None)):
        m0 = replica_call(rt, kvd, "metrics")
        got = run_clients([(handle_stream, (kvd_handle, {
            "prompt_ids": p, "generated_ids": f, "max_tokens": KV_TOKENS,
            **({"kv": hint} if hint else {})}))
            for p, f in zip(prompts, firsts)])
        m1 = replica_call(rt, kvd, "metrics")
        ttft = [g["arrivals"][1] for g in got if len(g["arrivals"]) > 1]
        legs[arm] = got
        out[f"decode_leg_{arm}"] = {
            "ttft_ms_p50": pctl_ms(ttft, 50),
            "ttft_ms_p95": pctl_ms(ttft, 95),
            "errors": [g["error"] for g in got if g["error"]],
            "adoptions": m1["kv_adoptions"] - m0["kv_adoptions"],
            "prefill_tokens": m1["prefill_tokens"] - m0["prefill_tokens"],
            "equal_to_handoff": sum(
                g["tokens"] == r["tokens"] for g, r in zip(got, results))}
        if out[f"decode_leg_{arm}"]["errors"]:
            bad.append(f"split: decode leg ({arm}) errors")
    if out["decode_leg_adopted"]["adoptions"] != out["with_full_chunk"] or (
            out["decode_leg_re-prefill"]["adoptions"]):
        bad.append("split: the decode legs adopted "
                   f"{out['decode_leg_adopted']['adoptions']} and "
                   f"{out['decode_leg_re-prefill']['adoptions']}")
    out["index"] = index_vs_in_process(rt_api, device, cfg, prompts, bad)
    out["streams"], cases = stream_cases(
        prompts, [r["tokens"] for r in results], ref_streams)
    return out, launches, kvp_pid, cases


def serve_sweep(rt_api, kvp_pid, bad):
    """SIGKILL the prefill replica that donated: within SERVE_SWEEP_WAIT
    sweep intervals its index entries are gone and the node store's
    bytes fall back."""
    import signal

    client = rt_api._client
    stats = lambda: client._run(client.raylet.call("store_stats", {}))
    n_rows = lambda: len(client.kv_keys(tkvo.INDEX_NS))
    donated = n_rows()
    shm0 = stats()["shm_bytes"]
    t0 = time.perf_counter()
    os.kill(kvp_pid, signal.SIGKILL)
    limit = SERVE_SWEEP_WAIT * SERVE_SYSTEM_CONFIG["serve_kv_sweep_interval_s"]
    left = donated
    while left and time.perf_counter() - t0 < limit + 30:
        time.sleep(0.1)
        left = n_rows()
    swept_s = time.perf_counter() - t0
    shm1 = stats()["shm_bytes"]
    out = {"entries_before": donated, "entries_after": left,
           "swept_s": swept_s, "limit_s": limit,
           "shm_bytes_before": shm0, "shm_bytes_after": shm1,
           "freed_bytes": shm0 - shm1}
    if left or swept_s > limit or not shm1 < shm0:
        bad.append(f"orphan sweep: {out}")
    return out


# The zero-drop scenario (bench_chaos_torch.run_scenario) on the card:
# 32 SSE streams of 128-512-token prompts, 32 greedy tokens each, over 3
# replicas at num_gpus 1/3 on the card; the first routable replica's
# kill rule armed kill_delay_s into the burst and fired at its
# kill_after_windows-th decode window after that (mid-decode), and the
# scale-down to 2 right after the arming, so that the controller drains
# a replica while the victim still serves (a victim it has seen die
# first is replaced instead, and no replica would be drained).
SERVE_CHAOS = dict(clients=32, replicas=3, scale_down_to=2, max_tokens=32,
                   prompt_len=(128, 512), drain_timeout_s=2.0, seed=0,
                   kill_after_windows=3, kill_delay_s=0.6,
                   drain_delay_s=0.6)
SERVE_CHAOS_GPUS = 1 / 3
SERVE_CHAOS_CKPT = os.path.join("build", "serve_chaos", "params")


def chaos_params(device):
    """opt_1_3b's bf16 serving weights from seed 0 cut to its first
    CUT_DEPTH layers (full width), saved once as the checkpoint the
    baseline engine and every replica load. → (cfg, params, path)."""
    from ray_tpu_torch.train.checkpoint import Checkpoint

    cfg, masters, params = make_params(device)
    del masters
    cfg, (params,) = first_layers(cfg, [params], CUT_DEPTH)
    path = Checkpoint.from_params(params).to_directory(
        os.path.abspath(SERVE_CHAOS_CKPT))
    torch.cuda.empty_cache()
    return cfg, params, path


def chaos_replica_gates(cfg, detail, bad):
    """Each replica that served the burst from its start and survived
    (neither killed nor drained): its paged-kernel launches, n_layers
    per decode step and per prefill dispatch, no int8 program, and its
    pages closed. A replica that joined later (the killed one's
    replacement) is recorded, not gated. → (records, launches by
    path)."""
    recs, by_path = [], {}
    for aid, r in detail["replicas"].items():
        role = ("killed" if aid == detail["killed"] else
                "drained" if aid in detail["drained"] else
                "survived" if "before" in r else "joined")
        rec = {"replica": aid[:12], "role": role,
               "load_at_drain": {k: r.get("load_at_drain", {}).get(k)
                                 for k in ("active_slots", "queue_depth",
                                           "error")}}
        if "after" in r and "before" in r:
            b, a, n = r["before"], r["after"], r["launches"]
            rec.update(
                launches=n, requests=a["completed"] - b["completed"],
                decode_steps=a["decode_steps"] - b["decode_steps"],
                prefill_dispatches=(a["prefill_dispatches"]
                                    - b["prefill_dispatches"]),
                page_accounting=r["page_accounting"])
        elif "launches" in r:
            rec.update(launches=r["launches"],
                       page_accounting=r["page_accounting"])
        if "error" in r:
            rec["error"] = r["error"]
        recs.append(rec)
        if role == "survived":
            by_path[f"serve_chaos (replica {aid[:8]})"] = rec.get(
                "launches", {})
            n = rec.get("launches")
            acc = rec.get("page_accounting") or {}
            if (n is None or min(n["paged_attention"],
                                 n["paged_prefill_attention"]) <= 0
                    or n["paged_attention"]
                    != cfg.n_layers * rec["decode_steps"]
                    or n["paged_prefill_attention"]
                    != cfg.n_layers * rec["prefill_dispatches"]
                    or n["paged_attention_int8"]
                    or n["paged_prefill_attention_int8"]):
                bad.append(f"serve_chaos: surviving replica {rec}")
            if not (acc.get("closure") and acc.get("refs_consistent")
                    and acc.get("live") == 0):
                bad.append(f"serve_chaos: replica {aid[:8]} pages {acc}")
    if not any(r["role"] == "survived" for r in recs):
        bad.append("serve_chaos: no replica served the burst and survived")
    drained = [r for r in recs if r["role"] == "drained"]
    if len(drained) != 1 or not (
            (drained[0]["load_at_drain"]["active_slots"] or 0)
            + (drained[0]["load_at_drain"]["queue_depth"] or 0)):
        bad.append(f"serve_chaos: the drained replica held no live stream "
                   f"when the scale-down began: {drained}")
    return recs, by_path


def serve_chaos(device, bad):
    """The zero-drop scenario on the serve phase's cluster:
    bench_chaos_torch.run_scenario with opt_1_3b cut to CUT_DEPTH layers
    (one checkpoint for the baseline engine and every replica) and the
    engine phase's knobs. → (record, launches by path, departures and
    the planted wrong token for the tie check, cfg, params)."""
    import bench_chaos_torch

    cfg, params, path = chaos_params(device)
    detail: dict = {}
    t0 = time.perf_counter()
    row = bench_chaos_torch.run_scenario(
        **SERVE_CHAOS, n_slots=ENGINE_KNOBS["n_slots"],
        max_len=ENGINE_KNOBS["max_len"], model=cfg, params_checkpoint=path,
        device=SERVE_DEVICE, engine_kwargs=dict(SERVE_ENGINE_KW),
        replica_gpus=SERVE_CHAOS_GPUS, detail=detail)
    out = {"wall_s": time.perf_counter() - t0, "row": row}
    out["replicas"], by_path = chaos_replica_gates(cfg, detail, bad)
    streams = detail["streams"]
    out["streams"], cases = stream_cases(detail["prompts"], streams,
                                         detail["expected"])
    if row["dropped"] or row["completed"] != SERVE_CHAOS["clients"]:
        bad.append(f"serve_chaos: dropped {row['dropped']}, completed "
                   f"{row['completed']}: {detail['errors']}")
    if any(s is None or len(s) != SERVE_CHAOS["max_tokens"]
           for s in streams):
        bad.append("serve_chaos: streams of another length "
                   f"{[None if s is None else len(s) for s in streams]}")
    if (row["final_live_replicas"], row["final_draining_replicas"]) != (
            SERVE_CHAOS["scale_down_to"], 0):
        bad.append(f"serve_chaos: final replicas {row}")
    if row["serve_failovers_total"] < 1:
        bad.append(f"serve_chaos: no stream failed over: {row}")
    planted = (detail["prompts"][0] + detail["expected"][0][:3],
               detail["expected"][0][3])
    return out, by_path, cases, planted, cfg, params


def phase_serve(device, engine_ref, parts=("serve", "serve_chaos")):
    """The serve plane on the card: LLMDeployment(opt_1_3b) replicas on
    the paged kernels behind handles and the HTTP proxy, a prefill→
    decode pool split through the cluster store, and the orphan sweep
    (``serve``); then, on the same cluster, the zero-drop scenario of a
    replica kill and a scale-down drain (``serve_chaos``). ``parts``
    names those to run; each emits its own line. ``engine_ref``: the
    engine phase's (record, streams), else ``serve`` runs it first.
    Every part runs; the phase fails after its lines if a gate did. →
    launches by path."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api as rt_api
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import _get_controller

    t_phase = time.perf_counter()
    if "serve" in parts:
        if engine_ref is None:
            cfg, _masters, params = make_params(device)
            del _masters
            _, ref_record, ref_streams = phase_engine(device, cfg, params)
            del cfg, params
        else:
            ref_record, ref_streams = engine_ref
    torch.cuda.empty_cache()
    cfg = gpt.GPTConfig.by_name(SERVE_MODEL)
    prompts = engine_prompts(cfg)
    out = {"phase": "serve", "card": card_line(),
           "config": "opt_1_3b bf16 from seed 0, 16 slots, max_len 2048, "
                     "page 64, chunk 256, budget 512, attn_impl kernel; "
                     "replicas at num_gpus=0.5 on one card",
           "system_config": SERVE_SYSTEM_CONFIG}
    chaos = {"phase": "serve_chaos", "card": out["card"],
             "config": f"opt_1_3b bf16 from seed 0, its first {CUT_DEPTH} "
                       "of 24 layers at full width, one checkpoint; the "
                       "engine phase's knobs, warmed; 3 replicas at "
                       "num_gpus 1/3 on one card, scaled down to 2",
             "scenario": dict(SERVE_CHAOS)}
    bad: list = []
    chaos_bad: list = []
    by_path = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=8, resources={"GPU": 1},
            _system_config=SERVE_SYSTEM_CONFIG)
    try:
        out["init_s"] = time.perf_counter() - t0
        serve.start()
        ctrl = _get_controller()
        if "serve" in parts:
            out["fused"], by_path["serve (fused, 2 replicas)"], fused = (
                serve_fused(rt, serve, ctrl, cfg, prompts, ref_streams,
                            ref_record, device, bad))
            few = prompts[:KV_FEW]
            out["split"], counts, kvp_pid, split = serve_split(
                rt, rt_api, serve, ctrl, cfg, few,
                [s[:KV_TOKENS] for s in ref_streams[:KV_FEW]], device, bad)
            by_path["serve (split, prefill replica)"] = counts["kvp"]
            by_path["serve (split, decode replica)"] = counts["kvd"]
            out["sweep"] = serve_sweep(rt_api, kvp_pid, bad)
            out["parts_s"] = time.perf_counter() - t_phase
            for name in ("kvp", "kvd"):   # their card share, for the next
                serve.delete(name)
        if "serve_chaos" in parts:
            t0 = time.perf_counter()
            (chaos["run"], paths, chaos_cases, chaos_planted, chaos_cfg,
             chaos_weights) = serve_chaos(device, chaos_bad)
            by_path.update(paths)
            chaos["part_s"] = time.perf_counter() - t0
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    # Each line's phase_s: its part on the cluster and its tie check.
    if "serve" in parts:
        t0 = time.perf_counter()
        check_streams(device, cfg, {
            "fused": (out["fused"]["streams"], fused),
            "split": (out["split"]["streams"], split)},
            (prompts[0] + ref_streams[0][:3], ref_streams[0][3]), bad)
        out["phase_s"] = out["parts_s"] + time.perf_counter() - t0
        out["failed_gates"] = bad
        emit(out)
    if "serve_chaos" in parts:
        t0 = time.perf_counter()
        check_streams(device, chaos_cfg, {
            "serve_chaos": (chaos["run"]["streams"], chaos_cases)},
            chaos_planted, chaos_bad, params=chaos_weights)
        del chaos_weights
        torch.cuda.empty_cache()
        chaos["departures"] = len(chaos_cases)
        chaos["failed_gates"] = chaos_bad
        chaos["phase_s"] = chaos["part_s"] + time.perf_counter() - t0
        emit(chaos)
    if bad or chaos_bad:
        raise AssertionError(f"serve: {bad}; serve_chaos: {chaos_bad}")
    return by_path


# ------------------------------------------------------------- autoscaler

AUTOSCALER_IDLE_S = 10.0     # idle_timeout_s of the autoscaled node
AUTOSCALER_PERIOD_S = 1.0    # seconds between reconcile passes
AUTOSCALER_SLACK_S = 20.0    # past the idle timeout, the most to terminate
AUTOSCALER_YAML = """\
cluster_name: chip-smoke-autoscaler
provider: {type: local}
head_resources: {CPU: 2}
node_types:
  gpu_worker: {resources: {CPU: 2, GPU: 1}, min_workers: 0, max_workers: 1}
"""


def autoscaler_decode_inputs(device):
    """runtime_kernel_calls' decode inputs (16 slots of 1-2048 positions,
    bf16, page 64, 32 heads of 64), from the same seed in every
    process. → (q, k pool, v pool, tables, lengths)."""
    rng = np.random.default_rng(RUNTIME_KERNEL_SEED)
    kp, vp, tables, lengths, _ = paged_pool(
        rng, rng.integers(1, CAP + 1, 16), ps=64, n_pg=CAP // 64,
        dtype=torch.bfloat16, device=device)
    q = torch.from_numpy(rng.normal(size=(16, H, K)).astype(
        np.float32)).to(device, torch.bfloat16)
    return (q, kp, vp, *[torch.from_numpy(a).to(device)
                         for a in (tables, lengths)])


def autoscaler_kernel_task():
    """The decode kernel on the autoscaled node's card: its output on the
    host, the worker's launch counts, its pid and node."""
    import ray_tpu_torch as rt

    pa.reset_launch_counts()
    out = pa.paged_attention(*autoscaler_decode_inputs(
        torch.device("cuda"))).cpu()
    counts = launch_counts()
    torch.cuda.empty_cache()
    return out, counts, os.getpid(), rt.get_runtime_context().get_node_id()


def alive_pids(pids):
    """Those of ``pids`` whose process still runs (not a zombie)."""
    out = []
    for p in pids:
        try:
            with open(f"/proc/{p}/status") as f:
                if "zombie" not in f.read():
                    out.append(p)
        except OSError:
            pass
    return out


def process_tree(root: int) -> list[int]:
    """``root`` and every live process below it."""
    kids: dict[int, list[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    out, todo = [root], [root]
    while todo:
        for k in kids.get(todo.pop(), []):
            out.append(k)
            todo.append(k)
    return out


def phase_autoscaler(device):
    """The port's autoscaler on the card: a head with 2 CPUs and no GPU
    (``ClusterUp`` from a written YAML when pyyaml imports, else
    ``init(num_cpus=2)`` and a StandardAutoscaler reconciled every
    second) over a LocalSubprocessProvider whose one node type offers
    {"CPU": 2, "GPU": 1}; a num_gpus=1 task the head cannot place runs
    the decode kernel on the launched node and is held to the plain
    version; the idle node is terminated after its idle timeout, and
    none of its processes is left."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api as rt_api
    from ray_tpu_torch.autoscaler import (
        LocalSubprocessProvider,
        NodeType,
        StandardAutoscaler,
    )

    t_phase = time.perf_counter()
    out = {"phase": "autoscaler", "card": card_line(),
           "node_type": {"gpu_worker": {"CPU": 2, "GPU": 1,
                                        "min_workers": 0,
                                        "max_workers": 1}},
           "idle_timeout_s": AUTOSCALER_IDLE_S,
           "reconcile_period_s": AUTOSCALER_PERIOD_S}
    bad: list = []
    try:
        import yaml  # noqa: F401 — ClusterUp reads the YAML with it
        out["driver"] = "ClusterUp (YAML)"
    except ImportError:
        out["driver"] = "StandardAutoscaler (no pyyaml)"
    stop = threading.Event()
    if out["driver"].startswith("ClusterUp"):
        from ray_tpu_torch.autoscaler.yaml_config import ClusterUp

        path = os.path.join("build", "autoscaler", "cluster.yaml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(AUTOSCALER_YAML)
        cluster = ClusterUp(path, update_interval_s=AUTOSCALER_PERIOD_S)
        provider, asc = cluster.provider, cluster.autoscaler
        asc.idle_timeout_s = AUTOSCALER_IDLE_S
        rt.init(address=cluster.address)
        teardown = cluster.down
    else:
        rt.init(num_cpus=2)
        gcs = rt_api._ensure_client().gcs_address
        provider = LocalSubprocessProvider(gcs)
        asc = StandardAutoscaler(
            provider, [NodeType("gpu_worker", {"CPU": 2, "GPU": 1},
                                min_workers=0, max_workers=1)],
            idle_timeout_s=AUTOSCALER_IDLE_S, gcs_address=gcs)

        def loop():
            while not stop.is_set():
                asc.update()
                stop.wait(AUTOSCALER_PERIOD_S)

        looper = threading.Thread(target=loop, daemon=True)
        looper.start()

        def teardown():
            stop.set()
            looper.join(timeout=30)
            provider.terminate_all()

    events = {"launched": [], "terminated": []}
    create, terminate = provider.create_node, provider.terminate_node
    provider.create_node = lambda nt: events["launched"].append(
        (time.perf_counter(), nt.name)) or create(nt)
    provider.terminate_node = lambda nid: events["terminated"].append(
        (time.perf_counter(), nid)) or terminate(nid)
    tree = []
    try:
        out["head_resources"] = rt.cluster_resources()
        t0 = time.perf_counter()
        ref = rt.remote(num_gpus=1)(autoscaler_kernel_task).remote()
        registered = None
        while registered is None and time.perf_counter() - t0 < 300:
            registered = next((n for n in rt.nodes() if n["Alive"] and (
                n["Labels"] or {}).get("provider_node_id")), None)
            time.sleep(0.1)
        t_reg = time.perf_counter()
        w_out, w_counts, w_pid, w_node = rt.get(ref, timeout=600)
        t_res = time.perf_counter()
        nid = (registered or {}).get("Labels", {}).get("provider_node_id")
        node = getattr(provider, "_nodes", {}).get(nid)
        if node is not None:
            tree = [q for p in node.procs for q in process_tree(p.pid)]
        while (provider.non_terminated_nodes()
               and time.perf_counter() - t_res
               < AUTOSCALER_IDLE_S + AUTOSCALER_SLACK_S + 30):
            time.sleep(0.2)
        t_term = time.perf_counter()
        left = tree
        while left and time.perf_counter() - t_term < 15:
            time.sleep(0.2)
            left = alive_pids(tree)
        out.update({
            "submit_to_registered_s": t_reg - t0,
            "submit_to_result_s": t_res - t0,
            "idle_to_terminated_s": t_term - t_res,
            "launches": [n for _t, n in events["launched"]],
            "terminations": len(events["terminated"]),
            "node": {"registered": registered is not None,
                     "task_on_it": bool(registered)
                     and w_node == registered["NodeID"],
                     "processes": len(tree), "left": alive_pids(tree)},
            "task": {"pid": w_pid, "launches": w_counts}})
    finally:
        rt.shutdown()
        teardown()
    q, kp, vp, tables, lengths = autoscaler_decode_inputs(device)
    ref_out = pa.reference_paged_attention(q, kp, vp, tables, lengths)
    s_abs = abs_v_attention(pa.reference_paged_attention, q, kp, vp,
                            tables, lengths)
    try:
        out["task"]["vs_plain"] = check_close(
            "autoscaled decode", w_out.to(device), ref_out, s_abs,
            torch.bfloat16, lengths > 0, lengths >= LONG_ROW)
    except AssertionError as e:
        bad.append(str(e))
    if out["launches"] != ["gpu_worker"]:
        bad.append(f"autoscaler: launches {out['launches']}, not one")
    if not out["node"]["task_on_it"]:
        bad.append(f"autoscaler: the task did not run on the launched "
                   f"node: {out['node']}")
    if w_counts["paged_attention"] < 1:
        bad.append(f"autoscaler: task launches {w_counts}")
    if out["terminations"] != 1 or not (
            AUTOSCALER_IDLE_S <= out["idle_to_terminated_s"]
            <= AUTOSCALER_IDLE_S + AUTOSCALER_SLACK_S):
        bad.append(f"autoscaler: idle node terminated after "
                   f"{out['idle_to_terminated_s']} s "
                   f"({out['terminations']} terminations)")
    if not tree or out["node"]["left"]:
        bad.append(f"autoscaler: processes of the node {out['node']}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["failed_gates"] = bad
    emit(out)
    if bad:
        raise AssertionError(f"autoscaler: {bad}")
    return {"autoscaler (task on the launched node)": w_counts}


AUTOSCALER_CHILD_OUT = os.path.join("build", "autoscaler", "child")
# The single-card training phases: the autoscaler part runs beside them
# in a child process (its own cluster) when both are asked for. Most of
# the part is waiting (a node's boot, a fresh worker's first CUDA work,
# the idle timeout), and their gates read no process, arena or free
# memory of the machine (their step times are readings only).
TRAIN_ONE_CARD = ("train_ring", "train_llama", "train_gpt2_2_7b",
                  "train_gptj_6b", "train_moe", "train_pipeline")


def start_autoscaler_child():
    """`phase_autoscaler` in a child process of this script, which
    inherits no runtime variable of this process."""
    os.makedirs(os.path.dirname(AUTOSCALER_CHILD_OUT), exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    with open(AUTOSCALER_CHILD_OUT + ".out", "w") as out, open(
            AUTOSCALER_CHILD_OUT + ".err", "w") as err:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--autoscaler-child"], stdout=out, stderr=err, env=env)


def join_autoscaler_child(proc):
    """Wait for the child; its phase line joins this run's record. →
    launches by path. Raises if the child failed."""
    rc = proc.wait(timeout=600)
    with open(AUTOSCALER_CHILD_OUT + ".out") as f:
        line = next((json.loads(x) for x in f
                     if x.startswith('{"phase": "autoscaler"')), None)
    if line is not None:
        line["at_s_in_child"] = line.pop("at_s", None)
        emit(line)
    if rc != 0 or line is None:
        with open(AUTOSCALER_CHILD_OUT + ".err") as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"autoscaler: child exited {rc}: {tail}")
    return {"autoscaler (task on the launched node)":
            line["task"]["launches"]}


def autoscaler_child_main() -> int:
    try:
        phase_autoscaler(torch.device("cuda"))
    except AssertionError as e:
        print(f"autoscaler child: {e}", file=sys.stderr)
        return 1
    return 0


# ------------------------------------------------------------------- train

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 12
# Launches per step with remat: the forward runs once per block and once
# more in the block's recompute; dq and dkv once per block.
# The flash kernels every training path counts: per backward call one
# delta, one dq and one dkv.
FLASH_KERNELS = ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
FLASH_PER_STEP = {"flash_fwd": 24, "flash_delta": 12, "flash_dq": 12,
                  "flash_dkv": 12}
# flash vs xla, one step from the same parameters and batch, bf16: the two
# attention paths round probabilities at different places (unit roundoff
# 2^-8) and the difference goes through 12 bf16 layers. The loss is a mean
# over 8192 tokens; the gradient is held as a whole and, since the
# embedding and head dominate its norm, on the attention weights of each
# layer alone, where a wrong attention backward shows first. Each limit
# sits between the sound runs' reading and the planted faults' (the
# planted faults must exceed the attention limit in every run).
TRAIN_LOSS_TOL = 5e-4          # |loss_flash - loss_xla|
TRAIN_GRAD_TOL = 2e-2          # |g_flash - g_xla| / |g_xla|, all leaves
TRAIN_ATTN_GRAD_TOL = 5e-2     # the same, worst (layer, wq/wk/wv/wo) slice
ATTN_LEAVES = ("wq", "wk", "wv", "wo")


def train_flops_per_token(cfg) -> float:
    """bench.py's count: ~6N per token (forward 2N, backward 4N) with N
    the matmul parameters (tied embedding/unembedding, 4 d^2 of attention
    and 2 d d_ff of MLP per layer), plus the attention score/value term."""
    n_params = (cfg.vocab_size * cfg.d_model
                + cfg.n_layers * (4 * cfg.d_model * cfg.d_model
                                  + 2 * cfg.d_model * cfg.d_ff))
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.max_seq
    return 6.0 * n_params + attn


def train_batch(cfg, device):
    return train_batch_of(cfg.vocab_size, TRAIN_B, TRAIN_S, device)


def train_batch_of(vocab, B, S, device, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S))
    tg = np.roll(toks, -1, axis=1)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (toks, tg))


def loss_and_grads(cfg, params, batch, impl, mesh=None, model=gpt):
    """One step's loss and gradients ({name: grad}) of ``model`` with
    ``impl`` (the sp ``mesh`` for "ring")."""
    loss = model.loss_fn(params, *batch,
                         dataclasses.replace(cfg, attn_impl=impl), mesh)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def step_diff(loss, grads, loss_ref, ref):
    """The step's differences from the reference step's: |Δloss|, the
    relative difference of the whole gradient, and the largest over the
    attention weights (wq, wk, wv, wo) of one layer."""
    whole = torch.sqrt(sum((grads[n].float() - ref[n].float()).square().sum()
                           for n in ref))
    return {"loss_abs_diff": abs(loss - loss_ref),
            "grad_rel_err": float(whole / torch.sqrt(sum(
                g.float().square().sum() for g in ref.values()))),
            "attn_grad_rel_err": layer_rel_err(grads, ref, ATTN_LEAVES)}


def layer_rel_err(grads, ref, leaves):
    """The largest relative difference over the (layer, leaf) slices of
    the stacked ``leaves``."""
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    return max(rel(grads[n][i], ref[n][i])
               for n in leaves for i in range(ref[n].shape[0]))


def planted_backwards(real):
    """Wrong versions of fa.flash_bwd: faults the flash-vs-xla check must
    see, from a blatant one to a dropped 64-key tile."""
    def zero_dq(*args):
        dq, dk, dv = real(*args)
        return torch.zeros_like(dq), dk, dv

    def swap_dkv(*args):
        dq, dk, dv = real(*args)
        return dq, dv, dk

    def drop_tile(q, k, v, o, lse, do, dlse, causal, scale):
        dq, dk, dv = real(q, k, v, o, lse, do, dlse, causal, scale)
        tile = dropped_tile(q, k, v, do, lse,
                            fa.reference_flash_delta(o, do, dlse), scale,
                            FAULT_LO)[0]
        return (dq.float() - tile).to(dq.dtype), dk, dv

    return {"dq zeroed": zero_dq, "dk and dv swapped": swap_dkv,
            f"keys {FAULT_LO}-{FAULT_LO + 63} dropped from dq": drop_tile}


def flash_vs_xla(cfg, params, batch):
    """One step with flash attention against plain attention from the
    same parameters (nothing is updated), then the same for each planted
    fault in the flash backward, each of which must fail the check."""
    loss_x, g_x = loss_and_grads(cfg, params, batch, "xla")
    loss_f, g_f = loss_and_grads(cfg, params, batch, "flash")
    res = {"loss_flash": loss_f, "loss_xla": loss_x,
           **step_diff(loss_f, g_f, loss_x, g_x),
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
           "attn_grad_tol": TRAIN_ATTN_GRAD_TOL}
    del g_f
    real, planted = fa.flash_bwd, {}
    for fault, bwd in planted_backwards(real).items():
        fa.flash_bwd = bwd
        try:
            loss_p, g_p = loss_and_grads(cfg, params, batch, "flash")
        finally:
            fa.flash_bwd = real
        planted[fault] = step_diff(loss_p, g_p, loss_x, g_x)
        del g_p
    res["planted_faults"] = planted
    if not (res["loss_abs_diff"] <= TRAIN_LOSS_TOL
            and res["grad_rel_err"] <= TRAIN_GRAD_TOL
            and res["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_TOL):
        raise AssertionError(f"flash vs xla step disagree: {res}")
    if not all(p["attn_grad_rel_err"] > TRAIN_ATTN_GRAD_TOL
               for p in planted.values()):
        raise AssertionError(f"a planted fault passes the check: {res}")
    return res


def flash_counts() -> dict:
    """The flash kernels' launch counters (FLASH_KERNELS)."""
    return {k: getattr(fa, k).launches for k in FLASH_KERNELS}


def timed_steps(step, params, opt_state, batch, n):
    """One warm-up step and ``n`` timed ones, the flash counters zeroed
    just before and read just after → (params, opt_state, losses, step
    ms, launches per step)."""
    fa.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(1 + n):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))            # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = flash_counts()
    per_step = {k: v / (1 + n) for k, v in launches.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return params, opt_state, losses, step_ms, launches, per_step


def phase_train(device):
    """bench.py's training step on the port: gpt2_124m at B=8, S=1024,
    bf16, remat, flash attention, AdamW with a bf16 first moment."""
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, remat=True,
                                  attn_impl="flash")
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, device)
    batch = train_batch(cfg, device)
    compare = flash_vs_xla(cfg, params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()      # the peak of the steps alone
    params, opt_state, losses, step_ms, launches, per_step = timed_steps(
        step, params, opt_state, batch, TRAIN_STEPS)
    if per_step != FLASH_PER_STEP:
        raise AssertionError(f"flash launches per step {per_step}, "
                             f"expected {FLASH_PER_STEP}")
    timed = step_ms[1:]
    p50 = float(np.median(timed))
    tok_s = TRAIN_B * TRAIN_S / (p50 / 1e3)
    peak_mem = torch.cuda.max_memory_allocated()
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    out = {"phase": "train", "config": "gpt2_124m bf16 remat flash "
           f"B={TRAIN_B} S={TRAIN_S} adamw(3e-4, wd=0.1, mu bf16)",
           "params": gpt.num_params(cfg), "flash_vs_xla": compare,
           "steps_timed": TRAIN_STEPS, "step_ms": step_ms,
           "step_ms_p50": p50, "tokens_per_s": tok_s,
           "mfu": train_flops_per_token(cfg) * tok_s / BF16_FLOPS,
           "flops_per_token": train_flops_per_token(cfg),
           "max_memory_allocated_gb": peak_mem / 2**30,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": launches,
           "launches_per_step": per_step, "profile_one_step": profiled}
    emit(out)
    return launches, (losses, p50)


# ------------------------------------------------------- long context

RING_B, RING_S, RING_SP, RING_STEPS = 2, 4096, 4, 4
RING_COMBINES = RING_SP * (RING_SP - 1) // 2   # combines per causal ring call
# Per step with remat at sp = 4, causal: each of the CUT_DEPTH layers'
# ring attends 4 diagonal and 6 full chunks (the 6 masked steps launch
# nothing), in the block's forward and again in its recompute; dq and
# dkv once each.
RING_PER_STEP = {"flash_fwd": 160, "flash_delta": 80, "flash_dq": 80,
                 "flash_dkv": 80}


def dropped_rotation(real):
    """A planted fault in the ring's combine: the first combine of every
    ring call keeps the running (o, lse), so shard 1 never sees chunk 0."""
    calls = [0]

    def combine(o1, lse1, o2, lse2):
        calls[0] += 1
        if calls[0] % RING_COMBINES == 1:
            return o1, lse1
        return real(o1, lse1, o2, lse2)

    return combine


def phase_train_ring(device, errs):
    """Ring attention on the training path: gpt2_124m cut to its first
    CUT_DEPTH of 12 layers (full width) at S 4096, B 2, bf16, remat,
    attn_impl="ring" over an sp=4 mesh with every shard on one card,
    adamw(3e-4, wd 0.1, mu bf16)."""
    t_phase = time.perf_counter()
    B, S, Hh, Kd = RING_B, RING_S // RING_SP, 12, 64
    shapes = {
        "ring_diagonal": flash_shape_timings(device, errs, "ring diagonal",
                                             B, S, Hh, Kd, True, 7)[0],
        "ring_full": flash_shape_timings(device, errs, "ring full", B, S, Hh,
                                         Kd, False, 8)[0]}
    emit({"phase": "flash_kernel_timing_ring", **{
        f"{k} {tag}": v for tag, t in shapes.items() for k, v in t.items()}})
    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_124m(
        max_seq=RING_S, remat=True, attn_impl="ring"), n_layers=CUT_DEPTH)
    mesh = make_sp_mesh(RING_SP, devices=[device] * RING_SP)
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, device,
                                             mesh=mesh)
    batch = train_batch_of(cfg.vocab_size, RING_B, RING_S, device)

    loss_x, g_x = loss_and_grads(cfg, params, batch, "xla")
    loss_r, g_r = loss_and_grads(cfg, params, batch, "ring", mesh)
    compare = {"loss_ring": loss_r, "loss_xla": loss_x,
               **step_diff(loss_r, g_r, loss_x, g_x),
               "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
               "attn_grad_tol": TRAIN_ATTN_GRAD_TOL}
    del g_r
    real = tring._combine
    tring._combine = dropped_rotation(real)
    try:
        loss_p, g_p = loss_and_grads(cfg, params, batch, "ring", mesh)
    finally:
        tring._combine = real
    compare["planted_dropped_rotation"] = step_diff(loss_p, g_p, loss_x, g_x)
    del g_p, g_x
    if not (compare["loss_abs_diff"] <= TRAIN_LOSS_TOL
            and compare["grad_rel_err"] <= TRAIN_GRAD_TOL
            and compare["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_TOL):
        raise AssertionError(f"ring vs xla step disagree: {compare}")
    # The planted fault moves the loss of random weights by 1.9e-4 (under
    # the loss limit; the attention barely steers their logits), and the
    # attention weights' gradients by 0.96 relative: as in the train
    # phase, it must fail the attention-gradient limit.
    if not compare["planted_dropped_rotation"]["attn_grad_rel_err"] > \
            TRAIN_ATTN_GRAD_TOL:
        raise AssertionError(f"a dropped rotation passes the check: "
                             f"{compare}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, losses, step_ms, launches, per_step = timed_steps(
        step, params, opt_state, batch, RING_STEPS)
    if per_step != RING_PER_STEP:
        raise AssertionError(f"ring flash launches per step {per_step}, "
                             f"expected {RING_PER_STEP}")
    peak_mem = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_ms[1:]))
    tok_s = RING_B * RING_S / (p50 / 1e3)
    fpt = train_flops_per_token(cfg)
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    # The same step unsharded: attn_impl="flash" on the same parameters.
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    flash_step = make_train_step(
        lambda p, a, b: gpt.loss_fn(p, a, b, flash_cfg), opt)
    params, opt_state, f_losses, f_ms, _, f_per_step = timed_steps(
        flash_step, params, opt_state, batch, RING_STEPS)
    f_p50 = float(np.median(f_ms[1:]))
    out = {"phase": "train_ring", "config": f"gpt2_124m (first {CUT_DEPTH} "
           f"of 12 layers) bf16 remat ring sp={RING_SP} (every shard on "
           f"one card) B={RING_B} S={RING_S} adamw(3e-4, wd=0.1, mu bf16)",
           "ring_vs_xla": compare,
           "steps_timed": RING_STEPS, "step_ms": step_ms,
           "step_ms_p50": p50, "tokens_per_s": tok_s,
           "mfu": fpt * tok_s / BF16_FLOPS, "flops_per_token": fpt,
           "max_memory_allocated_gb": peak_mem / 2**30,
           "losses": losses, "launches": launches,
           "launches_per_step": per_step, "profile_one_step": profiled,
           "unsharded_flash": {"step_ms": f_ms, "step_ms_p50": f_p50,
                               "tokens_per_s": RING_B * RING_S / (
                                   f_p50 / 1e3),
                               "launches_per_step": f_per_step,
                               "losses": f_losses},
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, shapes


# ------------------------------------------------------ large models

LLAMA_S, LLAMA_STEPS = 4096, 4
# Per step with remat: 32 layers' flash forward twice (block and
# recompute), dq and dkv once each.
LLAMA_PER_STEP = {"flash_fwd": 64, "flash_delta": 32, "flash_dq": 32,
                  "flash_dkv": 32}
# |loss_flash - loss_plain| of one step from the same parameters, bf16:
# the two attention paths round probabilities at different places, and
# the difference goes through 32 layers. Stated before the first run; a
# tiled GQA repeat (query head h reading kv head h mod 8 in place of
# h // 4) planted in the plain path must exceed it.
LLAMA_LOSS_TOL = 1e-2


def llama_loss(cfg, params, batch, impl):
    with torch.no_grad():
        return float(llama.loss_fn(params, *batch,
                                   dataclasses.replace(cfg, attn_impl=impl)))


def phase_train_llama(device, errs):
    """bench.py's BENCH_OPT=adafactor_sr path on the port: llama3_8b at
    full width and depth, S 4096, B 1, bf16 SR masters, adafactor(3e-4),
    remat, flash attention, random weights from seed 0."""
    t_phase = time.perf_counter()
    shapes = {"llama": flash_shape_timings(device, errs, "llama3_8b", 1,
                                           LLAMA_S, 32, 128, True, 9)[0]}
    emit({"phase": "flash_kernel_timing_llama", **{
        f"{k} {tag}": v for tag, t in shapes.items() for k, v in t.items()}})
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig.llama3_8b(max_seq=LLAMA_S, attn_impl="flash",
                                      param_dtype=torch.bfloat16)
    one = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    report = memory_audit.audit_training(
        cfg, one, model=llama, optimizer="adafactor", param_bytes=2,
        grad_bytes=2, hbm="h100")
    total_memory = torch.cuda.get_device_properties(0).total_memory
    audit = {"per_device": report.per_device, "total": report.total_bytes,
             "hbm_bytes": report.hbm_bytes, "fits": report.fits,
             "card_total_memory": total_memory}
    print(str(report), flush=True)
    if total_memory != memory_audit.HBM_BYTES["h100"]:
        raise AssertionError(f"the card reports {total_memory} bytes, "
                             f"HBM_BYTES['h100'] is "
                             f"{memory_audit.HBM_BYTES['h100']}")
    if not report.fits:
        raise AssertionError(f"llama3_8b does not fit one H100:\n{report}")
    torch.cuda.reset_peak_memory_stats()
    opt = adafactor(3e-4)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params, opt_state, step = build_training(cfg, opt, gen, device,
                                             model=llama,
                                             stochastic_round=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = train_batch_of(cfg.vocab_size, 1, LLAMA_S, device)
    loss_f, loss_x = (llama_loss(cfg, params, batch, i)
                      for i in ("flash", "xla"))
    real = llama._repeat_kv
    llama._repeat_kv = lambda x, groups: x.repeat(1, 1, groups, 1)
    try:
        loss_tiled = llama_loss(cfg, params, batch, "xla")
    finally:
        llama._repeat_kv = real
    compare = {"loss_flash": loss_f, "loss_xla": loss_x,
               "loss_abs_diff": abs(loss_f - loss_x),
               "loss_tol": LLAMA_LOSS_TOL,
               "planted_tiled_gqa_loss_abs_diff": abs(loss_tiled - loss_f)}
    if not compare["loss_abs_diff"] <= LLAMA_LOSS_TOL:
        raise AssertionError(f"llama flash vs plain disagree: {compare}")
    if not compare["planted_tiled_gqa_loss_abs_diff"] > LLAMA_LOSS_TOL:
        raise AssertionError(f"a tiled GQA repeat passes the check: "
                             f"{compare}")
    params, opt_state, losses, step_ms, launches, per_step = timed_steps(
        step, params, opt_state, batch, LLAMA_STEPS - 1)
    if per_step != LLAMA_PER_STEP:
        raise AssertionError(f"llama flash launches per step {per_step}, "
                             f"expected {LLAMA_PER_STEP}")
    not_bf16 = [k for k, p in params.items() if p.dtype != torch.bfloat16]
    if not_bf16:
        raise AssertionError(f"parameters left bf16: {not_bf16}")
    peak_mem = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_ms[1:]))
    tok_s = LLAMA_S / (p50 / 1e3)
    fpt = llama_flops_per_token(cfg)
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    optimizer = optimizer_device_time(cfg, params, opt_state, batch, opt)
    out = {"phase": "train_llama", "config": f"llama3_8b bf16 SR masters "
           f"remat flash B=1 S={LLAMA_S} adafactor(3e-4)",
           "params": llama.num_params(cfg), "audit": audit,
           "max_memory_allocated": peak_mem,
           "max_memory_allocated_gb": peak_mem / 2**30,
           "init_s": init_s, "flash_vs_plain": compare,
           "steps": LLAMA_STEPS, "step_ms": step_ms, "step_ms_p50": p50,
           "tokens_per_s": tok_s, "mfu": fpt * tok_s / BF16_FLOPS,
           "flops_per_token": fpt, "losses": losses, "launches": launches,
           "launches_per_step": per_step, "profile_one_step": profiled,
           "optimizer": optimizer,
           "optimizer_share_of_step_device_ms": (
               optimizer["device_busy_ms"] / profiled["device_busy_ms"]),
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, shapes


SR_B, SR_S, SR_STEPS = 8, 1024, 4   # bench.py's adafactor_sr step


def sr_per_step(cfg):
    """Flash launches per step with remat: each layer's forward twice (the
    block and its recompute), dq and dkv once each (gpt2_2_7b cut to 8
    layers 16/8/8/8, as gptj_6b cut to 8: delta with each dq)."""
    L = cfg.n_layers
    return {"flash_fwd": 2 * L, "flash_delta": L, "flash_dq": L,
            "flash_dkv": L}


def train_sr(device, errs, cfg, name, heads, seed):
    """bench.py's BENCH_MODEL=``name`` BENCH_OPT=adafactor_sr step on the
    port: ``cfg`` at full width (its depth as given), S 1024, B 8, bf16 SR
    masters,
    adafactor(3e-4), remat, flash attention, random weights from seed 0;
    the flash kernels first checked and timed at its [8, 1024, *heads].
    The memory audit is printed and must fit; one step of flash against
    plain attention (`flash_vs_xla`, its three planted faults); then 4
    steps (one warm-up) with the launches per step of `sr_per_step`, no
    plain call, every parameter left bf16 and the loss falling. The peak
    memory is read over the steps alone (the check's beside it)."""
    t_phase = time.perf_counter()
    shapes = {f"{name} training": flash_shape_timings(
        device, errs, name, SR_B, SR_S, *heads, True, seed)[0]}
    emit({"phase": f"flash_kernel_timing_{name}", **{
        f"{k} {tag}": v for tag, t in shapes.items() for k, v in t.items()}})
    torch.cuda.empty_cache()
    report = memory_audit.audit_training(
        cfg, {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}, optimizer="adafactor",
        batch_per_device=SR_B, param_bytes=2, grad_bytes=2, hbm="h100")
    audit = {"per_device": report.per_device, "total": report.total_bytes,
             "hbm_bytes": report.hbm_bytes, "fits": report.fits}
    print(str(report), flush=True)
    if not report.fits:
        raise AssertionError(f"{name} does not fit one H100:\n{report}")
    torch.cuda.reset_peak_memory_stats()
    opt = adafactor(3e-4)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params, opt_state, step = build_training(cfg, opt, gen, device,
                                             stochastic_round=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = train_batch_of(cfg.vocab_size, SR_B, SR_S, device)
    compare = flash_vs_xla(cfg, params, batch)
    check_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()      # the peak of the steps alone
    expected = sr_per_step(cfg)
    plain, real = counted_calls(fa, FLASH_PLAIN)
    try:
        params, opt_state, losses, step_ms, launches, per_step = (
            timed_steps(step, params, opt_state, batch, SR_STEPS - 1))
    finally:
        restore_plain(fa, real)
    if per_step != expected or any(plain.values()):
        raise AssertionError(f"{name} flash launches per step {per_step} "
                             f"(expected {expected}), plain calls {plain}")
    not_bf16 = [k for k, p in params.items() if p.dtype != torch.bfloat16]
    if not_bf16:
        raise AssertionError(f"parameters left bf16: {not_bf16}")
    peak_mem = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_ms[1:]))
    tok_s = SR_B * SR_S / (p50 / 1e3)
    fpt = train_flops_per_token(cfg)
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    emit({"phase": f"train_{name}", "config": f"{name} bf16 SR masters "
          f"remat flash B={SR_B} S={SR_S} adafactor(3e-4), "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}",
          "params": gpt.num_params(cfg), "audit": audit,
          "max_memory_allocated": peak_mem,
          "max_memory_allocated_gb": peak_mem / 2**30,
          "check_max_memory_allocated_gb": check_peak / 2**30,
          "init_s": init_s, "flash_vs_xla": compare, "steps": SR_STEPS,
          "step_ms": step_ms, "step_ms_p50": p50, "tokens_per_s": tok_s,
          "mfu": fpt * tok_s / BF16_FLOPS, "flops_per_token": fpt,
          "losses": losses, "launches": launches,
          "launches_per_step": per_step, "plain_calls": plain,
          "profile_one_step": profiled,
          "phase_s": time.perf_counter() - t_phase, "card": card_line()})
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, shapes


def phase_train_gpt2_2_7b(device, errs):
    """`train_sr` on gpt2_2_7b (bench.py:225-241): d 2560, 32 heads of
    80, d_ff 10240, untied, vocab 50304, cut to its first CUT_DEPTH of 32
    layers (room for train_gptj_6b; its kernels are checked and timed at
    full width first)."""
    cfg = dataclasses.replace(
        gpt.GPTConfig.gpt2_2_7b(max_seq=SR_S, attn_impl="flash",
                                param_dtype=torch.bfloat16),
        n_layers=CUT_DEPTH)
    return train_sr(device, errs, cfg, "gpt2_2_7b", HEADS_2_7B, 19)


def phase_train_gptj_6b(device, errs):
    """`train_sr` on gptj_6b (ray_tpu/models/gpt.py:86-92): d 4096, 16
    heads of 256 (rotary 64), d_ff 16384, untied, vocab 50304, cut to its
    first CUT_DEPTH of 28 layers (room for train_dist's four ranks); the
    backward kernels at head dim 256."""
    cfg = dataclasses.replace(
        gpt.GPTConfig.gptj_6b(max_seq=SR_S, attn_impl="flash",
                              param_dtype=torch.bfloat16),
        n_layers=CUT_DEPTH)
    return train_sr(device, errs, cfg, "gptj_6b", HEADS_GPTJ, 23)


def llama_flops_per_token(cfg) -> float:
    """`train_flops_per_token`'s count (bench.py's) for the Llama family:
    6N per token with N the matmul parameters (the untied embedding's
    gather is no matmul, so the LM head counts once; q and o of d x d, k
    and v of d x kv_heads·K, the three SwiGLU matrices), plus 12·L·d·S of
    attention scores and values."""
    K = cfg.head_dim
    attn_w = 2 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * (
        cfg.n_kv_heads * K)
    n = (cfg.vocab_size * cfg.d_model
         + cfg.n_layers * (attn_w + 3 * cfg.d_model * cfg.d_ff))
    return 6.0 * n + 12 * cfg.n_layers * cfg.d_model * cfg.max_seq


def optimizer_device_time(cfg, params, opt_state, batch, opt):
    """The device time of one optimizer application (adafactor's update
    and the stochastically rounded apply, fp32 gradients leaf by leaf) on
    one step's gradients, profiled as `_profiled` profiles the step. It
    runs three more optimizer steps on the parameters."""
    loss = llama.loss_fn(params, *batch, cfg)
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [params[k] for k in names])))
    del loss
    inner, count = opt_state

    def apply():
        updates, _ = opt.update(Fp32Leaves(dict(grads)), inner, params)
        sr_apply_updates(params, updates, count)

    res = _profiled(apply, top=6)
    del grads
    return res

# ---------------------------------------------------------------- MoE

MOE_B, MOE_S, MOE_STEPS = 8, 1024, 3   # 3 timed steps after a warm-up
# Per step with remat: 24 layers' flash forward twice (block and
# recompute), dq and dkv once each.
MOE_PER_STEP = {"flash_fwd": 48, "flash_delta": 24, "flash_dq": 24,
                "flash_dkv": 24}
MOE_EP = 4
# |loss(ep = 4) - loss(ep = 1)| on the same parameters and batch, bf16:
# the four shards' bf16 partial outputs are rounded and summed where one
# shard rounds the whole sum once (up to 2 extra bf16 roundings, u = 2^-8,
# of each MoE output element), and the difference goes through 24 layers
# into a mean over 8,192 tokens whose per-token changes have no common
# sign: 1e-3. A dropped shard partial (a quarter of the experts' outputs
# lost in every layer) must exceed it.
MOE_EP_LOSS_TOL = 1e-3
# moe_mlp in fp32 (TF32 off) against the plain top-2 loop, relative to
# the whole output: fp32 reassociation over D = 1,024 and F = 4,096 sums
# (~1e-6); the second expert's combine weight zeroed moves it by ~0.3.
MOE_MLP_REL_TOL = 1e-4
MOE_MLP_SLICE = (1, 512)
# Flash against plain, routing held: the train phase's loss and attention
# limits; the whole gradient's limit scaled to the depth. The bf16 noise
# of the whole gradient between two attention paths grows with depth
# (CPU rehearsals at full width: 0.0093 at 2 layers, 0.0113 at 4, 0.0130
# at 6, spread evenly over every leaf), and the 24 layers read 0.0204 on
# an H100, past the 2e-2 set for the train phase's 12 layers (where sound
# runs read 0.010-0.015). A planted attention fault is
# caught by the attention limit (a zeroed dq reads 1.0 there, 0.049 on
# the whole gradient). That the 0.0204 is rounding, and no fault at the
# full-width shapes, is read at full depth by the same held step with
# fp32 activations (`moe_fp32_steps`): there it must fall under
# MOE_F32_GRAD_TOL.
MOE_GRAD_TOL = 3e-2
# The held steps with fp32 activations and fp32 flash kernels (TF32 off),
# flash against plain and ep = 4 against ep = 1, on the whole gradient
# and, for ep, on each layer's expert stacks: what is left is fp32
# reassociation (u = 2^-24) through 24 layers, expected near 1e-5; 1e-3
# sits 20x under the bf16 step's reading and 50x under a zeroed dq's
# whole-gradient reading, and a dropped ep shard zeroes a quarter of
# every layer's expert gradients (a slice reading near 0.5).
MOE_F32_GRAD_TOL = 1e-3
MOE_EXPERT_LEAVES = ("moe_w_up", "moe_b_up", "moe_w_down", "moe_b_down")


def joined_shards(tree, n, dim):
    """Placed ``name@s`` leaves of ``n`` shards joined along ``dim``, the
    axis they were split on."""
    out = {k: v for k, v in tree.items() if "@" not in k}
    for k in {k.partition("@")[0] for k in tree if "@" in k}:
        out[k] = torch.cat([tree[f"{k}@{s}"] for s in range(n)], dim)
    return out


class _Captured(Exception):
    """Raised by `first_gates` once it holds layer 0's gates."""


def first_gates(cfg, params, batch):
    """Layer 0's router gates [G, E] fp32 as the model computes them on
    the card (the first `_top2_dispatch` call of a forward, which stops
    there)."""
    real, got = tmoe._top2_dispatch, []

    def capture(gates, capacity):
        got.append(gates.detach().clone())
        raise _Captured

    tmoe._top2_dispatch = capture
    try:
        with torch.no_grad():
            moe_gpt.loss_fn(params, *batch, cfg)
    except _Captured:
        pass
    finally:
        tmoe._top2_dispatch = real
    return got[0]


class HeldRouting:
    """Routing held across runs of the same model. ``recording()`` keeps
    the gates of each `_top2_dispatch` call in order; ``replaying()``
    routes each call by the recorded gates' choices (experts, slots,
    drops) with weights taken from the current gates as the real
    dispatch takes them (bitwise the real combine when the gates are the
    recorded ones), and counts the tokens whose top-2 experts the
    current gates would change. Routing is a step function of the gates:
    a token near a tie changes experts on one rounding, and under a
    binding capacity every later token of that expert changes slot. Two
    attention paths, or two ep sums, that differ by bf16 roundings then
    route some tokens differently, and those tokens' outputs and
    gradients differ wholesale. Held routing compares what the kernels
    and the sums compute, not where that step fell."""

    def __init__(self):
        self.gates, self.index, self.flipped = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        real = tmoe._top2_dispatch
        tmoe._top2_dispatch = lambda gates, capacity: fn(real, gates,
                                                         capacity)
        try:
            yield self
        finally:
            tmoe._top2_dispatch = real

    def recording(self):
        self.gates = []

        def record(real, gates, capacity):
            self.gates.append(gates.detach().clone())
            return real(gates, capacity)

        return self._patched(record)

    def replaying(self):
        self.index, self.flipped = 0, 0

        def replay(real, gates, capacity):
            ref = self.gates[self.index]
            self.index += 1
            dispatch, _ = real(ref, capacity)
            E = gates.shape[1]
            top = lambda g: (g.argmax(-1), (g * (1.0 - F.one_hot(
                g.argmax(-1), E).to(g.dtype))).argmax(-1))
            (i1, i2), (n1, n2) = top(ref), top(gates.detach())
            self.flipped += int(((i1 != n1) | (i2 != n2)).sum())
            m1 = F.one_hot(i1, E).to(gates.dtype)
            m2 = F.one_hot(i2, E).to(gates.dtype)
            w1, w2 = (gates * m1).sum(-1), (gates * m2).sum(-1)
            denom = torch.clamp(w1 + w2, min=1e-9)
            weights = m1 * (w1 / denom)[:, None] + m2 * (w2 / denom)[:, None]
            return dispatch, dispatch * weights[:, :, None]

        return self._patched(replay)


def routing_on_the_card(cfg, gates):
    """`_top2_dispatch` on the card against the CPU port's on the same
    gates, bitwise, at the configuration's capacity and at factor 0.5;
    with the share of (token, choice) routes each drops."""
    G = gates.shape[0]
    out = {}
    for factor in (cfg.capacity_factor, 0.5):
        C = dataclasses.replace(cfg.moe_cfg(),
                                capacity_factor=factor).capacity(G)
        card = [t.cpu() for t in tmoe._top2_dispatch(gates, C)]
        host = tmoe._top2_dispatch(gates.cpu(), C)
        same = all(torch.equal(a, b) for a, b in zip(card, host))
        out[f"factor {factor}"] = {
            "capacity": C, "bitwise_equal": same,
            "routes_dropped_share": 1.0 - float(card[0].sum()) / (2 * G)}
        del card, host
        if not same:
            raise AssertionError(f"routing differs on the card: {out}")
    return out


def top2_loop(x, params):
    """The plain top-2 mixture (the port's copy of the JAX test's
    ``_dense_top2_reference``), token by token in fp32: gates from an
    fp32 softmax, each token's two largest gates renormalized, each
    expert's MLP with the tanh GELU; no capacity."""
    xf = x.reshape(-1, x.shape[-1]).float()
    gates = torch.softmax(xf @ params["wg"].float(), dim=-1)
    top_w, top_e = torch.topk(gates, 2, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for g in range(xf.shape[0]):
        for w, e in zip(top_w[g], top_e[g].tolist()):
            up = F.gelu(xf[g] @ params["w_up"][e].float()
                        + params["b_up"][e].float(), approximate="tanh")
            out[g] += w * (up @ params["w_down"][e].float()
                           + params["b_down"][e].float())
    return out.reshape(x.shape)


def second_expert_dropped(real):
    """A planted fault: each token's smaller combine weight (its second
    expert's) set to 0."""
    def dispatch(gates, capacity):
        d, c = real(gates, capacity)
        top = c.amax(dim=(1, 2), keepdim=True)
        return d, torch.where(c == top, c, torch.zeros_like(c))

    return dispatch


def moe_mlp_vs_loop(cfg, params, device):
    """moe_mlp (fp32, capacity unconstrained: factor E / 2 gives C = G)
    on layer 0's experts and a seeded [1, 512, 1024] input against
    `top2_loop`; the planted fault must exceed the limit."""
    mcfg = dataclasses.replace(cfg.moe_cfg(), dtype=torch.float32,
                               capacity_factor=cfg.n_experts / 2)
    layer = {k.removeprefix("moe_"): params[k][0].detach()
             for k in ("wg", "moe_w_up", "moe_b_up", "moe_w_down",
                       "moe_b_down")}
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(*MOE_MLP_SLICE, cfg.d_model))
                         .astype(np.float32)).to(device)
    ref = top2_loop(x, layer)
    rel = lambda y: float((y - ref).norm() / ref.norm())
    with torch.no_grad():
        err = rel(tmoe.moe_mlp(x, layer, mcfg)[0])
        real = tmoe._top2_dispatch
        tmoe._top2_dispatch = second_expert_dropped(real)
        try:
            planted = rel(tmoe.moe_mlp(x, layer, mcfg)[0])
        finally:
            tmoe._top2_dispatch = real
    res = {"rel_err": err, "tol": MOE_MLP_REL_TOL,
           "planted_second_expert_dropped_rel_err": planted}
    if not err <= MOE_MLP_REL_TOL < planted:
        raise AssertionError(f"moe_mlp against the plain loop: {res}")
    return res


def dropped_shard(real):
    """A planted fault in the ep sum: shard 1's partial lost."""
    return lambda parts, device: real(parts[:1] + parts[2:], device)


def ep_check(cfg, params, batch, device):
    """The loss with the expert stacks placed on an ep = 4 mesh (every
    shard on the card) against ep = 1 on the same parameters, routed as
    ep = 1 routes (`HeldRouting`), and by their own routing; the planted
    dropped shard must exceed the limit. The gradients are held in
    `moe_fp32_steps`."""
    mesh = device_mesh(MOE_EP, axis="ep", devices=[device] * MOE_EP)
    held = HeldRouting()
    with torch.no_grad():
        placed = partition.place_on_axis(
            {k: v.detach() for k, v in params.items()},
            moe_gpt.logical_axes(cfg), mesh, "ep")
        loss = lambda p, m: float(moe_gpt.loss_fn(p, *batch, cfg,
                                                   ep_mesh=m))
        with held.recording():
            one = loss(params, None)
        free = loss(placed, mesh)
        with held.replaying():
            four = loss(placed, mesh)
        flipped = held.flipped
        with dropped_ep_shard(), held.replaying():
            planted = loss(placed, mesh)
    del placed
    torch.cuda.empty_cache()
    res = {"loss_ep1": one, "loss_ep4": four, "loss_abs_diff": abs(four - one),
           "tol": MOE_EP_LOSS_TOL, "routing": "held to ep=1's",
           "routes_flipped_ep4": flipped,
           "loss_ep4_own_routing": free,
           "loss_abs_diff_own_routing": abs(free - one),
           "planted_dropped_shard_loss_abs_diff": abs(planted - one)}
    if not abs(four - one) <= MOE_EP_LOSS_TOL < abs(planted - one):
        raise AssertionError(f"ep=4 against ep=1: {res}")
    return res


@contextlib.contextmanager
def dropped_ep_shard():
    """`moe_mlp`'s ep sum with the planted `dropped_shard` fault."""
    real = tmoe.reduce_shards
    tmoe.reduce_shards = dropped_shard(real)
    try:
        yield
    finally:
        tmoe.reduce_shards = real


def moe_fp32_steps(cfg, params, batch, device):
    """The held steps again with fp32 activations (fp32 flash kernels,
    TF32 off), loss and gradients, at full width and depth: flash
    against plain attention (and a zeroed dq against plain), and the
    expert stacks on an ep = 4 mesh against ep = 1 (and a dropped shard
    against ep = 1), every run routed as the fp32 flash ep = 1 run
    routes. Where the bf16 step's gaps are rounding, these fall under
    MOE_F32_GRAD_TOL, and the planted faults stay over it."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    mesh = device_mesh(MOE_EP, axis="ep", devices=[device] * MOE_EP)
    held = HeldRouting()

    def step(p, impl, ep_mesh=None):
        loss = moe_gpt.loss_fn(p, *batch, dataclasses.replace(
            cfg32, attn_impl=impl), ep_mesh=ep_mesh)
        # A dropped shard leaves its leaves out of the graph: zeros.
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True,
                                    materialize_grads=True)
        return float(loss.detach()), joined_shards(
            dict(zip(p, grads)), MOE_EP, 1)

    with held.recording():
        loss_f, g_f = step(params, "flash")
    with held.replaying():
        loss_x, g_x = step(params, "xla")
    flash = {"loss_flash": loss_f, "loss_xla": loss_x,
             **step_diff(loss_f, g_f, loss_x, g_x),
             "routes_flipped": held.flipped}
    real = fa.flash_bwd
    fa.flash_bwd = planted_backwards(real)["dq zeroed"]
    try:
        with held.replaying():
            loss_p, g_p = step(params, "flash")
    finally:
        fa.flash_bwd = real
    flash["planted_dq_zeroed"] = step_diff(loss_p, g_p, loss_x, g_x)
    del g_x, g_p
    placed = {k: v.requires_grad_(True) for k, v in partition.place_on_axis(
        {k: v.detach() for k, v in params.items()},
        moe_gpt.logical_axes(cfg), mesh, "ep").items()}
    with held.replaying():
        loss_4, g_4 = step(placed, "flash", mesh)
    ep = {"loss_ep1": loss_f, "loss_ep4": loss_4,
          **step_diff(loss_4, g_4, loss_f, g_f),
          "expert_grad_rel_err": layer_rel_err(g_4, g_f, MOE_EXPERT_LEAVES),
          "routes_flipped": held.flipped}
    del g_4
    with dropped_ep_shard(), held.replaying():
        loss_d, g_d = step(placed, "flash", mesh)
    ep["planted_dropped_shard"] = {
        **step_diff(loss_d, g_d, loss_f, g_f),
        "expert_grad_rel_err": layer_rel_err(g_d, g_f, MOE_EXPERT_LEAVES)}
    del placed, g_f, g_d
    torch.cuda.empty_cache()
    res = {"activations": "fp32", "tol": MOE_F32_GRAD_TOL,
           "routing": "held to the fp32 flash ep=1 run's",
           "flash_vs_xla": flash, "ep4_vs_ep1": ep}
    tol = MOE_F32_GRAD_TOL
    if not (flash["grad_rel_err"] <= tol < flash["planted_dq_zeroed"][
            "grad_rel_err"] and max(ep["grad_rel_err"],
                                    ep["expert_grad_rel_err"]) <= tol
            < ep["planted_dropped_shard"]["expert_grad_rel_err"]):
        raise AssertionError(f"fp32 moe steps: {res}")
    return res


def routing_timings(cfg, gates):
    """Device time of one layer's routing at the step's shapes: the
    dispatch construction (`_top2_dispatch` and the two bf16 casts) and
    its backward to the gates, the two routing einsums (gec,gd->ecd and
    gec,ecd->gd) and their backward products (dx of the first; dcombine
    and dexpert-output of the second), each by `device_ms`; per step
    they run 2 x L (forward, remat's recompute) and L (backward) times."""
    G, E, D = gates.shape[0], cfg.n_experts, cfg.d_model
    C = cfg.moe_cfg().capacity(G)
    dt = cfg.dtype
    g = gates.clone().requires_grad_(True)

    def build():
        d, c = tmoe._top2_dispatch(g, C)
        return d.to(dt), c.to(dt)

    with torch.no_grad():
        disp, comb = build()
    rng = np.random.default_rng(13)
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(gates.device, dt).requires_grad_(True)
    xd, down, comb = mk(G, D), mk(E, C, D), comb.clone().requires_grad_(True)
    dy, dein = mk(G, D).detach(), mk(E, C, D).detach()
    dc = torch.ones((G, E, C), device=gates.device, dtype=dt)
    fwd = {"dispatch_einsum": lambda: torch.einsum("gec,gd->ecd", disp, xd),
           "combine_einsum": lambda: torch.einsum("gec,ecd->gd", comb, down)}
    with torch.no_grad():
        ms = {k: device_ms(f, iters=10) for k, f in fwd.items()}
        ms["top2_dispatch"] = device_ms(build, iters=10)
    y1, y2 = fwd["dispatch_einsum"](), fwd["combine_einsum"]()
    ms["dispatch_einsum_bwd"] = device_ms(lambda: torch.autograd.grad(
        y1, xd, dein, retain_graph=True), iters=10)
    ms["combine_einsum_bwd"] = device_ms(lambda: torch.autograd.grad(
        y2, (comb, down), dy, retain_graph=True), iters=10)
    built = build()[1]
    ms["top2_dispatch_bwd"] = device_ms(lambda: torch.autograd.grad(
        built, g, dc, retain_graph=True), iters=10)
    L = cfg.n_layers
    per_step = {k: v * (L if k.endswith("_bwd") else 2 * L)
                for k, v in ms.items()}
    einsum_flops = 2.0 * G * E * C * D
    einsums_per_step = (2 * 2 + 1 + 2) * L     # fwd x2 (remat), bwd 1 + 2
    return {"shape": f"G={G} E={E} C={C} D={D} {str(dt)[6:]}",
            "ms_per_call": ms, "ms_per_step": per_step,
            "einsum_ms_per_step": sum(v for k, v in per_step.items()
                                      if "einsum" in k),
            "dispatch_build_ms_per_step": per_step["top2_dispatch"]
            + per_step["top2_dispatch_bwd"],
            "einsum_flops_per_call": einsum_flops,
            "einsum_tflop_per_step": einsums_per_step * einsum_flops / 1e12}


def moe_flops_per_token(cfg) -> float:
    """`train_flops_per_token`'s count for MoE-GPT on the ACTIVE matmul
    parameters: the tied head once, 4 d^2 of attention, the router's d E
    and two of the E experts' 2 d d_ff per layer; plus 12 L d S. The
    routing einsums are not model FLOPs (`routing_timings` counts them)."""
    n = cfg.vocab_size * cfg.d_model + cfg.n_layers * (
        4 * cfg.d_model * cfg.d_model + cfg.d_model * cfg.n_experts
        + 2 * 2 * cfg.d_model * cfg.d_ff)
    return 6.0 * n + 12 * cfg.n_layers * cfg.d_model * cfg.max_seq


def moe_flash_vs_xla(cfg, params, batch):
    """One step with flash attention against plain attention from the
    same parameters, the plain run routed as the flash run routes
    (`HeldRouting`), under the train phase's loss and attention limits
    and MOE_GRAD_TOL on the whole gradient; a zeroed dq must fail the
    attention limit. The plain run's loss by its own routing is printed
    beside."""
    held = HeldRouting()
    with held.recording():
        loss_f, g_f = loss_and_grads(cfg, params, batch, "flash",
                                     model=moe_gpt)
    with held.replaying():
        loss_x, g_x = loss_and_grads(cfg, params, batch, "xla",
                                     model=moe_gpt)
    res = {"loss_flash": loss_f, "loss_xla": loss_x,
           **step_diff(loss_f, g_f, loss_x, g_x),
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": MOE_GRAD_TOL,
           "attn_grad_tol": TRAIN_ATTN_GRAD_TOL,
           "routing": "xla held to flash's", "routes_flipped": held.flipped,
           "route_calls": len(held.gates)}
    del g_f
    real = fa.flash_bwd
    fa.flash_bwd = planted_backwards(real)["dq zeroed"]
    try:
        with held.replaying():
            loss_p, g_p = loss_and_grads(cfg, params, batch, "flash",
                                         model=moe_gpt)
    finally:
        fa.flash_bwd = real
    res["planted_dq_zeroed"] = step_diff(loss_p, g_p, loss_x, g_x)
    del g_p, g_x
    with torch.no_grad():
        own = float(moe_gpt.loss_fn(params, *batch, dataclasses.replace(
            cfg, attn_impl="xla")))
    res.update(loss_xla_own_routing=own,
               loss_abs_diff_own_routing=abs(own - loss_f))
    torch.cuda.empty_cache()
    if not (res["loss_abs_diff"] <= TRAIN_LOSS_TOL
            and res["grad_rel_err"] <= MOE_GRAD_TOL
            and res["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_TOL):
        raise AssertionError(f"moe flash vs xla step disagree: {res}")
    if not res["planted_dq_zeroed"]["attn_grad_rel_err"] > \
            TRAIN_ATTN_GRAD_TOL:
        raise AssertionError(f"a zeroed dq passes the check: {res}")
    return res


def phase_train_moe(device, errs):
    """The MoE-GPT family on the training path: moe_8x350m at full width
    and depth, S 1024, B 8, bf16 over fp32 parameters, remat, flash
    attention, adamw(3e-4, wd 0.1, mu bf16), random weights from seed 0."""
    t_phase = time.perf_counter()
    shapes = {"moe": flash_shape_timings(device, errs, "moe_8x350m", MOE_B,
                                         MOE_S, 16, 64, True, 10)[0]}
    emit({"phase": "flash_kernel_timing_moe", **{
        f"{k} {tag}": v for tag, t in shapes.items() for k, v in t.items()}})
    cfg = moe_gpt.MoEGPTConfig.moe_8x350m(max_seq=MOE_S, attn_impl="flash")
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, device,
                                             model=moe_gpt)
    batch = train_batch_of(cfg.vocab_size, MOE_B, MOE_S, device)
    gates = first_gates(cfg, params, batch)
    routing = routing_on_the_card(cfg, gates)
    mlp = moe_mlp_vs_loop(cfg, params, device)
    compare = moe_flash_vs_xla(cfg, params, batch)
    ep = ep_check(cfg, params, batch, device)
    fp32 = moe_fp32_steps(cfg, params, batch, device)
    routing_ms = routing_timings(cfg, gates)
    del gates
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, losses, step_ms, launches, per_step = timed_steps(
        step, params, opt_state, batch, MOE_STEPS)
    if per_step != MOE_PER_STEP:
        raise AssertionError(f"moe flash launches per step {per_step}, "
                             f"expected {MOE_PER_STEP}")
    peak_mem = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_ms[1:]))
    tok_s = MOE_B * MOE_S / (p50 / 1e3)
    fpt = moe_flops_per_token(cfg)
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    total, active = moe_gpt.num_params(cfg)
    out = {"phase": "train_moe", "config": "moe_8x350m bf16 remat flash "
           f"B={MOE_B} S={MOE_S} adamw(3e-4, wd=0.1, mu bf16)",
           "num_params": {"total": total, "active": active},
           "routing_on_the_card": routing, "moe_mlp_vs_loop": mlp,
           "flash_vs_xla": compare, "ep4_vs_ep1": ep, "fp32_steps": fp32,
           "steps_timed": MOE_STEPS, "step_ms": step_ms, "step_ms_p50": p50,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": fpt * tok_s / BF16_FLOPS,
           "routing": {**routing_ms, "einsum_share_of_step_device_ms": (
               routing_ms["einsum_ms_per_step"]
               / profiled["device_busy_ms"]),
               "dispatch_build_share_of_step_device_ms": (
                   routing_ms["dispatch_build_ms_per_step"]
                   / profiled["device_busy_ms"])},
           "max_memory_allocated": peak_mem,
           "max_memory_allocated_gb": peak_mem / 2**30,
           "losses": losses, "launches": launches,
           "launches_per_step": per_step, "profile_one_step": profiled,
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, shapes


# ----------------------------------------------------------- pipeline

PIPE_PP, PIPE_STEPS = 4, 3
# Per step with remat: CUT_DEPTH layers x 8 microbatches of flash forward
# twice (block and recompute), dq and dkv once each.
PIPE_PER_STEP = {"flash_fwd": 128, "flash_delta": 64, "flash_dq": 64,
                 "flash_dkv": 64}


def off_by_one_schedule(real):
    """A planted fault in the pipeline's schedule: every stage after the
    first takes the previous microbatch's activation (its first takes its
    own)."""
    def apply(stage_fn, stages, x, *, mesh, n_micro):
        held = {}

        def stage(stack, act):
            r = next(i for i, s in enumerate(stages) if s is stack)
            if r:
                act, held[r] = held.get(r, act), act
            return stage_fn(stack, act)

        return real(stage, stages, x, mesh=mesh, n_micro=n_micro)

    return apply




def phase_train_pipeline(device, errs):
    """GPipe on the training path: bench.py's headline step (gpt2_124m
    cut to its first CUT_DEPTH of 12 layers, full width, S 1024, B 8,
    remat, flash, the same adamw) through build_pipeline_training at pp
    = 4 with every stage on the card: 2 layers per stage, 8 microbatches
    of 1."""
    t_phase = time.perf_counter()
    shapes = {"pipeline": flash_shape_timings(
        device, errs, "pipeline microbatch", 1, TRAIN_S, 12, 64, True,
        11)[0]}
    emit({"phase": "flash_kernel_timing_pipeline", **{
        f"{k} {tag}": v for tag, t in shapes.items() for k, v in t.items()}})
    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_124m(
        max_seq=TRAIN_S, remat=True, attn_impl="flash"), n_layers=CUT_DEPTH)
    mesh = device_mesh(PIPE_PP, axis="pp", devices=[device] * PIPE_PP)
    n_micro = split_microbatch_count(TRAIN_B, PIPE_PP)
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_pipeline_training(
        cfg, opt, gen, device, mesh=mesh, n_micro=n_micro)
    batch = train_batch(cfg, device)

    def pipe_grads():
        loss = gpt.pipeline_loss_fn(params, *batch, cfg, mesh, n_micro)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), joined_shards(
            dict(zip(params, grads)), PIPE_PP, 0)

    loss_s, g_s = loss_and_grads(cfg, joined_shards(params, PIPE_PP, 0),
                                 batch, "flash")
    loss_p, g_p = pipe_grads()
    compare = {"loss_pipeline": loss_p, "loss_sequential": loss_s,
               **step_diff(loss_p, g_p, loss_s, g_s),
               "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
               "attn_grad_tol": TRAIN_ATTN_GRAD_TOL}
    real = tpipe.pipeline_apply
    tpipe.pipeline_apply = off_by_one_schedule(real)
    try:
        loss_o, g_o = pipe_grads()
    finally:
        tpipe.pipeline_apply = real
    compare["planted_off_by_one"] = step_diff(loss_o, g_o, loss_s, g_s)
    del g_s, g_p, g_o
    if not (compare["loss_abs_diff"] <= TRAIN_LOSS_TOL
            and compare["grad_rel_err"] <= TRAIN_GRAD_TOL
            and compare["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_TOL):
        raise AssertionError(f"pipeline vs sequential disagree: {compare}")
    fault = compare["planted_off_by_one"]
    if not (fault["grad_rel_err"] > TRAIN_GRAD_TOL
            and fault["attn_grad_rel_err"] > TRAIN_ATTN_GRAD_TOL):
        raise AssertionError(f"an off-by-one schedule passes: {compare}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, losses, step_ms, launches, per_step = timed_steps(
        step, params, opt_state, batch, PIPE_STEPS)
    if per_step != PIPE_PER_STEP:
        raise AssertionError(f"pipeline flash launches per step {per_step}, "
                             f"expected {PIPE_PER_STEP}")
    peak_mem = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_ms[1:]))
    tok_s = TRAIN_B * TRAIN_S / (p50 / 1e3)
    fpt = train_flops_per_token(cfg)
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    train = next((p for p in RECORD["phases"] if p["phase"] == "train"), {})
    out = {"phase": "train_pipeline", "config": f"gpt2_124m (first "
           f"{CUT_DEPTH} of 12 layers) bf16 remat flash pp={PIPE_PP} "
           f"(every stage on one card) n_micro={n_micro} B={TRAIN_B} "
           f"S={TRAIN_S} adamw(3e-4, wd=0.1, mu bf16)",
           "pipeline_vs_sequential": compare, "steps_timed": PIPE_STEPS,
           "step_ms": step_ms, "step_ms_p50": p50,
           "train_phase_step_ms_p50": train.get("step_ms_p50"),
           "tokens_per_s": tok_s, "mfu": fpt * tok_s / BF16_FLOPS,
           "max_memory_allocated_gb": peak_mem / 2**30, "losses": losses,
           "launches": launches, "launches_per_step": per_step,
           "profile_one_step": profiled,
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, shapes


# ------------------------------------------------- distributed training

DIST_STEPS = 5        # per topology: one warm-up and 4 timed
DIST_RANK_GPUS = 0.5  # two ranks share the card
DIST_HYBRID_GPUS = 0.25   # four ranks share it
DIST_KERNEL_SEED = 16
# The topologies of the two gangs: mesh shape and optimizer.
DIST_TWO_RANKS = {
    "dp": ({"dp": 2, "fsdp": 1}, "adamw"),
    "fsdp": ({"dp": 1, "fsdp": 2}, "adamw"),
    "tp": ({"tp": 2, "fsdp": 1}, "adamw"),
    "fsdp_adafactor": ({"dp": 1, "fsdp": 2}, "adafactor")}
DIST_FOUR_RANKS = {"fsdp_tp": ({"fsdp": 2, "tp": 2}, "adamw")}
# The topologies whose step is profiled once (the device's idle share):
# two steps each, run with the others' steps left out for time.
DIST_PROFILED = ("world1", "dp")
# An fsdp rank's peak as recorded in PERF.md when every slice was
# gathered whole before the loss: 3.44 GB a rank against a dp rank's
# 3.71, on this phase's step.
WHOLE_TREE_FSDP_PEAK_GB = 3.44
# The reference gradient crosses to each rank through the object plane
# (fp32, ~0.5 GB); every other gate reads scalars and digests.
# |P1 - P1'|, every element: a rank's parameters after its first step,
# gathered whole, against one controller's optimizer applied to the same
# whole parameters and the rank's own first gradients, gathered whole.
# Adamw is elementwise (the same bits expected); Adafactor's factored
# means and block RMS sum in another order over pieces (fp32: ~4e-9 at
# a tiny size on the CPU; one fp32 ulp of a parameter near 1.0 is
# 1.2e-7). A wrong update is off by the learning rate, 3e-4 (adamw), or
# by it times a leaf's RMS (Adafactor: ~6e-6 for wq).
DIST_UPDATE_TOL = 1e-6
# The topologies whose 5-step losses are not held to the reference's at
# TRAIN_LOSS_TOL: the hybrid's drift 6.2e-4 (my chip run, PR 24; tp's
# own 4.9e-4, dp's 2.2e-4): two runs' bf16 roundings, not a fault. Its
# loss is held each step to one controller's on its own parameters, its
# first gradients and update to one controller's, and its distance from
# the fp32 run to one controller's bf16 runs'.
DIST_TRAJECTORY_UNGATED = ("fsdp_tp",)


def dist_optimizer(name):
    """The train phase's adamw, or bench.py's BENCH_OPT=adafactor."""
    if name == "adamw":
        return adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    return adafactor(3e-4)


def params_digest(params) -> str:
    """sha256 of every leaf's bytes in name order: bitwise identity of
    two ranks' parameters."""
    h = hashlib.sha256()
    for k in sorted(params):
        t = params[k].detach().contiguous().cpu()
        h.update(k.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def resident_bytes(params, opt_state) -> dict:
    """Bytes the rank holds of the parameters and of AdamW's moments."""
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return {"params": nbytes(params.values()),
            "moments": nbytes(list(opt_state.mu.values())
                              + list(opt_state.nu.values()))}


def assigned_bytes(cfg, mesh, opt) -> dict:
    """What tree_to_shardings assigns this rank: each leaf's piece (its
    `Sharding.local_shape` of the global shape) in the parameters' dtype,
    and each moment's piece (its opt_state_shardings entry) in the dtype
    the optimizer keeps it in."""
    from ray_tpu_torch.train import spmd as tspmd

    specs = gpt.param_specs(cfg)
    shardings = partition.tree_to_shardings(gpt.logical_axes(cfg), mesh)
    meta = {k: torch.empty(shardings[k].local_shape(v["shape"]),
                           dtype=cfg.param_dtype, device="meta")
            for k, v in specs.items()}
    moments = tspmd.opt_state_shardings(opt, meta, shardings, mesh)
    kept = opt.init(meta)          # the moments' dtypes, nothing allocated
    nbytes = lambda s, k, dt: int(np.prod(s.local_shape(
        specs[k]["shape"]))) * torch.empty((), dtype=dt).element_size()
    return {"params": sum(nbytes(shardings[k], k, cfg.param_dtype)
                          for k in specs),
            "moments": sum(nbytes(getattr(moments, m)[k], k,
                                  getattr(kept, m)[k].dtype)
                           for k in specs for m in ("mu", "nu"))}


def dist_gathered_grads(step, params, batch, shardings, mesh):
    """The step's first gradients (`grads_of`: a split leaf's is the
    rank's piece) gathered whole on every rank, with the step's loss."""
    loss, grads = step.grads_of(params, batch)
    with torch.no_grad():
        whole = {k: mesh.gather_whole(g, shardings[k])
                 for k, g in grads.items()}
    return float(loss), whole


def keep_local_slice(mesh):
    """The planted fsdp fault, for ``mesh.reduce_scatter_mean``: the rank
    keeps its own slice of its own gradient, reduced with no other
    rank."""
    def local(grad, axis, dim):
        n = grad.shape[dim] // mesh.shape[axis]
        return grad.narrow(dim, mesh.coords[axis] * n, n)
    return local


def keep_own_tp_part():
    """The planted tp fault: the input of each column-parallel product
    keeps this rank's part of its gradient (`_ColumnParallel`'s backward
    skips its all-reduce over tp) → the real reduce, to restore."""
    real = dec._ColumnParallel.reduce
    dec._ColumnParallel.reduce = staticmethod(lambda t, mesh: t)
    return real


def planted_forward_loss(cfg, params, rows, mesh, shardings):
    """The planted fault of the tp loss gate: the loss with each
    row-parallel sum (and the vocab-parallel lookup) left as the rank's
    own partial (`reduce_from`'s forward skips its all-reduce)."""
    real = tmesh._ReduceFrom.forward
    tmesh._ReduceFrom.forward = staticmethod(lambda ctx, x, mesh, axis: x)
    try:
        with torch.no_grad():
            return float(gpt.loss_fn(
                params, *rows, cfg,
                plan=gpt.rank_plan(cfg, mesh, shardings)))
    finally:
        tmesh._ReduceFrom.forward = staticmethod(real)


def first_step_gates(config, name, cfg, step, params, rows, shardings,
                     mesh, ref_grads):
    """The first step's gradients gathered whole against the reference's
    (on every rank), and each topology's planted faults: fsdp's local
    reduce-scatter, tp's local copy gradient and its forward without the
    row-parallel sums (against the loss limit). → (readings, the first
    step's gradients gathered whole)."""
    dev = mesh.device
    ref_grads = {k: v.to(dev) for k, v in ref_grads.items()}
    ref_loss = config["ref_losses"][config["opt"][name]][0]
    fault = {"fsdp": "planted_local_reduce_scatter",
             "tp": "planted_tp_copy_keeps_own_grad"}.get(name)
    out = {}
    for tag in ("first_step",) + ((fault,) if fault else ()):
        real = None
        if tag == "planted_local_reduce_scatter":
            mesh.reduce_scatter_mean = keep_local_slice(mesh)
        elif tag == "planted_tp_copy_keeps_own_grad":
            real = keep_own_tp_part()
        try:
            loss, whole = dist_gathered_grads(step, params, rows, shardings,
                                              mesh)
        finally:
            vars(mesh).pop("reduce_scatter_mean", None)
            if real is not None:
                dec._ColumnParallel.reduce = staticmethod(real)
        out[tag] = step_diff(loss, whole, ref_loss, ref_grads)
        if tag == "first_step":
            first = whole
        del whole
    if name == "tp":
        out["planted_tp_skips_forward_reduce"] = abs(
            planted_forward_loss(cfg, params, rows, mesh, shardings)
            - ref_loss)
    del ref_grads
    return out, first


def gathered(mesh, params, shardings):
    """The rank's pieces gathered whole (a copy), kept out of the
    topology's collective counts."""
    stats, mesh.stats = mesh.stats, type(mesh.stats)()
    try:
        with torch.no_grad():
            return {k: mesh.gather_whole(p.detach(), shardings[k]).clone()
                    for k, p in params.items()}
    finally:
        mesh.stats = stats


def one_controller_update(opt, params, grads):
    """``params`` (whole, updated in place) after ``opt``'s first step on
    one controller with ``grads``, moved to the host (out of the peak
    memory of the steps it is held across)."""
    with torch.no_grad():
        updates, _ = opt.update(grads, opt.init(params), params)
        apply_updates(params, updates)
    return {k: v.cpu() for k, v in params.items()}


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over every element of every leaf (``b`` may
    lie on the host)."""
    return max(float((a[k] - b[k].to(a[k].device)).abs().max()) for k in b)


def whole_tree_peak_gb(cfg, opt, mesh, shardings, params, opt_state, rows):
    """The peak of one step that gathers every fsdp slice before the loss
    (``spmd.gather_params``, the earlier design: autograd keeps the whole
    leaves until the backward) on this rank's parameters and state."""
    from ray_tpu_torch.train import spmd as tspmd

    whole_step = tspmd.make_train_step(
        lambda p, t, tg: gpt.loss_fn(
            tspmd.gather_params(p, shardings, mesh), t, tg, cfg), opt,
        process_mesh=mesh, shardings=shardings)
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    whole_step(params, opt_state, rows)
    torch.cuda.synchronize(mesh.device)
    return torch.cuda.max_memory_allocated(mesh.device) / 2**30


def anchored_loss(cfg, mesh, params, shardings, batch):
    """The single controller's loss (no gradient) on this rank's
    parameters gathered whole and the global ``batch``: a tp rank's
    loss is held to it at each step, beside the reference run's
    trajectory (tp's partial sums round elsewhere than one controller's
    products: an equally exact bf16 run, which five Adam steps carry
    apart). Its gathers and launches are kept out of the topology's
    counts."""
    counts, stats = flash_counts(), mesh.stats
    mesh.stats = type(stats)()
    try:
        with torch.no_grad():
            whole = {k: mesh.gather_whole(p.detach(), shardings[k])
                     for k, p in params.items()}
            return float(gpt.loss_fn(whole, *batch, cfg))
    finally:
        mesh.stats = stats
        for k, n in counts.items():
            getattr(fa, k).launches = n


def dist_topology(config, name, mesh, cfg, opt, batch, ref_grads):
    """One topology on this rank: build_training on ``mesh`` from seed
    0, the gates' readings (``ref_grads``: the reference's first-step
    gradients on the host), DIST_STEPS steps (counters zeroed just before
    and read just after; the parameters after the first, gathered whole,
    against one controller's optimizer on the same whole parameters and
    the rank's first gradients: `DIST_UPDATE_TOL`), one profiled
    step."""
    from ray_tpu_torch.train import spmd as tspmd

    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen,
                                             process_mesh=mesh)
    shardings = tspmd.param_shardings(gpt.logical_axes(cfg), mesh)
    rows = tuple(batch_sharding(mesh).shard(x) for x in batch)
    out = {"coords": {a: c for a, c in mesh.coords.items()
                      if mesh.shape[a] > 1}, "batch_rows": rows[0].shape[0],
           "w_up_piece": list(params["w_up"].shape)}
    if config["opt"][name] == "adamw":
        out["bytes"] = resident_bytes(params, opt_state)
        out["bytes_assigned"] = assigned_bytes(cfg, mesh, opt)
    gates, first_grads = first_step_gates(config, name, cfg, step, params,
                                          rows, shardings, mesh, ref_grads)
    out.update(gates)
    p0 = gathered(mesh, params, shardings)
    expected = one_controller_update(opt, {k: v.clone() for k, v in
                                           p0.items()}, first_grads)
    # The gate's own planted fault: one controller's update with wq's
    # gradient left out (a leaf every mesh here splits or replicates).
    planted = one_controller_update(opt, p0, {
        k: torch.zeros_like(g) if k == "wq" else g
        for k, g in first_grads.items()})
    del first_grads, p0
    anchored = mesh.live("tp")
    global_batch = tuple(x.to(dev) for x in batch) if anchored else None
    fa.reset_launch_counts()
    mesh.stats = type(mesh.stats)()
    losses, step_ms, anchors, peak = [], [], [], 0
    for _ in range(DIST_STEPS):
        if anchored:
            anchors.append(anchored_loss(cfg, mesh, params, shardings,
                                         global_batch))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, rows)
        losses.append(float(loss))             # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        if expected is not None:
            p1 = gathered(mesh, params, shardings)
            out["first_update_abs_diff_max"] = max_abs_diff(p1, expected)
            out["planted_update_wq_skipped_abs_diff_max"] = max_abs_diff(
                p1, planted)
            expected = planted = p1 = None
            torch.cuda.empty_cache()
    out["launches"] = flash_counts()
    stats = mesh.stats
    if anchored:
        out["anchored_losses"] = anchors
    out.update(
        losses=losses, step_ms=step_ms,
        step_ms_p50=float(np.median(step_ms[1:])),
        max_memory_allocated_gb=peak / 2**30,
        collectives_per_step=stats.calls / DIST_STEPS,
        collective_bytes_per_step=stats.bytes / DIST_STEPS,
        staged_copies_per_step=stats.staged_copies / DIST_STEPS,
        staged_bytes_per_step=stats.staged_bytes / DIST_STEPS,
        whole_leaves_peak=stats.whole_peak,
        digest=params_digest(params))
    if name in DIST_PROFILED:
        out["profile_one_step"] = _profiled(
            lambda: step(params, opt_state, rows), top=6)
    if name == "fsdp":
        out["max_memory_allocated_gb_whole_tree_gather"] = (
            whole_tree_peak_gb(cfg, opt, mesh, shardings, params, opt_state,
                               rows))
    del params, opt_state
    torch.cuda.empty_cache()
    return out


def skip_all_reduce(mesh):
    """The planted dp fault, for ``mesh.all_reduce_mean`` on one rank: it
    joins each all-reduce (so its peers do not wait) and keeps its own
    gradient (and its own loss)."""
    real = mesh.all_reduce_mean

    def keep_own(t, axes):
        real(t.clone(), axes)
        return t
    return keep_own


def train_dist_loop(config):
    """A rank of the train_dist phase: the topologies of ``config`` in
    turn on this gang, each reported with the rank's readings."""
    from ray_tpu_torch import api as rt_api
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train import session

    started = time.time()
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, remat=True,
                                  attn_impl="flash")
    batch = train_batch(cfg, "cpu")
    ref_grads = rt_api.get(config["ref_grads"])    # once for every topology
    for name, shape in config["topologies"].items():
        mesh = make_mesh(MeshConfig(**shape))
        opt = dist_optimizer(config["opt"][name])
        out = dist_topology(config, name, mesh, cfg, opt, batch, ref_grads)
        if name == "dp":          # the planted fault: one step from seed 0
            gen = torch.Generator(device=mesh.device).manual_seed(0)
            params, opt_state, step = build_training(cfg, opt, gen,
                                                     process_mesh=mesh)
            rows = tuple(batch_sharding(mesh).shard(x) for x in batch)
            if mesh.rank == 1:
                mesh.all_reduce_mean = skip_all_reduce(mesh)
            try:
                step(params, opt_state, rows)
            finally:
                vars(mesh).pop("all_reduce_mean", None)
            out["planted_skip_all_reduce_digest"] = params_digest(params)
            del params, opt_state
        session.report({"topology": name, "rank": mesh.rank,
                        "device": str(mesh.device), "backend": mesh.backend,
                        "loop_started": started, **out})


def run_dist(config, topologies, n_ranks, scaling, backend):
    """One TorchTrainer fit of train_dist_loop over ``topologies`` ({name:
    (mesh shape, optimizer)}) → ({topology: {rank: readings}}, the wall
    from fit's start to each rank's loop start)."""
    from ray_tpu_torch.train import TorchTrainer

    t0 = time.time()
    config = {**config, "topologies": {k: v[0] for k, v in topologies.items()},
              "opt": {k: v[1] for k, v in topologies.items()}}
    result = TorchTrainer(train_dist_loop, train_loop_config=config,
                          scaling_config=scaling,
                          backend_config=backend).fit(timeout=900)
    runs: dict = {}
    for r in result.metrics_history:
        runs.setdefault(r["topology"], {})[r["rank"]] = r
    boot = {r["rank"]: r["loop_started"] - t0
            for r in result.metrics_history}
    if set(runs) != set(topologies) or any(len(v) != n_ranks
                                           for v in runs.values()):
        raise AssertionError(f"train_dist: missing rank reports {runs}")
    return runs, boot


def dist_references(device, cfg, batch):
    """The single-controller references from seed 0 on ``batch``: the
    first step's gradients (fp32, on the host), each optimizer's
    DIST_STEPS losses, the adamw run's final parameters' digest, the
    adamw losses with plain attention ("adamw_xla": how far two equally
    exact bf16 runs drift in DIST_STEPS steps) and in fp32 with plain
    attention ("adamw_fp32": how far each bf16 run stands from the
    exact one)."""
    losses = {}
    xla = dataclasses.replace(cfg, attn_impl="xla")
    fp32 = dataclasses.replace(xla, dtype=torch.float32)
    for name, run_cfg in (("adamw", cfg), ("adafactor", cfg),
                          ("adamw_xla", xla), ("adamw_fp32", fp32)):
        gen = torch.Generator(device=device).manual_seed(0)
        params, opt_state, step = build_training(
            run_cfg, dist_optimizer(name.split("_")[0]), gen, device)
        if name == "adamw":
            _, ref_grads = loss_and_grads(cfg, params, batch, "flash")
            ref_grads = {k: v.float().cpu() for k, v in ref_grads.items()}
        losses[name] = []
        for _ in range(DIST_STEPS):
            params, opt_state, loss = step(params, opt_state, batch)
            losses[name].append(float(loss))
        if name == "adamw":
            digest = params_digest(params)
        del params, opt_state
        torch.cuda.empty_cache()
    return ref_grads, losses, digest


def dist_summary(name, ranks, ref_losses, bad, fp32=None):
    """The phase's line for one topology, its gates appended to ``bad``:
    the launches, the 5-step losses against the reference's (but in
    DIST_TRAJECTORY_UNGATED), a tp rank's loss at each step against one
    controller's on the rank's own parameters (the anchor), the first
    gradients against the reference's, the first update against one
    controller's, and (``fp32``: the fp32 run's losses and the farthest
    one controller's bf16 runs stand from them) the distance from the
    fp32 run against one controller's."""
    for r, run in sorted(ranks.items()):
        per_step = {k: v / DIST_STEPS for k, v in run["launches"].items()}
        if per_step != FLASH_PER_STEP:
            bad.append(f"{name} rank {r}: flash launches per step "
                       f"{per_step}, expected {FLASH_PER_STEP}")
        dist = lambda ref: max(abs(a - b) for a, b in zip(run["losses"], ref))
        run["loss_abs_diff_max"] = dist(ref_losses)
        gated = ([] if name in DIST_TRAJECTORY_UNGATED
                 else ["loss_abs_diff_max"])
        if "anchored_losses" in run:
            run["anchored_loss_abs_diff_max"] = dist(run["anchored_losses"])
            gated.append("anchored_loss_abs_diff_max")
        for key in gated:
            if not run[key] <= TRAIN_LOSS_TOL:
                bad.append(f"{name} rank {r}: {key} {run[key]}")
        if fp32 is not None:
            fp32_losses, farthest = fp32
            d = run["loss_abs_diff_from_fp32_max"] = dist(fp32_losses)
            if not d <= farthest:
                bad.append(f"{name} rank {r}: {d} from the fp32 run, one "
                           f"controller's bf16 runs {farthest}")
        u = run["first_update_abs_diff_max"]
        if not u <= DIST_UPDATE_TOL:
            bad.append(f"{name} rank {r}: first update {u}")
        if not run["planted_update_wq_skipped_abs_diff_max"] > DIST_UPDATE_TOL:
            bad.append(f"{name} rank {r}: an update without wq's gradient "
                       "passes the update gate")
        g = run["first_step"]["grad_rel_err"]
        if not g <= TRAIN_GRAD_TOL:
            bad.append(f"{name} rank {r}: first-step gradients {g}")
        if "bytes" in run and run["bytes"] != run["bytes_assigned"]:
            bad.append(f"{name} rank {r}: resident {run['bytes']} against "
                       f"assigned {run['bytes_assigned']}")
    run0 = ranks[0]
    per_rank = lambda key: {r: run[key] for r, run in ranks.items()}
    out = {
        "backend": run0["backend"],
        "devices": sorted({run["device"] for run in ranks.values()}),
        "coords": per_rank("coords"),
        "batch_rows_per_rank": run0["batch_rows"],
        "w_up_piece": run0["w_up_piece"],
        "losses": run0["losses"],
        "loss_abs_diff_max": per_rank("loss_abs_diff_max"),
        **({"loss_abs_diff_from_fp32_max": per_rank(
            "loss_abs_diff_from_fp32_max")}
           if "loss_abs_diff_from_fp32_max" in run0 else {}),
        "first_update_abs_diff_max": per_rank("first_update_abs_diff_max"),
        "planted_update_wq_skipped_abs_diff_max": per_rank(
            "planted_update_wq_skipped_abs_diff_max"),
        **({"anchored_losses": run0["anchored_losses"],
            "anchored_loss_abs_diff_max": per_rank(
                "anchored_loss_abs_diff_max")}
           if "anchored_losses" in run0 else {}),
        "first_step_grad_rel_err": {
            r: run["first_step"]["grad_rel_err"] for r, run in ranks.items()},
        "first_step_attn_grad_rel_err": {
            r: run["first_step"]["attn_grad_rel_err"]
            for r, run in ranks.items()},
        "step_ms_p50": per_rank("step_ms_p50"),
        "step_ms": per_rank("step_ms"),
        **({"device_idle_share": {r: run["profile_one_step"][
            "device_idle_share"] for r, run in ranks.items()},
            "profile_one_step_rank0": run0["profile_one_step"]}
           if "profile_one_step" in run0 else {}),
        "max_memory_allocated_gb": per_rank("max_memory_allocated_gb"),
        "collectives_per_step": per_rank("collectives_per_step"),
        "collective_bytes_per_step": per_rank("collective_bytes_per_step"),
        "staged_through_host": run0["staged_copies_per_step"] > 0,
        "staged_copies_per_step": per_rank("staged_copies_per_step"),
        "staged_bytes_per_step": per_rank("staged_bytes_per_step"),
        "whole_leaves_peak": per_rank("whole_leaves_peak"),
        "launches_per_step": {r: {k: v / DIST_STEPS
                                  for k, v in run["launches"].items()}
                              for r, run in ranks.items()}}
    if "bytes" in run0:
        out.update(bytes=per_rank("bytes"),
                   bytes_assigned=per_rank("bytes_assigned"))
    if "planted_tp_skips_forward_reduce" in run0:
        out["planted_tp_skips_forward_reduce"] = per_rank(
            "planted_tp_skips_forward_reduce")
        if not all(run["planted_tp_skips_forward_reduce"] > TRAIN_LOSS_TOL
                   for run in ranks.values()):
            bad.append(f"{name}: a forward without its tp reduce passes "
                       "the loss limit")
    for fault in ("planted_local_reduce_scatter",
                  "planted_tp_copy_keeps_own_grad"):
        if fault in run0:
            out[fault] = {r: run[fault] for r, run in ranks.items()}
            if not all(run[fault]["grad_rel_err"] > TRAIN_GRAD_TOL
                       for run in ranks.values()):
                bad.append(f"{name}: {fault} passes the gradient limit")
    return out


def phase_train_dist(device, errs):
    """Distributed training of bench.py's headline step (gpt2_124m, S
    1024, global B 8, bf16 over fp32 params, remat, flash, the train
    phase's adamw, seed 0) through TorchTrainer on the port's runtime:
    world 1 on NCCL, then two ranks at num_gpus=0.5 on gloo (NCCL takes
    no two ranks on one card) with CUDA tensors staged through host
    memory, dp = 2, fsdp = 2, tp = 2 and fsdp = 2 under Adafactor, then
    four ranks at num_gpus=0.25 under fsdp 2 x tp 2, each against the
    single-controller steps from the same parameters and batch."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig

    t_phase = time.perf_counter()
    shapes = {}
    for tag, b, heads in (("dp rank", TRAIN_B // 2, 12),
                          ("tp rank", TRAIN_B, 6),
                          ("hybrid rank", TRAIN_B // 2, 6)):
        shapes[tag] = flash_shape_timings(device, errs, tag, b, TRAIN_S,
                                          heads, 64, True,
                                          DIST_KERNEL_SEED)[0]
        emit({"phase": f"flash_kernel_timing_{tag.replace(' ', '_')}",
              "card": card_line(),
              **{k: v for k, v in shapes[tag].items()}})
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, remat=True,
                                  attn_impl="flash")
    batch = train_batch(cfg, device)
    ref_grads, ref_losses, ref_digest = dist_references(device, cfg, batch)

    out = {"phase": "train_dist", "card": card_line(),
           "config": "gpt2_124m bf16 remat flash global B=8 S=1024 "
           "adamw(3e-4, wd=0.1, mu bf16) or adafactor(3e-4), seed 0",
           "steps": DIST_STEPS, "reference_losses": ref_losses,
           "flash_vs_xla_loss_abs_diff_max": max(
               abs(a - b) for a, b in zip(ref_losses["adamw"],
                                          ref_losses["adamw_xla"])),
           "one_controller_from_fp32_loss_abs_diff_max": {
               k: max(abs(a - b) for a, b in zip(ref_losses[k],
                                                 ref_losses["adamw_fp32"]))
               for k in ("adamw", "adamw_xla")},
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
           "update_tol": DIST_UPDATE_TOL,
           "trajectory_ungated": list(DIST_TRAJECTORY_UNGATED)}
    bad = []
    by_path = {}
    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        t0 = time.perf_counter()
        ref = rt.put(ref_grads)
        out["reference_grads_put_s"] = time.perf_counter() - t0
        del ref_grads
        config = {"ref_losses": ref_losses, "ref_grads": ref}
        runs1, boot1 = run_dist(
            config, {"world1": ({"dp": 1, "fsdp": 1}, "adamw")}, 1,
            ScalingConfig(num_workers=1, use_gpu=True), TorchBackendConfig())
        runs2, boot2 = run_dist(
            config, DIST_TWO_RANKS, 2, ScalingConfig(
                num_workers=2, resources_per_worker={
                    "CPU": 1, "GPU": DIST_RANK_GPUS}),
            TorchBackendConfig(backend="gloo"))
        runs4, boot4 = run_dist(
            config, DIST_FOUR_RANKS, 4, ScalingConfig(
                num_workers=4, resources_per_worker={
                    "CPU": 1, "GPU": DIST_HYBRID_GPUS}),
            TorchBackendConfig(backend="gloo"))
    finally:
        rt.shutdown()
    out["worker_boot_s"] = {"world1": boot1, "two ranks": boot2,
                            "four ranks": boot4}
    opts = {"world1": "adamw", **{k: v[1] for k, v in
                                  {**DIST_TWO_RANKS,
                                   **DIST_FOUR_RANKS}.items()}}
    runs = {**runs1, **runs2, **runs4}
    for name, ranks in runs.items():
        out[name] = dist_summary(
            name, ranks, ref_losses[opts[name]], bad,
            (ref_losses["adamw_fp32"], max(out[
                "one_controller_from_fp32_loss_abs_diff_max"].values()))
            if opts[name] == "adamw" else None)
        out[name]["optimizer"] = opts[name]
        for r, run in ranks.items():
            by_path[f"train_dist {name} rank {r}"] = run["launches"]
    w1 = runs["world1"][0]
    out["world1"]["bitwise_equal_single_controller"] = {
        "losses": w1["losses"] == ref_losses["adamw"],
        "params": w1["digest"] == ref_digest}
    dp = runs["dp"]
    out["dp"]["params_identical"] = dp[0]["digest"] == dp[1]["digest"]
    out["dp"]["planted_skip_all_reduce_identical"] = (
        dp[0]["planted_skip_all_reduce_digest"]
        == dp[1]["planted_skip_all_reduce_digest"])
    if not out["dp"]["params_identical"]:
        bad.append("dp: the two ranks' parameters differ")
    if out["dp"]["planted_skip_all_reduce_identical"]:
        bad.append("dp: a rank that skips the all-reduce passes the "
                   "identity gate")
    fs = runs["fsdp"]
    out["fsdp"]["peak_gb"] = {
        "per_layer_gather": {r: run["max_memory_allocated_gb"]
                             for r, run in fs.items()},
        "whole_tree_gather": {
            r: run["max_memory_allocated_gb_whole_tree_gather"]
            for r, run in fs.items()},
        "recorded_whole_tree_gather": WHOLE_TREE_FSDP_PEAK_GB,
        "dp_rank": {r: run["max_memory_allocated_gb"]
                    for r, run in dp.items()}}
    out["phase_s"] = time.perf_counter() - t_phase
    out["gates_failed"] = bad
    emit(out)
    if bad:
        raise AssertionError(f"train_dist: {bad}")
    return by_path, shapes


# ---------------------------------------------------------------- tune

# The tune phase's Tuner: 4 trials of the train phase's step (gpt2_124m
# at full width and depth, S 1024, B 8, bf16 over fp32 params, remat,
# flash), one per learning rate, all four on the card at once under
# ASHA. Its job is this script under --tune-driver, submitted through the
# port's CLI; the spec travels in a file beside the head's state.
TUNE_SPEC = {
    "model": "gpt2_124m", "B": TRAIN_B, "S": TRAIN_S,
    "lrs": [1e-4, 3e-4, 1e-3, 3e-3], "max_t": 8, "grace_period": 2,
    "reduction_factor": 2, "trial_gpus": 0.25, "device": None,
    "reference_lr": 3e-4, "planted_steps": 2,
}
TUNE_DIR = os.path.join("build", "tune")   # under the checkout's root
TUNE_ENTRY = "chip_smoke.py"               # the job's script, --tune-driver


def tune_trial(config):
    """One Tune trial: build_training from seed 0 at ``config["lr"]`` on
    the trial's device (``session.get_device()``), the train phase's batch
    (shifted by one token for the planted trial), ``config["steps"]``
    steps, each reported with its loss, the step's flash launches (the
    counters zeroed just before it), the plain versions' calls so far,
    its wall and the peak memory; the boot's parts (the actor's start to
    the train fn, build_training, the kernel library's load) with the
    first report."""
    from ray_tpu_torch.train import session

    started = time.time()
    dev = session.get_device()      # matmuls without tf32: torch's default
    t0 = time.perf_counter()
    plain = dict.fromkeys(("reference_flash_fwd", "reference_flash_dq",
                           "reference_flash_dkv"), 0)
    for name in plain:          # count every call of a plain version
        def counted(*a, _real=getattr(fa, name), _name=name, **k):
            plain[_name] += 1
            return _real(*a, **k)
        setattr(fa, name, counted)
    cfg = getattr(gpt.GPTConfig, config["model"])(
        max_seq=config["S"], remat=True, attn_impl="flash")
    opt = adamw(config["lr"], weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, dev)
    batch = train_batch_of(cfg.vocab_size, config["B"], config["S"], dev)
    if config.get("shift"):
        batch = tuple(torch.roll(x, config["shift"], dims=1) for x in batch)
    on_card = dev.type == "cuda"
    boot = {"build_training_s": time.perf_counter() - t0}
    if on_card:
        t0 = time.perf_counter()
        _build.library()            # what the first flash launch would load
        boot["kernel_library_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(config["steps"]):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        loss = float(loss)                      # synchronizes
        session.report({
            "loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
            "launches": flash_counts(),
            "plain_calls": dict(plain), "device": str(dev),
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if on_card else None),
            "started": started, "t": time.time(), "boot": boot})


def tune_trials_summary(grid, t_fit) -> list[dict]:
    """Each trial's config, state, error and readings, in grid order."""
    out = []
    for t in grid.trials:
        reps = t.reports
        out.append({
            "config": t.config, "state": t.state, "error": t.error,
            "steps": len(reps), "losses": [r["loss"] for r in reps],
            "devices": sorted({r["device"] for r in reps}),
            "launches_per_step": [r["launches"] for r in reps],
            "plain_calls": reps[-1]["plain_calls"] if reps else None,
            "step_ms": [r["step_ms"] for r in reps],
            "peak_gb": max((r["peak_gb"] or 0.0) for r in reps) if reps
            else None,
            "boot_s": reps[0]["t"] - t_fit if reps else None,
            "boot_parts": reps[0]["boot"] if reps else None,
            "actor_to_first_report_s": (reps[0]["t"] - reps[0]["started"])
            if reps else None})
    return out


def tune_driver_main(spec_path: str) -> int:
    """``--tune-driver SPEC``: the tune phase's job. It attaches to the
    cluster its job environment names (``RAY_TPU_TORCH_ADDRESS``), runs
    the Tuner of TUNE_SPEC under ASHA, then the planted trial (the
    reference lr on a batch shifted by one token) alone, and prints the
    trials as one ``{"tune_result": ...}`` line and the best trial's
    line."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    with open(spec_path) as f:
        spec = json.load(f)
    rt.init()
    try:
        base = {"model": spec["model"], "B": spec["B"], "S": spec["S"]}
        resources = {"CPU": 1, "GPU": spec["trial_gpus"]}
        t_fit = time.time()
        grid = tune.Tuner(
            tune_trial,
            param_space={**base, "lr": tune.grid_search(spec["lrs"]),
                         "steps": spec["max_t"]},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                max_concurrent_trials=len(spec["lrs"]),
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=spec["max_t"],
                    grace_period=spec["grace_period"],
                    reduction_factor=spec["reduction_factor"])),
            resources_per_trial=resources,
            device=spec["device"]).fit(timeout=600)
        fit_s = time.time() - t_fit
        t_planted = time.time()
        planted = tune.Tuner(
            tune_trial,
            param_space={**base, "lr": spec["reference_lr"], "shift": 1,
                         "steps": spec["planted_steps"]},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            resources_per_trial=resources,
            device=spec["device"]).fit(timeout=300)
        planted_s = time.time() - t_planted
        cluster = rt.cluster_resources()
    finally:
        rt.shutdown()
    best = grid.get_best_result()
    result = {"attached_to": os.environ.get("RAY_TPU_TORCH_ADDRESS"),
              "cluster_resources": cluster, "fit_s": fit_s,
              "planted_fit_s": planted_s,
              "trials": tune_trials_summary(grid, t_fit),
              "planted": tune_trials_summary(planted, t_planted)[0],
              "best": {"lr": best.metrics["config"]["lr"],
                       "loss": best.metrics["loss"],
                       "steps": len(best.metrics_history)}}
    print(json.dumps({"tune_result": result}), flush=True)
    print(f"best trial: lr={result['best']['lr']:g} "
          f"loss={result['best']['loss']!r} "
          f"steps={result['best']['steps']}", flush=True)
    return 1 if grid.errors or planted.errors else 0


def tune_reference(device, spec) -> list[float]:
    """The train phase's losses at the reference lr (for ``--only
    tune``): build_training from seed 0, spec["max_t"] steps."""
    cfg = getattr(gpt.GPTConfig, spec["model"])(
        max_seq=spec["S"], remat=True, attn_impl="flash")
    opt = adamw(spec["reference_lr"], weight_decay=0.1,
                mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, device)
    batch = train_batch_of(cfg.vocab_size, spec["B"], spec["S"], device)
    losses = []
    for _ in range(spec["max_t"]):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return losses


def _get_json(url: str, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _port_arenas() -> set:
    return {n for n in os.listdir("/dev/shm")
            if n.startswith("raytpu-torch-arena-")}


def phase_tune(device, train_run):
    """The slice's path as a user takes it, through ``python -m
    ray_tpu_torch``: start a head with a GPU and the dashboard, submit
    this script's --tune-driver as a job (--wait), watch the dashboard
    while it runs, read the job's status and logs back through the CLI
    and the dashboard, stop the head. ``train_run``: the train phase's
    (losses, step p50 ms), or None to compute the reference here."""
    t_phase = time.perf_counter()
    spec = dict(TUNE_SPEC)
    if train_run is None:
        ref_losses, train_p50 = tune_reference(device, spec), None
    else:
        ref_losses, train_p50 = train_run
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, TUNE_DIR)
    os.makedirs(work, exist_ok=True)
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {**os.environ,
           "RAY_TPU_TORCH_STATE_DIR": os.path.join(work, "state"),
           "PYTHONPATH": os.pathsep.join(
               [root] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else []))}
    cli = [sys.executable, "-m", "ray_tpu_torch"]

    def run_cli(*args, timeout=120):
        res = subprocess.run(cli + list(args), cwd=root, env=env,
                             capture_output=True, text=True,
                             timeout=timeout)
        if res.returncode != 0:
            raise AssertionError(f"`ray_tpu_torch {' '.join(args)}` exited "
                                 f"{res.returncode}: {res.stderr[-3000:]}")
        return res.stdout

    out = {"phase": "tune", "card": card_line(), "spec": spec,
           "reference_losses": ref_losses,
           "train_phase_step_ms_p50": train_p50}
    bad = []
    arenas_before = _port_arenas()
    t0 = time.perf_counter()
    sub = None                        # the job submission, once started
    head = subprocess.Popen(
        cli + ["start", "--head", "--num-cpus", "8", "--resources",
               '{"GPU": 1}', "--dashboard-port", "0"],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    head_lines = []
    try:
        gcs = url = None
        while url is None:
            line = head.stdout.readline()
            if not line:
                raise AssertionError(f"the head exited: {head_lines}")
            head_lines.append(line.rstrip())
            if line.startswith("head started; GCS at "):
                gcs = line.split()[-1]
            elif line.startswith("dashboard at "):
                url = line.split()[-1]
        threading.Thread(target=lambda: [head_lines.append(x.rstrip())
                                         for x in head.stdout],
                         daemon=True).start()
        out["head_start_s"] = time.perf_counter() - t0
        out["gcs"], out["dashboard"] = gcs, url
        out["status_before"] = run_cli("status", "--address", gcs)
        if "nodes: 1 alive" not in out["status_before"] \
                or "GPU: 1/1 available" not in out["status_before"]:
            bad.append(f"status: {out['status_before']!r}")
        t_job = time.perf_counter()
        sub = subprocess.Popen(
            cli + ["job", "submit", "--address", gcs, "--wait",
                   "--timeout", "900", "--", sys.executable,
                   os.path.join(root, TUNE_ENTRY), "--tune-driver",
                   spec_path],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        watch = {"samples": 0, "job_running_seen": False,
                 "min_gpu_available": None, "max_actors_alive": 0,
                 "gpu_total": None}
        while sub.poll() is None:
            try:
                st = _get_json(url + "/api/cluster_status")
                jobs = _get_json(url + "/api/jobs/")
                actors = _get_json(url + "/api/actors")
            except OSError as e:
                watch["error"] = repr(e)
                break
            watch["samples"] += 1
            watch["gpu_total"] = st["resources_total"].get("GPU")
            avail = st["resources_available"].get("GPU", 0.0)
            watch["min_gpu_available"] = (
                avail if watch["min_gpu_available"] is None
                else min(avail, watch["min_gpu_available"]))
            watch["job_running_seen"] |= any(
                j["status"] == "RUNNING" for j in jobs)
            watch["max_actors_alive"] = max(
                watch["max_actors_alive"],
                sum(a["state"] == "ALIVE" for a in actors))
            time.sleep(1.0)
        stdout, stderr = sub.communicate(timeout=960)
        out["job_wall_s"] = time.perf_counter() - t_job
        out["dashboard_while_running"] = watch
        if sub.returncode != 0:
            raise AssertionError(f"job submit --wait exited {sub.returncode}"
                                 f": {stdout[-4000:]} {stderr[-3000:]}")
        job_id = stdout.splitlines()[0].strip()
        status = run_cli("job", "status", job_id, "--address", gcs).strip()
        logs = run_cli("job", "logs", job_id, "--address", gcs)
        info = _get_json(f"{url}/api/jobs/{job_id}")
        dash_logs = _get_json(f"{url}/api/jobs/{job_id}/logs")["logs"]
        listed = json.loads(run_cli("list", "jobs", "--address", gcs))
        out["job"] = {"id": job_id, "status_cli": status,
                      "status_dashboard": info["status"],
                      "return_code": info["return_code"],
                      "listed": [j["status"] for j in listed
                                 if j["job_id"] == job_id],
                      "logs_equal": logs == dash_logs
                      and stdout.endswith(logs)}
        out["stop"] = run_cli("stop").strip()
        out["head_exit_code"] = head.wait(timeout=60)
    finally:
        for proc in (sub, head):
            if proc is not None and proc.poll() is None:
                proc.terminate()       # the head stops its node on SIGTERM
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    left = sorted(_port_arenas() - arenas_before)
    record = os.path.join(work, "state", "head.json")
    out["after_stop"] = {"arenas_left": left,
                         "head_record_left": os.path.exists(record)}
    if left or os.path.exists(record) or out["head_exit_code"] != 0:
        bad.append(f"stop left {out['after_stop']} (head exit "
                   f"{out['head_exit_code']})")
    if not (status == info["status"] == "SUCCEEDED"
            and out["job"]["listed"] == ["SUCCEEDED"]
            and out["job"]["logs_equal"]):
        bad.append(f"job status/logs disagree: {out['job']}")
    if not (watch["job_running_seen"] and watch["gpu_total"] == 1):
        bad.append(f"the dashboard while running: {watch}")
    line = next((x for x in logs.splitlines()
                 if x.startswith('{"tune_result"')), None)
    best_line = next((x for x in logs.splitlines()
                      if x.startswith("best trial: ")), None)
    if line is None or best_line is None:
        raise AssertionError(f"tune: no result in the job's logs: "
                             f"{logs[-4000:]}")
    res = json.loads(line)["tune_result"]
    out["best_line"] = best_line
    out["driver"] = {k: res[k] for k in ("attached_to", "cluster_resources",
                                        "fit_s", "planted_fit_s", "best")}
    if res["attached_to"] != gcs:
        bad.append(f"the job attached to {res['attached_to']}, not {gcs}")
    by_path, trials = {}, {}
    for tr in res["trials"] + [res["planted"]]:
        tag = (f"lr={tr['config']['lr']:g}"
               + (" planted" if tr["config"].get("shift") else ""))
        trials[tag] = tr
        if tr["error"] or not tr["steps"]:
            bad.append(f"trial {tag}: {tr['state']} {tr['error']}")
            continue
        if tr["devices"] != ["cuda:0"]:
            bad.append(f"trial {tag} on {tr['devices']}")
        if any(ls != FLASH_PER_STEP for ls in tr["launches_per_step"]):
            bad.append(f"trial {tag}: flash launches per step "
                       f"{tr['launches_per_step']}, expected "
                       f"{FLASH_PER_STEP}")
        if any(tr["plain_calls"].values()):
            bad.append(f"trial {tag}: plain versions ran "
                       f"{tr['plain_calls']}")
        by_path[f"tune ({tag})"] = {
            k: sum(ls[k] for ls in tr["launches_per_step"])
            for k in FLASH_PER_STEP}
        timed = tr["step_ms"][1:] or tr["step_ms"]
        tr["step_ms_p50"] = float(np.median(timed))
    ref_trial = trials[f"lr={spec['reference_lr']:g}"]
    n = min(len(ref_trial["losses"]), len(ref_losses))
    bitwise = n >= spec["grace_period"] and \
        ref_trial["losses"][:n] == ref_losses[:n]
    planted = trials[f"lr={spec['reference_lr']:g} planted"]
    m = min(len(planted["losses"]), len(ref_losses))
    planted_bitwise = planted["losses"][:m] == ref_losses[:m]
    out["bitwise_equal_train_phase"] = {"steps_compared": n,
                                        "equal": bitwise}
    out["planted_shifted_batch"] = {"steps_compared": m,
                                    "equal": planted_bitwise,
                                    "losses": planted["losses"]}
    if not bitwise:
        bad.append(f"lr={spec['reference_lr']:g} losses "
                   f"{ref_trial['losses']} are not the train phase's "
                   f"{ref_losses[:n]}")
    if planted_bitwise or m == 0:
        bad.append("the planted shifted-batch trial passes the bitwise gate")
    steps = {tag: tr["steps"] for tag, tr in trials.items()
             if "planted" not in tag}
    stopped_early = [tag for tag, s in steps.items() if s < spec["max_t"]]
    if not stopped_early:
        bad.append(f"ASHA stopped no trial before max_t: {steps}")
    if res["best"]["steps"] != spec["max_t"]:
        bad.append(f"the best trial ran {res['best']['steps']} steps, not "
                   f"max_t {spec['max_t']}")
    out.update(
        trials={tag: {k: tr[k] for k in (
            "state", "steps", "losses", "boot_s", "boot_parts",
            "actor_to_first_report_s",
            "step_ms", "step_ms_p50", "peak_gb", "devices", "plain_calls")
            if k in tr} for tag, tr in trials.items()},
        steps_per_trial=steps, stopped_early=stopped_early,
        boot_s={tag: tr["boot_s"] for tag, tr in trials.items()},
        step_ms_p50_shared={tag: tr.get("step_ms_p50")
                            for tag, tr in trials.items()
                            if "planted" not in tag},
        peak_gb={tag: tr["peak_gb"] for tag, tr in trials.items()},
        head_lines=head_lines[-20:], phase_s=time.perf_counter() - t_phase,
        gates_failed=bad)
    emit(out)
    if bad:
        raise AssertionError(f"tune: {bad}")
    return by_path


# ---------------------------------------------------------------- data

# The data phase: the slice's data plane on the training and inference
# paths. (a) TorchTrainer (world 1, NCCL) reads a Dataset through
# iter_cuda_batches: a seeded int32 token matrix [8 x DATA_STEPS, 1025]
# (GPT-2's vocabulary) in 8 blocks, cut into tokens and next-token
# targets by map_batches, shuffled with seed 0; the rank takes the train
# phase's steps from seed 0. (b) A BatchPredictor scores the unshuffled
# rows (blocks of 16) on a pool of two card actors. One cluster serves
# both.
DATA_STEPS = 6          # the trainer's steps: one warm-up, five timed
DATA_VOCAB = 50257
DATA_BLOCKS = 8
DATA_PRED_BLOCK = 16    # rows per block of the predictor's dataset
DATA_POOL = dict(min_size=1, max_size=2, resources={"GPU": 0.5})
DATA_PLANTED_STEPS = 2  # steps of the planted seed-1 shuffle
FLASH_PER_BATCH = {"flash_fwd": 12, "flash_delta": 0, "flash_dq": 0,
                   "flash_dkv": 0}
DATA_DEVICE = None      # the predictor's device: cuda, its default


def data_cut(b):
    """A row of S + 1 tokens → ``tokens`` and next-token ``targets``."""
    return {"tokens": b["data"][:, :-1], "targets": b["data"][:, 1:]}


def data_rows():
    rng = np.random.default_rng(0)
    return rng.integers(0, DATA_VOCAB, (TRAIN_B * DATA_STEPS, TRAIN_S + 1)
                        ).astype(np.int32)


def data_dataset(shuffle=0, blocks=DATA_BLOCKS):
    from ray_tpu_torch import data as rd

    ds = rd.from_numpy(data_rows(), parallelism=blocks).map_batches(data_cut)
    return ds if shuffle is None else ds.random_shuffle(seed=shuffle)


def batch_digest(tokens, targets) -> str:
    """sha256 of a batch's int64 bytes (numpy arrays or tensors)."""
    h = hashlib.sha256()
    for x in (tokens, targets):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        h.update(np.ascontiguousarray(x, dtype=np.int64).tobytes())
    return h.hexdigest()


FLASH_PLAIN = ("reference_flash_fwd", "reference_flash_delta",
               "reference_flash_dq", "reference_flash_dkv")


def count_plain_calls():
    """Wrap the flash kernels' plain versions to count their calls →
    the live counts (a dict)."""
    return counted_calls(fa, FLASH_PLAIN)[0]


def data_loop(config):
    """The data phase's rank: the train phase's step (gpt2_124m, S 1024,
    bf16 over fp32 params, remat, flash, adamw; seed 0) on a world-1
    process mesh, fed by its dataset shard's iter_cuda_batches; each
    step's loss, wall, flash launches (zeroed just before it), the
    devices and pinning of its tensors and its batch digest, then the
    feeder's counters."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train import session

    started = time.time()
    plain = count_plain_calls()
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1))
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, remat=True,
                                  attn_impl="flash")
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen,
                                             process_mesh=mesh)
    feed = session.get_dataset_shard("train").iter_cuda_batches(
        batch_size=TRAIN_B, dtype=torch.int64, prefetch=2,
        device=session.get_device())
    steps = []
    for batch in feed:
        toks, tg = batch["tokens"], batch["targets"]
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, (toks, tg))
        loss = float(loss)                      # synchronizes
        steps.append({"loss": loss,
                      "step_ms": (time.perf_counter() - t0) * 1e3,
                      "launches": flash_counts(),
                      "devices": sorted({str(toks.device), str(tg.device)}),
                      "dtypes": sorted({str(toks.dtype), str(tg.dtype)}),
                      "digest": batch_digest(toks, tg)})
    session.report({"steps": steps, "feed": feed.stats(),
                    "plain_calls": dict(plain), "loop_started": started,
                    "device": str(mesh.device), "backend": mesh.backend})


class GPTScorer(Predictor):
    """Each row's mean next-token log-likelihood under gpt2_124m (bf16
    over fp32 params, flash attention) on the card, one forward per
    batch under inference mode. Beside each score it returns what the
    gates read, for the batch: its flash launches (zeroed just before
    the forward), the plain versions' calls so far, the device ms of the
    forward, and the process's pid and model builds."""

    builds = 0

    def __init__(self, cfg, params, device):
        self.cfg, self.params, self.device = cfg, params, device
        self.plain = count_plain_calls()
        self.built_at = time.time()

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs):
        from ray_tpu_torch._device import resolve_device

        dev = resolve_device(kwargs.get("device"))
        cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, attn_impl="flash")
        params = {k: v.to(dev) for k, v in checkpoint.to_params().items()}
        GPTScorer.builds += 1
        return cls(cfg, params, dev)

    def predict_batch(self, batch):
        tokens = torch.from_numpy(np.asarray(batch["tokens"], np.int64))
        targets = torch.from_numpy(np.asarray(batch["targets"], np.int64))
        on_card = self.device.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        fa.reset_launch_counts()
        with torch.inference_mode():
            tokens, targets = tokens.to(self.device), targets.to(self.device)
            t0 = time.perf_counter()
            if on_card:
                start.record()
            logits = gpt.forward(self.params, tokens, self.cfg)
            gold = logits.gather(-1, targets[..., None])[..., 0]
            score = (gold - logits.logsumexp(-1)).mean(-1)
            if on_card:
                end.record()
            score = score.cpu().numpy()
        ms = (start.elapsed_time(end) if on_card
              else (time.perf_counter() - t0) * 1e3)
        n = len(score)
        launches = flash_counts()
        return {"score": score,
                "launches": np.array([[launches[k] for k in FLASH_PER_BATCH]]
                                     * n),
                "plain": np.full(n, sum(self.plain.values())),
                "device_ms": np.full(n, ms),
                "pid": np.full(n, os.getpid()),
                "builds": np.full(n, GPTScorer.builds),
                "built_at": np.full(n, self.built_at),
                "on_card": np.full(n, on_card)}


def in_process_scores(scorer, ds):
    """``scorer``'s scores over ``ds``'s blocks cut into TRAIN_B-row
    batches, as map_batches cuts them in the pool."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import block as B

    out = []
    for ref in ds._materialized_refs():
        blk = rt.get(ref, timeout=300)
        n = B.num_rows(blk)
        for s in range(0, n, TRAIN_B):
            out.append(scorer.predict_batch(B.to_batch(
                B.slice_block(blk, s, min(s + TRAIN_B, n))))["score"])
    return np.concatenate(out)


def single_controller_losses(device, batches):
    """The train phase's step from seed 0 in this process over
    ``batches`` (numpy tokens, targets) → the losses."""
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, remat=True,
                                  attn_impl="flash")
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, device)
    losses = []
    for toks, tg in batches:
        batch = tuple(torch.from_numpy(np.asarray(x, np.int64)).to(device)
                      for x in (toks, tg))
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    del params, opt_state
    torch.cuda.empty_cache()
    return losses


def phase_data(device, train_run):
    """The data plane on the card: (a) TorchTrainer fed by a Dataset
    through iter_cuda_batches, held bitwise to a single-controller loop
    over the batches this process's own iter_batches yields; (b) a
    BatchPredictor on a pool of two card actors, held bitwise to the
    same forward here. ``train_run``: the train phase's (losses, step
    p50 ms), or None."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.air import BatchPredictor, Checkpoint
    from ray_tpu_torch.data import ActorPoolStrategy
    from ray_tpu_torch.train import (ScalingConfig, TorchBackendConfig,
                                     TorchTrainer)

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"phase": "data", "card": card_line(),
           "config": f"gpt2_124m bf16 remat flash B={TRAIN_B} S={TRAIN_S} "
           "adamw(3e-4, wd=0.1, mu bf16), seed 0; dataset "
           f"[{TRAIN_B * DATA_STEPS}, {TRAIN_S + 1}] int32 vocab "
           f"{DATA_VOCAB} in {DATA_BLOCKS} blocks, map_batches cut, "
           "random_shuffle(seed=0)",
           "train_phase_step_ms_p50": None if train_run is None
           else train_run[1]}
    bad, by_path = [], {}
    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        # (a) the trainer fed by the dataset
        ds = data_dataset(shuffle=0)
        t0 = time.time()
        result = TorchTrainer(
            data_loop, scaling_config=ScalingConfig(num_workers=1,
                                                    use_gpu=True),
            backend_config=TorchBackendConfig(),
            datasets={"train": ds}).fit(timeout=600)
        out["trainer_fit_s"] = time.time() - t0
        run = result.metrics_history[-1]
        out["rank_boot_s"] = run["loop_started"] - t0
        ref = [(b["tokens"], b["targets"])
               for b in ds.iter_batches(batch_size=TRAIN_B)]
        # (b) the predictor on the pool, on the same cluster
        gen = torch.Generator(device=device).manual_seed(0)
        cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, attn_impl="flash")
        ckpt = Checkpoint.from_params(gpt.init_params(cfg, gen, device))
        pred_ds = data_dataset(shuffle=None, blocks=len(data_rows())
                               // DATA_PRED_BLOCK)
        bp = BatchPredictor.from_checkpoint(ckpt, GPTScorer,
                                            device=DATA_DEVICE)
        t0 = time.time()
        rows = bp.predict(pred_ds, batch_size=TRAIN_B, compute=(
            ActorPoolStrategy(**DATA_POOL))).take_all()
        pred_wall = time.time() - t0
        t_boot = t0
        ref_scorer = GPTScorer.from_checkpoint(ckpt, device=DATA_DEVICE)
        ref_scores = in_process_scores(ref_scorer, pred_ds)
        planted_ref = [(b["tokens"], b["targets"]) for b in data_dataset(
            shuffle=1).iter_batches(batch_size=TRAIN_B)]
    finally:
        rt.shutdown()
    del ref_scorer
    torch.cuda.empty_cache()

    # (a)'s gates
    steps = run["steps"]
    losses = [st["loss"] for st in steps]
    ref_losses = single_controller_losses(device, ref)
    planted = single_controller_losses(device,
                                       planted_ref[:DATA_PLANTED_STEPS])
    digests = [st["digest"] for st in steps]
    ref_digests = [batch_digest(*b) for b in ref]
    feed = run["feed"]
    timed = [st["step_ms"] for st in steps[1:]]
    out["trainer"] = {
        "device": run["device"], "backend": run["backend"],
        "steps": len(steps), "losses": losses,
        "reference_losses": ref_losses,
        "bitwise_equal_single_controller": losses == ref_losses,
        "batch_digests_equal": digests == ref_digests,
        "planted_seed1_losses": planted,
        "planted_seed1_equal": planted == losses[:len(planted)],
        "planted_seed1_digests_equal": [batch_digest(*b) for b in planted_ref]
        == ref_digests,
        "step_ms": [st["step_ms"] for st in steps],
        "step_ms_p50": float(np.median(timed)) if timed else None,
        "tensor_devices": sorted({d for st in steps for d in st["devices"]}),
        "tensor_dtypes": sorted({d for st in steps for d in st["dtypes"]}),
        "launches_per_step": [st["launches"] for st in steps],
        "plain_calls": run["plain_calls"], "feed": feed,
        "feed_wait_ms_per_batch": feed["wait_s"] * 1e3
        / max(1, feed["batches"]),
        "h2d_gb_s": feed.get("h2d_gb_s")}
    tr = out["trainer"]
    if len(steps) != DATA_STEPS:
        bad.append(f"trainer: {len(steps)} steps, expected {DATA_STEPS}")
    if not tr["batch_digests_equal"]:
        bad.append("trainer: the rank's batches are not the driver's "
                   "iter_batches batches")
    if not tr["bitwise_equal_single_controller"]:
        bad.append(f"trainer: losses {losses} are not the single "
                   f"controller's {ref_losses}")
    if tr["planted_seed1_equal"] or tr["planted_seed1_digests_equal"]:
        bad.append("trainer: the planted seed-1 shuffle passes the bitwise "
                   "gate")
    if tr["tensor_devices"] != ["cuda:0"] or tr["tensor_dtypes"] != [
            "torch.int64"]:
        bad.append(f"trainer: tensors on {tr['tensor_devices']} as "
                   f"{tr['tensor_dtypes']}")
    if not (feed["copies"] == 2 * DATA_STEPS
            and feed["pinned_copies"] == feed["copies"]):
        bad.append(f"trainer: the feeder's copies {feed}")
    if any(ls != FLASH_PER_STEP for ls in tr["launches_per_step"]):
        bad.append(f"trainer: flash launches per step "
                   f"{tr['launches_per_step']}, expected {FLASH_PER_STEP}")
    if any(run["plain_calls"].values()):
        bad.append(f"trainer: plain versions ran {run['plain_calls']}")
    by_path["data (trainer rank)"] = {
        k: sum(ls[k] for ls in tr["launches_per_step"])
        for k in FLASH_PER_STEP}

    # (b)'s gates
    scores = np.array([r["score"] for r in rows], dtype=np.float32)
    pids = sorted({int(r["pid"]) for r in rows})
    per_actor = {p: [r for r in rows if int(r["pid"]) == p] for p in pids}
    batches = [[int(x) for x in r["launches"]] for r in rows][::TRAIN_B]
    out["predictor"] = {
        "rows": len(rows), "actors": len(pids),
        "bitwise_equal_in_process": scores.tobytes() == ref_scores.tobytes(),
        "score_mean": float(scores.mean()),
        "max_abs_diff_in_process": float(np.abs(scores - ref_scores).max()),
        "builds_per_actor": {p: max(int(r["builds"]) for r in rs)
                             for p, rs in per_actor.items()},
        "rows_per_actor": {p: len(rs) for p, rs in per_actor.items()},
        "actor_boot_s": {p: min(float(r["built_at"]) for r in rs) - t_boot
                         for p, rs in per_actor.items()},
        "launches_per_batch": batches,
        "plain_calls": max(int(r["plain"]) for r in rows),
        "on_card": all(bool(r["on_card"]) for r in rows),
        "device_ms_per_batch": [float(r["device_ms"]) for r in rows
                                ][::TRAIN_B],
        "predict_wall_s": pred_wall, "rows_per_s": len(rows) / pred_wall,
        "rows_per_device_s": len(rows) / (sum(float(r["device_ms"])
                                              for r in rows[::TRAIN_B]) / 1e3)}
    pr = out["predictor"]
    pr["device_ms_per_batch_p50"] = float(np.median(
        pr["device_ms_per_batch"]))
    if not pr["bitwise_equal_in_process"] or len(rows) != len(ref_scores):
        bad.append(f"predictor: scores differ from the in-process forward "
                   f"by {pr['max_abs_diff_in_process']}")
    if any(b != 1 for b in pr["builds_per_actor"].values()):
        bad.append(f"predictor: builds per actor {pr['builds_per_actor']}")
    want = [FLASH_PER_BATCH[k] for k in FLASH_PER_BATCH]
    if any(b != want for b in batches) or pr["plain_calls"] \
            or not pr["on_card"]:
        bad.append(f"predictor: launches per batch {batches}, plain calls "
                   f"{pr['plain_calls']}, on the card {pr['on_card']}")
    by_path["data (predictor actors)"] = {
        k: sum(b[i] for b in batches) for i, k in enumerate(FLASH_PER_BATCH)}
    out["phase_s"] = time.perf_counter() - t_phase
    out["gates_failed"] = bad
    emit(out)
    if bad:
        raise AssertionError(f"data: {bad}")
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases: kernels,programs,profile,"
                         "engine,engine_prefix,engine_spec,engine_dense,"
                         "engine_oneshot,engine_drain,engine_warmup,"
                         "engine_observe,engine_edge,engine_tp,engine_kv,"
                         "engine_gptj,runtime,serve,serve_chaos,"
                         "autoscaler,train,train_ring,"
                         "train_llama,train_gpt2_2_7b,train_gptj_6b,"
                         "train_moe,"
                         "train_pipeline,train_dist,tune,data "
                         "(default: all; "
                         "the build always runs)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills)")
    ap.add_argument("--ab", metavar="OLD_CHECKOUT", default="",
                    help="also time the flash forward, delta, dq, dkv and "
                         "paged "
                         "prefill and decode kernels against an older "
                         "checkout's (its ray_tpu_torch/ops/csrc, built "
                         "into build/ab), in turns old, new, new, old")
    ap.add_argument("--warmup-child", choices=("on", "off"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tune-driver", metavar="SPEC", default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--autoscaler-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    only = set(filter(None, args.only.split(",")))
    want = lambda p: not only or p in only
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.warmup_child:
        return warmup_child_main(args.warmup_child)
    if args.tune_driver:
        return tune_driver_main(args.tune_driver)
    if args.autoscaler_child:
        return autoscaler_child_main()

    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.build(verbose=args.ptxas)
    _build.library()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "sources": [str(p.relative_to(_build.REPO_ROOT))
                      for p in _build.sources()],
          "arch": "sm_90a", "sass_ops": sass_ops(_build.LIB_PATH)})

    meta = {
        "paged_attention": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                            "ray_tpu/ops/paged_attention.py:55"),
        "paged_prefill_attention": ("ray_tpu_torch/ops/csrc/paged_prefill.cu",
                                    "ray_tpu/ops/paged_attention.py:206"),
        "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                      "ray_tpu/ops/attention.py:67"),
        # No Pallas kernel: the jnp delta of _bwd_impl, which XLA fuses.
        "flash_delta": ("ray_tpu_torch/ops/csrc/flash_delta.cu",
                        "ray_tpu/ops/attention.py:277"),
        "flash_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                     "ray_tpu/ops/attention.py:182"),
        "flash_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                      "ray_tpu/ops/attention.py:224"),
        # The int8 programs of the two paged kernels (quantized=True there).
        "paged_attention_int8": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                                 "ray_tpu/ops/paged_attention.py:55"),
        "paged_prefill_attention_int8": (
            "ray_tpu_torch/ops/csrc/paged_prefill.cu",
            "ray_tpu/ops/paged_attention.py:206"),
    }
    errs = dict.fromkeys(meta, 0.0)
    timings, launches, at_shapes = {}, {}, {}
    if want("kernels"):
        timings.update(phase_kernels(device, errs, at_shapes))
        timings.update(phase_flash_kernels(device, errs, at_shapes))
    if args.ab:
        phase_ab(device, args.ab)
    if want("engine_warmup"):
        # Fresh processes, before this one holds the engine's pools.
        children = warmup_children()
    # Launches of each serving path, each read from its own run (every
    # run zeroes every count just before it): the kernels line's
    # ``launches`` are the main path's (the float engine for the float
    # programs, the int8 engine for the int8 ones); ``launches_by_path``
    # adds the prefix-cache and speculative paths.
    by_path: dict = {}
    streams = float_run = None
    serving = ("programs", "profile", "engine", "engine_prefix",
               "engine_spec", "engine_dense", "engine_oneshot",
               "engine_drain", "engine_warmup", "engine_observe",
               "engine_edge", "engine_tp", "engine_kv")
    if any(want(p) for p in serving):
        cfg, masters, params = make_params(device)
        if want("programs"):
            phase_programs(device, cfg, params)
            phase_programs_int8(device, cfg, masters, params)
            phase_programs_prefix(device, cfg, params)
            phase_programs_oneshot(device, cfg, masters, params)
        if want("profile"):
            phase_profile(device, cfg, masters, params)
        if want("engine_warmup"):
            phase_engine_warmup(device, cfg, params, children, build_s)
        if want("engine"):
            counts, float_run, streams = phase_engine(device, cfg, params)
            by_path["engine"] = counts
            launches.update({k: counts[k] for k in (
                "paged_attention", "paged_prefill_attention")})
            counts = phase_engine_int8(device, cfg, masters, float_run,
                                       streams)
            by_path["engine_int8"] = counts
            launches.update({k: counts[k] for k in (
                "paged_attention_int8", "paged_prefill_attention_int8")})
        if want("engine_prefix"):
            by_path["engine_prefix (warm round)"] = phase_engine_prefix(
                device, cfg, params)
        if want("engine_spec"):
            by_path.update({f"engine_spec ({arm})": c for arm, c in
                            phase_engine_spec(device, cfg, params,
                                              streams).items()})
        if want("engine_dense"):
            phase_engine_dense(device, cfg, params, streams)
        if want("engine_oneshot"):
            by_path.update({f"engine_oneshot ({arm})": c for arm, c in
                            phase_engine_oneshot(device, cfg, params,
                                                 masters).items()})
        if want("engine_drain"):
            phase_engine_drain(device, cfg, params)
        if want("engine_observe"):
            by_path["engine_observe"] = phase_engine_observe(
                device, cfg, params, float_run)
        if want("engine_edge"):
            by_path.update({f"engine_edge ({arm})": c for arm, c in
                            phase_engine_edge(device, cfg, params).items()})
        if want("engine_tp"):
            by_path.update(phase_engine_tp(device, cfg, params, masters))
        if want("engine_kv"):
            by_path.update(phase_engine_kv(device, cfg, params))
        del cfg, masters, params
        torch.cuda.empty_cache()
    if want("engine_gptj"):
        (by_path["engine_gptj"],
         by_path["engine_gptj (ps 48)"]) = (
            phase_engine_gptj(device))
    if want("runtime"):
        by_path["runtime (actor)"] = phase_runtime(
            device, None if streams is None else (float_run, streams))
    serve_parts = tuple(p for p in ("serve", "serve_chaos") if want(p))
    if serve_parts:
        by_path.update(phase_serve(
            device, None if streams is None else (float_run, streams),
            serve_parts))
    beside = want("autoscaler") and any(want(p) for p in TRAIN_ONE_CARD)
    if want("autoscaler") and not beside:
        by_path.update(phase_autoscaler(device))
    train_run = None
    if want("train"):
        counts, train_run = phase_train(device)
        launches.update(counts)
    child = start_autoscaler_child() if beside else None
    try:
        for name, phase in (("train_ring", phase_train_ring),
                            ("train_llama", phase_train_llama),
                            ("train_gpt2_2_7b", phase_train_gpt2_2_7b),
                            ("train_gptj_6b", phase_train_gptj_6b),
                            ("train_moe", phase_train_moe),
                            ("train_pipeline", phase_train_pipeline)):
            if want(name):
                by_path[name], shapes = phase(device, errs)
                at_shapes.update(shapes)
    except BaseException:
        if child is not None:   # it tears its own cluster down
            with contextlib.suppress(Exception):
                join_autoscaler_child(child)
        raise
    if child is not None:
        by_path.update(join_autoscaler_child(child))
    if want("train_dist"):
        paths, shapes = phase_train_dist(device, errs)
        by_path.update(paths)
        at_shapes.update(shapes)
    if want("tune"):
        by_path.update(phase_tune(device, train_run))
    if want("data"):
        by_path.update(phase_data(device, train_run))

    kernels = []
    for name, (src, replaces) in meta.items():
        if name not in timings or name not in launches:
            continue
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            **({"replaces_note": "no Pallas kernel: jnp ops XLA fuses"}
               if name == "flash_delta" else {}),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("library_covers", "covered_ms",
                                 "library_see") if k in t}})
        shard = timings.get(f"{name} tp_shard")
        if shard is not None:
            kernels[-1]["tp_shard"] = {k: shard[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        if paths:
            kernels[-1]["launches_by_path"] = paths
        shapes = {tag: {k: t[name][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                  for tag, t in at_shapes.items() if name in t}
        if shapes:
            kernels[-1]["at_shapes"] = shapes
    if kernels:
        print(json.dumps({"kernels": kernels}), flush=True)
        RECORD["kernels"] = kernels
    if not only and len(kernels) != len(meta):
        raise AssertionError(f"kernels line has {len(kernels)} entries")
    os.makedirs(os.path.dirname(RECORD_PATH), exist_ok=True)
    with open(RECORD_PATH, "w") as f:
        json.dump(RECORD, f, indent=1)
    if only:
        return 0   # a partial run never prints the success line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
