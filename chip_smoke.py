"""Drive the PyTorch + CUDA port of moe_infinity_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device and build: needs a CUDA device, prints the card's name and power
   limit, builds every kernel from ``moe_infinity_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the shapes
   of the NLLB-MoE-54B, Mixtral-8x7B and DeepSeek-V2-Lite paths, with the
   error, its tolerance and the times of the kernel, the plain version and
   one library call for the same function; K4 and K1 also at long rows
   (8192 columns), the decode body at the edges of its split plan, K2's
   few-row route with every bias form, and K3 at the edges of its 64-row
   chunks and 64-deep k-tiles, at one k-split and at several, and at
   Mixtral's 16-wide chunk step, each with the plan it took; on Mixtral's
   down calls, where K3's error comes from (``[rounding]``); K1 with its
   split plan from the cache's capacity (as the NLLB decoder calls it)
   against the plan from the live keys, at capacities 32 and 1024; K2 at
   head dim 64 in the three shapes of Switch-large-128's path (the encoder's
   T5 and pad bias ``[B, 16, T, T]`` at T = 16 and 64, the decoder's T5
   bias ``[1, 16, 1, 128]``, cross-attention's pad bias ``[B, 1, 1, 16]``,
   B = 32, scale 1.0, bf16 and f32) and every few-row bias form; K1 and K4
   at head dim 64 with the split plan's edges; K3 at Switch's int4 decode
   and prefill shapes; and queue-3 fault F1 repaired: a graph of a split K3
   call replayed after a later capture's warm-up grew the capture stream's
   split scratch and the caches were emptied equals the eager call, with
   every ticket counter at 0; K3's e4m3 kind (float8_e4m3fn weights) at
   Grok-1's batch-1 and W=8 MoE layers and Arctic's batch-1 layer (its row
   ``gmm_fp8``), and K1, K2 (both bodies) and K4 at Grok-1's rep 6 with its
   softcap 30 and score scale and at Arctic's rep 7, bf16 and f32, timed
   beside SDPA for rep 7; and K1, K2 (the few-row route and the tiled
   kernels) and K4 on the zero-padded instances (``flash_attention_pad128.cu``
   and ``pad256.cu``)
   and on row groups: OPT-2.7B's decode (B = 4 and 8, H = 32, head dim 80)
   and prefill (T = 32, causal), head dim 256, head dim 97 (rows of no
   multiple of 16 bytes) and rep 16 (64 heads over 4 at 128), bf16 and f32,
   timed beside SDPA in bf16, each launch under its instance's name; K3 over
   the pre-tiled weight layout ``[S, F/tf, D, tf]`` (``pack_tiled``, JAX's
   default pool) at V2-Lite's decode layer in bf16 (group offsets 0 and 128,
   f32 rows), int8 and e4m3, in the default slabs and in slabs of 352 that a
   column tile straddles, and at a 512-row prefill, each call bit-equal to
   the flat call and held to the plain version, the layer timed over both
   layouts (row ``gmm_tiled``); K5's zero-padded instance (``mla_pad.cu``)
   at (R, P) = (128, 32), (256, 32) with 40 heads, (256, 64), (384, 64) and
   (512, 20) (rope rows copied by element), bf16 and f32, timed beside SDPA
   (row ``mla_flash_decode_pad``);
3. the seq2seq main path: NLLB-MoE-54B geometry (d_model 2048, 16 heads,
   FFN 8192, 128 experts top-2, every 4th block sparse, vocab 256,206) with
   random weights from a seed, bf16 compute, packed int4 experts, resident
   on the card, ``Seq2SeqGenerator.generate`` answering 4 padded requests
   with 16 greedy tokens each (K1, K2 and K3 must each launch), first
   eagerly (``graphs=False``, for comparison), then the main path, each
   decode step one replay of a CUDA graph (one capture, a replay per step,
   tokens equal to the eager run's); each prints tokens/s, decode ms per
   token, the host's ms per step, the profiled busy share and peak memory;
4. its whole-path check: at full width and 2+2 blocks, the first decode
   step's logits through the kernels against the plain versions on the card;
5. the decoder-only main path: Mixtral-8x7B (``bench.py``'s
   ``MIXTRAL_8X7B_SPEC``: d_model 4096, 32 layers, 32 heads over 8 KV heads,
   FFN 14336, 8 experts top-2, vocab 32,000) at full width and depth, bf16
   compute, int8 experts made on the card from a seed, served by
   ``ContinuousBatcher`` over the paged KV cache: 8 requests submitted
   together into 4 slots, 16 greedy tokens each (K4, K2 and K3 must each
   launch); request 1 again alone through ``Generator`` (K1, K2, K3);
6. its whole-path check: at full width and 2 layers, a 16-wide chunk step
   and a one-token step over paged caches with holes, logits through the
   kernels against the plain versions on the card (f32 on three seeds,
   bf16 on one);
7. the MLA main path: DeepSeek-V2-Lite (``bench.py``'s ``DSV2_LITE_SPEC``:
   d_model 2048, 27 layers, 16 heads, latent 512 + rope key 64, 64 routed
   experts top-6 of FFN 1408 plus 2 shared experts, the first layer dense,
   vocab 102,400, untied embeddings) at full width and depth, bf16 compute,
   bf16 experts made on the card from a seed, served by ``ContinuousBatcher``
   with phase 5's traffic, then request 1 alone through ``Generator``, then
   through ``FusedRunner`` (prefill and a 15-token ``decode`` over the
   stacked expert pool, K3 at group offsets above 0); K5 and K3 must launch
   on each of the three, K5 27 times per one-token step; then (7b) the pool
   rebuilt, role by role, in the pre-tiled layout JAX's ``stack_experts``
   builds by default, and the same request through ``FusedRunner`` over it:
   prefill logits bit-equal to the flat pool's and tokens equal, K3 held to
   3 x 26 ``gmm_tiled`` launches a forward;
8. its whole-path check: at full width and 1 dense + 2 MoE layers, the
   same two steps over paged caches with holes, logits through the kernels
   against the plain versions (f32 on three seeds, bf16 on one), and once
   more with ``fold_mla_params`` applied;
9. the offload main path: NLLB-MoE-54B at full width and depth served by
   the per-layer ``Seq2SeqOffloadEngine``: bf16 dense weights from a seed
   (``init_random(with_experts=False)``), ``bench.py``'s int4 store
   (``SyntheticStore``, records distinct per expert, 1,536 of 16.86 MB), a
   page-locked tier of 14 GiB made on the card (all decoder records and
   part of the first encoder layer), a slot arena sized as ``bench.py``
   sizes it at ``--hbm-gb 13`` (388 slots, a quarter of the experts), the
   EAMC tracer and predictor, prefetch (lookahead 3, budget 8), the
   ``priority`` policy and 4 fetch workers; phase 3's 4 requests x 16
   greedy tokens after one warm-up generate, then a profile of one decode
   step on the device (copies against kernels) and on the host (cProfile);
   K1, K2 and K3 must launch, and evictions and both fetch paths must occur;
10. its whole-path check: f32 at full width and 4+4 blocks (every 2nd
   sparse), an arena of 128 slots, against the resident ``Seq2SeqGenerator``
   over the same store's records (``ResidentProvider.from_store``): greedy
   tokens equal and first-step logits within the tolerance, on two seeds,
   the second with the decoder records in a tier copied from the store (the
   whole run takes the second alone, for its time limit; ``--offload``
   both);
11. the offload main path at ``bench.py``'s defaults: phase 9's build served
   by the speculative engine (``speculative=True``, ``spec_block=4``, route
   margin 2): blocks of up to 4 greedy steps on the device with no host
   read inside, verified once per dispatch and replayed on a miss; first
   eagerly (``graphs=False``, for comparison), then the main path, each
   step and block a replay of its CUDA graph, each on a new arena: one
   warm-up generate with every dispatch (every replay, with graphs) under
   ``torch.cuda.set_sync_debug_mode("error")``, the timed generate (tokens
   equal between the two), then a profile of one block on the device and
   on the host; K1, K2 and K3 must launch 24, 24 and 12 times per executed
   decoder step (replays and the warm-ups of captures) plus one encode's,
   every execution of the graph run must be a replay, evictions must occur
   and some block must run more than once;
12. its whole-path check: phase 10's set-up through the speculative engine
   at k=1 and at k=4 in both ``MOE_SPEC_BLOCK_MODE`` modes, on both seeds
   (the whole run: phase 10's second),
   8 tokens (cut from 24, then 16, for the whole run's time limit), with graphs
   and eagerly: greedy tokens equal to the resident
   path's, the first accepted step's logits within the tolerance, at k=1
   every accepted step's f32 logits equal between graph and eager (and the
   resident generator's likewise), and in bf16 graph and eager tokens
   equal at k = 1, 2 and 4 in both block modes; some step or block must
   run more than once;
13. Switch-large-128 (``bench.py``'s ``SWITCH_LARGE_128_SPEC``: d_model
   1024, 16 heads of d_kv 64, d_ff 4096, 24+24 blocks with every second
   sparse, 128 experts top-1 at capacity 64, the T5 relative bias, vocab
   32,128, tied embeddings) resident at full width and depth: all 3,072
   packed int4 experts made on the card, ``Seq2SeqGenerator`` with
   impl="pallas" answering bench.py's 32 prompts of 16 with 64 greedy
   tokens each, eagerly, then each step a graph replay; tokens/s against
   the reference's 69.105 at batch 32; K2 (head dim 64) and K3 launches
   held to 24 and 24 per encode, 48 and 24 per step;
14. Switch-large-128 as ``bench.py``'s ``switch-servable`` preset builds it
   (its int4 store, a 14 GiB layer-aligned page-locked tier, slots from
   ``--hbm-gb 13``, the speculative engine at ``spec_block=4``) with graphs,
   the same requests; launches held as in phase 11;
15. its whole-path check at f32, full width and 4+4 blocks: the per-layer
   and speculative (k = 1, 4) offload paths bit-equal to the resident path
   (first-step logits, greedy tokens), graph logits bit-equal to eager over
   24 steps; at bf16 the first step through the kernels against the plain
   versions, reported;
16. Mixtral-8x7B at full width and depth through the decoder-only
   ``OffloadEngine`` as ``bench.py``'s ``mixtral-offload`` preset builds it
   (bf16 dense weights, the int8 store's shared record, the ``priority``
   policy, 4 workers, lookahead 3, prefetch budget 4, ``speculative=True``,
   ``spec_block=2``; one prompt of 16, 64 tokens at a capacity of 128): at
   the preset's ``--hbm-gb 13`` (60 slots, fewer than one step routes: the
   engine leaves speculation and serves per layer), then at 152 slots
   eagerly and as graphs; s/token against the reference's 0.735, hit
   rate, executions per block, host ms per execution, graphs, peak
   memory; K1, K2 and K3 held to 32, 32 and 96 per step and prefill (the
   whole run takes 6 layers, each arena cut by the same share: 11 and 28
   slots, and 8 tokens, for its time limit; ``--mixtral-offload`` the full
   32 layers and 64 tokens);
17. its whole-path check at f32, full width and 3 layers: per-layer and
   speculative step (graph and eager) offload bit-equal to the resident
   path at every one of 25 steps, graph bit-equal to eager, blocks of 2
   in both modes equal in tokens; evictions at every MoE layer;
18. DeepSeek-V2-Lite at full width and 3 layers through the same engine,
   eagerly: per-layer and speculative offload bit-equal to the resident
   path at f32 (K5 held to 3 launches per executed step), and at bf16 the
   first decode step through the kernels against the plain versions,
   reported;
19. the user-facing entry point, ``MoE(checkpoint, config)``: a checkpoint of
   Mixtral-8x7B's published ``config.json`` (hidden 4096, 32 heads over 8
   KV heads, FFN 14336, 8 experts top-2, vocab 32,000, rope theta 1e6) cut
   to 2 layers, weights from a seed made on the card and written under
   HF's tensor names as sharded safetensors with an index (6.3 GB; the
   disk's free space is checked first and the files are deleted at the
   end), ingested by the port to int8 experts; the resident facade at its
   defaults (``max_batch_size`` 8: the continuous batcher; ``moe_impl`` and
   ``prefill_impl`` "pallas") serving 8 requests of 16 tokens, 16 new
   tokens each, submitted together (K4, K2, K3 must launch); a resident
   facade at ``max_batch_size`` 1 (``Generator``); the first decode step's
   logits through the kernels against the plain versions, held at f32
   compute (the same classes and store) and reported in bf16, argmax equal
   in both; then
   the offload facade (``dense_paging`` "off", a budget of 10 of the 16
   experts, speculative blocks of 2, graphs) answering the same 8 requests
   one at a time (K1, K2, K3 must launch), its greedy tokens equal to the
   ``Generator`` facade's request by request, a sampled request the same
   twice, temperature 0 greedy and ``logit_bias`` +100 forcing its token;
20. the OpenAI-compatible server over phase 19's offload facade, with a
   stand-in word-level tokenizer: /health, /v1/models, greedy completions
   equal to the decode of ``MoE.generate``, a sampled completion at the
   OpenAI defaults, ``n`` 2 with ``logprobs`` 3, a chat completion and the
   same streamed (its deltas joined equal the text), /metrics; every reply
   HTTP 200;
21. Grok-1 at its published widths (hpcai-tech/grok-1: hidden 6144, 48
   heads over 8 KV heads, FFN 32768, 8 experts top-2, vocab 131,072, the
   softcap and multipliers), bf16 dense weights and fp8 experts made on the
   card from a seed: 2 layers resident through ``Generator`` (a prompt of
   16, 32 tokens) and the batcher (8 requests, 8 slots), the first decode
   step's logits at f32 compute against the plain versions; 8 layers
   offloaded (64 fp8 records of 604 MB, one shared, 40 slots, speculative
   blocks of 2, eagerly and as graphs); at f32 and 2 layers the per-layer
   and speculative offload paths bit-equal to the resident path at every
   step over 16 distinct records in 10 slots, graphs bit-equal to eager;
22. Snowflake Arctic at its published widths (hidden 7168, 56 heads over 8,
   FFN 4864, 128 experts top-2, the parallel residual): 2 layers resident
   with fp8 experts (26.8 GB) through the batcher and ``Generator``; 4
   layers offloaded from an int8 store (per layer, then speculative blocks
   of 2 as graphs); at f32 the offload paths bit-equal to the resident one
   over 128 distinct int8 records, also with ``moe_layer_frequency`` 2
   (``dense_layer`` on the card);
23. ``MoE`` from a 1-layer checkpoint of Grok-1's published config (11.5
   GB of bf16 safetensors from a seed, deleted at the end), ingested to
   float8_e4m3fn experts: the resident facade and the offload facade at a
   budget of 5 of 8 experts (an arena of one layer's 8 slots, speculative
   blocks of 2, graphs), offload tokens equal to the resident ones;
24. the seq2seq continuous batcher on phase 3's build (run inside phase 3):
   ``Seq2SeqContinuousBatcher(max_batch_size=8)``, the facade's default, 12
   requests (sources of 64/48/40/24 tokens in turn, 8/12/16 new tokens in
   turn) submitted together, so that 4 join mid-flight as slots free;
   eagerly, then the shared decode step (per-row positions, ``row_offsets``)
   as one CUDA graph for the batcher's life (one capture, a replay per step,
   tokens equal to eager); then the same 12 through the wave batcher
   (``Seq2SeqDynamicBatcher``); tokens/s, steps, joins, host ms per step,
   peak memory; K1, K2 and K3 must launch;
25. the same 12 through the continuous batcher in offload mode on phase
   11's engine (run inside phase 11): each join encodes through the
   engine's per-layer path, each shared step is one speculative execution
   over the 388-slot arena, every execution a replay of one graph; hit
   rate, executions per step, tokens/s;
26. its whole-path check: f32, full width, 4+4 blocks (2+2 in the whole run,
   for its time limit) over phase 10's store
   (128 slots): 8 requests into 4 slots through the continuous batcher
   resident and in offload mode and the wave batcher, each request's greedy
   tokens equal to an isolated ``Seq2SeqGenerator``'s (slot reuse included),
   the first step's logits within the tolerance; the experts through the
   exact grouped FFN, eagerly (``F32_IMPL``: K3 rounds its activations to
   bf16, so batches of other rows than the isolated run's part its logits
   by ~1e-3 at f32);
27. Switch-large-128 on phase 13's build (run inside phase 13): bench.py's
   32 prompts of 16 into 8 slots of the continuous batcher, 32 tokens, as
   graphs (K2 at head dim 64 with the per-row T5 bias); then at f32 and 4+4
   blocks (``F32_IMPL``, eagerly), tokens equal to the isolated generator's;
28. Arctic on phase 22's 4-layer int8 offload build (run inside phase 22):
   ``ContinuousBatcher(arena=...)`` over 160 slots, 8 requests into 4 slots,
   ``prefill_chunk`` 1, 16 tokens, each step a speculative execution over
   the arena (K4, K3); hit rate, executions per step; then at f32 over phase
   22's 128 distinct records (E + 8 slots, ``prefill_chunk`` 4: K2), tokens
   equal to the resident batcher's;
29. Mixtral-8x7B on phase 5's build (run inside phase 5):
   ``SpeculativeDecoder(k=4)`` (prompt lookup) on a prompt that repeats a
   span, beside ``Generator``, and ``DynamicBatcher`` on 4 left-padded
   requests; acceptance rate and tokens/s in bf16; at f32 and 2 layers
   (``F32_IMPL``) both equal to ``Generator``'s tokens;
30. ``MoE`` from a checkpoint of google/switch-base-8's published
   ``config.json`` (d_model 768, d_ff 3072, 12 heads of d_kv 64, 12+12
   blocks with every second sparse, 8 experts, vocab 32,128), 1.24 GB of
   bf16 safetensors written from a seed under ``.switch_entry/`` (deleted
   at the end): at f32 the facade at its defaults (``max_batch_size`` 8: the
   continuous batcher), ``s2s_batcher="wave"`` and an offload facade with
   ``speculative_decode`` at half the experts' bytes (the batcher over the
   engine's arena), each answering 8 concurrent ``generate`` calls from
   threads with tokens equal to the ``max_batch_size`` 1 facade's; in bf16
   (K3) the default facade against the ``max_batch_size`` 1 one, reported.
   Phase 2 also holds the batchers' two new kernel inputs: K2 at head dim
   64 with a per-row T5 bias ``[B, 16, 1, 128]`` (B = 8 and 32, bf16 and
   f32, beside SDPA), and K1 at NLLB's B = 8, 16 heads with eight different
   per-row positions over a capacity of 64 (beside every row at the
   largest); and the port's own kernel ``stream_gather``
   (``csrc/stream.cu``, no Pallas counterpart) against its plain version on
   NLLB-MoE-54B's int4 record (6 roles, 16.86 MB) in a 128-record
   page-locked tier: U = 8 and 64 across segments with rows of -1 (zeros,
   nothing read), U = 13 with a segment on the card among pinned ones,
   every byte equal; its time and GB/s beside the host link's bound (the
   present rows' bytes over PCIe Gen5 x16) and a ``copy_`` per present
   record role on a copy engine, kernel and copies three times back to
   back;
31. stream decode (``Seq2SeqOffloadEngine(stream_decode=True)``) at
   NLLB-MoE-54B's full width and depth (24+24 blocks), built as bench.py
   builds its ``--stream`` leg: phase 9's weights and store, a 14 GiB
   layer-aligned page-locked tier (768 of 768 decoder records staged,
   required), an arena of ``max(E, min(slots, 2E))`` = 256 slots for the
   encoder; phase 3's 4 requests x 16 tokens at ``stream_unique`` 8 in
   blocks of k = 1 and 4, then bench.py's leg itself (``--spec-block 1
   --stream-unique 8``: 32 prompts of 16, 8 tokens), each eagerly and as
   graphs (one per (k, U)); tokens/s beside phase 11's, executions per
   block and token, U's path, host ms per step, the tier's GB read per
   step, peak memory; K1, K2, K3 and ``stream_gather`` held to their
   counts per executed step, every graph execution a replay, graph tokens
   equal to eager;
32. direct-tier layers on the same build: bench.py's ``--hbm-gb 13
   --direct-layers 2`` (the deepest two decoder MoE layers promoted to the
   card, 4.3 GB, 132 slots), then ``max_direct_layers=None`` (all 6, 12.9
   GB, 128 slots), each per layer and speculatively at k = 4 as graphs;
   hit rate, executions per block, tokens/s beside phase 11's; with every
   decoder layer direct, no decoder visit and every block accepted at its
   first dispatch (the whole run takes the two-layer plan at 8 tokens, for
   its time limit; ``--stream`` and ``--offload`` at 16);
33. their whole-path check at f32, full width, 4+4 blocks (2+2 in the whole
   run, for its time limit) over phase 10's
   store with the decoder records in a layer-aligned tier: stream decode
   (k = 1 and 4, U escalating from 2, graphs and eager) and direct layers
   (all and the deepest one; per layer, speculative k = 1 and 4, graphs and
   eager) bit-equal to the resident path in greedy tokens and first-step
   logits, graph logits against eager at every accepted k = 1 step;
34. OPT-66B at its published width (facebook/opt-66b: hidden 9216, FFN
   36864, 72 heads of 128, vocab 50,272, 2048 positions, ReLU, pre-norm),
   bf16, weights from a seed: (a) 8 distinct layers (16.3 GB) resident
   through ``ResidentStepper`` and ``Generator``, then copied to page-locked
   host memory and paged through ``PagedDenseEngine`` with 3 slots, 4
   left-padded requests x 16 greedy tokens: tokens equal, the prefill's
   logits bit-equal; (b) the full depth, 64 host layers aliasing the 8 (16.3
   GB of host memory, every step copies all 64 layers; 8 layers in the whole
   run, for its time limit, 64 with ``--paging``), paged with 4 slots
   at batch 1 and 8, 8 greedy tokens each (a copy-bound step of the same
   work each time; fewer steps keep the whole run well inside its time
   limit): tokens/s, s per token, GB copied per step, the dense
   hit rate, peak memory, the device's busy share; K1 and K2 must launch;
   phase 2 holds K1 at OPT-66B's decode (B = 1 and 8, rep 1) and K2 at its
   prefill against the plain versions, beside SDPA;
35. its whole-path check at f32, full width, 2 distinct layers in a stack of
   4 over 2 slots: the prefill's and a decode step's logits through the
   kernels against the plain versions, and paged against resident (logits
   bit-equal, tokens equal);
36. ``MoE`` from a checkpoint of OPT-66B's published ``config.json`` cut to
   4 layers (9.2 GB of bf16 safetensors from a seed under ``.opt_entry/``,
   deleted at the end): resident, then at a ``device_memory_bytes`` leaving
   2 dense slots, where ``dense_paging="auto"`` pages; 2 requests, tokens
   equal;
37. NLLB-MoE-54B at full width and depth on phase 9's build with its 48
   blocks paged through 16 slots and the experts offloaded (the per-layer
   engine with a ``DenseLayerArena``): phase 3's 4 requests x 16 tokens equal
   to phase 9's engine on the same build; the dense hit rate, GB of blocks
   copied, the landings the wrapped window makes and nothing reads, tokens/s;
38. the host fallback on the same build (an arena with its zero slot, the
   store read through the tier where it stages a record): at the default
   deadline (0.25 s) and phase 9's slots, ``host_exec_count`` and the tokens
   against phase 9's (held equal when no expert ran on the host in the
   timed run); with a slot for every expert, all warmed, tokens equal to
   phase 9's and no expert on the host; at a
   deadline of 0 with prefetch off, one request of 16 source tokens and 8
   new ones, every miss on the host (tokens/s, ``host_exec_count``, host ms
   per expert, the step's wait on the host), and the same with
   ``dequant_on_write`` (bf16 slots, no direct layer; phase 2 holds K3's
   bf16 kind at those slots' shapes); then NLLB at 2+2 blocks and
   Mixtral-8x7B at 2 layers (int8) with every expert on the host (fetch
   workers held back): the first step's logits within 1e-4 at f32 through
   the exact grouped FFN (Mixtral: the prefill's, and greedy tokens equal);
   in bf16 through K3, one MoE layer's output within 2e-2 of its scale, the
   first router row whose top-2 differ (or the combine weights' largest
   move) reported, and the logits within 2e-2 (NLLB as rtol = atol,
   Mixtral of their scale) when the host run replays the other run's
   routing;
39. ``MoE`` from a GPTQ checkpoint: Mixtral-8x7B's published ``config.json``
   cut to 2 layers with AutoGPTQ's v1 ``quantization_config`` (4 bits,
   groups of 128), every attention projection and expert linear packed on
   the card by the port's ``pack_gptq`` from a seed (router, embeddings,
   head and norms bf16) under ``.gptq_entry/`` (deleted at the end),
   ingested to int4 experts; 8 sampled store records byte-equal to
   ``dequant_gptq`` then ``quantize_rowwise`` on the host; K3's int4 kind at
   the batch-1 decode layer of the store's records against its plain
   version, timed; then phase 19's offload facade once per load mode
   (``mmap``, ``ram``, ``direct``, ``sched``), each answering phase 19's 8
   requests (the whole run's first 2, for its time limit; ``--loading``
   all 8): greedy tokens equal across the four, K1, K2 and K3 launched on
   each; ingest seconds, ``is_direct``, tokens/s, s/token and the escalated
   reads under ``sched``;
40. ``MoE`` from DeepSeek-V3's official block-fp8 layout at its published
   width (deepseek-ai/DeepSeek-V3's ``config.json``: hidden 7168, 128 heads,
   q_lora 1536, kv_lora 512, rope 64, 256 routed experts of 2048 top-8 in 8
   groups top-4, a shared expert, ``noaux_tc``; cut to 2 layers, the first
   dense): e4m3 codes plus ``weight_scale_inv`` at 128 x 128 for every
   attention projection, the dense MLP, the shared and the routed experts
   (15.8 GB from a seed under ``.dsv3_entry/``, deleted at the end),
   ingested to float8_e4m3fn experts; 8 sampled records byte-equal to
   ``dequant_fp8_block`` then ``quantize_rowwise``; K3's e4m3 kind at the
   batch-1 MoE layer (8 rows over 8 experts, D 7168, F 2048), timed; the
   resident facade (``Generator``, 4 requests of 16 tokens, 16 new each: K5
   at 128 heads on every layer of every one-token step, K3 e4m3 three times
   on every MoE layer call), the first decode step's logits through the
   kernels against the plain versions (f32 held, bf16 reported); then the
   offload facade at a budget of 160 of the 256 experts (the arena takes the
   256 slots of the one MoE layer), eagerly, under ``direct`` and ``mmap``
   with tokens equal;
41. ``decode_scan`` on the builds of phases 3 (NLLB-54B, through
   ``Seq2SeqGenerator.decode_scan``), 5 (Mixtral-8x7B) and 7
   (DeepSeek-V2-Lite, both through ``ResidentStepper.decode_scan`` after a
   prefill of 4 prompts of 16 into caches of 256 columns), each greedy at
   32 steps eagerly and as CUDA graphs of 8 steps: a warm-up call captures,
   the timed call replays under ``torch.cuda.set_sync_debug_mode("error")``
   (any host read raises), graph and eager bit-equal, one capture per block
   length and a replay per block; tokens against the per-step path's
   (NLLB's generate, whose graphed steps plan K1 from the same capacity:
   held; ``Generator``: reported with the per-step top-2 gap at a
   divergence); one sampled setting (temperature 0.8, top-p 0.9,
   repetition penalty 1.1): a seed twice equal, graph equal to eager, two
   seeds differ; ms per token and tokens/s of both loops, captures and
   replays; phase 2 times K5 at its rows under the capacity plan and the
   live one;
42. the resident mesh: Mixtral-8x7B at its published width and 2 layers,
   two ranks spawned with a ``file://`` rendezvous (gloo on one card, its
   CUDA tensors staged through the host; NCCL with a card a rank), each
   holding every plan (``expert=2``, ``model=2``, ``data=2`` with 4 rows)
   against its own unsharded run of the same seed's weights: at f32 through
   K3 (prefill logits within 2e-4 under ``expert=2``, whose ranks launch the
   unsharded layer's grid; within 5e-2 under ``model=2`` and ``data=2``,
   whose K3 inputs differ in their last bits) and through the exact grouped
   FFN (within 2e-4), greedy tokens equal, all held; at bf16 through K3, the gaps reported; K1,
   K2 and K3 launched by each rank's sharded runs (their launches go into
   the ``kernels`` line); a rank that fails or outlives 420 s fails
   the phase. Where the machine has two cards, K1 and K3 on ``cuda:1``
   against their plain versions first;
43. offload across ranks (``runtime/pod_engine.py``): the one-rank
   engines of the same seeds first, in this process, then ranks spawned as
   in 42 with an exchange timeout of 120 s: on 2 ranks, NLLB-MoE-54B at its
   published width and 4+4 blocks (f32 over int4, one MoE layer's share a
   coordinate, 4 requests x 8 tokens) through ``PodSeq2SeqOffloadEngine``
   under ``expert=2``, and Mixtral-8x7B at 2 layers (f32 over int8, 4 rows
   x 8 tokens) through ``PodOffloadEngine`` per layer and speculative
   (blocks of 4); on 4 ranks, the NLLB under ``model=2, expert=2`` (int4
   columns repacked), its host fallback with column 1 of coordinate 0
   never landing a record (1 request x 4 tokens; the reference runs that
   coordinate's experts on the host, as the agreed rows make the ranks do),
   and Mixtral under ``data=2,
   expert=2``. Each rank's greedy tokens equal the reference's and its
   first-step logits within 2e-4 (``expert=2``) or 5e-2 (a model or data
   axis: K3 planned for a d_ff column or half the rows), all held; 43c's
   host executions above 0, held; each rank's hits, misses, evictions,
   fetches, barrier joins and seconds printed; K1, K2 and K3 launched in
   every leg of every rank (their launches go into the ``kernels`` line);
44. sequence parallelism (``parallel/sequence.py``, ``ops/ring_attention.py``):
   the one-rank runs of the same seeds first, in this process, then two
   ranks spawned as in 42, once for three legs: (a) ``MoE(...,
   sequence_parallel=2)`` over Mixtral-8x7B at its published width and 2
   layers (int8 experts from a store written directly under ``.sp_entry/``,
   git-ignored, deleted after), one greedy request of 4,097 tokens (4,096
   through the ring, 2,048 a rank, and 1 through the tail) and 16 new ones,
   then a 1-token request (the resident path, no hop); (b) ``SPDecoder``
   over DeepSeek-V2-Lite at its published width and 2 layers, 2,048 + 8
   tokens; (c) ``sp_encode`` over NLLB-MoE-54B's published width, 2 encoder
   blocks (one MoE), one unpadded 1,024-token document. Each leg at f32
   through the plain grouped FFN (within 2e-4 of the one-rank run: the
   prefill's last logits, the encoder output; greedy tokens equal) and
   through K3 (within 5e-2, tokens equal), held; at bf16 through K3,
   reported; each rank's K3 launches go into the ``kernels`` line, and a
   rank that launched none fails the phase. Then (d): ``ring_attention``
   and ``sp_decode_attention`` on four ranks at Mixtral's attention width
   (4,096 tokens, 1,024 a rank), within 2e-5 of plain attention. ``[sp]``
   lines give per leg and rank the seconds, the prefill's tokens/s, the
   decode step's ms and the bytes the hops sent;
45. OPT-2.7B at its published width and full depth (facebook/opt-2.7b:
   hidden 2560, FFN 10240, 32 layers, 32 heads of 80, vocab 50,272, 2048
   positions, ReLU, pre-norm), weights from a seed, through the padded
   instances of K1 and K2 (``flash_decode_pad128``, ``flash_attend_pad128``;
   the head-dim-128 instances must not launch): (a) bf16 resident through
   ``ResidentStepper`` and ``Generator``, 4 requests x 8 greedy tokens after a
   warm-up generate, tokens/s and ms a step; then at f32 the prefill's and a
   decode step's logits within 1e-3 (rtol = atol) of the same model under the
   einsum oracle and the greedy tokens equal, held; (b) ``MoE`` from a
   checkpoint of its published ``config.json`` cut to 2 layers (bf16
   safetensors from a seed under ``.opt27_entry/``, deleted at the end),
   ingested at f32: tokens equal to a direct ``Generator`` over the
   archive's params.
46. K5's padded instance on a model's path: DeepSeek-V2-Lite's geometry at
   latent width 256 and rope width 32 (``MLA_PAD_SHAPE``; no published
   model of a served family has an MLA geometry other than 512/64), 1 dense
   + 2 MoE layers, random weights: request 1 through ``Generator`` in bf16
   (``mla_flash_decode_pad`` held to 3 launches a one-token step, the 512/64
   instance to none), then the batcher's two steps at f32 against the plain
   versions on three seeds.

``python3 chip_smoke.py --decode-plans`` instead times K4 under split plans
of 2 to 8 blocks per SM and stops (no main path, no result lines);
``python3 chip_smoke.py --gmm`` builds the kernels, runs phase 2's K3 checks
and times alone (the same inputs as in the whole run), times whole decode
layers under other split plans, and stops the same way;
``python3 chip_smoke.py --mla`` does the same for K5: phase 2's K5 checks
and times alone (V2-Lite's decode step, long rows, H=128; the same inputs
as in the whole run), then K5 under other split plans.
``python3 chip_smoke.py --offload`` runs the build and phases 9 to 12,
phase 2's ``stream_gather`` checks and phases 31 to 33 alone;
``--stream`` the build, the ``stream_gather`` checks and phases 31 to 33; ``--resident`` the build and phases 3, 5, 7 and 46 (to hold those paths
against another tree's in one call); ``--switch`` the build and phases 13
to 15; ``--mixtral-offload`` the build and phases 16 to 18;
``--entrypoints`` the build and phases 19 and 20; ``--grok`` the build,
phase 2's K3 e4m3 and rep 6/7 attention checks and phases 21 and 23;
``--arctic`` the build and phase 22; ``--batchers`` the build, phase 2's
batcher inputs and phases 24 to 30, each on a build of its own;
``--paging`` the build, phase 2's OPT and dequantized-slot checks and phases
34 to 37; ``--host-fallback`` the build and phases 37 and 38 (with
``--paging``, 34 to 38); ``--loading`` the build and phases 39 and 40;
``--scan`` the build and phases 3, 5 and 7 with phase 41 on their builds;
``--mesh`` the build and phase 42; ``--pod`` the build and phase 43;
``--sp`` the build and phase 44; ``--opt27`` the build, phase 2's checks at
other head dims and rep 16, and phase 45. Each prints no result line.
Every phase prints its seconds (``[phase]``). For its time limit the whole
run generates ``WHOLE_RUN_NEW_TOKENS`` (8) greedy tokens a request after
phase 2 where a phase's flag generates 16, runs the f32 whole paths of 15,
17, 18, 21 and 22 over half their tokens and steps, and phase 43's NLLB at
2+2 blocks; and, for the same limit, phase 32's leg over all six direct
layers at 8 tokens (``WHOLE_RUN_DIRECT``), phases 19 and 39 at 8 tokens a
request (``WHOLE_RUN_EP_NEW``), phase 40's facades at 2 requests of 8 tokens
(``WHOLE_RUN_DS_REQUESTS``, ``WHOLE_RUN_DS_NEW``), phase 38's deadline-0
legs at 2 tokens (``WHOLE_RUN_HF_NEW``) and phase 28's requests at 8 tokens
(``WHOLE_RUN_ARB_TOKENS``): fewer tokens and requests, every path and check
kept; each flag runs its phases in full.

The line before the last is the per-kernel JSON record (launches: the sum
of the counts of phases 3, 5, 7, 9, 11, 13, 14, 16, 18, 19, 21, 22, 23,
24 to 30 (26's none: a check-only phase), 31, 32, 34, 36 to 38, 39, 40,
41's timed calls, both ranks' sharded runs of 42, every rank's legs of
43, both ranks' K3 runs of 44, 45 and 46, graph replays included; K3's e4m3 kind has its own row, ``gmm_fp8``,
and its calls over the pre-tiled pool theirs, ``gmm_tiled`` (phase 7b); K5's padded instance
``mla_flash_decode_pad`` (phase 46);
K2 at head dim 64 has its own row, ``flash_attend_dh64``, and K1 and K2 on
their padded instance of width 128 theirs, ``flash_decode_pad128`` and
``flash_attend_pad128`` (phase 45's OPT-2.7B at head dim 80): a graph
counts at each replay the launches it recorded when it was captured); the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

START = time.perf_counter()  # the whole run's clock, the imports before it excepted

sys.path.insert(0, str(Path(__file__).resolve().parent))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
HOST_LINK_BYTES_PER_S = 32e9 * 128 / 130 * 16 / 8  # H100 SXM host link: PCIe Gen5 x16, one way
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2  # rtol = atol for bf16 operands (the JAX suite's gmm tolerance)

NLLB_54B = dict(
    vocab_size=256206, d_model=2048, num_heads=16,
    encoder_layers=24, decoder_layers=24,
    encoder_ffn_dim=8192, decoder_ffn_dim=8192,
    encoder_sparse_step=4, decoder_sparse_step=4,
    num_experts=128, pad_token_id=1, decoder_start_token_id=2,
    max_positions=1024, scale_embedding=True,
)
SRC_LENS = (64, 48, 40, 24)  # the 4 requests' source lengths, padded to 64
# phases 10 and 12: (seed, decoder records staged in a tier); the whole run
# takes the second alone (the tier and the store), for its time limit
PARITY_SEEDS = ((11, False), (12, True))
WHOLE_RUN_PARITY_SEEDS = PARITY_SEEDS[1:]
# the f32 whole paths of phases 10, 12, 26 and 33: blocks a stack, every 2nd
# sparse; the whole run takes 26 and 33 at 2+2 (one MoE layer a stack), for
# its time limit (10 and 12 need 4+4: at 2+2 an arena of E slots holds every
# expert the requests route, and nothing is evicted)
PARITY_BLOCKS = 4
WHOLE_RUN_PARITY_BLOCKS = 2
NEW_TOKENS = 16
# the whole run's greedy tokens a request in the phases after phase 2, and the
# f32 whole paths' tokens and steps (phases 15, 17, 18; 21 and 22), for its
# time limit (PR 21: phase 44 added, the run read 1,322 s); each phase's flag
# runs NEW_TOKENS, PARITY_TOKENS and GA_PARITY_STEPS
WHOLE_RUN_NEW_TOKENS = 8
WHOLE_RUN_PARITY_TOKENS = 12
WHOLE_RUN_GA_STEPS = 6

# bench.py MIXTRAL_8X7B_SPEC
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    num_experts=8, top_k=2, rms_eps=1e-5, rope_theta=1e6,
    tie_embeddings=False,
)
PROMPT_LENS = (24, 40, 64, 96, 17, 33, 50, 80)  # 8 requests into 4 slots
SLOTS, PAGE, MAX_COLS, CHUNK = 4, 16, 512, 16
NLLB_KERNELS = ("flash_decode", "flash_attend", "gmm")
BATCHER_KERNELS = ("paged_flash_decode", "flash_attend", "gmm")

# bench.py DSV2_LITE_SPEC (the published DeepSeek-V2-Lite geometry)
DSV2_LITE = dict(
    vocab_size=102400, hidden_size=2048, intermediate_size=10944,
    moe_intermediate_size=1408, num_layers=27, num_heads=16,
    q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, num_experts=64, top_k=6,
    n_shared_experts=2, first_k_dense_replace=1, topk_method="greedy",
    n_group=None, topk_group=None, routed_scaling_factor=1.0,
    rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
)
MLA_KERNELS = ("mla_flash_decode", "gmm")
# device functions of csrc/flash_attention.cu, as a profile names them
ATTENTION_KERNELS = ("flash_decode_kernel", "paged_decode_kernel", "attend_rows_kernel",
                     "flash_attend_kernel", "flash_attend_f32_kernel", "mla_decode_kernel")


def say(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Device time per call. A spin kernel of some 60 ms goes first, so the host
    has queued every call before the device reaches them and the events
    time the device's work, not the host's launch rate (a function that
    reads a value on the host inside, as gmm_plain does, waits for the spin
    and is then timed with its host work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def compare(name, got, want, tol=TOL) -> float:
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # share of the allclose limit used by the worst element: fails above 1
    used = (diff / (tol + tol * want.float().abs())).max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    finite = bool(torch.isfinite(got.float()).all())
    say(f"[check] {name}: max_abs_err={err:.3e} tol(rtol=atol)={tol} "
        f"limit_used={used:.3f} {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from moe_infinity_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    say(f"[build] {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s "
        f"(each nvcc's seconds: {json.dumps(_build.BUILD_SECONDS)})")
    for stem, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            _say_ptxas(stem, log.read_text())
    return smi


def _say_ptxas(stem, log):
    """One line per kernel of ptxas's report: registers, shared memory,
    stack and spills, under the kernel's name without its namespace."""
    import re

    name, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            ns = re.match(r"_ZN(\d+)_GLOBAL__N_", name)  # the anonymous namespace
            if ns:  # skip it by its mangled length, then the length of the name
                name = re.sub(r"^\d+", "", name[ns.end(1) + int(ns.group(1)):])
            name = re.sub(r"13__nv_bfloat16", "bf16", name)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            say(f"[ptxas] {stem}: {name[:48]}: "
                f"{line.split(':', 1)[-1].strip()}; {spill}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pad_bias(dev, S):
    valid = torch.zeros(len(SRC_LENS), S, dtype=torch.bool, device=dev)
    for i, n in enumerate(SRC_LENS):
        valid[i, :n] = True
    bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min)
    return bias[:, None, None, :].contiguous()


def _sdpa_mask_call(q, k, v, mask):
    import torch.nn.functional as F

    # [B, T, H, Dh] -> [B, H, T, Dh] views; the float mask broadcasts
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def check_flash_decode(g, dev):
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Dh, S = 4, 16, 128, 32
    # the last decode step: the decoder passes the cache's capacity as kv_len
    # and the causal bound of the position leaves 17 live keys
    kv_len, step = S, NEW_TOKENS
    q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
    run = lambda: fa.flash_decode(q, k, v, pos, kv_len)  # noqa: E731
    plain = lambda: fa.flash_decode_plain(  # noqa: E731
        q[:, 0], k, v, pos[:, 0], kv_len, scale=Dh ** -0.5
    )
    err = compare("flash_decode B=4 H=16 S=32 kv_len=32 (17 live)", run()[:, 0], plain())
    live = min(kv_len, step + 1)
    _k1_capacity_cost(g, dev, q, pos, live)
    mask = torch.full((B, 1, 1, S), float("-inf"), device=dev, dtype=torch.bfloat16)
    mask[..., :live] = 0
    nbytes = 2 * B * H * Dh * 2 + 2 * B * live * H * Dh * 2 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * B * H * live * Dh)
    return dict(
        name="flash_decode", route="cuda",
        source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
        replaces="moe_infinity_tpu/ops/flash_attention.py:308",
        max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(_sdpa_mask_call(q, k, v, mask)),
        shape=f"B={B} H={H} Dh={Dh} S={S} live={live} bf16",
    )


def _k1_capacity_cost(g, dev, q, pos, live):
    """K1 with kv_len the live keys (the split plan from them) against
    kv_len the cache's capacity (the plan from it, the causal bound leaving
    the same keys), at phase 3's and phase 11's capacity of 32 and at 1024."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, _, H, Dh = q.shape
    for S in (32, 1024):
        k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        a, b = fa.flash_decode(q, k, v, pos, live), fa.flash_decode(q, k, v, pos, S)
        torch.cuda.synchronize()
        ms = [cuda_ms(lambda n=n: fa.flash_decode(q, k, v, pos, n)) for n in (live, S, live, S)]
        say(f"[time] flash_decode capacity {S}, {live} live keys: kv_len={live} plan "
            f"{fa._decode_splits(B * H, live)} ms={ms[0]:.5f}/{ms[2]:.5f}, kv_len={S} plan "
            f"{fa._decode_splits(B * H, S)} ms={ms[1]:.5f}/{ms[3]:.5f}; results "
            f"{'bit-equal' if torch.equal(a, b) else 'differ by %.3e' % (a - b).abs().max()}")


def check_flash_attend(g, dev):
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Dh, S = 4, 16, 128, max(SRC_LENS)
    bias = _pad_bias(dev, S)
    recs = {}
    for label, T in (("encoder", S), ("cross", 1)):
        q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
        run = lambda: fa.flash_attend(  # noqa: E731
            q, k, v, pos, S, causal=False, bias=bias
        )
        plain = lambda: fa.flash_attend_plain(  # noqa: E731
            q, k, v, pos, S, scale=Dh ** -0.5, causal=False, bias=bias
        )
        err = compare(f"flash_attend {label} B={B} T={T} S={S} pad bias", run(), plain())
        nbytes = 2 * B * T * H * Dh * 2 + 2 * B * S * H * Dh * 2 + B * S * 4 + B * T * 4
        b_ms, b_by = bound_ms(nbytes, 4 * B * H * T * S * Dh)
        recs[label] = dict(
            name="flash_attend", route="cuda",
            source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
            replaces="moe_infinity_tpu/ops/flash_attention.py:81",
            max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(_sdpa_mask_call(q, k, v, bias.to(torch.bfloat16))),
            shape=f"{label}: B={B} T={T} H={H} Dh={Dh} S={S} bf16",
        )
    for label in ("encoder", "cross"):
        say(f"[time] flash_attend NLLB {label} shape: {json.dumps(recs[label])}")
    return max(r["max_abs_err"] for r in recs.values())


def check_flash_attend_chunk(g, dev):
    """K2 at the Mixtral batcher's 16-wide chunk step over the gathered view:
    B=4, T=16, H=32 over Hkv=8, S=512, causal, a key_valid mask with holes,
    no bias, the queries at columns 250-265 (kv_len 266), bf16."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, T, H, Hkv, Dh, S = SLOTS, CHUNK, 32, 8, 128, MAX_COLS
    col0 = 250
    kv_len = col0 + T
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    pos = (col0 + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
    holes = torch.rand(B, S, generator=g, device=dev) > 0.1
    holes[:, col0:kv_len] = True  # this step's own columns are live
    run = lambda: fa.flash_attend(q, k, v, pos, kv_len, pad_mask=holes)  # noqa: E731
    plain = lambda: fa.flash_attend_plain(  # noqa: E731
        q, k, v, pos, kv_len, scale=Dh ** -0.5, pad_mask=holes
    )
    err = compare(f"flash_attend chunk step B={B} T={T} H={H} Hkv={Hkv} S={S} causal, "
                  f"columns {col0}-{kv_len - 1}, holes", run(), plain())
    key = torch.arange(S, device=dev)
    ok = holes[:, None, :] & (key[None, None, :] <= pos[:, :, None])  # [B, T, S]
    read = int(ok.any(1).sum())  # keys some query of the row attends to
    nbytes = (2 * B * T * H * Dh * 2 + 2 * read * Hkv * Dh * 2  # q, out, live K and V rows
              + B * kv_len + B * T * 4)  # mask bytes of the live range, positions
    b_ms, b_by = bound_ms(nbytes, 4 * H * Dh * int(ok.sum()))
    rep = H // Hkv
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    fmask = torch.where(ok, 0.0, float("-inf")).to(torch.bfloat16)[:, None]
    qt = q.transpose(1, 2)
    lib = lambda: F_.scaled_dot_product_attention(qt, kt, vt, attn_mask=fmask)  # noqa: E731
    rec = dict(
        name="flash_attend", route="cuda",
        source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
        replaces="moe_infinity_tpu/ops/flash_attention.py:81",
        max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib),
        shape=f"Mixtral chunk step: B={B} T={T} H={H} Hkv={Hkv} Dh={Dh} S={S} causal, "
              f"{read} keys read, bf16 (library: SDPA, KV heads expanded beforehand)",
    )
    return rec


def _routed_rows(g, dev, tokens, E, K=2):
    """Sorted (token, k) rows of top-K routing over E experts: (slots,
    group_ids, group_sizes) as gffn_pallas builds them."""
    from moe_infinity_tpu_torch.ops.gmm import compact_groups

    ids = torch.stack([
        torch.randperm(E, generator=g, device=dev)[:K] for _ in range(tokens)
    ])
    flat = ids.reshape(-1)
    sorted_slots = flat[torch.argsort(flat, stable=True)]
    gid, gsz = compact_groups(sorted_slots, min(E, flat.shape[0]))
    return gid, gsz, int(torch.unique(flat).numel())


def _plan(rows, G, D, Fw):
    """K3's split plan for one call, as its wrapper takes it."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    p = gm._gmm_plan(rows, G, D, Fw)
    return f"{p.tiles}x{p.chunks}x{p.splits}"


def _layer_plans(x, w, gsz):
    """The plans of a layer's gate, up and down calls, as tiles x chunks x
    splits (the grid)."""
    rows, G = x.shape[0], gsz.shape[0]
    return "plans " + " ".join(f"{r}={_plan(rows, G, w[r].shape[1], w[r].shape[2])}"
                               for r in ROLES)


def _gmm_case(name, g, dev, *, rows, D, F, S, kind, gid=None, gsz=None,
              active=None, time_it=False, keep=False):
    from moe_infinity_tpu_torch.ops import gmm as gm

    x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
    packed = kind == "int4"
    Fw = F // 2 if packed else F
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, Fw, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    else:
        lo, hi = (-128, 128)
        w = torch.randint(lo, hi, (S, D, Fw), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(S, F, generator=g, device=dev) * 0.0026 + 0.003
        if kind == "int8":
            scale = scale / 16
    run = lambda: gm.gmm(x, w, gsz, scale, group_ids=gid, packed=packed)  # noqa: E731
    plain = lambda: gm.gmm_plain(  # noqa: E731
        x, w, gsz, scale, group_ids=gid, packed=packed
    )
    err = compare(f"gmm {name} plan={_plan(rows, gsz.shape[0], D, Fw)}", run(), plain())
    if not time_it:
        return err, None
    wbytes = active * D * Fw * w.element_size()
    nbytes = rows * D * 2 + wbytes + active * F * 4 + rows * F * 4
    out = dict(
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=5, warmup=1),
        nbytes=nbytes, flops=2 * rows * D * F,
    )
    if keep:  # the inputs, for a library yardstick on the same tensors
        out.update(x=x, w=w, run=run)
    return err, out


def check_gmm(g, dev):
    E, D, F = 128, 2048, 8192
    B = len(SRC_LENS)
    errs, timed = [], {}
    for label, tokens in (("decode", B), ("prefill", B * max(SRC_LENS) // 1)):
        gid, gsz, active = _routed_rows(g, dev, tokens, E)
        for role, (d_in, f_out) in (("gate", (D, F)), ("down", (F, D))):
            err, t = _gmm_case(
                f"int4 {label} {role} rows={2 * tokens} D={d_in} F={f_out} "
                f"S={E} active={active}", g, dev, rows=2 * tokens, D=d_in,
                F=f_out, S=E, kind="int4", gid=gid, gsz=gsz, active=active,
                time_it=True,
            )
            errs.append(err)
            timed[(label, role)] = t
            b_ms, b_by = bound_ms(t["nbytes"], t["flops"])
            say(f"[time] gmm int4 {label} {role}: ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
    # small bf16 / int8 cases, and empty groups with compacted ids
    sizes = torch.tensor([5, 0, 9, 0, 2], dtype=torch.int32, device=dev)
    for kind in ("bf16", "int8"):
        errs.append(_gmm_case(f"{kind} S=5 with empty groups", g, dev, rows=16,
                              D=256, F=384, S=5, kind=kind, gsz=sizes)[0])
    gid = torch.tensor([3, 17, 40, 0, 0], dtype=torch.int32, device=dev)
    gsz = torch.tensor([6, 1, 9, 0, 0], dtype=torch.int32, device=dev)
    errs.append(_gmm_case("int4 compacted ids, padded empty groups", g, dev,
                          rows=16, D=512, F=1024, S=64, kind="int4",
                          gid=gid, gsz=gsz)[0])
    gate, down = timed[("decode", "gate")], timed[("decode", "down")]
    b_ms, b_by = bound_ms(gate["nbytes"] + down["nbytes"], gate["flops"] + down["flops"])
    say(f"[time] gmm NLLB decode MoE layer (gate + down, 8 rows, packed int4, "
        f"D=2048 F=8192 S=128): ms={gate['ms'] + down['ms']:.4f} plain_ms="
        f"{gate['plain_ms'] + down['plain_ms']:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return max(errs)


def check_opt_attention(g, dev):
    """K1 at OPT-66B's decode (B = 1 and 8, 72 heads over 72, head dim 128,
    the last of 16 steps after a prompt of 32: 48 live keys of a 64-column
    cache) and K2 at its prefill (B = 8, T = 32 over the cache's first 32
    columns, causal), bf16, against the plain versions, timed beside SDPA.
    Returns the largest error per kernel."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    H, Dh, S, T = 72, 128, 64, OPT_PROMPT
    live = T + NEW_TOKENS
    errs = {}
    for B in (1, 8):
        q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        pos = torch.full((B, 1), live - 1, dtype=torch.int32, device=dev)
        run = lambda: fa.flash_decode(q, k, v, pos, live)  # noqa: E731
        plain = lambda: fa.flash_decode_plain(  # noqa: E731
            q[:, 0], k, v, pos[:, 0], live, scale=Dh ** -0.5)
        err = compare(f"flash_decode OPT-66B B={B} H=72 rep 1 S={S} ({live} live)",
                      run()[:, 0], plain())
        errs["flash_decode"] = max(errs.get("flash_decode", 0.0), err)
        mask = torch.full((B, 1, 1, S), float("-inf"), device=dev, dtype=torch.bfloat16)
        mask[..., :live] = 0
        b_ms, b_by = bound_ms(2 * B * H * Dh * 2 + 2 * B * live * H * Dh * 2 + B * 4,
                              4 * B * H * live * Dh)
        say(f"[time] flash_decode OPT-66B decode B={B} H=72 Dh=128 {live} live keys: "
            f"ms={cuda_ms(run):.5f} plain_ms={cuda_ms(plain):.4f} bound_ms={b_ms:.6f} ({b_by}) "
            f"library_ms={cuda_ms(_sdpa_mask_call(q, k, v, mask)):.5f} (SDPA) launches per "
            f"step 64")
    B = 8
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
    run = lambda: fa.flash_attend(q, k, v, pos, T, causal=True)  # noqa: E731
    plain = lambda: fa.flash_attend_plain(q, k, v, pos, T, scale=Dh ** -0.5,  # noqa: E731
                                          causal=True)
    errs["flash_attend"] = compare(f"flash_attend OPT-66B prefill B={B} T={T} H=72 causal",
                                   run(), plain())
    qi = torch.arange(T, device=dev)[:, None]
    ki = torch.arange(S, device=dev)[None, :]
    mask = torch.where((ki <= qi) & (ki < T), 0.0, float("-inf")).to(torch.bfloat16)[None, None]
    b_ms, b_by = bound_ms(2 * B * T * H * Dh * 2 + 2 * B * T * H * Dh * 2 + B * T * 4,
                          4 * B * H * Dh * T * (T + 1) // 2)
    say(f"[time] flash_attend OPT-66B prefill B={B} T={T} H=72 Dh=128 causal: "
        f"ms={cuda_ms(run):.5f} plain_ms={cuda_ms(plain):.4f} bound_ms={b_ms:.6f} ({b_by}) "
        f"library_ms={cuda_ms(_sdpa_mask_call(q, k, v, mask)):.5f} (SDPA) launches per "
        f"prefill 64")
    return errs


# ---- phase 2: K1, K2 and K4 at other head dims and rep 16 ----------------------

# (label, B values, H, Hkv, Dh, what the shape stands for); each timed in bf16
HEAD_DIM_CASES = (
    ("OPT-2.7B", (4, 8), 32, 32, 80, "decode and prefill of phase 45"),
    ("Dh 256", (4,), 16, 8, 256, "the width-256 instance at its full width"),
    ("Dh 97", (4,), 8, 4, 97, "rows of no multiple of 16 bytes in bf16 or f32"),
    ("rep 16", (4,), 64, 4, 128, "Qwen3-235B-A22B's 64 query heads over 4"),
)
HD_LIVE = 48  # the decode rows' live keys of a 64-column cache (32 + 16, as phase 34's)
HD_T = 32  # the prefill's queries (causal over the cache's first 32 columns)


def _sdpa_gqa(q, k, v, mask):
    """SDPA over [B, T, H, Dh] queries with the KV heads expanded to H
    beforehand (not timed), a float mask."""
    import torch.nn.functional as F_

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kx = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vx = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    return lambda: F_.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)


def _hd_time(name, label, run, plain, nbytes, flops, lib, launches):
    """One [time] line; returns its record (ms, plain_ms, bound, library_ms)."""
    b_ms, b_by = bound_ms(nbytes, flops)
    rec = dict(ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=5, warmup=1), bound_ms=b_ms,
               bound_by=b_by, library_ms=cuda_ms(lib))
    say(f"[time] {name} {label}: ms={rec['ms']:.5f} plain_ms={rec['plain_ms']:.4f} "
        f"bound_ms={b_ms:.6f} ({b_by}) library_ms={rec['library_ms']:.5f} (SDPA, KV heads "
        f"expanded beforehand where rep > 1) launches {launches}")
    return rec


def check_head_dims(dev):
    """K1, K2 (the few-row route and the tiled kernels) and K4 on the
    padded instances (``csrc/flash_attention_pad128.cu``, ``pad256.cu``) and on row groups
    (rep 16), against the plain versions, bf16 (2e-2) and f32 (2e-3):
    OPT-2.7B's decode (B = 4 and 8, H = 32, Dh = 80, 48 live keys of a
    64-column cache, contiguous and paged through a shuffled page table of
    16-key pages with 10% holes) and prefill (T = 32, causal; and one token
    with a pad bias, the few-row route), the same at Dh 256 (rep 2), Dh 97
    (rep 2) and rep 16 (64 heads over 4 at Dh 128). bf16 times beside SDPA.
    Each launch is counted under its instance's name. Draws from its own
    generator. Returns ({launch name: largest error}, {launch name: the
    record of its OPT-2.7B B = 4 shape, for the kernels line})."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev)
    g.manual_seed(22)
    errs, recs = {}, {}
    S, P = 64, 64 // PAGE
    for label, batches, H, Hkv, Dh, what in HEAD_DIM_CASES:
        sfx = fa._instance(Dh)[2]
        sc = Dh ** -0.5
        for B in batches:
            for dtype in (torch.bfloat16, torch.float32):
                dn = "bf16" if dtype == torch.bfloat16 else "f32"
                tol = TOL if dtype == torch.bfloat16 else 2e-3
                es = 2 if dtype == torch.bfloat16 else 4
                tag = f"{label} ({what}) B={B} H={H} Hkv={Hkv} Dh={Dh} {dn}"
                NP = B * P + 8
                q, pk, pv, table, lengths, holes = _paged_case(
                    g, dev, dtype, B=B, H=H, Hkv=Hkv, P=P, NP=NP, lengths=[HD_LIVE] * B,
                    Dh=Dh)
                idx = table.long()
                k, v = pk[idx].reshape(B, S, Hkv, Dh), pv[idx].reshape(B, S, Hkv, Dh)
                qpos = torch.full((B, 1), HD_LIVE - 1, dtype=torch.int32, device=dev)
                before = dict(fa.LAUNCHES)
                dec = lambda: fa.flash_decode(q[:, None], k, v, qpos, HD_LIVE)  # noqa: E731
                dec_plain = lambda: fa.flash_decode_plain(  # noqa: E731
                    q, k, v, qpos[:, 0], HD_LIVE, scale=sc)
                paged = lambda: fa.paged_flash_decode(  # noqa: E731
                    q, pk, pv, table, lengths, pad_mask=holes)
                paged_plain = lambda: fa.paged_flash_decode_plain(  # noqa: E731
                    q, pk, pv, table, lengths, scale=sc, pad_mask=holes)
                qq = torch.randn(B, HD_T, H, Dh, generator=g, device=dev).to(dtype)
                pos = torch.arange(HD_T, dtype=torch.int32, device=dev).expand(B, HD_T).contiguous()
                pre = lambda: fa.flash_attend(qq, k, v, pos, HD_T, causal=True)  # noqa: E731
                pre_plain = lambda: fa.flash_attend_plain(  # noqa: E731
                    qq, k, v, pos, HD_T, scale=sc, causal=True)
                bias = torch.where(holes, 0.0, torch.finfo(torch.float32).min)[:, None, None]
                q1, pos1 = qq[:, -1:].contiguous(), pos[:, -1:].contiguous()
                one = lambda: fa.flash_attend(  # noqa: E731
                    q1, k, v, pos1, S, causal=False, bias=bias)
                one_plain = lambda: fa.flash_attend_plain(  # noqa: E731
                    q1, k, v, pos1, S, scale=sc, causal=False, bias=bias)
                for name, got, want in (
                        ("flash_decode", lambda: dec()[:, 0], dec_plain),
                        ("paged_flash_decode", paged, paged_plain),
                        ("flash_attend", pre, pre_plain),
                        ("flash_attend", one, one_plain)):
                    key = name + sfx
                    errs[key] = max(errs.get(key, 0.0),
                                    compare(f"{key} {tag}", got(), want(), tol))
                ran = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES
                       if fa.LAUNCHES[n] != before[n]}
                want_runs = {"flash_decode" + sfx: 1, "paged_flash_decode" + sfx: 1,
                             "flash_attend" + sfx: 2}
                if ran != want_runs:
                    raise AssertionError(f"{tag}: launches {ran}, expected {want_runs}")
                if dtype != torch.bfloat16:
                    continue
                # bf16 times: bytes of q and out, the K/V rows read once
                # (decode: the live ones under the holes for K4), the ints
                valid = int(holes[:, :HD_LIVE].sum())
                live_mask = torch.zeros(B, 1, 1, S, dtype=dtype, device=dev)
                live_mask[..., HD_LIVE:] = float("-inf")
                hole_mask = torch.where(holes & (torch.arange(S, device=dev) < HD_LIVE),
                                        0.0, float("-inf")).to(dtype)[:, None, None]
                qi = torch.arange(HD_T, device=dev)[:, None]
                ki = torch.arange(S, device=dev)[None, :]
                causal_mask = torch.where((ki <= qi) & (ki < HD_T), 0.0, float("-inf")).to(
                    dtype)[None, None]
                opt = label == "OPT-2.7B"
                r1 = _hd_time(
                    "flash_decode" + sfx, tag + f", {HD_LIVE} live keys", lambda: dec()[:, 0],
                    dec_plain, 2 * B * H * Dh * es + 2 * B * HD_LIVE * Hkv * Dh * es + B * 4,
                    4 * B * H * HD_LIVE * Dh, _sdpa_gqa(q[:, None], k, v, live_mask),
                    "32 per step (phase 45)" if opt else "phase 2 only")
                _hd_time("paged_flash_decode" + sfx, tag + f", {valid} valid keys", paged,
                         paged_plain,
                         2 * B * H * Dh * es + 2 * valid * Hkv * Dh * es + B * P * 4
                         + B * HD_LIVE + B * 4,
                         4 * H * valid * Dh, _sdpa_gqa(q[:, None], k, v, hole_mask),
                         "phase 2 only (the paged batcher)")
                r2 = _hd_time(
                    "flash_attend" + sfx, tag + f", prefill T={HD_T} causal", pre, pre_plain,
                    2 * B * HD_T * H * Dh * es + 2 * B * HD_T * Hkv * Dh * es + B * HD_T * 4,
                    4 * B * H * Dh * HD_T * (HD_T + 1) // 2,
                    _sdpa_gqa(qq, k, v, causal_mask),
                    "32 per prefill (phase 45)" if opt else "phase 2 only")
                if opt and B == batches[0]:
                    for name, r, shape in (
                            ("flash_decode" + sfx, r1,
                             f"OPT-2.7B decode B={B} H={H} Dh={Dh} {HD_LIVE} live keys bf16"),
                            ("flash_attend" + sfx, r2,
                             f"OPT-2.7B prefill B={B} T={HD_T} H={H} Dh={Dh} causal bf16")):
                        recs[name] = dict(
                            name=name, route="cuda",
                            source="moe_infinity_tpu_torch/csrc/flash_attention_pad128.cu",
                            replaces=("moe_infinity_tpu/ops/flash_attention.py:308"
                                      if name.startswith("flash_decode")
                                      else "moe_infinity_tpu/ops/flash_attention.py:81"),
                            shape=shape, **r)
    for r in recs.values():
        r["max_abs_err"] = errs[r["name"]]
    return errs, recs


def check_gmm_dequant(g, dev):
    """K3's bf16 kind over NLLB-MoE-54B's expert slots as ``dequant_on_write``
    lands them (bf16, 2048 x 8192 and 8192 x 2048): a decode layer's gate
    and down, 8 rows over the routed experts of 16 slots, against the plain
    version, timed beside its bound and beside ``torch._grouped_mm`` on the
    same inputs (one call a projection, each slot's rows as device offsets).
    Returns the largest error."""
    D, F, S = 2048, 8192, 16
    gid, gsz, active = _routed_rows(g, dev, len(SRC_LENS), S)
    errs, t = [], {}
    for role, (d_in, f_out) in (("gate", (D, F)), ("down", (F, D))):
        err, t[role] = _gmm_case(f"bf16 (dequant-on-write slots) decode {role} rows=8 "
                                 f"D={d_in} F={f_out} S={S} active={active}", g, dev,
                                 rows=2 * len(SRC_LENS), D=d_in, F=f_out, S=S, kind="bf16",
                                 gid=gid, gsz=gsz, active=active, time_it=True, keep=True)
        errs.append(err)
    b_ms, b_by = bound_ms(t["gate"]["nbytes"] + t["down"]["nbytes"],
                          t["gate"]["flops"] + t["down"]["flops"])
    if hasattr(torch, "_grouped_mm"):
        # the rows are sorted by slot: slot s takes the next sizes[s] rows
        sizes = torch.zeros(S, dtype=torch.int32, device=dev).index_add_(0, gid.long(), gsz)
        ends = torch.cumsum(sizes, 0).to(torch.int32)
        lib = lambda: [torch._grouped_mm(t[r]["x"], t[r]["w"], offs=ends)  # noqa: E731
                       for r in ("gate", "down")]
        torch.cuda.synchronize()
        gap = max((got.float() - t[r]["run"]().float()).abs().max().item()
                  for got, r in zip(lib(), ("gate", "down")))
        lib_txt = (f"{cuda_ms(lib):.4f} (torch._grouped_mm x2 over all {S} slots, bf16 out; "
                   f"max_abs_diff={gap:.3e}, reported, not held)")
    else:
        lib_txt = "None (this torch has no torch._grouped_mm)"
    say(f"[time] gmm NLLB decode MoE layer over dequantized bf16 slots (gate + down, 8 rows "
        f"over {active} experts, D=2048 F=8192): ms={t['gate']['ms'] + t['down']['ms']:.4f} "
        f"plain_ms={t['gate']['plain_ms'] + t['down']['plain_ms']:.4f} bound_ms={b_ms:.5f} "
        f"({b_by}) library_ms={lib_txt}")
    return max(errs)


ROLES = ("gate", "up", "down")


def _layer_weights(g, dev, S, D, F, kind):
    """gate, up and down weights of S experts from the generator: bf16, int8
    with per-channel scales, e4m3 with scales, or packed int4 with scales."""
    w, sc = {}, {}
    for role, (d_in, d_out) in zip(ROLES, ((D, F), (D, F), (F, D))):
        if kind == "bf16":
            w[role] = (torch.randn(S, d_in, d_out, generator=g, device=dev) * 0.02
                       ).to(torch.bfloat16)
            sc[role] = None
            continue
        if kind == "fp8":  # about int8's spread, in e4m3's steps
            w[role] = (torch.randn(S, d_in, d_out, generator=g, device=dev) * 40
                       ).clamp(-448, 448).to(torch.float8_e4m3fn)
            sc[role] = torch.rand(S, d_out, generator=g, device=dev) * 0.0009 + 0.001
            continue
        fw = d_out // 2 if kind == "int4" else d_out
        w[role] = torch.randint(-128, 128, (S, d_in, fw), generator=g, device=dev,
                                dtype=torch.int8)
        sc[role] = torch.rand(S, d_out, generator=g, device=dev) * 0.0026 + 0.003
        if kind == "int8":
            sc[role] = sc[role] / 3
    return w, sc


def _check_layer(label, x, w, sc, gsz, active, act="silu", **kw):
    """One MoE layer on K3 (gate and up on x, down on act(gate) * up, act
    silu or gelu) held against gmm_plain role by role, then timed. Returns
    the error, the times, the bound and the down projection's input."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import gmm as gm

    a = (getattr(F_, act)(gm.gmm(x, w["gate"], gsz, sc["gate"], **kw))
         * gm.gmm(x, w["up"], gsz, sc["up"], **kw)).to(torch.bfloat16)

    def calls(fn):
        return lambda: [fn(xin, w[r], gsz, sc[r], **kw) for r, xin in zip(ROLES, (x, x, a))]

    run, plain = calls(gm.gmm), calls(gm.gmm_plain)
    err = max(compare(f"gmm {label} {r}", got, want)
              for r, got, want in zip(ROLES, run(), plain()))
    (rows, D), F = x.shape, a.shape[1]
    nbytes = (sum(active * v[0].numel() * v.element_size() for v in w.values())
              + (0 if sc["gate"] is None else active * (2 * F + D) * 4)  # scales
              + 2 * rows * D * 2 + rows * F * 2  # x read twice, a
              + 2 * rows * F * 4 + rows * D * 4)  # f32 outputs
    b_ms, b_by = bound_ms(nbytes, 2 * rows * D * F * 3)
    return dict(max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=5, warmup=1),
                bound_ms=b_ms, bound_by=b_by, a=a)


def _to_f32(t, toward_zero):
    """The f64 tensor ``t`` rounded to f32: to nearest, or toward zero."""
    r = t.float()
    if toward_zero:
        r = torch.where(r.double().abs() > t.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def gmm_rounding(label, x, w, scale, gsz, gid):
    """Where K3's error against ``gmm_plain`` comes from, on one int8 call
    (reported, not held). Against the exact result (f64 from the bf16 x and
    the int8 w, whose products and sums f64 holds exactly), the line gives
    the largest error over the largest output and the mean signed error over
    the mean output (below 0: magnitudes come out short) of the kernel, of
    ``gmm_plain`` and of two emulations of the kernel's order of sums: each
    split of the plan walks 16-deep steps (one mma.sync) whose exact sum
    with the f32 accumulator is rounded to f32, to nearest or toward zero;
    the splits are summed in order in f32 and the scale comes after."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    T, D = x.shape
    Fw = w.shape[2]
    depth = gm._gmm_plan(T, gsz.shape[0], D, Fw).ktiles * gm._K_TILE
    got = gm.gmm(x, w, gsz, scale, group_ids=gid)
    plain = gm.gmm_plain(x, w, gsz, scale, group_ids=gid)
    sizes, ids = gsz.tolist(), gid.tolist()  # rows are sorted by group: skip empty ones
    ids = [i for i, n in zip(ids, sizes) if n]
    sizes = [n for n in sizes if n]
    G, M = len(sizes), max(sizes)
    xp = torch.zeros(G, M, D, dtype=torch.float64, device=x.device)
    start = 0
    for i, n in enumerate(sizes):
        xp[i, :n] = x[start:start + n].to(torch.bfloat16).double()
        start += n
    wp = torch.stack([w[i].double() for i in ids])
    sp = scale[ids].double()[:, None, :]
    exact = torch.bmm(xp, wp) * sp
    emu = {}
    for rz in (True, False):
        total = torch.zeros(G, M, Fw, device=x.device)
        for k0 in range(0, D, depth):
            acc = torch.zeros(G, M, Fw, device=x.device)
            for k in range(k0, min(D, k0 + depth), 16):
                acc = _to_f32(acc.double() + torch.bmm(xp[:, :, k:k + 16], wp[:, k:k + 16]), rz)
            total = total + acc  # f32, in split order
        emu[rz] = total * sp.float()
    live = torch.cat([torch.arange(n, device=x.device) + i * M for i, n in enumerate(sizes)])

    def rows(t):  # [G, M, F] -> the live rows, in x's order
        return t.reshape(G * M, Fw)[live]

    ref = rows(exact)
    scale_max, scale_mean = ref.abs().max().item(), ref.abs().mean().item()

    def err(t):
        d = t.double() - ref
        return (f"{d.abs().max().item() / scale_max:.3e} / "
                f"{(d * ref.sign()).mean().item() / scale_mean:.3e}")

    n = sum(sizes)
    rz, rn = rows(emu[True]), rows(emu[False])
    say(f"[rounding] gmm {label} (split depth {depth}, 16-deep steps): error against the exact "
        f"result, largest over the largest output / mean signed over the mean output: kernel "
        f"{err(got[:n])}, gmm_plain {err(plain[:n])}, emulated to nearest {err(rn)}, emulated "
        f"toward zero {err(rz)}; kernel less emulated toward zero: largest "
        f"{(got[:n] - rz).abs().max().item() / scale_max:.3e}, less emulated to nearest "
        f"{(got[:n] - rn).abs().max().item() / scale_max:.3e} (reported, not held)")


def check_gmm_mixtral(g, dev):
    """K3 at one Mixtral MoE layer at both step widths of the batcher, int8
    with per-channel scales, D=4096 F=14336, gate + up + down: the W=1 decode
    step (8 rows, 4 tokens x top-2, one row on each of the 8 experts) and the
    W=16 chunk step (128 rows, 64 tokens x top-2 over the 8 experts). Returns
    K3's record (the decode layer) and the W=16 layer's error."""
    from moe_infinity_tpu_torch.ops.gmm import compact_groups

    E, D, F = 8, 4096, 14336
    w, sc = _layer_weights(g, dev, E, D, F, "int8")
    flat = torch.randperm(E, generator=g, device=dev)  # 4 tokens x 2 experts
    gid, gsz = compact_groups(torch.sort(flat).values, E)
    x = torch.randn(8, D, generator=g, device=dev).to(torch.bfloat16)
    dec = _check_layer("int8 Mixtral decode rows=8 active=8", x, w, sc, gsz, E, group_ids=gid)
    tokens = SLOTS * CHUNK
    gid16, gsz16, active = _routed_rows(g, dev, tokens, E)
    x16 = torch.randn(2 * tokens, D, generator=g, device=dev).to(torch.bfloat16)
    w16 = _check_layer(f"int8 Mixtral W=16 chunk step rows={2 * tokens} active={active}",
                       x16, w, sc, gsz16, active, group_ids=gid16)
    gmm_rounding("int8 Mixtral decode down", dec["a"], w["down"], sc["down"], gsz, gid)
    gmm_rounding("int8 Mixtral W=16 chunk step down", w16["a"], w["down"], sc["down"], gsz16,
                 gid16)
    say(f"[time] gmm Mixtral W=16 chunk-step MoE layer (gate + up + down, {2 * tokens} rows "
        f"over {active} experts, group sizes {gsz16.tolist()}, int8 + scales, D={D} F={F}): "
        f"ms={w16['ms']:.4f} plain_ms={w16['plain_ms']:.4f} bound_ms={w16['bound_ms']:.5f} "
        f"({w16['bound_by']}) library_ms=None (no PyTorch call takes int8 weights with "
        f"per-channel scales); {_layer_plans(x16, w, gsz16)}")
    say(f"[time] gmm Mixtral decode MoE layer: {_layer_plans(x, w, gsz)}")
    # the offload engine's step at batch 1 (phase 16): 2 rows on 2 experts
    gid1, gsz1 = compact_groups(torch.sort(flat[:2]).values, 2)
    x1 = torch.randn(2, D, generator=g, device=dev).to(torch.bfloat16)
    one = _check_layer("int8 Mixtral batch-1 decode rows=2 active=2", x1, w, sc, gsz1, 2,
                       group_ids=gid1)
    say(f"[time] gmm Mixtral batch-1 decode MoE layer (the offload step: gate + up + down, 2 "
        f"rows over 2 experts, int8 + scales, D={D} F={F}): ms={one['ms']:.4f} plain_ms="
        f"{one['plain_ms']:.4f} bound_ms={one['bound_ms']:.5f} ({one['bound_by']}); "
        f"{_layer_plans(x1, w, gsz1)}")
    del w, sc
    torch.cuda.empty_cache()
    dec.pop("a")
    return dict(
        name="gmm", route="cuda", source="moe_infinity_tpu_torch/csrc/gmm.cu",
        replaces="moe_infinity_tpu/ops/gmm.py:46", library_ms=None,
        shape=f"one Mixtral decode MoE layer: gate + up + down launches, 8 rows "
              f"over 8 experts, int8 + scales, D={D} F={F}", **dec,
    ), w16["max_abs_err"]


def check_gmm_edges(g, dev):
    """K3 at the edges of its 64-row chunks and 64-deep k-tiles in each
    weight type: groups of 0, 1, 15, 16, 17, 63, 64, 65 and 150 rows with 5
    rows past the last group (they stay zero), D=328 (8 past the last whole
    k-tile) and a half column tile; a last group that ends at a chunk edge
    and one that ends at T; a wide call (one k-split) and a deep one over
    few blocks (several)."""
    errs = []
    sizes = [0, 1, 15, 16, 17, 0, 63, 64, 65, 150]
    for kind, F in (("bf16", 320), ("int8", 704), ("int4", 1408)):
        errs.append(_gmm_case(
            f"{kind} edge groups {sizes} + 5 rows past them, D=328 F={F}", g, dev,
            rows=sum(sizes) + 5, D=328, F=F, S=len(sizes), kind=kind,
            gsz=torch.tensor(sizes, dtype=torch.int32, device=dev))[0])
    for kind, sz, D, F in (("int8", [64, 64], 256, 512),  # the last group ends at a chunk edge
                           ("int4", [37, 27, 0], 256, 512),  # ... and at T = 64
                           ("int8", [4] * 16, 512, 8192),  # wide: one split
                           ("bf16", [3, 0], 8192, 256)):  # deep over few blocks: several
        errs.append(_gmm_case(f"{kind} groups {sz} D={D} F={F}", g, dev, rows=sum(sz), D=D,
                              F=F, S=len(sz), kind=kind,
                              gsz=torch.tensor(sz, dtype=torch.int32, device=dev))[0])
    return max(errs)


def phase_gmm(dev):
    """Every K3 check of phase 2 (``--gmm`` runs these alone); returns K3's
    record with the largest error of them all, and the tiled layout's. The cases draw from their own
    generator, in this order, so that their inputs stay the same whatever
    other phases draw: a new case goes last."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    err = check_gmm(g, dev)
    rec, w16_err = check_gmm_mixtral(g, dev)
    rec["max_abs_err"] = max(rec["max_abs_err"], err, w16_err, check_gmm_deepseek(g, dev),
                             check_gmm_edges(g, dev))
    return rec, check_gmm_tiled(g, dev)


def check_paged_decode(g, dev):
    """K4 at Mixtral decode shapes: B=4, H=32 over Hkv=8, page 16, 32 pages
    per row (512 columns) from a 160-page pool, shuffled page table, rows of
    113, 200, 37 and 512 live keys, a hole mask, bf16."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Hkv, Dh, P, NP = 4, 32, 8, 128, MAX_COLS // PAGE, 160
    S = P * PAGE
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    pk = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    table = torch.randperm(NP, generator=g, device=dev)[:B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([113, 200, 37, 512], dtype=torch.int32, device=dev)
    holes = torch.rand(B, S, generator=g, device=dev) > 0.1
    run = lambda: fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)  # noqa: E731
    plain = lambda: fa.paged_flash_decode_plain(  # noqa: E731
        q, pk, pv, table, lengths, scale=Dh ** -0.5, pad_mask=holes
    )
    err = compare("paged_flash_decode B=4 H=32 Hkv=8 page=16 P=32 lengths=(113,200,37,512) holes",
                  run(), plain())
    live = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    valid = int((live & holes).sum())
    nbytes = (2 * valid * Hkv * Dh * 2  # live K and V rows read
              + int(lengths.sum())  # mask bytes of the live range
              + 2 * B * H * Dh * 2 + B * P * 4 + B * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * H * Dh * valid)
    # library yardstick: SDPA over a pre-gathered contiguous view, KV heads
    # expanded to H beforehand, with the same mask as a float bias
    idx = table.long()
    kc = pk[idx].reshape(B, S, Hkv, Dh).repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    vc = pv[idx].reshape(B, S, Hkv, Dh).repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    bias = torch.where(live & holes, 0.0, float("-inf")).to(torch.bfloat16)[:, None, None, :]
    qs = q[:, :, None, :]
    lib = lambda: F_.scaled_dot_product_attention(qs, kc, vc, attn_mask=bias)  # noqa: E731
    # K1 over the same rows gathered into a contiguous cache: the same
    # decode body without the page table, so the two times show what the
    # page-table reads cost
    kg = pk[idx].reshape(B, S, Hkv, Dh)
    vg = pv[idx].reshape(B, S, Hkv, Dh)
    q1, qpos = q[:, None], (lengths - 1)[:, None]
    contig = lambda: fa.flash_decode(q1, kg, vg, qpos, S, pad_mask=holes)  # noqa: E731
    contig_plain = lambda: fa.flash_decode_plain(  # noqa: E731
        q, kg, vg, lengths - 1, S, scale=Dh ** -0.5, pad_mask=holes)
    compare("flash_decode on the gathered rows vs paged_flash_decode", contig()[:, 0], run())
    say(f"[time] K4 vs K1 on the same rows ({valid} valid keys): paged ms="
        f"{cuda_ms(run):.4f} contiguous ms={cuda_ms(contig):.4f} contiguous plain_ms="
        f"{cuda_ms(contig_plain, iters=5, warmup=1):.4f}")
    return dict(
        name="paged_flash_decode", route="cuda",
        source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
        replaces="moe_infinity_tpu/ops/flash_attention.py:700",
        max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib),
        shape=f"B={B} H={H} Hkv={Hkv} page={PAGE} P={P} pool={NP} "
              f"{valid} valid keys, bf16 (library: SDPA on a pre-gathered view)",
    )


def _paged_case(g, dev, dtype, *, B, H, Hkv, P, NP, lengths, hole_share=0.1, dead=(),
                Dh=128):
    """Inputs of one K4 call over a shuffled page table: (q, pool_k, pool_v,
    table, lengths, holes); ``dead`` lists (row, first key, last key) ranges
    that are all holes."""
    S = P * PAGE
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    pk = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(dtype)
    pv = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(dtype)
    table = torch.randperm(NP, generator=g, device=dev)[:B * P].reshape(B, P).to(torch.int32)
    holes = torch.rand(B, S, generator=g, device=dev) > hole_share
    for row, lo, hi in dead:
        holes[row, lo:hi] = False
    return q, pk, pv, table, torch.tensor(lengths, dtype=torch.int32, device=dev), holes


def check_decode_long(g, dev):
    """K4 and K1 at long rows, where the byte bound means something: B=4,
    H=32 over Hkv=8, page 16, 512 pages a row (8192 columns) from a pool of
    2100 pages (69 MB each for K and V), rows of 8192, 6000, 3000 and 1000
    keys with holes, bf16."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Hkv, Dh, P, NP = 4, 32, 8, 128, 512, 2100
    S = P * PAGE
    q, pk, pv, table, lengths, holes = _paged_case(
        g, dev, torch.bfloat16, B=B, H=H, Hkv=Hkv, P=P, NP=NP,
        lengths=[8192, 6000, 3000, 1000])
    run = lambda: fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)  # noqa: E731
    plain = lambda: fa.paged_flash_decode_plain(  # noqa: E731
        q, pk, pv, table, lengths, scale=Dh ** -0.5, pad_mask=holes)
    err = compare(f"paged_flash_decode long rows B={B} H={H} Hkv={Hkv} page={PAGE} P={P} "
                  f"lengths=(8192,6000,3000,1000) holes", run(), plain())
    live = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    valid = int((live & holes).sum())
    nbytes = (2 * valid * Hkv * Dh * 2 + int(lengths.sum())
              + 2 * B * H * Dh * 2 + B * P * 4 + B * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * H * Dh * valid)
    idx = table.long()
    kg = pk[idx].reshape(B, S, Hkv, Dh)
    vg = pv[idx].reshape(B, S, Hkv, Dh)
    q1, qpos = q[:, None], (lengths - 1)[:, None]
    contig = lambda: fa.flash_decode(q1, kg, vg, qpos, S, pad_mask=holes)  # noqa: E731
    contig_plain = lambda: fa.flash_decode_plain(  # noqa: E731
        q, kg, vg, lengths - 1, S, scale=Dh ** -0.5, pad_mask=holes)
    compare("flash_decode on the gathered long rows vs paged_flash_decode", contig()[:, 0], run())
    rep = H // Hkv
    kc = kg.repeat_interleave(rep, dim=2).transpose(1, 2)
    vc = vg.repeat_interleave(rep, dim=2).transpose(1, 2)
    bias = torch.where(live & holes, 0.0, float("-inf")).to(torch.bfloat16)[:, None, None, :]
    qs = q[:, :, None, :]
    lib = lambda: F_.scaled_dot_product_attention(qs, kc, vc, attn_mask=bias)  # noqa: E731
    say(f"[time] long rows ({valid} valid keys, {2 * valid * Hkv * Dh * 2 / 1e6:.1f} MB of K and V): "
        f"paged_flash_decode ms={cuda_ms(run):.4f} flash_decode on the gathered rows ms="
        f"{cuda_ms(contig):.4f} plain_ms={cuda_ms(plain, iters=5, warmup=1):.4f} "
        f"flash_decode plain_ms={cuda_ms(contig_plain, iters=5, warmup=1):.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) library_ms={cuda_ms(lib):.4f} (SDPA on a pre-gathered "
        f"view, KV heads expanded beforehand)")
    return err


def check_decode_edges(g, dev, Dh=128):
    """The decode body where its split plan has edges: a row of 0 live keys
    beside a long one, four splits that lie wholly in holes, a live length
    that is no multiple of the tile; rep 1, 2, 4 and 8; bf16 and f32; through
    K4 and, on the gathered rows, through K1; at head dim ``Dh``."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, Hkv, P, NP = 3, 2, 64, 200
    S = P * PAGE
    errs = []
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-3)):
        for rep in (1, 2, 4, 8):
            q, pk, pv, table, lengths, holes = _paged_case(
                g, dev, dtype, B=B, H=Hkv * rep, Hkv=Hkv, P=P, NP=NP,
                lengths=[0, 1000, 333], dead=[(1, 128, 384)], Dh=Dh)
            kc, ns = fa._decode_splits(B * Hkv, S)
            if not (ns > 6 and kc * 2 <= 128 and 384 <= kc * ns):
                raise AssertionError(f"the plan ({kc}, {ns}) leaves no split wholly in holes")
            name = (f"Dh={Dh} rep={rep} {str(dtype).split('.')[-1]} lengths=(0,1000,333), "
                    "keys 128-383 of row 1 holes")
            want = fa.paged_flash_decode_plain(q, pk, pv, table, lengths, scale=Dh ** -0.5,
                                               pad_mask=holes)
            got = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)
            errs.append(compare(f"paged_flash_decode edges {name}", got, want, tol))
            idx = table.long()
            got1 = fa.flash_decode(q[:, None], pk[idx].reshape(B, S, Hkv, Dh),
                                   pv[idx].reshape(B, S, Hkv, Dh), (lengths - 1)[:, None], S,
                                   pad_mask=holes)[:, 0]
            errs.append(compare(f"flash_decode edges {name}", got1, want, tol))
            if not bool((got[0] == 0).all() and (got1[0] == 0).all()):
                raise AssertionError("a row of 0 live keys must give 0")
    return max(errs)


def check_attend_rows(g, dev, Dh=128):
    """K2's few-row route (the decode body with a bias, per-row positions and
    p rounded to V's type): every bias broadcast form, causal=False, a row
    with no valid key, T * rep = 4 and 8 query rows per kv head, bf16 and f32,
    at head dim ``Dh``."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, Hkv, rep, S = 3, 2, 4, 200
    key = "flash_attend" if Dh == 128 else f"flash_attend_dh{Dh}"
    H = Hkv * rep
    errs = []
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-3)):
        for T in (1, 2):
            forms = {"B11S": (B, 1, 1, S), "1H1S": (1, H, 1, S), "11TS": (1, 1, T, S),
                     "BHTS": (B, H, T, S), "none": None}
            for form, shape in forms.items():
                q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
                k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
                v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
                pos = (70 + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
                bias = torch.randn(*shape, generator=g, device=dev) if shape else None
                mask = torch.rand(B, S, generator=g, device=dev) > 0.2
                mask[1] = False  # row 1 has no valid key
                causal = form == "none"
                kw = dict(causal=causal, bias=bias, pad_mask=mask)
                before = fa.LAUNCHES[key]
                got = fa.flash_attend(q, k, v, pos, 150, **kw)
                if fa.LAUNCHES[key] != before + 1:
                    raise AssertionError("flash_attend must count one launch")
                want = fa.flash_attend_plain(q, k, v, pos, 150, scale=Dh ** -0.5, **kw)
                errs.append(compare(
                    f"flash_attend rows Dh={Dh} T={T} rep={rep} {str(dtype).split('.')[-1]} bias={form} "
                    f"causal={causal}, row 1 empty", got, want, tol))
                if not bool((got[1] == 0).all()):
                    raise AssertionError("flash_attend: a row with no valid key must give 0")
    return max(errs)


# Switch-large-128 (bench.py SWITCH_LARGE_128_SPEC): its attention is K2 at
# head dim 64 with a T5 bias; its experts run through K3 at top-1
SWITCH_LARGE_128 = dict(
    vocab_size=32128, d_model=1024, d_kv=64, d_ff=4096, num_heads=16,
    num_encoder_layers=24, num_decoder_layers=24,
    encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=128, expert_capacity=64, rel_buckets=32,
    rel_max_distance=128, rms_eps=1e-6, tie_embeddings=True,
    is_gated=False, dense_act_gelu=False, decoder_start_token_id=0,
)
SW_BATCH, SW_PROMPT, SW_TOKENS = 32, 16, 64  # bench.py's switch presets: batch 32
SW_CAP = 128  # the decoder cache's capacity for 64 new tokens (_bucket_len(65))
SWITCH_KERNELS = ("flash_attend_dh64", "gmm")


def _switch_attention_case(g, dev, dtype, label):
    """Inputs of K2 at one of Switch's three shapes, B=32 H=16 Dh=64, with
    the bias the model builds there: (q, k, v, positions, kv_len, causal,
    bias, live keys per row). ``encoder16``/``encoder64``: T = S, the T5
    table gathered bidirectionally plus the pad bias (finfo.min) of rows 16,
    12, 9 and 5 keys long (of 16; of 64: 64, 48, 36, 20), ``[B, 16, T, T]``;
    ``self``: the last decode step of 64 (position 64 over a cache of 128,
    causal), the unidirectional T5 bias ``[1, 16, 1, 128]``; ``cross``: one
    query over the 16 encoder states, the pad bias ``[B, 1, 1, 16]``."""
    from moe_infinity_tpu_torch.models.layers import t5_position_bias

    B, H, Dh = SW_BATCH, 16, 64
    table = torch.randn(32, H, generator=g, device=dev) * 0.5
    if label.startswith("encoder"):
        T = S = int(label[len("encoder"):])
    else:
        T, S = 1, (SW_CAP if label == "self" else SW_PROMPT)
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    cols = torch.arange(S, device=dev)
    if label == "self":
        pos = torch.full((B, 1), SW_TOKENS, dtype=torch.int32, device=dev)
        bias = t5_position_bias(table, pos[0], cols.to(torch.int32), False)
        return q, k, v, pos, S, True, bias, torch.full((B,), SW_TOKENS + 1, device=dev)
    lens = torch.tensor([S, S * 3 // 4, S * 9 // 16, S * 5 // 16], device=dev).repeat(B // 4)
    pad = torch.where(cols[None, :] < lens[:, None], 0.0, torch.finfo(torch.float32).min)
    pad = pad[:, None, None, :]
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
    if label == "cross":
        return q, k, v, pos, S, False, pad, lens
    bias = t5_position_bias(table, pos[0], pos[0], True) + pad
    return q, k, v, pos, S, False, bias, lens


def check_switch_attention(g, dev):
    """K2 at head dim 64 in the three shapes of Switch-large-128's path
    (``_switch_attention_case``), bf16 and f32, scale 1.0 (T5 attention is
    unscaled), against its plain version; bf16 timed against its byte bound
    and SDPA with an equivalent float mask. Returns the record of the
    decoder's self-attention shape (24 of the 48 launches of every decode
    step) with the largest error of all."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    errs, recs = [], {}
    for label in ("encoder16", "encoder64", "self", "cross"):
        for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-3)):
            q, k, v, pos, kv_len, causal, bias, lens = _switch_attention_case(g, dev, dtype, label)
            kw = dict(scale=1.0, causal=causal, bias=bias)
            before = fa.LAUNCHES["flash_attend_dh64"]
            run = lambda: fa.flash_attend(q, k, v, pos, kv_len, **kw)  # noqa: E731
            plain = lambda: fa.flash_attend_plain(q, k, v, pos, kv_len, **kw)  # noqa: E731
            got = run()
            if fa.LAUNCHES["flash_attend_dh64"] != before + 1:
                raise AssertionError("flash_attend at Dh 64 must count one launch of its own")
            name = (f"flash_attend Dh=64 Switch {label} B={q.shape[0]} T={q.shape[1]} "
                    f"S={k.shape[1]} bias {list(bias.shape)} {str(dtype).split('.')[-1]}")
            errs.append(compare(name, got, plain(), tol))
            if dtype != torch.bfloat16:
                continue
            B, T, H, Dh = q.shape
            S = k.shape[1]
            live = int(lens.sum())  # keys of a row that count, over the rows
            nbytes = (2 * B * T * H * Dh * 2 + 2 * live * H * Dh * 2  # q, out, live K and V
                      + bias.numel() * 4 + B * T * 4)
            b_ms, b_by = bound_ms(nbytes, 4 * T * H * Dh * live)
            key = torch.arange(S, device=dev)
            ok = key[None, None, :] <= pos[:, :, None] if causal else torch.ones(
                B, T, S, dtype=torch.bool, device=dev)
            fmask = torch.where(ok[:, None], bias.float(), float("-inf")).to(torch.bfloat16)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = lambda: F_.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=fmask, scale=1.0)
            recs[label] = dict(
                name="flash_attend_dh64", route="cuda",
                source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
                replaces="moe_infinity_tpu/ops/flash_attention.py:81",
                max_abs_err=0.0, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib),
                shape=f"Switch {label}: B={B} T={T} H={H} Dh={Dh} S={S} bias "
                      f"{list(bias.shape)} bf16 (library: SDPA, the bias and masks as a "
                      f"float mask)",
            )
            say(f"[time] flash_attend Dh=64 Switch {label}: {json.dumps(recs[label])}")
    errs.append(check_attend_rows(g, dev, Dh=64))
    rec = recs["self"]
    rec["max_abs_err"] = max(errs)
    return rec


def check_decode_dh64(g, dev):
    """K1 and K4 at head dim 64 (on no path of Switch, whose attention all
    carries a bias; they share the decode body with K2's few-row route): K1
    at Switch's decode shape without the bias, K4 over a page pool, bf16
    and f32, the split plan's edges; bf16 timed. Returns the largest error."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    errs = []
    B, H, Dh, S, step = SW_BATCH, 16, 64, SW_CAP, SW_TOKENS
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-3)):
        q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(dtype)
        k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
        v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
        pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
        before = fa.LAUNCHES["flash_decode_dh64"]
        run = lambda: fa.flash_decode(q, k, v, pos, S, scale=1.0)  # noqa: E731
        plain = lambda: fa.flash_decode_plain(q[:, 0], k, v, pos[:, 0], S, scale=1.0)  # noqa: E731
        got = run()[:, 0]
        if fa.LAUNCHES["flash_decode_dh64"] != before + 1:
            raise AssertionError("flash_decode at Dh 64 must count one launch of its own")
        errs.append(compare(f"flash_decode Dh=64 B={B} H={H} S={S} ({step + 1} live) "
                            f"{str(dtype).split('.')[-1]}", got, plain(), tol))
        if dtype == torch.bfloat16:
            live = step + 1
            mask = torch.full((B, 1, 1, S), float("-inf"), device=dev, dtype=dtype)
            mask[..., :live] = 0
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = lambda: F_.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, scale=1.0)
            b_ms, b_by = bound_ms(2 * B * H * Dh * 2 + 2 * B * live * H * Dh * 2 + B * 4,
                                  4 * B * H * live * Dh)
            say(f"[time] flash_decode Dh=64 (B={B} H={H} S={S}, {live} live keys, bf16): "
                f"ms={cuda_ms(run):.5f} plain_ms={cuda_ms(plain):.4f} bound_ms={b_ms:.6f} "
                f"({b_by}) library_ms={cuda_ms(lib):.5f} (SDPA)")
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-3)):
        Hkv, P, NP = 8, 32, 160
        q, pk, pv, table, lengths, holes = _paged_case(
            g, dev, dtype, B=4, H=32, Hkv=Hkv, P=P, NP=NP, lengths=[113, 200, 37, 512], Dh=Dh)
        before = fa.LAUNCHES["paged_flash_decode_dh64"]
        run = lambda: fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)  # noqa: E731
        plain = lambda: fa.paged_flash_decode_plain(  # noqa: E731
            q, pk, pv, table, lengths, scale=Dh ** -0.5, pad_mask=holes)
        got = run()
        if fa.LAUNCHES["paged_flash_decode_dh64"] != before + 1:
            raise AssertionError("paged_flash_decode at Dh 64 must count one launch of its own")
        errs.append(compare(f"paged_flash_decode Dh=64 B=4 H=32 Hkv={Hkv} page={PAGE} P={P} "
                            f"lengths=(113,200,37,512) holes {str(dtype).split('.')[-1]}",
                            got, plain(), tol))
        if dtype == torch.bfloat16:
            live = torch.arange(P * PAGE, device=dev)[None, :] < lengths[:, None]
            valid = int((live & holes).sum())
            b_ms, b_by = bound_ms(2 * valid * Hkv * Dh * 2 + int(lengths.sum())
                                  + 2 * 4 * 32 * Dh * 2 + 4 * P * 4 + 16, 4 * 32 * Dh * valid)
            # SDPA on a pre-gathered view, KV heads expanded beforehand, as for K4 at 128
            idx = table.long()
            kc = pk[idx].reshape(4, P * PAGE, Hkv, Dh).repeat_interleave(4, dim=2).transpose(1, 2)
            vc = pv[idx].reshape(4, P * PAGE, Hkv, Dh).repeat_interleave(4, dim=2).transpose(1, 2)
            fmask = torch.where(live & holes, 0.0, float("-inf")).to(dtype)[:, None, None, :]
            qs = q[:, :, None, :]
            lib = lambda: F_.scaled_dot_product_attention(qs, kc, vc, attn_mask=fmask)  # noqa: E731
            say(f"[time] paged_flash_decode Dh=64 (Mixtral's rows, {valid} valid keys, bf16): "
                f"ms={cuda_ms(run):.5f} plain_ms={cuda_ms(plain):.4f} bound_ms={b_ms:.6f} "
                f"({b_by}) library_ms={cuda_ms(lib):.5f} (SDPA on a pre-gathered view)")
    errs.append(check_decode_edges(g, dev, Dh=64))
    return max(errs)


def check_gmm_switch(g, dev):
    """K3 at Switch-large-128's int4 shapes, top-1 over 128 experts, D=1024
    F=4096: the decode layer (32 rows) and the prefill layer (32 x 16 = 512
    rows), gate and down, timed. Returns the largest error."""
    E, D, F = 128, 1024, 4096
    errs, layer = [], {}
    for label, rows in (("decode", SW_BATCH), ("prefill", SW_BATCH * SW_PROMPT)):
        gid, gsz, active = _routed_rows(g, dev, rows, E, K=1)
        for role, (d_in, f_out) in (("gate", (D, F)), ("down", (F, D))):
            err, t = _gmm_case(
                f"Switch int4 {label} {role} rows={rows} D={d_in} F={f_out} S={E} "
                f"active={active}", g, dev, rows=rows, D=d_in, F=f_out, S=E, kind="int4",
                gid=gid, gsz=gsz, active=active, time_it=True)
            errs.append(err)
            b_ms, b_by = bound_ms(t["nbytes"], t["flops"])
            say(f"[time] gmm Switch int4 {label} {role} ({rows} rows, {active} experts): "
                f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} bound_ms={b_ms:.5f} ({b_by})")
            layer.setdefault(label, []).append((t, b_ms))
    for label, parts in layer.items():
        (tg, _), (td, _) = parts
        b_ms, b_by = bound_ms(tg["nbytes"] + td["nbytes"], tg["flops"] + td["flops"])
        say(f"[time] gmm Switch {label} MoE layer (gate + down, packed int4): "
            f"ms={tg['ms'] + td['ms']:.4f} plain_ms={tg['plain_ms'] + td['plain_ms']:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms=None (no PyTorch call takes packed int4 "
            f"with scales)")
    return max(errs)


def check_f1_replay(dev):
    """Queue-3 fault F1, repaired: a graph of a split K3 call is captured;
    a second graph of the same backend, whose warm-up needs more split
    scratch, grows the capture stream's workspace; the allocators' caches
    are emptied and a buffer is allocated and filled; the first graph then
    replays. Its output must equal the eager call's bit for bit, every
    ticket counter (the live ones and the outgrown ones) must read 0, the
    filled buffer must be untouched, and the outgrown workspace must still
    be held (``_build.grown``)."""
    from moe_infinity_tpu_torch.ops import _build
    from moe_infinity_tpu_torch.ops import gmm as gm
    from moe_infinity_tpu_torch.runtime.graphs import CudaGraphBackend, GraphCache

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    S, D, F = 8, 4096, 4096
    w = (torch.randn(S, D, F, generator=g, device=dev) * 0.02).to(torch.bfloat16)

    def sizes(rows):
        return torch.full((S,), rows // S, dtype=torch.int32, device=dev)

    small, large = sizes(8), sizes(256)
    for rows in (8, 256):
        if gm._gmm_plan(rows, S, D, F).splits < 2:
            raise AssertionError(f"F1 check: a call of {rows} rows must split its reduction")
    cache = GraphCache(CudaGraphBackend(dev), dev)
    key = (dev, cache.backend.stream.cuda_stream)
    x8 = torch.randn(8, D, generator=g, device=dev).to(torch.bfloat16)
    x256 = torch.randn(256, D, generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        want = gm.gmm(x8, w, small)
        (first,) = cache.run("small", lambda x: (gm.gmm(x, w, small),), {"x": x8}, [w, small])
        first = first.clone()
        old = _build._workspaces[key]
        old_ptr, old_n = old.data_ptr(), old.numel()
        del old
        cache.run("large", lambda x: (gm.gmm(x, w, large),), {"x": x256}, [w, large])
        grew = _build._workspaces[key].numel()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        filler = torch.full((old_n,), 7.0, device=dev)
        (again,) = cache.run("small", lambda x: (gm.gmm(x, w, small),), {"x": x8}, [w, small])
        torch.cuda.synchronize()
    held = any(t.data_ptr() == old_ptr for t in _build._retired)
    counters = [t for (d, _), t in _build._tickets.items() if d == dev] + [
        t for t in _build._retired if t.dtype == torch.int32]
    zero = all(int(t.abs().sum()) == 0 for t in counters)
    untouched = bool((filler == 7.0).all())
    same = torch.equal(again, want) and torch.equal(first, want)
    if (cache.captures, cache.recaptures, cache.replays) != (2, 0, 3):
        raise AssertionError(f"F1 check: two captures and three replays expected ({cache.stats()})")
    say(f"[check] F1: split K3 graph replayed after a later warm-up grew the capture stream's "
        f"workspace from {old_n} to {grew} f32 and the caches were emptied: output "
        f"{'equal to eager' if same else 'DIFFERS'}, ticket counters "
        f"{'0' if zero else 'NOT 0'}, outgrown workspace {'held' if held else 'FREED'}, "
        f"buffer allocated after it {'untouched' if untouched else 'OVERWRITTEN'}")
    if not (same and zero and held and untouched and grew > old_n):
        raise AssertionError("F1: a graph replayed over a buffer a later warm-up outgrew")


def _mla_inputs(g, dev, *, B, H, S, lengths, R=512, P=64):
    """f32 queries and caches of one K5 call, the caches also in bf16, the
    rows' live lengths and a mask with 10% holes."""
    q_lat = torch.randn(B, H, R, generator=g, device=dev)
    q_pe = torch.randn(B, H, P, generator=g, device=dev)
    c32 = torch.randn(B, S, R, generator=g, device=dev)
    kpe32 = torch.randn(B, S, P, generator=g, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    holes = torch.rand(B, S, generator=g, device=dev) > 0.1
    return dict(q_lat=q_lat, q_pe=q_pe, c32=c32, kpe32=kpe32, c=c32.to(torch.bfloat16),
                kpe=kpe32.to(torch.bfloat16), lengths=lengths, holes=holes)


def _mla_check(what, a, *, scale, dtype=torch.bfloat16, mask=None, q_mult=1.0,
               library=False, tol=TOL):
    """One K5 check: the kernel against its plain version on the same inputs
    (``q_mult`` folds the scale into q), its time and its bound, and with
    ``library`` the SDPA yardstick. Returns a dict of the readings."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    c, kpe = (a["c"], a["kpe"]) if dtype == torch.bfloat16 else (a["c32"], a["kpe32"])
    q_lat, q_pe = a["q_lat"] * q_mult, a["q_pe"] * q_mult
    mask = a["holes"] if mask is None else mask
    pos, lengths = a["lengths"] - 1, a["lengths"]
    (B, H, R), S, P = q_lat.shape, c.shape[1], q_pe.shape[-1]
    run = lambda: fa.mla_flash_decode(  # noqa: E731
        q_lat, q_pe, c, kpe, pos, S, scale=scale, pad_mask=mask)
    plain = lambda: fa.mla_flash_decode_plain(  # noqa: E731
        q_lat, q_pe, c, kpe, pos, S, scale=scale, pad_mask=mask)
    out = run()
    err = compare(f"{what} {str(dtype).split('.')[-1]} caches", out, plain(), tol)
    live = torch.arange(S, device=c.device)[None, :] < lengths[:, None]
    valid = int((live & mask).sum())
    nbytes = (valid * (R + P) * c.element_size()  # live latent and rope-key rows
              + int(lengths.sum()) + B * 4  # mask bytes of the live range, positions
              + B * H * (R + P) * 4 + B * H * R * 4)  # f32 q in, f32 out
    b_ms, b_by = bound_ms(nbytes, 2 * H * valid * (2 * R + P))
    r = dict(out=out, max_abs_err=err, ms=cuda_ms(run), bound_ms=b_ms, bound_by=b_by,
             valid=valid)
    line = (f"[time] {what} {str(dtype).split('.')[-1]} caches ({valid} valid keys, "
            f"{nbytes / 1e6:.2f} MB): ms={r['ms']:.5f} bound_ms={b_ms:.5f} ({b_by})")
    if dtype == torch.bfloat16:
        line += f" plan(kc, splits)={fa._mla_splits(B, H, min(S, int(lengths.max())))}"
    if library:
        # one SDPA call on q = [q_lat | q_pe], the shared key [c | k_pe]
        # expanded over the heads, value c, the same mask as a float bias,
        # all in the caches' type
        qs = torch.cat([q_lat, q_pe], -1).to(dtype)[:, :, None, :]
        ks = torch.cat([c, kpe], -1).to(dtype)[:, None].expand(B, H, S, R + P)
        vs = c.to(dtype)[:, None].expand(B, H, S, R)
        bias = torch.where(live & mask, 0.0, float("-inf")).to(dtype)[:, None, None, :]
        lib = lambda: F_.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=bias, scale=scale)
        torch.cuda.synchronize()
        gap = (lib()[:, :, 0].float() - out).abs().max().item()
        r["library_ms"] = cuda_ms(lib)
        r["plain_ms"] = cuda_ms(plain, iters=5, warmup=1)
        line += (f" plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA over "
                 f"the key expanded to {H} heads; max_abs_diff={gap:.3e}, q and p "
                 f"{str(dtype).split('.')[-1]} there, reported, not held)")
    say(line)
    return r


def check_mla_decode(g, dev):
    """K5 at DeepSeek-V2-Lite's batcher decode step: B=4, H=16, R=512, P=64,
    bf16 caches of 512 columns, rows of 113, 200, 37 and 512 live keys with a
    hole mask (K4's case); once more with f32 caches and the folded scale
    1.0; a row with no valid key gives 0. Returns K5's record."""
    B, H, S = SLOTS, DSV2_LITE["num_heads"], MAX_COLS
    scale = (DSV2_LITE["qk_nope_head_dim"] + 64) ** -0.5
    a = _mla_inputs(g, dev, B=B, H=H, S=S, lengths=[113, 200, 37, 512])
    what = "mla_flash_decode B=4 H=16 R=512 P=64 S=512 lengths=(113,200,37,512) holes"
    r = _mla_check(what, a, scale=scale, library=True)
    err = max(r["max_abs_err"], _mla_check(f"{what} scale=1.0", a, scale=1.0, q_mult=scale,
                                           dtype=torch.float32, library=True)["max_abs_err"])
    empty = a["holes"].clone()
    empty[2] = False
    e = _mla_check(f"{what}, row 2 without a valid key", a, scale=scale, mask=empty)
    if not bool((e["out"][2] == 0).all()):
        raise AssertionError("mla_flash_decode: a row with no valid key must give 0")
    return dict(
        name="mla_flash_decode", route="cuda",
        source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
        replaces="moe_infinity_tpu/ops/flash_attention.py:507",
        max_abs_err=max(err, e["max_abs_err"]), ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=f"B={B} H={H} R=512 P=64 S={S}, {r['valid']} valid keys, bf16 caches "
              f"(library: SDPA over the key expanded to {H} heads)",
    )


def check_mla_long(g, dev):
    """K5 at long rows, where the byte bound means something: B=4, S=8192,
    rows of 8192, 6000, 3000 and 1000 live keys with 10% holes, H=16."""
    a = _mla_inputs(g, dev, B=4, H=16, S=8192, lengths=[8192, 6000, 3000, 1000])
    return _mla_check("mla_flash_decode long rows B=4 H=16 S=8192 lengths=(8192,6000,3000,1000) "
                      "holes", a, scale=192 ** -0.5, library=True)


def check_mla_heads(g, dev):
    """K5 at the H=128 that DeepSeek-V2 and V3 publish, at the V2-Lite rows."""
    a = _mla_inputs(g, dev, B=SLOTS, H=128, S=MAX_COLS, lengths=[113, 200, 37, 512])
    return _mla_check("mla_flash_decode H=128 B=4 S=512 lengths=(113,200,37,512) holes", a,
                      scale=192 ** -0.5, library=True)


def check_mla_capacity(g, dev):
    """K5 as ``decode_scan`` calls it (phase 41): a cache of SCAN_CAP (256)
    columns, rows of 17, 24, 33 and 48 live keys (phase 41's DeepSeek rows),
    B=4 H=16, bf16, no holes; planned from the capacity (its ``kv_len`` a
    0-d device tensor: most splits lie past every row's live keys) and from
    the live length, each against the plain version and timed."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, S = SCAN_BATCH, DSV2_LITE["num_heads"], SCAN_CAP
    a = _mla_inputs(g, dev, B=B, H=H, S=S, lengths=[17, 24, 33, 48])
    scale = (DSV2_LITE["qk_nope_head_dim"] + 64) ** -0.5
    pos, live = a["lengths"] - 1, 48
    args = (a["q_lat"], a["q_pe"], a["c"], a["kpe"], pos)
    step = torch.tensor(S - 1, dtype=torch.int32, device=dev)  # any device value: not read
    want = fa.mla_flash_decode_plain(*args, S, scale=scale)
    runs = {"capacity": lambda: fa.mla_flash_decode(*args, step, scale=scale),
            "live": lambda: fa.mla_flash_decode(*args, live, scale=scale)}
    valid = int(a["lengths"].sum())
    nbytes = valid * (512 + 64) * 2 + B * 4 + B * H * (512 + 64) * 4 + B * H * 512 * 4
    b_ms, b_by = bound_ms(nbytes, 2 * H * valid * (2 * 512 + 64))
    r = {"bound_ms": b_ms, "max_abs_err": 0.0}
    for plan, run in runs.items():
        r["max_abs_err"] = max(r["max_abs_err"], compare(f"K5 {plan} plan, decode_scan rows",
                                                         run(), want))
        r[plan] = cuda_ms(run)
    r["plain_ms"] = cuda_ms(lambda: fa.mla_flash_decode_plain(*args, S, scale=scale), iters=5,
                            warmup=1)
    # one SDPA call: q = [q_lat | q_pe], the shared key expanded over the heads,
    # value c, the live keys as a float mask
    import torch.nn.functional as F_

    qs = torch.cat([a["q_lat"], a["q_pe"]], -1).to(torch.bfloat16)[:, :, None, :]
    ks = torch.cat([a["c"], a["kpe"]], -1)[:, None].expand(B, H, S, 512 + 64)
    vs = a["c"][:, None].expand(B, H, S, 512)
    keep = torch.arange(S, device=dev)[None, :] < a["lengths"][:, None]
    bias = torch.where(keep, 0.0, float("-inf")).to(torch.bfloat16)[:, None, None, :]
    r["library_ms"] = cuda_ms(lambda: F_.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=bias, scale=scale))
    say(f"[time] mla_flash_decode decode_scan rows B={B} H={H} S={S} lengths=(17,24,33,48) "
        f"({valid} keys): capacity plan (kc, splits)={fa._mla_splits(B, H, S)} "
        f"ms={r['capacity']:.5f}; live plan {fa._mla_splits(B, H, live)} ms={r['live']:.5f}; "
        f"bound_ms={b_ms:.5f} ({b_by}) plain_ms={r['plain_ms']:.4f} library_ms="
        f"{r['library_ms']:.4f} (SDPA over the key expanded to {H} heads)")
    return r


# (R, P, H) of K5's padded instance in phase 2: every R that is a multiple of
# 128 below 512, P below 64 (20: a 40-byte bf16 rope row, copied by element),
# a head count that leaves a head group part full
MLA_WIDTHS = ((128, 32, 16), (256, 32, 40), (256, 64, 16), (384, 64, 16), (512, 20, 16))
MLA_PAD_SHAPE = (256, 32)  # the widths phase 46's model serves, whose case K5's record times


def check_mla_widths(g, dev):
    """K5's zero-padded instance (``csrc/mla_pad.cu``) at each of
    ``MLA_WIDTHS``: V2-Lite's batcher rows (113, 200, 37 and 512 live keys
    with holes) in bf16 caches (2e-2) and f32 (2e-3), and a row without a
    valid key (0), each timed beside its bound and SDPA with the key
    expanded. Returns the ``mla_flash_decode_pad`` record."""
    B, S = SLOTS, MAX_COLS
    rec, errs = None, []
    for R, P, H in MLA_WIDTHS:
        a = _mla_inputs(g, dev, B=B, H=H, S=S, lengths=[113, 200, 37, 512], R=R, P=P)
        scale = (R // 4 + P) ** -0.5
        what = f"mla_flash_decode_pad B={B} H={H} R={R} P={P} S={S} lengths=(113,200,37,512) holes"
        r = _mla_check(what, a, scale=scale, library=True)
        errs += [r["max_abs_err"], _mla_check(what, a, scale=scale, dtype=torch.float32,
                                              tol=2e-3)["max_abs_err"]]
        empty = a["holes"].clone()
        empty[2] = False
        e = _mla_check(f"{what}, row 2 without a valid key", a, scale=scale, mask=empty)
        if not bool((e["out"][2] == 0).all()):
            raise AssertionError("mla_flash_decode_pad: a row with no valid key must give 0")
        errs.append(e["max_abs_err"])
        if (R, P) == MLA_PAD_SHAPE:
            rec = dict(
                name="mla_flash_decode_pad", route="cuda",
                source="moe_infinity_tpu_torch/csrc/mla_pad.cu",
                replaces="moe_infinity_tpu/ops/flash_attention.py:507", ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"],
                shape=f"B={B} H={H} R={R} P={P} S={S}, {r['valid']} valid keys, bf16 caches "
                      f"(library: SDPA over the key expanded to {H} heads)",
            )
        del a, r, e
    rec["max_abs_err"] = max(errs)
    return rec


def phase_mla(dev):
    """Every K5 check of phase 2 (``--mla`` runs these alone); returns K5's
    record with the largest error of them all. The cases draw from their own
    generator, in this order, so that their inputs stay the same whatever
    other phases draw: a new case goes last. Also returns the padded
    instance's record."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rec = check_mla_decode(g, dev)
    for r in (check_mla_long(g, dev), check_mla_heads(g, dev), check_mla_capacity(g, dev)):
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    return rec, check_mla_widths(g, dev)


def check_gmm_deepseek(g, dev):
    """K3 at one DeepSeek-V2-Lite decode MoE layer: gate, up and down over 24
    rows (4 tokens x top-6) routed over 64 experts, D=2048 F=1408, in bf16
    (11 column tiles) and packed int4 (704 stored columns: 5.5 tiles, the
    partial tile), all 64 groups passed uncompacted as the fused runner passes
    them; the bf16 case once more at group_offset 128 into a 3-layer pool."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    E, D, F, T, K = DSV2_LITE["num_experts"], 2048, 1408, SLOTS, DSV2_LITE["top_k"]
    rows = T * K
    flat = torch.stack([torch.randperm(E, generator=g, device=dev)[:K] for _ in range(T)]).reshape(-1)
    gsz = torch.zeros(E, dtype=torch.int32, device=dev)
    gsz.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    active = int((gsz > 0).sum())
    x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
    errs = []
    for kind, offset in (("bf16", 0), ("int4", 0), ("bf16", 2 * E)):
        w, sc = _layer_weights(g, dev, offset + E, D, F, kind)
        r = _check_layer(f"{kind} V2-Lite decode rows={rows} active={active} of {E} "
                         f"offset={offset}", x, w, sc, gsz, active, group_offset=offset,
                         packed=kind == "int4")
        errs.append(r["max_abs_err"])
        line = (f"[time] gmm DeepSeek-V2-Lite decode MoE layer (gate + up + down, {rows} rows "
                f"over {active} of {E} experts, {kind}, D={D} F={F}, group_offset={offset}): "
                f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}); {_layer_plans(x, w, gsz)}")
        if kind == "bf16" and offset == 0:
            # library yardstick where one PyTorch call computes the function:
            # bf16 weights without scales, for the layer and the gate alone
            gate = lambda: gm.gmm(x, w["gate"], gsz, None)  # noqa: E731
            gate_line = f"[time] gmm V2-Lite bf16 gate projection alone: ms={cuda_ms(gate):.4f} "
            if hasattr(torch, "_grouped_mm"):
                ends = torch.cumsum(gsz, 0).to(torch.int32)
                lib_gate = lambda: torch._grouped_mm(x, w["gate"], offs=ends)  # noqa: E731
                lib = lambda: [torch._grouped_mm(xin, w[n], offs=ends)  # noqa: E731
                               for n, xin in zip(ROLES, (x, x, r["a"]))]
                torch.cuda.synchronize()
                gap = (lib_gate().float() - gate().float()).abs().max().item()
                line += f" library_ms={cuda_ms(lib):.4f} (torch._grouped_mm x3, bf16 out)"
                gate_line += (f"library_ms={cuda_ms(lib_gate):.4f} (torch._grouped_mm, bf16 out; "
                              f"max_abs_diff={gap:.3e}, reported, not held)")
            else:
                line += " library_ms=None (this torch has no torch._grouped_mm)"
                gate_line += "library_ms=None (this torch has no torch._grouped_mm)"
            say(line)
            say(gate_line)
        else:
            say(line)
        del w, sc, r
        torch.cuda.empty_cache()
    return max(errs)


def _tiled_equal(label, x, w, wt, sc, gsz, tol=TOL, **kw):
    """Each role of one MoE layer on K3 over the pre-tiled weights ``wt``:
    bit-equal to the same call over the flat ``w`` (the same products in the
    same order) and held to ``gmm_plain`` within ``tol``. Returns the error."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    a = (torch.nn.functional.silu(gm.gmm(x, wt["gate"], gsz, sc["gate"], **kw))
         * gm.gmm(x, wt["up"], gsz, sc["up"], **kw)).to(x.dtype)
    err = 0.0
    for role, xin in zip(ROLES, (x, x, a)):
        got = gm.gmm(xin, wt[role], gsz, sc[role], **kw)
        flat = gm.gmm(xin, w[role], gsz, sc[role], **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, flat)
        say(f"[check] gmm tiled {label} {role} (tf {wt[role].shape[3]}, {wt[role].shape[1]} "
            f"slabs): bit-equal to the flat call: {same}")
        if not same:
            raise AssertionError(f"gmm tiled {label} {role}: differs from the flat call")
        err = max(err, compare(f"gmm tiled {label} {role}", got,
                               gm.gmm_plain(xin, wt[role], gsz, sc[role], **kw), tol))
    return err


def check_gmm_tiled(g, dev):
    """K3 over the pre-tiled layout [S, F/tf, D, tf] that JAX's
    ``stack_experts`` builds by default (``pack_tiled``'s slabs: tf 128 for
    V2-Lite's gate and up, 512 for down) and over gate and up in slabs of
    352, whose 128-column tiles read two slabs: V2-Lite's decode layer (24
    rows, all 64 groups passed) in bf16 at group offsets 0 and 128, int8
    and e4m3 with scales, bf16 with f32 rows (2e-3: the x rounding and the
    sums' order only), and a prefill of 512 rows over compacted groups; each
    role bit-equal to the flat call and held to the plain version. The bf16
    layer at offset 0 is timed over both layouts, beside its bound and
    ``torch._grouped_mm`` on the flat one, and over the slabs of 352.
    Returns the ``gmm_tiled`` record."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    E, K = DSV2_LITE["num_experts"], DSV2_LITE["top_k"]
    D, F = DSV2_LITE["hidden_size"], DSV2_LITE["moe_intermediate_size"]
    rows = SLOTS * K
    flat = torch.stack([torch.randperm(E, generator=g, device=dev)[:K]
                        for _ in range(SLOTS)]).reshape(-1)
    gsz = torch.zeros(E, dtype=torch.int32, device=dev)
    gsz.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    active = int((gsz > 0).sum())
    x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
    def pack(w, tf):  # slabs of tf where they divide the role's width, else the default
        return {r: gm.pack_tiled(w[r], tf if tf and w[r].shape[2] % tf == 0 else 0)
                for r in ROLES}

    errs, rec = [], None
    for kind, offset, tf in (("bf16", 0, 0), ("bf16", 2 * E, 352), ("int8", 0, 352),
                             ("fp8", 0, 352)):
        w, sc = _layer_weights(g, dev, offset + E, D, F, kind)
        wt = pack(w, tf)
        label = (f"{kind} V2-Lite decode rows={rows} active={active} of {E} offset={offset} "
                 f"tf={tf or 'default'}")
        errs.append(_tiled_equal(label, x, w, wt, sc, gsz, group_offset=offset))
        if kind == "bf16" and offset == 0:
            errs.append(_tiled_equal(f"{label} f32 rows", x.float(), w, wt, sc, gsz, tol=2e-3))
            t = _check_layer(f"tiled {label}", x, wt, sc, gsz, active)
            f = _check_layer(f"flat {label}", x, w, sc, gsz, active)
            lib, lib_txt = None, "None (this torch has no torch._grouped_mm)"
            if hasattr(torch, "_grouped_mm"):
                ends = torch.cumsum(gsz, 0).to(torch.int32)
                lib = cuda_ms(lambda: [torch._grouped_mm(xin, w[n], offs=ends)
                                       for n, xin in zip(ROLES, (x, x, t["a"]))])
                lib_txt = f"{lib:.4f} (torch._grouped_mm x3 on the flat layout, bf16 out)"
            t352 = _check_layer(f"tiled 352 {label}", x, pack(w, 352), sc, gsz, active)
            say(f"[time] gmm_tiled DeepSeek-V2-Lite decode MoE layer (gate + up + down, {rows} "
                f"rows over {active} of {E} experts, bf16, D={D} F={F}, tf "
                f"{'/'.join(str(wt[r].shape[3]) for r in ROLES)}): ms={t['ms']:.4f} flat "
                f"ms={f['ms']:.4f} (tiled/flat {t['ms'] / f['ms']:.3f}); gate and up in slabs of "
                f"352 ms={t352['ms']:.4f} ({t352['ms'] / f['ms']:.3f}); plain_ms="
                f"{t['plain_ms']:.4f} bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                f"library_ms={lib_txt}")
            rec = dict(
                name="gmm_tiled", route="cuda", source="moe_infinity_tpu_torch/csrc/gmm.cu",
                replaces="moe_infinity_tpu/ops/gmm.py:46", ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=lib,
                shape=f"one DeepSeek-V2-Lite decode MoE layer over the pre-tiled pool: gate + "
                      f"up + down, {rows} rows over {active} of {E} experts, bf16, D={D} F={F}",
            )
            del t, f, t352
        del w, wt, sc
        torch.cuda.empty_cache()
    # a prefill of 256 tokens x top-2: 512 rows over compacted groups
    gid, gsz512, active = _routed_rows(g, dev, 256, E)
    x512 = torch.randn(512, D, generator=g, device=dev).to(torch.bfloat16)
    w, sc = _layer_weights(g, dev, E, D, F, "bf16")
    wt = {r: gm.pack_tiled(w[r]) for r in ROLES}
    errs.append(_tiled_equal(f"bf16 V2-Lite prefill rows=512 active={active}", x512, w, wt,
                             sc, gsz512, group_ids=gid))
    del w, wt, sc
    torch.cuda.empty_cache()
    rec["max_abs_err"] = max(errs)
    return rec


def phase_kernels(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    check_f1_replay(dev)
    k2_err = check_flash_attend(g, dev)
    gmm_rec, tiled_rec = phase_gmm(dev)
    mla_rec, mla_pad_rec = phase_mla(dev)
    recs = [check_flash_decode(g, dev), check_flash_attend_chunk(g, dev), gmm_rec,
            check_paged_decode(g, dev), mla_rec, check_switch_attention(g, dev)]
    recs[1]["max_abs_err"] = max(recs[1]["max_abs_err"], k2_err, check_attend_rows(g, dev))
    long_err = check_decode_long(g, dev)
    edge_err = check_decode_edges(g, dev)  # through K4 and K1 alike
    dh64_err = check_decode_dh64(g, dev)  # K1 and K4 at head dim 64
    recs[0]["max_abs_err"] = max(recs[0]["max_abs_err"], long_err, edge_err, dh64_err)
    recs[3]["max_abs_err"] = max(recs[3]["max_abs_err"], long_err, edge_err, dh64_err)
    recs[2]["max_abs_err"] = max(recs[2]["max_abs_err"], check_gmm_switch(g, dev),
                                 check_gmm_dequant(g, dev))
    opt_errs = check_opt_attention(g, dev)  # OPT-66B's K1 and K2 shapes
    recs[0]["max_abs_err"] = max(recs[0]["max_abs_err"], opt_errs["flash_decode"])
    recs[1]["max_abs_err"] = max(recs[1]["max_abs_err"], opt_errs["flash_attend"])
    recs.append(check_gmm_fp8(dev))  # K3's e4m3 kind, from its own generator
    recs.append(check_stream_gather(dev))  # the port's own kernel, its own generator
    rep_errs = check_attention_rep67(dev)
    batcher_errs = check_batcher_attention(dev)  # per-row T5 bias (K2), per-row positions (K1)
    hd_errs, hd_recs = check_head_dims(dev)  # the padded instances, rep 16
    recs.extend(hd_recs.values())
    recs += [tiled_rec, mla_pad_rec]  # K3 over the pre-tiled pool, K5's padded instance
    for r in recs:
        r["max_abs_err"] = max(r["max_abs_err"], rep_errs.get(r["name"], 0.0),
                               batcher_errs.get(r["name"], 0.0), hd_errs.get(r["name"], 0.0))
    for r in recs:
        say(f"[time] {r['name']} ({r['shape']}): ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
    return recs


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def _requests(vocab, g, dev):
    B, T = len(SRC_LENS), max(SRC_LENS)
    ids = np.full((B, T), NLLB_54B["pad_token_id"], dtype=np.int64)
    mask = np.zeros((B, T), dtype=np.float32)
    body = torch.randint(3, vocab, (B, T), generator=g, device=dev).cpu().numpy()
    for i, n in enumerate(SRC_LENS):
        ids[i, :n] = body[i, :n]
        ids[i, n - 1] = 2  # eos closes each source
        mask[i, :n] = 1.0
    return ids, mask


def phase_main_path(dev, extra=None, scan=None):
    """Phase 3 (and with ``extra``, phase 24 on its build: its launches go
    into ``extra``; with ``scan``, phase 41's NLLB part, into ``scan``)."""
    from moe_infinity_tpu_torch.models.nllb import NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = NllbSpec(**NLLB_54B)
    say(f"[main] NLLB-MoE-54B geometry, depth {spec.encoder_layers}+"
        f"{spec.decoder_layers} blocks, sparse_step {spec.encoder_sparse_step}, "
        f"bf16 compute, int4 experts, impl=pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, provider, g = _nllb_resident(dev)
    torch.cuda.synchronize()
    say(f"[main] weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"experts {provider.nbytes() / 1e9:.2f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ids, mask = _requests(spec.vocab_size, g, dev)
    base = torch.cuda.memory_allocated()
    runs = {}
    # the eager path first, for comparison; then the main path, each decode
    # step one replay of a CUDA graph (the counts returned are its own)
    for graphs in (False, True):
        tag = "graphs" if graphs else "eager"
        gen = Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer,
                               impl="pallas", graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        gen.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                     eos_token_id=None)  # warm-up at the timed shape: its capture
        torch.cuda.synchronize()
        st0 = gen.graph_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = gen.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                           eos_token_id=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st, gst = res.stats, gen.graph_stats()
        peak = torch.cuda.max_memory_allocated()
        say(f"[main] {tag}: sequences shape {res.sequences.shape}; first row "
            f"{res.sequences[0].tolist()}")
        say(f"[main] {tag}: encode_ms={st['encode_ms']:.3f} decode_ms_per_token="
            f"{st['decode_ms'] / NEW_TOKENS:.3f} tokens_per_s="
            f"{len(SRC_LENS) * NEW_TOKENS / (st['decode_ms'] / 1e3):.1f} "
            f"wall_s={wall:.3f} max_memory_allocated_gb={peak / 1e9:.2f} (weights "
            f"{base / 1e9:.2f}) graphs {json.dumps(gst)} (captures in the timed generate: "
            f"{gst.get('captures', 0) - st0.get('captures', 0)})")
        say(f"[main] {tag}: launches {json.dumps(counts)}")
        st3 = gen.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                           eos_token_id=None).stats
        say(f"[main] {tag}: a third request: encode_ms={st3['encode_ms']:.3f} "
            f"decode_ms_per_token={st3['decode_ms'] / NEW_TOKENS:.3f}")
        if res.sequences.shape != (len(SRC_LENS), NEW_TOKENS + 1):
            raise AssertionError(f"unexpected output shape {res.sequences.shape}")
        _require_launched(counts, NLLB_KERNELS, f"NLLB main path ({tag})")
        if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
            raise AssertionError("token ids out of range")
        if graphs and (gst["captures"] != 1 or gst["recaptures"]
                       or gst["replays"] != 2 * NEW_TOKENS
                       or gen.graph_stats()["captures"] != 1):
            raise AssertionError(f"graphs: one capture and a replay per step expected ({gst})")
        runs[tag] = res.sequences
        _profile_main_path(model, params, provider, ids, mask, gen, tag)
        del gen
        torch.cuda.empty_cache()
    same = np.array_equal(runs["graphs"], runs["eager"])
    say(f"[main] graphs against eager greedy tokens: {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("graph and eager tokens differ")
    # logits of one more step are finite
    logits = _first_step_logits(model, params, provider, ids, mask, "pallas")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    say(f"[main] first-step logits finite, shape {tuple(logits.shape)}")
    if extra is not None:
        extra["phase_s2s_batchers"] = _subphase(phase_s2s_batchers, dev,
                                                (model, params, provider))
    if scan is not None:
        scan["nllb"] = _subphase(phase_decode_scan, dev, "nllb",
                                 (model, params, provider.pytree(), ids, mask))
    del params, provider, model
    torch.cuda.empty_cache()
    return counts


def _require_launched(counts, names, what):
    missing = [n for n in names if counts.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing} ({counts})")


def _profile(label, fn, n):
    """Run fn() n times under torch.profiler: host wall time per call, the
    device's busy time per call (sum of kernel intervals; one stream, so no
    overlap) and its busy share, and the kernels taking the most time.
    Returns the busy time per call (None when the trace holds no kernel)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
    if not by_name:
        say(f"[profile] {label}: device time not measured (no CUDA events traced)")
        return None
    busy = sum(by_name.values())
    say(f"[profile] {label}: wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
        f"busy_share={busy / wall_ms:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in ranked[:8]:
        say(f"[profile]   {ms:8.3f} ms  {name[:110]}")
    for name, ms in ranked[8:]:  # the attention kernels, wherever they rank
        if any(k in name for k in ATTENTION_KERNELS):
            say(f"[profile]   {ms:8.3f} ms  {name[:110]}")
    return busy


def _profile_main_path(model, params, provider, ids, mask, gen, tag, cap=32, what=""):
    """The encoder (once, eager in both modes) and the generator's decode
    step at the timed shape (a cache of ``cap`` columns) under the
    profiler; then the host's time per step: the calls alone (queueing), 16
    steps ended by one synchronize. ``what`` prefixes the labels."""
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev, for_layer, experts = model.device, ResidentProvider.for_layer, provider.pytree()
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    B, T = tok.shape

    def encode():
        return model.cross_kv(params, model.encode(params, experts, tok, m, for_layer, "pallas"))

    with torch.inference_mode():
        cross = encode()
        step_fn = gen.decoder(B, cap, m, cross)
        cur = torch.full((B, 1), model.spec.decoder_start_token_id, dtype=torch.int32,
                         device=dev)
        step = [0]

        def decode():
            _, nxt = step_fn(cur, step[0])
            cur.copy_(nxt[:, None])
            step[0] = (step[0] + 1) % 16

        decode()
        if tag == "eager":
            _profile(f"{what}encode ({B} x {T} tokens) + cross K/V", encode, 2)
        _profile(f"{what}decode step ({B} rows, {tag})", decode, 4)
        torch.cuda.synchronize()
        host, t0 = 0.0, time.perf_counter()
        for _ in range(16):
            t1 = time.perf_counter()
            decode()
            host += time.perf_counter() - t1
        torch.cuda.synchronize()
        say(f"[profile] {what}decode step ({B} rows, {tag}): host_ms_per_step={host * 1e3 / 16:.3f} "
            f"(the calls) wall_ms_per_step={(time.perf_counter() - t0) * 1e3 / 16:.3f} "
            f"(16 steps, one synchronize)")


def _first_step_logits(model, params, provider, ids, mask, impl):
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev = model.device
    experts = provider.pytree()
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    enc = model.encode(params, experts, tok, m, ResidentProvider.for_layer, impl)
    cross = model.cross_kv(params, enc)
    kvs = model.init_cache(tok.shape[0], 32)
    start = torch.full((tok.shape[0], 1), model.spec.decoder_start_token_id,
                       dtype=torch.int32, device=dev)
    pos = torch.zeros_like(start)
    logits, _, _ = model.decode_step(params, experts, start, pos, kvs, 0, m, cross,
                                     ResidentProvider.for_layer, impl)
    return logits


class _plain_kernels:
    """Route the model's kernel calls to the plain versions (the card's
    tensors then run the PyTorch arithmetic): a check-only path."""

    def __enter__(self):
        from moe_infinity_tpu_torch.ops import flash_attention as fa, gmm as gm

        self._saved = (fa.flash_decode, fa.flash_attend, fa.paged_flash_decode,
                       fa.mla_flash_decode, gm.gmm)

        def decode(q, k, v, qp, kv_len, *, scale=None, causal=True,
                   logit_softcap=None, pad_mask=None):
            out = fa.flash_decode_plain(
                q[:, 0], k, v, qp.reshape(-1), int(kv_len),
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                causal=causal, logit_softcap=logit_softcap, pad_mask=pad_mask,
            )
            return out[:, None]

        def attend(q, k, v, qp, kv_len, *, scale=None, causal=True,
                   logit_softcap=None, bias=None, pad_mask=None):
            return fa.flash_attend_plain(
                q, k, v, qp, int(kv_len),
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                causal=causal, logit_softcap=logit_softcap, bias=bias,
                pad_mask=pad_mask,
            )

        def paged(q, pk, pv, table, lengths, *, scale=None, logit_softcap=None,
                  pad_mask=None, max_len=None):
            return fa.paged_flash_decode_plain(
                q, pk, pv, table, lengths,
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                logit_softcap=logit_softcap, pad_mask=pad_mask,
            )

        def mla(q_lat, q_pe, c, kpe, qp, kv_len, *, scale, pad_mask=None):
            return fa.mla_flash_decode_plain(q_lat, q_pe, c, kpe, qp.reshape(-1), int(kv_len),
                                             scale=float(scale), pad_mask=pad_mask)

        def gmm(x, w, gs, scale=None, group_offset=0, group_ids=None, *, packed=False):
            return gm.gmm_plain(x, w, gs, scale, group_offset, group_ids, packed=packed)

        (fa.flash_decode, fa.flash_attend, fa.paged_flash_decode, fa.mla_flash_decode,
         gm.gmm) = (decode, attend, paged, mla, gmm)
        return self

    def __exit__(self, *exc):
        from moe_infinity_tpu_torch.ops import flash_attention as fa, gmm as gm

        (fa.flash_decode, fa.flash_attend, fa.paged_flash_decode, fa.mla_flash_decode,
         gm.gmm) = self._saved
        return False


def phase_whole_path(dev):
    """f32 compute is held to the tolerance: there kernel and plain differ
    only in summation order (~1e-6), so the check sees wiring faults. In
    bf16 a last-bit difference can flip a rounding of the residual stream
    or a near-tie of the top-2 router, which moves that request's logits
    by more than a kernel's error; the bf16 run is reported per request,
    and its outputs must be finite."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=2, decoder_layers=2,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev)
        g.manual_seed(99)
        model = NllbModel(spec, compute_dtype=dtype, device=dev)
        params, tree = model.init_random(g, expert_dtype="int4")
        provider = ResidentProvider(tree)
        ids, mask = _requests(spec.vocab_size, g, dev)
        reset_launches()
        got = _first_step_logits(model, params, provider, ids, mask, "pallas")
        counts = launch_counts()
        with _plain_kernels():
            want = _first_step_logits(model, params, provider, ids, mask, "pallas")
        if launch_counts() != counts:
            raise AssertionError(f"the plain run launched kernels: {counts} -> {launch_counts()}")
        _require_launched(counts, NLLB_KERNELS, "NLLB whole-path check")
        label = f"whole path logits {str(dtype).split('.')[-1]} (full width, 2+2 blocks, sparse_step 2, int4 experts)"
        if dtype == torch.float32:
            compare(label, got, want)
        else:
            rows = (got - want).abs().amax(dim=(1, 2)).tolist()
            same = (got.argmax(-1) == want.argmax(-1)).all().item()
            say(f"[check] {label}: per-request max_abs_err="
                f"{['%.3e' % r for r in rows]} argmax equal={same} "
                f"(reported, not held to a tolerance)")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("bf16 whole-path logits are not finite")
        del model, params, tree, provider, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 5 and 6: Mixtral-8x7B through the continuous batcher
# ---------------------------------------------------------------------------

def _mixtral(dev, dtype, seed, **spec_overrides):
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = MixtralModel(MixtralSpec(**dict(MIXTRAL_8X7B, **spec_overrides)),
                         compute_dtype=dtype, device=dev)
    params, tree = model.init_random(g, expert_dtype="int8")
    return model, params, ResidentProvider(tree), g


def _serve_batcher(tag, model, params, experts, g, slots=SLOTS):
    """Serve PROMPT_LENS' 8 requests, submitted together, through a
    ContinuousBatcher of ``slots`` slots (4; 8 seats them all at once), 16
    greedy tokens each, after a warm-up request that runs both step widths. Prints the run's times and counts,
    checks what came back, and returns (the batcher with its thread stopped,
    prompts, outputs, launch counts of the 8 requests, step stats)."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    vocab, dev = model.spec.vocab_size, model.device
    prompts = [torch.randint(1, vocab, (n,), generator=g, device=dev).cpu().numpy()
               for n in PROMPT_LENS]
    batcher = ContinuousBatcher(
        model, params, experts, ResidentProvider.for_layer, impl="pallas",
        max_batch_size=slots, page_size=PAGE, max_cols=MAX_COLS,
        num_pages=(MAX_COLS // PAGE) * (slots + 1), prefill_chunk=CHUNK,
    )
    try:
        batcher.submit(prompts[4], max_new_tokens=2).result(timeout=600)  # warm-up
        torch.cuda.synchronize()
        batcher.reset_step_stats()
        reset_launches()
        t0 = time.perf_counter()
        futures = [batcher.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        outs = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = batcher.step_stats()
    finally:
        batcher.shutdown()
    n_tok = len(prompts) * NEW_TOKENS
    say(f"[{tag}] {len(prompts)} requests x {NEW_TOKENS} tokens (prompts "
        f"{PROMPT_LENS}): wall_s={wall:.3f} tokens_per_s={n_tok / wall:.2f} "
        f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    for w, st in steps.items():
        say(f"[{tag}] steps of width {w}: {st['steps']} at "
            f"{st['ms_per_step']:.3f} ms per step (host clock, ends in the argmax read)")
    say(f"[{tag}] launches {json.dumps(counts)}")
    say(f"[{tag}] request 1 tokens {outs[0][len(prompts[0]):].tolist()}")
    for p, out in zip(prompts, outs):
        if out.shape != (len(p) + NEW_TOKENS,) or not np.array_equal(out[:len(p)], p):
            raise AssertionError(f"request of {len(p)} tokens came back as {out.shape}")
        if not np.all((out >= 0) & (out < vocab)):
            raise AssertionError("token ids out of range")
    return batcher, prompts, outs, counts, steps


def _profile_batcher(label, batcher, prompts):
    """Profile the batcher's own steps, driven here with its thread stopped:
    the first 16-wide chunk step of 4 fresh requests, then 4 one-token steps.
    Returns the one-token step's device busy time."""
    for p in prompts[:SLOTS]:
        batcher.submit(p, max_new_tokens=NEW_TOKENS)
    with torch.inference_mode():
        batcher._admit()
        _profile(f"{label}batcher chunk step W=16 (4 rows prefilling)",
                 batcher._step_iteration, 1)
        while any(s.prefilling for s in batcher._slots):
            batcher._step_iteration()
        return _profile(f"{label}batcher decode step W=1 (4 rows)", batcher._step_iteration, 4)


def _paged_step_inputs(model, g):
    """Inputs of ``_batcher_steps``: a shuffled page table over all pages but
    the null page, a hole mask for rows fed 16, 16, 9 and 1 tokens, tokens."""
    dev = model.device
    B, P, NP = SLOTS, MAX_COLS // PAGE, (MAX_COLS // PAGE) * (SLOTS + 1)
    fed = torch.tensor([16, 16, 9, 1], device=dev)
    valid = torch.zeros(B, MAX_COLS, dtype=torch.bool, device=dev)
    valid[torch.arange(MAX_COLS, device=dev)[None, :] < fed[:, None]] = True
    return dict(
        num_pages=NP, valid=valid,
        table=(torch.randperm(NP - 1, generator=g, device=dev)[:B * P] + 1)
        .reshape(B, P).to(torch.int32),
        toks1=torch.randint(1, model.spec.vocab_size, (B, CHUNK), generator=g,
                            device=dev, dtype=torch.int32),
        toks2=torch.randint(1, model.spec.vocab_size, (B, 1), generator=g,
                            device=dev, dtype=torch.int32),
        rope2=fed.to(torch.int32)[:, None],
    )


def _hold_steps(what, dtype, got, want):
    """f32 logits of the two steps are held to the tolerance; bf16 is
    reported per request and must be finite."""
    for label, a, b in (("W=16 chunk step", got[0], want[0]),
                        ("W=1 paged step", got[1], want[1])):
        full = what.format(step=label)
        if dtype == torch.float32:
            compare(full, a, b)
        else:
            rows = (a - b).abs().amax(dim=(1, 2)).tolist()
            same = (a.argmax(-1) == b.argmax(-1)).all().item()
            say(f"[check] {full}: per-request max_abs_err={['%.3e' % r for r in rows]} "
                f"argmax equal={same} (reported, not held to a tolerance)")
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{full}: logits are not finite")


def phase_mixtral(dev, extra=None, scan=None):
    """Serve 8 requests through 4 slots; returns the launch counts of the
    batcher's run and of the Generator's run. With ``extra``, phase 29 on
    the same build; with ``scan``, phase 41's Mixtral part."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    say(f"[mixtral] Mixtral-8x7B geometry, {MIXTRAL_8X7B['num_layers']} layers, "
        f"bf16 compute, int8 experts, impl=pallas; ContinuousBatcher("
        f"max_batch_size={SLOTS}, page_size={PAGE}, max_cols={MAX_COLS}, "
        f"num_pages={(MAX_COLS // PAGE) * (SLOTS + 1)}, prefill_chunk={CHUNK})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, provider, g = _mixtral(dev, torch.bfloat16, 4321)
    torch.cuda.synchronize()
    say(f"[mixtral] weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"experts {provider.nbytes() / 1e9:.2f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    experts = provider.pytree()
    batcher, prompts, outs, counts, _ = _serve_batcher("mixtral", model, params, experts, g)
    _require_launched(counts, BATCHER_KERNELS, "Mixtral batcher path")

    # request 1 alone through Generator: contiguous cache, K2 prefill, K1 decode
    reset_launches()
    res = Generator(model, params, experts, ResidentProvider.for_layer, impl="pallas",
                    max_seq_len=MAX_COLS).generate(prompts[0][None], max_new_tokens=NEW_TOKENS)
    gen_counts = launch_counts()
    _require_launched(gen_counts, NLLB_KERNELS, "Mixtral Generator path")
    same = np.array_equal(res.sequences[0], outs[0])
    say(f"[mixtral] Generator alone, request 1: tokens equal to the batcher's: {same} "
        f"(bf16, reported, not held); launches {json.dumps(gen_counts)}")

    _profile_batcher("", batcher, prompts)
    del batcher
    if extra is not None:
        extra["phase_mixtral_speculative"] = _subphase(phase_mixtral_speculative, dev,
                                                       (model, params, experts))
    if scan is not None:
        scan["mixtral"] = _subphase(phase_decode_scan, dev, "mixtral", (model, params, experts))
    del params, provider, experts, model
    torch.cuda.empty_cache()
    return {k: counts[k] + gen_counts[k] for k in counts}


def _batcher_steps(model, params, experts, inputs, trace_ids=None):
    """A 16-wide chunk step, then a one-token step, over fresh paged caches
    as the batcher builds them: rows fed 16, 16, 9 and 1 real tokens in the
    chunk (the rest are hole columns), per-row RoPE positions. Returns the two
    steps' logits; trace_ids, a list, collects their routed expert ids."""
    from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev = model.device
    lead = (inputs["num_pages"], PAGE)  # pools shaped as the batcher shapes them
    kvs = [PagedKVCache(torch.zeros(lead + tuple(kv.k.shape[2:]), dtype=model.dtype, device=dev),
                        torch.zeros(lead + tuple(kv.v.shape[2:]), dtype=model.dtype, device=dev),
                        inputs["table"])
           for kv in model.init_cache(1, 1)]
    valid = inputs["valid"].clone()
    B = valid.shape[0]
    chunk = torch.arange(CHUNK, dtype=torch.int32, device=dev).expand(B, CHUNK)
    out = []
    for toks, pos, rope, col in ((inputs["toks1"], chunk, chunk, 0),
                                 (inputs["toks2"], torch.full((B, 1), CHUNK, dtype=torch.int32, device=dev),
                                  inputs["rope2"], CHUNK)):
        if col:
            valid[:, col] = True
        logits, _, trace = model.forward(params, experts, toks, pos, kvs, col,
                                         for_layer=ResidentProvider.for_layer, impl="pallas",
                                         rope_positions=rope, key_valid=valid)
        out.append(logits)
        if trace_ids is not None:
            trace_ids.append(trace[0])
    return out


class _gmm_inputs:
    """Record the x of every K3 call (kernel or plain, whichever ``gm.gmm``
    is on entry) as the bf16 values K3 multiplies."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        from moe_infinity_tpu_torch.ops import gmm as gm

        self._saved = inner = gm.gmm

        def recorded(x, *a, **k):
            self.store.append(x.to(torch.bfloat16))
            return inner(x, *a, **k)

        gm.gmm = recorded
        return self

    def __exit__(self, *exc):
        from moe_infinity_tpu_torch.ops import gmm as gm

        gm.gmm = self._saved
        return False


def phase_mixtral_whole_path(dev):
    """f32 is held to the tolerance on three seeds (kernel and plain differ
    in summation order only; K3 rounds its x to bf16 in both, so an order
    difference upstream can flip a rounding there, which the line of K3
    inputs counts); bf16 is reported per request, as in phase 4."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    for dtype, seed in ((torch.float32, 77), (torch.float32, 78), (torch.float32, 79),
                        (torch.bfloat16, 77)):
        model, params, provider, g = _mixtral(dev, dtype, seed, num_layers=2)
        experts = provider.pytree()
        inputs = _paged_step_inputs(model, g)
        xs_got, xs_want = [], []
        with torch.inference_mode():
            reset_launches()
            with _gmm_inputs(xs_got):
                got = _batcher_steps(model, params, experts, inputs)
            counts = launch_counts()
            with _plain_kernels(), _gmm_inputs(xs_want):
                want = _batcher_steps(model, params, experts, inputs)
        if launch_counts() != counts:
            raise AssertionError(f"the plain run launched kernels: {counts} -> {launch_counts()}")
        _require_launched(counts, BATCHER_KERNELS, "Mixtral whole-path check")
        name = str(dtype).split(".")[-1]
        if dtype == torch.float32:
            flips = [int((a != b).sum()) for a, b in zip(xs_got, xs_want)]
            say(f"[check] seed {seed}: K3 inputs whose bf16 rounding differs between the "
                f"kernel and plain runs, per call (layer 0 gate, up, down, layer 1 ...; "
                f"W=16 step, then W=1): {flips} of {[a.numel() for a in xs_got]}")
        _hold_steps(f"Mixtral whole path logits {name} seed {seed}, {{step}} (full width, "
                    f"2 layers, int8 experts, paged, holes)", dtype, got, want)
        del model, params, provider, experts, got, want, xs_got, xs_want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7 and 8: DeepSeek-V2-Lite (MLA) through the batcher, Generator and
# the fused runner
# ---------------------------------------------------------------------------

def _deepseek(dev, dtype, seed, **spec_overrides):
    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = DeepseekV2Model(DeepseekV2Spec(**dict(DSV2_LITE, **spec_overrides)),
                            compute_dtype=dtype, device=dev)
    params, tree = model.init_random(g, expert_dtype="bf16")
    return model, params, ResidentProvider(tree), g


def _require_mla_counts(counts, one_token_steps, steps, what, layers=DSV2_LITE["num_layers"],
                        k5="mla_flash_decode", k3="gmm"):
    """K5 launches once per layer of every one-token step and nowhere else;
    K3 three times (gate, up, down) per MoE layer of every step; each under
    the named instance (``k5``: the padded one, ``k3``: the tiled layout's)
    and none under the others."""
    _require_launched(counts, (k5, k3), what)
    moe_layers = layers - DSV2_LITE["first_k_dense_replace"]
    want = {"mla_flash_decode": 0, "mla_flash_decode_pad": 0, "gmm": 0, "gmm_tiled": 0}
    want.update({k5: layers * one_token_steps, k3: 3 * moe_layers * steps})
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_deepseek(dev, scan=None):
    """Serve 8 requests through 4 slots, then request 1 through Generator and
    through FusedRunner over a flat pool, then again through FusedRunner over
    the pool JAX's ``stack_experts`` builds by default, pre-tiled (phase 7b:
    rebuilt from the flat one role by role, its prefill logits bit-equal to
    the flat run's, its tokens equal); returns the four runs' launch counts
    summed. With ``scan``, phase 41's DeepSeek part on the same build."""
    import warnings

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.fused import FusedRunner
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    L = DSV2_LITE["num_layers"]
    say(f"[deepseek] DeepSeek-V2-Lite geometry, {L} layers (1 dense + {L - 1} MoE), bf16 compute, "
        f"bf16 experts, impl=pallas; ContinuousBatcher(max_batch_size={SLOTS}, "
        f"page_size={PAGE}, max_cols={MAX_COLS}, "
        f"num_pages={(MAX_COLS // PAGE) * (SLOTS + 1)}, prefill_chunk={CHUNK})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, provider, g = _deepseek(dev, torch.bfloat16, 2468)
    torch.cuda.synchronize()
    say(f"[deepseek] weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"experts {provider.nbytes() / 1e9:.2f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    vocab = model.spec.vocab_size
    experts = provider.pytree()
    batcher, prompts, outs, counts, steps = _serve_batcher("deepseek", model, params, experts, g)
    n_steps = sum(st["steps"] for st in steps.values())
    _require_mla_counts(counts, steps.get(1, {"steps": 0})["steps"], n_steps,
                        "DeepSeek batcher path")

    # request 1 alone through Generator: contiguous caches, einsum prefill, K5 decode
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = Generator(model, params, experts, ResidentProvider.for_layer, impl="pallas",
                    max_seq_len=MAX_COLS).generate(prompts[0][None], max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = launch_counts()
    _require_mla_counts(gen_counts, NEW_TOKENS - 1, NEW_TOKENS, "DeepSeek Generator path")
    say(f"[deepseek] Generator alone, request 1: {gen_s * 1e3 / NEW_TOKENS:.3f} ms per token "
        f"(prefill of {PROMPT_LENS[0]} included); tokens equal to the batcher's: "
        f"{np.array_equal(res.sequences[0], outs[0])} (bf16, reported, not held); "
        f"launches {json.dumps(gen_counts)}")

    busy = _profile_batcher("DeepSeek ", batcher, prompts)
    with torch.inference_mode():
        # the gathered view: every layer of a paged step copies its rows' pages
        # into [B, 512, 1, R] and [B, 512, 1, P] before attention reads them
        from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache

        table = torch.from_numpy(batcher.alloc.table(
            [id(s.req) if s.active else "__free__" for s in batcher._slots],
            batcher.max_pages_per_seq)).to(dev)
        kv0 = PagedKVCache(*batcher._pools[0], table)
        view_ms = cuda_ms(lambda: (kv0.k, kv0.v)) * L
        say(f"[deepseek] gathered view of the paged caches: {view_ms:.3f} ms of device time per "
            f"step ({L} layers)" + (f", {view_ms / busy:.3f} of the W=1 step's device busy time"
                                    if busy else ""))
    del batcher, kv0
    if scan is not None:
        scan["deepseek"] = _subphase(phase_decode_scan, dev, "deepseek", (model, params, experts))

    # request 1 through the fused runner: one stacked pool, K3 at offsets li * E
    torch.cuda.synchronize()
    say(f"[deepseek] peak memory of the batcher and Generator runs: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    pool = model.stack_experts(experts["layers"], layout="flat")
    del experts, provider
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = FusedRunner(model, params, pool, moe_impl="gmm")
    T = len(prompts[0])
    tok = torch.as_tensor(prompts[0][None], dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    pos0 = torch.full((1,), T, dtype=torch.int32, device=dev)

    def fused(runner):
        logits, kv = runner.prefill(tok, pos, runner.init_cache(1, 64), 0)
        tok0 = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        toks, _ = runner.decode(tok0, pos0, kv, NEW_TOKENS - 1)
        return logits, torch.cat([tok0, toks], dim=1)

    fused(runner)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            flat_logits, new = fused(runner)
            queued_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_counts = launch_counts()
    _require_mla_counts(fused_counts, NEW_TOKENS - 1, NEW_TOKENS, "DeepSeek FusedRunner path")
    new_dev = new
    new = new[0].cpu().numpy()
    if new.shape != (NEW_TOKENS,) or not np.all((new >= 0) & (new < vocab)):
        raise AssertionError(f"FusedRunner returned {new.shape}")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    say(f"[deepseek] FusedRunner, request 1: prefill + {NEW_TOKENS - 1}-token decode "
        f"{fused_s * 1e3 / NEW_TOKENS:.3f} ms per token (host had queued all of it after "
        f"{queued_s * 1e3 / NEW_TOKENS:.3f} ms per token); host reads flagged by "
        f"torch.cuda.set_sync_debug_mode: {len(syncs)} (decode reads its start column once); "
        f"tokens equal to Generator's: {np.array_equal(new, res.sequences[0][T:])}, to the "
        f"batcher's: {np.array_equal(new, outs[0][T:])} (bf16, reported, not held); "
        f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"launches {json.dumps(fused_counts)}")
    for w in syncs:
        say(f"[deepseek]   host read at {Path(w.filename).name}:{w.lineno}")
    tiled_counts = _deepseek_tiled(model, params, runner, fused, flat_logits, new_dev)
    del runner, pool, params, model
    torch.cuda.empty_cache()
    return {k: counts[k] + gen_counts[k] + fused_counts[k] + tiled_counts[k] for k in counts}


def _deepseek_tiled(model, params, runner, fused, flat_logits, flat_new):
    """Phase 7b: the flat pool of ``runner`` rebuilt as the pre-tiled one
    that JAX's ``stack_experts`` builds by default, role by role (each flat
    role freed as its tiled copy lands, so the card never holds a third copy
    of the experts), then the same request through a FusedRunner over it:
    prefill logits bit-equal to the flat run's, the tokens equal, K3 held to
    3 x 26 ``gmm_tiled`` launches a forward and none on the flat layout.
    Returns the timed run's launch counts."""
    from moe_infinity_tpu_torch.ops import gmm as gm
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.fused import FusedRunner

    flat = runner.pool
    runner.pool = runner.stacked = None  # the flat runner goes; its pool dict empties below
    t0 = time.perf_counter()
    tiled = {}
    for role in list(flat):
        w = flat.pop(role)
        tiled[role] = gm.pack_tiled(w) if w.dim() == 3 else w
        del w
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shapes = {r: tuple(t.shape) for r, t in tiled.items() if t.dim() == 4}
    trun = FusedRunner(model, params, tiled, moe_impl="gmm")
    fused(trun)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, new = fused(trun)
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    tiled_s = time.perf_counter() - t0
    counts = launch_counts()
    _require_mla_counts(counts, NEW_TOKENS - 1, NEW_TOKENS, "DeepSeek FusedRunner over the "
                        "pre-tiled pool", k3="gmm_tiled")
    same_logits = torch.equal(logits, flat_logits)
    same_tokens = torch.equal(new, flat_new)
    say(f"[deepseek] FusedRunner over the pre-tiled pool {json.dumps(shapes)} (rebuilt from the "
        f"flat one role by role in {build_s:.2f} s), request 1: prefill + {NEW_TOKENS - 1}-token "
        f"decode {tiled_s * 1e3 / NEW_TOKENS:.3f} ms per token (host had queued all of it after "
        f"{queued_s * 1e3 / NEW_TOKENS:.3f} ms per token); prefill logits bit-equal to the "
        f"flat pool's: {same_logits}; tokens equal: {same_tokens}; "
        f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"launches {json.dumps(counts)}")
    if not (same_logits and same_tokens):
        raise AssertionError("FusedRunner over the pre-tiled pool differs from the flat pool's")
    del trun, tiled
    return counts


def phase_deepseek_whole_path(dev):
    """As phase 6, at DeepSeek-V2-Lite's width with 1 dense + 2 MoE layers and
    bf16 experts: f32 compute held to the tolerance on three seeds, bf16
    reported; then seed 77 at f32 once more with fold_mla_params applied
    (K5 at scale 1.0, the folded q and o projections)."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    cases = [(torch.float32, 77, False), (torch.float32, 78, False), (torch.float32, 79, False),
             (torch.bfloat16, 77, False), (torch.float32, 77, True)]
    for dtype, seed, fold in cases:
        model, params, provider, g = _deepseek(dev, dtype, seed, num_layers=3)
        if fold:
            params = model.fold_mla_params(params)
        experts = provider.pytree()
        inputs = _paged_step_inputs(model, g)
        ids_got, ids_want = [], []
        with torch.inference_mode():
            reset_launches()
            got = _batcher_steps(model, params, experts, inputs, ids_got)
            counts = launch_counts()
            with _plain_kernels():
                want = _batcher_steps(model, params, experts, inputs, ids_want)
        if launch_counts() != counts:
            raise AssertionError(f"the plain run launched kernels: {counts} -> {launch_counts()}")
        _require_mla_counts(counts, 1, 2, "DeepSeek whole-path check", layers=3)
        flips = sum(int((a != b).sum()) for a, b in zip(ids_got, ids_want))
        say(f"[check] seed {seed}: expert choices that differ between the kernel and plain "
            f"runs: {flips} of {sum(a.numel() for a in ids_got)}")
        name = str(dtype).split(".")[-1] + (" folded" if fold else "")
        _hold_steps(f"DeepSeek whole path logits {name} seed {seed}, {{step}} (full width, "
                    f"1 dense + 2 MoE layers, bf16 experts, paged, holes)", dtype, got, want)
        del model, params, provider, experts, got, want
        torch.cuda.empty_cache()


def phase_deepseek_widths(dev):
    """Phase 46: K5's padded instance on a model's path. No published model
    of a served family has an MLA geometry other than R 512 with P 64, so
    this is DeepSeek-V2-Lite's geometry with the latent and rope widths of
    ``MLA_PAD_SHAPE`` (R 256, P 32) at 1 dense + 2 MoE layers, random
    weights: request 1 through Generator at bf16 (K5 held to 3 padded
    launches a one-token step and none of the 512/64 instance), then the
    batcher's two steps at f32 against the plain versions on three seeds,
    as phase 8 holds them. Returns the Generator run's launch counts."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    R, P = MLA_PAD_SHAPE
    widths = dict(num_layers=3, kv_lora_rank=R, qk_rope_head_dim=P)
    say(f"[widths] DeepSeek-V2-Lite geometry at kv_lora_rank={R}, qk_rope_head_dim={P}, "
        f"1 dense + 2 MoE layers, bf16 experts, impl=pallas")
    model, params, provider, g = _deepseek(dev, torch.bfloat16, 4680, **widths)
    experts = provider.pytree()
    prompt = torch.randint(3, model.spec.vocab_size, (1, PROMPT_LENS[0]), generator=g,
                           device=dev).cpu().numpy()
    gen = Generator(model, params, experts, ResidentProvider.for_layer, impl="pallas",
                    max_seq_len=MAX_COLS)
    gen.generate(prompt, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = gen.generate(prompt, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launch_counts()
    _require_mla_counts(counts, NEW_TOKENS - 1, NEW_TOKENS, "DeepSeek padded widths Generator",
                        layers=3, k5="mla_flash_decode_pad")
    new = res.sequences[0][PROMPT_LENS[0]:]
    if new.shape != (NEW_TOKENS,) or not np.all((new >= 0) & (new < model.spec.vocab_size)):
        raise AssertionError(f"padded widths Generator returned {new.shape}")
    say(f"[widths] Generator, request 1: {gen_s * 1e3 / NEW_TOKENS:.3f} ms per token (prefill of "
        f"{PROMPT_LENS[0]} included); launches {json.dumps(counts)}")
    del gen, model, params, provider, experts
    torch.cuda.empty_cache()
    for seed in (77, 78, 79):
        model, params, provider, g = _deepseek(dev, torch.float32, seed, **widths)
        experts = provider.pytree()
        inputs = _paged_step_inputs(model, g)
        with torch.inference_mode():
            reset_launches()
            got = _batcher_steps(model, params, experts, inputs)
            steps = launch_counts()
            with _plain_kernels():
                want = _batcher_steps(model, params, experts, inputs)
        _require_mla_counts(steps, 1, 2, "DeepSeek padded widths whole-path check", layers=3,
                            k5="mla_flash_decode_pad")
        _hold_steps(f"DeepSeek padded widths (R {R}, P {P}) whole path logits float32 seed "
                    f"{seed}, {{step}} (1 dense + 2 MoE layers, paged, holes)", torch.float32,
                    got, want)
        del model, params, provider, experts, got, want
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phases 9 and 10: NLLB-MoE-54B through the per-layer offload engine
# ---------------------------------------------------------------------------

# bench.py's --tier-gb and --hbm-gb defaults, and the KV reserve it keeps
# out of the HBM budget (bench.py:1029, :1037-1041)
TIER_GB, HBM_GB, KV_RESERVE = 14, 13, int(1.4 * 2**30)
PHASE9_TOKENS = {}  # phase 9's timed generate, when it ran in this process


def _offload_store(spec, seed=0, cache_records=64):
    """bench.py:991-998's store: packed int4 fc1/fc2 with f32 scales and
    biases for every MoE layer, SyntheticStore records distinct per expert."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    D, F, E = spec.d_model, spec.encoder_ffn_dim, spec.num_experts
    n_enc = sum(spec.is_sparse(i, False) for i in range(spec.encoder_layers))
    n_moe = n_enc + sum(spec.is_sparse(i, True) for i in range(spec.decoder_layers))
    fields = [("fc1.weight", (D, F // 2), "int4"), ("fc1.weight.scale", (F,), "float32"),
              ("fc1.bias", (F,), "float32"), ("fc2.weight", (F, D // 2), "int4"),
              ("fc2.weight.scale", (D,), "float32"), ("fc2.bias", (D,), "float32")]
    return SyntheticStore(n_moe, E, fields, meta={"arch": "nllb", "num_encoder_moe_layers": n_enc},
                          seed=seed, distinct_records=True, cache_records=cache_records)


def _offload_engine(model, params, store, num_slots, tier, impl="pallas", arena_kw=None, **kw):
    """bench.py's engine (`_nllb_build`): EAMC tracer and predictor, prefetch
    with lookahead 3 and budget 8, the priority policy, 4 fetch workers, K3
    for every expert FFN; the per-layer path unless ``kw`` asks for the
    speculative one; no direct-tier layer unless ``kw`` asks
    (``max_direct_layers``, bench.py's ``--direct-layers`` 0). arena_kw: more
    of the arena's options (``reserve_zero_slot``, ``dequant_on_write``)."""
    kw.setdefault("max_direct_layers", 0)
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine

    n_enc = store.meta["num_encoder_moe_layers"]
    tracer = ExpertTracer(256, store.num_layers, store.num_experts, num_encoder_layers=n_enc)
    arena = ExpertArena(store, num_slots, policy="priority", compute_dtype=model.dtype,
                        device=model.device, num_threads=4, pinned_tier=tier,
                        **(arena_kw or {}))
    return Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                                predictor=ExpertPredictor(tracer), prefetch=True, lookahead=3,
                                prefetch_budget=8, impl=impl, **kw)


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _offload_build(dev, align=False):
    """Phase 9's and 11's set-up: bf16 dense weights from a seed, the int4
    store, a 14 GiB page-locked tier (decoder records first, made on the
    card; with ``align`` in segments of one layer's E records), and the
    slot count of bench.py's --hbm-gb 13 budget; the records the tier does
    not hold are kept in host memory after their first read, as a
    page-cached store keeps them."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = NllbSpec(**NLLB_54B)
    E = spec.num_experts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    model = NllbModel(spec, compute_dtype=torch.bfloat16, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    dense = _tree_bytes(params)
    store = _offload_store(spec, cache_records=spec.encoder_layers * E)
    tier = PinnedExpertTier(store, device=dev, shared_record=False, max_bytes=TIER_GB * 2**30,
                            synth_on_device=True, align_rows=E if align else None)
    torch.cuda.synchronize()
    t_tier = time.perf_counter() - t0
    slots = max(E, int((HBM_GB * 2**30 - dense - KV_RESERVE) // store.stride))
    ids, mask = _requests(spec.vocab_size, g, dev)
    return SimpleNamespace(spec=spec, model=model, params=params, dense=dense, store=store,
                           tier=tier, slots=slots, t0=t0, t_tier=t_tier, ids=ids, mask=mask)


def _say_offload_setup(tag, b, arena):
    spec, store, tier, E = b.spec, b.store, b.tier, b.spec.num_experts
    n_rec = store.num_layers * E
    n_enc = store.meta["num_encoder_moe_layers"]
    dec_staged = sum(tier.record_index(l, e) is not None
                     for l in range(n_enc, store.num_layers) for e in range(E))
    say(f"[{tag}] NLLB-MoE-54B, depth {spec.encoder_layers}+{spec.decoder_layers} blocks, "
        f"{store.num_layers} MoE layers x {E} experts = {n_rec} int4 records of "
        f"{store.stride / 1e6:.2f} MB ({n_rec * store.stride / 1e9:.2f} GB); dense bf16 "
        f"{b.dense / 1e9:.2f} GB; tier {json.dumps(tier.stats())} "
        f"{'page-locked' if tier.fields['fc1.weight'][0].is_pinned() else 'pageable'}, "
        f"{dec_staged} of {n_rec - n_enc * E} decoder records; arena {b.slots} slots "
        f"({b.slots / n_rec:.3f} of the experts), {arena.nbytes() / 1e9:.2f} GB; set-up "
        f"{time.perf_counter() - b.t0:.1f} s (tier {b.t_tier:.1f} s)")


def phase_offload(dev):
    """NLLB-MoE-54B at full width and depth served by the per-layer offload
    engine (``_offload_build``). One warm-up generate, then a timed one of
    phase 3's 4 requests x 16 greedy tokens."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    b = _offload_build(dev)
    spec, tier, ids, mask = b.spec, b.tier, b.ids, b.mask
    engine = _offload_engine(b.model, b.params, b.store, b.slots, tier)
    arena = engine.arena
    _say_offload_setup("offload", b, arena)
    try:
        t0 = time.perf_counter()
        engine.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask, eos_token_id=None)
        torch.cuda.synchronize()
        say(f"[offload] warm-up generate {time.perf_counter() - t0:.1f} s, stats "
            f"{json.dumps(engine.stats())}, fetches {json.dumps(arena.fetch_stats())}")
        f0, s0 = arena.fetch_stats(), engine.stats()
        reset_launches()
        t0 = time.perf_counter()
        res = engine.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                              eos_token_id=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        PHASE9_TOKENS["sequences"] = res.sequences  # phases 37 and 38 hold theirs to these
        f1, s1 = arena.fetch_stats(), engine.stats()
        dw = engine.decode_window_stats()
        st = res.stats
        say(f"[offload] sequences shape {res.sequences.shape}; first row "
            f"{res.sequences[0].tolist()}")
        say(f"[offload] encode_ms={st['encode_ms']:.3f} decode_ms_per_step="
            f"{st['decode_ms'] / NEW_TOKENS:.3f} tokens_per_s="
            f"{len(SRC_LENS) * NEW_TOKENS / (st['decode_ms'] / 1e3):.1f} wall_s={wall:.3f}")
        say(f"[offload] decode window: hit_rate={dw['decode_hit_rate']:.4f} visits={dw['visits']} "
            f"misses={dw['misses']} evictions={dw['evictions']} miss_by_layer="
            f"{dw['miss_by_layer']} miss_churn={dw['miss_churn']} miss_fresh={dw['miss_fresh']} "
            f"distinct_routed={dw['distinct_routed']}")
        say(f"[offload] timed generate: visits={s1['visits'] - s0['visits']} misses="
            f"{s1['misses'] - s0['misses']} evictions={s1['evictions'] - s0['evictions']} "
            f"prefetches={s1['prefetches'] - s0['prefetches']} fetches tier="
            f"{f1['fetches_tier'] - f0['fetches_tier']} store="
            f"{f1['fetches_store'] - f0['fetches_store']} fetch_seconds_ewma="
            f"{f1['fetch_seconds_ewma']:.6f}")
        say(f"[offload] tier_gb={tier.stats()['pinned_tier_gb']} arena_gb="
            f"{arena.nbytes() / 2**30:.3f} max_memory_allocated_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        say(f"[offload] launches {json.dumps(counts)}")
        if res.sequences.shape != (len(SRC_LENS), NEW_TOKENS + 1):
            raise AssertionError(f"unexpected output shape {res.sequences.shape}")
        if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
            raise AssertionError("token ids out of range")
        _require_launched(counts, NLLB_KERNELS, "NLLB offload path")
        if s1["evictions"] <= 0 or f1["fetches_tier"] <= 0 or f1["fetches_store"] <= 0:
            raise AssertionError(f"offload path: no evictions, or a fetch path unused "
                                 f"({s1}, {f1})")
        _profile_offload_step(engine, ids, mask)
    finally:
        arena.shutdown()
    del engine, arena, tier, b
    torch.cuda.empty_cache()
    return counts


def _profile_streams(label, fn, n):
    """Run fn() n times under torch.profiler: host wall time per call, the
    device's busy time per call as the union of every stream's intervals,
    time in copies (Memcpy) and in everything else, and the largest items."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
    if not spans:
        say(f"[profile] {label}: device time not measured (no CUDA events traced)")
        return None
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e3 / n
    copies = sum(ms for k, ms in by_name.items() if "memcpy" in k.lower())
    kernels = sum(by_name.values()) - copies
    say(f"[profile] {label}: wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} (union of streams) "
        f"busy_share={busy / wall_ms:.3f} kernels_ms={kernels:.3f} copies_ms={copies:.3f} "
        f"copy_share_of_busy={min(1.0, copies / busy):.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        say(f"[profile]   {ms:8.3f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, kernels_ms=kernels, copies_ms=copies)


def _profile_offload_step(engine, ids, mask):
    """One encode through the engine, then two decode steps under the
    profiler (the first step runs before the window)."""
    model = engine.model
    dev = model.device
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    B = tok.shape[0]
    seq_ids = [engine.tracer.create_entry() for _ in range(B)]
    with torch.inference_mode():
        _, cross = engine.run_encoder(tok, m, seq_ids)
        engine._prefetch_decoder_tier(seq_ids)
        kvs = engine.init_cache(B, 32)
        cur = torch.full((B, 1), model.spec.decoder_start_token_id, dtype=torch.int32, device=dev)
        step = [0]

        def decode():
            logits = engine.decode_step(cur, step[0], kvs, m, cross, seq_ids)
            cur.copy_(torch.argmax(logits[:, -1], -1, keepdim=True))
            step[0] += 1

        decode()
        _profile_streams("offload decode step (4 rows, per-layer, 6 MoE layers)", decode, 2)
        _host_profile("offload decode step", decode, 2)
    for sid in seq_ids:
        engine.tracer.finish_entry(sid)


def _host_profile(label, fn, n, top=18):
    """Where the host's time goes, by cProfile over n calls: cumulative and
    own ms per call of the functions with the most cumulative time. On
    Python 3.12 cProfile sees every thread, so the fetch workers' functions
    (``_worker``, ``_next_order_locked``) stand beside the caller's; the
    caller's ``acquire`` is its wait for fetches. cProfile slows every
    Python call, so these shares locate time; they do not time it."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3 / n
    say(f"[host] {label}: wall_ms={wall:.3f} under cProfile; cumulative / own ms per call:")
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
    for (path, line, func), (_, calls, tt, ct, _) in rows[:top]:
        where = f"{Path(path).parent.name}/{Path(path).name}:{line}" if line else path
        say(f"[host]   {ct * 1e3 / n:9.3f} {tt * 1e3 / n:9.3f}  {calls / n:7.1f} calls  "
            f"{func} ({where})")


def _offload_first_step(engine, ids, mask):
    model = engine.model
    dev = model.device
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    with torch.inference_mode():
        _, cross = engine.run_encoder(tok, m)
        kvs = engine.init_cache(tok.shape[0], 32)
        start = torch.full((tok.shape[0], 1), model.spec.decoder_start_token_id,
                           dtype=torch.int32, device=dev)
        return engine.decode_step(start, 0, kvs, m, cross)


def phase_offload_whole_path(dev, seeds=PARITY_SEEDS, blocks=PARITY_BLOCKS):
    """The offload engine against the resident Seq2SeqGenerator at f32, full
    width, 4+4 blocks with every 2nd sparse (2+2 MoE layers), an arena of E
    slots (evictions at every MoE layer), prefetch on and 4 workers. The
    resident experts are the store's own records (``from_store``). Seed 11
    fetches every record from the store; seed 12 stages the decoder records
    and 40 of the first encoder layer's in a tier copied from the store
    (``synth_on_device=False``). Greedy tokens must be equal, first-step
    logits within the tolerance."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=blocks, decoder_layers=blocks,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    E = spec.num_experts
    for seed, staged in seeds:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        model = NllbModel(spec, compute_dtype=torch.float32, device=dev)
        params, _ = model.init_random(g, with_experts=False)
        store = _offload_store(spec, seed=seed, cache_records=4 * E)
        provider = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
        tier = None
        if staged:
            n_dec = (store.num_layers - store.meta["num_encoder_moe_layers"]) * E
            tier = PinnedExpertTier(store, device=dev, shared_record=False,
                                    max_bytes=(n_dec + 40) * store.stride,
                                    synth_on_device=False)
        engine = _offload_engine(model, params, store, E, tier)
        ids, mask = _requests(spec.vocab_size, g, dev)
        try:
            reset_launches()
            got_logits = _offload_first_step(engine, ids, mask)
            got = engine.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                                  eos_token_id=None)
            torch.cuda.synchronize()
            counts = launch_counts()
            stats, fetch = engine.stats(), engine.arena.fetch_stats()
            ev_by_layer = engine.arena.policy.node_stats["evictions"].sum(axis=1).tolist()
        finally:
            engine.arena.shutdown()
        _require_launched(counts, NLLB_KERNELS, "NLLB offload whole-path check")
        res = Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer,
                               impl="pallas")
        want = res.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                            eos_token_id=None)
        want_logits = _first_step_logits(model, params, provider, ids, mask, "pallas")
        say(f"[check] offload seed {seed} ({'tier + store' if staged else 'store only'}): "
            f"{E} slots, evictions by MoE layer {ev_by_layer}, misses {stats['misses']}, "
            f"fetches {json.dumps(fetch)}")
        compare(f"offload vs resident first-step logits f32 seed {seed} (full width, {blocks}+{blocks} "
                f"blocks, int4 experts, {E}-slot arena)", got_logits, want_logits)
        same = np.array_equal(got.sequences, want.sequences)
        say(f"[check] offload vs resident greedy tokens seed {seed}: "
            f"{'equal' if same else 'DIFFER'} {got.sequences[0].tolist()}")
        if not same:
            raise AssertionError(f"offload tokens differ from the resident path's (seed {seed})")
        if stats["evictions"] <= 0 or (staged and fetch["fetches_tier"] <= 0):
            raise AssertionError(f"offload whole path: no evictions or no tier fetch ({stats})")
        del model, params, store, provider, tier, engine, res
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 11 and 12: the speculative offload path (bench.py's default)
# ---------------------------------------------------------------------------

NLLB_ENCODE_LAUNCHES = {"flash_attend": 24, "gmm": 12}  # one encode of NLLB-MoE-54B
NLLB_STEP_LAUNCHES = {"flash_decode": 24, "flash_attend": 24, "gmm": 12}  # one decoder step


def _wrap_dispatches(engine, wrap, replays=True):
    """Wrap each speculative dispatch of ``engine`` in ``wrap(fn)``: with
    graphs and ``replays``, each replay (input copies included; a capture is
    not wrapped); else each call of its whole step and k-step block, or of
    its stream block under stream decode (with graphs: the graph cache's
    lookup, and a capture where a shape has none). Returns a function that
    takes the wrappers off."""
    from moe_infinity_tpu_torch.runtime import graphs

    if engine.graphs is not None and replays:
        replay = graphs.StepGraph.replay
        graphs.StepGraph.replay = wrap(replay)

        def off():
            graphs.StepGraph.replay = replay

        return off
    if getattr(engine, "_stream", False):
        stream_fn = engine._stream_block_fn
        engine._stream_block_fn = lambda k: wrap(stream_fn(k))

        def off():
            del engine._stream_block_fn

        return off
    block_fn, step_fn = engine._spec_block_fn, engine._spec_step
    engine._spec_block_fn = lambda k: wrap(block_fn(k))
    engine._spec_step = wrap(step_fn)

    def off():
        del engine._spec_block_fn, engine._spec_step

    return off


def _sync_guard(engine):
    """Run every speculative dispatch under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read inside raises.
    The slot-row upload comes before the guarded call and the trace read
    after it. Returns the count of guarded calls and a function that takes
    the guard off."""
    n = [0]

    def guard(fn):
        def run(*a, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            n[0] += 1
            return out
        return run

    return n, _wrap_dispatches(engine, guard)


def _host_timer(engine):
    """[host seconds inside the dispatches' calls, calls]: what the host
    spends queueing an execution (a graph's lookup and replay, or an eager
    step or block), without the trace read that waits for the device."""
    t = [0.0, 0]

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            t[0] += time.perf_counter() - t0
            t[1] += 1
            return out
        return run

    return t, _wrap_dispatches(engine, timed, replays=False)


def phase_offload_spec(dev, extra=None):
    """Phase 9's build served by the speculative engine, as bench.py's
    ``nllb-offload`` preset builds it (``speculative=True``, ``spec_block=4``,
    route margin 2): blocks of up to 4 greedy steps on the device with no
    host read inside, verified once per dispatch. First the eager path
    (``graphs=False``, for comparison), then the main path, each step and
    block a replay of a CUDA graph, each with a new arena over the same tier
    and store: one warm-up generate with every dispatch under the
    sync-debug guard, then a timed one of phase 3's 4 requests x 16 greedy
    tokens, then a profile of one block on the device and on the host."""
    b = _offload_build(dev)
    runs = {}
    for graphs in (False, True):
        counts = _offload_spec_run(dev, b, graphs, runs, extra)
    same = np.array_equal(runs["graphs"], runs["eager"])
    say(f"[spec] graphs against eager greedy tokens: {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("speculative path: graph and eager tokens differ")
    del b
    torch.cuda.empty_cache()
    return counts


def _offload_spec_run(dev, b, graphs, runs, extra=None):
    """One leg of phase 11; with graphs and ``extra``, phase 25 on its engine."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.engine import spec_block_diag, speculative_stats

    tag = "graphs" if graphs else "eager"
    spec, tier, ids, mask = b.spec, b.tier, b.ids, b.mask
    torch.cuda.reset_peak_memory_stats()
    say(f"[spec] {tag}: allocated before the engine is built "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    engine = _offload_engine(b.model, b.params, b.store, b.slots, tier, speculative=True,
                             spec_block=4, graphs=graphs)
    arena = engine.arena
    _say_offload_setup(f"spec {tag}", b, arena)
    gen = dict(max_new_tokens=NEW_TOKENS, attention_mask=mask, eos_token_id=None)
    try:
        guarded, unguard = _sync_guard(engine)
        t0 = time.perf_counter()
        try:
            engine.generate(ids, **gen)
            torch.cuda.synchronize()
        finally:
            unguard()
        say(f"[spec] {tag}: warm-up generate {time.perf_counter() - t0:.1f} s, {guarded[0]} "
            f"{'replays' if graphs else 'dispatches'} under sync_debug_mode=error with no "
            f"host read; stats {json.dumps(engine.stats())}, executions "
            f"{engine.replay_counts}, graphs {json.dumps(engine.graph_stats())}")
        if guarded[0] == 0:
            raise AssertionError("speculative path: no dispatch ran under the sync guard")
        f0, s0, g0 = arena.fetch_stats(), engine.stats(), engine.graph_stats()
        pt0, lc0, x0 = dict(engine.phase_timings), dict(engine.lease_counts), engine.executed_steps
        r0, l0, k0 = len(engine.replay_counts), len(engine.spec_log), len(engine._k_trace)
        host, untime = _host_timer(engine)
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = engine.generate(ids, **gen)
            torch.cuda.synchronize()
        finally:
            untime()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = engine.executed_steps - x0
        f1, s1, g1 = arena.fetch_stats(), engine.stats(), engine.graph_stats()
        warm = g1.get("warmup_steps", 0) - g0.get("warmup_steps", 0)
        dw = engine.decode_window_stats()
        st = res.stats
        execs = engine.replay_counts[r0:]
        timings = {k: round(v - pt0.get(k, 0.0), 6) for k, v in engine.phase_timings.items()}
        say(f"[spec] {tag}: sequences shape {res.sequences.shape}; first row "
            f"{res.sequences[0].tolist()}")
        cap_s = g1.get("capture_s", 0) - g0.get("capture_s", 0)
        TOKENS_PER_S[tag] = len(SRC_LENS) * NEW_TOKENS / (st["decode_ms"] / 1e3)
        say(f"[spec] {tag}: encode_ms={st['encode_ms']:.3f} decode_ms_per_token="
            f"{st['decode_ms'] / NEW_TOKENS:.3f} tokens_per_s="
            f"{len(SRC_LENS) * NEW_TOKENS / (st['decode_ms'] / 1e3):.1f} wall_s={wall:.3f} "
            f"host_ms_per_execution={host[0] * 1e3 / max(1, host[1]):.3f} (without "
            f"captures {(host[0] - cap_s) * 1e3 / max(1, host[1]):.3f}; {host[1]} executions "
            f"queued) max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        say(f"[spec] {tag}: blocks={len(execs)} executions={execs} k_trace="
            f"{engine._k_trace[k0:]} k_now={engine.spec_block} chosen={engine._chosen} "
            f"executed_steps={steps} speculative={engine.speculative} step_times="
            f"{[(n, round(t, 4)) for n, t in engine.step_times]}")
        say(f"[spec] {tag}: graphs {json.dumps(g1)}; in the timed generate: captures "
            f"{g1.get('captures', 0) - g0.get('captures', 0)}, capture_s {cap_s:.3f}, "
            f"warm-up steps {warm}")
        say(f"[spec] {tag}: speculative_stats {json.dumps(speculative_stats(execs))} (all: "
            f"{json.dumps(speculative_stats(engine.replay_counts))}) spec_block_diag "
            f"{json.dumps(spec_block_diag(engine.spec_log[l0:]))}")
        say(f"[spec] {tag}: phase_timings (timed generate, s) {json.dumps(timings)}")
        say(f"[spec] {tag}: decode window: hit_rate={dw['decode_hit_rate']:.4f} visits="
            f"{dw['visits']} misses={dw['misses']} evictions={dw['evictions']} miss_by_layer="
            f"{dw['miss_by_layer']} miss_churn={dw['miss_churn']} miss_fresh={dw['miss_fresh']} "
            f"distinct_routed={dw['distinct_routed']}")
        say(f"[spec] {tag}: timed generate: visits={s1['visits'] - s0['visits']} misses="
            f"{s1['misses'] - s0['misses']} evictions={s1['evictions'] - s0['evictions']} "
            f"prefetches={s1['prefetches'] - s0['prefetches']} fetches tier="
            f"{f1['fetches_tier'] - f0['fetches_tier']} store="
            f"{f1['fetches_store'] - f0['fetches_store']} lease_evictions="
            f"{f1['lease_evictions'] - f0['lease_evictions']} lease_misses="
            f"{engine.lease_counts.get('lease_misses', 0) - lc0.get('lease_misses', 0)} "
            f"lease_rejects="
            f"{engine.lease_counts.get('lease_rejects', 0) - lc0.get('lease_rejects', 0)} "
            f"fetch_seconds_ewma={f1['fetch_seconds_ewma']:.6f}")
        say(f"[spec] {tag}: tier_gb={tier.stats()['pinned_tier_gb']} arena_gb="
            f"{arena.nbytes() / 2**30:.3f}")
        want = {k: NLLB_ENCODE_LAUNCHES.get(k, 0) + n * (steps + warm)
                for k, n in NLLB_STEP_LAUNCHES.items()}
        say(f"[spec] {tag}: launches {json.dumps(counts)}; expected from {steps} executed "
            f"steps, {warm} warm-up steps of captures and one encode {json.dumps(want)}")
        if res.sequences.shape != (len(SRC_LENS), NEW_TOKENS + 1):
            raise AssertionError(f"unexpected output shape {res.sequences.shape}")
        if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
            raise AssertionError("token ids out of range")
        _require_launched(counts, NLLB_KERNELS, f"NLLB speculative offload path ({tag})")
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"speculative path: launches {counts} != {want}")
        if s1["evictions"] <= 0 or max(engine.replay_counts) <= 1:
            raise AssertionError(f"speculative path: no evictions or no block ran more than "
                                 f"once ({s1}, {engine.replay_counts})")
        if graphs and (g1["recaptures"] or g1["replays"] - g0["replays"] != sum(execs)):
            raise AssertionError(f"speculative path: every execution a replay, no recapture "
                                 f"expected ({g0} -> {g1}, executions {execs})")
        runs[tag] = res.sequences
        _profile_spec_block(engine, ids, mask, tag)
        if graphs and extra is not None:
            extra["phase_s2s_batcher_offload"] = _subphase(phase_s2s_batcher_offload, dev,
                                                           (b, engine))
    finally:
        arena.shutdown()
    del engine, arena
    torch.cuda.empty_cache()
    return counts


def _profile_spec_block(engine, ids, mask, tag, cap=32):
    """One encode through the engine, one block, then two blocks at the size
    the hill-climb holds, under the profiler and under cProfile, over the
    buffers the engine's graphs read (a cache of ``cap`` columns)."""
    model = engine.model
    dev = model.device
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    B, k = tok.shape[0], engine.spec_block
    seq_ids = [engine.tracer.create_entry() for _ in range(B)]
    with torch.inference_mode():
        _, cross = engine.run_encoder(tok, m, seq_ids)
        engine._prefetch_decoder_tier(seq_ids)
        kvs, m, cross = engine.decode_state(B, cap, m, cross)
        state = {"cur": torch.full((B, 1), model.spec.decoder_start_token_id,
                                   dtype=torch.int32, device=dev), "step": 0}

        def block():
            toks, _ = engine._speculative_block(state["cur"], state["step"], kvs, m, cross,
                                                engine.dec_mlis, seq_ids, k)
            state["cur"] = torch.as_tensor(toks[:, -1:], dtype=torch.int32).to(dev)
            state["step"] += k

        block()
        r0 = len(engine.replay_counts)
        _profile_streams(f"speculative block ({B} rows, k={k}, {len(engine.dec_mlis)} MoE "
                         f"layers, {tag})", block, 2)
        _host_profile(f"speculative block (k={k}, {tag})", block, 2)
        say(f"[profile] executions of the profiled blocks {engine.replay_counts[r0:]}; "
            f"graphs {json.dumps(engine.graph_stats())}")
    for sid in seq_ids:
        engine.tracer.finish_entry(sid)


PARITY_TOKENS = 24  # the f32 whole paths' greedy tokens per request (phases 15, 17, 18)
SPEC_PARITY_TOKENS = 8  # phase 12's (cut from 24 to 16, then 8, for the whole run's time limit)


def _same_or_close(what, got, want):
    """Graph against eager logits: bit for bit, else within 1e-5 (printed
    with the difference; greedy tokens are held equal beside it)."""
    torch.cuda.synchronize()
    if torch.equal(got, want):
        return "bit-equal"
    err = (got.float() - want.float()).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"{what}: graph and eager logits differ by {err:.3e}")
    return f"within {err:.3e}"


def _spec_case(model, params, store, tier, ids, gen, k, mode, graphs, record, **kw):
    """One speculative generate at block size k in ``mode``, with graphs on
    or off (``kw``: more engine options). record: "steps" keeps every
    accepted whole step's logits (k=1), "step0" step 0's logits of every
    eager execution (the last is the accepted one), None nothing. Returns
    (result, logits, engine, counts)."""
    import os

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    engine = _offload_engine(model, params, store, store.num_experts, tier, speculative=True,
                             spec_block=k, graphs=graphs, **kw)
    logits = []
    if record == "steps":
        step_fn = engine._speculative_step

        def recording_step(*a):
            out = step_fn(*a)
            logits.append(out[0].clone())
            return out

        engine._speculative_step = recording_step
    elif record == "step0":  # eager only: the step is an int there
        decode_step = model.decode_step

        def recording(*a, **kw):
            out = decode_step(*a, **kw)
            if a[5] == 0:
                logits.append(out[0].clone())
            return out

        model.decode_step = recording
    kept = os.environ.get("MOE_SPEC_BLOCK_MODE")
    os.environ["MOE_SPEC_BLOCK_MODE"] = mode
    try:
        reset_launches()
        res = engine.generate(ids, **gen)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        if record == "step0":
            del model.decode_step
        if kept is None:
            del os.environ["MOE_SPEC_BLOCK_MODE"]
        else:
            os.environ["MOE_SPEC_BLOCK_MODE"] = kept
        engine.arena.shutdown()
    return res, logits, engine, counts


def phase_offload_spec_whole_path(dev, seeds=PARITY_SEEDS, blocks=PARITY_BLOCKS):
    """The speculative engine at full width, 4+4 blocks with every 2nd
    sparse, an arena of E slots, prefetch on and 4 workers (phase 10's
    set-up), on seeds 11 (store only) and 12 (decoder records in a tier
    copied from the store), ``SPEC_PARITY_TOKENS`` greedy tokens per
    request:

    * f32, against the resident Seq2SeqGenerator: whole steps (k=1) and
      blocks of 4 in both MOE_SPEC_BLOCK_MODE modes, each with graphs (the
      main path) and eagerly; greedy tokens equal, the first accepted
      step's logits within the tolerance (k=1 both ways; k=4 eagerly, where
      a block's logits are not kept inside a graph), and at k=1 every
      accepted step's logits of the graph run equal to the eager run's; the
      resident generator's 24 steps, graph against eager, likewise;
    * bf16: graph and eager greedy tokens equal at k = 1, 2 and 4 in both
      block modes.

    Some step or block must run more than once."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=blocks, decoder_layers=blocks,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    E = spec.num_experts
    replays = []
    for seed, staged in seeds:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        model = NllbModel(spec, compute_dtype=torch.float32, device=dev)
        params, _ = model.init_random(g, with_experts=False)
        store = _offload_store(spec, seed=seed, cache_records=4 * E)
        provider = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
        tier = None
        if staged:
            n_dec = (store.num_layers - store.meta["num_encoder_moe_layers"]) * E
            tier = PinnedExpertTier(store, device=dev, shared_record=False,
                                    max_bytes=n_dec * store.stride, synth_on_device=False)
        ids, mask = _requests(spec.vocab_size, g, dev)
        where = f"{'tier + store' if staged else 'store only'}"
        gen = dict(max_new_tokens=SPEC_PARITY_TOKENS, attention_mask=mask, eos_token_id=None)
        resident = {gr: Seq2SeqGenerator(model, params, provider.pytree(),
                                         ResidentProvider.for_layer, impl="pallas", graphs=gr)
                    for gr in (True, False)}
        want = resident[True].generate(ids, **gen)
        if not np.array_equal(want.sequences, resident[False].generate(ids, **gen).sequences):
            raise AssertionError(f"resident graph and eager tokens differ (seed {seed})")
        _resident_graph_parity(model, params, provider, resident, ids, mask, seed,
                               SPEC_PARITY_TOKENS)
        want_logits = _first_step_logits(model, params, provider, ids, mask, "pallas")
        for k, mode in ((1, "whole"), (4, "whole"), (4, "prefix")):
            runs = {}
            for graphs in (True, False):
                record = "steps" if k == 1 else (None if graphs else "step0")
                got, logits, engine, counts = _spec_case(model, params, store, tier, ids, gen,
                                                         k, mode, graphs, record)
                tag = "graphs" if graphs else "eager"
                what = f"seed {seed} k={k} {mode} {tag}"
                runs[tag] = logits
                _require_launched(counts, NLLB_KERNELS,
                                  f"NLLB speculative whole-path check {what}")
                stats, fetch = engine.stats(), engine.arena.fetch_stats()
                say(f"[check] speculative {what} ({where}): {E} slots, executions "
                    f"{engine.replay_counts}, evictions {stats['evictions']}, misses "
                    f"{stats['misses']}, lease_evictions {fetch['lease_evictions']}, "
                    f"{json.dumps(engine.lease_counts)}, speculative={engine.speculative}, "
                    f"graphs {json.dumps(engine.graph_stats())}")
                if logits:
                    compare(f"speculative vs resident first accepted step's logits f32 {what} "
                            f"(full width, {blocks}+{blocks} blocks, int4 experts, {E}-slot arena)",
                            logits[0] if record == "steps" else logits[-1], want_logits)
                elif record is not None:
                    raise AssertionError(f"{what}: step 0 never ran speculatively")
                same = np.array_equal(got.sequences, want.sequences)
                say(f"[check] speculative vs resident greedy tokens {what}: "
                    f"{'equal' if same else 'DIFFER'} {got.sequences[0].tolist()}")
                if not same:
                    raise AssertionError(f"speculative tokens differ from the resident "
                                         f"path's ({what})")
                replays += engine.replay_counts
                del engine
            if k == 1:
                if (len(runs["graphs"]) != SPEC_PARITY_TOKENS
                        or len(runs["eager"]) != SPEC_PARITY_TOKENS):
                    raise AssertionError(f"k=1: {len(runs['graphs'])} and {len(runs['eager'])} "
                                         f"accepted steps recorded, {SPEC_PARITY_TOKENS} expected")
                how = [_same_or_close(f"offload k=1 step {i} seed {seed}", a, b)
                       for i, (a, b) in enumerate(zip(runs["graphs"], runs["eager"]))]
                say(f"[check] offload k=1 f32 graph against eager logits over "
                    f"{SPEC_PARITY_TOKENS} accepted steps, seed {seed}: "
                    f"{sum(h == 'bit-equal' for h in how)} bit-equal, others {sorted(set(how))}")
        del model, params, provider, resident
        torch.cuda.empty_cache()
        _bf16_graph_parity(dev, spec, store, tier, seed, where)
        del store, tier
        torch.cuda.empty_cache()
    if max(replays) <= 1:
        raise AssertionError("speculative whole-path check: no step or block ran twice")


def _resident_graph_parity(model, params, provider, resident, ids, mask, seed,
                           n=PARITY_TOKENS):
    """The resident generator's decode step, graph against eager, at f32
    over n steps fed the eager argmax."""
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev = model.device
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    with torch.inference_mode():
        cross = model.cross_kv(params, model.encode(params, provider.pytree(), tok, m,
                                                    ResidentProvider.for_layer, "pallas"))
        steps = [resident[gr].decoder(tok.shape[0], 32, m, cross) for gr in (True, False)]
        cur = torch.full((tok.shape[0], 1), model.spec.decoder_start_token_id,
                         dtype=torch.int32, device=dev)
        how = []
        for i in range(n):
            (lg, ng), (le, ne) = (st(cur, i) for st in steps)
            how.append(_same_or_close(f"resident step {i} seed {seed}", lg, le))
            if not torch.equal(ng, ne):
                raise AssertionError(f"resident step {i}: graph and eager tokens differ")
            cur = ne[:, None].to(torch.int32)
    say(f"[check] resident f32 graph against eager logits over {n} steps, seed "
        f"{seed}: {sum(h == 'bit-equal' for h in how)} bit-equal, others {sorted(set(how))}")


def _bf16_graph_parity(dev, spec, store, tier, seed, where):
    """bf16 weights from the same seed: the speculative engine's greedy
    tokens with graphs and eagerly, at k = 1, 2 and 4 in both block modes."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = NllbModel(spec, compute_dtype=torch.bfloat16, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    ids, mask = _requests(spec.vocab_size, g, dev)
    gen = dict(max_new_tokens=SPEC_PARITY_TOKENS, attention_mask=mask, eos_token_id=None)
    for k, mode in ((1, "whole"), (2, "whole"), (2, "prefix"), (4, "whole"), (4, "prefix")):
        seqs, execs = [], []
        for graphs in (True, False):
            res, _, engine, _ = _spec_case(model, params, store, tier, ids, gen, k, mode,
                                           graphs, None)
            seqs.append(res.sequences)
            execs.append(engine.replay_counts)
        same = np.array_equal(seqs[0], seqs[1])
        say(f"[check] bf16 graph against eager greedy tokens seed {seed} k={k} {mode} "
            f"({where}): {'equal' if same else 'DIFFER'}; executions {execs[0]} / {execs[1]}")
        if not same:
            raise AssertionError(f"bf16 graph and eager tokens differ (seed {seed} k={k} "
                                 f"{mode})")
    del model, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 13 to 15: Switch-large-128 (K2 at head dim 64 with the T5 bias)
# ---------------------------------------------------------------------------

SW_BASELINE_TOKENS_PER_S = 69.105  # the reference at batch 32 (BASELINE.md:24)


def _switch_requests(vocab, B=None):
    """bench.py's Switch prompts (``bench_switch_throughput``, :775-778): 32
    (or B) rows of 16 tokens, ``(arange(T) * 13 + row) % (vocab - 1)``,
    unpadded."""
    B, T = B or SW_BATCH, SW_PROMPT
    ids = (np.arange(T)[None].repeat(B, 0) * 13 + np.arange(B)[:, None]) % (vocab - 1)
    return ids.astype(np.int64), np.ones((B, T), dtype=np.float32)


def _switch_store(spec, seed=0, cache_records=64):
    """bench.py's ``bench_switch_servable`` store (:1823-1835): packed int4
    ``wi``/``wo`` with f32 scales for every MoE layer, SyntheticStore records
    distinct per expert, the encoder's 12 MoE layers first."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    D, F, E = spec.d_model, spec.d_ff, spec.num_experts
    n_enc = sum(spec.is_sparse(i, False) for i in range(spec.num_encoder_layers))
    fields = [("wi.weight", (D, F // 2), "int4"), ("wi.weight.scale", (F,), "float32"),
              ("wo.weight", (F, D // 2), "int4"), ("wo.weight.scale", (D,), "float32")]
    return SyntheticStore(spec.num_moe_layers, E, fields,
                          meta={"arch": "switch", "num_encoder_moe_layers": n_enc}, seed=seed,
                          distinct_records=True, cache_records=cache_records)


def _free_host_cache():
    """Return the caching host allocator's free page-locked blocks (an earlier
    phase's tier) to the system, where this PyTorch has the call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def _want_launches(spec, encodes, steps):
    """K2 and K3 launches of ``encodes`` encodes and ``steps`` decoder steps:
    a self-attention per encoder block, a self- and a cross-attention per
    decoder block, gate and down per MoE layer (Switch-large-128: 24 and 24
    per encode, 48 and 24 per step)."""
    n_enc = sum(spec.is_sparse(i, False) for i in range(spec.num_encoder_layers))
    n_dec = spec.num_moe_layers - n_enc
    return {"flash_attend_dh64": spec.num_encoder_layers * encodes
            + 2 * spec.num_decoder_layers * steps,
            "gmm": 2 * n_enc * encodes + 2 * n_dec * steps}


def phase_switch(dev, extra=None):
    """Switch-large-128 resident: ``Seq2SeqGenerator`` over all 24 x 128
    packed int4 experts made on the card, impl="pallas", bench.py's 32
    prompts of 16 tokens, 64 greedy tokens; eagerly, then each decode step a
    replay of its CUDA graph. Each run after a warm-up generate at its
    shapes; launches held to 24 K2 and 24 K3 per encode and 48 K2 and 24
    K3 per step (``_want_launches``); then a profile of one decode step."""
    from moe_infinity_tpu_torch.models.switch import SwitchSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = SwitchSpec(**SWITCH_LARGE_128)
    say(f"[switch] Switch-large-128, depth {spec.num_encoder_layers}+{spec.num_decoder_layers} "
        f"blocks ({spec.num_moe_layers} MoE layers x {spec.num_experts} experts, top-1, "
        f"capacity {spec.expert_capacity}), d_kv {spec.d_kv}, bf16 compute, int4 experts, "
        f"impl=pallas, batch {SW_BATCH}, prompts of {SW_PROMPT}, {SW_TOKENS} tokens")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, provider = _switch_resident(dev)
    torch.cuda.synchronize()
    say(f"[switch] weights built on the card in {time.perf_counter() - t0:.1f} s; experts "
        f"{provider.nbytes() / 1e9:.2f} GB, dense {_tree_bytes(params) / 1e9:.2f} GB, "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ids, mask = _switch_requests(spec.vocab_size)
    runs, counts = {}, {}
    gen_kw = dict(max_new_tokens=SW_TOKENS, attention_mask=mask, eos_token_id=None)
    for graphs in (False, True):
        tag = "graphs" if graphs else "eager"
        gen = Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer,
                               impl="pallas", graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        gen.generate(ids, **gen_kw)  # warm-up at the timed shapes: its capture
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = gen.generate(ids, **gen_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st, gst = res.stats, gen.graph_stats()
        tps = SW_BATCH * SW_TOKENS / (st["decode_ms"] / 1e3)
        say(f"[switch] {tag}: sequences shape {res.sequences.shape}; first row "
            f"{res.sequences[0].tolist()}")
        say(f"[switch] {tag}: tokens_per_s={tps:.1f} vs_baseline="
            f"{tps / SW_BASELINE_TOKENS_PER_S:.3f} (the reference's "
            f"{SW_BASELINE_TOKENS_PER_S} at batch 32) decode_ms_per_token="
            f"{st['decode_ms'] / SW_TOKENS:.3f} encode_ms={st['encode_ms']:.3f} wall_s={wall:.3f} "
            f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} graphs "
            f"{json.dumps(gst)}")
        want = _want_launches(spec, 1, SW_TOKENS)
        say(f"[switch] {tag}: launches {json.dumps(counts)}; expected {json.dumps(want)}")
        if res.sequences.shape != (SW_BATCH, SW_TOKENS + 1):
            raise AssertionError(f"unexpected output shape {res.sequences.shape}")
        if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
            raise AssertionError("token ids out of range")
        _require_launched(counts, SWITCH_KERNELS, f"Switch resident path ({tag})")
        if any(counts.get(k) != n for k, n in want.items()):
            raise AssertionError(f"Switch resident path: launches {counts} != {want}")
        if graphs and (gst["captures"] != 1 or gst["recaptures"] or gst["replays"] != 2 * SW_TOKENS):
            raise AssertionError(f"graphs: one capture and a replay per step expected ({gst})")
        runs[tag] = res.sequences
        _profile_main_path(model, params, provider, ids, mask, gen, tag, cap=SW_CAP,
                           what="Switch ")
        del gen
        torch.cuda.empty_cache()
    same = np.array_equal(runs["graphs"], runs["eager"])
    say(f"[switch] graphs against eager greedy tokens: {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("Switch: graph and eager tokens differ")
    logits = _first_step_logits(model, params, provider, ids, mask, "pallas")
    if not bool(torch.isfinite(logits).all()) or logits.shape != (SW_BATCH, 1, spec.vocab_size):
        raise AssertionError(f"Switch first-step logits: shape {tuple(logits.shape)} or not finite")
    say(f"[switch] first-step logits finite, shape {tuple(logits.shape)}")
    if extra is not None:
        extra["phase_switch_batcher"] = _subphase(phase_switch_batcher, dev,
                                                  (model, params, provider))
    del params, provider, model, logits
    torch.cuda.empty_cache()
    return counts


def phase_switch_offload(dev):
    """Switch-large-128 served as ``bench.py``'s ``switch-servable`` preset
    builds it (``bench_switch_servable``, :1789-1900): bf16 dense weights
    from a seed, the int4 store of 3,072 records, a 14 GiB page-locked tier
    with layer-aligned segments (``--tier-gb 14``), slots from ``--hbm-gb
    13`` less the dense bytes and 1.2 GiB of KV reserve, the EAMC tracer
    (256 sequences, 12 encoder MoE layers) and predictor, prefetch with
    lookahead 3, the ``priority`` policy, ``speculative=True``,
    ``spec_block=4``, ``max_direct_layers=0``; each step and block a replay
    of its CUDA graph. bench.py's warm-up generate (7 tokens) under the
    sync-debug guard, then the timed one: 32 prompts of 16, 64 tokens; then
    a profile of one block on the device and on the host."""
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.engine import speculative_stats
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = SwitchSpec(**SWITCH_LARGE_128)
    E = spec.num_experts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    model = SwitchModel(spec, compute_dtype=torch.bfloat16, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    dense = _tree_bytes(params)
    store = _switch_store(spec, cache_records=spec.num_moe_layers * E)
    tier = PinnedExpertTier(store, device=dev, shared_record=False, max_bytes=TIER_GB * 2**30,
                            align_rows=E, synth_on_device=True)
    torch.cuda.synchronize()
    t_tier = time.perf_counter() - t0
    n_rec = store.num_layers * E
    union = (store.num_layers - store.meta["num_encoder_moe_layers"]) * min(E, SW_BATCH)
    slots = max(E, union, int((HBM_GB * 2**30 - dense - int(1.2 * 2**30)) // store.stride))
    engine = _offload_engine(model, params, store, slots, tier, speculative=True, spec_block=4)
    arena = engine.arena
    ids, mask = _switch_requests(spec.vocab_size)
    say(f"[switch-offload] {store.num_layers} MoE layers x {E} experts = {n_rec} int4 records of "
        f"{store.stride / 1e6:.2f} MB ({n_rec * store.stride / 1e9:.2f} GB); dense bf16 "
        f"{dense / 1e9:.2f} GB; tier {json.dumps(tier.stats())} "
        f"{'page-locked' if tier.fields['wi.weight'][0].is_pinned() else 'pageable'}, "
        f"{tier.num_staged} of {n_rec} records; arena {slots} slots ({slots / n_rec:.3f} of the "
        f"experts), {arena.nbytes() / 1e9:.2f} GB; set-up {time.perf_counter() - t0:.1f} s "
        f"(tier {t_tier:.1f} s)")
    cap = SW_CAP
    try:
        guarded, unguard = _sync_guard(engine)
        t1 = time.perf_counter()
        try:
            engine.generate(ids, max_new_tokens=2 * engine.spec_block - 1, attention_mask=mask,
                            eos_token_id=None, cache_len=cap)
            torch.cuda.synchronize()
        finally:
            unguard()
        say(f"[switch-offload] warm-up generate {time.perf_counter() - t1:.1f} s, {guarded[0]} "
            f"replays under sync_debug_mode=error; executions {engine.replay_counts}, graphs "
            f"{json.dumps(engine.graph_stats())}")
        if guarded[0] == 0:
            raise AssertionError("Switch offload: no replay ran under the sync guard")
        f0, s0, g0 = arena.fetch_stats(), engine.stats(), engine.graph_stats()
        pt0, x0, r0 = dict(engine.phase_timings), engine.executed_steps, len(engine.replay_counts)
        host, untime = _host_timer(engine)
        reset_launches()
        t1 = time.perf_counter()
        try:
            res = engine.generate(ids, max_new_tokens=SW_TOKENS, attention_mask=mask,
                                  eos_token_id=None, cache_len=cap)
            torch.cuda.synchronize()
        finally:
            untime()
        wall = time.perf_counter() - t1
        counts = launch_counts()
        steps = engine.executed_steps - x0
        f1, s1, g1 = arena.fetch_stats(), engine.stats(), engine.graph_stats()
        warm = g1.get("warmup_steps", 0) - g0.get("warmup_steps", 0)
        cap_s = g1.get("capture_s", 0) - g0.get("capture_s", 0)
        execs = engine.replay_counts[r0:]
        dw, st = engine.decode_window_stats(), res.stats
        tps = SW_BATCH * SW_TOKENS / (st["decode_ms"] / 1e3)
        timings = {k: round(v - pt0.get(k, 0.0), 6) for k, v in engine.phase_timings.items()}
        say(f"[switch-offload] sequences shape {res.sequences.shape}; first row "
            f"{res.sequences[0].tolist()}")
        say(f"[switch-offload] tokens_per_s={tps:.1f} vs_baseline="
            f"{tps / SW_BASELINE_TOKENS_PER_S:.3f} decode_ms_per_token="
            f"{st['decode_ms'] / SW_TOKENS:.3f} encode_ms={st['encode_ms']:.3f} wall_s="
            f"{wall:.3f} host_ms_per_execution={host[0] * 1e3 / max(1, host[1]):.3f} (without "
            f"captures {(host[0] - cap_s) * 1e3 / max(1, host[1]):.3f}; {host[1]} executions) "
            f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        say(f"[switch-offload] slots={slots} decode hit_rate={dw['decode_hit_rate']:.4f} "
            f"visits={dw['visits']} misses={dw['misses']} evictions={dw['evictions']}; timed "
            f"generate: misses={s1['misses'] - s0['misses']} evictions="
            f"{s1['evictions'] - s0['evictions']} prefetches={s1['prefetches'] - s0['prefetches']} "
            f"fetches tier={f1['fetches_tier'] - f0['fetches_tier']} store="
            f"{f1['fetches_store'] - f0['fetches_store']}")
        say(f"[switch-offload] blocks={len(execs)} executions={execs} "
            f"speculative_stats {json.dumps(speculative_stats(execs))} block size held "
            f"k={engine.spec_block} chosen={engine._chosen} executed_steps={steps} "
            f"speculative={engine.speculative}")
        say(f"[switch-offload] graphs {json.dumps(g1)}; in the timed generate: captures "
            f"{g1.get('captures', 0) - g0.get('captures', 0)}, replays "
            f"{g1['replays'] - g0['replays']}, capture_s {cap_s:.3f}, warm-up steps {warm}")
        say(f"[switch-offload] phase_timings (timed generate, s) {json.dumps(timings)}")
        want = _want_launches(spec, 1, steps + warm)
        say(f"[switch-offload] launches {json.dumps(counts)}; expected from {steps} executed "
            f"steps, {warm} warm-up steps of captures and one encode {json.dumps(want)}")
        if res.sequences.shape != (SW_BATCH, SW_TOKENS + 1):
            raise AssertionError(f"unexpected output shape {res.sequences.shape}")
        if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
            raise AssertionError("token ids out of range")
        _require_launched(counts, SWITCH_KERNELS, "Switch speculative offload path")
        if any(counts.get(k) != n for k, n in want.items()):
            raise AssertionError(f"Switch offload: launches {counts} != {want}")
        if not engine.speculative or g1["recaptures"] or g1["replays"] - g0["replays"] != sum(execs):
            raise AssertionError(f"Switch offload: every execution a replay, no recapture, the "
                                 f"speculative path kept expected ({g0} -> {g1}, {execs})")
        _profile_spec_block(engine, ids, mask, "Switch, graphs", cap=SW_CAP)
    finally:
        arena.shutdown()
    del engine, arena, tier, store, params, model
    torch.cuda.empty_cache()
    return counts


def phase_switch_whole_path(dev):
    """Switch at full width and 4+4 blocks (2+2 MoE layers), 8 rows of
    bench.py's prompts padded to 16, 12, 9 and 5 tokens, experts from one
    int4 store (the resident generator over its own records,
    ``from_store``). At f32: the per-layer offload engine (128 slots,
    evictions at every MoE layer) and the speculative one (k = 1 and k = 4,
    graphs) against the resident path: greedy tokens equal and first-step
    logits bit-equal; the resident generator's graph step against its eager
    step, logits bit-equal over 24 steps. At bf16: the first step's logits
    through the kernels against the plain versions, reported per request
    with the argmax (as phase 4 reports NLLB's)."""
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = SwitchSpec(**dict(SWITCH_LARGE_128, num_encoder_layers=4, num_decoder_layers=4))
    E, B = spec.num_experts, 8
    ids, mask = _switch_requests(spec.vocab_size, B)
    for i, n in enumerate((16, 12, 9, 5, 16, 12, 9, 5)):
        mask[i, n:] = 0.0
    gen = dict(max_new_tokens=PARITY_TOKENS, attention_mask=mask, eos_token_id=None)
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    model = SwitchModel(spec, compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _switch_store(spec, seed=31, cache_records=spec.num_moe_layers * E)
    provider = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    resident = {gr: Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer,
                                     impl="pallas", graphs=gr) for gr in (True, False)}
    want = resident[False].generate(ids, **gen)
    if not np.array_equal(resident[True].generate(ids, **gen).sequences, want.sequences):
        raise AssertionError("Switch resident: graph and eager tokens differ")
    want_logits = _first_step_logits(model, params, provider, ids, mask, "pallas")
    engine = _offload_engine(model, params, store, E, None)
    try:
        reset_launches()
        got_logits = _offload_first_step(engine, ids, mask)
        got = engine.generate(ids, **gen)
        torch.cuda.synchronize()
        counts, stats = launch_counts(), engine.stats()
    finally:
        engine.arena.shutdown()
    _require_launched(counts, SWITCH_KERNELS, "Switch offload whole-path check")
    same_logits = torch.equal(got_logits, want_logits)
    same = np.array_equal(got.sequences, want.sequences)
    say(f"[check] Switch per-layer offload vs resident f32 (full width, 4+4 blocks, int4 "
        f"experts, {E}-slot arena, evictions {stats['evictions']}): first-step logits "
        f"{'bit-equal' if same_logits else 'DIFFER by %.3e' % (got_logits - want_logits).abs().max()}, "
        f"greedy tokens {'equal' if same else 'DIFFER'} {got.sequences[0].tolist()}")
    if not (same and same_logits) or stats["evictions"] <= 0:
        raise AssertionError("Switch offload differs from the resident path (or no eviction)")
    for k in (1, 4):
        res, logits, eng, _ = _spec_case(model, params, store, None, ids, gen, k, "whole", True,
                                         "steps" if k == 1 else None)
        same = np.array_equal(res.sequences, want.sequences)
        first = logits and torch.equal(logits[0], want_logits)
        say(f"[check] Switch speculative k={k} graphs vs resident f32: executions "
            f"{eng.replay_counts}, graphs {json.dumps(eng.graph_stats())}, greedy tokens "
            f"{'equal' if same else 'DIFFER'}"
            + (f", first accepted step's logits {'bit-equal' if first else 'DIFFER'}"
               if k == 1 else ""))
        if not same or (k == 1 and not first) or not eng.speculative:
            raise AssertionError(f"Switch speculative k={k}: differs from the resident path, "
                                 f"or left the speculative path")
        del res, logits, eng
    _resident_graph_parity(model, params, provider, resident, ids, mask, 31)
    del resident, provider, store, params, model
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev)
    g.manual_seed(32)
    model = SwitchModel(spec, compute_dtype=torch.bfloat16, device=dev)
    params, tree = model.init_random(g, expert_dtype="int4")
    provider = ResidentProvider(tree)
    reset_launches()
    got = _first_step_logits(model, params, provider, ids, mask, "pallas")
    counts = launch_counts()
    with _plain_kernels():
        want = _first_step_logits(model, params, provider, ids, mask, "pallas")
    if launch_counts() != counts:
        raise AssertionError(f"the plain run launched kernels: {counts} -> {launch_counts()}")
    _require_launched(counts, SWITCH_KERNELS, "Switch bf16 whole-path check")
    rows = (got - want).abs().amax(dim=(1, 2)).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).all().item()
    say(f"[check] Switch whole path logits bf16 (full width, 4+4 blocks, int4 experts), kernels "
        f"against plain: per-request max_abs_err={['%.3e' % r for r in rows]} argmax "
        f"equal={same} (reported, as phase 4's)")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("Switch bf16 whole-path logits are not finite")
    del model, params, tree, provider, got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 16 to 18: the decoder-only OffloadEngine (Mixtral-8x7B, DeepSeek-V2-Lite)
# ---------------------------------------------------------------------------

MX_PROMPT, MX_TOKENS, MX_CAP = 16, 64, 128  # bench.py's mixtral-offload: 16 + 64, _bucket_len(80)
MX_BASELINE_S_PER_TOKEN = 0.735  # the reference, Mixtral-8x7B on one A5000 (bench.py:309)
# an HBM budget whose arena holds a k=2 block's union at batch 1 (2 x 32 x 2
# = 128 experts): the preset's 13 GiB arena (60 slots) holds less than one
# step's 64, so its speculative path turns off at the first step
MX_SPEC_HBM_GB = 28
# phase 16's depth in the whole run (its arenas cut by the same share), for
# the run's time limit; --mixtral-offload runs the full 32
MX_WHOLE_RUN_DEPTH = 6
MX_WHOLE_RUN_TOKENS = 8  # and its tokens a generate in the whole run, for the same limit
MIXTRAL_KERNELS = ("flash_decode", "flash_attend", "gmm")


def _mixtral_offload_store(spec, distinct=False, seed=0):
    """bench.py's mixtral-offload store (:240-247): int8 w1/w3/w2 with f32
    per-channel scales; by default its one shared record (SyntheticStore's
    default), ``distinct`` a record per expert (the whole-path checks)."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    D, F = spec.hidden_size, spec.intermediate_size
    fields = []
    for tail, shape in (("w1", (D, F)), ("w3", (D, F)), ("w2", (F, D))):
        fields += [(tail + ".weight", shape, "int8"), (tail + ".weight.scale", shape[1:], "float32")]
    return SyntheticStore(spec.num_layers, spec.num_experts, fields,
                          meta={"arch": "mixtral", "gated": True, "num_encoder_moe_layers": 0},
                          seed=seed, distinct_records=distinct,
                          cache_records=spec.num_layers * spec.num_experts)


def _decoder_engine(model, params, store, slots, *, prefetch_budget=4, **kw):
    """bench.py's mixtral-offload engine (:265-286): the priority policy, 4
    fetch workers, the EAMC tracer (256 sequences) and predictor, prefetch
    with lookahead 3 and budget 4, K3 for every expert FFN."""
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.engine import OffloadEngine

    arena = ExpertArena(store, slots, policy="priority", compute_dtype=torch.bfloat16,
                        device=model.device, num_threads=4)
    tracer = ExpertTracer(256, store.num_layers, store.num_experts)
    return OffloadEngine(model, params, arena, tracer=tracer, predictor=ExpertPredictor(tracer),
                         prefetch=True, lookahead=3, prefetch_budget=prefetch_budget,
                         impl="pallas", **kw)


def _decoder_launches(spec, prefills, steps, k3="gmm", moe_layers=None):
    """K1, K2 and K3 launches of ``prefills`` prompt steps and ``steps``
    one-token steps of a Mixtral-like model: an attention per layer (K2 in a
    prefill, K1 in a step), gate, up and down per MoE layer (every layer
    unless ``moe_layers`` says), counted under ``k3`` (``gmm_fp8`` for
    e4m3 experts)."""
    L = spec.num_layers
    M = L if moe_layers is None else moe_layers
    return {"flash_decode": L * steps, "flash_attend": L * prefills,
            k3: 3 * M * (prefills + steps)}


def _mixtral_offload_run(tag, b, slots, graphs, speculative=True):
    """One engine over ``slots`` slots: the warm-up generate at the timed
    capacity (its dispatches under the sync guard), the timed generate of
    ``b.tokens`` tokens (64 for Mixtral), its numbers and its launches held
    exactly. ``b`` also names the run (``b.label``), the capacity
    (``b.cap``), the kernels and K3's count (``b.kernels``, ``b.k3``) and
    the MoE layers (``b.moe_layers``)."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.engine import spec_block_diag, speculative_stats
    from moe_infinity_tpu_torch.runtime.generate import Generator

    import gc

    spec = b.spec
    gc.collect()  # an earlier leg's engine, and its arena, are gone before the peak is reset
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    say(f"[{b.label}] {tag}: allocated before the engine is built "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    label, tokens, cap = b.label, b.tokens, b.cap
    engine = _decoder_engine(b.model, b.params, b.store, slots, speculative=speculative,
                             spec_block=2, graphs=graphs)
    arena, gen = engine.arena, Generator(stepper=engine, max_seq_len=256)
    try:
        guarded, unguard = _sync_guard(engine)
        t0 = time.perf_counter()
        try:
            # 4 tokens: a block of 2 and a whole step, so the timed run captures nothing
            gen.generate(b.prompt, max_new_tokens=4, cache_len=cap)
            torch.cuda.synchronize()
        finally:
            unguard()
        warm_s = time.perf_counter() - t0
        say(f"[{label}] {tag}: warm-up generate {warm_s:.1f} s, {guarded[0]} dispatches "
            f"under sync_debug_mode=error; executions {engine.replay_counts}, speculative="
            f"{engine.speculative} spec_block={engine.spec_block}, graphs "
            f"{json.dumps(engine.graph_stats())}")
        f0, s0, g0 = arena.fetch_stats(), engine.stats(), engine.graph_stats()
        pt0, x0, r0 = dict(engine.phase_timings), engine.executed_steps, len(engine.replay_counts)
        host, untime = _host_timer(engine)
        reset_launches()
        t0 = time.perf_counter()
        try:
            res = gen.generate(b.prompt, max_new_tokens=tokens, cache_len=cap)
            torch.cuda.synchronize()
        finally:
            untime()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = engine.executed_steps - x0
        f1, s1, g1 = arena.fetch_stats(), engine.stats(), engine.graph_stats()
        warm = g1.get("warmup_steps", 0) - g0.get("warmup_steps", 0)
        cap_s = g1.get("capture_s", 0) - g0.get("capture_s", 0)
        execs = engine.replay_counts[r0:]
        visits, hits = s1["visits"] - s0["visits"], s1["hits"] - s0["hits"]
        per_tok = wall / (tokens + 1)  # bench.py: the prefill counts as one step
        timings = {k: round(v - pt0.get(k, 0.0), 6) for k, v in engine.phase_timings.items()}
        say(f"[{label}] {tag}: sequences shape {res.sequences.shape}; new tokens "
            f"{res.sequences[0, b.prompt.shape[1]:].tolist()}")
        vs = (f" vs_baseline={MX_BASELINE_S_PER_TOKEN / per_tok:.3f} (the reference's "
              f"{MX_BASELINE_S_PER_TOKEN} s/token)" if label == "mixtral-offload"
              else "")
        say(f"[{label}] {tag}: s_per_token={per_tok:.4f}{vs} tokens_per_s={tokens / wall:.2f} wall_s="
            f"{wall:.3f} hit_rate={hits / max(1, visits):.4f} (engine life "
            f"{s1['hit_rate']:.4f}) max_memory_allocated_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        say(f"[{label}] {tag}: speculative={engine.speculative} executions per block or "
            f"step {execs} ({json.dumps(speculative_stats(execs))}) block size held "
            f"k={engine.spec_block} executed_steps={steps} host_ms_per_execution="
            f"{host[0] * 1e3 / max(1, host[1]):.3f} (without captures "
            f"{(host[0] - cap_s) * 1e3 / max(1, host[1]):.3f}; {host[1]} executions) "
            f"diag {json.dumps(spec_block_diag(getattr(engine, 'spec_log', [])))}")
        say(f"[{label}] {tag}: timed generate: visits={visits} misses="
            f"{s1['misses'] - s0['misses']} evictions={s1['evictions'] - s0['evictions']} "
            f"prefetches={s1['prefetches'] - s0['prefetches']} fetches store="
            f"{f1['fetches_store'] - f0['fetches_store']} fetch_seconds_ewma="
            f"{f1['fetch_seconds_ewma']:.6f}; graphs {json.dumps(g1)} (in the timed generate: "
            f"captures {g1.get('captures', 0) - g0.get('captures', 0)}, replays "
            f"{g1.get('replays', 0) - g0.get('replays', 0)}, warm-up steps {warm}); "
            f"phase_timings (s) {json.dumps(timings)}")
        want = _decoder_launches(spec, 1, steps + warm, b.k3, b.moe_layers)
        say(f"[{label}] {tag}: launches {json.dumps(counts)}; expected from one "
            f"prefill, {steps} executed steps and {warm} warm-up steps of captures "
            f"{json.dumps(want)}")
        if res.sequences.shape != (1, b.prompt.shape[1] + tokens):
            raise AssertionError(f"unexpected output shape {res.sequences.shape}")
        if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
            raise AssertionError("token ids out of range")
        _require_launched(counts, b.kernels, f"{label} path ({tag})")
        if any(counts.get(k) != n for k, n in want.items()):
            raise AssertionError(f"{label} ({tag}): launches {counts} != {want}")
        if s1["misses"] - s0["misses"] <= 0 or s1["evictions"] - s0["evictions"] <= 0:
            raise AssertionError(f"{label} ({tag}): no miss or no eviction ({s0} -> {s1})")
        if engine.speculative and engine.graphs is not None and (
                g1["recaptures"] or g1["replays"] - g0["replays"] != sum(execs)):
            raise AssertionError(f"{label} ({tag}): every execution a replay and no "
                                 f"recapture expected ({g0} -> {g1}, {execs})")
        return res.sequences, counts, engine.speculative
    finally:
        arena.shutdown()
        del engine, arena, gen
        torch.cuda.empty_cache()


def phase_mixtral_offload(dev, depth=None, tokens=MX_TOKENS):
    """Mixtral-8x7B at full width and depth (bench.py's MIXTRAL_8X7B_SPEC)
    served by the decoder-only ``OffloadEngine`` as bench.py's
    ``mixtral-offload`` preset builds it (:221-320): bf16 dense weights from
    a seed, resident; the int8 ``SyntheticStore`` (its shared record: 256
    experts of 176.29 MB); the priority policy, 4 fetch workers, lookahead 3,
    prefetch budget 4, ``speculative=True``, ``spec_block=2``; one prompt of
    16 tokens, 64 greedy tokens at a capacity of 128, after a warm-up at
    that capacity. First at the preset's ``--hbm-gb 13`` (the arena holds
    fewer experts than one step routes, so speculation turns off at the
    first step and the per-layer path serves), then at an arena that holds a
    block's union (``MX_SPEC_HBM_GB``): eagerly (``graphs=False``), then
    each step and block a CUDA graph replay. Returns the launches of the
    three timed generates. ``tokens``: new tokens a generate. ``depth``:
    fewer layers, each arena cut by the
    same share (the whole run's time limit), so each holds the same share
    of the experts and of a step's union as at full depth."""
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec

    full = MIXTRAL_8X7B["num_layers"]
    spec = MixtralSpec(**dict(MIXTRAL_8X7B, num_layers=depth or full))
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    model = MixtralModel(spec, compute_dtype=torch.bfloat16, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    dense = _tree_bytes(params)
    store = _mixtral_offload_store(spec)
    prompt = (np.arange(MX_PROMPT, dtype=np.int64)[None] * 37) % 31999  # bench.py:294
    b = SimpleNamespace(spec=spec, model=model, params=params, store=store, prompt=prompt,
                        label="mixtral-offload", tokens=tokens, cap=MX_CAP,
                        kernels=MIXTRAL_KERNELS, k3="gmm", moe_layers=None)
    n_rec = spec.num_layers * spec.num_experts
    layer = _tree_bytes(params["layers"][0])
    full_dense = dense + (full - spec.num_layers) * layer  # the dense bytes at full depth
    slots = {gb: max(spec.num_experts,
                     int((gb * 2**30 - full_dense) // store.stride) * spec.num_layers // full)
             for gb in (HBM_GB, MX_SPEC_HBM_GB)}  # bench.py:252-263, cut with the depth
    say(f"[mixtral-offload] Mixtral-8x7B, {spec.num_layers} layers x {spec.num_experts} "
        f"experts = {n_rec} int8 records of {store.stride / 1e6:.2f} MB "
        f"({n_rec * store.stride / 1e9:.2f} GB), dense bf16 {dense / 1e9:.2f} GB; arena "
        f"{slots[HBM_GB]} slots at --hbm-gb {HBM_GB} ({slots[HBM_GB] / n_rec:.3f} of the "
        f"experts), {slots[MX_SPEC_HBM_GB]} at {MX_SPEC_HBM_GB} "
        f"({slots[MX_SPEC_HBM_GB] / n_rec:.3f}); prompt {MX_PROMPT}, {tokens} tokens, "
        f"capacity {MX_CAP}; set-up {time.perf_counter() - t0:.1f} s")
    counts = {}
    seqs, counts["preset"], spec_kept = _mixtral_offload_run(
        f"--hbm-gb {HBM_GB}, graphs", b, slots[HBM_GB], True)
    if spec_kept:
        raise AssertionError("the preset's arena cannot hold a step's union, yet the "
                             "speculative path stayed on")
    runs = {}
    for graphs in (False, True):
        tag = "graphs" if graphs else "eager"
        runs[tag], counts[tag], spec_kept = _mixtral_offload_run(
            f"--hbm-gb {MX_SPEC_HBM_GB}, {tag}", b, slots[MX_SPEC_HBM_GB], graphs)
        if not spec_kept:
            raise AssertionError(f"Mixtral offload ({tag}): the speculative path turned off")
    same = np.array_equal(runs["graphs"], runs["eager"])
    say(f"[mixtral-offload] graphs against eager greedy tokens: "
        f"{'equal' if same else 'DIFFER'}; the preset's per-layer tokens against them: "
        f"{'equal' if np.array_equal(seqs, runs['eager']) else 'differ (bf16, reported)'}")
    if not same:
        raise AssertionError("Mixtral offload: graph and eager tokens differ")
    del b, params, model, store
    torch.cuda.empty_cache()
    return {k: sum(c.get(k, 0) for c in counts.values()) for k in MIXTRAL_KERNELS}


def _decoder_steps(engine, model, params, experts, prompt, n, cap, launches=None, tok=None):
    """Prefill ``prompt`` [B, T] through the engine and the resident model,
    then ``n`` greedy one-token steps of each, both fed the resident
    path's tokens (or ``tok`` [B, 1] at the first step); yields (step,
    engine logits, resident logits). ``launches``: a dict that gathers the
    engine's kernel launches alone."""
    from moe_infinity_tpu_torch.ops import launch_counts
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev = model.device
    B, T = prompt.shape

    def through_engine(*a):
        c0 = launch_counts()
        out = engine.forward(*a)[0]
        if launches is not None:
            for k, v in launch_counts().items():
                launches[k] = launches.get(k, 0) + v - c0[k]
        return out

    x = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    seq_ids = engine.begin_sequences(B)
    kv_o, kv_r = engine.init_cache(B, cap), model.init_cache(B, cap)
    with torch.inference_mode():
        got = through_engine(x, pos, kv_o, 0, seq_ids)
        want, _, _ = model.forward(params, experts, x, pos, kv_r, 0,
                                   for_layer=ResidentProvider.for_layer, impl="pallas")
        yield -1, got, want
        cur = tok if tok is not None else torch.argmax(want[:, -1], -1, keepdim=True).to(
            torch.int32)
        for step in range(T, T + n):
            pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
            got = through_engine(cur, pos, kv_o, step, seq_ids)
            want, _, _ = model.forward(params, experts, cur, pos, kv_r, step,
                                       for_layer=ResidentProvider.for_layer, impl="pallas")
            yield step, got, want
            cur = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
    engine.end_sequences(seq_ids)


def _held_steps(label, engine, model, params, experts, prompt, n, launches, cap=MX_CAP):
    """Every step's logits through ``engine`` bit-equal to the resident
    model's; returns the engine's logits."""
    out = []
    for step, got, want in _decoder_steps(engine, model, params, experts, prompt, n, cap,
                                          launches):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: step {step} differs from the resident path by "
                                 f"{(got - want).abs().max().item():.3e}")
        out.append(got.clone())
    return out


def phase_mixtral_offload_whole_path(dev):
    """Mixtral at full width and 3 layers, f32 compute over int8 slots, one
    row, a prompt of 16 and 24 steps at a capacity of 128 (K1 planned from
    it: two splits, one live), experts from one int8 store with a record
    per expert (the resident model over the same records,
    ``ResidentProvider.from_store``): the per-layer path through an arena of
    one layer plus 4 slots (evictions at every MoE layer) and the
    speculative whole step as a graph through the same arena, each step's
    logits bit-equal to the resident path's; the step eagerly against the
    graph, bit-equal; blocks of 2 in both modes (graphs, 2E slots) through
    ``Generator``, tokens equal to the resident ``Generator``'s."""
    import os

    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = MixtralSpec(**dict(MIXTRAL_8X7B, num_layers=3))
    E, n = spec.num_experts, PARITY_TOKENS
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    model = MixtralModel(spec, compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _mixtral_offload_store(spec, distinct=True, seed=41)
    experts = ResidentProvider.from_store(store, dtype=torch.bfloat16, device=dev).pytree()
    prompt = np.random.default_rng(41).integers(0, spec.vocab_size, (1, MX_PROMPT))
    logits = {}
    for label, kw in (("per-layer", dict(speculative=False)),
                      ("speculative step, graphs", dict(speculative=True)),
                      ("speculative step, eager", dict(speculative=True, graphs=False))):
        engine = _decoder_engine(model, params, store, E + 4, prefetch_budget=8, **kw)
        counts = {}
        try:
            logits[label] = _held_steps(f"Mixtral f32 {label}", engine, model, params,
                                        experts, prompt, n, counts)
            ev = engine.arena.policy.node_stats["evictions"].sum(axis=1)
        finally:
            engine.arena.shutdown()
        _require_launched(counts, MIXTRAL_KERNELS, f"Mixtral whole path ({label})")
        say(f"[check] Mixtral {label} vs resident f32 (full width, 3 layers, int8 experts, "
            f"{E + 4} slots): {n + 1} steps' logits bit-equal; evictions by layer "
            f"{ev.tolist()}, executions {engine.replay_counts}, graphs "
            f"{json.dumps(engine.graph_stats())}, engine launches {json.dumps(counts)}")
        if label == "per-layer" and not (ev > 0).all():
            raise AssertionError(f"Mixtral per-layer: no eviction at some MoE layer ({ev})")
        if kw["speculative"] and (not engine.speculative or max(engine.replay_counts) < 2):
            raise AssertionError(f"Mixtral {label}: left the speculative path, or no step "
                                 f"ran again ({engine.replay_counts})")
    how = [_same_or_close(f"Mixtral step {i}", a, b) for i, (a, b) in enumerate(
        zip(logits["speculative step, graphs"], logits["speculative step, eager"]))]
    say(f"[check] Mixtral f32 speculative step, graph against eager logits over {n + 1} "
        f"steps: {sum(h == 'bit-equal' for h in how)} bit-equal, others {sorted(set(how))}")
    want = Generator(model, params, experts, ResidentProvider.for_layer, impl="pallas").generate(
        prompt, max_new_tokens=n, cache_len=MX_CAP).sequences
    kept = os.environ.get("MOE_SPEC_BLOCK_MODE")
    try:
        for mode in ("whole", "prefix"):
            os.environ["MOE_SPEC_BLOCK_MODE"] = mode
            engine = _decoder_engine(model, params, store, 2 * E, prefetch_budget=8,
                                     speculative=True, spec_block=2)
            try:
                got = Generator(stepper=engine).generate(prompt, max_new_tokens=n,
                                                         cache_len=MX_CAP).sequences
            finally:
                engine.arena.shutdown()
            same = np.array_equal(got, want)
            say(f"[check] Mixtral f32 blocks of 2 ({mode}, graphs, {2 * E} slots) vs resident "
                f"Generator: tokens {'equal' if same else 'DIFFER'}; executions "
                f"{engine.replay_counts}, k held {engine.spec_block}, graphs "
                f"{json.dumps(engine.graph_stats())}")
            if not same or engine.spec_block != 2 or not engine.speculative:
                raise AssertionError(f"Mixtral blocks ({mode}): differ from the resident path, "
                                     f"or the block shrank")
    finally:
        if kept is None:
            os.environ.pop("MOE_SPEC_BLOCK_MODE", None)
        else:
            os.environ["MOE_SPEC_BLOCK_MODE"] = kept
    del model, params, store, experts
    torch.cuda.empty_cache()


def _deepseek_offload_store(spec, seed):
    """V2-Lite's routed experts as bf16 gate/up/down records, one per expert
    (the bench's DeepSeek experts are bf16)."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    D, F = spec.hidden_size, spec.moe_intermediate_size
    n_moe = spec.num_layers - spec.first_k_dense_replace
    fields = [("gate_proj.weight", (D, F), "bfloat16"), ("up_proj.weight", (D, F), "bfloat16"),
              ("down_proj.weight", (F, D), "bfloat16")]
    return SyntheticStore(n_moe, spec.num_experts, fields,
                          meta={"arch": "deepseek", "num_encoder_moe_layers": 0}, seed=seed,
                          distinct_records=True, cache_records=n_moe * spec.num_experts)


def phase_deepseek_offload(dev):
    """DeepSeek-V2-Lite at full width (phase 7's geometry) and 3 layers (the
    dense first layer and 2 MoE layers of 64 experts top-6 plus 2 shared)
    served by the decoder-only ``OffloadEngine``, eagerly (graphs of the MLA
    step are ROADMAP item 10a part 2), bf16 slots from a store with a
    record per expert, one arena of E + 8 slots. At f32 compute, two rows,
    a prompt of 16 and 24 steps: the per-layer path and the speculative
    whole step each bit-equal to the resident path at every step; the
    engine's K5 held to one launch per layer of every one-token step, its
    K3 to three per MoE layer of every step. At bf16: the first decode step
    through the kernels against the plain versions, reported per request
    with the argmax (as phase 4's). Returns the engine's f32 launches."""
    import contextlib

    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = DeepseekV2Spec(**dict(DSV2_LITE, num_layers=3))
    E, n, B, slots = spec.num_experts, PARITY_TOKENS, 2, spec.num_experts + 8
    store = _deepseek_offload_store(spec, 51)
    prompt = np.random.default_rng(51).integers(0, spec.vocab_size, (B, MX_PROMPT))
    counts = {}
    g = torch.Generator(device=dev)
    g.manual_seed(51)
    model = DeepseekV2Model(spec, compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    experts = ResidentProvider.from_store(store, dtype=torch.bfloat16, device=dev).pytree()
    for label, speculative in (("per-layer", False), ("speculative step", True)):
        engine = _decoder_engine(model, params, store, slots, prefetch_budget=8,
                                 speculative=speculative, graphs=False)
        c = counts[label] = {}
        try:
            _held_steps(f"DeepSeek f32 {label}", engine, model, params, experts, prompt, n, c)
        finally:
            engine.arena.shutdown()
        # one prefill and the executed one-token steps (replays included)
        x = engine.executed_steps
        _require_mla_counts(c, x, x + 1, f"DeepSeek offload {label}", layers=spec.num_layers)
        st = engine.stats()
        say(f"[check] DeepSeek-V2-Lite {label} vs resident f32 (full width, 1 dense + 2 MoE "
            f"layers, bf16 experts, {slots} slots, eager): {n + 1} steps' logits bit-equal for "
            f"{B} rows; evictions {st['evictions']}, executions {engine.replay_counts}; "
            f"engine launches {json.dumps(c)}")
        if speculative and (not engine.speculative or not engine.replay_counts):
            raise AssertionError("DeepSeek offload: the speculative path was left")
        if not speculative and st["evictions"] <= 0:
            raise AssertionError("DeepSeek offload: no eviction")
    del model, params
    torch.cuda.empty_cache()

    # bf16: the first decode step (token 7 for every row) through the kernels
    # and through the plain versions on the card
    g = torch.Generator(device=dev)
    g.manual_seed(52)
    model = DeepseekV2Model(spec, compute_dtype=torch.bfloat16, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    tok = torch.full((B, 1), 7, dtype=torch.int32, device=dev)
    out, kern = [], {}
    for plain in (False, True):
        engine = _decoder_engine(model, params, store, slots, prefetch_budget=8, graphs=False)
        try:
            with _plain_kernels() if plain else contextlib.nullcontext():
                # run to its end: a suspended step generator keeps inference mode on
                steps = list(_decoder_steps(engine, model, params, experts, prompt, 1, MX_CAP,
                                            None if plain else kern, tok))
            out.append(steps[1][1])
        finally:
            engine.arena.shutdown()
    got, want = out
    _require_launched(kern, MLA_KERNELS, "DeepSeek bf16 offload step")
    rows = (got - want).abs().amax(dim=(1, 2)).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).all().item()
    say(f"[check] DeepSeek-V2-Lite offload first decode step bf16, kernels against plain: "
        f"per-request max_abs_err={['%.3e' % r for r in rows]} argmax equal={same} "
        f"(reported, as phase 4's)")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("DeepSeek bf16 offload logits are not finite")
    del model, params, experts
    torch.cuda.empty_cache()
    del store
    return {k: sum(c.get(k, 0) for c in counts.values()) for k in MLA_KERNELS}


# ---------------------------------------------------------------------------
# phases 19 and 20: the user-facing entry points
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json, cut to 2 layers (depth is the cut
# an entry-point path may take: the full checkpoint is 93 GB)
EP_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 2, "num_key_value_heads": 8,
    "num_local_experts": 8, "output_router_logits": False, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.36.0.dev0", "use_cache": True, "vocab_size": 32000,
}
EP_REQUESTS, EP_PROMPT, EP_NEW = 8, 16, 16
WHOLE_RUN_EP_NEW = 8  # phases 19 and 39's new tokens a request in the whole run, for its time limit
EP_SLOTS = 10  # of the 16 experts: evictions happen
EP_DISK_GB = 10.5  # checkpoint 6.3 + int8 store 2.8 + dense archive 0.7, with room
EP_DIR = Path(__file__).resolve().parent / ".entrypoints"
EP_IMPL = {"expert_dtype": "int8", "moe_impl": "pallas", "prefill_impl": "pallas"}


_SAFE_DTYPE = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
               torch.int32: "I32", torch.float8_e4m3fn: "F8_E4M3"}


def _write_safetensors(path, tensors):
    """The safetensors format: an 8-byte little-endian header length, the
    JSON header, then each tensor's bytes (bf16, f16, f32, int32 or
    float8_e4m3fn tensors)."""
    header, off = {}, 0
    for name, t in tensors:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFE_DTYPE[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, t in tensors:
            f.write(memoryview(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + off


def _write_mixtral_checkpoint(root, dev, seed=0):
    """EP_CONFIG's checkpoint under HF's tensor names, bf16, weights normal
    with std 0.02 made on the card from ``seed`` (norms one), one safetensors
    shard per layer plus one for the embeddings, head and final norm, and
    ``model.safetensors.index.json``. Returns its bytes."""
    c = EP_CONFIG
    D, F, E, V = c["hidden_size"], c["intermediate_size"], c["num_local_experts"], c["vocab_size"]
    hd = D // c["num_attention_heads"]
    kvd = c["num_key_value_heads"] * hd
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mat(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(c, indent=2))
    L = c["num_hidden_layers"]
    weight_map, total = {}, 0
    for shard in range(L + 1):
        fname = f"model-{shard + 1:05d}-of-{L + 1:05d}.safetensors"
        if shard < L:
            p = f"model.layers.{shard}."
            tensors = [(p + "input_layernorm.weight", ones(D)),
                       (p + "post_attention_layernorm.weight", ones(D)),
                       (p + "self_attn.q_proj.weight", mat(D, D)),
                       (p + "self_attn.k_proj.weight", mat(kvd, D)),
                       (p + "self_attn.v_proj.weight", mat(kvd, D)),
                       (p + "self_attn.o_proj.weight", mat(D, D)),
                       (p + "block_sparse_moe.gate.weight", mat(E, D))]
            for e in range(E):
                q = f"{p}block_sparse_moe.experts.{e}."
                tensors += [(q + "w1.weight", mat(F, D)), (q + "w2.weight", mat(D, F)),
                            (q + "w3.weight", mat(F, D))]
        else:
            tensors = [("model.embed_tokens.weight", mat(V, D)), ("model.norm.weight", ones(D)),
                       ("lm_head.weight", mat(V, D))]
        total += _write_safetensors(root / fname, tensors)
        weight_map.update({name: fname for name, _ in tensors})
        del tensors
    (root / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return total


def _ep_prompts():
    rng = np.random.default_rng(19)
    return [rng.integers(3, EP_CONFIG["vocab_size"], (1, EP_PROMPT)) for _ in range(EP_REQUESTS)]


def _ep_build(tag, ckpt, cfg, dev):
    from moe_infinity_tpu_torch.entrypoints.api import MoE

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = MoE(str(ckpt), cfg, device=dev)
    torch.cuda.synchronize()
    plan = ("offload" if m.engine is not None else "resident") + \
        (", batcher" if m.batcher is not None else ", Generator")
    say(f"[entry] {tag}: built in {time.perf_counter() - t0:.1f} s ({plan}); device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return m


def _ep_first_step_logits(st, prompt, dev):
    """Logits of the first decode step after a prefill of ``prompt``, through
    the resident stepper ``st``."""
    kv = st.init_cache(1, 32)
    T = prompt.shape[1]
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    logits, kv, _ = st.forward(tok, pos, kv, 0)
    nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    out, _, _ = st.forward(nxt, torch.full((1, 1), T, dtype=torch.int32, device=dev), kv, T)
    return out[:, -1]


def _ep_logits_check(ref, store, prompt, dev, tag="entry"):
    """The first decode step's logits through the kernels against the plain
    versions on the card. At f32 compute (the facade's model class, dense
    params from the same store, and the facade's quantized experts: the
    store's bytes, which f32 compute takes as they are) they are held to the
    tolerance of phases 4 and 6, with equal argmax; through the bf16 facade
    the argmax is held and the error reported, as phases 4 and 6 report
    bf16."""
    from moe_infinity_tpu_torch.runtime.generate import ResidentStepper
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.store.blob import DenseArchive

    m32 = type(ref.model)(ref.model.spec, torch.float32, device=dev)
    st32 = ResidentStepper(m32, m32.load_params(DenseArchive(str(store))),
                           ref.generator.stepper.experts, ResidentProvider.for_layer,
                           impl="pallas")
    for kind, st in (("f32", st32), ("bf16 facade", ref.generator.stepper)):
        with _plain_kernels():
            plain = _ep_first_step_logits(st, prompt, dev)
        kern = _ep_first_step_logits(st, prompt, dev)
        what = f"{tag}: first decode step's logits ({kind}), kernels against plain versions"
        if kind == "f32":
            compare(what, kern, plain)
        else:
            diff = (kern.float() - plain.float()).abs()
            used = (diff / (TOL + TOL * plain.float().abs())).max().item()
            say(f"[check] {what}: max_abs_err={diff.max().item():.3e} limit_used={used:.3f} "
                f"(reported, not held to a tolerance)")
            if not bool(torch.isfinite(kern).all()):
                raise AssertionError(f"{what}: logits are not finite")
        _ep_check(f"{what}: argmax equal", bool((kern.argmax(-1) == plain.argmax(-1)).all()))
    del st32, m32
    torch.cuda.empty_cache()


def phase_entrypoints(dev):
    """Phase 19: ``MoE`` from a checkpoint at Mixtral-8x7B's width. Returns
    the launches of the resident batch and of the offload facade's run, and
    leaves the offload facade and its checkpoint to phase 20 (which deletes
    the checkpoint)."""
    import concurrent.futures as cf
    import shutil

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    EP_DIR.mkdir(exist_ok=True)
    free = shutil.disk_usage(EP_DIR).free
    say(f"[entry] disk free under {EP_DIR.name}/: {free / 1e9:.1f} GB (needs {EP_DISK_GB})")
    if free < EP_DISK_GB * 1e9:
        raise RuntimeError(f"phase 19 needs {EP_DISK_GB} GB of disk under {EP_DIR}, "
                           f"{free / 1e9:.1f} GB is free")
    ckpt, store = EP_DIR / "ckpt", EP_DIR / "store"
    t0 = time.perf_counter()
    nbytes = _write_mixtral_checkpoint(ckpt, dev)
    say(f"[entry] checkpoint: Mixtral-8x7B geometry at {EP_CONFIG['num_hidden_layers']} "
        f"layers, {nbytes / 1e9:.2f} GB of bf16 safetensors in "
        f"{len(list(ckpt.glob('*.safetensors')))} shards, written in "
        f"{time.perf_counter() - t0:.1f} s")
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    t0 = time.perf_counter()
    ingest_checkpoint(str(ckpt), str(store), read_hf_config(str(ckpt)), expert_dtype="int8")
    say(f"[entry] ingest (int8): {time.perf_counter() - t0:.1f} s; experts.blob "
        f"{(store / 'experts.blob').stat().st_size / 1e9:.2f} GB, dense.blob "
        f"{(store / 'dense.blob').stat().st_size / 1e9:.2f} GB")
    prompts = _ep_prompts()
    kw = dict(max_new_tokens=EP_NEW, eos_token_id=None)
    base = dict(EP_IMPL, offload_path=str(store))

    # ---- the resident facade at its defaults: the continuous batcher ----
    torch.cuda.reset_peak_memory_stats()
    res = _ep_build("resident (max_batch_size 8)", ckpt, base, dev)
    if res.batcher is None or res.engine is not None:
        raise AssertionError("the default facade should be resident with a batcher")
    res.generate(prompts[0], max_new_tokens=2, eos_token_id=None)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(EP_REQUESTS) as ex:
        batch = list(ex.map(lambda q: res.generate(q, **kw), prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_res = launch_counts()
    say(f"[entry] resident batch: {EP_REQUESTS} requests x {EP_NEW} tokens in {wall:.3f} s: "
        f"{EP_REQUESTS * EP_NEW / wall:.1f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {json.dumps(counts_res)}")
    say(f"[entry] batcher tokens (bf16, printed, not compared): "
        f"{[b[0, EP_PROMPT:].tolist() for b in batch[:2]]} ...")
    _require_launched(counts_res, BATCHER_KERNELS, "resident facade (batcher)")
    sampled = dict(kw, temperature=0.8, top_p=0.9, top_k=50, seed=7)
    a, b = res.generate(prompts[0], **sampled), res.generate(prompts[0], **sampled)
    _ep_check("batcher: a sampled request twice gives the same tokens", np.array_equal(a, b))
    res.shutdown()
    del res
    torch.cuda.empty_cache()

    # ---- the reference: resident at max_batch_size 1, Generator --------
    ref = _ep_build("resident (max_batch_size 1)", ckpt, dict(base, max_batch_size=1), dev)
    want = [ref.generate(q, **kw) for q in prompts]
    _ep_logits_check(ref, store, prompts[0], dev)
    dense_bytes = _tree_bytes(ref.params)
    del ref
    torch.cuda.empty_cache()

    # ---- the offload facade: 10 of 16 experts, speculative blocks of 2 --
    from moe_infinity_tpu_torch.store.blob import ExpertStore

    stride = ExpertStore(str(store)).stride
    budget = dense_bytes + EP_SLOTS * stride + stride // 2
    torch.cuda.reset_peak_memory_stats()
    off = _ep_build("offload", ckpt, dict(
        base, dense_paging="off", device_memory_bytes=budget, speculative_decode=True,
        speculative_block=2, max_batch_size=1), dev)
    if off.engine is None or off.engine.arena.num_slots != EP_SLOTS:
        raise AssertionError(f"offload facade: expected {EP_SLOTS} slots")
    off.generate(prompts[0], max_new_tokens=4, eos_token_id=None)  # warm-up: captures
    torch.cuda.synchronize()
    reset_launches()
    s0 = off.stats()
    walls, got = [], []
    for q in prompts:
        t0 = time.perf_counter()
        got.append(off.generate(q, **kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts_off = launch_counts()
    st = off.stats()
    per_tok = [w / (EP_NEW + 1) for w in walls]
    say(f"[entry] offload: {EP_REQUESTS} requests one at a time, s/token (wall over new "
        f"tokens + 1) {['%.4f' % x for x in per_tok]} mean {np.mean(per_tok):.4f}; hit rate "
        f"{(st['hits'] - s0['hits']) / max(1, st['visits'] - s0['visits']):.4f} (all "
        f"{st['hit_rate']:.4f}); evictions {st['evictions'] - s0['evictions']}; executions "
        f"per block {st.get('mean_step_executions', 0):.2f}; graphs "
        f"{json.dumps(off.engine.graph_stats())}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {json.dumps(counts_off)}")
    _require_launched(counts_off, MIXTRAL_KERNELS, "offload facade")
    if st["evictions"] - s0["evictions"] <= 0:
        raise AssertionError("offload facade: no eviction in the run")
    for i, (g_, w_) in enumerate(zip(got, want)):
        _ep_check(f"entry: request {i} offload tokens equal resident Generator's",
                  np.array_equal(g_, w_))
    a = off.generate(prompts[1], **sampled)
    _ep_check("offload: a sampled request (t 0.8, top-p 0.9, top-k 50, seed 7) twice gives "
              "the same tokens", np.array_equal(a, off.generate(prompts[1], **sampled)))
    _ep_check("offload: temperature 0 gives the greedy tokens",
              np.array_equal(off.generate(prompts[1], temperature=0.0, **kw), want[1]))
    forced = off.generate(prompts[2], logit_bias={777: 100.0}, **kw)
    _ep_check("offload: logit_bias +100 on id 777 makes every new token 777",
              bool((forced[0, EP_PROMPT:] == 777).all()))
    return {k: counts_res.get(k, 0) + counts_off.get(k, 0)
            for k in set(counts_res) | set(counts_off)}, off, want


def _ep_check(what, ok):
    say(f"[check] {what}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(what)


class WordTokenizer:
    """A stand-in word-level tokenizer for the server: id i <-> ``tok{i}``;
    any other word maps to an id by its CRC. Its EOS id is the vocabulary's
    size, which the model never produces."""

    chat_template = None

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.eos_token_id = vocab

    def _id(self, w):
        import zlib

        if w.startswith("tok") and w[3:].isdigit() and int(w[3:]) < self.vocab:
            return int(w[3:])
        return zlib.crc32(w.encode()) % self.vocab

    def __call__(self, text, return_tensors="np"):
        return SimpleNamespace(input_ids=np.array([[self._id(w) for w in text.split()]]))

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"tok{int(i)}" for i in ids
                        if not (skip_special_tokens and int(i) == self.eos_token_id))


def phase_server(dev, off, want):
    """Phase 20: the OpenAI-compatible server over phase 19's offload facade."""
    import shutil
    import threading
    import urllib.request

    from moe_infinity_tpu_torch.entrypoints.openai.server import build_server

    tok = WordTokenizer(EP_CONFIG["vocab_size"])
    srv = build_server(off, tok, "mixtral-8x7b-2l", "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(path, payload=None, raw=False):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url + path, data, {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body, code = r.read(), r.status
        say(f"[server] {path} {json.dumps(payload)[:80] if payload else ''} -> HTTP {code} "
            f"in {time.perf_counter() - t0:.3f} s")
        _ep_check(f"server: {path} answers HTTP 200", code == 200)
        return body.decode() if raw else json.loads(body)

    try:
        _ep_check("server: /health", call("/health") == {"status": "ok"})
        _ep_check("server: /v1/models", call("/v1/models")["data"][0]["id"] == "mixtral-8x7b-2l")
        n = 8
        for i in (3, 4):
            prompt = " ".join(f"tok{t}" for t in _ep_prompts()[i][0])
            text = call("/v1/completions", {"prompt": prompt, "max_tokens": n,
                                            "temperature": 0.0})["choices"][0]["text"]
            ids = tok(prompt).input_ids
            gen = off.generate(ids, max_new_tokens=n, eos_token_id=tok.eos_token_id)
            _ep_check(f"server: greedy completion {i} equals the decode of MoE.generate",
                      text == tok.decode(gen[0, ids.shape[1]:]))
            same = text == tok.decode(want[i][0, EP_PROMPT:EP_PROMPT + n])
            say(f"[server] completion {i} against the resident Generator's first {n} tokens: "
                f"{'equal' if same else 'differ'} (printed, not held)")
        prompt = " ".join(f"tok{t}" for t in _ep_prompts()[5][0])
        r = call("/v1/completions", {"prompt": prompt, "max_tokens": n, "seed": 1})
        _ep_check("server: sampled completion at the OpenAI defaults",
                  len(r["choices"][0]["text"].split()) == n)
        r = call("/v1/completions", {"prompt": prompt, "max_tokens": n, "n": 2, "logprobs": 3,
                                     "seed": 2})
        _ep_check("server: n=2 with logprobs=3",
                  len(r["choices"]) == 2 and all(
                      len(c["logprobs"]["tokens"]) == n and
                      all(len(t) <= 3 for t in c["logprobs"]["top_logprobs"])
                      for c in r["choices"]))
        chat = {"messages": [{"role": "user", "content": prompt}], "max_tokens": n,
                "temperature": 0.0}
        text = call("/v1/chat/completions", chat)["choices"][0]["message"]["content"]
        body = call("/v1/chat/completions", dict(chat, stream=True), raw=True)
        deltas = [json.loads(line[6:])["choices"][0]["delta"].get("content", "")
                  for line in body.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        _ep_check("server: streamed chat deltas join to the chat text",
                  "".join(deltas) == text and len(text.split()) == n)
        m = call("/metrics")
        say(f"[server] tokens_generated {m['tokens_generated']} over {m['requests']} "
            f"requests; expert cache {json.dumps(m['expert_cache'])}")
    finally:
        srv.shutdown()
        srv.server_close()
        off.shutdown()
        shutil.rmtree(EP_DIR, ignore_errors=True)
        say(f"[entry] deleted {EP_DIR.name}/")


def phase_entrypoints_and_server(dev):
    """Phases 19 and 20 (the server runs over phase 19's offload facade)."""
    t0 = time.perf_counter()
    try:
        counts, off, want = phase_entrypoints(dev)
    except BaseException:
        import shutil

        shutil.rmtree(EP_DIR, ignore_errors=True)
        raise
    say(f"[phase] phase_entrypoints: {time.perf_counter() - t0:.1f} s")
    phase_server(dev, off, want)
    del off
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phases 21 to 23: Grok-1 and Snowflake Arctic (fp8 experts through K3's e4m3 kind)
# ---------------------------------------------------------------------------

# hpcai-tech/grok-1's config.json, as GrokSpec.from_hf reads it
GROK_1 = dict(
    vocab_size=131072, hidden_size=6144, intermediate_size=32768, num_layers=64,
    num_heads=48, num_kv_heads=8, head_dim=128, num_experts=8, top_k=2, rms_eps=1e-5,
    attn_output_multiplier=0.08838834764831845, max_attn_value=30.0,
    embedding_multiplier_scale=78.38367176906169, output_multiplier_scale=0.5773502691896257,
)
# Snowflake/snowflake-arctic-instruct's config.json, as ArcticSpec.from_hf reads it
ARCTIC = dict(
    vocab_size=32000, hidden_size=7168, intermediate_size=4864, num_layers=35,
    num_heads=56, num_kv_heads=8, head_dim=128, num_experts=128, top_k=2,
    moe_layer_frequency=1, parallel_attn_mlp_res=True, rms_eps=1e-5, rope_theta=10000.0,
)
GA_PROMPT, GA_TOKENS, GA_CAP = 16, 16, 64  # the offload runs: prompt, new tokens, capacity
GROK_OFF_LAYERS, GROK_OFF_SLOTS = 8, 40  # phase 21b: 64 records of 604 MB, 40 slots
ARCTIC_OFF_LAYERS, ARCTIC_OFF_SLOTS = 4, 160  # phase 22b: 512 int8 records, 160 slots
GA_PARITY_STEPS = 12  # the f32 whole-path checks' greedy steps after the prefill
GROK_KERNELS = ("flash_decode", "flash_attend", "gmm_fp8")
GROK_TAILS = (("linear", "gate"), ("linear_v", "up"), ("linear_1", "down"))
# phase 2's e4m3 layers: (label, D, F, tokens at top-2)
GMM_FP8_CASES = (("Grok-1 batch-1 decode", 6144, 32768, 1),
                 ("Grok-1 W=8 batcher step", 6144, 32768, 8),
                 ("Arctic batch-1 decode", 7168, 4864, 1))
ARCTIC_TAILS = (("w1", "gate"), ("w3", "up"), ("w2", "down"))


def _grok(dev, dtype, seed, expert_dtype="fp8", **overrides):
    from moe_infinity_tpu_torch.models.grok import GrokModel, GrokSpec

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = GrokModel(GrokSpec(**dict(GROK_1, **overrides)), compute_dtype=dtype, device=dev)
    params, tree = model.init_random(g, expert_dtype=expert_dtype,
                                     with_experts=expert_dtype is not None)
    return model, params, tree, g


def _arctic(dev, dtype, seed, expert_dtype="fp8", **overrides):
    from moe_infinity_tpu_torch.models.arctic import ArcticModel, ArcticSpec

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = ArcticModel(ArcticSpec(**dict(ARCTIC, **overrides)), compute_dtype=dtype,
                        device=dev)
    params, tree = model.init_random(g, expert_dtype=expert_dtype,
                                     with_experts=expert_dtype is not None)
    return model, params, tree, g


def _gated_fields(D, F, tails, dtype):
    """The record fields of a gated expert: gate and up [D, F], down [F, D],
    each with its f32 per-channel scale."""
    fields = []
    for (tail, role) in tails:
        shape = (F, D) if role == "down" else (D, F)
        fields += [(tail + ".weight", shape, dtype), (tail + ".weight.scale", shape[1:], "float32")]
    return fields


class _CardStore:
    """The expert-store protocol over an expert tree made on the card (one
    dict of [E, ...] tensors per MoE layer, ``random_expert_layer``'s), each
    record copied to the host once: the arena's slots then hold the resident
    tree's bytes, and distinct records cost no host-side draws."""

    def __init__(self, layers, tails, meta):
        from moe_infinity_tpu_torch.store.blob import build_record_layout

        w0 = layers[0]
        dt = {torch.float8_e4m3fn: "float8_e4m3fn", torch.int8: "int8"}[w0["gate"].dtype]
        D, F = w0["gate"].shape[1:]
        self.fields, self.stride = build_record_layout(_gated_fields(D, F, tails, dt))
        self._field_by_name = {f.name: f for f in self.fields}
        self.field_names = [f.name for f in self.fields]
        self.meta = dict(meta)
        self.num_layers, self.num_experts = len(layers), w0["gate"].shape[0]

        def host(t):
            t = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
            return t.cpu().numpy()

        self._records = []
        for w in layers:
            per = {}
            for tail, role in tails:
                per[tail + ".weight"] = host(w[role])
                per[tail + ".weight.scale"] = host(w[role + "_scale"])
            self._records.append(per)

    def get_expert(self, layer, expert, *, prio=0, gen=0):
        return {n: a[expert] for n, a in self._records[layer].items()}


# ---- phase 2: K3's e4m3 kind, K1, K2 and K4 at rep 6 and 7 -------------------

def _fp8_layer(g, dev, S, D, F):
    from moe_infinity_tpu_torch.models.layers import random_expert_layer

    t = random_expert_layer(S, D, F, "fp8", g, dev)
    return {r: t[r] for r in ROLES}, {r: t[r + "_scale"] for r in ROLES}


def check_gmm_fp8(dev):
    """K3's e4m3 kind (float8_e4m3fn codes, per-channel f32 scales after the
    dot) at the MoE layers of phases 21 and 22, gate + up + GELU + down,
    each role held to its plain version: Grok-1's batch-1 decode layer (2
    rows over 2 of its 8 experts, D=6144 F=32768: 1.21 GB of routed
    weights), a W=8 batcher step (16 rows over the 8 experts) and Arctic's
    batch-1 layer (2 rows over 2 experts, D=7168 F=4864, 209 MB; 8 of the
    layer's 128 expert rows are made, as the kernel reads only the routed
    ones). Draws from its own generator. Returns ``gmm_fp8``'s record, timed
    at Grok-1's batch-1 layer."""
    from moe_infinity_tpu_torch.ops.gmm import compact_groups

    g = torch.Generator(device=dev)
    g.manual_seed(14)
    recs = {}
    for label, D, F, tokens in GMM_FP8_CASES:
        S = 8
        w, sc = _fp8_layer(g, dev, S, D, F)
        flat = torch.stack([torch.randperm(S, generator=g, device=dev)[:2]
                            for _ in range(tokens)]).reshape(-1)
        gid, gsz = compact_groups(torch.sort(flat).values, min(S, flat.numel()))
        active = int(torch.unique(flat).numel())
        x = torch.randn(2 * tokens, D, generator=g, device=dev).to(torch.bfloat16)
        r = _check_layer(f"fp8 {label} rows={2 * tokens} active={active}", x, w, sc, gsz,
                         active, act="gelu", group_ids=gid)
        r.pop("a")
        recs[label] = r
        say(f"[time] gmm_fp8 {label} MoE layer (gate + up + down, {2 * tokens} rows over "
            f"{active} experts, e4m3 + scales, D={D} F={F}): ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) library_ms="
            f"None (no single PyTorch call takes bf16 x e4m3 with per-channel scales: "
            f"torch._scaled_mm rounds x to fp8); {_layer_plans(x, w, gsz)}")
        del w, sc
        torch.cuda.empty_cache()
    dec = recs[GMM_FP8_CASES[0][0]]
    dec["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    return dict(
        name="gmm_fp8", route="cuda", source="moe_infinity_tpu_torch/csrc/gmm.cu",
        replaces="moe_infinity_tpu/ops/gmm.py:46", library_ms=None,
        shape="Grok-1 batch-1 decode MoE layer: gate + up + down, 2 rows over 2 experts, "
              "e4m3 + scales, D=6144 F=32768", **dec,
    )


def check_attention_rep67(dev):
    """K1, K2 (the decode body and both tiled kernels) and K4 at Grok-1's
    GQA (48 query heads over 8: rep 6, scores times 0.0884 and softcapped
    at 30) and Arctic's (56 over 8: rep 7), head dim 128, bf16 and f32:
    rows of 113, 200, 37 and 512 keys with holes, contiguous (K1) and paged
    (K4, page 16); K2 at T=1 with a pad bias (6 or 7 rows a kv head: the
    decode body), T=2 (12 or 14 rows: a block's 4 units straddle query
    chunks) and T=16. bf16 times beside SDPA for rep 7 (SDPA takes no
    softcap: rep 6 has no yardstick). Draws from its own generator. Returns
    the largest error of each kernel."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev)
    g.manual_seed(67)
    errs = {"flash_decode": 0.0, "flash_attend": 0.0, "paged_flash_decode": 0.0}
    B, Hkv, Dh, P, NP = 4, 8, 128, MAX_COLS // PAGE, 160
    S = P * PAGE
    lengths = torch.tensor([113, 200, 37, 512], dtype=torch.int32, device=dev)
    for rep, softcap, scale, who in ((6, 30.0, GROK_1["attn_output_multiplier"], "Grok-1"),
                                     (7, None, None, "Arctic")):
        H = Hkv * rep
        sc = scale or Dh ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            dn = "bf16" if dtype == torch.bfloat16 else "f32"
            tol = TOL if dtype == torch.bfloat16 else 2e-3
            q = (torch.randn(B, H, Dh, generator=g, device=dev) * 3).to(dtype)
            pk = (torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev) * 3).to(dtype)
            pv = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(dtype)
            table = torch.randperm(NP, generator=g, device=dev)[:B * P].reshape(B, P).to(
                torch.int32)
            holes = torch.rand(B, S, generator=g, device=dev) > 0.1
            kw = dict(scale=sc, logit_softcap=softcap, pad_mask=holes)
            paged = lambda: fa.paged_flash_decode(q, pk, pv, table, lengths, **kw)  # noqa: E731
            paged_plain = lambda: fa.paged_flash_decode_plain(  # noqa: E731
                q, pk, pv, table, lengths, **kw)
            errs["paged_flash_decode"] = max(errs["paged_flash_decode"], compare(
                f"paged_flash_decode {who} rep {rep} {dn}", paged(), paged_plain(), tol))
            idx = table.long()
            k, v = pk[idx].reshape(B, S, Hkv, Dh), pv[idx].reshape(B, S, Hkv, Dh)
            qpos = (lengths - 1)[:, None]
            dec = lambda: fa.flash_decode(q[:, None], k, v, qpos, S, **kw)  # noqa: E731
            dec_plain = lambda: fa.flash_decode_plain(q, k, v, lengths - 1, S, **kw)  # noqa
            errs["flash_decode"] = max(errs["flash_decode"], compare(
                f"flash_decode {who} rep {rep} {dn}", dec()[:, 0], dec_plain(), tol))
            att = {}
            for T in (1, 2, 16):
                qq = (torch.randn(B, T, H, Dh, generator=g, device=dev) * 3).to(dtype)
                pos = ((lengths - T).clamp(min=0)[:, None]
                       + torch.arange(T, dtype=torch.int32, device=dev)[None])
                bias = torch.zeros(B, 1, 1, S, device=dev) if T == 1 else None
                kw2 = dict(kw, bias=bias)
                run = lambda qq=qq, pos=pos, kw2=kw2: fa.flash_attend(  # noqa: E731
                    qq, k, v, pos, S, **kw2)
                plain = lambda qq=qq, pos=pos, kw2=kw2: fa.flash_attend_plain(  # noqa: E731
                    qq, k, v, pos, S, **kw2)
                errs["flash_attend"] = max(errs["flash_attend"], compare(
                    f"flash_attend {who} rep {rep} T={T} ({T * rep} rows a kv head) {dn}",
                    run(), plain(), tol))
                att[T] = (run, plain, qq, pos)
            if dtype != torch.bfloat16:
                continue
            live = torch.arange(S, device=dev)[None, :] < lengths[:, None]
            valid = int((live & holes).sum())
            nbytes = 2 * valid * Hkv * Dh * 2 + int(lengths.sum()) + 2 * B * H * Dh * 2
            lib = "None (SDPA takes no softcap)"
            if softcap is None:
                fmask = torch.where(live & holes, 0.0, float("-inf")).to(dtype)[:, None, None]
                kx = k.repeat_interleave(rep, dim=2).transpose(1, 2)
                vx = v.repeat_interleave(rep, dim=2).transpose(1, 2)
                sd = lambda: F_.scaled_dot_product_attention(  # noqa: E731
                    q[:, :, None], kx, vx, attn_mask=fmask)
                lib = f"{cuda_ms(sd):.5f} (SDPA on a gathered view, KV heads expanded)"
            for name, fn, pfn in (("paged_flash_decode", paged, paged_plain),
                                  ("flash_decode", dec, dec_plain)):
                b_ms, b_by = bound_ms(nbytes + (B * P * 4 if name.startswith("paged") else 0),
                                      4 * H * Dh * valid)
                say(f"[time] {name} {who} rep {rep} (B={B} H={H} Hkv={Hkv}, rows "
                    f"{lengths.tolist()} with holes, {valid} valid keys, bf16): ms="
                    f"{cuda_ms(fn):.5f} plain_ms={cuda_ms(pfn, iters=5, warmup=1):.4f} "
                    f"bound_ms={b_ms:.5f} ({b_by}) library_ms={lib}")
            for T in (2, 16):
                run, plain, qq, pos = att[T]
                key = torch.arange(S, device=dev)
                ok = holes[:, None, :] & (key[None, None, :] <= pos[:, :, None])
                read = int(ok.any(1).sum())
                nb = 2 * B * T * H * Dh * 2 + 2 * read * Hkv * Dh * 2 + B * S + B * T * 4
                b_ms, b_by = bound_ms(nb, 4 * H * Dh * int(ok.sum()))
                lib2 = "None (SDPA takes no softcap)"
                if softcap is None:
                    kx = k.repeat_interleave(rep, dim=2).transpose(1, 2)
                    vx = v.repeat_interleave(rep, dim=2).transpose(1, 2)
                    fm = torch.where(ok, 0.0, float("-inf")).to(dtype)[:, None]
                    qt = qq.transpose(1, 2)
                    sd = lambda qt=qt, fm=fm: F_.scaled_dot_product_attention(  # noqa: E731
                        qt, kx, vx, attn_mask=fm)
                    lib2 = f"{cuda_ms(sd):.5f} (SDPA, KV heads expanded beforehand)"
                say(f"[time] flash_attend {who} rep {rep} T={T} ({T * rep} rows a kv head, "
                    f"{read} keys read, bf16): ms={cuda_ms(run):.5f} plain_ms="
                    f"{cuda_ms(plain, iters=5, warmup=1):.4f} bound_ms={b_ms:.5f} ({b_by}) "
                    f"library_ms={lib2}")
    return errs


# ---- phase 21: Grok-1 --------------------------------------------------------

def _first_step_check(what, model, params, experts, prompt):
    """The first decode step's logits after a prefill of ``prompt`` through
    the kernels against the plain versions, at the model's compute type:
    held to the tolerance with equal argmax at f32."""
    from moe_infinity_tpu_torch.runtime.generate import ResidentStepper
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    st = ResidentStepper(model, params, experts, ResidentProvider.for_layer, impl="pallas")
    dev = model.device
    with torch.inference_mode():
        with _plain_kernels():
            plain = _ep_first_step_logits(st, prompt, dev)
        kern = _ep_first_step_logits(st, prompt, dev)
    compare(what, kern, plain)
    if not bool((kern.argmax(-1) == plain.argmax(-1)).all()):
        raise AssertionError(f"{what}: argmax differs")
    say(f"[check] {what}: argmax equal: ok")


def _resident_decoder_runs(tag, model, params, tree, g, gen_tokens=32):
    """``Generator`` at batch 1 (a prompt of 16, ``gen_tokens`` new tokens,
    eager), then 8 requests of 16 tokens through a ``ContinuousBatcher`` of
    8 slots; returns the launches of both."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    prompt = torch.randint(1, model.spec.vocab_size, (1, GA_PROMPT), generator=g,
                           device=model.device).cpu().numpy()
    gen = Generator(model, params, tree, ResidentProvider.for_layer, impl="pallas",
                    max_seq_len=MAX_COLS)
    gen.generate(prompt, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = gen.generate(prompt, max_new_tokens=gen_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_counts = launch_counts()
    new = res.sequences[0, GA_PROMPT:]
    say(f"[{tag}] Generator batch 1, prompt {GA_PROMPT}, {gen_tokens} new tokens (eager): "
        f"wall_s={wall:.3f} s_per_token={wall / (gen_tokens + 1):.4f} tokens_per_s="
        f"{gen_tokens / wall:.2f}; launches {json.dumps(gen_counts)}; tokens {new.tolist()}")
    if new.shape != (gen_tokens,) or not np.all((new >= 0) & (new < model.spec.vocab_size)):
        raise AssertionError(f"{tag}: Generator output {res.sequences.shape} or ids out of range")
    batcher, _, _, counts, _ = _serve_batcher(tag, model, params, tree, g, slots=8)
    return gen_counts, counts


def _ga_offload_build(label, model, params, store, kernels, k3, moe_layers):
    prompt = (np.arange(GA_PROMPT, dtype=np.int64)[None] * 37) % (model.spec.vocab_size - 1)
    return SimpleNamespace(spec=model.spec, model=model, params=params, store=store,
                           prompt=prompt, label=label, tokens=GA_TOKENS, cap=GA_CAP,
                           kernels=kernels, k3=k3, moe_layers=moe_layers)


def _ga_whole_path(label, model, params, experts, store, slots, kernels, prompt):
    """The per-layer path and the speculative step (graphs, then eager)
    through an arena of ``slots`` slots, each step's logits bit-equal to
    the resident path's; graph logits bit-equal to eager."""
    logits = {}
    for leg, kw in (("per-layer", dict(speculative=False)),
                    ("speculative step, graphs", dict(speculative=True)),
                    ("speculative step, eager", dict(speculative=True, graphs=False))):
        engine = _decoder_engine(model, params, store, slots, prefetch_budget=4, **kw)
        counts = {}
        try:
            logits[leg] = _held_steps(f"{label} f32 {leg}", engine, model, params, experts,
                                      prompt, GA_PARITY_STEPS, counts, cap=GA_CAP)
            ev = int(engine.arena.policy.node_stats["evictions"].sum())
        finally:
            engine.arena.shutdown()
        _require_launched(counts, kernels, f"{label} whole path ({leg})")
        say(f"[check] {label} {leg} vs resident f32 ({slots} slots for "
            f"{store.num_layers * store.num_experts} records): {GA_PARITY_STEPS + 1} steps' "
            f"logits bit-equal; evictions {ev}, executions {engine.replay_counts}, graphs "
            f"{json.dumps(engine.graph_stats())}, engine launches {json.dumps(counts)}")
        if kw["speculative"] and not engine.speculative:
            raise AssertionError(f"{label} {leg}: left the speculative path")
    for i, (a, b) in enumerate(zip(logits["speculative step, graphs"],
                                   logits["speculative step, eager"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: graph and eager logits differ at step {i}")
    say(f"[check] {label} f32 speculative step, graph against eager logits over "
        f"{GA_PARITY_STEPS + 1} steps: all bit-equal")


def phase_grok(dev):
    """Phase 21: Grok-1 at its published widths (hpcai-tech/grok-1), bf16
    dense weights and fp8 experts made on the card from a seed. (a) 2
    layers resident (9.7 GB of experts): ``Generator`` at batch 1 and 8
    requests through the batcher (K4 and K2 at rep 6 with the softcap, K3's
    e4m3 kind at W=8), then the first decode step's logits at f32 compute,
    kernels against plain versions. (b) 8 layers offloaded: 64 fp8 records
    of 604 MB from a ``SyntheticStore``'s shared record, 40 slots,
    speculative blocks of 2, eagerly and as graphs. (c) f32 compute at 2
    layers, 10 slots for 16 distinct records: per layer and speculative
    (graphs and eager), each step's logits bit-equal to the resident
    path's. Returns the launches of (a) and (b)."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    t0 = time.perf_counter()
    model, params, tree, g = _grok(dev, torch.bfloat16, 2101, num_layers=2)
    torch.cuda.synchronize()
    say(f"[grok] Grok-1 widths at 2 layers: built on the card in {time.perf_counter() - t0:.1f} "
        f"s; dense {_tree_bytes(params) / 1e9:.2f} GB bf16, experts {_tree_bytes(tree) / 1e9:.2f} "
        f"GB fp8 + scales")
    gen_counts, counts = _resident_decoder_runs("grok", model, params, tree, g)
    _require_launched(gen_counts, GROK_KERNELS, "Grok-1 Generator path")
    _require_launched(counts, ("paged_flash_decode", "flash_attend", "gmm_fp8"),
                      "Grok-1 batcher path")
    prompt = torch.randint(1, GROK_1["vocab_size"], (1, GA_PROMPT), generator=g,
                           device=dev).cpu().numpy()
    del params
    torch.cuda.empty_cache()
    m32, p32, _, _ = _grok(dev, torch.float32, 2101, expert_dtype=None, num_layers=2)
    _first_step_check("grok: first decode step's logits (f32 compute, fp8 experts), kernels "
                      "against plain versions", m32, p32, tree, prompt)
    del m32, p32, tree, model
    torch.cuda.empty_cache()

    # (b) offload at 8 layers
    model, params, _, _ = _grok(dev, torch.bfloat16, 2102, expert_dtype=None,
                                num_layers=GROK_OFF_LAYERS)
    D, F, E = GROK_1["hidden_size"], GROK_1["intermediate_size"], GROK_1["num_experts"]
    t0 = time.perf_counter()
    store = SyntheticStore(GROK_OFF_LAYERS, E, _gated_fields(D, F, GROK_TAILS, "float8_e4m3fn"),
                           meta={"arch": "grok", "gated": True, "num_encoder_moe_layers": 0})
    say(f"[grok-offload] Grok-1 widths at {GROK_OFF_LAYERS} layers: {GROK_OFF_LAYERS * E} fp8 "
        f"records of {store.stride / 1e6:.2f} MB (one shared, made in "
        f"{time.perf_counter() - t0:.1f} s), dense {_tree_bytes(params) / 1e9:.2f} GB bf16; "
        f"{GROK_OFF_SLOTS} slots; prompt {GA_PROMPT}, {GA_TOKENS} tokens, capacity {GA_CAP}")
    b = _ga_offload_build("grok-offload", model, params, store, GROK_KERNELS, "gmm_fp8", None)
    off = {}
    runs = {}
    for graphs in (False, True):
        tag = "graphs" if graphs else "eager"
        runs[tag], off[tag], kept = _mixtral_offload_run(tag, b, GROK_OFF_SLOTS, graphs)
        if not kept:
            raise AssertionError(f"Grok-1 offload ({tag}): the speculative path turned off")
    if not np.array_equal(runs["graphs"], runs["eager"]):
        raise AssertionError("Grok-1 offload: graph and eager tokens differ")
    say("[grok-offload] graphs against eager greedy tokens: equal")
    del b, model, params, store
    torch.cuda.empty_cache()

    # (c) f32 whole path, 2 layers, 16 distinct records, 10 slots
    model, params, tree, g = _grok(dev, torch.float32, 2103, num_layers=2)
    t0 = time.perf_counter()
    store = _CardStore(tree["layers"], GROK_TAILS, {"arch": "grok", "num_encoder_moe_layers": 0})
    say(f"[grok] f32 whole path: 16 distinct fp8 records copied to the host in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(21).integers(0, GROK_1["vocab_size"], (1, GA_PROMPT))
    _ga_whole_path("Grok-1 (2 layers, fp8 experts)", model, params, tree, store, 10,
                   GROK_KERNELS, prompt)
    del model, params, tree, store
    torch.cuda.empty_cache()
    return _sum_counts(gen_counts, counts, *off.values())


def _sum_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


# ---- phase 22: Snowflake Arctic ------------------------------------------------

def phase_arctic(dev, extra=None):
    """Phase 22: Snowflake Arctic at its published widths
    (Snowflake/snowflake-arctic-instruct), bf16 dense weights from a seed on
    the card. (a) 2 layers resident with fp8 experts (26.8 GB): the batcher
    (8 requests of 16 tokens, 8 slots: K4 at rep 7) and ``Generator``. (b)
    4 layers offloaded from an int8 ``SyntheticStore`` (512 records of
    104.6 MB, one shared), 160 slots: the per-layer path, then speculative
    blocks of 2 as graphs. (c) f32 compute over 128 distinct int8 records
    of one MoE layer, per layer and speculative (graphs, eager), each step
    bit-equal to the resident path; again with ``moe_layer_frequency`` 2
    (a dense layer, then the MoE layer: ``dense_layer`` on the card).
    Returns the launches of (a) and (b)."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    t0 = time.perf_counter()
    model, params, tree, g = _arctic(dev, torch.bfloat16, 2201, num_layers=2)
    torch.cuda.synchronize()
    say(f"[arctic] Arctic widths at 2 layers: built on the card in "
        f"{time.perf_counter() - t0:.1f} s; dense {_tree_bytes(params) / 1e9:.2f} GB bf16, "
        f"experts {_tree_bytes(tree) / 1e9:.2f} GB fp8 + scales")
    gen_counts, counts = _resident_decoder_runs("arctic", model, params, tree, g)
    _require_launched(gen_counts, GROK_KERNELS, "Arctic Generator path")
    _require_launched(counts, ("paged_flash_decode", "flash_attend", "gmm_fp8"),
                      "Arctic batcher path")
    del model, params, tree
    torch.cuda.empty_cache()

    # (b) offload with an int8 store at 4 layers
    model, params, _, _ = _arctic(dev, torch.bfloat16, 2202, expert_dtype=None,
                                  num_layers=ARCTIC_OFF_LAYERS)
    D, F, E = ARCTIC["hidden_size"], ARCTIC["intermediate_size"], ARCTIC["num_experts"]
    store = SyntheticStore(ARCTIC_OFF_LAYERS, E, _gated_fields(D, F, ARCTIC_TAILS, "int8"),
                           meta={"arch": "arctic", "gated": True, "num_encoder_moe_layers": 0})
    say(f"[arctic-offload] Arctic widths at {ARCTIC_OFF_LAYERS} layers: "
        f"{ARCTIC_OFF_LAYERS * E} int8 records of {store.stride / 1e6:.2f} MB (one shared), "
        f"dense {_tree_bytes(params) / 1e9:.2f} GB bf16; {ARCTIC_OFF_SLOTS} slots; prompt "
        f"{GA_PROMPT}, {GA_TOKENS} tokens, capacity {GA_CAP}")
    b = _ga_offload_build("arctic-offload", model, params, store, MIXTRAL_KERNELS, "gmm", None)
    off = {}
    _, off["per-layer"], _ = _mixtral_offload_run("per-layer, eager", b, ARCTIC_OFF_SLOTS,
                                                  False, speculative=False)
    _, off["graphs"], kept = _mixtral_offload_run("speculative, graphs", b, ARCTIC_OFF_SLOTS,
                                                  True)
    if not kept:
        raise AssertionError("Arctic offload: the speculative path turned off")
    if extra is not None:
        extra["phase_arctic_batcher"] = _subphase(phase_arctic_batcher, dev,
                                                  (model, params, store))
    del b, model, params, store
    torch.cuda.empty_cache()

    # (c) f32 whole path over 128 distinct int8 records of one MoE layer
    for freq, layers in ((1, 1), (2, 2)):
        t0 = time.perf_counter()
        model, params, tree, store = _arctic_f32_build(dev, freq, layers)
        say(f"[arctic] f32 whole path, moe_layer_frequency {freq} ({layers} layers, "
            f"{'a dense layer, then ' if freq == 2 else ''}1 MoE layer): {store.num_experts} "
            f"distinct int8 records of {store.stride / 1e6:.2f} MB built and copied to the host in "
            f"{time.perf_counter() - t0:.1f} s")
        prompt = np.random.default_rng(22).integers(0, ARCTIC["vocab_size"], (1, GA_PROMPT))
        _ga_whole_path(f"Arctic (moe_layer_frequency {freq}, int8 experts)", model, params,
                       tree, store, E + 8, MIXTRAL_KERNELS, prompt)
        if freq == 1 and extra is not None:  # phase 28's f32 check on this build
            extra["phase_arctic_batcher"] = _sum_counts(
                extra["phase_arctic_batcher"],
                _subphase(arctic_batcher_whole_path, model, params, tree, store))
        del model, params, tree, store
        torch.cuda.empty_cache()
    return _sum_counts(gen_counts, counts, *off.values())


# ---- phase 23: Grok-1 through MoE from a checkpoint ------------------------------

GK_DIR = Path(__file__).resolve().parent / ".grok_entry"
GK_DISK_GB = 21  # checkpoint 11.5 + fp8 store 4.9 + dense archive 1.8, with room
GK_CONFIG = {  # hpcai-tech/grok-1's config.json, cut to 1 layer
    "architectures": ["Grok1ModelForCausalLM"], "model_type": "grok-1",
    "vocab_size": 131072, "hidden_size": 6144, "intermediate_size": 32768,
    "num_hidden_layers": 1, "num_attention_heads": 48, "num_key_value_heads": 8,
    "num_experts": 8, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
    "attn_output_multiplier": 0.08838834764831845, "max_attn_value": 30.0,
    "embedding_multiplier_scale": 78.38367176906169,
    "output_multiplier_scale": 0.5773502691896257, "max_position_embeddings": 8192,
    "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16",
}
GK_REQUESTS, GK_NEW = 4, 8


def _write_grok_checkpoint(root, dev, seed=0):
    """GK_CONFIG's checkpoint under Grok-1's tensor names, bf16, normal with
    std 0.02 made on the card from ``seed`` (norm scales one), one
    safetensors shard per expert and one for the rest, with an index.
    Returns its bytes."""
    c = GK_CONFIG
    D, F, E, V = c["hidden_size"], c["intermediate_size"], c["num_experts"], c["vocab_size"]
    hd = D // c["num_attention_heads"]
    kvd = c["num_key_value_heads"] * hd
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mat(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(c, indent=2))
    p = "model.layers.0."
    shards = [[("model.embed_tokens.weight", lambda: mat(V, D)), ("model.norm.scale", lambda: ones(D))]
              + [(p + n + ".scale", lambda: ones(D)) for n in
                 ("pre_attn_norm", "post_attn_norm", "pre_moe_norm", "post_moe_norm")]
              + [(p + "attn.q_proj.weight", lambda: mat(D, D)),
                 (p + "attn.k_proj.weight", lambda: mat(kvd, D)),
                 (p + "attn.v_proj.weight", lambda: mat(kvd, D)),
                 (p + "attn.o_proj.weight", lambda: mat(D, D)),
                 (p + "moe_block.gate.weight", lambda: mat(E, D))]]
    for e in range(E):
        q = f"{p}moe_block.experts.{e}."
        shards.append([(q + "linear.weight", lambda: mat(F, D)),
                       (q + "linear_v.weight", lambda: mat(F, D)),
                       (q + "linear_1.weight", lambda: mat(D, F))])
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = [(name, make()) for name, make in shard]
        total += _write_safetensors(root / fname, tensors)
        weight_map.update({name: fname for name, _ in tensors})
        del tensors
    (root / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return total


def phase_grok_entry(dev):
    """Phase 23: ``MoE`` from a 1-layer checkpoint of Grok-1's published
    config (bf16 sharded safetensors written from a seed under
    ``.grok_entry/`` in the checkout, git-ignored; the free disk checked
    first, the directory deleted at the end, also on failure), ingested to
    float8_e4m3fn experts: the resident facade (``Generator``) and the
    offload facade at a budget of 5 of the 8 experts (its arena takes the 8
    slots of one MoE layer, the least the engine takes, so every fetch is a
    first touch; speculative blocks of 2, graphs), 4 requests of 16
    tokens, 8 new each; the offload tokens equal the resident ones. Returns
    the offload facade's launches."""
    import shutil

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    GK_DIR.mkdir(exist_ok=True)
    try:
        free = shutil.disk_usage(GK_DIR).free
        say(f"[grok-entry] disk free under {GK_DIR.name}/: {free / 1e9:.1f} GB (needs "
            f"{GK_DISK_GB})")
        if free < GK_DISK_GB * 1e9:
            raise RuntimeError(f"phase 23 needs {GK_DISK_GB} GB of disk under {GK_DIR}, "
                               f"{free / 1e9:.1f} GB is free")
        ckpt, store = GK_DIR / "ckpt", GK_DIR / "store"
        t0 = time.perf_counter()
        nbytes = _write_grok_checkpoint(ckpt, dev)
        say(f"[grok-entry] checkpoint: Grok-1's config at 1 layer, {nbytes / 1e9:.2f} GB of "
            f"bf16 safetensors in {len(list(ckpt.glob('*.safetensors')))} shards, written in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ingest_checkpoint(str(ckpt), str(store), read_hf_config(str(ckpt)),
                          expert_dtype="float8_e4m3fn")
        say(f"[grok-entry] ingest (float8_e4m3fn): {time.perf_counter() - t0:.1f} s; "
            f"experts.blob {(store / 'experts.blob').stat().st_size / 1e9:.2f} GB, dense.blob "
            f"{(store / 'dense.blob').stat().st_size / 1e9:.2f} GB")
        rng = np.random.default_rng(23)
        prompts = [rng.integers(3, GK_CONFIG["vocab_size"], (1, GA_PROMPT))
                   for _ in range(GK_REQUESTS)]
        kw = dict(max_new_tokens=GK_NEW, eos_token_id=None)
        base = {"expert_dtype": "float8_e4m3fn", "moe_impl": "pallas", "prefill_impl": "pallas",
                "offload_path": str(store), "max_batch_size": 1}
        res = _ep_build("grok resident", ckpt, base, dev)
        want = [res.generate(p, **kw) for p in prompts]
        say(f"[grok-entry] resident tokens (request 1): {want[0][0, GA_PROMPT:].tolist()}")
        dense_bytes = _tree_bytes(res.params)
        res.shutdown()
        del res
        torch.cuda.empty_cache()
        from moe_infinity_tpu_torch.store.blob import ExpertStore

        # a budget of 5 of the 8 experts: the plan offloads, and its arena takes
        # the 8 slots of one MoE layer, the least the engine takes
        E = GK_CONFIG["num_experts"]
        stride = ExpertStore(str(store)).stride
        off = _ep_build("grok offload", ckpt, dict(
            base, dense_paging="off", device_memory_bytes=dense_bytes + 5 * stride + stride // 2,
            speculative_decode=True, speculative_block=2), dev)
        try:
            if off.engine is None or off.engine.arena.num_slots != E:
                raise AssertionError(f"grok offload facade: expected an arena of {E} slots")
            off.generate(prompts[0], **kw)  # warm-up: the graphs' captures
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            got = [off.generate(p, **kw) for p in prompts]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            st = off.stats()
            say(f"[grok-entry] offload (a budget of 5 of 8 experts: {E} slots, speculative "
                f"blocks of 2, graphs; fetches {json.dumps(off.engine.arena.fetch_stats())}): "
                f"{GK_REQUESTS} requests, s_per_token={wall / (GK_REQUESTS * (GK_NEW + 1)):.4f}; "
                f"hit rate {off.hit_rate():.4f}; evictions {st.get('evictions')}; graphs "
                f"{json.dumps(off.engine.graph_stats())}; launches {json.dumps(counts)}")
            for i, (a, b) in enumerate(zip(got, want)):
                _ep_check(f"grok-entry: request {i} offload tokens equal the resident "
                          f"Generator's", np.array_equal(a, b))
            _require_launched(counts, GROK_KERNELS, "Grok-1 offload facade")
        finally:
            off.shutdown()
        del off
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(GK_DIR, ignore_errors=True)
        say(f"[grok-entry] deleted {GK_DIR.name}/")



# ---------------------------------------------------------------------------
# phases 24-30: the batchers
# ---------------------------------------------------------------------------

S2S_SLOTS = 8  # the facade's default max_batch_size
S2S_REQUESTS, S2S_NEW = 12, (8, 12, 16)  # requests, and their max_new_tokens in turn
S2S_CAP = 32  # the continuous batcher's decode cache: 16 new tokens and the start token
SWB_NEW, SWB_CAP = 32, 64  # phase 27: new tokens, decode capacity (_bucket_len(33))
ARB_SLOTS, ARB_PROMPTS = 4, (16, 9, 12, 16, 10, 14, 16, 11)  # phase 28: 8 requests, 4 slots
# phase 29's requests in the whole run (still more than its slots), for its
# time limit; --batchers runs all 8
WHOLE_RUN_ARB_REQUESTS = 5
ARB_TOKENS = 16  # phase 28's new tokens a request (GA_TOKENS)
WHOLE_RUN_ARB_TOKENS = 8  # and in the whole run, for its time limit
MXS_SPAN, MXS_NEW = 12, 32  # phase 29: the repeated span, new tokens
SB8_CONFIG = {  # google/switch-base-8's config.json
    "architectures": ["SwitchTransformersForConditionalGeneration"], "d_ff": 3072,
    "d_kv": 64, "d_model": 768, "decoder_sparse_step": 2, "decoder_start_token_id": 0,
    "dense_act_fn": "relu", "dropout_rate": 0.1, "encoder_sparse_step": 2,
    "eos_token_id": 1, "expert_capacity": 64, "initializer_factor": 1.0,
    "is_encoder_decoder": True, "is_gated_act": False, "layer_norm_epsilon": 1e-06,
    "model_type": "switch_transformers", "num_decoder_layers": 12, "num_experts": 8,
    "num_heads": 12, "num_layers": 12, "num_sparse_decoder_layers": 6,
    "num_sparse_encoder_layers": 6, "pad_token_id": 0,
    "relative_attention_max_distance": 128, "relative_attention_num_buckets": 32,
    "router_aux_loss_coef": 0.001, "router_bias": False, "router_dtype": "float32",
    "router_ignore_padding_tokens": False, "router_jitter_noise": 0.01,
    "router_type": "tokens_masked", "router_z_loss_coef": 0.001, "torch_dtype": "float32",
    "transformers_version": "4.26.0.dev0", "use_cache": True, "vocab_size": 32128,
}
SB_DIR = Path(__file__).resolve().parent / ".switch_entry"
SB_DISK_GB = 8  # checkpoint 1.2 + f32 store 2.1 + bf16 store 1.1 + dense archives, with room
SB_REQUESTS, SB_PROMPT, SB_NEW = 8, 16, 12
# The f32 token checks of batches against isolated runs: K3 rounds its
# activations to bf16 (the JAX kernel's contract), so where the batch
# differs the f32 sums' order moves a rounding and the logits part by ~1e-3;
# these checks take the exact grouped FFN, the attention through K1 and K2.
# It reads the group sizes on the host, so they run eagerly (graphs=False)
F32_IMPL = "ragged"


def _subphase(fn, *args):
    """Run a phase on an earlier phase's build; print its seconds. Garbage
    (reference cycles that hold device memory) is collected before and
    after."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _submit_together(batcher, requests):
    """Queue every request on a new queue that replaces the batcher's in one
    assignment, so that its next admission sees them all, whatever its
    thread was doing: the joins, and so each step's batch, are the same in
    every run. ``requests``: (input_ids, submit's keywords). Returns the
    futures."""
    import queue

    stage = SimpleNamespace(**vars(batcher))
    stage._queue = queue.Queue()
    futures = [type(batcher).submit(stage, ids, **kw) for ids, kw in requests]
    batcher._queue = stage._queue
    return futures


def _s2s_requests(vocab, seed, n=S2S_REQUESTS):
    """n sources of SRC_LENS' lengths in turn, each closed by eos 2, with
    max_new_tokens 8, 12, 16 in turn."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = rng.integers(3, vocab, SRC_LENS[i % len(SRC_LENS)])
        ids[-1] = 2
        out.append((ids, S2S_NEW[i % len(S2S_NEW)]))
    return out


def _serve_s2s(tag, batcher, reqs, start, vocab):
    """reqs submitted together, greedy, no EOS: (outputs, wall s, tokens)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = _submit_together(batcher, [(ids, dict(max_new_tokens=n, eos_token_id=None))
                                         for ids, n in reqs])
    outs = [f.result(timeout=900) for f in futures]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for (_, n), o in zip(reqs, outs):
        if o.shape != (n + 1,) or o[0] != start or not np.all((o >= 0) & (o < vocab)):
            raise AssertionError(f"[{tag}] a request of {n} tokens came back as {o.tolist()}")
    return outs, wall, sum(n for _, n in reqs)


def _first_step_recorder(batcher):
    """Wrap the batcher's step so that the logits of its first accepted
    step are kept (in offload mode the last execution of that step)."""
    rec = {"calls": [], "first": None}
    step, once = batcher._step, batcher._step_once

    def record(*a):
        out = step(*a)
        rec["calls"].append(out[0].clone())
        return out

    def one(start):
        once(start)
        if rec["first"] is None:
            rec["first"] = rec["calls"][-1]

    batcher._step, batcher._step_once = record, one
    return rec


def _same_tokens(what, got, want):
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if not np.array_equal(a, b)]
    say(f"[check] {what}: {len(got) - len(bad)} of {len(got)} requests' greedy tokens equal"
        + (f"; first differing request {bad[0]}: {got[bad[0]].tolist()} against "
           f"{want[bad[0]].tolist()}" if bad else ""))
    if bad:
        raise AssertionError(f"{what}: tokens differ for requests {bad}")


def _nllb_resident(dev):
    """Phase 3's build: NLLB-MoE-54B at full width and depth, bf16, packed
    int4 experts made on the card from seed 1234."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    model = NllbModel(NllbSpec(**NLLB_54B), compute_dtype=torch.bfloat16, device=dev)
    params, tree = model.init_random(g, expert_dtype="int4")
    return model, params, ResidentProvider(tree), g


def phase_s2s_batchers(dev, built=None):
    """Phase 24: phase 3's resident NLLB-MoE-54B through
    ``Seq2SeqContinuousBatcher(max_batch_size=8)``: 12 requests (sources of
    SRC_LENS' lengths in turn, 8, 12 and 16 new tokens in turn) submitted
    together, so that 4 join mid-flight as slots free; eagerly, then with
    the shared step as one CUDA graph (a warm-up run, whose first step
    captures, then the timed run); then the same 12 through the wave
    batcher. Returns the launches of the timed graph run and the wave run."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.batching import Seq2SeqDynamicBatcher
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    model, params, provider = (built or _nllb_resident(dev))[:3]
    spec, start = model.spec, model.spec.decoder_start_token_id
    reqs = _s2s_requests(spec.vocab_size, 24)
    kw = dict(impl="pallas", max_batch_size=S2S_SLOTS, max_src_len=max(SRC_LENS),
              max_decode_len=S2S_CAP)
    say(f"[s2s] NLLB-MoE-54B (phase 3's build) through Seq2SeqContinuousBatcher("
        f"{json.dumps(kw)}): {len(reqs)} requests, sources {[len(i) for i, _ in reqs]}, "
        f"max_new_tokens {[n for _, n in reqs]}, submitted together")
    runs, counts = {}, {}
    for graphs in (False, True):
        tag = "graphs" if graphs else "eager"
        torch.cuda.reset_peak_memory_stats()
        b = Seq2SeqContinuousBatcher(model, params, provider.pytree(), ResidentProvider.for_layer,
                                     graphs=graphs, **kw)
        try:
            warm_steps = 0
            if graphs:  # the warm-up run: its first step captures
                warm, _, _ = _serve_s2s(f"s2s {tag} warm-up", b, reqs, start, spec.vocab_size)
                warm_steps = b.steps
                b.steps, b.joins, b.step_seconds = 0, 0, 0.0
            reset_launches()
            outs, wall, n_tok = _serve_s2s(f"s2s {tag}", b, reqs, start, spec.vocab_size)
            counts = launch_counts()
            st, gst = b.step_stats(), b.graph_stats()
        finally:
            b.shutdown()
        say(f"[s2s] {tag}: {n_tok} tokens in {wall:.3f} s: tokens_per_s={n_tok / wall:.1f} "
            f"steps={st['steps']} joins={st['joins']} host_ms_per_step={st['ms_per_step']:.3f} "
            f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} graphs "
            f"{json.dumps(gst)}; launches {json.dumps(counts)}")
        say(f"[s2s] {tag}: request 1 {outs[0].tolist()}")
        _require_launched(counts, NLLB_KERNELS, f"NLLB continuous batcher ({tag})")
        if st["joins"] != len(reqs):
            raise AssertionError(f"continuous batcher: {st['joins']} joins for {len(reqs)}")
        if graphs:
            _same_tokens("s2s graphs: warm-up run against timed run", outs, warm)
            if (gst["captures"], gst["recaptures"]) != (1, 0) or \
                    gst["replays"] != warm_steps + st["steps"]:
                raise AssertionError(f"continuous batcher: one capture and a replay per step "
                                     f"expected ({gst}, steps {warm_steps} + {st['steps']})")
        runs[tag] = outs
    _same_tokens("s2s continuous batcher: graphs against eager (bf16, one batch)",
                 runs["graphs"], runs["eager"])

    w = Seq2SeqDynamicBatcher(model, params, provider.pytree(), ResidentProvider.for_layer,
                              impl="pallas", max_batch_size=S2S_SLOTS, max_wait_s=0.05,
                              max_seq_len=max(SRC_LENS))
    try:
        reset_launches()
        wouts, wall, n_tok = _serve_s2s("s2s wave", w, reqs, start, spec.vocab_size)
        wcounts = launch_counts()
    finally:
        w.shutdown()
    agree = sum(np.array_equal(a, c) for a, c in zip(wouts, runs["graphs"]))
    say(f"[s2s] wave: {n_tok} tokens in {wall:.3f} s: tokens_per_s={n_tok / wall:.1f}; "
        f"{agree} of {len(reqs)} requests' tokens equal the continuous batcher's (bf16, other "
        f"batches: reported, not held); launches {json.dumps(wcounts)}")
    _require_launched(wcounts, NLLB_KERNELS, "NLLB wave batcher")
    return _sum_counts(counts, wcounts)


def phase_s2s_batcher_offload(dev, built=None):
    """Phase 25: phase 11's build (the 388-slot int4 arena over the 14 GiB
    tier, the speculative engine with graphs) serving phase 24's 12 requests
    through the continuous batcher in offload mode: each join encodes
    through the engine's per-layer path, each shared step is one
    speculative execution over the arena, a replay of one graph. Returns
    the launches."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

    own = built is None
    if own:
        b = _offload_build(dev)
        engine = _offload_engine(b.model, b.params, b.store, b.slots, b.tier, speculative=True,
                                 spec_block=4)
    else:
        b, engine = built
    arena = engine.arena
    try:
        reqs = _s2s_requests(b.spec.vocab_size, 25)
        start = b.spec.decoder_start_token_id
        batcher = Seq2SeqContinuousBatcher(b.model, b.params, None, None, engine=engine,
                                           impl="pallas", max_batch_size=S2S_SLOTS,
                                           max_src_len=max(SRC_LENS), max_decode_len=S2S_CAP)
        s0, f0, g0 = arena.hit_stats(), arena.fetch_stats(), engine.graph_stats()
        try:
            reset_launches()
            outs, wall, n_tok = _serve_s2s("s2s offload", batcher, reqs, start,
                                           b.spec.vocab_size)
            counts = launch_counts()
            st, execs = batcher.step_stats(), list(batcher.replay_counts)
        finally:
            batcher.shutdown()
        s1, f1, g1 = arena.hit_stats(), arena.fetch_stats(), engine.graph_stats()
        visits = s1["visits"] - s0["visits"]
        say(f"[s2s-offload] {len(reqs)} requests through {arena.num_slots} slots: {n_tok} tokens "
            f"in {wall:.3f} s: tokens_per_s={n_tok / wall:.2f} steps={st['steps']} joins="
            f"{st['joins']} host_ms_per_step={st['ms_per_step']:.3f}; hit rate "
            f"{(s1['hits'] - s0['hits']) / max(1, visits):.4f} over {visits} visits, misses "
            f"{s1['misses'] - s0['misses']}, evictions {s1['evictions'] - s0['evictions']}, "
            f"fetches tier {f1['fetches_tier'] - f0['fetches_tier']} store "
            f"{f1['fetches_store'] - f0['fetches_store']}; executions per step "
            f"{sum(execs) / max(1, len(execs)):.3f} ({execs}); graphs {json.dumps(g1)}; "
            f"launches {json.dumps(counts)}")
        say(f"[s2s-offload] request 1 {outs[0].tolist()}")
        _require_launched(counts, NLLB_KERNELS, "NLLB continuous batcher, offload mode")
        if (g1["captures"] - g0["captures"], g1["recaptures"] - g0["recaptures"],
                g1["replays"] - g0["replays"]) != (1, 0, sum(execs)):
            raise AssertionError(f"offload batcher: one capture and every execution a replay "
                                 f"expected ({g0} -> {g1}, executions {sum(execs)})")
    finally:
        if own:
            arena.shutdown()
    return counts


def phase_s2s_batchers_whole_path(dev, blocks=PARITY_BLOCKS):
    """Phase 26: f32, full width, 4+4 blocks over phase 10's store (seed 11,
    128 records a layer): 8 requests into 4 slots (4 join mid-flight)
    through the continuous batcher resident (graphs), in offload mode over
    a 128-slot arena (the speculative engine's graphs) and the wave
    batcher; each request's greedy tokens equal to an isolated
    ``Seq2SeqGenerator``'s, and the first step's logits of the resident and
    offload batchers within the tolerance of the isolated ones. The experts
    run the exact grouped FFN (``F32_IMPL``), eagerly."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.runtime.batching import Seq2SeqDynamicBatcher
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=blocks, decoder_layers=blocks,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    E, start = spec.num_experts, spec.decoder_start_token_id
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    model = NllbModel(spec, compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _offload_store(spec, seed=11, cache_records=4 * E)
    provider = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    experts = provider.pytree()
    reqs = _s2s_requests(spec.vocab_size, 26, n=8)
    gen = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer, impl=F32_IMPL,
                           graphs=False)
    want = [gen.generate(ids[None], max_new_tokens=n, eos_token_id=None).sequences[0]
            for ids, n in reqs]
    first = [_first_step_logits(model, params, provider, ids[None],
                                np.ones((1, len(ids)), np.float32), F32_IMPL)[0, -1]
             for ids, _ in reqs[:4]]
    kw = dict(impl=F32_IMPL, max_batch_size=4, max_src_len=max(SRC_LENS), max_decode_len=S2S_CAP,
              graphs=False)
    engine = _offload_engine(model, params, store, E, None, impl=F32_IMPL, speculative=True,
                             graphs=False)
    try:
        for leg in ("resident", "offload"):
            if leg == "resident":
                b = Seq2SeqContinuousBatcher(model, params, experts, ResidentProvider.for_layer,
                                             **kw)
            else:
                b = Seq2SeqContinuousBatcher(model, params, None, None, engine=engine, **kw)
            rec = _first_step_recorder(b)
            try:
                outs, _, _ = _serve_s2s(f"s2s f32 {leg}", b, reqs, start, spec.vocab_size)
                gst, execs = b.graph_stats(), list(b.replay_counts)
            finally:
                b.shutdown()
            for i, w in enumerate(first):
                compare(f"s2s batcher f32 {leg}: request {i}'s first-step logits against the "
                        f"isolated generator's", rec["first"][i, -1], w)
            _same_tokens(f"s2s batcher f32 {leg} (8 requests, 4 slots) against the isolated "
                         f"generator", outs, want)
            say(f"[check] s2s batcher f32 {leg}: graphs {json.dumps(gst)}"
                + (f"; executions {execs}; arena {json.dumps(engine.stats())}"
                   if leg == "offload" else ""))
    finally:
        engine.arena.shutdown()
    w = Seq2SeqDynamicBatcher(model, params, experts, ResidentProvider.for_layer, impl=F32_IMPL,
                              max_batch_size=4, max_wait_s=0.05, max_seq_len=max(SRC_LENS))
    try:
        outs, _, _ = _serve_s2s("s2s f32 wave", w, reqs, start, spec.vocab_size)
    finally:
        w.shutdown()
    _same_tokens("s2s wave batcher f32 (waves of 4) against the isolated generator", outs, want)
    del model, params, store, provider, experts, gen, engine
    torch.cuda.empty_cache()


def _switch_resident(dev):
    """Phase 13's build: Switch-large-128 at full width and depth, bf16,
    packed int4 experts made on the card from seed 2024."""
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    model = SwitchModel(SwitchSpec(**SWITCH_LARGE_128), compute_dtype=torch.bfloat16, device=dev)
    params, tree = model.init_random(g, expert_dtype="int4")
    return model, params, ResidentProvider(tree)


def phase_switch_batcher(dev, built=None):
    """Phase 27: phase 13's Switch-large-128 through the continuous batcher:
    bench.py's 32 prompts of 16 into 8 slots, 32 new tokens each, the step a
    graph (a warm-up run, then the timed one); K2 at head dim 64 takes the
    per-row T5 bias. Then at f32 and 4+4 blocks: 8 of the prompts into 4
    slots, 12 tokens, each equal to an isolated ``Seq2SeqGenerator``'s.
    Returns the launches of the timed run."""
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    model, params, provider = built or _switch_resident(dev)
    spec, start = model.spec, model.spec.decoder_start_token_id
    ids, _ = _switch_requests(spec.vocab_size)
    reqs = [(row, SWB_NEW) for row in ids]
    b = Seq2SeqContinuousBatcher(model, params, provider.pytree(), ResidentProvider.for_layer,
                                 impl="pallas", max_batch_size=S2S_SLOTS, max_src_len=SW_PROMPT,
                                 max_decode_len=SWB_CAP)
    try:
        warm, _, _ = _serve_s2s("switch batcher warm-up", b, reqs, start, spec.vocab_size)
        warm_steps = b.steps
        b.steps, b.joins, b.step_seconds = 0, 0, 0.0
        reset_launches()
        outs, wall, n_tok = _serve_s2s("switch batcher", b, reqs, start, spec.vocab_size)
        counts = launch_counts()
        st, gst = b.step_stats(), b.graph_stats()
    finally:
        b.shutdown()
    tps = n_tok / wall
    say(f"[switch-batcher] {len(reqs)} prompts of {SW_PROMPT} into {S2S_SLOTS} slots, {SWB_NEW} "
        f"tokens each: {n_tok} tokens in {wall:.3f} s: tokens_per_s={tps:.1f} (vs_baseline "
        f"{tps / SW_BASELINE_TOKENS_PER_S:.3f}) steps={st['steps']} joins={st['joins']} "
        f"host_ms_per_step={st['ms_per_step']:.3f} graphs {json.dumps(gst)}; launches "
        f"{json.dumps(counts)}")
    _require_launched(counts, SWITCH_KERNELS, "Switch continuous batcher")
    _same_tokens("switch batcher graphs: warm-up run against timed run", outs, warm)
    if (gst["captures"], gst["recaptures"]) != (1, 0) or gst["replays"] != warm_steps + st["steps"]:
        raise AssertionError(f"Switch batcher: one capture and a replay per step expected ({gst})")

    # f32, 4+4 blocks: each request against the isolated generator
    g = torch.Generator(device=dev)
    g.manual_seed(2027)
    m32 = SwitchModel(SwitchSpec(**dict(SWITCH_LARGE_128, num_encoder_layers=4,
                                        num_decoder_layers=4)),
                      compute_dtype=torch.float32, device=dev)
    p32, t32 = m32.init_random(g, expert_dtype="int4")
    experts = ResidentProvider(t32).pytree()
    few = [(row, 12) for row in ids[:8]]
    gen = Seq2SeqGenerator(m32, p32, experts, ResidentProvider.for_layer, impl=F32_IMPL,
                           graphs=False)
    want = [gen.generate(row[None], max_new_tokens=n, eos_token_id=None).sequences[0]
            for row, n in few]
    b = Seq2SeqContinuousBatcher(m32, p32, experts, ResidentProvider.for_layer, impl=F32_IMPL,
                                 max_batch_size=4, max_src_len=SW_PROMPT, max_decode_len=SWB_CAP,
                                 graphs=False)
    try:
        got, _, _ = _serve_s2s("switch batcher f32", b, few, start, spec.vocab_size)
    finally:
        b.shutdown()
    _same_tokens("Switch batcher f32, 4+4 blocks (8 requests, 4 slots) against the isolated "
                 "generator", got, want)
    del m32, p32, t32, experts, gen
    torch.cuda.empty_cache()
    return counts


def _arena_batcher(model, params, store, slots, chunk, dtype):
    """ContinuousBatcher in offload mode over a new arena of ``slots`` slots:
    the priority policy, 4 workers, the EAMC tracer and predictor, K3."""
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher

    arena = ExpertArena(store, slots, policy="priority", compute_dtype=dtype, device=model.device,
                        num_threads=4)
    tracer = ExpertTracer(256, store.num_layers, store.num_experts)
    return ContinuousBatcher(model, params, None, None, impl="pallas", arena=arena, tracer=tracer,
                             predictor=ExpertPredictor(tracer), max_batch_size=ARB_SLOTS,
                             page_size=PAGE, num_pages=(GA_CAP * 2 // PAGE) * (ARB_SLOTS + 1),
                             max_cols=GA_CAP * 2, prefill_chunk=chunk)


def _arctic_offload_build(dev):
    """Phase 22b's build: Arctic's widths at 4 layers, bf16 dense weights
    from seed 2202, the int8 SyntheticStore (one shared record)."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    model, params, _, _ = _arctic(dev, torch.bfloat16, 2202, expert_dtype=None,
                                  num_layers=ARCTIC_OFF_LAYERS)
    D, F, E = ARCTIC["hidden_size"], ARCTIC["intermediate_size"], ARCTIC["num_experts"]
    store = SyntheticStore(ARCTIC_OFF_LAYERS, E, _gated_fields(D, F, ARCTIC_TAILS, "int8"),
                           meta={"arch": "arctic", "gated": True, "num_encoder_moe_layers": 0})
    return model, params, store


def _arctic_prompts(vocab):
    rng = np.random.default_rng(28)
    return [rng.integers(1, vocab, n) for n in ARB_PROMPTS]


def phase_arctic_batcher(dev, built=None):
    """Phase 28: phase 22b's Arctic build (4 layers, the int8 store) served by
    ``ContinuousBatcher(arena=...)`` over 160 slots: 8 requests into 4
    slots, prefill_chunk 1 (a step's union stays within 4 x 4 x 2 = 32
    experts), ``ARB_TOKENS`` tokens each, each step a speculative execution over the
    arena. Returns the launches."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    model, params, store = built or _arctic_offload_build(dev)
    prompts = _arctic_prompts(model.spec.vocab_size)
    b = _arena_batcher(model, params, store, ARCTIC_OFF_SLOTS, 1, torch.bfloat16)
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futures = _submit_together(b, [(p, dict(max_new_tokens=ARB_TOKENS)) for p in prompts])
        outs = [f.result(timeout=900) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        s, execs, steps = b.stats(), list(b.replay_counts), b.step_stats()
    finally:
        b.shutdown()
        b.arena.shutdown()
    n_tok = len(prompts) * ARB_TOKENS
    say(f"[arctic-batcher] {len(prompts)} requests (prompts {list(ARB_PROMPTS)}) into "
        f"{ARB_SLOTS} slots over {ARCTIC_OFF_SLOTS} of {store.num_layers * store.num_experts} "
        f"experts, {ARB_TOKENS} tokens each: {n_tok} tokens in {wall:.3f} s: tokens_per_s="
        f"{n_tok / wall:.2f}; hit rate {s['hit_rate']:.4f} ({s['visits']} visits, "
        f"{s['misses']} misses, {s['evictions']} evictions); executions per step "
        f"{s['mean_step_executions']:.3f} over {s['speculative_steps']} steps; steps "
        f"{json.dumps(steps)}; launches {json.dumps(counts)}")
    for p, out in zip(prompts, outs):
        if out.shape != (len(p) + ARB_TOKENS,) or not np.array_equal(out[:len(p)], p):
            raise AssertionError(f"Arctic batcher: a request of {len(p)} came back as {out.shape}")
    _require_launched(counts, ("paged_flash_decode", "gmm"), "Arctic batcher in offload mode")
    if max(execs) <= 1:
        raise AssertionError("Arctic batcher: no step ran again after its misses")
    if built is None:  # alone: phase 22c's f32 build for the whole-path check
        del model, params, store
        torch.cuda.empty_cache()
        counts = _sum_counts(counts, arctic_batcher_whole_path(*_arctic_f32_build(dev, 1, 1)))
    return counts


def _arctic_f32_build(dev, freq, layers):
    """Phase 22c's build: f32 compute, ``layers`` layers with a MoE layer
    every ``freq``, int8 experts from seed 2203, and their records copied
    to the host (``_CardStore``)."""
    model, params, tree, _ = _arctic(dev, torch.float32, 2203, expert_dtype="int8",
                                     num_layers=layers, moe_layer_frequency=freq)
    store = _CardStore(tree["layers"], ARCTIC_TAILS, {"arch": "arctic", "num_encoder_moe_layers": 0})
    return model, params, tree, store


def arctic_batcher_whole_path(model, params, tree, store):
    """Phase 28's f32 check, on phase 22c's build (one MoE layer of 128
    distinct int8 records): the arena batcher over E + 8 slots at
    prefill_chunk 4 (K2 for the chunk steps) against the resident batcher
    on the same requests, token for token. Returns the arena batcher's
    launches."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    prompts = _arctic_prompts(model.spec.vocab_size)
    reqs = [(p, dict(max_new_tokens=8)) for p in prompts]
    res = ContinuousBatcher(model, params, tree, ResidentProvider.for_layer, impl="pallas",
                            max_batch_size=ARB_SLOTS, page_size=PAGE,
                            num_pages=(GA_CAP * 2 // PAGE) * (ARB_SLOTS + 1), max_cols=GA_CAP * 2,
                            prefill_chunk=4)
    try:
        want = [f.result(timeout=900) for f in _submit_together(res, reqs)]
    finally:
        res.shutdown()
    b = _arena_batcher(model, params, store, store.num_experts + 8, 4, torch.float32)
    try:
        reset_launches()
        got = [f.result(timeout=900) for f in _submit_together(b, reqs)]
        counts = launch_counts()
        s = b.stats()
    finally:
        b.shutdown()
        b.arena.shutdown()
    _same_tokens(f"Arctic arena batcher f32 (prefill_chunk 4, {store.num_experts + 8} slots, "
                 f"{s['evictions']} evictions, executions per step "
                 f"{s['mean_step_executions']:.3f}) against the resident batcher", got, want)
    _require_launched(counts, ("paged_flash_decode", "flash_attend", "gmm"),
                      "Arctic arena batcher, f32")
    return counts


def phase_mixtral_speculative(dev, built=None):
    """Phase 29: phase 5's Mixtral-8x7B (full depth, int8) through
    ``SpeculativeDecoder(k=4)`` on a prompt that repeats a span 4 times, 32
    tokens, beside ``Generator`` on the same prompt; and through
    ``DynamicBatcher`` on 4 left-padded requests (PROMPT_LENS' first four),
    16 tokens. bf16 tokens are reported; at f32 and 2 layers both are held
    to ``Generator``'s. Returns the launches of the two bf16 runs."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.batching import DynamicBatcher
    from moe_infinity_tpu_torch.runtime.generate import Generator, ResidentStepper
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.runtime.speculative import SpeculativeDecoder

    def drive(model, params, experts, seed, counts=None, impl="pallas"):
        vocab = model.spec.vocab_size
        rng = np.random.default_rng(seed)
        prompt = np.tile(rng.integers(1, vocab, MXS_SPAN), 4)[None]
        stepper = ResidentStepper(model, params, experts, ResidentProvider.for_layer, impl=impl)
        gen = Generator(stepper=stepper, max_seq_len=MAX_COLS)
        dec = SpeculativeDecoder(stepper, spec_tokens=4, max_seq_len=MAX_COLS)
        dec.generate(prompt, max_new_tokens=4)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        r = dec.generate(prompt, max_new_tokens=MXS_NEW)
        torch.cuda.synchronize()
        t_spec = time.perf_counter() - t0
        c_spec = launch_counts()
        t0 = time.perf_counter()
        ref = gen.generate(prompt, max_new_tokens=MXS_NEW).sequences
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        prompts = [rng.integers(1, vocab, n) for n in PROMPT_LENS[:4]]
        wants = [gen.generate(p[None], max_new_tokens=NEW_TOKENS).sequences[0] for p in prompts]
        w = DynamicBatcher(model, params, experts, ResidentProvider.for_layer, impl=impl,
                           max_batch_size=4, max_wait_s=0.05, max_seq_len=MAX_COLS)
        try:
            reset_launches()
            t0 = time.perf_counter()
            outs = [f.result(timeout=900) for f in _submit_together(
                w, [(p, dict(max_new_tokens=NEW_TOKENS)) for p in prompts])]
            torch.cuda.synchronize()
            t_wave = time.perf_counter() - t0
            c_wave = launch_counts()
        finally:
            w.shutdown()
        if counts is not None:
            counts.update(_sum_counts(c_spec, c_wave))
        return r, ref, t_spec, t_gen, outs, wants, t_wave, c_spec, c_wave

    model, params, experts = built if built is not None else _mixtral(dev, torch.bfloat16,
                                                                      4321)[:3]
    if not isinstance(experts, dict):
        experts = experts.pytree()
    counts = {}
    r, ref, t_spec, t_gen, outs, wants, t_wave, c_spec, c_wave = drive(model, params, experts, 29,
                                                                      counts)
    st = r.stats
    say(f"[mixtral-spec] SpeculativeDecoder(k=4), a span of {MXS_SPAN} repeated 4 times, "
        f"{MXS_NEW} tokens: {st['spec_steps']} verification steps, {st['spec_accepted']} drafts "
        f"accepted (acceptance rate {st['spec_accept_rate']:.3f}), {MXS_NEW / t_spec:.2f} "
        f"tokens/s against Generator's {MXS_NEW / t_gen:.2f}; tokens equal to Generator's: "
        f"{np.array_equal(r.sequences, ref)} (bf16: reported, not held); launches "
        f"{json.dumps(c_spec)}")
    say(f"[mixtral-spec] DynamicBatcher, 4 left-padded requests (prompts "
        f"{list(PROMPT_LENS[:4])}), {NEW_TOKENS} tokens: {4 * NEW_TOKENS / t_wave:.2f} tokens/s; "
        f"{sum(np.array_equal(a, b) for a, b in zip(outs, wants))} of 4 equal to Generator's "
        f"(bf16: reported); launches {json.dumps(c_wave)}")
    _require_launched(c_spec, ("flash_attend", "gmm"), "Mixtral prompt-lookup speculation")
    _require_launched(c_wave, NLLB_KERNELS, "Mixtral DynamicBatcher")

    m32, p32, prov32, _ = _mixtral(dev, torch.float32, 4329, num_layers=2)
    r, ref, *_, outs, wants, _, _, _ = drive(m32, p32, prov32.pytree(), 30, impl=F32_IMPL)
    _same_tokens("Mixtral f32, 2 layers: SpeculativeDecoder(k=4) against Generator",
                 [r.sequences[0]], [ref[0]])
    _same_tokens("Mixtral f32, 2 layers: DynamicBatcher (left padding) against Generator",
                 outs, wants)
    del m32, p32, prov32
    torch.cuda.empty_cache()
    return counts


def _write_switch_checkpoint(root, dev, seed=0):
    """SB8_CONFIG's checkpoint under HF's tensor names (the key set
    ``SwitchModel.load_params`` and the ingest read), bf16, matrices normal
    with std 0.02, routers and relative biases std 0.5, norms one, made on
    the card from ``seed``; one safetensors shard per block plus one for
    the embedding and the final norms, and the index. Returns its bytes."""
    from moe_infinity_tpu_torch.models.switch import SwitchSpec
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    c = SB8_CONFIG
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(c, indent=2))
    spec = SwitchSpec.from_hf(read_hf_config(str(root)))
    D, F, E, V = c["d_model"], c["d_ff"], c["num_experts"], c["vocab_size"]
    inner, R = c["num_heads"] * c["d_kv"], c["relative_attention_num_buckets"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mat(*shape, std=0.02):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, std, generator=g)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    shards = []
    for prefix, n, decoder in (("encoder", c["num_layers"], False),
                               ("decoder", c["num_decoder_layers"], True)):
        for i in range(n):
            p = f"{prefix}.block.{i}.layer."
            t = [(p + "0.layer_norm.weight", ones(D))]
            t += [(p + f"0.SelfAttention.{w}.weight", mat(inner, D)) for w in "qkv"]
            t.append((p + "0.SelfAttention.o.weight", mat(D, inner)))
            if i == 0:
                t.append((p + "0.SelfAttention.relative_attention_bias.weight",
                          mat(R, c["num_heads"], std=0.5)))
            ff = "2" if decoder else "1"
            if decoder:
                t.append((p + "1.layer_norm.weight", ones(D)))
                t += [(p + f"1.EncDecAttention.{w}.weight", mat(inner, D)) for w in "qkv"]
                t.append((p + "1.EncDecAttention.o.weight", mat(D, inner)))
            t.append((p + f"{ff}.layer_norm.weight", ones(D)))
            if spec.is_sparse(i, decoder):
                t.append((p + f"{ff}.mlp.router.classifier.weight", mat(E, D, std=0.5)))
                for e in range(E):
                    q = f"{p}{ff}.mlp.experts.expert_{e}."
                    t += [(q + "wi.weight", mat(F, D)), (q + "wo.weight", mat(D, F))]
            else:
                t += [(p + f"{ff}.mlp.wi.weight", mat(F, D)), (p + f"{ff}.mlp.wo.weight",
                                                               mat(D, F))]
            shards.append(t)
    shards.append([("shared.weight", mat(V, D)), ("encoder.final_layer_norm.weight", ones(D)),
                   ("decoder.final_layer_norm.weight", ones(D))])
    weight_map, total = {}, 0
    for k, tensors in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        total += _write_safetensors(root / fname, tensors)
        weight_map.update({name: fname for name, _ in tensors})
    (root / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return total


def phase_switch_entry(dev):
    """Phase 30: ``MoE`` from a checkpoint of google/switch-base-8's published
    config (12+12 blocks, every second sparse, 8 experts), written from a
    seed under ``.switch_entry/`` (deleted at the end, also on failure). At
    f32 (float32 experts): the facade at its defaults (max_batch_size 8: the
    continuous batcher) answering 8 concurrent ``generate`` calls from
    threads, the wave batcher's facade, and an offload facade with
    ``speculative_decode`` at a budget below the experts (the batcher over
    the engine's arena), each request's tokens equal to the max_batch_size
    1 facade's (the experts through the plain grouped FFN: K3 takes no
    float32 weights); in bf16 (K3) the default facade against the
    max_batch_size 1 one, reported. Returns the launches of the bf16
    default facade's batch."""
    import concurrent.futures as cf
    import shutil

    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    SB_DIR.mkdir(exist_ok=True)
    free = shutil.disk_usage(SB_DIR).free
    say(f"[sb8] disk free under {SB_DIR.name}/: {free / 1e9:.1f} GB (needs {SB_DISK_GB})")
    if free < SB_DISK_GB * 1e9:
        raise RuntimeError(f"phase 30 needs {SB_DISK_GB} GB of disk under {SB_DIR}")
    try:
        ckpt = SB_DIR / "ckpt"
        t0 = time.perf_counter()
        nbytes = _write_switch_checkpoint(ckpt, dev)
        say(f"[sb8] checkpoint of google/switch-base-8's config: {nbytes / 1e9:.2f} GB of bf16 "
            f"safetensors in {len(list(ckpt.glob('*.safetensors')))} shards, written in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(30)
        prompts = [rng.integers(2, SB8_CONFIG["vocab_size"], (1, SB_PROMPT))
                   for _ in range(SB_REQUESTS)]
        kw = dict(max_new_tokens=SB_NEW, eos_token_id=None)

        def build(tag, cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = MoE(str(ckpt), cfg, device=dev)
            say(f"[sb8] {tag}: built in {time.perf_counter() - t0:.1f} s ("
                f"{'offload' if m.engine is not None else 'resident'}, "
                f"{type(m.s2s_batcher).__name__ if m.s2s_batcher else 'no batcher'})")
            return m

        def batch(m):
            with cf.ThreadPoolExecutor(SB_REQUESTS) as ex:
                return list(ex.map(lambda q: m.generate(q, **kw), prompts))

        counts = {}
        for dtype in ("float32", "bfloat16"):
            store = SB_DIR / f"store-{dtype}"
            t0 = time.perf_counter()
            ingest_checkpoint(str(ckpt), str(store), read_hf_config(str(ckpt)), expert_dtype=dtype)
            say(f"[sb8] ingest ({dtype}): {time.perf_counter() - t0:.1f} s; experts.blob "
                f"{(store / 'experts.blob').stat().st_size / 1e9:.2f} GB")
            # K3 takes bf16, int8, int4 and e4m3 weights: float32 experts run
            # the plain grouped FFN (moe_impl "ragged"), bf16 ones K3
            base = {"expert_dtype": dtype, "offload_path": str(store)}
            if dtype == "bfloat16":
                base.update(moe_impl="pallas", prefill_impl="pallas")
            ref = build(f"{dtype} max_batch_size 1", dict(base, max_batch_size=1))
            want = [ref.generate(q, **kw) for q in prompts]
            ref.shutdown()
            del ref
            legs = [("defaults", base)]
            if dtype == "float32":  # offload: a budget of half the experts' bytes, 64 slots
                half = (store / "experts.blob").stat().st_size // 2
                legs += [("wave", dict(base, s2s_batcher="wave")),
                         ("offload", dict(base, device_memory_bytes=half, dense_paging="off",
                                          num_slots=64, speculative_decode=True))]
            for leg, cfg in legs:
                m = build(f"{dtype} {leg}", cfg)
                try:
                    if m.s2s_batcher is None or (leg == "offload") != (m.engine is not None):
                        raise AssertionError(f"{leg}: unexpected plan")
                    m.generate(prompts[0], max_new_tokens=2, eos_token_id=None)  # warm-up
                    torch.cuda.synchronize()
                    reset_launches()
                    t0 = time.perf_counter()
                    got = batch(m)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    c = launch_counts()
                    extra = ""
                    if isinstance(m.s2s_batcher, Seq2SeqContinuousBatcher):
                        extra = (f"; steps {json.dumps(m.s2s_batcher.step_stats())} graphs "
                                 f"{json.dumps(m.s2s_batcher.graph_stats())}")
                    if m.engine is not None:
                        extra += f"; stats {json.dumps(m.stats())}"
                finally:
                    m.shutdown()
                say(f"[sb8] {dtype} {leg}: {SB_REQUESTS} concurrent requests x {SB_NEW} tokens "
                    f"in {wall:.3f} s: {SB_REQUESTS * SB_NEW / wall:.1f} tokens/s{extra}; "
                    f"launches {json.dumps(c)}")
                _require_launched(c, SWITCH_KERNELS if dtype == "bfloat16" else SWITCH_KERNELS[:1],
                                  f"switch-base-8 facade ({dtype} {leg})")
                what = f"switch-base-8 facade {dtype} {leg} against max_batch_size 1"
                if dtype == "float32":
                    _same_tokens(what, [x[0] for x in got], [x[0] for x in want])
                else:
                    agree = sum(np.array_equal(a, b) for a, b in zip(got, want))
                    say(f"[sb8] {what}: {agree} of {SB_REQUESTS} requests' tokens equal (bf16: "
                        f"reported, not held)")
                if dtype == "bfloat16":
                    counts = c
                del m
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(SB_DIR, ignore_errors=True)
    return counts


def check_batcher_attention(dev):
    """The two kernel inputs the batchers add, against the plain versions:
    K2 at head dim 64 with a per-row T5 bias ``[B, 16, 1, 128]`` (Switch's
    shared step, each row at its own position, causal) at B = 8 and 32, bf16
    and f32, timed beside SDPA with the same float mask; K1 at NLLB's
    B = 8, H = 16, Dh 128 with eight different per-row positions over a
    capacity of 64 (``kv_len`` the capacity), timed against the same call
    with every row at the largest position. Own generator. Returns
    {record name: largest error}."""
    from moe_infinity_tpu_torch.models.layers import t5_relative_bucket
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev)
    g.manual_seed(15)
    errs = {"flash_attend_dh64": 0.0, "flash_decode": 0.0}
    H = 16
    table = torch.randn(32, H, generator=g, device=dev) * 0.5
    for B in (8, 32):
        S = SW_CAP
        offs = torch.randint(0, SW_TOKENS + 1, (B,), generator=g, device=dev).to(torch.int32)
        rel = torch.arange(S, device=dev, dtype=torch.int32)[None, :] - offs[:, None]
        bias = table[t5_relative_bucket(rel, False, 32, 128).long()].permute(0, 2, 1)[:, :, None]
        for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-3)):
            q = torch.randn(B, 1, H, 64, generator=g, device=dev).to(dtype)
            k = torch.randn(B, S, H, 64, generator=g, device=dev).to(dtype)
            v = torch.randn(B, S, H, 64, generator=g, device=dev).to(dtype)
            pos = offs[:, None].contiguous()
            run = lambda: fa.flash_attend(q, k, v, pos, S, scale=1.0, bias=bias)  # noqa: E731
            plain = lambda: fa.flash_attend_plain(q, k, v, pos, S, scale=1.0,  # noqa: E731
                                                  bias=bias)
            errs["flash_attend_dh64"] = max(errs["flash_attend_dh64"], compare(
                f"flash_attend Dh=64 per-row T5 bias {list(bias.shape)} B={B} S={S} causal "
                f"{str(dtype).split('.')[-1]}", run(), plain(), tol))
            if dtype != torch.bfloat16:
                continue
            # the kernel reads K, V and the bias only in each row's live
            # columns (the causal bound): q in, out, K/V and bias columns, pos
            live = int((offs + 1).sum())
            nbytes = (2 * B * H * 64 * 2 + 2 * live * H * 64 * 2
                      + live * H * bias.element_size() + B * 4)
            b_ms, b_by = bound_ms(nbytes, 4 * H * 64 * live)
            ok = torch.arange(S, device=dev)[None, :] <= offs[:, None]
            fmask = torch.where(ok[:, None, None, :], bias, float("-inf")).to(torch.bfloat16)
            lib = _sdpa_lib(q, k, v, fmask, 1.0)
            say(f"[time] flash_attend Dh=64 per-row T5 bias B={B}: " + json.dumps(dict(
                ms=cuda_ms(run), plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lib), live_keys=live,
                shape=f"B={B} T=1 H={H} Dh=64 S={S} bias {list(bias.shape)} bf16 (library: "
                      f"SDPA, the bias and the causal bound as a float mask)")))
    B, S, Dh = 8, 64, 128
    pos = torch.tensor([0, 5, 11, 23, 31, 40, 52, 63], dtype=torch.int32, device=dev)[:, None]
    q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    top = torch.full_like(pos, int(pos.max()))
    run = lambda: fa.flash_decode(q, k, v, pos, S)  # noqa: E731
    plain = lambda: fa.flash_decode_plain(q[:, 0], k, v, pos[:, 0], S,  # noqa: E731
                                          scale=Dh ** -0.5)
    errs["flash_decode"] = compare(f"flash_decode per-row positions {pos[:, 0].tolist()} B={B} "
                                   f"H={H} capacity {S}", run()[:, 0], plain())
    same = lambda: fa.flash_decode(q, k, v, top, S)  # noqa: E731
    live = int((pos + 1).sum())
    nbytes = 2 * B * H * Dh * 2 + 2 * live * H * Dh * 2 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * H * Dh * live)
    ok = torch.arange(S, device=dev)[None, :] <= pos
    fmask = torch.where(ok, 0.0, float("-inf"))[:, None, None, :].to(torch.bfloat16)
    ms = [cuda_ms(f) for f in (run, same, run, same)]
    say(f"[time] flash_decode NLLB per-row positions: " + json.dumps(dict(
        ms=ms[0], ms_again=ms[2], all_rows_at_63_ms=ms[1], all_rows_at_63_again_ms=ms[3],
        plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(_sdpa_lib(q, k, v, fmask, Dh ** -0.5)), live_keys=live,
        shape=f"B={B} H={H} Dh={Dh} capacity {S}, positions {pos[:, 0].tolist()} bf16")))
    return errs


def _sdpa_lib(q, k, v, mask, scale):
    import torch.nn.functional as F_

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F_.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)


def phase_batchers(dev, extra):
    """``--batchers``: phases 24 to 30 on builds of their own."""
    for fn in (phase_s2s_batchers, phase_s2s_batcher_offload, phase_s2s_batchers_whole_path,
               phase_switch_batcher, phase_arctic_batcher, phase_mixtral_speculative,
               phase_switch_entry):
        extra[fn.__name__] = _subphase(fn, dev) or {}
        _free_host_cache()


def sweep_decode_plans(dev):
    """``--decode-plans``: K4 at the Mixtral decode shape and at the long rows
    under split plans aimed at 2 to 8 blocks per SM (the wrapper's
    ``_DEC_BLOCKS``), first and last the same, to show the spread."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    kept = fa._DEC_BLOCKS
    try:
        for blocks in (264, 396, 528, 792, 1056, 264):
            fa._DEC_BLOCKS = blocks
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            say(f"[plan] _DEC_BLOCKS={blocks}")
            check_paged_decode(g, dev)
            check_decode_long(g, dev)
    finally:
        fa._DEC_BLOCKS = kept


def _decode_layers(g, dev):
    """{name: (calls, byte bound in ms)} of whole decode MoE layers on K3,
    each call the arguments of one ``gmm`` (x, w, sizes, scale, offset, ids,
    packed), the down projection's input drawn at random: NLLB's (gate +
    down, int4), Mixtral's at W=1 and at its W=16 step (int8), V2-Lite's
    (bf16 and int4, its 64 groups uncompacted)."""
    from moe_infinity_tpu_torch.ops.gmm import compact_groups

    def layer(x, w, sc, gsz, gid=None, packed=False, roles=ROLES):
        h = torch.randn(x.shape[0], w["down"].shape[1], generator=g, device=dev).to(torch.bfloat16)
        calls = [(h if r == "down" else x, w[r], gsz, sc[r], 0, gid, packed) for r in roles]
        active, nbytes, flops = int((gsz > 0).sum()), 0, 0
        for xin, wr, _, s, _, _, p in calls:
            (rows, D), F = xin.shape, wr.shape[2] * (2 if p else 1)
            nbytes += (active * (D * wr.shape[2] * wr.element_size() + (0 if s is None else F * 4))
                       + rows * D * 2 + rows * F * 4)
            flops += 2 * rows * D * F
        return calls, bound_ms(nbytes, flops)[0]

    layers = {}
    gid, gsz, _ = _routed_rows(g, dev, 4, 128)
    w, sc = _layer_weights(g, dev, 128, 2048, 8192, "int4")
    x = torch.randn(8, 2048, generator=g, device=dev).to(torch.bfloat16)
    layers["nllb_decode"] = layer(x, w, sc, gsz, gid, packed=True, roles=("gate", "down"))
    w, sc = _layer_weights(g, dev, 8, 4096, 14336, "int8")
    gid, gsz = compact_groups(torch.sort(torch.randperm(8, generator=g, device=dev)).values, 8)
    x = torch.randn(8, 4096, generator=g, device=dev).to(torch.bfloat16)
    layers["mixtral_decode"] = layer(x, w, sc, gsz, gid)
    gid, gsz, _ = _routed_rows(g, dev, SLOTS * CHUNK, 8)
    x = torch.randn(2 * SLOTS * CHUNK, 4096, generator=g, device=dev).to(torch.bfloat16)
    layers["mixtral_w16"] = layer(x, w, sc, gsz, gid)
    flat = torch.stack([torch.randperm(64, generator=g, device=dev)[:6] for _ in range(SLOTS)])
    gsz = torch.zeros(64, dtype=torch.int32, device=dev)
    gsz.index_add_(0, flat.reshape(-1), torch.ones(24, dtype=torch.int32, device=dev))
    x = torch.randn(24, 2048, generator=g, device=dev).to(torch.bfloat16)
    for kind in ("bf16", "int4"):
        w, sc = _layer_weights(g, dev, 64, 2048, 1408, kind)
        layers[f"v2lite_{kind}"] = layer(x, w, sc, gsz, packed=kind == "int4")
    return layers


def _gmm_calls(fn, calls):
    """A function that runs ``fn`` (``gmm`` or ``gmm_plain``) on each call."""
    return lambda: [fn(*c[:6], packed=c[6]) for c in calls]


def sweep_gmm_plans(dev):
    """The tail of ``--gmm``: K3's time for ``_decode_layers`` under other
    block targets of the split planner (``_GMM_BLOCKS``), the first again
    last, to show the spread."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    runs = {k: _gmm_calls(gm.gmm, calls) for k, (calls, _) in _decode_layers(g, dev).items()}
    kept = gm._GMM_BLOCKS
    try:
        for blocks in (264, 528, 792, 264):
            gm._GMM_BLOCKS = blocks
            say(f"[plan] _GMM_BLOCKS={blocks}: "
                + " ".join(f"{k}={cuda_ms(fn):.4f}" for k, fn in runs.items()))
    finally:
        gm._GMM_BLOCKS = kept


def sweep_mla_plans(dev):
    """The tail of ``--mla``: K5's time at its three timed shapes under other
    block targets (``_MLA_BLOCKS``) and least tiles a split
    (``_MLA_MIN_TILES``) of the split planner, the first again last, to show
    the spread."""
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cases = {
        "v2lite": _mla_inputs(g, dev, B=SLOTS, H=16, S=MAX_COLS, lengths=[113, 200, 37, 512]),
        "long": _mla_inputs(g, dev, B=4, H=16, S=8192, lengths=[8192, 6000, 3000, 1000]),
        "h128": _mla_inputs(g, dev, B=SLOTS, H=128, S=MAX_COLS, lengths=[113, 200, 37, 512]),
    }
    runs = {k: (lambda a=a: fa.mla_flash_decode(a["q_lat"], a["q_pe"], a["c"], a["kpe"],
                                                a["lengths"] - 1, a["c"].shape[1],
                                                scale=192 ** -0.5, pad_mask=a["holes"]))
            for k, a in cases.items()}
    kept = fa._MLA_BLOCKS, fa._MLA_MIN_TILES
    try:
        for blocks, tiles in ((132, 2), (264, 2), (132, 1), (132, 4), (264, 4), (132, 2)):
            fa._MLA_BLOCKS, fa._MLA_MIN_TILES = blocks, tiles
            plans = {k: fa._mla_splits(a["q_lat"].shape[0], a["q_lat"].shape[1],
                                       int(a["lengths"].max())) for k, a in cases.items()}
            say(f"[plan] _MLA_BLOCKS={blocks} _MLA_MIN_TILES={tiles}: "
                + " ".join(f"{k}={cuda_ms(fn):.5f} {plans[k]}" for k, fn in runs.items()))
    finally:
        fa._MLA_BLOCKS, fa._MLA_MIN_TILES = kept


# ---------------------------------------------------------------------------
# phase 2's stream_gather; phases 31 to 33: stream decode and direct-tier
# layers (bench.py's stream-decode leg, --direct-layers)
# ---------------------------------------------------------------------------

ST_UNIQUE = 8  # bench.py's stream leg: --stream-unique 8
# the leg's batch (bench.py: --batch 1 means 32), prompt and new tokens
# (min(8, --tokens)), its warm-up generate's tokens (2k - 1 at k = 1, at least
# 2) and the cache both take (_bucket_len(8 + 1))
ST_BATCH, ST_PROMPT, ST_TOKENS, ST_WARM, ST_CAP = 32, 16, 8, 2, 16
STREAM_KERNELS = NLLB_KERNELS + ("stream_gather",)
TOKENS_PER_S = {}  # phase 11's tokens/s by leg, printed beside phases 31 and 32's


def check_stream_gather(dev):
    """``stream_gather`` (``csrc/stream.cu``) against its plain version on
    NLLB-MoE-54B's int4 record (6 roles, 16.86 MB) in a 128-record
    page-locked tier made as phase 9 makes it (segments of 30 records): U = 8
    (the main path's width: phase 31) and 64, rows crossing segments and rows
    of -1 (zeros, nothing read), and U = 13 with one segment promoted to the
    card among pinned ones; every byte equal. Times the kernel, the plain
    version and, as the library yardstick, one ``copy_(non_blocking=True)`` per present record
    role from pinned memory (a copy engine's cudaMemcpyAsync) and a
    ``zero_`` per absent one, at U = 8 and 64: kernel and copies three times
    each, back to back, their medians in the row. The bound counts the
    present rows' bytes over the host link. Returns the kernel's record at
    U = 8."""
    from moe_infinity_tpu_torch.models.nllb import NllbSpec
    from moe_infinity_tpu_torch.ops import stream as st
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = NllbSpec(**NLLB_54B)
    store = _offload_store(spec, cache_records=1)
    n_rec = min(128, store.num_layers * spec.num_experts)
    tier = PinnedExpertTier(store, device=dev, shared_record=False,
                            max_bytes=n_rec * store.stride, synth_on_device=True)
    seg_rows, R = tier._seg_rows, store.stride
    src = st.StreamSource({k: list(v) for k, v in tier.fields.items()}, None, seg_rows)
    mixed = st.StreamSource({k: [a.to(dev) if s == 1 else a for s, a in enumerate(v)]
                             for k, v in tier.fields.items()}, None, seg_rows)
    g = torch.Generator().manual_seed(16)
    err, recs = 0.0, {}
    for U, source, label in ((8, src, "pinned"), (64, src, "pinned"),
                             (13, mixed, "segment 1 on the card")):
        rows = torch.randperm(n_rec, generator=g)[:U].to(torch.int32)
        rows[::5] = -1
        rows_d = rows.to(dev)
        got = st.stream_gather(source, rows_d)
        want = st.stream_gather_plain(source.fields, seg_rows, rows)
        torch.cuda.synchronize()
        for role, w in want.items():
            a = got[role].cpu()
            err = max(err, (a.float() - w.float()).abs().max().item())
            if not torch.equal(a, w):
                raise AssertionError(f"stream_gather U={U} ({label}): role {role} differs")
            if w[rows < 0].any():
                raise AssertionError(f"stream_gather U={U}: a row of -1 is not zeros")
        present = [r for r in rows.tolist() if r >= 0]
        host = R * sum(label == "pinned" or r // seg_rows != 1 for r in present)
        say(f"[check] stream_gather U={U} ({label}, rows of -1 at {rows.tolist()[::5]}, "
            f"segments of {seg_rows} records): every byte equal to the plain version, rows "
            f"of -1 zeros; {host / 1e6:.1f} MB from page-locked memory")
        if label != "pinned":
            continue
        run = lambda: st.stream_gather(src, rows_d)  # noqa: E731
        plain = lambda: st.stream_gather_plain(src.fields, seg_rows, rows_d)  # noqa: E731
        outs = {k: torch.empty((U,) + v[0].shape[1:], dtype=v[0].dtype, device=dev)
                for k, v in src.fields.items()}
        r = rows.tolist()

        def lib():
            for k, segs in src.fields.items():
                for u, row in enumerate(r):
                    if row < 0:
                        outs[k][u].zero_()
                    else:
                        outs[k][u].copy_(segs[row // seg_rows][row % seg_rows],
                                         non_blocking=True)

        # kernel and copy engine back to back, three times: a swing of the
        # link's rate shows in both, one of the kernel's in the kernel alone
        pairs = [(cuda_ms(run), cuda_ms(lib, iters=5)) for _ in range(3)]
        ms, lib_ms = (float(np.median([p[i] for p in pairs])) for i in (0, 1))
        b_ms = max(host / HOST_LINK_BYTES_PER_S, U * R / HBM_BYTES_PER_S) * 1e3
        recs[U] = dict(name="stream_gather", route="cuda",
                       source="moe_infinity_tpu_torch/csrc/stream.cu",
                       replaces="none: moe_infinity_tpu/ops/stream.py:133 gathers with "
                                "dynamic_slice and device_put, no pallas_call",
                       max_abs_err=0.0, ms=ms, plain_ms=cuda_ms(plain, iters=3, warmup=1),
                       bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
                       shape=f"U={U} slots, {len(present)} records of {R / 1e6:.2f} MB (6 "
                             f"roles) from page-locked memory over PCIe Gen5 x16 "
                             f"({HOST_LINK_BYTES_PER_S / 1e9:.2f} GB/s), {U - len(present)} "
                             "rows of -1")
        rc = recs[U]
        say(f"[stream_gather] U={U} ({len(present)} present rows, {host / 1e6:.1f} MB): "
            f"ms={ms:.4f} ({host / ms / 1e6:.1f} GB/s) plain_ms={rc['plain_ms']:.3f} "
            f"library_ms={lib_ms:.4f} ({6 * len(present)} copy_ calls, "
            f"{host / lib_ms / 1e6:.1f} GB/s) bound_ms={b_ms:.4f}; back to back (kernel, "
            f"copies) {[(round(a, 4), round(b, 4)) for a, b in pairs]}")
    recs[8]["max_abs_err"] = err
    del src, mixed, tier, store
    _free_host_cache()
    return recs[8]


def _stream_build(dev):
    """Phases 31 and 32's set-up: bench.py's nllb-offload build with
    ``--stream`` (``_nllb_build``, :933-1075): phase 9's dense weights and
    int4 store, and its 14 GiB page-locked tier made on the card, in
    layer-aligned segments (``align_rows`` = E, as bench.py's
    ``_make_nllb_tier``), decoder records first. Every decoder record must be
    staged: the tier stages less, quietly, when MemAvailable is short."""
    b = _offload_build(dev, align=True)
    spec, store, tier, E = b.spec, b.store, b.tier, b.spec.num_experts
    n_enc = store.meta["num_encoder_moe_layers"]
    staged = sum(tier.record_index(l, e) is not None
                 for l in range(n_enc, store.num_layers) for e in range(E))
    total = (store.num_layers - n_enc) * E
    say(f"[stream] build: decoder records staged {staged} of {total}; tier "
        f"{json.dumps(tier.stats())}, segments of {tier._seg_rows} records; set-up "
        f"{time.perf_counter() - b.t0:.1f} s")
    if staged != total:
        raise AssertionError(f"the tier staged {staged} of {total} decoder records")
    b.dec_mlis = list(range(n_enc, store.num_layers))
    return b


def _bench_slots(b, n_direct=0, stream=False):
    """bench.py's arena for ``--hbm-gb 13`` (:1018-1048): the budget less the
    dense weights, the KV reserve and ``n_direct`` promoted layers, at most
    the union a batch of 32 routes over the other decoder layers, at least
    E; with ``--stream`` at most 2E (the arena serves the encoder alone)."""
    E, stride = b.spec.num_experts, b.store.stride
    union = (len(b.dec_mlis) - n_direct) * min(E, 2 * ST_BATCH)
    budget = int((HBM_GB * 2**30 - b.dense - KV_RESERVE - n_direct * E * stride) // stride)
    slots = max(E, min(union, budget))
    return max(E, min(slots, 2 * E)) if stream else slots


def _stream_probe(engine):
    """Per stream block: the U it started and ended at, and the executions.
    Returns the log and a function that takes the probe off."""
    log, block = [], engine._stream_block

    def probe(*a):
        u0, n0 = engine._stream_U, len(engine.replay_counts)
        out = block(*a)
        log.append((u0, engine._stream_U, engine.replay_counts[n0:], a[-1]))
        return out

    engine._stream_block = probe

    def off():
        del engine._stream_block

    return log, off


def _leg(b, tag, engine, ids, mask, new_tokens, warm_tokens, kernels, cap=None, guard=True):
    """One leg of phases 31 and 32 on ``engine``: a warm-up generate (every
    dispatch under the sync guard where ``guard``), then the timed one with
    its launches, executions and host time. Returns (sequences, numbers)."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.engine import speculative_stats

    gen = dict(attention_mask=mask, eos_token_id=None, cache_len=cap)
    t0 = time.perf_counter()
    n_guard, unguard = _sync_guard(engine) if guard else ([0], lambda: None)
    try:
        engine.generate(ids, max_new_tokens=warm_tokens, **gen)
        torch.cuda.synchronize()
    finally:
        unguard()
    warm_s = time.perf_counter() - t0
    if guard and n_guard[0] == 0:
        raise AssertionError(f"{tag}: no dispatch ran under the sync guard")
    g0, x0, r0 = engine.graph_stats(), engine.executed_steps, len(engine.replay_counts)
    s0, pt0 = engine.stats(), dict(engine.phase_timings)
    stream = getattr(engine, "_stream", False)
    ulog, unprobe = _stream_probe(engine) if stream else ([], lambda: None)
    rec0 = getattr(engine, "stream_records", 0)
    host, untime = _host_timer(engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = engine.generate(ids, max_new_tokens=new_tokens, **gen)
        torch.cuda.synchronize()
    finally:
        untime()
        unprobe()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    g1, s1 = engine.graph_stats(), engine.stats()
    steps = engine.executed_steps - x0
    warm = g1.get("warmup_steps", 0) - g0.get("warmup_steps", 0)
    execs = engine.replay_counts[r0:]
    B, st = ids.shape[0], res.stats
    tps = B * new_tokens / (st["decode_ms"] / 1e3)
    n = dict(tokens_per_s=tps, decode_ms_per_token=st["decode_ms"] / new_tokens,
             encode_ms=st["encode_ms"], wall_s=wall, warm_s=warm_s, executions=execs,
             executions_per_block=float(np.mean(execs)) if execs else 0.0,
             executions_per_token=sum(execs) / new_tokens if execs else 0.0,
             host_ms_per_step=host[0] * 1e3 / max(1, new_tokens),
             host_ms_per_dispatch=host[0] * 1e3 / max(1, host[1]),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9, graphs=g1)
    if stream:
        # U path, and the tier's bytes: the records the gathers read (the
        # staged ones among each (layer, step)'s first U distinct experts)
        path = [ulog[0][0]] if ulog else []
        for u0, u1, ex, k in ulog:
            u = u0
            for _ in ex:
                if u not in path:
                    path.append(u)
                u = min(b.spec.num_experts, 2 * u)
        nbytes = (engine.stream_records - rec0) * b.store.stride
        n.update(u_path=path, tier_gb_per_step=nbytes / 1e9 / new_tokens)
    else:
        dw = engine.decode_window_stats()
        n.update(decode_hit_rate=dw["decode_hit_rate"], decode_visits=dw["visits"],
                 misses=dw["misses"])
    say(f"[{tag}] sequences shape {res.sequences.shape}; first row {res.sequences[0].tolist()}")
    say(f"[{tag}] {json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in n.items()})}"
        f"; speculative_stats {json.dumps(speculative_stats(execs))}; phase_timings (timed "
        f"generate, s) {json.dumps({k: round(v - pt0.get(k, 0.0), 4) for k, v in engine.phase_timings.items()})}; "
        f"arena visits {s1['visits'] - s0['visits']}")
    spec = b.spec
    n_enc = sum(spec.is_sparse(i, False) for i in range(spec.encoder_layers))
    encode = {"flash_attend": spec.encoder_layers, "gmm": 2 * n_enc}  # NLLB-54B: 24, 12
    per_step = {"flash_decode": spec.decoder_layers, "flash_attend": spec.decoder_layers,
                "gmm": 2 * len(b.dec_mlis), "stream_gather": len(b.dec_mlis) if stream else 0}
    want = {k: encode.get(k, 0) + c * (steps + warm) for k, c in per_step.items()}
    say(f"[{tag}] launches {json.dumps(counts)}; expected from {steps} executed steps, {warm} "
        f"warm-up steps of captures and one encode {json.dumps(want)}")
    if res.sequences.shape != (B, new_tokens + 1):
        raise AssertionError(f"{tag}: unexpected output shape {res.sequences.shape}")
    if not np.all((res.sequences >= 0) & (res.sequences < b.spec.vocab_size)):
        raise AssertionError(f"{tag}: token ids out of range")
    _require_launched(counts, kernels, tag)
    if engine.speculative and any(counts.get(k, 0) != c for k, c in want.items()):
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if engine.graphs is not None and engine.speculative and (
            g1["recaptures"] or g1["replays"] - g0.get("replays", 0) != sum(execs)):
        raise AssertionError(f"{tag}: every execution a replay, none recaptured expected "
                             f"({g0} -> {g1}, executions {execs})")
    return res.sequences, n, counts


def _beside_phase_11(tps):
    p11 = TOKENS_PER_S.get("graphs")
    return (f"{tps:.2f} tokens/s beside phase 11's {p11:.2f} (graphs)" if p11
            else f"{tps:.2f} tokens/s (phase 11 not run in this call)")


def _bench_prompts(vocab):
    """bench.py's nllb-offload prompts (``bench_nllb_offload``, :1234-1238):
    32 rows of ``(arange(16) * 131 + 7) % (vocab - 10)``, unpadded."""
    T = ST_PROMPT
    ids = (np.arange(T, dtype=np.int64)[None].repeat(ST_BATCH, 0) * 131 + 7) % (vocab - 10)
    return ids, np.ones((ST_BATCH, T), dtype=np.float32)


def phase_stream_decode(dev, built=None):
    """Phase 31: NLLB-MoE-54B at full width and depth (24+24 blocks) through
    stream decode, as bench.py builds its stream leg (``_stream_build``, an
    arena of ``max(E, min(slots, 2E))`` = 256 slots for the encoder): phase
    3's 4 requests x 16 tokens at ``stream_unique`` 8, blocks of k = 1 and
    then k = 4; then bench.py's leg itself (``--spec-block 1
    --stream-unique 8``: 32 prompts of 16, a warm-up of 2 tokens, 8 timed,
    a cache of 16); each eagerly, then as graphs (one per (k, U)). K1, K2, K3
    and ``stream_gather`` launch exactly as the executed steps say, every
    graph execution is a replay, graph tokens equal eager ones. Returns
    (launches, the build) for phase 32."""
    from moe_infinity_tpu_torch.runtime.generate import _bucket_len

    b = built or _stream_build(dev)
    slots = _bench_slots(b, stream=True)
    say(f"[stream] arena {slots} slots (bench.py's --stream sizing), U0={ST_UNIQUE}")
    counts_all = []
    # the warm-up generate at the timed one's cache capacity and over every
    # block size of the halving chain (2k - 1 tokens), so that the timed one
    # finds its graphs captured
    cap = _bucket_len(NEW_TOKENS + 1)
    legs = [(f"4 requests x {NEW_TOKENS}, k={k}", b.ids, b.mask, NEW_TOKENS, 2 * k - 1, k, cap)
            for k in (1, 4)]
    legs.append((f"bench.py's leg: {ST_BATCH} prompts of {ST_PROMPT}, k=1, {ST_TOKENS} tokens",
                 *_bench_prompts(b.spec.vocab_size), ST_TOKENS, ST_WARM, 1, ST_CAP))
    for label, ids, mask, n_new, n_warm, k, cap in legs:
        seqs = {}
        for graphs in (False, True):
            tag = f"stream {'graphs' if graphs else 'eager'}"
            engine = _offload_engine(b.model, b.params, b.store, slots, b.tier, speculative=True,
                                     spec_block=k, stream_decode=True, stream_unique=ST_UNIQUE,
                                     max_direct_layers=0, graphs=graphs)
            try:
                say(f"[{tag}] {label}")
                seqs[graphs], n, counts = _leg(b, tag, engine, ids, mask, n_new, max(n_warm, 2),
                                               STREAM_KERNELS, cap=cap)
                counts_all.append(counts)
                say(f"[{tag}] {label}: {_beside_phase_11(n['tokens_per_s'])}; executions per "
                    f"block {n['executions_per_block']:.3f} (per token "
                    f"{n['executions_per_token']:.3f}), U path {n['u_path']}, host ms per step "
                    f"{n['host_ms_per_step']:.3f}, tier GB read per step "
                    f"{n['tier_gb_per_step']:.3f}, peak {n['peak_gb']:.2f} GB")
            finally:
                engine.arena.shutdown()
            del engine
            torch.cuda.empty_cache()
        same = np.array_equal(seqs[True], seqs[False])
        say(f"[stream] {label}: graph against eager greedy tokens "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"stream decode ({label}): graph and eager tokens differ")
    return _sum_counts(*counts_all), b


# phase 32's legs, (max_direct_layers, new tokens): bench.py's two direct
# layers, then all six; the whole run takes both at 8 tokens, for its time
# limit (phases 41-42 took its share)
DIRECT_LEGS = ((2, NEW_TOKENS), (None, NEW_TOKENS))
WHOLE_RUN_DIRECT = ((2, WHOLE_RUN_NEW_TOKENS), (None, WHOLE_RUN_NEW_TOKENS))


def phase_direct_layers(dev, built=None, legs=DIRECT_LEGS):
    """Phase 32: direct-tier layers on phase 31's build and tier. First at
    bench.py's sizing for ``--hbm-gb 13 --direct-layers 2`` (the deepest two
    decoder MoE layers promoted to the card, 4.3 GB; the arena's slots from
    the rest of the budget), then at ``max_direct_layers=None``: all 6
    decoder MoE layers, 12.9 GB. Each per layer (eager: it reads the routing
    on the host) and speculatively at k = 4 as graphs, on phase 3's 4
    requests x the leg's tokens (``legs``); with every decoder layer direct, every block
    accepts at its first dispatch and the decoder never visits the arena."""
    b = built or _stream_build(dev)
    counts_all = []
    for n_direct, new_tokens in legs:
        slots = _bench_slots(b, n_direct=n_direct or len(b.dec_mlis))
        for speculative in (False, True):
            tag = f"direct {'spec' if speculative else 'per-layer'}"
            before = torch.cuda.memory_allocated()
            engine = _offload_engine(b.model, b.params, b.store, slots, b.tier,
                                     speculative=speculative, spec_block=4,
                                     max_direct_layers=n_direct)
            try:
                direct = sorted(engine._direct_mlis)
                say(f"[{tag}] max_direct_layers={n_direct}: direct MoE layers {direct} "
                    f"(promoted {sum(t.numel() * t.element_size() for d in engine._direct.values() for t in d.values()) / 1e9:.2f} GB "
                    f"on the card; allocated {before / 1e9:.2f} -> "
                    f"{torch.cuda.memory_allocated() / 1e9:.2f} GB), arena {slots} slots")
                want = b.dec_mlis[-(n_direct or len(b.dec_mlis)):]
                if direct != want:
                    raise AssertionError(f"{tag}: direct layers {direct}, expected {want}")
                _, n, counts = _leg(b, tag, engine, b.ids, b.mask, new_tokens, new_tokens,
                                    NLLB_KERNELS, guard=speculative)
                counts_all.append(counts)
                say(f"[{tag}] max_direct_layers={n_direct}: {_beside_phase_11(n['tokens_per_s'])}; "
                    f"decode hit rate {n['decode_hit_rate']:.4f} over {n['decode_visits']} "
                    f"visits, executions per block {n['executions_per_block']:.3f}")
                if n_direct is None and (n["decode_visits"] or (speculative and any(
                        e != 1 for e in n["executions"]))):
                    raise AssertionError(f"{tag}: all layers direct, yet visits "
                                         f"{n['decode_visits']} or executions {n['executions']}")
            finally:
                engine.arena.shutdown()
            del engine
            torch.cuda.empty_cache()
    return _sum_counts(*counts_all)


def _stream_first_step(engine, ids, mask):
    """The first decode step's logits through the engine's encoder and its
    stream sources at the engine's present U (the gather and K3)."""
    model = engine.model
    dev = model.device
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    with torch.inference_mode():
        _, cross = engine.run_encoder(tok, m)
        start = torch.full((tok.shape[0], 1), model.spec.decoder_start_token_id,
                           dtype=torch.int32, device=dev)
        sources, ident = engine._stream_sources(engine._stream_U), engine._identity
        logits, _, _ = model.decode_step(
            engine.params, None, start, torch.zeros_like(start), engine.init_cache(
                tok.shape[0], 32), 0, m, cross, lambda _e, mli: (sources[mli], ident, None),
            engine._impl)
    return logits


def phase_stream_whole_path(dev, blocks=PARITY_BLOCKS):
    """Phase 33: stream decode and direct-tier layers at f32, full width, 4+4
    blocks (2+2 MoE layers), over phase 10's store (seed 11) with its
    decoder records copied into a layer-aligned tier, against the resident
    ``Seq2SeqGenerator`` over the same records: greedy tokens and the first
    step's logits bit-equal. Stream at k = 1 and 4 from ``stream_unique`` 2
    (U escalates), with graphs and eagerly; direct layers all and some (1),
    per layer and speculative at k = 4 (graphs and eager) and k = 1 (graph
    logits against eager at every accepted step)."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=blocks, decoder_layers=blocks,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    E, seed = spec.num_experts, 11
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = NllbModel(spec, compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _offload_store(spec, seed=seed, cache_records=4 * E)
    provider = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    n_dec = (store.num_layers - store.meta["num_encoder_moe_layers"]) * E
    tier = PinnedExpertTier(store, device=dev, shared_record=False, max_bytes=n_dec * store.stride,
                            synth_on_device=False, align_rows=E)
    ids, mask = _requests(spec.vocab_size, g, dev)
    gen = dict(max_new_tokens=NEW_TOKENS, attention_mask=mask, eos_token_id=None)
    want = Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer,
                            impl="pallas", graphs=False).generate(ids, **gen).sequences
    want_logits = _first_step_logits(model, params, provider, ids, mask, "pallas")

    def check(what, got, logits=None, kernels=NLLB_KERNELS, counts=None):
        same = np.array_equal(got, want)
        bit = logits is None or torch.equal(logits, want_logits)
        say(f"[check] {what} vs resident f32 (full width, {blocks}+{blocks} blocks, int4 experts): greedy "
            f"tokens {'equal' if same else 'DIFFER'}"
            + ("" if logits is None else ", first-step logits " + (
                "bit-equal" if bit else f"DIFFER by {(logits - want_logits).abs().max():.3e}")))
        if counts is not None:
            _require_launched(counts, kernels, what)
        if not (same and bit):
            raise AssertionError(f"{what}: differs from the resident path")

    for k in (1, 4):
        seqs = {}
        for graphs in (True, False):
            what = f"stream k={k} from U=2 {'graphs' if graphs else 'eager'}"
            engine = _offload_engine(model, params, store, E, tier, speculative=True,
                                     spec_block=k, stream_decode=True, stream_unique=2,
                                     max_direct_layers=0, graphs=graphs)
            try:
                reset_launches()
                seqs[graphs] = engine.generate(ids, **gen).sequences
                torch.cuda.synchronize()
                counts = launch_counts()
                say(f"[check] {what}: executions {engine.replay_counts}, U {engine._stream_U}, "
                    f"graphs {json.dumps(engine.graph_stats())}")
                if engine._stream_U <= 2 or max(engine.replay_counts) <= 1:
                    raise AssertionError(f"{what}: U never escalated")
                check(what, seqs[graphs], _stream_first_step(engine, ids, mask),
                      STREAM_KERNELS, counts)
            finally:
                engine.arena.shutdown()
            del engine
        if not np.array_equal(seqs[True], seqs[False]):
            raise AssertionError(f"stream k={k}: graph and eager tokens differ")
    for n_direct in (None, 1):
        label = f"direct {'all' if n_direct is None else 'deepest 1'}"
        engine = _offload_engine(model, params, store, E, tier, max_direct_layers=n_direct)
        try:
            logits = _offload_first_step(engine, ids, mask)
            reset_launches()
            got = engine.generate(ids, **gen).sequences
            torch.cuda.synchronize()
            say(f"[check] {label} per layer: direct layers {sorted(engine._direct_mlis)}, "
                f"decode window {json.dumps({k: v for k, v in engine.decode_window_stats().items() if k in ('visits', 'misses', 'evictions')})}")
            check(f"{label} per layer", got, logits, counts=launch_counts())
        finally:
            engine.arena.shutdown()
        del engine
        for k in (1, 4):
            runs = {}
            for graphs in (True, False):
                res, logits, engine, counts = _spec_case(
                    model, params, store, tier, ids, gen, k, "whole", graphs,
                    "steps" if k == 1 else None, max_direct_layers=n_direct)
                what = f"{label} speculative k={k} {'graphs' if graphs else 'eager'}"
                say(f"[check] {what}: executions {engine.replay_counts}, graphs "
                    f"{json.dumps(engine.graph_stats())}")
                check(what, res.sequences, logits[0] if logits else None, counts=counts)
                if n_direct is None and any(e != 1 for e in engine.replay_counts):
                    raise AssertionError(f"{what}: every block should accept at once")
                runs[graphs] = logits
                del engine
            if k == 1:
                how = [_same_or_close(f"{label} k=1 step {i}", a, b)
                       for i, (a, b) in enumerate(zip(runs[True], runs[False]))]
                say(f"[check] {label} k=1 f32 graph against eager logits over {len(how)} "
                    f"accepted steps: {sum(h == 'bit-equal' for h in how)} bit-equal, others "
                    f"{sorted(set(how))}")
    del model, params, provider, store, tier
    torch.cuda.empty_cache()
    _free_host_cache()


def phase_stream(dev, blocks=PARITY_BLOCKS, direct_legs=DIRECT_LEGS):
    """``--stream`` and the whole run: phase 9's tier released, then phases
    31 to 33 (31 and 32 on one build, 32 at each leg of ``direct_legs``; 33
    at ``blocks``). Returns the launches of 31 and 32."""
    _free_host_cache()
    counts, b = _subphase(phase_stream_decode, dev)
    counts = _sum_counts(counts, _subphase(phase_direct_layers, dev, b, direct_legs))
    del b
    _free_host_cache()
    _subphase(phase_stream_whole_path, dev, blocks)
    return counts


# ---------------------------------------------------------------------------
# phases 34-38: serving past the card's memory (OPT-66B paged through the
# card, NLLB-MoE-54B with paged dense blocks, the host fallback)
# ---------------------------------------------------------------------------

# facebook/opt-66b's config.json: hidden 9216, FFN 36864, 72 heads, 64
# layers, vocab 50272, 2048 positions, ReLU, pre-norm
OPT_66B = dict(vocab_size=50272, hidden_size=9216, ffn_dim=36864, num_layers=64,
               num_heads=72, max_positions=2048, activation="relu")
OPT_DISTINCT = 8  # seeded layers drawn; phase 34b's 64 host layers alias them
OPT_PROMPT = 32  # phase 34's prompt length (34a's shorter prompts left-padded to it)
OPT_PROMPT_LENS = (32, 27, 20, 12)  # 34a's 4 requests
OPT_SLOTS = 3  # 34a's dense slots (of 8 layers)
OPT_SLOTS_FULL = 4  # 34b's (of 64)
OPT_FULL_TOKENS = 8  # 34b's new tokens per generate (the prefill and 7 steps)
OPT_WHOLE_RUN_DEPTH = 8  # 34b's layers in the whole run, for its time limit; --paging runs 64
OPT_KERNELS = ("flash_decode", "flash_attend")
OPT_EP_DIR = Path(__file__).resolve().parent / ".opt_entry"
OPT_EP_DISK_GB = 24  # checkpoint 9.2 + dense archive 9.2, with room
OPT_EP_CONFIG = {  # facebook/opt-66b's config.json, cut to 4 layers, bf16
    "_remove_final_layer_norm": False, "activation_dropout": 0.0,
    "activation_function": "relu", "architectures": ["OPTForCausalLM"],
    "attention_dropout": 0.0, "bos_token_id": 2, "do_layer_norm_before": True,
    "dropout": 0.1, "eos_token_id": 2, "ffn_dim": 36864, "hidden_size": 9216,
    "init_std": 0.02, "layerdrop": 0.0, "max_position_embeddings": 2048,
    "model_type": "opt", "num_attention_heads": 72, "num_hidden_layers": 4,
    "pad_token_id": 1, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 50272, "word_embed_proj_dim": 9216,
}
# a budget that leaves 2 of the 4 layers' slots: (B - top - B/10) // 2.04 GB
OPT_EP_BUDGET = int(6.5e9)
NLLB_DENSE_SLOTS = 16  # phase 37's dense slots, of NLLB-MoE-54B's 48 blocks
HF_SRC = 8  # phase 38's deadline-0 request: one source of 8 tokens, 4 new ones
HF_NEW = 4
WHOLE_RUN_HF_NEW = 2  # the deadline-0 legs' new tokens in the whole run, for its time limit
HF_DQ_SLOTS = 160  # phase 38's dequant-on-write arena (bf16 slots of 67.1 MB)


def _host_free_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def _pinned_copy(tree):
    """A page-locked host copy of a tree of card tensors."""
    from moe_infinity_tpu_torch.runtime.dense_arena import tree_map

    return tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t), tree)


def _opt_prompts(vocab, B, seed, lens=None):
    """B prompts of OPT_PROMPT tokens from a seed; with ``lens``, row i keeps
    its last lens[i] tokens and is left-padded with OPT's pad id 1 (the
    Generator takes rows of one length; OPT, as in JAX, masks no pad)."""
    ids = np.random.default_rng(seed).integers(3, vocab, (B, OPT_PROMPT))
    for i, n in enumerate(lens or ()):
        ids[i, :OPT_PROMPT - n] = 1
    return ids


def _opt_prefill_logits(stepper, ids):
    model = stepper.model
    B, T = ids.shape
    kv = stepper.init_cache(B, 64)
    tok = torch.as_tensor(ids, dtype=torch.int32, device=model.device)
    pos = torch.arange(T, dtype=torch.int32, device=model.device).expand(B, T)
    with torch.inference_mode():
        return stepper.forward(tok, pos, kv, 0)[0]


def _opt_generate(stepper, ids, n=NEW_TOKENS):
    from moe_infinity_tpu_torch.runtime.generate import Generator

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = Generator(stepper=stepper, max_seq_len=64).generate(ids, max_new_tokens=n,
                                                              pad_token_id=1)
    torch.cuda.synchronize()
    return res.sequences, time.perf_counter() - t0


def _opt_two_steps(stepper, ids, dev):
    """The prefill's logits over ``ids`` and those of one greedy decode step
    after it, in a 64-column cache."""
    B, T = ids.shape
    kv = stepper.init_cache(B, 64)
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    with torch.inference_mode():
        a = stepper.forward(tok, pos, kv, 0)[0]
        nxt = torch.argmax(a[:, -1], -1).to(torch.int32)[:, None]
        b = stepper.forward(nxt, torch.full((B, 1), T, dtype=torch.int32, device=dev),
                            kv, T)[0]
    return a, b


def _logits_verdict(what, got, want):
    """Bit-equal, or the largest difference (reported, then held to TOL)."""
    torch.cuda.synchronize()
    if torch.equal(got, want):
        say(f"[check] {what}: bit-equal")
        return 0.0
    return compare(what, got, want)


def phase_opt(dev, depth=None):
    """Phase 34: OPT-66B at its published width, bf16, weights from a seed.
    (a) depth 8, distinct layers, resident through ``ResidentStepper`` and
    then paged through ``PagedDenseEngine`` with 3 slots; (b) full depth, 64
    host layers aliasing the 8, paged with 4 slots, batch 1 and 8 (``depth``:
    fewer layers, the whole run's time limit)."""
    from moe_infinity_tpu_torch.models.opt import OPTModel, OPTSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.dense_arena import DenseLayerArena, PagedDenseEngine
    from moe_infinity_tpu_torch.runtime.generate import ResidentStepper

    say(f"[opt] host memory available at the start of phase 34: {_host_free_gb():.1f} GiB")
    total = {}

    def count(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    g = torch.Generator(device=dev)
    g.manual_seed(66)
    torch.cuda.reset_peak_memory_stats()
    spec8 = OPTSpec(**dict(OPT_66B, num_layers=OPT_DISTINCT))
    model8 = OPTModel(spec8, torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    params = model8.init_random(g)
    torch.cuda.synchronize()
    layer_gb = _tree_bytes(params["layers"][0]) / 1e9
    say(f"[opt] OPT-66B width (hidden 9216, FFN 36864, 72 heads of 128, vocab 50272), "
        f"{OPT_DISTINCT} distinct layers of {layer_gb:.3f} GB drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; embeddings {_tree_bytes(params['embed']) / 1e9:.3f} GB")
    ids = _opt_prompts(spec8.vocab_size, len(OPT_PROMPT_LENS), 34, OPT_PROMPT_LENS)
    # (a) resident, then paged
    resident = ResidentStepper(model8, params, {}, lambda experts, mli: experts)
    reset_launches()
    want_logits = _opt_prefill_logits(resident, ids)
    want, wall = _opt_generate(resident, ids)
    c = launch_counts()
    count(c)
    _require_launched(c, OPT_KERNELS, "OPT-66B depth 8 resident")
    say(f"[opt] depth 8 resident: {len(ids)} requests x {NEW_TOKENS} tokens in {wall:.3f} s "
        f"({len(ids) * NEW_TOKENS / wall:.1f} tokens/s); launches {json.dumps(c)}; first row "
        f"{want[0, OPT_PROMPT:].tolist()}")
    t0 = time.perf_counter()
    host = _pinned_copy(params["layers"])
    torch.cuda.synchronize()
    t_pin = time.perf_counter() - t0
    top = {k: v for k, v in params.items() if k != "layers"}
    del params, resident
    torch.cuda.empty_cache()
    say(f"[opt] the {OPT_DISTINCT} layers copied to page-locked host memory "
        f"({OPT_DISTINCT * layer_gb:.1f} GB) in {t_pin:.1f} s; card copies freed")
    arena = DenseLayerArena(host, OPT_SLOTS, device=dev, num_threads=2)
    try:
        engine = PagedDenseEngine(model8, dict(top, layers=[None] * OPT_DISTINCT), arena)
        reset_launches()
        got_logits = _opt_prefill_logits(engine, ids)
        got, wall = _opt_generate(engine, ids)
        c = launch_counts()
        count(c)
        _require_launched(c, OPT_KERNELS, "OPT-66B depth 8 paged")
        st, cs = arena.stats(), arena.copy_stats()
    finally:
        arena.shutdown()
    say(f"[opt] depth 8 paged ({OPT_SLOTS} slots): {wall:.3f} s; dense stats {json.dumps(st)}; "
        f"copies {json.dumps(cs)}; launches {json.dumps(c)}")
    _logits_verdict("OPT-66B depth 8: the prefill's logits paged vs resident", got_logits,
                    want_logits)
    same = np.array_equal(got, want)
    say(f"[check] OPT-66B depth 8 paged vs resident greedy tokens: {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("OPT-66B paged tokens differ from the resident run's")
    if st["dense_misses"] <= 0:
        raise AssertionError("OPT-66B depth 8 paged: no dense miss")
    # (b) the full depth (or ``depth``), paged
    spec64 = OPTSpec(**dict(OPT_66B, num_layers=depth or OPT_66B["num_layers"]))
    n = spec64.num_layers
    model64 = OPTModel(spec64, torch.bfloat16, device=dev)
    host64 = [host[i % OPT_DISTINCT] for i in range(spec64.num_layers)]
    arena = DenseLayerArena(host64, OPT_SLOTS_FULL, device=dev, num_threads=2)
    say(f"[opt] depth {n}: {n} host layers alias the {OPT_DISTINCT} drawn ones (host memory "
        f"{arena.host_bytes / 1e9:.1f} GB; every step copies all {n} layers, "
        f"{sum(arena.layer_bytes) / 1e9:.1f} GB); {arena.num_slots} slots, ahead "
        f"{arena.ahead}; pinning at arena build {arena.pin_seconds:.2f} s (already pinned)")
    try:
        engine = PagedDenseEngine(model64, dict(top, layers=[None] * spec64.num_layers), arena)
        for B in (1, 8):
            ids = _opt_prompts(spec64.vocab_size, B, 340 + B)
            torch.cuda.reset_peak_memory_stats()
            s0, c0 = arena.stats(), arena.copy_stats()
            reset_launches()
            seqs, wall = _opt_generate(engine, ids, OPT_FULL_TOKENS)
            c = launch_counts()
            count(c)
            _require_launched(c, OPT_KERNELS, f"OPT-66B depth {n} paged batch {B}")
            s1, c1 = arena.stats(), arena.copy_stats()
            steps = OPT_FULL_TOKENS  # the prefill and the one-token steps
            hits, misses = (s1["dense_hits"] - s0["dense_hits"],
                            s1["dense_misses"] - s0["dense_misses"])
            gb = (c1["bytes_landed"] - c0["bytes_landed"]) / steps / 1e9
            landed = c1["landings"] - c0["landings"]
            say(f"[opt-{n}] batch {B}: {steps} tokens in {wall:.3f} s: "
                f"{B * steps / wall:.4f} tokens/s, {wall / steps:.4f} s per token "
                f"(per step); {landed} landings, {gb:.2f} GB copied per step "
                f"({gb / (wall / steps):.1f} GB/s); "
                f"dense hit rate {hits / max(1, hits + misses):.4f} ({hits} hits, {misses} "
                f"misses); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
                f"launches {json.dumps(c)}")
            # a hit counts a landing once its copies are queued (the JAX
            # arena counts a dispatched write so): the ring pages every layer
            # a step, so landings, not misses, show the paging
            if (seqs.shape != (B, OPT_PROMPT + steps)
                    or landed < steps * (spec64.num_layers - arena.num_slots)):
                raise AssertionError(f"OPT-66B depth {n} batch {B}: shape {seqs.shape}, "
                                     f"{landed} landings")
        if arena.stats()["dense_misses"] <= 0:
            raise AssertionError(f"OPT-66B depth {n}: no dense miss")
        # the device's busy share over one step (a prefill and one step)
        ids = _opt_prompts(spec64.vocab_size, 1, 341)
        prof = _profile_streams(f"OPT-66B depth {n} paged, batch 1, a prefill and one step",
                                lambda: _opt_generate(engine, ids, 2), 1)
        if prof:
            say(f"[opt-{n}] compute busy share {prof['kernels_ms'] / prof['wall_ms']:.4f}, "
                f"copies {prof['copies_ms']:.1f} ms of {prof['wall_ms']:.1f} ms")
    finally:
        arena.shutdown()
    del host, host64, top, arena, engine
    torch.cuda.empty_cache()
    _free_host_cache()
    return total


def phase_opt_whole_path(dev):
    """Phase 35: OPT at full width and f32, 2 distinct layers in a stack of 4
    (so 2 slots evict): the prefill's and a decode step's logits through the
    kernels against the plain versions on the card, and paged against
    resident (logits and 8 greedy tokens)."""
    from moe_infinity_tpu_torch.models.opt import OPTModel, OPTSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.dense_arena import DenseLayerArena, PagedDenseEngine
    from moe_infinity_tpu_torch.runtime.generate import ResidentStepper

    spec = OPTSpec(**dict(OPT_66B, num_layers=4))
    g = torch.Generator(device=dev)
    g.manual_seed(35)
    model = OPTModel(spec, torch.float32, device=dev)
    params = model.init_random(g, num_distinct=2)
    ids = _opt_prompts(spec.vocab_size, 2, 35)
    resident = ResidentStepper(model, params, {}, lambda experts, mli: experts)

    def two_steps(stepper):
        return _opt_two_steps(stepper, ids, dev)

    reset_launches()
    k_pre, k_dec = two_steps(resident)
    c = launch_counts()
    _require_launched(c, OPT_KERNELS, "OPT f32 whole path")
    with _plain_kernels():
        p_pre, p_dec = two_steps(resident)
    compare("OPT f32 (full width, 4 layers) prefill logits, kernels vs plain", k_pre, p_pre)
    compare("OPT f32 decode-step logits, kernels vs plain", k_dec, p_dec)
    want, _ = _opt_generate(resident, ids, 8)
    host = _pinned_copy(params["layers"][:2])
    arena = DenseLayerArena([host[i % 2] for i in range(4)], 2, device=dev, num_threads=2)
    try:
        engine = PagedDenseEngine(model, dict(params, layers=[None] * 4), arena)
        g_pre, g_dec = two_steps(engine)
        got, _ = _opt_generate(engine, ids, 8)
        st, landings = arena.stats(), arena.copy_stats()["landings"]
    finally:
        arena.shutdown()
    _logits_verdict("OPT f32 prefill logits, paged vs resident", g_pre, k_pre)
    _logits_verdict("OPT f32 decode-step logits, paged vs resident", g_dec, k_dec)
    same = np.array_equal(got, want)
    say(f"[check] OPT f32 paged vs resident tokens: {'equal' if same else 'DIFFER'}; "
        f"dense stats {json.dumps(st)}, {landings} landings")
    # 2 slots for 4 layers: every pass through the stack lands again
    if not same or landings <= 2 * 4:
        raise AssertionError("OPT f32 whole path: tokens differ, or no eviction")
    del params, resident, host, engine
    torch.cuda.empty_cache()
    _free_host_cache()


def _write_opt_checkpoint(root, dev, seed=0, config=None):
    """``config``'s (default OPT_EP_CONFIG's) checkpoint under HF's tensor
    names, bf16, matrices normal with std 0.02 made on the card from
    ``seed``, biases zero, norms one, the LM head tied (not written): a
    shard per layer and one for the embeddings and final norm, with the
    index. Returns its bytes."""
    c = config or OPT_EP_CONFIG
    D, F, V = c["hidden_size"], c["ffn_dim"], c["vocab_size"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mat(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.bfloat16, device=dev)

    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(c, indent=2))
    L = c["num_hidden_layers"]
    weight_map, total = {}, 0
    for shard in range(L + 1):
        fname = f"model-{shard + 1:05d}-of-{L + 1:05d}.safetensors"
        if shard < L:
            p = f"model.decoder.layers.{shard}."
            tensors = []
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                tensors += [(f"{p}self_attn.{proj}.weight", mat(D, D)),
                            (f"{p}self_attn.{proj}.bias", full(D, 0.0))]
            tensors += [(p + "self_attn_layer_norm.weight", full(D, 1.0)),
                        (p + "self_attn_layer_norm.bias", full(D, 0.0)),
                        (p + "fc1.weight", mat(F, D)), (p + "fc1.bias", full(F, 0.0)),
                        (p + "fc2.weight", mat(D, F)), (p + "fc2.bias", full(D, 0.0)),
                        (p + "final_layer_norm.weight", full(D, 1.0)),
                        (p + "final_layer_norm.bias", full(D, 0.0))]
        else:
            tensors = [("model.decoder.embed_tokens.weight", mat(V, D)),
                       ("model.decoder.embed_positions.weight",
                        mat(c["max_position_embeddings"] + 2, D)),
                       ("model.decoder.final_layer_norm.weight", full(D, 1.0)),
                       ("model.decoder.final_layer_norm.bias", full(D, 0.0))]
        total += _write_safetensors(root / fname, tensors)
        weight_map.update({name: fname for name, _ in tensors})
        del tensors
    (root / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return total


def phase_opt_entry(dev):
    """Phase 36: ``MoE`` from a checkpoint of OPT-66B's config.json cut to 4
    layers: resident (the default budget), then at a ``device_memory_bytes``
    that leaves 2 dense slots, where ``dense_paging="auto"`` pages; 2
    requests, tokens equal. The checkpoint and store are deleted at the end."""
    import shutil

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    OPT_EP_DIR.mkdir(exist_ok=True)
    free = shutil.disk_usage(OPT_EP_DIR).free
    say(f"[opt-entry] disk free under {OPT_EP_DIR.name}/: {free / 1e9:.1f} GB "
        f"(needs {OPT_EP_DISK_GB})")
    if free < OPT_EP_DISK_GB * 1e9:
        raise RuntimeError(f"phase 36 needs {OPT_EP_DISK_GB} GB of disk under {OPT_EP_DIR}, "
                           f"{free / 1e9:.1f} GB is free")
    total = {}
    try:
        ckpt, store = OPT_EP_DIR / "ckpt", OPT_EP_DIR / "store"
        t0 = time.perf_counter()
        nbytes = _write_opt_checkpoint(ckpt, dev)
        say(f"[opt-entry] checkpoint: OPT-66B's config at {OPT_EP_CONFIG['num_hidden_layers']} "
            f"layers, {nbytes / 1e9:.2f} GB of bf16 safetensors, written in "
            f"{time.perf_counter() - t0:.1f} s")
        prompts = _opt_prompts(OPT_EP_CONFIG["vocab_size"], 2, 36)
        out = {}
        for tag, extra in (("resident", {}),
                           ("paged", {"device_memory_bytes": OPT_EP_BUDGET})):
            cfg = dict(offload_path=str(store), max_seq_len=64, **extra)
            m = _ep_build(f"OPT {tag}", ckpt, cfg, dev)
            try:
                paged = m.dense_arena is not None
                say(f"[opt-entry] {tag}: dense paging {'on' if paged else 'off'}"
                    + (f", {m.dense_arena.num_slots} slots of {m.dense_arena.L} layers"
                       if paged else ""))
                if paged != (tag == "paged") or (paged and m.dense_arena.num_slots != 2):
                    raise AssertionError(f"OPT {tag}: unexpected plan")
                reset_launches()
                t0 = time.perf_counter()
                out[tag] = m.generate(prompts, max_new_tokens=NEW_TOKENS, eos_token_id=None)
                torch.cuda.synchronize()
                c = launch_counts()
                for k, v in c.items():
                    total[k] = total.get(k, 0) + v
                _require_launched(c, OPT_KERNELS, f"OPT facade ({tag})")
                say(f"[opt-entry] {tag}: 2 requests x {NEW_TOKENS} tokens in "
                    f"{time.perf_counter() - t0:.2f} s; stats {json.dumps(m.stats())}; "
                    f"launches {json.dumps(c)}")
            finally:
                m.shutdown()
                del m
                torch.cuda.empty_cache()
                _free_host_cache()
        same = np.array_equal(out["paged"], out["resident"])
        say(f"[check] OPT facade paged vs resident tokens: {'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("OPT facade: paged tokens differ from the resident facade's")
    finally:
        shutil.rmtree(OPT_EP_DIR, ignore_errors=True)
    return total


# ---- phase 45: OPT-2.7B (head dim 80) ------------------------------------------

OPT_2_7B = dict(vocab_size=50272, hidden_size=2560, ffn_dim=10240, num_layers=32,
                num_heads=32, max_positions=2048)  # facebook/opt-2.7b: head dim 80
OPT27_CONFIG = {  # facebook/opt-2.7b's config.json, cut to 2 layers
    "_name_or_path": "facebook/opt-2.7b", "activation_dropout": 0.0,
    "activation_function": "relu", "architectures": ["OPTForCausalLM"],
    "attention_dropout": 0.0, "bos_token_id": 2, "do_layer_norm_before": True,
    "dropout": 0.1, "eos_token_id": 2, "ffn_dim": 10240, "hidden_size": 2560,
    "init_std": 0.02, "layerdrop": 0.0, "max_position_embeddings": 2048,
    "model_type": "opt", "num_attention_heads": 32, "num_hidden_layers": 2,
    "pad_token_id": 1, "prefix": "</s>", "torch_dtype": "float16", "use_cache": True,
    "vocab_size": 50272, "word_embed_proj_dim": 2560,
}
OPT27_KERNELS = ("flash_decode_pad128", "flash_attend_pad128")
OPT27_REQUESTS, OPT27_TOKENS = 4, 8
# f32 logits through the kernels against the einsum oracle, all 32 layers:
# rtol = atol (set before the first run; phase 35 read 1.5e-5 at 4 layers)
OPT27_TOL = 1e-3
OPT27_EP_DIR = Path(__file__).resolve().parent / ".opt27_entry"
OPT27_EP_DISK_GB = 3  # checkpoint 0.6 + f32 dense archive 1.2, with room


def phase_opt27(dev):
    """Phase 45: OPT-2.7B at its published width and full depth through the
    padded instances of K1 and K2 (head dim 80). (a) bf16 weights from a
    seed, resident through ``ResidentStepper`` and ``Generator``: 4 requests
    x 8 greedy tokens after a warm-up generate, tokens/s and ms a step;
    then at f32 (no TF32) the prefill's and a decode step's logits and the
    greedy tokens through the kernels against the same model under the
    einsum oracle (``set_attention_impl("naive")``): tokens equal, logits
    within OPT27_TOL. (b) ``MoE`` from a checkpoint of OPT-2.7B's
    config.json cut to 2 layers (bf16 safetensors from a seed, ingested at
    f32, deleted at the end): its greedy tokens equal a direct ``Generator``
    over the same archive's params at f32. Returns the launches."""
    import shutil

    from moe_infinity_tpu_torch.models import layers as tl
    from moe_infinity_tpu_torch.models.opt import OPTModel, OPTSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import ResidentStepper
    from moe_infinity_tpu_torch.store.blob import DenseArchive
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    total = {}

    def count(what):
        c = launch_counts()
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        _require_launched(c, OPT27_KERNELS, what)
        if c["flash_decode"] or c["flash_attend"]:
            raise AssertionError(f"{what}: head dim 80 reached the head-dim-128 instances {c}")
        return {k: v for k, v in c.items() if v}

    spec = OPTSpec(**OPT_2_7B)
    ids = _opt_prompts(spec.vocab_size, OPT27_REQUESTS, 45)
    # (a) bf16, resident
    g = torch.Generator(device=dev)
    g.manual_seed(45)
    torch.cuda.reset_peak_memory_stats()
    model = OPTModel(spec, torch.bfloat16, device=dev)
    params = model.init_random(g)
    torch.cuda.synchronize()
    say(f"[opt27] OPT-2.7B (hidden 2560, FFN 10240, 32 layers, 32 heads of {spec.head_dim}, "
        f"vocab 50272): {_tree_bytes(params) / 1e9:.2f} GB of bf16 weights drawn on the card")
    stepper = ResidentStepper(model, params, {}, lambda experts, mli: experts)
    reset_launches()
    warm, _ = _opt_generate(stepper, ids, OPT27_TOKENS)
    seqs, wall = _opt_generate(stepper, ids, OPT27_TOKENS)
    c = count("OPT-2.7B bf16 resident")
    same = np.array_equal(seqs, warm)
    say(f"[opt27] bf16 resident: {OPT27_REQUESTS} requests x {OPT27_TOKENS} tokens in "
        f"{wall:.4f} s: {OPT27_REQUESTS * OPT27_TOKENS / wall:.2f} tokens/s, "
        f"{wall / OPT27_TOKENS * 1e3:.3f} ms a step (the prefill and {OPT27_TOKENS - 1} "
        f"steps); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches of "
        f"both generates {json.dumps(c)}; tokens equal to the warm-up's: {same}; first row "
        f"{seqs[0, OPT_PROMPT:].tolist()}")
    if not same or seqs.shape != (OPT27_REQUESTS, OPT_PROMPT + OPT27_TOKENS):
        raise AssertionError("OPT-2.7B bf16: tokens differ between two generates, or shape")
    del params, stepper, model
    torch.cuda.empty_cache()
    # (a) f32 through the kernels against the einsum oracle
    g.manual_seed(45)
    model = OPTModel(spec, torch.float32, device=dev)
    params = model.init_random(g)
    stepper = ResidentStepper(model, params, {}, lambda experts, mli: experts)
    reset_launches()
    k_pre, k_dec = _opt_two_steps(stepper, ids, dev)
    k_seqs, k_wall = _opt_generate(stepper, ids, OPT27_TOKENS)
    count("OPT-2.7B f32 through the kernels")
    prev = tl.get_attention_impl()
    tl.set_attention_impl("naive")
    try:
        reset_launches()
        n_pre, n_dec = _opt_two_steps(stepper, ids, dev)
        n_seqs, n_wall = _opt_generate(stepper, ids, OPT27_TOKENS)
        if any(launch_counts().values()):
            raise AssertionError("OPT-2.7B under the einsum oracle launched a kernel")
    finally:
        tl.set_attention_impl(prev)
    compare("OPT-2.7B f32 (32 layers) prefill logits, kernels vs einsum oracle", k_pre, n_pre,
            OPT27_TOL)
    compare("OPT-2.7B f32 decode-step logits, kernels vs einsum oracle", k_dec, n_dec,
            OPT27_TOL)
    same = np.array_equal(k_seqs, n_seqs)
    say(f"[check] OPT-2.7B f32 greedy tokens, kernels vs einsum oracle: "
        f"{'equal' if same else 'DIFFER'} ({OPT27_REQUESTS} x {OPT27_TOKENS}; {k_wall:.3f} s "
        f"vs {n_wall:.3f} s)")
    if not same:
        raise AssertionError("OPT-2.7B f32: kernel tokens differ from the einsum oracle's")
    del params, stepper, model
    torch.cuda.empty_cache()
    # (b) the facade from a checkpoint of the published config cut to 2 layers
    OPT27_EP_DIR.mkdir(exist_ok=True)
    _check_disk(OPT27_EP_DIR, OPT27_EP_DISK_GB, 45, "opt27-entry")
    try:
        ckpt, store = OPT27_EP_DIR / "ckpt", OPT27_EP_DIR / "store"
        nbytes = _write_opt_checkpoint(ckpt, dev, seed=46, config=OPT27_CONFIG)
        m = _ep_build("OPT-2.7B f32", ckpt, dict(offload_path=str(store), max_seq_len=64,
                                                 expert_dtype="float32"), dev)
        try:
            reset_launches()
            got = m.generate(ids, max_new_tokens=OPT27_TOKENS, eos_token_id=None)
            c = count("OPT-2.7B facade")
        finally:
            m.shutdown()
            del m
        direct_model = OPTModel(OPTSpec.from_hf(read_hf_config(str(ckpt))), torch.float32,
                                device=dev)
        direct = ResidentStepper(direct_model, direct_model.load_params(DenseArchive(str(store))),
                                 {}, lambda experts, mli: experts)
        reset_launches()
        want, _ = _opt_generate(direct, ids, OPT27_TOKENS)
        count("OPT-2.7B direct Generator")
        same = np.array_equal(got, want)
        say(f"[check] OPT-2.7B facade (2 layers, {nbytes / 1e9:.2f} GB checkpoint, f32) vs a "
            f"direct Generator over its archive: {'equal' if same else 'DIFFER'}; facade "
            f"launches {json.dumps(c)}")
        if not same:
            raise AssertionError("OPT-2.7B facade tokens differ from the direct Generator's")
        del direct, direct_model
    finally:
        shutil.rmtree(OPT27_EP_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    return total


class _TierStore:
    """The build's store as a deployment has it: records the tier stages are
    the tier's (a tier is a copy of its store), the rest the store's. The
    host fallback reads records through it."""

    def __init__(self, store, tier):
        self._store, self._tier = store, tier

    def __getattr__(self, name):
        return getattr(self._store, name)

    def get_expert(self, layer, expert, *, prio=0, gen=0):
        row = self._tier.record_index(layer, expert)
        if row is None:
            return self._store.get_expert(layer, expert, prio=prio, gen=gen)
        seg, local = self._tier.segment_for(row)
        return {f.name: seg[f.name][local].numpy() for f in self._store.fields}


class _GatedStore(_TierStore):
    """A store whose fetch workers wait on ``gate`` (the main thread, where
    the host executor reads, passes): with the gate shut nothing lands, so
    every routed expert runs on the host."""

    def __init__(self, store, tier=None):
        super().__init__(store, tier)
        import threading

        self.gate = threading.Event()

    def get_expert(self, layer, expert, *, prio=0, gen=0):
        import threading

        if threading.current_thread() is not threading.main_thread():
            self.gate.wait(timeout=600.0)
        if self._tier is None:
            return self._store.get_expert(layer, expert, prio=prio, gen=gen)
        return super().get_expert(layer, expert, prio=prio, gen=gen)


def _paged_offload_build(dev):
    """Phase 9's build for phases 37 and 38, the store read through the tier
    where it stages a record, and the reference: phase 9's tokens (its
    per-layer engine, no paging and no fallback, on phase 3's 4 requests x
    16 tokens), from phase 9 when it ran in this process, else from a run
    of its engine on this build."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    _free_host_cache()
    say(f"[paged] host memory available at the start of phase 37: {_host_free_gb():.1f} GiB")
    b = _offload_build(dev)
    b.tstore = _TierStore(b.store, b.tier)
    b.ids1, b.mask1 = b.ids[:1, :HF_SRC].copy(), np.ones((1, HF_SRC), np.float32)
    b.ids1[0, -1] = 2  # phase 38's deadline-0 request
    b.want, b.ref_counts = PHASE9_TOKENS.get("sequences"), {}
    if b.want is not None:
        say(f"[paged] the reference: phase 9's tokens; first row {b.want[0].tolist()}")
        return b
    engine = _offload_engine(b.model, b.params, b.tstore, b.slots, b.tier)
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = engine.generate(b.ids, max_new_tokens=NEW_TOKENS, attention_mask=b.mask,
                              eos_token_id=None)
        torch.cuda.synchronize()
        b.ref_counts = launch_counts()
        b.want = res.sequences
        say(f"[paged] the reference, phase 9's per-layer engine (no paging, no fallback): "
            f"{time.perf_counter() - t0:.1f} s, tokens/s "
            f"{len(SRC_LENS) * NEW_TOKENS / (res.stats['decode_ms'] / 1e3):.2f}; first row "
            f"{b.want[0].tolist()}")
    finally:
        engine.arena.shutdown()
    return b


def phase_nllb_paged(dev, b):
    """Phase 37: NLLB-MoE-54B at full width and depth with its 48 dense
    blocks paged through 16 slots and the experts offloaded (phase 9's
    engine with a ``DenseLayerArena``): tokens equal to phase 9's run."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.dense_arena import DenseLayerArena

    t0 = time.perf_counter()
    blocks = _pinned_copy(list(b.params["enc_blocks"]) + list(b.params["dec_blocks"]))
    torch.cuda.synchronize()
    t_pin = time.perf_counter() - t0
    top = {k: v for k, v in b.params.items() if k not in ("enc_blocks", "dec_blocks")}
    top["enc_blocks"], top["dec_blocks"] = [{}], [{}]  # NLLB's preludes read no block
    arena = DenseLayerArena(blocks, NLLB_DENSE_SLOTS, device=dev, num_threads=2)
    n_enc = b.spec.encoder_layers
    dec_gb = sum(arena.layer_bytes[n_enc:]) / 1e9
    say(f"[paged] {arena.L} blocks ({sum(arena.layer_bytes) / 1e9:.2f} GB, decoder "
        f"{dec_gb:.2f} GB) pinned in {t_pin:.1f} s; {arena.num_slots} slots in groups "
        f"{[n for n, _ in arena.group_slots]} of {[m for _, m in arena.group_slots]}"
        f" blocks; ahead {arena.ahead}")
    engine = _offload_engine(b.model, top, b.tstore, b.slots, b.tier, dense_arena=arena)
    _say_offload_setup("paged", b, engine.arena)
    try:
        reset_launches()
        c0 = arena.copy_stats()
        res = engine.generate(b.ids, max_new_tokens=NEW_TOKENS, attention_mask=b.mask,
                              eos_token_id=None)
        torch.cuda.synchronize()
        counts = launch_counts()
        c1, st = arena.copy_stats(), engine.stats()
        dms = res.stats["decode_ms"]
        # decode alone, driven step by step: encoder blocks that land while
        # the decoder runs are the wrapped window's (decode never reads them)
        tok = torch.as_tensor(b.ids, dtype=torch.int32, device=dev)
        m = torch.as_tensor(b.mask, device=dev)
        with torch.inference_mode():
            _, cross = engine.run_encoder(tok, m)
            l0 = arena.landings_by_layer()
            kvs = engine.init_cache(tok.shape[0], 32)
            cur = torch.full((tok.shape[0], 1), b.spec.decoder_start_token_id,
                             dtype=torch.int32, device=dev)
            for step in range(NEW_TOKENS):
                logits = engine.decode_step(cur, step, kvs, m, cross)
                cur = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            l1 = arena.landings_by_layer()
    finally:
        engine.arena.shutdown()
        arena.shutdown()
    n_enc = b.spec.encoder_layers
    lb = arena.layer_bytes
    enc = [(l1[i] - l0[i], (l1[i] - l0[i]) * lb[i]) for i in range(n_enc)]
    dec = [(l1[i] - l0[i], (l1[i] - l0[i]) * lb[i]) for i in range(n_enc, arena.L)]
    say(f"[paged] {NEW_TOKENS} decode steps alone: decoder blocks landed "
        f"{sum(n for n, _ in dec)} times ({sum(x for _, x in dec) / 1e9:.2f} GB, "
        f"{sum(x for _, x in dec) / NEW_TOKENS / 1e9:.3f} GB per step, for "
        f"{sum(lb[n_enc:]) / 1e9:.2f} GB of decoder blocks); encoder blocks landed "
        f"{sum(n for n, _ in enc)} times ({sum(x for _, x in enc) / 1e9:.2f} GB, "
        f"{sum(x for _, x in enc) / NEW_TOKENS / 1e9:.3f} GB per step): the wrapped window's "
        f"cost, never read")
    gb = (c1["bytes_landed"] - c0["bytes_landed"]) / 1e9
    unread = (c1["unread_bytes"] - c0["unread_bytes"]) / 1e9
    say(f"[paged] NLLB-MoE-54B paged + offload: decode {dms / NEW_TOKENS:.2f} ms per step, "
        f"{len(SRC_LENS) * NEW_TOKENS / (dms / 1e3):.2f} tokens/s; dense hit rate "
        f"{st['dense_hit_rate']:.4f} ({st['dense_hits']} hits, {st['dense_misses']} misses); "
        f"{gb:.2f} GB of dense blocks copied over the generate ({gb / NEW_TOKENS:.3f} GB per "
        f"step with the encode's); landings never read (the wrapped window's and the "
        f"window's evictions of nearer blocks): "
        f"{c1['unread_landings'] - c0['unread_landings']}, {unread:.2f} GB; expert hit rate "
        f"{st['hit_rate']:.4f}; launches {json.dumps(counts)}")
    same = np.array_equal(res.sequences, b.want)
    say(f"[check] NLLB paged + offload vs phase 9's per-layer run: tokens "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("NLLB paged tokens differ from phase 9's run")
    _require_launched(counts, NLLB_KERNELS, "NLLB paged + offload")
    if st["dense_misses"] <= 0:
        raise AssertionError("NLLB paged: no dense miss")
    del blocks, top, arena, engine
    torch.cuda.empty_cache()
    _free_host_cache()
    return counts


def _timed_host_fallback():
    """Wrap the host fallback's delta and the executor's FFN to measure them;
    returns (numbers, undo)."""
    from moe_infinity_tpu_torch.runtime import host_exec

    n = {"delta_s": 0.0, "deltas": 0, "ffn_s": 0.0, "ffns": 0}
    delta0, ffn0 = host_exec.host_moe_delta, host_exec.HostExpertExecutor.ffn

    def delta(*a, **k):
        t = time.perf_counter()
        out = delta0(*a, **k)
        n["delta_s"] += time.perf_counter() - t
        n["deltas"] += 1
        return out

    def ffn(self, *a, **k):
        t = time.perf_counter()
        out = ffn0(self, *a, **k)
        n["ffn_s"] += time.perf_counter() - t
        n["ffns"] += 1
        return out

    host_exec.host_moe_delta, host_exec.HostExpertExecutor.ffn = delta, ffn

    def undo():
        host_exec.host_moe_delta, host_exec.HostExpertExecutor.ffn = delta0, ffn0

    return n, undo


def phase_host_fallback(dev, b):
    """Phase 38: the host fallback on phase 9's build (an arena with its zero
    slot): at the default deadline (measured at phase 9's slots; tokens
    equal to phase 9's with every expert resident), at a
    deadline of 0 with prefetch off (measured), the same with
    ``dequant_on_write``; then the whole-path checks (NLLB at 2+2 blocks and
    Mixtral-8x7B at 2 layers, every expert on the host)."""
    import gc

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    total = {}

    def count(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    # the default deadline (0.25 s), prefetch on. At phase 9's slots a fetch
    # can miss it (35-36 experts a generate on one machine, none on others):
    # measured, with the host runs by MoE layer, and the tokens held to phase
    # 9's when no expert ran on the host in the timed run (bf16 tokens part
    # when one did: the combine weights move, see the whole-path check).
    # With a slot for every expert, all warmed, nothing misses: held always.
    every = [(l, e) for l in range(b.store.num_layers) for e in range(b.store.num_experts)]
    for label, slots in (("phase 9's slots", b.slots), ("a slot for every expert, warmed",
                                                        len(every))):
        engine = _offload_engine(b.model, b.params, b.tstore, slots, b.tier, host_fallback=True,
                                 arena_kw=dict(reserve_zero_slot=True))
        by_layer = {}

        def counted(layer, expert, x, _ffn=engine._host_exec.ffn):
            by_layer[layer] = by_layer.get(layer, 0) + 1
            return _ffn(layer, expert, x)

        engine._host_exec.ffn = counted
        try:
            if slots == len(every):
                engine.arena.warm(every)
                if not all(engine.arena.is_resident(k) for k in every):
                    raise AssertionError("host fallback: warming every expert left one out")
            else:
                engine.generate(b.ids, max_new_tokens=NEW_TOKENS, attention_mask=b.mask,
                                eos_token_id=None)
            warm = engine.host_exec_count
            reset_launches()
            res = engine.generate(b.ids, max_new_tokens=NEW_TOKENS, attention_mask=b.mask,
                                  eos_token_id=None)
            torch.cuda.synchronize()
            c = launch_counts()
            count(c)
        finally:
            engine.arena.shutdown()
        timed = engine.host_exec_count - warm
        same = np.array_equal(res.sequences, b.want)
        say(f"[host-fallback] deadline 0.25 s, {label} ({slots}): host_exec_count {warm} in the "
            f"warm-up, {timed} in the timed run; tokens/s "
            f"{len(SRC_LENS) * NEW_TOKENS / (res.stats['decode_ms'] / 1e3):.2f}; fetches "
            f"{json.dumps(engine.arena.fetch_stats())}; host runs by MoE layer (the first "
            f"{b.store.meta['num_encoder_moe_layers']} encode) {dict(sorted(by_layer.items()))}; "
            f"tokens {'equal' if same else 'DIFFER'} "
            f"to phase 9's run{'' if same or timed else ' with no expert on the host'}")
        if not same and (timed == 0 or slots == len(every)):
            raise AssertionError(f"host fallback at the default deadline, {label}: tokens "
                                 f"differ from phase 9's run")
        if slots == len(every) and timed:
            raise AssertionError("host fallback with every expert resident ran one on the host")
        del engine, res
        gc.collect()  # the engine's reference cycles hold its arena's slots
        torch.cuda.empty_cache()
    # deadline 0, prefetch off: every miss on the host
    for label, slots, akw in (("int4 slots", b.slots, {}),
                              ("dequant_on_write, bf16 slots", HF_DQ_SLOTS,
                               {"dequant_on_write": True})):
        engine = _offload_engine(b.model, b.params, b.tstore, slots, b.tier, host_fallback=True,
                                 host_fallback_timeout=0.0,
                                 arena_kw=dict(reserve_zero_slot=True, **akw))
        engine.prefetch = False
        n, undo = _timed_host_fallback()
        try:
            reset_launches()
            t0 = time.perf_counter()
            res = engine.generate(b.ids1, max_new_tokens=HF_NEW, attention_mask=b.mask1,
                                  eos_token_id=None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = launch_counts()
            count(c)
            direct = len(engine._direct_mlis)
        finally:
            undo()
            engine.arena.shutdown()
        say(f"[host-fallback] deadline 0, prefetch off, {label} ({slots} slots, {direct} "
            f"direct layers): 1 request of {HF_SRC} source tokens, {HF_NEW} tokens in "
            f"{wall:.2f} s (encode {res.stats['encode_ms']:.1f} ms, decode "
            f"{res.stats['decode_ms'] / HF_NEW:.1f} ms per step, "
            f"{HF_NEW / (res.stats['decode_ms'] / 1e3):.3f} tokens/s); host_exec_count "
            f"{engine.host_exec_count}; host ms per expert (2048 x 8192 int4 fc1 + fc2, "
            f"dequantized at f32) {1e3 * n['ffn_s'] / max(1, n['ffns']):.2f} over {n['ffns']}; "
            f"the host's deltas {1e3 * n['delta_s']:.1f} ms in all, "
            f"{1e3 * n['delta_s'] / (1 + HF_NEW):.1f} ms per step (encode included); "
            f"launches {json.dumps(c)}")
        if engine.host_exec_count <= 0 or (akw and direct):
            raise AssertionError(f"host fallback at deadline 0 ({label}): no expert ran on "
                                 f"the host, or a direct layer under dequant_on_write")
    count(_host_fallback_whole_path(dev))
    return total


class _RouterTape:
    """The routing of each router call of one run, in call order, with the
    gap between its 2nd and 3rd logits; with ``replay``, a recorded run's
    routing returned in place of the router's own, so that this run
    dispatches the same experts with the same combine weights."""

    def __init__(self, model, replay=None):
        from moe_infinity_tpu_torch.models.layers import linear

        self.model, self.calls = model, []
        self.name = "_route_top2" if hasattr(model, "_route_top2") else "route"
        inner = getattr(model, self.name)

        def hooked(pl, h, *a):
            out = inner(pl, h, *a)
            logits = linear(h.float(), pl["router"]).reshape(-1, pl["router"].shape[0])
            if pl.get("router_bias") is not None:
                logits = logits + pl["router_bias"]
            top3 = logits.topk(3, dim=-1).values
            n = logits.shape[0]
            self.calls.append((out[1].reshape(n, -1), out[0].reshape(n, -1).float(),
                               top3[:, 1] - top3[:, 2]))
            if replay is not None:
                out = replay.outs[len(self.outs)]
            self.outs.append(out)
            return out

        self.outs = []
        setattr(model, self.name, hooked)

    def close(self):
        delattr(self.model, self.name)


def _say_route_diff(what, want, got):
    """Report the first router call and row whose top-2 differ between two
    tapes, with that row's 2nd-to-3rd logit gap in ``want``'s run; or, where
    every row routes alike, the largest change of a combine weight."""
    cw_gap = 0.0
    for i, ((a, wa, gap), (b, wb, _)) in enumerate(zip(want.calls, got.calls)):
        sa, ia = a.sort(-1)
        sb, ib = b.sort(-1)
        rows = (sa != sb).any(-1).nonzero()
        if rows.numel():
            r = int(rows[0])
            say(f"[check] {what}: the routing first differs at router call {i} of "
                f"{len(want.calls)}, row {r} ({rows.numel()} rows differ there): top-2 "
                f"{a[r].tolist()} without fallback, {b[r].tolist()} with; the 2nd-to-3rd "
                f"logit gap there without fallback {gap[r].item():.3e} (smallest of the "
                f"call {gap.min().item():.3e})")
            return
        cw_gap = max(cw_gap, (wa.gather(1, ia) - wb.gather(1, ib)).abs().max().item())
    say(f"[check] {what}: the same top-2 in all {len(want.calls)} router calls; the "
        f"combine weights move by up to {cw_gap:.3e}")


def _fallback_pair(make_engine, store, first_step, model=None):
    """(without fallback, every expert on the host) results of
    ``first_step(engine)``; the second over a gated store. With ``model``,
    each run's router calls are taped, the first routing difference is
    reported, and a third result is appended: every expert on the host
    again, with the first run's routing replayed."""
    out, tapes = [], []
    runs = (False, True, True) if model is not None else (False, True)
    for i, gated in enumerate(runs):
        st = _GatedStore(store) if gated else store
        eng = make_engine(st, gated)
        if model is not None:
            tapes.append(_RouterTape(model, replay=tapes[0] if i == 2 else None))
        try:
            out.append(first_step(eng))
            torch.cuda.synchronize()
            if gated and eng.host_exec_count <= 0:
                raise AssertionError("the gated run ran no expert on the host")
            if gated:
                say(f"[host-fallback]   every expert on the host{' (routing replayed)' if i == 2 else ''}: "
                    f"host_exec_count {eng.host_exec_count}")
        finally:
            if model is not None:
                tapes[-1].close()
            if gated:
                st.gate.set()
            eng.arena.shutdown()
    if model is not None:
        _say_route_diff("every expert on the host vs none", tapes[0], tapes[1])
    return out


def _moe_layer_out(engine, seq2seq: bool, T=16, seed=383):
    """One MoE layer (MoE layer 0) through the engine's per-layer path on
    random hidden states of T tokens routed top-2 over distinct experts:
    the layer's expert output (the residual is zero)."""
    model = engine.model
    dev = model.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    D = getattr(model.spec, "d_model", None) or model.spec.hidden_size
    E = model.spec.num_experts
    h = torch.randn(1, T, D, generator=g, device=dev).to(model.dtype)
    ids = torch.stack([torch.randperm(E, generator=g, device=dev)[:2]
                       for _ in range(T)])[None].to(torch.int32)
    cw = torch.rand(1, T, 2, generator=g, device=dev)
    cw = cw / cw.sum(-1, keepdim=True)
    ids_np = ids.cpu().numpy()
    keys = [(0, int(e)) for e in np.unique(ids_np)]
    x0 = torch.zeros_like(h)
    with torch.inference_mode():
        if seq2seq:
            return engine._moe_dispatch(x0, h, cw, ids, ids_np, keys, 0)
        return engine._moe_apply(engine.params["layers"][0], x0, h, cw, ids, ids_np, keys, 0)


def _compare_scaled(name, got, want, tol=TOL) -> float:
    """The largest difference over the largest magnitude of ``want``, held to
    ``tol``: for outputs far from unit scale (the synthetic records' int
    codes times N(0, 0.02) scales), where an elementwise rtol/atol would read
    the rounding of near-zero elements against the scale of the rest."""
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs().max().item()
    m = want.float().abs().max().item()
    ok = bool(torch.isfinite(got.float()).all()) and d <= tol * m
    say(f"[check] {name}: max_abs_err={d:.3e} of max |want| {m:.3e}: {d / m:.3e} "
        f"(tol {tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside {tol} of the output's scale")
    return d


def _say_gap(name, got, want):
    """Report (not hold) a bf16 whole path's largest difference."""
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs().max().item()
    m = want.float().abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    say(f"[check] {name}: max_abs_err={d:.3e} of max |want| {m:.3e} (reported, bf16)")
    if not finite:
        raise AssertionError(f"{name}: not finite")


def _host_fallback_whole_path(dev):
    """Every expert on the host (fetch workers held back) against none: NLLB
    at full width and 2+2 blocks, the first step's logits within 1e-4 at
    f32 through the exact grouped FFN; Mixtral-8x7B at full width, 2 layers,
    int8, at f32 through the exact grouped FFN: the prefill's logits within
    1e-4 and greedy tokens equal. In bf16 through K3 (which rounds the down
    projection's input to bf16, where the host stays at f32): one MoE
    layer's output within the JAX suite's 2e-2 of its largest magnitude
    (``_compare_scaled``); the logits with each run's own routing reported,
    beside the first router row whose top-2 differ (or the combine weights'
    largest move); and, with the host run replaying the other run's routing
    (``_RouterTape``), the logits within 2e-2: NLLB's as rtol = atol,
    Mixtral's of their largest magnitude."""
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.engine import OffloadEngine
    from moe_infinity_tpu_torch.runtime.generate import Generator

    reset_launches()
    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=2, decoder_layers=2,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    E = spec.num_experts
    store = _offload_store(spec, seed=38, cache_records=2 * E)
    g = torch.Generator(device=dev)
    g.manual_seed(38)
    ids, mask = _requests(spec.vocab_size, g, dev)
    ids, mask = ids[:1, :8].copy(), np.ones((1, 8), np.float32)
    ids[:, -1] = 2
    for dtype, impl in ((torch.float32, "ragged"), (torch.bfloat16, "pallas")):
        g.manual_seed(380)
        model = NllbModel(spec, compute_dtype=dtype, device=dev)
        params, _ = model.init_random(g, with_experts=False)

        def make(st, gated):
            kw = dict(host_fallback=True, host_fallback_timeout=0.0) if gated else {}
            return _offload_engine(model, params, st, E, None, impl=impl, graphs=False,
                                   arena_kw=dict(reserve_zero_slot=gated), **kw)

        bf16 = dtype == torch.bfloat16
        res = _fallback_pair(make, store, lambda eng: (
            _offload_first_step(eng, ids, mask), _moe_layer_out(eng, True)),
            model=model if bf16 else None)
        (want, want_y), (got, got_y) = res[:2]
        what = f"NLLB ({dtype}, {impl}, full width, 2+2 blocks), every expert on the host vs none"
        if not bf16:
            compare(f"{what}: first-step logits", got, want, tol=1e-4)
        else:
            _compare_scaled(f"{what}: one MoE layer's output", got_y, want_y)
            _say_gap(f"{what}: first-step logits, own routing", got, want)
            compare(f"{what}: first-step logits, routing replayed", res[2][0], want)
        del model, params
    mspec = MixtralSpec(**dict(MIXTRAL_8X7B, num_layers=2))
    mstore = _mixtral_offload_store(mspec, distinct=True, seed=38)
    prompt = np.random.default_rng(38).integers(0, mspec.vocab_size, (1, 8))
    for dtype, impl in ((torch.float32, "ragged"), (torch.bfloat16, "pallas")):
        g.manual_seed(381)
        model = MixtralModel(mspec, compute_dtype=dtype, device=dev)
        params, _ = model.init_random(g, with_experts=False)

        def make(st, gated):
            kw = dict(host_fallback=True, host_fallback_timeout=0.0) if gated else {}
            arena = ExpertArena(st, mspec.num_experts, compute_dtype=dtype, device=dev,
                                num_threads=4, reserve_zero_slot=gated)
            return OffloadEngine(model, params, arena, prefetch=False, impl=impl,
                                 graphs=False, **kw)

        what = f"Mixtral-8x7B ({dtype}, {impl}, 2 layers, int8), every expert on the host vs none"
        if dtype == torch.float32:
            (want_l, want), (got_l, got) = _fallback_pair(make, mstore, lambda eng: (
                _opt_prefill_logits(eng, prompt),
                Generator(stepper=eng).generate(prompt, max_new_tokens=2).sequences))
            compare(f"{what}: prefill logits", got_l, want_l, tol=1e-4)
            same = np.array_equal(got, want)
            say(f"[check] {what}: greedy tokens {'equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError("Mixtral host fallback at f32: tokens differ")
        else:
            res = _fallback_pair(make, mstore, lambda eng: (
                _opt_prefill_logits(eng, prompt), _moe_layer_out(eng, False)), model=model)
            (want, want_y), (got, got_y) = res[:2]
            _compare_scaled(f"{what}: one MoE layer's output", got_y, want_y)
            _say_gap(f"{what}: prefill logits, own routing", got, want)
            # the synthetic int8 records make expert outputs of up to ~1e7,
            # so bf16's relative rounding of K3's activations is held
            # against the logits' scale, as for the layer's output
            _compare_scaled(f"{what}: prefill logits, routing replayed", res[2][0], want)
        del model, params
    torch.cuda.empty_cache()
    return launch_counts()


def phase_paged_offload(dev):
    """Phases 37 and 38 on one build."""
    def timed_(fn, *args):
        t0 = time.perf_counter()
        out = fn(dev, *args)
        say(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    b = timed_(_paged_offload_build)
    counts = {}
    for fn in (phase_nllb_paged, phase_host_fallback):
        for k, v in timed_(fn, b).items():
            counts[k] = counts.get(k, 0) + v
    for k, v in b.ref_counts.items():
        counts[k] = counts.get(k, 0) + v
    del b
    torch.cuda.empty_cache()
    _free_host_cache()
    return counts


# ---------------------------------------------------------------------------
# phases 39-40: the rest of loading (GPTQ and block-fp8 checkpoints, the
# native store's load modes)
# ---------------------------------------------------------------------------

LOAD_MODES = ("mmap", "ram", "direct", "sched")
# phase 39's requests per load mode in the whole run, for its time limit
# (phases 41-42 took their share); --loading answers all EP_REQUESTS
WHOLE_RUN_LOAD_REQUESTS = 1
LOAD_SAMPLES = 8  # expert records held byte for byte against a recomputation on the host
GQ_DIR = Path(__file__).resolve().parent / ".gptq_entry"
GQ_DISK_GB = 6  # checkpoint 2.0 + int4 store 1.4 + dense archive 0.7, with room
# EP_CONFIG (Mixtral-8x7B's config.json at 2 layers) quantized as AutoGPTQ's v1
# format writes it: 4 bits, groups of 128, asymmetric, no act-order
GQ_CONFIG = dict(EP_CONFIG, quantization_config={
    "bits": 4, "group_size": 128, "damp_percent": 0.01, "desc_act": False, "sym": False,
    "true_sequential": True, "quant_method": "gptq"})
DS_DIR = Path(__file__).resolve().parent / ".dsv3_entry"
DS_DISK_GB = 36  # checkpoint 15.8 + fp8 store 11.3 + dense archive 5.3, with room
DSV3_CONFIG = {  # deepseek-ai/DeepSeek-V3's config.json, cut in depth only (2 layers, the first dense)
    "architectures": ["DeepseekV3ForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "aux_loss_alpha": 0.001, "bos_token_id": 0,
    "eos_token_id": 1, "ep_size": 1, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 7168, "initializer_range": 0.02, "intermediate_size": 18432,
    "kv_lora_rank": 512, "max_position_embeddings": 163840, "model_type": "deepseek_v3",
    "moe_intermediate_size": 2048, "moe_layer_freq": 1, "n_group": 8,
    "n_routed_experts": 256, "n_shared_experts": 1, "norm_topk_prob": True,
    "num_attention_heads": 128, "num_experts_per_tok": 8, "num_hidden_layers": 2,
    "num_key_value_heads": 128, "num_nextn_predict_layers": 1, "pretraining_tp": 1,
    "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "quantization_config": {"activation_scheme": "dynamic", "fmt": "e4m3",
                            "quant_method": "fp8", "weight_block_size": [128, 128]},
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0,
                     "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 4, "topk_method": "noaux_tc",
    "torch_dtype": "bfloat16", "transformers_version": "4.33.1", "use_cache": True,
    "v_head_dim": 128, "vocab_size": 129280,
}
DS_REQUESTS, DS_PROMPT, DS_NEW = 4, 16, 16
# phase 40's facades in the whole run, for its time limit (its ingest, some
# 45 s of the host's, stays whole); --loading answers 4 requests of 16
WHOLE_RUN_DS_REQUESTS, WHOLE_RUN_DS_NEW = 2, 8
DS_OFF_BUDGET = 160  # experts the offload plan's budget holds, of 256
DS_EXPERT_SHARD = 32  # routed experts per safetensors shard
DS_KERNELS = ("mla_flash_decode", "gmm_fp8")


def _check_disk(dirpath, need_gb, phase, tag):
    import shutil

    free = shutil.disk_usage(dirpath).free
    say(f"[{tag}] disk free under {dirpath.name}/: {free / 1e9:.1f} GB (needs {need_gb})")
    if free < need_gb * 1e9:
        raise RuntimeError(f"phase {phase} needs {need_gb} GB of disk under {dirpath}, "
                           f"{free / 1e9:.1f} GB is free")


def _write_shards(root, shards, config):
    """``shards``: an iterable of [(name, tensor)] lists, each written as one
    safetensors shard as it comes (the tensors freed after), then
    ``model.safetensors.index.json`` and ``config.json``. Returns the bytes."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(config, indent=2))
    weight_map, total = {}, 0
    for k, tensors in enumerate(shards):
        fname = f"model-{k + 1:05d}.safetensors"
        total += _write_safetensors(root / fname, tensors)
        weight_map.update({name: fname for name, _ in tensors})
        del tensors
    (root / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return total


def _write_gptq_checkpoint(root, dev, seed=0):
    """GQ_CONFIG's checkpoint under HF's tensor names: weights normal with std
    0.02 made on the card from ``seed`` in bf16 (norms one); every attention
    projection and expert linear packed by the port's ``pack_gptq`` on the
    card (qweight, qzeros, scales, g_idx), the router, embeddings, head and
    norms bf16; a shard per layer and one for the rest. Returns its bytes."""
    from moe_infinity_tpu_torch.store.gptq import pack_gptq

    c = GQ_CONFIG
    D, F, E, V = c["hidden_size"], c["intermediate_size"], c["num_local_experts"], c["vocab_size"]
    hd = D // c["num_attention_heads"]
    kvd = c["num_key_value_heads"] * hd
    qc = c["quantization_config"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mat(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g)

    def packed(prefix, *shape):
        t = pack_gptq(mat(*shape), bits=qc["bits"], group_size=qc["group_size"])
        return [(f"{prefix}.{comp}", v) for comp, v in t.items()]

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    def shards():
        for layer in range(c["num_hidden_layers"]):
            p = f"model.layers.{layer}."
            t = [(p + "input_layernorm.weight", ones(D)),
                 (p + "post_attention_layernorm.weight", ones(D)),
                 (p + "block_sparse_moe.gate.weight", mat(E, D))]
            for name, shape in (("q_proj", (D, D)), ("k_proj", (kvd, D)), ("v_proj", (kvd, D)),
                                ("o_proj", (D, D))):
                t += packed(p + "self_attn." + name, *shape)
            for e in range(E):
                q = f"{p}block_sparse_moe.experts.{e}."
                t += packed(q + "w1", F, D) + packed(q + "w2", D, F) + packed(q + "w3", F, D)
            yield t
        yield [("model.embed_tokens.weight", mat(V, D)), ("model.norm.weight", ones(D)),
               ("lm_head.weight", mat(V, D))]

    return _write_shards(root, shards(), c)


def _write_dsv3_checkpoint(root, dev, seed=0):
    """DSV3_CONFIG's checkpoint in DeepSeek-V3's official layout: weights
    normal with std 0.02 made on the card from ``seed``; every attention
    projection, the dense MLP, the shared expert and every routed expert as
    e4m3 codes plus ``weight_scale_inv`` (blocks of 128 x 128, packed by the
    port's ``pack_fp8_block`` on the card; ``kv_a_proj_with_mqa``'s 576 rows
    end in a half block); the embeddings, head, norms and router bf16, the
    router's ``e_score_correction_bias`` f32 (uniform in [-0.1, 0.1)). A
    shard per layer's dense tensors, one per 32 routed experts and one for
    the rest. Returns its bytes."""
    from moe_infinity_tpu_torch.store.fp8_block import pack_fp8_block

    c = DSV3_CONFIG
    D, V, H = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    Fm, Fd, E = c["moe_intermediate_size"], c["intermediate_size"], c["n_routed_experts"]
    R, P, Dn, Dv, Q = (c["kv_lora_rank"], c["qk_rope_head_dim"], c["qk_nope_head_dim"],
                       c["v_head_dim"], c["q_lora_rank"])
    block = tuple(c["quantization_config"]["weight_block_size"])
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mat(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g)

    def fp8(name, *shape):
        q, s = pack_fp8_block(mat(*shape), block)
        return [(name + ".weight", q.view(torch.float8_e4m3fn)),
                (name + ".weight_scale_inv", s)]

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    def mlp(prefix, F):
        return (fp8(prefix + "gate_proj", F, D) + fp8(prefix + "up_proj", F, D)
                + fp8(prefix + "down_proj", D, F))

    def shards():
        for layer in range(c["num_hidden_layers"]):
            p = f"model.layers.{layer}."
            t = [(p + "input_layernorm.weight", ones(D)),
                 (p + "post_attention_layernorm.weight", ones(D)),
                 (p + "self_attn.q_a_layernorm.weight", ones(Q)),
                 (p + "self_attn.kv_a_layernorm.weight", ones(R))]
            t += (fp8(p + "self_attn.q_a_proj", Q, D) + fp8(p + "self_attn.q_b_proj", H * (Dn + P), Q)
                  + fp8(p + "self_attn.kv_a_proj_with_mqa", R + P, D)
                  + fp8(p + "self_attn.kv_b_proj", H * (Dn + Dv), R)
                  + fp8(p + "self_attn.o_proj", D, H * Dv))
            if layer < c["first_k_dense_replace"]:
                yield t + mlp(p + "mlp.", Fd)
                continue
            bias = torch.empty(E, dtype=torch.float32, device=dev).uniform_(-0.1, 0.1, generator=g)
            yield t + [(p + "mlp.gate.weight", mat(E, D)),
                       (p + "mlp.gate.e_score_correction_bias", bias)] + mlp(
                           p + "mlp.shared_experts.", Fm)
            for e0 in range(0, E, DS_EXPERT_SHARD):
                yield [kv for e in range(e0, min(E, e0 + DS_EXPERT_SHARD))
                       for kv in mlp(f"{p}mlp.experts.{e}.", Fm)]
        yield [("model.embed_tokens.weight", mat(V, D)), ("model.norm.weight", ones(D)),
               ("lm_head.weight", mat(V, D))]

    return _write_shards(root, shards(), c)


def _checkpoint_arrays(ckpt):
    """{name: (array, store dtype)} over every shard of ``ckpt``: read-only
    views of the memory-mapped files, read when touched."""
    from moe_infinity_tpu_torch.utils.checkpoints import get_checkpoint_paths, iter_safetensors

    return {name: (a, src) for path in get_checkpoint_paths(str(ckpt))[0]
            for name, a, src in iter_safetensors(path)}


def _check_sampled_records(tag, ckpt, store_dir, dequant, expert_dtype, seed):
    """``LOAD_SAMPLES`` expert records of the store, each byte for byte equal
    to its recomputation on the host from the checkpoint's own tensors:
    ``dequant(arrays, prefix)`` (the weight as f32 [out, in]) then
    ``quantize_rowwise``, transposed into compute layout, each field at its
    offset and the padding zero."""
    from moe_infinity_tpu_torch.store.blob import ExpertStore
    from moe_infinity_tpu_torch.store.quant import quantize_rowwise

    st = ExpertStore(str(store_dir))
    name_map = json.loads((Path(store_dir) / "name_map.json").read_text())
    by_record = {}
    for name, entry in name_map.items():
        if entry[0] == "expert":
            by_record.setdefault((entry[1], entry[2]), []).append((name, entry[3]))
    arrays = _checkpoint_arrays(ckpt)
    rng = np.random.default_rng(seed)
    keys = sorted(by_record)
    picks = [keys[i] for i in sorted(rng.choice(len(keys), LOAD_SAMPLES, replace=False))]
    offset = {f.name: f.offset for f in st.fields}
    for key in picks:
        want = np.zeros(st.stride, np.uint8)
        for name, tail in by_record[key]:
            q, scale = quantize_rowwise(dequant(arrays, name[: -len(".weight")]), expert_dtype)
            for field, a in ((tail, np.ascontiguousarray(q.T)), (tail + ".scale", scale)):
                raw = a.reshape(-1).view(np.uint8)
                want[offset[field]: offset[field] + raw.size] = raw
        _ep_check(f"{tag}: record (L{key[0]}, E{key[1]}) byte-equal to its recomputation from "
                  f"the checkpoint on the host", bytes(st.get_record(*key)) == want.tobytes())
    return picks


def _store_layer(store_dir, layer, experts, tails, dev):
    """gate, up and down weights ``[S, in, out]`` (as stored) and scales of
    ``experts`` of one store layer, on the card."""
    from moe_infinity_tpu_torch.store.blob import ExpertStore
    from moe_infinity_tpu_torch.utils.dtypes import to_tensor

    st = ExpertStore(str(store_dir))
    dt = {f.name: f.dtype for f in st.fields}
    recs = [st.get_expert(layer, e) for e in experts]
    w, sc = {}, {}
    for role, tail in zip(ROLES, tails):
        w[role] = to_tensor(np.stack([r[tail] for r in recs]), dt[tail]).to(dev)
        sc[role] = torch.from_numpy(np.stack([r[tail + ".scale"] for r in recs])).to(dev)
    return w, sc


def _time_store_layer(label, kind, x, w, sc, active, **kw):
    """K3 at one decode layer of a store built from a checkpoint (``_check_layer``),
    printed as a [time] line."""
    gsz = torch.ones(active, dtype=torch.int32, device=x.device) * (x.shape[0] // active)
    gid = torch.arange(active, dtype=torch.int32, device=x.device)
    r = _check_layer(label, x, w, sc, gsz, active, group_ids=gid, **kw)
    r.pop("a")
    D, F = x.shape[1], sc["gate"].shape[1]
    say(f"[time] {kind} {label} (gate + up + down, {x.shape[0]} rows over {active} experts, "
        f"D={D} F={F}): ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
        f"{r['bound_ms']:.5f} ({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e}; "
        f"{_layer_plans(x, w, gsz)}")
    return r


def _serve_offload(tag, m, prompts, kw):
    """Warm-up, then ``prompts`` one at a time through the offload facade
    ``m``: (tokens, launches, wall seconds, the summary line's fields)."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    store = m.engine.arena.store
    escalated = []
    plain_escalate = store.escalate
    store.escalate = lambda *key: (escalated.append(key), plain_escalate(*key))[1]
    m.generate(prompts[0], max_new_tokens=4, eos_token_id=None)  # warm-up (captures)
    torch.cuda.synchronize()
    reset_launches()
    s0 = m.stats()
    escalated.clear()
    t0 = time.perf_counter()
    got = [m.generate(q, **kw) for q in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = m.stats()
    n_tok = len(prompts) * (kw["max_new_tokens"] + 1)
    say(f"[{tag}] load_mode {store.load_mode} (is_direct {store.is_direct}): {len(prompts)} "
        f"requests one at a time in {wall:.3f} s: {len(prompts) * kw['max_new_tokens'] / wall:.2f} "
        f"tokens/s, s/token (wall over new tokens + 1) {wall / n_tok:.4f}; hit rate "
        f"{(st['hits'] - s0['hits']) / max(1, st['visits'] - s0['visits']):.4f}; fetches "
        f"{json.dumps(m.engine.arena.fetch_stats())}; escalated reads {len(escalated)}; "
        f"launches {json.dumps(counts)}")
    return got, counts


def phase_gptq_entry(dev, requests=EP_REQUESTS):
    """Phase 39: ``MoE`` from a GPTQ checkpoint of Mixtral-8x7B at its
    published width (GQ_CONFIG: 2 layers, 4 bits, groups of 128), written
    from a seed under ``.gptq_entry/`` (git-ignored; the free disk checked
    first, the directory deleted at the end, also on failure) and ingested
    to int4 experts; 8 sampled records byte-equal to ``dequant_gptq`` then
    ``quantize_rowwise`` on the host; K3's int4 kind at a decode layer of
    the store's records, timed; then the offload facade (phase 19's plan:
    10 of 16 experts, speculative blocks of 2, graphs) once per load mode
    of LOAD_MODES (``mmap`` first), each answering the first ``requests`` of
    phase 19's 8 requests with the same greedy tokens and launching K1, K2
    and K3. Returns the launches of the runs summed."""
    import shutil

    from moe_infinity_tpu_torch.entrypoints.api import _dense_bytes_estimate
    from moe_infinity_tpu_torch.store.blob import DenseArchive, ExpertStore
    from moe_infinity_tpu_torch.store.gptq import dequant_gptq
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    GQ_DIR.mkdir(exist_ok=True)
    try:
        _check_disk(GQ_DIR, GQ_DISK_GB, 39, "gptq")
        ckpt, store = GQ_DIR / "ckpt", GQ_DIR / "store"
        t0 = time.perf_counter()
        nbytes = _write_gptq_checkpoint(ckpt, dev)
        say(f"[gptq] checkpoint: Mixtral-8x7B's config at {GQ_CONFIG['num_hidden_layers']} "
            f"layers, GPTQ v1 4-bit groups of 128 (attention and experts packed on the card), "
            f"{nbytes / 1e9:.2f} GB in {len(list(ckpt.glob('*.safetensors')))} shards, written "
            f"in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ingest_checkpoint(str(ckpt), str(store), read_hf_config(str(ckpt)), expert_dtype="int4")
        say(f"[gptq] ingest (GPTQ -> int4): {time.perf_counter() - t0:.1f} s; experts.blob "
            f"{(store / 'experts.blob').stat().st_size / 1e9:.2f} GB, dense.blob "
            f"{(store / 'dense.blob').stat().st_size / 1e9:.2f} GB")
        qc = GQ_CONFIG["quantization_config"]

        def dequant(arrays, prefix):
            parts = {c: arrays[f"{prefix}.{c}"][0] for c in ("qweight", "qzeros", "scales", "g_idx")}
            return dequant_gptq(parts["qweight"], parts["qzeros"], parts["scales"], parts["g_idx"],
                                bits=qc["bits"], group_size=qc["group_size"])

        t0 = time.perf_counter()
        _check_sampled_records("gptq", ckpt, store, dequant, "int4", seed=39)
        say(f"[gptq] {LOAD_SAMPLES} sampled records checked in {time.perf_counter() - t0:.1f} s")

        # K3's int4 kind at the offload step's layer: 2 rows over 2 experts
        w, sc = _store_layer(store, 0, (0, 1), ("w1.weight", "w3.weight", "w2.weight"), dev)
        g = torch.Generator(device=dev)
        g.manual_seed(39)
        x = torch.randn(2, GQ_CONFIG["hidden_size"], generator=g, device=dev).to(torch.bfloat16)
        _time_store_layer("Mixtral-8x7B batch-1 decode layer from the GPTQ store", "gmm int4",
                          x, w, sc, 2, packed=True)
        del w, sc

        prompts = _ep_prompts()[:requests]
        kw = dict(max_new_tokens=EP_NEW, eos_token_id=None)
        stride = ExpertStore(str(store)).stride
        budget = _dense_bytes_estimate(DenseArchive(str(store)), 2) + EP_SLOTS * stride + stride // 2
        cfg = dict(EP_IMPL, expert_dtype="int4", offload_path=str(store), dense_paging="off",
                   device_memory_bytes=budget, speculative_decode=True, speculative_block=2,
                   max_batch_size=1)
        tokens, total = {}, {}
        for mode in LOAD_MODES:
            m = _ep_build(f"gptq offload ({mode})", ckpt, dict(cfg, load_mode=mode), dev)
            try:
                if m.engine is None or m.engine.arena.num_slots != EP_SLOTS:
                    raise AssertionError(f"gptq offload facade: expected {EP_SLOTS} slots")
                tokens[mode], counts = _serve_offload("gptq", m, prompts, kw)
                _require_launched(counts, MIXTRAL_KERNELS, f"GPTQ offload facade ({mode})")
                total = _sum_counts(total, counts)
            finally:
                m.shutdown()
            del m
            torch.cuda.empty_cache()
        say(f"[gptq] tokens (request 1, mmap): {tokens['mmap'][0][0, EP_PROMPT:].tolist()}")
        for mode in LOAD_MODES[1:]:
            _ep_check(f"gptq: every request's greedy tokens equal between load modes mmap and "
                      f"{mode}", all(np.array_equal(a, b)
                                     for a, b in zip(tokens["mmap"], tokens[mode])))
        return total
    finally:
        shutil.rmtree(GQ_DIR, ignore_errors=True)
        say(f"[gptq] deleted {GQ_DIR.name}/")


def phase_dsv3_entry(dev):
    """Phase 40: ``MoE`` from a block-fp8 checkpoint of DeepSeek-V3 at its
    published width (DSV3_CONFIG, cut to 2 layers, the first dense), written
    from a seed in the official layout under ``.dsv3_entry/`` (git-ignored;
    the free disk checked first, the directory deleted at the end, also on
    failure) and ingested to float8_e4m3fn experts; 8 sampled records
    byte-equal to ``dequant_fp8_block`` then ``quantize_rowwise`` on the
    host; K3's e4m3 kind at the batch-1 MoE layer of the store's records,
    timed; the resident facade (``Generator``) answering ``DS_REQUESTS``
    requests of 16 tokens with ``DS_NEW`` new each (4 of 16; 2 of 8 in the
    whole run), K5 (H = 128) held to 2 launches on every
    one-token step and K3 e4m3 to 3 on every MoE layer call; the first
    decode step's logits through the kernels against the plain versions (f32
    held at the bf16 tolerance, the bf16 facade reported); then the offload
    facade at a budget of 160 of the 256 experts (its arena takes the 256
    slots of the one MoE layer, the least the engine takes, so every fetch
    is a first touch), eagerly, under ``direct`` and under ``mmap``, tokens
    equal. Returns the launches of its runs."""
    import shutil

    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.store.blob import ExpertStore
    from moe_infinity_tpu_torch.store.fp8_block import dequant_fp8_block
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    DS_DIR.mkdir(exist_ok=True)
    try:
        _check_disk(DS_DIR, DS_DISK_GB, 40, "dsv3")
        ckpt, store = DS_DIR / "ckpt", DS_DIR / "store"
        t0 = time.perf_counter()
        nbytes = _write_dsv3_checkpoint(ckpt, dev)
        say(f"[dsv3] checkpoint: DeepSeek-V3's config at {DSV3_CONFIG['num_hidden_layers']} "
            f"layers, block-fp8 (e4m3 + weight_scale_inv, 128 x 128), {nbytes / 1e9:.2f} GB in "
            f"{len(list(ckpt.glob('*.safetensors')))} shards, written in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ingest_checkpoint(str(ckpt), str(store), read_hf_config(str(ckpt)),
                          expert_dtype="float8_e4m3fn")
        say(f"[dsv3] ingest (block-fp8 -> float8_e4m3fn): {time.perf_counter() - t0:.1f} s; "
            f"experts.blob {(store / 'experts.blob').stat().st_size / 1e9:.2f} GB, dense.blob "
            f"{(store / 'dense.blob').stat().st_size / 1e9:.2f} GB")
        block = tuple(DSV3_CONFIG["quantization_config"]["weight_block_size"])

        def dequant(arrays, prefix):
            return dequant_fp8_block(arrays[prefix + ".weight"][0],
                                     arrays[prefix + ".weight_scale_inv"][0], block)

        t0 = time.perf_counter()
        picks = _check_sampled_records("dsv3", ckpt, store, dequant, "float8_e4m3fn", seed=40)
        say(f"[dsv3] {LOAD_SAMPLES} sampled records checked in {time.perf_counter() - t0:.1f} s")
        for f in ckpt.glob("*.safetensors"):  # the facades read the store; free the disk
            f.unlink()

        # K3's e4m3 kind at the batch-1 MoE layer: one token's 8 rows over 8 experts
        layer = picks[0][0]
        tails = ("gate_proj.weight", "up_proj.weight", "down_proj.weight")
        w, sc = _store_layer(store, layer, [e for _, e in picks], tails, dev)
        w = {r: t.view(torch.float8_e4m3fn) for r, t in w.items()}
        g = torch.Generator(device=dev)
        g.manual_seed(40)
        x = torch.randn(LOAD_SAMPLES, DSV3_CONFIG["hidden_size"], generator=g,
                        device=dev).to(torch.bfloat16)
        _time_store_layer("DeepSeek-V3 batch-1 decode MoE layer from the block-fp8 store",
                          "gmm_fp8", x, w, sc, LOAD_SAMPLES)
        del w, sc
        torch.cuda.empty_cache()

        rng = np.random.default_rng(40)
        prompts = [rng.integers(3, DSV3_CONFIG["vocab_size"], (1, DS_PROMPT))
                   for _ in range(DS_REQUESTS)]
        kw = dict(max_new_tokens=DS_NEW, eos_token_id=None)
        base = {"expert_dtype": "float8_e4m3fn", "moe_impl": "pallas", "prefill_impl": "pallas",
                "offload_path": str(store), "max_batch_size": 1}
        torch.cuda.reset_peak_memory_stats()
        res = _ep_build("dsv3 resident", ckpt, base, dev)
        try:
            if res.engine is not None:
                raise AssertionError("the DeepSeek-V3 facade should be resident")
            res.generate(prompts[0], max_new_tokens=2, eos_token_id=None)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            want = [res.generate(p, **kw) for p in prompts]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            say(f"[dsv3] resident (Generator): {DS_REQUESTS} requests x {DS_NEW} tokens in "
                f"{wall:.3f} s: {DS_REQUESTS * DS_NEW / wall:.2f} tokens/s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {json.dumps(counts)}")
            say(f"[dsv3] resident tokens (request 1): {want[0][0, DS_PROMPT:].tolist()}")
            _require_launched(counts, DS_KERNELS, "DeepSeek-V3 resident facade")
            layers = DSV3_CONFIG["num_hidden_layers"]
            moe_layers = layers - DSV3_CONFIG["first_k_dense_replace"]
            need = {"mla_flash_decode": layers * (DS_NEW - 1) * DS_REQUESTS,
                    "gmm_fp8": 3 * moe_layers * DS_NEW * DS_REQUESTS}
            got = {k: counts.get(k, 0) for k in need}
            _ep_check(f"dsv3: K5 (H = 128) on every layer of every one-token step and K3 e4m3 "
                      f"on every MoE layer call: launches {got}, expected {need}", got == need)
            _ep_logits_check(res, store, prompts[0], dev, tag="dsv3")
            dense_bytes = _tree_bytes(res.params)
        finally:
            res.shutdown()
        del res
        torch.cuda.empty_cache()

        stride = ExpertStore(str(store)).stride
        budget = dense_bytes + DS_OFF_BUDGET * stride + stride // 2
        tokens = {}
        for mode in ("direct", "mmap"):
            # a budget of 160 of the 256 experts: the plan offloads, and its arena
            # takes the 256 slots of its one MoE layer, the least the engine takes
            # (so every fetch is a first touch, read from the store in ``mode``)
            off = _ep_build(f"dsv3 offload ({mode})", ckpt, dict(
                base, dense_paging="off", device_memory_bytes=budget, load_mode=mode), dev)
            try:
                E = DSV3_CONFIG["n_routed_experts"]
                if off.engine is None or off.engine.arena.num_slots != E:
                    raise AssertionError(f"dsv3 offload facade: expected an arena of {E} slots")
                tokens[mode], c = _serve_offload("dsv3", off, prompts, kw)
                _require_launched(c, DS_KERNELS, f"DeepSeek-V3 offload facade ({mode})")
                counts = _sum_counts(counts, c)
            finally:
                off.shutdown()
            del off
            torch.cuda.empty_cache()
        _ep_check("dsv3: offload tokens equal between load modes direct and mmap",
                  all(np.array_equal(a, b) for a, b in zip(tokens["direct"], tokens["mmap"])))
        say(f"[dsv3] offload tokens equal the resident facade's (reported): "
            f"{all(np.array_equal(a, b) for a, b in zip(tokens['mmap'], want))}")
        return counts
    finally:
        shutil.rmtree(DS_DIR, ignore_errors=True)
        say(f"[dsv3] deleted {DS_DIR.name}/")


def phase_loading(dev, requests=EP_REQUESTS):
    """Phases 39 (``requests`` per load mode) and 40, each timed. Returns
    their launches summed."""
    counts = {}
    for fn, args in ((phase_gptq_entry, (requests,)), (phase_dsv3_entry, ())):
        t0 = time.perf_counter()
        counts = _sum_counts(counts, fn(dev, *args))
        say(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 41: decode_scan (ROADMAP item 11) on the builds of phases 3, 5 and 7
# ---------------------------------------------------------------------------

SCAN_TOKENS = 32  # bench.py's presets' --tokens
WHOLE_RUN_SCAN_TOKENS = 8  # phase 41's steps in the whole run, for its time limit; --scan runs 32
SCAN_BATCH, SCAN_PROMPT = 4, 16  # decoder-only rows and their prompt
SCAN_CAP = 256  # bench.py's decode_scan caches (bench.py:370)
SCAN_SAMPLING = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.1)
SCAN_KERNELS = {"nllb": NLLB_KERNELS, "mixtral": ("flash_decode", "gmm"),
                "deepseek": MLA_KERNELS}


def _scan_guarded(fn):
    """(fn's result, device ms, wall s): fn runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so any host read or
    synchronisation inside it raises; CUDA events bracket it."""
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    prev = torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    e0.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1), time.perf_counter() - t0


def _scan_report(kind, what, got, want, gaps=None):
    """Greedy tokens of decode_scan against the per-step path's, per row:
    equal, or (bf16) the first differing step and the per-step path's top-2
    logit gap there, reported."""
    rows = [b for b in range(got.shape[0]) if not np.array_equal(got[b], want[b])]
    line = f"[scan] {kind}: decode_scan against {what}: {got.shape[0] - len(rows)} of " \
           f"{got.shape[0]} rows' greedy tokens equal"
    for b in rows:
        j = int(np.argmax(got[b] != want[b]))
        gap = "" if gaps is None else f", per-step top-2 gap there {gaps[b, j]:.4e}"
        line += f"; row {b} first differs at step {j}{gap}"
    say(line + (" (bf16, reported)" if rows else ""))
    return not rows


def _scan_gaps(stepper, prompt, n, dev):
    """The per-step path's (int kv_len, as ``Generator`` steps) top-2 logit
    gap at each of its ``n`` decode steps after the prefill: [B, n]."""
    B, P = prompt.shape
    kv = stepper.init_cache(B, SCAN_CAP)
    pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    logits, kv, _ = stepper.forward(prompt, pos, kv, 0)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    gaps = []
    for i in range(n):
        at = P + i
        logits, kv, _ = stepper.forward(tok, torch.full((B, 1), at, dtype=torch.int32,
                                                        device=dev), kv, at)
        top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).cpu().numpy())
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    return np.stack(gaps, 1)


def phase_decode_scan(dev, kind, built):
    """Phase 41 on one build (``kind``: nllb, mixtral or deepseek): greedy
    ``decode_scan`` of SCAN_TOKENS steps eagerly and as CUDA graphs (a
    warm-up call captures; the timed call replays under the sync guard),
    bit-equal; its tokens against the per-step path's; one sampled setting
    (SCAN_SAMPLING): a seed twice, graph against eager, two seeds. Returns
    the timed call's launches."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import (
        Generator,
        ResidentStepper,
        Seq2SeqGenerator,
        _scan_blocks,
    )
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.runtime.sampling import SamplingParams

    N, sp = SCAN_TOKENS, SamplingParams(**SCAN_SAMPLING)
    fl = ResidentProvider.for_layer
    if kind == "nllb":
        model, params, experts, ids, mask = built
        B = ids.shape[0]
        src = torch.as_tensor(ids, dtype=torch.int32, device=dev)
        msk = torch.as_tensor(mask, device=dev)
        graphed = Seq2SeqGenerator(model, params, experts, fl, impl="pallas")
        eager = Seq2SeqGenerator(model, params, experts, fl, impl="pallas", graphs=False)

        def scan(gen, **kw):
            return gen.decode_scan(src, N, attention_mask=msk, **kw)[0]

        def per_step():
            return graphed.generate(ids, max_new_tokens=N, attention_mask=mask,
                                    eos_token_id=None).sequences[:, 1:]
    else:
        model, params, experts = built
        B, P = SCAN_BATCH, SCAN_PROMPT
        g = torch.Generator(device=dev)
        g.manual_seed(41)
        prompt = torch.randint(3, model.spec.vocab_size, (B, P), generator=g, device=dev,
                               dtype=torch.int32)
        graphed = ResidentStepper(model, params, experts, fl, impl="pallas")
        eager = ResidentStepper(model, params, experts, fl, impl="pallas", graphs=False)
        pos0 = torch.full((B,), P, dtype=torch.int32, device=dev)
        starts = {}

        def start(st):
            kv = st.init_cache(B, SCAN_CAP)
            pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
            logits, kv, _ = st.forward(prompt, pos, kv, 0)
            return torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None], kv

        def scan(st, **kw):
            if st not in starts:
                starts[st] = start(st)
            tok0, kv = starts[st]
            toks, kv = st.decode_scan(tok0, pos0, kv, N, **kw)
            starts[st] = (tok0, kv)  # graphs: the stepper's own caches, no copy next time
            return toks

        host_prompt = prompt.cpu().numpy()

        def per_step():
            return Generator(stepper=eager).generate(
                host_prompt, max_new_tokens=N + 1, cache_len=SCAN_CAP).sequences[:, P + 1:]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = scan(eager).cpu().numpy()
    eager_ms = (time.perf_counter() - t0) * 1e3 / N
    t0 = time.perf_counter()
    warm = scan(graphed).cpu().numpy()  # captures every block length's graph
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    st0 = graphed.graph_stats()
    reset_launches()
    toks, ms, wall = _scan_guarded(lambda: scan(graphed))
    counts = launch_counts()
    toks = toks.cpu().numpy()
    gst = graphed.graph_stats()
    blocks = _scan_blocks(N)
    if not (np.array_equal(toks, want) and np.array_equal(warm, want)):
        raise AssertionError(f"{kind}: decode_scan as graphs differs from eager")
    if (gst["captures"] != st0["captures"] or gst["recaptures"]
            or gst["replays"] - st0["replays"] != len(blocks)
            or gst["captures"] != len(set(blocks))):
        raise AssertionError(f"{kind}: one capture per block length, one replay per block "
                             f"expected ({st0} -> {gst})")
    _require_launched(counts, SCAN_KERNELS[kind], f"{kind} decode_scan")
    if toks.shape != (B, N) or not np.all((toks >= 0) & (toks < model.spec.vocab_size)):
        raise AssertionError(f"{kind}: decode_scan returned {toks.shape}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = per_step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    if kind == "nllb":
        # the generator's graphed steps plan K1 from the same capacity: held
        if not _scan_report(kind, "Seq2SeqGenerator.generate", toks, ref):
            raise AssertionError("nllb: decode_scan tokens differ from generate's")
        step_ms = step_s * 1e3 / N
    else:
        t1 = time.perf_counter()
        start(eager)
        torch.cuda.synchronize()
        step_ms = (step_s - (time.perf_counter() - t1)) * 1e3 / N  # the prefill taken off
        if not _scan_report(kind, "Generator", toks, ref):
            _scan_report(kind, "Generator", toks, ref, _scan_gaps(eager, prompt, N, dev))
    say(f"[scan] {kind}: B={B} N={N} greedy decode_scan as graphs (blocks {blocks}): "
        f"{ms / N:.4f} ms per token of device time ({B * N / (ms / 1e3):.1f} tokens/s; wall "
        f"{wall * 1e3 / N:.4f} ms, the sync guard on); eager and the warm-up capture bit-equal; "
        f"eager decode_scan {eager_ms:.4f} ms per token (host clock, the build's first "
        f"scan); per-step path {step_ms:.4f} ms per token "
        f"({B * N / (step_ms * N / 1e3):.1f} tokens/s, host clock); graphs {json.dumps(gst)} (the warm-up call with its captures "
        f"{capture_s:.2f} s); launches {json.dumps({k: n for k, n in counts.items() if n})}")
    a = scan(graphed, sampling=sp, seed=7).cpu().numpy()
    checks = {"seed twice": np.array_equal(a, scan(graphed, sampling=sp, seed=7).cpu().numpy()),
              "graph == eager": np.array_equal(a, scan(eager, sampling=sp, seed=7).cpu().numpy()),
              "two seeds differ": not np.array_equal(
                  a, scan(graphed, sampling=sp, seed=8).cpu().numpy())}
    say(f"[scan] {kind}: sampled {json.dumps(SCAN_SAMPLING)}: {json.dumps(checks)}; graphs "
        f"{json.dumps(graphed.graph_stats())}")
    if not all(checks.values()):
        raise AssertionError(f"{kind}: sampled decode_scan {checks}")
    del graphed, eager
    return {k: n for k, n in counts.items() if n}


# ---------------------------------------------------------------------------
# phase 42: the resident mesh (item 18a) on two ranks
# ---------------------------------------------------------------------------

MESH_DEPTH = 2  # Mixtral-8x7B's layers, as phase 19 cuts it
MESH_PLANS = (dict(expert=2), dict(model=2), dict(data=2))
MESH_ROWS, MESH_PROMPT, MESH_NEW = 4, 16, 8
MESH_TIMEOUT = 420  # seconds for both ranks; a rank still alive then is killed
MESH_KERNELS = ("flash_decode", "flash_attend", "gmm")
# each rank's runs, in order: f32 through K3, f32 through the exact grouped
# FFN ("dense": every slot for every token in f32, whose rows depend neither
# on the batch nor on the plan), bf16 through K3; f32 runs are held, bf16
# reported
MESH_RUNS = ((torch.float32, "pallas"), (torch.float32, "dense"), (torch.bfloat16, "pallas"))
MESH_TOL = 2e-4  # largest error of the prefill logits (the JAX suite's, tests/test_parallel.py)
# f32 through K3 under model=2 and data=2: the o projection's sum over
# ranks, and attention and K3 planned for fewer rows, change the last f32
# bits of K3's inputs, and K3 rounds its operands to bf16, which turns some
# of those into bf16 steps (1.24e-2 on logits up to 6.4). The limit lies
# between that and the planted faults' 6.3 to 8.6 (PERF.md section 6).
# Under expert=2 the ranks launch the unsharded grid and are held at MESH_TOL.
MESH_K3_TOL = 5e-2


def _rank_device(rank):
    """A rank's card: ``cuda:(rank % device_count)``, so both ranks share one."""
    return torch.device("cuda", rank % torch.cuda.device_count())


def _mesh_tol(dtype, impl, plan):
    """The held limit of a run, or None where it is reported."""
    if dtype != torch.float32:
        return None
    return MESH_TOL if impl == "dense" or "expert" in plan else MESH_K3_TOL


def _mesh_rank(rank, world, init, out_dir, backend):
    """One rank of phase 42 (spawned): the same seed's Mixtral-8x7B at
    MESH_DEPTH layers unsharded (this process alone), then sharded under each
    plan of MESH_PLANS, for each run of MESH_RUNS. Writes its readings and
    the sharded runs' launches to ``out_dir/rank<r>.json``; raises on a
    failed check."""
    import traceback

    import torch.distributed as dist

    try:
        from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
        from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
        from moe_infinity_tpu_torch.parallel import mesh as pm
        from moe_infinity_tpu_torch.runtime.generate import Generator, ResidentStepper
        from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

        dev = _rank_device(rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        spec = MixtralSpec(**dict(MIXTRAL_8X7B, num_layers=MESH_DEPTH))
        fl = ResidentProvider.for_layer
        g = torch.Generator(device=dev)
        g.manual_seed(4242)
        prompt = torch.randint(3, spec.vocab_size, (MESH_ROWS, MESH_PROMPT), generator=g,
                               device=dev, dtype=torch.int32)
        host_prompt = prompt.cpu().numpy()
        pos = torch.arange(MESH_PROMPT, dtype=torch.int32, device=dev).expand(MESH_ROWS, -1)

        def run(stepper):
            kv = stepper.init_cache(MESH_ROWS, 64)
            logits = stepper.forward(prompt, pos, kv, 0)[0]
            toks = Generator(stepper=stepper).generate(
                host_prompt, max_new_tokens=MESH_NEW, cache_len=64).sequences
            return logits, toks

        out, counts = {"readings": []}, {}
        built = None
        for dtype, impl in MESH_RUNS:
            if built is None or built[0] != dtype:
                built = None
                torch.cuda.empty_cache()
                single = MixtralModel(spec, compute_dtype=dtype, device=dev)
                g.manual_seed(7)
                params, tree = single.init_random(g, expert_dtype="bf16")
                built = (dtype, single, params, ResidentProvider(tree).pytree())
                del tree
            _, single, params, experts = built
            kernels = MESH_KERNELS if impl == "pallas" else MESH_KERNELS[:2]
            want, want_toks = run(ResidentStepper(single, params, experts, fl, impl=impl,
                                                  graphs=False))
            scale = want.abs().max().item()
            for plan in MESH_PLANS:
                mesh = pm.make_mesh(pm.MeshPlan(**plan))
                model = MixtralModel(spec, compute_dtype=dtype, device=dev, mesh=mesh)
                p = (pm.shard_params(params, pm.mixtral_param_shardings(mesh, params))
                     if mesh.shape["model"] > 1 else params)
                e = pm.shard_params(experts, pm.expert_shardings(mesh, experts))
                st = ResidentStepper(model, p, e, fl, impl=impl, graphs=False)
                if mesh.shape["data"] > 1:
                    st.set_data_sharding(mesh)
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, toks = run(st)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                c = launch_counts()
                counts = {k: counts.get(k, 0) + n for k, n in c.items()}
                missing = [k for k in kernels if c.get(k, 0) <= 0]
                err = (got - want).abs().max().item()
                tol = _mesh_tol(dtype, impl, plan)
                ok = err <= (tol or MESH_TOL)
                same = bool(np.array_equal(toks, want_toks))
                name = str(dtype).split(".")[-1]
                out["readings"].append(dict(
                    dtype=name, impl=impl, plan=plan, max_abs_err=err, logit_scale=scale,
                    tol=tol, within=ok, tokens_equal=same, seconds=secs, launches=c,
                    coords=mesh.coords, expert_slots=int(e["layers"][0]["gate"].shape[0]),
                    kv_heads=int(model.num_kv_heads)))
                if missing or (tol is not None and not (ok and same)):
                    raise AssertionError(
                        f"rank {rank} {name} impl={impl} {plan}: max_abs_err {err:.3e} (limit "
                        f"{tol or MESH_TOL:g}, logits up to {scale:.3g}), tokens equal {same}, "
                        f"kernels not launched {missing}")
                del model, p, e, st
                torch.cuda.empty_cache()
        del built, single, params, experts
        torch.cuda.empty_cache()
        out["launches"] = counts
        dist.barrier()
        dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def check_other_device(dev):
    """K1 and K3 on the second card against their plain versions, where the
    machine has one: the wrappers launch on their tensors' device."""
    if torch.cuda.device_count() < 2:
        say("[mesh] one card: K1 and K3 on cuda:1 could not be run (needs two)")
        return
    from moe_infinity_tpu_torch.ops import flash_attention as fa
    from moe_infinity_tpu_torch.ops import gmm as gm
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    d1 = torch.device("cuda", 1)
    before = launch_counts()
    g = torch.Generator(device=d1)
    g.manual_seed(1)
    q = torch.randn(4, 32, 128, generator=g, device=d1, dtype=torch.bfloat16)
    k = torch.randn(4, 64, 8, 128, generator=g, device=d1, dtype=torch.bfloat16)
    v = torch.randn(4, 64, 8, 128, generator=g, device=d1, dtype=torch.bfloat16)
    qpos = torch.tensor([40, 12, 63, 5], dtype=torch.int32, device=d1)
    compare("K1 on cuda:1", fa._decode_cuda(q, k, v, qpos, 64, scale=0.088, causal=True,
                                            logit_softcap=None, pad_mask=None),
            fa.flash_decode_plain(q, k, v, qpos, 64, scale=0.088))
    x = torch.randn(24, 4096, generator=g, device=d1, dtype=torch.bfloat16)
    w = torch.randn(8, 4096, 512, generator=g, device=d1, dtype=torch.bfloat16) * 0.02
    sizes = torch.tensor([3, 0, 5, 2, 6, 1, 4, 3], dtype=torch.int32, device=d1)
    compare("K3 on cuda:1", gm.gmm(x, w, sizes), gm.gmm_plain(x, w, sizes))
    reset_launches()
    from moe_infinity_tpu_torch.ops import add_launches

    add_launches(before)  # the comparisons' launches do not count


def phase_mesh(dev):
    """Phase 42: two ranks, spawned, with a ``file://`` rendezvous in a
    temporary directory; gloo on one card, NCCL with a card a rank. Each
    rank holds every plan to its own unsharded run (f32 logits within
    ``_mesh_tol``, greedy tokens equal; bf16 reported). Returns the ranks'
    launches."""
    import tempfile

    import torch.multiprocessing as mp

    check_other_device(dev)
    n = torch.cuda.device_count()
    backend = "nccl" if n >= 2 else "gloo"
    say(f"[mesh] Mixtral-8x7B at {MESH_DEPTH} layers, published width, bf16 experts "
        f"(f32 through K3 and through the exact grouped FFN, bf16 through K3); 2 ranks on {min(n, 2)} card(s), backend {backend}"
        + (" (CUDA tensors staged through the host)" if backend == "gloo" else "")
        + f"; plans {json.dumps(MESH_PLANS)}; {MESH_ROWS} rows, prompt "
          f"{MESH_PROMPT}, {MESH_NEW} greedy tokens")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank, args=(r, 2, f"file://{tmp}/rendezvous", tmp,
                                                       backend)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        errs = "".join(Path(tmp, f"rank{r}.err").read_text() for r in range(2)
                       if Path(tmp, f"rank{r}.err").exists())
        if hung:
            raise AssertionError(f"mesh: ranks {hung} did not finish in {MESH_TIMEOUT} s\n{errs}")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"mesh: rank exit codes {codes}\n{errs}")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(2)]
    counts = {}
    for r, res in enumerate(ranks):
        for rd in res["readings"]:
            held = f"held at {rd['tol']:g}" if rd["tol"] else "reported"
            say(f"[mesh] rank {r} {rd['dtype']} impl={rd['impl']} {json.dumps(rd['plan'])} coords "
                f"{json.dumps(rd['coords'])}: prefill logits (up to {rd['logit_scale']:.4g}) "
                f"against the unsharded run max_abs_err={rd['max_abs_err']:.4e} (within: "
                f"{rd['within']}, {held}), greedy tokens equal {rd['tokens_equal']} "
                f"({'held' if rd['tol'] else 'reported'}), expert slots "
                f"{rd['expert_slots']}, KV heads {rd['kv_heads']}, {rd['seconds']:.2f} s; "
                f"launches {json.dumps({k: n for k, n in rd['launches'].items() if n})}")
        counts = {k: counts.get(k, 0) + n for k, n in res["launches"].items()}
    counts = {k: n for k, n in counts.items() if n}
    say(f"[mesh] launches of both ranks' sharded runs {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------------------
# phase 43: offload across ranks (item 18b) on two and four ranks
# ---------------------------------------------------------------------------

POD_BLOCKS = PARITY_BLOCKS  # NLLB-MoE-54B's 4+4 blocks, every 2nd sparse (phases 10 and 12)
POD_NLLB_NEW = 8  # greedy tokens a request in 43a
POD_FALLBACK_NEW = 4  # 43c's greedy tokens, one request (the shortest source, 24 tokens)
# 43c's deadline, seconds: the held column rank waits it out at every MoE
# layer; the other ranks' fetches land well inside it, so that only the held
# coordinate's experts run on the host
POD_FALLBACK_TIMEOUT = 1.0
POD_SEEDS = {"nllb": 43, "mixtral": 44}
# the legs of each spawn: (leg, model, plan, options); 43c is 43a's model=2 x
# expert=2 build with the host fallback and one column rank's store held
POD_LEGS = {
    2: (("43a", "nllb", dict(expert=2), {}),
        ("43b", "mixtral", dict(expert=2), {}),
        ("43b-spec", "mixtral", dict(expert=2), dict(speculative=True, spec_block=4))),
    4: (("43a", "nllb", dict(model=2, expert=2), {}),
        ("43c", "nllb", dict(model=2, expert=2), dict(host_fallback=True)),
        ("43b", "mixtral", dict(data=2, expert=2), {})),
}
POD_TIMEOUT = 420  # seconds a spawn's ranks have in all; a rank still alive then is killed
POD_MESH_TIMEOUT = 120.0  # seconds an exchange waits for a peer before it raises
POD_KERNELS = ("flash_decode", "flash_attend", "gmm")


class _HeldStore:
    """A store whose records never reach the arena's fetch workers (threads
    ``arena-fetch-*``) until ``release``: every expert it serves misses the
    host fallback's deadline. Other readers (the host executor, on the
    rank's own thread) pass."""

    def __init__(self, inner):
        import threading

        self._inner = inner
        self._open = threading.Event()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def release(self):
        self._open.set()

    def get_expert(self, layer, expert, **kw):
        import threading

        if threading.current_thread().name.startswith("arena-fetch"):
            self._open.wait(timeout=POD_TIMEOUT)
        return self._inner.get_expert(layer, expert, **kw)


def _pod_nllb(dev):
    """NLLB-MoE-54B at its published width, POD_BLOCKS+POD_BLOCKS blocks,
    f32, params from POD_SEEDS["nllb"] (a model with no mesh)."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=POD_BLOCKS, decoder_layers=POD_BLOCKS,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    g = torch.Generator(device=dev)
    g.manual_seed(POD_SEEDS["nllb"])
    params, _ = NllbModel(spec, compute_dtype=torch.float32, device=dev).init_random(
        g, with_experts=False)
    ids, mask = _requests(spec.vocab_size, g, dev)
    return spec, params, ids, mask


def _pod_mixtral(dev):
    """Mixtral-8x7B at MESH_DEPTH layers, f32 compute, int8 experts (a
    record per expert), from POD_SEEDS["mixtral"]."""
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec

    spec = MixtralSpec(**dict(MIXTRAL_8X7B, num_layers=MESH_DEPTH))
    g = torch.Generator(device=dev)
    g.manual_seed(POD_SEEDS["mixtral"])
    params, _ = MixtralModel(spec, compute_dtype=torch.float32, device=dev).init_random(
        g, with_experts=False)
    prompt = np.random.default_rng(POD_SEEDS["mixtral"]).integers(
        3, spec.vocab_size, (MESH_ROWS, MESH_PROMPT))
    return spec, params, prompt


def _pod_nllb_store(spec):
    return _offload_store(spec, seed=POD_SEEDS["nllb"], cache_records=spec.num_experts)


def _nllb_run(engine, ids, mask, new):
    """(first-step logits [B, V] on the host, greedy tokens) of a seq2seq
    offload engine."""
    logits = _offload_first_step(engine, ids, mask)[:, -1].float().cpu().numpy()
    toks = engine.generate(ids, max_new_tokens=new, attention_mask=mask,
                           eos_token_id=None).sequences
    return logits, np.asarray(toks)


def _mixtral_run(engine, prompt):
    """(prefill logits [B, V] of the last column on the host, greedy
    tokens) of a decoder-only stepper."""
    from moe_infinity_tpu_torch.runtime.generate import Generator

    dev = engine.model.device
    B, T = prompt.shape
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    logits = engine.forward(torch.as_tensor(prompt, dtype=torch.int32, device=dev), pos,
                            engine.init_cache(B, 64), 0)[0][:, -1].float().cpu().numpy()
    toks = Generator(stepper=engine).generate(prompt, max_new_tokens=MESH_NEW,
                                              cache_len=64).sequences
    return logits, np.asarray(toks)


def _pod_references(dev, out_dir):
    """The one-rank engines of the same seeds, in this process: the NLLB
    ``Seq2SeqOffloadEngine`` (E slots, bench.py's engine) on the four
    requests, and on the first alone with the host fallback and experts of
    coordinate 0 (of 2) held back, as 43c's column rank holds them; the
    Mixtral ``OffloadEngine`` (E slots, eager). Saved to ``out_dir``."""
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel
    from moe_infinity_tpu_torch.models.nllb import NllbModel

    spec, params, ids, mask = _pod_nllb(dev)
    E = spec.num_experts
    model = NllbModel(spec, compute_dtype=torch.float32, device=dev)
    engine = _offload_engine(model, params, _pod_nllb_store(spec), E, None)
    try:
        logits, toks = _nllb_run(engine, ids, mask, POD_NLLB_NEW)
    finally:
        engine.arena.shutdown()
    np.savez(Path(out_dir, "ref_nllb.npz"), logits=logits, tokens=toks)
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine

    # 43c's reference: coordinate 0's experts (of 2) run on the host at every
    # MoE layer, the rest through the arena, as 43c's agreed rows make them
    arena = ExpertArena(_pod_nllb_store(spec), E, policy="priority", compute_dtype=torch.float32,
                        device=dev, num_threads=4, reserve_zero_slot=True)
    acquire = arena.acquire

    def coordinate_0_missing(keys, layer, timeout):
        rest = [k for k in keys if k[1] >= E // 2]
        acquire(rest, layer)
        return rest, [k for k in keys if k[1] < E // 2]

    arena.try_acquire = coordinate_0_missing
    engine = Seq2SeqOffloadEngine(model, params, arena, prefetch=False, impl="pallas",
                                  host_fallback=True, host_fallback_timeout=POD_FALLBACK_TIMEOUT)
    try:
        logits, toks = _nllb_run(engine, ids[-1:], mask[-1:], POD_FALLBACK_NEW)
        host = engine.host_exec_count
    finally:
        engine.arena.shutdown()
    np.savez(Path(out_dir, "ref_fallback.npz"), logits=logits, tokens=toks, host=host)
    del model, params, engine, arena
    torch.cuda.empty_cache()
    mspec, mparams, prompt = _pod_mixtral(dev)
    mmodel = MixtralModel(mspec, compute_dtype=torch.float32, device=dev)
    store = _mixtral_offload_store(mspec, distinct=True, seed=POD_SEEDS["mixtral"])
    engine = _decoder_engine(mmodel, mparams, store, mspec.num_experts, graphs=False)
    try:
        logits, toks = _mixtral_run(engine, prompt)
    finally:
        engine.arena.shutdown()
    np.savez(Path(out_dir, "ref_mixtral.npz"), logits=logits, tokens=toks)
    del mmodel, mparams, store, engine
    torch.cuda.empty_cache()


def _pod_leg(leg, kind, plan, opts, mesh, built, dev):
    """One leg on this rank: the pod engine over this rank's executor,
    first-step logits and greedy tokens, its counters. The executor holds
    one MoE layer's share of its coordinate's experts (two layers' for the
    speculative leg, the least that holds a step's union)."""
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
    from moe_infinity_tpu_torch.parallel.pod import PodOffloadExecutor
    from moe_infinity_tpu_torch.runtime.pod_engine import (
        PodOffloadEngine,
        PodSeq2SeqOffloadEngine,
    )

    ep = mesh.shape["expert"]
    spec, params = built[kind][:2]
    E = spec.num_experts
    slots = E // ep * (2 if opts.get("speculative") else 1)
    held = None
    if kind == "nllb":
        from moe_infinity_tpu_torch.models.nllb import NllbModel

        ids, mask = built[kind][2:]
        store = _pod_nllb_store(spec)
        if opts.get("host_fallback") and (mesh.coords["expert"], mesh.coords["model"]) == (0, 1):
            store = held = _HeldStore(store)  # this column rank never lands a record
        model = NllbModel(spec, compute_dtype=torch.float32, device=dev, mesh=mesh)
        n_enc = store.meta["num_encoder_moe_layers"]
        tracer = ExpertTracer(256, store.num_layers, E, num_encoder_layers=n_enc)
        ex = PodOffloadExecutor(mesh, store, slots, compute_dtype=torch.float32, device=dev,
                                num_threads=4, host_fallback=bool(opts.get("host_fallback")),
                                host_fallback_timeout=POD_FALLBACK_TIMEOUT)
        eng = PodSeq2SeqOffloadEngine(model, params, ex, tracer=tracer,
                                      predictor=ExpertPredictor(tracer),
                                      prefetch=not opts.get("host_fallback"), lookahead=3,
                                      prefetch_budget=8, impl="pallas")
        rows = slice(-1, None) if opts.get("host_fallback") else slice(None)
        new = POD_FALLBACK_NEW if opts.get("host_fallback") else POD_NLLB_NEW

        def run():
            return _nllb_run(eng, ids[rows], mask[rows], new)
    else:
        from moe_infinity_tpu_torch.models.mixtral import MixtralModel

        prompt = built[kind][2]
        store = built[kind][3]
        model = MixtralModel(spec, compute_dtype=torch.float32, device=dev, mesh=mesh,
                             shard_dense=False)
        tracer = ExpertTracer(256, store.num_layers, E)
        ex = PodOffloadExecutor(mesh, store, slots, compute_dtype=torch.bfloat16, device=dev,
                                num_threads=4)
        eng = PodOffloadEngine(model, params, ex, tracer=tracer, predictor=ExpertPredictor(tracer),
                               prefetch=True, lookahead=3, prefetch_budget=4, impl="pallas",
                               speculative=bool(opts.get("speculative")),
                               spec_block=opts.get("spec_block", 1))

        def run():
            return _mixtral_run(eng, prompt)
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, toks = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        st = eng.stats()
        fetch = ex.arena.fetch_stats()
    finally:
        if held is not None:
            held.release()
        ex.shutdown()
    return {"leg": leg, "kind": kind, "plan": plan, "coords": dict(mesh.coords), "slots": slots,
            "seconds": secs, "launches": counts,
            "stats": {k: st.get(k) for k in ("hits", "misses", "evictions", "barrier_joins",
                                             "host_exec_count", "column_disagreements",
                                             "speculative_steps", "mean_step_executions")},
            "fetches": fetch["fetches_store"] + fetch["fetches_tier"]}, logits, toks


def _pod_rank(rank, world, init, out_dir, backend, blocks=POD_BLOCKS):
    """One rank of phase 43 (spawned): the legs of POD_LEGS[world], each
    model built once from its seed, NLLB at ``blocks``+``blocks`` (the
    parent's POD_BLOCKS: a spawned rank imports this module afresh). Writes
    its readings (and logits and tokens) to ``out_dir``; raises on a failed
    leg."""
    import traceback

    import torch.distributed as dist

    global POD_BLOCKS
    POD_BLOCKS = blocks
    try:
        from moe_infinity_tpu_torch.parallel import mesh as pm
        from moe_infinity_tpu_torch.parallel.multihost import global_mesh

        dev = _rank_device(rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        # the ranks share the host's cores (43c's host deltas run on them)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        built, meshes, out = {}, {}, {"legs": []}
        for leg, kind, plan, opts in POD_LEGS[world]:
            if kind not in built:
                if kind == "nllb":
                    built[kind] = _pod_nllb(dev)
                else:
                    mspec, mparams, prompt = _pod_mixtral(dev)
                    built[kind] = (mspec, mparams, prompt, _mixtral_offload_store(
                        mspec, distinct=True, seed=POD_SEEDS["mixtral"]))
            key = json.dumps(plan, sort_keys=True)
            if key not in meshes:
                meshes[key] = global_mesh(pm.MeshPlan(**plan), timeout=POD_MESH_TIMEOUT)
            reading, logits, toks = _pod_leg(leg, kind, plan, opts, meshes[key], built, dev)
            np.savez(Path(out_dir, f"{leg}_{world}_rank{rank}.npz"), logits=logits, tokens=toks)
            out["legs"].append(reading)
        del built
        torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        Path(out_dir, f"rank{rank}_{world}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}_{world}.err").write_text(traceback.format_exc())
        raise


def _pod_spawn(world, tmp, backend):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_pod_rank, args=(r, world, f"file://{tmp}/rendezvous{world}",
                                                 tmp, backend, POD_BLOCKS))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + POD_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errs = "".join(Path(tmp, f"rank{r}_{world}.err").read_text() for r in range(world)
                   if Path(tmp, f"rank{r}_{world}.err").exists())
    if hung:
        raise AssertionError(f"pod: ranks {hung} of {world} did not finish in {POD_TIMEOUT} s"
                             f"\n{errs}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"pod: rank exit codes {codes} of {world}\n{errs}")
    return [json.loads(Path(tmp, f"rank{r}_{world}.json").read_text()) for r in range(world)]


def phase_pod(dev):
    """Phase 43: offload across ranks (``runtime/pod_engine.py``) on two
    and four ranks spawned on the card(s), a ``file://`` rendezvous, gloo
    on one card (NCCL with a card a rank). The engines are built directly
    (the facade's multihost plan needs a checkpoint on disk; the stores are
    seeded ``SyntheticStore``s). 43a: NLLB-MoE-54B at its published width
    through ``PodSeq2SeqOffloadEngine`` under expert=2, then model=2 x
    expert=2 (int4 columns repacked); 43b: Mixtral-8x7B at 2 layers
    through ``PodOffloadEngine`` per layer and speculative (blocks of 4)
    under expert=2, then data=2 x expert=2; 43c: the model=2 x expert=2
    NLLB with the host fallback and column 1 of coordinate 0 never landing
    a record (its coordinate's experts run on the host on every rank). Each
    rank's greedy tokens are held equal to the one-rank engine's of the same
    seed and its first-step logits within MESH_TOL (expert=2) or
    MESH_K3_TOL (a model or data axis: K3 planned for a d_ff column or half
    the rows). Returns the ranks' launches."""
    import tempfile

    n = torch.cuda.device_count()
    say(f"[pod] NLLB-MoE-54B at its published width, {POD_BLOCKS}+{POD_BLOCKS} blocks, f32 over "
        f"int4 experts; Mixtral-8x7B at {MESH_DEPTH} layers, f32 over int8 experts; ranks on "
        f"{n} card(s); legs "
        f"{json.dumps({w: [(l, p) for l, _k, p, _o in legs] for w, legs in POD_LEGS.items()})}")
    torch.cuda.empty_cache()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _pod_references(dev, tmp)
        say(f"[pod] one-rank references: {time.perf_counter() - t0:.1f} s")
        refs = {k: dict(np.load(Path(tmp, f"ref_{k}.npz"))) for k in ("nllb", "fallback",
                                                                       "mixtral")}
        torch.cuda.empty_cache()
        for world in sorted(POD_LEGS):
            backend = "nccl" if n >= world else "gloo"
            t0 = time.perf_counter()
            ranks = _pod_spawn(world, tmp, backend)
            say(f"[pod] {world} ranks over {backend}: {time.perf_counter() - t0:.1f} s")
            for r, res in enumerate(ranks):
                for rd in res["legs"]:
                    leg = rd["leg"]
                    got = np.load(Path(tmp, f"{leg}_{world}_rank{r}.npz"))
                    ref = refs["fallback" if leg == "43c" else rd["kind"]]
                    err = float(np.abs(got["logits"] - ref["logits"]).max())
                    tol = MESH_TOL if set(rd["plan"]) == {"expert"} else MESH_K3_TOL
                    same = bool(np.array_equal(got["tokens"], ref["tokens"]))
                    missing = [k for k in POD_KERNELS if rd["launches"].get(k, 0) <= 0]
                    extra = ""
                    if leg == "43c":
                        extra = (f", host executions {rd['stats']['host_exec_count']} (the "
                                 f"one-rank reference's {int(ref['host'])})")
                    say(f"[pod] {leg} rank {r} {json.dumps(rd['plan'])} coords "
                        f"{json.dumps(rd['coords'])}: first-step logits (up to "
                        f"{np.abs(ref['logits']).max():.4g}) max_abs_err={err:.4e} (held at "
                        f"{tol:g}), greedy tokens equal {same}; {rd['slots']} slots, "
                        f"{json.dumps(rd['stats'])}, fetches {rd['fetches']}, "
                        f"{rd['seconds']:.2f} s{extra}; launches "
                        f"{json.dumps({k: v for k, v in rd['launches'].items() if v})}")
                    bad = err > tol or not same or missing
                    if leg == "43c" and not rd["stats"]["host_exec_count"]:
                        bad = True
                    if bad:
                        raise AssertionError(
                            f"pod {leg} rank {r} {rd['plan']}: max_abs_err {err:.3e} (limit "
                            f"{tol:g}), tokens equal {same}, kernels not launched {missing}, "
                            f"stats {rd['stats']}")
                    counts = {k: counts.get(k, 0) + v for k, v in rd["launches"].items()}
    counts = {k: v for k, v in counts.items() if v}
    say(f"[pod] launches of every rank's legs {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------------------
# phase 44: sequence parallelism (item 18c) on two ranks, its ring on four
# ---------------------------------------------------------------------------

SP_DEPTH = 2  # Mixtral-8x7B's and DeepSeek-V2-Lite's layers, NLLB-MoE-54B's encoder blocks
SP_PROMPT = 4097  # (a): 4,096 tokens through the ring (2,048 a rank) and 1 through the tail
SP_SHORT = 1  # (a)'s second request, shorter than the ring: the resident path
SP_NEW = 16
SP_MLA_PROMPT, SP_MLA_NEW = 2048, 8  # (b)
SP_DOC = 1024  # (c): one unpadded document
SP_MAX_SEQ = 4608  # (a)'s max_seq_len: the one-rank cache, and the tail's columns (tail_cap)
SP_SEEDS = {"mixtral": 45, "mla": 46, "nllb": 47, "ring": 48}
# each rank's runs of legs (a)-(c), in order: f32 through the plain grouped
# FFN ("ragged": one f32 matmul per routed group, the products exact), f32
# through K3, bf16 through K3; f32 runs are held, bf16 reported
SP_RUNS = ((torch.float32, "ragged"), (torch.float32, "pallas"), (torch.bfloat16, "pallas"))
SP_RING = 4  # (d): ring_attention and sp_decode_attention on four ranks
SP_RING_TOL = 2e-5  # the JAX suite's for the ring primitives (tests/test_sequence_parallel.py)
SP_TIMEOUT = 420  # seconds a spawn's ranks have in all; a rank still alive then is killed
SP_DIR = Path(__file__).resolve().parent / ".sp_entry"
SP_DISK_GB = 5  # int8 store 2.8 + dense archive 0.7, with room
SP_KERNELS = ("gmm",)


def _sp_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bf16_params(tree, key=None):
    """The dense tree at bf16 compute, as ``load_params`` casts it: every
    floating matrix but a router to bf16, vectors and routers as they are."""
    if isinstance(tree, dict):
        return {k: _bf16_params(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_bf16_params(v, key) for v in tree)
    if (isinstance(tree, torch.Tensor) and tree.dim() >= 2 and tree.is_floating_point()
            and key != "router"):
        return tree.to(torch.bfloat16)
    return tree


def _write_sp_store(root, dev, seed=SP_SEEDS["mixtral"]):
    """Leg (a)'s model directory with no checkpoint in it: EP_CONFIG's
    ``config.json`` and, under ``store/``, what the port's ingest writes for
    it at int8 (a record per expert: w1/w3/w2 int8 in [in, out] with f32
    per-channel scales; the dense archive in bf16 under HF's names), its
    values made on the card from ``seed``, so that ``MoE`` starts warm and
    nothing is quantized on the host. Returns the bytes written."""
    from moe_infinity_tpu_torch.store.blob import DenseArchiveWriter, ExpertStoreWriter

    c = EP_CONFIG
    D, F, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    V, L, H = c["vocab_size"], c["num_hidden_layers"], c["num_attention_heads"]
    kvd = c["num_key_value_heads"] * (D // H)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(c, indent=2))
    store = root / "store"
    roles = (("w1", (D, F)), ("w3", (D, F)), ("w2", (F, D)))
    fields = []
    for tail, shape in roles:
        fields += [(tail + ".weight", shape, "int8"), (tail + ".weight.scale", shape[1:], "float32")]
    meta = {"arch": "mixtral", "num_moe_layers": L, "num_experts": E, "num_encoder_moe_layers": 0,
            "expert_dtype": "int8", "dense_dtype": "bfloat16", "activation": "silu",
            "gated": True}
    w = ExpertStoreWriter(str(store), L, E, fields, meta=meta)
    total = 0
    for layer in range(L):
        for e in range(E):
            for tail, (din, dout) in roles:
                q = torch.randint(-127, 128, (din, dout), generator=g, device=dev,
                                  dtype=torch.int8)
                s = torch.empty(dout, device=dev).uniform_(2e-4, 3.5e-4, generator=g)
                w.write_tensor(layer, e, tail + ".weight", q.cpu().numpy())
                w.write_tensor(layer, e, tail + ".weight.scale", s.cpu().numpy())
                total += q.numel() + 4 * s.numel()
    w.finalize()
    d = DenseArchiveWriter(str(store))

    def put(name, *shape, ones=False):
        t = (torch.ones(shape, dtype=torch.bfloat16, device=dev) if ones else
             torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g))
        d.write(name, t.cpu().view(torch.int16).numpy().view(np.uint16))
        return 2 * t.numel()

    for i in range(L):
        p = f"model.layers.{i}."
        total += put(p + "input_layernorm.weight", D, ones=True)
        total += put(p + "post_attention_layernorm.weight", D, ones=True)
        total += put(p + "self_attn.q_proj.weight", D, D)
        total += put(p + "self_attn.k_proj.weight", kvd, D)
        total += put(p + "self_attn.v_proj.weight", kvd, D)
        total += put(p + "self_attn.o_proj.weight", D, D)
        total += put(p + "block_sparse_moe.gate.weight", E, D)
    total += put("model.embed_tokens.weight", V, D)
    total += put("model.norm.weight", D, ones=True)
    total += put("lm_head.weight", V, D)
    d.finalize()
    return total


def _sp_config(dtype, impl, seq):
    """Leg (a)'s facade: f32 compute over the store's int8 experts (taken as
    they are), or bf16; one request at a time."""
    return {"offload_path": str(SP_DIR / "store"),
            "expert_dtype": "float32" if dtype == torch.float32 else "int8",
            "moe_impl": impl, "max_seq_len": SP_MAX_SEQ, "max_batch_size": 1,
            "sequence_parallel": seq, "dense_paging": "off"}


def _sp_prompts():
    rng = np.random.default_rng(SP_SEEDS["mixtral"])
    return (rng.integers(3, EP_CONFIG["vocab_size"], (1, SP_PROMPT)),
            rng.integers(3, EP_CONFIG["vocab_size"], (1, SP_SHORT)))


def _sp_mla(dev):
    """DeepSeek-V2-Lite at SP_DEPTH layers (the dense first one and a MoE
    layer), bf16 experts, its prompt."""
    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = DeepseekV2Spec(**dict(DSV2_LITE, num_layers=SP_DEPTH))
    model = DeepseekV2Model(spec, compute_dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SP_SEEDS["mla"])
    params, tree = model.init_random(g, expert_dtype="bf16")
    prompt = np.random.default_rng(SP_SEEDS["mla"]).integers(3, spec.vocab_size,
                                                              (1, SP_MLA_PROMPT))
    return spec, params, ResidentProvider(tree).pytree(), prompt


def _sp_nllb(dev):
    """NLLB-MoE-54B with SP_DEPTH encoder blocks (the second sparse, int4
    experts) and one dense decoder block, f32, one unpadded document."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=SP_DEPTH, decoder_layers=1,
                           encoder_sparse_step=2, decoder_sparse_step=0))
    g = torch.Generator(device=dev)
    g.manual_seed(SP_SEEDS["nllb"])
    params, tree = NllbModel(spec, compute_dtype=torch.float32, device=dev).init_random(g)
    doc = np.random.default_rng(SP_SEEDS["nllb"]).integers(3, spec.vocab_size, (1, SP_DOC))
    doc[0, -1] = 2  # eos closes the document
    return spec, params, ResidentProvider(tree).pytree(), doc


def _sp_model(kind, spec, dtype, dev):
    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel
    from moe_infinity_tpu_torch.models.nllb import NllbModel

    cls = {"mixtral": MixtralModel, "mla": DeepseekV2Model, "nllb": NllbModel}[kind]
    return cls(spec, compute_dtype=dtype, device=dev)


def check_gmm_sp(dev):
    """K3 at one rank's Mixtral-8x7B MoE layer in leg (a)'s prefill: 2,048
    tokens x top-2 = 4,096 rows over the 8 experts, int8 with per-channel
    scales, D=4096 F=14336, gate + up + down, each role held against
    gmm_plain, then timed."""
    E, D, F = (MIXTRAL_8X7B["num_experts"], MIXTRAL_8X7B["hidden_size"],
               MIXTRAL_8X7B["intermediate_size"])
    g = torch.Generator(device=dev)
    g.manual_seed(SP_SEEDS["mixtral"])
    w, sc = _layer_weights(g, dev, E, D, F, "int8")
    tokens = (SP_PROMPT - 1) // 2
    gid, gsz, active = _routed_rows(g, dev, tokens, E)
    x = torch.randn(2 * tokens, D, generator=g, device=dev).to(torch.bfloat16)
    r = _check_layer(f"int8 Mixtral SP prefill rows={2 * tokens} active={active}", x, w, sc,
                     gsz, active, group_ids=gid)
    say(f"[time] gmm Mixtral sequence-parallel prefill MoE layer of one rank (gate + up + down, "
        f"{2 * tokens} rows over {active} experts, group sizes {gsz.tolist()}, int8 + scales, "
        f"D={D} F={F}): ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) library_ms=None (no PyTorch call takes "
        f"int8 weights with per-channel scales) max_abs_err={r['max_abs_err']:.3e}")
    del w, sc, x, r
    torch.cuda.empty_cache()


def _sp_references(dev, out_dir):
    """The one-rank runs of legs (a)-(c), in this process, for each run of
    SP_RUNS: (a) the facade's weights (``MoE`` with sequence_parallel 1)
    through a ``ResidentStepper``: the logits after the ring's 4,096 tokens
    and ``Generator``'s greedy tokens, and the facade's own tokens for the
    short request; (b) DeepSeek-V2-Lite's prefill logits and greedy tokens;
    (c) NLLB's ``encode``. Saved to ``out_dir``; returns the seconds of the
    one-rank prefills (the encode), by leg and run."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.runtime.generate import Generator, ResidentStepper
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    fl = ResidentProvider.for_layer
    secs = {}

    def decoder_refs(kind, model, params, experts, prompt, n, ring_len, extra=None):
        for dtype, impl in SP_RUNS:
            f32 = dtype == torch.float32
            m = model if f32 else _sp_model(kind, model.spec, dtype, dev)
            st = ResidentStepper(m, params if f32 else _bf16_params(params), experts, fl,
                                 impl=impl, graphs=False)
            ids = torch.as_tensor(prompt[:, :ring_len], dtype=torch.int32, device=dev)
            pos = torch.arange(ring_len, dtype=torch.int32, device=dev)[None]
            _sp_sync(dev)
            t0 = time.perf_counter()
            logits = st.forward(ids, pos, st.init_cache(1, ring_len), 0)[0][:, -1]
            _sp_sync(dev)
            secs[f"{kind}_{impl}_{str(dtype)[6:]}"] = time.perf_counter() - t0
            toks = Generator(stepper=st, max_seq_len=SP_MAX_SEQ).generate(
                prompt, max_new_tokens=n, eos_token_id=None).sequences
            np.savez(Path(out_dir, f"ref_{kind}_{impl}_{str(dtype)[6:]}.npz"),
                     out=logits.float().cpu().numpy(), tokens=np.asarray(toks), **(extra or {}))
            del st, logits
            torch.cuda.empty_cache()

    prompt, short = _sp_prompts()
    ref = MoE(str(SP_DIR), _sp_config(torch.float32, "ragged", 1), device=dev)
    try:
        short_toks = ref.generate(short, max_new_tokens=SP_NEW, eos_token_id=None)
        decoder_refs("mixtral", ref.model, ref.params, ref.generator.stepper.experts, prompt,
                     SP_NEW, SP_PROMPT - 1, extra={"short": short_toks})
    finally:
        ref.shutdown()
    del ref
    torch.cuda.empty_cache()
    spec, params, experts, mprompt = _sp_mla(dev)
    decoder_refs("mla", _sp_model("mla", spec, torch.float32, dev), params, experts, mprompt,
                 SP_MLA_NEW, SP_MLA_PROMPT)
    del params, experts
    torch.cuda.empty_cache()
    spec, params, experts, doc = _sp_nllb(dev)
    mask = torch.ones(doc.shape, dtype=torch.float32, device=dev)
    ids = torch.as_tensor(doc, device=dev)
    for dtype, impl in SP_RUNS:
        f32 = dtype == torch.float32
        m = _sp_model("nllb", spec, dtype, dev)
        _sp_sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = m.encode(params if f32 else _bf16_params(params), experts, ids, mask, fl, impl)
        _sp_sync(dev)
        secs[f"nllb_{impl}_{str(dtype)[6:]}"] = time.perf_counter() - t0
        np.savez(Path(out_dir, f"ref_nllb_{impl}_{str(dtype)[6:]}.npz"),
                 out=out.float().cpu().numpy())
        del out
    del params, experts
    torch.cuda.empty_cache()
    return secs


def _sp_timed(dec, dev):
    """Record the seconds of ``dec``'s prefill and of each of its steps."""
    t = {"prefill": 0.0, "steps": []}
    prefill, step = dec.prefill, dec.step

    def timed_prefill(tokens):
        _sp_sync(dev)
        t0 = time.perf_counter()
        out = prefill(tokens)
        _sp_sync(dev)
        t["prefill"] = time.perf_counter() - t0
        return out

    def timed_step(token, g):
        _sp_sync(dev)
        t0 = time.perf_counter()
        out = step(token, g)
        _sp_sync(dev)
        t["steps"].append(time.perf_counter() - t0)
        return out

    dec.prefill, dec.step = timed_prefill, timed_step
    return t


def _sp_run(leg, kind, dtype, impl, mesh, dev, fn, out_dir, rank, tokens_in):
    """One run of a leg on this rank: ``fn()`` -> (output to hold, tokens or
    None, timings or None), its K3 launches and hop bytes. Saves the arrays;
    returns the reading."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    hops = mesh.hop_bytes
    reset_launches()
    _sp_sync(dev)
    t0 = time.perf_counter()
    out, toks, times = fn()
    _sp_sync(dev)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    name = str(dtype)[6:]
    np.savez(Path(out_dir, f"{leg}_{impl}_{name}_rank{rank}.npz"), out=out.float().cpu().numpy(),
             **({} if toks is None else {"tokens": np.asarray(toks)}))
    pre = times["prefill"] if times else secs
    steps = times["steps"] if times else []
    return {"leg": leg, "kind": kind, "dtype": name, "impl": impl, "seconds": secs,
            "prefill_s": pre, "prefill_tokens": tokens_in, "tokens_per_s": tokens_in / pre,
            "step_ms": 1e3 * float(np.mean(steps)) if steps else None, "steps": len(steps),
            "hop_bytes": mesh.hop_bytes - hops, "launches": counts}


def _sp_legs(rank, mesh, dev, out_dir):
    """Legs (a)-(c) on this rank; returns their readings."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.parallel.sequence import SPDecoder, sp_encode
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    fl = ResidentProvider.for_layer
    readings = []
    # (a) through the facade: f32 (the plain grouped FFN, then K3 in the same
    # SPDecoder), then bf16 through K3 over the facade's weights cast
    prompt, short = _sp_prompts()
    moe = MoE(str(SP_DIR), _sp_config(torch.float32, "ragged", 2), device="cuda"
              if dev.type == "cuda" else "cpu")
    try:
        if moe.sp_decoder is None or moe.mesh.shape["seq"] != 2:
            raise AssertionError("sp (a): the facade built no long-context lane")
        dec = moe.sp_decoder
        # a short request through the lane first: the rank's first kernels,
        # handles and allocations are not timed below
        moe.generate(prompt[:, :64], max_new_tokens=2, eos_token_id=None)
        times = _sp_timed(dec, dev)
        for dtype, impl in SP_RUNS:
            if dtype == torch.float32:
                dec.impl = impl

                def run():
                    toks = moe.generate(prompt, max_new_tokens=SP_NEW, eos_token_id=None)
                    return dec.last_logits, toks, dict(times)
            else:
                bf = SPDecoder(_sp_model("mixtral", moe.model.spec, dtype, dev),
                               _bf16_params(moe.params), dec.experts, moe.mesh, for_layer=fl,
                               impl=impl, tail_cap=SP_MAX_SEQ)
                bt = _sp_timed(bf, dev)

                def run():
                    toks = bf.generate(prompt, max_new_tokens=SP_NEW)
                    return bf.last_logits, toks[None], bt
            times["steps"] = []
            readings.append(_sp_run("a", "mixtral", dtype, impl, moe.mesh, dev, run, out_dir,
                                    rank, SP_PROMPT - 1))
        dec.impl = "ragged"
        hops = moe.mesh.hop_bytes
        short_toks = moe.generate(short, max_new_tokens=SP_NEW, eos_token_id=None)
        np.savez(Path(out_dir, f"a_short_rank{rank}.npz"), tokens=short_toks,
                 hops=moe.mesh.hop_bytes - hops)
    finally:
        moe.shutdown()
    del moe, dec
    torch.cuda.empty_cache()
    # (b) SPDecoder over DeepSeek-V2-Lite
    spec, params, experts, mprompt = _sp_mla(dev)
    for dtype, impl in SP_RUNS:
        f32 = dtype == torch.float32
        d = SPDecoder(_sp_model("mla", spec, dtype, dev), params if f32 else _bf16_params(params),
                      experts, mesh, for_layer=fl, impl=impl, tail_cap=SP_MLA_NEW)
        t = _sp_timed(d, dev)

        def run():
            toks = d.generate(mprompt, max_new_tokens=SP_MLA_NEW, eos_token_id=None)
            return d.last_logits, toks[None], t
        readings.append(_sp_run("b", "mla", dtype, impl, mesh, dev, run, out_dir, rank,
                                SP_MLA_PROMPT))
        del d
    del params, experts
    torch.cuda.empty_cache()
    # (c) sp_encode over NLLB-MoE-54B
    spec, params, experts, doc = _sp_nllb(dev)
    for dtype, impl in SP_RUNS:
        f32 = dtype == torch.float32
        m = _sp_model("nllb", spec, dtype, dev)
        p = params if f32 else _bf16_params(params)

        def run():
            with torch.inference_mode():
                return sp_encode(m, p, experts, doc, mesh, for_layer=fl, impl=impl), None, None
        readings.append(_sp_run("c", "nllb", dtype, impl, mesh, dev, run, out_dir, rank, SP_DOC))
    del params, experts
    torch.cuda.empty_cache()
    return readings


def _sp_ring_inputs(dev):
    """(d)'s inputs at Mixtral-8x7B's attention width, f32, the same on
    every rank: q/k/v [1, 4096, H, 128] (rope-free), a one-token query and
    a tail of 16 columns."""
    g = torch.Generator(device=dev)
    g.manual_seed(SP_SEEDS["ring"])
    H, Hkv, Dh, T = (MIXTRAL_8X7B["num_heads"], MIXTRAL_8X7B["num_kv_heads"],
                     MIXTRAL_8X7B["head_dim"], SP_PROMPT - 1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)

    return (rnd(1, T, H, Dh), rnd(1, T, Hkv, Dh), rnd(1, T, Hkv, Dh), rnd(1, 1, H, Dh),
            rnd(1, 16, Hkv, Dh), rnd(1, 16, Hkv, Dh))


SP_RING_TAIL = 5  # (d)'s valid tail columns


def _sp_ring(rank, mesh, dev, out_dir):
    """(d) on this rank of four: its time block through ``ring_attention``
    (three hops) and the decode merge over its shard."""
    from moe_infinity_tpu_torch.ops.ring_attention import ring_attention, sp_decode_attention

    q, k, v, q1, tk, tv = _sp_ring_inputs(dev)
    Tl = q.shape[1] // SP_RING
    blk = slice(rank * Tl, (rank + 1) * Tl)
    _sp_sync(dev)
    t0 = time.perf_counter()
    out = ring_attention(q[:, blk], k[:, blk], v[:, blk], mesh)
    _sp_sync(dev)
    ring_s = time.perf_counter() - t0
    dec = sp_decode_attention(q1, k[:, blk], v[:, blk], tk, tv, SP_RING_TAIL, mesh)
    np.savez(Path(out_dir, f"d_rank{rank}.npz"), out=out.cpu().numpy(), dec=dec.cpu().numpy())
    return {"ring_s": ring_s, "hop_bytes": mesh.hop_bytes}


def _sp_rank(rank, world, init, out_dir, backend):
    """One rank of phase 44 (spawned): legs (a)-(c) on a ``seq`` mesh of two,
    or (d) on a ring of four. Writes its readings to ``out_dir``; raises on
    a failed step."""
    import traceback

    import torch.distributed as dist

    try:
        from moe_infinity_tpu_torch.parallel import mesh as pm

        dev = _rank_device(rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        mesh = pm.make_mesh(pm.MeshPlan(seq=world))
        if world == SP_RING:
            out = _sp_ring(rank, mesh, dev, out_dir)
        else:
            out = {"legs": _sp_legs(rank, mesh, dev, out_dir)}
        torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        Path(out_dir, f"sp_rank{rank}_{world}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"sp_rank{rank}_{world}.err").write_text(traceback.format_exc())
        raise


def _sp_spawn(world, tmp, backend):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sp_rank, args=(r, world, f"file://{tmp}/sp_rendezvous{world}",
                                                tmp, backend)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SP_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errs = "".join(Path(tmp, f"sp_rank{r}_{world}.err").read_text() for r in range(world)
                   if Path(tmp, f"sp_rank{r}_{world}.err").exists())
    if hung:
        raise AssertionError(f"sp: ranks {hung} of {world} did not finish in {SP_TIMEOUT} s"
                             f"\n{errs}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"sp: rank exit codes {codes} of {world}\n{errs}")
    return [json.loads(Path(tmp, f"sp_rank{r}_{world}.json").read_text()) for r in range(world)]


def _sp_ring_check(dev, tmp, ranks):
    """(d)'s blocks against the port's plain attention over the whole
    sequence (``models.layers.attend_reference``, f32), held at
    SP_RING_TOL."""
    from moe_infinity_tpu_torch.models.layers import attend_reference

    q, k, v, q1, tk, tv = _sp_ring_inputs(dev)
    T = q.shape[1]
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    want = attend_reference(q, k, v, pos, T).cpu().numpy()
    kf = torch.cat([k, tk[:, :SP_RING_TAIL]], dim=1)
    vf = torch.cat([v, tv[:, :SP_RING_TAIL]], dim=1)
    S = T + SP_RING_TAIL
    want_dec = attend_reference(q1, kf, vf, torch.full((1, 1), S - 1, dtype=torch.int32,
                                                       device=dev), S).cpu().numpy()
    del q, k, v, kf, vf
    torch.cuda.empty_cache()
    Tl = T // SP_RING
    for r, res in enumerate(ranks):
        got = np.load(Path(tmp, f"d_rank{r}.npz"))
        err = float(np.abs(got["out"] - want[:, r * Tl:(r + 1) * Tl]).max())
        dec_err = float(np.abs(got["dec"] - want_dec).max())
        say(f"[sp] (d) rank {r} of {SP_RING}: ring_attention over {T} tokens ({Tl} a rank, "
            f"H={q1.shape[2]} over {tk.shape[2]} KV heads, f32) against plain attention "
            f"max_abs_err={err:.4e}, the decode merge over the shards and {SP_RING_TAIL} tail "
            f"columns max_abs_err={dec_err:.4e} (held at {SP_RING_TOL:g}); ring {res['ring_s']:.3f} s, "
            f"{res['hop_bytes']} bytes hopped")
        if not (err <= SP_RING_TOL and dec_err <= SP_RING_TOL):
            raise AssertionError(f"sp (d) rank {r}: ring max_abs_err {err:.3e}, decode "
                                 f"{dec_err:.3e} (limit {SP_RING_TOL:g})")


def phase_sp(dev):
    """Phase 44: sequence parallelism (``parallel/sequence.py``,
    ``ops/ring_attention.py``) on two ranks spawned once for three legs, a
    ``file://`` rendezvous, gloo on one card (NCCL with a card a rank): (a)
    ``MoE(..., sequence_parallel=2)`` over Mixtral-8x7B at its published
    width and SP_DEPTH layers (int8 experts from a store written directly
    under SP_DIR), one greedy request of SP_PROMPT tokens (4,096 through
    the ring, 1 through the tail) and SP_NEW new ones, then a request
    shorter than the ring (the resident path); (b) ``SPDecoder`` over
    DeepSeek-V2-Lite at SP_DEPTH layers, SP_MLA_PROMPT tokens and
    SP_MLA_NEW new; (c) ``sp_encode`` over NLLB-MoE-54B's SP_DEPTH encoder
    blocks and one unpadded SP_DOC-token document (K3 first, alone, at one
    rank's MoE layer of (a)'s prefill). Each f32 run is held to
    the one-rank run of the same seed (this process): MESH_TOL through the
    plain grouped FFN, MESH_K3_TOL through K3 (each rank's K3 sees half the
    rows), greedy tokens equal; bf16 is reported. Then (d): the ring itself
    on four ranks, where a hop's direction matters. Returns the ranks' K3
    launches."""
    import shutil
    import tempfile

    n = torch.cuda.device_count()
    backend = "nccl" if n >= 2 else "gloo"
    say(f"[sp] 2 ranks on {min(n, 2)} card(s), backend {backend}"
        + (" (CUDA tensors staged through the host)" if backend == "gloo" else "")
        + f": (a) MoE(sequence_parallel=2) over Mixtral-8x7B at {SP_DEPTH} layers, int8 "
          f"experts, a {SP_PROMPT}-token request and {SP_NEW} new tokens; (b) SPDecoder over "
          f"DeepSeek-V2-Lite at {SP_DEPTH} layers, {SP_MLA_PROMPT} + {SP_MLA_NEW} tokens; (c) "
          f"sp_encode over NLLB-MoE-54B's {SP_DEPTH} encoder blocks, a {SP_DOC}-token document; "
          f"runs {[(str(d)[6:], i) for d, i in SP_RUNS]}; (d) the ring on {SP_RING} ranks")
    _check_disk(SP_DIR.parent, SP_DISK_GB, "44", "sp")
    check_gmm_sp(dev)
    counts = {}
    try:
        t0 = time.perf_counter()
        nbytes = _write_sp_store(SP_DIR, dev)
        say(f"[sp] (a)'s store written directly: {nbytes / 1e9:.2f} GB in "
            f"{time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            one = _sp_references(dev, tmp)
            say(f"[sp] one-rank references: {time.perf_counter() - t0:.1f} s (prefills and "
                "encodes: " + ", ".join(f"{k} {v:.3f} s" for k, v in one.items()) + ")")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = _sp_spawn(2, tmp, backend)
            say(f"[sp] 2 ranks over {backend}: {time.perf_counter() - t0:.1f} s")
            _sp_hold(tmp, ranks, one, counts)
            t0 = time.perf_counter()
            ring = _sp_spawn(SP_RING, tmp, "nccl" if n >= SP_RING else "gloo")
            say(f"[sp] {SP_RING} ranks: {time.perf_counter() - t0:.1f} s")
            _sp_ring_check(dev, tmp, ring)
    finally:
        shutil.rmtree(SP_DIR, ignore_errors=True)
    counts = {k: v for k, v in counts.items() if v}
    say(f"[sp] K3 launches of both ranks' legs {json.dumps(counts)}")
    return counts


def _sp_hold(tmp, ranks, one, counts):
    """Each rank's runs against the one-rank references; adds the ranks'
    launches to ``counts``."""
    for r, res in enumerate(ranks):
        for rd in res["legs"]:
            leg, kind, impl, name = rd["leg"], rd["kind"], rd["impl"], rd["dtype"]
            got = np.load(Path(tmp, f"{leg}_{impl}_{name}_rank{r}.npz"))
            ref = np.load(Path(tmp, f"ref_{kind}_{impl}_{name}.npz"))
            want = ref["out"]
            if leg == "c":  # this rank's block of the encoder output
                Tl = want.shape[1] // 2
                want = want[:, r * Tl:(r + 1) * Tl]
            err = float(np.abs(got["out"] - want).max())
            held = name == "float32"
            tol = MESH_TOL if impl != "pallas" else MESH_K3_TOL
            same = None if leg == "c" else bool(np.array_equal(got["tokens"], ref["tokens"]))
            missing = [k for k in SP_KERNELS if impl == "pallas" and rd["launches"].get(k, 0) <= 0]
            what = {"a": "prefill's last logits", "b": "prefill's last logits",
                    "c": "encoder output"}[leg]
            steps = (f", decode step {rd['step_ms']:.2f} ms ({rd['steps']} steps)"
                     if rd["step_ms"] is not None else "")
            say(f"[sp] ({leg}) rank {r} {name} impl={impl}: {what} (up to "
                f"{np.abs(want).max():.4g}) max_abs_err={err:.4e} ("
                + (f"held at {tol:g}" if held else "reported") + ")"
                + ("" if same is None else f", greedy tokens equal {same}"
                   + (" (held)" if held else " (reported)"))
                + f"; {rd['seconds']:.2f} s, prefill {rd['prefill_tokens']} tokens in "
                  f"{rd['prefill_s']:.3f} s ({rd['tokens_per_s']:.1f} tokens/s; one rank "
                  f"{rd['prefill_tokens'] / one[f'{kind}_{impl}_{name}']:.1f}){steps}, hops sent "
                  f"{rd['hop_bytes']} bytes; launches "
                  f"{json.dumps({k: v for k, v in rd['launches'].items() if v})}")
            if missing or (held and (err > tol or same is False)):
                raise AssertionError(
                    f"sp ({leg}) rank {r} {name} impl={impl}: max_abs_err {err:.3e} (limit "
                    f"{tol:g}), tokens equal {same}, kernels not launched {missing}")
            if not np.isfinite(got["out"]).all():
                raise AssertionError(f"sp ({leg}) rank {r} {name} impl={impl}: not finite")
            counts.update({k: counts.get(k, 0) + v for k, v in rd["launches"].items()})
        short = np.load(Path(tmp, f"a_short_rank{r}.npz"))
        ref = np.load(Path(tmp, "ref_mixtral_ragged_float32.npz"))
        same = bool(np.array_equal(short["tokens"], ref["short"]))
        say(f"[sp] (a) rank {r}: a {SP_SHORT}-token request (shorter than the ring) took the "
            f"resident path: greedy tokens equal {same} (held), hops sent {int(short['hops'])} "
            f"bytes (held at 0)")
        if not same or int(short["hops"]):
            raise AssertionError(f"sp (a) rank {r}: the short request's tokens equal {same}, "
                                 f"hops {int(short['hops'])}")


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    if "--decode-plans" in sys.argv[1:]:
        sweep_decode_plans(dev)
        say(f"[card] {smi}")
        return 0
    if "--gmm" in sys.argv[1:]:
        for r in phase_gmm(dev):
            say(f"[time] {r['name']} ({r['shape']}): ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e}")
        sweep_gmm_plans(dev)
        say(f"[card] {smi}")
        return 0
    if "--mla" in sys.argv[1:]:
        for r in phase_mla(dev):
            say(f"[time] {r['name']} ({r['shape']}): ms={r['ms']:.5f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                f"({r['bound_by']}) library_ms={r['library_ms']:.4f} "
                f"max_abs_err={r['max_abs_err']:.3e}")
        sweep_mla_plans(dev)
        say(f"[card] {smi}")
        return 0

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(dev, *args)
        say(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    extra = {}  # the launches of phases 24-30, by phase
    if "--batchers" in sys.argv[1:]:
        say(f"[check] phase 2's batcher inputs: largest errors "
            f"{json.dumps(check_batcher_attention(dev))}")
        phase_batchers(dev, extra)
        say(f"[batchers] launches by phase {json.dumps(extra)}")
        say(f"[card] {smi}")
        return 0

    if "--stream" in sys.argv[1:] or "--offload" in sys.argv[1:]:
        if "--offload" in sys.argv[1:]:
            timed(phase_offload)
            timed(phase_offload_whole_path)
            timed(phase_offload_spec)
            timed(phase_offload_spec_whole_path)
        r = check_stream_gather(dev)
        say(f"[time] {r['name']} ({r['shape']}): ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) library_ms={r['library_ms']:.4f}")
        say(f"[stream] launches of phases 31 and 32 {json.dumps(timed(phase_stream))}")
        say(f"[card] {smi}")
        return 0
    if "--scan" in sys.argv[1:]:
        scan = {}
        timed(phase_main_path, None, scan)
        timed(phase_mixtral, None, scan)
        timed(phase_deepseek, scan)
        say(f"[scan] launches of phase 41's timed calls {json.dumps(scan)}")
        say(f"[card] {smi}")
        return 0
    if "--mesh" in sys.argv[1:]:
        timed(phase_mesh)
        say(f"[card] {smi}")
        return 0
    if "--pod" in sys.argv[1:]:
        timed(phase_pod)
        say(f"[card] {smi}")
        return 0
    if "--sp" in sys.argv[1:]:
        timed(phase_sp)
        say(f"[card] {smi}")
        return 0
    if "--resident" in sys.argv[1:]:
        timed(phase_main_path)
        timed(phase_mixtral)
        timed(phase_deepseek)
        timed(phase_deepseek_widths)
        say(f"[card] {smi}")
        return 0
    if "--switch" in sys.argv[1:]:
        timed(phase_switch)
        timed(phase_switch_offload)
        timed(phase_switch_whole_path)
        say(f"[card] {smi}")
        return 0
    if "--mixtral-offload" in sys.argv[1:]:
        timed(phase_mixtral_offload)
        timed(phase_mixtral_offload_whole_path)
        timed(phase_deepseek_offload)
        say(f"[card] {smi}")
        return 0
    if "--entrypoints" in sys.argv[1:]:
        timed(phase_entrypoints_and_server)
        say(f"[card] {smi}")
        return 0
    if "--paging" in sys.argv[1:] or "--host-fallback" in sys.argv[1:]:
        if "--paging" in sys.argv[1:]:
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            say(f"[check] OPT-66B's K1 and K2 shapes: largest errors "
                f"{json.dumps(check_opt_attention(g, dev))}")
            say(f"[check] K3 over dequantized slots: largest error "
                f"{check_gmm_dequant(g, dev):.3e}")
            timed(phase_opt)
            timed(phase_opt_whole_path)
            timed(phase_opt_entry)
        if "--host-fallback" in sys.argv[1:]:
            timed(phase_paged_offload)  # phases 37 and 38 on one build
        else:
            b = timed(_paged_offload_build)
            timed(phase_nllb_paged, b)
        say(f"[card] {smi}")
        return 0
    if "--opt27" in sys.argv[1:]:
        errs, _ = check_head_dims(dev)
        say(f"[check] K1, K2 and K4 at other head dims and rep 16: largest errors "
            f"{json.dumps(errs)}")
        say(f"[opt27] launches of phase 45 {json.dumps(timed(phase_opt27))}")
        say(f"[card] {smi}")
        return 0
    if "--loading" in sys.argv[1:]:
        say(f"[loading] launches of phases 39 and 40 {json.dumps(timed(phase_loading))}")
        say(f"[card] {smi}")
        return 0
    if "--grok" in sys.argv[1:] or "--arctic" in sys.argv[1:]:
        if "--grok" in sys.argv[1:]:
            r = check_gmm_fp8(dev)
            say(f"[time] {r['name']} ({r['shape']}): ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
                f"max_abs_err={r['max_abs_err']:.3e}")
            say(f"[check] rep 6 and 7 attention: largest errors "
                f"{json.dumps(check_attention_rep67(dev))}")
            timed(phase_grok)
            timed(phase_grok_entry)
        if "--arctic" in sys.argv[1:]:
            timed(phase_arctic)
        say(f"[card] {smi}")
        return 0
    recs = timed(phase_kernels)
    # the whole run's cuts of earlier paths' steps and requests, for its time
    # limit (each path whole under its flag; PERF.md section 6)
    global SCAN_TOKENS, ARB_PROMPTS, NEW_TOKENS, PARITY_TOKENS, GA_PARITY_STEPS, POD_BLOCKS
    global EP_NEW, DS_REQUESTS, DS_NEW, HF_NEW, ARB_TOKENS
    EP_NEW, DS_REQUESTS, DS_NEW = WHOLE_RUN_EP_NEW, WHOLE_RUN_DS_REQUESTS, WHOLE_RUN_DS_NEW
    HF_NEW, ARB_TOKENS = WHOLE_RUN_HF_NEW, WHOLE_RUN_ARB_TOKENS
    SCAN_TOKENS, ARB_PROMPTS = WHOLE_RUN_SCAN_TOKENS, ARB_PROMPTS[:WHOLE_RUN_ARB_REQUESTS]
    NEW_TOKENS, PARITY_TOKENS = WHOLE_RUN_NEW_TOKENS, WHOLE_RUN_PARITY_TOKENS
    GA_PARITY_STEPS, POD_BLOCKS = WHOLE_RUN_GA_STEPS, WHOLE_RUN_PARITY_BLOCKS
    scan = {}  # phase 41's launches, by model
    counts = timed(phase_main_path, extra, scan)
    timed(phase_whole_path)
    mix_counts = timed(phase_mixtral, extra, scan)
    timed(phase_mixtral_whole_path)
    mla_counts = timed(phase_deepseek, scan)
    timed(phase_deepseek_whole_path)
    widths_counts = timed(phase_deepseek_widths)  # phase 46
    off_counts = timed(phase_offload)
    timed(phase_offload_whole_path, WHOLE_RUN_PARITY_SEEDS)
    spec_counts = timed(phase_offload_spec, extra)
    timed(phase_offload_spec_whole_path, WHOLE_RUN_PARITY_SEEDS)
    # phases 31-33, after phase 9's tier is released
    st_counts = timed(phase_stream, WHOLE_RUN_PARITY_BLOCKS, WHOLE_RUN_DIRECT)
    _free_host_cache()  # the NLLB tier's page-locked memory, before Switch's
    extra["phase_s2s_batchers_whole_path"] = timed(phase_s2s_batchers_whole_path,
                                                   WHOLE_RUN_PARITY_BLOCKS) or {}
    sw_counts = timed(phase_switch, extra)
    sw_off_counts = timed(phase_switch_offload)
    timed(phase_switch_whole_path)
    _free_host_cache()
    mx_off_counts = timed(phase_mixtral_offload, MX_WHOLE_RUN_DEPTH, MX_WHOLE_RUN_TOKENS)
    timed(phase_mixtral_offload_whole_path)
    ds_off_counts = timed(phase_deepseek_offload)
    ep_counts = timed(phase_entrypoints_and_server)
    gk_counts = timed(phase_grok)
    ac_counts = timed(phase_arctic, extra)
    ge_counts = timed(phase_grok_entry)
    extra["phase_switch_entry"] = timed(phase_switch_entry)
    _free_host_cache()
    extra["phase_opt"] = timed(phase_opt, OPT_WHOLE_RUN_DEPTH)  # phases 34-38: past the card
    timed(phase_opt_whole_path)
    extra["phase_opt_entry"] = timed(phase_opt_entry)
    extra["phase_opt27"] = timed(phase_opt27)  # phase 45
    extra["phase_paged_offload"] = timed(phase_paged_offload)
    extra["phase_loading"] = timed(phase_loading, WHOLE_RUN_LOAD_REQUESTS)  # phases 39-40
    mesh_counts = timed(phase_mesh)  # phase 42: the ranks' launches
    pod_counts = timed(phase_pod)  # phase 43: the ranks' launches
    sp_counts = timed(phase_sp)  # phase 44: the ranks' K3 launches
    say(f"[batchers] launches by phase {json.dumps(extra)}")
    say(f"[scan] launches of phase 41's timed calls {json.dumps(scan)}")
    say(f"[run] the whole run: {time.perf_counter() - START:.1f} s, the build included")
    for r in recs:
        r["launches"] = sum(c.get(r["name"], 0) for c in (
            counts, mix_counts, mla_counts, widths_counts, off_counts, spec_counts, st_counts,
            sw_counts,
            sw_off_counts, mx_off_counts, ds_off_counts, ep_counts, gk_counts, ac_counts, ge_counts,
            *extra.values(), *scan.values(), mesh_counts, pod_counts, sp_counts))
        r.pop("shape")
    say(f"[card] {smi}")
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
