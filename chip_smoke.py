#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed 0]

Two kernels. ``cache_sim`` has seven programs, entry points of six CUDA
sources: ``cache_sim`` (lru, lfu, plfu, plfua), ``cache_sim/wlfu``,
``cache_sim/tinylfu`` (with or without the doorkeeper),
``cache_sim/plfua_dyn``, ``cache_sim/sized`` (gdsf, and lru/lfu/plfu/plfua/
gdsf under a byte budget), ``cache_sim/plfua_dyn_bytes`` (plfua_dyn under a
byte budget, from ``plfua_dyn.cu``) and ``cache_sim/arc``; every program but
``cache_sim/arc`` takes its victims from a heap of the residents in shared
memory (``kernel.heap_plan`` says where a call puts its heap slots, rows,
sketch and hot mask), ``cache_sim/arc`` from the heads of its four lists kept
in stamp order (``kernel.arc_plan``: its tags and links). ``flash_attention``
(``csrc/flash_attention.cu``) has two instances, ``flash_attention/prefill``
(bf16: wgmma on TMA-staged tiles of 128 query rows; f32: CUDA cores) and
``flash_attention/decode`` (a kv head's query rows a block, its keys split over
blocks and merged by the last one), each at D = 16, 32, 64, 128 and 192.
Two main paths: the paper's grid through cache_sim, and the serving path
(smollm-360m at full width behind the content cache, every attention call
through the flash kernel; deepseek-v2-236b at its published widths, cut to 4
layers, every MLA prefill through the kernel at D = 192; rwkv6-7b and
jamba-1.5-large-398b at theirs, cut to 4 and 5 layers, jamba's attention
layer through the kernel at D = 128; whisper-large-v3 and
llava-next-mistral-7b at full width and depth through ``Model.prefill`` and
``decode_step``, every attention call through the kernel); training
(smollm-360m at full width and depth, phase 19c) runs no kernel; the fleet, placed and hierarchy phases drive the
N-tier fleet engines, which step the plain PyTorch policies (no kernel of
their own), and the fleet front serves the model behind a tree of content
caches. Phases, one line each (or one line per item):

1. device  — the card's name and count, and ``nvidia-smi``'s name and power limit.
2. build   — nvcc builds the six cache_sim sources and the flash source from
             ``src/repro_torch/kernels/*/csrc``, one process each, all started
             together (the flash source's kernels optimised on every core,
             ``--split-compile``); the grid's CPU references (phase 4) and the
             shard phase's world (10b) start before it, as neither needs a
             kernel; prints ptxas's register, shared-memory, stack and spill
             report for each kernel (no spill stores allowed in any cache_sim
             instance; the D = 192 flash kernels' registers and spill stores
             on lines of their own), and the count of HGMMA (wgmma)
             instructions in each bf16 prefill kernel's SASS (``cuobjdump``),
             which must be > 0.
3. check   — each program against its plain PyTorch version, exact on hits,
             freq, in_cache, inserts and (sized runs) hit bytes, at S = 12:
             lru/lfu/plfu/plfua at (N, cap, T) = (100, 2, 10,000), (10,000,
             200, 10,000), (46,416, 4,225, 17,500) and (100,000, 2,000,
             6,000); wlfu, tinylfu
             without and with the doorkeeper, and plfua_dyn at (10,000, 200,
             20,500), (100,000, 2,000, 6,500) and a small case with explicit
             window, sketch width, refresh and hot-set size; gdsf with the
             lognormal catalogue, and lru/lfu/plfu/plfua/gdsf/plfua_dyn under a byte
             budget with the lognormal and the pareto catalogue, at (10,000,
             200) with T = 10,000 and (100,000, 2,000) with T = 6,000 (gdsf)
             and 5,000 (the byte programs); a max_victims=2 case
             whose bound is hit (T = 10,000); arc at (100, 2) with T = 20,000,
             (10,000, 200) with T = 10,000 and (100,000, 2,000) with T = 6,000
             (5,000 on scan) on Zipf and scan traces, its directory size
             included. Each check at N >= 46,416 runs at 5,000 or at the least
             T at which each of its samples evicts (seed 0), and must evict in
             every sample (``hold_depth``; plfua and plfua_dyn, whose admission
             gates never fill the cache there, run at 5,000 and must turn a miss
             away in every sample instead), as must the sized and arc checks at
             N = 10,000 (cut from 20,000); lfu, gdsf,
             wlfu, plfua_dyn, arc and tinylfu at the grid's largest heap
             (100,000, 25,000), each a full cache evicting 1,000 times a sample
             or more: lfu, gdsf and wlfu on a scan trace of 32,000 requests
             that fills it and evicts 1,693 times a sample or more, plfua_dyn
             on a scan of 36,000 (it fills later) with 97,000 hot ids and a
             refresh every 9,000 requests (four refreshes, each with churn,
             read from its telemetry instance on the same traces), arc on a
             scan of 32,000 (about 1,700 demotions), and tinylfu, whose duel
             turns a scan away, on a sweep over 26,800 ids and 1,600 of the
             turned-away ids twice each.
             Each heap program's line names its heap plan, arc's its tags' and
             links' places. With unit
             sizes and capacity_bytes == capacity each byte program must give
             the object-count program's outputs. Then phase 7's telemetry
             checks. The plain version runs on the card for N = 100,000, in
             four card worker processes beside the shard phase's world (10b),
             the largest heap's first (the longest), and in seven CPU worker
             processes for N <= 46,416, overlapping the card's work; each
             check's line gives its plain run's wall seconds.
4. grid    — ``simulate.run_grid``: the paper's 60 cases x 12 samples x 100,000
             requests for the seven object-count kinds, gdsf with the
             byte-capacity catalogue, arc, and gdsf under the byte budget, and
             the N = 100,000 row under the byte budget for lru/lfu/plfu/plfua/
             plfua_dyn, with every program's launch count set to 0 just before
             and read just after; the smallest case of each full-grid row is
             held to the same case run by the plain version on the CPU, and
             plfu's CHR must beat lfu's.
5. scan    — lru, lfu, arc and tinylfu (doorkeeper 256) on ``scan`` traces and
             their stationary base (N = 6,000, cap = 300, 8 x 50,000, seed 33,
             6 sweeps of 6 %): each CHR and the scan cost; arc must beat lru
             and lfu on scan, as the JAX reference does at this setting.
   profile — ``telemetry.timing.measure`` over plfua's grid row's N = 100,000
             cases (its largest 6 of 60) with ``profile_dir``: the device's
             idle share between launches over those cases, from the
             ``torch.profiler`` trace and from CUDA events.
6. measure — each program at N = 100,000, cap = 2,000, S = 12, T = 100,000
             (``cache_sim`` through lfu, ``cache_sim/sized`` through gdsf and
             both byte programs under the byte budget of 2,000 objects of mean
             size): the kernel's time from CUDA events after a warm-up, the
             plain version's time once at T = 2,500 (the kernel is held to it
             there), and the least time the card could take (bound: the bytes
             moved, or the operations the function needs, see ``bound``); the
             µs a request of a sample's chain, and for the heap programs the
             heap's slots and where its slots, rows, sketch (tinylfu,
             plfua_dyn) and hot mask (plfua_dyn) lie, for arc where its tags
             and links lie.
7. telemetry — each program's two telemetry instances (``+telemetry`` and
             ``+telemetry_grouped``, W = T // 16, 4 tenant groups): checks (run
             in phase 3), exact against the plain version, ungrouped on Zipf and
             grouped on ``multi_tenant`` traces, at (10,000, 200) with T = 5,000
             (plain in the CPU workers; every sample evicts), at (100,000,
             2,000) with T = 2,500 (plain in the card workers), and W = 1 and
             W > T at (130, 3), T = 2,010 (a partial plfua_dyn period), and
             grouped at capacity 0 and -3 for wlfu, tinylfu, plfua_dyn (7 hot
             ids) and arc at (130, T = 2,010) and (10,000, T = 5,000), where the
             first victim is id 0 while it is not cached; then the telemetry
             path at the measured case (T = 100,000) through
             ``ops.cache_sim_outputs``,
             with the launch counts set to 0 just before and read just after:
             primary outputs equal the instance without telemetry's, the hits
             column sums to the hit count, requests equal the window sizes, and
             the grouped series summed over the groups equals the ungrouped;
             then, on the multi_tenant traces, each instance's time between
             two telemetry-off times (in turns: off, ungrouped, grouped, off)
             and its ratio to their mean (on/off), and its plain version's time
             alone on the card over the traces' first 500 requests (the kernel
             held to it there).
8. fleet   — the fleet modules (one line per item): ``workloads.device``'s six
             generators on the card at the fleet benchmark's size (N = 10,000,
             8 x 100,000; ms each), held there to their contracts (range,
             determinism, seed sensitivity, independent samples, the Zipf head, a
             sample made alone equal to its row, each scenario's own shape);
             ``cdn.router.route_level`` on the card for the three modes,
             bit-identical to numpy's; the level-major fleet on
             ``benchmarks/fleet_bench.py``'s topology (8 edges -> 2 regionals ->
             1 root, capacities 300 / 1,200 / 2,400, hash router) for all nine
             kinds on host ``stationary`` traces (8 x 20,000: T cut from
             100,000 to the depth at which the caches fill), every sample held
             exactly to the port's oracle in the CPU workers (per-level hits,
             final contents, per-node hits and evictions, origin misses), every
             edge of every sample evicting and every upper level hitting for the
             kinds without an admission gate (some node evicting for plfua,
             plfua_dyn and tinylfu); plfua_dyn on ``churn`` made and routed on
             the card (8 x 20,000), its refreshes on global time (6 of its
             edges' before the last request); tinylfu with grouped telemetry on
             ``multi_tenant`` (4 groups, W = T // 16), equal to the run without
             telemetry and to the CPU run, its groups summing to the ungrouped
             series, every level's series evicting and the cross-tenant
             pressure > 0. Each line prints per-level CHR and evictions, origin
             misses, ``fleet_report``'s management energy, ms a request and the
             device's idle share (``timing.profile`` over the first 300
             requests). Then the paper's CPU time: ``simulate.run_trace`` for
             lfu, plfu and plfua at N = 100,000, cap = 2,000, one 100,000-request
             sample, beside the kernel's device seconds on it (equal hits).
9. placed  — the time-major placed engine (one line a run): ``fleet_bench.py``'s
             placement sweep at its full width (plfu on the fleet topology,
             N = 10,000, capacities 300 / 1,200 / 2,400, hash router, 4
             ``stationary`` samples of 13,500) under lcd, prob(0.5), admit and
             prob(1.0); gdsf under byte budgets (the byte benchmark's lognormal
             catalogue, each capacity x the mean size) with admit and ungrouped
             telemetry, on the first 5,500 requests of the samples; the mixed
             tree (lru / plfua_dyn / plfua_dyn under lcd / admit / prob(0.5),
             periods 3,000 and 4,500: chunks of 1,500) on ``churn`` made and
             routed on the card, 4 x 9,000, with telemetry.
             Every sample equals the oracle (CPU workers), every run the same
             call on the CPU, prob(1.0) the level-major lce call bit for bit;
             the levels ``PLACED_EVICTING`` names evict in every sample and the
             admit levels ``PLACED_REFUSING`` names turn a fill away in every
             sample; the mixed tree's levels refresh 3 and 2 times. Each line:
             per-level CHR and evictions, origin misses, ``fleet_report``'s
             management and placement J, ms a request, the idle share and the
             kernels a position over the first 300 positions
             (``torch.profiler``), the fills each level turned away. Then
             lcd's management-J saving and ΔCHR against prob(1.0) (not gated).
10. hierarchy — ``cdn_bench.py``'s full two-tier topology (4 edges at 300, a
             parent at 1,200, N = 10,000, hash) for plfua, plfua_dyn and
             tinylfu on 8 ``churn`` samples of 20,000: each sample equal to
             ``cdn.simulate_hierarchy_reference`` (CPU workers), the parent
             evicting; ``hierarchy_report``'s edge, parent and total CHR and
             management J; plfua_dyn's total CHR against plfua's (not gated).
10a. stream — the streaming engine (``fleet.FleetStream``): the fleet
             phase's lru, plfua_dyn churn (+telemetry, refreshes inside chunks
             on gcd sub-chunks) and tinylfu grouped runs (sample 0, T =
             20,000) as 8 chunks of 2,500, and the placed phase's plfu admit run
             (sample 0, T = 13,500) as 9 chunks of 1,500, each bit for bit its
             bounded call's sample 0 (hits, node hits, counters, states, origin
             misses, stitched series) and equal to that sample's oracle; the
             fast compact-lane rows of ``benchmarks/stream_bench.py`` (lru and
             tinylfu at N = 2**16, capacity 2**12, 18 chunks of 1,024, seeds 40
             and 41; plfua_dyn with a refresh of 4 chunks, 8 chunks) through
             ``stream_fleet`` (the next chunk generated on a side CUDA stream),
             each equal to the cache_sim program on its concatenated chunks
             (hits, ``in_cache``, freq or stamps, inserts), lru and tinylfu
             evicting; the acceptance width (N = 2**20, capacity 2**16, 8
             chunks of 2,048) timed, and the 10**8-request row extrapolated
             from it. Each line: ms a chunk, µs a request, requests/s, kernels
             a chunk and the idle share over the first chunk (``torch.profiler``,
             CUDA activity only), J a request (the CPU-core model, and at the
             power limit, an upper bound).
10b. shard — a gloo world of 2 ranks (``python3 chip_smoke.py --shard-rank R``,
             ``init_method=file://build/shard/init``, each rank on cuda:0, a
             card operand of a collective staged through the host) started
             before the build, beside it and phase 3's checks, under a 420 s
             deadline that kills it: the
             edge-sharded level-major run (plfu, the fleet phase's sample 0),
             the edge-sharded placed run (plfu admit, the placed phase's sample
             0; one all-reduce a position) and the sample-sharded run (plfua_dyn
             on the fleet phase's churn, 4 samples a rank), every rank's whole
             result bit for bit the single-process call's. One card shows only
             that the paths are correct.
11. flash check — the flash kernel against its plain version (the naive
             oracle, query rows in chunks of 1,024) on the card, TF32 off, each
             case in float32 (atol = rtol = 2e-5) and bfloat16 (atol 1e-4,
             rtol 2**-7: one rounding of the output): tests/test_kernels_flash.py's
             8 SWEEP rows and its kv_len = 100 case with garbage past it; the
             edges of the prefill tiles and the decode splits (tests/test_torch_cuda.py's
             FLASH_EDGES); the served shapes (1, 15, 5, 64): causal prefill at
             2,048 and 16,384, decode against a cache of 2,056 at kv_len 1,
             2,049 and 2,056; a D = 128 prefill (1, 24, 8, 1,024); at D = 192
             (MLA) a SWEEP row (1, 4, 4, 130), a 12-row causal prompt on the
             decode instance and deepseek's served prefill (1, 128, 128,
             2,048, causal); jamba's attention layer (1, 64, 8, 128): causal
             prefill at 2,048, decode against a cache of 2,056 at kv_len 1,
             2,049 and 2,056; whisper's (1, 20, 20, 64): the encoder's
             non-causal prefill over 1,500 frames, cross-attention from 4 and
             128 rows over the 1,500-frame source (non-causal, Sq != Skv, a
             partial last key tile), the cross decode at kv_len 1,500, the
             decoder's causal prefill at 4 and 128 and its decode against the
             self cache of 448; llava's (1, 32, 8, 128): causal prefill at
             2,048 and decode against 2,056 at kv_len 2,049 and 2,056. For each
             served case it also reads deliberately wrong plain versions (the
             causal bound one 64-key tile early, and in bf16 p rounded to bf16
             before P V; a non-causal case with one live key dropped, read
             causally, and without its last partial tile of 64 keys, or with
             one garbage key let in at kv_len 1) against the same tolerance,
             which must reject each, and prints what the former 2e-2 tolerance
             read for them.
12. serve  — smollm-360m at full width (32 layers, d_model 960, 15 heads, 5 KV
             heads, ~409 M parameters), weights from ``--seed`` through
             ``Model.init``, bf16 compute: the reference launcher's traffic (20
             objects, 40 requests from ``zipf.sample_trace(20, 40, seed=1)``)
             with 2,048-token prompts, max_new = 8, cache_len = 2,056, through
             a cold engine and one behind ``ContentCache(5, "plfua")``, then one
             16,384-token request (past the chunk threshold, max_new = 4); the
             flash counts set to 0 just before and read just after. Checks: cold
             and warm tokens equal, warm computed + saved = cold computed, the
             launches = 32 x (prefills + decode steps) by instance. Then its
             traffic priced by ``energy.serving_energy`` (CHR, the content
             cache's management CPU seconds) at the card's power limit and the
             H100 SXM's data-sheet bf16 peak (989 TFLOP/s).
13. fleet front — the same model behind ``FleetContentCache.from_topology``
             (2 edges -> 1 parent, lru at 2 / 4 objects, lcd): 12 requests over
             6 objects (``zipf.sample_trace(6, 12, seed=4)``), 2,048-token
             prompts, max_new = 8; its tier stats equal a model-free replay of
             the same lookups and offers through a second front, each hit's
             tokens equal its object's first serve's, and the flash launches
             are 32 x (prefills + decode steps), counted from 0.
14. serve check — one request (prompt 128, max_new = 4) on the card and on the
             CPU (the plain path, the same weights, fed the card's tokens):
             every step's logits within 0.125, tokens equal where the top-2
             margin exceeds it.
15. measure — the flash kernel at the served shapes (causal prefill 2,048;
             decode at kv_len 2,056) with its bound, plain version and
             ``scaled_dot_product_attention`` (timed only), each timed on the
             device with the host ahead (``torch.cuda._sleep`` holds the
             device until all 50 calls are queued) beside the host's µs a
             call and the old back-to-back figure; the prefill at 16,384 and
             the decode's grid (blocks, rows a block) too; the engine's
             prefill ms and tokens/s, decode ms a token, J a generated token at
             the power limit, and the device's busy time and idle share over
             one prefill and one request's decode (``torch.profiler``).
16. moe serve — smollm's model freed, deepseek-v2-236b at its published
             widths (d_model 5,120, 128 heads, MLA q/kv lora 1,536/512, nope/
             rope/v 128/64/128, 160 routed experts top-6 and 2 shared, expert
             d_ff 1,536, dense d_ff 12,288, vocab 102,400, bf16) cut to 4 of 60
             layers (the dense first layer and 3 MoE layers; 13,302,903,808
             parameters), weights from ``--seed``: 8 requests over 4 objects
             (``zipf.sample_trace(4, 8, seed=1)``), 2,048-token prompts,
             max_new = 8, behind ``ContentCache(2, "plfua")``, the flash counts
             set to 0 just before and read just after (prefill launches = 4
             layers x misses, no decode launch: MLA's decode runs on the latent
             cache in PyTorch); hits generate their first serve's tokens. Then
             prefill ms, decode ms a token beside the bytes of weights a token
             reads (the capacity buffers read every expert), and the device's
             idle share over one decode token (``torch.profiler``).
17. moe check — the served model's first 2 layers (dense + 1 MoE) on the card
             and on the CPU (the plain path, the same weights, fed the card's
             tokens), a 256-token prompt and 4 decode steps: every prompt
             position's and each step's logits within 0.25 where the two sides'
             routing agrees (read through the route step by a separate pass),
             the count of tokens routed differently; the experts' w_gate and
             w_up swapped must be rejected. Then the flash kernel at MLA's
             prefill shape, measured as in phase 15.
18. ssm serve — each model freed before the next: rwkv6-7b (32 layers,
             d_model 4,096, 64 heads of 64, d_ff 14,336, vocab 65,536; f32
             masters, bf16 compute) cut to 4 of 32 layers (1,411,584,000
             parameters), and jamba-1.5-large-398b (d_model 8,192, 64 / 8 heads
             of 128, Mamba d_inner 16,384, d_state 16, d_conv 4, dt_rank 512, 16
             experts top-2 on the odd layers, d_ff 24,576, vocab 65,536, bf16)
             cut to 5 of 72 layers (Mamba layers 0-3, 1 and 3 MoE, and the
             attention layer 4: 24,045,707,264 parameters, 48.1 GB), weights
             from ``--seed``, each served as phase 16 serves deepseek (8
             requests over 4 objects, 2,048-token prompts, max_new = 8,
             ``ContentCache(2, "plfua")``), the flash counts set to 0 just
             before and read just after: jamba's launches = 1 attention layer x
             (prefills + decode steps), rwkv6's none; hits generate their first
             serve's tokens. Then prefill ms and tokens/s, decode ms a token
             beside the bytes of weights a token reads (jamba's capacity
             buffers read all 16 experts of both MoE layers) and their bound,
             the decode state a request holds (the content cache's payload),
             the idle share over one decode token and one prefill, and one SSM
             mixer alone at 2,048 tokens: ms, kernels (its loop launches 2 a
             token) and the recurrence's launches a prefill.
19. ssm check — the card against the CPU's plain path, the same weights with
             the SSM parameters (RWKV's bonus u and decay base, Mamba's A, dt
             bias and conv taps) drawn anew at a trained model's scale, a
             256-token prompt and 4 decode steps, the CPU fed the card's
             tokens: rwkv6's first 2 layers, every logit within 0.25 and
             tokens equal at a clear margin, and its decode without the bonus u
             rejected; jamba one layer at a time, layers 0 (Mamba + dense), 1
             (Mamba + MoE) and 4 (attention + dense), every sublayer kind (each
             CPU layer fed the card's input to it, its own cache; the outputs
             read through ln_f and the unembedding, within 0.25; a MoE layer
             where both sides' routing and drops agree; the card's entry points
             over all 5 layers equal to its layer by layer run), each checked
             Mamba layer's decode with its conv carry zeroed rejected. Then the
             flash kernel at jamba's prefill and decode shapes, measured as in
             phase 15.
19a. whisper — whisper-large-v3 at full width and depth (32 encoder and 32
             decoder layers, d_model 1,280, 20 / 20 heads of 64, d_ff 5,120,
             vocab 51,866, f32 masters, bf16 compute; 1,600,990,720
             parameters), weights from ``--seed``: 4 requests of 1,500 frames
             (``enc_embeds`` drawn from the seed), decoder prompts of 4, 4, 4
             and 128 tokens, 16 new tokens each, greedy through
             ``Model.prefill`` and ``decode_step`` (no serving path takes
             ``enc_embeds``), the flash counts set to 0 just before and read
             just after: 32 x 3 a request (encoder, self and cross prefill; a
             4-row prompt runs the decode instance) and 64 a decode step, by
             instance. Then prefill ms (encoder + prompt), decode ms a token
             beside the bytes a token reads, J a token at the power limit, the
             idle share over one decode token. Check: the first 2 encoder and 2
             decoder layers on the card and on the CPU (the card's bf16
             compute copies; the plain path, fed the card's tokens), the
             whole source, a 4-token prompt and 4 decode steps, the logits
             within 0.125; a causal encoder must be rejected. Then the kernel
             at the encoder's, the 128-row cross prefill's and the cross
             decode's shapes, measured as in phase 15.
19b. llava — llava-next-mistral-7b at full width and depth (32 layers, d_model
             4,096, 32 / 8 heads of 128, d_ff 14,336, vocab 32,000, rope
             theta 1e6, f32 masters, bf16 compute; 7,241,732,096 parameters,
             43.5 GB with the bf16 copies): 4 requests of 1,152 prefix
             embeddings (drawn from the seed at 0.02) and 896 text tokens,
             cache_len 2,056, 8 new tokens at positions after the prefix;
             flash launches = 32 x (prefills + decode steps); the same
             figures. Check: the first 2 layers, the prefix and 128 text
             tokens, 4 decode steps, within 0.125; the text without the prefix
             (at positions 0...) must be rejected. Then the kernel at its
             prefill and decode shapes.
19c. train — training on the card (``repro_torch.train``, eager PyTorch, no
             kernel: the flash kernel has no backward, so a forward that
             autograd records takes the plain attention). (a) smollm-360m at
             full width and depth (32 layers, 409,007,040 parameters, f32
             masters, bf16 compute, each layer rematerialised), weights from
             ``--seed``, 60 steps of ``make_train_step`` on
             ``ZipfBigramStream`` batches of 8 x 512 tokens (AdamW, lr 1e-3, 5
             warm-up steps), the flash counts set to 0 just before and read
             just after (0): the last 10 steps' mean loss at least 0.5 under
             the first 10's; the step's median ms over steps 11-60, tokens/s,
             the model's FLOPs a step (6 N tokens + attention) and their share
             of 989 TFLOP/s, J a token at the power limit, the kernels and the
             idle share over one step, the peak memory. (b) a ``Trainer`` at
             full width on 2 of 32 layers (8 x 128 tokens) to step 20 with a
             checkpoint every 10 in a temporary directory, then a new one that
             must print ``resumed from step 20`` and stop at 30 after 10 steps;
             the newest checkpoint restored onto the CPU equal to the card's
             state bit for bit; its bytes, save and restore seconds. (c) those
             2 layers' loss and every gradient on one batch (2 x 256) on the
             card and the CPU's plain path (bf16 compute on both): within 0.02
             and a relative L2 of 0.05; non-causal attention must be rejected.
             (d) ``launch.train.main`` in process, 4 steps of the reduced
             config on the card.
20. kernels — a ``[phases]`` line (each phase's seconds), then one JSON
             line, an entry per kernel instance, with the trace
             lengths of cache_sim's time (``T``) and plain version's
             (``plain_T``) and the flash instances' shapes (the D = 192 prefill,
             jamba's D = 128 prefill and decode, and whisper's and llava's
             shapes their own entries).

The last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before it; without a card the script exits 1 and prints no result. Every line
is flushed as it is printed, so that a run cut off shows how far it got.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import cdn, fleet, serving  # noqa: E402
from repro_torch._device import card_info  # noqa: E402
from repro_torch.cdn import router  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import energy, policies, simulate, sketch, torch_cache, zipf  # noqa: E402
from repro_torch.kernels.cache_sim import cache_sim as kernel  # noqa: E402
from repro_torch.kernels.cache_sim import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as flash  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, build, moe, ssm, transformer, whisper  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.telemetry import spec as telemetry_spec  # noqa: E402
from repro_torch.telemetry import timing  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train.data import DataConfig, ZipfBigramStream  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.workloads import device as device_workloads  # noqa: E402
from repro_torch.workloads import generators  # noqa: E402

BASE_KINDS = ("lru", "lfu", "plfu", "plfua")
ADMISSION_KINDS = ("wlfu", "tinylfu", "plfua_dyn")
KINDS = BASE_KINDS + ADMISSION_KINDS
BYTE_KINDS = kernel.BYTE_CAPABLE_KINDS
SAMPLES = 12
# The checks whose plain version runs on the card (N > CPU_PLAIN_MAX_N) were cut in depth from T =
# 10,000: each runs at 5,000 or, where that does not evict in every sample, at the least T (on a
# grid of 250; seed 0) that does, and ``hold_depth`` holds it to that. Of those whose plain version
# runs in the CPU workers, the sized and arc checks at N = 10,000 were cut from 20,000 to 10,000 and
# the small telemetry case from 10,000 to 5,000 (each evicts 38 times a sample or more there, seed
# 0), also held by ``hold_depth``.
# (N, cap, T): the base program's checks, at T = 10,000 (cut from 20,000) where N <= 10,000; at
# N = 100,000, 6,000; at N = 46,416, 17,500 (raised from 10,000, where it evicted in no sample:
# 2,788-2,885 distinct ids for 4,225 slots)
BASE_CHECK_CASES = ((100, 2, 10_000), (10_000, 200, 10_000), (46_416, 4_225, 17_500), (100_000, 2_000, 6_000))
# (N, cap, T, explicit options): the admission programs' checks; at N = 100,000 6,500, the least at
# which tinylfu evicts in every sample (with and without its doorkeeper; wlfu from 6,000); plfua_dyn's
# refresh there is checked by the largest-heap case
ADMISSION_CHECK_CASES = (
    (10_000, 200, 20_500, {}),
    (100_000, 2_000, 6_500, {}),
    (130, 3, 2_000, dict(window=33, refresh=50, sketch_width=96, hot_size=7)),
)
# (N, cap, T of gdsf's object-count program, T of the byte programs): the sized checks; at N = 100,000
# gdsf first evicts in every sample at 6,000, and the byte programs (from 1,250-1,750) run at the
# cut's 5,000; at N = 10,000 both at 10,000 (1,543 evictions a sample or more)
SIZED_CHECK_CASES = ((10_000, 200, 10_000, 10_000), (100_000, 2_000, 6_000, 5_000))
#: the max_victims and unit-size checks, at N = 10,000: max_victims=2 still binds on the pareto case
SIZED_CHECK_LEN = 10_000
# (N, cap, T on Zipf, T on scan): arc's checks; at N = 10,000 10,000 on both (3,078 evictions a
# sample or more); at N = 100,000 on Zipf 6,000, on scan 5,000 (760 evictions a sample or more)
ARC_CHECK_CASES = ((100, 2, 20_000, 20_000), (10_000, 200, 10_000, 10_000), (100_000, 2_000, 6_000, 5_000))
#: the kinds whose caches never fill in those checks (seed 0): their admission gate lets in only the
#: hot set, fewer of whose ids arrive within T than the cache has slots (plfua at N = 46,416 up to T
#: = 20,000 and at N = 100,000 up to 12,000; plfua_dyn at N = 100,000 up to 12,000), so no sample
#: evicts at any depth these checks have run at; each sample must turn misses away instead, at the
#: cut's T = NEVER_FULL_LEN
NEVER_FULL_KINDS = ("plfua", "plfua_dyn")
NEVER_FULL_LEN = 5_000
#: (N, cap, T, scan options): the grid's largest heap (25,000 slots, 200,000 B of shared
#: memory) and arc's largest lists, filled by one sweep over 95 % of the trace and then evicting;
#: T cut from 36,000 (about 5,000 evictions a sample) to 32,000, the least thousand at which lfu,
#: gdsf and wlfu evict 1,000 times or more in every sample (1,693 at least; 888 at 31,000; seed 0)
HEAP_CHECK_CASE = (100_000, 25_000, 32_000, dict(n_sweeps=1, sweep_len_frac=0.95))
#: in the order of their plain runs' length on the card, longest first: the program checks hand the
#: card workers their plain runs in the order they are made, and these come first
HEAP_CHECK_KINDS = ("arc", "plfua_dyn", "lfu", "gdsf", "wlfu", "tinylfu")
#: plfua_dyn's options there: its default hot set (ids below 2 x 25,000) would turn the sweep
#: over [50,000, 100,000) away, and its default refresh (250,000) would never fire; with 97,000
#: hot ids every sample fills the cache and evicts 1,955 times or more, and a refresh every
#: 9,000 requests fires four times, each changing the hot set (seed 0). It fills its heap more
#: slowly than lfu (24,454 residents at 33,000), so it keeps its own scan of T = 36,000
PLFUA_DYN_HEAP_OPTIONS = dict(hot_size=97_000, refresh=9_000)
PLFUA_DYN_HEAP_CHECK_LEN = 36_000
#: arc's largest-lists check on a scan of T = 32,000: its plain version takes about 1.3 ms a step
#: on the card, and this depth still demotes about 1,700 times a sample (843 at least at 31,000)
ARC_HEAP_CHECK_LEN = 32_000
#: tinylfu's duel turns a one-touch sweep away (9 evictions a sample on the scan above), so its
#: largest-heap trace sweeps 26,800 ids (the last 1,800 turned away) and then requests 1,600 of
#: those twice each (T = 30,000, cut from 31,500: 27,500 swept, 2,000 twice): the first wins its
#: duel on a count of 2 and evicts, the second hits, so that the newcomer is not the next victim;
#: 1,150 evictions a sample at least (885 with 26,500 swept; seed 0)
TINYLFU_RESWEEP = (26_800, 25_000, 1_600)
#: the grouped telemetry checks at capacity <= 0 (the first victim is id 0, not cached): the
#: programs whose victims once came from a block-wide scan, at the edge case's shape and
#: options and at the small check case's (plain in the CPU workers)
ZERO_CAPACITIES = (0, -3)
ZERO_CAPACITY_KINDS = ("wlfu", "tinylfu", "plfua_dyn", "arc")
#: the largest N whose checks keep their depth: above it the depth rules (``check_len``,
#: ``hold_depth``) apply, set when those checks' plain versions all ran on the card
CPU_PLAIN_MAX_N = 10_000
#: the least N whose check's plain version runs on the card (in the card workers), below it in the
#: CPU workers: a card worker shares the card with three others, the shard world and the main
#: process, and its step then takes about 3 ms at N = 46,416, where the CPU's takes 1.6 ms
CARD_PLAIN_MIN_N = 100_000
CPU_WORKERS = 7
#: the CPU workers' niceness: while the check phase runs the card workers and the shard world on
#: the host's 8 cores, the CPU workers, whose plain runs are compared only after the grid, take
#: what is left
CPU_WORKER_NICE = 10
#: processes that run the larger checks' plain versions on the card, beside the main process (each
#: plain run is bound by its host's launches, one core a process)
CARD_PLAIN_WORKERS = 4
SCAN_KW = dict(n_sweeps=6, sweep_len_frac=0.06)  # benchmarks/scan_bench.py's full setting
SCAN_N, SCAN_CAP, SCAN_SAMPLES, SCAN_LEN, SCAN_SEED = 6_000, 300, 8, 50_000, 33
SCAN_KINDS = (("lru", {}), ("lfu", {}), ("arc", {}), ("tinylfu", dict(doorkeeper=256)))
# the plain version's measured run: T cut from 20,000 to 10,000, then to 2,500 (the seven plain runs
# took 65.7 s at 10,000) to keep the script's time within its budget
MEASURE_N, MEASURE_CAP, MEASURE_LEN, PLAIN_MEASURE_LEN = 100_000, 2_000, 100_000, 2_500
# the kind (and whether under the byte budget) each program is measured through
MEASURED = {"cache_sim": ("lfu", False), "cache_sim/wlfu": ("wlfu", False),
            "cache_sim/tinylfu": ("tinylfu", False), "cache_sim/plfua_dyn": ("plfua_dyn", False),
            "cache_sim/sized": ("gdsf", True), "cache_sim/plfua_dyn_bytes": ("plfua_dyn", True),
            "cache_sim/arc": ("arc", False)}
SOURCE_DIR = "src/repro_torch/kernels/cache_sim/csrc"
TPU_KERNEL = "src/repro/kernels/cache_sim/cache_sim.py"
REPLACES = {  # the TPU kernel's program each one replaces
    "cache_sim": f"{TPU_KERNEL}:187",  # _cache_sim_kernel (base_step, l.320)
    "cache_sim/wlfu": f"{TPU_KERNEL}:465",  # wlfu_step
    "cache_sim/tinylfu": f"{TPU_KERNEL}:499",  # tinylfu_step (+ sketch primitives, l.105-151)
    "cache_sim/plfua_dyn": f"{TPU_KERNEL}:154",  # _refresh_hot (+ the chunked loop, l.665)
    "cache_sim/sized": f"{TPU_KERNEL}:359",  # base_step's evict_body and gdsf score (l.359-425)
    "cache_sim/plfua_dyn_bytes": f"{TPU_KERNEL}:359",  # evict_body in plfua_dyn's chunked walk
    "cache_sim/arc": f"{TPU_KERNEL}:570",  # arc_step
}
#: H100 SXM HBM3 rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per Hopper SM: 4 partitions x 16 (the Hopper architecture white paper)
INT32_LANES_PER_SM = 64
#: the row options of the grid: the byte-capacity catalogue, and its budget
SIZED = dict(sizing="sized")
BUDGET = dict(sizing="budget")
#: telemetry: W = T // 16 (the reference's telemetry bench), 4 tenant groups on multi_tenant traces
TEL_WINDOWS, TEL_GROUPS = 16, 4
#: (N, cap, T) of the telemetry checks: the small one's plain runs in the CPU workers, the large
#: one's on the card; both cut from T = 20,000 to stay in the script's time (the small one to
#: 10,000, then to 5,000; the large one to 5,000, then to 2,500 to make room for the fleet phase)
TEL_CHECK_CASES = ((10_000, 200, 5_000), (100_000, 2_000, 2_500))
#: the telemetry instances' plain versions timed alone on the card (phase 7) over this many requests
#: of the measured case's multi_tenant traces: the checks' plain runs share the card with the card
#: workers, and timing them alone at 2,500 took about 40 s of the script
TEL_PLAIN_LEN = 500
#: (N, cap, T, options): the window edges W = 1 and W > T, T not a multiple of plfua_dyn's refresh
TEL_EDGE_CASE = (130, 3, 2_010, dict(window=33, refresh=50, sketch_width=96, hot_size=7))
#: what each telemetry instance replaces: tel_update, and plfua_dyn's refresh/churn rows
TEL_REPLACES = {program: f"{TPU_KERNEL}:238" for program in MEASURED}
TEL_REPLACES.update({"cache_sim/plfua_dyn": f"{TPU_KERNEL}:688", "cache_sim/plfua_dyn_bytes": f"{TPU_KERNEL}:688"})
#: the options of a call that are not PolicySpec fields
CALL_OPTIONS = ("sizes", "telemetry_window", "n_groups", "groups")
#: the grid row profiled for the device's idle share
PROFILED_ROW = "plfua"
#: the profiled cases: that row's N = 100,000 cases (6 of 60)
PROFILED_N = 100_000


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def max_abs_err(got: dict, want: dict) -> int:
    """Largest difference over the outputs both have (argmins is the kernel's only)."""
    require(set(want) <= set(got) and set(kernel.OUTPUTS) <= set(want),
            f"the kernel's outputs {sorted(got)} do not cover the plain version's {sorted(want)}")
    err = 0
    for k, b in want.items():
        a = torch.as_tensor(got[k]).cpu().to(torch.int64)
        b = torch.as_tensor(b).cpu().to(torch.int64)
        require(a.shape == b.shape, f"{k}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    return err


def cuda_ms(fn):
    """(result, device ms) of one call, bracketed by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def grid_options(kind: str) -> dict:
    """The options ``simulate.run_case`` gives a kind."""
    return dict(window=simulate.WLFU_WINDOW) if kind == "wlfu" else {}


def catalogue(dist: str, n: int) -> np.ndarray:
    """The byte-capacity benchmark's catalogue of ``dist``."""
    return generators.object_sizes(n, dist=dist, corr=0.5, seed=11, median=64)


def plan_text(spec, sizes=None) -> str:
    """Where a heap program's call puts its heap slots, rows, sketch
    (tinylfu, plfua_dyn) and hot mask (plfua_dyn), and where arc's puts its
    tags and links."""
    where = lambda shared: "shared" if shared else "device"
    program = kernel.program_of(spec.kind, spec.capacity_bytes)
    if program == "cache_sim/arc":
        plan = kernel.arc_plan(spec)
        return f" tags,links={where(plan.shared)} shared_bytes={plan.shared_bytes}"
    size_range = (1, 1) if sizes is None else (int(np.min(sizes)), int(np.max(sizes)))
    plan = kernel.heap_plan(spec, size_range)
    heap = f"shared,device_past={plan.shared_slots}" if plan.can_move else "shared"
    extra = f" sketch={where(plan.sketch_shared)}" if program in kernel.SKETCH_PROGRAMS else ""
    if plan.hot_bytes:
        extra += f" hot_mask={where(plan.hot_shared)}"
    return (f" heap_slots={plan.slots} heap={heap} rows={where(plan.rows_shared)}{extra} "
            f"shared_bytes={plan.shared_bytes}")


def option_text(spec, sizes_dist: str | None = None) -> str:
    """The options a kind runs with, after the defaults are filled in."""
    kind, opts = spec.kind, {}
    if kind in ("plfua", "plfua_dyn"):
        opts["hot_size"] = spec.effective_hot
    if kind in ("wlfu", "tinylfu"):
        opts["window"] = spec.effective_window
    if kind == "plfua_dyn":
        opts["refresh"] = spec.effective_refresh
    if kind in ("tinylfu", "plfua_dyn"):
        opts["sketch_width"] = spec.effective_sketch_width
    if spec.doorkeeper:
        opts["doorkeeper"] = spec.doorkeeper
    if spec.capacity_bytes:
        opts.update(capacity_bytes=spec.capacity_bytes, max_victims=spec.effective_max_victims)
    if sizes_dist:
        opts["sizes"] = sizes_dist
    return json.dumps(opts)


# ------------------------------------------------------------------ CPU workers
def host_cpu() -> str:
    """The host's CPU as ``/proc/cpuinfo`` shows its first core (vendor, family, model, MHz; a virtual
    machine may hide the model name) and its core count: the script's times are the host's launches,
    so a whole run's time is read beside it."""
    first = Path("/proc/cpuinfo").read_text().split("\n\n")[0]
    info = {k.strip(): v.strip() for k, _, v in (line.partition(":") for line in first.splitlines())}
    return (f"{info.get('vendor_id')} family {info.get('cpu family')} model {info.get('model')} "
            f"({info.get('model name')}) {info.get('cpu MHz')} MHz x {os.cpu_count()}")


def _worker_init(nice: int = 0) -> None:
    torch.set_num_threads(1)
    if nice:
        os.nice(nice)


def plain(traces: torch.Tensor, **kw) -> dict:
    """The plain version's outputs, in inference mode: its steps are thousands of small ops,
    each cheaper without autograd's bookkeeping (the outputs are the same)."""
    with torch.inference_mode():
        return kernel.cache_sim_plain(traces, **kw)


def cpu_plain(traces: np.ndarray, kw: dict) -> tuple[dict, float]:
    """The plain version on the CPU (a worker process): numpy outputs, and the run's wall seconds."""
    t0 = time.perf_counter()
    outs = plain(torch.as_tensor(traces), **kw)
    return {k: v.numpy() for k, v in outs.items()}, time.perf_counter() - t0


def card_plain(traces: np.ndarray, kw: dict) -> tuple[dict, float]:
    """The plain version on the card (a card worker process; it shares the card and the host, so its
    wall seconds say what the check phase spends, not what the plain version costs alone): numpy
    outputs, and the run's wall seconds."""
    t0 = time.perf_counter()
    outs = {k: v.cpu().numpy() for k, v in plain(torch.as_tensor(traces, device="cuda"), **kw).items()}
    return outs, time.perf_counter() - t0


def cpu_grid_case(kind: str, options: str, seed: int) -> tuple:
    """The smallest grid case of a row through the plain version on the CPU."""
    kw = {"": {}, "sized": SIZED, "bytes": BUDGET}[options]
    with torch.inference_mode():
        r = simulate.run_case(kind, zipf.paper_grid()[0], seed=seed, device="cpu", **kw)
    return (r.mean_chr, r.std_chr, r.mean_evictions, r.mean_metadata, r.mean_byte_chr)


def grid_rows() -> tuple[list, list]:
    """The paper's grid, and the grid phase's rows ``(label, kind, options, CPU reference's options,
    cases)``: every kind over the 60 cases, gdsf with the byte-capacity catalogue and under the budget,
    and the N = 100,000 cases under the budget for the other byte programs."""
    paper = zipf.paper_grid()
    n100k = [c for c in paper if c.n_objects == 100_000]
    rows = [(kind, kind, {}, "", paper) for kind in KINDS]
    rows += [("gdsf", "gdsf", SIZED, "sized", paper), ("arc", "arc", {}, "", paper),
             ("gdsf+bytes", "gdsf", BUDGET, "bytes", paper)]
    rows += [(f"{kind}+bytes", kind, BUDGET, "bytes", n100k) for kind in BYTE_KINDS if kind != "gdsf"]
    return paper, rows


class Checks:
    """Kernel runs on the card, each held to the plain version: on the card
    in a card worker while there is a ``card_pool`` (the main process goes on
    with the next check), else at once; or in a CPU worker (small N);
    compared when it comes back."""

    def __init__(self, pool, seed: int, card_pool):
        self.pool, self.seed, self.card_pool = pool, seed, card_pool
        self.worst = dict.fromkeys(kernel.INSTANCES, 0)
        self.pending = []
        self.pending_card = []
        self.count = 0

    def run(self, label: str, kind: str, n: int, cap: int, trace_len: int, traces=None, sizes_dist=None,
            budget: bool = False, **kw) -> dict:
        """One check; returns the kernel's outputs."""
        t1 = time.perf_counter()
        if traces is None:
            traces = zipf.sample_traces(n, SAMPLES, trace_len, seed=self.seed)
        if sizes_dist:
            sizes = catalogue(sizes_dist, n)
            kw["sizes"] = sizes
            if budget:
                kw["capacity_bytes"] = simulate.bytes_budget(sizes, cap)
        kw.update(kind=kind, n_objects=n, capacity=cap)
        spec = kernel.spec_of(**{k: v for k, v in kw.items() if k not in CALL_OPTIONS})
        program = kernel.instance_of(kernel.program_of(kind, spec.capacity_bytes), kw.get("telemetry_window", 0),
                                     kw.get("n_groups", 0))
        got = kernel.cache_sim_cuda(torch.as_tensor(traces, device="cuda"), **kw)
        torch.cuda.synchronize()
        got = {k: v.cpu() for k, v in got.items()}
        line = (f"[check {label}] program={program} n_objects={n} capacity={cap} T={trace_len} "
                f"options={option_text(spec, sizes_dist)}{plan_text(spec, kw.get('sizes'))} "
                f"hits={int(got['hits'].sum())} inserts={int(got['inserts'].sum())}")
        if "argmins" in got:
            line += f" dir_size={got['dir_size'].tolist()} argmins={int(got['argmins'].sum())}"
        if "series" in got:
            line += (f" telemetry_window={kw['telemetry_window']} n_groups={kw.get('n_groups', 0)} "
                     f"series_shape={list(got['series'].shape)}")
        what = f"{label} {program} N={n} cap={cap} T={trace_len} {option_text(spec, sizes_dist)}"
        self.count += 1
        if n < CARD_PLAIN_MIN_N:
            future = self.pool.submit(cpu_plain, traces, kw)
            self.pending.append((future, got, program, line + " plain=cpu", what, t1))
        elif self.card_pool is not None:
            future = self.card_pool.submit(card_plain, traces, kw)
            self.pending_card.append((future, got, program, line + " plain=card_worker", what, t1))
        else:
            self.compare(got, (plain(torch.as_tensor(traces, device="cuda"), **kw), None), program,
                         line + " plain=card", what, t1)
        return got

    def compare(self, got, plain_run: tuple, program, line, what, t1) -> None:
        want, plain_s = plain_run
        err = max_abs_err(got, want)
        print(f"{line} max_abs_err={err} plain_s={plain_s} elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
        require(err == 0, f"kernel != plain version: {what}")
        self.worst[program] = max(self.worst[program], err)

    def finish_card(self) -> None:
        """Wait for the card workers' plain runs and compare them; later checks run their plain
        version in the main process, alone on the card."""
        self.finish(self.pending_card)
        self.pending_card = []
        self.card_pool = None

    def finish(self, pending=None) -> None:
        """Wait for the workers' plain runs (the CPU workers' by default) and compare them."""
        for future, got, program, line, what, t1 in self.pending if pending is None else pending:
            self.compare(got, future.result(), program, line, what, t1)
        if pending is None:
            self.pending = []


def same_outputs(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in kernel.OUTPUTS)


def tel_kinds() -> dict:
    """Each program's kind in the telemetry phase (the measured one) with
    its sizes: the byte programs under the lognormal budget, gdsf's object-
    count program over the lognormal catalogue."""
    return {program: (kind, dict(sizes_dist="lognormal", budget=True) if with_budget else
                      dict(sizes_dist="lognormal") if kind == "gdsf" else {})
            for program, (kind, with_budget) in MEASURED.items()}


def run_telemetry_checks(checks: Checks, seed: int) -> None:
    """Each program's telemetry instances against the plain version: ungrouped
    on Zipf traces, grouped on multi_tenant traces of 4 tenants; at the small
    case also byte mode's multi-victim evictions per group (lru under the
    pareto budget, 2 victims at most) and gdsf's object-count program; and the
    window edges W = 1 (grouped) and W > T."""
    for n, cap, trace_len in TEL_CHECK_CASES:
        w = trace_len // TEL_WINDOWS
        grouped = dict(traces=generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS),
                       telemetry_window=w, n_groups=TEL_GROUPS, groups=generators.tenant_groups(n, TEL_GROUPS))
        for kind, extra in tel_kinds().values():
            extra = {**grid_options(kind), **extra}
            got = checks.run(f"{kind} telemetry", kind, n, cap, trace_len, telemetry_window=w, **extra)
            got_grouped = checks.run(f"{kind} telemetry grouped", kind, n, cap, trace_len, **grouped, **extra)
            if n <= CPU_PLAIN_MAX_N:  # cut in depth: each sample still evicts
                budget = bool(extra.get("budget"))
                hold_depth(f"{kind} telemetry N={n}", kind, got, trace_len, budget=budget, n=n)
                hold_depth(f"{kind} telemetry grouped N={n}", kind, got_grouped, trace_len, budget=budget, n=n)
        if n <= CPU_PLAIN_MAX_N:
            checks.run("lru+bytes telemetry grouped", "lru", n, cap, trace_len, sizes_dist="pareto", budget=True,
                       max_victims=2, **grouped)
            checks.run("gdsf telemetry grouped", "gdsf", n, cap, trace_len, **grouped)
    n, cap, trace_len, explicit = TEL_EDGE_CASE
    tenants = generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS)
    for kind, extra in tel_kinds().values():
        extra = {**explicit, **extra}
        checks.run(f"{kind} telemetry W=1", kind, n, cap, trace_len, traces=tenants, telemetry_window=1,
                   n_groups=TEL_GROUPS, groups=generators.tenant_groups(n, TEL_GROUPS), **extra)
        checks.run(f"{kind} telemetry W>T", kind, n, cap, trace_len, telemetry_window=trace_len + 7, **extra)
    # capacity <= 0: an empty cache's victim (id 0, not cached) counts in no group
    small_n, _, small_len = TEL_CHECK_CASES[0]
    for n, trace_len, options in ((n, trace_len, explicit), (small_n, small_len, {})):
        w = trace_len // TEL_WINDOWS
        grouped = dict(traces=generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS),
                       telemetry_window=w, n_groups=TEL_GROUPS, groups=generators.tenant_groups(n, TEL_GROUPS))
        for kind in ZERO_CAPACITY_KINDS:
            # plfua_dyn's default hot set (2 x capacity) is empty here: the edge case's 7 ids are hot
            extra = {**grid_options(kind), **options, **({"hot_size": 7} if kind == "plfua_dyn" else {})}
            for cap in ZERO_CAPACITIES:
                checks.run(f"{kind} telemetry grouped capacity<=0", kind, n, cap, trace_len, **grouped, **extra)


def plfua_dyn_refreshes(got: dict, trace: np.ndarray, n: int, cap: int) -> None:
    """The refreshes and hot churn of plfua_dyn's largest-heap check, from its telemetry
    instance on the same traces (a window a refresh period): the same primary outputs, and
    at least three refreshes a sample, each with churn."""
    refresh = PLFUA_DYN_HEAP_OPTIONS["refresh"]
    tel = kernel.cache_sim_cuda(torch.as_tensor(trace, device="cuda"), kind="plfua_dyn", n_objects=n, capacity=cap,
                                telemetry_window=refresh, **PLFUA_DYN_HEAP_OPTIONS)
    require(same_outputs(tel, got), "plfua_dyn's largest-heap check: the telemetry instance changed the outputs")
    series = tel["series"].cpu()
    fired = series[..., telemetry_spec.METRICS.index("refreshes")]
    churn = series[..., telemetry_spec.METRICS.index("hot_churn")]
    with_churn = ((fired > 0) & (churn > 0)).sum(dim=1)
    require(int(with_churn.min()) >= 3,
            f"plfua_dyn's largest-heap check refreshed with churn only {with_churn.tolist()} times a sample")
    print(f"[check plfua_dyn largest heap] refreshes={int(fired.sum())} refreshes_with_churn_by_sample="
          f"{with_churn.tolist()} churn={int(churn.sum())} churn_by_refresh_sample0={churn[0].tolist()}", flush=True)


def hold_depth(label: str, kind: str, got: dict, trace_len: int, budget: bool = False, n: int | None = None) -> None:
    """A check cut in depth still exercises eviction: every sample evicts (inserts past its
    residents), or, for a kind of ``NEVER_FULL_KINDS`` under an object count with its plain version
    on the card (``n`` None or above ``CPU_PLAIN_MAX_N``), turns a miss away (misses past inserts).
    Prints both by sample."""
    evictions = got["inserts"].long() - got["in_cache"].long().sum(dim=1)
    refused = trace_len - got["hits"].long() - got["inserts"].long()
    gated = kind in NEVER_FULL_KINDS and not budget and (n is None or n > CPU_PLAIN_MAX_N)
    print(f"[check {label} depth] T={trace_len} evictions_by_sample={evictions.tolist()} "
          f"refused_by_sample={refused.tolist()} gate={'refuses' if gated else 'evicts'}", flush=True)
    if gated:
        require(int(refused.min()) > 0, f"{label} at T={trace_len}: a sample never turned a miss away")
    else:
        require(int(evictions.min()) > 0, f"{label} at T={trace_len}: a sample never evicted ({evictions.tolist()})")


def check_len(kind: str, n: int, trace_len: int) -> int:
    """A check's T: ``NEVER_FULL_LEN`` for a kind that never fills there (plain on the card)."""
    return NEVER_FULL_LEN if n > CPU_PLAIN_MAX_N and kind in NEVER_FULL_KINDS else trace_len


def run_checks(checks: Checks, seed: int) -> None:
    """The program checks, the largest heap's first: their plain runs on the card are the longest,
    and the card workers take the plain runs in the order the checks make them."""
    n, cap, trace_len, scan_kw = HEAP_CHECK_CASE
    scan = generators.scan(n, SAMPLES, trace_len, seed=seed, **scan_kw)
    swept, kept, again = TINYLFU_RESWEEP
    resweep = []
    for i in range(SAMPLES):
        order = np.random.default_rng(seed + i).permutation(n)
        resweep.append(np.concatenate([order[:swept], np.repeat(order[kept:kept + again], 2)]))
    traces = dict(arc=generators.scan(n, SAMPLES, ARC_HEAP_CHECK_LEN, seed=seed, **scan_kw),
                  plfua_dyn=generators.scan(n, SAMPLES, PLFUA_DYN_HEAP_CHECK_LEN, seed=seed, **scan_kw),
                  tinylfu=np.stack(resweep).astype(np.int32))
    options = dict(wlfu=grid_options("wlfu"), plfua_dyn=PLFUA_DYN_HEAP_OPTIONS)
    for kind in HEAP_CHECK_KINDS:
        trace = traces.get(kind, scan)
        got = checks.run(f"{kind} largest heap", kind, n, cap, trace.shape[1], traces=trace, **options.get(kind, {}))
        evictions = int(got["inserts"].sum()) - int(got["in_cache"].sum())
        require(evictions >= 1_000 * SAMPLES and int(got["in_cache"].sum()) == cap * SAMPLES,
                f"the largest-heap check of {kind} did not fill the heap and evict: {evictions} evictions")
        print(f"[check {kind} largest heap] evictions={evictions} residents={int(got['in_cache'].sum())}", flush=True)
        if kind == "plfua_dyn":
            plfua_dyn_refreshes(got, trace, n, cap)
    for n, cap, base_len in BASE_CHECK_CASES:
        for kind in BASE_KINDS:
            trace_len = check_len(kind, n, base_len)
            got = checks.run(kind, kind, n, cap, trace_len)
            if n > CPU_PLAIN_MAX_N:
                hold_depth(f"{kind} N={n}", kind, got, trace_len)
    for n, cap, case_len, explicit in ADMISSION_CHECK_CASES:
        for kind in ADMISSION_KINDS:
            trace_len = check_len(kind, n, case_len)
            variants = [{}]
            if kind == "tinylfu":
                variants.append(dict(doorkeeper=sketch.default_doorkeeper(cap)))
            for extra in variants:
                # options a kind does not take are ignored, as the reference does
                got = checks.run(kind, kind, n, cap, trace_len, **{**grid_options(kind), **explicit, **extra})
                if n > CPU_PLAIN_MAX_N:
                    hold_depth(f"{kind} N={n} {json.dumps(extra)}", kind, got, trace_len)
    for n, cap, trace_len, bytes_len in SIZED_CHECK_CASES:
        got = checks.run("gdsf", "gdsf", n, cap, trace_len, sizes_dist="lognormal")
        hold_depth(f"gdsf N={n}", "gdsf", got, trace_len)
        for dist in generators.SIZE_DISTS:
            for kind in BYTE_KINDS:
                got = checks.run(f"{kind}+bytes", kind, n, cap, bytes_len, sizes_dist=dist, budget=True)
                hold_depth(f"{kind}+bytes {dist} N={n}", kind, got, bytes_len, budget=True)
    # max_victims=2 where the bound is hit: the run differs from the default bound's
    n, cap = SIZED_CHECK_CASES[0][:2]
    traces = zipf.sample_traces(n, SAMPLES, SIZED_CHECK_LEN, seed=seed)
    capped = checks.run("gdsf+bytes", "gdsf", n, cap, SIZED_CHECK_LEN, traces=traces, sizes_dist="pareto",
                        budget=True, max_victims=2)
    sizes = catalogue("pareto", n)
    default = kernel.cache_sim_cuda(
        torch.as_tensor(traces, device="cuda"), kind="gdsf", n_objects=n, capacity=cap, sizes=sizes,
        capacity_bytes=simulate.bytes_budget(sizes, cap))
    require(not same_outputs(capped, default), "max_victims=2 never bound the pareto case")
    hold_depth(f"gdsf+bytes pareto max_victims=2 N={n}", "gdsf", capped, SIZED_CHECK_LEN, budget=True)
    print("[check max_victims] gdsf pareto N=10000: max_victims=2 differs from the default bound "
          f"(inserts {int(capped['inserts'].sum())} vs {int(default['inserts'].sum())})", flush=True)
    # unit sizes with capacity_bytes == capacity: the byte program gives the object-count program's outputs
    dev_traces = torch.as_tensor(traces, device="cuda")
    for kind in BYTE_KINDS:
        kw = dict(kind=kind, n_objects=n, capacity=cap)
        bytes_run = kernel.cache_sim_cuda(dev_traces, capacity_bytes=cap, **kw)
        object_run = kernel.cache_sim_cuda(dev_traces, **kw)
        require(same_outputs(bytes_run, object_run), f"unit sizes: {kind} byte program != object-count program")
        print(f"[check unit-sizes {kind}] {kernel.program_of(kind, cap)} == {kernel.program_of(kind)} "
              f"N={n} cap={cap} T={SIZED_CHECK_LEN} hits={int(bytes_run['hits'].sum())}", flush=True)
    for n, cap, trace_len, scan_len in ARC_CHECK_CASES:
        got = checks.run("arc", "arc", n, cap, trace_len)
        scan = generators.scan(n, SAMPLES, scan_len, seed=SCAN_SEED, **SCAN_KW)
        got_scan = checks.run("arc scan", "arc", n, cap, scan_len, traces=scan)
        if n >= CPU_PLAIN_MAX_N:
            hold_depth(f"arc N={n}", "arc", got, trace_len)
            hold_depth(f"arc scan N={n}", "arc", got_scan, scan_len)


# ------------------------------------------------------------------------ bound
def bound(program: str, got: dict, spec, card, sms: int, n_sizes: int, n_groups_row: int = 0) -> dict:
    """The least time the card could take for the measured call: the larger of
    its bytes (inputs read once, outputs written once) over the HBM rate and
    the operations the function needs, counted from this run's outputs, over
    the INT32 peak. A telemetry instance's series is one of its outputs and
    its group row (``n_groups_row`` ints) one of its inputs.

    The function's need, not the kernel's algorithm: a request costs a hit
    test and an update (2); lru's and arc's lists are recency lists whose LRU
    is a list head, so each list move or LRU lookup costs 1; a keyed kind
    (lfu, plfu, plfua, gdsf, the sketch kinds) keeps its residents in a heap,
    so each re-price on a hit, insert and eviction costs ceil(log2 N); the
    sketch kinds add their DEPTH counters a request, their estimates, and the
    sketch's aging; a byte budget adds a fit test and a ledger update a
    request. ``scan_operations`` is what the kernels' O(N) block argmin does
    instead (N compares per eviction or list-LRU search), kept as a diagnostic."""
    hits, freq, in_cache, inserts = (got[k] for k in kernel.OUTPUTS)
    s, n = freq.shape
    trace_len = MEASURE_LEN
    requests = s * trace_len
    n_hits = int(hits.sum())
    occupancy = int(in_cache.sum())
    evictions = int(inserts.sum()) - occupancy
    n_bytes = (requests * 4 + (n_sizes + n_groups_row) * 4
               + sum(a.numel() * a.element_size() for a in got.values()))
    width = spec.effective_sketch_width
    log_n = math.ceil(math.log2(n))
    heap_ops = n_hits + int(inserts.sum()) + evictions  # re-price, push, pop
    counted = {"hits": n_hits, "evictions": evictions, "log2_n": log_n}
    operations = 2 * requests
    if spec.capacity_bytes:
        operations += 2 * requests  # the fit test and the ledger's update
    if program == "cache_sim/arc":
        argmins = int(got["argmins"].sum())
        operations += requests + argmins  # a list move a request, a list-head lookup per LRU search
        scan_operations = argmins * n
        counted.update(argmins=argmins)
    else:
        operations += heap_ops * log_n
        scan_operations = evictions * n
        if program == "cache_sim/wlfu":
            operations += 2 * requests  # the window's two count updates a step
        if program == "cache_sim/tinylfu":
            # every miss into a full cache duels the heap's top: two estimates
            duels = requests - n_hits - occupancy
            agings = s * (trace_len // spec.effective_window)
            operations += requests * sketch.DEPTH + duels * 2 * sketch.DEPTH + agings * sketch.DEPTH * width
            scan_operations = duels * n
            counted.update(duels=duels, agings=agings)
        if program in ("cache_sim/plfua_dyn", "cache_sim/plfua_dyn_bytes"):
            # a refresh: every id's estimate, a linear-time top-k selection, the rows' halving
            refreshes = s * (trace_len // spec.effective_refresh)
            operations += requests * sketch.DEPTH + refreshes * (n * (sketch.DEPTH + 1) + sketch.DEPTH * width)
            scan_operations += refreshes * n * (sketch.DEPTH + 2 * log_n)  # the kernel's two binary searches
            counted.update(refreshes=refreshes)
    int32_peak = sms * INT32_LANES_PER_SM * card.max_sm_clock_mhz * 1e6
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, operations / int32_peak * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return dict(bytes=n_bytes, operations=operations, int32_peak_ops_per_s=int32_peak, bytes_ms=bytes_ms,
                operations_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by, scan_operations=scan_operations,
                scan_operations_ms=scan_operations / int32_peak * 1e3, **counted)


def profile_row(seed: int, card) -> None:
    """``measure`` over PROFILED_ROW's N = 100,000 cases (its largest 6 of 60; cut from the whole row
    to save 12 s) with a ``torch.profiler`` trace: the device's idle share between the first
    kernel's start and the last one's end, from the trace's kernels, and from CUDA events (1 - the
    cases' device seconds over the timed call's). The share is that of the row's largest cases."""
    t0 = time.perf_counter()
    paper = [c for c in zipf.paper_grid() if c.n_objects == PROFILED_N]
    rows = []
    tm = timing.measure(lambda: rows.append(simulate.run_grid(PROFILED_ROW, paper, seed=seed)),
                        steps=len(paper) * zipf.PAPER_NUM_SAMPLES * zipf.PAPER_TRACE_LEN, repeats=1,
                        profile_dir=Path(__file__).resolve().parent / "build" / "profile")
    device_s = sum(r.device_s for r in rows[2])  # the timed call's cases
    trace = tm.trace
    require(trace is not None and trace.path.exists(), "the profiled call wrote no trace")
    print(f"[profile {PROFILED_ROW}] cases={len(paper)} (the row's N = {PROFILED_N} cases, its largest) trace={trace.path} trace_kernels={trace.kernels} "
          f"trace_busy_s={trace.busy_s} trace_span_s={trace.span_s} trace_idle_share={trace.idle_share} "
          f"row_s={tm.execute_s} cases_device_s={device_s} events_idle_share={1 - device_s / tm.execute_s} "
          f"card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)


def run_telemetry(traces, offs: dict, checks: Checks, card, sms: int, seed: int) -> list[dict]:
    """The telemetry path at the measured case: each program's ungrouped
    instance on the Zipf traces (``offs``: the measure phase's outputs
    without telemetry on them) and on multi_tenant traces, and its grouped
    instance on the latter, through ``ops.cache_sim_outputs``, with every
    launch count set to 0 just before and read just after; the identities
    the series must keep; then each instance's time on the multi_tenant
    traces between two telemetry-off times. Returns the ``kernels`` line's
    entries."""
    n, cap, trace_len = MEASURE_N, MEASURE_CAP, MEASURE_LEN
    w = trace_len // TEL_WINDOWS
    tenants = torch.as_tensor(generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS),
                              device="cuda")
    groups = torch.as_tensor(generators.tenant_groups(n, TEL_GROUPS), device="cuda")
    sizes = simulate.bytes_catalogue(n)
    calls = {}
    for program, (kind, with_budget) in MEASURED.items():
        kw = dict(kind=kind, n_objects=n, capacity=cap, **grid_options(kind))
        if with_budget:
            kw.update(capacity_bytes=simulate.bytes_budget(sizes, cap))
        if kernel.spec_of(**kw).size_aware:
            kw["sizes"] = sizes
        calls[program] = kw
    flat = dict(telemetry_window=w)
    grouped = dict(telemetry_window=w, n_groups=TEL_GROUPS, groups=groups)

    t0 = time.perf_counter()
    for instance in kernel.LAUNCHES:
        kernel.LAUNCHES[instance] = 0
    runs = {}
    for program, kw in calls.items():
        runs[program] = (ops.cache_sim_outputs(traces, **kw, **flat),
                         ops.cache_sim_outputs(tenants, **kw, **flat),
                         ops.cache_sim_outputs(tenants, **kw, **grouped))
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    want = {instance: 0 for instance in kernel.LAUNCHES}
    for program in calls:
        want[kernel.instance_of(program, w)] = 2
        want[kernel.instance_of(program, w, TEL_GROUPS)] = 1
    require(launches == want, f"the telemetry path launched {launches}, expected {want}")
    print(f"[telemetry] path launches={json.dumps({k: v for k, v in launches.items() if v})} "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

    entries = []
    window_sizes = telemetry_spec.window_sizes(trace_len, w, device="cuda")
    for program, kw in calls.items():
        t1 = time.perf_counter()
        zipf_flat, tenant_flat, tenant_grouped = runs[program]
        tenant_off = kernel.cache_sim_cuda(tenants, **kw)
        # the series is observational: the primary outputs are the instance's without telemetry
        require(same_outputs(zipf_flat, offs[program]), f"{program}: telemetry changed the primary outputs")
        require(same_outputs(tenant_flat, tenant_off) and same_outputs(tenant_grouped, tenant_off),
                f"{program}: telemetry changed the primary outputs on multi_tenant traces")
        for run in (zipf_flat, tenant_flat):
            series = run["series"]
            require(tuple(series.shape) == (SAMPLES, len(window_sizes), telemetry_spec.N_METRICS),
                    f"{program}: series shape {tuple(series.shape)}")
            require(torch.equal(series[..., 1].sum(dim=1), run["hits"].long()), f"{program}: hits column != hits")
            require(bool((series[..., 0] == window_sizes).all()), f"{program}: requests != window sizes")
        summed = tenant_grouped["series"].sum(dim=2, dtype=torch.int32)
        require(torch.equal(summed, tenant_flat["series"]), f"{program}: grouped series summed over G != ungrouped")
        occupancy = tenant_grouped["series"][:, -1, :, telemetry_spec.METRIC_INDEX["occupancy"]]
        require(torch.equal(occupancy.sum(dim=1), tenant_off["in_cache"].sum(dim=1, dtype=torch.int32)),
                f"{program}: the last window's occupancy != the final residents")

        def timed(trace_set, **tel):
            tm = timing.measure(kernel.cache_sim_cuda, trace_set, steps=trace_set.numel(), repeats=2, **kw, **tel)
            return tm.execute_s * 1e3, tm.mean_execute_s * 1e3

        spec = kernel.spec_of(**{k: v for k, v in kw.items() if k not in CALL_OPTIONS})
        # each instance's plain version, alone on the card, on the traces' first TEL_PLAIN_LEN requests,
        # the kernel held to it there (phase 3 holds both at T = TEL_CHECK_CASES' 2,500)
        plain_timed = {}
        short = tenants[:, :TEL_PLAIN_LEN].contiguous()
        short_tel = dict(telemetry_window=TEL_PLAIN_LEN // TEL_WINDOWS)
        for instance, tel in ((kernel.instance_of(program, w), short_tel),
                              (kernel.instance_of(program, w, TEL_GROUPS),
                               dict(short_tel, n_groups=TEL_GROUPS, groups=groups))):
            want, plain_ms = cuda_ms(lambda: plain(short, **kw, **tel))
            require(max_abs_err(kernel.cache_sim_cuda(short, **kw, **tel), want) == 0,
                    f"{instance}: kernel != plain version at T={TEL_PLAIN_LEN}")
            plain_timed[instance] = (plain_ms, TEL_PLAIN_LEN)
        # in turns on the same traces: off, ungrouped, grouped, off; on/off is against the offs' mean
        off_first, _ = timed(tenants)
        timings = {"flat": timed(tenants, **flat), "grouped": timed(tenants, **grouped)}
        off_last, _ = timed(tenants)
        ref_ms = (off_first + off_last) / 2
        # arc's search count (for its bound) is the kernel's diagnostic, which ops drops: the
        # instance without telemetry made the same searches
        searches = {"argmins": tenant_off["argmins"]} if "argmins" in tenant_off else {}
        line = (f"[telemetry {program}] kind={kw['kind']} N={n} cap={cap} S={SAMPLES} T={trace_len} W={w} "
                f"groups={TEL_GROUPS} traces=multi_tenant off_ms={off_first} off_ms_after={off_last}")
        for instance, layout, run, n_groups_row in (
                (kernel.instance_of(program, w), "flat", tenant_flat, 0),
                (kernel.instance_of(program, w, TEL_GROUPS), "grouped", tenant_grouped, n)):
            ms, mean_ms = timings[layout]
            b = bound(program, {**run, **searches}, spec, card, sms, n if spec.size_aware else 0, n_groups_row)
            plain_ms, plain_t = plain_timed[instance]
            line += (f" | {instance}: ms={ms} mean_ms={mean_ms} on_off={ms / ref_ms} bound_ms={b['bound_ms']} "
                     f"bound_by={b['bound_by']} bytes={b['bytes']} plain_ms={plain_ms} plain_T={plain_t} "
                     f"launches={launches[instance]}")
            entries.append({
                "name": instance, "route": "cuda",
                "source": f"{SOURCE_DIR}/{kernel.PROGRAMS[program].source.name}",
                "replaces": TEL_REPLACES[program], "launches": launches[instance],
                "max_abs_err": checks.worst[instance], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
                "T": trace_len, "plain_T": plain_t,
            })
        print(line + f" card={card.label!r} elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
    return entries


# ------------------------------------------------------------------ the fleet
#: benchmarks/fleet_bench.py's topology (``_three_tier``) at its full size: 8 edges -> 2 regionals ->
#: 1 root over N = 10,000 ids, capacities 300 / 1,200 / 2,400, the hash router; wlfu's window is the
#: fleet benchmarks' 2,048 (benchmarks/cdn_bench.py)
FLEET_N, FLEET_WIDTHS, FLEET_CAPS, FLEET_WLFU_WINDOW = 10_000, (8, 2, 1), (300, 1_200, 2_400), 2_048
#: the benchmark's 8 samples of 100,000 requests: the device traces are made at that size; the fleet
#: runs (plfua_dyn's churn run too: 6 refreshes of its edges, 1 of its regionals) are cut to FLEET_LEN
#: requests a sample, the depth at which the caches work: at 10,000 no cache of the fleet fills,
#: at 20,000 every edge of every sample evicts (97 times or more, seed 0) and every upper level
#: hits, for each kind without an admission gate; the idle share is read from a profiled run of the
#: first FLEET_PROFILE_LEN requests
FLEET_SAMPLES, FLEET_BENCH_LEN, FLEET_LEN, FLEET_PROFILE_LEN = 8, 100_000, 20_000, 300
FLEET_KINDS = torch_cache.PORTED_KINDS
#: the kinds that turn misses away (plfua's and plfua_dyn's hot set, tinylfu's duel): their edges
#: need not fill, but the fleet must evict somewhere
FLEET_GATED = ("plfua", "plfua_dyn", "tinylfu")
#: the grouped run: tinylfu on multi_tenant traces of 4 tenants, W = T // 16 (as phase 7)
FLEET_TEL_KIND = "tinylfu"
#: the paper's CPU-time case: the pure-Python policies at N = 100,000, cap = 2,000, one sample
CPU_TIME_KINDS, CPU_TIME_N, CPU_TIME_CAP, CPU_TIME_LEN = ("lfu", "plfu", "plfua"), 100_000, 2_000, 100_000


def fleet_topology(kind: str):
    return fleet.tree(n_objects=FLEET_N, widths=FLEET_WIDTHS, kinds=kind, capacities=FLEET_CAPS,
                      window=FLEET_WLFU_WINDOW if kind == "wlfu" else 0, router="hash")


def fleet_oracle(kind, trace: np.ndarray, assignment: np.ndarray, sizes=None) -> dict:
    """One sample through the port's pure-Python oracle (a CPU worker); ``kind`` names a
    fleet_topology or is the topology itself."""
    topo = fleet_topology(kind) if isinstance(kind, str) else kind
    ref = fleet.simulate_fleet_reference(topo, trace, assignment, sizes=sizes)
    return {"hit": ref.level_hit, "in_cache": ref.in_cache(topo.n_objects),
            "hits": [[p.hits for p in lvl] for lvl in ref.levels],
            "evictions": [[p.evictions for p in lvl] for lvl in ref.levels]}


def fleet_cpu_run(kind: str, traces: np.ndarray, assignments: np.ndarray, window: int, n_groups: int,
                  groups: np.ndarray) -> dict:
    """The same fleet call on the CPU (a CPU worker): numpy outputs."""
    with torch.inference_mode():
        out = fleet.simulate_fleet_batch(fleet_topology(kind), traces, assignments,
                                         telemetry_spec.TelemetrySpec(window, n_groups), groups=groups,
                                         device="cpu")
    return to_numpy(out)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    return tree.cpu().numpy()


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def hold_to_oracle(label: str, kind: str, out: dict, futures: list) -> None:
    """Each sample of a card run exactly equal to the oracle's: per-level hit series,
    final contents, per-node hits and evictions, and the origin misses; and a run whose
    caches work: for a kind without an admission gate every edge of every sample evicts and
    every upper level hits, for the others some node evicts."""
    host = to_numpy({k: out[k] for k in ("hit", "states", "tiers", "origin_miss")})
    evictions = [t["evictions"] for t in host["tiers"]]
    if kind in FLEET_GATED:
        require(sum(int(e.sum()) for e in evictions) > 0, f"{label}: no node evicted")
    else:
        require(bool((evictions[0] > 0).all()), f"{label}: an edge never evicted, {evictions[0].min(axis=1)}")
        upper_hits = [int(t["hits"].sum()) for t in host["tiers"][1:]]
        require(all(h > 0 for h in upper_hits), f"{label}: an upper level never hit, {upper_hits}")
    equal_to_oracle(label, host, futures)


def equal_to_oracle(label: str, host: dict, futures: list) -> None:
    """Each sample of a run's host outputs equal to the oracle's (one future a sample)."""
    for s, future in enumerate(futures):
        ref = future.result()
        for l in range(len(ref["hit"])):
            require(np.array_equal(host["hit"][l][s], ref["hit"][l]), f"{label}: sample {s} level {l} hits")
            require(np.array_equal(host["states"][l]["in_cache"][s], ref["in_cache"][l]),
                    f"{label}: sample {s} level {l} final contents")
            require(host["tiers"][l]["hits"][s].tolist() == ref["hits"][l], f"{label}: sample {s} level {l} node hits")
            require(host["tiers"][l]["evictions"][s].tolist() == ref["evictions"][l],
                    f"{label}: sample {s} level {l} node evictions")
        require(np.array_equal(host["origin_miss"][s], ~np.any(ref["hit"], axis=0)), f"{label}: sample {s} origin")


def fleet_line(topo, out: dict, wall_s: float, device_s: float, prof: tuple, card) -> str:
    """What a fleet run's line prints: per-level CHR, origin misses, management energy, ms a request and
    the idle share of a profiled prefix (``prof``: its trace and the host seconds the profiling took)."""
    trace, profile_s = prof
    rep = fleet.fleet_report(topo, out)
    requests = out["hit"][0].numel()
    evictions = [int(t["evictions"].sum()) for t in out["tiers"]]
    edge_min = int(out["tiers"][0]["evictions"].min())
    return (f"level_chr={json.dumps([round(c, 6) for c in rep.level_chr])} total_chr={rep.total_chr} "
            f"evictions_by_level={evictions} edge_evictions_min={edge_min} "
            f"origin_misses={rep.origin_requests} mgmt_energy_j={rep.mgmt_energy_j} "
            f"ms_per_request={wall_s * 1e3 / requests} device_ms_per_request={device_s * 1e3 / requests} "
            f"idle_share={trace.idle_share} profiled_kernels={trace.kernels} profiled_requests={FLEET_PROFILE_LEN} "
            f"profile_s={profile_s:.3f} card={card.label!r}")


def fleet_run(topo, traces, assignments, **kw) -> tuple[dict, float, float]:
    """(outputs, host wall s, device s between CUDA events) of one batched fleet call on the card."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fleet.simulate_fleet_batch(topo, traces, assignments, device="cuda", **kw)
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def fleet_profile(topo, traces, assignments, **kw) -> tuple:
    """(trace, host s) of a fleet call on the first FLEET_PROFILE_LEN requests of each sample under
    ``timing.profile``, whose trace gives the device's idle share (the same call ran in full just
    before, so nothing is built or loaded in it); no Chrome trace is written (nothing reads it, and
    writing one took 0.7-8 s a call)."""
    t0 = time.perf_counter()
    tr = torch.as_tensor(traces[:, :FLEET_PROFILE_LEN], device="cuda")
    asg = torch.as_tensor(assignments[:, :FLEET_PROFILE_LEN], device="cuda")
    trace = timing.profile(fleet.simulate_fleet_batch, topo, tr, asg, device="cuda", profile_dir=None, **kw)
    return trace, time.perf_counter() - t0


def device_trace_checks(seed: int) -> None:
    """Each scenario generated on the card at the fleet benchmark's size, held to the generators'
    contracts there: shape, dtype and range; the same seed gives the same traces and another seed
    others; samples differ; the Zipf head dominates; a sample generated alone equals its row; and
    each scenario's own shape."""
    n = FLEET_N
    try:
        device_workloads.DeviceTraceSpec("stationary", n, overrides=(("n_phases", 3),))
        require(False, "an unknown override was accepted")
    except ValueError:
        pass
    for scenario in device_workloads.DEVICE_SCENARIO_NAMES:
        t0 = time.perf_counter()
        dspec = device_workloads.DeviceTraceSpec(scenario, n, n_samples=FLEET_SAMPLES, trace_len=FLEET_BENCH_LEN,
                                                 seed=seed)
        traces, ms = cuda_ms(lambda: device_workloads.make_traces_device(dspec, device="cuda"))
        require(traces.is_cuda and traces.shape == (FLEET_SAMPLES, FLEET_BENCH_LEN) and traces.dtype == torch.int32,
                f"{scenario}: {traces.shape} {traces.dtype}")
        lo, hi = int(traces.min()), int(traces.max())
        require(0 <= lo and hi < n, f"{scenario}: ids in [{lo}, {hi}]")
        require(torch.equal(traces, device_workloads.make_traces_device(dspec, device="cuda")),
                f"{scenario}: not deterministic")
        other = dataclasses.replace(dspec, seed=seed + 1)
        require(not torch.equal(traces, device_workloads.make_traces_device(other, device="cuda")),
                f"{scenario}: seed-insensitive")
        require(all(bool((traces[i] != traces[i + 1]).any()) for i in range(FLEET_SAMPLES - 1)),
                f"{scenario}: two samples equal")
        last = FLEET_SAMPLES - 1
        require(torch.equal(device_workloads.gen_sample(dspec, device_workloads.sample_key(dspec, last),
                                                        device="cuda"), traces[last]),
                f"{scenario}: a sample generated alone differs from its row")
        head = n // 10
        if scenario == "churn":
            counts = torch.bincount(traces.flatten().long(), minlength=n)
            share = float(counts.sort(descending=True).values[:head].sum()) / traces.numel()
        else:
            share = float((traces < head).double().mean())
        require(share > 0.25, f"{scenario}: head share {share}")
        semantics = scenario_semantics(scenario, traces, n)
        print(f"[fleet traces {scenario}] N={n} S={FLEET_SAMPLES} T={FLEET_BENCH_LEN} ms={ms} head_share={share} "
              f"{semantics} deterministic=True seed_sensitive=True samples_independent=True "
              f"row_independent=True elapsed_s={time.perf_counter() - t0:.3f}", flush=True)


def scenario_semantics(scenario: str, traces: torch.Tensor, n: int) -> str:
    """Each scenario's own shape, checked on the card: churn moves popularity between its first and
    last phase, flash_crowd sends runs of requests to cold ids, diurnal's head swings between its
    chunks, multi_tenant's tenants follow their Zipf(1) weights, and scan walks consecutive ids."""
    tr = traces.long()
    t_n = tr.shape[1]
    if scenario == "churn":
        first = torch.bincount(tr[:, : t_n // 5].flatten(), minlength=n).topk(100).indices
        last = torch.bincount(tr[:, -(t_n // 5):].flatten(), minlength=n).topk(100).indices
        moved = 100 - len(set(first.tolist()) & set(last.tolist()))
        require(moved > 10, f"churn: {moved} of the top 100 ids moved")
        return f"top100_moved={moved}"
    if scenario == "flash_crowd":
        cold = tr >= (3 * n) // 4
        share = float(cold.double().mean())
        require(share > 0.01, f"flash_crowd: cold share {share}")
        return f"cold_share={share}"
    if scenario == "diurnal":
        heads = (tr < 10).double().view(tr.shape[0], 40, -1).mean(dim=(0, 2))
        require(float(heads.max() - heads.min()) > 0.05, f"diurnal: head shares {heads.tolist()}")
        return f"head10_share_min={float(heads.min())} max={float(heads.max())}"
    if scenario == "multi_tenant":
        shares = torch.bincount((tr // (n // 4)).flatten(), minlength=4).double() / tr.numel()
        want = zipf.zipf_probs(4, 1.0)
        require(np.abs(shares.cpu().numpy() - want).max() < 0.01, f"multi_tenant: tenant shares {shares.tolist()}")
        return f"tenant_shares={[round(float(x), 4) for x in shares]}"
    if scenario == "scan":
        steps = (tr[:, 1:] - tr[:, :-1]) % (n - n // 2)
        walked = float(((steps == 1) & (tr[:, 1:] >= n // 2)).double().mean())
        require(walked > 0.02, f"scan: {walked} of the steps walk one id")
        return f"walk_share={walked}"
    return ""


def router_checks(seed: int) -> None:
    """route_level on the card, for the three modes, bit-identical to numpy's on the same trace."""
    dspec = device_workloads.DeviceTraceSpec("stationary", FLEET_N, n_samples=FLEET_SAMPLES,
                                             trace_len=FLEET_BENCH_LEN, seed=seed)
    traces = device_workloads.make_traces_device(dspec, device="cuda")
    host = traces.cpu().numpy()
    for mode in router.ROUTER_MODES:
        for n_nodes, level_seed in ((FLEET_WIDTHS[0], 0), (FLEET_WIDTHS[1], 1)):
            got, ms = cuda_ms(lambda: router.route_level(traces, n_nodes, mode, seed=level_seed))
            want = router.route_level(host, n_nodes, mode, seed=level_seed)
            require(got.is_cuda and np.array_equal(got.cpu().numpy(), want),
                    f"route_level {mode} n={n_nodes} on the card != numpy")
            counts = np.bincount(want.ravel(), minlength=n_nodes)
            print(f"[fleet router {mode}] n_nodes={n_nodes} seed={level_seed} S={FLEET_SAMPLES} T={FLEET_BENCH_LEN} "
                  f"ms={ms} bit_identical=True load_min={counts.min()} load_max={counts.max()}", flush=True)


def row0(out: dict) -> dict:
    """Sample 0 of a batched fleet result: the single-sample result of its trace."""
    return fleet.sim._map(lambda v: v[0], out)


def fleet_phase(seed: int, card) -> dict:
    """The fleet phase: device traces, routers, the level-major fleet for every kind held to the
    oracle, plfua_dyn on device-made churn, tinylfu with grouped telemetry, and the paper's CPU time.
    Returns what the stream and shard phases reuse: sample 0's trace, assignment, bounded result and
    oracle result of the lru, plfu, plfua_dyn churn and tinylfu grouped runs, and the churn run's
    whole batch."""
    t_phase = time.perf_counter()
    keep = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx, initializer=_worker_init,
                                                initargs=(CPU_WORKER_NICE,)) as pool:
        # the two CPU runs first (the longest jobs), then the oracles, all overlapping the card's work
        tenants = generators.multi_tenant(FLEET_N, FLEET_SAMPLES, FLEET_LEN, seed=seed, n_tenants=TEL_GROUPS)
        tenant_assign = fleet_topology(FLEET_TEL_KIND).assignment(tenants)
        groups = generators.tenant_groups(FLEET_N, TEL_GROUPS)
        window = FLEET_LEN // TEL_WINDOWS
        cpu_grouped = pool.submit(fleet_cpu_run, FLEET_TEL_KIND, tenants, tenant_assign, window, TEL_GROUPS, groups)
        cpu_flat = pool.submit(fleet_cpu_run, FLEET_TEL_KIND, tenants, tenant_assign, window, 0, groups)
        tenant_oracle = pool.submit(fleet_oracle, FLEET_TEL_KIND, tenants[0], tenant_assign[0])
        traces = generators.stationary(FLEET_N, FLEET_SAMPLES, FLEET_LEN, seed=seed)
        assignments = fleet_topology("lru").assignment(traces)
        oracles = {kind: [pool.submit(fleet_oracle, kind, traces[s], assignments[s]) for s in range(FLEET_SAMPLES)]
                   for kind in FLEET_KINDS}

        device_trace_checks(seed)
        router_checks(seed)

        dev_traces = torch.as_tensor(traces, device="cuda")
        dev_assign = torch.as_tensor(assignments, device="cuda")
        # every kind on the card first, then each held to its oracles: those run meanwhile
        done = {}
        for kind in FLEET_KINDS:
            t0 = time.perf_counter()
            topo = fleet_topology(kind)
            out, wall_s, device_s = fleet_run(topo, dev_traces, dev_assign)
            prof = fleet_profile(topo, traces, assignments)
            done[kind] = (topo, out, wall_s, device_s, prof, time.perf_counter() - t0)
        for kind in FLEET_KINDS:
            t0 = time.perf_counter()
            topo, out, wall_s, device_s, prof, run_s = done.pop(kind)
            hold_to_oracle(kind, kind, out, oracles[kind])
            if kind in ("lru", "plfu"):
                keep[kind] = dict(trace=traces[0], assignment=assignments[0], row=row0(out),
                                  oracle=oracles[kind][0].result(), wall_s=wall_s)
            print(f"[fleet {kind}] N={FLEET_N} widths={list(FLEET_WIDTHS)} capacities={list(FLEET_CAPS)} router=hash "
                  f"S={FLEET_SAMPLES} T={FLEET_LEN} scenario=stationary wall_s={wall_s} "
                  f"{fleet_line(topo, out, wall_s, device_s, prof, card)} oracle=exact "
                  f"run_s={run_s:.3f} hold_s={time.perf_counter() - t0:.3f}", flush=True)

        # plfua_dyn on churn made on the card, routed there: its refreshes on global time
        t0 = time.perf_counter()
        topo = fleet_topology("plfua_dyn")
        dspec = device_workloads.DeviceTraceSpec("churn", FLEET_N, n_samples=FLEET_SAMPLES, trace_len=FLEET_LEN,
                                                 seed=seed)
        churn = device_workloads.make_traces_device(dspec, device="cuda")
        churn_assign = router.route_device(churn, FLEET_WIDTHS[0], "hash")
        host_churn, host_churn_assign = churn.cpu().numpy(), churn_assign.cpu().numpy()
        churn_oracle = [pool.submit(fleet_oracle, "plfua_dyn", host_churn[s], host_churn_assign[s])
                        for s in range(FLEET_SAMPLES)]
        spec = telemetry_spec.TelemetrySpec(FLEET_LEN // TEL_WINDOWS)
        out, wall_s, device_s = fleet_run(topo, churn, churn_assign, telemetry=spec)
        refreshes = [int(s[..., telemetry_spec.METRIC_INDEX["refreshes"]].sum(dim=-1).min()) for s in out["telemetry"]]
        want = [FLEET_LEN // lvl[0].effective_refresh for lvl in topo.levels]
        require(want[0] >= 2, "plfua_dyn's churn run: no request follows a refresh of its edges")
        require(refreshes == want, f"plfua_dyn's refreshes per node {refreshes}, on global time {want}")
        prof = fleet_profile(topo, host_churn, host_churn_assign)
        hold_to_oracle("plfua_dyn churn", "plfua_dyn", out, churn_oracle)
        keep["plfua_dyn churn"] = dict(trace=host_churn[0], assignment=host_churn_assign[0], row=row0(out),
                                       oracle=churn_oracle[0].result(), telemetry=spec, out=out,
                                       traces=churn, assignments=churn_assign, wall_s=wall_s)
        print(f"[fleet plfua_dyn churn] traces=make_traces_device(churn) assignment=route_device(hash) "
              f"S={FLEET_SAMPLES} T={FLEET_LEN} refreshes_per_node_by_level={refreshes} (global time: "
              f"T // refresh = {want}) {fleet_line(topo, out, wall_s, device_s, prof, card)} "
              f"oracle=exact elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

        # tinylfu with grouped telemetry on multi_tenant traces
        t0 = time.perf_counter()
        topo = fleet_topology(FLEET_TEL_KIND)
        spec = telemetry_spec.TelemetrySpec(window, TEL_GROUPS)
        dev_tenants = torch.as_tensor(tenants, device="cuda")
        dev_tenant_assign = torch.as_tensor(tenant_assign, device="cuda")
        out, wall_s, device_s = fleet_run(topo, dev_tenants, dev_tenant_assign, telemetry=spec, groups=groups)
        plain_out, plain_wall_s, _ = fleet_run(topo, dev_tenants, dev_tenant_assign)
        require(same_tree(to_numpy({k: out[k] for k in plain_out}), to_numpy(plain_out)),
                "tinylfu: grouped telemetry changed the fleet's outputs")
        require(same_tree(to_numpy(out), cpu_grouped.result()), "tinylfu grouped: the card != the CPU")
        flat = cpu_flat.result()["telemetry"]
        require(all(np.array_equal(s.sum(dim=-2).cpu().numpy(), f) for s, f in zip(out["telemetry"], flat)),
                "tinylfu: the grouped series summed over the groups != the ungrouped series")
        series_evictions = [int(s[..., telemetry_spec.METRIC_INDEX["evictions"]].sum()) for s in out["telemetry"]]
        pressure = [int(p.sum()) for p in out["telemetry_pressure"]]
        require(all(e > 0 for e in series_evictions) and sum(pressure) > 0,
                f"tinylfu grouped: a level's series has no eviction {series_evictions}, or no pressure {pressure}")
        prof = fleet_profile(topo, tenants, tenant_assign, telemetry=spec, groups=groups)
        keep["tinylfu grouped"] = dict(trace=tenants[0], assignment=tenant_assign[0], row=row0(out),
                                       oracle=tenant_oracle.result(), telemetry=spec, groups=groups, wall_s=wall_s)
        rep = fleet.fleet_report(topo, out, telemetry=spec)
        tenant_rows = rep.tenant_rows()
        print(f"[fleet {FLEET_TEL_KIND} grouped] traces=multi_tenant groups={TEL_GROUPS} W={window} S={FLEET_SAMPLES} "
              f"T={FLEET_LEN} telemetry_off_wall_s={plain_wall_s} wall_s={wall_s} "
              f"on_off={wall_s / plain_wall_s} {fleet_line(topo, out, wall_s, device_s, prof, card)} "
              f"tenant_p50_us={[r['p50_us'] for r in tenant_rows]} tenant_p99_us={[r['p99_us'] for r in tenant_rows]} "
              f"pressure={[r['eviction_pressure'] for r in tenant_rows]} series_evictions_by_level={series_evictions} "
              f"pressure_by_level={pressure} equals_off=True equals_cpu=True "
              f"group_sum_equals_ungrouped=True elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

    # the paper's CPU time: the pure-Python policies' management loop beside the kernel's device time
    trace = zipf.sample_traces(CPU_TIME_N, 1, CPU_TIME_LEN, seed=seed)
    dev_trace = torch.as_tensor(trace, device="cuda")
    for kind in CPU_TIME_KINDS:
        r = simulate.run_trace(policies.make_policy(kind, CPU_TIME_CAP, n_objects=CPU_TIME_N), trace[0])
        kw = dict(kind=kind, n_objects=CPU_TIME_N, capacity=CPU_TIME_CAP)
        kernel.cache_sim_cuda(dev_trace, **kw)  # warm-up
        got, ms = cuda_ms(lambda: kernel.cache_sim_cuda(dev_trace, **kw))
        require(int(got["hits"].sum()) == r.hits, f"{kind}: kernel hits {int(got['hits'].sum())} != policy {r.hits}")
        print(f"[fleet paper cpu time {kind}] N={CPU_TIME_N} cap={CPU_TIME_CAP} T={CPU_TIME_LEN} chr={r.chr} "
              f"evictions={r.evictions} cpu_s={r.cpu_time_s} wall_s={r.wall_time_s} "
              f"mgmt_energy_j={energy.mgmt_energy_j(r.cpu_time_s)} kernel_device_s={ms / 1e3} "
              f"kernel_j_at_power_limit={energy.device_energy_j(ms / 1e3, card.power_limit_w)} hits_equal=True "
              f"card={card.label!r}", flush=True)
    print(f"[fleet] elapsed_s={time.perf_counter() - t_phase:.3f}", flush=True)
    return keep


# --------------------------------------------------------- the placed fleet engine
#: benchmarks/fleet_bench.py::fleet_placement_sweep at its full width: plfu on the fleet topology, its 4
#: stationary samples, the placements below; prob(1.0) is also held to the level-major (lce) call
PLACED_SAMPLES, PLACED_SWEEP, PLACED_KIND = 4, ("lcd", "prob(0.5)", "admit", "prob(1.0)"), "plfu"
#: the mixed tree on churn made on the card: plfua_dyn periods 3,000 and 4,500 make chunks of 1,500
PLACED_MIXED = dict(kinds=("lru", "plfua_dyn", "plfua_dyn"), refresh=(0, 3_000, 4_500),
                    placements=("lcd", "admit", "prob(0.5)"))
#: depths, from the oracle on the CPU at seed 0 (PERF.md §4): PLACED_LEN is the least multiple of 500 at
#: which, in every sample, every level of the admit and prob(1.0) runs evicts, the root of the lcd and
#: prob(0.5) runs evicts, and every admit level turns a fill away (the last of them, admit's root, at
#: 13,123); lcd's edges and regionals and prob(0.5)'s regionals evict at no depth up to 20,000. The gdsf run
#: takes the first PLACED_BYTES_LEN requests of the same samples, where every level of it evicts and turns a
#: fill away (from 5,316 on): its byte loop runs all of its 8 victims at every step (no host sync), about
#: 6 times plfu's kernels a position. The mixed run is cut to 9,000, the least common multiple of its two
#: periods (its levels refresh 3 and 2 times, both at its last position): its root would evict from about
#: 18,500 on, and its regionals, under admit and a 2,400-id hot set, never fill.
PLACED_LEN, PLACED_BYTES_LEN, PLACED_MIXED_LEN = 13_500, 5_500, 9_000
#: per run: the levels that must evict in every sample, and the admit levels that must turn a fill away
PLACED_EVICTING = {"lcd": (2,), "prob(0.5)": (2,), "admit": (0, 1, 2), "prob(1.0)": (0, 1, 2),
                   "gdsf admit bytes": (0, 1, 2), "mixed": ()}
PLACED_REFUSING = {"admit": (0, 1, 2), "gdsf admit bytes": (0, 1, 2)}


def placed_topology(placements, kind=PLACED_KIND, **kw):
    return fleet.tree(n_objects=FLEET_N, widths=FLEET_WIDTHS, kinds=kind, capacities=FLEET_CAPS, router="hash",
                      placements=placements, **kw)


def placed_cpu_run(topo, traces: np.ndarray, assignments: np.ndarray, sizes=None, window: int = 0) -> dict:
    """The same placed call on the CPU (a CPU worker): numpy outputs."""
    with torch.inference_mode():
        tel = telemetry_spec.TelemetrySpec(window) if window else None
        return to_numpy(fleet.simulate_fleet_batch(topo, traces, assignments, tel, sizes, device="cpu"))


def refusals(label: str, out: dict) -> list:
    """Per level, the fills each sample's admit gate turned away: from the fill offers of a run with
    telemetry (misses minus offers), else the misses that were not filled (exact for plfu, which
    admits every offered miss)."""
    if "telemetry" in out:
        idx = telemetry_spec.METRIC_INDEX
        return [(s[..., idx["misses"]] - s[..., idx["fill_offers"]]).sum(dim=(1, 2)).cpu().numpy()
                for s in out["telemetry"]]
    require(label in PLACED_SWEEP, f"{label}: refusals need telemetry")
    return [(t["requests"] - t["hits"] - t["inserts"]).sum(dim=1).cpu().numpy() for t in out["tiers"]]


def hold_placed(label: str, out: dict, futures: list, cpu_future) -> list:
    """A placed run: every sample equal to the oracle, the card equal to the CPU run, and the
    run's caches working (PLACED_EVICTING, PLACED_REFUSING). Returns the refusals per level."""
    host = to_numpy(out)
    evictions = [t["evictions"].sum(axis=1) for t in host["tiers"]]
    for l in PLACED_EVICTING[label]:
        require(bool((evictions[l] > 0).all()), f"{label}: level {l} does not evict in every sample {evictions[l]}")
    refused = refusals(label, out)
    for l in PLACED_REFUSING.get(label, ()):
        require(bool((refused[l] > 0).all()), f"{label}: admit level {l} turns no fill away {refused[l]}")
    equal_to_oracle(label, host, futures)
    require(same_tree(host, cpu_future.result()), f"{label}: the card != the CPU")
    return [int(r.sum()) for r in refused]


def placed_line(topo, out: dict, wall_s: float, device_s: float, prof: tuple, refused: list, card) -> str:
    rep = fleet.fleet_report(topo, out)
    return (f"{fleet_line(topo, out, wall_s, device_s, prof, card)} placement_energy_j={rep.placement_energy_j} "
            f"turned_away_by_level={refused} kernels_per_position={prof[0].kernels / FLEET_PROFILE_LEN}")


def placed_phase(pool, seed: int, card, keep: dict) -> dict:
    """The time-major placed engine on the card: the placement sweep, gdsf under byte budgets with
    admit, and the mixed tree on churn made on the card, each held to the oracle and the CPU;
    prob(1.0) held to the level-major call. Returns the sweep's reports, and adds to ``keep`` sample
    0 of the admit run (trace, assignment, bounded result, oracle result) for the stream and shard
    phases."""
    t_phase = time.perf_counter()
    traces = generators.stationary(FLEET_N, PLACED_SAMPLES, PLACED_LEN, seed=seed)
    assignments = placed_topology("lcd").assignment(traces)
    sizes = simulate.bytes_catalogue(FLEET_N)
    bytes_topo = placed_topology("admit", kind="gdsf",
                                 capacity_bytes=tuple(simulate.bytes_budget(sizes, c) for c in FLEET_CAPS))
    runs = [(pl, placed_topology(pl), PLACED_LEN, {}) for pl in PLACED_SWEEP]
    runs.append(("gdsf admit bytes", bytes_topo, PLACED_BYTES_LEN,
                 dict(sizes=sizes, window=PLACED_BYTES_LEN // TEL_WINDOWS)))
    cpu = {label: pool.submit(placed_cpu_run, topo, traces[:, :t_n], assignments[:, :t_n], **kw)
           for label, topo, t_n, kw in runs}
    oracles = {label: [pool.submit(fleet_oracle, topo, traces[s, :t_n], assignments[s, :t_n], kw.get("sizes"))
                       for s in range(PLACED_SAMPLES)] for label, topo, t_n, kw in runs}
    mixed_topo = placed_topology(PLACED_MIXED["placements"], kind=PLACED_MIXED["kinds"],
                                 refresh=PLACED_MIXED["refresh"])
    dspec = device_workloads.DeviceTraceSpec("churn", FLEET_N, n_samples=PLACED_SAMPLES, trace_len=PLACED_MIXED_LEN,
                                             seed=seed)
    churn = device_workloads.make_traces_device(dspec, device="cuda")
    churn_assign = router.route_device(churn, FLEET_WIDTHS[0], "hash")
    host_churn, host_assign = churn.cpu().numpy(), churn_assign.cpu().numpy()
    window = PLACED_MIXED_LEN // TEL_WINDOWS
    cpu_mixed = pool.submit(placed_cpu_run, mixed_topo, host_churn, host_assign, window=window)
    mixed_oracle = [pool.submit(fleet_oracle, mixed_topo, host_churn[s], host_assign[s]) for s in range(PLACED_SAMPLES)]

    dev_traces = torch.as_tensor(traces, device="cuda")
    dev_assign = torch.as_tensor(assignments, device="cuda")
    reports = {}
    # every run on the card first, then each held to its oracle and CPU run: those run meanwhile
    done = {}
    for label, topo, t_n, kw in runs:
        t0 = time.perf_counter()
        call = {} if "sizes" not in kw else dict(sizes=kw["sizes"], telemetry=telemetry_spec.TelemetrySpec(kw["window"]))
        out, wall_s, device_s = fleet_run(topo, dev_traces[:, :t_n], dev_assign[:, :t_n], **call)
        prof = fleet_profile(topo, traces, assignments, **call)
        extra = ""
        if label == "prob(1.0)":
            lce, lce_wall_s, _ = fleet_run(placed_topology("lce"), dev_traces, dev_assign)
            require(same_tree(to_numpy({k: out[k] for k in lce}), to_numpy(lce)), "prob(1.0) != the level-major lce call")
            extra = f" equals_level_major_lce=True level_major_wall_s={lce_wall_s}"
        done[label] = (out, wall_s, device_s, prof, extra, time.perf_counter() - t0)
    for label, topo, t_n, kw in runs:
        t0 = time.perf_counter()
        out, wall_s, device_s, prof, extra, run_s = done.pop(label)
        refused = hold_placed(label, out, oracles[label], cpu[label])
        reports[label] = fleet.fleet_report(topo, out)
        if label == "admit":
            keep["placed admit"] = dict(trace=traces[0, :t_n], assignment=assignments[0, :t_n], row=row0(out),
                                        oracle=oracles[label][0].result(), wall_s=wall_s)
        print(f"[placed {label}] kind={topo.levels[0][0].kind} N={FLEET_N} widths={list(FLEET_WIDTHS)} "
              f"capacities={list(FLEET_CAPS)} placements={list(topo.placements)} router=hash S={PLACED_SAMPLES} "
              f"T={t_n} scenario=stationary {'sizes=lognormal budget=capacities x mean size ' if kw else ''}"
              f"wall_s={wall_s} {placed_line(topo, out, wall_s, device_s, prof, refused, card)} oracle=exact "
              f"equals_cpu=True{extra} run_s={run_s:.3f} hold_s={time.perf_counter() - t0:.3f}", flush=True)
    lcd, lce = reports["lcd"], reports["prob(1.0)"]
    print(f"[placed lcd_vs_lce] mgmt_saving={1 - lcd.mgmt_energy_j / lce.mgmt_energy_j} "
          f"dchr={lcd.total_chr - lce.total_chr} lcd_mgmt_j={lcd.mgmt_energy_j} lce_mgmt_j={lce.mgmt_energy_j} "
          f"lcd_placement_j={lcd.placement_energy_j} lce_placement_j={lce.placement_energy_j} "
          f"(lce = the prob(1.0) run; reported, not gated) card={card.label!r}", flush=True)

    # the mixed tree on churn made and routed on the card (its CPU run and oracles started with the sweep's)
    t0 = time.perf_counter()
    topo = mixed_topo
    spec = telemetry_spec.TelemetrySpec(window)
    out, wall_s, device_s = fleet_run(topo, churn, churn_assign, telemetry=spec)
    refreshes = [int(s[..., telemetry_spec.METRIC_INDEX["refreshes"]].sum(dim=-1).min()) for s in out["telemetry"]]
    want = [PLACED_MIXED_LEN // lvl[0].effective_refresh if lvl[0].kind == "plfua_dyn" else 0 for lvl in topo.levels]
    require(refreshes == want, f"mixed: refreshes per node {refreshes}, on global time {want}")
    prof = fleet_profile(topo, host_churn, host_assign, telemetry=spec)
    refused = hold_placed("mixed", out, mixed_oracle, cpu_mixed)
    print(f"[placed mixed] kinds={list(PLACED_MIXED['kinds'])} placements={list(topo.placements)} "
          f"refresh={list(PLACED_MIXED['refresh'])} chunk={fleet.sim._dyn_chunk(topo)} "
          f"traces=make_traces_device(churn) assignment=route_device(hash) S={PLACED_SAMPLES} T={PLACED_MIXED_LEN} "
          f"refreshes_per_node_by_level={refreshes} wall_s={wall_s} "
          f"{placed_line(topo, out, wall_s, device_s, prof, refused, card)} oracle=exact equals_cpu=True "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    print(f"[placed] elapsed_s={time.perf_counter() - t_phase:.3f}", flush=True)
    return reports


#: benchmarks/cdn_bench.py::cdn_hierarchy's full topology: 4 edges at 300 in front of a parent at 1,200,
#: N = 10,000, hash router, on churn; 8 samples at the fleet phase's depth
HIER_EDGES, HIER_EDGE_CAP, HIER_PARENT_CAP, HIER_KINDS = 4, 300, 1_200, ("plfua", "plfua_dyn", "tinylfu")


def hierarchy_spec(kind: str):
    return cdn.two_tier(kind, FLEET_N, n_edges=HIER_EDGES, edge_capacity=HIER_EDGE_CAP,
                        parent_capacity=HIER_PARENT_CAP, router="hash")


def hierarchy_oracle(kind: str, trace: np.ndarray, assignment: np.ndarray) -> dict:
    """One sample through ``cdn.simulate_hierarchy_reference`` (a CPU worker)."""
    ref = cdn.simulate_hierarchy_reference(hierarchy_spec(kind), trace, assignment)
    edge_in, parent_in = ref.in_cache(FLEET_N)
    return {"edge_hit": ref.edge_hit, "parent_hit": ref.parent_hit, "edge_in": edge_in, "parent_in": parent_in,
            "edge_evictions": [p.evictions for p in ref.edges], "parent_evictions": ref.parent.evictions}


def hierarchy_phase(pool, seed: int, card) -> None:
    """The two-tier hierarchy on the card, each sample equal to its oracle."""
    t_phase = time.perf_counter()
    traces = generators.churn(FLEET_N, FLEET_SAMPLES, FLEET_LEN, seed=seed)
    assignments = hierarchy_spec("plfua").assignment(traces)
    oracles = {kind: [pool.submit(hierarchy_oracle, kind, traces[s], assignments[s]) for s in range(FLEET_SAMPLES)]
               for kind in HIER_KINDS}
    dev_traces, dev_assign = torch.as_tensor(traces, device="cuda"), torch.as_tensor(assignments, device="cuda")
    total = {}
    for kind in HIER_KINDS:
        t0 = time.perf_counter()
        hspec = hierarchy_spec(kind)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = cdn.simulate_hierarchy_batch(hspec, dev_traces, dev_assign, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        host = to_numpy(out)
        for s, future in enumerate(oracles[kind]):
            ref = future.result()
            for key, got in (("edge_hit", host["edge_hit"][s]), ("parent_hit", host["parent_hit"][s]),
                             ("edge_in", host["edge_states"]["in_cache"][s]),
                             ("parent_in", host["parent_state"]["in_cache"][s]),
                             ("edge_evictions", host["edge"]["evictions"][s]),
                             ("parent_evictions", host["parent"]["evictions"][s])):
                require(np.array_equal(got, ref[key]), f"hierarchy {kind}: sample {s} {key}")
        require(int(host["parent"]["evictions"].sum()) > 0, f"hierarchy {kind}: the parent never evicted")
        rep = cdn.hierarchy_report(hspec, out)
        total[kind] = rep.total_chr
        print(f"[hierarchy {kind}] edges={HIER_EDGES}x{HIER_EDGE_CAP} parent={HIER_PARENT_CAP} N={FLEET_N} router=hash "
              f"scenario=churn S={FLEET_SAMPLES} T={FLEET_LEN} edge_chr={rep.edge_chr} parent_chr={rep.parent_chr} "
              f"total_chr={rep.total_chr} origin={rep.origin_requests} "
              f"edge_evictions={int(host['edge']['evictions'].sum())} "
              f"parent_evictions={int(host['parent']['evictions'].sum())} mgmt_cpu_s={rep.mgmt_cpu_s} "
              f"mgmt_energy_j={rep.mgmt_energy_j} wall_s={wall_s} ms_per_request={wall_s * 1e3 / traces.size} "
              f"oracle=exact card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    print(f"[hierarchy] churn_plfua_dyn_total_chr={total['plfua_dyn']} churn_plfua_total_chr={total['plfua']} "
          f"plfua_dyn_minus_plfua={total['plfua_dyn'] - total['plfua']} (the reference's acceptance property; "
          f"reported, not gated) elapsed_s={time.perf_counter() - t_phase:.3f}", flush=True)


# --------------------------------------------------------- the streaming fleet engine
#: the fleet phase's runs (8 -> 2 -> 1, T = 20,000, sample 0) as 8 chunks of 2,500 (its window of 1,250
#: divides a chunk), the placed phase's admit run (T = 13,500) as 9 chunks of 1,500
STREAM_CHUNK, STREAM_PLACED_CHUNK = 2_500, 1_500
STREAM_LEVEL_MAJOR = ("lru", "plfua_dyn churn", "tinylfu grouped")
#: benchmarks/stream_bench.py's reduced rows (N = 2**16, capacity 2**12, on ``stationary``, seeds 40
#: and 41) cut from 24 chunks of 1,024 to 18: their caches first evict in the 16th (3,400-3,500
#: distinct ids in 12 chunks for 4,096 slots, on CPU-drawn streams of the same law; the card draws
#: its own) and plfua_dyn with a refresh of 4 chunks (seed 42; 8 chunks, two
#: refreshes: it admits only hot ids, fewer of which arrive than it has slots, so at this width it
#: evicted in none of 24 chunks), through
#: ``stream_fleet``: (kind, seed, options, chunks); the acceptance width (N = 2**20, capacity 2**16, chunks of 2,048) timed over 8
#: chunks, the acceptance row's 100,001,792 requests extrapolated from it, not run
STREAM_FAST_N, STREAM_FAST_CAP, STREAM_FAST_CHUNK = 1 << 16, 1 << 12, 1_024
STREAM_FAST_ROWS = (("lru", 40, {}, 18), ("tinylfu", 41, {}, 18), ("plfua_dyn", 42, {"refresh": 4 * 1_024}, 8))
STREAM_FULL_N, STREAM_FULL_CAP, STREAM_FULL_CHUNK, STREAM_FULL_CHUNKS = 1 << 20, 1 << 16, 2_048, 8
STREAM_ACCEPT_REQUESTS = 100_001_792  # BENCH_PR10.json's fleet_stream/lru_flat_n1048576 (48,829 chunks)


def done_future(value) -> concurrent.futures.Future:
    future = concurrent.futures.Future()
    future.set_result(value)
    return future


def stream_push(fs, trace, assignment, chunk_len: int) -> tuple:
    """Push a card trace through ``fs`` chunk by chunk, the first chunk under ``timing.profile``
    (CUDA activity only, no trace file): (each chunk's result, the host wall s of the other chunks to
    the last one's end on the device, the first chunk's profile, the host s it took)."""
    part = lambda c: (trace[c: c + chunk_len], None if assignment is None else assignment[c: c + chunk_len])
    outs = []
    t0 = time.perf_counter()
    prof = timing.profile(lambda: outs.append(fs.push(*part(0))), profile_dir=None)
    profile_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs += [fs.push(*part(c)) for c in range(chunk_len, trace.shape[0], chunk_len)]
    fs.block()
    return outs, time.perf_counter() - t0, prof, profile_s


def stream_result(fs, outs) -> dict:
    """A stream's run in ``simulate_fleet``'s single-sample layout."""
    st = fs.stats()
    res = {"hit": tuple(torch.cat([o["hit"][l] for o in outs]) for l in range(len(outs[0]["hit"]))),
           "node_hit": tuple(torch.cat([o["node_hit"][l] for o in outs], dim=-1) for l in range(len(outs[0]["hit"]))),
           "tiers": st.tiers, "states": fs.states(), "origin_miss": torch.cat([o["origin_miss"] for o in outs])}
    if st.telemetry is not None:
        res["telemetry"] = st.telemetry
    if st.telemetry_pressure is not None:
        res["telemetry_pressure"] = st.telemetry_pressure
    return res


def hold_stream(label: str, res: dict, kept: dict) -> None:
    """A stream run bit for bit the bounded call's sample 0 (every key the stream returns) and
    equal to that sample's oracle."""
    want = {k: kept["row"][k] for k in res}
    require(same_tree(to_numpy(res), to_numpy(want)), f"stream {label}: != the bounded call's sample 0")
    host = fleet.sim._map(lambda v: v[None], to_numpy({k: res[k] for k in ("hit", "states", "tiers", "origin_miss")}))
    equal_to_oracle(f"stream {label}", host, [done_future(kept["oracle"])])


def stream_line(requests: int, chunks: int, wall_s: float, prof, profile_s: float, card) -> str:
    """A stream line's times over ``chunks`` timed chunks of ``requests`` requests in ``wall_s``."""
    return (f"ms_per_chunk={wall_s * 1e3 / chunks} us_per_request={wall_s * 1e6 / requests} "
            f"requests_per_s={requests / wall_s} kernels_per_chunk={prof.kernels} "
            f"idle_share_first_chunk={prof.idle_share} profile_s={profile_s:.3f} "
            f"j_per_step={energy.mgmt_energy_j(wall_s) / requests} (core.energy's CPU-core model over the wall "
            f"clock) j_per_request_at_power_limit_upper_bound={card.power_limit_w * wall_s / requests} "
            f"card={card.label!r}")


def stream_profile(make, push_args: tuple) -> tuple:
    """(trace, host s) of a fresh stream's first chunk under ``timing.profile`` (CUDA activity only,
    no trace file)."""
    t0 = time.perf_counter()
    fs = make()
    trace = timing.profile(fs.push, *push_args, profile_dir=None)
    return trace, time.perf_counter() - t0


def fast_topology(kind: str, n: int, cap: int, opts: dict):
    return fleet.tree(n_objects=n, widths=(1,), kinds=kind, capacities=cap, **{k: (v,) for k, v in opts.items()})


def fast_row(kind: str, seed: int, opts: dict, n: int, cap: int, chunk_len: int, n_chunks: int, card) -> tuple:
    """One fast row through ``stream_fleet`` (double-buffered generation): (stats, the stream, its
    first chunk's profile and profile s)."""
    cfg = fleet.StreamConfig(topo=fast_topology(kind, n, cap, opts), chunk_len=chunk_len, fast=True)
    dspec = device_workloads.DeviceTraceSpec("stationary", n, n_samples=1, trace_len=chunk_len, seed=seed)
    fs = fleet.FleetStream(cfg, device="cuda")
    st = fleet.stream_fleet(cfg, dspec, n_chunks, device="cuda", stream=fs)
    first = device_workloads.gen_stream_chunk(dspec, 0, 0, device="cuda")
    prof, profile_s = stream_profile(lambda: fleet.FleetStream(cfg, device="cuda"), (first,))
    return st, fs, dspec, prof, profile_s


def stream_phase(keep: dict, card) -> None:
    """The streaming engine on the card: the fleet phase's runs as chunks (level-major), the placed
    phase's admit run as chunks (placed), each bit for bit the bounded call's sample 0 and equal to
    its oracle; the fast rows through ``stream_fleet``, each equal to the cache_sim program on the
    concatenated chunks; the acceptance width timed."""
    t_phase = time.perf_counter()
    for label in STREAM_LEVEL_MAJOR:
        t0 = time.perf_counter()
        kept = keep[label]
        kind = label.split()[0]
        topo = fleet_topology(kind)
        tel = kept.get("telemetry")
        cfg = fleet.StreamConfig(topo=topo, chunk_len=STREAM_CHUNK, telemetry=tel)
        kw = dict(groups=kept["groups"]) if "groups" in kept else {}
        trace = torch.as_tensor(kept["trace"], device="cuda")
        assignment = torch.as_tensor(kept["assignment"], device="cuda")
        fs = fleet.FleetStream(cfg, device="cuda", **kw)
        outs, wall_s, prof, profile_s = stream_push(fs, trace, assignment, STREAM_CHUNK)
        res = stream_result(fs, outs)
        hold_stream(label, res, kept)
        st = fs.stats()
        evictions = [int(t["evictions"].sum()) for t in st.tiers]
        sub = [fleet.stream._sub_len(lvl[0], STREAM_CHUNK) for lvl in topo.levels]
        print(f"[stream level-major {label}] N={FLEET_N} widths={list(FLEET_WIDTHS)} capacities={list(FLEET_CAPS)} "
              f"T={FLEET_LEN} chunk={STREAM_CHUNK} chunks={st.chunks} refresh_sub_chunks={sub} "
              f"telemetry={None if tel is None else (tel.window, tel.n_groups)} total_chr={st.total_chr} "
              f"evictions_by_level={evictions} origin_misses={st.origin_misses} "
              f"{stream_line(st.requests - STREAM_CHUNK, st.chunks - 1, wall_s, prof, profile_s, card)} "
              f"(chunks 2 to {st.chunks} timed, the first profiled) bounded_wall_s_{FLEET_SAMPLES}_samples="
              f"{kept['wall_s']} equals_bounded=True oracle=exact "
              f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

    # the placed engine's admit run as chunks
    t0 = time.perf_counter()
    kept = keep["placed admit"]
    topo = placed_topology("admit")
    cfg = fleet.StreamConfig(topo=topo, chunk_len=STREAM_PLACED_CHUNK)
    trace = torch.as_tensor(kept["trace"], device="cuda")
    assignment = torch.as_tensor(kept["assignment"], device="cuda")
    fs = fleet.FleetStream(cfg, device="cuda")
    outs, wall_s, prof, profile_s = stream_push(fs, trace, assignment, STREAM_PLACED_CHUNK)
    hold_stream("placed admit", stream_result(fs, outs), kept)
    st = fs.stats()
    timed = st.requests - STREAM_PLACED_CHUNK
    print(f"[stream placed admit] kind={PLACED_KIND} N={FLEET_N} widths={list(FLEET_WIDTHS)} T={trace.shape[0]} "
          f"chunk={STREAM_PLACED_CHUNK} chunks={st.chunks} total_chr={st.total_chr} "
          f"evictions_by_level={[int(t['evictions'].sum()) for t in st.tiers]} origin_misses={st.origin_misses} "
          f"ms_per_position={wall_s * 1e3 / timed} kernels_per_position={prof.kernels / STREAM_PLACED_CHUNK} "
          f"{stream_line(timed, st.chunks - 1, wall_s, prof, profile_s, card)} (chunks 2 to {st.chunks} timed, "
          f"the first profiled) bounded_wall_s_{PLACED_SAMPLES}_samples={kept['wall_s']} equals_bounded=True "
          f"oracle=exact "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

    # the fast rows, each held to the cache_sim program on its concatenated chunks
    fast_ms = {}
    for kind, seed, opts, n_chunks in STREAM_FAST_ROWS:
        t0 = time.perf_counter()
        n, cap, g_n = STREAM_FAST_N, STREAM_FAST_CAP, STREAM_FAST_CHUNK
        st, fs, dspec, prof, profile_s = fast_row(kind, seed, opts, n, cap, g_n, n_chunks, card)
        traces = torch.cat([device_workloads.gen_stream_chunk(dspec, 0, c, device="cuda")
                            for c in range(n_chunks)])[None]
        got = ops.cache_sim_outputs(traces, kind=kind, n_objects=n, capacity=cap, device="cuda", **opts)
        state = fs.states()[0]
        require(int(got["hits"][0]) == st.hits, f"fast {kind}: hits {st.hits} != the kernel's {int(got['hits'][0])}")
        require(torch.equal(got["in_cache"][0], state["in_cache"]), f"fast {kind}: in_cache != the kernel's")
        if kind == "lru":
            seen = torch.zeros_like(state["in_cache"]).scatter_(0, traces[0].long(), True)
            row, field = torch.where(seen, state["last"] + 1, 0), "stamps"
        else:
            row, field = state["freq"], "freq"
        require(torch.equal(got["freq"][0], row.to(torch.int32)), f"fast {kind}: {field} != the kernel's")
        if "inserts" in state:
            require(int(got["inserts"][0]) == int(state["inserts"]), f"fast {kind}: inserts != the kernel's")
        evictions = int(got["inserts"][0]) - int(state["count"])
        require(kind == "plfua_dyn" or evictions > 0, f"fast {kind}: the cache never evicted")
        fast_ms[kind] = st.elapsed_s * 1e3 / st.chunks
        print(f"[stream fast {kind}] N={n} cap={cap} chunk={g_n} chunks={n_chunks} seed={seed} "
              f"options={json.dumps(opts)} lanes={min(2 * g_n, cap + g_n) + g_n} total_chr={st.total_chr} "
              f"evictions={evictions} {stream_line(st.requests, st.chunks, st.elapsed_s, prof, profile_s, card)} "
              f"equals_cache_sim=True (hits, in_cache, {field}) elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

    # the acceptance width: timed only
    t0 = time.perf_counter()
    st, fs, _, prof, profile_s = fast_row("lru", 40, {}, STREAM_FULL_N, STREAM_FULL_CAP, STREAM_FULL_CHUNK,
                                          STREAM_FULL_CHUNKS, card)
    ms = st.elapsed_s * 1e3 / st.chunks
    n_accept = -(-STREAM_ACCEPT_REQUESTS // STREAM_FULL_CHUNK)
    print(f"[stream fast lru full width] N={STREAM_FULL_N} cap={STREAM_FULL_CAP} chunk={STREAM_FULL_CHUNK} "
          f"chunks={st.chunks} count={int(fs.states()[0]['count'])} total_chr={st.total_chr} "
          f"{stream_line(st.requests, st.chunks, st.elapsed_s, prof, profile_s, card)} "
          f"ms_per_chunk_n65536={fast_ms['lru']} ms_per_request_ratio_to_n65536="
          f"{(ms / STREAM_FULL_CHUNK) / (fast_ms['lru'] / STREAM_FAST_CHUNK)} "
          f"extrapolated_acceptance_row_h={ms * n_accept / 3.6e6} (an extrapolation: {n_accept} chunks x "
          f"ms_per_chunk; not run) elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    print(f"[stream] elapsed_s={time.perf_counter() - t_phase:.3f}", flush=True)


# ----------------------------------------------- the multi-device fleet on torch.distributed
#: a gloo world of 2 ranks on the one card (NCCL takes one rank a device): each rank one process on
#: cuda:0, its collectives' operands staged through the host
SHARD_WORLD, SHARD_TIMEOUT_S = 2, 420
SHARD_DIR = Path(__file__).resolve().parent / "build" / "shard"


def shard_rank(rank: int, world: int, seed: int, t_start: float) -> None:
    """One rank of the shard phase's world: the edge-sharded level-major run (plfu, the fleet phase's
    sample 0), the edge-sharded placed run (plfu admit, the placed phase's sample 0) and the
    sample-sharded device run (plfua_dyn on the fleet phase's churn, 8 samples), each whole result
    and its wall time written to ``SHARD_DIR``."""
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"file://{SHARD_DIR}/init", world_size=world,
                                         rank=rank)
    mesh = fleet.fleet_mesh(device="cuda")
    out = {}

    def timed(name, fn, *args, **kw):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        out[name] = (to_numpy(res), time.perf_counter() - t0)

    traces = generators.stationary(FLEET_N, FLEET_SAMPLES, FLEET_LEN, seed=seed)
    timed("level-major plfu", fleet.simulate_fleet_sharded, fleet_topology("plfu"), traces[0],
          fleet_topology("lru").assignment(traces)[0], mesh=mesh, device="cuda")
    placed = generators.stationary(FLEET_N, PLACED_SAMPLES, PLACED_LEN, seed=seed)
    timed("placed admit", fleet.simulate_fleet_sharded, placed_topology("admit"), placed[0],
          placed_topology("lcd").assignment(placed)[0], mesh=mesh, device="cuda")
    dspec = device_workloads.DeviceTraceSpec("churn", FLEET_N, n_samples=FLEET_SAMPLES, trace_len=FLEET_LEN,
                                             seed=seed)
    timed("device plfua_dyn churn", fleet.simulate_fleet_device, fleet_topology("plfua_dyn"), dspec, mesh=mesh,
          device="cuda")
    out["total_s"] = time.perf_counter() - t_start  # the process's life, its start-up included
    torch.save(out, SHARD_DIR / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def shard_start(seed: int) -> list:
    """Start the shard phase's world (it runs beside the check phase: both only check, neither
    times anything reported)."""
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--seed", str(seed), "--shard-rank",
                              str(r), "--shard-world", str(SHARD_WORLD)], env=env,
                             stdout=open(SHARD_DIR / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
            for r in range(SHARD_WORLD)]


def shard_wait(procs: list, deadline: float) -> None:
    """Wait for the world until ``deadline`` (``time.monotonic()``): as soon as a rank exits non-zero,
    or at the deadline, kill the ranks still running (a rank left alone would block in a collective)."""
    try:
        while any(p.poll() is None for p in procs) and all(p.returncode in (None, 0) for p in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        log = (SHARD_DIR / f"rank{r}.log").read_text()[-3000:]
        require(p.returncode == 0, f"shard rank {r} exited {p.returncode} (killed if < 0: at the deadline, or "
                                   f"after another rank failed): {log}")


def shard_stop(procs: list) -> None:
    """Kill the ranks still running (a phase beside them failed)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def shard_phase(keep: dict, card) -> None:
    """Each rank's whole result bit for bit the single-process call's (the fleet and placed phases'
    sample 0, the churn run's 8 samples with its traces and assignments)."""
    t_phase = time.perf_counter()
    ranks = [torch.load(SHARD_DIR / f"rank{r}.pt", weights_only=False) for r in range(SHARD_WORLD)]
    churn = keep["plfua_dyn churn"]
    single = {
        "level-major plfu": (keep["plfu"]["row"], keep["plfu"]["wall_s"], "fleet phase, 8 samples"),
        "placed admit": (keep["placed admit"]["row"], keep["placed admit"]["wall_s"], "placed phase, 4 samples"),
        "device plfua_dyn churn": (churn["out"], churn["wall_s"], "fleet phase, 8 samples, +telemetry"),
    }
    for name, (want, single_wall_s, single_what) in single.items():
        walls = []
        for r, got in enumerate(ranks):
            res, wall_s = got[name]
            walls.append(wall_s)
            if name.startswith("device"):
                res, traces, assignments = res
                require(np.array_equal(traces, churn["traces"].cpu().numpy()), f"shard {name}: rank {r} traces")
                require(np.array_equal(assignments, churn["assignments"].cpu().numpy()),
                        f"shard {name}: rank {r} assignments")
            require(same_tree(res, to_numpy({k: want[k] for k in res})), f"shard {name}: rank {r} != one process")
        print(f"[shard {name}] world={SHARD_WORLD} backend=gloo (operands staged through the host) device=cuda:0 "
              f"equals_single_process=True (every rank, every key) sharded_wall_s_by_rank={walls} "
              f"single_process_wall_s={single_wall_s} ({single_what}) (one card, the world beside the check "
              f"phase: correctness only, not a speed) card={card.label!r}", flush=True)
    print(f"[shard] rank_process_s={[round(r['total_s'], 3) for r in ranks]} (start-up, gloo, three runs) "
          f"elapsed_s={time.perf_counter() - t_phase:.3f}", flush=True)


# -------------------------------------------------------------- serving path
SERVE_ARCH = "smollm-360m"
#: the reference launcher's traffic: 20 objects, 40 requests from zipf.sample_trace(20, 40, seed=1),
#: a content cache of 5 objects under plfua
SERVE_OBJECTS, SERVE_REQUESTS, SERVE_TRACE_SEED, SERVE_CACHE_OBJECTS, SERVE_POLICY = 20, 40, 1, 5, "plfua"
SERVE_PROMPT, SERVE_NEW, SERVE_CACHE_LEN = 2_048, 8, 2_056
#: one request past the full config's chunk threshold (8,192)
LONG_PROMPT, LONG_NEW = 16_384, 4
#: the card-vs-CPU check: one request at full width
CHECK_PROMPT, CHECK_NEW = 128, 4
#: its logit tolerance: 8 bf16 ulps at the logits' magnitude (|logit| < 4, ulp 2**-6 in [2, 4)).
#: The card's kernel keeps p in f32 where the CPU path rounds it to bf16 before PV (as the
#: reference does), and the two round bf16 matmuls differently; a 4-layer model at full width
#: differs by 2 ulps (0.03) between the two attention roundings on the CPU.
SERVE_LOGIT_TOL = 0.125
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:42"  # _flash_kernel
#: SDPA's backends by the number its dispatch (``torch._fused_sdp_choice``) returns
SDP_BACKENDS = {int(b): name for name, b in SDPBackend.__members__.items()}
#: H100 SXM dense bf16 tensor-core rate (NVIDIA's data sheet)
BF16_FLOPS_PER_S = energy.H100_SXM_PEAK_BF16_FLOPS
#: torch.cuda._sleep's cycles a second: the H100's top SM clock (1,980 MHz), so a sleep is at least as
#: long as asked
SLEEP_CYCLES_PER_S = 1.98e9
#: the least sleep before timed calls: room for the host's jitter when few calls are queued
SLEEP_MIN_S = 0.02
#: (atol, rtol) of the kernel against its plain version. Both accumulate the same f32 function
#: (p in f32) from the same inputs: in float32 they differ by summation order; in bfloat16 by
#: one rounding of the output, 1 bf16 ulp (rtol 2**-7 covers 1 to 2 ulps), above a floor of 1e-4
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2**-7)}
#: the tolerance the flash check had before, printed beside each wrong version's reading
FLASH_OLD_BF16_TOL = (2e-2, 2e-2)
#: (B, H, KH, Sq, Skv, D, causal, kv_len): tests/test_kernels_flash.py's SWEEP, its kv_len case, and
#: the edges of the prefill's 128-row, 64-key tiles and of the decode splits (tests/test_torch_cuda.py's
#: FLASH_EDGES)
FLASH_SWEEP = (
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 256, 256, 128, True, None),
    (1, 2, 1, 96, 160, 64, True, None),
    (1, 2, 2, 128, 384, 64, False, None),
    (2, 3, 3, 64, 64, 32, True, None),
    (1, 2, 2, 1, 512, 64, False, None),
    (1, 16, 8, 1, 300, 128, False, None),
    (1, 4, 4, 1, 256, 64, False, 100),
    (1, 4, 2, 17, 17, 64, True, None),
    (1, 4, 2, 100, 100, 64, True, None),
    (1, 4, 2, 100, 160, 64, True, 130),
    (1, 4, 4, 200, 90, 64, False, None),
    (1, 16, 2, 150, 150, 64, True, None),
    (1, 4, 2, 130, 130, 16, True, None),
    (1, 4, 2, 130, 200, 128, False, 180),
    (1, 15, 5, 1, 530, 64, False, 40),
    (1, 15, 5, 1, 48, 64, False, None),
    (8, 32, 32, 1, 300, 64, False, None),
    (2, 16, 2, 16, 700, 16, True, 650),
    (1, 4, 4, 130, 130, 192, True, None),
    (1, 8, 8, 12, 12, 192, True, None),
)
#: the served models' shapes: smollm's (1, 15, 5, 64), causal prefill at 2,048 and 16,384, decode
#: against a cache of 2,056 at kv_len 1, 2,049 and 2,056; a D = 128 prefill; deepseek's MLA
#: prefill (1, 128, 128, 192) at 2,048; jamba's attention layer (1, 64, 8, 128), its causal
#: prefill at 2,048 and its decode against a cache of 2,056 at kv_len 1, 2,049 and 2,056; whisper's
#: (1, 20, 20, 64), MHA: the encoder's non-causal self-attention over 1,500 frames, cross-attention
#: (non-causal, Sq != Skv: the source's last key tile holds 28 of 64 keys) from prompts of 4 rows (the
#: decode instance) and 128, the cross decode over the whole source, the decoder's causal prefill at 4
#: and 128 and its decode against the self cache of 448; llava's (1, 32, 8, 128): the causal prefill
#: over prefix and text at 2,048, decode against a cache of 2,056 at kv_len 2,049 and 2,056
FLASH_SERVED = (
    (1, 15, 5, 2_048, 2_048, 64, True, None),
    (1, 15, 5, 16_384, 16_384, 64, True, None),
    (1, 15, 5, 1, 2_056, 64, False, 1),
    (1, 15, 5, 1, 2_056, 64, False, 2_049),
    (1, 15, 5, 1, 2_056, 64, False, 2_056),
    (1, 24, 8, 1_024, 1_024, 128, True, None),
    (1, 128, 128, 2_048, 2_048, 192, True, None),
    (1, 64, 8, 2_048, 2_048, 128, True, None),
    (1, 64, 8, 1, 2_056, 128, False, 1),
    (1, 64, 8, 1, 2_056, 128, False, 2_049),
    (1, 64, 8, 1, 2_056, 128, False, 2_056),
    (1, 20, 20, 1_500, 1_500, 64, False, None),
    (1, 20, 20, 4, 1_500, 64, False, None),
    (1, 20, 20, 128, 1_500, 64, False, None),
    (1, 20, 20, 1, 1_500, 64, False, 1_500),
    (1, 20, 20, 4, 4, 64, True, None),
    (1, 20, 20, 128, 128, 64, True, None),
    (1, 20, 20, 1, 448, 64, False, 144),
    (1, 32, 8, 2_048, 2_048, 128, True, None),
    (1, 32, 8, 1, 2_056, 128, False, 2_049),
    (1, 32, 8, 1, 2_056, 128, False, 2_056),
)
#: the wrong version's causal bound: this many keys early (one kernel tile at D = 64)
FLASH_WRONG_SHIFT = 64
#: the plain version's query rows a chunk (bounds its scores at 16,384 to 1 GB)
FLASH_PLAIN_ROWS = 1_024


def flash_inputs(b, h, kh, sq, skv, d, dtype, seed, kv_len=None):
    """q, k, v on the card from a seeded generator; garbage (1e6) in K past kv_len."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, kh, skv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, kh, skv, d, generator=gen, device="cuda").to(dtype)
    if kv_len is not None:
        k[:, :, kv_len:] = 1e6
    return q, k, v


def bf16_p_attention(q, k, v, *, causal, scale, kv_len, q_offset):
    """A deliberately wrong version: ``naive_attention`` with p rounded to
    bf16 before P V, as one bf16 wgmma operand would take it."""
    group = q.shape[1] // k.shape[1]
    kq, vq = (torch.repeat_interleave(x, group, dim=1).float() for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    col = torch.arange(k.shape[2], device=q.device)[None, :]
    live = col < kv_len
    if causal:
        live = live & (col <= q_offset + torch.arange(q.shape[2], device=q.device)[:, None])
    s = torch.where(live, s, torch.tensor(-1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vq)
    return (pv / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_plain(q, k, v, *, causal, kv_len, shift=0, attention=naive_attention):
    """The plain version with the query rows in chunks of FLASH_PLAIN_ROWS
    (which bounds the scores' memory at 16,384 rows); ``shift`` moves the
    causal bound that many rows, and ``attention=bf16_p_attention`` rounds p
    (deliberately wrong versions)."""
    scale, kv_len = flash.check_inputs(q, k, v, kv_len=kv_len)
    return torch.cat([attention(q[:, :, r0:r0 + FLASH_PLAIN_ROWS], k, v, causal=causal, scale=scale,
                                kv_len=kv_len, q_offset=r0 + shift)
                      for r0 in range(0, q.shape[2], FLASH_PLAIN_ROWS)], dim=2)


def tol_ratio(got, want, tol, rows=None) -> float:
    """The largest |got - want| / (atol + rtol |want|) (over query rows
    ``rows`` if given): above 1 fails."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[:, :, rows], want[:, :, rows]
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def flash_wrong(q, k, v, causal, kv_len) -> list[tuple[str, torch.Tensor]]:
    """Deliberately wrong versions of the case, from the plain version (p
    rounded to bf16: in bf16, where it is the single-operand design's error;
    a non-causal case read causally, and without its last partial tile of 64
    keys)."""
    if causal:
        wrong = [(f"causal bound {FLASH_WRONG_SHIFT} keys early",
                  flash_plain(q, k, v, causal=True, kv_len=kv_len, shift=-FLASH_WRONG_SHIFT))]
        if q.dtype == torch.bfloat16:
            wrong.append(("p rounded to bf16",
                          flash_plain(q, k, v, causal=True, kv_len=kv_len, attention=bf16_p_attention)))
        return wrong
    if kv_len == 1:
        return [("one garbage key let in", flash_plain(q, k, v, causal=False, kv_len=kv_len + 1))]
    wrong = [("last live key dropped", flash_plain(q, k, v, causal=False, kv_len=kv_len - 1)),
             ("a causal mask on a non-causal case", flash_plain(q, k, v, causal=True, kv_len=kv_len))]
    if kv_len % FLASH_WRONG_SHIFT > 1:
        whole = kv_len - kv_len % FLASH_WRONG_SHIFT
        wrong.append(("the last partial key tile dropped", flash_plain(q, k, v, causal=False, kv_len=whole)))
    return wrong


def flash_checks(seed: int) -> dict:
    """The kernel against its plain version on the card (TF32 off): the SWEEP
    rows, the kv_len case, the served shapes, a D = 128 prefill and the D =
    192 rows (MLA), each in float32 and bfloat16; for each served case, what a
    wrong version reads. Returns the worst error per kernel instance, and of
    the D = 192 prefill (``MLA_FLASH_ENTRY``), of jamba's two shapes
    (``JAMBA_PREFILL_ENTRY``, ``JAMBA_DECODE_ENTRY``: 64 heads of 128 over 8
    kv heads) and of whisper's and llava's measured shapes (their entries)."""
    t0 = time.perf_counter()
    by_shape = {shape[:7]: entry for entry, _, shape in WHISPER_FLASH_SHAPES + LLAVA_FLASH_SHAPES}
    worst = dict.fromkeys(flash.INSTANCES + (MLA_FLASH_ENTRY, JAMBA_PREFILL_ENTRY, JAMBA_DECODE_ENTRY)
                          + tuple(by_shape.values()), 0.0)
    cases = [(c, dt, c in FLASH_SERVED) for c in FLASH_SWEEP + FLASH_SERVED for dt in (torch.float32, torch.bfloat16)]
    for i, ((b, h, kh, sq, skv, d, causal, kv_len), dtype, served) in enumerate(cases):
        t1 = time.perf_counter()
        q, k, v = flash_inputs(b, h, kh, sq, skv, d, dtype, seed + i, kv_len)
        got = flash.flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
        want = flash_plain(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        ratio = tol_ratio(got, want, tol)
        instance = flash.instance_of(sq)
        worst[instance] = max(worst[instance], err)
        if d == 192 and instance == flash.INSTANCES[0]:
            worst[MLA_FLASH_ENTRY] = max(worst[MLA_FLASH_ENTRY], err)
        if (h, kh, d) == (64, 8, 128):
            entry = JAMBA_PREFILL_ENTRY if instance == flash.INSTANCES[0] else JAMBA_DECODE_ENTRY
            worst[entry] = max(worst[entry], err)
        entry = by_shape.get((b, h, kh, sq, skv, d, causal))
        if entry is not None:
            worst[entry] = max(worst[entry], err)
        text = ""
        for what, wrong in (flash_wrong(q, k, v, causal, kv_len or skv) if served else []):
            late = slice(sq // 2, sq) if causal else None
            wrong_ratio, wrong_late = tol_ratio(wrong, want, tol), tol_ratio(wrong, want, tol, late)
            old = FLASH_OLD_BF16_TOL if dtype == torch.bfloat16 else tol
            text += (f" wrong_version={what!r} wrong_max_abs_err={float((wrong.float() - want.float()).abs().max())} "
                     f"wrong_tol_ratio={wrong_ratio} wrong_tol_ratio_late_rows={wrong_late} "
                     f"wrong_old_tol_ratio={tol_ratio(wrong, want, old)} "
                     f"wrong_old_tol_ratio_late_rows={tol_ratio(wrong, want, old, late)}")
            require(wrong_ratio > 1, f"the flash tolerance does not reject a wrong version ({what}) at "
                    f"{(b, h, kh, sq, skv, d, causal, dtype, kv_len)}: ratio {wrong_ratio}")
        if served:
            text += f" mean_abs_out={float(want.float().abs().mean())}"
        print(f"[flash check] instance={instance} B={b} H={h} KH={kh} Sq={sq} Skv={skv} D={d} causal={causal} "
              f"dtype={str(dtype).split('.')[-1]} kv_len={kv_len} max_abs_err={err} tol_ratio={ratio} "
              f"atol={tol[0]} rtol={tol[1]} finite={bool(torch.isfinite(got).all())}{text} "
              f"elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
        require(bool(torch.isfinite(got).all()) and ratio <= 1,
                f"flash kernel != plain version at {(b, h, kh, sq, skv, d, causal, dtype, kv_len)}: {err}")
    print(f"[flash check] cases={len(cases)} worst={json.dumps(worst)} tf32=off "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    return worst


def serve_requests(vocab: int, seed: int) -> tuple[list, object]:
    """The 40 requests of 2,048-token prompts (prompts from ``seed``, the
    reference launcher's Zipf trace) and the one 16,384-token request."""
    rng = np.random.default_rng(seed)
    prompts = {i: rng.integers(0, vocab, SERVE_PROMPT).astype(np.int32) for i in range(SERVE_OBJECTS)}
    trace = zipf.sample_trace(SERVE_OBJECTS, SERVE_REQUESTS, seed=SERVE_TRACE_SEED)
    reqs = [serving.Request(int(x), prompts[int(x)], SERVE_NEW) for x in trace]
    long_req = serving.Request(SERVE_OBJECTS, rng.integers(0, vocab, LONG_PROMPT).astype(np.int32), LONG_NEW)
    return reqs, long_req


def serve_path(model, seed: int, card) -> dict:
    """The serving main path at full width: a cold engine and one behind the
    content cache on the 40 requests, then the 16,384-token request, with the
    flash kernel's counts set to 0 just before and read just after. Returns
    the launches by instance."""
    cfg = model.cfg
    reqs, long_req = serve_requests(cfg.vocab_size, seed)
    require(LONG_PROMPT > cfg.attn_chunk_threshold and LONG_PROMPT % cfg.attn_chunk_q == 0,
            "the long request does not cross the chunk threshold")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for instance in flash.LAUNCHES:
        flash.LAUNCHES[instance] = 0
    cold = serving.ServeEngine(model, SERVE_CACHE_LEN)
    cold_out = cold.run(reqs)
    t_cold = time.perf_counter()
    cache = serving.ContentCache(SERVE_CACHE_OBJECTS, policy=SERVE_POLICY, n_objects=SERVE_OBJECTS)
    warm = serving.ServeEngine(model, SERVE_CACHE_LEN, content_cache=cache)
    warm_out = warm.run(reqs)
    t_warm = time.perf_counter()
    long = serving.ServeEngine(model, LONG_PROMPT + LONG_NEW)
    long_out = long.run([long_req])
    torch.cuda.synchronize()
    by_instance = dict(flash.LAUNCHES)
    launches = sum(by_instance.values())
    t_long = time.perf_counter()

    prefills = SERVE_REQUESTS + cache.stats.misses + 1
    decode_steps = 2 * SERVE_REQUESTS * SERVE_NEW + LONG_NEW
    require(launches == cfg.n_layers * (prefills + decode_steps),
            f"the serving path launched the flash kernel {launches} times, expected "
            f"{cfg.n_layers} x ({prefills} prefills + {decode_steps} decode steps)")
    require(by_instance == {flash.INSTANCES[0]: cfg.n_layers * prefills, flash.INSTANCES[1]: cfg.n_layers * decode_steps},
            f"launches by instance {by_instance}")
    require([r.new_tokens for r in cold_out] == [r.new_tokens for r in warm_out],
            "the content cache changed the generated tokens")
    require(warm.stats.prefill_tokens_computed + warm.stats.prefill_tokens_saved == cold.stats.prefill_tokens_computed,
            "warm computed + saved != cold computed")
    require(warm.stats.prefill_tokens_saved > 0 and cache.stats.hits > 0, "the content cache never hit")
    for req, r in zip(reqs + [long_req], cold_out + long_out):
        require(len(r.new_tokens) == req.max_new and all(0 <= x < cfg.vocab_size for x in r.new_tokens),
                f"bad tokens for object {r.obj_id}: {r.new_tokens}")
    report = warm.report()
    print(f"[serve] arch={cfg.name} n_params={model.n_params} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} compute={cfg.compute_dtype} requests={SERVE_REQUESTS} objects={SERVE_OBJECTS} "
          f"prompt={SERVE_PROMPT} max_new={SERVE_NEW} cache_len={SERVE_CACHE_LEN} policy={SERVE_POLICY} "
          f"cache_objects={SERVE_CACHE_OBJECTS} chr={cache.stats.chr} tokens_saved={warm.stats.prefill_tokens_saved} "
          f"cold_computed={cold.stats.prefill_tokens_computed} report={json.dumps(report)} "
          f"cold_wall_s={t_cold - t0:.3f} warm_wall_s={t_warm - t_cold:.3f} card={card.label!r}", flush=True)
    print(f"[serve long] prompt={LONG_PROMPT} (> attn_chunk_threshold={cfg.attn_chunk_threshold}) max_new={LONG_NEW} "
          f"tokens={long_out[0].new_tokens} wall_s={t_long - t_warm:.3f}", flush=True)
    print(f"[serve] path launches={launches} by_instance={json.dumps(by_instance)} = {cfg.n_layers} layers x "
          f"({prefills} prefills + {decode_steps} decode steps) cold_eq_warm=True "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    return by_instance, dict(chr=cache.stats.chr, mgmt_cpu_s=report["mgmt_time_s"])


#: the fleet front: 2 edges -> 1 parent under lcd, 12 requests over 6 objects, the serve phase's prompts
FRONT_OBJECTS, FRONT_REQUESTS, FRONT_TRACE_SEED = 6, 12, 4
FRONT_TREE = dict(widths=(2, 1), kinds="lru", capacities=(2, 4), placements="lcd")


def fleet_front(model, seed: int, card) -> None:
    """smollm-360m behind ``FleetContentCache.from_topology``: the fleet's tier stats equal a model-free
    replay of the same lookups and offers through a second front on the host, and every hit generates
    its object's first, missed serve's tokens; the flash counts set to 0 just before and read after."""
    t0 = time.perf_counter()
    cfg = model.cfg
    rng = np.random.default_rng(seed + 2)
    prompts = {i: rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32) for i in range(FRONT_OBJECTS)}
    trace = zipf.sample_trace(FRONT_OBJECTS, FRONT_REQUESTS, seed=FRONT_TRACE_SEED)
    reqs = [serving.Request(int(x), prompts[int(x)], SERVE_NEW) for x in trace]
    topo = fleet.tree(n_objects=FRONT_OBJECTS, **FRONT_TREE)
    front = serving.FleetContentCache.from_topology(topo)
    engine = serving.ServeEngine(model, SERVE_CACHE_LEN, content_cache=front)
    torch.cuda.synchronize()
    for instance in flash.LAUNCHES:
        flash.LAUNCHES[instance] = 0
    out = engine.run(reqs)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    wall_s = time.perf_counter() - t0
    replay = serving.FleetContentCache.from_topology(topo)
    for x in trace.tolist():
        if replay.lookup(int(x)) is None:
            replay.offer(int(x), int(x))
    counts = lambda tiers: {name: (s.hits, s.misses, s.inserts, s.evictions) for name, s in tiers.items()}
    require(counts(front.tier_stats()) == counts(replay.tier_stats()),
            f"fleet front {counts(front.tier_stats())} != its replay {counts(replay.tier_stats())}")
    first = {}
    for r in out:
        if not r.prefill_skipped:
            first.setdefault(r.obj_id, r.new_tokens)
    hits = [r for r in out if r.prefill_skipped]
    require(bool(hits) and front.parent_fills > 0, f"the fleet front never served a hit from the parent: {out}")
    require(all(r.new_tokens == first[r.obj_id] for r in hits), "a hit's tokens differ from its first serve's")
    prefills = FRONT_REQUESTS - len(hits)
    require(launches == {flash.INSTANCES[0]: cfg.n_layers * prefills,
                         flash.INSTANCES[1]: cfg.n_layers * FRONT_REQUESTS * SERVE_NEW},
            f"fleet front launches {launches}")
    stats = front.stats
    print(f"[fleet front] arch={cfg.name} topology=2 edges -> 1 parent {json.dumps(FRONT_TREE)} "
          f"requests={FRONT_REQUESTS} objects={FRONT_OBJECTS} prompt={SERVE_PROMPT} max_new={SERVE_NEW} "
          f"fleet_chr={stats.chr} hits={len(hits)} parent_fills={front.parent_fills} "
          f"tier_stats={json.dumps(counts(front.tier_stats()))} tokens_saved={engine.stats.prefill_tokens_saved} "
          f"launches={json.dumps(launches)} mgmt_time_s={stats.mgmt_time_s} tier_stats_equal_replay=True "
          f"hit_tokens_equal_first_serve=True wall_s={wall_s:.3f} card={card.label!r}", flush=True)


def serving_energy_line(model, served: dict, card) -> None:
    """The serve phase's traffic (its CHR and the content cache's management CPU seconds) priced by
    ``energy.serving_energy`` at the card's power limit and the H100 SXM's data-sheet bf16 peak."""
    rep = energy.serving_energy(served["chr"], SERVE_REQUESTS, model.n_params, SERVE_PROMPT, SERVE_NEW,
                                served["mgmt_cpu_s"], power_w=card.power_limit_w,
                                peak_flops=energy.H100_SXM_PEAK_BF16_FLOPS)
    require(all(math.isfinite(v) and v >= 0 for v in rep.row().values()), f"serving energy {rep.row()}")
    print(f"[energy serving] chr={served['chr']} requests={SERVE_REQUESTS} n_params={model.n_params} "
          f"prompt={SERVE_PROMPT} new_tokens={SERVE_NEW} mgmt_cpu_s={served['mgmt_cpu_s']} efficiency=0.4 "
          f"peak_flops={energy.H100_SXM_PEAK_BF16_FLOPS} power_w={card.power_limit_w} "
          f"e_prefill_j_per_miss={rep.e_prefill_j} e_decode_j_per_request={rep.e_decode_j} "
          f"row={json.dumps(rep.row())} card={card.label!r}", flush=True)


def greedy_logits(model, tokens: np.ndarray, cache_len: int, forced=None) -> tuple[list, list]:
    """One request through prefill and CHECK_NEW decode steps: the logits of
    each step and the greedy tokens (``forced``: feed these tokens instead)."""
    logits, cache = model.prefill({"tokens": tokens[None, :]}, cache_len)
    steps = [logits[0, -1].float().cpu()]
    fed = []
    for t in range(CHECK_NEW):
        nxt = int(steps[-1].argmax()) if forced is None else forced[t]
        fed.append(nxt)
        logits, cache = model.decode_step(cache, torch.tensor([[nxt]], device=model.device), len(tokens) + t)
        steps.append(logits[0].float().cpu())
    return steps, fed


def serve_check(model, seed: int) -> dict:
    """One request at full width on the card (the kernel) and on the CPU (the
    plain path, the same weights, fed the card's tokens): prefill's and each
    decode step's logits within SERVE_LOGIT_TOL, and the greedy tokens equal
    wherever the top-2 margin exceeds it."""
    t0 = time.perf_counter()
    tokens = np.random.default_rng(seed + 1).integers(0, model.cfg.vocab_size, CHECK_PROMPT).astype(np.int32)
    card_steps, fed = greedy_logits(model, tokens, CHECK_PROMPT + CHECK_NEW)
    cpu_model = build(model.cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_steps, _ = greedy_logits(cpu_model, tokens, CHECK_PROMPT + CHECK_NEW, forced=fed)
    errs, compared = [], 0
    for a, b in zip(card_steps, cpu_steps):
        errs.append(float((a - b).abs().max()))
        top2 = b.topk(2).values
        if float(top2[0] - top2[1]) > SERVE_LOGIT_TOL:
            compared += 1
            require(int(a.argmax()) == int(b.argmax()), "card and CPU pick different tokens at a clear margin")
    print(f"[serve check] prompt={CHECK_PROMPT} max_new={CHECK_NEW} card_tokens={fed} max_abs_err_by_step={errs} "
          f"tolerance={SERVE_LOGIT_TOL} max_abs_logit={float(max(s.abs().max() for s in cpu_steps))} "
          f"tokens_compared={compared} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    require(max(errs) <= SERVE_LOGIT_TOL and all(math.isfinite(e) for e in errs),
            f"card logits differ from the CPU's by {max(errs)} > {SERVE_LOGIT_TOL}")
    return dict(errs=errs)


# ------------------------------------------------------------ MoE/MLA serving
MOE_ARCH = "deepseek-v2-236b"
#: depth cut to 4 of 60 layers (the dense first layer and 3 MoE layers) at the published widths
MOE_LAYERS = 4
#: the reference's ``build(cfg).n_params`` at that depth (26.6 GB in bf16)
MOE_PARAMS = 13_302_903_808
#: 8 requests over 4 objects (the reference launcher's trace, zipf.sample_trace(4, 8, seed=1)),
#: a content cache of 2 objects under plfua
MOE_OBJECTS, MOE_REQUESTS, MOE_CACHE_OBJECTS = 4, 8, 2
#: the card-vs-CPU check: the served model's first 2 layers (the dense layer and one MoE layer,
#: 10.7 GB in bf16), a 256-token prompt and CHECK_NEW decode steps
MOE_CHECK_LAYERS, MOE_CHECK_PROMPT = 2, 256
#: its logit tolerance: 8 bf16 ulps at the logits' magnitude (|logit| < 8, ulp 2**-5 in [4, 8)).
#: As for smollm, the card's kernel keeps p in f32 where the CPU rounds it to bf16 before P V,
#: and the two round bf16 matmuls differently; here D = 192, 128 heads and the MoE products add
#: their own roundings, and the logits are about twice smollm's.
MOE_LOGIT_TOL = 0.25
#: the flash kernel's shape on MLA's prefill: (B, H, KH, Sq, Skv, D, causal, kv_len)
MLA_FLASH_SHAPE = (1, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, True, None)
MLA_FLASH_ENTRY = "flash_attention/prefill (MLA, D=192)"


def tensors(tree):
    """The tensors of a nested dict (or list) of tensors."""
    for value in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(value, torch.Tensor):
            yield value
        else:
            yield from tensors(value)


def decode_weight_bytes(model) -> int:
    """The bytes of weights one decode token reads: every parameter's compute
    copy (``Model.params()``: bf16, also where the masters are f32) but the
    embedding table, of which it reads one row. The MoE layers' capacity
    buffers multiply every expert, so all of them count."""
    p = model.params()
    embed = p["embed"]
    return sum(t.numel() * t.element_size() for t in tensors(p)) - (embed.numel() - embed.shape[1]) * embed.element_size()


def moe_serve(seed: int, card) -> tuple[object, dict]:
    """deepseek-v2-236b at its published widths, cut to MOE_LAYERS layers, served
    behind the content cache with the flash counts set to 0 just before and read
    just after: every MLA prefill on the kernel (D = 192), MLA's decode on the
    latent cache in plain PyTorch (no launch). Then its prefill ms, decode ms a
    token, and the device's idle share over one decode token."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(seed))
    require(model.n_params == MOE_PARAMS and sum(p.numel() for p in model.parameters()) == MOE_PARAMS,
            f"deepseek cut to {MOE_LAYERS} layers holds {model.n_params} parameters, not {MOE_PARAMS}")
    require([d.ffn for d in model.descs] == ["dense"] + ["moe"] * (MOE_LAYERS - 1)
            and all(d.mixer == "mla" for d in model.descs), f"layer kinds {model.descs}")
    torch.cuda.synchronize()
    t_built = time.perf_counter()
    rng = np.random.default_rng(seed + 3)
    prompts = {i: rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32) for i in range(MOE_OBJECTS)}
    trace = zipf.sample_trace(MOE_OBJECTS, MOE_REQUESTS, seed=SERVE_TRACE_SEED)
    reqs = [serving.Request(int(x), prompts[int(x)], SERVE_NEW) for x in trace]
    cache = serving.ContentCache(MOE_CACHE_OBJECTS, policy=SERVE_POLICY, n_objects=MOE_OBJECTS)
    engine = serving.ServeEngine(model, SERVE_CACHE_LEN, content_cache=cache)
    for instance in flash.LAUNCHES:
        flash.LAUNCHES[instance] = 0
    out = engine.run(reqs)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    t_served = time.perf_counter()
    misses = cache.stats.misses
    require(launches == {flash.INSTANCES[0]: cfg.n_layers * misses, flash.INSTANCES[1]: 0},
            f"MoE/MLA launches {launches}, expected {cfg.n_layers} layers x {misses} prefills and no decode launch")
    require(cache.stats.hits > 0 and engine.stats.prefill_tokens_saved == cache.stats.hits * SERVE_PROMPT,
            f"the content cache never hit, or saved the wrong count: {engine.report()}")
    first = {}
    for r in out:
        require(len(r.new_tokens) == SERVE_NEW and all(0 <= x < cfg.vocab_size for x in r.new_tokens),
                f"bad tokens for object {r.obj_id}: {r.new_tokens}")
        if not r.prefill_skipped:
            first.setdefault(r.obj_id, r.new_tokens)
    require(all(r.new_tokens == first[r.obj_id] for r in out if r.prefill_skipped),
            "a hit's tokens differ from its object's first serve")

    tokens = torch.as_tensor(reqs[0].tokens, device="cuda")[None, :]
    prefill_ms = events_ms(lambda: model.prefill({"tokens": tokens}, SERVE_CACHE_LEN), 2)
    logits, kv = model.prefill({"tokens": tokens}, SERVE_CACHE_LEN)
    first_logits = logits[:, -1, :].clone()
    del logits

    def decode_request():
        nxt_logits = first_logits
        for t in range(SERVE_NEW):
            nxt = torch.argmax(nxt_logits, dim=-1)
            int(nxt[0])  # the engine's host read of each token
            nxt_logits, _ = model.decode_step(kv, nxt[:, None], SERVE_PROMPT + t)

    decode_ms = events_ms(decode_request, 2) / SERVE_NEW
    nxt = torch.argmax(first_logits, dim=-1)[:, None]
    trace = timing.profile(model.decode_step, kv, nxt, SERVE_PROMPT, profile_dir=None)
    weight_bytes = decode_weight_bytes(model)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    expert_bytes = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2
    print(f"[moe serve] arch={cfg.name} layers={cfg.n_layers} of 60 (dense first layer + {cfg.n_layers - 1} MoE) "
          f"n_params={model.n_params} d_model={cfg.d_model} heads={cfg.n_heads} q_lora={cfg.q_lora_rank} "
          f"kv_lora={cfg.kv_lora_rank} nope/rope/v={cfg.nope_head_dim}/{cfg.rope_head_dim}/{cfg.v_head_dim} "
          f"experts={cfg.n_experts} top_k={cfg.experts_per_token} shared={cfg.n_shared_experts} "
          f"expert_d_ff={cfg.moe_d_ff} dense_d_ff={cfg.d_ff} vocab={cfg.vocab_size} compute={cfg.compute_dtype} "
          f"requests={MOE_REQUESTS} objects={MOE_OBJECTS} prompt={SERVE_PROMPT} max_new={SERVE_NEW} "
          f"policy={SERVE_POLICY} cache_objects={MOE_CACHE_OBJECTS} chr={cache.stats.chr} "
          f"tokens_saved={engine.stats.prefill_tokens_saved} prefills={misses} launches={json.dumps(launches)} "
          f"(= {cfg.n_layers} layers x {misses} prefills) hit_tokens_equal_first_serve=True "
          f"build_s={t_built - t0:.3f} serve_wall_s={t_served - t_built:.3f} card={card.label!r}", flush=True)
    print(f"[moe measure] prefill_ms={prefill_ms} prefill_tokens_per_s={SERVE_PROMPT / prefill_ms * 1e3} "
          f"decode_ms_per_token={decode_ms} decode_weight_bytes={weight_bytes} "
          f"(a MoE layer's experts {expert_bytes}, all read through the capacity buffers) "
          f"decode_bytes_bound_ms={bound_ms} decode_trace_kernels={trace.kernels} decode_busy_s={trace.busy_s} "
          f"decode_span_s={trace.span_s} decode_idle_share={trace.idle_share} power_limit_w={card.power_limit_w} "
          f"card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    require(trace.kernels > 0 and math.isfinite(prefill_ms) and math.isfinite(decode_ms), "MoE/MLA measure")
    return model, launches


def moe_routes(model, tokens: np.ndarray, fed: list, cache_len: int) -> torch.Tensor:
    """Each MoE layer's top-k experts (sorted) for every prompt token and each
    fed token, read through the route step (``moe.route``) on the input the
    layer's FFN gets, by running the model's layer functions by hand: a
    prefill over the prompt, then one decode step a fed token. Stops after
    the last MoE layer's route. Returns (positions, MoE layers, k) on the CPU."""
    cfg, p = model.cfg, model.params()
    last = max(i for i, d in enumerate(model.descs) if d.ffn == "moe")
    caches = {}

    def run(x, pos):
        picked = []
        for i, desc in enumerate(model.descs[:last + 1]):
            lp = p["layers"][i]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if pos is None:
                mix, caches[i] = attention.mla_prefill(lp["mixer"], h, cfg, cache_len)
            else:
                mix, _ = attention.mla_decode(lp["mixer"], h, caches[i], pos, cfg)
            if desc.ffn == "moe":
                ids = moe.route(lp["ffn"]["router"], transformer.ffn_input(cfg, lp, x, mix)[1], cfg.experts_per_token)[1]
                picked.append(ids.sort(dim=-1).values[0].cpu())
            if i < last:
                x = transformer.sublayer_ffn(cfg, desc, lp, x, mix)[0]
        return torch.stack(picked, dim=1)

    with torch.no_grad():
        out = [run(p["embed"][torch.as_tensor(tokens, device=model.device).long()[None, :]], None)]
        for t, tok in enumerate(fed):
            out.append(run(p["embed"][torch.tensor([[tok]], device=model.device)], len(tokens) + t))
    return torch.cat(out)


def kept_experts(routes: torch.Tensor, n_prompt: int, n_experts: int, cap: int) -> torch.Tensor:
    """(positions, MoE layers, E) bool: the experts that keep each token's
    copy, from ``moe_routes``' choices: the prompt is one dispatch, where a
    copy is kept if fewer than ``cap`` earlier tokens chose its expert; each
    decode token is one of its own (C = 8 >= k: all kept)."""
    onehot = torch.zeros(*routes.shape[:2], n_experts, dtype=torch.bool).scatter_(-1, routes, True)
    prompt = onehot[:n_prompt]
    earlier = prompt.long().cumsum(dim=0) - prompt.long()
    return torch.cat([prompt & (earlier < cap), onehot[n_prompt:]])


def decode_logits(model, cache, start: int, first: torch.Tensor, forced=None) -> tuple[list, list]:
    """CHECK_NEW decode steps on ``cache`` from position ``start``, greedy from
    the logits ``first`` (or fed ``forced``): each step's logits (CPU, f32)
    and the tokens fed."""
    steps, fed = [], []
    nxt_logits = first
    for t in range(CHECK_NEW):
        nxt = int(nxt_logits.argmax()) if forced is None else forced[t]
        fed.append(nxt)
        nxt_logits, cache = model.decode_step(cache, torch.tensor([[nxt]], device=model.device), start + t)
        nxt_logits = nxt_logits[0].float().cpu()
        steps.append(nxt_logits)
    return steps, fed


def logit_steps(model, tokens: np.ndarray, cache_len: int, forced=None) -> tuple[torch.Tensor, list, list]:
    """Prefill's logits at every prompt position, then CHECK_NEW decode steps'
    logits (greedy, or fed ``forced``), through the entry points."""
    logits, cache = model.prefill({"tokens": tokens[None, :]}, cache_len)
    prefill = logits[0].float().cpu()
    del logits
    steps, fed = decode_logits(model, cache, len(tokens), prefill[-1], forced)
    return prefill, steps, fed


def moe_check(model, seed: int) -> None:
    """The served model's first MOE_CHECK_LAYERS layers on the card (its own
    weights, no copy) and on the CPU (a copy, the plain path), the CPU fed
    the card's greedy tokens: the logits at every prompt position and each
    decode step within MOE_LOGIT_TOL wherever the two sides' routing agrees
    (the one MoE layer is the last, so a token routed differently moves only
    its own logits, and its kept copies agree too: a token routed
    differently shifts the capacity drops of its experts' later copies), the
    count of tokens whose top-k sets or kept copies differ, and a
    wrong version (the experts' w_gate and w_up swapped, on the card) that
    the tolerance must reject."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, n_layers=MOE_CHECK_LAYERS)
    kept = {k: v for k, v in model.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < MOE_CHECK_LAYERS}
    card = build(cfg, device="meta")
    card.load_state_dict(kept, assign=True)
    require([d.ffn for d in card.descs] == ["dense", "moe"], f"the check's layers {card.descs}")
    tokens = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, MOE_CHECK_PROMPT).astype(np.int32)
    cache_len = MOE_CHECK_PROMPT + CHECK_NEW
    card_prefill, card_steps, fed = logit_steps(card, tokens, cache_len)
    card_routes = moe_routes(card, tokens, fed, cache_len)
    wrong = build(cfg, device="meta")
    experts = {f"layers.{i}.ffn.w_gate": f"layers.{i}.ffn.w_up" for i, d in enumerate(card.descs) if d.ffn == "moe"}
    experts.update({v: k for k, v in experts.items()})
    swapped = {experts.get(k, k): v for k, v in kept.items()}
    wrong.load_state_dict(swapped, assign=True)
    wrong_prefill, wrong_steps, _ = logit_steps(wrong, tokens, cache_len, forced=fed)
    del wrong, swapped
    torch.cuda.synchronize()
    t_card = time.perf_counter()

    cpu = build(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in kept.items()}, assign=True)
    require(cpu.device.type == "cpu", "the check's CPU model")
    t_copy = time.perf_counter()
    cpu_prefill, cpu_steps, _ = logit_steps(cpu, tokens, cache_len, forced=fed)
    t_cpu = time.perf_counter()
    cpu_routes = moe_routes(cpu, tokens, fed, cache_len)
    t_routes = time.perf_counter()
    del cpu, card

    agree = (card_routes == cpu_routes).all(dim=-1).all(dim=-1)  # (positions,)
    n_pos = MOE_CHECK_PROMPT
    cap = moe._capacity(n_pos, cfg)
    same_drops = (kept_experts(card_routes, n_pos, cfg.n_experts, cap)
                  == kept_experts(cpu_routes, n_pos, cfg.n_experts, cap)).all(dim=-1).all(dim=-1)
    n_drops_differ = int((agree & ~same_drops).sum())
    agree &= same_drops
    held = agree[:n_pos]
    errs = [float((card_prefill - cpu_prefill).abs().amax(dim=-1)[held].max())]
    wrong_errs = [float((wrong_prefill - cpu_prefill).abs().amax(dim=-1)[held].max())]
    for t, (a, b, w) in enumerate(zip(card_steps, cpu_steps, wrong_steps)):
        if agree[n_pos + t]:
            errs.append(float((a - b).abs().max()))
            wrong_errs.append(float((w - b).abs().max()))
    compared = 0
    for a, b in zip(card_steps, cpu_steps):
        top2 = b.topk(2).values
        if float(top2[0] - top2[1]) > MOE_LOGIT_TOL:
            compared += 1
            require(int(a.argmax()) == int(b.argmax()), "card and CPU pick different tokens at a clear margin")
    n_differ = int((~agree).sum()) - n_drops_differ
    print(f"[moe check] arch={cfg.name} layers={MOE_CHECK_LAYERS} (dense + 1 MoE, the served model's first) "
          f"prompt={MOE_CHECK_PROMPT} max_new={CHECK_NEW} card_tokens={fed} "
          f"routing_differs_tokens={n_differ} of {len(agree)} (top-{cfg.experts_per_token} sets, read through "
          f"the route step on each side) drops_differ_tokens={n_drops_differ} (routed alike, a copy kept on one "
          f"side only: C = {cap}) held_positions={int(held.sum())} of {n_pos} held_decode_steps={len(errs) - 1} "
          f"max_abs_err_prefill={errs[0]} max_abs_err_by_step={errs[1:]} tolerance={MOE_LOGIT_TOL} "
          f"max_abs_logit={float(cpu_prefill.abs().max())} tokens_compared={compared} "
          f"wrong_version='experts w_gate and w_up swapped' wrong_max_abs_err={max(wrong_errs)} "
          f"card_s={t_card - t0:.3f} cpu_copy_s={t_copy - t_card:.3f} cpu_s={t_cpu - t_copy:.3f} "
          f"routes_cpu_s={t_routes - t_cpu:.3f} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    require(held.sum() > n_pos // 2, f"the routing differs at {n_differ} tokens: too few held")
    require(max(errs) <= MOE_LOGIT_TOL and all(math.isfinite(e) for e in errs),
            f"card logits differ from the CPU's by {max(errs)} > {MOE_LOGIT_TOL}")
    require(max(wrong_errs) > MOE_LOGIT_TOL, f"the tolerance does not reject swapped experts: {max(wrong_errs)}")


# ------------------------------------------------------------ SSM and hybrid serving
SSM_ARCHS = ("rwkv6-7b", "jamba-1.5-large-398b")
#: the depth cuts at the published widths (of 32 and 72 layers): rwkv6-7b's first 4 layers; jamba's
#: first 5, Mamba layers 0-3 (1 and 3 with MoE FFNs) and the attention layer 4, the fewest layers that
#: hold every sublayer kind
SSM_LAYERS = {"rwkv6-7b": 4, "jamba-1.5-large-398b": 5}
SSM_KINDS = {"rwkv6-7b": [("rwkv6", "cmix")] * 4,
             "jamba-1.5-large-398b": [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
                                      ("gqa", "dense")]}
#: the reference's ``build(cfg).n_params`` at those depths (rwkv6: f32 masters, 5.6 GB; jamba: bf16, 48.1 GB)
SSM_PARAMS = {"rwkv6-7b": 1_411_584_000, "jamba-1.5-large-398b": 24_045_707_264}
#: the card-vs-CPU check: rwkv6's first 2 layers as a model; jamba one layer at a time, each layer on
#: the CPU fed the card's input to it (one layer's weights on the host at a time: 19.3 GB at most).
#: jamba's layers 0 (Mamba + dense), 1 (Mamba + MoE) and 4 (attention + dense) hold every sublayer
#: kind; 2 and 3 repeat 0 and 1, and would add ~20 s: the host's bf16 products run at 0.12-0.16
#: TFLOP/s (experiments/ssm_probe.py), and a MoE layer's 4 decode steps multiply all 16 experts' buffers
RWKV_CHECK_LAYERS, JAMBA_CHECK_LAYERS, SSM_CHECK_PROMPT = 2, (0, 1, 4), 256
#: its logit tolerance, as the MoE check's: 8 bf16 ulps at |logit| < 8
SSM_LOGIT_TOL = 0.25
#: the check's SSM parameters, drawn anew at a trained model's scale (the same tensors on both sides):
#: at init's scale (bonus_u, a_log, dt_bias and conv_w 1e-3, decay_base 0) a Mamba state adds 1e-4 of
#: its mixer's output and RWKV's bonus under one bf16 rounding of it, so a wrong state or bonus would
#: not show; conv taps of 0.1 keep a Mamba mixer's output near 1 and its state's part near a half
SSM_CHECK_DRAWS = {"bonus_u": ("normal", 1.0), "decay_base": ("normal", 1.0),
                   "a_log": ("uniform", 0.0, math.log(16)), "dt_bias": ("uniform", -4.0, -1.0),
                   "conv_w": ("normal", 0.1)}
JAMBA_PREFILL_ENTRY = "flash_attention/prefill (jamba, D=128)"
JAMBA_DECODE_ENTRY = "flash_attention/decode (jamba, D=128)"
#: the flash kernel at jamba's attention layer (64 heads of 128 over 8 kv heads): prefill and decode
JAMBA_FLASH_SHAPES = (
    (JAMBA_PREFILL_ENTRY, flash.INSTANCES[0], (1, 64, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True, None)),
    (JAMBA_DECODE_ENTRY, flash.INSTANCES[1], (1, 64, 8, 1, SERVE_CACHE_LEN, 128, False, SERVE_CACHE_LEN)),
)


def ssm_serve(arch: str, seed: int, card) -> tuple[object, dict]:
    """``arch`` at its published widths, cut to ``SSM_LAYERS[arch]`` layers,
    weights from ``seed``, served behind the content cache as deepseek is in
    phase 16, with the flash counts set to 0 just before and read just after:
    jamba's attention layer runs the kernel at every prefill and decode step,
    rwkv6 launches it never. Then prefill ms and tokens/s, decode ms a token
    beside the bytes of weights a token reads, the bytes of decode state a
    request holds (the content cache's payload), the device's idle share over
    one decode token and over one prefill (``torch.profiler``), and one SSM
    mixer alone at the prompt's length: its ms and its launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=SSM_LAYERS[arch])
    model = build(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(seed))
    require(model.n_params == SSM_PARAMS[arch] and sum(p.numel() for p in model.parameters()) == SSM_PARAMS[arch],
            f"{arch} cut to {cfg.n_layers} layers holds {model.n_params} parameters, not {SSM_PARAMS[arch]}")
    kinds = [(d.mixer, d.ffn) for d in model.descs]
    require(kinds == SSM_KINDS[arch], f"layer kinds {kinds}")
    n_attn = sum(d.mixer == "gqa" for d in model.descs)
    n_ssm = sum(d.mixer in ("rwkv6", "mamba") for d in model.descs)
    torch.cuda.synchronize()
    t_built = time.perf_counter()
    rng = np.random.default_rng(seed + 6)
    prompts = {i: rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32) for i in range(MOE_OBJECTS)}
    trace = zipf.sample_trace(MOE_OBJECTS, MOE_REQUESTS, seed=SERVE_TRACE_SEED)
    reqs = [serving.Request(int(x), prompts[int(x)], SERVE_NEW) for x in trace]
    cache = serving.ContentCache(MOE_CACHE_OBJECTS, policy=SERVE_POLICY, n_objects=MOE_OBJECTS)
    engine = serving.ServeEngine(model, SERVE_CACHE_LEN, content_cache=cache)
    for instance in flash.LAUNCHES:
        flash.LAUNCHES[instance] = 0
    out = engine.run(reqs)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    t_served = time.perf_counter()
    misses, steps = cache.stats.misses, MOE_REQUESTS * SERVE_NEW
    require(launches == {flash.INSTANCES[0]: n_attn * misses, flash.INSTANCES[1]: n_attn * steps},
            f"{arch} launches {launches}, expected {n_attn} attention layers x ({misses} prefills, {steps} decode steps)")
    require(cache.stats.hits > 0 and engine.stats.prefill_tokens_saved == cache.stats.hits * SERVE_PROMPT,
            f"the content cache never hit, or saved the wrong count: {engine.report()}")
    first = {}
    for r in out:
        require(len(r.new_tokens) == SERVE_NEW and all(0 <= x < cfg.vocab_size for x in r.new_tokens),
                f"bad tokens for object {r.obj_id}: {r.new_tokens}")
        if not r.prefill_skipped:
            first.setdefault(r.obj_id, r.new_tokens)
    require(all(r.new_tokens == first[r.obj_id] for r in out if r.prefill_skipped),
            "a hit's tokens differ from its object's first serve")
    state = {name: math.prod(shape) * dt.itemsize for name, (shape, _, dt) in model.cache_spec(1, SERVE_CACHE_LEN).items()}

    tokens = torch.as_tensor(reqs[0].tokens, device="cuda")[None, :]
    prefill_ms = events_ms(lambda: model.prefill({"tokens": tokens}, SERVE_CACHE_LEN), 2)
    prefill_trace = timing.profile(model.prefill, {"tokens": tokens}, SERVE_CACHE_LEN, profile_dir=None)
    logits, kv = model.prefill({"tokens": tokens}, SERVE_CACHE_LEN)
    first_logits = logits[:, -1, :].clone()
    del logits

    def decode_request():
        nxt_logits = first_logits
        for t in range(SERVE_NEW):
            nxt = torch.argmax(nxt_logits, dim=-1)
            int(nxt[0])  # the engine's host read of each token
            nxt_logits, _ = model.decode_step(kv, nxt[:, None], SERVE_PROMPT + t)

    decode_ms = events_ms(decode_request, 2) / SERVE_NEW
    nxt = torch.argmax(first_logits, dim=-1)[:, None]
    trace = timing.profile(model.decode_step, kv, nxt, SERVE_PROMPT, profile_dir=None)
    del kv
    # one SSM mixer alone at the prompt's length (the first SSM layer's weights, a normed input): its
    # loop steps twice a token
    first_ssm = next(i for i, d in enumerate(model.descs) if d.mixer in ("rwkv6", "mamba"))
    lp = model.params()["layers"][first_ssm]["mixer"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    h = torch.randn(1, SERVE_PROMPT, cfg.d_model, generator=gen, device="cuda").to(model.compute_dtype)
    apply = ssm.rwkv6_apply if cfg.ssm_kind == "rwkv6" else ssm.mamba_apply
    mixer_ms = events_ms(lambda: apply(lp, h, cfg), 2)
    mixer_trace = timing.profile(apply, lp, h, cfg, profile_dir=None)
    del h
    weight_bytes = decode_weight_bytes(model)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    widths = (f"heads={cfg.n_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff}" if cfg.ssm_kind == "rwkv6" else
              f"heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim} "
              f"mamba_d_inner={ssm.mamba_d_inner(cfg)} d_state={cfg.mamba_d_state} d_conv={cfg.mamba_d_conv} "
              f"dt_rank={model.port_specs()[f'layers.{first_ssm}.mixer.w_dt'].shape[0]} experts={cfg.n_experts} "
              f"top_k={cfg.experts_per_token} d_ff={cfg.d_ff}")
    print(f"[ssm serve] arch={cfg.name} layers={cfg.n_layers} of {get_config(arch).n_layers} ({json.dumps(kinds)}) "
          f"n_params={model.n_params} d_model={cfg.d_model} {widths} vocab={cfg.vocab_size} "
          f"params={cfg.param_dtype} compute={cfg.compute_dtype} requests={MOE_REQUESTS} objects={MOE_OBJECTS} "
          f"prompt={SERVE_PROMPT} max_new={SERVE_NEW} policy={SERVE_POLICY} cache_objects={MOE_CACHE_OBJECTS} "
          f"chr={cache.stats.chr} tokens_saved={engine.stats.prefill_tokens_saved} prefills={misses} "
          f"launches={json.dumps(launches)} (= {n_attn} attention layers x ({misses} prefills, {steps} decode "
          f"steps)) hit_tokens_equal_first_serve=True build_s={t_built - t0:.3f} "
          f"serve_wall_s={t_served - t_built:.3f} card={card.label!r}", flush=True)
    print(f"[ssm measure] arch={cfg.name} prefill_ms={prefill_ms} prefill_tokens_per_s={SERVE_PROMPT / prefill_ms * 1e3} "
          f"prefill_trace_kernels={prefill_trace.kernels} prefill_busy_s={prefill_trace.busy_s} "
          f"prefill_span_s={prefill_trace.span_s} prefill_idle_share={prefill_trace.idle_share} "
          f"decode_ms_per_token={decode_ms} decode_weight_bytes={weight_bytes} decode_bytes_bound_ms={bound_ms} "
          f"decode_trace_kernels={trace.kernels} decode_busy_s={trace.busy_s} decode_span_s={trace.span_s} "
          f"decode_idle_share={trace.idle_share} state_bytes_per_request={sum(state.values())} "
          f"state_bytes_by_name={json.dumps(state)} payload_bytes={sum(state.values()) + cfg.vocab_size * 4} "
          f"(+ the f32 next-token logits) ssm_layers={n_ssm} mixer_ms_at_prompt={mixer_ms} "
          f"mixer_us_per_token={mixer_ms * 1e3 / SERVE_PROMPT} mixer_kernels={mixer_trace.kernels} "
          f"mixer_loop_launches={2 * SERVE_PROMPT} (2 a token) mixer_busy_s={mixer_trace.busy_s} "
          f"mixer_idle_share={mixer_trace.idle_share} recurrence_launches_per_prefill={n_ssm * mixer_trace.kernels} "
          f"power_limit_w={card.power_limit_w} card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}",
          flush=True)
    require(trace.kernels > 0 and mixer_trace.kernels >= 2 * SERVE_PROMPT and math.isfinite(prefill_ms)
            and math.isfinite(decode_ms), f"{arch} measure")
    return model, launches


def check_weights(model, seed: int) -> dict:
    """``model``'s state dict with its SSM parameters (``SSM_CHECK_DRAWS``)
    drawn anew on the card from ``seed``; every other tensor the model's own
    (no copy)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        how = SSM_CHECK_DRAWS.get(name.rsplit(".", 1)[-1]) if ".mixer." in name else None
        if how is None:
            out[name] = t
        elif how[0] == "normal":
            out[name] = (torch.randn(t.shape, generator=gen, device="cuda") * how[1]).to(t.dtype)
        else:
            out[name] = (torch.rand(t.shape, generator=gen, device="cuda") * (how[2] - how[1]) + how[1]).to(t.dtype)
    return out


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def tokens_agree(card: list, cpu: list, tol: float) -> int:
    """Require the greedy tokens equal where the CPU's top-2 margin exceeds
    ``tol``; returns how many were compared."""
    compared = 0
    for a, b in zip(card, cpu):
        top2 = b.topk(2).values
        if float(top2[0] - top2[1]) > tol:
            compared += 1
            require(int(a.argmax()) == int(b.argmax()), "card and CPU pick different tokens at a clear margin")
    return compared


def rwkv_check(model, seed: int) -> None:
    """rwkv6's first RWKV_CHECK_LAYERS layers (the served weights, the SSM
    parameters drawn anew at a trained model's scale) on the card and on the
    CPU (a copy, the plain path), the CPU fed the card's greedy tokens: every
    prompt position's and each decode step's logits within SSM_LOGIT_TOL,
    tokens equal at a clear margin; and the card's decode without the bonus u
    (after the card's own prefill), which the tolerance must reject."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, n_layers=RWKV_CHECK_LAYERS)
    kept = {k: v for k, v in check_weights(model, seed + 8).items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < RWKV_CHECK_LAYERS}
    card = build(cfg, device="meta")
    card.load_state_dict(kept, assign=True)
    tokens = np.random.default_rng(seed + 9).integers(0, cfg.vocab_size, SSM_CHECK_PROMPT).astype(np.int32)
    cache_len = SSM_CHECK_PROMPT + CHECK_NEW
    card_prefill, card_steps, fed = logit_steps(card, tokens, cache_len)
    wrong = build(cfg, device="meta")
    wrong.load_state_dict({k: torch.zeros_like(v) if k.endswith("mixer.bonus_u") else v for k, v in kept.items()},
                          assign=True)
    _, kv = card.prefill({"tokens": tokens[None, :]}, cache_len)
    wrong_steps, _ = decode_logits(wrong, kv, SSM_CHECK_PROMPT, card_prefill[-1], forced=fed)
    del wrong, kv
    torch.cuda.synchronize()
    t_card = time.perf_counter()
    cpu = build(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in kept.items()}, assign=True)
    t_copy = time.perf_counter()
    cpu_prefill, cpu_steps, _ = logit_steps(cpu, tokens, cache_len, forced=fed)
    t_cpu = time.perf_counter()
    del cpu, card, kept
    errs = [float((card_prefill - cpu_prefill).abs().max())] + [float((a - b).abs().max())
                                                                 for a, b in zip(card_steps, cpu_steps)]
    wrong_errs = [float((w - b).abs().max()) for w, b in zip(wrong_steps, cpu_steps)]
    compared = tokens_agree([card_prefill[-1]] + card_steps[:-1], [cpu_prefill[-1]] + cpu_steps[:-1], SSM_LOGIT_TOL)
    print(f"[ssm check] arch={cfg.name} layers={RWKV_CHECK_LAYERS} (the served model's first; SSM parameters drawn "
          f"at a trained scale: {json.dumps(SSM_CHECK_DRAWS)}) prompt={SSM_CHECK_PROMPT} max_new={CHECK_NEW} "
          f"card_tokens={fed} max_abs_err_prefill={errs[0]} max_abs_err_by_step={errs[1:]} "
          f"tolerance={SSM_LOGIT_TOL} max_abs_logit={float(cpu_prefill.abs().max())} tokens_compared={compared} "
          f"wrong_version='decode without the bonus u' wrong_max_abs_err_by_step={wrong_errs} "
          f"card_s={t_card - t0:.3f} cpu_copy_s={t_copy - t_card:.3f} cpu_s={t_cpu - t_copy:.3f} "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    require(max(errs) <= SSM_LOGIT_TOL and all(math.isfinite(e) for e in errs),
            f"card logits differ from the CPU's by {max(errs)} > {SSM_LOGIT_TOL}")
    require(max(wrong_errs) > SSM_LOGIT_TOL, f"the tolerance does not reject a decode without u: {wrong_errs}")


def jamba_check(model, seed: int) -> None:
    """jamba one layer at a time (the served weights, the Mamba layers' SSM
    parameters drawn anew at a trained model's scale): the card runs the
    model's layer functions over a SSM_CHECK_PROMPT-token prompt and
    CHECK_NEW greedy decode steps, keeping each layer's input and output (its
    entry points, fed the same tokens, must give the same logits); then each
    layer of JAMBA_CHECK_LAYERS on the CPU (a copy of that layer's weights
    alone, the plain path, its own cache) is fed the card's inputs to it. Each layer's
    outputs are read through the model's final norm and unembedding (on the
    card, for both sides) and must lie within SSM_LOGIT_TOL at every
    position, a MoE layer's only where the two sides' routing and capacity
    drops agree; the last layer's are the logits, and the tokens agree where
    the margin is clear. Each Mamba layer's first decode step with its conv
    carry zeroed (on the card) must be rejected."""
    t0 = time.perf_counter()
    cfg = model.cfg
    card = build(cfg, device="meta")
    card.load_state_dict(check_weights(model, seed + 10), assign=True)
    p = card.params()
    tokens = np.random.default_rng(seed + 11).integers(0, cfg.vocab_size, SSM_CHECK_PROMPT).astype(np.int32)
    cache_len, n_pos = SSM_CHECK_PROMPT + CHECK_NEW, SSM_CHECK_PROMPT + CHECK_NEW

    def lens(h):
        return (rms_norm(h, p["ln_f"], cfg.norm_eps) @ p["unembed"]).float()[0]

    routed, route = [], moe.route

    def recording_route(router, x, k):
        weights, ids = route(router, x, k)
        routed.append(ids.sort(dim=-1).values[0].cpu())
        return weights, ids

    moe.route = recording_route
    try:
        descs = card.descs
        inputs, outputs, caches, fresh = [[] for _ in descs], [[] for _ in descs], [], []
        card_routes = {i: [] for i, d in enumerate(descs) if d.ffn == "moe"}
        x = p["embed"][torch.as_tensor(tokens, device="cuda").long()[None, :]]
        for i, desc in enumerate(descs):
            inputs[i].append(x)
            x, c = transformer.sublayer_prefill(cfg, desc, p["layers"][i], x, cache_len)
            outputs[i].append(x)
            caches.append(c)
            fresh.append({k: v.clone() for k, v in c.items()})
            if desc.ffn == "moe":
                card_routes[i].append(routed.pop())
        nxt_logits, fed = lens(x)[-1], []
        for t in range(CHECK_NEW):
            fed.append(int(nxt_logits.argmax()))
            x = p["embed"][torch.tensor([[fed[-1]]], device="cuda")]
            for i, desc in enumerate(descs):
                inputs[i].append(x)
                x, _ = transformer.sublayer_decode(cfg, desc, p["layers"][i], x, caches[i], SSM_CHECK_PROMPT + t)
                outputs[i].append(x)
                if desc.ffn == "moe":
                    card_routes[i].append(routed.pop())
            nxt_logits = lens(x)[-1]
        wrong = {}
        for i, desc in enumerate(descs):
            if desc.mixer == "mamba" and i in JAMBA_CHECK_LAYERS:
                c = {k: v.clone() for k, v in fresh[i].items()}
                c["conv"].zero_()
                wrong[i] = lens(transformer.sublayer_decode(cfg, desc, p["layers"][i], inputs[i][1], c,
                                                            SSM_CHECK_PROMPT)[0])[0]
                if desc.ffn == "moe":
                    routed.pop()
        del caches, fresh
        # the entry points (the stacked cache's slots) give the by-hand run's logits
        entry_prefill, entry_steps, _ = logit_steps(card, tokens, cache_len, forced=fed)
        entry_err = max([float((entry_prefill - lens(torch.cat(outputs[-1][:1], dim=1)).cpu()).abs().max())]
                        + [float((a - lens(o)[0].cpu()).abs().max()) for a, o in zip(entry_steps, outputs[-1][1:])])
        del entry_prefill, entry_steps, routed[:]
        torch.cuda.synchronize()
        t_card = time.perf_counter()
        rows, copy_s, cpu_s, final = [], 0.0, 0.0, None
        for i in JAMBA_CHECK_LAYERS:
            desc = descs[i]
            t1 = time.perf_counter()
            lp = tree_to(p["layers"][i], "cpu")
            t2 = time.perf_counter()
            out, c = transformer.sublayer_prefill(cfg, desc, lp, inputs[i][0].cpu(), cache_len)
            cpu_out = [out]
            cpu_routes = [routed.pop()] if desc.ffn == "moe" else []
            for t in range(CHECK_NEW):
                out, _ = transformer.sublayer_decode(cfg, desc, lp, inputs[i][t + 1].cpu(), c, SSM_CHECK_PROMPT + t)
                cpu_out.append(out)
                if desc.ffn == "moe":
                    cpu_routes.append(routed.pop())
            del lp, c
            copy_s, cpu_s = copy_s + t2 - t1, cpu_s + time.perf_counter() - t2
            held = torch.ones(n_pos, dtype=torch.bool)
            n_differ = n_drops = 0
            if desc.ffn == "moe":
                a, b = torch.cat(card_routes[i])[:, None, :], torch.cat(cpu_routes)[:, None, :]
                agree = (a == b).all(dim=-1).all(dim=-1)
                cap = moe._capacity(SSM_CHECK_PROMPT, cfg)
                drops = (kept_experts(a, SSM_CHECK_PROMPT, cfg.n_experts, cap)
                         == kept_experts(b, SSM_CHECK_PROMPT, cfg.n_experts, cap)).all(dim=-1).all(dim=-1)
                n_differ, n_drops = int((~agree).sum()), int((agree & ~drops).sum())
                held = agree & drops
            card_lens = lens(torch.cat(outputs[i], dim=1))
            cpu_lens = lens(torch.cat(cpu_out, dim=1).to("cuda"))
            err = (card_lens - cpu_lens).abs().amax(dim=-1).cpu()
            row = dict(layer=i, mixer=desc.mixer, ffn=desc.ffn, held=int(held.sum()),
                       max_abs_err_prompt=float(err[:SSM_CHECK_PROMPT][held[:SSM_CHECK_PROMPT]].max()),
                       max_abs_err_by_step=[float(e) if h else None for e, h in zip(err[SSM_CHECK_PROMPT:],
                                                                                     held[SSM_CHECK_PROMPT:])],
                       max_abs_lens=float(cpu_lens.abs().max()))
            if desc.ffn == "moe":
                row.update(routing_differs_tokens=n_differ, drops_differ_tokens=n_drops)
            if i in wrong:
                row["wrong_max_abs_err"] = float((wrong[i] - cpu_lens[SSM_CHECK_PROMPT]).abs().max())
            rows.append(row)
            require(held.sum() > n_pos // 2, f"layer {i}: the routing differs at {n_differ} tokens: too few held")
            require(bool(torch.isfinite(err[held]).all()) and float(err[held].max()) <= SSM_LOGIT_TOL,
                    f"layer {i} ({desc}): card and CPU differ by {float(err[held].max())} > {SSM_LOGIT_TOL}")
            require(i not in wrong or row["wrong_max_abs_err"] > SSM_LOGIT_TOL,
                    f"layer {i}: the tolerance does not reject a zeroed conv carry: {row.get('wrong_max_abs_err')}")
            final = (card_lens, cpu_lens)
            del card_lens, cpu_lens, cpu_out
    finally:
        moe.route = route
    require(not routed, f"{len(routed)} router calls left unread")
    require(entry_err <= SSM_LOGIT_TOL, f"the entry points' logits differ from the layer by layer run's: {entry_err}")
    last = range(SSM_CHECK_PROMPT - 1, n_pos - 1)  # the logits each fed token was chosen from
    compared = tokens_agree([final[0][r].cpu() for r in last], [final[1][r].cpu() for r in last], SSM_LOGIT_TOL)
    del card, p, inputs, outputs, wrong, final
    print(f"[ssm check] arch={cfg.name} layers={list(JAMBA_CHECK_LAYERS)} of {cfg.n_layers}, one at a time (each CPU "
          f"layer fed the card's input; the card's entry points over all {cfg.n_layers} against its layer by layer run; "
          f"outputs read through ln_f and the unembedding; Mamba's SSM parameters drawn at a trained scale: "
          f"{json.dumps({k: v for k, v in SSM_CHECK_DRAWS.items() if k in ('a_log', 'dt_bias', 'conv_w')})}) "
          f"prompt={SSM_CHECK_PROMPT} max_new={CHECK_NEW} card_tokens={fed} tolerance={SSM_LOGIT_TOL} "
          f"layers_checked={json.dumps(rows)} tokens_compared={compared} wrong_version='Mamba decode with its conv "
          f"carry zeroed' entry_points_vs_layer_by_layer_max_abs_err={entry_err} card_s={t_card - t0:.3f} "
          f"cpu_copy_s={copy_s:.3f} cpu_s={cpu_s:.3f} "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)



# ------------------------------------------------ the encoder-decoder and the vlm prefix (12a)
WHISPER_ARCH, LLAVA_ARCH = "whisper-large-v3", "llava-next-mistral-7b"
#: the reference's ``build(cfg).n_params`` at full depth (f32 masters: whisper 6.4 GB, llava 29.0 GB)
ENC_DEC_PARAMS = {WHISPER_ARCH: 1_600_990_720, LLAVA_ARCH: 7_241_732_096}
#: whisper's traffic: 4 requests, each a 30 s window of 1,500 frames (``enc_embeds`` drawn from the
#: seed), three with 4-token decoder prompts (SOT, language, task, no-timestamps) and one with 128
#: (previous text as context); 16 new tokens each, greedy, through ``prefill`` and ``decode_step``
WHISPER_FRAMES, WHISPER_PROMPTS, WHISPER_NEW = 1_500, (4, 4, 4, 128), 16
#: llava's traffic: 4 requests of 1,152 prefix embeddings (drawn from the seed at 0.02, as the
#: reference's test draws them) and 896 text tokens, 2,048 positions, a cache of 2,056, 8 new tokens
LLAVA_REQUESTS, LLAVA_TEXT, LLAVA_CACHE_LEN, LLAVA_NEW = 4, 896, 2_056, 8
PREFIX_SCALE = 0.02
#: the card-vs-CPU checks: whisper's first 2 encoder and 2 decoder layers over the whole source, a
#: 4-token prompt and CHECK_NEW decode steps; llava's first 2 layers over its prefix and 128 text
#: tokens and CHECK_NEW decode steps; the logits within SERVE_LOGIT_TOL, as smollm's
ENC_DEC_CHECK_LAYERS, LLAVA_CHECK_TEXT = 2, 128
#: whisper's check draws its decoder layers' cross-attention wq and wk anew at this scale (3 x init's):
#: at init's 0.02 the scores over the source have a std of 0.5, every query reads about the mean of the
#: 1,500 frames, and a causal encoder moves the logits by 0.10-0.11 (f32 and bf16, the CPU's plain path
#: at full width, 2 + 2 layers, seed 0), under the tolerance; at 0.06 (scores of std 4.6, the selective
#: attention of a trained model) by 0.27, while the plain path with p kept in f32, as the kernel keeps
#: it, moves them by 0.05
WHISPER_CHECK_CROSS_SCALE = 0.06
WHISPER_ENCODER_ENTRY = "flash_attention/prefill (whisper encoder, D=64)"
WHISPER_CROSS_PREFILL_ENTRY = "flash_attention/prefill (whisper cross, D=64)"
WHISPER_CROSS_DECODE_ENTRY = "flash_attention/decode (whisper cross, D=64)"
LLAVA_PREFILL_ENTRY = "flash_attention/prefill (llava, D=128)"
LLAVA_DECODE_ENTRY = "flash_attention/decode (llava, D=128)"
#: the kernel at whisper's shapes (20 heads of 64, MHA): the encoder's non-causal self-attention over
#: the source, the 128-token prompt's cross-attention (Sq != Skv), the cross decode over the source
WHISPER_FLASH_SHAPES = (
    (WHISPER_ENCODER_ENTRY, flash.INSTANCES[0], (1, 20, 20, WHISPER_FRAMES, WHISPER_FRAMES, 64, False, None)),
    (WHISPER_CROSS_PREFILL_ENTRY, flash.INSTANCES[0], (1, 20, 20, 128, WHISPER_FRAMES, 64, False, None)),
    (WHISPER_CROSS_DECODE_ENTRY, flash.INSTANCES[1], (1, 20, 20, 1, WHISPER_FRAMES, 64, False, WHISPER_FRAMES)),
)
#: and at llava's (32 heads of 128 over 8 kv heads): the causal prefill over prefix and text, decode
LLAVA_FLASH_SHAPES = (
    (LLAVA_PREFILL_ENTRY, flash.INSTANCES[0], (1, 32, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True, None)),
    (LLAVA_DECODE_ENTRY, flash.INSTANCES[1], (1, 32, 8, 1, LLAVA_CACHE_LEN, 128, False, LLAVA_CACHE_LEN)),
)


def flash_counts_zero() -> None:
    for instance in flash.LAUNCHES:
        flash.LAUNCHES[instance] = 0
    flash.SHAPE_LAUNCHES.clear()


def generate(model, batch: dict, start: int, max_new: int, cache_len: int) -> list[int]:
    """One request through ``Model.prefill`` and ``max_new`` decode steps, as
    the serving engine runs them (argmax, the host's read, decode); returns
    the tokens."""
    logits, cache = model.prefill(batch, cache_len)
    logits = logits[:, -1]
    out = []
    for t in range(max_new):
        nxt = torch.argmax(logits, dim=-1)
        out.append(int(nxt[0]))
        logits, cache = model.decode_step(cache, nxt[:, None], start + t)
    return out


def measure_request(model, batch: dict, start: int, max_new: int, cache_len: int) -> dict:
    """A request's prefill ms (CUDA events, the mean of 2 after a warm-up),
    its decode ms a token (the engine's loop on one cache), and the device's
    busy time and idle share over one decode token (``torch.profiler``)."""
    prefill_ms = events_ms(lambda: model.prefill(batch, cache_len), 2)
    logits, cache = model.prefill(batch, cache_len)
    first = logits[:, -1].clone()
    del logits

    def decode_request():
        nxt_logits = first
        for t in range(max_new):
            nxt = torch.argmax(nxt_logits, dim=-1)
            int(nxt[0])  # the engine's host read of each token
            nxt_logits, _ = model.decode_step(cache, nxt[:, None], start + t)

    decode_ms = events_ms(decode_request, 2) / max_new
    trace = timing.profile(model.decode_step, cache, torch.argmax(first, dim=-1)[:, None], start, profile_dir=None)
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms, trace=trace, cache_bytes=cache_bytes)


def enc_dec_line(model, m: dict, weight_bytes: int, live_cache_bytes: int, card) -> str:
    """The measure line's figures: prefill ms, decode ms a token beside its
    bound (the bytes of weights a token reads and the live cache), J a token
    at the power limit, the idle share over one decode token."""
    bound_ms = (weight_bytes + live_cache_bytes) / HBM_BYTES_PER_S * 1e3
    trace = m["trace"]
    return (f"prefill_ms={m['prefill_ms']} decode_ms_per_token={m['decode_ms']} "
            f"decode_j_per_token={energy.device_energy_j(m['decode_ms'] / 1e3, card.power_limit_w)} "
            f"decode_weight_bytes={weight_bytes} decode_live_cache_bytes={live_cache_bytes} "
            f"decode_bytes_bound_ms={bound_ms} decode_trace_kernels={trace.kernels} decode_busy_s={trace.busy_s} "
            f"decode_span_s={trace.span_s} decode_idle_share={trace.idle_share} cache_bytes={m['cache_bytes']} "
            f"power_limit_w={card.power_limit_w} card={card.label!r}")


def built_full(arch: str, seed: int):
    model = build(get_config(arch), device="cuda").init(torch.Generator(device="cuda").manual_seed(seed))
    n = sum(p.numel() for p in model.parameters())
    require(model.n_params == n == ENC_DEC_PARAMS[arch], f"{arch} holds {n} parameters, not {ENC_DEC_PARAMS[arch]}")
    torch.cuda.synchronize()
    return model


def whisper_serve(seed: int, card) -> tuple[object, dict, list]:
    """whisper-large-v3 at full width and depth (32 + 32 layers), weights from
    ``seed``: 4 requests (1,500 frames each; prompts of 4, 4, 4 and 128
    tokens; 16 new tokens) through ``prefill`` and ``decode_step``, the flash
    counts set to 0 just before and read just after: each request's encoder,
    self and cross prefill (32 layers each; Sq <= 16 runs the decode
    instance) and 64 launches a decode step (self and cross). Then prefill
    ms, decode ms a token and J a token, the idle share over one decode token."""
    t0 = time.perf_counter()
    model = built_full(WHISPER_ARCH, seed)
    cfg = model.cfg
    t_built = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    rng = np.random.default_rng(seed + 11)
    reqs = [(torch.randn(1, WHISPER_FRAMES, cfg.d_model, generator=gen, device="cuda"),
             rng.integers(0, cfg.vocab_size, p).astype(np.int32)) for p in WHISPER_PROMPTS]
    flash_counts_zero()
    outs = [generate(model, {"enc_embeds": enc, "tokens": tokens[None, :]}, len(tokens), WHISPER_NEW, WHISPER_FRAMES)
            for enc, tokens in reqs]
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    by_shape = dict(flash.SHAPE_LAUNCHES)
    t_served = time.perf_counter()
    layers = cfg.n_layers
    expected = dict.fromkeys(flash.INSTANCES, 0)
    for p in WHISPER_PROMPTS:
        expected[flash.INSTANCES[0]] += cfg.n_encoder_layers  # the encoder over the source
        expected[flash.instance_of(p)] += 2 * layers  # the prompt's self and cross prefill
        expected[flash.INSTANCES[1]] += 2 * layers * WHISPER_NEW  # self and cross, a decode step
    require(launches == expected, f"whisper launches {launches}, expected {expected}")
    require(all(len(o) == WHISPER_NEW and all(0 <= x < cfg.vocab_size for x in o) for o in outs),
            f"whisper's tokens {outs}")
    # each measured entry's launches as the wrapper counted them by shape (Sq, Skv, causal) in this serve,
    # held to what the requests make: the encoder a request, the cross prefill of the prompt that runs
    # the prefill instance, the cross decode a step
    by_entry, want_entry = {}, {
        WHISPER_ENCODER_ENTRY: cfg.n_encoder_layers * len(WHISPER_PROMPTS),
        WHISPER_CROSS_PREFILL_ENTRY: layers * sum(p > flash.DECODE_MAX_ROWS for p in WHISPER_PROMPTS),
        WHISPER_CROSS_DECODE_ENTRY: layers * WHISPER_NEW * len(WHISPER_PROMPTS)}
    for entry, _, (_, _, _, sq, skv, _, causal, _) in WHISPER_FLASH_SHAPES:
        by_entry[entry] = by_shape.get((sq, skv, causal), 0)
    require(by_entry == want_entry, f"whisper launches by shape {by_entry}, expected {want_entry}")
    enc, tokens = reqs[0]
    m = measure_request(model, {"enc_embeds": enc, "tokens": tokens[None, :]}, len(tokens), WHISPER_NEW,
                        WHISPER_FRAMES)
    # a decode token reads the decoder's weights and the unembedding (not the encoder's; the embedding
    # a row), the cross cache and the live self cache
    p = model.params()
    weight_bytes = (sum(t.numel() * t.element_size() for t in tensors(p["decoder"]))
                    + sum(p[k].numel() * p[k].element_size() for k in ("ln_f", "unembed"))
                    + cfg.d_model * p["embed"].element_size())
    kv_row = cfg.n_kv_heads * cfg.head_dim * p["embed"].element_size()
    live = 2 * layers * kv_row * (WHISPER_FRAMES + len(tokens) + WHISPER_NEW)
    print(f"[whisper serve] arch={cfg.name} encoder_layers={cfg.n_encoder_layers} decoder_layers={layers} "
          f"n_params={model.n_params} d_model={cfg.d_model} heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} "
          f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={cfg.param_dtype} "
          f"compute={cfg.compute_dtype} requests={len(reqs)} frames={WHISPER_FRAMES} prompts={list(WHISPER_PROMPTS)} "
          f"max_new={WHISPER_NEW} launches={json.dumps(launches)} launches_by_shape(Sq,Skv,causal)="
          f"{json.dumps({str(k): v for k, v in sorted(by_shape.items())})} (= {cfg.n_encoder_layers} encoder layers a "
          f"request + {layers} x 2 a prompt + {layers} x 2 a decode step) first_tokens={outs[0][:8]} "
          f"build_s={t_built - t0:.3f} serve_wall_s={t_served - t_built:.3f} card={card.label!r}", flush=True)
    print(f"[whisper measure] prompt={len(tokens)} frames={WHISPER_FRAMES} (prefill = encoder + prompt) "
          f"{enc_dec_line(model, m, weight_bytes, live, card)} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    require(math.isfinite(m["prefill_ms"]) and math.isfinite(m["decode_ms"]) and m["trace"].kernels > 0,
            "whisper measure")
    return model, by_entry, reqs


def check_model(model, cfg, to=None, drawn=None):
    """A model of ``cfg`` (``model``'s config cut in depth) on the meta device,
    given ``model``'s tensors of the layers ``cfg`` keeps, the first
    ``n_layers`` (and ``n_encoder_layers``) of each stack, those in ``drawn``
    replaced: the card's own (no copy), or ``to`` of each (a copy to the host)."""
    keep = {"layers": cfg.n_layers, "decoder": cfg.n_layers, "encoder": cfg.n_encoder_layers}
    kept = {k: v for k, v in model.state_dict().items()
            if k.split(".")[0] not in keep or int(k.split(".")[1]) < keep[k.split(".")[0]]}
    kept.update(drawn or {})
    out = build(cfg, device="meta")
    out.load_state_dict({k: v if to is None else to(v) for k, v in kept.items()}, assign=True)
    return out


def host_bf16(t: torch.Tensor) -> torch.Tensor:
    """A parameter's compute copy (bf16) on the host: the weights the card computes with."""
    return t.to(torch.bfloat16).cpu()


def held_to_cpu(name: str, card_steps: list, cpu_steps: list, wrong_steps: list, what: str, t0: float,
                extra: str) -> None:
    errs = [float((a - b).abs().max()) for a, b in zip(card_steps, cpu_steps)]
    wrong = [float((w - b).abs().max()) for w, b in zip(wrong_steps, cpu_steps)]
    compared = tokens_agree(card_steps[:-1], cpu_steps[:-1], SERVE_LOGIT_TOL)
    print(f"[{name} check] {extra} max_abs_err_by_step={errs} tolerance={SERVE_LOGIT_TOL} "
          f"max_abs_logit={float(max(s.abs().max() for s in cpu_steps))} tokens_compared={compared} "
          f"wrong_version={what!r} wrong_max_abs_err_by_step={wrong} elapsed_s={time.perf_counter() - t0:.3f}",
          flush=True)
    require(max(errs) <= SERVE_LOGIT_TOL and all(math.isfinite(e) for e in errs),
            f"{name}: card logits differ from the CPU's by {max(errs)} > {SERVE_LOGIT_TOL}")
    require(max(wrong) > SERVE_LOGIT_TOL, f"{name}: the tolerance does not reject {what}: {wrong}")


@contextlib.contextmanager
def causal_encoder():
    """A deliberately wrong whisper while it lasts: every ``attention.gqa_apply`` call made causal, so
    that ``whisper.encode`` (its only caller in a prefill) runs a causal encoder."""
    right = attention.gqa_apply
    attention.gqa_apply = lambda *args, **kw: right(*args, **{**kw, "causal": True})
    try:
        yield
    finally:
        attention.gqa_apply = right


def whisper_check(model, reqs: list, seed: int) -> None:
    """whisper's first ENC_DEC_CHECK_LAYERS encoder and decoder layers on the
    card (the served weights, no copy) and on the CPU (a copy, the plain
    path), the CPU fed the card's tokens: the first request's 1,500 frames, a
    4-token prompt and CHECK_NEW decode steps, each step's logits within
    SERVE_LOGIT_TOL; the card with a causal encoder must be rejected. The
    checked layers' cross-attention wq and wk are drawn anew at
    WHISPER_CHECK_CROSS_SCALE (the same tensors on both sides)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, n_encoder_layers=ENC_DEC_CHECK_LAYERS, n_layers=ENC_DEC_CHECK_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    drawn = {f"decoder.{i}.cross.{w}": torch.randn(model.decoder[i].cross.get_parameter(w).shape, generator=gen,
                                                   device="cuda") * WHISPER_CHECK_CROSS_SCALE
             for i in range(cfg.n_layers) for w in ("wq", "wk")}
    card = check_model(model, cfg, drawn=drawn)
    enc, tokens = reqs[0]
    batch = {"enc_embeds": enc, "tokens": tokens[None, :]}
    logits, cache = card.prefill(batch, WHISPER_FRAMES)
    card_steps, fed = decode_logits(card, cache, len(tokens), logits[0, -1].float().cpu())
    card_steps = [logits[0, -1].float().cpu()] + card_steps
    p = card.params()
    with causal_encoder():
        enc_out = whisper.encode(cfg, p, enc.to(card.compute_dtype))
    logits, cache = whisper.prefill_encoded(cfg, p, enc_out, torch.as_tensor(tokens[None, :], device="cuda").long())
    wrong_steps, _ = decode_logits(card, cache, len(tokens), logits[0, -1].float().cpu(), forced=fed)
    wrong_steps = [logits[0, -1].float().cpu()] + wrong_steps
    del logits, cache, enc_out
    torch.cuda.synchronize()
    t_card = time.perf_counter()
    cpu = check_model(model, dataclasses.replace(cfg, param_dtype="bfloat16"), to=host_bf16, drawn=drawn)
    t_copy = time.perf_counter()
    logits, cache = cpu.prefill({"enc_embeds": enc.cpu(), "tokens": tokens[None, :]}, WHISPER_FRAMES)
    cpu_steps, _ = decode_logits(cpu, cache, len(tokens), logits[0, -1].float(), forced=fed)
    cpu_steps = [logits[0, -1].float()] + cpu_steps
    del cpu, card, logits, cache
    held_to_cpu("whisper", card_steps, cpu_steps, wrong_steps, "a causal encoder", t0,
                f"encoder_layers={cfg.n_encoder_layers} decoder_layers={cfg.n_layers} (the served model's first) "
                f"frames={WHISPER_FRAMES} prompt={len(tokens)} max_new={CHECK_NEW} card_tokens={fed} "
                f"cross_wq_wk_drawn_at={WHISPER_CHECK_CROSS_SCALE} cpu_params=bfloat16 (the card's compute copies) card_s={t_card - t0:.3f} cpu_copy_s={t_copy - t_card:.3f} cpu_s={time.perf_counter() - t_copy:.3f}")


def llava_serve(seed: int, card) -> tuple[object, dict, list]:
    """llava-next-mistral-7b at full width and depth (32 layers), weights from
    ``seed``: 4 requests of 1,152 prefix embeddings and 896 text tokens
    (2,048 positions; cache 2,056; 8 new tokens, the decode positions after
    the prefix) through ``prefill`` and ``decode_step``, the flash counts set
    to 0 just before and read just after: 32 a prefill and 32 a decode step.
    Then prefill ms, decode ms a token, J a token, the idle share over one
    decode token."""
    t0 = time.perf_counter()
    model = built_full(LLAVA_ARCH, seed)
    cfg = model.cfg
    t_built = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    rng = np.random.default_rng(seed + 12)
    reqs = [(torch.randn(1, cfg.n_prefix_embeds, cfg.d_model, generator=gen, device="cuda") * PREFIX_SCALE,
             rng.integers(0, cfg.vocab_size, LLAVA_TEXT).astype(np.int32)) for _ in range(LLAVA_REQUESTS)]
    start = cfg.n_prefix_embeds + LLAVA_TEXT
    flash_counts_zero()
    outs = [generate(model, {"prefix_embeds": pre, "tokens": tokens[None, :]}, start, LLAVA_NEW, LLAVA_CACHE_LEN)
            for pre, tokens in reqs]
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    t_served = time.perf_counter()
    expected = {flash.INSTANCES[0]: cfg.n_layers * LLAVA_REQUESTS, flash.INSTANCES[1]: cfg.n_layers * LLAVA_REQUESTS * LLAVA_NEW}
    require(launches == expected, f"llava launches {launches}, expected {expected}")
    require(all(len(o) == LLAVA_NEW and all(0 <= x < cfg.vocab_size for x in o) for o in outs), f"llava's tokens {outs}")
    pre, tokens = reqs[0]
    m = measure_request(model, {"prefix_embeds": pre, "tokens": tokens[None, :]}, start, LLAVA_NEW, LLAVA_CACHE_LEN)
    kv_row = cfg.n_kv_heads * cfg.head_dim * 2
    live = 2 * cfg.n_layers * kv_row * (start + LLAVA_NEW)
    print(f"[llava serve] arch={cfg.name} layers={cfg.n_layers} n_params={model.n_params} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} rope_theta={cfg.rope_theta} params={cfg.param_dtype} compute={cfg.compute_dtype} "
          f"requests={LLAVA_REQUESTS} prefix_embeds={cfg.n_prefix_embeds} text={LLAVA_TEXT} positions={start} "
          f"cache_len={LLAVA_CACHE_LEN} max_new={LLAVA_NEW} launches={json.dumps(launches)} (= {cfg.n_layers} x "
          f"(prefills, decode steps)) first_tokens={outs[0]} build_s={t_built - t0:.3f} "
          f"serve_wall_s={t_served - t_built:.3f} card={card.label!r}", flush=True)
    print(f"[llava measure] positions={start} {enc_dec_line(model, m, decode_weight_bytes(model), live, card)} "
          f"prefill_tokens_per_s={start / m['prefill_ms'] * 1e3} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    require(math.isfinite(m["prefill_ms"]) and math.isfinite(m["decode_ms"]) and m["trace"].kernels > 0,
            "llava measure")
    by_entry = {LLAVA_PREFILL_ENTRY: launches[flash.INSTANCES[0]], LLAVA_DECODE_ENTRY: launches[flash.INSTANCES[1]]}
    return model, by_entry, reqs


def llava_check(model, reqs: list, seed: int) -> None:
    """llava's first ENC_DEC_CHECK_LAYERS layers on the card (the served
    weights, no copy) and on the CPU (a bf16 copy, the plain path), the CPU
    fed the card's tokens: the first request's 1,152 prefix embeddings,
    LLAVA_CHECK_TEXT text tokens and CHECK_NEW decode steps, each step's
    logits within SERVE_LOGIT_TOL; the card without the prefix (the text at
    positions 0...) must be rejected."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, n_layers=ENC_DEC_CHECK_LAYERS)
    card = check_model(model, cfg)
    pre, text = reqs[0]
    tokens = text[:LLAVA_CHECK_TEXT]
    start = cfg.n_prefix_embeds + len(tokens)
    cache_len = start + CHECK_NEW
    logits, cache = card.prefill({"prefix_embeds": pre, "tokens": tokens[None, :]}, cache_len)
    first = logits[0, -1].float().cpu()
    card_steps, fed = decode_logits(card, cache, start, first)
    card_steps = [first] + card_steps
    bare = check_model(model, dataclasses.replace(cfg, n_prefix_embeds=0))
    logits, cache = bare.prefill({"tokens": tokens[None, :]}, len(tokens) + CHECK_NEW)
    first = logits[0, -1].float().cpu()
    wrong_steps, _ = decode_logits(bare, cache, len(tokens), first, forced=fed)
    wrong_steps = [first] + wrong_steps
    del logits, cache, bare
    torch.cuda.synchronize()
    t_card = time.perf_counter()
    cpu = check_model(model, dataclasses.replace(cfg, param_dtype="bfloat16"), to=host_bf16)
    t_copy = time.perf_counter()
    logits, cache = cpu.prefill({"prefix_embeds": pre.cpu(), "tokens": tokens[None, :]}, cache_len)
    first = logits[0, -1].float()
    del logits
    cpu_steps, _ = decode_logits(cpu, cache, start, first, forced=fed)
    cpu_steps = [first] + cpu_steps
    del cpu, card, cache
    held_to_cpu("llava", card_steps, cpu_steps, wrong_steps, "the text without the prefix", t0,
                f"layers={cfg.n_layers} (the served model's first) prefix_embeds={cfg.n_prefix_embeds} "
                f"text={len(tokens)} max_new={CHECK_NEW} card_tokens={fed} cpu_params=bfloat16 (the card's compute "
                f"copies) card_s={t_card - t0:.3f} cpu_copy_s={t_copy - t_card:.3f} "
                f"cpu_s={time.perf_counter() - t_copy:.3f}")


# --------------------------------------------------------------------------- training (12b)
TRAIN_ARCH = "smollm-360m"
#: the reference's ``build(cfg).n_params`` at full depth (32 layers)
TRAIN_PARAMS = 409_007_040
#: (a): smollm-360m trained at full width and depth from ``--seed``'s weights (f32 masters, bf16
#: compute, remat per its config), ``ZipfBigramStream`` over its vocab, 8 x 512 tokens a step, 60
#: steps at lr 1e-3 with 5 warm-up steps; the loss must fall by TRAIN_LOSS_DROP, the last 10 steps'
#: mean against the first 10's (the reference test's criterion)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 512, 60, 5, 1e-3
TRAIN_LOSS_DROP, TRAIN_LOSS_WINDOW = 0.5, 10
#: the steps timed: 11 to 60 (the first ones hold the allocator's and cuBLAS's first calls)
TRAIN_TIMED_FROM = 10
#: the dense bf16 peak of one H100 SXM (NVIDIA's data sheet, at 700 W)
H100_BF16_FLOPS = 989e12
#: (b): the Trainer at full width cut to 2 of 32 layers, for its checkpoints' disk time (f32 params,
#: m and v: 1.36 GB a checkpoint), 8 x 128 tokens a step, to step 20 with a checkpoint every 10, then
#: a new Trainer resuming to 30
TRAINER_LAYERS, TRAINER_BATCH, TRAINER_SEQ, TRAINER_CKPT_EVERY, TRAINER_STEPS = 2, 8, 128, 10, (20, 30)
#: (c): the card against the CPU's plain path at the same compute dtype (bf16 over f32 masters): the
#: trainer's last weights (2 layers, full width), one batch of 2 x 256 tokens; the loss within
#: TRAIN_LOSS_TOL, each parameter's gradient within a relative L2 error of TRAIN_GRAD_TOL
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2, 256, 0.02, 0.05
#: (d): the launcher in process, on the card: the reduced config, 4 steps
LAUNCH_STEPS = 4


def model_flops_per_step(cfg, n_params: int, batch: int, seq: int) -> float:
    """The model's FLOPs a train step: 6 x N a token (forward and backward,
    every parameter counted) plus attention's score and value products, 12
    x layers x heads x head_dim x seq a token (forward and backward, the
    whole square, PaLM's count); remat's recomputation is not counted."""
    tokens = batch * seq
    return 6 * n_params * tokens + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq * tokens


def train_full(seed: int, card) -> None:
    """19c (a): smollm-360m at full width and depth, TRAIN_STEPS steps of
    ``make_train_step`` from weights drawn from ``seed``, the flash counts set
    to 0 just before and read just after (training takes the plain attention:
    the kernel has no backward). Prints the step's median ms over the timed
    steps, tokens/s, the model's FLOPs a step and their share of the bf16
    peak, J a token at the power limit, the kernels and the idle share over
    one step (``torch.profiler``) and the peak memory."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    model = build(cfg, device="cuda")
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    params, state = init_train_state(model, tcfg, torch.Generator(device="cuda").manual_seed(seed))
    n = sum(p.numel() for p in params.values())
    require(model.n_params == n == TRAIN_PARAMS and cfg.n_layers == 32 and cfg.remat,
            f"{TRAIN_ARCH} holds {n} parameters in {cfg.n_layers} layers (remat {cfg.remat})")
    stream = ZipfBigramStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    batches = [stream.batch(i) for i in range(TRAIN_STEPS)]
    step_fn = make_train_step(model, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_ready = time.perf_counter()
    flash_counts_zero()
    losses, times = [], []
    for batch in batches:
        t1 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))  # read after the step's last launch: waits for all of it
        times.append(time.perf_counter() - t1)
    launches = dict(flash.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    t_trained = time.perf_counter()
    require(sum(launches.values()) == 0, f"training launched the flash kernel: {launches}")
    require(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    first = float(np.mean(losses[:TRAIN_LOSS_WINDOW]))
    last = float(np.mean(losses[-TRAIN_LOSS_WINDOW:]))
    require(last <= first - TRAIN_LOSS_DROP, f"the loss fell from {first} to {last}, not by {TRAIN_LOSS_DROP}")
    trace = timing.profile(step_fn, params, state, batches[-1], profile_dir=None)
    step_s = float(np.median(times[TRAIN_TIMED_FROM:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops_per_step(cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} n_params={n} params={cfg.param_dtype} "
          f"compute={cfg.compute_dtype} remat={cfg.remat} batch={TRAIN_BATCH}x{TRAIN_SEQ} steps={TRAIN_STEPS} "
          f"lr={TRAIN_LR} warmup={TRAIN_WARMUP} loss_first10={first} loss_last10={last} "
          f"loss_by_10={[round(x, 4) for x in losses[::10]]} flash_launches={json.dumps(launches)} "
          f"step_ms_median_11_60={step_s * 1e3} step_ms_first={times[0] * 1e3} tokens_per_s={tokens / step_s} "
          f"model_flops_per_step={flops} (6 N tokens + attention) flops_share_of_989_tflops="
          f"{flops / step_s / H100_BF16_FLOPS} j_per_token={energy.device_energy_j(step_s, card.power_limit_w) / tokens} "
          f"step_trace_kernels={trace.kernels} step_busy_s={trace.busy_s} step_span_s={trace.span_s} "
          f"step_idle_share={trace.idle_share} max_memory_allocated_bytes={peak} "
          f"power_limit_w={card.power_limit_w} card={card.label!r} build_s={t_ready - t0:.3f} "
          f"train_s={t_trained - t_ready:.3f} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)


def train_resume(seed: int, card) -> tuple[object, dict]:
    """19c (b): a Trainer at full width on TRAINER_LAYERS layers to step 20
    with a checkpoint every 10, in a temporary directory; a new Trainer must
    resume from step 20 and stop at 30 after 10 steps. The newest checkpoint,
    restored onto the CPU, must equal the card's state leaf for leaf, bit for
    bit. Prints the checkpoint's bytes and the seconds to save and restore.
    Returns the model and the last params (the card check's weights)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAINER_LAYERS)
    model = build(cfg, device="cuda")
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAINER_STEPS[1]))
    stream = ZipfBigramStream(DataConfig(cfg.vocab_size, TRAINER_SEQ, TRAINER_BATCH))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        def trainer(total):
            return Trainer(model, tcfg, TrainerConfig(total_steps=total, ckpt_every=TRAINER_CKPT_EVERY, ckpt_dir=d,
                                                      log_every=TRAINER_CKPT_EVERY), stream)

        first = trainer(TRAINER_STEPS[0]).run(seed)
        require(first["final_step"] == TRAINER_STEPS[0] and train_ckpt.available_steps(d) == [10, 20],
                f"the first trainer stopped at {first['final_step']} with checkpoints {train_ckpt.available_steps(d)}")
        resumed = trainer(TRAINER_STEPS[1])
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            second = resumed.run(seed)
        run_s = time.perf_counter() - t1
        print(out.getvalue(), end="", flush=True)
        require(f"resumed from step {TRAINER_STEPS[0]}" in out.getvalue(), "the second trainer did not resume")
        require(second["final_step"] == TRAINER_STEPS[1] and len(second["history"]) == 10,
                f"the resumed trainer ended at {second['final_step']} after {len(second['history'])} steps")
        step_dir = Path(d) / f"step_{TRAINER_STEPS[1]}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        t1 = time.perf_counter()
        step, host = train_ckpt.restore(d, resumed.state, device="cpu")
        restore_s = time.perf_counter() - t1
    on_card, on_host = train_ckpt._flatten(resumed.state), train_ckpt._flatten(host)
    unequal = [k for k in on_card if on_card[k].dtype != on_host[k].dtype or not torch.equal(on_card[k].cpu(), on_host[k])]
    require(step == TRAINER_STEPS[1] and on_card.keys() == on_host.keys() and not unequal,
            f"the checkpoint restored onto the CPU (step {step}) differs from the card's state: {unequal[:5]}")
    print(f"[train trainer] arch={cfg.name} layers={cfg.n_layers} of 32 (full width) batch={TRAINER_BATCH}x{TRAINER_SEQ} "
          f"ckpt_every={TRAINER_CKPT_EVERY} first_final_step={first['final_step']} resumed_from={TRAINER_STEPS[0]} "
          f"final_step={second['final_step']} history={len(second['history'])} final_loss={second['final_loss']} "
          f"stragglers={second['stragglers']} ckpt_leaves={len(on_host)} ckpt_bytes={ckpt_bytes} "
          f"save_snapshot_s={resumed.saver.snapshot_s:.3f} save_write_s={resumed.saver.write_s:.3f} "
          f"restore_to_cpu_s={restore_s:.3f} restored_equal_bit_for_bit=True resumed_run_s={run_s:.3f} "
          f"card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    return model, resumed.state["params"]


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


@contextlib.contextmanager
def noncausal_training():
    """A deliberately wrong training forward while it lasts: every attention
    call of ``attention.gqa_apply`` made non-causal."""
    right = attention.full_attention
    attention.full_attention = lambda *args, **kw: right(*args, **{**kw, "causal": False})
    try:
        yield
    finally:
        attention.full_attention = right


def train_check(model, masters: dict, seed: int) -> None:
    """19c (c): the loss and every parameter's gradient of ``model`` (full
    width, TRAINER_LAYERS layers) with ``masters`` on one batch, on the card
    and on the CPU's plain path (a copy of the masters, the same bf16
    compute): the loss within TRAIN_LOSS_TOL, each gradient within
    TRAIN_GRAD_TOL relative L2; the training forward with non-causal
    attention must be rejected."""
    t0 = time.perf_counter()
    tcfg = TrainConfig()
    batch = ZipfBigramStream(DataConfig(model.cfg.vocab_size, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                                        seed=seed + 21)).batch(0)
    loss_fn = make_loss_fn(model, tcfg)
    (loss, _), grads = value_and_grad(loss_fn, masters, batch)
    with noncausal_training():
        (wrong_loss, _), wrong = value_and_grad(loss_fn, masters, batch)
    grads = {k: g.cpu() for k, g in grads.items()}
    wrong = {k: g.cpu() for k, g in wrong.items()}
    t_card = time.perf_counter()
    cpu = build(model.cfg, device="cpu")
    (cpu_loss, _), cpu_grads = value_and_grad(make_loss_fn(cpu, tcfg), {k: v.cpu() for k, v in masters.items()}, batch)
    t_cpu = time.perf_counter()
    errs = {k: rel_l2(grads[k], cpu_grads[k]) for k in cpu_grads}
    wrong_errs = {k: rel_l2(wrong[k], cpu_grads[k]) for k in cpu_grads}
    loss_err, wrong_loss_err = abs(float(loss) - float(cpu_loss)), abs(float(wrong_loss) - float(cpu_loss))
    worst, wrong_worst = max(errs, key=errs.get), max(wrong_errs, key=wrong_errs.get)
    print(f"[train check] arch={model.cfg.name} layers={model.cfg.n_layers} (full width; the trainer's last weights) "
          f"batch={TRAIN_CHECK_BATCH}x{TRAIN_CHECK_SEQ} compute={model.cfg.compute_dtype} card_loss={float(loss)} "
          f"cpu_loss={float(cpu_loss)} loss_abs_err={loss_err} loss_tolerance={TRAIN_LOSS_TOL} "
          f"grad_max_rel_l2={errs[worst]} ({worst}) grad_tolerance={TRAIN_GRAD_TOL} "
          f"wrong_version='non-causal attention' wrong_loss_abs_err={wrong_loss_err} "
          f"wrong_grad_max_rel_l2={wrong_errs[wrong_worst]} ({wrong_worst}) card_s={t_card - t0:.3f} "
          f"cpu_s={t_cpu - t_card:.3f}", flush=True)
    require(loss_err <= TRAIN_LOSS_TOL and max(errs.values()) <= TRAIN_GRAD_TOL,
            f"card vs CPU: loss {loss_err} > {TRAIN_LOSS_TOL} or a gradient {errs[worst]} > {TRAIN_GRAD_TOL}")
    require(wrong_loss_err > TRAIN_LOSS_TOL or max(wrong_errs.values()) > TRAIN_GRAD_TOL,
            "the tolerances do not reject non-causal attention")


def train_launch(card) -> None:
    """19c (d): ``launch.train.main`` in process, LAUNCH_STEPS steps of the
    reduced config on the card, its checkpoints in a temporary directory."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as d:
        out = launch_train.main(["--arch", TRAIN_ARCH, "--reduced", "--steps", str(LAUNCH_STEPS), "--device", "cuda",
                                 "--ckpt-dir", str(Path(d) / "run")])
        saved = train_ckpt.available_steps(Path(d) / "run")
    require(out["final_step"] == LAUNCH_STEPS and math.isfinite(out["final_loss"]) and saved == [LAUNCH_STEPS],
            f"the launcher ended at step {out['final_step']} (loss {out['final_loss']}, checkpoints {saved})")
    print(f"[train launch] argv='--arch {TRAIN_ARCH} --reduced --steps {LAUNCH_STEPS} --device cuda' "
          f"final_step={out['final_step']} final_loss={out['final_loss']} checkpoints={saved} card={card.label!r} "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)


def events_ms(fn, repeats: int) -> float:
    """Mean device ms of ``fn`` over ``repeats`` calls between two CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def device_ms(fn, repeats: int) -> dict:
    """``fn``'s device time with the host ahead of the device: after a
    warm-up, ``torch.cuda._sleep`` holds the stream while the host queues
    ``repeats`` calls between two CUDA events, so the events time the
    kernels alone and not the host's work between launches. Also the host's
    µs a call (the queueing, timed once back to back), the old back-to-back
    figure (events around calls the host issues as the device runs them),
    and whether the host stayed ahead (the first event still pending when
    the last call was queued)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    host_us = (time.perf_counter() - t0) / repeats * 1e6
    back_to_back = events_ms(fn, repeats)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(3 * repeats * host_us * 1e-6, SLEEP_MIN_S) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / repeats, host_us=host_us, back_to_back_ms=back_to_back, ahead=ahead)


def flash_bound(h, kh, sq, kv_len, d, causal, elem_bytes) -> dict:
    """The least time for one call: bytes (q and o once, the live K/V rows
    once) over the HBM rate against 4 D flops a live (row, key) pair over the
    bf16 tensor-core rate."""
    pairs = sum(min(kv_len, r + 1) for r in range(sq)) if causal else sq * kv_len
    flops = 4 * d * h * pairs
    n_bytes = elem_bytes * d * (2 * h * sq + 2 * kh * kv_len)
    bytes_ms, flops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return dict(flops=flops, bytes=n_bytes, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


#: smollm's served shapes (causal prefill at 2,048; decode at kv_len 2,056), and its prefill at
#: 16,384 (printed only): (entry name, instance, shape)
SMOLLM_FLASH_SHAPES = (
    (flash.INSTANCES[0], flash.INSTANCES[0], (1, 15, 5, SERVE_PROMPT, SERVE_PROMPT, 64, True, None)),
    (flash.INSTANCES[1], flash.INSTANCES[1], (1, 15, 5, 1, SERVE_CACHE_LEN, 64, False, SERVE_CACHE_LEN)),
    (None, flash.INSTANCES[0], (1, 15, 5, LONG_PROMPT, LONG_PROMPT, 64, True, None)),
)


def flash_measure(seed: int, worst: dict, by_instance: dict, sms: int, shapes=SMOLLM_FLASH_SHAPES) -> list[dict]:
    """The kernel at ``shapes`` (smollm's served ones by default; deepseek's
    MLA prefill), its plain version and SDPA (timed only, never called by the
    port), device times with the host ahead. Returns the ``kernels`` line's
    entries: one a shape with an entry name, its launches ``by_instance[name]``."""
    entries = []
    for entry, instance, (b, h, kh, sq, skv, d, causal, kv_len) in shapes:
        q, k, v = flash_inputs(b, h, kh, sq, skv, d, torch.bfloat16, seed)
        kernel = device_ms(lambda: flash.flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len), 50)
        library = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True), 50)
        # the backend SDPA's own dispatch picks for these inputs
        sdpa_backend = SDP_BACKENDS[torch._fused_sdp_choice(q, k, v, is_causal=causal, enable_gqa=True)]
        require(kernel["ahead"] and library["ahead"], f"the host fell behind the device timing {instance} at Sq={sq}")
        kernel_ms, library_ms = kernel["ms"], library["ms"]
        # the plain version at the kernels line's shapes only
        plain_ms = events_ms(lambda: flash_plain(q, k, v, causal=causal, kv_len=kv_len), 5) if sq <= SERVE_PROMPT else None
        bnd = flash_bound(h, kh, sq, kv_len or skv, d, causal, q.element_size())
        grid = ""
        if instance == flash.INSTANCES[1]:
            row_groups, n_split, split_keys = flash.decode_plan(b, h, kh, sq, kv_len or skv, sms)
            blocks = b * kh * row_groups * n_split
            require(blocks > b * h, f"the decode runs {blocks} blocks, not more than B * H = {b * h}")
            grid = (f" blocks={blocks} (B*KH={b * kh} x row_groups={row_groups} x splits={n_split} of "
                    f"{split_keys} keys) rows_a_block={h // kh * sq} (B*H={b * h})")
        print(f"[flash measure] entry={entry} instance={instance} B={b} H={h} KH={kh} Sq={sq} Skv={skv} kv_len={kv_len or skv} "
              f"D={d} causal={causal} dtype=bfloat16 ms={kernel_ms} host_us={kernel['host_us']} "
              f"back_to_back_ms={kernel['back_to_back_ms']} plain_ms={plain_ms} sdpa_ms={library_ms} "
              f"sdpa_host_us={library['host_us']} sdpa_back_to_back_ms={library['back_to_back_ms']} "
              f"sdpa_backend={sdpa_backend} "
              f"bound_ms={bnd['bound_ms']} bound_by={bnd['bound_by']} flops={bnd['flops']} bytes={bnd['bytes']} "
              f"tflops={bnd['flops'] / kernel_ms / 1e9} gb_per_s={bnd['bytes'] / kernel_ms / 1e6}{grid}", flush=True)
        if entry is None:
            continue  # printed only: the kernels line holds the served shapes
        entries.append({
            "name": entry, "route": "cuda", "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": by_instance[entry], "max_abs_err": worst[entry], "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"], "library_ms": library_ms,
            "library": f"scaled_dot_product_attention ({sdpa_backend})",
            "shape": [b, h, kh, sq, skv, d], "kv_len": kv_len or skv, "causal": causal,
        })
    return entries


def serve_measure(model, seed: int, card) -> None:
    """The engine's numbers on the card: a request's prefill (ms between CUDA
    events around the call, and tokens/s), its decode (ms a token, as the
    engine runs it: argmax, host sync, decode step), J a generated token at
    the card's power limit, and the device's busy time and idle share over
    one prefill and over one request's decode (torch.profiler)."""
    t0 = time.perf_counter()
    reqs, _ = serve_requests(model.cfg.vocab_size, seed)
    tokens = torch.as_tensor(reqs[0].tokens, device="cuda")[None, :]
    prefill_ms = events_ms(lambda: model.prefill({"tokens": tokens}, SERVE_CACHE_LEN), 3)
    # the device's busy time and idle share over one prefill: is the host or the device its bound?
    prefill_trace = timing.profile(model.prefill, {"tokens": tokens}, SERVE_CACHE_LEN,
                                   profile_dir=Path(__file__).resolve().parent / "build" / "profile_prefill")
    logits, cache = model.prefill({"tokens": tokens}, SERVE_CACHE_LEN)
    first = logits[:, -1, :].clone()
    del logits

    def decode_request():
        nxt_logits = first
        for t in range(SERVE_NEW):
            nxt = torch.argmax(nxt_logits, dim=-1)
            int(nxt[0])  # the engine's host read of each token
            nxt_logits, _ = model.decode_step(cache, nxt[:, None], SERVE_PROMPT + t)

    tm = timing.measure(decode_request, steps=SERVE_NEW, repeats=3,
                        profile_dir=Path(__file__).resolve().parent / "build" / "profile_decode")
    decode_ms = tm.execute_s * 1e3 / SERVE_NEW
    request_j = energy.device_energy_j((prefill_ms + decode_ms * SERVE_NEW) / 1e3, card.power_limit_w)
    trace = tm.trace
    print(f"[serve measure] prompt={SERVE_PROMPT} prefill_ms={prefill_ms} prefill_tokens_per_s="
          f"{SERVE_PROMPT / prefill_ms * 1e3} prefill_trace_kernels={prefill_trace.kernels} "
          f"prefill_busy_s={prefill_trace.busy_s} prefill_span_s={prefill_trace.span_s} "
          f"prefill_idle_share={prefill_trace.idle_share} "
          f"decode_ms_per_token={decode_ms} decode_tokens_per_s={1e3 / decode_ms} "
          f"decode_j_per_token={tm.j_per_step} request_j_per_generated_token={request_j / SERVE_NEW} "
          f"decode_trace_kernels={trace.kernels} decode_busy_s={trace.busy_s} decode_span_s={trace.span_s} "
          f"decode_idle_share={trace.idle_share} power_limit_w={card.power_limit_w} card={card.label!r} "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)


def hgmma_counts(lib) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each bf16 prefill kernel of
    the flash library (``cuobjdump --dump-sass``), by kernel name."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib.path)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if "prefill_tc_kernel" in name:
                counts[name] = 0
        elif name in counts and "HGMMA" in line:
            counts[name] += 1
    return counts


def ptxas_report(lib) -> list[str]:
    """One ``kernel: usage; stack and spills`` item per kernel the library holds."""
    out, name, function, spills = [], None, None, {}
    for line in lib.ptxas:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Function properties for" in line:
            function = line.split("Function properties for", 1)[1].strip()
        elif "bytes spill stores" in line:
            spills[function] = line
        elif "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills.get(name, 'no stack line')}")
    return out


def spill_stores(lib) -> int:
    """The bytes of spill stores ptxas reported over every function of the library."""
    return sum(int(line.split("bytes spill stores")[0].split(",")[-1]) for line in lib.ptxas
               if "bytes spill stores" in line)


class Phases:
    """Each phase's seconds, in order, for the ``[phases]`` line."""

    def __init__(self, t_start: float):
        self.seconds: dict[str, float] = {}
        self.t = t_start

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 3)
        self.t = now


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--shard-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--shard-world", type=int, default=SHARD_WORLD, help=argparse.SUPPRESS)
    args = parser.parse_args()
    seed = args.seed
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("[device] no CUDA device: chip_smoke.py runs on the card", file=sys.stderr)
        return 1
    if args.shard_rank is not None:
        with torch.inference_mode():
            shard_rank(args.shard_rank, args.shard_world, seed, t_start)
        return 0

    # 1. device
    sys.stdout.reconfigure(line_buffering=True)  # a run cut off shows how far it got
    phases = Phases(t_start)
    t0 = time.perf_counter()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    card = card_info(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] name={name!r} count={count} sms={sms} power_limit_w={card.power_limit_w} "
          f"max_sm_clock_mhz={card.max_sm_clock_mhz} torch={torch.__version__} cuda={torch.version.cuda} "
          f"host_cpu={host_cpu()!r} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    print(smi, flush=True)
    phases.done("device")

    # the CPU workers: plain runs of the small checks and the grid's CPU references
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx, initializer=_worker_init,
                                                initargs=(CPU_WORKER_NICE,)) as pool:
        # neither the grid's CPU references nor the shard phase's world (10b) needs a kernel: both start
        # before the build, and run beside it and phase 3
        paper, rows = grid_rows()
        references = {label: pool.submit(cpu_grid_case, kind, opts, seed)
                      for label, kind, _, opts, cases in rows if cases is paper}
        shard_deadline = time.monotonic() + SHARD_TIMEOUT_S
        shard_procs = shard_start(seed)
        try:
            # 2. build: one nvcc per source, all started together (programs of one source share its
            # build), the flash kernel's among them
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(kernel.PROGRAMS) + 1) as threads:
                flash_lib = threads.submit(flash.library)
                built = {lib.path: lib for lib in threads.map(kernel.library, kernel.PROGRAMS)}
                built[flash_lib.result().path] = flash_lib.result()
            for lib in built.values():
                report = ptxas_report(lib)
                require(bool(report), f"ptxas printed no register report for {lib.path.name}")
                print(f"[build] library={lib.path.name} spill_stores={spill_stores(lib)} ptxas={report}", flush=True)
            for program in kernel.PROGRAMS:
                lib = kernel.library(program)
                require(spill_stores(lib) == 0, f"ptxas spills in {lib.path.name}")
            hgmma = hgmma_counts(flash_lib.result())
            require(len(hgmma) == len(flash.HEAD_DIMS) and all(n > 0 for n in hgmma.values()),
                    f"a bf16 prefill kernel without wgmma in its SASS: {hgmma}")
            print(f"[build] flash bf16 prefill HGMMA instructions by kernel: {json.dumps(hgmma)}", flush=True)
            for line in ptxas_report(flash_lib.result()):
                if "Li192E" in line:  # MLA's head dim: registers and spill stores of each D = 192 kernel
                    print(f"[build] flash D=192 {line}", flush=True)
            print(f"[build] sources={len(built)} programs={len(kernel.PROGRAMS)} + flash_attention "
                  f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
            phases.done("build")

            # 3. check: every program and telemetry instance == its plain version, exactly. The checks
            # at N > CPU_PLAIN_MAX_N run their plain versions on the card in CARD_PLAIN_WORKERS
            # processes, beside the rest of the shard phase's world (two ranks on the card, phase 10b):
            # none of them times anything kept (phases 6 and 7 time the plain versions alone)
            t0 = time.perf_counter()
            with concurrent.futures.ProcessPoolExecutor(CARD_PLAIN_WORKERS, mp_context=ctx,
                                                        initializer=_worker_init) as card_pool:
                checks = Checks(pool, seed, card_pool)
                run_checks(checks, seed)
                run_telemetry_checks(checks, seed)
                n_card = len(checks.pending_card)
                checks.finish_card()
            shard_wait(shard_procs, shard_deadline)
            print(f"[check] card phase done: {checks.count} checks ({n_card} plain runs in {CARD_PLAIN_WORKERS} "
                  f"card workers, the shard world beside them), {len(checks.pending)} plain runs still in CPU "
                  f"workers elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
            phases.done("program and telemetry checks (with the shard world)")
        except BaseException:
            shard_stop(shard_procs)
            raise

        # 4. grid: the main path, through every program
        t0 = time.perf_counter()
        expected = dict.fromkeys(kernel.LAUNCHES, 0)
        n_requests = len(paper) * zipf.PAPER_NUM_SAMPLES * zipf.PAPER_TRACE_LEN
        grid = {}
        for program in kernel.LAUNCHES:
            kernel.LAUNCHES[program] = 0
        for label, kind, kw, _, cases in rows:
            t1 = time.perf_counter()
            program = kernel.program_of(kind, kw == BUDGET)
            expected[program] += len(cases)
            before = kernel.LAUNCHES[program]
            results = simulate.run_grid(kind, cases, seed=seed, **kw)
            grid[label] = results
            device_s = sum(r.device_s for r in results)
            per_n = {}
            for r in results:
                per_n[r.case.n_objects] = per_n.get(r.case.n_objects, 0.0) + r.device_s
            by_rate = {f"{r.case.rate:.3f}": round(r.device_s, 6) for r in results if r.case.n_objects == 100_000}
            mean_chr = sum(r.mean_chr for r in results) / len(results)
            byte_chr = ([r.mean_byte_chr for r in results] if results[0].mean_byte_chr is not None else None)
            mean_byte_chr = None if byte_chr is None else sum(byte_chr) / len(byte_chr)
            print(f"[grid {label}] program={program} cases={len(results)} "
                  f"launches={kernel.LAUNCHES[program] - before} grid_mean_chr={mean_chr} "
                  f"grid_mean_byte_chr={mean_byte_chr} device_s={device_s} "
                  f"j_per_request={device_s * card.power_limit_w / (len(results) * n_requests / len(paper))} "
                  f"device_s_by_n={json.dumps({k: round(v, 6) for k, v in per_n.items()})} "
                  f"n100k_device_s_by_rate={json.dumps(by_rate)} card={card.label!r} "
                  f"elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
            for r in results:
                values = (r.mean_chr, r.std_chr, r.mean_evictions, r.mean_metadata, r.device_s)
                require(all(math.isfinite(v) for v in values), f"non-finite metric in {label} {r.case}")
                require(0.0 <= r.mean_chr <= 1.0 and r.mean_evictions >= 0 and r.mean_metadata >= 1,
                        f"out-of-range metric in {label} {r.case}: {r}")
                require(bool(kw) == (r.mean_byte_chr is not None), f"byte CHR of {label} {r.case}")
                if r.mean_byte_chr is not None:
                    require(0.0 <= r.mean_byte_chr <= 1.0, f"byte CHR out of range in {label} {r.case}")
        launches = dict(kernel.LAUNCHES)
        require(launches == expected, f"the grid launched {launches}, expected {expected}")
        chr_of = {label: sum(r.mean_chr for r in v) / len(v) for label, v in grid.items()}
        # the paper's finding: keeping parked counts (plfu) beats in-memory lfu on Zipf traffic
        require(chr_of["plfu"] > chr_of["lfu"], f"plfu CHR {chr_of['plfu']} <= lfu CHR {chr_of['lfu']}")
        # the derived metrics against the plain version on the CPU, smallest case
        for label, future in references.items():
            card_row = grid[label][0]
            cpu = future.result()
            same = cpu == (card_row.mean_chr, card_row.std_chr, card_row.mean_evictions, card_row.mean_metadata,
                           card_row.mean_byte_chr)
            require(same, f"{label} {paper[0]}: card {card_row} != cpu {cpu}")
        print(f"[grid] launches={json.dumps(launches)} total={sum(launches.values())} plfu_gt_lfu=True "
              f"grid_mean_chr={json.dumps(chr_of)} cpu_reference_case={paper[0]} "
              f"cpu_reference_rows={len(references)} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
        phases.done("grid")

        # the small checks' plain runs, back from the CPU workers
        t0 = time.perf_counter()
        n_cpu = len(checks.pending)
        checks.finish()
        print(f"[check] cases={checks.count} (plain on the CPU: {n_cpu}) samples={SAMPLES} "
              f"base_T={json.dumps({n: t for n, _, t in BASE_CHECK_CASES})} max_abs_err={max(checks.worst.values())} "
              f"tolerance=exact wait_s={time.perf_counter() - t0:.3f}", flush=True)
        phases.done("small checks' CPU plain runs (wait)")

    # 5. scan: arc's scan resistance at benchmarks/scan_bench.py's full setting
    t0 = time.perf_counter()
    traces = {
        "scan": generators.scan(SCAN_N, SCAN_SAMPLES, SCAN_LEN, seed=SCAN_SEED, **SCAN_KW),
        "stationary": generators.stationary(SCAN_N, SCAN_SAMPLES, SCAN_LEN, seed=SCAN_SEED),
    }
    scan_chr = {}
    for kind, extra in SCAN_KINDS:
        chrs = {}
        for scenario, tr in traces.items():
            hits = kernel.cache_sim_cuda(torch.as_tensor(tr, device="cuda"), kind=kind, n_objects=SCAN_N,
                                         capacity=SCAN_CAP, **extra)["hits"]
            chrs[scenario] = int(hits.sum()) / tr.size
        scan_chr[kind] = chrs["scan"]
        print(f"[scan {kind}] options={json.dumps(extra)} chr={chrs['scan']} stationary_chr={chrs['stationary']} "
              f"scan_cost={chrs['stationary'] - chrs['scan']}", flush=True)
    require(scan_chr["arc"] > scan_chr["lru"] and scan_chr["arc"] > scan_chr["lfu"],
            f"arc does not beat lru and lfu on scan: {scan_chr}")
    print(f"[scan] N={SCAN_N} cap={SCAN_CAP} S={SCAN_SAMPLES} T={SCAN_LEN} seed={SCAN_SEED} "
          f"sweeps={json.dumps(SCAN_KW)} arc_gt_lru_and_lfu=True elapsed_s={time.perf_counter() - t0:.3f}",
          flush=True)
    phases.done("scan")

    # profile: the device's idle share between the launches of one grid row's largest cases
    profile_row(seed, card)
    phases.done("profile row")

    # 6. measure
    traces = torch.as_tensor(zipf.sample_traces(MEASURE_N, SAMPLES, MEASURE_LEN, seed=seed), device="cuda")
    short = traces[:, :PLAIN_MEASURE_LEN].contiguous()
    sizes = simulate.bytes_catalogue(MEASURE_N)
    entries, offs = [], {}
    for program, (kind, with_budget) in MEASURED.items():
        t0 = time.perf_counter()
        kw = dict(kind=kind, n_objects=MEASURE_N, capacity=MEASURE_CAP, **grid_options(kind))
        if with_budget:
            kw.update(sizes=sizes, capacity_bytes=simulate.bytes_budget(sizes, MEASURE_CAP))
        require(kernel.program_of(kind, kw.get("capacity_bytes", 0)) == program, f"{program} measures {kind}")
        spec = kernel.spec_of(**{k: v for k, v in kw.items() if k != "sizes"})
        tm = timing.measure(kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=5, warmup=1, **kw)
        got = kernel.cache_sim_cuda(traces, **kw)
        offs[program] = got
        want, plain_ms = cuda_ms(lambda: plain(short, **kw))
        err = max_abs_err(kernel.cache_sim_cuda(short, **kw), want)
        require(err == 0, f"kernel != plain version at the measured case of {program} (T={PLAIN_MEASURE_LEN})")
        b = bound(program, got, spec, card, sms, MEASURE_N if spec.size_aware else 0)
        kernel_ms = tm.execute_s * 1e3
        print(f"[measure {program}] kind={kind} N={MEASURE_N} cap={MEASURE_CAP} S={SAMPLES} T={MEASURE_LEN} "
              f"options={option_text(spec, 'lognormal' if spec.size_aware else None)}"
              f"{plan_text(spec, kw.get('sizes'))} "
              f"kernel_ms={kernel_ms} kernel_mean_ms={tm.mean_execute_s * 1e3} repeats={tm.repeats} "
              f"us_per_request={kernel_ms * 1e3 / MEASURE_LEN} "
              f"plain_ms={plain_ms} plain_T={PLAIN_MEASURE_LEN} {' '.join(f'{k}={v}' for k, v in b.items())} "
              f"(peak = {sms} SMs x {INT32_LANES_PER_SM} lanes x {card.max_sm_clock_mhz} MHz) "
              f"j_per_request={tm.j_per_step} max_abs_err={err} card={card.label!r} "
              f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
        entries.append({
            "name": program, "route": "cuda", "source": str(Path(SOURCE_DIR) / kernel.PROGRAMS[program].source.name),
            "replaces": REPLACES[program], "launches": launches[program],
            "max_abs_err": max(checks.worst[program], err), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "T": MEASURE_LEN, "plain_T": PLAIN_MEASURE_LEN,
        })

    phases.done("measure")

    # 7. telemetry: the telemetry path at the measured case, counted
    entries += run_telemetry(traces, offs, checks, card, sms, seed)
    del traces, short, offs
    phases.done("telemetry")

    # the fleet engines' phases in inference mode, as the plain runs: their steps are thousands of
    # small ops, each cheaper without autograd's bookkeeping (the outputs are the same)
    with torch.inference_mode():
        # 8. fleet: device traces, routers, the level-major fleet held to its oracle, the paper's CPU time
        keep = fleet_phase(seed, card)
        phases.done("fleet")

        # 9. placed and 10. hierarchy: the time-major placed engine and the two-tier hierarchy, held to
        # their oracles in the CPU workers
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx, initializer=_worker_init,
                                                    initargs=(CPU_WORKER_NICE,)) as pool:
            placed_phase(pool, seed, card, keep)
            phases.done("placed")
            hierarchy_phase(pool, seed, card)
            phases.done("hierarchy")

        # 10a. stream and 10b. shard: the streaming engine and the sharded runs, held to the fleet and
        # placed phases' bounded calls and oracle results
        stream_phase(keep, card)
        phases.done("stream")
        shard_phase(keep, card)
        phases.done("shard wrap-up")
        del keep

    # 11. flash check: the attention kernel against its plain version, f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = flash_checks(seed)
    phases.done("flash check")

    # 12. serve: smollm-360m at full width behind the content cache, every attention call on the kernel
    t0 = time.perf_counter()
    model = build(get_config(SERVE_ARCH), device="cuda").init(torch.Generator(device="cuda").manual_seed(seed))
    print(f"[serve] model built and initialised from seed {seed}: {model.n_params} parameters "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    by_instance, served = serve_path(model, seed, card)
    serving_energy_line(model, served, card)
    # 13. fleet front: the same model behind the serving fleet front
    fleet_front(model, seed, card)
    phases.done("serve and fleet front")

    # 14. serve check: the card against the plain path on the CPU, the same weights
    serve_check(model, seed)
    phases.done("serve check")

    # 15. measure: the kernel at the served shapes beside its bound, plain version and SDPA; the engine
    entries += flash_measure(seed, worst, by_instance, sms)
    serve_measure(model, seed, card)
    del model
    torch.cuda.empty_cache()
    phases.done("flash and serve measure")

    # 16. MoE/MLA serve: deepseek-v2-236b at its published widths, 4 of 60 layers, behind the content
    # cache, every MLA prefill on the kernel at D = 192; 17. its card-vs-CPU check on 2 layers
    t0 = time.perf_counter()
    model, moe_launches = moe_serve(seed, card)
    moe_check(model, seed)
    del model
    torch.cuda.empty_cache()
    t_moe = time.perf_counter() - t0
    entries += flash_measure(seed, worst, {MLA_FLASH_ENTRY: moe_launches[flash.INSTANCES[0]]}, sms,
                             shapes=((MLA_FLASH_ENTRY, flash.INSTANCES[0], MLA_FLASH_SHAPE),))
    print(f"[moe] serve + check elapsed_s={t_moe:.3f} with the MLA flash measure "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    phases.done("moe")

    # 18. SSM serve and 19. SSM check: rwkv6-7b (4 of 32 layers) and jamba-1.5-large-398b (5 of 72) at
    # their published widths behind the content cache, jamba's attention layer on the kernel at D = 128;
    # each held to the CPU (rwkv6's first 2 layers; jamba one layer at a time)
    t0 = time.perf_counter()
    ssm_launches = {}
    for arch in SSM_ARCHS:
        t1 = time.perf_counter()
        model, ssm_launches[arch] = ssm_serve(arch, seed, card)
        t2 = time.perf_counter()
        (rwkv_check if arch == "rwkv6-7b" else jamba_check)(model, seed)
        del model
        torch.cuda.empty_cache()
        print(f"[ssm] arch={arch} serve_s={t2 - t1:.3f} check_s={time.perf_counter() - t2:.3f}", flush=True)
    t_ssm = time.perf_counter() - t0
    jamba = ssm_launches["jamba-1.5-large-398b"]
    entries += flash_measure(seed, worst, {JAMBA_PREFILL_ENTRY: jamba[flash.INSTANCES[0]],
                                           JAMBA_DECODE_ENTRY: jamba[flash.INSTANCES[1]]}, sms, shapes=JAMBA_FLASH_SHAPES)
    print(f"[ssm] serve + check elapsed_s={t_ssm:.3f} with jamba's flash measure "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    phases.done("ssm")

    # 19a. whisper-large-v3 at full depth (32 + 32 layers): served through prefill and decode_step, every
    # attention call on the kernel (the encoder, cross-attention over the source), held to the CPU on
    # 2 + 2 layers; then the kernel at its shapes
    t0 = time.perf_counter()
    model, by_entry, reqs = whisper_serve(seed, card)
    whisper_check(model, reqs, seed)
    del model, reqs
    torch.cuda.empty_cache()
    entries += flash_measure(seed, worst, by_entry, sms, shapes=WHISPER_FLASH_SHAPES)
    print(f"[whisper] serve + check + flash measure elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    phases.done("19a whisper")

    # 19b. llava-next-mistral-7b at full depth (32 layers), its 1,152 prefix embeddings before the text;
    # held to the CPU on 2 layers; then the kernel at its shapes
    t0 = time.perf_counter()
    model, by_entry, reqs = llava_serve(seed, card)
    llava_check(model, reqs, seed)
    del model, reqs
    torch.cuda.empty_cache()
    entries += flash_measure(seed, worst, by_entry, sms, shapes=LLAVA_FLASH_SHAPES)
    print(f"[llava] serve + check + flash measure elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    phases.done("19b llava")

    # 19c. train: smollm-360m at full width and depth through make_train_step (no flash launch); the
    # Trainer's checkpoints and resume on 2 layers, restored onto the CPU bit for bit; the card's loss and
    # gradients held to the CPU's on those 2 layers; the launcher in process. What the earlier phases
    # left on the heap is frozen out of the collector's passes while it runs: a step's autograd graph
    # makes thousands of objects, and each collection would walk the frozen ones too
    t0 = time.perf_counter()
    gc.collect()
    gc.freeze()
    train_full(seed, card)
    torch.cuda.empty_cache()
    model, masters = train_resume(seed, card)
    train_check(model, masters, seed)
    del model, masters
    train_launch(card)
    gc.unfreeze()
    torch.cuda.empty_cache()
    print(f"[train] phase elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    phases.done("19c train")

    # 20. kernels
    print(f"[phases] {json.dumps(phases.seconds)}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"[total] host_cpu={host_cpu()!r} elapsed_s={time.perf_counter() - t_start:.3f}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
