#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no result line is
printed:

  1. device   the card's name, count, and ``nvidia-smi`` name/power limit;
  2. build    every CUDA source under ``src/repro_torch/csrc`` (one nvcc per
              source, all at once), with ptxas' register/smem/spill lines;
  3. kernels  each kernel at the main path's full-width shapes
              (bitnet-3b: d 3200, 32 heads of 100, ffn 8640, capacity
              1664), held against its plain PyTorch version on the same
              inputs, then timed with CUDA events (inputs rotated over
              >100 MB of copies so each launch finds L2 cold, as decode
              does), beside the plain version's time, the least time the
              card could take (bound) and, where one PyTorch call computes
              the same function, that call's time; #1 and #2 (on the
              ternary tile core) and #4 and #5 (on the split-lane decode
              core) also with their calls captured in one CUDA graph (the
              device's time without the host's), with their launch shapes
              and ptxas' registers / static smem / spills, and #2
              checked once more at f 14,336 on a narrow d (above the
              former k cap); for #3 also 12 chunks of 128 rows bitwise
              one whole 1536-row call, a sliding window of 512 against
              the plain version, and for #3
              and #8 (phase 5) the CTAs, warps per CTA, dynamic shared
              memory and ptxas' registers / static smem / spills; #1
              and #2 with the leading expert axis at granite-moe-1b-a400m's
              widths (E 32, d 1024, f 512) at the decode shape (C 8) and
              one 1536-token prompt's (C 480), empty capacity rows
              included (exact zeros), with launch shapes; #4 and #5 in
              the modes of the sequence-parallel path — pos_offset +
              return_stats on a 2048-slot cache cut into 2 and 4
              shards, each shard in turn (an empty shard, new_len inside
              a shard's first and last block; empty rows exactly m =
              −1e30, ℓ = 0, out 0), the shards' (out, m, ℓ) merged
              in-process against the plain merge — and #4's
              shared_select at granite's shapes (G 2, dh 64) beside
              per-head selection, with the K/V blocks each gathers;
              shared_select at G 1 bitwise per-head; #1 and #2 with the
              squared-relu epilogue;
  4. serve    full-width bitnet-3b with seeded random weights: 8 requests
              of 128–1536 prompt tokens (numpy default_rng(0)), 32 new
              tokens each, through the continuous-batching Scheduler on 4
              slots, greedy, LOP decode; launch counts are zeroed just
              before and read just after each path, and every kernel of
              the path must show launches; the Scheduler's tokens must
              equal lockstep_generate's for 2 requests, and chunked prefill
              must equal whole-prompt prefill bitwise for one prompt; then
              clean timings: a decode step over 4 active lanes with no
              prefill in flight, one prefill chunk, a whole-prompt prefill,
              and a torch.profiler breakdown of decode steps and of one
              chunk; every serve run prints a sha256 of its tokens. Every
              serve run decodes through the engine's CUDA graphs (one
              replay a step, launch counts counted per replay); the clean
              decode step is timed and profiled on the graphs and on an
              eager twin engine sharing the weights, whose tokens must
              equal the graphs' and whose launch counts must equal 52 /
              26 / 26 of #1 / #2 / the decode kernel a step on both; the
              graphs held and the device memory they reserved are
              printed, and over the fresh caches of the lockstep checks
              the graphs' private memory pools must grow by exactly what
              the graphs held grew (an evicted graph gives its memory
              back) with at most GRAPH_BOUND keys left; the same traffic
              once more with the prefix cache off (tokens bitwise the
              cache-on run's: what interning costs);
  4b. no-LOP  the same 8 requests on a use_lop=False engine sharing the
              weights: the dense decode kernel must launch and the LOP one
              must not; scheduler == lockstep for 2 requests; its steady
              decode step (graph and eager) beside the LOP engine's, and a
              torch.profiler breakdown of its decode steps;
  4c. sampled (4c, 4d and 4g's chaos trace on phase 4's weights cut to
      + faults their first 4 of 26 layers, for the run's time) the 8
              requests sampled (T 0.8, top-k 50, top-p 0.95, seed =
              rid) on the LOP engine, scheduler == sampled lockstep for 2
              requests and the steady sampled decode step (graph and
              eager); then on the
              no-LOP engine 4 requests clean and under transient NaN
              logits (every fault recovered, every stream bitwise the
              clean one), a sticky NaN lane (reason "fault"), a 1 us
              deadline and a mid-decode cancellation; and the LOP engine
              under NaN logits, recovering through the dense retry (at
              least 3 retries on one pool, so the retry's graph is
              captured and replayed);
  4d. prefix  8 requests (numpy default_rng(1)) of one shared 1024-token
      + spec  prefix and a unique 64–512-token suffix, 32 new tokens,
              greedy, LOP, with the prefix cache on and off (tokens
              bitwise; the first sweep's 4 requests miss, the next 4 hit
              1024 tokens; hits, prefill tokens computed against served,
              TTFT, tokens/s, the store's bytes and the time of one match
              and one intern), then on under a flipped page bit and a
              store outage (each detected, tokens unchanged); then 2 of
              phase 4's requests speculatively (γ 4, the draft 6 of 13
              layers at k_keep 1, no watchdog): no-LOP greedy and sampled
              against plain decode of the same requests (equal, or a
              first divergence where the decode and chunk kernels round
              apart: that lane's pages in the two runs bitwise over the
              prompt and at layer 0, the speculative pages bitwise what
              one prefill chunk of the same tokens writes, the rows
              recomputed from each run's pages making its choice, the
              plain choice's margin below the change of the two tokens'
              gap; the pages' differences printed by layer), LOP
              greedy completing with #4 in its draft; launch counts
              zeroed before each run: #3 launches for every chunk and
              verify, the draft entry replays its CUDA graph; rounds,
              acceptance, the draft step's and the verify chunk's wall
              time and tokens/s against plain;
  4g. http   the port's HTTP front-end (``serving/frontend``) on phase 4's
      + chaos warm engine: phase 4's 8 requests (rids 0–3 greedy, 4–7
              sampled as in 4c) straight through a Scheduler, then as 8
              concurrent SSE streams from stdlib sockets through
              ``serve_threaded`` on a fresh Scheduler with its own
              registry: every stream bitwise the direct run, a unary
              body's tokens and usage, a 504 on an expired deadline
              (streamed and unary), 400 on invalid bodies with nothing
              submitted, and a /metrics scrape whose token, outcome,
              prefill-token and per-route/code HTTP counters equal what
              the clients saw; each engine histogram's count and p50
              beside this run's own timing of the same work; HTTP TTFT
              p50, tokens/s and peak memory beside the direct run's;
              then a 1-slot server with max_queue 1: a 429 with
              Retry-After while a stream holds the lane and one waits,
              and the holder's disconnect cancelling its lane, which the
              waiter takes and streams bitwise; an exception on the pump
              thread or a client timeout fails the phase. Then the
              200-request chaos trace of tests/test_faults.py (seeded
              FaultPlan.random(31, ...), max_queue 150, 4 slots, the
              virtual clock, check_invariants) twice on the 4-layer
              no-LOP engine, with a 1024-token shared prefix in place of 32
              tokens (so the store interns 8 blocks and the plan's flip
              of the 8th fires): every request terminal, 50 shed, >= 1
              deadline and cancelled, >= 100 length, fault events,
              recoveries and injected NaNs >= 1, the two runs bitwise
              alike, the first 8 length-finished streams == lockstep;
  4e. moe    full-width granite-moe-1b-a400m (6 of its 24 layers, a cut
              for the run's time; d 1024, 16 heads of 64 over 8 KV
              heads, 32 experts top-8, d_ff 512) with
              seeded random weights, served run-to-completion (each prompt
              prefilled whole at its exact length, batch 1): phase 4's 8
              requests greedy with LOP, on a no-LOP engine sharing the
              weights, and sampled (T 0.8, top-k 50, top-p 0.95); each
              run's launch counts (#2 only in its grouped-expert form),
              scheduler == lockstep for 2 requests; after the greedy run
              #1 (E 1), #3 (exact-length prompts of 1536 and 1023 tokens
              over their 128-block roundup), #4 and #5 at granite's
              shapes (G 2, dh 64) on a layer's served weights and pooled
              K/V, held against their plain versions (#1 bitwise, f32 at
              rtol = atol = 2e-5); tokens/s, TTFT, the
              exact-length prefills and the stalls they caused, peak
              memory, and the clean decode step on CUDA graphs and eager
              (tokens equal; 24 / 12 / 12 launches of #1 / #2 with E 32 /
              the decode kernel a step); one exact-length prefill's time
              at 128, 512, 1024 and 1536 tokens; then a greedy LOP arm
              with gqa_shared_select=True (one candidate set a kv head)
              on the same weights, through the same checks, its tokens/s
              and step ms beside the per-head arm's;
  4h. families stablelm-1.6b (LayerNorm) at full width and 6 of its 24
              layers (the run's time; d 2048, 32 heads of 64, f 5632)
              and qwen1.5-32b (QKV
              bias, drawn nonzero from a seeded generator before
              quantization) at full width and 8 of its 64 layers (the
              run's time; d 5120, 40 heads of 128, f 27,392, vocab
              152,064; its served tree, pool and draw peak printed;
              phase 4p holds the bias at full depth): phase 4's 8 requests
              greedy LOP,
              chunked, through the Scheduler on 4 slots, scheduler ==
              lockstep for 2 requests, the clean decode step on graphs
              and eager with its launches (#1 / #2 / decode kernel 24 /
              12 / 12 and 16 / 8 / 8 a step), #1 at qwen's QKV shape with
              its bias bitwise its plain version on layer 0's served
              weights, half of qwen's #1 launches carrying the bias; then
              whisper-small (encoder-decoder) at full width and depth (12
              + 12 layers, d 768, 12 heads of 64, f 3072 ungated gelu,
              vocab 51,865): 8 requests (default_rng(2)) of 1500 frames
              and a 4–64-token prompt, 32 new tokens, max_len 448, run to
              completion with exact-length prefill (#1 84 / #2 24 / #3 36
              launches a prefill, the encoder's and cross prefill's #3
              non-causal), greedy LOP, on a no-LOP engine sharing the
              weights, and LOP with one transient NaN lane recovered
              through the retry (its stream bitwise the clean one);
              scheduler == lockstep for 2 requests in each arm; a decode
              step 48 / 12 / 24 (self + cross, half of the decode
              kernel's launches over the cross pages); after the greedy
              run #3 at the encoder's shape (C = M = 1500) and the cross
              prefill's (C 64 over M 1536, kv_len 1500) and #4 and #5
              over the pool's cross pages (no write, the pages untouched)
              against their plain versions (rtol = atol = 2e-5) and
              timed beside their bounds; the decode step on graphs and
              eager, one exact-length prefill's time, tokens/s, TTFT and
              peak memory; each arm's engine freed before the next;
  4i. recurrent rwkv6-1.6b (ssm) at full width (d 2048, 32 heads of 64,
              f 7168, vocab 65,536) and 3 of its 24 layers (phase 4l
              serves it at full depth) with seeded weights drawn on the
              card: phase 4's 8 requests greedy, then
              sampled (T 0.8, top-k 50, top-p 0.95, seed = rid), run to
              completion with exact-length prefill (the wkv recurrence a
              time loop of plain tensor ops); 30 #1 launches a decode
              step and no other kernel of the table; scheduler ==
              lockstep for 2 requests an arm; the decode step on CUDA
              graphs and on an eager twin (tokens equal) with a profiler
              split of #1 against the glue and the device's busy share;
              #1 at w_lora_a / w_lora_b / wk_c / wv_c on layer 0's served
              weights at m 4 and 1536 bitwise its plain version, timed
              eagerly and in a graph beside its bound; one exact-length
              prefill at 128, 512, 1024 and 1536 tokens; the peak while
              drawing; then jamba-1.5-large-398b reduced (hybrid: per
              superblock Mamba, Mamba + MoE, attention, Mamba + MoE): 8
              requests of 8–96 tokens (default_rng(3)), 16 new, greedy
              LOP, no-LOP and sampled, a prefill's and a decode step's
              launches (#1 22, #2 4 dense and 4 expert, the decode kernel
              2 a step; #3 one a superblock a prefill), scheduler ==
              lockstep, graph == eager (a launch and parity check of
              the hybrid path at d 128, not its performance); then
              jamba at full width and one superblock of its 9 (7 Mamba
              sublayers: d 8192, Di 16384, dt_rank 512; 1 attention: 64
              heads of 128 over 8; 4 dense FFNs and 4 MoEs of 16
              experts top-2, f 24,576), drawn and quantized on the card
              a sublayer at a time through PooledEngine.from_seed (the
              draw peak printed, below the card's memory): 4 requests of
              64–256 tokens (default_rng(9)), 16 new, greedy LOP and
              no-LOP, a prefill's launches, scheduler == lockstep, graph
              == eager (#1 30, #2 4 dense and 4 expert, the decode
              kernel 1 a step), #2 with E 16 at the decode C and the
              longest prompt's against its plain version (a few experts
              a call) with times and bound; on its first Mamba and its
              attention sublayer: #1 at in_proj, x_proj,
              dt_proj + bias, out_proj, wqkv and wo at m 4 and 1536
              bitwise its plain version and timed beside its bound; the
              Mamba prefill (4 #1 launches) at 128, 512 and 1536 tokens
              and its decode step, eager and in a graph; the Mamba
              sublayer card against CPU stage by stage (2e-5, the
              barrier in front of out_proj bitwise but for 1-ulp
              knife-edges); the attention sublayer's 512-token prefill
              and decode step with #3, #4 and #5 against their plain
              versions; each arm's engine freed before the next (the
              whole full-width model is more than one card holds,
              even packed);
  4o. mixtral mixtral-8x22b at full width and depth (56 layers, d 6144,
              48 heads of 128 over 8, 8 experts top-2 of f 16,384,
              swa_window 4096, moe_group 2048), run after phase 5 with
              the earlier engines freed, drawn and quantized on the card
              a layer at a time: 4 requests of 128–1536 tokens and 2 past
              the window (4200, 4700; default_rng(8)), 32 new, 4 slots,
              capacity 4736, run to completion (each prompt one
              exact-length prefill, no chunk) greedy LOP, then the 2
              long requests on a no-LOP engine sharing the weights;
              launches, scheduler == lockstep (the first and the longest
              request), graph == eager (112 / 56 / 56 launches of #1 /
              #2 (E 8) / the decode kernel a step); #2 at the decode C 4
              and a full group's C 640 on a layer's served experts, #4
              and #5 at G 6 on the served pages with lanes past the
              window, #3 over the longest prompt whole with the window,
              each against its plain version with times and bound;
              tokens/s, TTFT, the step ms and one exact-length prefill
              of the longest prompt;
  4p. qwen   qwen1.5-110b at full width and depth (80 layers, d 8192, 64
              heads of 128 over 8: G 8, f 49,152, vocab 152,064, QKV
              bias drawn nonzero), after 4o with mixtral freed, drawn
              and quantized on the card a layer at a time (served tree,
              pool and draw peak printed): phase 4's first 4 requests
              greedy LOP, chunked, through the Scheduler on 4 slots,
              scheduler == lockstep for the shortest, half of #1's
              launches with the bias; #1 QKV + bias (m 4, k 8192, n
              10,240) and O, #2 at d 8192, f 49,152 (m 4 and 128), #3
              causal over a 1536-token prompt whole and #4 / #5 at G 8
              (B 4, M 1664) on layer 0's served weights and pages, each
              against its plain version, timed eagerly (and #1, #2, #4,
              #5 in a CUDA graph) beside its bound, #3 and #5 beside
              SDPA on the dequantized pages; the 2 shortest requests
              no-LOP (#5 on the served path); the clean decode step on
              graphs and eager (160 / 80 / 80 launches a step) over the
              4 prompts cut to 384 tokens;
  9. examples the port's examples in this process: torch_quickstart
              (bitnet-3b reduced, keep 0.25; its pipeline also on
              CPU-drawn weights card against CPU), torch_serve_lop
              (mistral-nemo-12b reduced: the keep ablation, both
              scheduler demos equal to their lockstep replays) at their
              defaults, torch_train_bitnet (bitnet-100m, 60 steps of 8 x
              256, a checkpoint every 20, preempted after 40 and resumed
              to 60, the loss falling, no kernel launched);
  4j. vlm   the streamed draw, then two models that only it fits on the
      + draw card, each drawn and quantized one layer at a time
              (init_serving_params): bitnet-3b at full width and depth
              drawn both ways (the whole f32 master tree, then
              quantize_params; and layer by layer), every served leaf
              bitwise, both peaks printed; llava-next-34b (vlm) at full
              width (d 7168, 56 heads of 128 over 8, f 20,480, vocab
              64,000, 2,880 image rows), drawn at full depth (60 layers,
              the draw's peak under 30 GiB) and served at its first 6
              (a cut for the run's time): 8 requests (default_rng(4)) of 2,880
              patch rows of 0.02·N(0, 1) and 64–512 text tokens, 32 new,
              4 slots, chunked (the image rides the first chunk:
              2,880 + 128 rows at start 0), greedy LOP and no-LOP, each
              scheduler == lockstep for 2 requests and its decode step
              on CUDA graphs and eager (24 / 12 / 12 launches of #1 /
              #2 / the decode kernel a step); one request's chunks
              timed and bitwise its whole-prompt prefill; #3 causal at
              the first chunk's shape (R = 7 x 3,008 rows a kv lane)
              and a text chunk past it, #4 and #5 at G 7 on the served
              pages, against their plain versions and timed beside
              their bounds; 4 sampled requests with one NaN lane
              recovered through the retry (a clean lane == its
              lockstep); the prefix store (image requests never match
              or intern; text-only requests sharing 1,024 tokens hit);
              2 requests speculatively (γ 4, the draft 3 of 6 layers)
              against plain no-LOP decode, equal or a near-tie of
              rounding; then mistral-nemo-12b (d 5120, q_dim 4096) at
              full width and 6 of its 40 layers: phase 4's 8 requests
              greedy LOP, scheduler == lockstep, the decode step graph
              and eager, #1 at its O projection (k 4096 → n 5120)
              bitwise its plain version; each arm freed before the
              next;
  5. standalone kernels and the per-head LOP decode, at full width:
              the TINT GEMM (ternary_matmul), the LOP screen
              (lop_scores_kernel), single-head flash prefill and block-sparse
              decode, each held against its plain version (integers
              bitwise, f32 at rtol = atol = 1e-4) and timed as in phase 3
              beside one PyTorch call for the same function; #7, #6 and
              #9 also with their calls captured in one CUDA graph (the
              device's time without the host's enqueue time), their launch
              shapes (CTAs, warps, dynamic smem; #7's k split, #9's
              cluster), ptxas' registers / static smem / spills and their
              shares of bound; #7 bitwise once more at k 27,392 x n 5,120
              (above the former k cap), #9 once more with the TPU kernel's
              masked cases (a gated empty interval, an all-masked lane, an
              ungated lane); then the paths
              a user of the kernel API runs, each with the launch counts
              zeroed before and read after: the TINT chain
              (ternary_matmul(quantize(x)) · x_scale · γ, bitwise
              qlinear_fused at the QKV and O shapes, m = 4 and 128), one
              1536-token flash prefill, and the paper's per-head
              predictive-sparse decode (lop_screen over every (batch,
              kv-head) lane → select_blocks → sparse_decode over every
              lane; 2 launches) against the fused LOP decode kernel (1
              launch) on the K/V of one layer of the serve engine's cache;
  4k. train  (after phase 5, the earlier engines freed) the QAT training
              path: (a) full-width bitnet-3b (26 layers, d 3200) with f32
              masters drawn on the card, 8 make_train_step steps of batch
              4 x 512 (bf16 activations, per-layer remat, peak lr 1e-4
              after 1 warmup step; SyntheticDataset seed 0), each step's
              loss, grad norm, lr and synchronized ms, the peak device
              memory; gates: finite, the mean loss of steps 7-8 below that
              of steps 1-2, no kernel of the table launched while
              training; (b) reduced bitnet (2 layers, vocab 256) through
              train_loop for 60 steps (batch 8 x 32, lr 3e-3), last-5 mean
              below first-5 mean - 0.3; at f32, the same loop on the
              card and on the CPU from the same masters: step 1's loss
              within 1e-4 and its pre-clip grad norm within 1e-4 of
              itself, its forward's first int8 parting a knife-edge, steps
              2-5 printed; a run preempted at step 30 (checkpointed) and
              resumed, its losses bitwise the uninterrupted run's; (c)
              (a)'s trained masters quantized on the card and served:
              phase 4's first 4 requests greedy LOP through the Scheduler,
              scheduler == lockstep for 2 requests, #1-#4 launched, the
              tokens' sha256; #1 at layer 0's QKV and #2 at its FFN on the
              trained served weights bitwise their plain versions, timed
              beside their bounds;
  4l. train  the recurrent families' training: (a) full-width rwkv6-1.6b
      recurrent (24 layers, d 2048) with f32 masters drawn on the card,
              2 make_train_step steps of batch 4 x 256 (bf16 activations,
              layer and chunk remat, peak lr 3e-5 after 1 warmup step),
              each step's loss, grad norm and synchronized ms, the peak;
              gates as 4k (a) (the last step's loss the run's lowest);
              (d) (a)'s trained masters quantized and
              served at full width and depth: phase 4's first 4 requests
              greedy, 240 #1 launches a decode step, scheduler ==
              lockstep for rid 0, the graph decode step, #1 at the
              trained layer 0's wk_c bitwise its plain version; (b)
              reduced rwkv6 and reduced jamba at f32 from the same
              masters, step 1 card against CPU: on the card's own
              forward the first int8 parting a knife-edge; with the
              CPU's int8 activations and ternary weights (each QAT
              BitLinear's input and ternary weight replaced by the CPU's
              in value, the partings knife-edges) the loss within 1e-4
              and the pre-clip grad norm within 1e-4 of itself; then 12
              steps on the card whose last-5 mean loss falls below the
              first-5; (c) one full-width jamba Mamba sublayer (d 8192,
              Di 16,384) trained forward and backward at 1 x 512 tokens
              (8 remat'd chunks), timed with its peak, its f32 gradients
              at T 16 card (on the CPU's int8 activations and ternary
              weights) against CPU within 1e-4 (the int8 gradient
              compression runs in 4m's spawn, as its (f));
  4f. sp     (run last, the earlier engines freed) the reference's
              production decode path: full-width bitnet-3b at 8 of its
              26 layers (the run's time) drawn from the
              seeded generator, phase 4's first 4 prompts prefilled
              replicated into a 2048-slot pool, 8 greedy eager
              serve_step(sp_axes=("model",)) steps, LOP, LOP with f-axis
              TP of the FFN (use_ffn_tp) and dense; once on a
              single-process mesh holding both token shards, then in 2
              processes joined in a gloo group on cuda:0 (spawned after
              every kernel is built), each holding its shard. Gates: (a)
              each rank's tokens and cache shard (sha256 of every leaf
              and layer) bitwise the single-process run, #1 / #2 / the
              decode kernel 26 / 13 / 13 launches a rank a step; (b) at
              lop_keep 1 the SP attention on one layer of the pooled K/V
              within 1e-3 (err/ref) of the local dense decode; (c) each
              rank's #4 (out, m, ℓ) at the quota on its own shard
              against its plain version; eager step ms and tokens/s by
              rank, and where the SP tokens first part from single-card
              decode (token index, top-2 margins).

  4n. chunk  (after phase 4, on its engine's weights) the prefill chunk
      widths width: 4 requests (phase 4's rids 0 and 1; rids 2 and 3 as
              their first 256 tokens behind one shared 1024-token
              prefix), 3 slots, greedy LOP, prefix cache on, at chunk
              widths 128 (phase 4's engine), 48 and 256 (engines
              sharing the weights): tokens at 48 and 256 equal the 128
              run's; #3 26 launches a chunk; the second sharer's hit
              resumes at 1024, a block multiple, and chunks from there;
              scheduler == lockstep for it; TTFT p50 and one chunk's ms
              by width;
  6. tune    (after 4n, on phase 4's weights) the tile autotuner
              (``kernels/autotune.py``) at full width: (a) 4 of phase 4's
              requests through a fresh engine with ``shape_log=`` a
              temporary file, whose shapes must be exactly the main
              path's (QKV, O and FFN at m 4 and 128, the 128-row prefill
              chunk over 1664 slots, the B = 4 decode step); (b)
              ``run_sweep`` over ``merged_shapes`` of that log into a
              temporary table, at most 6 candidates a shape, each
              checked bitwise against the default launch and timed in a
              CUDA graph with L2 cold; the default's and the winner's ms
              and the winner's knobs a line per shape; (c) the requests
              through a fresh engine reading that table: tokens and launch
              counts equal (a)'s; nothing written at the repository root;
  7. sched   ``core/schedule.py`` at bitnet-3b's attention width (x [1,
              1024, 3200], 32 heads of 100, f32, causal): the streamed
              schedule at groups 1, 4, 8 and 32 within rtol = atol = 1e-4
              of the materialized one, each with its ms and the peak
              memory it allocated above its inputs;
  8. dryrun  (after 7, on phase 4's engine) the meta-device dry-run
              (``launch/dryrun.py``): kernel_cost at each phase-3 shape
              of #1–#5 exactly the bytes and operations phase 3's bound
              used; (a) ``run_cell`` at full width on pod16x16 (in a
              process of its own, started after the build, tracing
              beside phases 3–7) for
              bitnet-3b train_4k / prefill_32k / decode_32k,
              mixtral-8x22b decode_32k and rwkv6-1.6b long_500k (each
              must end ``ok``; status, fits, peak, dominant term, trace
              seconds); (b) one decode step of phase 4's weights (4
              slots, capacity 1664, LOP and no-LOP) traced on meta and
              run eagerly on a fresh pool: the predicted launches by
              kernel equal the counted ones (52 #1, 26 #2, 26 #4 or #5),
              the predicted argument bytes equal the served tree's, the
              pool's and the tokens' nbytes, the predicted peak within
              10 % of ``max_memory_allocated`` from a reset (less what
              was allocated besides the arguments); (c), inside 4k,
              4k (a)'s training step traced on meta: no kernel record,
              the predicted peak within 10 % of 4k (a)'s;
  4m. dist   (last) the distributed modules over gloo ranks on cuda:0:
              (a), (b), (c), (e) and (f) in one spawn of 4 ranks, one
              after the other, then (d) in a fresh spawn of 3, this
              process's single-process runs made while the ranks start;
              each spawn's seconds split by the ranks' stamps (start,
              first CUDA call, each sub-arm, exit): (a)
              ``ep_moe_apply`` on granite-moe-1b-a400m's layer at full
              width (bf16 mode, capacity factor 8), x [4, 512, 1024] on
              (data 2, model 2), every rank returning the whole batch's
              rows: within 2e-3 of ``moe_apply`` at moe_group 1024, the
              ranks bitwise the card's single-process mesh; (b)
              ``ring_reduce_matmul`` and ``allgather_matmul`` at bitnet-3b's O shape (k 3200 cut 4
              ways, n 3200, 64 rows) over 4 ranks within 1e-4 of
              ``psum(x_loc @ w_loc)`` and X @ W_loc, timed beside one
              plain all_reduce; (c) the sharded training step of
              stablelm-1.6b at full width, 1 layer, f32, batch 8 x 128
              on (data 2, model 2), lr 1e-4 at step 1: loss and grad
              norm within rtol 1e-4 of the single-process step, each
              leaf's update and both moments held to its by the step
              check of ``tests/torch_step_check.py`` (each rank checks
              its shards against the single-process step saved to
              disk), which fails on the same step with the update
              flipped (one of the check's three planted faults: the
              run's time; the CPU tests plant all three); each rank holding a
              quarter of every leaf cut on both axes; the state
              gathered and checkpointed; (d) the elastic restart: 3
              survivors, plan (1, 2), the spare sits out, one more step
              from the checkpoint held by the same check to the
              single-process step from it; (e)
              ``serve_step(sp_axes=("model",))`` of reduced jamba and
              rwkv6-1.6b at full width and 3 layers over 2 ranks, LOP
              and dense: greedy tokens equal the unsharded engine's;
              (f) one data-parallel step of reduced rwkv6 (batch 8 x 32)
              with the int8 gradient compression (CompressedMean) over
              2 ranks: both ranks' masters bitwise each other and a
              single-process mesh's step, the error feedback's running
              mean converging, one compressed all-reduce of a 2048 x
              7168 gradient timed beside the plain f32 one.

The line before the last two is the ``kernels`` JSON (eleven entries:
the nine TPU kernels, and #1 and #2 once more in their expert form; #1,
#2, #3 and the two decode entries also list the modes they ran — #1
``bias``, #2 ``ungated``, #3 ``non_causal``, #4/#5 ``per_head``,
``shared_select``, ``pos_offset+return_stats`` and ``cross`` — each with
its launches on the path that runs it and the numbers of the phase that
checked it; the launches of #1–#5 also count phase 4i's and 4j's serve
runs, phase 4k's and 4l's serve runs, phase 4n's and phase 6's, and the
``pos_offset+return_stats`` modes phase 4m (e)'s rank 0; #1, #3, #4 and #5 list phase
4j's checks under ``shapes``, #1 and #2 phase 4k's on trained weights,
#1 phase 4l's), each phase's seconds printed before it; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_STANDALONE = dict(rtol=1e-4, atol=1e-4)   # the reference's kernel tests

SEED = 0
N_SLOTS, N_REQUESTS, GEN = 4, 8, 32
MIN_PROMPT, MAX_PROMPT = 128, 1536


def log(msg: str) -> None:
    print(msg, flush=True)


def tests_module(name: str):
    """A JAX-free helper module of ``tests/`` that the card tests share
    (``torch_knife_edges``, ``torch_dp_rank``), imported by its own name
    as pytest imports it (another ``tests`` package may be installed)."""
    import importlib

    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    return importlib.import_module(name)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean ms per call of ``fn(*args)`` over ``iters`` calls, cycling
    through ``arg_sets`` (copies of the inputs) so L2 starts cold."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, arg_sets, per_graph: int = 20, replays: int = 5) -> float:
    """Mean ms per call of ``fn(*args)`` with the calls captured in one CUDA
    graph (cycling through ``arg_sets``, L2 cold): the device's time for
    the launches, without the host's time to enqueue them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def copies(torch, args, min_bytes: float = 100e6, cap: int = 16) -> list:
    """Enough copies of ``args`` that cycling through them exceeds L2."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(2, min(cap, math.ceil(min_bytes / max(nbytes, 1)) + 1))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def bound_ms(nbytes: float, int8_ops: float = 0.0,
             f32_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or the
    operations over their peak rates (``repro_torch.analysis.roofline``'s
    data-sheet figures), whichever is larger, and which it was."""
    from repro_torch.analysis.roofline import (HBM_BW, PEAK_FLOPS_F32,
                                               PEAK_OPS_INT8)
    t_bytes = nbytes / HBM_BW
    t_ops = int8_ops / PEAK_OPS_INT8 + f32_ops / PEAK_FLOPS_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fmt_shape(shape: dict) -> str:
    """One launch of a kernel on the ternary tile core."""
    return (f"{shape['ctas']} CTAs x {shape['warps']} warps ({shape['tiles']} "
            f"tiles, k split {shape['split']}), {shape['smem']} B dynamic "
            f"smem")


def fmt_decode_shape(shape: dict) -> str:
    """One launch of a decode kernel on the split-lane core."""
    return (f"{shape['ctas']} CTAs x {shape['warps']} warps ({shape['split']}"
            f" a lane, one cluster; {shape['share']} blocks a CTA), "
            f"{shape['smem']} B dynamic smem; the card holds "
            f"{shape['resident_clusters']} such clusters at once, "
            f"{shape['ctas_per_sm']} CTAs an SM")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return nbytes(tree)


def ptxas_summary(build, source: str, kernel: str) -> str:
    """Registers, static shared memory and spills of one kernel, from the
    ptxas log nvcc wrote beside the library."""
    found, stats = False, {}
    for line in build.ptxas_report(source).splitlines():
        if "Compiling entry" in line:
            found = kernel in line
        elif found:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                hit = re.search(pat, line)
                if hit:
                    stats[key] = int(hit.group(1))
    if "registers" not in stats:
        raise AssertionError(f"no ptxas report for {kernel} in {source}")
    return (f"ptxas: {stats['registers']} registers, {stats.get('smem', 0)} B "
            f"static smem, spills {stats.get('spill_stores', 0)} B stored / "
            f"{stats.get('spill_loads', 0)} B loaded")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def check_close(torch, name, got, want, bitwise=False, tol=TOL) -> float:
    torch.cuda.synchronize()
    if got.is_floating_point() and not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (float((got.double() - want.double()).abs().max())
           if got.numel() else 0.0)
    if bitwise:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name}: not bitwise the plain version "
                                 f"(max |err| {err})")
    else:
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{name}: {m}")
    return err


def kernel_phase(torch, np) -> dict:
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.decode_attention import (
        fused_decode_attention, fused_dense_decode_attention)
    from repro_torch.kernels.decode_attention import \
        launch_shape as decode_launch_shape
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefill_attention import fused_prefill_attention
    from repro_torch.kernels.prefill_attention import \
        launch_shape as prefill_launch_shape
    from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear
    from repro_torch.kernels.qlinear import \
        launch_shape as qlinear_launch_shape

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    d, f, h, dh, m_cap, blk = 3200, 8640, 32, 100, 1664, 128
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- #1 fused_qlinear: QKV and O at decode (m = 4) and chunk (128) ----
    log("  qlinear.cu: " + "; ".join(
        f"{kern} {ptxas_summary(_build, 'qlinear', kern)}"
        for kern in ("barrier_kernel", "qlinear_decode_kernel",
                     "qlinear_chunk_kernel", "gate_up_decode_kernel",
                     "gate_up_chunk_kernel")))
    err, timed = 0.0, None
    for label, m, k, n in (("qkv", 4, d, 3 * d), ("o", 4, d, d),
                           ("qkv", 128, d, 3 * d), ("o", 128, d, d)):
        x = t(rng.standard_normal((m, k)).astype(np.float32))
        packed = t(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
        gamma = t(rng.uniform(0.01, 0.05, (n,)).astype(np.float32))
        got = fused_qlinear(x, packed, gamma)
        want = plain.qlinear_ref(x, packed, gamma[None])
        err = max(err, check_close(torch, f"fused_qlinear[{label},m={m}]",
                                   got, want, bitwise=True))
        args = (x, packed, gamma)
        arg_sets = copies(torch, args)
        ms = cuda_ms(torch, fused_qlinear, arg_sets, 50)
        g_ms = graph_ms(torch, fused_qlinear, arg_sets)
        p_ms = cuda_ms(torch, lambda a, b, c: plain.qlinear_ref(a, b, c[None]),
                       [args], 3)
        b_ms, b_by = bounded("fused_qlinear", dict(m=m, k=k, n=n),
                             nbytes(x, packed, gamma) + m * n * 4,
                             int8_ops=2.0 * m * k * n)
        log(f"  fused_qlinear {label} m={m} k={k} n={n}: {ms:.4f} ms, in a "
            f"CUDA graph {g_ms:.4f} ms (plain {p_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of bound, "
            f"{b_ms / g_ms:.1%} in the graph) bitwise=True; GEMM "
            f"{fmt_shape(qlinear_launch_shape(m, k, n))}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"{label} m={m} k={k} n={n}")
    rows["fused_qlinear"] = dict(timed, max_abs_err=err, library_ms=None)

    # ---- #2 fused_ffn at decode (m = 4) and chunk (128); then once at
    #      f 14,336 (mistral-nemo, above the former k cap) on a narrow d ----
    err, timed = 0.0, None
    for m, dd, ff in ((4, d, f), (128, d, f), (4, 256, 14336),
                      (128, 256, 14336)):
        x = t(rng.standard_normal((m, dd)).astype(np.float32))
        gu = t(rng.integers(0, 256, (dd // 4, 2 * ff)).astype(np.uint8))
        gs = t(rng.uniform(0.01, 0.05, (2 * ff,)).astype(np.float32))
        down = t(rng.integers(0, 256, (ff // 4, dd)).astype(np.uint8))
        ds = t(np.full((dd,), 0.02, np.float32))
        args = (x, gu, gs, down, ds)

        def kern(*a):
            return fused_ffn(*a, gated=True, act="silu")

        def ref(x_, gu_, gs_, down_, ds_):
            return plain.ffn_fused_ref(x_, gu_, gs_[None], down_, ds_[None],
                                       gated=True, act="silu")
        got, want = kern(*args), ref(*args)
        err = max(err, check_close(torch, f"fused_ffn[m={m},d={dd},f={ff}]",
                                   got, want))
        if ff != f:
            log(f"  fused_ffn m={m} d={dd} f={ff}: within rtol=atol="
                f"{TOL['rtol']} of the plain version, bitwise="
                f"{bool(torch.equal(got, want))} (check only)")
            continue
        arg_sets = copies(torch, args)
        ms = cuda_ms(torch, kern, arg_sets, 30)
        g_ms = graph_ms(torch, kern, arg_sets)
        p_ms = cuda_ms(torch, ref, [args], 3)
        b_ms, b_by = bounded("fused_ffn", dict(m=m, k=d, f=f, n=d),
                             nbytes(*args) + m * d * 4,
                             int8_ops=2.0 * m * d * 2 * f + 2.0 * m * f * d)
        log(f"  fused_ffn m={m} d={d} f={f}: {ms:.4f} ms, in a CUDA graph "
            f"{g_ms:.4f} ms (plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}; {b_ms / ms:.1%} of bound, {b_ms / g_ms:.1%} in the "
            f"graph) bitwise={bool(torch.equal(got, want))}; gate‖up GEMM "
            f"{fmt_shape(qlinear_launch_shape(m, d, f, gated=True))}, down "
            f"GEMM {fmt_shape(qlinear_launch_shape(m, f, d))}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"m={m} d={d} f={f}")
    rows["fused_ffn"] = dict(timed, max_abs_err=err, library_ms=None)
    rows.update(expert_kernels(torch, np, rng, t))

    # ---- #3 fused_prefill_attention: last chunk of a 1536-token prompt,
    #      and the whole prompt, over the 1664-token capacity ----
    err, timed = 0.0, None
    s_total, c = 1536, 128
    k_c = t(rng.integers(-127, 128, (h, m_cap, dh)).astype(np.int8))
    v_c = t(rng.integers(-127, 128, (h, m_cap, dh)).astype(np.int8))
    ks = t((rng.random((h, m_cap)) * 0.02 + 0.001).astype(np.float32))
    vs = t((rng.random((h, m_cap)) * 0.02 + 0.001).astype(np.float32))
    scale = dh ** -0.5
    ptx = ptxas_summary(_build, "prefill_attention", "prefill_kernel")
    for label, r, q_off in (("chunk", c, s_total - c), ("whole", s_total, 0)):
        qi = t(rng.integers(-127, 128, (h, r, dh)).astype(np.int8))
        qsc = t((rng.random((h, r)) * 0.02 + 0.001).astype(np.float32))
        kv_len = torch.tensor([q_off + r], dtype=torch.int32, device=dev)
        args = (qi, qsc, k_c, v_c, ks, vs, kv_len, q_off)

        def kern(*a, window=0):
            return fused_prefill_attention(*a, hkv=h, chunk=a[0].shape[1],
                                           causal=True, window=window,
                                           softmax_scale=scale)

        def ref(qi_, qsc_, k_, v_, ks_, vs_, kvl_, qo_, window=0):
            return plain.prefill_attention_ref(
                qi_[None], qsc_[None], k_[None], v_[None], ks_[None],
                vs_[None], kvl_, qo_, causal=True, window=window,
                softmax_scale=scale)[0]
        got, want = kern(*args), ref(*args)
        err = max(err, check_close(torch, f"fused_prefill_attention[{label}]",
                                   got, want))
        if label == "whole":
            # chunked == whole bitwise at kernel level: 128-row chunks of
            # the same prompt over the same cache, each at its own q_off
            for start in range(0, s_total, c):
                part = kern(qi[:, start:start + c].contiguous(),
                            qsc[:, start:start + c].contiguous(), k_c, v_c,
                            ks, vs, torch.tensor([start + c], dtype=torch.int32,
                                                 device=dev), start)
                check_close(torch, f"fused_prefill_attention[chunk at "
                            f"{start}] vs whole", part,
                            got[:, start:start + c], bitwise=True)
            log(f"  fused_prefill_attention: {s_total // c} chunks of {c} "
                f"rows bitwise one whole call ({h} lanes, dh {dh})")
            # sliding window 512 over the whole prompt
            got_w = kern(*args, window=512)
            err = max(err, check_close(
                torch, "fused_prefill_attention[whole, window 512]", got_w,
                ref(*args, window=512)))
        ms = cuda_ms(torch, kern, copies(torch, args), 20)
        p_ms = cuda_ms(torch, ref, [args], 2)
        kvl = q_off + r
        visible = sum(q_off + i + 1 for i in range(r))      # causal pairs
        b_ms, b_by = bounded(
            "fused_prefill_attention", dict(b=1, h=h, hkv=h, c=r, dh=dh,
                                            kvl=kvl, q_off=q_off),
            nbytes(qi, qsc) + h * kvl * (2 * dh + 8) + h * r * dh * 4,
            int8_ops=2.0 * h * visible * dh, f32_ops=2.0 * h * visible * dh)
        # library yardstick: SDPA on the dequantized tensors, causal at the
        # chunk's offset (one PyTorch call, same function up to rounding)
        qf = (qi.float() * qsc[..., None])[None]
        kf = (k_c[:, :kvl].float() * ks[:, :kvl, None])[None]
        vf = (v_c[:, :kvl].float() * vs[:, :kvl, None])[None]
        mask = (torch.arange(kvl, device=dev)[None, :]
                <= (q_off + torch.arange(r, device=dev))[:, None])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(torch, lambda a, b_, c_, m_: sdpa(a, b_, c_,
                                                          attn_mask=m_),
                         [(qf, kf, vf, mask)], 10)
        shape = prefill_launch_shape(h, r, dh)
        log(f"  fused_prefill_attention {label} R={r} q_off={q_off} M={m_cap}:"
            f" {ms:.4f} ms (plain {p_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound"
            f" {b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of bound); "
            f"{shape['ctas']} CTAs x {shape['warps']} warps, "
            f"{shape['smem']} B dynamic smem; {ptx}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms,
                         shape=f"{label} R={r} q_off={q_off} M={m_cap} B=1")
    rows["fused_prefill_attention"] = dict(timed, max_abs_err=err)

    # ---- #4 fused_decode_attention: B = 4, M = 1664, k_keep = 2, one
    #      retired lane (new_len 0) ----
    b = 4
    bh = b * h
    k_keep = 2
    qi = t(rng.integers(-127, 128, (bh, 1, dh)).astype(np.int8))
    qsc = t((rng.random((bh, 1)) * 0.02 + 0.001).astype(np.float32))
    kd = t(rng.integers(-127, 128, (bh, m_cap, dh)).astype(np.int8))
    vd = t(rng.integers(-127, 128, (bh, m_cap, dh)).astype(np.int8))
    ksd = t((rng.random((bh, m_cap)) * 0.02 + 0.001).astype(np.float32))
    vsd = t((rng.random((bh, m_cap)) * 0.02 + 0.001).astype(np.float32))
    feat = pack_features(lop_features(kd))
    new_len = torch.tensor([1600, 0, 700, 1200], dtype=torch.int32,
                           device=dev)
    args = (qi, qsc, kd, vd, ksd, vsd, feat, new_len)
    scale = dh ** -0.5

    def kern(*a):
        return fused_decode_attention(*a, hkv=h, block=blk, k_keep=k_keep,
                                      window=0, softmax_scale=scale)

    def ref(qi_, qsc_, k_, v_, ks_, vs_, f_, nl_):
        out = plain.decode_attention_ref(
            qi_.reshape(b, h, dh), qsc_.reshape(b, h, 1),
            k_.reshape(b, h, m_cap, dh), v_.reshape(b, h, m_cap, dh),
            ks_.reshape(b, h, m_cap), vs_.reshape(b, h, m_cap),
            f_.reshape(b, h, m_cap, dh // 2), nl_, block=blk, k_keep=k_keep,
            window=0, softmax_scale=scale)
        return out.reshape(bh, 1, dh)
    got, want = kern(*args), ref(*args)
    err = check_close(torch, "fused_decode_attention", got, want)
    if got.reshape(b, h, dh)[1].any():
        raise AssertionError("fused_decode_attention: retired lane not zero")
    arg_sets = copies(torch, args)
    ms = cuda_ms(torch, kern, arg_sets, 50)
    g_ms = graph_ms(torch, kern, arg_sets)
    p_ms = cuda_ms(torch, ref, [args], 3)
    nl = new_len.tolist()
    live_tok = sum(min(n_, k_keep * blk) for n_ in nl if n_)  # ≤ K blocks
    sel_blocks = sum(min(k_keep, -(-n_ // blk)) for n_ in nl if n_)
    b_ms, b_by = bounded(
        "fused_decode_attention", dict(b=b, h=h, hkv=h, dh=dh, block=blk,
                                       k_keep=k_keep, new_len=nl),
        nbytes(qi, qsc, new_len) + h * sum(nl) * (dh // 2)
        + h * sel_blocks * blk * (2 * dh + 8) + bh * dh * 4,
        int8_ops=2.0 * h * (sum(nl) + live_tok) * dh,
        f32_ops=2.0 * h * live_tok * dh)
    kind = "ILb1ELi2EE"              # <kOne = one query row, 2 ring stages>
    log(f"  fused_decode_attention B={b} M={m_cap} k_keep={k_keep}: "
        f"{ms:.4f} ms, in a CUDA graph {g_ms:.4f} ms (plain {p_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of bound, "
        f"{b_ms / g_ms:.1%} in the graph); "
        f"{fmt_decode_shape(decode_launch_shape(bh, 1, m_cap, dh, blk, k_keep=k_keep))}"
        f"; {ptxas_summary(_build, 'decode_attention', 'lop_decode_kernel' + kind)}")
    rows["fused_decode_attention"] = dict(
        ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_abs_err=err, shape=f"B={b} H=32 M={m_cap} k_keep={k_keep}")

    # ---- #5 fused_dense_decode_attention: the same inputs, every valid
    #      token attended (the --no-lop and recovery-retry path) ----
    dargs = (qi, qsc, kd, vd, ksd, vsd, new_len)

    def dkern(*a):
        return fused_dense_decode_attention(*a, hkv=h, block=blk, window=0,
                                            softmax_scale=scale)

    def dref(qi_, qsc_, k_, v_, ks_, vs_, nl_):
        out = plain.decode_attention_ref(
            qi_.reshape(b, h, dh), qsc_.reshape(b, h, 1),
            k_.reshape(b, h, m_cap, dh), v_.reshape(b, h, m_cap, dh),
            ks_.reshape(b, h, m_cap), vs_.reshape(b, h, m_cap), None, nl_,
            block=blk, k_keep=k_keep, window=0, softmax_scale=scale,
            use_lop=False)
        return out.reshape(bh, 1, dh)
    got, want = dkern(*dargs), dref(*dargs)
    derr = check_close(torch, "fused_dense_decode_attention", got, want)
    if got.reshape(b, h, dh)[1].any():
        raise AssertionError("fused_dense_decode_attention: retired lane "
                             "not zero")
    arg_sets = copies(torch, dargs)
    d_ms = cuda_ms(torch, dkern, arg_sets, 50)
    dg_ms = graph_ms(torch, dkern, arg_sets)
    dp_ms = cuda_ms(torch, dref, [dargs], 3)
    db_ms, db_by = bounded(
        "fused_dense_decode_attention", dict(b=b, h=h, hkv=h, dh=dh,
                                             block=blk, new_len=nl),
        nbytes(qi, qsc, new_len) + h * sum(nl) * (2 * dh + 8) + bh * dh * 4,
        int8_ops=2.0 * h * sum(nl) * dh, f32_ops=2.0 * h * sum(nl) * dh)
    # library yardstick: SDPA over the dequantized f32 K/V with the
    # validity mask (one PyTorch call, same function up to rounding; the
    # retired lane's fully masked row is NaN there, zero in the kernel)
    qf = (qi.float() * qsc[..., None])[:, None]           # [BH, 1, 1, dh]
    kf = (kd.float() * ksd[..., None])[:, None]           # [BH, 1, M, dh]
    vf = (vd.float() * vsd[..., None])[:, None]
    lane_len = new_len.repeat_interleave(h)
    mask = (torch.arange(m_cap, device=dev)[None, :]
            < lane_len[:, None])[:, None, None, :]        # [BH, 1, 1, M]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(torch, lambda a, b_, c_, m_: sdpa(a, b_, c_,
                                                      attn_mask=m_),
                     [(qf, kf, vf, mask)], 20)
    log(f"  fused_dense_decode_attention B={b} M={m_cap} new_len={nl}: "
        f"{d_ms:.4f} ms, in a CUDA graph {dg_ms:.4f} ms (plain {dp_ms:.3f} "
        f"ms, SDPA {lib_ms:.4f} ms, bound {db_ms:.4f} ms by {db_by}; "
        f"{db_ms / d_ms:.1%} of bound, {db_ms / dg_ms:.1%} in the graph); "
        f"{fmt_decode_shape(decode_launch_shape(bh, 1, m_cap, dh, blk, lop=False))}"
        f"; {ptxas_summary(_build, 'decode_attention', 'dense_decode_kernel' + kind)}"
        f"; LOP at the same shape: {ms:.4f} ms (graph {g_ms:.4f} ms), bound "
        f"{b_ms:.4f} ms")
    rows["fused_dense_decode_attention"] = dict(
        ms=d_ms, plain_ms=dp_ms, bound_ms=db_ms, bound_by=db_by,
        library_ms=lib_ms, max_abs_err=derr,
        shape=f"B={b} H=32 M={m_cap} new_len={nl}")
    modes = decode_modes(torch, np, rng, t)
    for name, row in modes.items():
        rows[name]["modes"] = row
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        *(r["max_abs_err"]
                                          for r in row.values()))
    squared_relu_check(torch, np, rng, t)
    return rows


def selected(torch, qi, feat, new_len, *, b, hkv, g, m, dh, blk, k_keep,
             shared=False, po=0, window=0):
    """What the LOP selection of the plain version reads on these inputs:
    (distinct gated blocks over the lanes, Σ live tokens of every (row,
    candidate) pair — a shared candidate counts for each of the G rows)."""
    from repro_torch.core.lop import features_to_pot, pot, unpack_features
    from repro_torch.core.quantization import int_matmul
    from repro_torch.serving.lop_select import select_blocks
    qg = qi.reshape(b, hkv, g, dh)
    kp = features_to_pot(unpack_features(feat.reshape(b, hkv, m, dh // 2)))
    scores = int_matmul(pot(qg), kp.transpose(-1, -2))
    if shared:
        scores = scores.amax(2, keepdim=True)
    idx, gt = select_blocks(scores, new_len, block=blk, k_keep=k_keep,
                            window=window, block_offset=po // blk)
    gate = gt[..., :k_keep] > 0
    live = ((gt[..., k_keep:2 * k_keep] - gt[..., 2 * k_keep:]) * gate).sum()
    hit = torch.zeros((b, hkv, m // blk), dtype=torch.int32,
                      device=qi.device)
    hit.scatter_(-1, idx.reshape(b, hkv, -1).long(),
                 gate.reshape(b, hkv, -1).to(torch.int32))
    return int(hit.sum()), int(live) * (g if shared else 1)


def decode_modes(torch, np, rng, t) -> dict:
    """#4 and #5 in the modes the sequence-parallel path and
    ``gqa_shared_select`` run, each against its plain version (f32 at
    rtol = atol = 2e-5: a different candidate set would be far off), timed
    as phase 3 times the kernels: shared_select at granite-moe-1b-a400m's
    shapes (G 2, dh 64) beside per-head selection on the same inputs;
    pos_offset + return_stats at bitnet-3b's shapes on a 2048-slot cache
    cut into 2 and 4 shards, each shard in turn (an empty shard, new_len
    inside a shard's first and last block, a retired lane), the shards'
    (out, m, ℓ) merged in-process and held against the plain merge; and
    shared_select at G 1 bitwise per-head. → {kernel: {mode: row}}."""
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.decode_attention import (
        fused_decode_attention, fused_dense_decode_attention)
    from repro_torch.kernels.decode_attention import \
        launch_shape as decode_launch_shape

    dev = torch.device("cuda")
    out = {"fused_decode_attention": {}, DENSE: {}}
    ptx = {one: ptxas_summary(_build, "decode_attention",
                              f"lop_decode_kernelILb{one}ELi2EE")
           for one in (0, 1)}

    def data(b, h, hkv, m, dh):
        bh = b * hkv
        g = h // hkv
        kd = t(rng.integers(-127, 128, (bh, m, dh)).astype(np.int8))
        return (t(rng.integers(-127, 128, (bh, g, dh)).astype(np.int8)),
                t((rng.random((bh, g)) * 0.02 + 0.001).astype(np.float32)),
                kd, t(rng.integers(-127, 128, (bh, m, dh)).astype(np.int8)),
                t((rng.random((bh, m)) * 0.02 + 0.001).astype(np.float32)),
                t((rng.random((bh, m)) * 0.02 + 0.001).astype(np.float32)),
                pack_features(lop_features(kd)))

    def plain_call(a, new_len, *, b, hkv, blk, k_keep, lop, shared=False,
                   po=0, stats=False):
        bh, g, dh = a[0].shape
        m = a[2].shape[1]
        res = plain.decode_attention_ref(
            a[0].reshape(b, hkv * g, dh), a[1].reshape(b, hkv * g, 1),
            *(x.reshape(b, hkv, m, *x.shape[2:]) for x in a[2:7]), new_len,
            block=blk, k_keep=k_keep, window=0, softmax_scale=dh ** -0.5,
            use_lop=lop, shared_select=shared, pos_offset=po,
            return_stats=stats)
        if not stats:
            return res.reshape(bh, g, dh)
        return (res[0].reshape(bh, g, dh), res[1].reshape(bh, g),
                res[2].reshape(bh, g))

    # ---- shared_select at granite's shapes, beside per-head ----
    b, h, hkv, m, dh, blk, k_keep = 4, 16, 8, 1664, 64, 128, 2
    g = h // hkv
    a = data(b, h, hkv, m, dh)
    nl = torch.tensor([1600, 0, 700, 1200], dtype=torch.int32, device=dev)
    args = (*a, nl)
    times = {}
    for shared in (True, False):
        def kern(*x, shared=shared):
            return fused_decode_attention(*x, hkv=hkv, block=blk,
                                          k_keep=k_keep, window=0,
                                          softmax_scale=dh ** -0.5,
                                          shared_select=shared)

        def ref(*x, shared=shared):
            return plain_call(x[:7], x[7], b=b, hkv=hkv, blk=blk,
                              k_keep=k_keep, lop=True, shared=shared)
        label = "shared_select" if shared else "per_head"
        err = check_close(torch, f"fused_decode_attention[{label}, granite]",
                          kern(*args), ref(*args))
        if kern(*args).reshape(b, h, dh)[1].any():
            raise AssertionError(f"[{label}] retired lane not zero")
        sets = copies(torch, args)
        ms, g_ms = cuda_ms(torch, kern, sets, 50), graph_ms(torch, kern, sets)
        p_ms = cuda_ms(torch, ref, [args], 3)
        blocks, live_sel = selected(torch, a[0], a[6], nl, b=b, hkv=hkv, g=g,
                                    m=m, dh=dh, blk=blk, k_keep=k_keep,
                                    shared=shared)
        live = hkv * int(nl.sum())
        b_ms, b_by = bound_ms(
            nbytes(a[0], a[1], nl) + live * dh // 2
            + blocks * blk * (2 * dh + 8) + b * h * dh * 4,
            int8_ops=2.0 * g * live * dh + 2.0 * live_sel * dh,
            f32_ops=2.0 * live_sel * dh)
        times[label] = dict(ms=ms, graph_ms=g_ms, plain_ms=p_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                            shape=f"B={b} H={h} Hkv={hkv} dh={dh} M={m} "
                                  f"k_keep={k_keep}, {blocks} blocks "
                                  f"gathered")
        log(f"  fused_decode_attention {label} (granite B={b} H={h} over "
            f"Hkv={hkv}, dh {dh}, M={m}, k_keep={k_keep}; {blocks} K/V "
            f"blocks gathered): {ms:.4f} ms, in a CUDA graph {g_ms:.4f} ms "
            f"(plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; "
            f"{b_ms / g_ms:.1%} of bound in the graph), max |err| {err:.3g};"
            f" {fmt_decode_shape(decode_launch_shape(b * hkv, g, m, dh, blk, k_keep=k_keep))}"
            f"; {ptx[0]}")
    out["fused_decode_attention"]["shared_select"] = times["shared_select"]

    # ---- pos_offset + return_stats at bitnet's shapes, n = 2 and 4 ----
    b, h, m, dh, blk = 4, 32, 2048, 100, 128
    a = data(b, h, h, m, dh)
    lens = [2000, 0, 1025, 1535]
    nl = torch.tensor(lens, dtype=torch.int32, device=dev)
    for lop, name in ((True, "fused_decode_attention"), (False, DENSE)):
        row = None
        for n in (2, 4):
            m_loc, k_keep = m // n, max(1, -(-2 // n))     # the quota
            parts, ms, g_ms, p_ms, b_ms, err = [], 0.0, 0.0, 0.0, 0.0, 0.0
            byb = {}
            for r in range(n):
                po = r * m_loc
                sa = (a[0], a[1], *(x[:, po:po + m_loc].contiguous()
                                    for x in a[2:]))
                args = (*sa, nl)
                if lop:
                    def kern(*x, po=po, k_keep=k_keep):
                        return fused_decode_attention(
                            *x, hkv=h, block=blk, k_keep=k_keep, window=0,
                            softmax_scale=dh ** -0.5, pos_offset=po,
                            return_stats=True)
                else:
                    def kern(*x, po=po):
                        return fused_dense_decode_attention(
                            *x[:6], x[7], hkv=h, block=blk, window=0,
                            softmax_scale=dh ** -0.5, pos_offset=po,
                            return_stats=True)

                def ref(*x, po=po, k_keep=k_keep):
                    return plain_call(x[:7], x[7], b=b, hkv=h, blk=blk,
                                      k_keep=k_keep, lop=lop, po=po,
                                      stats=True)
                got, want = kern(*args), ref(*args)
                for part, gv, wv in zip(("out", "m", "l"), got, want):
                    err = max(err, check_close(
                        torch, f"{name}[n={n}, shard {r}, {part}]", gv, wv))
                for lane, nlv in enumerate(lens):
                    if nlv <= po:       # an empty shard of this lane
                        rows_ = slice(lane * h, (lane + 1) * h)
                        for x in (got, want):
                            if (x[0][rows_].any() or x[2][rows_].any()
                                    or not (x[1][rows_] == -1e30).all()):
                                raise AssertionError(
                                    f"{name}[n={n}, shard {r}] lane {lane}:"
                                    f" empty rows not (m -1e30, ℓ 0, 0)")
                parts.append((got, want))
                sets = copies(torch, args)
                ms += cuda_ms(torch, kern, sets, 30)
                g_ms += graph_ms(torch, kern, sets)
                p_ms += cuda_ms(torch, ref, [args], 2)
                live = h * sum(max(0, min(v, po + m_loc) - po) for v in lens)
                if lop:
                    blocks, live_sel = selected(
                        torch, a[0], sa[6], nl, b=b, hkv=h, g=1, m=m_loc,
                        dh=dh, blk=blk, k_keep=k_keep, po=po)
                    nb_, ops_ = (live * dh // 2 + blocks * blk * (2 * dh + 8),
                                 2.0 * (live + live_sel) * dh)
                    f_ops = 2.0 * live_sel * dh
                else:
                    nb_, ops_, f_ops = (live * (2 * dh + 8), 2.0 * live * dh,
                                        2.0 * live * dh)
                bm, by = bound_ms(nbytes(a[0], a[1], nl) + nb_
                                  + b * h * (dh + 2) * 4, int8_ops=ops_,
                                  f32_ops=f_ops)
                b_ms += bm
                byb[by] = byb.get(by, 0) + 1
            merged = []
            for side in (0, 1):
                o, mx, l = (torch.stack([p[side][i] for p in parts])
                            for i in range(3))
                w = torch.exp(mx - mx.amax(0, keepdim=True))
                lw = (l * w).sum(0)
                merged.append((o * (l * w)[..., None]).sum(0)
                              / torch.clamp_min(lw, 1e-20)[..., None])
            merr = check_close(torch, f"{name}[n={n} merged]", *merged)
            if merged[0].reshape(b, h, dh)[1].any():
                raise AssertionError(f"{name}[n={n}]: retired lane not zero")
            by = max(byb, key=byb.get)
            log(f"  {name} pos_offset + return_stats, n={n} shards of "
                f"M={m_loc} (bitnet B={b} H={h} dh {dh}, new_len {lens}, "
                f"k_keep {k_keep} a shard): all {n} shards {ms:.4f} ms, in "
                f"CUDA graphs {g_ms:.4f} ms (plain {p_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms by {by}; {b_ms / g_ms:.1%} of bound in the "
                f"graph); (out, m, ℓ) max |err| {err:.3g}, empty rows exact, "
                f"merge max |err| {merr:.3g} against the plain merge; "
                f"{fmt_decode_shape(decode_launch_shape(b * h, 1, m_loc, dh, blk, k_keep=k_keep, lop=lop))}"
                f"; {ptxas_summary(_build, 'decode_attention', ('lop' if lop else 'dense') + '_decode_kernelILb1ELi2EE')}")
            if row is None:
                row = dict(ms=ms, graph_ms=g_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=by, max_abs_err=max(err, merr),
                           shape=f"B={b} H={h} M={m} in {n} shards, "
                                 f"new_len {lens}, all shards")
        out[name]["pos_offset+return_stats"] = row

    # ---- G = 1: shared_select bitwise per-head (a shard, stats too) ----
    sa = (a[0], a[1], *(x[:, m // 2:].contiguous() for x in a[2:]), nl)
    per = [fused_decode_attention(*sa, hkv=h, block=blk, k_keep=1, window=0,
                                  softmax_scale=dh ** -0.5, shared_select=sh,
                                  pos_offset=m // 2, return_stats=True)
           for sh in (False, True)]
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(*per)):
        raise AssertionError("shared_select at G = 1 is not bitwise "
                             "per-head selection")
    log("  fused_decode_attention shared_select at G = 1 (bitnet, shard 1 "
        "of 2, stats): bitwise per-head selection")
    return out


def squared_relu_check(torch, np, rng, t) -> None:
    """#1 and #2 with the squared-relu epilogue at bitnet-3b's decode
    shapes (#1 the O projection; #2 gated and ungated) against their plain
    versions (#1 bitwise), timed eager and in a CUDA graph beside their
    bounds."""
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear
    d, f, m = 3200, 8640, 4
    x = t(rng.standard_normal((m, d)).astype(np.float32))
    packed = t(rng.integers(0, 256, (d // 4, d)).astype(np.uint8))
    gamma = t(rng.uniform(0.01, 0.05, (d,)).astype(np.float32))
    check_close(torch, "fused_qlinear[squared_relu]",
                fused_qlinear(x, packed, gamma, act="squared_relu"),
                plain.qlinear_ref(x, packed, gamma[None],
                                  act="squared_relu"), bitwise=True)
    sets = copies(torch, (x, packed, gamma))

    def proj(*a):
        return fused_qlinear(*a, act="squared_relu")
    b_ms, b_by = bound_ms(nbytes(x, packed, gamma) + m * d * 4,
                          int8_ops=2.0 * m * d * d)
    parts = [f"fused_qlinear O m={m} k=n={d} bitwise, "
             f"{cuda_ms(torch, proj, sets, 30):.4f} ms, in a CUDA graph "
             f"{graph_ms(torch, proj, sets):.4f} ms, bound {b_ms:.4f} ms by "
             f"{b_by}"]
    for gated in (True, False):
        width = 2 * f if gated else f
        args = (x, t(rng.integers(0, 256, (d // 4, width)).astype(np.uint8)),
                t(rng.uniform(0.01, 0.05, (width,)).astype(np.float32)),
                t(rng.integers(0, 256, (f // 4, d)).astype(np.uint8)),
                t(np.full((d,), 0.02, np.float32)))

        def ffn(*a, gated=gated):
            return fused_ffn(*a, gated=gated, act="squared_relu")
        err = check_close(
            torch, f"fused_ffn[squared_relu, gated={gated}]", ffn(*args),
            plain.ffn_fused_ref(args[0], args[1], args[2][None], args[3],
                                args[4][None], gated=gated,
                                act="squared_relu"))
        sets = copies(torch, args)
        b_ms, b_by = bound_ms(nbytes(*args) + m * d * 4,
                              int8_ops=2.0 * m * d * width
                              + 2.0 * m * f * d)
        parts.append(f"fused_ffn {'gated' if gated else 'ungated'} m={m} "
                     f"d={d} f={f} max |err| {err:.3g}, "
                     f"{cuda_ms(torch, ffn, sets, 30):.4f} ms, in a CUDA "
                     f"graph {graph_ms(torch, ffn, sets):.4f} ms, bound "
                     f"{b_ms:.4f} ms by {b_by}")
    log("  squared_relu epilogue: " + "; ".join(parts))


MOE_D, MOE_F, MOE_E = 1024, 512, 32        # granite-moe-1b-a400m
MOE_LAYERS = 6                             # of 24 (the smoke run's time)


def expert_kernels(torch, np, rng, t) -> dict:
    """#1 and #2 with the leading expert axis, E = 32 at granite's widths
    (d 1024, f 512): x [E, C, d] at the decode shape (C = cap 8 of 4
    lanes; all but the first row of every expert zero, as the dispatch
    leaves the empty capacity slots) and at one 1536-token prompt's group
    (C = cap 480, its last 96 rows of every expert zero), γ per expert and
    column. Held against the plain versions (#1 bitwise; zero rows exact
    zeros), timed as the E = 1 forms. No PyTorch call computes a batched
    packed-ternary product (``torch._int_mm`` has no batch axis), so no
    library time. → their rows of the kernels line."""
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import (fused_ffn_experts,
                                             fused_qlinear_experts)
    from repro_torch.kernels.qlinear import \
        launch_shape as qlinear_launch_shape

    e, d, f = MOE_E, MOE_D, MOE_F
    rows = {}
    for name in ("fused_qlinear_experts", "fused_ffn_experts"):
        err, timed = 0.0, None
        for c, live in ((8, 1), (480, 384)):
            x = rng.standard_normal((e, c, d)).astype(np.float32)
            x[:, live:] = 0.0
            gs = rng.uniform(0.01, 0.05, (e, 2 * f)).astype(np.float32)
            gu = t(rng.integers(0, 256, (e, d // 4, 2 * f)).astype(np.uint8))
            x, gs = t(x), t(gs)
            if name == "fused_qlinear_experts":
                args = (x, gu, gs)
                kern = fused_qlinear_experts

                def ref(x_, gu_, gs_):
                    return plain.qlinear_ref(x_, gu_, gs_[:, None])
                n_out, ops_ = 2 * f, 2.0 * e * c * d * 2 * f
                launch = fmt_shape(qlinear_launch_shape(c, d, 2 * f,
                                                        experts=e))
            else:
                down = t(rng.integers(0, 256, (e, f // 4, d)).astype(
                    np.uint8))
                ds = t(np.repeat(rng.uniform(0.01, 0.05, (e, 1)), d,
                                 1).astype(np.float32))
                args = (x, gu, gs, down, ds)

                def kern(*a):
                    return fused_ffn_experts(*a, gated=True, act="silu")

                def ref(x_, gu_, gs_, down_, ds_):
                    return plain.ffn_fused_ref(x_, gu_, gs_[:, None], down_,
                                               ds_[:, None], gated=True,
                                               act="silu")
                n_out = d
                ops_ = 2.0 * e * c * (d * 2 * f + f * d)
                gate_up = qlinear_launch_shape(c, d, f, gated=True,
                                               experts=e)
                down_gemm = qlinear_launch_shape(c, f, d, experts=e)
                launch = (f"gate‖up GEMM {fmt_shape(gate_up)}, down GEMM "
                          f"{fmt_shape(down_gemm)}")
            got, want = kern(*args), ref(*args)
            label = f"{name}[E={e},C={c}]"
            bitwise = name == "fused_qlinear_experts"
            err = max(err, check_close(torch, label, got, want,
                                       bitwise=bitwise))
            if got[:, live:].any():
                raise AssertionError(f"{label}: zero rows gave non-zeros")
            arg_sets = copies(torch, args)
            ms = cuda_ms(torch, kern, arg_sets, 30)
            g_ms = graph_ms(torch, kern, arg_sets)
            p_ms = cuda_ms(torch, ref, [args], 3)
            b_ms, b_by = bound_ms(nbytes(*args) + e * c * n_out * 4,
                                  int8_ops=ops_)
            log(f"  {name} E={e} C={c} d={d} f={f} ({live} live rows an "
                f"expert): {ms:.4f} ms, in a CUDA graph {g_ms:.4f} ms "
                f"(plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; "
                f"{b_ms / ms:.1%} of bound, {b_ms / g_ms:.1%} in the graph) "
                f"bitwise={bool(torch.equal(got, want))}, zero rows exact "
                f"zeros; library: none (no batched packed-ternary call); "
                f"{launch}")
            if timed is None:
                timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, shape=f"E={e} C={c} d={d} f={f}")
        rows[name] = dict(timed, max_abs_err=err, library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve full-width bitnet-3b
# ---------------------------------------------------------------------------

LOP_PATH = ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
            "fused_decode_attention")
DENSE = "fused_dense_decode_attention"


def serve_run(torch, np, engine, reqs, label: str, card: str,
              capacity: int = 1664, n_slots: int = N_SLOTS, **sched_kw):
    """Serve ``reqs`` through a Scheduler on ``engine`` with the launch
    counts (by mode too) zeroed just before and read just after. →
    dict."""
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import Scheduler

    sched = Scheduler(engine, n_slots=n_slots, **sched_kw)
    if sched.capacity != capacity:
        raise AssertionError(f"pool capacity {sched.capacity} != {capacity}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        sched.submit(r)
    results = {r.rid: r for r in sched.run_to_completion()}
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts(modes=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"  [{label}] launch counts (graph replays counted): {counts}")
    if sorted(results) != sorted(r.rid for r in reqs):
        raise AssertionError(f"[{label}] finished rids {sorted(results)}")
    n_tok = sum(len(r.tokens) for r in results.values())
    log(f"  [{label}] tokens sha256 {tokens_digest(results)}")
    ttft = [r.ttft for r in results.values()]
    step_ms = (float(np.percentile(sched.decode_seconds, 50) * 1e3)
               if sched.decode_seconds else float("nan"))
    store = sched.prefix_store
    prefix = ("prefix cache off" if store is None else
              f"prefix cache: {sched.prefix_hits} hits, prefill tokens "
              f"computed/served {sched.prefill_tokens_computed}/"
              f"{sched.prefill_tokens_served}, store "
              f"{store.cached_tokens} tokens = {store.nbytes / 2**20:.1f} "
              f"MiB")
    log(f"  [{label}] served {len(reqs)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.2f} tok/s, TTFT p50 "
        f"{np.percentile(ttft, 50) * 1e3:.1f} ms, serve-cycle decode p50 "
        f"{step_ms:.2f} ms over {sched.decode_launches} steps (waits on "
        f"the cycle's prefill chunk), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; {prefix}; {graph_memory(engine)} "
        f"[{card}]")
    return dict(sched=sched, results=results, counts=counts,
                tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50) * 1e3),
                serve_cycle_decode_ms_p50=step_ms, peak_bytes=peak)


def graph_memory(engine) -> str:
    graphs = engine.graphs
    if graphs is None:
        return "no CUDA graphs (eager)"
    return (f"{graphs.count} CUDA graphs held ({len(graphs)} keys), "
            f"{graphs.nbytes / 2**20:.1f} MiB reserved by their captures")


def tokens_digest(results: dict) -> str:
    """sha256 (16 hex digits) of every request's tokens in rid order: the
    same digest on two builds means the same tokens."""
    text = json.dumps([[rid, [int(x) for x in results[rid].tokens]]
                       for rid in sorted(results)])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def check_counts(counts: dict, label: str, launched, idle=()) -> None:
    missing = [k for k in launched if counts[k] <= 0]
    if missing:
        raise AssertionError(f"[{label}] kernels not launched: {missing}")
    stray = [k for k in idle if counts[k] != 0]
    if stray:
        raise AssertionError(f"[{label}] kernels launched that this path "
                             f"must not run: {stray}")


def check_tokens(cfg, results, gen: int, label: str) -> None:
    for r in results.values():
        if r.finish_reason != "length" or len(r.tokens) != gen or not all(
                0 <= x < cfg.vocab_padded for x in r.tokens):
            raise AssertionError(f"[{label}] rid {r.rid}: "
                                 f"{r.finish_reason} {r.tokens}")


def graph_pool_bytes(torch) -> int:
    """Device memory in the caching allocator's private pools — the CUDA
    graphs' — once what is free has been released."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


def check_lockstep(engine, reqs, results, rids, label: str) -> None:
    import torch
    from repro_torch.serving.graphs import GRAPH_BOUND
    from repro_torch.serving.scheduler import lockstep_generate
    graphs = engine.graphs
    if graphs is None:
        raise AssertionError(f"[{label}] the engine holds no CUDA graphs")
    pools, held = graph_pool_bytes(torch), graphs.nbytes
    for rid in rids:
        req = reqs[rid]
        ref = lockstep_generate(engine, req.prompt, req.max_new_tokens,
                                sampling=req.sampling, frames=req.frames,
                                patches=req.patches)
        if ref != results[rid].tokens:
            raise AssertionError(f"[{label}] rid {rid}: scheduler "
                                 f"{results[rid].tokens} != lockstep {ref}")
    grew = graph_pool_bytes(torch) - pools
    if len(graphs) > GRAPH_BOUND or grew != graphs.nbytes - held:
        raise AssertionError(
            f"[{label}] graph memory: pools grew {grew} B, held graphs "
            f"{graphs.nbytes - held} B; {graph_memory(engine)}, bound "
            f"{GRAPH_BOUND}")
    log(f"  [{label}] scheduler tokens == lockstep tokens for rids "
        f"{', '.join(map(str, rids))} (a fresh cache each; graph pools grew "
        f"{grew / 2**20:.1f} MiB, as the held graphs did; "
        f"{graph_memory(engine)}, bound {GRAPH_BOUND})")


HALF_LAYERS = 4     # of 26: 4c, 4d and 4g's chaos trace (the run's time)


def half_engines(engine):
    """Phase 4's weights cut to their first ``HALF_LAYERS`` layers (views
    of the stacked leaves, no copy): a LOP and a no-LOP engine for phases
    4c, 4d and 4g's chaos trace. → (LOP engine, no-LOP engine)."""
    from repro_torch.serving.api import PooledEngine

    cfg = engine.cfg.replace(n_layers=HALF_LAYERS)
    qp = dict(engine.qp, layers=leaves_cut(engine.qp["layers"], HALF_LAYERS))
    return tuple(PooledEngine(cfg, qp, max_len=engine.max_len, use_lop=lop,
                              device="cuda") for lop in (True, False))


def serve_phase(torch, np, card: str):
    """Phase 4: the greedy LOP serve. → (engine, reqs, stats)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.launch.serve import make_requests

    cfg = get_config("bitnet-3b")
    max_len = MAX_PROMPT + GEN
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=max_len,
                                    device="cuda")
    torch.cuda.synchronize()
    log(f"  seeded bitnet-3b weights ready in {time.monotonic() - t0:.1f} s")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    log("  prompt lengths: " + ", ".join(str(len(r.prompt)) for r in reqs))

    # warm-up (library handles, allocator) on a short request
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm

    run = serve_run(torch, np, engine, reqs, "LOP greedy", card)
    check_counts(run["counts"], "LOP greedy", LOP_PATH, idle=(DENSE,))
    check_tokens(cfg, run["results"], GEN, "LOP greedy")
    check_lockstep(engine, reqs, run["results"], (0, 1), "LOP greedy")
    # the same traffic with the prefix cache off: what interning costs (the
    # cache-on run's store goes first, so the two peaks compare)
    run.pop("sched")
    off = serve_run(torch, np, engine, reqs, "LOP greedy, prefix cache off",
                    card, prefix_cache=False)
    if tokens_digest(off["results"]) != tokens_digest(run["results"]):
        raise AssertionError("prefix cache off changed phase 4's tokens")
    run["cache_off"] = {k: off[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                            "peak_bytes")}
    del off

    # chunked prefill vs whole-prompt prefill, bitwise
    prompt = max((r.prompt for r in reqs), key=len)
    logits_w, whole = engine.prefill(prompt[None])
    chk = Scheduler(engine, n_slots=1)
    chk.submit(GenerateRequest(rid=0, prompt=prompt, max_new_tokens=1))
    chk.admit()
    pf = chk._prefilling[0]
    for kk in range(len(pf.chunks)):
        logits_c, pool = engine.prefill_chunk(
            chk.pool, pf.slot, pf.chunks[kk], pf.starts[kk], pf.seq_ends[kk],
            kk == len(pf.chunks) - 1)
    s = len(prompt)
    if not torch.isfinite(logits_w).all():
        raise AssertionError("non-finite prefill logits")
    if not torch.equal(logits_c, logits_w):
        raise AssertionError("chunked prefill logits != whole-prompt logits")
    for key, leaf in whole["layers"].items():
        if not torch.equal(pool["layers"][key][:, 0, :, :s], leaf[:, 0, :, :s]):
            raise AssertionError(f"chunked prefill cache '{key}' != whole")
    log(f"  chunked prefill ({len(pf.chunks)} chunks) == whole-prompt "
        f"prefill, bitwise, for a {s}-token prompt")
    del chk, pool, whole
    steady = steady_phase(torch, np, engine, reqs, card)
    stats = {k: v for k, v in run.items() if k not in ("sched", "results")}
    return engine, reqs, dict(stats, **steady)


def decode_step_ms(torch, np, engine, reqs, sampling=None, eager=False):
    """p50 of 10 decode steps over 4 active lanes with no prefill in flight
    (host clock around work that ends in a synchronize), the prefix store
    off: the steps read none of its pages. ``eager``: the lanes' prefill
    (with the decode steps of the lanes already prefilled) on ``engine``'s
    CUDA graphs, then its graphs dropped: the timed steps, and every later
    step of the returned scheduler, run eagerly. → (ms, sched)."""
    from dataclasses import replace

    from repro_torch.serving.scheduler import Scheduler

    sched = Scheduler(engine, n_slots=N_SLOTS, prefix_cache=False)
    for r in reqs[:N_SLOTS]:
        sched.submit(replace(r, max_new_tokens=96, arrival=None,
                             **({} if sampling is None
                                else dict(sampling=sampling(r.rid)))))
    sched.admit()
    while sched.n_prefilling:
        sched.step()
    if sched.n_active != N_SLOTS:
        raise AssertionError(f"{sched.n_active} lanes active, want {N_SLOTS}")
    if eager:
        engine.graphs = None
    from repro_torch.kernels import ops
    step_s = []
    ops.reset_launch_counts()
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check_step_counts(ops.launch_counts(), engine, len(step_s))
    return float(np.median(step_s[2:]) * 1e3), sched


def recurrent_step_launches(cfg, use_lop: bool) -> dict:
    """Kernel launches of one decode step of an ssm or hybrid model: rwkv6
    ten #1 a layer; a jamba superblock #1 three a Mamba sublayer (in, x,
    out; four where dt_proj packs, k = dt_rank >= 16) and two for its
    attention (QKV, O), #2 a sublayer (its expert form on MoE positions)
    and the decode kernel once."""
    if cfg.family == "ssm":
        return {"fused_qlinear": 10 * cfg.n_layers}
    from repro_torch.models.mamba import dt_rank
    n_sb, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
    n_moe = sum(cfg.is_moe_layer(j) for j in range(e))
    mamba_q = 3 + (dt_rank(cfg) >= 16 and dt_rank(cfg) % 4 == 0)
    return {"fused_qlinear": n_sb * ((e - 1) * mamba_q + 2),
            "fused_ffn": n_sb * (e - n_moe), "fused_ffn_experts": n_sb * n_moe,
            "fused_decode_attention" if use_lop else DENSE: n_sb}


def check_step_counts(counts: dict, engine, steps: int) -> None:
    """Each decode step launches #1 twice a layer (QKV, O; four times with
    cross-attention: its Q and O too), #2 once (for a moe model its
    grouped-expert form, every expert in the launch) and its decode kernel
    once (twice with cross-attention: over the self and the cross pages),
    and nothing else — counted per graph replay as per eager call; an ssm
    or hybrid model launches :func:`recurrent_step_launches`."""
    n = engine.cfg.n_layers
    per = 2 if engine.cfg.family == "encdec" else 1
    attn = "fused_decode_attention" if engine.use_lop else DENSE
    ffn = "fused_ffn_experts" if engine.cfg.family == "moe" else "fused_ffn"
    want = {"fused_qlinear": 2 * per * n * steps, ffn: n * steps,
            attn: per * n * steps}
    if engine.cfg.family in ("ssm", "hybrid"):
        want = {k: v * steps for k, v in recurrent_step_launches(
            engine.cfg, engine.use_lop).items()}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{steps} decode steps launched {got}, want "
                             f"{want}")
    log(f"  launches a decode step ({engine.cfg.name}): "
        + ", ".join(f"{k} {v // steps}" for k, v in sorted(got.items())))


def decode_arms(torch, np, engine, reqs, label: str, card: str,
                sampling=None) -> dict:
    """The clean decode step on an eager twin of ``engine`` (the same
    weights; its prefill on graphs of its own, its steps eager) and on
    ``engine``'s CUDA graphs, one after the other: both lanes' tokens must
    agree. → dict of both p50s and schedulers."""
    from repro_torch.serving.api import PooledEngine

    eager = PooledEngine(engine.cfg, engine.qp, max_len=engine.max_len,
                         use_lop=engine.use_lop, device="cuda")
    eager_ms, eager_sched = decode_step_ms(torch, np, eager, reqs, sampling,
                                           eager=True)
    graph_ms_, sched = decode_step_ms(torch, np, engine, reqs, sampling)
    want = [lane.tokens for lane in eager_sched.lanes]
    if [lane.tokens for lane in sched.lanes] != want:
        raise AssertionError(f"[{label}] graph decode tokens != eager")
    log(f"  decode step (B={N_SLOTS}, no prefill in flight), {label}: "
        f"p50 eager {eager_ms:.2f} ms, CUDA graph {graph_ms_:.2f} ms over "
        f"10 steps each, tokens equal; {graph_memory(engine)} [{card}]")
    return dict(ms=graph_ms_, eager_ms=eager_ms, sched=sched,
                eager_sched=eager_sched)


def profile_arms(torch, arms: dict, label: str, card: str) -> dict:
    """Profile 4 decode steps on each arm of :func:`decode_arms`. → device
    ms a step and busy share of each."""
    out = {}
    for arm, sched in (("eager", arms["eager_sched"]),
                       ("graph", arms["sched"])):
        dev_us, wall_us = profile_steps(torch, sched, f"{label}, {arm}")
        out[arm] = ((dev_us / 4e3, dev_us / wall_us) if dev_us
                    else (None, None))
    (e_ms, e_busy), (g_ms, g_busy) = out["eager"], out["graph"]
    if e_ms and g_ms:
        log(f"  device time a step, {label}: eager {e_ms:.3f} ms, CUDA "
            f"graph {g_ms:.3f} ms ({g_ms / e_ms - 1:+.1%}); busy eager "
            f"{e_busy:.1%}, graph {g_busy:.1%} (profiler on) [{card}]")
    return out


def nolop_phase(torch, np, engine, reqs, card: str) -> dict:
    """Phase 4b: the same 8 requests on a use_lop=False engine sharing the
    LOP engine's quantized weights."""
    from repro_torch.serving.api import PooledEngine

    dense = PooledEngine(engine.cfg, engine.qp, max_len=engine.max_len,
                         use_lop=False, device="cuda")
    run = serve_run(torch, np, dense, reqs, "no-LOP greedy", card)
    check_counts(run["counts"], "no-LOP greedy",
                 ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
                  DENSE), idle=("fused_decode_attention",))
    check_tokens(engine.cfg, run["results"], GEN, "no-LOP greedy")
    check_lockstep(dense, reqs, run["results"], (0, 1), "no-LOP greedy")
    plain = {rid: r.tokens for rid, r in run.pop("results").items()}
    run.pop("sched")
    arms = decode_arms(torch, np, dense, reqs, "no-LOP greedy", card)
    prof = profile_arms(torch, arms, "no-LOP greedy", card)
    return dict(dense=dense, counts=run["counts"], tokens=plain,
                tokens_per_s=run["tokens_per_s"],
                ttft_p50_ms=run["ttft_p50_ms"], decode_step_ms_p50=arms["ms"],
                eager_decode_step_ms_p50=arms["eager_ms"],
                device_ms=prof["graph"][0], eager_device_ms=prof["eager"][0])


def sampled_fault_phase(torch, np, engine, dense, reqs, card: str) -> dict:
    """Phase 4c: sampled serve, then the fault-recovery, sticky-fault,
    deadline and cancellation contracts on the card."""
    from dataclasses import replace

    from repro_torch.kernels import ops
    from repro_torch.serving import faults
    from repro_torch.serving.api import (CancelToken, GenerateRequest,
                                         SamplingParams)
    from repro_torch.serving.scheduler import Scheduler

    cfg = engine.cfg

    def sp(rid):
        return SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=rid)

    # 1. sampled LOP serve == sampled lockstep
    sreqs = [replace(r, sampling=sp(r.rid)) for r in reqs]
    run = serve_run(torch, np, engine, sreqs, "LOP sampled", card)
    check_counts(run["counts"], "LOP sampled", LOP_PATH, idle=(DENSE,))
    check_tokens(cfg, run["results"], GEN, "LOP sampled")
    check_lockstep(engine, sreqs, run["results"], (0, 1), "LOP sampled")
    sampled_tps = run["tokens_per_s"]
    del run                       # its pool would count in later peaks
    arms = decode_arms(torch, np, engine, reqs,
                       "LOP sampled (T=0.8, top_k=50, top_p=0.95)", card,
                       sampling=sp)
    sampled_ms, sampled_eager_ms = arms["ms"], arms["eager_ms"]
    del arms                      # their pools would count in later peaks

    # 2. transient NaNs on the no-LOP engine recover to the clean streams
    freqs = [replace(r, max_new_tokens=16) for r in reqs[:N_SLOTS]]
    dense_launches = 0
    streams = []
    for plan in (faults.FaultPlan(),
                 faults.FaultPlan(nan_logits=frozenset({(3, 0), (7, 2)}))):
        frun = None                   # free the last run's pool first
        with faults.inject(plan):
            frun = serve_run(torch, np, dense, freqs,
                             f"no-LOP faults={sorted(plan.nan_logits)}", card,
                             check_invariants=True)
        dense_launches += frun["counts"][DENSE]
        streams.append({rid: r.tokens for rid, r in frun["results"].items()})
    fs = frun["sched"]
    if not (fs.fault_events >= 1 and fs.fault_recoveries == fs.fault_events
            and fs.fault_finishes == 0):
        raise AssertionError(f"fault run: events {fs.fault_events}, "
                             f"recoveries {fs.fault_recoveries}, finishes "
                             f"{fs.fault_finishes}")
    if streams[0] != streams[1]:
        raise AssertionError("recovered streams != clean streams")
    log(f"  transient NaNs: {fs.fault_events} events, "
        f"{fs.fault_recoveries} recovered, 0 gave up; every stream bitwise "
        f"the clean run's")

    # 3.-4. sticky fault, deadline, cancellation
    ops.reset_launch_counts()
    short = reqs[0].prompt[:200]
    with faults.inject(faults.FaultPlan(sticky_nan_lanes=frozenset({0}))):
        sticky = Scheduler(dense, n_slots=1, check_invariants=True)
        sticky.submit(GenerateRequest(rid=0, prompt=short, max_new_tokens=8))
        (res,) = sticky.run_to_completion()
    if res.finish_reason != "fault" or sticky.fault_finishes != 1:
        raise AssertionError(f"sticky lane finished {res.finish_reason}")
    tok = CancelToken()

    def cancel_at_two(sr):
        if sr.index == 2:
            tok.cancel()

    ab = Scheduler(engine, n_slots=2, check_invariants=True)
    ab.submit(GenerateRequest(rid=0, prompt=short, max_new_tokens=16,
                              deadline_ms=1e-3))
    ab.submit(GenerateRequest(rid=1, prompt=short, max_new_tokens=16,
                              on_token=cancel_at_two, cancel=tok))
    got = {r.rid: r for r in ab.run_to_completion()}
    if (got[0].finish_reason, got[0].tokens) != ("deadline", []) \
            or got[1].finish_reason != "cancelled" \
            or len(got[1].tokens) != 3 or ab.deadline_count != 1:
        raise AssertionError(f"deadline/cancel: {got[0].finish_reason} "
                             f"{got[0].tokens}, {got[1].finish_reason} "
                             f"{got[1].tokens}")
    dense_launches += ops.launch_counts()[DENSE]
    log("  sticky lane -> fault; 1 us deadline -> deadline, no tokens; "
        "cancel after the 3rd token -> cancelled with 3 tokens")

    # 5. the production shape: a LOP server whose retry runs dense; enough
    #    events on one pool that the retry's graph is captured and replayed
    ops.reset_launch_counts()
    with faults.inject(faults.FaultPlan(nan_logits=frozenset({
            (3, 0), (7, 2), (12, 1), (20, 2), (28, 3)}))):
        lop_faults = Scheduler(engine, n_slots=N_SLOTS, check_invariants=True)
        for r in freqs:
            lop_faults.submit(replace(r, arrival=None))
        lres = lop_faults.run_to_completion()
    counts = ops.launch_counts()
    dense_launches += counts[DENSE]
    if not (lop_faults.fault_events >= 1 and lop_faults.fault_finishes == 0
            and lop_faults.fault_recoveries == lop_faults.fault_events):
        raise AssertionError(f"LOP fault run: events "
                             f"{lop_faults.fault_events}, finishes "
                             f"{lop_faults.fault_finishes}")
    if any(r.finish_reason != "length" for r in lres):
        raise AssertionError("LOP fault run: a request did not finish")
    retries = lop_faults.fault_events
    if retries < 3:
        raise AssertionError(f"LOP fault run: {retries} retries, want >= 3 "
                             f"(warm-up, capture, replays)")
    if counts[DENSE] != cfg.n_layers * retries:
        raise AssertionError(f"dense launches {counts[DENSE]} != "
                             f"{cfg.n_layers} x {retries} retries")
    log(f"  LOP engine under NaN faults: {lop_faults.fault_events} events, "
        f"all recovered through the dense retry ({counts[DENSE]} dense "
        f"launches = {cfg.n_layers} layers x {retries} retries; the "
        f"retry's graph warmed once, then captured and replayed)")
    return dict(sampled_tokens_per_s=sampled_tps,
                sampled_decode_step_ms_p50=sampled_ms,
                sampled_eager_decode_step_ms_p50=sampled_eager_ms,
                dense_launches=dense_launches)


# ---------------------------------------------------------------------------
# phase 4d: prefix caching and speculative decoding
# ---------------------------------------------------------------------------

SHARED_PREFIX, MIN_SUFFIX, MAX_SUFFIX = 1024, 64, 512
GAMMA = 4
SPEC_REQUESTS = 2                  # phase 4's first two (the run's time)
NO_WATCHDOG = 10 ** 6       # random weights accept little: every cycle drafts


def timed_ms(torch, fn):
    """Host ms of ``fn()`` between two synchronizes. → (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def prefix_phase(torch, np, engine, card) -> dict:
    """Phase 4d, prefix traffic: 8 requests of one shared 1024-token prefix
    and a unique 64–512-token suffix, greedy, LOP; the cache on, then off
    (tokens bitwise), then on under page bit flips and a lookup outage."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import cache as _cache
    from repro_torch.serving import faults

    cfg = engine.cfg
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_SUFFIX,
                         max_prompt=MAX_SUFFIX, gen=GEN, seed=1,
                         shared_prefix_tokens=SHARED_PREFIX)
    log("  prompt lengths: " + ", ".join(str(len(r.prompt)) for r in reqs))
    on = serve_run(torch, np, engine, reqs, "prefix on", card)
    check_counts(on["counts"], "prefix on", LOP_PATH, idle=(DENSE,))
    check_tokens(cfg, on["results"], GEN, "prefix on")
    sched = on["sched"]
    # the first sweep's 4 requests miss an empty store; the 4 admitted
    # after them hit the whole shared prefix
    if (sched.prefix_hits, sched.prefill_tokens_served
            - sched.prefill_tokens_computed) != (4, 4 * SHARED_PREFIX):
        raise AssertionError(f"prefix on: {sched.prefix_hits} hits, "
                             f"{sched.prefill_tokens_computed} of "
                             f"{sched.prefill_tokens_served} computed")
    hit = [r.cached_len for r in on["results"].values()]
    store = sched.prefix_store
    prompt = reqs[-1].prompt
    match_ms, (n, _) = timed_ms(torch, lambda: store.match(prompt))
    aligned = len(prompt) // store.block * store.block
    # into fresh stores, three times: the first may grow the allocator
    interns = [timed_ms(torch, lambda: _cache.PrefixStore(store.block).insert(
        prompt[:aligned], _cache.extract_slot(sched.pool, 0)))[0]
        for _ in range(3)]
    intern_ms = interns[-1]
    log(f"  cached lengths by rid: {hit}; store {store.cached_tokens} "
        f"tokens, {store.nbytes / 2**20:.1f} MiB on the card; match of a "
        f"{len(prompt)}-token prompt ({n // store.block} nodes, checksums "
        f"verified): {match_ms:.2f} ms; intern of {aligned} tokens "
        f"({aligned // store.block} nodes cloned and checksummed), three "
        f"times: {', '.join(f'{t:.2f}' for t in interns)} ms [{card}]")
    digest = tokens_digest(on["results"])
    stats = dict(on_tokens_per_s=on["tokens_per_s"],
                 on_ttft_p50_ms=on["ttft_p50_ms"],
                 store_bytes=store.nbytes, match_ms=match_ms,
                 intern_ms=intern_ms, peak_bytes=on["peak_bytes"])
    del on, sched, store

    off = serve_run(torch, np, engine, reqs, "prefix off", card,
                    prefix_cache=False)
    if tokens_digest(off["results"]) != digest:
        raise AssertionError("prefix on != prefix off tokens")
    stats.update(off_tokens_per_s=off["tokens_per_s"],
                 off_ttft_p50_ms=off["ttft_p50_ms"])
    del off
    log(f"  prefix on == prefix off, bitwise: tok/s "
        f"{stats['on_tokens_per_s']:.2f} vs {stats['off_tokens_per_s']:.2f}, "
        f"TTFT p50 "
        f"{stats['on_ttft_p50_ms']:.1f} vs {stats['off_ttft_p50_ms']:.1f} ms "
        f"[{card}]")

    # a flip in the 3rd shared block (the first request's 3rd intern),
    # caught at the 6th match; the 5th match fails outright
    plan = faults.FaultPlan(seed=5, page_bitflips=frozenset({2}),
                            lookup_failures=frozenset({4}))
    with faults.inject(plan) as st:
        frun = serve_run(torch, np, engine, reqs, "prefix on, faults", card,
                         check_invariants=True)
    fs = frun["sched"]
    if not (st.injected_flips == fs.prefix_store.checksum_failures == 1
            and st.injected_lookup_failures == fs.prefix_lookup_failures
            == 1):
        raise AssertionError(
            f"faults: {st.injected_flips} flips, "
            f"{fs.prefix_store.checksum_failures} checksum failures, "
            f"{st.injected_lookup_failures} outages, "
            f"{fs.prefix_lookup_failures} lookup failures")
    if tokens_digest(frun["results"]) != digest:
        raise AssertionError("faulted prefix run changed the tokens")
    log(f"  under faults: {st.injected_flips} flipped page bit -> "
        f"{fs.prefix_store.checksum_failures} checksum failure, "
        f"{st.injected_lookup_failures} store outage -> "
        f"{fs.prefix_lookup_failures} cold prefill; {fs.prefix_hits} hits, "
        f"cached lengths {[r.cached_len for r in frun['results'].values()]};"
        f" tokens bitwise the clean run's")
    return stats


@contextlib.contextmanager
def kept_lanes():
    """While open, every lane a Scheduler retires is copied just before
    its eviction. → dict rid -> batch-1 copy of the lane's pages."""
    from repro_torch.serving.scheduler import Scheduler

    kept: dict = {}
    finish = Scheduler._finish

    def keep(self, slot, reason):
        kept[self.lanes[slot].req.rid] = self.engine.extract(self.pool, slot)
        return finish(self, slot, reason)

    Scheduler._finish = keep
    try:
        yield kept
    finally:
        Scheduler._finish = finish


def lane_diff(torch, plain, spec, prompt_len: int, end: int) -> dict:
    """Two runs' copies of one request's lane. [0, prompt_len) was written
    by the same prefill chunks and must be bitwise equal; [prompt_len, end)
    the plain run wrote by decode steps (#5) and the speculative run by
    verify chunks (#3). → over the latter: int8 K and V elements that
    differ and the largest |difference| in int8 steps, the largest
    relative scale difference, feature nibbles that differ, and whether
    each copy's features are its own int8 K's."""
    from repro_torch.core.lop import lop_features, pack_features, \
        unpack_features

    a, b = plain["layers"], spec["layers"]
    out = dict(prompt_bitwise=all(
        torch.equal(a[k][:, :, :, :prompt_len], b[k][:, :, :, :prompt_len])
        for k in a))
    x = {k: a[k][:, :, :, prompt_len:end] for k in a}
    y = {k: b[k][:, :, :, prompt_len:end] for k in b}
    out["bitwise"] = all(torch.equal(x[k], y[k]) for k in x)
    for k in ("k", "v"):
        d = (x[k].to(torch.int32) - y[k].to(torch.int32)).abs()
        out[f"{k}_differ"] = int((d > 0).sum())
        out[f"{k}_elements"] = d.numel()
        out[f"{k}_max_steps"] = int(d.max())
        per = d.reshape(d.shape[0], -1)
        out[f"{k}_max_steps_by_layer"] = per.max(dim=1).values.tolist()
        out[f"{k}_share_by_layer"] = [
            round(float(v), 4) for v in (per > 0).float().mean(dim=1)]
    for k in ("k_scale", "v_scale"):
        rel = (x[k] - y[k]).abs() / x[k].abs().clamp_min(1e-30)
        out[f"{k}_max_rel"] = float(rel.max())
    out["feat_differ"] = int((unpack_features(x["feat"])
                              != unpack_features(y["feat"])).sum())
    out["feat_follow_k"] = all(
        torch.equal(t["feat"], pack_features(lop_features(t["k"])))
        for t in (x, y))
    return out


def explain_divergence(torch, np, engine, req, plain_toks, spec_toks, p,
                       chunks, plain_lane, spec_lane, sampled) -> dict:
    """Where a speculative stream first parts from the plain one, at token
    ``p`` (plain ``a``, speculative ``b``). Three rows score token ``p``:
    the plain run's decode row, recomputed on the plain run's own pages;
    the verify row the speculative run chose from (``chunks``: its (start,
    logits [w, V]) in order); and that verify chunk replayed on the plain
    run's pages (same start, width and row, the plain stream's tokens).
    Scores are the logits for a greedy lane and, for a sampled one, the
    sampler's after its filters and noise. The control writes the plain
    stream's tokens [0, p) by one prefill chunk (#3) onto the plain run's
    prompt pages, with no speculation. → the margin of the plain choice
    (its top-2 score gap), the gap s[a] − s[b] on each row, and
    :func:`lane_diff` over [prompt, prompt + p) of the speculative lane
    against the plain one, at the first generated position alone, and
    against the control."""
    from repro_torch.serving import sampling as smp
    from repro_torch.serving.engine import prefill_chunk, serve_step

    cfg, qp, dev = engine.cfg, engine.qp, engine.device
    plen = engine.prefix_len(req) + len(req.prompt)     # a vlm image first
    pos = plen + p - 1                  # the position whose row picks token p
    start, logits = next((st, lg) for st, lg in reversed(chunks)
                         if st <= pos < st + lg.shape[0])
    i = pos - start
    width = logits.shape[0]

    def lane_at(n):
        """A fresh copy of the plain lane, cut back to length ``n``."""
        return {"lengths": torch.full((1,), n, dtype=torch.int32, device=dev),
                "layers": {k: v.clone()
                           for k, v in plain_lane["layers"].items()}}

    tok = torch.tensor([[int(plain_toks[p - 1])]], dtype=torch.int64,
                       device=dev)
    drow, _ = serve_step(cfg, qp, lane_at(pos), tok, use_lop=engine.use_lop)
    block = np.zeros((1, width), np.int64)
    tail = plain_toks[start - plen:start - plen + width]
    block[0, :len(tail)] = tail
    vrows, _ = prefill_chunk(cfg, qp, torch.as_tensor(block, device=dev),
                             lane_at(start), start=start,
                             seq_end=start + width, all_logits=True)
    rows = dict(decode=drow[0], same=vrows[0, i], spec=logits[i])
    ctl = lane_at(plen)
    prefill_chunk(cfg, qp, torch.as_tensor(
        np.asarray(plain_toks[:p], np.int64)[None], device=dev), ctl,
        start=plen, seq_end=plen + p)

    def scores(row):
        if not sampled:
            return row
        sp = req.sampling
        one = row[None] / torch.clamp_min(
            torch.full((1,), sp.temperature, device=dev), 1e-6)[:, None]
        one = smp._mask_top_k(one, torch.full((1,), sp.top_k,
                                              dtype=torch.int32, device=dev))
        one = smp._mask_top_p(one, torch.full((1,), sp.top_p, device=dev))
        keys = smp.lane_keys(
            torch.tensor([sp.seed], dtype=torch.int32, device=dev),
            torch.tensor([p], dtype=torch.int32, device=dev))
        return (smp.gumbel(keys, one.shape[-1]) + one)[0]

    a, b = int(plain_toks[p]), int(spec_toks[p])
    sc = {k: scores(r) for k, r in rows.items()}
    top2 = torch.topk(sc["decode"], 2).values
    out = dict(rid=req.rid, token=p, plain=a, spec=b, chunk_start=start,
               row=i, margin=float(top2[0] - top2[1]),
               decode_picks=int(torch.argmax(sc["decode"])),
               spec_picks=int(torch.argmax(sc["spec"])),
               same_row_bitwise=torch.equal(rows["same"], rows["spec"]))
    for k, s_ in sc.items():
        out[f"gap_{k}"] = float(s_[a] - s_[b])
    out.update(lane_diff(torch, plain_lane, spec_lane, plen, plen + p))
    out["first"] = lane_diff(torch, plain_lane, spec_lane, plen, plen + 1)
    out["spec_vs_control"] = lane_diff(torch, ctl, spec_lane, plen, plen + p)
    return out


def rounding_verdict(d: dict) -> str | None:
    """None when a divergence comes from the decode kernel (#5) and the
    chunk kernel (#3) rounding apart, else why not. The speculative run
    writes its tokens' pages by verify chunks, the plain run by decode
    steps. So the prompt's pages must be bitwise equal; layer 0's K/V,
    a projection of the token at its position alone, too; the speculative
    pages must be bitwise what one prefill chunk of the same tokens writes
    (the control: any verify fault — a wrong token, position or row, a
    draft row left behind — parts from it); each copy's features are its
    own K's; the rows recomputed from each run's pages make that run's
    choice; equal pages leave the verify row bitwise its replay; and the
    plain margin is below the change of the two tokens' gap."""
    if not d["prompt_bitwise"]:
        return "the prompt's pages differ"
    if d["k_max_steps_by_layer"][0] or d["v_max_steps_by_layer"][0]:
        return "layer 0's K/V differ"
    if not d["spec_vs_control"]["bitwise"]:
        return "the speculative pages are not one prefill chunk's"
    if not d["feat_follow_k"]:
        return "features are not the lanes' own K's"
    if (d["decode_picks"], d["spec_picks"]) != (d["plain"], d["spec"]):
        return "the recomputed rows do not make the runs' choices"
    if d["bitwise"] and not d["same_row_bitwise"]:
        return "equal pages, yet the verify row differs from its replay"
    if not d["margin"] < abs(d["gap_spec"] - d["gap_decode"]):
        return "the margin is not below the change of the gap"
    return None


def compare_streams(torch, np, engine, reqs, spec, plain, label, card,
                    sampled=False) -> list:
    """``spec``'s tokens == ``plain``'s for every request, or its first
    divergence a near-tie of rounding (:func:`rounding_verdict`, logged
    with the numbers it reads); anything else fails, after every request
    is logged. → the near-ties."""
    ties, bad = [], []
    for req in reqs:
        a, b = plain["tokens"][req.rid], spec["tokens"][req.rid]
        if a == b:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        d = explain_divergence(torch, np, engine, req, a, b, p,
                               spec["verify_rows"][req.rid],
                               plain["lanes"][req.rid],
                               spec["lanes"][req.rid], sampled)
        why = rounding_verdict(d)
        log(f"  [{label}] rid {req.rid} parts from plain decode at token "
            f"{p} ({d['spec']} vs {d['plain']}; verify chunk at "
            f"{d['chunk_start']}, row {d['row']}): margin of the plain "
            f"choice {d['margin']:.3e}; gap s[plain]-s[spec] on the decode "
            f"row {d['gap_decode']:.3e}, on the verify chunk replayed on the"
            f" plain pages {d['gap_same']:.3e}, on the speculative verify "
            f"row {d['gap_spec']:.3e}. Pages [prompt, prompt+{p}) against "
            f"the plain run's: prompt bitwise {d['prompt_bitwise']}, "
            f"K {d['k_differ']}/{d['k_elements']} int8 differ (max "
            f"{d['k_max_steps']} step), V {d['v_differ']}/{d['v_elements']}"
            f" (max {d['v_max_steps']}), scales max rel "
            f"{d['k_scale_max_rel']:.2e} / {d['v_scale_max_rel']:.2e}, "
            f"feature nibbles {d['feat_differ']} differ (features follow K:"
            f" {d['feat_follow_k']}); the speculative pages bitwise one "
            f"prefill chunk's of the plain tokens: "
            f"{d['spec_vs_control']['bitwise']} -> "
            f"{'rounding' if why is None else 'FAULT: ' + why} [{card}]")
        for name, e in (("by layer", d),
                        ("the first generated position alone", d["first"])):
            log(f"    {name}: K {e['k_differ']}/{e['k_elements']} differ, "
                f"max step by layer {e['k_max_steps_by_layer']}, share by "
                f"layer {e['k_share_by_layer']}; V {e['v_differ']}, max "
                f"step by layer {e['v_max_steps_by_layer']}; scales max rel"
                f" {e['k_scale_max_rel']:.2e} / {e['v_scale_max_rel']:.2e}")
        if why is None:
            ties.append(d)
        else:
            bad.append(f"rid {req.rid} token {p}: {why}")
    if bad:
        raise AssertionError(f"[{label}] divergences that are no near-tie: "
                             + "; ".join(bad))
    return ties


def spec_run(torch, np, engine, reqs, label, card) -> dict:
    """Serve ``reqs`` speculatively (γ 4, no watchdog) with the launch
    counts zeroed before and read after: #3 must launch for every chunk
    and every verify, the draft entry must replay a CUDA graph. → dict."""
    import math

    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import Scheduler

    cfg = engine.cfg
    sched = Scheduler(engine, n_slots=N_SLOTS, spec_decode=True, gamma=GAMMA,
                      spec_watchdog=NO_WATCHDOG)
    # keep each verify chunk's logits, for a divergence's diagnosis
    rows: dict = {}
    verify = engine.verify_chunk

    def record(pool, slot, tokens, start):
        logits, pool = verify(pool, slot, tokens, start)
        rows.setdefault(sched.lanes[slot].req.rid, []).append(
            (start, logits[0].clone()))
        return logits, pool

    engine.verify_chunk = record
    replays = engine.graphs.replays
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            sched.submit(r)
        results = {r.rid: r for r in sched.run_to_completion()}
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        del engine.verify_chunk
    counts = ops.launch_counts()
    replays = engine.graphs.replays - replays
    n_tok = sum(len(r.tokens) for r in results.values())
    chunks = sum(math.ceil((r.prompt_len - r.cached_len)
                           / engine.chunk_tokens) for r in results.values())
    want3 = cfg.n_layers * (chunks + sched.spec_verify_launches)
    attn = "fused_decode_attention" if engine.use_lop else DENSE
    want_attn = (engine.draft_layers * sched.draft_launches
                 + cfg.n_layers * sched.decode_launches)
    log(f"  [{label}] launch counts: {counts}; graph replays {replays}")
    if not (sched.spec_rounds > 0 and counts["fused_prefill_attention"]
            == want3 and counts[attn] == want_attn):
        raise AssertionError(f"[{label}] #3 {counts['fused_prefill_attention']}"
                             f" != {want3} or {attn} {counts[attn]} != "
                             f"{want_attn} ({sched.spec_rounds} rounds)")
    if replays < sched.draft_launches - 1 + max(sched.decode_launches - 1, 0):
        raise AssertionError(f"[{label}] {replays} graph replays for "
                             f"{sched.draft_launches} draft steps")
    check_tokens(cfg, results, GEN, label)
    draft_ms = float(np.percentile(sched.draft_seconds, 50) * 1e3)
    verify_ms = float(np.percentile(sched.verify_seconds, 50) * 1e3)
    rate = sched.spec_accepted / max(1, sched.spec_drafted)
    log(f"  [{label}] {sched.spec_rounds} rounds, {sched.spec_accepted}/"
        f"{sched.spec_drafted} drafts accepted ({rate:.3f}), "
        f"{sched.spec_emitted} tokens from rounds, "
        f"{sched.spec_verify_launches} verify chunks (#3 launched "
        f"{counts['fused_prefill_attention']} = {cfg.n_layers} x ({chunks} "
        f"chunks + verifies)), {sched.draft_launches} draft steps of "
        f"{engine.draft_layers} layers at k_keep {engine.draft_k} ({attn} "
        f"{counts[attn]}), {sched.decode_launches} plain steps; draft step "
        f"p50 {draft_ms:.2f} ms (CUDA graph), verify chunk p50 "
        f"{verify_ms:.2f} ms (eager, {GAMMA + 1} rows); {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.2f} tok/s [{card}]")
    return dict(tokens={rid: r.tokens for rid, r in results.items()},
                verify_rows=rows,
                counts=counts, tokens_per_s=n_tok / wall, draft_ms=draft_ms,
                verify_ms=verify_ms, accept_rate=rate,
                rounds=sched.spec_rounds)


def spec_phase(torch, np, engine, dense, reqs, card) -> dict:
    """Phase 4d, speculative traffic: 2 of phase 4's requests, γ 4, the
    draft the first half of ``engine``'s layers at k_keep 1. No-LOP
    greedy and sampled against plain decode of the same requests (equal,
    or a near-tie); LOP greedy completes with #4 in its draft."""
    from dataclasses import replace

    from repro_torch.serving.api import SamplingParams

    sreqs = [replace(r, arrival=None) for r in reqs[:SPEC_REQUESTS]]
    out, ties = {}, []

    def pair(kind, rs):
        """Plain then speculative no-LOP runs of ``rs``, each lane kept at
        its retirement for a divergence's diagnosis."""
        with kept_lanes() as lanes:
            plain = serve_run(torch, np, dense, rs, f"plain no-LOP {kind}",
                              card)
        plain = dict(plain, lanes=lanes,
                     tokens={rid: r.tokens
                             for rid, r in plain["results"].items()})
        with kept_lanes() as lanes:
            spec = dict(spec_run(torch, np, dense, rs, f"spec no-LOP {kind}",
                                 card), lanes=lanes)
        ties.extend(compare_streams(torch, np, dense, rs, spec, plain,
                                    f"spec no-LOP {kind}", card,
                                    sampled=kind == "sampled"))
        return dict(spec_tokens_per_s=spec["tokens_per_s"],
                    plain_tokens_per_s=plain["tokens_per_s"],
                    **{k: spec[k] for k in ("draft_ms", "verify_ms",
                                            "accept_rate", "rounds")})

    def sp(rid):
        return SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=rid)

    out["greedy"] = pair("greedy", sreqs)
    out["sampled"] = pair("sampled", [replace(r, sampling=sp(r.rid))
                                      for r in sreqs])

    spec = spec_run(torch, np, engine, sreqs, "spec LOP greedy", card)
    if spec["counts"]["fused_decode_attention"] <= 0:
        raise AssertionError("spec LOP greedy: the draft never launched #4")
    out["lop"] = {k: spec[k] for k in ("tokens_per_s", "draft_ms",
                                       "verify_ms", "accept_rate", "rounds")}
    out["near_ties"] = ties
    log(f"  speculative vs plain ({SPEC_REQUESTS} requests, no-LOP): greedy "
        f"{out['greedy']['spec_tokens_per_s']:.2f} vs "
        f"{out['greedy']['plain_tokens_per_s']:.2f} tok/s, sampled "
        f"{out['sampled']['spec_tokens_per_s']:.2f} vs "
        f"{out['sampled']['plain_tokens_per_s']:.2f} tok/s; LOP greedy spec "
        f"{out['lop']['tokens_per_s']:.2f} tok/s; near-ties {len(ties)}; "
        f"{graph_memory(engine)}; no-LOP engine: {graph_memory(dense)} "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 4g: the HTTP front-end, /metrics, and the chaos trace
# ---------------------------------------------------------------------------

HTTP_TIMEOUT = 120.0        # seconds a client waits on its socket
CHAOS_SHARED = 1024         # the chaos trace's shared prefix: 8 blocks of 128


def http_call(port: int, body=None, path: str = "/v1/completions",
              method: str = "POST", raw: bytes | None = None) -> dict:
    """One HTTP/1.1 request over loopback (stdlib sockets), the response
    read to its close. → status, headers, body, the seconds to the first
    SSE token frame (None without one) and to the close. A socket timeout
    raises."""
    import socket
    payload = json.dumps(body).encode() if body is not None else b""
    req = raw if raw is not None else (
        f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: "
        f"{len(payload)}\r\n\r\n".encode() + payload)
    t0 = time.monotonic()
    got, first = b"", None
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=HTTP_TIMEOUT) as s:
        s.sendall(req)
        while chunk := s.recv(65536):
            got += chunk
            if first is None and b"data: {" in got:
                first = time.monotonic() - t0
    head, _, rest = got.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    return dict(status=int(lines[0].split(" ")[1]), body=rest,
                headers=dict(ln.split(": ", 1) for ln in lines[1:]
                             if ": " in ln),
                ttft=first, wall=time.monotonic() - t0)


def sse_frames(body: bytes) -> tuple:
    """An SSE stream → (token frames' JSON, saw [DONE], error frames)."""
    frames, done, errors = [], False, []
    for frame in body.decode().split("\n\n"):
        lines = frame.split("\n")
        is_error = "event: error" in lines
        for line in lines:
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                (errors if is_error else frames).append(json.loads(line[6:]))
    return frames, done, errors


def in_threads(calls: dict) -> dict:
    """Run each ``name -> callable`` on its own thread, all at once; → the
    results by name. A thread's exception, or one still running after
    HTTP_TIMEOUT, raises here."""
    import threading
    out, errors = {}, []

    def run(name, fn):
        try:
            out[name] = fn()
        except BaseException as e:                     # noqa: BLE001
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=kv) for kv in calls.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP client timed out")
    if errors:
        raise AssertionError(f"HTTP client {errors[0][0]} failed: "
                             f"{errors[0][1]!r}") from errors[0][1]
    return out


def body_of(req, stream: bool = True, **extra) -> dict:
    sp = req.sampling
    return dict(prompt=[int(t) for t in req.prompt],
                max_tokens=req.max_new_tokens, stream=stream,
                temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
                seed=sp.seed, **extra)


def scrape(port: int) -> dict:
    """GET /metrics → {series with its labels: value}."""
    r = http_call(port, path="/metrics", method="GET")
    if r["status"] != 200:
        raise AssertionError(f"/metrics answered {r['status']}")
    out = {}
    for line in r["body"].decode().splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


@contextlib.contextmanager
def served(sched, **kw):
    """``serve_threaded`` over ``sched``; on the way out the server stops
    and an exception on its pump thread fails the phase."""
    from repro_torch.serving.frontend import serve_threaded
    srv = serve_threaded(sched, **kw)
    try:
        yield srv
    finally:
        srv.close()
    pump = srv.frontend.pump
    if pump.error is not None:
        raise AssertionError(f"scheduler pump failed: {pump.error!r}") \
            from pump.error
    if srv.thread.is_alive() or pump.is_alive():
        raise AssertionError("the HTTP server did not stop")


def http_phase(torch, np, engine, reqs, serve, spec, card) -> dict:
    """Phase 4g, HTTP: phase 4's 8 requests (rids 0–3 greedy, 4–7 sampled
    as in phase 4c) straight through a Scheduler, then as concurrent SSE
    streams through the port's server on a fresh Scheduler of the same
    engine: streams bitwise the direct run; a unary body with usage; a
    504 on an expired deadline; 400s before the scheduler; /metrics
    counters against what the clients saw; then a 1-slot server with
    max_queue 1: a 429 with Retry-After while a stream holds the lane and
    one waits, and the holder's disconnect cancelling its lane, which the
    waiting request then takes and streams token-exactly."""
    import socket
    import threading
    from dataclasses import replace

    from repro_torch.kernels import ops
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.metrics import (REGISTRY, MetricsRegistry,
                                             percentile)
    from repro_torch.serving.scheduler import Scheduler

    cfg = engine.cfg
    mixed = [replace(r, arrival=None, sampling=SamplingParams(
        temperature=0.8, top_k=50, top_p=0.95, seed=r.rid) if r.rid >= 4
        else SamplingParams()) for r in reqs]
    prompt_tokens = sum(len(r.prompt) for r in mixed)

    # ---- the same requests straight through a Scheduler ----
    # each run's peak is read above what the process holds before it (the
    # engine, and whatever earlier phases left that gc can free first)
    gc.collect()
    direct = Scheduler(engine, n_slots=N_SLOTS, metrics=MetricsRegistry())
    torch.cuda.synchronize()
    d_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for r in mixed:
        direct.submit(r)
    dres = {r.rid: r for r in direct.run_to_completion()}
    torch.cuda.synchronize()
    d_wall = time.monotonic() - t0
    d_peak = torch.cuda.max_memory_allocated() - d_base
    check_tokens(cfg, dres, GEN, "4g direct")
    want = {rid: r.tokens for rid, r in dres.items()}
    d_tps = sum(len(t) for t in want.values()) / d_wall
    d_ttft = percentile([r.ttft for r in dres.values()], 50)
    log(f"  [direct] {len(mixed)} requests (4 greedy, 4 sampled), "
        f"{d_tps:.2f} tok/s, TTFT p50 {d_ttft * 1e3:.1f} ms, "
        f"max_memory_allocated {d_peak / 2**30:.2f} GiB above the "
        f"{d_base / 2**30:.2f} GiB held before it; tokens sha256 "
        f"{tokens_digest(dres)} [{card}]")
    del direct, dres
    gc.collect()

    # ---- the same requests as concurrent SSE streams ----
    reg = MetricsRegistry()
    sched = Scheduler(engine, n_slots=N_SLOTS, metrics=reg)
    seen = []                               # (route, code) the clients got
    with served(sched, registry=reg) as srv:
        port = srv.port
        torch.cuda.synchronize()                  # the pump is idle
        h_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        streams = in_threads({r.rid: (lambda r=r: http_call(
            port, body_of(r))) for r in mixed})
        h_wall = time.monotonic() - t0
        h_peak = torch.cuda.max_memory_allocated() - h_base
        counts = ops.launch_counts()
        n_streamed = 0
        for rid, resp in sorted(streams.items()):
            frames, done, errors = sse_frames(resp["body"])
            toks = [f["choices"][0]["token"] for f in frames]
            seen.append(("/v1/completions", resp["status"]))
            if resp["status"] != 200 or not done or errors \
                    or frames[-1]["choices"][0]["finish_reason"] != "length":
                raise AssertionError(f"[http] rid {rid}: {resp['status']}, "
                                     f"done {done}, errors {errors}")
            if toks != want[rid]:
                raise AssertionError(f"[http] rid {rid}: streamed {toks} != "
                                     f"direct {want[rid]}")
            n_streamed += len(toks)
        check_counts(counts, "4g http", LOP_PATH, idle=(DENSE,))
        h_tps = n_streamed / h_wall
        c_ttft = percentile([s["ttft"] for s in streams.values()], 50)
        s_ttft = percentile([r.ttft for r in sched.results], 50)
        log(f"  [http] {len(mixed)} concurrent SSE streams bitwise the "
            f"direct run (4 greedy, 4 sampled); launch counts {counts}")
        log(f"  [http] {h_tps:.2f} tok/s (direct {d_tps:.2f}), TTFT p50 "
            f"{c_ttft * 1e3:.1f} ms at the client, {s_ttft * 1e3:.1f} ms in "
            f"the scheduler (direct {d_ttft * 1e3:.1f}), "
            f"max_memory_allocated {h_peak / 2**30:.2f} GiB above the "
            f"{h_base / 2**30:.2f} GiB held before it (direct "
            f"{d_peak / 2**30:.2f} above {d_base / 2**30:.2f}) [{card}]")

        # a unary body: its tokens and usage
        r0 = mixed[0]
        resp = http_call(port, body_of(r0, stream=False))
        seen.append(("/v1/completions", resp["status"]))
        obj = json.loads(resp["body"])
        cached = sched.results[-1].cached_len
        usage = {"prompt_tokens": len(r0.prompt), "completion_tokens": GEN,
                 "cached_prompt_tokens": cached}
        if resp["status"] != 200 or obj["choices"][0]["tokens"] != want[0] \
                or obj["usage"] != usage:
            raise AssertionError(f"[http] unary: {resp['status']} {obj}")
        n_streamed += GEN
        log(f"  [http] unary completion == direct rid 0, usage {usage} "
            f"(a prefix hit)")

        # an expired deadline: 504, streamed or not, no hang
        for stream in (True, False):
            resp = http_call(port, body_of(r0, stream=stream,
                                           deadline_ms=1e-3))
            seen.append(("/v1/completions", resp["status"]))
            err = json.loads(resp["body"]).get("error", {})
            if resp["status"] != 504 or err.get("code") != 504:
                raise AssertionError(f"[http] deadline: {resp['status']} "
                                     f"{resp['body'][:200]!r}")

        # invalid bodies: 400 before the scheduler sees them
        n_results = len(sched.results)
        bad = [{"prompt": "text"}, {"prompt": []},
               {"prompt": [1, 2], "max_tokens": 0},
               {"prompt": [1, 2], "max_tokens": 4000},
               {"prompt": [cfg.vocab]},
               {"prompt": [1, 2], "temperature": -1.0},
               {"prompt": [1, 2], "deadline_ms": -5}]
        for body in bad:
            resp = http_call(port, body)
            seen.append(("/v1/completions", resp["status"]))
            if resp["status"] != 400:
                raise AssertionError(f"[http] {body}: {resp['status']}")
        resp = http_call(port, raw=b"NOT HTTP\r\n\r\n")
        seen.append(("malformed", resp["status"]))
        if resp["status"] != 400 or len(sched.results) != n_results \
                or sched.queue:
            raise AssertionError("[http] an invalid body reached the "
                                 "scheduler")
        log(f"  [http] 504 on an expired deadline (stream and unary); "
            f"{len(bad) + 1} invalid requests -> 400, none submitted")

        # /metrics against what the clients saw
        got = scrape(port)
        want_series = {
            "repro_tokens_generated_total": n_streamed,
            'repro_requests_total{outcome="length"}': len(mixed) + 1,
            'repro_requests_total{outcome="deadline"}': 2,
            "repro_deadline_expired_total": 2,
            "repro_requests_shed_total": 0}
        for route, code in set(seen):
            want_series[f'repro_http_requests_total{{route="{route}",'
                        f'code="{code}"}}'] = seen.count((route, code))
        wrong = {k: (got.get(k, 0), v) for k, v in want_series.items()
                 if got.get(k, 0) != v}
        extra = [k for k in got if k.startswith(("repro_requests_total{",
                                                 "repro_http_requests_total{"))
                 and k not in want_series]
        prefill = (got.get('repro_prefill_tokens_total{source="computed"}', 0)
                   + got.get('repro_prefill_tokens_total{source="cached"}', 0))
        if wrong or extra or prefill != prompt_tokens + len(r0.prompt):
            raise AssertionError(f"[http] /metrics: {wrong}, unexpected "
                                 f"{extra}, prefill tokens {prefill} != "
                                 f"{prompt_tokens + len(r0.prompt)}")
        log(f"  [http] /metrics: tokens {n_streamed}, outcomes length "
            f"{len(mixed) + 1} / deadline 2, prefill tokens computed + "
            f"cached = {prefill:.0f} = the prompts', "
            f"repro_http_requests_total by route and code = the clients' "
            f"{len(seen)} responses")

        # each engine histogram beside this run's own timing of the work
        rows = [("repro_prefill_chunk_seconds", reg,
                 f"a synchronized 128-token chunk {serve['prefill_chunk_ms']:.2f}"
                 f" ms (phase 4)"),
                ("repro_decode_step_seconds", reg,
                 f"the same samples' exact p50 "
                 f"{percentile(sched.decode_seconds, 50) * 1e3:.2f} ms; a "
                 f"synchronized decode step with no chunk in flight "
                 f"{serve['decode_step_ms_p50']:.2f} ms (phase 4)"),
                ("repro_spec_draft_seconds", REGISTRY,
                 "phase 4d's draft step p50s (greedy, sampled, LOP) "
                 + ", ".join(f"{spec[k]['draft_ms']:.2f}" for k in
                             ("greedy", "sampled", "lop")) + " ms"),
                ("repro_spec_verify_seconds", REGISTRY,
                 "phase 4d's verify p50s through the host's finiteness read"
                 " (greedy, sampled, LOP) "
                 + ", ".join(f"{spec[k]['verify_ms']:.2f}" for k in
                             ("greedy", "sampled", "lop")) + " ms")]
        hist = {}
        for name, r, beside in rows:
            h = r.histogram(name).labels()
            hist[name] = dict(count=h.count, p50_ms=h.quantile(0.5) * 1e3)
            where = ("phase 4d's runs, process registry" if r is REGISTRY
                     else "this run")
            log(f"  {name}: count {h.count}, p50 {hist[name]['p50_ms']:.2f} "
                f"ms (bucket estimate, {where}) beside {beside} [{card}]")
    del sched

    # ---- one lane, a bound of one: 429, then a disconnect frees the lane
    reg1 = MetricsRegistry()
    one = Scheduler(engine, n_slots=1, max_queue=1, metrics=reg1)
    with served(one, registry=reg1) as srv:
        holder = replace(mixed[2], prompt=mixed[2].prompt[:200],
                         max_new_tokens=1000, sampling=SamplingParams())
        s = socket.create_connection(("127.0.0.1", srv.port),
                                     timeout=HTTP_TIMEOUT)
        payload = json.dumps(body_of(holder)).encode()
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(payload), payload))
        got = b""
        while got.count(b"data: {") < 2:
            chunk = s.recv(4096)
            if not chunk:
                raise AssertionError("[1 slot] the holder's stream ended")
            got += chunk
        waiter = {}
        wt = threading.Thread(target=lambda: waiter.update(
            http_call(srv.port, body_of(mixed[1]))))
        wt.start()
        t_end = time.monotonic() + HTTP_TIMEOUT
        while not one.queue:
            if time.monotonic() > t_end:
                raise AssertionError("[1 slot] the waiter never queued")
            time.sleep(0.005)
        shed = http_call(srv.port, body_of(mixed[3], stream=False))
        s.close()                               # the holder walks away
        wt.join(timeout=HTTP_TIMEOUT)
        if wt.is_alive():
            raise AssertionError("[1 slot] the waiter timed out")
        if shed["status"] != 429 or shed["headers"].get("Retry-After") != "1":
            raise AssertionError(f"[1 slot] overload: {shed['status']} "
                                 f"{shed['headers']}")
        res = {r.rid: r for r in one.results}
        frames, done, _ = sse_frames(waiter["body"])
        toks = [f["choices"][0]["token"] for f in frames]
        cancelled = [r for r in res.values() if r.finish_reason == "cancelled"]
        if len(cancelled) != 1 or not 2 <= len(cancelled[0].tokens) < 1000 \
                or waiter["status"] != 200 or not done or toks != want[1] \
                or reg1.value("repro_http_client_disconnects_total") < 1 \
                or reg1.value("repro_requests_shed_total") != 1:
            raise AssertionError(
                f"[1 slot] disconnect/reuse: {[(r.rid, r.finish_reason, len(r.tokens)) for r in res.values()]}, "
                f"waiter {waiter['status']} == direct {toks == want[1]}")
        log(f"  [1 slot, max_queue 1] 429 with Retry-After: 1 while a stream "
            f"held the lane and one waited; the holder's disconnect after "
            f"{len(cancelled[0].tokens)} tokens cancelled its lane, and the "
            f"waiter took it and streamed rid 1 bitwise the direct run")
    return dict(http_tokens_per_s=h_tps, direct_tokens_per_s=d_tps,
                http_ttft_p50_ms=c_ttft * 1e3,
                http_sched_ttft_p50_ms=s_ttft * 1e3,
                direct_ttft_p50_ms=d_ttft * 1e3, http_peak_bytes=h_peak,
                direct_peak_bytes=d_peak, histograms=hist)


def chaos_trace(np, vocab: int):
    """``tests/test_faults.py``'s 200-request chaos trace, draw for draw,
    with one change: the shared prefix is CHAOS_SHARED tokens (8 of
    bitnet-3b's 128-token blocks), not 32. 32 tokens are less than one
    block, so at full width the store would intern nothing; and the
    plan's page flip is drawn for the 8th interned block (insert call 7),
    so the prefix must span 8 blocks for it to fire. → (requests, cancel
    tokens by rid)."""
    from repro_torch.serving.api import CancelToken, GenerateRequest
    rng = np.random.default_rng(41)
    shared = rng.integers(0, vocab, (CHAOS_SHARED,)).astype(np.int32)
    reqs, cancels = [], {}
    for rid in range(200):
        plen = int(rng.integers(6, 15))
        prompt = rng.integers(0, vocab, (plen,)).astype(np.int32)
        if rid % 10 == 0:
            prompt = np.concatenate([shared, prompt])
        tok = CancelToken() if rid % 41 == 3 else None
        if tok is not None:
            cancels[rid] = tok
        reqs.append(GenerateRequest(
            rid=rid, prompt=prompt, max_new_tokens=3, cancel=tok,
            deadline_ms=150.0 if rid % 23 == 5 else None))
    return reqs, cancels


def chaos_run(np, dense, label: str) -> dict:
    """The trace once: 4 slots, a bound of 150, the virtual clock moved
    10 ms a cycle, ``check_invariants`` after every step,
    ``FaultPlan.random(31, ...)`` injected; a cancel fires once its lane
    holds 2 tokens. → dict."""
    from repro_torch.kernels import ops
    from repro_torch.serving import faults
    from repro_torch.serving.metrics import MetricsRegistry
    from repro_torch.serving.scheduler import Scheduler

    reqs, cancels = chaos_trace(np, dense.cfg.vocab)
    plan = faults.FaultPlan.random(31, n_decode_calls=160, n_lanes=4,
                                   nan_events=6, page_flips=1,
                                   lookup_fails=2)
    t = [0.0]
    sched = Scheduler(dense, n_slots=N_SLOTS, max_queue=150,
                      clock=lambda: t[0], check_invariants=True,
                      metrics=MetricsRegistry())
    ops.reset_launch_counts()
    w0 = time.monotonic()
    with faults.inject(plan) as st:
        for r in reqs:
            sched.submit(r)
        steps = 0
        while sched.has_work():
            sched.admit()
            sched.step()
            t[0] += 0.01
            for rid, tok in cancels.items():
                lane = next((ln for ln in sched.lanes
                             if ln is not None and ln.req.rid == rid), None)
                if lane is not None and len(lane.tokens) >= 2:
                    tok.cancel()
            steps += 1
            if steps >= 2000:
                raise AssertionError(f"[{label}] exceeded its step budget")
    wall = time.monotonic() - w0
    counts = ops.launch_counts()
    check_counts(counts, label, ("fused_qlinear", "fused_ffn",
                                 "fused_prefill_attention", DENSE),
                 idle=("fused_decode_attention",))
    res = {r.rid: r for r in sched.results}
    reasons = {}
    for r in res.values():
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    store = sched.prefix_store
    log(f"  [{label}] {steps} steps in {wall:.1f} s: {dict(sorted(reasons.items()))}; "
        f"fault events {sched.fault_events}, recovered "
        f"{sched.fault_recoveries}, gave up {sched.fault_finishes}; injected "
        f"NaNs {st.injected_nan}, page flips {st.injected_flips} (checksum "
        f"failures {store.checksum_failures}), lookup outages "
        f"{st.injected_lookup_failures}; prefix hits {sched.prefix_hits}; "
        f"tokens sha256 {tokens_digest(res)}")
    return dict(reqs=reqs, res=res, reasons=reasons, sched=sched, st=st,
                store=store, wall=wall)


def chaos_phase(torch, np, dense, card) -> dict:
    """Phase 4g, chaos: the 200-request trace on the no-LOP engine, twice.
    Gates (the reference test's): every request terminal; exactly 50
    shed; at least 1 deadline and 1 cancelled; at least 100 length; fault
    events, recoveries and injected NaNs at least 1; the two runs bitwise
    alike in every stream, reason and fault count; the first 8
    length-finished streams each equal their lockstep run."""
    from repro_torch.serving.scheduler import lockstep_generate

    terminal = {"eos", "stop", "length", "cancelled", "deadline", "shed",
                "fault"}
    a = chaos_run(np, dense, "chaos run 1")
    b = chaos_run(np, dense, "chaos run 2")
    sa, r = a["sched"], a["reasons"]
    if len(a["res"]) != 200 or not set(r) <= terminal \
            or r.get("shed", 0) != 50 or r.get("deadline", 0) < 1 \
            or r.get("cancelled", 0) < 1 or r.get("length", 0) < 100 \
            or sa.fault_events < 1 or sa.fault_recoveries < 1 \
            or a["st"].injected_nan < 1:
        raise AssertionError(f"chaos gates: {len(a['res'])} results {r}, "
                             f"fault events {sa.fault_events}, recoveries "
                             f"{sa.fault_recoveries}, NaNs "
                             f"{a['st'].injected_nan}")
    sb = b["sched"]
    for rid, x in a["res"].items():
        y = b["res"][rid]
        if (x.tokens, x.finish_reason) != (y.tokens, y.finish_reason):
            raise AssertionError(f"chaos rid {rid}: run 1 {x.finish_reason} "
                                 f"{x.tokens} != run 2 {y.finish_reason} "
                                 f"{y.tokens}")
    if (sa.fault_events, sa.fault_recoveries, sa.fault_finishes) != \
            (sb.fault_events, sb.fault_recoveries, sb.fault_finishes) or \
            a["st"].injected_nan != b["st"].injected_nan:
        raise AssertionError("chaos: the two runs' fault counts differ")
    checked = []
    for req in a["reqs"]:
        x = a["res"][req.rid]
        if x.finish_reason == "length" and len(checked) < 8:
            ref = lockstep_generate(dense, req.prompt, 3)
            if ref != x.tokens:
                raise AssertionError(f"chaos rid {req.rid}: {x.tokens} != "
                                     f"lockstep {ref}")
            checked.append(req.rid)
    log(f"  chaos gates pass, both runs bitwise alike; lockstep-exact rids "
        f"{checked}; {a['wall']:.1f} + {b['wall']:.1f} s [{card}]")
    return dict(reasons=r, fault_events=sa.fault_events,
                recoveries=sa.fault_recoveries,
                page_flips=a["st"].injected_flips,
                checksum_failures=a["store"].checksum_failures,
                walls=(a["wall"], b["wall"]))


# ---------------------------------------------------------------------------
# phase 4e: serve full-width granite-moe-1b-a400m
# ---------------------------------------------------------------------------

def prefill_ms_by_length(torch, np, engine, lengths, reps: int = 3,
                         warm: bool = True) -> dict:
    """Host ms of one exact-length, batch-1 whole-prompt prefill (ending in
    a synchronize), the median of ``reps`` after one warm call (none
    without ``warm``: an engine that has served prompts of every length
    already), by length."""
    rng = np.random.default_rng(SEED)
    out = {}
    for s in lengths:
        prompt = rng.integers(0, engine.cfg.vocab, (1, s)).astype(np.int32)
        times = []
        for _ in range(reps + warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.prefill(prompt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[s] = float(np.median(times[int(warm):]) * 1e3)
    return out


def moe_kernel_checks(torch, np, engine, pool, card: str) -> None:
    """#1 (E = 1), #3, #4 and #5 at granite's shapes, which phase 3 holds
    only at bitnet-3b's (G = 1, dh 100, d 3200): here G = 2, dh 64, d
    1024, and #3 over the exact-length prompt's key view round_up(S, 128).
    Each goes through its ops entry, as the engine calls it, on one
    layer's served weights and the int8 K/V that the greedy run left in
    the pool (features recomputed: retiring a lane zeroes them), with
    seeded activations and queries, and is held against its plain version
    at phase 3's tolerance (#1 bitwise). Called outside every counted
    window."""
    from repro_torch.configs.base import resolve_decode_flags
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.models.moe import route
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.cache import round_up
    from repro_torch.serving.lop_select import k_keep_blocks

    cfg = resolve_decode_flags(engine.cfg)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    layer = cfg.n_layers // 2
    h, hkv, dh, blk = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.lop_block
    scale = dh ** -0.5
    errs = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- #1, E = 1: QKV and O at the decode rows and one whole prompt ----
    lp = layer_slice(engine.qp["layers"]["attn"], layer)
    for name in ("wqkv", "wo"):
        node = lp[name]
        k, n = node["packed"].shape[-2] * 4, node["packed"].shape[-1]
        for m in (N_SLOTS, MAX_PROMPT):
            x = t(rng.standard_normal((m, k)).astype(np.float32))
            got = ops.qlinear_fused(x, node["packed"], node["scale"],
                                    node.get("b"))
            want = plain.qlinear_ref(x, node["packed"],
                                     ops._col_scale(node["scale"], n),
                                     node.get("b"))
            errs[f"fused_qlinear {name} m={m} k={k} n={n}"] = check_close(
                torch, f"fused_qlinear[granite {name}, m={m}]", got, want,
                bitwise=True)

    # ---- #3: exact-length prompts over their block roundup (one a
    #      multiple of the block, one not) ----
    kv = {key: pool["layers"][key][layer] for key in ("k", "v", "k_scale",
                                                       "v_scale")}
    for s in (MAX_PROMPT, MAX_PROMPT * 2 // 3 - 1):
        m_att = min(kv["k"].shape[2], round_up(s, blk))
        qi = t(rng.integers(-127, 128, (1, h, s, dh)).astype(np.int8))
        qsc = t((rng.random((1, h, s)) * 0.02 + 0.001).astype(np.float32))
        view = [kv[key][:1, :, :m_att] for key in ("k", "v", "k_scale",
                                                   "v_scale")]
        kv_len = torch.full((1,), s, dtype=torch.int32, device=dev)
        got = ops.prefill_attention(qi, qsc, *view, kv_len, causal=True,
                                    window=cfg.swa_window,
                                    int8_logits=cfg.int8_logits)
        want = plain.prefill_attention_ref(
            qi, qsc, *view, kv_len, 0, causal=True, window=cfg.swa_window,
            softmax_scale=scale, int8_logits=cfg.int8_logits)
        errs[f"fused_prefill_attention S={s} M={m_att}"] = check_close(
            torch, f"fused_prefill_attention[granite, S={s}]", got, want)

    # ---- #4 LOP and #5 dense: the pool's lanes, one of them retired ----
    m = kv["k"].shape[2]
    k_keep = max(1, min(k_keep_blocks(cfg, m), m // blk))
    feat = pack_features(lop_features(kv["k"]))
    new_len = torch.tensor([1600, 0, 700, 1200], dtype=torch.int32,
                           device=dev)
    qi = t(rng.integers(-127, 128, (N_SLOTS, h, dh)).astype(np.int8))
    qsc = t((rng.random((N_SLOTS, h, 1)) * 0.02 + 0.001).astype(np.float32))
    for name, use_lop in (("fused_decode_attention", True), (DENSE, False)):
        kw = dict(block=blk, k_keep=k_keep, window=cfg.swa_window,
                  use_lop=use_lop, shared_select=cfg.gqa_shared_select)
        args = (qi, qsc, kv["k"], kv["v"], kv["k_scale"], kv["v_scale"],
                feat, new_len)
        got = ops.decode_attention(*args, **kw)
        want = plain.decode_attention_ref(*args, softmax_scale=scale, **kw)
        errs[f"{name} B={N_SLOTS} M={m} k_keep={k_keep} shared_select="
             f"{bool(cfg.gqa_shared_select)}"] = check_close(
            torch, f"{name}[granite]", got, want)
        if got[1].any():
            raise AssertionError(f"{name}[granite]: retired lane not zero")
    # the router is formed in float64 (models/moe.py) so that a token's
    # routing does not depend on how many tokens share the call: shown
    # here against cuBLAS's f32 product of the same rows
    router = engine.qp["layers"]["moe"]["router"][layer]
    x = t(rng.standard_normal((MAX_PROMPT, cfg.d_model)).astype(np.float32))
    alone, one = route(cfg, router, x[:1]), x[:1] @ router
    f32_moved = {}
    for n_tok in (N_SLOTS, 8, MAX_PROMPT):
        shared = route(cfg, router, x[:n_tok])
        if not all(torch.equal(a[0], b[0]) for a, b in zip(alone[:4],
                                                           shared[:4])):
            raise AssertionError(f"route: token 0 alone differs from token "
                                 f"0 among {n_tok}")
        f32_moved[n_tok] = int((one[0] != (x[:n_tok] @ router)[0]).sum())
    log(f"  router rows (d {cfg.d_model}, E {cfg.n_experts}): the port's "
        f"route of token 0 bitwise alone and among {N_SLOTS}, 8 and "
        f"{MAX_PROMPT} tokens; an f32 cuBLAS product would move "
        + ", ".join(f"{v} of its {cfg.n_experts} logits among {k}"
                    for k, v in f32_moved.items()) + f" [{card}]")
    log(f"  kernels at granite's shapes (H {h} over Hkv {hkv}, dh {dh}, "
        f"layer {layer}'s weights and served K/V), against the plain "
        f"versions at rtol=atol={TOL['rtol']} (#1 bitwise): "
        + "; ".join(f"{k_} max |err| {v:.3g}" for k_, v in errs.items())
        + f" [{card}]")


def moe_phase(torch, np, card: str) -> dict:
    """Phase 4e: granite-moe-1b-a400m at full width (d 1024, 16 heads of
    64 over 8 KV heads, 32 experts top-8, d_ff 512), its first
    ``MOE_LAYERS`` of 24 layers (the smoke run's time), through the
    run-to-completion regime: phase 4's 8 requests greedy with LOP, then on a no-LOP engine sharing the weights, then sampled. Each
    run: every kernel of its path launched, #2 only in its grouped-expert
    form, scheduler == lockstep for 2 rids; the decode step in CUDA graphs
    bitwise its eager twin, 2 / 1 / 1 launches a layer of #1 / #2 (E =
    32) / the decode kernel a step. → stats."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.qlinear import \
        launch_shape as qlinear_launch_shape
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.moe import capacity
    from repro_torch.serving.api import (GenerateRequest, PooledEngine,
                                         SamplingParams)
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("granite-moe-1b-a400m").replace(n_layers=MOE_LAYERS)
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=MAX_PROMPT + GEN,
                                    device="cuda")
    torch.cuda.synchronize()
    experts = tree_bytes(engine.qp["layers"]["moe"])
    weights = tree_bytes(engine.qp)
    pool = tree_bytes(engine.init_pool(N_SLOTS))
    log(f"  seeded granite-moe-1b-a400m weights ready in "
        f"{time.monotonic() - t0:.1f} s: serving weights "
        f"{weights / 2**30:.3f} GiB (experts {experts / 2**20:.1f} MiB), a "
        f"{N_SLOTS}-slot pool {pool / 2**20:.1f} MiB; the earlier phases "
        f"keep {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"in all; exact_length_prefill="
        f"{engine.exact_length_prefill}, supports_chunked="
        f"{engine.supports_chunked}, prefix_block={engine.prefix_block}")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    c_dec, c_max = capacity(cfg, N_SLOTS), capacity(cfg, MAX_PROMPT)
    gate_up = qlinear_launch_shape(c_dec, cfg.d_model, cfg.d_ff, gated=True,
                                   experts=cfg.n_experts)
    log(f"  #2 per decode step: E={cfg.n_experts} x C={c_dec} rows, gate‖up "
        f"GEMM {fmt_shape(gate_up)}; a {MAX_PROMPT}-token prompt: "
        f"C={c_max}")

    out = {}
    dense = PooledEngine(cfg, engine.qp, max_len=engine.max_len,
                         use_lop=False, device="cuda")
    # one LOP candidate set a kv head (G 2): a config field, as a served
    # config would set it
    shared = PooledEngine(cfg.replace(gqa_shared_select=True), engine.qp,
                          max_len=engine.max_len, device="cuda")

    def sp(rid):
        return SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=rid)
    arms = (("moe LOP greedy", engine, reqs, None),
            ("moe no-LOP greedy", dense, reqs, None),
            ("moe LOP sampled", engine,
             [replace(r, sampling=sp(r.rid)) for r in reqs], sp),
            ("moe LOP greedy shared_select", shared, reqs, None))
    for label, eng, rq, sampling in arms:
        attn = "fused_decode_attention" if eng.use_lop else DENSE
        run = serve_run(torch, np, eng, rq, label, card)
        check_counts(run["counts"], label,
                     ("fused_qlinear", "fused_ffn_experts",
                      "fused_prefill_attention", attn),
                     idle=("fused_ffn", "fused_qlinear_experts",
                           "fused_decode_attention" if attn == DENSE
                           else DENSE))
        check_tokens(cfg, run["results"], GEN, label)
        check_lockstep(eng, rq, run["results"], (0, 1), label)
        sched = run.pop("sched")
        if eng is not dense and sampling is None:
            moe_kernel_checks(torch, np, eng, sched.pool, card)
        log(f"  [{label}] {len(sched.full_prefill_seconds)} exact-length "
            f"prefills, p50 "
            f"{np.percentile(sched.full_prefill_seconds, 50) * 1e3:.1f} ms, "
            f"{sched.full_prefill_stalls} stalled the decoding lanes "
            f"(full_prefill_stalls)")
        step = decode_arms(torch, np, eng, reqs, label, card,
                           sampling=sampling)
        if eng is engine and sampling is None:
            profile_arms(torch, step, label, card)
        out[label] = dict(
            counts=run["counts"], tokens=tokens_digest(run["results"]),
            tokens_per_s=run["tokens_per_s"],
            ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
            full_prefill_stalls=sched.full_prefill_stalls,
            decode_step_ms_p50=step["ms"],
            eager_decode_step_ms_p50=step["eager_ms"])
        del run, sched, step
    by_len = prefill_ms_by_length(torch, np, engine, (128, 512, 1024, 1536))
    log("  exact-length prefill (batch 1, host ms to a synchronize): "
        + ", ".join(f"{s} tokens {ms:.1f} ms" for s, ms in by_len.items())
        + f" [{card}]")
    g = out["moe LOP greedy"]
    log(f"  moe decode step (B={N_SLOTS}), CUDA graph (eager): LOP greedy "
        f"{g['decode_step_ms_p50']:.2f} ({g['eager_decode_step_ms_p50']:.2f})"
        f" ms, no-LOP "
        f"{out['moe no-LOP greedy']['decode_step_ms_p50']:.2f} "
        f"({out['moe no-LOP greedy']['eager_decode_step_ms_p50']:.2f}) ms, "
        f"sampled {out['moe LOP sampled']['decode_step_ms_p50']:.2f} "
        f"({out['moe LOP sampled']['eager_decode_step_ms_p50']:.2f}) ms "
        f"[{card}]")
    sh = out["moe LOP greedy shared_select"]
    log(f"  moe LOP greedy, per-head selection / shared_select: "
        f"{g['tokens_per_s']:.2f} / {sh['tokens_per_s']:.2f} tok/s, decode "
        f"step (B={N_SLOTS}) CUDA graph {g['decode_step_ms_p50']:.2f} / "
        f"{sh['decode_step_ms_p50']:.2f} ms, eager "
        f"{g['eager_decode_step_ms_p50']:.2f} / "
        f"{sh['eager_decode_step_ms_p50']:.2f} ms; tokens sha256 "
        f"{g['tokens']} / {sh['tokens']} [{card}]")
    return dict(runs=out, prefill_ms=by_len,
                launches={k: g["counts"][k] for k in ("fused_ffn_experts",
                                                      "fused_qlinear_experts")},
                shared_launches=sh["counts"]["fused_decode_attention"])


def expert_ffn_rows(torch, np, rng, node, cs, label: str, card: str,
                    act: str = "silu") -> dict:
    """#2 with the expert axis on one layer's served expert stacks
    ``node`` (gu_packed [E, d/4, 2f], down_packed [E, f/4, d] and their
    γ) at each capacity C of ``cs``: seeded rows x [E, C, d], the first
    ceil(C/2) of every expert live and the rest zero (the dispatch's
    empty slots), through the ops entry as the MoE layer calls it;
    against the plain version run a few experts a call (an expert's rows
    read that expert's weights alone, so the calls' rows are the whole
    call's; at E 16 and f 24,576 the plain version's float64 gate‖up of
    all the experts would be 51.5 GB), zero rows exact zeros; then the
    kernel timed eagerly and in a CUDA graph (L2 cold) beside its bound.
    No PyTorch call computes a batched packed-ternary FFN. → rows by
    C."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import fused_ffn_experts
    from repro_torch.kernels.qlinear import \
        launch_shape as qlinear_launch_shape

    gu, down = node["gu_packed"], node["down_packed"]
    e, d, f2 = gu.shape[0], gu.shape[1] * 4, gu.shape[2]
    f = f2 // 2
    gu_row = ops._col_scale(node["gu_scale"], f2).reshape(e, f2).contiguous()
    down_row = ops._col_scale(node["down_scale"], d).reshape(e, d).contiguous()
    per_call = max(1, int(8e9 // (d * f2 * 8)))   # float64 gate‖up a call

    def ref(x_):
        return torch.cat([plain.ffn_fused_ref(
            x_[i:i + per_call], gu[i:i + per_call], gu_row[i:i + per_call,
                                                         None],
            down[i:i + per_call], down_row[i:i + per_call, None],
            gated=True, act=act) for i in range(0, e, per_call)])

    def kern(*a):
        return fused_ffn_experts(*a, gated=True, act=act)
    rows = {}
    for c in cs:
        live = -(-c // 2)
        xn = rng.standard_normal((e, c, d)).astype(np.float32)
        xn[:, live:] = 0.0
        x = torch.from_numpy(xn).cuda()
        ops.reset_launch_counts()
        got = ops.ffn_fused(x, gu, node["gu_scale"], down,
                            node["down_scale"], gated=True, act=act)
        if ops.launch_counts()["fused_ffn_experts"] != 1:
            raise AssertionError(f"#2 [{label}, C={c}]: not one launch")
        want = ref(x)
        err = check_close(torch, f"fused_ffn_experts[{label}, C={c}]", got,
                          want)
        bitwise = bool(torch.equal(got, want))
        if got[:, live:].any():
            raise AssertionError(f"#2 [{label}, C={c}]: zero rows gave "
                                 f"non-zeros")
        del got, want
        args = (x, gu, gu_row, down, down_row)
        sets = copies(torch, args)
        ms = cuda_ms(torch, kern, sets, 10)
        g_ms = graph_ms(torch, kern, sets, per_graph=5, replays=3)
        del sets
        p_ms = cuda_ms(torch, lambda x_: ref(x_), [(x,)], 1)
        b_ms, b_by = bound_ms(nbytes(*args) + e * c * d * 4,
                              int8_ops=2.0 * e * c * (d * f2 + f * d))
        gate_up = qlinear_launch_shape(c, d, f, gated=True, experts=e)
        down_gemm = qlinear_launch_shape(c, f, d, experts=e)
        log(f"  fused_ffn_experts {label} E={e} C={c} d={d} f={f} ({live} "
            f"live rows an expert; a layer's served experts): max |err| "
            f"{err:.3g}, bitwise={bitwise}, zero rows exact zeros (plain "
            f"version {per_call} experts a call); {ms:.4f} ms, in a CUDA "
            f"graph {g_ms:.4f} ms (plain {p_ms:.2f} ms, bound {b_ms:.4f} ms "
            f"by {b_by}; {b_ms / ms:.1%} of bound, {b_ms / g_ms:.1%} in the "
            f"graph); library: none; gate‖up GEMM {fmt_shape(gate_up)}, "
            f"down GEMM {fmt_shape(down_gemm)} [{card}]")
        rows[f"{label} E={e} C={c}"] = dict(
            max_abs_err=err, bitwise=bitwise, ms=ms, graph_ms=g_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"E={e} C={c} d={d} f={f}")
        del x
    return rows


def kernel_rows(rows: dict, found: dict) -> None:
    """Merge ``found`` (kernel → {shape label: row}) into the kernels
    line's ``rows``: each under ``shapes``, its error into the entry's."""
    for kname, by_shape in found.items():
        rows[kname].setdefault("shapes", {}).update(by_shape)
        rows[kname]["max_abs_err"] = max(
            rows[kname]["max_abs_err"],
            *(r["max_abs_err"] for r in by_shape.values()))


# ---------------------------------------------------------------------------
# phase 4o: mixtral-8x22b at full width and depth
# ---------------------------------------------------------------------------

MIXTRAL_SHORT = 4                  # requests of MIN_PROMPT–MAX_PROMPT tokens
MIXTRAL_LONG = (4200, 4700)        # past swa_window 4096
MIXTRAL_SEED = 8                   # the traffic's request rng
MIXTRAL_NEW_LEN = (4700, 0, 1500, 4200)   # the kernel rows' lanes


def mixtral_requests(np, cfg) -> list:
    """4 requests of 128–1536 prompt tokens, then 2 past the sliding
    window (4200 and 4700), 32 new tokens each; numpy
    default_rng(MIXTRAL_SEED)."""
    from repro_torch.serving.api import GenerateRequest
    rng = np.random.default_rng(MIXTRAL_SEED)
    lens = [*rng.integers(MIN_PROMPT, MAX_PROMPT + 1, MIXTRAL_SHORT).tolist(),
            *MIXTRAL_LONG]
    return [GenerateRequest(rid=rid, prompt=rng.integers(
        0, cfg.vocab, (n,)).astype(np.int32), max_new_tokens=GEN)
        for rid, n in enumerate(lens)]


def mixtral_phase(torch, np, card: str) -> dict:
    """Phase 4o: mixtral-8x22b at full width and depth (56 layers, d 6144,
    48 heads of 128 over 8 KV heads, 8 experts top-2 of f 16,384,
    swa_window 4096), drawn and quantized on the card one layer at a
    time through ``PooledEngine.from_seed``; 4 requests of 128–1536
    tokens and 2 past the window run to completion (each prompt
    prefilled whole at its exact length) on 4 slots, greedy LOP, then
    the 2 long requests on a no-LOP engine sharing the weights. Each run:
    every kernel of its path launched (#2 only in its expert form),
    scheduler == lockstep (LOP: the first and the longest request),
    every prompt one exact-length prefill and no chunk, the run's
    launches those of its prefills and of 112 / 56 / 56 launches of #1 /
    #2 / the decode kernel a step; the LOP decode step on CUDA graphs
    bitwise its eager twin with those launches; #2 (E 8) at the decode C
    and a full
    group's, #4 and #5 on the served pages with lanes past the window
    and #3 over the longest whole prompt against their plain versions
    with times and bounds. → stats, launches and kernel rows."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.cache import capacity_for
    from repro_torch.serving.scheduler import Scheduler

    t_phase = time.monotonic()
    cfg = get_config("mixtral-8x22b")
    reqs = mixtral_requests(np, cfg)
    lens = [len(r.prompt) for r in reqs]
    longest = int(np.argmax(lens))
    max_len = max(lens) + GEN
    cap = capacity_for(cfg, max_len)
    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=max_len,
                                    device="cuda")
    torch.cuda.synchronize()
    drawn_s = time.monotonic() - t0
    draw_peak = torch.cuda.max_memory_allocated() - base
    weights = tree_bytes(engine.qp)
    experts = tree_bytes(engine.qp["layers"]["moe"])
    f32_ends = tree_bytes({k: engine.qp[k] for k in ("embed", "head")})
    log(f"  [mixtral] seeded weights drawn and quantized one layer at a "
        f"time in {drawn_s:.1f} s ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of f {cfg.d_ff}, "
        f"swa_window {cfg.swa_window}, moe_group {cfg.moe_group}, vocab "
        f"{cfg.vocab}): serving weights {weights / 2**30:.3f} GiB (experts "
        f"{experts / 2**30:.3f} GiB, embed and head f32 "
        f"{f32_ends / 2**30:.3f} GiB); peak while drawing "
        f"{draw_peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB the "
        f"earlier phases hold; capacity {cap}; prompt lengths "
        + ", ".join(map(str, lens)) + f" [{card}]")
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    dense = PooledEngine(cfg, engine.qp, max_len=max_len, use_lop=False,
                         device="cuda")
    out, launches, found = {}, {k: 0 for k in KERNEL_NAMES}, {}
    for label, eng, rq, rids in (
            ("mixtral LOP greedy", engine, reqs, (0, longest)),
            ("mixtral no-LOP greedy, the long requests", dense,
             reqs[MIXTRAL_SHORT:], (longest,))):
        attn = "fused_decode_attention" if eng.use_lop else DENSE
        run = serve_run(torch, np, eng, rq, label, card, capacity=cap)
        check_counts(run["counts"], label,
                     ("fused_qlinear", "fused_ffn_experts",
                      "fused_prefill_attention", attn),
                     idle=("fused_ffn", "fused_qlinear_experts",
                           "fused_decode_attention" if attn == DENSE
                           else DENSE))
        check_tokens(cfg, run["results"], GEN, label)
        check_lockstep(eng, reqs, run["results"], rids, label)
        sched = run.pop("sched")
        pre = sched.full_prefill_seconds
        if (sched.chunked or len(pre) != len(rq)
                or sched.prefill_tokens_computed
                != sum(len(r.prompt) for r in rq)):
            raise AssertionError(f"[{label}] {len(pre)} exact-length "
                                 f"prefills of {len(rq)} prompts, "
                                 f"{sched.prefill_tokens_computed} tokens "
                                 f"computed, chunked {sched.chunked}")
        log(f"  [{label}] {len(pre)} exact-length prefills (no chunk), p50 "
            f"{np.percentile(pre, 50) * 1e3:.1f} ms, max "
            f"{max(pre) * 1e3:.1f} ms; {sched.full_prefill_stalls} stalled "
            f"the decoding lanes; pool of {N_SLOTS} slots x {cap} "
            f"{tree_bytes(sched.pool) / 2**30:.3f} GiB [{card}]")
        if eng is engine:
            layer = cfg.n_layers // 2
            cl = {key: sched.pool["layers"][key][layer]
                  for key in ("k", "v", "k_scale", "v_scale")}
            rng = np.random.default_rng(SEED + 34)
            new_len = torch.tensor(MIXTRAL_NEW_LEN, dtype=torch.int32,
                                   device="cuda")
            dec = decode_rows(torch, np, rng, cfg, cl, new_len,
                              f"mixtral layer {layer}'s served pages", card,
                              window=cfg.swa_window)
            found["fused_prefill_attention"] = {
                "mixtral whole prompt, window": prefill_chunk_rows(
                    torch, np, rng, cfg, cl, 0, lens[longest],
                    f"mixtral's {lens[longest]}-token prompt whole", card)}
            found["fused_decode_attention"] = {
                "mixtral G 6, window": dec["fused_decode_attention"]}
            found[DENSE] = {"mixtral G 6, window": dec[DENSE]}
            found["fused_ffn_experts"] = expert_ffn_rows(
                torch, np, rng, layer_slice(engine.qp["layers"]["moe"],
                                            layer),
                (capacity(cfg, N_SLOTS), capacity(cfg, cfg.moe_group)),
                "mixtral", card)
            del cl
        # the run's launches, whole: a decode step's 2 / 1 / 1 a layer of
        # #1 / #2 / the decode kernel, a prefill's 2 #1 and one #3 a layer
        # and one #2 a layer a moe_group of prompt tokens
        n, steps = cfg.n_layers, sched.decode_launches
        groups = sum(-(-len(r.prompt) // cfg.moe_group) for r in rq)
        want = {"fused_qlinear": 2 * n * (steps + len(rq)),
                "fused_ffn_experts": n * (steps + groups),
                "fused_prefill_attention": n * len(rq), attn: n * steps}
        got = {k: run["counts"][k] for k in KERNEL_NAMES
               if run["counts"][k]}
        if got != want:
            raise AssertionError(f"[{label}] launched {got}, want {want} "
                                 f"for {steps} decode steps")
        del sched
        out[label] = dict(
            counts=run["counts"], tokens=tokens_digest(run["results"]),
            tokens_per_s=run["tokens_per_s"],
            ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
            prefill_ms_p50=float(np.percentile(pre, 50) * 1e3),
            serve_cycle_decode_ms_p50=run["serve_cycle_decode_ms_p50"])
        if eng is engine:
            # graph == eager once, on the LOP engine (the no-LOP run's
            # steps are held by its launches above)
            step = decode_arms(torch, np, eng, reqs, label, card)
            out[label].update(decode_step_ms_p50=step["ms"],
                              eager_decode_step_ms_p50=step["eager_ms"])
            del step
        for k in KERNEL_NAMES:
            launches[k] += run["counts"][k]
        del run
        free_cuda(torch)
    by_len = prefill_ms_by_length(torch, np, engine, (lens[longest],),
                                  reps=2, warm=False)
    g, d = out["mixtral LOP greedy"], out[
        "mixtral no-LOP greedy, the long requests"]
    log(f"  [mixtral] LOP greedy {g['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{g['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{g['decode_step_ms_p50']:.2f} ms, eager "
        f"{g['eager_decode_step_ms_p50']:.2f} ms, peak while serving "
        f"{g['peak_bytes'] / 2**30:.2f} GiB; no-LOP (the 2 long requests) "
        f"{d['tokens_per_s']:.2f} tok/s, TTFT p50 {d['ttft_p50_ms']:.1f} ms, "
        f"serve-cycle decode p50 {d['serve_cycle_decode_ms_p50']:.2f} ms; "
        f"one exact-length prefill "
        f"of {lens[longest]} tokens (batch 1, host ms to a synchronize) "
        f"{by_len[lens[longest]]:.1f} ms; tokens sha256 {g['tokens']} / "
        f"{d['tokens']}; phase 4o took {time.monotonic() - t_phase:.1f} s "
        f"[{card}]")
    del engine, dense
    free_cuda(torch)
    return dict(runs=out, launches=launches, rows=found,
                draw_peak_bytes=draw_peak, weights_bytes=weights,
                prefill_ms=by_len)


# ---------------------------------------------------------------------------
# phase 4p: qwen1.5-110b at full width and depth
# ---------------------------------------------------------------------------

QWEN110_REQUESTS = 4               # phase 4's first 4 (the run's time)
QWEN110_NOLOP = 2                  # the shortest, served again no-LOP
QWEN110_STEADY = 384               # the steady lanes' prompt tokens (time)
QWEN110_NEW_LEN = (1600, 0, 700, 1200)   # the decode rows' lanes


def qwen110b_rows(torch, np, engine, pool, card: str) -> dict:
    """qwen1.5-110b's own kernel shapes on layer 0's served weights and
    pages: #1 at O (m 4 and 1536), #2 at d 8192, f 49,152 (m 4 and 128,
    eager and in a CUDA graph), #3 causal over one 1536-token prompt whole
    (64 heads over 8), #4 and #5 at G 8 (B 4, M 1664) — each against its
    plain version, timed beside its bound (and #3, #5 beside SDPA). →
    kernel → {shape label: row}."""
    from repro_torch.models.transformer import layer_slice

    cfg = engine.cfg
    lp = layer_slice(engine.qp["layers"], 0)
    cl = {key: pool["layers"][key][0]
          for key in ("k", "v", "k_scale", "v_scale")}
    rng = np.random.default_rng(SEED + 35)
    o = projection_rows(torch, np, {"O": lp["attn"]["wo"]}, "qwen1.5-110b",
                        "layer 0's served weights", card, SEED + 36)
    ffn = served_ffn_rows(torch, np, lp["ffn"], cfg.d_model, card,
                           rows_m=(N_SLOTS, 128), whose="qwen1.5-110b")
    whole = prefill_chunk_rows(torch, np, rng, cfg, cl, 0, MAX_PROMPT,
                               f"qwen1.5-110b's {MAX_PROMPT}-token prompt "
                               f"whole", card)
    new_len = torch.tensor(QWEN110_NEW_LEN, dtype=torch.int32,
                           device="cuda")
    dec = decode_rows(torch, np, rng, cfg, cl, new_len,
                      "qwen1.5-110b layer 0's served pages", card)
    del cl
    free_cuda(torch)
    return {"fused_qlinear": {f"qwen1.5-110b {k}": v for k, v in o.items()},
            "fused_ffn": {f"qwen1.5-110b {k}": v for k, v in ffn.items()},
            "fused_prefill_attention": {"qwen1.5-110b whole prompt, G 8":
                                        whole},
            "fused_decode_attention": {
                "qwen1.5-110b G 8": dec["fused_decode_attention"]},
            DENSE: {"qwen1.5-110b G 8": dec[DENSE]}}


def qwen110b_nolop(torch, np, engine, reqs, card: str) -> dict:
    """The ``QWEN110_NOLOP`` shortest requests again on a no-LOP engine
    sharing the served weights: #5 at G 8 on the served path, #4 idle."""
    from repro_torch.serving.api import PooledEngine

    label = (f"qwen1.5-110b no-LOP greedy, the {QWEN110_NOLOP} shortest "
             f"requests")
    dense = PooledEngine(engine.cfg, engine.qp, max_len=engine.max_len,
                         use_lop=False, device="cuda")
    short = sorted(reqs, key=lambda r: len(r.prompt))[:QWEN110_NOLOP]
    run = serve_run(torch, np, dense, short, label, card)
    check_counts(run["counts"], label,
                 ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
                  DENSE), idle=("fused_decode_attention",
                                "fused_qlinear_experts", "fused_ffn_experts"))
    check_tokens(engine.cfg, run["results"], GEN, label)
    out = dict(counts=run["counts"], tokens=tokens_digest(run["results"]),
               tokens_per_s=run["tokens_per_s"],
               ttft_p50_ms=run["ttft_p50_ms"])
    del run, dense
    free_cuda(torch)
    return out


def qwen110b_phase(torch, np, card: str) -> dict:
    """Phase 4p: qwen1.5-110b at full width and depth (80 layers, d 8192,
    64 heads of 128 over 8 KV heads: G 8, f 49,152, vocab 152,064, QKV
    bias drawn nonzero), drawn and quantized on the card one layer at a
    time; phase 4's first ``QWEN110_REQUESTS`` requests greedy LOP,
    chunked, through the Scheduler on 4 slots (scheduler == lockstep for
    the shortest, half of #1's launches with the bias); the kernel rows
    at its shapes on layer 0's served weights and pages; the
    ``QWEN110_NOLOP`` shortest requests no-LOP (#5 at G 8); the clean
    decode step (160 / 80 / 80 launches of #1 / #2 / #4) on CUDA graphs
    and eager over the 4 prompts cut to ``QWEN110_STEADY`` tokens. →
    stats, launches and kernel rows."""
    from repro_torch.configs import get_config

    t0 = time.monotonic()
    cfg = get_config("qwen1.5-110b")
    label = f"qwen1.5-110b ({cfg.n_layers} layers) LOP greedy"

    def served(engine, pool, reqs):
        return dict(rows=qwen110b_rows(torch, np, engine, pool, card),
                    nolop=qwen110b_nolop(torch, np, engine, reqs, card))
    out = dense_feature_arm(torch, np, cfg, label, card,
                            bias_seed=SEED + 110,
                            n_requests=QWEN110_REQUESTS, lockstep=None,
                            steady_prompt=QWEN110_STEADY, served=served)
    rows, nolop = out["rows"], out["nolop"]
    rows["fused_qlinear"]["qwen1.5-110b QKV + bias m=4"] = dict(
        out["bias_check"], library_ms=None)
    launches = {k: out["counts"][k] + nolop["counts"][k]
                for k in KERNEL_NAMES}
    log(f"  [qwen1.5-110b] LOP greedy {out['tokens_per_s']:.2f} tok/s, TTFT "
        f"p50 {out['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA "
        f"graph {out['decode_step_ms_p50']:.2f} ms, eager "
        f"{out['eager_decode_step_ms_p50']:.2f} ms, peak while serving "
        f"{out['peak_bytes'] / 2**30:.2f} GiB, draw peak "
        f"{out['init_peak_bytes'] / 2**30:.2f} GiB; no-LOP ("
        f"{QWEN110_NOLOP} requests) {nolop['tokens_per_s']:.2f} tok/s, TTFT "
        f"p50 {nolop['ttft_p50_ms']:.1f} ms; tokens sha256 {out['tokens']} /"
        f" {nolop['tokens']}; phase 4p took {time.monotonic() - t0:.1f} s "
        f"[{card}]")
    return dict(out, nolop=nolop, rows=rows, launches=launches,
                bias=out["counts"]["fused_qlinear:bias"]
                + nolop["counts"]["fused_qlinear:bias"])


# ---------------------------------------------------------------------------
# phase 4h: the dense family's LayerNorm and QKV bias; the encdec family
# ---------------------------------------------------------------------------

QWEN_LAYERS = 8                    # of 64 (the run's time; 4p holds the
                                   # QKV bias at full depth)
STABLELM_LAYERS = 6                # of 24 (the smoke run's time)
WHISPER_MAX_LEN = 448              # whisper's decoder context
WHISPER_FRAMES = 1500              # a full 30-s window (cross_ctx)
WHISPER_MIN_PROMPT, WHISPER_MAX_PROMPT = 4, 64


def free_cuda(torch) -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def qkv_bias_check(torch, np, qp, card: str) -> dict:
    """#1 at the fused QKV shape with its bias, on layer 0's served
    weights (the bias drawn nonzero): bitwise the plain version, timed
    eagerly and in a CUDA graph beside its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import fused_qlinear
    from repro_torch.models.transformer import layer_slice

    node = layer_slice(qp["layers"]["attn"], 0)["wqkv"]
    k, n = node["packed"].shape[0] * 4, node["packed"].shape[1]
    if not node["b"].any():
        raise AssertionError("qwen's QKV bias is all zero")
    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.standard_normal((N_SLOTS, k)).astype(
        np.float32)).cuda()
    gamma = ops._col_scale(node["scale"], n)
    got = ops.qlinear_fused(x, node["packed"], node["scale"], node["b"])
    want = plain.qlinear_ref(x, node["packed"], gamma, node["b"])
    err = check_close(torch, "fused_qlinear[qwen QKV + bias]", got, want,
                      bitwise=True)
    args = (x, node["packed"].contiguous(), gamma.reshape(n).contiguous(),
            node["b"].contiguous())
    sets = copies(torch, args)
    ms = cuda_ms(torch, fused_qlinear, sets, 30)
    g_ms = graph_ms(torch, fused_qlinear, sets)
    p_ms = cuda_ms(torch, lambda x_, p_, g_, b_: plain.qlinear_ref(
        x_, p_, g_[None], b_), [args], 3)
    b_ms, b_by = bound_ms(nbytes(*args) + N_SLOTS * n * 4,
                          int8_ops=2.0 * N_SLOTS * k * n)
    log(f"  fused_qlinear QKV + bias (m={N_SLOTS}, k={k}, n={n}, layer 0's "
        f"served weights): bitwise the plain version; {ms:.4f} ms, in a "
        f"CUDA graph {g_ms:.4f} ms (plain {p_ms:.3f} ms, bound {b_ms:.4f} "
        f"ms by {b_by}; {b_ms / ms:.1%} of bound, {b_ms / g_ms:.1%} in the "
        f"graph) [{card}]")
    return dict(max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by,
                shape=f"m={N_SLOTS} k={k} n={n}")


def dense_feature_arm(torch, np, cfg, label: str, card: str,
                      bias_seed: int | None = None,
                      n_requests: int = N_REQUESTS, lockstep=(0, 1),
                      steady_prompt: int | None = None,
                      served=None) -> dict:
    """One dense model at full width through phase 4's traffic: seeded
    weights drawn and quantized on the card one layer at a time
    (``bias_seed``: the QKV biases drawn nonzero from a generator of that
    seed, the values a draw onto the master tree gave); then the first
    ``n_requests`` of phase 4's requests greedy LOP through the Scheduler
    on 4 slots (chunked), scheduler == lockstep for the rids ``lockstep``
    (None: the shortest prompt's), then
    ``served(engine, pool, reqs)`` (more arms on the served weights and
    pages; its dict joins the stats), and the clean decode step (over the
    4 shortest prompts, cut to ``steady_prompt`` tokens when given) on
    CUDA graphs and eager with its launches.
    → stats."""
    from dataclasses import replace

    from repro_torch.launch.serve import make_requests
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.quantize import init_serving_params
    from repro_torch.serving.scheduler import Scheduler

    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    qp = init_serving_params(cfg, SEED, "cuda")
    if bias_seed is not None:
        # the stacked biases [L, n] of wq, wk, wv drawn in that order, as
        # onto the master tree before quantization, then fused as
        # quantize_params fuses them (concatenated)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(bias_seed)
        n = cfg.n_layers
        qp["layers"]["attn"]["wqkv"]["b"].copy_(torch.cat([
            torch.randn((n, width), generator=gen, device="cuda") * 0.02
            for width in (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)], dim=-1))
    free_cuda(torch)
    init_peak = torch.cuda.max_memory_allocated()
    engine = PooledEngine(cfg, qp, max_len=MAX_PROMPT + GEN, device="cuda")
    log(f"  [{label}] seeded weights ready in {time.monotonic() - t0:.1f} s"
        f" ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.hd}, ffn {cfg.d_ff}, vocab {cfg.vocab}, norm {cfg.norm}, "
        f"qkv_bias {cfg.qkv_bias}): serving weights "
        f"{tree_bytes(qp) / 2**30:.3f} GiB; peak while drawing and "
        f"quantizing one layer at a time {(init_peak - base) / 2**30:.2f} "
        f"GiB above the "
        f"{base / 2**30:.2f} GiB the earlier phases hold [{card}]")
    reqs = make_requests(cfg, n_requests=n_requests, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    by_len = sorted(reqs, key=lambda r: len(r.prompt))
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    out = {}
    if bias_seed is not None:
        out["bias_check"] = qkv_bias_check(torch, np, qp, card)
    run = serve_run(torch, np, engine, reqs, label, card)
    check_counts(run["counts"], label, LOP_PATH,
                 idle=(DENSE, "fused_qlinear_experts", "fused_ffn_experts"))
    check_tokens(cfg, run["results"], GEN, label)
    pool = tree_bytes(run["sched"].pool)
    log(f"  [{label}] served tree {tree_bytes(qp) / 2**30:.3f} GiB, pool "
        f"of {N_SLOTS} slots x {run['sched'].capacity} "
        f"{pool / 2**30:.3f} GiB ({pool / (N_SLOTS * run['sched'].capacity) / 1e3:.1f}"
        f" KB a token), draw peak {(init_peak - base) / 2**30:.2f} GiB [{card}]")
    check_lockstep(engine, reqs, run["results"],
                   (by_len[0].rid,) if lockstep is None else lockstep, label)
    bias = run["counts"].get("fused_qlinear:bias", 0)
    if cfg.qkv_bias and 2 * bias != run["counts"]["fused_qlinear"]:
        raise AssertionError(f"[{label}] {bias} of "
                             f"{run['counts']['fused_qlinear']} #1 launches "
                             f"carried the QKV bias, want half")
    if served is not None:
        out.update(served(engine, run["sched"].pool, reqs))
    # the steady lanes: the 4 shortest prompts (each arm of the step
    # prefills them eagerly), cut to steady_prompt tokens when given
    steady = [r if steady_prompt is None else
              replace(r, prompt=r.prompt[:steady_prompt]) for r in by_len]
    step = decode_arms(torch, np, engine, steady, label, card)
    out.update(counts=run["counts"], tokens=tokens_digest(run["results"]),
               tokens_per_s=run["tokens_per_s"],
               ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
               init_peak_bytes=init_peak - base,
               decode_step_ms_p50=step["ms"],
               eager_decode_step_ms_p50=step["eager_ms"])
    del run, step, engine, qp
    free_cuda(torch)
    return out


def whisper_requests(np, cfg) -> list:
    """8 requests (numpy default_rng(2)): a 4–64-token decoder prompt and
    1500 encoder frames of 0.02·N(0, 1) each, 32 new tokens."""
    from repro_torch.serving.api import GenerateRequest
    rng = np.random.default_rng(2)
    reqs = []
    for rid in range(N_REQUESTS):
        plen = int(rng.integers(WHISPER_MIN_PROMPT, WHISPER_MAX_PROMPT + 1))
        prompt = rng.integers(0, cfg.vocab, (plen,)).astype(np.int32)
        frames = (rng.standard_normal((WHISPER_FRAMES, cfg.d_model))
                  .astype(np.float32) * 0.02)
        reqs.append(GenerateRequest(rid=rid, prompt=prompt,
                                    max_new_tokens=GEN, frames=frames))
    return reqs


def prefill_row(torch, np, rng, label, k, v, ks, vs, kv_len, c, dh,
                card) -> dict:
    """#3 non-causal: seeded int8 queries [1, H, c, dh] over the given K/V
    view, through the ops entry as the engine calls it, against the plain
    version, then the kernel timed alone (CUDA events, L2 cold) beside
    its bound and SDPA on the dequantized tensors."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.prefill_attention import fused_prefill_attention

    h, m = k.shape[1], k.shape[2]
    dev = k.device
    qi = torch.from_numpy(rng.integers(-127, 128, (1, h, c, dh)).astype(
        np.int8)).to(dev)
    qsc = torch.from_numpy((rng.random((1, h, c)) * 0.02 + 0.001).astype(
        np.float32)).to(dev)
    kvl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    got = ops.prefill_attention(qi, qsc, k, v, ks, vs, kvl, causal=False)
    want = plain.prefill_attention_ref(qi, qsc, k, v, ks, vs, kvl, 0,
                                       causal=False, window=0,
                                       softmax_scale=scale)
    err = check_close(torch, f"fused_prefill_attention[{label}]", got, want)
    args = (qi[0].contiguous(), qsc[0].contiguous(), k[0].contiguous(),
            v[0].contiguous(), ks[0].contiguous(), vs[0].contiguous(), kvl)

    def kern(*a):
        return fused_prefill_attention(*a, hkv=h, chunk=c, causal=False,
                                       window=0, softmax_scale=scale)
    ms = cuda_ms(torch, kern, copies(torch, args), 20)
    p_ms = cuda_ms(torch, lambda *a: plain.prefill_attention_ref(
        *(t[None] for t in a[:6]), a[6], 0, causal=False, window=0,
        softmax_scale=scale), [args], 2)
    pairs = c * kv_len
    b_ms, b_by = bound_ms(nbytes(qi, qsc) + h * kv_len * (2 * dh + 8)
                          + h * c * dh * 4,
                          int8_ops=2.0 * h * pairs * dh,
                          f32_ops=2.0 * h * pairs * dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qf = qi.float() * qsc[..., None]
    kf = k[:, :, :kv_len].float() * ks[:, :, :kv_len, None]
    vf = v[:, :, :kv_len].float() * vs[:, :, :kv_len, None]
    lib_ms = cuda_ms(torch, sdpa, [(qf, kf, vf)], 10)
    log(f"  fused_prefill_attention {label} (non-causal, C={c}, M={m}, "
        f"kv_len {kv_len}, H {h}, dh {dh}): max |err| {err:.3g}; {ms:.4f} ms"
        f" (plain {p_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"by {b_by}; {b_ms / ms:.1%} of bound) [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"C={c} M={m} kv_len={kv_len} H={h} dh={dh}")


def decode_rows(torch, np, rng, cfg, cl, new_len, label: str,
                card: str, window: int = 0) -> dict:
    """#4 (LOP) and #5 (dense) over one layer's pages ``cl`` (B, Hkv, M,
    dh) at ``cfg``'s query heads (G = H / Hkv rows a kv lane) and
    ``new_len`` (keys in the last ``window`` positions only, when set),
    seeded queries, features recomputed (retiring a lane zeroes them),
    through the ops entry against the plain version (the pages
    untouched), then each kernel timed eagerly and in a CUDA graph beside
    its bound (the blocks and live tokens the plain selection reads on
    these inputs; a window's keys alone)."""
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.decode_attention import (
        fused_decode_attention, fused_dense_decode_attention)
    from repro_torch.serving.lop_select import k_keep_blocks

    b, hkv, m, dh = cl["k"].shape
    h = cfg.n_heads
    g = h // hkv
    blk = cfg.lop_block
    k_keep = max(1, min(k_keep_blocks(cfg, m), m // blk))
    dev = cl["k"].device
    feat = pack_features(lop_features(cl["k"]))
    qi = torch.from_numpy(rng.integers(-127, 128, (b, h, dh)).astype(
        np.int8)).to(dev)
    qsc = torch.from_numpy((rng.random((b, h, 1)) * 0.02 + 0.001).astype(
        np.float32)).to(dev)
    scale = dh ** -0.5
    nl = new_len.tolist()
    live = hkv * sum(min(n_, window) if window else n_ for n_ in nl)
    rows = {}
    for name, use_lop in (("fused_decode_attention", True), (DENSE, False)):
        kw = dict(block=blk, k_keep=k_keep, window=window, use_lop=use_lop)
        args = (qi, qsc, cl["k"], cl["v"], cl["k_scale"], cl["v_scale"],
                feat, new_len)
        before = [cl[key].clone() for key in ("k", "v", "k_scale",
                                              "v_scale")]
        got = ops.decode_attention(*args, **kw)
        want = plain.decode_attention_ref(*args, softmax_scale=scale, **kw)
        err = check_close(torch, f"{name}[{label}]", got, want)
        if not all(torch.equal(cl[key], old) for key, old in zip(
                ("k", "v", "k_scale", "v_scale"), before)):
            raise AssertionError(f"{name}[{label}] wrote the cache")
        for lane, n_ in enumerate(nl):
            if not n_ and got[lane].any():
                raise AssertionError(f"{name}[{label}]: retired lane not "
                                     f"zero")
        lanes = (qi.reshape(b * hkv, g, dh).contiguous(),
                 qsc.reshape(b * hkv, g).contiguous(),
                 *(a.reshape(b * hkv, *a.shape[2:]).contiguous()
                   for a in args[2:6]))
        if use_lop:
            kargs = (*lanes, feat.reshape(b * hkv, m, dh // 2).contiguous(),
                     new_len)

            def kern(*a):
                return fused_decode_attention(
                    *a, hkv=hkv, block=blk, k_keep=k_keep, window=window,
                    softmax_scale=scale)
            blocks, live_sel = selected(torch, qi, feat, new_len, b=b,
                                        hkv=hkv, g=g, m=m, dh=dh, blk=blk,
                                        k_keep=k_keep, window=window)
            b_ms, b_by = bound_ms(
                nbytes(qi, qsc, new_len) + live * (dh // 2)
                + blocks * blk * (2 * dh + 8) + b * h * dh * 4,
                int8_ops=2.0 * g * live * dh + 2.0 * live_sel * dh,
                f32_ops=2.0 * live_sel * dh)
        else:
            kargs = (*lanes, new_len)

            def kern(*a):
                return fused_dense_decode_attention(
                    *a, hkv=hkv, block=blk, window=window,
                    softmax_scale=scale)
            b_ms, b_by = bound_ms(
                nbytes(qi, qsc, new_len) + live * (2 * dh + 8)
                + b * h * dh * 4, int8_ops=2.0 * g * live * dh,
                f32_ops=2.0 * g * live * dh)
        sets = copies(torch, kargs)
        ms = cuda_ms(torch, kern, sets, 50)
        g_ms = graph_ms(torch, kern, sets)
        p_ms = cuda_ms(torch, lambda *a: plain.decode_attention_ref(
            *a, softmax_scale=scale, **kw), [args], 3)
        lib_ms = None if use_lop else dense_sdpa_ms(
            torch, qi, qsc, cl, new_len, g, window, scale)
        log(f"  {name} {label} (B={b}, H {h} over Hkv {hkv}, G {g}, dh "
            f"{dh}, M={m}, new_len {nl}, window {window}, k_keep {k_keep}, "
            f"no write): max "
            f"|err| {err:.3g}, cache untouched; {ms:.4f} ms, in a CUDA graph "
            f"{g_ms:.4f} ms (plain {p_ms:.3f} ms, "
            + ("" if lib_ms is None else f"SDPA {lib_ms:.4f} ms, ")
            + f"bound {b_ms:.4f} ms by "
            f"{b_by}; {b_ms / ms:.1%} of bound, {b_ms / g_ms:.1%} in the "
            f"graph) [{card}]")
        rows[name] = dict(max_abs_err=err, ms=ms, graph_ms=g_ms,
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms,
                          shape=f"B={b} H={h} Hkv={hkv} M={m} new_len={nl}"
                          + (f" window={window}" if window else ""))
    return rows


def dense_sdpa_ms(torch, qi, qsc, cl, new_len, g: int, window: int,
                  scale: float) -> float:
    """The library call beside #5: SDPA of the one decode row a head on
    the dequantized f32 pages, K/V repeated to the query heads, under the
    validity mask (a lane's first ``new_len`` keys; its last ``window``
    of them when set). A retired lane's row is all masked (NaN), as the
    call gives it; only its time is read."""
    b, h, dh = qi.shape
    m = cl["k"].shape[2]
    kf, vf = ((cl[key].float() * cl[f"{key}_scale"][..., None])
              .repeat_interleave(g, dim=1) for key in ("k", "v"))
    qf = (qi.float() * qsc).reshape(b, h, 1, dh)
    pos = torch.arange(m, device=qi.device)[None, :]
    n = new_len.long()[:, None]
    mask = pos < n
    if window:
        mask &= pos >= n - window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(torch, lambda: sdpa(qf, kf, vf, attn_mask=mask[:, None,
                                                                None],
                                     scale=scale), [()], 10)
    del kf, vf, qf
    return ms


def whisper_projection_rows(torch, np, rng, engine, layer, card) -> dict:
    """#2 ungated (gelu) on one decoder layer's served FFN at the decode
    rows (m 4) and the encoder's (m 1500), and #1 at the cross K‖V
    projection of the encoder memory (m 1500, n 2·768), each through the
    ops entry against the plain version (#1 bitwise), then timed alone
    (CUDA events, L2 cold; in a CUDA graph at m 4) beside its bound. →
    the #2 row (m 4, with m 1500 nested)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear
    from repro_torch.models.transformer import layer_slice

    cfg = engine.cfg
    lp = layer_slice(engine.qp["layers"], layer)
    node = lp["ffn"]
    d, f = cfg.d_model, cfg.d_ff
    dev = node["gu_packed"].device
    gu_row = ops._col_scale(node["gu_scale"], f).reshape(f).contiguous()
    down_row = ops._col_scale(node["down_scale"], d).reshape(d).contiguous()
    rows = {}
    for m in (N_SLOTS, WHISPER_FRAMES):
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).to(dev)
        got = ops.ffn_fused(x, node["gu_packed"], node["gu_scale"],
                            node["down_packed"], node["down_scale"],
                            gated=False, act="gelu")
        want = plain.ffn_fused_ref(x, node["gu_packed"], gu_row[None],
                                   node["down_packed"], down_row[None],
                                   gated=False, act="gelu")
        err = check_close(torch, f"fused_ffn[whisper ungated, m={m}]", got,
                          want)
        args = (x, node["gu_packed"].contiguous(), gu_row,
                node["down_packed"].contiguous(), down_row)

        def kern(*a):
            return fused_ffn(*a, gated=False, act="gelu")
        sets = copies(torch, args)
        ms = cuda_ms(torch, kern, sets, 30)
        g_ms = graph_ms(torch, kern, sets) if m == N_SLOTS else None
        p_ms = cuda_ms(torch, lambda *a: plain.ffn_fused_ref(
            a[0], a[1], a[2][None], a[3], a[4][None], gated=False,
            act="gelu"), [args], 3)
        b_ms, b_by = bound_ms(nbytes(*args) + m * d * 4,
                              int8_ops=4.0 * m * d * f)
        graph = (f", in a CUDA graph {g_ms:.4f} ms ({b_ms / g_ms:.1%} of "
                 f"bound)" if g_ms else "")
        log(f"  fused_ffn ungated gelu (m={m}, d={d}, f={f}, layer {layer}'s"
            f" served weights): max |err| {err:.3g}; {ms:.4f} ms{graph} "
            f"(plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; "
            f"{b_ms / ms:.1%} of bound) [{card}]")
        rows[m] = dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                       bound_by=b_by, shape=f"m={m} d={d} f={f}")
        if g_ms:
            rows[m]["graph_ms"] = g_ms
    wkv = lp["xattn"]["wkv"]
    n = wkv["packed"].shape[1]
    x = torch.from_numpy(rng.standard_normal((WHISPER_FRAMES, d)).astype(
        np.float32)).to(dev)
    gamma = ops._col_scale(wkv["scale"], n).reshape(n).contiguous()
    got = ops.qlinear_fused(x, wkv["packed"], wkv["scale"])
    check_close(torch, "fused_qlinear[whisper cross K‖V, m=1500]", got,
                plain.qlinear_ref(x, wkv["packed"], gamma[None]),
                bitwise=True)
    args = (x, wkv["packed"].contiguous(), gamma)
    ms = cuda_ms(torch, fused_qlinear, copies(torch, args), 30)
    b_ms, b_by = bound_ms(nbytes(*args) + WHISPER_FRAMES * n * 4,
                          int8_ops=2.0 * WHISPER_FRAMES * d * n)
    log(f"  fused_qlinear cross K‖V of the encoder memory (m="
        f"{WHISPER_FRAMES}, k={d}, n={n}): bitwise the plain version; "
        f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of "
        f"bound) [{card}]")
    return dict(rows[N_SLOTS], encoder_rows=rows[WHISPER_FRAMES],
                max_abs_err=max(r["max_abs_err"] for r in rows.values()))


def whisper_kernel_checks(torch, np, engine, pool, card) -> dict:
    """After the greedy run, on one layer's served K/V: #3 non-causal at
    the encoder's shape (C = M = 1500: the unpadded frames) and at the
    cross-prefill's (a 64-token prompt over the 1536-slot cross page,
    kv_len 1500), then #4 and #5 over the pool's cross pages, then #2
    ungated and #1's cross K‖V projection on the layer's served weights.
    → rows by kernel and mode."""
    cfg = engine.cfg
    layer = cfg.n_layers // 2
    rng = np.random.default_rng(SEED + 11)
    cl = {key: pool["cross"][key][layer] for key in pool["cross"]}
    s_enc = int(pool["cross_len"][0])
    enc_view = [cl[key][:1, :, :s_enc] for key in ("k", "v", "k_scale",
                                                   "v_scale")]
    cross_view = [cl[key][:1] for key in ("k", "v", "k_scale", "v_scale")]
    enc = prefill_row(torch, np, rng, "encoder", *enc_view, s_enc, s_enc,
                      cfg.hd, card)
    cross = prefill_row(torch, np, rng, "cross prefill", *cross_view, s_enc,
                        WHISPER_MAX_PROMPT, cfg.hd, card)
    decode = decode_rows(torch, np, rng, cfg, cl, pool["cross_len"].clone(),
                         "over whisper's cross pages", card)
    ffn = whisper_projection_rows(torch, np, rng, engine, layer, card)
    return {"fused_ffn": {"ungated": ffn},
            "fused_prefill_attention": {"non_causal": dict(
                enc, cross_prefill=cross,
                max_abs_err=max(enc["max_abs_err"], cross["max_abs_err"]))},
            "fused_decode_attention": {"cross": decode[
                "fused_decode_attention"]},
            DENSE: {"cross": decode[DENSE]}}


def whisper_prefill_ms(torch, engine, req) -> float:
    """Host ms of one exact-length prefill of ``req`` (its frames and
    prompt, batch 1) to a synchronize: the median of 3 after a warm call."""
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(req.prompt[None], frames=req.frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times[1:])[1] * 1e3


def whisper_arm(torch, np, card: str) -> dict:
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, d 768, 12 heads of 64, f 3072 ungated gelu, vocab 51865,
    cross_ctx 1500): 8 requests of 1500 frames and a 4–64-token prompt,
    run to completion with exact-length prefill, greedy LOP, on a no-LOP
    engine sharing the weights, and LOP with one transient NaN lane
    recovered through the retry. → stats."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import faults
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.cache import capacity_for
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("whisper-small")
    free_cuda(torch)
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=WHISPER_MAX_LEN,
                                    device="cuda")
    dense = PooledEngine(cfg, engine.qp, max_len=WHISPER_MAX_LEN,
                         use_lop=False, device="cuda")
    torch.cuda.synchronize()
    reqs = whisper_requests(np, cfg)
    pool = engine.init_pool(N_SLOTS)
    log(f"  [whisper] seeded whisper-small weights ready in "
        f"{time.monotonic() - t0:.1f} s: serving weights "
        f"{tree_bytes(engine.qp) / 2**30:.3f} GiB, a {N_SLOTS}-slot pool "
        f"{tree_bytes(pool) / 2**20:.1f} MiB (self capacity "
        f"{pool['layers']['k'].shape[3]}, cross capacity "
        f"{pool['cross']['k'].shape[3]}); exact_length_prefill="
        f"{engine.exact_length_prefill}, supports_chunked="
        f"{engine.supports_chunked}, prefix_block={engine.prefix_block}; "
        f"prompt lengths "
        + ", ".join(str(len(r.prompt)) for r in reqs)
        + f", {WHISPER_FRAMES} frames each [{card}]")
    del pool
    warm = Scheduler(engine, n_slots=1)
    warm.submit(replace(reqs[0], rid=-1, max_new_tokens=2))
    warm.run_to_completion()
    del warm
    # one exact-length prefill's launches
    n, n_enc = cfg.n_layers, cfg.n_encoder_layers
    ops.reset_launch_counts()
    engine.prefill(reqs[0].prompt[None], frames=reqs[0].frames)
    torch.cuda.synchronize()
    got = {k: v for k, v in ops.launch_counts(modes=True).items() if v}
    want = {"fused_qlinear": 2 * n_enc + 5 * n, "fused_ffn": n_enc + n,
            "fused_ffn:ungated": n_enc + n,
            "fused_prefill_attention": n_enc + 2 * n,
            "fused_prefill_attention:non_causal": n_enc + n}
    if got != want:
        raise AssertionError(f"a whisper prefill launched {got}, want {want}")
    log("  launches an exact-length prefill (whisper-small): "
        + ", ".join(f"{k} {v}" for k, v in sorted(got.items())))

    out, checks = {}, {}
    plan = faults.FaultPlan(nan_logits=frozenset({(5, 1)}))
    arms = (("whisper LOP greedy", engine, None),
            ("whisper no-LOP greedy", dense, None),
            ("whisper LOP greedy, NaN lane", engine, plan))
    for label, eng, fault in arms:
        attn = "fused_decode_attention" if eng.use_lop else DENSE
        with faults.inject(fault or faults.FaultPlan()):
            run = serve_run(torch, np, eng, reqs, label, card,
                            capacity=capacity_for(cfg, WHISPER_MAX_LEN),
                            check_invariants=True)
        idle = ("fused_ffn_experts", "fused_qlinear_experts")
        if fault is None:
            idle += ("fused_decode_attention" if attn == DENSE else DENSE,)
        check_counts(run["counts"], label,
                     ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
                      attn), idle=idle)
        check_tokens(cfg, run["results"], GEN, label)
        check_lockstep(eng, reqs, run["results"], (0, 1), label)
        sched = run.pop("sched")
        digest = tokens_digest(run["results"])
        if fault is not None:
            if not (sched.fault_events >= 1 and sched.fault_finishes == 0
                    and sched.fault_recoveries == sched.fault_events):
                raise AssertionError(
                    f"[{label}] events {sched.fault_events}, recoveries "
                    f"{sched.fault_recoveries}, finishes "
                    f"{sched.fault_finishes}")
            if digest != out["whisper LOP greedy"]["tokens"]:
                raise AssertionError(f"[{label}] recovered stream != clean")
            log(f"  [{label}] {sched.fault_events} fault event(s), all "
                f"recovered through the dense retry "
                f"({run['counts'][DENSE]} dense launches: self and cross); "
                f"tokens bitwise the clean run's")
        cross = run["counts"].get(f"{attn}:cross", 0)
        if fault is None and 2 * cross != run["counts"][attn]:
            raise AssertionError(f"[{label}] {cross} of "
                                 f"{run['counts'][attn]} decode launches "
                                 f"over the cross pages, want half")
        log(f"  [{label}] {len(sched.full_prefill_seconds)} exact-length "
            f"prefills (1500 frames + prompt), p50 "
            f"{np.percentile(sched.full_prefill_seconds, 50) * 1e3:.1f} ms, "
            f"{sched.full_prefill_stalls} stalled the decoding lanes [{card}]")
        if label == "whisper LOP greedy":
            checks = whisper_kernel_checks(torch, np, eng, sched.pool, card)
        out[label] = dict(counts=run["counts"], tokens=digest,
                          tokens_per_s=run["tokens_per_s"],
                          ttft_p50_ms=run["ttft_p50_ms"],
                          peak_bytes=run["peak_bytes"])
        del run, sched
    step = decode_arms(torch, np, engine, reqs, "whisper LOP greedy", card)
    out["whisper LOP greedy"].update(decode_step_ms_p50=step["ms"],
                                     eager_decode_step_ms_p50=step["eager_ms"])
    del step
    longest = replace(reqs[0], prompt=np.random.default_rng(3).integers(
        0, cfg.vocab, (WHISPER_MAX_PROMPT,)).astype(np.int32))
    pre_ms = whisper_prefill_ms(torch, engine, longest)
    log(f"  whisper exact-length prefill ({WHISPER_FRAMES} frames + "
        f"{len(longest.prompt)} tokens, batch 1, host ms to a synchronize):"
        f" {pre_ms:.1f} ms [{card}]")
    g = out["whisper LOP greedy"]
    log(f"  whisper LOP greedy: {g['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{g['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{g['decode_step_ms_p50']:.2f} ms, eager "
        f"{g['eager_decode_step_ms_p50']:.2f} ms, max_memory_allocated "
        f"{g['peak_bytes'] / 2**30:.2f} GiB; no-LOP "
        f"{out['whisper no-LOP greedy']['tokens_per_s']:.2f} tok/s [{card}]")
    del engine, dense
    free_cuda(torch)
    return dict(runs=out, checks=checks, prefill_ms=pre_ms)


def families_phase(torch, np, card: str) -> dict:
    """Phase 4h: (a) stablelm-1.6b (LayerNorm) at full width and
    ``STABLELM_LAYERS`` of its 24 layers,
    (b) qwen1.5-32b (QKV bias drawn nonzero) at full width and
    ``QWEN_LAYERS`` of its 64 layers (phase 4p serves qwen1.5-110b's bias
    at full depth), (c) whisper-small (encdec) at full width and depth;
    each
    arm's engine and master tree freed before the next. → stats, with the
    launches of the new kernel modes on the paths that run them and the
    kernel rows of the new shapes."""
    from repro_torch.configs import get_config

    t0 = time.monotonic()
    stable = dense_feature_arm(
        torch, np, get_config("stablelm-1.6b").replace(
            n_layers=STABLELM_LAYERS),
        f"stablelm ({STABLELM_LAYERS} layers) LOP greedy", card)
    qwen = dense_feature_arm(
        torch, np, get_config("qwen1.5-32b").replace(n_layers=QWEN_LAYERS),
        f"qwen ({QWEN_LAYERS} layers) LOP greedy", card, bias_seed=SEED + 1)
    whisper = whisper_arm(torch, np, card)
    runs = whisper["runs"]
    lop, nolop = runs["whisper LOP greedy"], runs["whisper no-LOP greedy"]
    nan = runs["whisper LOP greedy, NaN lane"]
    modes = {
        "fused_qlinear": {"bias": qwen["counts"]["fused_qlinear:bias"]},
        "fused_ffn": {"ungated": lop["counts"]["fused_ffn:ungated"]},
        "fused_prefill_attention": {
            "non_causal": lop["counts"]["fused_prefill_attention:non_causal"]},
        "fused_decode_attention": {
            "cross": lop["counts"]["fused_decode_attention:cross"]},
        DENSE: {"cross": nolop["counts"][f"{DENSE}:cross"]
                + nan["counts"].get(f"{DENSE}:cross", 0)}}
    rows = dict(whisper["checks"])
    rows["fused_qlinear"] = {"bias": qwen["bias_check"]}
    for label, r in (("stablelm", stable), ("qwen", qwen),
                     ("whisper", lop)):
        log(f"  [{label}] {r['tokens_per_s']:.2f} tok/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.1f} ms, peak {r['peak_bytes'] / 2**30:.2f}"
            f" GiB, tokens sha256 {r['tokens']} [{card}]")
    log(f"  new modes' launches on their paths: {json.dumps(modes)}; phase "
        f"4h took {time.monotonic() - t0:.1f} s")
    return dict(stable=stable, qwen=qwen, whisper=whisper, modes=modes,
                rows=rows)


# ---------------------------------------------------------------------------
# phase 4i: the recurrent families — rwkv6 (ssm) and jamba (hybrid)
# ---------------------------------------------------------------------------

RWKV_ROWS = ("w_lora_a", "w_lora_b", "wk_c", "wv_c")
# 4i serves rwkv6 at full width and 3 of its 24 layers; the trained
# model is served at full depth in phase 4l (d)
RWKV_SERVE_LAYERS = 3
JAMBA_REQUESTS, JAMBA_MIN_PROMPT, JAMBA_MAX_PROMPT = 8, 8, 96
JAMBA_GEN = 16
JAMBA_MAX_LEN = JAMBA_MAX_PROMPT + 96      # room for the steady steps' 96
JW_ATTN_PROMPT = 512                      # full-width attention sublayer
KERNEL_NAMES = ("fused_qlinear", "fused_ffn", "fused_qlinear_experts",
                "fused_ffn_experts", "fused_prefill_attention",
                "fused_decode_attention", DENSE)


def sampled_params(rid):
    from repro_torch.serving.api import SamplingParams
    return SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=rid)


def projection_rows(torch, np, nodes: dict, label: str, whose: str,
                    card: str, seed: int) -> dict:
    """#1 on the served projections ``nodes`` (name → packed node) at the
    decode rows (m 4) and one 1536-token prompt's: bitwise the plain
    version, timed eagerly and in a CUDA graph beside the bound. A node
    with a bias runs with a seeded nonzero one of its shape (a drawn bias
    is zero). Called outside every counted window. → rows."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import fused_qlinear

    rng = np.random.default_rng(seed)
    rows = {}
    for name, node in nodes.items():
        k, n = node["packed"].shape[0] * 4, node["packed"].shape[1]
        gamma = ops._col_scale(node["scale"], n)
        bias = (torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).cuda() if "b" in node else None)
        for m in (N_SLOTS, MAX_PROMPT):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).cuda()
            got = ops.qlinear_fused(x, node["packed"], node["scale"], bias)
            want = plain.qlinear_ref(x, node["packed"], gamma, bias)
            err = check_close(torch, f"fused_qlinear[{label} {name}, m={m}]",
                              got, want, bitwise=True)
            args = (x, node["packed"].contiguous(),
                    gamma.reshape(n).contiguous(), bias)
            sets = copies(torch, args)
            ms = cuda_ms(torch, fused_qlinear, sets, 30)
            g_ms = graph_ms(torch, fused_qlinear, sets)
            p_ms = cuda_ms(torch, lambda x_, p_, g_, b_: plain.qlinear_ref(
                x_, p_, g_[None], b_), [args], 3)
            b_ms, b_by = bound_ms(
                nbytes(*args[:3]) + (0 if bias is None else nbytes(bias))
                + m * n * 4, int8_ops=2.0 * m * k * n)
            rows[f"{name} m={m}"] = dict(
                max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, shape=f"m={m} k={k} n={n}")
            log(f"  fused_qlinear {label} {name} (m={m}, k={k}, n={n}"
                f"{', bias' if bias is not None else ''}, {whose}): bitwise "
                f"the plain version; {ms:.4f} ms, in a CUDA graph "
                f"{g_ms:.4f} ms (plain {p_ms:.3f} ms, bound {b_ms:.6f} ms by "
                f"{b_by}; {b_ms / ms:.2%} of bound, {b_ms / g_ms:.2%} in the "
                f"graph) [{card}]")
    return rows


def step_split(torch, sched, label: str, card: str, n_prof: int = 4):
    """Profile ``n_prof`` decode steps: #1's device time (its barrier and
    GEMM kernels) against the rest (the glue), and the device's busy
    share. → (#1 ms a step, glue ms a step, busy share), or Nones when
    the profiler recorded no device time."""
    by_name, dev_us, wall_us = profiled(
        torch, lambda: [sched.step() for _ in range(n_prof)])
    if not dev_us:
        log(f"  profiler ({label}): no device time recorded (not measured)")
        return None, None, None
    q_us = sum(us for key, us in by_name.items()
               if "barrier_kernel" in key or "qlinear_" in key)
    log(f"  profiler, {n_prof} decode steps ({label}): #1 "
        f"{q_us / n_prof / 1e3:.3f} ms a step, the glue "
        f"{(dev_us - q_us) / n_prof / 1e3:.3f} ms ({q_us / dev_us:.1%} #1);"
        f" device busy {dev_us / wall_us:.1%} of {wall_us / 1e3:.2f} ms wall"
        f" (profiler on) [{card}]")
    return (q_us / n_prof / 1e3, (dev_us - q_us) / n_prof / 1e3,
            dev_us / wall_us)


def recurrent_serve(torch, np, engine, reqs, label, card, capacity: int,
                    launched, idle, lockstep=(0, 1)) -> dict:
    """One serve run of phase 4i (and 4l): launches, tokens, scheduler ==
    lockstep for the rids ``lockstep``. → stats with the scheduler's
    prefill times."""
    run = serve_run(torch, np, engine, reqs, label, card, capacity=capacity)
    check_counts(run["counts"], label, launched, idle=idle)
    check_tokens(engine.cfg, run["results"], reqs[0].max_new_tokens, label)
    check_lockstep(engine, reqs, run["results"], lockstep, label)
    sched = run.pop("sched")
    pre = sched.full_prefill_seconds
    log(f"  [{label}] {len(pre)} exact-length prefills, p50 "
        f"{np.percentile(pre, 50) * 1e3:.1f} ms, max "
        f"{max(pre) * 1e3:.1f} ms; {sched.full_prefill_stalls} stalled the "
        f"decoding lanes [{card}]")
    return dict(counts=run["counts"], tokens=tokens_digest(run["results"]),
                tokens_per_s=run["tokens_per_s"],
                ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
                prefill_ms_p50=float(np.percentile(pre, 50) * 1e3))


def rwkv_arm(torch, np, card: str) -> dict:
    """rwkv6-1.6b at full width (d 2048, 32 heads of 64, f 7168, vocab
    65,536) and 3 of its 24 layers: seeded weights drawn and quantized on
    the card one layer at a time (the first 3 layers of the full draw),
    phase 4's 8 requests greedy, then sampled, through the Scheduler on 4
    slots (run to completion, exact-length prefill), #1 the only kernel of
    the table (30 launches a decode step). → stats."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.quantize import init_serving_params
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("rwkv6-1.6b").replace(n_layers=RWKV_SERVE_LAYERS)
    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    qp = init_serving_params(cfg, SEED, "cuda")
    free_cuda(torch)
    draw_peak = torch.cuda.max_memory_allocated() - base
    engine = PooledEngine(cfg, qp, max_len=MAX_PROMPT + GEN, device="cuda")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    log(f"  [rwkv6] seeded weights ready in {time.monotonic() - t0:.1f} s "
        f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.hd}, f {cfg.d_ff}, vocab {cfg.vocab}): serving weights "
        f"{tree_bytes(qp) / 2**30:.3f} GiB, a {N_SLOTS}-slot pool "
        f"{tree_bytes(engine.init_pool(N_SLOTS)) / 2**20:.1f} MiB of "
        f"state; peak while drawing and quantizing "
        f"{draw_peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB the "
        f"earlier phases hold; state_kind {engine.state_kind}, "
        f"exact_length_prefill={engine.exact_length_prefill}; prompt "
        f"lengths " + ", ".join(str(len(r.prompt)) for r in reqs)
        + f" [{card}]")
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:16],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    rows = projection_rows(
        torch, np, {name: layer_slice(qp["layers"], 0)["tm"][name]
                    for name in RWKV_ROWS}, "rwkv6",
        "layer 0's served weights", card, SEED + 9)
    idle = tuple(k for k in KERNEL_NAMES if k != "fused_qlinear")
    # a decode step's cost does not depend on the context, so the steady
    # steps run on the four shortest prompts (their prefills are the
    # phase's cost)
    short = sorted(reqs, key=lambda r: len(r.prompt))[:N_SLOTS]
    out = {}
    for label, sampling in (("rwkv6 greedy", None),
                            ("rwkv6 sampled", sampled_params)):
        rq = reqs if sampling is None else [
            replace(r, sampling=sampling(r.rid)) for r in reqs]
        out[label] = recurrent_serve(torch, np, engine, rq, label, card, 0,
                                     ("fused_qlinear",), idle)
        step = decode_arms(torch, np, engine, short, label, card,
                           sampling=sampling)
        out[label].update(decode_step_ms_p50=step["ms"],
                          eager_decode_step_ms_p50=step["eager_ms"])
        if sampling is None:
            prof = profile_arms(torch, step, label, card)
            out[label]["split"] = {
                arm: step_split(torch, step[key], f"{label}, {arm}", card)
                for arm, key in (("eager", "eager_sched"),
                                 ("graph", "sched"))}
            out[label]["device_ms"] = prof["graph"][0]
        del step
    by_len = prefill_ms_by_length(torch, np, engine, (128, 512, 1024, 1536),
                                  reps=1, warm=False)
    log("  [rwkv6] exact-length prefill (batch 1, host ms to a synchronize,"
        " one call each on the warm engine): " + ", ".join(
            f"{s} tokens {ms:.1f} ms" for s, ms in by_len.items())
        + f" [{card}]")
    g, sm = out["rwkv6 greedy"], out["rwkv6 sampled"]
    log(f"  [rwkv6] greedy {g['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{g['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{g['decode_step_ms_p50']:.2f} ms, eager "
        f"{g['eager_decode_step_ms_p50']:.2f} ms; sampled "
        f"{sm['tokens_per_s']:.2f} tok/s, step {sm['decode_step_ms_p50']:.2f}"
        f" ({sm['eager_decode_step_ms_p50']:.2f}) ms; peak in the greedy "
        f"run {g['peak_bytes'] / 2**30:.2f} GiB; tokens sha256 "
        f"{g['tokens']} / {sm['tokens']} [{card}]")
    del engine, qp
    free_cuda(torch)
    return dict(runs=out, rows=rows, prefill_ms=by_len,
                draw_peak_bytes=draw_peak)


def hybrid_prefill_launches(torch, engine, reqs, label: str):
    """One exact-length prefill of the longest prompt of ``reqs`` on a
    hybrid engine: its launches are the decode step's #1 and dense #2,
    #2's expert form once a moe_group of tokens and #3 once a superblock.
    → the prompt."""
    from repro_torch.kernels import ops

    cfg = engine.cfg
    prompt = max((r.prompt for r in reqs), key=len)
    ops.reset_launch_counts()
    engine.prefill(prompt[None])
    torch.cuda.synchronize()
    got = {k: v for k, v in ops.launch_counts().items() if v}
    step = recurrent_step_launches(cfg, True)
    groups = -(-len(prompt) // cfg.moe_group)
    want = {"fused_qlinear": step["fused_qlinear"],
            "fused_ffn": step["fused_ffn"],
            "fused_ffn_experts": step["fused_ffn_experts"] * groups,
            "fused_prefill_attention": step["fused_decode_attention"]}
    if {k: v for k, v in got.items() if ":" not in k} != want:
        raise AssertionError(f"a {label} prefill of {len(prompt)} tokens "
                             f"launched {got}, want {want}")
    log(f"  launches an exact-length prefill of {len(prompt)} tokens "
        f"({label}): " + ", ".join(f"{k} {v}" for k, v in sorted(got.items()))
        + "; prompt lengths " + ", ".join(str(len(r.prompt)) for r in reqs))
    return prompt


def jamba_arm(torch, np, card: str) -> dict:
    """jamba-1.5-large-398b-reduced (2 superblocks of Mamba, Mamba + MoE,
    attention, Mamba + MoE; d 128, 4 experts top-2, lop_block 32): 8
    requests of 8–96 prompt tokens (default_rng(3)), 16 new, greedy LOP,
    no-LOP on an engine sharing the weights, and sampled; every kernel of
    the path launches. A launch and parity check of the hybrid path at d
    128, not its performance: :func:`jamba_width_arm` serves one
    superblock at full width (the whole model, about 100 GB even packed,
    fits no card). → stats."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.cache import capacity_for
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("jamba-1.5-large-398b-reduced")
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=JAMBA_MAX_LEN,
                                    device="cuda")
    dense = PooledEngine(cfg, engine.qp, max_len=JAMBA_MAX_LEN,
                         use_lop=False, device="cuda")
    reqs = make_requests(cfg, n_requests=JAMBA_REQUESTS,
                         min_prompt=JAMBA_MIN_PROMPT,
                         max_prompt=JAMBA_MAX_PROMPT, gen=JAMBA_GEN, seed=3)
    cap = capacity_for(cfg, JAMBA_MAX_LEN)
    log(f"  [jamba] seeded reduced weights ready in "
        f"{time.monotonic() - t0:.1f} s: serving weights "
        f"{tree_bytes(engine.qp) / 2**20:.2f} MiB, capacity {cap}; "
        f"state_kind {engine.state_kind}; prompt lengths "
        + ", ".join(str(len(r.prompt)) for r in reqs) + f" [{card}]")
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:8],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    hybrid_prefill_launches(torch, engine, reqs, "jamba reduced")
    out = {}
    for label, eng, sampling in (("jamba LOP greedy", engine, None),
                                 ("jamba no-LOP greedy", dense, None),
                                 ("jamba LOP sampled", engine,
                                  sampled_params)):
        attn = "fused_decode_attention" if eng.use_lop else DENSE
        rq = reqs if sampling is None else [
            replace(r, sampling=sampling(r.rid)) for r in reqs]
        out[label] = recurrent_serve(
            torch, np, eng, rq, label, card, cap,
            ("fused_qlinear", "fused_ffn", "fused_ffn_experts",
             "fused_prefill_attention", attn),
            ("fused_qlinear_experts",
             DENSE if attn != DENSE else "fused_decode_attention"))
        step = decode_arms(torch, np, eng, reqs, label, card,
                           sampling=sampling)
        out[label].update(decode_step_ms_p50=step["ms"],
                          eager_decode_step_ms_p50=step["eager_ms"])
        del step
    g = out["jamba LOP greedy"]
    log(f"  [jamba] LOP greedy {g['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{g['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{g['decode_step_ms_p50']:.2f} ms, eager "
        f"{g['eager_decode_step_ms_p50']:.2f} ms; tokens sha256 "
        + " / ".join(f"{r['tokens']}" for r in out.values()) + f" [{card}]")
    del engine, dense
    free_cuda(torch)
    return dict(runs=out)


def to_cpu(tree):
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def barrier_parts(torch, got, want) -> int:
    """The int8 absmax barrier of the card's f32 rows ``got`` against the
    CPU's ``want``: the values may part only where the CPU's scaled value
    lies within 1e-4 of a rounding boundary (a 1-ulp knife-edge), and
    then by one. → how many part."""
    from repro_torch.core.quantization import absmax_scale, quantize

    g, w = quantize(got).values, quantize(want).values
    apart = g != w
    scaled = (want / absmax_scale(want))[apart].abs()
    if ((g.int() - w.int()).abs().max() > 1
            or ((scaled % 1.0 - 0.5).abs() > 1e-4).any()):
        raise AssertionError(f"int8 barrier values part away from a "
                             f"rounding boundary: {scaled.tolist()[:8]}")
    return int(apart.sum())


def mamba_card_vs_cpu(torch, np, cfg, mp, card) -> dict:
    """A full-width Mamba sublayer on the card against the CPU, stage by
    stage, each stage on the CPU's input to it: a 16-token prefill from
    zero states, then one decode step from the CPU's state. ``in_proj``'s
    x and z, the causal conv and silu, ``x_proj``/``dt_proj``/softplus's
    dt, B and C, the selective scan's state and y, and ``out_proj`` on the
    CPU's gated y, each within rtol = atol = 2e-5; ``out_proj``'s int8
    barrier values (the gated y) bitwise but for 1-ulp knife-edges. The
    whole sublayer is not held at 2e-5: exp and sigmoid round apart by
    ulps between the CPU and the card, and a value on a rounding boundary
    of a barrier moves its row's projection by a 127th of its scale. →
    the largest |err| by stage, and the barrier values that parted."""
    from repro_torch.models import mamba
    from repro_torch.models.layers import linear_apply
    from repro_torch.models.rwkv6 import silu
    from repro_torch.models.scan_utils import chunked_scan, stepwise

    weights = {"cpu": to_cpu(mp), "cuda": mp}
    rng = np.random.default_rng(SEED + 16)
    errs, parts = {}, {}

    def stage(name, fn, *args):
        """fn(weights, *args) on the CPU, and on the card on the same
        values; every output within 2e-5. → (the CPU's outputs, the
        card's)."""
        want = fn(weights["cpu"], *args)
        got = fn(weights["cuda"], *(a.cuda() for a in args))
        for i, (g, w) in enumerate(zip(got, want)):
            errs[name] = max(errs.get(name, 0.0), check_close(
                torch, f"jamba mamba {name}[{i}], card vs CPU", g.cpu(), w))
        return want, got

    def conv_silu(p, x, *conv):
        y, st = mamba._causal_conv(x, p["conv_w"], p["conv_b"], *conv)
        return silu(y), st

    def scan(p, h, *xs):
        step = mamba._scan_step(p["A_log"], p["D"])
        return chunked_scan(stepwise(step), h,
                            tuple(a.transpose(0, 1) for a in xs))

    h = torch.zeros((1, cfg.d_inner, cfg.mamba_d_state))
    conv = ()
    for label, t in (("prefill", 16), ("decode", 1)):
        u = torch.from_numpy(rng.standard_normal((1, t, cfg.d_model)).astype(
            np.float32))
        (x, z), _ = stage(f"{label} in_proj",
                          lambda p, u_: mamba._ssm_inputs(cfg, p, u_), u)
        (xc, conv_new), _ = stage(f"{label} conv", conv_silu, x, *conv)
        (dt, b, c), _ = stage(f"{label} x_proj/dt_proj",
                              lambda p, x_: mamba._ssm_project(cfg, p, x_),
                              xc)
        (h, ys), (_, ys_card) = stage(f"{label} scan", scan, h, xc, dt, b, c)
        y = ys.transpose(0, 1) * silu(z)
        parts[label] = barrier_parts(
            torch, (ys_card.transpose(0, 1) * silu(z.cuda())).cpu(), y)
        stage(f"{label} out_proj", lambda p, y_: (linear_apply(
            p["out_proj"], y_, quant=cfg.quant),), y)
        conv = (conv_new,)
    log("  jamba full-width Mamba sublayer, card vs CPU stage by stage (a "
        "16-token prefill, then a decode step; rtol=atol=2e-5): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + "; out_proj's int8 barrier values parted at "
        + ", ".join(f"{v} ({k})" for k, v in parts.items())
        + f" 1-ulp knife-edges [{card}]")
    return dict(max_abs_err=errs, barrier_parts=parts)


def host_ms(torch, fn, reps: int) -> float:
    """Median host ms of ``fn()`` (:func:`timed_ms`) over ``reps``
    calls."""
    times = sorted(timed_ms(torch, fn)[0] for _ in range(reps))
    return times[len(times) // 2]


def counted(torch, fn, want: dict, label: str):
    """``fn()`` once with the launch counts zeroed before it; its launches
    must be ``want``. → fn's result."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in ops.launch_counts().items() if v}
    if got != want:
        raise AssertionError(f"{label} launched {got}, want {want}")
    return out


def jamba_attention_checks(torch, np, cfg, ap, card) -> dict:
    """The full-width attention sublayer (64 heads of 128 over 8 KV
    heads) on a page layer of 4 lanes: a 512-token prefill of each (#1
    twice, #3 once) and a decode step at LOP and dense (#1 twice, the
    decode kernel once), each timed (host ms to a synchronize) with
    finite outputs; #3 on the prefill's own queries and pages, and #4 and
    #5 on the decode step's and the pages it wrote, against their plain
    versions (rtol = atol = 2e-5). → times and errors."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.models.layers import rope
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving import engine as teng
    from repro_torch.serving.cache import init_cache, round_up
    from repro_torch.serving.lop_select import k_keep_blocks

    rng = np.random.default_rng(SEED + 17)
    t = JW_ATTN_PROMPT
    cache = init_cache(cfg, N_SLOTS, t + 1, "cuda")
    cl = layer_slice(cache["blocks"], 0)["attn"]
    cap, blk, scale = cl["k"].shape[2], cfg.lop_block, cfg.hd ** -0.5
    h = torch.from_numpy(rng.standard_normal((N_SLOTS, t, cfg.d_model))
                         .astype(np.float32)).cuda()
    teng.attn_prefill(cfg, ap, h[:, :16], cl)              # warm
    out = counted(torch, lambda: teng.attn_prefill(cfg, ap, h, cl),
                  {"fused_qlinear": 2, "fused_prefill_attention": 1},
                  "the jamba attention sublayer's prefill")
    if not torch.isfinite(out).all():
        raise AssertionError("jamba attention prefill: non-finite output")
    pre_ms = host_ms(torch, lambda: teng.attn_prefill(cfg, ap, h, cl), 3)
    q = rope(teng._project_qkv(cfg, ap, h)[0],
             torch.arange(t, device="cuda")[None, :], cfg.rope_theta)
    qi, qsc = teng._q(q)
    kv_len = torch.full((N_SLOTS,), t, dtype=torch.int32, device="cuda")
    view = [cl[key][:, :, :min(cap, round_up(t, blk))]
            for key in ("k", "v", "k_scale", "v_scale")]
    qargs = (qi.transpose(1, 2), qsc[..., 0].transpose(1, 2), *view, kv_len)
    flags = dict(causal=True, window=cfg.swa_window,
                 int8_logits=bool(cfg.int8_logits))
    errs = {"fused_prefill_attention": check_close(
        torch, "fused_prefill_attention[jamba full width, causal]",
        ops.prefill_attention(*qargs, q_offset=0, **flags),
        plain.prefill_attention_ref(*qargs, 0, softmax_scale=scale,
                                    **flags))}
    lengths = kv_len.clone()
    h1 = torch.from_numpy(rng.standard_normal((N_SLOTS, 1, cfg.d_model))
                          .astype(np.float32)).cuda()
    q1 = rope(teng._project_qkv(cfg, ap, h1)[0], lengths[:, None],
              cfg.rope_theta)
    qi1, qsc1 = teng._q(q1[:, 0])
    k_keep = max(1, min(k_keep_blocks(cfg, cap), cap // blk))
    step_ms = {}
    for name, use_lop in (("fused_decode_attention", True), (DENSE, False)):
        # each call writes the same token at the same row of every lane
        def step():
            return teng.attn_decode(cfg, ap, h1, cl, lengths,
                                    use_lop=use_lop)
        y = counted(torch, step, {"fused_qlinear": 2, name: 1},
                    f"a jamba attention decode step ({name})")
        if not torch.isfinite(y).all():
            raise AssertionError(f"jamba attention decode ({name}): "
                                 f"non-finite output")
        step_ms[name] = host_ms(torch, step, 10)
        dargs = (qi1, qsc1, cl["k"], cl["v"], cl["k_scale"], cl["v_scale"],
                 cl["feat"], lengths + 1)
        kw = dict(block=blk, k_keep=k_keep, window=cfg.swa_window,
                  use_lop=use_lop,
                  shared_select=bool(cfg.gqa_shared_select))
        errs[name] = check_close(
            torch, f"{name}[jamba full width]",
            ops.decode_attention(*dargs, **kw),
            plain.decode_attention_ref(*dargs, softmax_scale=scale, **kw))
    log(f"  jamba full-width attention sublayer (B {N_SLOTS}, {cfg.n_heads} "
        f"heads of {cfg.hd} over {cfg.n_kv_heads}, pages of {cap}): prefill "
        f"of {t} tokens a lane {pre_ms:.2f} ms (#1 2, #3 1); decode step LOP"
        f" {step_ms['fused_decode_attention']:.3f} ms, dense "
        f"{step_ms[DENSE]:.3f} ms (#1 2, the decode kernel 1; host ms to a "
        f"synchronize); against the plain versions: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f" [{card}]")
    del cache
    return dict(prefill_ms=pre_ms, decode_step_ms=step_ms,
                max_abs_err=errs)


JAMBA_SB_REQUESTS, JAMBA_SB_MIN, JAMBA_SB_MAX, JAMBA_SB_GEN = 4, 64, 256, 16
JAMBA_SB_MAX_LEN = JAMBA_SB_MAX + 96      # room for the steady steps' 96
JAMBA_SB_SEED = 9                         # the superblock's request rng


def jamba_width_arm(torch, np, card: str) -> dict:
    """jamba-1.5-large-398b at full width and one superblock of its 9 (8
    of 72 sublayers: 7 Mamba (d 8192, Di 16384, S 16, conv 4, dt_rank
    512) and 1 attention (64 heads of 128 over 8 KV heads), 4 dense FFNs
    and 4 MoEs of 16 experts top-2 of f 24,576), drawn and quantized on
    the card a sublayer at a time through ``PooledEngine.from_seed`` (the
    peak is the served tree and one sublayer's masters); 4 requests of
    64–256 tokens, 16 new, run to completion greedy LOP and on a no-LOP
    engine sharing the weights: every kernel of the path launched, one
    exact-length prefill's launches, scheduler == lockstep for 2
    requests, the decode step on CUDA graphs bitwise its eager twin (30
    / 4 dense + 4 expert / 1 launches of #1 / #2 / the decode kernel);
    #2 (E 16) at the decode C and the longest prompt's against its plain
    version with times and bound. Then, on the served superblock's first
    Mamba sublayer and its attention sublayer: #1 at ``in_proj``,
    ``x_proj``, ``dt_proj`` + bias, ``out_proj``, ``wqkv`` and ``wo``
    bitwise its plain version and timed beside its bound; the Mamba
    sublayer's prefill (4 #1 launches, the selective scan a time loop of
    plain ops) at 128, 512 and 1536 tokens and its decode step (4 lanes,
    eager and in a CUDA graph); the Mamba sublayer card against CPU stage
    by stage; the attention sublayer's prefill and decode with #3 and the
    decode kernels held against their plain versions. → stats."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import resolve_decode_flags
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import mamba
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.cache import capacity_for
    from repro_torch.serving.scheduler import Scheduler

    cfg = resolve_decode_flags(get_config("jamba-1.5-large-398b").replace(
        n_layers=get_config("jamba-1.5-large-398b").attn_every))
    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=JAMBA_SB_MAX_LEN,
                                    device="cuda")
    torch.cuda.synchronize()
    drawn_s = time.monotonic() - t0
    draw_peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if draw_peak >= total:
        raise AssertionError(f"jamba superblock draw peak {draw_peak} B")
    sb = layer_slice(engine.qp["blocks"], 0)
    moe_bytes = sum(tree_bytes(sb[f"sub{j}"]["moe"])
                    for j in range(cfg.attn_every) if cfg.is_moe_layer(j))
    cap = capacity_for(cfg, JAMBA_SB_MAX_LEN)
    log(f"  [jamba superblock] seeded weights drawn and quantized a "
        f"sublayer at a time in {drawn_s:.1f} s (d {cfg.d_model}, "
        f"{cfg.attn_every} sublayers: "
        + ", ".join(("attn" if cfg.is_attn_layer(j) else "mamba")
                    + ("+moe" if cfg.is_moe_layer(j) else "+ffn")
                    for j in range(cfg.attn_every))
        + f"; {cfg.n_experts} experts top-{cfg.top_k} of f {cfg.d_ff}): "
        f"serving weights {tree_bytes(engine.qp) / 2**30:.3f} GiB (the 4 "
        f"MoEs {moe_bytes / 2**30:.3f} GiB, embed and head f32 "
        f"{tree_bytes({k: engine.qp[k] for k in ('embed', 'head')}) / 2**30:.3f}"
        f" GiB); draw peak {draw_peak / 2**30:.2f} GiB of the card's "
        f"{total / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held by the "
        f"earlier phases); capacity {cap} [{card}]")
    dense = PooledEngine(cfg, engine.qp, max_len=JAMBA_SB_MAX_LEN,
                         use_lop=False, device="cuda")
    reqs = make_requests(cfg, n_requests=JAMBA_SB_REQUESTS,
                         min_prompt=JAMBA_SB_MIN, max_prompt=JAMBA_SB_MAX,
                         gen=JAMBA_SB_GEN, seed=JAMBA_SB_SEED)
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:8],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    prompt = hybrid_prefill_launches(torch, engine, reqs, "jamba superblock")
    runs, launches = {}, {k: 0 for k in KERNEL_NAMES}
    for label, eng in (("jamba superblock LOP greedy", engine),
                       ("jamba superblock no-LOP greedy", dense)):
        attn = "fused_decode_attention" if eng.use_lop else DENSE
        runs[label] = recurrent_serve(
            torch, np, eng, reqs, label, card, cap,
            ("fused_qlinear", "fused_ffn", "fused_ffn_experts",
             "fused_prefill_attention", attn),
            ("fused_qlinear_experts",
             DENSE if attn != DENSE else "fused_decode_attention"))
        step = decode_arms(torch, np, eng, reqs, label, card)
        runs[label].update(decode_step_ms_p50=step["ms"],
                           eager_decode_step_ms_p50=step["eager_ms"])
        for k in KERNEL_NAMES:
            launches[k] += runs[label]["counts"][k]
        del step
    del dense
    free_cuda(torch)
    moe_sub = next(j for j in range(cfg.attn_every) if cfg.is_moe_layer(j))
    expert_rows = expert_ffn_rows(
        torch, np, np.random.default_rng(SEED + 20), sb[f"sub{moe_sub}"]["moe"],
        (capacity(cfg, N_SLOTS), capacity(cfg, len(prompt))),
        f"jamba sub{moe_sub}", card)
    g, d = runs["jamba superblock LOP greedy"], runs[
        "jamba superblock no-LOP greedy"]
    log(f"  [jamba superblock] LOP greedy {g['tokens_per_s']:.2f} tok/s, "
        f"TTFT p50 {g['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA "
        f"graph {g['decode_step_ms_p50']:.2f} ms, eager "
        f"{g['eager_decode_step_ms_p50']:.2f} ms, peak while serving "
        f"{g['peak_bytes'] / 2**30:.2f} GiB; no-LOP "
        f"{d['tokens_per_s']:.2f} tok/s, graph step "
        f"{d['decode_step_ms_p50']:.2f} ms; tokens sha256 {g['tokens']} / "
        f"{d['tokens']} [{card}]")
    mp = sb[next(f"sub{j}" for j in range(cfg.attn_every)
                 if not cfg.is_attn_layer(j))]["mamba"]
    ap = sb[next(f"sub{j}" for j in range(cfg.attn_every)
                 if cfg.is_attn_layer(j))]["attn"]
    if "packed" not in mp["dt_proj"] or "b" not in mp["dt_proj"]:
        raise AssertionError("full-width dt_proj is not packed with its bias")
    rows = projection_rows(
        torch, np, {**{f"mamba {n}": mp[n] for n in (
            "in_proj", "x_proj", "dt_proj", "out_proj")},
            "attn wqkv": ap["wqkv"], "attn wo": ap["wo"]},
        "jamba", "the served superblock's sublayers", card, SEED + 18)
    rng = np.random.default_rng(SEED + 19)

    def seeded(*shape, sd=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sd).astype(
            np.float32)).cuda()
    four = {"fused_qlinear": 4}
    mamba.mamba_forward(cfg, mp, seeded(1, 16, cfg.d_model))   # warm
    prefill_ms = {}
    for t in (128, 512, 1536):
        u = seeded(1, t, cfg.d_model)
        y, st = counted(torch, lambda: mamba.mamba_forward(cfg, mp, u), four,
                        f"a full-width Mamba prefill of {t} tokens")
        if not (torch.isfinite(y).all() and torch.isfinite(st["ssm"]).all()):
            raise AssertionError(f"Mamba prefill of {t}: non-finite output")
        prefill_ms[t] = timed_ms(
            torch, lambda: mamba.mamba_forward(cfg, mp, u))[0]
    shapes = mamba.mamba_state_shape(cfg, N_SLOTS)
    u1, ssm, conv = (seeded(N_SLOTS, 1, cfg.d_model),
                     seeded(*shapes["ssm"][0], sd=0.3),
                     seeded(*shapes["conv"][0], sd=0.3))

    def decode(u_, s_, c_):
        return mamba.mamba_decode_step(cfg, mp, u_, {"ssm": s_, "conv": c_})
    y, _ = counted(torch, lambda: decode(u1, ssm, conv), four,
                   "a full-width Mamba decode step")
    if not torch.isfinite(y).all():
        raise AssertionError("Mamba decode step: non-finite output")
    step_ms = host_ms(torch, lambda: decode(u1, ssm, conv), 20)
    step_graph_ms = graph_ms(torch, decode, [(u1, ssm, conv)])
    log(f"  [jamba full width] Mamba sublayer prefill (batch 1, host ms to "
        f"a synchronize): " + ", ".join(f"{t} tokens {ms:.1f} ms" for t, ms
                                        in prefill_ms.items())
        + f"; decode step (B={N_SLOTS}) eager {step_ms:.3f} ms, in a CUDA "
        f"graph {step_graph_ms:.3f} ms; 4 #1 launches a call [{card}]")
    cpu = mamba_card_vs_cpu(torch, np, cfg, mp, card)
    attn = jamba_attention_checks(torch, np, cfg, ap, card)
    del sb, mp, ap, engine
    free_cuda(torch)
    return dict(rows=rows, mamba_prefill_ms=prefill_ms,
                mamba_step_ms=step_ms, mamba_step_graph_ms=step_graph_ms,
                card_vs_cpu=cpu, attention=attn, draw_peak_bytes=draw_peak,
                runs=runs, launches=launches, expert_rows=expert_rows)


def recurrent_phase(torch, np, card: str) -> dict:
    """Phase 4i: (a) rwkv6-1.6b at full width and ``RWKV_SERVE_LAYERS``
    layers, (b) jamba-1.5-large-398b reduced, (c) one full-width jamba
    superblock served, its sublayers checked; each arm's engine freed
    before the next. → stats, with every serve run's launches summed by
    kernel."""
    t0 = time.monotonic()
    rwkv = rwkv_arm(torch, np, card)
    jamba = jamba_arm(torch, np, card)
    width = jamba_width_arm(torch, np, card)
    launches = {k: 0 for k in KERNEL_NAMES}
    for run in (*rwkv["runs"].values(), *jamba["runs"].values(),
                *width["runs"].values()):
        for k in KERNEL_NAMES:
            launches[k] += run["counts"][k]
    log(f"  phase 4i's serve runs launched {json.dumps(launches)}; phase 4i "
        f"took {time.monotonic() - t0:.1f} s")
    return dict(rwkv=rwkv, jamba=jamba, jamba_width=width,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 4j: the streamed draw; the vlm family (llava-next-34b) and
# mistral-nemo-12b at full width and depth
# ---------------------------------------------------------------------------

VLM_SEED = 4                       # the vlm traffic's request rng
VLM_MIN_TEXT, VLM_MAX_TEXT = 64, 512
VLM_SPEC_REQUESTS = 2
VLM_SERVE_LAYERS = 6               # of 60: drawn whole, served cut (time)
MISTRAL_LAYERS = 6                 # of 40: drawn and served cut (time)
VLM_SHARED_TEXT = 1024             # the text-only prefix-store arm
DRAW_PEAK_LIMIT = 30 * 2 ** 30     # llava's streamed draw (its whole f32
#                                    master tree would not fit the card)
VLM_NAN_CALLS = frozenset({(3, 1)})   # (decode call, lane): one NaN lane


def leaves_cut(tree: dict, n: int) -> dict:
    """The first ``n`` layers of a layer-stacked tree (views, no copies)."""
    return {k: leaves_cut(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def leaves(tree, path=()):
    """(path, tensor) of every leaf of a nested dict."""
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, path + (name,))
        else:
            yield path + (name,), val


def drawn(torch, draw) -> tuple:
    """``draw()`` with the device's peak above what was allocated before
    it. → (tree, seconds, peak bytes)."""
    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tree = draw()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return tree, secs, torch.cuda.max_memory_allocated() - base


def streamed_draw_arm(torch, np, card: str) -> dict:
    """(a) bitnet-3b at full width and depth drawn both ways on the card:
    the whole f32 master tree then ``quantize_params``, and
    ``init_serving_params``, one layer at a time; every leaf bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.quantize import (init_serving_params,
                                              quantize_params)

    cfg = get_config("bitnet-3b")
    whole, w_s, w_peak = drawn(torch, lambda: quantize_params(
        cfg, init_params(cfg, SEED, "cuda")))
    streamed, s_s, s_peak = drawn(torch, lambda: init_serving_params(
        cfg, SEED, "cuda"))
    want = dict(leaves(whole))
    got = dict(leaves(streamed))
    if got.keys() != want.keys():
        raise AssertionError(f"streamed tree paths {sorted(got)} != "
                             f"{sorted(want)}")
    apart = [p for p, leaf in want.items()
             if got[p].dtype != leaf.dtype or not torch.equal(got[p], leaf)]
    if apart:
        raise AssertionError(f"streamed draw != whole draw at {apart}")
    log(f"  [streamed draw] bitnet-3b ({cfg.n_layers} layers, d "
        f"{cfg.d_model}): {len(want)} leaves "
        f"({tree_bytes(whole) / 2**30:.3f} GiB) bitwise both ways; whole "
        f"master then quantize {w_s:.1f} s, peak {w_peak / 2**30:.2f} GiB; "
        f"one layer at a time {s_s:.1f} s, peak {s_peak / 2**30:.2f} GiB "
        f"[{card}]")
    del whole, streamed, want, got
    free_cuda(torch)
    return dict(whole_peak_bytes=w_peak, streamed_peak_bytes=s_peak,
                whole_s=w_s, streamed_s=s_s)


def prefill_chunk_rows(torch, np, rng, cfg, cl, start: int, c: int,
                       label: str, card: str) -> dict:
    """#3 causal at a chunk's shape over one layer's pages ``cl`` (batch
    1; ``c`` rows a query head at global positions [start, start + c),
    kv_len start + c; G = H / Hkv rows a kv lane, g-major; ``cfg``'s
    sliding window), seeded queries, through the ops
    entry against the plain version, then timed alone (CUDA events, L2
    cold) beside its bound (the (row, key) pairs the mask keeps) and
    SDPA on the dequantized tensors with the chunk's mask."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.prefill_attention import fused_prefill_attention

    _, hkv, m, dh = cl["k"].shape
    h = cfg.n_heads
    g = h // hkv
    dev = cl["k"].device
    kvl = start + c
    qi = torch.from_numpy(rng.integers(-127, 128, (1, h, c, dh)).astype(
        np.int8)).to(dev)
    qsc = torch.from_numpy((rng.random((1, h, c)) * 0.02 + 0.001).astype(
        np.float32)).to(dev)
    kv_len = torch.full((1,), kvl, dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    win = cfg.swa_window
    view = [cl[key][:1] for key in ("k", "v", "k_scale", "v_scale")]
    got = ops.prefill_attention(qi, qsc, *view, kv_len, q_offset=start,
                                causal=True, window=win)
    want = plain.prefill_attention_ref(qi, qsc, *view, kv_len, start,
                                       causal=True, window=win,
                                       softmax_scale=scale)
    err = check_close(torch, f"fused_prefill_attention[{label}]", got, want)
    args = (qi.reshape(hkv, g * c, dh).contiguous(),
            qsc.reshape(hkv, g * c).contiguous(),
            *(v_[0].contiguous() for v_ in view), kv_len, start)

    def kern(*a):
        return fused_prefill_attention(*a, hkv=hkv, chunk=c, causal=True,
                                       window=win, softmax_scale=scale)
    ms = cuda_ms(torch, kern, copies(torch, args), 10)
    p_ms = cuda_ms(torch, lambda: plain.prefill_attention_ref(
        qi, qsc, *view, kv_len, start, causal=True, window=win,
        softmax_scale=scale), [()], 2)
    pos = np.arange(start, start + c)               # (row, key) pairs kept
    visible = int((np.minimum(pos + 1, win) if win else pos + 1).sum())
    b_ms, b_by = bound_ms(nbytes(qi, qsc) + hkv * kvl * (2 * dh + 8)
                          + h * c * dh * 4, int8_ops=2.0 * h * visible * dh,
                          f32_ops=2.0 * h * visible * dh)
    kf = (view[0][:, :, :kvl].float() * view[2][:, :, :kvl, None])
    vf = (view[1][:, :, :kvl].float() * view[3][:, :, :kvl, None])
    kf, vf = (x.repeat_interleave(g, dim=1) for x in (kf, vf))
    qf = qi.float() * qsc[..., None]
    rel = ((start + torch.arange(c, device=dev))[:, None]
           - torch.arange(kvl, device=dev)[None, :])
    mask = (rel >= 0) & (rel < win) if win else rel >= 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(torch, lambda: sdpa(qf, kf, vf, attn_mask=mask),
                     [()], 3)
    del kf, vf, qf, mask, rel
    log(f"  fused_prefill_attention {label} (causal, C={c} rows a head at "
        f"start {start}, kv_len {kvl}, M={m}, H {h} over Hkv {hkv}, G {g}, "
        f"dh {dh}, window {win}): max |err| {err:.3g}; {ms:.4f} ms (plain "
        f"{p_ms:.3f} ms, "
        f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"{b_ms / ms:.1%} of bound) [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"C={c} start={start} M={m} H={h} Hkv={hkv} dh={dh}"
                + (f" window={win}" if win else ""))


def vlm_chunks(torch, engine, req, card: str) -> dict:
    """One image request's chunked prefill on a fresh 1-slot pool, each
    chunk timed (host ms to a synchronize): the first carries the image
    (n_img + C rows at start 0), the rest start past it; then its
    whole-prompt prefill, which the chunks must equal bitwise (logits and
    the prompt's pages). → ms of the first chunk and of the later ones."""
    from repro_torch.serving.scheduler import Scheduler

    chk = Scheduler(engine, n_slots=1, prefix_cache=False)
    chk.submit(req)
    chk.admit()
    pf = chk._prefilling[0]
    times = []
    for k in range(len(pf.chunks)):
        kw = {"patches": req.patches} if k == 0 else {}
        ms, (logits_c, pool) = timed_ms(torch, lambda k=k, kw=kw:
                                        engine.prefill_chunk(
                                            chk.pool, pf.slot, pf.chunks[k],
                                            pf.starts[k], pf.seq_ends[k],
                                            k == len(pf.chunks) - 1, **kw))
        times.append(ms)
    whole_ms, (logits_w, whole) = timed_ms(
        torch, lambda: engine.prefill(req.prompt[None],
                                      patches=req.patches))
    s = engine.prefix_len(req) + len(req.prompt)
    if not torch.isfinite(logits_w).all():
        raise AssertionError("non-finite vlm prefill logits")
    if not torch.equal(logits_c, logits_w):
        raise AssertionError("vlm chunked prefill logits != whole prefill")
    for key, leaf in whole["layers"].items():
        if not torch.equal(pool["layers"][key][:, 0, :, :s],
                           leaf[:, 0, :, :s]):
            raise AssertionError(f"vlm chunked prefill '{key}' != whole")
    log(f"  [llava] an image request ({engine.prefix_len(req)} image rows + "
        f"{len(req.prompt)} tokens) in {len(times)} chunks (starts "
        f"{pf.starts}, widths {[c.shape[1] for c in pf.chunks]}): logits "
        f"and pages bitwise its whole-prompt prefill; first chunk "
        f"({engine.prefix_len(req) + pf.chunks[0].shape[1]} rows) "
        f"{times[0]:.1f} ms, later chunks "
        + ", ".join(f"{t:.1f}" for t in times[1:])
        + f" ms, whole prefill ({s} rows) {whole_ms:.1f} ms (host ms to a "
        f"synchronize, eager) [{card}]")
    del chk, pool, whole
    return dict(first_chunk_ms=times[0], chunk_ms=times[1:],
                whole_ms=whole_ms)


def vlm_prefix_arm(torch, np, engine, reqs, card: str) -> dict:
    """Two image requests with the same text and their own images: no
    hit, nothing interned. Then two text-only requests sharing their
    first 1024 tokens on the same Scheduler: the second hits all 8
    blocks, and its tokens equal its lockstep's."""
    from dataclasses import replace

    from repro_torch.serving.api import GenerateRequest
    from repro_torch.serving.scheduler import Scheduler, lockstep_generate

    cfg = engine.cfg
    rng = np.random.default_rng(VLM_SEED + 1)
    sched = Scheduler(engine, n_slots=N_SLOTS, check_invariants=True)
    text = reqs[0].prompt
    for rid, r in enumerate(reqs[:2]):
        sched.submit(replace(r, rid=rid, prompt=text, arrival=None))
        sched.run_to_completion()
    if sched.prefix_hits or sched.prefix_store.cached_tokens:
        raise AssertionError(f"image requests touched the prefix store: "
                             f"{sched.prefix_hits} hits, "
                             f"{sched.prefix_store.cached_tokens} tokens")
    shared = rng.integers(0, cfg.vocab, VLM_SHARED_TEXT).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 64)
                               .astype(np.int32)]) for _ in range(2)]
    for rid, p in enumerate(prompts, start=2):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=GEN))
        sched.run_to_completion()
    res = {r.rid: r for r in sched.results}
    if (sched.prefix_hits, res[3].cached_len) != (1, VLM_SHARED_TEXT):
        raise AssertionError(f"text-only requests: {sched.prefix_hits} "
                             f"hits, cached {res[3].cached_len}")
    ref = lockstep_generate(engine, prompts[1], GEN)
    if res[3].tokens != ref:
        raise AssertionError("text-only prefix hit != its lockstep")
    log(f"  [llava prefix store] 2 image requests with one text: 0 hits, "
        f"nothing interned; 2 text-only requests sharing "
        f"{VLM_SHARED_TEXT} tokens: 1 hit of {res[3].cached_len} tokens "
        f"(TTFT {res[2].ttft * 1e3:.1f} ms cold, {res[3].ttft * 1e3:.1f} ms "
        f"hit), the hit's tokens == lockstep [{card}]")
    return dict(cold_ttft_ms=res[2].ttft * 1e3, hit_ttft_ms=res[3].ttft * 1e3)


def vlm_spec_arm(torch, np, dense, reqs, cap: int, card: str) -> dict:
    """2 image requests speculatively (γ 4, the draft 15 of 30 layers at
    k_keep 1) on the no-LOP engine against plain decode of the same
    requests: equal, or a first divergence that is a near-tie of rounding
    (:func:`rounding_verdict`)."""
    from dataclasses import replace

    sreqs = [replace(r, arrival=None) for r in reqs[:VLM_SPEC_REQUESTS]]
    with kept_lanes() as lanes:
        plain = serve_run(torch, np, dense, sreqs, "llava plain no-LOP",
                          card, capacity=cap)
    plain = dict(plain, lanes=lanes, tokens={
        rid: r.tokens for rid, r in plain["results"].items()})
    with kept_lanes() as lanes:
        spec = dict(spec_run(torch, np, dense, sreqs, "llava spec no-LOP",
                             card), lanes=lanes)
    ties = compare_streams(torch, np, dense, sreqs, spec, plain,
                           "llava spec no-LOP", card)
    log(f"  [llava spec] {spec['rounds']} rounds, accept rate "
        f"{spec['accept_rate']:.3f}, draft step {spec['draft_ms']:.2f} ms "
        f"(graph, {dense.draft_layers} of {dense.cfg.n_layers} layers), "
        f"verify chunk {spec['verify_ms']:.2f} ms (eager); "
        f"{spec['tokens_per_s']:.2f} tok/s vs plain "
        f"{plain['tokens_per_s']:.2f}; near-ties {len(ties)} [{card}]")
    return dict(tokens_per_s=spec["tokens_per_s"],
                plain_tokens_per_s=plain["tokens_per_s"],
                draft_ms=spec["draft_ms"], verify_ms=spec["verify_ms"],
                accept_rate=spec["accept_rate"], near_ties=len(ties),
                counts=spec["counts"])


def vlm_arm(torch, np, card: str) -> dict:
    """(b) llava-next-34b at full width (d 7168, 56 heads of 128 over 8, f
    20,480, vocab 64,000, 2,880 image rows), drawn on the card one layer
    at a time at full depth (60 layers) and served at its first
    ``VLM_SERVE_LAYERS``: 8
    image requests (default_rng(4):
    64–512 text tokens and 2,880 patch rows of 0.02·N(0, 1) each), 32
    new tokens, 4 slots, chunked; greedy LOP, no-LOP, then 4 sampled with
    a NaN lane through the retry; the decode step on graphs and eager, a
    request's chunks against its whole prefill, the prefix store and
    speculation, #3 and #4/#5 at G 7 on the served pages. → stats."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving import faults
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.cache import capacity_for
    from repro_torch.serving.quantize import init_serving_params
    from repro_torch.serving.scheduler import Scheduler, lockstep_generate

    cfg = get_config("llava-next-34b")
    n_img = cfg.n_img_tokens
    qp, draw_s, draw_peak = drawn(torch, lambda: init_serving_params(
        cfg, SEED, "cuda"))
    if draw_peak >= DRAW_PEAK_LIMIT:
        raise AssertionError(f"llava's draw peaked at "
                             f"{draw_peak / 2**30:.2f} GiB")
    drawn_layers = cfg.n_layers
    # served at the first VLM_SERVE_LAYERS layers of the full-depth draw
    # (views of the stacked leaves), to keep the smoke run in its time
    cfg = cfg.replace(n_layers=VLM_SERVE_LAYERS)
    qp = dict(qp, layers=leaves_cut(qp["layers"], VLM_SERVE_LAYERS))
    max_len = VLM_MAX_TEXT + GEN + n_img
    cap = capacity_for(cfg, max_len)
    engine = PooledEngine(cfg, qp, max_len=max_len, device="cuda")
    by_part = {name: tree_bytes(qp[name]) for name in qp}
    log(f"  [llava] seeded weights drawn and quantized one layer at a time "
        f"in {draw_s:.1f} s ({drawn_layers} layers, served at the first "
        f"{cfg.n_layers}; d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads}, f "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {n_img} image rows): peak while "
        f"drawing {draw_peak / 2**30:.2f} GiB (limit "
        f"{DRAW_PEAK_LIMIT / 2**30:.0f}); served weights "
        f"{tree_bytes(qp) / 2**30:.3f} GiB ("
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in by_part.items())
        + f" GiB); a {N_SLOTS}-slot pool of capacity {cap} "
        f"{tree_bytes(engine.init_pool(N_SLOTS)) / 2**30:.3f} GiB; "
        f"has_image_prefix={engine.has_image_prefix}, "
        f"supports_chunked={engine.supports_chunked} [{card}]")
    reqs = make_requests(cfg, n_requests=N_REQUESTS,
                         min_prompt=VLM_MIN_TEXT, max_prompt=VLM_MAX_TEXT,
                         gen=GEN, seed=VLM_SEED)
    log("  [llava] text lengths: " + ", ".join(str(len(r.prompt))
                                               for r in reqs))
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2, patches=reqs[0].patches))
    warm.run_to_completion()
    del warm
    chunks = vlm_chunks(torch, engine, max(reqs, key=lambda r: len(
        r.prompt)), card)
    out = dict(draw_peak_bytes=draw_peak, draw_s=draw_s,
               weight_bytes=tree_bytes(qp), chunks=chunks)
    idle = (DENSE, "fused_qlinear_experts", "fused_ffn_experts")
    dense = PooledEngine(cfg, qp, max_len=max_len, use_lop=False,
                         device="cuda")
    # the steady decode step: the 4 shortest prompts, with room for its
    # 96 tokens a lane
    short = [replace(r, prompt=r.prompt[:cap - 1 - n_img - 96])
             for r in sorted(reqs, key=lambda r: len(r.prompt))[:N_SLOTS]]
    for label, eng, launched, off in (
            ("llava LOP greedy", engine, LOP_PATH, idle),
            ("llava no-LOP greedy", dense,
             ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
              DENSE), ("fused_decode_attention", *idle[1:]))):
        run = serve_run(torch, np, eng, reqs, label, card, capacity=cap)
        check_counts(run["counts"], label, launched, idle=off)
        check_tokens(cfg, run["results"], GEN, label)
        check_lockstep(eng, reqs, run["results"], (0, 1), label)
        sched = run.pop("sched")
        if eng is engine:
            rng = np.random.default_rng(SEED + 11)
            layer = cfg.n_layers // 2
            cl = layer_slice(sched.pool["layers"], layer)
            # lanes deep into the image's rows and past them; one retired
            lens = torch.tensor([cap - 56, 0, n_img + 70, n_img + 300],
                                dtype=torch.int32, device="cuda")
            out["rows"] = dict(
                first_chunk=prefill_chunk_rows(
                    torch, np, rng, cfg, cl, 0, n_img + engine.chunk_tokens,
                    "llava first chunk (image + text)", card),
                text_chunk=prefill_chunk_rows(
                    torch, np, rng, cfg, cl, n_img + engine.chunk_tokens,
                    engine.chunk_tokens, "llava text chunk", card),
                decode=decode_rows(torch, np, rng, cfg, cl, lens,
                                   "llava served pages", card))
            del cl
        del sched
        if eng is engine:
            # the clean decode step, graph and eager, on the LOP engine
            step = decode_arms(torch, np, eng, short, label, card)
            out.update(decode_step_ms_p50=step["ms"],
                       eager_decode_step_ms_p50=step["eager_ms"])
            del step
        out[label] = dict(
            counts=run["counts"], tokens=tokens_digest(run["results"]),
            tokens_per_s=run["tokens_per_s"],
            ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
            serve_cycle_decode_ms_p50=run["serve_cycle_decode_ms_p50"])
        del run

    # 4 sampled requests, one lane's logits NaN once: the lane recovers
    # through the dense retry; every request runs to its length
    label = "llava LOP sampled + NaN lane"
    sreqs = [replace(r, sampling=sampled_params(r.rid)) for r in reqs[:4]]
    with faults.inject(faults.FaultPlan(nan_logits=VLM_NAN_CALLS)):
        run = serve_run(torch, np, engine, sreqs, label, card, capacity=cap,
                        check_invariants=True)
    fs = run.pop("sched")
    if not (fs.fault_events >= 1 and fs.fault_recoveries == fs.fault_events
            and fs.fault_finishes == 0):
        raise AssertionError(f"[{label}] events {fs.fault_events}, "
                             f"recoveries {fs.fault_recoveries}, finishes "
                             f"{fs.fault_finishes}")
    check_tokens(cfg, run["results"], GEN, label)
    clean = next(r for r in sreqs if r.rid not in fs.fault_rids)
    ref = lockstep_generate(engine, clean.prompt, GEN,
                            sampling=clean.sampling, patches=clean.patches)
    if run["results"][clean.rid].tokens != ref:
        raise AssertionError(f"[{label}] rid {clean.rid} != its lockstep")
    log(f"  [{label}] {fs.fault_events} NaN events, all recovered through "
        f"the dense retry (rids {sorted(fs.fault_rids)}); rid {clean.rid}'s"
        f" sampled stream == its lockstep [{card}]")
    out[label] = dict(counts=run["counts"],
                      tokens=tokens_digest(run["results"]),
                      tokens_per_s=run["tokens_per_s"],
                      ttft_p50_ms=run["ttft_p50_ms"])
    del run, fs
    out["prefix"] = vlm_prefix_arm(torch, np, engine, reqs, card)
    out["spec"] = vlm_spec_arm(torch, np, dense, reqs, cap, card)
    g, d = out["llava LOP greedy"], out["llava no-LOP greedy"]
    log(f"  [llava] greedy LOP {g['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{g['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{out['decode_step_ms_p50']:.2f} ms, eager "
        f"{out['eager_decode_step_ms_p50']:.2f} ms, peak while serving "
        f"{g['peak_bytes'] / 2**30:.2f} GiB; no-LOP {d['tokens_per_s']:.2f} "
        f"tok/s, serve-cycle decode p50 {d['serve_cycle_decode_ms_p50']:.2f}"
        f" ms; first chunk "
        f"{chunks['first_chunk_ms']:.1f} ms; tokens sha256 {g['tokens']} / "
        f"{d['tokens']} / {out['llava LOP sampled + NaN lane']['tokens']} "
        f"[{card}]")
    del engine, dense, qp
    free_cuda(torch)
    return out


def mistral_arm(torch, np, card: str) -> dict:
    """(c) mistral-nemo-12b at full width (d 5120, 32 heads of 128 over 8
    — q_dim 4096 ≠ d —, f 14,336, vocab 131,072), its first
    ``MISTRAL_LAYERS`` of 40 layers (the smoke run's time), drawn on the
    card one layer at a time: phase 4's 8 requests greedy LOP,
    scheduler == lockstep for 2 rids, the decode step on graphs and eager,
    #1 at the O projection (k 4096 → n 5120) bitwise its plain version.
    → stats."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.quantize import init_serving_params
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("mistral-nemo-12b").replace(n_layers=MISTRAL_LAYERS)
    qp, draw_s, draw_peak = drawn(torch, lambda: init_serving_params(
        cfg, SEED, "cuda"))
    engine = PooledEngine(cfg, qp, max_len=MAX_PROMPT + GEN, device="cuda")
    log(f"  [mistral-nemo] seeded weights drawn and quantized one layer at "
        f"a time in {draw_s:.1f} s ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} over "
        f"{cfg.n_kv_heads}, q_dim {cfg.q_dim}, f {cfg.d_ff}, vocab "
        f"{cfg.vocab}): peak while drawing {draw_peak / 2**30:.2f} GiB, "
        f"serving weights {tree_bytes(qp) / 2**30:.3f} GiB [{card}]")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    rows = projection_rows(
        torch, np, {"wo": layer_slice(qp["layers"]["attn"], 0)["wo"]},
        "mistral-nemo", "layer 0's served weights", card, SEED + 13)
    label = "mistral-nemo LOP greedy"
    run = serve_run(torch, np, engine, reqs, label, card)
    check_counts(run["counts"], label, LOP_PATH,
                 idle=(DENSE, "fused_qlinear_experts", "fused_ffn_experts"))
    check_tokens(cfg, run["results"], GEN, label)
    check_lockstep(engine, reqs, run["results"], (0, 1), label)
    run.pop("sched")
    short = sorted(reqs, key=lambda r: len(r.prompt))[:N_SLOTS]
    step = decode_arms(torch, np, engine, short, label, card)
    out = dict(counts=run["counts"], tokens=tokens_digest(run["results"]),
               tokens_per_s=run["tokens_per_s"],
               ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
               decode_step_ms_p50=step["ms"],
               eager_decode_step_ms_p50=step["eager_ms"], rows=rows,
               draw_peak_bytes=draw_peak, draw_s=draw_s)
    log(f"  [mistral-nemo] {out['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{out['decode_step_ms_p50']:.2f} ms, eager "
        f"{out['eager_decode_step_ms_p50']:.2f} ms, peak while serving "
        f"{out['peak_bytes'] / 2**30:.2f} GiB; tokens sha256 "
        f"{out['tokens']} [{card}]")
    del run, step, engine, qp
    free_cuda(torch)
    return out


def vlm_phase(torch, np, card: str) -> dict:
    """Phase 4j: (a) the streamed draw bitwise the whole one at full-width
    bitnet-3b, (b) llava-next-34b and (c) mistral-nemo-12b at full width
    and depth; each arm's engines freed before the next. → stats, with
    every serve run's launches summed by kernel."""
    t0 = time.monotonic()
    free_cuda(torch)
    log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by the "
        f"earlier phases [{card}]")
    draw = streamed_draw_arm(torch, np, card)
    vlm = vlm_arm(torch, np, card)
    mistral = mistral_arm(torch, np, card)
    launches = {k: 0 for k in KERNEL_NAMES}
    runs = [r for key, r in vlm.items() if key.startswith("llava ")]
    for run in (*runs, vlm["spec"], mistral):
        for k in KERNEL_NAMES:
            launches[k] += run["counts"][k]
    vr = vlm["rows"]
    rows = {"fused_prefill_attention": {
                "llava first chunk": vr["first_chunk"],
                "llava text chunk": vr["text_chunk"]},
            "fused_decode_attention": {
                "llava G 7": vr["decode"]["fused_decode_attention"]},
            DENSE: {"llava G 7": vr["decode"][DENSE]},
            "fused_qlinear": {f"mistral-nemo {k}": v
                              for k, v in mistral["rows"].items()}}
    log(f"  phase 4j's serve runs launched {json.dumps(launches)}; phase 4j "
        f"took {time.monotonic() - t0:.1f} s")
    return dict(draw=draw, vlm=vlm, mistral=mistral, launches=launches,
                rows=rows)


# ---------------------------------------------------------------------------
# phase 4k: the QAT training path — train, quantize, serve
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 512
# lr 1e-3 (the reduced arm's scale) diverges at d 3200 from this seeded
# init, on the card and in the reference alike (scripts/train_lr_check.py)
TRAIN_LR, TRAIN_WARMUP = 1e-4, 1
RED_STEPS, RED_BATCH, RED_SEQ, RED_LR, RED_RESUME = 60, 8, 32, 3e-3, 30
RED_HELD, RED_TOL, RED_GNORM_TOL = 5, 1e-4, 1e-4
TRAIN_REQUESTS = 4


class StopAfter:
    """A preemption flag that trips after ``n`` polls (one a step)."""

    def __init__(self, n: int):
        self.n, self.polls = n, 0

    @property
    def preempted(self) -> bool:
        self.polls += 1
        return self.polls >= self.n


def train_full_arm(torch, np, card: str, lr: float = TRAIN_LR,
                   warmup: int = TRAIN_WARMUP, arch: str = "bitnet-3b",
                   steps: int = TRAIN_STEPS, seq: int = TRAIN_SEQ):
    """(a) ``arch`` (bitnet-3b; rwkv6-1.6b in phase 4l) at full width and
    depth: masters drawn on the card, then ``steps`` steps of
    ``make_train_step`` (batch 4 × ``seq``, peak ``lr`` after ``warmup``
    steps) with every step's loss, grad norm, lr and synchronized ms, the
    peak, and no kernel of the table launched. Gates: finite, and the
    last step's loss the lowest of the run (AdamW's first sign-like
    steps can raise the loss for a step or two; a run that ends above any
    earlier step did not train). → (trained masters, stats)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import make_train_step

    cfg = get_config(arch)
    tag = f"[train {arch}]"
    params, draw_s, draw_peak = drawn(torch, lambda: init_params(
        cfg, SEED, "cuda"))
    n_params = sum(p.numel() for _, p in leaves(params))
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, peak_lr=lr, warmup=warmup,
                              total_steps=steps)
    data = SyntheticDataset(cfg, seq_len=seq, global_batch=TRAIN_BATCH,
                            seed=SEED)
    held = torch.cuda.memory_allocated()
    state = (tree_bytes(params) + tree_bytes(opt.m) + tree_bytes(opt.v)
             + nbytes(opt.step))
    log(f"  {tag} {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd}, ffn {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params:,} f32 masters drawn on the card in "
        f"{draw_s:.1f} s (peak {draw_peak / 2**30:.2f} GiB); "
        f"{held / 2**30:.2f} GiB with the AdamW moments; batch "
        f"{TRAIN_BATCH} x {seq}, peak lr {lr}, warmup {warmup} [{card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, norms, step_ms = [], [], []
    for n in range(steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(n).items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        log(f"  {tag} step {n + 1}: loss {losses[-1]:.4f}, grad norm "
            f"{norms[-1]:.4f}, lr {float(m['lr']):.3e}, param norm "
            f"{float(m['param_norm']):.2f}, {step_ms[-1]:.1f} ms")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"{tag} training launched serving kernels: "
                             f"{counts}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{tag} non-finite losses {losses} or norms "
                             f"{norms}")
    low = min(losses[:-1])
    if not losses[-1] < low:
        raise AssertionError(f"{tag} loss did not fall: step {steps} "
                             f"{losses[-1]:.4f}, an earlier step {low:.4f}")
    log(f"  {tag} loss {losses[0]:.4f} (step 1) → {losses[-1]:.4f} (step "
        f"{steps}, the lowest; earlier low {low:.4f}); step ms p50 "
        f"{np.percentile(step_ms[1:], 50):.1f} (first {step_ms[0]:.1f}); "
        f"peak {peak / 2**30:.2f} GiB; launch counts while training "
        f"{counts} [{card}]")
    del opt, batch, m
    free_cuda(torch)
    return params, dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                        peak_bytes=peak, other_bytes=held - state,
                        draw_s=draw_s, draw_peak_bytes=draw_peak)


def step_parting(torch, cfg, masters, batch) -> dict:
    """Step 1's forward from the same masters on the CPU and on the card,
    every QAT BitLinear input recorded: the first input whose absmax int8
    values differ, and whether each differing element is a knife-edge
    (x/scale within 1e-4 of one half-integer on both sides: rounding, not
    a fault; what follows carries it). → {"edge", "text", ...}."""
    from repro_torch.core.quantization import quantize
    from repro_torch.models import layers
    from repro_torch.models.transformer import forward_train
    from repro_torch.tree_util import tree_map

    real = layers.bitlinear_qat
    rec = {}
    for dev in ("cpu", "cuda"):
        xs = rec[dev] = []

        def recorded(x, w, *a, xs=xs, **k):
            xs.append(x.detach().to("cpu", copy=True))
            return real(x, w, *a, **k)
        layers.bitlinear_qat = recorded
        try:
            with torch.no_grad():
                forward_train(cfg, tree_map(lambda t: t.to(dev), masters),
                              torch.from_numpy(batch["tokens"]).to(dev),
                              remat=False)
        finally:
            layers.bitlinear_qat = real
    before = 0.0
    for i, (a, b) in enumerate(zip(rec["cpu"], rec["cuda"])):
        qa, qb = quantize(a), quantize(b)
        apart = [tuple(j) for j in (qa.values != qb.values).nonzero().tolist()]
        if not apart:
            before = max(before, float((a - b).abs().max()))
            continue
        ratios = [(float(a[j] / qa.scale[j[:-1]]),
                   float(b[j] / qb.scale[j[:-1]])) for j in apart]
        edge = all(abs(r - math.floor(ra) - 0.5) < 1e-4
                   for ra, rb in ratios for r in (ra, rb))
        shown = [(round(x, 6), round(y, 6)) for x, y in ratios[:4]]
        return dict(edge=edge, index=i, elements=apart, ratios=ratios,
                    text=f"the int8 values of the first {i} of "
                    f"{len(rec['cpu'])} BitLinear inputs bitwise (f32 apart "
                    f"by at most {before:.2e}); input {i} parts at "
                    f"{len(apart)} element(s) {apart[:4]}, x/scale CPU / "
                    f"card {shown}"
                    f"{' (knife-edges)' if edge else ' (NOT knife-edges)'}")
    return dict(edge=True, index=None, text=f"all {len(rec['cpu'])} "
                f"BitLinear inputs' int8 values bitwise (f32 apart by at "
                f"most {before:.2e})")


def train_reduced_arm(torch, np, card: str) -> dict:
    """(b) reduced bitnet (2 layers, vocab 256): ``train_loop`` for 60 steps
    (batch 8 × 32, lr 3e-3, the reference's ``test_loss_decreases_qat``)
    with its gate; at f32, the same loop on the CPU and on the card from
    the same masters (drawn on the CPU: a CUDA generator draws other
    numbers): step 1's loss within 1e-4 and its pre-clip grad norm (the
    backward, before AdamW) within 1e-4 of itself, its forward's first
    int8 parting a knife-edge (``step_parting``), the later steps' parting
    printed (AdamW's first steps are sign-like, so a gradient element
    near zero that rounds the other way moves its master by 2·lr); a run
    preempted at step 30 (checkpointed)
    and resumed, its losses bitwise the uninterrupted run's."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import init_params
    from repro_torch.tree_util import tree_map

    cfg = get_config("bitnet-3b-reduced").replace(n_layers=2, vocab=256)
    kw = dict(steps=RED_STEPS, global_batch=RED_BATCH, seq_len=RED_SEQ,
              peak_lr=RED_LR, log_every=10 ** 6)
    t0 = time.monotonic()
    full = train_loop(cfg, device="cuda", **kw)
    secs = time.monotonic() - t0
    losses = full["losses"]
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last5 < first5 - 0.3:
        raise AssertionError(f"[train reduced] last-5 mean {last5:.4f} not "
                             f"below first-5 mean {first5:.4f} − 0.3")
    log(f"  [train reduced] bitnet-3b-reduced, 2 layers, vocab 256: "
        f"{RED_STEPS} steps in {secs:.1f} s, loss first-5 mean {first5:.4f} "
        f"→ last-5 mean {last5:.4f} (gate: below {first5 - 0.3:.4f}) "
        f"[{card}]")
    f32 = cfg.replace(act_dtype="float32")
    masters = init_params(f32, SEED, "cpu")      # the same draw on both
    held, gnorm = {}, {}
    for dev in ("cpu", "cuda"):
        norms = gnorm[dev] = []
        held[dev] = train_loop(
            f32, device=dev, preemption=StopAfter(RED_HELD),
            params=tree_map(lambda t: t.to(dev, copy=True), masters),
            hooks=[lambda n, p, o, m, norms=norms: norms.append(
                float(m["grad_norm"]))], **kw)["losses"]
    first = abs(held["cuda"][0] - held["cpu"][0])
    gn_rel = abs(gnorm["cuda"][0] / gnorm["cpu"][0] - 1)
    apart = max(abs(a - b) for a, b in zip(held["cuda"], held["cpu"]))
    data = SyntheticDataset(f32, seq_len=RED_SEQ, global_batch=RED_BATCH,
                            seed=SEED)
    part = step_parting(torch, f32, masters, data.batch(0))
    log(f"  [train reduced] f32 from the same masters, first {RED_HELD} "
        f"losses: CPU {[round(x, 6) for x in held['cpu']]}, card "
        f"{[round(x, 6) for x in held['cuda']]}: step 1 apart by "
        f"{first:.2e} (tol {RED_TOL}), the steps after by up to "
        f"{apart:.2e}; step 1's pre-clip grad norm CPU / card "
        f"{gnorm['cpu'][0]:.6f} / {gnorm['cuda'][0]:.6f}, apart by "
        f"{gn_rel:.2e} of it (tol {RED_GNORM_TOL}); step 1's forward: "
        f"{part['text']}")
    if (len(held["cuda"]) != RED_HELD or first > RED_TOL
            or gn_rel > RED_GNORM_TOL or not part["edge"]):
        raise AssertionError(f"[train reduced] card vs CPU {held}; grad "
                             f"norms {gnorm}; {part}")
    with tempfile.TemporaryDirectory() as ckpt:
        cut = train_loop(cfg, device="cuda", ckpt_dir=ckpt,
                         ckpt_every=10 ** 6,
                         preemption=StopAfter(RED_RESUME), **kw)
        rest = train_loop(cfg, device="cuda", ckpt_dir=ckpt,
                          ckpt_every=10 ** 6, **kw)
    if cut["last_step"] != RED_RESUME or len(rest["losses"]) != \
            RED_STEPS - RED_RESUME:
        raise AssertionError(f"[train reduced] cut at {cut['last_step']}, "
                             f"resumed {len(rest['losses'])} steps")
    if cut["losses"] + rest["losses"] != losses:
        raise AssertionError("[train reduced] resumed losses != the "
                             "uninterrupted run's")
    log(f"  [train reduced] checkpointed at step {RED_RESUME} and resumed: "
        f"steps {RED_RESUME + 1}–{RED_STEPS} bitwise the uninterrupted "
        f"run's ({rest['losses'][-1]:.6f} last) [{card}]")
    del full, cut, rest
    free_cuda(torch)
    return dict(first5=float(first5), last5=float(last5), step1_diff=first,
                step1_grad_norm_rel=gn_rel, held_apart=apart, seconds=secs)


def served_ffn_rows(torch, np, node, d: int, card: str, *,
                     rows_m=(N_SLOTS, MAX_PROMPT),
                     whose: str = "trained") -> dict:
    """#2 on a served FFN node (layer 0's, of the ``whose`` model) at the
    rows ``rows_m`` (the decode rows, m 4, and one 1536-token prompt's),
    bitwise its plain version, timed eagerly and in a CUDA graph beside
    its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.qlinear import fused_ffn

    rng = np.random.default_rng(SEED + 29)
    f = node["down_packed"].shape[0] * 4
    gs = ops._col_scale(node["gu_scale"], 2 * f).reshape(2 * f).contiguous()
    ds = ops._col_scale(node["down_scale"], d).reshape(d).contiguous()
    rows = {}
    for m in rows_m:
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).cuda()
        args = (x, node["gu_packed"].contiguous(), gs,
                node["down_packed"].contiguous(), ds)

        def kern(*a):
            return fused_ffn(*a, gated=True, act="silu")

        def ref(x_, gu_, gs_, down_, ds_):
            return plain.ffn_fused_ref(x_, gu_, gs_[None], down_, ds_[None],
                                       gated=True, act="silu")
        err = check_close(torch, f"fused_ffn[{whose}, m={m}]", kern(*args),
                          ref(*args), bitwise=True)
        sets = copies(torch, args)
        ms = cuda_ms(torch, kern, sets, 30)
        g_ms = graph_ms(torch, kern, sets)
        p_ms = cuda_ms(torch, ref, [args], 3)
        free_cuda(torch)
        b_ms, b_by = bound_ms(nbytes(*args) + m * d * 4,
                              int8_ops=2.0 * m * d * 3 * f)
        rows[f"m={m}"] = dict(max_abs_err=err, ms=ms, plain_ms=p_ms,
                              graph_ms=g_ms, bound_ms=b_ms, bound_by=b_by,
                              shape=f"m={m} d={d} f={f}")
        log(f"  fused_ffn on layer 0's {whose} served weights (m={m}, d={d}, "
            f"f={f}): bitwise the plain version; {ms:.4f} ms, in a CUDA "
            f"graph {g_ms:.4f} ms (plain {p_ms:.3f} ms, bound {b_ms:.6f} ms "
            f"by {b_by}; {b_ms / ms:.2%} of bound, {b_ms / g_ms:.2%} in the "
            f"graph) [{card}]")
        del x, args, sets
    return rows


def train_serve_arm(torch, np, params, card: str) -> dict:
    """(c) the trained masters quantized on the card (then dropped: the
    tree ``params`` is emptied) and served: phase 4's
    first 4 requests greedy LOP through the Scheduler, scheduler ==
    lockstep, #1 (QKV) and #2 on layer 0's trained served weights bitwise
    their plain versions. → stats with the serve run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.quantize import quantize_params
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("bitnet-3b")
    t0 = time.monotonic()
    qp = quantize_params(cfg, params)
    torch.cuda.synchronize()
    q_s = time.monotonic() - t0
    params.clear()              # the caller's tree too: the masters go
    free_cuda(torch)
    layer0 = layer_slice(qp["layers"], 0)
    qkv = layer0["attn"]["wqkv"]
    zeros = float((qkv["packed"] == 0).float().mean())
    gammas = [round(float(g), 5) for g in qkv["scale"][0, ::cfg.q_dim][:3]]
    log(f"  [trained serve] the trained masters quantized on the card in "
        f"{q_s:.1f} s: {tree_bytes(qp) / 2**30:.3f} GiB served; layer 0's "
        f"Q, K, V γ {gammas}, {zeros:.2%} of its code bytes all-zero "
        f"[{card}]")
    engine = PooledEngine(cfg, qp, max_len=MAX_PROMPT + GEN, device="cuda")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN,
                         seed=SEED)[:TRAIN_REQUESTS]
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    label = "trained bitnet-3b LOP greedy"
    run = serve_run(torch, np, engine, reqs, label, card)
    check_counts(run["counts"], label, LOP_PATH,
                 idle=(DENSE, "fused_qlinear_experts", "fused_ffn_experts"))
    check_tokens(cfg, run["results"], GEN, label)
    check_lockstep(engine, reqs, run["results"], (0, 1), label)
    rows = projection_rows(torch, np, {"wqkv": qkv},
                           "trained bitnet-3b", "layer 0's trained served "
                           "weights", card, SEED + 28)
    ffn = served_ffn_rows(torch, np, layer0["ffn"], cfg.d_model, card)
    out = dict(counts=run["counts"], tokens=tokens_digest(run["results"]),
               tokens_per_s=run["tokens_per_s"],
               ttft_p50_ms=run["ttft_p50_ms"], peak_bytes=run["peak_bytes"],
               quantize_s=q_s, rows=rows, ffn_rows=ffn)
    del run, engine, qp, layer0, qkv
    free_cuda(torch)
    return out


def train_phase(torch, np, card: str) -> dict:
    """Phase 4k: (a) bitnet-3b trained at full width and depth, (b) the
    reduced loop's loss drop, card against CPU and the bitwise resume,
    (c) (a)'s trained masters quantized and served. → stats, with the
    serve run's launches by kernel."""
    t0 = time.monotonic()
    free_cuda(torch)
    log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by the "
        f"earlier phases [{card}]")
    # bf16 products summed in f32 (the reference's preferred_element_type)
    matmul = torch.backends.cuda.matmul
    reduced_bf16 = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        params, full = train_full_arm(torch, np, card)
        # phase 8 (c): the dry-run's prediction of (a)'s step
        dry = dryrun_train_arm(torch, full, card)
        red = train_reduced_arm(torch, np, card)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced_bf16
    serve = train_serve_arm(torch, np, params, card)
    launches = {k: serve["counts"][k] for k in KERNEL_NAMES}
    log(f"  phase 4k's serve run launched {json.dumps(launches)}; phase 4k "
        f"took {time.monotonic() - t0:.1f} s")
    return dict(full=full, reduced=red, serve=serve, launches=launches,
                dryrun=dry)


# ---------------------------------------------------------------------------
# phase 4l: training of the recurrent families — train, quantize, serve;
# the int8 gradient compression's pieces (run in 4m's spawn)
# ---------------------------------------------------------------------------

# at seq 512 a full-width rwkv6 step took 8.1 s (the wkv time loop of
# plain ops, run three times under the nested remat, is host-bound), so
# (a) trains at seq 256. At peak lr 1e-4 its loss rises after step 2
# (11.60, 8.87, 9.41, 9.44; the grad norm 38,715 at step 3) and at 3e-5
# it falls at every step (scripts/train_lr_check.py --arch rwkv6-1.6b).
# 2 steps for the run's time: the loss falls at step 2, and step 1's
# update is the same at any step count
REC_TRAIN_STEPS, REC_TRAIN_SEQ, REC_TRAIN_LR = 2, 256, 3e-5
REC_RED_STEPS, REC_RED_LR = 12, 3e-3
MAMBA_TRAIN_T, MAMBA_HELD_T = 512, 16
DP_RANKS, DP_BATCH, DP_SEQ, EF_ROUNDS = 2, 8, 32, 16
COMPRESS_SHAPE = (2048, 7168)             # rwkv6's wk_c gradient


def rec_reduced_arm(torch, np, arch: str, card: str) -> dict:
    """(b) reduced ``arch`` (rwkv6 or jamba) at f32 from the same masters
    (drawn on the CPU), step 1 on the CPU and on the card: on its own
    forward the card parts from the CPU at knife-edges (the first parting
    BitLinear call's elements within 1e-4 of a half-integer; f32
    rounding of the two devices, which a flip carries through the
    recurrences), printed; with the CPU's int8 activations and ternary
    weights (``tests/torch_knife_edges.py``'s replay, the partings
    knife-edges) step 1's loss within 1e-4 and its pre-clip grad norm
    within 1e-4 of itself. Then ``train_loop`` on the card (bf16, batch
    8 x 32, lr 3e-3) whose last-5 mean loss falls below its first-5
    mean. → stats."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import init_params

    ke = tests_module("torch_knife_edges")
    knife_edges, step1_grads = ke.knife_edges, ke.step1_grads
    cfg = get_config(f"{arch}-reduced")
    f32 = cfg.replace(act_dtype="float32")
    masters = init_params(f32, SEED, "cpu")
    batch = SyntheticDataset(f32, seq_len=RED_SEQ, global_batch=RED_BATCH,
                             seed=SEED).batch(0)
    l_cpu, n_cpu, xs = step1_grads(f32, masters, batch, "cpu")
    l_own, n_own, own = step1_grads(f32, masters, batch, "cuda")
    flips, codes, first, _ = knife_edges(own, xs, 1e-4, first_only=True)
    l_sub, n_sub, sub = step1_grads(f32, masters, batch, "cuda", replay=xs)
    edges, sub_codes, _, widest = knife_edges(sub, xs, 1e-4)
    diff, gn_rel = abs(l_sub - l_cpu), abs(n_sub / n_cpu - 1)
    kw = dict(steps=REC_RED_STEPS, global_batch=RED_BATCH, seq_len=RED_SEQ,
              peak_lr=REC_RED_LR, log_every=10 ** 6)
    t0 = time.monotonic()
    losses = train_loop(cfg, device="cuda", **kw)["losses"]
    secs = time.monotonic() - t0
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"  [train {cfg.name}] f32 step 1 from the same masters, CPU / card"
        f" on its own forward: loss {l_cpu:.6f} / {l_own:.6f} "
        f"({abs(l_own - l_cpu):.2e} apart), pre-clip grad norm "
        f"{n_cpu:.6f} / {n_own:.6f} ({abs(n_own / n_cpu - 1):.2e} of it); "
        f"the first of {len(xs)} BitLinear calls that parts: {first} "
        f"({flips} int8 value(s), {codes} ternary code(s), knife-edges); "
        f"with the CPU's int8 activations and ternary weights "
        f"({edges} int8 knife-edges within {widest:.1e} of a half-integer, "
        f"{sub_codes} ternary): "
        f"loss {l_sub:.6f}, {diff:.2e} apart (tol {RED_TOL}), grad norm "
        f"{n_sub:.6f}, {gn_rel:.2e} of it (tol {RED_GNORM_TOL}); then "
        f"{REC_RED_STEPS} steps at {cfg.act_dtype} in {secs:.1f} s, loss "
        f"first-5 mean {first5:.4f} → last-5 mean {last5:.4f} [{card}]")
    if diff > RED_TOL or gn_rel > RED_GNORM_TOL or not last5 < first5:
        raise AssertionError(f"[train {cfg.name}] step 1 CPU {l_cpu}, "
                             f"{n_cpu}; card on the CPU's int8 {l_sub}, "
                             f"{n_sub}; first-5 {first5}, last-5 {last5}")
    free_cuda(torch)
    return dict(own_loss_diff=abs(l_own - l_cpu),
                own_grad_norm_rel=abs(n_own / n_cpu - 1), partings=flips,
                step1_diff=diff, step1_grad_norm_rel=gn_rel,
                first5=float(first5), last5=float(last5), seconds=secs)


def mamba_train_arm(torch, np, card: str) -> dict:
    """(c) one full-width jamba Mamba sublayer (d 8192, Di 16,384, S 16,
    dt_rank 512) drawn on the card: the training ``mamba_forward`` plus
    its backward at batch 1 x 512 bf16 tokens (8 remat'd chunks of 64),
    timed (host clock to a synchronize) and its peak; then at f32, T 16,
    every master's gradient card against CPU (the same masters and
    input; the card on the CPU's int8 activations and ternary weights,
    which part from its own only at knife-edges: x/scale within 1e-3 of
    a half-integer, |w|/γ within 1e-5 of ½) within rtol = atol = 1e-4.
    → stats."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import mamba
    from repro_torch.tree_util import flatten_with_path, tree_map

    ke = tests_module("torch_knife_edges")
    cfg = get_config("jamba-1.5-large-398b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 41)
    mp = mamba.mamba_init(gen, cfg, device="cuda")

    def grads(p, u, c, replay=None, record=False):
        masters = [t for _, t in flatten_with_path(p)]
        for t in masters:
            t.grad = None
            t.requires_grad_(True)
        with (ke.bitlinear_inputs(replay) if record
              else contextlib.nullcontext()) as rec:
            y, st = mamba.mamba_forward(c, p, u, train=True)
            (y.float().mean() + st["ssm"].mean()).backward()
        out = {k: t.grad for k, t in flatten_with_path(p)}
        for t in masters:
            t.requires_grad_(False)
            t.grad = None
        return out, rec

    u = torch.randn((1, MAMBA_TRAIN_T, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ops.reset_launch_counts()
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        g = grads(mp, u, cfg)[0]
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        del g
    if any(ops.launch_counts().values()):
        raise AssertionError(f"[train jamba Mamba] launched serving kernels: "
                             f"{ops.launch_counts()}")
    f32 = cfg.replace(act_dtype="float32")
    uh = torch.randn((1, MAMBA_HELD_T, cfg.d_model), generator=gen,
                     device="cuda")
    cpu_p = tree_map(lambda t: t.to("cpu", copy=True), mp)
    want, xs = grads(cpu_p, uh.cpu(), f32, record=True)
    got, own = grads(mp, uh, f32, replay=xs, record=True)
    edges, codes, _, widest = ke.knife_edges(own, xs, 1e-3)
    worst = {}
    for k, w in want.items():
        gk = got[k].cpu()
        torch.testing.assert_close(gk, w, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, k=k: f"{k}: {m}")
        worst[k] = float((gk - w).abs().max())
    far = max(worst, key=worst.get)
    log(f"  [train jamba Mamba] full width (d {cfg.d_model}, Di "
        f"{cfg.d_inner}, S {cfg.mamba_d_state}, dt_rank "
        f"{mamba.dt_rank(cfg)}): training forward + backward at 1 x "
        f"{MAMBA_TRAIN_T} bf16 tokens ({MAMBA_TRAIN_T // 64} remat chunks) "
        f"{ms[1]:.1f} / {ms[2]:.1f} ms (first {ms[0]:.1f}), peak "
        f"{peak / 2**30:.2f} GiB above the masters; no kernel of the table; "
        f"f32 gradients of {len(worst)} masters at T {MAMBA_HELD_T} card vs "
        f"CPU, the card on the CPU's int8 activations and ternary weights "
        f"({edges} int8 knife-edges, within {widest:.1e} of a "
        f"half-integer: k up to 16,384 summed in two orders; {codes} "
        f"ternary codes at |w|/γ = ½, γ a mean over up to 268M weights), "
        f"within rtol = atol = 1e-4 "
        f"(farthest {far}, {worst[far]:.2e} abs) [{card}]")
    del mp, cpu_p, got, want, u, uh
    free_cuda(torch)
    return dict(ms=ms, peak_bytes=peak, grad_apart=worst)


def rec_serve_arm(torch, np, params, card: str) -> dict:
    """(d) (a)'s trained rwkv6-1.6b masters quantized on the card (then
    dropped: ``params`` is emptied) and served at full width and depth:
    phase 4's first 4 requests greedy through the Scheduler (run to
    completion, exact-length prefill), 240 #1 launches a decode step and
    no other kernel of the table, scheduler == lockstep for rid 0; #1 on
    the trained layer 0's wk_c at m 4 and 1536 bitwise its plain version;
    the graph decode step. → stats with the serve run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.quantize import quantize_params
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("rwkv6-1.6b")
    t0 = time.monotonic()
    qp = quantize_params(cfg, params)
    torch.cuda.synchronize()
    q_s = time.monotonic() - t0
    params.clear()
    free_cuda(torch)
    # room for the steady steps' 96 (a recurrent state has no pages)
    engine = PooledEngine(cfg, qp, max_len=MAX_PROMPT + 96, device="cuda")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN,
                         seed=SEED)[:TRAIN_REQUESTS]
    log(f"  [trained rwkv6 serve] the trained masters quantized on the card "
        f"in {q_s:.1f} s: {tree_bytes(qp) / 2**30:.3f} GiB served; prompt "
        f"lengths " + ", ".join(str(len(r.prompt)) for r in reqs)
        + f" [{card}]")
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:16],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm
    label = "trained rwkv6-1.6b greedy"
    idle = tuple(k for k in KERNEL_NAMES if k != "fused_qlinear")
    run = recurrent_serve(torch, np, engine, reqs, label, card, 0,
                          ("fused_qlinear",), idle, lockstep=(0,))
    step_ms, sched = decode_step_ms(torch, np, engine, reqs)
    del sched
    rows = projection_rows(
        torch, np, {"wk_c": layer_slice(qp["layers"], 0)["tm"]["wk_c"]},
        "trained rwkv6", "layer 0's trained served weights", card,
        SEED + 30)
    log(f"  [trained rwkv6 serve] {run['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{run['ttft_p50_ms']:.1f} ms, decode step (B={N_SLOTS}) CUDA graph "
        f"{step_ms:.2f} ms, peak {run['peak_bytes'] / 2**30:.2f} GiB; "
        f"tokens sha256 {run['tokens']} [{card}]")
    run.update(decode_step_ms_p50=step_ms, rows=rows, quantize_s=q_s)
    del engine, qp
    free_cuda(torch)
    return run


def dp_rank(mesh, masters, batch) -> dict:
    """One process of phase 4m (f), a rank of a gloo group on cuda:0 (or,
    given a single-process mesh, every shard in this process): one
    data-parallel ``make_train_step`` of reduced rwkv6 on this rank's
    share of ``batch`` with ``CompressedMean`` (the int8 psum with error
    feedback, then the mean); the reference's error-feedback check on 2
    shards of 64 (a row each); one compressed and one plain f32
    all-reduce of a ``COMPRESS_SHAPE`` gradient timed. → the masters after
    the step (on the CPU), the check's running-mean errors, the ms."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.partitioning import Mesh, psum
    from repro_torch.tree_util import flatten_with_path, tree_map

    t_in = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    n = mesh.size(mesh.axis_names)
    data = Mesh(("data",), {"data": n}, mesh.group)
    local = data.local
    cfg = get_config("rwkv6-1.6b-reduced")
    params = tree_map(lambda t: t.to("cuda", copy=True), masters)
    rows = DP_BATCH // n
    r = 0 if local else data.rank("data")
    mine = {k: torch.from_numpy(v[r * rows:(r + 1) * rows] if not local
                                else v).cuda() for k, v in batch.items()}
    params, m = tests_module("torch_dp_rank").dp_step(cfg, params, mine,
                                                      data)
    out = {"params": {k: v.cpu() for k, v in flatten_with_path(params)},
           "loss": float(m["loss"]), "step_s": time.monotonic() - t_in}
    # error feedback: the running mean of the compressed sums converges
    full = np.random.default_rng(0).standard_normal((n, 64)).astype(
        np.float32)
    x = torch.from_numpy(full if local else full[r:r + 1]).cuda()
    exact = torch.from_numpy(full.sum(0)).cuda()
    err = torch.zeros_like(x)
    running, mean_err = torch.zeros(64, device="cuda"), []
    for i in range(1, EF_ROUNDS + 1):
        total, err = compressed_psum(x, "data", err, data)
        running += total[0]
        mean_err.append(float((running / i - exact).abs().max()))
    out["ef_mean_err"] = mean_err
    if not local:
        g = torch.randn(COMPRESS_SHAPE, device="cuda")
        e = torch.zeros_like(g)
        for name, fn in (("compressed", lambda: compressed_psum(
                g, "data", e, data)), ("f32", lambda: psum(g, "data", data))):
            ts = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_ms"] = float(np.median(ts[1:]))
    return out


def dp_inputs():
    """4m (f)'s inputs, made alike in every process: reduced rwkv6's
    seeded masters on the CPU and its first batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.transformer import init_params

    cfg = get_config("rwkv6-1.6b-reduced")
    return (init_params(cfg, SEED, "cpu"),
            SyntheticDataset(cfg, seq_len=DP_SEQ, global_batch=DP_BATCH,
                             seed=SEED).batch(0))


def compress_verdict(torch, ranks, one, card: str) -> dict:
    """4m (f): :func:`dp_rank` on the first 2 gloo ranks of the shared
    spawn (``ranks``) and on a single-process mesh of 2 shards in this
    process (``one``), from the same masters and batch: both ranks'
    masters after the step bitwise equal and bitwise the single-process
    mesh's; the error-feedback check's running mean after 16 rounds below
    half its first-round error on every rank; one compressed all-reduce's
    ms beside the plain f32 one's. → stats."""
    from repro_torch.tree_util import flatten_with_path

    masters, _ = dp_inputs()
    for i, rk in enumerate(ranks):
        for k, v in one["params"].items():
            if not torch.equal(rk["params"][k], v):
                raise AssertionError(f"(f) rank {i}'s {k} != the "
                                     f"single-process mesh's")
    moved = sum(not torch.equal(one["params"][k], v)
                for k, v in flatten_with_path(masters))
    for who, rk in (("rank 0", ranks[0]), ("rank 1", ranks[1]),
                    ("single-process mesh", one)):
        e = rk["ef_mean_err"]
        if not e[-1] < 0.5 * e[0]:
            raise AssertionError(f"(f) {who}: running-mean error {e}")
    log(f"  (f) the int8 gradient compression, reduced rwkv6, batch "
        f"{DP_BATCH} x {DP_SEQ} over {DP_RANKS} of the ranks (rank 0's step "
        f"{ranks[0]['step_s']:.1f} s): "
        f"one make_train_step with CompressedMean (int8 psum over gloo, "
        f"int32 codes on CUDA tensors): both ranks' masters "
        f"({len(one['params'])} leaves, {moved} moved) bitwise each other "
        f"and the single-process mesh's; losses {ranks[0]['loss']:.4f} / "
        f"{ranks[1]['loss']:.4f}; error feedback over {EF_ROUNDS} rounds, "
        f"running-mean max error {ranks[0]['ef_mean_err'][0]:.4f} → "
        f"{ranks[0]['ef_mean_err'][-1]:.4f}; one all-reduce of a "
        f"{COMPRESS_SHAPE[0]} x {COMPRESS_SHAPE[1]} f32 gradient: compressed "
        f"{ranks[0]['compressed_ms']:.2f} ms, plain f32 "
        f"{ranks[0]['f32_ms']:.2f} ms (rank 0, host clock to a synchronize)"
        f" [{card}]")
    return dict(compressed_ms=ranks[0]["compressed_ms"],
                f32_ms=ranks[0]["f32_ms"], ef_mean_err=ranks[0]["ef_mean_err"])


def rec_train_phase(torch, np, card: str) -> dict:
    """Phase 4l: (a) rwkv6-1.6b trained at full width and depth, (b)
    reduced rwkv6 and jamba card against CPU and a short loop, (c) a
    full-width jamba Mamba sublayer trained, (d) (a)'s masters quantized
    and served at full width and depth (the int8 gradient compression
    runs in phase 4m's spawn, as its (f)). → stats with (d)'s
    launches."""
    t0 = time.monotonic()
    free_cuda(torch)
    matmul = torch.backends.cuda.matmul
    reduced_bf16 = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        params, full = train_full_arm(torch, np, card, arch="rwkv6-1.6b",
                                      lr=REC_TRAIN_LR,
                                      steps=REC_TRAIN_STEPS,
                                      seq=REC_TRAIN_SEQ)
        serve = rec_serve_arm(torch, np, params, card)
        del params
        reduced = {arch: rec_reduced_arm(torch, np, arch, card)
                   for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b")}
        width = mamba_train_arm(torch, np, card)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced_bf16
    launches = {k: serve["counts"][k] for k in KERNEL_NAMES}
    log(f"  phase 4l's serve run launched {json.dumps(launches)}; phase 4l "
        f"took {time.monotonic() - t0:.1f} s")
    return dict(full=full, serve=serve, reduced=reduced, width=width,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 4f: sequence-parallel decode over 2 gloo ranks on the card
# ---------------------------------------------------------------------------

SP_RANKS, SP_CAPACITY, SP_STEPS = 2, 2048, 8
SP_LAYERS = 8                      # of bitnet-3b's 26 (the smoke run's time)
# arm → (use_lop, f-axis TP of the FFN, sequence-parallel)
SP_ARMS = {"sp": (True, False, True), "sp-tp": (True, True, True),
           "sp-dense": (False, False, True), "single": (True, False, False)}


def sp_prefill(torch, np, eng, prompts):
    """Each prompt prefilled alone at its exact length into its own lane
    of a fresh pool (replicated: every rank does the same). → (pool, the
    first tokens [B], their top-2 logit margins [B])."""
    pool = eng.init_pool(len(prompts))
    first, margin = [], []
    for slot, prompt in enumerate(prompts):
        logits, cache = eng.prefill(np.asarray(prompt)[None])
        eng.insert(pool, slot, cache)
        top = logits.topk(2, dim=-1).values
        first.append(logits.argmax(-1))
        margin.append(top[:, 0] - top[:, 1])
    return pool, torch.cat(first), torch.cat(margin)


def shard_digests(torch, pool, ranks, local: bool) -> dict:
    """sha256 (16 hex digits) of every layer leaf of each shard this
    process holds: {rank: {"key/layer": digest}}."""
    out = {}
    m = pool["layers"]["k"].shape[3]
    n_rows = m // len(ranks) if local else m
    for i, r in enumerate(ranks):
        rows = slice(i * n_rows, (i + 1) * n_rows) if local else slice(None)
        out[r] = {f"{key}/{layer}": hashlib.sha256(
            leaf[layer][:, :, rows].contiguous().cpu().numpy().tobytes()
        ).hexdigest()[:16] for key, leaf in pool["layers"].items()
            for layer in range(leaf.shape[0])}
    return out


def sp_gates(torch, np, eng, pool, mesh, ranks) -> dict:
    """Gates (b) and (c) on one layer of the prefilled pool (this process's
    shard), seeded queries and a new token: (b) the sequence-parallel
    attention at lop_keep 1 (and, on a single-process mesh holding the
    whole layer, the local dense decode it is held against); (c) each
    shard's kernel (out, m, ℓ) at the quota against its plain version."""
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.distributed.sp_decode import (_write_token_local,
                                                   sp_decode_attention)
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.serving.engine import lop_decode_attention
    from repro_torch.serving.lop_select import k_keep_blocks

    cfg = eng.cfg
    layer = cfg.n_layers // 2
    dev = pool["lengths"].device
    rng = np.random.default_rng(SEED + 7)
    b, h, hkv, dh = pool["lengths"].shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    qi = t(rng.integers(-127, 128, (b, h, dh)).astype(np.int8))
    qsc = t((rng.random((b, h, 1)) * 0.02 + 0.001).astype(np.float32))
    ki = t(rng.integers(-127, 128, (b, hkv, dh)).astype(np.int8))
    vi = t(rng.integers(-127, 128, (b, hkv, dh)).astype(np.int8))
    ksc = t((rng.random((b, hkv, 1)) * 0.02 + 0.001).astype(np.float32))
    vsc = t((rng.random((b, hkv, 1)) * 0.02 + 0.001).astype(np.float32))
    feat = pack_features(lop_features(ki))
    lengths = pool["lengths"]

    def layer_copy():
        return {k: v[layer].clone() for k, v in pool["layers"].items()}
    out = {}
    keep1 = cfg.replace(lop_keep=1.0)
    o, _ = sp_decode_attention(keep1, qi, qsc, ki, vi, ksc, vsc, feat,
                               layer_copy(), lengths, window=0, use_lop=True,
                               sp_axes=("model",))
    out["keep1"] = o.cpu().numpy()
    if mesh.local:
        whole = layer_copy()
        _write_token_local(whole, ki, vi, ksc, vsc, feat, lengths, 0,
                           whole["k"].shape[2])
        out["dense"] = lop_decode_attention(
            cfg, qi, qsc, whole, lengths + 1, window=0,
            use_lop=False).cpu().numpy()
    n = mesh.size("model")
    cl = layer_copy()
    m_loc = cl["k"].shape[2] // (n if mesh.local else 1)
    quota = max(1, -(-k_keep_blocks(cfg, m_loc * n) // n))
    err = 0.0
    for i, r in enumerate(ranks):
        part = {k: v[:, :, i * m_loc:(i + 1) * m_loc].contiguous()
                for k, v in cl.items()}
        _write_token_local(part, ki, vi, ksc, vsc, feat, lengths, r * m_loc,
                           m_loc)
        kw = dict(block=cfg.lop_block, k_keep=quota, window=0,
                  shared_select=bool(cfg.gqa_shared_select),
                  pos_offset=r * m_loc, return_stats=True)
        args = (qi, qsc, part["k"], part["v"], part["k_scale"],
                part["v_scale"], part["feat"], (lengths + 1).to(torch.int32))
        got = ops.decode_attention(*args, **kw)
        want = plain.decode_attention_ref(*args, softmax_scale=dh ** -0.5,
                                          **kw)
        for name, g_, w_ in zip(("out", "m", "l"), got, want):
            err = max(err, check_close(torch, f"sp shard {r} {name}", g_, w_))
    out["quota_err"], out["quota"] = err, quota
    return out


def sp_rank(mesh, prompts, steps: int) -> dict:
    """One process of phase 4f (a rank of the gloo group, or the
    single-process mesh holding both shards): full-width bitnet-3b from
    the seeded generator on the card, the prompts prefilled replicated
    into a 2048-slot pool, this process's token shard kept, then ``steps``
    greedy ``serve_step(sp_axes=("model",))`` calls eagerly, per arm of
    ``SP_ARMS`` (the single-card arm only on the single-process mesh).
    → numpy results: tokens, margins, step seconds, launch counts, shard
    digests, the gates' values."""
    from contextlib import nullcontext

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.partitioning import use_mesh
    from repro_torch.distributed.tp_ffn import use_ffn_tp
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as E
    from repro_torch.serving.api import PooledEngine

    cfg = get_config("bitnet-3b").replace(n_layers=SP_LAYERS)
    eng = PooledEngine.from_seed(cfg, seed=SEED, max_len=SP_CAPACITY - 1,
                                 device="cuda")
    n = mesh.size("model")
    ranks = list(range(n)) if mesh.local else [mesh.rank("model")]
    res = {"ranks": ranks}
    with use_mesh(mesh):
        for arm, (lop, tp, sp) in SP_ARMS.items():
            if not (sp or mesh.local):
                continue
            pool, tok, margin = sp_prefill(torch, np, eng, prompts)
            if pool["layers"]["k"].shape[3] != SP_CAPACITY:
                raise AssertionError("SP pool capacity "
                                     f"{pool['layers']['k'].shape[3]}")
            if sp:
                pool = E.shard_cache(pool)
            if arm == "sp":
                res["gates"] = sp_gates(torch, np, eng, pool, mesh, ranks)
            toks, margins, step_s = [tok], [margin], []
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with use_ffn_tp() if tp else nullcontext():
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, pool = E.serve_step(
                        cfg, eng.qp, pool, tok[:, None], use_lop=lop,
                        sp_axes=("model",) if sp else None)
                    tok = logits.argmax(-1)
                    top = logits.topk(2, dim=-1).values
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    toks.append(tok)
                    margins.append(top[:, 0] - top[:, 1])
            res[arm] = dict(
                counts=ops.launch_counts(), step_s=step_s,
                tokens=torch.stack(toks, 1).cpu().numpy(),
                margins=torch.stack(margins, 1).cpu().numpy(),
                digests=shard_digests(torch, pool, ranks, mesh.local)
                if sp else None)
            del pool
        if not mesh.local:
            res["collective_ms"] = collective_ms(torch, np, cfg, mesh,
                                                 eng.device)
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def collective_ms(torch, np, cfg, mesh, device) -> dict:
    """p50 host ms of one all_reduce (with the synchronize that ends it)
    of each tensor a decode layer reduces on the card: the merge's max and
    sum of (m, ℓ) [B, H, 1] and its sum of out [B, H, dh], and the TP FFN's
    sum [B, 1, d], over 20 calls after 3 warm ones."""
    from repro_torch.distributed.partitioning import pmax, psum
    b, h, dh, d = N_SLOTS, cfg.n_heads, cfg.hd, cfg.d_model
    out = {}
    for name, shape, op in (("pmax m", (b, h, 1), pmax),
                            ("psum l", (b, h, 1), psum),
                            ("psum out", (b, h, dh), psum),
                            ("psum ffn", (b, 1, d), psum)):
        x = torch.ones(shape, device=device)
        times = []
        for _ in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op(x, ("model",), mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times[3:]) * 1e3)
    return out


def sp_phase(torch, np, card: str) -> dict:
    """Phase 4f: the reference's production decode path on one card, 2
    gloo ranks on cuda:0 (each its token shard of a 2048-slot cache),
    against the same path on a single-process mesh holding both shards;
    gates (a) caches and tokens bitwise, (b) lop_keep 1 within 1e-3 of
    dense, (c) every rank's (out, m, ℓ) against its plain version. →
    launches of rank 0's sequence-parallel arms."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import local_mesh, spawn_ranks
    from repro_torch.launch.serve import make_requests

    cfg = get_config("bitnet-3b").replace(n_layers=SP_LAYERS)
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    prompts = [r.prompt for r in reqs[:N_SLOTS]]
    log(f"  prompts of {[len(p) for p in prompts]} tokens, capacity "
        f"{SP_CAPACITY} ({SP_CAPACITY // SP_RANKS} rows a rank), "
        f"{SP_STEPS} greedy steps an arm; arms {list(SP_ARMS)}")
    t0 = time.monotonic()
    local = sp_rank(local_mesh((SP_RANKS,)), prompts, SP_STEPS)
    log(f"  single-process mesh run: {time.monotonic() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left allocated "
        f"before the spawn")
    t0 = time.monotonic()
    ranks = spawn_ranks("chip_smoke:sp_rank", SP_RANKS, (prompts, SP_STEPS),
                        timeout=900)
    log(f"  {SP_RANKS} gloo ranks on cuda:0 ran in "
        f"{time.monotonic() - t0:.1f} s (spawn, weights, prefill, "
        f"{len(SP_ARMS) - 1} arms)")
    n_layers = cfg.n_layers
    for arm, (lop, tp, sp) in SP_ARMS.items():
        if not sp:
            continue
        attn = "fused_decode_attention" if lop else DENSE
        want = {"fused_qlinear": 2 * n_layers * SP_STEPS,
                "fused_ffn": n_layers * SP_STEPS, attn: n_layers * SP_STEPS}
        for r, res in enumerate(ranks):
            got = {k: v for k, v in res[arm]["counts"].items() if v}
            if got != want:
                raise AssertionError(f"[{arm}] rank {r} launched {got}, "
                                     f"want {want}")
            # (a) tokens and the cache shard bitwise the single-process run
            if not np.array_equal(res[arm]["tokens"], local[arm]["tokens"]):
                raise AssertionError(f"[{arm}] rank {r} tokens != the "
                                     f"single-process run's")
            if res[arm]["digests"][r] != local[arm]["digests"][r]:
                bad = [k for k, v in res[arm]["digests"][r].items()
                       if local[arm]["digests"][r][k] != v]
                raise AssertionError(f"[{arm}] rank {r} cache shard differs "
                                     f"at {bad[:6]}")
        steps_ms = [float(np.median(res[arm]["step_s"]) * 1e3)
                    for res in ranks]
        tok_s = [N_SLOTS * SP_STEPS / sum(res[arm]["step_s"]) for res in ranks]
        log(f"  [{arm}] gate (a): {SP_RANKS} ranks' tokens and cache shards "
            f"(5 leaves x {n_layers} layers each) bitwise the single-process "
            f"run; launches a rank a step: #1 {2 * n_layers}, #2 {n_layers}, "
            f"{attn} {n_layers}; eager step p50 "
            + " / ".join(f"{x:.1f}" for x in steps_ms)
            + " ms by rank (single-process mesh "
            f"{np.median(local[arm]['step_s']) * 1e3:.1f} ms), "
            + " / ".join(f"{x:.2f}" for x in tok_s)
            + f" tok/s; tokens sha256 "
            f"{hashlib.sha256(local[arm]['tokens'].tobytes()).hexdigest()[:16]}"
            f" [{card}]")
    log("  one all_reduce through gloo on CUDA tensors (p50 host ms with "
        "its synchronize, by rank): " + "; ".join(
            f"{k} " + " / ".join(f"{res['collective_ms'][k]:.3f}"
                                 for res in ranks)
            for k in ranks[0]["collective_ms"]) + f" [{card}]")
    # (b) lop_keep 1: the merge is exact attention up to rounding
    dense = local["gates"]["dense"]
    for r, res in enumerate(ranks):
        if not np.array_equal(res["gates"]["keep1"], local["gates"]["keep1"]):
            raise AssertionError(f"rank {r}: lop_keep 1 output != the "
                                 f"single-process run's")
        rel = (float(np.abs(res["gates"]["keep1"] - dense).max())
               / (float(np.abs(dense).max()) + 1e-9))
        if not rel < 1e-3:
            raise AssertionError(f"gate (b): rank {r} err/ref {rel:.3g}")
    # (c) checked inside each rank (check_close raises)
    log(f"  gate (b): lop_keep 1 SP attention on layer {n_layers // 2}'s "
        f"pooled K/V, err/ref {rel:.3g} < 1e-3 against the local dense "
        f"decode; gate (c): each rank's #4 (out, m, ℓ) at the quota "
        f"k_keep {ranks[0]['gates']['quota']} on its own shard within "
        f"rtol=atol={TOL['rtol']} of the plain version (max |err| "
        + " / ".join(f"{res['gates']['quota_err']:.3g}" for res in ranks)
        + ")")
    sp_t, one = local["sp"]["tokens"], local["single"]["tokens"]
    parts = []
    for lane in range(sp_t.shape[0]):
        hit = np.flatnonzero(sp_t[lane] != one[lane])
        if hit.size:
            i = int(hit[0])
            parts.append(f"lane {lane} at token {i} (top-2 margin SP "
                         f"{local['sp']['margins'][lane, i]:.4f}, single "
                         f"{local['single']['margins'][lane, i]:.4f})")
        else:
            parts.append(f"lane {lane} never")
    log("  SP (quota selection) vs single-card decode (global top-K), "
        "where the greedy tokens first part: " + "; ".join(parts)
        + f" [{card}]")
    return dict(lop=ranks[0]["sp"]["counts"]["fused_decode_attention"],
                dense=ranks[0]["sp-dense"]["counts"][DENSE],
                step_ms={arm: float(np.median(ranks[0][arm]["step_s"]) * 1e3)
                         for arm in ("sp", "sp-tp", "sp-dense")})


# ---------------------------------------------------------------------------
# phase 5: the standalone kernels and the per-head LOP decode
# ---------------------------------------------------------------------------

STANDALONE = ("ternary_matmul", "lop_scores_kernel", "int8_flash_prefill",
              "sparse_decode_attention")
TINT_SHAPES = (("qkv", 3200, 9600), ("o", 3200, 3200),
               ("gate_up", 3200, 17280), ("down", 8640, 3200))
PER_HEAD_LEN = (1600, 1, 700, 1200)


def cache_lanes(torch, np, engine) -> dict:
    """K/V, scales and LOP features of the last layer for 4 lanes, each a
    whole-prompt prefill of a seeded prompt of PER_HEAD_LEN tokens on the
    serve engine. → {leaf: [B, Hkv, M, ...]}."""
    cfg = engine.cfg
    rng = np.random.default_rng(SEED + 13)
    leaves = {key: [] for key in ("k", "v", "k_scale", "v_scale", "feat")}
    for n in PER_HEAD_LEN:
        prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
        _, cache = engine.prefill(prompt[None])
        for key, vals in leaves.items():
            vals.append(cache["layers"][key][cfg.n_layers - 1, 0].clone())
        del cache
    return {key: torch.stack(vals) for key, vals in leaves.items()}


def time_row(torch, kern, ref, args, n_iter, b_ms, b_by, lib):
    """Time ``kern`` (L2 cold) and ``ref`` on ``args``, and the library
    call ``lib = (fn, its args)`` (L2 cold). → the row fields."""
    fn, lib_args = lib
    return dict(ms=cuda_ms(torch, kern, copies(torch, args), n_iter),
                plain_ms=cuda_ms(torch, ref, [args], 3),
                library_ms=cuda_ms(torch, fn, copies(torch, lib_args),
                                   n_iter),
                bound_ms=b_ms, bound_by=b_by)


def fmt_row(row) -> str:
    return (f"{row['ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']})")


def standalone_kernels(torch, np, lanes, card) -> dict:
    """Part 1: each standalone kernel against its plain version on the
    card, at full width, with its times. → rows by kernel name."""
    from repro_torch.core.lop import features_to_pot, pot, unpack_features
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_attention import (
        flash_prefill_launch_shape, int8_flash_prefill,
        sparse_decode_attention, sparse_decode_launch_shape)
    from repro_torch.kernels.lop_scores import launch_shape as \
        lop_launch_shape
    from repro_torch.kernels.lop_scores import lop_scores_kernel
    from repro_torch.kernels.ternary_matmul import launch_shape as \
        tint_launch_shape
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.serving.lop_select import select_blocks

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 14)
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- #7 ternary_matmul: the four projections at m = 4 and 128 ----
    log(f"  ternary_matmul: decode kernel {ptxas_summary(_build, 'ternary_matmul', 'ternary_matmul_decode_kernel')}; "
        f"chunk kernel {ptxas_summary(_build, 'ternary_matmul', 'ternary_matmul_chunk_kernel')}")
    err, first = 0.0, None
    for m in (4, 128):
        for label, k, n in TINT_SHAPES:
            x = t(rng.integers(-127, 128, (m, k)).astype(np.int8))
            packed = t(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
            got = ternary_matmul(x, packed)
            want = plain.ternary_matmul_ref(x, packed, k)
            err = max(err, check_close(torch, f"ternary_matmul[{label},m={m}]",
                                       got, want, bitwise=True))
            # library yardstick: torch._int_mm on the unpacked int8 weight
            # (4x the weight bytes); it wants more than 16 rows, so m = 4
            # is padded to 32
            w8 = unpack_ternary(packed, k)
            x_pad = torch.zeros((max(m, 32), k), dtype=torch.int8,
                                device=dev)
            x_pad[:m] = x
            if not torch.equal(torch._int_mm(x_pad, w8)[:m], want):
                raise AssertionError("torch._int_mm disagrees with the "
                                     "plain TINT GEMM")
            b_ms, b_by = bound_ms(nbytes(x, packed) + m * n * 4,
                                  int8_ops=2.0 * m * k * n)
            row = time_row(torch, ternary_matmul,
                           lambda a, b: plain.ternary_matmul_ref(a, b, k),
                           (x, packed), 50, b_ms, b_by,
                           lib=(torch._int_mm, (x_pad, w8)))
            g_ms = graph_ms(torch, ternary_matmul, copies(torch, (x, packed)))
            log(f"  ternary_matmul {label} m={m} k={k} n={n}: {fmt_row(row)}"
                f" bitwise=True{' (_int_mm at 32 rows)' if m < 32 else ''}; "
                f"in a CUDA graph {g_ms:.4f} ms; {b_ms / row['ms']:.1%} of "
                f"bound ({b_ms / g_ms:.1%} in the graph); "
                f"{fmt_shape(tint_launch_shape(m, k, n))} [{card}]")
            if first is None:
                first = dict(row, shape=f"{label} m={m} k={k} n={n}")
    # check only: k above the former 13,952 cap (qwen1.5-32b's down
    # projection)
    k, n = 27392, 5120
    for m in (4, 128):
        x = t(rng.integers(-127, 128, (m, k)).astype(np.int8))
        packed = t(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
        err = max(err, check_close(
            torch, f"ternary_matmul[k={k},n={n},m={m}]", ternary_matmul(
                x, packed), plain.ternary_matmul_ref(x, packed, k),
            bitwise=True))
        log(f"  ternary_matmul m={m} k={k} n={n}: bitwise=True (check only)")
        del x, packed
    rows["ternary_matmul"] = dict(first, max_abs_err=err)

    # ---- #6 lop_scores_kernel: every (B, Hkv) lane of the cache ----
    b, hkv, m_cap, dh = lanes["k"].shape
    n_lanes = b * hkv
    qi = t(rng.integers(-127, 128, (b, hkv, dh)).astype(np.int8))
    q_pot = pot(qi).reshape(n_lanes, 1, dh)
    feat = lanes["feat"].reshape(n_lanes, m_cap, dh // 2)
    got = lop_scores_kernel(q_pot, feat)
    want = plain.lop_scores_ref(q_pot, feat)
    err = check_close(torch, "lop_scores_kernel", got, want, bitwise=True)
    # library yardstick: one batched f32 product of the unpacked pot
    # operands (exact: |score| < 2^24); _int_mm is 2-D and has no lanes
    k_pot = features_to_pot(unpack_features(feat)).float().transpose(1, 2)
    q_f = q_pot.float()
    if not torch.equal(torch.bmm(q_f, k_pot).to(torch.int32), want):
        raise AssertionError("torch.bmm disagrees with the plain LOP screen")
    b_ms, b_by = bound_ms(nbytes(q_pot, feat) + n_lanes * m_cap * 4,
                          int8_ops=2.0 * n_lanes * m_cap * dh)
    row = time_row(torch, lop_scores_kernel,
                   plain.lop_scores_ref, (q_pot, feat), 50, b_ms, b_by,
                   lib=(torch.bmm, (q_f, k_pot)))
    g_ms = graph_ms(torch, lop_scores_kernel, copies(torch, (q_pot, feat)))
    shape = lop_launch_shape(n_lanes, 1, m_cap, dh)
    log(f"  lop_scores_kernel lanes={n_lanes} g=1 M={m_cap} d={dh}: "
        f"{fmt_row(row)} bitwise=True (library: torch.bmm, f32 pot); in a "
        f"CUDA graph {g_ms:.4f} ms; {b_ms / row['ms']:.1%} of bound "
        f"({b_ms / g_ms:.1%} in the graph); {shape['ctas']} CTAs x "
        f"{shape['warps']} warps ({shape['tiles']} tiles of "
        f"{shape['tokens']} tokens a lane), {shape['smem']} B dynamic smem; "
        f"{ptxas_summary(_build, 'lop_scores', 'lop_scores_kernel')} [{card}]")
    rows["lop_scores_kernel"] = dict(row, max_abs_err=err,
                                     shape=f"lanes={n_lanes} g=1 M={m_cap} "
                                           f"d={dh}")

    # ---- #8 int8_flash_prefill: one head of 1536 tokens ----
    s_len = 1536
    sm = dh ** -0.5
    q8, k8, v8 = (t(rng.integers(-127, 128, (s_len, dh)).astype(np.int8))
                  for _ in range(3))
    qs8, ks8, vs8 = (t(rng.uniform(0.001, 0.02, (s_len, 1)).astype(
        np.float32)) for _ in range(3))
    args8 = (q8, k8, v8, qs8, ks8, vs8)
    err = 0.0
    for causal, window in ((True, 0), (True, 512), (False, 0)):
        kw = dict(softmax_scale=sm, causal=causal, window=window)
        got = int8_flash_prefill(*args8, **kw)
        want = plain.flash_prefill_ref(*args8, **kw)
        err = max(err, check_close(
            torch, f"int8_flash_prefill[causal={causal},window={window}]",
            got, want, tol=TOL_STANDALONE))
    pairs = s_len * (s_len + 1) / 2
    b_ms, b_by = bound_ms(nbytes(*args8) + s_len * dh * 4,
                          int8_ops=2.0 * pairs * dh, f32_ops=2.0 * pairs * dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qf, kf, vf = ((a.float() * sc)[None, None]
                  for a, sc in ((q8, qs8), (k8, ks8), (v8, vs8)))
    kw = dict(softmax_scale=sm, causal=True)
    row = time_row(torch, lambda *a: int8_flash_prefill(*a, **kw),
                   lambda *a: plain.flash_prefill_ref(*a, **kw), args8, 20,
                   b_ms, b_by,
                   lib=(lambda a, b_, c: sdpa(a, b_, c, is_causal=True),
                        (qf, kf, vf)))
    shape = flash_prefill_launch_shape(s_len, dh)
    log(f"  int8_flash_prefill s={s_len} d={dh} causal: {fmt_row(row)}, "
        f"{b_ms / row['ms']:.1%} of bound; {shape['ctas']} CTAs of 16 rows x "
        f"{shape['warps']} warps on 132 SMs, {shape['smem']} B dynamic smem; "
        f"{ptxas_summary(_build, 'int8_attention', 'flash_prefill_kernel')}; "
        f"SWA 512 and non-causal checked too (library: SDPA on dequantized "
        f"f32) [{card}]")
    rows["int8_flash_prefill"] = dict(row, max_abs_err=err,
                                      shape=f"s={s_len} d={dh} causal")

    # ---- #9 sparse_decode_attention: the per-head path's selections ----
    new_len = torch.tensor(PER_HEAD_LEN, dtype=torch.int32, device=dev)
    scores = plain.lop_scores_ref(q_pot, feat).reshape(b, hkv, 1, m_cap)
    blk = 128
    idx, gt = select_blocks(scores, new_len, block=blk, k_keep=2)
    nb = idx.shape[-1]
    q9, k9, v9 = (qi.reshape(n_lanes, 1, dh),
                  lanes["k"].reshape(n_lanes, m_cap, dh),
                  lanes["v"].reshape(n_lanes, m_cap, dh))
    qs9 = t(rng.uniform(0.001, 0.02, (n_lanes, 1, 1)).astype(np.float32))
    ks9, vs9 = (lanes[key].reshape(n_lanes, m_cap, 1)
                for key in ("k_scale", "v_scale"))
    idx9 = idx.reshape(n_lanes, nb).contiguous()
    gt9 = gt.reshape(n_lanes, 3 * nb).contiguous()
    args9 = (q9, k9, v9, qs9, ks9, vs9, idx9, gt9)
    kw = dict(block=blk, softmax_scale=sm)
    got = sparse_decode_attention(*args9, **kw)
    want = plain.sparse_decode_attention_ref(*args9, **kw)
    err = check_close(torch, "sparse_decode_attention", got, want,
                      tol=TOL_STANDALONE)
    gate = gt9[:, :nb] > 0
    start, end = gt9[:, 2 * nb:], gt9[:, nb:2 * nb]
    live = ((end - start).clamp_min(0) * gate).sum().item()
    b_ms, b_by = bound_ms(nbytes(q9, qs9, idx9, gt9)
                          + live * (2 * dh + 8) + n_lanes * dh * 4,
                          int8_ops=2.0 * live * dh, f32_ops=2.0 * live * dh)
    # library yardstick: SDPA over the selected blocks, gathered and
    # dequantized beforehand, with the live-token mask
    sel = (idx9[..., None] * blk
           + torch.arange(blk, device=dev)).reshape(n_lanes, nb * blk)
    lane_ix = torch.arange(n_lanes, device=dev)[:, None]
    kg, vg = ((c[lane_ix, sel].float() * sc[lane_ix, sel])[:, None]
              for c, sc in ((k9, ks9), (v9, vs9)))
    tpos = torch.arange(blk, device=dev)
    live_mask = (gate[..., None] & (tpos >= start[..., None])
                 & (tpos < end[..., None]))
    lib9 = (lambda a, b_, c, m_: sdpa(a, b_, c, attn_mask=m_),
            ((q9.float() * qs9)[:, None], kg, vg,
             live_mask.reshape(n_lanes, 1, 1, nb * blk)))
    def kern9(*a):
        return sparse_decode_attention(*a, **kw)
    row = time_row(torch, kern9,
                   lambda *a: plain.sparse_decode_attention_ref(*a, **kw),
                   args9, 50, b_ms, b_by, lib=lib9)
    g_ms = graph_ms(torch, kern9, copies(torch, args9))
    shape = sparse_decode_launch_shape(n_lanes, 1, dh, blk, nb)
    log(f"  sparse_decode_attention lanes={n_lanes} g=1 K={nb} blocks of "
        f"{blk}, new_len={list(PER_HEAD_LEN)}: {fmt_row(row)} (library: "
        f"SDPA on the gathered dequantized blocks); in a CUDA graph "
        f"{g_ms:.4f} ms; {b_ms / row['ms']:.1%} of bound ({b_ms / g_ms:.1%}"
        f" in the graph); {fmt_decode_shape(shape)}; "
        f"{ptxas_summary(_build, 'int8_attention', 'sparse_decode_kernelILb1E')}"
        f" [{card}]")
    # the TPU kernel's masking: a gated block with an empty interval
    # before a live one weighs nothing; a lane whose gated blocks hold no
    # live token gives the mean of their V; a lane with no gate gives zero
    gt_m = gt9.clone()
    gt_m[0, :nb] = 1
    gt_m[0, nb], gt_m[0, 2 * nb] = 9, 9
    gt_m[1, :nb] = 1
    gt_m[1, nb:] = 5
    gt_m[2, :nb] = 0
    args_m = args9[:7] + (gt_m,)
    got = kern9(*args_m)
    err = max(err, check_close(
        torch, "sparse_decode_attention[masked intervals]", got,
        plain.sparse_decode_attention_ref(*args_m, **kw),
        tol=TOL_STANDALONE))
    if got[2].any() or not got[1].any():
        raise AssertionError("sparse_decode_attention: an ungated lane must "
                             "give zero and an all-masked lane the mean of V")
    log(f"  sparse_decode_attention: gated empty interval before a live "
        f"block, an all-masked lane (mean of V) and an ungated lane (zero) "
        f"agree with the plain version [{card}]")
    rows["sparse_decode_attention"] = dict(
        row, max_abs_err=err,
        shape=f"lanes={n_lanes} g=1 K={nb} block={blk} M={m_cap}")
    return rows


def per_head_decode(torch, ops, select_blocks, qi, qsc, lanes, new_len, *,
                    block, k_keep):
    """The paper's per-head predictive-sparse decode through the kernel
    API (the Fig. 8 path): one lop_screen over every (batch, kv-head)
    lane, select_blocks, one sparse_decode over every (batch, kv-head,
    group) lane. qi int8 [B, H, dh]; qsc f32 [B, H, 1]. → f32 [B, H, dh]."""
    b, h, dh = qi.shape
    hkv = lanes["k"].shape[1]
    g = h // hkv
    qg = qi.reshape(b, hkv, g, dh)
    scores = ops.lop_screen(qg, lanes["feat"])
    idx, gate_tokens = select_blocks(scores, new_len, block=block,
                                     k_keep=k_keep)
    out = ops.sparse_decode(
        qg[..., None, :], lanes["k"], lanes["v"],
        qsc.reshape(b, hkv, g, 1, 1), lanes["k_scale"][..., None],
        lanes["v_scale"][..., None], idx, gate_tokens, block=block,
        softmax_scale=dh ** -0.5)
    return out.reshape(b, h, dh)


def standalone_paths(torch, np, lanes, card) -> dict:
    """Parts 2 and 3: the TINT chain, one flash prefill and the per-head
    decode, each driven with the launch counts zeroed just before and
    read just after. → launches by kernel name."""
    from repro_torch.core.lop import kv_traffic_bytes
    from repro_torch.core.quantization import quantize
    from repro_torch.core.ternary import TernaryWeight
    from repro_torch.kernels import ops
    from repro_torch.serving.lop_select import select_blocks

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 15)
    launches = dict.fromkeys(STANDALONE, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def counted(label, fn, want):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, label, want)
        for key in launches:
            launches[key] += counts[key]
        return out, counts

    # ---- the TINT chain == the fused projection, bitwise ----
    d = 3200
    cases = []
    for m in (4, 128):
        for label, n, per_col in (("qkv", 3 * d, True), ("o", d, False)):
            gamma = t((rng.uniform(0.01, 0.05, (1, n)) if per_col
                       else np.full((1, 1), 0.03)).astype(np.float32))
            cases.append((label, m, t(rng.standard_normal((m, d)).astype(
                np.float32)), TernaryWeight(t(rng.integers(
                    0, 256, (d // 4, n)).astype(np.uint8)), gamma, (d, n))))

    def chain():
        outs = []
        for _, _, x, tw in cases:
            xq = quantize(x)
            acc = ops.ternary_matmul(xq.values, tw)
            outs.append(acc.to(torch.float32) * xq.scale * tw.scale)
        return outs
    chained, _ = counted("TINT chain", chain, ("ternary_matmul",))
    for (label, m, x, tw), y in zip(cases, chained):
        fused = ops.qlinear_fused(x, tw.packed, tw.scale)
        torch.cuda.synchronize()
        if not torch.equal(y, fused):
            raise AssertionError(f"TINT chain [{label}, m={m}] != "
                                 "qlinear_fused")
    log(f"  TINT chain (absmax quantize -> ternary_matmul -> (acc*xs)*gamma)"
        f" == qlinear_fused bitwise for QKV (per-column gamma) and O (scalar"
        f" gamma) at m = 4 and 128; {launches['ternary_matmul']} "
        f"ternary_matmul launches")

    # ---- one head of flash prefill at 1536 tokens ----
    s_len, dh = 1536, lanes["k"].shape[-1]
    q8, k8, v8 = (t(rng.integers(-127, 128, (s_len, dh)).astype(np.int8))
                  for _ in range(3))
    scales = [t(rng.uniform(0.001, 0.02, (s_len, 1)).astype(np.float32))
              for _ in range(3)]
    out, _ = counted("flash prefill", lambda: ops.flash_prefill(
        q8, k8, v8, *scales, softmax_scale=dh ** -0.5, causal=True),
        ("int8_flash_prefill",))
    if out.shape != (s_len, dh) or not torch.isfinite(out).all():
        raise AssertionError(f"flash prefill: {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    log(f"  flash_prefill (one head, s={s_len}, causal): finite [{s_len}, "
        f"{dh}] output")

    # ---- the per-head predictive-sparse decode vs the fused kernel ----
    b, hkv, m_cap, _ = lanes["k"].shape
    h, block, k_keep = hkv, 128, 2
    qi = t(rng.integers(-127, 128, (b, h, dh)).astype(np.int8))
    qsc = t(rng.uniform(0.001, 0.02, (b, h, 1)).astype(np.float32))
    new_len = torch.tensor(PER_HEAD_LEN, dtype=torch.int32, device=dev)

    def per_head(qi_, qsc_, k_, v_, ks_, vs_, f_, nl_):
        return per_head_decode(
            torch, ops, select_blocks, qi_, qsc_,
            dict(k=k_, v=v_, k_scale=ks_, v_scale=vs_, feat=f_), nl_,
            block=block, k_keep=k_keep)

    def fused(*a):
        return ops.decode_attention(*a, block=block, k_keep=k_keep)
    args = (qi, qsc, lanes["k"], lanes["v"], lanes["k_scale"],
            lanes["v_scale"], lanes["feat"], new_len)
    got, ph_counts = counted("per-head LOP decode", lambda: per_head(*args),
                             ("lop_scores_kernel", "sparse_decode_attention"))
    want, f_counts = counted("fused LOP decode", lambda: fused(*args),
                             ("fused_decode_attention",))
    err = check_close(torch, "per-head decode vs fused_decode_attention",
                      got, want, tol=TOL_STANDALONE)
    n_ph = sum(ph_counts.values())
    n_f = sum(f_counts.values())
    ph_ms = cuda_ms(torch, per_head, copies(torch, args), 20)
    f_ms = cuda_ms(torch, fused, copies(torch, args), 20)
    queries = b * h
    dense_b = queries * kv_traffic_bytes(m_cap, dh, 0, with_lop=False)
    lop_b = queries * kv_traffic_bytes(m_cap, dh, k_keep * block)
    scores_b = 2 * b * hkv * m_cap * 4       # int32 scores out and back in
    log(f"  per-head LOP decode (B={b}, H={h}, M={m_cap}, k_keep={k_keep}, "
        f"new_len={list(PER_HEAD_LEN)}): agrees with fused_decode_attention "
        f"(max |err| {err:.3g}, rtol=atol=1e-4); launches {n_ph} per-head "
        f"vs {n_f} fused; {ph_ms:.4f} ms per-head vs {f_ms:.4f} ms fused "
        f"(L2 cold) [{card}]")
    log(f"  modeled K/V bytes per decode step (kv_traffic_bytes, {queries} "
        f"head-queries): dense {dense_b}, per-head LOP {lop_b} (+{scores_b} "
        f"of int32 scores written and read back between its launches), "
        f"fused LOP {lop_b}")
    return launches


def standalone_phase(torch, np, engine, card) -> dict:
    """Phase 5. → rows of the four standalone kernels, with launches."""
    t0 = time.monotonic()
    lanes = cache_lanes(torch, np, engine)
    log(f"  K/V of layer {engine.cfg.n_layers - 1} from whole-prompt "
        f"prefills of {list(PER_HEAD_LEN)} tokens in "
        f"{time.monotonic() - t0:.1f} s [{card}]")
    rows = standalone_kernels(torch, np, lanes, card)
    launches = standalone_paths(torch, np, lanes, card)
    for name, n in launches.items():
        rows[name]["launches"] = n
    return rows


def _dev_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(torch, fn, calls=None):
    """Run ``fn`` under torch.profiler. → (device µs by kernel name, device
    µs in all, wall µs up to a synchronize); ``calls``, a dict, also gets
    the device events' count by name. Device activity only: the host's
    ops of an eager step (tens of thousands) would cost seconds of trace
    processing a call and count nothing here."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpys); the aten ops that
        # launched them would count the same time twice
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        us = _dev_us(evt)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
            if calls is not None:
                calls[evt.key] = calls.get(evt.key, 0) + int(evt.count)
    return by_name, sum(by_name.values()), wall_us


def profile_steps(torch, sched, label: str, n_prof: int = 4):
    """Profile ``n_prof`` decode steps of ``sched`` (4 active lanes) and
    print the device's busy time and the top kernels a step. → (device µs,
    wall µs)."""
    calls = {}
    by_name, dev_us, prof_wall_us = profiled(
        torch, lambda: [sched.step() for _ in range(n_prof)], calls)
    if dev_us:
        log(f"  profiler, {n_prof} decode steps ({label}): device busy "
            f"{dev_us / 1e3:.2f} ms of {prof_wall_us / 1e3:.2f} ms wall "
            f"({100 * dev_us / prof_wall_us:.1f}%, profiler on), "
            f"{sum(calls.values()) / n_prof:.0f} device events a step; top "
            f"device time per step:")
        for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {us / n_prof / 1e3:8.3f} ms  {key[:90]}")
    else:
        log("  profiler: no device time recorded (busy share not measured)")
    return dev_us, prof_wall_us


def steady_phase(torch, np, engine, reqs, card) -> dict:
    """Clean timings outside the serve run: a decode step over 4 active
    lanes with no prefill in flight, one 128-token prefill chunk at the end
    of a 1536-token prompt, a whole-prompt prefill, and a profiler
    breakdown of decode steps and of one chunk (device time by kernel,
    busy share)."""
    arms = decode_arms(torch, np, engine, reqs, "LOP greedy", card)
    prof = profile_arms(torch, arms, "LOP greedy", card)
    decode_ms, eager_ms = arms["ms"], arms["eager_ms"]
    del arms                      # their pools would count in later peaks

    # one 128-token chunk at positions [1408, 1536) of a spare lane
    pool = engine.init_pool(1)
    chunk = np.asarray(reqs[0].prompt[:128], np.int32)[None]
    chunk_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pool = engine.prefill_chunk(pool, 0, chunk, 1408, 1536, True)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    chunk_ms = float(np.median(chunk_s[1:]) * 1e3)
    by_name, chunk_dev_us, chunk_wall_us = profiled(
        torch, lambda: engine.prefill_chunk(pool, 0, chunk, 1408, 1536, True))
    if chunk_dev_us:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"  profiler, one prefill chunk: device busy "
            f"{chunk_dev_us / 1e3:.2f} ms of {chunk_wall_us / 1e3:.2f} ms wall"
            f" ({100 * chunk_dev_us / chunk_wall_us:.1f}%, profiler on); top: "
            + "; ".join(f"{us / 1e3:.3f} ms {key[:60]}" for key, us in top))
    prompt = reqs[0].prompt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt[None])
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    log(f"  prefill chunk (128 tokens at 1408, 26 layers): {chunk_ms:.2f} ms;"
        f" whole-prompt prefill of {len(prompt)} tokens: {whole_ms:.1f} ms "
        f"[{card}]")
    del pool, logits
    return dict(decode_step_ms_p50=decode_ms, prefill_chunk_ms=chunk_ms,
                eager_decode_step_ms_p50=eager_ms, whole_prefill_ms=whole_ms,
                device_ms=prof["graph"][0], eager_device_ms=prof["eager"][0],
                profile_device_busy=prof["graph"][1])


# ---------------------------------------------------------------------------
# phase 4n: the prefill chunk width on the main path
# ---------------------------------------------------------------------------

CHUNK_WIDTHS = (48, 256)          # off the 16-row / 32-key tile; two blocks
CHUNK_SHARED, CHUNK_SUFFIX, CHUNK_SLOTS = 1024, 256, 3


def chunk_ms(torch, engine, c: int, reps: int = 5) -> float:
    """One c-token prefill chunk at start 3·c of a fresh 1-slot pool
    (host clock around a synchronized call, p50 of ``reps``)."""
    import numpy as np
    pool = engine.init_pool(1)
    tokens = np.arange(c, dtype=np.int32)[None] % engine.cfg.vocab
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.prefill_chunk(pool, 0, tokens, 3 * c, 4 * c, False)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    return float(np.median(times[1:]) * 1e3)


def chunk_width_phase(torch, np, engine, reqs, card: str) -> dict:
    """Phase 4n: phase 4's engine weights served at prefill chunk widths
    48 and 256 against phase 4's 128: 4 requests (phase 4's rids 0 and
    1, and rids 2 and 3 as their first 256 tokens behind one shared
    1024-token prefix), greedy LOP, prefix cache on, 3 slots (the second
    sharer is admitted after the first interned the prefix). Gates: every
    width's tokens equal the 128-token run's; #3 launches 26 times a
    chunk; the hit resumes at the block boundary, 1024; scheduler ==
    lockstep for the hit. → launches of #3 by width."""
    from dataclasses import replace

    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.cache import capacity_for

    cfg = engine.cfg
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, (CHUNK_SHARED,)).astype(np.int32)
    sub = {r.rid: r for r in reqs[:2]}
    for rid in (2, 3):
        sub[rid] = replace(reqs[rid], prompt=np.concatenate(
            [shared, reqs[rid].prompt[:CHUNK_SUFFIX]]))
    order = [sub[2], sub[0], sub[1], sub[3]]
    log(f"  prompts (rid: tokens) "
        + ", ".join(f"{r.rid}: {len(r.prompt)}" for r in order)
        + f"; rids 2 and 3 share {CHUNK_SHARED} tokens; {CHUNK_SLOTS} slots")
    runs, out = {}, {}
    for c in (engine.chunk_tokens,) + CHUNK_WIDTHS:
        eng = engine if c == engine.chunk_tokens else PooledEngine(
            cfg, engine.qp, max_len=engine.max_len, device="cuda",
            chunk_tokens=c)
        label = f"chunk {c}"
        run = serve_run(torch, np, eng, order, label, card,
                        capacity=capacity_for(cfg, eng.max_len),
                        n_slots=CHUNK_SLOTS)
        check_counts(run["counts"], label, LOP_PATH, idle=(DENSE,))
        check_tokens(cfg, run["results"], GEN, label)
        res = run["results"]
        if res[3].cached_len != CHUNK_SHARED or \
                CHUNK_SHARED % cfg.lop_block:
            raise AssertionError(f"[{label}] the sharer resumed at "
                                 f"{res[3].cached_len}, not {CHUNK_SHARED}")
        plan = run["sched"]._plan_chunks(sub[3], skip=CHUNK_SHARED)[1]
        chunks = sum(-(-(r.prompt_len - r.cached_len) // c)
                     for r in res.values())
        got = run["counts"]["fused_prefill_attention"]
        if got != cfg.n_layers * chunks:
            raise AssertionError(f"[{label}] #3 launched {got} times for "
                                 f"{chunks} chunks of {cfg.n_layers} layers")
        if c != engine.chunk_tokens:
            base = runs[engine.chunk_tokens]["results"]
            parted = [rid for rid in res if res[rid].tokens
                      != base[rid].tokens]
            if parted:
                raise AssertionError(f"[{label}] tokens part from the "
                                     f"{engine.chunk_tokens}-token run's "
                                     f"for rids {parted}")
            check_lockstep(eng, sub, res, (3,), label)
        ms = chunk_ms(torch, eng, c)
        log(f"  [{label}] {chunks} chunks, #3 {got} launches "
            f"({cfg.n_layers} a chunk); the hit resumed at {CHUNK_SHARED} "
            f"(chunk starts {plan[:3]}...); TTFT p50 "
            f"{run['ttft_p50_ms']:.1f} ms, {run['tokens_per_s']:.2f} tok/s; "
            f"one chunk at start {3 * c} {ms:.2f} ms (host clock, "
            f"synchronized); tokens sha256 {tokens_digest(res)}"
            + (f" == the {engine.chunk_tokens}-token run's"
               if c != engine.chunk_tokens else "") + f" [{card}]")
        run.pop("sched")
        runs[c] = run
        out[c] = dict(prefill_launches=got, ttft_p50_ms=run["ttft_p50_ms"],
                      chunk_ms=ms, counts=dict(run["counts"]))
        if eng is not engine:
            del eng
            free_cuda(torch)
    return out


# ---------------------------------------------------------------------------
# phase 6: the tile autotuner at full width, on phase 4's weights
# ---------------------------------------------------------------------------

TUNE_REQUESTS, TUNE_CANDIDATES, TUNE_REPEATS = 4, 6, 5


def main_path_shapes(cfg, n_slots: int, chunk: int, capacity: int) -> dict:
    """The kernel shapes bitnet-3b's greedy LOP serve dispatches, under
    the shape log's names: QKV, O and the FFN at the decode rows (one a
    slot) and at the chunk width, the prefill chunk over one lane's pages,
    and the decode step over every slot."""
    from repro_torch.serving.lop_select import k_keep_blocks

    d, hd, hkv = cfg.d_model, cfg.hd, cfg.n_kv_heads
    g = cfg.n_heads // hkv
    k_keep = max(1, min(k_keep_blocks(cfg, capacity),
                        capacity // cfg.lop_block))
    rows = (n_slots, chunk)
    return {
        "qlinear": [{"e": 1, "m": m, "k": d, "n": n} for m in rows
                    for n in (cfg.q_dim + 2 * cfg.kv_dim, d)],
        "ffn": [{"e": 1, "m": m, "k": d, "f": cfg.d_ff, "n": d}
                for m in rows],
        "prefill": [{"bhg": hkv, "r": g * chunk, "d": hd, "m": capacity,
                     "chunk": chunk}],
        "decode": [{"bhg": n_slots * hkv, "g": g, "d": hd, "m": capacity,
                    "block": cfg.lop_block, "k_keep": k_keep}]}


def autotune_phase(torch, np, engine, reqs, card: str) -> dict:
    """Phase 6: the tile autotuner at bitnet-3b's full width on phase 4's
    weights (no new draw). (a) 4 of phase 4's requests through a fresh
    engine with ``shape_log=`` a temporary file: the log must hold exactly
    the main path's shapes; (b) ``run_sweep`` over ``merged_shapes`` of
    that log into a temporary table, at most 6 candidates a shape, every
    candidate checked bitwise against the default launch on the same
    inputs (a difference raises) and timed (CUDA graph, L2 cold); (c) the
    same requests through a fresh engine reading that table: tokens and
    launch counts equal (a)'s. Nothing is written at the repository root.
    → the winners by shape."""
    import os
    import tempfile

    from repro_torch.kernels import autotune
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.cache import capacity_for

    cfg = engine.cfg
    sub = reqs[:TUNE_REQUESTS]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        log_path, table = Path(tmp) / "shapes.json", Path(tmp) / "table.json"
        # (a) the shape log of a served run
        eng = PooledEngine(cfg, engine.qp, max_len=engine.max_len,
                           device="cuda", shape_log=str(log_path))
        try:
            untuned = serve_run(torch, np, eng, sub, "autotune (a) logged",
                                card)
        finally:
            autotune.stop_shape_log()
        untuned.pop("sched")
        del eng
        check_counts(untuned["counts"], "autotune (a)", LOP_PATH,
                     idle=(DENSE,))
        logged = autotune.load_shape_log(log_path)
        want = main_path_shapes(cfg, N_SLOTS, engine.chunk_tokens,
                                capacity_for(cfg, engine.max_len))
        for kernel, shapes in sorted(logged.items()):
            log(f"  (a) logged {kernel}: "
                + "; ".join(autotune.shape_key(kernel, d) for d in shapes))
        norm = {k: sorted(map(json.dumps, v)) for k, v in logged.items()}
        if norm != {k: sorted(map(json.dumps, v)) for k, v in want.items()}:
            raise AssertionError(f"autotune (a): the log {logged} is not the "
                                 f"main path's shapes {want}")
        # (b) the sweep over the log's shapes and the defaults
        t0 = time.monotonic()
        lines = []
        swept = autotune.run_sweep(
            shapes=autotune.merged_shapes(log_path), out_path=table,
            repeats=TUNE_REPEATS, max_candidates=TUNE_CANDIDATES,
            log=lines.append)
        entries = swept["configs"][autotune.config_key()]
        n_cands = sum(e["candidates"] for v in entries.values()
                      for e in v.values())
        log(f"  (b) swept {sum(len(v) for v in entries.values())} shapes, "
            f"{n_cands} candidates, each bitwise the default launch on the "
            f"same inputs, in {time.monotonic() - t0:.1f} s (device ms a "
            f"launch: CUDA graph of 20, L2 cold, median of "
            f"{TUNE_REPEATS}) [{card}]")
        for kernel, by_shape in entries.items():
            for skey, e in by_shape.items():
                gain = e["default_ms"] / e["ms"]
                log(f"    {kernel} {skey}: default {e['default_ms']:.5f} ms, "
                    f"winner {e['params']} {e['ms']:.5f} ms ({gain:.3f}x) of "
                    f"{e['candidates']}")
                out[f"{kernel} {skey}"] = dict(
                    default_ms=e["default_ms"], ms=e["ms"],
                    params=e["params"], candidates=e["candidates"])
        if autotune.validate_table(table):
            raise AssertionError(f"autotune (b): {autotune.validate_table(table)}")
        # (c) the same requests served with the table
        before = os.environ.get(autotune.TABLE_ENV)
        os.environ[autotune.TABLE_ENV] = str(table)
        try:
            tuned_knobs = {f"{k} {autotune.shape_key(k, d)}":
                           autotune.lookup(k, d)
                           for k, shapes in want.items() for d in shapes}
            eng = PooledEngine(cfg, engine.qp, max_len=engine.max_len,
                               device="cuda")
            tuned = serve_run(torch, np, eng, sub, "autotune (c) tuned",
                              card)
            tuned.pop("sched")
            del eng
        finally:
            if before is None:
                os.environ.pop(autotune.TABLE_ENV)
            else:
                os.environ[autotune.TABLE_ENV] = before
        log(f"  (c) knobs the table names on the path: {tuned_knobs}")
        if tokens_digest(tuned["results"]) != tokens_digest(untuned["results"]):
            raise AssertionError("autotune (c): the tuned serve's tokens "
                                 "part from the untuned serve's")
        if tuned["counts"] != untuned["counts"]:
            raise AssertionError(f"autotune (c): launch counts "
                                 f"{tuned['counts']} != {untuned['counts']}")
        log(f"  (c) tuned tokens sha256 {tokens_digest(tuned['results'])} == "
            f"untuned, launch counts equal; tok/s {tuned['tokens_per_s']:.2f}"
            f" tuned / {untuned['tokens_per_s']:.2f} untuned, TTFT p50 "
            f"{tuned['ttft_p50_ms']:.1f} / {untuned['ttft_p50_ms']:.1f} ms "
            f"(one run each: host-bound, not a comparison) [{card}]")
    free_cuda(torch)
    return dict(winners=out, counts=untuned["counts"],
                tuned_counts=tuned["counts"])


# ---------------------------------------------------------------------------
# phase 7: the head-level schedule at bitnet-3b's attention width
# ---------------------------------------------------------------------------

SCHED_SEQ, SCHED_GROUPS = 1024, (1, 4, 8, 32)
SCHED_TOL = dict(rtol=1e-4, atol=1e-4)      # the reference test's atol


def schedule_phase(torch, np, card: str) -> dict:
    """Phase 7: ``core/schedule.py`` at bitnet-3b's attention width: x [1,
    1024, 3200], 32 heads of 100, f32 weights (scaled by d^-1/2) from a
    seeded ``torch.Generator`` on the card, causal. ``materialized_mha``
    against ``streamed_mha`` at groups 1, 4, 8 and 32: allclose at rtol =
    atol = 1e-4 (the sums' order differs), each with its ms (CUDA events,
    mean of 3 after a warm-up) and the peak memory it allocated above its
    inputs (``max_memory_allocated`` after ``reset_peak_memory_stats``).
    Plain ``torch.matmul`` and softmax: no kernel of the port runs."""
    from repro_torch.core import schedule

    dev = torch.device("cuda")
    d, h, hd = 3200, 32, 100
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((1, SCHED_SEQ, d), generator=gen, device=dev)
    ws = [torch.randn((d, h * hd), generator=gen, device=dev) * d ** -0.5
          for _ in range(3)]
    wo = torch.randn((h * hd, d), generator=gen, device=dev) * d ** -0.5
    attn = schedule.standard_softmax_attention

    def run(group):
        if group is None:
            return schedule.materialized_mha(x, *ws, wo, n_heads=h,
                                             head_dim=hd, attn_fn=attn)
        return schedule.streamed_mha(x, *ws, wo, n_heads=h, head_dim=hd,
                                     attn_fn=attn, group=group)

    rows, want = {}, None
    for group in (None, *SCHED_GROUPS):
        label = "materialized" if group is None else f"streamed g={group}"
        run(group)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = run(group)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run(group)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        if not torch.isfinite(got).all():
            raise AssertionError(f"schedule {label}: non-finite output")
        err = 0.0
        if want is None:
            want = got
        else:
            err = check_close(torch, f"schedule {label}", got, want,
                              tol=SCHED_TOL)
        rows[label] = dict(ms=ms, peak_bytes=peak, max_abs_err=err)
        log(f"  {label}: {ms:.3f} ms, peak {peak / 2**20:.1f} MiB above the "
            f"inputs, max |err| against materialized {err:.3g} [{card}]")
    del x, ws, wo, want
    free_cuda(torch)
    return rows


# ---------------------------------------------------------------------------
# phase 8: the dry-run on the card's terms
# ---------------------------------------------------------------------------

# (a) cells traced on the host at full width on pod16x16 (the depth
# probes off: the full-depth trace alone)
DRYRUN_CELLS = (("bitnet-3b", "train_4k"), ("bitnet-3b", "prefill_32k"),
                ("bitnet-3b", "decode_32k"), ("mixtral-8x22b", "decode_32k"),
                ("rwkv6-1.6b", "long_500k"))
DRYRUN_PEAK_TOL = 0.10          # predicted peak against the card's
DRYRUN_LENGTHS = (1500, 700, 1200, 100)   # (b)'s lanes: tokens cached
# phase 3's bound inputs for #1–#5, by kernel: [(kernel_cost dims,
# (bytes, int8 operations, f32 operations))], filled by kernel_phase
BOUND_INPUTS: dict = {}


def bounded(name: str, dims: dict, nbytes_: float, int8_ops: float = 0.0,
            f32_ops: float = 0.0) -> tuple[float, str]:
    """``bound_ms`` of one phase-3 shape, its inputs kept for phase 8's
    check of ``roofline.kernel_cost``."""
    BOUND_INPUTS.setdefault(name, []).append(
        (dims, (nbytes_, int8_ops, f32_ops)))
    return bound_ms(nbytes_, int8_ops, f32_ops)


def dryrun_host_child(out_path: str) -> int:
    """(a)'s traces in a process of their own (``python3 chip_smoke.py
    --dryrun-host PATH``, started after the build, so the host traces
    while the card runs phases 3–7): ``run_cell`` at full width on
    pod16x16 for DRYRUN_CELLS, the records written to ``PATH`` as JSON.
    Needs no card."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.dryrun import run_cell

    out = {f"{arch} {shape}": run_cell(arch, shape, differential=False,
                                       verbose=False)
           for arch, shape in DRYRUN_CELLS}
    Path(out_path).write_text(json.dumps(out))
    return 0


def start_dryrun_host():
    """Start :func:`dryrun_host_child` in a temporary directory; an atexit
    hook stops it if the run ends first. → (the process, its JSON path)."""
    import atexit
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="dryrun_host_"))
    path = tmp / "cells.json"
    log_file = open(tmp / "child.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-host", str(path)], stdout=log_file,
                            stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()
    atexit.register(stop)
    return proc, path


def dryrun_host_arm(card: str, host) -> dict:
    """(a) the cells :func:`start_dryrun_host` traced: each must end
    ``ok``. → each cell's record."""
    proc, path = host
    t0 = time.monotonic()
    rc = proc.wait(timeout=900)
    if rc != 0:
        raise AssertionError(f"dry-run (a): the host traces exited {rc}: "
                             + path.with_name("child.log").read_text()[-3000:])
    log(f"  (a) the host traces, run beside phases 3–7, waited for "
        f"{time.monotonic() - t0:.1f} s more")
    out = json.loads(path.read_text())
    for (arch, shape), r in zip(DRYRUN_CELLS, out.values()):
        if r["status"] != "ok":
            raise AssertionError(f"dry-run (a) {arch} x {shape}: "
                                 f"{r['status']} {r.get('reason', '')}")
        peak = r["memory"]["peak_estimate_bytes"]
        log(f"  (a) {arch} x {shape} x pod16x16: {r['status']}, fits "
            f"{r['fits']}, peak_estimate {peak} B ({peak / 2**30:.2f} GiB "
            f"a rank), dominant {r['roofline']['dominant']}, kernels "
            f"{r['raw_scan_cost']['kernels']}, trace {r['trace_s']} s "
            f"(host) [{card}]")
    return out


def traced_decode_step(torch, cfg, n_slots: int, max_len: int,
                       use_lop: bool):
    """One decode step of the served tree over an ``n_slots`` pool traced
    on meta, no mesh. → (the trace, its memory record)."""
    from repro_torch.analysis.op_trace import OpTrace
    from repro_torch.serving.cache import init_cache_pool
    from repro_torch.serving.engine import serve_step
    from repro_torch.serving.quantize import init_serving_params

    qp = init_serving_params(cfg, SEED, "meta")
    pool = init_cache_pool(cfg, n_slots, max_len, "meta")
    tokens = torch.empty((n_slots, 1), dtype=torch.int64, device="meta")
    tr = OpTrace()
    tr.arguments(qp, pool, tokens)
    with tr:
        out = serve_step(cfg, qp, pool, tokens, use_lop=use_lop)
    return tr, tr.memory(out)


def dryrun_decode_arm(torch, engine, card: str) -> dict:
    """(b) one decode step of the main path (phase 4's bitnet-3b weights,
    B 4, capacity 1664), LOP and no-LOP: traced on meta, then one eager
    step on the card over a fresh pool (lanes at DRYRUN_LENGTHS, active).
    Gates: the predicted launches by kernel (and mode) equal the counted
    ones; the predicted argument bytes equal the nbytes of the served tree,
    the pool and the tokens; the predicted peak within DRYRUN_PEAK_TOL of
    the card's (``max_memory_allocated`` from a reset, less what was
    allocated besides the step's arguments)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.cache import init_cache_pool
    from repro_torch.serving.engine import serve_step

    cfg = engine.cfg
    out = {}
    for use_lop in (True, False):
        label = "LOP" if use_lop else "no-LOP"
        tr, mem = traced_decode_step(torch, cfg, N_SLOTS, engine.max_len,
                                     use_lop)
        pool = init_cache_pool(cfg, N_SLOTS, engine.max_len, "cuda")
        pool["active"].fill_(True)
        pool["lengths"].copy_(torch.tensor(DRYRUN_LENGTHS,
                                           dtype=torch.int32))
        tokens = torch.tensor([[17], [42], [99], [7]], dtype=torch.int64,
                              device="cuda")
        args = tree_bytes(engine.qp) + tree_bytes(pool) + nbytes(tokens)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        logits, _ = serve_step(cfg, engine.qp, pool, tokens, use_lop=use_lop)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counted = {k: v for k, v in ops.launch_counts(modes=True).items()
                   if v}
        if logits.shape != (N_SLOTS, cfg.vocab_padded) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"dry-run (b) {label}: the card's step gave "
                                 f"{tuple(logits.shape)} or non-finite "
                                 f"logits")
        measured = peak - base + args
        pred = mem["peak_estimate_bytes"]
        rel = pred / measured - 1
        log(f"  (b) {label} decode step, bitnet-3b B {N_SLOTS} capacity "
            f"{pool['layers']['k'].shape[3]}: launches predicted "
            f"{dict(sorted(tr.kernels.items()))}, counted "
            f"{dict(sorted(counted.items()))}; argument bytes predicted "
            f"{mem['argument_bytes']}, the card's tree + pool + tokens "
            f"{args}; peak predicted {pred} B (temporaries "
            f"{pred - mem['argument_bytes']} B), the card's {measured} B "
            f"(max_memory_allocated {peak} − allocated before {base} + the "
            f"arguments; temporaries {peak - base} B), {rel:+.2%} "
            f"[{card}]")
        if tr.kernels != counted:
            raise AssertionError(f"dry-run (b) {label}: predicted launches "
                                 f"{tr.kernels} != counted {counted}")
        if mem["argument_bytes"] != args:
            raise AssertionError(f"dry-run (b) {label}: predicted argument "
                                 f"bytes {mem['argument_bytes']} != the "
                                 f"card's {args}")
        if abs(rel) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"dry-run (b) {label}: predicted peak {pred}"
                                 f" B is {rel:+.2%} off the card's "
                                 f"{measured} B (limit "
                                 f"{DRYRUN_PEAK_TOL:.0%})")
        out[label] = dict(launches=counted, argument_bytes=args,
                          peak_pred=pred, peak_card=measured, rel=rel,
                          temp_pred=pred - mem["argument_bytes"],
                          temp_card=peak - base)
        del pool, tokens, logits
    want = {"LOP": {"fused_qlinear": 52, "fused_ffn": 26,
                    "fused_decode_attention": 26},
            "no-LOP": {"fused_qlinear": 52, "fused_ffn": 26,
                       "fused_dense_decode_attention": 26}}
    for label, counts in want.items():
        if out[label]["launches"] != counts:
            raise AssertionError(f"dry-run (b) {label}: launches "
                                 f"{out[label]['launches']} != {counts}")
    free_cuda(torch)
    return out


def dryrun_train_arm(torch, full: dict, card: str) -> dict:
    """(c) phase 4k (a)'s training step (bitnet-3b, batch TRAIN_BATCH x
    TRAIN_SEQ, full depth, n_micro 1) traced on meta, against the peak
    4k (a) measured (less what was allocated besides the masters and
    moments at its reset). Gates: no kernel record, the predicted peak
    within DRYRUN_PEAK_TOL."""
    from repro_torch.analysis.op_trace import OpTrace
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import make_train_step

    t0 = time.monotonic()
    cfg = get_config("bitnet-3b")
    params = init_params(cfg, SEED, "meta")
    opt = adamw_init(params)
    batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    tr = OpTrace()
    tr.arguments(params, opt, batch)
    with tr:
        out = step(params, opt, batch)
    mem = tr.memory(out)
    pred = mem["peak_estimate_bytes"]
    measured = full["peak_bytes"] - full["other_bytes"]
    rel = pred / measured - 1
    secs = time.monotonic() - t0
    log(f"  (c) bitnet-3b training step {TRAIN_BATCH} x {TRAIN_SEQ}, 26 "
        f"layers: predicted peak {pred} B ({pred / 2**30:.2f} GiB; "
        f"arguments {mem['argument_bytes']} B, temporaries "
        f"{mem['temp_bytes']} B), 4k (a)'s {measured} B "
        f"({measured / 2**30:.2f} GiB: max_memory_allocated "
        f"{full['peak_bytes']} less {full['other_bytes']} B besides the "
        f"masters and moments), {rel:+.2%}; kernel records {tr.kernels}; "
        f"traced in {secs:.1f} s (host) [{card}]")
    if tr.kernels:
        raise AssertionError(f"dry-run (c): a training step recorded kernel "
                             f"launches {tr.kernels}")
    if abs(rel) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"dry-run (c): predicted peak {pred} B is "
                             f"{rel:+.2%} off the card's {measured} B "
                             f"(limit {DRYRUN_PEAK_TOL:.0%})")
    return dict(peak_pred=pred, peak_card=measured, rel=rel, seconds=secs)


def cost_consistency(card: str) -> None:
    """``roofline.kernel_cost`` at each phase-3 shape of #1–#5 gives
    exactly the bytes and operations phase 3's bound used."""
    from repro_torch.analysis.roofline import kernel_cost

    n = 0
    for name, shapes in BOUND_INPUTS.items():
        for dims, (nb, i8, f32) in shapes:
            got = kernel_cost(name, **dims)
            if (got["bytes"], got["int8_ops"], got["flops"]) != (nb, i8, f32):
                raise AssertionError(f"kernel_cost({name}, {dims}) = {got}, "
                                     f"phase 3's bound used bytes {nb}, "
                                     f"int8 {i8}, f32 {f32}")
            n += 1
    want = {"fused_qlinear", "fused_ffn", "fused_prefill_attention",
            "fused_decode_attention", "fused_dense_decode_attention"}
    if set(BOUND_INPUTS) != want:
        raise AssertionError(f"phase 3 kept bound inputs for "
                             f"{sorted(BOUND_INPUTS)}, not {sorted(want)}")
    log(f"  kernel_cost equals phase 3's bound inputs at all {n} shapes of "
        f"#1–#5 [{card}]")


def dryrun_phase(torch, engine, card: str, host) -> dict:
    """Phase 8 (a) and (b), and the cost check; (c) runs in phase 4k.
    ``host``: :func:`start_dryrun_host`'s."""
    cost_consistency(card)
    host = dryrun_host_arm(card, host)
    decode = dryrun_decode_arm(torch, engine, card)
    return dict(host=host, decode=decode)


# ---------------------------------------------------------------------------
# phase 4m: the distributed modules, gloo ranks on cuda:0
# ---------------------------------------------------------------------------

EP_MESH, EP_X = (2, 2), (4, 512)         # (data, model); x [B, S] at d 1024
CM_RANKS, CM_ROWS = 4, 64                # bitnet-3b's O: k 3200 → n 3200
FSDP_MESH, FSDP_LAYERS, FSDP_BATCH, FSDP_SEQ = (2, 2), 1, 8, 128
# (c) plants one of the step check's three faults (the run's time: each is
# a sharded step through gloo); tests/test_torch_distributed.py plants all
SMOKE_FAULTS = ("sign",)
ELASTIC_SURVIVORS = 3                    # plan (1, 2): one spare
SPR_RANKS, SPR_STEPS, SPR_LANES = 2, 8, 4
SPR_ARCHS = {"jamba": ("jamba-1.5-large-398b-reduced", None, 96, 255),
             "rwkv6": ("rwkv6-1.6b", RWKV_SERVE_LAYERS, 256, 1024)}
# (a), (b), (c) and (e) share one spawn of 4 ranks: (a) and (c) on the
# (data, model) mesh it is spawned with, (b) and (e) on meshes built
# over its first CM_RANKS and SPR_RANKS ranks
SHARED_RANKS = math.prod(FSDP_MESH)
assert EP_MESH == FSDP_MESH and CM_RANKS == SHARED_RANKS >= SPR_RANKS


def wait_for(path: str, timeout: float = 900.0) -> None:
    """On a rank: wait until the parent has written ``path`` (atomically:
    :func:`fsdp_single`) or has failed (``path``.failed)."""
    import os

    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if os.path.exists(path + ".failed"):
            raise RuntimeError(f"the parent failed before writing {path}")
        if time.monotonic() > end:
            raise TimeoutError(f"{path} not written in {timeout} s")
        time.sleep(0.1)


@contextlib.contextmanager
def ranks_behind(want: str, target: str, world: int, args, **kw):
    """``spawn_ranks(target, world, args, **kw)`` in a thread, so that this
    process makes the file ``want`` that the ranks wait for
    (:func:`wait_for`) while they start; the dict yielded holds their
    results under "ranks" after the block. If the block raises, the ranks
    are told (``want``.failed) and joined before it propagates."""
    import threading

    from repro_torch.launch.mesh import spawn_ranks

    box = {}

    def run():
        try:
            box["ranks"] = spawn_ranks(target, world, args, **kw)
        except BaseException as exc:
            box["exc"] = exc
    thread = threading.Thread(target=run)
    thread.start()
    try:
        yield box
    except BaseException:
        with open(want + ".failed", "w"):
            pass
        thread.join()
        raise
    thread.join()
    if "exc" in box:
        raise box.pop("exc")


def ep_inputs(torch):
    """granite-moe-1b-a400m's MoE layer at full width (d 1024, E 32, top
    8, f 512), bf16 mode, capacity factor 8 (no drops), as the
    reference's check runs it; the layer and x [4, 512, 1024] drawn on
    the card from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import moe_init
    cfg = get_config("granite-moe-1b-a400m").replace(
        quant="bf16", capacity_factor=8.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    p = moe_init(gen, cfg, device="cuda")
    x = torch.randn((*EP_X, cfg.d_model), generator=gen, device="cuda")
    return cfg, p, x


def ep_rank(mesh) -> dict:
    """4m (a), one rank (or the single-process mesh): ``ep_moe_apply``
    on the whole batch, cut over the data axis, twice (the second
    timed); → the whole batch's rows."""
    import torch

    from repro_torch.distributed.expert_parallel import ep_moe_apply
    cfg, p, x = ep_inputs(torch)
    ep_moe_apply(cfg, p, x, mesh)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    y = ep_moe_apply(cfg, p, x, mesh)
    torch.cuda.synchronize()
    return {"y": y.cpu(), "ms": (time.monotonic() - t0) * 1e3,
            "peak": torch.cuda.max_memory_allocated()}


def cm_rank(mesh) -> dict:
    """4m (b), one of 4 model ranks: ``ring_reduce_matmul`` of x_loc [64,
    800] @ w_loc [800, 3200] against ``psum(x_loc @ w_loc)`` and X @ W,
    and ``allgather_matmul`` of x rows [16, 3200] @ W's 800 columns
    against X @ W_loc; each timed (p50 of 5, synchronized host clock)
    beside one plain all_reduce of the [64, 3200] product."""
    import numpy as np
    import torch

    from repro_torch.distributed.collective_matmul import (allgather_matmul,
                                                           ring_reduce_matmul)
    from repro_torch.distributed.partitioning import psum
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k = n = 3200
    x = torch.randn((CM_ROWS, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    r, nr = mesh.rank("model"), mesh.size("model")
    kl, bl = k // nr, CM_ROWS // nr
    x_loc, w_loc = x[:, r * kl:(r + 1) * kl], w[r * kl:(r + 1) * kl]
    x_rows, w_cols = x[r * bl:(r + 1) * bl], w[:, r * kl:(r + 1) * kl]

    def timed(fn):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        return out, float(np.median(times) * 1e3)
    ring, ring_ms = timed(lambda: ring_reduce_matmul(x_loc, w_loc, "model",
                                                     chunks=4, mesh=mesh))
    plain, plain_ms = timed(lambda: psum(x_loc.contiguous()
                                         @ w_loc.contiguous(), "model", mesh))
    ag, ag_ms = timed(lambda: allgather_matmul(x_rows, w_cols, "model",
                                               mesh=mesh))
    want_ag = x @ w_cols.contiguous()
    return {"ring_vs_psum": float((ring - plain).abs().max()),
            "ring_vs_full": float((ring - x @ w).abs().max()),
            "ring_ok": bool(torch.allclose(ring, plain, rtol=1e-4,
                                           atol=1e-4)),
            "ag_ok": bool(torch.allclose(ag, want_ag, rtol=1e-4, atol=1e-4)),
            "ag_err": float((ag - want_ag).abs().max()),
            "scale": float(plain.abs().max()),
            "ring_ms": ring_ms, "ag_ms": ag_ms, "all_reduce_ms": plain_ms,
            "peak": torch.cuda.max_memory_allocated()}


def fsdp_inputs(torch):
    """stablelm-1.6b at full width (d 2048, vocab 100,352), 1 layer (the
    reference's check cuts it to 2; 1 for the smoke run's time), f32
    activations; f32 masters drawn on
    the card from seed 0; SyntheticDataset batch 8 x 128 (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.transformer import init_params
    cfg = get_config("stablelm-1.6b").replace(n_layers=FSDP_LAYERS,
                                              act_dtype="float32")
    batch = SyntheticDataset(cfg, seq_len=FSDP_SEQ, global_batch=FSDP_BATCH,
                             seed=0).batch(0)
    return cfg, init_params(cfg, SEED, "cuda"), {
        k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def _checked_steps(torch, cfg, mesh, params, opt, batch, want: str,
                   faults=()) -> dict:
    """This rank's shards of ``params`` and ``opt`` (whole trees on the
    card), one sharded step (``make_train_step(mesh=)``, the step check's
    schedule) and the step check's sums of its shards against the step
    saved at ``want`` (``torch.save`` of p, m, v by path; read through a
    memory map, a shard at a time); then the same
    step from the same shards with each planted fault of ``faults`` and
    its sums. → the loss, grad norm, ms and peak of the sound step, the
    bytes held against the whole, the sums (the leaves this rank owns),
    and its new shards (``p``, ``o``)."""
    from repro_torch.distributed.partitioning import owns, shard_of
    from repro_torch.training.train import (make_train_step, shard_dims,
                                            shard_tree)
    from repro_torch.tree_util import flatten_with_path, tree_map
    sc = tests_module("torch_step_check")
    dims = shard_dims(cfg, params, mesh)
    both = [path for path, d in dims.items() if all(d[-2:])]
    whole = sum(x.numel() * 4 for path, x in flatten_with_path(params)
                if path in both)
    p0 = shard_tree(params, dims, mesh)
    o0 = shard_tree(opt, dims, mesh)
    del params, opt
    free_cuda(torch)
    held = sum(x.numel() * 4 for path, x in flatten_with_path(p0)
               if path in both)
    step = make_train_step(cfg, mesh=mesh, dims=dims, **sc.STEP)
    wait_for(want)
    ref = torch.load(want, mmap=True, map_location="cpu")
    coords = mesh.coords()
    start = dict(flatten_with_path(p0))

    def clone(tree):
        return tree_map(lambda x: x.clone(), tree)

    def run(fault):
        p = clone(p0)
        o = o0._replace(step=o0.step.clone(), m=clone(o0.m), v=clone(o0.v))
        torch.cuda.reset_peak_memory_stats()
        with sc.planted(fault):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            p, o, m = step(p, o, batch)
            torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        got = {part: dict(flatten_with_path(tree))
               for part, tree in (("p", p), ("m", o.m), ("v", o.v))}
        sums = {path: sc.leaf_sums(x, [got[part][path] for part in "pmv"],
                                   [shard_of(ref[part][path], dims[path],
                                             coords, mesh).to(x.device)
                                    for part in "pmv"])
                for path, x in start.items() if owns(dims[path], coords,
                                                     mesh)}
        return p, o, m, sums, ms
    p, o, m, sums, ms = run(None)
    out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               ms=ms, peak=torch.cuda.max_memory_allocated(), dims=dims,
               held=held, whole=whole, sums=sums, p=p, o=o)
    for fault in faults:
        _, _, _, out[f"sums/{fault}"], out[f"ms/{fault}"] = run(fault)
    return out


def fsdp_rank(mesh, ckpt_dir: str) -> dict:
    """4m (c), one rank of (data 2, model 2): the masters drawn, this
    rank's shards of them and of fresh moments, one sharded step checked
    against the ranks' single-process emulation (``ckpt_dir``/want_c.pt),
    then each planted fault's; the sound step's state gathered and
    checkpointed by rank 0 (the step the restart resumes from)."""
    import torch

    from repro_torch.checkpoint.store import save_checkpoint
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import gather_tree
    sc = tests_module("torch_step_check")
    t0 = time.monotonic()
    cfg, params, batch = fsdp_inputs(torch)
    torch.cuda.synchronize()
    drawn = time.monotonic() - t0
    t0 = time.monotonic()
    out = _checked_steps(torch, cfg, mesh, params, adamw_init(params), batch,
                         f"{ckpt_dir}/want_c.pt", SMOKE_FAULTS)
    stepped = time.monotonic() - t0
    t0 = time.monotonic()
    state = {"params": gather_tree(out.pop("p"), out["dims"], mesh),
             "opt": gather_tree(out.pop("o"), out["dims"], mesh)}
    torch.cuda.synchronize()
    gathered = time.monotonic() - t0
    if mesh.rank(mesh.axis_names) == 0:
        save_checkpoint(f"{ckpt_dir}/ckpt", 1, state)
    return dict(out, draw_s=drawn, steps_s=stepped, gather_s=gathered,
                save_s=time.monotonic() - t0 - gathered)


def first_cuda(torch) -> dict:
    """A spawned rank's wall-clock stamps (``time.time()``, comparable
    across processes): entering its target (after the process start, its
    imports, the gloo rendezvous and the mesh), then after its first CUDA
    call."""
    stamps = {"entered": time.time()}
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    stamps["cuda"] = time.time()
    return stamps


def shared_rank(mesh, ckpt_dir: str) -> dict:
    """4m (a), (b), (c), (e) and (f) on one of the 4 ranks of one spawn,
    one after the other, the rank's peak reset and its memory freed
    between them: (a) :func:`ep_rank` and (c) :func:`fsdp_rank` on the
    (data, model) mesh it was spawned with, (b) :func:`cm_rank` on a
    4-rank model mesh, (e) :func:`sp_rec_rank` on a 2-rank model mesh
    and (f) :func:`dp_rank` on a 2-rank data mesh, both over ranks 0 and
    1 (the others sit them out). Every rank builds every mesh, in the
    same order. → each sub-arm's result under its letter, and the
    rank's stamps (:func:`first_cuda`, then the end of each sub-arm)."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    stamps = first_cuda(torch)
    out = {}
    arms = (("a", lambda: ep_rank(mesh)),
            ("b", lambda: cm_rank(make_host_mesh((CM_RANKS,), ("model",)))),
            ("c", lambda: fsdp_rank(mesh, ckpt_dir)),
            ("e", lambda: (lambda m: None if m is None else sp_rec_rank(m))(
                make_host_mesh((SPR_RANKS,), ("model",)))),
            ("f", lambda: (lambda m: None if m is None else dp_rank(
                m, *dp_inputs()))(make_host_mesh((DP_RANKS,), ("data",)))))
    for key, arm in arms:
        torch.cuda.reset_peak_memory_stats()
        res = arm()
        if res is not None:
            out[key] = res
        free_cuda(torch)
        stamps[key] = time.time()
    out["stamps"] = stamps
    return out


def elastic_rank(mesh, ckpt_dir: str) -> dict:
    """4m (d), one of 3 survivors (a fresh process group: the restart):
    ``elastic_restart`` builds (1, 2) over the first two and loads the
    checkpoint; the spare returns; the others take one more sharded
    step, checked against the ranks' single-process emulation from the
    same checkpoint (``ckpt_dir``/want_d.pt)."""
    import torch

    from repro_torch.distributed.fault_tolerance import elastic_restart
    from repro_torch.training.optimizer import adamw_init
    stamps = first_cuda(torch)
    t0 = time.monotonic()
    cfg, like, batch = fsdp_inputs(torch)
    emesh, state, step, _ = elastic_restart(
        f"{ckpt_dir}/ckpt", {"params": like, "opt": adamw_init(like)}, None,
        model=FSDP_MESH[1])
    del like
    torch.cuda.synchronize()
    loaded = time.monotonic() - t0
    if emesh is None:
        return {"spare": True, "step": step,
                "stamps": dict(stamps, d=time.time())}
    out = _checked_steps(torch, cfg, emesh, state["params"], state["opt"],
                         batch, f"{ckpt_dir}/want_d.pt")
    out.pop("p"), out.pop("o")
    return dict(out, step=step, shape=dict(emesh.shape), load_s=loaded,
                stamps=dict(stamps, d=time.time()))


def sp_rec_rank(mesh) -> dict:
    """4m (e), one rank (or the single-process mesh, or None: unsharded):
    per arch of ``SPR_ARCHS`` its seeded weights on the card, 4 prompts
    prefilled whole, then ``SPR_STEPS`` greedy ``serve_step`` calls with
    ``sp_axes=("model",)`` on this rank's token shard (the hybrid
    model's attention pages; the Mamba and rwkv states whole), LOP and
    dense. → tokens, launch counts and step ms by arm."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.partitioning import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as teng
    from repro_torch.serving.quantize import init_serving_params
    out = {}
    for arch, (name, layers, plen, max_len) in SPR_ARCHS.items():
        cfg = get_config(name)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        qp = init_serving_params(cfg, SEED, "cuda")
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (SPR_LANES, plen))).to("cuda")
        for use_lop in (True, False):
            logits, cache = teng.prefill(cfg, qp, prompts, max_len=max_len)
            tok = logits.argmax(-1)
            toks, times = [tok], []
            ops.reset_launch_counts()
            with use_mesh(mesh):
                if mesh is not None:
                    cache = teng.shard_cache(cache)
                for _ in range(SPR_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    logits, cache = teng.serve_step(
                        cfg, qp, cache, tok[:, None], use_lop=use_lop,
                        sp_axes=None if mesh is None else ("model",))
                    tok = logits.argmax(-1)
                    torch.cuda.synchronize()
                    times.append(time.monotonic() - t0)
                    toks.append(tok)
            out[f"{arch}/{'lop' if use_lop else 'dense'}"] = dict(
                tokens=torch.stack(toks, 1).cpu().numpy(),
                counts=ops.launch_counts(modes=True),
                step_ms=float(np.median(times) * 1e3),
                peak=torch.cuda.max_memory_allocated())
        del qp, cache
        free_cuda(torch)
    return out


def _rank_peaks(ranks) -> str:
    return " / ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks
                      if "peak" in r) + " GiB"


def stamp_line(t_spawn: float, t_back: float, ranks, arms) -> str:
    """Where a spawn's seconds went, by the ranks' stamps (the slowest
    rank at each): the start (processes, imports, gloo rendezvous, mesh)
    and the first CUDA call, each sub-arm's work, then the exit and
    join."""
    stamps = [r["stamps"] for r in ranks]
    marks = [("start", "entered"), ("first CUDA call", "cuda")] + [
        (f"({k})", k) for k in arms]
    parts, t = [], t_spawn
    for label, key in marks:
        end = max(st[key] for st in stamps if key in st)
        parts.append(f"{label} {end - t:.1f}")
        t = end
    parts.append(f"exit and join {t_back - t:.1f}")
    return ", ".join(parts) + f" s ({t_back - t_spawn:.1f} s in all)"


def distributed_phase(torch, np, card: str) -> dict:
    """Phase 4m: (a) EP MoE, (b) the ring collective matmuls, (c) the
    sharded training step, (e) SP decode of the hybrid and ssm families
    and (f) the int8 gradient compression in one spawn of 4 gloo ranks on
    cuda:0 (:func:`shared_rank`), each held against this process's
    single-process run, made while the ranks start; then (d), the elastic
    restart from (c)'s checkpoint, in a fresh spawn of 3 survivors. Each
    spawn's seconds are split by the ranks' stamps. → #4/#5 launches of
    (e)'s rank 0."""
    import os
    import tempfile

    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models.moe import train_moe_apply

    sc = tests_module("torch_step_check")
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a), (b), (c) and (e) on one spawn of 4 ranks, and this
        # process's side of (a), (c) and (e) while the ranks start ----
        t_spawn = time.time()
        with ranks_behind(f"{tmp}/want_c.pt", "chip_smoke:shared_rank",
                          SHARED_RANKS, (tmp,), shape=FSDP_MESH,
                          axes=("data", "model"), timeout=1200) as spawn:
            t0 = time.monotonic()
            cfg_c, single_ms, m, em = fsdp_single(torch, f"{tmp}/want_c.pt")
            t_c = time.monotonic() - t0
            t0 = time.monotonic()
            cfg, p, x = ep_inputs(torch)
            n_tok = x.shape[0] * x.shape[1] // EP_MESH[0]
            want_a, _ = train_moe_apply(cfg.replace(moe_group=n_tok), p, x)
            want_a = want_a.cpu()
            local = ep_rank(local_mesh(EP_MESH, ("data", "model")))
            del p, x
            free_cuda(torch)
            t_a = time.monotonic() - t0
            t0 = time.monotonic()
            single = sp_rec_rank(None)
            free_cuda(torch)
            t_e = time.monotonic() - t0
            t0 = time.monotonic()
            matmul = torch.backends.cuda.matmul
            reduced_bf16 = matmul.allow_bf16_reduced_precision_reduction
            try:                         # dp_rank sets it for its process
                one_f = dp_rank(local_mesh((DP_RANKS,), ("data",)),
                                *dp_inputs())
            finally:
                matmul.allow_bf16_reduced_precision_reduction = reduced_bf16
            t_f = time.monotonic() - t0
            log(f"  this process's runs while the ranks start: (c) the "
                f"mesh-less step and the ranks' emulation {t_c:.1f} s, (a) "
                f"the single-process mesh and moe_apply {t_a:.1f} s, (e) "
                f"the unsharded engines {t_e:.1f} s, (f) the "
                f"single-process mesh {t_f:.1f} s [{card}]")
        shared = spawn["ranks"]
        t_back = time.time()
        os.remove(f"{tmp}/want_c.pt")
        log(f"  one spawn of {SHARED_RANKS} ranks for (a), (b), (c), (e), "
            f"(f): " + stamp_line(t_spawn, t_back, shared, "abcef")
            + f" [{card}]")

        # ---- (a) EP MoE ----
        ranks = [r["a"] for r in shared]
        err = max(float((y - want_a).abs().max()) for y in local["y"][0])
        if not all(torch.allclose(y, want_a, rtol=2e-3, atol=2e-3)
                   for y in local["y"][0]):
            raise AssertionError(f"(a) EP on the card's single-process mesh "
                                 f"{err:.3g} from moe_apply")
        for r, res in enumerate(ranks):
            if not torch.equal(res["y"], local["y"][0, r % EP_MESH[1]]):
                raise AssertionError(f"(a) EP rank {r} != the "
                                     f"single-process mesh's rows")
        log(f"  (a) EP MoE, granite-moe-1b-a400m's layer (d {cfg.d_model}, E "
            f"{cfg.n_experts} top-{cfg.top_k}, f {cfg.d_ff}; bf16 mode, "
            f"capacity factor 8), x {list(EP_X)} x {cfg.d_model} on (data, "
            f"model) {EP_MESH}, {cfg.n_experts // EP_MESH[1]} experts a rank: "
            f"{err:.3g} from moe_apply at moe_group {n_tok} (gate 2e-3); "
            f"{len(ranks)} ranks bitwise the single-process mesh; one call "
            + " / ".join(f"{r['ms']:.1f}" for r in ranks)
            + f" ms by rank (single-process mesh {local['ms']:.1f} ms; two "
            f"all_to_all_singles and the rows' all_gather through gloo); "
            f"peaks {_rank_peaks(ranks)} [{card}]")
        del local, want_a

        # ---- (b) ring collective matmuls ----
        ranks = [r["b"] for r in shared]
        for r, res in enumerate(ranks):
            if not (res["ring_ok"] and res["ag_ok"]):
                raise AssertionError(f"(b) rank {r}: {res}")
        log(f"  (b) bitnet-3b's O shape (k 3200 cut 4 ways, n 3200, "
            f"{CM_ROWS} rows) over {CM_RANKS} model ranks: ring_reduce_matmul "
            f"{max(r['ring_vs_psum'] for r in ranks):.3g} from psum(x_loc @ "
            f"w_loc) ({max(r['ring_vs_full'] for r in ranks):.3g} from X @ W; "
            f"values to {ranks[0]['scale']:.1f}), allgather_matmul "
            f"{max(r['ag_err'] for r in ranks):.3g} from X @ W_loc (gates "
            f"rtol = atol = 1e-4); ms by rank: ring "
            + " / ".join(f"{r['ring_ms']:.2f}" for r in ranks)
            + ", all-gather " + " / ".join(f"{r['ag_ms']:.2f}" for r in ranks)
            + ", one plain all_reduce of the product "
            + " / ".join(f"{r['all_reduce_ms']:.2f}" for r in ranks)
            + f" (gloo on one card: no overlap to show); peaks "
            f"{_rank_peaks(ranks)} [{card}]")

        # ---- (c) the sharded step ----
        ranks = [r["c"] for r in shared]
        worst, bitwise, caught = fsdp_verdict(sc, ranks, m, em, "(c)",
                                              SMOKE_FAULTS)
        res = ranks[0]
        log(f"  (c) stablelm-1.6b full width (d {cfg_c.d_model}, vocab "
            f"{cfg_c.vocab}), {cfg_c.n_layers} layers, f32, batch "
            f"{FSDP_BATCH} x {FSDP_SEQ} on (data, model) {FSDP_MESH}, lr "
            f"{float(em['lr']):.1e} at step 1: loss "
            + " / ".join(f"{r['loss']:.6f}" for r in ranks)
            + f" by rank, single-process step {float(m['loss']):.6f}; grad "
            f"norm {res['grad_norm']:.6f} / {float(m['grad_norm']):.6f} "
            f"(rtol 1e-4); against the ranks' emulation in one process "
            f"(loss and grad norm within 1e-6; shards "
            f"{'bitwise' if bitwise else 'not bitwise'}): update gap "
            f"{worst['update']:.3g} of its norm (bound {sc.UPDATE_TOL}), "
            f"{worst['element']:.3g} lr in an element (bound "
            f"{sc.ELEM_TOL}; {worst['left_out']} of {worst['n']} elements "
            f"left out, their gradients zero to rounding), m "
            f"{worst['m']:.3g}, v {worst['v']:.3g} of their norms (bound "
            f"{sc.MOMENT_TOL}); planted faults caught: "
            + ", ".join(f"{f} ({n} leaves)" for f, n in caught.items())
            + f"; a rank holds {res['held'] / 2**20:.1f} MiB of the "
            f"{res['whole'] / 2**20:.1f} MiB of masters cut on both axes "
            f"({res['held'] / res['whole']:.4f}; the two moments the same); "
            f"step ms by rank "
            + " / ".join(f"{r['ms']:.0f}" for r in ranks)
            + f" (single-process {single_ms:.0f}; the emulation and its "
            f"6-GB file {em['s']:.1f} s), rank 0's fault steps "
            + " / ".join(f"{res[f'ms/{f}']:.0f}" for f in SMOKE_FAULTS)
            + f" ms; rank 0's draw {res['draw_s']:.1f} s, the checked steps "
            f"with their sums {res['steps_s']:.1f} s, gather of the state "
            f"{res['gather_s']:.1f} s, checkpoint write {res['save_s']:.1f} "
            f"s; peaks {_rank_peaks(ranks)} [{card}]")

        # ---- (e) SP decode of the hybrid and ssm families ----
        ranks = [r["e"] for r in shared[:SPR_RANKS]]
        if any("e" in r for r in shared[SPR_RANKS:]):
            raise AssertionError("(e) ran on a rank outside its mesh")
        for arm, want in single.items():
            for r, res in enumerate(ranks):
                if not np.array_equal(res[arm]["tokens"], want["tokens"]):
                    raise AssertionError(
                        f"(e) [{arm}] rank {r} tokens "
                        f"{res[arm]['tokens'].tolist()} != unsharded "
                        f"{want['tokens'].tolist()}")
            counts = {k: v for k, v in ranks[0][arm]["counts"].items() if v}
            attn = ("fused_decode_attention" if arm.endswith("lop")
                    else DENSE)
            # every attention launch of a sequence-parallel step is in the
            # pos_offset + return_stats mode (jamba's; rwkv6 has none)
            need = ["fused_qlinear"] + ([attn] if arm.startswith("jamba")
                                        else [])
            if any(counts.get(k, 0) <= 0 for k in need):
                raise AssertionError(f"(e) [{arm}] rank 0 launched "
                                     f"{counts}, not {need}")
            log(f"  (e) [{arm}] {SPR_LANES} lanes, {SPR_STEPS} greedy steps "
                f"with sp_axes=('model',) over {SPR_RANKS} ranks == the "
                f"unsharded engine's tokens; rank 0's launches {counts}; "
                f"step p50 " + " / ".join(f"{r[arm]['step_ms']:.2f}"
                                          for r in ranks)
                + f" ms by rank (unsharded {want['step_ms']:.2f}); peaks "
                + " / ".join(f"{r[arm]['peak'] / 2**30:.2f}" for r in ranks)
                + f" GiB [{card}]")
        stats = {"lop": 0, "dense": 0}
        for arm, res in ranks[0].items():
            mode = arm.split("/")[1]
            name = "fused_decode_attention" if mode == "lop" else DENSE
            stats[mode] += res["counts"][name]
        # ---- (f) the int8 gradient compression ----
        stats["compress"] = compress_verdict(
            torch, [r["f"] for r in shared[:DP_RANKS]], one_f, card)
        if any("f" in r for r in shared[DP_RANKS:]):
            raise AssertionError("(f) ran on a rank outside its mesh")
        del shared, ranks, single, one_f
        free_cuda(torch)

        # ---- (d) the elastic restart: a fresh spawn of 3 survivors, and
        # the single-process step from the same checkpoint while they
        # start and load it ----
        t_spawn = time.time()
        with ranks_behind(f"{tmp}/want_d.pt", "chip_smoke:elastic_rank",
                          ELASTIC_SURVIVORS, (tmp,), timeout=900) as spawn:
            t0 = time.monotonic()
            _, _, m, em = fsdp_single(torch, f"{tmp}/want_d.pt",
                                      f"{tmp}/ckpt")
            t_single = time.monotonic() - t0
        ranks = spawn["ranks"]
        t_back = time.time()
    on_mesh = [r for r in ranks if not r.get("spare")]
    if len(on_mesh) != 2 or not ranks[-1].get("spare") or any(
            r["step"] != 1 for r in ranks):
        raise AssertionError(f"(d) elastic restart: "
                             f"{[r.get('shape') for r in ranks]}")
    worst, bitwise, _ = fsdp_verdict(sc, on_mesh, m, em, "(d)", ())
    log(f"  (d) elastic restart on {ELASTIC_SURVIVORS} survivors: plan "
        f"{tuple(on_mesh[0]['shape'].values())} (rank 2 the spare), the "
        f"checkpoint of (c)'s step 1 loaded; one more step (lr "
        f"{float(em['lr']):.3e}): loss "
        + " / ".join(f"{r['loss']:.6f}" for r in on_mesh)
        + f", single-process step from the same checkpoint "
        f"{float(m['loss']):.6f}; against the ranks' emulation from it "
        f"(shards {'bitwise' if bitwise else 'not bitwise'}): update gap "
        f"{worst['update']:.3g} of its norm, {worst['element']:.3g} lr in "
        f"an element "
        f"({worst['left_out']} left out), m {worst['m']:.3g}, v "
        f"{worst['v']:.3g}; load s by rank "
        + " / ".join(f"{r['load_s']:.1f}" for r in on_mesh)
        + ", step ms by rank " + " / ".join(f"{r['ms']:.0f}" for r in on_mesh)
        + f"; peaks {_rank_peaks(on_mesh)}; this process's step and "
        f"emulation from the checkpoint {t_single:.1f} s while the ranks "
        f"start and load it, the spawn "
        + stamp_line(t_spawn, t_back, ranks, "d") + f" [{card}]")
    del ranks, on_mesh
    free_cuda(torch)
    return stats


def fsdp_single(torch, want: str, ckpt: str | None = None):
    """The single-process steps on the card (the step check's schedule),
    from the drawn masters and fresh moments, or from the checkpoint at
    ``ckpt``: the mesh-less step on the whole batch (timed), and the
    ranks' step emulated in this process on (data, model) ``FSDP_MESH``
    (or (1, 2) from the checkpoint, the restart's mesh), whose p, m and v
    are saved by path at ``want`` for the ranks' step check. → (the
    config, the mesh-less step's ms and metrics, the emulation's
    metrics)."""
    import os

    from repro_torch.checkpoint.store import load_checkpoint
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import make_train_step
    from repro_torch.tree_util import flatten_with_path, tree_map
    sc = tests_module("torch_step_check")
    cfg, params, batch = fsdp_inputs(torch)
    opt = adamw_init(params)
    if ckpt is not None:
        state, _, _ = load_checkpoint(ckpt, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        del state

    def clone(tree):
        return tree_map(lambda x: x.clone(), tree)
    p, o = clone(params), opt._replace(step=opt.step.clone(), m=clone(opt.m),
                                       v=clone(opt.v))
    step = make_train_step(cfg, **sc.STEP)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, _, m = step(p, o, batch)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    del p, o
    mesh = local_mesh(FSDP_MESH if ckpt is None else (1, FSDP_MESH[1]),
                      ("data", "model"))
    t0 = time.monotonic()
    params, opt, em = sc.local_sharded_step(cfg, mesh, params, opt, batch,
                                            **sc.STEP)
    torch.save({part: {path: x.cpu() for path, x in flatten_with_path(tree)}
                for part, tree in (("p", params), ("m", opt.m),
                                   ("v", opt.v))}, want + ".part")
    os.replace(want + ".part", want)        # whole when a rank sees it
    del params, opt, batch
    free_cuda(torch)
    em = {k: v.cpu() for k, v in em.items()}
    em["s"] = time.monotonic() - t0
    return cfg, ms, {k: v.cpu() for k, v in m.items()}, em


def fsdp_verdict(sc, ranks, m: dict, em: dict, label: str,
                 faults) -> tuple:
    """Each rank's loss and pre-clip grad norm within rtol 1e-4 of the
    mesh-less single-process step's (metrics ``m``) and within 1e-6 of
    the emulation's (``em``); the ranks' step-check sums against the
    emulation added over the leaves' owners and the step check passed;
    each planted fault of ``faults`` failing it. → (the worst measures,
    whether every shard is bitwise the emulation's, the number of leaves
    each fault failed)."""
    for r, res in enumerate(ranks):
        for key in ("loss", "grad_norm"):
            if not math.isclose(res[key], float(m[key]), rel_tol=1e-4):
                raise AssertionError(f"{label} rank {r} {key} {res[key]} "
                                     f"!= {float(m[key])}")
            if not math.isclose(res[key], float(em[key]), rel_tol=1e-6):
                raise AssertionError(f"{label} rank {r} {key} {res[key]} "
                                     f"!= the emulation's {float(em[key])}")

    def total(key):
        out = {}
        for res in ranks:
            for path, s in res[key].items():
                out[path] = s if path not in out else sc.add_sums(out[path],
                                                                  s)
        return out
    lr = float(em["lr"])
    sums = total("sums")
    bad = sc.step_faults(sums, lr)
    if bad:
        raise AssertionError(f"{label} the sharded step parts from the "
                             f"ranks' emulation: {bad[:8]}")
    bitwise = all(float(s[0]) == float(s[3]) == float(s[5]) == 0.0
                  for s in sums.values())
    caught = {}
    for fault in faults:
        caught[fault] = len({f[0] for f in sc.step_faults(
            total(f"sums/{fault}"), lr)})
        if not caught[fault]:
            raise AssertionError(f"{label} the step check passed a step "
                                 f"with the fault {fault!r} planted")
    return sc.worst(sums, lr), bitwise, caught


# ---------------------------------------------------------------------------
# phase 9: the port's examples, the entry points a user starts from
# ---------------------------------------------------------------------------

EXAMPLE_STEPS, EXAMPLE_CKPT_EVERY, EXAMPLE_PREEMPT = 60, 20, 40


def example_module(name: str):
    """``examples/<name>.py`` of this checkout as a module (examples is no
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, label: str | None = None, **kw):
    """``fn(*args, **kw)`` with its standard output captured (and, with a
    ``label``, logged a line at a time under it). → (result, lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    lines = buf.getvalue().splitlines()
    if label is not None:
        for line in lines:
            log(f"  [{label}] {line}")
    return out, lines


def continuation(lines: list) -> list:
    """The greedy continuation's rows of the quickstart's printed lines."""
    at = lines.index("greedy continuation:") + 1
    rows = []
    for line in lines[at:]:
        rows.append([int(t) for t in line.strip(" []").split()])
        if line.endswith("]]"):
            return rows
    raise AssertionError(f"no continuation in {lines}")


def teacher_forced(torch, np, cfg, qp, card: str) -> dict:
    """The quickstart's pipeline on the card and on the CPU from the same
    weights, both fed the CPU's greedy tokens. Gates: every kernel call of
    the card's run (#1–#4 at the example's shapes) against its plain
    version on the same card inputs (#1, #2 bitwise, #3, #4 within
    ``TOL``); layer 0's prefill pages bitwise the CPU's; and every argmax
    that parts a near-tie, the CPU's top-2 margin below the lane's logit
    gap. Logged beside them: the int8 K/V values that part by layer, and
    the first of the attention's int8 barriers (q, k, v of the prefill
    and each step, the engine's ``_q``) to part, with how far apart the
    two sides' x/scale lie there and after it. → the figures."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import ops
    from repro_torch.serving import engine
    from repro_torch.tree_util import tree_map

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 24)).astype(
        np.int32))
    sides = {"cpu": (qp, "cpu"),
             "card": (tree_map(lambda x: x.to("cuda"), qp), "cuda")}
    rec = {side: [] for side in sides}
    held = {}                       # kernel → [calls, max |err|]
    real_q, now = engine._q, []
    entries = {"qlinear_fused": ("fused_qlinear", True),
               "ffn_fused": ("fused_ffn", True),
               "prefill_attention": ("fused_prefill_attention", False),
               "decode_attention": ("fused_decode_attention", False)}
    real = {name: getattr(ops, name) for name in entries}

    def recorded(x):
        rec[now[-1]].append(x.detach().to("cpu", torch.float32, copy=True))
        return real_q(x)

    def against_plain(name):
        kernel, bitwise = entries[name]

        def call(*a, **k):
            got = real[name](*a, **k)
            if a[0].device.type == "cuda":
                on_cuda, ops._on_cuda = ops._on_cuda, lambda t: False
                try:
                    want = real[name](*a, **k)        # the plain version
                finally:
                    ops._on_cuda = on_cuda
                kname = (f"{kernel}[quickstart, "
                         f"{'x'.join(map(str, a[0].shape))}]")
                err = check_close(torch, kname, got, want, bitwise=bitwise)
                calls, worst = held.get(kernel, (0, 0.0))
                held[kernel] = (calls + 1, max(worst, err))
            return got
        return call

    def both(fn):
        out = {}
        for side, (w, dev) in sides.items():
            now.append(side)
            out[side] = fn(side, w, dev)
        return out
    engine._q = recorded
    for name in entries:
        setattr(ops, name, against_plain(name))
    try:
        state = both(lambda side, w, dev: engine.prefill(
            cfg, w, prompts.to(dev), max_len=40))
        pages = {side: state[side][1]["layers"] for side in sides}
        apart = [sum(int((pages["cpu"][key][i]
                          != pages["card"][key][i].cpu()).sum())
                     for key in ("k", "v")) for i in range(cfg.n_layers)]
        gaps, ties, step = [], [], 0
        while True:
            cpu, dev = state["cpu"][0], state["card"][0].cpu()
            gap = (cpu - dev).abs().amax(-1)
            gaps.append(float(gap.max()))
            for lane in (cpu.argmax(-1) != dev.argmax(-1)).nonzero()[:, 0]:
                top = cpu[lane].topk(2).values
                ties.append((step, int(lane), float(top[0] - top[1]),
                             float(gap[lane])))
            if step == 16:
                break
            step += 1
            tok = cpu.argmax(-1)[:, None].to(torch.int32)
            state = both(lambda side, w, dev: engine.serve_step(
                cfg, w, state[side][1], tok.to(dev)))
    finally:
        engine._q = real_q
        for name, fn in real.items():
            setattr(ops, name, fn)
    per = 3 * cfg.n_layers
    if len(rec["cpu"]) != 17 * per or len(rec["card"]) != 17 * per:
        raise AssertionError(f"[quickstart] {len(rec['cpu'])} / "
                             f"{len(rec['card'])} int8 barriers recorded, "
                             f"want 17 x {per}")
    if sorted(held) != sorted(k for k, _ in entries.values()):
        raise AssertionError(f"[quickstart] kernels held against their "
                             f"plain versions: {held}")
    first, drift, n_apart = None, 0.0, 0
    for i, (xc, xd) in enumerate(zip(rec["cpu"], rec["card"])):
        qc, qd = quantize(xc), quantize(xd)
        parts = int((qc.values != qd.values).sum())
        d = float((xc / qc.scale - xd / qd.scale).abs().max())
        if parts and first is None:
            first = (i, parts, d)
        if first is not None:
            drift = max(drift, d)
        n_apart += parts

    def where(i):
        return (f"{'prefill' if i < per else f'step {i // per}'} layer "
                f"{i % per // 3} {'qkv'[i % 3]}")
    faults = ([f"layer 0's prefill pages part at {apart[0]} values"]
              if apart[0] else [])
    faults += [f"step {s} lane {lane}: the argmax parts at a top-2 margin "
               f"{m:.3g}, not below the logit gap {g:.3g}"
               for s, lane, m, g in ties if m >= g]
    log(f"  [quickstart] teacher-forced on the CPU's tokens: every kernel "
        f"call of the card's run against its plain version on the card "
        + ", ".join(f"{k} {n} calls (max |err| {e:.3g})"
                    for k, (n, e) in held.items())
        + f"; card against CPU: int8 K/V values of the prefill's pages "
        f"apart by layer {apart}; {n_apart} int8 values apart over the "
        f"{len(rec['cpu'])} q/k/v barriers, the first at "
        + ("none" if first is None else
           f"{where(first[0])} ({first[1]} value(s), x/scale {first[2]:.3g}"
           f" steps apart there, at most {drift:.3g} from there on)")
        + f"; max |logit gap| {gaps[0]:.3g} at the prefill, "
        f"{max(gaps):.3g} over 16 steps; {len(ties)} argmax parting(s) "
        f"{[(s, lane, round(m, 4), round(g, 4)) for s, lane, m, g in ties]}"
        f" (step, lane, the CPU's top-2 margin, the lane's gap) [{card}]")
    if faults:
        raise AssertionError(f"[quickstart] card against CPU: {faults[:8]}")
    return dict(kernels=held, pages_apart=apart, values_apart=n_apart,
                first_parting=None if first is None else where(first[0]),
                drift=drift, ties=ties, max_gap=max(gaps))


def examples_phase(torch, np, card: str) -> dict:
    """Phase 9: the three examples of the port, in this process on the
    card, each with the launch counts zeroed just before and read just
    after: (a) ``torch_quickstart`` at its defaults through its entry
    point (#1–#4 launched, #5 idle), then its pipeline on CPU-drawn
    weights on the card against the CPU (:func:`teacher_forced`, a
    gate); (b) ``torch_serve_lop`` at its defaults (mistral-nemo-12b
    reduced): every request of both scheduler demos
    equal to its lockstep replay; (c) ``torch_train_bitnet``'s
    bitnet-100m, ``EXAMPLE_STEPS`` steps of 8 x 256 with a checkpoint
    every ``EXAMPLE_CKPT_EVERY``, preempted after step
    ``EXAMPLE_PREEMPT``, then resumed from that checkpoint to the end:
    no kernel of the table launched, the mean loss of the last 10 steps
    below the first 10's. → launches and stats."""
    import tempfile

    from repro_torch.checkpoint.store import latest_step
    from repro_torch.kernels import ops
    from repro_torch.serving.quantize import init_serving_params

    launches = {k: 0 for k in KERNEL_NAMES}
    seconds = {}

    def counted(label, want, idle, fn, *args, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        out, lines = printed(fn, *args, label=label, **kw)
        torch.cuda.synchronize()
        seconds[label] = time.monotonic() - t0
        counts = ops.launch_counts()
        check_counts(counts, label, want, idle)
        for k in KERNEL_NAMES:
            launches[k] += counts[k]
        log(f"  [{label}] {seconds[label]:.1f} s; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})} [{card}]")
        return out, lines

    experts = ("fused_qlinear_experts", "fused_ffn_experts")
    # (a) the quickstart
    quick = example_module("torch_quickstart")
    rc, lines = counted("quickstart", LOP_PATH, (DENSE, *experts),
                        quick.main, [])
    rows = continuation(lines)
    cfg = quick.CFG.replace(lop_keep=0.25)
    if rc or len(rows) != 4 or any(
            len(r) != 16 or not all(0 <= t < cfg.vocab_padded for t in r)
            for r in rows):
        raise AssertionError(f"[quickstart] exit {rc}, continuation {rows}")
    tied = teacher_forced(torch, np, cfg,
                          init_serving_params(cfg, SEED, "cpu"), card)
    # (b) serve_lop
    serve = example_module("torch_serve_lop")
    out, _ = counted("serve_lop", (*LOP_PATH, DENSE), experts, serve.demo,
                     serve.parse_args([]))
    for part in ("batching", "sampled"):
        n = len(out[part]["results"])
        if out[part]["agree"] != n or not out[part]["verified"]:
            raise AssertionError(f"[serve_lop] {part}: lockstep agreement "
                                 f"{out[part]['agree']}/{n}")
    # (c) train_bitnet: preempted, then resumed from its checkpoint
    train = example_module("torch_train_bitnet")
    with tempfile.TemporaryDirectory() as ckpt:
        kw = dict(steps=EXAMPLE_STEPS, global_batch=8, seq=256,
                  ckpt_dir=ckpt, ckpt_every=EXAMPLE_CKPT_EVERY)
        first, _ = counted("train_bitnet", (), KERNEL_NAMES, train.train,
                           train.CFG_100M, preemption=StopAfter(
                               EXAMPLE_PREEMPT), **kw)
        stopped = latest_step(ckpt)
        rest, lines = counted("train_bitnet resumed", (), KERNEL_NAMES,
                              train.train, train.CFG_100M, **kw)
        last = latest_step(ckpt)
    losses = first["losses"] + rest["losses"]
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if (first["last_step"] != EXAMPLE_PREEMPT or stopped != EXAMPLE_PREEMPT
            or f"resumed from step {EXAMPLE_PREEMPT}" not in lines
            or rest["last_step"] != EXAMPLE_STEPS or last != EXAMPLE_STEPS
            or len(losses) != EXAMPLE_STEPS or not tail < head):
        raise AssertionError(
            f"[train_bitnet] stopped at {first['last_step']} (checkpoint "
            f"{stopped}), resumed to {rest['last_step']} (checkpoint "
            f"{last}), {len(losses)} losses, {head:.4f} → {tail:.4f}")
    log(f"  [train_bitnet] preempted after step {EXAMPLE_PREEMPT} "
        f"(checkpoint {stopped}), resumed to {last}: loss (mean of 10) "
        f"{head:.4f} → {tail:.4f}; straggler summary {rest['straggler']} "
        f"[{card}]")
    return dict(launches=launches, seconds=seconds,
                keep_agreement=out["agreement"], loss=(head, tail),
                teacher_forced=tied)


# ---------------------------------------------------------------------------

def main() -> int:
    t_start = time.monotonic()
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} is missing: run from a checkout "
                    "of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    phase_s = {"1": time.monotonic() - t_start}
    t_phase = time.monotonic()

    # ---- 2. build ----
    t0 = time.monotonic()
    libs = _build.build_all()
    for src in _build.SOURCES:
        _build.load(src)
    log(f"[build] {len(libs)} libraries in {time.monotonic() - t0:.1f} s")
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            log(f"  {src}: {line.strip()}")

    # phase 8 (a)'s host traces, beside the card's phases 3–7
    dryrun_host = start_dryrun_host()

    phase_s["2"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 3. kernels ----
    log(f"[kernels] full-width shapes, held against the plain versions "
        f"(rtol=atol={TOL['rtol']}; projections bitwise) [{smi}]")
    rows = kernel_phase(torch, np)

    phase_s["3"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4. serve ----
    log(f"[serve] bitnet-3b full width, {N_SLOTS} slots, {N_REQUESTS} "
        f"requests, gen {GEN} [{smi}]")
    engine, reqs, serve = serve_phase(torch, np, smi)

    phase_s["4"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4n. the prefill chunk width on the main path ----
    log(f"[serve chunk widths] bitnet-3b full width on phase 4's weights: "
        f"chunks of {', '.join(map(str, CHUNK_WIDTHS))} against "
        f"{engine.chunk_tokens}, greedy LOP, prefix cache on [{smi}]")
    widths = chunk_width_phase(torch, np, engine, reqs, smi)

    phase_s["4n"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 6. the tile autotuner at full width on phase 4's weights ----
    log(f"[autotune] bitnet-3b full width on phase 4's weights: "
        f"{TUNE_REQUESTS} requests served with a shape log, the logged and "
        f"default shapes swept (at most {TUNE_CANDIDATES} candidates a "
        f"shape, each bitwise the default), the requests served again "
        f"with the swept table [{smi}]")
    tune = autotune_phase(torch, np, engine, reqs, smi)

    phase_s["6"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 7. the head-level schedule at bitnet-3b's attention width ----
    log(f"[schedule] materialized vs streamed multi-head attention, x [1, "
        f"{SCHED_SEQ}, 3200], 32 heads of 100, causal, groups "
        f"{', '.join(map(str, SCHED_GROUPS))} (rtol=atol="
        f"{SCHED_TOL['rtol']}) [{smi}]")
    schedule_phase(torch, np, smi)

    phase_s["7"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 8. the dry-run on the card's terms: (a) cells traced on the
    #      host, (b) one decode step of phase 4's engine predicted and run
    #      ((c), the training step, runs in phase 4k) ----
    log(f"[dryrun] the meta-device dry-run (launch/dryrun.py): (a) "
        f"{len(DRYRUN_CELLS)} cells at full width on pod16x16; (b) one "
        f"decode step of phase 4's bitnet-3b ({N_SLOTS} slots), LOP and "
        f"no-LOP, predicted on meta and run eagerly: launches and argument "
        f"bytes equal, peak within {DRYRUN_PEAK_TOL:.0%} [{smi}]")
    dryrun = dryrun_phase(torch, engine, smi, dryrun_host)

    phase_s["8"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4b. no-LOP serve ----
    log(f"[serve no-LOP] the same {N_REQUESTS} requests on a use_lop=False "
        f"engine sharing the weights [{smi}]")
    nolop = nolop_phase(torch, np, engine, reqs, smi)
    log(f"  decode step (B={N_SLOTS}, no prefill in flight), CUDA graph "
        f"(eager): LOP {serve['decode_step_ms_p50']:.2f} "
        f"({serve['eager_decode_step_ms_p50']:.2f}) ms, no-LOP "
        f"{nolop['decode_step_ms_p50']:.2f} "
        f"({nolop['eager_decode_step_ms_p50']:.2f}) ms [{smi}]")

    phase_s["4b"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4c. sampled serve and faults (4c, 4d and 4g's chaos trace on
    #      phase 4's weights cut to HALF_LAYERS layers) ----
    half, half_dense = half_engines(engine)
    log(f"[serve sampled + faults] bitnet-3b full width at {HALF_LAYERS} of "
        f"26 layers, phase 4's weights [{smi}]")
    sampled = sampled_fault_phase(torch, np, half, half_dense, reqs, smi)
    log(f"  decode step (B={N_SLOTS}, no prefill in flight), LOP, CUDA "
        f"graph (eager): greedy {serve['decode_step_ms_p50']:.2f} "
        f"({serve['eager_decode_step_ms_p50']:.2f}) ms at 26 layers, "
        f"sampled {sampled['sampled_decode_step_ms_p50']:.2f} "
        f"({sampled['sampled_eager_decode_step_ms_p50']:.2f}) ms at "
        f"{HALF_LAYERS} [{smi}]")
    launches = dict(serve["counts"])
    launches[DENSE] = nolop["counts"][DENSE] + sampled["dense_launches"]
    # phase 4n's serve runs at each chunk width, phase 6's two serve runs
    for counts in (*(run["counts"] for run in widths.values()),
                   tune["counts"], tune["tuned_counts"]):
        for kname in LOP_PATH:
            launches[kname] += counts[kname]

    phase_s["4c"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4d. prefix caching and speculative decoding ----
    log(f"[serve prefix + speculative] bitnet-3b at {HALF_LAYERS} of 26 "
        f"layers: prefix traffic ({N_REQUESTS} "
        f"requests: a shared {SHARED_PREFIX}-token prefix + {MIN_SUFFIX}-"
        f"{MAX_SUFFIX} unique tokens, greedy, LOP), then speculative traffic"
        f" (γ {GAMMA}, draft {half.draft_layers} of {half.cfg.n_layers}"
        f" layers at k_keep {half.draft_k}) [{smi}]")
    prefix_phase(torch, np, half, smi)
    spec = spec_phase(torch, np, half, half_dense, reqs, smi)

    phase_s["4d"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4g. the HTTP front-end, /metrics, and the chaos trace ----
    t4g = time.monotonic()
    log(f"[serve http + chaos] the port's HTTP server on phase 4's engine "
        f"({N_REQUESTS} concurrent SSE streams against the direct run, "
        f"errors, /metrics), then the 200-request chaos trace twice on the "
        f"no-LOP engine at {HALF_LAYERS} of 26 layers (shared prefix "
        f"{CHAOS_SHARED} tokens) [{smi}]")
    http_phase(torch, np, engine, reqs, serve, spec, smi)
    chaos_phase(torch, np, half_dense, smi)
    del half, half_dense
    log(f"  phase 4g took {time.monotonic() - t4g:.1f} s")

    phase_s["4g"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4e. the MoE family: granite-moe-1b-a400m ----
    log(f"[serve moe] granite-moe-1b-a400m full width ({MOE_LAYERS} of 24 "
        f"layers, d 1024, "
        f"32 experts top-8, d_ff 512), {N_SLOTS} slots, {N_REQUESTS} "
        f"requests, gen {GEN}: greedy LOP, no-LOP, sampled [{smi}]")
    moe = moe_phase(torch, np, smi)
    # the serving format fuses the experts into #2, as in the reference:
    # #1's expert form runs in phase 3 only, so its count here is 0
    launches.update(moe["launches"])

    phase_s["4e"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4h. the dense family's LayerNorm and QKV bias; the encdec
    #      family (whisper) ----
    log(f"[serve families] stablelm-1.6b (LayerNorm) full width at "
        f"{STABLELM_LAYERS} of 24 layers, "
        f"qwen1.5-32b (QKV bias) full width at {QWEN_LAYERS} of 64 layers, "
        f"whisper-small (encoder-decoder) full width and depth; {N_SLOTS} "
        f"slots, {N_REQUESTS} requests, gen {GEN} [{smi}]")
    fam = families_phase(torch, np, smi)

    phase_s["4h"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4i. the recurrent families: rwkv6 (ssm) and jamba (hybrid) ----
    log(f"[serve recurrent] rwkv6-1.6b (ssm) full width (d 2048), "
        f"{RWKV_SERVE_LAYERS} of 24 layers (full depth in 4l (d)), phase "
        f"4's {N_REQUESTS} requests greedy and "
        f"sampled; jamba-1.5-large-398b reduced (hybrid: Mamba + attention "
        f"+ MoE), {JAMBA_REQUESTS} requests of {JAMBA_MIN_PROMPT}-"
        f"{JAMBA_MAX_PROMPT} tokens, LOP, no-LOP, sampled; {N_SLOTS} slots; "
        f"then a full-width jamba Mamba and attention sublayer [{smi}]")
    rec = recurrent_phase(torch, np, smi)

    phase_s["4i"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4j. the streamed draw; llava-next-34b (vlm) at full width
    #      (served at VLM_SERVE_LAYERS of 60 layers) and mistral-nemo-12b
    #      at full width (MISTRAL_LAYERS of 40 layers) ----
    log(f"[serve vlm + streamed draw] bitnet-3b drawn whole and one layer at "
        f"a time (bitwise); llava-next-34b (vlm) full width, drawn at full "
        f"depth, served at {VLM_SERVE_LAYERS} of 60 layers, "
        f"{N_REQUESTS} image requests of 2880 patch rows and "
        f"{VLM_MIN_TEXT}-{VLM_MAX_TEXT} text tokens, LOP, no-LOP, sampled "
        f"with a NaN lane, prefix store, speculation; mistral-nemo-12b full "
        f"width at {MISTRAL_LAYERS} of 40 layers, phase 4's {N_REQUESTS} "
        f"requests; {N_SLOTS} slots "
        f"[{smi}]")
    vlm4j = vlm_phase(torch, np, smi)

    phase_s["4j"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 5. standalone kernels and the per-head LOP decode ----
    log(f"[standalone kernels + per-head LOP decode] full width (d 3200, "
        f"32 heads of 100, ffn 8640, capacity 1664, lop_block 128, k_keep "
        f"2); integers bitwise, f32 at rtol=atol={TOL_STANDALONE['rtol']} "
        f"[{smi}]")
    standalone = standalone_phase(torch, np, engine, smi)
    for kname, row in standalone.items():
        launches[kname] = row["launches"]
    rows.update(standalone)
    # phase 4i's serve runs: #1 on rwkv6 and jamba, #2 dense and expert,
    # #3 and the decode kernels on jamba
    for kname, n in rec["launches"].items():
        launches[kname] += n
    # phase 4j's serve runs: llava (#1–#5) and mistral-nemo (#1–#4)
    for kname, n in vlm4j["launches"].items():
        launches[kname] += n

    # ---- 4f. sequence-parallel decode over 2 gloo ranks (last, with the
    #      earlier phases' engines freed: each rank draws full-width
    #      weights) ----
    del engine, nolop, sampled
    free_cuda(torch)

    phase_s["5"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4o. mixtral-8x22b at full width and depth (the earlier phases'
    #      engines freed: its served tree is 34 GiB) ----
    log(f"[serve mixtral] mixtral-8x22b full width and depth (56 layers, d "
        f"6144, 48 heads of 128 over 8, 8 experts top-2 of f 16,384, "
        f"swa_window 4096), drawn a layer at a time; {MIXTRAL_SHORT} "
        f"requests of {MIN_PROMPT}-{MAX_PROMPT} tokens and "
        f"{len(MIXTRAL_LONG)} past the window "
        f"({', '.join(map(str, MIXTRAL_LONG))}), gen {GEN}, {N_SLOTS} "
        f"slots: greedy LOP, then the long requests no-LOP [{smi}]")
    mix = mixtral_phase(torch, np, smi)
    for kname, n in mix["launches"].items():
        launches[kname] += n
    kernel_rows(rows, mix["rows"])

    phase_s["4o"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4p. qwen1.5-110b at full width and depth (mixtral's tree freed:
    #      its served tree is 35 GiB) ----
    log(f"[serve qwen1.5-110b] full width and depth (80 layers, d 8192, 64 "
        f"heads of 128 over 8: G 8, f 49,152, vocab 152,064, QKV bias drawn "
        f"nonzero), drawn a layer at a time; {QWEN110_REQUESTS} requests of "
        f"{MIN_PROMPT}-{MAX_PROMPT} tokens, gen {GEN}, {N_SLOTS} slots, "
        f"greedy LOP, then the {QWEN110_NOLOP} shortest no-LOP; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before "
        f"it [{smi}]")
    q110 = qwen110b_phase(torch, np, smi)
    for kname, n in q110["launches"].items():
        launches[kname] += n
    kernel_rows(rows, q110["rows"])

    phase_s["4p"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 9. the port's examples on the card ----
    log(f"[examples] examples/torch_quickstart.py and torch_serve_lop.py at "
        f"their defaults, torch_train_bitnet.py {EXAMPLE_STEPS} steps (a "
        f"checkpoint every {EXAMPLE_CKPT_EVERY}, preempted after "
        f"{EXAMPLE_PREEMPT}, resumed), in this process [{smi}]")
    ex = examples_phase(torch, np, smi)
    for kname, n in ex["launches"].items():
        launches[kname] += n

    phase_s["9"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4k. the QAT training path: bitnet-3b trained at full width and
    #      depth, the reduced loop, then the trained masters served ----
    log(f"[train] bitnet-3b full width and depth, {TRAIN_STEPS} steps of "
        f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; reduced bitnet {RED_STEPS} "
        f"steps, card vs CPU, resume at step {RED_RESUME}; the trained "
        f"masters quantized and served ({TRAIN_REQUESTS} requests) [{smi}]")
    train = train_phase(torch, np, smi)
    log(f"  phase 8 (c), the dry-run's training step inside 4k: predicted "
        f"peak {train['dryrun']['rel']:+.2%} off the card's, traced in "
        f"{train['dryrun']['seconds']:.1f} s [{smi}]")
    for kname, n in train["launches"].items():
        launches[kname] += n
    rows["fused_qlinear"].setdefault("shapes", {}).update(
        {f"trained bitnet-3b {k}": v
         for k, v in train["serve"]["rows"].items()})
    rows["fused_ffn"].setdefault("shapes", {}).update(
        {f"trained bitnet-3b {k}": v
         for k, v in train["serve"]["ffn_rows"].items()})
    phase_s["4k"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4l. training of the recurrent families: rwkv6-1.6b trained at
    #      full width and depth, then served; reduced rwkv6 and jamba card
    #      vs CPU; a full-width jamba Mamba sublayer trained ----
    log(f"[train recurrent] rwkv6-1.6b full width and depth, "
        f"{REC_TRAIN_STEPS} steps of batch {TRAIN_BATCH} x seq "
        f"{REC_TRAIN_SEQ}, then quantized and served ({TRAIN_REQUESTS} "
        f"requests); reduced rwkv6 and jamba card vs CPU and "
        f"{REC_RED_STEPS} steps; a full-width jamba Mamba sublayer trained "
        f"[{smi}]")
    rtrain = rec_train_phase(torch, np, smi)
    for kname, n in rtrain["launches"].items():
        launches[kname] += n
    rows["fused_qlinear"].setdefault("shapes", {}).update(
        {f"trained rwkv6-1.6b {k}": v
         for k, v in rtrain["serve"]["rows"].items()})
    phase_s["4l"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    log(f"[serve sp] bitnet-3b full width, sequence-parallel decode over "
        f"{SP_RANKS} gloo ranks on cuda:0 (kernels built above), with and "
        f"without f-axis TP of the FFN, and dense; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before "
        f"it [{smi}]")
    sp = sp_phase(torch, np, smi)
    phase_s["4f"] = time.monotonic() - t_phase
    t_phase = time.monotonic()

    # ---- 4m. the distributed modules over gloo ranks on cuda:0 ----
    free_cuda(torch)
    log(f"[distributed] gloo ranks on cuda:0, one spawn of {SHARED_RANKS} "
        f"ranks for (a) EP MoE (granite-moe-1b-a400m's layer, (data, model) "
        f"{EP_MESH}), (b) ring_reduce_matmul and allgather_matmul "
        f"({CM_RANKS} ranks), (c) the sharded training step (stablelm-1.6b "
        f"full width, {FSDP_LAYERS} layers, {FSDP_MESH}), (e) SP decode "
        f"of jamba reduced and rwkv6 ({RWKV_SERVE_LAYERS} layers) over "
        f"{SPR_RANKS} ranks and (f) the int8 gradient compression over "
        f"{DP_RANKS}; then a fresh spawn for (d), (c)'s elastic "
        f"restart on {ELASTIC_SURVIVORS} survivors [{smi}]")
    dist_stats = distributed_phase(torch, np, smi)
    phase_s["4m"] = time.monotonic() - t_phase
    mode_launches = {
        "fused_decode_attention": {
            "per_head": launches["fused_decode_attention"],
            "shared_select": moe["shared_launches"],
            "pos_offset+return_stats": sp["lop"] + dist_stats["lop"]},
        DENSE: {"per_head": launches[DENSE],
                "pos_offset+return_stats": sp["dense"]
                + dist_stats["dense"]}}
    # phase 4h's modes: #1 with the QKV bias (qwen), #2 ungated, #3
    # non-causal and #4/#5 over the cross pages (whisper), each with its
    # launches on the path that runs it and phase 4h's check and times
    for kname, by_mode in fam["modes"].items():
        mode_launches.setdefault(kname, {}).update(by_mode)
    mode_launches["fused_qlinear"]["bias"] += q110["bias"]
    for kname, by_mode in fam["rows"].items():
        rows[kname].setdefault("modes", {}).update(by_mode)
        rows[kname]["max_abs_err"] = max(
            rows[kname]["max_abs_err"],
            *(r["max_abs_err"] for r in by_mode.values()))
    # phase 4j's shapes: #3 at llava's image-prefixed first chunk and a
    # text chunk past it, #4/#5 at G 7 on llava's pages, #1 at
    # mistral-nemo's O projection; phase 4i's: #2 with E 16 at full-width
    # jamba's
    kernel_rows(rows, vlm4j["rows"])
    kernel_rows(rows, {"fused_ffn_experts": rec["jamba_width"]["expert_rows"]})

    sources = {"fused_qlinear": ("qlinear.cu", "src/repro/kernels/qlinear.py:224"),
               "fused_ffn": ("qlinear.cu", "src/repro/kernels/qlinear.py:368"),
               "fused_qlinear_experts": (
                   "qlinear.cu", "src/repro/kernels/qlinear.py:224"),
               "fused_ffn_experts": (
                   "qlinear.cu", "src/repro/kernels/qlinear.py:368"),
               "fused_prefill_attention": (
                   "prefill_attention.cu",
                   "src/repro/kernels/prefill_attention.py:217"),
               "fused_decode_attention": (
                   "decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:422"),
               DENSE: ("decode_attention.cu",
                       "src/repro/kernels/decode_attention.py:380"),
               "ternary_matmul": (
                   "ternary_matmul.cu",
                   "src/repro/kernels/ternary_matmul.py:77"),
               "lop_scores_kernel": (
                   "lop_scores.cu", "src/repro/kernels/lop_scores.py:71"),
               "int8_flash_prefill": (
                   "int8_attention.cu",
                   "src/repro/kernels/int8_attention.py:122"),
               "sparse_decode_attention": (
                   "int8_attention.cu",
                   "src/repro/kernels/int8_attention.py:237")}
    kernels = []
    for kname, row in rows.items():
        src, replaces = sources[kname]
        entry = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]}
        if "shapes" in row:
            entry["shapes"] = row["shapes"]
        if kname in mode_launches:
            # each mode the entry ran: its launches on the path that runs
            # it (phase 4, 4e's shared arm, 4f's rank 0, 4h's arms) and its
            # check and times (phase 3, or 4h at the new shapes)
            entry["modes"] = {
                mode: dict(row.get("modes", {}).get(mode, {}), launches=n)
                for mode, n in mode_launches[kname].items()}
            for mode, r in row.get("modes", {}).items():
                entry["modes"].setdefault(mode, dict(r))
        kernels.append(entry)
    log("[phases] seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in phase_s.items())
        + f" [{smi}]")
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-host"]:
        sys.exit(dryrun_host_child(sys.argv[2]))
    sys.exit(main())
