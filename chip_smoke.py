"""Smoke test of paddle_tpu_torch on one NVIDIA GPU (H100 / H200).

    python3 chip_smoke.py            # every phase; needs one card
    python3 chip_smoke.py --quick    # card, build, and the kernel checks only
    python3 chip_smoke.py --int8-stress   # card, build, phase int8_stress
    python3 chip_smoke.py --training      # card, build, k3w, llama_step,
                                          # train_llama, train_mistral
    python3 chip_smoke.py --bwd-times     # card, build, bwd_times
    python3 chip_smoke.py --dropout       # card, build, dropout, k1d,
                                          # train_dropout
    python3 chip_smoke.py --k1d           # card, build, dropout, k1d
    python3 chip_smoke.py --moe           # card, build, k6, moe,
                                          # train_moe
    python3 chip_smoke.py --unet          # card, build, k1h, k3h, unet,
                                          # train_unet
    python3 chip_smoke.py --ernie         # card, build, k1m, ernie
    python3 chip_smoke.py --modes         # card, build, k1s,
                                          # train_mistral_pad
    python3 chip_smoke.py --k1s           # card, build, k1s
    python3 chip_smoke.py --k1m           # card, build, k1m

Phases, each printing one JSON line:
  1. card   — nvidia-smi name and power limit, memory rate and bf16 peak.
  2. build  — nvcc builds paddle_tpu_torch/csrc/*.cu (sm_90a) at first use.
  2a. keep_words_sass — kernel W's instruction mix a hashed key, from
              cuobjdump of the built library (its innermost hashing loop):
              the INT32 pipe's share that the hashing rows' int32_bound_ms
              reads, and the FMA pipe's share (IMAD).
  3. k1     — flash-attention forward kernel vs its plain fp32 version at the
              prefill shape, a GQA shape, a ragged shape and sq=1 decode,
              and the edges of its 128-row query tile and 128-key TMA ring
              (sq 1, 65, 127, 129, 200; sk off the tile; an offset inside a
              key tile; GQA 4 and 8; a batch row of kv_len 0, whose rows
              must give 0 and lse NEG_INF exactly; d 64 and 128); and
              train_llama's call (b 4, S 2048, 32 heads over 4, d 64).
  3a. k1w   — K1's causal sliding window vs its plain fp32 version at the
              kernel's edges: windows 1, 64, 127, 128, 129, 200 and 4096
              over 384 query rows at offset 700 (the first block's t0
              inside a key tile, query tiles straddling the window's lower
              edge and the diagonal, rows with no key in the first loaded
              tile), GQA 4 and 8, d 64 and 128, a batch row whose kv_len
              ends below the window, sq = 1 decode with kv_lens at
              Mistral-7B's decode shape; every case launched twice with the
              same bits, and a window at or above the visible span gives
              the windowless kernel's bits; then a tiny windowed Llama's
              `generate` on the card against the CPU (the layered path:
              K1 with the window once a layer a step, nothing else).
  4. k2     — fused decode-step kernel vs its plain version at Llama-2-7B
              width with 2 layers, MHA and GQA (nkv=8): x_out and the
              appended cache row; then at 1, 9, 16, 33, 64 and 65 rows (the
              product engine's wgmma widths N = 8 … 64, and two launches of
              33 + 32 rows, on inputs from a generator of their own), two
              launches bitwise equal; then at the split-KV attention's
              chunk edges (EDGE_POS: positions 0, 1, 511, 512, 513, 1023,
              1024, 1500 of a 1501-row cache; b=2, MHA), two launches
              bitwise equal.
  5. k3     — flash-attention backward kernels (K3 dq, K4 dk/dv) through
              the autograd Function vs the plain fp32 backward on the same
              forward's (out, lse): the GPT-2 training shape, a GQA d=128
              shape, a ragged causal shape, a non-causal one, one with a
              fully-masked batch row, K4's tile edges (sq 1, 65, 127, 129,
              200; sk off the 128-key block; an offset; GQA 4 and 8; d 64
              and 128) and K3's (sq 64, where the second consumer group has
              no rows, and 193; sk 65; an offset inside a 64-key tile; GQA
              8 at d 128) and train_llama's call (b 4, S 2048, 32 heads
              over 4, d 64); K3 and K4 each launched twice on each case's
              inputs must give the same bits.
  5a. k3w   — K3's and K4's causal sliding window (their windowed
              instantiations, on K1's windowed forward) vs the plain fp32
              backward with the window: windows 1, 63, 64, 65, 127, 128,
              129, 200, 512 and 4096 over 384 query rows at offset 700
              (inside a 64-key tile), GQA 4 and 8, d 64 and 128, a batch
              row of kv_len 0 (zero gradients) and one ending early, sq 64,
              bottom-right self-attention, windows at and above the visible
              span (the windowless kernels' bits); every case launched
              twice with the same bits; then train_mistral's attention
              shape (b 1, S 8192, 32 heads over 8, d 128, window 4096):
              K1's out and lse, then K3's and K4's gradients, held one
              kv-head group at a time, and K3 and K4 timed there beside
              their bounds, the windowless kernels, the plain backward and
              torch sdpa's forward plus backward over the dense window
              mask (rows 2a and 3a).
  6. k5     — paged decode-step kernel vs its plain version at Llama-2-7B
              width with 2 layers, b=8 over a shuffled block table (BT 128,
              16 blocks per row): rows at mixed positions with one idle row,
              MHA and GQA (nkv=8); then x_out and the appended rows bitwise
              against K2 with every row at one position over the same KV,
              in the llama mode and (GPT-2 345M width) in the gpt mode;
              then at 1, 9, 16, 33, 64 and 65 rows (drawn positions, the
              last row idle) and bitwise against K2 at 33 and 65 rows, both
              modes; then one row at each chunk edge over blocks of 128,
              16 and 12 tokens (12: the cp.async path), two launches
              bitwise equal, and K5 = K2 bitwise at each edge, both modes;
              then the int8 modes (int8 weights × an int8 pool with
              per-row scales, int8 weights over a bf16 pool, bf16 weights
              over an int8 pool) at 8 rows (one idle), 65 rows (two row
              groups) and one row at each chunk edge over blocks of 128 and
              12 tokens (the int8 pool's edges over one layer), appended
              int8 rows within one int8 step, two launches bitwise equal;
              and the int8 pool's pin: with every row's scales K2's layer
              scales, K5 gives K2-int8-KV's bits (8 and 65 rows, each edge).
  7. k7     — paged verify kernel (K7) vs its plain version at Llama-2-7B
              width with 2 layers, b=8, a 5-token tail per row, over a
              shuffled table (BT 128, 16 blocks per row), MHA and GQA:
              mixed positions, a tail straddling a block boundary, an idle
              row, a tail past its last mapped block and one past the
              table; x_out of mapped tokens, the appended rows, the rest of
              the pool unchanged; then 16 slots at drawn positions (80 tail
              rows: two launches of 8 slots); then 4 slots with tails of 64
              tokens (a launch a slot) and 100 (two chunks of 50 in turn,
              the second over the first's appends), a tail from position 3
              over one layer and over two held to the fp32 plain verify (K7
              no further from it than the bf16 plain verify + K2's atol);
              every case launched twice, bitwise equal; then an all-accepted
              K7 step against 5
              sequential K5 steps on a copy of the pool, per token; then
              K7's three int8 modes over the edge rows and tails at the
              chunk edges (the int8 pool's over one layer; its two-layer
              edge rows reported against the fp32 plain verify) and 16
              slots.
  8. k6     — MoE decode-step kernel (K6) vs its plain version, 2 layers,
              b=1 and b=4, pos 1056, S 1152, at DeepSeekMoE-16B width (MHA,
              64 experts of 1408, top-6, shared 2816) and Mixtral-8x7B width
              (h 4096, GQA 32/8, 8 experts of 14336, top-2): routing ids
              first, then x_out and the appended rows of the rows routed as
              the plain version routes them (a swap is allowed only at a
              near-tie at the top-k boundary, K6_FLIP_GAP), the rest of the
              cache unchanged, two launches bitwise equal, every row routed
              alike (one expert slot serves all 4 rows), and the gate ×8
              held strictly; then b=9 and b=16 (two launches of rows); at
              DeepSeekMoE-16B width also b=2 at each chunk edge (S 1501);
              then K6's int8 KV mode at both widths, b=1, 4 and 9 (two
              launches of rows), over an int8 cache with its lane scales
              (quantize_kv_cache): against the int8 plain version on the
              same cache, routing first (the swap rule), x_out at K2's
              tolerance, the appended int8 rows within one int8 step, the
              rest of the cache unchanged, two launches bitwise equal.
  8e. wide  — steps wider than one launch through the entry points, tiny
              models at head width 64 against the same weights on the CPU:
              Llama `generate` at b=65 (K2 in 33 + 32 rows) and a 65-slot
              ServingEngine (K5 in two launches a tick); a Mixtral with
              capacity_factor 4 (the fused plan's max_batch 64) `generate`
              at b=9 and 16 (K6 in groups of 8 rows); tokens equal the
              CPU's or part only at a near tie (NEAR_TIE), each `generate`
              run twice on the card with equal tokens.
  8a. k2g, k5g, k7g — the gpt modes of K2, K5 and K7 (LayerNorm with bias,
              biased products, no rope, tanh-GELU FFN) vs their plain
              versions at GPT-2 345M width (h 1024, 16 heads of 64, ffn
              4096), 2 layers, random bf16 weights and biases: k2's case
              (b=4, S 1152, pos 1056), k5's rows (b=8, shuffled table,
              mixed positions, an idle row) and k7's edge cases (b=8 × a
              5-token tail); x_out, the appended rows, the rest of the
              cache or pool unchanged, two launches bitwise equal; k2g and
              k5g also at 1, 9, 16, 33 and 64 rows, k5g with one row at
              each chunk edge; k5g and k7g then the int8 pool as phases k5
              and k7 run it.
  8b. k2q   — K2's int8 modes vs their plain versions, 2 layers, b=4, S 1152,
              pos 1056: Llama-2-7B width with int8 weights (per-out-channel
              scales), with an int8 KV cache (per-(layer, kv head) scales),
              with both (MHA and GQA nkv=8), and GPT-2 345M width with an
              int8 KV cache; x_out at K2's tolerance, the appended int8 rows
              within one int8 step (lanes one step apart counted), the rest
              of the cache unchanged, two launches bitwise equal; then
              int8 weights at 1, 9, 16, 33 and 64 rows (bf16, int8 KV);
              then the int8 cache at each chunk edge (llama and gpt, one
              layer, b=2, S 1501).
  8f. int8_stress — the product engine's int8 path repeated: K2, K5 and
              K7 with the int8 weights of a quantized Llama-2-7B (32
              layers, GQA 8) over int8 caches and pools, K2 at b = 8, 16
              and 64, K5 at 8 and 64 rows, K7 at 2 and 8 rows × 5 tokens
              (the engine's N of 8 … 64, rings of 8, 7 and 4 stages), 501
              launches each: every x_out bitwise equal to the first, and a
              launch not done within 30 s reported as a stall (the process
              then ends); each step timed by CUDA events.
  8c. k8    — RMSNorm rows (K8) vs the plain rms_norm at the Llama-2-7B
              prefill shape (4·1024, 4096) bf16, with and without the
              weight (the one-pass kernel), a (1024, 8192) bf16 case (the
              two-pass kernel, above the one-pass width) and an fp32 case;
              timed beside its byte bound, the plain version and
              torch.nn.functional.rms_norm, by CUDA events and by the
              kernels' device time (device_ms: CUDA events over calls
              queued behind a sleep kernel).
  8d. k9    — the shared-memory probe (K9): it equals the device's opt-in
              shared memory per block, a launch one step above is refused,
              and every dynamic shared-memory request of the kernels at the
              smoke's shapes (the split-KV attention's at head_dim 64 and
              128 over bf16 and int8 caches, the product engine's at each
              N, bf16 and int8 weights, among them) fits it.
  8g. dropout — the hidden-dropout kernel (csrc/dropout.cu) against its
              plain version bit for bit: GPT-2 345M's (8, 1024, 1024) bf16
              activations, an fp32 case, p 0.1, 0.5 and 1, dividing
              by keep or not; the kept share within 5σ of 0.9, two launches
              with one key bitwise equal, another key another mask; timed
              beside its bound (the larger of its bytes and the hash's 69
              integer instructions an element over the issue ceiling: SMs
              × 128 × the maximum SM clock), the plain version and
              torch.nn.functional.dropout.
  8h. k1d   — K1, K3 and K4's dropout modes. Exact mask probes: with q = 0
              every visible probability is 1/n, and V the identity over a
              key tile makes K1's output the dropped probabilities, so
              out·keep·n rounds to the keep bit — every tile in turn at
              GPT-2's training shape (b 8, h 16, s 1024, d 64), causal and
              not, and at d 128 with GQA 16/4 and kv_lens; K4's dv with dO
              the identity over a query tile likewise; K3's dq with K the
              identity over a key tile, V and dO the first unit vector and
              Δ = 0 (dq = scale·Z/(keep·s)); each bit for bit against the
              port's torch threefry on the card. The kept share
              of the training shape's 134 M draws within 5σ of 0.9. Cases
              (training shape; d 128, GQA, kv_lens; non-causal; the window;
              a causal offset with a kv_len-0 row): out, dq, dk, dv against
              the plain versions with the same key (K1/K3 tolerances), lse
              bit for bit the dropout-free kernel's, two launches bitwise
              equal, another key another output. Times at the training
              shape with and without dropout beside the bounds (bytes,
              tensor FLOPs, the hash's integer operations), the plain
              versions and torch sdpa with dropout_p 0.1 (its own mask).
              Kernel W (the keep words K1, K3 and K4 read, once a call):
              bit for bit against its plain twin over the cases' limits
              (the training shape; kv_lens; non-causal ragged; the window
              and an offset; every key, as the general mode hashes), two
              launches equal; a bool-mask case with dropout (the general
              mode on every key's words); K3 and K4 given the forward's
              words equal to K3 and K4 making their own. K1's row times the
              whole forward (W and K1, as a call without words runs them),
              K3's and K4's rows K3 and K4 on the given words; W timed
              beside its bound, its INT32-pipe figure (SHF, LOP3 and IADD3
              a hash, counted in its SASS, over 64 lanes a clock an SM) and
              its plain twin; no PyTorch call packs a keep mask.
  8i. k1h   — K1 at head dim 256 and the dispatch's padded head dims: every
              attention call of the SD-1.5 UNet at b 2, 8 heads, 64×64
              latents (self-attention over 4096, 1024, 256 and 64 tokens
              at head dims 40, 80, 160, 160, and cross-attention to 77
              tokens) through scaled_dot_product_attention (the pad to 64,
              128, 256, K1, the slice) against the plain version at the
              unpadded d, out within K1_TOL_OUT, K1H_TOL_OF_MAX of
              max|plain| and K1H_REL_L2; one K1 launch each at the padded
              d, and K1 on the padded inputs held there (out, lse within
              K1's tolerances, the padded columns exactly 0); timed there
              beside the bounds at the padded and at the model's d, the
              whole dispatch, the plain version and torch sdpa at the
              unpadded d; then native
              d 256 against the plain version (out and lse): causal with an
              offset and a batch row of kv_len 0, GQA 4, sq 1, sq 127 and
              129, non-causal sk 77 and 333 without kv_lens (keys past sk
              are TMA zero fill and must be masked), a 64-key tile edge;
              two launches of one d 256 call bitwise equal; the window and
              dropout at d 256 refused, naming ROADMAP Queue B row 1.
  8j. k3h   — K3 and K4 at head dim 256 (K3: 32-key tiles under 128-row
              blocks; K4: 64-key blocks, the consumer groups splitting
              dk/dv's columns) through the autograd Function against the
              plain fp32 backward on K1's (out, lse), each gradient within
              K3_TOL · max|plain|, K3 and K4 each launched twice with the
              same bits: the UNet's shapes at native d 256 (b 2, 8 heads,
              non-causal: 256², 256 × 77, 64², 64 × 77) and d 256's edges
              (sq 1, 64 over sk 65, 65, 129, 193; ragged sk 77 and 1000; a
              causal offset inside a tile; GQA 4 and 8; a batch row of
              kv_len 0, zero gradients); then SD-1.5's head dim 160 at the
              UNet's shapes through the dispatch (the pad, K1, K3, K4 at
              256 once each, the slice's backward) against the plain
              backward at d 160, and K3's and K4's device time there beside
              the bounds at the padded and the model's d, the plain
              backward and torch sdpa's backward at d 160 (rows 2c, 3c);
              the window and dropout at d 256 refused, naming Queue B rows
              2-3.
  8k. k1m   — K1, K3 and K4's dense-mask modes (bool or fp32, read through
              broadcast strides; tiles of `mask_bounds`) against their
              plain versions on the same inputs (K3/K4's on K1's (out,
              (m, log l) pairs)): ERNIE-base and Titan key padding
              ((b, 1, 1, s) bool, lengths s/8..s from a seed; b 32, h 12,
              s 512, d 64 and b 8, h 96, d 128), TinyLlama's causal +
              padding (b 4, 32/4 heads, s 2048, d 64), a (b, h, s, s) fp32
              mask of -1e4 soft entries, rows of -1e10 and -inf tiles, a
              2-D block-sparse bool mask with a row hidden at every key (its
              block walks every tile: the mean of v), a 3-D (h, s, s) mask
              under GQA and causal, cross-attention 512 × 77 with a key
              mask, and ERNIE-base's shape with two batch rows of
              length 0 (whole blocks of dead rows) and with dead query rows
              beside live ones ((b, 1, s, s) bool), PaddleNLP's additive
              0 / -1e4 padding mask, float dead rows at -1e30 (their blocks
              on the walk of every tile), a ragged sk (300 × 333, d 128,
              causal), dead query rows inside FULL tiles beside live ones
              ((b, 1, s, s) bool, s 640, d 128, GQA, causal: K3's
              log2 l = +inf rows) and ERNIE-base's whole dead blocks
              under dropout 0.1 (off K3's walk, on K1's and K4's; the
              keep mask the plain versions draw, out within K1_TOL_OUT +
              K1S_OUT_RTOL·|plain|): out within K1_TOL_OUT, the pairs'
              lse within K1_TOL_LSE (+ 2^-22·|m|), each gradient within
              K3_TOL · max|plain|, each kernel twice with the same bits, and
              `mask_bounds` free of host syncs; each case timed (device_ms)
              beside torch sdpa with the same mask (forward; backward over
              a retained graph), the plain versions and the bound from
              the bytes (q, k, v, o, the mask at its broadcast shape) and
              the operations of the pairs the mask leaves (a bool mask's
              dead row the closed form, no pair's work; beside it the
              bound that counts its sk keys at 2 / 0 / 2·d) (rows 1e, 2d,
              3d at the ERNIE-base case); each case prints its tiles by
              class (`tile_counts`: EMPTY, FULL, MIXED in K1's, K3's and
              K4's grids) and dead rows; a float row at -inf gives NaN
              as the plain version; d 40 and 80 through the dispatch
              (padded, K1/K3/K4 once each in mask mode); the mask beside
              the window and dropout running, at d 256 refused, naming
              Queue B rows 1-3.
  8m. k1s   — the rest of flash attention: K1, K3 and K4's general
              instantiations (segment ids, ALiBi, the dense mask beside the
              window, each beside dropout) and flash_fwd_lse, at the
              models' own attention shapes: segment ids (8 packed documents
              a row, lengths from a seed) at Mistral-7B's (b 1, s 8192,
              32/8 heads, d 128) and GPT-2 345M's (b 8, s 1024, 16 heads,
              d 64) causal shape, and non-causal cross-attention (1024 ×
              1536, kv_segment_ids, a row no key matches: 0); ALiBi (slopes
              2^(-8i/h)) alone, with the window (4096; 256 at GPT-2's) and
              with kv_lens at both; the (b, 1, 1, s) bool mask with the
              window at train_mistral_pad's b 2 (row 1 left-padded by
              3,072: its pad queries are dead rows); dropout 0.1 beside the
              mask, the segment ids and ALiBi at GPT-2's; flash_fwd_lse
              under a random g_lse at both; GPT-2's shape with
              batch rows left-padded by GPT2_PAD (dead causal rows beside
              live ones in a block), with and without dropout. Each case
              first through the
              public entry point (nn.functional.flash_attention, or
              flash_fwd_lse), forward and backward, every count at 0 just
              before and read just after (the path's launches); then the
              wrappers twice each, bitwise equal and equal to the entry
              point's bits, against the plain twins one kv-head group at a
              time (K1_TOL_OUT, K1_TOL_LSE on the pairs, K3_TOL · max|plain|
              on each gradient); timed (device_ms) beside the plain twins,
              torch sdpa over the equivalent dense mask and bf16 ALiBi bias,
              and the bound from the bytes and the operations (and the
              hash's integer instructions) of the pairs the run's structure
              leaves (rows 1f–1j, 2e–2i, 3e–3i); the general mode's keep
              mask read back bit for bit (k1_mask_probe, general); every
              new mode at kernel d 256 refused, naming Queue B rows 1-3;
              the dead rows' row sums (csrc/attn_rows.cu: the mean of v and
              dsum) at train_mistral_pad's call against their plain
              version, twice bitwise, timed (row R).
  9. e2e    — Llama-2-7B (32 layers, bf16, random weights from seed 0)
              through inference.generate, b=4, prompt 1024, 64 new tokens,
              greedy and sampled; kernel launch counts read around each
              run; time to first token (generate with one new token) and
              decode ms/step (the rest of the greedy run per step); one
              teacher-forced decode step through the kernel and the plain
              path, logits compared.
 10. timing — K1 (prefill shape) and K2 times beside the bound, the plain
              version and (flash attention) PyTorch's sdpa, with K1's and
              sdpa's TFLOP/s and K1's share of its bound; K2 also over the
              same cache quantized to int8 (its int8-KV mode).
 11. serve  — Llama-2-7B (the e2e phase's model, its plan and cache freed)
              through serving.ServingEngine (max_slots 8, block_tokens 128,
              max_seq_len 2048): 16 greedy requests, prompts of 100–1000
              tokens and 16–96 new tokens from seed 0, eight of them behind a
              shared 256-token prefix (the first of those admitted a tick
              ahead, so its siblings hit its blocks), 14 "low" and then,
              with all 8 slots busy, 2 "high" that preempt and force a
              replay; launch counts read around the run; a teacher-forced
              32-layer step over the live pool, K5 vs the plain paged
              version on the logits; K5 timed at 8 rows averaging ~700
              cached tokens; then a second engine serves 8 sampled requests
              (temperature 0.8, top-k 50, top-p 0.9) with their own seeds.
 11b. serve32 — the same model through ServingEngine at 32 slots (block
              128, max_seq_len 2048, a 34 GB pool): 32 greedy requests
              drawn as serve's 16 are, from seed 32, every slot busy at
              once; launch counts; a teacher-forced 32-row, 32-layer K5
              step vs the plain paged version on the logits; K5 timed at
              32 rows (the K5 row's "b32").
 12. spec   — the same model through ServingEngine(speculate=SpecConfig(k=4))
              (8 slots, block 128): 16 greedy requests from seed 0 with
              32–128 new tokens, 8 of 400–1000-token prompts tiling a
              16–64-token motif and 8 random, 2 "high" that preempt; launch
              counts (K7 once per speculative tick, K5 per plain tick and
              replayed token); K7 timed at 8 rows × 5 tokens averaging ~700
              cached tokens; the same requests through a plain engine (an
              A/B, reported) and where the two engines' tokens part; a
              k=4 engine on the random half with one forced-acceptance
              tick (its proposals are the next 4 greedy tokens of K5 steps
              over a clone of the pool: a multi-token commit, a stop inside
              the accepted run, and a K5 step over K7's appended history
              against one over K5's); then an adaptive engine (k_min 0) on
              the random half with a teacher-forced 32-layer K7 step over
              its live pool vs the plain verify on the logits; then the 16
              requests (new tokens capped at 32) through a 16-slot k = 4
              engine (80 tail rows: two K7 launches a tick, a teacher-forced
              80-row K7 step) beside a plain 16-slot one, tokens equal or
              parted only at a near tie.
 12b. int8  — the same model through quantization.quantize_model (in place:
              int8 weights, per-out-channel scales, embeddings bf16), then
              inference.generate, b=4, prompt 1024, 64 new tokens, greedy and
              sampled, with cache_dtype int8 and bf16: K1 32 and K2 63
              launches per call; TTFT, decode ms/step, tokens/s, peak memory;
              a teacher-forced 32-layer K2 step (int8 weights and KV) vs the
              plain int8 path on the logits and argmax; K2 timed in both
              int8-weight modes at b=4, pos 1056.
 12c. int8_pool — before phase int8 quantizes it, the bf16 Llama-2-7B
              over an int8 pool: the serve mix's unshared half through an
              8-slot engine, plain and speculating k = 4 (rows 6c, 7c):
              launches, full lengths, no leaked block, no tick on a plain
              version; K5 and K7 timed over its pool.
 12d. int8_serve — after phase int8, its quantized model through an
              8-slot engine with an int8 pool (block 128, max_seq_len
              2048) on the serve phase's mix (16 greedy requests, eight
              behind a shared prefix, two preempting, then 8 sampled), the
              checks and timings of phase serve (rows 6a); the same engine
              speculating k = 4 on the spec phase's 16 requests (7a); int8
              weights over a bf16 pool, plain and speculating (6b, 7b);
              tiny engines on the card against the same weights on the
              CPU: a Llama with int8 weights and an int8 pool at 65 slots
              and a GPT with an int8 pool at 8 slots, tokens equal or
              parted at a near tie.
 12a. gpt   — GPT-2 345M (24 layers, bf16, random weights from seed 0 with
              its biases and LayerNorms drawn too; the Llama model freed)
              through inference.generate, b=8, prompt 512, 128 new tokens,
              greedy and sampled, and greedy with an int8 KV cache: K1 24
              and K2 127 launches per call; TTFT, decode ms/step, tokens/s,
              peak memory; a teacher-forced 24-layer step, K2 vs the plain
              path, on the logits; K2 timed at b=8, pos 576, beside its
              bound and the plain version, over the bf16 and the int8 cache.
      gpt_serve — the same model through ServingEngine (8 slots, block
              128, max_seq_len 1024) as phase serve does it, prompts of
              100–800 tokens: K5 once per tick and replayed token, K1 24
              per prefill group; K5 timed at 8 rows over positions
              150 … 1000.
      gpt_spec — the same greedy requests through
              ServingEngine(speculate=SpecConfig(k=4)): K7 once per
              speculative tick, a teacher-forced 24-layer K7 step over the
              live pool, K7 timed at those rows × 5 tokens.
      gpt_int8_pool — the serve mix's unshared half through the engine
              over an int8 pool, plain and speculating (rows 6d, 7d).
 13. moe    — DeepSeekMoE-16B (28 layers, bf16, random weights from seed 0;
              the Llama model freed first) through inference.generate, b=4,
              prompt 1024, 64 new tokens, greedy and sampled: K1 28 and K6
              63 launches per call; TTFT and decode ms/step; a
              teacher-forced 28-layer step, K6 vs the plain path (logits of
              the rows without a routing swap, the swap rule for the rest,
              and every row's logits against the plain path taking K6's
              experts);
              K6 timed at b=4 and b=1 beside its bound (the distinct routed
              experts of that step) and the plain version; then the same
              generate over an int8 KV cache (cache_dtype=int8: a bf16
              prefill calibrates, every decode step on K6's int8 KV mode):
              K1 28, K6 63 per call, all 63 in the int8 mode; TTFT, decode
              ms/step, peak memory, tokens; a teacher-forced int8 step, K6
              vs the int8 plain path (the swap rule, logits, appended rows
              within MOE_INT8_DRIFT; fed one input, each layer's within one
              step) and its agreement with the bf16 step; K6's
              int8 mode timed at b=4 beside its bound (int8 KV bytes).
 13a. train_moe — DeepSeekMoE-16B at full width, 4 layers (the reference's
              deepseek-16b-d4 cross-section; 2.77 B parameters), fused
              dispatch, through the MoE twin's build and train_step
              (paddle_tpu_torch.moe_bench): b 4, S 1024, bf16,
              AdamW(1e-4, multi_precision=False), capacity 480 an expert;
              2 warm-up and 5 counted steps: K1, K3 and K4 4 a step each,
              nothing else, no plain attention call; step ms, tokens/s,
              activated MFU, peak memory, the loss finite and falling, one
              traced step by kernel bucket (moe_bench.step_breakdown). Then
              the twin at its defaults (12 layers, 8 experts, h 1024,
              fused) for its JSON line; then one step (loss and gradients)
              at the twin's shape under scatter, sort and einsum against
              fused, and dropless against fused at capacity factor 4.0
              (nothing drops), within MODE_LOSS_ATOL / MODE_GRAD_RTOL.
 14. train  — GPT-2 345M (24 layers, bf16, random weights from seed 0)
              pretraining through the bench twin's step
              (paddle_tpu_torch.bench): B=8, S=1024, AdamW 1e-4, a warm-up
              pass and a counted, timed pass of 20 steps each; K1, K3 and
              K4 must each launch 24 × 20 times in the counted pass, the
              loss must stay finite and fall.
 15. step   — one train step of a 2-layer GPT at full width (hidden 1024,
              16 heads, vocab 50304, B=1, S=1024): on the card in bf16
              through the kernels, against the same weights on the CPU in
              fp32 through the plain versions; loss and every gradient.
 16. timing_train — K1, K3 and K4 at the training shape beside the bound,
              the plain version and PyTorch's sdpa (forward; backward for
              the K3/K4 pair), with TFLOP/s, the share of the bound, and
              K3 + K4 over sdpa's backward.
 16a. train_dropout — GPT-2 345M as published, GPTConfig.gpt2_medium()
              with hidden and attention dropout 0.1, through the bench
              twin's build and train_step (one "dropout" key a step from
              the global generator), B 8, S 1024, AdamW 1e-4: 3 warm-up and
              10 counted steps; K1, K3 and K4 24 a step each, all in their
              dropout modes, kernel W 24 a step (one a layer's forward), the
              dropout kernel 49 a step forward and 49 backward, nothing
              else, no plain attention, keep-word or dropout call;
              step ms, tokens/s, MFU on phase train's basis, peak memory,
              one traced step by kernel family; the loss finite and
              falling.
 17. mistral — Mistral-7B (32 layers, GQA 32/8, ffn 14336, window 4096;
              bf16, random weights from seed 0) through inference.generate,
              b=2, prompt 8192, 64 new tokens, greedy, on the layered path
              (no fused plan for a window): K1 32 + 63 x 32 launches and
              nothing else, no call of a plain attention; TTFT, decode
              ms/step, tokens/s, peak memory; the last decode step
              teacher-forced: its attention held layer by layer against
              K1's plain version over the cached K/V, its logits against a
              windowed no-cache forward of the same tokens within a fixed
              limit (the same noise read with and without the window on
              the generated tokens and 3 random sequences), and the
              weights without the window giving the same logits below
              position 4096 and others past it; K1's window mode at the
              prefill and decode calls held against its plain version
              (out, lse, two launches bitwise) and timed beside its bound,
              the plain version, the windowless kernel and sdpa over the
              dense window mask (row 1a).
 17a. llama_step — train_llama's model cut to 2 layers at full width
              (b 4, S 2048, core_attn, 4 loss chunks): one loss and
              gradient as train_llama computes them (the recompute saving
              core_attn's names), again without recompute (bit for bit
              the same), and against the same step in fp32 with the
              attention's plain versions in place of K1, K3 and K4 (loss
              and every gradient within phase step's tolerances).
 18. train_llama — TinyLlama-1.1B (train_bench's llama-1b: h 2048, 22
              layers, GQA 32/4, ffn 5632, vocab 32000; bf16, random weights
              from seed 0) through paddle_tpu_torch.train_bench's build and
              train_step at the reference's settings: b 4, S 2048,
              recompute core_attn, 4 loss chunks, AdamW(1e-4,
              multi_precision=False); 2 warm-up and 10 counted, timed
              steps: K1 twice a layer a step (the forward and its replay
              under recompute), K3 and K4 once, no plain attention call, the
              loss finite and falling; step ms, tokens/s, MFU (dense 6N
              and over the visible pairs), peak memory and one traced step
              by kernel family.
 19. train_mistral — Mistral-7B (LlamaConfig.mistral_7b(): 32 layers, h
              4096, ffn 14336, GQA 32/8, window 4096; bf16, random weights
              from seed 0) at b 1, S 8192 (twice the window), recompute
              full, 8 loss chunks, AdamW(1e-4, multi_precision=False): 2
              warm-up and 3 counted steps, every K1, K3 and K4 launch
              windowed (the wrappers' `windowed` counts), nothing else, no
              plain attention; layer 0's attention at this shape (K1's out
              and lse, K3's and K4's gradients) against the plain versions
              one kv-head group at a time; the same measurements as
              train_llama.
 19a. train_mistral_pad — Mistral-7B at full width (32 layers, h 4096,
              32/8 heads, d 128, window 4096) on a padded batch: b 2,
              S 8192, row 1 left-padded by 3,072 tokens (labels there at
              the loss's ignore_index), a (b, 1, 1, S) bool mask,
              train_loss(x, y, attn_mask) under full recompute and 8 loss
              chunks, pure-bf16 AdamW; 1 warm-up and 3 counted steps: K1
              twice a layer a step and K3, K4 once, every one on the
              general instantiations with the mask beside the window, no
              plain attention call, the loss finite and falling; step ms,
              tokens/s over the real tokens, MFU, peak memory; then at 2
              layers the loss and every gradient on the kernels against
              the plain twins on the card (bf16, one kv-head group at a
              time): STEP_LOSS_ATOL, STEP_GRAD_RTOL.
 20. unet   — UNetConfig.sd15() (860 M parameters, bf16, random weights from
              seed 0) through the UNet twin's build, inputs and denoise
              (paddle_tpu_torch.unet_bench): b 2, latents (2, 4, 64, 64),
              context (2, 77, 768), 2 warm-up and 10 counted denoise steps
              with ε fed back: ms/step (CUDA events), images/s, MFU over
              the twin's analytic FLOP count, peak memory; K1 32 launches
              a forward (12 at d 256, 10 at 128, 10 at 64: the wrapper's
              `by_d`), nothing else, no plain attention call; ε finite; one
              traced step by kernel family (convolutions, products, norms,
              K1, copies, the rest; each family's longest kernels by
              name); then a full-width forward in bf16 at
              b 1, 32×32 latents against the port's fp32 CPU forward of the
              same weights, relative L2 of ε within UNET_REL_L2.
 20a. train_unet — UNetConfig.sd15() trained through the UNet twin's
              build, optimizer, train_inputs and train_step (unet_bench
              --train: the reference's DDPM step, ε-MSE in fp32, pure-bf16
              AdamW(1e-4, multi_precision=False)), b 2, 64×64 latents, the
              77-token context: 2 warm-up and 5 counted steps; step ms,
              images/s, MFU over 3 × the twin's forward FLOP count, peak
              memory; K1, K3 and K4 32 launches a step each (12 at d 256, 10
              at 128, 10 at 64: the wrappers' `by_d`), none windowed or
              dropped, nothing else, no plain attention call; the loss
              finite, the last below the first; one traced step by family
              and one of the forward and backward alone (the optimizer is
              the difference); then one bf16 loss and backward at full
              width, b 1, 32×32, against the port's fp32 CPU loss and
              backward of the same weights: the relative loss error within
              UNET_LOSS_RTOL, the gradients' relative L2 over all
              parameters within UNET_GRAD_REL_L2 and at the worst
              parameter within UNET_GRAD_REL_L2_PARAM.
 21. ernie  — ERNIE-3.0 at Titan width through the twin of examples/
              scale_report.py ernie-titan-step (scale_report.run: hidden
              12288, 96 heads, ffn 49152, the reference's 1 + 1 layers of
              48 + 12, 6.43 B parameters, bf16, SGD 1e-4 with fp32
              masters, 2 + 6 steps) at its defaults (seq 128, b 1) and at
              seq 512, b 8: step ms, tokens/s, MFU (6 × trained params ×
              tokens), peak memory, every loss finite and the last below
              the first, K1/K3/K4 2 a step each without a mask; one
              traced step at the defaults by kernel family, and its
              forward and backward alone (the SGD update the difference);
              then
              ErnieConfig() (ERNIE-base, uncut: 12 layers, d 64) as the
              backbone ErnieModel in bf16 on a padded batch (b 32, s 512)
              with its (b, 1, 1, s) bool mask: forward and backward with
              every attention call on the mask instantiations (12 each, no
              plain call), against the same model over the plain twins on
              the card (PlainKernelsOnCard): output within
              ERNIE_OUT_REL_L2, all gradients within ERNIE_GRAD_REL_L2,
              the worst parameter within ERNIE_GRAD_REL_L2_PARAM, and at
              the first layer's attention output the mask's own effect
              (the plain twins without it) ERNIE_MASK_MARGIN times the
              kernels' difference or more; the path's launches (the twin's runs and the backbone's first
              step) for the kernel table's rows 1e, 2d, 3d.
 bwd_times (--bwd-times alone) — the windowless K3 and K4 at GPT-2 345M's,
              train_llama's and train_mistral's attention shapes, as phase
              timing_train times them; the calls take no window, so the
              script runs against a tree that predates it too (copy it
              into the tree and run it there: the tree's own package is
              imported), parent and change in turns in one call.

--quick stops after phase 8m; --int8-stress runs phase 8f alone; --training
runs phases 5a, 17a, 18 and 19; --dropout phases 8g, 8h and 16a; --moe
phases 8, 13 and 13a; --unet phases 8i, 8j, 20 and 20a (about 100 s with
the build); --ernie phases 8k and 21 (about 140 s with the build);
--modes phases 8m and 19a (about 115 s with the build). Every failure
propagates and exits non-zero. The whole run takes about 420 s on an
H100, build included (phases 8i, 8j, 20 and 20a about 65 s of it, 8k and
21 about 30 s, 8m and 19a about 65 s); the watchdog (WATCHDOG_S) ends a
run that stalls past 1,100 s.
The line before the last is the kernel table ({"kernels": [...]}); the
last line is {"ok": true, "device": {...}}. Imports nothing of jax or
paddle_tpu.
"""

import dataclasses
import faulthandler
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances. bf16 keeps 8 significant bits: where kernel and plain version
# round nearly equal fp32 values on either side of a boundary they differ by
# one bf16 ulp (at most 2^-7·|v|, the rtol). Such flips in the bf16
# intermediates (the normalised x, attention output, SwiGLU activation)
# feed the next products and leave absolute noise in the fp32 residual
# (the atol), which grows with depth.
K1_TOL_OUT = 3e-2   # |out| <= max|v| ~ 4: bf16 P in P·V + bf16 output
K1_TOL_LSE = 2e-3   # fp32 log-sum-exp; __expf approximation
K2_ATOL, K2_RTOL = 5e-2, 2.0 ** -7   # x_out and appended row, 2 layers
E2E_ATOL, E2E_RTOL = 0.1, 2.0 ** -5  # logits after 32 layers
# The serve phase's teacher-forced step compares 8 rows x 32000 logits of
# the live engine state. E2E_ATOL is the largest error K2's b=4 step
# showed (0.1016, passing by the rtol term) and leaves no margin: K5 read
# 0.117 and 0.110 in two runs, the second above 0.1 + |ref|/32 at one
# logit of |ref| < 0.31 (argmax 8/8 both times). The bf16 flips' noise is
# the same as K2's; 0.15 leaves that noise room, a wrong kernel gives O(1).
# The MoE phase's teacher-forced 28-layer step (4 rows × 102400 logits)
# read 0.117 against the plain path taking K6's experts: the same noise.
SERVE_LOGIT_ATOL = 0.15
# The whole run, build included, takes about 420 s on an H100; past
# this many seconds the watchdog reports a stall and ends the run.
WATCHDOG_S = 1100
# K3/K4: each gradient within K3_TOL · max|plain|. The kernels round P and
# dS to bf16 before their products (2^-9 relative each, signs at random)
# and their outputs to bf16 (2^-9); sums are fp32 and Δ is fp32, so the
# error stays a few 2^-9 of the largest entry. 2^-6 = 8 · 2^-9 leaves room
# for __expf and sums over 1024 keys; a wrong fragment or mask gives O(1).
K3_TOL = 2.0 ** -6
# Whole step, bf16 on the card vs fp32 on the CPU from the same (bf16)
# weights: every activation, logit and gradient of the card rounds to bf16
# (2^-9 relative) at each layer. The loss (≈ ln 50304 = 10.8) is a mean
# over 1024 tokens, so that noise averages down to ~1e-3; each gradient's
# relative error ‖g − g_ref‖/‖g_ref‖ sums a few such roundings per layer,
# ~1e-2 over 2 layers. A broken backward gives O(1).
STEP_LOSS_ATOL = 2e-2
STEP_GRAD_RTOL = 5e-2
# train_llama's attention call (TinyLlama-1.1B at b 4, S 2048): b, heads,
# kv heads, sq, sk, head_dim
LLAMA_TRAIN_ATTN = (4, 32, 4, 2048, 2048, 64)
# train_mistral's attention call: b, S, heads, kv heads, head_dim, window
K3W_PATH = (1, 8192, 32, 8, 128, 4096)
# train_mistral's depth: Mistral-7B's full 32 layers (bf16 weights, grads
# and both AdamW moments, 8 bytes a parameter, 57.9 GB, + 2.1 GB of layer
# boundaries at S 8192 fit one 80 GB card)
MISTRAL_TRAIN_LAYERS = 32


def close(a, ref, atol, rtol):
    """(max |a - ref|, all |a - ref| <= atol + rtol·|ref|)."""
    a, ref = a.float(), ref.float()
    d = (a - ref).abs()
    return d.max().item(), bool((d <= atol + rtol * ref.abs()).all())


_T0 = time.perf_counter()


def emit(obj):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps(dict(obj, elapsed_s=time.perf_counter() - _T0)),
          flush=True)


def card():
    from paddle_tpu_torch.bench import peak_rates
    name_line = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(name_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, flops = peak_rates(kind)
    emit({"phase": "card", "nvidia_smi": name_line, "kind": kind,
          "count": torch.cuda.device_count(), "bytes_per_s": bw,
          "bf16_flops": flops})
    return name_line, kind, bw, flops


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters=10, warmup=2, tries=4):
    """The card's time of fn's kernels per call, for a call whose host work
    outlasts its kernels (where time_ms times the host): CUDA events around
    `iters` calls queued behind a sleep kernel that outlasts the host's
    enqueueing of all of them, so the card runs them back to back. A host
    stall (the host's cores are shared) can outlast the sleep and let the
    queue run dry: that measurement is thrown away and taken again behind
    a sleep four times the stalled enqueue, up to `tries` times; raises if
    the queue ran dry every time. (A sum over a torch.profiler trace, the
    earlier way, lost kernel records in some runs and read low.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    # twice the calibrated enqueue time, plus 0.5 ms
    sleep_ms = 2 * (time.perf_counter() - t0) * 1e3 + 0.5
    torch.cuda.synchronize()
    for _ in range(tries):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        # 2e9 cycles a second is above the card's clock: the sleep lasts
        # at least sleep_ms
        torch.cuda._sleep(int(sleep_ms * 2e6))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if enqueue_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        sleep_ms = max(sleep_ms, 4 * enqueue_ms)
    raise RuntimeError(f"device_ms: enqueueing took {enqueue_ms:.3f} ms, "
                       f"longer than the sleep ahead of it, {tries} times")


def rand(shape, gen, scale=1.0, dtype=torch.bfloat16):
    t = torch.empty(shape, dtype=torch.float32, device="cuda")
    return (t.normal_(0.0, scale, generator=gen)).to(dtype)


# ---- K1 -----------------------------------------------------------------------

def k1_agreement(out, lse, ref, ref_lse):
    """K1's (out, lse) against its plain version's: out within K1_TOL_OUT,
    lse within K1_TOL_LSE on rows with a visible key, and rows with none
    giving out 0 and lse NEG_INF exactly; out finite."""
    err = (out.float() - ref.float()).abs().max().item()
    live = ref_lse > -1e29
    lerr = (lse - ref_lse)[live].abs().max().item() if live.any() else 0.0
    dead = ~live
    dead_ok = bool((lse[dead] == ref_lse[dead]).all()
                   and not out.transpose(1, 2)[dead].any())
    ok = (err <= K1_TOL_OUT and lerr <= K1_TOL_LSE and dead_ok
          and bool(torch.isfinite(out.float()).all()))
    return {"max_abs_err": err, "lse_max_abs_err": lerr,
            "dead_rows": int(dead.sum().item()), "dead_rows_ok": dead_ok,
            "tol": K1_TOL_OUT, "lse_tol": K1_TOL_LSE, "ok": ok}


def k1_case(fa, gen, b, h, nkv, sq, sk, d, q_off, kv_len, causal=True,
            window=None):
    """K1 against its plain version; kv_len is one length for every row, a
    list (a 0 gives a batch row with no visible key) or None (no kv_lens,
    as a training call), q_off None the bottom-right causal alignment. With a window, K1 launches twice (the
    same bits), a window at or above the visible span (off + sq keys, the
    most a row sees) must give the windowless launch's bits, and t0, the
    first key tile of the first query block, is reported with whether a
    row of that block has no visible key in it."""
    q = rand((b, sq, h, d), gen)
    k = rand((b, sk, nkv, d), gen)
    v = rand((b, sk, nkv, d), gen)
    if kv_len is None:
        kl = None
    else:
        lens = [kv_len] * b if isinstance(kv_len, int) else list(kv_len)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(is_causal=causal, causal_offset=q_off, kv_lens=kl)
    if window is not None:
        kw["window"] = window
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    res = {"b": b, "h": h, "nkv": nkv, "sq": sq, "sk": sk, "d": d,
           "q_off": q_off, "kv_len": kv_len, "causal": causal,
           **k1_agreement(out, lse, ref, ref_lse)}
    ok = res["ok"]
    if window is not None:
        out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
        off = sk - sq if q_off is None else q_off
        t0 = max(0, off - window + 1) // 128
        res.update(window=window, t0_first_block=t0,
                   row_without_key_in_first_tile=(
                       off + min(sq, 128) - window >= (t0 + 1) * 128),
                   repeat_bitwise=bool(torch.equal(out, out2)
                                       and torch.equal(lse, lse2)))
        ok = ok and res["repeat_bitwise"]
        if window >= off + sq:
            kw.pop("window")
            o0, l0 = fa.flash_attention_fwd(q, k, v, **kw)
            res["windowless_bitwise"] = bool(torch.equal(out, o0)
                                             and torch.equal(lse, l0))
            ok = ok and res["windowless_bitwise"]
    res["ok"] = ok
    return res


def phase_k1(fa, gen):
    cases = [
        k1_case(fa, gen, 4, 32, 32, 1024, 1152, 128, 0, 1024),  # prefill
        k1_case(fa, gen, 2, 32, 8, 512, 640, 128, 64, 576),     # GQA
        k1_case(fa, gen, 2, 8, 8, 1000, 1000, 128, 0, 1000),    # ragged
        k1_case(fa, gen, 3, 8, 2, 1000, 1100, 64, 100, 1037),   # d=64 GQA
        k1_case(fa, gen, 4, 32, 32, 1, 1152, 128, 1056, 1057),  # decode
        # the edges of a 128-row query tile and a 128-key TMA ring: sq
        # around the tile, sk not a multiple of it, an offset that starts
        # inside a key tile, GQA 4 and 8, a batch row of kv_len 0
        k1_case(fa, gen, 2, 16, 4, 1, 300, 128, 299, [300, 0]),
        k1_case(fa, gen, 2, 16, 2, 65, 333, 64, 200, [333, 100]),
        k1_case(fa, gen, 2, 8, 2, 127, 127, 128, None, 127),
        k1_case(fa, gen, 2, 8, 1, 129, 200, 64, 71, [200, 0]),
        k1_case(fa, gen, 1, 16, 4, 200, 1000, 128, 777, 1000),
        k1_case(fa, gen, 2, 8, 1, 200, 260, 64, None, [260, 3],
                causal=False),
    ]
    # train_llama's call, from a generator of its own (the later phases'
    # inputs stay as they were)
    own = torch.Generator(device="cuda")
    own.manual_seed(17)
    cases.append(k1_case(fa, own, *LLAMA_TRAIN_ATTN, None, None))
    emit({"phase": "k1", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return max(c["max_abs_err"] for c in cases)


# ---- K1's sliding window -------------------------------------------------------

def tiny_window_generate(fa, fd):
    """A tiny windowed Llama (h 256, 4 heads of 64, 2 kv heads, 2 layers,
    window 5) through `generate` on the card (bf16, the layered path: K1
    with the window, prompt 12, 16 new tokens, b=2) twice, and on the CPU
    copy of the same weights (the plain versions): tokens equal the CPU's
    or part at a near tie; K1 once a layer a step, nothing else."""
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      sliding_window=5)
    n, new = 12, 16
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    cpu = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    cpu.set_state_dict({k: v.cpu() for k, v in
                        model.state_dict(include_buffers=False).items()})
    ids = np.random.RandomState(14).randint(0, 256, (2, n))
    reset_counts(fa, fd)
    out = generate(model, ids, max_new_tokens=new)
    torch.cuda.synchronize()
    got = counts(fa, fd)
    again = generate(model, ids, max_new_tokens=new)
    ref = generate(cpu, ids, max_new_tokens=new)
    partings = [first_parting(cpu, ids[i], out[i, n:].cpu().numpy(),
                              ref[i, n:].cpu().numpy()) for i in range(2)]
    want = dict.fromkeys(got, 0)
    want["flash_attention_fwd"] = cfg.num_layers * new
    run = {"window": cfg.sliding_window, "prompt": n, "new": new,
           "launches": got, "repeat_equal": bool(torch.equal(out, again)),
           "rows_equal_cpu": sum(q is None for q in partings),
           "first_parting": [q for q in partings if q is not None]}
    run["ok"] = (got == want and run["repeat_equal"]
                 and all(q is None or q["near_tie"] for q in partings))
    return run


def phase_k1w(fa, fd, gen):
    """K1's causal sliding window at the kernel's edges: windows 1, 64,
    127, 128, 129, 200 and 4096 over a 384-row query span at offset 700
    (the first block's t0 inside a key tile; windows below 128 make every
    query tile straddle both the window's lower edge and the diagonal, and
    at 1 and 64 the block's last rows see no key of the first loaded tile),
    GQA 4 and 8, d 64 and 128, a batch row whose kv_len ends below the
    window (rows with no visible key), bottom-right self-attention, sq = 1
    decode with kv_lens at Mistral-7B's decode shape (the 8256-key cache at
    position 8254, window 4096), and windows at and above the visible span
    (the windowless bits); then the tiny windowed `generate`."""
    g = torch.Generator(device="cuda")
    g.manual_seed(141)
    base = (2, 16, 4, 384, 1200, 128, 700, 1100)
    cases = [k1_case(fa, g, *base, window=w)
             for w in (1, 64, 127, 128, 129, 200, 1084, 4096)]
    gqa8 = (2, 16, 2, 300, 700, 64, 333, [700, 500])
    cases += [k1_case(fa, g, *gqa8, window=w) for w in (1, 129, 200, 4096)]
    for shape, w in (
            ((1, 8, 8, 1000, 1000, 128, None, 1000), 200),
            ((1, 32, 8, 2048, 2048, 128, None, 2048), 512),
            ((2, 32, 8, 1, 8256, 128, 8254, [8255, 8255]), 4096),
            ((2, 32, 8, 1, 8256, 128, 8254, [8255, 100]), 4096),
            ((2, 16, 2, 1, 1500, 64, 1300, 1301), 129)):
        cases.append(k1_case(fa, g, *shape, window=w))
    tiny = tiny_window_generate(fa, fd)
    reset_counts(fa, fd)
    emit({"phase": "k1w", "cases": cases, "tiny_generate": tiny})
    bad = [c for c in cases if not c["ok"]]
    if bad or not tiny["ok"]:
        raise AssertionError(f"K1's window mode: {bad}, tiny {tiny}")
    return max(c["max_abs_err"] for c in cases)


# ---- K2 -----------------------------------------------------------------------

def fused_params(gen, L, h, nh, nkv, hd, ffn):
    dq, dkv = nh * hd, nkv * hd
    return {"ln1": (1.0 + rand((L, h), gen, 0.1, torch.float32)).bfloat16(),
            "wqkv": rand((L, h, dq + 2 * dkv), gen, 0.02),
            "wo": rand((L, dq, h), gen, 0.02),
            "ln2": (1.0 + rand((L, h), gen, 0.1, torch.float32)).bfloat16(),
            "wg": rand((L, h, ffn), gen, 0.02),
            "wu": rand((L, h, ffn), gen, 0.02),
            "wd": rand((L, ffn, h), gen, 0.02)}


# the stacks' widths: Llama-2-7B for the llama arch, GPT-2 345M for gpt
WIDTHS = {"llama": dict(h=4096, nh=32, hd=128, ffn=11008),
          "gpt": dict(h=1024, nh=16, hd=64, ffn=4096)}


def gpt_params(gen, L, h, ffn):
    """Random bf16 gpt stacks (build_fused_params_gpt's keys): LayerNorm
    scales about 1, every bias and LayerNorm shift nonzero."""
    one = lambda n: (1.0 + rand((L, n), gen, 0.1, torch.float32)).bfloat16()
    return {"ln1": one(h), "ln1_b": rand((L, h), gen, 0.1),
            "wqkv": rand((L, h, 3 * h), gen, 0.02),
            "bqkv": rand((L, 3 * h), gen, 0.1),
            "wo": rand((L, h, h), gen, 0.02), "bo": rand((L, h), gen, 0.1),
            "ln2": one(h), "ln2_b": rand((L, h), gen, 0.1),
            "wg": rand((L, h, ffn), gen, 0.02),
            "bg": rand((L, ffn), gen, 0.1),
            "wd": rand((L, ffn, h), gen, 0.02), "bd": rand((L, h), gen, 0.1)}


def stack_params(gen, arch, L, nkv):
    w = WIDTHS[arch]
    if arch == "gpt":
        return gpt_params(gen, L, w["h"], w["ffn"])
    return fused_params(gen, L, w["h"], w["nh"], nkv, w["hd"], w["ffn"])


#: the row counts the product engine's cases add beside each phase's own:
#: one row, each of its wgmma widths N = 16, 32 and 64 entered just past the
#: one below (9, 16, 33), a full launch (GROUP_ROWS) and one row past it (65:
#: two launches, 33 + 32 rows)
WIDE_ROWS = (1, 9, 16, 33, 64, 65)

#: the split-KV attention's chunk edges (512-key chunks): one key, two, a
#: full chunk, one key past it and two, two full chunks and one key past
#: them, and a third chunk part-filled; the contiguous cases run over a
#: cache of EDGE_S rows, so the last position is the cache's last row
#: (its boxes reach past the slab, which reads as zeros)
EDGE_POS = (0, 1, 511, 512, 513, 1023, 1024, 1500)
EDGE_S = 1501


def wide_nkv(b):
    """The llama wide cases' kv heads: MHA at 1 and 16 rows, GQA (8) at
    the others, which keeps the 64-row cache and pool small."""
    return 32 if b in (1, 16) else 8


def wide_gen(seed):
    """A generator of the wide cases' own, so that the shared one's stream,
    and with it every later phase's inputs, stays as it was."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def k2_case(fd, rope, gen, nkv, L=2, b=4, S=1152, pos=1056, arch="llama",
            twice=False):
    """K2 against its plain version; the gpt mode (and `twice`) also
    launches twice and holds the two results bitwise equal."""
    w = WIDTHS[arch]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    dkv = nkv * hd
    params = stack_params(gen, arch, L, nkv)
    kv = torch.zeros((L, b, S, 2 * dkv), dtype=torch.bfloat16, device="cuda")
    kv[:, :, :pos] = rand((L, b, pos, 2 * dkv), gen)
    x = rand((b, h), gen)
    c = s = None
    if arch != "gpt":
        cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch)
    kv_k = kv.clone()
    xo, _ = fd.fused_decode_cuda(x, params, kv_k, pos, c, s, **kw)
    repeat = None
    if twice or arch == "gpt":
        kv_k2 = kv.clone()
        xo2, _ = fd.fused_decode_cuda(x, params, kv_k2, pos, c, s, **kw)
        repeat = bool(torch.equal(xo, xo2) and torch.equal(kv_k, kv_k2))
        del kv_k2
    torch.cuda.synchronize()
    xr, kv_r = fd.fused_decode_reference(x, params, kv, pos, c, s, **kw)
    err, ok_x = close(xo, xr, K2_ATOL, K2_RTOL)
    row_err, ok_row = close(kv_k[:, :, pos], kv_r[:, :, pos], K2_ATOL,
                            K2_RTOL)
    untouched = bool(torch.equal(kv_k[:, :, :pos], kv_r[:, :, :pos])
                     and torch.equal(kv_k[:, :, pos + 1:], kv_r[:, :, pos + 1:]))
    ok = (ok_x and ok_row and untouched and repeat is not False
          and bool(torch.isfinite(xo.float()).all()))
    res = {"nkv": nkv, "L": L, "b": b, "S": S, "pos": pos,
           "max_abs_err": err, "row_max_abs_err": row_err,
           "rest_of_cache_unchanged": untouched, "atol": K2_ATOL,
           "rtol": K2_RTOL, "ok": ok}
    if arch == "gpt":
        res["arch"] = "gpt"
    if repeat is not None:
        res["two_launches_bitwise_equal"] = repeat
    return res


def phase_k2g(fd, rope, gen):
    """K2's gpt mode at GPT-2 345M width (h 1024, 16 heads of 64, ffn 4096),
    2 layers, b=4, S 1152, pos 1056, then at WIDE_ROWS rows."""
    cases = [k2_case(fd, rope, gen, 16, arch="gpt")]
    wg = wide_gen(21)
    cases += [k2_case(fd, rope, wg, 16, b=b, arch="gpt") for b in WIDE_ROWS]
    emit({"phase": "k2g", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K2 (gpt) disagrees with its plain version: "
                             f"{bad}")
    return max(c["max_abs_err"] for c in cases)


def phase_k2(fd, rope, gen):
    """K2 at Llama-2-7B width, 2 layers, b=4 (MHA and GQA nkv=8), then at
    WIDE_ROWS rows (wide_nkv's heads, two launches bitwise equal), then at
    the chunk edges EDGE_POS (b=2, MHA, two launches bitwise equal)."""
    cases = [k2_case(fd, rope, gen, 32), k2_case(fd, rope, gen, 8)]
    wg = wide_gen(20)
    cases += [k2_case(fd, rope, wg, wide_nkv(b), b=b, twice=True)
              for b in WIDE_ROWS]
    eg = wide_gen(30)
    edges = [k2_case(fd, rope, eg, 32, b=2, S=EDGE_S, pos=p, twice=True)
             for p in EDGE_POS]
    emit({"phase": "k2", "cases": cases, "chunk_edges": edges})
    cases += edges
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version: {bad}")
    return max(c["max_abs_err"] for c in cases)


# ---- K5 -----------------------------------------------------------------------

K5_BT, K5_MB = 128, 16     # the serve phase's block size and blocks per row


def k5_pool(gen, L, dkv2, positions, idle=(), bt=K5_BT, mb=K5_MB):
    """A random pool of bt-token blocks and a shuffled block table of mb
    blocks a row: row r owns ceil((pos_r + 1) / bt) private blocks drawn
    from a permutation, the rest of its table (and all of an idle row's)
    points at scratch block 0. Returns (pool, tables (b, mb) int32 cuda)."""
    b = len(positions)
    nb = 1 + b * mb
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        len(positions) + L)) + 1
    tables = torch.zeros((b, mb), dtype=torch.int32)
    nxt = 0
    for r, pos in enumerate(positions):
        if r in idle:
            continue
        need = pos // bt + 1
        tables[r, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    pool = rand((L, nb, bt, dkv2), gen)
    return pool, tables.cuda()


def wide_positions(b, seed):
    """b positions drawn from `seed` over the table's span, and the last
    row idle when b > 1."""
    r = np.random.RandomState(seed)
    pos = [int(p) for p in r.randint(0, K5_BT * K5_MB, b)]
    return pos, ((b - 1,) if b > 1 else ())


def int8_pool(fd, pool, tables, nkv):
    """An int8 pool with per-ROW lane scales (L, b, 2*nkv*hd) from a bf16
    one, as the engine keeps it: row r's scales calibrated over the blocks
    of its table (random rows at every position, so no floor scale), its
    blocks quantized with them; blocks no row maps with row 0's."""
    L, b = pool.shape[0], tables.shape[0]
    lanes = torch.stack([fd.quantize_kv_cache(
        pool[:, tables[r].long()].reshape(L, 1, -1, pool.shape[3]), nkv)[1][
        :, 0] for r in range(b)], dim=1).contiguous()
    q = lambda v, sc: torch.clamp(torch.round(v.float() / sc[:, None, None]),
                                  -127, 127).to(torch.int8)
    out = q(pool, lanes[:, 0])
    for r in range(b):
        bids = tables[r].long()
        out[:, bids] = q(pool[:, bids], lanes[:, r])
    return out, lanes


def int8_row_steps(a, b):
    """(largest difference in int8 steps, lanes one step apart) of two int8
    row sets."""
    d = (a.int() - b.int()).abs()
    return int(d.max()), int((d == 1).sum())


def k5_case(fd, rope, gen, nkv, positions, idle, L=2, arch="llama",
            twice=False, bt=K5_BT, mb=K5_MB, w8=False, kv8=False):
    """K5 against its plain version over a pool of bt-token blocks, mb a
    row; the gpt mode (and `twice`, and the int8 modes) also launches twice
    and holds the two results bitwise equal. w8: int8 weight stacks (a
    quantized model's, llama); kv8: an int8 pool with per-row scales
    (`int8_pool`), the appended rows then held within one int8 step."""
    w = WIDTHS[arch]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    b = len(positions)
    params = int8_llama_params(L, nkv) if w8 else stack_params(gen, arch, L,
                                                                 nkv)
    pool, tables = k5_pool(gen, L, 2 * nkv * hd, positions, idle, bt, mb)
    scales = None
    if kv8:
        pool, scales = int8_pool(fd, pool, tables, nkv)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    c = s = None
    if arch != "gpt":
        cos, sin = rope.rope_cos_sin(bt * mb, hd, device="cuda")
        c, s = cos.index_select(0, pos), sin.index_select(0, pos)
    x = rand((b, h), gen)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch,
              kv_scales=scales)
    pool_k = pool.clone()
    xo, _ = fd.fused_paged_decode_cuda(x, params, pool_k, tables, pos, c, s,
                                       **kw)
    repeat = None
    if twice or arch == "gpt" or w8 or kv8:
        pool_k2 = pool.clone()
        xo2, _ = fd.fused_paged_decode_cuda(x, params, pool_k2, tables, pos,
                                            c, s, **kw)
        repeat = bool(torch.equal(xo, xo2) and torch.equal(pool_k, pool_k2))
        del pool_k2
    torch.cuda.synchronize()
    xr, pool_r = fd.fused_paged_decode_reference(x, params, pool, tables,
                                                 pos, c, s, **kw)
    active = [r for r in range(b) if r not in idle]
    err, ok_x = close(xo[active], xr[active], K2_ATOL, K2_RTOL)
    bids = tables.long()[active, pos.long()[active] // bt]
    offs = pos.long()[active] % bt
    if kv8:
        row_err, off = int8_row_steps(pool_k[:, bids, offs],
                                      pool_r[:, bids, offs])
        ok_row = row_err <= 1
    else:
        row_err, ok_row = close(pool_k[:, bids, offs], pool_r[:, bids, offs],
                                K2_ATOL, K2_RTOL)
    # every other row of every block but scratch is untouched by both
    mask = torch.ones(pool.shape[1:3], dtype=torch.bool, device="cuda")
    mask[bids, offs] = False
    mask[0] = False
    untouched = bool(torch.equal(pool_k[:, mask], pool_r[:, mask]))
    ok = (ok_x and ok_row and untouched and repeat is not False
          and bool(torch.isfinite(xo.float()).all()))
    res = {"nkv": nkv, "L": L, "b": b, "block_tokens": bt,
           "blocks_per_row": mb, "positions": positions,
           "idle_rows": list(idle), "max_abs_err": err,
           "row_max_abs_err": row_err, "rest_of_pool_unchanged": untouched,
           "atol": K2_ATOL, "rtol": K2_RTOL, "ok": ok}
    if arch == "gpt":
        res["arch"] = "gpt"
    if w8 or kv8:
        res.update(int8_weights=w8, int8_pool=kv8)
    if kv8:
        res.update(row_max_int8_steps=row_err, row_lanes_one_step_apart=off)
    if repeat is not None:
        res["two_launches_bitwise_equal"] = repeat
    return res


def k5_vs_k2(fd, rope, gen, nkv=8, L=2, b=8, pos=1300, arch="llama",
             w8=False, kv8=False):
    """Every row at one position over the same KV: K5 through a shuffled
    block table must give K2's bits (same products, same attention code,
    the same chunks merged in the same order). kv8: the bitwise pin of the
    int8 pool — the cache quantized by quantize_kv_cache, the pool holding
    its rows with every row's scales K2's layer scales; w8: int8 weights
    on both."""
    w = WIDTHS[arch]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    dkv2 = 2 * nkv * hd
    S = K5_BT * K5_MB
    params = int8_llama_params(L, nkv) if w8 else stack_params(gen, arch, L,
                                                                 nkv)
    cache = torch.zeros((L, b, S, dkv2), dtype=torch.bfloat16, device="cuda")
    cache[:, :, :pos] = rand((L, b, pos, dkv2), gen)
    positions = [pos] * b
    pool, tables = k5_pool(gen, L, dkv2, [S - 1] * b)   # every block mapped
    kq2 = kq5 = {}
    if kv8:
        cache, lanes = fd.quantize_kv_cache(cache, nkv)
        pool = pool.to(torch.int8)
        kq2 = dict(kv_scales=lanes)
        kq5 = dict(kv_scales=lanes.expand(L, b, dkv2).contiguous())
    for r in range(b):
        pool[:, tables[r].long()] = cache[:, r].reshape(L, K5_MB, K5_BT,
                                                        dkv2)
    x = rand((b, h), gen)
    p32 = torch.tensor(positions, dtype=torch.int32, device="cuda")
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch)
    c2 = s2 = c5 = s5 = None
    if arch != "gpt":
        cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
        c2, s2 = cos[pos:pos + 1], sin[pos:pos + 1]
        c5, s5 = cos.index_select(0, p32), sin.index_select(0, p32)
    x2, cache = fd.fused_decode_cuda(x, params, cache, pos, c2, s2, **kw,
                                     **kq2)
    x5, pool = fd.fused_paged_decode_cuda(x, params, pool, tables, p32, c5,
                                          s5, **kw, **kq5)
    torch.cuda.synchronize()
    rows_equal = all(
        torch.equal(pool[:, tables[r, pos // K5_BT].long(), pos % K5_BT],
                    cache[:, r, pos]) for r in range(b))
    ok = bool(torch.equal(x5, x2)) and rows_equal
    return {"arch": arch, "nkv": nkv, "L": L, "b": b, "pos": pos,
            "int8_weights": w8, "int8_pool": kv8,
            "x_out_bitwise_equal_k2": bool(torch.equal(x5, x2)),
            "appended_rows_equal_k2": rows_equal,
            "x_out_max_abs_diff": (x5.float() - x2.float()).abs().max().item(),
            "ok": ok}


#: the int8 sub-modes of K5 and K7 (Queue B rows 6 and 7, a–d): (name, sub-row
#: letter, arch, int8 weights, int8 pool)
PAGED_INT8_MODES = (("llama_int8w_int8kv", "a", "llama", True, True),
                    ("llama_int8w", "b", "llama", True, False),
                    ("llama_int8kv", "c", "llama", False, True),
                    ("gpt_int8kv", "d", "gpt", False, True))


def k5_int8_cases(fd, rope, arch, w8, kv8, seed):
    """One int8 mode of K5 against its plain version (two launches bitwise
    equal each): 8 rows at phase k5's mixed positions with one idle row, 65
    rows (two row groups, the scales of each group read in place) at drawn
    positions with the last row idle, and one row at each chunk edge over
    blocks of 128 and of 12 tokens (the cp.async path). With an int8 pool
    the edge cases run one layer (as phase k2q's int8 edges: over two,
    layer 1's appends quantize bf16 noise, which at pos 1–2 moves x_out
    past K2's tolerance for any kernel)."""
    g = wide_gen(seed)
    nkv = 16 if arch == "gpt" else 32
    mixed = [1037, 5, 700, 1024, 3, 127, 1500, 256]   # row 4 idle
    pos65, idle65 = wide_positions(65, seed)
    kw = dict(arch=arch, w8=w8, kv8=kv8)
    edge, le = list(EDGE_POS), 1 if kv8 else 2
    return [k5_case(fd, rope, g, nkv, mixed, (4,), **kw),
            k5_case(fd, rope, g, 16 if arch == "gpt" else 8, pos65, idle65,
                    **kw),
            k5_case(fd, rope, g, nkv, edge, (), L=le, **kw),
            k5_case(fd, rope, g, 16, edge, (), L=le, bt=12, mb=126, **kw)]


def phase_k5(fd, rope, gen, int8_errs):
    """K5 at Llama-2-7B width, 2 layers, b=8 at mixed positions with an
    idle row (MHA and GQA), bitwise against K2 at b=8 (llama and gpt);
    then at WIDE_ROWS rows (drawn positions, the last row idle; two
    launches bitwise equal) and bitwise against K2 at b=33 and b=65 (two
    launches of rows each); then at the chunk edges EDGE_POS, over blocks of
    128, 16 and 12 tokens, and bitwise against K2 at each edge. Then the
    llama int8 modes (`k5_int8_cases`) and the int8 pool's bitwise pin: with
    every row's scales K2's layer scales, K5 gives K2-int8's bits (8 rows,
    65 rows, each chunk edge over one layer; int8 weights and bf16). Fills
    int8_errs[mode] with each int8 mode's largest x_out error."""
    mixed = [1037, 5, 700, 1024, 3, 127, 1500, 256]   # row 4 idle
    cases = [k5_case(fd, rope, gen, 32, mixed, idle=(4,)),
             k5_case(fd, rope, gen, 8, mixed, idle=(4,))]
    bitwise = k5_vs_k2(fd, rope, gen)
    bitwise_gpt = k5_vs_k2(fd, rope, gen, nkv=16, pos=1000, arch="gpt")
    wg = wide_gen(22)
    for b in WIDE_ROWS:
        positions, idle = wide_positions(b, 100 + b)
        cases.append(k5_case(fd, rope, wg, wide_nkv(b), positions, idle,
                             twice=True))
    bitwise33 = k5_vs_k2(fd, rope, wg, b=33)
    bitwise33_gpt = k5_vs_k2(fd, rope, wg, nkv=16, b=33, pos=1000,
                             arch="gpt")
    bitwise65 = k5_vs_k2(fd, rope, wg, b=65)
    bitwise65_gpt = k5_vs_k2(fd, rope, wg, nkv=16, b=65, pos=1000,
                             arch="gpt")
    # the chunk edges: one row at each of EDGE_POS, over blocks of 128
    # tokens (MHA), 16 (GQA 4) and 12 (GQA 2: the cp.async path), two
    # launches bitwise equal; K5 = K2 bitwise at each edge, both modes
    eg = wide_gen(31)
    edge = list(EDGE_POS)
    edges = [k5_case(fd, rope, eg, 32, edge, (), twice=True),
             k5_case(fd, rope, eg, 8, edge, (), twice=True, bt=16, mb=128),
             k5_case(fd, rope, eg, 16, edge, (), twice=True, bt=12, mb=126)]
    edges_vs_k2 = ([k5_vs_k2(fd, rope, eg, b=2, pos=p) for p in EDGE_POS]
                   + [k5_vs_k2(fd, rope, eg, nkv=16, b=2, pos=p, arch="gpt")
                      for p in EDGE_POS])
    int8 = {name: k5_int8_cases(fd, rope, arch, w8, kv8, 40 + i)
            for i, (name, _, arch, w8, kv8) in enumerate(PAGED_INT8_MODES)
            if arch == "llama"}
    pg = wide_gen(35)
    pins = ([k5_vs_k2(fd, rope, pg, kv8=True, w8=w8) for w8 in (True, False)]
            + [k5_vs_k2(fd, rope, pg, b=65, kv8=True, w8=True)]
            + [k5_vs_k2(fd, rope, pg, L=1, b=2, pos=p, kv8=True)
               for p in EDGE_POS])
    emit({"phase": "k5", "cases": cases, "vs_k2": bitwise,
          "vs_k2_gpt": bitwise_gpt, "vs_k2_b33": bitwise33,
          "vs_k2_gpt_b33": bitwise33_gpt, "vs_k2_b65": bitwise65,
          "vs_k2_gpt_b65": bitwise65_gpt, "chunk_edges": edges,
          "chunk_edges_vs_k2": edges_vs_k2, "int8": int8,
          "int8_pool_vs_k2_int8kv": pins})
    cases += edges + [c for cs in int8.values() for c in cs]
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K5 disagrees with its plain version: {bad}")
    for name, cs in int8.items():
        int8_errs[name] = max(c["max_abs_err"] for c in cs)
    for b in [bitwise, bitwise_gpt, bitwise33, bitwise33_gpt, bitwise65,
              bitwise65_gpt] + edges_vs_k2 + pins:
        if not b["ok"]:
            raise AssertionError(f"K5 does not give K2's bits: {b}")
    return max(c["max_abs_err"] for c in cases)


def phase_k5g(fd, rope, gen, int8_errs):
    """K5's gpt mode at GPT-2 345M width, 2 layers, b=8 over a shuffled
    table at mixed positions with one idle row (phase k5's rows), then at
    WIDE_ROWS rows, then one row at each chunk edge EDGE_POS; then the
    int8 pool (`k5_int8_cases`), its error into int8_errs."""
    mixed = [1037, 5, 700, 1024, 3, 127, 1500, 256]   # row 4 idle
    cases = [k5_case(fd, rope, gen, 16, mixed, idle=(4,), arch="gpt")]
    wg = wide_gen(23)
    for b in WIDE_ROWS:
        positions, idle = wide_positions(b, 200 + b)
        cases.append(k5_case(fd, rope, wg, 16, positions, idle, arch="gpt"))
    edge = k5_case(fd, rope, wide_gen(32), 16, list(EDGE_POS), (),
                   arch="gpt")
    int8 = k5_int8_cases(fd, rope, "gpt", False, True, 43)
    emit({"phase": "k5g", "cases": cases, "chunk_edges": edge,
          "int8_pool": int8})
    cases += [edge] + int8
    int8_errs["gpt_int8kv"] = max(c["max_abs_err"] for c in int8)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K5 (gpt) disagrees with its plain version: "
                             f"{bad}")
    return max(c["max_abs_err"] for c in cases)


# ---- K7 -----------------------------------------------------------------------

K7_K1 = 5      # the spec phase's tail: the last token and k = 4 proposals


def k7_pool(gen, L, dkv2, nmap):
    """A random pool and a shuffled block table: row r maps nmap[r] private
    blocks drawn from a permutation; the rest of its table (all of an idle
    row's) points at scratch block 0. Returns (pool, tables (b, MB) int32
    cuda)."""
    b = len(nmap)
    nb = 1 + b * K5_MB
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        b + L + 7)) + 1
    tables = torch.zeros((b, K5_MB), dtype=torch.int32)
    nxt = 0
    for r, n in enumerate(nmap):
        tables[r, :n] = perm[nxt:nxt + n].to(torch.int32)
        nxt += n
    return rand((L, nb, K5_BT, dkv2), gen), tables.cuda()


def k7_rope(rope, hd, positions, K1):
    """(b, K1, hd) rope rows at min(pos + j, S - 1), as the engine gathers
    them."""
    S = K5_BT * K5_MB
    cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
    pj = torch.clamp(torch.tensor(positions, device="cuda")[:, None]
                     + torch.arange(K1, device="cuda")[None], max=S - 1)
    return cos[pj], sin[pj]


def k7_case(fd, rope, gen, nkv, positions, nmap, L=2, arch="llama",
            w8=False, kv8=False, fp32=False, K1=K7_K1, x_vs_fp32=False):
    """K7 against the plain verify. Compared: x_out of every mapped tail
    token (its position and all before it in mapped blocks), the appended
    rows at mapped positions, and every other row of every block but
    scratch (untouched by both); K7 also launches twice and the two
    results must be bitwise equal. w8/kv8: the int8 modes, as k5_case's
    (the appended int8 rows within one int8 step). fp32: also the plain
    verify in fp32 (bf16 weights and x upcast, int8 stacks and pool as
    they are), and each of K7 and the bf16 plain version against it on
    the mapped tokens (reported). K1: the tail's tokens (above GROUP_ROWS
    the wrapper runs chunks of at most GROUP_ROWS tokens in turn).
    x_vs_fp32 (with fp32): x_out is held to the fp32 plain verify instead,
    K7 no further from it than the bf16 plain version plus K2_ATOL (where
    both carry more bf16 noise than K2's tolerance; the appended rows and
    the rest of the pool are held as always)."""
    w = WIDTHS[arch]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    b = len(positions)
    params = int8_llama_params(L, nkv) if w8 else stack_params(gen, arch, L,
                                                                 nkv)
    pool, tables = k7_pool(gen, L, 2 * nkv * hd, nmap)
    scales = None
    if kv8:
        pool, scales = int8_pool(fd, pool, tables, nkv)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    c = s = None
    if arch != "gpt":
        c, s = k7_rope(rope, hd, positions, K1)
    x = rand((b, K1, h), gen)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch,
              kv_scales=scales)
    pool_k = pool.clone()
    n0 = fd.fused_paged_verify_cuda.launches
    xo, _ = fd.fused_paged_verify_cuda(x, params, pool_k, tables, pos, c, s,
                                       **kw)
    launches = fd.fused_paged_verify_cuda.launches - n0
    pool_k2 = pool.clone()
    xo2, _ = fd.fused_paged_verify_cuda(x, params, pool_k2, tables, pos, c,
                                        s, **kw)
    torch.cuda.synchronize()
    x32 = None
    if fp32:
        x32, _ = fd.fused_paged_verify_reference(
            x.float(), {k: v.float() if v.dtype == torch.bfloat16 else v
                        for k, v in params.items()},
            pool.clone() if kv8 else pool.float(), tables, pos, c, s, **kw)
    xr, pool_r = fd.fused_paged_verify_reference(x, params, pool, tables,
                                                 pos, c, s, **kw)
    mapped = [(r, j) for r in range(b) for j in range(K1)
              if (positions[r] + j) // K5_BT < min(nmap[r], K5_MB)]
    rr = torch.tensor([r for r, _ in mapped], device="cuda")
    jj = torch.tensor([j for _, j in mapped], device="cuda")
    err, ok_x = close(xo[rr, jj], xr[rr, jj], K2_ATOL, K2_RTOL)
    t = pos.long()[rr] + jj
    bids = tables.long()[rr, t // K5_BT]
    offs = t % K5_BT
    if kv8:
        row_err, _ = int8_row_steps(pool_k[:, bids, offs],
                                    pool_r[:, bids, offs])
        ok_row = row_err <= 1
    else:
        row_err, ok_row = close(pool_k[:, bids, offs], pool_r[:, bids, offs],
                                K2_ATOL, K2_RTOL)
    mask = torch.ones(pool.shape[1:3], dtype=torch.bool, device="cuda")
    mask[bids, offs] = False
    mask[0] = False
    untouched = bool(torch.equal(pool_k[:, mask], pool_r[:, mask]))
    # two launches agree bitwise on every mapped token and every block but
    # scratch: idle rows and tails past their blocks write scratch block 0
    # from several rows at once and read it back, so it holds no defined
    # value (as in K5)
    repeat = bool(torch.equal(xo[rr, jj], xo2[rr, jj])
                  and torch.equal(pool_k[:, 1:], pool_k2[:, 1:]))
    del pool_k2, xo2
    # whole slots of K1 tail rows, at most GROUP_ROWS tail rows a launch,
    # for each chunk of at most GROUP_ROWS tail tokens
    want_launches = sum(len(fd.row_groups(b, fd.GROUP_ROWS // (c1 - c0)))
                        for c0, c1 in fd.row_groups(K1, fd.GROUP_ROWS))
    ok = (ok_x and ok_row and untouched and repeat
          and launches == want_launches
          and bool(torch.isfinite(xo.float()).all()))
    res = {"arch": arch, "nkv": nkv, "L": L, "b": b, "K1": K1,
           "block_tokens": K5_BT, "blocks_per_row": K5_MB,
           "positions": positions, "mapped_blocks": nmap,
           "mapped_tokens": len(mapped), "launches": launches,
           "max_abs_err": err, "row_max_abs_err": row_err,
           "rest_of_pool_unchanged": untouched,
           "two_launches_bitwise_equal": repeat, "atol": K2_ATOL,
           "rtol": K2_RTOL, "ok": ok}
    if w8 or kv8:
        res.update(int8_weights=w8, int8_pool=kv8)
    if x32 is not None:
        ref = x32[rr, jj]
        res["vs_fp32"] = {
            "kernel": (xo[rr, jj].float() - ref).abs().max().item(),
            "plain_bf16": (xr[rr, jj].float() - ref).abs().max().item()}
        if x_vs_fp32:
            v = res["vs_fp32"]
            res["x_out_held_to_fp32"] = True
            res["ok"] = (ok_row and untouched and repeat
                         and launches == want_launches
                         and bool(torch.isfinite(xo.float()).all())
                         and v["kernel"] <= v["plain_bf16"] + K2_ATOL)
    return res


def k7_vs_k5(fd, rope, gen, nkv=32, L=2, fp32=False):
    """An all-accepted K7 step against K1 sequential K5 steps over a clone
    of the same pool: token j's x_out against K5's step at pos + j, and
    the appended rows. Sums run in other orders (K7's products over 40
    rows, K5's over 8, split differently; K7's attention on tensor cores),
    so the bound is K2's tolerance, per token. With `fp32`, each token's
    x_out of both kernels is also compared with the plain verify in fp32
    (weights, pool and x upcast): which of the two strays from the exact
    function, and by how much."""
    h, nh, hd, ffn = 4096, 32, 128, 11008
    K1 = K7_K1
    positions = [1037, 126, 700, 3, 200, 5, 1900, 1500]
    idle = (3,)
    b = len(positions)
    nmap = [0 if r in idle else (p + K1 - 1) // K5_BT + 1
            for r, p in enumerate(positions)]
    params = fused_params(gen, L, h, nh, nkv, hd, ffn)
    pool, tables = k7_pool(gen, L, 2 * nkv * hd, nmap)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    c, s = k7_rope(rope, hd, positions, K1)
    x = rand((b, K1, h), gen)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    x32 = None
    if fp32:
        x32, _ = fd.fused_paged_verify_reference(
            x.float(), {k: v.float() for k, v in params.items()},
            pool.float(), tables, pos, c, s, **kw)
    pool7 = pool.clone()
    x7, _ = fd.fused_paged_verify_cuda(x, params, pool7, tables, pos, c, s,
                                       **kw)
    active = [r for r in range(b) if r not in idle]
    per_token, ok = [], True
    for j in range(K1):
        pj = pos + j
        x5, pool = fd.fused_paged_decode_cuda(
            x[:, j].contiguous(), params, pool, tables, pj,
            c[:, j].contiguous(), s[:, j].contiguous(), **kw)
        torch.cuda.synchronize()
        err, ok_j = close(x7[active, j], x5[active], K2_ATOL, K2_RTOL)
        t = pj.long()[active]
        bids = tables.long()[active, t // K5_BT]
        row_err, ok_r = close(pool7[:, bids, t % K5_BT],
                              pool[:, bids, t % K5_BT], K2_ATOL, K2_RTOL)
        per_token.append({"j": j, "x_out_max_abs_diff": err,
                          "appended_row_max_abs_diff": row_err})
        if x32 is not None:
            ref = x32[active, j]
            per_token[-1].update(
                k7_vs_fp32=(x7[active, j].float() - ref).abs().max().item(),
                k5_vs_fp32=(x5[active].float() - ref).abs().max().item())
        ok &= ok_j and ok_r
    return {"nkv": nkv, "L": L, "b": b, "K1": K1, "positions": positions,
            "idle_rows": list(idle), "per_token": per_token,
            "x_out_absmax": x7[active].float().abs().max().item(),
            "atol": K2_ATOL, "rtol": K2_RTOL, "ok": ok}


def k7_wide(seed, b=16):
    """b slots at drawn positions whose tails lie in their mapped blocks,
    the last slot idle: (positions, nmap)."""
    r = np.random.RandomState(seed)
    positions = [int(p) for p in r.randint(0, K5_BT * K5_MB - K7_K1, b)]
    nmap = [(p + K7_K1 - 1) // K5_BT + 1 for p in positions]
    nmap[-1] = 0
    return positions, nmap


#: phase k7's edge rows: row 1 straddles a block boundary (126..130), row 3
#: is idle, row 4's tail runs past its last mapped block (254..258 with 2
#: blocks), row 6 past the table itself (2045..2049, blocks 16 and beyond:
#: scratch)
K7_EDGES = ([1037, 126, 700, 3, 254, 5, 2045, 1500],
            [9, 2, 6, 0, 2, 1, K5_MB, 12])


#: phase k7's long tails: K1 = 64 (the most one launch takes) and 100 (two
#: chunks), from these positions
K7_LONG_TAILS = (64, 100)
K7_LONG_POS = [1037, 126, 700, 300]


def k7_int8_cases(fd, rope, arch, w8, kv8, seed):
    """One int8 mode of K7 against its plain version: 8 slots × 5 tail rows
    over phase k7's edge rows, 16 slots (two launches) at drawn positions,
    and 8 slots whose tails start at the chunk edges EDGE_POS (511..515
    and 1023..1027 cross a chunk boundary); two launches bitwise equal
    each. With an int8 pool the edge rows and the chunk edges run one
    layer, as phase k2q's int8 edges: their tails start at
    positions 3 and 5, where a tail token attends to a handful of keys
    among its own tail's appends, and over two layers the appends of
    layer 1, quantized from x that carries bf16 noise, land one int8 step
    apart and move x_out past K2's tolerance (on an H100: 0.0625 at a value
    below 1.6, bf16 weights); the two-layer edge case
    still runs, reported with K7's and the bf16 plain version's distance
    from the fp32 plain verify. Returns (cases, reported or None)."""
    g = wide_gen(seed)
    nkv = 16 if arch == "gpt" else 32
    kw = dict(arch=arch, w8=w8, kv8=kv8)
    le = 1 if kv8 else 2
    chunk = [(p + K7_K1 - 1) // K5_BT + 1 for p in EDGE_POS]
    cases = [k7_case(fd, rope, g, nkv, *K7_EDGES, L=le, **kw),
             k7_case(fd, rope, g, 16 if arch == "gpt" else 8,
                     *k7_wide(seed), **kw),
             k7_case(fd, rope, g, nkv, list(EDGE_POS), chunk, L=le, **kw)]
    report = (k7_case(fd, rope, g, nkv, *K7_EDGES, fp32=True, **kw)
              if kv8 else None)
    return cases, report


def phase_k7(fd, rope, gen, int8_errs):
    """K7 at Llama-2-7B width, 2 layers, b=8 x a 5-token tail over phase
    k7's edge cases, MHA and GQA; then 16 slots (80 tail rows: two launches
    of whole slots) at drawn positions; then all-accepted against 5
    sequential K5 steps; then the llama int8 modes (`k7_int8_cases`),
    each mode's largest x_out error into int8_errs."""
    positions, nmap = K7_EDGES
    cases = [k7_case(fd, rope, gen, 32, positions, nmap),
             k7_case(fd, rope, gen, 8, positions, nmap)]
    cases.append(k7_case(fd, rope, wide_gen(25), 32, *k7_wide(300)))
    # tails of 64 tokens (one slot a launch) and 100 (two chunks of 50,
    # the second over the first's appends), GQA: four slots over 2 layers;
    # a tail from position 3 over 1 layer, and over 2 layers held to the
    # fp32 plain verify (its tokens attend mostly to the tail's own
    # appends, whose layer-1 keys carry layer 0's bf16 rounding: there K7
    # and the bf16 plain verify both stray ~0.13 from the fp32 one, past
    # K2's tolerance, on an H100)
    nmap_of = lambda pos, k1: [(p + k1 - 1) // K5_BT + 1 for p in pos]
    for k1 in K7_LONG_TAILS:
        g = wide_gen(27 + k1)
        cases += [
            k7_case(fd, rope, g, 8, K7_LONG_POS, nmap_of(K7_LONG_POS, k1),
                    K1=k1),
            k7_case(fd, rope, g, 8, [3, 900], nmap_of([3, 900], k1), L=1,
                    K1=k1),
            k7_case(fd, rope, g, 8, [3, 126], nmap_of([3, 126], k1), K1=k1,
                    fp32=True, x_vs_fp32=True)]
    seq = k7_vs_k5(fd, rope, gen)
    runs = {name: k7_int8_cases(fd, rope, arch, w8, kv8, 50 + i)
            for i, (name, _, arch, w8, kv8) in enumerate(PAGED_INT8_MODES)
            if arch == "llama"}
    int8 = {name: cs for name, (cs, _) in runs.items()}
    emit({"phase": "k7", "cases": cases, "vs_k5_sequential": seq,
          "int8": int8, "int8_two_layer_edges_reported":
              {name: rep for name, (_, rep) in runs.items() if rep}})
    cases += [c for cs in int8.values() for c in cs]
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K7 disagrees with its plain version: {bad}")
    for name, cs in int8.items():
        int8_errs[name] = max(c["max_abs_err"] for c in cs)
    if not seq["ok"]:
        raise AssertionError(f"K7 disagrees with sequential K5 steps: {seq}")
    return max(c["max_abs_err"] for c in cases)


def phase_k7g(fd, rope, gen, int8_errs):
    """K7's gpt mode at GPT-2 345M width, 2 layers, b=8 × a 5-token tail,
    with phase k7's edge cases (a tail across a block boundary, an idle
    row, tails past the last mapped block and past the table), then 16
    slots (two launches) at drawn positions; then the int8 pool
    (`k7_int8_cases`), its error into int8_errs."""
    cases = [k7_case(fd, rope, gen, 16, *K7_EDGES, arch="gpt"),
             k7_case(fd, rope, wide_gen(26), 16, *k7_wide(301),
                     arch="gpt")]
    int8, report = k7_int8_cases(fd, rope, "gpt", False, True, 53)
    emit({"phase": "k7g", "cases": cases, "int8_pool": int8,
          "int8_two_layer_edges_reported": report})
    cases += int8
    int8_errs["gpt_int8kv"] = max(c["max_abs_err"] for c in int8)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K7 (gpt) disagrees with its plain version: "
                             f"{bad}")
    return max(c["max_abs_err"] for c in cases)


# ---- K6 -----------------------------------------------------------------------

# K6's router reads xn2 = bf16(rms(x)·ln2). Where the kernel's and the plain
# version's x differ by their bf16 noise, a router logit moves by ~0.02 ·
# √h · |Δxn2|, and a row whose k-th and (k+1)-th expert are that close
# swaps them; its x then moves by O(1/k) of an expert's output, so rows are
# compared only up to their first swap. A swap is allowed where the
# kernel's expert set is the plain top-(k+1) less one (the two at the
# boundary traded places) and the plain probability gap there is below the
# bound: after 2 layers the x noise is ~1e-4 (router-logit noise ~1e-3,
# probability-gap noise ~1e-4 at probabilities ~0.05), so 2e-3 leaves 20×;
# after 28 layers the logit noise reaches ~1e-2 of the model's logits
# (E2E_ATOL's 0.1 at the worst of 102400), so 1e-2. A wrong kernel gives
# sets outside the plain top-(k+1), or swaps at gaps of O(0.01–0.1).
K6_FLIP_GAP = 2e-3
K6_FLIP_GAP_DEEP = 1e-2

K6_WIDTHS = {
    # DeepSeekMoE-16B: MHA, 64 experts of 1408, top-6, 2 shared (2816)
    "deepseek_moe_16b": dict(h=2048, nh=16, nkv=16, hd=128, E=64, k=6,
                             f=1408, fs=2816),
    # Mixtral-8x7B: GQA 32/8, 8 experts of 14336, top-2, no shared
    "mixtral_8x7b": dict(h=4096, nh=32, nkv=8, hd=128, E=8, k=2, f=14336,
                         fs=0),
}


def moe_params(gen, L, h, nh, nkv, hd, E, k, f, fs):
    p = fused_params(gen, L, h, nh, nkv, hd, 8)
    for n in ("wg", "wu", "wd"):
        del p[n]
    p.update(gate=rand((L, E, h), gen, 0.02), weg=rand((L, E, h, f), gen, 0.02),
             weu=rand((L, E, h, f), gen, 0.02),
             wed=rand((L, E, f, h), gen, 0.02))
    if fs:
        p.update(wsg=rand((L, h, fs), gen, 0.02),
                 wsu=rand((L, h, fs), gen, 0.02),
                 wsd=rand((L, fs, h), gen, 0.02))
    return p


def compare_routing(kr, pr, gap_tol):
    """Per row: the first layer whose expert set differs between the
    kernel's routing `kr` and the plain `pr` (None: never), and whether
    that swap is allowed (see K6_FLIP_GAP)."""
    kid = kr["ids"].long().cpu()
    pid = pr["ids"].long().cpu()
    L, b, _ = pid.shape
    rows = []
    for r in range(b):
        diff = [l for l in range(L) if set(kid[l, r].tolist())
                != set(pid[l, r].tolist())]
        if not diff:
            rows.append({"row": r, "first_swap_layer": None, "ok": True})
            continue
        l = diff[0]
        plus = set(pid[l, r].tolist()) | {int(pr["next"][l, r])}
        gap = float(pr["gap"][l, r])
        boundary = set(kid[l, r].tolist()) <= plus
        rows.append({"row": r, "first_swap_layer": l, "plain_gap": gap,
                     "boundary_swap": boundary, "gap_tol": gap_tol,
                     "ok": boundary and gap < gap_tol})
    return rows


def k6_case(fd, rope, gen, width, params, b, same_rows=False, strict=False,
            L=2, S=1152, pos=1056, kv8=False):
    """K6 against its plain version on one input; kv8: over an int8 cache
    (its lane scales from the filled prefix), the appended int8 rows held
    within one int8 step, as phase k2q holds K2's."""
    w = K6_WIDTHS[width]
    nh, nkv, hd, k = w["nh"], w["nkv"], w["hd"], w["k"]
    dkv = nkv * hd
    kv = torch.zeros((L, b, S, 2 * dkv), dtype=torch.bfloat16, device="cuda")
    kv[:, :, :pos] = rand((L, b, pos, 2 * dkv), gen)
    x = rand((b, w["h"]), gen)
    if same_rows:       # every row the same: one expert slot serves all b
        kv[:, 1:] = kv[:, :1]
        x[1:] = x[:1]
    scales = None
    if kv8:
        kv, scales = fd.quantize_kv_cache(kv, nkv)
        kv[:, :, pos:] = 0
    cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, top_k=k,
              kv_scales=scales)
    kr, kr2, pr = {}, {}, {}
    kv_k, kv_k2 = kv.clone(), kv.clone()
    xo, _ = fd.fused_decode_moe_cuda(x, params, kv_k, pos, c, s, routing=kr,
                                     **kw)
    xo2, _ = fd.fused_decode_moe_cuda(x, params, kv_k2, pos, c, s,
                                      routing=kr2, **kw)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(xo, xo2) and torch.equal(kv_k, kv_k2)
                  and torch.equal(kr["ids"], kr2["ids"])
                  and torch.equal(kr["w"], kr2["w"]))
    del kv_k2
    xr, kv_r = fd.fused_decode_reference(x, params, kv, pos, c, s,
                                         arch="moe", routing=pr, **kw)
    rows = compare_routing(kr, pr, K6_FLIP_GAP)
    kept = [r["row"] for r in rows if r["first_swap_layer"] is None]
    err, ok_x = close(xo[kept], xr[kept], K2_ATOL, K2_RTOL) if kept \
        else (0.0, True)
    # the append of layer l follows the routing of layers < l
    app_err, ok_app = 0.0, True
    for r in rows:
        lim = L if r["first_swap_layer"] is None else r["first_swap_layer"] + 1
        ka, ra = kv_k[:lim, r["row"], pos], kv_r[:lim, r["row"], pos]
        if kv8:     # in int8 steps
            e = int((ka.int() - ra.int()).abs().max())
            o = e <= 1
        else:
            e, o = close(ka, ra, K2_ATOL, K2_RTOL)
        app_err, ok_app = max(app_err, e), ok_app and o
    untouched = bool(torch.equal(kv_k[:, :, :pos], kv_r[:, :, :pos])
                     and torch.equal(kv_k[:, :, pos + 1:],
                                     kv_r[:, :, pos + 1:]))
    ids = kr["ids"].long()
    distinct = [len(set(ids[l].flatten().tolist())) for l in range(L)]
    swaps = sum(r["first_swap_layer"] is not None for r in rows)
    ok = (ok_x and ok_app and untouched and repeat
          and all(r["ok"] for r in rows)
          and bool(torch.isfinite(xo.float()).all())
          and (not strict or swaps == 0)
          and (not same_rows or distinct == [k] * L))
    return {"width": width, "b": b, "L": L, "S": S, "pos": pos,
            "int8_kv": kv8,
            "launches_per_step": len(fd.row_groups(
                b, min(fd.MOE_MAX_ROWS, fd.MOE_MAX_PAIRS // k))),
            "same_rows": same_rows, "strict": strict,
            "gate_scale": 8.0 if strict else 1.0,
            "distinct_experts_per_layer": distinct,
            "rows_swapped": swaps, "routing": rows,
            "max_abs_err": err,
            ("row_max_int8_steps" if kv8 else "row_max_abs_err"): app_err,
            "rest_of_cache_unchanged": untouched,
            "two_launches_bitwise_equal": repeat, "atol": K2_ATOL,
            "rtol": K2_RTOL, "ok": ok}


def phase_k6(fd, rope, gen):
    """K6 against its plain version at both widths, 2 layers, b=1 and b=4:
    random routing (the swap rule), one routing shared by all 4 rows, and
    the gate ×8 held strictly; then b=9 and b=16 (two launches of rows
    each, inputs from a generator of their own); at DeepSeekMoE-16B width
    also b=2 at the chunk edges EDGE_POS (S EDGE_S); then the int8 KV mode
    at b=1, 4 and 9 at both widths. Returns the largest |x_out − plain| of
    the bf16 cases and of the int8 ones."""
    cases = []
    wg = wide_gen(27)
    eg = wide_gen(34)
    qg = wide_gen(35)
    for width, w in K6_WIDTHS.items():
        params = moe_params(gen, 2, **w)
        cases.append(k6_case(fd, rope, gen, width, params, 1))
        cases.append(k6_case(fd, rope, gen, width, params, 4))
        cases.append(k6_case(fd, rope, gen, width, params, 4,
                             same_rows=True))
        cases += [k6_case(fd, rope, wg, width, params, b) for b in (9, 16)]
        cases += [k6_case(fd, rope, qg, width, params, b, kv8=True)
                  for b in (1, 4, 9)]
        if width == "deepseek_moe_16b":   # the attention half's chunk edges
            cases += [k6_case(fd, rope, eg, width, params, 2, S=EDGE_S,
                              pos=p) for p in EDGE_POS]
        params["gate"] = params["gate"] * 8      # exact in bf16
        cases.append(k6_case(fd, rope, gen, width, params, 4, strict=True))
        del params
        torch.cuda.empty_cache()
    emit({"phase": "k6", "flip_gap": K6_FLIP_GAP, "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version: {bad}")
    return (max(c["max_abs_err"] for c in cases if not c["int8_kv"]),
            max(c["max_abs_err"] for c in cases if c["int8_kv"]))


def wide_tokens(model, cpu, ids, new, fa, fd, counter, groups):
    """`generate` of `ids` on the card twice (the tokens must repeat) and
    on the CPU copy `cpu` of the same weights (the plain steps): launches
    of the fused step `counter` read around the first card run (`groups`
    a step) and K1 once a layer; rows whose tokens part from the CPU's
    must part at a near tie (`first_parting`)."""
    from paddle_tpu_torch.inference import generate
    b, n = ids.shape
    reset_counts(fa, fd)
    out = generate(model, ids, max_new_tokens=new)
    torch.cuda.synchronize()
    got = counts(fa, fd)
    again = generate(model, ids, max_new_tokens=new)
    ref = generate(cpu, ids, max_new_tokens=new)
    partings = [first_parting(cpu, ids[i], out[i, n:].cpu().numpy(),
                              ref[i, n:].cpu().numpy()) for i in range(b)]
    run = {"b": b, "launches_per_step": groups, "launches": got,
           "repeat_equal": bool(torch.equal(out, again)),
           "rows_equal_cpu": sum(q is None for q in partings),
           "first_parting": [q for q in partings if q is not None]}
    run["ok"] = (run["repeat_equal"]
                 and got[counter] == groups * (new - 1)
                 and got["flash_attention_fwd"] == model.cfg.num_layers
                 and all(q is None or q["near_tie"] for q in partings))
    return run


def wide_engine(fa, fd, model, cpu, slots, **engine_kw):
    """`slots` + 1 greedy requests through ServingEngine(max_slots=slots,
    **engine_kw) on the card and on the CPU copy: every slot busy at once,
    K5 in row_groups(slots, GROUP_ROWS) launches a tick, no leaked block,
    each request's tokens equal to the CPU engine's or parted at a near
    tie."""
    from paddle_tpu_torch.serving import Request, ServingEngine
    r = np.random.RandomState(slots)
    reqs = [(r.randint(0, model.cfg.vocab_size, int(n)), int(m)) for n, m in
            zip(r.randint(4, 24, slots + 1), r.randint(3, 9, slots + 1))]
    toks, stats = {}, {}
    for name, m in (("card", model), ("cpu", cpu)):
        eng = ServingEngine(m, max_slots=slots, block_tokens=16,
                            max_seq_len=64, device=m.device, **engine_kw)
        reset_counts(fa, fd)
        rids = [eng.submit(Request(p, max_new_tokens=n)) for p, n in reqs]
        eng.step()
        busy = eng.active_slots
        eng.drain(max_steps=400)
        got = counts(fa, fd)
        toks[name] = [eng.results[i].tokens.tolist() for i in rids]
        eng.prefix_cache.clear()
        stats[name] = {"busy": busy, "launches": got, "stats": dict(eng.stats),
                       "leaked": eng.pool.used_blocks}
        eng.close()
    partings = [first_parting(cpu, p, np.asarray(a), np.asarray(c))
                for (p, _), a, c in zip(reqs, toks["card"], toks["cpu"])]
    st = stats["card"]["stats"]
    groups = len(fd.row_groups(slots, fd.GROUP_ROWS))
    ok = (stats["card"]["busy"] == stats["cpu"]["busy"] == slots
          and [len(t) for t in toks["card"]] == [n for _, n in reqs]
          and stats["card"]["launches"]["fused_paged_decode_step"]
          == groups * (st["steps"] + st["replay_tokens"])
          and stats["card"]["leaked"] == 0
          and all(q is None or q["near_tie"] for q in partings))
    return {"slots": slots, "requests": len(reqs), "k5_launches_per_tick":
            groups, "card": stats["card"], "rows_equal_cpu":
            sum(q is None for q in partings),
            "first_parting": [q for q in partings if q is not None],
            "ok": ok}


def phase_wide(fa, fd):
    """Steps wider than one launch through the entry points, on tiny
    models at the kernels' head width (64), each against the same weights
    on the CPU (the plain steps) and run twice on the card:
      * Llama (h 256, 4 heads, 2 kv heads, 2 layers) `generate` at b = 65,
        prompt 16, 8 new tokens, greedy: K2 2 x 7 launches (33 + 32 rows);
      * the same model through ServingEngine(max_slots=65): K5 in two
        launches a tick;
      * a Mixtral (h 128, 2 heads of 64, 1 kv head, 8 experts of 96, top-2,
        2 shared experts, the gate x8 for decisive routing) with
        capacity_factor 4, so the fused plan's max_batch is 64 (no drops
        up to 64 rows), `generate` at b = 9 and 16: K6 2 x 7 launches
        (groups of at most MOE_MAX_ROWS rows).
    Tokens equal the CPU's, or part only at a near tie."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         MixtralConfig, MixtralForCausalLM)
    r = np.random.RandomState(16)

    def pair(cls, cfg, scale_gate=False):
        model = cls(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        state = model.state_dict(include_buffers=False)
        if scale_gate:
            for i in range(cfg.num_layers):
                key = f"model.layers.{i}.moe.gate.proj.weight"
                state[key] = state[key] * 8          # exact in bf16
            model.set_state_dict(state)
        cpu = cls(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
        cpu.set_state_dict({k: v.cpu() for k, v in state.items()})
        return model, cpu, state

    lcfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=4, num_kv_heads=2)
    model, cpu, _ = pair(LlamaForCausalLM, lcfg)
    llama = wide_tokens(model, cpu, r.randint(0, 256, (65, 16)), 8, fa, fd,
                        "fused_decode_step",
                        len(fd.row_groups(65, fd.GROUP_ROWS)))
    engine = wide_engine(fa, fd, model, cpu, 65)
    del model, cpu
    mcfg = dataclasses.replace(MixtralConfig.tiny(), hidden_size=128,
                               num_heads=2, num_kv_heads=1, num_experts=8,
                               num_shared_experts=2, capacity_factor=4.0)
    model, cpu, state = pair(MixtralForCausalLM, mcfg, scale_gate=True)
    plan = model.fused_decode_plan(state, probe=True)
    cap = min(fd.MOE_MAX_ROWS, fd.MOE_MAX_PAIRS // mcfg.top_k)
    moe = [wide_tokens(model, cpu, r.randint(0, mcfg.vocab_size, (b, 16)), 8,
                       fa, fd, "fused_decode_moe_step",
                       len(fd.row_groups(b, cap))) for b in (9, 16)]
    ok = (llama["ok"] and engine["ok"] and all(m["ok"] for m in moe)
          and plan is not None and plan["max_batch"] >= 16)
    res = {"phase": "wide", "llama_generate": llama, "llama_engine": engine,
           "moe_max_batch": None if plan is None else plan["max_batch"],
           "moe_generate": moe, "ok": ok}
    emit(res)
    if not ok:
        raise AssertionError(f"wide: {res}")
    del model, cpu
    gc.collect()


# ---- K3 / K4 ------------------------------------------------------------------

def k3_case(fa, gen, b, h, nkv, sq, sk, d, causal, kv_lens=None,
            q_off=None, window=None):
    """K3/K4 through the autograd Function against the plain backward on
    the kernel forward's (out, lse), and each launched twice with the same
    bits. With a window (K3's and K4's windowed instantiations, the forward
    K1's) also t0, the first key tile of the first query block, and, for
    a window at or above the visible span (off + sq keys, the most a row
    sees), the windowless launches' bits."""
    q = rand((b, sq, h, d), gen)
    k = rand((b, sk, nkv, d), gen)
    v = rand((b, sk, nkv, d), gen)
    do = rand((b, sq, h, d), gen)
    kl = None if kv_lens is None else torch.tensor(kv_lens, dtype=torch.int32,
                                                   device="cuda")
    kw = dict(is_causal=causal, kv_lens=kl, causal_offset=q_off)
    wkw = {} if window is None else {"window": window}
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, **kw, **wkw)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw, **wkw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.scaled_dot_product_attention(*leaves, **kw, window_size=window)
    o.backward(do)
    # K3 sums the key tiles and K4 the GQA heads in a fixed order without
    # atomics: two launches on the same inputs give the same bits
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq1 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw, **wkw)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw, **wkw)
    dk1, dv1 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw,
                                          **wkw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw,
                                          **wkw)
    torch.cuda.synchronize()
    bitwise3 = bool(torch.equal(dq1, dq2))
    bitwise4 = bool(torch.equal(dk1, dk2) and torch.equal(dv1, dv2))
    res = {"b": b, "h": h, "nkv": nkv, "sq": sq, "sk": sk, "d": d,
           "causal": causal, "kv_lens": kv_lens, "q_off": q_off,
           "tol_of_max_ref": K3_TOL, "k3_two_launches_bitwise": bitwise3,
           "k4_two_launches_bitwise": bitwise4,
           "ok": bitwise3 and bitwise4}
    if window is not None:
        off = sk - sq if q_off is None else q_off
        res.update(window=window, t0_first_block=max(0, off - window + 1)
                   // 64)
        if window >= off + sq:
            dq0 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk0, dv0 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  **kw)
            res["windowless_bitwise"] = bool(
                torch.equal(dq1, dq0) and torch.equal(dk1, dk0)
                and torch.equal(dv1, dv0))
            res["ok"] &= res["windowless_bitwise"]
    cancel = None
    if window == 1:
        cancel = cancel_noise(q, k, out, do)
        res["window1_cancel_noise"] = cancel
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        g = t.grad.float()
        err = (g - r).abs().max().item()
        tol = K3_TOL * r.abs().max().item()
        if cancel is not None and name != "dv":
            # dS = dP − Δ = 0 exactly: both sides hold fp32 noise
            tol = max(tol, cancel)
        res[name] = {"max_abs_err": err, "tol": tol,
                     "max_abs_ref": r.abs().max().item()}
        res["ok"] &= bool(err <= tol and torch.isfinite(g).all())
        if kv_lens is not None and 0 in kv_lens:
            res["ok"] &= not bool(t.grad[kv_lens.index(0)].any())
    return res


def cancel_noise(q, k, out, do):
    """Under a window of 1 each row sees only its own key: P = 1, O = V,
    and dS = P∘(dP − Δ) is 0 in exact arithmetic, dP = dO·V (the kernel's
    fp32 wgmma sums) and Δ = rowsum(dO∘O) (fp32, another order) cancelling.
    dq and dk are then that fp32 rounding noise on both sides, which no
    relative tolerance of their (≈ 0) size can hold: their bound is the
    noise of a d-term fp32 sum, d · 2^-22 · max Σ|dO∘O|, through scale ·
    max(|Q|, |K|) and the GQA group's n_rep terms. A wrong mask or fragment
    gives O(0.1) there."""
    d, n_rep = q.shape[-1], q.shape[2] // k.shape[2]
    terms = (do.float() * out.float()).abs().sum(-1).max().item()
    scale = 1.0 / math.sqrt(d)
    return (n_rep * d * 2.0 ** -22 * terms * scale
            * max(q.float().abs().max().item(), k.float().abs().max().item()))


def phase_k3(fa, gen):
    cases = [
        k3_case(fa, gen, 8, 16, 16, 1024, 1024, 64, True),     # training
        k3_case(fa, gen, 2, 32, 8, 1024, 1024, 128, True),     # GQA d=128
        k3_case(fa, gen, 2, 8, 8, 1000, 1000, 64, True),       # ragged
        k3_case(fa, gen, 2, 8, 2, 512, 700, 128, False),       # non-causal
        k3_case(fa, gen, 2, 8, 2, 384, 384, 64, True, [300, 0]),  # masked row
        # K4's edges: 64-query tiles streamed past 128-key blocks, sq and sk
        # off the tiles, an offset inside a key block, GQA 4 and 8
        k3_case(fa, gen, 2, 16, 4, 65, 333, 128, True, [333, 0], 200),
        k3_case(fa, gen, 2, 16, 2, 127, 200, 64, True, [150, 200], 50),
        k3_case(fa, gen, 2, 8, 1, 129, 129, 128, True),
        k3_case(fa, gen, 2, 8, 2, 1, 300, 64, True, None, 299),
        k3_case(fa, gen, 1, 8, 2, 200, 1000, 64, False, [777]),
    ]
    # K3's edges: 128-query blocks (64 rows a consumer group) past 64-key
    # tiles: sq 64 (the second group has no rows), sq 193, sk 65 (one key
    # in the last tile, a batch row of one key), a causal offset inside a
    # key tile, GQA 8 at d = 128. Their inputs come from a generator of
    # their own, so the later phases' inputs stay as they were.
    edge = torch.Generator(device="cuda")
    edge.manual_seed(3)
    cases += [
        k3_case(fa, edge, 2, 8, 2, 64, 300, 64, True, None, 100),
        k3_case(fa, edge, 1, 8, 2, 193, 260, 64, True, [197]),
        k3_case(fa, edge, 2, 4, 4, 64, 65, 128, True, [65, 1]),
        k3_case(fa, edge, 2, 8, 8, 300, 300, 64, True, None, 37),
        k3_case(fa, edge, 2, 16, 2, 256, 512, 128, True, None, 200),
        # train_llama's call
        k3_case(fa, edge, *LLAMA_TRAIN_ATTN, True),
    ]
    emit({"phase": "k3", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K3/K4 disagree with the plain backward: {bad}")
    return (max(c["dq"]["max_abs_err"] for c in cases),
            max(max(c["dk"]["max_abs_err"], c["dv"]["max_abs_err"])
                for c in cases))


# ---- K3 / K4's sliding window ----------------------------------------------------

def window_bwd_check(fa, q, k, v, do, window, kv_lens=None):
    """K1, K3 and K4 with the window at one shape, one kv-head group at a
    time (a whole 8192-row shape's fp32 scores would take 9 GB a
    temporary): K1's (out, lse) against its plain version
    (`k1_agreement`), then K3's and K4's gradients on that (out, lse)
    against the plain backward, within K3_TOL · max|plain| of the group;
    each kernel launched twice with the same bits."""
    b, s, h, d = q.shape
    nkv = k.shape[2]
    rep = h // nkv
    kw = dict(is_causal=True, kv_lens=kv_lens, window=window)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
    k1_bitwise = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
    del out2, lse2
    k1 = []
    for g in range(nkv):
        hs = slice(g * rep, (g + 1) * rep)
        k1.append(k1_agreement(out[:, :, hs], lse[:, hs],
                               *fa.flash_attention_fwd_plain(
                                   q[:, :, hs], k[:, :, g:g + 1],
                                   v[:, :, g:g + 1], **kw)))
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    res = {"shape_b_s_h_nkv_d": [b, s, h, nkv, d], "window": window,
           "k1": {"out_max_abs_err": max(c["max_abs_err"] for c in k1),
                  "lse_max_abs_err": max(c["lse_max_abs_err"] for c in k1),
                  "tol": K1_TOL_OUT, "lse_tol": K1_TOL_LSE,
                  "dead_rows": sum(c["dead_rows"] for c in k1),
                  "two_launches_bitwise": k1_bitwise,
                  "ok": k1_bitwise and all(c["ok"] for c in k1)},
           "tol_of_max_ref": K3_TOL,
           "k3_two_launches_bitwise": bool(torch.equal(dq, dq2)),
           "k4_two_launches_bitwise": bool(torch.equal(dk, dk2)
                                           and torch.equal(dv, dv2))}
    del dq2, dk2, dv2
    errs = {"dq": [], "dk": [], "dv": []}
    ok = (res["k1"]["ok"] and res["k3_two_launches_bitwise"]
          and res["k4_two_launches_bitwise"])
    for g in range(nkv):
        hs = slice(g * rep, (g + 1) * rep)
        ref = fa.flash_attention_bwd_plain(
            q[:, :, hs], k[:, :, g:g + 1], v[:, :, g:g + 1], out[:, :, hs],
            lse[:, hs], do[:, :, hs], **kw)
        for name, got, r in zip(("dq", "dk", "dv"),
                                (dq[:, :, hs], dk[:, :, g:g + 1],
                                 dv[:, :, g:g + 1]), ref):
            err = (got.float() - r).abs().max().item()
            tol = K3_TOL * r.abs().max().item()
            errs[name].append(err)
            ok &= bool(err <= tol and torch.isfinite(got.float()).all())
        del ref
    res.update({f"{n}_max_abs_err_by_group": e for n, e in errs.items()})
    res["max_abs_err"] = max(max(e) for e in errs.values())
    res["ok"] = ok
    return res


def window_bwd_timing(fa, gen, bw, flops, b, s, h, nkv, d, window):
    """K3's and K4's window mode at `train_mistral`'s attention shape:
    `window_bwd_check`, then CUDA events over each wrapper and its device
    time, the windowless kernels at the same shape, the plain backward
    (every kv-head group in turn), torch sdpa's forward plus backward over
    the dense window mask (kv heads repeated beforehand: `library_ms`), and
    each kernel's bound from this shape's visible pairs (K3 6·d FLOPs a
    pair, K4 8·d)."""
    q, do = rand((b, s, h, d), gen), rand((b, s, h, d), gen)
    k, v = rand((b, s, nkv, d), gen), rand((b, s, nkv, d), gen)
    check = window_bwd_check(fa, q, k, v, do, window)
    kw = dict(is_causal=True)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, window=window, **kw)
        out0, lse0 = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    delta0 = (do.float() * out0.float()).sum(-1).transpose(1, 2).contiguous()
    f3 = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                           window=window, **kw)
    f4 = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            window=window, **kw)
    g3 = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse0, delta0, **kw)
    g4 = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse0, delta0, **kw)
    ms = {name: time_ms(f, iters=10) for name, f in
          (("k3", f3), ("k4", f4), ("k3_windowless", g3),
           ("k4_windowless", g4))}
    dev = {"k3": device_ms(f3, iters=10), "k4": device_ms(f4, iters=10)}
    rep = h // nkv

    def plain():
        for g in range(nkv):
            hs = slice(g * rep, (g + 1) * rep)
            fa.flash_attention_bwd_plain(
                q[:, :, hs], k[:, :, g:g + 1], v[:, :, g:g + 1],
                out[:, :, hs], lse[:, hs], do[:, :, hs], window=window, **kw)

    plain_ms = time_ms(plain, iters=1, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(s, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - window))[None, None]
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (t.transpose(1, 2).repeat_interleave(rep, dim=1).detach()
              .requires_grad_(True) for t in (k, v))
    dot = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt), dot), iters=5)
    pairs = window_pairs(s, 0, window, s) * b * h
    t_bf, kv_bf, row = b * s * h * d * 2, b * s * nkv * d * 2, b * h * s * 4
    work = {"k3": (3 * t_bf + 2 * kv_bf + 2 * row, 6 * d * pairs),
            "k4": (2 * t_bf + 4 * kv_bf + 2 * row, 8 * d * pairs)}
    rows = {}
    for key, (nbytes, nflops) in work.items():
        tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
        rows[key] = {"ms": ms[key], "device_ms": dev[key],
                     "windowless_ms": ms[f"{key}_windowless"],
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": nbytes, "flops": nflops,
                     "tflops": nflops / ms[key] / 1e9,
                     "bound_share": max(tb, to) / ms[key]}
    return {"shape_b_s_h_nkv_d": [b, s, h, nkv, d], "window": window,
            "visible_pairs": pairs, **check, "kernels": rows,
            "plain_ms_covers": "flash_attention_bwd_plain with the window, "
                               "the kv-head groups in turn: dq, dk and dv",
            "library_covers": "torch sdpa forward + backward over the dense "
                              "bool window mask, kv heads repeated "
                              "beforehand"}


def phase_k3w(fa, gen, bw, flops):
    """K3's and K4's causal sliding window at the kernels' edges: windows
    1, 63, 64, 65, 127, 128, 129, 200, 512 and 4096 over 384 query rows at
    offset 700 (inside a 64-key tile; t0 inside the ring; query tiles
    straddling the window's lower edge and the diagonal; K4 key blocks
    that no query sees at window 1), a batch row whose kv_len ends early;
    GQA 4 and 8, d 64 and 128; a batch row of kv_len 0 (zero gradients);
    sq 64 (K3's second group without rows); bottom-right self-attention;
    windows at and above the visible span (the windowless kernels' bits);
    then the path's own shape (b 1, S 8192, 32 heads over 8, d 128, window
    4096) checked one kv-head group at a time and timed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(151)
    base = (2, 16, 4, 384, 1200, 128, True, [1100, 900], 700)
    cases = [k3_case(fa, g, *base, window=w)
             for w in (1, 63, 64, 65, 127, 128, 129, 200, 512, 4096)]
    gqa8 = (2, 16, 2, 300, 700, 64, True, [700, 0], 333)
    cases += [k3_case(fa, g, *gqa8, window=w) for w in (1, 64, 200, 4096)]
    for shape, w in (
            ((1, 8, 8, 1000, 1000, 128, True, None, None), 200),
            ((1, 32, 8, 2048, 2048, 128, True, None, None), 512),
            ((2, 8, 2, 64, 300, 64, True, None, 100), 37),
            ((2, 8, 2, 200, 260, 64, True, [260, 3], None), 260),
            ((2, 4, 4, 129, 129, 128, True, None, None), 129)):
        cases.append(k3_case(fa, g, *shape, window=w))
    path = window_bwd_timing(fa, g, bw, flops, *K3W_PATH)
    emit({"phase": "k3w", "cases": cases, "path_shape": path})
    bad = [c for c in cases if not c["ok"]]
    if bad or not path["ok"]:
        raise AssertionError(f"K3/K4's window mode disagrees with the plain "
                             f"backward: {bad}, path {path['ok']}")
    errs = (max(max(c["dq"]["max_abs_err"] for c in cases),
                max(path["dq_max_abs_err_by_group"])),
            max(max(max(c["dk"]["max_abs_err"], c["dv"]["max_abs_err"])
                    for c in cases),
                max(path["dk_max_abs_err_by_group"]
                    + path["dv_max_abs_err_by_group"])))
    return errs, path


# ---- K2's int8 modes, K8, K9 -------------------------------------------------------

def int8_llama_params(L, nkv):
    """Int8 stacks at Llama-2-7B width with L layers, as the int8 generate
    path gives them to K2: a random bf16 model (seed 0) through
    quantize_model and its fused decode plan."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = LlamaConfig(vocab_size=256, num_layers=L, num_kv_heads=nkv)
    model = quantize_model(LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                                            device="cuda", seed=0))
    state = model.state_dict(include_buffers=False)
    return model.fused_decode_plan(state)["params"]


def int8_rows(kv_k, kv_r, pos):
    """The appended int8 rows of kernel and plain version: (largest
    difference in int8 steps, lanes one step apart, lanes two steps
    apart)."""
    d = (kv_k[:, :, pos].int() - kv_r[:, :, pos].int()).abs()
    return int(d.max()), int((d == 1).sum()), int((d == 2).sum())


def k2q_case(fd, rope, gen, nkv, w8, kv8, arch="llama", L=2, b=4, S=1152,
             pos=1056, calib_all=False):
    """One int8 mode of K2 against its plain version: x_out at K2's
    tolerance, the appended row (int8: within one int8 step, the lanes one
    step apart counted; bf16: K2's tolerance), the rest of the cache
    unchanged, two launches bitwise equal. calib_all: the int8 cache's
    scales come from random rows at every position (the rows from pos on
    are then zeroed), not from the filled prefix alone, which at pos 0 is
    empty and leaves the floor scale 1e-8: an append then saturates to
    ±127 by its sign, and any x noise flips it."""
    w = WIDTHS[arch]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    params = int8_llama_params(L, nkv) if w8 else stack_params(gen, arch,
                                                                 L, nkv)
    kv = torch.zeros((L, b, S, 2 * nkv * hd), dtype=torch.bfloat16,
                     device="cuda")
    kv[:, :, :pos] = rand((L, b, pos, 2 * nkv * hd), gen)
    scales = None
    if kv8:
        src = kv
        if calib_all:
            src = kv.clone()
            src[:, :, pos:] = rand((L, b, S - pos, 2 * nkv * hd), gen)
        kv, scales = fd.quantize_kv_cache(src, nkv)
        kv[:, :, pos:] = 0
        del src
    x = rand((b, h), gen)
    c = s = None
    if arch != "gpt":
        cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch,
              kv_scales=scales)
    kv_k, kv_k2 = kv.clone(), kv.clone()
    xo, _ = fd.fused_decode_cuda(x, params, kv_k, pos, c, s, **kw)
    xo2, _ = fd.fused_decode_cuda(x, params, kv_k2, pos, c, s, **kw)
    repeat = bool(torch.equal(xo, xo2) and torch.equal(kv_k, kv_k2))
    del kv_k2
    torch.cuda.synchronize()
    xr, kv_r = fd.fused_decode_reference(x, params, kv, pos, c, s, **kw)
    err, ok_x = close(xo, xr, K2_ATOL, K2_RTOL)
    res = {"arch": arch, "int8_weights": w8, "int8_kv": kv8, "nkv": nkv,
           "L": L, "b": b, "S": S, "pos": pos, "max_abs_err": err}
    if kv8:
        steps, off, _ = int8_rows(kv_k, kv_r, pos)
        ok_row = steps <= 1
        res.update(row_max_int8_steps=steps, row_lanes_one_step_apart=off,
                   row_lanes=b * L * 2 * nkv * hd)
    else:
        row_err, ok_row = close(kv_k[:, :, pos], kv_r[:, :, pos], K2_ATOL,
                                K2_RTOL)
        res["row_max_abs_err"] = row_err
    untouched = bool(torch.equal(kv_k[:, :, :pos], kv_r[:, :, :pos])
                     and torch.equal(kv_k[:, :, pos + 1:], kv_r[:, :, pos + 1:]))
    ok = (ok_x and ok_row and untouched and repeat
          and bool(torch.isfinite(xo.float()).all()))
    res.update(rest_of_cache_unchanged=untouched,
               two_launches_bitwise_equal=repeat, atol=K2_ATOL, rtol=K2_RTOL,
               ok=ok)
    return res


#: the int8 sub-modes of K2 (Queue B row 4): (name, arch, int8 weights,
#: int8 KV)
K2Q_MODES = (("llama_int8w", "llama", True, False),
             ("llama_int8kv", "llama", False, True),
             ("llama_int8w_int8kv", "llama", True, True),
             ("gpt_int8kv", "gpt", False, True))


def phase_k2q(fd, rope, gen):
    """K2's int8 modes at Llama-2-7B width (MHA; both int8 modes also GQA
    nkv=8) and GPT-2 345M width (int8 KV), 2 layers, b=4, S 1152,
    pos 1056; then int8 weights at WIDE_ROWS rows (GQA, bf16 and int8 KV
    in turn); then the int8 cache at the chunk edges EDGE_POS (one layer,
    b=2, S EDGE_S, llama and gpt). Returns {mode: max |x_out - plain|}."""
    cases = {}
    for name, arch, w8, kv8 in K2Q_MODES:
        cases[name] = [k2q_case(fd, rope, gen, 16 if arch == "gpt" else 32,
                                w8, kv8, arch=arch)]
    cases["llama_int8w_int8kv"].append(k2q_case(fd, rope, gen, 8, True, True))
    # the engine's int8 path at every width: int8 weights, bf16 and int8 KV
    wg = wide_gen(24)
    for i, b in enumerate(WIDE_ROWS):
        name = "llama_int8w" if i % 2 == 0 else "llama_int8w_int8kv"
        cases[name].append(k2q_case(fd, rope, wg, 8, True, i % 2 == 1, b=b))
    # the int8 cache at the chunk edges (b=2, llama MHA and gpt), scales
    # from random rows at every position (see k2q_case), one layer: over
    # two, layer 1's appends are quantized from x that already carries bf16
    # noise, hundreds of lanes land one int8 step apart, and at positions 1
    # and 2 (one or two keys beside the append) that moves x_out past K2's
    # tolerance for the kernel this one replaced as well
    # (examples/torch_decode_accuracy.py --case int8kv)
    eg = wide_gen(33)
    for p in EDGE_POS:
        cases["llama_int8kv"].append(k2q_case(fd, rope, eg, 32, False, True,
                                              L=1, b=2, S=EDGE_S, pos=p,
                                              calib_all=True))
        cases["gpt_int8kv"].append(k2q_case(fd, rope, eg, 16, False, True,
                                            arch="gpt", L=1, b=2, S=EDGE_S,
                                            pos=p, calib_all=True))
    emit({"phase": "k2q", "cases": cases})
    bad = [c for cs in cases.values() for c in cs if not c["ok"]]
    if bad:
        raise AssertionError(f"K2's int8 modes disagree with their plain "
                             f"versions: {bad}")
    return {k: max(c["max_abs_err"] for c in cs) for k, cs in cases.items()}


#: K8's tolerances against the plain version. bf16: two bf16 ulp (2^-6
#: relative; one ulp is up to 2^-7 of the value): the fp32 normalised values
#: agree to a few fp32 ulp (rsqrtf, the sum's order) but may round to bf16
#: on either side of a boundary, and the weight product rounds that
#: one-ulp difference again. fp32: 1e-5 relative.
K8_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
#: H100 fp32 rate outside the tensor cores (the operations of K8)
FP32_FLOPS = 67e12


# ---- the int8 product engine, launched many times ------------------------------

#: phase int8_stress: the launches of each step after its first, the seconds
#: one launch may take before the phase reports a stall, and the layers
STRESS_LAUNCHES, STRESS_STALL_S, STRESS_LAYERS = 500, 30.0, 32


def watched(fn, n, fault):
    """fn() (it returns x_out) once and then n times more, each launch's
    x_out bitwise against the first's. After each launch the host polls an
    event for up to STRESS_STALL_S seconds. A launch that never completes
    (a ring stage waiting on a fill that never comes) cannot be
    synchronised, so fault(what) reports it and the process ends at once;
    a launch that fails is reported the same way and its error raised.
    Returns the launches whose x_out differed."""
    first = None
    differing = torch.zeros((), dtype=torch.int64, device="cuda")
    for i in range(n + 1):
        try:
            x = fn()
            if first is None:
                first = x.clone()
            else:
                differing += (x != first).any().to(torch.int64)
            ev = torch.cuda.Event()
            ev.record()
            t0 = time.perf_counter()
            while not ev.query():
                if time.perf_counter() - t0 > STRESS_STALL_S:
                    fault({"launch": i, "stalled_s": STRESS_STALL_S})
                    sys.stderr.flush()
                    os._exit(1)
                time.sleep(1e-4)
        except Exception as e:
            fault({"launch": i, "error": str(e).splitlines()[0]})
            raise
    return int(differing.item())


def phase_int8_stress(fd, rope):
    """The product engine's int8 path (the int8 weights of a quantized
    Llama-2-7B, STRESS_LAYERS layers, GQA 8) launched many times, each step
    STRESS_LAUNCHES times after its first under `watched`: K2 over an int8
    cache (position 600) at b = 8, 16 and 64 (the engine's N of 8, 16 and
    64: rings of 8, 7 and 4 stages), K5 over an int8 pool at 8 and 64 rows
    (16 and 4 blocks of 128 tokens a row), K7 over an int8 pool at 2 and 8
    rows × 5 tokens (N 16 and 64); every row active and every tail token
    mapped. Every launch's x_out must equal the first's bits, and none may
    stall or fail. Each step is timed by CUDA events (as the kernel table's
    rows are) before any is repeated."""
    L, nkv = STRESS_LAYERS, 8
    w = WIDTHS["llama"]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    dkv2 = 2 * nkv * hd
    params = int8_llama_params(L, nkv)
    g = wide_gen(60)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    steps = []   # (step, b, rows, a call of it)
    S, pos = 640, 600
    cos, sin = rope.rope_cos_sin(K5_BT * K5_MB, hd, device="cuda")
    for b in (8, 16, 64):
        kv = torch.zeros((L, b, S, dkv2), dtype=torch.bfloat16, device="cuda")
        kv[:, :, :pos] = rand((L, b, pos, dkv2), g)
        kv, sc = fd.quantize_kv_cache(kv, nkv)
        x = rand((b, h), g)
        steps.append(("fused_decode_step", b, b, functools.partial(
            fd.fused_decode_cuda, x, params, kv, pos, cos[pos:pos + 1],
            sin[pos:pos + 1], kv_scales=sc, **kw)))
    for b, mb in ((8, K5_MB), (64, 4)):   # 64 rows: a 4.3 GB bf16 pool
        positions = [int(p) for p in np.random.RandomState(b).randint(
            0, K5_BT * mb - 1, b)]
        pool, tables = k5_pool(g, L, dkv2, positions, mb=mb)
        pool, sc = int8_pool(fd, pool, tables, nkv)
        p32 = torch.tensor(positions, dtype=torch.int32, device="cuda")
        x = rand((b, h), g)
        steps.append(("fused_paged_decode_step", b, b, functools.partial(
            fd.fused_paged_decode_cuda, x, params, pool, tables, p32,
            cos.index_select(0, p32), sin.index_select(0, p32),
            kv_scales=sc, **kw)))
    for b in (2, 8):
        positions = [int(p) for p in np.random.RandomState(b).randint(
            0, K5_BT * K5_MB - K7_K1, b)]
        pool, tables = k7_pool(g, L, dkv2, [K5_MB] * b)
        pool, sc = int8_pool(fd, pool, tables, nkv)
        p32 = torch.tensor(positions, dtype=torch.int32, device="cuda")
        x = rand((b, K7_K1, h), g)
        steps.append(("fused_paged_verify_step", b, b * K7_K1,
                      functools.partial(
                          fd.fused_paged_verify_cuda, x, params, pool,
                          tables, p32, *k7_rope(rope, hd, positions, K7_K1),
                          kv_scales=sc, **kw)))
    # every step timed before any is repeated: a tree whose engine faults
    # under repetition still reports its times
    cases = [{"step": step, "b": b, "rows": rows,
              "ms": time_ms(lambda: fn()[0], iters=20)}
             for step, b, rows, fn in steps]
    for case, (step, b, _, fn) in zip(cases, steps):
        def fault(what):
            emit({"phase": "int8_stress", "layers": L, "nkv": nkv,
                  "cases": cases, "fault": dict(what, step=step, b=b)})
        case["differing_launches"] = watched(lambda: fn()[0],
                                             STRESS_LAUNCHES, fault)
        case.update(launches=STRESS_LAUNCHES + 1,
                    ok=case["differing_launches"] == 0)
    del steps, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "int8_stress", "layers": L, "nkv": nkv, "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"the int8 product engine's launches differ: "
                             f"{bad}")


def phase_k8(gen, bw):
    """K8 (RMSNorm rows) against the plain rms_norm: the Llama-2-7B
    prefill shape (4·1024, 4096) bf16 with and without the weight, and an
    fp32 case; timed at the prefill shape beside its byte bound, the plain
    version and torch.nn.functional.rms_norm."""
    from paddle_tpu_torch.ops import rms_norm as rn
    cases = []
    for shape, dtype in (((4 * 1024, 4096), torch.bfloat16),
                         ((1024, 8192), torch.bfloat16),
                         ((3, 300, 1024), torch.float32)):
        x = rand(shape, gen, 2.0, dtype)
        w = (1.0 + rand((shape[-1],), gen, 0.1, torch.float32)).to(dtype)
        for weight in (w, None):
            out = rn.rms_norm_cuda(x, weight, 1e-5)
            torch.cuda.synchronize()
            ref = rn.rms_norm(x, weight, 1e-5)
            err, ok = close(out, ref, 1e-6, K8_RTOL[dtype])
            cases.append({"shape": list(shape), "dtype": str(dtype),
                          "weight": weight is not None, "max_abs_err": err,
                          "rtol": K8_RTOL[dtype], "ok": ok})
    x = rand((4 * 1024, 4096), gen, 2.0)
    w = (1.0 + rand((4096,), gen, 0.1, torch.float32)).bfloat16()
    n0 = rn.rms_norm_cuda.launches
    k8 = lambda: rn.rms_norm_cuda(x, w, 1e-5)
    # the wrapper's checks and ctypes call take about as long on the host as
    # the kernel on the card, so CUDA events around back-to-back calls time
    # the host: the row's times are the kernels' device time, the events'
    # times are kept beside them
    event_ms = time_ms(k8, iters=50, warmup=5)
    ms = device_ms(k8, iters=50, warmup=5)
    rn.rms_norm_cuda.launches = n0
    plain = time_ms(lambda: rn.rms_norm(x, w, 1e-5), iters=20)
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    lib_event = lib = None
    if lib_fn is not None:
        lib_call = lambda: lib_fn(x, (4096,), w, 1e-5)
        lib_event = time_ms(lib_call, iters=50, warmup=5)
        lib = device_ms(lib_call, iters=50, warmup=5)
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    nops = 5 * x.numel()        # square-add, scale, round, weight, round
    tb, to = nbytes / bw * 1e3, nops / FP32_FLOPS * 1e3
    row = {"name": "rms_norm", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/rms_norm.cu",
           "replaces": "paddle_tpu/ops/rms_norm.py:35",
           "max_abs_err": max(c["max_abs_err"] for c in cases
                              if c["dtype"] == str(torch.bfloat16)),
           "ms": ms, "plain_ms": plain, "bound_ms": max(tb, to),
           "bound_by": "bytes" if tb >= to else "operations",
           "library_ms": lib, "library": "torch.nn.functional.rms_norm",
           "ms_is": "device time (device_ms), one-pass kernel",
           "event_ms": event_ms, "library_event_ms": lib_event,
           "plain_ms_is": "CUDA events",
           "at_shape": {"rows": 4 * 1024, "d": 4096, "dtype": "bfloat16",
                        "weight": True},
           "bytes": nbytes}
    emit({"phase": "k8", "cases": cases, "timing": row})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K8 disagrees with its plain version: {bad}")
    return row


def phase_k9(fd, bw):
    """K9 (the shared-memory probe): the probe equals the device's opt-in
    shared memory per block, a launch one step above it is refused, and
    every dynamic shared-memory request of the kernels at the smoke's
    shapes fits it. Its plain version is the device attribute read through
    PyTorch."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import smem_probe as sp
    dev = torch.device("cuda", torch.cuda.current_device())
    props = torch.cuda.get_device_properties(dev)
    torch_optin = getattr(props, "shared_memory_per_block_optin", None)
    got = sp.probe_usable_smem_bytes(dev)
    over_refused = not sp.smem_probe_cuda(got + sp.STEP, dev)
    requests = {}
    for hd in (64, 128):
        for kv8 in (0, 1):
            requests[f"attention hd{hd}{' int8' if kv8 else ''}"] = \
                fd.dynamic_smem_bytes("attention", hd, kv8)
        requests[f"verify_attention hd{hd}"] = fd.dynamic_smem_bytes(
            "verify_attention", hd)
    for mt in (1, 2, 3, 4):
        requests[f"tensor_core_gemm mt{mt}"] = fd.dynamic_smem_bytes(
            "tensor_core_gemm", mt)
    for n in (8, 16, 32, 64):
        for w8 in (0, 1):
            requests[f"product_engine n{n}{' int8' if w8 else ''}"] = \
                fd.dynamic_smem_bytes("product_engine", n, w8)
    too_big = {k: v for k, v in requests.items() if not 0 < v <= got}
    out = torch.zeros((2, 4), device=dev)
    lib = sp._lib()
    launch = lambda: lib.smem_probe(_build.ptr(out), got,
                                    _build.stream_of(out))
    ms = time_ms(launch, iters=20)
    plain = time_ms(lambda: torch.cuda.get_device_properties(dev), iters=20)
    nbytes = 2 * 16
    res = {"phase": "k9", "kind": torch.cuda.get_device_name(dev),
           "probe_bytes": got, "torch_shared_memory_per_block_optin":
           torch_optin, "step": sp.STEP, "one_step_over_refused": over_refused,
           "requests": requests, "largest_request": max(requests.values()),
           "requests_over_budget": too_big}
    emit(res)
    if not (over_refused and not too_big
            and (torch_optin is None or got == torch_optin)):
        raise AssertionError(f"k9: {res}")
    return {"name": "smem_probe", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/smem_probe.cu",
            "replaces": "paddle_tpu/ops/vmem_probe.py:32",
            "max_abs_err": 0 if torch_optin in (None, got) else
            abs(got - torch_optin),
            "ms": ms, "plain_ms": plain, "bound_ms": nbytes / bw * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "plain_is": "torch.cuda.get_device_properties (host)",
            "probe_bytes": got}


# ---- end to end ---------------------------------------------------------------

B, PROMPT, NEW = 4, 1024, 64


def reset_counts(fa, fd):
    from paddle_tpu_torch.ops import dropout, rms_norm, smem_probe
    dropout.dropout_cuda.launches = 0
    rms_norm.rms_norm_cuda.launches = 0
    smem_probe.smem_probe_cuda.launches = 0
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        w.launches = w.masked = 0
    fa.dead_row_sums.launches = 0
    dropout.attention_keep_words.launches = 0
    fd.fused_decode_cuda.launches = 0
    fd.fused_paged_decode_cuda.launches = 0
    fd.fused_paged_verify_cuda.launches = 0
    fd.fused_decode_moe_cuda.launches = 0
    fd.fused_decode_moe_cuda.int8_kv = 0


def counts(fa, fd):
    from paddle_tpu_torch.ops import dropout, rms_norm, smem_probe
    return {"dropout": dropout.dropout_cuda.launches,
            "rms_norm": rms_norm.rms_norm_cuda.launches,
            "smem_probe": smem_probe.smem_probe_cuda.launches,
            "flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "dead_row_sums": fa.dead_row_sums.launches,
            "attention_keep_words": dropout.attention_keep_words.launches,
            "fused_decode_step": fd.fused_decode_cuda.launches,
            "fused_paged_decode_step": fd.fused_paged_decode_cuda.launches,
            "fused_paged_verify_step": fd.fused_paged_verify_cuda.launches,
            "fused_decode_moe_step": fd.fused_decode_moe_cuda.launches}


def phase_e2e(fa, fd):
    from paddle_tpu_torch.inference import generate, prefill
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import rope

    cfg = LlamaConfig.llama2_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), device="cuda",
                        generator=gen)
    runs = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, top_p=0.9,
                                      seed=7))):
        torch.cuda.synchronize()
        reset_counts(fa, fd)
        t0 = time.perf_counter()
        out = generate(model, ids, max_new_tokens=NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        new = out[:, PROMPT:]
        if got != {"dropout": 0, "rms_norm": 0, "smem_probe": 0,
                   "dead_row_sums": 0,
                   "attention_keep_words": 0,
                   "flash_attention_fwd": cfg.num_layers,
                   "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                   "fused_decode_step": NEW - 1,
                   "fused_paged_decode_step": 0,
                   "fused_paged_verify_step": 0,
                   "fused_decode_moe_step": 0}:
            raise AssertionError(f"{name}: launch counts {got}, expected "
                                 f"{cfg.num_layers} and {NEW - 1}")
        if tuple(out.shape) != (B, PROMPT + NEW) \
                or not torch.equal(out[:, :PROMPT], ids) \
                or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
            raise AssertionError(f"{name}: bad tokens {tuple(out.shape)}")
        runs[name] = {"wall_s": wall, "launches": got,
                      "first_tokens": new[:, :8].tolist()}
        if name == "greedy":
            greedy_new = new
    # K2's int8-KV mode (bf16 weights) through generate, once, greedy
    reset_counts(fa, fd)
    t0 = time.perf_counter()
    out = generate(model, ids, max_new_tokens=NEW, cache_dtype=torch.int8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(fa, fd)
    if got != runs["greedy"]["launches"] \
            or tuple(out.shape) != (B, PROMPT + NEW):
        raise AssertionError(f"greedy int8 cache: launch counts {got}, "
                             f"shape {tuple(out.shape)}")
    runs["greedy_int8_cache"] = {
        "wall_s": wall, "launches": got,
        "first_tokens": out[:, PROMPT:][:, :8].tolist(),
        "tokens_equal_bf16_cache": float(
            (out[:, PROMPT:] == greedy_new).float().mean())}
    reset_counts(fa, fd)

    # warm timings (the counted runs above were the first, cold, calls):
    # time to first token = generate with one new token (prefill, building
    # the fused plan, the first sample; no decode step); a decode step = the
    # rest of a greedy 64-token run, per step
    def wall(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=new)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ttft_s = min(wall(1) for _ in range(2))
    gen_s = wall(NEW)
    total = -(-(PROMPT + NEW) // 128) * 128
    with torch.inference_mode():
        prefill(model, ids, total, fused=True)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv = prefill(model, ids, total, fused=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError("prefill logits not finite")
        # one teacher-forced decode step, kernel path vs plain path
        state = model.state_dict(include_buffers=False)
        plan = model.fused_decode_plan(state)
        tok = torch.argmax(logits[:, -1], dim=-1)
        del logits
        pos = PROMPT
        cos, sin = rope.rope_cos_sin(total, cfg.head_dim, device="cuda")
        x = plan["embed"](tok, pos)
        kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
                  eps=cfg.rms_norm_eps)
        kv_plain = kv.clone()
        xk, kv = fd.fused_decode_cuda(x, plan["params"], kv, pos,
                                      cos[pos:pos + 1], sin[pos:pos + 1], **kw)
        lk = plan["head"](xk).float()
        xp, kv_plain = fd.fused_decode_reference(
            x, plan["params"], kv_plain, pos, cos[pos:pos + 1],
            sin[pos:pos + 1], **kw)
        lp = plan["head"](xp).float()
        logit_err, logits_ok = close(lk, lp, E2E_ATOL, E2E_RTOL)
        logit_absmax = lp.abs().max().item()
        argmax_agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        del kv_plain
    peak = torch.cuda.max_memory_allocated()
    decode_s = (gen_s - ttft_s) / (NEW - 1)
    res = {"phase": "e2e", "model": "llama2_7b", "layers": cfg.num_layers,
           "dtype": "bfloat16", "batch": B, "prompt": PROMPT, "new": NEW,
           "init_s": init_s, "runs": runs, "prefill_ms": prefill_s * 1e3,
           "ttft_ms": ttft_s * 1e3,
           "decode_ms_per_step": decode_s * 1e3,
           "generate_ms": gen_s * 1e3, "tokens_per_s": B * NEW / gen_s,
           "teacher_forced_logit_max_abs_err": logit_err,
           "teacher_forced_argmax_agree": argmax_agree,
           "logit_absmax": logit_absmax, "logit_atol": E2E_ATOL,
           "logit_rtol": E2E_RTOL,
           "max_memory_allocated": peak}
    emit(res)
    if not logits_ok:
        raise AssertionError(f"teacher-forced logits differ by {logit_err}")
    return model, plan, kv, runs["greedy"]["launches"], \
        runs["greedy_int8_cache"]["launches"]


# ---- timing -----------------------------------------------------------------

def phase_timing(fa, fd, model, plan, kv, bw, flops, launches, k1_err, k2_err):
    from paddle_tpu_torch.ops import rope
    cfg = model.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    b, h, d, sq, sk = B, cfg.num_heads, cfg.head_dim, PROMPT, kv.shape[2]
    q = rand((b, sq, h, d), gen)
    k = rand((b, sk, cfg.kv_heads, d), gen)
    v = rand((b, sk, cfg.kv_heads, d), gen)
    kl = torch.full((b,), sq, dtype=torch.int32, device="cuda")
    f1 = lambda: fa.flash_attention_fwd(q, k, v, is_causal=True,
                                        causal_offset=0, kv_lens=kl)
    ms1 = time_ms(f1, iters=20)
    plain1 = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, is_causal=True, causal_offset=0, kv_lens=kl), iters=3,
        warmup=1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib1 = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=20)
    pairs = sum(min(sq, i + 1) for i in range(sq)) * b * h
    bytes1 = sum(t.numel() * t.element_size() for t in (q, k, v, q)) \
        + b * h * sq * 4
    flops1 = 4 * d * pairs
    t_bytes1, t_ops1 = bytes1 / bw * 1e3, flops1 / flops * 1e3

    pos = PROMPT + 32
    cos, sin = rope.rope_cos_sin(kv.shape[2], cfg.head_dim, device="cuda")
    x = rand((b, cfg.hidden_size), gen)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
              eps=cfg.rms_norm_eps)
    f2 = lambda: fd.fused_decode_cuda(x, plan["params"], kv, pos,
                                      cos[pos:pos + 1], sin[pos:pos + 1], **kw)
    ms2 = time_ms(f2, iters=20)
    plain2 = time_ms(lambda: fd.fused_decode_reference(
        x, plan["params"], kv, pos, cos[pos:pos + 1], sin[pos:pos + 1], **kw),
        iters=2, warmup=1)
    L = cfg.num_layers
    wbytes = sum(t.numel() * t.element_size() for t in plan["params"].values())
    row = b * kv.shape[3] * kv.element_size()
    bytes2 = wbytes + L * row * (pos + 1) + L * row + 2 * x.numel() * 2
    flops2 = 2 * b * sum(t.numel() for t in plan["params"].values()) \
        + L * b * cfg.num_heads * 4 * cfg.head_dim * (pos + 1)
    t_bytes2, t_ops2 = bytes2 / bw * 1e3, flops2 / flops * 1e3
    # K2's int8-KV mode (bf16 weights) on the same step, over the cache
    # quantized as generate(cache_dtype=int8) quantizes it
    kvq, kv_sc = fd.quantize_kv_cache(kv, cfg.kv_heads)
    int8kv = time_k2_mode(fd, x, plan["params"], kvq, pos, cos[pos:pos + 1],
                          sin[pos:pos + 1], dict(kw, kv_scales=kv_sc), bw,
                          flops)
    del kvq
    head_bytes = model.lm_head.weight.numel() * 2
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:526",
         "launches": launches["flash_attention_fwd"], "max_abs_err": k1_err,
         "ms": ms1, "plain_ms": plain1, "bound_ms": max(t_bytes1, t_ops1),
         "bound_by": "bytes" if t_bytes1 >= t_ops1 else "operations",
         "library_ms": lib1, "tflops": flops1 / ms1 / 1e9,
         "library_tflops": flops1 / lib1 / 1e9,
         "bound_share": max(t_bytes1, t_ops1) / ms1},
        {"name": "fused_decode_step", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/fused_decode.cu",
         "replaces": "paddle_tpu/ops/fused_decode.py:555",
         "launches": launches["fused_decode_step"], "max_abs_err": k2_err,
         "ms": ms2, "plain_ms": plain2, "bound_ms": max(t_bytes2, t_ops2),
         "bound_by": "bytes" if t_bytes2 >= t_ops2 else "operations",
         "library_ms": None, "int8": {"llama_int8kv": int8kv}},
    ]
    emit({"phase": "timing", "k1_shape": [b, sq, h, d, sk],
          "k2_pos": pos, "k2_bytes": bytes2, "k1_flops": flops1,
          "decode_step_bound_ms_with_lm_head": (bytes2 + head_bytes) / bw * 1e3,
          "kernels": kernels})
    return kernels


# ---- serving ------------------------------------------------------------------

SERVE = dict(max_slots=8, block_tokens=128, max_seq_len=2048)
PREFIX = 256


def serve_requests(vocab, max_prompt=1000, n=16, seed=0):
    """n requests from `seed`: n/2 behind a shared 256-token prefix
    (prompts 300–max_prompt tokens), n/2 without (100–max_prompt); 16–96
    new tokens each."""
    r = np.random.RandomState(seed)
    prefix = r.randint(0, vocab, PREFIX)
    shared, other = [], []
    for _ in range(n // 2):
        n_tok = r.randint(300, max_prompt + 1)
        shared.append((np.concatenate([prefix, r.randint(0, vocab,
                                                        n_tok - PREFIX)]),
                       int(r.randint(16, 97))))
    for _ in range(n // 2):
        other.append((r.randint(0, vocab, r.randint(100, max_prompt + 1)),
                      int(r.randint(16, 97))))
    return shared, other


def teacher_forced_k5(fd, eng):
    """One 32-layer step over the live engine state: K5 against the plain
    paged version from the same x, pool, tables and positions (the host
    mirrors the next tick would upload), logits of the active rows
    compared. Both write only each row's next append position (which the
    next tick overwrites) or scratch; the comparison launch is not counted
    as the path's."""
    up = lambda a: torch.tensor(a, device="cuda")
    tables, positions = up(eng._tables), up(eng._positions)
    plan, meta = eng._plan, eng.meta
    x = plan["embed"](up(eng._toks), positions)
    cos = eng._cos_tab.index_select(0, positions)
    sin = eng._sin_tab.index_select(0, positions)
    kw = dict(num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
              eps=meta["eps"], arch=eng.arch, kv_scales=pool_scales(eng))
    n0 = fd.fused_paged_decode_cuda.launches
    xk, _ = fd.fused_paged_decode_cuda(x, plan["params"], eng.kv_pool, tables,
                                       positions, cos, sin, **kw)
    lk = plan["head"](xk).float()
    torch.cuda.synchronize()
    fd.fused_paged_decode_cuda.launches = n0
    xp, _ = fd.fused_paged_decode_reference(x, plan["params"], eng.kv_pool,
                                            tables, positions, cos, sin, **kw)
    lp = plan["head"](xp).float()
    active = [i for i, sl in enumerate(eng._slots) if sl is not None]
    err, ok = close(lk[active], lp[active], SERVE_LOGIT_ATOL, E2E_RTOL)
    agree = float((lk[active].argmax(-1) == lp[active].argmax(-1))
                  .float().mean())
    return {"rows": active, "positions": eng._positions[active].tolist(),
            "logit_max_abs_err": err, "logit_absmax":
            lp[active].abs().max().item(), "argmax_agree": agree,
            "atol": SERVE_LOGIT_ATOL, "rtol": E2E_RTOL, "ok": ok}


def pool_scales(eng, rows=None):
    """The engine's per-slot int8 pool scales on the card (its first `rows`
    slots), or None over a bf16 pool."""
    if eng._kv_scales is None:
        return None
    sc = eng._kv_scales if rows is None else eng._kv_scales[:, :rows]
    return torch.tensor(np.ascontiguousarray(sc), device="cuda")


def borrow_blocks(eng, n):
    """Make `n` pool blocks free for a timing's tables: evict prefix-cache
    blocks that only the cache holds, as far as the free list falls short
    (a drained engine's cache may hold most of a small pool)."""
    short = n - eng.pool.free_blocks
    if short > 0 and eng.prefix_cache is not None:
        eng.prefix_cache.evict_free(short)


def time_k5(fd, eng, bw, flops, span=(100, 1300), rows=8):
    """K5 and its plain version at `rows` rows at positions evenly over
    `span` (~700 cached tokens on average by default), over the engine's
    pool (blocks borrowed from its free list)."""
    positions = [int(p) for p in np.linspace(*span, rows)]
    BT, L = eng.block_tokens, eng._num_layers
    borrow_blocks(eng, sum(p // BT + 1 for p in positions))
    borrowed = []
    tables = np.zeros((rows, eng.max_blocks_per_slot), np.int32)
    for i, p in enumerate(positions):
        bids = eng.pool.alloc(p // BT + 1)
        tables[i, :len(bids)] = bids
        borrowed += bids
    tab = torch.tensor(tables, device="cuda")
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    plan, meta = eng._plan, eng.meta
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    h = plan["params"]["ln1"].shape[1]
    x = rand((rows, h), gen)
    cos = eng._cos_tab.index_select(0, pos)
    sin = eng._sin_tab.index_select(0, pos)
    scales = pool_scales(eng, rows)     # an int8 pool: slots' own scales
    kw = dict(num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
              eps=meta["eps"], arch=eng.arch, kv_scales=scales)
    n0 = fd.fused_paged_decode_cuda.launches
    ms = time_ms(lambda: fd.fused_paged_decode_cuda(
        x, plan["params"], eng.kv_pool, tab, pos, cos, sin, **kw), iters=20)
    fd.fused_paged_decode_cuda.launches = n0
    plain = time_ms(lambda: fd.fused_paged_decode_reference(
        x, plan["params"], eng.kv_pool, tab, pos, cos, sin, **kw), iters=2,
        warmup=1)
    for bid in borrowed:
        eng.pool.free(bid)
    params = plan["params"]
    wbytes = sum(t.numel() * t.element_size() for t in params.values())
    row = eng.kv_pool.shape[3] * eng.kv_pool.element_size()
    keys = sum(p + 1 for p in positions)
    nbytes = wbytes + L * row * keys + L * row * rows + 2 * x.numel() * 2 \
        + (0 if scales is None else 4 * scales.numel())
    nflops = 2 * rows * sum(t.numel() for t in params.values()) \
        + L * meta["num_heads"] * 4 * meta["head_dim"] * keys
    tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
    return {"rows": rows, "positions": positions,
            "mean_cached_tokens": keys / rows,
            "ms": ms, "plain_ms": plain, "bytes": nbytes, "flops": nflops,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


class PlainCalls:
    """Counts the calls of the paged steps' plain versions made while the
    context is open: the engine's dispatch reads them from the module at
    call time, so a step that fell to its plain version shows here. Opened
    around an engine's own ticks only (not the checks that call the plain
    versions on purpose); re-entrant, the count accumulates."""

    NAMES = ("fused_paged_decode_reference", "fused_paged_verify_reference")

    def __init__(self, fd):
        self.fd, self.n = fd, 0

    def __enter__(self):
        self.saved = {k: getattr(self.fd, k) for k in self.NAMES}
        for k, f in self.saved.items():
            setattr(self.fd, k, self._counted(f))
        return self

    def _counted(self, f):
        def call(*a, **kw):
            self.n += 1
            return f(*a, **kw)
        return call

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(self.fd, k, f)


def phase_serve(fa, fd, model, bw, flops, k5_err, phase="serve",
                name="llama2_7b", serve=SERVE, max_prompt=1000,
                span=(100, 1300), cache_dtype=torch.bfloat16):
    """`model` through serving.ServingEngine(**serve, cache_dtype): the
    greedy run with a shared prefix and a preemption, then the sampled run
    (see the module docstring's phase serve); no tick falls to a plain
    version. Returns (K5's kernel-table row, the launch counts of both
    runs)."""
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.serving import Request, ServingEngine

    cfg = model.cfg
    shared, other = serve_requests(cfg.vocab_size, max_prompt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(model, **serve, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lows = shared + other[:6]
    highs = other[6:]
    reset_counts(fa, fd)
    plain = PlainCalls(fd)
    t0 = time.perf_counter()
    with plain:
        rids = [eng.submit(Request(shared[0][0], max_new_tokens=shared[0][1],
                                   priority="low"))]
        eng.step()    # its prefix blocks land in the cache before the rest
        rids += [eng.submit(Request(p, max_new_tokens=n, priority="low"))
                 for p, n in lows[1:]]
        for _ in range(4):
            if eng.active_slots == serve["max_slots"]:
                break
            eng.step()
        rids += [eng.submit(Request(p, max_new_tokens=n, priority="high"))
                 for p, n in highs]
        eng.step()    # the high requests preempt two low slots
    if eng.stats["preemptions"] < 1 or eng.active_slots < 8:
        raise AssertionError(f"{phase}: no preemption ({eng.stats})")
    forced = teacher_forced_k5(fd, eng)
    with plain:
        eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(eng.stats)
    got = counts(fa, fd)
    results = [eng.pop_result(i) for i in rids]
    want = [n for _, n in lows + highs]
    lengths = [len(res.tokens) for res in results]
    ttft = sorted(res.ttft_s for res in results)
    timing = time_k5(fd, eng, bw, flops, span)
    eng.prefix_cache.clear()
    leaked = eng.pool.used_blocks
    greedy_peak = torch.cuda.max_memory_allocated()
    eng.close()
    del eng
    torch.cuda.empty_cache()
    # parity with isolated generate is reported, not gated: a batched
    # prefill may take another cuBLAS algorithm than a b=1 one, and one bf16
    # ulp in the prompt's KV can part greedy tokens at a near-tie
    agree = []
    for res, (p, n) in zip(results[:2], lows[:2]):
        iso = generate(model, p[None], max_new_tokens=n,
                       cache_dtype=cache_dtype)[0, len(p):].tolist()
        agree.append(next((j for j, (a, b) in enumerate(zip(iso, res.tokens))
                           if a != b), n))

    # sampled: the knobs live on the engine, each request has its own seed
    eng = ServingEngine(model, **serve, temperature=0.8, top_k=50, top_p=0.9,
                        cache_dtype=cache_dtype)
    reset_counts(fa, fd)
    t1 = time.perf_counter()
    with plain:
        srids = [eng.submit(Request(p, max_new_tokens=n, seed=1000 + i))
                 for i, (p, n) in enumerate(other)]
        eng.drain()
    torch.cuda.synchronize()
    swall = time.perf_counter() - t1
    sst = dict(eng.stats)
    sgot = counts(fa, fd)
    sres = [eng.pop_result(i) for i in srids]
    slengths = [len(res.tokens) for res in sres]
    stoks = np.concatenate([res.tokens for res in sres])
    eng.prefix_cache.clear()
    sleaked = eng.pool.used_blocks
    eng.close()
    del eng
    total = {k: got[k] + sgot[k] for k in sgot}
    L = cfg.num_layers
    steps = st["steps"]
    res = {
        "phase": phase, "model": name, "layers": L,
        "dtype": "bfloat16", "cache_dtype": str(cache_dtype).split(".")[-1],
        **serve, "engine_init_s": init_s, "plain_version_calls": plain.n,
        "requests": len(rids), "shared_prefix_tokens": PREFIX,
        "prompt_lens": [len(p) for p, _ in lows + highs],
        "max_new": want, "generated": lengths,
        "finish": [r.finish for r in results], "wall_s": wall,
        "tokens_per_s": sum(lengths) / wall,
        "decode_ms_per_tick": 1e3 * (st["step_dispatch_s"]
                                     + st["step_sync_s"]) / steps,
        "prefill_s": st["step_prefill_s"],
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                      int(0.99 * len(ttft)))],
        "stats": st, "launches": got, "teacher_forced": forced,
        "k5_timing": timing, "pool_used_blocks_after_clear": leaked,
        "max_memory_allocated": greedy_peak,
        "isolated_generate_agreeing_prefix": agree,
        "sampled": {"requests": len(srids), "wall_s": swall,
                    "tokens_per_s": sum(slengths) / swall,
                    "generated": slengths, "stats": sst, "launches": sgot,
                    "distinct_tokens": int(len(np.unique(stoks))),
                    "pool_used_blocks_after_clear": sleaked}}
    emit(res)
    checks = {
        "every request at its full length": lengths == want
        and slengths == [n for _, n in other],
        "K5 once per tick and replayed token": got["fused_paged_decode_step"]
        == steps + st["replay_tokens"] and sgot["fused_paged_decode_step"]
        == sst["steps"] + sst["replay_tokens"],
        "K2 never": total["fused_decode_step"] == 0,
        f"K1 {L} per prefill group": got["flash_attention_fwd"]
        == L * st["prefill_groups"] and sgot["flash_attention_fwd"]
        == L * sst["prefill_groups"],
        "a preemption and a replay": st["preemptions"] >= 1
        and st["replay_tokens"] >= 1,
        "7 siblings reuse the prefix": st["prefill_tokens_reused"]
        >= 7 * PREFIX,
        "no leaked block": leaked == 0 and sleaked == 0,
        "no plain-version call": plain.n == 0,
        "teacher-forced logits": forced["ok"],
        "sampled tokens in range": int(stoks.min()) >= 0
        and int(stoks.max()) < cfg.vocab_size,
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"{phase}: failed {bad}")
    row = {"name": "fused_paged_decode_step", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/fused_decode.cu",
           "replaces": "paddle_tpu/ops/fused_decode.py:1884",
           "launches": total["fused_paged_decode_step"],
           "max_abs_err": k5_err, "ms": timing["ms"],
           "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
           "bound_by": timing["bound_by"], "library_ms": None,
           "at_shape": {"b": 8, "layers": L,
                        "positions": timing["positions"]}}
    return row, total


SERVE32 = dict(max_slots=32, block_tokens=128, max_seq_len=2048)


def phase_serve32(fa, fd, model, bw, flops):
    """`model` through ServingEngine(**SERVE32) (a 34 GB pool beside the
    weights): 32 greedy requests drawn as serve_requests draws its 16, from
    seed 32 (their own, so no later phase's inputs change), half behind the
    shared prefix; every slot busy at once; a teacher-forced 32-layer,
    32-row K5 step over the live pool against the plain paged version on
    the logits; K5 timed at 32 rows. Returns (K5's 32-row timing, the run's
    launch counts)."""
    from paddle_tpu_torch.serving import Request, ServingEngine

    cfg = model.cfg
    shared, other = serve_requests(cfg.vocab_size, n=32, seed=32)
    reqs = shared + other
    slots = SERVE32["max_slots"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, **SERVE32)
    reset_counts(fa, fd)
    t0 = time.perf_counter()
    rids = [eng.submit(Request(shared[0][0], max_new_tokens=shared[0][1]))]
    eng.step()        # its prefix blocks land in the cache before the rest
    rids += [eng.submit(Request(p, max_new_tokens=n)) for p, n in reqs[1:]]
    for _ in range(8):
        eng.step()
        if eng.active_slots == slots:
            break
    busy = eng.active_slots
    forced = teacher_forced_k5(fd, eng)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(eng.stats)
    got = counts(fa, fd)
    results = [eng.pop_result(i) for i in rids]
    want = [n for _, n in reqs]
    lengths = [len(res.tokens) for res in results]
    ttft = sorted(res.ttft_s for res in results)
    timing = time_k5(fd, eng, bw, flops, rows=slots)
    eng.prefix_cache.clear()
    leaked = eng.pool.used_blocks
    peak = torch.cuda.max_memory_allocated()
    pool_bytes = eng.kv_pool.numel() * eng.kv_pool.element_size()
    eng.close()
    del eng
    torch.cuda.empty_cache()
    L = cfg.num_layers
    steps = st["steps"]
    res = {"phase": "serve32", "model": "llama2_7b", "layers": L,
           "dtype": "bfloat16", **SERVE32, "pool_bytes": pool_bytes,
           "requests": len(rids), "shared_prefix_tokens": PREFIX,
           "slots_busy_at_once": busy,
           "prompt_lens": [len(p) for p, _ in reqs], "max_new": want,
           "generated": lengths, "wall_s": wall,
           "tokens_per_s": sum(lengths) / wall,
           "decode_ms_per_tick": 1e3 * (st["step_dispatch_s"]
                                        + st["step_sync_s"]) / steps,
           "prefill_s": st["step_prefill_s"],
           "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
           "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                         int(0.99 * len(ttft)))],
           "stats": st, "launches": got, "teacher_forced": forced,
           "k5_timing": timing, "pool_used_blocks_after_clear": leaked,
           "max_memory_allocated": peak}
    emit(res)
    checks = {
        "every slot busy at once": busy == slots,
        "every request at its full length": lengths == want,
        "K5 once per tick and replayed token": got["fused_paged_decode_step"]
        == steps + st["replay_tokens"],
        "K2 never": got["fused_decode_step"] == 0,
        f"K1 {L} per prefill group": got["flash_attention_fwd"]
        == L * st["prefill_groups"],
        "15 siblings reuse the prefix": st["prefill_tokens_reused"]
        >= 15 * PREFIX,
        "no leaked block": leaked == 0,
        "teacher-forced logits": forced["ok"],
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"serve32: failed {bad}")
    return timing, got


# ---- speculative serving --------------------------------------------------------

SPEC_K = 4


def spec_requests(vocab):
    """16 greedy requests from seed 0, 32–128 new tokens each: 8 whose
    400–1000-token prompts tile a 16–64-token motif (the extraction, code
    and quoting traffic prompt lookup serves), 8 random 100–1000-token
    prompts."""
    r = np.random.RandomState(0)
    motif, rand_ = [], []
    for _ in range(8):
        m = r.randint(0, vocab, r.randint(16, 65))
        n = r.randint(400, 1001)
        motif.append((np.resize(m, n), int(r.randint(32, 129))))
    for _ in range(8):
        rand_.append((r.randint(0, vocab, r.randint(100, 1001)),
                      int(r.randint(32, 129))))
    return motif, rand_


def drive_spec(eng, lows, highs):
    """Submit the lows, tick until every slot is busy, submit the highs
    (they preempt), drain. Returns (request ids, the ticks each request
    decoded in)."""
    from paddle_tpu_torch.serving import Request
    ticks = {}

    def step():
        done = eng.step()["finished"]
        for rid in done + [s.req.request_id for s in eng._slots
                           if s is not None]:
            ticks[rid] = ticks.get(rid, 0) + 1

    rids = [eng.submit(Request(p, max_new_tokens=n, priority="low"))
            for p, n in lows]
    for _ in range(8):
        if eng.active_slots == SERVE["max_slots"]:
            break
        step()
    rids += [eng.submit(Request(p, max_new_tokens=n, priority="high"))
             for p, n in highs]
    step()
    if eng.stats["preemptions"] < 1:
        raise AssertionError(f"spec: no preemption ({eng.stats})")
    while not eng.idle:
        step()
    return rids, ticks


def teacher_forced_k7(fd, eng):
    """One 32-layer verify over the live engine state: K7 against the plain
    verify from the same tail (each slot's last token and the proposals the
    last tick produced, zeros where it produced none), pool, tables and
    positions (the host mirrors the next tick would upload); logits of
    every mapped tail token of the active rows compared. Both write only
    the rows' tail positions (which the next verify rewrites before
    reading them) or scratch; the comparison launch is not counted as the
    path's."""
    tables_np, positions_np, toks_np = eng._tables, eng._positions, eng._toks
    ntab = [0 if s is None else s.ntab for s in eng._slots]
    pool = eng.kv_pool
    up = lambda a: torch.tensor(a, device="cuda")
    tables, positions = up(tables_np), up(positions_np)
    b, K1 = len(positions_np), SPEC_K + 1
    props = (eng._dev_prop[0] if eng._dev_prop is not None
             and eng._dev_prop[0].shape[1] == SPEC_K else
             torch.zeros((b, SPEC_K), dtype=torch.int32, device="cuda"))
    tail = torch.cat([up(toks_np)[:, None], props.long()], dim=1)
    S, BT = eng.max_seq_len, eng.block_tokens
    pj = torch.clamp(positions.long()[:, None]
                     + torch.arange(K1, device="cuda")[None], max=S - 1)
    plan, meta = eng._plan, eng.meta
    x = plan["embed"](tail.reshape(-1), pj.reshape(-1)).reshape(b, K1, -1)
    cos, sin = eng._cos_tab[pj], eng._sin_tab[pj]
    kw = dict(num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
              eps=meta["eps"], arch=eng.arch, kv_scales=pool_scales(eng))
    n0 = fd.fused_paged_verify_cuda.launches
    xk, _ = fd.fused_paged_verify_cuda(x, plan["params"], pool, tables,
                                       positions, cos, sin, **kw)
    torch.cuda.synchronize()
    fd.fused_paged_verify_cuda.launches = n0
    xp, _ = fd.fused_paged_verify_reference(x, plan["params"], pool, tables,
                                            positions, cos, sin, **kw)
    mapped = [(r, j) for r in range(b) if ntab[r] for j in range(K1)
              if (positions_np[r] + j) // BT < ntab[r]]
    rr = torch.tensor([r for r, _ in mapped], device="cuda")
    jj = torch.tensor([j for _, j in mapped], device="cuda")
    lk = plan["head"](xk[rr, jj]).float()
    lp = plan["head"](xp[rr, jj]).float()
    err, ok = close(lk, lp, SERVE_LOGIT_ATOL, E2E_RTOL)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    return {"rows": sorted({r for r, _ in mapped}), "tail_tokens":
            len(mapped), "positions": positions_np.tolist(),
            "logit_max_abs_err": err, "logit_absmax": lp.abs().max().item(),
            "argmax_agree": agree, "atol": SERVE_LOGIT_ATOL,
            "rtol": E2E_RTOL, "ok": ok}


def time_k7(fd, eng, bw, flops, span=(100, 1300)):
    """K7 and its plain version at b=8, K1=5, rows at positions evenly over
    `span` (~700 cached tokens on average by default), over the engine's
    pool (blocks borrowed from its free list). Bound: every layer weight
    once, each row's filled KV and its K1 appended rows, x in and out, at
    the card's memory rate; the tail's 2·params·40 FLOP (and the
    attention's) at its bf16 rate."""
    K1 = SPEC_K + 1
    positions = [int(p) for p in np.linspace(*span, 8)]
    BT, L = eng.block_tokens, eng._num_layers
    borrow_blocks(eng, sum((p + K1 - 1) // BT + 1 for p in positions))
    borrowed = []
    tables = np.zeros((8, eng.max_blocks_per_slot), np.int32)
    for i, p in enumerate(positions):
        bids = eng.pool.alloc((p + K1 - 1) // BT + 1)
        tables[i, :len(bids)] = bids
        borrowed += bids
    tab = torch.tensor(tables, device="cuda")
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    plan, meta = eng._plan, eng.meta
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    h = plan["params"]["ln1"].shape[1]
    x = rand((8, K1, h), gen)
    pj = pos.long()[:, None] + torch.arange(K1, device="cuda")[None]
    cos, sin = eng._cos_tab[pj], eng._sin_tab[pj]
    scales = pool_scales(eng, 8)        # an int8 pool: slots' own scales
    kw = dict(num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
              eps=meta["eps"], arch=eng.arch, kv_scales=scales)
    n0 = fd.fused_paged_verify_cuda.launches
    ms = time_ms(lambda: fd.fused_paged_verify_cuda(
        x, plan["params"], eng.kv_pool, tab, pos, cos, sin, **kw), iters=20)
    fd.fused_paged_verify_cuda.launches = n0
    plain = time_ms(lambda: fd.fused_paged_verify_reference(
        x, plan["params"], eng.kv_pool, tab, pos, cos, sin, **kw), iters=2,
        warmup=1)
    for bid in borrowed:
        eng.pool.free(bid)
    params = plan["params"]
    wbytes = sum(t.numel() * t.element_size() for t in params.values())
    row = eng.kv_pool.shape[3] * eng.kv_pool.element_size()
    keys = sum(p + K1 for p in positions)           # rows each row reads
    nbytes = wbytes + L * row * keys + L * row * 8 * K1 + 2 * x.numel() * 2 \
        + (0 if scales is None else 4 * scales.numel())
    pairs = sum(p + j + 1 for p in positions for j in range(K1))
    nflops = 2 * 8 * K1 * sum(t.numel() for t in params.values()) \
        + L * meta["num_heads"] * 4 * meta["head_dim"] * pairs
    tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
    return {"b": 8, "K1": K1, "positions": positions,
            "mean_cached_tokens": sum(positions) / 8, "ms": ms,
            "plain_ms": plain, "bytes": nbytes, "flops": nflops,
            "bound_ms": max(tb, to), "bytes_ms": tb, "operations_ms": to,
            "bound_by": "bytes" if tb >= to else "operations"}


def engine_metrics(eng, wall, results, want):
    st = dict(eng.stats)
    lengths = [len(r.tokens) for r in results]
    ttft = sorted(r.ttft_s for r in results)
    slot_ticks = st["steps"] * eng.max_slots - st["idle_slot_steps"]
    return {"wall_s": wall, "generated": lengths,
            "full_length": lengths == want,
            "tokens_per_s": sum(lengths) / wall,
            "decode_ms_per_tick": 1e3 * (st["step_dispatch_s"]
                                         + st["step_sync_s"]) / st["steps"],
            "tokens_per_tick_per_active_slot":
                st["decode_tokens"] / max(slot_ticks, 1),
            "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
            "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                          int(0.99 * len(ttft)))],
            "prefill_s": st["step_prefill_s"], "stats": st}


#: two greedy runs whose logits each carry their path's bf16 noise (up to
#: SERVE_LOGIT_ATOL against the plain path) may take different tokens only
#: where the model's top two logits lie within twice that of each other;
#: random weights make such near ties common (phase spec's own A/B of the
#: 8-slot engines parts after 1 to 73 tokens), a wrong kernel parts at
#: gaps of O(1)
NEAR_TIE = 2 * SERVE_LOGIT_ATOL


def first_parting(model, prompt, a, b):
    """Where two greedy continuations `a`, `b` of `prompt` first differ
    (None: never), and whether that parting is a near tie: in the model's
    logits there (one full forward over the prompt and the shared prefix,
    on the model's device) both tokens lie within NEAR_TIE of the
    largest."""
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return None
    ids = torch.tensor(np.concatenate([np.asarray(prompt), a[:j]]),
                       device=model.device)[None]
    with torch.no_grad():
        out = model(ids)
        logits = (out[0] if isinstance(out, tuple) else out)[0, -1].float()
    top = float(logits.max())
    below = [top - float(logits[int(t)]) for t in (a[j], b[j])]
    return {"token": j, "tokens": [int(a[j]), int(b[j])],
            "below_max": below, "near_tie": max(below) <= NEAR_TIE}


#: the wide speculative engine: 16 slots x (k + 1) = 80 tail rows a tick,
#: two K7 launches of whole slots (at most GROUP_ROWS tail rows each)
SPEC_WIDE = dict(SERVE, max_slots=16)


def spec_wide(fa, fd, model, reqs):
    """A plain and a k = 4 speculative 16-slot engine on the same greedy
    requests (new tokens capped at 32), every slot busy at once: launch
    counts (K7 in two groups of slots each speculative tick, K5 once per
    plain tick and replayed token), a teacher-forced 32-layer K7 step over
    the speculative engine's live pool (80 tail rows) against the plain
    verify, and the two engines' tokens equal or parted only at a near tie
    (`first_parting`)."""
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
    reqs = [(p, min(n, 32)) for p, n in reqs]
    runs, tokens = {}, {}
    for name, spec in (("plain", None), ("spec", SpecConfig(k=SPEC_K))):
        torch.cuda.empty_cache()
        eng = ServingEngine(model, **SPEC_WIDE, speculate=spec)
        reset_counts(fa, fd)
        rids = [eng.submit(Request(p, max_new_tokens=n)) for p, n in reqs]
        busy, tf = 0, None
        t0 = time.perf_counter()
        while not eng.idle:
            eng.step()
            busy = max(busy, eng.active_slots)
            if spec is not None and tf is None \
                    and eng.active_slots == SPEC_WIDE["max_slots"] \
                    and eng.stats["spec_ticks"] >= 2:
                tf = teacher_forced_k7(fd, eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        res = [eng.pop_result(i) for i in rids]
        st = dict(eng.stats)
        eng.prefix_cache.clear()
        runs[name] = {"wall_s": wall, "launches": got, "stats": st,
                      "most_slots_busy": busy,
                      "generated": [len(r.tokens) for r in res],
                      "pool_used_blocks_after_clear": eng.pool.used_blocks}
        if spec is not None:
            runs[name]["teacher_forced"] = tf
        tokens[name] = [r.tokens.tolist() for r in res]
        eng.close()
        del eng
        gc.collect()
    partings = [first_parting(model, p, a, b) for (p, _), a, b in
                zip(reqs, tokens["spec"], tokens["plain"])]
    sp, pl = runs["spec"], runs["plain"]
    groups = len(fd.row_groups(SPEC_WIDE["max_slots"],
                               fd.GROUP_ROWS // (SPEC_K + 1)))
    sst, pst = sp["stats"], pl["stats"]
    checks = {
        "every request at its full length": all(
            r["generated"] == [n for _, n in reqs] for r in runs.values()),
        "every slot busy at once": sp["most_slots_busy"]
        == pl["most_slots_busy"] == SPEC_WIDE["max_slots"],
        "no leaked block": sp["pool_used_blocks_after_clear"]
        == pl["pool_used_blocks_after_clear"] == 0,
        "K7 in groups each speculative tick": groups == 2
        and sp["launches"]["fused_paged_verify_step"]
        == groups * sst["spec_ticks"] > 0,
        "K5 once per plain tick and replayed token":
            sp["launches"]["fused_paged_decode_step"]
            == sst["steps"] - sst["spec_ticks"] + sst["replay_tokens"]
            and pl["launches"]["fused_paged_decode_step"]
            == pst["steps"] + pst["replay_tokens"]
            and pl["launches"]["fused_paged_verify_step"] == 0,
        "teacher-forced logits": sp["teacher_forced"] is not None
        and sp["teacher_forced"]["ok"],
        "tokens equal the plain engine's, or part at a near tie": all(
            q is None or q["near_tie"] for q in partings),
    }
    return {"slots": SPEC_WIDE["max_slots"], "k": SPEC_K,
            "k7_launches_per_tick": groups, "requests": len(reqs),
            "spec": sp, "plain": pl, "first_parting": partings,
            "requests_equal": sum(q is None for q in partings),
            "near_tie": NEAR_TIE, "checks": checks,
            "ok": all(checks.values())}


def forced_acceptance(fa, fd, model, reqs, plain_tokens):
    """A speculative engine (k=4) on `reqs` whose proposals, on one tick,
    are the plain engine's next k greedy tokens: random weights accept
    next to nothing from the n-gram matcher, so this is the tick that
    drives a multi-token commit, positions, tokens and counts moving by
    acc + 1 on the device, and a stop inside an accepted run on the card.

    Tick A is the first clean tick (every slot busy, nothing queued, no
    event that would re-zero the proposals on it or on the tick after).
    Before it, k + 1 sequential K5 steps over a clone of the pool give each
    row's greedy continuation o_0..o_k and the top-2 logit gap of each;
    o_0..o_{k-1} replace the carried proposals. After it:
      - every row accepts at least the prefix of proposals whose gap
        exceeds SERVE_LOGIT_ATOL (below it K7 and K5 may round to other
        argmaxes), these prefixes are not all empty, and the accepted
        tokens are the proposals;
      - one K5 step at each row's next position (host mirrors) over the
        live pool, whose new history K7 appended, matches the same step
        over the clone, whose history K5 appended (logits within
        SERVE_LOGIT_ATOL/E2E_RTOL).
    Tick B runs on the device twins tick A advanced. Row 0's budget is cut
    to 2 more tokens and its first proposal set to that K5 step's argmax:
      - every other row's first token of tick B is that argmax where its
        gap exceeds SERVE_LOGIT_ATOL;
      - row 0 commits 2 tokens and finishes by length (a stop inside the
        accepted run) where its gap does.
    Then the engine drains: every request reaches its length, no block
    leaks, K7 launches equal its spec ticks, and where its tokens part from
    the plain engine's is reported. Comparison launches are not counted
    as the path's."""
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
    K, BT = SPEC_K, SERVE["block_tokens"]
    thr = SERVE_LOGIT_ATOL
    assert len(reqs) == SERVE["max_slots"]
    eng = ServingEngine(model, **SERVE, speculate=SpecConfig(k=K))
    reset_counts(fa, fd)
    rids = [eng.submit(Request(p, max_new_tokens=n)) for p, n in reqs]

    def clean():
        act = [s for s in eng._slots if s is not None]
        return (len(act) == eng.max_slots and not eng.queued
                and not eng._dirty and eng._dev_prop is not None
                and all((s.pos + 2 * K + 1) // BT < s.ntab
                        and s.req.max_new_tokens - s.count > 2 * K + 2
                        for s in act))

    for warm in range(1, 33):
        eng.step()
        if clean():
            break
    else:
        raise AssertionError("spec forced: no clean tick in 32")
    slots = list(eng._slots)
    up = lambda a: torch.tensor(a, device=eng.device)
    plan, meta = eng._plan, eng.meta
    kw = dict(num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
              eps=meta["eps"])
    n5 = fd.fused_paged_decode_cuda.launches

    def k5_step(pool, tables, positions, toks):
        """(argmax, top-2 gap) of one K5 step, and the pool."""
        x = plan["embed"](toks, positions)
        xk, pool = fd.fused_paged_decode_cuda(
            x, plan["params"], pool, tables, positions,
            eng._cos_tab.index_select(0, positions),
            eng._sin_tab.index_select(0, positions), **kw)
        top = plan["head"](xk).float().topk(2, dim=-1)
        return (top.indices[:, 0], top.values[:, 0] - top.values[:, 1],
                top.values, pool)

    def mirrors():
        return up(eng._tables), up(eng._positions), up(eng._toks)

    # tick A: the oracle's proposals
    tables, pos0, tok = mirrors()
    clone = eng.kv_pool.clone()
    oracle, gaps = [], []
    for j in range(K + 1):
        tok, gap, _, clone = k5_step(clone, tables, pos0 + j, tok)
        oracle.append(tok.tolist())
        gaps.append(gap.tolist())
    eng._dev_prop = (torch.tensor(oracle[:K], dtype=torch.int32,
                                  device=eng.device).T.contiguous(),
                     up(np.full(eng.max_slots, K, np.int32)))
    before = [len(s.tokens) for s in slots]
    acc0 = eng.stats["spec_accepted"]
    eng.step()
    committed = [len(s.tokens) - n for s, n in zip(slots, before)]
    accepted = eng.stats["spec_accepted"] - acc0
    prefix = [next((j for j in range(K) if gaps[j][i] <= thr), K)
              for i in range(len(slots))]
    acc = [c - 1 for c in committed]
    oracle_kept = all(s.tokens[n:n + a] == [o[i] for o in oracle[:a]]
                      for i, (s, n, a) in enumerate(zip(slots, before, acc)))
    cut = 0
    # K7's appended history against K5's, one step at the next position
    tables, positions, toks = mirrors()
    nxt, gap_b, live, _ = k5_step(eng.kv_pool, tables, positions, toks)
    _, _, ref, _ = k5_step(clone, tables, positions, toks)
    del clone
    hist_err, hist_ok = close(live, ref, thr, E2E_RTOL)
    fd.fused_paged_decode_cuda.launches = n5
    nxt, gap_b = nxt.tolist(), gap_b.tolist()

    # tick B: over the device twins tick A left; row 0 stops inside its run
    clean_b = not eng._dirty
    props, nprop = eng._dev_prop
    props, nprop = props.clone(), nprop.clone()
    props[cut, 0], nprop[cut] = nxt[cut], max(int(nprop[cut]), 1)
    eng._dev_prop = (props, nprop)
    slots[cut].req.max_new_tokens = slots[cut].count + 2
    before_b = [len(s.tokens) for s in slots]
    eng.step()
    first_b = [s.tokens[n] for s, n in zip(slots, before_b)]
    device_ok = clean_b and all(first_b[i] == nxt[i]
                                for i in range(len(slots))
                                if i != cut and gap_b[i] > thr)
    cut_res = eng.results.get(slots[cut].req.request_id)
    cut_committed = len(slots[cut].tokens) - before_b[cut]
    cut_ok = gap_b[cut] <= thr or (cut_committed == 2 and cut_res is not None
                                   and cut_res.finish == "length")
    while not eng.idle:
        eng.step()
    got = counts(fa, fd)
    st = dict(eng.stats)
    results = [eng.pop_result(i) for i in rids]
    slot_of = {s.req.request_id: i for i, s in enumerate(slots)}
    want = [slots[slot_of[r]].req.max_new_tokens for r in rids]
    lengths = [len(r.tokens) for r in results]
    eng.prefix_cache.clear()
    leaked = eng.pool.used_blocks
    eng.close()
    del eng
    gc.collect()
    parting = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                    min(len(x), len(y)))
               for x, y in zip((r.tokens.tolist() for r in results),
                               plain_tokens)]
    res = {"warm_ticks": warm, "positions_at_a": pos0.tolist(),
           "tokens_before_a": [before[slot_of[r]] for r in rids],
           "gap_prefix": prefix, "accepted_at_a": acc,
           "tick_a_accepted": accepted,
           "tick_a_tokens_per_active_slot": sum(committed) / len(slots),
           "history_logit_max_abs_err": hist_err,
           "tick_b_gap_above_atol": [g > thr for g in gap_b],
           "tick_b_first_token_is_k5_argmax": [a == b for a, b in
                                               zip(first_b, nxt)],
           "cut_row_committed": cut_committed, "cut_row_finish":
               None if cut_res is None else cut_res.finish,
           "generated": lengths, "want": want,
           "first_parting_token_vs_plain": parting, "stats": st,
           "launches": got, "pool_used_blocks_after_clear": leaked}
    checks = {
        "gap prefix accepted": all(a >= p for a, p in zip(acc, prefix))
        and sum(prefix) > 0 and oracle_kept,
        "history appended by K7": hist_ok,
        "device twins advanced by acc + 1": device_ok,
        "stop inside the accepted run": cut_ok,
        "every request at its length": lengths == want,
        "no leaked block": leaked == 0,
        "K7 once per speculative tick": got["fused_paged_verify_step"]
        == st["spec_ticks"] > 0,
    }
    res["ok"] = all(checks.values())
    res["failed"] = [k for k, v in checks.items() if not v]
    return res


def phase_spec(fa, fd, model, bw, flops, k7_err):
    """Llama-2-7B through ServingEngine(speculate=SpecConfig(k=4)): one K7
    launch per tick; then the same requests through a plain engine (an A/B
    that is reported, not claimed); a forced-acceptance tick on the random
    half (`forced_acceptance`); then an adaptive engine (k_min=0) on the
    random half."""
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig

    cfg = model.cfg
    L = cfg.num_layers
    motif, rand_ = spec_requests(cfg.vocab_size)
    lows, highs = motif + rand_[:6], rand_[6:]
    want = [n for _, n in lows + highs]
    runs, tokens = {}, {}
    launches = None
    for name, spec in (("spec", SpecConfig(k=SPEC_K)), ("plain", None)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(model, **SERVE, speculate=spec)
        reset_counts(fa, fd)
        t0 = time.perf_counter()
        rids, ticks = drive_spec(eng, lows, highs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        results = [eng.pop_result(i) for i in rids]
        m = engine_metrics(eng, wall, results, want)
        m["launches"] = got
        m["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        per_tick = [(len(r.tokens) - 1) / max(ticks.get(i, 1), 1)
                    for i, r in zip(rids, results)]
        m["tokens_per_tick_motif_half"] = sum(per_tick[:8]) / 8
        m["tokens_per_tick_random_half"] = sum(per_tick[8:]) / 8
        if spec is not None:
            st = m["stats"]
            m["acceptance"] = st["spec_accepted"] / max(st["spec_proposed"],
                                                        1)
            m["k7_timing"] = time_k7(fd, eng, bw, flops)
            launches = got
        eng.prefix_cache.clear()
        m["pool_used_blocks_after_clear"] = eng.pool.used_blocks
        tokens[name] = [r.tokens.tolist() for r in results]
        runs[name] = m
        eng.close()
        del eng
        gc.collect()
    # where the two engines' greedy tokens first part, per request
    # (reported: K7's tensor-core sums and K5's split-K sums round apart)
    parting = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                    min(len(x), len(y)))
               for x, y in zip(tokens["spec"], tokens["plain"])]

    # one tick whose proposals are the plain engine's greedy continuation
    torch.cuda.empty_cache()
    forced = forced_acceptance(fa, fd, model, rand_, tokens["plain"][8:])
    gc.collect()

    # adaptive k on the random half; after its third tick, with every slot
    # busy, the teacher-forced K7 check over its live state (this run's
    # wall time includes the check)
    torch.cuda.empty_cache()
    eng = ServingEngine(model, **SERVE, speculate=SpecConfig(
        k=SPEC_K, adaptive=True, k_min=0))
    reset_counts(fa, fd)
    arids = [eng.submit(Request(p, max_new_tokens=n)) for p, n in rand_]
    widths = []
    tf = None
    t0 = time.perf_counter()
    while not eng.idle:
        eng.step()
        widths.append(eng._spec_k_eff)
        if len(widths) == 3:
            tf = teacher_forced_k7(fd, eng)
    torch.cuda.synchronize()
    awall = time.perf_counter() - t0
    agot = counts(fa, fd)
    ares = [eng.pop_result(i) for i in arids]
    ast = dict(eng.stats)
    eng.prefix_cache.clear()
    aleaked = eng.pool.used_blocks
    eng.close()
    del eng
    gc.collect()
    adaptive = {"requests": len(arids), "wall_s": awall,
                "generated": [len(r.tokens) for r in ares],
                "k_per_tick": widths, "stats": ast, "launches": agot,
                "teacher_forced": tf,
                "pool_used_blocks_after_clear": aleaked}

    # 16 slots (80 tail rows, two K7 launches a tick) on all 16 requests
    wide = spec_wide(fa, fd, model, motif + rand_)

    sp, pl = runs["spec"], runs["plain"]
    st = sp["stats"]
    res = {"phase": "spec", "model": "llama2_7b", "layers": L,
           "dtype": "bfloat16", **SERVE, "k": SPEC_K, "requests": len(want),
           "prompt_lens": [len(p) for p, _ in lows + highs],
           "max_new": want, "spec": sp, "plain": pl,
           "first_parting_token": parting, "forced_acceptance": forced,
           "adaptive_random_half": adaptive, "wide_16_slots": wide}
    emit(res)
    checks = {
        "every request at its full length": sp["full_length"]
        and pl["full_length"]
        and adaptive["generated"] == [n for _, n in rand_],
        "no leaked block": sp["pool_used_blocks_after_clear"] == 0
        and pl["pool_used_blocks_after_clear"] == 0 and aleaked == 0,
        "K7 once per speculative tick": launches["fused_paged_verify_step"]
        == st["spec_ticks"] > 0,
        "K5 once per plain tick and replayed token":
            launches["fused_paged_decode_step"]
            == st["steps"] - st["spec_ticks"] + st["replay_tokens"],
        "K1 32 per prefill group": launches["flash_attention_fwd"]
        == L * st["prefill_groups"],
        "K2 never": launches["fused_decode_step"] == 0,
        "a preemption and a replay": st["preemptions"] >= 1
        and st["replay_tokens"] >= 1,
        "teacher-forced logits": tf is not None and tf["ok"],
        "forced acceptance": forced["ok"],
        "adaptive launches split": agot["fused_paged_verify_step"]
        == ast["spec_ticks"] and agot["fused_paged_decode_step"]
        == ast["steps"] - ast["spec_ticks"] + ast["replay_tokens"],
        "16 slots speculating (two K7 launches a tick)": wide["ok"],
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"spec: failed {bad}")
    t = sp["k7_timing"]
    row = {"name": "fused_paged_verify_step", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/fused_decode.cu",
           "replaces": "paddle_tpu/ops/fused_decode.py:2642",
           "launches": launches["fused_paged_verify_step"],
           "max_abs_err": k7_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": None,
           "at_shape": {"b": 8, "K1": t["K1"], "layers": L,
                        "positions": t["positions"]}}
    return row, launches


# ---- weight-only int8 generation ---------------------------------------------------

#: the 32-layer teacher-forced int8 step's appends, kernel against plain
#: version. Below layer 0 each side's input carries the other's bf16
#: residual noise, which moves a value up to about a step before it rounds:
#: full runs of phase int8 on the H100 read at most 2 steps and 205,676 of
#: 1,048,576 lanes (19.6%) one step apart. Held to 2 steps, a quarter of
#: the lanes one step apart and 1% two steps apart. (Fed one input, each
#: layer's appends are held to one step.)
INT8_DRIFT = {"max_steps": 2, "one_step_share": 0.25, "two_step_share": 0.01}
#: the same for phase moe's 28-layer int8 step (DeepSeekMoE-16B, K6 against
#: the plain path taking K6's experts): each layer's routed experts add
#: their outputs' bf16 noise on top of the attention's, so the residual
#: noise below layer 0 is larger than Llama's. Its first full run on the
#: H100 read at most 4 steps, 126,965 of 458,752 lanes (27.7%) one step
#: apart and 4,888 (1.07%) two apart; held to 6 steps, 40% and 3%. A wrong
#: scale, lane or position moves a whole row by tens of steps. (Fed one
#: input, each layer's appends are held to one step.)
MOE_INT8_DRIFT = {"max_steps": 6, "one_step_share": 0.4,
                  "two_step_share": 0.03}

def phase_int8(fa, fd, model, bw, flops):
    """Llama-2-7B (the model already in memory) through quantize_model, in
    place, then inference.generate, b=4, prompt 1024, 64 new tokens, greedy
    and sampled, with an int8 and with a bf16 KV cache: K1 32 and K2 63
    launches per call; TTFT, decode ms/step, tokens/s, peak memory per
    cache; a teacher-forced 32-layer K2 step (int8 weights, int8 KV)
    against the plain int8 path on the logits, their argmax and the
    appends (within INT8_DRIFT; fed one input, each layer's within one
    step); K2 timed in
    both int8-weight modes at b=4, pos 1056. Returns ({mode: timing row},
    {cache: its greedy run's launch counts})."""
    from paddle_tpu_torch.inference import generate, prefill
    from paddle_tpu_torch.ops import rope
    from paddle_tpu_torch.quantization import quantize_model

    cfg = model.cfg
    L = cfg.num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_model(model)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    state = model.state_dict(include_buffers=False)
    weight_bytes = sum(t.numel() * t.element_size() for t in state.values())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), device="cuda",
                        generator=gen)
    want = {"dropout": 0, "rms_norm": 0, "smem_probe": 0,
            "dead_row_sums": 0,
            "attention_keep_words": 0,
            "flash_attention_fwd": L,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_decode_step": NEW - 1, "fused_paged_decode_step": 0,
            "fused_paged_verify_step": 0, "fused_decode_moe_step": 0}
    caches = {}
    for cname, cdt in (("int8", torch.int8), ("bf16", torch.bfloat16)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs = {}
        for name, kw in (("greedy", {}),
                         ("sampled", dict(temperature=0.8, top_k=50,
                                          top_p=0.9, seed=7))):
            torch.cuda.synchronize()
            reset_counts(fa, fd)
            t0 = time.perf_counter()
            out = generate(model, ids, max_new_tokens=NEW, cache_dtype=cdt,
                           **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts(fa, fd)
            new = out[:, PROMPT:]
            if got != want:
                raise AssertionError(f"int8 {cname} {name}: launch counts "
                                     f"{got}, expected {want}")
            if tuple(out.shape) != (B, PROMPT + NEW) \
                    or not torch.equal(out[:, :PROMPT], ids) \
                    or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
                raise AssertionError(f"int8 {cname} {name}: bad tokens "
                                     f"{tuple(out.shape)}")
            runs[name] = {"wall_s": wall, "launches": got,
                          "first_tokens": new[:, :8].tolist()}
        reset_counts(fa, fd)

        def wall(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(model, ids, max_new_tokens=n, cache_dtype=cdt)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        ttft_s = min(wall(1) for _ in range(2))
        gen_s = wall(NEW)
        caches[cname] = {"runs": runs, "ttft_ms": ttft_s * 1e3,
                         "decode_ms_per_step": (gen_s - ttft_s) / (NEW - 1)
                         * 1e3, "generate_ms": gen_s * 1e3,
                         "tokens_per_s": B * NEW / gen_s,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated()}

    total = -(-(PROMPT + NEW) // 128) * 128
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
              eps=cfg.rms_norm_eps)
    with torch.inference_mode():
        logits, kv = prefill(model, ids, total, fused=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        del logits
        plan = model.fused_decode_plan(state)
        params = plan["params"]
        kvq, kv_sc = fd.quantize_kv_cache(kv, cfg.kv_heads)
        cos, sin = rope.rope_cos_sin(total, cfg.head_dim, device="cuda")
        pos = PROMPT
        x = plan["embed"](tok, pos)
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
        kq = dict(kw, kv_scales=kv_sc)
        kv_plain = kvq.clone()
        n0 = fd.fused_decode_cuda.launches
        xk, kv_k = fd.fused_decode_cuda(x, params, kvq.clone(), pos, c, s,
                                        **kq)
        fd.fused_decode_cuda.launches = n0
        lk = plan["head"](xk).float()
        xp, kv_plain = fd.fused_decode_reference(x, params, kv_plain, pos, c,
                                                 s, **kq)
        lp = plan["head"](xp).float()
        steps, one, two = int8_rows(kv_k, kv_plain, pos)
        # every layer's appends on one input: K2 a layer at a time, each
        # layer's plain step fed K2's own x into that layer
        kv_k.copy_(kvq)
        kv_plain.copy_(kvq)
        xl = x
        for layer in range(L):
            sl = slice(layer, layer + 1)
            p1 = {k: v[sl] for k, v in params.items()}
            k1 = dict(kw, kv_scales=kv_sc[sl])
            xn, kv_k[sl] = fd.fused_decode_cuda(xl, p1, kv_k[sl], pos, c, s,
                                                **k1)
            kv_plain[sl] = fd.fused_decode_reference(xl, p1, kv_plain[sl],
                                                     pos, c, s, **k1)[1]
            xl = xn
        fd.fused_decode_cuda.launches = n0
        steps1, one1, _ = int8_rows(kv_k, kv_plain, pos)
        del kv_k, kv_plain
        lanes = L * B * 2 * cfg.kv_heads * cfg.head_dim
        logit_err, logits_ok = close(lk, lp, SERVE_LOGIT_ATOL, E2E_RTOL)
        tf = {"logit_max_abs_err": logit_err,
              "logit_absmax": lp.abs().max().item(),
              "argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                    .float().mean()),
              "per_layer_appended_rows_max_int8_steps": steps1,
              "per_layer_appended_lanes_one_step_apart": one1,
              "appended_rows_max_int8_steps": steps,
              "appended_lanes_one_step_apart": one,
              "appended_lanes_two_steps_apart": two,
              "appended_lanes": lanes,
              "atol": SERVE_LOGIT_ATOL, "rtol": E2E_RTOL,
              "ok": (logits_ok and steps1 <= 1
                     and steps <= INT8_DRIFT["max_steps"]
                     and one <= INT8_DRIFT["one_step_share"] * lanes
                     and two <= INT8_DRIFT["two_step_share"] * lanes)}
        tpos = PROMPT + 32
        gen.manual_seed(3)
        xt = rand((B, cfg.hidden_size), gen)
        ct, st = cos[tpos:tpos + 1], sin[tpos:tpos + 1]
        timing = {
            "llama_int8w": time_k2_mode(fd, xt, params, kv, tpos, ct, st, kw,
                                        bw, flops),
            "llama_int8w_int8kv": time_k2_mode(fd, xt, params, kvq, tpos, ct,
                                               st, kq, bw, flops)}
        head_ms = time_ms(lambda: plan["head"](xt), iters=20)
        del kv, kvq, plan, params
    head_bytes = sum(state[k].numel() * state[k].element_size()
                     for k in ("lm_head.weight_q", "lm_head.weight_scale"))
    res = {"phase": "int8", "model": "llama2_7b", "layers": L,
           "weights": "int8 (quantize_model), embeddings bf16",
           "weight_bytes": weight_bytes, "quantize_s": quantize_s,
           "batch": B, "prompt": PROMPT, "new": NEW, "caches": caches,
           "teacher_forced_int8w_int8kv": tf, "k2_timing": timing,
           "head_ms": head_ms,
           "decode_step_bound_ms_with_lm_head": {
               k: v["bound_ms"] + head_bytes / bw * 1e3
               for k, v in timing.items()}}
    emit(res)
    if not tf["ok"]:
        raise AssertionError(f"int8: teacher-forced step failed {tf}")
    return timing, {c: caches[c]["runs"]["greedy"]["launches"]
                    for c in caches}


# ---- the int8 serving engine ------------------------------------------------------

def mode_run(fa, fd, model, reqs, bw, flops, serve, span, spec=False,
             **engine_kw):
    """A short run of one engine mode for its kernel-table sub-row: `reqs`
    (greedy) through ServingEngine(model, **serve, **engine_kw), speculating
    k = SPEC_K when `spec`: launches (K5 once per plain tick and replayed
    token, K7 once per speculative tick), full lengths, no leaked block, no
    tick on a plain version; then K5 (spec: K7) timed at 8 rows over its
    pool, positions over `span`."""
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, **serve, **engine_kw,
                        speculate=SpecConfig(k=SPEC_K) if spec else None)
    reset_counts(fa, fd)
    t0 = time.perf_counter()
    with PlainCalls(fd) as plain:
        rids = [eng.submit(Request(p, max_new_tokens=n)) for p, n in reqs]
        eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(fa, fd)
    m = engine_metrics(eng, wall, [eng.pop_result(i) for i in rids],
                       [n for _, n in reqs])
    m["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    st = m["stats"]
    timing = (time_k7(fd, eng, bw, flops, span) if spec
              else time_k5(fd, eng, bw, flops, span))
    eng.prefix_cache.clear()
    leaked = eng.pool.used_blocks
    eng.close()
    del eng
    gc.collect()
    ok = (m["full_length"] and leaked == 0 and plain.n == 0
          and got["fused_paged_verify_step"] == st["spec_ticks"]
          and got["fused_paged_decode_step"]
          == st["steps"] - st["spec_ticks"] + st["replay_tokens"]
          and (st["spec_ticks"] if spec else st["steps"]) > 0)
    if not ok:
        raise AssertionError(f"mode run {engine_kw} spec={spec}: {m}, "
                             f"launches {got}, plain calls {plain.n}")
    return dict(m, spec_k=SPEC_K if spec else 0, launches=got,
                plain_version_calls=plain.n, timing=timing,
                pool_used_blocks_after_clear=leaked, ok=ok)


def mode_runs(fa, fd, model, reqs, bw, flops, serve, span, **engine_kw):
    """`mode_run` plain and speculating: {"k5": run, "k7": run}."""
    return {k: mode_run(fa, fd, model, reqs, bw, flops, serve, span,
                        spec=k == "k7", **engine_kw) for k in ("k5", "k7")}


def run_launches(runs):
    """The launch counts of several mode runs ({mode: {"k5"|"k7": run}}),
    summed kernel by kernel."""
    tot = {}
    for pair in runs.values():
        for run in pair.values():
            for k, v in run["launches"].items():
                tot[k] = tot.get(k, 0) + v
    return tot


def sub_row(letter, timing, launches, path, err):
    """A kernel-table sub-row (6a–6d, 7a–7d) from a run's timing (time_k5's
    or time_k7's dict, or a phase's kernel row)."""
    shape = timing.get("at_shape") or {k: timing[k] for k in
                                       ("rows", "b", "K1", "positions")
                                       if k in timing}
    return {"row": letter, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None, "max_abs_err": err, "launches": launches,
            "launches_by_path": {path: launches}, "at_shape": shape}


def phase_int8_pool(fa, fd, model, bw, flops):
    """Llama-2-7B in bf16 (before phase int8 quantizes it) over an int8
    pool (rows 6c and 7c): the serve mix's unshared half through an 8-slot
    engine, plain and speculating, by `mode_run`. Returns {"llama_int8kv":
    {"k5": run, "k7": run}}."""
    other = serve_requests(model.cfg.vocab_size)[1]
    runs = {"llama_int8kv": mode_runs(fa, fd, model, other, bw, flops,
                                      SERVE, (100, 1300),
                                      cache_dtype=torch.int8)}
    emit({"phase": "int8_pool", "model": "llama2_7b", **SERVE,
          "runs": runs})
    return runs


def phase_int8_serve(fa, fd, model, bw, flops, k5q_err, k7q_err):
    """The int8 serving engine on phase int8's quantized Llama-2-7B (int8
    weights in place): an 8-slot engine with an int8 pool (block 128,
    max_seq_len 2048) on the serve phase's mix (16 greedy requests, eight
    behind a shared prefix, two preempting, then 8 sampled: `phase_serve`),
    then the same engine speculating k = 4 on the spec phase's 16 requests
    (`serve_spec`); then int8 weights over a bf16 pool, plain and
    speculating (`mode_run`, rows 6b and 7b); then tiny engines on the card
    against the same engines on the CPU: a Llama with int8 weights and an
    int8 pool at 65 slots (K5 in two launches a tick) and a GPT with an
    int8 pool at 8 slots, tokens equal or parted at a near tie. Returns
    ({row: {mode: sub-row}}, the 7B runs' launch counts)."""
    cfg = model.cfg
    k5, serve_launches = phase_serve(
        fa, fd, model, bw, flops, k5q_err["llama_int8w_int8kv"],
        phase="int8_serve", cache_dtype=torch.int8)
    motif, rand_ = spec_requests(cfg.vocab_size)
    k7, spec_launches = serve_spec(
        fa, fd, model, bw, flops, k7q_err["llama_int8w_int8kv"],
        phase="int8_serve_spec", name="llama2_7b", serve=SERVE,
        reqs=(motif + rand_[:6], rand_[6:]), span=(100, 1300),
        cache_dtype=torch.int8)
    other = serve_requests(cfg.vocab_size)[1]
    runs = {"llama_int8w": mode_runs(fa, fd, model, other, bw, flops, SERVE,
                                     (100, 1300),
                                     cache_dtype=torch.bfloat16)}
    tiny = int8_tiny_engines(fa, fd)
    emit({"phase": "int8_serve_modes", "runs": runs, "tiny_engines": tiny})
    if not all(t["ok"] for t in tiny.values()):
        raise AssertionError(f"int8_serve: tiny engines {tiny}")
    launches = run_launches(runs)
    for got in (serve_launches, spec_launches):
        for k, v in got.items():
            launches[k] += v
    rows = {"fused_paged_decode_step": {}, "fused_paged_verify_step": {}}
    for name, letter, timing, err, n in (
            ("fused_paged_decode_step", "6a", k5,
             k5q_err["llama_int8w_int8kv"],
             serve_launches["fused_paged_decode_step"]),
            ("fused_paged_verify_step", "7a", k7,
             k7q_err["llama_int8w_int8kv"],
             spec_launches["fused_paged_verify_step"])):
        rows[name]["llama_int8w_int8kv"] = sub_row(letter, timing, n,
                                                   "int8_serve", err)
    add_mode_rows(rows, runs, "int8_serve", k5q_err, k7q_err)
    return rows, launches


def add_mode_rows(rows, runs, path, k5q_err, k7q_err):
    """The sub-rows of `mode_runs` results ({mode: {"k5", "k7"}}) into
    rows[kernel][mode]."""
    letters = {m: letter for m, letter, _, _, _ in PAGED_INT8_MODES}
    for mode, pair in runs.items():
        for key, name, row, errs in (
                ("k5", "fused_paged_decode_step", "6", k5q_err),
                ("k7", "fused_paged_verify_step", "7", k7q_err)):
            run = pair[key]
            rows.setdefault(name, {})[mode] = sub_row(
                row + letters[mode], run["timing"], run["launches"][name],
                path, errs[mode])


def int8_tiny_engines(fa, fd):
    """Tiny engines over an int8 pool on the card against the same weights
    on the CPU (`wide_engine`): a Llama (h 256, 4 heads, 2 kv heads, 2
    layers) with int8 weights (quantize_model on the card, the state copied
    to the CPU model) at 65 slots, and a GPT (h 256, 4 heads of 64, 2
    layers) at 8 slots."""
    from paddle_tpu_torch.models import (GPTConfig, GPTPretrainModel,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.quantization import quantize_model
    out = {}
    lcfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=4, num_kv_heads=2)
    gcfg = GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                     num_heads=4, max_position_embeddings=256,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    for name, cls, cfg, slots, w8 in (
            ("llama_int8w_int8kv", LlamaForCausalLM, lcfg, 65, True),
            ("gpt_int8kv", GPTPretrainModel, gcfg, 8, False)):
        model = cls(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        cpu = cls(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
        if w8:
            quantize_model(model)
            quantize_model(cpu)
        model.eval()
        cpu.eval()
        cpu.set_state_dict({k: v.cpu() for k, v in
                            model.state_dict(include_buffers=False).items()})
        out[name] = wide_engine(fa, fd, model, cpu, slots,
                                cache_dtype=torch.int8)
        del model, cpu
    gc.collect()
    return out


# ---- GPT-2 345M generation and serving --------------------------------------------

GPT_B, GPT_PROMPT, GPT_NEW = 8, 512, 128
GPT_SERVE = dict(max_slots=8, block_tokens=128, max_seq_len=1024)
GPT_SPAN = (150, 1000)   # timed rows: 8 positions averaging ~575 tokens


def gpt_model():
    """GPT-2 345M (GPTConfig.gpt2_medium(): 24 layers, hidden 1024, 16
    heads of 64, vocab 50304, 1024 positions, tied head), bf16, random
    weights from seed 0, eval(). The model's init leaves every bias 0 and
    every LayerNorm at (1, 0); they are drawn here as well (N(0, 0.02)
    around those values, from seed 0) so that the paths carry the biases
    the gpt mode adds."""
    from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
    model = GPTPretrainModel(GPTConfig.gpt2_medium(), dtype=torch.bfloat16,
                             device="cuda", seed=0)
    model.eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.dim() == 1:        # biases, LayerNorm scales and shifts
                p.add_(rand(tuple(p.shape), gen, 0.02))
    return model


def k2_bound(params, kv, pos, b, bw, flops, nh, hd, kv_scales=None):
    """K2's least time for one step at these inputs: every layer weight
    (and scale row) once, the filled KV [0, pos] and the appends, the KV
    scales, x in and out, at the card's memory rate; its FLOP at the bf16
    peak."""
    L = kv.shape[0]
    wbytes = sum(t.numel() * t.element_size() for t in params.values())
    if kv_scales is not None:
        wbytes += kv_scales.numel() * kv_scales.element_size()
    row = b * kv.shape[3] * kv.element_size()
    h = params["ln1"].shape[1]
    nbytes = wbytes + L * row * (pos + 1) + L * row + 2 * b * h * 2
    nflops = 2 * b * sum(t.numel() for t in params.values()) \
        + L * b * nh * 4 * hd * (pos + 1)
    tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
    return {"bytes": nbytes, "flops": nflops, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def time_k2_mode(fd, x, params, kv, pos, c, s, kw, bw, flops):
    """K2 in the mode its inputs select, one step at `pos`, timed with CUDA
    events beside its bound and the plain version (neither counted as a
    launch of a path)."""
    n0 = fd.fused_decode_cuda.launches
    ms = time_ms(lambda: fd.fused_decode_cuda(x, params, kv, pos, c, s, **kw),
                 iters=20)
    fd.fused_decode_cuda.launches = n0
    plain = time_ms(lambda: fd.fused_decode_reference(
        x, params, kv, pos, c, s, **kw), iters=2, warmup=1)
    nkv = kw["num_kv_heads"]
    bound = k2_bound(params, kv, pos, x.shape[0], bw, flops, kw["num_heads"],
                     kv.shape[3] // (2 * nkv), kw.get("kv_scales"))
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "bytes": bound["bytes"],
            "at_shape": {"b": x.shape[0], "layers": kv.shape[0],
                         "pos": pos}}


def gpt_generate(fa, fd, model, bw, flops, k2g_err):
    """GPT-2 345M through inference.generate, b=8, prompt 512, 128 new
    tokens, greedy and sampled: K1 24 and K2 127 launches per call; TTFT,
    decode ms/step, tokens/s, peak memory; one teacher-forced 24-layer
    step, K2 vs the plain path, on the logits; K2 timed at b=8, pos 576."""
    from paddle_tpu_torch.inference import generate, prefill

    cfg = model.cfg
    L = cfg.num_layers
    hd = cfg.hidden_size // cfg.num_heads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (GPT_B, GPT_PROMPT), device="cuda",
                        generator=gen)
    want = {"dropout": 0, "rms_norm": 0, "smem_probe": 0,
            "dead_row_sums": 0,
            "attention_keep_words": 0,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_decode_step": GPT_NEW - 1,
            "fused_paged_decode_step": 0, "fused_paged_verify_step": 0,
            "fused_decode_moe_step": 0}
    runs = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, top_p=0.9,
                                      seed=7))):
        torch.cuda.synchronize()
        reset_counts(fa, fd)
        t0 = time.perf_counter()
        out = generate(model, ids, max_new_tokens=GPT_NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        new = out[:, GPT_PROMPT:]
        if got != want:
            raise AssertionError(f"gpt {name}: launch counts {got}, "
                                 f"expected {want}")
        if tuple(out.shape) != (GPT_B, GPT_PROMPT + GPT_NEW) \
                or not torch.equal(out[:, :GPT_PROMPT], ids) \
                or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
            raise AssertionError(f"gpt {name}: bad tokens {tuple(out.shape)}")
        runs[name] = {"wall_s": wall, "launches": got,
                      "first_tokens": new[:, :8].tolist()}
        if name == "greedy":
            greedy_new = new
    # the int8 KV mode of K2's gpt arch through generate, once, greedy
    reset_counts(fa, fd)
    out = generate(model, ids, max_new_tokens=GPT_NEW, cache_dtype=torch.int8)
    torch.cuda.synchronize()
    got = counts(fa, fd)
    if got != want or tuple(out.shape) != (GPT_B, GPT_PROMPT + GPT_NEW):
        raise AssertionError(f"gpt greedy int8 cache: launch counts {got}, "
                             f"shape {tuple(out.shape)}")
    runs["greedy_int8_cache"] = {
        "launches": got, "first_tokens": out[:, GPT_PROMPT:][:, :8].tolist(),
        "tokens_equal_bf16_cache": float(
            (out[:, GPT_PROMPT:] == greedy_new).float().mean())}
    reset_counts(fa, fd)

    def wall(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ttft_s = min(wall(1) for _ in range(2))
    gen_s = wall(GPT_NEW)
    gen_peak = torch.cuda.max_memory_allocated()
    total = -(-(GPT_PROMPT + GPT_NEW) // 128) * 128
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_heads,
              eps=cfg.layer_norm_epsilon, arch="gpt")
    with torch.inference_mode():
        logits, kv = prefill(model, ids, total, fused=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        del logits
        plan = model.fused_decode_plan(model.state_dict(include_buffers=False))
        params = plan["params"]
        pos = GPT_PROMPT
        x = plan["embed"](tok, pos)
        kv_plain = kv.clone()
        xk, kv = fd.fused_decode_cuda(x, params, kv, pos, None, None, **kw)
        lk = plan["head"](xk).float()
        xp, kv_plain = fd.fused_decode_reference(x, params, kv_plain, pos,
                                                 None, None, **kw)
        lp = plan["head"](xp).float()
        del kv_plain
        logit_err, logits_ok = close(lk, lp, E2E_ATOL, E2E_RTOL)
        tf = {"logit_max_abs_err": logit_err,
              "logit_absmax": lp.abs().max().item(),
              "argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                    .float().mean()),
              "atol": E2E_ATOL, "rtol": E2E_RTOL, "ok": logits_ok}
        # K2 timed at b=8, one step at the mean position of the 128-token
        # decode (512 + 64 = 576) over the prefilled cache
        tpos = GPT_PROMPT + GPT_NEW // 2
        gen.manual_seed(3)
        xt = rand((GPT_B, cfg.hidden_size), gen)
        n0 = fd.fused_decode_cuda.launches
        ms = time_ms(lambda: fd.fused_decode_cuda(xt, params, kv, tpos, None,
                                                  None, **kw), iters=20)
        fd.fused_decode_cuda.launches = n0
        plain = time_ms(lambda: fd.fused_decode_reference(
            xt, params, kv, tpos, None, None, **kw), iters=2, warmup=1)
        head_ms = time_ms(lambda: plan["head"](xt), iters=20)
        bound = k2_bound(params, kv, tpos, GPT_B, bw, flops, cfg.num_heads,
                         hd)
        kvq, kv_sc = fd.quantize_kv_cache(kv, cfg.num_heads)
        int8kv = time_k2_mode(fd, xt, params, kvq, tpos, None, None,
                              dict(kw, kv_scales=kv_sc), bw, flops)
        del kv, kvq, plan, params
    head_bytes = model.gpt.wte.weight.numel() * 2
    decode_s = (gen_s - ttft_s) / (GPT_NEW - 1)
    res = {"phase": "gpt", "model": "gpt2_medium", "layers": L,
           "dtype": "bfloat16", "params": model.num_params(),
           "batch": GPT_B, "prompt": GPT_PROMPT, "new": GPT_NEW,
           "runs": runs, "ttft_ms": ttft_s * 1e3,
           "decode_ms_per_step": decode_s * 1e3,
           "generate_ms": gen_s * 1e3,
           "tokens_per_s": GPT_B * GPT_NEW / gen_s,
           "max_memory_allocated": gen_peak, "teacher_forced": tf,
           "k2_timing": dict(bound, ms=ms, plain_ms=plain, pos=tpos,
                             launches_per_step=1 + 11 * L),
           "k2_int8kv_timing": int8kv,
           "head_ms": head_ms,
           "decode_step_bound_ms_with_head":
               bound["bound_ms"] + head_bytes / bw * 1e3}
    emit(res)
    if not tf["ok"]:
        raise AssertionError(f"gpt: teacher-forced logits differ: {tf}")
    row = {"ms": ms, "plain_ms": plain, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "library_ms": None,
           "max_abs_err": k2g_err,
           "at_shape": {"b": GPT_B, "layers": L, "pos": tpos},
           "int8": {"gpt_int8kv": dict(int8kv, launches=runs[
               "greedy_int8_cache"]["launches"]["fused_decode_step"])}}
    return row, runs["greedy"]["launches"]


def serve_spec(fa, fd, model, bw, flops, k7_err, phase="gpt_spec",
               name="gpt2_medium", serve=GPT_SERVE, reqs=None,
               span=GPT_SPAN, cache_dtype=torch.bfloat16):
    """`model` through ServingEngine(**serve, speculate=SpecConfig(k=4),
    cache_dtype) on `reqs` ((lows, highs); default: the gpt_serve phase's
    greedy requests, 2 "high" preempting): K7 once per speculative tick,
    K5 once per plain tick and replayed token, no tick on a plain version;
    after the first ticks that fill every slot, a teacher-forced K7 step
    over the live pool against the plain verify; K7 timed at b=8 × 5
    tokens at `span`'s rows."""
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig

    cfg = model.cfg
    L = cfg.num_layers
    if reqs is None:
        shared, other = serve_requests(cfg.vocab_size, 800)
        reqs = shared + other[:6], other[6:]
    lows, highs = reqs
    want = [n for _, n in lows + highs]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, **serve, speculate=SpecConfig(k=SPEC_K),
                        cache_dtype=cache_dtype)
    reset_counts(fa, fd)
    plain = PlainCalls(fd)
    t0 = time.perf_counter()
    with plain:
        rids = [eng.submit(Request(p, max_new_tokens=n, priority="low"))
                for p, n in lows]
        for _ in range(8):
            if eng.active_slots == serve["max_slots"]:
                break
            eng.step()
        rids += [eng.submit(Request(p, max_new_tokens=n, priority="high"))
                 for p, n in highs]
        eng.step()
        if eng.stats["preemptions"] < 1:
            raise AssertionError(f"{phase}: no preemption ({eng.stats})")
        eng.step()
    tf = teacher_forced_k7(fd, eng)
    with plain:
        eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(fa, fd)
    results = [eng.pop_result(i) for i in rids]
    m = engine_metrics(eng, wall, results, want)
    st = m["stats"]
    timing = time_k7(fd, eng, bw, flops, span)
    eng.prefix_cache.clear()
    leaked = eng.pool.used_blocks
    peak = torch.cuda.max_memory_allocated()
    eng.close()
    del eng
    gc.collect()
    res = {"phase": phase, "model": name, "layers": L,
           "dtype": "bfloat16", "cache_dtype": str(cache_dtype).split(".")[-1],
           **serve, "k": SPEC_K,
           "requests": len(want), "max_new": want, **m,
           "acceptance": st["spec_accepted"] / max(st["spec_proposed"], 1),
           "launches": got, "plain_version_calls": plain.n,
           "teacher_forced": tf, "k7_timing": timing,
           "pool_used_blocks_after_clear": leaked,
           "max_memory_allocated": peak}
    emit(res)
    checks = {
        "every request at its full length": m["full_length"],
        "no leaked block": leaked == 0,
        "no plain-version call": plain.n == 0,
        "K7 once per speculative tick": got["fused_paged_verify_step"]
        == st["spec_ticks"] > 0,
        "K5 once per plain tick and replayed token":
            got["fused_paged_decode_step"]
            == st["steps"] - st["spec_ticks"] + st["replay_tokens"],
        f"K1 {L} per prefill group": got["flash_attention_fwd"]
        == L * st["prefill_groups"],
        "K2 never": got["fused_decode_step"] == 0,
        "a preemption and a replay": st["preemptions"] >= 1
        and st["replay_tokens"] >= 1,
        "teacher-forced logits": tf["ok"],
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"{phase}: failed {bad}")
    row = {"ms": timing["ms"], "plain_ms": timing["plain_ms"],
           "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
           "library_ms": None, "max_abs_err": k7_err,
           "at_shape": {"b": 8, "K1": timing["K1"], "layers": L,
                        "positions": timing["positions"]}}
    return row, got


def phase_gpt(fa, fd, bw, flops, errs):
    """GPT-2 345M generation (phase gpt), serving (gpt_serve) and
    speculative serving (gpt_spec). Returns ({kernel name: its gpt-mode
    row}, {path: launch counts})."""
    model = gpt_model()
    k2, gen_launches = gpt_generate(fa, fd, model, bw, flops, errs["k2g"])
    with torch.no_grad():
        k5, serve_launches = phase_serve(
            fa, fd, model, bw, flops, errs["k5g"], phase="gpt_serve",
            name="gpt2_medium", serve=GPT_SERVE, max_prompt=800,
            span=GPT_SPAN)
        k7, spec_launches = serve_spec(fa, fd, model, bw, flops,
                                       errs["k7g"])
        # the int8 pool (rows 6d and 7d): the other half of the serve mix,
        # plain and speculating
        other = serve_requests(model.cfg.vocab_size, 800)[1]
        int8_runs = {
            "gpt_int8kv": mode_runs(fa, fd, model, other, bw, flops,
                                    GPT_SERVE, GPT_SPAN,
                                    cache_dtype=torch.int8)}
        emit({"phase": "gpt_int8_pool", "runs": int8_runs})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    k5 = {k: k5[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "at_shape")}
    k5["max_abs_err"] = errs["k5g"]
    rows = {"fused_decode_step": k2, "fused_paged_decode_step": k5,
            "fused_paged_verify_step": k7}
    return rows, {"gpt_generate": gen_launches, "gpt_serve": serve_launches,
                  "gpt_spec": spec_launches,
                  "gpt_int8_pool": run_launches(int8_runs)}, int8_runs


# ---- MoE generation -------------------------------------------------------------

def moe_bound(params, kv, pos, ids, b, bw, flops, nh, hd, kv_scales=None):
    """K6's least time for one step at these inputs: every attention, norm,
    gate and shared-expert weight once, the distinct routed experts the
    step's routing `ids` (L, b, k) used, the filled KV and the appends (in
    the cache's type, int8 with its lane scales), at the card's memory
    rate; operations likewise at its bf16 peak."""
    L = kv.shape[0]
    dense = [n for n in params if n not in ("weg", "weu", "wed")]
    dbytes = sum(params[n].numel() * params[n].element_size() for n in dense)
    dparams = sum(params[n].numel() for n in dense)
    E, h, f = params["weg"].shape[1:]
    distinct = [len(set(ids[l].flatten().tolist())) for l in range(L)]
    ebytes = sum(distinct) * 3 * h * f * 2
    row = kv.shape[3] * kv.element_size()
    nbytes = dbytes + ebytes + L * b * row * (pos + 1) + L * b * row \
        + 2 * b * h * 2
    if kv_scales is not None:
        nbytes += kv_scales.numel() * kv_scales.element_size()
    k = ids.shape[2]
    nflops = 2 * b * dparams + 2 * L * b * k * 3 * h * f \
        + L * b * nh * 4 * hd * (pos + 1)
    tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
    return {"distinct_experts_per_layer": distinct,
            "mean_distinct_experts": sum(distinct) / L, "bytes": nbytes,
            "flops": nflops, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def phase_moe(fa, fd, bw, flops, k6_err, k6q_err):
    """DeepSeekMoE-16B (28 layers, bf16, random weights from seed 0)
    through inference.generate, b=4, prompt 1024, 64 new tokens: greedy
    and sampled with launch counts, TTFT and decode ms/step, a
    teacher-forced 28-layer step K6 vs the plain path (the swap rule), and
    K6 timed at b=4 and b=1 beside its bound and the plain version."""
    from paddle_tpu_torch.inference import generate, prefill
    from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
    from paddle_tpu_torch.ops import rope

    cfg = MixtralConfig.deepseek_moe_16b()
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MixtralForCausalLM(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), device="cuda",
                        generator=gen)
    want = {"dropout": 0, "rms_norm": 0, "smem_probe": 0,
            "dead_row_sums": 0,
            "attention_keep_words": 0,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_decode_step": 0,
            "fused_paged_decode_step": 0, "fused_paged_verify_step": 0,
            "fused_decode_moe_step": NEW - 1}
    runs = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, top_p=0.9,
                                      seed=7))):
        torch.cuda.synchronize()
        reset_counts(fa, fd)
        t0 = time.perf_counter()
        out = generate(model, ids, max_new_tokens=NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        new = out[:, PROMPT:]
        if got != want:
            raise AssertionError(f"moe {name}: launch counts {got}, "
                                 f"expected {want}")
        if tuple(out.shape) != (B, PROMPT + NEW) \
                or not torch.equal(out[:, :PROMPT], ids) \
                or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
            raise AssertionError(f"moe {name}: bad tokens {tuple(out.shape)}")
        runs[name] = {"wall_s": wall, "launches": got,
                      "first_tokens": new[:, :8].tolist()}
    reset_counts(fa, fd)

    def wall(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ttft_s = min(wall(1) for _ in range(2))
    gen_s = wall(NEW)
    gen_peak = torch.cuda.max_memory_allocated()
    total = -(-(PROMPT + NEW) // 128) * 128
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
              eps=cfg.rms_norm_eps, top_k=cfg.top_k)
    with torch.inference_mode():
        logits, kv = prefill(model, ids, total, fused=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        del logits
        plan = model.fused_decode_plan(model.state_dict(include_buffers=False))
        params = plan["params"]
        cos, sin = rope.rope_cos_sin(total, cfg.head_dim, device="cuda")
        pos = PROMPT
        x = plan["embed"](tok, pos)
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
        kv_plain, kv_forced = kv.clone(), kv.clone()
        kr, pr = {}, {}
        xk, kv = fd.fused_decode_moe_cuda(x, params, kv, pos, c, s,
                                          routing=kr, **kw)
        lk = plan["head"](xk).float()
        xp, kv_plain = fd.fused_decode_reference(
            x, params, kv_plain, pos, c, s, arch="moe", routing=pr, **kw)
        lp = plan["head"](xp).float()
        # the plain step again, taking the kernel's experts at every layer:
        # every row is then comparable at full depth
        xf_, kv_forced = fd.fused_decode_reference(
            x, params, kv_forced, pos, c, s, arch="moe",
            routing={"force_ids": kr["ids"]}, **kw)
        lf = plan["head"](xf_).float()
        del kv_plain, kv_forced
        rows = compare_routing(kr, pr, K6_FLIP_GAP_DEEP)
        kept = [r["row"] for r in rows if r["first_swap_layer"] is None]
        logit_err, logits_ok = close(lk[kept], lp[kept], SERVE_LOGIT_ATOL,
                                     E2E_RTOL) if kept else (0.0, True)
        forced_err, forced_ok = close(lk, lf, SERVE_LOGIT_ATOL, E2E_RTOL)
        tf = {"rows_swapped": B - len(kept), "routing": rows,
              "logit_max_abs_err_unswapped_rows": logit_err,
              "argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                    .float().mean()),
              "logit_absmax": lp.abs().max().item(),
              "kernel_routing_logit_max_abs_err": forced_err,
              "kernel_routing_argmax_agree": float(
                  (lk.argmax(-1) == lf.argmax(-1)).float().mean()),
              "atol": SERVE_LOGIT_ATOL, "rtol": E2E_RTOL,
              "flip_gap": K6_FLIP_GAP_DEEP,
              "ok": logits_ok and forced_ok and all(r["ok"] for r in rows)}

        # K6 at b=4 and b=1, one position past the prompt + 32
        tpos = PROMPT + 32
        gen.manual_seed(3)
        timing = {}
        for b in (B, 1):
            kvb = kv if b == B else kv[:, :1].contiguous()
            xb = rand((b, cfg.hidden_size), gen)
            c, s = cos[tpos:tpos + 1], sin[tpos:tpos + 1]
            route = {}
            fd.fused_decode_moe_cuda(xb, params, kvb, tpos, c, s,
                                     routing=route, **kw)
            ms = time_ms(lambda: fd.fused_decode_moe_cuda(
                xb, params, kvb, tpos, c, s, **kw), iters=20)
            plain = time_ms(lambda: fd.fused_decode_reference(
                xb, params, kvb, tpos, c, s, arch="moe", **kw), iters=2,
                warmup=1)
            bound = moe_bound(params, kvb, tpos, route["ids"].cpu(), b, bw,
                              flops, cfg.num_heads, cfg.head_dim)
            timing[f"b{b}"] = dict(bound, ms=ms, plain_ms=plain, pos=tpos)
        reset_counts(fa, fd)
        del plan, params, kv, kvb
    gc.collect()
    torch.cuda.empty_cache()
    int8_res, int8_row, int8_launches = moe_int8(fa, fd, model, ids, lk, bw,
                                                 flops, k6q_err)
    del lk
    head_bytes = model.lm_head.weight.numel() * 2
    peak = torch.cuda.max_memory_allocated()
    decode_s = (gen_s - ttft_s) / (NEW - 1)
    res = {"phase": "moe", "model": "deepseek_moe_16b", "layers": L,
           "dtype": "bfloat16", "params": n_params, "batch": B,
           "prompt": PROMPT, "new": NEW, "init_s": init_s, "runs": runs,
           "ttft_ms": ttft_s * 1e3, "decode_ms_per_step": decode_s * 1e3,
           "generate_ms": gen_s * 1e3, "tokens_per_s": B * NEW / gen_s,
           "decode_step_bound_ms_with_lm_head":
               timing[f"b{B}"]["bound_ms"] + head_bytes / bw * 1e3,
           "teacher_forced": tf, "k6_timing": timing,
           "max_memory_allocated_generate": gen_peak,
           "max_memory_allocated": peak, "int8_cache": int8_res}
    emit(res)
    if not tf["ok"]:
        raise AssertionError(f"moe: teacher-forced step failed {tf}")
    if not int8_res["teacher_forced"]["ok"]:
        raise AssertionError("moe: the int8 cache's teacher-forced step "
                             f"failed {int8_res['teacher_forced']}")
    t = timing[f"b{B}"]
    row = {"name": "fused_decode_moe_step", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/fused_decode.cu",
           "replaces": "paddle_tpu/ops/fused_decode.py:1049",
           "launches": runs["greedy"]["launches"]["fused_decode_moe_step"],
           "max_abs_err": k6_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": None,
           "at_shape": {"b": B, "layers": L, "pos": t["pos"],
                        "mean_distinct_experts": t["mean_distinct_experts"]},
           "at_b1": {k: timing["b1"][k] for k in
                     ("ms", "plain_ms", "bound_ms", "bound_by",
                      "mean_distinct_experts")}}
    return row, runs["greedy"]["launches"], int8_row, int8_launches


def moe_int8(fa, fd, model, ids, lk_bf16, bw, flops, k6q_err):
    """Phase moe's int8 cache: `model` (DeepSeekMoE-16B) through generate
    with cache_dtype=int8, greedy and sampled: K1 L and K6 NEW - 1
    launches per call, every K6 launch in its int8 KV mode; TTFT, decode
    ms/step, tokens/s, peak memory. Then the teacher-forced first decode
    step over the quantized prefill cache: K6 vs the int8 plain path (the
    swap rule on the routing, the logits of unswapped rows), every row's
    logits and appended int8 rows against the plain path taking K6's
    experts (within MOE_INT8_DRIFT), every layer's appends fed one input
    (K6 a layer at a time, each layer's plain step fed K6's own x into
    that layer: within one int8 step; the append comes before the layer's
    router, so routing plays no part), and the int8 step's logits against
    the bf16 cache's K6 step `lk_bf16` (agreement, reported). K6's int8 mode
    timed at b = B beside its bound and the plain version. Returns (the
    record, the kernel-table row, the greedy run's launch counts)."""
    from paddle_tpu_torch.inference import generate, prefill
    from paddle_tpu_torch.ops import rope

    cfg = model.cfg
    L = cfg.num_layers
    want = {"dropout": 0, "rms_norm": 0, "smem_probe": 0,
            "dead_row_sums": 0,
            "attention_keep_words": 0,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_decode_step": 0,
            "fused_paged_decode_step": 0, "fused_paged_verify_step": 0,
            "fused_decode_moe_step": NEW - 1}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, top_p=0.9,
                                      seed=7))):
        torch.cuda.synchronize()
        reset_counts(fa, fd)
        t0 = time.perf_counter()
        out = generate(model, ids, max_new_tokens=NEW, cache_dtype=torch.int8,
                       **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, in_int8 = counts(fa, fd), fd.fused_decode_moe_cuda.int8_kv
        new = out[:, PROMPT:]
        if got != want or in_int8 != NEW - 1:
            raise AssertionError(f"moe int8 {name}: launch counts {got} "
                                 f"({in_int8} in the int8 KV mode), "
                                 f"expected {want}")
        if tuple(out.shape) != (B, PROMPT + NEW) \
                or not torch.equal(out[:, :PROMPT], ids) \
                or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
            raise AssertionError(f"moe int8 {name}: bad tokens "
                                 f"{tuple(out.shape)}")
        runs[name] = {"wall_s": wall, "launches": got,
                      "int8_kv_launches": in_int8,
                      "first_tokens": new[:, :8].tolist()}
    reset_counts(fa, fd)

    def wall(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=n, cache_dtype=torch.int8)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ttft_s = min(wall(1) for _ in range(2))
    gen_s = wall(NEW)
    gen_peak = torch.cuda.max_memory_allocated()
    reset_counts(fa, fd)
    total = -(-(PROMPT + NEW) // 128) * 128
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
              eps=cfg.rms_norm_eps, top_k=cfg.top_k)
    with torch.inference_mode():
        logits, kv = prefill(model, ids, total, fused=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        del logits
        kvq, sc = fd.quantize_kv_cache(kv, cfg.kv_heads)
        del kv
        plan = model.fused_decode_plan(model.state_dict(include_buffers=False))
        params = plan["params"]
        cos, sin = rope.rope_cos_sin(total, cfg.head_dim, device="cuda")
        pos = PROMPT
        x = plan["embed"](tok, pos)
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
        kq = dict(kw, kv_scales=sc)
        kr, pr = {}, {}
        xk, kv_k = fd.fused_decode_moe_cuda(x, params, kvq.clone(), pos, c,
                                            s, routing=kr, **kq)
        lk = plan["head"](xk).float()
        xp, _ = fd.fused_decode_reference(x, params, kvq.clone(), pos, c, s,
                                          arch="moe", routing=pr, **kq)
        lp = plan["head"](xp).float()
        xf_, kv_f = fd.fused_decode_reference(
            x, params, kvq.clone(), pos, c, s, arch="moe",
            routing={"force_ids": kr["ids"]}, **kq)
        lf = plan["head"](xf_).float()
        rows = compare_routing(kr, pr, K6_FLIP_GAP_DEEP)
        kept = [r["row"] for r in rows if r["first_swap_layer"] is None]
        logit_err, logits_ok = close(lk[kept], lp[kept], SERVE_LOGIT_ATOL,
                                     E2E_RTOL) if kept else (0.0, True)
        forced_err, forced_ok = close(lk, lf, SERVE_LOGIT_ATOL, E2E_RTOL)
        steps, one, two = int8_rows(kv_k, kv_f, pos)
        # every layer's appends on one input
        n0, i0 = fd.fused_decode_moe_cuda.launches, \
            fd.fused_decode_moe_cuda.int8_kv
        kv_k.copy_(kvq)
        kv_f.copy_(kvq)
        xl = x
        for layer in range(L):
            sl = slice(layer, layer + 1)
            p1 = {k: v[sl] for k, v in params.items()}
            k1 = dict(kw, kv_scales=sc[sl])
            xn, kv_k[sl] = fd.fused_decode_moe_cuda(xl, p1, kv_k[sl], pos, c,
                                                    s, **k1)
            kv_f[sl] = fd.fused_decode_reference(xl, p1, kv_f[sl], pos, c, s,
                                                 arch="moe", **k1)[1]
            xl = xn
        fd.fused_decode_moe_cuda.launches = n0
        fd.fused_decode_moe_cuda.int8_kv = i0
        steps1, one1, _ = int8_rows(kv_k, kv_f, pos)
        del kv_k, kv_f
        lanes = L * B * 2 * cfg.kv_heads * cfg.head_dim
        tf = {"rows_swapped": B - len(kept), "routing": rows,
              "logit_max_abs_err_unswapped_rows": logit_err,
              "argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                    .float().mean()),
              "logit_absmax": lp.abs().max().item(),
              "kernel_routing_logit_max_abs_err": forced_err,
              "per_layer_appended_rows_max_int8_steps": steps1,
              "per_layer_appended_lanes_one_step_apart": one1,
              "appended_rows_max_int8_steps": steps,
              "appended_lanes_one_step_apart": one,
              "appended_lanes_two_steps_apart": two,
              "appended_lanes": lanes,
              "vs_bf16_cache_logit_max_abs_diff":
                  (lk - lk_bf16).abs().max().item(),
              "vs_bf16_cache_argmax_agree": float(
                  (lk.argmax(-1) == lk_bf16.argmax(-1)).float().mean()),
              "atol": SERVE_LOGIT_ATOL, "rtol": E2E_RTOL,
              "flip_gap": K6_FLIP_GAP_DEEP, "int8_drift": MOE_INT8_DRIFT,
              "ok": (logits_ok and forced_ok and all(r["ok"] for r in rows)
                     and steps1 <= 1
                     and steps <= MOE_INT8_DRIFT["max_steps"]
                     and one <= MOE_INT8_DRIFT["one_step_share"] * lanes
                     and two <= MOE_INT8_DRIFT["two_step_share"] * lanes)}
        tpos = PROMPT + 32
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        xb = rand((B, cfg.hidden_size), gen)
        c, s = cos[tpos:tpos + 1], sin[tpos:tpos + 1]
        route = {}
        fd.fused_decode_moe_cuda(xb, params, kvq, tpos, c, s, routing=route,
                                 **kq)
        ms = time_ms(lambda: fd.fused_decode_moe_cuda(
            xb, params, kvq, tpos, c, s, **kq), iters=20)
        plain = time_ms(lambda: fd.fused_decode_reference(
            xb, params, kvq, tpos, c, s, arch="moe", **kq), iters=2,
            warmup=1)
        bound = moe_bound(params, kvq, tpos, route["ids"].cpu(), B, bw, flops,
                          cfg.num_heads, cfg.head_dim, kv_scales=sc)
        reset_counts(fa, fd)
        del plan, params, kvq
    t = dict(bound, ms=ms, plain_ms=plain, pos=tpos)
    res = {"cache": "int8 (quantize_kv_cache after a bf16 prefill)",
           "runs": runs, "ttft_ms": ttft_s * 1e3,
           "decode_ms_per_step": (gen_s - ttft_s) / (NEW - 1) * 1e3,
           "generate_ms": gen_s * 1e3, "tokens_per_s": B * NEW / gen_s,
           "max_memory_allocated_generate": gen_peak,
           "teacher_forced": tf, "k6_timing": t}
    row = {"name": "fused_decode_moe_step_int8kv", "mode": "int8 KV cache",
           "route": "cuda", "source": "paddle_tpu_torch/csrc/fused_decode.cu",
           "replaces": "paddle_tpu/ops/fused_decode.py:1049 (kv_scales: "
                       ":1082, :1110-1112)",
           "launches": runs["greedy"]["int8_kv_launches"],
           "max_abs_err": k6q_err, "ms": ms, "plain_ms": plain,
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": None,
           "at_shape": {"b": B, "layers": L, "pos": tpos,
                        "mean_distinct_experts": t["mean_distinct_experts"]},
           "launches_by_path": {"moe_int8": runs["greedy"]["int8_kv_launches"]}}
    return res, row, runs["greedy"]["launches"]


# ---- Mistral-7B: the causal sliding window through generate ------------------

MISTRAL_B, MISTRAL_PROMPT, MISTRAL_NEW = 2, 8192, 64
# The teacher-forced last decode step (the cache path: a prefill of 8192
# rows and 63 one-row steps, K1 at sq = 1 with the window at position 8254).
# Its attention is held layer by layer against K1's plain version over the
# cached K/V the step read (`CheckedAttention`, K1's tolerances). Its logits
# are held against a windowed no-cache forward of the same 8255 tokens (K1
# at sq = 8255): every K/V row of the two sides comes out of products of
# other row counts, so bf16 flips leave noise in all 32 layers' keys, larger
# than one step's against its plain version. MISTRAL_TF_ATOL is that
# noise's limit, fixed from its readings on an H100 (PERF.md §6): the
# generated tokens and MISTRAL_TF_DRAWS random sequences, 2 rows each, with
# the window and without it, 16 readings in 0.180-0.242 at logits of
# |5.8|; the limit is 1.55x the largest, and a wrong attention moves a
# logit by O(1) (the window's own effect is 6.5). The window's own effect on
# the last logits (with it against without, no-cache) must stand
# MISTRAL_EFFECT_FACTOR above every noise reading, and the logits below
# position 4096, where the window masks nothing, must not move at all.
MISTRAL_TF_ATOL, MISTRAL_TF_DRAWS, MISTRAL_EFFECT_FACTOR = 0.375, 3, 8.0


class PlainAttention(PlainCalls):
    """Counts calls of the attention's plain versions (the dispatch and
    K1's wrapper look them up at call time): a `generate` on the card must
    run none."""

    NAMES = ("flash_attention_fwd_plain", "_xla_attention")


class CheckedAttention:
    """Holds every K1 call made while it is open against K1's plain version
    on the same inputs as the call saw them (`k1_agreement`): a decode
    step's attention, layer by layer, over the cached K/V it read."""

    def __init__(self, fa):
        self.fa, self.calls = fa, []
        # the wrapper's counters (ops.flash_attention: launches, by_d and
        # each mode's), which it bumps on the module's name
        self.counts = ("launches", "by_d") + fa.MODE_COUNTERS

    def __enter__(self):
        self.saved = kernel = self.fa.flash_attention_fwd

        def call(q, k, v, **kw):
            out, lse = kernel(q, k, v, **kw)
            self.calls.append(k1_agreement(
                out, lse, *self.fa.flash_attention_fwd_plain(q, k, v, **kw)))
            return out, lse
        # the wrapper counts its launches on the module's name, this call
        for count in self.counts:
            setattr(call, count, getattr(kernel, count))
        self.fa.flash_attention_fwd = call
        return self

    def __exit__(self, *exc):
        for count in self.counts:
            setattr(self.saved, count,
                    getattr(self.fa.flash_attention_fwd, count))
        self.fa.flash_attention_fwd = self.saved


KERNEL_FAMILIES = (
    ("K1 flash_attention_fwd", ("flash_fwd_sm90",)),
    ("K3 flash_attention_bwd_dq", ("flash_bwd_dq_sm90",)),
    ("K4 flash_attention_bwd_dkv", ("flash_bwd_dkv_sm90",)),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass",
                                  "gemv")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("copies and dtype casts", ("copy",)),
    ("W attention keep words (ops.dropout)", ("keep_words_kernel",)),
    ("hidden dropout (ops.dropout)", ("dropout_kernel",)))



def traced_step(fn, reps=3, families=KERNEL_FAMILIES):
    """The card's side of a call that launches more kernels than the launch
    queue holds (a layered decode step, a train step: device_ms cannot
    queue it behind a sleep), from a torch.profiler trace over `reps` calls
    after an untraced one: per call the busy time (the union of the device
    activities' intervals), the activities, the device time by kernel
    family (`families`, the first matching a kernel's name; by default K1,
    K3, K4 on their own, the products, the optimizer, copies, the rest) and
    the first family's (K1's) alone, and each family's three longest
    kernels by name (what the matching put there). None where the trace
    holds no device activity (not measured)."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    fams, names = {}, {}
    for ev in evs:
        low = ev.name.lower()
        fam = next((f for f, keys in families
                    if any(key.lower() in low for key in keys)),
                   "other (elementwise, reductions)")
        t = (ev.time_range.end - ev.time_range.start) / 1e3
        fams[fam] = fams.get(fam, 0.0) + t
        by_name = names.setdefault(fam, {})
        by_name[ev.name] = by_name.get(ev.name, 0.0) + t
    busy, start, end = 0.0, None, None
    for a, b in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in evs):
        if end is None or a > end:
            busy += 0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    return {"busy_ms": busy / reps / 1e3, "device_activities": len(evs) / reps,
            "device_ms_by_family": {f: v / reps for f, v in
                                    sorted(fams.items(), key=lambda kv:
                                           -kv[1])},
            "k1_ms": fams.get(families[0][0], 0.0) / reps,
            "top_kernels_by_family": {
                f: [[n[:160], v / reps] for n, v in sorted(
                    by.items(), key=lambda kv: -kv[1])[:3]]
                for f, by in names.items()}}


def window_pairs(sq, off, window, kv_len):
    """Visible (query, key) pairs of one (batch, head) under the window:
    row i sees keys max(0, off + i - window + 1) … min(off + i, kv_len - 1)."""
    p = np.arange(sq) + off
    hi = np.minimum(p, kv_len - 1)
    lo = np.maximum(0, p - window + 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def k1_window_timing(fa, gen, bw, flops, b, h, nkv, sq, sk, d, q_off,
                     kv_len, window, groups_plain=False):
    """K1's window mode at one of the `mistral` path's call shapes: held
    against its plain fp32 version as phase k1 holds it (`k1_agreement`:
    out and lse within K1's tolerances, rows with no key exact) and
    launched twice with the same bits ("ok"; at the prefill shape the plain
    version runs one kv-head group after another: the whole shape's fp32
    scores would take 17 GB a temporary); then CUDA events over its
    wrapper, the device time, the plain version's time, torch sdpa with
    the equivalent dense mask (`library_ms`), the bound from this shape's
    visible pairs, and the windowless causal kernel at the same shape."""
    q = rand((b, sq, h, d), gen)
    k = rand((b, sk, nkv, d), gen)
    v = rand((b, sk, nkv, d), gen)
    kl = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
    kw = dict(is_causal=True, causal_offset=q_off, kv_lens=kl)
    fw = lambda: fa.flash_attention_fwd(q, k, v, window=window, **kw)
    ms = time_ms(fw, iters=20)
    dev = device_ms(fw, iters=20)
    ms_full = time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), iters=20)
    out, lse = fw()
    out2, lse2 = fw()
    repeat = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
    del out2, lse2
    rep = h // nkv
    if groups_plain:
        def plain():
            return [fa.flash_attention_fwd_plain(
                q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1],
                v[:, :, g:g + 1], window=window, **kw) for g in range(nkv)]
        groups = []
        for g in range(nkv):   # one group's fp32 temporaries at a time
            hs = slice(g * rep, (g + 1) * rep)
            ref, ref_lse = fa.flash_attention_fwd_plain(
                q[:, :, hs], k[:, :, g:g + 1], v[:, :, g:g + 1],
                window=window, **kw)
            groups.append(k1_agreement(out[:, :, hs], lse[:, hs], ref,
                                       ref_lse))
            del ref, ref_lse
        check = {key: max(c[key] for c in groups)
                 for key in ("max_abs_err", "lse_max_abs_err")}
        check.update(dead_rows=sum(c["dead_rows"] for c in groups),
                     dead_rows_ok=all(c["dead_rows_ok"] for c in groups),
                     ok=all(c["ok"] for c in groups))
    else:
        plain = lambda: fa.flash_attention_fwd_plain(q, k, v, window=window,
                                                     **kw)
        check = k1_agreement(out, lse, *plain())
    check["repeat_bitwise"] = repeat
    check["ok"] = check["ok"] and repeat
    del out, lse
    plain_ms = time_ms(plain, iters=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qp = torch.arange(sq, device="cuda")[:, None] + q_off
    kp = torch.arange(sk, device="cuda")[None, :]
    mask = ((kp <= qp) & (kp > qp - window) & (kp < kv_len))[None, None]
    # the kv heads repeated to h outside the timed call: sdpa's kernels
    # that take a mask take no GQA
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(rep, dim=1) for t in (k, v))
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), iters=20)
    pairs = window_pairs(sq, q_off, window, kv_len) * b * h
    full_pairs = window_pairs(sq, q_off, sq + q_off + 1, kv_len) * b * h

    def bound(k_lo, npairs):
        # q and out, the keys and values some row sees (from k_lo), lse
        k_used = min(kv_len, q_off + sq) - k_lo
        nbytes = (2 * q.numel() * 2 + 2 * b * k_used * nkv * d * 2
                  + b * h * sq * 4)
        t_b, t_o = nbytes / bw * 1e3, 4 * d * npairs / flops * 1e3
        return nbytes, max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    nbytes, bound_ms, bound_by = bound(max(0, q_off - window + 1), pairs)
    return {"shape_b_sq_sk_h_nkv_d": [b, sq, sk, h, nkv, d],
            "causal_offset": q_off, "kv_len": kv_len, "window": window,
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_covers": "torch sdpa over the dense bool window mask, "
                              "kv heads repeated beforehand",
            **check, "tol": K1_TOL_OUT, "lse_tol": K1_TOL_LSE,
            "visible_pairs": pairs, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": 4 * d * pairs / ms / 1e9,
            "bound_share": bound_ms / ms, "windowless_ms": ms_full,
            "windowless_bound_ms": bound(0, full_pairs)[1]}


def phase_mistral(fa, fd, bw, flops, k1w_err):
    """Mistral-7B (32 layers, h 4096, ffn 14336, GQA 32/8, window 4096;
    bf16, random weights from seed 0) through inference.generate, b=2,
    prompt 8192, 64 new tokens, greedy: the layered path (the fused plan
    refuses a window), K1 with the window 32 times for the prefill and 32
    a decode step, nothing else, no plain attention; TTFT, decode ms/step,
    tokens/s, peak memory; the last decode step teacher-forced, its
    attention held layer by layer against K1's plain version
    (`CheckedAttention`) and its logits against a windowed no-cache forward
    of the same tokens within MISTRAL_TF_ATOL, that noise also read without
    the window and on MISTRAL_TF_DRAWS random sequences; the same weights
    without the window give the same logits below position 4096 and others
    past it; K1's window mode held against its plain version and timed at
    the prefill and the decode shape."""
    from paddle_tpu_torch.inference import generate, prefill
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.mistral_7b()
    L, b, n, new = cfg.num_layers, MISTRAL_B, MISTRAL_PROMPT, MISTRAL_NEW
    w = cfg.sliding_window
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params()
    plan = model.fused_decode_plan(model.state_dict(include_buffers=False),
                                   probe=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (b, n), device="cuda",
                        generator=gen)
    torch.cuda.synchronize()
    reset_counts(fa, fd)
    with PlainAttention(fa) as plain:
        t0 = time.perf_counter()
        out = generate(model, ids, max_new_tokens=new)
        torch.cuda.synchronize()
        first_wall = time.perf_counter() - t0
    got = counts(fa, fd)
    want = dict.fromkeys(got, 0)
    want["flash_attention_fwd"] = L + (new - 1) * L
    if got != want or plain.n or plan is not None:
        raise AssertionError(f"mistral: launch counts {got} (expected "
                             f"{want}), plain calls {plain.n}, plan {plan}")
    gen_tokens = out[:, n:]
    if tuple(out.shape) != (b, n + new) or not torch.equal(out[:, :n], ids) \
            or int(gen_tokens.min()) < 0 \
            or int(gen_tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"mistral: bad tokens {tuple(out.shape)}")
    reset_counts(fa, fd)

    def wall(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ttft_s = min(wall(1) for _ in range(2))
    gen_s = wall(new)
    gen_peak = torch.cuda.max_memory_allocated()

    def cache_path(tokens, check=None):
        """generate's decode steps again, teacher-forced with `tokens`
        (b, n + new - 1): a prefill of n rows, then one row a step; the
        last step (position n + new - 2) gives the last token's logits.
        check: a CheckedAttention open around that last step. Also returns
        that step as a call (rerun in place, it writes the same K/V row)."""
        logits, cache = prefill(model, tokens[:, :n], n + new)
        del logits
        for i in range(1, new):
            pos = n + i - 1
            step = lambda: model(tokens[:, pos:pos + 1], cache=cache,
                                 start_pos=pos)
            if i == new - 1 and check is not None:
                with check:
                    lc, cache = step()
            else:
                lc, cache = step()
        return lc[:, -1].float(), step

    def noise(tokens):
        """Per row, max |cache path − no-cache forward| over the last
        logits, with the window and (cfg.sliding_window None: every layer
        shares this config) without it."""
        rows = {}
        for key, win in (("window", w), ("no_window", None)):
            cfg.sliding_window = win
            try:
                lc, _ = cache_path(tokens)
                lf = model(tokens)[:, -1].float()
            finally:
                cfg.sliding_window = w
            rows[key] = (lc - lf).abs().amax(-1).tolist()
        return rows

    seq = out[:, :n + new - 1]
    checked = CheckedAttention(fa)
    with torch.inference_mode():
        lc, step = cache_path(seq, checked)
        step_trace = traced_step(step)
        del step
        lw = model(seq)
        lw_last, lw_in = lw[:, -1].float(), lw[:, :w].float()
        del lw
        cfg.sliding_window = None
        try:
            lc_full, _ = cache_path(seq)
            lf = model(seq)
        finally:
            cfg.sliding_window = w
        lf_last, lf_in = lf[:, -1].float(), lf[:, :w].float()
        del lf
        # the same readings on random sequences of the same length
        draws = [noise(torch.randint(0, cfg.vocab_size, seq.shape,
                                     device="cuda", generator=gen))
                 for _ in range(MISTRAL_TF_DRAWS)]
    readings = {"window": (lc - lw_last).abs().amax(-1).tolist(),
                "no_window": (lc_full - lf_last).abs().amax(-1).tolist()}
    for d in draws:
        for key in readings:
            readings[key] += d[key]
    tf_err = max(readings["window"][:b])
    noise_max = max(readings["window"] + readings["no_window"])
    inside = (lf_in - lw_in).abs().max().item()
    past = (lf_last - lw_last).abs().max().item()
    full_vs_cache = (lf_last - lc).abs().max().item()
    finite = bool(torch.isfinite(lc).all() and torch.isfinite(lw_last).all())
    argmax_ok = bool(torch.equal(lc.argmax(-1), out[:, -1]))
    del lw_in, lf_in
    peak = torch.cuda.max_memory_allocated()
    wbytes = sum(p.numel() * p.element_size()
                 for name, p in model.named_parameters()
                 if "embed_tokens" not in name)
    kv_bytes = L * b * w * 2 * cfg.kv_heads * cfg.head_dim * 2
    decode_s = (gen_s - ttft_s) / (new - 1)
    attn = checked.calls
    attention = {"layers": len(attn), "ok": len(attn) == L and all(
                     c["ok"] for c in attn),
                 "max_abs_err": max((c["max_abs_err"] for c in attn),
                                    default=None),
                 "lse_max_abs_err": max((c["lse_max_abs_err"] for c in attn),
                                        default=None),
                 "tol": K1_TOL_OUT, "lse_tol": K1_TOL_LSE}
    tf = {"position": n + new - 2,
          "last_step_attention_vs_plain": attention,
          "logit_max_abs_err_vs_no_cache": tf_err,
          "noise_readings_per_row": readings,
          "random_draws": MISTRAL_TF_DRAWS, "tol": MISTRAL_TF_ATOL,
          "argmax_equals_generated": argmax_ok, "finite": finite,
          "logit_absmax": lw_last.abs().max().item(),
          "no_window_vs_window_below_window_max_abs": inside,
          "no_window_vs_window_last_max_abs": past,
          "no_window_vs_window_cache_last_max_abs": full_vs_cache,
          "window_effect_over_noise": past / max(noise_max, 1e-9)}
    tf["ok"] = (finite and argmax_ok and attention["ok"]
                and max(readings["window"]) <= MISTRAL_TF_ATOL
                and inside == 0.0
                and tf["window_effect_over_noise"] >= MISTRAL_EFFECT_FACTOR)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tg = torch.Generator(device="cuda")
    tg.manual_seed(5)
    h, nkv, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    pos = n + new - 2
    timing = {
        "prefill": k1_window_timing(fa, tg, bw, flops, b, h, nkv, n, n + new,
                                    d, 0, n, w, groups_plain=True),
        "decode": k1_window_timing(fa, tg, bw, flops, b, h, nkv, 1, n + new,
                                   d, pos, pos + 1, w)}
    reset_counts(fa, fd)
    res = {"phase": "mistral", "model": "mistral_7b", "layers": L,
           "dtype": "bfloat16", "params": n_params, "window": w,
           "batch": b, "prompt": n, "new": new, "init_s": init_s,
           "fused_plan": None, "launches": got, "plain_attention_calls": 0,
           "first_call_wall_s": first_wall,
           "first_tokens": gen_tokens[:, :8].tolist(),
           "ttft_ms": ttft_s * 1e3, "decode_ms_per_step": decode_s * 1e3,
           "generate_ms": gen_s * 1e3, "tokens_per_s": b * new / gen_s,
           "decode_step_bound_ms": (wbytes + kv_bytes) / bw * 1e3,
           "decode_step_bytes": {"weights_and_head": wbytes,
                                 "kv_in_window": kv_bytes},
           "max_memory_allocated_generate": gen_peak,
           "max_memory_allocated": peak,
           "decode_step_trace": step_trace,
           "decode_step_device_idle_share": None if step_trace is None
               else 1 - step_trace["busy_ms"] / (decode_s * 1e3),
           "teacher_forced": tf,
           "k1_window_timing": timing}
    emit(res)
    if not tf["ok"]:
        raise AssertionError(f"mistral: teacher-forced check failed {tf}")
    bad = {k: t for k, t in timing.items() if not t["ok"]}
    if bad:
        raise AssertionError(f"mistral: K1's window mode disagrees with its "
                             f"plain version at the path's shapes: {bad}")
    t = timing["prefill"]
    row = {"name": "flash_attention_fwd", "mode": "causal sliding window",
           "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention.cu",
           "replaces": "paddle_tpu/ops/flash_attention.py:526 "
                       "(window: _window_k0 :465, mask :411)",
           "launches": got["flash_attention_fwd"], "max_abs_err": max(
               k1w_err, t["max_abs_err"], timing["decode"]["max_abs_err"]),
           "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"], "at_prefill": t,
           "at_decode": timing["decode"]}
    return row, got


# ---- training -----------------------------------------------------------------

# GPT-2 345M's, train_llama's and train_mistral's attention calls: b, S,
# heads, kv heads, head_dim
BWD_TIME_SHAPES = {"gpt2_345m": (8, 1024, 16, 16, 64),
                   "tinyllama_1b": (4, 2048, 32, 4, 64),
                   "mistral_7b": (1, 8192, 32, 8, 128)}


def phase_bwd_times(fa):
    """The windowless K3 and K4 at BWD_TIME_SHAPES, causal: CUDA events
    over 20 launches and the kernels' device time (`device_ms`), as phase
    timing_train times them. No call takes a window, so a tree from
    before the window runs it too (the package imported is the tree's
    beside this script)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rows = {}
    for name, (b, s, h, nkv, d) in BWD_TIME_SHAPES.items():
        q, do = rand((b, s, h, d), gen), rand((b, s, h, d), gen)
        k, v = rand((b, s, nkv, d), gen), rand((b, s, nkv, d), gen)
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd(q, k, v, is_causal=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        f3 = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               is_causal=True)
        f4 = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                is_causal=True)
        rows[name] = {"b_s_h_nkv_d": [b, s, h, nkv, d],
                      "k3_ms": time_ms(f3, iters=20),
                      "k4_ms": time_ms(f4, iters=20),
                      "k3_device_ms": device_ms(f3, iters=20),
                      "k4_device_ms": device_ms(f4, iters=20)}
    emit({"phase": "bwd_times", "package": os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(fa.__file__)))), "causal": True,
        "window": None, "shapes": rows})


def phase_train(fa, fd, flops):
    from paddle_tpu_torch import bench
    cfg, b, s, steps = bench.config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, x, y = bench.build(cfg, b, s, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params()
    t0 = time.perf_counter()
    warm = bench.run_steps(model, opt, x, y, steps).tolist()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts(fa, fd)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    timed = bench.run_steps(model, opt, x, y, steps)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts(fa, fd)
    reset_counts(fa, fd)
    dev_s = e0.elapsed_time(e1) / 1e3
    losses = warm + timed.tolist()
    tok_s = b * s * steps / dev_s
    fpt = bench.flops_per_token(cfg, n_params, s)
    want = cfg.num_layers * steps
    res = {"phase": "train", "model": "gpt2_medium", "layers": cfg.num_layers,
           "dtype": "bfloat16", "params": n_params, "batch": b, "seq": s,
           "steps": steps, "init_s": init_s, "warmup_pass_s": warm_s,
           "step_ms": 1e3 * dev_s / steps, "wall_step_ms": 1e3 * wall / steps,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": tok_s * fpt / flops, "mfu_basis": "dense_6n",
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses_timed_pass": losses[steps:], "launches": got,
           "launches_expected": want}
    emit(res)
    if got != {"dropout": 0, "rms_norm": 0, "smem_probe": 0,
               "dead_row_sums": 0,
               "attention_keep_words": 0,
               "flash_attention_fwd": want, "flash_attention_bwd_dq": want,
               "flash_attention_bwd_dkv": want, "fused_decode_step": 0,
               "fused_paged_decode_step": 0, "fused_paged_verify_step": 0,
               "fused_decode_moe_step": 0}:
        raise AssertionError(f"train: launch counts {got}, expected {want} "
                             "each of K1, K3, K4")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss not finite or not falling: "
                             f"{losses}")
    return got


def phase_step(fa, fd):
    """One train step of a 2-layer full-width GPT: card (bf16, kernels) vs
    CPU (fp32, plain versions), from the same weights."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import GPTPretrainModel
    cfg = dataclasses.replace(bench.config()[0], num_layers=2)
    model, _, x, y = bench.build(cfg, 1, 1024, "cuda")
    ref = GPTPretrainModel(cfg, dtype=torch.float32, device="cpu", seed=1)
    ref.set_state_dict({k: t.float().cpu() for k, t in
                        model.state_dict(include_buffers=False).items()})
    reset_counts(fa, fd)
    loss = model.loss(model(x), y)
    loss.backward()
    torch.cuda.synchronize()
    got = counts(fa, fd)
    loss_ref = ref.loss(ref(x.cpu()), y.cpu())
    loss_ref.backward()
    if counts(fa, fd) != got:
        raise AssertionError("the CPU reference step launched a kernel")
    rel = {}
    for (name, p), rp in zip(model.named_parameters(), ref.parameters()):
        rel[name] = ((p.grad.float().cpu() - rp.grad).norm()
                     / rp.grad.norm()).item()
    worst = max(rel, key=rel.get)
    loss_err = abs(loss.item() - loss_ref.item())
    res = {"phase": "step", "layers": 2, "hidden": cfg.hidden_size,
           "heads": cfg.num_heads, "vocab": cfg.vocab_size, "batch": 1,
           "seq": 1024, "loss": loss.item(), "loss_ref_fp32_cpu":
           loss_ref.item(), "loss_abs_err": loss_err,
           "loss_atol": STEP_LOSS_ATOL, "grad_rel_err_max": rel[worst],
           "grad_rel_err_worst_param": worst,
           "grad_rel_err_by_param": rel, "grad_rel_tol": STEP_GRAD_RTOL,
           "launches": got}
    emit(res)
    if got["flash_attention_fwd"] != 2 or got["flash_attention_bwd_dq"] != 2 \
            or got["flash_attention_bwd_dkv"] != 2:
        raise AssertionError(f"step: launch counts {got}, expected 2 each")
    if not (loss_err <= STEP_LOSS_ATOL and rel[worst] <= STEP_GRAD_RTOL):
        raise AssertionError(f"step: loss off by {loss_err}, or {worst} "
                             f"gradient off by {rel[worst]} (relative)")


def causal_attention_work(b, h, s, d):
    """(visible pairs, {k1, k3, k4: (bytes, FLOPs)}) of causal MHA at (b, s,
    h, d): K1 reads q, k, v and writes out and lse; K3 reads q, k, v, dO,
    lse, Δ and writes dq; K4 the same and writes dk, dv; 4·d, 6·d and 8·d
    FLOPs a visible pair."""
    pairs = b * h * s * (s + 1) // 2
    row = b * h * s * 4                      # one fp32 (b, h, s) tensor
    t_bf = b * s * h * d * 2                 # one bf16 (b, s, h, d) tensor
    return pairs, {"k1": (4 * t_bf + row, 4 * d * pairs),
                   "k3": (5 * t_bf + 2 * row, 6 * d * pairs),
                   "k4": (6 * t_bf + 2 * row, 8 * d * pairs)}


def phase_timing_train(fa, bw, flops, kernels, train_launches, k3_errs):
    """K1, K3 and K4 at the GPT-2 345M training shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    b, h, s, d = 8, 16, 1024, 64
    q, k, v, do = (rand((b, s, h, d), gen) for _ in range(4))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, is_causal=True)
    delta_fn = lambda: (do.float() * out.float()).sum(-1).transpose(
        1, 2).contiguous()
    delta = delta_fn()
    f1 = lambda: fa.flash_attention_fwd(q, k, v, is_causal=True)
    f3 = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                           is_causal=True)
    f4 = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            is_causal=True)
    ms1, ms3, ms4 = (time_ms(f, iters=20) for f in (f1, f3, f4))
    dev3, dev4 = (device_ms(f, iters=20) for f in (f3, f4))
    delta_ms = time_ms(delta_fn, iters=20)
    plain1 = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, is_causal=True), iters=3, warmup=1)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, is_causal=True), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    with torch.no_grad():
        lib1 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=20)
    # sdpa's backward alone, over one retained graph, as the card's time of
    # its kernels: CUDA events around autograd's calls time the host, which
    # here takes longer than the kernels and varies from run to run
    o_lib = sdpa(qt, kt, vt, is_causal=True)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), dot, retain_graph=True), iters=20)
    pairs, work = causal_attention_work(b, h, s, d)
    bound = {}
    for key, (nbytes, nflops) in work.items():
        tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
        bound[key] = (max(tb, to), "bytes" if tb >= to else "operations")
    k1 = kernels[0]
    k1["at_train_shape"] = {
        "shape_b_s_h_d": [b, s, h, d], "causal": True, "ms": ms1,
        "plain_ms": plain1, "bound_ms": bound["k1"][0],
        "bound_by": bound["k1"][1], "library_ms": lib1,
        "tflops": work["k1"][1] / ms1 / 1e9,
        "library_tflops": work["k1"][1] / lib1 / 1e9,
        "bound_share": bound["k1"][0] / ms1}
    k1["launches_by_path"] = {"generate": k1["launches"],
                              "train": train_launches["flash_attention_fwd"]}
    kernels[1]["launches_by_path"] = {
        "generate": kernels[1]["launches"],
        "train": train_launches["fused_decode_step"]}
    pair = {"plain_ms_covers": "flash_attention_bwd_plain: dq, dk and dv",
            "library_ms_covers": "backward of torch sdpa over a retained "
                                 "graph, its kernels' device time "
                                 "(device_ms): dq, dk and dv"}
    for name, line, ms, dev, key, err, design in (
            ("flash_attention_bwd_dq", 668, ms3, dev3, "k3", k3_errs[0],
             "redesigned: TMA ring, wgmma, warp specialisation, the next "
             "tile's products issued before this tile's dq"),
            ("flash_attention_bwd_dkv", 787, ms4, dev4, "k4", k3_errs[1],
             "redesigned: TMA ring, wgmma, warp specialisation")):
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_bwd, "bound_ms": bound[key][0],
            "bound_by": bound[key][1], "library_ms": lib_bwd,
            "launches_by_path": {"generate": 0, "train": train_launches[name]},
            "shape_b_s_h_d": [b, s, h, d], "causal": True,
            "tflops": work[key][1] / ms / 1e9,
            "bound_share": bound[key][0] / ms, "device_ms": dev,
            "design": design}, **pair))
    emit({"phase": "timing_train", "shape_b_s_h_d": [b, s, h, d],
          "causal": True, "visible_pairs": pairs, "delta_ms": delta_ms,
          "sdpa_bwd_ms": lib_bwd,
          "sdpa_bwd_tflops": (work["k3"][1] + work["k4"][1]) / lib_bwd / 1e9,
          "k3_plus_k4_over_sdpa_bwd": (ms3 + ms4) / lib_bwd,
          "k3_plus_k4_device_over_sdpa_bwd": (dev3 + dev4) / lib_bwd,
          "work_bytes_flops": work, "kernels": kernels[:1] + kernels[2:]})
    return kernels


# ---- Llama-family training ----------------------------------------------------------

class PlainTraining(PlainCalls):
    """Counts calls of the attention's plain versions, forward and backward
    (FlashAttention and the dispatch look them up at call time): a train
    step on the card must run none."""

    NAMES = ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
             "_xla_attention")


class PlainKernelsOnCard:
    """While open, FlashAttention's forward and backward run the plain
    versions on the card in place of K1 and K3/K4 (the Function and the
    dispatch look them up on the module at call time), one kv-head group
    at a time (`grouped_plain`: an 8192-row batch's fp32 scores a group at
    once). The wrappers, and their launch counts, are left as they were:
    read the counts outside."""

    def __init__(self, fa):
        self.fa = fa

    def __enter__(self):
        fa = self.fa
        self.saved = fa.flash_attention_fwd, fa.flash_attention_bwd

        def fwd(q, k, v, bounds=None, **kw):   # the kernels' tile bounds
            return grouped_plain(fa, q, k, v, kw)

        def bwd(q, k, v, out, lse, dout, bounds=None, g_lse=None, **kw):
            grads = grouped_plain(fa, q, k, v, kw, out, lse, dout, g_lse)
            return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_fwd, self.fa.flash_attention_bwd = self.saved


def phase_llama_step(fa, fd):
    """One loss and gradient of train_llama's model cut to 2 layers
    (TinyLlama-1.1B's full width, b 4, S 2048, recompute core_attn, 4 loss
    chunks) on the card, from the same weights and batch: as train_llama
    computes them (the selective recompute must save exactly core_attn's
    names; its replays run on autograd's device thread); without
    recompute, which must give the same loss and gradients bit for bit
    (the replays run the same kernels on the same inputs, and the
    backward's graph is the same); and against the same step in fp32 with
    the attention's plain versions (`PlainKernelsOnCard`), within
    STEP_LOSS_ATOL and STEP_GRAD_RTOL as phase step holds GPT-2's. The bf16
    step with the plain attention is read against that reference too: the
    noise of bf16 alone."""
    from paddle_tpu_torch import train_bench
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import RECOMPUTE_SAVES
    from paddle_tpu_torch.utils import recompute as rc
    cfg = dataclasses.replace(train_bench.config("llama-1b"), num_layers=2)
    b, s = LLAMA_TRAIN_ATTN[0], LLAMA_TRAIN_ATTN[3]
    model, _, x, y = train_bench.build(cfg, b, s, "cuda")
    ref = LlamaForCausalLM(cfg, dtype=torch.float32, device="cuda", seed=1)
    ref.set_state_dict({k: t.float() for k, t in
                        model.state_dict(include_buffers=False).items()})

    def grads(m):
        loss = m.train_loss(x, y)
        loss.backward()
        got = {n: p.grad for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        torch.cuda.synchronize()
        return loss.item(), got

    def rel(g, g_ref):
        return {n: ((g[n].float() - r).norm() / r.norm()).item()
                for n, r in g_ref.items()}

    reset_counts(fa, fd)
    with rc.record_saves() as saved:
        loss, g = grads(model)
    got = counts(fa, fd)
    cfg.recompute = False
    loss_n, g_n = grads(model)
    cfg.recompute = True
    got_n = counts(fa, fd)
    with PlainKernelsOnCard(fa):
        loss_p, g_p = grads(model)
        loss_f, g_f = grads(ref)
    got_p = counts(fa, fd)
    reset_counts(fa, fd)
    L = cfg.num_layers
    want = dict.fromkeys(got, 0)
    want.update(flash_attention_fwd=2 * L, flash_attention_bwd_dq=L,
                flash_attention_bwd_dkv=L)
    want_n = dict(want, flash_attention_fwd=3 * L,
                  flash_attention_bwd_dq=2 * L, flash_attention_bwd_dkv=2 * L)
    bitwise = loss == loss_n and all(torch.equal(g[n], g_n[n]) for n in g)
    err, err_p = rel(g, g_f), rel(g_p, g_f)
    worst = max(err, key=err.get)
    res = {"phase": "llama_step", "model": "llama-1b (TinyLlama-1.1B)",
           "layers": L, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
           "kv_heads": cfg.kv_heads, "batch": b, "seq": s,
           "recompute_granularity": cfg.recompute_granularity,
           "loss_seq_chunks": cfg.loss_seq_chunks,
           "saved_names": sorted(saved),
           "saved_names_expected": sorted(RECOMPUTE_SAVES["core_attn"]),
           "loss": loss, "loss_no_recompute": loss_n,
           "no_recompute_bitwise": bitwise,
           "loss_ref_fp32_plain_attention": loss_f,
           "loss_abs_err": abs(loss - loss_f), "loss_atol": STEP_LOSS_ATOL,
           "grad_rel_err_max": err[worst], "grad_rel_err_worst_param": worst,
           "grad_rel_err_by_param": err, "grad_rel_tol": STEP_GRAD_RTOL,
           "bf16_plain_attention": {
               "loss_abs_err": abs(loss_p - loss_f),
               "grad_rel_err_max": max(err_p.values()),
               "grad_rel_err_by_param": err_p},
           "launches": got, "launches_with_no_recompute_step": got_n,
           "launches_after_plain_steps": got_p}
    emit(res)
    bad = []
    if got != want or got_n != want_n or got_p != got_n:
        bad.append(f"launches {got}, {got_n}, {got_p}: expected {want}, "
                   f"then {want_n} twice")
    if set(saved) != set(RECOMPUTE_SAVES["core_attn"]):
        bad.append(f"saved {sorted(saved)}")
    if not bitwise:
        bad.append("recompute changed the loss or a gradient")
    if not (res["loss_abs_err"] <= STEP_LOSS_ATOL
            and err[worst] <= STEP_GRAD_RTOL):
        bad.append(f"loss off by {res['loss_abs_err']}, or {worst}'s "
                   f"gradient by {err[worst]} (relative)")
    if bad:
        raise AssertionError("llama_step: " + "; ".join(bad))


def train_run(fa, fd, flops, cfg, b, s, warm, steps, phase):
    """`train_bench`'s build and train_step over `cfg` at (b, s): `warm`
    steps, then `steps` counted and timed (CUDA events; the loss read back
    after each step, as the reference's per-step dispatch), then a step
    and a traced one; the launch counts of the counted steps (windowed
    launches apart), the plain attention calls of all of them, step ms,
    tokens/s, the peak memory, and MFU on the dense-6N basis (the
    reference's: 12·L·h·S attention FLOPs a token, every key of the
    sequence) and on the visible pairs (12·L·h times the keys a row sees
    on average: (S + 1)/2 causal, about 3/8 of S for Mistral's window at
    S = 2w)."""
    from paddle_tpu_torch import train_bench
    from paddle_tpu_torch.bench import flops_per_token
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, x, y = train_bench.build(cfg, b, s, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params()
    step = lambda: train_bench.train_step(model, opt, x, y)
    wins = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)
    with PlainTraining(fa) as plain:
        t0 = time.perf_counter()
        losses = [float(step()) for _ in range(warm)]
        warm_s = time.perf_counter() - t0
        reset_counts(fa, fd)
        for w in wins:
            w.windowed = 0
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        losses += [float(step()) for _ in range(steps)]
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        windowed = {w.__name__: w.windowed for w in wins}
        peak = torch.cuda.max_memory_allocated()
        trace = traced_step(step, reps=1)
    reset_counts(fa, fd)
    dev_s = e0.elapsed_time(e1) / 1e3
    tok_s = b * s * steps / dev_s
    fpt = flops_per_token(cfg, n_params, s)
    keys = window_pairs(s, 0, cfg.sliding_window or s, s) / s
    fpt_vis = flops_per_token(cfg, n_params, keys)
    res = {"phase": phase, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "heads": cfg.num_heads,
           "kv_heads": cfg.kv_heads, "ffn": cfg.intermediate_size,
           "vocab": cfg.vocab_size, "window": cfg.sliding_window,
           "dtype": "bfloat16", "params": n_params, "batch": b, "seq": s,
           "recompute_granularity": cfg.recompute_granularity
           if cfg.recompute else None,
           "loss_seq_chunks": cfg.loss_seq_chunks,
           "optimizer": "AdamW(1e-4, multi_precision=False)",
           "warmup_steps": warm, "steps": steps, "init_s": init_s,
           "warmup_s": warm_s, "step_ms": 1e3 * dev_s / steps,
           "wall_step_ms": 1e3 * wall / steps, "tokens_per_s": tok_s,
           "flops_per_token": fpt, "mfu": tok_s * fpt / flops,
           "mfu_basis": "dense_6n", "keys_a_row_sees": keys,
           "flops_per_token_visible_pairs": fpt_vis,
           "mfu_visible_pairs": tok_s * fpt_vis / flops,
           "max_memory_allocated": peak,
           "losses": losses, "launches": got, "windowed_launches": windowed,
           "plain_attention_calls": plain.n, "step_trace": trace,
           "device_idle_share": None if trace is None
           else 1 - trace["busy_ms"] / (1e3 * dev_s / steps)}
    return res, model


def check_train(res, steps_layers, windowed):
    """A counted run's launches: K1 twice a layer a step (the forward and
    its replay under recompute), K3 and K4 once, nothing else; with a
    window every one of them windowed; no plain attention call; the loss
    finite and falling."""
    n = steps_layers
    want = dict.fromkeys(res["launches"], 0)
    want.update(flash_attention_fwd=2 * n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkv=n)
    want_w = {"flash_attention_fwd": 2 * n if windowed else 0,
              "flash_attention_bwd_dq": n if windowed else 0,
              "flash_attention_bwd_dkv": n if windowed else 0}
    losses = res["losses"]
    bad = []
    if res["launches"] != want:
        bad.append(f"launches {res['launches']}, expected {want}")
    if res["windowed_launches"] != want_w:
        bad.append(f"windowed launches {res['windowed_launches']}, "
                   f"expected {want_w}")
    if res["plain_attention_calls"]:
        bad.append(f"{res['plain_attention_calls']} plain attention calls")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        bad.append(f"loss not finite or not falling: {losses}")
    if bad:
        raise AssertionError(f"{res['phase']}: " + "; ".join(bad))


def phase_train_llama(fa, fd, flops):
    """TinyLlama-1.1B (`train_bench`'s llama-1b: h 2048, 22 layers, GQA
    32/4, ffn 5632, vocab 32000) at the reference's settings: b 4, S 2048,
    recompute core_attn, 4 loss chunks, pure-bf16 AdamW(1e-4); 2 warm-up
    and 10 counted steps."""
    from paddle_tpu_torch import train_bench
    cfg = train_bench.config("llama-1b")
    res, model = train_run(fa, fd, flops, cfg, 4, 2048, 2, 10, "train_llama")
    res["model"] = "llama-1b (TinyLlama-1.1B)"
    emit(res)
    del model
    check_train(res, cfg.num_layers * res["steps"], windowed=False)
    return res


def phase_train_mistral(fa, fd, flops):
    """Mistral-7B (`LlamaConfig.mistral_7b()`: 32 layers, h 4096, ffn
    14336, GQA 32/8, window 4096) at b 1, S 8192 (twice the window: it bites
    in half the rows), recompute full, 8 loss chunks, pure-bf16
    AdamW(1e-4); 2 warm-up and 3 counted steps; K3 and K4 windowed on every
    layer; then layer 0's attention at this shape (its q, k, v from the
    trained weights and the batch) held against the plain backward one
    kv-head group at a time."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops import rope
    cfg = dataclasses.replace(LlamaConfig.mistral_7b(),
                              num_layers=MISTRAL_TRAIN_LAYERS, recompute=True,
                              recompute_granularity="full", loss_seq_chunks=8)
    b, s = K3W_PATH[:2]
    res, model = train_run(fa, fd, flops, cfg, b, s, 2, 3, "train_mistral")
    res["model"] = "mistral_7b"
    res["state_bytes"] = {"params_grads_moments": 8 * res["params"],
                          "layer_boundaries": 2 * b * s * cfg.hidden_size
                          * cfg.num_layers}
    # layer 0's attention inputs at the path's shape
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s))).cuda()
    layer = model.model.layers[0]
    hd = cfg.head_dim
    with torch.no_grad():
        xn = layer.input_layernorm(model.model.embed_tokens(x))
        cos, sin = rope.rope_cos_sin(s, hd, base=cfg.rope_base, device="cuda")
        att = layer.self_attn
        q = rope.apply_rotary_pos_emb(att.q_proj(xn).reshape(
            b, s, cfg.num_heads, hd), cos, sin).contiguous()
        k = rope.apply_rotary_pos_emb(att.k_proj(xn).reshape(
            b, s, cfg.kv_heads, hd), cos, sin).contiguous()
        v = att.v_proj(xn).reshape(b, s, cfg.kv_heads, hd).contiguous()
    del model, xn
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    do = rand(q.shape, gen)
    res["layer0_attention_grads"] = window_bwd_check(fa, q, k, v, do,
                                                     cfg.sliding_window)
    emit(res)
    check_train(res, cfg.num_layers * res["steps"], windowed=True)
    if not res["layer0_attention_grads"]["ok"]:
        raise AssertionError("train_mistral: layer 0's attention (K1, K3, "
                             "K4) disagrees with the plain versions")
    return res


# ---- MoE training: DeepSeekMoE-16B d4 and the twin's dispatch modes ----------

# train_moe's model: DeepSeekMoE-16B at full width cut to 4 of its 28 layers
# (the reference's deepseek-16b-d4 cross-section, examples/decode_bench.py)
MOE_TRAIN_LAYERS = 4
# train_moe (c): one step of each dispatch mode against fused's at the
# twin's shape (12 layers, h 1024, 8 experts), bf16. Scatter, sort and
# einsum move the same rows as fused and sum the same products, in another
# order only in the combine and its backward; dropless runs each expert's
# products on its own segment (cuBLAS may pick other kernels, other sum
# orders). So the modes differ by bf16 roundings (2^-9 relative) that
# compound over 12 layers, and by the rare token whose top-2 choice sits on
# a near-tie that such noise flips. The loss (≈ ln 32000 = 10.4, a mean over
# 4096 tokens) then moves by ~1e-3, a gradient's relative L2 error by ~1e-2,
# as phase step's whole-step tolerances assume; a dispatch that loses or
# misplaces rows moves the loss by O(1e-1) and a gradient by O(1).
MODE_LOSS_ATOL, MODE_GRAD_RTOL = STEP_LOSS_ATOL, STEP_GRAD_RTOL
MODE_GRADS = ("model.embed_tokens.weight",
              "model.layers.0.self_attn.q_proj.weight",
              "model.layers.0.moe.gate.proj.weight",
              "model.layers.0.moe.experts.w_gate",
              "model.layers.11.moe.experts.w_down", "lm_head.weight")


def mode_step(moe_bench, dispatch, cf, state):
    """Loss and MODE_GRADS of one forward + backward at the twin's shape
    under `dispatch` with capacity factor `cf`, from `state` (None: the
    twin's seed-0 weights). Returns (loss, grads, state, host reads)."""
    from paddle_tpu_torch.nn.layers.moe import GroupedSwiGLUExperts
    cfg = moe_bench.config(capacity_factor=cf, dispatch=dispatch)
    model, _, x, y = moe_bench.build(cfg, 4, 1024, "cuda")
    if state is not None:
        model.load_state_dict(state)
    reads = GroupedSwiGLUExperts.host_reads
    loss = model.loss(model(x), y)
    loss.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()
             if n in MODE_GRADS}
    state = state or {n: t.detach().clone()
                      for n, t in model.state_dict().items()}
    out = (float(loss.detach()), grads, state,
           GroupedSwiGLUExperts.host_reads - reads)
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_moe(fa, fd, flops):
    """(a) DeepSeekMoE-16B at full width, MOE_TRAIN_LAYERS layers, fused
    dispatch, through moe_bench's build and train_step: b 4, S 1024,
    pure-bf16 AdamW(1e-4); 2 warm-up and 5 counted steps (CUDA events, the
    loss read after the last): K1, K3 and K4 once a layer a step, nothing
    else, no plain attention call, the loss finite and falling; step ms,
    tokens/s, activated MFU, peak memory, one traced step by bucket.
    (b) The twin at its defaults (its JSON line, with the bucket split).
    (c) One step under scatter, sort and einsum against fused at the
    twin's capacity factor, and dropless against fused at 4.0 (= E / k:
    an expert's queue holds every token, so nothing drops): the loss within
    MODE_LOSS_ATOL, each of MODE_GRADS within MODE_GRAD_RTOL relative L2."""
    from paddle_tpu_torch import moe_bench
    from paddle_tpu_torch.models import MixtralConfig
    cfg = dataclasses.replace(MixtralConfig.deepseek_moe_16b(),
                              num_layers=MOE_TRAIN_LAYERS,
                              moe_dispatch="fused")
    b, s, warm, steps = 4, 1024, 2, 5
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, x, y = moe_bench.build(cfg, b, s, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params()
    cap = model.model.layers[0].moe.gate.capacity(b * s)
    step = lambda: moe_bench.train_step(model, opt, x, y)
    with PlainTraining(fa) as plain:
        losses = [float(step()) for _ in range(warm)]
        reset_counts(fa, fd)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        counted = [step() for _ in range(steps)]
        e1.record()
        losses += [float(v) for v in counted]
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        peak = torch.cuda.max_memory_allocated()
        trace = moe_bench.step_breakdown(step)
    reset_counts(fa, fd)
    dev_s = e0.elapsed_time(e1) / 1e3
    tok_s = b * s * steps / dev_s
    fpt = moe_bench.flops_per_token(cfg, n_params, s)
    res = {"phase": "train_moe", "model": "deepseek_moe_16b",
           "layers": cfg.num_layers, "cut": "28 -> 4 layers",
           "hidden": cfg.hidden_size, "heads": cfg.num_heads,
           "experts": cfg.num_experts, "top_k": cfg.top_k,
           "expert_ffn": cfg.intermediate_size,
           "shared_experts": cfg.num_shared_experts,
           "vocab": cfg.vocab_size, "dispatch": "fused",
           "capacity_per_expert": cap, "dtype": "bfloat16",
           "params": n_params,
           "params_activated": moe_bench.activated_params(cfg, n_params),
           "batch": b, "seq": s,
           "optimizer": "AdamW(1e-4, multi_precision=False)",
           "warmup_steps": warm, "steps": steps, "init_s": init_s,
           "step_ms": 1e3 * dev_s / steps, "wall_step_ms": 1e3 * wall / steps,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": tok_s * fpt / flops, "mfu_basis": "activated",
           "max_memory_allocated": peak, "losses": losses, "launches": got,
           "plain_attention_calls": plain.n, "step_trace": trace}
    del model, opt, x, y, step
    gc.collect()
    torch.cuda.empty_cache()
    n = cfg.num_layers * steps
    want = dict.fromkeys(got, 0)
    want.update(flash_attention_fwd=n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkv=n)
    bad = []
    if got != want:
        bad.append(f"launches {got}, expected {want}")
    if plain.n:
        bad.append(f"{plain.n} plain attention calls")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        bad.append(f"loss not finite or not falling: {losses}")

    # (b) the twin at its defaults
    reset_counts(fa, fd)
    res["twin"] = moe_bench.main(["--xplane_breakdown"])
    res["twin_launches"] = counts(fa, fd)
    reset_counts(fa, fd)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the other dispatch modes against fused, one step each
    cf = 1.0
    modes = {}
    for ref_cf, others in ((cf, ("scatter", "sort", "einsum")),
                           (4.0, ("dropless",))):
        l0, g0, state, _ = mode_step(moe_bench, "fused", ref_cf, None)
        for mode in others:
            l1, g1, _, reads = mode_step(moe_bench, mode, ref_cf, state)
            rel = {n: float((g1[n] - g0[n]).norm() / g0[n].norm())
                   for n in MODE_GRADS}
            ok = (abs(l1 - l0) <= MODE_LOSS_ATOL
                  and all(v <= MODE_GRAD_RTOL for v in rel.values()))
            modes[mode] = {"capacity_factor": ref_cf, "loss": l1,
                           "fused_loss": l0, "loss_diff": l1 - l0,
                           "grad_rel_l2": rel, "host_reads": reads,
                           "ok": ok}
            if not ok:
                bad.append(f"{mode} disagrees with fused: {modes[mode]}")
        del state, g0
        gc.collect()
        torch.cuda.empty_cache()
    res["modes_vs_fused"] = {"shape": "the twin's defaults: 12 layers, "
                             "8 experts, h 1024, ffn 2816, b 4, S 1024",
                             "loss_atol": MODE_LOSS_ATOL,
                             "grad_rtol": MODE_GRAD_RTOL, "modes": modes}
    emit(res)
    if bad:
        raise AssertionError("train_moe: " + "; ".join(bad))
    return res


# ---- dropout: the hidden-dropout kernel, K1/K3/K4's dropout modes, GPT-2 at
# its published dropout ------------------------------------------------------

# the draw's key of phases dropout and k1d, and the rate of GPT-2's config
DROP_P = 0.1
# GPT-2 345M's hidden activations at B 8, S 1024 (phase train_dropout's
# shape, 49 dropouts a step forward and 49 backward)
DROPOUT_SHAPE = (8, 1024, 1024)
# integer instructions of one element's keep bit, at the fewest:
# threefry2x32's 20 rounds of add, rotate (one funnel shift) and xor (60),
# five x2 key injections, the last x1 injection (the other four fold into
# the next round's three-input add), the two input adds and the final xor
# (csrc/threefry.cuh); the keep test's shift and compare aside
HASH_OPS = 69
# thread-instructions an SM issues a clock at most: four schedulers, one
# warp instruction (32 lanes) each (NVIDIA H100 architecture white paper).
# An integer instruction runs on the INT32 pipe (64 lanes a clock) or, as
# ptxas schedules many adds and shifts, on the FMA pipe: the issue rate is
# the ceiling both share
ISSUE_PER_SM = 128


# the instructions a hash issues to the INT32 pipe alone (SHF, LOP3, and the
# IADD3 that ptxas did not write as IMAD, which the FMA pipe runs), counted
# in kernel W's SASS by keep_words_sass_mix; None until it ran
SASS_MIX = {}
INT32_ONLY = ("SHF", "LOP3", "IADD3")
INT32_LANES_PER_SM = 64
# the instructions of the FMA pipe among them (every IMAD form)
FMA_PIPE = ("IMAD", "FFMA", "FADD", "FMUL")


def keep_words_sass_mix():
    """Kernel W's instruction mix a hashed key: `cuobjdump -sass` of the
    built dropout library, among the innermost loops (closed by a backward
    branch, no other loop inside) that hold VOTE instructions (one ballot a
    hashed word), the one with the most ballots and then the fewest
    instructions (the row's counters below 2^32), each opcode's count
    there over its ballots. Sets SASS_MIX (with the INT32 pipe's rate: SMs
    × 64 lanes × the maximum SM clock, and the FMA pipe's share of the
    instructions) and returns it."""
    import re
    from paddle_tpu_torch.ops import _build
    so = _build.library("dropout")._name
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    body, cur = [], None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = "keep_words_kernel" in m.group(1)
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]*)?\s*([^;]*);", line)
        if cur and m:
            body.append((int(m.group(1), 16), m.group(3), m.group(5)))
    spans = []
    for at, op, args in body:
        t = re.search(r"0x([0-9a-f]+)", args)
        if op == "BRA" and t and int(t.group(1), 16) < at:
            spans.append((int(t.group(1), 16), at))
    loops = []
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue                        # a loop inside: not innermost
        ins = [o for a, o, _ in body if lo <= a <= hi]
        loops.append((ins.count("VOTE"), -len(ins), ins))
    votes, _, ins = max(loops) if loops else (0, 0, [])
    if not votes:
        raise AssertionError("keep_words_kernel: no loop with a ballot in "
                             "its SASS")
    mix = {}
    for o in ins:
        mix[o] = mix.get(o, 0) + 1
    SASS_MIX.update(
        hashes_in_loop=votes,
        per_hash={o: n / votes for o, n in sorted(mix.items(),
                                                   key=lambda kv: -kv[1])},
        instructions_per_hash=len(ins) / votes,
        int32_per_hash=sum(mix.get(o, 0) for o in INT32_ONLY) / votes,
        fma_per_hash=sum(mix.get(o, 0) for o in FMA_PIPE) / votes,
        fma_share=sum(mix.get(o, 0) for o in FMA_PIPE) / len(ins),
        int32_ops_per_s=int_ops_per_s() * INT32_LANES_PER_SM / ISSUE_PER_SM,
        int32_only=list(INT32_ONLY), fma_pipe=list(FMA_PIPE))
    emit({"phase": "keep_words_sass", **SASS_MIX})
    return SASS_MIX


def int32_bound_ms(hashes):
    """The least time of `hashes` hashes on the INT32 pipe alone (SASS_MIX's
    count a hash), or None before keep_words_sass_mix ran."""
    if not SASS_MIX:
        return None
    return hashes * SASS_MIX["int32_per_hash"] / SASS_MIX["int32_ops_per_s"] \
        * 1e3


def int_ops_per_s():
    """The card's integer-instruction ceiling: SMs × 128 × the SM clock's
    maximum (nvidia-smi clocks.max.sm)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_PER_SM * mhz * 1e6


def drop_key(n):
    from paddle_tpu_torch.core import rng
    return rng.fold_in(rng.PRNGKey(16), n)


def bound3(nbytes, nflops, nint, bw, flops, iops):
    """(ms, by): the larger of the bytes over the memory rate, the tensor
    FLOPs over the bf16 peak and the hash's integer instructions over the
    issue ceiling."""
    t = {"bytes": nbytes / bw * 1e3, "operations": nflops / flops * 1e3,
         "integer operations": nint / iops * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def phase_dropout(bw, flops, iops):
    """The hidden-dropout kernel against its plain version, bit for bit:
    GPT-2's (8, 1024, 1024) bf16 activations, an fp32 case, p 0.1,
    0.5 and 1, both modes (divide by keep, or not); the kept share, two
    launches with one key bitwise equal, another key another mask; timed
    beside the larger of its byte and integer-operation bounds, the plain
    version and torch.nn.functional.dropout (another mask: the time
    only)."""
    from paddle_tpu_torch.ops import dropout as dops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    key = drop_key(0)
    cases, ok = [], True
    for dt, shape in ((torch.bfloat16, DROPOUT_SHAPE),
                      (torch.float32, (3, 1000, 7))):
        x = rand(shape, gen, dtype=dt)
        for p in (DROP_P, 0.5, 1.0):
            for divide in (True, False):
                a = dops.dropout_cuda(x, key, p, divide)
                b = dops.dropout_plain(x, key, p, divide)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b))
                cases.append({"dtype": str(dt), "shape": list(shape),
                              "p": p, "divide": divide, "bitwise": same})
                ok &= same
    x = rand(DROPOUT_SHAPE, gen)
    y1 = dops.dropout_cuda(x, key, DROP_P)
    y2 = dops.dropout_cuda(x, key, DROP_P)
    y3 = dops.dropout_cuda(x, drop_key(1), DROP_P)
    n = x.numel()
    kept = ((y1 != 0) | (x == 0)).float().mean().item()
    sigma = math.sqrt(DROP_P * (1 - DROP_P) / n)
    stats = {"kept_share": kept, "expected": 1 - DROP_P, "sigma": sigma,
             "within_5_sigma": abs(kept - (1 - DROP_P)) <= 5 * sigma,
             "repeat_bitwise": bool(torch.equal(y1, y2)),
             "other_key_differs": not bool(torch.equal(y1, y3))}
    ok &= stats["within_5_sigma"] and stats["repeat_bitwise"] \
        and stats["other_key_differs"]
    f = lambda: dops.dropout_cuda(x, key, DROP_P)
    ms, dev = time_ms(f, iters=50), device_ms(f, iters=50)
    plain = time_ms(lambda: dops.dropout_plain(x, key, DROP_P), iters=3,
                    warmup=1)
    lib = time_ms(lambda: torch.nn.functional.dropout(x, DROP_P), iters=50)
    bound, by = bound3(2 * n * x.element_size(), 0, HASH_OPS * n, bw, flops,
                       iops)
    row = {"name": "dropout", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/dropout.cu",
           "replaces": "none: paddle_tpu/nn/functional.py:105 dropout runs "
                       "in XLA, outside any Pallas kernel",
           "launches": 0, "max_abs_err": 0.0 if ok else None, "ms": ms,
           "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
           "bound_by": by, "library_ms": lib,
           "library_is": "torch.nn.functional.dropout (its own mask)",
           "shape": list(DROPOUT_SHAPE), "dtype": "bfloat16", "p": DROP_P,
           "bound_share": bound / ms,
           "byte_bound_ms": 2 * n * x.element_size() / bw * 1e3,
           "int_bound_ms": HASH_OPS * n / iops * 1e3,
           "int32_bound_ms": int32_bound_ms(n),
           "int_ops_per_s": iops}
    emit({"phase": "dropout", "cases": cases, "stats": stats, "row": row})
    if not ok:
        raise AssertionError(f"dropout: kernel and plain version differ or "
                             f"the mask's statistics fail: {cases} {stats}")
    return row


def probe_v(b, s, nkv, d, t):
    """V of zeros with the identity over key tile t (keys t·d … t·d + d - 1):
    with q = 0, K1's output row q is then P̃[q, tile t], the dropped
    probabilities themselves."""
    v = torch.zeros((b, s, nkv, d), dtype=torch.bfloat16, device="cuda")
    w = min(d, s - t * d)
    v[:, t * d:t * d + w] = torch.eye(
        d, dtype=torch.bfloat16, device="cuda")[:w, None, :]
    return v


def k1_mask_probe(fa, dops, b, h, nkv, sq, sk, d, causal, kv_lens=None,
                  general=False):
    """K1's dropout mask read back exactly: q = 0 makes every visible
    probability 1/n (n a row's visible keys), V the identity over one key
    tile makes the output those probabilities dropped, so out·keep·n
    rounds to the keep bit. Every key tile in turn; the bits against
    attention_keep_mask (the port's torch threefry on the card) on the
    visible elements, bit for bit. `general`: the lengths as a (b, 1, 1,
    sk) bool mask, K1's general instantiation with dropout. Returns
    (result, the full mask)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    key = drop_key(2)
    q = torch.zeros((b, sq, h, d), dtype=torch.bfloat16, device="cuda")
    k = rand((b, sk, nkv, d), gen)
    kl = None if kv_lens is None else torch.tensor(
        kv_lens, dtype=torch.int32, device="cuda")
    mask = dops.attention_keep_mask(key, DROP_P, b, h, sq, sk, "cuda")
    keys = torch.arange(sk, device="cuda")
    rows = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    lens = torch.tensor(kv_lens or [sk] * b, device="cuda")
    vis = (keys[None, None, :] < lens[:, None, None]).expand(b, sq, sk)
    if causal:
        vis = vis & (keys[None, None, :] <= rows[None])
    n = vis.sum(-1).clamp_min(1).float()                 # (b, sq)
    keep = float(np.float32(1 - DROP_P))
    bad = worst = 0
    lkw = dict(kv_lens=kl)
    if general:
        lkw = dict(attn_mask=(keys[None, :] < lens[:, None])[:, None, None])
    for t in range((sk + d - 1) // d):
        out, _ = fa.flash_attention_fwd(q, k, probe_v(b, sk, nkv, d, t),
                                        is_causal=causal, dropout_p=DROP_P,
                                        key=key, **lkw)
        z = out.float().permute(0, 2, 1, 3) * keep * n[:, None, :, None]
        w = min(d, sk - t * d)
        z = z[..., :w]
        bits = z > 0.5
        worst = max(worst, (z - z.round()).abs().max().item())
        v = vis[:, None, :, t * d:t * d + w].expand_as(bits)
        bad += int((bits != mask[..., t * d:t * d + w])[v].sum().item())
    res = {"b": b, "h": h, "nkv": nkv, "sq": sq, "sk": sk, "d": d,
           "causal": causal, "kv_lens": kv_lens, "general": general,
           "visible": int(vis.sum().item()) * h, "bits_differing": bad,
           "max_distance_from_integer": worst,
           "ok": bad == 0 and worst < 0.05}
    return res, mask


def k4_mask_probe(fa, mask, b, h, s, d):
    """K4's regenerated mask read back exactly (MHA, non-causal): q = 0,
    the forward's lse from K1, dO the identity over query tile t; then
    dv[k, j] = P̃[t·d + j, k] = Z/(keep·s), so dv·keep·s rounds to the
    keep bit of query t·d + j. Every query tile in turn, against `mask`
    (the same key's attention_keep_mask), bit for bit."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    key = drop_key(2)
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    k, v = rand((b, s, h, d), gen), rand((b, s, h, d), gen)
    kw = dict(is_causal=False, dropout_p=DROP_P, key=key)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    keep = float(np.float32(1 - DROP_P))
    bad = worst = 0
    for t in range(s // d):
        do = probe_v(b, s, h, d, t)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        _, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        z = dv.float() * keep * s                     # (b, key, h, j)
        worst = max(worst, (z - z.round()).abs().max().item())
        bits = (z > 0.5).permute(0, 2, 3, 1)          # (b, h, j, key)
        bad += int((bits != mask[:, :, t * d:(t + 1) * d]).sum().item())
    return {"b": b, "h": h, "s": s, "d": d, "causal": False,
            "bits_differing": bad, "max_distance_from_integer": worst,
            "ok": bad == 0 and worst < 0.05}


def k3_mask_probe(fa, mask, b, h, s, d):
    """K3's mask read back exactly (MHA, non-causal): q = 0 makes every
    probability 1/s (lse = log s, from K1), V and dO the first unit vector
    make dP = 1, Δ = 0 is passed, so dS = Z/(keep·s); K the identity over
    key tile t then gives dq[q, j] = scale·Z[q, t·d + j]/(keep·s), and
    dq·keep·s/scale rounds to the keep bit. Every key tile in turn (K3 on
    the words it makes from the key: kernel W's), against `mask` (the same
    key's attention_keep_mask), bit for bit."""
    key = drop_key(2)
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    e0 = torch.zeros((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    e0[..., 0] = 1
    kw = dict(is_causal=False, dropout_p=DROP_P, key=key)
    _, lse = fa.flash_attention_fwd(q, probe_v(b, s, h, d, 0), e0, **kw)
    delta = torch.zeros((b, h, s), dtype=torch.float32, device="cuda")
    keep = float(np.float32(1 - DROP_P))
    scale = 1.0 / math.sqrt(d)
    bad = worst = 0
    for t in range(s // d):
        dq = fa.flash_attention_bwd_dq(q, probe_v(b, s, h, d, t), e0, e0,
                                       lse, delta, **kw)
        z = dq.float() * keep * s / scale             # (b, q, h, j)
        worst = max(worst, (z - z.round()).abs().max().item())
        bits = (z > 0.5).permute(0, 2, 1, 3)          # (b, h, q, j)
        bad += int((bits != mask[..., t * d:(t + 1) * d]).sum().item())
    return {"kernel": "k3", "b": b, "h": h, "s": s, "d": d, "causal": False,
            "bits_differing": bad, "max_distance_from_integer": worst,
            "ok": bad == 0 and worst < 0.05}


def k1d_case(fa, dops, gen, b, h, nkv, sq, sk, d, causal, kv_lens=None,
             q_off=None, window=None):
    """K1, K3 and K4 in dropout mode against the plain versions with the
    same key: out within K1_TOL_OUT, lse bit for bit the dropout-free
    kernel's (the statistics take the undropped P), dq, dk, dv within
    K3_TOL of the largest plain entry; two launches of each with one key
    bitwise equal, another key another output; K3 and K4 given the call's
    keep words (kernel W's) bitwise equal to K3 and K4 making their own."""
    q, do = rand((b, sq, h, d), gen), rand((b, sq, h, d), gen)
    k, v = rand((b, sk, nkv, d), gen), rand((b, sk, nkv, d), gen)
    kl = None if kv_lens is None else torch.tensor(
        kv_lens, dtype=torch.int32, device="cuda")
    base = dict(is_causal=causal, kv_lens=kl, causal_offset=q_off,
                window=window)
    kw = dict(base, dropout_p=DROP_P, key=drop_key(3))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
    out3, _ = fa.flash_attention_fwd(q, k, v, **dict(kw, key=drop_key(4)))
    _, lse0 = fa.flash_attention_fwd(q, k, v, **base)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq1 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk1, dv1 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    # K4 on the forward's keep words, as FlashAttention hands them over
    words = dops.attention_keep_words(
        kw["key"], DROP_P, b, h, sq, sk, causal, q_off, kl, window,
        device="cuda")
    dk3, dv3 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                          keep_words=words, **base,
                                          dropout_p=DROP_P)
    dq3 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                    keep_words=words, **base,
                                    dropout_p=DROP_P)
    torch.cuda.synchronize()
    res = {"b": b, "h": h, "nkv": nkv, "sq": sq, "sk": sk, "d": d,
           "causal": causal, "kv_lens": kv_lens, "q_off": q_off,
           "window": window, **k1_agreement(out, lse, ref, ref_lse),
           "lse_equals_dropout_free": bool(torch.equal(lse, lse0)),
           "repeat_bitwise": bool(
               torch.equal(out, out2) and torch.equal(lse, lse2)
               and torch.equal(dq1, dq2) and torch.equal(dk1, dk2)
               and torch.equal(dv1, dv2)),
           "other_key_differs": not bool(torch.equal(out, out3)),
           "k4_on_given_words_bitwise": bool(
               torch.equal(dk1, dk3) and torch.equal(dv1, dv3)),
           "k3_on_given_words_bitwise": bool(torch.equal(dq1, dq3))}
    res["ok"] &= res["lse_equals_dropout_free"] and res["repeat_bitwise"] \
        and res["other_key_differs"] and res["k4_on_given_words_bitwise"] \
        and res["k3_on_given_words_bitwise"]
    refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), (dq1, dk1, dv1), refs):
        err = (g.float() - r).abs().max().item()
        tol = K3_TOL * r.abs().max().item()
        res[name] = {"max_abs_err": err, "tol": tol}
        res["ok"] &= bool(err <= tol and torch.isfinite(g.float()).all())
    return res


def keep_words_case(dops, b, h, sq, sk, causal, kv_lens=None, q_off=None,
                    window=None, everything=False):
    """Kernel W against its plain twin (the port's torch threefry on the
    card, packed), bit for bit, and two launches equal."""
    key = drop_key(5)
    kw = dict(is_causal=causal, causal_offset=q_off, window=window,
              kv_lens=None if kv_lens is None else torch.tensor(
                  kv_lens, dtype=torch.int32, device="cuda"),
              everything=everything, device="cuda")
    w1 = dops.attention_keep_words(key, DROP_P, b, h, sq, sk, **kw)
    w2 = dops.attention_keep_words(key, DROP_P, b, h, sq, sk, **kw)
    ref = dops.attention_keep_words_plain(key, DROP_P, b, h, sq, sk, **kw)
    torch.cuda.synchronize()
    res = {"b": b, "h": h, "sq": sq, "sk": sk, "causal": causal,
           "kv_lens": kv_lens, "q_off": q_off, "window": window,
           "everything": everything, "words": list(w1.shape),
           "bits_set": int(dops.keep_words_mask(ref, sk).sum().item()),
           "bitwise": bool(torch.equal(w1, ref)),
           "repeat_bitwise": bool(torch.equal(w1, w2))}
    res["ok"] = res["bitwise"] and res["repeat_bitwise"]
    return res


def visible_word_bytes(vis, b, h):
    """Bytes of the keep words that hold a pair of `vis` (bool, (b|1, h|1,
    sq, sk)) over b batches and h heads: each row's 32-key words with a
    visible key, 4 bytes each. The least a kernel that reads the words for
    those pairs must read (K3 and K4 stage whole 128-key groups of them)."""
    pad = -vis.shape[-1] % 32
    if pad:
        vis = torch.cat([vis, vis.new_zeros(vis.shape[:-1] + (pad,))], -1)
    g = vis.reshape(vis.shape[:-1] + (-1, 32)).any(-1)
    heads = h if g.shape[1] == 1 else 1
    return int(g.expand(b, g.shape[1], *g.shape[2:]).sum().item()) \
        * heads * 4


# A row pair of kernel W whose flat index range crosses 2^32 (its CROSS
# path): (b, h, sq, sk), causal, so that b·h·sq·sk > 2^32 and the row
# (bh 63, q 7176) crosses it at key 4096, inside its visible keys; sk is no
# power of two, so that the crossing falls inside a row. Its words: 546 MB.
KEEP_WORDS_CROSS = (2, 32, 8200, 8200)
# rows held against the plain hash on each side of the crossing row
KEEP_WORDS_CROSS_SIDE = 4


def keep_words_cross_case(dops):
    """Kernel W where the flat index ((bi·h + hi)·sq + q)·sk + k passes 2^32
    (KEEP_WORDS_CROSS): the row whose range crosses it, KEEP_WORDS_CROSS_SIDE
    rows on each side and the last row, against the port's torch threefry
    of those rows' flat indices, packed, bit for bit. The plain twin over
    the whole call would need 4.3 G int64 indices; these rows need 8200
    each."""
    from paddle_tpu_torch.core import rng
    b, h, sq, sk = KEEP_WORDS_CROSS
    key = drop_key(6)
    words = dops.attention_keep_words(key, DROP_P, b, h, sq, sk, True,
                                      device="cuda")
    ww = words.shape[-1]
    cross = (1 << 32) // sk                      # the row holding 2^32
    n = KEEP_WORDS_CROSS_SIDE
    rows = torch.tensor(list(range(cross - n, cross + n + 1))
                        + [b * h * sq - 1], dtype=torch.int64, device="cuda")
    keys = torch.arange(sk, dtype=torch.int64, device="cuda")
    idx = rows[:, None] * sk + keys[None, :]
    kd = key.to("cuda")
    y1, y2 = rng.threefry2x32(kd[0], kd[1], idx >> 32, idx & 0xFFFFFFFF)
    z = ((y1 ^ y2) >> 9) < dops.keep_threshold(DROP_P)
    z &= keys[None, :] <= (rows % sq)[:, None] + (sk - sq)     # causal
    ref = dops._pack_bits(z, ww * 32).view(torch.int32)
    got = words.view(-1, ww)[rows]
    torch.cuda.synchronize()
    res = {"b": b, "h": h, "sq": sq, "sk": sk, "causal": True,
           "crossing_row": cross, "crossing_key": (1 << 32) - cross * sk,
           "rows_checked": rows.tolist(),
           "rows_with_high_word_1": int(((rows * sk + sk - 1) >> 32)
                                        .sum().item()),
           "words_bytes": words.numel() * 4,
           "bits_set": int(dops.keep_words_mask(ref, sk).sum().item()),
           "bitwise": bool(torch.equal(got, ref))}
    res["ok"] = res["bitwise"]
    del words, idx, y1, y2, z
    torch.cuda.empty_cache()
    return res


def phase_k1d(fa, bw, flops, iops):
    """K1, K3 and K4's dropout modes and kernel W: the exact mask probes
    (K1 at GPT-2's training shape, causal and not, and at d 128 with GQA
    and kv_lens; K4's dv and K3's dq at the training shape, every tile),
    the kept share, W against
    its plain twin (the cases' limits and every key; the rows where the
    flat index passes 2^32), the agreement cases
    (the training shape; d 128, GQA and kv_lens; non-causal; the window; a
    causal offset), and the times at the training shape with and without
    dropout beside the bounds (the hash's integer operations, and their
    INT32-pipe figure) and torch sdpa with dropout_p (its own mask: the
    time only). K1's row times the whole forward (W, then K1 on its words),
    K3's and K4's K3 and K4 on the given words, W's row W."""
    from paddle_tpu_torch.ops import dropout as dops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    b, h, s, d = 8, 16, 1024, 64
    probes = []
    res, mask = k1_mask_probe(fa, dops, b, h, h, s, s, d, causal=False)
    probes.append(res)
    n = mask.numel()
    kept = mask.float().mean().item()
    sigma = math.sqrt(DROP_P * (1 - DROP_P) / n)
    stats = {"elements": n, "kept_share": kept, "expected": 1 - DROP_P,
             "sigma": sigma,
             "within_5_sigma": abs(kept - (1 - DROP_P)) <= 5 * sigma}
    probes.append(k4_mask_probe(fa, mask, b, h, s, d))
    probes.append(k3_mask_probe(fa, mask, b, h, s, d))
    del mask
    probes.append(k1_mask_probe(fa, dops, b, h, h, s, s, d, causal=True)[0])
    probes.append(k1_mask_probe(fa, dops, 2, 16, 4, 512, 640, 128,
                                causal=False, kv_lens=[640, 300])[0])
    torch.cuda.empty_cache()
    words = [
        keep_words_case(dops, b, h, s, s, True),                 # training
        keep_words_case(dops, 2, 16, 512, 640, True, [640, 300]),
        keep_words_case(dops, 2, 8, 300, 700, False, [700, 123]),
        keep_words_case(dops, 2, 8, 384, 1084, True, None, 700, 200),
        keep_words_case(dops, 2, 8, 200, 333, True, [333, 0], 133),
        # the general mode's words (a bool mask beside dropout): every key
        keep_words_case(dops, 2, 12, 512, 512, True, [512, 300],
                        everything=True),
        keep_words_cross_case(dops),
    ]
    torch.cuda.empty_cache()
    cases = [
        k1d_case(fa, dops, gen, b, h, h, s, s, d, True),          # training
        k1d_case(fa, dops, gen, 2, 16, 4, 512, 640, 128, True, [640, 300]),
        k1d_case(fa, dops, gen, 2, 8, 2, 300, 700, 64, False, [700, 123]),
        k1d_case(fa, dops, gen, 2, 8, 2, 384, 1084, 128, True, None, 700,
                 200),
        k1d_case(fa, dops, gen, 2, 8, 8, 200, 333, 64, True, [333, 0], 133),
    ]
    # times at the training shape, causal
    q, k, v, do = (rand((b, s, h, d), gen) for _ in range(4))
    kw = dict(is_causal=True, dropout_p=DROP_P, key=drop_key(3))
    wkw = dict(is_causal=True, device="cuda")
    make_words = lambda: dops.attention_keep_words(drop_key(3), DROP_P, b, h,
                                                   s, s, **wkw)
    zw = make_words()
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        out0, lse0 = fa.flash_attention_fwd(q, k, v, is_causal=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    delta0 = (do.float() * out0.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    fns = {
        # the whole forward: W and K1 on its words
        "k1": (lambda: fa.flash_attention_fwd(q, k, v, **kw),
               lambda: fa.flash_attention_fwd(q, k, v, is_causal=True)),
        "k3": (lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 keep_words=zw, **kw),
               lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse0, delta0,
                                                 is_causal=True)),
        "k4": (lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  keep_words=zw, **kw),
               lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse0, delta0,
                                                  is_causal=True))}
    times = {}
    for key_, (fd_, f0) in fns.items():
        times[key_] = {"ms": time_ms(fd_, iters=20),
                       "device_ms": device_ms(fd_, iters=20),
                       "ms_without_dropout": time_ms(f0, iters=20),
                       "device_ms_without_dropout": device_ms(f0, iters=20)}
    k1_on_words = lambda: fa.flash_attention_fwd(q, k, v, keep_words=zw,
                                                 **kw)
    times["k1"].update(k1_alone_ms=time_ms(k1_on_words, iters=20),
                       k1_alone_device_ms=device_ms(k1_on_words, iters=20))
    times["w"] = {"ms": time_ms(make_words, iters=20),
                  "device_ms": device_ms(make_words, iters=20)}
    plain_fwd = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                        iters=2, warmup=1)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=2, warmup=1)
    plain_w = time_ms(lambda: dops.attention_keep_words_plain(
        drop_key(3), DROP_P, b, h, s, s, **wkw), iters=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    with torch.no_grad():
        lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                       dropout_p=DROP_P), iters=20)
    o_lib = sdpa(qt, kt, vt, is_causal=True, dropout_p=DROP_P)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        iters=20)
    pairs, work = causal_attention_work(b, h, s, d)
    wbytes = zw.numel() * zw.element_size()
    # the words K3 and K4 must read: those that hold a causal pair
    vbytes = visible_word_bytes(torch.ones(
        (1, 1, s, s), dtype=torch.bool, device="cuda").tril(), b, h)
    rows = {}
    errs = {"k1": max(c["max_abs_err"] for c in cases),
            "k3": max(c["dq"]["max_abs_err"] for c in cases),
            "k4": max(max(c["dk"]["max_abs_err"], c["dv"]["max_abs_err"])
                      for c in cases)}
    for key_, name, line, where in (
            ("k1", "flash_attention_fwd", 526, "_dropout_keep :605"),
            ("k3", "flash_attention_bwd_dq", 668, "dropout :737"),
            ("k4", "flash_attention_bwd_dkv", 787, "dropout :863")):
        nbytes, nflops = work[key_]
        # K3 and K4 read the forward's words and hash nothing; K1's row is
        # the whole forward, whose hash W runs
        hashes = pairs if key_ == "k1" else 0
        if key_ != "k1":
            nbytes += vbytes
        bound, by = bound3(nbytes, nflops, HASH_OPS * hashes, bw, flops,
                           iops)
        t = times[key_]
        rows[key_] = {
            "name": f"{name} (dropout)", "mode": "dropout", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention"
                      + ("_bwd" if key_ != "k1" else "") + ".cu",
            "replaces": f"paddle_tpu/ops/flash_attention.py:{line} "
                        f"({where})",
            "launches": 0, "max_abs_err": errs[key_], "ms": t["ms"],
            "device_ms": t["device_ms"],
            "ms_without_dropout": t["ms_without_dropout"],
            "device_ms_without_dropout": t["device_ms_without_dropout"],
            "plain_ms": plain_fwd if key_ == "k1" else plain_bwd,
            "bound_ms": bound, "bound_by": by,
            "int32_bound_ms": int32_bound_ms(hashes) if hashes else None,
            "library_ms": lib_fwd if key_ == "k1" else lib_bwd,
            "library_is": "torch sdpa, dropout_p 0.1 (its own mask), "
                          + ("forward" if key_ == "k1" else
                             "backward, dq+dk+dv, device time"),
            "keep": {"k1": "ms: kernel W and K1 (the whole forward); "
                           "k1_alone: K1 on given words",
                     "k3": "reads the given words",
                     "k4": "reads the given words"}[key_],
            "shape_b_s_h_d": [b, s, h, d], "causal": True,
            "visible_pairs": pairs, "int_ops": HASH_OPS * hashes,
            "words_read_bytes": vbytes if key_ != "k1" else None,
            "bound_share": bound / t["ms"]}
        if key_ == "k1":
            rows[key_].update(k1_alone_ms=t["k1_alone_ms"],
                              k1_alone_device_ms=t["k1_alone_device_ms"])
    # kernel W: its words written once, the hash of every visible pair
    bound, by = bound3(wbytes, 0, HASH_OPS * pairs, bw, flops, iops)
    w_ok = all(c["ok"] for c in words)
    rows["w"] = {
        "name": "attention_keep_words", "row": "W", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/dropout.cu",
        "replaces": "none: the attention's keep mask (paddle_tpu/ops/"
                    "flash_attention.py:139; the Pallas kernels' in-kernel "
                    "_dropout_keep :426 draws another), hashed once a call "
                    "for K1, K3 and K4",
        "launches": 0, "max_abs_err": 0.0 if w_ok else None,
        "ms": times["w"]["ms"], "device_ms": times["w"]["device_ms"],
        "plain_ms": plain_w, "bound_ms": bound, "bound_by": by,
        "int32_bound_ms": int32_bound_ms(pairs),
        "library_ms": None,
        "library_is": "none: no PyTorch call packs a keep mask",
        "shape_b_h_sq_sk": [b, h, s, s], "causal": True,
        "visible_pairs": pairs, "words_bytes": wbytes,
        "int_ops": HASH_OPS * pairs, "bound_share": bound / times["w"]["ms"],
        "sass_mix": dict(SASS_MIX)}
    res = {"phase": "k1d", "p": DROP_P, "probes": probes, "stats": stats,
           "keep_words": words, "cases": cases, "kernels": rows}
    emit(res)
    bad = [c for c in probes + words + cases if not c["ok"]]
    if bad or not stats["within_5_sigma"]:
        raise AssertionError(f"k1d: {bad} {stats}")
    return rows


class PlainDropout(PlainCalls):
    """Counts calls of the hidden dropout's and kernel W's plain versions
    (the wrappers look them up at call time): a train step on the card
    must run none."""

    NAMES = ("dropout_plain", "attention_keep_words_plain")


def phase_train_dropout(fa, fd, flops):
    """GPT-2 345M as published (`GPTConfig.gpt2_medium()`: hidden and
    attention dropout 0.1) through the bench twin's build and train_step
    (one "dropout" key a step from the global generator): 3 warm-up and 10
    counted steps; K1, K3 and K4 24 a step, all in dropout mode, the
    dropout kernel 49 a step forward and 49 backward, no plain attention
    or dropout call; step ms, MFU on phase train's basis, peak memory, a
    traced step; the loss finite and falling."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops import dropout as dops
    cfg = GPTConfig.gpt2_medium()
    _, b, s, _ = bench.config()
    warm, steps = 3, 10
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, x, y = bench.build(cfg, b, s, "cuda")
    n_params = model.num_params()
    rng.seed(0)
    step = lambda: bench.train_step(model, opt, x, y)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    with PlainTraining(fa) as plain, PlainDropout(dops) as plain_drop:
        losses = [float(step()) for _ in range(warm)]
        reset_counts(fa, fd)
        for w in wrappers:
            w.dropout = 0
        dops.dropout_cuda.backward = 0
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        timed = [step() for _ in range(steps)]
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fa, fd)
        in_mode = {w.__name__: w.dropout for w in wrappers}
        backward = dops.dropout_cuda.backward
        peak = torch.cuda.max_memory_allocated()
        trace = traced_step(step, reps=1)
    reset_counts(fa, fd)
    losses += [float(t) for t in timed]
    dev_s = e0.elapsed_time(e1) / 1e3
    tok_s = b * s * steps / dev_s
    fpt = bench.flops_per_token(cfg, n_params, s)
    L = cfg.num_layers
    n_drop = (1 + 2 * L) * steps
    res = {"phase": "train_dropout", "model": "gpt2_medium",
           "hidden_dropout": cfg.hidden_dropout_prob,
           "attention_dropout": cfg.attention_dropout_prob, "layers": L,
           "dtype": "bfloat16", "params": n_params, "batch": b, "seq": s,
           "optimizer": "AdamW(1e-4), fp32 masters", "warmup_steps": warm,
           "steps": steps, "step_ms": 1e3 * dev_s / steps,
           "wall_step_ms": 1e3 * wall / steps, "tokens_per_s": tok_s,
           "flops_per_token": fpt, "mfu": tok_s * fpt / flops,
           "mfu_basis": "dense_6n", "max_memory_allocated": peak,
           "losses": losses, "launches": got,
           "dropout_mode_launches": in_mode,
           "dropout_kernel_backward_launches": backward,
           "plain_attention_calls": plain.n,
           "plain_dropout_calls": plain_drop.n, "step_trace": trace,
           "device_idle_share": None if trace is None
           else 1 - trace["busy_ms"] / (1e3 * dev_s / steps),
           "rng_state": list(rng.get_rng_state())}
    emit(res)
    del model, opt
    want = dict.fromkeys(got, 0)
    want.update(flash_attention_fwd=L * steps, flash_attention_bwd_dq=L * steps,
                flash_attention_bwd_dkv=L * steps, dropout=2 * n_drop,
                attention_keep_words=L * steps)
    bad = []
    if got != want:
        bad.append(f"launches {got}, expected {want}")
    if in_mode != {w.__name__: L * steps for w in wrappers} \
            or backward != n_drop:
        bad.append(f"dropout-mode launches {in_mode}, backward dropout "
                   f"{backward}, expected {L * steps} and {n_drop}")
    if plain.n or plain_drop.n:
        bad.append(f"{plain.n} plain attention and {plain_drop.n} plain "
                   "dropout or keep-word calls")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        bad.append(f"loss not finite or not falling: {losses}")
    if bad:
        raise AssertionError("train_dropout: " + "; ".join(bad))
    return res


def dropout_rows(drop_row, k1d_rows, train_res):
    """The kernel table's dropout rows (1b, 2b, 3b, W and the
    hidden-dropout kernel), their launches from phase train_dropout."""
    got, in_mode = train_res["launches"], train_res["dropout_mode_launches"]
    out = []
    for key_, row in k1d_rows.items():
        name = row["name"].split(" ")[0]
        n = got[name] if key_ == "w" else in_mode[name]
        out.append(dict(row, launches=n, launches_by_path={
            "train_dropout": n}))
    out.append(dict(drop_row, launches=got["dropout"], launches_by_path={
        "train_dropout": got["dropout"]},
        backward_launches=train_res["dropout_kernel_backward_launches"]))
    return out


# ---- the SD-1.5 UNet: K1 at head dim 256 and the padded head dims ------------

# The UNet's attention calls at b 2, 8 heads, 64×64 latents: (level, query
# tokens, head dim, calls of each kind a forward); each kind is
# self-attention (sk = sq) and cross-attention to the 77-token context
UNET_ATTN = ((0, 4096, 40, 5), (1, 1024, 80, 5), (2, 256, 160, 5),
             ("mid", 64, 160, 1))
UNET_CTX = 77
# The whole-model check: ε of a full-width forward in bf16 on the card
# against the port's fp32 CPU forward of the same weights (b 1, 32×32
# latents), as relative L2. Measured on one H100 it read 0.0133
# (PERF.md): every activation of the card rounds to bf16 (2^-9
# relative) through ~60 convolution, norm and attention layers, noise that
# adds up in quadrature to ~1e-2 at random weights. 0.05 leaves that noise
# ~4x room for other draws; a wrong kernel, mask, pad or scale moves every
# attention output by O(1) of its size.
UNET_REL_L2 = 0.05
# Phase k1h holds each UNet attention shape relative to its reference, since
# an absolute bound sized for max|v| ~ 4 is a typical |out| at 4096 keys
# (out averages N(0, 1) values down to ~√(e/sk)). K1 and the plain version
# both round out to bf16: where they round near-equal fp32 values to either
# side of a boundary they differ by one ulp, at most 2^-7 of that entry and
# so of max|plain|. 2^-6 allows two such flips at the largest entry; as
# relative L2 the flips are a few per cent of the entries at ≤ 2^-8 each,
# far inside 2^-7. A key tile dropped or mis-masked, or the scale of the
# padded d (≈ 20% on every output), exceeds both by an order of magnitude.
K1H_TOL_OF_MAX = 2.0 ** -6
K1H_REL_L2 = 2.0 ** -7
UNET_FAMILIES = (
    ("K1 flash_attention_fwd", ("flash_fwd_sm90",)),
    ("convolutions (cuDNN)", ("fprop", "implicit_gemm", "implicit_convolve",
                              "winograd", "conv2d", "convolve")),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass",
                                  "gemv")),
    ("GroupNorm and LayerNorm", ("rowwisemoments", "computefusedparams",
                                 "groupnorm", "group_norm", "layer_norm",
                                 "layernorm")),
    ("copies (the pad, layout transforms, concatenation, casts)",
     ("copy", "cat", "fill", "pad", "nchwtonhwc", "nhwctonchw")))


def d256_refusals(call):
    """{mode: the NotImplementedError's message, or None where it ran} of
    `call(**kw)` under the window and under dropout, the modes the kernels
    are not built for at head dim 256."""
    from paddle_tpu_torch.core import rng
    out = {}
    for mode, kw in (("window", dict(is_causal=True, window=4)),
                     ("dropout", dict(dropout_p=0.1, key=rng.PRNGKey(3)))):
        try:
            call(**kw)
            out[mode] = None
        except NotImplementedError as e:
            out[mode] = str(e)
    return out


def k1h_bound(b, h, sq, sk, d, bw, flops):
    """(bound ms, by) of one attention call at head dim d: q, k, v and out
    in bf16 once and the lse, against 4·d FLOPs a (query, key) pair."""
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4 * b * h * sq
    return bound3(nbytes, 4 * b * h * sq * sk * d, 0, bw, flops, 1.0)


def k1h_shape(fa, gen, b, h, sq, sk, d, bw, flops):
    """One UNet attention call at head dim d through the dispatch (the pad
    to K1's d, K1, the slice), held against K1's plain version at the
    unpadded d; K1 launched once at the padded d. K1 launched on the
    dispatch's padded inputs is held as phase k1 holds it (out and lse
    within K1_TOL_OUT and K1_TOL_LSE: the pad leaves lse exact), its
    padded columns exactly 0, and out, relative to the reference,
    within K1H_TOL_OF_MAX of max|plain| and K1H_REL_L2. Then K1's device
    time at the padded d (device_ms: the wrapper's host work outlasts the
    small launches), the dispatch's, torch sdpa's at the unpadded d and
    the plain version's (CUDA events), beside the bound at the padded d
    and at the model's own d."""
    q, k, v = (rand((b, s, h, d), gen) for s in (sq, sk, sk))
    dt = next(t for t in fa.FWD_DIMS if t >= d)
    before = dict(fa.flash_attention_fwd.by_d)
    with torch.no_grad():
        out = fa.scaled_dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    launched = {t: fa.flash_attention_fwd.by_d[t] - before[t]
                for t in fa.FWD_DIMS}
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v)
    qp, kp, vp, scale, _ = fa._pad_head_dim(q, k, v, None)
    with torch.no_grad():
        out_k, lse_k = fa.flash_attention_fwd(qp, kp, vp, scale=scale)
    agree = k1_agreement(out_k[..., :d], lse_k, ref, ref_lse)
    ref_max = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    rel = (torch.linalg.vector_norm(out.float() - ref.float())
           / torch.linalg.vector_norm(ref.float())).item()
    pad_zero = not out_k[..., d:].any().item()
    with torch.no_grad():
        ms = device_ms(lambda: fa.flash_attention_fwd(qp, kp, vp,
                                                      scale=scale), iters=20)
        dispatch_ms = device_ms(
            lambda: fa.scaled_dot_product_attention(q, k, v), iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v),
                       iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
        iters=20)
    bound, by = k1h_bound(b, h, sq, sk, dt, bw, flops)
    bound_d, by_d = k1h_bound(b, h, sq, sk, d, bw, flops)
    ok = (err <= K1_TOL_OUT and err <= K1H_TOL_OF_MAX * ref_max
          and rel <= K1H_REL_L2 and agree["ok"] and pad_zero
          and launched == {t: int(t == dt) for t in fa.FWD_DIMS}
          and bool(torch.isfinite(out.float()).all()))
    return {"b": b, "h": h, "sq": sq, "sk": sk, "d": d, "kernel_d": dt,
            "max_abs_err": err, "tol": K1_TOL_OUT, "ref_max_abs": ref_max,
            "tol_of_max_ref": K1H_TOL_OF_MAX, "rel_l2": rel,
            "rel_l2_tol": K1H_REL_L2, "k1_padded_inputs": agree,
            "padded_columns_zero": pad_zero, "k1_launches": launched,
            "ms": ms, "dispatch_ms": dispatch_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "bound_ms_model_d": bound_d, "bound_by_model_d": by_d, "ok": ok}


def phase_k1h(fa, bw, flops):
    """K1 at head dim 256 and the dispatch's padded head dims, against the
    plain version (see the module docstring, phase 8i)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    shapes = []
    for level, sq, d, calls in UNET_ATTN:
        for sk in (sq, UNET_CTX):
            shapes.append(dict(k1h_shape(fa, gen, 2, 8, sq, sk, d, bw, flops),
                               level=level, calls_a_forward=calls))
    # native d = 256 at the kernel's edges: causal with an offset, GQA 4,
    # kv_lens with a zero-length row, sq 1, sq 127 and 129 around the query
    # tile, ragged non-causal sk 77 and 333 without kv_lens (keys past sk
    # arrive as TMA zero fill and must be masked), the key tile's edge
    edges = [
        k1_case(fa, gen, 2, 8, 8, 300, 1200, 256, 900, [1200, 0]),
        k1_case(fa, gen, 2, 16, 4, 200, 700, 256, 450, 650),
        k1_case(fa, gen, 2, 8, 2, 1, 1000, 256, 999, [1000, 0]),
        k1_case(fa, gen, 2, 8, 8, 127, 127, 256, None, None),
        k1_case(fa, gen, 2, 8, 8, 129, 333, 256, None, None, causal=False),
        k1_case(fa, gen, 2, 8, 8, 129, 77, 256, None, None, causal=False),
        k1_case(fa, gen, 2, 8, 8, 256, 77, 256, None, None, causal=False),
        k1_case(fa, gen, 1, 8, 8, 64, 64, 256, None, [63], causal=False),
        k1_case(fa, gen, 2, 16, 4, 128, 513, 256, 385, [513, 129]),
    ]
    # two launches of one d = 256 call: the same bits
    q = rand((2, 256, 8, 256), gen)
    k = rand((2, UNET_CTX, 8, 256), gen)
    v = rand((2, UNET_CTX, 8, 256), gen)
    o1, l1 = fa.flash_attention_fwd(q, k, v)
    o2, l2 = fa.flash_attention_fwd(q, k, v)
    repeat = bool(torch.equal(o1, o2) and torch.equal(l1, l2))
    # the window and dropout at d 256 raise, naming the ROADMAP row (the
    # gradient at d 256 runs: phase k3h)
    refused = d256_refusals(lambda **kw: fa.flash_attention_fwd(q, k, v,
                                                                **kw))
    emit({"phase": "k1h", "unet_shapes": shapes, "d256_cases": edges,
          "d256_repeat_bitwise": repeat, "d256_modes_refused": refused})
    bad = ([c for c in shapes + edges if not c["ok"]]
           + ([] if repeat else ["two d 256 launches differ"])
           + [f"the {m} at d 256 was not refused" for m, e in refused.items()
              if not (e and "Queue B row 1" in e)])
    if bad:
        raise AssertionError(f"K1 at the UNet's head dims: {bad}")
    return shapes, max(c["max_abs_err"] for c in edges)


def unet_rows(shapes, d256_err, launches):
    """Rows 1c (K1 at d 256: the UNet's level-2 and mid calls, and the
    native cases) and 1d (d 40 / 80 padded to 64 / 128): device times,
    bounds, plain and sdpa times summed over one forward's calls of that
    mode (calls_a_forward of each shape), max |out − plain|, the unet
    path's launches (a run of UNET_STEPS denoise steps)."""
    rows = []
    for tag, dims, line in (("1c", (256,), "head dim 256 (SD-1.5's 160, "
                                            "padded; native 256)"),
                            ("1d", (64, 128), "head dims 40, 80 padded to "
                                              "64, 128")):
        mine = [c for c in shapes if c["kernel_d"] in dims]
        tot = lambda key: sum(c[key] * c["calls_a_forward"] for c in mine)
        rows.append({
            "name": "flash_attention_fwd", "row": tag, "mode": line,
            "route": "cuda", "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/flash_attention.py:526 (head dims: "
                        "_pad_for_kernel :339, :351-352)",
            "launches": sum(launches["by_d"][d] for d in dims),
            "max_abs_err": max([c["max_abs_err"] for c in mine]
                               + ([d256_err] if 256 in dims else [])),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_ms_model_d": tot("bound_ms_model_d"),
            # the kind that makes up the larger share of the summed bound
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                c["bound_ms"] * c["calls_a_forward"] for c in mine
                if c["bound_by"] == by)),
            "library_ms": tot("library_ms"),
            "dispatch_ms": tot("dispatch_ms"),
            "per": "one forward's calls of this mode, b 2, 64x64 latents",
            "launches_by_path": {"unet": sum(launches["by_d"][d]
                                             for d in dims)},
            "at_shapes": mine})
    return rows


# ---- K3/K4 at head dim 256: the UNet's backward --------------------------------

# The UNet's backward calls at kernel d 256 (SD-1.5's head dim 160 at level
# 2 and the middle, padded), b 2, 8 heads, non-causal: (query tokens, key
# tokens, calls a step)
UNET_BWD_256 = ((256, 256, 5), (256, UNET_CTX, 5), (64, 64, 1),
                (64, UNET_CTX, 1))


def k3h_work(b, h, sq, sk, d):
    """{k3, k4: (bytes, FLOPs)} of one non-causal backward call at head dim
    d: K3 reads q, k, v, dO, lse and Δ and writes dq, K4 reads the same and
    writes dk and dv; 6·d and 8·d FLOPs a (query, key) pair."""
    pairs = b * h * sq * sk
    tq, tk, row = b * sq * h * d * 2, b * sk * h * d * 2, b * h * sq * 4
    return {"k3": (3 * tq + 2 * tk + 2 * row, 6 * d * pairs),
            "k4": (2 * tq + 4 * tk + 2 * row, 8 * d * pairs)}


def k3h_shape(fa, gen, b, h, sq, sk, bw, flops):
    """One UNet backward call at SD-1.5's head dim 160: the gradient
    through the dispatch (the pad to 256, K1, K3 and K4 at d 256, the
    slice's backward) against the plain backward at d 160 on the kernel
    forward's (out, lse), each of dq, dk, dv within K3_TOL · max|plain|;
    K1, K3 and K4 launched once each, at d 256. Then K3's and K4's device
    time on the padded inputs (device_ms), beside the bounds at the padded
    and at the model's d, the plain backward at d 160 and torch sdpa's
    backward at d 160 over a retained graph (its kernels' device time)."""
    d = 160
    q, k, v, do = (rand((b, s, h, d), gen) for s in (sq, sk, sk, sq))
    wraps = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)
    before = [dict(w.by_d) for w in wraps]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.scaled_dot_product_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    launched = {w.__name__: {t: w.by_d[t] - n[t] for t in n}
                for w, n in zip(wraps, before)}
    qp, kp, vp, scale, _ = fa._pad_head_dim(q, k, v, None)
    dop = torch.nn.functional.pad(do, (0, 256 - d))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(qp, kp, vp, scale=scale)
    ref = fa.flash_attention_bwd_plain(q, k, v, out[..., :d], lse, do)
    ok = all(got == {t: int(t == 256) for t in got}
             for got in launched.values())
    res = {"b": b, "h": h, "sq": sq, "sk": sk, "d": d, "kernel_d": 256,
           "tol_of_max_ref": K3_TOL, "launches": launched}
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        g = t.grad.float()
        err = (g - r).abs().max().item()
        tol = K3_TOL * r.abs().max().item()
        res[name] = {"max_abs_err": err, "tol": tol,
                     "max_abs_ref": r.abs().max().item()}
        ok &= bool(err <= tol and torch.isfinite(g).all())
    res["ok"] = ok
    delta = (dop.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    with torch.no_grad():
        ms = {"k3": device_ms(lambda: fa.flash_attention_bwd_dq(
                  qp, kp, vp, dop, lse, delta, scale=scale), iters=20),
              "k4": device_ms(lambda: fa.flash_attention_bwd_dkv(
                  qp, kp, vp, dop, lse, delta, scale=scale), iters=20)}
    res["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out[..., :d], lse, do), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    o_lib = sdpa(qt, kt, vt)
    res["library_ms"] = device_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        iters=20)
    for at, dd in (("", 256), ("_model_d", d)):
        for key, (nbytes, nflops) in k3h_work(b, h, sq, sk, dd).items():
            tb, to = nbytes / bw * 1e3, nflops / flops * 1e3
            res.setdefault(key, {})
            res[key].update({f"bound_ms{at}": max(tb, to),
                             f"bound_by{at}": "bytes" if tb >= to
                             else "operations"})
    for key in ("k3", "k4"):
        res[key]["ms"] = ms[key]
    return res


def phase_k3h(fa, bw, flops):
    """K3 and K4 at head dim 256 against the plain backward (see the module
    docstring, phase 8j). Returns (the UNet shapes' results, K3's and K4's
    largest errors)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    b, h = 2, 8
    # native d 256 at the UNet's shapes, and at d 256's edges (32-key K3
    # tiles under 128-row blocks, 64-key K4 blocks split by columns): sq 1,
    # 65, 129 and 193, sq 64 (K3's second group without rows) over sk 65,
    # ragged sk 77 and 1000 (TMA zero fill past sk), causal offsets inside
    # a tile, GQA 4 and 8, a batch row of kv_len 0 (zero gradients)
    cases = [k3_case(fa, gen, b, h, h, sq, sk, 256, False)
             for sq, sk, _ in UNET_BWD_256]
    cases += [
        k3_case(fa, gen, 2, 8, 2, 1, 300, 256, True, None, 299),
        k3_case(fa, gen, 2, 16, 4, 65, 333, 256, True, [333, 0], 200),
        k3_case(fa, gen, 2, 8, 1, 129, 129, 256, True),
        k3_case(fa, gen, 2, 8, 8, 129, UNET_CTX, 256, False),
        k3_case(fa, gen, 1, 8, 2, 193, 260, 256, True, [197]),
        k3_case(fa, gen, 2, 4, 4, 64, 65, 256, True, [65, 1]),
        k3_case(fa, gen, 1, 8, 2, 200, 1000, 256, False, [777]),
        k3_case(fa, gen, 2, 16, 4, 300, 1200, 256, True, [1200, 0], 900),
    ]
    shapes = [dict(k3h_shape(fa, gen, b, h, sq, sk, bw, flops),
                   calls_a_step=calls) for sq, sk, calls in UNET_BWD_256]
    # the window and dropout at d 256 raise, naming the ROADMAP rows
    q = rand((1, 64, 2, 256), gen)
    lse = torch.zeros((1, 2, 64), dtype=torch.float32, device="cuda")
    refused = d256_refusals(lambda **kw: fa.flash_attention_bwd_dq(
        q, q, q, q, lse, lse, **kw))
    emit({"phase": "k3h", "d256_cases": cases, "unet_shapes": shapes,
          "d256_modes_refused": refused})
    bad = ([c for c in cases + shapes if not c["ok"]]
           + [f"the {m} at d 256 was not refused" for m, e in refused.items()
              if not (e and "Queue B rows 2-3" in e)])
    if bad:
        raise AssertionError(f"K3/K4 at head dim 256: {bad}")
    return shapes, (
        max(c["dq"]["max_abs_err"] for c in cases + shapes),
        max(max(c["dk"]["max_abs_err"], c["dv"]["max_abs_err"])
            for c in cases + shapes))


def k3h_rows(shapes, errs, launches):
    """Rows 2c and 3c (K3 and K4 at d 256: SD-1.5's 160 padded, native
    256): device times, bounds (at the padded d and the model's), the plain
    and sdpa backward's times, each summed over one training step's calls
    (calls_a_step of each shape); the largest error of phase k3h; launches
    on path train_unet (its counted steps)."""
    rows = []
    for name, key, tag, line, err in (
            ("flash_attention_bwd_dq", "k3", "2c", 668, errs[0]),
            ("flash_attention_bwd_dkv", "k4", "3c", 787, errs[1])):
        tot = lambda f: sum(f(c) * c["calls_a_step"] for c in shapes)
        rows.append({
            "name": name, "row": tag,
            "mode": "head dim 256 (SD-1.5's 160, padded; native 256)",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/flash_attention.py:{line} (head "
                        "dims: _pad_for_kernel :339, :351-352)",
            "launches": launches["by_d"][name][256], "max_abs_err": err,
            "ms": tot(lambda c: c[key]["ms"]),
            "plain_ms": tot(lambda c: c["plain_ms"]),
            "bound_ms": tot(lambda c: c[key]["bound_ms"]),
            "bound_ms_model_d": tot(lambda c: c[key]["bound_ms_model_d"]),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                c[key]["bound_ms"] * c["calls_a_step"] for c in shapes
                if c[key]["bound_by"] == by)),
            "library_ms": tot(lambda c: c["library_ms"]),
            "per": "one training step's calls at d 256, b 2, 64x64 latents",
            "plain_ms_covers": "flash_attention_bwd_plain at d 160: dq, dk "
                               "and dv",
            "library_ms_covers": "backward of torch sdpa at d 160 over a "
                                 "retained graph, its kernels' device "
                                 "time: dq, dk and dv",
            "launches_by_path": {"train_unet":
                                 launches["by_d"][name][256]},
            "at_shapes": [dict(c[key], sq=c["sq"], sk=c["sk"],
                               calls_a_step=c["calls_a_step"])
                          for c in shapes]})
    return rows


def train_unet_launches(row, launches):
    """A kernel row's launches on path train_unet: the d-256 rows (1c, 2c,
    3c) their kernel's at d 256, row 1d K1's at 64 and 128, a row of
    another mode (window, dropout, int8) none (the step runs none of
    them: phase train_unet checks), any other row its kernel's."""
    tag, by_d = row.get("row"), launches["by_d"].get(row["name"], {})
    if tag in ("1c", "2c", "3c"):
        return by_d[256]
    if tag == "1d":
        return by_d[64] + by_d[128]
    return 0 if "mode" in row else launches.get(row["name"], 0)


UNET_STEPS, UNET_WARMUP = 10, 2


def unet_whole_model(fa, model, cfg):
    """A full-width forward on the card in bf16 (b 1, 32×32 latents, the
    77-token context) against the port's fp32 CPU forward of the same
    weights: relative L2 of ε. Moves the model to the CPU in fp32 (the
    caller is done with it on the card)."""
    from paddle_tpu_torch import unet_bench
    x, t, ctx = unet_bench.inputs(cfg, 1, 32, UNET_CTX, "cuda", seed=1)
    with torch.no_grad():
        eps = model(x, t, ctx).float().cpu()
    model.to(device="cpu", dtype=torch.float32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = model(x.float().cpu(), t.cpu(), ctx.float().cpu())
    cpu_s = time.perf_counter() - t0
    rel = (torch.linalg.vector_norm(eps - ref)
           / torch.linalg.vector_norm(ref)).item()
    return {"shape": list(x.shape), "rel_l2": rel, "bound": UNET_REL_L2,
            "max_abs_err": (eps - ref).abs().max().item(),
            "ref_max_abs": ref.abs().max().item(),
            "cpu_fp32_forward_s": cpu_s,
            "finite": bool(torch.isfinite(eps).all()),
            "ok": rel <= UNET_REL_L2 and bool(torch.isfinite(eps).all())}


def phase_unet(fa, fd, flops):
    """UNetConfig.sd15() in bf16 through the twin (see the module
    docstring, phase 20). Returns the counted run's launches."""
    from paddle_tpu_torch import unet_bench
    from paddle_tpu_torch.models import UNetConfig
    cfg = UNetConfig.sd15()
    b = 2
    model = unet_bench.build(cfg, "cuda")
    x0, t, ctx = unet_bench.inputs(cfg, b, 64, UNET_CTX, "cuda")
    count = unet_bench.forward_flops(model, x0, t, ctx)
    unet_bench.denoise(model, x0, t, ctx, UNET_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, fd)
    fa.flash_attention_fwd.by_d = dict.fromkeys(fa.FWD_DIMS, 0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with PlainAttention(fa) as plain:
        ev[0].record()
        t0 = time.perf_counter()
        eps = unet_bench.denoise(model, x0, t, ctx, UNET_STEPS)
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts(fa, fd)
    launches["by_d"] = dict(fa.flash_attention_fwd.by_d)
    step_ms = ev[0].elapsed_time(ev[1]) / UNET_STEPS
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(eps.float()).all())
    want = {"flash_attention_fwd": 32 * UNET_STEPS}
    others = {k: v for k, v in launches.items()
              if k not in ("flash_attention_fwd", "by_d") and v}
    want_d = {64: 10 * UNET_STEPS, 128: 10 * UNET_STEPS,
              256: 12 * UNET_STEPS}
    trace = traced_step(lambda: unet_bench.denoise(model, x0, t, ctx, 1),
                        families=UNET_FAMILIES)
    whole = unet_whole_model(fa, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res = {"phase": "unet", "config": "UNetConfig.sd15()", "batch": b,
           "latents": list(x0.shape), "context": list(ctx.shape),
           "warmup_steps": UNET_WARMUP, "steps": UNET_STEPS,
           "step_ms": step_ms, "wall_step_ms": wall * 1e3 / UNET_STEPS,
           "images_per_s": b / step_ms * 1e3,
           "flops_per_step": count,
           "mfu": count["total"] / (step_ms / 1e3) / flops,
           "floor_ms": count["total"] / flops * 1e3,
           "peak_memory_gb": peak / 1e9, "eps_finite": finite,
           "eps_shape": list(eps.shape), "launches": launches,
           "plain_attention_calls": plain.n, "traced_step": trace,
           "whole_model": whole}
    ok = (launches["flash_attention_fwd"] == want["flash_attention_fwd"]
          and launches["by_d"] == want_d and not others and plain.n == 0
          and finite and tuple(eps.shape) == tuple(x0.shape)
          and whole["ok"])
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError(
            f"phase unet: K1 {launches['flash_attention_fwd']} (want "
            f"{want['flash_attention_fwd']}), by d {launches['by_d']} (want "
            f"{want_d}), other kernels {others}, plain calls {plain.n}, "
            f"finite {finite}, whole model {whole}")
    return launches


# ---- SD-1.5 UNet training: the DDPM step ------------------------------------------

UNET_TRAIN_STEPS, UNET_TRAIN_WARMUP = 5, 2
# A training step's kernels by family: K1, K3, K4 apart, cuDNN's forward and
# backward convolutions, the products, the norms, the optimizer, copies
UNET_TRAIN_FAMILIES = (
    ("K1 flash_attention_fwd", ("flash_fwd_sm90",)),
    ("K3 flash_attention_bwd_dq", ("flash_bwd_dq_sm90",)),
    ("K4 flash_attention_bwd_dkv", ("flash_bwd_dkv_sm90",)),
    ("convolutions (cuDNN)", UNET_FAMILIES[1][1] + ("dgrad", "wgrad")),
    UNET_FAMILIES[2], UNET_FAMILIES[3],
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    UNET_FAMILIES[4])
# The full-width gradient check: one loss and backward in bf16 on the card
# (b 1, 32×32 latents) against the port's fp32 CPU loss and backward of the
# same weights. Expected from ε's 0.0133 (phase unet: bf16 activations,
# 2^-9 each, through ~60 layers) and the backward's own roundings: 2–4e-2
# relative L2 over all parameters' gradients. Measured on one H100 it read
# 0.0042, and 0.031 at the worst parameter (an attention key projection;
# PERF.md): the total is dominated by the large convolution gradients,
# whose bf16 noise averages over many terms. UNET_GRAD_REL_L2 0.02 and
# UNET_GRAD_REL_L2_PARAM 0.15 leave that ~5x room for other draws; the
# attention's projections hold a few per cent of the total norm, so it is
# the per-parameter bound that a wrong K3/K4 tile, mask, pad or scale (an
# O(1) error in every q, k, v projection's gradient) exceeds. The loss, a
# mean over the 4096 latent entries of (ε − noise)² ≈ 1, read 3.3e-4
# relative; 5e-3 leaves the same room.
UNET_GRAD_REL_L2 = 0.02
UNET_GRAD_REL_L2_PARAM = 0.15
UNET_LOSS_RTOL = 5e-3


def unet_grad_check(model, cfg):
    """One loss and backward of the DDPM step on the card in bf16 (b 1,
    32×32 latents, the 77-token context, train_inputs from seed 1) against
    the port's fp32 CPU loss and backward of the same weights: the
    relative loss difference and the relative L2 of the gradient over all
    parameters (and the worst parameter's, reported). Moves the model to
    the CPU in fp32 (the caller is done with it on the card)."""
    from paddle_tpu_torch import unet_bench

    def loss_grads(m, xt, t, ctx, noise):
        eps = m(xt, t, ctx)
        loss = torch.mean(torch.square(eps.float() - noise.float()))
        loss.backward()
        g = {n: p.grad.float().cpu() for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        return loss.item(), g

    xt, t, ctx, noise = unet_bench.train_inputs(cfg, 1, 32, UNET_CTX,
                                                "cuda", seed=1)
    loss, g = loss_grads(model, xt, t, ctx, noise)
    model.to(device="cpu", dtype=torch.float32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_ref, g_ref = loss_grads(model, xt.float().cpu(), t.cpu(),
                                 ctx.float().cpu(), noise.float().cpu())
    cpu_s = time.perf_counter() - t0
    num = sum(float((g[n] - r).square().sum()) for n, r in g_ref.items())
    den = sum(float(r.square().sum()) for r in g_ref.values())
    rel = math.sqrt(num / den)
    per = {n: float((g[n] - r).norm() / r.norm()) for n, r in g_ref.items()
           if float(r.norm()) > 0}
    worst = max(per, key=per.get)
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    finite = all(bool(torch.isfinite(v).all()) for v in g.values())
    return {"shape": list(xt.shape), "loss": loss, "loss_ref_fp32": loss_ref,
            "loss_rel_err": loss_rel, "loss_rtol": UNET_LOSS_RTOL,
            "grad_rel_l2": rel, "grad_rel_l2_bound": UNET_GRAD_REL_L2,
            "grad_rel_l2_worst_param": worst,
            "grad_rel_l2_worst": per[worst],
            "grad_rel_l2_param_bound": UNET_GRAD_REL_L2_PARAM,
            "cpu_fp32_loss_and_backward_s": cpu_s, "finite": finite,
            "ok": (finite and math.isfinite(loss) and rel <= UNET_GRAD_REL_L2
                   and per[worst] <= UNET_GRAD_REL_L2_PARAM
                   and loss_rel <= UNET_LOSS_RTOL)}


def phase_train_unet(fa, fd, flops):
    """UNetConfig.sd15() trained in bf16 through the twin's DDPM step (see
    the module docstring, phase 20a). Returns the counted steps' launches
    (with `by_d`: each attention kernel's launches by head dim)."""
    from paddle_tpu_torch import unet_bench
    from paddle_tpu_torch.models import UNetConfig
    cfg = UNetConfig.sd15()
    b = 2
    gc.collect()
    torch.cuda.empty_cache()
    model = unet_bench.build(cfg, "cuda")
    opt = unet_bench.optimizer(model)
    xt, t, ctx, noise = unet_bench.train_inputs(cfg, b, 64, UNET_CTX, "cuda")
    count = unet_bench.forward_flops(model, xt, t, ctx)
    step = lambda: unet_bench.train_step(model, opt, xt, t, ctx, noise)
    wraps = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)
    with PlainTraining(fa) as plain:
        losses = [step() for _ in range(UNET_TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, fd)
        for w in wraps:
            w.by_d = dict.fromkeys(w.by_d, 0)
            w.windowed = w.dropout = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        losses += [step() for _ in range(UNET_TRAIN_STEPS)]
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(fa, fd)
        launches["by_d"] = {w.__name__: dict(w.by_d) for w in wraps}
        other_modes = {w.__name__: w.windowed + w.dropout for w in wraps}
        peak = torch.cuda.max_memory_allocated()
        trace = traced_step(step, reps=1, families=UNET_TRAIN_FAMILIES)

        def forward_backward():
            eps = model(xt, t, ctx)
            torch.mean(torch.square(eps.float() - noise.float())).backward()
            for p in model.parameters():
                p.grad = None
        # the step without the optimizer: what the optimizer adds is the
        # difference
        trace_fb = traced_step(forward_backward, reps=1,
                               families=UNET_TRAIN_FAMILIES)
    losses = [float(v) for v in losses]
    step_ms = ev[0].elapsed_time(ev[1]) / UNET_TRAIN_STEPS
    n_params = model.num_params()
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    grad = unet_grad_check(model, cfg)
    del model
    gc.collect()
    n = UNET_TRAIN_STEPS
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention_fwd=32 * n, flash_attention_bwd_dq=32 * n,
                flash_attention_bwd_dkv=32 * n,
                by_d={w.__name__: {64: 10 * n, 128: 10 * n, 256: 12 * n}
                      for w in wraps})
    step_flops = 3 * count["total"]
    res = {"phase": "train_unet", "config": "UNetConfig.sd15()",
           "params": n_params, "batch": b, "latents": list(xt.shape),
           "context": list(ctx.shape), "dtype": "bfloat16",
           "optimizer": "AdamW(1e-4, multi_precision=False)",
           "warmup_steps": UNET_TRAIN_WARMUP, "steps": n,
           "step_ms": step_ms, "wall_step_ms": wall * 1e3 / n,
           "images_per_s": b / step_ms * 1e3,
           "flops_per_step": step_flops, "forward_flops": count,
           "mfu": step_flops / (step_ms / 1e3) / flops,
           "mfu_basis": "3 x unet_bench.forward_flops (forward + backward)",
           "floor_ms": step_flops / flops * 1e3,
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "launches": launches, "windowed_or_dropout_launches": other_modes,
           "plain_attention_calls": plain.n,
           "step_trace": trace, "device_idle_share": None if trace is None
           else 1 - trace["busy_ms"] / step_ms,
           "forward_backward_trace": trace_fb, "grad_check": grad}
    bad = []
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if plain.n:
        bad.append(f"{plain.n} plain attention calls")
    if any(other_modes.values()):
        bad.append(f"windowed or dropout launches {other_modes}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        bad.append(f"loss not finite or not falling: {losses}")
    if not grad["ok"]:
        bad.append(f"gradient check {grad}")
    res["ok"] = not bad
    emit(res)
    if bad:
        raise AssertionError("train_unet: " + "; ".join(bad))
    return launches


# ---- K1, K3, K4's mask modes (phase k1m) --------------------------------------

# Dense-mask cases of phase k1m: (name, b, h, nkv, sq, sk, d, causal, the
# mask's form, the attention dropout). The ERNIE-base case is the shape of
# phase ernie's masked backbone, which the rows 1e, 2d and 3d time.
K1M_CASES = (
    ("ernie_base_key_padding", 32, 12, 12, 512, 512, 64, False, "padding",
     0.0),
    ("ernie_titan_key_padding", 8, 96, 96, 512, 512, 128, False, "padding",
     0.0),
    ("tinyllama_causal_padding", 4, 32, 4, 2048, 2048, 64, True, "padding",
     0.0),
    ("full_4d_fp32", 2, 8, 8, 512, 512, 64, False, "fp32_4d", 0.0),
    ("block_sparse_2d_bool", 2, 8, 8, 1024, 1024, 128, False, "blocks_2d",
     0.0),
    ("mask_3d_gqa", 2, 8, 2, 384, 384, 64, True, "bool_3d", 0.0),
    ("cross_512x77_key_mask", 4, 8, 8, 512, 77, 64, False, "padding", 0.0),
    ("ernie_base_dead_blocks", 32, 12, 12, 512, 512, 64, False,
     "padding_dead", 0.0),
    ("ernie_base_dead_rows", 32, 12, 12, 512, 512, 64, False, "rows_dead",
     0.0),
    ("ernie_base_neg1e4", 32, 12, 12, 512, 512, 64, False, "neg1e4", 0.0),
    ("fp32_dead_rows", 2, 8, 8, 512, 512, 64, False, "fp32_dead", 0.0),
    ("ragged_sk_causal_padding", 2, 8, 2, 300, 333, 128, True, "padding",
     0.0),
    # K3 takes a bool mask's dead rows off its walk by log2 l = +inf: dead
    # rows inside FULL tiles beside live ones (d 128, GQA, causal), and
    # whole blocks of dead rows under dropout (on K1's and K4's walks there)
    ("full_tiles_dead_rows", 2, 8, 2, 640, 640, 128, True, "rows_dead_full",
     0.0),
    ("ernie_base_dead_blocks_dropout", 32, 12, 12, 512, 512, 64, False,
     "padding_dead", 0.1),
)
# the cases that draw from a generator of their own (so that the others'
# inputs stay those of the runs before them)
K1M_OWN_GEN = ("full_tiles_dead_rows", "ernie_base_dead_blocks_dropout")
K1M_MAIN = "ernie_base_key_padding"


def k1m_mask(form, b, h, sq, sk, gen):
    """The mask of a k1m case, made from `gen` on the card."""
    u = lambda *s: torch.rand(s, generator=gen, device="cuda")
    if form == "padding":           # (b, 1, 1, sk) bool, lengths 1/8..1 sk
        lens = (sk // 8 + (u(b) * (sk - sk // 8 + 1)).long()).clamp(max=sk)
        return (torch.arange(sk, device="cuda")[None] < lens[:, None])[
            :, None, None, :]
    if form == "fp32_4d":           # PaddleNLP's -1e4 soft padding, whole
        m = torch.where(u(b, h, sq, sk) < 0.2, -1e4, 0.0)   # rows of -1e10
        m[:, :, 5::37] = -1e10                              # and -inf tiles
        m[:, :, :256, 256:] = float("-inf")
        m[:, :, 256:, 128:256] = float("-inf")
        return m
    if form == "blocks_2d":         # 128 x 128 blocks of a bool pattern,
        blk = u(sq // 128, sk // 128) < 0.4            # diagonal kept, and
        blk |= torch.eye(sq // 128, dtype=torch.bool, device="cuda")
        m = blk.repeat_interleave(128, 0).repeat_interleave(128, 1)
        m[300] = False              # a row hidden at every key (dead)
        return m
    if form == "bool_3d":           # (h, sq, sk) bool, a head's own rows
        m = u(h, sq, sk) < 0.7
        m[..., 0] = True
        return m
    if form == "padding_dead":      # key padding, two batch rows of length
        m = k1m_mask("padding", b, h, sq, sk, gen)     # 0: every row dead,
        m[3] = m[17 % b] = False                        # whole blocks
        return m
    if form == "rows_dead":         # (b, 1, sq, sk): key padding and, in
        m = k1m_mask("padding", b, h, sq, sk, gen)     # 8 batch rows, query
        m = m.expand(b, 1, sq, sk).clone()              # rows hidden at every
        m[:8, :, 100:140] = False                       # key (dead rows
        m[:8, :, sq - 1] = False                        # beside live ones)
        return m
    if form == "rows_dead_full":    # (b, 1, sq, sk) True but query rows
        m = torch.ones((b, 1, sq, sk), dtype=torch.bool,   # hidden at
                       device="cuda")                      # every key, in
        m[0, :, [5, 77, 200, 450]] = False                 # FULL tiles
        m[1 % b, :, 300:331] = False                       # beside live
        return m                                           # rows
    if form == "neg1e4":            # PaddleNLP's additive padding mask,
        keep = k1m_mask("padding", b, h, sq, sk, gen)  # (b, 1, 1, sk) fp32
        return torch.where(keep, 0.0, -1e4)            # 0 / -1e4
    if form == "fp32_dead":         # -1e4 soft entries, and rows at -1e30
        m = torch.where(u(b, h, sq, sk) < 0.2, -1e4, 0.0)   # at every key:
        m[:, :, 7::41] = -1e30      # float dead rows (their blocks walk
        return m                    # every tile)
    raise ValueError(form)


def k1m_library_mask(mask, sq, sk, causal):
    """The case's mask with the causal mask folded in, as torch sdpa takes
    it (it takes no is_causal beside a mask)."""
    if not causal:
        return mask
    s = torch.ones((sq, sk), dtype=torch.bool, device="cuda").tril(sk - sq)
    return mask & s if mask.dtype == torch.bool else mask + torch.where(
        s, 0.0, float("-inf"))


# The tensor operations a (query, key) pair costs each kernel, over the
# head dim: QKᵀ and P·V in K1 (4·d), S, dP and dq in K3 (6·d), S, dP, dv
# and dk in K4 (8·d). A dead row's key under a bool mask (the uniform
# softmax over every key, csrc/attn_mask.cuh) has a score that does not
# depend on s: K1 needs its P·V alone and K4 its dv alone (2·d), K3
# nothing (the row's dq is 0). A float mask's dead row is a softmax like
# any other and costs a pair's operations.
PAIR_OPS = {"k1": 4, "k3": 6, "k4": 8}
DEAD_KEY_OPS = {"k1": 2, "k3": 0, "k4": 2}


def attention_ops(key, d, pairs, dead_pairs, bool_mask, closed=False):
    """Kernel `key`'s tensor operations over `pairs` visible pairs and the
    `dead_pairs` (dead rows × sk) of a mask call. `closed`: the dead rows
    of a bool mask without dropout are the closed form (the mean of v, dO
    / sk to every key's dv) and cost no pair's operations: reads of v and
    dO, which the kernels' bytes count already."""
    if closed:
        return d * PAIR_OPS[key] * pairs
    dead = DEAD_KEY_OPS[key] if bool_mask else PAIR_OPS[key]
    return d * (PAIR_OPS[key] * pairs + dead * dead_pairs)


def tile_counts(bounds, b, h, nkv):
    """A call's tiles by class over every block: K1's (b, h, 128-row
    blocks, 128-key tiles), K3's (b, h, 128-row blocks, 64-key tiles) and
    K4's (b, kv heads, 128-key blocks, 64-row query tiles), and its dead
    rows (b, h) and whether they are off K1's and K4's walks (a bool mask
    without dropout; K3's: any bool mask)."""
    out = {}
    for key, name, heads in (("k1", "fwd_cls", h), ("k3", "dq_cls", h),
                             ("k4", "dkv_cls", nkv)):
        c = bounds[name]
        c = c.expand(b, heads, *c.shape[2:])
        out[key] = {n: int((c == v).sum().item()) for n, v in (
            ("empty", 0), ("full", 1), ("mixed", 2))}
    dead = bounds["dead"]
    out["dead_rows"] = int(dead.expand(b, dead.shape[1], dead.shape[2])
                           .sum().item()) * (h // dead.shape[1])
    out["dead_rows_off_walk"] = bool(bounds["dead_off"])
    return out


def k1m_work(fa, mask, b, h, nkv, sq, sk, d, causal):
    """(pairs, dead pairs, {k1, k3, k4: bytes}) of a masked call: the
    (query, key) pairs this run's mask and structure leave (a tile of -inf
    or False entries is no work), sk for each dead row, and the bytes each
    kernel must move: q, k, v (and dO) in bf16 once, the mask once at its
    broadcast shape, the outputs once, the (m, log l) pairs (and Δ)."""
    m4 = fa.dense_mask(mask, b, h, sq, sk)
    ok = m4 if m4.dtype == torch.bool else m4 != float("-inf")
    live = m4 if m4.dtype == torch.bool else m4 > -5e29
    vis = fa._visible_keys(b, sq, sk, causal, None, None, m4.device)
    keys = torch.arange(sk, device="cuda")
    seen = (keys[None, None, None] < vis[:, None, :, None])
    pairs = int((ok & seen).expand(b, h, sq, sk).sum().item())
    dead = ~(live & seen).any(-1) & (vis[:, None] > 0)
    dead_pairs = int(dead.expand(b, h, sq).sum().item()) * sk
    tq, tk = b * sq * h * d * 2, b * sk * nkv * d * 2
    mb = m4.numel() * m4.element_size()
    rows = b * h * sq
    return pairs, dead_pairs, {"k1": 2 * tq + 2 * tk + mb + 8 * rows,
                   "k3": 3 * tq + 2 * tk + mb + 12 * rows,
                   "k4": 2 * tq + 4 * tk + mb + 12 * rows}


def k1m_case(fa, gen, name, b, h, nkv, sq, sk, d, causal, form, dropout,
             bw, flops, iops):
    """K1, K3 and K4 in mask mode against their plain versions on the same
    inputs (with `dropout`, the same keep mask): out within K1_TOL_OUT (plus
    K1S_OUT_RTOL·|plain| under dropout, whose 1/keep scales a kept
    probability) and the pair's lse m + log l within K1_TOL_LSE (plus
    2^-22·|m|: rows at -1e10); each gradient within K3_TOL · max|plain|
    (the plain backward on K1's (out, pairs)); each kernel launched twice
    with the same bits. Then the device times of the three kernels, torch
    sdpa's with the same mask (forward, and backward over a retained
    graph), the plain versions', and the bounds."""
    from paddle_tpu_torch.core import rng
    q, k, v, do = (rand(s, gen) for s in ((b, sq, h, d), (b, sk, nkv, d),
                                           (b, sk, nkv, d), (b, sq, h, d)))
    mask = k1m_mask(form, b, h, sq, sk, gen)
    kw = dict(is_causal=causal, attn_mask=mask)
    if dropout:
        kw.update(dropout_p=dropout, key=rng.fold_in(drop_key(24), 0))
    m4 = fa.dense_mask(mask, b, h, sq, sk)
    bounds = fa.mask_bounds(m4, b, h, nkv, sq, sk, causal,
                            dropout=dropout > 0.0)
    with torch.no_grad():
        out, st = fa.flash_attention_fwd(q, k, v, **kw, bounds=bounds)
        out2, st2 = fa.flash_attention_fwd(q, k, v, **kw, bounds=bounds)
    ref, ref_st = fa.flash_attention_fwd_plain(q, k, v, **kw)
    err = ((out.float() - ref.float()).abs() - (K1S_OUT_RTOL if dropout
           else 0.0) * ref.float().abs()).max().item()
    lse, ref_lse = st.double().sum(-1), ref_st.double().sum(-1)
    lerr = ((lse - ref_lse).abs() - 2.0 ** -22 * ref_st[..., 0].double()
            .abs()).max().item()
    res = {"case": name, "b": b, "h": h, "nkv": nkv, "sq": sq, "sk": sk,
           "d": d, "causal": causal, "mask": form, "dropout": dropout,
           "mask_shape": list(m4.shape), "mask_dtype": str(m4.dtype),
           "max_abs_err": err, "tol": K1_TOL_OUT, "lse_max_abs_err": lerr,
           "lse_tol": K1_TOL_LSE,
           "k1_two_launches_bitwise": bool(torch.equal(out, out2)
                                          and torch.equal(st, st2)),
           "finite": bool(torch.isfinite(out.float()).all())}
    res["ok"] = (err <= K1_TOL_OUT and lerr <= K1_TOL_LSE and res["finite"]
                 and res["k1_two_launches_bitwise"])
    del ref, ref_st
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bkw = dict(kw, bounds=bounds)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, st, delta, **bkw)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, st, delta, **bkw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **bkw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **bkw)
    res["k3_two_launches_bitwise"] = bool(torch.equal(dq, dq2))
    res["k4_two_launches_bitwise"] = bool(torch.equal(dk, dk2)
                                          and torch.equal(dv, dv2))
    res["ok"] &= res["k3_two_launches_bitwise"] and \
        res["k4_two_launches_bitwise"]
    grads = fa.flash_attention_bwd_plain(q, k, v, out, st, do, **kw)
    for gname, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        e = (g.float() - r).abs().max().item()
        tol = K3_TOL * r.abs().max().item()
        res[gname] = {"max_abs_err": e, "tol": tol}
        res["ok"] &= bool(e <= tol and torch.isfinite(g.float()).all())
    del grads
    pairs, dead_pairs, nbytes = k1m_work(fa, mask, b, h, nkv, sq, sk, d,
                                         causal)
    res["tiles"] = tile_counts(bounds, b, h, nkv)
    res["pairs"] = pairs
    res["dead_row_pairs"] = dead_pairs
    res["pairs_of_all"] = (pairs + dead_pairs) / (b * h * sq * sk)
    with torch.no_grad():
        ms = {"k1": device_ms(lambda: fa.flash_attention_fwd(
                  q, k, v, **kw, bounds=bounds), iters=10),
              "k3": device_ms(lambda: fa.flash_attention_bwd_dq(
                  q, k, v, do, st, delta, **bkw), iters=10),
              "k4": device_ms(lambda: fa.flash_attention_bwd_dkv(
                  q, k, v, do, st, delta, **bkw), iters=10)}
    res["bounds_ms"] = time_ms(lambda: fa.mask_bounds(
        m4, b, h, nkv, sq, sk, causal, dropout=dropout > 0.0), iters=10)
    res["bounds_host_syncs"] = host_syncs(lambda: fa.mask_bounds(
        m4, b, h, nkv, sq, sk, causal, dropout=dropout > 0.0))
    plain = {"k1": time_ms(lambda: fa.flash_attention_fwd_plain(
                 q, k, v, **kw), iters=2, warmup=1),
             "k3": time_ms(lambda: fa.flash_attention_bwd_plain(
                 q, k, v, out, st, do, **kw), iters=2, warmup=1)}
    plain["k4"] = plain["k3"]     # one plain backward gives dq, dk and dv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lm = k1m_library_mask(mask, sq, sk, causal)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    gqa = {"enable_gqa": True} if nkv != h else {}
    gqa["dropout_p"] = dropout      # sdpa's own keep mask
    with torch.no_grad():
        lib_fwd = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=lm, **gqa),
                            iters=10)
    o_lib = sdpa(qt, kt, vt, attn_mask=lm, **gqa)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        iters=10)
    del o_lib
    lib = {"k1": lib_fwd, "k3": lib_bwd, "k4": lib_bwd}
    is_bool = m4.dtype == torch.bool
    for key in ("k1", "k3", "k4"):
        # dropout hashes every pair the kernel weighs (a bool mask's dead
        # row's keys for out and dv; K3 makes the same words, every key of
        # a row, for its zero dq); without it a bool mask's dead row is the
        # closed form
        hashed = pairs + (dead_pairs if DEAD_KEY_OPS[key] or not is_bool
                          or key == "k3" else 0)
        nint = HASH_OPS * hashed if dropout else 0
        bound, by = bound3(nbytes[key], attention_ops(
            key, d, pairs, dead_pairs, is_bool,
            closed=is_bool and not dropout), nint, bw, flops, iops)
        bound_pr21, _ = bound3(nbytes[key], attention_ops(
            key, d, pairs, dead_pairs, is_bool), nint, bw, flops, iops)
        res[key] = dict(res.get(key, {}), ms=ms[key], plain_ms=plain[key],
                        library_ms=lib[key], bound_ms=bound, bound_by=by,
                        bound_ms_dead_rows_as_pairs=bound_pr21)
    res["library_covers"] = ("torch sdpa with the same mask (structured "
                             "masks folded in): k1 its forward, k3 and k4 "
                             "its backward (dq, dk, dv)")
    res["plain_covers"] = "k3 and k4: one plain backward gives dq, dk, dv"
    return res


def host_syncs(fn):
    """[(file:line, message)] of the synchronizing CUDA operations fn runs
    (torch's sync debug mode)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename}:{w.lineno}: {str(w.message)[:120]}" for w in got]


def k1m_nan_row(fa, gen):
    """A float row at -inf at every key gives NaN out and NaN log l in K1,
    as in its plain version; the other rows agree as in phase k1m."""
    q, k, v = (rand((1, 200, 2, 64), gen) for _ in range(3))
    m = torch.zeros((1, 1, 200, 200), device="cuda")
    m[..., 77, :] = float("-inf")
    with torch.no_grad():
        out, st = fa.flash_attention_fwd(q, k, v, attn_mask=m)
    ref, _ = fa.flash_attention_fwd_plain(q, k, v, attn_mask=m)
    nan_row = bool(torch.isnan(out[0, 77].float()).all()
                   and torch.isnan(ref[0, 77].float()).all()
                   and torch.isnan(st[0, :, 77, 1]).all())
    keep = torch.ones(200, dtype=torch.bool, device="cuda")
    keep[77] = False
    err = (out[0, keep].float() - ref[0, keep].float()).abs().max().item()
    return {"nan_row": nan_row, "other_rows_max_abs_err": err,
            "ok": nan_row and err <= K1_TOL_OUT}


def k1m_padded_dims(fa, gen):
    """The dispatch at SD-1.5's head dims 40 and 80 with a (b, 1, 1, sk)
    key mask: padded to 64 and 128, K1, K3 and K4 in mask mode once each,
    the output and gradients against the plain versions at the unpadded
    d (K1_TOL_OUT; K3_TOL · max|plain|)."""
    cases = []
    for d in (40, 80):
        b, h, s = 2, 8, 320
        q, k, v, do = (rand((b, s, h, d), gen) for _ in range(4))
        mask = k1m_mask("padding", b, h, s, s, gen)
        before = (fa.flash_attention_fwd.masked,
                  fa.flash_attention_bwd_dq.masked,
                  fa.flash_attention_bwd_dkv.masked)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.scaled_dot_product_attention(*leaves, attn_mask=mask)
        o.backward(do)
        launched = [w.masked - n for w, n in zip(
            (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv), before)]
        ref, st = fa.flash_attention_fwd_plain(q, k, v, attn_mask=mask)
        grads = fa.flash_attention_bwd_plain(q, k, v, ref, st, do,
                                             attn_mask=mask)
        err = (o.float() - ref.float()).abs().max().item()
        res = {"d": d, "kernel_d": 64 if d == 40 else 128,
               "max_abs_err": err, "mask_launches": launched,
               "ok": err <= K1_TOL_OUT and launched == [1, 1, 1]}
        for name, t, r in zip(("dq", "dk", "dv"), leaves, grads):
            e = (t.grad.float() - r).abs().max().item()
            res[name] = {"max_abs_err": e,
                         "tol": K3_TOL * r.abs().max().item()}
            res["ok"] &= e <= res[name]["tol"]
        cases.append(res)
    return cases


def mask_refusals(fa):
    """{mode: the NotImplementedError's message, or None where it ran} of a
    masked call beside the window, dropout, and at head dim 256: the
    window and dropout run (the general instantiations), d 256 raises."""
    from paddle_tpu_torch.core import rng
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device="cuda")
    q256 = torch.zeros((1, 64, 2, 256), dtype=torch.bfloat16, device="cuda")
    m = torch.ones((64, 64), dtype=torch.bool, device="cuda")
    out = {}
    for mode, args, kw in (
            ("window", (q, q, q), dict(is_causal=True, window=4)),
            ("dropout", (q, q, q), dict(dropout_p=0.1, key=rng.PRNGKey(3))),
            ("d256", (q256, q256, q256), {})):
        try:
            with torch.no_grad():
                fa.flash_attention_fwd(*args, attn_mask=m, **kw)
            out[mode] = None
        except NotImplementedError as e:
            out[mode] = str(e)
    return out


def phase_k1m(fa, bw, flops, iops):
    """K1, K3 and K4's mask modes against their plain versions (see the
    module docstring, phase 8k)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    own = torch.Generator(device="cuda")
    own.manual_seed(24)
    cases = []
    for case in K1M_CASES:
        cases.append(k1m_case(fa, own if case[0] in K1M_OWN_GEN else gen,
                              *case, bw, flops, iops))
        emit({"phase": "k1m_case", **cases[-1]})
        gc.collect()
        torch.cuda.empty_cache()
    nan_row = k1m_nan_row(fa, gen)
    padded = k1m_padded_dims(fa, gen)
    refused = mask_refusals(fa)
    emit({"phase": "k1m", "cases": cases, "nan_row": nan_row,
          "padded_head_dims": padded, "modes_refused": refused})
    bad = ([c["case"] for c in cases if not c["ok"]]
           + ([] if nan_row["ok"] else ["nan_row"])
           + [f"d {c['d']}" for c in padded if not c["ok"]]
           + [f"the mask with {m}: {e}" for m, e in refused.items()
              if (m == "d256") != bool(e and "Queue B rows 1-3" in e)]
           + [f"{c['case']}: mask_bounds synchronizes the host"
              for c in cases if c["bounds_host_syncs"]])
    if bad:
        raise AssertionError(f"K1, K3, K4 mask modes: {bad}")
    return cases


def mask_rows(cases, launches):
    """Rows 1e, 2d and 3d (K1, K3, K4's mask modes): device time, bound,
    plain and sdpa-with-the-mask times at the main path's call (phase
    ernie's masked ERNIE-base backbone: K1M_MAIN's shape), every k1m case
    beside them, the largest error over the cases, and the launches of
    the mask instantiations on path ernie."""
    main = next(c for c in cases if c["case"] == K1M_MAIN)
    rows = []
    for name, key, tag, line, what in (
            ("flash_attention_fwd", "k1", "1e", 526, "_fwd_kernels"),
            ("flash_attention_bwd_dq", "k3", "2d", 668, "_bwd_dq_kernel"),
            ("flash_attention_bwd_dkv", "k4", "3d", 787, "_bwd_dkv_kernel")):
        err = max(c["max_abs_err"] if key == "k1"
                  else c["dq"]["max_abs_err"] if key == "k3"
                  else max(c["dk"]["max_abs_err"], c["dv"]["max_abs_err"])
                  for c in cases)
        t = main[key]
        rows.append({
            "name": name, "row": tag,
            "mode": "dense attn_mask (bool or fp32, broadcast strides)",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/" + (
                "flash_attention.cu" if key == "k1"
                else "flash_attention_bwd.cu"),
            "replaces": f"paddle_tpu/ops/flash_attention.py:{line} ({what}"
                        ", mask: _mask_block_bounds :445)",
            "launches": launches["masked"][name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "per": f"one call at {K1M_MAIN}: b {main['b']}, h {main['h']}, "
                   f"s {main['sq']}, d {main['d']}, (b, 1, 1, s) bool",
            "launches_by_path": {"ernie": launches["masked"][name]},
            "at_cases": [dict(c[key], case=c["case"]) for c in cases]})
    return rows


# ---- ERNIE (phase ernie) --------------------------------------------------------

# The twin's runs: (tag, seq, batch) — the reference's defaults, and a
# longer, wider batch
ERNIE_TITAN_RUNS = (("reference_defaults", 128, 1), ("s512_b8", 512, 8))
# ERNIE-base's masked backbone: b, s (K1M_MAIN's attention shape)
ERNIE_BASE_SHAPE = (32, 512)
# The backbone on the kernels against the same bf16 model over the plain
# twins on the card: both round every activation to bf16, and only the
# attention differs (the kernels round P and dS to bf16 before their
# products, the plain versions compute in fp32 and round the result); those
# flips feed the next layers. The output's relative L2 over 12 post-norm
# layers is a few bf16 ulps (2^-9 each); each gradient sums such roundings
# per layer through the backward. One parameter's gradient sums them with
# little signal: the token-type embedding's two rows are sums over 16,384
# tokens of sum(out·w)'s random-sign terms, whose signal cancels and whose
# bf16 noise does not, and its norm dominates all gradients' together.
# On an H100 (bf16, seed 21) the output read 0.0109, every parameter but
# that one 0.013 or less, that one 0.064, all together 0.022. So, as
# phase train_unet sets its bounds from such a reading: all gradients
# within ERNIE_GRAD_REL_L2, the worst parameter within
# ERNIE_GRAD_REL_L2_PARAM.
# What the mask itself does to the output (the plain twins with and
# without it) is small at random weights: the attention is near uniform
# and a mean over all keys or the valid ones of random values is near 0
# either way (read 0.072 at the output, 0.019 at the first layer's output
# after its norms and FFN), while the random post-norm stack grows any
# difference layer by layer (the kernels' 0.0020 at the first layer,
# 0.0109 at the last). So the sharp check is where the mask acts, the
# first layer's attention output: there the kernels' difference from the
# plain twins must sit ERNIE_MASK_MARGIN times or more below the mask's
# own effect, which a kernel that dropped or added keys would match.
ERNIE_OUT_REL_L2 = 2.0 ** -6
ERNIE_GRAD_REL_L2 = 5e-2
ERNIE_GRAD_REL_L2_PARAM = 0.15
ERNIE_MASK_MARGIN = 10


def mask_counts(fa):
    """The launches of K1's, K3's and K4's mask instantiations."""
    return {w.__name__: w.masked for w in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv)}


def ernie_titan_runs(fa):
    """The twin (paddle_tpu_torch.scale_report ernie-titan-step) at each of
    ERNIE_TITAN_RUNS: Titan width, the reference's 1 + 1 cut, SGD 1e-4, 2
    warm-up and 6 counted steps. Each run's record, with whether every
    loss is finite and the last below the first."""
    import argparse
    from paddle_tpu_torch import scale_report
    runs = {}
    for tag, seq, b in ERNIE_TITAN_RUNS:
        rec = scale_report.run(argparse.Namespace(
            steps=6, seq=seq, batch=b, layers=1, task_layers=1,
            device="cuda", tiny=False))
        losses = rec["warmup_losses"] + rec["losses"]
        rec["finite"] = all(math.isfinite(x) for x in losses)
        rec["last_below_first"] = losses[-1] < losses[0]
        rec["ok"] = rec["finite"] and rec["last_below_first"]
        runs[tag] = rec
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def ernie_titan_trace():
    """Where the Titan step's time goes (the twin's defaults: b 1, seq
    128): the twin's model, optimizer and batch, two steps, then one
    traced step by kernel family and one traced forward and backward
    alone (the SGD update is the difference)."""
    from paddle_tpu_torch import scale_report
    cfg = scale_report.config()
    model, opt, state = scale_report.build(cfg, "cuda")
    x, y = scale_report.batch(cfg, 1, 128, "cuda")
    params = list(model.trainable_state().values())

    def step():
        scale_report.train_step(model, opt, state, x, y)

    def forward_backward():
        torch.autograd.grad(model.loss(model(x), y), params,
                            allow_unused=True)
    step()
    res = {"step": traced_step(step),
           "forward_backward": traced_step(forward_backward)}
    del model, opt, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ernie_base_backbone(fa, fd):
    """ErnieConfig() (ERNIE-base: 12 layers, hidden 768, 12 heads of d 64)
    as the backbone ErnieModel in bf16, eval (no hidden dropout), on a
    padded batch (lengths from a seed, 1/8 s to s) with its (b, 1, 1, s)
    bool mask and random token types: forward and the gradients of
    sum(out · w), w fixed random weights, on the kernels (every attention
    call on the mask instantiations, no plain call) and over the plain
    twins on the card (PlainKernelsOnCard); the output's relative L2
    within ERNIE_OUT_REL_L2, all gradients' within ERNIE_GRAD_REL_L2 and
    the worst parameter's within ERNIE_GRAD_REL_L2_PARAM.
    Also the step's device time on the kernels and on the plain twins."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieModel
    b, s = ERNIE_BASE_SHAPE
    cfg = ErnieConfig()
    model = ErnieModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    model.eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)   # ERNIE-base's own draws
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device="cuda")
    types = torch.randint(0, 2, (b, s), generator=gen, device="cuda")
    mask = k1m_mask("padding", b, cfg.num_heads, s, s, gen)
    w = rand((b, s, cfg.hidden_size), gen, scale=1.0 / math.sqrt(b * s),
             dtype=torch.float32)
    params = model.trainable_state()
    # the first layer's attention output and the outputs of layers 0, 5,
    # 11 of the last forward
    seen = {}
    for i, mod in (("attn0", model.layers[0].attn), (0, model.layers[0]),
                   (5, model.layers[5]), (11, model.layers[11])):
        mod.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(i, out.detach()))

    def step():
        out = model(ids, types, mask)
        grads = torch.autograd.grad((out.float() * w).sum(),
                                    list(params.values()))
        return out, grads
    before = (dict(mask_counts(fa)), fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    with PlainTraining(fa) as plain_calls:
        out, grads = step()
    torch.cuda.synchronize()
    layers_k = dict(seen)
    # the path's counts end here (the timing below drives the step again)
    path_launches = {"all": counts(fa, fd), "masked": mask_counts(fa)}
    masked = {k: v - before[0][k] for k, v in mask_counts(fa).items()}
    launched = [fa.flash_attention_fwd.launches - before[1],
                fa.flash_attention_bwd_dq.launches - before[2],
                fa.flash_attention_bwd_dkv.launches - before[3]]
    ms = time_ms(step, iters=3, warmup=1)
    with PlainKernelsOnCard(fa):
        out_p, grads_p = step()
        layers_p = dict(seen)
        with torch.no_grad():
            out_nomask = model(ids, types)
        layers_n = dict(seen)
        plain_ms = time_ms(step, iters=2, warmup=1)
    rel = lambda a, r: (torch.linalg.vector_norm(a.float() - r.float())
                        / torch.linalg.vector_norm(r.float())).item()
    out_rel = rel(out, out_p)
    mask_effect = rel(out_nomask, out_p)
    by_layer = {i: {"kernels_vs_plain": rel(layers_k[i], layers_p[i]),
                    "mask_effect": rel(layers_n[i], layers_p[i])}
                for i in layers_k}
    grad_rel = {k: rel(g, r) for k, g, r in zip(params, grads, grads_p)}
    worst = sorted(grad_rel, key=grad_rel.get)[::-1]
    cat = lambda gs: torch.cat([g.float().reshape(-1) for g in gs])
    all_rel = rel(cat(grads), cat(grads_p))
    n = cfg.num_hidden_layers
    res = {"config": "ErnieConfig() (ERNIE-base)", "layers": n, "b": b,
           "s": s, "heads": cfg.num_heads,
           "head_dim": cfg.hidden_size // cfg.num_heads,
           "mask": "(b, 1, 1, s) bool padding",
           "valid_keys_of_all": mask.float().mean().item(),
           "mask_launches": masked, "launches": launched,
           "plain_calls": plain_calls.n, "out_rel_l2": out_rel,
           "out_tol": ERNIE_OUT_REL_L2, "mask_effect_rel_l2": mask_effect,
           "rel_l2_by_layer": by_layer, "mask_margin": ERNIE_MASK_MARGIN,
           "grad_rel_l2": all_rel, "grad_tol": ERNIE_GRAD_REL_L2,
           "grad_rel_l2_worst_params": {k: grad_rel[k] for k in worst[:5]},
           "grad_param_tol": ERNIE_GRAD_REL_L2_PARAM,
           "step_ms_kernels": ms, "step_ms_plain_twins": plain_ms,
           "finite": bool(torch.isfinite(out.float()).all())}
    res["ok"] = (out_rel <= ERNIE_OUT_REL_L2
                 and ERNIE_MASK_MARGIN * by_layer["attn0"]["kernels_vs_plain"]
                 <= by_layer["attn0"]["mask_effect"]
                 and all_rel <= ERNIE_GRAD_REL_L2
                 and grad_rel[worst[0]] <= ERNIE_GRAD_REL_L2_PARAM
                 and masked == dict.fromkeys(masked, n)
                 and launched == [n, n, n] and plain_calls.n == 0
                 and res["finite"])
    del model, out, grads, out_p, grads_p, out_nomask, seen, layers_k, \
        layers_p, layers_n
    gc.collect()
    torch.cuda.empty_cache()
    return res, path_launches


def phase_ernie(fa, fd):
    """ERNIE-3.0 at Titan width through the twin, and ERNIE-base's masked
    backbone on the mask instantiations (see the module docstring, phase
    21). Returns the path's launches: {all: every kernel's, masked: the
    mask instantiations'} over the twin's runs and the backbone's first
    step on the kernels (not its timing)."""
    reset_counts(fa, fd)
    titan = ernie_titan_runs(fa)
    titan_launches = counts(fa, fd)
    trace = ernie_titan_trace()
    backbone, launches = ernie_base_backbone(fa, fd)
    # the twin's runs launch no mask instantiation; the backbone only them
    titan_ok = titan_launches["flash_attention_fwd"] == sum(
        2 * (r["warmup_steps"] + r["steps"]) for r in titan.values())
    emit({"phase": "ernie", "titan": titan, "titan_launches": titan_launches,
          "titan_traced_b1_s128": trace,
          "titan_launches_ok": titan_ok, "ernie_base_backbone": backbone,
          "launches": launches})
    bad = ([f"titan {t}" for t, r in titan.items() if not r["ok"]]
           + ([] if titan_ok else ["titan launches"])
           + ([] if backbone["ok"] else ["ernie-base backbone"]))
    if bad:
        raise AssertionError(f"phase ernie: {bad}")
    return launches


# ---- the rest of flash attention (phases k1s, train_mistral_pad) --------------

# (b, sq, sk, h, nkv, d) of the models' attention calls: Mistral-7B's
# training call (train_mistral: b 1, S 8192), its padded batch's
# (train_mistral_pad: b 2), GPT-2 345M's (train: b 8, S 1024), and a
# cross-attention at GPT-2's heads over a 1536-key context
K1S_SHAPES = {"mistral": (1, 8192, 8192, 32, 8, 128),
              "mistral_pad": (2, 8192, 8192, 32, 8, 128),
              "gpt2": (8, 1024, 1024, 16, 16, 64),
              "gpt2_cross": (8, 1024, 1536, 16, 16, 64)}
# the window at each shape: Mistral-7B's own, and a quarter of GPT-2's
# sequence (GPT-2 has none: a window that bites in most rows)
K1S_WINDOW = {"mistral": 4096, "mistral_pad": 4096, "gpt2": 256}
# Mistral's padded batch: row 1 left-padded by this many tokens (its pad
# queries see no valid key: dead rows, the mean of v over every key)
MISTRAL_PAD = 3072
# GPT-2's left-padded batch rows: 300 pad tokens (under causal its rows
# 0-299 are dead: rows 256-299 share a 128-row block with live rows)
GPT2_PAD = 300
# packed documents a row in the segment-id cases
K1S_DOCS = 8
# K1's out in phase k1s: K1_TOL_OUT + this · |plain| (one bf16 ulp of an
# output above 4: dropout's 1/keep on a row of a few keys; k1s_case)
K1S_OUT_RTOL = 2.0 ** -7
# (case, shape, causal, modes)
K1S_CASES = (
    ("seg_mistral", "mistral", True, ("seg",)),
    ("seg_gpt2", "gpt2", True, ("seg",)),
    ("seg_cross_gpt2", "gpt2_cross", False, ("seg_cross",)),
    ("alibi_mistral", "mistral", True, ("alibi",)),
    ("alibi_window_mistral", "mistral", True, ("alibi", "window")),
    ("alibi_kv_lens_mistral", "mistral", True, ("alibi", "kv_lens")),
    ("alibi_gpt2", "gpt2", True, ("alibi",)),
    ("alibi_window_gpt2", "gpt2", True, ("alibi", "window")),
    ("alibi_kv_lens_gpt2", "gpt2", True, ("alibi", "kv_lens")),
    ("mask_window_mistral", "mistral_pad", True, ("pad", "window")),
    ("mask_dropout_gpt2", "gpt2", True, ("padding", "dropout")),
    ("seg_dropout_gpt2", "gpt2", True, ("seg", "dropout")),
    ("alibi_dropout_gpt2", "gpt2", True, ("alibi", "dropout")),
    ("mask_dead_rows_gpt2", "gpt2", True, ("lpad",)),
    ("mask_dead_rows_dropout_gpt2", "gpt2", True, ("lpad", "dropout")),
    ("lse_mistral", "mistral", True, ("lse",)),
    ("lse_gpt2", "gpt2", True, ("lse",)),
)
# the kernel-table rows of the new modes: (tags of K1, K3, K4; the
# wrappers' counter of the mode, or "lse"; the modes of its cases; the
# case whose times the row shows; what it ports)
K1S_ROWS = (
    (("1f", "2e", "3e"), "segmented", ("seg", "seg_cross"), "seg_mistral",
     "segment ids (_block_mask :415-416)"),
    (("1g", "2f", "3f"), "alibi", ("alibi",), "alibi_mistral",
     "ALiBi (_block_mask :407-408)"),
    (("1h", "2g", "3g"), "mask_window", ("pad",), "mask_window_mistral",
     "dense mask beside the window (_block_mask :411-412, :417-423)"),
    (("1i", "2h", "3h"), "dropout", ("dropout",), "mask_dropout_gpt2",
     "the general mode with dropout (_dropout_keep :426)"),
    (("1j", "2i", "3i"), "lse", ("lse",), "lse_mistral",
     "flash_fwd_lse, g_lse in delta (:1177-1215, :1061-1062)"),
)


def mode_counts(fa):
    """{wrapper: {counter: launches}} of the attention wrappers' mode
    counters (ops.flash_attention.MODE_COUNTERS)."""
    return {w.__name__: {c: getattr(w, c) for c in fa.MODE_COUNTERS}
            for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                      fa.flash_attention_bwd_dkv)}


def reset_mode_counts(fa):
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        for c in fa.MODE_COUNTERS:
            setattr(w, c, 0)


def alibi_slopes(h):
    """ALiBi's geometric slopes 2^(-8i/h), i = 1 … h, on the card."""
    return torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)],
                        device="cuda")


def packed_docs(gen, b, s):
    """(b, s) int32 ids of K1S_DOCS packed documents a row, the cuts drawn
    from `gen`."""
    cuts = (torch.rand((b, K1S_DOCS - 1), generator=gen, device="cuda")
            * s).long()
    return (torch.arange(s, device="cuda")[None, None]
            >= cuts[..., None]).sum(1).to(torch.int32)


def k1s_inputs(shape, causal, modes, gen):
    """q, k, v, dO and a case's modes as the kernels' wrappers take them,
    drawn from `gen` on the card."""
    b, sq, sk, h, nkv, d = K1S_SHAPES[shape]
    q, do = rand((b, sq, h, d), gen), rand((b, sq, h, d), gen)
    k, v = rand((b, sk, nkv, d), gen), rand((b, sk, nkv, d), gen)
    kw = {"is_causal": causal}
    if "seg" in modes:
        kw["seg_q"] = kw["seg_k"] = packed_docs(gen, b, sq)
    if "seg_cross" in modes:
        kw["seg_q"], kw["seg_k"] = packed_docs(gen, b, sq), \
            packed_docs(gen, b, sk)
        kw["seg_q"][1, 100:103] = K1S_DOCS       # a segment no key has
    if "alibi" in modes:
        kw["alibi_slopes"] = alibi_slopes(h)
    if "window" in modes:
        kw["window"] = K1S_WINDOW[shape]
    if "kv_lens" in modes:
        kw["kv_lens"] = (sk // 2 + (torch.rand(b, generator=gen,
                                               device="cuda")
                                    * (sk // 2 + 1)).long()).clamp(
            max=sk).to(torch.int32)
    if "pad" in modes:               # row 0 full, row 1 left-padded
        m = torch.ones((b, 1, 1, sk), dtype=torch.bool, device="cuda")
        m[1:, ..., :MISTRAL_PAD] = False
        kw["attn_mask"] = m
    if "lpad" in modes:              # row 0 full, the others left-padded
        m = torch.ones((b, 1, 1, sk), dtype=torch.bool, device="cuda")
        m[1:, ..., :GPT2_PAD] = False   # (dead causal rows beside live ones
        kw["attn_mask"] = m             # in one block)
    if "padding" in modes:
        kw["attn_mask"] = k1m_mask("padding", b, h, sq, sk, gen)
    if "dropout" in modes:
        kw.update(dropout_p=DROP_P, key=None)
    return (q, k, v, do), kw


def head_group(kw, h, hs):
    """A case's modes for the query heads `hs` (the slopes' and a per-head
    mask's slices)."""
    out = dict(kw)
    if out.get("alibi_slopes") is not None:
        out["alibi_slopes"] = out["alibi_slopes"][hs]
    m = out.get("attn_mask")
    if m is not None and m.dim() == 4 and m.shape[1] == h:
        out["attn_mask"] = m[:, hs]
    return out


def grouped_plain(fa, q, k, v, kw, out=None, st=None, do=None, g_lse=None):
    """The plain twins one kv-head group at a time (an 8192-row shape's
    fp32 scores take gigabytes a temporary): the forward's (out, stats),
    or, given the kernels' (out, st) and dO, the backward's (dq, dk, dv),
    the groups' pieces joined along the heads. Under dropout in one
    piece: the keep mask hashes the element's index over all heads."""
    h, nkv = q.shape[2], k.shape[2]
    if kw.get("dropout_p", 0.0) > 0.0:
        if do is None:
            return fa.flash_attention_fwd_plain(q, k, v, **kw)
        return fa.flash_attention_bwd_plain(q, k, v, out, st, do, **kw,
                                            g_lse=g_lse)
    rep = h // nkv
    parts = []
    for g in range(nkv):
        hs = slice(g * rep, (g + 1) * rep)
        gkw = head_group(kw, h, hs)
        args = (q[:, :, hs], k[:, :, g:g + 1], v[:, :, g:g + 1])
        if do is None:
            parts.append(fa.flash_attention_fwd_plain(*args, **gkw))
        else:
            parts.append(fa.flash_attention_bwd_plain(
                *args, out[:, :, hs], st[:, hs], do[:, :, hs], **gkw,
                g_lse=None if g_lse is None else g_lse[:, hs]))
    if do is None:
        return torch.cat([p[0] for p in parts], 2), \
            torch.cat([p[1] for p in parts], 1)
    return tuple(torch.cat([p[i] for p in parts], 2) for i in range(3))


def timed(fn):
    """(fn(), its ms by CUDA events around one call)."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return got, ev[0].elapsed_time(ev[1])


def k1s_structure(fa, kw, b, h, sq, sk):
    """(pairs, dead rows, live words' bytes) of a case: the (query, key)
    pairs this run's structure and mask leave over all heads, the count of
    dead rows (a row some key reaches through the structured masks but no
    valid one: its softmax weighs every key), and the bytes of the keep
    words that hold a live pair (visible_word_bytes)."""
    st = fa._structured_mask(sq, sk, kw["is_causal"], kw.get("kv_lens"),
                             None, "cuda", kw.get("window"), kw.get("seg_q"),
                             kw.get("seg_k"))
    if st is None:
        st = torch.ones((1, 1, sq, sk), dtype=torch.bool, device="cuda")
    m = kw.get("attn_mask")
    live = st if m is None else st & fa.dense_mask(m, b, h, sq, sk)
    heads = h if live.shape[1] == 1 else 1
    dead = st.any(-1) & ~live.any(-1)
    n_dead = int(dead.expand(b, live.shape[1], sq).sum().item()) * heads
    pairs = int(live.expand(b, live.shape[1], sq, sk).sum().item()) * heads
    return pairs, n_dead, visible_word_bytes(live, b, h)


def k1s_library(kw, q, k, v, do, h, nkv):
    """torch sdpa's forward and backward device times over the case's
    equivalent dense mask (structured masks, segment ids and the dense
    mask folded into one bool mask) and additive ALiBi bias (then one
    bf16 (b|1, h, sq, sk) bias with -inf off the mask), with its own
    dropout at the case's p."""
    b, sq, _, d = q.shape
    sk = k.shape[1]
    from paddle_tpu_torch.ops import flash_attention as fa
    st = fa._structured_mask(sq, sk, kw["is_causal"], kw.get("kv_lens"),
                             None, "cuda", kw.get("window"), kw.get("seg_q"),
                             kw.get("seg_k"))
    m = kw.get("attn_mask")
    if m is not None:
        dm = fa.dense_mask(m, b, h, sq, sk)
        st = dm if st is None else st & dm
    if kw.get("alibi_slopes") is not None:
        bias = fa._alibi_bias(kw["alibi_slopes"], sq, sk, None,
                              torch.float32)
        st = torch.where(st, bias, float("-inf")).to(torch.bfloat16)
        del bias
    lib_kw = {"attn_mask": st, "dropout_p": kw.get("dropout_p", 0.0)}
    if not any(kw.get(n) is not None for n in (
            "attn_mask", "seg_q", "alibi_slopes", "window", "kv_lens")):
        lib_kw = {"is_causal": kw["is_causal"]}     # flash_fwd_lse's cases
    if nkv != h:
        lib_kw["enable_gqa"] = True
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    with torch.no_grad():
        fwd = device_ms(lambda: sdpa(qt, kt, vt, **lib_kw), iters=5)
    o = sdpa(qt, kt, vt, **lib_kw)
    bwd = device_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=5)
    return fwd, bwd


def k1s_case(fa, fd, nnf, gen, name, shape, causal, modes, bw, flops, iops,
             path):
    """One k1s case. First the main path: the public entry point
    (``nn.functional.flash_attention``, or ``flash_fwd_lse``), forward and
    backward, with every launch count at 0 just before and read just after
    (added to `path`). Then K1, K3 and K4 through their wrappers on the
    same inputs: two launches of each bitwise equal and equal to the entry
    point's bits; K1's out within K1_TOL_OUT of the plain twin and its
    statistics within K1_TOL_LSE (the pairs' m + log l, plus 2^-22·|m|);
    each gradient within K3_TOL · max|plain| of the plain backward on K1's
    (out, statistics); a row no key matches at 0. Then the device times,
    the plain twins' and sdpa's, and each kernel's bound. K1's out is held
    within K1_TOL_OUT + K1S_OUT_RTOL·|plain| (`close`): dropout scales a
    kept probability by 1/keep, and a row that sees a few keys (a short
    document, a causal row near the start) gives |out| near max|v|·1/keep,
    past the 4 K1_TOL_OUT assumes, where one bf16 ulp is 2^-7·|out|."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import dropout as dops
    b, sq, sk, h, nkv, d = K1S_SHAPES[shape]
    (q, k, v, do), kw = k1s_inputs(shape, causal, modes, gen)
    lse_mode = "lse" in modes
    g_lse = rand((b, h, sq), gen, dtype=torch.float32) if lse_mode else None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_counts(fa, fd)
    reset_mode_counts(fa)
    if lse_mode:
        o, lse_e = fa.flash_fwd_lse(*leaves, is_causal=causal)
        torch.autograd.backward([o, lse_e], [do, g_lse])
    else:
        with rng.rng_guard(dropout=drop_key(21)):
            o, _ = nnf.flash_attention(
                *leaves, dropout=kw.get("dropout_p", 0.0), causal=causal,
                attn_mask=kw.get("attn_mask"), kv_lens=kw.get("kv_lens"),
                segment_ids=kw.get("seg_q"),
                kv_segment_ids=kw.get("seg_k") if shape == "gpt2_cross"
                else None, window_size=kw.get("window"),
                alibi_slopes=kw.get("alibi_slopes"))
        o.backward(do)
    torch.cuda.synchronize()
    got = counts(fa, fd)
    got["modes"] = mode_counts(fa)
    path.append(got)
    if "dropout" in modes:   # the draw the entry point took
        kw["key"] = rng.fold_in(drop_key(21), 0)
    wkw = {n: t for n, t in kw.items() if n not in ("dropout_p", "key")
           or "dropout" in modes}
    general = fa._general(kw.get("attn_mask"), kw.get("seg_q"),
                          kw.get("alibi_slopes"))
    if general:
        wkw["bounds"] = fa._call_bounds(
            q, k, kw.get("attn_mask"), causal, kw.get("kv_lens"), None,
            kw.get("window"), kw.get("seg_q"), kw.get("seg_k"),
            kw.get("dropout_p", 0.0))
        res_tiles = tile_counts(wkw["bounds"], b, h, nkv)
    # under dropout the call's keep words (kernel W, every key in the
    # general mode), which K3 and K4 take as FlashAttention hands them
    # over; K1 makes its own, so its time is the whole forward's
    words = None if "dropout" not in modes else dops.attention_keep_words(
        kw["key"], DROP_P, b, h, sq, sk, causal, None, kw.get("kv_lens"),
        kw.get("window"), everything=general, device="cuda")
    bkw = wkw if words is None else dict(wkw, keep_words=words)
    with torch.no_grad():
        out, st = fa.flash_attention_fwd(q, k, v, **wkw)
        out2, st2 = fa.flash_attention_fwd(q, k, v, **wkw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse
    delta = delta.contiguous()
    grads = (fa.flash_attention_bwd_dq(q, k, v, do, st, delta, **bkw),
             *fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **bkw))
    grads2 = (fa.flash_attention_bwd_dq(q, k, v, do, st, delta, **bkw),
              *fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **bkw))
    entry = [o.detach()] + [t.grad for t in leaves]
    res = {"case": name, "shape": shape, "b": b, "sq": sq, "sk": sk,
           "h": h, "nkv": nkv, "d": d, "causal": causal,
           "modes": list(modes), "window": kw.get("window"),
           "general_instantiation": general,
           "two_launches_bitwise": bool(
               torch.equal(out, out2) and torch.equal(st, st2)
               and all(torch.equal(x, y) for x, y in zip(grads, grads2))),
           "entry_point_equals_wrappers": bool(all(
               torch.equal(x, y) for x, y in zip(entry, (out,) + grads))
               and (not lse_mode or torch.equal(lse_e.detach(), st))),
           "entry_point_launches": {n: got[n] for n in (
               "flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "dead_row_sums",
               "attention_keep_words")}}
    if general:
        res["tiles"] = res_tiles
    del out2, st2, grads2, entry, o, leaves
    pkw = {n: t for n, t in wkw.items() if n != "bounds"}
    (ref, ref_st), plain_fwd = timed(lambda: grouped_plain(fa, q, k, v, pkw))
    err, out_ok = close(out, ref, K1_TOL_OUT, K1S_OUT_RTOL)
    if general:
        live = ref_st[..., 1] > float("-inf")
        lerr = ((st.double().sum(-1) - ref_st.double().sum(-1)).abs()
                - 2.0 ** -22 * ref_st[..., 0].double().abs())[live]
        lerr = lerr.max().item() if lerr.numel() else 0.0
        stats_ok = bool(torch.equal(st[~live], ref_st[~live]))
    else:
        lerr = (st - ref_st).abs().max().item()
        stats_ok = True
    res.update(max_abs_err=err, tol=K1_TOL_OUT, rtol=K1S_OUT_RTOL,
               lse_max_abs_err=lerr, lse_tol=K1_TOL_LSE,
               hidden_rows_stats_exact=stats_ok,
               finite=bool(torch.isfinite(out.float()).all()))
    res["ok"] = (out_ok and lerr <= K1_TOL_LSE and stats_ok
                 and res["finite"] and res["two_launches_bitwise"]
                 and res["entry_point_equals_wrappers"])
    if shape == "gpt2_cross":
        res["unmatched_row_zero"] = bool((out[1, 100:103] == 0).all())
        res["ok"] &= res["unmatched_row_zero"]
    del ref, ref_st
    refs, plain_bwd = timed(lambda: grouped_plain(
        fa, q, k, v, pkw, out, st, do, g_lse))
    for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
        e = (g.float() - r).abs().max().item()
        tol = K3_TOL * r.abs().max().item()
        res[gname] = {"max_abs_err": e, "tol": tol}
        res["ok"] &= bool(e <= tol and torch.isfinite(g.float()).all())
    del refs, grads
    gc.collect()
    torch.cuda.empty_cache()
    pairs, n_dead, live_wbytes = k1s_structure(fa, kw, b, h, sq, sk)
    dead_pairs = n_dead * sk
    res.update(pairs=pairs, dead_row_pairs=dead_pairs,
               pairs_of_all=(pairs + dead_pairs) / (b * h * sq * sk),
               dead_rows=n_dead)
    with torch.no_grad():
        ms = {"k1": device_ms(lambda: fa.flash_attention_fwd(
                  q, k, v, **wkw), iters=5),
              "k3": device_ms(lambda: fa.flash_attention_bwd_dq(
                  q, k, v, do, st, delta, **bkw), iters=5),
              "k4": device_ms(lambda: fa.flash_attention_bwd_dkv(
                  q, k, v, do, st, delta, **bkw), iters=5)}
        if words is not None:   # K1 on the given words, and W alone
            k1_alone = device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, keep_words=words, **wkw), iters=5)
            w_ms = device_ms(lambda: dops.attention_keep_words(
                kw["key"], DROP_P, b, h, sq, sk, causal, None,
                kw.get("kv_lens"), kw.get("window"), everything=general,
                device="cuda"), iters=5)
    lib_fwd, lib_bwd = k1s_library(kw, q, k, v, do, h, nkv)
    tq, tk = b * sq * h * d * 2, b * sk * nkv * d * 2
    rows = b * h * sq
    extra = sum(t.numel() * t.element_size() for t in (
        kw.get("attn_mask"), kw.get("seg_q"), kw.get("seg_k"),
        kw.get("kv_lens"), kw.get("alibi_slopes")) if t is not None)
    st_bytes = st.numel() * 4
    # the words K3 and K4 must read: those that hold a live pair, and K4
    # (dv) a dead row's every word
    wbytes = {"k3": 0, "k4": 0} if words is None else {
        "k3": live_wbytes, "k4": live_wbytes + n_dead * -(-sk // 32) * 4}
    nbytes = {"k1": 2 * tq + 2 * tk + extra + st_bytes,
              "k3": 3 * tq + 2 * tk + extra + st_bytes + 4 * rows
              + wbytes["k3"],
              "k4": 2 * tq + 4 * tk + extra + st_bytes + 4 * rows
              + wbytes["k4"]}
    # the k1s masks are bool; dropout hashes every pair the kernel weighs
    # (a dead row's keys for out and dv, not for K3's zero dq); without
    # dropout a dead row is the closed form (no pair's work)
    closed = "dropout" not in modes
    for key, plain, lib in (("k1", plain_fwd, lib_fwd),
                            ("k3", plain_bwd, lib_bwd),
                            ("k4", plain_bwd, lib_bwd)):
        # K3 and K4 read the words: the forward's W hashed them (K1's row)
        hashed = 0 if "dropout" not in modes or key != "k1" else \
            pairs + (dead_pairs if DEAD_KEY_OPS[key] else 0)
        nint = HASH_OPS * hashed
        bound, by = bound3(nbytes[key], attention_ops(
            key, d, pairs, dead_pairs, True, closed), nint, bw, flops, iops)
        bound_pr21, _ = bound3(nbytes[key], attention_ops(
            key, d, pairs, dead_pairs, True), nint, bw, flops, iops)
        res[key] = dict(res.get(key, {}), ms=ms[key], plain_ms=plain,
                        library_ms=lib, bound_ms=bound, bound_by=by,
                        bound_ms_dead_rows_as_pairs=bound_pr21,
                        int32_bound_ms=int32_bound_ms(hashed) if hashed
                        else None, words_read_bytes=wbytes.get(key))
    if words is not None:
        res["k1"].update(k1_alone_ms=k1_alone, keep_words_ms=w_ms)
        res["keep"] = ("k1: kernel W and K1 (the whole forward), k1_alone "
                       "K1 on given words; k3 and k4 read the given "
                       "words")
    res["library_covers"] = (
        "torch sdpa over the case's equivalent dense bool mask (and a bf16 "
        "ALiBi bias with -inf off it; its own dropout at the case's p): k1 "
        "its forward, k3 and k4 its backward (dq, dk, dv)")
    res["plain_covers"] = ("the plain twins one kv-head group at a time: "
                           "k1 the forward, k3 and k4 one backward")
    del q, k, v, do, out, st, delta, words, bkw
    gc.collect()
    torch.cuda.empty_cache()
    return res


# The row sums against their plain version: fp32 sums of the same bf16
# values in another order (up to 4 · 8192 rows), held within this share of
# the largest |plain| (and 1e-6 near 0)
ROW_SUMS_RTOL = 1e-4


def dead_sums_case(fa, gen, bw):
    """The dead rows' row-sum kernel (csrc/attn_rows.cu) at
    train_mistral_pad's attention call (b 2, s 8192, 32/8 heads, d 128,
    row 1 left-padded by MISTRAL_PAD under the window): the mean of v (K1's)
    and dsum, the dead rows' dO summed over each kv head's query heads
    (K4's), each launched twice with the same bits and against its plain
    version; timed beside the plain version, torch.mean (the mean of v in
    one call; dsum has no one-call counterpart) and the bytes' bound."""
    b, sq, sk, h, nkv, d = K1S_SHAPES["mistral_pad"]
    (q, k, v, do), kw = k1s_inputs("mistral_pad", True, ("pad", "window"),
                                   gen)
    bounds = fa._call_bounds(q, k, kw["attn_mask"], True, None, None,
                             kw["window"])
    dead, bits = bounds["dead"], bounds["dead_bits"]
    n_dead = int(dead.expand(b, dead.shape[1], sq).sum().item()) * (
        h // dead.shape[1])
    res = {"b": b, "sq": sq, "sk": sk, "h": h, "nkv": nkv, "d": d,
           "dead_rows": n_dead, "rtol": ROW_SUMS_RTOL}
    calls = {
        "vmean": (lambda: fa.dead_row_sums(v, nkv, 1.0 / sk),
                  lambda: fa.dead_row_sums_plain(v, nkv, 1.0 / sk),
                  lambda: torch.mean(v, 1, dtype=torch.float32),
                  b * sk * nkv * d * 2 + b * nkv * d * 4),
        "dsum": (lambda: fa.dead_row_sums(do, nkv, 1.0, dead, bits),
                 lambda: fa.dead_row_sums_plain(do, nkv, 1.0, dead),
                 None, n_dead * d * 2 + bits.numel() * 8 + b * nkv * d * 4)}
    res["ok"] = True
    for name, (kern, plain, lib, nbytes) in calls.items():
        got, got2, ref = kern(), kern(), plain()
        err = (got - ref).abs().max().item()
        tol = ROW_SUMS_RTOL * ref.abs().max().item() + 1e-6
        bound, by = bound3(nbytes, 0, 0, bw, 1.0, 1.0)
        res[name] = {"max_abs_err": err, "tol": tol,
                     "two_launches_bitwise": bool(torch.equal(got, got2)),
                     "ms": device_ms(kern, iters=20),
                     "plain_ms": time_ms(plain, iters=3, warmup=1),
                     "library_ms": None if lib is None
                     else device_ms(lib, iters=20),
                     "bound_ms": bound, "bound_by": by}
        if lib is None:
            res[name]["library_covers"] = "none: no one PyTorch call sums "\
                "the rows a bit mask selects"
        res["ok"] &= err <= tol and res[name]["two_launches_bitwise"]
    emit({"phase": "dead_row_sums", **res})
    return res


def dead_sums_row(res, k1s_launches, pad_launches):
    """The row of the dead rows' row-sum kernel: its times at
    train_mistral_pad's call (the mean of v; dsum beside it), its launches
    on paths k1s and train_mistral_pad."""
    by_path = {"k1s": k1s_launches["dead_row_sums"],
               "train_mistral_pad": pad_launches["dead_row_sums"]}
    t = res["vmean"]
    return {"name": "dead_row_sums", "row": "R", "route": "cuda",
            "mode": "the general mode's dead rows off the walk",
            "source": "paddle_tpu_torch/csrc/attn_rows.cu",
            "replaces": "none: the closed form of a dead row (_xla_attention's "
                        "uniform softmax, paddle_tpu/ops/flash_attention.py"
                        ":99-141), which K1 and K4 read",
            "launches": sum(by_path.values()),
            "max_abs_err": max(res["vmean"]["max_abs_err"],
                               res["dsum"]["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "per": f"the mean of v at train_mistral_pad's call: b {res['b']},"
                   f" s {res['sk']}, {res['nkv']} kv heads, d {res['d']}",
            "dsum": res["dsum"], "launches_by_path": by_path}


def phase_k1s(fa, fd, bw, flops, iops):
    """The rest of flash attention on the card (see the module docstring,
    phase 8m): K1S_CASES through the public entry points and against the
    plain twins; the general mode's dropout mask read back exactly at
    GPT-2's shape; the modifiers at kernel d 256 refused. Returns (cases,
    the main path's launches summed over the cases' entry-point runs)."""
    from paddle_tpu_torch.nn import functional as nnf
    from paddle_tpu_torch.ops import dropout as dops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    cases, path = [], []
    for name, shape, causal, modes in K1S_CASES:
        cases.append(k1s_case(fa, fd, nnf, gen, name, shape, causal, modes,
                              bw, flops, iops, path))
        emit({"phase": "k1s_case", **cases[-1]})
    launches = {n: sum(p[n] for p in path) for n in path[0]
                if n != "modes"}
    launches["modes"] = {w: {c: sum(p["modes"][w][c] for p in path)
                             for c in fa.MODE_COUNTERS}
                         for w in path[0]["modes"]}
    b, sq, _, h, nkv, d = K1S_SHAPES["gpt2"]
    probe, _ = k1_mask_probe(fa, dops, b, h, nkv, sq, sq, d, True,
                             [sq, sq // 2 + 7] * (b // 2), general=True)
    refused = d256_mode_refusals(fa)
    sums = dead_sums_case(fa, gen, bw)
    emit({"phase": "k1s", "cases": [c["case"] for c in cases],
          "launches": launches, "general_dropout_mask_probe": probe,
          "d256_refused": refused})
    bad = ([c["case"] for c in cases if not c["ok"]]
           + ([] if probe["ok"] else ["the general mode's dropout mask"])
           + ([] if sums["ok"] else ["the dead rows' row sums"])
           + [f"d256 {m} ran or raised otherwise: {e}"
              for m, e in refused.items()
              if not (e and "Queue B rows 1-3" in e)])
    modes = launches["modes"]["flash_attention_fwd"]
    if not all(launches[n] > 0 and modes["general"] > 0 for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "dead_row_sums")):
        bad.append(f"the kernels were not launched on the path: {launches}")
    if bad:
        raise AssertionError(f"phase k1s: {bad}")
    return cases, launches, sums


def d256_mode_refusals(fa):
    """{mode: the NotImplementedError's message, or None where it ran} of
    the dispatch at head dim 256 with each of the general mode's
    modifiers (ROADMAP Queue B rows 1-3)."""
    q = torch.zeros((1, 64, 2, 256), dtype=torch.bfloat16, device="cuda")
    m = torch.ones((1, 1, 1, 64), dtype=torch.bool, device="cuda")
    out = {}
    for mode, kw in (
            ("segment_ids", dict(is_causal=True, segment_ids=torch.zeros(
                (1, 64), dtype=torch.int32, device="cuda"))),
            ("alibi", dict(is_causal=True, alibi_slopes=alibi_slopes(2))),
            ("mask_window", dict(is_causal=True, attn_mask=m,
                                 window_size=16)),
            ("mask_dropout", dict(attn_mask=m, dropout_p=0.1))):
        try:
            fa.scaled_dot_product_attention(q, q, q, **kw)
            out[mode] = None
        except NotImplementedError as e:
            out[mode] = str(e)
    return out


def k1s_rows(cases, k1s_launches, pad_launches):
    """Rows 1f–1j, 2e–2i, 3e–3i (K1, K3, K4's new modes): each row's
    launches on paths k1s and train_mistral_pad (its mode's counter; the
    lse rows the plain instantiations' launches of the lse cases), the
    largest error over its cases, and the times, bounds, plain and sdpa
    times of its main case, every case of the mode beside them."""
    rows = []
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    for tags, counter, case_modes, main_name, what in K1S_ROWS:
        main = next(c for c in cases if c["case"] == main_name)
        mine = [c for c in cases if set(case_modes) & set(c["modes"])]
        for name, key, tag, line, fn in zip(
                names, ("k1", "k3", "k4"), tags, (526, 668, 787),
                ("_fwd_kernels", "_bwd_dq_kernel", "_bwd_dkv_kernel")):
            def on(launches):
                if counter == "lse":
                    return launches[name] - launches["modes"][name]["general"]
                return launches["modes"][name][counter]
            by_path = {"k1s": on(k1s_launches),
                       "train_mistral_pad": on(pad_launches)}
            err = max(c["max_abs_err"] if key == "k1"
                      else c["dq"]["max_abs_err"] if key == "k3"
                      else max(c["dk"]["max_abs_err"], c["dv"]["max_abs_err"])
                      for c in mine)
            t = main[key]
            rows.append({
                "name": name, "row": tag, "mode": what, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/" + (
                    "flash_attention.cu" if key == "k1"
                    else "flash_attention_bwd.cu"),
                "replaces": f"paddle_tpu/ops/flash_attention.py:{line} "
                            f"({fn}, {what})",
                "launches": sum(by_path.values()), "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "int32_bound_ms": t.get("int32_bound_ms"),
                "library_ms": t["library_ms"],
                "per": f"one call at {main_name}: b {main['b']}, h "
                       f"{main['h']}/{main['nkv']}, s {main['sq']}, d "
                       f"{main['d']}",
                "launches_by_path": by_path,
                "at_cases": [dict(c[key], case=c["case"]) for c in mine]})
    return rows


# train_mistral_pad's depth: Mistral-7B's 32 layers. train_mistral's b 1
# run peaks at 61.4 GB: 57.9 GB of bf16 weights, gradients and both AdamW
# moments, ≈ 3.5 GB of activations at S 8192 under full recompute. b 2
# doubles the activations, ≈ 65 GB in all, under the card's 80 GB
MISTRAL_PAD_LAYERS = 32


def mistral_pad_batch(cfg, b, s, ignore_index):
    """train_bench's batch (ids from RandomState(0)) at (b, s) with row 1
    left-padded by MISTRAL_PAD tokens (pad id 0), its pad labels at the
    loss's ignore_index, and the (b, 1, 1, s) bool mask hiding its pad
    keys."""
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    x, y = ids[:, :-1].clone(), ids[:, 1:].clone()
    x[1:, :MISTRAL_PAD] = 0
    y[1:, :MISTRAL_PAD] = ignore_index
    mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device="cuda")
    mask[1:, ..., :MISTRAL_PAD] = False
    return x, y, mask


def mistral_pad_grad_check(fa, fd, cfg, b, s):
    """train_mistral_pad's model cut to 2 layers (the same width, window,
    recompute and loss chunks), its loss and every gradient on the padded
    batch through the kernels (the general instantiations, counted) and
    through the plain twins on the card (one kv-head group at a time),
    both bf16 from the same weights: the loss within STEP_LOSS_ATOL, each
    gradient within STEP_GRAD_RTOL (relative L2), as phase llama_step
    holds TinyLlama's."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    c2 = dataclasses.replace(cfg, num_layers=2)
    model = LlamaForCausalLM(c2, dtype=torch.bfloat16, device="cuda", seed=0)
    x, y, mask = mistral_pad_batch(
        c2, b, s, getattr(model.loss_fn, "ignore_index", -100))

    def grads():
        loss = model.train_loss(x, y, mask)
        loss.backward()
        got = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        return loss.item(), got
    reset_counts(fa, fd)
    reset_mode_counts(fa)
    loss, g = grads()
    launched = counts(fa, fd)
    mw = {w: m["mask_window"] for w, m in mode_counts(fa).items()}
    with PlainKernelsOnCard(fa):
        loss_p, g_p = grads()
    err = {n: ((g[n].float() - r.float()).norm() / r.float().norm()).item()
           for n, r in g_p.items()}
    worst = max(err, key=err.get)
    want = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 2,
            "flash_attention_bwd_dkv": 2}
    res = {"layers": 2, "loss": loss, "loss_plain_twins": loss_p,
           "loss_abs_err": abs(loss - loss_p), "loss_atol": STEP_LOSS_ATOL,
           "grad_rel_err_max": err[worst], "grad_rel_err_worst_param": worst,
           "grad_rel_err_by_param": err, "grad_rel_tol": STEP_GRAD_RTOL,
           "mask_window_launches": mw}
    res["ok"] = (abs(loss - loss_p) <= STEP_LOSS_ATOL
                 and err[worst] <= STEP_GRAD_RTOL and math.isfinite(loss)
                 and all(launched[n] == want[n] == mw[n]
                         for n in want))
    del model, g, g_p
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_train_mistral_pad(fa, fd, flops):
    """Mistral-7B (`LlamaConfig.mistral_7b()`: h 4096, 32/8 heads, d 128,
    window 4096) at MISTRAL_PAD_LAYERS layers on a padded batch: b 2,
    S 8192, row 1 left-padded by MISTRAL_PAD tokens (pad labels at the
    loss's ignore_index, a (b, 1, 1, S) bool mask), `train_loss(x, y,
    attn_mask)` under full recompute and 8 loss chunks, pure-bf16
    AdamW(1e-4): 1 warm-up and 3 counted steps (CUDA events), every launch
    count at 0 just before the counted steps and read just after: K1
    twice a layer a step, K3 and K4 once, all on the general
    instantiations with the mask beside the window, no plain attention
    call; the loss finite and falling; step ms, tokens/s over the real
    tokens, MFU (dense-6N basis over the real tokens), peak memory and a
    traced step by kernel family. Then the 2-layer gradient check
    (`mistral_pad_grad_check`)."""
    from paddle_tpu_torch import train_bench
    from paddle_tpu_torch.bench import flops_per_token
    from paddle_tpu_torch.models import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.mistral_7b(),
                              num_layers=MISTRAL_PAD_LAYERS, recompute=True,
                              recompute_granularity="full", loss_seq_chunks=8)
    b, s = K1S_SHAPES["mistral_pad"][:2]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, _, _ = train_bench.build(cfg, b, s, "cuda")
    x, y, mask = mistral_pad_batch(
        cfg, b, s, getattr(model.loss_fn, "ignore_index", -100))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params()
    step = lambda: train_bench.train_step(model, opt, x, y, mask)
    with PlainTraining(fa) as plain:
        losses = [float(step())]
        reset_counts(fa, fd)
        reset_mode_counts(fa)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        counted = [float(step()) for _ in range(3)]
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(fa, fd)
        launches["modes"] = mode_counts(fa)
        peak = torch.cuda.max_memory_allocated()
        trace = traced_step(step, reps=1)
    reset_counts(fa, fd)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = ev[0].elapsed_time(ev[1]) / 3
    real = int(mask.sum().item())
    tok_s = real / step_ms * 1e3
    fpt = flops_per_token(cfg, n_params, s)
    L = cfg.num_layers
    res = {"phase": "train_mistral_pad", "model": "mistral_7b", "layers": L,
           "hidden": cfg.hidden_size, "heads": cfg.num_heads,
           "kv_heads": cfg.kv_heads, "window": cfg.sliding_window,
           "params": n_params, "batch": b, "seq": s, "left_pad": MISTRAL_PAD,
           "mask": "(b, 1, 1, s) bool", "real_tokens_a_step": real,
           "recompute_granularity": "full", "loss_seq_chunks": 8,
           "optimizer": "AdamW(1e-4, multi_precision=False)",
           "init_s": init_s, "warmup_steps": 1, "steps": 3,
           "step_ms": step_ms, "wall_step_ms": wall * 1e3 / 3,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": tok_s * fpt / flops,
           "mfu_basis": "dense_6n + 12·L·h·S a real token",
           "peak_memory_gb": peak / 1e9, "losses": losses + counted,
           "launches": launches, "plain_attention_calls": plain.n,
           "step_trace": trace, "device_idle_share": None if trace is None
           else 1 - trace["busy_ms"] / step_ms}
    res["grad_check_2_layers"] = mistral_pad_grad_check(fa, fd, cfg, b, s)
    emit(res)
    n = 3 * L
    want = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n}
    bad = []
    for w, k in want.items():
        m = launches["modes"][w]
        if not launches[w] == k == m["general"] == m["mask_window"]:
            bad.append(f"{w}: {launches[w]} launches, {m}, expected {k} "
                       "on the general instantiation with the mask and the "
                       "window")
    if plain.n:
        bad.append(f"{plain.n} plain attention calls")
    # the dead rows' sums: one mean of v a K1 launch, one dsum a K4 launch
    if launches["dead_row_sums"] != 3 * n:
        bad.append(f"dead_row_sums: {launches['dead_row_sums']} launches, "
                   f"expected {3 * n} (one a K1 and a K4 launch)")
    if not all(math.isfinite(v) for v in counted) or \
            not counted[-1] < counted[0]:
        bad.append(f"loss not finite or not falling: {counted}")
    if not res["grad_check_2_layers"]["ok"]:
        bad.append("the 2-layer loss or gradients off the plain twins")
    if bad:
        raise AssertionError("train_mistral_pad: " + "; ".join(bad))
    return res


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    quick = "--quick" in argv
    # a stalled phase (a kernel that never completes leaves the host in a
    # synchronize) prints every thread's Python stack and exits non-zero
    # inside the run's budget; a SIGABRT from outside does the same
    faulthandler.enable()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops import rope

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_line, kind, bw, flops = card()
    iops = int_ops_per_s()
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_by_source": dict(_build.build_seconds),
          "libraries": sorted(_build._libs)})
    try:   # a measurement for the bounds: they read None without it
        keep_words_sass_mix()
    except Exception as e:
        emit({"phase": "keep_words_sass", "error": repr(e)})
    if "--int8-stress" in argv:
        phase_int8_stress(fd, rope)
        return 0
    if "--bwd-times" in argv:
        phase_bwd_times(fa)
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if "--training" in argv:
        phase_k3w(fa, gen, bw, flops)
        phase_llama_step(fa, fd)
        phase_train_llama(fa, fd, flops)
        phase_train_mistral(fa, fd, flops)
        return 0
    if "--k1d" in argv:
        print(json.dumps({"kernels": [phase_dropout(bw, flops, iops)] + list(
            phase_k1d(fa, bw, flops, iops).values())}), flush=True)
        return 0
    if "--dropout" in argv:
        rows = dropout_rows(phase_dropout(bw, flops, iops),
                            phase_k1d(fa, bw, flops, iops),
                            phase_train_dropout(fa, fd, flops))
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if "--moe" in argv:
        k6_errs = phase_k6(fd, rope, gen)
        row, _, row8, _ = phase_moe(fa, fd, bw, flops, *k6_errs)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_moe(fa, fd, flops)
        print(json.dumps({"kernels": [row, row8]}), flush=True)
        return 0
    if "--ernie" in argv:
        rows = mask_rows(phase_k1m(fa, bw, flops, iops), phase_ernie(fa, fd))
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if "--k1m" in argv:
        phase_k1m(fa, bw, flops, iops)
        return 0
    if "--k1s" in argv:
        phase_k1s(fa, fd, bw, flops, iops)
        return 0
    if "--modes" in argv:
        cases, k1s_launches, sums = phase_k1s(fa, fd, bw, flops, iops)
        pad = phase_train_mistral_pad(fa, fd, flops)
        rows = k1s_rows(cases, k1s_launches, pad["launches"])
        rows.append(dead_sums_row(sums, k1s_launches, pad["launches"]))
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if "--unet" in argv:
        shapes, d256_err = phase_k1h(fa, bw, flops)
        bwd_shapes, bwd_errs = phase_k3h(fa, bw, flops)
        rows = unet_rows(shapes, d256_err, phase_unet(fa, fd, flops))
        train_unet = phase_train_unet(fa, fd, flops)
        rows += k3h_rows(bwd_shapes, bwd_errs, train_unet)
        for row in rows:
            row["launches_by_path"]["train_unet"] = train_unet_launches(
                row, train_unet)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    k1_err = phase_k1(fa, gen)
    k1w_err = phase_k1w(fa, fd, gen)
    k2_err = phase_k2(fd, rope, gen)
    k3_errs = phase_k3(fa, gen)
    k3w_errs, k3w_path = phase_k3w(fa, gen, bw, flops)
    k5q_errs, k7q_errs = {}, {}     # the int8 modes' errors (rows 6, 7)
    k5_err = phase_k5(fd, rope, gen, k5q_errs)
    k7_err = phase_k7(fd, rope, gen, k7q_errs)
    k6_errs = phase_k6(fd, rope, gen)
    phase_wide(fa, fd)
    gpt_errs = {"k2g": phase_k2g(fd, rope, gen),
                "k5g": phase_k5g(fd, rope, gen, k5q_errs),
                "k7g": phase_k7g(fd, rope, gen, k7q_errs)}
    k2q_errs = phase_k2q(fd, rope, gen)
    phase_int8_stress(fd, rope)
    k8_row = phase_k8(gen, bw)
    k9_row = phase_k9(fd, bw)
    drop_row = phase_dropout(bw, flops, iops)
    k1d_rows = phase_k1d(fa, bw, flops, iops)
    k1h_shapes, k1h_err = phase_k1h(fa, bw, flops)
    k3h_shapes, k3h_errs = phase_k3h(fa, bw, flops)
    k1m_cases = phase_k1m(fa, bw, flops, iops)
    k1s_cases, k1s_launches, k1s_sums = phase_k1s(fa, fd, bw, flops, iops)
    if quick:
        return 0
    model, plan, kv, launches, int8kv_launches = phase_e2e(fa, fd)
    with torch.inference_mode():   # kv is an inference tensor
        kernels = phase_timing(fa, fd, model, plan, kv, bw, flops, launches,
                               k1_err, k2_err)
    del plan, kv
    gc.collect()
    with torch.no_grad():
        k5_row, serve_launches = phase_serve(fa, fd, model, bw, flops, k5_err)
        gc.collect()
        k5_row["b32"], serve32_launches = phase_serve32(fa, fd, model, bw,
                                                        flops)
        gc.collect()
        k7_row, spec_launches = phase_spec(fa, fd, model, bw, flops, k7_err)
        gc.collect()
        int8_pool_runs = phase_int8_pool(fa, fd, model, bw, flops)
        gc.collect()
        int8_timing, int8_runs = phase_int8(fa, fd, model, bw, flops)
        int8_launches = int8_runs["int8"]
        gc.collect()
        paged_int8, int8_serve_launches = phase_int8_serve(
            fa, fd, model, bw, flops, k5q_errs, k7q_errs)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gpt_rows, gpt_launches, gpt_int8_runs = phase_gpt(fa, fd, bw, flops,
                                                      gpt_errs)
    k6_row, moe_launches, k6q_row, moe_int8_launches = phase_moe(
        fa, fd, bw, flops, *k6_errs)
    gc.collect()
    torch.cuda.empty_cache()
    train_moe = phase_train_moe(fa, fd, flops)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train(fa, fd, flops)
    phase_step(fa, fd)
    kernels = phase_timing_train(fa, bw, flops, kernels, train_launches,
                                 k3_errs)
    gc.collect()
    torch.cuda.empty_cache()
    train_drop = phase_train_dropout(fa, fd, flops)
    gc.collect()
    torch.cuda.empty_cache()
    window_row, mistral_launches = phase_mistral(fa, fd, bw, flops, k1w_err)
    gc.collect()
    torch.cuda.empty_cache()
    phase_llama_step(fa, fd)
    llama_train = phase_train_llama(fa, fd, flops)
    mistral_train = phase_train_mistral(fa, fd, flops)
    gc.collect()
    torch.cuda.empty_cache()
    pad_launches = phase_train_mistral_pad(fa, fd, flops)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    unet_launches = phase_unet(fa, fd, flops)
    gc.collect()
    torch.cuda.empty_cache()
    train_unet = phase_train_unet(fa, fd, flops)
    gc.collect()
    torch.cuda.empty_cache()
    ernie = phase_ernie(fa, fd)
    # row 4's int8 sub-rows: the modes' timings and their plain-version
    # errors (phase k2q); launches on the runs that drive each mode
    k2 = kernels[1]
    k2["int8"].update(int8_timing)
    k2["int8"].update(gpt_rows["fused_decode_step"].pop("int8"))
    mode_launches = {
        "llama_int8w_int8kv": int8_launches["fused_decode_step"],
        "llama_int8w": int8_runs["bf16"]["fused_decode_step"],
        "llama_int8kv": int8kv_launches["fused_decode_step"]}
    for mode, row in k2["int8"].items():
        row["max_abs_err"] = k2q_errs[mode]
        row.setdefault("launches", mode_launches.get(mode))
    # rows 6 and 7's int8 sub-rows (a–d): int8_serve's runs, the bf16
    # model's int8-pool runs and GPT-2's
    add_mode_rows(paged_int8, int8_pool_runs, "int8_pool", k5q_errs,
                  k7q_errs)
    add_mode_rows(paged_int8, gpt_int8_runs, "gpt_int8_pool", k5q_errs,
                  k7q_errs)
    k5_row["int8"] = paged_int8["fused_paged_decode_step"]
    k7_row["int8"] = paged_int8["fused_paged_verify_step"]
    int8_pool_launches = run_launches(int8_pool_runs)
    for row in (k8_row, k9_row):
        row["launches"] = int8_launches[row["name"]]
        row["launches_by_path"] = {
            "generate": launches[row["name"]],
            "train": train_launches[row["name"]]}
    kernels += [k5_row, k7_row, k6_row, k8_row, k9_row]
    for k in kernels:
        k.setdefault("launches_by_path", {"generate": 0, "train": 0})
        k["launches_by_path"]["generate_int8kv"] = int8kv_launches[k["name"]]
        k["launches_by_path"]["int8_generate"] = int8_launches[k["name"]]
        k["launches_by_path"]["serve"] = serve_launches[k["name"]]
        k["launches_by_path"]["serve32"] = serve32_launches[k["name"]]
        k["launches_by_path"]["spec"] = spec_launches[k["name"]]
        k["launches_by_path"]["int8_pool"] = int8_pool_launches[k["name"]]
        k["launches_by_path"]["int8_serve"] = int8_serve_launches[k["name"]]
        k["launches_by_path"]["moe"] = moe_launches[k["name"]]
        k["launches_by_path"]["moe_int8"] = moe_int8_launches[k["name"]]
        k["launches_by_path"]["train_moe"] = train_moe["launches"][k["name"]]
        k["launches_by_path"]["mistral"] = mistral_launches[k["name"]]
        k["launches_by_path"]["train_llama"] = \
            llama_train["launches"][k["name"]]
        k["launches_by_path"]["train_mistral"] = \
            mistral_train["launches"][k["name"]]
        k["launches_by_path"]["unet"] = unet_launches[k["name"]]
        for path, got in gpt_launches.items():
            k["launches_by_path"][path] = got[k["name"]]
        if k["name"] in gpt_rows:
            k["gpt"] = gpt_rows[k["name"]]
    # row 1a: K1's window mode, launched on paths mistral and train_mistral
    windowed = mistral_train["windowed_launches"]
    window_row["launches_by_path"] = {
        "mistral": window_row["launches"],
        "train_mistral": windowed["flash_attention_fwd"],
        "train_llama": llama_train["windowed_launches"]["flash_attention_fwd"]}
    kernels[0]["window"] = window_row
    # rows 2a and 3a: K3's and K4's window modes (phase k3w at the
    # train_mistral path's shape), launched on path train_mistral
    layer0 = mistral_train["layer0_attention_grads"]
    for row, key, err, line, where in (
            (kernels[2], "k3", max(k3w_errs[0], max(
                layer0["dq_max_abs_err_by_group"])), 668,
             "_window_k0 :465, :749"),
            (kernels[3], "k4", max(k3w_errs[1], max(
                layer0["dk_max_abs_err_by_group"]
                + layer0["dv_max_abs_err_by_group"])), 787,
             "query range :884-891")):
        t = k3w_path["kernels"][key]
        row["window"] = {
            "name": row["name"], "mode": "causal sliding window",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/flash_attention.py:{line} "
                        f"(window: {where})",
            "launches": windowed[row["name"]], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launches_by_path": {
                "train_mistral": windowed[row["name"]],
                "train_llama": llama_train["windowed_launches"][row["name"]]},
            "at_path": dict(t, shape_b_s_h_nkv_d=k3w_path["shape_b_s_h_nkv_d"],
                            window=k3w_path["window"])}
    for k in kernels:
        k["launches_by_path"]["train_dropout"] = \
            train_drop["launches"][k["name"]]
    # rows 1b, 2b, 3b (K1, K3, K4's dropout modes) and the hidden-dropout
    # kernel, launched on path train_dropout
    kernels += dropout_rows(drop_row, k1d_rows, train_drop)
    # row 5a: K6's int8 KV mode, launched on path moe_int8
    kernels.append(k6q_row)
    # rows 1c, 1d: K1 at head dim 256 and the padded head dims, launched
    # on path unet
    kernels += unet_rows(k1h_shapes, k1h_err, unet_launches)
    # rows 2c, 3c: K3, K4 at head dim 256, launched on path train_unet;
    # every row's launches there
    kernels += k3h_rows(k3h_shapes, k3h_errs, train_unet)
    for k in kernels:
        k["launches_by_path"]["train_unet"] = train_unet_launches(
            k, train_unet)
    # rows 1e, 2d, 3d: the mask modes, launched on path ernie; every
    # other row's launches there (the Titan twin's K1, K3, K4 without a
    # mask)
    for k in kernels:
        k["launches_by_path"]["ernie"] = 0 if "mode" in k else \
            ernie["all"].get(k["name"], 0) - ernie["masked"].get(k["name"], 0)
    kernels += mask_rows(k1m_cases, ernie)
    # paths k1s and train_mistral_pad: the plain instantiations' launches
    # (flash_fwd_lse's cases) on rows 1, 2, 3, the mask rows' (1e, 2d, 3d:
    # the general instantiations, with a mask) on theirs; then rows 1f–1j,
    # 2e–2i, 3e–3i
    for k in kernels:
        for path, got in (("k1s", k1s_launches),
                          ("train_mistral_pad", pad_launches)):
            modes = got["modes"].get(k["name"])
            if modes is None:
                k["launches_by_path"][path] = 0 if "mode" in k else \
                    got[k["name"]]
            elif "mode" in k:
                k["launches_by_path"][path] = modes["masked"] \
                    if k["mode"].startswith("dense attn_mask") else 0
            else:
                k["launches_by_path"][path] = got[k["name"]] - \
                    modes["general"]
    kernels += k1s_rows(k1s_cases, k1s_launches, pad_launches)
    # row R: the dead rows' row sums, launched on paths k1s and
    # train_mistral_pad
    kernels.append(dead_sums_row(k1s_sums, k1s_launches, pad_launches))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    rc = main(sys.argv[1:])
    faulthandler.cancel_dump_traceback_later()
    sys.exit(rc)
