#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths (and, in phases 8d to 8g, the plan's
streaming entry points, the clustering engine, the RPC server and the
sharded backend on the first; in phases 14b to 14e the LM variants:
decode over KV codebooks built by fastkmeans++, MLA and MoE; in phases
15a to 15d the rest of the model stack: RWKV-6, Mamba, the vlm prefix and
the audio inputs; in phase 16 training: the backward kernel of row 8 and
olmo-1b trained at full width and depth, then the `Trainer`'s kill and
resume, olmo-1b trained in bf16 under remat "dots", and the compressed
data-parallel step and the pipeline schedule on a one-rank NCCL group;
in phase 17 the port's copies of the four examples and the dry run's
count of a training step).  Two go through the plan, each at the shape
of the paper's smallest real dataset (KDD Cup, 311,029 x 74, generated
here from a seed as `benchmarks/datasets.py` does) with k = 1000: the
paper's Algorithm 4,
`ClusterPlan(ClusterSpec(k=1000, seeder="rejection"),
ExecutionSpec(backend="device")).fit(points)`, and the k-means|| baseline,
the same with `seeder="kmeans||"` (5 rounds, ell = 2k, 8,000 center slots
per round).  The third is LM serving: yi-9b at full width and depth
(48 layers, d_model 4096, 32 query heads over 4 KV heads of 128, random
bf16 weights from a seed) through `Engine(params, cfg, ServeConfig(
max_new_tokens=32, max_seq=2088)).generate` on 4 prompts of 2,048 tokens.
It builds every CUDA kernel from `src/repro_torch/csrc/` and holds each
against its plain PyTorch version on the card.  In order:

  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
  2. the kernel build (five sources, in parallel): time, registers and
     spills from `ptxas -v`;
  3. each kernel against its plain version at the paths' shapes: the tree
     sweeps bit-identical at n = 311,029, their tile sums,
     `lsh_bucket_accept` and `lsh_bucket_min` to rtol 1e-5 over B in
     32..512 and 0..1000 live centers (`LSH_MISS` lanes exactly, a second
     launch bit-identical); the sweeps and the accept in the call form a
     fit launches (one lane of the lane axis), the solo call forms held
     bit for bit to it,
     `pairwise_argmin` at 311,029 x 8,000 x 74 (one k-means|| round's
     slots; the sweep over its live slots bit-identical to the full one;
     every slot live in f32 and bf16) and at a ragged small shape in f32
     and bf16, `d2_update` and `d2_update_tiles` at n = 311,029 (the
     tiles entry on the unpadded rows; a second launch bit-identical);
  4. each kernel's time (CUDA events) beside its plain version's, a
     PyTorch library call's where one computes the same function, and the
     least time the card could take for the same work; the kernels of a
     few microseconds are timed as a CUDA graph of their launches (the
     card's time; a loop of launches from Python times the host) with the
     loop's time beside, the sweeps and the accept in a fit's one-lane
     call form, `lsh_bucket_accept` at the path's most used block
     and at B = 32; `pairwise_argmin` (a) in f32 with all 8,000 slots live
     (its row), (b) as the path launches it, over one round's live slots,
     and (c) on the bf16 route at (a)'s shape, its bound the work at f32
     accuracy on the tensor cores (3xTF32 at 495 TFLOP/s; bf16 at 989);
     `d2_update` and `d2_update_tiles` also at the paper's other shapes
     (song 515,345 x 90 and census 2,458,285 x 68 in f32) and at KDD Cup's
     in bf16, each checked first;
  5. the paths: `fit` and `refit(seed=1)` of each, with the launch counts
     set to 0 just before and read just after (Algorithm 4: 2k, k and at
     least k - 1 launches; k-means||: exactly 5 `pairwise_argmin`), then
     Algorithm 3 on the rejection plan's prepared data, and the k-means||
     rounds timed apart from the host recluster on the fit's own seed (a
     replay: the same indices);
  6. the result against references: a replay of the rejection fit's
     centers through the plain versions on the card, and both seeders on
     the card against the port on the CPU at a small size (64-seed mean
     costs within 5%);
  7. quality in float64 against exact k-means++ and uniform seeding
     (information only);
  8. the device's idle share over Algorithm 4's `refit(seed=1)` again,
     traced with `torch.profiler`, beside the untraced one, with
     `lsh_bucket_accept`'s mean time per launch on the path beside its
     timed one, and the same launch traced alone between idle gaps;
 8b to 8g run at k = `KS` (100), their depth cut from k = 1000 for time
     (PERF.md section 4 lists the cuts), but for 8g's gated sharded
     rejection fits; their references are phase 8's plans at that k over
     phase 8's prepared data (the fit's draws, and refit(seed=1)), so no
     phase re-prepares `kddcup_shaped(0)` for them;
 8b. the plan's other entry points on the same data: the legacy
     `fit(points, KMeansConfig(seeder=...))` of the three device seeders,
     each with the same indices as `ClusterPlan.fit` on the same seed and
     its launch counts; `fit_batch(seeds=[0, 1, 2, 3])` on the rejection
     and the fastkmeans++ plans, each one lane-batched solve (2k
     `tree_sep_update` and k `tree_sep_update_tiles` launches for the four
     lanes; `lsh_bucket_accept` between the largest lane's refit count
     and the four refits' sum), each lane bit-identical to `refit(seed=s)`
     and lane 0 to the fit, its time beside the four refits';
     `no_retrace()` around one more refit;
 8c. stacked lanes: `fit_batch(datasets=...)` of the rejection seeder at
     full width on `kddcup_shaped(0)`, `kddcup_shaped(1)` and the first
     150,000 rows of `kddcup_shaped(2)` (two shape buckets, 524,288 and
     262,144 rows), the canonical prepares and the solve timed, its
     launches (one solve a bucket), each lane bit-identical to its
     one-lane stacked fit, with indices below its row count and its cost
     in original coordinates; then the lane axis of the three kernels at
     B = 4 lanes of that bucket (H = 12, d = 74) with per-lane and shared
     (stride-0) codes, against their plain versions and, lane by lane,
     the solo launch bit for bit, and at B = 1 against the plain
     versions, and their times as CUDA graphs
     beside the bound from the bytes (shared codes read once); and the
     cpu backend's six NumPy seeders on the host at n = 31,102 (the first
     tenth of the rows), their host times and float64 cost ratios to
     exact k-means++ (information only);
 8d. streaming at full width on `kddcup_shaped(0)`, k = `KS`, through the
     device backend: `prepare_streaming` of the first 200,000 rows
     (capacity 262,144), `extend` of the other 111,029 in batches of
     10,000 (capacity 524,288), `retire` of 31,102 rows drawn from a
     seed, each timed; the patched `w0` exactly m_init on the live rows
     and 0 elsewhere, the patched heap `ts.init(w0)` bit for bit;
     `fit_prepared(seed=1)` with the launch counts set to 0 just before
     and read just after (2k, k and at least k - 1 launches), its indices
     live and distinct, its masked cost within 1e-4 of float64 over the
     live rows, a replay of its centers from `w0` through the kernels and
     the plain sweeps (the same weights), seed 1 again (the same indices;
     not repeated after the rebuild below, a cut for time); extend then
     retire of the same 10,000 rows (`w0` and the
     heap back bit for bit); an extend of 1,000 rows out of the frozen
     domain (one rebuild) and the same checks again; scratch equivalence,
     the first 200,000 rows then 50,000 duplicates of them against all
     250,000 at once (artifacts and the refit's indices bit-identical);
     and a fastkmeans++ stream with the same history, its refit's
     launches and checks;
 8e. the clustering engine at full width: `ClusterEngine(prepare_workers=
     2)` on `kddcup_shaped(0)` and `(1)` at seeds 0 and 1, each ticket
     bit-identical to the serial `prepare_data` + `fit_prepared` (phase
     8's plan at k = `KS` for the first dataset), the wall time beside the
     serial sum and `stats()`'s prepare and solve seconds; a pipelined
     pair on the two prepared datasets traced with `torch.profiler`, its
     idle share; a real out-of-memory
     (`torch.cuda.set_per_process_memory_fraction` just above what is
     reserved) failing a request, classified transient, the allocated
     bytes back to their level before it, and the same request equal to
     the fit once the cap is lifted; then a `FaultPlan` of transient
     solve faults on the rejection targets: one ticket served by
     k-means||/device after rejection/device (equal to phase 8's
     k-means|| plan's fit at k = `KS`; an engine on the card skips the
     chain's cpu rungs),
     one retried (equal to the fit at `attempt_seed(1, 1)`);
 8f. the clustering service: `ClusterServer` on an ephemeral loopback
     port with two tenants, a `ClusterClient` sending `kddcup_shaped(0)`
     at seeds 0 to 3 (four requests in flight, 176 MiB each in f64),
     which the frontend coalesces into one stacked lane; each answer bit
     for bit against its lane of `fit_batch_prepared` over one
     `prepare_stacked` (phase 8c's plan), the queue-wait, solve and
     network attribution and the bytes on the wire;
 8g. the sharded backend at full width on `kddcup_shaped(0)` over
     `make_seeding_mesh(4, device="cuda:0")` (four shards on the one
     card): the rejection plan's prepare (split onto the shards) and fit
     at k = 1000, its launches (4 x 2k `tree_sep_update`, 4k
     `tree_sep_update_tiles`, one `lsh_bucket_accept` an accept round),
     a refit at seed 1 (the mean cost of seeds 0 and 1 within 5% of
     phase 8's device fit and refit(seed=1)); at k = `KS`: the rejection
     solve on one shard of phase 8's prepared artifacts (the same indices
     as phase 8's device plan at that k), fastkmeans++ and k-means|| on
     the four shards (5 x 4 `pairwise_argmin` launches); "sharded done"
     closes it;
  9. the seeding paths' device tensors are freed;
 10. `flash_attention` against its plain version (the chunked
     online-softmax scan) at the serving path's shape, q (4, 2048, 32, 128)
     over k, v (4, 2048, 4, 128) in bf16, causal, and at f32 non-causal
     with g = 1, a ragged S and the (BH, S, D) entry, to 1e-4;
 11. its time (CUDA events) beside the plain version's, PyTorch's
     `scaled_dot_product_attention` on the (B, H, S, D) view (the table's
     yardstick; the port never calls it), and the bound: 2 S (S + 1) D
     operations per head on the bf16 tensor cores; the f32 route (the SIMT
     kernel) at the same shape for information;
 12. the serving path: yi-9b's 17.7 GB of weights drawn on the card,
     a warm-up, then `generate` with the launch counts set to 0 just
     before and read just after (exactly 48 `flash_attention`, one per
     layer, in the prefill; decode runs no kernel), peak device memory,
     a second `generate` with the same tokens, the engine's steps timed
     apart (prefill seconds, time to first token, decode tokens per
     second; the same tokens again), and a prefill and 4 decode steps
     traced with `torch.profiler` (device busy share, top kernels);
 13. the kernel inside the model, apart from its plain version, on
     128-token prompts: layer by layer through all 48 layers, each
     layer's prefill attention (one launch) against its decode attention
     (128 steps over a cache, no kernel) on the same input, f32
     activations over the bf16 weights, to 1e-3 of the layer's largest
     output; and, for information, the last logits of `prefill` against
     `replay_prefill` end to end in bf16 (under the JAX package's init
     law the attention is nearly one-hot, so the random model is chaotic
     and the two drift apart over the depth);
 14. reduced yi-9b in f32 on the card against the port on the CPU with
     the same weights: prefill logits to 1e-3 and the same greedy tokens;
 14b. the clustered KV cache on yi-9b's first 24 layers (phase 12's
     weights, depth cut from 48 for time, `cluster_kv` with C = 64, topc =
     16): `prefill` of one 2,048-token prompt, then
     `build_clustered_cache` for each of the 24 layers from its K/V (96
     fastkmeans++/device fits of k = 64 on 2,048 points of d = 128, 2
     Lloyd steps; exactly 128 `tree_sep_update` and 64
     `tree_sep_update_tiles` launches a fit), timed, with the dropped
     share; rows 1 and 2 at the codebook fit's shape, for the first and
     the last (layer, head): the fit again through its plan, its centroids
     equal to the build's, and its 64 opened centers replayed through the
     kernels and through the plain sweeps (the same weights bit for bit
     after every center, tile sums to 1e-5), and the solo call forms at
     the last weights; 32 `decode_step`s over the stacked codebooks timed
     beside the plain decode at the same context, with the KV bytes each
     reads a step; then, layer by layer through the first 8 layers with
     f32 activations over the bf16 weights, `attn_decode_clustered` at
     topc = C = 8 with a capacity of S (nothing drops) against
     `attn_decode` on the same input, to 1e-3 of the layer's largest
     output;
 14c. deepseek-v2-lite-16b at full width (27 layers, MLA with kv_lora 512,
     64 routed experts top-6 and 2 shared, the first layer dense;
     15,647,895,040 random bf16 parameters from seed 0): `prefill` on 4 x
     2,048 tokens (exactly 27 `flash_attention` launches, q and k of head
     dim 192 and v of 128), timed, with peak memory; `Engine.generate`
     (replay prefill) on 4 x 64-token prompts, 16 new, twice with the same
     tokens; the MLA layer check (each layer's prefill attention, one
     launch, against the absorbed decode on the same input, to 1e-3); and
     the kernel at MLA's shape against its plain version, timed beside
     `scaled_dot_product_attention`, with its bound;
 14d. qwen2-moe-a2.7b at full width (24 layers, 60 routed experts padded
     to 64, top-4, 4 shared; 15,146,403,840 parameters): `Engine.generate`
     on 4 x 2,048 tokens, 32 new, greedy, twice with the same tokens
     (exactly 24 `flash_attention` launches), its steps timed apart, peak
     memory, no token routed to experts 60 to 63, and the kernel at the
     prefill's shape (4 x 2,048, 16 heads of 128, g = 1, bf16, causal)
     against its plain version, timed beside SDPA, with its bound;
 14e. reduced deepseek-v2-lite-16b and qwen2-moe-a2.7b in f32 on the card
     against the port on the CPU: the same greedy tokens, and prefill
     logits to 1e-3 on 2 x 16-token prompts (at 4 x 64 reduced
     qwen2-moe's logits move by about 6e-3 under 1e-7 relative weight
     noise on the CPU alone, PERF.md section 4);
 15a. rwkv6-3b at full width and depth (32 layers, d_model 2560, 40 wkv
     heads of 64; 3,089,123,840 random bf16 parameters): `forward` on 4 x
     2,048 tokens (the chunked wkv scan, no kernel), timed, the time mix of
     one layer timed alone; `Engine.generate` on 4 prompts of 128 tokens,
     32 new (the prompt replayed through `decode_step`, the states written
     in place), timed, and the replay alone on the same prompts, timed (its
     bf16 last logits against the forward's printed for information); and
     the gate:
     the forward's last logits against the replay's on the same prompts,
     f32 activations over the bf16 weights, within 1e-3 of the largest;
 15b. jamba-1.5-large-398b at full width (d_model 8192, d_inner 16,384,
     64 query heads over 8 KV heads, expert d_ff 24,576) cut to one period
     of 8 of its 72 layers and 4 of its 16 experts, top-2 kept
     (16,246,923,264 parameters): the same steps on 4 x 2,048 tokens
     (exactly 1 `flash_attention` launch, the Mamba mixer timed per
     layer), `generate` on 4 x 64 tokens, 16 new, and the same gate (MoE
     capacity raised so that nothing drops);
 15c. paligemma-3b at full width and depth (18 layers; 2,511,022,080
     parameters): `prefill` of 256 image patches (width 1152) ahead of 768
     text tokens, 4 sequences (exactly 18 `flash_attention` launches with
     the prefix of 256 attended fully), 32 decode steps, timed; row 8 at
     that shape (q (4, 1024, 8, 256), k, v (4, 1024, 1, 256), bf16) with
     prefixes 256, 200 (inside a query block) and 1000 against its plain
     version, prefixes 0 and 1 bit-identical to the causal launch, its
     numbers beside SDPA with a boolean mask;
 15d. hubert-xlarge at full width and depth (48 layers; 1,260,360,960
     parameters): `forward` on 4 x 2,048 frame embeddings of width 512
     (exactly 48 non-causal `flash_attention` launches, 16 heads of 80),
     timed; row 8 at that shape against its plain version, its numbers;
 16a. the backward of row 8 (`csrc/flash_attention_bwd.cu`, three launches
     a call: delta, dK and dV, dQ) against autograd through the plain
     version on f32 copies of the same inputs, at olmo-1b's training shape
     (8, 256, 16, 128) f32 causal, yi-9b's GQA (4, 2048, 32 over 4, 128),
     MLA's D 192 / Dv 128, a prefix of 256 (4, 1024, 8 over 1, 256),
     hubert's non-causal D 80 and 16d's microbatch (2, 4096, 16, 128), in
     bf16: each gradient within 1e-4 (f32) or
     4e-3 (bf16: one rounding of the gradient, at most 2^-8 of it) of its
     largest magnitude, a second launch bit-identical, the forward's `out`
     the same bits with its log-sum-exp asked for; times beside the plain
     backward's and `scaled_dot_product_attention`'s backward, and the
     bound (f32 at the TF32 rate of its 3xTF32 products, the f32 rate
     beside); and row 8's forward at olmo-1b's shape in f32 against its
     plain version, its time beside SDPA's in f32 and its bound;
 16b. olmo-1b at full width and depth in f32 (1,176,764,416 parameters,
     18.8 GB with the gradients and both moments) through
     `make_train_step`: 6 steps of 8 x 256 tokens from `TokenStream(50304,
     256, 8, seed=0)`, lr 1e-3, remat "none", each step's loss (finite)
     and exactly 16 forward and 16 backward `flash_attention` launches,
     the median step time, tokens a second, peak memory, and a seventh
     step traced (the device idle share, and the backward kernels' device
     time in it: exactly 3 launches a layer);
 16c. the `Trainer` (`repro_torch.launch.train`'s loop) at full width and
     2 of the 16 layers: 8 steps with a checkpoint every 3 (a golden
     run), a run that `fail_at_step=5` stops, and its resume from step 3,
     whose losses match the golden run's steps 4 to 8 within rtol 1e-6
     (bit-identical or not, printed), the checkpoint's bytes and write
     seconds; the checkpoints live under `build/` and are removed;
 16d. olmo-1b at full width and depth in bf16 (bf16 parameters and
     activations, f32 moments and accumulators) under remat "dots"
     through `make_train_step`: batches of 4 x 4,096 tokens (the JAX
     package's train_4k sequence length) in 2 microbatches; first the
     first batch's gradients under "dots", "none" and "block" on the same
     parameters (`make_grads_fn`): the loss and every gradient of "none"
     and "block" equal to "dots"' bit for bit (or, should an op prove
     non-deterministic on the card, within the gap of two "none" runs,
     printed), each policy's peak memory above the state (dots below
     none), and each policy's launches: one backward launch a layer and
     microbatch, one forward launch a layer and microbatch and one more
     where the group is recomputed ("block", and "dots", which cannot save
     the output of the flash kernel's autograd Function: it is no aten
     op); then 4 timed steps (each loss finite, exactly 64 forward and 32
     backward launches a step), the median step time, tokens a second,
     peak memory, and a fifth step traced (the idle share); row 8 at the
     microbatch's shape (q, k, v (2, 4096, 16, 128) bf16, causal) against
     its plain version and timed (its backward: 16a's sixth shape);
 16e. a one-rank NCCL group on the card, from a `FileStore` under
     `build/` (no TCP port; no fallback to gloo): `compressed_psum` over
     16d's gradient tree, each leaf equal to `int8_decompress(q, scale)`
     and its residual to `int8_compress`'s bit for bit, its time and the
     bytes it gathers; `make_ddp_step` on olmo-1b at full width and 2 of
     its 16 layers in bf16 (4 x 2,048 tokens): the compressed sync within
     half a quantisation step of the uncompressed one, 4 SGD steps with
     and 4 without compression (finite losses); `pipeline_apply` on one
     stage with one full-width block as its body, 2 microbatches of 2 x
     2,048, equal to the direct calls bit for bit;
 17. the port's copies of the four examples (`examples_torch/`), in this
     process, on the card: quickstart `--smoke --backend device` and
     `--smoke --backend sharded` (the device plans: rows 1 to 3 and 5; the
     seeder table's NumPy rows, the plan, the engine and the stacked
     lanes), resilient_serving `--smoke` on the device backend (its six
     stages; rejection's dead primary served by k-means|| on the device,
     bit for bit), serve_cluster_kv `--seq 16384
     --engine` (the codebook rebuilds through `ClusterEngine`, rows 1 and
     2; recall and output error against exact attention) and train_lm's
     tiny preset (f32, head width 64: rows 8 and 8′) for a few steps, then
     again in the same workdir, which resumes; each gated as
     `tests/test_torch_examples.py` gates it where the card can be
     compared; then the dry run's count of 16d's step on `meta`
     (`repro_torch.launch.dryrun.count_operations`, remat "dots", two
     microbatches: its attention launches 16d's), divided by 16d's median
     step seconds, beside the card's name and power limit;
 18. the phases' wall seconds (``{"phase_seconds": {...}}``), one JSON
     line per the kernels (the eight rows and the backward of row 8), the
     card's line again, and last ``{"ok": true, "device": {...}}``.  A row's `launches` is its main
     path's count, each path's counts set to 0 just before it and read
     just after: phase 8's rejection fit for rows 1 to 3, its k-means||
     fit for row 5, phase 12's `generate` for row 8.  `launches_by_path`
     gives every path's own count: ``main`` and ``kmeans||`` (phase 8),
     ``streaming`` (8d), ``engine`` (8e), ``service`` (8f), ``sharded``
     (8g: its rejection fit for rows 1 to 3, its k-means|| fit for row 5),
     ``generate`` (12), ``cluster_kv`` (14b's build), ``mla`` (14c's
     prefill), ``moe`` (14d's generate), ``rwkv6`` and ``jamba`` (15a's
     and 15b's forward), ``paligemma`` (15c's prefill), ``hubert``
     (15d's forward) and ``examples`` (17, the four copies).  Row 8 also carries its numbers at MLA's shape
     (``at_mla_shape``), qwen2-moe's (``at_moe_shape``), paligemma's
     with its prefix (``at_prefix_shape``) and hubert's
     (``at_hubert_shape``), olmo-1b's training shape in f32
     (``at_olmo_1b_shape``) and in bf16 (``at_olmo_1b_bf16_train_shape``,
     16d's microbatch); its ``max_abs_err`` is the largest of all its
     checks.  The backward's row (``flash_attention_bwd``) has its numbers
     at olmo-1b's training shape, its launches in 16b's six steps
     (``train``; ``trainer`` for 16c, ``train_bf16`` for 16d's four timed
     steps, ``ddp`` for 16e), its other 16a shapes (``at_yi_9b_shape``,
     ``at_mla_shape``, ``at_prefix_shape``, ``at_hubert_shape``,
     ``at_olmo_1b_bf16_train_shape``) and its device time in 16b's traced
     step (``in_traced_train_step``).  Both rows' ``launches_by_path``
     carry ``train``, ``trainer``, ``train_bf16`` and ``ddp``.

Any failure raises and exits non-zero before the last line is printed.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import gc
import json
import math
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N, D, K_TRUE = 311_029, 74, 2000      # KDD Cup (benchmarks/datasets.py)
K = 1000
SEED = 0
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
F32_OPS_PER_S = 67e12                 # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12               # TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12               # bf16 on the tensor cores, dense
RTOL = 1e-5
SMALL_SEEDS = 64
KERNELS = {
    "tree_sep_update": ("src/repro_torch/csrc/tree_sep_update.cu",
                        "src/repro/kernels/tree_sep_update.py:61"),
    "tree_sep_update_tiles": ("src/repro_torch/csrc/tree_sep_update.cu",
                              "src/repro/kernels/tree_sep_update.py:95"),
    "lsh_bucket_accept": ("src/repro_torch/csrc/lsh_bucket_accept.cu",
                          "src/repro/kernels/lsh_bucket_min.py:140"),
    "lsh_bucket_min": ("src/repro_torch/csrc/lsh_bucket_accept.cu",
                       "src/repro/kernels/lsh_bucket_min.py:99"),
    "pairwise_argmin": ("src/repro_torch/csrc/pairwise_argmin.cu",
                        "src/repro/kernels/pairwise_argmin.py:55"),
    "d2_update": ("src/repro_torch/csrc/d2_update.cu",
                  "src/repro/kernels/d2_update.py:44"),
    "d2_update_tiles": ("src/repro_torch/csrc/d2_update.cu",
                        "src/repro/kernels/d2_update.py:70"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:94"),
}
STACK_SMALL = 150_000                   # the third stacked lane's rows
STREAM_FIRST = 200_000                  # phase 8d: the stream's first rows
STREAM_BATCH = 10_000                   # rows an extend
STREAM_RETIRE = 31_102                  # rows retired, a tenth of n
STREAM_DUPS = 50_000                    # duplicates of the first rows
STREAM_OOD = 1_000                      # rows moved out of the domain
KMP_ROUNDS = 5                          # the k-means|| defaults
KMP_ELL = 2.0 * K
KMP_CAP = int(min(N, max(8, 4 * KMP_ELL)))
SHARDS = 4                              # phase 8g: shards on cuda:0
# Phases 8b to 8g, the secondary seeding paths, solve at k = KS: their
# depth, cut from K for time (a solve is host-bound at some 190 host ops a
# center, so k sets its seconds); phase 8's solves at K stay, and so does
# 8g's sharded rejection fit and refit, whose mean cost is gated
KS = 100
SERVE_ARCH = "yi-9b"                    # the serving launcher's default
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
REPLAY_PROMPT = 128
TRACE_STEPS = 4
# f32 sums over up to 2,048 keys in another order than the plain version's
ATTN_TOL = 1e-4
# one layer's attention, prefill against decode on the same f32 input, as
# a share of its largest output (f32 sums in other orders)
LAYER_TOL = 1e-3
# f32 on the card against f32 on the CPU, 4 layers (tests/test_torch_models)
SMALL_TOL = 1e-3
CKV_PROMPT, CKV_CLUSTERS, CKV_TOPC, CKV_STEPS = 2048, 64, 16, 32   # 14b
CKV_EXACT_CLUSTERS = 8                  # 14b's exactness check: topc = C
# 14b's depth, cut for time: the build and decode over yi-9b's first 24
# of 48 layers, the exactness check over the first 8
CKV_LAYERS, CKV_EXACT_LAYERS = 24, 8
MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b")
MOE_BATCH, MOE_PROMPT = 4, 2048         # 14c's prefill, 14d's generate
MOE_SHORT, MOE_SHORT_NEW = 64, 16       # 14c's generate (replay prefill)
# 14e's logits gate: the shape of tests/test_torch_models.py, where 1e-7
# weight noise moves the reduced MoE models' logits by about 1e-4 on the
# CPU; at 4 x 64 it moves reduced qwen2-moe's by about 6e-3 (attention
# near one-hot in the random model), past any 1e-3 comparison
MOE_GATE_SHAPE = (2, 16)
DEEPSEEK_PARAMS = 15_647_895_040
QWEN_MOE_PARAMS = 15_146_403_840
# 15a and 15b: the chunked forward, then a replayed generate and its gate
SSM_BATCH, SSM_FORWARD = 4, 2048
SSM_PROMPT = {"rwkv6-3b": (128, 32), "jamba-1.5-large-398b": (64, 16)}
# jamba-1.5-large-398b on one card: one period of its 72 layers, 4 of its
# 16 experts (top-2 kept); every matrix keeps its full shape
JAMBA_CUTS = {"num_layers": 8, "num_experts": 4}
SSM_PARAMS = {"rwkv6-3b": 3_089_123_840,
              "jamba-1.5-large-398b": 16_246_923_264}
# the forward's last logits against the replay's, f32 activations over the
# bf16 weights, as a share of the largest (f32 sums in other orders: the
# chunked scans against the step recurrences)
GATE_TOL = 1e-3
VLM_PATCHES, VLM_TEXT, VLM_STEPS = 256, 768, 32       # 15c
VLM_PREFIXES = (256, 200, 1000)        # the path's, inside a block, near S
PALIGEMMA_PARAMS = 2_511_022_080
AUDIO_FRAMES = 2048                    # 15d
HUBERT_PARAMS = 1_260_360_960
# 16: training olmo-1b in f32 on one card, the JAX launcher's defaults
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = "olmo-1b", 8, 256, 1e-3
TRAIN_STEPS = 6
OLMO_PARAMS = 1_176_764_416
# 16c: the Trainer at full width, depth cut to 2 of 16 layers for its
# checkpoints (about 2.8 GB each, 14 GB at full depth)
TRAINER_LAYERS, TRAINER_STEPS, TRAINER_EVERY, TRAINER_FAIL = 2, 8, 3, 5
# 16a: the backward kernel against autograd through the plain version, as
# a share of the largest |gradient|: f32 sums in other orders (f32), and
# one rounding of each gradient to bf16, at most 2^-8 of it (bf16 inputs)
BWD_TOL = {"float32": 1e-4, "bfloat16": 4e-3}
# 16d: olmo-1b in bf16 under remat "dots": batches of 4 x 4,096 tokens
# (the JAX package's train_4k sequence length), two microbatches
BF16_BATCH, BF16_SEQ, BF16_MICRO, BF16_STEPS = 4, 4096, 2, 4
# 16e: the compressed DDP step on olmo-1b at full width, 2 of its 16 layers,
# in bf16, batches of 4 x 2,048 tokens; the pipeline's block on 2
# microbatches of 2 x 2,048
DDP_LAYERS, DDP_BATCH, DDP_SEQ, DDP_STEPS, DDP_LR = 2, 4, 2048, 4, 1e-2
PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 2, 2, 2048
# 17: the examples' copies; train_lm's tiny preset runs TLM_FIRST steps,
# then resumes to TLM_STEPS (4 layers: one forward and one backward launch
# a layer and step, remat "none")
TLM_FIRST, TLM_STEPS, TLM_LAYERS = 4, 6, 4
# serve_cluster_kv at --seq 16384 (4 heads, 256 clusters, top 24): the cpu
# backend's run of the same script on the CPU recovers 1.000 of the
# attention mass, with relative output errors of median 0.047 and largest
# 0.559 over its 16 queries
KV_MIN_COVERAGE, KV_MAX_MEDIAN_ERROR = 0.95, 0.1
# (label, B, S, H, Hk, D, Dv, dtype, causal, prefix)
BWD_SHAPES = (
    ("olmo-1b", 8, 256, 16, 16, 128, 128, "float32", True, 0),
    ("yi-9b", 4, 2048, 32, 4, 128, 128, "bfloat16", True, 0),
    ("mla", 4, 2048, 16, 16, 192, 128, "bfloat16", True, 0),
    ("prefix", 4, 1024, 8, 1, 256, 256, "bfloat16", True, 256),
    ("hubert", 4, 2048, 16, 16, 80, 80, "bfloat16", False, 0),
    # 16d's microbatch: olmo-1b in bf16 at 2 x 4,096
    ("olmo-1b-bf16-train", BF16_BATCH // BF16_MICRO, BF16_SEQ, 16, 16, 128,
     128, "bfloat16", True, 0),
)


def log(*parts) -> None:
    print(*parts, flush=True)


# Phase boundaries: (name, perf_counter) in the order the phases start; a
# phase runs until the next one starts.  `phase_seconds` turns them into
# each phase's wall seconds.
PHASE_MARKS: list = []


def mark(name: str) -> None:
    """Start phase `name` (and end the one before it)."""
    PHASE_MARKS.append((name, time.perf_counter()))


def phase_seconds() -> dict:
    ends = [t for _, t in PHASE_MARKS[1:]] + [time.perf_counter()]
    out: dict = {}
    for (name, t0), t1 in zip(PHASE_MARKS, ends):
        out[name] = round(out.get(name, 0.0) + t1 - t0, 1)
    return out


def kddcup_shaped(seed: int) -> np.ndarray:
    """Gaussian mixture at KDD Cup's (n, d): power-law cluster sizes and
    anisotropic scales, as `benchmarks/datasets.py` makes it."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K_TRUE, D)) * 12.0
    weights = 1.0 / np.arange(1, K_TRUE + 1) ** 1.3
    weights /= weights.sum()
    assign = rng.choice(K_TRUE, size=N, p=weights)
    scales = rng.uniform(0.3, 3.0, size=(K_TRUE, D))
    return centers[assign] + rng.normal(size=(N, D)) * scales[assign]


def mixture(n=1200, d=5, k_true=12, spread=40.0, seed=6) -> np.ndarray:
    """The small mixture of `tests/test_device_rejection.py`."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * spread
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds of `fn(i)` over `iters` calls (CUDA
    events around the whole run, after a warm-up)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds of `fn(i)` over `iters` calls captured in
    one CUDA graph and replayed: the card's time per launch, free of the
    host's time per call (a kernel of a few microseconds launched from
    Python in a loop times the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    return cuda_ms(torch, lambda i: graph.replay(), replays) / iters


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least milliseconds for moving `nbytes` and doing `ops` at
    `ops_per_s`, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_rss_gib() -> float:
    """This process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def check_pairwise(torch, ops, ref, x, c, label):
    """`pairwise_argmin` against its plain version on the same inputs.

    Both evaluate the expanded form (|x|^2 - 2 x.c) + |c|^2 in f32, which
    rounds relative to |x|^2 + |c|^2, not to d2; so d2 must agree within
    `RTOL` of that scale, and an argmin may differ only where the exact
    distances of the two picks lie that close.  Returns the max abs d2
    error.
    """
    d2, idx = ops.pairwise_argmin(x, c)
    pd2, pidx = ref.pairwise_argmin_ref(x, c)
    torch.cuda.synchronize()
    xf, cf = x.float(), c.float()
    scale = (xf * xf).sum(dim=1) + (cf * cf).sum(dim=1)[pidx.long()]
    rel = float(((d2 - pd2).abs() / scale.clamp_min(1.0)).max())
    rows = torch.nonzero(idx != pidx).flatten()
    tie = 0.0
    if len(rows):
        xr = xf[rows].double()
        mine = ((xr - cf[idx[rows].long()].double()) ** 2).sum(dim=1)
        theirs = ((xr - cf[pidx[rows].long()].double()) ** 2).sum(dim=1)
        tie = float(((mine - theirs).abs() / scale[rows].double()).max())
    err = float((d2 - pd2).abs().max())
    if rel > RTOL or tie > RTOL or int(idx.max()) >= c.shape[0]:
        raise AssertionError(f"pairwise_argmin {label}: d2 rel err {rel}, "
                             f"{len(rows)} other argmins off by {tie}")
    log(f"pairwise_argmin {label}: max|d2 err| {err:.3g}, {rel:.3g} of "
        f"|x|^2+|c|^2 (tol {RTOL}); {len(rows)} of {x.shape[0]} argmins "
        f"differ, each a tie within {tie:.3g}")
    return err


def check_d2_update(torch, ops, ref, x, ctr, w, tile, label):
    """`d2_update` and `d2_update_tiles` (on the unpadded rows) against the
    plain version on the same inputs: w' to `RTOL`, lanes past n exactly
    0, tile sums to `RTOL` of the plain ones, a second launch of each
    bit-identical.  Returns the two max abs errors."""
    n = x.shape[0]
    out = ops.d2_update(x, ctr, w)
    tiles, sums = ops.d2_update_tiles(x, ctr, w, block_n=tile)
    again = (ops.d2_update(x, ctr, w),
             *ops.d2_update_tiles(x, ctr, w, block_n=tile))
    plain, psums = ref.d2_update_tiles_ref(x, ctr, w, block_n=tile)
    torch.cuda.synchronize()
    errs = (float((out - plain[:n]).abs().max()),
            max(float((tiles - plain).abs().max()),
                float((sums - psums).abs().max())))
    rel = float(((sums - psums).abs() / psums.abs().clamp_min(1e-30)).max())
    same = all(torch.equal(a, b) for a, b in zip((out, tiles, sums), again))
    if not (torch.allclose(out, plain[:n], rtol=RTOL, atol=RTOL)
            and torch.allclose(tiles, plain, rtol=RTOL, atol=RTOL)
            and rel <= RTOL and bool((tiles[n:] == 0).all()) and same):
        raise AssertionError(f"d2_update {label}: errs {errs}, tile sums "
                             f"rel {rel}, second launch equal {same}")
    log(f"d2_update, d2_update_tiles {label}: n={n} d={x.shape[1]}: max|w' "
        f"err| {errs[0]:.3g}, {errs[1]:.3g}; {sums.shape[0]} tile sums max "
        f"rel err {rel:.3g} (rtol {RTOL}); w' past n exactly 0; a second "
        "launch bit-identical")
    return errs


def d2_bound(n, d, elem, tile=None) -> tuple[float, str]:
    """Least time of `d2_update` (tile None) or `d2_update_tiles` on n rows
    of d elements of `elem` bytes: x, the center and w read once, w' (n,
    or n_pad for the tiles entry with its n_pad / tile sums) written once;
    3d + 1 operations a row, and a tile sum's add."""
    if tile is None:
        return bound(elem * (n * d + d) + 8 * n, n * (3 * d + 1))
    n_pad = -(-n // tile) * tile
    return bound(elem * (n * d + d) + 4 * n + 4 * (n_pad + n_pad // tile),
                 n * (3 * d + 1) + n_pad)


def d2_shapes(torch, ops, ref, d2_cuda, x_km, tile) -> None:
    """`d2_update` and `d2_update_tiles` at the paper's three dataset
    shapes (benchmarks/datasets.py) in f32, and KDD Cup's also in bf16:
    each checked against the plain version, then its time as a CUDA graph
    of 100 launches (best of two) beside the plain version's, the bound
    and the share.  The tiles entry runs on the unpadded rows.  Random
    rows from a seed: the time depends on the shape, not the values."""
    dev = x_km.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    log(f"d2_update at the paper's shapes, on {smi('name,power.limit')}:")
    for label, n, d, dtype in (("kddcup", N, D, torch.float32),
                               ("kddcup", N, D, torch.bfloat16),
                               ("song", 515_345, 90, torch.float32),
                               ("census", 2_458_285, 68, torch.float32)):
        if n == N:
            x = x_km.to(dtype)
        else:
            x = torch.randn(n, d, generator=gen, device=dev).mul_(8.0)
        ctr = x[n // 3].clone()
        w = torch.rand(n, generator=gen, device=dev).mul_(16.0 * d)
        name = f"{label} {str(dtype)[6:]}"
        check_d2_update(torch, ops, ref, x, ctr, w, tile, name)
        elem = x.element_size()
        for entry, kernel, plain_fn, (b_ms, b_by) in (
                ("d2_update", lambda i: d2_cuda.launch(x, ctr, w),
                 lambda i: ref.d2_update_ref(x, ctr, w),
                 d2_bound(n, d, elem)),
                ("d2_update_tiles",
                 lambda i: d2_cuda.launch_tiles(x, ctr, w, tile=tile),
                 lambda i: ref.d2_update_tiles_ref(x, ctr, w, block_n=tile),
                 d2_bound(n, d, elem, tile))):
            ms = min(graph_ms(torch, kernel, 100),
                     graph_ms(torch, kernel, 100))
            plain_ms = cuda_ms(torch, plain_fn, 10)
            log(f"time {entry} {name} {n} x {d}: kernel {ms:.6f} ms as a "
                f"CUDA graph of 100 launches, plain {plain_ms:.6f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}), {b_ms / ms:.3f} of the bound")
        del x, ctr, w
    torch.cuda.empty_cache()


def cost64(torch, pts, centers, chunk=16384) -> float:
    """sum_x min_c ||x - c||^2 in float64 on the card."""
    total = 0.0
    c_sq = (centers ** 2).sum(dim=1)
    for lo in range(0, pts.shape[0], chunk):
        x = pts[lo: lo + chunk]
        d2 = (x ** 2).sum(dim=1, keepdim=True) - 2.0 * x @ centers.T + c_sq
        total += float(d2.min(dim=1).values.clamp_min(0.0).sum())
    return total


def busy_seconds(spans: list, per_second: float) -> float:
    """The length of the union of (start, end) spans, in seconds."""
    if not spans:
        raise AssertionError("the profiler recorded no device events")
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / per_second


def device_time(torch, prof) -> tuple:
    """(seconds the device was busy, device events, {kernel name: [ms,
    count]}) of a `torch.profiler` trace: the union of its CUDA events'
    spans, read from the raw events (no Python event objects are built,
    which is slow for hundreds of thousands of launches)."""
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = busy_seconds([(e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in kernels], 1e9)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name()][0] += e.duration_ns() / 1e6
        by_name[e.name()][1] += 1
    return busy, len(kernels), by_name


def log_top(by_name: dict, n: int) -> None:
    for name, (ms, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:n]:
        log(f"  {ms:10.3f} ms {cnt:7d}x {name[:90]}")


def at_k(plan, k: int):
    """`plan` at another k over the same prepared data: a shallow copy
    that shares its prepare cache and active data (k is read only by the
    solve stage)."""
    import copy
    import dataclasses

    out = copy.copy(plan)
    out.cluster = dataclasses.replace(plan.cluster, k=k)
    return out


def seeding_paths(torch, t_start: float) -> list:
    """Phases 3 to 8 on the seeding paths; returns their kernels' rows.
    Every device tensor they made is freed when this returns."""
    from repro_torch.core import device_seeding as ds
    from repro_torch.core import seeding
    from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
    from repro_torch.core.sample_tree import TiledSampleTree
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import d2_update_cuda as d2_cuda
    from repro_torch.kernels import lsh_bucket_accept_cuda as lsh_cuda
    from repro_torch.kernels import pairwise_argmin_cuda as pam_cuda
    from repro_torch.kernels import tree_sep_update_cuda as sweep_cuda

    mark("3-8")
    dev = torch.device("cuda")
    # -- data and prepare (the main path's first stage) -----------------------
    t0 = time.perf_counter()
    points = kddcup_shaped(SEED)
    log(f"data: kddcup-shaped n={N} d={D} ({time.perf_counter() - t0:.2f} s)")
    plan = ClusterPlan(ClusterSpec(k=K, seeder="rejection", seed=SEED),
                       ExecutionSpec(backend="device"))
    prep = plan.prepare(points).prepare_data(points)
    data = prep.artifacts
    t, h, n = data.codes_lo.shape
    l = data.keys_lo.shape[0]
    log(f"prepare: {prep.prepare_seconds:.3f} s; trees={t} H={h + 1} L={l} "
        f"scale={data.scale:.6g} m_init={data.m_init:.6g}")

    # -- 3. each kernel against its plain version at the main path's shapes ----
    tile = plan.execution.tile
    ts = TiledSampleTree(n, tile=tile)
    lo = ds._pad_axis(data.codes_lo, 2, ts.n_pad)
    hi = ds._pad_axis(data.codes_hi, 2, ts.n_pad)
    sweep_kw = dict(scale=data.scale, num_levels=data.num_levels)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    w = torch.zeros(ts.n_pad, device=dev)
    w[:n] = data.m_init
    for x in rng.choice(n, 8, replace=False):      # a weight mid-solve
        for ti in range(t):
            w = ref.tree_sep_update_ref(lo[ti], hi[ti], lo[ti, :, x],
                                        hi[ti, :, x], w, **sweep_kw)
    coarse = ts.init(w)
    x = int(rng.integers(n))
    # The sweeps as a fit launches them: the lane form with one lane, codes
    # (1, T, H-1, n_pad), the opened point x on the card, weights (1, n_pad).
    lo1, hi1, w1 = lo[None], hi[None], w[None]
    x1 = torch.tensor([x], dtype=torch.int64, device=dev)
    errs = {}
    out = ops.tree_sep_update_lanes(lo1[:, 0], hi1[:, 0], x1, w1,
                                    **sweep_kw)[0]
    plain = ref.tree_sep_update_ref(lo[0], hi[0], lo[0, :, x], hi[0, :, x], w,
                                    **sweep_kw)
    solo = ops.tree_sep_update(lo[0], hi[0], lo[0, :, x], hi[0, :, x], w,
                               **sweep_kw)
    torch.cuda.synchronize()
    errs["tree_sep_update"] = float((out - plain).abs().max())
    if not torch.equal(out, plain) or not torch.equal(solo, plain):
        raise AssertionError(f"tree_sep_update differs from its plain version"
                             f": max abs {errs['tree_sep_update']}, the solo "
                             f"call form equal {torch.equal(solo, plain)}")
    log(f"tree_sep_update: H-1={h} n_pad={ts.n_pad}, one lane as a fit "
        "launches it: bit-identical to the plain version; the solo call form "
        "too")
    out, sums = (v[0] for v in ops.tree_sep_update_tiles_lanes(
        lo1[:, t - 1], hi1[:, t - 1], x1, w1, block_n=tile, **sweep_kw))
    plain, psums = ref.tree_sep_update_tiles_ref(
        lo[t - 1], hi[t - 1], lo[t - 1, :, x], hi[t - 1, :, x], w,
        block_n=tile, **sweep_kw)
    solo, ssums = ops.tree_sep_update_tiles(lo[t - 1], hi[t - 1],
                                            lo[t - 1, :, x], hi[t - 1, :, x],
                                            w, block_n=tile, **sweep_kw)
    torch.cuda.synchronize()
    rel = float(((sums - psums).abs() / psums.abs().clamp_min(1e-30)).max())
    errs["tree_sep_update_tiles"] = max(float((out - plain).abs().max()),
                                        float((sums - psums).abs().max()))
    if not torch.equal(out, plain) or rel > RTOL or \
            not (torch.equal(solo, out) and torch.equal(ssums, sums)):
        raise AssertionError(f"tree_sep_update_tiles: w' equal "
                             f"{torch.equal(out, plain)}, tile sums rel {rel}"
                             f", the solo call form equal "
                             f"{torch.equal(solo, out)}, "
                             f"{torch.equal(ssums, sums)}")
    log(f"tree_sep_update_tiles, one lane as a fit launches it: w' "
        f"bit-identical; {ts.num_tiles} tile sums max rel err {rel:.3g} "
        f"(rtol {RTOL}); the solo call form bit-identical to it")

    pts_pad = ds._pad_axis(data.points, 0, ts.n_pad)
    klo = ds._pad_axis(data.keys_lo, 1, ts.n_pad)
    khi = ds._pad_axis(data.keys_hi, 1, ts.n_pad)
    centers = torch.as_tensor(rng.choice(n, K, replace=False), device=dev)
    c2 = plan.cluster.c ** 2

    def center_slots(count):
        """The seeder's center buffers (K slots) with `count` opened."""
        c = torch.full((K, D), ds._FAR, device=dev)
        ck_lo = torch.zeros((l, K), dtype=torch.int32, device=dev)
        ck_hi = torch.zeros_like(ck_lo)
        c[:count] = pts_pad[centers[:count]]
        ck_lo[:, :count] = klo[:, centers[:count]]
        ck_hi[:, :count] = khi[:, centers[:count]]
        return ck_lo, ck_hi, c

    def one_lane(args):
        """The accept's inputs as a fit passes them: every candidate in
        lane 0, the center buffers (1, L, K) and (1, K, D)."""
        lanes = torch.zeros(args[2].shape[0], dtype=torch.int64, device=dev)
        return args[:3] + (lanes,) + tuple(a[None] for a in args[3:6]) + \
            args[6:]

    log(f"lsh_bucket_accept (one lane as a fit launches it) and "
        f"lsh_bucket_min (L={l}, d={D}, {K} slots): B count hits max|d2 err| "
        "max rel err")
    errs["lsh_bucket_accept"] = errs["lsh_bucket_min"] = 0.0
    for b in (32, 64, 128, 256, 512):
        cand = ts.sample(coarse, w, gen, b)
        q_args = (klo[:, cand], khi[:, cand], pts_pad[cand])
        for count in (0, 1, K // 2, K):
            args = q_args + center_slots(count) + (w[cand],)
            d2, p = ops.lsh_bucket_accept_lanes(*one_lane(args), count, c2=c2)
            d2_only = ops.lsh_bucket_min(*args[:6], count)
            again = ops.lsh_bucket_accept_lanes(
                *one_lane(args), count, c2=c2) + (
                ops.lsh_bucket_min(*args[:6], count),)
            solo = ops.lsh_bucket_accept(*args, count, c2=c2)
            pd2, pp = ref.lsh_bucket_accept_ref(*args, count, c2=c2)
            pd2_only = ref.lsh_bucket_min_ref(*args[:6], count)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y)
                       for x, y in zip((d2, p, d2_only), again)):
                raise AssertionError(f"LSH queries at B={b} count={count}: "
                                     "a second launch differs")
            if not (torch.equal(solo[0], d2) and torch.equal(solo[1], p)):
                raise AssertionError(f"lsh_bucket_accept at B={b} count="
                                     f"{count}: the solo call form differs "
                                     "from the one-lane launch")
            miss = pd2 == ref.LSH_MISS
            if not (torch.equal(d2 == ref.LSH_MISS, miss)
                    and torch.equal(d2_only == ref.LSH_MISS, miss)
                    and torch.equal(pd2_only, pd2)):
                raise AssertionError(f"LSH_MISS lanes differ at B={b} "
                                     f"count={count}")
            if not torch.allclose(d2_only[~miss], pd2[~miss], rtol=RTOL,
                                  atol=RTOL):
                raise AssertionError(f"lsh_bucket_min B={b} count={count}")
            errs["lsh_bucket_min"] = max(
                errs["lsh_bucket_min"],
                float((d2_only - pd2)[~miss].abs().max()) if (~miss).any()
                else 0.0)
            hit = ~miss
            diff = (d2 - pd2)[hit].abs()
            err = float(diff.max()) if hit.any() else 0.0
            rel = float((diff / pd2[hit].abs().clamp_min(1e-30)).max()) \
                if hit.any() else 0.0
            p_ok = torch.allclose(p, pp, rtol=RTOL, atol=RTOL)
            d2_ok = torch.allclose(d2[hit], pd2[hit], rtol=RTOL, atol=RTOL)
            if not (p_ok and d2_ok):
                raise AssertionError(f"lsh_bucket_accept B={b} count={count}"
                                     f": d2 err {err}, p ok {p_ok}")
            errs["lsh_bucket_accept"] = max(
                errs["lsh_bucket_accept"], err,
                float((p - pp)[hit].abs().max()) if hit.any() else 0.0)
            log(f"  {b} {count} {int(hit.sum())} {err:.3g} {rel:.3g}")

    log(f"[{time.perf_counter() - t_start:.1f} s] k-means|| kernels")
    # k-means|| at full width: the plan's artifact is the f32 upload, and one
    # round's center slots come from the seeder's own draws.
    plan_km = ClusterPlan(ClusterSpec(k=K, seeder="kmeans||", seed=SEED),
                          ExecutionSpec(backend="device"))
    km_prep = plan_km.prepare(points).prepare_data(points)
    x_km = km_prep.artifacts
    km_gen = torch.Generator(device=dev).manual_seed(SEED)
    d2_0 = ((x_km - x_km[int(rng.integers(n))]) ** 2).sum(dim=1)
    _, slots, live = ds._kmeans_parallel_picks(x_km, d2_0, km_gen, KMP_ELL,
                                               KMP_CAP)
    live_slots = int(live)
    if live_slots != int((slots[:, 0] < ds._FAR).sum()):
        raise AssertionError(f"the round's live count {live_slots} is not "
                             "its number of picks")
    log(f"k-means|| prepare: {km_prep.prepare_seconds:.3f} s; one round's "
        f"{KMP_CAP} center slots hold {live_slots} picks")
    errs["pairwise_argmin"] = check_pairwise(
        torch, ops, ref, x_km, slots, f"{N} x {KMP_CAP} x {D} f32")
    # The path's launch sweeps only the live slots and the first far one:
    # bit for bit the full sweep's outputs.
    full = ops.pairwise_argmin(x_km, slots)
    swept = ops.pairwise_argmin(x_km, slots, live)
    torch.cuda.synchronize()
    if not (torch.equal(full[0], swept[0]) and torch.equal(full[1], swept[1])):
        raise AssertionError("pairwise_argmin over the round's live slots "
                             "differs from the full sweep")
    log(f"pairwise_argmin over the round's {live_slots} live slots (the "
        f"path's launch): bit-identical to the full sweep of {KMP_CAP}")
    del full, swept
    # All 8,000 slots live (timing (a) below), f32 and the bf16 route.
    pick_all = np.random.default_rng(SEED + 1).choice(n, KMP_CAP,
                                                      replace=False)
    slots_all = x_km[torch.as_tensor(pick_all, device=dev)]
    for dtype in (torch.float32, torch.bfloat16):
        errs["pairwise_argmin"] = max(errs["pairwise_argmin"], check_pairwise(
            torch, ops, ref, x_km.to(dtype), slots_all.to(dtype),
            f"{N} x {KMP_CAP} x {D} {str(dtype)[6:]}, every slot live"))
    small_x = torch.randn(1001, D, generator=km_gen, device=dev)
    small_c = torch.randn(77, D, generator=km_gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        errs["pairwise_argmin"] = max(errs["pairwise_argmin"], check_pairwise(
            torch, ops, ref, small_x.to(dtype), small_c.to(dtype),
            f"1001 x 77 x {D} {str(dtype)[6:]}"))

    w_km = ((x_km - x_km[int(rng.integers(n))]) ** 2).sum(dim=1)
    ctr_km = x_km[int(rng.integers(n))]
    errs["d2_update"], errs["d2_update_tiles"] = check_d2_update(
        torch, ops, ref, x_km, ctr_km, w_km, tile, "kddcup f32")

    # -- 5. the main path -------------------------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] the paths")

    def fit_once(label, call):
        ops.reset_launch_counts()
        res = call()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {"tree_sep_update": (t - 1) * K, "tree_sep_update_tiles": K}
        if any(counts[name] != v for name, v in want.items()) or \
                counts["lsh_bucket_accept"] < K - 1:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want} and lsh_bucket_accept >= {K - 1}")
        idx = res.indices
        if idx.shape != (K,) or idx.device.type != "cuda" or \
                len(torch.unique(idx)) != K or int(idx.min()) < 0 or \
                int(idx.max()) >= n:
            raise AssertionError(f"{label}: bad indices {idx}")
        if res.centers.shape != (K, D) or \
                not bool(torch.isfinite(res.centers).all()) or \
                not math.isfinite(float(res.cost)) or float(res.cost) <= 0:
            raise AssertionError(f"{label}: bad centers or cost {res.cost}")
        trials = res.extras["trials"]
        if int(trials.min()) < 1:
            raise AssertionError(f"{label}: a center with no trial")
        log(f"  {label}: prepare_seconds={res.prepare_seconds:.3f} "
            f"solve_seconds={res.solve_seconds:.3f} "
            f"cost={float(res.cost):.9g} "
            f"trials_per_center={float(trials.sum()) / K:.3f} "
            f"launches={counts} "
            f"rounds_per_batch={dict(sorted(res.extras['rounds_per_batch'].items()))}")
        return res, counts

    log("main path:")
    fit, launches = fit_once("rejection fit", plan.fit)
    refit, _ = fit_once("rejection refit(seed=1)", lambda: plan.refit(seed=1))
    if plan.cache_info()["prepare_builds"] != 1:
        raise AssertionError(f"refit re-prepared: {plan.cache_info()}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fast_idx = ds.device_fast_kmeanspp(
        data.codes_lo, data.codes_hi, K,
        torch.Generator(device=dev).manual_seed(SEED), scale=data.scale,
        num_levels=data.num_levels, m_init=data.m_init, tile=tile)
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    fast_counts = ops.launch_counts()
    if fast_counts != dict({name: 0 for name in fast_counts},
                           tree_sep_update=(t - 1) * K,
                           tree_sep_update_tiles=K) \
            or len(torch.unique(fast_idx)) != K:
        raise AssertionError(f"fastkmeans++: launches {fast_counts}")
    log(f"  fastkmeans++ on the same prepared data: solve {fast_s:.3f} s, "
        f"launches={fast_counts}")

    def fit_km(label, call):
        ops.reset_launch_counts()
        res = call()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts["pairwise_argmin"] != KMP_ROUNDS or \
                sum(counts.values()) != KMP_ROUNDS:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{KMP_ROUNDS} pairwise_argmin and no other")
        idx = res.indices
        if idx.shape != (K,) or idx.device.type != "cuda" or \
                len(torch.unique(idx)) != K or int(idx.min()) < 0 or \
                int(idx.max()) >= n or not math.isfinite(float(res.cost)) \
                or float(res.cost) <= 0:
            raise AssertionError(f"{label}: bad indices or cost {res.cost}")
        log(f"  {label}: solve_seconds={res.solve_seconds:.3f} "
            f"pool={res.extras['pool_size']} cost={float(res.cost):.9g} "
            f"launches={counts} peak host RSS {peak_rss_gib():.2f} GiB")
        return res, counts

    log(f"[{time.perf_counter() - t_start:.1f} s] k-means||; peak host RSS "
        f"before its fits: {peak_rss_gib():.2f} GiB")
    km_fit, km_launches = fit_km("kmeans|| fit", plan_km.fit)
    km_refit, _ = fit_km("kmeans|| refit(seed=1)",
                         lambda: plan_km.refit(seed=1))
    if plan_km.cache_info()["prepare_builds"] != 1:
        raise AssertionError(f"k-means|| refit re-prepared: "
                             f"{plan_km.cache_info()}")
    # The fit's own draws again, called directly: the rounds on the card,
    # synchronised, then the host recluster, each timed.
    km_rng = plan_km._solve_rng(km_prep, None)
    ops.reset_launch_counts()
    rss0 = peak_rss_gib()
    t0 = time.perf_counter()
    sel, km_d2 = ds.device_kmeans_parallel_rounds(
        x_km, ds._generator(km_rng, dev), KMP_ELL, rounds=KMP_ROUNDS,
        cap=KMP_CAP)
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    cand = np.flatnonzero(sel.cpu().numpy())
    t0 = time.perf_counter()
    km_idx, pool = seeding._candidate_pool_to_centers(points, cand, K,
                                                      km_rng)
    recluster_s = time.perf_counter() - t0
    if not np.array_equal(km_idx, km_fit.indices.cpu().numpy()) or \
            ops.launch_counts()["pairwise_argmin"] != KMP_ROUNDS:
        raise AssertionError("k-means|| did not replay the fit's seed")
    log(f"  kmeans|| the fit's seed replayed directly: rounds on the card "
        f"{rounds_s:.4f} s ({KMP_ROUNDS} rounds, {len(cand)} selected, "
        f"phi after the rounds {float(km_d2.double().sum()):.6g}), host "
        f"recluster {recluster_s:.3f} s (pool {pool}); peak host RSS "
        f"{peak_rss_gib():.2f} GiB ({rss0:.2f} before); same indices as "
        "the fit")

    log(f"[{time.perf_counter() - t_start:.1f} s] references")
    # -- 6. the result against references ---------------------------------------
    def replay(open_center):
        weights = torch.zeros(ts.n_pad, device=dev)
        weights[:n] = data.m_init
        heap = ts.init(weights)
        for x in fit.indices.tolist():
            weights, tsums = open_center(weights, x)
            heap = ts.refresh(heap, tsums)
        return weights, heap

    def open_plain(weights, x):
        for ti in range(t - 1):
            weights = ref.tree_sep_update_ref(lo[ti], hi[ti], lo[ti, :, x],
                                              hi[ti, :, x], weights,
                                              **sweep_kw)
        return ref.tree_sep_update_tiles_ref(
            lo[t - 1], hi[t - 1], lo[t - 1, :, x], hi[t - 1, :, x], weights,
            block_n=tile, **sweep_kw)

    # The kernels as the fit opens a center: one lane-form launch a tree.
    _, open_kernel, _, _ = ds._initial_state(
        data.codes_lo, data.codes_hi, scale=data.scale,
        num_levels=data.num_levels, m_init=data.m_init, tile=tile)
    w_k, heap_k = replay(open_kernel)
    w_p, heap_p = replay(open_plain)
    torch.cuda.synchronize()
    leaves = slice(ts.coarse.cap, ts.coarse.cap + ts.num_tiles)
    leaf_rel = float(((heap_k[leaves] - heap_p[leaves]).abs()
                      / heap_p[leaves].abs().clamp_min(1e-30)).max())
    node_rel = float((heap_k - heap_p).abs().max()) / (data.m_init * n)
    if not torch.equal(w_k, w_p) or leaf_rel > RTOL or node_rel > RTOL:
        raise AssertionError(f"replay: weights equal {torch.equal(w_k, w_p)}"
                             f", leaf rel {leaf_rel}, node rel {node_rel}")
    log(f"replay of the fit's {K} centers through the plain versions: weights "
        f"bit-identical; heap leaves max rel err {leaf_rel:.3g}, internal "
        f"nodes max abs err {node_rel:.3g} of the initial total (rtol {RTOL})")

    # Per-seed costs spread by about 8% (rejection) and 6% (k-means||)
    # here, so 64 seeds a side keep the 5% gate more than 3 standard errors
    # of the difference away.
    small = mixture()
    log(f"[{time.perf_counter() - t_start:.1f} s] small inputs")
    for seeder in ("rejection", "kmeans||"):
        costs = {}
        for where in ("cuda", "cpu"):
            vals = []
            for s in range(SMALL_SEEDS):
                p = ClusterPlan(ClusterSpec(k=24, seeder=seeder, c=1.2,
                                            quantize=False, seed=s),
                                ExecutionSpec(device=where))
                idx = p.fit(small).indices.cpu().numpy()
                vals.append(seeding.clustering_cost(small, small[idx]))
            costs[where] = float(np.mean(vals))
        ratio = costs["cuda"] / costs["cpu"]
        if abs(ratio - 1.0) > 0.05:
            raise AssertionError(f"small input, {seeder}: card/CPU mean "
                                 f"cost {ratio}")
        log(f"small input (n=1200, d=5, k=24, {SMALL_SEEDS} seeds), "
            f"{seeder}: mean cost on the card {costs['cuda']:.6g}, on the "
            f"CPU {costs['cpu']:.6g}, ratio {ratio:.4f} (within 5%)")

    log(f"[{time.perf_counter() - t_start:.1f} s] quality")
    # -- 7. quality, information only ------------------------------------------
    pts64 = torch.as_tensor(points, device=dev)
    t0 = time.perf_counter()
    exact = seeding.kmeanspp(points, K, np.random.default_rng(SEED),
                             device="cuda")
    exact_s = time.perf_counter() - t0
    quality = {
        "rejection": cost64(torch, pts64, pts64[fit.indices.long()]),
        "fastkmeans++": cost64(torch, pts64, pts64[fast_idx.long()]),
        "kmeans||": cost64(torch, pts64, pts64[km_fit.indices.long()]),
        "kmeans++": cost64(torch, pts64, pts64[torch.as_tensor(
            exact.indices, device=dev)]),
        "uniform": cost64(torch, pts64, pts64[torch.as_tensor(
            rng.choice(n, K, replace=False), device=dev)]),
    }
    log("quality (float64 cost, information only): " + ", ".join(
        f"{name} {v:.10g}" for name, v in quality.items())
        + f"; exact kmeans++ took {exact_s:.2f} s; rejection/kmeans++ "
        f"{quality['rejection'] / quality['kmeans++']:.4f}, "
        f"fastkmeans++/kmeans++ "
        f"{quality['fastkmeans++'] / quality['kmeans++']:.4f}, "
        f"kmeans||/kmeans++ "
        f"{quality['kmeans||'] / quality['kmeans++']:.4f}, "
        f"rejection/uniform {quality['rejection'] / quality['uniform']:.4f}")

    log(f"[{time.perf_counter() - t_start:.1f} s] kernel times")
    # -- 4. kernel times, at the main path's shapes ----------------------------
    rounds = collections.Counter()
    for res in (fit, refit):
        rounds.update(res.extras["rounds_per_batch"])
    b_main = rounds.most_common(1)[0][0]
    count_main = K // 2                  # mean live centers over a fit
    centers_args = center_slots(count_main)
    penalty = ops.penalty_row(K, count_main, dev)   # the plain version's

    def lsh_inputs(b):
        """B candidates of the path's law against `count_main` live of the
        K slots: the kernel's seven inputs and the colliding pairs."""
        cand = ts.sample(coarse, w, gen, b)
        args = (klo[:, cand], khi[:, cand], pts_pad[cand]) + \
            centers_args + (w[cand],)
        collide = ((args[0][:, :, None] == args[3][:, None, :count_main])
                   & (args[1][:, :, None] == args[4][:, None, :count_main])
                   ).any(dim=0)
        return args, int(collide.sum())

    def lsh_bound(b, n_pairs, accept):
        """Each live input read once (no slot past the count is an input
        of the function; the accept's lane form also reads an int64 lane
        a candidate), each output written once; key compares, q.c for
        colliding pairs, |q|^2 and |c|^2, the epilogue."""
        return bound(
            4 * (2 * l * b + b * D + 2 * l * count_main + count_main * D
                 + (5 if accept else 1) * b),
            b * count_main * 2 * l + n_pairs * 2 * D
            + (b + count_main) * 2 * D + (6 if accept else 1) * b)

    lsh_args, n_collide = lsh_inputs(b_main)
    lane_lsh_args = one_lane(lsh_args)
    # Rows 1 to 3 time the call forms a fit launches (one lane of the lane
    # axis); the plain version of one lane is the solo plain version.
    cols = [(lo[ti], hi[ti], lo[ti, :, x], hi[ti, :, x]) for ti in range(t)]
    times = {
        "tree_sep_update": (
            lambda i: sweep_cuda.launch_lanes(lo1[:, i % t], hi1[:, i % t],
                                              x1, w1, **sweep_kw),
            lambda i: ref.tree_sep_update_ref(*cols[i % t], w, **sweep_kw)),
        "tree_sep_update_tiles": (
            lambda i: sweep_cuda.launch_tiles_lanes(
                lo1[:, i % t], hi1[:, i % t], x1, w1, tile=tile, **sweep_kw),
            lambda i: ref.tree_sep_update_tiles_ref(*cols[i % t], w,
                                                    block_n=tile,
                                                    **sweep_kw)),
        "lsh_bucket_accept": (
            lambda i: lsh_cuda.launch_lanes(*lane_lsh_args, count=count_main,
                                            c2=c2),
            lambda i: ref.lsh_bucket_accept_penalty_ref(
                *lsh_args[:6], penalty, lsh_args[6], c2=c2)),
        "lsh_bucket_min": (
            lambda i: lsh_cuda.launch_min(*lsh_args[:6], count=count_main),
            lambda i: ref.lsh_bucket_min_penalty_ref(*lsh_args[:6],
                                                     penalty)),
        "pairwise_argmin": (
            lambda i: pam_cuda.launch(x_km, slots_all_pad),
            lambda i: ref.pairwise_argmin_ref(x_km, slots_all_pad)),
        "d2_update": (
            lambda i: d2_cuda.launch(x_km, ctr_km, w_km),
            lambda i: ref.d2_update_ref(x_km, ctr_km, w_km)),
        "d2_update_tiles": (
            lambda i: d2_cuda.launch_tiles(x_km, ctr_km, w_km, tile=tile),
            lambda i: ref.d2_update_tiles_ref(x_km, ctr_km, w_km,
                                              block_n=tile)),
    }
    iters = {"pairwise_argmin": (10, 3)}     # (kernel, plain); else 300, 100
    # Kernels of a few microseconds: their `ms` is a CUDA graph of 100
    # launches replayed (the card's time), the loop's time printed beside.
    graphed = {"tree_sep_update", "tree_sep_update_tiles",
               "lsh_bucket_accept", "lsh_bucket_min", "d2_update",
               "d2_update_tiles"}

    def cdist_min(centers):
        """The closest library form: two calls, TF32 off."""
        def call(i):
            with ref.full_f32_matmul():
                return torch.cdist(x_km, centers, compute_mode=(
                    "use_mm_for_euclid_dist")).min(dim=1)
        return call

    library = {"pairwise_argmin": (cdist_min(slots_all), 3)}
    slots_all_pad = ops._pad_to(slots_all, 0, pam_cuda.BLOCK_K, ops._PAD_FAR)
    # The lane form reads the codes, the center column within them, the
    # weights and the int64 point; it writes w'.
    sweep_bytes = 4 * (2 * h * ts.n_pad + 2 * h + 2 * ts.n_pad) + 8
    sweep_ops = ts.n_pad * (4 * h + 6)
    bounds = {
        "tree_sep_update": bound(sweep_bytes, sweep_ops),
        "tree_sep_update_tiles": bound(sweep_bytes + 4 * ts.num_tiles,
                                       sweep_ops + ts.n_pad),
        "lsh_bucket_accept": lsh_bound(b_main, n_collide, True),
        "lsh_bucket_min": lsh_bound(b_main, n_collide, False),
        # The function's own work at f32 accuracy on the tensor cores
        # (3xTF32: three products): n points against 8,000 live slots, not
        # the kernel's padding.
        "pairwise_argmin": bound(4 * (N * D + KMP_CAP * D + 2 * N),
                                 3 * 2 * N * KMP_CAP * D, TF32_OPS_PER_S),
        "d2_update": d2_bound(N, D, 4),
        "d2_update_tiles": d2_bound(N, D, 4, tile),
    }
    main_launches = dict(launches,
                         pairwise_argmin=km_launches["pairwise_argmin"])
    rows, loop_ms = [], {}
    for name, (kernel, plain_fn) in times.items():
        k_iters, p_iters = iters.get(name, (300, 100))
        if name in graphed:
            loop_ms[name] = cuda_ms(torch, kernel, k_iters)
            ms = graph_ms(torch, kernel, 100)
            plain_ms = cuda_ms(torch, plain_fn, p_iters)
            ms_again = graph_ms(torch, kernel, 100)
        else:
            ms = cuda_ms(torch, kernel, k_iters)
            plain_ms = cuda_ms(torch, plain_fn, p_iters)
            ms_again = cuda_ms(torch, kernel, k_iters)
        lib_ms = None
        if name in library:
            lib_ms = cuda_ms(torch, *library[name])
        b_ms, b_by = bounds[name]
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": main_launches[name],
                     "max_abs_err": errs[name], "ms": min(ms, ms_again),
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
        how = (f" as a CUDA graph ({loop_ms[name]:.6f} ms in a loop of "
               f"launches from Python)" if name in graphed else "")
        log(f"time {name}: kernel {ms:.6f} / {ms_again:.6f} ms{how}, plain "
            f"{plain_ms:.6f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}, bound "
            f"{b_ms:.6f} ms ({b_by}), {b_ms / min(ms, ms_again):.3f} of "
            "the bound")
    # pairwise_argmin beyond row (a): (b) the path's launch, over one
    # round's live slots, (c) the bf16 route at (a)'s shape.
    slots_pad = ops._pad_to(slots, 0, pam_cuda.BLOCK_K, ops._PAD_FAR)
    live_b = lambda i: pam_cuda.launch(x_km, slots_pad, live)
    ms_b = min(cuda_ms(torch, live_b, 20), cuda_ms(torch, live_b, 20))
    plain_b = cuda_ms(torch, lambda i: ref.pairwise_argmin_ref(
        x_km, slots_pad, live), 3)
    lib_b = cuda_ms(torch, cdist_min(slots[:live_slots]), 3)
    b_b, b_b_by = bound(4 * (N * D + live_slots * D + 2 * N),
                        3 * 2 * N * live_slots * D, TF32_OPS_PER_S)
    x_bf, all_bf = x_km.bfloat16(), slots_all_pad.bfloat16()
    bf16_c = lambda i: pam_cuda.launch(x_bf, all_bf)
    ms_c = min(cuda_ms(torch, bf16_c, 10), cuda_ms(torch, bf16_c, 10))
    b_c, b_c_by = bound(2 * (N * D + KMP_CAP * D) + 8 * N,
                        2 * N * KMP_CAP * D, BF16_OPS_PER_S)
    row_a = next(r for r in rows if r["name"] == "pairwise_argmin")
    log(f"time pairwise_argmin (a) f32, all {KMP_CAP} slots live: kernel "
        f"{row_a['ms']:.6f} ms, bound {row_a['bound_ms']:.6f} ms "
        f"({row_a['bound_by']}: 3xTF32 at 495 TFLOP/s; "
        f"{2 * N * KMP_CAP * D / F32_OPS_PER_S * 1e3:.6f} ms at the 67 "
        f"TFLOP/s f32 rate, the basis before this kernel), "
        f"{row_a['bound_ms'] / row_a['ms']:.4f} of the bound")
    log(f"time pairwise_argmin (b) f32, the path's launch over the round's "
        f"{live_slots} live slots of {KMP_CAP}: kernel {ms_b:.6f} ms, plain "
        f"{plain_b:.6f} ms, library (cdist + min over the {live_slots} live "
        f"slots, TF32 off) {lib_b:.6f} ms, bound {b_b:.6f} ms ({b_b_by}; "
        f"{2 * N * live_slots * D / F32_OPS_PER_S * 1e3:.6f} ms at the f32 "
        f"rate), {b_b / ms_b:.4f} of the bound")
    log(f"time pairwise_argmin (c) the bf16 route at (a)'s shape: kernel "
        f"{ms_c:.6f} ms, bound {b_c:.6f} ms ({b_c_by}: one product at 989 "
        f"TFLOP/s), {b_c / ms_c:.4f} of the bound")
    del x_bf, all_bf
    d2_shapes(torch, ops, ref, d2_cuda, x_km, tile)
    # The ladder's lowest rung: the new kernel spreads the slots over the
    # card, so B = 32 should take no longer than the path's block.
    args32, pairs32 = lsh_inputs(32)
    lane32 = one_lane(args32)
    acc32 = lambda i: lsh_cuda.launch_lanes(*lane32, count=count_main, c2=c2)
    ms32 = min(graph_ms(torch, acc32, 100), graph_ms(torch, acc32, 100))
    plain32 = cuda_ms(torch, lambda i: ref.lsh_bucket_accept_penalty_ref(
        *args32[:6], penalty, args32[6], c2=c2), 100)
    b32_ms, b32_by = lsh_bound(32, pairs32, True)
    log(f"time lsh_bucket_accept at B=32 ({count_main} live of {K} slots, "
        f"{pairs32} colliding pairs): kernel {ms32:.6f} ms as a CUDA graph "
        f"({cuda_ms(torch, acc32, 300):.6f} ms in a loop of launches from "
        f"Python), plain {plain32:.6f} ms, bound {b32_ms:.6f} ms ({b32_by})")
    # The path's rounds see every live count from 0 to K: the kernel's time
    # at the path's block over the counts, against its mean on the path
    # (phase 8).
    by_count = {}
    for live in range(K // 10, K + 1, K // 10):
        args_live = one_lane(lsh_args[:3] + center_slots(live)
                             + lsh_args[6:])
        by_count[live] = graph_ms(torch, lambda i: lsh_cuda.launch_lanes(
            *args_live, count=live, c2=c2), 50)
    log(f"time lsh_bucket_accept at B={b_main} by live count (CUDA graph): "
        + ", ".join(f"{live}: {ms:.6f}" for live, ms in by_count.items())
        + f" ms; mean {sum(by_count.values()) / len(by_count):.6f} ms")
    log(f"  (sweeps: one lane as a fit launches them, H-1={h}, "
        f"n_pad={ts.n_pad}, trees in turn so the code planes do not sit in "
        f"L2; lsh_bucket_accept: one lane as a fit launches it, B={b_main}, "
        f"the main "
        f"path's most used block, {count_main} live of {K} slots, "
        f"{n_collide} colliding pairs, and lsh_bucket_min on the same "
        f"inputs; pairwise_argmin: {N} x {KMP_CAP} x {D}, the slots padded "
        f"to {slots_all_pad.shape[0]}, every slot live, library = "
        f"torch.cdist(use_mm_for_euclid_dist) + min in full f32; "
        f"d2_update and d2_update_tiles: n={N}, d={D}, f32, the tiles "
        f"entry on the unpadded rows, its outputs padded to "
        f"{-(-N // tile) * tile})")
    log("clocks/power after timing: " + smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu"))

    log(f"[{time.perf_counter() - t_start:.1f} s] idle share")
    # -- 8. idle share over a solve ----------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    # The main path's refit(seed=1) again, traced: one seed gives the same
    # draws, so both run the same rounds, and the untraced wall time shows
    # what the tracing costs.
    bare = refit
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = plan.refit(seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    traced_launches = ops.launch_counts()["lsh_bucket_accept"]
    if not torch.equal(bare.indices, profiled.indices):
        raise AssertionError("refit(seed=1) opened other centers when traced")
    busy, n_events, by_name = device_time(torch, prof)
    log(f"idle share: {1 - busy / wall:.4f} (device busy {busy:.4f} s over "
        f"{n_events} device events in the traced refit(seed=1), whose "
        f"wall time was {wall:.4f} s); the same solve untraced took "
        f"{bare.solve_seconds:.4f} s with the same centers, an idle share "
        f"of {1 - busy / bare.solve_seconds:.4f} if its device time was the "
        f"traced run's; cost "
        f"{float(profiled.cost):.9g}")
    log_top(by_name, 8)

    def lsh_device_ms(names: dict) -> tuple:
        """(device ms, kernels) of the LSH query's two kernels in a trace."""
        hits = [v for name, v in names.items()
                if "lsh_query_kernel" in name or "lsh_finish_kernel" in name]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    path_ms, path_kernels = lsh_device_ms(by_name)
    timed = next(r for r in rows if r["name"] == "lsh_bucket_accept")
    log(f"lsh_bucket_accept on the traced path: {traced_launches} launches "
        f"({path_kernels} kernels) took {path_ms:.3f} ms of device time, "
        f"{path_ms / max(traced_launches, 1):.6f} ms per launch over the "
        f"path's blocks and live counts; timed at B={b_main} with "
        f"{count_main} live: {timed['ms']:.6f} ms as a CUDA graph, "
        f"{loop_ms['lsh_bucket_accept']:.6f} ms in a loop of launches")
    # The same launch traced back to back and alone between idle gaps, as
    # the path issues it: whether an idle card runs it slower.
    for label, gap in (("back to back", 0.0), ("between 2 ms gaps", 0.002)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                lsh_cuda.launch_lanes(*lane_lsh_args, count=count_main, c2=c2)
                if gap:
                    torch.cuda.synchronize()
                    time.sleep(gap)
            torch.cuda.synchronize()
        ms_50, kernels_50 = lsh_device_ms(device_time(torch, prof)[2])
        log(f"  traced at B={b_main} with {count_main} live, 50 launches "
            f"{label}: {ms_50 / 50:.6f} ms of device time per launch "
            f"({kernels_50} kernels)")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB; {time.perf_counter() - t_start:.1f} s so far")
    # Phases 8b to 8g at k = KS: phase 8's plans over their prepared data
    # at that k, and their fit and refit(seed=1) (the same draws) as the
    # references of the later phases
    mark("8b")
    plan_s, km_plan_s = at_k(plan, KS), at_k(plan_km, KS)
    fit_s, refit_s = plan_s.refit(), plan_s.refit(seed=1)
    km_fit_s = km_plan_s.refit()
    log(f"[{time.perf_counter() - t_start:.1f} s] phases 8b to 8g at k={KS}"
        f": phase 8's plans at k={KS} over their prepared data, fit "
        f"{fit_s.solve_seconds:.3f} s and refit(seed=1) "
        f"{refit_s.solve_seconds:.3f} s (rejection), fit "
        f"{km_fit_s.solve_seconds:.3f} s (k-means||)")
    stacked_plan, lane_costs = other_entry_points(
        torch, t_start, points, plan_s, fit_s, km_fit_s, t)
    by_path = {"main": launches, "kmeans||": km_launches}
    mark("8d")
    by_path["streaming"] = streaming(torch, t_start, points)
    mark("8e")
    by_path["engine"] = engine_phase(torch, t_start, points, plan_s, fit_s,
                                     refit_s, km_fit_s, t)
    mark("8f")
    by_path["service"] = service_phase(torch, t_start, points, stacked_plan)
    mark("8g")
    by_path["sharded"] = sharded_phase(torch, t_start, points, plan_s, fit_s,
                                       km_fit_s, lane_costs, (fit, refit), t)
    for row in rows:
        row["launches_by_path"] = {path: counts.get(row["name"], 0)
                                   for path, counts in by_path.items()}
    return rows


def other_entry_points(torch, t_start, points, plan, fit, km_fit, t):
    """Phase 8b on the same data: the legacy `fit` of the three device
    seeders against `ClusterPlan.fit` on the same seed, `fit_batch` over
    four seeds against solo refits, `no_retrace` around one refit, and
    the cpu backend's six seeders on the host at a tenth of n.  Returns
    phase 8c's plan, its canonical lanes prepared, and the costs of the
    `fit_batch(seeds=[0, 1, 2, 3])` lanes by seeder."""
    import warnings

    from repro_torch.core import (TRACE_COUNTS, ClusterPlan, ClusterSpec,
                                  ExecutionSpec, KMeansConfig, no_retrace,
                                  seeding)
    from repro_torch.core import fit as legacy_fit
    from repro_torch.kernels import ops

    log(f"[{time.perf_counter() - t_start:.1f} s] the legacy fit")
    sweeps = {"tree_sep_update": (t - 1) * KS, "tree_sep_update_tiles": KS}
    plan_fast = ClusterPlan(ClusterSpec(k=KS, seeder="fastkmeans++",
                                        seed=SEED),
                            ExecutionSpec(backend="device"))
    fast_fit = plan_fast.fit(points)
    plan_idx = {"rejection": fit.indices, "fastkmeans++": fast_fit.indices,
                "kmeans||": km_fit.indices}
    for seeder, want in plan_idx.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            km = legacy_fit(points, KMeansConfig(k=KS, seeder=seeder,
                                                 seed=SEED))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        expect = ({"pairwise_argmin": KMP_ROUNDS} if seeder == "kmeans||"
                  else dict(sweeps))
        if seeder == "rejection":
            expect["lsh_bucket_accept"] = max(counts["lsh_bucket_accept"],
                                              KS - 1)
        if counts != dict({name: 0 for name in counts}, **expect):
            raise AssertionError(f"legacy fit {seeder}: launches {counts}, "
                                 f"expected {expect}")
        if not np.array_equal(km.seeding.indices, want.cpu().numpy()):
            raise AssertionError(f"legacy fit {seeder}: other indices than "
                                 "ClusterPlan.fit on the same seed")
        if km.centers.shape != (KS, D) or not math.isfinite(km.cost):
            raise AssertionError(f"legacy fit {seeder}: cost {km.cost}")
        log(f"  legacy fit {seeder}: {seconds:.3f} s (prepare "
            f"{km.seeding.prepare_seconds:.3f} s, solve "
            f"{km.seeding.solve_seconds:.3f} s, the rest the host's "
            f"quantisation and float64 cost {km.cost:.10g}); "
            f"launches={counts}; the same {KS} indices as ClusterPlan.fit")

    log(f"[{time.perf_counter() - t_start:.1f} s] fit_batch(seeds) and "
        "no_retrace")
    lane_costs = {seeder: fit_batch_seeds(torch, ops, seeder, p, first,
                                          sweeps)
                  for seeder, p, first in (("rejection", plan, fit),
                                           ("fastkmeans++", plan_fast,
                                            fast_fit))}
    builds = {name: v for name, v in TRACE_COUNTS.items()
              if name.startswith("build/")}
    with no_retrace():
        plan.refit(seed=5)
        torch.cuda.synchronize()
    log(f"  no_retrace() held around refit(seed=5); "
        f"builds counted in this process: {builds}")
    mark("8c")
    stacked_plan = stacked_lanes(torch, t_start)

    # The cpu backend: host NumPy seeders, as in the JAX package; only the
    # gather and the f32 cost of each FitResult run on the card.
    n_cpu = N // 10
    sub = points[:n_cpu]
    log(f"[{time.perf_counter() - t_start:.1f} s] the cpu backend at n="
        f"{n_cpu} (the first tenth of the rows), d={D}, k={KS}; host times")
    costs = {}
    for seeder in ("kmeans++", "fastkmeans++", "rejection", "kmeans||",
                   "afkmc2", "uniform"):
        ops.reset_launch_counts()
        res = ClusterPlan(ClusterSpec(k=KS, seeder=seeder, seed=SEED),
                          ExecutionSpec(backend="cpu")).fit(sub)
        idx = res.indices.cpu().numpy()
        costs[seeder] = seeding.clustering_cost(sub, sub[idx])
        rel = abs(float(res.cost) - costs[seeder]) / costs[seeder]
        if not (res.indices.is_cuda and len(np.unique(idx)) == KS
                and idx.min() >= 0 and idx.max() < n_cpu and rel < 1e-3
                and sum(ops.launch_counts().values()) == 0):
            raise AssertionError(f"cpu backend {seeder}: indices, cost "
                                 f"{float(res.cost)} against {costs[seeder]}"
                                 f" or launches {ops.launch_counts()}")
        log(f"  cpu {seeder}: host prepare {res.prepare_seconds:.3f} s, "
            f"solve {res.solve_seconds:.3f} s (the host seeder, then the "
            f"card's gather and f32 cost), float64 cost "
            f"{costs[seeder]:.10g} ({costs[seeder] / costs['kmeans++']:.4f} "
            "of exact kmeans++); no kernel launched")
    return stacked_plan, lane_costs


def fit_batch_seeds(torch, ops, seeder, plan, first, sweeps) -> list:
    """`fit_batch(seeds=[0, 1, 2, 3])` on a prepared full-width plan: one
    lane-batched solve (each sweep launched once a center for the four
    lanes, the accept kernel once a round for the lanes still drawing),
    each lane bit-identical to `refit(seed=s)` and lane 0 to the fit; its
    time beside the four refits'.  Returns the lanes' costs."""
    seeds = [0, 1, 2, 3]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    batch = plan.fit_batch(seeds=seeds)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    batch_counts = ops.launch_counts()
    lane_lsh, refit_s = [], 0.0
    for i, s in enumerate(seeds):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lane = plan.refit(seed=s)
        torch.cuda.synchronize()
        refit_s += time.perf_counter() - t0
        lane_lsh.append(ops.launch_counts()["lsh_bucket_accept"])
        same = (torch.equal(batch.indices[i], lane.indices)
                and torch.equal(batch.centers[i], lane.centers)
                and torch.equal(batch.cost[i], lane.cost))
        if seeder == "rejection":
            same = same and torch.equal(batch.extras["trials"][i],
                                        lane.extras["trials"])
        if not same:
            raise AssertionError(f"fit_batch {seeder} lane {i} differs from "
                                 f"refit(seed={s})")
    if not torch.equal(batch.indices[0], first.indices):
        raise AssertionError(f"fit_batch {seeder} lane 0 (the spec's seed) "
                             "differs from the fit")
    want = dict({name: 0 for name in batch_counts}, **sweeps)
    lsh = batch_counts["lsh_bucket_accept"]
    want["lsh_bucket_accept"] = lsh
    if batch_counts != want or batch.extras.get("vmapped") is not True or (
            seeder == "rejection"
            and not max(lane_lsh) <= lsh <= sum(lane_lsh)) or (
            seeder != "rejection" and lsh != 0):
        raise AssertionError(f"fit_batch {seeder} launches {batch_counts}, "
                             f"expected the sweeps {sweeps} and "
                             f"lsh_bucket_accept in [{max(lane_lsh)}, "
                             f"{sum(lane_lsh)}] (the refits' {lane_lsh})")
    log(f"  fit_batch(seeds={seeds}) on the {seeder} plan, one lane-batched "
        f"solve: {batch_s:.3f} s (solve_seconds {batch.solve_seconds:.3f}); "
        f"the four refits {refit_s:.3f} s in all, "
        f"{refit_s / batch_s:.3f} times the batch; launches={batch_counts} "
        f"(the refits' lsh_bucket_accept {lane_lsh}, sum "
        f"{sum(lane_lsh)}); each lane bit-identical to refit(seed=s), lane 0 "
        f"to the fit; costs {[round(float(c), 1) for c in batch.cost]}")
    return [float(c) for c in batch.cost]


def stacked_lanes(torch, t_start):
    """Phase 8c: `fit_batch(datasets=...)` of the rejection seeder at full
    width, then the lane axis of the three kernels on its lanes.  Returns
    the plan, its canonical lanes prepared."""
    from repro_torch.core.batch_schedule import shape_bucket
    from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
    from repro_torch.core.sample_tree import TiledSampleTree
    from repro_torch.kernels import lsh_bucket_accept_cuda as lsh_cuda
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tree_sep_update_cuda as sweep_cuda

    dev = torch.device("cuda")
    log(f"[{time.perf_counter() - t_start:.1f} s] fit_batch(datasets=...) "
        f"at full width, d={D}, k={KS}, rejection")
    datasets = [kddcup_shaped(SEED), kddcup_shaped(SEED + 1),
                kddcup_shaped(SEED + 2)[:STACK_SMALL]]
    plan = ClusterPlan(ClusterSpec(k=KS, seeder="rejection", seed=SEED),
                       ExecutionSpec(backend="device"))
    preps = [plan.prepare_stacked(x) for x in datasets]
    log("  prepare_stacked (the canonical lanes): " + ", ".join(
        f"n={p.artifacts.n_real} in {p.artifacts.arrays[0].shape[-1]} rows "
        f"{p.prepare_seconds:.3f} s" for p in preps)
        + f"; statics (scale, num_levels, m_init) {preps[0].artifacts.statics}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    batch = plan.fit_batch(datasets=datasets)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    ex = batch.extras
    tile = plan.execution.tile
    rows = [shape_bucket(r, min_bucket=max(1024, tile))
            for r in (N, N, STACK_SMALL)]          # 524,288 and 262,144
    want = {"stacked": True, "vmapped": True, "shape_buckets": 2,
            "lane_rows": (N, N, STACK_SMALL), "bucket_rows": tuple(rows)}
    if any(ex[key] != v for key, v in want.items()):
        raise AssertionError(f"fit_batch(datasets=...) extras {ex}")
    t = preps[0].artifacts.arrays[0].shape[0]
    solo_lsh, solo_s = [], []
    for i, x in enumerate(datasets):
        ops.reset_launch_counts()
        solo = plan.fit_batch(datasets=[x])
        torch.cuda.synchronize()
        solo_lsh.append(ops.launch_counts()["lsh_bucket_accept"])
        solo_s.append(solo.solve_seconds)
        idx = batch.indices[i]
        pts64 = torch.as_tensor(x, device=dev)
        exact = cost64(torch, pts64, pts64[idx.long()])
        rel = abs(float(batch.cost[i]) - exact) / exact
        if not (torch.equal(idx, solo.indices[0])
                and torch.equal(batch.cost[i], solo.cost[0])
                and torch.equal(ex["trials"][i], solo.extras["trials"][0])):
            raise AssertionError(f"fit_batch(datasets=...) lane {i} differs "
                                 "from its one-lane stacked fit")
        if int(idx.min()) < 0 or int(idx.max()) >= len(x) or \
                len(torch.unique(idx)) != KS or rel > 1e-4:
            raise AssertionError(f"fit_batch(datasets=...) lane {i}: "
                                 f"indices or cost {float(batch.cost[i])} "
                                 f"against {exact} in float64")
        del pts64
    lsh = counts["lsh_bucket_accept"]
    groups = (max(solo_lsh[:2]) + solo_lsh[2], sum(solo_lsh))
    if counts != dict({name: 0 for name in counts},
                      tree_sep_update=2 * (t - 1) * KS,
                      tree_sep_update_tiles=2 * KS, lsh_bucket_accept=lsh) \
            or not groups[0] <= lsh <= groups[1]:
        raise AssertionError(f"fit_batch(datasets=...) launches {counts}, "
                             f"expected two solves of {(t - 1) * KS} and {KS} "
                             f"sweeps and lsh_bucket_accept in {groups}")
    log(f"  fit_batch(datasets=[kddcup_shaped(0), kddcup_shaped(1), "
        f"kddcup_shaped(2)[:{STACK_SMALL}]]): solve {batch_s:.3f} s "
        f"(solve_seconds {batch.solve_seconds:.3f}) in {ex['shape_buckets']}"
        f" shape buckets, lane_rows {ex['lane_rows']}, bucket_rows "
        f"{ex['bucket_rows']}; launches={counts} (the one-lane fits' "
        f"lsh_bucket_accept {solo_lsh}, their solves "
        f"{[round(v, 3) for v in solo_s]} s, {sum(solo_s):.3f} s in all, "
        f"{sum(solo_s) / batch_s:.3f} times the batch); trials per center "
        f"{[round(float(v.sum()) / KS, 3) for v in ex['trials']]}; each "
        "lane bit-identical to its "
        "one-lane stacked fit, indices below its n_real, cost in original "
        f"coordinates within 1e-4 of float64: "
        f"{[round(float(c), 1) for c in batch.cost]}")

    # -- the lane axis: B = 4 lanes (the two KDD-Cup-shaped lanes twice) in
    # the 524,288 bucket, H = 12, d = 74, mid-solve weights.
    log(f"[{time.perf_counter() - t_start:.1f} s] the lane axis of the "
        f"kernels, B=4 in the {rows[0]} bucket")
    lanes4 = [preps[j % 2].artifacts for j in range(4)]
    lo4, hi4, pts4, klo4, khi4 = (torch.stack([a.arrays[m] for a in lanes4])
                                  for m in range(5))
    scale, num_levels, m_init = lanes4[0].statics
    kw = dict(scale=scale, num_levels=num_levels)
    b, t, h, n = lo4.shape
    l = klo4.shape[1]
    ts = TiledSampleTree(n, tile=tile)
    rng = np.random.default_rng(SEED + 21)
    w4 = torch.zeros(b, n, device=dev)
    w4[:, :N] = m_init
    for _ in range(8):                       # weights mid-solve
        xr = torch.as_tensor(rng.integers(0, N, b), device=dev)
        for ti in range(t):
            w4 = ref.tree_sep_update_lanes_ref(lo4[:, ti], hi4[:, ti], xr, w4,
                                               **kw)
    x4 = torch.as_tensor(rng.integers(0, N, b), device=dev)
    codes = {"per-lane codes": (lo4, hi4),
             "shared codes (stride 0)": (lo4[0].expand(b, t, h, n),
                                         hi4[0].expand(b, t, h, n))}
    for label, (lo, hi) in codes.items():
        out = ops.tree_sep_update_lanes(lo[:, 0], hi[:, 0], x4, w4, **kw)
        tout, tsums = ops.tree_sep_update_tiles_lanes(
            lo[:, t - 1], hi[:, t - 1], x4, w4, block_n=tile, **kw)
        plain = ref.tree_sep_update_lanes_ref(lo[:, 0], hi[:, 0], x4, w4,
                                              **kw)
        pout, psums = ref.tree_sep_update_tiles_lanes_ref(
            lo[:, t - 1], hi[:, t - 1], x4, w4, block_n=tile, **kw)
        same = []
        for j, xj in enumerate(x4.tolist()):
            one = ops.tree_sep_update(lo[j, 0], hi[j, 0], lo[j, 0, :, xj],
                                      hi[j, 0, :, xj], w4[j], **kw)
            one_t, one_s = ops.tree_sep_update_tiles(
                lo[j, t - 1], hi[j, t - 1], lo[j, t - 1, :, xj],
                hi[j, t - 1, :, xj], w4[j], block_n=tile, **kw)
            same.append(torch.equal(out[j], one) and torch.equal(tout[j], one_t)
                        and torch.equal(tsums[j], one_s))
        # B = 1, timed below: lane 0 alone against the plain version.
        same.append(torch.equal(ops.tree_sep_update_lanes(
            lo[:1, 0], hi[:1, 0], x4[:1], w4[:1], **kw), plain[:1]))
        torch.cuda.synchronize()
        rel = float(((tsums - psums).abs()
                     / psums.abs().clamp_min(1e-30)).max())
        if not (torch.equal(out, plain) and torch.equal(tout, pout)
                and rel <= RTOL and all(same)):
            raise AssertionError(f"lane-axis sweeps, {label}: plain equal "
                                 f"{torch.equal(out, plain)}, "
                                 f"{torch.equal(tout, pout)}, tile sums rel "
                                 f"{rel}, lanes equal to solo launches and "
                                 f"B=1 to the plain version {same}")
        log(f"  tree_sep_update and _tiles, lane axis, {label}: w' "
            f"bit-identical to the plain version and, lane by lane, to the "
            f"solo launch, and at B=1 to the plain version; tile sums max "
            f"rel err {rel:.3g} of the plain "
            f"ones (rtol {RTOL}), bit-identical to the one-lane launch")

    count = K // 2
    c2 = plan.cluster.c ** 2
    every = torch.arange(b, device=dev)
    heaps = torch.stack([ts.init(w4[j].clone()) for j in range(b)])
    cidx = torch.as_tensor(rng.integers(0, N, (b, count)), device=dev)
    ctr = torch.full((b, K, D), 1.0e17, device=dev)
    ctr[:, :count] = pts4[every[:, None], cidx]
    ck_lo = torch.zeros((b, l, K), dtype=torch.int32, device=dev)
    ck_hi = torch.zeros_like(ck_lo)
    ck_lo[:, :, :count] = torch.gather(klo4, 2, cidx[:, None].expand(
        b, l, count))
    ck_hi[:, :, :count] = torch.gather(khi4, 2, cidx[:, None].expand(
        b, l, count))
    penalty = ops.penalty_row(K, count, dev)

    def lsh_lane_inputs(sizes):
        lanes = torch.as_tensor(np.repeat(np.arange(b), sizes), device=dev)
        gens = [torch.Generator(device=dev).manual_seed(SEED + j)
                for j in range(b)]
        cand = ts.sample_lanes(heaps, w4, gens, list(sizes), lanes)
        args = (klo4.transpose(0, 1)[:, lanes, cand],
                khi4.transpose(0, 1)[:, lanes, cand], pts4[lanes, cand],
                lanes, ck_lo, ck_hi, ctr, w4[lanes, cand])
        pairs = [int(((args[0][:, lanes == j][:, :, None]
                       == ck_lo[j, :, None, :count])
                      & (args[1][:, lanes == j][:, :, None]
                         == ck_hi[j, :, None, :count])).any(dim=0).sum())
                 for j in range(b)]
        return args, pairs

    lsh_err = 0.0
    for sizes in ((512,) * b, (32, 512, 128, 256)):
        args, pairs = lsh_lane_inputs(sizes)
        d2, p = ops.lsh_bucket_accept_lanes(*args, count, c2=c2)
        pd2, pp = ref.lsh_bucket_accept_lanes_penalty_ref(
            *args[:7], penalty, args[7], c2=c2)
        same, start = [], 0
        for j, size in enumerate(sizes):
            seg = slice(start, start + size)
            one = ops.lsh_bucket_accept(
                args[0][:, seg].contiguous(), args[1][:, seg].contiguous(),
                args[2][seg], ck_lo[j], ck_hi[j], ctr[j], args[7][seg],
                count, c2=c2)
            same.append(torch.equal(d2[seg], one[0])
                        and torch.equal(p[seg], one[1]))
            start += size
        torch.cuda.synchronize()
        miss = pd2 == ref.LSH_MISS
        hit = ~miss
        err = max(float((d2 - pd2)[hit].abs().max()) if hit.any() else 0.0,
                  float((p - pp).abs().max()))
        lsh_err = max(lsh_err, err)
        if not (torch.equal(d2 == ref.LSH_MISS, miss) and all(same)
                and torch.allclose(d2[hit], pd2[hit], rtol=RTOL, atol=RTOL)
                and torch.allclose(p, pp, rtol=RTOL, atol=RTOL)):
            raise AssertionError(f"lane-axis lsh_bucket_accept at {sizes}: "
                                 f"err {err}, lanes equal to one-lane "
                                 f"launches {same}")
        log(f"  lsh_bucket_accept, lane axis, blocks {sizes} against "
            f"{count} live of {K} slots a lane ({sum(pairs)} colliding "
            f"pairs): max abs err {err:.3g} against the plain version (rtol "
            f"{RTOL}), {int(hit.sum())} hits; each lane bit-identical to "
            "its one-lane launch")

    # Times: a CUDA graph of 100 launches, best of two, beside the plain
    # version and the bound from the bytes (shared codes read once).
    def sweep_bound(lanes, shared, tiles):
        nbytes = 4 * 2 * h * n * (1 if shared else lanes) \
            + lanes * (4 * (2 * h + 2 * n) + 8)
        ops_ = lanes * n * (4 * h + 6)
        if tiles:
            nbytes += 4 * lanes * (n // tile)
            ops_ += lanes * n
        return bound(nbytes, ops_)

    def lsh_lanes_bound(sizes, pairs):
        nbytes = sum(4 * (2 * l * bj + bj * D + 3 * bj) + 8 * bj
                     for bj in sizes) + 4 * b * (2 * l * count + count * D)
        ops_ = sum(bj * count * 2 * l + pj * 2 * D + (bj + count) * 2 * D
                   + 6 * bj for bj, pj in zip(sizes, pairs))
        return bound(nbytes, ops_)

    args, pairs = lsh_lane_inputs((512,) * b)
    one = torch.zeros(512, dtype=torch.int64, device=dev)
    args1 = (args[0][:, :512].contiguous(), args[1][:, :512].contiguous(),
             args[2][:512], one, ck_lo[:1], ck_hi[:1], ctr[:1], args[7][:512])
    # B = 1, timed below: lane 0 alone against the plain version.
    d2, p = ops.lsh_bucket_accept_lanes(*args1, count, c2=c2)
    pd2, pp = ref.lsh_bucket_accept_lanes_penalty_ref(*args1[:7], penalty,
                                                      args1[7], c2=c2)
    hit = pd2 != ref.LSH_MISS
    if not (torch.equal(d2 != ref.LSH_MISS, hit)
            and torch.allclose(d2[hit], pd2[hit], rtol=RTOL, atol=RTOL)
            and torch.allclose(p, pp, rtol=RTOL, atol=RTOL)):
        raise AssertionError("lane-axis lsh_bucket_accept at B=1 x 512 "
                             "differs from the plain version")
    cases = []
    for label, (lo, hi) in codes.items():
        shared = label.startswith("shared")
        cases += [
            (f"tree_sep_update, B={b}, {label}",
             lambda i, lo=lo, hi=hi: sweep_cuda.launch_lanes(
                 lo[:, i % t], hi[:, i % t], x4, w4, **kw),
             lambda i, lo=lo, hi=hi: ref.tree_sep_update_lanes_ref(
                 lo[:, i % t], hi[:, i % t], x4, w4, **kw),
             sweep_bound(b, shared, False)),
            (f"tree_sep_update_tiles, B={b}, {label}",
             lambda i, lo=lo, hi=hi: sweep_cuda.launch_tiles_lanes(
                 lo[:, i % t], hi[:, i % t], x4, w4, tile=tile, **kw),
             lambda i, lo=lo, hi=hi: ref.tree_sep_update_tiles_lanes_ref(
                 lo[:, i % t], hi[:, i % t], x4, w4, block_n=tile, **kw),
             sweep_bound(b, shared, True))]
    cases += [
        ("tree_sep_update, B=1 (a solve of one dataset)",
         lambda i: sweep_cuda.launch_lanes(lo4[:1, i % t], hi4[:1, i % t],
                                           x4[:1], w4[:1], **kw),
         lambda i: ref.tree_sep_update_lanes_ref(
             lo4[:1, i % t], hi4[:1, i % t], x4[:1], w4[:1], **kw),
         sweep_bound(1, False, False)),
        (f"lsh_bucket_accept, B={b} x 512",
         lambda i: lsh_cuda.launch_lanes(*args, count=count, c2=c2),
         lambda i: ref.lsh_bucket_accept_lanes_penalty_ref(
             *args[:7], penalty, args[7], c2=c2),
         lsh_lanes_bound((512,) * b, pairs)),
        ("lsh_bucket_accept, B=1 x 512",
         lambda i: lsh_cuda.launch_lanes(*args1, count=count, c2=c2),
         lambda i: ref.lsh_bucket_accept_lanes_penalty_ref(
             *args1[:7], penalty, args1[7], c2=c2),
         lsh_lanes_bound((512,), pairs[:1]))]
    log(f"  lane-axis times on {smi('name,power.limit')}, n={n} rows a "
        f"lane, H-1={h}, d={D}, {count} live of {K} slots:")
    for label, kernel, plain_fn, (b_ms, b_by) in cases:
        ms = min(graph_ms(torch, kernel, 100), graph_ms(torch, kernel, 100))
        plain_ms = cuda_ms(torch, plain_fn, 5)
        log(f"time lane axis {label}: kernel {ms:.6f} ms as a CUDA graph of "
            f"100 launches, plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), {b_ms / ms:.3f} of the bound")
    log(f"  lane-axis max abs err against the plain versions: sweeps 0.0 "
        f"(bit-identical), lsh_bucket_accept {lsh_err:.3g}")
    return plan


def streaming(torch, t_start, points) -> dict:
    """Phase 8d: a stream at full width on the main path's data, through
    the device backend: `prepare_streaming` of the first rows, `extend`
    of the rest in batches (crossing a capacity rung), `retire` of a
    tenth, and refits over the live rows, each held to its checks.
    Returns the rejection refit's launch counts."""
    from repro_torch.core import device_seeding as ds
    from repro_torch.core.batch_schedule import shape_bucket
    from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rungs = (shape_bucket(STREAM_FIRST), shape_bucket(N))  # 262,144; 524,288
    log(f"[{time.perf_counter() - t_start:.1f} s] streaming at full width, "
        f"d={D}, k={KS}: prepare_streaming of {STREAM_FIRST} rows, extends "
        f"of {STREAM_BATCH}, retire of {STREAM_RETIRE}")
    retired = np.random.default_rng(SEED + 8).choice(N, STREAM_RETIRE,
                                                     replace=False)

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def history(seeder):
        plan = ClusterPlan(ClusterSpec(k=KS, seeder=seeder, seed=SEED),
                           ExecutionSpec(backend="device"))
        t0 = time.perf_counter()
        prep = plan.prepare_streaming(points[:STREAM_FIRST])
        prep_s = sync_s(t0)
        state = prep.streaming
        caps = [state.capacity]
        ext_s = []
        for lo in range(STREAM_FIRST, N, STREAM_BATCH):
            t0 = time.perf_counter()
            plan.extend(points[lo: lo + STREAM_BATCH], prepared=prep)
            ext_s.append(sync_s(t0))
            caps.append(state.capacity)
        t0 = time.perf_counter()
        plan.retire(retired, prepared=prep)
        ret_s = sync_s(t0)
        if (caps[0], caps[-1]) != rungs or \
                state.n_rows != N or state.rebuilds != 0 or \
                state.live_count != N - STREAM_RETIRE:
            raise AssertionError(f"stream {seeder}: capacities {caps}, rows "
                                 f"{state.n_rows}, rebuilds {state.rebuilds}"
                                 f", live {state.live_count}")
        log(f"  {seeder}: prepare_streaming {prep_s:.3f} s (capacity "
            f"{caps[0]}); {len(ext_s)} extends, median "
            f"{float(np.median(ext_s)):.4f} s a batch (max "
            f"{max(ext_s):.4f} s; capacity {caps[-1]} from extend "
            f"{caps.index(caps[-1])}); retire of {STREAM_RETIRE} rows "
            f"{ret_s:.4f} s; {state.live_count} live of {state.n_rows}")
        return plan, prep

    def check_weights(label, state):
        """`w0` is m_init on live rows and 0 on retired and padding rows,
        and the patched heap is `ts.init(w0)` bit for bit."""
        want = torch.zeros(state.ts.n_pad, device=dev)
        want[:state.capacity] = torch.as_tensor(
            state.live, dtype=torch.float32, device=dev) * state.statics[2]
        heap = state.ts.init(state.w0)
        if not (torch.equal(state.w0, want)
                and torch.equal(state.base_heap, heap)):
            raise AssertionError(f"{label}: w0 exact "
                                 f"{torch.equal(state.w0, want)}, heap equal "
                                 f"to ts.init(w0) "
                                 f"{torch.equal(state.base_heap, heap)}")

    def refit(label, plan, prep, seed, want):
        """A refit with the launch counts set to 0 just before and read
        just after; its indices live and distinct, its masked cost against
        float64 over the live rows."""
        state = prep.streaming
        ops.reset_launch_counts()
        res = plan.fit_prepared(prep, seed=seed)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        lsh = counts["lsh_bucket_accept"]
        lsh_ok = lsh >= KS - 1 if plan.cluster.seeder == "rejection" \
            else lsh == 0
        if counts != dict({name: 0 for name in counts}, **want,
                          lsh_bucket_accept=lsh) or not lsh_ok:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want} (and the accept)")
        idx = res.indices.cpu().numpy()
        pts64 = torch.as_tensor(state.host_pts[state.live_ids()], device=dev)
        exact = cost64(torch, pts64, torch.as_tensor(state.host_pts[idx],
                                                     device=dev))
        rel = abs(float(res.cost) - exact) / exact
        if not (state.live[idx].all() and len(np.unique(idx)) == KS
                and rel <= 1e-4 and res.extras["streaming"]):
            raise AssertionError(f"{label}: indices live "
                                 f"{state.live[idx].all()}, distinct "
                                 f"{len(np.unique(idx))}, cost "
                                 f"{float(res.cost)} against {exact}")
        rounds = (f", {lsh} accept rounds, trials per center "
                  f"{float(res.extras['trials'].sum()) / KS:.3f}"
                  if lsh else "")
        log(f"  {label}: solve {res.solve_seconds:.3f} s, cost "
            f"{float(res.cost):.9g} (float64 over the live rows "
            f"{exact:.10g}, rel {rel:.3g}); launches={counts}{rounds}; "
            f"indices live and distinct")
        del pts64
        return res, counts

    def replay(label, state, idx):
        """The refit's centers opened from `w0` through the kernels (one
        lane, as the solve launches them) and through the plain sweeps:
        the same weights bit for bit, retired and padding rows still 0."""
        scale, levels, m_init = state.statics
        tile = state.tile
        ts, open_k, w_k, _ = ds._lane_start(
            state.codes_lo[None], state.codes_hi[None], [state.capacity],
            scale=scale, num_levels=levels, m_init=m_init, tile=tile,
            w0=state.w0[None], base0=state.base_heap[None])
        lo = ds._pad_axis(state.codes_lo, 2, ts.n_pad)
        hi = ds._pad_axis(state.codes_hi, 2, ts.n_pad)
        t = lo.shape[0]
        kw = dict(scale=scale, num_levels=levels)
        w_p = state.w0.clone()
        for x in idx.tolist():
            w_k, _ = open_k(w_k, torch.tensor([x], device=dev))
            for ti in range(t - 1):
                w_p = ref.tree_sep_update_ref(lo[ti], hi[ti], lo[ti, :, x],
                                              hi[ti, :, x], w_p, **kw)
            w_p, _ = ref.tree_sep_update_tiles_ref(
                lo[t - 1], hi[t - 1], lo[t - 1, :, x], hi[t - 1, :, x], w_p,
                block_n=tile, **kw)
        torch.cuda.synchronize()
        dead = state.w0 == 0
        if not (torch.equal(w_k[0], w_p) and bool((w_p[dead] == 0).all())):
            raise AssertionError(f"{label}: replay weights equal "
                                 f"{torch.equal(w_k[0], w_p)}, dead rows 0 "
                                 f"{bool((w_p[dead] == 0).all())}")
        log(f"  {label}: a replay of the {len(idx)} centers from w0 through "
            f"the kernels and through the plain sweeps gives the same "
            f"weights; {int(dead.sum())} retired and padding rows stay 0")

    def refit_checks(label, plan, prep, want, again=True):
        check_weights(label, prep.streaming)
        res, counts = refit(f"{label} fit_prepared(seed=1)", plan, prep, 1,
                            want)
        replay(label, prep.streaming, res.indices)
        if not again:       # the repeated refit, cut for time
            return res, counts
        again = plan.fit_prepared(prep, seed=1)
        if not torch.equal(again.indices, res.indices):
            raise AssertionError(f"{label}: seed 1 opened other indices the "
                                 "second time")
        log(f"  {label}: seed 1 again, the same {KS} indices "
            f"({again.solve_seconds:.3f} s)")
        return res, counts

    plan, prep = history("rejection")
    state = prep.streaming
    t = state.codes_lo.shape[0]
    sweeps = {"tree_sep_update": (t - 1) * KS, "tree_sep_update_tiles": KS}
    res, launches = refit_checks("rejection stream", plan, prep, sweeps)

    # Round trip: extend then retire the same rows.
    w0, heap = state.w0.clone(), state.base_heap.clone()
    n0 = state.n_rows
    plan.extend(points[:STREAM_BATCH], prepared=prep)
    plan.retire(np.arange(n0, n0 + STREAM_BATCH), prepared=prep)
    if not (torch.equal(state.w0, w0) and torch.equal(state.base_heap, heap)):
        raise AssertionError("stream: extend then retire of the same rows "
                             "did not give w0 and the heap back")
    log(f"  extend then retire of {STREAM_BATCH} rows: w0 and the heap "
        "back bit for bit")
    del w0, heap

    # Out of the frozen domain ([origin, origin + 2) a coordinate in scaled
    # units, less the tree's shift): a rebuild over every row, then the
    # checks.
    far = points[:STREAM_OOD] + 2.0 / state.scale
    t0 = time.perf_counter()
    plan.extend(far, prepared=prep)
    ood_s = sync_s(t0)
    if state.rebuilds != 1:
        raise AssertionError(f"stream: {state.rebuilds} rebuilds after an "
                             "extend out of the domain")
    log(f"  extend of {STREAM_OOD} rows out of the domain: rebuild over "
        f"{state.n_rows} rows in {ood_s:.3f} s (stream_rebuilds 1)")
    res_ood, _ = refit_checks("rejection stream after the rebuild", plan,
                              prep, sweeps, again=False)
    if res_ood.extras["stream_rebuilds"] != 1:
        raise AssertionError(f"stream extras {res_ood.extras}")
    plan.forget(prep)
    del prep, state, res, res_ood

    # Scratch equivalence: A then duplicates of A, against A + B at once.
    dups = points[np.random.default_rng(SEED + 9).integers(
        0, STREAM_FIRST, STREAM_DUPS)]
    t0 = time.perf_counter()
    inc = plan.prepare_streaming(points[:STREAM_FIRST])
    plan.extend(dups, prepared=inc)
    inc_s = sync_s(t0)
    t0 = time.perf_counter()
    scratch = plan.prepare_streaming(np.concatenate([points[:STREAM_FIRST],
                                                     dups]))
    scratch_s = sync_s(t0)
    si, ss = inc.streaming, scratch.streaming
    names = ("codes_lo", "codes_hi", "keys_lo", "keys_hi", "pts_scaled", "w0",
             "base_heap")
    same = [n for n in names if torch.equal(getattr(si, n), getattr(ss, n))]
    ri = plan.fit_prepared(inc, seed=2)
    rs = plan.fit_prepared(scratch, seed=2)
    if len(same) != len(names) or si.scale != ss.scale or \
            si.capacity != ss.capacity or si.rebuilds != 0 or \
            not torch.equal(ri.indices, rs.indices):
        raise AssertionError(f"scratch equivalence: equal {same}, scale "
                             f"{si.scale} {ss.scale}, indices equal "
                             f"{torch.equal(ri.indices, rs.indices)}")
    log(f"  scratch equivalence: prepare_streaming of {STREAM_FIRST} rows "
        f"and extend of {STREAM_DUPS} duplicates ({inc_s:.3f} s) against "
        f"prepare_streaming of the {STREAM_FIRST + STREAM_DUPS} rows "
        f"({scratch_s:.3f} s): codes, keys, pts_scaled, w0 and the heap "
        f"bit-identical, capacity {si.capacity}; the refit at seed 2 the "
        "same indices")
    plan.forget(inc)
    plan.forget(scratch)
    del inc, scratch, si, ss, ri, rs

    fast_plan, fast_prep = history("fastkmeans++")
    check_weights("fastkmeans++ stream", fast_prep.streaming)
    refit("fastkmeans++ stream fit_prepared(seed=1)", fast_plan, fast_prep,
          1, sweeps)
    fast_plan.forget(fast_prep)
    del fast_prep
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] streaming done")
    return launches


def same_fit(torch, a, b) -> bool:
    """Indices, centers and cost bit for bit."""
    return (torch.equal(a.indices, b.indices)
            and torch.equal(a.centers, b.centers)
            and torch.equal(a.cost, b.cost))


def check_launches(label, counts, solves, t, pairwise=0, shards=1,
                   k=KS) -> None:
    """`solves` rejection solves of k centers and one lane each (or
    lane-batched: the lanes share launches) over `shards` shards (each
    sweep launched once a shard, the accept once a round) and `pairwise`
    `pairwise_argmin` launches, nothing else."""
    lsh = counts["lsh_bucket_accept"]
    want = dict({name: 0 for name in counts}, lsh_bucket_accept=lsh,
                tree_sep_update=solves * shards * (t - 1) * k,
                tree_sep_update_tiles=solves * shards * k,
                pairwise_argmin=pairwise)
    if counts != want or lsh < solves * (k - 1):
        raise AssertionError(f"{label}: launches {counts}, expected {want} "
                             f"and lsh_bucket_accept >= {solves * (k - 1)}")


def sharded_phase(torch, t_start, points, device_plan, fit, km_fit,
                  lane_costs, full_fits, t) -> dict:
    """Phase 8g: the sharded backend at full width on `kddcup_shaped(0)`
    over a mesh of `SHARDS` shards on cuda:0: the rejection fit and
    refit(seed=1) at k = K, their mean cost within 5% of phase 8's device
    fit and refit (`full_fits`, the same seeds and k); the rejection solve
    on one shard of phase 8's prepared artifacts, fastkmeans++ and
    k-means|| at k = KS.  Returns the launches of its rejection fit (rows
    1 to 3) and of its k-means|| fit (row 5)."""
    from repro_torch.core import sharded_seeding as shs
    from repro_torch.core.device_seeding import _generator
    from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_seeding_mesh

    t_phase = time.perf_counter()
    log(f"[{t_phase - t_start:.1f} s] the sharded backend: n={N}, d={D}, "
        f"k={K} (rejection) and {KS}, {SHARDS} shards on cuda:0 "
        f"(make_seeding_mesh({SHARDS}, device='cuda:0'))")
    mesh = make_seeding_mesh(SHARDS, device="cuda:0")

    def sharded_plan(seeder, shards_mesh, k=KS):
        plan = ClusterPlan(ClusterSpec(k=k, seeder=seeder, seed=SEED),
                           ExecutionSpec(backend="sharded",
                                         mesh=shards_mesh))
        prep = plan.prepare(points).prepare_data(points)
        return plan, prep

    def timed_fit(plan, seed=None):
        ops.reset_launch_counts()
        res = plan.fit(seed=seed)
        torch.cuda.synchronize()
        return res, ops.launch_counts()

    # k = K: the mean-cost gate below holds two seeds a side to 5%, which
    # at k = 1000 is about three standard errors of the difference (a
    # seed's cost spreads by 1 to 2% there, by about 5% at k = 250)
    plan, prep = sharded_plan("rejection", mesh, K)
    data = prep.artifacts
    if not (data.mesh.size == SHARDS and all(
            a.device == torch.device("cuda", 0) for a in data.codes_lo)):
        raise AssertionError(f"sharded artifacts on {data.mesh}")
    res0, counts = timed_fit(plan)
    rounds = sum(res0.extras["rounds_per_batch"].values())
    check_launches("sharded rejection", counts, 1, t, shards=SHARDS, k=K)
    if counts["lsh_bucket_accept"] != rounds:
        raise AssertionError(f"sharded rejection: {rounds} accept rounds, "
                             f"{counts['lsh_bucket_accept']} launches")
    idx = res0.indices.cpu().numpy()
    if len(np.unique(idx)) != K or idx.max() >= N or \
            res0.extras["devices"] != SHARDS:
        raise AssertionError("sharded rejection: indices or extras")
    log(f"  rejection: prepare {prep.prepare_seconds:.3f} s (split onto "
        f"{SHARDS} shards of {data.n_loc} rows), solve "
        f"{res0.solve_seconds:.3f} s (phase 8's device fit "
        f"{full_fits[0].solve_seconds:.3f} s), {rounds} accept rounds, "
        f"launches={counts}, cost {float(res0.cost):.10g}")
    res1, _ = timed_fit(plan, seed=1)
    costs = [float(res0.cost), float(res1.cost)]
    log(f"  rejection refit(seed=1): solve {res1.solve_seconds:.3f} s, "
        f"cost {costs[1]:.10g}")
    mean = float(np.mean(costs))
    device = float(np.mean([float(f.cost) for f in full_fits]))
    if abs(mean / device - 1.0) > 0.05:
        raise AssertionError(f"sharded rejection: mean cost of seeds 0 and "
                             f"1 {mean} against phase 8's device fits' "
                             f"{device}")
    log(f"  mean cost of seeds 0 and 1 {mean:.10g}, {mean / device:.6f} of "
        f"phase 8's device fit and refit(seed=1) at k={K} ({device:.10g})")
    main_counts = counts

    # One shard of phase 8's prepared artifacts (no second host prepare),
    # solved from the rng state phase 8's fit solved from.
    dev_prep = device_plan.prepare_data(points)          # cached
    art = dev_prep.artifacts
    t0 = time.perf_counter()
    one = shs.shard_arrays(
        make_seeding_mesh(1, device="cuda:0"), plan.execution.tile, N,
        codes_lo=art.codes_lo, codes_hi=art.codes_hi, points=art.points,
        keys_lo=art.keys_lo, keys_hi=art.keys_hi, scale=art.scale,
        num_levels=art.num_levels, m_init=art.m_init)
    split_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    rng.bit_generator.state = dev_prep.rng_state
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    chosen, _ = shs.sharded_rejection_sampling(
        one, KS, _generator(rng, one.controller), c=device_plan.cluster.c)
    torch.cuda.synchronize()
    solve1 = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_launches("sharded rejection, one shard", counts, 1, t)
    if not torch.equal(chosen, fit.indices):
        raise AssertionError("one shard: other indices than phase 8's "
                             "device fit at seed 0")
    log(f"  rejection on one shard of phase 8's artifacts: split "
        f"{split_s:.3f} s, solve {solve1:.3f} s, launches={counts}; the "
        f"same {KS} indices as phase 8's device plan at k={KS}")
    del one, chosen

    fast, prep_f = sharded_plan("fastkmeans++", mesh)
    res_f, counts = timed_fit(fast)
    want = dict({name: 0 for name in counts},
                tree_sep_update=SHARDS * (t - 1) * KS,
                tree_sep_update_tiles=SHARDS * KS)
    if counts != want or len(torch.unique(res_f.indices)) != KS:
        raise AssertionError(f"sharded fastkmeans++: launches {counts}, "
                             f"expected {want}")
    fast_lanes = float(np.mean(lane_costs["fastkmeans++"]))
    log(f"  fastkmeans++: prepare {prep_f.prepare_seconds:.3f} s, solve "
        f"{res_f.solve_seconds:.3f} s, launches={counts}, cost "
        f"{float(res_f.cost):.10g} ({float(res_f.cost) / fast_lanes:.6f} "
        "of the mean of phase 8b's fastkmeans++ lanes)")
    del fast, prep_f

    kmp, prep_k = sharded_plan("kmeans||", mesh)
    res_k, counts = timed_fit(kmp)
    want = dict({name: 0 for name in counts},
                pairwise_argmin=KMP_ROUNDS * SHARDS)
    if counts != want or len(torch.unique(res_k.indices)) != KS or \
            not math.isfinite(float(res_k.cost)):
        raise AssertionError(f"sharded kmeans||: launches {counts}, "
                             f"expected {want}")
    log(f"  kmeans||: prepare {prep_k.prepare_seconds:.3f} s, solve "
        f"{res_k.solve_seconds:.3f} s (pool {res_k.extras['pool_size']}), "
        f"launches={counts}, cost {float(res_k.cost):.10g} "
        f"({float(res_k.cost) / float(km_fit.cost):.6f} of phase 8's "
        "device k-means|| fit)")
    del plan, prep, kmp, prep_k
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] sharded done "
        f"({time.perf_counter() - t_phase:.1f} s)")
    return dict(main_counts, pairwise_argmin=counts["pairwise_argmin"])


def engine_phase(torch, t_start, points, plan, fit, refit, km_fit,
                 t) -> dict:
    """Phase 8e: `ClusterEngine` at full width on `kddcup_shaped(0)` and
    `(1)`: pipelined tickets against the serial fits, a traced pipelined
    pair, transient faults (a retry, and a fallback down to
    k-means||/device) and a real out-of-memory.  Returns the launches of
    the engine's solves."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (CircuitBreakerPolicy, ClusterEngine,
                                  ClusterPlan, ClusterSpec, ExecutionSpec,
                                  FaultPlan, RetryPolicy, attempt_seed,
                                  classify_failure)
    from repro_torch.kernels import ops

    spec = ClusterSpec(k=KS, seeder="rejection", seed=SEED)
    exe = ExecutionSpec(backend="device")
    total = collections.Counter()
    log(f"[{time.perf_counter() - t_start:.1f} s] the clustering engine at "
        f"full width, d={D}, k={KS}, rejection: kddcup_shaped(0) and (1) at "
        "seeds 0 and 1, prepare_workers=2")
    data1 = kddcup_shaped(SEED + 1)
    engine = ClusterEngine(spec, exe, prepare_workers=2, degrade=False)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [engine.submit(x, seed=s) for x in (points, data1)
                   for s in (0, 1)]
        results = [tk.result() for tk in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        stats = engine.stats()
        check_launches("engine, four tickets", counts, 4, t)
        total.update(counts)

        serial = ClusterPlan(spec, exe)
        prep1 = serial.prepare_data(data1)
        refs = [fit, refit, serial.fit_prepared(prep1, seed=0),
                serial.fit_prepared(prep1, seed=1)]
        for i, (res, ref_fit) in enumerate(zip(results, refs)):
            if not (same_fit(torch, res, ref_fit)
                    and torch.equal(res.extras["trials"],
                                    ref_fit.extras["trials"])
                    and res.extras["served_by"] == "rejection/device"
                    and res.extras["attempts"] == 1):
                raise AssertionError(f"engine ticket {i} differs from its "
                                     f"serial fit: {res.extras}")
        serial_s = (fit.prepare_seconds + fit.solve_seconds
                    + refit.solve_seconds + prep1.prepare_seconds
                    + refs[2].solve_seconds + refs[3].solve_seconds)
        log(f"  engine: four tickets in {wall:.3f} s of wall time; the "
            f"serial prepares and solves of the same fits {serial_s:.3f} s "
            f"(kddcup_shaped(0): phase 8's prepare {fit.prepare_seconds:.3f}"
            f" s and solves {fit.solve_seconds:.3f} and "
            f"{refit.solve_seconds:.3f} s; kddcup_shaped(1): prepare "
            f"{prep1.prepare_seconds:.3f} s, solves "
            f"{refs[2].solve_seconds:.3f} and {refs[3].solve_seconds:.3f} "
            f"s); stats() prepare_seconds {stats['prepare_seconds']:.3f}, "
            f"solve_seconds {stats['solve_seconds']:.3f}; launches={counts};"
            f" each ticket bit-identical to its serial fit, costs "
            f"{[round(float(r.cost), 1) for r in results]}")
        del serial, prep1, refs

        # A pipelined pair of requests on the two prepared datasets,
        # traced (the card's activity only).
        log(f"[{time.perf_counter() - t_start:.1f} s] a traced pair")
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pair = [engine.submit(x, seed=2) for x in (points, data1)]
            pair = [tk.result() for tk in pair]
            torch.cuda.synchronize()
            pair_wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check_launches("engine, traced pair", counts, 2, t)
        total.update(counts)
        busy, n_events, by_name = device_time(torch, prof)
        log(f"  traced pipelined pair (kddcup_shaped(0) and (1) at seed 2, "
            f"both prepared): wall {pair_wall:.3f} s, device busy "
            f"{busy:.4f} s over {n_events} device events, idle share "
            f"{1 - busy / pair_wall:.4f}; solves {pair[0].solve_seconds:.3f}"
            f" and {pair[1].solve_seconds:.3f} s")
        log_top(by_name, 5)
        del prof

        log(f"[{time.perf_counter() - t_start:.1f} s] an out-of-memory")
        # A real out-of-memory: the allocator capped 64 MiB above what is
        # reserved.  The pair's results stay referenced, so the solve
        # worker letting go of its last request frees nothing here.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        dev_total = torch.cuda.get_device_properties(0).total_memory
        torch.cuda.set_per_process_memory_fraction(
            (reserved + (64 << 20)) / dev_total)
        try:
            t0 = time.perf_counter()
            exc = engine.submit(points, seed=0).exception()
            oom_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        if not (isinstance(exc, torch.cuda.OutOfMemoryError)
                and classify_failure(exc) == "transient"
                and after == before):
            raise AssertionError(f"out-of-memory: {exc!r} classified "
                                 f"{classify_failure(exc)}, allocated "
                                 f"{after} after against {before} before")
        ops.reset_launch_counts()
        again = engine.submit(points, seed=0).result()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_launches("engine, after the out-of-memory", counts, 1, t)
        total.update(counts)
        if not same_fit(torch, again, fit):
            raise AssertionError("the request after the out-of-memory "
                                 "differs from the fit")
        log(f"  out-of-memory: capped at {(reserved >> 20) + 64} MiB "
            f"(reserved {reserved / 2**20:.1f} MiB, allocated "
            f"{before / 2**20:.1f} MiB), the request failed in {oom_s:.3f} s"
            f" with {type(exc).__name__} ({str(exc).splitlines()[0][:90]}),"
            f" classified {classify_failure(exc)}; allocated after the "
            f"ticket settled {after / 2**20:.1f} MiB, as before; uncapped, "
            f"the same request equals the fit ({again.solve_seconds:.3f} s)")
        del exc, again, results, tickets, pair
    finally:
        engine.close()
    del engine

    # Transient solve faults on every rejection target: the first ticket
    # retries on the card, then is served by k-means||/device (phase 8's
    # k-means|| fit at the same seed; an engine on the card skips the
    # chain's cpu rungs); the second fails once more (the key's third
    # fault) and is retried.
    fp = FaultPlan(seed=0, solve_failure_rate=1.0, match="rejection/",
                   max_failures_per_key=3)
    log(f"[{time.perf_counter() - t_start:.1f} s] transient faults")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ClusterEngine(spec, exe, prepare_workers=1, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=2),
                       breaker=CircuitBreakerPolicy(failure_threshold=10)
                       ) as faulty:
        fell = faulty.submit(points, seed=0)
        retried = faulty.submit(points, seed=1)
        fell, retried = fell.result(), retried.result()
        torch.cuda.synchronize()
        fault_s = time.perf_counter() - t0
        fstats = faulty.stats()
    counts = ops.launch_counts()
    check_launches("engine under faults", counts, 1, t, pairwise=KMP_ROUNDS)
    total.update(counts)
    want_retry = plan.fit_prepared(plan.prepare_data(points),
                                   seed=attempt_seed(1, 1))
    checks = {
        "fallback served by kmeans||/device": (
            fell.extras["served_by"] == "kmeans||/device"
            and fell.extras["fallback_path"] == ("rejection/device",)),
        "fallback equals the direct k-means|| fit": same_fit(torch, fell,
                                                             km_fit),
        "retry on rejection/device, attempt 2": (
            retried.extras["served_by"] == "rejection/device"
            and retried.extras["attempts"] == 2),
        "retry equals the fit at attempt_seed(1, 1)": same_fit(
            torch, retried, want_retry),
        "no cpu rung": all(not key.endswith("/cpu")
                           for key in fstats["health"]),
        "books": (fp.stats()["injected"] == 3 and fstats["retries"] == 2
                  and fstats["fallback_served"] == 1
                  and fstats["completed"] == 2),
    }
    if not all(checks.values()):
        raise AssertionError(f"engine under faults: {checks}, stats "
                             f"{fstats}, faults {fp.stats()}")
    log(f"  under faults ({fp.stats()['injected']} injected transient "
        f"solve faults on the rejection targets): two tickets in "
        f"{fault_s:.3f} s; the first served by kmeans||/device after "
        f"{fell.extras['fallback_path']} (solve {fell.solve_seconds:.3f} s),"
        f" equal to the direct k-means|| fit; the second retried "
        f"(attempts {retried.extras['attempts']}), equal to the fit at "
        f"attempt_seed(1, 1) = {attempt_seed(1, 1)}; stats retries "
        f"{fstats['retries']}, fallback_served {fstats['fallback_served']},"
        f" health {fstats['health']}; launches={counts}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] engine done")
    return dict(total)


def service_phase(torch, t_start, points, stacked_plan) -> dict:
    """Phase 8f: `ClusterServer` on an ephemeral loopback port with two
    tenants; a `ClusterClient` sends `kddcup_shaped(0)` at seeds 0 to 3,
    four requests in flight, which the frontend coalesces into one stacked
    lane; each answer against the lane-batched solve of those seeds.
    Returns the launches of the server's solve."""
    from repro_torch.core import ClusterSpec, ExecutionSpec
    from repro_torch.kernels import ops
    from repro_torch.serving.net import (ClusterClient, ClusterServer,
                                         TenantScheduler, parse_tenants)
    from repro_torch.serving.net.protocol import ResultFrame

    spec = ClusterSpec(k=KS, seeder="rejection", seed=SEED)
    exe = ExecutionSpec(backend="device")
    seeds = [0, 1, 2, 3]
    tenants = ("bulk", "interactive")
    log(f"[{time.perf_counter() - t_start:.1f} s] the clustering service: "
        f"ClusterServer on loopback, tenants {tenants}, kddcup_shaped(0) at "
        f"seeds {seeds} from one ClusterClient")
    scheduler = TenantScheduler(parse_tenants(
        "bulk:1000:64:1,interactive:1000:64:4"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ClusterServer(spec, exe, admission=scheduler, max_batch=len(seeds),
                       max_wait_ms=600_000.0) as srv:
        with ClusterClient(*srv.address) as client:
            ids = [client.submit(points, seed=s, tenant=tenants[s % 2])
                   for s in seeds]
            sent_s = time.perf_counter() - t0
            wire = [client.result(rid, timeout=900) for rid in ids]
            wall = time.perf_counter() - t0
            settle = time.monotonic() + 30.0
            while True:
                stats = client.stats(timeout=60)
                if stats["net"]["results_sent"] >= len(seeds) or \
                        time.monotonic() > settle:
                    break
                time.sleep(0.05)
    counts = ops.launch_counts()
    prep = stacked_plan.prepare_stacked(points)        # phase 8c's, cached
    check_launches("service, one lane-batched solve", counts, 1,
                   prep.artifacts.arrays[0].shape[0])
    want = stacked_plan.fit_batch_prepared([prep] * len(seeds), seeds=seeds)
    for i, got in enumerate(wire):
        if not (np.array_equal(got.indices, want.indices[i].cpu().numpy())
                and np.array_equal(got.centers,
                                   want.centers[i].cpu().numpy())
                and got.cost == float(want.cost[i])
                and got.extras["lane_size"] == len(seeds)):
            raise AssertionError(f"service answer {i} differs from lane {i} "
                                 "of the lane-batched solve")
    net = stats["net"]
    if not (stats["lanes"] == 1 and stats["completed"] == len(seeds)
            and net["results_sent"] == len(seeds)
            and net["errors_sent"] == 0):
        raise AssertionError(f"service books: {stats}")
    bd = net["breakdown"]
    attributed = sum(bd.values())
    out_bytes = sum(len(ResultFrame(rid, got.indices, got.centers, got.cost,
                                    got.extras).encode())
                    for rid, got in zip(ids, wire))
    log(f"  four answers in {wall:.3f} s of wall time (the four uploads "
        f"sent in {sent_s:.3f} s), one lane of {stats['lane_members']} "
        f"(flush {wire[0].extras['flush_reason']}), each bit-identical to "
        f"its lane of fit_batch_prepared over one prepare_stacked; "
        f"launches={counts}; bytes on the wire: {net['bytes_in']} in "
        f"({net['bytes_in'] / len(seeds) / 2**20:.1f} MiB a request, f64), "
        f"{out_bytes} out (result frames)")
    log("  SLO attribution (the server's, cumulative over the four "
        "answers; solve is each answer's prepare_seconds + solve_seconds, "
        "and a lane's prepare_seconds sums its members' prepares):")
    for name, key in (("queue_wait", "queue_wait_s"), ("solve", "solve_s"),
                      ("network", "network_s")):
        log(f"    {name:<11} {bd[key]:10.4f} s ({bd[key] / attributed:.4f})")
    for i, got in enumerate(wire):
        srv_x = got.extras["server"]
        log(f"    request {i} ({tenants[i % 2]}): queue_wait "
            f"{srv_x['queue_wait']:.3f} s, prepare_seconds "
            f"{srv_x['prepare_seconds']:.3f} s, solve_seconds "
            f"{srv_x['solve_seconds']:.3f} s, recv_to_submit "
            f"{srv_x['recv_to_submit'] * 1e3:.3f} ms")
    for tenant, rec in sorted(stats["tenants"].items()):
        log(f"    tenant {tenant}: submitted {rec.get('submitted', 0)}, "
            f"completed {rec.get('completed', 0)}, queue_wait p50 "
            f"{rec['queue_wait']['p50']:.3f} s")
    del want, wire
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] service done")
    return counts


def check_attention(torch, ops, ref, q, k, v, causal: bool, label: str,
                    tol: float, prefix_len: int = 0) -> float:
    """`attention_bshd` (the kernel) against its plain version on the same
    inputs, to `tol` absolute and relative; returns the max abs error."""
    scale = q.shape[-1] ** -0.5
    out = ops.attention_bshd(q, k, v, scale=scale, causal=causal,
                             prefix_len=prefix_len)
    plain = ref.attention_bshd_ref(q, k, v, scale=scale, causal=causal,
                                   prefix_len=prefix_len)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    if not bool(torch.isfinite(out).all()) or \
            not torch.allclose(out, plain, rtol=tol, atol=tol):
        raise AssertionError(f"flash_attention {label}: max abs err {err}")
    log(f"flash_attention {label}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"{str(q.dtype)[6:]}: max abs err {err:.3g} (tol {tol})")
    return err


def prefill_vs_replay(torch, params, cfg, short) -> None:
    """Information: the last logits of `prefill` (one kernel launch per
    layer) against `Engine.replay_prefill` (one decode step per token over
    the cache, no kernel) on the prompts `short`, end to end."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    n = short.shape[1]
    ops.reset_launch_counts()
    last_f, _ = prefill(params, cfg, {"tokens": short}, max_seq=n + 8)
    torch.cuda.synchronize()
    n_prefill = ops.launch_counts()
    ops.reset_launch_counts()
    last_r, _ = Engine(params, cfg, ServeConfig(max_seq=n + 8)
                       ).replay_prefill(short)
    torch.cuda.synchronize()
    n_replay = ops.launch_counts()
    if n_prefill["flash_attention"] != cfg.num_layers or \
            sum(n_prefill.values()) != cfg.num_layers or \
            sum(n_replay.values()) != 0:
        raise AssertionError(f"prefill launches {n_prefill}, replay "
                             f"{n_replay}")
    lf, lr = last_f.float(), last_r.float()
    rows = (lf.argmax(dim=-1) == lr.argmax(dim=-1)).sum()
    log(f"  end to end (information): prefill ({cfg.num_layers} kernel "
        f"launches) against replay ({n} decode steps, no kernel) on "
        f"{short.shape[0]} x {n} tokens in {cfg.dtype}: last logits max abs "
        f"diff {float((lf - lr).abs().max()):.4g} of max |logit| "
        f"{float(lf.abs().max()):.4g}; argmax equal in {int(rows)} of "
        f"{short.shape[0]} rows")


def attention_prefill_vs_replay(torch, params, cfg, short) -> float:
    """The kernel inside the model, apart from its plain version: layer by
    layer through the whole depth, each layer's prefill attention
    (`attn_forward`, one kernel launch) against the same layer's decode
    attention (`attn_decode`, one step per token over its own cache, no
    kernel) on the same normed input, f32 activations over the bf16
    weights.  Returns the worst max abs difference as a share of the
    layer's largest output; raises past `LAYER_TOL` or on other launch
    counts than one per layer."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models.layers import apply_mlp, apply_norm
    from repro_torch.models.model import layer_slice

    dev = short.device
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    b, n = short.shape
    at = torch.arange(n, device=dev)
    worst, first = 0.0, []
    ops.reset_launch_counts()
    with torch.inference_mode():
        x = params["embed"]["tokens"][short].to(torch.float32)
        for i in range(cfg.num_layers):
            layer = layer_slice(params["groups"]["pos00"], i)
            h = apply_norm(layer["norm1"], x, f32cfg)
            y_f, _ = attention.attn_forward(layer["attn"], h, f32cfg)
            kv = (b, n, cfg.num_kv_heads, cfg.head_dim)
            cache = {"k": torch.zeros(kv, device=dev),
                     "v": torch.zeros(kv, device=dev)}
            y_d = torch.empty_like(y_f)
            for t in range(n):
                y_d[:, t: t + 1], cache = attention.attn_decode(
                    layer["attn"], h[:, t: t + 1], cache, at[t], f32cfg)
            rel = float((y_f - y_d).abs().max() / y_f.abs().max())
            worst = max(worst, rel)
            if i < 3:
                first.append(f"{rel:.3g}")
            x = x + y_f
            x = x + apply_mlp(layer["mlp"],
                              apply_norm(layer["norm2"], x, f32cfg), f32cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["flash_attention"] != cfg.num_layers or \
            sum(counts.values()) != cfg.num_layers or worst > LAYER_TOL:
        raise AssertionError(f"layer by layer: launches {counts}, worst "
                             f"relative difference {worst}")
    log(f"  layer by layer through all {cfg.num_layers} layers at full "
        f"width, f32 activations over the bf16 weights, {b} x {n} tokens: "
        f"prefill attention ({counts['flash_attention']} kernel launches) "
        f"against decode attention ({n} steps a layer, no kernel): worst max "
        f"abs diff {worst:.3g} of the layer's largest output (tol "
        f"{LAYER_TOL}; layers 0 to 2: {', '.join(first)})")
    return worst


def timed_steps(torch, params, cfg, toks, serve, tokens) -> tuple:
    """`Engine.generate`'s steps again, timed apart: the prefill, the first
    token, then the decode steps (greedy, so `tokens` again, or raise).
    Returns (prefill s, time to first token s, decode s)."""
    from repro_torch.models import decode_step
    from repro_torch.serving.prefill import prefill

    b, s = toks.shape
    new = tokens.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": toks},
                            max_seq=serve.max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cur = torch.argmax(logits, dim=-1)
    cur.cpu()
    ttft_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    steps = [cur]
    for _ in range(new - 1):
        logits, cache = decode_step(params, cfg, cur, cache)
        cur = torch.argmax(logits, dim=-1)
        steps.append(cur)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    split = torch.stack(steps, dim=1).cpu().numpy()
    if not np.array_equal(split, tokens):
        raise AssertionError("the timed steps gave other tokens than "
                             "generate")
    log(f"  prefill {prefill_s:.4f} s ({b * s / prefill_s:.1f} prompt "
        f"tokens/s); time to first token {ttft_s:.4f} s; decode "
        f"{new - 1} steps in {decode_s:.4f} s, "
        f"{b * (new - 1) / decode_s:.2f} tokens/s "
        f"({decode_s / (new - 1) * 1e3:.3f} ms per step of {b} tokens); "
        f"the same tokens as generate")
    return prefill_s, ttft_s, decode_s


def serving_path(torch, t_start: float) -> dict:
    """Phases 10 to 14: the `flash_attention` kernel against its plain
    version and timed at the serving path's shape, then yi-9b at full
    width and depth through `Engine.generate`, prefill against replay, and
    the reduced model on the card against the CPU.  Returns the kernel's
    row."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_cuda as fa_cuda
    from repro_torch.kernels import ops, ref
    from repro_torch.models import decode_step, init_params, param_specs
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    b, s, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 10. the kernel against its plain version ----------------------------
    mark("10-11")
    log(f"[{time.perf_counter() - t_start:.1f} s] flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    q, k, v = (randn((b, s, n, hd), bf16) for n in (h, hk, hk))
    err = check_attention(torch, ops, ref, q, k, v, True,
                          "at the path's shape, causal", ATTN_TOL)
    x = [randn((2, 1024, 8, hd), f32) for _ in range(3)]
    err = max(err, check_attention(torch, ops, ref, *x, False,
                                   "f32, non-causal, g = 1", ATTN_TOL))
    x = [randn((1, 1000, n, hd), bf16) for n in (h, hk, hk)]
    err = max(err, check_attention(torch, ops, ref, *x, True,
                                   "ragged S, causal", ATTN_TOL))
    x = [randn((8, 333, 64), f32) for _ in range(3)]
    flat = ops.flash_attention(*x, scale=0.125, causal=True)
    plain = ref.flash_attention_ref(*x, scale=0.125, causal=True)
    torch.cuda.synchronize()
    flat_err = float((flat - plain).abs().max())
    if not torch.allclose(flat, plain, rtol=ATTN_TOL, atol=ATTN_TOL):
        raise AssertionError(f"flash_attention (BH, S, D): {flat_err}")
    log(f"flash_attention, the (BH, S, D) entry at (8, 333, 64) f32 causal: "
        f"max abs err {flat_err:.3g} (tol {ATTN_TOL})")
    err = max(err, flat_err)
    del x, flat, plain

    # -- 11. its time at the path's shape ------------------------------------
    ms = cuda_ms(torch, lambda i: fa_cuda.launch(q, k, v, scale=scale,
                                                 causal=True), 20)
    plain_ms = cuda_ms(torch, lambda i: ref.attention_bshd_ref(
        q, k, v, scale=scale, causal=True), 3)
    ms_again = cuda_ms(torch, lambda i: fa_cuda.launch(q, k, v, scale=scale,
                                                       causal=True), 20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), 20)
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = cuda_ms(torch, lambda i: fa_cuda.launch(qf, kf, vf, scale=scale,
                                                     causal=True), 3)
    log(f"time flash_attention, f32 route (the SIMT kernel; tests and the "
        f"f32 checks only): {f32_ms:.6f} ms at the same shape in f32")
    del qf, kf, vf
    ops_count = 2 * s * (s + 1) * hd * b * h
    nbytes = (q.element_size() * (q.numel() + k.numel() + v.numel())
              + 4 * q.numel())       # each input read once, f32 out
    b_ms, b_by = bound(nbytes, ops_count, BF16_OPS_PER_S)
    simt_ms = ops_count / F32_OPS_PER_S * 1e3
    log(f"time flash_attention: kernel {ms:.6f} / {ms_again:.6f} ms, plain "
        f"{plain_ms:.6f} ms, library (scaled_dot_product_attention, bf16 "
        f"out) {lib_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}; {ops_count} "
        f"operations take {ops_count / BF16_OPS_PER_S * 1e3:.6f} ms at 989 "
        f"TFLOP/s bf16 and {simt_ms:.6f} ms at the 67 TFLOP/s of f32 outside "
        f"the tensor cores; {nbytes} bytes take "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms), "
        f"{b_ms / min(ms, ms_again):.4f} of the bound")
    source, replaces = KERNELS["flash_attention"]
    row = {"name": "flash_attention", "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "ms": min(ms, ms_again), "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # -- 12. the path: yi-9b at full width and depth ------------------------
    mark("12-13")
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} at full width")
    t0 = time.perf_counter()
    params = init_params(param_specs(cfg), gen, bf16, dev)
    torch.cuda.synchronize()
    log(f"  parameters: {cfg.param_count()} in bf16 drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)
    serve = ServeConfig(max_new_tokens=new, max_seq=s + 40)
    eng = Engine(params, cfg, serve)
    t0 = time.perf_counter()
    eng.serve = dataclasses.replace(serve, max_new_tokens=1)
    eng.generate(prompts)                       # warm-up: cuBLAS, allocator
    eng.serve = serve
    log(f"  warm-up generate (1 new token): "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts)
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_launches("generate", counts, {"flash_attention": cfg.num_layers})
    row["launches"] = counts["flash_attention"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if tokens.shape != (b, new) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"generate: bad tokens {tokens}")
    again = eng.generate(prompts)
    if not np.array_equal(tokens, again):
        raise AssertionError("generate: a second run gave other tokens")
    log(f"  generate: {b} prompts x {s} tokens, {new} new each, "
        f"max_seq={serve.max_seq}: {gen_s:.4f} s; launches {counts}; peak "
        f"device memory {peak_gib:.3f} GiB; a second run gave the same "
        f"tokens; first sequence starts {tokens[0, :8].tolist()}")

    # The engine's own steps again, timed apart: prefill, the first token,
    # then the decode steps; greedy, so the same tokens as generate.
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    timed_steps(torch, params, cfg, toks, serve, tokens)

    # Where the time goes: the prefill and TRACE_STEPS decode steps again,
    # each traced with torch.profiler.
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, {"tokens": toks},
                                max_seq=serve.max_seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_events, by_name = device_time(torch, prof)
    log(f"  traced prefill: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"over {n_events} device events, idle share {1 - busy / wall:.4f}")
    log_top(by_name, 6)
    cur = torch.argmax(logits, dim=-1)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_STEPS):
            logits, cache = decode_step(params, cfg, cur, cache)
            cur = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_events, by_name = device_time(torch, prof)
    log(f"  traced decode, {TRACE_STEPS} steps: wall {wall:.4f} s, device "
        f"busy {busy:.4f} s over {n_events} device events "
        f"({n_events / TRACE_STEPS:.0f} a step), idle share "
        f"{1 - busy / wall:.4f}")
    log_top(by_name, 6)
    del logits, cache, cur, prof

    # -- 13. the kernel inside the model, apart from its plain version: prefill
    # against replay, layer by layer (gated) and end to end (information:
    # under the init law the attention is nearly one-hot, so a rounding
    # difference can change the key a head picks and the change grows
    # over 48 layers).
    short = toks[:, :REPLAY_PROMPT]
    attention_prefill_vs_replay(torch, params, cfg, short)
    prefill_vs_replay(torch, params, cfg, short)
    del eng, toks, short

    # -- 14. reduced yi-9b on the card against the port on the CPU ----------
    mark("14")
    reduced_on_card(torch, cfg.name, b)
    # -- 14b. the clustered KV cache over phase 12's weights -----------------
    mark("14b")
    paths = {"generate": counts,
             "cluster_kv": cluster_kv_phase(torch, t_start, params, cfg)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # -- 14c to 14e. MLA and MoE at full width, then reduced ----------------
    mark("14c")
    paths["mla"], row["at_mla_shape"] = deepseek_phase(torch, t_start)
    mark("14d")
    paths["moe"], row["at_moe_shape"] = qwen_moe_phase(torch, t_start)
    mark("14e")
    for arch in MOE_ARCHS:
        reduced_on_card(torch, arch, b, gate_shape=MOE_GATE_SHAPE)
    # -- 15a to 15d. RWKV-6, Mamba, the vlm prefix and the audio inputs ----
    mark("15a")
    paths["rwkv6"] = recurrent_phase(torch, t_start, "rwkv6-3b", {})
    mark("15b")
    paths["jamba"] = recurrent_phase(torch, t_start, "jamba-1.5-large-398b",
                                     JAMBA_CUTS)
    mark("15c")
    paths["paligemma"], row["at_prefix_shape"] = paligemma_phase(torch,
                                                                 t_start)
    mark("15d")
    paths["hubert"], row["at_hubert_shape"] = hubert_phase(torch, t_start)
    bwd_row, train_paths, row["at_olmo_1b_shape"], \
        row["at_olmo_1b_bf16_train_shape"], bf16_step_s = training_phase(
            torch, t_start)
    paths.update(train_paths)
    row["max_abs_err"] = max(
        [row["max_abs_err"]] + [row[key]["max_abs_err"] for key in (
            "at_mla_shape", "at_moe_shape", "at_prefix_shape",
            "at_hubert_shape", "at_olmo_1b_shape",
            "at_olmo_1b_bf16_train_shape")])
    log("clocks/power after the serving path: " + smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu"))
    bwd_row["launches"] = paths["train"]["flash_attention_bwd"]
    return [row, bwd_row], paths, bf16_step_s


def reduced_on_card(torch, arch: str, b: int, gate_shape=None) -> None:
    """Phases 14 and 14e: the reduced config of `arch` in f32 on the card
    against the port on the CPU with the same weights: the same `generate`
    tokens (b prompts of 64, 16 new), and prefill logits to `SMALL_TOL` on
    prompts of `gate_shape` (default: the generate's prompts)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params, param_specs, params_from_numpy
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    dev = torch.device("cuda")
    small = reduce_for_smoke(get_config(arch))
    p_cpu = init_params(param_specs(small),
                        torch.Generator().manual_seed(SEED), torch.float32,
                        "cpu")
    p_card = params_from_numpy(p_cpu, dev)

    def last_logits(params, toks):
        return prefill(params, small, {"tokens": torch.from_numpy(toks).to(
            params["embed"]["tokens"].device)}, max_seq=88)[0].cpu()

    def compare(shape):
        toks = np.random.default_rng(SEED).integers(1, small.vocab_size,
                                                    shape)
        err = float((last_logits(p_card, toks) - last_logits(p_cpu, toks))
                    .abs().max())
        return toks, err

    toks, err = compare((b, 64))
    gate = err if gate_shape is None else compare(gate_shape)[1]
    sv = ServeConfig(max_new_tokens=16, max_seq=88)
    on_card = Engine(p_card, small, sv).generate(toks)
    on_cpu = Engine(p_cpu, small, sv, device="cpu").generate(toks)
    if gate > SMALL_TOL or not np.array_equal(on_card, on_cpu):
        raise AssertionError(f"reduced {arch}, card against CPU: logits "
                             f"{gate}, tokens equal "
                             f"{np.array_equal(on_card, on_cpu)}")
    shape = "the same prompts" if gate_shape is None else \
        f"{gate_shape[0]} x {gate_shape[1]} tokens"
    log(f"  reduced {arch} (f32, {small.num_layers} layers, d_model "
        f"{small.d_model}) on the card against the port on the CPU: the same "
        f"{b} x 16 greedy tokens from {b} x 64-token prompts (prefill logits "
        f"max abs diff {err:.3g}, information); on {shape}: logits max abs "
        f"diff {gate:.3g} (tol {SMALL_TOL})")


def expect_launches(label: str, counts: dict, want: dict) -> None:
    """Raise unless `counts` has exactly `want`'s launches and no other."""
    got = {name: n for name, n in counts.items() if n}
    if got != {name: n for name, n in want.items() if n}:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def codebook_sweeps(torch, label, pts, spec, built) -> float:
    """Rows 1 and 2 at one codebook fit's shape: the (layer, head) fit of
    `spec` on `pts` (n, d) float64 again through its plan, its centroids
    equal to `built` (the build's), then its opened centers replayed
    through the kernels (one lane, as the fit launches them) and through
    the plain sweeps: the same weights bit for bit after every center,
    tile sums to `RTOL`; and the solo call forms at the last weights
    against the plain versions.  Returns the largest abs error."""
    from repro_torch.core import device_seeding as ds
    from repro_torch.core.plan import ClusterPlan, ExecutionSpec
    from repro_torch.kernels import ops, ref

    plan = ClusterPlan(spec, ExecutionSpec())
    prep = plan.prepare_data(pts)
    res = plan.fit_prepared(prep)
    centers = torch.from_numpy(res.centers.cpu().numpy().astype(np.float64))
    if not torch.equal(centers.to(device=built.device, dtype=built.dtype),
                       built):
        raise AssertionError(f"{label}: the fit again gave other centroids "
                             "than the build")
    lo_raw, hi_raw, meta = prep.artifacts
    tile = plan.execution.tile
    kw = dict(scale=meta["scale"], num_levels=meta["num_levels"])
    ts, open_k, w_k, _ = ds._initial_state(lo_raw, hi_raw, m_init=meta[
        "m_init"], tile=tile, **kw)
    lo = ds._pad_axis(lo_raw, 2, ts.n_pad)
    hi = ds._pad_axis(hi_raw, 2, ts.n_pad)
    t = lo.shape[0]
    w_p, worst_rel = w_k.clone(), 0.0
    for step, x in enumerate(res.indices.tolist()):
        w_k, s_k = open_k(w_k, x)
        for ti in range(t - 1):
            w_p = ref.tree_sep_update_ref(lo[ti], hi[ti], lo[ti, :, x],
                                          hi[ti, :, x], w_p, **kw)
        w_p, s_p = ref.tree_sep_update_tiles_ref(
            lo[t - 1], hi[t - 1], lo[t - 1, :, x], hi[t - 1, :, x], w_p,
            block_n=tile, **kw)
        rel = float(((s_k - s_p).abs()
                     / s_p.abs().clamp_min(1e-30)).max())
        worst_rel = max(worst_rel, rel)
        if not torch.equal(w_k, w_p) or rel > RTOL:
            raise AssertionError(f"{label}: center {step} (point {x}): "
                                 f"weights equal {torch.equal(w_k, w_p)}, "
                                 f"tile sums rel {rel}")
    x = int(res.indices[len(res.indices) // 2])
    errs = []
    for ti in range(t - 1):
        out = ops.tree_sep_update(lo[ti], hi[ti], lo[ti, :, x], hi[ti, :, x],
                                  w_p, **kw)
        plain = ref.tree_sep_update_ref(lo[ti], hi[ti], lo[ti, :, x],
                                        hi[ti, :, x], w_p, **kw)
        errs.append(float((out - plain).abs().max()))
        if not torch.equal(out, plain):
            raise AssertionError(f"{label}: tree_sep_update, tree {ti}: "
                                 f"max abs {errs[-1]}")
    out, sums = ops.tree_sep_update_tiles(
        lo[t - 1], hi[t - 1], lo[t - 1, :, x], hi[t - 1, :, x], w_p,
        block_n=tile, **kw)
    plain, psums = ref.tree_sep_update_tiles_ref(
        lo[t - 1], hi[t - 1], lo[t - 1, :, x], hi[t - 1, :, x], w_p,
        block_n=tile, **kw)
    rel = float(((sums - psums).abs() / psums.abs().clamp_min(1e-30)).max())
    errs += [float((out - plain).abs().max()),
             float((sums - psums).abs().max())]
    if not torch.equal(out, plain) or rel > RTOL:
        raise AssertionError(f"{label}: tree_sep_update_tiles: w' equal "
                             f"{torch.equal(out, plain)}, tile sums rel {rel}")
    log(f"  {label}: the fit again, the build's centroids; its "
        f"{len(res.indices)} centers replayed through the kernels ({t - 1} "
        f"tree_sep_update and 1 tree_sep_update_tiles launch a center, "
        f"n_pad {ts.n_pad}, H-1 {lo.shape[1]}) and the plain sweeps: weights "
        f"bit-identical after every center, tile sums max rel err "
        f"{worst_rel:.3g} (rtol {RTOL}); the solo call forms at the last "
        f"weights: w' bit-identical, tile sums rel {rel:.3g}")
    return max(errs)


def cluster_kv_phase(torch, t_start, params, cfg) -> dict:
    """Phase 14b: yi-9b (phase 12's weights) with `cluster_kv`: a prompt
    of `CKV_PROMPT` tokens through `prefill`, each layer's clustered cache
    built from its K/V on the card (one fastkmeans++/device fit a KV head:
    2C and C sweep launches), `CKV_STEPS` decode steps over the stacked
    caches timed beside the plain decode at the same context, then the
    exactness check layer by layer.  Returns the build's launch counts."""
    import dataclasses

    from repro_torch.core.plan import ClusterSpec
    from repro_torch.kernels import ops
    from repro_torch.models import attention, decode_step
    from repro_torch.models import cluster_attn as CA
    from repro_torch.models.layers import apply_mlp, apply_norm
    from repro_torch.models.model import layer_slice
    from repro_torch.serving.prefill import prefill

    dev = torch.device("cuda")
    n, c, topc, steps = CKV_PROMPT, CKV_CLUSTERS, CKV_TOPC, CKV_STEPS
    depth = CKV_LAYERS
    cfg = dataclasses.replace(cfg, num_layers=depth)

    def first_layers(tree):
        return {key: first_layers(node) if isinstance(node, dict) else
                node[:depth] for key, node in tree.items()}

    params = dict(params,
                  groups={"pos00": first_layers(params["groups"]["pos00"])})
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    ccfg = dataclasses.replace(cfg, cluster_kv=True, cluster_kv_clusters=c,
                               cluster_kv_topc=topc)
    kv_cfg = CA.ClusterKVConfig(num_clusters=c, topc=topc)
    log(f"[{time.perf_counter() - t_start:.1f} s] clustered KV on "
        f"{cfg.name}'s first {depth} layers: 1 prompt of {n} tokens, C = "
        f"{c}, topc = {topc}")
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        1, cfg.vocab_size, (1, n)), device=dev)
    logits, cache = prefill(params, cfg, {"tokens": prompt}, max_seq=n)
    k_all, v_all = cache["groups"]["pos00"]["k"], cache["groups"]["pos00"]["v"]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    layers, dropped = [], []
    for layer in range(depth):
        info = {}
        layers.append(CA.build_clustered_cache(
            k_all[layer], v_all[layer], kv_cfg, seed=SEED + layer,
            info=info))
        dropped.append(info["dropped_frac"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    fits = depth * hk
    expect_launches("the clustered build", counts, {
        "tree_sep_update": 2 * c * fits, "tree_sep_update_tiles": c * fits})
    cap = layers[0]["k_slots"].shape[3]
    log(f"  build: {fits} fastkmeans++/device fits of k = {c} on {n} points "
        f"of d = {hd} (+ {kv_cfg.lloyd_iters} Lloyd steps, float64 assign) "
        f"in {build_s:.3f} s ({build_s / fits * 1e3:.2f} ms a fit; budget "
        f"60 s{'' if build_s <= 60 else ', OVER'}); launches "
        f"{ {k: v for k, v in counts.items() if v} } ({2 * c} and {c} a "
        f"fit); capacity {cap} slots a cluster; dropped share mean "
        f"{sum(dropped) / depth:.4f}, max {max(dropped):.4f}")
    # Rows 1 and 2 at this path's shape, on the first and the last fit.
    for layer, h in ((0, 0), (depth - 1, hk - 1)):
        spec = ClusterSpec(k=c, seeder=kv_cfg.seeder,
                           lloyd_iters=kv_cfg.lloyd_iters,
                           seed=SEED + layer + h)
        codebook_sweeps(torch, f"layer {layer}, KV head {h}",
                        k_all[layer][0, :, h, :].double().cpu().numpy(), spec,
                        layers[layer]["centroids"][0, h])
    stacked = {"index": torch.tensor(n, device=dev), "groups": {"pos00": {
        leaf: torch.stack([lc[leaf] for lc in layers])
        for leaf in layers[0]}}}
    del layers, cache, k_all, v_all

    def decode_run(run_cfg, run_cache, first):
        cur, out = first, []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(steps):
            lg, run_cache = decode_step(params, run_cfg, cur, run_cache)
            cur = torch.argmax(lg, dim=-1)
            out.append(cur)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"decode ({run_cfg.cluster_kv}): logits "
                                 "not finite")
        return secs, torch.stack(out, dim=1).cpu().numpy(), run_cache

    first = torch.argmax(logits, dim=-1)
    ops.reset_launch_counts()
    ckv_s, ckv_tokens, stacked = decode_run(ccfg, stacked, first)
    expect_launches("clustered decode", ops.launch_counts(), {})
    ring = stacked["groups"]["pos00"]["recent_len"]
    if not bool((ring == steps).all()) or ckv_tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"clustered decode: ring {ring.tolist()}")
    del stacked
    _, plain_cache = prefill(params, cfg, {"tokens": prompt},
                             max_seq=n + steps)
    plain_s, plain_tokens, _ = decode_run(cfg, plain_cache, first)
    del plain_cache
    # KV bytes a step reads in bf16: the plain decode reads the whole
    # cache of max_seq rows; the clustered one the centroids, the topc
    # clusters' slots (K, V and the valid byte) and the ring.
    plain_bytes = depth * 2 * (n + steps) * hk * hd * 2
    ckv_bytes = depth * hk * (c * hd * 2 + topc * cap * (2 * hd * 2 + 1)
                              + 2 * kv_cfg.recent_window * hd * 2)
    same = float((ckv_tokens == plain_tokens).mean())
    log(f"  decode {steps} steps of 1 token at context {n}: clustered "
        f"{ckv_s:.4f} s ({ckv_s / steps * 1e3:.3f} ms a step, {ckv_bytes} "
        f"KV bytes a step), plain {plain_s:.4f} s "
        f"({plain_s / steps * 1e3:.3f} ms a step, {plain_bytes} KV bytes a "
        f"step); greedy tokens equal in {same:.3f} of the steps "
        f"(information)")

    # Exactness, layer by layer: at topc = C with a capacity of S (nothing
    # can drop), a layer's clustered decode of token n - 1 over the
    # codebooks of tokens 0..n-2 and the ring holding token n - 1 (the
    # second call; the first appended it) attends exactly the tokens the
    # plain decode attends.  f32 activations over the bf16 weights.
    ce = CKV_EXACT_CLUSTERS
    ecfg = dataclasses.replace(cfg, dtype="float32", cluster_kv=True,
                               cluster_kv_clusters=ce, cluster_kv_topc=ce)
    exact_kv = CA.ClusterKVConfig(num_clusters=ce, topc=ce,
                                  capacity_slack=float(ce))
    m = n - 1
    at = torch.tensor(m, device=dev)
    worst, first_rel = 0.0, []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        x = params["embed"]["tokens"][prompt].to(torch.float32)
        for layer in range(CKV_EXACT_LAYERS):
            lp = layer_slice(params["groups"]["pos00"], layer)
            h = apply_norm(lp["norm1"], x, ecfg)
            y_f, kv = attention.attn_forward(lp["attn"], h, ecfg,
                                             return_cache=True)
            info = {}
            cc = CA.build_clustered_cache(kv["k"][:, :m], kv["v"][:, :m],
                                          exact_kv, seed=SEED + layer,
                                          info=info)
            if info["dropped_frac"] != 0.0:
                raise AssertionError(f"layer {layer}: dropped {info}")
            plain = {leaf: torch.zeros_like(kv[leaf]) for leaf in ("k", "v")}
            for leaf in ("k", "v"):
                plain[leaf][:, :m] = kv[leaf][:, :m]
            xt = h[:, m:]
            y_p, _ = attention.attn_decode(lp["attn"], xt, plain, at, ecfg)
            attention.attn_decode_clustered(lp["attn"], xt, cc, at, ecfg)
            y_c, _ = attention.attn_decode_clustered(lp["attn"], xt, cc, at,
                                                     ecfg)
            rel = float((y_c - y_p).abs().max() / y_p.abs().max())
            worst = max(worst, rel)
            if layer < 3:
                first_rel.append(f"{rel:.3g}")
            x = x + y_f
            x = x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, ecfg),
                              ecfg)
            del kv, cc, plain
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    exact_fits = CKV_EXACT_LAYERS * hk
    expect_launches("the exactness check", ops.launch_counts(), {
        "flash_attention": CKV_EXACT_LAYERS,
        "tree_sep_update": 2 * ce * exact_fits,
        "tree_sep_update_tiles": ce * exact_fits})
    if worst > LAYER_TOL:
        raise AssertionError(f"clustered decode against attn_decode: worst "
                             f"relative difference {worst}")
    log(f"  exactness through the first {CKV_EXACT_LAYERS} layers, f32 "
        f"activations over the bf16 weights: attn_decode_clustered at topc = C = {ce}, capacity "
        f"{m} (no drops), against attn_decode on the same input at "
        f"position {m}: worst max abs diff {worst:.3g} of the layer's "
        f"largest output (tol {LAYER_TOL}; layers 0 to 2: "
        f"{', '.join(first_rel)}); {exact_fits} more fits, "
        f"{exact_s:.3f} s")
    log(f"[{time.perf_counter() - t_start:.1f} s] clustered KV done")
    return counts


def deepseek_phase(torch, t_start) -> tuple:
    """Phase 14c: deepseek-v2-lite-16b at full width, random bf16 weights
    drawn on the card: `prefill` on `MOE_BATCH` x `MOE_PROMPT` tokens (one
    flash launch a layer, q and k of 192 and v of 128), `Engine.generate`
    (replay prefill) twice with the same tokens, the MLA layer check, and
    the kernel at MLA's shape against its plain version, SDPA and its
    bound.  Returns (the prefill's launch counts, the kernel's numbers at
    that shape)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    dev = torch.device("cuda")
    cfg = get_config("deepseek-v2-lite-16b")
    b, s = MOE_BATCH, MOE_PROMPT
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} at full width")
    params, gen = draw_params(torch, cfg, DEEPSEEK_PARAMS)
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, s)),
                           device=dev)
    prefill(params, cfg, {"tokens": toks[:, :64]}, max_seq=64)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    last, cache = prefill(params, cfg, {"tokens": toks}, max_seq=s)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_launches(f"{cfg.name} prefill", counts,
                    {"flash_attention": cfg.num_layers})
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{cfg.name} prefill: logits not finite")
    log(f"  prefill {b} x {s} tokens: {prefill_s:.4f} s "
        f"({b * s / prefill_s:.1f} tokens/s), launches "
        f"{ {k: v for k, v in counts.items() if v} }, latent cache "
        f"{tuple(cache['groups']['pos00']['c_kv'].shape)} and dense0 "
        f"{tuple(cache['dense0']['c_kv'].shape)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del last, cache

    prompts = rng.integers(1, cfg.vocab_size, (b, MOE_SHORT)).astype(np.int32)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=MOE_SHORT_NEW,
                                          max_seq=MOE_SHORT + MOE_SHORT_NEW
                                          + 8))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    gen_s = time.perf_counter() - t0
    expect_launches(f"{cfg.name} generate (replay prefill)",
                    ops.launch_counts(), {})
    again = eng.generate(prompts)
    if not np.array_equal(out, again) or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} generate: a second run gave "
                             "other tokens")
    log(f"  generate (replay prefill: the leading dense layer): {b} prompts "
        f"x {MOE_SHORT} tokens, {MOE_SHORT_NEW} new: {gen_s:.4f} s "
        f"({MOE_SHORT + MOE_SHORT_NEW} decode steps, no kernel); a second "
        f"run gave the same tokens; first sequence starts "
        f"{out[0, :8].tolist()}")
    del eng
    mla_layers(torch, params, cfg, toks[:, :REPLAY_PROMPT])
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    # The kernel at MLA's shape: q, k (B, S, 16, 192) and v (B, S, 16, 128).
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    h, d = cfg.num_heads, nope + rope
    q, k = (torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn((b, s, h, vd), generator=gen, device=dev).to(
        torch.bfloat16)
    err = check_attention(torch, ops, ref, q, k, v, True,
                          "at MLA's prefill shape, causal", ATTN_TOL)
    numbers = attention_numbers(torch, q, k, v, causal=True,
                                label="at MLA's shape (m)")
    numbers["max_abs_err"] = err
    del q, k, v
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} done")
    return counts, numbers


def mla_layers(torch, params, cfg, short) -> float:
    """MLA's attention layer by layer through the whole depth (the dense
    layer, then the MoE groups): each layer's prefill attention
    (`attn_forward`, one kernel launch) against its absorbed decode
    (`attn_decode` over its latent cache, one step a token, no kernel) on
    the same normed input, f32 activations over the bf16 weights; raises
    past `LAYER_TOL` of the layer's largest output."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models.layers import apply_mlp, apply_norm
    from repro_torch.models.model import layer_slice
    from repro_torch.models.moe import apply_moe

    dev = short.device
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    b, n = short.shape
    at = torch.arange(n, device=dev)
    layers = [(params[f"dense{i}"], False) for i in range(cfg.first_k_dense)]
    layers += [(layer_slice(params["groups"]["pos00"], g), True)
               for g in range(cfg.num_layers - cfg.first_k_dense)]
    worst, first = 0.0, []
    ops.reset_launch_counts()
    with torch.inference_mode():
        x = params["embed"]["tokens"][short].to(torch.float32)
        for i, (lp, is_moe) in enumerate(layers):
            h = apply_norm(lp["norm1"], x, f32cfg)
            y_f, _ = attention.attn_forward(lp["attn"], h, f32cfg)
            cache = {"c_kv": torch.zeros((b, n, cfg.kv_lora_rank),
                                         device=dev),
                     "k_rope": torch.zeros((b, n, cfg.qk_rope_dim),
                                           device=dev)}
            y_d = torch.empty_like(y_f)
            for t in range(n):
                y_d[:, t: t + 1], cache = attention.attn_decode(
                    lp["attn"], h[:, t: t + 1], cache, at[t], f32cfg)
            rel = float((y_f - y_d).abs().max() / y_f.abs().max())
            worst = max(worst, rel)
            if i < 3:
                first.append(f"{rel:.3g}")
            x = x + y_f
            h2 = apply_norm(lp["norm2"], x, f32cfg)
            x = x + (apply_moe(lp["moe"], h2, f32cfg)[0] if is_moe
                     else apply_mlp(lp["mlp"], h2, f32cfg))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect_launches("MLA layer by layer", counts,
                    {"flash_attention": cfg.num_layers})
    if worst > LAYER_TOL:
        raise AssertionError(f"MLA layer by layer: worst relative "
                             f"difference {worst}")
    log(f"  MLA layer by layer through all {cfg.num_layers} layers, f32 "
        f"activations over the bf16 weights, {b} x {n} tokens: prefill "
        f"attention ({counts['flash_attention']} kernel launches, D "
        f"{cfg.qk_nope_dim + cfg.qk_rope_dim}, Dv {cfg.v_head_dim}) against "
        f"the absorbed decode ({n} steps a layer, no kernel): worst max abs "
        f"diff {worst:.3g} of the layer's largest output (tol {LAYER_TOL}; "
        f"layers 0 to 2: {', '.join(first)})")
    return worst


def qwen_moe_phase(torch, t_start) -> dict:
    """Phase 14d: qwen2-moe-a2.7b at full width (60 routed experts padded to
    64, 4 shared), random bf16 weights drawn on the card: `Engine.generate`
    on `MOE_BATCH` x `MOE_PROMPT` tokens, 32 new, greedy, twice with the
    same tokens (one flash launch a layer in the fused prefill), no token
    routed to a padded expert, and the engine's steps timed apart.  Returns
    the generate's launch counts and the kernel's numbers at the prefill's
    shape (against its plain version, timed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import decode_step, moe
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    dev = torch.device("cuda")
    cfg = get_config("qwen2-moe-a2.7b")
    b, s, new = MOE_BATCH, MOE_PROMPT, SERVE_NEW
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} at full width")
    params, gen = draw_params(torch, cfg, QWEN_MOE_PARAMS)
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)
    serve = ServeConfig(max_new_tokens=new, max_seq=s + 40)
    eng = Engine(params, cfg, serve)
    eng.serve = dataclasses.replace(serve, max_new_tokens=1)
    eng.generate(prompts)                       # warm-up
    eng.serve = serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts)
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_launches(f"{cfg.name} generate", counts,
                    {"flash_attention": cfg.num_layers})
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    again = eng.generate(prompts)
    if not np.array_equal(tokens, again) or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} generate: a second run gave "
                             "other tokens")
    log(f"  generate: {b} prompts x {s} tokens, {new} new each: "
        f"{gen_s:.4f} s; launches {counts}; peak device memory "
        f"{peak_gib:.3f} GiB; a second run gave the same tokens; first "
        f"sequence starts {tokens[0, :8].tolist()}")
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    timed_steps(torch, params, cfg, toks, serve, tokens)

    # Routing: the experts each prefill token and decode token chose.
    seen, route = [], moe.route

    def spy(p, xf, c):
        out = route(p, xf, c)
        seen.append(out[1].max())
        return out

    moe.route = spy
    try:
        _, cache = prefill(params, cfg, {"tokens": toks}, max_seq=s + 8)
        decode_step(params, cfg, toks[:, -1], cache)
    finally:
        moe.route = route
    top = int(torch.stack(seen).max())
    if top >= cfg.num_experts or len(seen) != 2 * cfg.num_layers:
        raise AssertionError(f"{cfg.name}: a token routed to expert {top} "
                             f"({len(seen)} routings)")
    log(f"  routing: the highest expert any prefill or decode token chose is "
        f"{top}, of {cfg.num_experts} routed and {moe.phys_experts(60)} "
        f"physical ({len(seen)} routings)")
    del params, eng, cache, toks
    gc.collect()
    torch.cuda.empty_cache()
    # The kernel at the prefill's shape against its plain version.
    q, k, v = (torch.randn((b, s, n, cfg.head_dim), generator=gen,
                           device=dev).to(torch.bfloat16)
               for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    err = check_attention(torch, ops, ref, q, k, v, True,
                          f"at {cfg.name}'s prefill shape, causal", ATTN_TOL)
    numbers = attention_numbers(torch, q, k, v, causal=True,
                                label=f"at {cfg.name}'s prefill shape (q)")
    numbers["max_abs_err"] = err
    del q, k, v
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} done")
    return counts, numbers


def attention_numbers(torch, q, k, v, *, causal: bool, label: str,
                      prefix_len: int = 0) -> dict:
    """Row 8 at one shape: the kernel's time (CUDA events, best of two
    runs of 20 launches), the plain version's, one
    `scaled_dot_product_attention` call's on the same inputs (a boolean
    mask for a prefix; the yardstick only, the port never calls it) and
    the bound: 2 (D + Dv) operations a visible (query, key) pair a head on
    the bf16 tensor cores (bf16 inputs) or at the TF32 rate (f32 inputs,
    the f32-rate figure beside), or the bytes (each input read once, the
    f32 output written once)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda as fa_cuda
    from repro_torch.kernels import ops, ref

    b, s, h, d = q.shape
    dv = v.shape[3]
    scale = d ** -0.5

    def kernel(i):
        fa_cuda.launch(q, k, v, scale=scale, causal=causal,
                       prefix_len=prefix_len)

    ms = cuda_ms(torch, kernel, 20)
    plain_ms = cuda_ms(torch, lambda i: ref.attention_bshd_ref(
        q, k, v, scale=scale, causal=causal, prefix_len=prefix_len), 3)
    ms_again = cuda_ms(torch, kernel, 20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"scale": scale, "enable_gqa": k.shape[2] != h}
    if prefix_len:
        pos = torch.arange(s, device=q.device)
        kw["attn_mask"] = ref.prefix_causal_mask(pos, pos, prefix_len)
    else:
        kw["is_causal"] = causal
    try:
        lib_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, **kw), 20)
    except RuntimeError as exc:     # the yardstick only, never in the port
        log(f"  scaled_dot_product_attention refused {label}: {exc}")
        lib_ms = None
    pairs = ops.attention_pairs(s, causal, prefix_len)
    ops_count = 2 * pairs * (d + dv) * b * h
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()) + \
        4 * b * s * h * dv
    f32 = q.dtype == torch.float32
    rate = TF32_OPS_PER_S if f32 else BF16_OPS_PER_S
    b_ms, b_by = bound(nbytes, ops_count, rate)
    out = {"ms": min(ms, ms_again), "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    rate_note = "on the bf16 tensor cores"
    if f32:
        out["bound_ms_f32_rate"] = bound(nbytes, ops_count)[0]
        rate_note = (f"at the TF32 rate; {out['bound_ms_f32_rate']:.6f} ms "
                     f"at the 67 TFLOP/s of f32")
    log(f"time flash_attention {label}: q {tuple(q.shape)} k "
        f"{tuple(k.shape)} v {tuple(v.shape)} {str(q.dtype)[6:]}, causal "
        f"{causal}, prefix {prefix_len}: kernel {ms:.6f} / {ms_again:.6f} "
        f"ms, plain {plain_ms:.6f} ms, library (scaled_dot_product_attention,"
        f" {str(q.dtype)[6:]} in, {'f32' if f32 else 'bf16'} out) {lib_ms} "
        f"ms, bound {b_ms:.6f} ms ({b_by}; {pairs} visible pairs a head, "
        f"{ops_count} operations {rate_note}, {nbytes} bytes), "
        f"{b_ms / min(ms, ms_again):.4f} of the bound")
    return out


def draw_params(torch, cfg, want: int):
    """`cfg`'s random bf16 parameters drawn on the card from `SEED`, after
    checking their count against `want`."""
    from repro_torch.models import init_params, param_specs

    if cfg.param_count() != want:
        raise AssertionError(f"{cfg.name}: {cfg.param_count()} parameters")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(param_specs(cfg), gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    log(f"  parameters: {cfg.param_count()} in bf16 drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params, gen


def mixer_times(torch, params, cfg, toks) -> None:
    """Each block type's mixer alone on layer 0's normed input, the
    chunked scan with its projections: ms a layer (CUDA events, best of
    two runs of 2)."""
    from repro_torch.models import mamba, rwkv6
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.model import layer_slice
    from repro_torch.models.transformer import layer_layout

    positions = layer_layout(cfg).positions
    with torch.inference_mode():
        x = params["embed"]["tokens"][toks].to(torch.bfloat16)
        for p, (bt, _) in enumerate(positions):
            if bt == "attn" or bt in [t for t, _ in positions[:p]]:
                continue
            layer = layer_slice(params["groups"][f"pos{p:02d}"], 0)
            h = apply_norm(layer["norm1"], x, cfg)
            if bt == "mamba":
                mix = lambda i: mamba.mamba_forward(layer["mixer"], h, cfg)
            else:
                mix = lambda i: rwkv6.rwkv_time_forward(layer["time_mix"], h,
                                                        cfg)
            mix_ms = min(cuda_ms(torch, mix, 2), cuda_ms(torch, mix, 2))
            log(f"  {bt} mixer of one layer (the chunked scan and its "
                f"projections) on {tuple(toks.shape)} tokens: "
                f"{mix_ms:.3f} ms")


def recurrent_phase(torch, t_start, arch: str, cuts: dict) -> dict:
    """Phases 15a (rwkv6-3b at full width and depth) and 15b
    (jamba-1.5-large-398b at full width, cut by `cuts`): `forward` on
    `SSM_BATCH` x `SSM_FORWARD` tokens (the chunked scans; one
    `flash_attention` launch for each attention layer), timed, with each
    block type's mixer timed alone on layer 0; `Engine.generate` (the
    prompt replayed through `decode_step`, no kernel), timed whole, and
    `Engine.replay_prefill` alone on the same prompts, timed; and the gate:
    the forward's last logits against the replay's on the same prompts,
    f32 activations over the
    bf16 weights, within `GATE_TOL` of the largest (MoE capacity raised so
    that nothing drops, since the forward's one window and the replay's
    windows of one token drop differently).  Returns the forward's launch
    counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import forward
    from repro_torch.models.transformer import layer_layout
    from repro_torch.serving.engine import Engine, ServeConfig

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), **cuts)
    layout = layer_layout(cfg)
    n_attn = layout.num_groups * sum(bt == "attn" for bt, _ in
                                     layout.positions)
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} at full width"
        + (f", cut to {cuts}" if cuts else " and depth"))
    params, _ = draw_params(torch, cfg, SSM_PARAMS[arch])
    rng = np.random.default_rng(SEED)
    b, s = SSM_BATCH, SSM_FORWARD
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, s)),
                           device=dev)
    forward(params, cfg, {"tokens": toks[:, :64]})           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, _, _ = forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_launches(f"{cfg.name} forward", counts,
                    {"flash_attention": n_attn})
    if logits.shape != (b, s, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} forward: bad logits")
    log(f"  forward {b} x {s} tokens: {fwd_s:.4f} s "
        f"({b * s / fwd_s:.1f} tokens/s), launches "
        f"{ {k: v for k, v in counts.items() if v} }; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del logits

    mixer_times(torch, params, cfg, toks)
    prompt, new = SSM_PROMPT[arch]
    prompts = rng.integers(1, cfg.vocab_size, (b, prompt)).astype(np.int32)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=new,
                                          max_seq=prompt + new + 8))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts)
    gen_s = time.perf_counter() - t0
    expect_launches(f"{cfg.name} generate (replay prefill)",
                    ops.launch_counts(), {})
    if tokens.shape != (b, new) or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} generate: bad tokens {tokens}")
    # The replay alone on the same prompts: its seconds, and its last
    # logits for the bf16 comparison below.
    short = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    last = eng.replay_prefill(short)[0]
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    decode_s = gen_s - replay_s
    log(f"  generate: {b} prompts x {prompt} tokens, {new} new each: "
        f"{gen_s:.4f} s; the replay prefill alone {replay_s:.4f} s "
        f"({replay_s / prompt * 1e3:.3f} ms a step), the rest {new} decode "
        f"steps {decode_s:.4f} s ({decode_s / new * 1e3:.3f} ms a step of "
        f"{b} tokens); first sequence starts {tokens[0, :8].tolist()}")

    # The gate: forward (the chunked scans) against replay (the step
    # recurrences, the states written in place) on the same prompts, in f32
    # activations; in bf16 against the replay above, for information.
    gcfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.num_experts:
        gcfg = dataclasses.replace(
            gcfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    info = {}
    for label, c in (("f32 activations", gcfg), ("bf16", cfg)):
        lf = forward(params, c, {"tokens": short})[0][:, -1].float()
        lr = last if c is cfg else Engine(
            params, c, ServeConfig(max_seq=prompt + 8)).replay_prefill(
                short)[0]
        lr = lr.float()
        info[label] = (float((lf - lr).abs().max() / lf.abs().max()),
                       int((lf.argmax(-1) == lr.argmax(-1)).sum()))
    rel, same = info["f32 activations"]
    if not rel <= GATE_TOL:
        raise AssertionError(f"{cfg.name}: forward against replay {rel}")
    log(f"  gate: the forward's last logits against the replay's on {b} x "
        f"{prompt} tokens, f32 activations over the bf16 weights: max abs "
        f"diff {rel:.3g} of the largest (tol {GATE_TOL}), argmax equal in "
        f"{same} of {b} rows; in bf16 (information) {info['bf16'][0]:.3g}, "
        f"argmax equal in {info['bf16'][1]} of {b}")
    del params, eng, last, toks, short
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} done")
    return counts


def paligemma_phase(torch, t_start) -> tuple:
    """Phase 15c: paligemma-3b at full width and depth: `prefill` of
    `VLM_PATCHES` image patches ahead of `VLM_TEXT` text tokens, 4
    sequences (one `flash_attention` launch a layer with the prefix of
    full attention), then `VLM_STEPS` decode steps, timed; then row 8 at
    the prefill's shape against its plain version with the path's prefix,
    one that ends inside a query block and one near S, prefixes 0 and 1
    bit-identical to the causal launch, and its numbers.  Returns (the
    prefill's launch counts, the kernel's numbers at this shape)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import decode_step
    from repro_torch.serving.prefill import prefill

    dev = torch.device("cuda")
    cfg = get_config("paligemma-3b")
    b, s = SSM_BATCH, VLM_PATCHES + VLM_TEXT
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} at full width "
        "and depth")
    params, gen = draw_params(torch, cfg, PALIGEMMA_PARAMS)
    rng = np.random.default_rng(SEED)
    batch = {"patches": torch.randn((b, VLM_PATCHES, cfg.frontend_dim),
                                    generator=gen, device=dev).to(
                                        torch.bfloat16),
             "tokens": torch.as_tensor(rng.integers(
                 1, cfg.vocab_size, (b, VLM_TEXT)), device=dev)}
    prefill(params, cfg, {"patches": batch["patches"][:1],
                          "tokens": batch["tokens"][:1, :256]})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    last, cache = prefill(params, cfg, batch, max_seq=s + VLM_STEPS + 8)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_launches(f"{cfg.name} prefill", counts,
                    {"flash_attention": cfg.num_layers})
    if int(cache["index"]) != s or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{cfg.name} prefill: index "
                             f"{int(cache['index'])}, or logits not finite")
    cur = torch.argmax(last, dim=-1)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(VLM_STEPS):
        step, cache = decode_step(params, cfg, cur, cache)
        cur = torch.argmax(step, dim=-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    expect_launches(f"{cfg.name} decode", ops.launch_counts(), {})
    if int(cache["index"]) != s + VLM_STEPS or \
            not bool(torch.isfinite(step).all()):
        raise AssertionError(f"{cfg.name} decode: bad steps")
    log(f"  prefill {b} x ({VLM_PATCHES} patches + {VLM_TEXT} text tokens), "
        f"prefix {cfg.prefix_len}: {prefill_s:.4f} s "
        f"({b * s / prefill_s:.1f} tokens/s), launches "
        f"{ {k: v for k, v in counts.items() if v} }; {VLM_STEPS} decode "
        f"steps {decode_s:.4f} s ({decode_s / VLM_STEPS * 1e3:.3f} ms a step "
        f"of {b} tokens); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del params, cache, last, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # Row 8 at the prefill's shape: 8 query heads over 1 KV head of 256.
    q, k, v = (torch.randn((b, s, n, cfg.head_dim), generator=gen,
                           device=dev).to(torch.bfloat16)
               for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    err = max(check_attention(torch, ops, ref, q, k, v, True,
                              f"at {cfg.name}'s prefill shape, prefix {p}",
                              ATTN_TOL, prefix_len=p) for p in VLM_PREFIXES)
    scale = cfg.head_dim ** -0.5
    causal = ops.attention_bshd(q, k, v, scale=scale, causal=True)
    for p in (0, 1):
        if not torch.equal(ops.attention_bshd(q, k, v, scale=scale,
                                              causal=True, prefix_len=p),
                           causal):
            raise AssertionError(f"flash_attention: prefix {p} is not the "
                                 "causal launch bit for bit")
    log("flash_attention: prefixes 0 and 1 bit-identical to the causal "
        "launch")
    numbers = attention_numbers(torch, q, k, v, causal=True,
                                prefix_len=cfg.prefix_len,
                                label=f"at {cfg.name}'s prefill shape (p)")
    numbers["max_abs_err"] = err
    del q, k, v, causal
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} done")
    return counts, numbers


def hubert_phase(torch, t_start) -> tuple:
    """Phase 15d: hubert-xlarge at full width and depth: `forward` on
    `SSM_BATCH` x `AUDIO_FRAMES` frame embeddings (one non-causal
    `flash_attention` launch a layer, 16 heads of 80), timed; then row 8
    at that shape against its plain version, and its numbers.  Returns
    (the forward's launch counts, the kernel's numbers at this shape)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import forward

    dev = torch.device("cuda")
    cfg = get_config("hubert-xlarge")
    b, s = SSM_BATCH, AUDIO_FRAMES
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} at full width "
        "and depth")
    params, gen = draw_params(torch, cfg, HUBERT_PARAMS)
    frames = torch.randn((b, s, cfg.frontend_dim), generator=gen,
                         device=dev).to(torch.bfloat16)
    forward(params, cfg, {"embeddings": frames[:1, :1024]})      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, _, _ = forward(params, cfg, {"embeddings": frames})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect_launches(f"{cfg.name} forward", counts,
                    {"flash_attention": cfg.num_layers})
    if out.shape != (b, s, cfg.vocab_size) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{cfg.name} forward: bad outputs")
    log(f"  forward {b} x {s} frames: {fwd_s:.4f} s "
        f"({b * s / fwd_s:.1f} frames/s), launches "
        f"{ {k: v for k, v in counts.items() if v} }; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del params, out, frames
    gc.collect()
    torch.cuda.empty_cache()

    q, k, v = (torch.randn((b, s, cfg.num_heads, cfg.head_dim),
                           generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    err = check_attention(torch, ops, ref, q, k, v, False,
                          f"at {cfg.name}'s shape, non-causal", ATTN_TOL)
    numbers = attention_numbers(torch, q, k, v, causal=False,
                                label=f"at {cfg.name}'s shape (h)")
    numbers["max_abs_err"] = err
    del q, k, v
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} done")
    return counts, numbers


def backward_numbers(torch, label, b, s, h, hk, d, dv, dtype, causal,
                     prefix) -> dict:
    """16a at one shape: the backward kernel's dq, dk, dv against autograd
    through the plain version (`ref.attention_bshd_ref`) on f32 copies of
    the same values, a second launch bit-identical, the forward's `out`
    the same bits with and without its log-sum-exp; the kernel's time
    (CUDA events) beside the plain backward's, SDPA's backward through
    autograd (the yardstick only) and the bound: the five products, 2 (3 D
    + 2 Dv) operations a visible pair, at the TF32 rate for f32 (the
    kernel's 3xTF32; the f32-rate figure beside) or the bf16 rate, or the
    bytes (q, k, v, out, dO and lse read once, dq, dk, dv written once)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda as fa_cuda
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, dv)))
    dout = torch.randn((b, s, h, dv), generator=gen, device=dev)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal, prefix_len=prefix)
    out, lse = fa_cuda.launch(q, k, v, with_lse=True, **kw)
    if not torch.equal(out, fa_cuda.launch(q, k, v, **kw)):
        raise AssertionError(f"flash_attention {label}: out differs with "
                             "the log-sum-exp asked for")
    grads = fa_cuda.launch_backward(q, k, v, out, dout, lse, **kw)
    again = fa_cuda.launch_backward(q, k, v, out, dout, lse, **kw)
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        raise AssertionError(f"flash_attention_bwd {label}: a second launch "
                             "gave other bits")
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    plain_out = ref.attention_bshd_ref(*leaves, **kw)
    plain = torch.autograd.grad(plain_out, leaves, dout, retain_graph=True)
    errs, rels = [], []
    for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
        if g.dtype != dt or g.shape != p.shape:
            raise AssertionError(f"flash_attention_bwd {label}: {name} "
                                 f"{g.dtype} {tuple(g.shape)}")
        err = float((g.float() - p).abs().max())
        errs.append(err)
        rels.append(err / float(p.abs().max()))
    tol = BWD_TOL[dtype]
    if not max(rels) <= tol:
        raise AssertionError(f"flash_attention_bwd {label}: errors {rels} "
                             f"of the largest |gradient|, tolerance {tol}")

    def kernel(i):
        fa_cuda.launch_backward(q, k, v, out, dout, lse, **kw)

    ms = cuda_ms(torch, kernel, 5)
    plain_ms = cuda_ms(torch, lambda i: torch.autograd.grad(
        plain_out, leaves, dout, retain_graph=True), 2)
    ms_again = cuda_ms(torch, kernel, 5)
    del plain_out, plain, leaves
    lib_in = [t.detach().transpose(1, 2).requires_grad_(True)
              for t in (q, k, v)]
    lib_kw = {"scale": scale, "enable_gqa": hk != h}
    if causal and prefix:
        pos = torch.arange(s, device=dev)
        lib_kw["attn_mask"] = ref.prefix_causal_mask(pos, pos, prefix)
    else:
        lib_kw["is_causal"] = causal
    try:
        lib_out = F.scaled_dot_product_attention(*lib_in, **lib_kw)
        lib_dout = dout.transpose(1, 2).to(dt)
        lib_ms = cuda_ms(torch, lambda i: torch.autograd.grad(
            lib_out, lib_in, lib_dout, retain_graph=True), 5)
        del lib_out, lib_dout
    except RuntimeError as exc:     # the yardstick only, never in the port
        log(f"  scaled_dot_product_attention's backward refused {label}: "
            f"{exc}")
        lib_ms = None
    pairs = ops.attention_pairs(s, causal, prefix)
    ops_count = 2 * (3 * d + 2 * dv) * pairs * b * h
    es = q.element_size()
    nbytes = 2 * es * (q.numel() + k.numel() + v.numel()) + \
        4 * (2 * out.numel() + lse.numel())
    rate = TF32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    b_ms, b_by = bound(nbytes, ops_count, rate)
    f32_rate_ms = bound(nbytes, ops_count)[0]
    log(f"flash_attention_bwd {label}: q {tuple(q.shape)} k {tuple(k.shape)}"
        f" v {tuple(v.shape)} {dtype}, causal {causal}, prefix {prefix}: "
        f"dq, dk, dv against autograd through the plain version max abs err "
        f"{[f'{e:.3g}' for e in errs]}, {max(rels):.3g} of the largest "
        f"|gradient| (tol {tol}); a second launch bit-identical; out the "
        f"same bits with the log-sum-exp")
    log(f"time flash_attention_bwd {label}: kernel {ms:.6f} / "
        f"{ms_again:.6f} ms, plain backward (autograd) {plain_ms:.6f} ms, "
        f"library (scaled_dot_product_attention's backward) {lib_ms} ms, "
        f"bound {b_ms:.6f} ms ({b_by}; {pairs} visible pairs a head, "
        f"{ops_count} operations at {rate / 1e12:.0f} TFLOP/s, {nbytes} "
        f"bytes; {f32_rate_ms:.6f} ms at the 67 TFLOP/s of f32), "
        f"{b_ms / min(ms, ms_again):.4f} of the bound")
    del q, k, v, dout, out, lse, grads, again
    torch.cuda.empty_cache()
    out = {"ms": min(ms, ms_again), "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": max(errs), "max_rel_err": max(rels)}
    if dtype == "float32":
        out["bound_ms_f32_rate"] = f32_rate_ms
    return out


def training_phase(torch, t_start) -> tuple:
    """Phase 16: (a) the backward kernel at its shapes and row 8's forward
    at the training shape, (b) olmo-1b at full width and depth through
    `make_train_step`, (c) the `Trainer`'s kill and resume at full width
    and 2 layers.  Returns the backward's kernel row, each path's launch
    counts and row 8's numbers at the training shape."""
    import dataclasses
    import shutil
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params, param_specs
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import Trainer

    mark("16a")
    log(f"[{time.perf_counter() - t_start:.1f} s] flash_attention_bwd")
    numbers = {spec[0]: backward_numbers(torch, *spec)
               for spec in BWD_SHAPES}
    main = numbers.pop(TRAIN_ARCH)
    # Row 8's forward at the training shape (f32, 16 launches a step).
    _, b, s, h, hk, d, dv, dtype, causal, _ = BWD_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, dv)))
    fwd = attention_numbers(torch, q, k, v, causal=causal,
                            label="at olmo-1b's training shape (o), f32")
    fwd["max_abs_err"] = check_attention(
        torch, ops, ref, q, k, v, causal, "at olmo-1b's training shape, f32",
        ATTN_TOL)
    del q, k, v
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/attention.py:94", "launches": None,
           "max_abs_err": max([main["max_abs_err"]] + [
               n["max_abs_err"] for n in numbers.values()]),
           **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
    for label, n in numbers.items():
        row[f"at_{label.replace('-', '_')}_shape"] = n

    # -- 16b. olmo-1b at full width and depth, f32, through make_train_step --
    mark("16b")
    dev = torch.device("cuda")
    f32 = torch.float32
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              param_dtype="float32")
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} training at "
        f"full width and depth: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, f32; {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step, lr {TRAIN_LR}, remat none")
    if cfg.param_count() != OLMO_PARAMS:
        raise AssertionError(f"{cfg.name}: {cfg.param_count()} parameters")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(param_specs(cfg), gen, f32, dev)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    log(f"  {cfg.param_count()} f32 parameters and both moments on the card "
        f"in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=10,
                     total_steps=TRAIN_STEPS, remat="none")
    step = make_train_step(cfg, tc)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    per_step = {"flash_attention": cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers}
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    ops.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = ops.launch_counts()
        batch = {"tokens": stream.next_batch()}
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        now = ops.launch_counts()
        expect_launches(f"train step {i + 1}", {
            name: now[name] - before[name] for name in now}, per_step)
        if not math.isfinite(loss):
            raise AssertionError(f"train step {i + 1}: loss {loss}")
        log(f"  step {i + 1}: loss {loss:.6f}, grad norm "
            f"{float(metrics['grad_norm']):.6f}, lr {float(metrics['lr']):.6g}"
            f", {times[-1]:.4f} s")
    train_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times[1:]))
    nonzero = {name: n for name, n in train_counts.items() if n}
    log(f"  {TRAIN_STEPS} steps: launches {nonzero} ({per_step} a step); "
        f"median step "
        f"(steps 2 to {TRAIN_STEPS}) {med:.4f} s, "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s; peak device memory "
        f"{peak:.3f} GiB")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt,
                                    {"tokens": stream.next_batch()})
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
    busy, n_events, by_name = device_time(torch, prof)
    log(f"  a seventh step, traced: loss {loss:.6f}, wall {wall:.4f} s, "
        f"device busy {busy:.4f} s over {n_events} device events, idle "
        f"share {1 - busy / wall:.4f}")
    log_top(by_name, 6)
    # The backward kernels' device time in the traced step (their three
    # launches a call: delta, dK and dV, dQ).
    bwd_kernels = [(ms, cnt) for name, (ms, cnt) in by_name.items()
                   if any(f"{k}_kernel<" in name or f"{k}_kernel(" in name
                          for k in ("delta", "dkv", "dq"))]
    bwd_ms = sum(ms for ms, _ in bwd_kernels)
    bwd_n = sum(cnt for _, cnt in bwd_kernels)
    if bwd_n != 3 * cfg.num_layers:
        raise AssertionError(f"traced step: {bwd_n} backward kernel "
                             f"launches, want {3 * cfg.num_layers}")
    log(f"  flash_attention_bwd.cu in the traced step: {bwd_ms:.4f} ms "
        f"device time over {bwd_n} launches ({cfg.num_layers} calls), "
        f"{bwd_ms / 1e3 / busy:.4f} of the device's busy time")
    row["in_traced_train_step"] = {"device_ms": bwd_ms, "launches": bwd_n,
                                   "share_of_busy": bwd_ms / 1e3 / busy}
    del params, opt, metrics, prof, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16c. the Trainer's kill and resume, full width, 2 layers ---------
    mark("16c")
    cut = dataclasses.replace(cfg, num_layers=TRAINER_LAYERS)
    log(f"[{time.perf_counter() - t_start:.1f} s] the Trainer "
        f"(repro_torch.launch.train's loop) on {cfg.name} at full width, "
        f"{TRAINER_LAYERS} of {cfg.num_layers} layers ({cut.param_count()} "
        f"f32 parameters): {TRAINER_STEPS} steps, a checkpoint every "
        f"{TRAINER_EVERY}, a failure at step {TRAINER_FAIL}, then a resume")
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=10,
                     total_steps=TRAINER_STEPS, remat="none",
                     checkpoint_every=TRAINER_EVERY)
    root = Path(ROOT) / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(workdir, **kw):
        return Trainer(cut, tc, workdir=root / workdir, batch=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, **kw)

    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        golden_run = trainer("golden")
        golden = golden_run.run(TRAINER_STEPS)
        golden_s = time.perf_counter() - t0
        trainer_counts = ops.launch_counts()
        expect_launches("Trainer", trainer_counts, {
            name: TRAINER_LAYERS * TRAINER_STEPS for name in per_step})
        ckpt = golden_run.ckpt
        t0 = time.perf_counter()
        try:
            trainer("resume", fail_at_step=TRAINER_FAIL).run(TRAINER_STEPS)
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
        else:
            raise AssertionError("fail_at_step did not stop the run")
        fail_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = trainer("resume").run(TRAINER_STEPS)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    start = TRAINER_FAIL // TRAINER_EVERY * TRAINER_EVERY
    if resumed.resumed_from != start or \
            not np.allclose(resumed.losses, golden.losses[start:],
                            rtol=1e-6, atol=0.0) or \
            not np.isfinite(golden.losses).all():
        raise AssertionError(f"Trainer: resumed from {resumed.resumed_from},"
                             f" losses {resumed.losses} against the golden "
                             f"run's {golden.losses[start:]}")
    bits = resumed.losses == golden.losses[start:]
    log(f"  golden run {golden_s:.2f} s, losses "
        f"{[round(x, 6) for x in golden.losses]}; launches "
        f"{ {k: v for k, v in trainer_counts.items() if v} }; the run "
        f"stopped at step {TRAINER_FAIL} in {fail_s:.2f} s; resumed from "
        f"step {resumed.resumed_from} in {resume_s:.2f} s: losses of steps "
        f"{start + 1} to {TRAINER_STEPS} within rtol 1e-6 of the golden "
        f"run's, {'bit-identical' if bits else 'not bit-identical'}; a "
        f"checkpoint is {ckpt.last_bytes} bytes, its host copy "
        f"{ckpt.last_copy_seconds:.3f} s, its write "
        f"{ckpt.last_write_seconds:.3f} s (np.savez under build/)")
    log(f"[{time.perf_counter() - t_start:.1f} s] training done")
    bf16_counts, fwd_bf16, grads, bf16_step_s = bf16_training_phase(
        torch, t_start)
    ddp_counts = distributed_phase(torch, t_start, grads)
    return row, {"train": train_counts, "trainer": trainer_counts,
                 "train_bf16": bf16_counts, "ddp": ddp_counts}, fwd, \
        fwd_bf16, bf16_step_s


def bf16_training_phase(torch, t_start) -> tuple:
    """16d: olmo-1b at full width and depth in bf16 (bf16 parameters and
    activations, f32 moments, f32 accumulators) under remat "dots" through
    `make_train_step`; the same parameters and batch under "none" and
    "block" against it; row 8 at the microbatch's shape.  Returns (the
    timed steps' launch counts, row 8's numbers at that shape, the "dots"
    gradients of the first batch: f32, for 16e, the median step
    seconds)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params, param_specs
    from repro_torch.optim.adamw import init_opt_state, tree_leaves
    from repro_torch.training.train_step import (make_grads_fn,
                                                 make_train_step)

    mark("16d")
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="bfloat16",
                              param_dtype="bfloat16")
    if cfg.param_count() != OLMO_PARAMS:
        raise AssertionError(f"{cfg.name}: {cfg.param_count()} parameters")
    layers, tokens = cfg.num_layers, BF16_BATCH * BF16_SEQ
    log(f"[{time.perf_counter() - t_start:.1f} s] {cfg.name} training in "
        f"bf16 at full width and depth ({cfg.param_count()} parameters): "
        f"bf16 parameters and activations, f32 moments and accumulators, "
        f"remat dots; {BF16_BATCH} x {BF16_SEQ} tokens a step in "
        f"{BF16_MICRO} microbatches, lr {TRAIN_LR}")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(param_specs(cfg), gen, bf16, dev)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    log(f"  bf16 parameters and f32 moments on the card in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    stream = TokenStream(cfg.vocab_size, BF16_SEQ, BF16_BATCH, seed=SEED)
    first = {"tokens": stream.next_batch()}

    def tc(remat):
        return TrainConfig(learning_rate=TRAIN_LR, warmup_steps=10,
                           total_steps=BF16_STEPS + 1,
                           microbatches=BF16_MICRO, remat=remat)

    # Forward launches a microbatch: one a layer, and one more a layer
    # where the backward recomputes the group ("block" and "dots": the
    # flash kernel's autograd Function is no aten op, so "dots" cannot
    # save its output); one backward launch a layer.
    def per_step(remat):
        fwd = (1 if remat == "none" else 2) * layers * BF16_MICRO
        return {"flash_attention": fwd,
                "flash_attention_bwd": layers * BF16_MICRO}

    def grads_of(remat):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _, grads = make_grads_fn(cfg, tc(remat))(params, first)
        loss = float(loss)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        expect_launches(f"gradients under remat {remat}",
                        ops.launch_counts(), per_step(remat))
        log(f"  remat {remat}: loss {loss:.6f}, gradients in {wall:.3f} s, "
            f"peak {peak:.3f} GiB above the {base / 2**30:.3f} GiB held "
            f"before; launches {per_step(remat)}")
        if not math.isfinite(loss):
            raise AssertionError(f"remat {remat}: loss {loss}")
        return loss, grads, peak

    def gap(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    log("  the first batch's gradients under the three remat policies, on "
        "the same parameters (the backward kernel's launches: one a layer "
        "and microbatch; the forward's: one more a layer and microbatch "
        "where the group is recomputed)")
    loss_d, grads_d, peak_d = grads_of("dots")
    peaks, diffs, same = {"dots": peak_d}, {}, {}
    for remat in ("none", "block"):
        loss_o, grads_o, peaks[remat] = grads_of(remat)
        same[remat] = loss_o == loss_d and all(
            torch.equal(a, b) for a, b in zip(grads_o, grads_d))
        diffs[remat] = (abs(loss_o - loss_d), gap(grads_o, grads_d))
        del grads_o
    if all(same.values()):
        log(f"  remat none and block: the loss and all {len(grads_d)} "
            f"gradients equal remat dots' bit for bit")
    else:
        # an op of the step is not deterministic on the card: hold the gaps
        # to the one between two "none" runs
        loss_1, grads_1, _ = grads_of("none")
        loss_2, grads_2, _ = grads_of("none")
        noise = (abs(loss_1 - loss_2), gap(grads_1, grads_2))
        del grads_1, grads_2
        log(f"  not bit for bit: (loss, largest gradient) gaps to dots "
            f"{diffs}; two none runs differ by {noise}")
        for remat, got in diffs.items():
            if got[0] > noise[0] or got[1] > noise[1]:
                raise AssertionError(f"remat {remat}: {got} against two "
                                     f"none runs' {noise}")
    log(f"  peaks above the state (GiB): none {peaks['none']:.3f}, block "
        f"{peaks['block']:.3f}, dots {peaks['dots']:.3f}")
    if not peaks["dots"] < peaks["none"]:
        raise AssertionError(f"remat dots peaks at {peaks['dots']} GiB, "
                             f"not below none's {peaks['none']}")
    grads_first = grads_d
    del grads_d

    step = make_train_step(cfg, tc("dots"))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    ops.reset_launch_counts()
    for i in range(BF16_STEPS):
        before = ops.launch_counts()
        batch = first if i == 0 else {"tokens": stream.next_batch()}
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        now = ops.launch_counts()
        expect_launches(f"bf16 train step {i + 1}", {
            name: now[name] - before[name] for name in now},
            per_step("dots"))
        if not math.isfinite(loss):
            raise AssertionError(f"bf16 train step {i + 1}: loss {loss}")
        log(f"  step {i + 1}: loss {loss:.6f}, grad norm "
            f"{float(metrics['grad_norm']):.6f}, lr "
            f"{float(metrics['lr']):.6g}, {times[-1]:.4f} s")
    counts = ops.launch_counts()
    if loss_d != losses[0]:
        raise AssertionError(f"step 1's loss {losses[0]} is not the dots "
                             f"gradients' {loss_d}")
    if not all(p.dtype == bf16 for p in tree_leaves(params)):
        raise AssertionError("a parameter left bf16")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times[1:]))
    log(f"  {BF16_STEPS} steps: launches "
        f"{ {k: v for k, v in counts.items() if v} } ({per_step('dots')} a "
        f"step); median step (steps 2 to {BF16_STEPS}) {med:.4f} s, "
        f"{tokens / med:.1f} tokens/s; peak device memory {peak:.3f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt,
                                    {"tokens": stream.next_batch()})
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
    busy, n_events, by_name = device_time(torch, prof)
    if not math.isfinite(loss):
        raise AssertionError(f"bf16 traced step: loss {loss}")
    log(f"  a fifth step, traced: loss {loss:.6f}, wall {wall:.4f} s, device "
        f"busy {busy:.4f} s over {n_events} device events, idle share "
        f"{1 - busy / wall:.4f}")
    log_top(by_name, 8)
    del params, opt, metrics, prof, step
    gc.collect()
    torch.cuda.empty_cache()

    # Row 8 at the microbatch's shape (its backward is 16a's
    # olmo-1b-bf16-train shape).
    _, b, sq, h, hk, d, dv, *_ = BWD_SHAPES[-1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf16)
               for shape in ((b, sq, h, d), (b, sq, hk, d), (b, sq, hk, dv)))
    fwd = attention_numbers(torch, q, k, v, causal=True,
                            label="at olmo-1b's bf16 training shape")
    fwd["max_abs_err"] = check_attention(
        torch, ops, ref, q, k, v, True, "at olmo-1b's bf16 training shape",
        ATTN_TOL)
    del q, k, v
    log(f"[{time.perf_counter() - t_start:.1f} s] bf16 training done")
    return counts, fwd, grads_first, med


def distributed_phase(torch, t_start, grads: list) -> dict:
    """16e: a one-rank NCCL group on the card (from a `FileStore` under
    `build/`, no TCP port): `compressed_psum` over 16d's gradients,
    `make_ddp_step` on olmo-1b at full width and `DDP_LAYERS` layers in
    bf16, and `pipeline_apply` on one stage with one full-width block.
    Returns the launch counts of its model calls."""
    import dataclasses
    import shutil
    from pathlib import Path

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, param_specs, transformer
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import tree_map
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.grad_compress import (compressed_psum,
                                                    int8_compress,
                                                    int8_decompress,
                                                    make_ddp_step,
                                                    sync_grads)

    mark("16e")
    dev = torch.device("cuda", 0)
    root = Path(ROOT) / "build" / "chip_smoke_nccl"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"),
                                                         1),
                            rank=0, world_size=1, device_id=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        log(f"[{time.perf_counter() - t_start:.1f} s] a one-rank NCCL group "
            f"(FileStore under build/) in {time.perf_counter() - t0:.2f} s")
        # compressed_psum over the gradient tree of 16d's first batch
        numel = sum(g.numel() for g in grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads:
            value, res = compressed_psum(g)
            q, scale, want_res = int8_compress(g)
            if not torch.equal(value, int8_decompress(q, scale)) or \
                    not torch.equal(res, want_res):
                raise AssertionError(f"compressed_psum of a {tuple(g.shape)}"
                                     " gradient on one rank")
            del value, res, q, scale, want_res
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for g in grads:
            compressed_psum(g)
        end.record()
        end.synchronize()
        wire = numel + 4 * len(grads)
        log(f"  compressed_psum over olmo-1b's {len(grads)} gradient leaves "
            f"({numel} elements): each equal to int8_decompress(q, scale) "
            f"and its residual to int8_compress's, bit for bit; "
            f"{start.elapsed_time(end):.3f} ms for the tree (CUDA events; "
            f"the checks {check_s:.3f} s); the wire: {wire} bytes gathered "
            f"a rank (1 a gradient element, 4 a leaf's scale) against "
            f"{4 * numel} for f32")
        del grads
        gc.collect()
        torch.cuda.empty_cache()

        # make_ddp_step on olmo-1b at full width, 2 layers, bf16
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="bfloat16",
                                  param_dtype="bfloat16",
                                  num_layers=DDP_LAYERS)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params0 = init_params(param_specs(cfg), gen, torch.bfloat16, dev)
        toks = TokenStream(cfg.vocab_size, DDP_SEQ, DDP_BATCH,
                           seed=SEED).next_batch()
        batch = {"tokens": torch.from_numpy(toks).to(dev)}

        def lm_loss(params, b):
            return loss_fn(params, cfg, b, remat="dots")[0]

        ops.reset_launch_counts()
        leaves = tree_leaves(params0)
        for p in leaves:
            p.requires_grad_(True)
        g = torch.autograd.grad(lm_loss(params0, batch), leaves)
        zeros = [torch.zeros(p.shape, device=dev) for p in leaves]
        g_c, _ = sync_grads(g, zeros, None, compress=True)
        g_u, _ = sync_grads(g, zeros, None, compress=False)
        worst = 0.0
        for a, b_, raw in zip(g_c, g_u, g):
            half = float(raw.float().abs().max().clamp(min=1e-12)) / 127 / 2
            gap = float((a - b_.float()).abs().max())
            slack = float(torch.finfo(torch.float32).eps) * float(
                raw.float().abs().max())
            if not gap <= half + slack:
                raise AssertionError(f"compressed sync {gap} against half a "
                                     f"quantisation step {half}")
            worst = max(worst, gap / half)
        log(f"  make_ddp_step's sync on {cfg.name} (full width, {DDP_LAYERS}"
            f" layers, bf16, {DDP_BATCH} x {DDP_SEQ} tokens): the compressed "
            f"gradient within {worst:.4f} of half a quantisation step of the "
            f"uncompressed one")
        del g, g_c, g_u, zeros
        out = {}
        for compress in (True, False):
            params = tree_map(lambda p: p.detach().clone(), params0)
            residuals = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), params)
            step = make_ddp_step(lm_loss, None, lr=DDP_LR, compress=compress)
            losses = []
            t0 = time.perf_counter()
            for _ in range(DDP_STEPS):
                params, residuals, loss = step(params, residuals, batch)
                losses.append(float(loss))
            wall = time.perf_counter() - t0
            if not np.isfinite(losses).all():
                raise AssertionError(f"ddp compress={compress}: {losses}")
            if any(p.dtype != torch.bfloat16 for p in tree_leaves(params)):
                raise AssertionError("a ddp parameter left bf16")
            out[compress] = losses
            log(f"  make_ddp_step compress={compress}: {DDP_STEPS} SGD steps "
                f"(lr {DDP_LR}) in {wall:.3f} s, losses "
                f"{[round(x, 6) for x in losses]}")
            del params, residuals, step
        if out[True][0] != out[False][0]:
            raise AssertionError("the two ddp runs' first losses differ")

        # pipeline_apply on one stage: one full-width block
        block = tree_map(lambda p: p[:1].detach(),
                         params0["groups"]["pos00"])
        bt, moe = cfg.block_type(0), False
        pos = torch.arange(PIPE_SEQ, device=dev)[None, :]

        def stage(p, x):
            return transformer.block_forward(p, x, cfg, bt, moe,
                                             positions=pos)[0]

        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        xs = torch.randn((PIPE_MICRO, PIPE_BATCH, PIPE_SEQ, cfg.d_model),
                         generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            got = pipeline_apply(stage, block, xs, None)
            one = tree_map(lambda p: p[0], block)
            want = torch.stack([stage(one, xs[i])
                                for i in range(PIPE_MICRO)])
        if not torch.equal(got, want):
            raise AssertionError("pipeline_apply on one stage: "
                                 f"{float((got - want).abs().max())}")
        log(f"  pipeline_apply on one stage ({PIPE_MICRO} microbatches of "
            f"{PIPE_BATCH} x {PIPE_SEQ}, one full-width block): equal to the "
            f"direct calls bit for bit")
        counts = ops.launch_counts()
        calls = 1 + 2 * DDP_STEPS
        # each loss and gradient under "dots": two forward launches and one
        # backward launch a layer; the pipeline's and the direct calls'
        # block: one forward launch a microbatch each
        expect_launches("16e", counts, {
            "flash_attention": 2 * calls * DDP_LAYERS + 2 * PIPE_MICRO,
            "flash_attention_bwd": calls * DDP_LAYERS})
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[{time.perf_counter() - t_start:.1f} s] distributed done")
    return counts



def example(name: str):
    """The port's copy of an example, `examples_torch/<name>.py`, loaded by
    path."""
    import importlib.util

    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, t_start, card: str, bf16_step_s: float) -> dict:
    """17: the four examples' copies on the card, each gated, then the dry
    run's count of 16d's step.  Returns the four copies' launch counts."""
    import dataclasses
    import shutil

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import count_operations

    mark("17")
    log(f"[{time.perf_counter() - t_start:.1f} s] the examples' copies on "
        "the card")
    total: collections.Counter = collections.Counter()

    def run(label, name, argv, want):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = example(name).main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        total.update(counts)
        missing = [k for k in want if not counts[k]]
        if missing:
            raise AssertionError(f"{label}: no launch of {missing}: {counts}")
        log(f"  {label}: {time.perf_counter() - t0:.2f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        return out

    def positive(label, costs):
        bad = [c for c in costs if not (math.isfinite(c) and c > 0)]
        if bad:
            raise AssertionError(f"{label}: costs {bad}")

    sweeps = ("tree_sep_update", "tree_sep_update_tiles")
    for backend in ("device", "sharded"):
        label = f"quickstart --smoke --backend {backend}"
        out = run(label, "quickstart", ["--smoke", "--backend", backend],
                  sweeps + ("lsh_bucket_accept", "pairwise_argmin"))
        table = out["seeders"]
        positive(label, [r["cost"] for r in table.values()] +
                 [r["cost"] for r in out["device"].values()] +
                 out["device"]["rejection"]["batch_costs"] +
                 out["engine"]["costs"] + out["engine"]["stacked_costs"] +
                 [out["plan"]["cost"], out["plan"]["refit_cost"]])
        if table["kmeans++"]["ratio"] != 1.0 or \
                out["plan"]["lloyd_iterations"] != 5 or \
                len(out["device"]["rejection"]["batch_costs"]) != 4:
            raise AssertionError(f"{label}: {out}")

    # rejection on the device backend: on the card its dead primary falls
    # straight to k-means|| on the device (the chain's cpu rungs skipped)
    out = run("resilient_serving --smoke", "resilient_serving", ["--smoke"],
              sweeps + ("lsh_bucket_accept", "pairwise_argmin"))
    ledger = out["ledger"]
    if out["quarantine"] != {"quarantined": 1, "submitted": 0} or \
            out["degradation"]["served_by"] != "kmeans||/device" or \
            out["deadlines"]["deadline_expired"] != 1 or \
            out["retries"]["attempts"] != 2 or \
            not out["degradation"]["identical"] or \
            ledger["completed"] + ledger["failed"] + ledger["cancelled"] != \
            ledger["submitted"]:
        raise AssertionError(f"resilient_serving: {out}")

    out = run("serve_cluster_kv --seq 16384 --engine", "serve_cluster_kv",
              ["--seq", "16384", "--engine"], sweeps)
    if out["coverage"] < KV_MIN_COVERAGE or \
            out["median_error"] > KV_MAX_MEDIAN_ERROR:
        raise AssertionError(f"serve_cluster_kv: recall {out['coverage']}, "
                             f"median error {out['median_error']}")
    del out

    workdir = os.path.join(ROOT, "build", "chip_smoke_train_lm")
    shutil.rmtree(workdir, ignore_errors=True)
    before = dict(total)
    first = run(f"train_lm tiny, {TLM_FIRST} steps", "train_lm",
                ["--steps", str(TLM_FIRST), "--workdir", workdir],
                ("flash_attention", "flash_attention_bwd"))
    again = run(f"train_lm tiny, resumed to {TLM_STEPS}", "train_lm",
                ["--steps", str(TLM_STEPS), "--workdir", workdir],
                ("flash_attention", "flash_attention_bwd"))
    shutil.rmtree(workdir, ignore_errors=True)
    losses = first["losses"] + again["losses"]
    if first["ran"] != TLM_FIRST or again["resumed_from"] != TLM_FIRST or \
            again["ran"] != TLM_STEPS - TLM_FIRST or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_lm: {first} then {again}")
    expect_launches("train_lm", {k: total[k] - before.get(k, 0)
                                 for k in total},
                    {"flash_attention": TLM_LAYERS * TLM_STEPS,
                     "flash_attention_bwd": TLM_LAYERS * TLM_STEPS})
    log(f"  train_lm losses {[round(x, 4) for x in losses]}")
    gc.collect()
    torch.cuda.empty_cache()

    # the dry run's count of 16d's step (remat "dots", two microbatches)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="bfloat16",
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    counted = count_operations(
        cfg, ShapeConfig("16d", BF16_SEQ, BF16_BATCH, "train"), BF16_MICRO,
        remat="dots")
    att = counted["attention"]
    launches = {k: att[k]["launches"] for k in att}
    if launches != {"flash_attention": 2 * cfg.num_layers * BF16_MICRO,
                    "flash_attention_bwd": cfg.num_layers * BF16_MICRO}:
        raise AssertionError(f"dry run of 16d's step: launches {launches}")
    rate = counted["total"] / bf16_step_s
    log(f"  dry run of 16d's step on meta in "
        f"{time.perf_counter() - t0:.2f} s: {counted['total']:.6e} "
        f"operations ({counted['aten']:.6e} in the products FlopCounterMode "
        f"counts, {att['flash_attention']['operations']:.6e} and "
        f"{att['flash_attention_bwd']['operations']:.6e} in rows 8 and "
        f"8′), launches {launches}; over 16d's median step of "
        f"{bf16_step_s:.4f} s: {rate:.6e} operations a second, "
        f"{rate / BF16_OPS_PER_S:.4f} of the bf16 peak; card {card}")
    log(f"[{time.perf_counter() - t_start:.1f} s] examples done")
    return dict(total)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    mark("1-2")
    card = smi("name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)} count "
        f"{torch.cuda.device_count()}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({len(report)} sources)")
    for name, info in report.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}.cu: {line.strip()}")

    rows = seeding_paths(torch, t_start)
    # -- 9. free the seeding paths' tensors before the 17.7 GB of weights ---
    mark("9")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t_start:.1f} s] device memory after the "
        f"seeding paths: {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved")
    lm_rows, paths, bf16_step_s = serving_path(torch, t_start)
    rows.extend(lm_rows)
    paths["examples"] = examples_phase(torch, t_start, card, bf16_step_s)
    for r in rows:
        r.setdefault("launches_by_path", {}).update(
            {path: counts.get(r["name"], 0) for path, counts in paths.items()})
    mark("end")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"phase_seconds": {
        **phase_seconds(), "total": round(time.perf_counter() - t_start, 1)}}))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
