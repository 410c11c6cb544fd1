#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (multi_spatialmllm_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phases 10 13 # some phases (1 and 2 always run)

Phases, each printed as it ends; any failure raises (non-zero exit, no
result line):

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles the four kernel sources in ops/csrc with nvcc, in
   parallel (one nvcc per source), and the native library (ingest/native,
   g++: the JSONL emitter and the JPEG codec) beside them (it must
   build), and reads the SASS of the bf16 wgmma
   kernels (cuobjdump; K1, K2 and K3 at hd 32, 64 and 128; K8's general
   kernel for gmm, gmm_t and tgmm at BN 128 and 256 and its few-rows
   kernel at 16, 32 and 64 rows): each must hold wgmma (HGMMA) and TMA
   loads (UTMALDG); ptxas must report no spill for K8's bf16 kernels;
   every instantiation of K7's `paged_decode_split_kernel` must hold its
   bulk copies (UBLKCP) and no spill.
3. flash_fwd (K1) against its plain version, timed beside its bound and
   `scaled_dot_product_attention` at the shapes its paths run (flagship
   prefill S 2048, the ViT shape with its pad segment, the bench MoE
   prefill H16 over KVH8 S 512, a packed S 4096 train row of 16 segments
   and a 96-token pad, unpacked S 4096, S 8192; untimed: phase 22's
   bench LLM B4 H16 over KVH8 S 2048 and ViT of 8 tiles), then at the
   edges of its 128-row tiling (S 1, 127, 129, 200, 1153, segment
   boundaries inside a tile, GQA rep 1, 2 and 4, head dims 32, 64, 128)
   and small float32 cases; prints the entry point's host cost a call.
4. paged_decode (K7) against the plain gather-window version at the
   flagship serve shape (8 slots, H32 over KVH8, hd 128, page 64), a long
   shape (8 slots at 4,096 positions) and a skewed one (one slot at
   4,096, seven at 0), then at the split plan's edges (index at a run's
   edges, in the table's last run, every slot idle at the sink page, rep
   1, 2, 4, 8, hd 32, 64, 128, float32): pools bit-equal after the fused
   write, outputs within the K7 tolerances and, in bf16, per (slot,
   head) row within NORM_RATIO of the plain version's own bf16 error (a
   probe shows that check failing one row 10% off), two calls
   bit-identical, a CUDA-graph replay equal to the eager call. Timed at
   the three shapes: device ms from a graph's replay, the wrapper by CUDA
   events, its host us a call, the plain version, the bytes bound.
5. Model check: the `tiny` config in float32 with seeded weights through
   the PagedBatcher on the CPU (plain versions) and on the card (kernels);
   greedy tokens must be identical, a difference admitted only at a step
   whose CPU top-2 logit margin is below 1e-4 (printed).
6. Serve: the `flagship` config (full width and depth) with seeded random
   bf16 weights answers 16 MultiSPA-shaped requests (1-2 synthetic images
   each) through the port's serve loop; every request must finish and
   both kernels must have launched on that path.
7. flash_bwd_dq (K2) and flash_bwd_dkv (K3), and K1 at their shapes,
   against the plain forward and backward on float32 copies of the same
   values: the flagship train shape, a packed row, the ViT shape, the
   S 8192 streaming shape (which stands for K4-K6), small float32 GQA
   cases and phase 22's bench shapes (the LLM's B4 H16 over KVH8 S2048,
   the ViT's 8 tiles). bf16 results are also held, per 64-row tile, to twice the plain
   version's own bf16 error, and a probe shows that check failing a dq
   and a dv with one tile 10% off; K2 and K3 timed (C entry points, and
   the whole wrapper) at the four bf16 shapes (the unpacked and packed
   S 4096 rows and the ViT shape that training runs, and S 8192) against
   their bounds and the backward of `scaled_dot_product_attention` with
   the same mask (timed only).
8. Tiny training: the `tiny` config in float32, 3 steps of
   `make_train_step` (packed rows, accum 2) on the CPU and on the card
   from the same weights and batches; losses, grad norms, first-step
   gradients and params must agree (tolerances below).
9. Train: the `flagship` widths with the LLM cut to 8 of 32 layers,
   float32 master weights and bf16 compute, 4 steps through `train_steps`
   (what the `train` CLI calls) over a synthetic MultiSPA-shaped mixture
   (packed 4096-token rows, max_tiles 6, batch 2, accum 2); every loss
   finite, all three flash kernels launched, then the loss must fall at
   each update of a fresh optimizer, on the train CLI's default schedule,
   on one repeated batch.
10. gmm, gmm_t and tgmm (K8) against their plain versions on float32
   copies: the preflight shape (NK 16384, D = F = 2048, E 4, uniform and
   skewed groups), the MoE train shape (NK 8192, D 2048, F 8192, and the
   down projection), gmm at the MoE serve shapes (a decode step's 16 rows
   in four groups, one empty, and a 512-row prefill, both projections),
   all forms at M = 1, 64 and 65 (the few-rows gmm kernel takes M <= 64),
   64 groups of which four hold rows, a group inside one 128-row tile, a
   one-row group, and small float32 cases (an empty group, boundaries
   inside a tile, rows past the groups' total). bf16 results are held as
   in phase 7 (tgmm per group and 64-row tile of K); probes show the check
   failing a gmm and a tgmm with one tile 10% off; the split few-rows gmm
   must repeat bit for bit. Every form timed at every train and serve
   shape against its bound (TFLOP/s or GB/s, and the share) and
   `torch._grouped_mm` (timed only, where it exists and computes the same
   function), the general kernel also at BN 128 and 256, gmm at 16 and 64
   rows also on the general kernel, and gmm at 1-64 rows on both kernels
   and at 1-8 K parts (device times from CUDA graphs).
11. paged_decode_int8 (K7 int8) as phase 4 (quantised write, dequantised
   window; pools and scale pools bit-equal) at the bench MoE serve shape
   (H16 over KVH8, page 128) and the long and skewed shapes at page 128;
   timed beside native K7 on the same rows.
12. Tiny MoE: `tiny_moe_config` in float32 with the einsum impl and with
   the ragged impl on K8 (`moe_kernel="pallas"`): phase 8's 3 train steps
   and phase 5's greedy serving with int8 kv pools, CPU vs card.
13. MoE train at full width, nothing cut: `--config bench --moe-experts 4
   --moe-impl ragged --moe-kernel pallas` (through the CLI's config
   rules), as phase 9 (the train CLI's tile defaults, 14 and 6); every
   loss finite, the launches a step equal to MOE_TRAIN_LAUNCHES (K1 in
   the forward alone under the config's `dots_and_flash_saveable`; K8's
   grouped products recomputed), then the repeated-batch check.
14. MoE serve at full width: the same model in bf16 with seeded weights,
   `bench_paged_config(kv_dtype="int8")` (8 slots, page 128, 53 pages,
   prompts up to 512, 128 new tokens), 16 one-image requests through the
   serve loop; every request finishes, flash_fwd, gmm and
   paged_decode_int8 launched.
15. Data engine (no kernel of its own: torch ops on the card, and the
   native JSONL emitter, built with g++ beside the nvcc builds of phase 2;
   on this path the Python emitter is a failure, not a fallback):
   real-scale visibility (bench.py's 296-image, 200,000-point scene) in
   float64 and float32, cold and steady seconds, M tests/s, dispatches,
   peak device memory; the float64 bits of the first 24 images equal to
   the port's CPU run. The bench corpus (40 scenes x 96 images): batched
   f32 visibility (scenes/s), frame relations (pairs/s), camera movement
   for total_distance, displacement_vector, yaw_angle and x_movement at
   200,000 samples each with the production config (samples/s, median of
   3 passes). Then `demo --scenes 2 --images-per-scene 12
   --points-per-scene 4000` (`run_all` with its two TAPVid records) on the
   card and on the CPU, in this process: visibility.npz equal, relation
   overlap equal and distance/yaw/pitch within DIST_ULP/ANGLE_ULP, every
   file under qa/ (the JSONL of every engine, the object-movement `_orig`
   dumps, frames and annotated JPEGs, which the card writes with no cv2)
   and every index pickle byte-equal. Each number printed beside the
   card's name and power limit.
16. ScanNet engines (torch ops on the card, no kernel of their own): on
   the real-scale scene, object visibility's counts (M3) and coverage's
   intervals (M4) card == CPU bit for bit with equal dtypes over every
   image, each device program alone timed by CUDA events with its inputs
   resident beside its bytes bound and its peak device bytes; the
   bench's `object_visibility_realscale`, `coverage_search_realscale`
   (s/scene) and `object_perception` (samples/s) on that scene; then at
   bench.py's configurations `depth_estimation_coor`,
   `depth_comparison_coor` and `correspondence_coor` (50,000, production
   sampler) on the 40-scene corpus, and `depth_estimation_dot`,
   `depth_comparison_dot` and `correspondence_dot_multichoice` on two
   annotated scenes (48 images of 480 x 640, depth 120 x 160) after a
   warm pass: host clock, median of STAGE_PASSES passes, each beside the
   card's name and power limit.
17. TAPVid object movement (M5 as torch ops on the card, no kernel of its
   own; the native JPEG codec on the host): the codec's encodes and
   decodes of the golden grid (ingest/_jpeg_golden.json, made with cv2 by
   scripts/gen_jpeg_golden.py) match every stored digest, and its decode
   and encode MB/s on 512 x 512 frames; M5 on a record made here at the
   real-scale stand-in (512 x 512 frames, T 300, N 1,024) card == CPU bit
   for bit, the device program alone timed by CUDA events with its input
   resident beside its bytes bound and peak device bytes, and the
   rigid-body groups equal; `object_movement_coord` and
   `object_movement_dot` at bench.py's configuration (8 records, T 24,
   N 60, npairs_per_bin 2; dot into a fresh image directory each pass),
   a warm pass then the median of STAGE_PASSES, and the real-scale record
   through both once; then the `tapvid` command over npz files in
   `<data>/adt/`, train and val, with and without `--dot`, on the card
   and on the CPU: every file byte-equal. Each number beside the card's
   name and power limit.
18. Real inputs on the card without cv2 (no kernel of its own but K1, K7
   and tile_frame on the serve path; the native inflate and codec and the
   PNG codec on the host): (a) bench.py's ingest_l1
   configuration (make_synthetic_sens, 300 frames of 480 x 640, seed 5):
   export_posed_images and build_images_info at frame_skip 1, their rates
   under `ingest_sens_export` and `ingest_info_update` (frames/s, median
   of STAGE_PASSES), the written JPEGs, PNGs, pose texts and images_info
   against the JAX package's digests (scripts/gen_ingest_golden.py, made
   with cv2; PNG bytes depend on the zlib, so under another zlib version
   the PNGs' pixels); (b) the real-scale scene (bench.py's 296 images of
   968 x 1296, depth 480 x 640, 202,400 points, 8 objects) written as a
   ScanNet scan (a 1,480-frame .sens, ply, segments, aggregation, meta),
   `ingest-scannet`, `ingest-sens --frame-skip 5` and `pipeline` on the
   card, each timed, the L3 stages by their events too, and the ingested
   pack equal to its source; (c) two small scans (240 x 320, 40 frames,
   4,000 points) through ingest-scannet, ingest-sens, coverage over 2
   shards then --merge, unsharded coverage and pipeline, on the card and
   on the CPU: every pickle, npz, npy, JSONL and JPEG byte-equal, the
   merged coverage equal to the unsharded run, packs, scenes_info and
   merged coverage equal to the JAX digests; (d) 968 x 1296 and 640 x 480
   frames written as JPEG and PNG: tile_image's tiles equal cv2's by
   digest, and `serve` (tiny, float32) on request lines naming those files
   gives the same greedy tokens on the card and the CPU, K1 and K7
   launched, tile_frame once a frame read on the card and no frame tiled on
   the host there, `--device cpu` tiling each frame in numpy. Each number
   beside the card's name and power limit.

19. Eval and the serving options (K1, K7 native and int8 and K8 on the
   eval paths; generation, sampling and the paged options are torch ops,
   as the JAX package runs them outside Pallas): (a) the `tiny` config in
   float32 on a small campaign (eight records over two JPEG frames): the
   `eval` command's --output report equal card vs CPU with --batch-size 1
   and 4, --speculate 3, --mc-logprob and --paged with each of
   --prefix-cache, --prefill-chunk 16, --vision-cache 2, --speculate 3,
   --kv-dtype int8, --logprobs (confidences within EVAL_SCORE_ATOL) and
   --quantize-weights; option scores card vs CPU within EVAL_SCORE_ATOL;
   `serve --sampling` tokens equal card vs CPU for four seeds and
   temperatures, top_p 0.8 in one. (b) the flagship's widths with its LLM
   and ViT cut to EVAL_LAYERS of 32 and EVAL_VIT_LAYERS of 24 layers for
   time (seeded bf16 weights) over the eval data of a port pipeline run on phase
   18's two small scans (their frames exported from the .sens beside the
   engines' annotated images; every record's images must resolve),
   EVAL_LIMIT records a file: `eval --batch-size 4 --mc-logprob`, then
   `--paged --prefix-cache --prefill-chunk 1024 --vision-cache 8` with
   `--speculate 4`, and with `--logprobs` (the two are exclusive), then
   with the weights quantised to int8 (one record a file): records/s,
   time to first token, decode tokens/s, prefix and vision hits,
   speculation's tokens a verify,
   agreement with the batched greedy answers (reported, not gated at
   bf16), peak device memory, weight bytes; every record predicted and
   every logprob finite; a keyed top-p draw's time beside a decode step.
   (c) the bench MoE (`--moe-experts 4 --moe-impl ragged --moe-kernel
   pallas`) with `eval --paged --kv-dtype int8` on one record a file.
   K1 must launch on eval_batched and eval_paged, K7 on eval_paged, K7
   int8 and gmm on moe_eval.

20. Checkpoint import/export and LoRA (K1, K2, K3, K7 native and int8, and
   K8's gmm and gmm_t on these paths; the LoRA merge, the per-row adapter
   deltas and the safetensors reader and writer are torch ops and host
   code): (a) the `tiny` config in float32: a fixture HF checkpoint with
   layer scales through `import-checkpoint` on the card and on the CPU
   (state dicts bit-equal) and `export-checkpoint` (files byte-equal),
   greedy serving of the import card vs CPU, 3 LoRA steps card vs CPU
   within TRAIN_REL, and a mixed-adapter PagedBatcher (base and two
   adapters with non-zero B, native and int8 kv, prefix cache, chunked
   prefill and speculation) card vs CPU; (b) the flagship's widths in
   bf16 with its LLM cut to PHASE20_LAYERS of 32 layers for time (the CLI's
   `flagship` cut alike for (b)-(d)): an HF-layout state drawn on the card
   from a seeded generator, written as SHARD_GB shards (5 and the index)
   through models/safetensors_io.py, `import-checkpoint --config flagship
   --dtype bfloat16` (seconds and GB/s), the import equal to
   `convert_state_dict` on the card bit for bit, `export-checkpoint`, and
   the export re-imported equal to the import (needs PHASE20_DISK of free
   disk under the temporary directory, checked first; the files go as the
   phase goes);
   (c) 16 flagship requests on the imported weights through the serve
   loop in thirds on the base and two rank-16 adapters, beside an
   adapter-free run of the same requests (decode tokens/s of both), base
   rows equal to the adapter-free run's, adapter rows against a batcher on
   merged weights (reported); (d) LoRA rank 16 of that flagship from the
   imported weights (frozen float32 base, the LLM's layers
   rematerialised, packed 4096-token rows, batch 2): `trainable` must be
   LORA_TRAINABLE_PER_LAYER a layer and the loss must fall over 5 steps on
   one repeated batch (peak memory, step seconds, K1/K2/K3 launches a
   step); then the bench MoE (`--moe-experts 4 --moe-impl ragged
   --moe-kernel pallas`) the same way: gmm and gmm_t launch, tgmm never
   (the expert tables are frozen).

21. The data engine's hybrid and pipelined paths (no kernel of their
   own: torch ops on the card, numpy on the host): (a) bench.py's
   real-scale scene: its float64 and its hybrid labels must both equal
   the JAX package's CPU float64 labels by the SHA-256 stored in
   stages/_visibility_golden.json (scripts/gen_visibility_golden.py);
   the float64 call's seconds and device ms, the hybrid call's seconds,
   device ms, flagged share and host fix-up seconds, its peak bytes a
   pair; (b) bench.py's split_projection_val on PROJ_SCENES of its 6
   real-scale scenes (seeds 20-22), the sequential loop against
   `project_scenes_pipelined`: visibility and relations byte-equal,
   s/scene of both and the 312-scene val split in minutes; (c) `run_all`
   (the demo's scenes and TAPVid records) with
   `PipelineConfig(dtype="hybrid")` card vs CPU file for file. The
   rates under bench.py's keys, beside the card's name and power limit.
22. The bench train step, bench.py's model block: `bench_1chip_config`
   (batch 4, S 2048, 2 tiles a row) from `make_example_batch` through
   `make_chained_train_step` (chains of 8, the best of 3) under whole-
   layer remat, `dots_with_no_batch_dims_saveable` and
   `dots_and_flash_saveable`: step ms, tokens/s, MFU (utils/flops.py
   against the card's bf16 peak), peak GiB, K1/K2/K3 launches a step
   and the device's time a step by kind (torch.profiler over one step);
   K1 must launch once an attention call a step under
   `dots_and_flash_saveable` (none in the backward) and twice under the
   others, and the chains' losses must agree within BENCH_LOSS_REL; the
   model block under bench.py's names. K1 and K2/K3 against their plain
   versions on the operands the first step under `dots_and_flash_saveable`
   gave the flash backward (the LLM's and the ViT's), by phase 7's rules
   (a max|err| may also reach twice the plain version's own on the bf16
   values: those limits are for unit-normal operands); the same harness at the tiny f32 config under that policy, CPU vs
   card (losses and first-step gradients within TRAIN_REL, parameter
   changes within BENCH_TINY_UPDATE_REL). Then the bench MoE (ragged, K8)
   for MOE_BENCH_STEPS steps under its policy: launches a step and peak
   GiB.

23. The data axis (torch.distributed; no kernel of its own on the stages,
   K1/K2/K3 and K8 on the train steps): (a) the four scene-parallel
   stages (`compute_visibility_multichip`, `compute_relations_multichip`,
   `object_visibility_multichip`, `coverage_intervals_multichip` through
   `build_object_coverage(mesh=...)`) on the bench corpus (40 scenes of 96
   images) and the real-scale scene, in this process over NCCL at world
   size 1 (the launcher's environment set as `python -m
   torch.distributed.run --nproc-per-node 1` sets it) and in two gloo
   processes sharing the card (`dryrun.run_world`): every scene's results
   byte-equal to the single-device stages' in this phase (per-scene
   SHA-256 of each stage's output), the real-scale labels equal to the
   JAX CPU float64 digest of phase 21; seconds a scene for each world and
   the exchange's seconds. (b) `train --data-parallel 1` in this process
   under that group, at phase 9's configuration (flagship widths, 8 of 32
   LLM layers, packed 4096-token rows, 2 microbatches) for DP_STEPS steps:
   every loss within DP_LOSS_REL of the same command without a group
   (the difference printed), K1/K2/K3 launched; then the bench MoE
   (`--moe-experts 4 --moe-impl ragged --moe-kernel pallas`), whose
   load-balance statistic is all-reduced over the group, the same way:
   DP_STEPS steps within DP_LOSS_REL of the command without a group,
   K1/K2/K3 and gmm/gmm_t/tgmm launched. (c) `scripts/torch_volume_drill.py --scale smoke` on the
   card: killed after 8 units, resumed, no unit run again, and every file
   equal to the CPU campaign's stored digests
   (scripts/_torch_volume_drill_golden.json, made by
   scripts/gen_drill_golden.py; the relation parquets by their columns,
   distance and angles within phase 15's card-vs-CPU ulp limits).

24. The mesh's model, seq and expert axes and FSDP (parallel/sharding.py,
   ops/ring_attention.py; K1-K3 on head-sharded shapes and as ring
   blocks, K7 over kv-head-sharded pools, K8 on FFN-sharded expert
   tables), in ONE world of two gloo processes sharing the card
   (`dryrun.run_world`, computing on CUDA), each part against the same
   work in this process without a group: (a) `train` at phase 9's
   widths and flags, cut to MESH_LAYERS LLM and MESH_VIT_LAYERS ViT
   layers (gloo carries 0.4-1.1 GB/s between the processes), for
   MESH_STEPS steps under `--model-parallel 2`, then under `--fsdp
   --data-parallel 2` (one row a process); (b) the same on unpacked
   4,096-token rows under `--seq-parallel 2` (ring attention); (c) the
   bench MoE (`bench_1chip_moe_config`, 4 experts, MESH_MOE_LAYERS of its
   8 decoder layers) in float32 on MESH_MOE_BATCH under (1 x
   1 x 1 x 2 expert) with the einsum impl and under (1 x 2 model) with
   ragged + K8, each parameter's first gradient within
   MESH_FIRST_GRAD_REL of the run without a group in norm;
   MESH_STEPS steps each, so that the last loss follows an update at a
   nonzero rate (the first update's rate is 0), which the run without a
   group must show; every loss within MESH_LOSS_REL and every step's
   gradient norm within MESH_GNORM_REL of the run without a group;
   launches a step. (d) the flagship's widths in bf16 with
   MESH_SERVE_LAYERS of its 32 LLM layers, served under (1 x 2 model):
   N_MESH_SERVE requests of MESH_NEW_TOKENS new tokens (two a shared image
   and prefix) on the paged batcher with the prefix cache and chunked
   prefill, bf16 and int8 kv; the tokens against the same requests served in this
   process (equal share) and the teacher-forced agreement of the
   sharded run's tokens under this process's model, at least
   MESH_AGREE_MIN of them (bf16 kv; MESH_AGREE_MIN_INT8 int8); decode
   tokens/s.
   Each part's seconds, the peak GiB a process and the gloo transport's
   staged bytes and seconds.

25. The mesh's pipe axis (parallel/pipeline_parallel.py,
   parallel/pipeline_mllm.py; K1-K3 in every stage's forward, recompute
   and backward and the ViT preamble's), as gloo processes sharing the
   card, each part against the same model's `loss_fn` and backward in
   this process without a group: (a) the flagship's widths (float32
   master weights, bf16 compute) with PIPE_LAYERS LLM and PIPE_VIT_LAYERS
   ViT layers, `mllm_pipeline_loss_and_grads` over 2 pipe stages on
   `make_example_batch` at PIPE_BATCH in PIPE_MICRO microbatches, in a
   world of two: the loss within MESH_LOSS_REL and every parameter's
   gradient norm within MESH_GNORM_REL of the run without a group, the
   processes' losses equal; K1/K2/K3 launches, the gloo transport's staged
   bytes and seconds, the peak GiB a process and the call's seconds;
   (b) the `tiny` config in float32 with PIPE_TINY_LAYERS decoder layers
   in a world of four, over pipe 4, (data 2 x pipe 2) and (model 2 x pipe
   2) in turn: the loss within PIPE_LOSS_RTOL and every gradient element
   within PIPE_GRAD_ATOL (the JAX pipeline tests' bounds). The two worlds
   run at once.

26. tile_frame (ops/csrc/tile_frames.cu: INTER_AREA, crops and the
   normalisation of a frame's tiles in one launch; it replaces no TPU
   kernel, the JAX package tiles on the host) at the benchmark cells'
   frame (968 x 1296, 6 tiles and the thumbnail, no fixed resize), on a
   smooth and a noisy frame, and from 480 x 640 with the reference's
   fixed resize to 968 x 1296 (`resize_frame` first): `tile_image`'s tiles
   byte-equal to the numpy path's, one launch a frame; the kernel's device
   ms (CUDA-graph replay, frame resident) beside its bytes bound,
   `tile_image`'s host ms a frame end to end (upload, launch, wait,
   download; median of TILE_CALLS) and the numpy path's ms.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

K1_BF16_ATOL = 2e-2      # bf16 outputs on unit-normal inputs
K1_F32_ATOL = 1e-4
K1_LSE_ATOL = 1e-3       # lse is f32 from f32 scores in both versions
K7_BF16_ATOL = 2e-2
K7_F32_ATOL = 2e-5       # the JAX package's own paged-kernel tolerance
BWD_F32_ATOL = 2e-4      # the JAX package's backward-kernel test's own
BWD_BF16_REL = 2e-2      # bf16: max|err| <= 2e-2 * max|ref|, per tensor
# every bf16 result also: its relative RMS error and its worst relative
# error of a 64-row tile within NORM_RATIO of the plain version's on the
# same bf16 values (which is bf16 rounding alone); a tile's norm is floored
# at TILE_FLOOR of the tensor's RMS tile norm
NORM_RATIO = 2.0
TILE_FLOOR = 1e-2
TRAIN_REL = 1e-4         # phase 8: losses, grad norms, first gradients
MARGIN = 1e-4            # phase 5's near-tie threshold (CPU logits, f32)
N_SERVE = 16
TRAIN_LAYERS = 8         # phase 9: LLM depth cut from 32 (see PERF.md)
# phase 13: the train CLI's --max-tiles and --tiles-per-image defaults
MOE_MAX_TILES, MOE_TILES_PER_IMAGE = 14, 6
# ... and its launches a step, 2 microbatches of 6 ViT and 8 LLM layers:
# under the bench MoE's dots_and_flash_saveable K1 runs in the forward
# alone; K8's grouped products are recomputed (a forward gmm pair and the
# down gmm per layer, twice), their backward is gmm_t and tgmm
MOE_TRAIN_LAUNCHES = {"flash_fwd": 28, "flash_bwd_dq": 28,
                      "flash_bwd_dkv": 28, "gmm": 96, "gmm_t": 48,
                      "tgmm": 48}
N_PHASES = 26
# phase 26: tile_image calls timed (median) at the cells' frame
TILE_CALLS = 20
# phase 20: LoRA rank 16 on the default targets (wq, wk, wv, wo of the
# flagship's 32 layers: (131,072 + 81,920 + 81,920 + 131,072) a layer)
LORA_RANK = 16
# rank 16 on wq/wk/wv/wo of one flagship layer (13,631,488 at 32 layers)
LORA_TRAINABLE_PER_LAYER = 425_984
# its repeated-batch steps: a LoRA learning rate, warmup 1 (the first
# update has lr 0), REPEAT_STEPS steps
LORA_LR, LORA_WARMUP = 2e-4, 1
# (a): the tiny LoRA run's merged weights card vs CPU (tests/test_torch_lora.py
# holds adapters to JAX's at this bound) and how far they must have moved
# from the import (adapters that never updated leave them where they were)
TINY_LORA_ATOL, TINY_LORA_MOVED = 1e-5, 1e-4
# (c): an adapter row's first prefill logits lie within this fraction of
# the base's distance from the merged weights' logits (bf16: the unmerged
# delta is added after the bf16 product, the merged weight rounds W + delta)
LORA_LOGIT_FRAC = 0.25
# phase 20 (b)-(d): the flagship's LLM cut from 32 layers for time (the
# whole depth took 125-203 s of the phase); 1.5 GB shards cut its 5.681
# GB state into 5, as 4 GB shards (export-checkpoint's default) cut the
# whole depth's 16.151 GB
PHASE20_LAYERS = 8
SHARD_GB = 1.5
PHASE20_DISK = 12e9      # peak: the shards and the imported file
# phase 9's steps on one repeated batch run a fresh optimizer on the train
# CLI's default schedule (--lr 1e-5, --warmup 100, --steps 1000)
REPEAT_LR, REPEAT_WARMUP, REPEAT_TOTAL = 1e-5, 100, 1000
REPEAT_STEPS = 5
SEED = 0
# published dense peaks of one H100 SXM (NVIDIA data sheet), for bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_name_and_power_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device milliseconds per call, by CUDA events around `iters`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=20):
    """Mean device milliseconds per call of `fn`, replayed from a CUDA
    graph of `iters` calls (no host work between the launches), by CUDA
    events around a replay; None where `fn` cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except Exception as exc:  # noqa: BLE001 (a yardstick may not capture)
        log(f"    not capturable in a CUDA graph: {type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:120]}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ms_text(t):
    return "none" if t is None else f"{t:.4f} ms"


def bound_ms(flops, n_bytes, peak_flops=PEAK_BF16_FLOPS):
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate; and which one bounds."""
    t_ops, t_bytes = flops / peak_flops * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attended_pairs(torch, b, s, causal, seg):
    """(query, key) pairs one head attends to, summed over the batch: the
    score entries the mask keeps, counted from this run's segment ids."""
    if seg is None:
        return b * (s * (s + 1) // 2 if causal else s * s)
    total = 0
    for row in seg:
        _, lens = torch.unique_consecutive(row, return_counts=True)
        lens = lens.double()
        total += int((lens * (lens + 1) / 2 if causal else lens * lens)
                     .sum().item())
    return total


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def tile_norms(x):
    """Frobenius norms of the 64-row tiles along S of x `[B, H, S, D]`,
    the kernels' tiles (the last one may be short)."""
    import torch.nn.functional as F

    b, h, s, d = x.shape
    return F.pad(x, (0, 0, 0, -s % 64)).reshape(b * h, -1, 64 * d).norm(
        dim=-1)


def normalised_errors(got, ref):
    """`got` against `ref` `[B, H, S, D]`: (relative RMS error, worst
    relative error of a 64-row tile). Unlike max|err| against max|ref|,
    the tile error reads small tiles at their own scale (the late keys of
    a causal row have dv far below the first keys'). A tile's norm is
    floored at TILE_FLOOR of the RMS tile norm."""
    err = got.float() - ref
    e, r = tile_norms(err), tile_norms(ref)
    rms = r.norm() / r.numel() ** 0.5
    worst = (e / (r + TILE_FLOOR * rms)).max()
    return (err.norm() / ref.norm()).item(), worst.item()


def verdict(got, ref, tol, plain=None):
    """(ok, max|err|, text) of `got` against the float32 reference `ref`:
    max|err| <= tol and, for a bf16 result (`plain`: the plain version on
    the same bf16 values), both normalised errors within NORM_RATIO of the
    plain version's."""
    err = (got.float() - ref).abs().max().item()
    ok = err <= tol
    text = f"max|err| {err:.3e} (tol {tol:.3e})"
    if plain is not None:
        g, p = normalised_errors(got, ref), normalised_errors(plain, ref)
        ok = ok and all(a <= NORM_RATIO * b for a, b in zip(g, p))
        text += (f", rms {g[0]:.3e} (plain {p[0]:.3e}), worst tile "
                 f"{g[1]:.3e} (plain {p[1]:.3e})")
    return ok, err, text


def packed_segments(torch, s, n_seg, pad):
    """One packed row `[1, s]` of int32 ids as `packed_segments` training
    makes it: `n_seg` segments of near-equal length (ids 1..n_seg), then a
    `pad`-token tail of id 0."""
    lens = torch.full((n_seg,), (s - pad) // n_seg)
    lens[: (s - pad) - int(lens.sum())] += 1
    ids = torch.repeat_interleave(torch.arange(1, n_seg + 1), lens)
    ids = torch.cat([ids, torch.zeros(pad, dtype=ids.dtype)])
    return ids[None].to("cuda", torch.int32)


def k1_bound(torch, q, k, causal, seg):
    """(GFLOP of this call's attended pairs, (bound ms, bound by)) of K1:
    q, k, v read once, o and the f32 lse written once."""
    b, h, s, d = q.shape
    flops = 4 * h * d * attended_pairs(torch, b, s, causal, seg)
    return flops / 1e9, bound_ms(flops, 2 * nbytes(q, k) + b * h * s * 4)


def phase_k1(torch, A):
    """K1 cases; returns (max abs err over cases, timings by shape)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def case(name, b, h, kvh, s, d, causal, dtype=torch.bfloat16,
             bounds=(), seg=None):
        """`bounds`: positions where the segment id steps up (a boundary
        inside a 128-row tile where one is not a multiple of 128)."""
        atol = K1_BF16_ATOL if dtype == torch.bfloat16 else K1_F32_ATOL
        q = normal(b, h, s, d, dtype=dtype)
        k = normal(b, kvh, s, d, dtype=dtype)
        v = normal(b, kvh, s, d, dtype=dtype)
        if bounds:
            seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
            for x in bounds:
                seg[:, x:] += 1
        o, lse = A.flash_attention_fwd_cuda(q, k, v, causal, seg)
        # the plain version on float32 copies of the same inputs: the exact
        # answer for them; in bf16 the plain version on the bf16 values is
        # the yardstick of bf16 rounding (it rounds its own scores)
        o_ref, lse_ref = A.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal, seg)
        o_pl = None
        if dtype == torch.bfloat16:
            o_pl, _ = A.flash_attention_fwd_plain(q, k, v, causal, seg)
        torch.cuda.synchronize()
        ok, err, text = verdict(o, o_ref, atol, o_pl)
        err_lse = (lse - lse_ref).abs().max().item()
        ok = ok and err_lse <= K1_LSE_ATOL
        log(f"  K1 {name}: o {text}; lse max|err| {err_lse:.3e} (atol "
            f"{K1_LSE_ATOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_fwd disagrees with its plain version on {name}")
        return err, (q, k, v, causal, seg)

    errs, timed = [], {}

    def timed_case(label, *args, **kw):
        e, call = case(*args, **kw)
        errs.append(e)
        timed[label] = call
        return call

    # the shapes each path runs, timed below
    timed_case("prefill", "flagship prefill B1 H32 KVH8 S2048 hd128 causal",
               1, 32, 8, 2048, 128, True)
    timed_case("vit", "ViT 7 tiles H16 S1152 (pad segment from 1025) hd64",
               7, 16, 16, 1152, 64, False, bounds=(1025,))
    timed_case("moe_prefill", "bench MoE prefill B1 H16 KVH8 S512 hd128 "
               "causal", 1, 16, 8, 512, 128, True)
    timed_case("packed", "packed train row S4096, 16 segments + 96 pad "
               "(id 0), B1 H32 KVH8 hd128 causal", 1, 32, 8, 4096, 128,
               True, seg=packed_segments(torch, 4096, 16, 96))
    timed_case("train", "unpacked train B1 H32 KVH8 S4096 hd128 causal",
               1, 32, 8, 4096, 128, True)
    timed_case("xl", "S8192 (K4's streaming role) B1 H8 KVH2 hd128 causal",
               1, 8, 2, 8192, 128, True)
    # the bench train step's (phase 22): the LLM and the ViT of 8 tiles
    errs.append(case("bench train B4 H16 KVH8 S2048 hd128 causal", 4, 16, 8,
                     2048, 128, True)[0])
    errs.append(case("bench ViT 8 tiles H16 S1152 (pad segment from 1025) "
                     "hd64", 8, 16, 16, 1152, 64, False, bounds=(1025,))[0])
    # the edges of the 128-row tiling, GQA rep 1/2/4, every head dim
    for name, args, kw in (
            ("S1 rep4 hd128 causal", (1, 4, 1, 1, 128, True), {}),
            ("S127 rep2 hd64 causal", (1, 4, 2, 127, 64, True), {}),
            ("S129 rep1 hd32 causal", (1, 2, 2, 129, 32, True), {}),
            ("S200 rep2 hd128 causal, segments from 70 and 160",
             (2, 4, 2, 200, 128, True), dict(bounds=(70, 160))),
            ("S1153 rep4 hd64 causal, segment from 600",
             (1, 8, 2, 1153, 64, True), dict(bounds=(600,))),
            ("S1153 rep1 hd32 non-causal, segments from 300 and 1100",
             (2, 2, 2, 1153, 32, False), dict(bounds=(300, 1100))),
            ("S200 rep2 hd64 non-causal", (1, 4, 2, 200, 64, False), {})):
        errs.append(case(f"bf16 {name}", *args, **kw)[0])
    errs.append(case("f32 causal GQA B2 H4 KVH2 S200 hd32", 2, 4, 2, 200, 32,
                     True, torch.float32)[0])
    errs.append(case("f32 non-causal pad segment B2 H2 S150 hd64", 2, 2, 2,
                     150, 64, False, torch.float32, bounds=(130,))[0])

    def c_call(q, k, v, causal, seg):
        """The C entry point on these inputs, the segment ids normalised
        once (the wrapper normalises them at every call)."""
        seg = None if seg is None else A.normalize_segments(seg)
        o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=dev)
        cargs = (A.ptr(q), A.ptr(k), A.ptr(v), A.ptr(seg), A.ptr(o),
                 A.ptr(lse), *q.shape[:2], k.shape[1], *q.shape[2:],
                 int(causal), q.shape[3] ** -0.5, 1)
        # the default argument keeps the tensors behind the pointers alive
        return lambda keep=(seg, o, lse): A.FLASH_FWD(*cargs)

    # the entry point's host cost a call (the prefill runs under a
    # host-bound serve loop): the C call alone, then the whole wrapper
    run_c = c_call(*timed["prefill"])
    host = []
    for fn in (run_c,
               lambda: A.flash_attention_fwd_cuda(*timed["prefill"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    log(f"  K1 host cost a call: {host[0]:.1f} us in the C entry point "
        f"(ctypes included), {host[1]:.1f} us through "
        f"flash_attention_fwd_cuda")

    # kernel: the C entry point; wrapper: flash_attention_fwd_cuda, which
    # also normalises the segment ids (a few small kernels) at each call
    timings = {}
    for label, args in timed.items():
        q, k, v, causal, seg = args
        big = q.shape[2] >= 4096
        run_c = c_call(*args)
        t_k = cuda_ms(torch, run_c)
        t_w = cuda_ms(torch, lambda: A.flash_attention_fwd_cuda(*args))
        t_p = cuda_ms(torch, lambda: A.flash_attention_fwd_plain(*args),
                      iters=3 if big else 20, warmup=1 if big else 3)
        t_lib = sdpa_fwd_ms(torch, q, k, v, causal, seg)
        gflop, bound = k1_bound(torch, q, k, causal, seg)
        log(f"  K1 {label} timing: kernel {t_k:.4f} ms "
            f"({gflop / t_k:.1f} TFLOP/s, {bound[0] / t_k:.1%} of the bound),"
            f" {t_w:.4f} ms through the wrapper, plain {t_p:.4f} ms, sdpa "
            f"{t_lib:.4f} ms ({gflop / t_lib:.1f} TFLOP/s), bound "
            f"{bound[0]:.4f} ms ({bound[1]}; {gflop:.1f} GFLOP)")
        timings[label] = (t_k, t_p, t_lib, bound, t_w)
    return max(errs), timings


def sdpa_mask(torch, s, causal, seg):
    """The boolean mask `scaled_dot_product_attention` needs for segment
    ids (None when `is_causal` alone says it)."""
    if seg is None:
        return None
    mask = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        mask = mask & torch.ones(s, s, dtype=torch.bool,
                                 device=seg.device).tril()
    return mask


def sdpa_fwd_ms(torch, q, k, v, causal, seg):
    """`scaled_dot_product_attention` forward on the same inputs (timed as
    the library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    mask = sdpa_mask(torch, q.shape[2], causal, seg)
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True), iters=10)


def sdpa_bwd_ms(torch, q, k, v, do, causal, seg):
    """Its backward (dq, dk, dv) through `torch.autograd.grad`."""
    import torch.nn.functional as F

    mask = sdpa_mask(torch, q.shape[2], causal, seg)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(
        *leaves, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    return cuda_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), iters=10)


def k7_setup(torch, P, gen, b, h, kvh, ps, pps, hd, n_pages, index, dtype,
             quant, sink=False):
    """Seeded K7 inputs `(q, pools, page_table, index, k_new, v_new)`:
    distinct pool pages per slot (every entry at the sink page 0 with
    `sink`, where all slots then feed the same new row, as idle slots do,
    so that the write is no race), unit-normal q, pools `(k, v)` or, int8,
    `(k, v, k_scale, v_scale)` through the plain quantiser, new rows."""
    dev = torch.device("cuda")

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    pt = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
    if sink:
        pt.zero_()
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    pools = (normal(n_pages, kvh, ps, hd), normal(n_pages, kvh, ps, hd))
    if quant:
        (kp, ks), (vp, vs) = map(P.quantize_kv_rows, pools)
        pools = (kp, vp, ks, vs)
    kn, vn = normal(b, kvh, hd), normal(b, kvh, hd)
    if sink:
        kn, vn = (t[:1].expand_as(t).contiguous() for t in (kn, vn))
    return normal(b, h, 1, hd), pools, pt, idx, kn, vn


def k7_shapes(torch, P, quant):
    """The timed K7 shapes (bf16, 8 slots, KVH 8, hd 128): `serve`, the
    serve path's (flagship native: H32, page 64, 11 table pages; bench MoE
    int8: H16, page 128, 5 pages); `long`, every slot at 4,096 positions
    (native 64 pages of 64, int8 32 of 128); `skewed`, the long table with
    one slot at 4,096 positions and seven at index 0."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + (4 if quant
                                                             else 1))
    if quant:
        h, ps, pps, n_pages = 16, 128, 5, 53
        index = [0, 5, 127, 128, 300, 400, 511, 600]
    else:
        h, ps, pps, n_pages = 32, 64, 11, 105
        # first page, last row of a page, first row of a fresh page, ...
        index = [0, 5, 63, 64, 209, 320, 447, 680]
    wide = 4096 // ps
    return {label: k7_setup(torch, P, gen, 8, h, 8, ps, n, 128, pages, ix,
                            torch.bfloat16, quant)
            for label, n, pages, ix in (
                ("serve", pps, n_pages, index),
                ("long", wide, 8 * wide + 1, [4095] * 8),
                ("skewed", wide, 8 * wide + 1, [4095] + [0] * 7))}


def k7_call(P, args, pools=None):
    """The wrapper on `args`, writing into `pools` (default: args' own)."""
    q, own, pt, idx, kn, vn = args
    kp, vp, *scales = pools or own
    return P.paged_decode_attention_cuda(q, kp, vp, pt, idx, kn, vn,
                                         *scales)


def k7_bound(args):
    """((bound ms, bound by), MB) of K7 on `args`: K and V of the live rows
    (int8: with their f32 scales) read once, the new rows read and written
    once, q read and o written once; 4 flops per (q head, row, dim)."""
    q, pools, _, idx, kn, vn = args
    b, h, _, hd = q.shape
    kvh = pools[0].shape[1]
    rows = int(idx.sum()) + b                    # live rows per kv head
    row_bytes = 2 * kvh * (hd + 4 if len(pools) == 4 else 2 * hd)
    n_bytes = (rows + b) * row_bytes + 2 * nbytes(q) + nbytes(kn, vn)
    return bound_ms(4 * h * rows * hd, n_bytes), n_bytes / 1e6


def k7_times(torch, P, args):
    """K7 on `args`: device ms from a CUDA graph's replay, ms by CUDA
    events around back-to-back wrapper calls (the host's cost included
    where it outruns the device), and the wrapper's host us a call."""
    fn = lambda: k7_call(P, args)  # noqa: E731
    times = {"graph_ms": graph_ms(torch, fn), "wrapper_ms": cuda_ms(torch,
                                                                    fn)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fn()
    times["host_us"] = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    return times


def k7_c_call(torch, P, args, chunk, n_split):
    """The C entry point on `args` under the split plan (`chunk`,
    `n_split`), its workspace sized for it (timing only: the sweep)."""
    q, pools, pt, idx, kn, vn = args
    b, h, _, hd = q.shape
    kvh, ps = pools[0].shape[1:3]
    ws = torch.empty(b * kvh * n_split * P.rep_slots(h // kvh) * (hd + 2),
                     device=q.device)
    out = torch.empty_like(q)
    kern = P.PAGED_DECODE_INT8 if len(pools) == 4 else P.PAGED_DECODE
    cargs = (*map(P.ptr, (q, *pools, pt, idx, kn, vn, out, ws,
                          P._tickets(q.device, b * kvh))),
             b, h, kvh, ps, pt.shape[1], hd, chunk, n_split, hd ** -0.5,
             int(q.dtype == torch.bfloat16))
    # the default argument keeps the tensors behind the pointers alive
    return lambda keep=(ws, out): kern(*cargs)


def k7_case(torch, P, name, args, atol):
    """One K7 case against the plain version: pools (and scale pools)
    after the fused write bit-equal; the output within `atol` of the
    float32 reference and, in bf16, per (slot, head) row within NORM_RATIO
    of the plain version's own bf16 error (`verdict`: a row is one tile);
    two calls bit-identical; a graph-captured call equal to the eager one,
    output and pools. Returns (max|err|, out, ref, plain)."""
    q, pools, pt, idx, kn, vn = args
    got = [t.clone() for t in pools]
    out = k7_call(P, args, got)
    again = k7_call(P, args, got)      # the same row lands again
    want = [t.clone() for t in pools]
    P.write_kv_rows(*want[:2], pt, idx, kn, vn, *want[2:])
    kv_ref = want[:2] if len(want) == 4 else [t.float() for t in want]
    ref = P.window_attention(q.float(), *kv_ref, pt, idx, *want[2:])
    plain = (P.window_attention(q, *want[:2], pt, idx, *want[2:])
             if q.dtype == torch.bfloat16 else None)
    graphed = [t.clone() for t in pools]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = k7_call(P, args, graphed)
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    repeat = torch.equal(out, again)
    replay = torch.equal(out_g, out) and all(
        torch.equal(a, b) for a, b in zip(graphed, got))
    ok, err, text = verdict(out, ref, atol, plain)
    ok = ok and equal and repeat and replay
    log(f"  {name}: pools after the fused write "
        f"{'bit-equal' if equal else 'DIFFER'}; o {text}; repeat "
        f"{'bit-identical' if repeat else 'DIFFERS'}; graph replay "
        f"{'= eager' if replay else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: the kernel disagrees with its plain version")
    return err, out, ref, plain


def phase_k7(torch, P, quant):
    """K7 (native pools, phase 4) or K7 int8 (phase 11) against the plain
    version at the timed shapes and the split plan's edges, then timed.
    Returns (max abs err over cases, timings by shape)."""
    tag = "K7 int8" if quant else "K7"
    shapes = k7_shapes(torch, P, quant)
    errs = []
    for label, args in shapes.items():
        err, out, ref, plain = k7_case(
            torch, P, f"{tag} {label}: bf16 H{args[0].shape[1]} KVH8 hd128 "
            f"ps{args[1][0].shape[2]}, index {args[3].tolist()}", args,
            K7_BF16_ATOL)
        errs.append(err)
        if label == "serve":    # the check must see one row 10% off
            bad = out.clone()
            bad[7, 0] *= 1.1
            ok, _, text = verdict(bad, ref, K7_BF16_ATOL, plain)
            log(f"  fault probe, {tag} serve output with slot 7's head 0 "
                f"10% off: {text}; the check {'passes' if ok else 'fails'}"
                f" it")
            if ok:
                fail(f"the bf16 check passes a {tag} output with one row "
                     f"10% off")
    # the plan's edges at page 16 (16-position chunks): index at a chunk's
    # last, first and second position and in the table's last chunk;
    # every slot idle at the sink; rep 1, 2, 4, 8; hd 32, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for name, b, h, kvh, pps, hd, index, dtype, sink in (
            ("chunk edges, last chunk, rep4 hd128", 4, 8, 2, 8, 128,
             [15, 16, 17, 127], torch.bfloat16, False),
            ("every slot idle, rep2 hd64", 3, 4, 2, 4, 64, [0, 0, 0],
             torch.bfloat16, True),
            ("rep8 hd32", 2, 8, 1, 4, 32, [40, 63], torch.bfloat16, False),
            ("rep1 hd64", 2, 2, 2, 4, 64, [16, 50], torch.bfloat16, False),
            ("f32 rep2 hd64", 3, 4, 2, 4, 64, [37, 32, 3], torch.float32,
             False),
            ("f32 rep8 hd32", 4, 8, 1, 4, 32, [0, 16, 33, 63],
             torch.float32, False)):
        args = k7_setup(torch, P, gen, b, h, kvh, 16, pps, hd, b * pps + 1,
                        index, dtype, quant, sink)
        atol = K7_BF16_ATOL if dtype == torch.bfloat16 else K7_F32_ATOL
        errs.append(k7_case(torch, P, f"{tag} {name}, index {index}", args,
                            atol)[0])

    timings = {}
    for label, args in shapes.items():
        (b_ms, b_by), mb = k7_bound(args)
        t = k7_times(torch, P, args)
        big = label != "serve"
        q, pools, pt, idx, kn, vn = args
        t["plain_ms"] = cuda_ms(
            torch, lambda: P.paged_decode_attention_plain(
                q, *pools[:2], pt, idx, kn, vn, *pools[2:]),
            iters=5 if big else 20, warmup=1 if big else 3)
        t["bound_ms"], t["bound_by"] = b_ms, b_by
        if quant:   # native K7 over the same logical rows, in bf16 pools
            deq = tuple((p.float() * s[..., None]).to(torch.bfloat16)
                        for p, s in zip(pools[:2], pools[2:]))
            t["native_graph_ms"] = k7_times(
                torch, P, (q, deq, pt, idx, kn, vn))["graph_ms"]
        timings[label] = t
        plan = P.split_plan(8, 8, pools[0].shape[2], pt.shape[1], 128,
                            pools[0].element_size(), quant)
        # the plan against other split counts, half and twice the chunk
        # (where it fits; device ms by "chunk x splits")
        ps, itemsize = pools[0].shape[2], pools[0].element_size()
        chunks = [c for c in (plan[0] // 2, plan[0], 2 * plan[0])
                  if ps % c == 0 and c * 128 * itemsize <= P.CHUNK_BYTES]
        t["sweep"] = {f"{c}x{n}": graph_ms(torch, k7_c_call(torch, P, args,
                                                            c, n))
                      for c in chunks
                      for n in sorted({2, 4, plan[1], 8, 16, 32})}
        log(f"  {tag} {label} timing (chunk, splits: {plan}): "
            f"device {ms_text(t['graph_ms'])} by graph replay "
            f"({b_ms / t['graph_ms']:.1%} of the bound), "
            f"{t['wrapper_ms']:.4f} ms through the wrapper, host "
            f"{t['host_us']:.1f} us a call, plain {t['plain_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {mb:.2f} MB)"
            + (f"; native K7 on the same rows {t['native_graph_ms']:.4f} ms"
               " by graph replay" if quant else "")
            + "; device ms by chunk x splits: " + ", ".join(
                f"{per}: {ms:.4f}" for per, ms in t["sweep"].items()))
    return max(errs), timings


def probe_bulk_fault(name, got, ref, tol, plain):
    """The bf16 check must see a fault in the bulk of the tiles: a copy of
    the kernel's result with one 64-row tile of the last quarter (head 0)
    10% off must fail it. Prints whether max|err| alone would see it."""
    bad = got.clone()
    s = bad.shape[2]
    bad[:, 0, 3 * s // 4:3 * s // 4 + 64] *= 1.1
    ok, err, text = verdict(bad, ref, tol, plain)
    log(f"  fault probe, {name} with one 64-row tile of the last quarter "
        f"10% off: {text}; max|err| alone "
        f"{'passes' if err <= tol else 'fails'} it, the whole check "
        f"{'passes' if ok else 'fails'} it")
    if ok:
        fail(f"the bf16 check passes a {name} with one tile 10% off")


def hold_flash(torch, A, name, q, k, v, do, causal, seg=None, probe=False,
               v_scale=1.0, plain_floor=False):
    """K1, then K2/K3 on its (o, lse), against the plain versions on
    float32 copies of the same operands; a bf16 result is also judged by
    the per-64-row-tile rule against the plain version on the bf16 values
    (`verdict`). K1_BF16_ATOL is for unit-normal v: o's tolerance is it
    times `v_scale` (o mixes v's rows). The max|err| limits are for
    unit-normal operands; with `plain_floor` (a train step's own
    operands) a bf16 result's max|err| may also reach NORM_RATIO times
    the plain version's own on the bf16 values. Returns (max abs errors
    by tensor, the operands with K1's o and lse)."""
    dtype = q.dtype
    o, lse = A.flash_attention_fwd_cuda(q, k, v, causal, seg)
    got = (o,) + A.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                            seg)
    # the reference: the plain forward and backward on float32 copies,
    # so that no side uses K1's o and lse
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o_ref, lse_ref = A.flash_attention_fwd_plain(qf, kf, vf, causal, seg)
    want = (o_ref,) + A.flash_attention_bwd_plain(
        qf, kf, vf, o_ref, lse_ref, dof, causal, seg)
    plain = (None,) * 4
    if dtype == torch.bfloat16:   # the plain version on the bf16 values
        o_pl, lse_pl = A.flash_attention_fwd_plain(q, k, v, causal, seg)
        plain = (o_pl,) + A.flash_attention_bwd_plain(
            q, k, v, o_pl, lse_pl, do, causal, seg)
    torch.cuda.synchronize()
    err_lse = (lse - lse_ref).abs().max().item()
    ok = err_lse <= K1_LSE_ATOL
    errs = {}
    parts = [f"lse max|err| {err_lse:.3e} (atol {K1_LSE_ATOL:g})"]
    for n, g, w, p in zip(("o", "dq", "dk", "dv"), got, want, plain):
        if dtype == torch.float32:
            tol = K1_F32_ATOL if n == "o" else BWD_F32_ATOL
        else:
            tol = K1_BF16_ATOL * v_scale if n == "o" else \
                BWD_BF16_REL * w.abs().max().item()
        floor = ""
        if plain_floor and p is not None:
            p_err = (p.float() - w).abs().max().item()
            tol = max(tol, NORM_RATIO * p_err)
            floor = f" (plain max|err| {p_err:.3e})"
        ok_n, errs[n], text = verdict(g, w, tol, p)
        ok = ok and ok_n
        parts.append(f"{n} {text}{floor}")
    log(f"  {name}: " + "; ".join(parts) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"flash attention disagrees with its plain version on "
             f"{name}")
    for i, n in ((1, "dq"), (3, "dv")) if probe else ():
        probe_bulk_fault(n, got[i], want[i],
                         BWD_BF16_REL * want[i].abs().max().item(),
                         plain[i])
    return errs, (q, k, v, o, lse, do, causal, seg)


def phase_bwd(torch, A):
    """K2/K3 (and K1 at their shapes; at S 8192 they stand for K4-K6)
    against the plain versions; returns (max abs err of dq, of dk/dv, of
    K1's o, timings)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def normal(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def case(name, b, h, kvh, s, d, causal, dtype, seg=None, probe=False):
        q, do = (normal(b, h, s, d, dtype=dtype) for _ in range(2))
        k, v = (normal(b, kvh, s, d, dtype=dtype) for _ in range(2))
        return hold_flash(torch, A, name, q, k, v, do, causal, seg, probe)

    vit_seg = torch.zeros(6, 1152, dtype=torch.int32, device=dev)
    vit_seg[:, 1025:] = 1
    bf = torch.bfloat16
    results = [
        case("K2/K3 flagship train B1 H32 KVH8 S4096 hd128 causal bf16",
             1, 32, 8, 4096, 128, True, bf, probe=True),
        case("K2/K3 packed S4096 16 segments + pad 96 (id 0) causal bf16",
             1, 32, 8, 4096, 128, True, bf,
             packed_segments(torch, 4096, 16, 96)),
        case("K2/K3 ViT 6 tiles H16 S1152 (pad from 1025) hd64 bf16",
             6, 16, 16, 1152, 64, False, bf, vit_seg),
        case("K1/K2/K3 at S 8192 (K4-K6) B1 H8 KVH2 hd128 causal bf16",
             1, 8, 2, 8192, 128, True, bf),
        case("K2/K3 f32 GQA B2 H4 KVH2 S200 hd32 causal", 2, 4, 2, 200, 32,
             True, torch.float32),
        case("K2/K3 f32 GQA B1 H4 KVH1 S192 hd64 non-causal packed", 1, 4,
             1, 192, 64, False, torch.float32,
             torch.tensor([[1] * 100 + [2] * 60 + [0] * 32], device=dev,
                          dtype=torch.int32)),
        # the bench train step's (phase 22): the LLM, the ViT of 8 tiles
        case("K2/K3 bench train B4 H16 KVH8 S2048 hd128 causal bf16",
             4, 16, 8, 2048, 128, True, bf, probe=True),
        case("K2/K3 bench ViT 8 tiles H16 S1152 (pad from 1025) hd64 bf16",
             8, 16, 16, 1152, 64, False, bf,
             vit_seg[:1].expand(8, -1).contiguous()),
    ]
    err_dq = max(r[0]["dq"] for r in results)
    err_dkv = max(max(r[0]["dk"], r[0]["dv"]) for r in results)
    err_fwd = max(r[0]["o"] for r in results)

    # kernel: the C entry points on pre-normalised segment ids; wrapper:
    # flash_attention_bwd_cuda, which also forms delta (two f32 copies of o
    # and dO) and normalises the segment ids at each call
    timings = {}
    for label, (_, args) in (("train", results[0]), ("packed", results[1]),
                             ("vit", results[2]), ("xl", results[3])):
        q, k, v, o, lse, do, causal, seg = args
        nseg = None if seg is None else A.normalize_segments(seg)
        delta = A._delta(o, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
                 int(causal), q.shape[3] ** -0.5, 1)

        def run_dq():
            A.FLASH_BWD_DQ(A.ptr(q), A.ptr(k), A.ptr(v), A.ptr(do),
                           A.ptr(lse), A.ptr(delta), A.ptr(nseg), A.ptr(dq),
                           *shape)

        def run_dkv():
            A.FLASH_BWD_DKV(A.ptr(q), A.ptr(k), A.ptr(v), A.ptr(do),
                            A.ptr(lse), A.ptr(delta), A.ptr(nseg),
                            A.ptr(dk), A.ptr(dv), *shape)

        t_dq, t_dkv = cuda_ms(torch, run_dq), cuda_ms(torch, run_dkv)
        t_wrap = cuda_ms(torch, lambda: A.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal, seg))
        t_fwd = cuda_ms(torch, lambda: A.flash_attention_fwd_cuda(
            q, k, v, causal, seg))
        t_plain = cuda_ms(torch, lambda: A.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal, seg), iters=3, warmup=1)
        t_plain_fwd = cuda_ms(torch, lambda: A.flash_attention_fwd_plain(
            q, k, v, causal, seg), iters=3, warmup=1)
        t_lib_bwd = sdpa_bwd_ms(torch, q, k, v, do, causal, seg)
        t_lib_fwd = sdpa_fwd_ms(torch, q, k, v, causal, seg)
        prod = 2 * q.shape[1] * q.shape[3] * attended_pairs(
            torch, q.shape[0], q.shape[2], causal, seg)  # one S x S x hd product
        rows = q.numel() // q.shape[3] * 4    # an f32 [B, H, S] vector
        io = nbytes(q, k, v, do) + 2 * rows
        b_dq = bound_ms(3 * prod, io + nbytes(dq))
        b_dkv = bound_ms(4 * prod, io + nbytes(dk, dv))
        b_fwd = bound_ms(2 * prod, nbytes(q, k, v, o) + rows)

        def rate(n_prod, t_ms, bound):
            return (f"{n_prod * prod / t_ms / 1e9:.1f} TFLOP/s, "
                    f"{bound[0] / t_ms:.1%} of its bound {bound[0]:.4f} "
                    f"({bound[1]})")

        log(f"  {label} timing ({tuple(q.shape)}, kv {tuple(k.shape)}): "
            f"dq kernel {t_dq:.4f} ms ({rate(3, t_dq, b_dq)}), dk/dv "
            f"kernel {t_dkv:.4f} ms ({rate(4, t_dkv, b_dkv)}), together "
            f"{t_dq + t_dkv:.4f} ms, {t_wrap:.4f} ms through the wrapper; "
            f"plain backward {t_plain:.4f} ms, sdpa backward "
            f"{t_lib_bwd:.4f} ms; forward kernel {t_fwd:.4f} ms (bound "
            f"{b_fwd[0]:.4f}), plain {t_plain_fwd:.4f} ms, sdpa "
            f"{t_lib_fwd:.4f} ms; card {card_name_and_power_limit()}")
        timings[label] = dict(dq=(t_dq, b_dq), dkv=(t_dkv, b_dkv),
                              fwd=(t_fwd, b_fwd), plain=t_plain,
                              plain_fwd=t_plain_fwd, lib_bwd=t_lib_bwd,
                              lib_fwd=t_lib_fwd, wrapper=t_wrap)
    return err_dq, err_dkv, err_fwd, timings


def tiny_train_batches(cfg, n, seed):
    """n packed numpy batches of the tiny config: 4 rows of 128 tokens,
    two conversations a row (one tile each) and a trailing pad."""
    import numpy as np

    from multi_spatialmllm_tpu_torch.models.data import (
        DataConfig,
        pack_samples,
    )

    rng = np.random.default_rng(seed)
    data_cfg = DataConfig(max_seq_len=128, max_tiles=2)
    batches = []
    for _ in range(n):
        enc = []
        for _ in range(8):
            length = int(rng.integers(40, 62))
            ids = rng.integers(10, cfg.llm.vocab_size,
                               size=length).astype(np.int32)
            ids[0] = 1
            ids[1:1 + cfg.tokens_per_tile] = cfg.img_context_id
            labels = ids.copy()
            labels[:1 + cfg.tokens_per_tile] = -100
            tiles = rng.standard_normal(
                (1, cfg.vit.image_size, cfg.vit.image_size, 3)
            ).astype(np.float32)
            enc.append((ids, labels, tiles))
        rows = list(pack_samples(enc, data_cfg, 0))[:4]
        batches.append({k: np.stack([r[k] for r in rows]) for k in rows[0]})
    return batches


def phase_tiny_train(torch, M, T, cli, cfg=None, label="tiny"):
    """3 tiny f32 steps on the CPU (plain versions) and on the card (`cfg`:
    the tiny config by default)."""
    cfg = cfg or M.with_dtype(M.tiny_config(), "float32")
    tcfg = T.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    batches = tiny_train_batches(cfg, 3, SEED + 7)
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
        if name == "cpu":
            M.init_random_weights(model, SEED)
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        opt = T.AdamW(list(model.named_parameters()), tcfg)
        step = T.make_train_step(model, opt, accum_steps=2)
        first_mu = []

        def keep_first_moments(n, opt=opt, first_mu=first_mu):
            if n == 1:   # lr 0 at count 0: mu = (1 - b1) * clipped grads
                first_mu.extend(m.detach().cpu().clone() for m in opt.mu)

        _, history = cli.train_steps(step, iter(batches), 3, dev,
                                     log=lambda *a, **k: None,
                                     after_step=keep_first_moments)
        runs[name] = (history, first_mu,
                      {k: v.detach().cpu() for k, v in
                       model.state_dict().items()})
    (h_c, mu_c, p_c), (h_g, mu_g, p_g) = runs["cpu"], runs["card"]
    worst = {}
    for key in ("loss", "grad_norm"):
        worst[key] = max(abs(a[key] - b[key]) / abs(a[key])
                         for a, b in zip(h_c, h_g))
    worst["first gradients"] = max(
        ((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
        for a, b in zip(mu_c, mu_g))
    lr_sum = sum(T.learning_rate(tcfg, i) for i in range(3))
    worst_param = max((p_c[k] - p_g[k]).abs().max().item() for k in p_c)
    log(f"  {label} train, 3 steps, accum 2, packed: losses CPU "
        f"{[round(h['loss'], 6) for h in h_c]} card "
        f"{[round(h['loss'], 6) for h in h_g]}")
    log(f"  worst relative difference: loss {worst['loss']:.3e}, grad norm "
        f"{worst['grad_norm']:.3e}, first-step gradients "
        f"{worst['first gradients']:.3e} (tol {TRAIN_REL:g}); params "
        f"max|diff| {worst_param:.3e} (tol: lr summed over the steps, "
        f"{lr_sum:.3e})")
    if max(worst.values()) > TRAIN_REL or worst_param > lr_sum:
        fail(f"{label} f32 training differs between the CPU and the card")


def serve_lines_for(cfg, n, K, max_images=2):
    """n JSONL request lines (1 to `max_images` images each) and their
    image tiles."""
    reqs = K.make_serve_requests(cfg, n, seed=SEED + 5)
    tiles = {f"frame{i}.jpg": t for i, (_, t) in enumerate(reqs)}
    questions = (
        "How did the camera move between these two frames?",
        "What is the distance between the chair and the table in meters?",
        "Which point in the second image corresponds to the marked point?",
        "Estimate the depth of the highlighted object.")
    lines = []
    for i in range(n):
        images = [f"frame{i}.jpg"] if i % 2 == 0 or max_images == 1 else \
            [f"frame{i}.jpg", f"frame{(i + 1) % n}.jpg"]
        text = "".join("<image>\n" for _ in images) + questions[i % 4]
        lines.append(json.dumps({"id": f"req{i}", "text": text,
                                 "image": images}))
    return lines, tiles


def top2_margin(torch, model, ids, tiles, generated, step):
    seq = list(map(int, ids)) + list(map(int, generated[:step]))
    with torch.no_grad():
        logits = model(torch.tensor([seq]), torch.from_numpy(tiles)[None])
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_tiny(torch, M, K, cfg=None, label="tiny", kv_dtype="native",
               state=None, adapters=None, lora_cfg=None, options=None):
    """Greedy tokens of a tiny config in f32 (`cfg`, the tiny config by
    default; seeded weights, or `state`): CPU (plain) vs card. With
    `adapters` ({name: adapter dict} and their `lora_cfg`) the requests
    go in thirds to the base and two adapters, and a near tie is judged on
    the request's merged weights; `options` are more PagedConfig fields."""
    cfg = cfg or M.with_dtype(M.tiny_config(), "float32")
    cpu_model = M.MultiFrameMLLM(cfg)
    if state is None:
        M.init_random_weights(cpu_model, SEED)
    else:
        cpu_model.load_state_dict(state)
    cpu_model.eval()
    gpu_model = M.MultiFrameMLLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.eval()
    pcfg = dict(slots=3, page_size=16, num_pages=64, max_prompt_len=256,
                max_new_tokens=12, chunk=4, length_bucket=64,
                kv_dtype=kv_dtype, **(options or {}))
    requests = K.make_serve_requests(cfg, 6, seed=SEED + 5)
    names = [None] * len(requests)
    teachers = {None: cpu_model}
    lora = {}
    if adapters:
        from multi_spatialmllm_tpu_torch.parallel import lora as L

        names = [(None, *adapters)[i % 3] for i in range(len(requests))]
        requests = [r + ((n,) if n else ()) for r, n in zip(requests, names)]
        for n, ad in adapters.items():
            teachers[n] = M.MultiFrameMLLM(cfg)
            teachers[n].load_state_dict(L.merge_lora(
                cpu_model.state_dict(), ad, lora_cfg))
        lora = dict(adapters=adapters, lora_config=lora_cfg)
    want = K.PagedBatcher(cpu_model, K.PagedConfig(**pcfg),
                          **lora).generate_all(requests)
    if adapters:
        lora["adapters"] = {n: {w: {p: t.cuda() for p, t in ad.items()}
                                for w, ad in a.items()}
                            for n, a in adapters.items()}
    got = K.PagedBatcher(gpu_model, K.PagedConfig(**pcfg),
                         **lora).generate_all(requests)
    n_same = 0
    for i, ((ids, tiles, *_), g, w) in enumerate(zip(requests, got, want)):
        g, w = g.tolist(), w.tolist()
        if g == w:
            n_same += 1
            continue
        k = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        if k == min(len(g), len(w)):
            fail(f"{label} request {i}: token streams differ in length only")
        margin = top2_margin(torch, teachers[names[i]], ids, tiles, w, k)
        log(f"  {label} request {i}: first difference at step {k} "
            f"(card {g[k]}, CPU {w[k]}), CPU top-2 margin {margin:.3e}")
        if margin >= MARGIN:
            fail(f"{label} request {i} differs at step {k} with margin "
                 f"{margin:.3e} >= {MARGIN:g}")
    log(f"  {label} f32, {kv_dtype} kv{', ' + str(options) if options else ''}"
        f": {n_same}/{len(requests)} requests token-identical (card vs CPU), "
        f"tokens {sum(len(w) for w in want)}")


def serve_tokenizer():
    """The builtin tokenizer, decoding ids past its 783-token vocabulary
    to nothing: random weights sample the whole 92,544-row head."""
    from multi_spatialmllm_tpu_torch.models.tokenizer import SpatialTokenizer

    class ServeTokenizer(SpatialTokenizer):
        def decode(self, ids):
            return super().decode([i for i in ids
                                   if 0 <= int(i) < self.vocab_size])

    return ServeTokenizer()


def phase_serve(torch, M, K, cli, tok, kernels, cfg=None, pcfg=None,
                max_images=2, label="flagship"):
    """16 requests through the serve loop at full width (`cfg`, the
    flagship config by default) with seeded bf16 weights; each of
    `kernels` must launch on that path. Returns its launches."""
    cfg = cfg or M.flagship_config()
    pcfg = pcfg or K.PagedConfig(slots=8, page_size=64, num_pages=256,
                                 max_prompt_len=2048, max_new_tokens=32)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = M.MultiFrameMLLM(cfg, device=dev)
    M.init_random_weights(model, SEED)
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {label}: {n_params / 1e9:.3f} B params on the card, built in "
        f"{time.perf_counter() - t0:.1f} s; {pcfg}")
    batcher = K.PagedBatcher(model, pcfg, pad_id=tok.pad_id,
                             eos_id=tok.eos_id)
    lines, tiles = serve_lines_for(cfg, N_SERVE, K, max_images)
    to_request = cli.make_request_builder(cfg, tok, batcher, tiles.get)
    events = []

    def emit(obj):
        events.append((time.perf_counter(), obj))

    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    t_start = time.perf_counter()
    cli.serve_lines(batcher, lines, to_request, tok, emit, stream=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k.name: k.launches for k in kernels}

    errors = [o for _, o in events if "error" in o]
    if errors:
        fail(f"serve answered with errors: {errors[:3]}")
    first_at, tokens, done = {}, {}, set()
    for t, o in events:
        first_at.setdefault(o["id"], t - t_start)
        tokens.setdefault(o["id"], []).extend(o["delta_ids"])
        if o["done"]:
            done.add(o["id"])
    if len(done) != N_SERVE:
        fail(f"{len(done)}/{N_SERVE} requests finished")
    for rid, toks in tokens.items():
        if len(toks) > pcfg.max_new_tokens or any(
                not 0 <= t < cfg.llm.vocab_size for t in toks):
            fail(f"{rid}: bad token stream {toks[:8]}...")
    if min(launches.values()) <= 0:
        fail(f"a kernel never launched on the serve path: {launches}")
    st = batcher.stats
    ttft = sorted(first_at.values())
    n_tok = sum(len(t) for t in tokens.values())
    log(f"  serve: {N_SERVE}/{N_SERVE} requests finished, {n_tok} tokens "
        f"in {wall:.3f} s ({n_tok / wall:.1f} tokens/s end to end)")
    log(f"  time to first token: mean {sum(ttft) / len(ttft):.3f} s, "
        f"median {ttft[len(ttft) // 2]:.3f} s, max {ttft[-1]:.3f} s "
        f"(all {N_SERVE} requests arrive at t=0)")
    log(f"  decode: {st['decode_tokens']} tokens in {st['decode_dispatches']}"
        f" dispatches, {st['decode_seconds']:.3f} s -> "
        f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s; "
        f"prefill {st['prefill_full']} requests in "
        f"{st['prefill_seconds']:.3f} s")
    log(f"  torch.cuda.max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"  launches on the serve path: {launches}")

    # output check on one request: finite logits of the expected shape,
    # and how often a full causal forward over prompt + answer picks the
    # served tokens (reported: bf16 near ties may flip)
    req = to_request(json.loads(lines[0]))
    ids, req_tiles = req[0], req[1]
    served = tokens["req0"]
    seq = torch.tensor([list(map(int, ids)) + served], device=dev)
    with torch.no_grad():
        logits = model(seq, torch.from_numpy(req_tiles)[None].to(dev))
    if logits.shape != (1, seq.shape[1], cfg.llm.vocab_size):
        fail(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        fail(f"non-finite logits at the {label} width")
    pred = logits[0, len(ids) - 1:-1].argmax(-1).tolist()
    agree = sum(int(a == b) for a, b in zip(pred, served))
    log(f"  req0: teacher-forced argmax agrees with {agree}/{len(served)} "
        f"served tokens (bf16)")
    del batcher, model
    return launches


def write_mixture(root, tok, n_records, seed):
    """A two-dataset mixture shaped like MultiSPA's under `root`: a meta
    JSON and JSONL records of 1-2 `<image>` frames with questions and
    answers drawn from the template banks the tokenizer was built from."""
    import numpy as np

    from multi_spatialmllm_tpu_torch.models._vocab_templates import (
        TEMPLATE_CORPUS,
    )

    rng = np.random.default_rng(seed)
    texts = [t.replace("<image>", "").strip() for t in TEMPLATE_CORPUS]
    meta = {}
    for d, (name, repeat) in enumerate((("multispa", 1.0),
                                        ("general", 0.5))):
        with open(os.path.join(root, f"{name}.jsonl"), "w") as f:
            for i in range(n_records):
                n_img = 1 + int(rng.integers(0, 2))
                head = "".join(f"Image-{j + 1}: <image>\n"
                               for j in range(n_img))
                q, a = (texts[int(rng.integers(0, len(texts)))]
                        for _ in range(2))
                f.write(json.dumps({
                    "id": f"{name}-{i}",
                    "image": [f"frame_{d}_{i}_{j}.jpg" for j in range(n_img)],
                    "conversations": [
                        {"from": "human", "value": head + q},
                        {"from": "gpt", "value": a}]}) + "\n")
        meta[name] = {"root": "frames", "annotation": f"{name}.jsonl",
                      "repeat_time": repeat, "length": n_records}
    path = os.path.join(root, "mix.json")
    with open(path, "w") as f:
        json.dump(meta, f)
    return path


def synthetic_frame(path):
    """A seeded 448x448 RGB uint8 frame for an image path (no decode)."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(os.path.basename(path).encode()))
    return rng.integers(0, 256, (448, 448, 3), dtype=np.uint8)


def phase_train(torch, M, T, cli, tok, kernels, dev="cuda", base=None,
                layers=TRAIN_LAYERS, max_tiles=6, tiles_per_image=6):
    """Training at full width (`base`, by default the flagship config, its
    LLM cut to `layers` layers unless None) through `train_steps` on
    `dev`; each of `kernels` must launch. Returns (launches on the train
    path, the summary, peak GiB)."""
    import dataclasses
    import gc
    import itertools
    import tempfile

    from multi_spatialmllm_tpu_torch.models.data import DataConfig
    from multi_spatialmllm_tpu_torch.models.mixture import (
        load_meta,
        mixture_batches,
    )
    from multi_spatialmllm_tpu_torch.models.preprocess import (
        PreprocessConfig,
    )

    base = base or M.flagship_config()
    cfg = base if layers is None else dataclasses.replace(
        base, llm=dataclasses.replace(base.llm, num_layers=layers))
    dev = torch.device(dev)
    t0 = time.perf_counter()
    model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
    M.init_random_weights(model, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = T.AdamW(list(model.named_parameters()), T.TrainConfig(
        learning_rate=1e-5, warmup_steps=2, total_steps=4))
    step = T.make_train_step(model, opt, accum_steps=2)
    torch.cuda.synchronize()
    log(f"  model: ViT {cfg.vit.hidden_size} x {cfg.vit.num_layers}, LLM "
        f"{cfg.llm.hidden_size} x {cfg.llm.num_layers} of "
        f"{base.llm.num_layers} layers, {cfg.llm.moe_experts} experts "
        f"({cfg.llm.moe_impl}, {cfg.llm.moe_kernel}), "
        f"{n_params / 1e9:.3f} B float32 params (bf16 compute), with "
        f"AdamW moments: {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"built in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as root:
        meta = write_mixture(root, tok, 64, SEED + 9)
        data_cfg = DataConfig(max_seq_len=4096, max_tiles=max_tiles,
                              preprocess=PreprocessConfig(
                                  tile_size=cfg.vit.image_size,
                                  max_tiles=tiles_per_image,
                                  resize_hw=None))
        batches = mixture_batches(load_meta(meta), tok, cfg, synthetic_frame,
                                  2, data_cfg, seed=SEED, packed=True)
        first = next(batches)
        real = int((first["segment_ids"] > 0).sum())
        log(f"  batch: {first['input_ids'].shape} tokens ({real} in "
            f"segments), tiles {first['tiles'].shape}")
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        summary, history = cli.train_steps(
            step, itertools.chain([first], batches), 4, dev, log_every=1,
            log=lambda kind, **kw: log(f"  {kind} {kw}"))
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train: {summary}")
    log(f"  step seconds {[round(h['step_s'], 4) for h in history]}; "
        f"torch.cuda.max_memory_allocated {peak:.3f} GiB; launches on the "
        f"train path: {launches}; card {card_name_and_power_limit()}")
    if summary["steps"] != 4:
        fail(f"{summary['steps']}/4 train steps")
    bad = [h for h in history if not all(
        map(lambda x: x == x and abs(x) < float("inf"),
            (h["loss"], h["grad_norm"])))]
    if bad:
        fail(f"non-finite loss or grad norm: {bad}")
    if min(launches.values()) <= 0:
        fail(f"a kernel never launched on the train path: {launches}")

    # a fresh optimizer on the train CLI's default schedule takes
    # REPEAT_STEPS steps on the first batch, repeated (the old moments are
    # freed first)
    del step, opt
    gc.collect()
    opt = T.AdamW(list(model.named_parameters()), T.TrainConfig(
        learning_rate=REPEAT_LR, warmup_steps=REPEAT_WARMUP,
        total_steps=REPEAT_TOTAL))
    step = T.make_train_step(model, opt, accum_steps=2)
    _, history = cli.train_steps(step, itertools.repeat(first), REPEAT_STEPS,
                                 dev, log=lambda *a, **k: None)
    losses = [h["loss"] for h in history]
    log(f"  repeated batch, lr {REPEAT_LR:g} warmup {REPEAT_WARMUP} (the "
        f"CLI's defaults): losses {losses}")
    # the first update has lr 0; every one after it must lower the loss
    if not all(b < a for a, b in zip(losses[1:], losses[2:])):
        fail(f"the loss did not fall on a repeated batch: {losses}")
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary, peak


def grouped_library(torch, form, a, b, sizes):
    """`torch._grouped_mm` on the same inputs, where this torch has it and
    it computes the same function (checked against the plain version by
    the caller): a callable, or None. Timed only; the port never calls
    it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    if form == "gmm":
        call = lambda: fn(a, b, offs=offs)                     # noqa: E731
    elif form == "gmm_t":
        call = lambda: fn(a, b.transpose(-2, -1), offs=offs)   # noqa: E731
    else:   # tgmm: [K, M] x [M, N] per group of M
        call = lambda: fn(a.t(), b, offs=offs)                 # noqa: E731
    try:
        call()
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 (a yardstick, not the port)
        log(f"    torch._grouped_mm ({form}) not usable here: "
            f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}")
        return None
    return call


def gmm_general(torch, G, lhs, rhs, gs):
    """gmm through its C entry with splits 0: the general kernel at any M
    (the wrapper takes the few-rows kernel at M <= G.ROWS_PATH_MAX)."""
    m, k = lhs.shape
    out = torch.empty(m, rhs.shape[2], dtype=lhs.dtype, device=lhs.device)
    G.GMM(G.ptr(lhs), G.ptr(rhs), G.ptr(gs), G.ptr(out), G.ptr(None), m, k,
          rhs.shape[2], gs.numel(), 1, 0)
    return out


def phase_k8(torch, G, B):
    """gmm, gmm_t and tgmm (K8) against their plain versions on float32
    copies: the preflight shape (NK 16384, D = F = 2048, E 4; uniform and
    skewed groups), the MoE train shape (NK 8192, D 2048, F 8192, and the
    down projection F -> D), gmm at the serve shapes (16 decode rows, 512
    prefill rows), 64 groups of which four hold rows, a group inside one
    128-row tile and a one-row group, M = 1, 64 and 65 around the few-rows
    path's threshold (all forms), and small f32 cases. Fault probes: a gmm
    and a tgmm with one 64-row tile 10% off must fail the check. The split
    few-rows path must repeat bit for bit. Every form is timed at every
    shape of the train and serve paths against its bound and
    `torch._grouped_mm`, the general kernels also at BN 256, and gmm at 16
    and 64 rows also on the general kernel. Returns (max abs err per
    entry, timings)."""
    import ctypes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {"gmm": 0.0, "gmm_t": 0.0, "tgmm": 0.0}
    all_forms = ("gmm", "gmm_t", "tgmm")

    def case(name, m, k, n, sizes, dtype, probe=(), forms=all_forms):
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        e = len(sizes)
        lhs = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        rhs = (torch.randn(e, k, n, generator=gen, device=dev)
               * k ** -0.5).to(dtype)
        dy = torch.randn(m, n, generator=gen, device=dev).to(dtype)
        entries = {
            "gmm": (lambda: G.gmm(lhs, rhs, gs),
                    lambda x, w, d: G.gmm_plain(x, w, gs)),
            "gmm_t": (lambda: G.gmm(dy, rhs, gs, transpose_rhs=True),
                      lambda x, w, d: G.gmm_plain(d, w, gs, True)),
            "tgmm": (lambda: G.tgmm(lhs, dy, gs),
                     lambda x, w, d: G.tgmm_plain(x, d, gs))}
        parts, ok = [], True
        for form in forms:
            kern, plain = entries[form]
            got = kern()
            want = plain(lhs.float(), rhs.float(), dy.float())
            pl = plain(lhs, rhs, dy) if dtype == torch.bfloat16 else None
            torch.cuda.synchronize()
            # as [B, H, S, D] for the 64-row tile check: gmm/gmm_t tiles
            # of rows, tgmm tiles of K within each group
            view = (lambda x: x[:, None]) if form == "tgmm" else \
                (lambda x: x[None, None])
            tol = (K1_F32_ATOL if dtype == torch.float32
                   else BWD_BF16_REL * want.abs().max().item())
            ok_f, err, text = verdict(view(got), view(want), tol,
                                      None if pl is None else view(pl))
            ok = ok and ok_f
            errs[form] = max(errs[form], err)
            parts.append(f"{form} {text}")
            if form in probe:   # one 64-row tile 10% off
                bad = got.clone()
                if form == "tgmm":
                    r0, what = 3 * k // 4, "one 64-row tile of group 1"
                    bad[1, r0:r0 + 64] *= 1.1
                else:
                    r0 = sizes[0] + 64
                    what = f"rows {r0}-{r0 + 63}"
                    bad[r0:r0 + 64] *= 1.1
                ok_b, err_b, text_b = verdict(view(bad), view(want), tol,
                                              view(pl))
                log(f"  fault probe, {form} with {what} 10% off: "
                    f"{text_b}; max|err| alone "
                    f"{'passes' if err_b <= tol else 'fails'} it, the whole"
                    f" check {'passes' if ok_b else 'fails'} it")
                if ok_b:
                    fail(f"the bf16 check passes a {form} with one tile 10% "
                         f"off")
        log(f"  K8 {name}: " + "; ".join(parts) +
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"grouped matmul disagrees with its plain version on {name}")
        return lhs, rhs, dy, gs

    bf = torch.bfloat16
    shapes = {}
    shapes["preflight"] = case(
        "preflight NK16384 D2048 F2048 E4 uniform bf16", 16384, 2048, 2048,
        [4096] * 4, bf, probe=("gmm", "tgmm"))
    shapes["preflight skewed"] = case(
        "preflight skewed groups [9001, 4000, 3000, 383] bf16", 16384, 2048,
        2048, [9001, 4000, 3000, 383], bf)
    shapes["train gate/up"] = case(
        "train gate/up NK8192 D2048 -> F8192 E4 bf16", 8192, 2048, 8192,
        [2500, 1800, 2200, 1692], bf)
    shapes["train down"] = case(
        "train down NK8192 F8192 -> D2048 E4 bf16", 8192, 8192, 2048,
        [2500, 1800, 2200, 1692], bf)
    # the serve path's shapes (gmm only; serving takes no gradient): a
    # decode step's 16 rows (8 slots, top 2) with all four groups, one of
    # them empty, inside one partial 128-row tile, and a prefill's rows
    shapes["decode gate/up"] = case(
        "serve decode gate/up 16 rows D2048 -> F8192 groups [5, 0, 7, 4] "
        "bf16", 16, 2048, 8192, [5, 0, 7, 4], bf, forms=("gmm",))
    shapes["decode down"] = case(
        "serve decode down 16 rows F8192 -> D2048 groups [5, 0, 7, 4] bf16",
        16, 8192, 2048, [5, 0, 7, 4], bf, forms=("gmm",))
    for name, k, n in (("gate/up", 2048, 8192), ("down", 8192, 2048)):
        shapes[f"prefill {name}"] = case(
            f"serve prefill {name} 512 rows {k} -> {n} groups "
            f"[190, 141, 97, 84] bf16", 512, k, n, [190, 141, 97, 84], bf,
            forms=("gmm",))
    # around the few-rows path's threshold (gmm_t and tgmm stay on the
    # general kernel at every M), and the group layouts the schedules must
    # get right
    case("M1 D2048 -> F8192 groups [0, 1, 0, 0] bf16", 1, 2048, 8192,
         [0, 1, 0, 0], bf)
    shapes["64 rows gate/up"] = case(
        "M64 D2048 -> F8192 groups [20, 0, 30, 14] bf16", 64, 2048, 8192,
        [20, 0, 30, 14], bf)
    case("M65 D2048 -> F8192 groups [20, 0, 30, 15] bf16", 65, 2048, 8192,
         [20, 0, 30, 15], bf)
    case("E64, four live groups, rows past the total, M4096 K1024 N1024 "
         "bf16", 4096, 1024, 1024,
         [0] * 5 + [1500] + [0] * 30 + [1] + [0] * 20 + [2000] + [0] * 6
         + [500], bf)
    case("a group inside one 128-row tile, a one-row group, M2048 K1024 "
         "N2048 bf16", 2048, 1024, 2048, [700, 20, 1, 1327], bf,
         probe=("gmm",))
    case("f32 M300 K64 N96, an empty group, boundaries mid-tile", 300, 64,
         96, [70, 0, 150, 60], torch.float32)
    case("f32 M256 K128 N136, rows past the groups' total", 256, 128, 136,
         [10, 100, 40], torch.float32)

    # the split few-rows path sums its partials in a fixed order: one row
    # of the down projection (one live group), which the wrapper splits
    one = case("M1 F8192 -> D2048 groups [0, 0, 1, 0] bf16 (split K)", 1,
               8192, 2048, [0, 0, 1, 0], bf, forms=("gmm",))
    splits = G.rows_path_splits(1, 8192, 2048, 4, G.sm_count(dev))
    runs = [G.gmm(one[0], one[1], one[3]) for _ in range(3)]
    torch.cuda.synchronize()
    if splits < 2 or not all(torch.equal(runs[0], r) for r in runs[1:]):
        fail(f"the few-rows gmm with {splits} K parts is not bitwise "
             f"repeatable")
    log(f"  K8 few-rows gmm, one row of the down projection, {splits} K "
        f"parts: three calls bit-identical")

    tile_n = ctypes.CDLL(B.library_path("grouped_matmul")).gmm_tile_n
    tile_n.argtypes, tile_n.restype = [ctypes.c_int], ctypes.c_int
    timings = {}
    serve_only = ("gmm",)
    for label, forms in (
            ("preflight", all_forms), ("preflight skewed", all_forms),
            ("train gate/up", all_forms), ("train down", all_forms),
            ("prefill gate/up", serve_only), ("prefill down", serve_only),
            ("decode gate/up", serve_only), ("decode down", serve_only),
            ("64 rows gate/up", serve_only)):
        lhs, rhs, dy, gs = shapes[label]
        m, k = lhs.shape
        n = rhs.shape[2]
        rows = int(gs.sum())
        flops = 2 * rows * k * n
        # the weights of an empty group need not be read
        dead_b = nbytes(rhs) * int((gs == 0).sum()) // gs.numel()
        few_rows = m <= G.ROWS_PATH_MAX
        for form, kern, plain, args, out_b in (
                ("gmm", lambda: G.gmm(lhs, rhs, gs),
                 lambda: G.gmm_plain(lhs, rhs, gs), (lhs, rhs), m * n * 2),
                ("gmm_t", lambda: G.gmm(dy, rhs, gs, transpose_rhs=True),
                 lambda: G.gmm_plain(dy, rhs, gs, True), (dy, rhs),
                 m * k * 2),
                ("tgmm", lambda: G.tgmm(lhs, dy, gs),
                 lambda: G.tgmm_plain(lhs, dy, gs), (lhs, dy),
                 rhs.numel() * 2)):
            if form not in forms:
                continue
            t_k = cuda_ms(torch, kern)
            if few_rows:
                # the wrapper's time by events holds its host work when that
                # outruns the device; a graph's replay holds none
                t_dev = graph_ms(torch, kern) or t_k
                t_gen = graph_ms(torch, lambda: gmm_general(torch, G, lhs,
                                                            rhs, gs))
                alt = (f"on the device (CUDA graph) {t_dev:.4f} ms, the "
                       f"general kernel there {ms_text(t_gen)}")
            else:
                t_dev, alt = t_k, ""
                for bn in (128, 256):
                    tile_n(bn)
                    try:
                        alt += f"BN {bn} {cuda_ms(torch, kern):.4f} ms, "
                    finally:
                        tile_n(0)
                alt = alt[:-2]
            t_p = cuda_ms(torch, plain, iters=3, warmup=1)
            lib = grouped_library(torch, form, *args, gs)
            t_l = None
            if lib is not None:
                # it must compute the same function on the groups' rows
                ref, got = plain(), lib()
                rows_ok = ref[:rows] if form != "tgmm" else ref
                got = got[:rows] if form != "tgmm" else got
                same = (got.float() - rows_ok.float()).abs().max().item() \
                    <= BWD_BF16_REL * rows_ok.float().abs().max().item()
                t_l = cuda_ms(torch, lib) if same else None
                if not same:
                    log(f"    torch._grouped_mm ({form}) computes another "
                        f"function here; not timed")
                elif few_rows:
                    alt += (f", torch._grouped_mm on the device "
                            f"{ms_text(graph_ms(torch, lib))}")
            in_b = nbytes(*args) - (dead_b if form != "tgmm" else 0)
            n_bytes = in_b + out_b + nbytes(gs)
            bound = bound_ms(flops, n_bytes)
            rate = (f"{flops / t_dev / 1e9:.1f} TFLOP/s"
                    if bound[1] == "operations"
                    else f"{n_bytes / t_dev / 1e6:.1f} GB/s")
            where = " on the device" if few_rows else ""
            log(f"  K8 {form} {label} ({m}x{k}x{n}, {rows} rows in groups) "
                f"timing: kernel {t_k:.4f} ms ({rate}, "
                f"{bound[0] / t_dev:.1%} of the bound{where}), {alt}; "
                f"plain {t_p:.4f} ms, torch._grouped_mm "
                f"{'none' if t_l is None else f'{t_l:.4f} ms'}, bound "
                f"{bound[0]:.4f} ms ({bound[1]}; {flops / 1e9:.1f} GFLOP, "
                f"{n_bytes / 1e6:.1f} MB)")
            timings[(form, label)] = (t_k, t_p, t_l, bound, t_dev)

    # where the few-rows kernel pays: both projections of a decode-like
    # step at M rows (up to three live groups of four), device ms from CUDA
    # graphs of the C entry: the general kernel (splits 0) against the
    # few-rows kernel at 1, 2, 4 and 8 K parts
    log(f"  K8 gmm at few rows, ms on the device (the wrapper's choice in "
        f"brackets; rows path at M <= {G.ROWS_PATH_MAX}):")
    for m in (1, 8, 16, 32, 48, 64):
        sizes = [m - m // 2 - m // 4, 0, m // 2, m // 4]
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs = torch.randn(m, 8192, generator=gen, device=dev).to(bf)
        for name, k, n in (("gate/up", 2048, 8192), ("down", 8192, 2048)):
            rhs = (torch.randn(4, k, n, generator=gen, device=dev)
                   * k ** -0.5).to(bf)
            x = lhs[:, :k].contiguous()
            out = torch.empty(m, n, dtype=bf, device=dev)
            ws = torch.empty(8 * m * n, dtype=torch.float32, device=dev)
            res = []
            for sp in (0, 1, 2, 4, 8):
                call = lambda sp=sp: G.GMM(  # noqa: E731
                    G.ptr(x), G.ptr(rhs), G.ptr(gs), G.ptr(out), G.ptr(ws),
                    m, k, n, 4, 1, sp)
                res.append(ms_text(graph_ms(torch, call)))
            log(f"    M {m} {name} {k}->{n} groups {sizes}: general "
                f"{res[0]}; few-rows by K parts 1: {res[1]}, 2: {res[2]}, "
                f"4: {res[3]}, 8: {res[4]} [wrapper: "
                f"{G.rows_path_splits(m, k, n, 4, G.sm_count(dev))}]")
    return errs, timings


def build_all(kernels):
    """Build every kernel source with one nvcc each, all at once, then
    bind the remaining entry points of each library."""
    from concurrent.futures import ThreadPoolExecutor

    firsts = list({k.source: k for k in kernels}.values())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(firsts)) as pool:
        list(pool.map(lambda k: k.build(), firsts))
    for kern in kernels:
        kern.build()
    for kern in firsts:
        log(f"[2/{N_PHASES}] built {kern.source}.cu in "
            f"{kern.build_seconds:.1f} s")
        for line in ptxas_report(kern.build_log):
            log(f"      ptxas: {line}")
    log(f"      all kernels built in {time.perf_counter() - t0:.1f} s")


def ptxas_kernels(build_log):
    """(name, registers, spill store bytes, spill load bytes) a kernel from
    nvcc's -Xptxas=-v output; the name carries the template arguments."""
    import re

    found, name, spill = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # the name follows its length in the mangled symbol
            k = re.search(r"(?<=\d)([a-z]+(?:_(?:[a-z]+|bf16|f32|int8))*"
                          r"_kernel)(?:I((?:L[a-z]\d+E)+)E)?", m.group(1))
            name = m.group(1) if k is None else k.group(1) + (
                f"<{','.join(re.findall(r'(\d+)E', k.group(2)))}>"
                if k.group(2) else "")
            # K7's arguments start with types: q's, the pools' (S..._:
            # q's again; a: int8), then hd and the rep slots
            k7 = re.search(r"paged_decode_split_kernelI(13__nv_bfloat16|f)"
                           r"(S\d*_|a|f)Li(\d+)ELi(\d+)E", m.group(1))
            if k7:
                q_t = "bf16" if k7.group(1) == "13__nv_bfloat16" else "f32"
                pool = "int8" if k7.group(2) == "a" else q_t
                name = (f"paged_decode_split_kernel<{q_t},{pool},"
                        f"{k7.group(3)},{k7.group(4)}>")
            spill = (0, 0)
        elif "spill stores" in line:
            st = re.search(r"(\d+) bytes spill stores", line)
            ld = re.search(r"(\d+) bytes spill loads", line)
            spill = (int(st.group(1)), int(ld.group(1)))
        elif name and re.search(r"Used \d+ registers", line):
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            found.append((name, regs, *spill))
            name = None
    return found


def ptxas_report(build_log):
    """One line a kernel from nvcc's -Xptxas=-v output (its name and
    template arguments, registers, spill bytes), and every C75xx warning
    (a wgmma chain serialised)."""
    lines = [f"{n}: {r} registers, {st} bytes spill stores, {ld} bytes "
             f"spill loads" for n, r, st, ld in ptxas_kernels(build_log)]
    return lines + [line.strip() for line in build_log.splitlines()
                    if "C75" in line]


# The bf16 kernels whose SASS must hold wgmma (HGMMA) and TMA loads
# (UTMALDG), by library: the mangled names carry the template arguments
# (...flash_bwd_dq_bf16_kernelILi128EE..., ...gmm_wgmma_kernelILi0ELi128EE...)
SASS_KERNELS = {
    "flash_fwd": r"(flash_fwd)_bf16_kernelI((?:Li\d+E)+)E",
    "flash_bwd": r"(flash_bwd_[a-z]+)_bf16_kernelI((?:Li\d+E)+)E",
    "grouped_matmul": r"(gmm_wgmma|gmm_rows)_kernelI((?:Li\d+E)+)E",
}
SASS_WANT = (
    {f"{k}<{d}>" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
     for d in (32, 64, 128)}
    | {f"gmm_wgmma<{m},{bn}>" for m in (0, 1, 2) for bn in (128, 256)}
    | {f"gmm_rows<{nr}>" for nr in (16, 32, 64)})
# K8's bf16 kernels, which the entry points take by shape: ptxas must
# report no spill for them
K8_NO_SPILL = ({f"gmm_wgmma_kernel<{m},{bn}>" for m in (0, 1, 2)
                for bn in (128, 256)}
               | {f"gmm_rows_kernel<{nr}>" for nr in (16, 32, 64)}
               | {"gmm_splitk_reduce_kernel"})


def check_sass(build, k8_build_log):
    """cuobjdump's SASS of the flash and grouped-matmul libraries: each
    bf16 kernel (K1, K2 dq and K3 dk/dv at hd 32, 64 and 128; K8's general
    kernel for gmm, gmm_t and tgmm at BN 128 and 256 and its few-rows
    kernel at 16, 32 and 64 rows) must hold HGMMA (wgmma) and UTMALDG (TMA
    loads); and ptxas must report no spill for K8's kernels.
    Prints the counts."""
    import re

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    bf16 = {}
    for source, pattern in SASS_KERNELS.items():
        out = subprocess.run([tool, "-sass", build.library_path(source)],
                             capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            fail(f"cuobjdump: {out.stderr.strip()}")
        counts = None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                m = re.search(pattern, line)
                counts = None if m is None else bf16.setdefault(
                    f"{m.group(1)}<"
                    f"{','.join(re.findall(r'(\d+)E', m.group(2)))}>",
                    dict.fromkeys(("HGMMA", "UTMALDG"), 0))
            elif counts is not None:
                for op in counts:
                    counts[op] += op in line
    log(f"      cuobjdump -sass of the bf16 wgmma kernels: {bf16}")
    if set(bf16) != SASS_WANT or not all(min(c.values()) > 0
                                         for c in bf16.values()):
        fail(f"the bf16 kernels lack HGMMA or UTMALDG (want one of each in "
             f"{sorted(SASS_WANT)}): {bf16}")
    k8 = {n: (st, ld) for n, _, st, ld in ptxas_kernels(k8_build_log)}
    if not k8:
        log("      grouped_matmul was built before this run: no ptxas "
            "report to read")
        return
    spilled = {n: k8.get(n) for n in K8_NO_SPILL if k8.get(n) != (0, 0)}
    if spilled:
        fail(f"K8 kernels spill or were not reported by ptxas: {spilled}")


def k7_timing(timings):
    """(ms, plain ms, (bound ms, bound by)) of K7 at the serve shape: the
    device time from a graph's replay."""
    t = timings["serve"]
    return t["graph_ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"])


# K7's instantiations: q f32 or bf16, native or int8 pools, hd 32, 64 and
# 128, rep slots 1, 2, 4 and 8
K7_INSTANCES = 2 * 2 * 3 * 4


def check_k7_sass(build, build_log):
    """cuobjdump's SASS of paged_decode: every instantiation of
    `paged_decode_split_kernel` must hold its bulk copies (UBLKCP), and
    ptxas must report no spill for any. Prints the counts."""
    import re

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    lib = build.library_path("paged_decode")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()}")
    copies, current = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"paged_decode_split_kernel\S*", line)
            current = m and m.group(0)
            if current:
                copies[current] = 0
        elif current:
            copies[current] += "UBLKCP" in line
    spills = [(st, ld) for n, _, st, ld in ptxas_kernels(build_log)
              if n.startswith("paged_decode_split_kernel<")]
    log(f"      K7: {len(copies)} instantiations, UBLKCP a kernel "
        f"{min(copies.values(), default=0)}-"
        f"{max(copies.values(), default=0)}; ptxas: "
        + (f"{len(spills)} reported, {sum(x != (0, 0) for x in spills)} "
           f"spill" if build_log else "built before this run"))
    if len(copies) != K7_INSTANCES or min(copies.values()) == 0:
        fail(f"paged_decode_split_kernel: want {K7_INSTANCES} "
             f"instantiations, each with UBLKCP: {copies}")
    if build_log and (len(spills) != K7_INSTANCES
                      or any(x != (0, 0) for x in spills)):
        fail(f"paged_decode_split_kernel spills or was not reported by "
             f"ptxas: {spills}")


# --------------------------------------------------------------------------
# Phase 15: the data engine (scene -> visibility -> frame relations ->
# camera-movement JSONL)
# --------------------------------------------------------------------------

# card vs CPU: an angle may differ by ANGLE_ULP ulp of its own value on
# each side of a pair's difference (libdevice's f64 atan2 is within 2 ulp,
# torch's CPU atan2 within 1; the degree conversion can move the count
# across a binade), a distance by DIST_ULP ulp (the card's reduction of a
# 3-term sum of squares may order or contract it differently)
ANGLE_ULP = 8
DIST_ULP = 2
# bench.py's scenes: the real-scale ScanNet-val-shaped scene (:357-362)
# and the 40-scene bench corpus (:259-263)
REAL_SCENE = dict(scene_id="real0000_00", seed=7, n_images=296,
                  n_background=200_000, n_objects=8, image_hw=(968, 1296),
                  depth_hw=(480, 640), n_invalid_poses=0)
REAL_CPU_IMAGES = 24
N_CORPUS = 40
CM_QTYPES = ("total_distance", "displacement_vector", "yaw_angle",
             "x_movement")
CM_SAMPLES = 200_000
CM_PASSES = 3
DEMO_ARGS = ["--scenes", "2", "--images-per-scene", "12",
             "--points-per-scene", "4000"]


def corpus_scene(make_scene, i):
    return make_scene(scene_id=f"bench{i:04d}_00", seed=100 + i,
                      n_images=96, n_background=4000, n_objects=4,
                      depth_hw=(24, 32), n_invalid_poses=0)


def realscale_visibility(torch, np, V, scene, dtype, card):
    """Cold and steady seconds, tests/s, dispatches and peak device bytes
    of `compute_scene_visibility` over the real-scale scene."""
    pts, _ = scene.padded_points(dtype)
    ext, _, _ = scene.padded_images(dtype)
    i_pad, n_pad = ext.shape[0], pts.shape[0]
    chunk = V.image_chunk_for(i_pad, n_pad, dtype)
    dispatches = 1 if chunk is None else -(-i_pad // chunk)
    name = np.dtype(dtype).name
    t0 = time.perf_counter()
    V.compute_scene_visibility(scene, dtype)
    cold = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steady = []
    for _ in range(2):
        t0 = time.perf_counter()
        vis = V.compute_scene_visibility(scene, dtype)
        steady.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    pairs = i_pad * n_pad
    # the device program alone, its inputs resident (the rest of a call
    # is host packing, the upload and the fetch)
    dev = torch.device("cuda")
    ext, depth, ivalid = scene.padded_images(dtype)
    pvalid = scene.padded_points(dtype)[1]
    args = [torch.from_numpy(a).to(dev) for a in (
        pts, scene.intrinsic.astype(dtype), ext, depth.astype(np.int32),
        ivalid, pvalid)]
    device_ms = cuda_ms(torch, lambda: V._visibility_packed(
        *args, scene.image_hw), iters=5, warmup=1)
    del args
    tests = scene.num_images * scene.num_points
    log(f"  real-scale visibility {name}: {scene.num_images} images x "
        f"{scene.num_points} points, cold {cold:.3f} s, steady "
        f"{min(steady):.3f} s ({[round(t, 4) for t in steady]}), "
        f"{tests / min(steady) / 1e6:.1f} M tests/s, the device program "
        f"alone {device_ms:.3f} ms (CUDA events), {dispatches} "
        f"dispatch(es), peak {peak / 2**30:.3f} GiB over the allocated "
        f"base, {peak / pairs:.1f} bytes a padded pair "
        f"({i_pad} x {n_pad}); {card}")
    return vis, {"cold_s": cold, "steady_s": min(steady), "steady": steady,
                 "mtests_per_s": tests / min(steady) / 1e6,
                 "device_ms": device_ms,
                 "dispatches": dispatches, "peak_bytes": peak,
                 "bytes_per_pair": peak / pairs}


def first_difference(np, a, b):
    """(index, a value, b value) of the first element where a != b."""
    idx = np.argwhere(a != b)[0]
    return tuple(int(i) for i in idx), a[tuple(idx)], b[tuple(idx)]


def compare_relations(np, card_t, cpu_t):
    """Card vs CPU relation tables: identity columns and overlap exactly,
    distance/yaw/pitch within their ulp limits; a difference fails with
    its scene, its pair and both values."""
    for c in ("scene_id", "image_id1", "image_id2"):
        if card_t[c].tolist() != cpu_t[c].tolist():
            fail(f"relations: column {c} differs card vs CPU")
    # ulps of the columns' own dtype (float32 under the hybrid dtype)
    angle = cpu_t["yaw"].dtype.type
    limits = {
        "overlap": np.zeros(len(cpu_t["overlap"])),
        "distance": DIST_ULP * np.spacing(np.abs(cpu_t["distance"])),
        "yaw": 2 * ANGLE_ULP * np.spacing(angle(180.0)) * np.ones(
            len(cpu_t["yaw"])),
        "pitch": 2 * ANGLE_ULP * np.spacing(angle(90.0)) * np.ones(
            len(cpu_t["pitch"])),
    }
    worst = {}
    for c, lim in limits.items():
        a, b = card_t[c], cpu_t[c]
        same_nan = np.isnan(a) & np.isnan(b)
        gap = np.where(same_nan, 0.0, np.abs(a - b))
        bad = ~(gap <= lim)
        if bad.any():
            k = int(np.argmax(bad))
            fail(f"relations: {c} of {cpu_t['scene_id'][k]} "
                 f"({cpu_t['image_id1'][k]}, {cpu_t['image_id2'][k]}) is "
                 f"{a[k]!r} on the card and {b[k]!r} on the CPU "
                 f"(limit {lim[k]:.3g})")
        worst[c] = float(gap.max()) if len(gap) else 0.0
        worst[c + "_differ"] = int((gap > 0).sum())
    return worst


def first_differing_line(a, b):
    la, lb = a.splitlines(), b.splitlines()
    return next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                min(len(la), len(lb))) + 1


def demo_card_vs_cpu(np, cli, root, card):
    """`demo` (`run_all` with its TAPVid records) on the card and on the
    CPU, in this one process (the synthetic frames are seeded from
    Python's string hash): visibility.npz equal, relation columns within
    their limits, every file under qa/ (JSONL, frames and annotated JPEGs,
    the object-movement engines' included) and every pickle under indices/
    byte-equal."""
    from multi_spatialmllm_tpu_torch.pipeline import PipelineConfig

    roots = {}
    for dev in ("cuda", "cpu"):
        roots[dev] = os.path.join(root, f"demo_{dev}")
        t0 = time.perf_counter()
        cli.main(["demo", "--device", dev, "--output", roots[dev],
                  *DEMO_ARGS])
        log(f"  demo on {dev}: {time.perf_counter() - t0:.2f} s")
    return pipeline_roots_equal(
        np, roots, PipelineConfig(overlap_min=0.1, overlap_max=100.0,
                                  interval=5.0), "demo", card)


def pipeline_roots_equal(np, roots, config, label, card):
    """A `run_all` tree of the card (`roots["cuda"]`) against the CPU's:
    visibility.npz equal, relation columns within their limits, every
    file under qa/ and every pickle under indices/ byte-equal."""
    from multi_spatialmllm_tpu_torch.core.scene import SceneStore
    from multi_spatialmllm_tpu_torch.pipeline import SpatialEnginePipeline

    npz = {d: np.load(os.path.join(r, "indices", "visibility.npz"))
           for d, r in roots.items()}
    if sorted(npz["cuda"].files) != sorted(npz["cpu"].files):
        fail("visibility.npz: different entries card vs CPU")
    for k in npz["cpu"].files:
        a, b = npz["cuda"][k], npz["cpu"][k]
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"visibility.npz {k}: card vs CPU differ"
                 + (f" first at {first_difference(np, a, b)}"
                    if a.shape == b.shape else ""))
    tables = {}
    for dev, r in roots.items():
        pipe = SpatialEnginePipeline(
            SceneStore(os.path.join(r, "scenes")), r, config, device=dev)
        tables[dev] = pipe.frame_relations()
    worst = compare_relations(np, tables["cuda"], tables["cpu"])
    counts = {"jsonl": 0, "jpg": 0, "pkl": 0, "object_movement": 0}
    for sub, keep in (("qa", lambda f: True),
                      ("indices", lambda f: f.endswith(".pkl"))):
        files = {}
        for dev, r in roots.items():
            top = os.path.join(r, sub)
            files[dev] = sorted(
                os.path.relpath(os.path.join(d, f), top)
                for d, _, fs in os.walk(top) for f in fs if keep(f))
        if files["cuda"] != files["cpu"] or not files["cpu"]:
            fail(f"{sub}/: different files card vs CPU: "
                 f"{sorted(set(files['cuda']) ^ set(files['cpu']))[:5]}")
        for rel in files["cpu"]:
            with open(os.path.join(roots["cuda"], sub, rel), "rb") as f, \
                    open(os.path.join(roots["cpu"], sub, rel), "rb") as g:
                a, b = f.read(), g.read()
            if a != b:
                where = (f"line {first_differing_line(a, b)}"
                         if rel.endswith(".jsonl") else
                         f"{len(a)} vs {len(b)} bytes")
                fail(f"{sub}/{rel}: differs card vs CPU ({where})")
            ext = rel.rsplit(".", 1)[-1]
            counts[ext] = counts.get(ext, 0) + 1
            counts["object_movement"] += "object_movement_" in rel
    log(f"  {label} card vs CPU: visibility.npz equal, {len(tables['cpu']['overlap'])} "
        f"relation rows (overlap equal; largest gaps {worst}), byte-equal: "
        f"{counts['jsonl']} JSONL, {counts['jpg']} JPEG and {counts['pkl']} "
        f"index pickles ({counts['object_movement']} of the files from the "
        f"object-movement engines); {card}")
    if not (counts["jsonl"] and counts["jpg"] and counts["pkl"] == 4
            and counts["object_movement"]):
        fail(f"{label} card vs CPU compared too little: {counts}")
    return {**worst, "files": counts}


def phase_data_engine(torch, cli, card):
    """Phase 15: real-scale f64 visibility, the bench corpus through
    visibility, relations and camera movement, and `demo` card vs CPU."""
    import dataclasses
    import tempfile

    import numpy as np

    from multi_spatialmllm_tpu_torch.core.scene import SceneStore
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.engines import camera_movement as CM
    from multi_spatialmllm_tpu_torch.stages import frame_relations as FR
    from multi_spatialmllm_tpu_torch.stages import visibility as V

    out = {}
    no_parquet = FR.parquet_unavailable()
    log(f"  pandas and pyarrow: "
        f"{'importable' if no_parquet is None else 'missing: ' + no_parquet}")
    t0 = time.perf_counter()
    real = make_scene(**REAL_SCENE)
    log(f"  real-scale scene made in {time.perf_counter() - t0:.1f} s "
        f"({real.depth_maps.nbytes / 1e6:.1f} MB of depth maps)")
    vis64, out["real_f64"] = realscale_visibility(torch, np, V, real,
                                                  np.float64, card)
    _, out["real_f32"] = realscale_visibility(torch, np, V, real, np.float32,
                                              card)
    head = dataclasses.replace(
        real, image_ids=real.image_ids[:REAL_CPU_IMAGES],
        extrinsics=real.extrinsics[:REAL_CPU_IMAGES],
        depth_maps=real.depth_maps[:REAL_CPU_IMAGES])
    cpu = V.compute_scene_visibility(head, np.float64, device="cpu")
    if not np.array_equal(vis64[:REAL_CPU_IMAGES], cpu):
        fail(f"real-scale f64 visibility: card vs CPU differ, first at "
             f"(image, point) {first_difference(np, vis64[:REAL_CPU_IMAGES], cpu)}")
    log(f"  real-scale f64 bits card == CPU on the first {REAL_CPU_IMAGES} "
        f"images ({int(cpu.sum())} visible of {cpu.size})")
    del real, head, vis64
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scenes = [corpus_scene(make_scene, i) for i in range(N_CORPUS)]
        store = SceneStore.write(scenes, os.path.join(tmp, "scenes"))
        log(f"  bench corpus: {N_CORPUS} scenes made in "
            f"{time.perf_counter() - t0:.1f} s")
        V.compute_visibility_batch(scenes[:10], np.float32, batch_size=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vis = V.compute_visibility_batch(scenes, np.float32, batch_size=10)
        dt = time.perf_counter() - t0
        out["visibility_f32_bench"] = N_CORPUS / dt
        log(f"  visibility f32 batched: {dt:.3f} s, "
            f"{N_CORPUS / dt:.2f} scenes/s; {card}")
        FR.build_frame_relations(scenes[:4], visibility=vis,
                                 dtype=np.float32)
        t0 = time.perf_counter()
        relations = FR.build_frame_relations(scenes, visibility=vis,
                                             dtype=np.float32)
        dt = time.perf_counter() - t0
        n_pairs = len(relations["overlap"])
        out["frame_relations"] = n_pairs / dt
        log(f"  frame relations: {dt:.3f} s, {n_pairs} pairs, "
            f"{n_pairs / dt:,.0f} pairs/s; {card}")
        relations = CM.prepare_relations(relations, store)
        cfg = CM.CameraMovementConfig()
        CM.generate_to_jsonl(relations, store, "total_distance", 1000,
                             os.path.join(tmp, "warmup.jsonl"), cfg)
        rates = []
        for _ in range(CM_PASSES):
            total = 0
            t0 = time.perf_counter()
            for qtype in CM_QTYPES:
                total += CM.generate_to_jsonl(
                    relations, store, qtype, CM_SAMPLES,
                    os.path.join(tmp, f"{qtype}_train.jsonl"), cfg)
            rates.append(total / (time.perf_counter() - t0))
        out["camera_movement_qa_samples_per_sec"] = sorted(rates)[
            len(rates) // 2]
        log(f"  camera movement ({', '.join(CM_QTYPES)}; {CM_SAMPLES} "
            f"samples each, production config, native emitter): "
            f"{total} samples a pass, median "
            f"{out['camera_movement_qa_samples_per_sec']:,.0f} samples/s "
            f"({[round(r) for r in rates]}); {card}")
        out["demo"] = demo_card_vs_cpu(np, cli, tmp, card)
    return out


# --------------------------------------------------------------------------
# Phase 16: the rest of the ScanNet engines (object visibility M3, coverage
# M4 and its host search, object perception; depth, correspondence)
# --------------------------------------------------------------------------

STAGE_PASSES = 3         # host-clock passes of a stage or engine (median)
ANN_SCENE = dict(n_images=48, n_background=4000, n_objects=4,
                 image_hw=(480, 640), depth_hw=(120, 160), n_invalid_poses=0)
CORR_COOR_SAMPLES = 50_000


def median(xs):
    """bench.py's `_stats` median: the middle pass, or the mean of the two
    middle passes."""
    v, n = sorted(xs), len(xs)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def device_peak(torch, fn):
    """Peak device bytes of `fn()` over what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def m3_m4_realscale(torch, np, real, vis, card):
    """M3 (object counts) and M4 (coverage intervals) on the real-scale
    scene: card == CPU bit for bit with equal dtypes, each device program
    alone timed by CUDA events with its inputs resident, beside its bytes
    bound, and the peak device bytes of each."""
    from multi_spatialmllm_tpu_torch.stages import coverage as CV
    from multi_spatialmllm_tpu_torch.stages import object_visibility as OV

    t0 = time.perf_counter()
    card_out = {"M3": (OV.object_image_counts(real, vis),),
                "M4": CV.object_coverage_intervals(real, vis)}
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out = {"M3": (OV.object_image_counts(real, vis, device="cpu"),),
               "M4": CV.object_coverage_intervals(real, vis, device="cpu")}
    cpu_s = time.perf_counter() - t0
    for name, outs in cpu_out.items():
        for k, (a, b) in enumerate(zip(card_out[name], outs)):
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"{name} output {k}: {a.dtype}{a.shape} on the card, "
                     f"{b.dtype}{b.shape} on the CPU")
            if not np.array_equal(a, b):
                fail(f"{name} output {k}: card vs CPU differ, first at "
                     f"{first_difference(np, a, b)}")
    log(f"  M3 counts {card_out['M3'][0].dtype}{card_out['M3'][0].shape}, "
        f"M4 mins/maxs {card_out['M4'][0].dtype}{card_out['M4'][0].shape} "
        f"and counts {card_out['M4'][2].dtype}{card_out['M4'][2].shape}: "
        f"card == CPU bit for bit on all {real.num_images} images "
        f"(card {card_s:.3f} s, CPU {cpu_s:.3f} s, both host clock with "
        f"the upload and fetch)")
    dev = torch.device("cuda")
    packed = torch.from_numpy(np.packbits(vis, axis=1)).to(dev)
    ids = torch.from_numpy(real.instance_ids.astype(np.int32)).to(dev)
    coords = torch.from_numpy(np.ascontiguousarray(
        real.points_aligned[:, :3], dtype=np.float64)).to(dev)
    n, segs, i = vis.shape[1], real.num_objects + 1, vis.shape[0]
    progs = {
        "M3": (lambda: OV._count_kernel(packed, ids, n, segs),
               nbytes(packed, ids) + i * segs * 4),
        "M4": (lambda: CV._interval_fn(packed, ids, coords, n, segs),
               nbytes(packed, ids, coords) + 2 * i * 3 * segs * 8
               + i * segs * 4),
    }
    out = {"card_s": card_s, "cpu_s": cpu_s}
    for name, (fn, n_bytes) in progs.items():
        peak = device_peak(torch, fn)
        t = cuda_ms(torch, fn, iters=5, warmup=1)
        b_ms = n_bytes / PEAK_BYTES * 1e3
        out[name] = {"ms": t, "bound_ms": b_ms, "bound_by": "bytes",
                     "bytes": n_bytes, "peak_bytes": peak}
        log(f"  {name} device program alone: {t:.4f} ms (CUDA events, "
            f"inputs resident), bytes bound {b_ms:.4f} ms ({n_bytes / 1e6:.2f}"
            f" MB at {PEAK_BYTES / 1e12:.2f} TB/s; {b_ms / t:.1%} of it), "
            f"peak {peak / 2**20:.1f} MiB over the allocated base; {card}")
    return out


def timed_passes(fn, passes=STAGE_PASSES):
    """Host seconds of `passes` calls of fn(i) and the last result."""
    times, res = [], None
    for k in range(passes):
        t0 = time.perf_counter()
        res = fn(k)
        times.append(time.perf_counter() - t0)
    return times, res


def phase_scannet_engines(torch, card):
    """Phase 16: M3/M4 on the real-scale scene (card vs CPU, device ms,
    bounds, peak bytes) and the bench's object-visibility, coverage and
    object-perception stages on it; then the depth and correspondence
    engines at bench.py's configurations. Rates under bench.py's keys."""
    import shutil
    import tempfile

    import numpy as np

    from multi_spatialmllm_tpu_torch.core.scene import SceneStore
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.engines import depth_perception as DP
    from multi_spatialmllm_tpu_torch.engines import object_perception as OP
    from multi_spatialmllm_tpu_torch.engines import visual_correspondence as VC
    from multi_spatialmllm_tpu_torch.engines.annotate import (
        SyntheticImageProvider,
    )
    from multi_spatialmllm_tpu_torch.stages import coverage as CV
    from multi_spatialmllm_tpu_torch.stages import frame_relations as FR
    from multi_spatialmllm_tpu_torch.stages import object_visibility as OV
    from multi_spatialmllm_tpu_torch.stages import visibility as V

    out, rates = {}, {}

    def rate(key, n, times, unit="samples/s"):
        per = [n / t for t in times]
        rates[key] = median(per)
        log(f"  {key}: {n} a pass, median {rates[key]:,.1f} {unit} "
            f"({[round(r, 1) for r in per]}); {card}")

    def seconds(key, times):
        rates[key] = median(times)
        log(f"  {key}: median {rates[key]:.4f} s/scene "
            f"({[round(t, 4) for t in times]}); {card}")

    real = make_scene(**REAL_SCENE)
    vis = V.compute_scene_visibility(real, np.float64)
    out["m3_m4"] = m3_m4_realscale(torch, np, real, vis, card)
    vmap = {real.scene_id: vis}
    OV.build_object_visibility([real], visibility=vmap)       # warm
    times, ovis = timed_passes(
        lambda k: OV.build_object_visibility([real], visibility=vmap))
    seconds("object_visibility_realscale", times)
    CV.build_object_coverage([real], ovis, visibility=vmap)   # warm
    times, cov = timed_passes(
        lambda k: CV.build_object_coverage([real], ovis, visibility=vmap))
    seconds("coverage_search_realscale", times)
    with tempfile.TemporaryDirectory() as tmp:
        real_store = SceneStore.write([real], os.path.join(tmp, "real"))
        cov_by_dim = dict(zip(("height", "length", "width"), cov))
        OP.generate(real_store, cov_by_dim, os.path.join(tmp, "op_w"),
                    "train")
        times, op_out = timed_passes(lambda k: OP.generate(
            real_store, cov_by_dim, os.path.join(tmp, f"op{k}"), "train"))
        rate("object_perception", sum(o.n_train for o in op_out.values()),
             times)
        del real, vis, vmap, real_store
        torch.cuda.empty_cache()

        # the 40-scene bench corpus (f32 visibility, as bench.py builds it)
        scenes = [corpus_scene(make_scene, i) for i in range(N_CORPUS)]
        store = SceneStore.write(scenes, os.path.join(tmp, "scenes"))
        cvis = V.compute_visibility_batch(scenes, np.float32, batch_size=10)
        vindex = V.VisibilityIndex()
        for s in scenes:
            vindex.add_scene(s.scene_id, s.image_ids, cvis[s.scene_id])
        relations = FR.build_frame_relations(scenes, visibility=cvis,
                                             dtype=np.float32)
        DP.generate_depth_estimation_to_jsonl(
            store, vindex, os.path.join(tmp, "de_w.jsonl"), "coor",
            DP.DepthEngineConfig(all_max_samples=500))
        times, res = timed_passes(lambda k: DP.generate_depth_estimation_to_jsonl(
            store, vindex, os.path.join(tmp, "de.jsonl"), "coor",
            DP.DepthEngineConfig(max_n_points_per_image=5)))
        rate("depth_estimation_coor", res.n_train, times)
        DP.generate_depth_comparison_to_jsonl(
            store, vindex, os.path.join(tmp, "dcc_w.jsonl"), "coor",
            DP.DepthEngineConfig(all_max_samples=500,
                                 max_n_points_per_image=2))
        times, res = timed_passes(lambda k: DP.generate_depth_comparison_to_jsonl(
            store, vindex, os.path.join(tmp, "dcc.jsonl"), "coor",
            DP.DepthEngineConfig(max_n_points_per_image=4)))
        rate("depth_comparison_coor", res.n_train, times)
        vc_cfg = VC.CorrespondenceConfig()   # production 6-35 / 1.0
        VC.generate_coor_to_coor_to_jsonl(
            relations, store, vindex, os.path.join(tmp, "vc_w.jsonl"), 500,
            vc_cfg)
        times, res = timed_passes(lambda k: VC.generate_coor_to_coor_to_jsonl(
            relations, store, vindex, os.path.join(tmp, "vc.jsonl"),
            CORR_COOR_SAMPLES, vc_cfg))
        rate("correspondence_coor", res.n_train, times)
        del scenes, store, cvis, vindex, relations

        # two annotated scenes at the ScanNet export's 480x640 frames
        ann = [make_scene(scene_id=f"annot{i:04d}_00", seed=300 + i,
                          **ANN_SCENE) for i in range(2)]
        ann_store = SceneStore.write(ann, os.path.join(tmp, "ann"))
        avis = V.compute_visibility_batch(ann, np.float32, batch_size=2)
        aindex = V.VisibilityIndex()
        for s in ann:
            aindex.add_scene(s.scene_id, s.image_ids, avis[s.scene_id])
        arel = FR.build_frame_relations(ann, visibility=avis,
                                        dtype=np.float32)
        provider = SyntheticImageProvider((480, 640))

        def annotated(key, fn):
            """A warm pass (it prepares every source frame once), then the
            steady passes, each into a fresh image directory."""
            fn("w")
            times, res = [], None
            for k in range(STAGE_PASSES):
                t0 = time.perf_counter()
                res = fn(k)
                times.append(time.perf_counter() - t0)
                shutil.rmtree(os.path.join(tmp, f"img_{key}_{k}"))
            shutil.rmtree(os.path.join(tmp, f"img_{key}_w"))
            rate(key, res.n_train, times)

        annotated("depth_estimation_dot",
                  lambda k: DP.generate_depth_estimation_to_jsonl(
                      ann_store, aindex, os.path.join(tmp, f"dd{k}.jsonl"),
                      "dot", DP.DepthEngineConfig(max_n_points_per_image=4),
                      image_provider=provider,
                      image_output_dir=os.path.join(
                          tmp, f"img_depth_estimation_dot_{k}")))
        annotated("depth_comparison_dot",
                  lambda k: DP.generate_depth_comparison_to_jsonl(
                      ann_store, aindex, os.path.join(tmp, f"dc{k}.jsonl"),
                      "dot", DP.DepthEngineConfig(max_n_points_per_image=4),
                      image_provider=provider,
                      image_output_dir=os.path.join(
                          tmp, f"img_depth_comparison_dot_{k}")))
        vcd_cfg = VC.CorrespondenceConfig(overlap_min=0.1, overlap_max=100.0,
                                          interval=5.0)
        annotated("correspondence_dot_multichoice",
                  lambda k: VC.generate_dot_to_multichoice_to_jsonl(
                      arel, ann_store, aindex,
                      os.path.join(tmp, f"vcd{k}.jsonl"), 400,
                      os.path.join(
                          tmp, f"img_correspondence_dot_multichoice_{k}"),
                      image_provider=provider, config=vcd_cfg))
    out["rates"] = rates
    return out


# --------------------------------------------------------------------------
# Phase 17: the TAPVid object-movement engines (M5, the native JPEG codec)
# --------------------------------------------------------------------------

# the real-scale stand-in for a long ADT clip (PERF.md section 4): 512 x 512
# frames, T 300, N 1,024 = 8 groups x 96 points + 256 static
M5_REAL = dict(n_frames=300, n_groups=8, points_per_group=96, n_static=256,
               image_hw=(512, 512), seed=11)
# bench.py's object-movement records and config (:641-679)
OM_RECORDS = 8
OM_RECORD = dict(n_frames=24, n_groups=4, points_per_group=10, n_static=20)
OM_CONFIG = dict(question_type="tapvid3d_total_distance",
                 npoints_per_group=15, npairs_per_bin=2)
CODEC_FRAMES = 16        # 512 x 512 frames of each kind, for the MB/s


def golden_module():
    """scripts/gen_jpeg_golden.py: its seeded frames, digest functions and
    the stored file's path (it imports cv2 only when run)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "gen_jpeg_golden.py")
    spec = importlib.util.spec_from_file_location("gen_jpeg_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def codec_check(card):
    """The native codec against cv2's stored digests, then its MB/s (raw
    BGR bytes over one thread's host seconds) on 512 x 512 frames."""
    import base64

    from multi_spatialmllm_tpu_torch.ingest import jpeg

    G = golden_module()
    with open(G.OUT) as f:
        stored = json.load(f)
    for c in stored["cases"]:
        img = G.frame(c["kind"], c["h"], c["w"], c["seed"])
        data = (jpeg.imencode(img) if c["quality"] is None
                else jpeg.imencode(img, c["quality"]))
        if G.sha(data) != c["encode"]:
            fail(f"codec: encode of {c} differs from cv2's")
        if G.pixels_sha(jpeg.imdecode(data)) != c["decode"]:
            fail(f"codec: decode of {c} differs from cv2's")
    for o in stored["other"]:
        if G.pixels_sha(jpeg.imdecode(base64.b64decode(o["jpeg"]))) \
                != o["decode"]:
            fail(f"codec: decode of cv2's {o['name']} file differs")
    log(f"  codec: {len(stored['cases'])} encodes byte-equal and their "
        f"decodes pixel-equal to cv2 {stored['cv2']} ({stored['jpeg']}) by "
        f"digest; cv2's {', '.join(o['name'] for o in stored['other'])} "
        f"files decoded pixel-equal")
    out = {}
    for kind in G.KINDS:
        frames = [G.frame(kind, 512, 512, 2000 + i)
                  for i in range(CODEC_FRAMES)]
        mb = len(frames) * 512 * 512 * 3 / 1e6
        encoded = [jpeg.imencode(f) for f in frames]
        t0 = time.perf_counter()
        for f in frames:
            jpeg.imencode(f)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in encoded:
            jpeg.imdecode(b)
        dec_s = time.perf_counter() - t0
        out[kind] = {"encode_MBps": mb / enc_s, "decode_MBps": mb / dec_s,
                     "jpeg_bytes": sum(map(len, encoded)) / len(encoded)}
        log(f"  codec on {len(frames)} {kind} 512 x 512 frames (q95, "
            f"{out[kind]['jpeg_bytes']:,.0f} B each): decode "
            f"{out[kind]['decode_MBps']:.1f} MB/s, encode "
            f"{out[kind]['encode_MBps']:.1f} MB/s of BGR pixels, one "
            f"thread; {card}")
    return out


def m5_realscale(torch, np, OM, rec, card):
    """M5 on the real-scale stand-in: card == CPU bit for bit, the device
    program alone by CUDA events with its input resident, its bytes bound
    and peak device bytes, and the groups equal."""
    pts_np = rec["tracks_XYZ"]
    t, n, _ = pts_np.shape
    t0 = time.perf_counter()
    on_card = OM.cumulative_loss(pts_np, "cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = OM.cumulative_loss(pts_np, "cpu")
    cpu_s = time.perf_counter() - t0
    if on_card.dtype != on_cpu.dtype or not np.array_equal(on_card, on_cpu):
        fail(f"M5 card vs CPU differ, first at "
             f"{first_difference(np, on_card, on_cpu)}")
    log(f"  M5 at T {t}, N {n}: card == CPU bit for bit "
        f"({on_card.dtype}{list(on_card.shape)}; card {card_s:.3f} s, CPU "
        f"{cpu_s:.3f} s, host clock with the upload and fetch); {card}")
    pts = torch.from_numpy(np.ascontiguousarray(pts_np, np.float32)).cuda()
    peak = device_peak(torch, lambda: OM.m5(pts))
    ms = cuda_ms(torch, lambda: OM.m5(pts), iters=5, warmup=1)
    n_bytes = t * n * 3 * 4 + n * n * 4
    b_ms = n_bytes / PEAK_BYTES * 1e3
    log(f"  M5 device program alone: {ms:.4f} ms (CUDA events, input "
        f"resident), bytes bound {b_ms:.5f} ms ({n_bytes / 1e6:.2f} MB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s; {b_ms / ms:.2%} of it), peak "
        f"{peak / 2**20:.1f} MiB over the allocated base; {card}")
    groups = {dev: OM.rigid_body_segmentation(pts_np, device=dev)
              for dev in ("cuda", "cpu")}
    if groups["cuda"] != groups["cpu"]:
        fail("M5: rigid-body groups differ card vs CPU")
    log(f"  rigid-body groups card == CPU: {len(groups['cpu'])} groups of "
        f"{sorted(len(g) for g in groups['cpu'])} points")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": "bytes",
            "bytes": n_bytes, "peak_bytes": peak, "card_s": card_s,
            "cpu_s": cpu_s, "groups": len(groups["cpu"])}


def tapvid_card_vs_cpu(cli, make_tapvid_npz, root, card):
    """The `tapvid` command over npz files in `<data>/adt/` with a small
    `--meta`, train and val, with and without `--dot`, on the card and on
    the CPU: every file byte-equal."""
    data, meta = os.path.join(root, "data"), os.path.join(root, "meta")
    os.makedirs(os.path.join(data, "adt"))
    os.makedirs(os.path.join(meta, "adt"))
    for k, split in enumerate(("train", "val")):
        ids = [f"{split}_clip{i}" for i in range(2)]
        for i, sid in enumerate(ids):
            make_tapvid_npz(os.path.join(data, "adt", f"{sid}.npz"),
                            seed=300 + 10 * k + i, **OM_RECORD)
        with open(os.path.join(meta, "adt", f"{split}.txt"), "w") as f:
            f.write("".join(f"{sid}\n" for sid in ids))
    n_files = 0
    for split in ("train", "val"):
        for dot in (False, True):
            outs = {}
            for dev in ("cuda", "cpu"):
                outs[dev] = os.path.join(root, f"{split}_{dot}_{dev}")
                cli.main(["tapvid", "--data", data, "--meta", meta,
                          "--split", split, "--output", outs[dev],
                          "--device", dev] + ["--dot"] * dot)
            files = {dev: sorted(
                os.path.relpath(os.path.join(d, f), o)
                for d, _, fs in os.walk(o) for f in fs)
                for dev, o in outs.items()}
            if files["cuda"] != files["cpu"] or not files["cpu"]:
                fail(f"tapvid {split} dot={dot}: different files card vs CPU")
            for rel in files["cpu"]:
                with open(os.path.join(outs["cuda"], rel), "rb") as f, \
                        open(os.path.join(outs["cpu"], rel), "rb") as g:
                    if f.read() != g.read():
                        fail(f"tapvid {split} dot={dot}: {rel} differs card "
                             f"vs CPU")
            n_files += len(files["cpu"])
    log(f"  tapvid command (train and val, with and without --dot) card vs "
        f"CPU: {n_files} files byte-equal; {card}")
    return n_files


def phase_object_movement(torch, cli, card):
    """Phase 17: the codec against cv2's digests and its MB/s, M5 at the
    real-scale stand-in card vs CPU, the engines' rates under bench.py's
    keys, and the `tapvid` command card vs CPU."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from multi_spatialmllm_tpu_torch.core.synthetic import make_tapvid_npz
    from multi_spatialmllm_tpu_torch.engines import object_movement as OM

    out = {"codec": codec_check(card)}
    t0 = time.perf_counter()
    real = make_tapvid_npz(**M5_REAL)
    log(f"  real-scale stand-in record made in {time.perf_counter() - t0:.1f}"
        f" s: {len(real['images_jpeg_bytes'])} frames of 512 x 512, "
        f"tracks {list(real['tracks_XYZ'].shape)}; {card}")
    out["m5"] = m5_realscale(torch, np, OM, real, card)
    torch.cuda.empty_cache()
    rates = {}

    def rate(key, n, times):
        per = [n / t for t in times]
        rates[key] = median(per)
        log(f"  {key}: {n} samples a pass, median {rates[key]:,.1f} "
            f"samples/s ({[round(r, 1) for r in per]}); {card}")

    cfg = OM.ObjectMovementConfig(**OM_CONFIG)
    dot_cfg = dataclasses.replace(cfg, dot_variant=True)
    with tempfile.TemporaryDirectory() as tmp:
        records = {f"seq{i}": make_tapvid_npz(seed=i, **OM_RECORD)
                   for i in range(OM_RECORDS)}
        OM.generate_to_jsonl(records, os.path.join(tmp, "om_w.jsonl"), cfg,
                             device="cuda")
        times, res = timed_passes(lambda k: OM.generate_to_jsonl(
            records, os.path.join(tmp, f"om{k}.jsonl"), cfg, device="cuda"))
        rate("object_movement_coord", res.n_train, times)
        t0 = time.perf_counter()
        for rec in records.values():
            OM.cumulative_loss(rec["tracks_XYZ"], "cuda")
        m5_s = time.perf_counter() - t0
        out["m5_share_coord"] = m5_s / median(times)
        log(f"  M5 over the {OM_RECORDS} records (upload, device program and "
            f"fetch; host clock): {m5_s:.4f} s, "
            f"{out['m5_share_coord']:.1%} of a coord pass; {card}")

        def dot_pass(k):
            img_dir = os.path.join(tmp, f"omd_img{k}")
            t0 = time.perf_counter()
            res = OM.generate_to_jsonl(
                records, os.path.join(tmp, f"omd{k}.jsonl"), dot_cfg,
                img_output_dir=img_dir, device="cuda")
            dt = time.perf_counter() - t0
            shutil.rmtree(img_dir)
            return res, dt

        dot_pass("w")
        passes = [dot_pass(k) for k in range(STAGE_PASSES)]
        rate("object_movement_dot", passes[-1][0].n_train,
             [dt for _, dt in passes])
        for key, c, img_dir in (("coord", cfg, None),
                                ("dot", dot_cfg, os.path.join(tmp, "real"))):
            t0 = time.perf_counter()
            res = OM.generate_to_jsonl({"real0": real},
                                       os.path.join(tmp, f"real_{key}.jsonl"),
                                       c, img_output_dir=img_dir,
                                       device="cuda")
            dt = time.perf_counter() - t0
            rates[f"object_movement_{key}_realscale"] = res.n_train / dt
            log(f"  object_movement_{key} on the real-scale record: "
                f"{res.n_train} samples in {dt:.3f} s, "
                f"{res.n_train / dt:,.1f} samples/s; {card}")
        out["tapvid_files"] = tapvid_card_vs_cpu(
            cli, make_tapvid_npz, os.path.join(tmp, "tapvid"), card)
    out["rates"] = rates
    return out


# --------------------------------------------------------------------------
# Phase 18: real inputs on the card without cv2 (the ingest commands, the
# sharded coverage command, frames read from disk for `serve`)
# --------------------------------------------------------------------------

REAL_SKIP = 5            # ScanNet's D5: 1,480 .sens frames for 296 images
EXPORT_PASSES = 2        # bench.py's ingest_l1: two timed export passes
PIPELINE_STAGES = ("visibility", "frame_relations", "object_visibility",
                   "coverage", "run_camera_movement", "run_depth_perception",
                   "run_visual_correspondence", "run_object_perception")
SERVE_FLAGS = ["--config", "tiny", "--vocab-size", "800",
               "--max-new-tokens", "8", "--slots", "2", "--page-size", "16",
               "--num-pages", "96", "--max-prompt-len", "512"]


def ingest_golden():
    """scripts/gen_ingest_golden.py: the phase's inputs, digest functions
    and the stored file (made with the JAX package and cv2)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "gen_ingest_golden.py")
    spec = importlib.util.spec_from_file_location("gen_ingest_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def png_gate(what, bytes_equal, pixels_equal, stored_zlib):
    """PNG bytes equal the JAX digest, or, where this machine's zlib is
    another version than the one that made the digests (the deflate
    stream may differ), the pixels do. Returns how the gate held."""
    import zlib

    if bytes_equal:
        return "bytes"
    if zlib.ZLIB_RUNTIME_VERSION != stored_zlib and pixels_equal:
        log(f"  {what}: PNG bytes differ from cv2's under zlib "
            f"{zlib.ZLIB_RUNTIME_VERSION} (digests made with {stored_zlib}); "
            f"pixels equal")
        return "pixels"
    fail(f"{what}: PNG files differ from the JAX digests")


def export_check(G, stored, tmp, card):
    """(a) bench.py's ingest_l1: export_posed_images and build_images_info
    at frame_skip 1 over 300 frames of 480 x 640, their rates, and the
    written files and images_info against the JAX digests."""
    from multi_spatialmllm_tpu_torch.ingest.posed_images import (
        build_images_info,
    )
    from multi_spatialmllm_tpu_torch.ingest.sens import export_posed_images

    os.makedirs(tmp)
    t0 = time.perf_counter()
    sens = G.port_export_sens(tmp)
    log(f"  make_synthetic_sens ({G.EXPORT}): {time.perf_counter() - t0:.1f}"
        f" s, {os.path.getsize(sens) / 1e6:.1f} MB")
    export_posed_images(sens, os.path.join(tmp, "warm"), frame_skip=10)
    rates, dirs = [], []
    for p in range(EXPORT_PASSES):
        dirs.append(os.path.join(tmp, f"posed{p}", G.EXPORT_DIR))
        t0 = time.perf_counter()
        n = export_posed_images(sens, dirs[-1], frame_skip=1)
        rates.append(n / (time.perf_counter() - t0))
    out = {"ingest_sens_export": median(rates)}
    log(f"  ingest_sens_export: {n} frames a pass (jpeg copy, 16-bit PNG, "
        f"pose), median {out['ingest_sens_export']:,.1f} frames/s "
        f"({[round(r, 1) for r in rates]}); {card}")
    build_images_info(dirs[0], frame_skip=1)
    rates = []
    for _ in range(STAGE_PASSES):
        t0 = time.perf_counter()
        info = build_images_info(dirs[0], frame_skip=1)
        rates.append(info["num_posed_images"] / (time.perf_counter() - t0))
    out["ingest_info_update"] = median(rates)
    log(f"  ingest_info_update: {info['num_posed_images']} frames, median "
        f"{out['ingest_info_update']:,.1f} frames/s "
        f"({[round(r, 1) for r in rates]}); {card}")
    got = G.port_export_digests(dirs[0], n)
    want = stored["export"]
    for key in ("frames", "jpg", "txt", "images_info"):
        if got[key] != want[key]:
            fail(f"export: {key} differs from the JAX digest")
    out["png_gate"] = png_gate("export", got["png"] == want["png"],
                               got["png_pixels"] == want["png_pixels"],
                               stored["zlib"])
    log(f"  export: the {n} JPEGs, pose texts and images_info equal the JAX "
        f"package's by digest, the PNGs by {out['png_gate']}")
    return out


def check_pack(np, got, scene):
    """The ingested pack against the scene it was written from: depth bit
    for bit, poses, intrinsics and unaligned points at float32, instance
    ids, categories and image size equal, aligned points and boxes within
    float32 rounding (1e-5 m)."""
    def f32(a):
        return np.asarray(a, np.float32).astype(np.float64)

    checks = {
        "depth": np.array_equal(got.depth_maps, scene.depth_maps),
        "poses": np.array_equal(got.extrinsics, f32(scene.extrinsics)),
        "intrinsic": np.array_equal(got.intrinsic, f32(scene.intrinsic)),
        "unaligned points": np.array_equal(got.points_unaligned[:, :3],
                                           f32(scene.points_unaligned)),
        "instance ids": np.array_equal(got.instance_ids, scene.instance_ids),
        "categories": got.categories == scene.categories,
        "image size": tuple(got.image_hw) == tuple(scene.image_hw),
        "aligned points": np.allclose(got.points_aligned[:, :3],
                                      scene.points_aligned, rtol=0,
                                      atol=1e-5),
        "boxes": all(np.allclose(a, b, rtol=0, atol=1e-5) for a, b in (
            (got.aligned_bboxes, scene.aligned_bboxes),
            (got.unaligned_bboxes, scene.unaligned_bboxes)))}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"the ingested scene differs from its source in: {bad}")
    return list(checks)


class StageClock:
    """Host seconds of each outermost call of the pipeline's stage and
    engine methods while it is entered (where a `run_all` spends its
    time; a stage reached from inside another is counted in that one)."""

    def __init__(self, cls):
        self.cls, self.seconds, self._depth, self._saved = cls, {}, 0, {}

    def __enter__(self):
        for name in PIPELINE_STAGES:
            self._saved[name] = fn = getattr(self.cls, name)
            setattr(self.cls, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if self._depth == 0:
                    self.seconds[name] = (self.seconds.get(name, 0.0)
                                          + time.perf_counter() - t0)
        return run

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.cls, name, fn)


def realscale_ingest(torch, np, cli, tmp, card):
    """(b) the real-scale scene written as a scan (1,480 .sens frames),
    `ingest-scannet`, `ingest-sens --frame-skip 5`, then `pipeline` on the
    card; each timed by the host clock, the L3 stages also by their
    events."""
    from multi_spatialmllm_tpu_torch.core.scene import Scene
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.ingest.synthetic_scan import write_scan
    from multi_spatialmllm_tpu_torch.pipeline import SpatialEnginePipeline

    out = {}
    scene = make_scene(**{**REAL_SCENE, "scene_id": "scene0707_00"})
    scans = os.path.join(tmp, "scans")
    t0 = time.perf_counter()
    write_scan(scans, scene, frame_skip=REAL_SKIP)
    out["write_s"] = time.perf_counter() - t0
    sens = os.path.join(scans, scene.scene_id, f"{scene.scene_id}.sens")
    log(f"  real-scale scan written in {out['write_s']:.1f} s: "
        f"{len(scene.image_ids) * REAL_SKIP} .sens frames "
        f"({os.path.getsize(sens) / 1e6:,.1f} MB), "
        f"{len(scene.points_unaligned):,} vertices, "
        f"{len(scene.categories)} objects")

    def timed(key, argv):
        t0 = time.perf_counter()
        cli.main(argv)
        out[key] = time.perf_counter() - t0
        log(f"  {' '.join(os.path.basename(a) for a in argv)}: "
            f"{out[key]:.2f} s (host clock); {card}")

    timed("ingest_scannet_s", ["ingest-scannet", "--scans", scans,
                               "--output", os.path.join(tmp, "exp"),
                               "--device", "cuda"])
    timed("ingest_sens_s", ["ingest-sens", "--scans", scans, "--frame-skip",
                            str(REAL_SKIP), "--output",
                            os.path.join(tmp, "packs"), "--device", "cuda"])
    got = Scene.load_npz(os.path.join(tmp, "packs",
                                      f"{scene.scene_id}.npz"))
    held = check_pack(np, got, scene)
    log(f"  the ingested pack equals its source ({', '.join(held)}; "
        f"{got.depth_maps.shape[0]} images)")
    del got
    run = os.path.join(tmp, "run")
    with StageClock(SpatialEnginePipeline) as clock:
        timed("pipeline_s", ["pipeline", "--scenes",
                             os.path.join(tmp, "packs"), "--output", run,
                             "--device", "cuda"])
    out["stages_s"] = clock.seconds
    log("  where the pipeline's seconds go (host clock, outermost calls): "
        + ", ".join(f"{k} {v:.2f}" for k, v in clock.seconds.items()))
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    for e in events:
        if e.get("kind") == "summary":
            out[f"{e['stage']}_s"] = e["elapsed_s"]
    log(f"  L3 stages by their events: visibility "
        f"{out.get('visibility_s')} s, frame relations "
        f"{out.get('frame_relations_s')} s")
    n_jsonl = sum(f.endswith(".jsonl") for _, _, fs in os.walk(
        os.path.join(run, "qa")) for f in fs)
    if not n_jsonl:
        fail("the real-scale pipeline wrote no JSONL")
    out["jsonl"] = n_jsonl
    return out


def tree_bytes(root, keep):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs if keep(f)}


def small_card_vs_cpu(G, stored, cli, tmp, card):
    """(c) two small scans through ingest-scannet, ingest-sens, coverage
    (2 shards, --merge, and unsharded) and pipeline, on the card and on
    the CPU: every pickle, npz, npy and JSONL (and annotated JPEG)
    byte-equal; the merged coverage equal to the unsharded run; the packs,
    scenes_info and merged coverage equal to the JAX digests."""
    scans = os.path.join(tmp, "scans")
    G.small_scans(scans)
    roots = {}
    for dev in ("cuda", "cpu"):
        root = roots[dev] = os.path.join(tmp, f"small_{dev}")
        t0 = time.perf_counter()
        for cmd in G.small_commands(scans, root):
            cli.main([*cmd, "--device", dev])
        cli.main(["coverage", "--scenes", os.path.join(root, "packs"),
                  "--output", os.path.join(root, "whole"), "--device", dev])
        cli.main(["pipeline", "--scenes", os.path.join(root, "packs"),
                  "--output", os.path.join(root, "run"), "--device", dev])
        log(f"  small run on {dev}: {time.perf_counter() - t0:.2f} s")
    keep = (".pkl", ".npz", ".npy", ".jsonl", ".jpg", ".json")
    files = {}
    for dev, root in roots.items():
        files[dev] = {}
        for sub in ("exp", "packs", "cov", "whole",
                    os.path.join("run", "qa"), os.path.join("run", "indices")):
            files[dev].update({os.path.join(sub, k): v for k, v in tree_bytes(
                os.path.join(root, sub), lambda f: f.endswith(keep)).items()})
    if sorted(files["cuda"]) != sorted(files["cpu"]) or not files["cpu"]:
        fail(f"small run: different files card vs CPU: "
             f"{sorted(set(files['cuda']) ^ set(files['cpu']))[:5]}")
    for rel, path in files["cpu"].items():
        with open(files["cuda"][rel], "rb") as f, open(path, "rb") as g:
            if f.read() != g.read():
                fail(f"small run: {rel} differs card vs CPU")
    for dim in ("height", "length", "width"):
        merged = G.pickle_sha(os.path.join(
            roots["cuda"], "cov", f"merged_train_object_coverage_{dim}.pkl"))
        whole = G.pickle_sha(os.path.join(
            roots["cuda"], "whole",
            f"train_object_coverage_{dim}_shard000of001.pkl"))
        if merged != whole:
            fail(f"coverage {dim}: the merged shards differ from an "
                 f"unsharded run")
    got = G.small_digests(roots["cuda"])
    bad = [k for k, v in stored["small"].items() if got.get(k) != v]
    if bad:
        fail(f"small run: {bad} differ from the JAX digests")
    kinds = {}
    for rel in files["cpu"]:
        ext = rel.rsplit(".", 1)[-1]
        kinds[ext] = kinds.get(ext, 0) + 1
    log(f"  small run card vs CPU: {len(files['cpu'])} files byte-equal "
        f"({kinds}); merged coverage == unsharded; packs, scenes_info and "
        f"merged coverage == the JAX digests; {card}")
    return len(files["cpu"])


def frames_and_serve(torch, np, G, stored, cli, tmp, card, kernels):
    """(d) 968 x 1296 and 640 x 480 frames written as JPEG and PNG:
    tile_image's tiles of each equal the digests of cv2's; then `serve`
    at the tiny config in float32 (as phase 5) with request lines naming
    those files, on the card and on the CPU: the same greedy tokens, and
    each of `kernels` launched on the card's run; every frame read tiled
    by one launch of tile_frame on the card and in numpy on the CPU.
    Returns the launches."""
    import argparse
    import contextlib
    import io

    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.models import preprocess as PP
    from multi_spatialmllm_tpu_torch.ops import tile_frames as TF

    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    got = G.port_tiles(frames)
    for name, want in stored["tiles"].items():
        for key, v in want.items():
            if key == "file" and name.endswith(".png"):
                png_gate(name, got[name][key] == v,
                         got[name]["pixels"] == want["pixels"],
                         stored["zlib"])
            elif got[name][key] != v:
                fail(f"frames: {name} {key} differs from cv2's digest")
    log(f"  frames: {len(got)} files read as cv2.imread does and tiled "
        f"({', '.join(G.TILE_SIZES)} tiles) equal to cv2's by digest")
    names = sorted(got)
    lines = [json.dumps({"id": f"img{i}", "image": [n],
                         "text": "<image>\nHow far is the chair?"})
             for i, n in enumerate(names)]
    lines.append(json.dumps({"id": "pair", "image": names[:2],
                             "text": "<image>\n<image>\nHow did the "
                                     "camera move?"}))
    tiny = M.CONFIGS["tiny"]
    M.CONFIGS["tiny"] = lambda: M.with_dtype(tiny(), "float32")
    try:
        cfg = cli._config(argparse.Namespace(config="tiny", vocab_size=800))
        model = M.MultiFrameMLLM(cfg)
        M.init_random_weights(model, SEED)
        ckpt = os.path.join(tmp, "tiny.pt")
        torch.save(model.state_dict(), ckpt)
        tokens, tiled = {}, {}
        n_frames = sum(len(json.loads(ln)["image"]) for ln in lines)
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                for k in kernels:
                    k.launches = 0
            card0, host0 = TF.TILE_FRAME.launches, PP.HOST_TILED.frames
            stdin, buf = sys.stdin, io.StringIO()
            sys.stdin = io.StringIO("".join(ln + "\n" for ln in lines))
            try:
                with contextlib.redirect_stdout(buf):
                    cli.main(["serve", "--checkpoint", ckpt, "--device", dev,
                              "--images-root", frames, *SERVE_FLAGS])
            finally:
                sys.stdin = stdin
            tiled[dev] = (TF.TILE_FRAME.launches - card0,
                          PP.HOST_TILED.frames - host0)
            if dev == "cuda":
                launches = {k.name: k.launches for k in kernels}
            res = [json.loads(ln) for ln in buf.getvalue().splitlines()]
            errors = [r for r in res if "error" in r]
            if errors or len(res) != len(lines):
                fail(f"serve on {dev}: {errors[:2] or len(res)}")
            tokens[dev] = {r["id"]: r["token_ids"] for r in res}
    finally:
        M.CONFIGS["tiny"] = tiny
    if tokens["cuda"] != tokens["cpu"]:
        diff = [k for k in tokens["cpu"] if tokens["cuda"][k] != tokens["cpu"][k]]
        fail(f"serve on frames from disk: greedy tokens differ card vs CPU "
             f"for {diff}")
    if min(launches.values()) <= 0:
        fail(f"a kernel never launched on the frames' serve path: {launches}")
    if tiled != {"cuda": (n_frames, 0), "cpu": (0, n_frames)}:
        fail(f"serve on frames from disk: {n_frames} frames read, tiled "
             f"(on the card, in numpy) {tiled}")
    n_tok = sum(len(t) for t in tokens["cpu"].values())
    log(f"  serve (tiny f32) on {len(lines)} requests naming those files: "
        f"{n_tok} greedy tokens equal card vs CPU; launches {launches}; "
        f"{n_frames} frames read, tiled by tile_frame on the card and in "
        f"numpy on the CPU; {card}")
    return launches


def phase_real_inputs(torch, cli, card, kernels):
    """Phase 18: the ingest export and info update at bench.py's
    configuration, the real-scale scan through ingest-scannet, ingest-sens
    and pipeline on the card, the small runs card vs CPU and against the
    JAX digests, and serve on frames read from disk."""
    import tempfile
    import zlib

    import numpy as np

    from multi_spatialmllm_tpu_torch.ingest import native

    if not native.native_available():
        fail(f"the native library did not build: {native.build_error}")
    G = ingest_golden()
    with open(G.OUT) as f:
        stored = json.load(f)
    log(f"  zlib {zlib.ZLIB_RUNTIME_VERSION} (the JAX digests were made with "
        f"{stored['zlib']}, cv2 {stored['cv2']}); numpy {np.__version__}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["export"] = export_check(G, stored, os.path.join(tmp, "a"), card)
        out["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["real"] = realscale_ingest(torch, np, cli, os.path.join(tmp, "b"),
                                       card)
        out["real_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["small_files"] = small_card_vs_cpu(G, stored, cli,
                                               os.path.join(tmp, "c"), card)
        out["small_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serve"] = frames_and_serve(torch, np, G, stored, cli,
                                        os.path.join(tmp, "d"), card, kernels)
        out["frames_s"] = time.perf_counter() - t0
    log(f"  phase 18 parts: export {out['export_s']:.1f} s, real-scale "
        f"{out['real_s']:.1f} s, small {out['small_s']:.1f} s, frames and "
        f"serve {out['frames_s']:.1f} s")
    out["rates"] = {k: out["export"][k] for k in ("ingest_sens_export",
                                                  "ingest_info_update")}
    return out


# phase 19: the eval command. (a) tiny float32 card vs CPU on a small
# campaign; (b) the flagship in bf16 on the eval data of a pipeline run:
# --max-tiles 6 (the CLI's default) makes a 240 x 320 frame 7 tiles of 256
# tokens, so a two-frame prompt takes ~3,700 tokens: --max-prompt-len 4096
EVAL_TILES, EVAL_PROMPT = 6, 4096
EVAL_LIMIT = 3            # records a file of the pipeline's eval data
# (b): the flagship's LLM and ViT cut from 32 and 24 layers, for time
EVAL_LAYERS, EVAL_VIT_LAYERS = 8, 6
EVAL_CHUNK, EVAL_VISION, EVAL_SPECULATE = 1024, 8, 4
EVAL_SCORE_ATOL = 1e-5    # option scores and logprobs, card vs CPU (f32)
TINY_PAGED = ["--paged", "--slots", "2", "--page-size", "16", "--num-pages",
              "64", "--max-prompt-len", "128"]
TINY_EVAL_FLAGS = {
    "batch1": ["--batch-size", "1"], "batch4": ["--batch-size", "4"],
    "speculate": ["--speculate", "3"], "mc_logprob": ["--mc-logprob"],
    "prefix_cache": TINY_PAGED + ["--prefix-cache"],
    "prefill_chunk": TINY_PAGED + ["--prefill-chunk", "16"],
    "vision_cache": TINY_PAGED + ["--prefill-chunk", "16", "--vision-cache",
                                  "2"],
    "paged_speculate": TINY_PAGED + ["--speculate", "3"],
    "int8_kv": TINY_PAGED + ["--kv-dtype", "int8"],
    "logprobs": TINY_PAGED + ["--logprobs"],
    "quantize_weights": TINY_PAGED + ["--quantize-weights"]}
# serve --sampling card vs CPU: (seed, temperature, top_p) a request
SAMPLED = [(0, 0.7, 1.0), (1, 1.0, 0.8), (7, 1.3, 1.0), (2**31 - 1, 0.5, 1.0)]


def tiny_eval_campaign(np, root):
    """Two 96 x 128 JPEG frames (the port's codec) and eight records over
    them: three questions a frame sharing a long stem, and one
    multiple-choice record a frame over both. Returns the JSONL path."""
    from multi_spatialmllm_tpu_torch.ingest.jpeg import imwrite

    os.makedirs(os.path.join(root, "imgs"))
    rng = np.random.default_rng(SEED + 4)
    for i in range(2):
        imwrite(os.path.join(root, "imgs", f"{i}.jpg"),
                rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
    stem = ("These are two views of one indoor scene and every distance in "
            "your answer must be reported in millimeters. ")
    recs = []
    for i in range(2):
        recs += [{"id": f"{i}-{q}", "image": [f"{i}.jpg"],
                  "text": f"<image>\n{stem}Question variant {q} here?",
                  "question_type": "depth_estimation_coor", "gt_value": 900}
                 for q in range(3)]
        recs.append({"id": f"{i}-mc", "image": [f"{i}.jpg", f"{1 - i}.jpg"],
                     "text": "<image>\n<image>\nWhich point corresponds?",
                     "question_type": "visual_correspondence_multiple_choice",
                     "gt_value": "A"})
    path = os.path.join(root, "eval.jsonl")
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs))
    return path, recs


def cli_run(cli, argv, stdin="", err=None):
    """`cli.main(argv)` -> its stdout lines (stdin from a string; stderr
    into `err`, a text stream, when given)."""
    import io

    saved, buf = sys.stdin, io.StringIO()
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(buf), (
                contextlib.redirect_stderr(err) if err is not None
                else contextlib.nullcontext()):
            cli.main(argv)
    finally:
        sys.stdin = saved
    return buf.getvalue().splitlines()


def eval_tiny_card_vs_cpu(torch, np, cli, M, tok, tmp, card):
    """(a) tiny float32: `eval` for each flag set of TINY_EVAL_FLAGS on the
    card and on the CPU (the --output files equal; with --logprobs the
    predictions equal and the confidences within EVAL_SCORE_ATOL), the
    option scores card vs CPU, and `serve --sampling` tokens card vs
    CPU."""
    import argparse

    from multi_spatialmllm_tpu_torch.models import runner as R
    from multi_spatialmllm_tpu_torch.models.data import DataConfig
    from multi_spatialmllm_tpu_torch.models.preprocess import PreprocessConfig

    jsonl, recs = tiny_eval_campaign(np, tmp)
    tiny = M.CONFIGS["tiny"]
    M.CONFIGS["tiny"] = lambda: M.with_dtype(tiny(), "float32")
    try:
        cfg = cli._config(argparse.Namespace(config="tiny",
                                             vocab_size=tok.vocab_size))
        models = {}
        for dev in ("cpu", "cuda"):
            models[dev] = M.MultiFrameMLLM(cfg, device=dev)
            if dev == "cpu":
                M.init_random_weights(models[dev], SEED)
            else:
                models[dev].load_state_dict(models["cpu"].state_dict())
            models[dev].eval()
        ckpt = os.path.join(tmp, "tiny.pt")
        torch.save(models["cpu"].state_dict(), ckpt)
        common = ["--checkpoint", ckpt, "--config", "tiny", "--vocab-size",
                  str(tok.vocab_size), "--images-root",
                  os.path.join(tmp, "imgs"), "--max-tiles", "1",
                  "--max-new-tokens", "6"]
        for name, flags in TINY_EVAL_FLAGS.items():
            outs = {}
            for dev in ("cuda", "cpu"):
                out = os.path.join(tmp, f"{name}_{dev}.json")
                cli_run(cli, ["eval", *common, "--eval-jsonl", jsonl,
                              "--output", out, "--device", dev, *flags])
                with open(out) as f:
                    outs[dev] = f.read()
            if name == "logprobs":
                a, b = json.loads(outs["cuda"]), json.loads(outs["cpu"])
                ca, cb = a.pop("confidences"), b.pop("confidences")
                a.pop("mean_token_logprob"), b.pop("mean_token_logprob")
                if a != b or max(abs(x - y) for x, y in zip(ca, cb)
                                 if x is not None) > EVAL_SCORE_ATOL:
                    fail(f"tiny eval {name}: card {a} {ca} vs CPU {b} {cb}")
            elif outs["cuda"] != outs["cpu"]:
                fail(f"tiny eval {name}: the report differs card vs CPU:\n"
                     f"{outs['cuda'][:400]}\n{outs['cpu'][:400]}")
        log(f"  (a) tiny f32 eval on {len(recs)} records: --output report "
            f"equal card vs CPU for {', '.join(TINY_EVAL_FLAGS)}")
        run_cfg = R.EvalRunConfig(max_new_tokens=6, data=DataConfig(
            preprocess=PreprocessConfig(tile_size=cfg.vit.image_size,
                                        max_tiles=1, resize_hw=None)))

        def load(path):
            return cli._read_image(os.path.join(tmp, "imgs", path))

        worst = 0.0
        for rec in recs:
            cands = R.mc_candidates(rec)
            if cands is None:
                continue
            s = {dev: R.score_candidates(models[dev], tok, rec, cands, load,
                                         run_cfg) for dev in models}
            worst = max(worst, float(np.abs(s["cuda"] - s["cpu"]).max()))
        if worst > EVAL_SCORE_ATOL:
            fail(f"option scores differ card vs CPU by {worst:.3e}")
        lines = "".join(json.dumps({
            "id": f"s{i}", "image": [f"{i % 2}.jpg"], "seed": seed,
            "temperature": temp, "top_p": top_p,
            "text": "<image>\nHow far is the chair?"}) + "\n"
            for i, (seed, temp, top_p) in enumerate(SAMPLED))
        tokens = {}
        for dev in ("cuda", "cpu"):
            res = [json.loads(ln) for ln in cli_run(
                cli, ["serve", *common, *TINY_PAGED[1:], "--sampling",
                      "--max-new-tokens", "12", "--device", dev], lines)]
            if any("error" in r for r in res) or len(res) != len(SAMPLED):
                fail(f"serve --sampling on {dev}: {res[:2]}")
            tokens[dev] = {r["id"]: r["token_ids"] for r in res}
        if tokens["cuda"] != tokens["cpu"]:
            fail(f"serve --sampling tokens differ card vs CPU: {tokens}")
    finally:
        M.CONFIGS["tiny"] = tiny
    log(f"  (a) option scores card vs CPU within {worst:.2e}; serve "
        f"--sampling, {len(SAMPLED)} seeds and temperatures (top_p 0.8 in "
        f"one): {sum(len(t) for t in tokens['cpu'].values())} tokens equal "
        f"card vs CPU; {card}")


def pipeline_eval_data(cli, tmp):
    """Phase 18's two small scans through `ingest-sens` and `pipeline` on
    the card, and their frames exported (every frame, numbered as the
    records name them) into one images directory beside the engines'
    annotated images. Returns (the evaluation_data dir, the images dir,
    the records `--limit EVAL_LIMIT` evaluates in the eval command's
    order, each with its place in its file); every record's images must
    resolve."""
    import contextlib
    import io
    import shutil

    from multi_spatialmllm_tpu_torch.ingest.sens import export_posed_images

    G = ingest_golden()
    scans = os.path.join(tmp, "scans")
    G.small_scans(scans)
    packs, run = os.path.join(tmp, "packs"), os.path.join(tmp, "run")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["ingest-sens", "--scans", scans, "--frame-skip",
                  str(G.SMALL_SKIP), "--output", packs, "--device", "cuda"])
        cli.main(["pipeline", "--scenes", packs, "--output", run,
                  "--device", "cuda"])
    images = os.path.join(tmp, "images")
    for scan in sorted(os.listdir(scans)):
        export_posed_images(os.path.join(scans, scan, f"{scan}.sens"),
                            os.path.join(images, scan), frame_skip=1)
    root = os.path.join(run, "qa", "evaluation_data")
    records = []
    for engine in sorted(os.listdir(root)):
        edir = os.path.join(root, engine)
        if os.path.isdir(os.path.join(edir, "images")):
            shutil.copytree(os.path.join(edir, "images"), images,
                            dirs_exist_ok=True)
        for fn in sorted(os.listdir(edir)):
            if fn.endswith(".jsonl") and not fn.endswith("_orig.jsonl"):
                with open(os.path.join(edir, fn)) as f:
                    rows = [json.loads(ln) for ln in f if ln.strip()]
                records += list(enumerate(rows[:EVAL_LIMIT]))
    missing = [p for _, r in records for p in r["image"]
               if not os.path.exists(os.path.join(images, p))]
    if missing:
        fail(f"eval records name missing frames: {missing[:4]}")
    return root, images, records


def flagship_eval_run(torch, cli, K, R, model, tok, argv, kernels, label):
    """One `eval` of `model` (cli.eval_report, the command's own code
    after the checkpoint load) with `argv`; every record predicted and
    every logprob finite. Returns its numbers and launches. On the paged
    path a campaign's requests arrive when its `generate_all` starts
    (after the runner has read, tiled and tokenised all of them: `prep_s`,
    summed over campaigns); a request's time to first token runs from
    there to the return of its prefill. All times here are host clock."""
    import math

    args = cli.build_parser().parse_args(["eval", "--checkpoint", "-",
                                          *argv])
    for k in kernels:
        k.launches = 0
    firsts, prep, sizes = [], [], []
    called, arrival = [0.0], [0.0]
    prefill = K.PagedBatcher._prefill_into
    generate_all = K.PagedBatcher.generate_all
    predict = R.predict_with_batcher

    def timed_predict(*a, **kw):
        called[0] = time.perf_counter()
        return predict(*a, **kw)

    def timed_generate_all(self, requests):
        arrival[0] = time.perf_counter()
        prep.append(arrival[0] - called[0])
        sizes.append(len(requests))
        return generate_all(self, requests)

    def timed_prefill(self, *a, **kw):
        got = prefill(self, *a, **kw)
        if got is not None:
            firsts.append(time.perf_counter() - arrival[0])
        return got

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.PagedBatcher._prefill_into = timed_prefill
    K.PagedBatcher.generate_all = timed_generate_all
    R.predict_with_batcher = timed_predict
    t0 = time.perf_counter()
    try:
        report, preds, batcher = cli.eval_report(model, tok, args)
        torch.cuda.synchronize()
    finally:
        K.PagedBatcher._prefill_into = prefill
        K.PagedBatcher.generate_all = generate_all
        R.predict_with_batcher = predict
    wall = time.perf_counter() - t0
    flat = [p for name in sorted(preds) for p in preds[name]]
    if len(flat) != report["count"] or any(p is None for p in flat):
        fail(f"{label}: {len(flat)} predictions for {report['count']} "
             f"records")
    confs = [c for r in report["engines"].values()
             for c in r.get("confidences", []) if c is not None]
    if any(not math.isfinite(c) for c in confs):
        fail(f"{label}: a non-finite logprob")
    out = {"records": len(flat), "wall_s": wall,
           "records_per_s": len(flat) / wall, "predictions": flat,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k.name: k.launches for k in kernels},
           "accuracy": report["accuracy"], "n_logprobs": len(confs)}
    if batcher is not None:
        st, pc = batcher.stats, batcher.config
        firsts.sort()
        # one step (or, speculating, one verify iteration) of every slot
        per_step = 1e3 * st["decode_seconds"] / max(
            1, st["decode_dispatches"] * pc.chunk)
        out.update(
            campaigns=len(sizes), campaign_records=sizes, slots=pc.slots,
            prep_s=sum(prep), prefill_s=st["prefill_seconds"],
            decode_s=st["decode_seconds"],
            ttft_mean_s=sum(firsts) / len(firsts),
            ttft_median_s=firsts[len(firsts) // 2], ttft_max_s=firsts[-1],
            decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
            prefill_resumed=st["prefill_resumed"],
            pages_reused=st["pages_reused"], vision_hits=st["vision_hits"],
            spec_tokens_per_verify=(st["decode_tokens"] / st["spec_verifies"]
                                    if st["spec_verifies"] else None),
            **({"verify_iteration_ms": per_step} if pc.speculate
               else {"decode_step_ms": per_step}))
    shown = {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in out.items() if k != "predictions"}
    log(f"  {label}: {json.dumps(shown)}")
    return out


@contextlib.contextmanager
def k1_operands(A, R, llm_cfg):
    """While the block runs, keep the first K1 operands of the language
    model (its heads and head dim) with more than one row (a batched
    prefill of right-padded prompts), and the first inside
    `score_candidates`; yields them by label."""
    got, scoring = {}, [False]
    fwd, score = A.flash_attention_fwd_cuda, R.score_candidates

    def keep(q, k, v, causal, segment_ids=None):
        label = ("score_candidates" if scoring[0] else
                 "batched prefill" if q.shape[0] > 1 else None)
        if label and label not in got and q.shape[1] == llm_cfg.num_heads \
                and q.shape[-1] == llm_cfg.head_dim:
            got[label] = (q.clone(), k.clone(), v.clone(), causal,
                          None if segment_ids is None
                          else segment_ids.clone())
        return fwd(q, k, v, causal, segment_ids)

    def scored(*a, **kw):
        scoring[0] = True
        try:
            return score(*a, **kw)
        finally:
            scoring[0] = False

    A.flash_attention_fwd_cuda, R.score_candidates = keep, scored
    try:
        yield got
    finally:
        A.flash_attention_fwd_cuda, R.score_candidates = fwd, score


def k1_on_operands(torch, A, got):
    """K1 against its plain version on operands an eval path gave it
    (`k1_operands`): the plain version on float32 copies is the answer,
    the plain version on the bf16 values the yardstick of the per-64-row
    tile rule (`verdict`), each a batch row at a time. K1_BF16_ATOL is for
    unit-normal v, so max|err| is held to it times max|v| (o mixes v's
    rows). Returns the largest max|err|."""
    worst = 0.0
    for label, (q, k, v, causal, seg) in got.items():
        o, lse = A.flash_attention_fwd_cuda(q, k, v, causal, seg)
        refs, lses, plains = [], [], []
        for b in range(q.shape[0]):
            r = slice(b, b + 1)
            sg = None if seg is None else seg[r]
            o_ref, lse_ref = A.flash_attention_fwd_plain(
                q[r].float(), k[r].float(), v[r].float(), causal, sg)
            refs.append(o_ref)
            lses.append(lse_ref)
            plains.append(A.flash_attention_fwd_plain(q[r], k[r], v[r],
                                                      causal, sg)[0])
        torch.cuda.synchronize()
        tol = K1_BF16_ATOL * max(1.0, v.float().abs().max().item())
        ok, err, text = verdict(o, torch.cat(refs), tol, torch.cat(plains))
        err_lse = (lse - torch.cat(lses)).abs().max().item()
        ok = ok and err_lse <= K1_LSE_ATOL
        log(f"  K1 on the {label} operands, q {tuple(q.shape)} kv "
            f"{tuple(k.shape)}: o {text}; lse max|err| {err_lse:.3e} (atol "
            f"{K1_LSE_ATOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_fwd disagrees with its plain version on the "
                 f"{label} operands")
        worst = max(worst, err)
        del refs, lses, plains, o, lse
    return worst


def agreement(got, ref, scored):
    """Records of `got` (a list, or a dict by record index) outside
    `scored` whose prediction equals the reference's."""
    got = dict(enumerate(got)) if isinstance(got, list) else got
    idx = [i for i in got if i not in scored]
    return sum(got[i] == ref[i] for i in idx), len(idx)


def phase_eval(torch, cli, M, K, tok, card, kernels):
    """Phase 19: (a) tiny card vs CPU, (b) the flagship in bf16 on a
    pipeline run's eval data, (c) the bench MoE with int8 kv. Returns the
    launches on the eval_paged, eval_batched and moe_eval paths, and K1's
    largest max|err| on the batched path's operands."""
    import tempfile

    import numpy as np

    from multi_spatialmllm_tpu_torch.models import quantize as Q
    from multi_spatialmllm_tpu_torch.models import runner as R
    from multi_spatialmllm_tpu_torch.models import serving as S
    from multi_spatialmllm_tpu_torch.ops import attention as A

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        eval_tiny_card_vs_cpu(torch, np, cli, M, tok,
                              os.path.join(tmp, "a"), card)
        out["tiny_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        root, images, records = pipeline_eval_data(cli,
                                                   os.path.join(tmp, "b"))
        # the eval command reads the engines in sorted order, as `records`
        scored = {i for i, (_, r) in enumerate(records)
                  if R.mc_candidates(r)}
        firsts = [i for i, (j, _) in enumerate(records) if j == 0]
        out["data_s"] = time.perf_counter() - t0
        log(f"  (b) {len(records)} eval records of a pipeline run on two "
            f"small scans, every frame resolved ({out['data_s']:.1f} s)")
        base = ["--eval-root", root, "--images-root", images, "--limit",
                str(EVAL_LIMIT), "--max-tiles", str(EVAL_TILES),
                "--max-prompt-len", str(EVAL_PROMPT)]
        paged = ["--paged", "--slots", "8", "--page-size", "64",
                 "--num-pages", "640", "--prefix-cache", "--prefill-chunk",
                 str(EVAL_CHUNK), "--vision-cache", str(EVAL_VISION)]
        cfg = flagship_cut(M, EVAL_LAYERS, EVAL_VIT_LAYERS)
        t0 = time.perf_counter()
        model = M.MultiFrameMLLM(cfg, device="cuda")
        M.init_random_weights(model, SEED)
        model.eval()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        bf16_bytes = Q.tree_nbytes(model)
        log(f"  flagship, LLM and ViT cut to {EVAL_LAYERS} and "
            f"{EVAL_VIT_LAYERS} layers: "
            f"{n_params / 1e9:.3f} B params, "
            f"{bf16_bytes / 2**30:.2f} GiB of weights, built in "
            f"{time.perf_counter() - t0:.1f} s")
        runs = {}
        with k1_operands(A, R, cfg.llm) as got:
            runs["batched"] = flagship_eval_run(
                torch, cli, K, R, model, tok,
                base + ["--batch-size", "4", "--mc-logprob"], kernels,
                "eval --batch-size 4 --mc-logprob (bf16)")
        if len(got) != 2:
            fail(f"K1 operands kept from the batched eval: {list(got)}")
        out["k1_err"] = k1_on_operands(torch, A, got)
        del got
        torch.cuda.empty_cache()
        runs["speculate"] = flagship_eval_run(
            torch, cli, K, R, model, tok,
            base + paged + ["--speculate", str(EVAL_SPECULATE)], kernels,
            f"eval --paged {' '.join(paged[7:])} --speculate "
            f"{EVAL_SPECULATE} (bf16)")
        runs["logprobs"] = flagship_eval_run(
            torch, cli, K, R, model, tok, base + paged + ["--logprobs"],
            kernels, "eval --paged ... --logprobs (bf16)")
        # sampling's cost beside a decode step, both on the host clock: one
        # keyed top-p draw over 8 slots of the flagship vocabulary
        # (threefry + Gumbel + nucleus), 20 back to back, synchronised
        logits = torch.randn(8, cfg.llm.vocab_size, device="cuda")
        samp = (torch.full((8,), 0.8, device="cuda"),
                torch.full((8,), 0.9, device="cuda"),
                torch.arange(8, dtype=torch.int32, device="cuda"), None,
                True)
        pos = torch.arange(8, device="cuda") + 3000
        for _ in range(3):
            S.next_tokens(logits, pos, samp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            S.next_tokens(logits, pos, samp)
        torch.cuda.synchronize()
        draw_ms = 1e3 * (time.perf_counter() - t0) / 20
        step_ms = runs["logprobs"]["decode_step_ms"]
        log(f"  sampling: a keyed top-p draw over 8 x {cfg.llm.vocab_size} "
            f"takes {draw_ms:.3f} ms, {100 * draw_ms / step_ms:.1f}% of a "
            f"{step_ms:.2f} ms decode step (both host clock, 8 slots)")
        Q.quantize_model(model)
        torch.cuda.empty_cache()
        q_bytes = Q.tree_nbytes(model)
        # one record a file (the dequantisation a call makes it the
        # slowest run)
        first = base[:5] + ["1"] + base[6:]
        runs["int8_weights"] = flagship_eval_run(
            torch, cli, K, R, model, tok, first + paged + ["--logprobs"],
            kernels, "eval --paged ... --logprobs, int8 weights, --limit 1")
        log(f"  weights: {q_bytes / 2**30:.2f} GiB int8 vs "
            f"{bf16_bytes / 2**30:.2f} GiB bf16 ({q_bytes / bf16_bytes:.3f})")
        ref = runs["batched"]["predictions"]
        for name in ("speculate", "logprobs", "int8_weights"):
            got = runs[name]["predictions"]
            if name == "int8_weights":      # the first record of each file
                got = {i: got[k] for k, i in enumerate(firsts)}
            same, n = agreement(got, ref, scored)
            log(f"  {name}: {same}/{n} decoded answers equal the unpaged "
                f"greedy ones (bf16; not gated)")
        del model
        torch.cuda.empty_cache()
        cfg = moe_config(cli)
        model = M.MultiFrameMLLM(cfg, device="cuda")
        M.init_random_weights(model, SEED)
        model.eval()
        runs["moe"] = flagship_eval_run(
            torch, cli, K, R, model, tok,
            ["--eval-root", root, "--images-root", images, "--limit", "1",
             "--max-prompt-len", str(EVAL_PROMPT), "--paged", "--kv-dtype",
             "int8", "--page-size", "128", "--num-pages", "320"],
            kernels, "(c) bench MoE eval --paged --kv-dtype int8")
        del model
        torch.cuda.empty_cache()
    log(f"  phase 19 parts: tiny {out['tiny_s']:.1f} s, eval data "
        f"{out['data_s']:.1f} s; {card}")

    def launches(*names):
        total = {}
        for n in names:
            for k, v in runs[n]["launches"].items():
                total[k] = total.get(k, 0) + v
        return total

    out.update(runs=runs, eval_paged=launches("speculate", "logprobs",
                                              "int8_weights"),
               eval_batched=runs["batched"]["launches"],
               moe_eval=runs["moe"]["launches"])
    for path in ("eval_paged", "eval_batched", "moe_eval"):
        log(f"  launches on {path}: {out[path]}")
    return out


def watched_train_steps(torch, cli, kernels):
    """A context manager: within it the CLI's `train_steps` zeroes the
    counts of `kernels` and the card's peak-memory reading just before the
    steps, and records in the dict it yields the steps' history, the
    launches and the peak GiB."""
    seen = {}
    inner = cli.train_steps

    def wrapped(*args, **kwargs):
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        summary, history = inner(*args, **kwargs)
        torch.cuda.synchronize()
        seen.update(history=history,
                    launches={k.name: k.launches for k in kernels},
                    peak=torch.cuda.max_memory_allocated() / 2**30)
        return summary, history

    @contextlib.contextmanager
    def watching():
        cli.train_steps = wrapped
        try:
            yield seen
        finally:
            cli.train_steps = inner

    return watching()


def train_cli(torch, cli, argv, kernels):
    """`cli.main(["train", *argv])` on its device -> (the summary line,
    its stderr events by kind, what `watched_train_steps` saw)."""
    import io

    err = io.StringIO()
    with watched_train_steps(torch, cli, kernels) as seen:
        lines = cli_run(cli, ["train", *argv], err=err)
    events = {}
    for line in err.getvalue().splitlines():
        if line.startswith("[train] "):
            kind, _, rest = line[8:].partition(" ")
            events.setdefault(kind, []).append(
                dict(kv.split("=", 1) for kv in rest.split() if "=" in kv))
    return json.loads(lines[-1]), events, seen, err.getvalue()


def write_tiny_train_world(np, root):
    """tiny_eval_campaign's frames and eval records under `root`, and a
    one-dataset mixture of six records over the frames. Returns (meta,
    eval JSONL)."""
    jsonl, _ = tiny_eval_campaign(np, root)
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for i in range(6):
            f.write(json.dumps({"id": f"s{i}", "image": [f"{i % 2}.jpg"],
                                "conversations": [
                {"from": "human", "value": "<image>\nhow far is the chair?"},
                {"from": "gpt", "value": f"{100 + 7 * i} mm"}]}) + "\n")
    meta = os.path.join(root, "mix.json")
    with open(meta, "w") as f:
        json.dump({"spa": {"root": "imgs", "annotation": "train.jsonl",
                           "repeat_time": 1}}, f)
    return meta, jsonl


def lora_tiny_cli(torch, np, cli, T, root, init, vocab, label):
    """`train --lora-rank 4` of the tiny f32 model from `init` for 3 steps
    with `--eval-*` (`--mc-logprob`) and `--async-save` on the CPU and on
    the card: every step's loss and grad norm within TRAIN_REL, the summary
    (eval_accuracy equal), the lora and eval events equal, the same
    checkpoint layout, the saved merged weights within TINY_LORA_ATOL card
    vs CPU and moved from `init` by more than TINY_LORA_MOVED."""
    meta, jsonl = write_tiny_train_world(np, root)
    runs = {}
    for dev in ("cpu", "cuda"):
        out = os.path.join(root, f"lora_{dev}")
        summary, events, seen, _ = train_cli(torch, cli, [
            "--meta", meta, "--config", "tiny", "--vocab-size", str(vocab),
            "--init-checkpoint", init, "--steps", "3", "--batch-size", "2",
            "--seq-len", "128", "--max-tiles", "1", "--tiles-per-image", "1",
            "--warmup", "1", "--lr", "1e-3", "--log-every", "1", "--seed",
            "3", "--lora-rank", "4", "--eval-jsonl", jsonl,
            "--eval-images-root", os.path.join(root, "imgs"),
            "--eval-every", "2", "--eval-max-new-tokens", "6",
            "--mc-logprob", "--async-save", "--save-every", "2", "--output",
            out, "--device", dev], [])
        with open(os.path.join(out, "LATEST")) as f:
            layout = (sorted(os.listdir(out)), f.read())
        saved = T.restore_checkpoint(out, map_location="cpu")
        runs[dev] = (summary, events, seen["history"], layout, saved)
    (s_c, e_c, h_c, l_c, p_c), (s_g, e_g, h_g, l_g, p_g) = (runs["cpu"],
                                                            runs["cuda"])
    worst = {key: max(abs(a[key] - b[key]) / abs(a[key])
                      for a, b in zip(h_c, h_g))
             for key in ("loss", "grad_norm")}
    steps = [[e["step"] for e in ev.get("checkpoint", [])]
             for ev in (e_c, e_g)]
    init_sd = torch.load(init, map_location="cpu", weights_only=True)
    gap = max((p_c["params"][k] - p_g["params"][k]).abs().max().item()
              for k in p_c["params"])
    moved = max((p_c["params"][k] - init_sd[k]).abs().max().item()
                for k in init_sd)
    log(f"  {label}: train --lora-rank 4, 3 steps, --eval-every 2 "
        f"--mc-logprob --async-save: losses CPU "
        f"{[round(h['loss'], 6) for h in h_c]} card "
        f"{[round(h['loss'], 6) for h in h_g]}; worst relative difference "
        f"loss {worst['loss']:.3e}, grad norm {worst['grad_norm']:.3e} "
        f"(tol {TRAIN_REL:g}); eval events {e_g.get('eval')}; "
        f"eval_accuracy {s_g.get('eval_accuracy')}; lora event "
        f"{e_g.get('lora')}; saves at steps {steps[1]} ({l_g[0]}); merged "
        f"weights max|card - CPU| {gap:.3e} (tol {TINY_LORA_ATOL:g}), "
        f"moved from the import by {moved:.3e} (at least "
        f"{TINY_LORA_MOVED:g})")
    if len(h_c) != 3 or len(h_g) != 3 or max(worst.values()) > TRAIN_REL:
        fail(f"{label}: LoRA train steps differ between the CPU and the "
             f"card")
    for key in ("first_loss", "last_loss"):
        if abs(s_c[key] - s_g[key]) > TRAIN_REL * abs(s_c[key]):
            fail(f"{label}: summary {key} {s_g[key]} vs CPU {s_c[key]}")
    if s_c.get("eval_accuracy") != s_g.get("eval_accuracy") or \
            "eval_accuracy" not in s_g:
        fail(f"{label}: eval_accuracy card {s_g.get('eval_accuracy')} vs "
             f"CPU {s_c.get('eval_accuracy')}")
    if e_c.get("eval") != e_g.get("eval") or len(e_g.get("eval", [])) != 2:
        fail(f"{label}: eval events card {e_g.get('eval')} vs CPU "
             f"{e_c.get('eval')}")
    if e_c.get("lora") != e_g.get("lora") or not e_g.get("lora"):
        fail(f"{label}: lora events card {e_g.get('lora')} vs CPU "
             f"{e_c.get('lora')}")
    if l_c != l_g or steps[0] != steps[1] or steps[1] != ["2", "3"]:
        fail(f"{label}: checkpoints card {l_g} {steps[1]} vs CPU {l_c} "
             f"{steps[0]}")
    if p_c.get("opt_state") is not None or p_g.get("opt_state") is not None:
        fail(f"{label}: a LoRA save holds optimizer state")
    if gap > TINY_LORA_ATOL or moved < TINY_LORA_MOVED:
        fail(f"{label}: merged weights card vs CPU {gap:.3e}, moved "
             f"{moved:.3e}")


def random_adapters(torch, model, lc, n, seed, std):
    """n seeded adapters of `lc` for `model` with non-zero B (normal, std
    `std`), on the model's device."""
    from multi_spatialmllm_tpu_torch.models import prng
    from multi_spatialmllm_tpu_torch.parallel import lora as L

    out = {}
    for i in range(n):
        ad = L.init_lora(model, lc, prng.key(seed + i))
        gen = torch.Generator(device=next(model.parameters()).device)
        gen.manual_seed(seed + i)
        for t in ad.values():
            t["b"].normal_(0.0, std, generator=gen)
        out[f"adapter_{'AB'[i]}"] = ad
    return out


def phase20_tiny(torch, np, cli, M, K, T, tok, tmp):
    """(a) tiny f32, card vs CPU: import-checkpoint of a fixture with
    layer scales (state dicts bit-equal), export-checkpoint (files
    byte-equal), greedy serving of the import, `train --lora-rank 4` from
    the import, and a mixed-adapter PagedBatcher (native and int8 kv, with
    the prefix cache, chunked prefill and speculation). The CLI's `tiny`
    computes in float32 here."""
    from multi_spatialmllm_tpu_torch.models import checkpoint_import as CI
    from multi_spatialmllm_tpu_torch.parallel import lora as L

    vocab = tok.vocab_size
    tiny = M.CONFIGS["tiny"]
    M.CONFIGS["tiny"] = lambda: M.with_dtype(tiny(), "float32")
    try:
        cfg = cli._config(argparse.Namespace(config="tiny",
                                             vocab_size=vocab))
        fixture = CI.make_fixture_state_dict(cfg, SEED + 20)
        src = os.path.join(tmp, "hf_tiny")
        n = len(CI.write_sharded({k: torch.from_numpy(v)
                                  for k, v in fixture.items()}, src,
                                 2_000_000))
        sds, files = {}, {}
        for name, dev in (("cpu", "cpu"), ("card", "cuda")):
            pt = os.path.join(tmp, f"tiny_{name}.pt")
            out = os.path.join(tmp, f"tiny_export_{name}")
            common = ["--config", "tiny", "--vocab-size", str(vocab),
                      "--device", dev]
            cli_run(cli, ["import-checkpoint", "--checkpoint", src,
                          "--output", pt, "--dtype", "float32", *common])
            cli_run(cli, ["export-checkpoint", "--checkpoint", pt,
                          "--output", out, "--dtype", "bfloat16",
                          "--shard-gb", "0.001", *common])
            sds[name] = torch.load(pt, map_location="cpu", weights_only=True)
            files[name] = {}
            for f in sorted(os.listdir(out)):
                with open(os.path.join(out, f), "rb") as fh:
                    files[name][f] = fh.read()
        bad = [k for k in sds["cpu"] if not torch.equal(sds["cpu"][k],
                                                        sds["card"][k])]
        if bad or set(sds["cpu"]) != set(sds["card"]):
            fail(f"tiny import differs card vs CPU: {bad[:4]}")
        if files["cpu"] != files["card"]:
            fail("tiny export files differ card vs CPU")
        log(f"  (a) tiny import of {n} fixture shards (layer scales "
            f"folded): {len(sds['cpu'])} tensors bit-equal card vs CPU; "
            f"export {len(files['cpu'])} files "
            f"({sum(map(len, files['cpu'].values()))} bytes) byte-equal")
        state = sds["cpu"]
        phase_tiny(torch, M, K, cfg, "tiny import", state=state)
        lora_tiny_cli(torch, np, cli, T, os.path.join(tmp, "tiny_train"),
                      os.path.join(tmp, "tiny_cpu.pt"), vocab, "tiny import")
    finally:
        M.CONFIGS["tiny"] = tiny
    lc = L.LoRAConfig(rank=4, targets=("wq", "wk", "wv", "wo", "gate", "up",
                                       "down"))
    probe = M.MultiFrameMLLM(cfg)
    adapters = random_adapters(torch, probe, lc, 2, SEED + 22, 0.2)
    for kv in ("native", "int8"):
        phase_tiny(torch, M, K, cfg, "tiny multi-LoRA", kv_dtype=kv,
                   state=state, adapters=adapters, lora_cfg=lc,
                   options=dict(prefix_cache=True, prefill_chunk=16,
                                speculate=2))


def file_bytes(root):
    return sum(os.path.getsize(os.path.join(root, f))
               for f in os.listdir(root))


def same_state(torch, got, want, what):
    """Leaf for leaf, bit for bit (want's device; got streams over)."""
    if set(got) != set(want):
        fail(f"{what}: names differ: {sorted(set(got) ^ set(want))[:4]}")
    for k, v in want.items():
        g = got[k].to(v.device)
        if g.dtype != v.dtype or not torch.equal(g, v):
            fail(f"{what}: {k} differs")


def phase20_checkpoint(torch, cli, M, cfg, tmp, card):
    """(b) the flagship `cfg` (the CLI's `flagship` cut to it), bf16: an
    HF-layout state drawn on the card, written as SHARD_GB shards,
    `import-checkpoint` (seconds, GB/s), held against `convert_state_dict`
    in memory, `export-checkpoint`, and the export re-imported equal to the
    import. Returns the imported file."""
    import shutil

    from multi_spatialmllm_tpu_torch.models import checkpoint_import as CI

    free = shutil.disk_usage(tmp).free
    log(f"  (b) disk free under {tmp}: {free / 1e9:.1f} GB (the phase needs "
        f"~{PHASE20_DISK / 1e9:.0f} GB at its peak)")
    if free < PHASE20_DISK:
        fail(f"phase 20 needs {PHASE20_DISK / 1e9:.0f} GB of free disk "
             f"under {tmp}, has {free / 1e9:.1f} GB")
    t0 = time.perf_counter()
    state = CI.random_state_dict(cfg, SEED + 23, device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_el = sum(t.numel() for t in state.values())
    src = os.path.join(tmp, "hf_flagship")
    t1 = time.perf_counter()
    shards = CI.write_sharded(state, src, int(SHARD_GB * 1e9))
    t_write = time.perf_counter() - t1
    size = file_bytes(src)
    log(f"  HF-layout flagship state: {len(state)} tensors, {n_el / 1e9:.3f}"
        f" B elements (layer scales included), drawn on the card in "
        f"{t1 - t0:.1f} s; written as {len(shards)} shards + index "
        f"({size / 1e9:.3f} GB) in {t_write:.1f} s ({size / 1e9 / t_write:.2f}"
        f" GB/s)")
    if len(shards) != 5 or not os.path.exists(
            os.path.join(src, "model.safetensors.index.json")):
        fail(f"expected 5 shards and an index, got {os.listdir(src)}")
    pt = os.path.join(tmp, "flagship.pt")
    t0 = time.perf_counter()
    cli_run(cli, ["import-checkpoint", "--checkpoint", src, "--output", pt,
                  "--config", "flagship", "--dtype", "bfloat16",
                  "--device", "cuda"])
    t_imp = time.perf_counter() - t0
    log(f"  import-checkpoint --config flagship --dtype bfloat16 on the "
        f"card: {t_imp:.1f} s for {size / 1e9:.3f} GB read and "
        f"{os.path.getsize(pt) / 1e9:.3f} GB written "
        f"({size / 1e9 / t_imp:.2f} GB/s of safetensors read); {card}")
    shutil.rmtree(src)
    want = CI.convert_state_dict(state, cfg, torch.bfloat16)
    del state
    got = torch.load(pt, map_location="cpu", mmap=True, weights_only=True)
    same_state(torch, got, want, "flagship import vs convert_state_dict")
    log(f"  the import equals convert_state_dict on the card leaf for leaf, "
        f"bit for bit ({len(want)} tensors)")
    del want
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "flagship_export")
    t0 = time.perf_counter()
    cli_run(cli, ["export-checkpoint", "--checkpoint", pt, "--output", out,
                  "--config", "flagship", "--dtype", "bfloat16",
                  "--shard-gb", str(SHARD_GB), "--device", "cuda"])
    t_exp = time.perf_counter() - t0
    size = file_bytes(out)
    log(f"  export-checkpoint: {len(os.listdir(out))} files, "
        f"{size / 1e9:.3f} GB in {t_exp:.1f} s ({size / 1e9 / t_exp:.2f} "
        f"GB/s)")
    t0 = time.perf_counter()
    again = CI.load_internvl2_checkpoint(out, cfg, torch.bfloat16, "cuda")
    t_re = time.perf_counter() - t0
    same_state(torch, got, again, "re-import of the export")
    log(f"  re-import of the export ({t_re:.1f} s) equals the import bit "
        f"for bit")
    del again, got
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    return pt


def phase20_serve(torch, M, K, cli, tok, cfg, pt, kernels, card):
    """(c) 16 flagship requests on the imported weights through the serve
    loop, in thirds on the base and two adapters (rank 16, the attention
    targets, non-zero B), beside the same requests with no adapters. The
    base rows must equal the adapter-free run's and some adapter row must
    differ from it; each adapter's first prefill logits must lie within
    LORA_LOGIT_FRAC of the base's distance from its merged-weights logits;
    the adapter rows' tokens against a batcher on the merged weights are
    reported. Returns the launches of the multi-LoRA run."""
    from multi_spatialmllm_tpu_torch.parallel import lora as L
    from multi_spatialmllm_tpu_torch.parallel.lora_serving import (
        stack_adapters,
    )

    dev = torch.device("cuda")
    model = M.MultiFrameMLLM(cfg, device=dev)
    model.load_state_dict(torch.load(pt, map_location=dev,
                                     weights_only=True))
    model.eval()
    lc = L.LoRAConfig(rank=LORA_RANK)
    adapters = random_adapters(torch, model, lc, 2, SEED + 24, 0.02)
    pcfg = K.PagedConfig(slots=8, page_size=64, num_pages=256,
                         max_prompt_len=2048, max_new_tokens=32)
    lines, tiles = serve_lines_for(cfg, N_SERVE, K)
    names = [(None, *adapters)[i * 3 // N_SERVE] for i in range(N_SERVE)]

    def run(batcher, with_names, label):
        build = cli.make_request_builder(cfg, tok, batcher, tiles.get)

        def to_request(rec):
            req = build(rec)
            name = names[int(rec["id"][3:])] if with_names else None
            return req + (name,) if name else req

        events = []
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.serve_lines(batcher, lines, to_request, tok,
                        lambda o: events.append(o))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        errors = [o for o in events if "error" in o]
        if errors or len(events) != N_SERVE:
            fail(f"{label}: {len(events)} results, errors {errors[:2]}")
        st = batcher.stats
        rate = st["decode_tokens"] / st["decode_seconds"]
        log(f"  {label}: {N_SERVE}/{N_SERVE} finished in {wall:.3f} s; "
            f"decode {st['decode_tokens']} tokens in "
            f"{st['decode_seconds']:.3f} s -> {rate:.1f} tokens/s; prefill "
            f"{st['prefill_seconds']:.3f} s; launches "
            f"{ {k.name: k.launches for k in kernels} }")
        return ({o["id"]: o["token_ids"] for o in events}, rate,
                {k.name: k.launches for k in kernels})

    def batcher(**lora):
        return K.PagedBatcher(model, pcfg, pad_id=tok.pad_id,
                              eos_id=tok.eos_id, **lora)

    torch.cuda.reset_peak_memory_stats()
    plain, plain_rate, _ = run(batcher(), False, "adapter-free")
    mixed, lora_rate, launches = run(
        batcher(adapters=adapters, lora_config=lc), True,
        "multi-LoRA (base, adapter_A, adapter_B in thirds)")
    if min(launches.values()) <= 0:
        fail(f"a kernel never launched on the multi-LoRA path: {launches}")
    base_rows = [f"req{i}" for i in range(N_SERVE) if names[i] is None]
    if any(mixed[r] != plain[r] for r in base_rows):
        fail("base rows of the mixed batch differ from the adapter-free "
             "run")
    changed = sum(mixed[f"req{i}"] != plain[f"req{i}"]
                  for i in range(N_SERVE) if names[i])
    if changed == 0:
        fail("no adapter row differs from the base: the adapters did not "
             "reach the served rows")

    tables = stack_adapters(list(adapters.values()), cfg.llm.num_layers, lc)
    build = cli.make_request_builder(cfg, tok, batcher(), tiles.get)

    @torch.no_grad()
    def first_logits(ids, row_tiles, idx=None):
        lora = None if idx is None else {**tables, "idx": torch.tensor(
            [idx], device=dev)}
        logits, _ = model.prefill(
            torch.as_tensor(ids[None], dtype=torch.long, device=dev),
            torch.as_tensor(row_tiles[None], dtype=torch.float32,
                            device=dev), lora=lora)
        return logits[0, -1].float()

    agree, logit_gaps = {}, {}
    for k, (name, ad) in enumerate(adapters.items(), start=1):
        row = names.index(name)
        ids, row_tiles = build(json.loads(lines[row]))[:2]
        unmerged = first_logits(ids, row_tiles, k)
        base = first_logits(ids, row_tiles)
        with L.merged(model, ad, lc):
            merged_logits = first_logits(ids, row_tiles)
            merged, _, _ = run(batcher(), False, f"merged {name}")
        gap = (unmerged - merged_logits).abs().max().item()
        apart = (base - merged_logits).abs().max().item()
        logit_gaps[name] = (gap, apart)
        if not gap <= LORA_LOGIT_FRAC * apart:
            fail(f"{name}: req{row}'s first prefill logits lie "
                 f"{gap:.4g} from the merged weights', more than "
                 f"{LORA_LOGIT_FRAC:g} x the base's {apart:.4g}")
        rows = [f"req{i}" for i in range(N_SERVE) if names[i] == name]
        prefix = [next((j for j, (a, b) in enumerate(zip(mixed[r],
                                                          merged[r]))
                        if a != b), len(mixed[r])) for r in rows]
        agree[name] = (sum(mixed[r] == merged[r] for r in rows), len(rows),
                       prefix)
    gaps = {n: (round(g, 5), round(a, 5), round(g / a, 4))
            for n, (g, a) in logit_gaps.items()}
    log(f"  first prefill logits of each adapter's first row: max|unmerged "
        f"- merged|, max|base - merged| and their ratio (gate: <= "
        f"{LORA_LOGIT_FRAC:g}): {gaps}")
    log(f"  adapter rows token-equal to their merged-weights batcher, of "
        f"the rows, and each row's tokens before the first difference "
        f"(reported, bf16 unmerged and merged deltas round differently): "
        f"{agree}; adapter rows that differ from the base: {changed} of "
        f"{N_SERVE - len(base_rows)}; decode {lora_rate:.1f} tokens/s "
        f"multi-LoRA vs {plain_rate:.1f} adapter-free "
        f"({lora_rate / plain_rate:.3f}x); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {card}")
    del model
    torch.cuda.empty_cache()
    return launches, dict(lora_tokens_per_s=lora_rate,
                          plain_tokens_per_s=plain_rate, agree=agree,
                          logit_gaps=logit_gaps, changed=changed)


def write_repeat_mixture(root, n_records):
    """A mixture of `n_records` copies of one record (one 448 x 448 JPEG
    frame, a question and its answer from the template banks the tokenizer
    was built from), so every packed batch the train CLI draws from it is
    the same batch. Returns the meta JSON's path."""
    from multi_spatialmllm_tpu_torch.ingest.jpeg import imwrite
    from multi_spatialmllm_tpu_torch.models._vocab_templates import (
        TEMPLATE_CORPUS,
    )

    os.makedirs(os.path.join(root, "frames"))
    imwrite(os.path.join(root, "frames", "f.jpg"), synthetic_frame("f.jpg"))
    q, a = (t.replace("<image>", "").strip() for t in TEMPLATE_CORPUS[:2])
    rec = json.dumps({"id": "r", "image": ["f.jpg"], "conversations": [
        {"from": "human", "value": "Image-1: <image>\n" + q},
        {"from": "gpt", "value": a}]})
    with open(os.path.join(root, "repeat.jsonl"), "w") as f:
        f.write((rec + "\n") * n_records)
    meta = os.path.join(root, "mix.json")
    with open(meta, "w") as f:
        json.dump({"repeat": {"root": "frames", "annotation": "repeat.jsonl",
                              "repeat_time": 1.0, "length": n_records}}, f)
    return meta


def lora_train_cli(torch, cli, kernels, label, config_flags, cfg, init,
                   max_tiles, tiles_per_image):
    """`train --lora-rank 16 --packed` (two 4096-token rows a batch) for
    REPEAT_STEPS steps of one repeated batch, on the card, from `init`
    (the CLI's seeded weights when None). The loss must fall at every
    update after the first (lr 0); K1 must launch once a ViT layer and
    twice an LLM layer a step (the LLM's layers recomputed in the
    backward; once where the remat policy keeps the flash forward's
    outputs), K2 and K3 once an LLM layer (the frozen ViT takes no
    backward). Returns (launches, summary, peak GiB, trainable, the
    CLI's stderr)."""
    import gc
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        meta = write_repeat_mixture(root, 64)
        t0 = time.perf_counter()
        summary, events, seen, err = train_cli(torch, cli, [
            "--meta", meta, *config_flags, "--lora-rank", str(LORA_RANK),
            "--packed", "--seq-len", "4096", "--batch-size", "2", "--steps",
            str(REPEAT_STEPS), "--lr", str(LORA_LR), "--warmup",
            str(LORA_WARMUP), "--max-tiles", str(max_tiles),
            "--tiles-per-image", str(tiles_per_image), "--log-every", "1",
            "--seed", str(SEED), "--device", "cuda",
            *(["--init-checkpoint", init] if init else [])], kernels)
        wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    history, launches, peak = seen["history"], seen["launches"], seen["peak"]
    losses = [h["loss"] for h in history]
    trainable = int(events["lora"][0]["trainable"])
    per_step = {k: v / REPEAT_STEPS for k, v in launches.items()}
    log(f"  {label}: the train CLI ({' '.join(config_flags)} --lora-rank "
        f"{LORA_RANK}) in {wall:.1f} s: {summary}; lora event "
        f"{events['lora'][0]}; losses {losses}; step seconds "
        f"{[round(h['step_s'], 4) for h in history]}; peak {peak:.3f} GiB; "
        f"launches a step {per_step}; {card_name_and_power_limit()}")
    if summary["steps"] != REPEAT_STEPS or not all(
            b < a for a, b in zip(losses[1:], losses[2:])):
        fail(f"{label}: the loss did not fall on a repeated batch: {losses}")
    # the LLM's K1 runs again in the backward unless its remat policy
    # keeps the flash forward's outputs (the bench MoE's)
    again = cfg.llm.remat_policy != "dots_and_flash_saveable"
    want = {"flash_fwd": cfg.vit.num_layers
            + (1 + again) * cfg.llm.num_layers,
            "flash_bwd_dq": cfg.llm.num_layers,
            "flash_bwd_dkv": cfg.llm.num_layers}
    if any(per_step[k] != v for k, v in want.items()):
        fail(f"{label}: launches a step {per_step}, expected {want} (remat "
             f"of every LLM layer, no ViT backward)")
    return launches, summary, peak, trainable, err


def phase20_train(torch, M, cli, cfg, pt, kernels, moe_kernels):
    """(d) `train --config flagship --lora-rank 16` (the CLI's `flagship`
    cut to `cfg`) from the imported weights (the CLI turns on the LLM's
    remat), then the bench MoE's LoRA with its expert tables frozen (gmm
    and gmm_t launch, tgmm never)."""
    launches, summary, peak, trainable, _ = lora_train_cli(
        torch, cli, kernels,
        f"flagship LoRA, LLM cut to {cfg.llm.num_layers} layers",
        ["--config", "flagship"], cfg, pt, 6, 6)
    want = LORA_TRAINABLE_PER_LAYER * cfg.llm.num_layers
    if trainable != want:
        fail(f"trainable adapter params {trainable} != {want}")
    flags = ["--config", "bench", "--moe-experts", "4", "--moe-impl",
             "ragged", "--moe-kernel", "pallas"]
    moe_launches, moe_summary, moe_peak, _, err = lora_train_cli(
        torch, cli, kernels + moe_kernels,
        "bench MoE LoRA (experts frozen)", flags, moe_config(cli), None,
        MOE_MAX_TILES, MOE_TILES_PER_IMAGE)
    if "note: --lora-rank with --moe-experts" not in err:
        fail("the train CLI printed no MoE LoRA note")
    if moe_launches["tgmm"] != 0 or min(
            moe_launches[k] for k in ("gmm", "gmm_t")) <= 0:
        fail(f"MoE LoRA launches: {moe_launches} (gmm and gmm_t must "
             f"launch, tgmm never: the experts are frozen)")
    return dict(train=launches, moe_train=moe_launches, peak=peak,
                summary=summary, moe_peak=moe_peak, moe_summary=moe_summary)


def phase_lora(torch, cli, M, K, T, tok, card, kernels, moe_kernels,
               serve_kernels):
    """Phase 20: (a) tiny card vs CPU, (b) the flagship checkpoint
    import/export, (c) multi-LoRA flagship serving, (d) flagship LoRA
    training and the MoE LoRA, both through the train CLI; (b)-(d) with
    the flagship's LLM cut to PHASE20_LAYERS layers."""
    import tempfile

    import numpy as np

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        phase20_tiny(torch, np, cli, M, K, T, tok, tmp)
        log(f"  (a) took {time.perf_counter() - t0:.1f} s")
        cfg = flagship_cut(M, PHASE20_LAYERS)
        with flagship_cut_to(M, PHASE20_LAYERS):
            t0 = time.perf_counter()
            pt = phase20_checkpoint(torch, cli, M, cfg, tmp, card)
            log(f"  (b) took {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            out["serve"], out["serve_rates"] = phase20_serve(
                torch, M, K, cli, tok, cfg, pt, serve_kernels, card)
            log(f"  (c) took {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            out.update(phase20_train(torch, M, cli, cfg, pt, kernels,
                                     moe_kernels))
            log(f"  (d) took {time.perf_counter() - t0:.1f} s")
    return out


# phase 21: bench.py's split_projection_val shape (:690-731: seeds 20-25,
# real-scale scenes, hybrid visibility and float32 relations a scene) with
# PROJ_SCENES of its 6 scenes, to stay in time; the val split's 312 scenes
PROJ_SCENES = 3
VAL_SCENES = 312
HYBRID_PASSES = 3        # bench.py's visibility_hybrid_realscale passes


def visibility_golden():
    """scripts/gen_visibility_golden.py (its scene, `packed_digest`) and
    the stored digests of the JAX package's labels."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "gen_visibility_golden.py")
    spec = importlib.util.spec_from_file_location("gen_visibility_golden",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load()


def bench_entry(times, unit="s/scene"):
    """A bench.py stage entry (`time_entry`'s value: the median)."""
    return {"value": median(times), "unit": unit,
            "times": [round(t, 4) for t in times]}


def hybrid_realscale(torch, np, V, real, card):
    """The hybrid stage over the real-scale scene: cold and steady
    seconds, the device program alone (CUDA events, inputs resident), the
    flagged share, the host fix-up's seconds (dispatch, wait for the
    device, then finalize), peak device bytes a padded pair."""
    pts, pvalid = real.padded_points(np.float32)
    ext, depth, ivalid = real.padded_images(np.float32)
    i_pad, n_pad = ext.shape[0], pts.shape[0]
    t0 = time.perf_counter()
    V.compute_scene_visibility_hybrid(real)
    cold = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steady = []
    for _ in range(HYBRID_PASSES):
        t0 = time.perf_counter()
        vis = V.compute_scene_visibility_hybrid(real)
        steady.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    handles = V._hybrid_dispatch(real)
    handles.ready.synchronize()
    t1 = time.perf_counter()
    again = V._hybrid_finalize(real, handles)
    fixup = time.perf_counter() - t1
    flagged = sum(int(np.unpackbits(nr.numpy()).sum())
                  for _, nr in handles.chunks)
    if not np.array_equal(again, vis):
        fail("real-scale hybrid: two calls differ")
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (
        pts, real.intrinsic.astype(np.float32), ext, depth.astype(np.int32),
        ivalid, pvalid)]

    def program():
        v, n = V.G.visibility_and_borderline(*args[:4], real.image_hw,
                                             *args[4:])
        return V._packbits(v), V._packbits(n)

    device_ms = cuda_ms(torch, program, iters=5, warmup=1)
    del args
    pairs = real.num_images * real.num_points
    out = {"cold_s": cold, "steady": steady, "steady_s": min(steady),
           "device_ms": device_ms, "wait_s": t1 - t0, "fixup_s": fixup,
           "chunks": len(handles.chunks), "flagged": flagged,
           "flagged_share": flagged / pairs, "peak_bytes": peak,
           "bytes_per_pair": peak / (i_pad * n_pad)}
    log(f"  real-scale visibility hybrid: cold {cold:.3f} s, steady "
        f"{min(steady):.3f} s ({[round(t, 4) for t in steady]}), the device "
        f"program alone {device_ms:.3f} ms (CUDA events), "
        f"{out['chunks']} chunk(s); flagged {flagged} of {pairs} pairs "
        f"({100 * out['flagged_share']:.3f}%); dispatch and wait "
        f"{t1 - t0:.3f} s, host fix-up {fixup:.3f} s; peak "
        f"{peak / 2**30:.3f} GiB over the allocated base, "
        f"{out['bytes_per_pair']:.1f} bytes a padded pair ({i_pad} x "
        f"{n_pad}); {card}")
    return vis, out


def split_projection(torch, np, V, FR, make_scene, card):
    """bench.py's split_projection_val on PROJ_SCENES real-scale scenes:
    the sequential loop (hybrid visibility, then float32 relations, a
    scene at a time) and `project_scenes_pipelined`, which must give the
    same bytes; s/scene of each and the val split's minutes."""
    t0 = time.perf_counter()
    scenes = [make_scene(**dict(REAL_SCENE, scene_id=f"proj{i:04d}_00",
                                seed=20 + i)) for i in range(PROJ_SCENES)]
    log(f"  split projection: {PROJ_SCENES} real-scale scenes made in "
        f"{time.perf_counter() - t0:.1f} s")
    for _ in FR.project_scenes_pipelined(scenes[:1]):     # warm
        pass
    torch.cuda.synchronize()
    runs, secs = {}, {}
    for name in ("sequential", "pipelined", "sequential_2", "pipelined_2"):
        t0 = time.perf_counter()
        if name.startswith("sequential"):
            got = []
            for sc in scenes:
                v = V.compute_scene_visibility_hybrid(sc)
                got.append((sc, v, FR.compute_scene_relations(
                    sc, vis=v, dtype=np.float32)))
        else:
            got = list(FR.project_scenes_pipelined(scenes, dtype=np.float32))
        secs.setdefault(name.split("_")[0], []).append(
            (time.perf_counter() - t0) / PROJ_SCENES)
        runs[name] = got
    seq, pipe = runs["sequential"], runs["pipelined"]
    if [sc.scene_id for sc, _, _ in pipe] != [sc.scene_id for sc in scenes]:
        fail("pipelined projection: scenes out of order")
    for (sc, v1, r1), (_, v2, r2) in zip(seq, pipe):
        if v1.tobytes() != v2.tobytes():
            fail(f"pipelined projection: {sc.scene_id} visibility differs "
                 f"from the sequential loop's")
        if sorted(r1) != sorted(r2) or any(
                r1[k].dtype != r2[k].dtype or r1[k].tobytes()
                != r2[k].tobytes() for k in r1):
            fail(f"pipelined projection: {sc.scene_id} relations differ "
                 f"from the sequential loop's")
    out = {k: {"s_per_scene": min(v), "passes": v} for k, v in secs.items()}
    log(f"  split projection, {PROJ_SCENES} scenes (bench.py runs 6): "
        f"sequential {[round(t, 4) for t in secs['sequential']]} s/scene, "
        f"pipelined {[round(t, 4) for t in secs['pipelined']]} s/scene; "
        f"vis and relations byte-equal; the {VAL_SCENES}-scene val split "
        f"projected in {min(secs['sequential']) * VAL_SCENES / 60:.2f} min "
        f"(sequential), {min(secs['pipelined']) * VAL_SCENES / 60:.2f} min "
        f"(pipelined); {card}")
    return out, {"split_projection_val": bench_entry(
        [t * VAL_SCENES / 60 for t in secs["sequential"]],
        unit="min/val-split")}


def hybrid_run_all(np, tmp, card):
    """`run_all` (the demo's scenes and TAPVid records) through
    `SpatialEnginePipeline` with `PipelineConfig(dtype="hybrid")` on the
    card and on the CPU: the trees equal file for file."""
    from multi_spatialmllm_tpu_torch.core.scene import SceneStore
    from multi_spatialmllm_tpu_torch.core.synthetic import (
        make_scene,
        make_tapvid_npz,
    )
    from multi_spatialmllm_tpu_torch.pipeline import (
        PipelineConfig,
        SpatialEnginePipeline,
    )

    config = PipelineConfig(dtype="hybrid", overlap_min=0.1,
                            overlap_max=100.0, interval=5.0)
    roots = {}
    for dev in ("cuda", "cpu"):
        roots[dev] = os.path.join(tmp, f"hybrid_{dev}")
        t0 = time.perf_counter()
        store = SceneStore.write(
            [make_scene(scene_id=f"demo{i:04d}_00", seed=i, n_images=12,
                        n_background=4000) for i in range(2)],
            os.path.join(roots[dev], "scenes"))
        SpatialEnginePipeline(store, roots[dev], config, device=dev).run_all(
            tapvid_records={f"demo_seq{i}": make_tapvid_npz(seed=50 + i)
                            for i in range(2)})
        log(f"  hybrid run_all on {dev}: {time.perf_counter() - t0:.2f} s")
    return pipeline_roots_equal(np, roots, config, "hybrid run_all", card)


def phase_hybrid(torch, card):
    """Phase 21: the float64 and hybrid labels of the real-scale scene
    against the JAX package's digest, the split projection sequential
    and pipelined, and a hybrid `run_all` card vs CPU."""
    import tempfile

    import numpy as np

    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.stages import frame_relations as FR
    from multi_spatialmllm_tpu_torch.stages import visibility as V

    gen, golden = visibility_golden()
    want_scene = {k: list(v) if isinstance(v, tuple) else v
                  for k, v in REAL_SCENE.items()}
    if golden["scene"] != want_scene or gen.REAL_SCENE != REAL_SCENE:
        fail(f"the stored digests are of another scene: {golden['scene']}")
    if golden["float64_packed_sha256"] != golden["hybrid_packed_sha256"]:
        fail("the stored JAX float64 and hybrid digests differ")
    want = golden["float64_packed_sha256"]
    real = make_scene(**REAL_SCENE)
    vis64, f64 = realscale_visibility(torch, np, V, real, np.float64, card)
    hyb, hybrid = hybrid_realscale(torch, np, V, real, card)
    got = {"float64": gen.packed_digest(vis64),
           "hybrid": gen.packed_digest(hyb)}
    for name, digest in got.items():
        if digest != want:
            fail(f"real-scale {name} labels: digest {digest} is not the JAX "
                 f"CPU float64 digest {want}")
    log(f"  real-scale float64 and hybrid labels equal the JAX CPU float64 "
        f"labels (SHA-256 {want[:16]}..., {golden['visible']} visible of "
        f"{real.num_images * real.num_points}); float64 call "
        f"{f64['steady_s']:.3f} s with a {f64['device_ms']:.3f} ms device "
        f"program, hybrid call {hybrid['steady_s']:.3f} s with a "
        f"{hybrid['device_ms']:.3f} ms device program, "
        f"{100 * hybrid['flagged_share']:.3f}% flagged, host fix-up "
        f"{hybrid['fixup_s']:.3f} s; {card}")
    rates = {"visibility_f64_realscale": bench_entry(f64["steady"]),
             "visibility_hybrid_realscale": bench_entry(hybrid["steady"])}
    del real, vis64, hyb
    torch.cuda.empty_cache()
    proj, proj_rate = split_projection(torch, np, V, FR, make_scene, card)
    rates.update(proj_rate)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        run_all = hybrid_run_all(np, tmp, card)
    log(f"  rates under bench.py's keys: {json.dumps(rates)}; {card}")
    return {"f64": f64, "hybrid": hybrid, "projection": proj,
            "run_all": run_all, "rates": rates}


# phase 22: bench.py's model block (:793-840): bench_1chip_config, batch 4
# rows of 2,048 tokens with 2 tiles each, chains of 8 steps, the best of 3
BENCH_B, BENCH_S, BENCH_TILES, BENCH_CHAIN, BENCH_CHAINS = 4, 2048, 2, 8, 3
BENCH_POLICIES = (None, "dots_with_no_batch_dims_saveable",
                  "dots_and_flash_saveable")
BENCH_LOSS_REL = 1e-3    # the chains' losses across the three policies
# the harness at the tiny f32 config, CPU vs card: chain length, and each
# parameter's change held to the CPU's in norm (tests/test_torch_flops.py
# measures 9.3e-3 against JAX on the CPU, on the ViT qkv biases whose key
# part has a zero gradient up to rounding)
BENCH_TINY_CHAIN, BENCH_TINY_UPDATE_REL = 3, 2e-2
MOE_BENCH_STEPS = 2


GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def device_by_kind(torch, fn):
    """Device milliseconds of `fn()` under torch.profiler, by kind (the
    flash forward K1, the flash backward K2/K3, K8, matrix products, the
    rest), and its host-clock milliseconds under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.key.lower()
        kind = ("K1" if "flash_fwd" in low else "K2/K3" if "flash_bwd" in low
                else "K8" if "gmm_" in low
                else "matrix products" if any(m in low for m in GEMM_MARKERS)
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    return kinds, wall * 1e3


def bench_train(torch, M, T, F, cfg, kernels, label, chain, chains,
                capture=contextlib.nullcontext):
    """`make_chained_train_step` on `make_example_batch` at the bench
    shape: a warm chain (its losses returned) under `capture()`, then
    `chains` timed chains (host clock, one fetch of the losses a chain);
    step ms, tokens/s, MFU, peak GiB and launches a step of the timed
    chains."""
    import gc

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
    M.init_random_weights(model, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = T.AdamW(list(model.named_parameters()),
                  T.TrainConfig(warmup_steps=10))
    batch = M.make_example_batch(cfg, batch=BENCH_B, n_tiles=BENCH_TILES,
                                 seq_len=BENCH_S, seed=0, device=dev)
    run = T.make_chained_train_step(model, opt, chain)
    with capture():
        warm = run(batch).tolist()
    log(f"  {label}: init and warm chain {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e6:.1f} M params, warm losses "
        f"{[round(x, 5) for x in warm]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    times = []
    for _ in range(chains):
        t0 = time.perf_counter()
        losses = run(batch)
        losses[-1].item()          # the one fetch a chain
        times.append((time.perf_counter() - t0) / chain)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k.name: k.launches for k in kernels}
    per_step = {k: n / (chain * chains) for k, n in launches.items()}
    step = min(times)
    # one more step under the profiler: the device's time a step by kind,
    # against the unprofiled host-clock step (the rest is the device idle)
    one = T.make_chained_train_step(model, opt, 1)
    kinds, prof_wall = device_by_kind(torch, lambda: one(batch)[-1].item())
    device_ms = sum(kinds.values()) if kinds else None
    peak_flops = F.device_peak_flops(dev)
    flops = F.mllm_train_flops(cfg, BENCH_B, BENCH_S, BENCH_TILES)
    mfu = flops / step / peak_flops if peak_flops else None
    out = {"warm_losses": warm, "step_ms": step * 1e3,
           "step_ms_passes": [t * 1e3 for t in times],
           "tokens_per_s": BENCH_B * BENCH_S / step, "mfu": mfu,
           "peak_gib": peak, "launches": launches,
           "launches_per_step": per_step,
           "params_m": n_params / 1e6, "flops_per_step": flops,
           "device_ms": device_ms,
           "device_ms_by_kind": kinds,
           "busy_share": device_ms / (step * 1e3) if kinds else None}
    log(f"  {label}: step {step * 1e3:.2f} ms "
        f"({[round(t * 1e3, 2) for t in times]}), "
        f"{out['tokens_per_s']:,.0f} tokens/s, MFU "
        + (f"{100 * mfu:.2f}% of {peak_flops / 1e12:.1f} TFLOP/s"
           if mfu else "not measured (no peak for this card)")
        + f" ({flops / 1e12:.3f} TFLOP a step), peak {peak:.3f} GiB, "
        f"launches a step {per_step}; device time a step by torch.profiler "
        + (f"{device_ms:.2f} ms ({100 * out['busy_share']:.1f}% of the step; "
           + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
               kinds.items(), key=lambda kv: -kv[1])) + ")"
           if kinds else "not measured (the trace holds no device event)")
        + f", the profiled step {prof_wall:.2f} ms on the host clock; "
        f"{card_name_and_power_limit()}")
    del run, one, opt, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def flash_bwd_operands(A, got):
    """While the block runs, keep into `got` the operands of the first
    flash backward (K2/K3) call of each head dim: those of the LLM (hd
    128) and of the ViT (hd 64), as the train step hands them over."""
    bwd = A.flash_attention_bwd_cuda

    def keep(q, k, v, o, lse, do, causal, segment_ids=None):
        label = f"hd{q.shape[-1]}"
        if label not in got:
            got[label] = tuple(
                t if t is None or isinstance(t, bool) else t.clone()
                for t in (q, k, v, do, causal, segment_ids))
        return bwd(q, k, v, o, lse, do, causal, segment_ids)

    A.flash_attention_bwd_cuda = keep
    try:
        yield got
    finally:
        A.flash_attention_bwd_cuda = bwd


def flash_on_bench_operands(torch, A, got):
    """K1 and K2/K3 against their plain versions (`hold_flash`, the
    per-64-row-tile rule, max|err| within the unit-normal limit or twice
    the plain version's own) on the operands a bench step gave the flash
    backward (`flash_bwd_operands`); returns the largest max|err| by
    tensor."""
    worst = {}
    for label, (q, k, v, do, causal, seg) in sorted(got.items()):
        scale = max(1.0, v.float().abs().max().item())
        errs, _ = hold_flash(
            torch, A, f"K1/K2/K3 on the bench step's {label} operands, q "
            f"{tuple(q.shape)} kv {tuple(k.shape)}, dO max|x| "
            f"{do.float().abs().max().item():.3e}", q, k, v, do, causal,
            seg, v_scale=scale, plain_floor=True)
        for n, e in errs.items():
            worst[n] = max(worst.get(n, 0.0), e)
    return worst


def tiny_chain_card_vs_cpu(torch, M, T, policy):
    """The bench harness at the tiny f32 config with both towers
    rematerialised under `policy`: `make_example_batch` and
    BENCH_TINY_CHAIN chained steps on the CPU (plain versions) and on the
    card from the same weights; the losses and the first step's gradients
    must agree within TRAIN_REL, and each parameter's change over the
    chain within BENCH_TINY_UPDATE_REL of the CPU's, in norm."""
    import dataclasses

    base = M.with_dtype(M.tiny_config(), "float32")
    cfg = dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, remat=True,
                                      remat_policy=policy),
        llm=dataclasses.replace(base.llm, remat=True, remat_policy=policy))
    batch = M.make_example_batch(cfg, batch=2, n_tiles=2, seq_len=128,
                                 seed=1, device="cpu")
    tcfg = T.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                         total_steps=BENCH_TINY_CHAIN)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
        if dev == "cpu":
            M.init_random_weights(model, SEED)
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        opt = T.AdamW(list(model.named_parameters()), tcfg)
        first, update = [], opt.update

        def keep_first(grads, first=first, update=update):
            if not first:
                first.extend(g.detach().cpu().clone() for g in grads)
            return update(grads)

        opt.update = keep_first
        losses = T.make_chained_train_step(model, opt, BENCH_TINY_CHAIN)(
            {k: v.to(dev) for k, v in batch.items()})
        runs[dev] = (losses.cpu(), first, {
            k: v.detach().cpu() - init[k]
            for k, v in model.state_dict().items()})
    (l_c, g_c, d_c), (l_g, g_g, d_g) = runs["cpu"], runs["cuda"]
    loss = ((l_g - l_c).abs() / l_c.abs()).max().item()
    grads = max(((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(g_c, g_g))
    update = max(((d_g[k] - d_c[k]).norm() / d_c[k].norm()).item()
                 for k in d_c if d_c[k].norm() > 0)
    log(f"  tiny f32 under {policy}, {BENCH_TINY_CHAIN} chained steps, CPU "
        f"vs card: losses CPU {[round(x, 6) for x in l_c.tolist()]}; worst "
        f"relative difference: loss {loss:.3e}, first-step gradients "
        f"{grads:.3e} (tol {TRAIN_REL:g}), a parameter's change "
        f"{update:.3e} (tol {BENCH_TINY_UPDATE_REL:g})")
    if max(loss, grads) > TRAIN_REL or update > BENCH_TINY_UPDATE_REL:
        fail(f"the tiny chained steps under {policy} differ between the CPU "
             f"and the card")
    return {"loss": loss, "grads": grads, "update": update}


def phase_bench_train(torch, M, T, A, G, card):
    """Phase 22: the bench train step under the three remat policies, its
    K1 launches against the forward's attention calls, the chains' losses
    across policies, and the bench MoE (ragged, K8) under its policy."""
    import dataclasses

    from multi_spatialmllm_tpu_torch.utils import flops as F

    flash = [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV]
    base = M.bench_1chip_config()
    attn_calls = base.vit.num_layers + base.llm.num_layers
    runs, operands = {}, {}
    for policy in BENCH_POLICIES:
        cfg = dataclasses.replace(
            base, vit=dataclasses.replace(base.vit, remat_policy=policy),
            llm=dataclasses.replace(base.llm, remat_policy=policy))
        capture = contextlib.nullcontext
        if policy == base.llm.remat_policy:
            def capture():
                return flash_bwd_operands(A, operands)
        runs[policy] = bench_train(torch, M, T, F, cfg, flash,
                                   f"bench, remat_policy {policy}",
                                   BENCH_CHAIN, BENCH_CHAINS, capture)
        k1 = runs[policy]["launches_per_step"]["flash_fwd"]
        want = attn_calls * (1 if policy == "dots_and_flash_saveable" else 2)
        if k1 != want:
            fail(f"bench under {policy}: K1 launches a step {k1}, expected "
                 f"{want} ({attn_calls} attention calls a forward)")
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            if runs[policy]["launches_per_step"][k] != attn_calls:
                fail(f"bench under {policy}: {k} launches a step "
                     f"{runs[policy]['launches_per_step'][k]}")
    ref = runs[None]["warm_losses"]
    gap = max(abs(a - b) / abs(b) for r in runs.values()
              for a, b in zip(r["warm_losses"], ref))
    log(f"  the chains' losses across the three policies: largest relative "
        f"difference {gap:.3g} (limit {BENCH_LOSS_REL:g})")
    if not gap <= BENCH_LOSS_REL:
        fail(f"the policies' losses differ by {gap:.3g} relative")
    if sorted(operands) != ["hd128", "hd64"]:
        fail(f"the bench step's flash backward operands: {sorted(operands)}")
    flash_errs = flash_on_bench_operands(torch, A, operands)
    del operands
    torch.cuda.empty_cache()
    tiny = tiny_chain_card_vs_cpu(torch, M, T, base.llm.remat_policy)
    own = runs["dots_and_flash_saveable"]
    model_block = {"train_tokens_per_s": round(own["tokens_per_s"], 1),
                   "train_step_ms": round(own["step_ms"], 1),
                   "mfu": round(own["mfu"], 4) if own["mfu"] else None,
                   "params_m": round(own["params_m"])}
    log(f"  model block under bench.py's names (bench_1chip_config, its "
        f"dots_and_flash_saveable): {json.dumps(model_block)}; {card}")
    moe_cfg = M.bench_1chip_moe_config(impl="ragged", kernel="pallas")
    moe = bench_train(torch, M, T, F, moe_cfg,
                      flash + [G.GMM, G.GMM_T, G.TGMM],
                      f"bench MoE ragged/K8, remat_policy "
                      f"{moe_cfg.llm.remat_policy}", 1, MOE_BENCH_STEPS)
    if moe["launches_per_step"]["flash_fwd"] != attn_calls or min(
            moe["launches_per_step"][k] for k in ("gmm", "gmm_t",
                                                 "tgmm")) <= 0:
        fail(f"bench MoE launches a step {moe['launches_per_step']}")
    return {"runs": {str(k): v for k, v in runs.items()}, "moe": moe,
            "loss_gap": gap, "model": model_block, "flash_errs": flash_errs,
            "tiny": tiny}


# phase 23: the data axis
# phase 24: losses and gradient norms of a mesh run against the run
# without a group, bf16 compute: TP sums the row-parallel partials in bf16
# and the ring merges per-block outputs. Sound runs read at most 1.1e-4 on
# the losses; a dropped or doubled partial sum moves them by more.
MESH_LOSS_REL = 1e-3
MESH_GNORM_REL = 1e-2
MESH_STEPS = 3           # the third step's loss follows an update
# (c) computes in float32: in bf16 a routing near tie moves a router's
# gradient by up to 13% and the run parts after the first update, while in
# float32 every parameter's first gradient holds within 8.7e-6 of the run
# without a group (scripts/torch_mesh_moe_dtype_check.py); each within
# MESH_FIRST_GRAD_REL
MESH_MOE_DTYPE = "float32"
MESH_FIRST_GRAD_REL = 1e-3
# (c)'s batch: rows, tiles a row, tokens a row, cut from bench.py's 4, 2,
# 2,048 for time (float32 products and K8's float32 form are 4-8x the
# bf16 step's time)
MESH_MOE_BATCH = (2, 1, 512)
# (d): the share of the sharded run's tokens that the whole model picks
# under teacher forcing (bf16 near ties may flip; int8 kv adds its
# rounding against the bf16-kv model that judges it)
MESH_AGREE_MIN, MESH_AGREE_MIN_INT8 = 0.9, 0.8
# (a), (b): the depth phase 9's widths are cut to: gloo carries 0.4-1.1
# GB/s on the card (scripts/torch_gloo_cuda_probe.py), and FSDP moves the
# f32 parameters and gradients through it every step
MESH_LAYERS, MESH_VIT_LAYERS = 1, 6
# (d): requests (two a shared image and prefix), cut from phase 6's 16 for
# time, and new tokens a request
N_MESH_SERVE, MESH_NEW_TOKENS = 8, 32
# (c) and (d): depth cut for time (the bench MoE has 8 decoder layers, the
# flagship 32; widths as they are)
MESH_MOE_LAYERS, MESH_SERVE_LAYERS = 4, 8
# phase 25 (a): the flagship's widths with the LLM cut to 2 layers a stage
# and the ViT to phase 24's depth; make_example_batch's rows, tiles a row
# and tokens a row, and the microbatches
PIPE_LAYERS, PIPE_VIT_LAYERS = 4, MESH_VIT_LAYERS
PIPE_BATCH = (4, 2, 2048)
PIPE_MICRO = 4
# (b): the tiny config's decoder depth, its meshes, and the JAX pipeline
# tests' bounds (tests/test_pipeline_parallel.py)
PIPE_TINY_LAYERS = 4
PIPE_TINY_MESHES = {"pipe 4": dict(n_stages=4),
                    "(data 2 x pipe 2)": dict(n_stages=2, n_data=2),
                    "(model 2 x pipe 2)": dict(n_stages=2, n_model=2)}
PIPE_LOSS_RTOL, PIPE_GRAD_ATOL = 1e-5, 3e-5
DP_STEPS = 3             # the third step's loss follows an update
DP_LOSS_REL = 1e-6       # world 1 against the same run without a group
STAGE_PDB = 4            # the scene-parallel stages' per_device_batch


def phase23_scenes(make_scene, n_corpus, real):
    """The bench corpus (`n_corpus` scenes) and, last, the real-scale
    scene (`real`, make_scene's arguments)."""
    return ([corpus_scene(make_scene, i) for i in range(n_corpus)]
            + [make_scene(**real)])


@contextlib.contextmanager
def timed_exchange(seconds):
    """Within the block every scene-parallel stage's exchange appends its
    seconds to `seconds`."""
    from multi_spatialmllm_tpu_torch.stages import frame_relations, visibility

    mods = (visibility, frame_relations)
    inner = visibility.exchange

    def wrapped(payload, group):
        t0 = time.perf_counter()
        out = inner(payload, group)
        seconds.append(time.perf_counter() - t0)
        return out

    for m in mods:
        m.exchange = wrapped
    try:
        yield
    finally:
        for m in mods:
            m.exchange = inner


def stage_digests(scenes, mesh, device, real_id=REAL_SCENE["scene_id"]):
    """The four data-engine stages over `scenes` on `device`: scene-
    parallel over `mesh`'s data axis, or the single-device stages when
    `mesh` is None. Returns ({scene_id: SHA-256 of its visibility,
    relations, object visibility, coverage intervals and coverage search},
    seconds by stage, the real-scale scene's packed-label digest)."""
    import hashlib

    import numpy as np

    from multi_spatialmllm_tpu_torch.stages import coverage as COV
    from multi_spatialmllm_tpu_torch.stages import frame_relations as FR
    from multi_spatialmllm_tpu_torch.stages import object_visibility as OV
    from multi_spatialmllm_tpu_torch.stages import visibility as V

    import torch

    gen, _ = visibility_golden()
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    kw = dict(per_device_batch=STAGE_PDB, device=device)
    if mesh is None:
        vis = timed("visibility", lambda: {
            s.scene_id: V.compute_scene_visibility(s, device=device)
            for s in scenes})
        rel = timed("relations", lambda: {
            s.scene_id: FR.compute_scene_relations(
                s, vis=vis[s.scene_id], device=device) for s in scenes})
        ovis = timed("object_visibility", lambda: OV.build_object_visibility(
            scenes, visibility=vis, device=device))
        intervals = timed("coverage_intervals", lambda: {
            s.scene_id: COV.object_coverage_intervals(
                s, vis[s.scene_id], device=device) for s in scenes})
        cov = timed("coverage", lambda: COV.build_object_coverage(
            scenes, ovis, visibility=vis, device=device))
    else:
        vis = timed("visibility", lambda: V.compute_visibility_multichip(
            scenes, mesh, **kw))
        rel = timed("relations", lambda: FR.compute_relations_multichip(
            scenes, mesh, vis, **kw))
        ovis = timed("object_visibility",
                     lambda: OV.object_visibility_multichip(
                         scenes, mesh, vis, **kw))
        intervals = timed("coverage_intervals",
                          lambda: COV.coverage_intervals_multichip(
                              scenes, mesh, vis, **kw))
        cov = timed("coverage", lambda: COV.build_object_coverage(
            scenes, ovis, visibility=vis, device=device, mesh=mesh))
    def feed(h, obj):
        # values, types and order; not object identity, which a pickle's
        # memo would record (an exchanged array holds its own dtype)
        if isinstance(obj, np.ndarray):
            h.update(f"array {obj.dtype} {obj.shape}:".encode())
            h.update(np.ascontiguousarray(obj).tobytes())
        elif isinstance(obj, dict):
            h.update(f"dict {len(obj)}:".encode())
            for k, v in obj.items():
                feed(h, k)
                feed(h, v)
        elif isinstance(obj, (list, tuple)):
            h.update(f"{type(obj).__name__} {len(obj)}:".encode())
            for v in obj:
                feed(h, v)
        else:
            h.update(f"{type(obj).__name__} {obj!r};".encode())

    digests = {}
    for s in scenes:
        sid = s.scene_id
        h = hashlib.sha256()
        feed(h, (vis[sid], sorted(rel[sid].items()), ovis[sid],
                 intervals[sid], tuple(c[sid] for c in cov)))
        digests[sid] = h.hexdigest()
    real = gen.packed_digest(vis[real_id])
    return digests, secs, real


def stage_world(device, n_corpus, real):
    """One process of the gloo world of phase 23 (a): the scene-parallel
    stages over the world's mesh on `device` (`phase23_scenes`'
    arguments); per-scene digests, seconds by stage, the exchanges'
    seconds."""
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh

    scenes = phase23_scenes(make_scene, n_corpus, real)
    mesh = make_mesh()
    seconds = []
    with timed_exchange(seconds):
        digests, secs, real = stage_digests(scenes, mesh, device)
    return dict(digests=digests, secs=secs, real=real,
                exchange_s=sum(seconds), exchanges=len(seconds))


def flagship_cut(M, layers, vit_layers=None):
    """The flagship config with its LLM cut to `layers` layers (and its ViT
    to `vit_layers`, when given): every width as it is."""
    import dataclasses

    cfg = M.flagship_config()
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(
            cfg.vit, num_layers=vit_layers or cfg.vit.num_layers),
        llm=dataclasses.replace(cfg.llm, num_layers=layers))


@contextlib.contextmanager
def flagship_cut_to(M, layers, vit_layers=None):
    """The CLI's `flagship` config cut as `flagship_cut` cuts it."""
    full = M.CONFIGS["flagship"]
    M.CONFIGS["flagship"] = lambda: flagship_cut(M, layers, vit_layers)
    try:
        yield
    finally:
        M.CONFIGS["flagship"] = full


@contextlib.contextmanager
def launcher_env(port):
    """The environment `python -m torch.distributed.run --nproc-per-node
    1` gives its one worker."""
    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_stage_world(name, got, want, want_real, golden_real, n):
    bad = [sid for sid, d in want.items() if got["digests"].get(sid) != d]
    if bad or set(got["digests"]) != set(want):
        fail(f"{name}: scene-parallel results differ from the "
             f"single-device stages' for {bad[:5]} ({len(bad)} scenes)")
    if got["real"] != want_real or got["real"] != golden_real:
        fail(f"{name}: real-scale labels {got['real']} are not the JAX "
             f"CPU float64 digest {golden_real}")
    total = sum(got["secs"].values())
    log(f"  {name}: {n} scenes byte-equal to the single-device stages, "
        f"real-scale labels = the JAX digest; "
        f"{ {k: round(v, 3) for k, v in got['secs'].items()} } s, "
        f"{total / n:.4f} s a scene; {got['exchanges']} exchanges "
        f"{got['exchange_s']:.3f} s")
    return {"secs": got["secs"], "s_per_scene": total / n,
            "exchange_s": got["exchange_s"], "exchanges": got["exchanges"]}


def dp_train_argv(meta, moe):
    """The train CLI's flags for phase 23 (b): phase 9's configuration
    (flagship widths, the CLI's flagship cut by `flagship_cut_to`), or
    phase 13's bench MoE."""
    common = ["--meta", meta, "--packed", "--seq-len", "4096",
              "--batch-size", "2", "--accum", "2", "--log-every", "1",
              "--seed", str(SEED), "--device", "cuda"]
    if moe:
        return [*common, "--config", "bench", "--moe-experts", "4",
                "--moe-impl", "ragged", "--moe-kernel", "pallas", "--steps",
                str(DP_STEPS), "--max-tiles", str(MOE_MAX_TILES),
                "--tiles-per-image", str(MOE_TILES_PER_IMAGE)]
    return [*common, "--config", "flagship", "--steps", str(DP_STEPS),
            "--max-tiles", "6", "--tiles-per-image", "6"]


def dp_train(torch, cli, M, argv, kernels, label):
    """`train` through the CLI in this process (a group, when the caller
    holds one, is the data axis); every loss finite and every kernel of
    `kernels` launched. Returns (summary, launches, history)."""
    import gc

    t0 = time.perf_counter()
    with flagship_cut_to(M, TRAIN_LAYERS):
        summary, _, seen, _ = train_cli(torch, cli, argv, kernels)
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    history, launches = seen["history"], seen["launches"]
    losses = [h["loss"] for h in history]
    log(f"  {label}: {summary} in {wall:.1f} s; losses {losses}; step "
        f"seconds {[round(h['step_s'], 4) for h in history]}; peak "
        f"{seen['peak']:.3f} GiB; launches {launches}; "
        f"{card_name_and_power_limit()}")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail(f"{label}: a loss is not finite: {losses}")
    if min(launches.values()) <= 0:
        fail(f"{label}: a kernel never launched: {launches}")
    return summary, launches, history


def phase_data_axis(torch, cli, M, card, kernels, moe_kernels):
    """Phase 23: the scene-parallel stages at world 1 (NCCL, this
    process) and 2 (gloo, two processes), data-parallel training through
    the CLI at world 1, and the drill at smoke scale."""
    import importlib.util
    import tempfile

    import torch.distributed as dist

    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.dryrun import free_port, run_world
    from multi_spatialmllm_tpu_torch.parallel.distributed import (
        initialize_multihost,
    )
    from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh

    _, golden = visibility_golden()
    golden_real = golden["float64_packed_sha256"]
    t0 = time.perf_counter()
    scenes = phase23_scenes(make_scene, N_CORPUS, REAL_SCENE)
    n = len(scenes)
    log(f"  {n} scenes (the bench corpus and the real-scale scene) made in "
        f"{time.perf_counter() - t0:.1f} s")
    want, single_secs, want_real = stage_digests(scenes, None, "cuda")
    if want_real != golden_real:
        fail(f"single-device real-scale labels {want_real} are not the JAX "
             f"CPU float64 digest {golden_real}")
    single_total = sum(single_secs.values())
    log(f"  single-device stages: "
        f"{ {k: round(v, 3) for k, v in single_secs.items()} } s, "
        f"{single_total / n:.4f} s a scene; {card}")
    out = {"single": {"secs": single_secs, "s_per_scene": single_total / n}}

    with tempfile.TemporaryDirectory() as tmp:
        meta = write_repeat_mixture(os.path.join(tmp, "dense"), 64)
        ref, _, ref_hist = dp_train(torch, cli, M, dp_train_argv(meta, False),
                                    kernels, "train, no group")
        moe_ref, _, moe_ref_hist = dp_train(
            torch, cli, M, dp_train_argv(meta, True), kernels + moe_kernels,
            "bench MoE train, no group")
        with launcher_env(free_port()):
            initialize_multihost(device="cuda")
            try:
                if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
                    fail(f"world 1: backend {dist.get_backend()}, size "
                         f"{dist.get_world_size()}")
                mesh = make_mesh()
                seconds = []
                with timed_exchange(seconds):
                    digests, secs, real = stage_digests(scenes, mesh, "cuda")
                out["world1"] = check_stage_world(
                    "scene-parallel, world 1 (NCCL)",
                    dict(digests=digests, secs=secs, real=real,
                         exchange_s=sum(seconds), exchanges=len(seconds)),
                    want, want_real, golden_real, n)
                dp, dp_launches, dp_hist = dp_train(
                    torch, cli, M,
                    [*dp_train_argv(meta, False), "--data-parallel", "1"],
                    kernels, "train --data-parallel 1 (NCCL)")
                moe, moe_launches, moe_hist = dp_train(
                    torch, cli, M,
                    [*dp_train_argv(meta, True), "--data-parallel", "1"],
                    kernels + moe_kernels,
                    "bench MoE train --data-parallel 1 (NCCL)")
            finally:
                dist.destroy_process_group()
    loss_diffs = {}
    for label, run, hist, ref_h in (
            ("train", dp, dp_hist, ref_hist),
            ("bench MoE train", moe, moe_hist, moe_ref_hist)):
        if run["mesh"] != {"data": 1, "model": 1} or run["devices"] != 1:
            fail(f"{label} --data-parallel 1: mesh {run['mesh']}, devices "
                 f"{run['devices']}")
        diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(hist, ref_h)]
        log(f"  {label} --data-parallel 1 against no group: losses "
            f"{[h['loss'] for h in hist]} vs {[h['loss'] for h in ref_h]}, "
            f"relative differences {diffs} (limit {DP_LOSS_REL:g}); "
            f"summary mesh {run['mesh']}, devices {run['devices']}")
        if len(diffs) != DP_STEPS or max(diffs) > DP_LOSS_REL:
            fail(f"{label} --data-parallel 1: losses {diffs} relative from "
                 f"the run without a group")
        if ref_h[-1]["loss"] == ref_h[0]["loss"]:
            fail(f"{label}: the last loss equals the first, so no update "
                 f"was seen: {[h['loss'] for h in ref_h]}")
        loss_diffs[label] = diffs
    out.update(dp_launches=dp_launches, moe_launches=moe_launches,
               loss_diffs=loss_diffs, dp_summary=dp, ref_summary=ref,
               moe_summary=moe, moe_ref_summary=moe_ref)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_world(2, "chip_smoke:stage_world",
                      ("cuda", N_CORPUS, REAL_SCENE), device="cpu",
                      timeout=600)
    wall = time.perf_counter() - t0
    got = max(ranks, key=lambda r: sum(r["secs"].values()))
    for r, res in enumerate(ranks):
        if res["digests"] != ranks[0]["digests"]:
            fail(f"world 2: rank {r}'s results differ from rank 0's")
    out["world2"] = check_stage_world(
        "scene-parallel, world 2 (gloo, two processes on the card)", got,
        want, want_real, golden_real, n)
    out["world2"]["wall_s"] = wall
    log(f"  world 2: the two processes started, ran and ended in "
        f"{wall:.1f} s; {card}")

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "gen_drill_golden.py")
    spec = importlib.util.spec_from_file_location("gen_drill_golden", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "drill")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, gen.DRILL, "--scale", "smoke", "--root", root],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"the drill failed: {proc.stdout[-2000:]}"
                 f"{proc.stderr[-2000:]}")
        with open(os.path.join(root, "torch_volume_drill.json")) as f:
            report = json.load(f)
        diff = gen.differences(gen.summary(root), gen.load())
    brief = {k: v for k, v in report.items()
             if k not in ("per_engine", "units_at_kill", "digests")}
    log(f"  drill at smoke scale on the card in "
        f"{time.perf_counter() - t0:.1f} s: {brief}")
    if not report["killed_mid_run"] or report["units_rerun"]:
        fail(f"the drill: killed {report['killed_mid_run']}, re-run "
             f"{report['rerun']}")
    if diff:
        fail(f"the drill's files differ from the CPU campaign's: "
             f"{diff[:10]} ({len(diff)})")
    log(f"  drill: {len(report['digests'])} files equal to the CPU "
        f"campaign's stored digests (the relation parquets by column, "
        f"distance and angles within phase 15's ulp limits); {card}")
    out["drill"] = brief
    return out


def mesh_train_parts(meta):
    """(key, label, train argv, LLM layers) of phase 24's (a) and (b) and of
    the runs without a group they are held to: phase 9's flags (the
    CLI's flagship, packed 4096-token rows, batch 2), with the mesh's."""
    common = ["--meta", meta, "--seq-len", "4096", "--batch-size", "2",
              "--log-every", "1", "--seed", str(SEED), "--device", "cuda",
              "--config", "flagship", "--max-tiles", "6",
              "--tiles-per-image", "6"]
    packed = [*common, "--packed", "--steps", str(MESH_STEPS)]
    seq = [*common, "--steps", str(MESH_STEPS)]
    return {
        "ref": ("train, no group", [*packed, "--accum", "2"]),
        "tp": ("train --model-parallel 2", [*packed, "--accum", "2",
                                           "--model-parallel", "2"]),
        "fsdp": ("train --fsdp --data-parallel 2",
                 [*packed, "--fsdp", "--data-parallel", "2"]),
        "seq_ref": ("train unpacked, no group", seq),
        "seq": ("train unpacked --seq-parallel 2",
                [*seq, "--seq-parallel", "2"])}


def mesh_train(torch, cli, M, argv, kernels):
    """`train` through the CLI in this process at the flagship's widths cut
    to MESH_LAYERS LLM and MESH_VIT_LAYERS ViT layers -> what the steps
    did: losses, launches, peak GiB, steady step seconds, the summary
    (process 0's; None on the others) and the gloo transport's staged
    bytes and seconds."""
    import gc
    import io

    from multi_spatialmllm_tpu_torch.parallel import sharding as S

    S.reset_staged()
    t0 = time.perf_counter()
    with flagship_cut_to(M, MESH_LAYERS, MESH_VIT_LAYERS), \
            watched_train_steps(torch, cli, kernels) as seen:
        lines = cli_run(cli, ["train", *argv], err=io.StringIO())
    wall = time.perf_counter() - t0
    # process 0 alone prints the summary
    summary = json.loads(lines[-1]) if lines else None
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=[h["loss"] for h in seen["history"]],
                grad_norms=[h["grad_norm"] for h in seen["history"]],
                step_s=[h["step_s"] for h in seen["history"]],
                launches=seen["launches"], peak=seen["peak"], wall=wall,
                summary=summary, staged=dict(S.STAGED))


def mesh_moe(torch, M, T, impl, mesh_kw, kernels):
    """The bench MoE (4 experts; `impl` einsum, or ragged with K8; both
    towers in MESH_MOE_DTYPE) for MESH_STEPS steps of `make_train_step` on
    bench.py's example batch at MESH_MOE_BATCH (rows, tiles a row, tokens
    a row), on the mesh `mesh_kw` or without a group. `first_grads`: the norm of each
    parameter's first gradient, clipped (AdamW's first moment after the
    first update, whose rate is 0, over 1 - b1), its shards' squares summed
    over the group that shards it."""
    import dataclasses
    import gc

    from multi_spatialmllm_tpu_torch.parallel import sharding as S
    from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh

    S.reset_staged()
    t0 = time.perf_counter()
    cfg = M.with_dtype(M.bench_1chip_moe_config(
        impl=impl, kernel="pallas" if impl == "ragged" else "xla"),
        MESH_MOE_DTYPE)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=MESH_MOE_LAYERS))
    model = M.MultiFrameMLLM(cfg, device="cuda", param_dtype=torch.float32)
    M.init_random_weights(model, SEED)
    mesh = make_mesh(**mesh_kw) if mesh_kw else None
    plan = S.shard_model(model, mesh) if mesh is not None else None
    opt = T.AdamW(list(model.named_parameters()), T.TrainConfig(
        learning_rate=1e-5, warmup_steps=1, total_steps=MESH_STEPS))
    step = T.make_train_step(model, opt, mesh=mesh)
    rows, tiles, tokens = MESH_MOE_BATCH
    batch = M.make_example_batch(cfg, batch=rows, n_tiles=tiles,
                                 seq_len=tokens, device="cuda")
    if mesh is not None:
        batch = T.local_rows(batch, 1, mesh)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, grad_norms, step_s = [], [], []
    for _ in range(MESH_STEPS):
        t1 = time.perf_counter()
        metrics = step(batch)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t1)
        if len(losses) == 1:
            sq = {n: m.square().sum() for n, m in zip(opt.names, opt.mu)}
            if plan is not None:
                for n, v in sq.items():
                    S.all_reduce_(v, plan.norm_group(n))
            first = {n: float(v.sqrt()) / (1 - opt.cfg.b1)
                     for n, v in sq.items()}
    out = dict(losses=losses, grad_norms=grad_norms, step_s=step_s,
               first_grads=first,
               launches={k.name: k.launches for k in kernels},
               peak=torch.cuda.max_memory_allocated() / 2**30,
               wall=time.perf_counter() - t0, staged=dict(S.STAGED))
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_serve(torch, M, K, reqs, ids, kernels, mesh_kw):
    """The flagship in bf16 at full depth (seeded weights), on the mesh
    `mesh_kw` or whole, serving `reqs` on the paged batcher with the
    prefix cache (and chunked prefill, which resumes a shared prefix whose
    next page still holds image tokens), bf16 kv then int8 kv -> tokens,
    launches, stats and
    decode tokens/s of each, and the model (for the caller's teacher
    forcing; None on a mesh)."""
    import gc

    import numpy as np

    from multi_spatialmllm_tpu_torch.parallel import sharding as S
    from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    model = M.MultiFrameMLLM(flagship_cut(M, MESH_SERVE_LAYERS),
                             device="cuda")
    M.init_random_weights(model, SEED)
    model.eval()
    if mesh_kw:
        S.shard_model(model, make_mesh(**mesh_kw))
    out = {"build_s": time.perf_counter() - t0}
    for kv in ("native", "int8"):
        pcfg = K.PagedConfig(slots=8, page_size=64, num_pages=256,
                             max_prompt_len=2048,
                             max_new_tokens=MESH_NEW_TOKENS,
                             prefix_cache=True, prefill_chunk=256,
                             kv_dtype=kv)
        batcher = K.PagedBatcher(model, pcfg, pad_id=ids[0], eos_id=ids[1])
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        tokens = [np.asarray(t).tolist() for t in batcher.generate_all(reqs)]
        torch.cuda.synchronize()
        st = dict(batcher.stats)
        out[kv] = dict(tokens=tokens, wall=time.perf_counter() - t1,
                       launches={k.name: k.launches for k in kernels},
                       stats=st, peak=torch.cuda.max_memory_allocated()
                       / 2**30,
                       decode_tok_s=st["decode_tokens"]
                       / max(st["decode_seconds"], 1e-9))
        del batcher
        gc.collect()
        torch.cuda.empty_cache()
    if mesh_kw:
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = None
    return out, model


def mesh_world(meta, reqs, ids):
    """One of phase 24's two processes (gloo, both computing on card 0):
    (a) and (b) through the train CLI, (c) the bench MoE, (d) sharded
    serving; everything it measured."""
    import torch

    from multi_spatialmllm_tpu_torch import __main__ as cli
    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.models import paged_kv as K
    from multi_spatialmllm_tpu_torch.ops import attention as A
    from multi_spatialmllm_tpu_torch.ops import grouped_matmul as G
    from multi_spatialmllm_tpu_torch.ops import paged_attention as P
    from multi_spatialmllm_tpu_torch.parallel import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV]
    parts = mesh_train_parts(meta)
    out = {}
    t0 = time.perf_counter()

    def done(key):       # progress in the process's log
        log(f"{key} done at {time.perf_counter() - t0:.1f} s: "
            f"{ {k: v for k, v in out[key].items() if k != 'summary'} }")

    for key in ("tp", "fsdp", "seq"):
        out[key] = mesh_train(torch, cli, M, parts[key][1], flash)
        done(key)
    out["ep_einsum"] = mesh_moe(torch, M, T, "einsum",
                                dict(n_data=1, n_expert=2), flash)
    done("ep_einsum")
    out["tp_ragged"] = mesh_moe(torch, M, T, "ragged",
                                dict(n_data=1, n_model=2),
                                flash + [G.GMM, G.GMM_T, G.TGMM])
    done("tp_ragged")
    out["serve"], _ = mesh_serve(
        torch, M, K, reqs, ids,
        [A.FLASH_FWD, P.PAGED_DECODE, P.PAGED_DECODE_INT8],
        dict(n_data=1, n_model=2))
    done("serve")
    return out


def loss_rel(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def phase_mesh(torch, cli, M, K, T, tok, card, flash, serve_kernels):
    """Phase 24 (see the module docstring): the references in this
    process, then one world of two gloo processes on the card."""
    import gc
    import tempfile

    from multi_spatialmllm_tpu_torch.dryrun import run_world
    from multi_spatialmllm_tpu_torch.ops import grouped_matmul as G

    cfg = M.flagship_config()
    reqs = K.make_serve_requests(cfg, N_MESH_SERVE, seed=SEED + 5,
                                 questions_per_image=2)
    ids = (tok.pad_id, tok.eos_id)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        meta = write_repeat_mixture(os.path.join(tmp, "repeat"), 64)
        parts = mesh_train_parts(meta)
        t0 = time.perf_counter()
        ref = {key: mesh_train(torch, cli, M, parts[key][1], flash)
               for key in ("ref", "seq_ref")}
        ref["ep_einsum"] = mesh_moe(torch, M, T, "einsum", None, flash)
        ref["tp_ragged"] = mesh_moe(torch, M, T, "ragged", None,
                                    flash + [G.GMM, G.GMM_T, G.TGMM])
        ref["serve"], model = mesh_serve(torch, M, K, reqs, ids,
                                         serve_kernels, None)
        log(f"  the runs without a group took {time.perf_counter() - t0:.1f}"
            f" s")
        t0 = time.perf_counter()
        del model        # the world's processes need the card's memory
        gc.collect()
        torch.cuda.empty_cache()
        ranks = run_world(2, "chip_smoke:mesh_world", (meta, reqs, ids),
                          device="cpu", timeout=600)
        out["world_wall"] = time.perf_counter() - t0
    world = ranks[0]
    for key, label, against in (
            ("tp", "(a) --model-parallel 2", "ref"),
            ("fsdp", "(a) --fsdp --data-parallel 2", "ref"),
            ("seq", "(b) --seq-parallel 2, unpacked", "seq_ref"),
            ("ep_einsum", "(c) bench MoE f32 einsum, 2 expert",
             "ep_einsum"),
            ("tp_ragged", "(c) bench MoE f32 ragged + K8, 2 model",
             "tp_ragged")):
        got, want = world[key], ref[against]
        diffs = loss_rel(got["losses"], want["losses"])
        gdiffs = loss_rel(got["grad_norms"], want["grad_norms"])
        steps = len(got["losses"])
        per_step = {k: v / steps for k, v in got["launches"].items()}
        log(f"  {label}: losses {got['losses']} vs {want['losses']} "
            f"without a group, relative {diffs} (limit {MESH_LOSS_REL:g}); "
            f"grad norms {got['grad_norms']} vs {want['grad_norms']}, "
            f"relative {gdiffs} (limit {MESH_GNORM_REL:g}); "
            f"step s {[round(x, 4) for x in got['step_s']]} vs "
            f"{[round(x, 4) for x in want['step_s']]}; launches a step "
            f"{per_step} (no group: "
            f"{ {k: v / steps for k, v in want['launches'].items()} }); "
            f"peak {[round(r[key]['peak'], 3) for r in ranks]} GiB a "
            f"process (no group {want['peak']:.3f}); staged "
            f"{got['staged']}; part {got['wall']:.1f} s; {card}")
        if any(r[key]["losses"] != got["losses"]
               or r[key]["grad_norms"] != got["grad_norms"] for r in ranks):
            fail(f"{label}: the processes' losses or grad norms differ")
        if want["losses"][-1] == want["losses"][0]:
            fail(f"{label}: no update seen: the run without a group ends "
                 f"at its first loss {want['losses']}")
        if len(diffs) != MESH_STEPS or max(diffs) > MESH_LOSS_REL:
            fail(f"{label}: losses {diffs} relative from the run without "
                 f"a group")
        if len(gdiffs) != MESH_STEPS or max(gdiffs) > MESH_GNORM_REL:
            fail(f"{label}: grad norms {gdiffs} relative from the run "
                 f"without a group")
        if "first_grads" in want:
            first = {n: abs(got["first_grads"][n] - g) / g
                     for n, g in want["first_grads"].items() if g > 0}
            worst = max(first, key=first.get)
            log(f"  {label}: {len(first)} first gradients' norms, the "
                f"farthest {worst} at {first[worst]:.3g} relative (limit "
                f"{MESH_FIRST_GRAD_REL:g})")
            if (set(got["first_grads"]) != set(want["first_grads"])
                    or first[worst] > MESH_FIRST_GRAD_REL):
                fail(f"{label}: first gradient of {worst} "
                     f"{first[worst]:.3g} relative from the run without a "
                     f"group")
        if min(got["launches"].values()) <= 0:
            fail(f"{label}: a kernel never launched: {got['launches']}")
        out[key] = dict(got, diffs=diffs, gnorm_diffs=gdiffs, ref=want)
    serve = world["serve"]
    out["serve"] = {}
    for kv in ("native", "int8"):
        got, want = serve[kv], ref["serve"][kv]
        equal = sum(a == b for a, b in zip(got["tokens"], want["tokens"]))
        pos = sum(min(len(a), len(b)) for a, b in zip(got["tokens"],
                                                      want["tokens"]))
        same = sum(x == y for a, b in zip(got["tokens"], want["tokens"])
                   for x, y in zip(a, b))
        log(f"  (d) flagship bf16 ({MESH_SERVE_LAYERS} layers) under 2 "
            f"model, {kv} kv: "
            f"{len(got['tokens'])} requests, {equal} token streams equal to "
            f"the run without a group, {same}/{pos} tokens at common "
            f"positions; decode {got['decode_tok_s']:.1f} tokens/s "
            f"(whole model {want['decode_tok_s']:.1f}); launches "
            f"{got['launches']} (whole {want['launches']}); stats "
            f"{got['stats']}; peak {[round(r['serve'][kv]['peak'], 3) for r in ranks]} "
            f"GiB a process (whole {want['peak']:.3f}); {card}")
        if any(r["serve"][kv]["tokens"] != got["tokens"] for r in ranks):
            fail(f"(d) {kv}: the processes' tokens differ")
        if got["stats"]["pages_reused"] <= 0:
            fail(f"(d) {kv}: the prefix cache reused no page")
        kern = "paged_decode" if kv == "native" else "paged_decode_int8"
        if got["launches"][kern] <= 0 or got["launches"]["flash_fwd"] <= 0:
            fail(f"(d) {kv}: K1 or K7 never launched: {got['launches']}")
        out["serve"][kv] = dict(got, equal_streams=equal, same_tokens=same,
                                positions=pos, ref=want)
    agreement = teacher_forced_agreement(
        torch, M, reqs, [serve[kv]["tokens"] for kv in ("native", "int8")])
    out["serve_agreement"] = {kv: f"{a}/{n}" for kv, (a, n)
                              in zip(("native", "int8"), agreement)}
    log(f"  (d) teacher-forced agreement of the sharded run's tokens under "
        f"the whole model (bf16 kv): {out['serve_agreement']} (floors "
        f"{MESH_AGREE_MIN:g} bf16 kv, {MESH_AGREE_MIN_INT8:g} int8 kv); "
        f"world {out['world_wall']:.1f} s; {card}")
    for kv, (a, n), floor in zip(("native", "int8"), agreement,
                                 (MESH_AGREE_MIN, MESH_AGREE_MIN_INT8)):
        if a < floor * n:
            fail(f"(d) {kv} kv: the whole model picks {a}/{n} of the "
                 f"sharded run's tokens, under the floor {floor:g}")
    return out


def teacher_forced_agreement(torch, M, reqs, token_sets):
    """For each run's tokens (`token_sets`, one list a request each), how
    many the whole model's full causal forward over prompt + tokens picks
    (bf16 near ties may flip) and how many there are."""
    import gc

    model = M.MultiFrameMLLM(flagship_cut(M, MESH_SERVE_LAYERS),
                             device="cuda")
    M.init_random_weights(model, SEED)
    model.eval()
    out = []
    with torch.no_grad():
        for tokens in token_sets:
            agree = total = 0
            for (ids, tiles), toks in zip(reqs, tokens):
                seq = torch.tensor([list(map(int, ids)) + toks],
                                   device="cuda")
                logits = model(seq, torch.from_numpy(tiles)[None].cuda())
                if not torch.isfinite(logits).all():
                    fail("(d) non-finite logits at the flagship width")
                pred = logits[0, len(ids) - 1:-1].argmax(-1).tolist()
                agree += sum(int(a == b) for a, b in zip(pred, toks))
                total += len(toks)
            out.append((agree, total))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_configs(M):
    """Phase 25's models: (a) the flagship cut to PIPE_LAYERS LLM and
    PIPE_VIT_LAYERS ViT layers, (b) the tiny config in float32 with
    PIPE_TINY_LAYERS decoder layers."""
    import dataclasses

    tiny = M.with_dtype(M.tiny_config(), "float32")
    return (flagship_cut(M, PIPE_LAYERS, PIPE_VIT_LAYERS),
            dataclasses.replace(tiny, llm=dataclasses.replace(
                tiny.llm, num_layers=PIPE_TINY_LAYERS)))


def pipe_batch(M, cfg, tiny):
    rows, tiles, tokens = (8, 1, 32) if tiny else PIPE_BATCH
    return M.make_example_batch(cfg, batch=rows, n_tiles=tiles,
                                seq_len=tokens, device="cuda")


def pipe_reference(torch, M, cfg, tiny):
    """The model of `cfg` (seeded weights, float32 master weights) without
    a group: `loss_fn` and its backward on the card -> (loss, {name:
    gradient on the host} for the tiny model, else {name: its norm}, the
    state for the tiny model)."""
    import gc

    model = M.MultiFrameMLLM(cfg, device="cuda", param_dtype=torch.float32)
    M.init_random_weights(model, SEED)
    loss = M.loss_fn(model, pipe_batch(M, cfg, tiny))
    loss.backward()
    grads = {n: p.grad.cpu() if tiny else float(p.grad.norm())
             for n, p in model.named_parameters()}
    state = {k: v.cpu() for k, v in model.state_dict().items()} if tiny \
        else None
    value = float(loss.detach())
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()
    return value, grads, state


@contextlib.contextmanager
def pipe_spans(torch, PM, model):
    """Seconds of a pipeline call's parts, each synchronised: the preamble's
    forward (stage 0), the 1F1B schedule and the broadcasts of the
    preamble's, the loss's and the head's gradients."""
    spans = {}
    parts = {"schedule": (PM, "one_f_one_b"),
             "broadcasts": (PM, "broadcast_all_"),
             "preamble": (model, "spliced_embeds")}
    saved = {k: getattr(o, a) for k, (o, a) in parts.items()}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for name, (obj, attr) in parts.items():
        setattr(obj, attr, timed(name, saved[name]))
    try:
        yield spans
    finally:
        PM.one_f_one_b = saved["schedule"]
        PM.broadcast_all_ = saved["broadcasts"]
        del model.spliced_embeds        # the class's method again


def pipe_world(tiny, state=None):
    """One process of phase 25's world (gloo, computing on card 0): (a)
    the flagship cut over 2 pipe stages, its loss, launches, staged
    transfers, peak and seconds, and its gradients' norms (the preamble's
    and head's on the first stage's process, each stage's own); or (b)
    the tiny model from `state` over each PIPE_TINY_MESHES mesh, its
    losses, launches and (rank 0) whole gradients."""
    import torch
    import torch.distributed as dist

    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.ops import attention as A
    from multi_spatialmllm_tpu_torch.parallel import pipeline_mllm as PM
    from multi_spatialmllm_tpu_torch.parallel import sharding as S
    from multi_spatialmllm_tpu_torch.parallel.pipeline_parallel import (
        MODEL_AXIS,
        gather_stage,
        make_pipe_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV]
    cfg = pipe_configs(M)[1 if tiny else 0]
    meshes = PIPE_TINY_MESHES if tiny else {"pipe 2": dict(n_stages=2)}
    out = {}
    for name, kw in meshes.items():
        model = M.MultiFrameMLLM(cfg, device="cuda",
                                 param_dtype=torch.float32)
        if tiny:
            model.load_state_dict(state)
        else:
            M.init_random_weights(model, SEED)
        mesh = make_pipe_mesh(**kw)
        if MODEL_AXIS in mesh.mesh_dim_names:
            S.shard_model(model, mesh)
        batch = pipe_batch(M, cfg, tiny)
        S.reset_staged()
        for kern in flash:
            kern.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with pipe_spans(torch, PM, model) as spans:
            loss, (pre, stage, head) = PM.mllm_pipeline_loss_and_grads(
                model, batch, mesh, PIPE_MICRO)
        torch.cuda.synchronize()
        got = dict(loss=float(loss), seconds=time.perf_counter() - t0,
                   launches={k.name: k.launches for k in flash},
                   staged=dict(S.STAGED), spans=spans,
                   peak=torch.cuda.max_memory_allocated() / 2**30)
        if tiny:
            stage = gather_stage(stage, mesh, PM.tp_stage_param_specs(stage))
            grads = PM.merge_params(pre, stage, head, cfg)
            got["grads"] = ({k: v.cpu() for k, v in grads.items()}
                            if dist.get_rank() == 0 else None)
        else:
            per = next(iter(stage.values())).shape[1]
            first = int(mesh.get_local_rank("pipe")) * per
            norms = {k: float(v.norm()) for k, v in {**pre, **head}.items()}
            for rel, v in stage.items():
                for j in range(v.shape[1]):
                    norms[f"llm.layers.{first + j}.{rel}"] = float(
                        v[0, j].norm())
            got["norms"] = norms
        out[name] = got
        del model, pre, stage, head
        torch.cuda.empty_cache()
    return out


def cells_frame(np, seed, noisy):
    """A seeded 968 x 1296 RGB frame (the benchmark cells' size): smooth
    shading with a little noise, or uniform noise."""
    rng = np.random.default_rng(seed)
    if noisy:
        return rng.integers(0, 256, (968, 1296, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:968, 0:1296]
    base = 96 + 80 * np.sin(xx / 37.0 + seed) * np.cos(yy / 23.0)
    img = base[..., None] + rng.normal(0, 6, (968, 1296, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_tile_frames(torch, TF, card):
    """Phase 26 (see the module docstring)."""
    import ctypes

    import numpy as np

    from multi_spatialmllm_tpu_torch.models import preprocess as PP

    cells = PP.PreprocessConfig(max_tiles=6, resize_hw=None)
    fixed = PP.PreprocessConfig(max_tiles=6, resize_hw=(968, 1296))
    cases = [("cells' frame, smooth", cells_frame(np, 1, False), cells),
             ("cells' frame, noise", cells_frame(np, 2, True), cells),
             ("480 x 640, fixed resize", cells_frame(np, 3, False)[:480, :640],
              fixed)]
    launches, host = TF.TILE_FRAME.launches, PP.HOST_TILED.frames
    plain_ms = []
    for label, img, cfg in cases:
        got = PP.tile_image(img, cfg)
        t0 = time.perf_counter()
        want = PP._tile_image(img, cfg)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if (got.dtype, got.shape) != (want.dtype, want.shape) or \
                not got.flags.c_contiguous or got.tobytes() != want.tobytes():
            fail(f"tile_frame: {label}: the tiles differ from the numpy "
                 f"path's")
        log(f"  {label}: {got.shape[0]} tiles byte-equal to the numpy path")
    launches = TF.TILE_FRAME.launches - launches
    if launches != len(cases) or PP.HOST_TILED.frames != host:
        fail(f"tile_frame launched {launches} times for {len(cases)} frames "
             f"({PP.HOST_TILED.frames - host} tiled on the host)")
    img = cases[0][1]
    host_ms = []
    for _ in range(TILE_CALLS):
        t0 = time.perf_counter()
        out = PP.tile_image(img, cells)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    src = torch.from_numpy(img).cuda()
    mean_std = (ctypes.c_float * 6)(*PP.MEAN.tolist(), *PP.STD.tolist())

    def launch():
        return TF.tile_on_device(src, (968, 1296), 2, 3, 448, True, mean_std)

    k_ms = graph_ms(torch, launch)
    if k_ms is None:
        fail("tile_frame: the launch did not capture in a CUDA graph")
    wrapper_ms = cuda_ms(torch, launch)
    n_bytes = img.nbytes + out.nbytes
    b_ms, b_by = bound_ms(0, n_bytes)
    t_plain = median(plain_ms[:2])
    log(f"  at 968 x 1296 -> {out.shape[0]} tiles: kernel {ms_text(k_ms)} "
        f"(graph replay; {wrapper_ms:.4f} ms by events around the wrapper), "
        f"bound {b_ms:.4f} ms ({b_by}: {img.nbytes / 1e6:.2f} MB read, "
        f"{out.nbytes / 1e6:.2f} MB written), {100 * b_ms / k_ms:.1f}% of "
        f"it; tile_image {median(host_ms):.2f} ms a frame on the host "
        f"(median of {TILE_CALLS}; {min(host_ms):.2f}-{max(host_ms):.2f}); "
        f"the numpy path {t_plain:.1f} ms; {card}")
    return {"ms": k_ms, "wrapper_ms": wrapper_ms, "bound": (b_ms, b_by),
            "plain_ms": t_plain, "host_ms": median(host_ms)}


def phase_pipe(torch, M, card):
    """Phase 25 (see the module docstring): the references in this
    process, then the two worlds at once."""
    from concurrent.futures import ThreadPoolExecutor

    from multi_spatialmllm_tpu_torch.dryrun import run_world

    cfg_a, cfg_b = pipe_configs(M)
    t0 = time.perf_counter()
    ref_a = pipe_reference(torch, M, cfg_a, False)
    ref_b = pipe_reference(torch, M, cfg_b, True)
    log(f"  the runs without a group took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    walls = {}

    def world(n, args):
        ranks = run_world(n, "chip_smoke:pipe_world", args, device="cpu",
                          timeout=600)
        walls[n] = time.perf_counter() - t0
        return ranks

    with ThreadPoolExecutor(2) as pool:
        world_a = pool.submit(world, 2, (False,))
        world_b = pool.submit(world, 4, (True, ref_b[2]))
        ranks_a, ranks_b = world_a.result(), world_b.result()
    world_s = time.perf_counter() - t0
    out = {"world_s": world_s, "world_walls": walls}

    # (a): the flagship cut over 2 stages
    loss, norms, _ = ref_a
    got = [r["pipe 2"] for r in ranks_a]
    rel = abs(got[0]["loss"] - loss) / abs(loss)
    mine = {**got[1]["norms"], **got[0]["norms"]}
    gdiff = {n: abs(mine[n] - g) / g for n, g in norms.items() if g > 0}
    worst = max(gdiff, key=gdiff.get)
    log(f"  (a) flagship widths ({PIPE_LAYERS} LLM, {PIPE_VIT_LAYERS} ViT "
        f"layers) over 2 pipe stages, {PIPE_MICRO} microbatches of "
        f"{PIPE_BATCH}: loss {got[0]['loss']} vs {loss} without a group, "
        f"relative {rel:.3g} (limit {MESH_LOSS_REL:g}); {len(gdiff)} "
        f"gradient norms, the farthest {worst} at {gdiff[worst]:.3g} "
        f"(limit {MESH_GNORM_REL:g}); launches a call a process "
        f"{[r['launches'] for r in got]}; staged "
        f"{[r['staged'] for r in got]}; parts "
        f"{[{k: round(v, 3) for k, v in r['spans'].items()} for r in got]} "
        f"s; peak "
        f"{[round(r['peak'], 3) for r in got]} GiB a process; call "
        f"{[round(r['seconds'], 3) for r in got]} s; {card}")
    if got[0]["loss"] != got[1]["loss"]:
        fail(f"(a) the processes' losses differ: "
             f"{[r['loss'] for r in got]}")
    if rel > MESH_LOSS_REL:
        fail(f"(a) loss {rel:.3g} relative from the run without a group")
    if set(mine) != set(norms) or gdiff[worst] > MESH_GNORM_REL:
        fail(f"(a) gradient norm of {worst} {gdiff[worst]:.3g} relative "
             f"from the run without a group")
    for r in got:
        if min(r["launches"].values()) <= 0:
            fail(f"(a) a kernel never launched: {r['launches']}")
    out["a"] = dict(loss=got[0]["loss"], ref_loss=loss, loss_rel=rel,
                    gnorm_worst=(worst, gdiff[worst]),
                    launches=[r["launches"] for r in got],
                    staged=[r["staged"] for r in got],
                    peak=[r["peak"] for r in got],
                    seconds=[r["seconds"] for r in got])

    # (b): the tiny model over three meshes, element by element
    loss, grads, _ = ref_b
    out["b"] = {}
    for name in PIPE_TINY_MESHES:
        got = [r[name] for r in ranks_b]
        rel = abs(got[0]["loss"] - loss) / abs(loss)
        whole = got[0]["grads"]
        err = {n: float((whole[n] - g).abs().max()) for n, g in grads.items()
               if n in whole}
        worst = max(err, key=err.get)
        log(f"  (b) tiny f32 over {name}: loss {got[0]['loss']} vs {loss}, "
            f"relative {rel:.3g} (limit {PIPE_LOSS_RTOL:g}); {len(err)} "
            f"gradients, the farthest {worst} at {err[worst]:.3g} (limit "
            f"{PIPE_GRAD_ATOL:g}); launches a call a process "
            f"{[r['launches'] for r in got]}; {card}")
        if len({r["loss"] for r in got}) != 1:
            fail(f"(b) {name}: the processes' losses differ")
        if rel > PIPE_LOSS_RTOL:
            fail(f"(b) {name}: loss {rel:.3g} relative from the run "
                 f"without a group")
        if set(whole) != set(grads) or err[worst] > PIPE_GRAD_ATOL:
            fail(f"(b) {name}: gradient of {worst} {err[worst]:.3g} from "
                 f"the run without a group")
        if any(min(r["launches"].values()) <= 0 for r in got):
            fail(f"(b) {name}: a kernel never launched")
        out["b"][name] = dict(loss_rel=rel, grad_err=(worst, err[worst]))
    log(f"  the two worlds took {world_s:.1f} s (world of 2 "
        f"{walls[2]:.1f} s, of 4 {walls[4]:.1f} s); {card}")
    return out


def kernel_entry(name, source, replaces, launches_by_path, err, timing,
                 library_ms):
    """One entry of the `kernels` line: `timing` is (ms, plain ms,
    (bound ms, bound by))."""
    t_k, t_p, (b_ms, b_by) = timing
    return {"name": name, "route": "cuda",
            "source": "multi_spatialmllm_tpu_torch/ops/csrc/" + source,
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def moe_config(cli):
    """The MoE slice's model, built by the CLI's own rules: `--config bench
    --moe-experts 4 --moe-impl ragged --moe-kernel pallas`."""
    return cli._config(argparse.Namespace(
        config="bench", vocab_size=0, moe_experts=4, moe_impl="ragged",
        moe_kernel="pallas", moe_group=0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", type=int, nargs="*",
                        default=list(range(3, N_PHASES + 1)),
                        help=f"phases to run after the device and the "
                             f"build (3-{N_PHASES})")
    phases = set(parser.parse_args(argv).phases)
    # fewer fragments for the training phases' large, short-lived tensors
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    import dataclasses

    from multi_spatialmllm_tpu_torch import __main__ as cli
    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.models import paged_kv as K
    from multi_spatialmllm_tpu_torch.ops import _build as B
    from multi_spatialmllm_tpu_torch.ops import attention as A
    from multi_spatialmllm_tpu_torch.ops import grouped_matmul as G
    from multi_spatialmllm_tpu_torch.ops import paged_attention as P
    from multi_spatialmllm_tpu_torch.ops import tile_frames as TF
    from multi_spatialmllm_tpu_torch.parallel import train as T

    # float32 paths compare against float32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def head(n, text):
        log(f"[{n}/{N_PHASES}] {text} (at {time.perf_counter() - t_start:.1f}"
            f" s)")

    card = card_name_and_power_limit()
    head(1, f"device: {torch.cuda.get_device_name(0)} "
            f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    from concurrent.futures import ThreadPoolExecutor

    from multi_spatialmllm_tpu_torch.ingest import native

    with ThreadPoolExecutor(1) as pool:   # g++ beside the nvcc builds
        t0 = time.perf_counter()
        emitter = pool.submit(native.native_available)
        build_all([A.FLASH_FWD, P.PAGED_DECODE, A.FLASH_BWD_DQ,
                   A.FLASH_BWD_DKV, P.PAGED_DECODE_INT8, G.GMM, G.GMM_T,
                   G.TGMM, TF.TILE_FRAME, TF.RESIZE_FRAME])
        if not emitter.result():
            fail(f"the native library did not build: "
                 f"{native.build_error}")
        log(f"[2/{N_PHASES}] native library (JSONL emitter, JPEG codec) ready "
            f"({native.library_path()}) {time.perf_counter() - t0:.1f} s "
            f"after the builds began")
    check_sass(B, "".join(k.build_log for k in (G.GMM, G.GMM_T, G.TGMM)))
    check_k7_sass(B, "".join(k.build_log for k in (P.PAGED_DECODE,
                                                   P.PAGED_DECODE_INT8)))
    tok = serve_tokenizer()
    res = {}
    if 3 in phases:
        head(3, "flash_fwd (K1) against its plain version")
        res["k1"] = phase_k1(torch, A)
    if 4 in phases:
        head(4, "paged_decode (K7) against the plain gather-window version")
        res["k7"] = phase_k7(torch, P, quant=False)
    if 5 in phases:
        head(5, "tiny f32: PagedBatcher on the CPU vs on the card")
        phase_tiny(torch, M, K)
    if 6 in phases:
        head(6, "flagship serve: 16 requests through the serve loop")
        res["serve"] = phase_serve(torch, M, K, cli, tok,
                                   [A.FLASH_FWD, P.PAGED_DECODE])
        torch.cuda.empty_cache()
    if 7 in phases:
        head(7, "flash backward (K2, K3; K4-K6 at S 8192) against the plain "
                "version")
        res["bwd"] = phase_bwd(torch, A)
        torch.cuda.empty_cache()
    if 8 in phases:
        head(8, "tiny f32 training: 3 steps on the CPU vs on the card")
        phase_tiny_train(torch, M, T, cli)
    if 9 in phases:
        head(9, f"flagship-width training, LLM cut to {TRAIN_LAYERS} layers: "
                f"4 steps through train_steps")
        res["train"] = phase_train(
            torch, M, T, cli, tok,
            [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV])
    if 10 in phases:
        head(10, "gmm, gmm_t, tgmm (K8) against their plain versions")
        res["k8"] = phase_k8(torch, G, B)
        torch.cuda.empty_cache()
    if 11 in phases:
        head(11, "paged_decode_int8 (K7 int8) against its plain version")
        res["k7i8"] = phase_k7(torch, P, quant=True)
    if 12 in phases:
        tiny_moe = M.with_dtype(M.tiny_moe_config(), "float32")
        for impl, kernel in (("einsum", "xla"), ("ragged", "pallas")):
            cfg = dataclasses.replace(tiny_moe, llm=dataclasses.replace(
                tiny_moe.llm, moe_impl=impl, moe_kernel=kernel))
            label = f"tiny MoE {impl}" + (f"/{kernel}" if impl == "ragged"
                                          else "")
            head(12, f"{label} f32: 3 train steps and int8-kv greedy "
                     f"serving, CPU vs card")
            phase_tiny_train(torch, M, T, cli, cfg, label)
            phase_tiny(torch, M, K, cfg, label, kv_dtype="int8")
    if 13 in phases:
        head(13, "MoE train at full width (bench, 4 experts, ragged, K8), "
                 "nothing cut: 4 steps through train_steps")
        res["moe_train"] = phase_train(
            torch, M, T, cli, tok,
            [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV, G.GMM, G.GMM_T,
             G.TGMM], base=moe_config(cli), layers=None,
            max_tiles=MOE_MAX_TILES, tiles_per_image=MOE_TILES_PER_IMAGE)
        steps = res["moe_train"][1]["steps"]
        per_step = {k: v / steps for k, v in res["moe_train"][0].items()}
        log(f"  launches a step (remat under dots_and_flash_saveable; "
            f"expected {MOE_TRAIN_LAUNCHES}): {per_step}")
        if per_step != MOE_TRAIN_LAUNCHES:
            fail(f"MoE train launches a step {per_step}, expected "
                 f"{MOE_TRAIN_LAUNCHES}")
        torch.cuda.empty_cache()
    if 14 in phases:
        head(14, "MoE serve at full width (bench, 4 experts, ragged, K8; "
                 "int8 kv): 16 requests through the serve loop")
        cfg = moe_config(cli)
        res["moe_serve"] = phase_serve(
            torch, M, K, cli, tok, [A.FLASH_FWD, G.GMM, P.PAGED_DECODE_INT8],
            cfg=cfg, pcfg=K.bench_paged_config(kv_dtype="int8"),
            max_images=1, label="bench MoE")
        torch.cuda.empty_cache()
    if 15 in phases:
        head(15, "data engine: real-scale visibility, the bench corpus "
                 "through visibility, relations and camera movement, and "
                 "demo card vs CPU")
        res["data_engine"] = phase_data_engine(torch, cli, card)
        torch.cuda.empty_cache()
    if 16 in phases:
        head(16, "ScanNet engines: M3/M4 on the real-scale scene, card vs "
                 "CPU, and the object-visibility, coverage, object-"
                 "perception, depth and correspondence rates")
        res["scannet"] = phase_scannet_engines(torch, card)
        log(f"  rates under bench.py's keys: "
            f"{json.dumps(res['scannet']['rates'])}; {card}")
        torch.cuda.empty_cache()
    if 17 in phases:
        head(17, "TAPVid object movement: the codec against cv2's digests, "
                 "M5 at the real-scale stand-in card vs CPU, the engines' "
                 "rates and the tapvid command card vs CPU")
        res["tapvid"] = phase_object_movement(torch, cli, card)
        log(f"  rates under bench.py's keys: "
            f"{json.dumps(res['tapvid']['rates'])}; {card}")
        torch.cuda.empty_cache()
    if 18 in phases:
        head(18, "real inputs without cv2: the ingest export at bench.py's "
                 "configuration, the real-scale scan through ingest and "
                 "pipeline on the card, the small runs card vs CPU and "
                 "against the JAX digests, serve on frames from disk")
        t0 = time.perf_counter()
        res["real_inputs"] = phase_real_inputs(
            torch, cli, card, [A.FLASH_FWD, P.PAGED_DECODE, TF.TILE_FRAME])
        log(f"  rates under bench.py's keys: "
            f"{json.dumps(res['real_inputs']['rates'])}; phase 18 took "
            f"{time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 19 in phases:
        head(19, "eval and serving options: tiny f32 card vs CPU, the "
                 f"flagship in bf16 (LLM and ViT cut to {EVAL_LAYERS} and "
                 f"{EVAL_VIT_LAYERS} layers) on a "
                 "pipeline run's eval data (paged with every option, batched "
                 "with option scoring, int8 weights), the bench MoE with "
                 "int8 kv")
        t0 = time.perf_counter()
        res["eval"] = phase_eval(
            torch, cli, M, K, tok, card,
            [A.FLASH_FWD, P.PAGED_DECODE, P.PAGED_DECODE_INT8, G.GMM])
        log(f"  phase 19 took {time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 20 in phases:
        head(20, "checkpoint import/export and LoRA: tiny card vs CPU, the "
                 "flagship checkpoint through import-checkpoint and "
                 "export-checkpoint, multi-LoRA flagship serving, "
                 "flagship LoRA training, the bench MoE LoRA (the flagship's "
                 f"LLM cut to {PHASE20_LAYERS} layers)")
        t0 = time.perf_counter()
        res["lora"] = phase_lora(
            torch, cli, M, K, T, tok, card,
            [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV],
            [G.GMM, G.GMM_T, G.TGMM], [A.FLASH_FWD, P.PAGED_DECODE])
        log(f"  phase 20 took {time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 21 in phases:
        head(21, "data engine, hybrid and pipelined: the real-scale float64 "
                 "and hybrid labels against the JAX digest, the split "
                 "projection sequential vs pipelined, a hybrid run_all "
                 "card vs CPU")
        t0 = time.perf_counter()
        res["hybrid"] = phase_hybrid(torch, card)
        log(f"  phase 21 took {time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 22 in phases:
        head(22, "the bench train step (bench.py's model block) under three "
                 "remat policies, and the bench MoE under its policy")
        t0 = time.perf_counter()
        res["bench_train"] = phase_bench_train(torch, M, T, A, G, card)
        log(f"  phase 22 took {time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 23 in phases:
        head(23, "the data axis: the scene-parallel stages at world 1 "
                 "(NCCL) and 2 (gloo), train --data-parallel 1 against the "
                 "run without a group, the bench MoE, the drill at smoke "
                 "scale against the CPU's digests")
        t0 = time.perf_counter()
        res["data_axis"] = phase_data_axis(
            torch, cli, M, card,
            [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV],
            [G.GMM, G.GMM_T, G.TGMM])
        log(f"  phase 23 took {time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 24 in phases:
        head(24, "the mesh's model, seq and expert axes and FSDP: train "
                 "under 2 model, FSDP over 2 data, ring attention over 2 "
                 "seq, the bench MoE over 2 expert and ragged under 2 "
                 "model, the flagship served under 2 model; one world of "
                 "two gloo processes on the card, each part against the "
                 "run without a group")
        t0 = time.perf_counter()
        res["mesh"] = phase_mesh(
            torch, cli, M, K, T, tok, card,
            [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV],
            [A.FLASH_FWD, P.PAGED_DECODE, P.PAGED_DECODE_INT8])
        log(f"  phase 24 took {time.perf_counter() - t0:.1f} s; {card}")
        torch.cuda.empty_cache()
    if 25 in phases:
        head(25, "the mesh's pipe axis: 1F1B training of the whole MLLM at "
                 "the flagship's widths over 2 pipe stages, and of the tiny "
                 "model over pipe 4, (data 2 x pipe 2) and (model 2 x pipe "
                 "2); gloo processes on the card, each against the run "
                 "without a group")
        t0 = time.perf_counter()
        res["pipe"] = phase_pipe(torch, M, card)
        log(f"  phase 25 took {time.perf_counter() - t0:.1f} s; {card}")
    if 26 in phases:
        head(26, "tile_frame at the benchmark cells' frame against the numpy "
                 "path, timed beside its bound and the numpy path")
        res["tile"] = phase_tile_frames(torch, TF, card)
    log(f"all phases done in {time.perf_counter() - t_start:.1f} s")

    if phases != set(range(3, N_PHASES + 1)):
        return 0      # a partial run prints no result line
    k1_err, k1 = res["k1"]
    k7_err, k7 = res["k7"]
    err_dq, err_dkv, err_fwd, bwd = res["bwd"]
    k8_err, k8 = res["k8"]
    k7i8_err, k7i8 = res["k7i8"]
    train = res["train"][0]
    moe_train, moe_serve = res["moe_train"][0], res["moe_serve"]
    tr = bwd["train"]
    jax_attn = "multi_spatialmllm_tpu/ops/attention.py"
    jax_moe = "multi_spatialmllm_tpu/models/moe.py"

    def by_path(name, **paths):
        return {p: launches[name] for p, launches in paths.items()}

    frames = res["real_inputs"]["serve"]
    ev = res["eval"]
    lo = res["lora"]
    bench = res["bench_train"]["runs"]["dots_and_flash_saveable"]["launches"]
    bench_moe = res["bench_train"]["moe"]["launches"]
    bench_errs = res["bench_train"]["flash_errs"]
    dp_train = res["data_axis"]["dp_launches"]
    dp_moe_train = res["data_axis"]["moe_launches"]
    mesh = res["mesh"]
    mesh_flash = {f"mesh_{k}": mesh[k]["launches"] for k in
                  ("tp", "fsdp", "seq", "ep_einsum", "tp_ragged")}
    mesh_moe = {"mesh_tp_ragged": mesh["tp_ragged"]["launches"]}
    # a call a process: the first stage's (with the preamble) and the last's
    pipe = dict(zip(("pipe_train", "pipe_train_last"),
                    res["pipe"]["a"]["launches"]))
    flash = dict(serve=res["serve"], train=train, moe_serve=moe_serve,
                 moe_train=moe_train, frames_serve=frames,
                 eval_paged=ev["eval_paged"], eval_batched=ev["eval_batched"],
                 moe_eval=ev["moe_eval"], lora_serve=lo["serve"],
                 lora_train=lo["train"], moe_lora_train=lo["moe_train"],
                 bench_train=bench, bench_moe_train=bench_moe,
                 dp_train=dp_train, dp_moe_train=dp_moe_train, **mesh_flash,
                 **pipe, mesh_serve=mesh["serve"]["native"]["launches"],
                 mesh_serve_int8=mesh["serve"]["int8"]["launches"])
    kernels = [
        kernel_entry("flash_fwd", "flash_fwd.cu",
                     f"{jax_attn}:92 (K1); :483 (K4, streaming)",
                     by_path("flash_fwd", **flash),
                     max(k1_err, err_fwd, ev["k1_err"], bench_errs["o"]),
                     (k1["prefill"][0], k1["prefill"][1], k1["prefill"][3]),
                     k1["prefill"][2]),
        kernel_entry("flash_bwd_dq", "flash_bwd.cu",
                     f"{jax_attn}:269 (K2); :592 (K5, streaming)",
                     by_path("flash_bwd_dq", train=train,
                             moe_train=moe_train, lora_train=lo["train"],
                             moe_lora_train=lo["moe_train"],
                             bench_train=bench, bench_moe_train=bench_moe,
                             dp_train=dp_train, dp_moe_train=dp_moe_train,
                             **mesh_flash, **pipe),
                     max(err_dq, bench_errs["dq"]),
                     (tr["dq"][0], tr["plain"], tr["dq"][1]), tr["lib_bwd"]),
        kernel_entry("flash_bwd_dkv", "flash_bwd.cu",
                     f"{jax_attn}:324 (K3); :645 (K6, streaming)",
                     by_path("flash_bwd_dkv", train=train,
                             moe_train=moe_train, lora_train=lo["train"],
                             moe_lora_train=lo["moe_train"],
                             bench_train=bench, bench_moe_train=bench_moe,
                             dp_train=dp_train, dp_moe_train=dp_moe_train,
                             **mesh_flash, **pipe),
                     max(err_dkv, bench_errs["dk"], bench_errs["dv"]),
                     (tr["dkv"][0], tr["plain"], tr["dkv"][1]),
                     tr["lib_bwd"]),
        kernel_entry("paged_decode", "paged_decode.cu",
                     "multi_spatialmllm_tpu/ops/paged_attention.py:95",
                     by_path("paged_decode", serve=res["serve"],
                             frames_serve=frames,
                             eval_paged=ev["eval_paged"],
                             lora_serve=lo["serve"],
                             mesh_serve=mesh["serve"]["native"]["launches"]),
                     k7_err,
                     k7_timing(k7), None),
        kernel_entry("paged_decode_int8", "paged_decode.cu",
                     "multi_spatialmllm_tpu/ops/paged_attention.py:95 "
                     "(quant branch, :220-245, :256-275)",
                     by_path("paged_decode_int8", moe_serve=moe_serve,
                             moe_eval=ev["moe_eval"],
                             mesh_serve_int8=mesh["serve"]["int8"][
                                 "launches"]),
                     k7i8_err, k7_timing(k7i8), None),
    ]
    for name, replaces, paths in (
            ("gmm", f"{jax_moe}:133 (_pallas_gmm: megablox gmm)",
             dict(moe_train=moe_train, moe_serve=moe_serve,
                  moe_eval=ev["moe_eval"], moe_lora_train=lo["moe_train"],
                  bench_moe_train=bench_moe, dp_moe_train=dp_moe_train,
                  **mesh_moe)),
            ("gmm_t", f"{jax_moe}:146-165 (VJP: gmm, transpose_rhs)",
             dict(moe_train=moe_train, moe_lora_train=lo["moe_train"],
                  bench_moe_train=bench_moe, dp_moe_train=dp_moe_train,
                  **mesh_moe)),
            ("tgmm", f"{jax_moe}:146-165 (VJP: megablox tgmm)",
             dict(moe_train=moe_train, bench_moe_train=bench_moe,
                  dp_moe_train=dp_moe_train, **mesh_moe))):
        t_k, t_p, t_l, bound, _ = k8[(name, "train gate/up")]
        kernels.append(kernel_entry(name, "grouped_matmul.cu", replaces,
                                    by_path(name, **paths), k8_err[name],
                                    (t_k, t_p, bound), t_l))
        # every timed shape beside; the device kernels behind the entry
        entry = kernels[-1]
        entry["device_kernels"] = (
            ["gmm_wgmma_kernel", "gmm_rows_kernel", "gmm_splitk_reduce_kernel"]
            if name == "gmm" else ["gmm_wgmma_kernel"])
        shown = {lb: t for (f, lb), t in k8.items() if f == name}
        entry["ms_by_shape"] = {lb: t[0] for lb, t in shown.items()}
        entry["bound_ms_by_shape"] = {lb: t[3][0] for lb, t in shown.items()}
        entry["library_ms_by_shape"] = {lb: t[2] for lb, t in shown.items()}
    # K7's `ms` is the serve shape's device time (graph replay); every
    # timed shape beside, with the wrapper's time and host cost
    for entry, timings in ((kernels[3], k7), (kernels[4], k7i8)):
        entry["device_kernels"] = ["paged_decode_split_kernel"]
        for key in ("graph_ms", "wrapper_ms", "host_us", "bound_ms",
                    "plain_ms"):
            entry[f"{key}_by_shape"] = {lb: t[key]
                                        for lb, t in timings.items()}
    # K2/K3's `ms` is at the unpacked S 4096 row; every timed shape beside
    for entry, part in ((kernels[1], "dq"), (kernels[2], "dkv")):
        entry["ms_by_shape"] = {s: t[part][0] for s, t in bwd.items()}
        entry["bound_ms_by_shape"] = {s: t[part][1][0]
                                      for s, t in bwd.items()}
        entry["library_ms_by_shape"] = {s: t["lib_bwd"]
                                        for s, t in bwd.items()}
    tile = res["tile"]
    kernels.append(kernel_entry(
        "tile_frame", "tile_frames.cu",
        "none: the JAX package tiles frames on the host with cv2 "
        "(multi_spatialmllm_tpu/models/preprocess.py)",
        by_path("tile_frame", frames_serve=frames), 0.0,
        (tile["ms"], tile["plain_ms"], tile["bound"]), None))
    kernels[-1]["host_ms"] = tile["host_ms"]
    missing = [(k["name"], p) for k in kernels
               for p, n in k["launches_by_path"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on their paths: {missing}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
