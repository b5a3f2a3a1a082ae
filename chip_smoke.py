#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

  1. print the card's name and power limit; build the nine CUDA kernels
     (eight libraries) from ``src/repro_torch/csrc`` (one nvcc per source,
     all at once); print the registers and spills of every kernel, and
     on a line each those of the half attention kernels;
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width ViTDet-L shapes the serving path gives it, and time
     the kernel alone, the plain version and, where one PyTorch call
     computes the same function, that call.  ``window_attention`` is
     checked to 1e-4 at the padded shape with ``win_valid``, the int8
     lane's 15-head call through views of a 2880-wide fused QKV, and
     the full-resolution shape (its kernels-line row).  ``int8_matmul``
     is checked bit-equal at the five GEMM shapes of the quantized model
     (M = 8192), each at both output tile widths (the other one timed
     for the record), and at two ragged ones (K = 100, which the wrapper
     zero-pads to 112, and the pruned 960 x 2880 at M = 1000); its
     numbers in the kernels line are sums over the five (the bound is
     the sum of each shape's bound, "by" the kind that bounds most of
     it).  Both print their achieved rates and share of their bound.
     The per-row activation quantization in front of each GEMM is
     timed on its own.  ``decode_attention`` is checked to 1e-5 at its
     kv_len edges (``DECODE_EDGES``), then at the Qwen3-4B serving shape
     (its kernels-line row), zamba2-1.2b's shared attention (G = 1, Dh =
     64) and a ragged 8192-key cache, each also timed cold: its launches
     rotate over enough caches to leave the 50 MB L2 (``cold_us``), as
     the 36 layers of a decode step do.  ``avg_pool`` is checked at its
     4-byte, chunked and wide paths (``POOL_CASES``) and must match the
     plain version exactly at the serving frame, also timed cold over
     four frames.  Every row's ``ms`` is host-clocked back-to-back
     relaunches (CUDA events), which the host's launch rate can bound for
     a short kernel; ``device_us`` is the kernel's own device time per
     launch from a ``torch.profiler`` trace of twenty relaunches (summed
     over the shapes for ``int8_matmul``, over the four kernels of a call
     for ``ssd_scan``).  ``flash_attention`` is checked to 1e-4, causal and
     not, at a causal-GQA T = 1000 and at every head width it builds (16,
     32, 64, 128; T and S off its 64-row tiles, S < T, GQA groups 1 and
     4), then at the ViT shape (its kernels-line row), the LM prefill's
     causal GQA shapes (T = 128 and the mixed prefill's T = 96) and
     Qwen3-4B's training shape (1, 1024, 32/8, 128), with the plain
     analytic backward timed there.  The
     three float32 tensor-core kernels (window, flash, ``ssd_scan``) are
     bounded by their bytes or by three TF32 products per product at the
     TF32 peak (3xTF32), whichever is larger.  The whole phase runs
     three times, through the kernels' float32, fp16 and bf16 entry
     points (``kernel_checks``, one copy of every check and bound, the
     multi-client layouts at float32 only): the data movement and the
     serving frame's pool bit-equal at every type, avg_pool's other
     paths, attention and decode (at half also a half cache under a
     float32 q) within one ULP of the half type beyond the float32 limit
     at HALF_EQUAL or more of the elements bit-equal; the bound counts
     the type's bytes, and at half attention's products as one half
     product at the half tensor-core peak.  Each row gains ``f16`` /
     ``bf16`` entries with the float32 row's keys.  At half, window and
     flash run their half tensor-core kernels (``HALF_KERNELS``), which
     the traces time under those kernels' own names (a trace with no
     device time there fails), and each is also held on q, k and v whose
     base lies 2 bytes off 16, which its wrapper copies (three copies
     counted);
  3. serve full-width ViTDet-L (24 blocks, D=1024, 1024x1024 frames,
     weights drawn from a seed) through ``ServerModel.infer_wave``: warm
     up, then a full-resolution wave that captures restoration-point
     tiles and a mixed FULL/LOW/REUSE wave at beta 2 that splices them.
     Detections must be finite, every kernel of the path must have
     launched during the two waves, and no grid key may first run after
     warmup.  One more wave of each kind is traced with
     ``torch.profiler``: device time by kernel family (GEMM, attention
     kernels, convolutions, ...) and the device's busy share of the
     wave; the full tables go to ``chiprun_out/profile_*.txt``.  Then a
     mixed wave at beta 0 (restore at input), which must launch
     ``nn_upsample`` and is traced the same way;
  4. one mixed wave of an 8-block full-width model on the card and,
     through the plain versions, on the CPU, at beta 2 and at beta 0:
     features (and captured tiles) agree to 1e-3 relative;
  5. the quantized ViTDet-L (int8 weights, one head of 16 pruned per
     block by the w_o-norm proxy): ``ServerModel(quant=QuantSpec("int8",
     "fp32", 1))`` serves a full-resolution and a mixed beta-2 wave as
     in phase 3; ``int8_matmul`` must launch and no key may first run
     after warmup; one traced wave splits device time into int8 GEMM,
     row quantization, attention, convolutions and elementwise;
  6. an 8-block full-width quantized wave, card vs CPU: features and
     tiles agree to 5% of their largest magnitude (a one-ulp difference
     upstream can flip an int8 code at a rounding tie; see
     ``tests/test_torch_quant.py``);
  7. serve full-width Qwen3-4B (36 layers, D=2560, GQA 32/8, weights
     from a seed) through ``repro_torch.serve.engine.ServeEngine``: warm
     up, then a plain wave and a mixed beta-2 wave (4 of 8 spans pooled)
     of 8 requests x 128 prompt tokens x 8 new tokens.  Every request
     must get 8 tokens, each wave must launch ``flash_attention`` 36
     times (one prefill) and ``decode_attention`` 36 times per decode
     step, and no key may first run after warmup.  Wall time (median of
     three), prefill and decode-step times, and one traced wave of each
     kind: device time by kernel family and the device's busy share
     inside the prefill and inside the decode steps;
  8. a 4-layer full-width Qwen3 on the card and, through the plain
     versions, on the CPU: prefill logits and 8 teacher-forced decode
     steps, plain and mixed at beta 2, agree to 1e-3 relative;
  9. ``ssd_scan`` against its plain version on the card, y and the final
     state within 1e-4 of their largest magnitudes: the mamba2-370m
     serving shape (x (8, 1024, 32, 64), B/C (8, 1024, 1, 128), chunk
     256; timed, its kernels-line row), the zamba2-1.2b shape (H = 64,
     N = 64), one 128-row chunk, a ragged T = 1000, two B/C groups,
     every (N, P slice) instance the library builds (N 16-128, P 16-128,
     G = 2, ragged T = 200 in chunks of 64) and the four shapes of the
     reference's ``test_ssd_scan``, and a state handoff through
     ``init_state``; the two serving shapes are timed, and traced for the
     device time of each of the scan's four kernels;
 10. serve full-width mamba2-370m (48 layers, D=1024, weights from a
     seed) through ``ServeEngine``: warm up, then plain waves of 8
     requests x 1024 prompt tokens x 8 new tokens.  Every request must
     get 8 tokens, a wave must launch ``ssd_scan`` 48 times (one
     prefill), and no key may first run after warmup.  Wall time
     (median of three), prefill and decode-step times, one traced wave;
     then ``mixed_forward_ssm`` at beta 2 with half the spans pooled
     (layers 0-23 at T_mix = 768; 48 ``ssd_scan`` launches) beside the
     plain ``prefill``, both timed;
 11. the same for full-width zamba2-1.2b (38 mamba layers, D=2048, one
     shared attention + SwiGLU block applied 6 times): 38 ``ssd_scan``
     and 6 ``flash_attention`` launches a prefill, 6 ``decode_attention``
     launches a decode step;
 12. a 4-layer full-width mamba2 and a 6-layer full-width zamba2 (layer
     5 runs the shared block) on the card and, through the plain
     versions, on the CPU, at B = 2 and T = 512 (two chunks): prefill
     logits and 8 teacher-forced decode steps, and the mamba2's
     ``mixed_forward_ssm`` at beta 2, agree to 1e-3 relative;
 13. the single-client offloading system (paper §VI) on a full-width
     ViTDet-L server as ``launch/offload.py`` makes it (weights from
     seed 0, top-k 32, score threshold 0, B = 1, warmed over the plan
     space the policies can reach): anchor the inference-delay model to
     the card's median full-resolution ``infer``, profile ``walkS``
     (PROFILE_FRAMES = 5 frames, the first 2 warm the motion model, x
     the 21 sample configs; the launcher profiles 8), fit the size and
     accuracy ``MLPEstimator``s on the card, then run ``Simulation`` for
     TrackB2B, ViTMAlis and ViTMAlis+Reuse on ``cycleS`` and
     ViTMAlis+Reuse on ``parkS`` (OFFLOAD_FRAMES = 20 each, the 4G trace).  Per
     run: offloads, the server's wall time per offload, the modelled
     Eq. (2) terms, F1, payload size, REUSE offloads, client host ms per
     frame and launches per kernel.  No key may first run after warmup,
     every kernel of the offloads' plans must launch, ``parkS`` must
     reuse at least once, and TrackB2B on ``cycleS`` and ViTMAlis+Reuse
     on ``parkS`` (whose decisions follow the detections, with LOW and
     REUSE offloads at B = 1) through an 8-block full-width model on the
     card and on the CPU must make the same decisions with the same
     payloads and delay terms, detections equal as sets to 1e-3.
     Phase 2 also holds pack_pos, restore_gather and avg_pool exactly
     against their plain versions at this phase's B = 1 layouts;
 14. the multi-client edge (``repro_torch.serve.edge``) on a full-width
     ``BatchedServerModel`` of its own (seed 0, top-k 32, score 0, B
     buckets 1 / 2 / 4, warmed once over every plan its runs reach),
     the delay model anchored as in phase 13.  Run A: four clients of
     bench_multiclient's ``RotatingMaskPolicy`` (4 LOW regions at
     offsets 0 / 4 / 8 / 12, beta 2) on ``walkS``, ``cycleS``,
     ``driveN``, ``walkB`` and 4G traces 0-3, ``MC_FRAMES`` frames,
     sequential, barrier and continuous with ``stage_ahead``.  Run B:
     ``ReuseRotatingPolicy`` on three ``parkS`` and a ``driveN`` over a
     slow uplink (``MC_SLOW_WINDOWS`` compounded bufferbloat windows),
     ``MC_SLOW_FRAMES`` frames, barrier, continuous and continuous +
     ``speculate``.  Per run: offloads, waves, modelled e2e / queue /
     admission / slot percentiles, ``device_idle_frac``,
     ``decode_hidden_s``, speculation counts, wall, the server calls'
     host seconds in dispatch, ``PendingWave.wait`` and ``stage_frames``
     and their wall by B, and launches; every run must launch the fused
     lane's kernels.  Then: run A's modes agree on the detections of a
     (client, frame) served in several; burst waves (the four clients'
     first payloads landing at once: B = 4, and three of them padded to
     4) through the barrier and continuous schedulers match the B = 1
     detections to DET_RTOL; ``infer_batch`` is timed at B = 1, 2, 4 for
     the measured alpha beside ``EdgeConfig.batch_alpha``; a direct
     ``infer_speculative`` on a ``parkS`` canvas equals ``infer_plan``
     on a copy of the cache and leaves the live tiles byte-identical;
     run B must splice REUSE and speculate; no key may first run after
     warmup; peak device memory is printed; and run A's barrier and run
     B's continuous + speculate modes through an 8-block full-width model
     on the card and on the CPU must give equal ``EdgeStats``, decisions
     and Eq. (2) terms, detections within DET_RTOL.  Phase 2 also holds
     pack_pos, restore_gather and avg_pool exactly against their plain
     versions at the B = 4 rotating wave and a B = 3 wave padded to 4
     with REUSE rows from three tile banks;
 15. training (``repro_torch.train.server``).  The kernels' autograd
     Functions (forward: the kernel; backward: the reference's analytic
     VJP) against autograd through the plain versions on the card:
     window attention at the full-width shape with and without a padded
     ``win_valid``, flash at the ViT shape and causal GQA at (8, 128,
     32/8, 128), dq / dk / dv to GRAD_TOL of each gradient's largest
     magnitude; ``avg_pool``'s adjoint equal, ``nn_upsample``'s (a d x d
     block sum, another order of four terms) to POOL_TOL.  Then
     ``TRAIN_STEPS`` steps of
     ``train_server_params`` on full-width ViTDet-L (seed 0, B = 2,
     1024 px ``make_clip`` frames and targets): every loss finite, 20
     window and 4 flash launches a step's forward, the step wall, peak
     memory, one step's forward / backward / AdamW device ms (CUDA
     events) and a traced step's kernel families and busy share; the
     first step's gradients against the same step through the plain
     versions at the kernels' forward values (autograd through the
     plain versions for the backward), each leaf to TRAIN_GRAD_TOL of its
     largest magnitude; the kernels' error on the step's own attention
     inputs (printed); the same step through the plain versions end to
     end taking the kernel route's branch at every kink of the head and
     loss (ReLU masks, L1 signs), every leaf to TRAIN_GRAD_TOL, and
     taking its own branches, every leaf to TRAIN_GRAD_TOL but the head
     convs in front of a ReLU and ``pos_emb`` (``kink_leaf``), which go
     to KINK_GRAD_TOL, with the count of kink positions whose branch
     differs; a 2-block full-width model at B = 1,
     card vs CPU: loss to TRAIN_LOSS_RTOL, every leaf's gradient the
     same two ways.  The four Functions' half gradients: at fp16 and
     bf16, window at the padded shape with ``win_valid``, flash at the
     ViT shape, ``avg_pool`` at the serving frame, ``nn_upsample`` at the
     LOW windows, on the card (the half forward kernel, the reference's
     VJP in plain PyTorch) against the CPU's plain forward and backward
     on the same inputs and cotangent, outputs and gradients within one
     ULP at >= HALF_EQUAL bit-equal, each half kernel launched (path
     ``train half Functions``).  Last,
     the reference's SIM recipe at 150 of its 1800 steps (peak lr
     5e-4, B = 2; cut to keep the run within its
     time limit): the
     loss and the wall, the mean of the last 100 losses
     below that of the first 50, the trained server's frame F1 against
     the ground-truth boxes of held-out clips (and of the training clips)
     beside the seed-0 model's,
     and a bit-equal checkpoint round trip.  The first step's flash calls
     are also held against the plain version in float64: the kernel's
     error and the float32 plain version's are printed;
 16. LM training: the flash Function, causal GQA at Qwen3-4B's (1, 1024,
     32/8, 128) and the ~100M config's (4, 256, 10/2, 64) shapes, forward
     and gradients against autograd through the plain version to
     GRAD_TOL, and the forward's error against float64 beside the plain
     version's; the ~100M qwen3-family run of ``examples/train_lm_100m.py``
     through ``launch.train.train`` (40 of the example's 300 steps at
     B = 4, T = 256; the mean of the last 10 losses 0.1 below the
     first), its last
     checkpoint restored bit-equal (``AdamState.step`` and moments) and a
     5-step resumed run; full-width Qwen3-4B (seed-0 weights, remat):
     the first step's gradients against the plain route on the card and
     flash's float64 error on the step's own inputs, 2 steps at B = 1,
     T = 1024 and one at B = 2 over two microbatches (72 flash launches a
     microbatch: 36 forward, 36 in the remat recompute), step wall, peak
     memory below the card's, the forward / backward / AdamW device ms
     and a traced step's families (``profile_lm_train_qwen3.txt``);
     then, the float32 state freed, full-depth Qwen3-4B at bf16
     parameters (``init_train_state(dtype=)``, float32 moments),
     LM_HALF_STEPS steps at B = 1, T = 1024: step wall, peak memory,
     launches by type (every flash launch the bf16 kernel's; path
     ``lm_train qwen3-4b bf16``), the forward / backward / AdamW device
     ms and a traced step (``flash_attention_bwd``, ``adamw``);
     full-width mamba2-370m and zamba2-1.2b steps at B = 2 (no
     ``ssd_scan`` launch: the scans train through ``ssd_chunked``; 12
     flash launches a zamba2 step); 2-layer Qwen3, 2-layer mamba2 and
     6-layer zamba2 full-width steps card against CPU (loss to
     TRAIN_LOSS_RTOL, every leaf to LM_GRAD_TOL of its largest), and the
     2-layer Qwen3 at bf16 (loss and every leaf to LM_BF16_RTOL);
 17. the exact-shape mixed-resolution lane (``forward_features`` on
     region ids, ``mixed_res.pack_mixed`` / ``restore_full``) on
     full-width ViTDet-L at B = 2 (seeded weights): beta 0..4 with 8 of
     16 regions LOW (T = 2560 before restoring), then 4 REUSE regions at
     beta 2 spliced from tiles a full-resolution forward captured.
     ``avg_pool``, ``window_attention`` (no pad flags), ``flash_attention``
     (unmasked, at T = 2560) and ``nn_upsample`` must launch, the padded
     lane's two kernels must not.  Each beta's features and the REUSE
     forward's features and tiles against the padded lane on the same
     plans, and beta 0 and the REUSE wave of an 8-block model card vs CPU,
     to E2E_RTOL; a wave's ms (``forward_det``, CUDA events) in each lane
     at each beta;
 18. run inside phase 13, on its server: ViTMAlis+Reuse on ``parkS`` with
     the server's FeatureCache host-resident (``device_cache=False``) and
     device-resident.  The same offloads with equal detections; tile
     bytes an offload above 0 in host mode and 0 in device mode; the
     server's ms an offload in each;
 19. the int8 LM lane: ``int8_matmul`` bit-equal to its plain version at
     Qwen3-4B's five projection GEMMs at decode M = 8 and prefill
     M = 1024, the decode shapes' device us beside their bound (summed
     over a decode step's 36 blocks); full-width Qwen3-4B (phase 7's
     seed-0 weights) through ``quant.ptq.quantize_lm_params`` (weight GB
     before and after) served by ``ServeEngine`` in plain waves of 8 x
     128 + 8 tokens: 5 ``int8_matmul`` launches a block in the prefill
     and in each decode step, no steady-state first use, wall, prefill
     and decode-step ms beside phase 7's fp32 engine, greedy agreement
     with its tokens (printed, not gated); a 2-layer full-width int8
     Qwen3 on the card and on the CPU: both engines' greedy tokens
     (agreement printed), and the logits teacher-forced on the CPU's
     tokens to QUANT_E2E_RTOL with the same greedy token wherever the
     CPU's top-2 margin exceeds twice the routes' difference; full-width
     zamba2-1.2b served once through the lane (its shared block's five
     GEMMs a call);
 20. the calibration gate (``quant.calibrate``) on full-width ViTDet-L
     (seed 0) with its default ladder (int8+fp16-p1, int8+fp16, int8,
     fp16+fp16, most compressed first), ``parkS`` / ``driveN``,
     CALIB_FRAMES frames, top-k 32 at score 0: each rung's bytes and F1
     deltas, the shipped spec, the wall and the fp16 launches (the int8
     GEMM's half epilogue and half attention must run).  On seeded
     weights this measures agreement with the float32 model, not
     accuracy;
 21. the ViT half lanes: full-width ViTDet-L (seed 0) through
     ``ServerModel(quant=spec)`` for int8+fp16-p1 (the reference's
     shipped point), an fp16 tree and a bf16 tree: compression on the
     card, warmup on phase 3's plan space (the grid's keys must equal
     float32's), a full-res wave capturing tiles, a mixed beta-2 wave
     splicing REUSE tiles, a beta-0 wave, the exact lane at beta 2;
     finite detections, no steady first use, tiles in the half type;
     the counts set to 0 before and read after two paths a spec: the
     compression (``vitdet-l <spec> compress``), where avg_pool must
     launch at half on the positional grid, and the served waves with
     the exact lane (``vitdet-l <spec>``), where kernels 1-4 and 6 (7
     in the int8 lane) must launch at half (a served wave pools its
     float32 frame in float32, as in the reference); weight bytes, ratio and wave ms beside phase 3's and
     phase 5's; 8-block int8+fp16-p1 and bf16 trees card vs CPU to
     HALF_E2E_RTOL; per served path a line of its fp16 / bf16 window
     and flash launches, each through the half design, and the view
     copies their wrappers made.  Inside phase 13, on its clips and estimators: phase
     18 again on an fp16 server (equal detections in both cache modes;
     tiles move in half float32's bytes);
 22. the LM half lanes: full-width Qwen3-4B (phase 7's weights and
     prompts) on a bf16 tree, an fp16 tree and a float32 tree over a
     bf16 cache, plain waves of 8 x 128 + 8: weight GB, prefill and
     decode-step ms beside phase 7's, flash at half in a half tree's
     prefill, decode at half in every step, finite bf16 logits (fp16's
     printed), greedy agreement with phase 7's tokens (printed); one
     bf16 wave each of mamba2-370m and zamba2-1.2b, each lane and wave
     with the half-design line of phase 21; a 2-layer bf16 Qwen3 card
     vs CPU to LM_BF16_RTOL;
 23. the MoE family: dbrx-132b (16 experts top-4, GQA 48/8) and
     deepseek-v2-236b (MLA, 160 experts top-6 and 2 shared, a dense
     layer first) at full published width, depth cut to MOE_LAYERS
     layers (float32 weights of 57.1 and 53.2 GB, seed 0, each freed
     before the next), each through a warmed ``ServeEngine``: a plain
     and a mixed wave (half the spans pooled at BETA) of 8 x 128 + 8;
     dbrx must launch flash once a layer a prefill and decode once a
     layer a step, deepseek-v2 neither (MLA's attention is einsums);
     no steady first use; prefill and decode-step ms against the
     step's byte bound (every weight but the embedding table), one MoE
     layer's experts timed alone at the step's shape against their
     slabs' bytes, peak memory against the card's; a traced wave of each kind split into the
     experts (bmm + SwiGLU), MLA's attention, flash, decode and the
     rest; dbrx's kernel route against the plain route on the card,
     teacher-forced on its plain wave's tokens (``hold_routes``: logits
     to LM_RTOL and greedy tokens equal but at near-ties, unless the
     routes chose other experts, which the first call to do so may
     only at routing near-ties, MOE_ROUTE_TIE); a narrow config of
     each family (``MOE_NARROW``) card vs CPU, plain and mixed, held
     the same way.  Phase 2 checks and times flash at dbrx's causal
     prefill shapes (G = 6, T = 128 and the mixed 96) and decode at its
     serving step and kv_len edges, at every type;
 24. the reference's last five architectures at full published width,
     MM_LAYERS layers each, float32, seed 0, each freed before the next:
     whisper-medium (8 + 8 layers) on 8 requests of 1500 stub frames
     and a 32-token prompt, MM_NEW greedy tokens through
     ``registry.prefill`` / ``decode_step`` (flash in the encoder, in
     the decoder's causal prefill and in every cross-attention, at T_q
     = 1 each step; decode each step), and ``encode_mixed`` at BETA
     with 37 of the 75 frame spans pooled; llava-next-mistral-7b on 2
     requests of 2880 image embeddings and a 128-token
     prompt, plain and through ``mixed_prefill`` at BETA (half the 188
     spans pooled), MM_NEW greedy tokens; deepseek-7b, mistral-nemo-12b
     and phi4-mini-3.8b through a warmed ``ServeEngine`` as phase 23
     serves its models.  Each with its launches (no path may count
     zero), prefill and decode-step ms (medians of two runs, three in
     ``serve_decoder``) against the
     step's byte bound, peak memory, the kernel route against the plain
     route (``hold_routes``: greedy tokens equal but at near-ties), and
     for whisper the traced share of a decode step's device time in the
     cross-attention K / V projections.  Phase 2 checks and times flash
     at whisper's encoder (8, 1500, 16, 64), its cross-attention at T_q
     = 32 and 1 against 1500 keys and llava's causal (2, 3008, 32/8,
     128), and decode at phi4-mini's G = 3, deepseek-7b's G = 1 at Dh =
     128 and whisper's decoder step, at float32;
 25. the LM families' last lanes.  (A) whisper-medium
     (WHISPER_TRAIN_LAYERS + as many encoder layers of its 24 + 24, cut
     to keep the whole run within its time limit) and
     llava-next-mistral-7b (LLAVA_TRAIN_LAYERS of its 32 layers: the
     whole model's weights, gradients and AdamW moments would take 116
     GB) trained at full width from seed 0 through ``make_train_step``
     (remat) on ``launch.train.synthetic_batches``: 8 x (1500 stub frames
     + 64 tokens) and 2 x (2880 image embeddings + 128 tokens).  The first
     step's loss and every gradient leaf against the plain route on the
     card (TRAIN_LOSS_RTOL, LM_GRAD_TOL), MM_TRAIN_STEPS finite steps
     (flash launches: every attention of a forward, twice under remat:
     48 a whisper step, 16 a llava step), the step wall, peak memory,
     one step's forward / backward / AdamW device ms and a traced step
     (``flash_attention_bwd`` marked); a 2-layer narrow config of each
     (``MM_NARROW``) card vs CPU over two steps (loss and every leaf
     before each step, the step's loss after).  (B) dbrx-132b in bf16,
     fp16 and int8 and deepseek-v2-236b in bf16 and fp16 at full width
     and MOE_LAYERS layers (a half tree cast as it is drawn,
     ``init_lm_params(dtype=)``: the float32 tree and its cast do not fit
     together), each through a warmed ``ServeEngine``: a plain and a
     mixed wave of 8 x 128 + 8 with their launches (dbrx at half: flash
     once a layer a prefill and decode once a layer a step, at the half
     type; int8: also ``int8_matmul`` twice a layer a prefill and a step;
     deepseek-v2: none), weight GB, prefill and decode-step ms against the
     weights' byte bound at the lane's bytes, peak memory, no steady first
     use, finite logits (fp16's printed) and greedy agreement with phase
     23's float32 tokens (printed); the launcher's refusal of
     deepseek-v2's int8 lane; each lane's narrow config (``MOE_NARROW``)
     card vs CPU by ``hold_routes`` at LANE_RTOL, its half tree equal to
     ``cast_tree`` of the float32 draws; a half router's near-tie bound is
     derived from the type's unit roundoff (HALF_ROUTE_ULPS).  (C) the
     narrow MoE configs' train steps, card vs CPU at accum 1 and 2, with
     the aux term, routes recorded (a step whose routes differ is held to
     its first flip lying at a near-tie, and not compared after).
     Full-width MoE training does not fit one card (``last_lanes_phase``).
     Phase 2 checks and times flash at whisper's training shapes (causal
     (8, 64, 16, 64) and 64 queries against 1500 keys) and ``int8_matmul``
     at dbrx's two attention GEMMs at M = 8 and 1024 (bit-equal, device
     us, bound, ``torch._int_mm``);
 26. the kernel autotuner (``kernels/autotune.py``).  Before phase 1 the
     script points ``REPRO_AUTOTUNE_CACHE`` at a fresh ``build/
     chip_smoke_autotune``, so every run sweeps from empty; the warmups
     of the earlier phases sweep the window / flash / int8 GEMM tiles
     (``ServerModel.warmup``) and the decode cluster size
     (``ServeEngine.warmup``), and their launches count under the path
     ``autotune``.  Phase 2 runs before any sweep, so its rows are the
     default tiles'.  (a) Every candidate tile of the four kernels against
     its plain version under the kernel's limit (ATTN_TOL, DECODE_TOL,
     one half ULP at HALF_EQUAL, int8 bit-equal) at ViTDet-L's
     full-resolution shapes (float32, fp16, bf16; the int8+fp16-p1
     GEMMs), Qwen3-4B's decode step and the other phase-2 rows' shapes,
     each candidate's device us (CUDA events, best of TILE_REPS) beside
     the default's, the fastest and the winner the warmups cached; (b)
     8-block full-width ViTDet-L servers (float32, bf16, int8+fp16-p1)
     and a 4-layer full-width Qwen3-4B engine warmed, then, after
     ``clear_memory_cache``, warmed again: 0 sweeps, the same winners
     from disk, the cache file unchanged; (c) with ``REPRO_AUTOTUNE=0``
     and ``refresh_from_env`` every lookup gives the default tile and a
     sweep does nothing; (d) A B B A, default tiles against tuned ones:
     each server's full-resolution wave and a decode step, host ms and
     device ms, the tuned outputs within the card-vs-CPU limits of the
     default ones (phases 4, 6, 8 and 21 compare card vs CPU at the
     tuned tiles); the host cost of a lookup.  Fails if any candidate of
     any sweep of the run raised;
 27. the device mesh (``launch/mesh.py``, ``distributed/sharding.py``,
     ``distributed/pipeline.py``, ``models/moe.moe_sharded``, the mesh
     step of ``train/trainer.py``, ``train/elastic.py``) at world size 1:
     an NCCL process group of one rank in this process (a free local
     port), destroyed at the phase's end, and the (1, 1) mesh.  (a)
     Full-width Qwen3-4B at MESH_LAYERS layers (seed 0, B=1, T=1024,
     remat): two steps of ``make_train_step(cfg, tc, mesh)`` against two
     of the mesh-free step from a copy of the same tree, parameters,
     moments and losses bit-equal (every collective over one rank is the
     identity and ``gather_leaf`` returns the leaf), each step's host ms
     and the peak GB, the mesh steps' flash launches (path ``lm_train
     qwen3-4b mesh (1, 1)``), and the mesh step's parameters saved with
     their shardings; the same at bf16 parameters, bit-equal too (path
     ``lm_train qwen3-4b mesh (1, 1) bfloat16``, the bf16 flash kernel
     at every launch); (b) one full-width dbrx-132b MoE layer in bf16
     (16 x 6144 x 10752 slabs, 8 x 128 tokens): a forward and a backward through
     ``moe_sharded`` at ep = 1 against ``moe_local``, outputs, aux and
     every gradient bit-equal; (c) ``compressed_psum`` over the one-rank
     world bit-equal to ``quantize_roundtrip``; (d) a 1-stage GPipe
     forward against the sequential stack (2e-5); (e) ``elastic_restart``
     from (a)'s checkpoint of the mesh step's parameters, every leaf
     bit-equal (the moments' sharded round trip is the CPU and card
     tests').
 28. the dry-run (``launch/{specs,costing,dryrun}.py``,
     ``roofline/{model,collectives}.py``) against the card, on phase 27's
     cell, at float32 and at bf16 parameters: (a) that step run once on
     the card under ``FlopCounterMode`` (an NCCL group of one rank; paths
     ``lm_train qwen3-4b dry-run check`` and ``... check bf16``) and
     counted by the dry-run (``build_cell_from(dtype=)``) on a fake group
     of one rank (fake tensors, plain versions): the dry-run's GEMM
     FLOPs outside the flash forward's plain version, which the card
     runs in its kernel out of the counter's sight, equal the card's
     exactly, the attention's share printed apart; (b) the dry-run's
     t_compute and t_memory at the H100 constants (FLOPs at the peak of
     the step's type: float32 67 TFLOP/s with TF32 off, bf16 989; the
     bytes also with the flash kernel's analytic traffic in place of the
     plain forward's) beside phase 27's measured step ms at that type
     and their ratio, not gated; (c) the
     production cell qwen3-4b decode_32k on the 256-rank ``pod1`` fake
     mesh and its roofline terms.

Every printed line also goes to ``chiprun_out/chip_smoke.log`` and every
number to ``chiprun_out/chip_smoke.json``.  Each serving path resets the launch counts just before it and reads them
just after.  The line before the last is a JSON object with every
kernel's numbers: its ``launches`` is the sum over the serving paths
that ran it, and ``launches_by_path`` gives each path's count (the
ViTDet-L waves of phase 3, its beta-0 wave, the int8 waves of phase 5,
the two Qwen3-4B waves of phase 7, one wave of each SSM model, the
``mixed_forward_ssm`` forward, each simulation of phase 13, and each
multi-client run and burst wave of phase 14, named ``mc ...``, the
two training runs of phase 15, ``train ...``, the LM training runs
of phase 16, ``lm_train ...``, the exact lane of phase 17, the host- and
device-cache simulations of phase 18, the int8 LM waves of phase 19,
the calibration of phase 20, the half lanes of phases 21 and 22, the
MoE waves of phase 23, the models of phase 24 and phase 25's training
runs, ``lm_train <config>``, and MoE lanes, ``<config> <lane>
[mixed]``, named by their config and path, every autotuner sweep of
the run, ``autotune``, and phase 28's counted steps, ``lm_train qwen3-4b
dry-run check [bf16]``);
the ``int8_matmul`` row also gives phase 19's decode-step device us and
bound, and every row but ``ssd_scan``'s its ``f16`` / ``bf16`` numbers.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
SEED = 0
BETA = 2
B = 2                       # wave size of the serving phases (B bucket 2)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32 = 67e12           # H100 SXM float32 FMA outside tensor cores
PEAK_INT8 = 1979e12         # H100 SXM dense int8 tensor-core ops/s
PEAK_TF32 = 495e12          # H100 SXM dense TF32 tensor-core flops/s
PEAK_HALF = 989e12          # H100 SXM dense fp16 / bf16 tensor-core flops/s
TF32_PRODUCTS = 3           # 3xTF32: float32 accuracy from three products
# flash_attention's extra checks (B, T, S, H, KV, Dh): every head width the
# kernel builds, T and S off its 64-row tiles, S < T, GQA groups 1 and 4
FLASH_CASES = ((2, 130, 77, 4, 4, 16), (2, 200, 300, 8, 2, 32),
               (1, 333, 200, 16, 4, 64), (2, 200, 130, 8, 2, 128))
ATTN_TOL = 1e-4             # float32 attention, kernel vs plain, absolute
DECODE_TOL = 1e-5           # float32 decode attention, another sum order
LM_RTOL = 1e-3              # 4-layer Qwen3 logits, card vs CPU, relative
# the LM serving waves (8 new tokens, cut from 16 to keep the whole run
# within its time limit: a decode step's launches and ms do not depend
# on the count)
LM_B, LM_T, LM_NEW = 8, 128, 8
LM_MAX_LEN = 152
LM_LONG_LENS = (8192, 6000, 4097, 2048, 513, 64, 1, 8192)
SSD_TOL = 1e-4              # SSD scan, kernel vs plain, of the largest value
SSM_B, SSM_T, SSM_NEW = 8, 1024, 8    # the SSM serving waves
# phase 24: whisper-medium's requests (1500 stub frames of width 1024 and
# a decoder prompt) and llava-next-mistral-7b's (2880 stub image
# embeddings of width 1024 and a text prompt), each of MM_NEW greedy
# tokens (the prefill's, then MM_NEW - 1 decode steps), every model at
# its first MM_LAYERS layers (whisper-medium: as many encoder layers).
# Both cut (from 16 tokens and full depth) to keep the whole run within
# its time limit: a decode step's launches a layer and a layer's ms do
# not depend on them
WHISPER_B, WHISPER_T = 8, 32
LLAVA_B, LLAVA_T = 2, 128
MM_NEW, MM_LAYERS = 8, 8
SSD_NS = (16, 32, 64, 128)  # the state sizes ssd_scan.cu is built for
# the four kernels one ssd_scan call runs, in order
SSD_STAGES = ("ssd_scores_kernel", "ssd_states_kernel", "ssd_pass_kernel",
              "ssd_outputs_kernel")
SSD_REF_SHAPES = ((2, 128, 8, 1, 32, 16, 32), (1, 200, 16, 2, 64, 32, 64),
                  (2, 64, 4, 4, 16, 64, 32), (1, 96, 8, 1, 128, 64, 96))
POOL_TOL = 1e-6             # mean of four floats, absolute
HALF_EQUAL = 0.99           # half attention: bit-equal share to plain
# avg_pool's other paths (shape, d, base offset in floats): W * C = 30 and
# Wo * C = 9 (4-byte copies), a base 4 bytes off 16, a row of three
# chunks, 1024 channels (80 KB of shared memory), d = 4 at the frame
POOL_CASES = (((2, 10, 10, 3), 2, 0), ((2, 16, 12, 3), 4, 0),
              ((2, 64, 64, 3), 2, 1), ((1, 4, 4096, 3), 2, 0),
              ((1, 16, 16, 1024), 2, 0), ((2, 1024, 1024, 3), 4, 0))
# decode_attention's phase-2 shapes (B, S, H, KV, Dh) and kv_len: the
# Qwen3-4B serving step (its kernels-line row), zamba2-1.2b's shared
# attention (G = 1) a few steps into a wave, a ragged long cache and
# dbrx-132b's serving step (G = 6: the kernel rounds the group up to 8)
DECODE_SHAPES = {
    "serving": ((LM_B, LM_MAX_LEN, 32, 8, 128), (LM_T + 1,) * LM_B),
    "dbrx": ((LM_B, LM_MAX_LEN, 48, 8, 128), (LM_T + 1,) * LM_B),
    "zamba2": ((SSM_B, SSM_T + SSM_NEW, 32, 32, 64), (SSM_T + 8,) * SSM_B),
    "ragged": ((LM_B, LM_LONG_LENS[0], 32, 8, 128), LM_LONG_LENS),
    # phase 24's steps (float32 only): phi4-mini-3.8b (G = 3: the kernel
    # rounds the group up to 4), deepseek-7b (MHA, G = 1 at Dh = 128) and
    # whisper-medium's decoder (G = 1 at Dh = 64, its 32-token prompt)
    "phi4": ((LM_B, LM_MAX_LEN, 24, 8, 128), (LM_T + 1,) * LM_B),
    "deepseek7b": ((LM_B, LM_MAX_LEN, 32, 32, 128), (LM_T + 1,) * LM_B),
    "whisper": ((WHISPER_B, WHISPER_T + MM_NEW + 8, 16, 16, 64),
                (WHISPER_T + 1,) * WHISPER_B)}
# flash_attention's phase-24 shapes (float32 only), name -> (B, T, S, H,
# KV, Dh, causal): whisper-medium's encoder (S off the 64-key tile), its
# cross-attention at the prompt's 32 query rows and at a decode step's
# one, and llava-next-mistral-7b's causal prefill of 2880 image and 128
# text tokens
FLASH_MM = {"whisper_encoder": (8, 1500, 1500, 16, 16, 64, False),
            "whisper_cross_T32": (8, 32, 1500, 16, 16, 64, False),
            "whisper_cross_T1": (8, 1, 1500, 16, 16, 64, False),
            "llava_causal": (2, 3008, 3008, 32, 8, 128, True),
            # phase 25's training forward: whisper's decoder, causal over
            # 64 tokens, and its cross-attention from 64 tokens
            "whisper_train_causal": (8, 64, 64, 16, 16, 64, True),
            "whisper_train_cross": (8, 64, 1500, 16, 16, 64, False)}
# decode_attention's kv_len edges (B, S, H, KV, Dh), kv_len: no key, one
# key, a split boundary, kv_len = S, runs wholly past kv_len, G = 1 over
# four kv heads a block and over one (KV = 6), G = 4 / 8 / 16, and
# dbrx-132b's G = 6 at its serving cache (no key, one, a split boundary,
# the prompt, the full cache), phi4-mini-3.8b's G = 3 and deepseek-7b's
# G = 1 at Dh = 128 at theirs
DECODE_EDGES = (((2, 256, 8, 2, 64), (0, 1)), ((2, 256, 8, 2, 64), (64, 256)),
                ((3, 300, 8, 8, 32), (5, 150, 299)),
                ((2, 200, 8, 1, 16), (33, 200)),
                ((2, 300, 16, 1, 32), (0, 300)),
                ((3, 777, 8, 4, 16), (1, 511, 777)),
                ((2, 200, 6, 6, 64), (77, 200)),
                ((3, LM_MAX_LEN, 48, 8, 128), (0, 1, LM_MAX_LEN)),
                ((2, LM_MAX_LEN, 48, 8, 128), (64, LM_T)),
                ((3, LM_MAX_LEN, 24, 8, 128), (0, 1, LM_MAX_LEN)),
                ((2, LM_MAX_LEN, 32, 32, 128), (64, LM_T)))
E2E_RTOL = 1e-3             # 8-block forward, card vs CPU, relative
OFFLOAD_FRAMES = 20         # frames of each phase-13 simulation
# frames of phase 13's walkS profile, the first PROFILE_SKIP warming the
# motion model: 3 x 21 sample configs (the launcher's 8 frames give 126
# samples; cut to keep the whole run within its time limit)
PROFILE_FRAMES = 5
# phase 13's simulations: (policy, video), each against the 4G trace
OFFLOAD_RUNS = (("TrackB2B", "cycleS"), ("ViTMAlis", "cycleS"),
                ("ViTMAlis+Reuse", "cycleS"), ("ViTMAlis+Reuse", "parkS"))
# phase 13's card-vs-CPU simulations, (policy, video, frames): TrackB2B
# offloads at frame 1 (cut from 16 frames, which added one at frame 15,
# to keep the whole run within its time limit), ViTMAlis+Reuse on parkS
# at 1 (full), 14 (LOW), 16 (REUSE) and 19 (LOW and REUSE)
CROSS_RUNS = (("TrackB2B", "cycleS", 8), ("ViTMAlis+Reuse", "parkS", 20))
DET_RTOL = 1e-3             # its detections, card vs CPU, relative
# phase 14, the multi-client edge: run A's clients (video, 4G trace index
# = position), run B's slow-uplink clients, their frames, the server's
# B buckets and the clips' seed (bench_multiclient's)
MC_VIDEOS = ("walkS", "cycleS", "driveN", "walkB")
MC_SLOW_VIDEOS = ("parkS", "parkS", "parkS", "driveN")
MC_FRAMES, MC_SLOW_FRAMES = 8, 20
MC_B_BUCKETS = (1, 2, 4)
MC_SEED = 17
# run B's uplink: bench_multiclient's SLOW_UPLINK compounds ten
# bufferbloat windows (each 70% of the throughput, 1.15x the RTT) over
# 256 px SIM frames; these 1024 px frames ship 16x the bytes, so two
# windows (0.7^2 = 49% of the uplink) give its payloads the transit time
# the ten (0.7^10 = 2.8%) give the SIM ones (16 x 2.8% = 45%)
MC_SLOW_WINDOWS = 2
MC_CROSS_CLIENTS, MC_CROSS_FRAMES = 2, 5    # phase 14's card-vs-CPU runs
ALPHA_REPS = 3              # timed waves per B behind the measured alpha
QUANT_E2E_RTOL = 0.05       # 8-block quantized forward, card vs CPU
# phase 15, training
TRAIN_STEPS = 6             # full-width ViTDet-L steps
GRAD_TOL = 1e-4             # Function vs plain autograd, of the largest grad
TRAIN_GRAD_TOL = 1e-3       # analytic vs autograd backward, of a leaf's max
# A step in other float32 arithmetic (the plain versions, the CPU) takes
# the other branch at a few ReLU positions of the head whose input is
# within its rounding of 0, and each such position adds or drops its one
# term of the gradient of every leaf in front of that ReLU.  That weighs
# where a leaf's gradient sums few terms: the head's convs in front of
# its ReLUs (one level's positions; 1024 a frame at stride 32) and
# pos_emb (one token a row).  These leaves (``kink_leaf``) are held to
# KINK_GRAD_TOL when each route takes its own branches, and every leaf
# to TRAIN_GRAD_TOL when both take the same ones.  On an H100 the first
# full-width step flips 14 positions against the plain route and its
# worst kink leaf reads 3.5e-3 (pos_emb, card vs CPU; 2.0e-3 against the
# plain route): the bound sits just above that.
KINK_GRAD_TOL = 5e-3
TRAIN_LOSS_RTOL = 1e-4      # the 2-block model's loss, card vs CPU
# benchmarks/common.py's SIM recipe (1800 steps, peak lr 5e-4) at 150 of
# its steps, to keep the whole run within its time limit (at 900 steps
# the last-100 mean loss read 0.37 against 3.91 over the first 50, at
# step 200 of 450 1.71, over steps 100-200 of 200 2.54: the check keeps
# a wide margin at 150)
SIM_STEPS, SIM_PEAK_LR = 150, 5e-4
F1_VIDEOS, F1_FRAMES, F1_SEED = ("walkS", "walkB", "cycleS"), 16, 23
BWD_MARKS = ("window_attention_bwd", "flash_attention_bwd")
# phase 16, LM training: causal GQA flash at Qwen3-4B's and the ~100M
# config's training shapes, (B, T, H, KV, Dh)
LM_FLASH_SHAPES = ((1, 1024, 32, 8, 128), (4, 256, 10, 2, 64))
# examples/train_lm_100m.py:33-43: qwen3-4b scaled to ~100M parameters
LM_100M = dict(name="qwen3-100m", n_layers=12, d_model=640, n_heads=10,
               n_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
               max_seq_len=4096)
# the example's run at 40 of its 300 steps (to keep the whole script
# within its time limit; at step 60 the last 10 losses' mean sat 2.1
# below the first, and the check asks for 0.1)
LM_100M_STEPS, LM_100M_B, LM_100M_T = 40, 4, 256
LM_100M_RESUME = 5          # steps of the resumed run
LM_TRAIN_T = 1024           # full-width LM steps' sequence length
LM_TRAIN_STEPS = 2          # full-width Qwen3-4B steps at B = 1
SSM_TRAIN_STEPS, SSM_TRAIN_B = 2, 2   # full-width mamba2 / zamba2 steps
LM_CROSS_T = 128            # the few-layer card-vs-CPU steps
LM_HALF_STEPS = 2           # full-depth bf16 Qwen3-4B steps at B = 1
LM_GRAD_TOL = 1e-3          # LM step gradients, of each leaf's largest
CALIB_FRAMES = 8            # phase 20's frames a scenario
# phase 22: the lanes (name, tree dtype, cache dtype) and the bf16
# card-vs-CPU limit (tests/test_torch_half_lm.py's bf16 lane)
LM_HALF_LANES = (("bf16", "bfloat16", "float32"),
                 ("fp16", "float16", "float32"),
                 ("bf16-cache", "float32", "bfloat16"))
LM_BF16_RTOL = 3e-2
# phase 23: the MoE configs' depth cut (dbrx-132b: 4 MoE layers;
# deepseek-v2-236b: its dense layer and 3 MoE layers), a routing near-tie
# (the k-th and (k+1)-th expert's probabilities this close: float32
# rounding between routes can swap them), and the narrow card-vs-CPU
# configs (the published layout: dbrx's GQA at G = 6 and Dh = 128,
# deepseek-v2's MLA, shared experts and leading dense layer)
MOE_LAYERS = 4
MOE_ROUTE_TIE = 1e-5
MOE_NARROW = {
    "dbrx-132b": dict(n_layers=2, d_model=512, n_heads=12, n_kv_heads=2,
                      head_dim=128, d_ff=1024, vocab_size=4096,
                      moe=dict(n_experts=8, d_ff_expert=512)),
    "deepseek-v2-236b": dict(
        n_layers=3, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=1024, vocab_size=4096,
        moe=dict(n_experts=16, d_ff_expert=128, d_ff_dense=1024),
        mla=dict(kv_lora_rank=128, q_lora_rank=192, qk_nope_head_dim=64,
                 qk_rope_head_dim=32, v_head_dim=64))}
# phase 25 (A): whisper-medium's training batches (8 x (1500 stub frames +
# 64 tokens), full depth) and llava-next-mistral-7b's (2 x (2880 image
# embeddings + 128 tokens)) at 8 of its 32 layers: 7.24 G parameters x 16
# bytes (weights, gradients, two AdamW moments) is 116 GB, which no 80 GB
# card holds; 8 layers are 2.03 G, 32.5 GB before activations.  Their
# narrow card-vs-CPU configs keep the published layout (whisper's 1500
# frames, llava's 2880 image embeddings of width 1024 and G = 4) at 2
# layers and narrow widths
WHISPER_TRAIN_B, WHISPER_TRAIN_T, WHISPER_TRAIN_LAYERS = 8, 64, 8
LLAVA_TRAIN_B, LLAVA_TRAIN_T, LLAVA_TRAIN_LAYERS = 2, 128, 8
MM_TRAIN_STEPS = 2
MM_NARROW = {
    "whisper-medium": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                           head_dim=64, d_ff=1024, vocab_size=4096,
                           encdec=dict(n_encoder_layers=2)),
    "llava-next-mistral-7b": dict(n_layers=2, d_model=256, n_heads=4,
                                  n_kv_heads=1, head_dim=64, d_ff=512,
                                  vocab_size=4096)}
# phase 25 (B): the MoE serving lanes (deepseek-v2-236b's int8 lane is
# refused: the reference's fails at its first forward) and each lane's
# card-vs-CPU logit limit on the narrow configs: the half types' as
# tests/test_torch_half_lm.py holds the two packages, the int8 lane's as
# phase 19 holds its 2-layer model
MOE_LANES = ("bf16", "fp16", "int8")
LANE_RTOL = {"bf16": LM_BF16_RTOL, "fp16": 4e-3, "int8": 0.05}
# a half router's routing near-tie (MOE_ROUTE_TIE holds a float32 one).
# Each logit l is a float32 sum rounded once to the tree's type, of a
# hidden state each route also rounded to the type: two roundings a
# route, each within u |l| (u the type's unit roundoff), so two routes'
# logits differ by at most eps = 4 u L, L the token's largest |logit|.
# Shifting each logit by at most eps moves the log of a probability
# ratio by at most 2 eps, so the k-th and (k+1)-th experts can swap only
# if p_k - p_(k+1) <= p_k (1 - exp(-2 eps)) <= 2 eps p_k = 8 u L p_k
HALF_ROUTE_ULPS = 8
UNIT_ROUNDOFF = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8}
# phase 25 (C): the narrow MoE train steps, B x T (two microbatches of 2
# at accum 2)
MOE_TRAIN_B, MOE_TRAIN_T, MOE_TRAIN_STEPS = 4, 128, 2
# phase 21: the reference's shipped point, an fp16 tree and a bf16 tree
HALF_SPECS = (("int8", "fp16", 1), ("fp16", "fp32", 0), ("bf16", "fp32", 0))
HALF_E2E = (("int8", "fp16", 1), ("bf16", "fp32", 0))   # card vs CPU
# their limits, of the largest feature: the CPU tests' (the half types'
# own rounding; int8 rows at a rounding tie), tests/test_torch_half_vit.py
HALF_E2E_RTOL = {"int8+fp16-p1": 0.05, "fp16": 3e-3, "bf16": 2.5e-2}
QUANT_SPEC = ("int8", "fp32", 1)
MESH_LAYERS = 4             # phase 27 (a): full-width Qwen3-4B layers
TILE_REPS = 10              # phase 26: a candidate's device us, best of
AB_REPS = 3                 # phase 26 (d): host-timed calls a measurement
# phase 26: the autotuner's cache, emptied at the start of every run so
# that every run sweeps from empty and reads no other run's winners
AUTOTUNE_CACHE = ROOT / "build" / "chip_smoke_autotune"
# the GEMMs of the quantized full-width model, (K, N): patch embed,
# fused QKV, w_o, MLP up, MLP down (15 heads of 64 after pruning)
GEMM_SHAPES = ((768, 1024), (1024, 2880), (960, 1024), (1024, 4096),
               (4096, 1024))
GEMM_M = 8192               # tokens of a full-resolution wave of two
# the kernels of the float32 full-res + mixed beta-2 serving path
FP32_PATH = ("window_attention", "flash_attention", "pack_pos",
             "restore_gather", "avg_pool")
# the kernels of a beta-0 (restore at input) wave
BETA0_PATH = ("window_attention", "flash_attention", "avg_pool",
              "nn_upsample")

# kernel name -> (source in the repo, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "window_attention": ("src/repro_torch/csrc/window_attention.cu",
                         "src/repro/kernels/window_attention/kernel.py:82"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:94"),
    "pack_pos": ("src/repro_torch/csrc/fused_serving.cu",
                 "src/repro/kernels/fused_serving/kernel.py:48"),
    "restore_gather": ("src/repro_torch/csrc/fused_serving.cu",
                       "src/repro/kernels/fused_serving/kernel.py:83"),
    "avg_pool": ("src/repro_torch/csrc/avg_pool.cu",
                 "src/repro/kernels/mixed_res_pool/kernel.py:46"),
    "nn_upsample": ("src/repro_torch/csrc/nn_upsample.cu",
                    "src/repro/kernels/mixed_res_pool/kernel.py:63"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul/kernel.py:52"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:81"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:104"),
}
# kernel name -> the fragment of its CUDA kernels' names in a trace (the
# four kernels of one ssd_scan call share theirs)
DEVICE_NAMES = {
    "window_attention": "window_attention_kernel",
    "flash_attention": "flash_attention_kernel",
    "pack_pos": "pack_pos_kernel", "restore_gather": "restore_gather_kernel",
    "avg_pool": "avg_pool_kernel", "nn_upsample": "nn_upsample_kernel",
    "int8_matmul": "int8_matmul_kernel",
    "decode_attention": "decode_attention_kernel", "ssd_scan": "ssd_"}


# the fp16 / bf16 entry points of window and flash attention launch only
# their half kernels (the half tensor-core design): kernel name -> the
# fragment of that kernel's name in a trace, and the design
HALF_KERNELS = {
    "window_attention": ("window_attention_kernel_half",
                         "mma.sync m16n8k16 + cp.async + ldmatrix"),
    "flash_attention": ("flash_attention_kernel_half", "wgmma + TMA")}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


LOG = None                  # chiprun_out/chip_smoke.log, opened by main()


T_START = time.perf_counter()


def say(*a) -> None:
    """A line to stdout and to the log, there after the seconds since the
    script started."""
    print(*a, flush=True)
    if LOG is not None:
        print(f"[{time.perf_counter() - T_START:7.1f}]", *a, file=LOG,
              flush=True)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    # the autotuner's cache: a fresh directory, so that the run sweeps
    # from empty and reads no winner of another run or card
    shutil.rmtree(AUTOTUNE_CACHE, ignore_errors=True)
    AUTOTUNE_CACHE.mkdir(parents=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(AUTOTUNE_CACHE)
    os.environ.pop("REPRO_AUTOTUNE", None)
    global LOG
    OUT_DIR.mkdir(exist_ok=True)
    LOG = open(OUT_DIR / "chip_smoke.log", "w")
    try:
        result = run(torch)
    except Exception:                        # every phase failure
        traceback.print_exc()
        traceback.print_exc(file=LOG)
        return 1
    finally:
        LOG.flush()
    say(json.dumps({"kernels": result}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------


def run(torch):
    import torch.nn.functional as F

    from repro_torch.configs.vitdet_l import CONFIG
    from repro_torch.core import partition as pt
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import build, dispatch
    from repro_torch.quant import qtensor as qt

    # phase 1 -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    say(smi.stdout.strip())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dispatch.disable_tf32()
    t0 = time.perf_counter()
    logs = build.build()
    say(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    for fn, regs, spills in ptxas_kernels(logs, [f for f, _ in
                                                 HALF_KERNELS.values()]):
        say(f"  half design kernel {fn}: {regs} registers, spill stores / "
            f"loads {spills[0]} / {spills[1]} bytes")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = CONFIG
    part = vb.vit_partition(cfg)
    nR, dd = part.n_regions, part.windows_per_full_region
    w2, D, H, Dh = part.window ** 2, cfg.d_model, cfg.n_heads, cfg.head_dim
    T = part.grid_h * part.grid_w
    plans = mixed_plans(pt, nR)
    lb = max(pt.length_bucket(pt.plan_n_windows(p, part),
                              pt.length_bucket_set(part)) for p in plans)
    arrays, _ = pt.stack_plan_layouts(
        [pt.plan_layout(p.states, lb, part) for p in plans])
    lay = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}

    # phase 2 -------------------------------------------------------------
    say(f"phase 2: kernels vs plain versions at full width (B={B}, "
        f"T={T}, D={D}, H={H}x{Dh}, w2={w2}, length bucket {lb}), at "
        f"float32, fp16 and bf16")
    rows = {}

    def put(name, err, k_ms, p_ms, l_ms, bound_ms, bound_by, d_us,
            dt=torch.float32, **extra):
        """One kernels-line row, or at fp16 / bf16 its ``f16`` / ``bf16``
        entry: ``ms`` is host-clocked back-to-back relaunches (CUDA
        events), ``device_us`` the kernel's own device time per launch
        (trace); ``extra`` adds keys such as ``cold_us``.  Returns it."""
        r = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": l_ms, "device_us": d_us, **extra}
        suf = build.FLOAT_SUFFIX[dt]
        if dt == torch.float32:
            rows[name] = r
        else:
            rows[name][suf] = r
        say(f"  {name} {suf}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
            f"device_us={d_us:.2f} plain_ms={p_ms:.4f} library_ms="
            f"{'null' if l_ms is None else f'{l_ms:.4f}'} "
            f"bound_ms={bound_ms:.4f} ({bound_by})"
            + "".join(f" {k}={v}" for k, v in extra.items()))
        return r

    t_phase = time.perf_counter()
    gemm, lm_kernels = {}, {}
    for dt in build.FLOAT_TYPES:
        g, lm = kernel_checks(torch, F, dev, gen, cfg, part, lay, arrays, lb,
                              put, dt)
        gemm[build.FLOAT_SUFFIX[dt]] = g
        lm_kernels.update(lm)
        torch.cuda.empty_cache()
    from repro_torch.configs.dbrx_132b import CONFIG as DBRX
    lm_kernels["int8_matmul_dbrx"] = moe_int8_gemm_checks(torch, DBRX, dev)
    say(f"  phase 2: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # each serving path's launch counts, reset just before it and read
    # just after: kernel -> {path: launches}
    by_path = {name: {} for name in KERNEL_SOURCES}

    def count(path, launches):
        for name, n in launches.items():
            if n:
                by_path[name][path] = n

    # phase 3 -------------------------------------------------------------
    launches, b0_launches, lat = serve(torch, cfg, dev, gen, plans, pt)
    count("vitdet-l", launches)
    count("vitdet-l beta 0", b0_launches)

    # phase 4 -------------------------------------------------------------
    cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

    # phase 5 -------------------------------------------------------------
    qlaunches, qlat = serve_quant(torch, cfg, dev, gen, plans, pt, qt)
    count("vitdet-l int8", qlaunches)
    lat["quant"] = qlat

    # phase 6 -------------------------------------------------------------
    quant_cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

    # phase 7 -------------------------------------------------------------
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    lm_launches, lat["lm"] = serve_lm(torch, QWEN, dev)
    count("qwen3-4b", lm_launches)
    lat["lm"]["kernels"] = lm_kernels

    # phase 8 -------------------------------------------------------------
    lat["lm"]["card_vs_cpu"] = lm_cross_check(torch, QWEN.replace(n_layers=4),
                                              dev)

    # phase 9 -------------------------------------------------------------
    from repro_torch.configs.mamba2_370m import CONFIG as MAMBA
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    lat["ssm"] = {"kernels": ssd_kernel_checks(torch, dev, gen, put)}

    # phases 10 and 11 ------------------------------------------------------
    for phase, c in ((10, MAMBA), (11, ZAMBA)):
        ln, lat["ssm"][c.name] = serve_ssm(torch, c, dev, phase)
        count(c.name, ln)
    count("mamba2-370m mixed_forward_ssm", {"ssd_scan": lat["ssm"][
        MAMBA.name]["mixed_forward_ssm"]["ssd_scan_launches"]})

    # phase 12 ------------------------------------------------------------
    lat["ssm"]["card_vs_cpu"] = {
        c.name: lm_cross_check(torch, c, dev, phase=12, T=2 * 256)
        for c in (MAMBA.replace(n_layers=4), ZAMBA.replace(n_layers=6))}
    say(f"  phases 3-12: {time.perf_counter() - t_phase:.1f} s")

    # phase 13 ------------------------------------------------------------
    lat["offload"] = serve_offload(torch, cfg, dev, count)

    # phase 14 ------------------------------------------------------------
    lat["multiclient"] = serve_multiclient(torch, cfg, dev, count)

    # phase 15 ------------------------------------------------------------
    lat["train"] = train_phase(torch, cfg, dev, gen, count)

    # phase 16 ------------------------------------------------------------
    lat["lm_train"] = lm_train_phase(torch, dev, count)

    # phase 17 ------------------------------------------------------------
    lat["exact_lane"] = exact_lane(torch, cfg, dev, count)

    # phase 19 (phase 18 runs inside phase 13) ----------------------------
    lat["lm_int8"] = lm_int8(torch, QWEN, dev, lat["lm"], count)
    rows["int8_matmul"]["decode_step_device_us"] = \
        lat["lm_int8"]["gemms"]["decode_step_device_us"]
    rows["int8_matmul"]["decode_step_bound_us"] = \
        lat["lm_int8"]["gemms"]["decode_step_bound_us"]

    # phase 20 ------------------------------------------------------------
    lat["calibrate"] = calibrate_phase(torch, cfg, dev, count)

    # phase 21 (its cache check runs inside phase 13) ----------------------
    lat["vit_half"] = vit_half_phase(torch, cfg, dev, count, plans, lat)
    lat["vit_half"]["host_cache_fp16"] = lat["offload"].pop(
        "host_cache_fp16")

    # phase 22 ------------------------------------------------------------
    lat["lm_half"] = lm_half_phase(torch, QWEN, dev, lat["lm"], count)

    # phase 23 ------------------------------------------------------------
    lat["moe"] = moe_phase(torch, dev, count)

    # phase 24 ------------------------------------------------------------
    lat["multimodal"] = mm_phase(torch, dev, count)

    # phase 25 ------------------------------------------------------------
    lat["last_lanes"] = last_lanes_phase(torch, dev, count, lat["moe"])

    # phase 26 ------------------------------------------------------------
    lat["autotune"] = autotune_phase(torch, dev, count)
    from repro_torch.kernels import autotune
    count("autotune", autotune.SWEEP_LAUNCHES)   # every sweep of the run

    # phase 27 ------------------------------------------------------------
    lat["mesh"] = mesh_phase(torch, dev, count)

    # phase 28 ------------------------------------------------------------
    lat["dryrun"] = dryrun_phase(
        torch, dev, count, lat["mesh"]["train"]["mesh"]["step_ms"],
        lat["mesh"]["train_bf16"]["mesh"]["step_ms"])

    out = []
    for name in KERNEL_SOURCES:
        src, replaces = KERNEL_SOURCES[name]
        r = rows[name]
        check(by_path[name], f"{name} launched on no serving path")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": sum(by_path[name].values()),
                    "launches_by_path": by_path[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "device_us": r["device_us"],
                    **{k: r[k] for k in ("cold_us", "decode_step_device_us",
                                         "decode_step_bound_us", "f16",
                                         "bf16") if k in r}})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi.stdout.strip(), "kernels": out, "waves": lat,
         "int8_gemm_shapes": gemm}, indent=1))
    return out


def gemm_checks(torch, i8, qt, dev, gen, n_layers, dt):
    """int8_matmul kernel vs plain version with ``dt`` out, bit-equal, at
    the quantized model's GEMM shapes (timed: kernel, plain,
    ``torch._int_mm`` as the library yardstick, the ``dt`` ``torch.matmul``
    of the same shape for context, and the row quantization of the GEMM's
    input as the int8 lane runs it) and at a ragged shape (checked
    only).  Returns the timed rows."""
    from repro_torch.kernels.build import FLOAT_SUFFIX
    suf, es = FLOAT_SUFFIX[dt], torch.finfo(dt).bits // 8
    out = []
    for (M, K, N) in [(GEMM_M, K, N) for K, N in GEMM_SHAPES] + \
            [(1000, 100, 130), (1000, 960, 2880)]:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8).t()
        sx = torch.rand(M, generator=gen, device=dev) * 0.02 + 1e-3
        sw = torch.rand(N, generator=gen, device=dev) * 0.02 + 1e-3
        got = i8.int8_matmul_cuda(xq, wq, sx, sw, dt)
        want = i8.int8_matmul_plain(xq, wq, sx, sw, dt)
        check(got.dtype == dt and torch.equal(got, want),
              f"int8_matmul {suf} {M}x{K}x{N}: kernel differs from plain "
              f"by up to {float((got.float() - want.float()).abs().max())}")
        if M != GEMM_M:
            say(f"  int8_matmul {suf} {M}x{K}x{N} (ragged): bit-equal")
            continue
        k_ms = timed(torch, lambda: i8.KERNEL.relaunch(1))
        d_us = device_us(torch, lambda: i8.KERNEL.relaunch(1),
                         DEVICE_NAMES["int8_matmul"])
        # the other output tile width, checked and timed for the record
        tile = i8.tile_n(N, K)
        check(i8.tile_for(M, N, K) == {"bn": tile}, "phase 2 runs before "
              "any sweep: the default tile")
        other = i8.int8_matmul_cuda(xq, wq, sx, sw, dt, bn=384 - tile)
        check(torch.equal(other, want), f"int8_matmul {suf} {M}x{K}x{N}"
              f": the {384 - tile}-wide tile differs from plain")
        o_ms = timed(torch, lambda: i8.KERNEL.relaunch(1))
        p_ms = timed(torch, lambda: i8.int8_matmul_plain(xq, wq, sx, sw, dt))
        l_ms = timed(torch, lambda: torch._int_mm(xq, wq))
        xf = torch.randn((M, K), generator=gen, device=dev).to(dt)
        wf = torch.randn((K, N), generator=gen, device=dev).to(dt)
        f_ms = timed(torch, lambda: torch.matmul(xf, wf))
        r_ms = timed(torch, lambda: qt._quantize_rows(xf.float()))
        nbytes = M * K + K * N + 4 * (M + N) + es * M * N
        b_ms, b_by = bound(nbytes, 2 * M * N * K, PEAK_INT8)
        row = {"M": M, "K": K, "N": N, "ms": k_ms, "device_us": d_us,
               "plain_ms": p_ms, "library_ms": l_ms, "matmul_ms": f_ms,
               "row_quant_ms": r_ms, "bound_ms": b_ms, "bound_by": b_by,
               "tile_n": tile, f"ms_tile_{tile}": k_ms,
               f"ms_tile_{384 - tile}": o_ms}
        out.append(row)
        say(f"  int8_matmul {suf} {M}x{K}x{N}: bit-equal kernel_ms="
            f"{k_ms:.4f} (128x{tile} tiles; 128x{384 - tile}: {o_ms:.4f}) "
            f"plain_ms={p_ms:.4f} int_mm_ms={l_ms:.4f} "
            f"{suf}_matmul_ms={f_ms:.4f} row_quant_ms={r_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        say(f"    {2 * M * N * K / k_ms / 1e9:.1f} TOPS, "
            f"{nbytes / k_ms / 1e6:.1f} GB/s, {b_ms / k_ms:.3f} of its bound")
        del xq, wq, xf, wf, got, want, other
    by_k = {r["K"]: r["row_quant_ms"] for r in out}
    block = sum(by_k[K] for K, _ in GEMM_SHAPES[1:])
    say(f"  row quantization of {suf} inputs per full-res wave ({n_layers} "
        f"blocks x {block:.4f} ms + patch embed {by_k[768]:.4f} ms): "
        f"{n_layers * block + by_k[768]:.4f} ms")
    return out


def bound(nbytes, nops, peak):
    """The least time of a function (ms): its bytes over the memory rate
    or its operations over ``peak``, whichever is larger, and which."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / peak * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def mixed_plans(pt, nR):
    """Two clients' FULL/LOW/REUSE plans (40 and 24 transmitted windows
    at ViTDet-L's 16 regions: length buckets 48 and 24)."""
    a = np.zeros(nR, np.int8)
    a[[1, 6, 9, 14]] = pt.LOW
    a[[2, 7, 12]] = pt.REUSE
    b = np.full(nR, pt.LOW, np.int8)
    b[[0, 5, 10, 15]] = pt.REUSE
    b[[3, 4, 11, 13]] = pt.FULL
    return [pt.RegionPlan(a), pt.RegionPlan(b)]


def single_plans(pt, nR):
    """One client's plans as the offloading policies send them at
    ViTDet-L's 16 regions: twelve LOW regions beside four FULL, two FULL
    and two REUSE, and four REUSE."""
    out = []
    for reuse in ((), (0, 5), (0, 5, 10, 15)):
        states = np.full(nR, pt.LOW, np.int8)
        states[[0, 5, 10, 15]] = pt.FULL
        states[list(reuse)] = pt.REUSE
        out.append(pt.RegionPlan(states))
    return out


def rotating_plans(pt, nR):
    """Phase 14's run-A layouts: client i sends ``nR // 4`` LOW regions
    from offset ``i * nR // 4`` (bench_multiclient's RotatingMaskPolicy),
    the rest FULL: four distinct layouts of one length bucket."""
    n_low = nR // 4
    out = []
    for i in range(4):
        states = np.zeros(nR, np.int8)
        states[[(i * n_low + k) % nR for k in range(n_low)]] = pt.LOW
        out.append(pt.RegionPlan(states))
    return out


def reuse_wave_plans(pt, nR):
    """Three clients' FULL/LOW/REUSE plans as run B's sessions send them
    once their caches are warm: 4 LOW + 8 REUSE, 2 LOW + 12 REUSE and
    12 REUSE (20, 10 and 16 transmitted windows, one length bucket)."""
    q = nR // 4
    a = np.zeros(nR, np.int8)
    a[:q] = pt.LOW
    a[2 * q:] = pt.REUSE
    b = np.zeros(nR, np.int8)
    b[q:q + q // 2] = pt.LOW
    b[:q] = pt.REUSE
    b[2 * q:] = pt.REUSE
    c = np.full(nR, pt.REUSE, np.int8)
    c[3 * q:] = pt.FULL
    return [pt.RegionPlan(a), pt.RegionPlan(b), pt.RegionPlan(c)]


def mc_kernel_checks(torch, pt, part, fused, pool, dev, gen, D, img_size):
    """Phase 2 for phase 14: pack_pos, restore_gather and avg_pool exactly
    equal to their plain versions at the multi-client waves' inputs: the
    B=4 wave of the four rotating layouts (64-window bucket, no REUSE),
    and a B=3 wave padded to 4 whose REUSE rows come from three different
    clients' tile banks (pad row = a copy of sample 0, as
    ``ServerModel.infer_wave`` pads)."""
    nR, dd, w2 = part.n_regions, part.windows_per_full_region, \
        part.window ** 2
    edges = pt.length_bucket_set(part)
    nbank = nR * dd + nR
    pos_bank = torch.randn((nbank, w2, D), generator=gen, device=dev)
    img = (4, *img_size, 3)
    for name, plans in (("B=4 rotating", rotating_plans(pt, nR)),
                        ("B=3 padded to 4, REUSE from three banks",
                         reuse_wave_plans(pt, nR))):
        lb = pt.length_bucket(max(pt.plan_n_windows(p, part)
                                  for p in plans), edges)
        layouts = [pt.plan_layout(p.states, lb, part) for p in plans]
        arrays, _ = pt.stack_plan_layouts(layouts)
        npad = 4 - len(plans)
        lay = {k: torch.as_tensor(np.concatenate(
            [v, np.repeat(v[:1], npad, axis=0)]) if npad else v,
            device=dev) for k, v in arrays.items()}
        tiles = None
        if any(l.n_reuse for l in layouts):
            banks = [torch.randn((nR, dd, w2, D), generator=gen, device=dev)
                     for _ in layouts]
            rows = [bk.index_select(0, torch.as_tensor(
                np.where(l.reuse_ids < nR, l.reuse_ids, 0), device=dev,
                dtype=torch.long)) for bk, l in zip(banks, layouts)]
            tiles = torch.stack(rows + rows[:1] * npad)
        bank = torch.randn((4, nbank, w2, D), generator=gen, device=dev)
        p_args = (bank, pos_bank, lay["win_src"], lay["nw"])
        r_args = (torch.randn((4, lb, w2, D), generator=gen, device=dev),
                  lay["out_src"], lay["out_map"], part.window,
                  part.downsample, tiles)
        frames = torch.rand(img, generator=gen, device=dev)
        if npad:
            frames[len(plans):] = frames[:1]
        check(torch.equal(fused.pack_pos_cuda(*p_args),
                          fused.pack_pos_plain(*p_args)),
              f"pack_pos at the {name} wave: kernel differs from plain")
        check(torch.equal(fused.restore_gather_cuda(*r_args),
                          fused.restore_gather_plain(*r_args)),
              f"restore_gather at the {name} wave: kernel differs from "
              f"plain")
        check(torch.equal(pool.avg_pool_cuda(frames, part.downsample),
                          pool.avg_pool_plain(frames, part.downsample)),
              f"avg_pool at the {name} wave: kernel differs from plain")
        say(f"  pack_pos, restore_gather, avg_pool at phase 14's {name} "
            f"wave (length bucket {lb}, n_low "
            f"{[l.n_low for l in layouts]}, n_reuse "
            f"{[l.n_reuse for l in layouts]}): equal to plain")
        del bank, frames, tiles, r_args, p_args


def timed(torch, fn, target_ms: float = 100.0) -> float:
    """Mean milliseconds of ``fn()`` over back-to-back calls, by CUDA
    events around the whole run (warmed up first)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    n = int(min(200, max(3, target_ms / max(t0.elapsed_time(t1), 1e-3))))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def serve(torch, cfg, dev, gen, plans, pt):
    from repro_torch import convert
    from repro_torch.kernels import dispatch
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.serve.request import FeatureCache

    say(f"phase 3: ServerModel, {cfg.name} {cfg.n_layers} blocks D="
        f"{cfg.d_model}, {cfg.vit.img_size[0]}x{cfg.vit.img_size[1]} frames")
    t0 = time.perf_counter()
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    srv = ServerModel(cfg, params, b_buckets=(1, 2), device=dev)
    b0_plans = beta0_plans(pt, srv.part.n_regions)
    space = srv.default_plan_space([BETA], reuse_edges=(0, 4),
                                   captures=(BETA,))
    space += [(int(p.n_low), 0, 0, 0) for p in b0_plans]   # beta-0 keys
    n_keys = srv.warmup(space, (1, 2))
    grid_keys = sorted(srv._keys)
    say(f"  warmup of {n_keys} grid keys {srv.stats.warmup_wall_s:.2f} s; "
        f"init + warmup {time.perf_counter() - t0:.2f} s; length buckets "
        f"{srv.length_edges}")
    nR = srv.part.n_regions
    full = [pt.RegionPlan(np.zeros(nR, np.int8)) for _ in range(B)]
    caches = [FeatureCache(nR) for _ in range(B)]
    frames = [torch.rand((B, *cfg.vit.img_size, 3), generator=gen,
                         device=dev) for _ in range(2)]

    def wave(i, wplans, **kw):
        t = time.perf_counter()
        pend = srv.infer_wave(frames[i], wplans, BETA, caches=caches,
                              frame_ids=[i] * B, defer=True, **kw)
        check(bool(torch.isfinite(pend.boxes).all()
                   and torch.isfinite(pend.scores).all()),
              f"wave {i}: non-finite detections")
        dets = pend.wait()
        return time.perf_counter() - t, dets

    dispatch.reset_launch_counts()          # the main path starts here
    t_full, d_full = wave(0, full, capture_beta=BETA)
    t_mixed, d_mixed = wave(1, plans)
    launches = dispatch.launch_counts()     # ... and ends here
    say(f"  launches {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in FP32_PATH),
          f"a kernel of the serving path never launched: {launches}")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    for c, p in zip(caches, plans):
        check(c.tiles is not None and bool(torch.isfinite(c.tiles).all()),
              "cached tiles missing or non-finite")
        check(bool((c.age[p.states == pt.REUSE] == 1).all()),
              "REUSE regions did not age")
    check(len(d_full) == B and len(d_mixed) == B, "wrong detection count")
    reps_full = [wave(0, full, capture_beta=BETA)[0] for _ in range(3)]
    reps_mixed = [wave(1, plans)[0] for _ in range(3)]
    lat = {"full_res_first_s": t_full, "mixed_first_s": t_mixed,
           "full_res_median_s": statistics.median(reps_full),
           "mixed_median_s": statistics.median(reps_mixed), "B": B,
           "beta": BETA, "grid_keys": grid_keys}
    say(f"  waves (B={B}, host clock incl. decode): full-res first "
        f"{t_full:.4f} s median {lat['full_res_median_s']:.4f} s; mixed "
        f"beta {BETA} first {t_mixed:.4f} s median "
        f"{lat['mixed_median_s']:.4f} s")
    check(srv.stats.steady_compiles == 0, "steady-state first uses")
    lat["profile"] = {
        "full_res": profile_wave(torch, "full_res",
                                 lambda: wave(0, full, capture_beta=BETA),
                                 lat["full_res_median_s"]),
        "mixed": profile_wave(torch, "mixed", lambda: wave(1, plans),
                              lat["mixed_median_s"])}

    # the beta-0 path: restore at input, no REUSE, no capture
    def wave0():
        t = time.perf_counter()
        pend = srv.infer_wave(frames[1], b0_plans, 0, defer=True)
        check(bool(torch.isfinite(pend.scores).all()),
              "beta-0 wave: non-finite detections")
        check(len(pend.wait()) == B, "beta-0 wave: wrong detection count")
        return time.perf_counter() - t

    dispatch.reset_launch_counts()          # the beta-0 path starts here
    t0w = wave0()
    b0_launches = dispatch.launch_counts()  # ... and ends here
    say(f"  beta-0 launches {json.dumps(b0_launches)}")
    check(all(b0_launches[k] > 0 for k in BETA0_PATH),
          f"a kernel of the beta-0 path never launched: {b0_launches}")
    check(srv.stats.steady_compiles == 0, "beta-0: steady-state first use")
    lat["beta0_first_s"] = t0w
    lat["beta0_median_s"] = statistics.median(wave0() for _ in range(3))
    say(f"  beta-0 wave (B={B}): first {t0w:.4f} s median "
        f"{lat['beta0_median_s']:.4f} s")
    lat["profile"]["beta0"] = profile_wave(torch, "beta0", wave0,
                                           lat["beta0_median_s"])
    del srv, params
    torch.cuda.empty_cache()
    return launches, b0_launches, lat


def beta0_plans(pt, nR):
    """Two clients' FULL/LOW plans for a restore-at-input wave (no REUSE
    at beta 0): 4 and 8 LOW regions."""
    a = np.zeros(nR, np.int8)
    a[[1, 6, 9, 14]] = pt.LOW
    b = np.zeros(nR, np.int8)
    b[[0, 2, 5, 7, 8, 10, 13, 15]] = pt.LOW
    return [pt.RegionPlan(a), pt.RegionPlan(b)]


def serve_quant(torch, cfg, dev, gen, plans, pt, qt):
    from repro_torch import convert
    from repro_torch.kernels import dispatch
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.quant.ptq import QuantSpec
    from repro_torch.serve.request import FeatureCache

    say(f"phase 5: quantized ServerModel {QUANT_SPEC}, {cfg.name} "
        f"{cfg.n_layers} blocks D={cfg.d_model}")
    t0 = time.perf_counter()
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    srv = ServerModel(cfg, params, b_buckets=(1, 2), device=dev,
                      quant=QuantSpec(*QUANT_SPEC))
    del params
    torch.cuda.synchronize()
    rep = srv.quant_report
    say(f"  compressed in {time.perf_counter() - t0:.2f} s: "
        f"{rep['bytes_fp32']} -> {rep['bytes']} bytes, ratio "
        f"{rep['ratio']:.4f}, heads {cfg.n_heads} -> {srv.cfg.n_heads}")
    check(srv.cfg.n_heads == cfg.n_heads - QUANT_SPEC[2], "heads not pruned")
    space = srv.default_plan_space([BETA], reuse_edges=(0, 4),
                                   captures=(BETA,))
    n_keys = srv.warmup(space, (1, 2))
    say(f"  warmup of {n_keys} grid keys {srv.stats.warmup_wall_s:.2f} s")
    nR = srv.part.n_regions
    full = [pt.RegionPlan(np.zeros(nR, np.int8)) for _ in range(B)]
    caches = [FeatureCache(nR) for _ in range(B)]
    frames = [torch.rand((B, *cfg.vit.img_size, 3), generator=gen,
                         device=dev) for _ in range(2)]

    def wave(i, wplans, **kw):
        t = time.perf_counter()
        pend = srv.infer_wave(frames[i], wplans, BETA, caches=caches,
                              frame_ids=[i] * B, defer=True, **kw)
        check(bool(torch.isfinite(pend.boxes).all()
                   and torch.isfinite(pend.scores).all()),
              f"quantized wave {i}: non-finite detections")
        dets = pend.wait()
        check(len(dets) == B, "quantized wave: wrong detection count")
        return time.perf_counter() - t

    dispatch.reset_launch_counts()          # the quantized path starts
    t_full = wave(0, full, capture_beta=BETA)
    t_mixed = wave(1, plans)
    launches = dispatch.launch_counts()     # ... and ends here
    say(f"  launches {json.dumps(launches)}")
    check(launches["int8_matmul"] > 0, "the int8 GEMM never launched")
    check(all(launches[k] > 0 for k in FP32_PATH),
          f"a kernel of the quantized path never launched: {launches}")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    for c in caches:
        check(c.tiles is not None and bool(torch.isfinite(c.tiles).all()),
              "quantized: cached tiles missing or non-finite")
    lat = {"full_res_first_s": t_full, "mixed_first_s": t_mixed,
           "full_res_median_s": statistics.median(
               wave(0, full, capture_beta=BETA) for _ in range(3)),
           "mixed_median_s": statistics.median(
               wave(1, plans) for _ in range(3)),
           "ratio": rep["ratio"], "bytes": rep["bytes"],
           "bytes_fp32": rep["bytes_fp32"], "heads": srv.cfg.n_heads}
    say(f"  quantized waves (B={B}): full-res first {t_full:.4f} s median "
        f"{lat['full_res_median_s']:.4f} s; mixed beta {BETA} first "
        f"{t_mixed:.4f} s median {lat['mixed_median_s']:.4f} s; "
        f"steady_compiles {srv.stats.steady_compiles}")
    check(srv.stats.steady_compiles == 0, "steady-state first uses")

    # trace one wave with the row quantization marked as its own family
    rows_fn = qt._quantize_rows

    def marked(x2):
        with torch.profiler.record_function("row_quant"):
            return rows_fn(x2)

    qt._quantize_rows = marked
    try:
        lat["profile"] = {
            "full_res": profile_wave(
                torch, "quant_full_res",
                lambda: wave(0, full, capture_beta=BETA),
                lat["full_res_median_s"], marks=("row_quant",)),
            "mixed": profile_wave(torch, "quant_mixed",
                                  lambda: wave(1, plans),
                                  lat["mixed_median_s"],
                                  marks=("row_quant",))}
    finally:
        qt._quantize_rows = rows_fn
    del srv
    torch.cuda.empty_cache()
    return launches, lat


# kernel-name fragments -> family, first match wins.  cuDNN's
# convolutions run as implicit GEMMs, FFTs and complex GEMMs, so their
# fragments come before the plain "gemm" of the cuBLAS/CUTLASS matmuls.
FAMILIES = (("window_attention", "window_attention"),
            ("flash_attention", "flash_attention"),
            ("decode_attention_kernel", "decode_attention"),
            ("ssd_scores_kernel", "ssd_scan"),
            ("ssd_states_kernel", "ssd_scan"),
            ("ssd_pass_kernel", "ssd_scan"),
            ("ssd_outputs_kernel", "ssd_scan"),
            ("pack_pos", "fused_serving"), ("restore_gather", "fused_serving"),
            ("avg_pool_kernel", "avg_pool"),
            ("nn_upsample_kernel", "nn_upsample"),
            ("int8_matmul_kernel", "int8_gemm"),
            ("fprop", "conv"), ("fft", "conv"), ("cf32", "conv"),
            ("region_transform", "conv"), ("cudnn", "conv"),
            ("gemm", "gemm"), ("gemv", "gemm"), ("splitK", "gemm"),
            ("softmax", "softmax"), ("reduce_kernel", "reduce"),
            ("elementwise", "elementwise"),
            ("Memcpy", "memcpy"), ("Memset", "memset"))


def profile_wave(torch, name, run_wave, wall_s, marks=()):
    """Trace one wave; device time by kernel family, and the share of the
    untraced wave's wall time (``wall_s``) the device was busy.  A kernel
    that runs inside a ``record_function`` range named in ``marks`` counts
    in a family of that name instead of its own, so the families still
    partition the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_wave()
    (OUT_DIR / f"profile_{name}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # the device-side spans of the marked ranges (one stream: a kernel
    # launched inside a range runs inside its span)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in dev if e.name in marks)
    starts = [s for s, _, _ in spans]
    fam: dict = {}
    for e in dev:
        if e.name in marks or getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if ms <= 0:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            key = spans[i][2]
        else:
            key = next((f for frag, f in FAMILIES if frag in e.name), "other")
        fam[key] = fam.get(key, 0.0) + ms
    busy = sum(fam.values())
    check(busy > 0, f"profile {name}: no device time traced")
    check(not marks or spans, f"profile {name}: no device span of {marks}")
    out = {"device_ms": busy, "busy_share": busy / (wall_s * 1e3),
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1]))}
    say(f"  profile {name}: device {busy:.2f} ms of {wall_s * 1e3:.2f} ms "
        f"wall (busy {out['busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
    return out


def cross_check(torch, cfg, dev, plans, pt, vb):
    """One mixed wave of an 8-block full-width model on the card and on
    the CPU (plain versions), at beta 2 and at beta 0: features (and the
    beta-2 tiles) to E2E_RTOL."""
    from repro_torch import convert
    say(f"phase 4: {cfg.n_layers}-block full-width wave, card vs CPU")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    p_gpu = convert.init_vitdet_params(cfg, gen, device=dev)
    compare_on_cpu(torch, cfg, dev, gen, p_gpu, plans, pt, vb, E2E_RTOL)
    compare_on_cpu(torch, cfg, dev, gen, p_gpu,
                   beta0_plans(pt, vb.vit_partition(cfg).n_regions), pt,
                   vb, E2E_RTOL, beta=0)


def quant_cross_check(torch, cfg, dev, plans, pt, vb):
    """One mixed beta-2 wave of an 8-block full-width quantized model on
    the card and on the CPU (plain versions): features and tiles to
    QUANT_E2E_RTOL, the measured error printed beside the limit."""
    from repro_torch import convert
    from repro_torch.quant.ptq import QuantSpec, compress
    say(f"phase 6: {cfg.n_layers}-block full-width quantized wave "
        f"{QUANT_SPEC}, card vs CPU")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    p_gpu = convert.init_vitdet_params(cfg, gen, device=dev)
    qcfg, p_gpu, _ = compress(cfg, p_gpu, QuantSpec(*QUANT_SPEC))
    compare_on_cpu(torch, qcfg, dev, gen, p_gpu, plans, pt, vb,
                   QUANT_E2E_RTOL)


def compare_on_cpu(torch, cfg, dev, gen, p_gpu, plans, pt, vb, rtol,
                   beta=BETA):
    """Sample 0's plan of ``plans`` through forward_features on the card
    and on the CPU; every output within ``rtol`` of its largest value."""
    from repro_torch.offload.simulator import to_device
    torch.set_num_threads(os.cpu_count() or 1)
    part = vb.vit_partition(cfg)
    img = torch.rand((1, *cfg.vit.img_size, 3), generator=gen, device=dev)
    tiles = torch.randn((1, part.n_regions, part.windows_per_full_region,
                         part.tokens_low_region, cfg.d_model), generator=gen,
                        device=dev).to(p_gpu["patch_embed"]["b"].dtype)
    lb = max(pt.length_bucket_set(part))
    lay = pt.plan_layout(plans[0].states, lb, part)
    layout = {k: torch.as_tensor(getattr(lay, k)[None], device=dev)
              for k in ("win_src", "win_dst", "low_src", "low_ids",
                        "out_src", "out_map")}
    layout["nw"] = torch.tensor([lay.nw], dtype=torch.int32, device=dev)

    def run_on(device, params):
        out = vb.forward_features(
            cfg, params, img.to(device), beta=beta,
            layout={k: v.to(device) for k, v in layout.items()},
            reuse_tiles=tiles.to(device) if beta else None,
            capture_beta=beta)
        return out if beta else (out,)

    got = run_on(dev, p_gpu)
    t0 = time.perf_counter()
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    want = run_on("cpu", p_cpu)
    errs = {}
    for what, g, c in zip(("features", "tiles"), got, want):
        g, c = g.cpu().float(), c.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite on card")
        errs[what] = rel = float((g - c).abs().max() / c.abs().max())
        say(f"  beta {beta} {what} {tuple(g.shape)}: max relative error "
            f"{rel:.3g} (limit {rtol})")
        check(rel <= rtol, f"{what}: card vs CPU {rel} > {rtol}")
    say(f"  CPU forward {time.perf_counter() - t0:.1f} s")
    return errs


# ---------------------------------------------------------------------------
# the single-client offloading system (Simulation on the ViTDet-L server)


def serve_offload(torch, cfg, dev, count):
    """Phase 13: a full-width server of the launcher's make, profile, fit
    the estimators and run the four simulations; then the card-vs-CPU
    simulation checks."""
    from repro_torch.data.network_traces import make_trace
    from repro_torch.kernels import dispatch
    from repro_torch.launch import offload as lo
    from repro_torch.offload.simulator import SIZE_SCALE

    t_phase = time.perf_counter()
    say(f"phase 13: offloading Simulation on {cfg.name} {cfg.n_layers} "
        f"blocks D={cfg.d_model}, {cfg.vit.img_size[0]}px frames")
    t0 = time.perf_counter()
    srv = lo.make_server(cfg, dev)
    part, patch = srv.part, cfg.vit.patch_size
    say(f"  init + warmup of the policies' {srv.stats.compiles} grid keys "
        f"(B=1, top-k 32, score threshold 0) {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    clips = {v: lo.video_with_gt(srv, v, OFFLOAD_FRAMES)
             for v in sorted({v for _, v in OFFLOAD_RUNS})}
    t_gt = time.perf_counter() - t0
    anchor = lo.median_infer_s(srv, clips["cycleS"][0][0])
    inf_delay = lo.delay_model(cfg, anchor)
    say(f"  clips + ground truth {t_gt:.1f} s; full-res B=1 infer median "
        f"{anchor * 1e3:.2f} ms (the delay model's anchor)")
    t0 = time.perf_counter()
    data = lo.build_profile_dataset(srv, part, patch, PROFILE_FRAMES)
    t_prof = time.perf_counter() - t0
    t0 = time.perf_counter()
    size_e, acc_e, metrics = lo.fit_estimators(data, dev)
    t_fit = time.perf_counter() - t0
    check(size_e.device.type == "cuda", "estimators not on the card")
    say(f"  profile: {len(data['X'])} samples in {t_prof:.1f} s; MLP fit "
        f"on the card {t_fit:.1f} s; held-out R2 size "
        f"{metrics['size']['R2']:.4f} acc {metrics['acc']['R2']:.4f}")
    trace = make_trace("4g", 0, duration_s=OFFLOAD_FRAMES // lo.FPS + 60)
    out = {"anchor_ms": anchor * 1e3,
           "profile_samples": len(data["X"]), "profile_s": t_prof,
           "fit_s": t_fit, "estimator_metrics": metrics, "runs": {}}
    for policy, video in OFFLOAD_RUNS:
        frames, gt = clips[video]
        pol = lo.make_policy(policy, size_e, acc_e, part, inf_delay)
        t0 = time.perf_counter()
        dispatch.reset_launch_counts()      # this simulation starts here
        sim, res = lo.run_policy(srv, frames, gt, trace, pol, part, patch,
                                 inf_delay, video)
        launches = dispatch.launch_counts()  # ... and ends here
        wall = time.perf_counter() - t0
        name = f"offload {policy} {video}"
        count(name, launches)
        jobs = sim.jobs
        check(len(jobs) > 0, f"{name}: no offload")
        check_offload_kernels(name, jobs, launches)
        sw = np.array([j["server_wall"] for j in jobs]) * 1e3
        s = res.summary()
        n = len(frames)
        rec = {
            "offloads": len(jobs), "wall_s": wall,
            "server_ms_median": float(np.median(sw)),
            "server_ms_p95": float(np.percentile(sw, 95)),
            # the server calls' share of the run's wall: at most the
            # card's busy share (the calls hold host decode too)
            "server_share": float(sw.sum()) / 1e3 / wall,
            "e2e_ms_median": s["median_e2e_latency"] * 1e3,
            "net_ms_median": s["median_net_delay"] * 1e3,
            "inf_ms_median": s["median_inf_delay"] * 1e3,
            "rendering_f1_median": s["median_rendering_f1"],
            "rendering_f1_mean": s["mean_rendering_f1"],
            "inference_f1_mean": s["mean_inference_f1"],
            "payload_kb_median": float(np.median(res.sizes)) / 1e3,
            "reuse_offloads": sum(1 for j in jobs if j["n_r"] > 0),
            "betas": sorted({j["beta"] for j in jobs}),
            "host_ms_per_frame": {
                k: sum(res.overhead.get(f"{k}_wall", [])) / n * 1e3
                for k in ("motion", "codec", "tracker")},
            "launches": {k: v for k, v in launches.items() if v}}
        out["runs"][name] = rec
        say(f"  {policy} on {video}: {rec['offloads']} offloads (betas "
            f"{rec['betas']}, {rec['reuse_offloads']} with REUSE), server "
            f"{rec['server_ms_median']:.2f} ms median / "
            f"{rec['server_ms_p95']:.2f} p95 a offload, "
            f"{rec['server_share']:.3f} of the run's wall; modelled e2e "
            f"{rec['e2e_ms_median']:.1f} net {rec['net_ms_median']:.1f} "
            f"inf {rec['inf_ms_median']:.1f} ms (medians); rendering F1 "
            f"{rec['rendering_f1_median']:.3f} median "
            f"{rec['rendering_f1_mean']:.3f} mean, inference F1 "
            f"{rec['inference_f1_mean']:.3f}; payload "
            f"{rec['payload_kb_median']:.1f} kB median (x{SIZE_SCALE:.2f} "
            "of the codec's bytes); host ms/frame " + ", ".join(
                f"{k} {v:.2f}" for k, v in rec["host_ms_per_frame"].items())
            + f"; {wall:.1f} s")
        say(f"    launches {json.dumps(rec['launches'])}")
        if not any(j["beta"] == 0 and j["n_d"] for j in jobs):
            say("    nn_upsample: not reached (no LOW region at beta 0)")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    park = out["runs"]["offload ViTMAlis+Reuse parkS"]
    check(park["reuse_offloads"] > 0, "REUSE never fired on parkS")
    out["host_cache"] = host_cache_runs(torch, srv, lo, clips, trace, size_e,
                                        acc_e, inf_delay, count)
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    steady = srv.stats.steady_compiles
    del srv
    torch.cuda.empty_cache()
    out["host_cache_fp16"] = half_host_cache(
        torch, cfg, dev, lo, clips, trace, size_e, acc_e, inf_delay, count,
        out["host_cache"])
    out["card_vs_cpu"] = offload_cross_check(
        torch, cfg.replace(n_layers=8), dev, clips, inf_delay, size_e, acc_e)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 13: {out['phase_s']:.1f} s; steady first uses {steady}")
    return out


def half_host_cache(torch, cfg, dev, lo, clips, trace, size_e, acc_e,
                    inf_delay, count, f32):
    """Phase 21's cache check, on phase 13's clips, trace and estimators:
    phase 18 again on an fp16 server (the launcher's make: seed 0, B = 1,
    top-k 32, score 0, warmed over the policies' plan space, its tree
    cast by ``QuantSpec("fp16")``): equal detections in both modes, and
    every tile copied in half the bytes of phase 18's float32 tiles (the
    same bytes halved where the two runs make the same offloads)."""
    from repro_torch import convert
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.quant.ptq import QuantSpec

    t0 = time.perf_counter()
    params = convert.init_vitdet_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    srv = ServerModel(cfg, params, top_k=32, score_thresh=0.0,
                      b_buckets=(1,), device=dev,
                      quant=QuantSpec("fp16", "fp32", 0))
    del params
    srv.warmup(lo.reachable_plan_space(srv.part), (1,))
    check(srv.act_dtype == torch.float16, f"fp16 server at {srv.act_dtype}")
    say(f"phase 21 (on phase 13's clips): fp16 server init + warmup "
        f"{time.perf_counter() - t0:.2f} s")
    out = host_cache_runs(torch, srv, lo, clips, trace, size_e, acc_e,
                          inf_delay, count, tag="fp16 ",
                          phase="21, fp16 (on phase 13's clips)")
    check(srv.stats.steady_compiles == 0,
          f"fp16 server: steady-state first uses "
          f"{srv.stats.steady_compile_keys}")
    part = srv.part
    unit = part.windows_per_full_region * part.tokens_low_region \
        * cfg.d_model                       # elements of one region's tile
    h, h32 = out["host"], f32["host"]
    tiles = {k: (h[k] / (2 * unit), h32[k] / (4 * unit))
             for k in ("tile_bytes_d2h", "tile_bytes_h2d")}
    check(all(a == int(a) and b == int(b) for a, b in tiles.values()),
          f"tile bytes not whole half / float32 tiles: {tiles}")
    same = out["decisions"] == f32["decisions"]
    if same:
        check(2 * h["tile_bytes_d2h"] == h32["tile_bytes_d2h"]
              and 2 * h["tile_bytes_h2d"] == h32["tile_bytes_h2d"],
              f"fp16 tile bytes {h} not half of float32's {h32}")
    out["tiles_moved"] = {k: v[0] for k, v in tiles.items()}
    out["same_offloads_as_fp32"] = same
    say(f"  fp16 tile bytes: {2 * unit} a region tile against float32's "
        f"{4 * unit}; tiles moved d2h / h2d {tiles['tile_bytes_d2h'][0]:.0f}"
        f" / {tiles['tile_bytes_h2d'][0]:.0f} (float32 run "
        f"{tiles['tile_bytes_d2h'][1]:.0f} / "
        f"{tiles['tile_bytes_h2d'][1]:.0f}); "
        f"{'the same' if same else 'other'} offloads than phase 18"
        + (f": bytes exactly half" if same else ""))
    del srv
    torch.cuda.empty_cache()
    return out


def check_offload_kernels(name, jobs, launches):
    """Every kernel the offloads' plans run launched in the run: the
    attention kernels always, the packed lane's three at beta >= 1 with
    LOW or REUSE regions, the restore-at-input pair at beta 0 with LOW
    regions."""
    mixed = [j for j in jobs if j["n_d"] or j["n_r"]]
    want = {"window_attention", "flash_attention"}
    if any(j["beta"] >= 1 for j in mixed):
        want |= set(FP32_PATH)
    if any(j["beta"] == 0 for j in mixed):
        want |= set(BETA0_PATH)
    check(all(launches[k] > 0 for k in want),
          f"{name}: a kernel of its offloads never launched: {launches}")


def offload_cross_check(torch, cfg, dev, clips, inf_delay, size_e, acc_e):
    """Each of CROSS_RUNS through an 8-block full-width server on the card
    and on the CPU (plain versions), on the same parameters, frames,
    ground truth (the card's), trace and estimators: the same offloads,
    decisions (mask, beta, plan states, capture point), payloads and
    Eq. (2) terms; detections equal as sets to DET_RTOL.  ViTMAlis+Reuse
    on parkS decides from the detections (the tracker's rho) and sends
    LOW and REUSE offloads at B=1, so the kernels of the simulations'
    mixed offloads are held against their plain versions here."""
    from repro_torch import convert
    from repro_torch.data.network_traces import make_trace
    from repro_torch.kernels import dispatch
    from repro_torch.launch import offload as lo
    from repro_torch.offload.simulator import ServerModel, to_device

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    kw = dict(top_k=32, score_thresh=0.0, b_buckets=(1,))
    gpu = ServerModel(cfg, params, device=dev, **kw)
    cpu = ServerModel(cfg, to_device(params, torch.device("cpu")),
                      device="cpu", **kw)
    part, patch = gpu.part, cfg.vit.patch_size
    trace = make_trace("4g", 0, duration_s=60)
    out = {}
    for policy, video, n in CROSS_RUNS:
        frames = clips[video][0][:n]
        say(f"  card vs CPU: {policy} on {video}, {cfg.n_layers}-block "
            f"full-width model, {len(frames)} frames")
        gt = [gpu.infer(f) for f in frames]
        t0 = time.perf_counter()
        dispatch.reset_launch_counts()
        sg = lo.run_policy(gpu, frames, gt, trace, lo.make_policy(
            policy, size_e, acc_e, part, inf_delay), part, patch,
            inf_delay, video)[0]
        launches = dispatch.launch_counts()
        sc = lo.run_policy(cpu, frames, gt, trace, lo.make_policy(
            policy, size_e, acc_e, part, inf_delay), part, patch,
            inf_delay, video)[0]
        t_run = time.perf_counter() - t0
        jg, jc = sg.jobs, sc.jobs
        check(len(jg) == len(jc) > 0, f"offloads {len(jg)} vs {len(jc)}")
        check_offload_kernels(f"card vs CPU {policy}", jg, launches)
        worst = 0.0
        for a, b in zip(jg, jc):
            for k in ("frame", "n_d", "beta", "n_r", "capture_beta", "size",
                      "t_enc", "t_up", "t_dec", "t_inf", "rtt", "e2e",
                      "parts"):
                check(a[k] == b[k], f"{policy} offload at frame "
                      f"{a['frame']}: {k} {a[k]} vs {b[k]}")
            check(np.array_equal(a["mask"], b["mask"])
                  and np.array_equal(a["plan"].states, b["plan"].states),
                  f"{policy} offload at frame {a['frame']}: plans differ")
            worst = max(worst, match_dets(a["dets"], b["dets"]))
        n_reuse = sum(1 for j in jg if j["n_r"] > 0)
        if "Reuse" in policy:
            check(n_reuse > 0, f"card vs CPU {policy}: REUSE never fired")
        shown = [(j["frame"], j["n_d"], j["n_r"], j["beta"]) for j in jg]
        say(f"    {len(jg)} offloads (frame, n_low, n_reuse, beta) {shown}: "
            f"decisions, payloads and delay terms equal; detections within "
            f"{worst:.3g} relative (limit {DET_RTOL}); card launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; both "
            f"runs {t_run:.1f} s")
        out[f"{policy} {video}"] = {
            "offloads": len(jg), "reuse_offloads": n_reuse,
            "det_rel_err": worst, "s": t_run}
    del gpu, cpu, params
    torch.cuda.empty_cache()
    return out


def match_dets(got, want) -> float:
    """Greedy set match of two top-k detection lists: box coordinates
    within DET_RTOL of max(|coordinate|, 1 px), scores within DET_RTOL
    relative.  Unmatched detections must lie at the top-k cut (a near-tie
    there may swap).  Returns the largest matched difference."""
    check(len(got) == len(want), f"{len(got)} vs {len(want)} detections")
    left, worst, extra = list(want), 0.0, []
    for g in got:
        hit = None
        for w in left:
            a = np.array([*g["box"], g["score"]])
            b = np.array([*w["box"], w["score"]])
            scale = np.maximum(np.abs(b), [1.0] * 4 + [1e-12])
            err = float((np.abs(a - b) / scale).max())
            if w["cls"] == g["cls"] and err <= DET_RTOL:
                hit = (w, err)
                break
        if hit is None:
            extra.append(g)
        else:
            left.remove(hit[0])
            worst = max(worst, hit[1])
    cut = min(d["score"] for d in want)
    for d in extra + left:
        check(abs(d["score"] - cut) <= DET_RTOL * cut,
              f"unmatched detection {d} away from the top-k cut {cut}")
    return worst


# ---------------------------------------------------------------------------
# the multi-client edge (MultiClientSimulation on a BatchedServerModel)


def mc_policies(sim, opt):
    """bench_multiclient's two policies (``benchmarks/bench_multiclient.py``,
    which this round does not port), over the port's ``Policy``."""
    class RotatingMaskPolicy(sim.Policy):
        """Deterministic per-client layout: ``n_low`` LOW regions from
        ``offset``, distinct across clients, one length bucket."""
        name = "rotating"
        use_tracker = True

        def __init__(self, offset, n_low, n_regions, beta=2):
            self.offset, self.n_low = offset, n_low
            self.n_regions, self.beta = n_regions, beta

        def decide(self, s, frame_idx):
            mask = np.zeros(self.n_regions, np.int32)
            for k in range(self.n_low):
                mask[(self.offset + k) % self.n_regions] = 1
            return {"mask": mask, "quality": 85, "beta": self.beta}

    class ReuseRotatingPolicy(RotatingMaskPolicy):
        """Rotating LOW mask + the motion-gated REUSE lift (K = 4): the
        reuse-heavy workload the speculative lane targets."""
        name = "reuse-rotating"
        reuse_k = 4

        def decide(self, s, frame_idx):
            d = super().decide(s, frame_idx)
            cache = s.feature_cache
            elig = (cache.eligible(self.beta) if cache is not None
                    else np.zeros(self.n_regions, bool))
            d["plan"] = opt.build_reuse_plan(s.part, d["mask"], s.m, elig)
            d["capture_beta"] = self.beta
            return d

    return RotatingMaskPolicy, ReuseRotatingPolicy


def mc_plan_space(part, beta):
    """Every (n_low, n_reuse, beta, capture) the two policies can send
    (and the speculative lane's patch plans: fewer transmitted regions),
    plus the full-resolution ground truth."""
    nR = part.n_regions
    return [(0, 0, 0, 0)] + [
        (n_low, n_reuse, beta, beta) for n_low in range(nR + 1)
        for n_reuse in range(nR - n_low + 1)
        if (n_low or n_reuse) and n_reuse < nR]


class CallClock:
    """Host clock around a server's calls: every ``infer_wave`` (real rows,
    wall, seconds spent inside ``PendingWave.wait`` during it, deferred
    or not), the seconds in ``stage_frames`` and in every
    ``PendingWave.wait``.  Dispatch seconds are a call's wall less the
    wait inside it."""

    def __init__(self, srv, sim):
        self.srv, self.sim = srv, sim
        self._wait = sim.PendingWave.wait
        self.reset()
        infer, stage, wait = srv.infer_wave, srv.stage_frames, self._wait

        def timed_wait(pw):
            t0 = time.perf_counter()
            out = wait(pw)
            self.wait_s += time.perf_counter() - t0
            return out

        def timed_infer(frames, plans, *a, **kw):
            w0, t0 = self.wait_s, time.perf_counter()
            out = infer(frames, plans, *a, **kw)
            self.calls.append((len(plans), time.perf_counter() - t0,
                               self.wait_s - w0, bool(kw.get("defer"))))
            return out

        def timed_stage(frames):
            t0 = time.perf_counter()
            out = stage(frames)
            self.stage_s += time.perf_counter() - t0
            return out

        srv.infer_wave, srv.stage_frames = timed_infer, timed_stage
        sim.PendingWave.wait = timed_wait

    def reset(self):
        self.calls, self.wait_s, self.stage_s = [], 0.0, 0.0

    def close(self):
        del self.srv.infer_wave, self.srv.stage_frames
        self.sim.PendingWave.wait = self._wait

    def summary(self):
        """Dispatch / wait / stage seconds and, per real B, the median
        wall of the synchronous calls (detections decoded inside) and of
        the deferred calls' dispatch."""
        sync, deferred = {}, {}
        for b, wall, waited, defer in self.calls:
            (deferred if defer else sync).setdefault(b, []).append(
                wall - waited if defer else wall)
        med = lambda d: {b: statistics.median(v) * 1e3
                         for b, v in sorted(d.items())}
        return {"calls": len(self.calls),
                "dispatch_s": sum(w - x for _, w, x, _ in self.calls),
                "wait_s": self.wait_s, "stage_s": self.stage_s,
                "sync_wall_ms_by_B": med(sync),
                "deferred_dispatch_ms_by_B": med(deferred)}


def alpha(walls):
    """Measured batch_alpha: (wall(B) / wall(1) - 1) / (B - 1) per B."""
    return {b: (w / walls[1] - 1.0) / (b - 1)
            for b, w in walls.items() if b > 1 and 1 in walls}


def serve_multiclient(torch, cfg, dev, count):
    """Phase 14: four clients' offloads on one full-width ViTDet-L replica
    through ``MultiClientSimulation`` (run A: sequential, barrier,
    continuous with stage_ahead; run B on a slow uplink: barrier,
    continuous, continuous + speculate), burst waves of B = 4 and 3,
    the measured batch alpha, a direct ``infer_speculative``, and the
    card-vs-CPU check on an 8-block copy."""
    from repro_torch import convert
    from repro_torch.core import partition as pt
    from repro_torch.data import synthetic_video as sv
    from repro_torch.data.network_traces import make_trace
    from repro_torch.kernels import dispatch
    from repro_torch.launch import offload as lo
    from repro_torch.offload import optimizer as opt
    from repro_torch.offload import simulator as sim
    from repro_torch.offload.faults import (FaultInjector, FaultSpec,
                                            FaultyTrace)
    from repro_torch.serve.edge import (BatchedServerModel, EdgeConfig,
                                        MultiClientSimulation)
    from repro_torch.serve.request import FeatureCache
    from repro_torch.serve.scheduler import make_scheduler

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    say(f"phase 14: multi-client edge on {cfg.name} {cfg.n_layers} blocks "
        f"D={cfg.d_model}, {cfg.vit.img_size[0]}px frames, B buckets "
        f"{MC_B_BUCKETS}")
    t0 = time.perf_counter()
    params = convert.init_vitdet_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    srv = BatchedServerModel(cfg, params, top_k=32, score_thresh=0.0,
                             b_buckets=MC_B_BUCKETS, device=dev)
    part, patch = srv.part, cfg.vit.patch_size
    n_keys = srv.warmup(mc_plan_space(part, BETA), MC_B_BUCKETS)
    say(f"  init + warmup of {n_keys} grid keys (length buckets "
        f"{srv.length_edges}, beta {BETA}, B {MC_B_BUCKETS}) "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    need = dict.fromkeys(MC_VIDEOS, MC_FRAMES)
    for v in MC_SLOW_VIDEOS:
        need[v] = max(need.get(v, 0), MC_SLOW_FRAMES)
    clips = {}
    for v, n in need.items():
        frames, _ = sv.make_clip(v, n, size=cfg.vit.img_size[0],
                                 seed=MC_SEED)
        clips[v] = (frames, [srv.infer(f) for f in frames])
    anchor = lo.median_infer_s(srv, clips["walkS"][0][0])
    inf_delay = lo.delay_model(cfg, anchor)
    say(f"  clips + ground truth {time.perf_counter() - t0:.1f} s; "
        f"full-res B=1 infer median {anchor * 1e3:.2f} ms (the delay "
        f"model's anchor)")
    Rotating, ReuseRotating = mc_policies(sim, opt)
    nR, n_low = part.n_regions, part.n_regions // 4
    slow = FaultSpec(bufferbloat=tuple((0.0, 3600.0, 1.15)
                                       for _ in range(MC_SLOW_WINDOWS)))

    def clients_a(server, videos=MC_VIDEOS, n=MC_FRAMES, gt=None):
        out = []
        for i, v in enumerate(videos):
            frames, g = clips[v][0][:n], (gt or clips)[v][1][:n]
            out.append(sim.Simulation(
                frames, g, make_trace("4g", i, duration_s=120),
                Rotating(i * n_low, n_low, nR, BETA), server, part, patch,
                fps=lo.FPS, inf_delay=inf_delay))
        return out

    def clients_b(server, videos=MC_SLOW_VIDEOS, n=MC_SLOW_FRAMES,
                  gt=None):
        out = []
        for i, v in enumerate(videos):
            frames, g = clips[v][0][:n], (gt or clips)[v][1][:n]
            trace = FaultyTrace(make_trace("4g", i, duration_s=240),
                                FaultInjector(slow))
            out.append(sim.Simulation(
                frames, g, trace, ReuseRotating(i * n_low, n_low, nR, BETA),
                server, part, patch, fps=lo.FPS, inf_delay=inf_delay))
        return out

    def drive(server, clients, ec):
        """One MultiClientSimulation run: its jobs in arrival order at the
        edge, results, stats and launches (counts reset just before the
        run and read just after)."""
        mc = MultiClientSimulation(clients, server, EdgeConfig(
            max_batch=max(MC_B_BUCKETS), **ec))
        jobs = []
        enqueue = mc.scheduler.enqueue

        def tap(ci, job):
            jobs.append(job)
            enqueue(ci, job)
        mc.scheduler.enqueue = tap
        splices = server.stats.reuse_splices
        t = time.perf_counter()
        dispatch.reset_launch_counts()       # this run starts here
        results = mc.run()
        launches = dispatch.launch_counts()  # ... and ends here
        return SimpleNamespace(mc=mc, jobs=jobs, results=results,
                               wall=time.perf_counter() - t,
                               launches=launches,
                               splices=server.stats.reuse_splices - splices)

    def pct(x, q):
        return float(np.percentile(x, q)) * 1e3 if len(x) else 0.0

    clock = CallClock(srv, sim)
    out = {"anchor_ms": anchor * 1e3, "keys": n_keys, "runs": {}}
    runs = {}
    modes = (("A", "sequential", dict(batched=False), clients_a),
             ("A", "barrier", {}, clients_a),
             ("A", "continuous+stage_ahead",
              dict(scheduler="continuous", stage_ahead=True), clients_a),
             ("B", "barrier", {}, clients_b),
             ("B", "continuous", dict(scheduler="continuous"), clients_b),
             ("B", "continuous+speculate",
              dict(scheduler="continuous", speculate=True), clients_b))
    for run_name, mode, ec, make in modes:
        name = f"mc {run_name} {mode}"
        clock.reset()
        r = drive(srv, make(srv), ec)
        runs[name] = r
        count(name, r.launches)
        st = r.mc.stats
        e2e = [x for res in r.results for x in res.e2e_latency]
        cs = clock.summary()
        walls = cs["sync_wall_ms_by_B"]
        n_cf = sum(len(c.frames) for c in r.mc.clients)
        host = {k: sum(sum(res.overhead.get(f"{k}_wall", []))
                       for res in r.results) / n_cf * 1e3
                for k in ("motion", "codec", "tracker")}
        rec = {
            "offloads": len(r.jobs), "waves": len(st.wave_sizes),
            "wave_sizes": {b: st.wave_sizes.count(b)
                           for b in sorted(set(st.wave_sizes))},
            "mean_wave": st.mean_wave_size,
            "mixed_n_low_waves": st.mixed_plan_waves,
            "e2e_ms_p50": pct(e2e, 50), "e2e_ms_p95": pct(e2e, 95),
            "queue_ms_p50": pct(st.queue_delays, 50),
            "queue_ms_p95": pct(st.queue_delays, 95),
            "admit_ms_p50": pct(st.queue_admit, 50),
            "admit_ms_p95": pct(st.queue_admit, 95),
            "slot_ms_p50": pct(st.queue_slot, 50),
            "slot_ms_p95": pct(st.queue_slot, 95),
            "device_idle_frac": st.device_idle_frac,
            "decode_hidden_s": st.decode_hidden_s,
            "spec": {"launched": st.spec_launched,
                     "patched": st.spec_patched,
                     "discarded": st.spec_discarded,
                     "hidden_s": st.spec_hidden_s},
            "reuse_splices": r.splices,
            "reuse_offloads": sum(1 for j in r.jobs if j["n_r"] > 0),
            "wall_s": r.wall, "host_ms_per_client_frame": host,
            "server": cs, "alpha_from_run": alpha(walls),
            "launches": {k: v for k, v in r.launches.items() if v}}
        out["runs"][name] = rec
        say(f"  run {run_name} {mode}: {rec['offloads']} offloads in "
            f"{rec['waves']} waves (sizes {rec['wave_sizes']}, mean "
            f"{rec['mean_wave']:.2f}, {rec['mixed_n_low_waves']} with >1 "
            f"n_low), {rec['reuse_offloads']} with REUSE ({r.splices} "
            f"splices); modelled e2e p50/p95 {rec['e2e_ms_p50']:.1f}/"
            f"{rec['e2e_ms_p95']:.1f} ms, queue {rec['queue_ms_p50']:.1f}/"
            f"{rec['queue_ms_p95']:.1f} (admit {rec['admit_ms_p50']:.1f}/"
            f"{rec['admit_ms_p95']:.1f}, slot {rec['slot_ms_p50']:.1f}/"
            f"{rec['slot_ms_p95']:.1f}); device_idle_frac "
            f"{rec['device_idle_frac']:.3f}, decode_hidden_s "
            f"{rec['decode_hidden_s']:.4f}; spec launched/patched/"
            f"discarded {st.spec_launched}/{st.spec_patched}/"
            f"{st.spec_discarded}, hidden {st.spec_hidden_s:.3f} s; "
            f"wall {r.wall:.1f} s")
        say(f"    server calls {cs['calls']}: host s in dispatch "
            f"{cs['dispatch_s']:.3f}, in PendingWave.wait "
            f"{cs['wait_s']:.3f}, in stage_frames {cs['stage_s']:.3f}; "
            f"sync wall ms by B "
            f"{ {b: round(w, 2) for b, w in walls.items()} }, deferred "
            f"dispatch ms by B "
            f"{ {b: round(w, 2) for b, w in cs['deferred_dispatch_ms_by_B'].items()} }; "
            f"alpha from the run {rec['alpha_from_run']}; host ms a "
            f"client-frame " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in host.items()))
        say(f"    launches {json.dumps(rec['launches'])}")
        check(all(r.launches[k] > 0 for k in FP32_PATH),
              f"{name}: a kernel of the fused lane never launched: "
              f"{r.launches}")
    clock.close()

    # the same (client, frame) served in several run-A modes gets the same
    # detections whatever wave it rode in
    seen, worst, pairs = {}, 0.0, 0
    for name, r in runs.items():
        if not name.startswith("mc A"):
            continue
        for j in r.jobs:
            if j.get("dets") is None or j.get("lost"):
                continue
            key = (j["_client"], j["frame"])
            if key in seen:
                worst = max(worst, match_dets(j["dets"], seen[key]))
                pairs += 1
            else:
                seen[key] = j["dets"]
    say(f"  run A across modes: {pairs} (client, frame) pairs served in "
        f"two modes agree within {worst:.3g} relative (limit {DET_RTOL})")
    b_runs = [r for n, r in runs.items() if n.startswith("mc B")]
    check(sum(r.splices for r in b_runs) > 0, "run B: no REUSE splice")
    spec = runs["mc B continuous+speculate"].mc.stats
    check(spec.spec_launched >= 1, "run B continuous+speculate launched no "
          "speculation")

    # burst waves: the four clients' first payloads landing at once (a
    # closed loop of four clients, each with one offload in flight, never
    # queues all four behind a busy replica); B = 4 and B = 3 padded to 4,
    # barrier (synchronous) and continuous (stage_frames + deferred decode)
    seq = runs["mc A sequential"]
    first = {}
    for j in seq.jobs:
        first.setdefault(j["_client"], j)
    keep = ("frame", "_client", "decoded", "plan", "mask", "n_d", "beta",
            "n_r", "capture_beta", "submit", "t_enc", "t_up", "t_dec",
            "t_inf", "rtt", "tput", "size", "seq", "deadline")
    bursts, worst_b = {}, 0.0
    for members in (4, 3):
        for mode, ec in (("barrier", {}),
                         ("continuous+stage_ahead",
                          dict(scheduler="continuous", stage_ahead=True))):
            jobs = [{k: first[ci][k] for k in keep} for ci in range(members)]
            t_land = max(first[ci]["arrival"] for ci in range(members))
            sched = make_scheduler(srv, seq.mc.clients, EdgeConfig(
                max_batch=max(MC_B_BUCKETS), **ec))
            for j in jobs:
                j["arrival"] = t_land
                sched.enqueue(j["_client"], j)
            t = time.perf_counter()
            dispatch.reset_launch_counts()
            sched.drain(float("inf"))
            launches = dispatch.launch_counts()
            wall = time.perf_counter() - t
            name = f"mc A burst B={members} {mode}"
            count(name, launches)
            check(sched.stats.wave_sizes == [members],
                  f"{name}: waves {sched.stats.wave_sizes}")
            check(len({j["plan"].states.tobytes() for j in jobs}) == members,
                  f"{name}: layouts not distinct")
            check(all(launches[k] > 0 for k in FP32_PATH),
                  f"{name}: a kernel of the fused lane never launched: "
                  f"{launches}")
            for j in jobs:
                worst_b = max(worst_b, match_dets(j["dets"],
                                                  first[j["_client"]]["dets"]))
            bursts[name] = {"wall_ms": wall * 1e3,
                            "launches": {k: v for k, v in launches.items()
                                         if v}}
    say(f"  burst waves of the four rotating layouts (B=4) and of three "
        f"(B=3 padded to 4), barrier and continuous+stage_ahead: one wave "
        f"each, detections within {worst_b:.3g} relative of the B=1 "
        f"sequential ones (limit {DET_RTOL}); wall ms "
        f"{ {k[5:]: round(v['wall_ms'], 2) for k, v in bursts.items()} }")
    out["bursts"] = bursts

    # measured alpha: the same four decoded frames and masks at B = 1, 2, 4
    frames = np.stack([first[ci]["decoded"] for ci in range(4)])
    masks = [first[ci]["mask"] for ci in range(4)]
    walls = {}
    for b in MC_B_BUCKETS:
        srv.infer_batch(frames[:b], masks[:b], beta=BETA)
        ts = []
        for _ in range(ALPHA_REPS):
            t = time.perf_counter()
            srv.infer_batch(frames[:b], masks[:b], beta=BETA)
            ts.append(time.perf_counter() - t)
        walls[b] = statistics.median(ts) * 1e3
    measured = alpha(walls)
    out["alpha"] = {"wall_ms_by_B": walls, "measured": measured,
                    "modelled": EdgeConfig().batch_alpha}
    say(f"  infer_batch wall ms by B (median of {ALPHA_REPS}, 64-window "
        f"bucket, detections decoded): "
        f"{ {b: round(w, 2) for b, w in walls.items()} }; measured alpha "
        f"{ {b: round(a, 4) for b, a in measured.items()} } against "
        f"EdgeConfig.batch_alpha {EdgeConfig().batch_alpha}")

    # a direct speculative forward on a parkS canvas: equal to the same
    # plan served on a copy of the cache, the live tiles byte-identical
    pframes = clips["parkS"][0]
    live = FeatureCache(nR, max_age=4)
    warm_plan = pt.RegionPlan.from_mask(masks[0])
    srv.infer_plan(pframes[0], warm_plan, beta=BETA, cache=live, frame_idx=0)
    live.note_pred(pframes[0], 0, srv.epoch)
    states = np.zeros(nR, np.int8)
    states[:n_low] = pt.LOW
    states[2 * n_low:] = pt.REUSE
    plan = pt.RegionPlan(states)
    canvas = sim.predict_canvas(part, part.region * patch, pframes[1], plan)
    copy = FeatureCache(nR, max_age=4, beta=live.beta,
                        tiles=live.tiles.clone(), age=live.age.copy(),
                        frame=live.frame, warm=live.warm, epoch=live.epoch)
    before = live.tiles.clone()
    dets_s, clone = srv.infer_speculative(canvas, plan, BETA, live, 1)
    dets_r = srv.infer_plan(canvas, plan, beta=BETA, cache=copy,
                            frame_idx=1)
    check(torch.equal(live.tiles, before),
          "infer_speculative wrote the live session's tiles")
    err_t = float((clone.tiles - copy.tiles).abs().max()
                  / copy.tiles.abs().max().clamp_min(1e-30))
    check(err_t <= DET_RTOL, f"speculative capture differs from the plan "
          f"served on a copy by {err_t} of the largest tile value")
    err_s = match_dets(dets_s, dets_r)
    say(f"  infer_speculative on a parkS canvas ({plan.n_low} LOW, "
        f"{plan.n_reuse} REUSE): detections within {err_s:.3g} and tiles "
        f"within {err_t:.3g} of infer_plan on a copy of the cache (limit "
        f"{DET_RTOL}); live tiles byte-identical")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = srv.stats.steady_compiles
    say(f"  steady first uses {steady}; max_memory_allocated "
        f"{out['peak_mem_gb']:.2f} GB")
    del srv, params, runs, seq
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = mc_cross_check(
        torch, cfg.replace(n_layers=8), dev, clips, inf_delay,
        clients_a, clients_b, drive)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 14: {out['phase_s']:.1f} s; steady first uses {steady}")
    return out


MC_JOB_KEYS = ("frame", "_client", "n_d", "beta", "n_r", "capture_beta",
               "size", "t_enc", "t_up", "t_dec", "t_inf", "rtt", "arrival",
               "e2e", "done_at", "parts", "speculation", "stale_epoch",
               "lost", "rejected", "abandoned", "spec_frac", "spec_conf")


def mc_cross_check(torch, cfg, dev, clips, inf_delay, clients_a, clients_b,
                   drive):
    """Run A's barrier mode and run B's continuous + speculate mode, with
    MC_CROSS_CLIENTS clients of MC_CROSS_FRAMES frames, through an
    8-block full-width server on the card and on the CPU (plain versions),
    on the same parameters, frames and ground truth (the card's): equal
    EdgeStats, per-job decisions and Eq. (2) terms, detections within
    DET_RTOL.  The timeline is modelled, so no wall clock decides."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.offload.simulator import to_device
    from repro_torch.serve.edge import BatchedServerModel

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    kw = dict(top_k=32, score_thresh=0.0, b_buckets=MC_B_BUCKETS)
    gpu = BatchedServerModel(cfg, params, device=dev, **kw)
    cpu = BatchedServerModel(cfg, to_device(params, torch.device("cpu")),
                             device="cpu", **kw)
    out = {}
    for name, make, videos, ec in (
            ("A barrier", clients_a, MC_VIDEOS, {}),
            ("B continuous+speculate", clients_b, MC_SLOW_VIDEOS,
             dict(scheduler="continuous", speculate=True))):
        videos = videos[:MC_CROSS_CLIENTS]
        gt = {v: (None, [gpu.infer(f)
                         for f in clips[v][0][:MC_CROSS_FRAMES]])
              for v in set(videos)}
        say(f"  card vs CPU: run {name}, {cfg.n_layers}-block full-width "
            f"model, {len(videos)} clients x {MC_CROSS_FRAMES} frames")
        t0 = time.perf_counter()
        rg = drive(gpu, make(gpu, videos, MC_CROSS_FRAMES, gt), ec)
        rc = drive(cpu, make(cpu, videos, MC_CROSS_FRAMES, gt), ec)
        t_run = time.perf_counter() - t0
        check(len(rg.jobs) == len(rc.jobs) > 0,
              f"{name}: offloads {len(rg.jobs)} vs {len(rc.jobs)}")
        sg, sc = (dataclasses.asdict(r.mc.stats) for r in (rg, rc))
        check(sg == sc, f"{name}: EdgeStats differ: {sg} vs {sc}")
        worst = 0.0
        for a, b in zip(rg.jobs, rc.jobs):
            for k in MC_JOB_KEYS:
                check(a.get(k) == b.get(k), f"{name} client {a['_client']} "
                      f"frame {a['frame']}: {k} {a.get(k)} vs {b.get(k)}")
            check(np.array_equal(a["plan"].states, b["plan"].states),
                  f"{name}: plans differ at frame {a['frame']}")
            if a.get("dets") is not None:
                worst = max(worst, match_dets(a["dets"], b["dets"]))
        st = rg.mc.stats
        say(f"    {len(rg.jobs)} offloads, waves {st.wave_sizes}, spec "
            f"{st.spec_launched}/{st.spec_patched}/{st.spec_discarded}: "
            f"EdgeStats, decisions and delay terms equal; detections "
            f"within {worst:.3g} relative (limit {DET_RTOL}); card "
            f"launches {json.dumps({k: v for k, v in rg.launches.items() if v})}"
            f"; both runs {t_run:.1f} s")
        out[name] = {"offloads": len(rg.jobs), "waves": st.wave_sizes,
                     "det_rel_err": worst, "s": t_run}
    del gpu, cpu, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the LM serving lane (Qwen3-4B through ServeEngine)


# ---------------------------------------------------------------------------
# training (phase 15)


def rel_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def plain_route(dispatch, win, flash):
    """The window and flash routes of ``dispatch`` replaced by autograd
    through the plain versions: what a training step is held against on
    the card."""
    saved = dispatch.window_attention, dispatch.flash_attention
    dispatch.window_attention = (
        lambda q, k, v, window, win_valid=None:
        win.window_attention_plain(q, k, v, window, win_valid))
    dispatch.flash_attention = (
        lambda q, k, v, *, causal=False:
        flash.flash_attention_plain(q, k, v, causal))
    try:
        yield
    finally:
        dispatch.window_attention, dispatch.flash_attention = saved


@contextlib.contextmanager
def kink_branches(dh, replay=None):
    """``det_head``'s ``torch`` with ``relu`` (the head's ReLUs) and
    ``abs`` (the loss's L1) recording the branch each element takes (the
    mask, the sign), in call order, into the yielded list; with
    ``replay`` (branches recorded on another route) each takes the
    replayed branch instead: the same step through the same kink
    branches."""
    import torch
    rec = []

    def branch(x, taken, plain):
        rec.append(taken)
        if replay is None:
            return plain(x)
        return x * replay[len(rec) - 1].to(x.device, x.dtype)

    class Branches:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def relu(x):
            return branch(x, x > 0, torch.relu)

        @staticmethod
        def abs(x):
            return branch(x, torch.sign(x), torch.abs)

    real = dh.torch
    dh.torch = Branches()
    try:
        yield rec
    finally:
        dh.torch = real


def branch_flips(a, b, tgt):
    """Positions whose branch differs between two recordings of a step,
    per kink: each level's smooth and tower ReLU, then each level's L1 at
    its positives."""
    n = len(tgt)
    names = [f"s{8 << i} {w}" for i in range(n) for w in ("smooth", "tower")]
    names += [f"s{8 << i} L1" for i in range(n)]
    flips = {}
    for i, name in enumerate(names):
        d = a[i].cpu() != b[i].cpu()
        if i >= 2 * n:
            d &= tgt[i - 2 * n]["pos"].cpu() > 0
        flips[name] = int(d.sum())
    return flips


def flash_f64_errors(flash, o, q, k, v, causal):
    """The flash kernel's output ``o`` and the float32 plain version's,
    each against the plain version in float64 on the same q, k, v: (the
    kernel's error, the plain version's), of the float64 output's
    largest."""
    ref = flash.flash_attention_plain(q.double(), k.double(), v.double(),
                                      causal)
    plain = flash.flash_attention_plain(q, k, v, causal)
    return rel_err(o.double(), ref), rel_err(plain.double(), ref)


@contextlib.contextmanager
def kernel_errors(dispatch, win, flash):
    """The window and flash routes of ``dispatch`` also run the plain
    versions on the kernels' own inputs and record each call's error, of
    the plain output's largest; for flash also the kernel's and the
    float32 plain version's error against float64 (``flash_f64_errors``)."""
    errs = {"window_attention": [], "flash_attention": [],
            "flash_attention vs float64": [], "flash plain vs float64": []}
    saved = dispatch.window_attention, dispatch.flash_attention

    def window(q, k, v, window, win_valid=None):
        o = saved[0](q, k, v, window, win_valid)
        errs["window_attention"].append(rel_err(
            o, win.window_attention_plain(q, k, v, window, win_valid)))
        return o

    def flash_(q, k, v, *, causal=False):
        o = saved[1](q, k, v, causal=causal)
        errs["flash_attention"].append(rel_err(
            o, flash.flash_attention_plain(q, k, v, causal)))
        e_k, e_p = flash_f64_errors(flash, o, q, k, v, causal)
        errs["flash_attention vs float64"].append(e_k)
        errs["flash plain vs float64"].append(e_p)
        return o

    dispatch.window_attention, dispatch.flash_attention = window, flash_
    try:
        yield errs
    finally:
        dispatch.window_attention, dispatch.flash_attention = saved


def kink_leaf(name: str) -> bool:
    return name == "pos_emb" or name.split("/")[:2] in (
        ["head", "lateral"], ["head", "smooth"], ["head", "tower"])


def route_vs_plain(what, got, want, replayed, flips, out):
    """Check a step's leaf gradients against the plain route's: every leaf
    to TRAIN_GRAD_TOL with the kink branches replayed; with each route's
    own branches, the ``kink_leaf`` leaves to KINK_GRAD_TOL and the rest
    to TRAIN_GRAD_TOL.  Prints the worst leaves and the flipped branches."""
    own = {k: rel_err(got[k].to(want[k].device), want[k]) for k in want}
    kinks = sorted(k for k in own if kink_leaf(k))
    same = {k: rel_err(got[k].to(want[k].device), replayed[k])
            for k in want}
    top = sorted(own, key=own.get, reverse=True)[:6]
    worst_same = max(same, key=same.get)
    rest = {k: e for k, e in own.items() if not kink_leaf(k)}
    worst_rest = max(rest, key=rest.get)
    out.update({
        "flipped_branches": flips,
        "own_branches": {k: own[k] for k in top},
        "own_over_train_tol": sorted(k for k, e in own.items()
                                     if e > TRAIN_GRAD_TOL),
        "same_branches_worst": {worst_same: same[worst_same]}})
    say(f"  {what}: kink positions taking another branch "
        + ", ".join(f"{k} {n}" for k, n in flips.items()))
    say(f"  {what}, each route its own branches: worst leaves "
        + ", ".join(f"{k} {own[k]:.3g}" for k in top)
        + f"; above {TRAIN_GRAD_TOL}: {out['own_over_train_tol']} (limit "
        f"{KINK_GRAD_TOL} for the {len(kinks)} leaves in front of a kink, "
        f"{TRAIN_GRAD_TOL} for the other {len(rest)})")
    say(f"  {what}, the plain route taking the kernel route's branches: "
        f"worst leaf {worst_same} {same[worst_same]:.3g} (limit "
        f"{TRAIN_GRAD_TOL}); {len(same)} leaves")
    check(same[worst_same] <= TRAIN_GRAD_TOL,
          f"{what}: gradient {worst_same} {same[worst_same]} with the same "
          f"kink branches")
    check(rest[worst_rest] <= TRAIN_GRAD_TOL,
          f"{what}: gradient {worst_rest} {rest[worst_rest]}")
    check(all(own[k] <= KINK_GRAD_TOL for k in kinks),
          f"{what}: a leaf in front of a kink above {KINK_GRAD_TOL}: "
          f"{ {k: own[k] for k in kinks if own[k] > KINK_GRAD_TOL} }")


@contextlib.contextmanager
def autograd_backward(dispatch, win, flash):
    """The window and flash routes of ``dispatch`` with the kernels'
    forward and, for the backward, autograd through the plain versions at
    the saved inputs: the analytic backward's comparison at the same
    forward values."""
    import torch

    def plain_vjp(plain, saved, g, *args):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in saved]
            return torch.autograd.grad(plain(*xs, *args), xs, g)

    class Window(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, window, win_valid):
            ctx.save_for_backward(q, k, v)
            ctx.args = (window, win_valid)
            return win.window_attention_cuda(q, k, v, window, win_valid)

        @staticmethod
        def backward(ctx, g):
            return plain_vjp(win.window_attention_plain, ctx.saved_tensors,
                             g, *ctx.args) + (None, None)

    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            ctx.save_for_backward(q, k, v)
            ctx.causal = causal
            return flash.flash_attention_cuda(q, k, v, causal)

        @staticmethod
        def backward(ctx, g):
            return plain_vjp(flash.flash_attention_plain, ctx.saved_tensors,
                             g, ctx.causal) + (None,)

    saved = dispatch.window_attention, dispatch.flash_attention
    dispatch.window_attention = (
        lambda q, k, v, window, win_valid=None:
        Window.apply(q, k, v, window, win_valid))
    dispatch.flash_attention = (
        lambda q, k, v, *, causal=False: Flash.apply(q, k, v, causal))
    try:
        yield
    finally:
        dispatch.window_attention, dispatch.flash_attention = saved


def grad_vs_plain(torch, gen, name, route, plain, xs, tol=GRAD_TOL):
    """The gradients of a Function's ``route`` (one kernel launch) against
    autograd through its ``plain`` version, for a random cotangent; each
    to ``tol`` of its largest (``tol`` 0: bit-equal).  Returns the worst."""
    def grads(fn, g):
        ts = [x.detach().requires_grad_(True) for x in xs]
        return torch.autograd.grad(fn(*ts), ts, g)

    from repro_torch.kernels import dispatch
    g = torch.randn(route(*xs).shape, generator=gen, device=xs[0].device)
    dispatch.reset_launch_counts()
    got = grads(route, g)
    check(sum(dispatch.launch_counts().values()) == 1,
          f"{name}: the Function launched {dispatch.launch_counts()}")
    want = grads(plain, g)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    say(f"  {name}: grads vs autograd through plain, of the largest: "
        + ", ".join(f"{e:.3g}" for e in errs) + f" (limit {tol})")
    check(max(errs) <= tol and (tol or all(
        torch.equal(a, b) for a, b in zip(got, want))),
        f"{name}: gradient error {errs}")
    return max(errs)


def function_grad_checks(torch, cfg, dev, gen):
    """The Functions' gradients against autograd through the plain
    versions at the training shapes, and the analytic backward timed
    alone at the ViT shape (ms a call)."""
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.mixed_res_pool import ops as pool
    from repro_torch.kernels.window_attention import ops as win

    part = vb.vit_partition(cfg)
    w2, T = part.window ** 2, part.grid_h * part.grid_w
    H, Dh = cfg.n_heads, cfg.head_dim

    def compare(name, route, plain, xs, tol=GRAD_TOL):
        return grad_vs_plain(torch, gen, name, route, plain, xs, tol)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {}
    q, k, v = rand(B, T, H, Dh), rand(B, T, H, Dh), rand(B, T, H, Dh)
    wv = torch.tensor([T // w2 - 16, T // w2 - 24], dtype=torch.int32,
                      device=dev)
    out["window"] = compare(
        f"window_attention ({B}, {T}, {H}, {Dh}) w2={w2}",
        lambda *a: dispatch.window_attention(*a, w2),
        lambda *a: win.window_attention_plain(*a, w2), (q, k, v))
    out["window_win_valid"] = compare(
        f"window_attention win_valid {wv.tolist()}",
        lambda *a: dispatch.window_attention(*a, w2, wv),
        lambda *a: win.window_attention_plain(*a, w2, wv), (q, k, v))
    out["flash"] = compare(
        f"flash_attention ({B}, {T}, {H}, {Dh})", dispatch.flash_attention,
        flash.flash_attention_plain, (q, k, v))
    g = rand(B, T, H, Dh)
    out["window_bwd_ms"] = timed(torch, lambda: win.window_attention_bwd(
        q, k, v, g, w2))
    out["flash_bwd_ms"] = timed(torch, lambda: flash.flash_attention_bwd(
        q, k, v, g))
    say(f"  analytic backward alone: window {out['window_bwd_ms']:.3f} ms, "
        f"flash {out['flash_bwd_ms']:.3f} ms a layer")
    del q, k, v, g
    qc, kc, vc = rand(8, 128, 32, 128), rand(8, 128, 8, 128), \
        rand(8, 128, 8, 128)
    out["flash_causal_gqa"] = compare(
        "flash_attention causal (8, 128, 32/8, 128)",
        lambda *a: dispatch.flash_attention(*a, causal=True),
        lambda *a: flash.flash_attention_plain(*a, True), (qc, kc, vc))
    frame = torch.rand((B, *cfg.vit.img_size, 3), generator=gen, device=dev)
    compare("avg_pool frame d=2", lambda x: dispatch.avg_pool(x, 2),
            lambda x: pool.avg_pool_plain(x, 2), (frame,), tol=0.0)
    # the block sum adds d^2 terms in another order than autograd's
    # scatter through repeat_interleave
    lows = rand(B * part.n_regions, part.window, part.window, cfg.d_model)
    compare("nn_upsample LOW windows d=2",
            lambda x: dispatch.nn_upsample(x, 2),
            lambda x: pool.nn_upsample_plain(x, 2), (lows,), tol=POOL_TOL)
    return out


def half_function_grad_checks(torch, cfg, dev, gen, count):
    """The four Functions with a backward at fp16 and bf16, at the
    full-width ViTDet-L shapes (window at the padded wave with
    ``win_valid``, flash at the global blocks' (B, T, H, Dh), at fp16 at
    one image's (1, T, H, Dh), whose CPU side costs half as much,
    avg_pool at the serving frame, nn_upsample at the LOW windows): on
    the card the
    half forward kernel and the reference's VJP in plain PyTorch (flash
    and window in float32, cast to each operand's type; the pools in the
    cotangent's type), against the same on CPU copies of the inputs and
    cotangent (the plain forward and backward).  Outputs and gradients
    within one ULP of the half type at >= HALF_EQUAL bit-equal
    (``half_close``); the half kernels must launch (path ``train half
    Functions``).  Nothing falls back: a half backward that fails fails
    the run."""
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.build import FLOAT_SUFFIX

    KERNEL_OF = {"window": "window_attention", "flash": "flash_attention",
                 "avg_pool": "avg_pool", "nn_upsample": "nn_upsample"}
    part = vb.vit_partition(cfg)
    w2, T = part.window ** 2, part.grid_h * part.grid_w
    H, Dh = cfg.n_heads, cfg.head_dim
    wv = torch.tensor([T // w2 - 16, T // w2 - 24], dtype=torch.int32)
    flash_b = {torch.float16: 1, torch.bfloat16: B}

    def cases(dt):
        fb = flash_b[dt]
        return {
            "window": ((B, T, H, Dh), (B, T, H, Dh), lambda q, k, v: (
                dispatch.window_attention(q, k, v, w2, wv.to(q.device))), 3),
            "flash": ((fb, T, H, Dh), (fb, T, H, Dh),
                      lambda q, k, v: dispatch.flash_attention(q, k, v), 3),
            "avg_pool": ((B, *cfg.vit.img_size, 3),
                         (B, cfg.vit.img_size[0] // 2,
                          cfg.vit.img_size[1] // 2, 3),
                         lambda x: dispatch.avg_pool(x, 2), 1),
            "nn_upsample": ((B * part.n_regions, part.window, part.window,
                             cfg.d_model),
                            (B * part.n_regions, 2 * part.window,
                             2 * part.window, cfg.d_model),
                            lambda x: dispatch.nn_upsample(x, 2), 1)}
    out = {}
    torch.set_num_threads(os.cpu_count() or 1)
    dispatch.reset_launch_counts()
    for dt in flash_b:
        for name, (shape, gshape, fn, n_in) in cases(dt).items():
            xs = [torch.randn(shape, generator=gen, device=dev).to(dt)
                  for _ in range(n_in)]
            g = torch.randn(gshape, generator=gen, device=dev).to(dt)
            runs = []
            for d in (dev, "cpu"):
                ins = [x.detach().to(d).requires_grad_(True) for x in xs]
                o = fn(*ins)
                o.backward(g.to(d))
                runs.append([o.detach()] + [x.grad for x in ins])
            row = {}
            for what, got, want in zip(("out", "dq", "dk", "dv"), *runs):
                row[what] = half_close(
                    torch, f"{name} {dt} {what} card vs CPU", got.cpu(),
                    want, ATTN_TOL if n_in == 3 else 0.0)
            out[f"{name}_{str(dt)[6:]}"] = row
            say(f"  half gradients, {name} {str(dt)[6:]} {tuple(shape)}: "
                "card vs CPU (largest difference, bit-equal share) "
                + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.5f}"
                            for k, v in row.items()))
            del xs, g, runs
    launches = dispatch.launch_counts()
    count("train half Functions", launches)
    for dt in flash_b:
        half = dispatch.launch_counts(FLOAT_SUFFIX[dt])
        want = {k: 1 for k in KERNEL_OF.values()}
        check(all(half[k] == v for k, v in want.items()),
              f"half Functions: {dt} launches {half}, want {want}")
    torch.cuda.empty_cache()
    return out


def stage_ms(torch, cfg, flat, like, img, tgt):
    """One training step's forward, backward and AdamW device ms: CUDA
    events between the stages on the one stream they share."""
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import server as ts

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    copy = {k: v.clone() for k, v in flat.items()}   # AdamW updates in place
    ev[0].record()
    loss, _ = ts.loss_fn(cfg, ckpt.unflatten(leaves, like), img, tgt)
    ev[1].record()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ev[2].record()
    adam.adam_update(dict(zip(leaves, grads)), adam.init_adam(copy), copy,
                     lr=1e-4, grad_clip=1.0)
    ev[3].record()
    ev[3].synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1])
            for i, name in enumerate(("forward", "backward", "adamw"))}


def profile_train(torch, step, wall_s):
    """Trace one training step: device ms by kernel family (kernels inside
    the analytic backward's ranges count as ``attention_bwd`` where the
    trace carries those ranges) and the device's busy share of the
    untraced step's wall ``wall_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    (OUT_DIR / "profile_train.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev
             if e.name in BWD_MARKS]
    fam: dict = {}
    for e in dev:
        if e.name in BWD_MARKS or getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if ms <= 0:
            continue
        if any(a <= e.time_range.start and e.time_range.end <= b
               for a, b in spans):
            key = "attention_bwd"
        else:
            key = next((f for frag, f in FAMILIES if frag in e.name), "other")
        fam[key] = fam.get(key, 0.0) + ms
    busy = sum(fam.values())
    check(busy > 0, "profile train: no device time traced")
    out = {"device_ms": busy, "busy_share": busy / (wall_s * 1e3),
           "bwd_spans_traced": len(spans),
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1]))}
    say(f"  profile train step: device {busy:.2f} ms of {wall_s * 1e3:.2f} "
        f"ms wall (busy {out['busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["families_ms"].items())
        + ("" if spans else "; the trace has no analytic-backward ranges, "
           "so its kernels count in their own families"))
    return out


def leaf_errors(got, want):
    """Each leaf's max error over its largest magnitude; (worst, name)."""
    errs = {k: rel_err(got[k].cpu(), want[k].cpu()) for k in want}
    name = max(errs, key=errs.get)
    return errs[name], name


def train_phase(torch, cfg, dev, gen, count):
    """Phase 15: the Functions' gradients, full-width training steps,
    their gradients against the plain route and a 2-block model against
    the CPU, then the reference's SIM recipe, its F1 and a checkpoint."""
    from repro_torch.configs.vitdet_l import SIM
    from repro_torch.core import det_head as dh
    from repro_torch.core import vit_backbone as vb
    from repro_torch.data import synthetic_video as sv
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.window_attention import ops as win
    from repro_torch.offload import detection as det
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import server as ts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    say(f"phase 15: training {cfg.name} ({cfg.n_layers} blocks, D="
        f"{cfg.d_model}, {cfg.vit.img_size[0]} px, B={B}) and the SIM "
        f"recipe")
    out = {"functions": function_grad_checks(torch, cfg, dev, gen),
           "half_functions": half_function_grad_checks(torch, cfg, dev, gen,
                                                       count)}

    # full-width steps through the kernels
    params = ts.seed0_params(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # the weights, earlier phases'
    dispatch.reset_launch_counts()
    _, m = ts.train_server_params(cfg, steps=TRAIN_STEPS, batch=B,
                                  params=params, device=dev, log_every=0)
    launches = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    count("train vitdet-l", launches)
    n_glob = cfg.vit.n_subsets
    check(all(np.isfinite(m["losses"])), f"non-finite loss: {m['losses']}")
    check(launches["window_attention"] == (cfg.n_layers - n_glob)
          * TRAIN_STEPS and launches["flash_attention"] == n_glob
          * TRAIN_STEPS, f"launches over {TRAIN_STEPS} steps: {launches}")
    step_s = statistics.median(m["step_s"][1:])
    out["full_width"] = {
        "losses": m["losses"], "step_s": m["step_s"],
        "step_median_ms": step_s * 1e3, "peak_gb": peak / 1e9,
        "held_before_gb": held / 1e9,
        "launches": {k: n for k, n in launches.items() if n}}
    say(f"  {TRAIN_STEPS} steps: losses " + " ".join(
        f"{x:.3f}" for x in m["losses"]) + f"; step median "
        f"{step_s * 1e3:.1f} ms (first {m['step_s'][0] * 1e3:.1f}); peak "
        f"memory {peak / 1e9:.2f} GB ({held / 1e9:.2f} GB allocated before "
        f"the run, the seed-0 weights included); launches "
        f"{out['full_width']['launches']} "
        f"({cfg.n_layers - n_glob} window + {n_glob} flash a step)")

    frames, targets = ts.training_pool(cfg)
    idx = np.random.default_rng(0).integers(0, len(frames), B)
    img, tgt = ts.make_batch(frames, targets, idx, dev)
    del frames, targets
    like = vb.strip_derived(params)
    flat = ckpt.flatten(like)
    stage_ms(torch, cfg, flat, like, img, tgt)          # warm-up
    stages = stage_ms(torch, cfg, flat, like, img, tgt)
    out["full_width"]["stages_ms"] = stages
    say("  one step on the device: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in stages.items()))
    copy = {k: v.clone() for k, v in flat.items()}   # AdamW updates in place
    opt = adam.init_adam(copy)

    def step():
        _, grads = ts.value_and_grad(cfg, flat, like, img, tgt)
        adam.adam_update(grads, opt, copy, lr=1e-4, grad_clip=1.0)
        torch.cuda.synchronize()

    out["full_width"]["profile"] = profile_train(torch, step, step_s)
    del opt, copy

    with kink_branches(dh) as br_k:
        loss_k, g_k = ts.value_and_grad(cfg, flat, like, img, tgt)
    check(abs(float(loss_k) - m["losses"][0]) <= 1e-5 * abs(m["losses"][0]),
          f"first step's loss {float(loss_k)} vs the run's "
          f"{m['losses'][0]}")
    with autograd_backward(dispatch, win, flash):
        _, g_a = ts.value_and_grad(cfg, flat, like, img, tgt)
    worst, name = leaf_errors(g_k, g_a)
    out["full_width"]["vs_autograd"] = {"worst_leaf": name, "grad_err": worst}
    say(f"  first step, analytic backward vs autograd through the plain "
        f"versions at the kernels' forward values: worst leaf {name} "
        f"{worst:.3g} of its largest (limit {TRAIN_GRAD_TOL}); {len(g_k)} "
        f"leaves")
    check(worst <= TRAIN_GRAD_TOL, f"gradient {name}: {worst} vs autograd")
    del g_a
    # the forward's part: the kernels against their plain versions on the
    # step's own attention inputs
    with torch.no_grad(), kernel_errors(dispatch, win, flash) as kerr:
        ts.loss_fn(cfg, ckpt.unflatten(flat, like), img, tgt)
    out["full_width"]["kernel_err_on_step"] = {k: max(v)
                                               for k, v in kerr.items()}
    say("  the first step's attention calls, kernel vs plain on the same "
        "inputs, worst of the largest: " + ", ".join(
            f"{k} {max(v):.3g} ({len(v)} calls)" for k, v in kerr.items()))
    dispatch.reset_launch_counts()
    with plain_route(dispatch, win, flash):
        with kink_branches(dh) as br_p:
            loss_p, g_p = ts.value_and_grad(cfg, flat, like, img, tgt)
        with kink_branches(dh, replay=br_k):
            _, g_r = ts.value_and_grad(cfg, flat, like, img, tgt)
    check(not any(dispatch.launch_counts().values()),
          f"the plain route launched {dispatch.launch_counts()}")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    out["full_width"]["vs_plain"] = {"loss_rel": loss_rel}
    say(f"  first step vs the plain route on the card: loss rel "
        f"{loss_rel:.3g}")
    route_vs_plain("first step vs the plain route", g_k, g_p, g_r,
                   branch_flips(br_k, br_p, tgt), out["full_width"]["vs_plain"])
    del g_k, g_p, g_r, br_k, br_p, params, like, flat
    torch.cuda.empty_cache()

    # a 2-block full-width model, card vs CPU
    small = cfg.replace(n_layers=2,
                        vit=dataclasses.replace(cfg.vit, n_subsets=1))
    like2 = vb.strip_derived(ts.seed0_params(small, dev))
    flat2 = ckpt.flatten(like2)
    img1, tgt1 = img[:1], [{k: v[:1] for k, v in t.items()} for t in tgt]
    with kink_branches(dh) as br_c:
        loss_c, g_c = ts.value_and_grad(small, flat2, like2, img1, tgt1)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    flat_h = {k: v.cpu() for k, v in flat2.items()}
    host = (small, flat_h, ckpt.unflatten(flat_h, like2), img1.cpu(),
            [{k: v.cpu() for k, v in t.items()} for t in tgt1])
    with kink_branches(dh) as br_h:
        loss_h, g_h = ts.value_and_grad(*host)
    with kink_branches(dh, replay=br_c):
        _, g_hr = ts.value_and_grad(*host)
    loss_rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    out["card_vs_cpu"] = {"loss_rel": loss_rel,
                          "cpu_s": time.perf_counter() - t0}
    say(f"  2-block model, B=1, card vs CPU: loss rel {loss_rel:.3g} "
        f"(limit {TRAIN_LOSS_RTOL}); CPU {out['card_vs_cpu']['cpu_s']:.1f} "
        f"s for two steps")
    check(loss_rel <= TRAIN_LOSS_RTOL, "2-block training step: card vs CPU "
          f"loss {loss_rel}")
    route_vs_plain("2-block card vs CPU", g_c, g_h, g_hr,
                   branch_flips(br_c, br_h, tgt1), out["card_vs_cpu"])
    del g_c, g_h, g_hr, br_c, br_h, host, flat2, flat_h, like2, img, tgt
    torch.cuda.empty_cache()

    # the reference's SIM recipe
    dispatch.reset_launch_counts()
    trained, ms = ts.train_server_params(
        SIM, steps=SIM_STEPS, peak_lr=SIM_PEAK_LR, batch=2, log_every=200,
        device=dev, log=lambda line: say("  " + line))
    sim_launches = dispatch.launch_counts()
    count("train SIM", sim_launches)
    first, last = (statistics.mean(ms["losses"][:50]),
                   statistics.mean(ms["losses"][-100:]))
    size = SIM.vit.img_size[0]
    # frame F1 against the ground-truth boxes: held-out clips (another
    # seed) and, for scale, the training clips themselves
    f1 = {}
    for what, p in (("trained", trained),
                    ("seed 0", ts.seed0_params(SIM, dev))):
        server = ServerModel(SIM, p, top_k=32, score_thresh=0.4, device=dev)
        like = vb.strip_derived(p)
        for clips, seed in (("held-out", F1_SEED), ("training", ts.CLIP_SEED)):
            scores, losses, n_det, n_gt = [], [], 0, 0
            for name in F1_VIDEOS:
                clip, gts = sv.make_clip(name, F1_FRAMES, size=size,
                                         seed=seed)
                tg = [sv.render_targets(g, size, n_classes=SIM.vit.n_classes)
                      for g in gts]
                for i, (f, gt) in enumerate(zip(clip, gts)):
                    dets = server.infer(f)
                    scores.append(det.frame_f1(dets, gt))
                    n_det, n_gt = n_det + len(dets), n_gt + len(gt)
                    with torch.no_grad():
                        losses.append(float(ts.loss_fn(
                            SIM, like, *ts.make_batch(clip, tg, [i], dev))[0]))
            f1[f"{what} {clips}"] = {"f1": statistics.mean(scores),
                                     "detections": n_det, "boxes": n_gt,
                                     "loss": statistics.mean(losses)}
    out["sim"] = {"wall_s": ms["wall_s"], "losses": ms["losses"],
                  "first50_mean": first, "last100_mean": last, "f1": f1,
                  "step_median_ms": statistics.median(ms["step_s"]) * 1e3,
                  "launches": {k: n for k, n in sim_launches.items() if n}}
    say(f"  SIM recipe: {SIM_STEPS} steps in {ms['wall_s']:.1f} s (step "
        f"median {out['sim']['step_median_ms']:.2f} ms); mean loss first 50 "
        f"{first:.4f}, last 100 {last:.4f}; frame F1 vs ground truth, "
        f"{len(F1_VIDEOS)} clips x {F1_FRAMES} frames at score 0.4: "
        + ", ".join(f"{k} {v['f1']:.3f} ({v['detections']} detections, "
                    f"{v['boxes']} boxes, mean loss {v['loss']:.3f})"
                    for k, v in f1.items()))
    check(last < first, f"SIM loss did not fall: {first} -> {last}")

    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    tree = vb.strip_derived(trained)
    ckpt.save(tree, str(d), step=SIM_STEPS)
    back = ckpt.flatten(ckpt.restore(tree, str(d)))
    check(all(torch.equal(back[k], v) and back[k].device == v.device
              for k, v in ckpt.flatten(tree).items()),
          "checkpoint round trip is not bit-equal")
    shutil.rmtree(d)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  checkpoint save/restore: {len(back)} leaves bit-equal; "
        f"phase 15: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# LM training (phase 16)


def lm_grads(torch, registry, ckpt, cfg, params, batch, remat=True):
    """The loss and every leaf's gradient of one ``lm_loss`` (the train
    step's forward and backward), the leaves' ``.grad`` cleared after."""
    flat = ckpt.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
        p.grad = None
    loss, _ = registry.lm_loss(cfg, params, batch, remat)
    loss.backward()
    grads = {k: p.grad for k, p in flat.items()}
    for p in flat.values():
        p.grad = None
    return loss.detach(), grads


def lm_leaves_close(what, got, want, out, tol=LM_GRAD_TOL):
    """Every leaf's gradient to ``tol`` of its largest (the LM has no
    ReLU: no kink tolerance applies); prints the worst leaves."""
    errs = {k: rel_err(got[k].to(want[k].device).float(), want[k].float())
            for k in want}
    top = sorted(errs, key=errs.get, reverse=True)[:4]
    out[what] = {k: errs[k] for k in top}
    say(f"  {what}: worst leaves " + ", ".join(
        f"{k} {errs[k]:.3g}" for k in top) + f" of their largest (limit "
        f"{tol}); {len(errs)} leaves")
    check(errs[top[0]] <= tol, f"{what}: {top[0]} {errs[top[0]]}")


def lm_function_checks(torch, dev):
    """The flash Function, causal GQA at the LM training shapes: forward
    and dq / dk / dv against autograd through the plain version, and the
    forward's error against float64 beside the plain version's."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as flash

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    out = {}
    for B_, T_, H_, KV_, Dh_ in LM_FLASH_SHAPES:
        name = f"flash causal ({B_}, {T_}, {H_}/{KV_}, {Dh_})"
        q = torch.randn((B_, T_, H_, Dh_), generator=gen, device=dev)
        k, v = (torch.randn((B_, T_, KV_, Dh_), generator=gen, device=dev)
                for _ in range(2))
        o = flash.flash_attention_cuda(q, k, v, True)
        fwd = rel_err(o, flash.flash_attention_plain(q, k, v, True))
        e_k, e_p = flash_f64_errors(flash, o, q, k, v, True)
        grad = grad_vs_plain(
            torch, gen, name, lambda *a: dispatch.flash_attention(
                *a, causal=True),
            lambda *a: flash.flash_attention_plain(*a, True), (q, k, v))
        out[name] = {"forward": fwd, "grad": grad, "kernel_vs_f64": e_k,
                     "plain_vs_f64": e_p}
        say(f"  {name}: forward vs plain {fwd:.3g} (limit {GRAD_TOL}); "
            f"against float64: kernel {e_k:.3g}, float32 plain {e_p:.3g}")
        check(fwd <= GRAD_TOL, f"{name}: forward {fwd}")
    return out


def lm_100m_run(torch, dev, count):
    """``examples/train_lm_100m.py`` through ``launch.train.train``: the
    loss must fall by 0.1 (its criterion); the checkpoint of the last
    step restores bit-equal, and a resumed run goes on from it."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint as ckpt

    cfg = get_config("qwen3-4b").replace(**LM_100M)
    steps, n = LM_100M_STEPS, cfg.param_count()
    say(f"  {cfg.name}: {n / 1e6:.1f}M parameters ({cfg.n_layers} layers, "
        f"D={cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads}), {steps} "
        f"steps at B={LM_100M_B}, T={LM_100M_T}")
    with tempfile.TemporaryDirectory() as d:
        dispatch.reset_launch_counts()
        r = lt.train(cfg, steps, LM_100M_B, LM_100M_T, ckpt_dir=d,
                     save_every=steps // 2, log_every=50, device=dev,
                     log=lambda line: say("    " + line))
        launches = dispatch.launch_counts()
        count("lm_train qwen3-100m", launches)
        losses = r["losses"]
        med = statistics.median(r["step_s"][1:]) * 1e3
        # the loss of a model that knows only which tokens the stream draws
        unigram = float(np.log(min(cfg.vocab_size, 4096)))
        out = {"params": n, "first_loss": r["first_loss"],
               "mean_last10": r["mean_last10"], "unigram_level": unigram,
               "wall_s": r["wall_s"], "step_median_ms": med,
               "losses_every_50": losses[::50],
               "launches": {k: v for k, v in launches.items() if v}}
        say(f"  {cfg.name}: loss {r['first_loss']:.4f} -> mean of the last "
            f"10 {r['mean_last10']:.4f} (the stream's unigram level "
            f"{unigram:.4f}); step median {med:.1f} ms; wall "
            f"{r['wall_s']:.1f} s; launches {out['launches']}")
        check(all(np.isfinite(losses)), f"{cfg.name}: a loss is not finite")
        check(r["mean_last10"] < r["first_loss"] - 0.1,
              f"{cfg.name}: the loss did not fall by 0.1")
        check(launches["flash_attention"] == cfg.n_layers * steps,
              f"{cfg.name}: launches {launches}")
        params, opt = r.pop("state")
        back_p, back_o = ckpt.restore((params, opt), d)
        saved = ckpt.flatten((params, opt))
        same = (type(back_o.step) is int and back_o.step == opt.step == steps
                and all(torch.equal(v, saved[k].detach()) for k, v in
                        ckpt.flatten((back_p, back_o)).items()
                        if k != "1/step"))
        check(same, f"{cfg.name}: the step-{steps} checkpoint does not "
              f"restore bit-equal")
        del params, opt, back_p, back_o
        r2 = lt.train(cfg, steps + LM_100M_RESUME, LM_100M_B, LM_100M_T,
                      ckpt_dir=d, resume=True, log_every=0, device=dev,
                      log=lambda line: say("    " + line))
        r2.pop("state")
        check(r2["start_step"] == steps
              and len(r2["losses"]) == LM_100M_RESUME
              and all(np.isfinite(r2["losses"])),
              f"{cfg.name}: resume {r2['start_step']}, {r2['losses']}")
        out["resume"] = {"start_step": r2["start_step"],
                         "losses": r2["losses"]}
        say(f"  {cfg.name}: the step-{steps} checkpoint (params, AdamState "
            f"step {steps}, moments) restores bit-equal; resumed for "
            f"{LM_100M_RESUME} steps, losses " + " ".join(
                f"{x:.3f}" for x in r2["losses"]))
    return out


def lm_stage_ms(torch, registry, adam, ckpt, cfg, params, opt, batch):
    """One train step's forward (``lm_loss``), backward and AdamW device
    ms: CUDA events between the stages on their one stream."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    flat = ckpt.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    ev[0].record()
    loss, _ = registry.lm_loss(cfg, params, batch, True)
    ev[1].record()
    loss.backward()
    ev[2].record()
    with torch.no_grad():
        adam.adam_update({k: p.grad for k, p in flat.items()}, opt, flat,
                         lr=1e-6, weight_decay=0.1, grad_clip=1.0)
    ev[3].record()
    ev[3].synchronize()
    for p in flat.values():
        p.grad = None
    return {name: ev[i].elapsed_time(ev[i + 1])
            for i, name in enumerate(("forward", "backward", "adamw"))}


def lm_full_width(torch, cfg, dev, count):
    """Full-width Qwen3-4B, seed-0 weights: the first step's gradients
    against the plain route, flash's error on the step's own inputs, then
    LM_TRAIN_STEPS steps at B = 1 and one at B = 2 over two microbatches,
    with remat: launches, step wall, peak memory, the forward / backward /
    AdamW split and a traced step."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.window_attention import ops as win
    from repro_torch.launch import train as lt
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as tr

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    data = lt.synthetic_batches(cfg, 2, LM_TRAIN_T, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                next(data).items()} for _ in range(LM_TRAIN_STEPS)]
    b1 = [{k: v[:1] for k, v in b.items()} for b in batches]
    say(f"  {cfg.name}: {cfg.param_count() / 1e9:.3f}B parameters, "
        f"{held / 1e9:.2f} GB allocated before the weights")
    out = {"held_before_gb": held / 1e9}

    loss_k, g_k = lm_grads(torch, registry, ckpt, cfg, params, b1[0])
    dispatch.reset_launch_counts()
    with plain_route(dispatch, win, flash):
        loss_p, g_p = lm_grads(torch, registry, ckpt, cfg, params, b1[0])
    check(not any(dispatch.launch_counts().values()),
          f"the plain route launched {dispatch.launch_counts()}")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    out["vs_plain"] = {"loss_rel": rel}
    say(f"  first step vs the plain route on the card: loss rel {rel:.3g}")
    lm_leaves_close("first step vs the plain route", g_k, g_p,
                    out["vs_plain"])
    del g_k, g_p
    with torch.no_grad(), kernel_errors(dispatch, win, flash) as kerr:
        registry.lm_loss(cfg, params, b1[0])
    out["kernel_err_on_step"] = {k: max(v) for k, v in kerr.items() if v}
    say("  the first step's flash calls on their own inputs, worst of the "
        "largest: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                out["kernel_err_on_step"].items())
        + f" ({len(kerr['flash_attention'])} calls)")

    opt = adam.init_adam(ckpt.flatten(params))
    step = tr.make_train_step(cfg, tr.TrainConfig(remat=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    losses, walls = [], []
    for b in b1:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    launches = dispatch.launch_counts()
    count("lm_train qwen3-4b", launches)
    check(abs(losses[0] - float(loss_k)) <= 1e-5 * abs(losses[0]),
          f"first step's loss {losses[0]} vs {float(loss_k)}")
    per_step = 2 * cfg.n_layers                 # forward + remat recompute
    check(all(np.isfinite(losses)) and launches["flash_attention"]
          == per_step * LM_TRAIN_STEPS and sum(launches.values())
          == launches["flash_attention"],
          f"{LM_TRAIN_STEPS} steps: losses {losses}, launches {launches}")
    step2 = tr.make_train_step(cfg, tr.TrainConfig(remat=True,
                                                   accum_steps=2))
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    params, opt, m = step2(params, opt, batches[0])
    loss2, wall2 = float(m["loss"]), time.perf_counter() - t0
    launches2 = dispatch.launch_counts()
    count("lm_train qwen3-4b accum 2", launches2)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    check(np.isfinite(loss2) and launches2["flash_attention"]
          == 2 * per_step, f"B=2 accum 2: loss {loss2}, {launches2}")
    check(peak < total, f"peak {peak} of {total} bytes")
    wall = statistics.median(walls[1:])
    out.update({"losses": losses, "step_s": walls, "step_median_ms":
                wall * 1e3, "accum2": {"loss": loss2, "wall_ms": wall2 * 1e3,
                                       "launches": launches2},
                "peak_gb": peak / 1e9, "card_gb": total / 1e9,
                "launches": launches})
    say(f"  {LM_TRAIN_STEPS} steps at B=1, T={LM_TRAIN_T}, remat: losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; step median "
        f"{wall * 1e3:.1f} ms (first {walls[0] * 1e3:.1f}); {per_step} "
        f"flash launches a step; B=2 over 2 microbatches: loss {loss2:.4f}, "
        f"{wall2 * 1e3:.1f} ms, {launches2['flash_attention']} launches; "
        f"peak memory {peak / 1e9:.2f} GB of {total / 1e9:.2f} GB")
    out["stages_ms"] = lm_stage_ms(torch, registry, adam, ckpt, cfg, params,
                                   opt, b1[0])
    say("  one step on the device: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out["stages_ms"].items()))

    def traced():
        step(params, opt, b1[0])
        torch.cuda.synchronize()

    out["profile"] = profile_wave(torch, "lm_train_qwen3", traced, wall,
                                  marks=("flash_attention_bwd", "adamw"))
    del params, opt, m
    torch.cuda.empty_cache()
    return out


def lm_half_full_width(torch, cfg, dev, count, dt):
    """Full-depth, full-width Qwen3-4B at ``dt`` parameters (float32 AdamW
    moments, ``init_train_state(dtype=)``), seed 0: LM_HALF_STEPS steps at
    B = 1, T = LM_TRAIN_T with remat after the float32 state is freed;
    losses, step wall, peak memory, launches by type (the half flash
    forward kernel must launch: path ``lm_train qwen3-4b bf16``), the
    forward / backward / AdamW device ms and a traced step (its
    ``flash_attention_bwd`` and ``adamw`` spans)."""
    import gc

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.build import FLOAT_SUFFIX
    from repro_torch.launch import train as lt
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as tr

    suf = FLOAT_SUFFIX[dt]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, opt = tr.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev, dt)
    data = lt.synthetic_batches(cfg, 1, LM_TRAIN_T, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                next(data).items()} for _ in range(LM_HALF_STEPS)]
    step = tr.make_train_step(cfg, tr.TrainConfig(remat=True))
    dispatch.reset_launch_counts()
    losses, walls = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    launches, by_type = dispatch.launch_counts(), dispatch.launch_counts(suf)
    count(f"lm_train qwen3-4b {suf}", launches)
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.n_layers                 # forward + remat recompute
    kinds = {str(p.dtype) for p in ckpt.flatten(params).values()}
    check(kinds == {str(dt)} and all(
        v.dtype == torch.float32 for v in opt.m.values()),
        f"{suf} state: parameters {kinds}")
    check(all(np.isfinite(losses)), f"{suf} steps: losses {losses}")
    check(launches["flash_attention"] == by_type["flash_attention"]
          == per_step * LM_HALF_STEPS and sum(launches.values())
          == launches["flash_attention"],
          f"{suf} steps: launches {launches}, {suf} {by_type}")
    out = {"losses": losses, "step_s": walls,
           "step_ms": [w * 1e3 for w in walls], "peak_gb": peak / 1e9,
           "held_before_gb": held / 1e9,
           "launches": {k: v for k, v in launches.items() if v},
           "launches_by_type": {s_: {k: v for k, v in
                                     dispatch.launch_counts(s_).items() if v}
                                for s_ in ("f32", "f16", "bf16")}}
    out["stages_ms"] = lm_stage_ms(torch, registry, adam, ckpt, cfg, params,
                                   opt, batches[0])

    def traced():
        step(params, opt, batches[0])
        torch.cuda.synchronize()

    out["profile"] = profile_wave(torch, f"lm_train_qwen3_{suf}", traced,
                                  walls[-1],
                                  marks=("flash_attention_bwd", "adamw"))
    fam = out["profile"]["families_ms"]
    say(f"  {cfg.name} at {suf} ({cfg.n_layers} layers), {LM_HALF_STEPS} "
        f"steps at B=1, T={LM_TRAIN_T}, remat: losses " + " ".join(
            f"{x:.4f}" for x in losses) + "; step ms " + " ".join(
            f"{w * 1e3:.1f}" for w in walls) + f"; peak {peak / 1e9:.2f} GB "
        f"({held / 1e9:.2f} GB held before); launches by type "
        f"{out['launches_by_type']}")
    say(f"  {cfg.name} {suf} step on the device: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out["stages_ms"].items())
        + "; traced: flash_attention_bwd "
        f"{fam.get('flash_attention_bwd', 0):.2f} ms, adamw "
        f"{fam.get('adamw', 0):.2f} ms")
    del params, opt, m, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_train_steps(torch, cfg, dev, count):
    """Full-width steps of an SSM / hybrid model, remat on: the scans take
    the training route (no ``ssd_scan`` launch); zamba2's shared block
    launches flash n_shared_calls times a forward, twice under remat."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as lt
    from repro_torch.models import hybrid as hyb
    from repro_torch.models import registry
    from repro_torch.train import trainer as tr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt = tr.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    step = tr.make_train_step(cfg, tr.TrainConfig(remat=True))
    data = lt.synthetic_batches(cfg, SSM_TRAIN_B, LM_TRAIN_T, seed=SEED)
    dispatch.reset_launch_counts()
    losses, walls = [], []
    for _ in range(SSM_TRAIN_STEPS):
        b = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    launches = dispatch.launch_counts()
    count(f"lm_train {cfg.name}", launches)
    peak = torch.cuda.max_memory_allocated()
    n_flash = (2 * hyb.n_shared_calls(cfg) if cfg.family == "hybrid" else 0)
    out = {"losses": losses, "step_s": walls, "peak_gb": peak / 1e9,
           "launches": {k: v for k, v in launches.items() if v}}
    say(f"  {cfg.name} ({cfg.family}, {cfg.param_count() / 1e9:.3f}B), "
        f"B={SSM_TRAIN_B}, T={LM_TRAIN_T}: losses " + " ".join(
            f"{x:.4f}" for x in losses) + ", step ms " + " ".join(
            f"{w * 1e3:.1f}" for w in walls) + f"; peak {peak / 1e9:.2f} GB; "
        f"launches {out['launches']} ({n_flash} flash a step)")
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    check(launches["ssd_scan"] == 0 and launches["flash_attention"]
          == n_flash * SSM_TRAIN_STEPS, f"{cfg.name}: launches {launches}")
    del params, opt
    torch.cuda.empty_cache()
    return out


def lm_card_vs_cpu(torch, cfg, dev, dtype=None, rtol=TRAIN_LOSS_RTOL,
                   grad_tol=LM_GRAD_TOL):
    """One training step's loss and gradients of a few full-width layers,
    card against CPU (the plain versions): loss to ``rtol``, every leaf
    to ``grad_tol`` of its largest; parameters at ``dtype`` (None:
    float32)."""
    from repro_torch.models import registry
    from repro_torch.offload.simulator import to_device
    from repro_torch.train import checkpoint as ckpt

    torch.set_num_threads(os.cpu_count() or 1)
    p_gpu = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 5), dev, dtype)
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    toks = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, LM_CROSS_T))
    t0 = time.perf_counter()
    loss_c, g_c = lm_grads(torch, registry, ckpt, cfg, p_gpu,
                           {"tokens": torch.as_tensor(toks, device=dev)})
    loss_h, g_h = lm_grads(torch, registry, ckpt, cfg, p_cpu,
                           {"tokens": torch.as_tensor(toks)})
    rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    what = (f"{cfg.n_layers}-layer {cfg.name} "
            f"{'' if dtype is None else str(dtype)[6:] + ' '}card vs CPU")
    out = {"loss_rel": rel, "s": time.perf_counter() - t0}
    say(f"  {what}, B=1, T={LM_CROSS_T}: loss rel {rel:.3g} (limit "
        f"{rtol}); {out['s']:.1f} s")
    check(rel <= rtol, f"{what}: loss {rel}")
    lm_leaves_close(what, g_c, g_h, out, grad_tol)
    del p_gpu, p_cpu, g_c, g_h
    torch.cuda.empty_cache()
    return out


def lm_train_phase(torch, dev, count):
    """Phase 16: the flash Function at the LM shapes, the ~100M run with
    its checkpoint and resume, full-width Qwen3-4B, mamba2-370m and
    zamba2-1.2b steps, and few-layer steps card against CPU."""
    import gc

    from repro_torch.configs.mamba2_370m import CONFIG as MAMBA
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say("phase 16: LM training (registry.lm_loss, train.trainer, "
        "launch.train)")
    out = {"functions": lm_function_checks(torch, dev),
           "qwen3-100m": lm_100m_run(torch, dev, count)}
    gc.collect()
    torch.cuda.empty_cache()
    out[QWEN.name] = lm_full_width(torch, QWEN, dev, count)
    out[f"{QWEN.name} bf16"] = lm_half_full_width(torch, QWEN, dev, count,
                                                  torch.bfloat16)
    for c in (MAMBA, ZAMBA):
        out[c.name] = ssm_train_steps(torch, c, dev, count)
    out["card_vs_cpu"] = {c.name: lm_card_vs_cpu(torch, c, dev) for c in (
        QWEN.replace(n_layers=2), MAMBA.replace(n_layers=2),
        ZAMBA.replace(n_layers=6))}
    # the bf16 step's loss and gradients, held as the CPU tests hold the
    # two packages' bf16 trees (tests/test_torch_half_train.py)
    out["card_vs_cpu"]["qwen3-4b bf16"] = lm_card_vs_cpu(
        torch, QWEN.replace(n_layers=2), dev, torch.bfloat16, LM_BF16_RTOL,
        LM_BF16_RTOL)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 16: {out['phase_s']:.1f} s")
    return out


def lm_kernel_checks(torch, F, flash, dev, gen, put, dt):
    """Phase 2 for the LM lane at ``dt``: ``decode_attention`` against its
    plain version at the serving shape (its kernels-line row, through
    ``put``; at fp16 / bf16 the half cache also under a float32 q, as a
    float32 tree over a half cache runs it), at the kv_len edges, at
    a ragged long cache and at dbrx-132b's serving step (G = 6);
    ``flash_attention`` at the LM prefills' causal GQA shapes (Qwen3-4B's
    and dbrx-132b's, plain and mixed) and at Qwen3-4B's training shape
    (with the plain backward's ms).  At float32 also phase 24's
    shapes: decode at phi4-mini's, deepseek-7b's and whisper's steps,
    flash at ``FLASH_MM``.  Each held by :func:`agree`.  Returns the
    extra rows, keyed with ``_f16`` / ``_bf16`` at half."""
    from repro_torch.kernels.build import FLOAT_SUFFIX
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.configs.dbrx_132b import CONFIG as DBRX
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    H, KV, Dh = QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim
    f32 = dt == torch.float32
    suf, es = FLOAT_SUFFIX[dt], torch.finfo(dt).bits // 8
    products, attn_peak = (TF32_PRODUCTS, PEAK_TF32) if f32 else \
        (1, PEAK_HALF)
    tag = "" if f32 else f"_{suf}"
    extra = {}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def decode_case(name):
        """One of DECODE_SHAPES: checked, timed warm (relaunches: host
        clock and device time) and cold (rotating over caches that leave
        the L2), beside the plain version and SDPA."""
        (b, S, h, kv, dh), lens = DECODE_SHAPES[name]
        sets = cold_sets(2 * es * b * S * kv * dh)
        q = rnd(b, 1, h, dh)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = [[rnd(b, S, kv, dh) for _ in range(2)] for _ in range(sets)]
        cold = cold_us(torch, [
            lambda k=k, v=v: dec.decode_attention_cuda(q, k, v, kl)
            for k, v in caches], DEVICE_NAMES["decode_attention"])
        k, v = caches[0]
        del caches
        row = {"shape": [b, S, h, kv, dh], "kv_len": list(lens)}
        if not f32:
            q32 = q.float()
            row["f32_q_max_abs_err"], _ = agree(
                torch, f"decode_attention {name} {suf} cache, float32 q",
                dec.decode_attention_cuda(q32, k, v, kl),
                dec.decode_attention_plain(q32, k, v, kl), DECODE_TOL)
        err, eq = agree(torch, f"decode_attention {name} {suf}",
                        dec.decode_attention_cuda(q, k, v, kl),
                        dec.decode_attention_plain(q, k, v, kl), DECODE_TOL)
        k_ms = timed(torch, lambda: dec.KERNEL.relaunch(1))
        d_us = device_us(torch, lambda: dec.KERNEL.relaunch(1),
                         DEVICE_NAMES["decode_attention"])
        p_ms = timed(torch, lambda: dec.decode_attention_plain(q, k, v, kl))
        qt_, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(S, device=dev)[None] < kl[:, None])[:, None,
                                                                  None]
        l_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, attn_mask=mask, enable_gqa=True))
        keys = sum(min(x, S) for x in lens)       # the rows this run reads
        nbytes = es * (keys * kv * dh * 2 + 2 * q.numel()) + 4 * b
        b_ms, b_by = bound(nbytes, 4 * keys * h * dh, PEAK_FP32)
        n, kps = dec.plan(b, kv, h // kv, S, sms)
        row.update({"max_abs_err": err, "equal_frac": eq, "ms": k_ms,
                    "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "device_us": d_us, "cold_us": cold,
                    "cold_sets": sets, "splits": n, "keys_per_split": kps})
        say(f"  decode_attention {name} {suf}: {row}")
        return row

    # the kv_len edges: no key, one key, a split boundary, kv_len = S,
    # splits wholly past kv_len, G = 1 / 8 / 16, every head width
    errs = {}
    for (b, S, h, kv, dh), lens in DECODE_EDGES:
        q, k, v = rnd(b, 1, h, dh), rnd(b, S, kv, dh), rnd(b, S, kv, dh)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        errs[(b, S, h, kv, dh, *lens)], _ = agree(
            torch, f"decode_attention {suf} {(b, S, h, kv, dh)} kv_len "
            f"{lens}", dec.decode_attention_cuda(q, k, v, kl),
            dec.decode_attention_plain(q, k, v, kl), DECODE_TOL)
    say(f"  decode_attention {suf} kv_len edges, max errors: "
        f"{ {k: float(f'{e:.3g}') for k, e in errs.items()} }")
    for name in ("ragged", "zamba2", "dbrx") + (
            ("phi4", "deepseek7b", "whisper") if f32 else ()):
        extra[f"decode_attention_{name}{tag}"] = decode_case(name)
    r = decode_case("serving")
    put("decode_attention", *(r[key] for key in (
        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "device_us")), dt=dt, cold_us=r["cold_us"],
        splits=r["splits"], keys_per_split=r["keys_per_split"],
        equal_frac=r["equal_frac"],
        **{k: r[k] for k in ("f32_q_max_abs_err",) if k in r})

    def flash_case(name, b, T, S, h, kv, dh, causal, bwd=False):
        """flash at (b, T, S, h / kv, dh): checked, timed (relaunches:
        host clock and device time) beside the plain version and SDPA,
        bounded by its bytes or its (query, key) pairs' products; with
        ``bwd`` also the plain analytic backward's ms (the Function's, in
        float32, cast to the operands' type)."""
        q, k, v = rnd(b, T, h, dh), rnd(b, S, kv, dh), rnd(b, S, kv, dh)
        err, eq = agree(
            torch, f"flash_attention {suf} {name} {(b, T, S, h, kv, dh)} "
            f"causal={causal}", flash.flash_attention_cuda(q, k, v, causal),
            flash.flash_attention_plain(q, k, v, causal), ATTN_TOL)
        k_ms = timed(torch, lambda: flash.KERNEL.relaunch(1))
        d_us = device_us(torch, lambda: flash.KERNEL.relaunch(1),
                         trace_name("flash_attention", dt))
        p_ms = timed(torch, lambda: flash.flash_attention_plain(q, k, v,
                                                                causal))
        qt_, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, is_causal=causal, enable_gqa=True))
        pairs = (sum(min(t + 1, S) for t in range(T)) if causal
                 else T * S)                  # the (query, key) pairs seen
        b_ms, b_by = bound(es * (2 * q.numel() + 2 * k.numel()),
                           products * 4 * b * h * pairs * dh, attn_peak)
        row = {"shape": [b, T, S, h, kv, dh], "causal": causal,
               "max_abs_err": err, "equal_frac": eq, "ms": k_ms,
               "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
               "bound_by": b_by, "device_us": d_us}
        if bwd:
            g = rnd(b, T, h, dh)
            row["plain_bwd_ms"] = timed(
                torch, lambda: flash.flash_attention_bwd(q, k, v, g, causal))
        say(f"  flash_attention {suf} {name} {row}")
        return row

    # the LM prefills' causal GQA: Qwen3-4B (G = 4) and dbrx-132b (G = 6),
    # the plain prefill and the mixed one at 4 of 8 spans pooled; at
    # float32 also phase 24's shapes (FLASH_MM)
    for model, (h, kv) in (("", (H, KV)), ("dbrx_", (DBRX.n_heads,
                                                    DBRX.n_kv_heads))):
        for T in (LM_T, LM_T - 32):
            extra[f"flash_attention_{model}causal_T{T}{tag}"] = flash_case(
                f"{model}causal GQA", LM_B, T, T, h, kv, Dh, True)
    # Qwen3-4B's training shape (phase 16's steps at float32 and bf16),
    # with the plain backward's ms
    extra[f"flash_attention_train_T{LM_TRAIN_T}{tag}"] = flash_case(
        "train causal GQA", 1, LM_TRAIN_T, LM_TRAIN_T, H, KV, Dh, True,
        bwd=True)
    for name, shape in (FLASH_MM.items() if f32 else ()):
        extra[f"flash_attention_{name}"] = flash_case(name, *shape)
        torch.cuda.empty_cache()
    return extra


def ulp(torch, x):
    """One unit in the last place of ``x``'s half type at each |x| (its
    spacing there; the smallest subnormal's at 0), as float32."""
    p, tiny = {torch.float16: (11, 2.0 ** -24),
               torch.bfloat16: (8, 2.0 ** -133)}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


def ptxas_kernels(logs, frags):
    """(kernel, registers, (spill store bytes, spill load bytes)) of each
    kernel in the ``nvcc -Xptxas -v`` logs whose name holds one of
    ``frags``, its name demangled where ``c++filt`` is at hand."""
    out, fn, spills = [], None, (0, 0)
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and any(f in fn for f in frags):
                out.append((fn, int(m.group(1)), spills))
                fn = None
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            f for f, _, _ in out), capture_output=True, text=True,
            timeout=60).stdout.split("\n")
        out = [(n or f, r, sp) for n, (f, r, sp) in zip(names, out)]
    return out


def half_design(path, suf, half):
    """Phases 21 and 22: the fp16 / bf16 window and flash launches of a
    served path, each through its half design (the half entry points
    launch nothing else), and the operands their wrappers copied because
    the design's 16-byte loads refuse the view, read with the launch
    counts.  Prints one line and returns the counts."""
    from repro_torch.kernels import dispatch
    copies = dispatch.copy_counts()
    r = {k: {"launches": half[k], "view_copies": copies[k],
             "design": HALF_KERNELS[k][1]} for k in HALF_KERNELS}
    say(f"    half design at {suf} on {path}: " + "; ".join(
        f"{k} {v['launches']} launches ({v['design']}), {v['view_copies']} "
        f"view copies" for k, v in r.items()))
    return r


def half_close(torch, name, got, want, atol):
    """A half kernel against its plain version: every element within one
    ULP of the plain value (beyond ``atol``, the float32 kernel-vs-plain
    limit, which near zero exceeds a half ULP), at least HALF_EQUAL of
    them bit-equal.  Returns (largest difference, bit-equal share)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: {got.dtype} {tuple(got.shape)} against "
          f"{want.dtype} {tuple(want.shape)}")
    d = (got.float() - want.float()).abs()
    equal = float((got == want).float().mean())
    excess = float((d - ulp(torch, want) - atol).max())
    check(excess <= 0 and equal >= HALF_EQUAL and bool(
        torch.isfinite(got).all()), f"{name}: {excess} beyond one ULP + "
          f"{atol}, {equal:.5f} bit-equal (at least {HALF_EQUAL})")
    return float(d.max()), equal


def rate(name, ms, nbytes):
    """Print a byte-bound kernel's achieved rate and share of its bound."""
    say(f"  {name}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
        f"{nbytes / PEAK_BYTES * 1e3 / ms:.3f} of its byte bound")


def kernel_checks(torch, F, dev, gen, cfg, part, lay, arrays, lb, put, dt):
    """Phase 2 at one element type ``dt``: kernels 1-8 through their
    ``dt`` entry points at full width, each against its plain version on
    the same inputs and timed beside it and the library call (``put``).
    The data movement (pack, restore, the serving frame's pool, the
    upsample) and the int8 epilogue are bit-equal at every type; the
    rest is held by :func:`agree`.  Bounds count ``dt``'s bytes, and
    attention's operations as three TF32 products at float32 (3xTF32)
    or one half product at fp16 / bf16 (a product of two half values is
    exact in float32), each at its tensor-core peak.  Float32 also runs
    the multi-client layouts (phase 14's waves).  Returns the int8 GEMM
    rows and the LM-lane rows (:func:`lm_kernel_checks`)."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.fused_serving import ops as fused
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.mixed_res_pool import ops as pool
    from repro_torch.kernels.window_attention import ops as win
    from repro_torch.core import partition as pt
    from repro_torch.quant import qtensor as qt

    from repro_torch.kernels.build import FLOAT_SUFFIX

    f32 = dt == torch.float32
    suf, es = FLOAT_SUFFIX[dt], torch.finfo(dt).bits // 8
    products, attn_peak = (TF32_PRODUCTS, PEAK_TF32) if f32 else \
        (1, PEAK_HALF)
    nR, dd = part.n_regions, part.windows_per_full_region
    w2, D, H, Dh = part.window ** 2, cfg.d_model, cfg.n_heads, cfg.head_dim
    T = part.grid_h * part.grid_w
    say(f" at {suf}")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def uni(*shape):
        return torch.rand(shape, generator=gen, device=dev).to(dt)

    def same(name, got, want):
        check(torch.equal(got, want), f"{name} {suf}: kernel differs from "
              f"plain by up to {float((got.float() - want.float()).abs().max())}")

    def record(name, err, kernel, plain_fn, lib_fn, nbytes, nops,
               peak=PEAK_FP32, **extra):
        """Kernel alone (its latest launch relaunched), plain version and
        library call in ms, the bound, and the kernel's device us."""
        k_ms = timed(torch, lambda: kernel.relaunch(1))
        p_ms = timed(torch, plain_fn)
        l_ms = timed(torch, lib_fn) if lib_fn is not None else None
        d_us = device_us(torch, lambda: kernel.relaunch(1),
                         trace_name(name, dt))
        return put(name, err, k_ms, p_ms, l_ms, *bound(nbytes, nops, peak),
                   d_us, dt=dt, **extra)

    # avg_pool: its other paths first (4-byte copies where W * C, Wo * C
    # or the base is not 16-byte aligned, rows cut into chunks, wide
    # channels), then the raw frame, pooled before the low-resolution
    # embedding, which must match the plain version exactly
    for shape, d, off in POOL_CASES:
        xs = uni(int(np.prod(shape)) + off)[off:].view(shape)
        agree(torch, f"avg_pool {suf} {shape} d={d} offset {off}",
              pool.avg_pool_cuda(xs, d), pool.avg_pool_plain(xs, d), POOL_TOL)
    say(f"  avg_pool paths {POOL_CASES}: within {POOL_TOL}"
        + ("" if f32 else " and one ULP"))
    frames = [uni(B, *cfg.vit.img_size, 3) for _ in range(4)]
    x = frames[0]
    got = pool.avg_pool_cuda(x, 2)
    same("avg_pool: serving frame", got, pool.avg_pool_plain(x, 2))
    xc = x.permute(0, 3, 1, 2)
    cold = cold_us(torch, [lambda f=f: pool.avg_pool_cuda(f, 2)
                           for f in frames], DEVICE_NAMES["avg_pool"])
    pool.avg_pool_cuda(x, 2)                  # the row's relaunch is x's
    record("avg_pool", 0.0, pool.KERNEL, lambda: pool.avg_pool_plain(x, 2),
           lambda: F.avg_pool2d(xc, 2), es * (x.numel() + got.numel()),
           x.numel() + got.numel(), cold_us=cold)
    x1 = x[:1]                          # phase 13's single-client frame
    same("avg_pool: B=1 serving frame", pool.avg_pool_cuda(x1, 2),
         pool.avg_pool_plain(x1, 2))
    del frames, x, x1, xc

    # pack_pos: window bank + positional bank -> packed sequence
    nbank = nR * dd + nR
    bank, pos_bank = rnd(B, nbank, w2, D), rnd(nbank, w2, D)
    args = (bank, pos_bank, lay["win_src"], lay["nw"])
    got = fused.pack_pos_cuda(*args)
    same("pack_pos", got, fused.pack_pos_plain(*args))
    win_src, nw = arrays["win_src"], arrays["nw"]
    used = [set(win_src[b, :nw[b]].tolist()) for b in range(B)]
    win_bytes = es * w2 * D
    record("pack_pos", 0.0, fused.PACK_POS,
           lambda: fused.pack_pos_plain(*args), None,
           win_bytes * (sum(map(len, used)) + len(set().union(*used)))
           + es * got.numel() + 4 * (win_src.size + nw.size),
           int(nw.sum()) * w2 * D)

    # restore_gather: packed windows + REUSE tiles -> full-res sequence
    windows, tiles = rnd(B, lb, w2, D), rnd(B, nR, dd, w2, D)
    args = (windows, lay["out_src"], lay["out_map"], part.window,
            part.downsample, tiles)
    got = fused.restore_gather_cuda(*args)
    same("restore_gather", got, fused.restore_gather_plain(*args))
    out_src = arrays["out_src"]
    n_src = sum(len(set(out_src[b].tolist())) for b in range(B))
    record("restore_gather", 0.0, fused.RESTORE,
           lambda: fused.restore_gather_plain(*args), None,
           win_bytes * n_src + es * got.numel()
           + 4 * (out_src.size * 2 + (dd + 1) * w2), 0)

    # phase 13's single-client layouts (B = 1, twelve LOW regions, with
    # and without REUSE tiles spliced in), exact as above
    edges = pt.length_bucket_set(part)
    for one in single_plans(pt, nR):
        lb1 = pt.length_bucket(pt.plan_n_windows(one, part), edges)
        a1, _ = pt.stack_plan_layouts([pt.plan_layout(one.states, lb1,
                                                      part)])
        l1 = {k: torch.as_tensor(v, device=dev) for k, v in a1.items()}
        p_args = (bank[:1], pos_bank, l1["win_src"], l1["nw"])
        r_args = (rnd(1, lb1, w2, D), l1["out_src"], l1["out_map"],
                  part.window, part.downsample,
                  tiles[:1] if one.n_reuse else None)
        same(f"pack_pos at B=1, plan {one.states}",
             fused.pack_pos_cuda(*p_args), fused.pack_pos_plain(*p_args))
        same(f"restore_gather at B=1, plan {one.states}",
             fused.restore_gather_cuda(*r_args),
             fused.restore_gather_plain(*r_args))
    say(f"  pack_pos, restore_gather, avg_pool at B=1 (phase 13's "
        f"layouts, {len(single_plans(pt, nR))} plans): equal to plain")
    del bank, pos_bank, windows, tiles, got
    if f32:
        mc_kernel_checks(torch, pt, part, fused, pool, dev, gen, D,
                         cfg.vit.img_size)

    # window attention: column views of a fused QKV product, as the
    # blocks hand them over; the padded shape with win_valid first, then
    # the int8 lane's 15 heads (views of a 2880-wide fused QKV)
    def qkv_views(tokens, heads=H):
        qkv = rnd(B, tokens, 3 * heads * Dh)
        return [t.reshape(B, tokens, heads, Dh)
                for t in qkv.split(heads * Dh, dim=-1)]

    qp, kp, vp = qkv_views(lb * w2)
    err_p, _ = agree(torch, f"window_attention {suf} padded",
                     win.window_attention_cuda(qp, kp, vp, w2, lay["nw"]),
                     win.window_attention_plain(qp, kp, vp, w2, lay["nw"]),
                     ATTN_TOL)
    q15, k15, v15 = qkv_views(T, H - 1)
    err_15, _ = agree(torch, f"window_attention {suf} H=15",
                      win.window_attention_cuda(q15, k15, v15, w2),
                      win.window_attention_plain(q15, k15, v15, w2),
                      ATTN_TOL)
    rate(f"window_attention {suf} H=15",
         timed(torch, lambda: win.KERNEL.relaunch(1)),
         4 * es * B * T * (H - 1) * Dh)
    del qp, kp, vp, q15, k15, v15
    if not f32:
        unaligned_view(torch, f"window_attention {suf}", win, rnd,
                       (B, T, H, Dh), lambda f, a: f(*a, w2))
    q, k, v = qkv_views(T)
    err, eq = agree(torch, f"window_attention {suf}",
                    win.window_attention_cuda(q, k, v, w2),
                    win.window_attention_plain(q, k, v, w2), ATTN_TOL)
    say(f"  window_attention {suf} errors: padded {err_p:.3g}, H=15 "
        f"{err_15:.3g}, full-res {err:.3g}")
    qw, kw, vw = (t.reshape(B, T // w2, w2, H, Dh).permute(0, 1, 3, 2, 4)
                  .reshape(-1, H, w2, Dh).contiguous() for t in (q, k, v))
    nbytes = 4 * es * B * T * H * Dh
    r = record("window_attention", max(err, err_p, err_15), win.KERNEL,
               lambda: win.window_attention_plain(q, k, v, w2),
               lambda: F.scaled_dot_product_attention(qw, kw, vw), nbytes,
               products * 4 * B * (T // w2) * H * w2 * w2 * Dh, attn_peak,
               equal_frac=eq)
    rate(f"window_attention {suf}", r["ms"], nbytes)
    del qw, kw, vw

    # flash attention: the unmasked global blocks after restoration; a
    # causal GQA call and the extra cases first, each causal and not (the
    # kernel keeps both options)
    errs = {}
    for (fb, ft, fs, fh, fkv, fd) in ((1, 1000, 1000, H, 4, Dh),) \
            + FLASH_CASES:
        qs, ks, vs = rnd(fb, ft, fh, fd), rnd(fb, fs, fkv, fd), \
            rnd(fb, fs, fkv, fd)
        for causal in (True, False):
            key = (fb, ft, fs, fh, fkv, fd, causal)
            errs[key], _ = agree(
                torch, f"flash_attention {suf} {key}",
                flash.flash_attention_cuda(qs, ks, vs, causal=causal),
                flash.flash_attention_plain(qs, ks, vs, causal=causal),
                ATTN_TOL)
    say(f"  flash_attention {suf} max errors by (B, T, S, H, KV, Dh, "
        f"causal): { {k: float(f'{e:.3g}') for k, e in errs.items()} }")
    if not f32:
        unaligned_view(torch, f"flash_attention {suf}", flash, rnd,
                       (1, 1000, H, Dh), lambda f, a: f(*a, causal=True))
    err, eq = agree(torch, f"flash_attention {suf}",
                    flash.flash_attention_cuda(q, k, v),
                    flash.flash_attention_plain(q, k, v), ATTN_TOL)
    qf, kf, vf = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    record("flash_attention", max(err, *errs.values()), flash.KERNEL,
           lambda: flash.flash_attention_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(qf, kf, vf),
           4 * es * B * T * H * Dh, products * 4 * B * H * T * T * Dh,
           attn_peak, equal_frac=eq)
    del q, k, v, qf, kf, vf
    torch.cuda.empty_cache()
    lm_kernels = lm_kernel_checks(torch, F, flash, dev, gen, put, dt)

    # nn_upsample: the LOW windows of a beta-0 wave, (B * nR, w, w, D)
    x = rnd(B * nR, part.window, part.window, D)
    got = pool.nn_upsample_cuda(x, 2)
    same("nn_upsample", got, pool.nn_upsample_plain(x, 2))
    xc = x.permute(0, 3, 1, 2)
    record("nn_upsample", 0.0, pool.UPSAMPLE,
           lambda: pool.nn_upsample_plain(x, 2),
           lambda: F.interpolate(xc, scale_factor=2, mode="nearest"),
           es * (x.numel() + got.numel()), 0)
    del x, xc, got

    # int8_matmul: the quantized model's GEMMs, bit-equal, out_dtype dt;
    # then a ragged shape that masks M, N and K
    gemm = gemm_checks(torch, i8, qt, dev, gen, cfg.n_layers, dt)
    by = {b: sum(r["bound_ms"] for r in gemm if r["bound_by"] == b)
          for b in ("bytes", "operations")}
    put("int8_matmul", 0.0, *(sum(r[k] for r in gemm)
                              for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")),
        max(by, key=by.get), sum(r["device_us"] for r in gemm), dt=dt)
    return gemm, lm_kernels


def trace_name(name, dt):
    """The fragment of a kernel's name in a trace: at fp16 / bf16 the half
    design's own kernel for window and flash attention, so that a phase-2
    device time of 0 (checked by ``device_us``) would show that a half
    launch took some other kernel."""
    if dt.itemsize == 2 and name in HALF_KERNELS:
        return HALF_KERNELS[name][0]
    return DEVICE_NAMES[name]


def unaligned_view(torch, name, ops, rnd, shape, call):
    """A half attention kernel on q, k and v whose base lies 2 bytes off
    16 (views of one flat buffer): the wrapper copies each (three copies
    counted on the kernel) and the result holds to the plain version."""
    n = int(np.prod(shape))
    flat = rnd(3 * n + 1)[1:]
    qkv = [t.view(shape) for t in flat.split(n)]
    before = ops.KERNEL.copies
    prefix = name.split()[0]
    err, eq = agree(torch, f"{name} unaligned view",
                    call(getattr(ops, f"{prefix}_cuda"), qkv),
                    call(getattr(ops, f"{prefix}_plain"), qkv), ATTN_TOL)
    check(ops.KERNEL.copies - before == 3, f"{name} unaligned view: "
          f"{ops.KERNEL.copies - before} copies counted, want 3")
    say(f"  {name} unaligned view {shape}: max error {err:.3g}, "
        f"{eq:.5f} bit-equal; 3 copies counted")


def agree(torch, name, got, want, tol):
    """A kernel against its plain version on the same inputs: at float32
    every element within ``tol``; at fp16 / bf16 by :func:`half_close`.
    Returns (largest difference, bit-equal share)."""
    if got.dtype != torch.float32:
        return half_close(torch, name, got, want, tol)
    err = float((got - want).abs().max())
    check(want.dtype == torch.float32 and err <= tol,
          f"{name}: max error {err} > {tol}")
    return err, float((got == want).float().mean())


def _marked(torch, fn, name):
    """``fn`` run inside a ``record_function`` range named ``name``."""
    def run(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return run


def mark_engine(torch, eng):
    """Run every prefill and decode key of ``eng`` inside ``lm_prefill``
    / ``lm_decode`` ranges, which ``profile_lm`` reads."""
    for fns, name in ((eng._prefill_fns, "lm_prefill"),
                      (eng._decode_fns, "lm_decode")):
        for key in list(fns):
            fns[key] = _marked(torch, fns[key], name)


def serve_lm(torch, cfg, dev):
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request

    say(f"phase 7: ServeEngine, {cfg.name} {cfg.n_layers} layers D="
        f"{cfg.d_model} GQA {cfg.n_heads}/{cfg.n_kv_heads} Dh="
        f"{cfg.head_dim}, waves of {LM_B} x {LM_T} + {LM_NEW} tokens")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(params))
    say(f"  init {n_params} parameters ({4 * n_params} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=LM_B, max_len=LM_MAX_LEN, buckets=(LM_T,),
        device=str(dev)))
    n_spans = LM_T // (cfg.mixed_res.window * cfg.mixed_res.downsample)
    mask = np.zeros(n_spans, np.int32)
    mask[:n_spans // 2] = 1
    n_keys = eng.warmup(plan_space=[(n_spans // 2, 0, BETA)])
    say(f"  warmup of {n_keys} keys {eng.stats.warmup_wall_s:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    steps = LM_NEW - 1                      # the first token is prefill's
    out = {"B": LM_B, "T": LM_T, "new": LM_NEW, "beta": BETA,
           "n_params": n_params, "warmup_keys": n_keys,
           "warmup_s": eng.stats.warmup_wall_s}
    launches_total = dict.fromkeys(dispatch.KERNELS, 0)

    def wave(mixed):
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=LM_NEW,
                               low_span_mask=mask if mixed else None,
                               beta=BETA if mixed else 0))
        t = time.perf_counter()
        resp = eng.run()
        wall = time.perf_counter() - t
        check(len(resp) == LM_B and all(r.n_tokens == LM_NEW for r in resp),
              f"LM wave: {[r.n_tokens for r in resp]} tokens, want "
              f"{LM_NEW} each")
        check(all(0 <= x < cfg.vocab_size for r in resp for x in r.tokens),
              "LM wave: token out of the vocabulary")
        return wall, [r.tokens for r in resp]

    for kind, mixed in (("plain", False), ("mixed", True)):
        dispatch.reset_launch_counts()      # the LM path starts here
        first, tokens = wave(mixed)
        launches = dispatch.launch_counts()  # ... and ends here
        say(f"  {kind} wave launches {json.dumps(launches)}")
        check(launches["flash_attention"] == cfg.n_layers,
              f"{kind}: flash launched {launches['flash_attention']} times, "
              f"want {cfg.n_layers} (one prefill)")
        check(launches["decode_attention"] == cfg.n_layers * steps,
              f"{kind}: decode launched {launches['decode_attention']} "
              f"times, want {cfg.n_layers} x {steps}")
        for name, n in launches.items():
            launches_total[name] += n
        walls = [wave(mixed)[0] for _ in range(3)]
        rec = {"first_s": first, "median_s": statistics.median(walls),
               "launches": launches, "tokens": tokens}
        rec["tokens_per_s"] = LM_B * LM_NEW / rec["median_s"]
        rec.update(lm_phase_times(torch, eng, cfg, prompts, mask, mixed))
        out[kind] = rec
        say(f"  {kind} wave: first {first:.4f} s, median {rec['median_s']:.4f}"
            f" s, {rec['tokens_per_s']:.1f} tok/s; prefill "
            f"{rec['prefill_ms']:.3f} ms, decode {rec['decode_step_ms']:.3f} "
            f"ms/step")
    check(eng.stats.steady_compiles == 0,
          f"LM steady-state first uses: {eng.stats.steady_compile_keys}")
    out["steady_compiles"] = eng.stats.steady_compiles

    # trace one wave of each kind, prefill and decode steps marked
    mark_engine(torch, eng)
    for kind, mixed in (("plain", False), ("mixed", True)):
        out[kind]["profile"] = profile_lm(
            torch, f"lm_{kind}", lambda: wave(mixed), out[kind]["median_s"])
    check(eng.stats.steady_compiles == 0, "LM: steady-state first uses")
    del eng, params
    torch.cuda.empty_cache()
    return launches_total, out


def tree_tensors(tree):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_tensors(v)
    else:
        yield tree


def lm_phase_times(torch, eng, cfg, prompts, mask, mixed, new=LM_NEW):
    """Host clock, synchronised, around the engine's own prefill of the
    wave's key and around its ``new - 1`` decode steps, each read back to
    the host as the engine reads it (median of three)."""
    T, B = len(prompts[0]), len(prompts)
    toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                           device=eng.device)
    n_pool = int(mask.sum()) if mixed else 0
    beta = BETA if mixed else 0
    fn = eng._get_prefill(T, n_pool, beta, B)
    pack = eng._pack_for(T, n_pool, 0, mask) if mixed else None
    pre, dec = [], []
    with torch.no_grad():
        for _ in range(3):
            state = eng._state(B)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, state = (fn(toks, state, pack) if mixed
                             else fn(toks, state))
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            decode = eng._get_decode(B)
            t = time.perf_counter()
            for step in range(1, new):
                logits, state = decode(tok, T + step - 1, state)
                tok = logits[:, -1].argmax(-1, keepdim=True)
                tok.cpu()
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t) / (new - 1))
    return {"prefill_ms": statistics.median(pre) * 1e3,
            "decode_step_ms": statistics.median(dec) * 1e3}


def profile_lm(torch, name, run_wave, wall_s, steps=LM_NEW - 1):
    """Trace one LM wave: device time by kernel family, and the device's
    busy share inside the prefill (from its first kernel to its last) and
    across the decode steps (from the first step's first kernel to the
    last step's last), where host launch overhead shows as idle gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_wave()
    (OUT_DIR / f"profile_{name}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {m: sorted((e.time_range.start, e.time_range.end) for e in dev
                       if e.name == m) for m in ("lm_prefill", "lm_decode")}
    check(len(spans["lm_prefill"]) == 1
          and len(spans["lm_decode"]) == steps,
          f"profile {name}: {len(spans['lm_prefill'])} prefill and "
          f"{len(spans['lm_decode'])} decode spans")
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in dev if e.name not in spans
                     and not getattr(e, "is_user_annotation", False)
                     and e.time_range.elapsed_us() > 0)
    fam: dict = {}
    for s, e, n in kernels:
        key = next((f for frag, f in FAMILIES if frag in n), "other")
        fam[key] = fam.get(key, 0.0) + (e - s) / 1e3
    busy = sum(fam.values())
    check(busy > 0, f"profile {name}: no device time traced")

    def share(lo, hi):
        """Kernel time inside [lo, hi) over its length (one stream)."""
        t = sum(max(0, min(e, hi) - max(s, lo)) for s, e, _ in kernels)
        return t / max(hi - lo, 1), (hi - lo) / 1e3

    p_lo, p_hi = spans["lm_prefill"][0]
    d_lo, d_hi = spans["lm_decode"][0][0], spans["lm_decode"][-1][1]
    p_share, p_ms = share(p_lo, p_hi)
    d_share, d_ms = share(d_lo, d_hi)
    per_step = sum(d_lo <= s < d_hi for s, _, _ in kernels) / steps
    out = {"device_ms": busy, "busy_share": busy / (wall_s * 1e3),
           "prefill_window_ms": p_ms, "prefill_busy_share": p_share,
           "decode_window_ms": d_ms, "decode_busy_share": d_share,
           "kernels_per_decode_step": per_step,
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1]))}
    say(f"  profile {name}: device {busy:.2f} ms of {wall_s * 1e3:.2f} ms "
        f"wall (busy {out['busy_share']:.3f}); prefill window {p_ms:.2f} ms "
        f"busy {p_share:.3f}; decode window {d_ms:.2f} ms busy "
        f"{d_share:.3f}, {per_step:.0f} kernels a step; " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
    return out


def lm_cross_check(torch, cfg, dev, phase=8, T=LM_T, dtype=None,
                   rtol=LM_RTOL):
    """A few layers of a full-width LM on the card and, through the plain
    versions, on the CPU: prefill logits and 8 teacher-forced decode
    steps, each to ``rtol`` of its largest magnitude.  A dense model runs
    plain and mixed at beta 2; an SSM model also compares the hidden
    states of ``mixed_forward_ssm`` at beta 2 (half the spans pooled).
    ``dtype`` casts the tree (``qtensor.cast_tree``) first."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.offload.simulator import to_device
    say(f"phase {phase}: {cfg.n_layers}-layer full-width {cfg.name}, card "
        f"vs CPU")
    torch.set_num_threads(os.cpu_count() or 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    p_gpu = registry.init_params(cfg, gen, device=dev)
    if dtype is not None:
        from repro_torch.quant import qtensor as qt
        p_gpu = qt.cast_tree(p_gpu, dtype)
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    B, n_dec = 2, 8
    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T + n_dec)))
    part = smr.seq_partition(cfg, T)
    mask = np.zeros(part.n_spans, np.int32)
    mask[:part.n_spans // 2] = 1
    pack = smr.build_seq_pack(mask, int(mask.sum()), part)
    worst = {}

    def run(device, params, mixed):
        state = registry.init_decode_state(cfg, B, T + n_dec, device=device)
        with torch.no_grad():
            x = toks[:, :T].to(device)
            if mixed:
                pk = {k: torch.as_tensor(v.astype(np.int64), device=device)
                      for k, v in pack.items()}
                h, state, _ = smr.mixed_prefill(cfg, params, x, pk, BETA,
                                                state)
            else:
                h, state, _ = registry.prefill(cfg, params, {"tokens": x},
                                               state)
            out = [tfm.logits_from_hidden(cfg, params, h[:, -1:])]
            for i in range(n_dec):
                lg, state = registry.decode_step(
                    cfg, params, toks[:, T + i:T + i + 1].to(device), T + i,
                    state)
                out.append(lg)
        return [o.float().cpu() for o in out]

    kinds = ((("plain", False), ("mixed", True)) if cfg.family == "dense"
             else (("plain", False),))
    for kind, mixed in kinds:
        t0 = time.perf_counter()
        got = run(dev, p_gpu, mixed)
        want = run("cpu", p_cpu, mixed)
        rel = [float((g - c).abs().max() / c.abs().max())
               for g, c in zip(got, want)]
        check(all(np.isfinite(rel)), f"{kind}: non-finite logits")
        worst[kind] = {"prefill": rel[0], "decode_max": max(rel[1:])}
        say(f"  {kind}: prefill logits max relative error {rel[0]:.3g}, "
            f"{n_dec} decode steps max {max(rel[1:]):.3g} (limit {rtol}); "
            f"{time.perf_counter() - t0:.1f} s")
        check(max(rel) <= rtol, f"{kind}: card vs CPU {max(rel)} > {rtol}")
    if cfg.family == "ssm":
        pk = {k: torch.as_tensor(v.astype(np.int64)) for k, v in pack.items()}
        with torch.no_grad():
            got, want = (smr.mixed_forward_ssm(
                cfg, params, toks[:, :T].to(device),
                {k: v.to(device) for k, v in pk.items()}, BETA)[0].cpu()
                for device, params in ((dev, p_gpu), ("cpu", p_cpu)))
        rel = float((got - want).abs().max() / want.abs().max())
        check(np.isfinite(rel) and rel <= LM_RTOL,
              f"mixed_forward_ssm: card vs CPU {rel} > {LM_RTOL}")
        worst["mixed_forward_ssm"] = rel
        say(f"  mixed_forward_ssm beta {BETA}: hidden max relative error "
            f"{rel:.3g} (limit {LM_RTOL})")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# the Mamba-2 serving lane (mamba2-370m and zamba2-1.2b through ServeEngine)


def serve_ssm(torch, cfg, dev, phase):
    """Phases 10 and 11: serve a full-width SSM or hybrid LM (weights from
    a seed) through ``ServeEngine``: warm up, then plain waves of SSM_B
    requests x SSM_T prompt tokens x SSM_NEW new tokens.  Every request
    must get SSM_NEW tokens; a wave launches ``ssd_scan`` once per mamba
    layer (one prefill) and, for the hybrid, ``flash_attention`` once per
    shared call and ``decode_attention`` once per shared call and decode
    step; no key may first run after warmup.  Wall time (median of
    three), prefill and decode-step times, one traced wave.  For the SSM
    LM also one ``mixed_forward_ssm`` at beta 2 with half the spans
    pooled beside the plain ``prefill``, both timed."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.kernels import dispatch
    from repro_torch.models import hybrid as hyb
    from repro_torch.models import registry, ssm_lm
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request

    calls = hyb.n_shared_calls(cfg) if cfg.family == "hybrid" else 0
    steps = SSM_NEW - 1
    say(f"phase {phase}: ServeEngine, {cfg.name} ({cfg.family}) "
        f"{cfg.n_layers} mamba layers D={cfg.d_model} N={cfg.ssm.d_state}"
        f"{f', {calls} shared attention calls' if calls else ''}, waves of "
        f"{SSM_B} x {SSM_T} + {SSM_NEW} tokens")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(params))
    say(f"  init {n_params} parameters ({4 * n_params} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=SSM_B, max_len=SSM_T + SSM_NEW, buckets=(SSM_T,),
        device=str(dev)))
    n_keys = eng.warmup()
    say(f"  warmup of {n_keys} keys {eng.stats.warmup_wall_s:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, SSM_T).astype(np.int32)
               for _ in range(SSM_B)]
    want = {"ssd_scan": cfg.n_layers, "flash_attention": calls,
            "decode_attention": calls * steps}

    def wave():
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=SSM_NEW))
        t = time.perf_counter()
        resp = eng.run()
        wall = time.perf_counter() - t
        check(len(resp) == SSM_B and all(r.n_tokens == SSM_NEW
                                         for r in resp),
              f"{cfg.name} wave: {[r.n_tokens for r in resp]} tokens, want "
              f"{SSM_NEW} each")
        check(all(0 <= x < cfg.vocab_size for r in resp for x in r.tokens),
              f"{cfg.name} wave: token out of the vocabulary")
        return wall, [r.tokens for r in resp]

    dispatch.reset_launch_counts()          # the SSM path starts here
    first, tokens = wave()
    launches = dispatch.launch_counts()     # ... and ends here
    say(f"  launches {json.dumps(launches)}")
    for name, n in want.items():
        check(launches[name] == n, f"{cfg.name}: {name} launched "
              f"{launches[name]} times, want {n}")
    walls = [wave()[0] for _ in range(3)]
    out = {"B": SSM_B, "T": SSM_T, "new": SSM_NEW, "n_params": n_params,
           "warmup_keys": n_keys, "warmup_s": eng.stats.warmup_wall_s,
           "first_s": first, "median_s": statistics.median(walls),
           "launches": launches, "tokens_0": tokens[0]}
    out["tokens_per_s"] = SSM_B * SSM_NEW / out["median_s"]
    out.update(lm_phase_times(torch, eng, cfg, prompts, None, False,
                              new=SSM_NEW))
    say(f"  wave: first {first:.4f} s, median {out['median_s']:.4f} s, "
        f"{out['tokens_per_s']:.1f} tok/s; prefill {out['prefill_ms']:.3f} "
        f"ms, decode {out['decode_step_ms']:.3f} ms/step")
    check(eng.stats.steady_compiles == 0,
          f"{cfg.name} steady-state first uses: "
          f"{eng.stats.steady_compile_keys}")
    out["steady_compiles"] = eng.stats.steady_compiles
    mark_engine(torch, eng)
    out["profile"] = profile_lm(torch, cfg.name, wave, out["median_s"],
                                steps=steps)
    check(eng.stats.steady_compiles == 0, f"{cfg.name}: steady first uses")

    if cfg.family == "ssm":
        part = smr.seq_partition(cfg, SSM_T)
        mask = np.zeros(part.n_spans, np.int32)
        mask[::2] = 1
        n_low = int(mask.sum())
        pack = {k: torch.as_tensor(v.astype(np.int64), device=dev)
                for k, v in smr.build_seq_pack(mask, n_low, part).items()}
        toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                               device=dev)
        states = hyb.init_stacked_states(cfg, SSM_B, device=dev)

        def fwd(mixed):
            with torch.no_grad():
                if mixed:
                    return smr.mixed_forward_ssm(cfg, params, toks, pack,
                                                 BETA)[0]
                return ssm_lm.prefill(cfg, params, toks, states)[0]

        dispatch.reset_launch_counts()      # the mixed forward starts here
        h = fwd(True)
        n_scan = dispatch.launch_counts()["ssd_scan"]   # ... and ends here
        check(n_scan == cfg.n_layers, f"mixed_forward_ssm launched ssd_scan "
              f"{n_scan} times, want {cfg.n_layers}")
        check(tuple(h.shape) == (SSM_B, SSM_T, cfg.d_model)
              and bool(torch.isfinite(h).all()),
              "mixed_forward_ssm: wrong shape or non-finite")

        def ms(mixed):
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fwd(mixed)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            return statistics.median(ts) * 1e3

        out["mixed_forward_ssm"] = {
            "beta": BETA, "n_low": n_low, "T_mix": part.n_tokens(n_low),
            "layers_pooled": smr.layers_before_rp(cfg, BETA, cfg.n_layers),
            "ssd_scan_launches": n_scan, "plain_ms": ms(False),
            "mixed_ms": ms(True)}
        say(f"  mixed_forward_ssm: {out['mixed_forward_ssm']}")
    del eng, params
    torch.cuda.empty_cache()
    return launches, out


def ssd_inputs(torch, cfg, dev, gen, b, T, groups=None):
    """Scan inputs shaped as a mamba layer hands them over: x, B and C are
    column views of one silu'd (b, T, conv_ch) conv output; dt is
    softplus(N(0, 1) + dt_bias) with the init's dt_bias (a log-uniform dt
    in [dt_min, dt_max]); A = -(1..H)."""
    import torch.nn.functional as F
    from repro_torch.models import mamba2 as m2
    s = cfg.ssm
    G = groups or s.n_groups
    d_inner, H, _ = m2.ssm_dims(cfg)
    N, P = s.d_state, s.head_dim
    xbc = F.silu(torch.randn((b, T, d_inner + 2 * G * N), generator=gen,
                             device=dev))
    xs, Bm, Cm = xbc.split((d_inner, G * N, G * N), dim=-1)
    u = torch.rand((H,), generator=gen, device=dev)
    dt0 = torch.exp(u * (np.log(s.dt_max) - np.log(s.dt_min))
                    + np.log(s.dt_min))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn((b, T, H), generator=gen, device=dev) + bias)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    return (xs.reshape(b, T, H, P), dt, A, Bm.reshape(b, T, G, N),
            Cm.reshape(b, T, G, N))


def ssd_cost(b, T, H, G, N, P, chunk, init_state=False):
    """Bytes (each input read once, each output written once) and the
    float32 operations the chunked form needs, for this call's chunks (the
    last one may be short): the C_i.B_j scores over the lower triangle
    once per B/C group (they do not depend on the head); per head the
    masked-decay product with xbar, the state update and, where the state
    coming in is not zero (every chunk but the first without
    ``init_state``), the C_i.S term."""
    chunk = min(chunk, T)
    nbytes = 4 * (2 * b * T * H * P + b * T * H + H + 2 * b * T * G * N
                  + b * H * N * P)
    ops = 0
    for t0 in range(0, T, chunk):
        q = min(chunk, T - t0)
        carried = 2 * q * N * P if (t0 or init_state) else 0
        ops += b * G * N * q * (q + 1) \
            + b * H * (P * q * (q + 1) + 2 * q * N * P + carried)
    return nbytes, ops


TRACE_TRIES = 5   # traces kernel_breakdown takes before a kernel is untraced


def kernel_breakdown(torch, fn, names, n=20):
    """Device microseconds per call of ``fn`` spent in each kernel whose
    name holds one of ``names`` (a trace of ``n`` calls).  CUPTI now and
    then returns a trace that lacks the device activity of a kernel that
    did run (the launches are counted and checked elsewhere), so a trace
    in which a kernel reads 0 is taken again, up to TRACE_TRIES traces,
    each of twice the calls of the one before (a short trace is the one
    CUPTI loses whole); the check fails only if no trace sees every
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_TRIES + 1):
        calls = n << (attempt - 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(names, 0.0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = next((k for k in names if k in e.name), None)
                if key is not None:         # "" matches every kernel
                    us[key] += e.time_range.elapsed_us() / calls
        if all(us.values()):
            return us
        seen = sorted({e.name[:60] for e in prof.events()
                       if e.device_type == DeviceType.CUDA})
        say(f"  kernel_breakdown: trace {attempt} of {TRACE_TRIES} lacks "
            f"device time in {us}; its device events: {seen[:8]}")
    check(False, f"kernel_breakdown: untraced kernels in {us} after "
          f"{TRACE_TRIES} traces")


# ---------------------------------------------------------------------------
# the exact-shape mixed-resolution lane (phase 17)


def exact_plans(pt, nR):
    """Two clients' plans for the exact lane: 8 of the 16 regions LOW
    (other regions each), and the same with 4 of the FULL regions
    REUSE."""
    low = (np.zeros(nR, np.int8), np.zeros(nR, np.int8))
    low[0][[0, 2, 5, 7, 8, 10, 13, 15]] = pt.LOW
    low[1][[1, 3, 4, 6, 9, 11, 12, 14]] = pt.LOW
    reuse = (low[0].copy(), low[1].copy())
    reuse[0][[1, 3, 4, 6]] = pt.REUSE
    reuse[1][[0, 2, 5, 7]] = pt.REUSE
    return ([pt.RegionPlan(s) for s in low],
            [pt.RegionPlan(s) for s in reuse])


def lane_inputs(torch, pt, part, plans, dev):
    """Per-sample exact-lane ids and the padded lane's layout of the same
    plans (at their length bucket)."""
    n_low, n_reuse = plans[0].n_low, plans[0].n_reuse
    ids = [torch.as_tensor(a, device=dev)
           for a in pt.stack_plan_ids(plans, n_low, n_reuse)]
    lb = pt.length_bucket(part.n_windows(n_low, n_reuse),
                          pt.length_bucket_set(part))
    arrays, _ = pt.stack_plan_layouts([pt.plan_layout(p.states, lb, part)
                                       for p in plans])
    return ids, {k: torch.as_tensor(v, device=dev)
                 for k, v in arrays.items()}, lb


def rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def exact_lane(torch, cfg, dev, count):
    """Phase 17: ``forward_features`` / ``forward_det`` on region ids at
    full width, B = 2: beta 0..4 with 8 of 16 regions LOW, then 4 REUSE
    regions at beta 2 spliced from tiles a full-resolution forward
    captured; the four kernels of the lane must launch.  Each beta's
    features (and the REUSE forward's tiles) against the padded lane on
    the card, and an 8-block model card vs CPU, to E2E_RTOL; a wave's
    ms (``forward_det``, CUDA events) in each lane at each beta."""
    from repro_torch import convert
    from repro_torch.core import partition as pt
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import dispatch

    t_phase = time.perf_counter()
    part = vb.vit_partition(cfg)
    nR, N = part.n_regions, cfg.vit.n_subsets
    low_plans, reuse_plans = exact_plans(pt, nR)
    say(f"phase 17: the exact-shape mixed-resolution lane, {cfg.name} "
        f"{cfg.n_layers} blocks D={cfg.d_model}, B={B}, {low_plans[0].n_low}"
        f" of {nR} regions LOW (T = {part.n_tokens(low_plans[0].n_low)}), "
        f"beta 0..{N}; {reuse_plans[0].n_reuse} REUSE at beta {BETA}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    img = torch.rand((B, *cfg.vit.img_size, 3), generator=gen, device=dev)
    prev = torch.rand((B, *cfg.vit.img_size, 3), generator=gen, device=dev)
    (fi, li, _), layout, lb = lane_inputs(torch, pt, part, low_plans, dev)
    (rfi, rli, rri), rlayout, rlb = lane_inputs(torch, pt, part, reuse_plans,
                                                dev)
    rows = torch.arange(B, device=dev)[:, None]
    with torch.no_grad():
        _, captured = vb.forward_features(cfg, params, prev,
                                          capture_beta=BETA)
        tiles = captured[rows, rri.long()]
        tiles_pad = torch.zeros_like(captured)
        tiles_pad[:, :rri.shape[1]] = tiles

        def exact(beta, **kw):
            return vb.forward_features(cfg, params, img, fi, li, beta, **kw)

        def spliced():
            return vb.forward_features(cfg, params, img, rfi, rli, BETA,
                                       reuse_ids=rri, reuse_tiles=tiles,
                                       capture_beta=BETA)

        dispatch.reset_launch_counts()      # the exact lane starts here
        feats = {beta: exact(beta) for beta in range(N + 1)}
        reuse_out = spliced()
        launches = dispatch.launch_counts()  # ... and ends here
        count("vitdet-l exact", launches)
        say(f"  launches {json.dumps(launches)}")
        check(all(launches[k] > 0 for k in BETA0_PATH),
              f"a kernel of the exact lane never launched: {launches}")
        check(launches["pack_pos"] == 0 and launches["restore_gather"] == 0,
              "the exact lane ran the padded lane's kernels")
        out = {"B": B, "n_low": low_plans[0].n_low, "length_bucket": lb,
               "launches": {k: v for k, v in launches.items() if v},
               "betas": {}}
        for beta in range(N + 1):
            f = feats[beta]
            check(bool(torch.isfinite(f).all()),
                  f"beta {beta}: non-finite features")
            pad = vb.forward_features(cfg, params, img, beta=beta,
                                      layout=layout)
            err = rel_max(f, pad)
            e_ms = timed(torch, lambda: vb.forward_det(
                cfg, params, img, fi, li, beta), target_ms=300)
            p_ms = timed(torch, lambda: vb.forward_det(
                cfg, params, img, beta=beta, layout=layout), target_ms=300)
            out["betas"][beta] = {"exact_ms": e_ms, "padded_ms": p_ms,
                                  "vs_padded_rel": err}
            say(f"  beta {beta}: wave {e_ms:.3f} ms exact (T = "
                f"{part.n_tokens(low_plans[0].n_low)} before restoring), "
                f"{p_ms:.3f} ms padded (bucket {lb} windows); features vs "
                f"the padded lane max relative error {err:.3g} (limit "
                f"{E2E_RTOL})")
            check(err <= E2E_RTOL, f"beta {beta}: exact vs padded {err}")
        del feats
        pad_f, pad_t = vb.forward_features(
            cfg, params, img, beta=BETA, layout=rlayout,
            reuse_tiles=tiles_pad, capture_beta=BETA)
        errs = (rel_max(reuse_out[0], pad_f), rel_max(reuse_out[1], pad_t))
        say(f"  REUSE at beta {BETA} (bucket {rlb}): features / tiles vs the "
            f"padded lane max relative error {errs[0]:.3g} / {errs[1]:.3g} "
            f"(limit {E2E_RTOL})")
        check(max(errs) <= E2E_RTOL, f"REUSE wave: exact vs padded {errs}")
        out["reuse_vs_padded_rel"] = errs
        del params, captured, tiles_pad, reuse_out, pad_f, pad_t
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = exact_lane_cpu(torch, cfg.replace(n_layers=8), dev,
                                        low_plans, reuse_plans)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 17: {out['phase_s']:.1f} s")
    return out


def exact_lane_cpu(torch, cfg, dev, low_plans, reuse_plans):
    """Sample 0 of phase 17's plans through an 8-block full-width model on
    the card and, through the plain versions, on the CPU: beta 0 and the
    REUSE wave at beta 2 (tiles captured on the card), to E2E_RTOL."""
    from repro_torch import convert
    from repro_torch.core import partition as pt
    from repro_torch.core import vit_backbone as vb
    from repro_torch.offload.simulator import to_device

    torch.set_num_threads(os.cpu_count() or 1)
    part = vb.vit_partition(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    p_gpu = convert.init_vitdet_params(cfg, gen, device=dev)
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    img = torch.rand((1, *cfg.vit.img_size, 3), generator=gen, device=dev)
    out = {}
    with torch.no_grad():
        _, captured = vb.forward_features(cfg, p_gpu, img, capture_beta=BETA)
        for name, plan, beta in (("beta 0", low_plans[0], 0),
                                 (f"REUSE beta {BETA}", reuse_plans[0],
                                  BETA)):
            fi, li, ri = pt.plan_to_region_ids(plan.states, plan.n_low,
                                               plan.n_reuse)
            kw = {}
            if plan.n_reuse:
                kw = dict(reuse_ids=ri, capture_beta=beta,
                          reuse_tiles=captured[:, torch.as_tensor(
                              ri, dtype=torch.long, device=dev)])
            t0 = time.perf_counter()
            got = vb.forward_features(cfg, p_gpu, img, fi, li, beta, **kw)
            kw = {k: (v.cpu() if torch.is_tensor(v) else v)
                  for k, v in kw.items()}
            want = vb.forward_features(cfg, p_cpu, img.cpu(), fi, li, beta,
                                       **kw)
            got, want = ((got, want) if plan.n_reuse
                         else ((got,), (want,)))
            errs = [rel_max(g.cpu(), w) for g, w in zip(got, want)]
            out[name] = errs
            say(f"  {cfg.n_layers}-block card vs CPU, {name}: features"
                + (" / tiles" if len(errs) > 1 else "")
                + " max relative error " + " / ".join(f"{e:.3g}"
                                                     for e in errs)
                + f" (limit {E2E_RTOL}); {time.perf_counter() - t0:.1f} s")
            check(max(errs) <= E2E_RTOL, f"{name}: card vs CPU {errs}")
    del p_gpu, p_cpu, captured
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the host-resident tile cache (phase 18, on phase 13's server)


def host_cache_runs(torch, srv, lo, clips, trace, size_e, acc_e, inf_delay,
                    count, tag="", phase="18 (on phase 13's server)"):
    """Phase 18: ViTMAlis+Reuse on parkS with the server's FeatureCache
    host-resident (``device_cache=False``) and device-resident: the same
    offloads with equal detections, tile bytes an offload above 0 in host
    mode and 0 in device mode, and the server's ms an offload in each.
    ``tag`` names a half server's runs (phase 21)."""
    from repro_torch.kernels import dispatch
    policy, video = "ViTMAlis+Reuse", "parkS"
    say(f"phase {phase}: {policy} on {video}, "
        f"{OFFLOAD_FRAMES} frames, FeatureCache host-resident and "
        f"device-resident")
    frames, gt = clips[video]
    part, patch = srv.part, srv.cfg.vit.patch_size
    out, jobs = {}, {}
    for mode, flag in (("host", False), ("device", True)):
        srv.device_cache = flag
        pol = lo.make_policy(policy, size_e, acc_e, part, inf_delay)
        st = srv.stats
        before = (st.tile_bytes_d2h, st.tile_bytes_h2d, st.offloads)
        dispatch.reset_launch_counts()      # this simulation starts here
        sim, _ = lo.run_policy(srv, frames, gt, trace, pol, part, patch,
                               inf_delay, video)
        launches = dispatch.launch_counts()  # ... and ends here
        count(f"offload {mode} cache {tag}{policy} {video}", launches)
        jobs[mode] = sim.jobs
        d2h, h2d = st.tile_bytes_d2h - before[0], st.tile_bytes_h2d - before[1]
        n = st.offloads - before[2]
        sw = np.array([j["server_wall"] for j in sim.jobs]) * 1e3
        reuse = [j for j in sim.jobs if j["n_r"] > 0]
        out[mode] = {
            "offloads": n, "reuse_offloads": len(reuse),
            "tile_bytes_d2h": d2h, "tile_bytes_h2d": h2d,
            "tile_bytes_per_offload": (d2h + h2d) / max(n, 1),
            "server_ms_median": float(np.median(sw)),
            "server_ms_mean": float(sw.mean()),
            "server_ms_reuse_mean": float(np.mean(
                [j["server_wall"] for j in reuse]) * 1e3) if reuse else None,
            "launches": {k: v for k, v in launches.items() if v}}
        r = out[mode]
        say(f"  {mode} cache: {n} offloads ({len(reuse)} with REUSE), tile "
            f"bytes d2h {d2h} h2d {h2d} ({r['tile_bytes_per_offload']:.0f} "
            f"an offload); server {r['server_ms_median']:.2f} ms median, "
            f"{r['server_ms_mean']:.2f} mean a offload"
            + (f", {r['server_ms_reuse_mean']:.2f} mean a REUSE offload"
               if reuse else ""))
    srv.device_cache = True

    def decisions(js):
        return [(j["frame"], j["n_d"], j["n_r"], j["beta"]) for j in js]

    check(decisions(jobs["host"]) == decisions(jobs["device"]),
          "host and device cache made different offloads")
    check(all(a["dets"] == b["dets"]
              for a, b in zip(jobs["host"], jobs["device"])),
          "host and device cache gave different detections")
    check(out["host"]["reuse_offloads"] > 0, "phase 18: REUSE never fired")
    check(out["host"]["tile_bytes_per_offload"] > 0,
          "host cache moved no tile bytes")
    check(out["device"]["tile_bytes_per_offload"] == 0,
          "device cache moved tile bytes")
    say(f"  detections equal over {len(jobs['host'])} offloads")
    out["decisions"] = decisions(jobs["host"])
    return out


# ---------------------------------------------------------------------------
# the int8 LM lane (phase 19)


def lm_gemms(cfg):
    """(name, K, N) of the five projection GEMMs of a dense block."""
    D, F_ = cfg.d_model, cfg.d_ff
    return (("qkv", D, cfg.q_dim + 2 * cfg.kv_dim), ("o", cfg.q_dim, D),
            ("gate", D, F_), ("up", D, F_), ("down", F_, D))


def lm_int8_gemm_checks(torch, cfg, dev):
    """``int8_matmul`` against its plain version, bit-equal, at the int8
    LM's shapes: decode M = LM_B and prefill M = LM_B * LM_T.  The decode
    shapes are timed (device us a launch) beside their bound, summed over
    a decode step's ``n_layers`` blocks."""
    from repro_torch.kernels.int8_matmul import ops as i8
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows, step_us, step_bound = [], 0.0, 0.0
    for name, K, N in lm_gemms(cfg):
        for M in (LM_B, LM_B * LM_T):
            xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8).t()
            sx = torch.rand(M, generator=gen, device=dev) * 0.02 + 1e-3
            sw = torch.rand(N, generator=gen, device=dev) * 0.02 + 1e-3
            got = i8.int8_matmul_cuda(xq, wq, sx, sw)
            check(torch.equal(got, i8.int8_matmul_plain(xq, wq, sx, sw)),
                  f"int8_matmul {M}x{K}x{N}: kernel differs from plain")
            if M != LM_B:
                continue
            d_us = device_us(torch, lambda: i8.KERNEL.relaunch(1),
                             DEVICE_NAMES["int8_matmul"])
            nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
            b_ms, b_by = bound(nbytes, 2 * M * N * K, PEAK_INT8)
            rows.append({"gemm": name, "M": M, "K": K, "N": N,
                         "device_us": d_us, "bound_us": b_ms * 1e3,
                         "bound_by": b_by})
            step_us += d_us * cfg.n_layers
            step_bound += b_ms * 1e3 * cfg.n_layers
            say(f"  int8_matmul {name} {M}x{K}x{N}: bit-equal (and at M = "
                f"{LM_B * LM_T}); device {d_us:.2f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}), {b_ms * 1e3 / d_us:.3f} of "
                f"its bound")
    say(f"  int8_matmul a decode step ({cfg.n_layers} blocks x 5): device "
        f"{step_us:.1f} us against its bound {step_bound:.1f} us")
    return {"decode_gemms": rows, "decode_step_device_us": step_us,
            "decode_step_bound_us": step_bound}


def moe_int8_gemm_checks(torch, cfg, dev):
    """Phase 2 for dbrx-132b's int8 lane: ``int8_matmul`` against its
    plain version, bit-equal, at its two attention GEMMs (the fused QKV
    and w_o; the expert slabs stay float) at decode M = LM_B and prefill
    M = LM_B * LM_T, each timed (device us a launch) beside its bound and
    ``torch._int_mm`` (null where it refuses the shape: it takes M > 16
    only)."""
    from repro_torch.kernels.int8_matmul import ops as i8
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    rows = []
    D = cfg.d_model
    for name, K, N in (("qkv", D, cfg.q_dim + 2 * cfg.kv_dim),
                       ("o", cfg.q_dim, D)):
        for M in (LM_B, LM_B * LM_T):
            xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8).t()
            sx = torch.rand(M, generator=gen, device=dev) * 0.02 + 1e-3
            sw = torch.rand(N, generator=gen, device=dev) * 0.02 + 1e-3
            got = i8.int8_matmul_cuda(xq, wq, sx, sw)
            check(torch.equal(got, i8.int8_matmul_plain(xq, wq, sx, sw)),
                  f"int8_matmul {cfg.name} {M}x{K}x{N}: kernel differs from "
                  f"plain")
            k_ms = timed(torch, lambda: i8.KERNEL.relaunch(1))
            d_us = device_us(torch, lambda: i8.KERNEL.relaunch(1),
                             DEVICE_NAMES["int8_matmul"])
            p_ms = timed(torch, lambda: i8.int8_matmul_plain(xq, wq, sx, sw))
            try:
                l_ms = timed(torch, lambda: torch._int_mm(xq, wq))
            except RuntimeError as e:       # the library refuses the shape
                l_ms = None
                say(f"  torch._int_mm refuses {M}x{K}x{N}: "
                    f"{str(e).splitlines()[0]}")
            nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
            b_ms, b_by = bound(nbytes, 2 * M * N * K, PEAK_INT8)
            row = {"gemm": name, "M": M, "K": K, "N": N, "ms": k_ms,
                   "device_us": d_us, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            say(f"  int8_matmul {cfg.name} {name} {M}x{K}x{N}: bit-equal; "
                f"device {d_us:.2f} us, kernel_ms {k_ms:.4f}, plain_ms "
                f"{p_ms:.4f}, int_mm_ms "
                f"{'null' if l_ms is None else f'{l_ms:.4f}'}, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}), {b_ms * 1e3 / d_us:.3f} of "
                f"its bound")
            del xq, wq, got
    return rows


def lm_int8(torch, cfg, dev, fp32, count):
    """Phase 19: full-width Qwen3-4B (seed 0, phase 7's weights) served
    through ``ServeEngine`` on its ``quantize_lm_params`` tree, plain
    waves of LM_B x LM_T + LM_NEW tokens: weight bytes before and after,
    5 ``int8_matmul`` launches a block each prefill and decode step,
    wall, prefill and decode-step ms beside phase 7's fp32 engine, greedy
    agreement with its tokens (printed, not gated); a 2-layer full-width
    int8 Qwen3 on the card and on the CPU (``lm_int8_cpu``); zamba2-1.2b
    served once through the lane."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.quant import qtensor as qt
    from repro_torch.quant.ptq import quantize_lm_params

    t_phase = time.perf_counter()
    say(f"phase 19: the int8 LM lane, {cfg.name} {cfg.n_layers} layers "
        f"D={cfg.d_model}, waves of {LM_B} x {LM_T} + {LM_NEW} tokens")
    out = {"gemms": lm_int8_gemm_checks(torch, cfg, dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    bytes0 = qt.tree_bytes(params)
    params = quantize_lm_params(params)
    torch.cuda.synchronize()
    bytes1 = qt.tree_bytes(params)
    proj = sum(leaf.q.numel() for leaf in qt._leaves(params)
               if isinstance(leaf, qt.QuantTensor))
    out.update(weight_gb_fp32=bytes0 / 1e9, weight_gb_int8=bytes1 / 1e9,
               int8_projection_gb=proj / 1e9)
    say(f"  weights {bytes0 / 1e9:.3f} GB -> {bytes1 / 1e9:.3f} GB "
        f"({proj / 1e9:.3f} GB of int8 projection codes)")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    eng, n_keys = lm_engine(torch, cfg, params, dev)
    steps = LM_NEW - 1
    dispatch.reset_launch_counts()          # the int8 LM path starts here
    first, tokens = lm_wave(eng, cfg, prompts)
    launches = dispatch.launch_counts()     # ... and ends here
    count("qwen3-4b int8", launches)
    say(f"  warmup of {n_keys} keys; wave launches {json.dumps(launches)}")
    want = {"int8_matmul": 5 * cfg.n_layers * (1 + steps),
            "flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * steps}
    check(all(launches[k] == n for k, n in want.items()),
          f"int8 wave launches {launches}, want {want}")
    walls = [lm_wave(eng, cfg, prompts)[0]]
    times = lm_phase_times(torch, eng, cfg, prompts, None, False)
    check(eng.stats.steady_compiles == 0,
          f"int8 LM steady-state first uses: {eng.stats.steady_compile_keys}")
    ref = fp32["plain"]
    same = sum(a == b for g, w in zip(tokens, ref["tokens"])
               for a, b in zip(g, w))
    agree = same / (LM_B * LM_NEW)
    out.update(first_s=first, median_s=statistics.median(walls),
               launches={k: v for k, v in launches.items() if v},
               token_agreement_with_fp32=agree, **times)
    say(f"  int8 wave: first {first:.4f} s, median {out['median_s']:.4f} s "
        f"(fp32 {ref['median_s']:.4f}); prefill {times['prefill_ms']:.3f} "
        f"ms (fp32 {ref['prefill_ms']:.3f}), decode "
        f"{times['decode_step_ms']:.3f} ms/step (fp32 "
        f"{ref['decode_step_ms']:.3f}); greedy tokens equal to fp32's "
        f"{same} of {LM_B * LM_NEW} ({agree:.3f}, not gated)")
    del eng, params
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = lm_int8_cpu(torch, cfg.replace(n_layers=2), dev,
                                     prompts)
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    out[ZAMBA.name] = lm_int8_hybrid(torch, ZAMBA, dev, count)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 19: {out['phase_s']:.1f} s")
    return out


def lm_engine(torch, cfg, params, dev, new=LM_NEW, cache_dtype=None):
    """A ServeEngine for plain waves of LM_B x LM_T + ``new``, warmed,
    its caches in ``cache_dtype`` (float32 by default)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=LM_B, max_len=LM_T + new + 8, buckets=(LM_T,),
        device=str(dev), cache_dtype=cache_dtype or torch.float32))
    return eng, eng.warmup()


def lm_wave(eng, cfg, prompts, new=LM_NEW, mask=None):
    """One wave, plain or, with a span ``mask``, mixed at BETA; returns
    (host wall s, each request's tokens)."""
    from repro_torch.serve.request import Request
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=new,
                           low_span_mask=mask,
                           beta=0 if mask is None else BETA))
    t = time.perf_counter()
    resp = sorted(eng.run(), key=lambda r: r.rid)
    wall = time.perf_counter() - t
    check(len(resp) == len(prompts)
          and all(r.n_tokens == new for r in resp),
          f"LM wave: {[r.n_tokens for r in resp]} tokens, want {new} each")
    check(all(0 <= x < cfg.vocab_size for r in resp for x in r.tokens),
          "LM wave: token out of the vocabulary")
    return wall, [r.tokens for r in resp]


def lm_int8_cpu(torch, cfg, dev, prompts):
    """A few-layer full-width int8 model served on the card and, through
    the plain versions, on the CPU: both engines' greedy tokens (their
    agreement printed), then both routes' logits teacher-forced on the
    CPU's tokens: each step to QUANT_E2E_RTOL of its largest magnitude,
    and the same greedy token wherever the CPU's top-2 margin exceeds
    twice the two routes' largest difference in that row.  Each GEMM
    quantizes its input rows on the fly, so a one-ulp difference upstream
    can flip an int8 code at a rounding tie and move a logit by a
    quantization step: on seeded weights, whose logits hold near-ties,
    one flipped greedy token changes every later one."""
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.quant import qtensor as qt
    from repro_torch.quant.ptq import quantize_lm_params
    torch.set_num_threads(os.cpu_count() or 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    p_gpu = quantize_lm_params(registry.init_params(cfg, gen, device=dev))
    p_cpu = qt.to_device(p_gpu, "cpu")
    t0 = time.perf_counter()
    got = lm_wave(lm_engine(torch, cfg, p_gpu, dev)[0], cfg, prompts)[1]
    want = lm_wave(lm_engine(torch, cfg, p_cpu, torch.device("cpu"))[0],
                   cfg, prompts)[1]
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    toks = torch.as_tensor(np.concatenate(
        [np.stack(prompts), np.asarray(want)[:, :-1]], axis=1))

    def forced(device, params):
        T = len(prompts[0])
        state = registry.init_decode_state(cfg, len(prompts),
                                           T + LM_NEW + 8, device=device)
        with torch.no_grad():
            h, state, _ = registry.prefill(
                cfg, params, {"tokens": toks[:, :T].to(device)}, state)
            out = [tfm.logits_from_hidden(cfg, params, h[:, -1:])]
            for i in range(LM_NEW - 1):
                lg, state = registry.decode_step(
                    cfg, params, toks[:, T + i:T + i + 1].to(device), T + i,
                    state)
                out.append(lg)
        return torch.stack([o[:, -1].float().cpu() for o in out])

    g, c = forced(dev, p_gpu), forced("cpu", p_cpu)      # (steps, B, V)
    rel = float(((g - c).abs().amax(dim=(1, 2))
                 / c.abs().amax(dim=(1, 2))).max())
    top2 = c.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flips = g.argmax(-1) != c.argmax(-1)
    ties = margin <= 2 * (g - c).abs().amax(dim=-1)
    say(f"  {cfg.n_layers}-layer int8 {cfg.name} card vs CPU: engine greedy "
        f"tokens equal {same} of {LM_B * LM_NEW} (not gated); teacher-forced "
        f"logits max relative error {rel:.3g} (limit {QUANT_E2E_RTOL}), "
        f"{int(flips.sum())} of {flips.numel()} greedy tokens differ, "
        f"{int((flips & ties).sum())} of them at a near-tie; "
        f"{time.perf_counter() - t0:.1f} s")
    check(rel <= QUANT_E2E_RTOL, f"int8 LM: card vs CPU logits {rel}")
    check(not bool((flips & ~ties).any()),
          "int8 LM: a greedy token differs card vs CPU beyond a near-tie")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return {"engine_tokens_equal": same, "tokens": LM_B * LM_NEW,
            "forced_logits_rel": rel, "forced_flips": int(flips.sum()),
            "forced_flips_at_ties": int((flips & ties).sum())}


def lm_int8_hybrid(torch, cfg, dev, count):
    """zamba2-1.2b (full width, seed 0) served once through the int8 lane:
    its shared block's projections run ``int8_matmul``."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.quant import qtensor as qt
    from repro_torch.quant.ptq import quantize_lm_params
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    bytes0 = qt.tree_bytes(params)
    params = quantize_lm_params(params)
    bytes1 = qt.tree_bytes(params)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    eng, _ = lm_engine(torch, cfg, params, dev)
    dispatch.reset_launch_counts()          # the zamba2 int8 path starts
    wall, _ = lm_wave(eng, cfg, prompts)
    launches = dispatch.launch_counts()     # ... and ends here
    count(f"{cfg.name} int8", launches)
    calls = cfg.n_layers // 6                # shared-block calls
    check(launches["int8_matmul"] == 5 * calls * LM_NEW,
          f"{cfg.name} int8: {launches['int8_matmul']} int8_matmul launches,"
          f" want {5 * calls * LM_NEW}")
    check(eng.stats.steady_compiles == 0, f"{cfg.name} int8: steady first use")
    say(f"  {cfg.name} int8: {bytes0 / 1e9:.3f} GB -> {bytes1 / 1e9:.3f} GB;"
        f" wave of {LM_B} x {LM_T} + {LM_NEW} in {wall:.3f} s; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    del eng, params
    torch.cuda.empty_cache()
    return {"weight_gb_fp32": bytes0 / 1e9, "weight_gb_int8": bytes1 / 1e9,
            "wall_s": wall,
            "launches": {k: v for k, v in launches.items() if v}}


# ---------------------------------------------------------------------------
# the ViT half-precision lanes (phase 21)


def vit_half_phase(torch, cfg, dev, count, plans, lat):
    """Phase 21: full-width ViTDet-L (seed 0) served through
    ``ServerModel(quant=spec)`` for each of HALF_SPECS (the reference's
    shipped ``int8+fp16-p1``, an fp16 tree, a bf16 tree): compression on
    the card, warmup on phase 3's plan space (the float32 grid's keys),
    a full-resolution wave capturing tiles, a mixed beta-2 wave at bucket
    48 splicing REUSE tiles from them, a beta-0 wave and the exact lane
    at beta 2.  Every wave finite, no steady first use.  Two paths a
    spec, each with its launches and its half launches, the counts set
    to 0 just before it and read just after: the compression (the
    server's construction, ``vitdet-l <spec> compress``), where
    ``avg_pool`` must launch at half (it pools the half positional
    grid), and the served waves and the exact lane (``vitdet-l
    <spec>``), where window, flash, pack_pos, restore_gather and
    nn_upsample must launch at half, and ``int8_matmul`` in the int8
    lane.  A served wave pools its frame in float32, as the reference
    does (the frame is float32; the patch embedding casts after the
    pool).  Wave ms beside phase 3's float32 and phase 5's int8 + fp32
    from this run.  Then 8-block full-width trees card
    vs CPU within the CPU tests' limits (HALF_E2E_RTOL)."""
    from repro_torch import convert
    from repro_torch.core import partition as pt
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import dispatch
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.quant.ptq import QuantSpec, compress
    from repro_torch.serve.request import FeatureCache

    t_phase = time.perf_counter()
    say(f"phase 21: the ViT half lanes, {cfg.name} {cfg.n_layers} blocks "
        f"D={cfg.d_model}, B={B}: {[QuantSpec(*s).name for s in HALF_SPECS]}")
    out = {"specs": {}}
    seen = {"f16": set(), "bf16": set()}         # the served paths
    pooled = {"f16": set(), "bf16": set()}       # the compressions
    for spec in HALF_SPECS:
        name = QuantSpec(*spec).name
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = convert.init_vitdet_params(cfg, gen, device=dev)
        t0 = time.perf_counter()
        dispatch.reset_launch_counts()      # the compression starts here
        srv = ServerModel(cfg, params, b_buckets=(1, 2), device=dev,
                          quant=QuantSpec(*spec))
        del params
        torch.cuda.synchronize()
        comp = dispatch.launch_counts()     # ... and ends here
        rep = srv.quant_report
        suf = {torch.float16: "f16", torch.bfloat16: "bf16"}[srv.act_dtype]
        comp_half = dispatch.launch_counts(suf)
        count(f"vitdet-l {name} compress", comp)
        pooled[suf] |= {k for k, v in comp_half.items() if v}
        nR = srv.part.n_regions
        b0 = beta0_plans(pt, nR)
        space = srv.default_plan_space([BETA], reuse_edges=(0, 4),
                                       captures=(BETA,))
        space += [(int(p.n_low), 0, 0, 0) for p in b0]
        srv.warmup(space, (1, 2))
        check(sorted(srv._keys) == lat["grid_keys"],
              f"{name}: grid keys differ from float32's")
        full = [pt.RegionPlan(np.zeros(nR, np.int8)) for _ in range(B)]
        caches = [FeatureCache(nR) for _ in range(B)]
        frames = [torch.rand((B, *cfg.vit.img_size, 3), generator=gen,
                             device=dev) for _ in range(2)]
        low_plans, _ = exact_plans(pt, nR)
        (fi, li, _), _, _ = lane_inputs(torch, pt, srv.part, low_plans, dev)

        def wave(i, wplans, beta=BETA, **kw):
            t = time.perf_counter()
            pend = srv.infer_wave(frames[i], wplans, beta,
                                  caches=caches if beta else None,
                                  frame_ids=[i] * B if beta else None,
                                  defer=True, **kw)
            check(bool(torch.isfinite(pend.boxes).all()
                       and torch.isfinite(pend.scores).all()),
                  f"{name} wave {i} beta {beta}: non-finite detections")
            check(len(pend.wait()) == B, f"{name}: wrong detection count")
            return time.perf_counter() - t

        def exact():
            with torch.no_grad():
                o = vb.forward_det(srv.cfg, srv.params, frames[1], fi, li,
                                   BETA)
            check(all(bool(torch.isfinite(t).all()) for lvl in o
                      for t in lvl.values() if isinstance(t, torch.Tensor)),
                  f"{name}: exact lane non-finite")

        dispatch.reset_launch_counts()      # the served path starts here
        firsts = (wave(0, full, capture_beta=BETA), wave(1, plans),
                  wave(1, b0, beta=0))
        exact()
        launches = dispatch.launch_counts()  # ... and ends here
        half = dispatch.launch_counts(suf)
        design = half_design(f"vitdet-l {name}", suf, half)
        count(f"vitdet-l {name}", launches)
        seen[suf] |= {k for k, v in half.items() if v}
        check(srv.stats.steady_compiles == 0,
              f"{name}: steady-state first uses "
              f"{srv.stats.steady_compile_keys}")
        for c in caches:
            check(c.tiles is not None and c.tiles.dtype == srv.act_dtype
                  and bool(torch.isfinite(c.tiles).all()),
                  f"{name}: cached tiles missing, non-finite or not "
                  f"{srv.act_dtype}")
        ms = {"full_res": statistics.median(
                  wave(0, full, capture_beta=BETA) for _ in range(3)) * 1e3,
              "mixed": statistics.median(wave(1, plans)
                                         for _ in range(3)) * 1e3,
              "beta0": statistics.median(wave(1, b0, beta=0)
                                         for _ in range(3)) * 1e3,
              "exact_beta2": timed(torch, exact, target_ms=300)}
        check(srv.stats.steady_compiles == 0, f"{name}: steady first uses")
        r = {"act_dtype": str(srv.act_dtype), "bytes": rep["bytes"],
             "bytes_fp32": rep["bytes_fp32"], "ratio": rep["ratio"],
             "heads": srv.cfg.n_heads, "init_warmup_s": time.perf_counter()
             - t0, "first_s": firsts, "wave_ms": ms,
             "launches": {k: v for k, v in launches.items() if v},
             f"launches_{suf}": {k: v for k, v in half.items() if v},
             "compress_launches": {k: v for k, v in comp.items() if v},
             f"compress_launches_{suf}": {k: v for k, v in comp_half.items()
                                          if v}, "half_design": design}
        out["specs"][name] = r
        say(f"  {name} ({srv.act_dtype}): {rep['bytes_fp32']} -> "
            f"{rep['bytes']} bytes (ratio {rep['ratio']:.4f}), heads "
            f"{srv.cfg.n_heads}; waves ms (B={B}): full-res "
            f"{ms['full_res']:.1f}, mixed beta {BETA} {ms['mixed']:.1f}, "
            f"beta 0 {ms['beta0']:.1f}, exact lane beta {BETA} "
            f"{ms['exact_beta2']:.1f}; steady first uses 0")
        say(f"    served launches {json.dumps(r['launches'])}; at {suf} "
            f"{json.dumps(r[f'launches_{suf}'])}")
        say(f"    compression launches {json.dumps(r['compress_launches'])};"
            f" at {suf} {json.dumps(r[f'compress_launches_{suf}'])}")
        del srv, caches, frames
        torch.cuda.empty_cache()
    q = lat["quant"]
    out["fp32_ms"] = {"full_res": lat["full_res_median_s"] * 1e3,
                      "mixed": lat["mixed_median_s"] * 1e3,
                      "beta0": lat["beta0_median_s"] * 1e3}
    out["int8_fp32_ms"] = {"full_res": q["full_res_median_s"] * 1e3,
                           "mixed": q["mixed_median_s"] * 1e3}
    say(f"  beside (this run): fp32 full-res {out['fp32_ms']['full_res']:.1f}"
        f" / mixed {out['fp32_ms']['mixed']:.1f} / beta 0 "
        f"{out['fp32_ms']['beta0']:.1f} ms (phase 3); int8+fp32-p1 "
        f"{out['int8_fp32_ms']['full_res']:.1f} / "
        f"{out['int8_fp32_ms']['mixed']:.1f} ms (phase 5)")
    out["half_kernels"] = {k: sorted(v) for k, v in seen.items()}
    out["half_kernels_compress"] = {k: sorted(v) for k, v in pooled.items()}
    want = ("window_attention", "flash_attention", "pack_pos",
            "restore_gather", "nn_upsample")
    for suf, got in seen.items():
        missing = [k for k in want + (("int8_matmul",) if suf == "f16"
                                      else ()) if k not in got]
        check(not missing, f"phase 21: never launched at {suf} on a served "
              f"path: {missing}")
        check("avg_pool" in pooled[suf], f"phase 21: avg_pool never "
              f"launched at {suf} in a compression")
    say(f"  half launches, served: {out['half_kernels']}; compression: "
        f"{out['half_kernels_compress']}")
    out["card_vs_cpu"] = {}
    for spec in HALF_E2E:
        name = QuantSpec(*spec).name
        say(f"  8-block full-width {name} tree, card vs CPU "
            f"(limit {HALF_E2E_RTOL[name]})")
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        c8 = cfg.replace(n_layers=8)
        p_gpu = convert.init_vitdet_params(c8, gen, device=dev)
        qcfg, p_gpu, _ = compress(c8, p_gpu, QuantSpec(*spec))
        out["card_vs_cpu"][name] = compare_on_cpu(
            torch, qcfg, dev, gen, p_gpu, plans, pt, vb, HALF_E2E_RTOL[name])
        del p_gpu
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 21: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the LM half-precision lanes (phase 22)


def lm_half_phase(torch, cfg, dev, fp32, count):
    """Phase 22: full-width Qwen3-4B (seed 0, phase 7's weights and
    prompts) served through ``ServeEngine`` in plain waves of LM_B x LM_T
    + LM_NEW tokens on each of LM_HALF_LANES: a bf16 tree and an fp16
    tree (``qtensor.cast_tree``, float32 caches) and a float32 tree over
    a bf16 cache (``ServeConfig.cache_dtype``).  For each: weight GB,
    prefill and decode-step ms, ``flash_attention`` at half in the
    prefill of a half tree and ``decode_attention`` at half in every
    decode step (its q or its cache half), finite prefill logits (gated
    on bf16; printed on fp16, whose range a 36-layer seeded model may
    leave), and greedy agreement with phase 7's float32 tokens (printed,
    not gated).  Then mamba2-370m and zamba2-1.2b serve one bf16 wave each
    (``ssd_scan`` on float32 casts, as in the reference), and a 2-layer
    full-width bf16 Qwen3 card vs CPU to LM_BF16_RTOL."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.quant import qtensor as qt

    t_phase = time.perf_counter()
    say(f"phase 22: the LM half lanes, {cfg.name} {cfg.n_layers} layers "
        f"D={cfg.d_model}, waves of {LM_B} x {LM_T} + {LM_NEW} tokens: "
        f"{[name for name, _, _ in LM_HALF_LANES]}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    ref = fp32["plain"]
    steps = LM_NEW - 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p32 = registry.init_params(cfg, gen, device=dev)
    out = {"lanes": {}}
    for name, tree_dt, cache_dt in LM_HALF_LANES:
        tree_dt, cache_dt = getattr(torch, tree_dt), getattr(torch, cache_dt)
        params = p32 if tree_dt == torch.float32 else \
            qt.cast_tree(p32, tree_dt)
        torch.cuda.synchronize()
        gb = qt.tree_bytes(params) / 1e9
        half = cache_dt if cache_dt != torch.float32 else tree_dt
        suf = {torch.float16: "f16", torch.bfloat16: "bf16"}[half]
        eng, n_keys = lm_engine(torch, cfg, params, dev,
                                cache_dtype=cache_dt)
        dispatch.reset_launch_counts()      # this lane starts here
        first, tokens = lm_wave(eng, cfg, prompts)
        launches = dispatch.launch_counts()  # ... and ends here
        at_half = dispatch.launch_counts(suf)
        design = half_design(f"{cfg.name} {name}", suf, at_half)
        count(f"{cfg.name} {name}", launches)
        want = {"decode_attention": cfg.n_layers * steps}
        if tree_dt != torch.float32:
            want["flash_attention"] = cfg.n_layers
        check(all(at_half[k] == n and launches[k] == n
                  for k, n in want.items()),
              f"{name}: launches {launches}, at {suf} {at_half}, want {want}")
        walls = [lm_wave(eng, cfg, prompts)[0]]
        times = lm_phase_times(torch, eng, cfg, prompts, None, False)
        check(eng.stats.steady_compiles == 0,
              f"{name}: steady first uses {eng.stats.steady_compile_keys}")
        with torch.no_grad():
            state = eng._state(LM_B)
            toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                                   device=dev)
            h, _, _ = registry.prefill(cfg, params, {"tokens": toks}, state)
            logits = tfm.logits_from_hidden(cfg, params, h[:, -1:])
            finite = bool(torch.isfinite(logits).all())
            hidden_max = float(h.float().abs().max())
        if name != "fp16":
            check(finite, f"{name}: non-finite prefill logits")
        same = sum(a == b for g, w in zip(tokens, ref["tokens"])
                   for a, b in zip(g, w))
        r = {"weight_gb": gb, "first_s": first,
             "median_s": statistics.median(walls), **times,
             "logits_finite": finite, "last_hidden_absmax": hidden_max,
             "token_agreement_with_fp32": same / (LM_B * LM_NEW),
             "launches": {k: v for k, v in launches.items() if v},
             f"launches_{suf}": {k: v for k, v in at_half.items() if v},
             "half_design": design, "warmup_keys": n_keys}
        out["lanes"][name] = r
        say(f"  {name}: weights {gb:.3f} GB; wave first {first:.4f} s, "
            f"median {r['median_s']:.4f} s (fp32 {ref['median_s']:.4f}); "
            f"prefill {times['prefill_ms']:.3f} ms (fp32 "
            f"{ref['prefill_ms']:.3f}), decode {times['decode_step_ms']:.3f}"
            f" ms/step (fp32 {ref['decode_step_ms']:.3f}); prefill logits "
            f"{'finite' if finite else 'NOT finite'} (last hidden |max| "
            f"{hidden_max:.4g}); greedy tokens equal to fp32's {same} of "
            f"{LM_B * LM_NEW} (not gated)")
        say(f"    launches {json.dumps(r['launches'])}; at {suf} "
            f"{json.dumps(r[f'launches_{suf}'])}")
        del eng, params, state, h, logits
        torch.cuda.empty_cache()
    del p32
    torch.cuda.empty_cache()
    from repro_torch.configs.mamba2_370m import CONFIG as MAMBA
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    for c in (MAMBA, ZAMBA):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = qt.cast_tree(registry.init_params(c, gen, device=dev),
                              torch.bfloat16)
        p_rng = np.random.default_rng(SEED)
        ps = [p_rng.integers(0, c.vocab_size, LM_T).astype(np.int32)
              for _ in range(LM_B)]
        eng, _ = lm_engine(torch, c, params, dev)
        dispatch.reset_launch_counts()      # this wave starts here
        wall, _ = lm_wave(eng, c, ps)
        launches = dispatch.launch_counts()  # ... and ends here
        at_half = dispatch.launch_counts("bf16")
        design = half_design(f"{c.name} bf16", "bf16", at_half)
        count(f"{c.name} bf16", launches)
        n_attn = c.n_layers // 6 if c.family == "hybrid" else 0
        check(launches["ssd_scan"] == c.n_layers
              and at_half["flash_attention"] == n_attn
              and at_half["decode_attention"] == n_attn * steps,
              f"{c.name} bf16: launches {launches}, bf16 {at_half}")
        check(eng.stats.steady_compiles == 0, f"{c.name} bf16: steady "
              f"first use")
        out[c.name] = {"wall_s": wall, "weight_gb": qt.tree_bytes(params)
                       / 1e9, "launches": {k: v for k, v in launches.items()
                                           if v},
                       "launches_bf16": {k: v for k, v in at_half.items()
                                         if v}, "half_design": design}
        say(f"  {c.name} bf16: {out[c.name]['weight_gb']:.3f} GB; wave of "
            f"{LM_B} x {LM_T} + {LM_NEW} in {wall:.3f} s; launches "
            f"{json.dumps(out[c.name]['launches'])}; at bf16 "
            f"{json.dumps(out[c.name]['launches_bf16'])}")
        del eng, params
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = lm_cross_check(
        torch, cfg.replace(n_layers=2), dev, phase=22, dtype=torch.bfloat16,
        rtol=LM_BF16_RTOL)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 22: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the calibration gate (phase 20)


def calibrate_phase(torch, cfg, dev, count):
    """Phase 20: ``quant.calibrate`` on full-width ViTDet-L (seed 0) with
    its default ladder (``ptq.DEFAULT_CANDIDATES``: int8+fp16-p1,
    int8+fp16, int8, fp16+fp16, most compressed first), ``parkS`` /
    ``driveN``, CALIB_FRAMES frames, top-k 32 at score 0: each rung's
    bytes and deltas, the shipped spec and the wall.  The half rungs run
    the kernels' half entry points."""
    from repro_torch import convert
    from repro_torch.kernels import dispatch
    from repro_torch.quant import calibrate as cal
    from repro_torch.quant.ptq import DEFAULT_CANDIDATES

    say(f"phase 20: calibration gate, {cfg.name} {cfg.n_layers} blocks, "
        f"{CALIB_FRAMES} frames of {cal.SCENARIOS}, the default ladder "
        f"{[c.name for c in DEFAULT_CANDIDATES]}, top-k 32, score "
        f"threshold 0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    kw = dict(device=str(dev), top_k=32, score_thresh=0.0)
    t0 = time.perf_counter()
    dispatch.reset_launch_counts()          # the calibration starts here
    rep = cal.calibrate(cfg, params, n_frames=CALIB_FRAMES, server_kw=kw)
    launches = dispatch.launch_counts()     # ... and ends here
    half = dispatch.launch_counts("f16")
    wall = time.perf_counter() - t0
    count("calibrate vitdet-l", launches)
    check(rep.points[0].spec.name == DEFAULT_CANDIDATES[0].name,
          f"the ladder did not start at its most compressed rung: "
          f"{[p.spec.name for p in rep.points]}")
    check(launches["int8_matmul"] > 0 and half["int8_matmul"] > 0,
          f"calibrate ran no fp16-output int8 GEMM: {launches}, fp16 {half}")
    check(half["window_attention"] > 0 and half["flash_attention"] > 0,
          f"calibrate's half rungs launched no half attention: {half}")
    points = []
    for p in rep.points:
        check(all(np.isfinite(d) for d in p.deltas.values()),
              f"{p.spec.name}: non-finite delta")
        points.append({"spec": p.spec.name, "bytes": p.bytes,
                       "ratio": p.ratio, "deltas": p.deltas,
                       "passed": p.passed})
        say(f"  {p.spec.name}: {p.bytes} bytes (ratio {p.ratio:.4f}); F1 "
            f"deltas " + ", ".join(f"{k} {v:.4f}" for k, v in
                                   p.deltas.items())
            + f" (bound {rep.bound}): {'pass' if p.passed else 'fail'}")
    shipped = rep.shipped.name if rep.shipped else None
    say(f"  shipped {shipped}; {wall:.1f} s; fp16 launches "
        f"{json.dumps({k: v for k, v in half.items() if v})}.  On seeded "
        f"weights these deltas measure agreement with the fp32 model's "
        f"detections, not accuracy")
    del params
    torch.cuda.empty_cache()
    return {"points": points, "shipped": shipped, "bound": rep.bound,
            "bytes_fp32": rep.bytes_fp32, "wall_s": wall,
            "launches": {k: v for k, v in launches.items() if v},
            "launches_f16": {k: v for k, v in half.items() if v}}


def device_us(torch, fn, frag, n=20):
    """Device microseconds per call of ``fn`` in the kernels whose names
    hold ``frag`` (a trace of ``n`` calls): the kernel's own time, without
    the host's launch rate that back-to-back CUDA-event timing can read."""
    return kernel_breakdown(torch, fn, (frag,), n)[frag]


def cold_us(torch, fns, frag, rounds=3):
    """Device microseconds per call in the kernels named by ``frag`` when
    the calls rotate over ``fns``, each on inputs of its own, so that the
    inputs of one call have left the 50 MB L2 before it runs again (as
    the caches of 36 layers do in one decode step)."""
    return kernel_breakdown(torch, lambda: [f() for f in fns], (frag,),
                            rounds)[frag] / len(fns)


def cold_sets(pair_bytes):
    """How many distinct input sets ``cold_us`` rotates over: 36 (a
    Qwen3-4B decode step's layers) while they fit in 1 GB, and never
    fewer than two."""
    return max(2, min(36, 10 ** 9 // pair_bytes))


def ssd_kernel_checks(torch, dev, gen, put):
    """Phase 9: ``ssd_scan`` against its plain version on the card, y and
    the final state each within SSD_TOL of the plain version's largest
    magnitude: the mamba2-370m serving shape (its kernels-line row, timed
    through ``put``), the zamba2-1.2b shape, one 128-row chunk, a ragged
    T, two B/C groups, every (N, P slice) instance the library builds and
    the reference's test shapes at small sizes, and a state handoff (two
    halves chained through ``init_state`` against the whole).  Returns the
    other cases' rows."""
    from repro_torch.configs.mamba2_370m import CONFIG as MAMBA
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops as ssd
    say("phase 9: ssd_scan vs its plain version on the card")
    extra = {}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def case(name, cfg, b, T, groups=None, timed_case=False):
        args = ssd_inputs(torch, cfg, dev, gen, b, T, groups)
        chunk = cfg.ssm.chunk_size
        y, s = ssd.ssd_scan_cuda(*args, chunk)
        yp, sp = ssd.ssd_scan_plain(*args, chunk)
        errs = (rel(y, yp), rel(s, sp))
        check(all(np.isfinite(errs)) and max(errs) <= SSD_TOL,
              f"ssd_scan {name}: relative error y {errs[0]}, state "
              f"{errs[1]} (limit {SSD_TOL})")
        x, dt, A, Bm, Cm = args
        shape = (b, T, x.shape[2], Bm.shape[2], Bm.shape[3], x.shape[3],
                 chunk)
        row = {"shape_b_T_H_G_N_P_chunk": shape, "rel_err_y": errs[0],
               "rel_err_state": errs[1],
               "max_abs_err": float(max((y - yp).abs().max(),
                                        (s - sp).abs().max()))}
        if timed_case:
            row["ms"] = timed(torch, lambda: ssd.KERNEL.relaunch(1))
            row["plain_ms"] = timed(torch,
                                    lambda: ssd.ssd_scan_plain(*args, chunk))
            nbytes, nops = ssd_cost(*shape)
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, TF32_PRODUCTS * nops, PEAK_TF32)
            row["kernels_us"] = kernel_breakdown(
                torch, lambda: ssd.KERNEL.relaunch(1), SSD_STAGES)
            say(f"  ssd_scan {name} device us per call by kernel: "
                f"{row['kernels_us']}")
        say(f"  ssd_scan {name} {shape}: relative error y {errs[0]:.3g}, "
            f"state {errs[1]:.3g} (limit {SSD_TOL})")
        extra[name] = row
        return row

    row = case("mamba2_serving", MAMBA, SSM_B, SSM_T, timed_case=True)
    put("ssd_scan", row["max_abs_err"], row["ms"], row["plain_ms"], None,
        row["bound_ms"], row["bound_by"], sum(row["kernels_us"].values()))
    z = case("zamba2_serving", ZAMBA, SSM_B, SSM_T, timed_case=True)
    say(f"  ssd_scan zamba2 shape: kernel_ms={z['ms']:.4f} plain_ms="
        f"{z['plain_ms']:.4f} bound_ms={z['bound_ms']:.4f} "
        f"({z['bound_by']})")
    case("one_chunk_T128", MAMBA, SSM_B, 128)
    case("ragged_T1000", MAMBA, 2, 1000)
    case("groups_2", MAMBA, 2, 512, groups=2)

    # every (N, P slice) instance the library builds, and the reference's
    # own test shapes (tests/test_kernels.py, test_ssd_scan)
    grid = [(2, 200, 8, 2, n, p, 64) for n in SSD_NS for p in (16, 32, 64)]
    grid += [(2, 200, 4, 1, 64, 128, 64)] + list(SSD_REF_SHAPES)
    extra["small_shapes"] = {}
    for shape in grid:
        b, T, H, G, N, P, chunk = shape
        x = torch.randn((b, T, H, P), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, T, H), generator=gen, device=dev))
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.5)
        Bm, Cm = (torch.randn((b, T, G, N), generator=gen, device=dev) * 0.3
                  for _ in range(2))
        y, s = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
        yp, sp = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
        errs = (rel(y, yp), rel(s, sp))
        check(all(np.isfinite(errs)) and max(errs) <= SSD_TOL,
              f"ssd_scan {shape}: relative error y {errs[0]}, state "
              f"{errs[1]} (limit {SSD_TOL})")
        extra["small_shapes"][str(shape)] = errs
    worst = max(max(e) for e in extra["small_shapes"].values())
    say(f"  ssd_scan at {len(grid)} small shapes (b, T, H, G, N, P, chunk),"
        f" every built instance: worst relative error {worst:.3g} (limit "
        f"{SSD_TOL})")

    # state handoff: the halves chained through init_state == the whole
    x, dt, A, Bm, Cm = ssd_inputs(torch, MAMBA, dev, gen, 2, 1024)
    y, s = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, 256)
    h = 512 + 100                             # a cut inside a chunk
    y1, s1 = ssd.ssd_scan_cuda(x[:, :h], dt[:, :h], A, Bm[:, :h],
                               Cm[:, :h], 256)
    y2, s2 = ssd.ssd_scan_cuda(x[:, h:], dt[:, h:], A, Bm[:, h:],
                               Cm[:, h:], 256, init_state=s1)
    yp, sp = ssd.ssd_scan_plain(x[:, h:], dt[:, h:], A, Bm[:, h:],
                                Cm[:, h:], 256, init_state=s1)
    errs = (rel(torch.cat([y1, y2], 1), y), rel(s2, s), rel(y2, yp),
            rel(s2, sp))
    check(max(errs) <= SSD_TOL, f"ssd_scan handoff: relative errors {errs}")
    extra["handoff"] = dict(zip(("y_vs_whole", "state_vs_whole",
                                 "y_vs_plain", "state_vs_plain"), errs))
    say(f"  ssd_scan handoff at row {h}: {extra['handoff']}")
    return extra


# ---------------------------------------------------------------------------
# the MoE family (phase 23: dbrx-132b and deepseek-v2-236b through
# ServeEngine)


@contextlib.contextmanager
def record_routes(torch, moe):
    """``moe.route`` recording, call by call, each token's chosen experts
    (sorted), the gap between its k-th and (k+1)-th expert's probability
    and the gap under which that is a routing near-tie: MOE_ROUTE_TIE for
    a float32 router, 8 u L p_k for a half one (HALF_ROUTE_ULPS)."""
    saved, log = moe.route, []

    def route(cfg, router_w, x_flat):
        top_idx, top_gate, aux = saved(cfg, router_w, x_flat)
        logits = (x_flat @ router_w).float()
        probs = torch.softmax(logits, dim=-1)
        top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
        unit = UNIT_ROUNDOFF.get(str(router_w.dtype).split(".")[-1])
        tie = (torch.full_like(top[:, 0], MOE_ROUTE_TIE) if unit is None
               else HALF_ROUTE_ULPS * unit * logits.abs().amax(-1)
               * top[:, -2])
        log.append((top_idx.sort(dim=-1).values.cpu(),
                    (top[:, -2] - top[:, -1]).cpu(), tie.cpu()))
        return top_idx, top_gate, aux
    moe.route = route
    try:
        yield log
    finally:
        moe.route = saved


@contextlib.contextmanager
def plain_lm_route(dispatch, flash, dec):
    """The flash and decode routes of ``dispatch`` replaced by their plain
    versions: what the LM serving path is held against on the card."""
    saved = dispatch.flash_attention, dispatch.decode_attention
    dispatch.flash_attention = (lambda q, k, v, *, causal=False:
                                flash.flash_attention_plain(q, k, v, causal))
    dispatch.decode_attention = dec.decode_attention_plain
    try:
        yield
    finally:
        dispatch.flash_attention, dispatch.decode_attention = saved


def forced_logits(torch, cfg, params, device, toks, T, pack=None,
                  extra=None):
    """A prefill of ``toks[:, :T]`` with the family's ``extra`` inputs
    ("frames", "image_embeds"; mixed at BETA with ``pack``), then decode
    teacher-forced on the rest: each step's last-row logits (steps, B,
    V) on the CPU, and the routing log (empty without MoE layers)."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.models import moe, registry
    from repro_torch.models import transformer as tfm
    extra = {k: v.to(device) for k, v in (extra or {}).items()}
    B, n = toks.shape[0], toks.shape[1] - T
    T0 = T + (extra["image_embeds"].shape[1] if "image_embeds" in extra
              else 0)                      # the prefill's sequence length
    with record_routes(torch, moe) as log, torch.no_grad():
        state = registry.init_decode_state(cfg, B, T0 + n + 8, device=device)
        x = toks[:, :T].to(device)
        if pack is None:
            h, state, _ = registry.prefill(cfg, params,
                                           {"tokens": x, **extra}, state)
        else:
            h, state, _ = smr.mixed_prefill(
                cfg, params, x, {k: v.to(device) for k, v in pack.items()},
                BETA, state, image_embeds=extra.get("image_embeds"))
        out = [tfm.logits_from_hidden(cfg, params, h[:, -1:])]
        for i in range(n):
            lg, state = registry.decode_step(
                cfg, params, toks[:, T + i:T + i + 1].to(device), T0 + i,
                state)
            out.append(lg)
    return torch.stack([o[:, -1].float().cpu() for o in out]), log


def hold_routes(torch, name, got, want, rtol):
    """Two routes' teacher-forced logits and routing logs
    (``forced_logits``):
    each step's logits to ``rtol`` of its largest magnitude, and the same
    greedy token wherever ``want``'s top-2 margin exceeds twice the
    routes' difference in that row.  If the routes chose other experts
    somewhere, the first call where they did must hold only routing
    near-ties (gap <= MOE_ROUTE_TIE in ``want``'s probabilities): one
    flipped expert moves its token's output by far more than rounding,
    so the logits are then printed, not held."""
    (g, glog), (c, clog) = got, want
    check(len(glog) == len(clog), f"{name}: {len(glog)} against "
          f"{len(clog)} routing calls")
    rel = float(((g - c).abs().amax(dim=(1, 2))
                 / c.abs().amax(dim=(1, 2))).max())
    top2 = c.topk(2, dim=-1).values
    flips = g.argmax(-1) != c.argmax(-1)
    ties = top2[..., 0] - top2[..., 1] <= 2 * (g - c).abs().amax(dim=-1)
    first = next(((i, (gi != ci).any(-1), gap, tie) for i, (
        (gi, _, _), (ci, gap, tie)) in enumerate(zip(glog, clog))
        if not torch.equal(gi, ci)), None)
    out = {"logits_rel": rel, "greedy_flips": int(flips.sum()),
           "greedy_flips_at_ties": int((flips & ties).sum()),
           "routing_calls": len(clog), "first_routing_flip": None}
    say(f"    {name}: logits max relative error {rel:.3g} (limit {rtol}), "
        f"{out['greedy_flips']} of {flips.numel()} greedy tokens differ, "
        f"{out['greedy_flips_at_ties']} of them at a near-tie" + (
            "; expert choices equal in " + ("all" if first is None else
                                            f"the first {first[0]}")
            + f" of {len(clog)} routing calls" if clog else ""))
    if first is None:
        check(rel <= rtol, f"{name}: logits {rel} > {rtol}")
        check(not bool((flips & ~ties).any()),
              f"{name}: a greedy token differs beyond a near-tie")
        return out
    i, rows, gap, tie = first
    worst = float((gap[rows] / tie[rows]).max())
    out["first_routing_flip"] = {"call": i, "tokens": int(rows.sum()),
                                 "max_gap": float(gap[rows].max()),
                                 "max_gap_over_tie": worst}
    say(f"    {name}: routing call {i} chose other experts for "
        f"{int(rows.sum())} tokens, largest k / k+1 probability gap "
        f"{float(gap[rows].max()):.3g}, {worst:.3g} of its near-tie bound")
    check(worst <= 1, f"{name}: experts differ at a gap {worst} times its "
          f"near-tie bound")
    return out


def moe_narrow(cfg):
    """The card-vs-CPU config of a MoE family: ``MOE_NARROW``'s widths
    over the published config's layout."""
    return narrow_config(cfg, MOE_NARROW[cfg.name])


def serve_decoder(torch, cfg, dev, traced=("plain", "mixed")):
    """One decoder LM (seed 0, full width; dense or MoE) through a warmed
    ``ServeEngine``: a plain and a mixed wave of LM_B x LM_T + LM_NEW
    (half the spans pooled at BETA), each with its launches (GQA: flash
    once a layer a prefill, decode once a layer a step; deepseek-v2's
    MLA: neither), prefill and decode-step ms; no steady first use; peak
    memory; the decode step's byte bound (:func:`decode_weight_bytes`)
    and, with MoE layers, one layer's experts timed alone at the step's
    shape against their slabs' bytes; a traced wave of each kind in
    ``traced`` split into the experts, MLA's attention, flash, decode and
    the rest; for a model that runs kernels, the kernel route held
    against the plain route on the card.  Returns (launches summed over
    both waves, record)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.models import attention as attn
    from repro_torch.models import moe, registry
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    att = (f"MLA rank {cfg.mla.kv_lora_rank}" if cfg.mla is not None else
           f"GQA {cfg.n_heads}/{cfg.n_kv_heads} Dh={cfg.head_dim}")
    m = cfg.moe
    say(f"  {cfg.name}: {cfg.n_layers} layers D={cfg.d_model}, {att}" + (
        f", {m.n_experts} experts top-{m.top_k} ({m.n_shared_experts} "
        f"shared, {m.first_dense_layers} dense layers first)" if m else
        f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f"{' tied' if cfg.tied_embeddings else ''}, partial rotary "
        f"{cfg.partial_rotary_factor}"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(params))
    say(f"    init {n_params} parameters ({4 * n_params / 1e9:.2f} GB; "
        f"the analytic count, norm scales aside, {cfg.param_count()}) in "
        f"{time.perf_counter() - t0:.2f} s; {held_gb:.2f} GB held before")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=LM_B, max_len=LM_MAX_LEN, buckets=(LM_T,),
        device=str(dev)))
    n_spans = LM_T // (cfg.mixed_res.window * cfg.mixed_res.downsample)
    mask = np.zeros(n_spans, np.int32)
    mask[:n_spans // 2] = 1
    n_keys = eng.warmup(plan_space=[(n_spans // 2, 0, BETA)])
    say(f"    warmup of {n_keys} keys {eng.stats.warmup_wall_s:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    steps = LM_NEW - 1
    gqa = cfg.mla is None
    out = {"n_layers": cfg.n_layers, "n_params": n_params,
           "weight_gb": 4 * n_params / 1e9, "warmup_keys": n_keys,
           "warmup_s": eng.stats.warmup_wall_s}
    total = dict.fromkeys(dispatch.KERNELS, 0)
    for kind, wmask in (("plain", None), ("mixed", mask)):
        dispatch.reset_launch_counts()      # the MoE path starts here
        first, tokens = lm_wave(eng, cfg, prompts, mask=wmask)
        launches = dispatch.launch_counts()  # ... and ends here
        want = (cfg.n_layers if gqa else 0, cfg.n_layers * steps if gqa
                else 0)
        check((launches["flash_attention"], launches["decode_attention"])
              == want, f"{cfg.name} {kind}: flash / decode launched "
              f"{launches['flash_attention']} / "
              f"{launches['decode_attention']} times, want {want}")
        check(sum(launches.values()) == sum(want), f"{cfg.name} {kind}: "
              f"other kernels launched: {launches}")
        for name, n in launches.items():
            total[name] += n
        walls = [lm_wave(eng, cfg, prompts, mask=wmask)[0]]
        rec = {"first_s": first, "median_s": statistics.median(walls),
               "launches": launches, "tokens": tokens}
        rec.update(lm_phase_times(torch, eng, cfg, prompts, mask,
                                  wmask is not None))
        out[kind] = rec
        say(f"    {kind} wave: launches flash {launches['flash_attention']}"
            f", decode {launches['decode_attention']}; first {first:.3f} s,"
            f" median {rec['median_s']:.3f} s; prefill "
            f"{rec['prefill_ms']:.2f} ms, decode {rec['decode_step_ms']:.2f}"
            f" ms/step")
    check(eng.stats.steady_compiles == 0, f"{cfg.name}: steady-state first "
          f"uses {eng.stats.steady_compile_keys}")
    out["steady_compiles"] = 0
    # a decode step's byte bound: the weights it reads, once; and one MoE
    # layer's experts at the step's shape (capacity slots an expert),
    # timed alone against their slabs' bytes
    step_gb = decode_weight_bytes(cfg, params) / 1e9
    out["decode_bound_ms"] = step_gb * 1e9 / PEAK_BYTES * 1e3
    say(f"    decode step byte bound {out['decode_bound_ms']:.2f} ms "
        f"({step_gb:.2f} GB of weights)")
    if m is not None:
        ffn = params["blocks"][-1]["ffn"]
        xs = torch.randn((m.n_experts, moe.expert_capacity(cfg, LM_B),
                          cfg.d_model), generator=gen, device=dev)
        slab_gb = 4 * sum(ffn[k].numel() for k in ("w_gate", "w_up",
                                                   "w_down")) / 1e9
        out["experts_at_decode"] = {
            "shape": list(xs.shape), "ms": timed(
                torch, lambda: moe.expert_ffn(ffn, xs)),
            "bound_ms": slab_gb * 1e9 / PEAK_BYTES * 1e3}
        del xs
        say(f"    one MoE layer's experts at the step's shape "
            f"{tuple(out['experts_at_decode']['shape'])}: "
            f"{out['experts_at_decode']['ms']:.3f} ms against "
            f"{out['experts_at_decode']['bound_ms']:.3f} ms of slab bytes "
            f"({slab_gb:.2f} GB)")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"    peak memory {out['peak_gb']:.2f} GB of the card's "
        f"{card_gb:.2f} GB; 0 steady first uses")

    # one traced wave of each kind, the experts and MLA's attention marked
    marks = (("moe_experts",) if m else ()) + (
        ("mla_attention",) if cfg.mla else ())
    saved = moe.expert_ffn, attn.mla_attend
    moe.expert_ffn = _marked(torch, moe.expert_ffn, "moe_experts")
    attn.mla_attend = _marked(torch, attn.mla_attend, "mla_attention")
    try:
        for kind, wmask in (("plain", None), ("mixed", mask)):
            if kind not in traced:
                continue
            prof = profile_wave(
                torch, f"{cfg.name}_{kind}",
                lambda: lm_wave(eng, cfg, prompts, mask=wmask),
                out[kind]["median_s"], marks=marks)
            fam = prof["families_ms"]
            split = {k: fam.get(k, 0.0) for k in marks + (
                "flash_attention", "decode_attention")}
            split["other"] = prof["device_ms"] - sum(split.values())
            out[kind]["profile"] = dict(prof, split_ms=split)
            say(f"    {kind} trace split (device ms): " + ", ".join(
                f"{k} {v:.2f}" for k, v in split.items()))
    finally:
        moe.expert_ffn, attn.mla_attend = saved
    check(eng.stats.steady_compiles == 0, f"{cfg.name}: steady first uses")

    if gqa:     # the kernel route against the plain route, on the card
        toks = torch.as_tensor(np.concatenate(
            [np.stack(prompts), np.asarray(out["plain"]["tokens"])[:, :-1]],
            axis=1))
        t0 = time.perf_counter()
        kern = forced_logits(torch, cfg, params, dev, toks, LM_T)
        with plain_lm_route(dispatch, flash, dec):
            dispatch.reset_launch_counts()
            plain = forced_logits(torch, cfg, params, dev, toks, LM_T)
            check(not any(dispatch.launch_counts().values()),
                  f"{cfg.name}: the plain route launched a kernel")
        out["route_check"] = hold_routes(
            torch, f"{cfg.name} kernel vs plain route (teacher-forced on "
            f"the plain wave's tokens)", kern, plain, LM_RTOL)
        out["route_check"]["s"] = time.perf_counter() - t0
    else:
        say(f"    {cfg.name}: no kernel on this path (MLA's attention is "
            f"einsums, as in the reference); no route to compare")
    del eng, params
    torch.cuda.empty_cache()
    return total, out


def moe_card_vs_cpu(torch, cfg, dev):
    """A narrow config of the family (``moe_narrow``, seed SEED + 3) on
    the card and, through the plain versions, on the CPU: prefill and 8
    teacher-forced decode steps, plain and mixed at BETA, held by
    :func:`hold_routes` to LM_RTOL."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.models import registry
    from repro_torch.offload.simulator import to_device
    narrow = moe_narrow(cfg)
    say(f"  card vs CPU: {narrow.name} narrow ({narrow.n_layers} layers "
        f"D={narrow.d_model}, {narrow.moe.n_experts} experts top-"
        f"{narrow.moe.top_k})")
    torch.set_num_threads(os.cpu_count() or 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    p_gpu = registry.init_params(narrow, gen, device=dev)
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, narrow.vocab_size,
                                        (2, LM_T + 8)))
    part = smr.seq_partition(narrow, LM_T)
    mask = np.zeros(part.n_spans, np.int32)
    mask[:part.n_spans // 2] = 1
    pack = {k: torch.as_tensor(v.astype(np.int64)) for k, v in
            smr.build_seq_pack(mask, int(mask.sum()), part).items()}
    out = {}
    for kind, pk in (("plain", None), ("mixed", pack)):
        out[kind] = hold_routes(
            torch, f"{narrow.name} narrow {kind}, card vs CPU",
            forced_logits(torch, narrow, p_gpu, dev, toks, LM_T, pk),
            forced_logits(torch, narrow, p_cpu, "cpu", toks, LM_T, pk),
            LM_RTOL)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return out


def moe_phase(torch, dev, count):
    """Phase 23: dbrx-132b and deepseek-v2-236b at full published width,
    depth cut to MOE_LAYERS (float32 weights of 57.1 and 53.2 GB), each
    served by :func:`serve_decoder` and freed before the next; then each
    family's narrow config card vs CPU."""
    from repro_torch.configs.dbrx_132b import CONFIG as DBRX
    from repro_torch.configs.deepseek_v2_236b import CONFIG as DSV2
    t_phase = time.perf_counter()
    say(f"phase 23: MoE serving, dbrx-132b and deepseek-v2-236b at full "
        f"width, {MOE_LAYERS} layers each, waves of {LM_B} x {LM_T} + "
        f"{LM_NEW} tokens")
    out = {}
    for c in (DBRX, DSV2):
        launches, out[c.name] = serve_decoder(
            torch, c.replace(n_layers=MOE_LAYERS), dev)
        count(c.name, launches)
    out["card_vs_cpu"] = {c.name: moe_card_vs_cpu(torch, c, dev)
                          for c in (DBRX, DSV2)}
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 23: {out['phase_s']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# the reference's last five architectures (phase 24: whisper-medium,
# llava-next-mistral-7b, deepseek-7b, mistral-nemo-12b, phi4-mini-3.8b)


def decode_weight_bytes(cfg, params):
    """Bytes of the weights one decode step reads, at their types (an
    int8 weight's codes and scales): every decoder layer,
    the final norm and the head (the token table when it is tied: the
    logits read it whole); not the table's gathered rows of an untied
    model, nor whisper's encoder and ``dec_pos`` or a VLM's projector."""
    from repro_torch.quant import qtensor as qt
    layers = params["dec_blocks"] if cfg.encdec else params["blocks"]
    head = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    return qt.tree_bytes([layers, params["final_norm"], head])


def mm_greedy(torch, cfg, params, prompt, extra, pack=None):
    """MM_NEW greedy tokens of a batch through ``registry.prefill`` (with
    the family's ``extra`` inputs; ``mixed_prefill`` at BETA with
    ``pack``) and ``registry.decode_step``, each token read back to the
    host as the engine reads it.  Returns (tokens (B, MM_NEW), each
    step's last-row logits (MM_NEW, B, V) on the CPU, prefill s, decode s
    a step), host clock, synchronised."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    B, T = prompt.shape
    T0 = T + (extra["image_embeds"].shape[1] if "image_embeds" in extra
              else 0)
    with torch.no_grad():
        state = registry.init_decode_state(cfg, B, T0 + MM_NEW + 8,
                                           device=prompt.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pack is None:
            h, state, _ = registry.prefill(cfg, params,
                                           {"tokens": prompt, **extra}, state)
        else:
            h, state, _ = smr.mixed_prefill(
                cfg, params, prompt, pack, BETA, state,
                image_embeds=extra.get("image_embeds"))
        logits = [tfm.logits_from_hidden(cfg, params, h[:, -1:])]
        tok = logits[0][:, -1].argmax(-1, keepdim=True)
        toks = [tok.cpu()]
        t1 = time.perf_counter()
        for i in range(MM_NEW - 1):
            lg, state = registry.decode_step(cfg, params, tok, T0 + i, state)
            logits.append(lg)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            toks.append(tok.cpu())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (torch.cat(toks, dim=1),
            torch.stack([lg[:, -1].float().cpu() for lg in logits]),
            t1 - t0, (t2 - t1) / (MM_NEW - 1))


def mm_path(torch, cfg, params, name, prompt, extra, want, pack=None):
    """One served path of phase 24: a greedy run with the launches
    counted (they must be ``want`` = (flash, decode), nothing else) and
    two more, the prefill and decode-step ms the medians of the three;
    then the plain route teacher-forced on the kernel run's tokens, held
    by :func:`hold_routes`.  Returns (launches, record)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as flash
    dispatch.reset_launch_counts()          # the path starts here
    runs = [mm_greedy(torch, cfg, params, prompt, extra, pack)]
    launches = dispatch.launch_counts()     # ... and ends here
    toks, logits = runs[0][:2]
    got = (launches["flash_attention"], launches["decode_attention"])
    check(got == want and sum(launches.values()) == sum(want),
          f"{name}: launches {launches}, want flash / decode {want}")
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{name}: token out of the vocabulary")
    runs.append(mm_greedy(torch, cfg, params, prompt, extra, pack))
    rec = {"launches": launches, "tokens": toks.tolist(),
           "prefill_ms": statistics.median(r[2] for r in runs) * 1e3,
           "decode_step_ms": statistics.median(r[3] for r in runs) * 1e3}
    check(all(torch.equal(r[0], toks) for r in runs[1:]),
          f"{name}: greedy tokens differ between runs")
    full = torch.cat([prompt.cpu(), toks[:, :-1]], dim=1)
    t0 = time.perf_counter()
    with plain_lm_route(dispatch, flash, dec):
        dispatch.reset_launch_counts()
        plain = forced_logits(torch, cfg, params, prompt.device, full,
                              prompt.shape[1], pack, extra)
        check(not any(dispatch.launch_counts().values()),
              f"{name}: the plain route launched a kernel")
    rec["route_check"] = hold_routes(
        torch, f"{name} kernel vs plain route (teacher-forced on the "
        f"kernel run's tokens)", (logits, []), plain, LM_RTOL)
    rec["route_check"]["s"] = time.perf_counter() - t0
    say(f"    {name}: launches flash {got[0]}, decode {got[1]}; prefill "
        f"{rec['prefill_ms']:.2f} ms, decode {rec['decode_step_ms']:.2f} "
        f"ms/step (median of two)")
    return launches, rec


def mm_model(torch, cfg, dev):
    """Seed-0 weights of ``cfg`` on the card after freeing the last
    model's: (params, record with their count, GB and the step's byte
    bound)."""
    from repro_torch.models import registry
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_tensors(params))
    rec = {"n_layers": cfg.n_layers, "n_params": n, "weight_gb": 4 * n / 1e9,
           "decode_weight_gb": decode_weight_bytes(cfg, params) / 1e9}
    rec["decode_bound_ms"] = rec["decode_weight_gb"] * 1e9 / PEAK_BYTES * 1e3
    say(f"    init {n} parameters ({rec['weight_gb']:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s; a decode step reads "
        f"{rec['decode_weight_gb']:.3f} GB of them: byte bound "
        f"{rec['decode_bound_ms']:.3f} ms")
    return params, gen, rec


def serve_whisper(torch, cfg, dev, count):
    """whisper-medium at full width: WHISPER_B requests of 1500
    stub frames and a WHISPER_T-token prompt through :func:`mm_path`
    (flash: the encoder's layers, then each decoder layer's causal
    self-attention and cross-attention at the prefill, and the
    cross-attention at T_q = 1 every step; decode: every layer every
    step); ``encode_mixed`` at BETA with 37 of 75 spans pooled, against
    the plain encoder and the plain route; a traced run of the decode
    steps with the cross-attention K / V projections marked."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.models import attention as attn
    from repro_torch.models import registry
    from repro_torch.models import whisper as whs
    n_enc, n_dec = cfg.encdec.n_encoder_layers, cfg.n_layers
    S = cfg.encdec.encoder_seq_len
    say(f"  {cfg.name}: {n_enc} + {n_dec} layers D={cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size} "
        f"tied; {WHISPER_B} requests of {S} frames + {WHISPER_T} tokens, "
        f"{MM_NEW} greedy tokens")
    params, gen, out = mm_model(torch, cfg, dev)
    frames = torch.randn((WHISPER_B, S, cfg.d_model), generator=gen,
                         device=dev)
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (WHISPER_B, WHISPER_T)),
                             device=dev)
    steps = MM_NEW - 1
    launches, out["plain"] = mm_path(
        torch, cfg, params, cfg.name, prompt, {"frames": frames},
        (n_enc + 2 * n_dec + n_dec * steps, n_dec * steps))
    count(cfg.name, launches)
    # the cross-attention's K / V projections: 2 GEMMs of (B S, D) x (D,
    # kv_dim) a layer every step, against float32's peak outside the
    # tensor cores (TF32 is off)
    kv_ops = 2 * 2 * WHISPER_B * S * cfg.d_model * cfg.kv_dim * n_dec
    out["cross_kv_ops_bound_ms"] = kv_ops / PEAK_FP32 * 1e3

    # the traced decode steps: the K / V projections' share
    with torch.no_grad():
        state = registry.init_decode_state(cfg, WHISPER_B,
                                           WHISPER_T + MM_NEW + 8,
                                           device=dev)
        _, state, _ = registry.prefill(cfg, params, {"tokens": prompt,
                                                     "frames": frames}, state)
        tok = prompt[:, -1:]

        def run_steps():
            st = state
            for i in range(steps):
                lg, st = registry.decode_step(cfg, params, tok,
                                              WHISPER_T + i, st)
                lg[:, -1].argmax(-1).cpu()
        saved = attn.cross_kv
        attn.cross_kv = _marked(torch, attn.cross_kv, "cross_kv")
        try:
            prof = profile_wave(torch, f"{cfg.name}_decode", run_steps,
                                out["plain"]["decode_step_ms"] * steps / 1e3,
                                marks=("cross_kv",))
        finally:
            attn.cross_kv = saved
    fam = prof["families_ms"]
    out["decode_profile"] = dict(prof, cross_kv_share=fam.get(
        "cross_kv", 0.0) / prof["device_ms"])
    say(f"    decode steps traced: cross-attention K / V projections "
        f"{fam.get('cross_kv', 0.0) / steps:.3f} of "
        f"{prof['device_ms'] / steps:.3f} device ms a step "
        f"({out['decode_profile']['cross_kv_share']:.3f}; their float32 "
        f"operations bound {out['cross_kv_ops_bound_ms']:.3f} ms); byte "
        f"bound of the step's weights {out['decode_bound_ms']:.3f} ms")

    # the encoder's frame pooling at BETA, half the spans pooled
    part = smr.seq_partition(cfg, S)
    mask = np.zeros(part.n_spans, np.int32)
    mask[:part.n_spans // 2] = 1
    pack = {k: torch.as_tensor(v.astype(np.int64), device=dev) for k, v in
            smr.build_seq_pack(mask, int(mask.sum()), part).items()}
    with torch.no_grad():
        dispatch.reset_launch_counts()      # the path starts here
        enc_mixed = smr.encode_mixed(cfg, params, frames, pack, BETA)
        enc_launches = dispatch.launch_counts()  # ... and ends here
        check(enc_launches["flash_attention"] == n_enc
              and sum(enc_launches.values()) == n_enc,
              f"encode_mixed: launches {enc_launches}, want {n_enc} flash")
        count(f"{cfg.name} encode_mixed", enc_launches)
        with plain_lm_route(dispatch, flash, dec):
            enc_plain_route = smr.encode_mixed(cfg, params, frames, pack,
                                               BETA)
        enc_full = whs.encode(cfg, params, frames)
        rel = rel_err(enc_mixed, enc_plain_route)
        check(rel <= LM_RTOL, f"encode_mixed: kernel vs plain route {rel}")
        times = {}
        for key, fn in (("encode_ms", lambda: whs.encode(cfg, params,
                                                         frames)),
                        ("encode_mixed_ms", lambda: smr.encode_mixed(
                            cfg, params, frames, pack, BETA))):
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            times[key] = statistics.median(walls)
    out["encode_mixed"] = dict(
        times, n_low=int(mask.sum()), n_spans=part.n_spans,
        frames_pooled=part.n_tokens(int(mask.sum())), launches=enc_launches,
        route_rel=rel, rel_to_full=rel_err(enc_mixed, enc_full))
    say(f"    encode_mixed beta {BETA}, {int(mask.sum())} of {part.n_spans} "
        f"spans pooled ({part.n_tokens(int(mask.sum()))} of {S} frames "
        f"through {smr.layers_before_rp(cfg, BETA, n_enc)} layers): "
        f"{times['encode_mixed_ms']:.2f} ms against the full encoder's "
        f"{times['encode_ms']:.2f} ms; flash "
        f"{enc_launches['flash_attention']}; kernel vs plain route "
        f"{rel:.3g}; {out['encode_mixed']['rel_to_full']:.3g} from the "
        f"full-resolution encoder (the pooling's own change)")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"    peak memory {out['peak_gb']:.2f} GB")
    del params, frames, state, enc_mixed, enc_plain_route, enc_full
    return out


def serve_llava(torch, cfg, dev, count):
    """llava-next-mistral-7b at full width: LLAVA_B requests of
    2880 stub image embeddings and a LLAVA_T-token prompt through
    :func:`mm_path`, plain (flash once a layer at the causal prefill of
    3008 tokens, decode once a layer a step) and through
    ``mixed_prefill`` at BETA with half of the 188 spans (the image's
    first 94) pooled."""
    from repro_torch.core import seq_mixed_res as smr
    n_img = cfg.vlm.n_image_tokens
    say(f"  {cfg.name}: {cfg.n_layers} layers D={cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads} Dh={cfg.head_dim}; {LLAVA_B} "
        f"requests of {n_img} image embeddings (width "
        f"{cfg.vlm.vision_hidden}) + {LLAVA_T} tokens, {MM_NEW} greedy "
        f"tokens")
    params, gen, out = mm_model(torch, cfg, dev)
    extra = {"image_embeds": torch.randn(
        (LLAVA_B, n_img, cfg.vlm.vision_hidden), generator=gen, device=dev)}
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (LLAVA_B, LLAVA_T)), device=dev)
    part = smr.seq_partition(cfg, n_img + LLAVA_T)
    mask = np.zeros(part.n_spans, np.int32)
    mask[:part.n_spans // 2] = 1
    pack = {k: torch.as_tensor(v.astype(np.int64), device=dev) for k, v in
            smr.build_seq_pack(mask, int(mask.sum()), part).items()}
    want = (cfg.n_layers, cfg.n_layers * (MM_NEW - 1))
    for kind, pk in (("plain", None), ("mixed", pack)):
        launches, out[kind] = mm_path(
            torch, cfg, params, f"{cfg.name} {kind}", prompt, extra, want,
            pk)
        count(cfg.name if pk is None else f"{cfg.name} mixed", launches)
    out["mixed"]["pooled_tokens"] = part.n_tokens(int(mask.sum()))
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"    mixed prefill: {part.n_tokens(int(mask.sum()))} of "
        f"{part.seq_len} tokens through "
        f"{smr.layers_before_rp(cfg, BETA, cfg.n_layers)} layers; peak "
        f"memory {out['peak_gb']:.2f} GB")
    del params, extra
    return out


def mm_phase(torch, dev, count):
    """Phase 24: whisper-medium and llava-next-mistral-7b through the
    registry (:func:`serve_whisper`, :func:`serve_llava`), then
    deepseek-7b, mistral-nemo-12b and phi4-mini-3.8b through
    :func:`serve_decoder`, every one at full published width and
    MM_LAYERS layers (:func:`cut_depth`)
    in float32, each freed before the next."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    say(f"phase 24: the last five architectures at full width, "
        f"{MM_LAYERS} layers, float32: whisper-medium, "
        f"llava-next-mistral-7b, deepseek-7b, mistral-nemo-12b, "
        f"phi4-mini-3.8b")
    out = {"whisper-medium": serve_whisper(
        torch, cut_depth(get_config("whisper-medium"), MM_LAYERS), dev,
        count)}
    torch.cuda.empty_cache()
    out["llava-next-mistral-7b"] = serve_llava(
        torch, cut_depth(get_config("llava-next-mistral-7b"), MM_LAYERS),
        dev, count)
    for name in ("deepseek-7b", "mistral-nemo-12b", "phi4-mini-3.8b"):
        torch.cuda.empty_cache()
        launches, out[name] = serve_decoder(
            torch, cut_depth(get_config(name), MM_LAYERS), dev, traced=())
        count(name, launches)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 24: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 25: the LM families' last lanes (whisper and llava training, the
# MoE int8 and half serving lanes, MoE train steps)


def mm_train(torch, cfg, dev, count, b, t):
    """(A) ``cfg`` (whisper-medium, or llava-next-mistral-7b at
    LLAVA_TRAIN_LAYERS) trained at full width from seed-0 weights on
    ``launch.train.synthetic_batches`` (b x t tokens plus the family's
    stub frames or image embeddings), remat on: the first step's loss and
    gradients against the plain route on the card, MM_TRAIN_STEPS steps
    through ``make_train_step`` (flash launches: every attention of the
    forward, twice under remat), step wall, peak memory, one step's
    forward / backward / AdamW device ms and a traced step's families
    (``flash_attention_bwd`` and ``adamw`` marked)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.window_attention import ops as win
    from repro_torch.launch import train as lt
    from repro_torch.models import registry
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as tr

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    n = sum(x.numel() for x in tree_tensors(params))
    data = lt.synthetic_batches(cfg, b, t, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                next(data).items()} for _ in range(MM_TRAIN_STEPS)]
    extra = {k: list(v.shape) for k, v in batches[0].items()
             if k in ("frames", "image_embeds")}
    n_flash = (cfg.encdec.n_encoder_layers + 2 * cfg.n_layers if cfg.encdec
               else cfg.n_layers)           # flash calls a forward
    say(f"  {cfg.name}: {cfg.n_layers} layers" + (
        f" + {cfg.encdec.n_encoder_layers} encoder" if cfg.encdec else "")
        + f", {n / 1e9:.3f} G parameters ({16 * n / 1e9:.1f} GB with "
        f"gradients and AdamW moments); B={b}, {t} tokens, {extra}; "
        f"{held / 1e9:.2f} GB allocated before")
    out = {"n_layers": cfg.n_layers, "n_params": n, "batch": b, "tokens": t,
           "extra": extra}

    loss_k, g_k = lm_grads(torch, registry, ckpt, cfg, params, batches[0])
    dispatch.reset_launch_counts()
    with plain_route(dispatch, win, flash):
        loss_p, g_p = lm_grads(torch, registry, ckpt, cfg, params,
                               batches[0])
    check(not any(dispatch.launch_counts().values()),
          f"{cfg.name}: the plain route launched {dispatch.launch_counts()}")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    out["vs_plain"] = {"loss_rel": rel}
    say(f"  {cfg.name} first step vs the plain route on the card: loss "
        f"{float(loss_k):.5f}, rel {rel:.3g} (limit {TRAIN_LOSS_RTOL})")
    check(np.isfinite(float(loss_k)) and rel <= TRAIN_LOSS_RTOL,
          f"{cfg.name}: loss {float(loss_k)} vs plain {float(loss_p)}")
    lm_leaves_close(f"{cfg.name} first step vs the plain route", g_k, g_p,
                    out["vs_plain"])
    del g_k, g_p

    opt = adam.init_adam(ckpt.flatten(params))
    step = tr.make_train_step(cfg, tr.TrainConfig(remat=True))
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()          # the training path starts here
    losses, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    launches = dispatch.launch_counts()     # ... and ends here
    count(f"lm_train {cfg.name}", launches)
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    check(abs(losses[0] - float(loss_k)) <= 1e-5 * abs(losses[0]),
          f"{cfg.name}: first step's loss {losses[0]} vs {float(loss_k)}")
    check(launches["flash_attention"] == 2 * n_flash * MM_TRAIN_STEPS
          and sum(launches.values()) == launches["flash_attention"],
          f"{cfg.name}: launches {launches}, want {2 * n_flash} flash a "
          f"step")
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(walls[1:])
    out.update({"losses": losses, "step_s": walls,
                "step_median_ms": wall * 1e3, "peak_gb": peak / 1e9,
                "flash_a_step": 2 * n_flash,
                "launches": {k: v for k, v in launches.items() if v}})
    say(f"  {cfg.name}: {MM_TRAIN_STEPS} steps, losses " + " ".join(
        f"{x:.4f}" for x in losses) + f"; step median {wall * 1e3:.1f} ms "
        f"(first {walls[0] * 1e3:.1f}); {2 * n_flash} flash launches a step "
        f"({n_flash} a forward, again in the remat recompute); peak memory "
        f"{peak / 1e9:.2f} GB")
    out["stages_ms"] = lm_stage_ms(torch, registry, adam, ckpt, cfg, params,
                                   opt, batches[0])

    def traced():
        step(params, opt, batches[0])
        torch.cuda.synchronize()

    out["profile"] = profile_wave(torch, f"lm_train_{cfg.name}", traced,
                                  wall, marks=("flash_attention_bwd",
                                               "adamw"))
    fam = out["profile"]["families_ms"]
    say(f"  {cfg.name} one step on the device: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out["stages_ms"].items())
        + f"; traced flash_attention_bwd {fam.get('flash_attention_bwd', 0):.2f}"
        f" ms, flash_attention {fam.get('flash_attention', 0):.2f} ms")
    del params, opt, batches, m
    torch.cuda.empty_cache()
    return out


def cut_depth(cfg, n):
    """``cfg`` at its first ``n`` layers (an encoder-decoder's encoder
    too)."""
    return narrow_config(cfg, dict(n_layers=n, **(
        {"encdec": dict(n_encoder_layers=n)} if cfg.encdec else {})))


def narrow_config(cfg, widths):
    """``widths`` over ``cfg``'s published layout (nested dicts replace
    fields of its sub-configs)."""
    kw = dict(widths)
    for sub in ("moe", "mla", "encdec", "vlm"):
        if sub in kw:
            kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
    return cfg.replace(**kw)


def accum_grads(torch, registry, ckpt, cfg, params, batch, accum):
    """``lm_grads`` over ``accum`` contiguous microbatches, as
    ``make_train_step`` takes them: (mean loss, mean gradients)."""
    rows = batch["tokens"].shape[0]
    loss, grads = 0.0, None
    for i in range(accum):
        mb = {k: v[i * rows // accum:(i + 1) * rows // accum]
              for k, v in batch.items()}
        lo, g = lm_grads(torch, registry, ckpt, cfg, params, mb)
        loss = loss + float(lo) / accum
        grads = ({k: v / accum for k, v in g.items()} if grads is None else
                 {k: grads[k] + v / accum for k, v in g.items()})
    return loss, grads


def train_card_vs_cpu(torch, cfg, dev, b, t, accum=1):
    """MOE_TRAIN_STEPS train steps of a narrow config from one seeded
    init (SEED + 5), card against CPU (the plain versions): before each
    step the loss to TRAIN_LOSS_RTOL and every leaf's gradient to
    LM_GRAD_TOL of its largest, then the step through ``make_train_step``
    on both (its loss held the same way).  With MoE layers each device's
    routing is recorded: a step whose routes differ is held only to its
    first flip lying at a near-tie (``record_routes``' bound), printed,
    and the steps after it are not compared (the two models have
    parted)."""
    from repro_torch.launch import train as lt
    from repro_torch.models import moe, registry
    from repro_torch.offload.simulator import to_device
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as tr

    torch.set_num_threads(os.cpu_count() or 1)
    p_gpu = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 5), dev)
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    opts = [adam.init_adam(ckpt.flatten(p)) for p in (p_gpu, p_cpu)]
    step = tr.make_train_step(cfg, tr.TrainConfig(remat=True,
                                                  accum_steps=accum))
    data = lt.synthetic_batches(cfg, b, t, seed=SEED + 5)
    what = (f"{cfg.n_layers}-layer narrow {cfg.name} D={cfg.d_model}"
            f"{f' accum {accum}' if accum > 1 else ''}")
    out, parted, t0 = {"steps": []}, False, time.perf_counter()
    for s in range(MOE_TRAIN_STEPS):
        batch = next(data)
        bs = [{k: torch.as_tensor(v, device=d) for k, v in batch.items()}
              for d in (dev, "cpu")]
        rec = {}
        if not parted:
            with record_routes(torch, moe) as log_c:
                loss_c, g_c = accum_grads(torch, registry, ckpt, cfg, p_gpu,
                                          bs[0], accum)
            with record_routes(torch, moe) as log_h:
                loss_h, g_h = accum_grads(torch, registry, ckpt, cfg, p_cpu,
                                          bs[1], accum)
            flip = next(((i, (gi != ci).any(-1), gap, tie) for i, (
                (gi, _, _), (ci, gap, tie)) in enumerate(zip(log_c, log_h))
                if not torch.equal(gi, ci)), None)
            rec["routing_calls"] = len(log_h)
            if flip is None:
                rel = abs(loss_c - loss_h) / abs(loss_h)
                rec["loss_rel"] = rel
                say(f"  {what} card vs CPU, step {s}: loss {loss_h:.5f}, rel "
                    f"{rel:.3g} (limit {TRAIN_LOSS_RTOL})" + (
                        f"; expert choices equal in all {len(log_h)} "
                        f"routing calls" if log_h else ""))
                check(rel <= TRAIN_LOSS_RTOL, f"{what} step {s}: loss {rel}")
                lm_leaves_close(f"{what} card vs CPU, step {s}", g_c, g_h,
                                rec)
            else:
                i, rows, gap, tie = flip
                worst = float((gap[rows] / tie[rows]).max())
                rec["routing_flip"] = {"call": i, "tokens": int(rows.sum()),
                                       "max_gap_over_tie": worst}
                say(f"  {what} card vs CPU, step {s}: routing call {i} chose "
                    f"other experts for {int(rows.sum())} tokens, the "
                    f"largest gap {worst:.3g} of its near-tie bound: not "
                    f"compared, nor the steps after it")
                check(worst <= 1, f"{what} step {s}: experts differ beyond "
                      f"a near-tie ({worst})")
                parted = True
            del g_c, g_h
        p_gpu, opts[0], m_c = step(p_gpu, opts[0], bs[0])
        p_cpu, opts[1], m_h = step(p_cpu, opts[1], bs[1])
        lc, lh = float(m_c["loss"]), float(m_h["loss"])
        rec.update(step_loss_card=lc, step_loss_cpu=lh)
        check(np.isfinite(lc) and np.isfinite(lh), f"{what}: losses {lc} "
              f"{lh}")
        if cfg.moe is not None and "aux" in m_c:
            rec["aux"] = float(m_c["aux"])
            check(rec["aux"] > 0, f"{what}: no MoE aux term")
        if not parted:
            check(abs(lc - lh) <= TRAIN_LOSS_RTOL * abs(lh),
                  f"{what} step {s}: step loss {lc} vs {lh}")
        out["steps"].append(rec)
    out["s"] = time.perf_counter() - t0
    say(f"  {what}: {MOE_TRAIN_STEPS} steps on both in {out['s']:.1f} s")
    del p_gpu, p_cpu, opts
    torch.cuda.empty_cache()
    return out


def moe_lane_tree(torch, cfg, dev, lane, gen):
    """A MoE config's tree in ``lane``: float32 drawn and quantized by
    ``quantize_lm_params`` (int8), or cast to the half type as each piece
    is drawn (``init_lm_params(dtype=)``: a full-width float32 tree and
    its half cast do not fit one card together)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.quant.ptq import quantize_lm_params
    if lane == "int8":
        return quantize_lm_params(tfm.init_lm_params(cfg, gen, dev))
    return tfm.init_lm_params(cfg, gen, dev,
                              dtype={"bf16": torch.bfloat16,
                                     "fp16": torch.float16}[lane])


def moe_lane(torch, cfg, dev, lane, fp32, count):
    """(B) One MoE serving lane at full published width and MOE_LAYERS
    layers (seed 0) through a warmed ``ServeEngine`` (float32 caches, as
    the launcher serves it): a plain and a mixed wave of LM_B x LM_T +
    LM_NEW, each with its launches (GQA: flash once a layer a prefill and
    decode once a layer a step, at the half type in a half tree;
    ``int8_matmul`` twice a layer a prefill and a step in the int8 lane;
    MLA: none), no steady first use, the weight GB, prefill and
    decode-step ms against the byte bound of the weights at the lane's
    bytes, peak memory, finite prefill logits (gated but at fp16, whose
    range a seeded model may leave) and greedy agreement with phase 23's
    float32 tokens (printed, not gated)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.quant import qtensor as qt
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    name = f"{cfg.name} {lane}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = moe_lane_tree(torch, cfg, dev, lane,
                           torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"weight_gb": qt.tree_bytes(params) / 1e9,
           "init_s": time.perf_counter() - t0}
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=LM_B, max_len=LM_MAX_LEN, buckets=(LM_T,),
        device=str(dev)))
    n_spans = LM_T // (cfg.mixed_res.window * cfg.mixed_res.downsample)
    mask = np.zeros(n_spans, np.int32)
    mask[:n_spans // 2] = 1
    out["warmup_keys"] = eng.warmup(plan_space=[(n_spans // 2, 0, BETA)])
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    steps, gqa = LM_NEW - 1, cfg.mla is None
    suf = {"bf16": "bf16", "fp16": "f16"}.get(lane)
    want = {"flash_attention": cfg.n_layers if gqa else 0,
            "decode_attention": cfg.n_layers * steps if gqa else 0,
            "int8_matmul": 2 * cfg.n_layers * (1 + steps) if lane == "int8"
            else 0}
    for kind, wmask in (("plain", None), ("mixed", mask)):
        dispatch.reset_launch_counts()      # this lane's wave starts here
        first, tokens = lm_wave(eng, cfg, prompts, mask=wmask)
        launches = dispatch.launch_counts()  # ... and ends here
        at_half = dispatch.launch_counts(suf) if suf else launches
        count(f"{name}{' mixed' if wmask is not None else ''}", launches)
        check(all(launches[k] == n for k, n in want.items())
              and sum(launches.values()) == sum(want.values())
              and (suf is None or all(at_half[k] == launches[k] for k in
                                      ("flash_attention",
                                       "decode_attention"))),
              f"{name} {kind}: launches {launches}, at {suf} {at_half}, "
              f"want {want}")
        out[kind] = {"first_s": first, "tokens": tokens,
                     "launches": {k: v for k, v in launches.items() if v}}
    times = lm_phase_times(torch, eng, cfg, prompts, None, False)
    check(eng.stats.steady_compiles == 0,
          f"{name}: steady first uses {eng.stats.steady_compile_keys}")
    step_gb = decode_weight_bytes(cfg, params) / 1e9
    with torch.no_grad():
        toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                               device=dev)
        h, _, _ = registry.prefill(cfg, params, {"tokens": toks},
                                   eng._state(LM_B))
        finite = bool(torch.isfinite(tfm.logits_from_hidden(
            cfg, params, h[:, -1:])).all())
        del h
    if lane != "fp16":
        check(finite, f"{name}: non-finite prefill logits")
    ref = fp32[cfg.name]
    same = sum(a == b for g, w in zip(out["plain"]["tokens"],
                                      ref["plain"]["tokens"])
               for a, b in zip(g, w))
    out.update(times, decode_weight_gb=step_gb,
               bound_ms=step_gb * 1e9 / PEAK_BYTES * 1e3,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               logits_finite=finite, steady_compiles=0,
               token_agreement_with_fp32=same / (LM_B * LM_NEW))
    say(f"  {name}: weights {out['weight_gb']:.2f} GB (drawn in "
        f"{out['init_s']:.2f} s; a step reads {step_gb:.2f} GB: byte bound "
        f"{out['bound_ms']:.2f} ms); prefill {times['prefill_ms']:.2f} ms "
        f"(float32 {ref['plain']['prefill_ms']:.2f}), decode "
        f"{times['decode_step_ms']:.2f} ms/step (float32 "
        f"{ref['plain']['decode_step_ms']:.2f}); peak {out['peak_gb']:.2f} "
        f"GB; 0 steady first uses; prefill logits "
        f"{'finite' if finite else 'NOT finite'}; greedy tokens equal to "
        f"phase 23's float32 {same} of {LM_B * LM_NEW} (not gated)")
    say(f"    launches plain {out['plain']['launches']}, mixed "
        f"{out['mixed']['launches']}" + ("" if gqa else " (MLA's attention "
                                         "is einsums, the experts bmm: no "
                                         "kernel on this path)"))
    del eng, params
    torch.cuda.empty_cache()
    return out


def moe_lane_card_vs_cpu(torch, cfg, dev, lane):
    """The narrow config (``moe_narrow``, seed SEED + 3) in ``lane`` on
    the card and, through the plain versions, on the CPU: the half tree
    drawn with ``init_lm_params(dtype=)`` byte-equal to ``cast_tree`` of
    the float32 draws, then prefill and 8 teacher-forced decode steps,
    plain, held by :func:`hold_routes` to LANE_RTOL."""
    from repro_torch.models import transformer as tfm
    from repro_torch.offload.simulator import to_device
    from repro_torch.quant import qtensor as qt
    narrow = moe_narrow(cfg)
    torch.set_num_threads(os.cpu_count() or 1)
    p_gpu = moe_lane_tree(torch, narrow, dev, lane,
                          torch.Generator(device=dev).manual_seed(SEED + 3))
    out = {}
    if lane != "int8":
        ref = qt.cast_tree(tfm.init_lm_params(
            narrow, torch.Generator(device=dev).manual_seed(SEED + 3), dev),
            p_gpu["embed"]["tok"].dtype)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_tensors(p_gpu), tree_tensors(ref)))
        check(same, f"{narrow.name} {lane}: the tree cast as drawn differs "
              f"from cast_tree of the float32 draws")
        out["cast_as_drawn_equal"] = True
        del ref
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, narrow.vocab_size, (2, LM_T + 8)))
    out.update(hold_routes(
        torch, f"{narrow.name} narrow {lane}, card vs CPU",
        forced_logits(torch, narrow, p_gpu, dev, toks, LM_T),
        forced_logits(torch, narrow, p_cpu, "cpu", toks, LM_T),
        LANE_RTOL[lane]))
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return out


def last_lanes_phase(torch, dev, count, moe_fp32):
    """Phase 25: (A) whisper-medium (WHISPER_TRAIN_LAYERS + as many encoder
    layers) and llava-next-mistral-7b
    (LLAVA_TRAIN_LAYERS of 32) trained at full width (:func:`mm_train`)
    and their narrow configs card vs CPU over two steps; (B)
    dbrx-132b's bf16, fp16 and int8 lanes and deepseek-v2-236b's bf16 and
    fp16 lanes at full width and MOE_LAYERS depth (:func:`moe_lane`), the
    launcher's refusal of deepseek-v2's int8 lane, and each lane's narrow
    config card vs CPU; (C) the narrow MoE configs' train steps card vs
    CPU at accum 1 and 2.  Full-width MoE training does not fit one card
    in float32 with AdamW (16 bytes a parameter): dbrx-132b at one layer
    holds 4.49 G parameters (71.9 GB before activations), deepseek-v2 at
    its dense layer and one MoE layer 5.35 G (85.6 GB); it waits for
    FSDP over four cards (ROADMAP.md, Queue 1, the mesh item)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.dbrx_132b import CONFIG as DBRX
    from repro_torch.configs.deepseek_v2_236b import CONFIG as DSV2
    from repro_torch.launch import serve as ls

    t_phase = time.perf_counter()
    say(f"phase 25: the LM families' last lanes: whisper-medium "
        f"({WHISPER_TRAIN_LAYERS} + {WHISPER_TRAIN_LAYERS} layers) and "
        f"llava-next-mistral-7b ({LLAVA_TRAIN_LAYERS} layers) training, the "
        f"MoE {MOE_LANES} serving lanes at {MOE_LAYERS} layers, narrow MoE "
        f"train steps")
    whisper, llava = (get_config("whisper-medium"),
                      get_config("llava-next-mistral-7b"))
    out = {"whisper-medium": mm_train(
               torch, cut_depth(whisper, WHISPER_TRAIN_LAYERS), dev, count,
               WHISPER_TRAIN_B, WHISPER_TRAIN_T),
           "llava-next-mistral-7b": mm_train(
               torch, llava.replace(n_layers=LLAVA_TRAIN_LAYERS), dev, count,
               LLAVA_TRAIN_B, LLAVA_TRAIN_T)}
    out["train_card_vs_cpu"] = {
        c.name: train_card_vs_cpu(torch, narrow_config(c, MM_NARROW[c.name]),
                                  dev, 1, t)
        for c, t in ((whisper, WHISPER_TRAIN_T), (llava, LLAVA_TRAIN_T))}
    out["t_a_s"] = time.perf_counter() - t_phase

    lanes = {}
    for c in (DBRX, DSV2):
        cut = c.replace(n_layers=MOE_LAYERS)
        for lane in MOE_LANES:
            if lane == "int8" and c.mla is not None:
                try:
                    ls.main(["--arch", c.name, "--quant", "int8"])
                except NotImplementedError as e:
                    lanes[f"{c.name} int8"] = {"refused": str(e)}
                    say(f"  {c.name} int8: the launcher refuses before any "
                        f"weight is drawn: {e}")
                    continue
                check(False, f"{c.name} int8: the launcher did not refuse")
            lanes[f"{c.name} {lane}"] = moe_lane(torch, cut, dev, lane,
                                                 moe_fp32, count)
    for c in (DBRX, DSV2):
        for lane in MOE_LANES:
            if lane == "int8" and c.mla is not None:
                continue
            lanes[f"{c.name} {lane}"]["card_vs_cpu"] = moe_lane_card_vs_cpu(
                torch, c, dev, lane)
    out["moe_lanes"] = lanes
    out["t_b_s"] = time.perf_counter() - t_phase - out["t_a_s"]

    out["moe_train_card_vs_cpu"] = {
        f"{c.name} accum {a}": train_card_vs_cpu(
            torch, moe_narrow(c), dev, MOE_TRAIN_B, MOE_TRAIN_T, a)
        for c in (DBRX, DSV2) for a in (1, 2)}
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 25: {out['phase_s']:.1f} s ((A) {out['t_a_s']:.1f}, (B) "
        f"{out['t_b_s']:.1f})")
    return out


# ---------------------------------------------------------------------------
# the kernel autotuner (phase 26)


def tile_key(tile) -> str:
    return json.dumps(tile, sort_keys=True)


def grid_rows(torch, kernel, name, grid, default, run, want, close,
              bucket=None):
    """Phase 26 (a): every tile of ``grid`` through ``run(tile)`` against
    the plain result ``want`` (``close`` raises past the kernel's limit),
    each timed (device us by CUDA events, best of TILE_REPS, the
    candidates in turns, each launch queued behind a spin kernel: the
    sweep's timer); prints each beside the default, the fastest here and
    the winner the warmups cached for ``bucket``."""
    from repro_torch.kernels import autotune
    errs = []
    for tile in grid:
        got = run(tile)
        torch.cuda.synchronize()
        errs.append(close(f"phase 26: {name} {tile}", got, want))
    times = autotune.time_candidates(
        [lambda t=t: run(t) for t in grid], TILE_REPS)
    rows = [{"tile": t, "max_abs_err": e, "us": us}
            for t, e, us in zip(grid, errs, times)]
    by = {tile_key(r["tile"]): r["us"] for r in rows}
    fast = min(rows, key=lambda r: r["us"])["tile"]
    cached = autotune.lookup(kernel, bucket) if bucket else None
    say(f"  {name}: " + "; ".join(
        f"{r['tile']} {r['us']:.2f} us" for r in rows)
        + f" | default {default} {by[tile_key(default)]:.2f} us, fastest "
        f"{fast}" + (f", cached winner {cached} "
                     f"{by[tile_key(cached)]:.2f} us" if cached else
                     (", no cached winner" if bucket else "")))
    return {"candidates": rows, "default": default, "fastest": fast,
            "cached_winner": cached, "bucket": bucket}


def tile_checks(torch, dev):
    """Phase 26 (a): every candidate tile of the four swept kernels held
    against the plain version under the kernel's existing limit (1e-4 at
    float32 attention, 1e-5 at decode, one ULP at >= 99% equal at half,
    bit-equal int8), at ViTDet-L's full-resolution shapes (window and
    flash at float32, fp16 and bf16; the int8+fp16-p1 GEMMs at M = 8192)
    and Qwen3-4B's decode step, and at the other phase-2 rows' shapes
    (flash at dbrx's G = 6 and phase 24 / 25's, decode at dbrx's, phi4's,
    deepseek-7b's and whisper's steps, the LM GEMMs at M = 8): their
    times give PERF.md's winners."""
    from repro_torch.configs.dbrx_132b import CONFIG as DBRX
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.configs.vitdet_l import CONFIG as VIT
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import autotune
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.window_attention import ops as win
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    part = vb.vit_partition(VIT)
    w2, H, Dh = part.window ** 2, VIT.n_heads, VIT.head_dim
    T = part.grid_h * part.grid_w
    out = {}

    def attn_close(tol):
        return lambda n, got, want: agree(torch, n, got, want, tol)[0]

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in (torch.float32, torch.float16, torch.bfloat16):
        suf = {torch.float32: "f32", torch.float16: "f16",
               torch.bfloat16: "bf16"}[dt]
        # window: the fused QKV's column views, as a full-res wave has them
        qkv = rnd((B, T, 3 * H * Dh), dt)
        q, k, v = (qkv[..., i * H * Dh:(i + 1) * H * Dh].view(B, T, H, Dh)
                   for i in range(3))
        out[f"window_attention vit {suf}"] = grid_rows(
            torch, "window_attention", f"window_attention vit {suf} "
            f"({B}, {T}, {H}, {Dh}) w2={w2}",
            win.tile_grid(B, T, H, Dh, w2), win.DEFAULT_TILE,
            lambda t: win.window_attention_cuda(q, k, v, w2, **t),
            win.window_attention_plain(q, k, v, w2), attn_close(ATTN_TOL),
            autotune.window_bucket(B, T, H, Dh, w2, dt))
        out[f"flash_attention vit {suf}"] = grid_rows(
            torch, "flash_attention", f"flash_attention vit {suf} "
            f"({B}, {T}, {H}, {Dh})", flash.tile_grid(Dh, dt),
            flash.default_tile(Dh, dt),
            lambda t: flash.flash_attention_cuda(q, k, v, False, **t),
            flash.flash_attention_plain(q, k, v, False),
            attn_close(ATTN_TOL),
            autotune.flash_bucket(B, T, T, H, H, Dh, False, dt))
        del qkv, q, k, v
        # flash at dbrx-132b's causal prefill (G = 6), and (float32) the
        # shapes of phases 24 and 25
        shapes = {"dbrx": (LM_B, LM_T, LM_T, 48, 8, 128, True)}
        if dt == torch.float32:
            shapes.update(FLASH_MM)
        for nm, (b, t, s_, h, kv, dh, causal) in shapes.items():
            q, k, v = rnd((b, t, h, dh), dt), rnd((b, s_, kv, dh), dt), \
                rnd((b, s_, kv, dh), dt)
            out[f"flash_attention {nm} {suf}"] = grid_rows(
                torch, "flash_attention", f"flash_attention {nm} {suf} "
                f"({b}, {t}, {s_}, {h}/{kv}, {dh}) causal={causal}",
                flash.tile_grid(dh, dt), flash.default_tile(dh, dt),
                lambda t_, q=q, k=k, v=v, c=causal:
                flash.flash_attention_cuda(q, k, v, c, **t_),
                flash.flash_attention_plain(q, k, v, causal),
                attn_close(ATTN_TOL),
                autotune.flash_bucket(b, t, s_, h, kv, dh, causal, dt))
        # decode: Qwen3-4B's step (its kernels-line row) and the others'
        names = ("serving", "dbrx") + (("phi4", "deepseek7b", "whisper")
                                       if dt == torch.float32 else ())
        sms = dec.sm_count(dev)
        for nm in names:
            (b, S, h, kv, dh), lens = DECODE_SHAPES[nm]
            q, k, v = rnd((b, 1, h, dh), dt), rnd((b, S, kv, dh), dt), \
                rnd((b, S, kv, dh), dt)
            kl = torch.tensor(lens, dtype=torch.int32, device=dev)
            out[f"decode_attention {nm} {suf}"] = grid_rows(
                torch, "decode_attention", f"decode_attention {nm} {suf} "
                f"({b}, {S}, {h}/{kv}, {dh}) kv_len {lens[0]}",
                dec.tile_grid(b, kv, h // kv, S, sms),
                dec.default_tile(b, kv, h // kv, S, sms),
                lambda t_, q=q, k=k, v=v, kl=kl:
                dec.decode_attention_cuda(q, k, v, kl, **t_),
                dec.decode_attention_plain(q, k, v, kl),
                attn_close(DECODE_TOL),
                autotune.decode_bucket(b, S, h, kv, dh, dt))
        torch.cuda.empty_cache()

    def same(n, got, want):
        check(torch.equal(got, want), f"{n}: kernel differs from plain")
        return 0.0

    gemms = [(f"vit {K}x{N}", GEMM_M, K, N, torch.float16)
             for K, N in GEMM_SHAPES]
    gemms += [(f"qwen3-4b {n}", LM_B, K, N, torch.float32)
              for n, K, N in lm_gemms(QWEN)]
    D = DBRX.d_model
    gemms += [(f"dbrx-132b {n} M={M}", M, K, N, torch.float32)
              for n, K, N in (("qkv", D, DBRX.q_dim + 2 * DBRX.kv_dim),
                              ("o", DBRX.q_dim, D))
              for M in (LM_B, LM_B * LM_T)]
    for nm, M, K, N, odt in gemms:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8).t()
        sx = torch.rand(M, generator=gen, device=dev) * 0.02 + 1e-3
        sw = torch.rand(N, generator=gen, device=dev) * 0.02 + 1e-3
        out[f"int8_matmul {nm}"] = grid_rows(
            torch, "int8_matmul", f"int8_matmul {nm} ({M}, {K}, {N}) -> "
            f"{str(odt).replace('torch.', '')}", i8.TILE_GRID,
            {"bn": i8.tile_n(N, K)},
            lambda t_, xq=xq, wq=wq, sx=sx, sw=sw, odt=odt:
            i8.int8_matmul_cuda(xq, wq, sx, sw, odt, **t_),
            i8.int8_matmul_plain(xq, wq, sx, sw, odt), same,
            autotune.matmul_bucket(M, N, K, torch.int8, torch.int8))
    return out


def vit_ab_server(torch, cfg, dev, spec):
    """Phase 26: an 8-block full-width ViTDet-L ``ServerModel`` (seed 0;
    ``spec`` a QuantSpec tuple or None), warmed at full resolution for
    B buckets 1 and 2, and its full-resolution wave's forward."""
    from repro_torch import convert
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.quant.ptq import QuantSpec
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    srv = ServerModel(cfg, params, b_buckets=(1, 2), device=dev,
                      quant=QuantSpec(*spec) if spec else None)
    del params
    space = [(0, 0, 0, 0)]
    srv.warmup(space, (1, 2))
    imgs = torch.rand((B, *cfg.vit.img_size, 3), generator=gen, device=dev)

    def fwd():
        from repro_torch.core import vit_backbone as vb
        with torch.no_grad():
            return vb.forward_det(srv.cfg, srv.params, imgs)
    return srv, space, fwd


def flat_out(torch, o):
    """The tensors of a forward's outputs (nested tuples / lists / dicts;
    other leaves skipped) as one float32 vector."""
    if isinstance(o, torch.Tensor):
        return o.float().reshape(-1)
    if isinstance(o, dict):
        o = list(o.values())
    if not isinstance(o, (list, tuple)):
        return torch.zeros(0, device="cuda")
    return torch.cat([flat_out(torch, x) for x in o])


def ab_time(torch, fn, reps=AB_REPS):
    """Host ms (median of ``reps`` calls, each synchronised) and device ms
    (the kernels' device time in a trace of two calls) of ``fn``, and
    its output."""
    o = fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    dev_us = kernel_breakdown(torch, fn, ("",), 2)[""]
    return statistics.median(host), dev_us / 1e3, o


def autotune_phase(torch, dev, count):
    """Phase 26, the kernel autotuner: (a) every candidate tile against
    the plain version (:func:`tile_checks`); (b) an 8-block full-width
    ViTDet-L server (float32) and a 4-layer full-width Qwen3-4B engine,
    warmed, then after ``clear_memory_cache`` warmed again: 0 sweeps and
    the same winners from disk; (c) with ``REPRO_AUTOTUNE=0`` every
    lookup gives the default tile; (d) A B B A, the default tiles (A,
    ``REPRO_AUTOTUNE=0``) against the tuned ones (B): full-resolution
    waves of the float32, bf16 and int8+fp16-p1 servers and a decode
    step, host and device ms, the tuned outputs within the card-vs-CPU
    limits of the default ones (phases 4, 6, 8 and 21 ran card vs CPU
    at the tuned tiles); the host cost of a lookup.  Fails if any
    candidate of any sweep of the run raised."""
    from repro_torch import convert
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.configs.vitdet_l import CONFIG as VIT
    from repro_torch.kernels import autotune
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.window_attention import ops as win
    from repro_torch.models import registry
    t_phase = time.perf_counter()
    out = {"warmups": {**autotune.STATS,
                       "launches": dict(autotune.SWEEP_LAUNCHES)},
           "cache": str(autotune.cache_path())}
    say(f"phase 26: the kernel autotuner (cache {autotune.cache_path()}); "
        f"the run's warmups swept {autotune.STATS['sweeps']} buckets, "
        f"{autotune.STATS['candidates']} candidates in "
        f"{autotune.STATS['sweep_s']:.2f} s (+ {autotune.STATS['inputs_s']:.2f}"
        f" s making inputs), launches {json.dumps(autotune.SWEEP_LAUNCHES)}")
    t0 = time.perf_counter()
    out["tiles"] = tile_checks(torch, dev)
    out["tiles_s"] = time.perf_counter() - t0
    say(f"  (a) {len(out['tiles'])} shapes, every candidate within its "
        f"limit: {out['tiles_s']:.1f} s")

    # (b) servers and an engine, warmed twice
    t0 = time.perf_counter()
    cut = VIT.replace(n_layers=8)
    lanes = {}
    for name, spec in (("float32", None), ("bf16", ("bf16", "fp32", 0)),
                       ("int8+fp16-p1", ("int8", "fp16", 1))):
        lanes[name] = vit_ab_server(torch, cut, dev, spec)
    qcut = QWEN.replace(n_layers=4)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(qcut, gen, device=dev)
    eng, _ = lm_engine(torch, qcut, params, dev)
    del params
    state = eng._state(LM_B)
    toks = eng._tokens(np.ones((LM_B, 1)))
    step = eng._get_decode(LM_B)

    def decode_step():
        with torch.no_grad():
            return step(toks, LM_T, state)

    part = lanes["float32"][0].part
    w2, T = part.window ** 2, part.grid_h * part.grid_w
    sms = dec.sm_count(dev)

    def tiles():
        """The tiles the A/B workloads resolve, per lane."""
        r = {}
        for name, (srv, _, _) in lanes.items():
            c, dt = srv.cfg, srv.act_dtype
            r[f"{name} window"] = win.tile_for(B, T, c.n_heads, c.head_dim,
                                               w2, dt)
            r[f"{name} flash"] = flash.tile_for(B, T, T, c.n_heads,
                                                c.n_heads, c.head_dim,
                                                False, dt)
            if name.startswith("int8"):
                for K, N in GEMM_SHAPES[1:]:
                    r[f"{name} gemm {K}x{N}"] = i8.tile_for(B * T, N, K)
        r["qwen3-4b decode"] = dec.tile_for(
            LM_B, LM_MAX_LEN, QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim,
            torch.float32, sms)
        return r

    won = tiles()
    disk = autotune.cache_path().read_text()
    autotune.clear_memory_cache()
    sweeps = autotune.STATS["sweeps"]
    for srv, space, _ in lanes.values():
        srv.warmup(space, (1, 2))
    eng.warmup()
    again = tiles()
    check(autotune.STATS["sweeps"] == sweeps, f"phase 26 (b): the second "
          f"warmup swept {autotune.STATS['sweeps'] - sweeps} buckets")
    check(again == won, f"phase 26 (b): winners {won} then {again}")
    check(autotune.cache_path().read_text() == disk,
          "phase 26 (b): the second warmup changed the cache file")
    out["winners"] = won
    out["second_warmup_sweeps"] = autotune.STATS["sweeps"] - sweeps
    say(f"  (b) second warmup after clear_memory_cache: 0 sweeps, the same "
        f"winners from disk: {json.dumps(won)}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (c) and (d): the default tiles with REPRO_AUTOTUNE=0
    def defaults(on):
        if on:
            os.environ[autotune.ENV_VAR] = "0"
        else:
            os.environ.pop(autotune.ENV_VAR, None)
        autotune.refresh_from_env()

    defaults(True)
    try:
        dflt = tiles()
        want = {}
        for name, (srv, _, _) in lanes.items():
            c, dt = srv.cfg, srv.act_dtype
            want[f"{name} window"] = win.DEFAULT_TILE
            want[f"{name} flash"] = flash.default_tile(c.head_dim, dt)
            if name.startswith("int8"):
                for K, N in GEMM_SHAPES[1:]:
                    want[f"{name} gemm {K}x{N}"] = {"bn": i8.tile_n(N, K)}
        want["qwen3-4b decode"] = dec.default_tile(
            LM_B, QWEN.n_kv_heads, QWEN.n_heads // QWEN.n_kv_heads,
            LM_MAX_LEN, sms)
        check(dflt == want, f"phase 26 (c): REPRO_AUTOTUNE=0 resolves "
              f"{dflt}, not the defaults {want}")
        check(autotune.tune_decode(LM_B, LM_MAX_LEN, QWEN.n_heads,
                                   QWEN.head_dim, KV=QWEN.n_kv_heads,
                                   device=dev) is None
              and autotune.STATS["sweeps"] == sweeps,
              "phase 26 (c): a sweep ran with REPRO_AUTOTUNE=0")
    finally:
        defaults(False)
    out["defaults"] = dflt
    say(f"  (c) REPRO_AUTOTUNE=0: every lookup the default: "
        f"{json.dumps(dflt)}")

    rtol = {"float32": E2E_RTOL, **HALF_E2E_RTOL, "qwen3-4b": LM_RTOL}
    work = {f"vit {n} full-res wave": (fn, n) for n, (_, _, fn)
            in lanes.items()}
    work["qwen3-4b decode step"] = (decode_step, "qwen3-4b")
    ab = {}
    for wname, (fn, lane) in work.items():
        runs = {}
        for tag in ("A", "B", "B", "A"):
            defaults(tag == "A")
            try:
                h, d, o = ab_time(torch, fn)
            finally:
                defaults(False)
            runs.setdefault(tag, []).append((h, d, flat_out(torch, o)))
        a, b = runs["A"][0][2], runs["B"][0][2]
        err = float((b - a).abs().max() / a.abs().max().clamp_min(1e-30))
        check(bool(torch.isfinite(b).all()) and err <= rtol[lane],
              f"phase 26 (d) {wname}: tuned vs default {err} > "
              f"{rtol[lane]}")
        ab[wname] = {tag: [(h, d) for h, d, _ in r]
                     for tag, r in runs.items()}
        ab[wname]["rel_err"] = err
        say(f"  (d) {wname}: default host / device ms "
            + ", ".join(f"{h:.3f} / {d:.3f}" for h, d, _ in runs["A"])
            + "; tuned " + ", ".join(f"{h:.3f} / {d:.3f}"
                                     for h, d, _ in runs["B"])
            + f"; tuned vs default {err:.3g} of the largest (limit "
            f"{rtol[lane]})")
    out["ab"] = ab

    # the host cost of a lookup in steady state (a memo hit)
    n = 100000
    t = time.perf_counter()
    for _ in range(n):
        dec.tile_for(LM_B, LM_MAX_LEN, QWEN.n_heads, QWEN.n_kv_heads,
                     QWEN.head_dim, torch.float32, sms)
    out["lookup_us"] = (time.perf_counter() - t) / n * 1e6
    say(f"  a lookup in steady state: {out['lookup_us']:.3f} us on the "
        f"host (memo hit, {n} calls)")
    check(not autotune.FAILURES, f"phase 26: candidates raised in a sweep: "
          f"{autotune.FAILURES}")
    out["sweep_log"] = autotune.SWEEP_LOG
    del lanes, eng, state
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 26: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the device mesh (phase 27)


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _tree_equal(torch, what, got, want):
    """Every leaf bit-equal (shapes and dtypes too); the names that differ
    and their largest relative difference otherwise."""
    check(set(got) == set(want),
          f"{what}: leaves {sorted(set(got) ^ set(want))}")
    bad = {}
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            d = (g.float() - w.float()).abs().max() if g.shape == w.shape \
                else float("inf")
            bad[k] = float(d) / max(float(w.float().abs().max()), 1e-30)
    check(not bad, f"{what}: {len(bad)} leaves not bit-equal, worst "
          f"{max(bad.items(), key=lambda kv: kv[1]) if bad else None}")


def mesh_train_steps(torch, dev, mesh, count, ckpt_dir, dtype=None):
    """Phase 27 (a): full-width Qwen3-4B cut to MESH_LAYERS layers (seed
    0), parameters at ``dtype`` (None: float32; AdamW moments float32),
    two steps of ``make_train_step(cfg, tc, mesh)`` on the (1, 1)
    mesh against two of the mesh-free step from a copy of the same tree:
    parameters and both moments bit-equal (every collective over one rank
    is the identity and ``gather_leaf`` returns the leaf itself); each
    step's host ms and the peak GB; with a ``ckpt_dir``, the mesh step's
    parameters saved with their shardings for (e)."""
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.build import FLOAT_SUFFIX
    from repro_torch.launch import train as lt
    from repro_torch.optim import adam
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as tr

    cfg = QWEN.replace(n_layers=MESH_LAYERS)
    data = lt.synthetic_batches(cfg, 1, LM_TRAIN_T, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                next(data).items()} for _ in range(2)]
    params = tr.registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev, dtype)
    copy = {k: v.clone() for k, v in ckpt.flatten(params).items()}
    tc = tr.TrainConfig(remat=True)
    tag = "" if dtype is None else f" {str(dtype)[6:]}"
    out = {"layers": MESH_LAYERS, "B": 1, "T": LM_TRAIN_T,
           "dtype": str(dtype or torch.float32)[6:]}
    runs = {}
    for name, m in (("mesh_free", None), ("mesh", mesh)):
        p = params if m is None else ckpt.unflatten(copy, params)
        if m is None:
            o = adam.init_adam(ckpt.flatten(p))
        else:
            p, o = tr.shard_train_state(cfg, m, p)
        step = tr.make_train_step(cfg, tc, m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        walls, losses = [], []
        for b in batches:
            t0 = time.perf_counter()
            p, o, met = step(p, o, b)
            losses.append(float(met["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = dispatch.launch_counts()
        if m is not None:
            count(f"lm_train qwen3-4b mesh (1, 1){tag}", launches)
        runs[name] = (p, o)
        out[name] = {"step_ms": walls, "losses": losses,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {k: v for k, v in launches.items() if v}}
        check(all(np.isfinite(losses)), f"phase 27 (a) {name}: {losses}")
        check(launches["flash_attention"] == 2 * 2 * MESH_LAYERS and
              sum(launches.values()) == launches["flash_attention"],
              f"phase 27 (a) {name}: launches {launches}")
        if dtype is not None:
            half = dispatch.launch_counts(FLOAT_SUFFIX[dtype])
            check(half["flash_attention"] == launches["flash_attention"],
                  f"phase 27 (a) {name}{tag}: half launches {half}")
        say(f"  (a) {name}{tag} step: {cfg.n_layers}-layer full-width "
            f"{cfg.name}, B=1, T={LM_TRAIN_T}, remat: losses "
            + " ".join(f"{x:.6f}" for x in losses) + "; host ms "
            + " ".join(f"{w:.1f}" for w in walls) + f"; peak "
            f"{out[name]['peak_gb']:.2f} GB; launches {out[name]['launches']}")
    (pf, of), (pm, om) = runs["mesh_free"], runs["mesh"]
    check(out["mesh"]["losses"] == out["mesh_free"]["losses"],
          f"phase 27 (a): losses {out['mesh']['losses']} vs "
          f"{out['mesh_free']['losses']}")
    _tree_equal(torch, "phase 27 (a) parameters", ckpt.flatten(pm),
                ckpt.flatten(pf))
    _tree_equal(torch, "phase 27 (a) first moments", om.m, of.m)
    _tree_equal(torch, "phase 27 (a) second moments", om.v, of.v)
    check(om.step == of.step == 2, f"steps {om.step} {of.step}")
    say(f"  (a) mesh step vs mesh-free step{tag}: {len(om.m)} parameters "
        f"and both moments bit-equal after 2 steps")
    del runs, pf, of, copy, params
    if ckpt_dir is None:
        return cfg, out, None
    named = shd.to_named(mesh, tr.train_shardings(cfg, mesh,
                                                  tr.shape_tree(cfg))[0])
    t0 = time.perf_counter()
    ckpt.save(pm, str(ckpt_dir), 2, named)
    out["save_s"] = time.perf_counter() - t0
    out["save_gb"] = sum(4 * v.numel() for v in ckpt.flatten(pm).values()) \
        / 1e9
    return cfg, out, ckpt.flatten(pm)


def mesh_moe_layer(torch, dev, mesh):
    """Phase 27 (b): one full-width dbrx-132b MoE layer in bf16 (16 x 6144
    x 10752 slabs, seed 0), a forward and a backward of sum(out * w) +
    aux through ``moe_sharded`` at ep = 1 against ``moe_local`` on the
    same inputs: outputs, aux and every gradient (slabs, router, x)
    bit-equal."""
    from repro_torch.configs.dbrx_132b import CONFIG as DBRX
    from repro_torch.models import moe
    from repro_torch.quant import qtensor as qt
    from repro_torch.train import checkpoint as ckpt

    cfg = DBRX
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = qt.cast_tree(moe.init_moe(cfg, gen, dev), torch.bfloat16)
    N = LM_B * LM_T
    x = torch.randn((LM_B, LM_T, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn((LM_B, LM_T, cfg.d_model), generator=gen, device=dev)
    res = {}
    for name in ("local", "sharded"):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in ckpt.flatten(p).items()}
        xs = x.clone().requires_grad_(True)
        tree = ckpt.unflatten(leaves, p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "local":
            o, aux = moe.moe_local(cfg, tree, xs)
        else:
            o, aux = moe.moe_sharded(cfg, tree, xs, mesh)
        (torch.sum(o.float() * w) + aux).backward()
        torch.cuda.synchronize()
        res[name] = {"out": o.detach(), "aux": aux.detach(),
                     "grads": {**{k: v.grad for k, v in leaves.items()},
                               "x": xs.grad},
                     "ms": (time.perf_counter() - t0) * 1e3}
        del leaves, xs, tree, o, aux
    loc, sh = res["local"], res["sharded"]
    check(torch.equal(sh["out"], loc["out"]) and
          torch.equal(sh["aux"], loc["aux"]),
          "phase 27 (b): moe_sharded's output or aux differs from moe_local")
    _tree_equal(torch, "phase 27 (b) gradients", sh["grads"], loc["grads"])
    out = {"tokens": N, "slab": [cfg.moe.n_experts, cfg.d_model,
                                 cfg.moe.d_ff_expert],
           "aux": float(loc["aux"]), "ms_local": loc["ms"],
           "ms_sharded": sh["ms"]}
    say(f"  (b) {cfg.name} MoE layer, bf16, {N} tokens, slabs "
        f"{tuple(out['slab'])}: moe_sharded (ep 1) vs moe_local: output, "
        f"aux {out['aux']:.6f} and {len(sh['grads'])} gradients bit-equal; "
        f"forward + backward {sh['ms']:.1f} / {loc['ms']:.1f} ms (first "
        f"calls)")
    del res, p
    return out


def mesh_psum(torch, dev):
    """Phase 27 (c): ``compressed_psum`` over the one-rank world against
    ``quantize_roundtrip`` on the card, with an error carried in: mean
    and new error bit-equal (a 64M-element gradient)."""
    import torch.distributed as dist
    from repro_torch.optim import grad_compression as gc
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    x = torch.randn((1 << 26,), generator=gen, device=dev)
    err = torch.randn((1 << 26,), generator=gen, device=dev) * 1e-3
    mean, e1 = gc.compressed_psum(x, dist.group.WORLD, err)
    deq, e2 = gc.quantize_roundtrip(x, err)
    check(torch.equal(mean, deq) and torch.equal(e1, e2),
          "phase 27 (c): compressed_psum differs from quantize_roundtrip")
    say(f"  (c) compressed_psum on one rank vs quantize_roundtrip, "
        f"{x.numel()} elements: mean and error bit-equal")
    return {"elements": x.numel()}


def mesh_pipeline(torch, dev):
    """Phase 27 (d): the GPipe forward on a 1-stage mesh against the
    sequential stack, 8 tanh layers at Qwen3-4B's width, 4 microbatches
    (2e-5, as ``tests/test_pipeline.py``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import pipeline as pl
    d = 2560
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    params = {"w": torch.randn((8, d, d), generator=gen, device=dev)
              / d ** 0.5,
              "b": torch.randn((8, d), generator=gen, device=dev) * 0.01}
    x = torch.randn((8, 128, d), generator=gen, device=dev)

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("stage",))
    y = pl.pipeline_forward(mesh, layer, params, x, 4)
    want = x
    for i in range(8):
        want = layer({k: v[i] for k, v in params.items()}, want)
    err = float((y - want).abs().max())
    check(err <= 2e-5 * (1 + float(want.abs().max())),
          f"phase 27 (d): pipeline vs sequential {err}")
    say(f"  (d) 1-stage GPipe forward (8 layers of {d}, 4 microbatches) vs "
        f"the sequential stack: max abs diff {err:.3g} (bubble "
        f"{pl.bubble_fraction(4, 1):.2f})")
    return {"max_abs_err": err}


def mesh_restart(torch, cfg, dev, ckpt_dir, want):
    """Phase 27 (e): ``elastic_restart`` over the one-rank world from (a)'s
    checkpoint of the mesh step's parameters (with both moments the
    round trip moves three times the bytes, and rank 0 hashes each on
    one thread; the moments' sharded round trip is
    ``tests/test_torch_mesh.py``'s and ``tests/test_torch_mesh_card.py``'s):
    a (1, 1) mesh planned, every restored leaf bit-equal."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic
    from repro_torch.train import trainer as tr
    like = ckpt.unflatten({k: torch.empty(0, device=dev) for k in want},
                          tr.shape_tree(cfg))

    def shardings(m):
        return shd.to_named(m, tr.train_shardings(cfg, m,
                                                  tr.shape_tree(cfg))[0])

    t0 = time.perf_counter()
    mesh, p = elastic.elastic_restart(cfg, str(ckpt_dir), [0], 1,
                                      lambda: like, shardings,
                                      device_type=dev.type)
    wall = time.perf_counter() - t0
    check(shd.mesh_shape(mesh) == {"data": 1, "model": 1},
          f"phase 27 (e): mesh {shd.mesh_shape(mesh)}")
    _tree_equal(torch, "phase 27 (e) parameters", ckpt.flatten(p), want)
    say(f"  (e) elastic_restart on the one-rank world from (a)'s "
        f"checkpoint: {len(want)} parameters bit-equal; restore "
        f"{wall:.1f} s")
    return {"restore_s": wall}


def mesh_phase(torch, dev, count):
    """Phase 27, the device mesh at world size 1: an NCCL process group of
    one rank in this process (a free local port), the (1, 1) mesh, then
    (a) to (e); the group is destroyed at the end, and a failure in any
    part fails the run."""
    import gc

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say("phase 27: the device mesh at world size 1 (NCCL, (1, 1) mesh): "
        "sharded train step, expert-parallel MoE, compressed psum, GPipe, "
        "elastic restart")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    ckpt_dir = ROOT / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        mesh = mesh_lib.make_local_mesh(1, 1)
        out = {}
        cfg, out["train"], want = mesh_train_steps(torch, dev, mesh, count,
                                                   ckpt_dir)
        say(f"  (a) the parameters ({out['train']['save_gb']:.2f} GB) saved "
            f"with their shardings in {out['train']['save_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        _, out["train_bf16"], _ = mesh_train_steps(torch, dev, mesh, count,
                                                   None, torch.bfloat16)
        gc.collect()
        torch.cuda.empty_cache()
        out["moe"] = mesh_moe_layer(torch, dev, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        out["psum"] = mesh_psum(torch, dev)
        out["pipeline"] = mesh_pipeline(torch, dev)
        out["restart"] = mesh_restart(torch, cfg, dev, ckpt_dir, want)
        del want
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 27: {out['phase_s']:.1f} s")
    return out


def dryrun_cell_check(torch, dev, count, cfg, dt, measured):
    """Phase 28 (a) and (b) at parameter type ``dt`` (the docstring of
    :func:`dryrun_phase`); ``measured``: phase 27's step ms at ``dt``."""
    import gc

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.build import FLOAT_SUFFIX
    from repro_torch.launch import costing, dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs as sp
    from repro_torch.launch import train as lt
    from repro_torch.roofline import model as rm
    from repro_torch.train import trainer as tr

    suf = FLOAT_SUFFIX[dt]
    tc = tr.TrainConfig(remat=True)
    out = {}
    # (a) the card's step under FlopCounterMode
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_local_mesh(1, 1)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(
            lt.synthetic_batches(cfg, 1, LM_TRAIN_T, seed=SEED)).items()}
        params = tr.registry.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
            None if dt == torch.float32 else dt)
        p, o = tr.shard_train_state(cfg, mesh, params)
        del params
        step = tr.make_train_step(cfg, tc, mesh)
        dispatch.reset_launch_counts()
        with FlopCounterMode(display=False) as fc:
            p, o, met = step(p, o, batch)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        count("lm_train qwen3-4b dry-run check"
              + ("" if dt == torch.float32 else f" {suf}"), launches)
        card_flops = fc.get_total_flops()
        check(np.isfinite(float(met["loss"])), f"phase 28 (a) {suf}: loss "
              f"{float(met['loss'])}")
        check(launches["flash_attention"] == 2 * MESH_LAYERS
              == dispatch.launch_counts(suf)["flash_attention"],
              f"phase 28 (a) {suf}: launches {launches}")
        del p, o, step, batch, met
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_local_mesh(1, 1, device_type="cpu")
        cell = sp.build_cell_from(
            cfg, ShapeSpec("phase27", LM_TRAIN_T, 1, "train"), mesh,
            accum=1, dtype=dt)
        cost, mem = costing.cell_cost(cell)
    trace_s = time.perf_counter() - t0
    check(cell.dtype == dt, f"phase 28 (b): cell {cell.dtype}, step {dt}")
    attn = cost.regions.get("kernel:flash_attention",
                            {"flops": 0.0, "bytes": 0.0})
    outside = cost.flops - attn["flops"]
    out["flops"] = {"card_flop_counter": card_flops,
                    "dryrun_total": cost.flops,
                    "dryrun_flash_forward": attn["flops"],
                    "dryrun_outside_flash": outside}
    say(f"  (a) {suf} GEMM FLOPs: card FlopCounterMode {card_flops:.6e}; "
        f"dry-run {cost.flops:.6e} of which the flash forward's plain "
        f"version {attn['flops']:.6e} ({attn['flops'] / cost.flops:.3f}), "
        f"outside it {outside:.6e}; dry-run trace {trace_s:.1f} s")
    check(outside == card_flops, f"phase 28 (a) {suf}: dry-run FLOPs "
          f"outside the flash forward {outside} != the card's {card_flops}")
    say(f"  (a) {suf}: dry-run GEMM FLOPs outside the flash forward equal "
        "the card's FlopCounterMode exactly")

    # (b) the roofline beside phase 27's measured step at this type
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_fwd = 2 * MESH_LAYERS                   # remat runs each forward twice
    kernel_b = n_fwd * costing.kernel_attn_bytes(
        "prefill", 1, LM_TRAIN_T, LM_TRAIN_T, H, KV, Dh, dt.itemsize)
    flash_bytes = cost.bytes - attn["bytes"] + kernel_b
    terms = rm.roofline_terms(flops_per_device=cost.flops,
                              bytes_per_device=cost.bytes,
                              collective_bytes_per_device=cost.coll,
                              n_chips=1, compute_dtype=cell.dtype)
    t_mem_flash = flash_bytes / rm.HBM_BW
    crit_ms = max(terms["t_compute"], t_mem_flash) * 1e3
    out["roofline"] = {**terms, "t_memory_flash_kernel": t_mem_flash,
                       "bytes_flash_kernel": flash_bytes,
                       "measured_step_ms": measured,
                       "ratio_measured_to_bound": measured / crit_ms,
                       "memory": dataclasses.asdict(mem)}
    say(f"  (b) {suf} roofline (H100 {rm.peak_flops(cell.dtype):.3g} "
        f"FLOP/s at {suf}, {rm.HBM_BW:.3g} B/s): t_compute "
        f"{terms['t_compute'] * 1e3:.3f} ms, t_memory "
        f"{terms['t_memory'] * 1e3:.3f} ms (plain attention bytes "
        f"{cost.bytes:.4e}), {t_mem_flash * 1e3:.3f} ms with the flash "
        f"kernel's bytes ({flash_bytes:.4e}); phase 27's measured {suf} "
        f"step {measured:.1f} ms, {measured / crit_ms:.2f}x the larger of "
        f"t_compute and the flash t_memory; dry-run peak "
        f"{mem.peak_bytes / 1e9:.2f} GB")
    return out


def dryrun_phase(torch, dev, count, step_ms, step_ms_bf16):
    """Phase 28, the dry-run against the card, on phase 27's cell (the
    MESH_LAYERS-layer full-width Qwen3-4B train step at B=1,
    T=LM_TRAIN_T with remat, on the (1, 1) mesh), at float32 and at bf16
    parameters (the dry-run's train cells' type, as the reference's):
      (a) the step run once on the card under ``FlopCounterMode`` (an
          NCCL group of one rank) against ``launch.dryrun``'s count of
          the same cell (``build_cell_from(dtype=)``) on a fake group of
          one rank: the dry-run's GEMM FLOPs outside the flash kernel's
          plain forward (which the card runs in its kernel, out of the
          counter's sight) equal the card's exactly; the attention's
          share is printed apart;
      (b) the dry-run's roofline terms (H100 constants, the FLOPs at the
          peak of the cell's type: float32 67 TFLOP/s with TF32 off, bf16
          989) beside phase 27's measured step ms at that type (its
          second step), and their ratio, not gated; bytes also with the
          flash kernel's analytic traffic in place of the plain
          forward's;
      (c) one production cell, qwen3-4b decode_32k on the 256-rank
          ``pod1`` mesh, and its terms."""
    import gc

    from repro_torch.configs import SHAPES
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    say("phase 28: the dry-run (fake-tensor count, H100 roofline) against "
        f"the card on phase 27's cell")
    cfg = QWEN.replace(n_layers=MESH_LAYERS)
    out = {"layers": MESH_LAYERS, "B": 1, "T": LM_TRAIN_T}
    for dt, measured in ((torch.float32, step_ms[-1]),
                         (torch.bfloat16, step_ms_bf16[-1])):
        out[str(dt)[6:]] = dryrun_cell_check(torch, dev, count, cfg, dt,
                                             measured)
        gc.collect()
        torch.cuda.empty_cache()

    # (c) one production cell
    t0 = time.perf_counter()
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", False)
    check(rec["status"] == "ok", f"phase 28 (c): {rec}")
    r = rec["roofline"]
    out["decode_32k_pod1"] = {k: rec[k] for k in (
        "n_chips", "memory", "collectives", "roofline", "model_flops",
        "useful_flop_ratio")}
    check(SHAPES["decode_32k"].global_batch == 128, "decode_32k batch")
    say(f"  (c) qwen3-4b decode_32k pod1 ({rec['n_chips']} ranks, "
        f"{time.perf_counter() - t0:.1f} s): t_compute "
        f"{r['t_compute'] * 1e3:.4f} ms, t_memory "
        f"{r['t_memory'] * 1e3:.3f} ms, t_collective "
        f"{r['t_collective'] * 1e3:.3f} ms, bound {r['bound']}; "
        f"{rec['memory']['total_with_donation'] / 1e9:.2f} GB a device")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 28: {out['phase_s']:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
