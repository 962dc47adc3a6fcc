"""Chip smoke test of the PyTorch/CUDA port (focal_tpu_torch) on one card.

    python3 chip_smoke.py [--out DIR]

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):
  1. print the card's name and power limit (nvidia-smi); build every kernel
     from the sources in this checkout (nvcc, one run per source);
  2. kernel #1 vs plain: fused_window_block against its plain PyTorch
     version on the card at every MOD SW_Transformer block geometry (batch
     128), shifted and unshifted, max abs error <= 1e-4 (the kernel's
     3xTF32 products and the plain f32 ones differ in summation order);
  3. the serving path: the MOD SW_Transformer at full width (seeded random
     init) served by focal_tpu_torch.serve.Predictor over ~1,000 synthetic
     samples at batch 128 (ragged tail included): probabilities finite and
     summing to 1, #1 launched 16 times per batch (and no other kernel),
     and the first batch equal (atol 1e-5) to the same model run with the
     plain block on the card;
  4. timing of #1 with CUDA events after warm-up at each geometry (the
     kernel over at least 20 ms of calls): kernel,
     plain version, a library yardstick (matmul + scaled_dot_product_attention
     + matmul, never called by the port) and the bound from the geometry's
     FLOP and byte counts; plus the Predictor's windows/s and p50 batch
     latency;
  5. a torch.profiler trace of one served batch: device busy time, idle
     share, device operations and the device kernels by time; #1's device
     time by phase, failing the run if any window_block.cu kernel but the
     row-tiled forward's products and its attention without dropout ran;
  6. kernels #2 and #3 vs plain at every block geometry of the training
     batch (256 samples, two views fused to 512): #2's output against the
     plain forward fed #2's own keep mask (1e-4 absolute), #2's keep rate
     within 5 sigma of 1 - attn_drop_rate per launch, #3's six gradients
     (with #2's mask, and without a mask) against autograd of the plain
     version as max|kernel - plain| / max|plain| <= 1e-4 (long f32 sums)
     and the same bits on a second call, #3 given the weights' [out, in]
     copies as the Swin block gives them;
  7. the training path: FOCAL pretrain steps of the MOD SW_Transformer at
     full width (flax-style init, seed 0, batch 256, synthetic data resident
     on the card, a fixed idx as bench.py uses): warm-up, then timed steps
     with #2 and #3 launched 16 times per step each (no other kernel),
     losses and parts finite; ms per step (p50), samples/s and attention
     windows/s, peak device memory; one step with every drop rate at 0 from
     the trained state, through the kernels and through the plain versions:
     loss within 1e-5 relative and every parameter's gradient within
     max|delta| / max|plain| <= 1e-4;
  8. timing of #2 and #3 at each training geometry: kernel, plain, library
     (scaled_dot_product_attention with dropout; the autograd backward of
     the library block), the bounds on the f32 CUDA cores, on the TF32
     tensor cores (3 passes) and by the bytes the design moves
     (design_bytes), TFLOP/s; then five profiled calls of each of #2 and
     #3 at every training geometry, which fail the run if any device
     kernel they launch is not one of csrc/window_block.cu's, their time
     split by kernel name into GEMM, attention, weight gradient and
     reduction;
  9. a torch.profiler trace of one training step (#2/#3's device time in
     it by phase), the step beside the one with the per-window #2/#3
     (PARENT_STEPS);
 10. kernels #4 and #5 vs plain at every per-head block geometry of
     MOD_WIDE (C 512 and 1024, 4 heads) at the wide training batch (64
     samples, views fused to 128): #4 at rate 0 (1e-4 absolute), #4 with
     dropout against the plain forward fed its own mask (1e-4 absolute,
     keep rate within 5 sigma), #4's mask equal to #2's bit for bit at
     every per-head geometry (#2 launches at C = 1024 too), #5's six
     gradients with #4's mask and without (1e-4 relative) and the same bits
     on a second call;
 11. the training entry point: python -m focal_tpu_torch.train at MOD_WIDE
     (256 synthetic samples, batch 64, 1 epoch, validation every epoch)
     run in-process, then -resume to epoch 2: finite losses, a validation
     point before the resume and one after, the _latest/_best/_resume files; per
     step #2 and #3 launched 4 times (stage 0) and #4 and #5 12 times, per
     eval forward #1 4 times and #4 12 times, nothing else;
 12. MOD_WIDE pretrain steps timed as phase 7 times MOD's (batch 64, 3
     warm-up + 3 timed; #2/#3 4 per step, #4/#5 12 per step), the rate-0
     kernels-vs-plain step held to phase 7's tolerances from the initial
     state (and from the trained state, reported but not held: AdamW at lr
     1e-3 grows the 184M-parameter model's attention logits, so any f32
     summation order moves its loss; C3),
     and a torch.profiler trace of one step (#2-#5's device time in it by
     phase); p50, samples/s, idle share and peak memory printed beside the
     step with the per-window #2/#3 (PARENT_STEPS);
 13. timing of #4 and #5 at each per-head geometry (kernel, plain, library,
     bounds and TFLOP/s as phase 8 times #2 and #3; #4 at rate 0, and #1
     beside it at C = 512), #2 and #3 at MOD_WIDE stage 0 as phase 8; then
     the profiled calls of phase 8 for #2/#3 at stage 0 and for #4/#5 at
     every per-head geometry;
 14. kernels #13 (fused_conv_tower) and #14 (fused_conv_tower_backward) vs
     plain at every conv-tower geometry of the DeepSense pretrain step: MOD
     (batch 256, views fused to 512: R 5,120 rows of S 20, C 64) and
     MOD_WIDE (batch 128 fused to 256, C 256), seismic (first conv inside,
     KW 3, Cin 2) and audio (first conv outside, KW 5): output, batch means
     and variances <= 1e-5 relative, the five gradients <= 1e-4 relative
     (absolutely to 1e-2 where both are below 1e-2: conv biases before a
     BatchNorm), the same bits on a second call;
 15. DeepSense pretrain steps (flax-style init, synthetic data resident on
     the card), MOD_WIDE at batch 128 (views fused to 256; 3 warm-up + 3
     timed) and MOD at batch 256 (3 + 5), on the default path (cuDNN
     convs, no kernel launched) and with -pallas_conv (#13 11 and #14 20
     launches a step at either): p50, samples/s, peak memory and a
     profiled step's idle share, device busy time and #13/#14's share of
     it; a dropout-0 MOD step, kernels vs plain, from the initial state
     (loss 1e-5, gradients 1e-4 relative, running statistics 1e-5) and
     from the trained one (reported);
 16. the entry point: python -m focal_tpu_torch.train -dataset MOD -model
     DeepSense -pallas_conv -synthetic in-process, 2 epochs with validation,
     then -resume to 3: finite losses, the three checkpoint files with the
     running statistics, #13/#14 launches only in the steps (eval forwards
     launch nothing); then Predictor serves the _best file over ~1,000
     synthetic samples at batch 128 (no kernel launched);
 17. timing of #13 and #14 per tower geometry (kernel, plain version, the
     unfused cuDNN chain and its autograd backward as the library
     yardstick, the bounds on the f32 CUDA cores and on the TF32 tensor
     cores (3 passes)), summed over a MOD and a MOD_WIDE step; then five
     profiled calls of each at every geometry, which fail the run if a
     device kernel other than csrc/conv_tower.cu's and PyTorch's own
     [C]-sized steps between the wrappers' calls runs, their device time
     split by kernel ([profile-tower]: products, weight gradients,
     elementwise passes, reductions, the first conv on the CUDA cores);
 18. kernels #10 (fused_mlp_forward), #11 (fused_mlp_dropout_forward) and
     #12 (fused_mlp_backward) vs plain at every MLP geometry on the fused
     route: MOD at batch 128 (C 64/128/256, 16 blocks) and MOD_WIDE stage 0
     (C 256, batch 64 fused to 128): #10, and #11 fed its own masks
     (mlp_keep_masks), <= 1e-4 absolute; #12's five gradients with the
     masks and without <= 1e-4 relative; each mask's keep rate within 5
     sigma of 0.8; the same bits on a second call;
 19. MOD supervised steps at batch 128 (fixed pool: mixup, phase_shift):
     3 warm-up + 5 timed on the default path (#2/#3 16 a step, no MLP
     kernel) and with -pallas_mlp (#2, #3, #11, #12 16 each), p50,
     samples/s, peak memory, a profiled step's idle share, top device
     kernels and #10-#12's device time by phase; the -pallas_mlp step
     beside the one with the CUDA-core #10-#12 (PARENT_STEPS); a rate-0
     step from the initial state, kernels (#1, #3, #10, #12 16 each) vs
     plain: loss 1e-5 relative, gradients 1e-4;
 20. the entry points in-process at MOD with -pallas_mlp and -synthetic (256
     samples): supervised 2 epochs, -resume to 3, focal_tpu_torch.test on
     its _best; FOCAL pretrain 1 epoch, finetune 2 epochs, -resume to 3,
     test: the launches per step (finetune: #2 and #11 only, the backbone
     frozen) and per eval forward (#1 and #10 16 each) held exactly, every
     backbone entry of the finetuned files bitwise the pretrained one,
     class_layer and mod_fusion_layer moved; Predictor -pallas_mlp over
     ~1,000 samples (#1 and #10 16 a batch), its probabilities within 1e-5
     of phase 3's (the cuBLAS MLP, same weights);
 21. timing of #10, #11 and #12 per geometry (kernel, plain version, the
     cuBLAS chain addmm -> GELU -> addmm with F.dropout for #11 and its
     autograd backward for #12 as the library yardstick, the bounds on the
     f32 CUDA cores and on the TF32 tensor cores (3 passes), TFLOP/s), then
     profiled calls of each at every geometry (at least 5 and 20 ms of
     them), which fail the run if
     any device kernel they launch is not one of csrc/fused_mlp.cu's, their
     time split by kernel name (hidden and output products, masked
     gradient, weight gradient, reduction);
 22. the attention-only kernels (-no_pallas_block) vs plain at every
     attention geometry: MOD at the served batch (128) and the training
     batch (256, views fused to 512), MOD_WIDE's 16 blocks at 64 fused to
     128 (hd 64 to 256), shifted and unshifted: #6, and #7 fed its own mask
     (window_attention_keep_mask), <= 1e-4 absolute; #8, and #9 with the
     mask, every gradient <= 1e-4 relative (absolutely to 1e-6 where both
     sides are below it) and the same bits on a second call; #7's keep rate
     within 5 sigma of 0.8 and its mask equal to #2's (#4's where #2 does
     not launch) bit for bit at the same seed and geometry;
 23. MOD pretrain steps with -no_pallas_block at batch 256: 3 warm-up + 5
     timed (#7 and #9 16 a step, nothing of #1-#5), p50, samples/s, peak
     memory, a profiled step's idle share and top device kernels; a rate-0
     step from the initial state, kernels (#6 and #8 16 each) vs plain:
     loss <= 1e-5 relative, gradients <= 1e-4;
 24. the entry points in-process at MOD with -no_pallas_block -synthetic
     (256 samples): supervised 1 epoch, -resume to 2, test on its _best;
     FOCAL pretrain 1 epoch, finetune 1 epoch (#7 only: the backbone is
     frozen), test on its _best: launches per step and per eval forward (#6
     16) held exactly; then Predictor(pallas_block=False) over ~1,000
     samples (#6 16 a batch), its probabilities within 1e-5 of phase 3's
     (#1's route, same weights), and a torch.profiler trace of one served
     batch (#6's device time);
 25. timing of #6-#9 per geometry (kernel, plain version, the library
     yardstick F.scaled_dot_product_attention with the bias materialised as
     attn_mask, dropout_p for #7, its autograd backward for #8/#9, and the
     bound), summed over one served MOD forward (#6) and one MOD training
     step (#7, #9; #8 at rate 0); the kernels over at least 20 ms of calls
     each; then the backward of one Swin WindowAttention on the
     -no_pallas_block route profiled with the ops' shapes (MOD stage 0's
     training geometry): it fails if an aten stack or cat, or a copy of a
     window-sized gradient, runs (#9 writes d(qkv) [B_, N, 3C] as the qkv
     Linear takes it);
 26. the JAX package's ACIDS, PAMAP2 and RealWorld_HAR recipes as packaged
     (configs/{recipe}.yaml, full width, synthetic data, random init), each
     in turn: #1 vs plain at the served geometries (RealWorld_HAR's shifted
     blocks have 48 and 12 windows a sample, where the JAX package takes its
     XLA attention: ROADMAP C8), #2/#3 and #6-#9 at the training batch (256,
     views fused to 512), #10-#12 at the classifier batch (128) and #13/#14
     at the DeepSense towers (cin 6 at S 20 or 25 on the CUDA cores; S 41
     after ACIDS's strided first conv) by the gates of phases 2, 6, 14, 18
     and 22, #13/#14 timed per tower as phase 17 times them; then a served
     batch of 128 of each backbone (#1 once a block; DeepSense none), 3 + 5
     SW_Transformer pretrain steps at 256 (#2/#3 once a block a step; the
     rate-0 step from the initial state, kernels vs plain), 3 + 5 DeepSense
     -pallas_conv pretrain steps at 256 (#13/#14 over every tower; its rate-0
     step) and 3 + 5 -pallas_mlp supervised steps at 128 (#2, #3, #11, #12),
     the launches held exactly, p50, samples/s, peak memory and a profiled
     step's idle share;
 27. MOD copied with a second location (as the JAX package's
     tests/test_multi_location.py builds one) at full width: #13/#14 vs
     plain and timed at the mod_extractor tower (cin 1, kw 4 in every layer,
     S 128, C 64); for SW_Transformer (location context and fusion) and
     DeepSense -pallas_conv (mean over locations, the mod_extractor towers)
     a served batch and 3 + 5 pretrain steps with the launches held
     exactly, and each backbone's rate-0 step, kernels vs plain;
 28. the attribution arms, the sweep and the reference format at MOD's
     full width, in-process through the entry points, on a synthetic split
     of 2 full steps of 256 and a tail of 3 subsequences (524 samples):
     #2/#3 and #13/#14 vs plain at the tail step's geometries (12 samples,
     views fused to 24; phases 6 and 14's gates) and timed and profiled
     there as phases 8 and 17 do; the tail step at rate 0
     from the initial state, kernels vs plain, for SW_Transformer (#1/#3;
     phase 26's gates) and DeepSense -pallas_conv (#13/#14; phase 15's,
     running statistics included); 3 + 5 full and tail steps of each
     timed from one state (launches held a step); python -m
     focal_tpu_torch.train -ragged_tail for 2 epochs of SW_Transformer (with
     -py_aug_draws -ref_lr_timing: #2/#3 16 x 3 x 2, #1 16 an eval forward;
     the table's shape and each epoch's lr printed) and of DeepSense
     -pallas_conv (#13 11 x 3 x 2, #14 20 x 3 x 2); a split whose tail is
     one subsequence runs its 2 full steps alone; both pretrained backbones
     exported to the reference format (python -m
     focal_tpu_torch.export_torch) and imported back bitwise; a -pallas_mlp
     supervised run from the SW_Transformer import through -init_weight
     (#2, #3, #11, #12 a step; #1, #10 an eval forward); python -m
     focal_tpu_torch.sweep finetuning it over -ratios 0.1,1.0 (#2 a step,
     #1 an eval forward) and printing its table;
 29. -compute_dtype bfloat16 at MOD's full width: #1-bf16
     (fused_window_block_bf16) at the served geometries (batch 128),
     #2-bf16 and #3-bf16 at the training ones (256 fused to 512), against
     their bf16 plain versions on the same bf16 inputs: y within 8e-3 of
     max|y|, #2-bf16 fed its own mask, its keep rate within 5 sigma, #3-bf16
     with the mask and without, every gradient within 1e-2 relative
     (absolutely to TINY_GRAD where both sides are below it), the same bits
     on a second call; each timed (events over >= 20 ms, device time split
     by kernel; plain, the library yardstick in bf16, the bound at 989
     TFLOP/s or the bf16 bytes); python -m focal_tpu_torch.train
     -compute_dtype bfloat16 in-process: pretrain -ragged_tail 2 epochs
     (#2-bf16/#3-bf16 16 a step, #1-bf16 16 an eval forward), supervised 1
     epoch and the test CLI on its _best, launches held exactly; a served
     bf16 batch of 128 (#1-bf16 16) against the bf16 plain block (1e-2); a
     rate-0 pretrain step at 256 from one state, bf16 kernels against f32
     (loss 1e-2 relative) and against the bf16 plain versions (loss 1e-2),
     gradients f32; 3 + 5 bf16 and f32 MOD pretrain steps from one init
     beside each other (p50, samples/s, peak memory, idle share, device
     time by window_block.cu phase, top kernels); the rate-0 step's
     gradients held to the CPU step test's gates (C11: each tensor's cosine
     >= 0.9 to the bf16 plain versions', the median relative error <= 5e-2,
     the worst tensor named; the tensors of true gradient 0 absolutely to
     1e-2);
 30. DeepSense at -compute_dtype bfloat16: #13-bf16 and #14-bf16
     (fused_conv_tower_bf16, fused_conv_tower_backward_bf16) against the
     bf16 plain tower (its f32 steps in float64) at every tower geometry of
     MOD, MOD_WIDE, ACIDS, PAMAP2, RealWorld_HAR and the two-location
     mod_extractor, masks of rate 0.2: the output within 8e-3 of max|a|, the
     statistics 1e-3, the gradients 1e-2 relative (absolutely to 1e-2 where
     both sides are below it), the same bits on a second call, the launches
     counted; conv_tower.cu's build: its bf16 products (ct_wg_*) compiled
     to wgmma (HGMMA) and no mma.sync (HMMA), no wgmma pipeline serialized;
     timed at MOD's geometries beside #13/#14 in f32 and the cuDNN bf16
     chain (events, device time by kernel, plain, bound at 989 TFLOP/s for
     the convs or the bf16 bytes), the profile holding the products on
     wgmma and no f32-only kernel (W's per-tap transpose, a sum walked on
     one SM: F32_ONLY_TOWER); a served bf16 batch of 128 (no
     kernel) against the same model on the CPU (1e-2); rate-0 pretrain (256)
     and supervised (128) steps from one init: -pallas_conv's kernels
     against their bf16 plain versions (loss 1e-2, C11's gradient gates),
     the cuDNN route's bf16 step against its f32 step (loss 1e-2); python -m
     focal_tpu_torch.train -pallas_conv -compute_dtype bfloat16 for 1 epoch
     with its launches held; 3 + 5 MOD pretrain steps at 256 of both
     routes, bf16 beside f32 from one init (p50, device busy, idle share,
     device operations, peak memory);
 31. MOD_WIDE at -compute_dtype bfloat16: #4-bf16 and #5-bf16
     (fused_window_block_perhead_bf16, fused_window_block_perhead_backward_bf16)
     against their bf16 plain versions (those of #1-#3) at every per-head
     geometry of the wide training batch (stages 1 and 2, C 512 and 1024,
     shifted and unshifted), #4-bf16 at rate 0 and 0.2 (fed its own mask:
     its keep rate within 5 sigma, the mask #2's), #5-bf16 with the mask and
     without, phase 29's gates, the same bits on a second call; timed there
     (events, device time by kernel, plain, cuBLAS bf16 + SDPA bf16 under
     autograd, the bound at 989 TFLOP/s or the bf16 bytes); 3 + 3 MOD_WIDE
     pretrain steps at batch 64, bf16 beside f32 from one init (#2-bf16 and
     #3-bf16 4, #4-bf16 and #5-bf16 12 a step: p50, device busy, idle share,
     device operations, peak memory); the rate-0 bf16 step, kernels against
     the bf16 plain versions (loss 1e-2, C11's gradient gates; the median
     relative error to 1.25x the plain versions' own floor, f32 against
     float64 sums in the same run, where that is above 5e-2: C14); python -m
     focal_tpu_torch.train -dataset MOD_WIDE -compute_dtype bfloat16 for an
     epoch and a served MOD_WIDE bf16 batch (against the bf16 plain block,
     1e-2), the launches held exactly;
 32. -pallas_mlp at -compute_dtype bfloat16: #10-bf16, #11-bf16 and #12-bf16
     (fused_mlp_forward_bf16, fused_mlp_dropout_forward_bf16,
     fused_mlp_backward_bf16) against their bf16 plain versions at every
     MLP geometry of MOD (batch 128) and MOD_WIDE's stage 0 (64 fused to
     128): y within 8e-3 of max|y|, #11-bf16 fed #11's masks (keep rates
     within 5 sigma), #12-bf16 with them and without, gradients 1e-2
     relative, the same bits on a second call; timed there (the library
     bf16 addmm -> GELU -> addmm); 3 + 5 MOD bf16 supervised steps at 128
     on the cuBLAS-MLP route and with -pallas_mlp from one init (#11-bf16
     and #12-bf16 16 a step); the rate-0 -pallas_mlp bf16 step, kernels
     against the bf16 plain versions (loss 1e-2, C11's gates); the
     supervised entry point for an epoch and the test CLI on its _best, and
     a served batch (#10-bf16 16) against the bf16 plain route (1e-2), the
     launches held exactly;
 33. -no_pallas_block at -compute_dtype bfloat16: #6-bf16 to #9-bf16
     (fused_window_attention_bf16, fused_window_attention_dropout_bf16,
     fused_window_attention_backward_bf16,
     fused_window_attention_dropout_backward_bf16) against their bf16 plain
     versions at every attention geometry of MOD's served batch (128) and
     training step (256 fused to 512), q unscaled with q_scale as the route
     passes it: y within 8e-3 of max|y|, #7-bf16 fed #7's mask (keep rate
     within 5 sigma; the weights it drops, read through a one-hot v, #7's
     mask bit for bit), #8-bf16/#9-bf16 every gradient within 1e-2
     relative, the same bits on a second call; timed there (events, device
     time, plain, SDPA in bf16 with a bf16 attn_mask under autograd, the
     bound: the products at the bf16 peak, the rest at the f32 one, or the
     bf16 bytes); 3 + 5 MOD -no_pallas_block
     pretrain steps at 256, bf16 beside f32 from one init (#7-bf16/#9-bf16
     16 a step, no whole-block kernel; p50, device busy, idle share, device
     operations, peak); the rate-0 bf16 step, kernels (#6-bf16/#8-bf16 16
     each) against the bf16 plain versions (loss 1e-2, C11's gates); python
     -m focal_tpu_torch.train -no_pallas_block -compute_dtype bfloat16 for
     an epoch; a served bf16 batch (#6-bf16 16) against the bf16 plain route
     (1e-2); a bf16 WindowAttention at C 12 (no kernel takes it) forward and
     backward on the card, launching nothing.
 34. #4-TP and #5-TP (fused_window_block_tp, fused_window_block_tp_backward:
     #4/#5's CUDA code at a tensor-parallel shard's inner width D = C / mp)
     against their plain versions at every local geometry of MOD's and
     MOD_WIDE's stages at mp 2 and 4 (131 windows, rate 0 and the recipe's):
     y within 1e-4, every gradient within 1e-4 relative, the backward's bits
     again on a second call; at rate 0 the shards' y (bproj once) and dx
     summed against #4/#5 at full heads, each shard's weight gradients
     against their slices, 1e-4 relative; timed on one of two shards of a
     MOD pretrain step (events, device time, plain, cuBLAS + SDPA at the
     local geometry under autograd, the bound at 3 TF32 products an f32 one);
     the data-parallel rows (the JAX package's DP wrappers: the existing
     kernels on a data shard's rows, DP-1-5: #2 + #3, DP-6-9: #7 + #9,
     DP-10-12: #11 + #12) timed the same way on one of two data shards, each
     forward within 1e-4 of its plain version;
 35. python -m focal_tpu_torch.train's main on MOD (one epoch, 256
     synthetic samples, batch 256) on two ranks sharing the card (gloo;
     the processes join from the FOCAL_DIST_* variables), at
     -data_parallel 2 and at -model_parallel 2, the launches counted in each
     rank; each layout's rate-0 SGD update (and at dp 2 the -no_pallas_block
     -pallas_mlp one) from the seed-0 init against the single-process update
     (loss 1e-4 relative; every entry within 3e-3 of itself + 1e-5 + its
     f32 rounding allowance, from the sums of |terms| of its gradient;
     a planted fault in one model shard's slice of a bias rejected);
     1 + 1 timed pretrain steps a layout (p50 and peak memory per rank, two
     ranks sharing one card: not multi-GPU speed), the launches held; one
     more step with its collectives timed apart. Then, with 1 + 1 timed
     steps each (run after phase 36): bf16 SW_Transformer at
     -model_parallel 2 (#4-TP-bf16/#5-TP-bf16; its finetune, supervised
     stage and test CLI after the pretraining, each holding its launches), DeepSense
     at -model_parallel 2 in f32 and bf16 (cuDNN convs: no kernel), and
     DeepSense -pallas_conv at -data_parallel 2 in f32 and bf16 (DP-13-14:
     #13/#14 writing raw BatchNorm sums, summed over the ranks); the f32
     updates held as above, the bf16 ones by C11's gates (loss 1e-2
     relative, each gradient's cosine >= 0.9, the median relative error <=
     5e-2); each layout's kernels launched by each timed step as by its
     rate-0 update, and no other;
 36. #4-TP-bf16 and #5-TP-bf16 (fused_window_block_tp_bf16, _backward_bf16)
     against their bf16 plain versions at every local geometry of MOD's and
     MOD_WIDE's stages at mp 2 and 4, at rate 0 and 0.2 (y within 8e-3 of
     max|y|, gradients within 1e-2 relative, each repeat the same bits, the
     keep rate within 5 sigma), at D = C the bits of #4-bf16/#5-bf16; timed
     on one of two shards of a MOD bf16 step; the conv tower's
     data-parallel form (raw sums, the statistics at the global count)
     against its plain version and timed over one of two data shards of a
     MOD DeepSense step, f32 and bf16.
     Phase 35 also runs python -m focal_tpu_torch.train at -data_parallel 2
     -data_layout sharded (each rank holding its rows of the train split),
     its entry point alone, each rank's launches held exactly; one pair of
     ranks runs every layout in turn.
 37. gradient accumulation: one GradCache update (-grad_accum 2) from the
     seed-0 init at the recipe's drop rates for MOD SW_Transformer f32
     (#2/#3), bf16 (#2-bf16/#3-bf16), -no_pallas_block (#7/#9), -pallas_mlp
     (#2/#3 and #11/#12), MOD_WIDE (#2/#3 at stage 0, #4/#5), DeepSense
     -pallas_conv f32 and bf16 (#13/#14, #13-bf16/#14-bf16), micro-batches
     of 128 (MOD_WIDE 16): pass 2's features bitwise pass 1's, the launches
     exactly 2 k forwards' and k backwards', DeepSense's BatchNorm buffers
     bitwise pass 1's chain (pass 2 folds none); the rate-0 GradCache update
     of 2 x 256 against the step over the 512 samples, kernels on both
     sides, the views the FFT (loss 1e-5 relative, gradients 1e-4); python -m
     focal_tpu_torch.train -dataset MOD -grad_accum 2 for an epoch of 1,024
     samples resident and with the train split streamed (-hbm_budget_gb
     1e-6, blocks of 3 steps from pinned memory on a side stream): launches
     exact and equal, validation points and parameters bit for bit the
     same.
 38. sample files: python -m focal_tpu_torch.preprocess.mod and .partition
     on raw CSVs of two allowlisted MOD recordings (samples of MOD's
     shapes, their labels, the index files); 2,048 MOD sample files (~133
     MB) read through the bulk loader (focal_tpu_torch/native, built with
     g++ here) and one file at a time: the same bits, both rates in MB/s;
     python -m focal_tpu_torch.train -dataset MOD -dataset_config <a recipe
     copy naming those files' index files> -gpu 0 -knn_backend jnp
     -profile_dir, 3 epochs at batch 256, in-process, then the same flags
     on a synthetic split resident on the card: finite
     validation points, the launches exact, one trace, of epoch 1, whose
     window_block.cu kernels are one epoch's #2/#3 exactly; wall and step
     p50 (CUDA events, the traced epoch left out) beside the synthetic
     run's, phase 11's wall and phase 7's p50.

Prints a {"kernels": [...]} line (#1-#14, #1-bf16 to #14-bf16, #4-TP/#5-TP,
#4-TP-bf16/#5-TP-bf16 and the data-parallel rows DP-1-5, DP-6-9, DP-10-12,
DP-13-14, DP-13-14-bf16), the
nvidia-smi line, and as its last line {"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX and
nothing of the JAX package. --out DIR writes the per-geometry details and
the profiles as JSON there.
"""

import argparse
import copy
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3;
# TF32 on the tensor cores (#4 and #5 run 3 TF32 products per f32 one)
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
SERVE_BATCH = 128
SERVE_SAMPLES = 1000
TRAIN_BATCH = 256         # samples per step; the two views run fused as 512
TRAIN_WARMUP = 3
TRAIN_STEPS = 5
WIDE_BATCH = 64           # MOD_WIDE samples per step; views fused to 128
WIDE_STEPS = 3
WIDE_SAMPLES = 256        # MOD_WIDE synthetic train split of the entry-point run
KERNEL_TOL = 1e-4
GRAD_TOL = 1e-4           # relative: max|kernel - plain| / max|plain|
SLICE_TOL = 1e-5
LOSS_TOL = 1e-5           # relative
PK = "focal_tpu/ops/pallas_kernels.py"
# the pretrain steps with the per-window #2 and #3, before they ran on the
# tensor cores (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_STEPS = {"MOD": {"p50_ms": 135.740, "idle_share": 0.256, "peak_mb": 6938.5},
                "MOD_WIDE": {"p50_ms": 210.455, "idle_share": 0.021, "peak_mb": 9716.9},
                # the -pallas_mlp MOD supervised step (batch 128) with #10-#12
                # on the CUDA cores
                "MOD_supervised_pallas_mlp": {"p50_ms": 102.901, "idle_share": 0.542,
                                              "peak_mb": 1043.5}}


def log(msg):
    print(msg, flush=True)


def kernel_of(ptxas_line):
    """The kernel a ptxas "Compiling entry function" line names, read from
    its mangled name (a length-prefixed identifier ending in _kernel, with
    its bool or int template arguments and its source tag: <true>,
    <128, true, false>, <64, FusedMlpSrc>). The last such identifier is
    the kernel's: an anonymous namespace's hash may also end in one."""
    found = [(int(m.group(1)), m.group(2))
             for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", ptxas_line)]
    for n, ident in reversed(found):
        if len(ident) >= n and ident[:n].endswith("_kernel"):
            rest = ident[n:]
            if not rest.startswith("I"):
                return ident[:n]
            args = [{"1": "true", "0": "false"}[v] if k == "b" else v
                    for k, v in re.findall(r"L([bi])(\d+)E", rest)]
            args += [t[:int(k)] for k, t in re.findall(r"(?=(\d+)([A-Za-z_]\w*))", rest)
                     if t[:int(k)].endswith("Src")]
            return f"{ident[:n]}<{', '.join(args)}>"
    return ptxas_line.strip()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def block_geometries(cfg, batch):
    """Every distinct (stage, shifted) launch geometry of the forward, over
    every location and modality, with how many times one forward makes it
    (locations or modalities of one geometry share it)."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.models.swin import block_geometry, shifted_window_mask

    sw = cfg["SW_Transformer"]
    geos = {}
    for loc in cfg["location_names"]:
        for mod in cfg["modality_names"]:
            geo = mod_geometry(cfg, loc, mod)
            for stage, ((H, W), C) in enumerate(geo["stages"]):
                depth = geo["block_num"][stage]
                kinds = {}  # (wh, ww, shifted) -> [sh, sw, blocks]; no mask -> shifts unused
                for i in range(depth):
                    shift = [0, 0] if i % 2 == 0 else [w // 2 for w in geo["window"]]
                    wh, ww, sh, sws, shifted = block_geometry((H, W), geo["window"], shift)
                    kinds.setdefault((wh, ww, shifted), [sh, sws, 0])[2] += 1
                for (wh, ww, shifted), (sh, sws, count) in kinds.items():
                    key = (H, W, C, wh, ww, sh, sws, shifted)
                    if key in geos:
                        geos[key]["per_forward"] += count
                        continue
                    nW = (H // wh) * (W // ww)
                    geos[key] = {
                        "name": f"{mod}/stage{stage}/{'shifted' if shifted else 'plain'}",
                        "H": H, "W": W, "C": C, "heads": sw["time_freq_head_num"],
                        "N": wh * ww, "nW": nW, "windows": batch * nW,
                        "mask": shifted_window_mask(H, W, wh, ww, sh, sws) if shifted else None,
                        "per_forward": count,
                    }
    return list(geos.values())


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tc_bound(flops, nbytes):
    """The bound of #2-#5 on the units they run on: 3 TF32 products an f32
    one (3xTF32) at the tensor cores' TF32 peak, or the bytes."""
    return 1e3 * max(3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def design_bytes(g, backward, sms):
    """Bytes that #2-#5 as designed move, each workspace written once and
    read once a phase: forward x -> qkv, qkv -> ao, ao -> y (10 C floats a
    row); backward x, dy -> qkv, g; qkv, g -> dqkv, ao; dqkv -> dx; x,
    dqkv, ao, dy -> the weight gradients (24 C); the keep mask, the weights
    and, in the backward, the split partials written and read (the split
    count as csrc/window_block.cu's bwd_plan sets it on ``sms`` SMs). What
    the algorithm needs is work()/work_backward()'s count."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    R = B * N
    keep = B * H * N * N
    if not backward:
        return 4 * (10 * R * C + 4 * C * C + 4 * C + H * N * N) + keep
    bn = 128 if C % 128 == 0 else 64  # the tile width (tile_bn)
    wtiles = -(-C // 128) * (-(-3 * C // bn) + -(-C // bn))
    splits = max(1, min(-(-4 * sms // wtiles), -(-R // 256)))
    rps = -(-R // splits)
    rps = -(-rps // 32) * 32
    E = 4 * C * C + 4 * C
    return 4 * (24 * R * C + 7 * C * C + 3 * C + 2 * H * N * N + 2 * -(-R // rps) * E + E) + keep


def work(g):
    """#1 (and #4 at rate 0): FLOPs and bytes of one launch (projections +
    attention; each input read once and the output written once) and its
    bound."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    flops = B * (8 * N * C * C + 4 * N * N * C)
    elems = 2 * B * N * C + 4 * C * C + 4 * C + H * N * N
    if g["mask"] is not None:
        elems += g["nW"] * N * N
    nbytes = 4 * elems
    return (flops, nbytes) + bound(flops, nbytes)


def work_dropout(g):
    """#2 (and #4 with dropout): #1's work plus writing the uint8 keep mask."""
    flops, nbytes, _, _ = work(g)
    nbytes += g["windows"] * g["heads"] * g["N"] ** 2
    return (flops, nbytes) + bound(flops, nbytes)


def work_backward(g, with_keep):
    """#3 (and #5): FLOPs = B_ (22 N C^2 + 12 N^2 C): qkv recompute 6NC^2,
    dx 6NC^2, dWqkv 6NC^2, d(attn out) 2NC^2, dWproj 2NC^2; attention
    12 N^2 C (scores, attention output, d(attention), dv, dq, dk: 2 N^2 C
    each). Bytes: x, dy, dx, the keep mask, the weights, bias table and
    shift mask once, and the gradients once."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    flops = B * (22 * N * C * C + 12 * N * N * C)
    elems = 3 * B * N * C + 2 * (4 * C * C + 4 * C + H * N * N)
    if g["mask"] is not None:
        elems += g["nW"] * N * N
    nbytes = 4 * elems + (B * H * N * N if with_keep else 0)
    return (flops, nbytes) + bound(flops, nbytes)


def make_inputs(torch, g, gen, dev):
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = rnd(B, N, C)
    wqkv = rnd(C, 3 * C, scale=C**-0.5)
    bqkv = rnd(3 * C, scale=0.1)
    wproj = rnd(C, C, scale=C**-0.5)
    bproj = rnd(C, scale=0.1)
    rel_bias = rnd(H, N, N, scale=0.02)
    mask = None if g["mask"] is None else torch.from_numpy(g["mask"]).to(dev)
    return x, wqkv, bqkv, wproj, bproj, rel_bias, mask


def time_ms(torch, fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_block(torch, x, wqkv, bqkv, wproj, bproj, attn_mask, H, dropout_p=0.0):
    """Yardstick only: the same function through cuBLAS and PyTorch's
    scaled_dot_product_attention (q is pre-scaled, so scale=1)."""
    B, N, _ = x.shape
    D = wqkv.shape[1] // 3  # C, or a tensor-parallel shard's heads
    qkv = torch.matmul(x, wqkv).add_(bqkv).reshape(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(
        qkv[0], qkv[1], qkv[2], attn_mask=attn_mask, dropout_p=dropout_p, scale=1.0)
    return torch.matmul(o.transpose(1, 2).reshape(B, N, D), wproj).add_(bproj)


def library_mask(torch, g, rel_bias, mask):
    B = g["windows"]
    attn_mask = rel_bias[None].expand(B, -1, -1, -1)
    if mask is not None:
        attn_mask = attn_mask + mask[torch.arange(B, device=mask.device) % g["nW"]][:, None]
    return attn_mask.contiguous()


def library_backward_ms(torch, g, args, dy, rate):
    """The autograd backward of the library block (the bias-table gradient
    flows through its attention mask), timed."""
    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    leaves = [t.clone().requires_grad_(True) for t in (x, wqkv, bqkv, wproj, bproj)]
    am = library_mask(torch, g, rel_bias, mask).requires_grad_(True)
    out = library_block(torch, *leaves, am, g["heads"], rate)
    ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves + [am], dy, retain_graph=True))
    del out
    return ms


def time_training(torch, pk, fwd, bwd, names, g, gen, dev, rate, sms, tag):
    """The training forward ``fwd`` (#2 or #4, with dropout) and backward
    ``bwd`` (#3 or #5) at geometry g, stored in g: kernel, plain version and
    library yardstick times; the f32 bound (work_dropout, work_backward),
    the 3xTF32 one (tc_bound), the bound of the bytes the design moves
    (design_bytes); TFLOP/s."""
    args = make_inputs(torch, g, gen, dev)
    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    attn_mask = library_mask(torch, g, rel_bias, mask)
    _, keep = fwd(*args, 7, rate)
    dy = torch.randn(x.shape, generator=gen).to(dev)
    tr = transposed(args)
    g["fwd_ms"] = time_ms(torch, lambda: fwd(*args, 7, rate))
    g["fwd_plain_ms"] = time_ms(
        torch, lambda: pk.fused_window_block_dropout_reference(*args, keep, rate))
    g["fwd_library_ms"] = time_ms(torch, lambda: library_block(
        torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"], rate))
    g["bwd_ms"] = time_ms(torch, lambda: bwd(*args, dy, keep, rate, *tr))
    g["bwd_plain_ms"] = time_ms(
        torch, lambda: pk.fused_window_block_backward_reference(*args, dy, keep, rate))
    g["bwd_library_ms"] = library_backward_ms(torch, g, args, dy, rate)
    for d, (f, b, bound_ms, by) in (("fwd", work_dropout(g)), ("bwd", work_backward(g, True))):
        g.update({f"{d}_flops": f, f"{d}_bytes": b, f"{d}_bound_ms": bound_ms,
                  f"{d}_bound_by": by, f"{d}_bound_tc_ms": tc_bound(f, b),
                  f"{d}_design_bytes": design_bytes(g, d == "bwd", sms),
                  f"{d}_tflops": f / g[f"{d}_ms"] / 1e9})
        g[f"{d}_bound_design_ms"] = 1e3 * g[f"{d}_design_bytes"] / HBM_BYTES_PER_S
    log(f"[{tag}] {g['name']} (windows {g['windows']}, C {g['C']}): " + "; ".join(
        f"{name} {g[f'{d}_ms']:.4f} ms (plain {g[f'{d}_plain_ms']:.4f}, library "
        f"{g[f'{d}_library_ms']:.4f}, bound f32 {g[f'{d}_bound_ms']:.4f}, TF32x3 "
        f"{g[f'{d}_bound_tc_ms']:.4f}, design bytes {g[f'{d}_bound_design_ms']:.4f}, "
        f"{g[f'{d}_tflops']:.2f} TFLOP/s)" for d, name in zip(("fwd", "bwd"), names)))


TRAIN_KEYS = tuple(f"{d}_{k}" for d in ("fwd", "bwd") for k in (
    "ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "bound_design_ms", "flops",
    "bytes", "design_bytes"))


def step_totals(geos, tag, names, launches):
    """time_training's numbers summed over one step (each geometry times
    its launches a forward), logged."""
    tot = {k: sum(g["per_forward"] * g[k] for g in geos) for k in TRAIN_KEYS}
    log(f"[{tag}] one step ({launches} launches each): " + "; ".join(
        f"{name} {tot[f'{d}_ms']:.3f} ms (plain {tot[f'{d}_plain_ms']:.3f}, library "
        f"{tot[f'{d}_library_ms']:.3f}, bound f32 {tot[f'{d}_bound_ms']:.3f}, TF32x3 "
        f"{tot[f'{d}_bound_tc_ms']:.3f}, design bytes {tot[f'{d}_bound_design_ms']:.3f} "
        f"({tot[f'{d}_design_bytes'] / 1e9:.3f} GB), {tot[f'{d}_flops'] / 1e9:.1f} GFLOP, "
        f"{tot[f'{d}_flops'] / tot[f'{d}_ms'] / 1e9:.2f} TFLOP/s)"
        for d, name in zip(("fwd", "bwd"), names)))
    return tot


def time_ms_long(torch, fn):
    """time_ms over at least PROFILE_TRACE_MS of calls (and at least 10): a
    one-off slow launch then moves the mean by little."""
    return time_ms(torch, fn, iters=max(10, math.ceil(
        PROFILE_TRACE_MS / time_ms(torch, fn, iters=3, warmup=1))))


def device_ms_per_call(torch, fn, attempts=3):
    """fn's device time a call (every kernel it launches, by a profile over
    at least PROFILE_TRACE_MS of calls): unlike CUDA events, not the host's
    time to enqueue a call where that is the longer. The calls are traced
    with pauses around them, as kernel_phase_split's; a trace that lost
    every record (device time 0: seen late in a process that has traced
    many times) is taken again, and ``attempts`` such traces raise."""
    reps = trace_reps(torch, fn)

    def calls():
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)

    for _ in range(attempts):
        busy = profile_device(torch, calls)["device_busy_ms"]
        if busy > 0:
            return busy / reps
    raise AssertionError(f"{attempts} profiles of {reps} calls held no device record")


def host_enqueue_ms(torch, fn, rounds=7, calls=30):
    """The host's time to enqueue one call of fn (the card left to run
    behind it): the median over ``rounds`` rounds of ``calls`` calls each,
    each round started on an idle card. One round reads the host's jitter
    (0.05-0.11 ms a call on the same code)."""
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


def attention_kernel_ms(rows, kernel, dropout):
    """Device ms of window_attention.cu's ``kernel`` (wattn_fwd_kernel or
    wattn_bwd_kernel) with or without dropout in a profile's rows (the
    backward's instances also name their row tile and columns: <9, 2, true>)."""
    flag = "true" if dropout else "false"
    pat = re.compile(rf"\b{kernel}<(?:\d+, )*{flag}>")
    return sum(r["device_ms"] for r in rows if pat.search(r["name"]))


def transposed(args):
    """wqkv and wproj in nn.Linear's [out, in] layout, which #3 and #5 read
    and the Swin block passes them."""
    return args[1].t().contiguous(), args[3].t().contiguous()


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def profile_device(torch, fn):
    """Run fn once under torch.profiler: wall ms, device busy ms, device
    operations and the device rows by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device rows only: a CPU op's self device time repeats its kernels'
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_ops": sum(e.count for e in rows), "rows": [
                {"name": e.key, "device_ms": e.self_device_time_total / 1e3, "count": e.count}
                for e in rows]}


def log_profile(tag, what, breakdown, top=12):
    b = breakdown
    log(f"[{tag}] {what}: wall {b['wall_ms']:.3f} ms, device busy {b['device_busy_ms']:.3f} ms, "
        f"idle share {1 - b['device_busy_ms'] / b['wall_ms']:.3f}, {b['device_ops']} device operations")
    for r in b["rows"][:top]:
        log(f"[{tag}] {r['device_ms']:.4f} ms x{r['count']}: {r['name'][:90]}")


@functools.lru_cache(maxsize=None)
def source_kernels(*files):
    """The names of the __global__ kernels of csrc/ files, read from the
    sources."""
    names = set()
    for name in files:
        with open(os.path.join(HERE, "focal_tpu_torch", "csrc", name)) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", f.read()))
    return names


def kernel_name(row):
    """The bare kernel name of a profiler row (None for a copy or memset)."""
    m = re.search(r"::(\w+)(?:<[^()]*>)?\(", row)
    return m.group(1) if m else None


# a library's kernels: its source's, and those of the headers window_block.cu
# and fused_mlp.cu share (gemm_splitk.cuh's, gemm_wgmma.cuh's) as it
# instantiates them, with its tag type in their names; the phase each
# kernel serves
SHARED = ("gemm_splitk.cuh", "gemm_wgmma.cuh")
WB_LIB = {"source": "window_block.cu", "tag": "WindowBlockSrc",
          "phases": {"proj_gemm_kernel": "GEMM", "attn_fwd_kernel": "attention",
                     "attn_bwd_kernel": "attention", "wgrad_gemm_kernel": "weight gradient",
                     "reduce_partials_kernel": "reduction", "wb_wg_qkvg_kernel": "GEMM",
                     "wb_wg_y_kernel": "GEMM", "wb_wg_dx_kernel": "GEMM",
                     "attn_fwd_bf16_kernel": "attention",
                     "attn_bwd_bf16_kernel": "attention", "wg_wgrad_kernel": "weight gradient",
                     "wg_reduce_kernel": "reduction"}}
MLP_LIB = {"source": "fused_mlp.cu", "tag": "FusedMlpSrc",
                   "phases": {"mlp_hidden_kernel": "hidden GEMM", "mlp_out_kernel": "output GEMM",
                              "mlp_g2_kernel": "masked gradient",
                              "wgrad_gemm_kernel": "weight gradient",
                              "reduce_partials_kernel": "reduction",
                              "mlp_wcast_kernel": "weight cast",
                              "mlp_wg_fwd_kernel": "fused forward",
                              "mlp_wg_gelu_kernel": "hidden GEMM",
                              "mlp_wg_hidden_kernel": "hidden GEMM",
                              "mlp_wg_out_kernel": "output GEMM",
                              "mlp_wg_g2_kernel": "masked gradient",
                              "wg_wgrad_kernel": "weight gradient",
                              "wg_reduce_kernel": "reduction"}}
# window_attention.cu's kernels, gemm_splitk.cuh's reduction among them as
# it instantiates it for drel_bias
ATTN_LIB = {"source": "window_attention.cu", "tag": "WindowAttentionSrc"}
# how many times one call of #2 or #4 (fwd) or of #3 or #5 (bwd) launches each
WB_LAUNCHES = {"fwd": {"proj_gemm_kernel": 2, "attn_fwd_kernel": 1},
               "bwd": {"proj_gemm_kernel": 2, "attn_bwd_kernel": 1, "wgrad_gemm_kernel": 1,
                       "reduce_partials_kernel": 2}}
PROFILE_REPS = 5
PROFILE_TRACE_MS = 20.0


def owned_by(lib, row):
    """Whether a profiler row is a kernel of ``lib`` (WB_LIB or
    MLP_LIB)."""
    name = kernel_name(row)
    if name not in source_kernels(lib["source"], *SHARED):
        return False
    return name not in source_kernels(*SHARED) or lib["tag"] in row


def mlp_launches(chunks, d, bf16_C=None):
    """How many times one call of #10 or #11 (fwd) or of #12 with masks
    (bwd) launches each fused_mlp.cu kernel, in ``chunks`` row chunks; with
    ``bf16_C`` (the width C) of their bf16 forms: the weight cast, then the
    forward in one launch where C <= fm.BF16_FUSED_MAX_C (else two a chunk),
    the backward's g2, hidden, dx and weight-gradient launches a chunk and
    one reduction."""
    if bf16_C is not None:
        from focal_tpu_torch.ops.fused_mlp import BF16_FUSED_MAX_C

        if d == "fwd":
            if bf16_C <= BF16_FUSED_MAX_C:
                return {"mlp_wcast_kernel": 1, "mlp_wg_fwd_kernel": 1}
            return {"mlp_wcast_kernel": 1, "mlp_wg_gelu_kernel": chunks, "mlp_wg_out_kernel": chunks}
        return {"mlp_wcast_kernel": 1, "mlp_wg_g2_kernel": chunks, "mlp_wg_hidden_kernel": chunks,
                "mlp_wg_out_kernel": chunks, "wg_wgrad_kernel": chunks, "wg_reduce_kernel": 1}
    if d == "fwd":
        return {"mlp_hidden_kernel": chunks, "mlp_out_kernel": chunks}
    return {"mlp_g2_kernel": chunks, "mlp_hidden_kernel": chunks, "mlp_out_kernel": chunks,
            "wgrad_gemm_kernel": chunks, "reduce_partials_kernel": 1}


def kernel_phase_split(torch, fn, launches, lib=WB_LIB, reps=PROFILE_REPS, attempts=3):
    """``reps`` calls of fn under torch.profiler; each kernel's device
    time per call (its mean per launch times ``launches[name]``: a short
    trace may lose a few records) and those times by ``lib``'s phases.
    Raises if a device kernel (or copy) ran that is not one of ``lib``'s
    (no cuBLAS or library kernel may run under the kernels' wrappers), or
    not one of ``launches``, or if one of ``launches`` left no record in
    ``attempts`` traces (a trace that lost records, as device_ms_per_call's
    can, is taken again)."""
    def calls():
        # pauses around the calls: in a process that had traced before, a
        # trace of one call (a few milliseconds) lost some or all records
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)

    for attempt in range(attempts):
        prof = profile_device(torch, calls)
        kernels = {}
        for r in prof["rows"]:
            name = kernel_name(r["name"])
            if not owned_by(lib, r["name"]):
                raise AssertionError(f"a device kernel outside csrc/{lib['source']} ran: "
                                     f"{r['name']}")
            if name not in launches:
                raise AssertionError(f"{name} ran; expected only {sorted(launches)}")
            k = kernels.setdefault(name, {"device_ms": 0.0, "count": 0})
            k["device_ms"] += r["device_ms"]
            k["count"] += r["count"]
        missing = set(launches) - set(kernels)
        if not missing:
            break
        log(f"[profile] trace {attempt + 1} of {attempts} holds no record of {sorted(missing)} "
            f"({len(prof['rows'])} device rows); taken again")
    else:
        raise AssertionError(f"the profile holds no record of {sorted(missing)} in {attempts} "
                             "traces")
    phases = {}
    for name, k in kernels.items():
        k["ms_per_call"] = k["device_ms"] / k["count"] * launches[name]
        phase = lib["phases"][name]
        phases[phase] = phases.get(phase, 0.0) + k["ms_per_call"]
    return {"device_ms": sum(phases.values()), "phases": phases, "kernels": kernels, "reps": reps,
            "complete": all(k["count"] == reps * launches[n] for n, k in kernels.items())}


def trace_reps(torch, fn):
    """Calls of fn (warmed here) that a profiled trace takes: at least
    PROFILE_REPS and PROFILE_TRACE_MS of them by CUDA events."""
    return max(PROFILE_REPS, math.ceil(PROFILE_TRACE_MS / time_ms(torch, fn, iters=3, warmup=1)))


def block_profiles(torch, fwd, bwd, names, g, gen, dev, rate, tag):
    """The training forward ``fwd`` (#2 or #4, with dropout) and its
    backward ``bwd`` (#3 or #5) at geometry g profiled after a warm-up
    call, split by kernel name (kernel_phase_split); ``names`` label them."""
    args = make_inputs(torch, g, gen, dev)
    tr = transposed(args)
    dy = torch.randn(args[0].shape, generator=gen).to(dev)
    _, keep = fwd(*args, 7, rate)
    calls = {"fwd": lambda: fwd(*args, 7, rate), "bwd": lambda: bwd(*args, dy, keep, rate, *tr)}
    # at least PROFILE_TRACE_MS of calls: a trace of a few milliseconds can
    # lose every record of a kernel
    out = {d: kernel_phase_split(torch, fn, WB_LAUNCHES[d], reps=trace_reps(torch, fn))
           for d, fn in calls.items()}
    for d, name in zip(("fwd", "bwd"), names):
        s = out[d]
        log(f"[{tag}] {g['name']} (windows {g['windows']}, C {g['C']}) {name}: device "
            f"{s['device_ms']:.4f} ms a call; " + ", ".join(
                f"{p} {ms:.4f}" for p, ms in sorted(s["phases"].items(), key=lambda kv: -kv[1]))
            + "; records " + ", ".join(f"{k} x{v['count']}" for k, v in s["kernels"].items())
            + f" of {s['reps']} calls")
    return out


def profile_split(torch, fwd, bwd, names, geos, gen, dev, rate, tag):
    """block_profiles at every geometry of ``geos``; the device time by
    phase summed over one step (each geometry times its launches a
    forward)."""
    split = {"fwd": {}, "bwd": {}}
    for g in geos:
        g["profile"] = block_profiles(torch, fwd, bwd, names, g, gen, dev, rate, tag)
        for d in ("fwd", "bwd"):
            for phase, ms in g["profile"][d]["phases"].items():
                split[d][phase] = split[d].get(phase, 0.0) + g["per_forward"] * ms
    log(f"[{tag}] one step, device ms by phase: {names[0]} {split['fwd']}; "
        f"{names[1]} {split['bwd']}")
    return split


def block_device_ms(prof, lib=WB_LIB):
    """The device time of ``lib``'s kernels (#2-#5's by default) in a
    profiled step, by phase."""
    out = {}
    for r in prof["rows"]:
        if owned_by(lib, r["name"]):
            phase = lib["phases"][kernel_name(r["name"])]
            out[phase] = out.get(phase, 0.0) + r["device_ms"]
    return out


def beside_parent(tag, dataset, run):
    """The step beside the parent's (PARENT_STEPS)."""
    p = PARENT_STEPS[dataset]
    log(f"[{tag}] beside the per-window #2/#3 ({dataset}: p50 {p['p50_ms']:.3f} ms, idle share "
        f"{p['idle_share']:.3f}, peak {p['peak_mb']:.1f} MiB): p50 {run['p50_ms']:.3f} ms "
        f"({run['p50_ms'] / p['p50_ms']:.3f}x), {run['samples_per_s']:.1f} samples/s, idle share "
        f"{run['idle_share']:.3f}, peak memory {run['peak_mb']:.1f} MiB; #2-#5 device time in the "
        f"profiled step by phase (ms): {run['block_device_ms']}")


def zero_counts(kernels):
    for k in kernels:
        k.launches = 0


def counts(kernels):
    return {k.__name__: k.launches for k in kernels}


def check_counts(what, got, want):
    """Every kernel's launches in a path equal the expected count (0 for
    the kernels the path must not launch)."""
    if got != want:
        raise AssertionError(f"{what}: launches {got} != expected {want}")


def run_train_steps(torch, np, targs, batch, warmup, steps, kernels, per_step, dev, tag,
                    rate0_from="trained", rate0_launches=None):
    """Pretrain steps of the SW_Transformer at full width (flax-style init,
    seed 0, synthetic data resident on the card, a fixed idx as bench.py
    uses; the attention-only route with -no_pallas_block): warm-up, then
    timed steps with each kernel's launches per step checked; then one step
    with every drop rate at 0 through the kernels and through the plain
    versions, held to LOSS_TOL and GRAD_TOL (and, given
    ``rate0_launches``, the kernels' launches in it held to those): from
    the state ``rate0_from`` names, "trained" or "initial"; with
    "initial+trained" from the trained state as well, reported beside the
    same plain step on the host's CPU (another f32 summation order) but not
    held. Returns (summary, (state, step, data, idx))."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.models.sw_transformer import init_params
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    host_data, labels, _ = synthetic_arrays(targs.dataset_config, targs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    idx = torch.arange(batch, device=dev) % len(labels)  # fixed, as bench.py
    pallas_block = not targs.no_pallas_block
    model = build_backbone(targs.dataset_config, targs.model, targs.task, targs.learn_framework,
                           pallas_block=pallas_block)
    init_params(model, seed=0)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] {targs.dataset} SW_Transformer pretrain{'' if pallas_block else ' -no_pallas_block'}"
        f", batch {batch} (views fused to {2 * batch}), "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"{warmup} warm-up steps in {time.time() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    step_s, history = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, tdata, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        history.append(torch.stack([metrics[k] for k in sorted(metrics)]))
    launches = counts(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    history = torch.stack(history).cpu()
    names_sorted = sorted(metrics)
    if not bool(torch.isfinite(history).all()):
        raise AssertionError(f"non-finite loss or part: {history}")
    check_counts(f"{tag}: {steps} steps", launches,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    p50_ms = float(np.percentile(step_s, 50)) * 1e3
    geos = block_geometries(targs.dataset_config, 2 * batch)
    step_windows = sum(g["per_forward"] * g["windows"] for g in geos)  # through the attention
    train = {
        "steps": steps, "launches": launches, "p50_ms": p50_ms,
        "mean_ms": float(np.mean(step_s)) * 1e3, "min_ms": float(np.min(step_s)) * 1e3,
        "max_ms": float(np.max(step_s)) * 1e3,
        "samples_per_s": batch / (p50_ms / 1e3),
        "attention_windows_per_s": step_windows / (p50_ms / 1e3), "peak_mb": peak_mb,
        "first": dict(zip(names_sorted, history[0].tolist())),
        "last": dict(zip(names_sorted, history[-1].tolist())),
    }
    log(f"[{tag}] {steps} steps: launches {launches} (per step {per_step})")
    log(f"[{tag}] loss {train['first']['loss']:.4f} -> {train['last']['loss']:.4f}; last parts "
        + ", ".join(f"{k} {v:.4f}" for k, v in train["last"].items() if k != "loss"))
    log(f"[{tag}] p50 step {p50_ms:.3f} ms (mean {train['mean_ms']:.3f}, min {train['min_ms']:.3f}, "
        f"max {train['max_ms']:.3f}), {train['samples_per_s']:.1f} samples/s, "
        f"{train['attention_windows_per_s']:.1f} attention windows/s ({step_windows} a step), "
        f"peak memory {peak_mb:.1f} MiB")

    # one step with every drop rate at 0, kernels vs plain
    cfg0 = copy.deepcopy(targs.dataset_config)
    sw0 = cfg0["SW_Transformer"]
    sw0["dropout_ratio"] = sw0["drop_path_rate"] = sw0["attn_drop_rate"] = 0.0
    args0 = copy.copy(targs)
    args0.dataset_config = cfg0
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # the Swin module's kernel entry points and their plain versions
    entry_points = {"window_block": pk.window_block_reference,
                    "window_block_forward": pk.fused_window_block_reference,
                    "window_attention_qkv": pk.window_attention_qkv_reference,
                    "fused_window_attention": pk.fused_window_attention_reference}

    def rate0_step(weights, plain, device):
        """(loss, {name: gradient on the CPU}, launches) of one rate-0 step,
        through the kernels or, with ``plain``, their plain versions."""
        m = build_backbone(cfg0, targs.model, targs.task, targs.learn_framework,
                           pallas_block=pallas_block)
        m.load_state_dict(weights)
        m.to(device)
        st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
        st.step = state.step
        data = {loc: {k: a.to(device) for k, a in mods.items()} for loc, mods in tdata.items()}
        if plain:
            for name, fn in entry_points.items():
                setattr(swin_mod, name, fn)
        zero_counts(kernels)
        try:
            _, mt = make_pretrain_step(m, build_augmenter(args0), make_focal_loss(args0))(
                st, data, idx.to(device))
            loss = float(mt["loss"])
        finally:
            for name in entry_points:
                setattr(swin_mod, name, getattr(pk, name))
        return loss, {n: None if p.grad is None else p.grad.cpu()
                      for n, p in m.named_parameters() if p.requires_grad}, counts(kernels)

    def differ(a, b):
        """(relative loss difference, worst relative gradient difference, its
        name). A true gradient of 0 (the fusion attention's key bias, with
        several locations: its softmax is blind to it) is rounding noise on
        both sides: below TINY_GRAD on both, it is held to TINY_GRAD
        absolutely (C7)."""
        (loss_a, grads_a, _), (loss_b, grads_b, _) = a, b
        worst_err, worst = 0.0, ""
        for name, gb in grads_b.items():
            ga = grads_a[name]
            if ga is None or gb is None:
                if (ga is None) != (gb is None):
                    raise AssertionError(f"{name}: gradient on one path only")
                continue
            if max(float(ga.abs().max()), float(gb.abs().max())) < TINY_GRAD:
                e = 0.0 if float((ga - gb).abs().max()) <= TINY_GRAD else math.inf
            else:
                e = rel_err(ga, gb)
            if e > worst_err:
                worst_err, worst = e, name
        return abs(loss_a - loss_b) / abs(loss_b), worst_err, worst

    where = rate0_from.split("+")[0]
    kern = rate0_step(initial if where == "initial" else trained, False, dev)
    plain = rate0_step(initial if where == "initial" else trained, True, dev)
    loss_rel, step_grad_err, worst = differ(kern, plain)
    train.update(rate0_state=where, rate0_loss_kernel=kern[0], rate0_loss_plain=plain[0],
                 rate0_loss_rel=loss_rel, rate0_max_grad_rel=step_grad_err, rate0_worst=worst,
                 rate0_launches=kern[2])
    log(f"[{tag}] rate-0 step from the {where} state, kernels vs plain: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {loss_rel:.2e}), max grad rel err {step_grad_err:.2e} ({worst}); "
        f"launches {kern[2]}")
    if not loss_rel <= LOSS_TOL:
        raise AssertionError(f"rate-0 loss differs: {kern[0]} vs {plain[0]}")
    if not step_grad_err <= GRAD_TOL:
        raise AssertionError(f"rate-0 gradients differ: {step_grad_err} at {worst}")
    if rate0_launches is not None:
        check_counts(f"{tag}: rate-0 step (kernels)", kern[2],
                     {k.__name__: rate0_launches.get(k.__name__, 0) for k in kernels})
        check_counts(f"{tag}: rate-0 step (plain)", plain[2], {k.__name__: 0 for k in kernels})
    del kern, plain
    if rate0_from == "initial+trained":
        # the trained state, not held: the same comparison
        kern = rate0_step(trained, False, dev)
        plain = rate0_step(trained, True, dev)
        kp = differ(kern, plain)
        train.update(trained_rate0_kernel_vs_plain=kp, trained_rate0_losses=[kern[0], plain[0]])
        log(f"[{tag}] rate-0 step from the trained state (not held): loss kernels {kern[0]:.6f}, "
            f"plain {plain[0]:.6f}; kernels vs plain: loss rel {kp[0]:.2e}, max grad rel "
            f"{kp[1]:.2e} ({kp[2]})")
        del kern, plain
    return train, (state, step, tdata, idx)


# ---------------------------------------------------------------------------
# DeepSense and its conv-tower kernels (#13, #14)

DS_BATCH = 256            # DeepSense MOD samples per step; views fused to 512
DS_WIDE_BATCH = 128       # DeepSense MOD_WIDE samples per step; views fused to 256
DS_SAMPLES = 256          # MOD synthetic train split of the DeepSense entry-point run
TOWER_TOL = 1e-5          # relative: output, batch means and variances
# a gradient below NEAR_ZERO on both sides is compared absolutely, to
# NEAR_ZERO, as the JAX package's own test holds its kernels: a conv bias
# before a BatchNorm has a true gradient of 0, and both sides sum ~1e5 rows
# of cancellation noise (~1e-3)
NEAR_ZERO = 1e-2
# operations an element of a layer's output, besides its conv: forward the
# two stat sums (3), the BN affine (2), the GELU with its erf (~20), the mask
# and the residual (2); backward the GELU derivative (~25), x-hat and gy (4),
# the two sums (4), dc (5), the residual (1) and db (1)
FWD_ELEM_OPS = 27
BWD_ELEM_OPS = 40
CT = "focal_tpu/ops/conv_tower.py"
# csrc/conv_tower.cu's kernels (and gemm_splitk.cuh's and gemm_wgmma.cuh's
# reductions as it instantiates them, tagged ConvTowerSrc) and the part of
# #13/#14(-bf16) each serves (the bf16 transposed conv's epilogue takes the
# previous layer's BatchNorm sums: "products")
TOWER_LIB = {"source": "conv_tower.cu", "tag": "ConvTowerSrc",
             "phases": {"conv_gemm_kernel": "products", "conv_wgrad_kernel": "weight gradients",
                        "bn_elementwise_kernel": "elementwise passes",
                        "tap_transpose_kernel": "elementwise passes",
                        "bn_grad_sums_kernel": "reductions", "reduce_partials_kernel": "reductions",
                        "bn_stats_kernel": "reductions", "bn_grad_stats_kernel": "reductions",
                        "narrow_conv_kernel": "first conv (CUDA cores)",
                        "narrow_convT_kernel": "first conv (CUDA cores)",
                        "narrow_wgrad_kernel": "first conv (CUDA cores)",
                        "ct_wg_conv_kernel": "products",
                        "ct_wg_wgrad_kernel": "weight gradients",
                        "bn_dc_sums_kernel": "elementwise passes",
                        "bn_stats_sliced_kernel": "reductions",
                        "bn_grad_stats_sliced_kernel": "reductions",
                        "wg_reduce_kernel": "reductions"}}
TOWER_KERNEL_NAMES = tuple(TOWER_LIB["phases"])
# an external first conv's BN statistics and coefficients are PyTorch's
# own kernels, between #13's calls
TORCH_PHASE = "[C]-sized steps (PyTorch)"


def tower_geometries(cfg, samples, dataset):
    """The conv towers of one DeepSense train forward at ``samples`` (the
    views fused), over every location and modality (one entry a distinct
    geometry, ``towers`` the blocks that run it): R = samples * intervals
    rows of S positions, its layer configs and whether the first conv runs
    outside. With several locations, each modality's ``mod_extractor`` too
    (cin 1, S = loc_mod_out_channels)."""
    ds = cfg["DeepSense"]
    half = ds["loc_mod_out_channels"] // 2
    geos = {}

    def add(name, S, cfgs, external):
        key = (S, cfgs, external)
        if key in geos:
            geos[key]["towers"] += 1
            return
        geos[key] = {"name": f"{dataset} {name}", "samples": samples,
                     "intervals": cfg["num_segments"], "R": samples * cfg["num_segments"],
                     "S": S, "C": cfgs[0][2], "cfgs": cfgs, "external": external, "towers": 1}

    for loc in cfg["location_names"]:
        for mod in cfg["modality_names"]:
            lens = ds["loc_mod_conv_lens"][mod]
            stride = ds["loc_mod_in_conv_stride"][mod]
            s = cfg["loc_mod_spectrum_len"][loc][mod]
            external = max(stride) > 1
            S = (s - lens[0][1]) // stride[1] + 1 if external else s
            cin0 = cfg["loc_mod_in_freq_channels"][loc][mod]
            L = 1 + ds["loc_mod_conv_inter_layers"]
            add(mod, S, tuple((lens[0][1] if k == 0 else lens[1][1], cin0 if k == 0 else half, half,
                               k > 0) for k in range(L)), external)
    if len(cfg["location_names"]) > 1:
        ext_half = ds["loc_out_channels"] // 2
        lens = ds["loc_conv_lens"]
        L = 1 + ds["loc_conv_inter_layers"]
        for mod in cfg["modality_names"]:
            add(f"{mod} mod_extractor", ds["loc_mod_out_channels"],
                tuple((lens[0][1] if k == 0 else lens[1][1], 1 if k == 0 else ext_half, ext_half,
                       k > 0) for k in range(L)), False)
    return list(geos.values())


def tower_launches(geos):
    """#13's and #14's wrapper calls (fused_conv_tower, fused_conv_tower_backward)
    in one step over the towers geos."""
    return {"fused_conv_tower": sum(g["towers"] * (len(g["cfgs"]) + (0 if g["external"] else 1))
                                    for g in geos),
            "fused_conv_tower_backward": sum(g["towers"] * 2 * len(g["cfgs"]) for g in geos)}


def tower_work(g):
    """(forward FLOPs, forward bytes, backward FLOPs, backward bytes) of the
    chain at geometry g: the convs 2*R*S*KW*Cin*Cout (twice in the
    backward: the transposed conv and dW) plus FWD_ELEM_OPS / BWD_ELEM_OPS
    an output element; bytes: each input of the function read once and
    each output written once (forward: x0, the parameters and masks in,
    the last activation and the statistics out; backward: dy and the saved
    activations in, dx0 and the parameter gradients out)."""
    R, S, C = g["R"], g["S"], g["C"]
    RS = R * S
    f_fl = b_fl = 0
    params = 0
    saved = 0
    for k, (kw, cin, cout, _) in enumerate(g["cfgs"]):
        conv = 0 if (k == 0 and g["external"]) else 2 * RS * kw * cin * cout
        f_fl += conv + FWD_ELEM_OPS * RS * cout
        b_fl += 2 * conv + BWD_ELEM_OPS * RS * cout
        params += (0 if (k == 0 and g["external"]) else kw * cin * cout) + 3 * cout
        saved += 2 * RS * cout  # c_k and a_k
    cin0 = g["cfgs"][0][2] if g["external"] else g["cfgs"][0][1]
    masks = len(g["cfgs"]) * g["samples"] * C
    f_by = 4 * (RS * cin0 + params + masks + RS * C + 2 * len(g["cfgs"]) * C)
    b_by = 4 * (RS * C + saved + RS * cin0 + params + masks + RS * cin0 + params)
    return f_fl, f_by, b_fl, b_by


def tower_tc_bounds(g):
    """(forward, backward) bound in ms of the tower on the units it runs
    on: its convs as three TF32 products an f32 one at the tensor cores'
    peak, the elementwise operations at the f32 peak, or the bytes."""
    f_fl, f_by, b_fl, b_by = tower_work(g)
    conv = sum(0 if (k == 0 and g["external"]) else 2 * g["R"] * g["S"] * kw * cin * cout
               for k, (kw, cin, cout, _) in enumerate(g["cfgs"]))
    return tuple(1e3 * max(3 * c / TF32_FLOPS + (fl - c) / F32_FLOPS, by / HBM_BYTES_PER_S)
                 for c, fl, by in ((conv, f_fl, f_by), (2 * conv, b_fl, b_by)))


def tower_phase_split(torch, fn, strict=True):
    """trace_reps calls of fn (#13's tower_forward or #14's backward) under
    torch.profiler after a pause, each kernel's device time per call and
    those times by TOWER_LIB's phases; PyTorch's own kernels and memsets
    (the [C]-sized steps between the wrappers' calls) under TORCH_PHASE. With ``strict``
    it raises on any other kernel (cuDNN, cuBLAS: none may run); without,
    other kernels are kept by name (a parent checkout's)."""
    reps = trace_reps(torch, fn)

    def calls():
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)

    prof = profile_device(torch, calls)
    kernels, phases = {}, {}
    for r in prof["rows"]:
        name = kernel_name(r["name"]) or r["name"]
        if owned_by(TOWER_LIB, r["name"]):
            phase = TOWER_LIB["phases"][name]
        elif r["name"].startswith(("void at::native::", "at::native::", "Memset")) and not any(
                w in r["name"].lower() for w in ("gemm", "conv", "cudnn", "cutlass", "cublas")):
            phase = TORCH_PHASE
        elif strict:
            raise AssertionError(f"a device kernel outside csrc/conv_tower.cu ran: {r['name']}")
        else:
            phase = name
        k = kernels.setdefault(name, {"device_ms": 0.0, "count": 0})
        k["device_ms"] += r["device_ms"] / reps
        k["count"] += r["count"]
        phases[phase] = phases.get(phase, 0.0) + r["device_ms"] / reps
    return {"device_ms": sum(phases.values()), "phases": phases, "kernels": kernels}


def tower_inputs(torch, np, g, seed, dev):
    """Inputs at a trained model's scale: unit activations, lecun-scaled
    weights, BN affine near (1, 0), Dropout2d masks of rate 0.2 per sample."""
    rng = np.random.default_rng(seed)
    cin0 = g["cfgs"][0][2] if g["external"] else g["cfgs"][0][1]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x0 = t(rng.normal(size=(g["R"], g["S"], cin0)))
    ws, bs, scales, biases, masks = [], [], [], [], []
    for k, (kw, cin, cout, _) in enumerate(g["cfgs"]):
        ws.append(t(np.zeros((1, 1))) if (k == 0 and g["external"]) else
                  t(rng.normal(size=(kw * cin, cout)) * (kw * cin) ** -0.5))
        bs.append(t(rng.normal(size=cout) * 0.1))
        scales.append(t(1.0 + 0.1 * rng.normal(size=cout)))
        biases.append(t(0.1 * rng.normal(size=cout)))
        masks.append(t((rng.random((g["samples"], cout)) > 0.2) / 0.8))
    dy = t(rng.normal(size=(g["R"], g["S"], g["C"])))
    return x0, [ws, bs, scales, biases], masks, dy


def tower_leaves(torch, x0, params, external):
    """Differentiable copies: x0 and every parameter but an external first
    conv's placeholders."""
    x0 = x0.clone().requires_grad_(True)
    params = [[p.clone().requires_grad_(not (external and k == 0 and gi < 2))
               for k, p in enumerate(group)] for gi, group in enumerate(params)]
    leaves = [x0] + [p for group in params for p in group if p.requires_grad]
    return x0, params, leaves


def grad_errors(got, want):
    """(worst relative error over the gradients compared relatively, worst
    absolute error over the near-zero ones, worst absolute error overall)."""
    rel = near = absolute = 0.0
    for g, w in zip(got, want):
        d = float((g - w).abs().max())
        absolute = max(absolute, d)
        if max(float(g.abs().max()), float(w.abs().max())) < NEAR_ZERO:
            near = max(near, d)
        else:
            rel = max(rel, d / float(w.abs().max()))
    return rel, near, absolute


def library_tower(torch, F, x0, g, params, masks):
    """Yardstick only: the unfused chain through cuDNN (conv2d in NCHW,
    batch_norm in training mode, GELU, the mask, the residual)."""
    ws, bs, scales, biases = params
    R, S = g["R"], g["S"]
    x = x0.permute(0, 2, 1).unsqueeze(2)  # [R, Cin, 1, S]
    a = None
    for k, (kw, cin, cout, residual) in enumerate(g["cfgs"]):
        if k == 0 and g["external"]:
            c = x
        else:
            w4 = ws[k].view(kw, cin, cout).permute(2, 1, 0).unsqueeze(2)  # [Cout, Cin, 1, KW]
            inp = a if k > 0 else x
            if kw % 2:
                c = F.conv2d(inp, w4, bs[k], padding=(0, (kw - 1) // 2))
            else:  # SAME for an even width: (kw - 1) // 2 before, kw // 2 after
                c = F.conv2d(F.pad(inp, ((kw - 1) // 2, kw // 2)), w4, bs[k])
        y = F.batch_norm(c, None, None, scales[k], biases[k], training=True, eps=1e-5)
        m = masks[k].repeat_interleave(R // masks[k].shape[0], dim=0)[:, :, None, None]
        z = F.gelu(y, approximate="none") * m
        a = z + a if residual else z
    return a


def run_deepsense_steps(torch, np, targs, batch, warmup, steps, kernels, per_step, dev, tag):
    """DeepSense pretrain steps (flax-style init, seed 0, synthetic data
    resident on the card, a fixed idx): warm-up, then timed steps with each
    kernel's launches per step checked, and one profiled step. Returns
    (summary, model)."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    host_data, labels, _ = synthetic_arrays(targs.dataset_config, targs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    idx = torch.arange(batch, device=dev) % len(labels)
    model = build_backbone(targs.dataset_config, "DeepSense", targs.task, targs.learn_framework,
                           pallas_conv=targs.pallas_conv, compute_dtype=targs.compute_dtype)
    init_params(model, seed=0).to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] {targs.dataset} DeepSense pretrain{' -pallas_conv' if targs.pallas_conv else ''}, batch "
        f"{batch} (views fused to {2 * batch}), {sum(p.numel() for p in model.parameters())} "
        f"parameters; {warmup} warm-up steps in {time.time() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    step_s, history = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, tdata, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        history.append(torch.stack([metrics[k] for k in sorted(metrics)]))
    launches = counts(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    history = torch.stack(history).cpu()
    if not bool(torch.isfinite(history).all()):
        raise AssertionError(f"{tag}: non-finite loss or part: {history}")
    check_counts(f"{tag}: {steps} steps", launches,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    p50_ms = float(np.percentile(step_s, 50)) * 1e3
    profile = profile_device(torch, lambda: step(state, tdata, idx))
    own_ms = sum(r["device_ms"] for r in profile["rows"] if owned_by(TOWER_LIB, r["name"]))
    summary = {
        "steps": steps, "launches": launches, "p50_ms": p50_ms, "tower_kernels_device_ms": own_ms,
        "device_ops": profile["device_ops"],
        "mean_ms": float(np.mean(step_s)) * 1e3, "min_ms": float(np.min(step_s)) * 1e3,
        "max_ms": float(np.max(step_s)) * 1e3, "samples_per_s": batch / (p50_ms / 1e3),
        "peak_mb": peak_mb, "loss_first": float(history[0][sorted(metrics).index("loss")]),
        "loss_last": float(history[-1][sorted(metrics).index("loss")]), "profile": profile,
        "idle_share": 1 - profile["device_busy_ms"] / profile["wall_ms"],
        "device_busy_ms": profile["device_busy_ms"],
    }
    log(f"[{tag}] {steps} steps: launches {launches}; loss {summary['loss_first']:.4f} -> "
        f"{summary['loss_last']:.4f}; p50 step {p50_ms:.3f} ms (mean {summary['mean_ms']:.3f}, "
        f"min {summary['min_ms']:.3f}, max {summary['max_ms']:.3f}), "
        f"{summary['samples_per_s']:.1f} samples/s, peak memory {peak_mb:.1f} MiB")
    log_profile(tag, "one profiled step", profile, top=15)
    log(f"[{tag}] device time of the conv-tower kernels (#13, #14) in the profiled step: "
        f"{own_ms:.4f} ms")
    del state, step, tdata, idx
    return summary, model


def deepsense_rate0_step(torch, targs, weights, dev, plain):
    """One step of DeepSense at dropout 0 from ``weights`` (a state_dict):
    FOCAL pretraining, or a supervised step where targs.learn_framework is
    "no", at targs.compute_dtype; with targs.pallas_conv through the
    tower's kernels, or with ``plain`` through its plain version (else on
    the cuDNN route). Returns (loss, {name: gradient}, {name: running
    statistic}) on the CPU."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import layers as layers_mod
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step, make_supervised_train_step

    cfg0 = copy.deepcopy(targs.dataset_config)
    cfg0["DeepSense"]["dropout_ratio"] = 0.0
    args0 = copy.copy(targs)
    args0.dataset_config = cfg0
    host_data, labels, _ = synthetic_arrays(cfg0, targs.task, 2 * targs.batch_size, seed=0)
    data = to_device(host_data, dev)
    idx = torch.arange(targs.batch_size, device=dev) % len(labels)
    m = build_backbone(cfg0, "DeepSense", targs.task, targs.learn_framework,
                       pallas_conv=targs.pallas_conv, compute_dtype=targs.compute_dtype)
    m.load_state_dict(weights)
    m.to(dev)
    st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
    if plain:
        layers_mod.fused_conv_tower = ct.fused_conv_tower_reference
    try:
        if targs.learn_framework == "no":
            _, mt = make_supervised_train_step(m, build_augmenter(args0))(
                st, data, torch.from_numpy(labels).long().to(dev), idx)
        else:
            _, mt = make_pretrain_step(m, build_augmenter(args0), make_focal_loss(args0))(
                st, data, idx)
    finally:
        layers_mod.fused_conv_tower = ct.fused_conv_tower
    return (float(mt["loss"]), {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None},
            {n: b.detach().cpu() for n, b in m.named_buffers()})


# ---------------------------------------------------------------------------
# the fused MLP (#10, #11, #12) and the classifier stages

SUP_BATCH = 128           # supervised and finetune samples per step (no views to fuse)
SUP_SAMPLES = 256         # MOD synthetic train split of the classifier entry-point runs
# operations a hidden element besides the two products: forward the bias,
# the exact GELU (~20) and the mask; backward the GELU again and its
# derivative (~35), the masks, dz and the bias sums
MLP_ELEM_FWD = 24
MLP_ELEM_BWD = 40
TINY_GRAD = 1e-6          # a gradient tensor below this on both sides is compared absolutely


def mlp_geometries(cfg, batch, dataset):
    """Every distinct geometry whose Swin MLPs take the fused route
    (``mlp_fits``) in one forward at ``batch`` samples, over every location
    and modality: T rows, width C, hidden H and the blocks (launches) a
    forward makes there."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.ops.fused_mlp import mlp_fits

    sw = cfg["SW_Transformer"]
    geos = {}
    for loc in cfg["location_names"]:
        for mod in cfg["modality_names"]:
            geo = mod_geometry(cfg, loc, mod)
            for stage, ((H, W), C) in enumerate(geo["stages"]):
                hidden = int(C * float(sw.get("mlp_ratio", 4.0)))
                if not mlp_fits(C, hidden):
                    continue
                key = (batch * H * W, C, hidden)
                if key in geos:
                    geos[key]["per_forward"] += geo["block_num"][stage]
                    continue
                geos[key] = {"name": f"{dataset} {mod}/stage{stage}", "T": batch * H * W, "C": C,
                             "H": hidden, "per_forward": geo["block_num"][stage]}
    return list(geos.values())


def mlp_work(g, backward):
    """(FLOPs, bytes) of one launch: forward 4TCH for the two products plus
    MLP_ELEM_FWD a hidden element, x, the weights and y once; backward the
    10TCH it needs (z again, dh, dx, dW1, dW2) plus MLP_ELEM_BWD a hidden
    element, x, g and the weights read once, dx and the gradients written
    once."""
    T, C, H = g["T"], g["C"], g["H"]
    if backward:
        return 10 * T * C * H + MLP_ELEM_BWD * T * H, 4 * (3 * T * C + 4 * C * H + 2 * H + C)
    return 4 * T * C * H + MLP_ELEM_FWD * T * H, 4 * (2 * T * C + 2 * C * H + H + C)


def mlp_inputs(torch, np, g, seed, dev):
    """x, w1 [C, H], b1, w2 [H, C], b2 and a gradient g at a trained model's
    scale (unit activations, lecun-scaled weights, small biases)."""
    rng = np.random.default_rng(seed)
    T, C, H = g["T"], g["C"], g["H"]
    shapes = [(T, C), (C, H), (H,), (H, C), (C,), (T, C)]
    scales = [1.0, C**-0.5, 0.1, H**-0.5, 0.1, 1.0]
    return [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
            for s, k in zip(shapes, scales)]


def library_mlp(torch, F, x, w1, b1, w2, b2, rate=0.0):
    """Yardstick only: the cuBLAS chain addmm -> GELU -> addmm, with
    F.dropout after each at ``rate``."""
    h = F.gelu(torch.addmm(b1, x, w1), approximate="none")
    if rate:
        h = F.dropout(h, rate)
    y = torch.addmm(b2, h, w2)
    return F.dropout(y, rate) if rate else y


def run_supervised_steps(torch, np, sargs, batch, warmup, steps, kernels, per_step, dev, tag):
    """Supervised steps of the MOD SW_Transformer at full width (flax-style
    init, seed 0, synthetic data and labels resident on the card, a fixed
    idx, the recipe's fixed pool: mixup and phase_shift): warm-up, timed
    steps with each kernel's launches per step checked, one profiled step.
    Returns the summary."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_supervised_train_step

    host_data, labels, _ = synthetic_arrays(sargs.dataset_config, sargs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    tlabels = torch.from_numpy(labels).long().to(dev)
    idx = torch.arange(batch, device=dev) % len(labels)
    model = build_backbone(sargs.dataset_config, "SW_Transformer", sargs.task, "no",
                           pallas_mlp=sargs.pallas_mlp, compute_dtype=sargs.compute_dtype)
    init_params(model, seed=0).to(dev)
    state = create_train_state(sargs, model, steps_per_epoch=100, seed=0)
    step = make_supervised_train_step(model, build_augmenter(sargs), fixed_aug=True)
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, tlabels, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] {sargs.dataset} SW_Transformer supervised{' -pallas_mlp' if sargs.pallas_mlp else ''}"
        f" ({sargs.compute_dtype}), batch {batch}; {warmup} warm-up steps in "
        f"{time.time() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    step_s, history = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, tdata, tlabels, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        history.append(torch.stack([metrics["loss"], metrics["acc"]]))
    launches = counts(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    history = torch.stack(history).cpu()
    if not bool(torch.isfinite(history).all()):
        raise AssertionError(f"{tag}: non-finite loss: {history}")
    check_counts(f"{tag}: {steps} steps", launches,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    p50_ms = float(np.percentile(step_s, 50)) * 1e3
    profile = profile_device(torch, lambda: step(state, tdata, tlabels, idx))
    mlp_split = block_device_ms(profile, MLP_LIB)
    mlp_ms = sum(mlp_split.values())
    summary = {
        "steps": steps, "launches": launches, "p50_ms": p50_ms,
        "mean_ms": float(np.mean(step_s)) * 1e3, "min_ms": float(np.min(step_s)) * 1e3,
        "max_ms": float(np.max(step_s)) * 1e3, "samples_per_s": batch / (p50_ms / 1e3),
        "peak_mb": peak_mb, "loss_first": float(history[0][0]), "loss_last": float(history[-1][0]),
        "profile": profile, "idle_share": 1 - profile["device_busy_ms"] / profile["wall_ms"],
        "device_busy_ms": profile["device_busy_ms"], "device_ops": profile["device_ops"],
        "mlp_kernels_device_ms": mlp_ms, "mlp_device_ms_by_phase": mlp_split,
    }
    log(f"[{tag}] {steps} steps: launches {launches}; loss {summary['loss_first']:.4f} -> "
        f"{summary['loss_last']:.4f}; p50 step {p50_ms:.3f} ms (mean {summary['mean_ms']:.3f}, "
        f"min {summary['min_ms']:.3f}, max {summary['max_ms']:.3f}), "
        f"{summary['samples_per_s']:.1f} samples/s, peak memory {peak_mb:.1f} MiB")
    log_profile(tag, "one profiled step", profile, top=15)
    log(f"[{tag}] device time of the fused MLP kernels (#10-#12) in the profiled step: "
        f"{mlp_ms:.4f} ms ({mlp_split})")
    del state, step, tdata, idx, model
    return summary


def supervised_rate0_step(torch, sargs, weights, dev, plain, kernels=None):
    """One supervised step of the MOD SW_Transformer at every drop rate 0
    with -pallas_mlp from ``weights``, at sargs.compute_dtype: through the
    kernels (#1/#3, #10/#12, or their bf16 forms), or with ``plain``
    through their plain versions. The fixed pool is replaced by ["no"] so
    both take the same inputs. Returns (loss, {name: gradient}) on the CPU
    and the launches of ``kernels`` (the f32 ones by default)."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_supervised_train_step

    cfg0 = copy.deepcopy(sargs.dataset_config)
    sw0 = cfg0["SW_Transformer"]
    sw0["dropout_ratio"] = sw0["drop_path_rate"] = sw0["attn_drop_rate"] = 0.0
    sw0["fixed_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    args0 = copy.copy(sargs)
    args0.dataset_config = cfg0
    host_data, labels, _ = synthetic_arrays(cfg0, sargs.task, 2 * sargs.batch_size, seed=0)
    data = to_device(host_data, dev)
    tlabels = torch.from_numpy(labels).long().to(dev)
    idx = torch.arange(sargs.batch_size, device=dev) % len(labels)
    m = build_backbone(cfg0, "SW_Transformer", sargs.task, "no", pallas_mlp=True,
                       compute_dtype=sargs.compute_dtype)
    m.load_state_dict(weights)
    m.to(dev)
    st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
    if plain:
        swin_mod.window_block, swin_mod.window_block_forward = (pk.window_block_reference,
                                                                pk.fused_window_block_reference)
        swin_mod.fused_mlp = fm.fused_mlp_plain
    kernels = kernels or (pk.fused_window_block, pk.fused_window_block_backward,
                          fm.fused_mlp_forward, fm.fused_mlp_backward,
                          pk.fused_window_block_dropout, fm.fused_mlp_dropout_forward)
    zero_counts(kernels)
    try:
        _, mt = make_supervised_train_step(m, build_augmenter(args0), fixed_aug=True)(
            st, data, tlabels, idx)
        torch.cuda.synchronize()
    finally:
        swin_mod.window_block, swin_mod.window_block_forward = pk.window_block, pk.window_block_forward
        swin_mod.fused_mlp = fm.fused_mlp
    return (float(mt["loss"]), {n: p.grad.cpu() for n, p in m.named_parameters()
                                if p.grad is not None}, counts(kernels))


# ---------------------------------------------------------------------------
# the attention-only kernels (#6-#9) of -no_pallas_block

# operations a score besides the products: forward the bias and mask adds,
# the max, exp, sum and scale (6); backward the softmax again (6), the
# row dot a . da and ds (4)
ATTN_ELEM_FWD = 6
ATTN_ELEM_BWD = 10
ATTN_SRC = "focal_tpu_torch/csrc/window_attention.cu"


def attention_geometries(cfg, batch, dataset):
    """block_geometries with the head width hd: the attention's q, k, v
    are [windows, heads, N, hd]."""
    geos = block_geometries(cfg, batch)
    for g in geos:
        g["name"] = f"{dataset} {g['name']}"
        g["hd"] = g["C"] // g["heads"]
    return geos


def attention_work(g, backward):
    """(FLOPs, bytes) of one launch. FLOPs: the products, 4 N^2 hd a
    (window, head) pair forward (q k^T, a v) and 10 N^2 hd backward (q k^T
    again, g v^T, dq, dk, dv), plus ATTN_ELEM_* a score (the Philox words of
    #7/#9 are integer work, not counted). Bytes: q, k, v (and g) read once,
    out (dq, dk, dv) written once, rel_bias (and drel_bias) and the shift
    mask once; no keep mask is stored."""
    pairs, N, hd, H = g["windows"] * g["heads"], g["N"], g["hd"], g["heads"]
    mask = g["nW"] * N * N if g["mask"] is not None else 0
    if backward:
        flops = pairs * (10 * N * N * hd + ATTN_ELEM_BWD * N * N)
        elems = 7 * pairs * N * hd + 2 * H * N * N + mask
    else:
        flops = pairs * (4 * N * N * hd + ATTN_ELEM_FWD * N * N)
        elems = 4 * pairs * N * hd + H * N * N + mask
    return flops, 4 * elems


def attention_inputs(torch, np, g, seed, dev):
    """q (pre-scaled by hd**-0.5), k, v, the output gradient gy, rel_bias
    at a trained model's scale and the geometry's shift mask (or None)."""
    rng = np.random.default_rng(seed)
    shape = (g["windows"], g["heads"], g["N"], g["hd"])
    q, k, v, gy = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    q *= np.float32(g["hd"] ** -0.5)
    rel_bias = (0.02 * rng.normal(size=(g["heads"], g["N"], g["N"]))).astype(np.float32)
    out = [torch.from_numpy(a).to(dev) for a in (q, k, v, rel_bias)]
    mask = None if g["mask"] is None else torch.from_numpy(g["mask"]).to(dev)
    return out + [mask, torch.from_numpy(gy).to(dev)]


def route_forms_equal(torch, pk, q, k, v, rel_bias, mask, gy, seed, rate):
    """Whether the route's forms of #6, #7, #8 and #9 give the bits of the
    calls on q * scale with contiguous outputs: q, k, v as the head views
    of one [B_, N, 3C] tensor with q unscaled (q * sqrt(hd) here) and
    ``q_scale``, #6/#7 writing into the head view of a [B_, N, C] tensor."""
    B, H, N, hd = q.shape
    s = hd**-0.5
    qkv = torch.empty((B, N, 3 * H * hd), device=q.device)
    qu, ku, vu = pk._head_views(qkv, H)
    for dst, src in ((qu, q * hd**0.5), (ku, k), (vu, v)):
        dst.copy_(src)
    qs = qu * s
    y = torch.empty((B, N, H * hd), device=q.device)
    view = y.view(B, N, H, hd).transpose(1, 2)
    got = [pk.fused_window_attention(qu, ku, vu, rel_bias, mask, q_scale=s, out=view)]
    equal = [torch.equal(got[0], pk.fused_window_attention(qs, ku, vu, rel_bias, mask))]
    pk.fused_window_attention_dropout(qu, ku, vu, rel_bias, mask, seed, rate, q_scale=s, out=view)
    equal.append(torch.equal(view, pk.fused_window_attention_dropout(qs, ku, vu, rel_bias, mask,
                                                                     seed, rate)))
    for sd, r in ((None, 0.0), (seed, rate)):
        a = pk.fused_window_attention_backward(qu, ku, vu, rel_bias, mask, gy, sd, r, q_scale=s)
        b = pk.fused_window_attention_backward(qs, ku, vu, rel_bias, mask, gy, sd, r)
        equal.append(all(torch.equal(x, z) for x, z in zip(a, b)))
    return equal


def library_attention(torch, q, k, v, attn_mask, rate=0.0):
    """Yardstick only: PyTorch's scaled_dot_product_attention with the bias
    and shift mask materialised as attn_mask (q is pre-scaled: scale 1)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=rate, scale=1.0)


def route_block(torch, swin_mod, g, dev, rate):
    """One Swin WindowAttention of the attention-only route
    (-no_pallas_block) at geometry g (attention dropout ``rate``), its
    input x [B_, N, C] (requiring a gradient), an output gradient, the
    shift mask and the step's generators."""
    from focal_tpu_torch.ops.dropout import StepRngs

    C, H, N, B = g["C"], g["heads"], g["N"], g["windows"]
    side = int(round(math.sqrt(N)))
    attn = swin_mod.WindowAttention(C, (side, side), H, attn_drop=rate,
                                    pallas_block=False).to(dev).train()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((B, N, C), generator=gen).to(dev).requires_grad_(True)
    gy = torch.randn((B, N, C), generator=gen).to(dev)
    mask = None if g["mask"] is None else torch.from_numpy(g["mask"]).to(dev)
    rng = StepRngs(torch.Generator().manual_seed(0), torch.Generator(device=dev).manual_seed(0))
    return attn, x, gy, mask, rng


def route_profile(torch, g, fn, ops, kernel, dropout, skip_linears=False):
    """Profile fn (at least PROFILE_TRACE_MS of calls) with the ops' shapes:
    the device rows a call, ``kernel``'s and the copy kernels' device ms a
    call, and the calls found of an aten stack or cat, or of one of the
    aten ``ops`` on a tensor of B_ N hd floats or more (a q-sized or
    window-sized one). With ``skip_linears`` the ops inside an aten linear
    (the qkv and proj Linears, which may copy their bias into their
    output) are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # at least PROFILE_TRACE_MS of calls: a shorter trace lost the records
    # of the port's kernels
    reps = trace_reps(torch, fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    big = g["windows"] * g["N"] * (g["C"] // g["heads"])
    def sized(shapes):
        return any(math.prod(sh) >= big for sh in shapes
                   if isinstance(sh, list) and sh and all(isinstance(d, int) for d in sh))

    def in_linear(e):
        while e is not None:
            if e.name == "aten::linear":
                return True
            e = e.cpu_parent
        return False

    moves = [(e.name, e.input_shapes) for e in prof.events()
             if (e.name in ("aten::stack", "aten::cat") or e.name in ops and sized(e.input_shapes))
             and not (skip_linears and in_linear(e))]
    rows = [{"name": e.key, "device_ms": e.self_device_time_total / 1e3 / reps,
             "count": e.count / reps}
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r["device_ms"])
    return {"rows": rows, "kernel_ms": attention_kernel_ms(rows, kernel, dropout),
            "copy_kernel_ms": sum(r["device_ms"] for r in rows
                                  if "copy" in r["name"].lower() or "cat" in r["name"].lower()),
            "device_ms": sum(r["device_ms"] for r in rows), "moves": moves}


def route_backward_profile(torch, swin_mod, g, dev, rate):
    """The backward of one route block (route_block) in training, profiled
    (route_profile). The qkv Linear takes d(qkv) [B_, N, 3C] as #9 writes
    it: no aten stack or cat runs, and no copy or clone of a window-sized
    gradient (B_ N hd floats or more)."""
    attn, x, gy, mask, rng = route_block(torch, swin_mod, g, dev, rate)
    leaves = [x] + list(attn.parameters())
    y = attn(x, mask, rng)
    out = route_profile(torch, g, lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True),
                        {"aten::copy_", "aten::clone"}, "wattn_bwd_kernel", rate > 0)
    return out


def route_forward_profile(torch, swin_mod, g, dev, rate):
    """The forward of one route block (route_block), profiled
    (route_profile) in training (#7 at ``rate``, autograd recording) and in
    eval (#6): q is scaled in the kernel and the kernel writes the proj
    Linear's input, so no aten multiply or division of a q-sized tensor
    (B_ N hd floats or more) runs, and no copy or clone of one."""
    attn, x, _, mask, rng = route_block(torch, swin_mod, g, dev, rate)
    ops = {"aten::mul", "aten::mul_", "aten::div", "aten::div_", "aten::copy_", "aten::clone"}
    train = route_profile(torch, g, lambda: attn(x, mask, rng), ops, "wattn_fwd_kernel", rate > 0,
                          skip_linears=True)
    attn.eval()
    with torch.no_grad():
        infer = route_profile(torch, g, lambda: attn(x, mask), ops, "wattn_fwd_kernel", False,
                              skip_linears=True)
    return {"train": train, "eval": infer}


def grads_differ(got, want):
    """Worst max|got - want| / max|want| over the gradients, each compared
    absolutely (to TINY_GRAD) where both sides are below TINY_GRAD."""
    worst = 0.0
    for a, b in zip(got, want):
        if max(float(a.abs().max()), float(b.abs().max())) < TINY_GRAD:
            if float((a - b).abs().max()) > TINY_GRAD:
                return math.inf
            continue
        worst = max(worst, rel_err(a, b))
    return worst


# ---------------------------------------------------------------------------
# the JAX package's other recipes (26) and two locations (27)

RECIPES = ("ACIDS", "PAMAP2", "RealWorld_HAR")
RECIPE_STEPS = 5          # timed steps a path at each recipe, after TRAIN_WARMUP


def two_locations(cfg):
    """A recipe copied with a second location ``tower`` shaped as the
    first, as the JAX package's tests/test_multi_location.py builds one."""
    cfg = copy.deepcopy(cfg)
    first = cfg["location_names"][0]
    cfg["location_names"] = [first, "tower"]
    cfg["num_location"] = 2
    for key in ("loc_modalities", "loc_mod_in_freq_channels", "loc_mod_in_time_channels",
                "loc_mod_spectrum_len"):
        cfg[key]["tower"] = copy.deepcopy(cfg[key][first])
    return cfg


def serve_one_batch(torch, np, cfg, model, task, kernels, want, tag, dev):
    """Predictor over one synthetic batch of SERVE_BATCH at full width
    (seeded random init): the launches held to ``want`` a batch, the
    probabilities finite and summing to 1; an SW_Transformer's also equal
    (SLICE_TOL) to the same model with the plain block. Returns (p50 ms,
    launches)."""
    from focal_tpu_torch.data import synthetic_arrays
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.serve import Predictor

    data = synthetic_arrays(cfg, task, SERVE_BATCH, seed=5)[0]
    predictor = Predictor(cfg, model, task, None, batch_size=SERVE_BATCH, device=dev.type, seed=0)
    zero_counts(kernels)
    result = predictor.predict(data)
    got = counts(kernels)
    check_counts(f"{tag}: one served batch", got,
                 {k.__name__: want.get(k.__name__, 0) for k in kernels})
    probs = result["probs"]
    if probs.shape != (SERVE_BATCH, cfg[task]["num_classes"]) or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: bad probabilities, shape {probs.shape}")
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if sum_err > 1e-5:
        raise AssertionError(f"{tag}: probabilities do not sum to 1 (max error {sum_err})")
    plain_err = None
    if model == "SW_Transformer":
        swin_mod.window_block_forward = pk.fused_window_block_reference
        try:
            plain_err = float(np.abs(predictor._forward(data) - probs).max())
        finally:
            swin_mod.window_block_forward = pk.window_block_forward
        if not plain_err <= SLICE_TOL:
            raise AssertionError(f"{tag}: served probabilities differ from the plain block's by "
                                 f"{plain_err}")
    p50 = result["latency"]["p50_s"] * 1e3
    log(f"[{tag}] {model} served batch of {SERVE_BATCH}: launches {got}; p50 {p50:.3f} ms; "
        f"max|dprobs| vs the plain block {plain_err}")
    del predictor
    torch.cuda.empty_cache()
    return p50, got


def deepsense_rate0(torch, dargs, tag, dev):
    """The -pallas_conv DeepSense rate-0 step from the initial state,
    kernels vs plain, held to phase 15's gates."""
    from focal_tpu_torch.models import build_backbone, init_params

    cfg = dargs.dataset_config
    weights = init_params(build_backbone(cfg, "DeepSense", dargs.task, "FOCAL"),
                          seed=0).state_dict()
    kern = deepsense_rate0_step(torch, dargs, weights, dev, plain=False)
    plain = deepsense_rate0_step(torch, dargs, weights, dev, plain=True)
    loss_rel = abs(kern[0] - plain[0]) / abs(plain[0])
    g_rel, g_near, _ = grad_errors([kern[1][n] for n in plain[1]], list(plain[1].values()))
    stats_rel = max(rel_err(kern[2][n], plain[2][n]) for n in plain[2])
    out = {"loss_kernel": kern[0], "loss_plain": plain[0], "loss_rel": loss_rel,
           "max_grad_rel": g_rel, "max_grad_abs_near_zero": g_near, "max_stats_rel": stats_rel}
    log(f"[{tag}] DeepSense rate-0 step from the initial state, kernels vs plain: loss "
        f"{kern[0]:.6f} vs {plain[0]:.6f} (rel {loss_rel:.2e}), max grad rel err {g_rel:.2e} "
        f"(near-zero max abs {g_near:.2e}), running statistics max rel err {stats_rel:.2e}")
    if not (loss_rel <= LOSS_TOL and g_rel <= GRAD_TOL and g_near <= NEAR_ZERO
            and stats_rel <= TOWER_TOL):
        raise AssertionError(f"{tag}: DeepSense rate-0 step, kernels vs plain: {out}")
    torch.cuda.empty_cache()
    return out


def profiled_idle(torch, run, fn, tag, what):
    """One profiled call of fn: its idle share and device busy time into run."""
    prof = profile_device(torch, fn)
    log_profile(tag, what, prof)
    run["idle_share"] = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    run["device_busy_ms"] = prof["device_busy_ms"]


def step_line(tag, run):
    log(f"[{tag}] p50 {run['p50_ms']:.3f} ms, {run['samples_per_s']:.1f} samples/s, peak "
        f"{run['peak_mb']:.1f} MiB, idle share {run['idle_share']:.3f}, launches {run['launches']}")


def time_new_towers(torch, np, ct, F, geos, dev, seed0):
    """time_tower at each geometry; their per-geometry figures."""
    out = []
    for gi, g in enumerate(geos):
        time_tower(torch, np, ct, F, g, seed0 + gi, dev)
        out.append({k: g[k] for k in (
            "name", "R", "S", "C", "external", "towers", "fwd_ms", "fwd_plain_ms",
            "fwd_library_ms", "fwd_bound_ms", "fwd_bound_tc_ms", "bwd_ms", "bwd_plain_ms",
            "bwd_library_ms", "bwd_bound_ms", "bwd_bound_tc_ms")}
                   | {"cin": g["cfgs"][0][1], "kw": [c[0] for c in g["cfgs"]],
                      "max_rel_err_fwd": g["max_rel_err_fwd"],
                      "max_rel_err_bwd": g["max_rel_err_bwd"],
                      "device_ms_by_phase": {d: g["profile"][d]["phases"] for d in ("fwd", "bwd")}})
    torch.cuda.empty_cache()
    return out


def backbone_paths(torch, np, kernels, dev, dataset, cfg, task, cgeos, tag, supervised=False):
    """The paths of phases 26-27 at the configuration ``cfg`` (the recipe
    ``dataset``, or a copy of it), at full width: a served batch of each
    backbone (#1 once a Swin block; DeepSense none), 3 + RECIPE_STEPS
    SW_Transformer pretrain steps at TRAIN_BATCH (#2/#3 once a block a
    step; the rate-0 step from the initial state, kernels vs plain, #1/#3),
    3 + RECIPE_STEPS DeepSense -pallas_conv pretrain steps at DS_BATCH
    (#13/#14 over the towers ``cgeos``; its rate-0 step) and, with
    ``supervised``, 3 + RECIPE_STEPS -pallas_mlp supervised steps at
    SUP_BATCH (#2, #3, #11, #12): launches held exactly, p50, samples/s,
    peak memory and a profiled step's idle share. Returns {path: run}."""
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import parse_train_params

    fwd, fwd_drop, bwd = (pk.fused_window_block, pk.fused_window_block_dropout,
                          pk.fused_window_block_backward)
    n_blocks = sum(g["per_forward"] for g in block_geometries(cfg, SERVE_BATCH))
    paths = {}
    for model, want in (("SW_Transformer", {fwd.__name__: n_blocks}), ("DeepSense", {})):
        p50, got = serve_one_batch(torch, np, cfg, model, task, kernels, want, f"{tag}-serve",
                                   dev)
        paths[f"serve_{model}"] = {"p50_ms": p50, "launches": got}

    def train_args(model, batch, *flags):
        args = parse_train_params(["-dataset", dataset, "-model", model, "-batch_size",
                                   str(batch), *flags])
        args.dataset_config = cfg
        return args

    # SW_Transformer pretrain steps, and the rate-0 step from the initial state
    targs = train_args("SW_Transformer", TRAIN_BATCH, "-learn_framework", "FOCAL")
    run, (state, step, tdata, idx) = run_train_steps(
        torch, np, targs, TRAIN_BATCH, TRAIN_WARMUP, RECIPE_STEPS, kernels,
        {fwd_drop.__name__: n_blocks, bwd.__name__: n_blocks}, dev, f"{tag}-sw-pretrain",
        rate0_from="initial", rate0_launches={fwd.__name__: n_blocks, bwd.__name__: n_blocks})
    profiled_idle(torch, run, lambda: step(state, tdata, idx), f"{tag}-sw-pretrain",
                  "one profiled step")
    del state, step, tdata, idx
    step_line(f"{tag}-sw-pretrain", run)
    paths["pretrain_steps_SW_Transformer"] = run
    torch.cuda.empty_cache()

    # DeepSense -pallas_conv pretrain steps, and its rate-0 step
    dargs = train_args("DeepSense", DS_BATCH, "-learn_framework", "FOCAL", "-pallas_conv")
    run, _ = run_deepsense_steps(torch, np, dargs, DS_BATCH, TRAIN_WARMUP, RECIPE_STEPS, kernels,
                                 tower_launches(cgeos), dev, f"{tag}-deepsense-pallas")
    run["rate0"] = deepsense_rate0(torch, dargs, f"{tag}-deepsense-rate0", dev)
    run.pop("profile")
    step_line(f"{tag}-deepsense-pallas", run)
    paths["pretrain_steps_DeepSense_pallas_conv"] = run
    torch.cuda.empty_cache()
    if not supervised:
        return paths

    # SW_Transformer -pallas_mlp supervised steps
    n_mlp = sum(g["per_forward"] for g in mlp_geometries(cfg, SUP_BATCH, dataset))
    sargs = train_args("SW_Transformer", SUP_BATCH, "-learn_framework", "no", "-pallas_mlp")
    run = run_supervised_steps(
        torch, np, sargs, SUP_BATCH, TRAIN_WARMUP, RECIPE_STEPS, kernels,
        {fwd_drop.__name__: n_blocks, bwd.__name__: n_blocks,
         fm.fused_mlp_dropout_forward.__name__: n_mlp, fm.fused_mlp_backward.__name__: n_mlp},
        dev, f"{tag}-supervised-pallas-mlp")
    run.pop("profile")
    step_line(f"{tag}-supervised-pallas-mlp", run)
    paths["supervised_steps_SW_Transformer_pallas_mlp"] = run
    torch.cuda.empty_cache()
    return paths


def recipe_paths(torch, np, kernels, gen, dev, recipe):
    """Phase 26 at one recipe, as packaged at full width, synthetic data and
    random init: every kernel vs plain at the recipe's geometries (#1 at the
    served batch; #2/#3, #6-#9 at the training batch fused to 512; #10-#12
    at the classifier batch; #13/#14 at the DeepSense towers fused to 512)
    and #13/#14 timed there; then a served batch of each backbone, 3 + 5
    SW_Transformer pretrain steps at TRAIN_BATCH (#2/#3; the rate-0 step
    from the initial state, kernels vs plain), 3 + 5 DeepSense -pallas_conv
    pretrain steps at DS_BATCH (#13/#14; its rate-0 step), 3 + 5
    SW_Transformer -pallas_mlp supervised steps at SUP_BATCH (#2, #3, #11,
    #12), launches held exactly, each with a profiled step's idle share."""
    import torch.nn.functional as F

    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import DATASET_DEFAULT_TASK, load_dataset_config

    cfg = load_dataset_config(recipe)
    task = DATASET_DEFAULT_TASK[recipe]
    tag = f"recipe-{recipe}"
    t0 = time.time()
    sw = cfg["SW_Transformer"]
    rate, mlp_rate = float(sw["attn_drop_rate"]), float(sw["dropout_ratio"])
    out = {"errors": {}, "paths": {}}
    sgeos = block_geometries(cfg, SERVE_BATCH)
    tgeos = block_geometries(cfg, 2 * TRAIN_BATCH)
    n_blocks = sum(g["per_forward"] for g in sgeos)
    for g in sgeos + tgeos:
        g["name"] = f"{recipe} {g['name']}"
        if not pk.wblock_takes(g["N"], g["C"], g["heads"]) or not pk.wblock_fits(
                g["N"], g["C"], g["heads"]):
            raise AssertionError(f"{g['name']}: not on #1-#3's route")
    log(f"[{tag}] {len(sgeos)} block geometries (nW "
        f"{sorted({g['nW'] for g in sgeos if g['mask'] is not None})} shifted), "
        f"{n_blocks} Swin blocks a forward")
    e = out["errors"]
    e["fused_window_block"] = check_block_forward(torch, pk, sgeos, gen, dev)
    drop_err, grad_err, grad_abs = check_block_training(torch, pk, tgeos, gen, dev, rate)
    e["fused_window_block_dropout"] = drop_err
    e["fused_window_block_backward"] = grad_abs
    e["fused_window_block_backward_rel"] = grad_err
    at_err = {"fwd": 0.0, "drop": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    agen = attention_geometries(cfg, 2 * TRAIN_BATCH, recipe)
    check_attention(torch, np, pk, agen, gen, dev, rate, 8000, at_err)
    e.update(fused_window_attention=at_err["fwd"], fused_window_attention_dropout=at_err["drop"],
             fused_window_attention_backward=at_err["bwd_abs"],
             fused_window_attention_dropout_backward=at_err["bwd_abs"],
             fused_window_attention_backward_rel=at_err["bwd"])
    mgeos = mlp_geometries(cfg, SUP_BATCH, recipe)
    mlp_err = check_mlps(torch, np, fm, mgeos, dev, mlp_rate, seed0=500)
    e.update(fused_mlp_forward=mlp_err["fwd"], fused_mlp_dropout_forward=mlp_err["drop"],
             fused_mlp_backward=mlp_err["bwd_abs"], fused_mlp_backward_rel=mlp_err["bwd"])
    cgeos = tower_geometries(cfg, 2 * DS_BATCH, recipe)
    ct_fwd_err, ct_rel, ct_near, ct_abs = check_towers(torch, np, ct, cgeos, dev, seed0=600,
                                                       exact=True)
    e.update(fused_conv_tower=ct_fwd_err, fused_conv_tower_backward=ct_abs,
             fused_conv_tower_backward_rel=ct_rel, fused_conv_tower_backward_near_zero=ct_near)
    torch.cuda.empty_cache()
    out["towers"] = time_new_towers(torch, np, ct, F, cgeos, dev, 700)
    log(f"[{tag}] kernels vs plain at {len(sgeos)} served, {len(tgeos)} training, {len(mgeos)} "
        f"MLP and {len(cgeos)} tower geometries: {e}")

    out["paths"] = backbone_paths(torch, np, kernels, dev, recipe, cfg, task, cgeos, tag,
                                  supervised=True)
    out["seconds"] = time.time() - t0
    log(f"[{tag}] phase 26 at {recipe} in {out['seconds']:.1f}s")
    return out


def two_location_paths(torch, np, kernels, gen, dev):
    """Phase 27: MOD copied with a second location (two_locations), at
    full width: #13/#14 vs plain and timed at the mod_extractor geometry
    (cin 1, kw 4, S 128, C 64, batch 256 fused to 512); for SW_Transformer
    and DeepSense -pallas_conv a served batch and 3 + 5 pretrain steps with
    the launches held exactly (#2/#3 32 a step; #13/#14 over the four
    location towers and the two mod_extractor towers), and each backbone's
    rate-0 step from the initial state, kernels vs plain."""
    import torch.nn.functional as F

    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.params import load_dataset_config

    tag = "two-locations"
    t0 = time.time()
    cfg = two_locations(load_dataset_config("MOD"))
    task = "vehicle_classification"
    out = {"errors": {}, "paths": {}}
    cgeos = tower_geometries(cfg, 2 * DS_BATCH, "MOD two-location")
    egeos = [g for g in cgeos if g["name"].endswith("mod_extractor")]
    if len(egeos) != 1 or egeos[0]["cfgs"][0][:2] != (4, 1) or egeos[0]["S"] != 128:
        raise AssertionError(f"{tag}: unexpected mod_extractor geometry {egeos}")
    ct_fwd_err, ct_rel, ct_near, ct_abs = check_towers(torch, np, ct, egeos, dev, seed0=900,
                                                       exact=True)
    out["errors"].update(fused_conv_tower=ct_fwd_err, fused_conv_tower_backward=ct_abs,
                         fused_conv_tower_backward_rel=ct_rel,
                         fused_conv_tower_backward_near_zero=ct_near)
    out["towers"] = time_new_towers(torch, np, ct, F, egeos, dev, 950)

    out["paths"] = backbone_paths(torch, np, kernels, dev, "MOD", cfg, task, cgeos, tag)
    out["seconds"] = time.time() - t0
    log(f"[{tag}] phase 27 in {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# the attribution arms, the sweep and the reference format (28)

TAIL_UNITS = 3            # subsequences phase 28's split leaves after its full steps
TAIL_REPS = 5             # timed full and tail steps


def stage_plan(argv):
    """(train steps an epoch, eval forwards a validation point) of a stage
    run in-process with ``argv``: pretraining's validation embeds the train
    split for the KNN probe and runs two views and the features of val and
    test; the classifier stages' one forward of each val and test batch."""
    from focal_tpu_torch.data import DeviceDataLoader, load_split, sequence_batches
    from focal_tpu_torch.params import parse_train_params

    a = parse_train_params(argv)
    seq = sequence_batches(a)
    n = {o: len(DeviceDataLoader(load_split(o, a), a.batch_size, sequence=seq))
         for o in ("train", "val", "test")}
    steps = len(DeviceDataLoader(load_split("train", a), a.batch_size, drop_last=True,
                                 sequence=seq))
    return steps, (n["train"] + 3 * (n["val"] + n["test"]) if seq else n["val"] + n["test"])


def run_entry_points(torch, kernels, out, tag, what, fn, argv, per_step, per_eval, steps, evals,
                     **summary):
    """fn(argv) in-process with the launches of ``kernels`` counted from 0
    and held to per_step x steps + per_eval x evals; records the run (and
    ``summary``) in out["paths"][what]. Returns fn's result."""
    zero_counts(kernels)
    t0 = time.time()
    result = fn(argv)
    torch.cuda.synchronize()
    got = counts(kernels)
    check_counts(f"{tag}: {what}", got, {k.__name__: per_step.get(k.__name__, 0) * steps
                                         + per_eval.get(k.__name__, 0) * evals for k in kernels})
    out["paths"][what] = {"seconds": time.time() - t0, "steps": steps, "eval_forwards": evals,
                          "launches": got, **summary}
    log(f"[{tag}] {what}: {steps} steps, {evals} eval forwards in {time.time() - t0:.1f}s; "
        f"launches {got}")
    return result


def rate0_tail_step(torch, targs, weights, dev, plain, kernels=None):
    """One SW_Transformer pretrain step at every drop rate 0 from
    ``weights`` on the first targs.batch_size rows of a synthetic split
    (whole subsequences), at targs.compute_dtype on the route targs names
    (-no_pallas_block: the attention-only one): through the kernels, or
    with ``plain`` through their plain versions. Returns (loss, [gradients
    on the CPU], launches of ``kernels``, #1-#3 by default, [the gradients'
    parameter names])."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    cfg0 = copy.deepcopy(targs.dataset_config)
    sw0 = cfg0["SW_Transformer"]
    sw0["dropout_ratio"] = sw0["drop_path_rate"] = sw0["attn_drop_rate"] = 0.0
    args0 = copy.copy(targs)
    args0.dataset_config = cfg0
    data = to_device(synthetic_arrays(cfg0, targs.task, 2 * targs.batch_size, seed=0)[0], dev)
    idx = torch.arange(targs.batch_size, device=dev)
    m = build_backbone(cfg0, "SW_Transformer", targs.task, targs.learn_framework,
                       pallas_block=not targs.no_pallas_block, compute_dtype=targs.compute_dtype)
    m.load_state_dict(weights)
    m.to(dev)
    st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
    entry_points = {"window_block": pk.window_block_reference,
                    "window_block_forward": pk.fused_window_block_reference,
                    "window_attention_qkv": pk.window_attention_qkv_reference}
    if plain:
        for name, fn in entry_points.items():
            setattr(swin_mod, name, fn)
    kernels = kernels or (pk.fused_window_block, pk.fused_window_block_dropout,
                          pk.fused_window_block_backward)
    zero_counts(kernels)
    try:
        _, mt = make_pretrain_step(m, build_augmenter(args0), make_focal_loss(args0))(
            st, data, idx)
    finally:
        for name in entry_points:
            setattr(swin_mod, name, getattr(pk, name))
    return (float(mt["loss"]), [p.grad.cpu() for p in m.parameters() if p.grad is not None],
            counts(kernels), [n for n, p in m.named_parameters() if p.grad is not None])


def time_tail_steps(torch, np, targs, kernels, per_step, dev, tag):
    """TRAIN_WARMUP + TAIL_REPS pretrain steps on a full batch (TRAIN_BATCH
    samples) and on a tail of TAIL_UNITS subsequences, from one state, at
    full width: each step's launches held to ``per_step`` and its loss
    finite. Returns their p50s (ms) and launches."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    cfg = targs.dataset_config
    tail_rows = TAIL_UNITS * cfg["seq_len"]
    data = to_device(synthetic_arrays(cfg, targs.task, TRAIN_BATCH + tail_rows, seed=0)[0], dev)
    model = build_backbone(cfg, targs.model, targs.task, targs.learn_framework,
                           pallas_conv=targs.pallas_conv)
    init_params(model, seed=0).to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    out = {}
    for name, idx in (("full", torch.arange(TRAIN_BATCH, device=dev)),
                      ("tail", torch.arange(TRAIN_BATCH, TRAIN_BATCH + tail_rows, device=dev))):
        for _ in range(TRAIN_WARMUP):
            step(state, data, idx)
        zero_counts(kernels)
        step_s, losses = [], []
        for _ in range(TAIL_REPS):
            torch.cuda.synchronize()
            t0 = time.time()
            _, metrics = step(state, data, idx)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            losses.append(float(metrics["loss"]))
        got = counts(kernels)
        check_counts(f"{tag}: {TAIL_REPS} {name} steps", got,
                     {k.__name__: per_step.get(k.__name__, 0) * TAIL_REPS for k in kernels})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{tag}: non-finite loss in a {name} step: {losses}")
        out[name] = {"rows": int(idx.numel()), "p50_ms": float(np.percentile(step_s, 50)) * 1e3,
                     "min_ms": float(np.min(step_s)) * 1e3, "launches": got}
    log(f"[{tag}] {targs.model} pretrain step at full width: a full batch of "
        f"{out['full']['rows']} samples (views fused to {2 * out['full']['rows']}) p50 "
        f"{out['full']['p50_ms']:.3f} ms, the tail of {TAIL_UNITS} subsequences "
        f"({out['tail']['rows']} samples, fused to {2 * out['tail']['rows']}) p50 "
        f"{out['tail']['p50_ms']:.3f} ms; launches a step {per_step}")
    del state, step, data, model
    torch.cuda.empty_cache()
    return out


def attribution_paths(torch, np, kernels, gen, dev):
    """Phase 28 at MOD's full width: the pretraining attribution arms, the
    label-ratio sweep and the reference format, through the entry points,
    in-process, on a synthetic split of 2 full steps of TRAIN_BATCH and a
    tail of TAIL_UNITS subsequences. -ragged_tail's tail step takes the
    training kernels at a second, small geometry (24 fused samples): #2/#3
    and #13/#14 held to phases 6 and 14's gates there and timed, the step
    held kernels vs plain at rate 0 from the initial state and timed
    beside a full step, and its launches held exactly in 2-epoch runs of
    SW_Transformer (with -py_aug_draws -ref_lr_timing) and DeepSense
    -pallas_conv; a split whose tail is one subsequence runs its full steps
    alone. Both pretrained backbones go to the reference format and back,
    bitwise; the SW_Transformer import starts a -pallas_mlp supervised run
    through -init_weight; the sweep finetunes it over two ratios."""
    import importlib

    import torch.nn.functional as F

    from focal_tpu_torch import export_torch, sweep
    from focal_tpu_torch.data import create_dataloader, load_split
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import load_dataset_config, parse_train_params
    from focal_tpu_torch.train.loops import aug_id_table
    from focal_tpu_torch.train.optim import make_epoch_schedule
    from focal_tpu_torch.utils import torch_import

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    tag = "attribution"
    t_phase = time.time()
    cfg = load_dataset_config("MOD")
    task = "vehicle_classification"
    seq = cfg["seq_len"]
    per = TRAIN_BATCH // seq
    samples = seq * (2 * per + TAIL_UNITS)
    fwd, fwd_drop, bwd = (pk.fused_window_block, pk.fused_window_block_dropout,
                          pk.fused_window_block_backward)
    n_blocks = sum(g["per_forward"] for g in block_geometries(cfg, SERVE_BATCH))
    n_mlp = sum(g["per_forward"] for g in mlp_geometries(cfg, SUP_BATCH, "MOD"))
    tower = tower_launches(tower_geometries(cfg, 2 * DS_BATCH, "MOD"))
    sw_step = {fwd_drop.__name__: n_blocks, bwd.__name__: n_blocks}
    out = {"samples": samples, "tail_units": TAIL_UNITS, "paths": {}}
    run_dir = os.path.join(HERE, "build", "chip_smoke_attribution")
    shutil.rmtree(run_dir, ignore_errors=True)
    base = ["-dataset", "MOD", "-synthetic", "-synthetic_samples", str(samples), "-val_epochs",
            "1", "-output_dir", run_dir]
    pre = base + ["-learn_framework", "FOCAL", "-stage", "pretrain", "-batch_size",
                  str(TRAIN_BATCH), "-epochs", "2", "-ragged_tail"]

    run_entry = functools.partial(run_entry_points, torch, kernels, out, tag)

    # #2/#3 and #13/#14 at the tail step's geometries: the gates, the times
    tail_rows = TAIL_UNITS * seq
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    tgeos = block_geometries(cfg, 2 * tail_rows)
    for g in tgeos:
        g["name"] = f"MOD tail {g['name']}"
    drop_err, grad_err, grad_abs = check_block_training(torch, pk, tgeos, gen, dev, rate)
    cgeos = tower_geometries(cfg, 2 * tail_rows, "MOD tail")
    ct_fwd_err, ct_rel, ct_near, ct_abs = check_towers(torch, np, ct, cgeos, dev, seed0=1100)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for g in tgeos:
        time_training(torch, pk, fwd_drop, bwd, ("#2", "#3"), g, gen, dev, rate, sms,
                      f"{tag}-time-tail")
    wtot = step_totals(tgeos, f"{tag}-time-tail", ("#2", "#3"), n_blocks)
    # events read the host's enqueue at geometries this small: device time too
    wsplit = profile_split(torch, fwd_drop, bwd, ("#2", "#3"), tgeos, gen, dev, rate,
                           f"{tag}-profile-tail")
    towers = time_new_towers(torch, np, ct, F, cgeos, dev, 1200)
    tower_tot = {f"{d}_{k}": sum(t["towers"] * t[f"{d}_{k}"] for t in towers)
                 for d in ("fwd", "bwd") for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_tc_ms")}
    out["tail_kernels"] = {
        "fused_window_block_dropout": {k[4:]: wtot[k] for k in TRAIN_KEYS if k.startswith("fwd")}
        | {"device_ms": sum(wsplit["fwd"].values()), "device_ms_by_phase": wsplit["fwd"],
           "max_abs_err": drop_err, "launches_per_step": n_blocks},
        "fused_window_block_backward": {k[4:]: wtot[k] for k in TRAIN_KEYS if k.startswith("bwd")}
        | {"device_ms": sum(wsplit["bwd"].values()), "device_ms_by_phase": wsplit["bwd"],
           "max_abs_err": grad_abs, "max_rel_err": grad_err, "launches_per_step": n_blocks},
        "fused_conv_tower": {k[4:]: v for k, v in tower_tot.items() if k.startswith("fwd")}
        | {"device_ms": sum(t["towers"] * sum(t["device_ms_by_phase"]["fwd"].values())
                            for t in towers),
           "max_abs_err": ct_fwd_err, "launches_per_step": tower["fused_conv_tower"]},
        "fused_conv_tower_backward": {k[4:]: v for k, v in tower_tot.items() if k.startswith("bwd")}
        | {"device_ms": sum(t["towers"] * sum(t["device_ms_by_phase"]["bwd"].values())
                            for t in towers),
           "max_abs_err": ct_abs, "max_rel_err": ct_rel, "max_abs_err_near_zero": ct_near,
           "launches_per_step": tower["fused_conv_tower_backward"]},
        "towers": towers}
    tk = out["tail_kernels"]
    log(f"[{tag}] the tail step's kernels ({tail_rows} samples, views fused to "
        f"{2 * tail_rows}), summed over a step, by events (device): #2 {wtot['fwd_ms']:.4f} "
        f"({tk['fused_window_block_dropout']['device_ms']:.4f}) ms, #3 {wtot['bwd_ms']:.4f} "
        f"({tk['fused_window_block_backward']['device_ms']:.4f}) ms, #13 "
        f"{tower_tot['fwd_ms']:.4f} ({tk['fused_conv_tower']['device_ms']:.4f}) ms, #14 "
        f"{tower_tot['bwd_ms']:.4f} ({tk['fused_conv_tower_backward']['device_ms']:.4f}) ms; "
        f"worst errors #2 {drop_err:.2e}, #3 {grad_err:.2e} rel, "
        f"#13 {ct_fwd_err:.2e}, #14 {ct_rel:.2e} rel ({ct_near:.2e} near zero)")
    torch.cuda.empty_cache()

    # the tail step, kernels vs plain at rate 0 from the initial state
    sargs = parse_train_params(["-dataset", "MOD", "-learn_framework", "FOCAL", "-batch_size",
                                str(TAIL_UNITS * seq)])
    initial = init_params(build_backbone(cfg, "SW_Transformer", task, "FOCAL"), seed=0).state_dict()
    kern = rate0_tail_step(torch, sargs, initial, dev, plain=False)
    plain = rate0_tail_step(torch, sargs, initial, dev, plain=True)
    loss_rel = abs(kern[0] - plain[0]) / abs(plain[0])
    grad_rel = grads_differ(kern[1], plain[1])
    out["sw_tail_rate0"] = {"loss_kernel": kern[0], "loss_plain": plain[0], "loss_rel": loss_rel,
                            "max_grad_rel": grad_rel, "launches": kern[2]}
    log(f"[{tag}] SW_Transformer tail step ({TAIL_UNITS} subsequences) at rate 0 from the "
        f"initial state, kernels vs plain: loss {kern[0]:.6f} vs {plain[0]:.6f} (rel "
        f"{loss_rel:.2e}), max grad rel err {grad_rel:.2e}; launches {kern[2]}")
    check_counts(f"{tag}: the SW_Transformer rate-0 tail step", kern[2],
                 {fwd.__name__: n_blocks, fwd_drop.__name__: 0, bwd.__name__: n_blocks})
    if not (loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL):
        raise AssertionError(f"{tag}: SW_Transformer rate-0 tail step, kernels vs plain: "
                             f"{out['sw_tail_rate0']}")
    del kern, plain, initial
    dargs = parse_train_params(["-dataset", "MOD", "-model", "DeepSense", "-learn_framework",
                                "FOCAL", "-pallas_conv", "-batch_size", str(TAIL_UNITS * seq)])
    zero_counts(kernels)
    out["deepsense_tail_rate0"] = deepsense_rate0(torch, dargs, f"{tag}-deepsense-tail", dev)
    check_counts(f"{tag}: the DeepSense rate-0 tail steps (kernels, then plain)", counts(kernels),
                 {k.__name__: tower.get(k.__name__, 0) for k in kernels})

    # the tail step timed beside a full one
    out["sw_step_times"] = time_tail_steps(
        torch, np, parse_train_params(["-dataset", "MOD", "-learn_framework", "FOCAL"]), kernels,
        sw_step, dev, f"{tag}-sw-steps")
    out["deepsense_step_times"] = time_tail_steps(
        torch, np, parse_train_params(["-dataset", "MOD", "-model", "DeepSense",
                                       "-learn_framework", "FOCAL", "-pallas_conv"]),
        kernels, tower, dev, f"{tag}-deepsense-steps")

    # -ragged_tail -py_aug_draws -ref_lr_timing: SW_Transformer, 2 epochs
    sw_argv = pre + ["-model", "SW_Transformer", "-py_aug_draws", "-ref_lr_timing"]
    steps, evals = stage_plan(sw_argv)
    if steps != 2:
        raise AssertionError(f"{tag}: {steps} full steps an epoch, not 2")
    st, _, points = run_entry("pretrain SW_Transformer -ragged_tail -py_aug_draws "
                              "-ref_lr_timing -epochs 2", train_cli.main, sw_argv, sw_step,
                              {fwd.__name__: n_blocks}, 2 * (steps + 1), 2 * evals)
    if st.step != 2 * (steps + 1) or [p["epoch"] for p in points] != [0, 1]:
        raise AssertionError(f"{tag}: {st.step} updates, points {points}")
    for p in points:
        if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
            raise AssertionError(f"{tag}: non-finite loss at a validation point: {p}")
    a = parse_train_params(sw_argv)
    table = aug_id_table(create_dataloader("train", load_split("train", a), a),
                         build_augmenter(a), 2, a.seed, a.ragged_tail)
    lrs = [st.optimizer.lr(e * (steps + 1)) for e in range(2)]
    sch = dict(cfg["FOCAL"]["pretrain_lr_scheduler"], train_epochs=2)
    recipe = [make_epoch_schedule(sch, cfg["FOCAL"]["pretrain_optimizer"])(e) for e in range(2)]
    if lrs != [recipe[0], recipe[0]] or st.optimizer.steps_per_epoch != steps + 1:
        raise AssertionError(f"{tag}: -ref_lr_timing lr {lrs}, recipe {recipe}")
    out["paths"]["pretrain SW_Transformer -ragged_tail -py_aug_draws -ref_lr_timing -epochs 2"
                 ].update(updates=st.step, table_shape=list(table.shape), lr_by_epoch=lrs,
                          recipe_lr_by_epoch=recipe, points=points)
    log(f"[{tag}] -py_aug_draws table {list(table.shape)} (epochs, full steps + the tail, views), "
        f"epoch 0 {table[0].tolist()}; -ref_lr_timing lr by epoch {lrs} (the recipe's lr(e): "
        f"{recipe}); {st.step} updates; points " + "; ".join(
            f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f}"
            for p in points))
    sw_folder = os.path.join(run_dir, "weights", "MOD_SW_Transformer", "exp0_contrastive_FOCAL")
    sw_latest = os.path.join(sw_folder, "MOD_SW_Transformer_pretrain_latest.pt")
    del st

    # -ragged_tail: DeepSense -pallas_conv, 2 epochs (eval forwards launch nothing)
    ds_argv = pre + ["-model", "DeepSense", "-pallas_conv"]
    st, _, points = run_entry("pretrain DeepSense -pallas_conv -ragged_tail -epochs 2",
                              train_cli.main, ds_argv, tower, {}, 2 * (steps + 1), 2 * evals)
    if st.step != 2 * (steps + 1):
        raise AssertionError(f"{tag}: DeepSense {st.step} updates")
    ds_latest = os.path.join(run_dir, "weights", "MOD_DeepSense", "exp0_contrastive_FOCAL",
                             "MOD_DeepSense_pretrain_latest.pt")
    del st

    # a tail of one subsequence stays dropped: the full steps alone
    one_argv = ["-dataset", "MOD", "-synthetic", "-synthetic_samples", str(seq * (2 * per + 1)),
                "-val_epochs", "1", "-output_dir", os.path.join(run_dir, "one"),
                "-learn_framework", "FOCAL", "-stage", "pretrain", "-batch_size",
                str(TRAIN_BATCH), "-epochs", "1", "-ragged_tail", "-model", "DeepSense",
                "-pallas_conv"]
    st, _, _ = run_entry("pretrain DeepSense -pallas_conv -ragged_tail, a tail of one "
                         "subsequence, -epochs 1", train_cli.main, one_argv, tower, {}, 2, 0)
    if st.step != 2:
        raise AssertionError(f"{tag}: a one-subsequence tail ran: {st.step} updates")
    del st
    torch.cuda.empty_cache()

    # the reference format: export both pretrained backbones, import them back
    for model, latest in (("SW_Transformer", sw_latest), ("DeepSense", ds_latest)):
        ref = os.path.join(run_dir, f"MOD_{model}_reference.pt")
        export_torch.main(["-dataset", "MOD", "-model", model, "-learn_framework", "FOCAL",
                           "-model_weight", latest, "-torch_out", ref])
        saved = torch.load(latest, map_location="cpu", weights_only=True)
        back = torch_import.import_state_dict(model, torch_import.load_torch_state_dict(ref),
                                              saved, cfg)
        same = set(back) == set(saved) and all(
            back[k].dtype == saved[k].dtype and torch.equal(back[k], saved[k]) for k in saved)
        if not same:
            raise AssertionError(f"{tag}: {model}'s reference-format round trip is not bitwise")
        out[f"reference_format_{model}"] = {"tensors": len(back), "bitwise": same,
                                            "bytes": os.path.getsize(ref)}
        log(f"[{tag}] {model} pretrain _latest -> reference format ({os.path.getsize(ref)} "
            f"bytes) -> the port's state_dict: {len(back)} tensors, bitwise")
        if model == "SW_Transformer":
            imported = os.path.join(run_dir, "MOD_SW_Transformer_imported.pt")
            torch.save(back, imported)

    # a -pallas_mlp supervised run from the import (-init_weight)
    sup_argv = base + ["-learn_framework", "no", "-model", "SW_Transformer", "-pallas_mlp",
                       "-batch_size", str(SUP_BATCH), "-epochs", "1", "-init_weight", imported]
    steps, evals = stage_plan(sup_argv)
    run_entry("supervised SW_Transformer -pallas_mlp -init_weight (the import) -epochs 1",
              train_cli.main, sup_argv,
              {fwd_drop.__name__: n_blocks, bwd.__name__: n_blocks,
               fm.fused_mlp_dropout_forward.__name__: n_mlp, fm.fused_mlp_backward.__name__: n_mlp},
              {fwd.__name__: n_blocks, fm.fused_mlp_forward.__name__: n_mlp}, steps, evals)

    # the sweep: finetune the SW_Transformer pretrain over two ratios, 1 epoch each
    ratios = (0.1, 1.0)
    ft_argv = base + ["-learn_framework", "FOCAL", "-stage", "finetune", "-model",
                      "SW_Transformer", "-batch_size", str(SUP_BATCH), "-epochs", "1"]
    plans = [stage_plan(ft_argv + ["-label_ratio", str(r)]) for r in ratios]
    rows = run_entry("sweep SW_Transformer finetune -ratios 0.1,1.0", sweep.main,
                     ft_argv + ["-ratios", ",".join(map(str, ratios)), "-out",
                                os.path.join(run_dir, "sweep.json")],
                     {fwd_drop.__name__: n_blocks}, {fwd.__name__: n_blocks},
                     sum(s for s, _ in plans), sum(e for _, e in plans))
    if [r["label_ratio"] for r in rows] != list(ratios) or not all(
            0.0 <= r["best_val_acc"] <= 1.0 for r in rows):
        raise AssertionError(f"{tag}: sweep rows {rows}")
    out["sweep_rows"] = rows
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"[{tag}] phase 28 in {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# -compute_dtype bfloat16 (29): the bf16 forms of #1-#3

BF16_FLOPS = 989e12       # H100 SXM bf16 tensor cores, dense (NVIDIA data sheet)
BF16_FWD_TOL = 8e-3       # max|kernel - plain| / max|plain| of a bf16 y (one bf16 step is 2^-8)
BF16_GRAD_TOL = 1e-2      # relative, each gradient of #3-bf16 (dx in bf16, the rest f32)
BF16_SERVE_TOL = 1e-2     # served probabilities, #1-bf16's route vs the bf16 plain block
BF16_LOSS_TOL = 1e-2      # relative: the rate-0 bf16 step's loss vs the f32 step's
BF16_GRAD_MIN_COS = 0.9   # each gradient's cosine to the bf16 plain versions' (C11)
BF16_GRAD_MEDIAN_TOL = 5e-2  # median over the tensors of ||g - g_plain|| / ||g_plain|| (C11)
WB_LAUNCHES_BF16 = {"fwd": {"wb_wg_qkvg_kernel": 1, "attn_fwd_bf16_kernel": 1, "wb_wg_y_kernel": 1},
                    "bwd": {"wb_wg_qkvg_kernel": 1, "attn_bwd_bf16_kernel": 1,
                            "wb_wg_dx_kernel": 1, "wg_wgrad_kernel": 1, "wg_reduce_kernel": 1}}


def bf16_inputs(torch, g, gen, dev):
    """make_inputs with x, wqkv and wproj rounded to bf16 (the biases, the
    bias table and the shift mask stay f32, as the Swin block hands them)."""
    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = make_inputs(torch, g, gen, dev)
    bf = torch.bfloat16
    return x.to(bf), wqkv.to(bf), bqkv, wproj.to(bf), bproj, rel_bias, mask


def bf16_work(g, backward=False, with_keep=False):
    """FLOPs of #1-bf16/#2-bf16 (or #3-bf16): work()'s and work_backward()'s
    counts; bytes at the types they move: x, y (dy, dx) and the weights in
    bf16, the biases, bias table, mask and the gradients in f32, the keep
    mask in uint8, each read or written once. Returns (flops, bytes,
    bound ms at the bf16 tensor cores' peak or the bytes, what bounds)."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    fixed = 4 * (4 * C + H * N * N) + (4 * g["nW"] * N * N if g["mask"] is not None else 0)
    fixed += B * H * N * N if with_keep else 0
    if backward:
        flops = B * (22 * N * C * C + 12 * N * N * C)
        nbytes = 2 * (3 * B * N * C + 4 * C * C) + fixed + 4 * (4 * C * C + 4 * C + H * N * N)
    else:
        flops = B * (8 * N * C * C + 4 * N * N * C)
        nbytes = 2 * (2 * B * N * C + 4 * C * C) + fixed
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bf16_grad_err(got, want):
    """grads_differ in f32 (dx comes in bf16)."""
    return grads_differ([a.float() for a in got], [b.float() for b in want])


def zero_true_gradient(name):
    """A parameter whose true gradient is 0, so that both sides of a
    comparison compute only rounding noise there (C7): a fusion attention's
    key bias (the softmax ignores a shift of a row's scores) and a conv
    bias that feeds a BatchNorm (the batch mean takes it away)."""
    return name.endswith("key.bias") or name.endswith("Conv_0.bias")


def bf16_grad_stats(names, got, want):
    """Two rate-0 bf16 steps' gradients compared tensor by tensor: the
    cosines, the median and worst of ||g - g_want|| / ||g_want|| with their
    tensors, and the tensors of true gradient 0 (zero_true_gradient)
    absolutely."""
    cos, rel, noise = {}, {}, {}
    for name, a, b in zip(names, got, want):
        a, b = a.double(), b.double()
        if zero_true_gradient(name):
            noise[name] = float((a - b).abs().max())
            continue
        same = bool((a == b).all())
        den = float(a.norm() * b.norm())
        cos[name] = float((a * b).sum()) / den if den > 0 else float(same)
        rel[name] = float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else (
            0.0 if same else math.inf)
    worst_cos = min(cos, key=cos.get)
    worst_rel = max(rel, key=rel.get)
    median = statistics.median(rel.values())
    worst_noise = max(noise, key=noise.get) if noise else None
    return {"tensors": len(cos), "min_cos": cos[worst_cos], "min_cos_tensor": worst_cos,
            "median_rel": median, "max_rel": rel[worst_rel], "max_rel_tensor": worst_rel,
            "zero_true_gradient_tensors": len(noise),
            "zero_true_gradient_max_abs": noise[worst_noise] if noise else 0.0,
            "zero_true_gradient_worst_tensor": worst_noise}


def bf16_grad_gates(tag, names, got, want, median_tol=BF16_GRAD_MEDIAN_TOL):
    """C11: a rate-0 bf16 step's gradients, kernels (got) against the bf16
    plain versions (want), held to the CPU step test's gates
    (tests/test_torch_port_bf16_step.py): each tensor's cosine at least
    BF16_GRAD_MIN_COS and the median over the tensors of ||g - g_plain|| /
    ||g_plain|| at most ``median_tol`` (BF16_GRAD_MEDIAN_TOL; C14: phase 31
    passes the plain versions' own floor where that is higher). Tensors
    whose true gradient is 0 (zero_true_gradient) are held absolutely, to
    NEAR_ZERO, instead. Logs the worst tensors by name and raises where a
    gate fails."""
    out = bf16_grad_stats(names, got, want)
    worst_cos, worst_rel, worst_noise = (out["min_cos_tensor"], out["max_rel_tensor"],
                                         out["zero_true_gradient_worst_tensor"])
    median = out["median_rel"]
    log(f"[{tag}] gradients, kernels vs the bf16 plain versions, over {out['tensors']} tensors: min "
        f"cosine {out['min_cos']:.5f} ({worst_cos}), median rel {median:.3e} (gate "
        f"{median_tol:.3e}), max rel {out['max_rel']:.3e} ({worst_rel}); "
        f"{out['zero_true_gradient_tensors']} tensors of true gradient 0 held absolutely: max abs "
        f"{out['zero_true_gradient_max_abs']:.3e} ({worst_noise})")
    out["median_tol"] = median_tol
    if not (out["min_cos"] >= BF16_GRAD_MIN_COS and median <= median_tol
            and out["zero_true_gradient_max_abs"] <= NEAR_ZERO):
        raise AssertionError(f"{tag}: bf16 step gradients fail the gates (cosine >= "
                             f"{BF16_GRAD_MIN_COS}, median rel <= {median_tol}, "
                             f"zero-gradient tensors within {NEAR_ZERO}): {out}")
    return out


def check_block_bf16(torch, pk, sgeos, tgeos, gen, dev, rate):
    """#1-bf16 at the served geometries, #2-bf16 and #3-bf16 at the training
    ones, against their bf16 plain versions on the same bf16 inputs, in the
    working type: y (bf16) to BF16_FWD_TOL of max|y|; #2-bf16 fed its own
    keep mask, its keep rate within 5 sigma of 1 - rate; #3-bf16 with the
    mask and without, every gradient to BF16_GRAD_TOL relative (absolutely
    to TINY_GRAD where both sides are below it, C7), the same bits on a
    second call. Returns the worst errors."""
    worst = {"fwd": 0.0, "fwd_abs": 0.0, "drop": 0.0, "drop_abs": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for g in sgeos:
        args = bf16_inputs(torch, g, gen, dev)
        y = pk.fused_window_block_bf16(*args)
        torch.cuda.synchronize()
        want = pk.fused_window_block_bf16_reference(*args).float()
        err = rel_err(y.float(), want)
        g["bf16_rel_err"] = err
        worst["fwd"] = max(worst["fwd"], err)
        worst["fwd_abs"] = max(worst["fwd_abs"], float((y.float() - want).abs().max()))
        log(f"[bf16-check] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: #1-bf16 "
            f"max|kernel-plain| / max|plain| {err:.3e}")
        if not err <= BF16_FWD_TOL:
            raise AssertionError(f"{g['name']}: #1-bf16 differs from plain by {err}")
    for gi, g in enumerate(tgeos):
        args = bf16_inputs(torch, g, gen, dev)
        y, keep = pk.fused_window_block_dropout_bf16(*args, 1500 + gi, rate)
        torch.cuda.synchronize()
        want = pk.fused_window_block_bf16_reference(*args, keep, rate).float()
        err = rel_err(y.float(), want)
        worst["drop_abs"] = max(worst["drop_abs"], float((y.float() - want).abs().max()))
        kept = float(keep.double().mean())
        sigma = math.sqrt(rate * (1 - rate) / keep.numel())
        dy = torch.randn(y.shape, generator=gen).to(dev).to(torch.bfloat16)
        errs = {}
        for tag, kp in (("keep", keep), ("nomask", None)):
            got = pk.fused_window_block_backward_bf16(*args, dy, kp, rate)
            again = pk.fused_window_block_backward_bf16(*args, dy, kp, rate)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{g['name']}: #3-bf16 gives other bits on a second call")
            want = pk.fused_window_block_backward_bf16_reference(*args, dy, kp, rate)
            errs[tag] = bf16_grad_err(got, want)
            worst["bwd_abs"] = max(worst["bwd_abs"], *(float((a.float() - b.float()).abs().max())
                                                       for a, b in zip(got, want)))
        g.update(bf16_rel_err_fwd=err, bf16_keep_rate=kept, bf16_rel_err_bwd=errs["keep"],
                 bf16_rel_err_bwd_nomask=errs["nomask"])
        worst["drop"] = max(worst["drop"], err)
        worst["bwd"] = max(worst["bwd"], *errs.values())
        log(f"[bf16-check] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: #2-bf16 "
            f"rel err {err:.3e}, keep rate {kept:.5f} ({(kept - 1 + rate) / sigma:+.2f} sigma); "
            f"#3-bf16 max rel err {errs['keep']:.3e} (mask), {errs['nomask']:.3e} (no mask), "
            "repeatable")
        if not err <= BF16_FWD_TOL:
            raise AssertionError(f"{g['name']}: #2-bf16 differs from plain by {err}")
        if not abs(kept - (1 - rate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: #2-bf16 keep rate {kept} is not 1 - {rate} "
                                 "within 5 sigma")
        if not max(errs.values()) <= BF16_GRAD_TOL:
            raise AssertionError(f"{g['name']}: #3-bf16 gradients differ from plain by {errs}")
    return worst


def library_bf16_ms(torch, g, args, dy, rate):
    """The library yardstick in bf16, timed: cuBLAS bf16 products around
    scaled_dot_product_attention on bf16 q, k, v with the bias and mask as
    a bf16 attn_mask, forward, and its autograd backward."""
    bf = torch.bfloat16
    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    am = library_mask(torch, g, rel_bias, mask).to(bf)
    fwd = time_ms(torch, lambda: library_block(torch, x, wqkv, bqkv.to(bf), wproj, bproj.to(bf),
                                               am, g["heads"], rate))
    leaves = [t.clone().requires_grad_(True) for t in (x, wqkv, bqkv.to(bf), wproj, bproj.to(bf))]
    am = am.clone().requires_grad_(True)
    out = library_block(torch, *leaves, am, g["heads"], rate)
    bwd = time_ms(torch, lambda: torch.autograd.grad(out, leaves + [am], dy, retain_graph=True))
    return fwd, bwd


def time_block_bf16(torch, pk, g, gen, dev, rate, train, perhead=False):
    """#1-bf16 (eval geometry) or #2-bf16 and #3-bf16 (training geometry;
    with ``perhead`` #4-bf16 and #5-bf16) at g, stored in g: events over at
    least PROFILE_TRACE_MS of calls, device time from a profile split by
    kernel (kernel_phase_split: it fails on a kernel outside
    csrc/window_block.cu), the plain versions, the library yardstick and the
    bound (bf16_work)."""
    args = bf16_inputs(torch, g, gen, dev)
    dy = torch.randn(args[0].shape, generator=gen).to(dev).to(torch.bfloat16)
    fwd_k, bwd_k = ((pk.fused_window_block_perhead_bf16, pk.fused_window_block_perhead_backward_bf16)
                    if perhead else
                    (pk.fused_window_block_dropout_bf16, pk.fused_window_block_backward_bf16))
    if train:
        _, keep = fwd_k(*args, 7, rate)
        calls = {"fwd": (lambda: fwd_k(*args, 7, rate),
                         lambda: pk.fused_window_block_bf16_reference(*args, keep, rate)),
                 "bwd": (lambda: bwd_k(*args, dy, keep, rate),
                         lambda: pk.fused_window_block_backward_bf16_reference(*args, dy, keep,
                                                                               rate))}
    else:
        calls = {"fwd": (lambda: pk.fused_window_block_bf16(*args),
                         lambda: pk.fused_window_block_bf16_reference(*args))}
    lib = library_bf16_ms(torch, g, args, dy, rate if train else 0.0)
    for d, (kernel, plain) in calls.items():
        split = kernel_phase_split(torch, kernel, WB_LAUNCHES_BF16[d],
                                   reps=trace_reps(torch, kernel))
        flops, nbytes, bnd, by = bf16_work(g, backward=d == "bwd", with_keep=train)
        g[f"bf16_{d}"] = {"ms": time_ms_long(torch, kernel), "device_ms": split["device_ms"],
                          "device_ms_by_phase": split["phases"],
                          "plain_ms": time_ms(torch, plain),
                          "library_ms": lib[0] if d == "fwd" else lib[1], "bound_ms": bnd,
                          "bound_by": by, "flops": flops, "bytes": nbytes}
        r = g[f"bf16_{d}"]
        names = ("#4-bf16", "#5-bf16") if perhead else ("#2-bf16" if train else "#1-bf16",
                                                          "#3-bf16")
        log(f"[bf16-time] {g['name']} (windows {g['windows']}, C {g['C']}) "
            f"{names[0] if d == 'fwd' else names[1]}: "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {bnd:.4f} ({by}), {flops / r['device_ms'] / 1e9:.2f} "
            f"TFLOP/s by device time; by phase {split['phases']}")


def bf16_step_runs(torch, np, kernels, dev, tag, dataset="MOD", batch=TRAIN_BATCH,
                   steps=TRAIN_STEPS, per_step=None, pallas_block=True):
    """``dataset`` pretrain steps at ``batch`` (views fused; MOD at
    TRAIN_BATCH by default), f32 and bf16 from one init (seed 0) on the same
    resident synthetic data and fixed idx, in one process: TRAIN_WARMUP +
    ``steps`` each, launches held a step (``per_step``: {dtype: {kernel
    name: launches}}; by default #2 and #3 in f32, #2-bf16 and #3-bf16 in
    bf16, once a block each), losses finite; p50, samples/s, peak memory,
    and a profiled step's idle share, device busy time, device operations,
    device time by window_block.cu phase, window_attention.cu's device time
    and top kernels. ``pallas_block`` False takes the attention-only route
    (-no_pallas_block)."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    out = {}
    data = None
    for dtype in ("float32", "bfloat16"):
        targs = parse_train_params(["-dataset", dataset, "-learn_framework", "FOCAL",
                                    "-compute_dtype", dtype]
                                   + ([] if pallas_block else ["-no_pallas_block"]))
        cfg = targs.dataset_config
        if per_step is None:
            n_blocks = sum(g["per_forward"] for g in block_geometries(cfg, SERVE_BATCH))
            fwd, bwd = ((pk.fused_window_block_dropout, pk.fused_window_block_backward)
                        if dtype == "float32" else
                        (pk.fused_window_block_dropout_bf16, pk.fused_window_block_backward_bf16))
            step_launches = {fwd.__name__: n_blocks, bwd.__name__: n_blocks}
        else:
            step_launches = per_step[dtype]
        if data is None:
            data = to_device(synthetic_arrays(cfg, targs.task, 2 * batch, seed=0)[0], dev)
        idx = torch.arange(batch, device=dev)
        model = init_params(build_backbone(cfg, "SW_Transformer", targs.task, "FOCAL",
                                           pallas_block=pallas_block, compute_dtype=dtype),
                            seed=0).to(dev)
        state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
        step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
        for _ in range(TRAIN_WARMUP):
            step(state, data, idx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        step_s, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.time()
            _, metrics = step(state, data, idx)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            losses.append(float(metrics["loss"]))
        got = counts(kernels)
        check_counts(f"{tag}: {steps} {dtype} steps", got,
                     {k.__name__: step_launches.get(k.__name__, 0) * steps for k in kernels})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{tag}: non-finite {dtype} loss: {losses}")
        p50 = float(np.percentile(step_s, 50)) * 1e3
        run = {"p50_ms": p50, "mean_ms": float(np.mean(step_s)) * 1e3,
               "min_ms": float(np.min(step_s)) * 1e3, "samples_per_s": batch / (p50 / 1e3),
               "peak_mb": torch.cuda.max_memory_allocated() / 2**20, "launches": got,
               "loss_first": losses[0], "loss_last": losses[-1],
               "grad_dtypes": sorted({str(p.grad.dtype) for p in model.parameters()
                                      if p.grad is not None}),
               "param_dtypes": sorted({str(p.dtype) for p in model.parameters()})}
        prof = profile_device(torch, lambda: step(state, data, idx))
        run["idle_share"] = 1 - prof["device_busy_ms"] / prof["wall_ms"]
        run["device_busy_ms"] = prof["device_busy_ms"]
        run["device_ops"] = prof["device_ops"]
        run["block_device_ms"] = block_device_ms(prof)
        run["attention_device_ms"] = sum(r["device_ms"] for r in prof["rows"]
                                         if owned_by(ATTN_LIB, r["name"]))
        run["top_kernels"] = prof["rows"][:12]
        if run["grad_dtypes"] != ["torch.float32"] or run["param_dtypes"] != ["torch.float32"]:
            raise AssertionError(f"{tag}: {dtype} step's parameters or gradients are not f32: "
                                 f"{run['param_dtypes']}, {run['grad_dtypes']}")
        out[dtype] = run
        log_profile(tag, f"one {dtype} {dataset} pretrain step", prof, top=8)
        log(f"[{tag}] {dtype}: p50 {p50:.3f} ms (mean {run['mean_ms']:.3f}, min "
            f"{run['min_ms']:.3f}), {run['samples_per_s']:.1f} samples/s, peak memory "
            f"{run['peak_mb']:.1f} MiB, idle share {run['idle_share']:.3f}, device busy "
            f"{run['device_busy_ms']:.3f} ms, {run['device_ops']} device operations; "
            f"window_block.cu device ms by phase "
            f"{run['block_device_ms']}, window_attention.cu {run['attention_device_ms']:.3f} ms; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {got}")
        del state, step, model
        torch.cuda.empty_cache()
    f, b = out["float32"], out["bfloat16"]
    log(f"[{tag}] bf16 beside f32: p50 {b['p50_ms']:.3f} vs {f['p50_ms']:.3f} ms "
        f"({b['p50_ms'] / f['p50_ms']:.3f}x), device busy {b['device_busy_ms']:.3f} vs "
        f"{f['device_busy_ms']:.3f} ms, peak {b['peak_mb']:.1f} vs {f['peak_mb']:.1f} MiB, idle "
        f"share {b['idle_share']:.3f} vs {f['idle_share']:.3f}, device operations "
        f"{b['device_ops']} vs {f['device_ops']}")
    return out


def bf16_paths(torch, np, kernels, gen, dev):
    """Phase 29, -compute_dtype bfloat16 at MOD's full width: #1-bf16 at the
    served geometries and #2-bf16/#3-bf16 at the training ones against their
    bf16 plain versions (check_block_bf16's gates), and timed there; the
    entry points in-process with -compute_dtype bfloat16 (pretrain with
    -ragged_tail for 2 epochs, supervised for 1 and the test CLI on its
    _best) with every launch held exactly; a served batch through
    Predictor(compute_dtype="bfloat16") against the bf16 plain block
    (BF16_SERVE_TOL); a rate-0 pretrain step in bf16 against the f32 step
    from one state (BF16_LOSS_TOL) and against the bf16 plain versions; the
    bf16 pretrain step timed beside the f32 one."""
    import importlib

    from focal_tpu_torch import test as test_cli
    from focal_tpu_torch.data import DeviceDataLoader, load_split, synthetic_arrays
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_dataset_config, parse_train_params
    from focal_tpu_torch.serve import Predictor

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    tag = "bf16"
    t_phase = time.time()
    cfg = load_dataset_config("MOD")
    task = "vehicle_classification"
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    fwd, fwd_drop, bwd = (pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
                          pk.fused_window_block_backward_bf16)
    sgeos = block_geometries(cfg, SERVE_BATCH)
    tgeos = block_geometries(cfg, 2 * TRAIN_BATCH)
    n_blocks = sum(g["per_forward"] for g in sgeos)
    out = {"paths": {}}

    # the kernels against their bf16 plain versions, then timed
    out["errors"] = check_block_bf16(torch, pk, sgeos, tgeos, gen, dev, rate)
    for g in sgeos:
        time_block_bf16(torch, pk, g, gen, dev, rate, train=False)
    for g in tgeos:
        time_block_bf16(torch, pk, g, gen, dev, rate, train=True)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")
    out["serve_forward"] = {k: sum(g["per_forward"] * g["bf16_fwd"][k] for g in sgeos)
                            for k in keys}
    out["train_step"] = {d: {k: sum(g["per_forward"] * g[f"bf16_{d}"][k] for g in tgeos)
                             for k in keys} for d in ("fwd", "bwd")}
    for d, geos_d, where in (("fwd", sgeos, "serve"), ("fwd", tgeos, "train"),
                             ("bwd", tgeos, "train")):
        split = {}
        for g in geos_d:
            for ph, ms in g[f"bf16_{d}"]["device_ms_by_phase"].items():
                split[ph] = split.get(ph, 0.0) + g["per_forward"] * ms
        out[f"{where}_{d}_device_ms_by_phase"] = split
    s, t = out["serve_forward"], out["train_step"]
    log(f"[bf16-time] one served forward at {SERVE_BATCH} ({n_blocks} launches): #1-bf16 "
        f"{s['ms']:.4f} ms (device {s['device_ms']:.4f}), plain {s['plain_ms']:.4f}, library "
        f"{s['library_ms']:.4f}, bound {s['bound_ms']:.4f}; one training step at "
        f"{2 * TRAIN_BATCH}: #2-bf16 {t['fwd']['ms']:.4f} (device {t['fwd']['device_ms']:.4f}, "
        f"plain {t['fwd']['plain_ms']:.4f}, library {t['fwd']['library_ms']:.4f}, bound "
        f"{t['fwd']['bound_ms']:.4f}), #3-bf16 {t['bwd']['ms']:.4f} (device "
        f"{t['bwd']['device_ms']:.4f}, plain {t['bwd']['plain_ms']:.4f}, library "
        f"{t['bwd']['library_ms']:.4f}, bound {t['bwd']['bound_ms']:.4f})")
    out["geometries"] = [{k: v for k, v in g.items() if k != "mask"} for g in sgeos + tgeos]
    torch.cuda.empty_cache()

    run_entry = functools.partial(run_entry_points, torch, kernels, out, tag)

    # the entry points with -compute_dtype bfloat16
    run_dir = os.path.join(HERE, "build", "chip_smoke_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    seq = cfg["seq_len"]
    samples = seq * (2 * (TRAIN_BATCH // seq) + TAIL_UNITS)
    base = ["-dataset", "MOD", "-model", "SW_Transformer", "-synthetic", "-synthetic_samples",
            str(samples), "-val_epochs", "1", "-output_dir", run_dir, "-compute_dtype", "bfloat16"]
    step_bf16 = {fwd_drop.__name__: n_blocks, bwd.__name__: n_blocks}
    pre = base + ["-learn_framework", "FOCAL", "-stage", "pretrain", "-batch_size",
                  str(TRAIN_BATCH), "-epochs", "2", "-ragged_tail"]
    steps, evals = stage_plan(pre)
    st, _, points = run_entry("pretrain -compute_dtype bfloat16 -ragged_tail -epochs 2",
                              train_cli.main, pre, step_bf16, {fwd.__name__: n_blocks},
                              2 * (steps + 1), 2 * evals)
    if st.step != 2 * (steps + 1) or [p["epoch"] for p in points] != [0, 1]:
        raise AssertionError(f"{tag}: {st.step} updates, points {points}")
    for p in points:
        if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
            raise AssertionError(f"{tag}: non-finite loss at a validation point: {p}")
    out["paths"]["pretrain -compute_dtype bfloat16 -ragged_tail -epochs 2"]["points"] = points
    del st
    sup = base + ["-learn_framework", "no", "-batch_size", str(SUP_BATCH), "-epochs", "1"]
    steps, evals = stage_plan(sup)
    st, _, points = run_entry("supervised -compute_dtype bfloat16 -epochs 1", train_cli.main, sup,
                              step_bf16, {fwd.__name__: n_blocks}, steps, evals)
    if not all(math.isfinite(p[k]) for p in points for k in ("train_loss", "val_loss")):
        raise AssertionError(f"{tag}: non-finite supervised loss: {points}")
    del st
    test_batches = len(DeviceDataLoader(load_split("test", parse_train_params(sup)), SUP_BATCH))
    result = run_entry("test -compute_dtype bfloat16 (the supervised _best)", test_cli.main, sup,
                       {}, {fwd.__name__: n_blocks}, 0, test_batches)
    if not all(math.isfinite(v) for v in result):
        raise AssertionError(f"{tag}: the test CLI's numbers are not finite: {result}")
    out["test_result"] = list(result)
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # a served bf16 batch, kernels vs the bf16 plain block
    data = synthetic_arrays(cfg, task, SERVE_BATCH, seed=5)[0]
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device=dev.type, seed=0, compute_dtype="bfloat16")
    zero_counts(kernels)
    served = predictor.predict(data)
    got = counts(kernels)
    check_counts(f"{tag}: one served bf16 batch", got,
                 {k.__name__: n_blocks if k is fwd else 0 for k in kernels})
    probs = served["probs"]
    if probs.dtype != np.float32 or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: bad probabilities ({probs.dtype})")
    swin_mod.window_block_forward = pk.fused_window_block_reference
    try:
        serve_err = float(np.abs(predictor._forward(data) - probs).max())
    finally:
        swin_mod.window_block_forward = pk.window_block_forward
    out["serve"] = {"p50_ms": served["latency"]["p50_s"] * 1e3, "launches": got,
                    "max_abs_err_vs_plain": serve_err}
    log(f"[{tag}] served bf16 batch of {SERVE_BATCH}: launches {got}, p50 "
        f"{out['serve']['p50_ms']:.3f} ms; max|dprobs| vs the bf16 plain block {serve_err:.3e}")
    if not serve_err <= BF16_SERVE_TOL:
        raise AssertionError(f"{tag}: served bf16 probabilities differ from the plain block's by "
                             f"{serve_err}")
    del predictor

    # a rate-0 pretrain step from one state: bf16 kernels, bf16 plain, f32 kernels
    initial = init_params(build_backbone(cfg, "SW_Transformer", task, "FOCAL"), seed=0).state_dict()
    rargs = {d: parse_train_params(["-dataset", "MOD", "-learn_framework", "FOCAL", "-batch_size",
                                    str(TRAIN_BATCH), "-compute_dtype", d])
             for d in ("float32", "bfloat16")}
    kern = rate0_tail_step(torch, rargs["bfloat16"], initial, dev, plain=False, kernels=kernels)
    plain = rate0_tail_step(torch, rargs["bfloat16"], initial, dev, plain=True, kernels=kernels)
    f32 = rate0_tail_step(torch, rargs["float32"], initial, dev, plain=False, kernels=kernels)
    check_counts(f"{tag}: the rate-0 bf16 step", kern[2],
                 {k.__name__: n_blocks if k in (fwd, bwd) else 0 for k in kernels})
    vs_f32 = abs(kern[0] - f32[0]) / abs(f32[0])
    vs_plain = abs(kern[0] - plain[0]) / abs(plain[0])
    out["rate0"] = {"loss_bf16_kernels": kern[0], "loss_bf16_plain": plain[0],
                    "loss_f32_kernels": f32[0], "loss_rel_vs_f32": vs_f32,
                    "loss_rel_vs_bf16_plain": vs_plain,
                    "max_grad_rel_vs_bf16_plain": grads_differ(kern[1], plain[1]),
                    "max_grad_rel_vs_f32": grads_differ(kern[1], f32[1]),
                    "grad_dtypes": sorted({str(g.dtype) for g in kern[1]})}
    r = out["rate0"]
    log(f"[{tag}] rate-0 pretrain step at {TRAIN_BATCH} from the initial state: loss bf16 "
        f"{kern[0]:.6f}, bf16 plain {plain[0]:.6f}, f32 {f32[0]:.6f}; bf16 vs f32 rel "
        f"{vs_f32:.2e}, vs the bf16 plain versions {vs_plain:.2e}; max grad rel vs bf16 plain "
        f"{r['max_grad_rel_vs_bf16_plain']:.2e}, vs f32 {r['max_grad_rel_vs_f32']:.2e}; gradients "
        f"{r['grad_dtypes']}")
    if not (vs_f32 <= BF16_LOSS_TOL and vs_plain <= BF16_LOSS_TOL):
        raise AssertionError(f"{tag}: rate-0 bf16 step loss: {r}")
    if r["grad_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"{tag}: bf16 step gradients are not f32: {r['grad_dtypes']}")
    r["grad_gates"] = bf16_grad_gates(tag, kern[3], kern[1], plain[1])
    del kern, plain, f32, initial
    torch.cuda.empty_cache()

    out["steps"] = bf16_step_runs(torch, np, kernels, dev, f"{tag}-steps")
    out["seconds"] = time.time() - t_phase
    log(f"[{tag}] phase 29 in {out['seconds']:.1f}s")
    return out

# ---------------------------------------------------------------------------
# DeepSense at -compute_dtype bfloat16 (30): #13-bf16 and #14-bf16

DS_BF16_STATS_TOL = 1e-3  # relative: the bf16 tower's batch means and variances vs plain
# rows at which C7's NEAR_ZERO was set: a conv bias before a BatchNorm has a
# true gradient of 0, and the f32 value the kernels sum for it is set by the
# rounding of the batch mean over the rows (n ulp(mu)), which grows with n
NEAR_ZERO_ROWS = 1e5


def tower_bf16_inputs(torch, np, g, seed, dev):
    """tower_inputs with x0 and dy rounded to bf16 (the parameters and the
    masks stay f32, as ConvBlock hands them)."""
    x0, params, masks, dy = tower_inputs(torch, np, g, seed, dev)
    return x0.to(torch.bfloat16), params, masks, dy.to(torch.bfloat16)


def check_towers_bf16(torch, np, ct, geos, dev, seed0):
    """#13-bf16 and #14-bf16 (fused_conv_tower on bf16 x0) against the bf16
    plain tower with its f32 steps in float64 (a conv bias before a
    BatchNorm has a true gradient of 0, which the f32 plain version misses
    by up to ~2e-2 over 1e5 rows) on the same inputs, Dropout2d masks of
    rate 0.2 drawn on the host: the output to BF16_FWD_TOL of max|a|, the
    batch statistics to DS_BF16_STATS_TOL, every gradient to BF16_GRAD_TOL
    relative (absolutely to NEAR_ZERO where both sides are below it), two
    calls the same bits, and each call's launches counted; the conv biases'
    gradients (true value 0) absolutely, to NEAR_ZERO times R*S /
    NEAR_ZERO_ROWS where the rows exceed NEAR_ZERO_ROWS. Returns the worst
    errors."""
    worst = {"fwd": 0.0, "fwd_abs": 0.0, "stats": 0.0, "bwd": 0.0, "bwd_near": 0.0,
             "bwd_abs": 0.0, "conv_bias_abs": 0.0}
    fwd_k, bwd_k = ct.fused_conv_tower_bf16, ct.fused_conv_tower_backward_bf16
    for gi, g in enumerate(geos):
        x0, params, masks, dy = tower_bf16_inputs(torch, np, g, seed0 + gi, dev)
        runs = []
        before = (fwd_k.launches, bwd_k.launches)
        for fn, exact in ((ct.fused_conv_tower_bf16, False), (ct.fused_conv_tower_bf16, False),
                          (ct.fused_conv_tower_reference, True)):
            p = [[q.double() for q in grp] for grp in params] if exact else params
            m = [mm.double() for mm in masks] if exact else masks
            xl, pl_, leaves = tower_leaves(torch, x0, p, g["external"])
            y, mus, vars_ = fn(xl, g["cfgs"], *pl_, m, g["external"])
            runs.append((y.detach(), mus, vars_, torch.autograd.grad(y, leaves, dy)))
            del y
        torch.cuda.synchronize()
        # which leaf is a conv bias: tower_leaves' order, x0 then the groups
        is_bias = [False] + [gi == 1 for gi, grp in enumerate(pl_) for q in grp if q.requires_grad]
        L = len(g["cfgs"])
        check_counts(f"{g['name']}: two bf16 tower calls",
                     {fwd_k.__name__: fwd_k.launches - before[0],
                      bwd_k.__name__: bwd_k.launches - before[1]},
                     {fwd_k.__name__: 2 * (L + (0 if g["external"] else 1)),
                      bwd_k.__name__: 2 * 2 * L})
        (y, mus, vars_, grads), again, (ry, rmus, rvars, rgrads) = runs
        fwd = rel_err(y.float(), ry.float())
        stats = max(rel_err(a, b) for a, b in zip(mus + vars_, rmus + rvars))
        g_rel, g_near, g_abs = grad_errors(
            [a.float() for a, bias in zip(grads, is_bias) if not bias],
            [b.float() for b, bias in zip(rgrads, is_bias) if not bias])
        cb_abs = max(float((a.float() - b.float()).abs().max())
                     for a, b, bias in zip(grads, rgrads, is_bias) if bias)
        cb_tol = NEAR_ZERO * max(1.0, g["R"] * g["S"] / NEAR_ZERO_ROWS)
        same = (torch.equal(y, again[0]) and all(torch.equal(a, b) for a, b in zip(mus, again[1]))
                and all(torch.equal(a, b) for a, b in zip(grads, again[3])))
        g.update(bf16_rel_err_fwd=fwd, bf16_rel_err_stats=stats, bf16_rel_err_bwd=g_rel,
                 bf16_abs_err_bwd_near_zero=g_near, bf16_abs_err_conv_bias=cb_abs,
                 bf16_repeatable=same)
        worst = {"fwd": max(worst["fwd"], fwd), "stats": max(worst["stats"], stats),
                 "fwd_abs": max(worst["fwd_abs"], float((y.float() - ry.float()).abs().max())),
                 "bwd": max(worst["bwd"], g_rel), "bwd_near": max(worst["bwd_near"], g_near),
                 "bwd_abs": max(worst["bwd_abs"], g_abs, cb_abs),
                 "conv_bias_abs": max(worst["conv_bias_abs"], cb_abs)}
        log(f"[bf16-tower-check] {g['name']}: R {g['R']} S {g['S']} C {g['C']} layers {L}"
            f"{' (first conv outside)' if g['external'] else ''}: #13-bf16 max|kernel-plain| / "
            f"max|plain| {fwd:.3e}, statistics {stats:.3e}; #14-bf16 max rel err {g_rel:.3e}, "
            f"near-zero max abs err {g_near:.3e}, conv biases (true 0) max abs err {cb_abs:.3e} "
            f"(gate {cb_tol:.2e}); same bits on a second call: {same}")
        if not (fwd <= BF16_FWD_TOL and stats <= DS_BF16_STATS_TOL):
            raise AssertionError(f"{g['name']}: #13-bf16 differs from plain: {fwd}, {stats}")
        if not (g_rel <= BF16_GRAD_TOL and g_near <= NEAR_ZERO and cb_abs <= cb_tol):
            raise AssertionError(f"{g['name']}: #14-bf16 differs from plain: {g_rel}, {g_near}, "
                                 f"conv biases {cb_abs}")
        if not same:
            raise AssertionError(f"{g['name']}: #13-bf16/#14-bf16 give other bits on a second call")
        del runs, grads, again, rgrads, x0, params, masks, dy
    torch.cuda.empty_cache()
    return worst


def tower_bf16_work(g):
    """(forward FLOPs, bytes, bound ms, bound_by; the same backward) of the
    bf16 tower at g: tower_work's operations, the convs at the bf16 tensor
    cores' peak and the rest at the f32 peak; the bytes at the types they
    move: the rows (x0, the output, dy, the saved c and a, dx0) and the
    weights in bf16 at 2 bytes, the other parameters, masks, statistics and
    parameter gradients at 4."""
    R, S, C = g["R"], g["S"], g["C"]
    RS = R * S
    f_fl, _, b_fl, _ = tower_work(g)
    conv = sum(0 if (k == 0 and g["external"]) else 2 * RS * kw * cin * cout
               for k, (kw, cin, cout, _) in enumerate(g["cfgs"]))
    weights = sum(0 if (k == 0 and g["external"]) else kw * cin * cout
                  for k, (kw, cin, cout, _) in enumerate(g["cfgs"]))
    L = len(g["cfgs"])
    cin0 = g["cfgs"][0][2] if g["external"] else g["cfgs"][0][1]
    small = 4 * (3 * L * C + L * g["samples"] * C)  # biases, BN affines, masks
    f_by = 2 * (RS * cin0 + weights + RS * C) + small + 4 * 2 * L * C
    b_by = 2 * (RS * C + 2 * L * RS * C + weights + RS * cin0) + small + 4 * (weights + 3 * L * C)
    out = []
    for fl, cv, by in ((f_fl, conv, f_by), (b_fl, 2 * conv, b_by)):
        t_ops = cv / BF16_FLOPS + (fl - cv) / F32_FLOPS
        t_by = by / HBM_BYTES_PER_S
        out += [fl, by, 1e3 * max(t_ops, t_by), "operations" if t_ops >= t_by else "bytes"]
    return out


# conv_tower.cu's kernels that only its f32 forms launch: the per-tap
# transpose of W (the bf16 transposed conv reads W as it lies) and the sums
# walked on one SM (the bf16 forms' cross-block sums go in slices)
F32_ONLY_TOWER = {"tap_transpose_kernel", "conv_gemm_kernel", "conv_wgrad_kernel",
                  "reduce_partials_kernel", "bn_stats_kernel", "bn_grad_stats_kernel"}


def bf16_tower_build():
    """The build of conv_tower.cu: its bf16 products' (ct_wg_*) lines from
    ptxas that say a wgmma pipeline was serialized (C7510-C7518, C7520) and
    each such kernel's HGMMA (wgmma) and HMMA (mma.sync) count in its SASS
    (cuobjdump beside nvcc). Returns {"serialized": [...], "sass": {kernel:
    [HGMMA, HMMA]}}."""
    from focal_tpu_torch.ops import _build

    log = open(_build.log_path("conv_tower.cu")).read()
    serialized = [line.strip() for line in log.splitlines()
                  if re.search(r"\((C75(?:1[0-8]|20))\).*ct_wg_", line)]
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library_path("conv_tower.cu")],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "ct_wg_" in m.group(1) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += bool(re.search(r"\bHMMA\b", line))
    return {"serialized": serialized, "sass": counts}


def time_tower_bf16(torch, np, ct, F, g, seed, dev):
    """#13-bf16 and #14-bf16 at one tower geometry, into g["bf16"]: by
    events and by device time (tower_phase_split: only conv_tower.cu's
    kernels and PyTorch's [C]-sized steps may run), the bf16 plain
    versions, the cuDNN bf16 chain (library_tower on bf16 rows) as the
    library yardstick (forward and its autograd backward), the bound
    (tower_bf16_work); and #13/#14 in f32
    at the same geometry by the same means (time_tower)."""
    bf = torch.bfloat16
    x0, params, masks, dy = tower_bf16_inputs(torch, np, g, seed, dev)
    kp = [[w.to(bf) for w in params[0]]] + params[1:]
    # the cuDNN bf16 chain's operands: bf16 weights, conv biases and masks,
    # the BatchNorm affine f32 (batch_norm takes bf16 rows with it)
    lp, lm = [kp[0], [b.to(bf) for b in params[1]]] + params[2:], [m.to(bf) for m in masks]
    cfgs, ext = g["cfgs"], g["external"]
    _, _, _, saved = ct.tower_forward(x0, cfgs, *kp, masks, ext)
    r = {"ms_fwd": time_ms_long(torch, lambda: ct.tower_forward(x0, cfgs, *kp, masks, ext)),
         "ms_bwd": time_ms_long(torch, lambda: ct.fused_conv_tower_backward_bf16(saved, dy))}
    with torch.no_grad():
        r["plain_ms_fwd"] = time_ms(torch, lambda: ct.tower_forward_bf16_reference(
            x0, cfgs, *params, masks, ext))
        _, _, _, psaved = ct.tower_forward_bf16_reference(x0, cfgs, *params, masks, ext)
        r["plain_ms_bwd"] = time_ms(torch, lambda: ct.tower_backward_bf16_reference(
            psaved, cfgs, masks, dy, ext))
        r["library_ms_fwd"] = time_ms(torch, lambda: library_tower(torch, F, x0, g, lp, lm))
    del psaved
    xl, pl_, leaves = tower_leaves(torch, x0, lp, ext)
    ly = library_tower(torch, F, xl, g, pl_, lm)
    dyl = dy.permute(0, 2, 1).unsqueeze(2)
    r["library_ms_bwd"] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves, dyl,
                                                                     retain_graph=True))
    del ly
    r["profile"] = {"fwd": tower_phase_split(torch, lambda: ct.tower_forward(x0, cfgs, *kp, masks,
                                                                            ext)),
                    "bwd": tower_phase_split(torch, lambda: ct.fused_conv_tower_backward_bf16(
                        saved, dy))}
    r["device_ms_fwd"], r["device_ms_bwd"] = (r["profile"][d]["device_ms"] for d in ("fwd", "bwd"))
    ran = set(r["profile"]["fwd"]["kernels"]) | set(r["profile"]["bwd"]["kernels"])
    if "ct_wg_conv_kernel" not in ran or "ct_wg_wgrad_kernel" not in ran or ran & F32_ONLY_TOWER:
        raise AssertionError(f"{g['name']}: the bf16 tower ran {sorted(ran)}: its products on "
                             f"wgmma expected, none of {sorted(F32_ONLY_TOWER)}")
    f_fl, f_by, r["bound_ms_fwd"], r["bound_by_fwd"], b_fl, b_by, r["bound_ms_bwd"], \
        r["bound_by_bwd"] = tower_bf16_work(g)
    r.update(flops_fwd=f_fl, bytes_fwd=f_by, flops_bwd=b_fl, bytes_bwd=b_by)
    del saved, x0, params, masks, dy, xl, pl_, leaves
    g["bf16"] = r
    time_tower(torch, np, ct, F, g, seed, dev)  # the f32 forms beside them, in this phase
    log(f"[bf16-tower-time] {g['name']}: #13-bf16 {r['ms_fwd']:.4f} ms (device "
        f"{r['device_ms_fwd']:.4f}; f32 #13 {g['fwd_ms']:.4f}, plain {r['plain_ms_fwd']:.4f}, "
        f"cuDNN bf16 chain {r['library_ms_fwd']:.4f}, bound {r['bound_ms_fwd']:.4f} "
        f"({r['bound_by_fwd']})); #14-bf16 {r['ms_bwd']:.4f} ms (device {r['device_ms_bwd']:.4f}; "
        f"f32 #14 {g['bwd_ms']:.4f}, plain {r['plain_ms_bwd']:.4f}, cuDNN bf16 chain "
        f"{r['library_ms_bwd']:.4f}, bound {r['bound_ms_bwd']:.4f} ({r['bound_by_bwd']}))")
    for d, what in (("fwd", "#13-bf16"), ("bwd", "#14-bf16")):
        pr = r["profile"][d]
        log(f"[profile-tower-bf16] {g['name']} {what}: device {pr['device_ms']:.4f} ms a call: "
            + ", ".join(f"{ph} {ms:.4f}" for ph, ms in sorted(pr["phases"].items(),
                                                               key=lambda kv: -kv[1])))
    torch.cuda.empty_cache()


def deepsense_bf16_paths(torch, np, kernels, dev):
    """Phase 30, DeepSense at -compute_dtype bfloat16 at MOD's full width:
    #13-bf16/#14-bf16 against the bf16 plain tower at every tower geometry
    of MOD, MOD_WIDE, the three other recipes and two-location MOD
    (check_towers_bf16) and timed at MOD's beside #13/#14 in f32 and the
    cuDNN bf16 chain; a served bf16 batch against the same model on the
    CPU; rate-0 pretrain and supervised steps from one init, -pallas_conv's
    kernels against their bf16 plain versions (the loss to BF16_LOSS_TOL,
    the gradients to C11's gates) and the cuDNN route's bf16 step against
    its f32 step (the loss); the pretrain entry point with -pallas_conv in
    bf16 with its launches held; MOD pretrain steps at DS_BATCH, bf16
    beside f32 on both routes."""
    import importlib

    import torch.nn.functional as F

    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.params import load_dataset_config, parse_train_params
    from focal_tpu_torch.serve import Predictor

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    tag = "ds-bf16"
    t_phase = time.time()
    cfg = load_dataset_config("MOD")
    task = "vehicle_classification"
    fwd_k, bwd_k = ct.fused_conv_tower_bf16, ct.fused_conv_tower_backward_bf16
    out = {"paths": {}}

    # the kernels against the bf16 plain tower at every geometry
    geos = (tower_geometries(cfg, 2 * DS_BATCH, "MOD")
            + tower_geometries(load_dataset_config("MOD_WIDE"), 2 * DS_WIDE_BATCH, "MOD_WIDE")
            + [g for r in RECIPES for g in tower_geometries(load_dataset_config(r), 2 * DS_BATCH, r)]
            + [g for g in tower_geometries(two_locations(cfg), 2 * DS_BATCH, "MOD two-location")
               if g["name"].endswith("mod_extractor")])
    out["errors"] = check_towers_bf16(torch, np, ct, geos, dev, seed0=3000)
    # the bf16 products compiled to wgmma, none to mma.sync, no pipeline serialized
    out["build"] = bf16_tower_build()
    sass = out["build"]["sass"]
    log(f"[{tag}] conv_tower.cu's bf16 products: {len(sass)} instances, HGMMA "
        f"{sorted({c[0] for c in sass.values()})}, HMMA {sorted({c[1] for c in sass.values()})}; "
        f"serialized-wgmma lines {len(out['build']['serialized'])}")
    if (len(sass) < 6 or any(hg == 0 or hm for hg, hm in sass.values())
            or out["build"]["serialized"]):
        raise AssertionError(f"{tag}: the bf16 tower's products are not all wgmma alone: "
                             f"{out['build']}")
    mod_geos = [g for g in geos if g["name"].startswith("MOD ") and "two-location" not in g["name"]]
    for gi, g in enumerate(mod_geos):
        time_tower_bf16(torch, np, ct, F, g, 3100 + gi, dev)
    per_step = {fwd_k.__name__: tower_launches(mod_geos)["fused_conv_tower"],
                bwd_k.__name__: tower_launches(mod_geos)["fused_conv_tower_backward"]}
    step = {}
    for d in ("fwd", "bwd"):
        step[d] = {k: sum(g["towers"] * g["bf16"][f"{k}_{d}"] for g in mod_geos) for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")}
        step[d]["f32_ms"] = sum(g["towers"] * g[f"{d}_ms"] for g in mod_geos)
        step[d]["f32_device_ms"] = sum(g["towers"] * g["profile"][d]["device_ms"] for g in mod_geos)
        split = {}
        for g in mod_geos:
            for ph, ms in g["bf16"]["profile"][d]["phases"].items():
                split[ph] = split.get(ph, 0.0) + g["towers"] * ms
        step[d]["device_ms_by_phase"] = split
        step[d]["bound_by"] = ("bytes" if all(g["bf16"][f"bound_by_{d}"] == "bytes"
                                              for g in mod_geos) else "operations")
    out["step"] = step
    out["geometries"] = [{k: v for k, v in g.items() if k not in ("cfgs", "profile")}
                         | {"bf16": {k: v for k, v in g.get("bf16", {}).items() if k != "profile"}}
                         for g in geos]
    f, b = step["fwd"], step["bwd"]
    log(f"[{tag}] the towers of one MOD step at {DS_BATCH} (views fused to {2 * DS_BATCH}): "
        f"#13-bf16 {f['ms']:.4f} ms (device {f['device_ms']:.4f}; f32 #13 {f['f32_ms']:.4f}, "
        f"device {f['f32_device_ms']:.4f}; plain {f['plain_ms']:.4f}, cuDNN bf16 chain "
        f"{f['library_ms']:.4f}, bound {f['bound_ms']:.4f}); #14-bf16 {b['ms']:.4f} ms (device "
        f"{b['device_ms']:.4f}; f32 #14 {b['f32_ms']:.4f}, device {b['f32_device_ms']:.4f}; plain "
        f"{b['plain_ms']:.4f}, cuDNN bf16 chain {b['library_ms']:.4f}, bound {b['bound_ms']:.4f})")

    # a served bf16 batch: the card against the same model on the CPU
    from focal_tpu_torch.data import synthetic_arrays

    data = synthetic_arrays(cfg, task, SERVE_BATCH, seed=5)[0]
    served = {}
    for where in ("cuda", "cpu"):
        pred = Predictor(cfg, "DeepSense", task, None, batch_size=SERVE_BATCH, device=where,
                         seed=0, compute_dtype="bfloat16")
        zero_counts(kernels)
        res = pred.predict(data)
        if where == "cuda":
            check_counts(f"{tag}: one served bf16 batch", counts(kernels),
                         {k.__name__: 0 for k in kernels})
            out["serve"] = {"p50_ms": res["latency"]["p50_s"] * 1e3}
        served[where] = res["probs"]
        del pred
    probs = served["cuda"]
    if probs.dtype != np.float32 or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: bad served probabilities ({probs.dtype})")
    serve_err = float(np.abs(probs - served["cpu"]).max())
    out["serve"]["max_abs_err_vs_cpu"] = serve_err
    log(f"[{tag}] served DeepSense bf16 batch of {SERVE_BATCH}: p50 {out['serve']['p50_ms']:.3f} "
        f"ms, no kernel launched; max|dprobs| vs the same model on the CPU {serve_err:.3e}")
    if not serve_err <= BF16_SERVE_TOL:
        raise AssertionError(f"{tag}: served bf16 probabilities differ from the CPU's by {serve_err}")
    torch.cuda.empty_cache()

    # rate-0 steps from one init: pretrain at DS_BATCH (views fused), supervised at SUP_BATCH
    initial = init_params(build_backbone(cfg, "DeepSense", task, "FOCAL"), seed=0).state_dict()
    out["rate0"] = {}
    for stage, framework, batch in (("pretrain", "FOCAL", DS_BATCH), ("supervised", "no", SUP_BATCH)):
        def step_once(dtype, pallas, plain=False):
            sargs = parse_train_params(["-dataset", "MOD", "-model", "DeepSense", "-learn_framework",
                                        framework, "-batch_size", str(batch), "-compute_dtype",
                                        dtype] + (["-pallas_conv"] if pallas else []))
            zero_counts(kernels)
            loss, grads, _ = deepsense_rate0_step(torch, sargs, initial, dev, plain)
            torch.cuda.synchronize()
            return loss, list(grads.values()), list(grads), counts(kernels)

        kern = step_once("bfloat16", True)
        plain = step_once("bfloat16", True, plain=True)
        cud = step_once("bfloat16", False)
        f32 = step_once("float32", False)
        n = tower_launches(tower_geometries(cfg, 2 * batch if stage == "pretrain" else batch, "MOD"))
        check_counts(f"{tag}: the rate-0 -pallas_conv bf16 {stage} step", kern[3],
                     {k.__name__: {fwd_k.__name__: n["fused_conv_tower"],
                                   bwd_k.__name__: n["fused_conv_tower_backward"]}.get(k.__name__, 0)
                      for k in kernels})
        for what, run in (("plain", plain), ("cuDNN route", cud), ("f32", f32)):
            check_counts(f"{tag}: the {what} rate-0 {stage} step", run[3],
                         {k.__name__: 0 for k in kernels})
        r = {"loss_kernels": kern[0], "loss_plain": plain[0], "loss_cudnn_bf16": cud[0],
             "loss_cudnn_f32": f32[0],
             "loss_rel_vs_plain": abs(kern[0] - plain[0]) / abs(plain[0]),
             "loss_rel_cudnn_vs_f32": abs(cud[0] - f32[0]) / abs(f32[0]),
             "grad_dtypes": sorted({str(g.dtype) for g in kern[1] + cud[1]})}
        log(f"[{tag}] rate-0 {stage} step: loss -pallas_conv bf16 {kern[0]:.6f}, its plain "
            f"{plain[0]:.6f} (rel {r['loss_rel_vs_plain']:.2e}); cuDNN route bf16 {cud[0]:.6f}, "
            f"f32 {f32[0]:.6f} (rel {r['loss_rel_cudnn_vs_f32']:.2e}); gradients {r['grad_dtypes']}")
        r["grad_gates"] = bf16_grad_gates(f"{tag}-{stage}", kern[2], kern[1], plain[1])
        if not (r["loss_rel_vs_plain"] <= BF16_LOSS_TOL and r["loss_rel_cudnn_vs_f32"] <= BF16_LOSS_TOL):
            raise AssertionError(f"{tag}: rate-0 {stage} step losses: {r}")
        if r["grad_dtypes"] != ["torch.float32"]:
            raise AssertionError(f"{tag}: bf16 step gradients are not f32: {r['grad_dtypes']}")
        out["rate0"][stage] = r
        del kern, plain, cud, f32
        torch.cuda.empty_cache()

    # the pretrain entry point with -pallas_conv in bf16, launches held
    run_dir = os.path.join(HERE, "build", "chip_smoke_ds_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["-dataset", "MOD", "-model", "DeepSense", "-learn_framework", "FOCAL", "-stage",
            "pretrain", "-pallas_conv", "-synthetic", "-synthetic_samples", str(DS_SAMPLES),
            "-batch_size", str(DS_BATCH), "-val_epochs", "1", "-epochs", "1", "-output_dir",
            run_dir, "-compute_dtype", "bfloat16"]
    steps, _ = stage_plan(argv)
    zero_counts(kernels)
    t0 = time.time()
    st, _, points = train_cli.main(argv)
    torch.cuda.synchronize()
    got = counts(kernels)
    # eval forwards launch nothing: the counts are the steps' alone
    check_counts(f"{tag}: pretrain -pallas_conv -compute_dtype bfloat16 -epochs 1", got,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    if st.step != steps or not all(math.isfinite(p[k]) for p in points
                                   for k in ("train_loss", "val_loss", "test_loss")):
        raise AssertionError(f"{tag}: {st.step} updates of {steps}, points {points}")
    if any(p.dtype != torch.float32 for p in st.model.parameters()):
        raise AssertionError(f"{tag}: the bf16 run's parameters are not f32")
    out["paths"]["pretrain -pallas_conv -compute_dtype bfloat16 -epochs 1"] = {
        "seconds": time.time() - t0, "steps": steps, "launches": got, "points": points}
    log(f"[{tag}] pretrain -pallas_conv -compute_dtype bfloat16: {steps} steps in "
        f"{time.time() - t0:.1f}s; launches {got}")
    del st
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # timed MOD pretrain steps, bf16 beside f32, on both routes
    out["steps"] = {}
    for pallas in (False, True):
        for dtype in ("float32", "bfloat16"):
            dargs = parse_train_params(["-dataset", "MOD", "-model", "DeepSense",
                                        "-learn_framework", "FOCAL", "-stage", "pretrain",
                                        "-batch_size", str(DS_BATCH), "-compute_dtype", dtype]
                                       + (["-pallas_conv"] if pallas else []))
            run_tag = f"{tag}-{'pallas' if pallas else 'cudnn'}-{dtype}"
            want = {}
            if pallas:
                want = ({fwd_k.__name__: per_step[fwd_k.__name__],
                         bwd_k.__name__: per_step[bwd_k.__name__]} if dtype == "bfloat16"
                        else tower_launches(mod_geos))
            summary, trained = run_deepsense_steps(torch, np, dargs, DS_BATCH, TRAIN_WARMUP,
                                                   TRAIN_STEPS, kernels, want, dev, run_tag)
            summary.pop("profile")
            out["steps"][run_tag] = summary
            del trained
            torch.cuda.empty_cache()
    for route in ("cudnn", "pallas"):
        a, b = out["steps"][f"{tag}-{route}-float32"], out["steps"][f"{tag}-{route}-bfloat16"]
        log(f"[{tag}] {route} route, bf16 beside f32: p50 {b['p50_ms']:.3f} vs {a['p50_ms']:.3f} "
            f"ms, device busy {b['device_busy_ms']:.3f} vs {a['device_busy_ms']:.3f} ms, idle "
            f"share {b['idle_share']:.3f} vs {a['idle_share']:.3f}, device operations "
            f"{b['device_ops']} vs {a['device_ops']}, peak {b['peak_mb']:.1f} vs "
            f"{a['peak_mb']:.1f} MiB")
    out["seconds"] = time.time() - t_phase
    log(f"[{tag}] phase 30 in {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# MOD_WIDE in bf16 (31): #4-bf16 and #5-bf16; -pallas_mlp in bf16 (32):
# #10-bf16 to #12-bf16

WIDE_BF16_SAMPLES = 256  # MOD_WIDE synthetic train split of phase 31's entry-point run
# C14: phase 31's rate-0 MOD_WIDE bf16 step holds the kernels' median
# gradient error to C11's gate or, where the bf16 plain versions' own floor
# (f32 sums against float64 sums, measured in the same run) is higher, to
# this multiple of it (on the H100 the floor read 6.39e-2, the kernels 6.58e-2)
BF16_FLOOR_MARGIN = 1.25
MLP_BF16_STEPS = 5       # timed supervised steps of each route in phase 32


def check_perhead_bf16(torch, pk, geos, gen, dev, rate):
    """#4-bf16 and #5-bf16 against their bf16 plain versions (those of #1-#3)
    at the per-head geometries, in the working type: #4-bf16 at rate 0 and
    with dropout (fed its own mask), y to BF16_FWD_TOL of max|y|, the keep
    rate within 5 sigma of 1 - rate and the mask #2's for the same seed;
    #5-bf16 with the mask and without, every gradient to BF16_GRAD_TOL
    relative (absolutely to TINY_GRAD where both sides are below it, C7),
    the same bits on a second call. Returns the worst errors."""
    ph_fwd, ph_bwd = pk.fused_window_block_perhead_bf16, pk.fused_window_block_perhead_backward_bf16
    worst = {"fwd": 0.0, "fwd_abs": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for gi, g in enumerate(geos):
        args = bf16_inputs(torch, g, gen, dev)
        y0, none = ph_fwd(*args)
        y, keep = ph_fwd(*args, 3100 + gi, rate)
        f32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a for a in args]
        same_mask = bool(torch.equal(pk.fused_window_block_dropout(*f32, 3100 + gi, rate)[1], keep))
        torch.cuda.synchronize()
        if none is not None:
            raise AssertionError(f"{g['name']}: #4-bf16 at rate 0 returned a keep mask")
        errs_f = {}
        for tag, yy, kp in (("rate0", y0, None), ("dropout", y, keep)):
            want = pk.fused_window_block_bf16_reference(*args, kp, rate if kp is not None else 0.0)
            errs_f[tag] = rel_err(yy.float(), want.float())
            worst["fwd_abs"] = max(worst["fwd_abs"], float((yy.float() - want.float()).abs().max()))
        kept = float(keep.double().mean())
        sigma = math.sqrt(rate * (1 - rate) / keep.numel())
        dy = torch.randn(y.shape, generator=gen).to(dev).to(torch.bfloat16)
        errs = {}
        for tag, kp in (("keep", keep), ("nomask", None)):
            got = ph_bwd(*args, dy, kp, rate)
            again = ph_bwd(*args, dy, kp, rate)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{g['name']}: #5-bf16 gives other bits on a second call")
            want = pk.fused_window_block_backward_bf16_reference(*args, dy, kp, rate)
            errs[tag] = bf16_grad_err(got, want)
            worst["bwd_abs"] = max(worst["bwd_abs"], *(float((a.float() - b.float()).abs().max())
                                                       for a, b in zip(got, want)))
            del got, again, want
        g.update(bf16_rel_err_fwd=errs_f["rate0"], bf16_rel_err_dropout=errs_f["dropout"],
                 bf16_keep_rate=kept, bf16_mask_is_2s=same_mask, bf16_rel_err_bwd=errs["keep"],
                 bf16_rel_err_bwd_nomask=errs["nomask"])
        worst["fwd"] = max(worst["fwd"], *errs_f.values())
        worst["bwd"] = max(worst["bwd"], *errs.values())
        log(f"[wide-bf16-check] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: "
            f"#4-bf16 rel err {errs_f['rate0']:.3e} (rate 0), {errs_f['dropout']:.3e} (dropout), "
            f"keep rate {kept:.5f} ({(kept - 1 + rate) / sigma:+.2f} sigma), #2's mask "
            f"{same_mask}; #5-bf16 max rel err {errs['keep']:.3e} (mask), {errs['nomask']:.3e} "
            "(no mask), repeatable")
        if not max(errs_f.values()) <= BF16_FWD_TOL:
            raise AssertionError(f"{g['name']}: #4-bf16 differs from plain by {errs_f}")
        if not (abs(kept - (1 - rate)) <= 5 * sigma and same_mask):
            raise AssertionError(f"{g['name']}: #4-bf16's mask (keep rate {kept}, #2's: "
                                 f"{same_mask})")
        if not max(errs.values()) <= BF16_GRAD_TOL:
            raise AssertionError(f"{g['name']}: #5-bf16 gradients differ from plain by {errs}")
    return worst


def wide_bf16_paths(torch, np, kernels, gen, dev):
    """Phase 31, MOD_WIDE's SW_Transformer at -compute_dtype bfloat16: #4-bf16
    and #5-bf16 against their bf16 plain versions at every per-head geometry
    of the wide training batch (check_perhead_bf16's gates) and timed there;
    3 + 3 bf16 and f32 pretrain steps at WIDE_BATCH from one init, beside
    each other (#2-bf16/#3-bf16 4 and #4-bf16/#5-bf16 12 a step); the rate-0
    bf16 step, kernels against the bf16 plain versions (BF16_LOSS_TOL, C11's
    gradient gates, the median's to the plain versions' own floor where
    that is higher: C14); the pretrain entry point for an epoch and a
    served batch against the bf16 plain block, launches held exactly."""
    import importlib

    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_dataset_config, parse_train_params
    from focal_tpu_torch.serve import Predictor

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    tag = "wide-bf16"
    t_phase = time.time()
    cfg = load_dataset_config("MOD_WIDE")
    task = "vehicle_classification"
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    wgeos = block_geometries(cfg, 2 * WIDE_BATCH)
    mono = [g for g in wgeos if pk.wblock_fits(g["N"], g["C"], g["heads"])]
    pgeos = [g for g in wgeos if not pk.wblock_fits(g["N"], g["C"], g["heads"])]
    n_mono, n_ph = (sum(g["per_forward"] for g in gs) for gs in (mono, pgeos))
    bf_fwd, bf_drop, bf_bwd = (pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
                               pk.fused_window_block_backward_bf16)
    ph_fwd, ph_bwd = pk.fused_window_block_perhead_bf16, pk.fused_window_block_perhead_backward_bf16
    step_bf16 = {bf_drop.__name__: n_mono, bf_bwd.__name__: n_mono, ph_fwd.__name__: n_ph,
                 ph_bwd.__name__: n_ph}
    eval_bf16 = {bf_fwd.__name__: n_mono, ph_fwd.__name__: n_ph}
    step_f32 = {pk.fused_window_block_dropout.__name__: n_mono,
                pk.fused_window_block_backward.__name__: n_mono,
                pk.fused_window_block_perhead.__name__: n_ph,
                pk.fused_window_block_perhead_backward.__name__: n_ph}
    log(f"[{tag}] MOD_WIDE at batch {WIDE_BATCH} (views fused to {2 * WIDE_BATCH}): {len(pgeos)} "
        f"per-head geometries (C {sorted({g['C'] for g in pgeos})}), {n_ph} per-head and {n_mono} "
        f"whole-block launches a forward")
    out = {"paths": {}, "launches_per_step": step_bf16}

    # the kernels against their bf16 plain versions, then timed
    out["errors"] = check_perhead_bf16(torch, pk, pgeos, gen, dev, rate)
    for g in pgeos:
        time_block_bf16(torch, pk, g, gen, dev, rate, train=True, perhead=True)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")
    out["train_step"] = {d: {k: sum(g["per_forward"] * g[f"bf16_{d}"][k] for g in pgeos)
                             for k in keys} for d in ("fwd", "bwd")}
    for d in ("fwd", "bwd"):
        split = {}
        for g in pgeos:
            for ph, ms in g[f"bf16_{d}"]["device_ms_by_phase"].items():
                split[ph] = split.get(ph, 0.0) + g["per_forward"] * ms
        out[f"train_{d}_device_ms_by_phase"] = split
    t = out["train_step"]
    log(f"[{tag}] one MOD_WIDE bf16 step's {n_ph} per-head launches: #4-bf16 {t['fwd']['ms']:.4f} "
        f"ms (device {t['fwd']['device_ms']:.4f}, plain {t['fwd']['plain_ms']:.4f}, library "
        f"{t['fwd']['library_ms']:.4f}, bound {t['fwd']['bound_ms']:.4f}), #5-bf16 "
        f"{t['bwd']['ms']:.4f} (device {t['bwd']['device_ms']:.4f}, plain "
        f"{t['bwd']['plain_ms']:.4f}, library {t['bwd']['library_ms']:.4f}, bound "
        f"{t['bwd']['bound_ms']:.4f})")
    out["geometries"] = [{k: v for k, v in g.items() if k != "mask"} for g in pgeos]
    torch.cuda.empty_cache()

    # the bf16 pretrain steps beside the f32 ones, from one init
    out["steps"] = bf16_step_runs(torch, np, kernels, dev, f"{tag}-steps", dataset="MOD_WIDE",
                                  batch=WIDE_BATCH, steps=WIDE_STEPS,
                                  per_step={"float32": step_f32, "bfloat16": step_bf16})
    torch.cuda.empty_cache()

    # the rate-0 bf16 step from one state: kernels against the bf16 plain versions
    initial = init_params(build_backbone(cfg, "SW_Transformer", task, "FOCAL"), seed=0).state_dict()
    rargs = parse_train_params(["-dataset", "MOD_WIDE", "-learn_framework", "FOCAL",
                                "-batch_size", str(WIDE_BATCH), "-compute_dtype", "bfloat16"])
    kern = rate0_tail_step(torch, rargs, initial, dev, plain=False, kernels=kernels)
    plain = rate0_tail_step(torch, rargs, initial, dev, plain=True, kernels=kernels)
    # C14: the plain versions' own floor, f32 sums against float64 ones
    refs = pk.fused_window_block_bf16_reference, pk.fused_window_block_backward_bf16_reference
    pk.fused_window_block_bf16_reference, pk.fused_window_block_backward_bf16_reference = (
        functools.partial(ref, acc=torch.float64) for ref in refs)
    try:
        exact = rate0_tail_step(torch, rargs, initial, dev, plain=True, kernels=kernels)
    finally:
        pk.fused_window_block_bf16_reference, pk.fused_window_block_backward_bf16_reference = refs
    floor = bf16_grad_stats(plain[3], plain[1], exact[1])
    median_tol = max(BF16_GRAD_MEDIAN_TOL, BF16_FLOOR_MARGIN * floor["median_rel"])
    log(f"[{tag}] the bf16 plain versions' own floor (f32 sums vs float64 sums): loss "
        f"{plain[0]:.6f} vs {exact[0]:.6f}; min cosine {floor['min_cos']:.5f} "
        f"({floor['min_cos_tensor']}), median rel {floor['median_rel']:.3e}, max rel "
        f"{floor['max_rel']:.3e} ({floor['max_rel_tensor']}); the median gate "
        f"max({BF16_GRAD_MEDIAN_TOL}, {BF16_FLOOR_MARGIN} x floor) = {median_tol:.3e}")
    check_counts(f"{tag}: the rate-0 bf16 step", kern[2],
                 {k.__name__: {bf_fwd.__name__: n_mono, bf_bwd.__name__: n_mono,
                               ph_fwd.__name__: n_ph, ph_bwd.__name__: n_ph}.get(k.__name__, 0)
                  for k in kernels})
    check_counts(f"{tag}: the rate-0 bf16 plain step", plain[2], {k.__name__: 0 for k in kernels})
    vs_plain = abs(kern[0] - plain[0]) / abs(plain[0])
    out["rate0"] = {"loss_bf16_kernels": kern[0], "loss_bf16_plain": plain[0],
                    "loss_rel_vs_bf16_plain": vs_plain, "launches": kern[2],
                    "grad_dtypes": sorted({str(g.dtype) for g in kern[1]})}
    log(f"[{tag}] rate-0 MOD_WIDE bf16 pretrain step at {WIDE_BATCH} from the initial state: "
        f"loss {kern[0]:.6f}, bf16 plain {plain[0]:.6f} (rel {vs_plain:.2e}); launches {kern[2]}")
    if not vs_plain <= BF16_LOSS_TOL:
        raise AssertionError(f"{tag}: rate-0 bf16 step loss: {out['rate0']}")
    if out["rate0"]["grad_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"{tag}: bf16 step gradients are not f32: {out['rate0']}")
    out["rate0"]["floor"] = floor
    out["rate0"]["loss_bf16_plain_f64_sums"] = exact[0]
    out["rate0"]["grad_gates"] = bf16_grad_gates(tag, kern[3], kern[1], plain[1], median_tol)
    del kern, plain, exact, initial
    torch.cuda.empty_cache()

    # the pretrain entry point in bf16 for an epoch
    run_dir = os.path.join(HERE, "build", "chip_smoke_wide_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    pre = ["-dataset", "MOD_WIDE", "-model", "SW_Transformer", "-synthetic", "-synthetic_samples",
           str(WIDE_BF16_SAMPLES), "-val_epochs", "1", "-output_dir", run_dir, "-compute_dtype",
           "bfloat16", "-learn_framework", "FOCAL", "-stage", "pretrain", "-batch_size",
           str(WIDE_BATCH), "-epochs", "1"]
    steps, evals = stage_plan(pre)
    st, _, points = run_entry_points(torch, kernels, out, tag,
                                     "pretrain MOD_WIDE -compute_dtype bfloat16 -epochs 1",
                                     train_cli.main, pre, step_bf16, eval_bf16, steps, evals)
    if st.step != steps or not all(math.isfinite(p[k]) for p in points
                                   for k in ("train_loss", "val_loss", "test_loss")):
        raise AssertionError(f"{tag}: {st.step} updates of {steps}, points {points}")
    del st
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # a served bf16 batch, kernels vs the bf16 plain block
    from focal_tpu_torch.data import synthetic_arrays

    data = synthetic_arrays(cfg, task, WIDE_BATCH, seed=5)[0]
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=WIDE_BATCH,
                          device=dev.type, seed=0, compute_dtype="bfloat16")
    zero_counts(kernels)
    served = predictor.predict(data)
    got = counts(kernels)
    check_counts(f"{tag}: one served MOD_WIDE bf16 batch", got,
                 {k.__name__: eval_bf16.get(k.__name__, 0) for k in kernels})
    probs = served["probs"]
    if probs.dtype != np.float32 or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: bad probabilities ({probs.dtype})")
    swin_mod.window_block_forward = pk.fused_window_block_reference
    try:
        serve_err = float(np.abs(predictor._forward(data) - probs).max())
    finally:
        swin_mod.window_block_forward = pk.window_block_forward
    out["serve"] = {"p50_ms": served["latency"]["p50_s"] * 1e3, "launches": got,
                    "max_abs_err_vs_plain": serve_err}
    log(f"[{tag}] served MOD_WIDE bf16 batch of {WIDE_BATCH}: launches {got}, p50 "
        f"{out['serve']['p50_ms']:.3f} ms; max|dprobs| vs the bf16 plain block {serve_err:.3e}")
    if not serve_err <= BF16_SERVE_TOL:
        raise AssertionError(f"{tag}: served bf16 probabilities differ from the plain block's by "
                             f"{serve_err}")
    del predictor
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"[{tag}] phase 31 in {out['seconds']:.1f}s")
    return out


def mlp_bf16_inputs(torch, np, g, seed, dev):
    """mlp_inputs with x and the gradient rounded to bf16 (the weights and
    biases stay f32, as the Swin Mlp hands them)."""
    x, w1, b1, w2, b2, gy = mlp_inputs(torch, np, g, seed, dev)
    return x.to(torch.bfloat16), w1, b1, w2, b2, gy.to(torch.bfloat16)


def mlp_bf16_work(g, backward):
    """(FLOPs, bytes, bound ms, what bounds) of one #10-bf16/#11-bf16 or
    #12-bf16 launch: mlp_work's FLOPs; bytes at the types they move (x, y, g
    and dx bf16; the weights read and their gradients written in f32), each
    once; the bound at the bf16 tensor cores' peak or the bytes."""
    T, C, H = g["T"], g["C"], g["H"]
    flops = mlp_work(g, backward)[0]
    if backward:
        nbytes = 2 * 3 * T * C + 4 * (4 * C * H + 2 * H + C)
    else:
        nbytes = 2 * 2 * T * C + 4 * (2 * C * H + H + C)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_mlps_bf16(torch, np, fm, geos, dev, rate, seed0=700):
    """#10-bf16, #11-bf16 and #12-bf16 against their bf16 plain versions at
    each MLP geometry: y to BF16_FWD_TOL of max|y| (#11-bf16 fed its own
    masks, mlp_keep_masks: #11's), each mask's keep rate within 5 sigma,
    #12-bf16 with the masks and without, every gradient to BF16_GRAD_TOL
    relative (absolutely to TINY_GRAD where both sides are below it), the
    same bits on a second call of each. Returns the worst errors."""
    fwd, drop, bwd = (fm.fused_mlp_forward_bf16, fm.fused_mlp_dropout_forward_bf16,
                      fm.fused_mlp_backward_bf16)
    worst = {"fwd": 0.0, "fwd_abs": 0.0, "drop": 0.0, "drop_abs": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for gi, g in enumerate(geos):
        T, C, H = g["T"], g["C"], g["H"]
        x, w1, b1, w2, b2, gy = mlp_bf16_inputs(torch, np, g, seed0 + gi, dev)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        seed = seed0 + 3700 + gi
        y, y_again = fwd(x, w1, b1, w2, b2), fwd(x, w1, b1, w2, b2)
        yd, yd_again = drop(x, w1, b1, w2, b2, seed, rate), drop(x, w1, b1, w2, b2, seed, rate)
        keep1, keep2 = fm.mlp_keep_masks(seed, T, C, H, rate, dev)
        torch.cuda.synchronize()
        same = torch.equal(y, y_again) and torch.equal(yd, yd_again)
        errs_f = {}
        for tag, yy, masks in (("fwd", y, ()), ("drop", yd, (keep1, keep2, rate))):
            want = fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2, *masks).float()
            errs_f[tag] = rel_err(yy.float(), want)
            worst[f"{tag}_abs"] = max(worst[f"{tag}_abs"], float((yy.float() - want).abs().max()))
        rates = {}
        for name, k in (("keep1", keep1), ("keep2", keep2)):
            kept = float(k.double().mean())
            rates[name] = (kept, (kept - 1 + rate) / math.sqrt(rate * (1 - rate) / k.numel()))
        errs = {}
        for tag, sd, masks in (("mask", seed, (keep1, keep2, rate)), ("nomask", None, ())):
            got = bwd(x, w1, b1, w1t, w2t, gy, sd, rate)
            again = bwd(x, w1, b1, w1t, w2t, gy, sd, rate)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
            want = fm.fused_mlp_backward_bf16_reference(x, w1, b1, w2, b2, gy, *masks)
            errs[tag] = bf16_grad_err(got, want)
            worst["bwd_abs"] = max(worst["bwd_abs"], *(float((a.float() - b.float()).abs().max())
                                                       for a, b in zip(got, want)))
            del got, again, want
        g.update(bf16_rel_err_fwd=errs_f["fwd"], bf16_rel_err_dropout=errs_f["drop"],
                 bf16_keep_rates=rates, bf16_rel_err_bwd=errs["mask"],
                 bf16_rel_err_bwd_nomask=errs["nomask"], bf16_repeatable=same)
        worst["fwd"], worst["drop"] = max(worst["fwd"], errs_f["fwd"]), max(worst["drop"],
                                                                           errs_f["drop"])
        worst["bwd"] = max(worst["bwd"], *errs.values())
        log(f"[mlp-bf16-check] {g['name']}: T {T} C {C} H {H} ({g['per_forward']} a forward): "
            f"#10-bf16 rel err {errs_f['fwd']:.3e}, #11-bf16 {errs_f['drop']:.3e} (its own masks), "
            "keep rates " + ", ".join(f"{k} {v[0]:.5f} ({v[1]:+.2f} sigma)" for k, v in rates.items())
            + f"; #12-bf16 max rel err {errs['mask']:.3e} (masks), {errs['nomask']:.3e} (none); "
            f"same bits on a second call: {same}")
        if not max(errs_f.values()) <= BF16_FWD_TOL:
            raise AssertionError(f"{g['name']}: #10-bf16/#11-bf16 differ from plain by {errs_f}")
        if not all(abs(v[1]) <= 5 for v in rates.values()):
            raise AssertionError(f"{g['name']}: keep rates {rates} not 1 - {rate} within 5 sigma")
        if not max(errs.values()) <= BF16_GRAD_TOL:
            raise AssertionError(f"{g['name']}: #12-bf16 gradients differ from plain by {errs}")
        if not same:
            raise AssertionError(f"{g['name']}: #10-#12-bf16 give other bits on a second call")
        del x, w1, b1, w2, b2, gy, w1t, w2t, y, y_again, yd, yd_again, keep1, keep2
    return worst


def time_mlp_bf16(torch, np, fm, F, g, seed, dev, rate):
    """#10-bf16, #11-bf16 and #12-bf16 at g, stored in g["bf16"]: events
    over at least PROFILE_TRACE_MS of calls, device time from a profile
    split by kernel (kernel_phase_split: it fails on a kernel outside
    csrc/fused_mlp.cu), the plain versions, the library yardstick in bf16
    (addmm -> GELU -> addmm on bf16 weights, F.dropout for #11, its
    autograd backward for #12) and the bound (mlp_bf16_work)."""
    T, C, H = g["T"], g["C"], g["H"]
    x, w1, b1, w2, b2, gy = mlp_bf16_inputs(torch, np, g, seed, dev)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    keep1, keep2 = fm.mlp_keep_masks(7, T, C, H, rate, dev)
    lib_w = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
    chunks = [fm.mlp_launch_plan(T, C, H, d, dev, torch.bfloat16)[1] for d in (False, True)]
    calls = {
        "fwd": (lambda: fm.fused_mlp_forward_bf16(x, w1, b1, w2, b2),
                lambda: fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2),
                lambda: library_mlp(torch, F, x, *lib_w)),
        "drop": (lambda: fm.fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, 7, rate),
                 lambda: fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2, keep1, keep2, rate),
                 lambda: library_mlp(torch, F, x, *lib_w, rate)),
        "bwd": (lambda: fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, gy, 7, rate),
                lambda: fm.fused_mlp_backward_bf16_reference(x, w1, b1, w2, b2, gy, keep1, keep2,
                                                             rate), None)}
    leaves = [t.clone().requires_grad_(True) for t in [x] + lib_w]
    ly = library_mlp(torch, F, *leaves, rate)
    bwd_library = time_ms(torch, lambda: torch.autograd.grad(ly, leaves, gy, retain_graph=True))
    del ly, leaves
    out = {}
    for d, (kernel, plain, library) in calls.items():
        with torch.no_grad():
            kernel()
            torch.cuda.synchronize()
            split = kernel_phase_split(torch, kernel, mlp_launches(
                chunks[d == "bwd"], "bwd" if d == "bwd" else "fwd", bf16_C=C), MLP_LIB,
                reps=trace_reps(torch, kernel))
            flops, nbytes, bnd, by = mlp_bf16_work(g, backward=d == "bwd")
            out[d] = {"ms": time_ms_long(torch, kernel), "device_ms": split["device_ms"],
                      "device_ms_by_phase": split["phases"], "plain_ms": time_ms(torch, plain),
                      "library_ms": time_ms(torch, library) if library else bwd_library,
                      "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes}
        r = out[d]
        log(f"[mlp-bf16-time] {g['name']} (T {T}, C {C}, {chunks[0]} / {chunks[1]} chunks) "
            f"{ {'fwd': '#10-bf16', 'drop': '#11-bf16', 'bwd': '#12-bf16'}[d]}: {r['ms']:.4f} ms "
            f"(device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {bnd:.4f} ({by}), {flops / r['device_ms'] / 1e9:.2f} "
            f"TFLOP/s by device time; by phase {split['phases']}")
    g["bf16"] = out
    g["bf16_chunks"] = chunks


def mlp_bf16_paths(torch, np, kernels, dev):
    """Phase 32, -pallas_mlp at -compute_dtype bfloat16: #10-bf16 to
    #12-bf16 against their bf16 plain versions at MOD's MLP geometries (batch
    128) and MOD_WIDE's stage 0 (64 fused to 128) (check_mlps_bf16's gates)
    and timed there; 3 + MLP_BF16_STEPS MOD bf16 supervised steps at 128 on
    the cuBLAS-MLP route and with -pallas_mlp from one init, beside each
    other (#11-bf16/#12-bf16 16 a step); the rate-0 -pallas_mlp bf16 step,
    kernels against the bf16 plain versions (BF16_LOSS_TOL, C11's gradient
    gates); the supervised entry point for an epoch and the test CLI on its
    _best; a served batch against the bf16 plain route, launches held
    exactly (#10-bf16 16 a batch)."""
    import importlib

    import torch.nn.functional as F

    from focal_tpu_torch import test as test_cli
    from focal_tpu_torch.data import DeviceDataLoader, load_split, synthetic_arrays
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_dataset_config, parse_train_params
    from focal_tpu_torch.serve import Predictor

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    tag = "mlp-bf16"
    t_phase = time.time()
    cfg, wcfg = load_dataset_config("MOD"), load_dataset_config("MOD_WIDE")
    task = "vehicle_classification"
    rate = float(cfg["SW_Transformer"]["dropout_ratio"])
    mgeos = (mlp_geometries(cfg, SUP_BATCH, "MOD")
             + mlp_geometries(wcfg, 2 * WIDE_BATCH, "MOD_WIDE"))
    n_blocks = sum(g["per_forward"] for g in block_geometries(cfg, SUP_BATCH))
    n_mlp = sum(g["per_forward"] for g in mgeos if g["name"].startswith("MOD "))
    bf_fwd, bf_drop, bf_bwd = (pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
                               pk.fused_window_block_backward_bf16)
    m_fwd, m_drop, m_bwd = (fm.fused_mlp_forward_bf16, fm.fused_mlp_dropout_forward_bf16,
                            fm.fused_mlp_backward_bf16)
    step_mlp = {bf_drop.__name__: n_blocks, bf_bwd.__name__: n_blocks, m_drop.__name__: n_mlp,
                m_bwd.__name__: n_mlp}
    eval_mlp = {bf_fwd.__name__: n_blocks, m_fwd.__name__: n_mlp}
    out = {"paths": {}, "launches_per_step": step_mlp, "launches_per_eval_forward": eval_mlp}

    # the kernels against their bf16 plain versions, then timed
    out["errors"] = check_mlps_bf16(torch, np, fm, mgeos, dev, rate)
    for gi, g in enumerate(mgeos):
        time_mlp_bf16(torch, np, fm, F, g, 900 + gi, dev, rate)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")
    for ds in ("MOD", "MOD_WIDE"):
        gs = [g for g in mgeos if g["name"].split()[0] == ds]
        out[f"{ds}_forward"] = {d: {k: sum(g["per_forward"] * g["bf16"][d][k] for g in gs)
                                    for k in keys} for d in ("fwd", "drop", "bwd")}
        for d in ("fwd", "drop", "bwd"):
            split = {}
            for g in gs:
                for ph, ms in g["bf16"][d]["device_ms_by_phase"].items():
                    split[ph] = split.get(ph, 0.0) + g["per_forward"] * ms
            out[f"{ds}_forward"][d]["device_ms_by_phase"] = split
        t = out[f"{ds}_forward"]
        log(f"[{tag}] the MLPs of one {ds} forward ({sum(g['per_forward'] for g in gs)} launches): "
            + "; ".join(f"{n} {t[d]['ms']:.4f} ms (device {t[d]['device_ms']:.4f}, plain "
                        f"{t[d]['plain_ms']:.4f}, library {t[d]['library_ms']:.4f}, bound "
                        f"{t[d]['bound_ms']:.4f})"
                        for d, n in (("fwd", "#10-bf16"), ("drop", "#11-bf16"),
                                     ("bwd", "#12-bf16"))))
    out["geometries"] = mgeos
    torch.cuda.empty_cache()

    # bf16 supervised steps: the cuBLAS-MLP route and -pallas_mlp, from one init
    out["steps"] = {}
    for pallas in (False, True):
        sargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                    "-learn_framework", "no", "-batch_size", str(SUP_BATCH),
                                    "-compute_dtype", "bfloat16"]
                                   + (["-pallas_mlp"] if pallas else []))
        run_tag = f"{tag}-steps-{'pallas-mlp' if pallas else 'default'}"
        per_step = step_mlp if pallas else {bf_drop.__name__: n_blocks, bf_bwd.__name__: n_blocks}
        out["steps"][run_tag] = run_supervised_steps(torch, np, sargs, SUP_BATCH, TRAIN_WARMUP,
                                                     MLP_BF16_STEPS, kernels, per_step, dev,
                                                     run_tag)
        torch.cuda.empty_cache()
    d, p = out["steps"][f"{tag}-steps-default"], out["steps"][f"{tag}-steps-pallas-mlp"]
    log(f"[{tag}] bf16 -pallas_mlp beside the bf16 cuBLAS-MLP route: p50 {p['p50_ms']:.3f} vs "
        f"{d['p50_ms']:.3f} ms ({p['p50_ms'] / d['p50_ms']:.3f}x), device busy "
        f"{p['device_busy_ms']:.3f} vs {d['device_busy_ms']:.3f} ms, idle share "
        f"{p['idle_share']:.3f} vs {d['idle_share']:.3f}, device operations {p['device_ops']} vs "
        f"{d['device_ops']}, peak {p['peak_mb']:.1f} vs {d['peak_mb']:.1f} MiB")

    # the rate-0 -pallas_mlp bf16 step from one state: kernels vs the bf16 plain versions
    initial = init_params(build_backbone(cfg, "SW_Transformer", task, "no", pallas_mlp=True),
                          seed=0).state_dict()
    kern = supervised_rate0_step(torch, sargs, initial, dev, plain=False, kernels=kernels)
    plain = supervised_rate0_step(torch, sargs, initial, dev, plain=True, kernels=kernels)
    check_counts(f"{tag}: the rate-0 bf16 -pallas_mlp step", kern[2],
                 {k.__name__: {bf_fwd.__name__: n_blocks, bf_bwd.__name__: n_blocks,
                               m_fwd.__name__: n_mlp, m_bwd.__name__: n_mlp}.get(k.__name__, 0)
                  for k in kernels})
    check_counts(f"{tag}: the rate-0 bf16 plain step", plain[2], {k.__name__: 0 for k in kernels})
    vs_plain = abs(kern[0] - plain[0]) / abs(plain[0])
    out["rate0"] = {"loss_bf16_kernels": kern[0], "loss_bf16_plain": plain[0],
                    "loss_rel_vs_bf16_plain": vs_plain, "launches": kern[2],
                    "grad_dtypes": sorted({str(g.dtype) for g in kern[1].values()})}
    log(f"[{tag}] rate-0 MOD bf16 -pallas_mlp supervised step at {SUP_BATCH} from the initial "
        f"state: loss {kern[0]:.6f}, bf16 plain {plain[0]:.6f} (rel {vs_plain:.2e}); launches "
        f"{kern[2]}")
    if not vs_plain <= BF16_LOSS_TOL or out["rate0"]["grad_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"{tag}: rate-0 bf16 -pallas_mlp step: {out['rate0']}")
    names = sorted(plain[1])
    out["rate0"]["grad_gates"] = bf16_grad_gates(tag, names, [kern[1][n] for n in names],
                                                 [plain[1][n] for n in names])
    del kern, plain, initial
    torch.cuda.empty_cache()

    # the supervised entry point with -pallas_mlp in bf16 for an epoch, the test CLI on its _best
    run_dir = os.path.join(HERE, "build", "chip_smoke_mlp_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    sup = ["-dataset", "MOD", "-model", "SW_Transformer", "-synthetic", "-synthetic_samples",
           "512", "-val_epochs", "1", "-output_dir", run_dir, "-compute_dtype", "bfloat16",
           "-pallas_mlp", "-learn_framework", "no", "-batch_size", str(SUP_BATCH), "-epochs", "1"]
    steps, evals = stage_plan(sup)
    st, _, points = run_entry_points(torch, kernels, out, tag,
                                     "supervised -pallas_mlp -compute_dtype bfloat16 -epochs 1",
                                     train_cli.main, sup, step_mlp, eval_mlp, steps, evals)
    if not all(math.isfinite(p[k]) for p in points for k in ("train_loss", "val_loss")):
        raise AssertionError(f"{tag}: non-finite supervised loss: {points}")
    del st
    test_batches = len(DeviceDataLoader(load_split("test", parse_train_params(sup)), SUP_BATCH))
    result = run_entry_points(torch, kernels, out, tag,
                              "test -pallas_mlp -compute_dtype bfloat16 (the supervised _best)",
                              test_cli.main, sup, {}, eval_mlp, 0, test_batches)
    if not all(math.isfinite(v) for v in result):
        raise AssertionError(f"{tag}: the test CLI's numbers are not finite: {result}")
    out["test_result"] = list(result)
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # a served bf16 -pallas_mlp batch, kernels vs the bf16 plain route
    data = synthetic_arrays(cfg, task, SERVE_BATCH, seed=6)[0]
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device=dev.type, seed=0, pallas_mlp=True, compute_dtype="bfloat16")
    zero_counts(kernels)
    served = predictor.predict(data)
    got = counts(kernels)
    check_counts(f"{tag}: one served bf16 -pallas_mlp batch", got,
                 {k.__name__: eval_mlp.get(k.__name__, 0) for k in kernels})
    probs = served["probs"]
    if probs.dtype != np.float32 or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: bad probabilities ({probs.dtype})")
    swin_mod.window_block_forward, swin_mod.fused_mlp = (pk.fused_window_block_reference,
                                                         fm.fused_mlp_plain)
    try:
        serve_err = float(np.abs(predictor._forward(data) - probs).max())
    finally:
        swin_mod.window_block_forward, swin_mod.fused_mlp = pk.window_block_forward, fm.fused_mlp
    out["serve"] = {"p50_ms": served["latency"]["p50_s"] * 1e3, "launches": got,
                    "max_abs_err_vs_plain": serve_err}
    log(f"[{tag}] served bf16 -pallas_mlp batch of {SERVE_BATCH}: launches {got}, p50 "
        f"{out['serve']['p50_ms']:.3f} ms; max|dprobs| vs the bf16 plain route {serve_err:.3e}")
    if not serve_err <= BF16_SERVE_TOL:
        raise AssertionError(f"{tag}: served probabilities differ from the plain route's by "
                             f"{serve_err}")
    del predictor
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"[{tag}] phase 32 in {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# -no_pallas_block at -compute_dtype bfloat16 (33): #6-bf16 to #9-bf16

ATTN_BF16_STEPS = 5       # timed bf16 and f32 -no_pallas_block pretrain steps in phase 33
C12_WIDTH = (12, 2)       # (C, heads) of phase 33's bf16 WindowAttention that no kernel takes


def attention_bf16_inputs(torch, np, g, seed, dev):
    """qkv [windows, N, 3C] bf16 with q unscaled, as the qkv Linear hands it
    over, rel_bias at a trained model's scale, the geometry's shift mask (or
    None) and the output gradient [windows, N, C] bf16."""
    rng = np.random.default_rng(seed)
    B, N, C = g["windows"], g["N"], g["C"]
    qkv, gy = (torch.from_numpy(rng.normal(size=(B, N, c)).astype(np.float32)).to(dev).to(
        torch.bfloat16) for c in (3 * C, C))
    rel_bias = torch.from_numpy(
        (0.02 * rng.normal(size=(g["heads"], N, N))).astype(np.float32)).to(dev)
    mask = None if g["mask"] is None else torch.from_numpy(g["mask"]).to(dev)
    return qkv, rel_bias, mask, gy


def attention_bf16_work(g, backward):
    """(FLOPs, bytes, bound ms, what bounds) of one #6-bf16/#7-bf16 or
    #8-bf16/#9-bf16 launch: attention_work's FLOPs, the products (4 N^2 hd
    a pair forward, 10 N^2 hd backward; bf16 operands on the tensor cores)
    at the bf16 peak and the rest (ATTN_ELEM_* a score, f32 on the CUDA
    cores) at the f32 peak; bytes with q, k, v, g, out, dq, dk and dv at 2
    bytes, rel_bias, drel_bias and the mask at 4, each read or written
    once."""
    pairs, N, hd, H = g["windows"] * g["heads"], g["N"], g["hd"], g["heads"]
    mask = g["nW"] * N * N if g["mask"] is not None else 0
    flops = attention_work(g, backward)[0]
    products = pairs * (10 if backward else 4) * N * N * hd
    if backward:
        nbytes = 2 * 7 * pairs * N * hd + 4 * (2 * H * N * N + mask)
    else:
        nbytes = 2 * 4 * pairs * N * hd + 4 * (H * N * N + mask)
    t_ops = products / BF16_FLOPS + (flops - products) / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return flops, nbytes, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bf16_keep_pattern(torch, pk, g, seed, rate, dev):
    """The weights #7-bf16 keeps at g's (windows, heads, N) for ``seed``, as
    uint8 [B_, H, N, N]: with v one-hot per key (v[j] = e_j, hd >= N) and no
    shift mask its output's first N columns are the dropped weights, nonzero
    exactly where one is kept."""
    B, H, N, hd = g["windows"], g["heads"], g["N"], g["hd"]
    gen = torch.Generator().manual_seed(seed)
    q, k = (torch.randn((B, H, N, hd), generator=gen).to(dev).to(torch.bfloat16)
            for _ in range(2))
    v = torch.zeros((B, H, N, hd), dtype=torch.bfloat16, device=dev)
    v[..., torch.arange(N), torch.arange(N)] = 1
    y = pk.fused_window_attention_dropout_bf16(q, k, v, torch.zeros((H, N, N), device=dev), None,
                                               seed, rate, q_scale=hd**-0.5)
    return (y[..., :N] != 0).to(torch.uint8)


def check_attention_bf16(torch, np, pk, geos, dev, rate, seed0):
    """#6-bf16 to #9-bf16 against their bf16 plain versions at each attention
    geometry, q unscaled with q_scale as the route passes it: #6-bf16
    (writing the head view of a [B_, N, C] tensor) and #7-bf16 fed #7's
    mask (window_attention_keep_mask) to BF16_FWD_TOL of max|y|; #7-bf16's
    keep rate within 5 sigma and the weights it drops (bf16_keep_pattern)
    #7's mask bit for bit; #8-bf16 and #9-bf16 every gradient to
    BF16_GRAD_TOL relative (absolutely to TINY_GRAD where both sides are
    below it); the same bits on a second call of each. Returns the worst
    errors."""
    worst = {"fwd": 0.0, "fwd_abs": 0.0, "drop": 0.0, "drop_abs": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for gi, g in enumerate(geos):
        B, H, N, hd = g["windows"], g["heads"], g["N"], g["hd"]
        seed, s = seed0 + gi, hd**-0.5
        qkv, rel_bias, mask, gy = attention_bf16_inputs(torch, np, g, seed, dev)
        q, k, v = pk._head_views(qkv, H)
        gh = pk._heads(gy, H)
        y = torch.empty((B, N, H * hd), dtype=torch.bfloat16, device=dev)
        pk.fused_window_attention_bf16(q, k, v, rel_bias, mask, q_scale=s, out=pk._heads(y, H))
        y2 = pk.fused_window_attention_bf16(q, k, v, rel_bias, mask, q_scale=s)
        yd = pk.fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, seed, rate, q_scale=s)
        yd2 = pk.fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, seed, rate, q_scale=s)
        keep = pk.window_attention_keep_mask(seed, B, H, N, rate, dev)
        same_mask = bool(torch.equal(bf16_keep_pattern(torch, pk, g, seed, rate, dev), keep))
        torch.cuda.synchronize()
        same = torch.equal(pk._heads(y, H), y2) and torch.equal(yd, yd2)
        errs_f = {}
        for tag, got, kp, r in (("fwd", y2, None, 0.0), ("drop", yd, keep, rate)):
            want = pk.fused_window_attention_bf16_reference(q, k, v, rel_bias, mask, kp, r,
                                                            s).float()
            errs_f[tag] = rel_err(got.float(), want)
            worst[f"{tag}_abs"] = max(worst[f"{tag}_abs"], float((got.float() - want).abs().max()))
        kept = float(keep.double().mean())
        sigma = math.sqrt(rate * (1 - rate) / keep.numel())
        errs = {}
        for tag, sd, kp, r in (("mask", seed, keep, rate), ("nomask", None, None, 0.0)):
            got = pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, gh, sd, r,
                                                          q_scale=s)
            again = pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, gh, sd, r,
                                                            q_scale=s)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
            if [t.dtype for t in got] != [torch.bfloat16] * 3 + [torch.float32]:
                raise AssertionError(f"{g['name']}: #8-bf16/#9-bf16 give {[t.dtype for t in got]}")
            want = pk.fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, gh,
                                                                     kp, r, s)
            errs[tag] = bf16_grad_err(got, want)
            worst["bwd_abs"] = max(worst["bwd_abs"], *(float((a.float() - b.float()).abs().max())
                                                       for a, b in zip(got, want)))
            del got, again, want
        g.update(bf16_rel_err_fwd=errs_f["fwd"], bf16_rel_err_dropout=errs_f["drop"],
                 bf16_keep_rate=kept, bf16_mask_equals_f32_kernels=same_mask,
                 bf16_rel_err_bwd=errs["mask"], bf16_rel_err_bwd_nomask=errs["nomask"],
                 bf16_repeatable=same)
        worst["fwd"], worst["drop"] = max(worst["fwd"], errs_f["fwd"]), max(worst["drop"],
                                                                           errs_f["drop"])
        worst["bwd"] = max(worst["bwd"], *errs.values())
        log(f"[attn-bf16-check] {g['name']}: windows {B} heads {H} N {N} hd {hd} nW {g['nW']}: "
            f"#6-bf16 rel err {errs_f['fwd']:.3e}, #7-bf16 {errs_f['drop']:.3e} (#7's mask), keep "
            f"rate {kept:.5f} ({(kept - 1 + rate) / sigma:+.2f} sigma), its dropped weights == "
            f"#7's mask: {same_mask}; #9-bf16 max rel err {errs['mask']:.3e}, #8-bf16 "
            f"{errs['nomask']:.3e}; same bits on a second call: {same}")
        if not max(errs_f.values()) <= BF16_FWD_TOL:
            raise AssertionError(f"{g['name']}: #6-bf16/#7-bf16 differ from plain by {errs_f}")
        if not abs(kept - (1 - rate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {rate} within 5 sigma")
        if not same_mask:
            raise AssertionError(f"{g['name']}: #7-bf16 drops other weights than #7's mask")
        if not max(errs.values()) <= BF16_GRAD_TOL:
            raise AssertionError(f"{g['name']}: #8-bf16/#9-bf16 gradients differ from plain by "
                                 f"{errs}")
        if not same:
            raise AssertionError(f"{g['name']}: #6-bf16 to #9-bf16 give other bits on a second "
                                 "call")
        del qkv, rel_bias, mask, gy, y, y2, yd, yd2, keep
    return worst


def time_attention_bf16(torch, np, pk, g, seed, dev, rate, train):
    """#6-bf16 (a served geometry) or #7-bf16, #8-bf16 (rate 0) and #9-bf16
    (a training geometry) at g, stored in g["bf16"]: events over at least
    PROFILE_TRACE_MS of calls, device time a call from a profile, the plain
    versions, the library yardstick (scaled_dot_product_attention on bf16
    q, k, v with the bias and mask as a bf16 attn_mask, dropout_p for
    #7-bf16; its autograd backward for #8-bf16/#9-bf16) and the bound
    (attention_bf16_work)."""
    B, H, N, hd = g["windows"], g["heads"], g["N"], g["hd"]
    s = hd**-0.5
    qkv, rel_bias, mask, gy = attention_bf16_inputs(torch, np, g, seed, dev)
    q, k, v = pk._head_views(qkv, H)
    gh = pk._heads(gy, H)
    keep = pk.window_attention_keep_mask(7, B, H, N, rate, dev)
    am = library_mask(torch, g, rel_bias, mask).to(torch.bfloat16)
    lq = [t.contiguous() for t in (pk.scale_bf16(q, s), k, v)]  # q scaled as the route's
    if train:
        calls = {
            "drop": (lambda: pk.fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, 7,
                                                                    rate, q_scale=s),
                     lambda: pk.fused_window_attention_bf16_reference(q, k, v, rel_bias, mask,
                                                                      keep, rate, s), rate, False),
            "bwd": (lambda: pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, gh,
                                                                    q_scale=s),
                    lambda: pk.fused_window_attention_backward_bf16_reference(
                        q, k, v, rel_bias, mask, gh, None, 0.0, s), 0.0, True),
            "drop_bwd": (lambda: pk.fused_window_attention_dropout_backward_bf16(
                q, k, v, rel_bias, mask, gh, 7, rate, q_scale=s),
                lambda: pk.fused_window_attention_backward_bf16_reference(
                    q, k, v, rel_bias, mask, gh, keep, rate, s), rate, True)}
    else:
        calls = {"fwd": (lambda: pk.fused_window_attention_bf16(q, k, v, rel_bias, mask, q_scale=s),
                         lambda: pk.fused_window_attention_bf16_reference(q, k, v, rel_bias, mask,
                                                                          q_scale=s), 0.0, False)}
    out = {}
    for d, (kernel, plain, lib_rate, backward) in calls.items():
        if backward:
            leaves = [t.clone().requires_grad_(True) for t in lq]
            amg = am.clone().requires_grad_(True)
            ly = library_attention(torch, *leaves, amg, lib_rate)
            lib_ms = time_ms(torch, lambda: torch.autograd.grad(ly, leaves + [amg], gh,
                                                                retain_graph=True))
            del ly, leaves, amg
        else:
            with torch.no_grad():
                lib_ms = time_ms(torch, lambda: library_attention(torch, *lq, am, lib_rate))
        with torch.no_grad():
            flops, nbytes, bnd, by = attention_bf16_work(g, backward)
            out[d] = {"ms": time_ms_long(torch, kernel), "device_ms": device_ms_per_call(torch, kernel),
                      "plain_ms": time_ms(torch, plain), "library_ms": lib_ms, "bound_ms": bnd,
                      "bound_by": by, "flops": flops, "bytes": nbytes}
        r = out[d]
        log(f"[attn-bf16-time] {g['name']} (windows {B}, hd {hd}) "
            f"{ {'fwd': '#6-bf16', 'drop': '#7-bf16', 'bwd': '#8-bf16', 'drop_bwd': '#9-bf16'}[d]}: "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {bnd:.4f} ({by}), {nbytes / r['device_ms'] / 1e6:.1f} "
            "GB/s by device time")
    g["bf16"] = out
    del qkv, rel_bias, mask, gy, keep, am, lq


def attention_bf16_paths(torch, np, kernels, dev):
    """Phase 33, -no_pallas_block at -compute_dtype bfloat16 at MOD's full
    width: #6-bf16 at the served geometries (batch 128) and #6-bf16 to
    #9-bf16 at the training ones (256 fused to 512) against their bf16 plain
    versions (check_attention_bf16's gates), and timed there; 3 +
    ATTN_BF16_STEPS MOD pretrain steps at 256 on the route, bf16 beside f32
    from one init (#7-bf16/#9-bf16 16 a step, no whole-block kernel); the
    rate-0 bf16 step, kernels (#6-bf16, #8-bf16) against the bf16 plain
    versions (BF16_LOSS_TOL, C11's gradient gates); python -m
    focal_tpu_torch.train for an epoch; a served batch (#6-bf16 16) against
    the bf16 plain route (BF16_SERVE_TOL); a bf16 WindowAttention at C12's
    width (C12_WIDTH: no kernel takes it) forward and backward on the card,
    launching nothing."""
    import importlib

    from focal_tpu_torch.data import synthetic_arrays
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.dropout import StepRngs
    from focal_tpu_torch.params import load_dataset_config, parse_train_params
    from focal_tpu_torch.serve import Predictor

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    tag = "attn-bf16"
    t_phase = time.time()
    cfg = load_dataset_config("MOD")
    task = "vehicle_classification"
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    fwd, drop, bwd, drop_bwd = (pk.fused_window_attention_bf16,
                                pk.fused_window_attention_dropout_bf16,
                                pk.fused_window_attention_backward_bf16,
                                pk.fused_window_attention_dropout_backward_bf16)
    sgeos = attention_geometries(cfg, SERVE_BATCH, "MOD")
    tgeos = attention_geometries(cfg, 2 * TRAIN_BATCH, "MOD")
    n_blocks = sum(g["per_forward"] for g in sgeos)
    step_bf16 = {drop.__name__: n_blocks, drop_bwd.__name__: n_blocks}
    eval_bf16 = {fwd.__name__: n_blocks}
    out = {"paths": {}, "launches_per_step": step_bf16, "launches_per_eval_forward": eval_bf16}

    # the kernels against their bf16 plain versions, then timed
    parts = {}
    t_part = time.time()

    def part_done(name):
        nonlocal t_part
        parts[name] = time.time() - t_part
        t_part = time.time()

    out["errors"] = check_attention_bf16(torch, np, pk, sgeos + tgeos, dev, rate, 9300)
    part_done("checks")
    for gi, g in enumerate(sgeos):
        time_attention_bf16(torch, np, pk, g, 9400 + gi, dev, rate, train=False)
    for gi, g in enumerate(tgeos):
        time_attention_bf16(torch, np, pk, g, 9500 + gi, dev, rate, train=True)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")
    out["serve_forward"] = {k: sum(g["per_forward"] * g["bf16"]["fwd"][k] for g in sgeos)
                            for k in keys}
    out["train_step"] = {d: {k: sum(g["per_forward"] * g["bf16"][d][k] for g in tgeos)
                             for k in keys} for d in ("drop", "bwd", "drop_bwd")}
    s, t = out["serve_forward"], out["train_step"]
    log(f"[{tag}] one served MOD forward at {SERVE_BATCH} ({n_blocks} launches): #6-bf16 "
        f"{s['ms']:.4f} ms (device {s['device_ms']:.4f}), plain {s['plain_ms']:.4f}, library "
        f"{s['library_ms']:.4f}, bound {s['bound_ms']:.4f}; one training step at "
        f"{2 * TRAIN_BATCH}: " + "; ".join(
            f"{n} {t[d]['ms']:.4f} ms (device {t[d]['device_ms']:.4f}, plain "
            f"{t[d]['plain_ms']:.4f}, library {t[d]['library_ms']:.4f}, bound "
            f"{t[d]['bound_ms']:.4f})"
            for d, n in (("drop", "#7-bf16"), ("bwd", "#8-bf16"), ("drop_bwd", "#9-bf16"))))
    out["geometries"] = [{k: v for k, v in g.items() if k != "mask"} for g in sgeos + tgeos]
    torch.cuda.empty_cache()
    part_done("timing")

    # bf16 and f32 -no_pallas_block pretrain steps from one init
    f32_step = {pk.fused_window_attention_dropout.__name__: n_blocks,
                pk.fused_window_attention_dropout_backward.__name__: n_blocks}
    out["steps"] = bf16_step_runs(torch, np, kernels, dev, f"{tag}-steps", steps=ATTN_BF16_STEPS,
                                  per_step={"float32": f32_step, "bfloat16": step_bf16},
                                  pallas_block=False)
    part_done("steps")

    # the rate-0 bf16 step from one state: kernels vs the bf16 plain versions
    initial = init_params(build_backbone(cfg, "SW_Transformer", task, "FOCAL", pallas_block=False),
                          seed=0).state_dict()
    rargs = parse_train_params(["-dataset", "MOD", "-learn_framework", "FOCAL", "-batch_size",
                                str(TRAIN_BATCH), "-compute_dtype", "bfloat16",
                                "-no_pallas_block"])
    kern = rate0_tail_step(torch, rargs, initial, dev, plain=False, kernels=kernels)
    plain = rate0_tail_step(torch, rargs, initial, dev, plain=True, kernels=kernels)
    check_counts(f"{tag}: the rate-0 bf16 step", kern[2],
                 {k.__name__: n_blocks if k in (fwd, bwd) else 0 for k in kernels})
    check_counts(f"{tag}: the rate-0 bf16 plain step", plain[2], {k.__name__: 0 for k in kernels})
    vs_plain = abs(kern[0] - plain[0]) / abs(plain[0])
    out["rate0"] = {"loss_bf16_kernels": kern[0], "loss_bf16_plain": plain[0],
                    "loss_rel_vs_bf16_plain": vs_plain, "launches": kern[2],
                    "grad_dtypes": sorted({str(g.dtype) for g in kern[1]})}
    log(f"[{tag}] rate-0 MOD bf16 -no_pallas_block pretrain step at {TRAIN_BATCH} from the "
        f"initial state: loss {kern[0]:.6f}, bf16 plain {plain[0]:.6f} (rel {vs_plain:.2e}); "
        f"launches {kern[2]}")
    if not vs_plain <= BF16_LOSS_TOL or out["rate0"]["grad_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"{tag}: rate-0 bf16 -no_pallas_block step: {out['rate0']}")
    out["rate0"]["grad_gates"] = bf16_grad_gates(tag, kern[3], kern[1], plain[1])
    del kern, plain, initial
    torch.cuda.empty_cache()
    part_done("rate-0 step")

    # the training entry point for an epoch
    run_dir = os.path.join(HERE, "build", "chip_smoke_attn_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    pre = ["-dataset", "MOD", "-model", "SW_Transformer", "-no_pallas_block", "-compute_dtype",
           "bfloat16", "-synthetic", "-synthetic_samples", str(SUP_SAMPLES), "-val_epochs", "1",
           "-output_dir", run_dir, "-learn_framework", "FOCAL", "-stage", "pretrain",
           "-batch_size", str(TRAIN_BATCH), "-epochs", "1"]
    steps, evals = stage_plan(pre)
    st, _, points = run_entry_points(torch, kernels, out, tag,
                                     "pretrain -no_pallas_block -compute_dtype bfloat16 -epochs 1",
                                     train_cli.main, pre, step_bf16, eval_bf16, steps, evals)
    if not all(math.isfinite(p[k]) for p in points for k in ("train_loss", "val_loss")):
        raise AssertionError(f"{tag}: non-finite pretrain loss: {points}")
    del st
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    part_done("entry point")

    # a served bf16 batch, kernels vs the bf16 plain route
    data = synthetic_arrays(cfg, task, SERVE_BATCH, seed=7)[0]
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device=dev.type, seed=0, pallas_block=False, compute_dtype="bfloat16")
    zero_counts(kernels)
    served = predictor.predict(data)
    got = counts(kernels)
    check_counts(f"{tag}: one served bf16 -no_pallas_block batch", got,
                 {k.__name__: eval_bf16.get(k.__name__, 0) for k in kernels})
    probs = served["probs"]
    if probs.dtype != np.float32 or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: bad probabilities ({probs.dtype})")
    swin_mod.fused_window_attention_bf16 = (
        lambda q, k, v, rb, m, q_scale=1.0, out=None: pk._into(
            out, pk.fused_window_attention_bf16_reference(q, k, v, rb, m, q_scale=q_scale)))
    try:
        serve_err = float(np.abs(predictor._forward(data) - probs).max())
    finally:
        swin_mod.fused_window_attention_bf16 = pk.fused_window_attention_bf16
    out["serve"] = {"p50_ms": served["latency"]["p50_s"] * 1e3, "launches": got,
                    "max_abs_err_vs_plain": serve_err}
    log(f"[{tag}] served bf16 -no_pallas_block batch of {SERVE_BATCH}: launches {got}, p50 "
        f"{out['serve']['p50_ms']:.3f} ms; max|dprobs| vs the bf16 plain route {serve_err:.3e}")
    if not serve_err <= BF16_SERVE_TOL:
        raise AssertionError(f"{tag}: served probabilities differ from the plain route's by "
                             f"{serve_err}")
    del predictor
    torch.cuda.empty_cache()

    # C12: a bf16 WindowAttention at a width no kernel takes runs the XLA route on the card
    C, H = C12_WIDTH
    attn = swin_mod.WindowAttention(C, (3, 3), H, attn_drop=rate,
                                    compute_dtype=torch.bfloat16).to(dev)
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((SERVE_BATCH, 9, C), generator=gen).to(torch.bfloat16)
    zero_counts(kernels)
    with torch.no_grad():
        y = attn.eval()(x.to(dev))
        y_cpu = attn.to("cpu")(x)
    attn.to(dev)
    xt = x.to(dev).requires_grad_(True)
    rngs = StepRngs(torch.Generator().manual_seed(0), torch.Generator(device=dev).manual_seed(0))
    attn.train()(xt, None, rngs).float().square().sum().backward()
    torch.cuda.synchronize()
    got = counts(kernels)
    c12_err = rel_err(y.float().cpu(), y_cpu.float())
    finite = bool(torch.isfinite(xt.grad.float()).all()) and all(
        p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
        for p in attn.parameters())
    out["c12"] = {"C": C, "heads": H, "launches": got, "rel_err_vs_cpu": c12_err,
                  "finite_f32_gradients": finite}
    log(f"[{tag}] C12: bf16 WindowAttention at C {C}, {H} heads (hd {C // H}) on the card: eval "
        f"forward vs the CPU's rel {c12_err:.3e}; a training forward and backward, gradients f32 "
        f"and finite: {finite}; launches {got}")
    check_counts(f"{tag}: the C12 width's bf16 forward and backward", got,
                 {k.__name__: 0 for k in kernels})
    if not (finite and c12_err <= BF16_FWD_TOL):
        raise AssertionError(f"{tag}: the C12 width's bf16 route: {out['c12']}")
    del attn, x, xt
    torch.cuda.empty_cache()
    part_done("serve and C12")
    out["seconds"], out["seconds_by_part"] = time.time() - t_phase, parts
    log(f"[{tag}] phase 33 in {out['seconds']:.1f}s: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in parts.items()))
    return out


def check_block_forward(torch, pk, geos, gen, dev):
    """#1 vs plain at each geometry, phase 2's gate; returns the worst
    absolute error (and keeps each in its geometry)."""
    fwd = pk.fused_window_block
    max_err = 0.0
    for g in geos:
        args = make_inputs(torch, g, gen, dev)
        y = fwd(*args)
        torch.cuda.synchronize()
        err = float((y - pk.fused_window_block_reference(*args)).abs().max())
        g["max_abs_err"] = err
        max_err = max(max_err, err)
        log(f"[check] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']} "
            f"max|kernel-plain| {err:.3e}")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: kernel differs from plain by {err} > {KERNEL_TOL}")
    torch.cuda.synchronize()
    return max_err


def check_block_training(torch, pk, geos, gen, dev, rate):
    """#2 and #3 vs plain at each training geometry, phase 6's gates;
    returns (#2's worst absolute error, #3's worst relative and absolute
    gradient errors)."""
    fwd_drop, bwd = pk.fused_window_block_dropout, pk.fused_window_block_backward
    drop_err = grad_err = grad_abs = 0.0
    for gi, g in enumerate(geos):
        args = make_inputs(torch, g, gen, dev)
        y, keep = fwd_drop(*args, 1000 + gi, rate)
        torch.cuda.synchronize()
        err = float((y - pk.fused_window_block_dropout_reference(*args, keep, rate)).abs().max())
        kept = float(keep.double().mean())
        sigma = math.sqrt(rate * (1 - rate) / keep.numel())
        dy = torch.randn(y.shape, generator=gen).to(dev)
        tr = transposed(args)
        errs = {}
        for tag, kp in (("keep", keep), ("nomask", None)):
            got = bwd(*args, dy, kp, rate, *tr)
            again = bwd(*args, dy, kp, rate, *tr)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{g['name']}: #3 gives other bits on a second call ({tag})")
            want = pk.fused_window_block_backward_reference(*args, dy, kp, rate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            grad_abs = max(grad_abs, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        g.update(max_abs_err_fwd=err, keep_rate=kept, keep_sigma=sigma, max_rel_err_bwd=errs["keep"],
                 max_rel_err_bwd_nomask=errs["nomask"])
        drop_err, grad_err = max(drop_err, err), max(grad_err, *errs.values())
        log(f"[check-train] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: "
            f"#2 max|kernel-plain| {err:.3e}, keep rate {kept:.5f} ({(kept - 1 + rate) / sigma:+.2f} "
            f"sigma); #3 max rel err {errs['keep']:.3e} (mask), {errs['nomask']:.3e} (no mask), "
            "repeatable")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #2 differs from plain by {err}")
        if not abs(kept - (1 - rate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {rate} within 5 sigma")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #3 gradients differ from plain by {errs}")
    return drop_err, grad_err, grad_abs


def check_towers(torch, np, ct, geos, dev, seed0=100, exact=False):
    """#13 and #14 vs plain at each tower geometry, phase 14's gates;
    returns (#13's worst absolute error, #14's worst relative, near-zero
    and absolute gradient errors). With ``exact`` the plain version runs in
    float64: a conv bias before a BatchNorm has a true gradient of 0, and
    the f32 plain version's cancellation noise there grows with the rows
    summed (~2e-2 at S 128's 6.6e5 rows, past NEAR_ZERO)."""
    ct_fwd = ct.fused_conv_tower
    ct_fwd_err = ct_grad_rel = ct_grad_near = ct_grad_abs = 0.0
    for gi, g in enumerate(geos):
        x0, params, masks, dy = tower_inputs(torch, np, g, seed0 + gi, dev)
        runs = []
        for fn in (ct_fwd, ct_fwd, ct.fused_conv_tower_reference):
            args = (x0, params, masks, dy)
            if exact and fn is ct.fused_conv_tower_reference:
                args = (x0.double(), [[p.double() for p in grp] for grp in params],
                        [m.double() for m in masks], dy.double())
            xl, pl_, leaves = tower_leaves(torch, args[0], args[1], g["external"])
            y, mus, vars_ = fn(xl, g["cfgs"], *pl_, args[2], g["external"])
            runs.append((y.detach(), mus, vars_, torch.autograd.grad(y, leaves, args[3])))
            del y
        torch.cuda.synchronize()
        (y, mus, vars_, grads), again, (ry, rmus, rvars, rgrads) = runs
        fwd_rel = max([rel_err(y, ry)] + [rel_err(a, b) for a, b in zip(mus + vars_, rmus + rvars)])
        fwd_abs = max([float((y - ry).abs().max())]
                      + [float((a - b).abs().max()) for a, b in zip(mus + vars_, rmus + rvars)])
        g_rel, g_near, g_abs = grad_errors(grads, rgrads)
        same = (torch.equal(y, again[0]) and all(torch.equal(a, b) for a, b in zip(mus, again[1]))
                and all(torch.equal(a, b) for a, b in zip(grads, again[3])))
        g.update(max_rel_err_fwd=fwd_rel, max_abs_err_fwd=fwd_abs, max_rel_err_bwd=g_rel,
                 max_abs_err_bwd_near_zero=g_near, max_abs_err_bwd=g_abs, repeatable=same)
        ct_fwd_err = max(ct_fwd_err, fwd_abs)
        ct_grad_rel, ct_grad_near, ct_grad_abs = (max(ct_grad_rel, g_rel), max(ct_grad_near, g_near),
                                                  max(ct_grad_abs, g_abs))
        log(f"[check-tower] {g['name']}: R {g['R']} S {g['S']} C {g['C']} layers {len(g['cfgs'])}"
            f"{' (first conv outside)' if g['external'] else ''}: #13 max rel err {fwd_rel:.3e} "
            f"(output, means, variances); #14 max rel err {g_rel:.3e}, near-zero max abs err "
            f"{g_near:.3e}; same bits on a second call: {same}")
        if not fwd_rel <= TOWER_TOL:
            raise AssertionError(f"{g['name']}: #13 differs from plain by {fwd_rel}")
        if not (g_rel <= GRAD_TOL and g_near <= NEAR_ZERO):
            raise AssertionError(f"{g['name']}: #14 gradients differ from plain: {g_rel}, {g_near}")
        if not same:
            raise AssertionError(f"{g['name']}: #13/#14 give other bits on a second call")
        del runs, grads, again, rgrads, x0, params, masks, dy
    return ct_fwd_err, ct_grad_rel, ct_grad_near, ct_grad_abs


def time_tower(torch, np, ct, F, g, seed, dev):
    """Phase 17's timing of #13 and #14 at one tower geometry, into g: the
    kernels, the plain versions, the library yardstick (the unfused cuDNN
    chain and its autograd backward), the bounds and the device time by
    phase (failing on a kernel outside csrc/conv_tower.cu)."""
    ct_bwd = ct.fused_conv_tower_backward
    x0, params, masks, dy = tower_inputs(torch, np, g, seed, dev)
    _, _, _, saved = ct.tower_forward(x0, g["cfgs"], *params, masks, g["external"])
    g["fwd_ms"] = time_ms(torch, lambda: ct.tower_forward(x0, g["cfgs"], *params, masks,
                                                          g["external"]))
    g["bwd_ms"] = time_ms(torch, lambda: ct_bwd(saved, dy))
    with torch.no_grad():
        g["fwd_plain_ms"] = time_ms(torch, lambda: ct.fused_conv_tower_reference(
            x0, g["cfgs"], *params, masks, g["external"]))
        g["fwd_library_ms"] = time_ms(torch, lambda: library_tower(torch, F, x0, g, params, masks))
    xl, pl_, leaves = tower_leaves(torch, x0, params, g["external"])
    ry = ct.fused_conv_tower_reference(xl, g["cfgs"], *pl_, masks, g["external"])[0]
    g["bwd_plain_ms"] = time_ms(torch, lambda: torch.autograd.grad(ry, leaves, dy,
                                                                   retain_graph=True))
    del ry
    xl, pl_, leaves = tower_leaves(torch, x0, params, g["external"])
    ly = library_tower(torch, F, xl, g, pl_, masks)
    dyl = dy.permute(0, 2, 1).unsqueeze(2)
    g["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves, dyl,
                                                                     retain_graph=True))
    del ly
    # device time by kernel: only conv_tower.cu's kernels and PyTorch's
    # [C]-sized steps may run under #13 and #14
    g["profile"] = {"fwd": tower_phase_split(torch, lambda: ct.tower_forward(
                        x0, g["cfgs"], *params, masks, g["external"])),
                    "bwd": tower_phase_split(torch, lambda: ct_bwd(saved, dy))}
    del saved
    f_fl, f_by, b_fl, b_by = tower_work(g)
    g["fwd_gflop"], g["bwd_gflop"] = f_fl / 1e9, b_fl / 1e9
    g["fwd_bound_ms"], g["fwd_bound_by"] = bound(f_fl, f_by)
    g["bwd_bound_ms"], g["bwd_bound_by"] = bound(b_fl, b_by)
    g["fwd_bound_tc_ms"], g["bwd_bound_tc_ms"] = tower_tc_bounds(g)
    g["fwd_flops_bytes"], g["bwd_flops_bytes"] = (f_fl, f_by), (b_fl, b_by)
    log(f"[time-tower] {g['name']}: #13 {g['fwd_ms']:.4f} ms (plain {g['fwd_plain_ms']:.4f}, "
        f"library {g['fwd_library_ms']:.4f}, bound f32 {g['fwd_bound_ms']:.4f}, TF32x3 "
        f"{g['fwd_bound_tc_ms']:.4f}, {f_fl / g['fwd_ms'] / 1e9:.2f} TFLOP/s); #14 "
        f"{g['bwd_ms']:.4f} ms (plain {g['bwd_plain_ms']:.4f}, library "
        f"{g['bwd_library_ms']:.4f}, bound f32 {g['bwd_bound_ms']:.4f}, TF32x3 "
        f"{g['bwd_bound_tc_ms']:.4f}, {b_fl / g['bwd_ms'] / 1e9:.2f} TFLOP/s)")
    for d, what in (("fwd", "#13"), ("bwd", "#14")):
        pr = g["profile"][d]
        log(f"[profile-tower] {g['name']} {what}: device {pr['device_ms']:.4f} ms a call: "
            + ", ".join(f"{ph} {ms:.4f}" for ph, ms in sorted(pr["phases"].items(),
                                                               key=lambda kv: -kv[1])))
    del x0, params, masks, dy, xl, pl_, leaves
    return f_fl, f_by, b_fl, b_by


def check_mlps(torch, np, fm, geos, dev, mlp_rate, seed0=300):
    """#10, #11 and #12 vs plain at each MLP geometry, phase 18's gates;
    returns the worst errors {"fwd", "drop", "bwd" (relative), "bwd_abs"}."""
    mlp_fwd, mlp_drop, mlp_bwd = fm.fused_mlp_forward, fm.fused_mlp_dropout_forward, fm.fused_mlp_backward
    mlp_err = {"fwd": 0.0, "drop": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for gi, g in enumerate(geos):
        T, C, H = g["T"], g["C"], g["H"]
        x, w1, b1, w2, b2, gy = mlp_inputs(torch, np, g, seed0 + gi, dev)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        seed = seed0 + 3700 + gi
        y, y_again = mlp_fwd(x, w1, b1, w2, b2), mlp_fwd(x, w1, b1, w2, b2)
        yd = mlp_drop(x, w1, b1, w2, b2, seed, mlp_rate)
        yd_again = mlp_drop(x, w1, b1, w2, b2, seed, mlp_rate)
        keep1, keep2 = fm.mlp_keep_masks(seed, T, C, H, mlp_rate, dev)
        torch.cuda.synchronize()
        err = float((y - fm.fused_mlp_reference(x, w1, b1, w2, b2)).abs().max())
        derr = float((yd - fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2,
                                                          mlp_rate)).abs().max())
        rates = {}
        for name, k in (("keep1", keep1), ("keep2", keep2)):
            kept = float(k.double().mean())
            rates[name] = (kept, (kept - 1 + mlp_rate) / math.sqrt(mlp_rate * (1 - mlp_rate) / k.numel()))
        same = torch.equal(y, y_again) and torch.equal(yd, yd_again)
        errs = {}
        for tag, sd, keeps in (("mask", seed, (keep1, keep2)), ("nomask", None, (None, None))):
            got = mlp_bwd(x, w1, b1, w1t, w2t, gy, sd, mlp_rate)
            again = mlp_bwd(x, w1, b1, w1t, w2t, gy, sd, mlp_rate)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
            want = fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, gy, *keeps, mlp_rate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            mlp_err["bwd_abs"] = max(mlp_err["bwd_abs"], *(float((a - b).abs().max())
                                                            for a, b in zip(got, want)))
            del got, again, want
        g.update(max_abs_err_fwd=err, max_abs_err_dropout=derr, keep_rates=rates,
                 max_rel_err_bwd=errs["mask"], max_rel_err_bwd_nomask=errs["nomask"],
                 repeatable=same)
        mlp_err["fwd"], mlp_err["drop"] = max(mlp_err["fwd"], err), max(mlp_err["drop"], derr)
        mlp_err["bwd"] = max(mlp_err["bwd"], *errs.values())
        log(f"[check-mlp] {g['name']}: T {T} C {C} H {H} ({g['per_forward']} a forward): #10 "
            f"max|kernel-plain| {err:.3e}, #11 {derr:.3e} (its own masks), keep rates "
            + ", ".join(f"{k} {v[0]:.5f} ({v[1]:+.2f} sigma)" for k, v in rates.items())
            + f"; #12 max rel err {errs['mask']:.3e} (masks), {errs['nomask']:.3e} (none); "
            f"same bits on a second call: {same}")
        if not max(err, derr) <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #10/#11 differ from plain by {err}, {derr}")
        if not all(abs(v[1]) <= 5 for v in rates.values()):
            raise AssertionError(f"{g['name']}: keep rates {rates} not 1 - {mlp_rate} within 5 sigma")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #12 gradients differ from plain by {errs}")
        if not same:
            raise AssertionError(f"{g['name']}: #10/#11/#12 give other bits on a second call")
        del x, w1, b1, w2, b2, gy, w1t, w2t, y, y_again, yd, yd_again, keep1, keep2
    return mlp_err


def check_attention(torch, np, pk, geos, gen, dev, a_rate, seed0, at_err):
    """#6-#9 vs plain at each attention geometry, phase 22's gates, #7's
    mask against #2's (#4's where #2 does not launch); the worst errors go
    into at_err {"fwd", "drop", "bwd" (relative), "bwd_abs"}."""
    at_fwd, at_drop = pk.fused_window_attention, pk.fused_window_attention_dropout
    fwd_drop, ph_fwd = pk.fused_window_block_dropout, pk.fused_window_block_perhead
    for gi, g in enumerate(geos):
        B, H, N, C = g["windows"], g["heads"], g["N"], g["C"]
        seed = seed0 + gi
        q, k, v, rel_bias, mask, gy = attention_inputs(torch, np, g, seed, dev)
        y = at_fwd(q, k, v, rel_bias, mask)
        yd = at_drop(q, k, v, rel_bias, mask, seed, a_rate)
        keep = pk.window_attention_keep_mask(seed, B, H, N, a_rate, dev)
        blk = fwd_drop if pk.wblock_fits(N, C, H) else ph_fwd
        blk_keep = blk(*make_inputs(torch, g, gen, dev), seed, a_rate)[1]
        torch.cuda.synchronize()
        same_mask = bool(torch.equal(blk_keep, keep))
        del blk_keep
        err = float((y - pk.fused_window_attention_reference(q, k, v, rel_bias, mask)).abs().max())
        derr = float((yd - pk.fused_window_attention_dropout_reference(
            q, k, v, rel_bias, mask, keep, a_rate)).abs().max())
        kept = float(keep.double().mean())
        sigma = math.sqrt(a_rate * (1 - a_rate) / keep.numel())
        errs, same = {}, True
        for tag, sd, kp in (("mask", seed, keep), ("nomask", None, None)):
            r = a_rate if sd is not None else 0.0
            got = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, gy, sd, r)
            again = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, gy, sd, r)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
            want = pk.fused_window_attention_backward_reference(q, k, v, rel_bias, mask, gy, kp, r)
            errs[tag] = grads_differ(got, want)
            at_err["bwd_abs"] = max(at_err["bwd_abs"], *(float((a - b).abs().max())
                                                          for a, b in zip(got, want)))
            del got, again, want
        forms = route_forms_equal(torch, pk, q, k, v, rel_bias, mask, gy, seed, a_rate)
        g.update(max_abs_err_fwd=err, max_abs_err_dropout=derr, keep_rate=kept,
                 keep_sigma=sigma, mask_equals_whole_block=same_mask,
                 max_rel_err_bwd=errs["mask"], max_rel_err_bwd_nomask=errs["nomask"],
                 repeatable=same, route_forms_bitwise=forms)
        at_err["fwd"], at_err["drop"] = max(at_err["fwd"], err), max(at_err["drop"], derr)
        at_err["bwd"] = max(at_err["bwd"], *errs.values())
        log(f"[check-attn] {g['name']}: windows {B} heads {H} N {N} hd {g['hd']} nW {g['nW']}: "
            f"#6 max|kernel-plain| {err:.3e}, #7 {derr:.3e} (its own mask), keep rate {kept:.5f} "
            f"({(kept - 1 + a_rate) / sigma:+.2f} sigma), mask == {blk.__name__}'s: {same_mask}; "
            f"#9 max rel err {errs['mask']:.3e}, #8 {errs['nomask']:.3e}; same bits on a second "
            f"call: {same}; q_scale / out forms bitwise the pre-scaled, contiguous calls "
            f"(#6, #7, #8, #9): {forms}")
        if not max(err, derr) <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #6/#7 differ from plain by {err}, {derr}")
        if not abs(kept - (1 - a_rate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {a_rate} within 5 sigma")
        if not same_mask:
            raise AssertionError(f"{g['name']}: #7's keep mask differs from {blk.__name__}'s")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #8/#9 gradients differ from plain by {errs}")
        if not same:
            raise AssertionError(f"{g['name']}: #8/#9 give other bits on a second call")
        if not all(forms):
            raise AssertionError(f"{g['name']}: the q_scale / out forms of #6-#9 differ from "
                                 f"the pre-scaled, contiguous calls: {forms}")
        del q, k, v, rel_bias, mask, gy, y, yd, keep


# ---------------------------------------------------------------------------
# phases 34-35: multi-process training, #4-TP/#5-TP and the data-parallel forms

TP_WAYS = (2, 4)          # model ranks of phase 34's gates (H 4: 2 and 1 heads a shard)
TP_GATE_WINDOWS = 131     # windows of each gate (not a multiple of nW or of a block's pairs)
MP_WARMUP, MP_STEPS = 1, 1  # warm-up and timed pretrain steps a layout of phase 35
MP_LR = 0.05              # the rate-0 update's SGD step
MP_LOSS_RTOL = 1e-4
MP_PARAM_RTOL, MP_PARAM_ATOL = 3e-3, 1e-5
MP_ROUNDING_LAMBDA = 6.0
# an update is held entry by entry against the single-process one:
#   |a - b| <= MP_PARAM_RTOL |b| + MP_PARAM_ATOL + lr 2 lambda sqrt(n) u A,
# A the sum of the |terms| of the entry's gradient over its n rows, u = 2^-24:
# an f32 sum of n terms lies within lambda sqrt(n) u A of its exact value
# (Higham and Mary's probabilistic bound, SIAM J. Sci. Comput. 41(5), 2019,
# failing with probability below 2 n exp(-lambda^2 / 2)), and the two updates
# sum in two orders. A bias summed over ~1.5e5 rows at MOD can be small beside
# its terms, so allclose alone fails on order noise there. A and n come from
# hooks on the Linears and LayerNorms of a single-process step
# (rounding_allowance); a parameter no hook sees is held to allclose alone.
MP_PLANT = ("stage0_shake_seismic.block1.attn.qkv.bias", 1.5)
# the planted fault the gate must reject: model shard 1's slice (of 2) of this
# bias (part|head|dim) with its update scaled by 1.5
MP_SAMPLES = 256          # synthetic train split of phase 35's entry-point runs
MP_DEVICE = "cuda"
# layout: (the layout's flags, the model's flags, which a single process
# runs too); the last five are the layouts PR 23 opened (bf16 SW_Transformer
# and DeepSense under TP, -pallas_conv under DP), given MP_NEW_STEPS timed
# steps
MP_LAYOUTS = {"dp2": (["-data_parallel", "2"], []), "mp2": (["-model_parallel", "2"], []),
              "mp2_bf16": (["-model_parallel", "2"], ["-compute_dtype", "bfloat16"]),
              "ds_mp2": (["-model_parallel", "2"], ["-model", "DeepSense"]),
              "ds_mp2_bf16": (["-model_parallel", "2"], ["-model", "DeepSense", "-compute_dtype",
                                                         "bfloat16"]),
              "ds_pallas_conv_dp2": (["-data_parallel", "2"], ["-model", "DeepSense",
                                                               "-pallas_conv"]),
              "ds_pallas_conv_dp2_bf16": (["-data_parallel", "2"],
                                          ["-model", "DeepSense", "-pallas_conv", "-compute_dtype",
                                           "bfloat16"]),
              "dp2_sharded": (["-data_parallel", "2", "-data_layout", "sharded"], [])}
# the layouts that run their entry point alone (the sharded step's equality
# with one process on the same global batch is a CPU test's)
MP_ENTRY_ONLY = ("dp2_sharded",)
MP_NEW_STEPS = 1
# the entry points a layout runs after its pretraining, in its output folder:
# (name, module, flags); the kernels each must launch (the bf16 TP layout's
# finetune trains the class head alone: no backward through the blocks)
MP_LAYOUT_STAGES = {"mp2_bf16": (
    ("finetune", "train.__main__", ["-stage", "finetune"], ("fused_window_block_tp_bf16",)),
    ("supervised", "train.__main__", ["-learn_framework", "no"],
     ("fused_window_block_tp_bf16", "fused_window_block_tp_backward_bf16")),
    ("test", "test", ["-learn_framework", "no"], ("fused_window_block_tp_bf16",)))}
# the rate-0 updates each layout holds to the single-process one
MP_RATE0 = {"dp2": {"default": [], "no_pallas_block_pallas_mlp": ["-no_pallas_block",
                                                                   "-pallas_mlp"]},
            **{layout: {"default": []} for layout in MP_LAYOUTS
               if layout != "dp2" and layout not in MP_ENTRY_ONLY}}
# the kernels a new layout's steps run (each step as its rate-0 update), and
# none other of MP_KERNELS; the DeepSense TP layouts run none (cuDNN convs)
MP_LAYOUT_KERNELS = {"mp2_bf16": ("fused_window_block_tp_bf16",
                                  "fused_window_block_tp_backward_bf16"),
                     "ds_mp2": (), "ds_mp2_bf16": (),
                     "ds_pallas_conv_dp2": ("fused_conv_tower", "fused_conv_tower_backward"),
                     "ds_pallas_conv_dp2_bf16": ("fused_conv_tower_bf16",
                                                 "fused_conv_tower_backward_bf16")}
MP_KERNELS = ("fused_window_block_tp", "fused_window_block_tp_backward", "fused_window_block",
              "fused_window_block_dropout", "fused_window_attention", "fused_window_block_backward",
              "fused_window_attention_dropout", "fused_window_attention_dropout_backward",
              "fused_window_attention_backward", "fused_mlp_forward",
              "fused_mlp_dropout_forward", "fused_mlp_backward", "fused_window_block_tp_bf16",
              "fused_window_block_tp_backward_bf16", "fused_conv_tower",
              "fused_conv_tower_backward", "fused_conv_tower_bf16",
              "fused_conv_tower_backward_bf16")


def mp_kernels():
    """The wrappers phase 35's ranks count (MP_KERNELS, by name)."""
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk

    return tuple(getattr(pk, n, None) or getattr(fm, n, None) or getattr(ct, n)
                 for n in MP_KERNELS)


def mp_steps(layout):
    """The timed steps of a phase 35 layout."""
    return MP_STEPS if layout in ("dp2", "mp2") else MP_NEW_STEPS


def mp_bf16(layout):
    return "bfloat16" in MP_LAYOUTS[layout][1]


def tp_shard(torch, args, mp, m):
    """Model rank m's kernel arguments from whole ones (x, wqkv [C, 3C],
    bqkv, wproj [C, C], bproj, rel_bias, mask): its heads' columns of wqkv
    and bqkv (part|head|dim), rows of wproj, heads of rel_bias; bproj on
    rank 0 alone."""
    from focal_tpu_torch.parallel.tp import Spec, local_slice

    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    H = rel_bias.shape[0]
    return (x, local_slice(wqkv, Spec(1, 3, H), mp, m), local_slice(bqkv, Spec(0, 3, H), mp, m),
            local_slice(wproj, Spec(0, 1, H), mp, m), bproj if m == 0 else torch.zeros_like(bproj),
            local_slice(rel_bias, Spec(0, 1, H), mp, m), mask)


def tp_work(g, mp, backward, with_keep):
    """#4-TP (#5-TP) on one of mp shards: #4's (#5's) formulas with D = C /
    mp for the inner width, B_ (8 N C D + 4 N^2 D) FLOPs forward and B_ (22 N
    C D + 12 N^2 D) backward; bytes: x and y (and dy, dx) once, the shard's
    weights, bias table and the shift mask once (their gradients written
    once), the keep mask. Returns (flops, bytes, bound ms at 3 TF32 products
    an f32 one, what bounds it, the f32 bound ms)."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    D, Hl = C // mp, H // mp
    mask = g["nW"] * N * N if g["mask"] is not None else 0
    weights = 4 * C * D + 3 * D + C + Hl * N * N
    keep = B * Hl * N * N if with_keep else 0
    if backward:
        flops = B * (22 * N * C * D + 12 * N * N * D)
        nbytes = 4 * (3 * B * N * C + 2 * weights + mask) + keep
    else:
        flops = B * (8 * N * C * D + 4 * N * N * D)
        nbytes = 4 * (2 * B * N * C + weights + mask) + keep
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (flops, nbytes, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            bound(flops, nbytes)[0])


def tp_kernel_paths(torch, np, pk, gen, dev):
    """Phase 34: #4-TP/#5-TP (fused_window_block_tp, _backward) against their
    plain versions at every local geometry of MOD's and MOD_WIDE's stages at
    mp 2 and 4 (TP_GATE_WINDOWS windows), at rate 0 and the recipe's rate:
    forward and every gradient within KERNEL_TOL / GRAD_TOL, the backward
    bitwise on a second call; at rate 0 the shards' y (bproj once) and dx
    summed equal #4's and #5's at full heads, each shard's weight gradients
    their slices. Then both held to their plain versions again and timed at
    MOD's training geometries on one of two shards (phase 35's mp 2 layout:
    batch TRAIN_BATCH, views fused): events and device time a step, the
    plain versions, cuBLAS + SDPA at the local geometry, and the bound."""
    from focal_tpu_torch.params import load_dataset_config

    t0 = time.time()
    fwd, bwd = pk.fused_window_block_tp, pk.fused_window_block_tp_backward
    cfg = load_dataset_config("MOD")
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    seen, gates = set(), []
    errs = {"fwd": 0.0, "bwd": 0.0, "bwd_abs": 0.0, "sum_y": 0.0, "sum_dx": 0.0, "slices": 0.0}
    for ds in ("MOD", "MOD_WIDE"):
        for geo in block_geometries(load_dataset_config(ds), 1):
            key = (geo["N"], geo["C"], geo["heads"], geo["mask"] is not None)
            if key in seen:
                continue
            seen.add(key)
            g = dict(geo, windows=TP_GATE_WINDOWS)
            whole = make_inputs(torch, g, gen, dev)
            dy = torch.randn(whole[0].shape, generator=gen).to(dev)
            full_y = pk.fused_window_block_perhead(*whole)[0]
            full_g = pk.fused_window_block_perhead_backward(*whole, dy)
            for mp in TP_WAYS:
                for r in (0.0, rate):
                    args = tp_shard(torch, whole, mp, mp - 1)
                    y, keep = fwd(*args, 11, r)
                    got = bwd(*args, dy, keep, r)
                    again = bwd(*args, dy, keep, r)
                    torch.cuda.synchronize()
                    errs["fwd"] = max(errs["fwd"], float(
                        (y - pk.fused_window_block_reference(*args, keep, r)).abs().max()))
                    want = pk.fused_window_block_backward_reference(*args, dy, keep, r)
                    errs["bwd"] = max([errs["bwd"]] + [rel_err(a, w) for a, w in zip(got, want)])
                    errs["bwd_abs"] = max([errs["bwd_abs"]] + [float((a - w).abs().max())
                                                               for a, w in zip(got, want)])
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"[tp-kernels] #5-TP repeats with other bits at {key}")
                y_sum, dx_sum = torch.zeros_like(full_y), torch.zeros_like(full_y)
                for m in range(mp):
                    args = tp_shard(torch, whole, mp, m)
                    y_sum += fwd(*args)[0]
                    dx, *dws = bwd(*args, dy)
                    dx_sum += dx
                    sliced = tp_shard(torch, (None, *full_g[1:], None), mp, m)
                    for a, w in zip(dws, (sliced[1], sliced[2], sliced[3], full_g[4], sliced[5])):
                        errs["slices"] = max(errs["slices"], rel_err(a, w))
                errs["sum_y"] = max(errs["sum_y"], rel_err(y_sum, full_y))
                errs["sum_dx"] = max(errs["sum_dx"], rel_err(dx_sum, full_g[0]))
                gates.append({"N": key[0], "C": key[1], "heads": key[2], "shifted": key[3],
                              "mp": mp})
    if errs["fwd"] > KERNEL_TOL or max(errs["bwd"], errs["sum_y"], errs["sum_dx"],
                                       errs["slices"]) > GRAD_TOL:
        raise AssertionError(f"[tp-kernels] past the gates: {errs}")
    log(f"[tp-kernels] #4-TP/#5-TP at {len(gates)} local geometries (rate 0 and {rate}) vs plain: "
        f"{errs}")

    # timed: one shard of two at MOD's training geometries
    mp, sms = 2, torch.cuda.get_device_properties(dev).multi_processor_count
    geos = block_geometries(cfg, 2 * TRAIN_BATCH)
    for g in geos:
        whole = make_inputs(torch, g, gen, dev)
        args = tp_shard(torch, whole, mp, 0)
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
        dy = torch.randn(x.shape, generator=gen).to(dev)
        y, keep = fwd(*args, 7, rate)
        tr = transposed(args)
        got, want = bwd(*args, dy, keep, rate, *tr), pk.fused_window_block_backward_reference(
            *args, dy, keep, rate)
        g["fwd_err"] = float((y - pk.fused_window_block_reference(*args, keep, rate)).abs().max())
        g["bwd_err"] = max(rel_err(a, w) for a, w in zip(got, want))
        if g["fwd_err"] > KERNEL_TOL or g["bwd_err"] > GRAD_TOL:
            raise AssertionError(f"[tp-kernels] {g['name']}: off the plain versions at the main "
                                 f"path's geometry: {g['fwd_err']}, {g['bwd_err']}")
        errs["fwd"], errs["bwd"] = max(errs["fwd"], g["fwd_err"]), max(errs["bwd"], g["bwd_err"])
        lib_args = (x, wqkv, bqkv, wproj, bproj)
        am = library_mask(torch, g, rel_bias, mask)
        g["fwd_ms"] = time_ms(torch, lambda: fwd(*args, 7, rate))
        g["fwd_device_ms"] = device_ms_per_call(torch, lambda: fwd(*args, 7, rate))
        g["fwd_plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_reference(*args, keep, rate))
        g["fwd_library_ms"] = time_ms(torch, lambda: library_block(torch, *lib_args, am,
                                                                   g["heads"] // mp, rate))
        g["bwd_ms"] = time_ms(torch, lambda: bwd(*args, dy, keep, rate, *tr))
        g["bwd_device_ms"] = device_ms_per_call(torch, lambda: bwd(*args, dy, keep, rate, *tr))
        g["bwd_plain_ms"] = time_ms(
            torch, lambda: pk.fused_window_block_backward_reference(*args, dy, keep, rate))
        leaves = [t.clone().requires_grad_(True) for t in lib_args]
        amg = am.clone().requires_grad_(True)
        out = library_block(torch, *leaves, amg, g["heads"] // mp, rate)
        g["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            out, leaves + [amg], dy, retain_graph=True))
        del out
        for d in ("fwd", "bwd"):
            f, b, bnd, by, f32 = tp_work(g, mp, d == "bwd", True)
            g.update({f"{d}_flops": f, f"{d}_bytes": b, f"{d}_bound_ms": bnd, f"{d}_bound_by": by,
                      f"{d}_bound_f32_ms": f32})
    keys = [f"{d}_{k}" for d in ("fwd", "bwd") for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_f32_ms", "flops", "bytes")]
    tot = {k: sum(g["per_forward"] * g[k] for g in geos) for k in keys}
    for d in ("fwd", "bwd"):
        tot[f"{d}_bound_by"] = ("operations" if 3 * tot[f"{d}_flops"] / TF32_FLOPS
                                >= tot[f"{d}_bytes"] / HBM_BYTES_PER_S else "bytes")
    per_fwd = sum(g["per_forward"] for g in geos)
    log(f"[tp-kernels] one MOD step on one of {mp} shards ({per_fwd} launches each, rate {rate}): "
        + "; ".join(f"{n} {tot[f'{d}_ms']:.3f} ms (device {tot[f'{d}_device_ms']:.3f}, plain "
                    f"{tot[f'{d}_plain_ms']:.3f}, library {tot[f'{d}_library_ms']:.3f}, bound "
                    f"3xTF32 {tot[f'{d}_bound_ms']:.3f}, f32 {tot[f'{d}_bound_f32_ms']:.3f})"
                    for d, n in (("fwd", "#4-TP"), ("bwd", "#5-TP"))))
    return {"seconds": time.time() - t0, "gates": gates, "errors": errs, "step": tot,
            "per_forward": per_fwd, "rate": rate,
            "geometries": [{k: v for k, v in g.items() if k != "mask"} for g in geos]}


def dp_form_times(torch, np, pk, fm, gen, dev):
    """The data-parallel forms at one data shard's geometry of phase 35's dp
    2 layout (MOD, TRAIN_BATCH / 2 samples a rank, views fused) and the
    recipe's rates, summed over one step: DP-1-5 (#2 forward + #3 backward),
    DP-6-9 (#7 + #9, -no_pallas_block), DP-10-12 (#11 + #12, -pallas_mlp).
    Each: kernel ms by events and device time, the plain versions, the
    library chain's forward and autograd backward, the f32 bound, the
    kernel's worst error against its plain version."""
    import torch.nn.functional as F
    from focal_tpu_torch.params import load_dataset_config

    cfg = load_dataset_config("MOD")
    sw = cfg["SW_Transformer"]
    rate, mlp_rate = float(sw["attn_drop_rate"]), float(sw["dropout_ratio"])
    shard = TRAIN_BATCH  # samples a rank: half the batch, its two views fused
    out = {}

    def add(name, per, parts):
        tot = out.setdefault(name, {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": 0.0, "flops": 0, "bytes": 0, "err": 0.0})
        for k in ("ms", "device_ms", "plain_ms", "library_ms", "flops", "bytes"):
            tot[k] += per * parts[k]
        tot["err"] = max(tot["err"], parts["err"])

    def timed(kernel_fns, plain_fns, library_fn, flops_bytes, err):
        run = lambda: [f() for f in kernel_fns]  # noqa: E731
        return {"ms": time_ms(torch, run), "device_ms": device_ms_per_call(torch, run),
                "plain_ms": time_ms(torch, lambda: [f() for f in plain_fns]),
                "library_ms": library_fn(), "flops": flops_bytes[0], "bytes": flops_bytes[1],
                "err": err}

    for g in block_geometries(cfg, shard):
        args = make_inputs(torch, g, gen, dev)
        x = args[0]
        dy = torch.randn(x.shape, generator=gen).to(dev)
        tr = transposed(args)
        y, keep = pk.fused_window_block_dropout(*args, 7, rate)
        err = float((y - pk.fused_window_block_reference(*args, keep, rate)).abs().max())
        f_w, b_w = work_dropout(g)[:2], work_backward(g, True)[:2]
        am = library_mask(torch, g, args[5], args[6])

        def lib_ms():
            fwd_ms = time_ms(torch, lambda: library_block(torch, *args[:5], am, g["heads"], rate))
            return fwd_ms + library_backward_ms(torch, g, args, dy, rate)

        add("DP-1-5", g["per_forward"], timed(
            [lambda: pk.fused_window_block_dropout(*args, 7, rate),
             lambda: pk.fused_window_block_backward(*args, dy, keep, rate, *tr)],
            [lambda: pk.fused_window_block_reference(*args, keep, rate),
             lambda: pk.fused_window_block_backward_reference(*args, dy, keep, rate)],
            lib_ms, (f_w[0] + b_w[0], f_w[1] + b_w[1]), err))
    for g in attention_geometries(cfg, shard, "MOD"):
        q, k, v, rel_bias, mask, gy = attention_inputs(torch, np, g, 5, dev)
        keep = pk.window_attention_keep_mask(7, g["windows"], g["heads"], g["N"], rate, dev)
        y = pk.fused_window_attention_dropout(q, k, v, rel_bias, mask, 7, rate)
        err = float((y - pk.fused_window_attention_reference(q, k, v, rel_bias, mask, keep,
                                                             rate)).abs().max())
        am = library_mask(torch, g, rel_bias, mask)
        f_a, b_a = attention_work(g, False), attention_work(g, True)

        def lib_ms():
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = library_attention(torch, *leaves, am, rate)
            fwd_ms = time_ms(torch, lambda: library_attention(torch, q, k, v, am, rate))
            return fwd_ms + time_ms(torch, lambda: torch.autograd.grad(o, leaves, gy,
                                                                        retain_graph=True))

        add("DP-6-9", g["per_forward"], timed(
            [lambda: pk.fused_window_attention_dropout(q, k, v, rel_bias, mask, 7, rate),
             lambda: pk.fused_window_attention_dropout_backward(q, k, v, rel_bias, mask, gy, 7,
                                                                rate)],
            [lambda: pk.fused_window_attention_reference(q, k, v, rel_bias, mask, keep, rate),
             lambda: pk.fused_window_attention_backward_reference(q, k, v, rel_bias, mask, gy,
                                                                  keep, rate)],
            lib_ms, (f_a[0] + b_a[0], f_a[1] + b_a[1]), err))
    for g in mlp_geometries(cfg, shard, "MOD"):
        x, w1, b1, w2, b2, gm = mlp_inputs(torch, np, g, 9, dev)
        w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
        k1, k2 = fm.draw_mlp_masks(7, g["T"], g["C"], g["H"], mlp_rate, dev)
        y = fm.fused_mlp_dropout_forward(x, w1, b1, w2, b2, 7, mlp_rate)
        ref = fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, *fm.mlp_keep_masks(
            7, g["T"], g["C"], g["H"], mlp_rate, dev), mlp_rate)
        err = float((y - ref).abs().max())
        f_m, b_m = mlp_work(g, False), mlp_work(g, True)

        def lib_ms():
            leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
            o = library_mlp(torch, F, *leaves, mlp_rate)
            fwd_ms = time_ms(torch, lambda: library_mlp(torch, F, x, w1, b1, w2, b2, mlp_rate))
            return fwd_ms + time_ms(torch, lambda: torch.autograd.grad(o, leaves, gm,
                                                                        retain_graph=True))

        add("DP-10-12", g["per_forward"], timed(
            [lambda: fm.fused_mlp_dropout_forward(x, w1, b1, w2, b2, 7, mlp_rate),
             lambda: fm.fused_mlp_backward(x, w1, b1, w1_t, w2_t, gm, 7, mlp_rate)],
            [lambda: fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, k1, k2, mlp_rate),
             lambda: fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, gm, k1, k2, mlp_rate)],
            lib_ms, (f_m[0] + b_m[0], f_m[1] + b_m[1]), err))
    for name, tot in out.items():
        tot["bound_ms"], tot["bound_by"] = bound(tot["flops"], tot["bytes"])
        if tot["err"] > KERNEL_TOL:
            raise AssertionError(f"[dp-forms] {name}: forward {tot['err']} off its plain version")
        log(f"[dp-forms] {name}, one MOD step on one of 2 data shards: {tot['ms']:.3f} ms "
            f"(device {tot['device_ms']:.3f}, plain {tot['plain_ms']:.3f}, library "
            f"{tot['library_ms']:.3f}, bound f32 {tot['bound_ms']:.3f}, {tot['bound_by']}), "
            f"forward error {tot['err']:.2e}")
    return out


def sgd_rate0_step(torch, argv, plan, dev, batch, on_model=None):
    """One MOD pretrain update at every drop rate 0 (SGD at MP_LR, from the
    seed-0 init, fixed rows and views) of the model ``argv`` names
    (SW_Transformer by default): (loss, the updated state_dict whole on the
    CPU, the state_dict before the update, the trained parameters' names).
    ``plan``: the rank's layout, or None for one process; ``on_model``,
    called with the model before the step."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import apply_plan, build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.parallel import tp
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.optim import StepOptimizer, trainable_mask
    from focal_tpu_torch.train.state import TrainState
    from focal_tpu_torch.train.steps import make_pretrain_step

    args = parse_train_params(["-dataset", "MOD", "-batch_size", str(batch), "-device",
                               MP_DEVICE] + argv)
    cfg = copy.deepcopy(args.dataset_config)
    cfg["SW_Transformer"].update(dropout_ratio=0.0, drop_path_rate=0.0, attn_drop_rate=0.0)
    cfg["DeepSense"].update(dropout_ratio=0.0)
    args.dataset_config = cfg
    model = build_backbone(cfg, args.model, args.task, args.learn_framework,
                           pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                           pallas_block=not args.no_pallas_block,
                           compute_dtype=args.compute_dtype)
    model = apply_plan(init_params(model, seed=0).to(dev), plan)
    mask = trainable_mask(model, args)
    params = [p for n, p in model.named_parameters() if mask[n]]
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    opt = StepOptimizer(torch.optim.SGD(params, lr=MP_LR), params, lambda e: MP_LR, 10, plan=plan)
    state = TrainState(model, opt, seed=0, plan=plan)
    host, _, _ = synthetic_arrays(cfg, args.task, batch, seed=0)
    data = to_device(host, dev)
    step = make_pretrain_step(model, build_augmenter(args), make_focal_loss(args), plan=plan)

    def whole():
        state_dict = tp.full_state_dict(model, plan) if plan is not None else model.state_dict()
        return {k: v.detach().cpu().clone() for k, v in state_dict.items()}

    init = whole()
    if on_model is not None:
        on_model(model)
    _, metrics = step(state, data, torch.arange(batch, device=dev))
    return float(metrics["loss"]), whole(), init, [n for n in mask if mask[n]]


def rounding_allowance(torch, dev, batch):
    """Each parameter entry's rounding allowance lr 2 MP_ROUNDING_LAMBDA
    sqrt(n) u A (see MP_PARAM_RTOL), from hooks on every Linear and
    LayerNorm of a single-process rate-0 update on the -no_pallas_block
    route, where the window attentions' qkv and proj run as Linears (at rate
    0 every route computes the same function): a Linear's weight A = |X|^T
    |G| and bias A = the sum of |G| over its n rows (X its input, G the
    gradient of its output), a LayerNorm's the sums of |G| |xhat| and |G|.
    {name: allowance on the CPU}, {name: n}."""
    import torch.nn as nn

    sums = {}

    def watch(name, mod):
        def on_forward(m, inp, out):
            x = inp[0].detach().float()

            def on_grad(g):
                g = g.detach().abs().float().reshape(-1, g.shape[-1])
                xf = x.reshape(-1, x.shape[-1])
                if isinstance(m, nn.LayerNorm):
                    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
                        xf.var(-1, unbiased=False, keepdim=True) + m.eps)
                    terms = {"weight": (g * xhat.abs()).sum(0), "bias": g.sum(0)}
                else:
                    terms = {"weight": g.t() @ xf.abs(), "bias": g.sum(0)}
                for k, a in terms.items():
                    if getattr(m, k, None) is not None:
                        a0, n0 = sums.get(f"{name}.{k}", (0.0, 0))
                        sums[f"{name}.{k}"] = (a0 + a, n0 + g.shape[0])

            if out.requires_grad:
                out.register_hook(on_grad)
        return mod.register_forward_hook(on_forward)

    def hook_all(model):
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Linear, nn.LayerNorm)):
                watch(name, mod)

    sgd_rate0_step(torch, ["-no_pallas_block"], None, dev, batch, on_model=hook_all)
    u = 2.0**-24
    allow = {k: (MP_LR * 2 * MP_ROUNDING_LAMBDA * n**0.5 * u * a).cpu() for k, (a, n) in sums.items()}
    return allow, {k: n for k, (_, n) in sums.items()}


def update_errors(whole, ref, allow):
    """An update against the single-process one, entry by entry: the
    largest ratio of |a - b| to its bound MP_PARAM_RTOL |b| + MP_PARAM_ATOL
    + the entry's rounding allowance (the gate: at most 1), and, reported,
    the largest ratios to allclose's bound alone and, over the entries
    that bound does not hold, to the allowance alone; the worst five
    parameters of each: [(ratio, name)]."""
    gate, plain, rounding = [], [], []
    for n, a in whole.items():
        b = ref[n]
        diff, bnd = (a - b).abs(), MP_PARAM_RTOL * b.abs() + MP_PARAM_ATOL
        gate.append((float((diff / (bnd + allow.get(n, 0.0))).max()), n))
        plain.append((float((diff / bnd).max()), n))
        past = diff > bnd
        if past.any():
            rounding.append((float((diff[past] / allow[n][past]).max()) if n in allow
                             else math.inf, n))
    return tuple(sorted(x, reverse=True)[:5] for x in (gate, plain, rounding))


def planted_fault(whole, ref, init, allow):
    """MP_PLANT applied to an update: model shard 1's slice of the tensor
    (its heads' entries of each of q, k and v) moved 1.5 times as far from
    the init. (the gate's ratio, which must exceed 1; the ratio of the
    per-tensor bound max|a - b| <= MP_PARAM_RTOL max|b| + MP_PARAM_ATOL)."""
    name, scale = MP_PLANT
    a, b = whole[name].clone(), ref[name]
    v, v0 = a.view(3, 2, -1), init[name].view(3, 2, -1)
    v[:, 1] = v0[:, 1] + scale * (v[:, 1] - v0[:, 1])
    diff = (a - b).abs()
    gate = float((diff / (MP_PARAM_RTOL * b.abs() + MP_PARAM_ATOL + allow.get(name, 0.0))).max())
    return gate, float(diff.max() / (MP_PARAM_RTOL * b.abs().max() + MP_PARAM_ATOL))


def collective_split(torch, fn):
    """fn() with every all_reduce and all_gather of torch.distributed
    timed, the card synchronized before and after each: (fn's seconds, the
    collectives' seconds, their count, their bytes). The collectives' time
    includes each rank's wait for the other."""
    import torch.distributed as dist

    spent = {"s": 0.0, "calls": 0, "bytes": 0}
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def timed(name, f):
        def call(*a, **k):
            t = a[0] if name == "all_reduce" else a[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            spent["bytes"] += t.numel() * t.element_size()
            return out
        return call

    for n, f in saved.items():
        setattr(dist, n, timed(n, f))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    return total, spent["s"], spent["calls"], spent["bytes"]


def rate0_ref_path(layout, variant):
    return os.path.join(HERE, "build", f"phase35_rate0_{layout}_{variant}.pt")


def phase35_rank(rank, world, layout):
    """One of two ranks of phase 35 on the shared card (spawned by
    run_local without a process group: the entry point joins it from the
    FOCAL_DIST_* variables). (1) ``python -m focal_tpu_torch.train``'s main
    on MOD at the layout's flags, every count zeroed before and read after;
    then the layout's MP_LAYOUT_STAGES (the bf16 TP layout's finetune,
    supervised stage and test CLI), counted alike; (2) the rate-0 SGD
    updates of MP_RATE0 against the single-process ones
    the parent saved: an f32 update entry by entry (update_errors) with
    MP_PLANT planted where the model has it, a bf16 one by C11's gates on
    its gradients (the update over the learning rate: bf16_grad_stats);
    (3) MP_WARMUP + the layout's timed pretrain steps at the recipe's rates:
    p50, peak memory, launches; then one step with its collectives timed
    (collective_split)."""
    sys.path.insert(0, HERE)
    import importlib

    import numpy as np
    import torch

    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import apply_plan, build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.parallel import distributed
    from focal_tpu_torch.parallel.mesh import make_mesh_plan
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = mp_kernels()
    layout_flags, model_flags = MP_LAYOUTS[layout]
    flags = layout_flags + model_flags
    steps = mp_steps(layout)
    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    out_dir = os.path.join(HERE, "build", f"phase35_{layout}")
    argv = ["-dataset", "MOD", "-synthetic", "-synthetic_samples", str(MP_SAMPLES), "-epochs",
            "1", "-val_epochs", "1", "-output_dir", out_dir, "-device", MP_DEVICE] + flags
    zero_counts(kernels)
    t_layout = t0 = time.time()
    train_cli.main(argv)
    torch.cuda.synchronize()
    res = {"rank": rank, "backend": distributed.backend(), "cli_seconds": time.time() - t0,
           "cli_launches": counts(kernels), "stages": {}}
    for name, module, more, _ in MP_LAYOUT_STAGES.get(layout, ()):
        zero_counts(kernels)
        t0 = time.time()
        importlib.import_module(f"focal_tpu_torch.{module}").main(argv + more)
        torch.cuda.synchronize()
        res["stages"][name] = {"seconds": time.time() - t0, "launches": counts(kernels)}
    if layout in MP_ENTRY_ONLY:
        res["seconds"] = time.time() - t_layout
        return res
    dev = torch.device(distributed.device_for(MP_DEVICE))
    plan = make_mesh_plan(2, 1) if "-data_parallel" in layout_flags else make_mesh_plan(1, 2)
    res["rate0"] = {}
    for variant, extra in MP_RATE0[layout].items():
        zero_counts(kernels)
        loss, whole, init, names = sgd_rate0_step(torch, flags + extra, plan, dev, TRAIN_BATCH)
        ref = torch.load(rate0_ref_path(layout, variant), weights_only=True)
        v = {"loss": loss, "loss_single": ref["loss"],
             "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]), "launches": counts(kernels)}
        if mp_bf16(layout):
            grads = [(init[n] - whole[n]) / MP_LR for n in names]
            want = [(ref["init"][n] - ref["state"][n]) / MP_LR for n in names]
            v["grads"] = bf16_grad_stats(names, grads, want)
            v["ok"] = (v["loss_rel"] <= BF16_LOSS_TOL and v["grads"]["min_cos"] >= BF16_GRAD_MIN_COS
                       and v["grads"]["median_rel"] <= BF16_GRAD_MEDIAN_TOL
                       and v["grads"]["zero_true_gradient_max_abs"] <= NEAR_ZERO)
        else:
            gate, plain, rounding = update_errors(whole, ref["state"], ref["allow"])
            v.update(worst_ratio=gate[0][0], worst_name=gate[0][1], worst_gate=gate,
                     worst_allclose=plain, worst_allowance=rounding)
            v["ok"] = v["loss_rel"] <= MP_LOSS_RTOL and gate[0][0] <= 1
            if MP_PLANT[0] in whole:
                v["plant_gate"], v["plant_per_tensor"] = planted_fault(whole, ref["state"], init,
                                                                        ref["allow"])
        res["rate0"][variant] = v
        del whole, init, ref
    args = parse_train_params(["-dataset", "MOD", "-batch_size", str(TRAIN_BATCH), "-device",
                               MP_DEVICE] + flags)
    model = build_backbone(args.dataset_config, args.model, args.task, args.learn_framework,
                           pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                           pallas_block=not args.no_pallas_block, compute_dtype=args.compute_dtype)
    model = apply_plan(init_params(model, seed=0).to(dev), plan)
    state = create_train_state(args, model, steps_per_epoch=100, seed=0)
    host, _, _ = synthetic_arrays(args.dataset_config, args.task, TRAIN_BATCH, seed=0)
    data = to_device(host, dev)
    idx = torch.arange(TRAIN_BATCH, device=dev)
    step = make_pretrain_step(model, build_augmenter(args), make_focal_loss(args), plan=plan)
    for _ in range(MP_WARMUP):
        step(state, data, idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    step_s, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.time()
        losses.append(float(step(state, data, idx)[1]["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
    res.update(steps_launches=counts(kernels), p50_ms=float(np.percentile(step_s, 50)) * 1e3,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20, losses=losses)
    total, coll, calls, nbytes = collective_split(torch, lambda: step(state, data, idx))
    res["split"] = {"step_ms": total * 1e3, "collective_ms": coll * 1e3, "calls": calls,
                    "mbytes": nbytes / 2**20}
    res["seconds"] = time.time() - t_layout
    return res


def phase35_ranks(rank, world, layouts):
    """phase35_rank for each of ``layouts`` in turn, in one pair of ranks:
    the first entry point joins the process group, the others find it
    joined (a pair of processes a layout spent ~15 s starting and stopping
    on the card's host)."""
    import gc

    import torch

    out = []
    for layout in layouts:
        out.append(phase35_rank(rank, world, layout))
        gc.collect()
        torch.cuda.empty_cache()
    return out


DP_ROWS = {  # a data shard's kernels: forward, backward, the update that also runs them
    "DP-1-5": ("fused_window_block_dropout", "fused_window_block_backward", "default"),
    "DP-6-9": ("fused_window_attention", "fused_window_attention_backward",
               "no_pallas_block_pallas_mlp"),
    "DP-10-12": ("fused_mlp_forward", "fused_mlp_backward", "no_pallas_block_pallas_mlp")}


def check_mp_launches(layout, ranks, per_fwd):
    """Phase 35's launches: the timed steps ran the layout's kernels
    exactly (per_fwd a step each: #4-TP/#5-TP at mp 2; #2/#3 on a data
    shard's rows at dp 2) and the other layout's none; the entry point ran
    the layout's, and the dp 2 -no_pallas_block -pallas_mlp rate-0 update
    #6/#8 and #10/#12 on a data shard's rows. A layout of MP_LAYOUT_KERNELS:
    its timed steps each ran its kernels as many times as its rate-0 update
    (at least once) and no other of MP_KERNELS, and so did its entry point
    (the DeepSense TP layouts none); each of its MP_LAYOUT_STAGES launched
    the kernels it must and no other of MP_KERNELS."""
    if layout in MP_ENTRY_ONLY:
        # sharded dp 2: each rank's rows; the train split's KNN plan one
        # batch of each rank's rows, val and test two views and the features
        from focal_tpu_torch.data import DeviceDataLoader, load_split
        from focal_tpu_torch.params import parse_train_params

        args = parse_train_params(["-dataset", "MOD", "-synthetic", "-synthetic_samples",
                                   str(MP_SAMPLES), "-device", "cpu"])
        seq = args.dataset_config["seq_len"]
        local_units, per = MP_SAMPLES // seq // 2, args.batch_size // seq // 2
        steps = local_units // per
        knn = -(-local_units * seq // (args.batch_size // 2))
        evals = knn + 3 * sum(len(DeviceDataLoader(load_split(o, args), args.batch_size,
                                                   sequence=True)) for o in ("val", "test"))
        want = {k: {"fused_window_block_dropout": per_fwd * steps,
                    "fused_window_block_backward": per_fwd * steps,
                    "fused_window_block": per_fwd * evals}.get(k, 0) for k in MP_KERNELS}
        for r in ranks:
            if r["cli_launches"] != want:
                raise AssertionError(f"[multi-process] {layout} rank {r['rank']}: entry point "
                                     f"launches {r['cli_launches']} != {want}")
        return
    if layout in MP_LAYOUT_KERNELS:
        names, steps = MP_LAYOUT_KERNELS[layout], mp_steps(layout)
        for r in ranks:
            one = r["rate0"]["default"]["launches"]
            want = {k: steps * one[k] if k in names else 0 for k in MP_KERNELS}
            cli = r["cli_launches"]
            if (r["steps_launches"] != want or any(one[k] < 1 for k in names)
                    or any(cli[k] < 1 for k in names)
                    or any(v for k, v in cli.items() if k not in names)):
                raise AssertionError(f"[multi-process] {layout} rank {r['rank']}: launches "
                                     f"{r['steps_launches']}, rate-0 update {one}, entry point "
                                     f"{cli}")
            for name, _, _, must in MP_LAYOUT_STAGES.get(layout, ()):
                got = r["stages"][name]["launches"]
                if any(got[k] < 1 for k in must) or any(v for k, v in got.items()
                                                        if k not in names):
                    raise AssertionError(f"[multi-process] {layout} rank {r['rank']} {name}: "
                                         f"launches {got}")
        return
    want_tp = MP_STEPS * per_fwd if layout == "mp2" else 0
    want_dp = MP_STEPS * per_fwd if layout == "dp2" else 0
    for r in ranks:
        got = r["steps_launches"]
        if (got["fused_window_block_tp"], got["fused_window_block_tp_backward"],
                got["fused_window_block_dropout"], got["fused_window_block_backward"]) != (
                want_tp, want_tp, want_dp, want_dp):
            raise AssertionError(f"[multi-process] {layout} rank {r['rank']}: launches {got}")
        if min(r["cli_launches"][k] for k in (
                ("fused_window_block_tp", "fused_window_block_tp_backward") if layout == "mp2"
                else DP_ROWS["DP-1-5"][:2])) < 1:
            raise AssertionError(f"[multi-process] {layout}: the entry point ran no kernel "
                                 f"of the layout: {r['cli_launches']}")
        if layout == "dp2" and min(r["rate0"]["no_pallas_block_pallas_mlp"]["launches"][k]
                                   for num in ("DP-6-9", "DP-10-12")
                                   for k in DP_ROWS[num][:2]) < 1:
            raise AssertionError(f"[multi-process] dp2: the -no_pallas_block -pallas_mlp update "
                                 f"ran no attention or MLP kernel: {r['rate0']}")


def multi_process_paths(torch, dev):
    """Phase 35: MOD pretraining at full width on two ranks sharing the
    card (gloo), at every layout of MP_LAYOUTS, one after the other in one
    pair of ranks (phase35_ranks): SW_Transformer at -data_parallel 2 and
    -model_parallel 2 in f32 and at -model_parallel 2 in bf16, DeepSense at
    -model_parallel 2 in f32 and bf16 and with -pallas_conv at
    -data_parallel 2 in f32 and bf16, SW_Transformer at -data_parallel 2
    on the sharded layout (phase35_rank); the single-process rate-0 updates
    they are held to are taken here first."""
    from focal_tpu_torch.parallel import distributed
    from focal_tpu_torch.params import load_dataset_config

    t0 = time.time()
    allow, rows = rounding_allowance(torch, dev, TRAIN_BATCH)
    for layout, variants in MP_RATE0.items():
        for variant, extra in variants.items():
            model_flags = MP_LAYOUTS[layout][1]
            loss, whole, init, _ = sgd_rate0_step(torch, model_flags + extra, None, dev,
                                                  TRAIN_BATCH)
            # the allowances are SW_Transformer's (hooks on its Linears and
            # LayerNorms); a DeepSense update is held to allclose alone
            torch.save({"loss": loss, "state": whole, "init": init,
                        "allow": {} if "DeepSense" in model_flags else allow},
                       rate0_ref_path(layout, variant))
            del whole, init
    per_fwd = sum(g["per_forward"] for g in block_geometries(load_dataset_config("MOD"), 1))
    out = {"layouts": {}, "per_forward": per_fwd, "allowance_rows": rows}
    t1 = time.time()
    pairs = distributed.run_local(phase35_ranks, 2, list(MP_LAYOUTS), device=MP_DEVICE,
                                  timeout=1500, init=False)
    out["ranks_seconds"] = time.time() - t1
    log(f"[multi-process] {len(MP_LAYOUTS)} layouts in one pair of ranks: "
        f"{out['ranks_seconds']:.1f}s")
    for i, layout in enumerate(MP_LAYOUTS):
        ranks = [pair[i] for pair in pairs]
        for r in ranks:
            for variant, v in r.get("rate0", {}).items():
                if not v["ok"]:
                    raise AssertionError(f"[multi-process] {layout} rank {r['rank']} {variant}: "
                                         f"the rate-0 update is off the single-process one: {v}")
                if v.get("plant_gate", math.inf) <= 1:
                    raise AssertionError(f"[multi-process] {layout} {variant}: the gate passes "
                                         f"the planted fault {MP_PLANT}: {v['plant_gate']}")
        check_mp_launches(layout, ranks, per_fwd)
        out["layouts"][layout] = {"seconds": max(r["seconds"] for r in ranks), "ranks": ranks}
        steps = mp_steps(layout)
        for r in ranks:
            if layout in MP_ENTRY_ONLY:
                log(f"[multi-process] {layout} rank {r['rank']} (two ranks sharing one card, "
                    f"{r['backend']}): entry point {r['cli_seconds']:.1f}s, launches "
                    f"{ {k: v for k, v in r['cli_launches'].items() if v} } (exact)")
                continue
            stages = "".join(f"; {n} {st['seconds']:.1f}s, launches "
                             f"{ {k: v for k, v in st['launches'].items() if v} }"
                             for n, st in r["stages"].items())
            log(f"[multi-process] {layout} rank {r['rank']} (two ranks sharing one card, "
                f"{r['backend']}): entry point {r['cli_seconds']:.1f}s, launches "
                f"{ {k: v for k, v in r['cli_launches'].items() if v} }{stages}; rate-0 update vs one "
                f"process: " + ", ".join(rate0_summary(k, v) for k, v in r["rate0"].items())
                + f"; {steps} steps p50 {r['p50_ms']:.3f} ms, peak {r['peak_mb']:.1f} MiB "
                f"(two ranks sharing one card: not multi-GPU speed), losses {r['losses']}; one "
                f"step with its collectives timed: {r['split']['step_ms']:.1f} ms, "
                f"collectives {r['split']['collective_ms']:.1f} ms ({r['split']['calls']} "
                f"calls, {r['split']['mbytes']:.1f} MiB)")
        log(f"[multi-process] {layout} in {out['layouts'][layout]['seconds']:.1f}s")
    out["seconds"] = time.time() - t0
    return out


def rate0_summary(variant, v):
    """One rate-0 update's line of phase 35's log."""
    if "grads" in v:
        gs = v["grads"]
        return (f"{variant} (C11's gates) loss rel {v['loss_rel']:.2e}, min cosine "
                f"{gs['min_cos']:.5f} ({gs['min_cos_tensor']}), median rel {gs['median_rel']:.3e}, "
                f"max rel {gs['max_rel']:.3e} ({gs['max_rel_tensor']}), true-zero gradients "
                f"within {gs['zero_true_gradient_max_abs']:.3e}")
    line = (f"{variant} loss rel {v['loss_rel']:.2e}, worst entries over the gate's bound "
            f"{v['worst_gate'][:3]}, over allclose's alone {v['worst_allclose'][:3]}, over the "
            f"rounding allowance alone {v['worst_allowance'][:3]}")
    if "plant_gate" in v:
        line += (f", planted fault {v['plant_gate']:.3g} of the gate's bound "
                 f"({v['plant_per_tensor']:.3g} of the per-tensor one)")
    return line


def multi_process_entries(tpk, dp_forms, multi, tpb, dpt):
    """The kernels line's rows of phases 34-36: #4-TP, #5-TP, the
    data-parallel forms, #4-TP-bf16, #5-TP-bf16 and DP-13-14(-bf16)."""
    kernels = []
    layouts = multi["layouts"]

    def mp_launches(layout, name, where="cli_launches"):
        """A kernel's launches in a layout's run, both ranks."""
        return sum(r[where][name] if where == "cli_launches" else r["rate0"][where]["launches"][name]
                   for r in layouts[layout]["ranks"])

    tst = tpk["step"]
    tp_per = (f"times: the {tpk['per_forward']} launches of one MOD pretrain step at batch "
              f"{TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH}, dropout {tpk['rate']}) on one of "
              "two model shards (D = C / 2); launches: the -model_parallel 2 entry point's run, "
              "both ranks (training and eval forwards); max_abs_err: worst over every local "
              "geometry of MOD's and MOD_WIDE's stages at mp 2 and 4; bound: 3 TF32 products an "
              "f32 one at 495 TFLOP/s, or the bytes")

    def tp_entry(name, num, line, d, err, also):
        return {"name": name, "kernel": num, "route": "cuda",
                "source": "focal_tpu_torch/csrc/window_block.cu", "replaces": f"{PK}:{line}",
                "replaces_also": also, "launches": mp_launches("mp2", name),
                "max_abs_err": err, "ms": tst[f"{d}_ms"], "plain_ms": tst[f"{d}_plain_ms"],
                "bound_ms": tst[f"{d}_bound_ms"], "bound_by": tst[f"{d}_bound_by"],
                "library_ms": tst[f"{d}_library_ms"], "per": tp_per,
                "device_ms": tst[f"{d}_device_ms"], "bound_ms_f32": tst[f"{d}_bound_f32_ms"],
                "flops": tst[f"{d}_flops"], "bytes": tst[f"{d}_bytes"],
                "launches_by_path": {"train_cli_MOD_mp2": mp_launches("mp2", name),
                                     "timed_steps_MOD_mp2": sum(r["steps_launches"][name] for r
                                                                in layouts["mp2"]["ranks"]),
                                     "rate0_step_MOD_mp2": mp_launches("mp2", name, "default")}}

    terr = tpk["errors"]
    kernels += [
        tp_entry("fused_window_block_tp", "#4-TP", 1759, "fwd", terr["fwd"], [f"{PK}:1629",
                                                                             f"{PK}:1303"]),
        tp_entry("fused_window_block_tp_backward", "#5-TP", 1727, "bwd", terr["bwd_abs"],
                 [f"{PK}:1342"]) | {"max_rel_err": terr["bwd"]},
    ]
    dp_rows = (("DP-1-5", 1622, 1546, "cli_launches", "#2 forward and #3 backward",
                "the -data_parallel 2 entry point's run", "focal_tpu_torch/csrc/window_block.cu"),
               ("DP-6-9", 439, 380, "no_pallas_block_pallas_mlp",
                "#7 forward and #9 backward (-no_pallas_block)",
                "#6 in the -data_parallel 2 -no_pallas_block -pallas_mlp rate-0 update", ATTN_SRC),
               ("DP-10-12", 800, 747, "no_pallas_block_pallas_mlp",
                "#11 forward and #12 backward (-pallas_mlp)",
                "#10 in the -data_parallel 2 -no_pallas_block -pallas_mlp rate-0 update",
                "focal_tpu_torch/csrc/fused_mlp.cu"))
    for num, line, also, where, what, run, src in dp_rows:
        t, (fwd_name, bwd_name, _) = dp_forms[num], DP_ROWS[num]
        kernels.append({
            "name": f"{fwd_name} + {bwd_name} on a data shard", "kernel": num, "route": "cuda",
            "source": src, "replaces": f"{PK}:{line}", "replaces_also": [f"{PK}:{also}"],
            "launches": mp_launches("dp2", fwd_name, where), "max_abs_err": t["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "per": (f"the existing kernels at a data shard's rows, its kernel seed (no wrapper of "
                    f"their own); times: {what} of one MOD pretrain step at batch {TRAIN_BATCH} "
                    f"on one of two data shards ({TRAIN_BATCH // 2} samples, views fused to "
                    f"{TRAIN_BATCH}), the recipe's rates; launches (forwards): {run}, both ranks; "
                    "max_abs_err: the forward against its plain version there; bound: f32 at "
                    "67 TFLOP/s or the bytes"),
            "launches_by_path": {"train_cli_MOD_dp2": mp_launches("dp2", fwd_name),
                                 "timed_steps_MOD_dp2": sum(r["steps_launches"][fwd_name] for r in
                                                            layouts["dp2"]["ranks"]),
                                 **{f"rate0_step_MOD_dp2_{v}": mp_launches("dp2", fwd_name, v)
                                    for v in MP_RATE0["dp2"]}}})

    def launches_by_path(layout, name):
        return {f"train_cli_MOD_{layout}": mp_launches(layout, name),
                f"timed_steps_MOD_{layout}": sum(r["steps_launches"][name]
                                                 for r in layouts[layout]["ranks"]),
                f"rate0_step_MOD_{layout}": mp_launches(layout, name, "default")}

    bst, berr = tpb["step"], tpb["errors"]
    tpb_per = (f"times: the {tpb['per_forward']} launches of one MOD bf16 pretrain step at batch "
               f"{TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH}, dropout {tpb['rate']}) on one "
               "of two model shards (D = C / 2); launches: the -model_parallel 2 -compute_dtype "
               "bfloat16 entry point's run, both ranks (training and eval forwards); "
               "max_abs_err: worst over every local geometry of MOD's and MOD_WIDE's stages at "
               "mp 2 and 4 against the bf16 plain versions; bound: B_ (8 N C D + 4 N^2 D) FLOPs "
               "forward, B_ (22 N C D + 12 N^2 D) backward at 989 TFLOP/s, or the bytes; "
               "library: cuBLAS bf16 + SDPA at the local geometry")
    for name, num, line, d, also in (
            ("fused_window_block_tp_bf16", "#4-TP-bf16", 1759, "fwd", [f"{PK}:1629", f"{PK}:1303"]),
            ("fused_window_block_tp_backward_bf16", "#5-TP-bf16", 1727, "bwd", [f"{PK}:1342"])):
        kernels.append({
            "name": name, "kernel": num, "route": "cuda",
            "source": "focal_tpu_torch/csrc/window_block.cu", "replaces": f"{PK}:{line}",
            "replaces_also": also, "launches": mp_launches("mp2_bf16", name),
            "max_abs_err": berr[f"{d}_abs"], "max_rel_err": berr[d], "ms": bst[f"{d}_ms"],
            "plain_ms": bst[f"{d}_plain_ms"], "bound_ms": bst[f"{d}_bound_ms"],
            "bound_by": bst[f"{d}_bound_by"], "library_ms": bst[f"{d}_library_ms"],
            "device_ms": bst[f"{d}_device_ms"], "flops": bst[f"{d}_flops"],
            "bytes": bst[f"{d}_bytes"], "per": tpb_per,
            "launches_by_path": launches_by_path("mp2_bf16", name)})
    for dtype, num, layout, fwd_name, bwd_name in (
            ("float32", "DP-13-14", "ds_pallas_conv_dp2", "fused_conv_tower",
             "fused_conv_tower_backward"),
            ("bfloat16", "DP-13-14-bf16", "ds_pallas_conv_dp2_bf16", "fused_conv_tower_bf16",
             "fused_conv_tower_backward_bf16")):
        t = dpt[dtype]
        kernels.append({
            "name": f"{fwd_name} + {bwd_name} over data ranks", "kernel": num, "route": "cuda",
            "source": "focal_tpu_torch/csrc/conv_tower.cu", "replaces": f"{CT}:288",
            "replaces_also": [f"{CT}:327", f"{CT}:349", f"{CT}:366", f"{CT}:387"],
            "launches": mp_launches(layout, fwd_name) + mp_launches(layout, bwd_name),
            "max_abs_err": t["err"], "max_rel_err": t["grad_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"], "flops": t["flops"],
            "bytes": t["bytes"],
            "per": (f"#13 and #14 writing raw BatchNorm sums, the statistics finished at the "
                    f"global count (the sums over the data ranks in phase 35's collectives); "
                    f"times: the towers of one MOD DeepSense -pallas_conv step ({dtype}) on one "
                    f"of two data shards ({TRAIN_BATCH // 2} samples, views fused to "
                    f"{TRAIN_BATCH}), forward plus backward; launches: #13's and #14's wrappers "
                    f"in the -data_parallel 2 -pallas_conv entry point's run, both ranks; "
                    "max_abs_err: the outputs and statistics against the plain DP form "
                    "(relative), max_rel_err its gradients; library: the cuDNN chain; bound: "
                    "the convs at the f32 (bf16) peak, the rest at 67 TFLOP/s, or the bytes"),
            "launches_by_path": {k: launches_by_path(layout, fwd_name)[k]
                                 + launches_by_path(layout, bwd_name)[k]
                                 for k in launches_by_path(layout, fwd_name)}})
    return kernels


# ---------------------------------------------------------------------------
# phase 36: #4-TP-bf16/#5-TP-bf16, and the conv tower's data-parallel form

class TwinRanks:
    """A stand-in plan of two data ranks that hold the same rows: their sum
    doubles a tensor (in place, as all_reduce does). It times the
    data-parallel tower's own work on one shard without a process group:
    its launches write raw sums, its statistics' last steps run at twice the
    count; the sums over the ranks themselves (2 x C floats a conv) are the
    collectives' part of phase 35."""
    dp = 2

    @staticmethod
    def sum_data_(t):
        return t.mul_(2.0)

    @staticmethod
    def sum_data(t):
        return 2.0 * t


def tp_bf16_work(g, mp, backward, with_keep):
    """#4-TP-bf16 (#5-TP-bf16) on one of mp shards: B_ (8 N C D + 4 N^2 D)
    FLOPs forward and B_ (22 N C D + 12 N^2 D) backward at the bf16 tensor
    cores' peak, D = C / mp; bytes at the types they move, each once: x, y
    (dy, dx) and the shard's weights bf16, its biases, bias table, shift
    mask and parameter gradients f32, the keep mask uint8. Returns (flops,
    bytes, bound ms, what bounds)."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    D, Hl = C // mp, H // mp
    small = 4 * (3 * D + C + Hl * N * N) + (4 * g["nW"] * N * N if g["mask"] is not None else 0)
    small += B * Hl * N * N if with_keep else 0
    if backward:
        flops = B * (22 * N * C * D + 12 * N * N * D)
        nbytes = 2 * (3 * B * N * C + 4 * C * D) + small + 4 * (4 * C * D + 3 * D + C + Hl * N * N)
    else:
        flops = B * (8 * N * C * D + 4 * N * N * D)
        nbytes = 2 * (2 * B * N * C + 4 * C * D) + small
    t_ops, t_by = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, 1e3 * max(t_ops, t_by), "operations" if t_ops >= t_by else "bytes"


def tp_bf16_kernel_paths(torch, np, pk, gen, dev):
    """Phase 36: #4-TP-bf16/#5-TP-bf16 (fused_window_block_tp_bf16,
    _backward_bf16) against their bf16 plain versions at every local
    geometry of MOD's and MOD_WIDE's stages at mp 2 and 4 (TP_GATE_WINDOWS
    windows), at rate 0 and the recipe's rate: y within BF16_FWD_TOL of
    max|y|, every gradient within BF16_GRAD_TOL relative (absolutely to
    NEAR_ZERO where both sides are below it), each kernel the same bits on a
    second call, the keep rate within 5 sigma; at D = C (one shard) the
    bits of #4-bf16/#5-bf16, the same code (the card tests hold those to
    the parent's). Then timed at MOD's training geometries on one of two
    shards (phase 35's mp 2 bf16 layout): events and device time a step,
    the bf16 plain versions, cuBLAS bf16 + SDPA at the local geometry, the
    bound."""
    from focal_tpu_torch.params import load_dataset_config

    t0 = time.time()
    fwd, bwd = pk.fused_window_block_tp_bf16, pk.fused_window_block_tp_backward_bf16
    bf = torch.bfloat16
    cfg = load_dataset_config("MOD")
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    seen, gates = set(), []
    errs = {"fwd": 0.0, "fwd_abs": 0.0, "bwd": 0.0, "bwd_near": 0.0, "bwd_abs": 0.0,
            "keep_sigma": 0.0}
    for ds in ("MOD", "MOD_WIDE"):
        for geo in block_geometries(load_dataset_config(ds), 1):
            key = (geo["N"], geo["C"], geo["heads"], geo["mask"] is not None)
            if key in seen:
                continue
            seen.add(key)
            g = dict(geo, windows=TP_GATE_WINDOWS)
            whole = bf16_inputs(torch, g, gen, dev)
            dy = torch.randn(whole[0].shape, generator=gen).to(dev).to(bf)
            # one shard: D = C, the per-head bf16 kernels' call
            y1, k1 = fwd(*whole, 11, rate)
            y0, k0 = pk.fused_window_block_perhead_bf16(*whole, 11, rate)
            same = torch.equal(y1, y0) and torch.equal(k1, k0) and all(
                torch.equal(a, b) for a, b in zip(bwd(*whole, dy, k1, rate),
                                                  pk.fused_window_block_perhead_backward_bf16(
                                                      *whole, dy, k0, rate)))
            if not same:
                raise AssertionError(f"[tp-bf16] at D = C #4-TP-bf16/#5-TP-bf16 differ from "
                                     f"#4-bf16/#5-bf16 at {key}")
            for mp in TP_WAYS:
                for r in (0.0, rate):
                    args = tp_shard(torch, whole, mp, mp - 1)
                    y, keep = fwd(*args, 11, r)
                    y2, keep2 = fwd(*args, 11, r)
                    got = bwd(*args, dy, keep, r)
                    again = bwd(*args, dy, keep, r)
                    torch.cuda.synchronize()
                    if not (torch.equal(y, y2) and (keep is None or torch.equal(keep, keep2))
                            and all(torch.equal(a, b) for a, b in zip(got, again))):
                        raise AssertionError(f"[tp-bf16] repeats with other bits at {key}, mp {mp}")
                    ref = pk.fused_window_block_bf16_reference(*args, keep, r).float()
                    errs["fwd"] = max(errs["fwd"], rel_err(y.float(), ref))
                    errs["fwd_abs"] = max(errs["fwd_abs"], float((y.float() - ref).abs().max()))
                    want = pk.fused_window_block_backward_bf16_reference(*args, dy, keep, r)
                    rel, near, absolute = grad_errors([a.float() for a in got],
                                                      [w.float() for w in want])
                    errs["bwd"], errs["bwd_near"] = max(errs["bwd"], rel), max(errs["bwd_near"], near)
                    errs["bwd_abs"] = max(errs["bwd_abs"], absolute)
                    if r:
                        kept = float(keep.double().mean())
                        errs["keep_sigma"] = max(errs["keep_sigma"], abs(kept - (1 - r)) / (
                            r * (1 - r) / keep.numel()) ** 0.5)
                gates.append({"N": key[0], "C": key[1], "heads": key[2], "shifted": key[3],
                              "mp": mp})
    if (errs["fwd"] > BF16_FWD_TOL or errs["bwd"] > BF16_GRAD_TOL or errs["bwd_near"] > NEAR_ZERO
            or errs["keep_sigma"] > 5):
        raise AssertionError(f"[tp-bf16] past the gates: {errs}")
    log(f"[tp-bf16] #4-TP-bf16/#5-TP-bf16 at {len(gates)} local geometries (rate 0 and {rate}) "
        f"vs the bf16 plain versions: {errs}; at D = C the bits of #4-bf16/#5-bf16")

    # timed: one shard of two at MOD's training geometries
    mp = 2
    geos = block_geometries(cfg, 2 * TRAIN_BATCH)
    for g in geos:
        args = tp_shard(torch, bf16_inputs(torch, g, gen, dev), mp, 0)
        dy = torch.randn(args[0].shape, generator=gen).to(dev).to(bf)
        y, keep = fwd(*args, 7, rate)
        ref = pk.fused_window_block_bf16_reference(*args, keep, rate).float()
        g["fwd_err"] = rel_err(y.float(), ref)
        g["fwd_abs_err"] = float((y.float() - ref).abs().max())
        got = bwd(*args, dy, keep, rate)
        want = pk.fused_window_block_backward_bf16_reference(*args, dy, keep, rate)
        g["bwd_err"] = grad_errors([a.float() for a in got], [w.float() for w in want])[0]
        if g["fwd_err"] > BF16_FWD_TOL or g["bwd_err"] > BF16_GRAD_TOL:
            raise AssertionError(f"[tp-bf16] {g['name']}: off the plain versions at the main "
                                 f"path's geometry: {g['fwd_err']}, {g['bwd_err']}")
        g["fwd_ms"] = time_ms(torch, lambda: fwd(*args, 7, rate))
        g["fwd_device_ms"] = device_ms_per_call(torch, lambda: fwd(*args, 7, rate))
        g["fwd_plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_bf16_reference(
            *args, keep, rate))
        g["bwd_ms"] = time_ms(torch, lambda: bwd(*args, dy, keep, rate))
        g["bwd_device_ms"] = device_ms_per_call(torch, lambda: bwd(*args, dy, keep, rate))
        g["bwd_plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_backward_bf16_reference(
            *args, dy, keep, rate))
        g["fwd_library_ms"], g["bwd_library_ms"] = library_bf16_ms(
            torch, dict(g, heads=g["heads"] // mp), args, dy, rate)
        for d in ("fwd", "bwd"):
            f, b, bnd, by = tp_bf16_work(g, mp, d == "bwd", True)
            g.update({f"{d}_flops": f, f"{d}_bytes": b, f"{d}_bound_ms": bnd, f"{d}_bound_by": by})
        del args, dy, y, keep, got, want, ref
    keys = [f"{d}_{k}" for d in ("fwd", "bwd") for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")]
    tot = {k: sum(g["per_forward"] * g[k] for g in geos) for k in keys}
    for d in ("fwd", "bwd"):
        tot[f"{d}_bound_by"] = ("operations" if tot[f"{d}_flops"] / BF16_FLOPS
                                >= tot[f"{d}_bytes"] / HBM_BYTES_PER_S else "bytes")
        tot[f"{d}_err"] = max(g[f"{d}_err"] for g in geos)
    per_fwd = sum(g["per_forward"] for g in geos)
    log(f"[tp-bf16] one MOD bf16 step on one of {mp} shards ({per_fwd} launches each, rate "
        f"{rate}): " + "; ".join(
            f"{n} {tot[f'{d}_ms']:.3f} ms (device {tot[f'{d}_device_ms']:.3f}, plain "
            f"{tot[f'{d}_plain_ms']:.3f}, library {tot[f'{d}_library_ms']:.3f}, bound "
            f"{tot[f'{d}_bound_ms']:.3f} {tot[f'{d}_bound_by']})"
            for d, n in (("fwd", "#4-TP-bf16"), ("bwd", "#5-TP-bf16"))))
    torch.cuda.empty_cache()
    return {"seconds": time.time() - t0, "gates": gates, "errors": errs, "step": tot,
            "per_forward": per_fwd, "rate": rate,
            "geometries": [{k: v for k, v in g.items() if k != "mask"} for g in geos]}


def dp_tower_times(torch, np, ct, dev):
    """DP-13-14 (f32) and DP-13-14-bf16: the towers of one MOD DeepSense
    -pallas_conv step on one of two data shards (TRAIN_BATCH / 2 samples,
    views fused to TRAIN_BATCH), through the data-parallel form (TwinRanks:
    each conv's launch writes raw sums, the statistics finished at the
    global count between the launches; the backward's means from the
    summed s2). Each geometry: the output, statistics and every gradient
    against the plain DP form (fused_conv_tower_reference with the same
    plan; bf16: its written-out VJP), forward plus backward by events and
    device time (tower_forward and fused_conv_tower_backward called as
    time_tower calls them), the plain versions and the cuDNN chain
    (library_tower; bf16 rows in bf16), each forward and autograd
    backward, and the bound (tower_work, tower_bf16_work). Summed over the
    step's towers."""
    import torch.nn.functional as F
    from focal_tpu_torch.params import load_dataset_config

    t0 = time.time()
    cfg = load_dataset_config("MOD")
    plan = TwinRanks()
    out = {}
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
               "bytes": 0, "bound_ms": 0.0, "err": 0.0, "grad_err": 0.0}
        for g in tower_geometries(cfg, TRAIN_BATCH, "MOD"):
            x0, params, masks, dy = (tower_bf16_inputs if bf16 else tower_inputs)(
                torch, np, g, 91 + g["S"], dev)
            cfgs, ext = g["cfgs"], g["external"]
            xl, pl_, leaves = tower_leaves(torch, x0, params, ext)

            def kernels():
                a = ct.fused_conv_tower(xl, cfgs, *pl_, masks, ext, plan=plan)[0]
                return torch.autograd.grad(a, leaves, dy)

            def plain():
                a = ct.fused_conv_tower_reference(xl, cfgs, *pl_, masks, ext, plan=plan)[0]
                return torch.autograd.grad(a, leaves, dy)

            got_a = ct.fused_conv_tower(xl, cfgs, *pl_, masks, ext, plan=plan)
            want_a = ct.fused_conv_tower_reference(xl, cfgs, *pl_, masks, ext, plan=plan)
            err = max(rel_err(a.detach().float(), w.detach().float()) for a, w in zip(
                [got_a[0], *got_a[1], *got_a[2]], [want_a[0], *want_a[1], *want_a[2]]))
            rel, near, _ = grad_errors([t.float() for t in kernels()],
                                       [t.float() for t in plain()])
            if err > (BF16_FWD_TOL if bf16 else KERNEL_TOL) or rel > (
                    BF16_GRAD_TOL if bf16 else GRAD_TOL) or near > NEAR_ZERO:
                raise AssertionError(f"[dp-tower] {dtype} {g['name']}: the DP form is off its "
                                     f"plain version: {err}, {rel}, {near}")
            lib_params = params if not bf16 else [[w.to(torch.bfloat16) for w in params[0]],
                                                  [b.to(torch.bfloat16) for b in params[1]],
                                                  *params[2:]]
            lx, lp, lleaves = tower_leaves(torch, x0, lib_params, ext)
            lmasks = masks if not bf16 else [m.to(torch.bfloat16) for m in masks]
            dyl = dy.permute(0, 2, 1).unsqueeze(2)

            def library():
                y = library_tower(torch, F, lx, g, lp, lmasks)
                return torch.autograd.grad(y, lleaves, dyl)

            # timed as time_tower times #13/#14: the forward and the backward
            # calls themselves, without autograd's host work around them
            kp = params if not bf16 else [[w.to(torch.bfloat16) for w in params[0]]] + params[1:]
            _, _, _, saved = ct.tower_forward(x0, cfgs, *kp, masks, ext, plan)

            def forward():
                return ct.tower_forward(x0, cfgs, *kp, masks, ext, plan)

            def backward():
                return ct.fused_conv_tower_backward(saved, dy, plan)

            n = g["towers"]
            tot["ms"] += n * (time_ms(torch, forward) + time_ms(torch, backward))
            tot["device_ms"] += n * (device_ms_per_call(torch, forward)
                                     + device_ms_per_call(torch, backward))
            tot["plain_ms"] += n * time_ms(torch, plain)
            tot["library_ms"] += n * time_ms(torch, library)
            if bf16:
                f_fl, f_by, f_bnd, _, b_fl, b_by, b_bnd, _ = tower_bf16_work(g)
            else:
                f_fl, f_by, b_fl, b_by = tower_work(g)
                f_bnd, b_bnd = (bound(f_fl, f_by)[0], bound(b_fl, b_by)[0])
            tot["flops"] += n * (f_fl + b_fl)
            tot["bytes"] += n * (f_by + b_by)
            tot["bound_ms"] += n * (f_bnd + b_bnd)
            tot["err"] = max(tot["err"], err)
            tot["grad_err"] = max(tot["grad_err"], rel)
            del x0, params, masks, dy, xl, pl_, leaves, lx, lp, lleaves, got_a, want_a, saved
        tot["bound_by"] = ("operations" if tot["bound_ms"] > 1e3 * tot["bytes"] / HBM_BYTES_PER_S
                           else "bytes")
        out[dtype] = tot
        log(f"[dp-tower] {dtype}: the towers of one MOD DeepSense step on one of two data shards "
            f"(#13 + #14 through the DP form): {tot['ms']:.3f} ms (device "
            f"{tot['device_ms']:.3f}, plain {tot['plain_ms']:.3f}, cuDNN chain "
            f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.3f} {tot['bound_by']}), worst "
            f"error vs the plain DP form {tot['err']:.2e} (gradients {tot['grad_err']:.2e})")
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    return out


# ---------------------------------------------------------------------------
# phase 37: gradient accumulation (GradCache's replayed forwards, MultiSteps),
# host->device streaming and the sharded layout

ACCUM_DATASET = "MOD"     # the recipe of phase 37's SW_Transformer and DeepSense cases
ACCUM_K = 2               # micro-batches a GradCache update of phase 37
ACCUM_MICRO = 128         # samples a micro-batch of the replay checks (views fused to 256)
ACCUM_WIDE_MICRO = 16     # MOD_WIDE's
ACCUM_SAMPLES = 1024      # MOD synthetic train split of the entry points: 4 steps of 256
ACCUM_STREAM = ["-hbm_budget_gb", "1e-6", "-stream_block_steps", "3"]
# the replay cases: (dataset, None for ACCUM_DATASET; flags); each effective step's launches are
# its kernels' per forward (``accum_per_forward``) times 2 k forwards (pass
# 1 and pass 2) and k backwards
ACCUM_REPLAY = {
    "sw": (None, []), "sw_bf16": (None, ["-compute_dtype", "bfloat16"]),
    "sw_no_pallas_block": (None, ["-no_pallas_block"]), "sw_pallas_mlp": (None, ["-pallas_mlp"]),
    "ds_pallas_conv": (None, ["-model", "DeepSense", "-pallas_conv"]),
    "ds_pallas_conv_bf16": (None, ["-model", "DeepSense", "-pallas_conv", "-compute_dtype",
                                   "bfloat16"]),
    "sw_wide": ("MOD_WIDE", []),
}


def accum_per_forward(cfg, dataset, flags, micro):
    """({forward wrapper: launches a training forward}, {backward wrapper:
    launches a backward}) of a replay case at ``micro`` samples (views
    fused)."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    if "DeepSense" in flags:
        tl = tower_launches(tower_geometries(cfg, 2 * micro, dataset))
        sfx = "_bf16" if "bfloat16" in flags else ""
        return ({f"fused_conv_tower{sfx}": tl["fused_conv_tower"]},
                {f"fused_conv_tower_backward{sfx}": tl["fused_conv_tower_backward"]})
    geos = block_geometries(cfg, 2 * micro)
    mono = sum(g["per_forward"] for g in geos if pk.wblock_fits(g["N"], g["C"], g["heads"]))
    heads = sum(g["per_forward"] for g in geos) - mono
    if "-no_pallas_block" in flags:
        fwd, bwd = ({"fused_window_attention_dropout": mono + heads},
                    {"fused_window_attention_dropout_backward": mono + heads})
    elif "bfloat16" in flags:
        fwd, bwd = ({"fused_window_block_dropout_bf16": mono},
                    {"fused_window_block_backward_bf16": mono})
    else:
        fwd = {"fused_window_block_dropout": mono, "fused_window_block_perhead": heads}
        bwd = {"fused_window_block_backward": mono, "fused_window_block_perhead_backward": heads}
    if "-pallas_mlp" in flags:
        mlps = sum(g["per_forward"] for g in mlp_geometries(cfg, 2 * micro, dataset))
        fwd["fused_mlp_dropout_forward"], bwd["fused_mlp_backward"] = mlps, mlps
    return ({k: v for k, v in fwd.items() if v}, {k: v for k, v in bwd.items() if v})


def recorded_passes(torch, model):
    """(handle, {False: pass 1's outputs, True: pass 2's}): a forward hook
    on ``model`` that copies each {mod: features} output of a GradCache
    update, keyed by the grad mode it ran under (pass 1 without gradient,
    pass 2 with), in call order; ``handle.remove()`` ends it."""
    seen = {False: [], True: []}

    def hook(module, inputs, out):
        seen[torch.is_grad_enabled()].append({m: v.detach().clone() for m, v in out.items()})

    return model.register_forward_hook(hook), seen


def replayed_bitwise(torch, seen):
    """Pass 2 made as many forwards as pass 1, each bitwise its pass-1
    counterpart."""
    first, second = seen[False], seen[True]
    return len(first) == len(second) > 0 and all(
        a.keys() == b.keys() and all(torch.equal(a[m], b[m]) for m in a)
        for a, b in zip(first, second))


def accum_replay(torch, kernels, dev, case):
    """One GradCache update of ``case`` (ACCUM_REPLAY) at the recipe's drop
    rates through the kernels, from the seed-0 init: pass 2's features
    bitwise pass 1's (a forward hook, ``recorded_passes``), the launches exactly 2 k
    forwards' and k backwards', the loss finite; DeepSense's BatchNorm
    buffers bitwise those of pass 1's forwards chained on a copy of the
    model (pass 2 folds none)."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import TrainState, create_train_state
    from focal_tpu_torch.train.steps import (gather_batch, make_gathered_pretrain_step,
                                             pretrain_features, pretrain_views)

    dataset, flags = ACCUM_REPLAY[case]
    dataset = dataset or ACCUM_DATASET
    micro = ACCUM_WIDE_MICRO if dataset == "MOD_WIDE" else ACCUM_MICRO
    args = parse_train_params(["-dataset", dataset, "-batch_size", str(micro), "-grad_accum",
                               str(ACCUM_K)] + flags)
    cfg = args.dataset_config
    model = build_backbone(cfg, args.model, args.task, args.learn_framework,
                           pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                           pallas_block=not args.no_pallas_block, compute_dtype=args.compute_dtype)
    init_params(model, seed=0).to(dev)
    chained = copy.deepcopy(model) if args.model == "DeepSense" else None
    state = create_train_state(args, model, 100, seed=0, accum_in_step=True)
    host, _, _ = synthetic_arrays(cfg, args.task, ACCUM_K * micro, seed=0)
    data = to_device(host, dev)
    micro_batches = [(data, torch.arange(i * micro, (i + 1) * micro, device=dev))
                     for i in range(ACCUM_K)]
    augmenter = build_augmenter(args)
    step = make_gathered_pretrain_step(model, augmenter, make_focal_loss(args), ACCUM_K)
    fwd, bwd = accum_per_forward(cfg, dataset, flags, micro)
    want = {k.__name__: 2 * ACCUM_K * fwd.get(k.__name__, 0) + ACCUM_K * bwd.get(k.__name__, 0)
            for k in kernels}
    hook, seen = recorded_passes(torch, model)
    zero_counts(kernels)
    t0 = time.time()
    _, metrics = step(state, micro_batches)
    loss = float(metrics["loss"])
    seconds = time.time() - t0
    got = counts(kernels)
    hook.remove()
    check_counts(f"[accum-replay] {case}: one GradCache update", got, want)
    replayed = replayed_bitwise(torch, seen)
    if not replayed or not math.isfinite(loss):
        raise AssertionError(f"[accum-replay] {case}: pass 2's features differ from pass 1's "
                             f"({replayed}) or the loss is {loss}")
    stats_equal = None
    if chained is not None:
        ref = TrainState(chained, None, seed=0)
        with torch.no_grad():
            for i, (d, idx) in enumerate(micro_batches):
                rngs = ref.generators(i)
                pretrain_features(chained, rngs, *pretrain_views(augmenter, rngs,
                                                                 gather_batch(d, idx)))
        after = dict(model.named_buffers())
        stats_equal = all(torch.equal(after[n], b) for n, b in chained.named_buffers())
        if not stats_equal:
            raise AssertionError(f"[accum-replay] {case}: BatchNorm buffers are not pass 1's chain")
    res = {"dataset": dataset, "flags": flags, "micro": micro, "k": ACCUM_K, "loss": loss,
           "replayed_bitwise": True, "bn_stats_pass1_chain": stats_equal, "seconds": seconds,
           "launches": got, "per_forward": fwd, "per_backward": bwd}
    log(f"[accum-replay] {case} ({dataset} {' '.join(flags) or 'default'}, {ACCUM_K} x {micro}): "
        f"pass 2's features bitwise pass 1's; launches "
        f"{ {k: v for k, v in got.items() if v} } = 2 x {ACCUM_K} forwards x {fwd} + "
        f"{ACCUM_K} backwards x {bwd}; BatchNorm buffers pass 1's chain: {stats_equal}; "
        f"loss {loss:.4f}; {seconds:.2f}s")
    return res


def accum_exactness(torch, kernels, dev):
    """The rate-0 GradCache update of 2 x TRAIN_BATCH against one step over
    the whole 2 x TRAIN_BATCH batch, kernels on both sides (MOD
    SW_Transformer, seed-0 init, the augmenter pool ["no"]: each view the
    batch's FFT on both sides): loss within LOSS_TOL, gradients within
    GRAD_TOL relative (TINY_GRAD absolutely where tiny on both)."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_gathered_pretrain_step, make_pretrain_step

    out = {}
    for k, batch in ((ACCUM_K, TRAIN_BATCH), (1, ACCUM_K * TRAIN_BATCH)):
        args = parse_train_params(["-dataset", ACCUM_DATASET, "-batch_size", str(batch),
                                   "-grad_accum", str(k)])
        cfg = copy.deepcopy(args.dataset_config)
        sw = cfg["SW_Transformer"]
        sw["dropout_ratio"] = sw["drop_path_rate"] = sw["attn_drop_rate"] = 0.0
        cfg["FOCAL"]["random_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
        args.dataset_config = cfg
        model = init_params(build_backbone(cfg, args.model, args.task, args.learn_framework),
                            seed=0).to(dev)
        state = create_train_state(args, model, 100, seed=0, accum_in_step=k > 1)
        data = to_device(synthetic_arrays(cfg, args.task, ACCUM_K * TRAIN_BATCH, seed=0)[0], dev)
        focal_loss, augmenter = make_focal_loss(args), build_augmenter(args)
        zero_counts(kernels)
        if k > 1:
            step = make_gathered_pretrain_step(model, augmenter, focal_loss, k)
            _, m = step(state, [(data, torch.arange(i * batch, (i + 1) * batch, device=dev))
                                for i in range(k)])
        else:
            _, m = make_pretrain_step(model, augmenter, focal_loss)(
                state, data, torch.arange(batch, device=dev))
        out[k] = (float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()
                                     if p.grad is not None}, counts(kernels))
        del model, state, data
    (loss_k, grads_k, launches_k), (loss_1, grads_1, launches_1) = out[ACCUM_K], out[1]
    if set(grads_k) != set(grads_1):
        raise AssertionError("[accum-exact] the two steps give gradients to other parameters")
    worst, worst_name = 0.0, ""
    for n, want in grads_1.items():
        got = grads_k[n]
        if max(float(got.abs().max()), float(want.abs().max())) < TINY_GRAD:
            e = 0.0 if float((got - want).abs().max()) <= TINY_GRAD else math.inf
        else:
            e = rel_err(got, want)
        if e > worst:
            worst, worst_name = e, n
    loss_rel = abs(loss_k - loss_1) / abs(loss_1)
    per = sum(g["per_forward"] for g in block_geometries(
        parse_train_params(["-dataset", ACCUM_DATASET]).dataset_config, 1))
    check_counts("[accum-exact] GradCache update", launches_k,
                 {n: {"fused_window_block": 2 * ACCUM_K * per,
                      "fused_window_block_backward": ACCUM_K * per}.get(n, 0) for n in launches_k})
    check_counts("[accum-exact] full-batch step", launches_1,
                 {n: {"fused_window_block": per, "fused_window_block_backward": per}.get(n, 0)
                  for n in launches_1})
    res = {"loss_gradcache": loss_k, "loss_full_batch": loss_1, "loss_rel": loss_rel,
           "max_grad_rel": worst, "worst": worst_name, "launches_gradcache": launches_k,
           "launches_full_batch": launches_1}
    log(f"[accum-exact] rate-0 GradCache update of {ACCUM_K} x {TRAIN_BATCH} vs one step of "
        f"{ACCUM_K * TRAIN_BATCH}, kernels on both sides: loss {loss_k:.6f} vs {loss_1:.6f} "
        f"(rel {loss_rel:.2e}), max grad rel err {worst:.2e} ({worst_name})")
    if not (loss_rel <= LOSS_TOL and worst <= GRAD_TOL):
        raise AssertionError(f"[accum-exact] the GradCache update is off the full batch's: {res}")
    return res


def accum_entry_points(torch, kernels, dev):
    """python -m focal_tpu_torch.train at MOD -grad_accum 2 for an epoch of
    ACCUM_SAMPLES (4 micro-steps of TRAIN_BATCH, 2 GradCache updates),
    resident and then with the split streamed (ACCUM_STREAM: blocks of 3
    steps and 1, pinned on the host, copied on a side stream): the launches
    exact (#2 2 x 16 a micro-step, #3 16, #1 16 an eval forward) and the
    same in both, the streamed run's validation points and parameters
    bitwise the resident run's, every block from pinned memory."""
    import importlib

    from focal_tpu_torch import streaming
    from focal_tpu_torch.data import DeviceDataLoader, load_split
    from focal_tpu_torch.params import parse_train_params

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    base = ["-dataset", ACCUM_DATASET, "-synthetic", "-synthetic_samples", str(ACCUM_SAMPLES),
            "-batch_size", str(TRAIN_BATCH), "-epochs", "1", "-val_epochs", "1", "-grad_accum",
            str(ACCUM_K), "-device", dev.type]
    args = parse_train_params(base)
    per = sum(g["per_forward"] for g in block_geometries(args.dataset_config, 1))
    batches = {o: len(DeviceDataLoader(load_split(o, args), TRAIN_BATCH, sequence=True))
               for o in ("train", "val", "test")}
    evals = batches["train"] + 3 * (batches["val"] + batches["test"])
    micro_steps = batches["train"] // ACCUM_K * ACCUM_K
    want = {k.__name__: {"fused_window_block_dropout": 2 * per * micro_steps,
                         "fused_window_block_backward": per * micro_steps,
                         "fused_window_block": per * evals}.get(k.__name__, 0) for k in kernels}
    blocks = []
    start = streaming.BlockStream.start

    def spy(self, rows):
        blocks.append({"rows": int(len(rows)), "card": self.cuda,
                       "pinned": all(t.is_pinned() for t in self._tensors()),
                       "copy_stream": getattr(self, "copy_stream", None) is not None})
        return start(self, rows)

    runs = {}
    streaming.BlockStream.start = spy
    try:
        for name, extra in (("resident", []), ("streamed", ACCUM_STREAM)):
            out = os.path.join(HERE, "build", f"chip_smoke_accum_{name}")
            shutil.rmtree(out, ignore_errors=True)
            zero_counts(kernels)
            t0 = time.time()
            st, best, points = train_cli.main(base + extra + ["-output_dir", out])
            torch.cuda.synchronize()
            (latest,) = [os.path.join(r, f) for r, _, fs in os.walk(out) for f in fs
                         if f.endswith("_pretrain_latest.pt")]
            runs[name] = {"seconds": time.time() - t0, "launches": counts(kernels),
                          "points": points, "updates": st.step,
                          "latest": torch.load(latest, weights_only=True)}
            check_counts(f"[accum-entry] {name}", runs[name]["launches"], want)
    finally:
        streaming.BlockStream.start = start
    res, stre = runs["resident"], runs["streamed"]
    same_points = res["points"] == stre["points"]
    same_params = all(torch.equal(res["latest"][n], stre["latest"][n]) for n in res["latest"])
    # the train split's 4 steps and the KNN plan's 4 batches, in blocks of 3 and 1
    blocks_ok = ([b["rows"] for b in blocks] == [3 * TRAIN_BATCH, TRAIN_BATCH] * 2
                 and all(b["card"] and b["pinned"] and b["copy_stream"] for b in blocks))
    if dev.type != "cuda":  # a rehearsal on the CPU: blocks are host gathers
        blocks_ok = [b["rows"] for b in blocks] == [3 * TRAIN_BATCH, TRAIN_BATCH] * 2
    summary = {name: {k: v for k, v in r.items() if k != "latest"} for name, r in runs.items()}
    summary.update(same_points=same_points, same_params=same_params, blocks=blocks,
                   per_forward=per, evals=evals, micro_steps=micro_steps)
    log(f"[accum-entry] {ACCUM_DATASET} -grad_accum {ACCUM_K}, {ACCUM_SAMPLES} samples: resident "
        f"{res['seconds']:.1f}s, streamed {stre['seconds']:.1f}s ({len(blocks)} blocks "
        f"{[b['rows'] for b in blocks]}, pinned, side stream); {res['updates']} updates; launches "
        f"{ {k: v for k, v in res['launches'].items() if v} } in both; train loss "
        f"{res['points'][0]['train_loss']!r} resident, {stre['points'][0]['train_loss']!r} "
        f"streamed; validation points equal: {same_points}, parameters bitwise: {same_params}")
    if not (same_points and same_params and blocks_ok and res["updates"] == micro_steps // ACCUM_K):
        raise AssertionError(f"[accum-entry] the streamed run differs from the resident one or "
                             f"streamed otherwise: {summary}")
    return summary


def accumulation_paths(torch, np, kernels, dev):
    """Phase 37: GradCache's replay through every training kernel (ACCUM_REPLAY),
    the rate-0 update against the full batch, and the -grad_accum entry
    point resident and streamed."""
    t0 = time.time()
    out = {"replay": {}}
    for case in ACCUM_REPLAY:
        out["replay"][case] = accum_replay(torch, kernels, dev, case)
        torch.cuda.empty_cache()
    out["exact"] = accum_exactness(torch, kernels, dev)
    torch.cuda.empty_cache()
    out["entry"] = accum_entry_points(torch, kernels, dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    return out


# ---------------------------------------------------------------------------
# sample files (38): MOD's offline preprocessing, the bulk loader, and the
# training entry point fed from index files

FILES_DATASET = "MOD"
FILES_SAMPLES = 2048      # sample files at MOD's shapes the loader reads (~133 MB)
FILES_EPOCHS = 3
FILES_SEED = 7
# raw recordings of tests/test_preprocess.py's layout: (run folder, sensor,
# seconds); both folders on the reference's allowlist, untrimmed
FILES_RAW = (("Polaris0150pm", "rs1", 5), ("Warhog1135am", "rs1", 5))
FILES_LABELS = {"Polaris0150pm": 0, "Warhog1135am": 1}


def files_preprocess(np, task, root):
    """python -m focal_tpu_torch.preprocess.mod and .partition, each once, on
    FILES_RAW's CSVs: every complete 2 s segment a sample file of MOD's
    shapes with its recording's label, the index files listing each once
    (train and val/test apart, pretrain the train split)."""
    from focal_tpu_torch.data import Split
    from focal_tpu_torch.params import load_dataset_config

    cfg = load_dataset_config("MOD")

    raw, samples, index = (os.path.join(root, d) for d in ("raw", "samples", "index"))
    for i, (run, shake, seconds) in enumerate(FILES_RAW):
        rng = np.random.default_rng(i)
        d = os.path.join(raw, run, shake)
        os.makedirs(d)
        np.savetxt(os.path.join(d, "aud16000.csv"), rng.normal(size=16000 * seconds), delimiter=",")
        np.savetxt(os.path.join(d, "ehz.csv"), rng.normal(size=100 * seconds), delimiter=",")
    t0 = time.time()
    for argv in (["focal_tpu_torch.preprocess.mod", "--input", raw, "--output", samples],
                 ["focal_tpu_torch.preprocess.partition", "--samples", samples, "--output", index]):
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=HERE, capture_output=True,
                              text=True, timeout=300)
        if proc.returncode:
            raise AssertionError(f"python -m {argv[0]} failed:\n{proc.stdout}{proc.stderr}")
    seconds = time.time() - t0
    files = sorted(os.path.join(samples, f) for f in os.listdir(samples))
    listed = {s: open(os.path.join(index, f"{s}_index.txt")).read().split()
              for s in ("train", "val", "test", "pretrain")}
    want = sorted(os.path.join(samples, f"{run}_{shake}_{i}.npz") for run, shake, s in FILES_RAW
                  for i in range(s // 2))
    split = Split.from_index_file(os.path.join(index, "pretrain_index.txt"), task)
    shapes = {m: a.shape[1:] for m, a in split.data["shake"].items()}
    want_shapes = {m: (cfg["loc_mod_in_time_channels"]["shake"][m], cfg["num_segments"],
                       cfg["loc_mod_spectrum_len"]["shake"][m])
                   for m in cfg["loc_modalities"]["shake"]}
    labels_ok = all(label == FILES_LABELS[name.split("_rs")[0]]
                    for name, label in zip(split.names, split.labels))
    out = {"seconds": seconds, "samples": len(files), "index": {k: len(v) for k, v in listed.items()},
           "shapes": {m: list(s) for m, s in shapes.items()}}
    log(f"[files-preprocess] {len(FILES_RAW)} raw recordings -> {len(files)} sample files, "
        f"index files {out['index']} in {seconds:.1f}s (two python -m runs); sample shapes {shapes}")
    if not (files == want and sorted(listed["train"] + listed["val"]) == want
            and listed["val"] == listed["test"] and listed["pretrain"] == listed["train"]
            and shapes == want_shapes and labels_ok):
        raise AssertionError(f"[files-preprocess] the samples or index files are not as expected: "
                             f"{files} {listed} {shapes} != {want_shapes}, labels {split.labels}")
    return out


def files_loader(np, cfg, task, root, build):
    """FILES_SAMPLES sample files at MOD's shapes (write_synthetic_sample_files)
    read through the bulk loader (``build``: its g++ build, files_paths')
    and one by one: the same bits; each rate in MB/s of the arrays (the
    files just written: a warm read)."""
    from focal_tpu_torch.data import _bulk_load, _load_sample_file, write_synthetic_sample_files

    t0 = time.time()
    index = write_synthetic_sample_files(cfg, task, os.path.join(root, "samples"), FILES_SAMPLES,
                                         seed=FILES_SEED)
    write_s = time.time() - t0
    paths = [p for s in ("train", "val", "test") for p in open(index[s]).read().split()]
    t0 = time.time()
    samples = [_load_sample_file(p, task) for p in paths]
    data = {loc: {m: np.stack([d[loc][m] for d, _ in samples]) for m in mods}
            for loc, mods in samples[0][0].items()}
    labels = np.asarray([label for _, label in samples], np.int32)
    file_s = time.time() - t0
    bulk_s = []
    for _ in range(2):
        t0 = time.time()
        bulk, bulk_labels = _bulk_load(paths, task)
        bulk_s.append(time.time() - t0)
    same = (np.array_equal(bulk_labels, labels) and bulk.keys() == data.keys() and all(
        bulk[loc].keys() == data[loc].keys() and all(
            bulk[loc][m].dtype == data[loc][m].dtype and np.array_equal(bulk[loc][m], data[loc][m])
            for m in data[loc]) for loc in data))
    mb = sum(a.nbytes for mods in data.values() for a in mods.values()) / 1e6
    out = {"samples": len(paths), "mb": mb, "write_s": write_s, **build, "file_s": file_s,
           "bulk_s": bulk_s,
           "file_mb_per_s": mb / file_s, "bulk_mb_per_s": [mb / s for s in bulk_s],
           "bitwise": same, "index": index}
    log(f"[files-loader] {len(paths)} MOD sample files ({mb:.1f} MB of arrays) written in "
        f"{write_s:.1f}s; loader {build['how']} ({build['library']}); one file at a "
        f"time {file_s:.3f}s = {mb / file_s:.1f} MB/s, bulk loader {bulk_s[0]:.3f}s = "
        f"{mb / bulk_s[0]:.1f} MB/s (again {bulk_s[1]:.3f}s = {mb / bulk_s[1]:.1f} MB/s), warm "
        f"page cache; the same bits: {same}")
    if not same:
        raise AssertionError("[files-loader] the bulk loader's arrays differ from the per-file read")
    return out


def trace_window_block_kernels(path):
    """{kernel: launches} of window_block.cu's kernels among a Chrome
    trace's device kernels, and the count of all its device kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e["name"] for e in events if e.get("cat") == "kernel"]
    got = {}
    for name in device:
        if owned_by(WB_LIB, name):
            got[kernel_name(name)] = got.get(kernel_name(name), 0) + 1
    return got, len(device)


def files_entry_point(torch, np, kernels, dev, cfg, task, index, root):
    """python -m focal_tpu_torch.train -dataset MOD -dataset_config <a
    recipe copy naming ``index``> -gpu 0 -knn_backend jnp -profile_dir, in
    process, FILES_EPOCHS epochs validated after each, at TRAIN_BATCH; then
    the same flags on a synthetic split of the train split's size resident
    on the card. Held in the file-fed run: finite validation points, the
    launches of the whole run exact (#2/#3 16 a step, #1 16 an eval
    forward), one trace, of epoch 1, its window_block.cu kernels one
    epoch's #2/#3 (their kernels times 16 a step) and no other. Timed:
    wall, the steps by CUDA events (p50 over the untraced epochs), the
    three split loads."""
    import importlib

    import yaml

    from focal_tpu_torch.data import DeviceDataLoader
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train import loops

    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    recipe = copy.deepcopy(cfg)
    recipe["pretrain_index_file"] = index["pretrain"]
    for s in ("train", "val", "test"):
        recipe[task][f"{s}_index_file"] = index[s]
    recipe_path = os.path.join(root, f"{FILES_DATASET}_files.yaml")
    with open(recipe_path, "w") as f:
        yaml.safe_dump(recipe, f)
    base = ["-dataset", FILES_DATASET, "-model", "SW_Transformer", "-learn_framework", "FOCAL",
            "-stage", "pretrain", "-knn_backend", "jnp", "-epochs", str(FILES_EPOCHS),
            "-val_epochs", "1", "-batch_size", str(TRAIN_BATCH)]
    base += ["-gpu", "0"] if dev.type == "cuda" else ["-device", "cpu"]
    file_argv = base + ["-dataset_config", recipe_path]
    args = parse_train_params(file_argv)
    splits = {o: loops.load_split(o, args) for o in ("train", "val", "test")}
    batches = {o: len(DeviceDataLoader(s, TRAIN_BATCH, sequence=True)) for o, s in splits.items()}
    steps = len(DeviceDataLoader(splits["train"], TRAIN_BATCH, drop_last=True, sequence=True))
    evals = batches["train"] + 3 * (batches["val"] + batches["test"])
    per = sum(g["per_forward"] for g in block_geometries(args.dataset_config, 1))
    names = {k.__name__ for k in kernels}
    want = {n: {"fused_window_block_dropout": per * steps * FILES_EPOCHS,
                "fused_window_block_backward": per * steps * FILES_EPOCHS,
                "fused_window_block": per * evals * FILES_EPOCHS}.get(n, 0) for n in names}
    trace_want = {k: per * steps * (WB_LAUNCHES["fwd"].get(k, 0) + WB_LAUNCHES["bwd"].get(k, 0))
                  for k in set(WB_LAUNCHES["fwd"]) | set(WB_LAUNCHES["bwd"])}

    make_step, load = loops.make_pretrain_step, loops.load_split
    marks, loads = [], []

    def timed_make(*a, **kw):
        step = make_step(*a, **kw)

        def timed(*sa, **skw):
            if dev.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*sa, **skw)
                end.record()
            else:
                start = time.perf_counter()
                out = step(*sa, **skw)
                end = time.perf_counter()
            marks.append((start, end))
            return out

        return timed

    def timed_load(*a, **kw):
        t0 = time.time()
        out = load(*a, **kw)
        loads.append(time.time() - t0)
        return out

    runs = {}
    loops.make_pretrain_step, loops.load_split = timed_make, timed_load
    try:
        for name, argv in (("files", file_argv), ("synthetic", base + [
                "-synthetic", "-synthetic_samples", str(len(splits["train"]))])):
            out_dir, trace_dir = os.path.join(root, f"run_{name}"), os.path.join(root, f"trace_{name}")
            marks.clear()
            loads.clear()
            zero_counts(kernels)
            t0 = time.time()
            st, _, points = train_cli.main(argv + ["-output_dir", out_dir, "-profile_dir", trace_dir])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.time() - t0
            got = counts(kernels)
            ms = [s.elapsed_time(e) if dev.type == "cuda" else (e - s) * 1e3 for s, e in marks]
            untraced = [m for i, m in enumerate(ms) if i // steps != 1]
            traces = sorted(os.listdir(trace_dir))
            runs[name] = {"seconds": wall, "steps": st.step, "step_ms": ms,
                          "p50_ms": statistics.median(untraced), "load_s": list(loads),
                          "launches": got, "points": points, "traces": traces}
            if name == "files":
                check_counts("[files-entry] the file-fed entry point", got, want)
                if [p["epoch"] for p in points] != list(range(FILES_EPOCHS)) or not all(
                        math.isfinite(p[k]) for p in points
                        for k in ("train_loss", "val_loss", "test_loss")):
                    raise AssertionError(f"[files-entry] validation points {points}")
                if traces != ["pretrain_epoch1.pt.trace.json"] or st.step != steps * FILES_EPOCHS:
                    raise AssertionError(f"[files-entry] traces {traces}, steps {st.step}")
                trace_got, n_device = trace_window_block_kernels(os.path.join(trace_dir, traces[0]))
                runs[name].update(trace_kernels=trace_got, trace_device_kernels=n_device)
                if dev.type == "cuda" and trace_got != trace_want:
                    raise AssertionError(f"[files-entry] the trace's window_block.cu kernels "
                                         f"{trace_got} != one epoch's #2/#3 {trace_want}")
            shutil.rmtree(out_dir, ignore_errors=True)
            shutil.rmtree(trace_dir, ignore_errors=True)
    finally:
        loops.make_pretrain_step, loops.load_split = make_step, load
    f, s = runs["files"], runs["synthetic"]
    log(f"[files-entry] {FILES_DATASET} from index files ({len(splits['train'])} train, "
        f"{len(splits['val'])} val, {len(splits['test'])} test samples), -gpu 0 -knn_backend jnp "
        f"-profile_dir, {FILES_EPOCHS} epochs of {steps} steps at batch {TRAIN_BATCH}: launches "
        f"{ {k: v for k, v in f['launches'].items() if v} } (exact); trace of epoch 1: "
        f"{f['trace_device_kernels']} device kernels, window_block.cu's {f['trace_kernels']} "
        f"= {per} x {steps} steps of #2/#3; points " + "; ".join(
            f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} test "
            f"{p['test_loss']:.4f}" for p in f["points"]))
    log(f"[files-entry] wall {f['seconds']:.2f}s (split loads {sum(f['load_s']):.2f}s), step p50 "
        f"{f['p50_ms']:.3f} ms from files; wall {s['seconds']:.2f}s (split loads "
        f"{sum(s['load_s']):.2f}s), step p50 {s['p50_ms']:.3f} ms synthetic-resident (the same "
        f"flags, -synthetic -synthetic_samples {len(splits['train'])}: val and test "
        f"{len(splits['train']) // 4} each)")
    return {"recipe": os.path.relpath(recipe_path, HERE), "per_forward": per, "steps": steps,
            "evals": evals, "runs": {n: {k: v for k, v in r.items() if k != "step_ms"}
                                     for n, r in runs.items()}}


def files_paths(torch, np, kernels, dev):
    """Phase 38: the preprocessing CLIs on raw CSVs, the bulk loader against
    the per-file read, the entry point fed from index files, traced."""
    from focal_tpu_torch.params import load_dataset_config

    from focal_tpu_torch import native

    t0 = time.time()
    root = os.path.join(HERE, "build", "chip_smoke_files")
    shutil.rmtree(root, ignore_errors=True)
    cfg, task = load_dataset_config(FILES_DATASET), "vehicle_classification"
    t_build, fresh = time.time(), not os.path.isfile(native.library_path())
    lib = native.build()  # g++ on this host, into build/ (a checkout has none built)
    build_s = time.time() - t_build
    build = {"library": os.path.relpath(lib, HERE), "build_s": build_s,
             "how": f"built with g++ in {build_s:.2f}s" if fresh else "already built"}
    out = {"preprocess": files_preprocess(np, task, os.path.join(root, "pre")),
           "loader": files_loader(np, cfg, task, root, build)}
    out["entry"] = files_entry_point(torch, np, kernels, dev, cfg, task, out["loader"].pop("index"),
                                     root)
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t0
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the per-geometry JSON")
    cli = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "focal_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository (no focal_tpu_torch/ beside it)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls (the default, stated)
    torch.backends.cudnn.allow_tf32 = False

    import importlib

    from focal_tpu_torch.data import DeviceDataLoader, load_split, synthetic_arrays
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import _build
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml, parse_train_params
    from focal_tpu_torch.serve import Predictor

    fwd, fwd_drop, bwd = pk.fused_window_block, pk.fused_window_block_dropout, pk.fused_window_block_backward
    ph_fwd, ph_bwd = pk.fused_window_block_perhead, pk.fused_window_block_perhead_backward
    ct_fwd, ct_bwd = ct.fused_conv_tower, ct.fused_conv_tower_backward
    mlp_fwd, mlp_drop, mlp_bwd = fm.fused_mlp_forward, fm.fused_mlp_dropout_forward, fm.fused_mlp_backward
    at_fwd, at_drop = pk.fused_window_attention, pk.fused_window_attention_dropout
    at_bwd, at_drop_bwd = pk.fused_window_attention_backward, pk.fused_window_attention_dropout_backward
    bf_fwd, bf_drop, bf_bwd = (pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
                               pk.fused_window_block_backward_bf16)
    ct_bf_fwd, ct_bf_bwd = ct.fused_conv_tower_bf16, ct.fused_conv_tower_backward_bf16
    ph_bf_fwd, ph_bf_bwd = pk.fused_window_block_perhead_bf16, pk.fused_window_block_perhead_backward_bf16
    mlp_bf_fwd, mlp_bf_drop, mlp_bf_bwd = (fm.fused_mlp_forward_bf16, fm.fused_mlp_dropout_forward_bf16,
                                           fm.fused_mlp_backward_bf16)
    at_bf_fwd, at_bf_drop, at_bf_bwd, at_bf_drop_bwd = (
        pk.fused_window_attention_bf16, pk.fused_window_attention_dropout_bf16,
        pk.fused_window_attention_backward_bf16, pk.fused_window_attention_dropout_backward_bf16)
    all_kernels = (fwd, fwd_drop, bwd, ph_fwd, ph_bwd, ct_fwd, ct_bwd, mlp_fwd, mlp_drop, mlp_bwd,
                   at_fwd, at_drop, at_bwd, at_drop_bwd, bf_fwd, bf_drop, bf_bwd, ct_bf_fwd,
                   ct_bf_bwd, ph_bf_fwd, ph_bf_bwd, mlp_bf_fwd, mlp_bf_drop, mlp_bf_bwd, at_bf_fwd,
                   at_bf_drop, at_bf_bwd, at_bf_drop_bwd)
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.time()

    # ---- 1. build: one nvcc per source
    t0 = time.time()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in {time.time() - t0:.1f}s")
    for src in _build.SOURCES:
        with open(_build.log_path(src)) as f:
            for line in f.read().splitlines():
                if "Compiling entry function" in line:
                    log(f"[build] {src}: {kernel_of(line)}")
                elif "registers" in line or "smem" in line or "spill" in line:
                    log(f"[build] {src}: {line.strip()}")

    # ---- 2. #1 vs plain at every block geometry of the MOD forward
    cfg = load_yaml(os.path.join(HERE, "focal_tpu_torch", "configs", "MOD.yaml"))  # full width
    task = "vehicle_classification"
    geos = block_geometries(cfg, SERVE_BATCH)
    gen = torch.Generator().manual_seed(0)
    max_err = check_block_forward(torch, pk, geos, gen, dev)

    # ---- 3. the serving path: full-width MOD SW_Transformer served by the Predictor
    data, labels, names = synthetic_arrays(cfg, task, SERVE_SAMPLES, seed=3)
    n = len(names)
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0)
    n_params = sum(p.numel() for p in predictor.model.parameters())
    log(f"[slice] MOD SW_Transformer, {n_params} parameters, warm-up {predictor.compile_seconds:.2f}s")
    zero_counts(all_kernels)
    result = predictor.predict(data)
    serve_launches = counts(all_kernels)
    per_fwd = sum(g["per_forward"] for g in geos)  # 16 Swin blocks in the MOD forward
    batches = result["latency"]["batches"]
    check_counts("serving", serve_launches, {**{k.__name__: 0 for k in all_kernels},
                                             fwd.__name__: per_fwd * batches})
    launches = serve_launches[fwd.__name__]
    probs = result["probs"]
    if probs.shape != (n, cfg[task]["num_classes"]) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if sum_err > 1e-5:
        raise AssertionError(f"probabilities do not sum to 1 (max error {sum_err})")
    log(f"[slice] {n} samples in {batches} batches of {SERVE_BATCH}: "
        f"kernel launches {launches} ({per_fwd} per batch)")

    first = {loc: {m: a[:SERVE_BATCH] for m, a in mods.items()} for loc, mods in data.items()}
    swin_mod.window_block_forward = pk.fused_window_block_reference  # the plain block, same model
    try:
        plain_probs = predictor._forward(first)
    finally:
        swin_mod.window_block_forward = pk.window_block_forward
    slice_err = float(np.abs(plain_probs - probs[:SERVE_BATCH]).max())
    log(f"[slice] first batch, kernel vs plain block: max|dprobs| {slice_err:.3e}")
    if not slice_err <= SLICE_TOL:
        raise AssertionError(f"served probs differ from the plain model by {slice_err}")
    lat = result["latency"]
    log(f"[slice] p50 batch {lat['p50_s'] * 1e3:.3f} ms, mean {lat['mean_s'] * 1e3:.3f} ms, "
        f"{lat['windows_per_s']:.1f} windows/s")

    # ---- 4. #1 timing per geometry
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "flops": 0, "bytes": 0}
    for g in geos:
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = make_inputs(torch, g, gen, dev)
        attn_mask = library_mask(torch, g, rel_bias, mask)
        args = (x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
        g["ms"] = time_ms_long(torch, lambda: fwd(*args))
        g["device_ms"] = device_ms_per_call(torch, lambda: fwd(*args))
        g["plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_reference(*args))
        g["library_ms"] = time_ms(
            torch, lambda: library_block(torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"]))
        g["flops"], g["bytes"], g["bound_ms"], g["bound_by"] = work(g)
        log(f"[time] {g['name']}: kernel {g['ms']:.4f} ms (device {g['device_ms']:.4f}), plain "
            f"{g['plain_ms']:.4f} ms, "
            f"library {g['library_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms ({g['bound_by']}), "
            f"{g['flops'] / g['ms'] / 1e9:.2f} TFLOP/s")
        for k in tot:
            tot[k] += g["per_forward"] * g[k]
    log(f"[time] one forward at batch {SERVE_BATCH} (16 launches): kernel {tot['ms']:.4f} ms "
        f"(device {tot['device_ms']:.4f}), "
        f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms; kernel share of p50 batch "
        f"{tot['ms'] / (lat['p50_s'] * 1e3):.3f}")

    # ---- 5. where one served batch's time goes on the device; #1 runs
    # window_block.cu's row-tiled forward at rate 0 (its products and the
    # attention without dropout) and no other kernel of that library
    predictor._forward(first)
    serve_profile = profile_device(torch, lambda: predictor._forward(first))
    log_profile("profile", "one served batch", serve_profile)
    serve_block_ms = block_device_ms(serve_profile)
    strays = [r["name"] for r in serve_profile["rows"]
              if kernel_name(r["name"]) in source_kernels(WB_LIB["source"], *SHARED)
              and not (kernel_name(r["name"]) == "proj_gemm_kernel"
                       or re.search(r"\battn_fwd_kernel<false>", r["name"]))]
    log(f"[profile] #1 in the served batch, device ms by phase: {serve_block_ms}")
    if strays or set(serve_block_ms) != {"GEMM", "attention"}:
        raise AssertionError(f"#1 ran other window_block.cu kernels than its row-tiled forward: "
                             f"{strays}, phases {serve_block_ms}")
    del predictor

    # ---- 6. #2 and #3 vs plain at every block geometry of the training batch
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    tgeos = block_geometries(cfg, 2 * TRAIN_BATCH)
    drop_err, grad_err, grad_abs = check_block_training(torch, pk, tgeos, gen, dev, rate)

    # ---- 7. the training path: FOCAL pretrain steps at full width
    targs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                "-learn_framework", "FOCAL", "-stage", "pretrain",
                                "-batch_size", str(TRAIN_BATCH)])
    train, (state, step, tdata, idx) = run_train_steps(
        torch, np, targs, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, all_kernels,
        {fwd_drop.__name__: per_fwd, bwd.__name__: per_fwd}, dev, "train")
    train_launches = train["launches"]
    p50_ms = train["p50_ms"]

    # ---- 8. #2 and #3 timing per training geometry, and profiled by phase
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for g in tgeos:
        time_training(torch, pk, fwd_drop, bwd, ("#2", "#3"), g, gen, dev, rate, sms, "time-train")
    ttot = step_totals(tgeos, "time-train", ("#2", "#3"), per_fwd)
    log(f"[time-train] share of the p50 step {(ttot['fwd_ms'] + ttot['bwd_ms']) / p50_ms:.3f}")
    train_split = profile_split(torch, fwd_drop, bwd, ("#2", "#3"), tgeos, gen, dev, rate,
                                "profile-train-kernels")
    torch.cuda.empty_cache()

    # ---- 9. where one training step's time goes on the device
    train_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-train", "one training step", train_profile, top=15)
    train["idle_share"] = 1 - train_profile["device_busy_ms"] / train_profile["wall_ms"]
    train["block_device_ms"] = block_device_ms(train_profile)
    beside_parent("train", "MOD", train)
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 10. #4 and #5 vs plain at every per-head geometry of MOD_WIDE
    wcfg = load_yaml(os.path.join(HERE, "focal_tpu_torch", "configs", "MOD_WIDE.yaml"))
    wrate = float(wcfg["SW_Transformer"]["attn_drop_rate"])
    wgeos = block_geometries(wcfg, 2 * WIDE_BATCH)
    mono = [g for g in wgeos if pk.wblock_fits(g["N"], g["C"], g["heads"])]
    pgeos = [g for g in wgeos if not pk.wblock_fits(g["N"], g["C"], g["heads"])]
    wide_per_step = {
        fwd_drop.__name__: sum(g["per_forward"] for g in mono),
        bwd.__name__: sum(g["per_forward"] for g in mono),
        ph_fwd.__name__: sum(g["per_forward"] for g in pgeos),
        ph_bwd.__name__: sum(g["per_forward"] for g in pgeos),
    }
    wide_per_eval = {fwd.__name__: sum(g["per_forward"] for g in mono),
                     ph_fwd.__name__: sum(g["per_forward"] for g in pgeos)}
    log(f"[check-wide] MOD_WIDE: {len(mono)} monolithic geometries (C "
        f"{sorted({g['C'] for g in mono})}), {len(pgeos)} per-head (C "
        f"{sorted({g['C'] for g in pgeos})}); per step {wide_per_step}")
    ph_err = ph_drop_err = ph_grad_err = ph_grad_abs = 0.0
    for gi, g in enumerate(pgeos):
        args = make_inputs(torch, g, gen, dev)
        y0, none = ph_fwd(*args)
        y, keep = ph_fwd(*args, 2000 + gi, wrate)
        torch.cuda.synchronize()
        if none is not None:
            raise AssertionError("#4 at rate 0 returned a keep mask")
        err0 = float((y0 - pk.fused_window_block_reference(*args)).abs().max())
        err = float((y - pk.fused_window_block_reference(*args, keep, wrate)).abs().max())
        kept = float(keep.double().mean())
        sigma = math.sqrt(wrate * (1 - wrate) / keep.numel())
        same_mask = bool(torch.equal(fwd_drop(*args, 2000 + gi, wrate)[1], keep))
        dy = torch.randn(y.shape, generator=gen).to(dev)
        tr = transposed(args)
        errs = {}
        for tag, kp in (("keep", keep), ("nomask", None)):
            got = ph_bwd(*args, dy, kp, wrate, *tr)
            again = ph_bwd(*args, dy, kp, wrate, *tr)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{g['name']}: #5 gives other bits on a second call ({tag})")
            want = pk.fused_window_block_backward_reference(*args, dy, kp, wrate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            ph_grad_abs = max(ph_grad_abs, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        g.update(max_abs_err_rate0=err0, max_abs_err_fwd=err, keep_rate=kept, keep_sigma=sigma,
                 mask_equals_2=same_mask, max_rel_err_bwd=errs["keep"],
                 max_rel_err_bwd_nomask=errs["nomask"])
        ph_err, ph_drop_err = max(ph_err, err0), max(ph_drop_err, err)
        ph_grad_err = max(ph_grad_err, *errs.values())
        log(f"[check-wide] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: #4 "
            f"max|kernel-plain| {err0:.3e} (rate 0), {err:.3e} (dropout), keep rate {kept:.5f} "
            f"({(kept - 1 + wrate) / sigma:+.2f} sigma), mask == #2's: {same_mask}; #5 max rel err "
            f"{errs['keep']:.3e} (mask), {errs['nomask']:.3e} (no mask), repeatable")
        if not max(err0, err) <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #4 differs from plain by {err0}, {err}")
        if not abs(kept - (1 - wrate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {wrate} within 5 sigma")
        if not same_mask:
            raise AssertionError(f"{g['name']}: #4's keep mask differs from #2's")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #5 gradients differ from plain by {errs}")
        del args, y0, y, keep, dy, tr
    torch.cuda.empty_cache()

    # ---- 11. the training entry point at MOD_WIDE, then -resume
    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    run_dir = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["-dataset", "MOD_WIDE", "-model", "SW_Transformer", "-learn_framework", "FOCAL",
            "-stage", "pretrain", "-synthetic", "-synthetic_samples", str(WIDE_SAMPLES),
            "-batch_size", str(WIDE_BATCH), "-val_epochs", "1", "-output_dir", run_dir]
    wargs = parse_train_params(argv)
    plan_batches = {o: len(DeviceDataLoader(load_split(o, wargs), WIDE_BATCH, sequence=True))
                    for o in ("train", "val", "test")}
    # a validation point: train features for the probe; per split, two views
    # for the loss and the features
    evals_per_point = plan_batches["train"] + 3 * (plan_batches["val"] + plan_batches["test"])
    cli_runs = []
    for extra, points_want in ((["-epochs", "1"], [0]), (["-epochs", "2", "-resume"], [1])):
        zero_counts(all_kernels)
        t0 = time.time()
        st, best, points = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts(all_kernels)
        n_steps = st.step - (cli_runs[-1]["step"] if cli_runs else 0)
        n_evals = len(points) * evals_per_point
        want = {k.__name__: wide_per_step.get(k.__name__, 0) * n_steps
                + wide_per_eval.get(k.__name__, 0) * n_evals for k in all_kernels}
        if [p["epoch"] for p in points] != points_want:
            raise AssertionError(f"validation points {[p['epoch'] for p in points]} != {points_want}")
        for p in points:
            if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
                raise AssertionError(f"non-finite loss at a validation point: {p}")
        check_counts(f"train CLI {' '.join(extra)}", got, want)
        folder = os.path.join(run_dir, "weights", "MOD_WIDE_SW_Transformer")
        (exp,) = [d for d in os.listdir(folder) if d.startswith("exp")]
        for kind in ("latest", "best", "resume"):
            path = os.path.join(folder, exp, f"MOD_WIDE_SW_Transformer_pretrain_{kind}.pt")
            if not os.path.isfile(path):
                raise AssertionError(f"missing checkpoint {path}")
        cli_runs.append({"argv": extra, "seconds": secs, "step": st.step, "steps": n_steps,
                         "eval_forwards": n_evals, "launches": got, "points": points,
                         "best": best})
        log(f"[train-cli] MOD_WIDE {' '.join(extra)}: {n_steps} steps, {n_evals} eval forwards "
            f"in {secs:.1f}s; launches {got}; points " + "; ".join(
                f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} "
                f"test {p['test_loss']:.4f} val acc {p['val_acc']:.3f}" for p in points))
        del st
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 12. MOD_WIDE pretrain steps timed, the rate-0 step, one profiled step
    wtargs = parse_train_params(["-dataset", "MOD_WIDE", "-model", "SW_Transformer",
                                 "-learn_framework", "FOCAL", "-stage", "pretrain",
                                 "-batch_size", str(WIDE_BATCH)])
    wide, (state, step, tdata, idx) = run_train_steps(
        torch, np, wtargs, WIDE_BATCH, TRAIN_WARMUP, WIDE_STEPS, all_kernels, wide_per_step, dev,
        "train-wide", rate0_from="initial+trained")
    wide_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-wide", "one MOD_WIDE training step", wide_profile, top=15)
    wide["idle_share"] = 1 - wide_profile["device_busy_ms"] / wide_profile["wall_ms"]
    wide["block_device_ms"] = block_device_ms(wide_profile)
    beside_parent("train-wide", "MOD_WIDE", wide)
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 13. #4 and #5 timing per geometry (#4 at rate 0 too, #1 beside it
    # at C = 512), #2 and #3 at MOD_WIDE stage 0, each profiled by phase
    for g in pgeos:
        time_training(torch, pk, ph_fwd, ph_bwd, ("#4", "#5"), g, gen, dev, wrate, sms, "time-wide")
        args = make_inputs(torch, g, gen, dev)
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
        attn_mask = library_mask(torch, g, rel_bias, mask)
        g["eval_ms"] = time_ms(torch, lambda: ph_fwd(*args))
        g["eval_plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_reference(*args))
        g["eval_library_ms"] = time_ms(torch, lambda: library_block(
            torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"]))
        f0, b0, g["eval_bound_ms"], _ = work(g)
        g["eval_bound_tc_ms"] = tc_bound(f0, b0)
        note = ""
        if g["C"] == 512:  # #1 takes this width too: the same row-tiled code at rate 0
            g["mono_eval_ms"] = time_ms(torch, lambda: fwd(*args))
            note = f"; beside it #1 {g['mono_eval_ms']:.4f} ms"
        log(f"[time-wide] {g['name']}: #4 at rate 0 (eval) {g['eval_ms']:.4f} ms (plain "
            f"{g['eval_plain_ms']:.4f}, library {g['eval_library_ms']:.4f}, bound f32 "
            f"{g['eval_bound_ms']:.4f}, TF32x3 {g['eval_bound_tc_ms']:.4f}, "
            f"{f0 / g['eval_ms'] / 1e9:.2f} TFLOP/s){note}")
        del args, x, wqkv, attn_mask
    n_ph = wide_per_step[ph_fwd.__name__]
    wtot = step_totals(pgeos, "time-wide", ("#4", "#5"), n_ph)
    wtot.update({k: sum(g["per_forward"] * g[k] for g in pgeos) for k in (
        "eval_ms", "eval_plain_ms", "eval_library_ms", "eval_bound_ms", "eval_bound_tc_ms")})
    log(f"[time-wide] #4/#5 share of the p50 step {(wtot['fwd_ms'] + wtot['bwd_ms']) / wide['p50_ms']:.3f}; "
        f"one eval forward's #4 {wtot['eval_ms']:.3f} ms (plain {wtot['eval_plain_ms']:.3f}, library "
        f"{wtot['eval_library_ms']:.3f}, bound f32 {wtot['eval_bound_ms']:.3f}, TF32x3 "
        f"{wtot['eval_bound_tc_ms']:.3f})")
    for g in mono:
        time_training(torch, pk, fwd_drop, bwd, ("#2", "#3"), g, gen, dev, wrate, sms, "time-wide")
    stot = step_totals(mono, "time-wide", ("#2", "#3"), wide_per_step[fwd_drop.__name__])
    # profiled at each geometry (kernel_phase_split): only window_block.cu's
    # kernels may run; their time by phase, summed per step
    wide_split = profile_split(torch, fwd_drop, bwd, ("#2", "#3"), mono, gen, dev, wrate,
                               "profile-wide-kernels")
    ph_split = profile_split(torch, ph_fwd, ph_bwd, ("#4", "#5"), pgeos, gen, dev, wrate,
                             "profile-perhead")
    torch.cuda.empty_cache()

    # ---- 14. #13 and #14 vs plain at every tower geometry of the DeepSense
    # pretrain step: MOD (batch 256, views fused to 512, C 64) and MOD_WIDE
    # (batch 128 fused to 256, C 256), seismic (first conv inside) and audio
    # (first conv outside)
    import torch.nn.functional as F

    cgeos = (tower_geometries(cfg, 2 * DS_BATCH, "MOD")
             + tower_geometries(wcfg, 2 * DS_WIDE_BATCH, "MOD_WIDE"))
    ct_fwd_err, ct_grad_rel, ct_grad_near, ct_grad_abs = check_towers(torch, np, ct, cgeos, dev)
    torch.cuda.empty_cache()

    # ---- 15. DeepSense pretrain steps: the default path (cuDNN convs, no
    # kernel) and -pallas_conv (#13/#14), in one call: MOD at batch 256 (3 +
    # 10 steps), then MOD_WIDE at batch 128 (3 + 5), where the towers weigh
    mod_geos = [g for g in cgeos if g["name"].startswith("MOD ")]
    ds_per_step = tower_launches(mod_geos)
    ds_wide_per_step = tower_launches([g for g in cgeos if g["name"].startswith("MOD_WIDE ")])
    ds_runs = {}
    for dataset, batch, steps in (("MOD_WIDE", DS_WIDE_BATCH, WIDE_STEPS),
                                  ("MOD", DS_BATCH, TRAIN_STEPS)):
        for pallas in (False, True):
            dargs = parse_train_params(["-dataset", dataset, "-model", "DeepSense",
                                        "-learn_framework", "FOCAL", "-stage", "pretrain",
                                        "-batch_size", str(batch)]
                                       + (["-pallas_conv"] if pallas else []))
            tag = ("deepsense-pallas" if pallas else "deepsense-default") + (
                "-wide" if dataset == "MOD_WIDE" else "")
            per_step = ds_per_step if dataset == "MOD" else ds_wide_per_step
            ds_runs[tag], trained = run_deepsense_steps(
                torch, np, dargs, batch, TRAIN_WARMUP, steps, all_kernels,
                per_step if pallas else {}, dev, tag)
            if pallas and dataset == "MOD":
                trained_sd = {k: v.detach().cpu().clone() for k, v in trained.state_dict().items()}
            del trained
            torch.cuda.empty_cache()
    w_def, w_pal = ds_runs["deepsense-default-wide"], ds_runs["deepsense-pallas-wide"]
    log(f"[deepsense-wide] MOD_WIDE step, -pallas_conv vs default: p50 {w_pal['p50_ms']:.3f} vs "
        f"{w_def['p50_ms']:.3f} ms, {w_pal['samples_per_s']:.1f} vs {w_def['samples_per_s']:.1f} "
        f"samples/s, idle share {w_pal['idle_share']:.3f} vs {w_def['idle_share']:.3f}, device "
        f"busy {w_pal['device_busy_ms']:.3f} vs {w_def['device_busy_ms']:.3f} ms (#13/#14 "
        f"{w_pal['tower_kernels_device_ms']:.3f}), peak {w_pal['peak_mb']:.1f} vs "
        f"{w_def['peak_mb']:.1f} MiB")
    # the rate-0 step, kernels vs plain: from the initial state (held) and
    # from the -pallas_conv run's trained state (reported)
    from focal_tpu_torch.models import build_backbone, init_params

    initial_sd = init_params(build_backbone(cfg, "DeepSense", task, "FOCAL"), seed=0).state_dict()
    rate0 = {}
    for where, weights in (("initial", initial_sd), ("trained", trained_sd)):
        kern = deepsense_rate0_step(torch, dargs, weights, dev, plain=False)
        plain = deepsense_rate0_step(torch, dargs, weights, dev, plain=True)
        loss_rel = abs(kern[0] - plain[0]) / abs(plain[0])
        g_rel, g_near, _ = grad_errors([kern[1][n] for n in plain[1]], list(plain[1].values()))
        stats_rel = max(rel_err(kern[2][n], plain[2][n]) for n in plain[2])
        rate0[where] = {"loss_kernel": kern[0], "loss_plain": plain[0], "loss_rel": loss_rel,
                        "max_grad_rel": g_rel, "max_grad_abs_near_zero": g_near,
                        "max_stats_rel": stats_rel}
        log(f"[deepsense-rate0] from the {where} state, kernels vs plain: loss {kern[0]:.6f} vs "
            f"{plain[0]:.6f} (rel {loss_rel:.2e}), max grad rel err {g_rel:.2e} (near-zero max "
            f"abs {g_near:.2e}), running statistics max rel err {stats_rel:.2e}"
            f"{'' if where == 'initial' else ' (reported, not held)'}")
        if where == "initial" and not (loss_rel <= LOSS_TOL and g_rel <= GRAD_TOL
                                       and g_near <= NEAR_ZERO and stats_rel <= TOWER_TOL):
            raise AssertionError(f"DeepSense rate-0 step, kernels vs plain: {rate0[where]}")
        del kern, plain
    del trained_sd, initial_sd
    torch.cuda.empty_cache()

    # ---- 16. the entry point: python -m focal_tpu_torch.train -dataset MOD
    # -model DeepSense -pallas_conv -synthetic, 2 epochs, then -resume to 3;
    # then Predictor serves the _best file
    run_dir = os.path.join(HERE, "build", "chip_smoke_deepsense")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["-dataset", "MOD", "-model", "DeepSense", "-learn_framework", "FOCAL", "-stage",
            "pretrain", "-pallas_conv", "-synthetic", "-synthetic_samples", str(DS_SAMPLES),
            "-batch_size", str(DS_BATCH), "-val_epochs", "1", "-output_dir", run_dir]
    ds_cli = []
    folder = os.path.join(run_dir, "weights", "MOD_DeepSense")
    for extra, points_want in ((["-epochs", "2"], [0, 1]), (["-epochs", "3", "-resume"], [2])):
        zero_counts(all_kernels)
        t0 = time.time()
        st, best, points = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts(all_kernels)
        n_steps = st.step - (ds_cli[-1]["step"] if ds_cli else 0)
        # eval forwards launch nothing: the counts are the steps' alone
        want = {k.__name__: ds_per_step.get(k.__name__, 0) * n_steps for k in all_kernels}
        if [p["epoch"] for p in points] != points_want:
            raise AssertionError(f"validation points {[p['epoch'] for p in points]} != {points_want}")
        for p in points:
            if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
                raise AssertionError(f"non-finite loss at a validation point: {p}")
        check_counts(f"DeepSense train CLI {' '.join(extra)}", got, want)
        (exp,) = [d for d in os.listdir(folder) if d.startswith("exp")]
        files = {kind: os.path.join(folder, exp, f"MOD_DeepSense_pretrain_{kind}.pt")
                 for kind in ("latest", "best", "resume")}
        for kind, path in files.items():
            saved = torch.load(path, map_location="cpu", weights_only=True)
            keys = saved["model"] if kind == "resume" else saved
            n_stats = sum(k.endswith(".mean") or k.endswith(".var") for k in keys)
            if n_stats != 2 * sum(len(g["cfgs"]) for g in mod_geos):  # each BatchNorm's two
                raise AssertionError(f"{path}: {n_stats} running statistics")
        ds_cli.append({"argv": extra, "seconds": secs, "step": st.step, "steps": n_steps,
                       "launches": got, "points": points, "best": best})
        log(f"[deepsense-cli] MOD {' '.join(extra)}: {n_steps} steps in {secs:.1f}s; launches "
            f"{got}; points " + "; ".join(
                f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} "
                f"test {p['test_loss']:.4f} val acc {p['val_acc']:.3f}" for p in points))
        del st
    predictor = Predictor(cfg, "DeepSense", task, files["best"], batch_size=SERVE_BATCH,
                          device="cuda", learn_framework="FOCAL")
    zero_counts(all_kernels)
    ds_result = predictor.predict(data)
    ds_serve_launches = counts(all_kernels)
    check_counts("DeepSense serving", ds_serve_launches, {k.__name__: 0 for k in all_kernels})
    dprobs = ds_result["probs"]
    if dprobs.shape != (n, cfg[task]["num_classes"]) or not np.isfinite(dprobs).all():
        raise AssertionError(f"DeepSense: bad probabilities: shape {dprobs.shape}")
    if float(np.abs(dprobs.sum(-1) - 1.0).max()) > 1e-5:
        raise AssertionError("DeepSense: probabilities do not sum to 1")
    ds_lat = ds_result["latency"]
    log(f"[deepsense-serve] {n} samples in {ds_lat['batches']} batches of {SERVE_BATCH} from the "
        f"_best file: p50 batch {ds_lat['p50_s'] * 1e3:.3f} ms, p99 {ds_lat['p99_s'] * 1e3:.3f} ms, "
        f"{ds_lat['windows_per_s']:.1f} samples/s; launches {ds_serve_launches}")
    del predictor
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 17. #13 and #14 timing per tower geometry: the kernels, the plain
    # versions, the library yardstick (the unfused cuDNN chain and its
    # autograd backward) and the bound
    ctot = {}
    for gi, g in enumerate(cgeos):
        f_fl, f_by, b_fl, b_by = time_tower(torch, np, ct, F, g, 200 + gi, dev)
        ds = g["name"].split()[0]
        step_sum = ctot.setdefault(ds, {"fwd_flops": 0, "fwd_bytes": 0, "bwd_flops": 0,
                                        "bwd_bytes": 0, "fwd_bound_tc_ms": 0.0,
                                        "bwd_bound_tc_ms": 0.0,
                                        "device_ms_by_phase": {"fwd": {}, "bwd": {}}})
        for k in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "bwd_ms", "bwd_plain_ms",
                  "bwd_library_ms", "fwd_bound_tc_ms", "bwd_bound_tc_ms"):
            step_sum[k] = step_sum.get(k, 0.0) + g[k]
        for d in ("fwd", "bwd"):
            split = step_sum["device_ms_by_phase"][d]
            for ph, ms in g["profile"][d]["phases"].items():
                split[ph] = split.get(ph, 0.0) + ms
        step_sum["fwd_flops"] += f_fl
        step_sum["fwd_bytes"] += f_by
        step_sum["bwd_flops"] += b_fl
        step_sum["bwd_bytes"] += b_by
    for ds, step_sum in ctot.items():
        step_sum["fwd_bound_ms"] = bound(step_sum["fwd_flops"], step_sum["fwd_bytes"])[0]
        step_sum["bwd_bound_ms"] = bound(step_sum["bwd_flops"], step_sum["bwd_bytes"])[0]
        log(f"[time-tower] one {ds} DeepSense step's towers: #13 {step_sum['fwd_ms']:.3f} ms "
            f"(plain {step_sum['fwd_plain_ms']:.3f}, library {step_sum['fwd_library_ms']:.3f}, "
            f"bound f32 {step_sum['fwd_bound_ms']:.3f}, TF32x3 {step_sum['fwd_bound_tc_ms']:.3f}, "
            f"{step_sum['fwd_flops'] / 1e9:.2f} GFLOP); #14 {step_sum['bwd_ms']:.3f} ms (plain "
            f"{step_sum['bwd_plain_ms']:.3f}, library {step_sum['bwd_library_ms']:.3f}, bound f32 "
            f"{step_sum['bwd_bound_ms']:.3f}, TF32x3 {step_sum['bwd_bound_tc_ms']:.3f}, "
            f"{step_sum['bwd_flops'] / 1e9:.2f} GFLOP)")
        log(f"[profile-tower] one {ds} DeepSense step's towers, device ms by phase: "
            f"#13 {step_sum['device_ms_by_phase']['fwd']}; #14 {step_sum['device_ms_by_phase']['bwd']}")
    mod_tot = ctot["MOD"]
    for ds, tag in (("MOD", "deepsense-pallas"), ("MOD_WIDE", "deepsense-pallas-wide")):
        log(f"[time-tower] share of the -pallas_conv p50 step ({ds}): "
            f"{(ctot[ds]['fwd_ms'] + ctot[ds]['bwd_ms']) / ds_runs[tag]['p50_ms']:.3f}")
    torch.cuda.empty_cache()
    # ---- 18. #10, #11 and #12 vs plain at every MLP geometry on the fused
    # route: MOD at the classifier batch of 128, MOD_WIDE stage 0 at batch
    # 64 with the views fused to 128
    mgeos = (mlp_geometries(cfg, SUP_BATCH, "MOD")
             + mlp_geometries(wcfg, 2 * WIDE_BATCH, "MOD_WIDE"))
    mlp_rate = float(cfg["SW_Transformer"]["dropout_ratio"])
    mlp_err = check_mlps(torch, np, fm, mgeos, dev, mlp_rate)
    torch.cuda.empty_cache()

    # ---- 19. MOD supervised steps at batch 128, the default path and
    # -pallas_mlp; the rate-0 step, kernels vs plain, from the initial state
    per_fwd_mlp = sum(g["per_forward"] for g in mgeos if g["name"].startswith("MOD "))
    sup_step = {fwd_drop.__name__: per_fwd, bwd.__name__: per_fwd,
                mlp_drop.__name__: per_fwd_mlp, mlp_bwd.__name__: per_fwd_mlp}
    ft_step = {fwd_drop.__name__: per_fwd, mlp_drop.__name__: per_fwd_mlp}
    eval_fwd = {fwd.__name__: per_fwd, mlp_fwd.__name__: per_fwd_mlp}
    sup_runs = {}
    for pallas in (False, True):
        sargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                    "-learn_framework", "no", "-batch_size", str(SUP_BATCH)]
                                   + (["-pallas_mlp"] if pallas else []))
        tag = "supervised-pallas-mlp" if pallas else "supervised-default"
        per_step = sup_step if pallas else {fwd_drop.__name__: per_fwd, bwd.__name__: per_fwd}
        sup_runs[tag] = run_supervised_steps(torch, np, sargs, SUP_BATCH, TRAIN_WARMUP,
                                             TRAIN_STEPS, all_kernels, per_step, dev, tag)
        torch.cuda.empty_cache()
    run, p = sup_runs["supervised-pallas-mlp"], PARENT_STEPS["MOD_supervised_pallas_mlp"]
    log(f"[supervised-pallas-mlp] beside the CUDA-core #10-#12 (p50 {p['p50_ms']:.3f} ms, idle "
        f"share {p['idle_share']:.3f}, peak {p['peak_mb']:.1f} MiB): p50 {run['p50_ms']:.3f} ms "
        f"({run['p50_ms'] / p['p50_ms']:.3f}x), idle share {run['idle_share']:.3f}, device busy "
        f"{run['profile']['device_busy_ms']:.3f} ms, peak {run['peak_mb']:.1f} MiB "
        f"({run['peak_mb'] / p['peak_mb']:.3f}x; {run['peak_mb'] / sup_runs['supervised-default']['peak_mb']:.3f}x "
        f"the default route's), #10-#12 device {run['mlp_kernels_device_ms']:.4f} ms")
    from focal_tpu_torch.models import build_backbone, init_params

    sup_initial = init_params(build_backbone(cfg, "SW_Transformer", task, "no", pallas_mlp=True),
                              seed=0).state_dict()
    kern = supervised_rate0_step(torch, sargs, sup_initial, dev, plain=False)
    plain = supervised_rate0_step(torch, sargs, sup_initial, dev, plain=True)
    want0 = {fwd.__name__: per_fwd, bwd.__name__: per_fwd, mlp_fwd.__name__: per_fwd_mlp,
             mlp_bwd.__name__: per_fwd_mlp, fwd_drop.__name__: 0, mlp_drop.__name__: 0}
    check_counts("supervised rate-0 step (kernels)", kern[2], want0)
    check_counts("supervised rate-0 step (plain)", plain[2], {k: 0 for k in want0})
    sup_rate0_loss = abs(kern[0] - plain[0]) / abs(plain[0])
    # a true gradient of 0 (the fusion attention's key bias: its softmax is
    # blind to it) is rounding noise on both sides: compared absolutely
    zero_grads = [n for n in plain[1] if max(float(kern[1][n].abs().max()),
                                             float(plain[1][n].abs().max())) < TINY_GRAD]
    sup_rate0_grad, worst = max((rel_err(kern[1][n], plain[1][n]), n) for n in plain[1]
                                if n not in zero_grads)
    zero_abs = max([float((kern[1][n] - plain[1][n]).abs().max()) for n in zero_grads] + [0.0])
    sup_rate0 = {"loss_kernel": kern[0], "loss_plain": plain[0], "loss_rel": sup_rate0_loss,
                 "max_grad_rel": sup_rate0_grad, "worst": worst, "zero_gradients": zero_grads,
                 "zero_gradients_max_abs": zero_abs, "launches": kern[2]}
    log(f"[supervised-rate0] from the initial state, kernels vs plain: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {sup_rate0_loss:.2e}), max grad rel err {sup_rate0_grad:.2e} "
        f"({worst}); true-zero gradients {zero_grads} within {zero_abs:.2e} absolute; "
        f"launches {kern[2]}")
    if set(kern[1]) != set(plain[1]) or not (sup_rate0_loss <= LOSS_TOL
                                             and sup_rate0_grad <= GRAD_TOL
                                             and zero_abs <= TINY_GRAD):
        raise AssertionError(f"supervised rate-0 step, kernels vs plain: {sup_rate0}")
    del kern, plain, sup_initial
    torch.cuda.empty_cache()

    # ---- 20. the classifier entry points at MOD with -pallas_mlp: supervised
    # 2 epochs, -resume to 3, test; FOCAL pretrain 1 epoch, finetune 2 epochs,
    # -resume to 3, test; then Predictor -pallas_mlp
    test_cli = importlib.import_module("focal_tpu_torch.test")
    run_dir = os.path.join(HERE, "build", "chip_smoke_classifier")
    shutil.rmtree(run_dir, ignore_errors=True)
    base = ["-dataset", "MOD", "-model", "SW_Transformer", "-pallas_mlp", "-synthetic",
            "-synthetic_samples", str(SUP_SAMPLES), "-val_epochs", "1", "-output_dir", run_dir]
    sup_argv = base + ["-learn_framework", "no", "-batch_size", str(SUP_BATCH)]
    pre_argv = base + ["-learn_framework", "FOCAL", "-stage", "pretrain"]
    ft_argv = base + ["-learn_framework", "FOCAL", "-stage", "finetune", "-batch_size",
                      str(SUP_BATCH)]

    def cli_plan(argv):
        """(train steps an epoch, eval forwards a validation point, eval
        forwards of the test CLI) of a run."""
        a = parse_train_params(argv)
        seq = a.train_mode == "contrastive" and a.stage == "pretrain"
        n = {o: len(DeviceDataLoader(load_split(o, a), a.batch_size, sequence=seq))
             for o in ("train", "val", "test")}
        steps = len(DeviceDataLoader(load_split("train", a), a.batch_size, drop_last=True,
                                     sequence=seq))
        evals = n["train"] + 3 * (n["val"] + n["test"]) if seq else n["val"] + n["test"]
        return steps, evals, n["test"]

    cls_runs = []

    def run_cli(what, fn, argv, per_step, epochs, points_want, evals=eval_fwd, runs=None):
        steps_per_epoch, evals_per_point, test_evals = cli_plan(argv)
        zero_counts(all_kernels)
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts(all_kernels)
        if points_want is None:  # the test CLI: one eval forward a test batch
            n_steps, n_evals = 0, test_evals
            if not all(math.isfinite(v) for v in out):
                raise AssertionError(f"{what}: non-finite test metrics {out}")
            summary = {"loss": out[0], "acc": out[1], "f1": out[2]}
        else:
            st, best, points = out
            n_steps, n_evals = steps_per_epoch * epochs, evals_per_point * len(points)
            if [p["epoch"] for p in points] != points_want:
                raise AssertionError(f"{what}: validation points {[p['epoch'] for p in points]}")
            for p in points:
                if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
                    raise AssertionError(f"{what}: non-finite loss at a validation point: {p}")
            summary = {"best": best, "points": points, "step": st.step}
        want = {k.__name__: per_step.get(k.__name__, 0) * n_steps
                + evals.get(k.__name__, 0) * n_evals for k in all_kernels}
        check_counts(what, got, want)
        (cls_runs if runs is None else runs).append({"what": what, "seconds": secs, "steps": n_steps, "eval_forwards": n_evals,
                         "launches": got, **summary})
        log(f"[classifier-cli] {what}: {n_steps} steps, {n_evals} eval forwards in {secs:.1f}s; "
            f"launches {got}; " + ("; ".join(
                f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} val acc "
                f"{p['val_acc']:.3f} test acc {p['test_acc']:.3f}" for p in summary["points"])
                if "points" in summary else f"test loss {out[0]:.4f} acc {out[1]:.4f} f1 {out[2]:.4f}"))
        return out

    weights = os.path.join(run_dir, "weights", "MOD_SW_Transformer")
    run_cli("supervised -epochs 2", train_cli.main, sup_argv + ["-epochs", "2"], sup_step, 2, [0, 1])
    run_cli("supervised -epochs 3 -resume", train_cli.main, sup_argv + ["-epochs", "3", "-resume"],
            sup_step, 1, [2])
    run_cli("test (supervised _best)", test_cli.main, sup_argv, {}, 0, None)
    sup_dir = os.path.join(weights, "exp0_supervised_vehicle_classification_1.0")
    for kind in ("best", "latest", "resume"):
        path = os.path.join(sup_dir, f"MOD_SW_Transformer_vehicle_classification_{kind}.pt")
        if not os.path.isfile(path):
            raise AssertionError(f"missing checkpoint {path}")
    run_cli("pretrain -epochs 1", train_cli.main, pre_argv + ["-epochs", "1"], sup_step, 1, [0])
    pre_dir = os.path.join(weights, "exp0_contrastive_FOCAL")
    pretrained = torch.load(os.path.join(pre_dir, "MOD_SW_Transformer_pretrain_latest.pt"),
                            map_location="cpu", weights_only=True)
    ft_file = os.path.join(pre_dir, "MOD_SW_Transformer_vehicle_classification_1.0_finetune_latest.pt")
    for extra, epochs, points_want in ((["-epochs", "2"], 2, [0, 1]),
                                       (["-epochs", "3", "-resume"], 1, [2])):
        run_cli(f"finetune {' '.join(extra)}", train_cli.main, ft_argv + extra, ft_step, epochs,
                points_want)
        tuned = torch.load(ft_file, map_location="cpu", weights_only=True)
        moved = set()
        for name, t in tuned.items():
            head = name.startswith(("class_layer", "mod_fusion_layer"))
            if head and not torch.equal(t, pretrained[name]):
                moved.add(name.split(".")[0])
            if not head and not torch.equal(t, pretrained[name]):
                raise AssertionError(f"finetune moved the frozen backbone parameter {name}")
        if moved != {"class_layer", "mod_fusion_layer"}:
            raise AssertionError(f"finetune moved {moved}, not class_layer and mod_fusion_layer")
    run_cli("test (finetune _best)", test_cli.main, ft_argv, {}, 0, None)
    log(f"[classifier-cli] finetune left all {len(pretrained) - sum(n.startswith(('class_layer', 'mod_fusion_layer')) for n in pretrained)} "
        "backbone entries bitwise as pretrained; class_layer and mod_fusion_layer moved")
    shutil.rmtree(run_dir, ignore_errors=True)
    del pretrained, tuned
    torch.cuda.empty_cache()

    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0, pallas_mlp=True)
    zero_counts(all_kernels)
    mlp_result = predictor.predict(data)
    mlp_serve_launches = counts(all_kernels)
    mlp_batches = mlp_result["latency"]["batches"]
    check_counts("serving -pallas_mlp", mlp_serve_launches,
                 {k.__name__: eval_fwd.get(k.__name__, 0) * mlp_batches for k in all_kernels})
    mlp_serve_err = float(np.abs(mlp_result["probs"] - probs).max())
    mlp_lat = mlp_result["latency"]
    log(f"[serve-mlp] {n} samples in {mlp_batches} batches of {SERVE_BATCH} with -pallas_mlp: "
        f"launches {mlp_serve_launches}; p50 batch {mlp_lat['p50_s'] * 1e3:.3f} ms, "
        f"{mlp_lat['windows_per_s']:.1f} samples/s; max|dprobs| vs the cuBLAS MLP {mlp_serve_err:.3e}")
    if not mlp_serve_err <= SLICE_TOL:
        raise AssertionError(f"-pallas_mlp served probabilities differ by {mlp_serve_err}")
    del predictor
    torch.cuda.empty_cache()

    # ---- 21. #10, #11 and #12 timing per geometry: kernel, plain version,
    # the cuBLAS chain as the library yardstick (with F.dropout for #11 and
    # its autograd backward for #12), the bounds on the f32 CUDA cores and
    # on the TF32 tensor cores (3 passes), TFLOP/s; then profiled calls of
    # each at every geometry, which fail the run if a device kernel they
    # launch is not one of csrc/fused_mlp.cu's, split by kernel name
    mtot = {}
    for gi, g in enumerate(mgeos):
        T, C, H = g["T"], g["C"], g["H"]
        x, w1, b1, w2, b2, gy = mlp_inputs(torch, np, g, 500 + gi, dev)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        keep1, keep2 = fm.mlp_keep_masks(7, T, C, H, mlp_rate, dev)
        calls = {"fwd": lambda: mlp_fwd(x, w1, b1, w2, b2),
                 "drop": lambda: mlp_drop(x, w1, b1, w2, b2, 7, mlp_rate),
                 "bwd": lambda: mlp_bwd(x, w1, b1, w1t, w2t, gy, 7, mlp_rate)}
        with torch.no_grad():
            g["fwd_ms"] = time_ms(torch, calls["fwd"])
            g["fwd_plain_ms"] = time_ms(torch, lambda: fm.fused_mlp_reference(x, w1, b1, w2, b2))
            g["fwd_library_ms"] = time_ms(torch, lambda: library_mlp(torch, F, x, w1, b1, w2, b2))
            g["drop_ms"] = time_ms(torch, calls["drop"])
            g["drop_plain_ms"] = time_ms(torch, lambda: fm.fused_mlp_dropout_reference(
                x, w1, b1, w2, b2, keep1, keep2, mlp_rate))
            g["drop_library_ms"] = time_ms(
                torch, lambda: library_mlp(torch, F, x, w1, b1, w2, b2, mlp_rate))
        g["bwd_ms"] = time_ms(torch, calls["bwd"])
        g["bwd_nomask_ms"] = time_ms(torch, lambda: mlp_bwd(x, w1, b1, w1t, w2t, gy))
        g["bwd_plain_ms"] = time_ms(torch, lambda: fm.fused_mlp_backward_reference(
            x, w1, b1, w2, b2, gy, keep1, keep2, mlp_rate))
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        ly = library_mlp(torch, F, *leaves, mlp_rate)
        g["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves, gy,
                                                                         retain_graph=True))
        del ly, leaves
        f_fl, f_by = mlp_work(g, False)
        b_fl, b_by = mlp_work(g, True)
        g["fwd_bound_ms"], g["fwd_bound_by"] = bound(f_fl, f_by)
        g["bwd_bound_ms"], g["bwd_bound_by"] = bound(b_fl, b_by)
        g["fwd_bound_tc_ms"], g["bwd_bound_tc_ms"] = tc_bound(f_fl, f_by), tc_bound(b_fl, b_by)
        g["fwd_gflop"], g["bwd_gflop"] = f_fl / 1e9, b_fl / 1e9
        g["chunks"] = fm.mlp_launch_plan(T, C, H, True, dev)[1]
        log(f"[time-mlp] {g['name']} ({g['chunks']} row chunks): #10 {g['fwd_ms']:.4f} ms (plain "
            f"{g['fwd_plain_ms']:.4f}, library {g['fwd_library_ms']:.4f}, bound f32 "
            f"{g['fwd_bound_ms']:.4f}, TF32x3 {g['fwd_bound_tc_ms']:.4f}, "
            f"{f_fl / g['fwd_ms'] / 1e9:.2f} TFLOP/s); #11 {g['drop_ms']:.4f} ms (plain "
            f"{g['drop_plain_ms']:.4f}, library {g['drop_library_ms']:.4f}, "
            f"{f_fl / g['drop_ms'] / 1e9:.2f} TFLOP/s); #12 {g['bwd_ms']:.4f} ms, "
            f"{g['bwd_nomask_ms']:.4f} without masks (plain {g['bwd_plain_ms']:.4f}, library "
            f"{g['bwd_library_ms']:.4f}, bound f32 {g['bwd_bound_ms']:.4f}, TF32x3 "
            f"{g['bwd_bound_tc_ms']:.4f}, {b_fl / g['bwd_ms'] / 1e9:.2f} TFLOP/s)")
        for fn in calls.values():  # warm before the traces
            fn()
        torch.cuda.synchronize()
        # a trace of well under a millisecond of kernels lost every record:
        # at least PROFILE_TRACE_MS of calls
        g["profile"] = {d: kernel_phase_split(
            torch, fn, mlp_launches(g["chunks"], "bwd" if d == "bwd" else "fwd"), MLP_LIB,
            reps=max(PROFILE_REPS, math.ceil(PROFILE_TRACE_MS / g[f"{d}_ms"])))
            for d, fn in calls.items()}
        log(f"[profile-mlp] {g['name']}: " + "; ".join(
            f"{name} device {g['profile'][d]['device_ms']:.4f} ms a call (" + ", ".join(
                f"{p} {ms:.4f}" for p, ms in sorted(g["profile"][d]["phases"].items(),
                                                    key=lambda kv: -kv[1])) + ")"
            for d, name in (("fwd", "#10"), ("drop", "#11"), ("bwd", "#12"))))
        ds = g["name"].split()[0]
        step_sum = mtot.setdefault(ds, {"fwd_flops": 0, "fwd_bytes": 0, "bwd_flops": 0,
                                        "bwd_bytes": 0, "launches": 0,
                                        "device_ms_by_phase": {"fwd": {}, "drop": {}, "bwd": {}}})
        k = g["per_forward"]
        for key in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "drop_ms", "drop_plain_ms",
                    "drop_library_ms", "bwd_ms", "bwd_nomask_ms", "bwd_plain_ms",
                    "bwd_library_ms"):
            step_sum[key] = step_sum.get(key, 0.0) + k * g[key]
        for d, split in step_sum["device_ms_by_phase"].items():
            for phase, ms in g["profile"][d]["phases"].items():
                split[phase] = split.get(phase, 0.0) + k * ms
        step_sum["fwd_flops"] += k * f_fl
        step_sum["fwd_bytes"] += k * f_by
        step_sum["bwd_flops"] += k * b_fl
        step_sum["bwd_bytes"] += k * b_by
        step_sum["launches"] += k
        del x, w1, b1, w2, b2, gy, w1t, w2t, keep1, keep2, calls
    for ds, step_sum in mtot.items():
        for d in ("fwd", "bwd"):
            fl, by = step_sum[f"{d}_flops"], step_sum[f"{d}_bytes"]
            step_sum[f"{d}_bound_ms"], step_sum[f"{d}_bound_tc_ms"] = bound(fl, by)[0], tc_bound(fl, by)
        log(f"[time-mlp] one {ds} forward's MLPs ({step_sum['launches']} launches): #10 "
            f"{step_sum['fwd_ms']:.3f} ms (plain {step_sum['fwd_plain_ms']:.3f}, library "
            f"{step_sum['fwd_library_ms']:.3f}, bound f32 {step_sum['fwd_bound_ms']:.3f}, TF32x3 "
            f"{step_sum['fwd_bound_tc_ms']:.3f}, {step_sum['fwd_flops'] / 1e9:.2f} GFLOP, "
            f"{step_sum['fwd_flops'] / step_sum['fwd_ms'] / 1e9:.2f} TFLOP/s); #11 "
            f"{step_sum['drop_ms']:.3f} (plain {step_sum['drop_plain_ms']:.3f}, library "
            f"{step_sum['drop_library_ms']:.3f}); #12 {step_sum['bwd_ms']:.3f} ms, "
            f"{step_sum['bwd_nomask_ms']:.3f} without masks (plain {step_sum['bwd_plain_ms']:.3f}, "
            f"library {step_sum['bwd_library_ms']:.3f}, bound f32 {step_sum['bwd_bound_ms']:.3f}, "
            f"TF32x3 {step_sum['bwd_bound_tc_ms']:.3f}, {step_sum['bwd_flops'] / 1e9:.2f} GFLOP, "
            f"{step_sum['bwd_flops'] / step_sum['bwd_ms'] / 1e9:.2f} TFLOP/s); device ms by "
            f"phase: {step_sum['device_ms_by_phase']}")
    mod_mlp = mtot["MOD"]
    log(f"[time-mlp] share of the -pallas_mlp supervised p50 step (MOD): "
        f"{(mod_mlp['drop_ms'] + mod_mlp['bwd_ms']) / sup_runs['supervised-pallas-mlp']['p50_ms']:.3f}")
    torch.cuda.empty_cache()

    # ---- 22. #6-#9 vs plain at every attention geometry: MOD served (128)
    # and training (256, views fused to 512), MOD_WIDE's 16 blocks (64 fused
    # to 128); #7's mask against #2's (#4's where #2 does not launch)
    agen = {"serve": attention_geometries(cfg, SERVE_BATCH, "MOD"),
            "train": attention_geometries(cfg, 2 * TRAIN_BATCH, "MOD"),
            "wide": attention_geometries(wcfg, 2 * WIDE_BATCH, "MOD_WIDE")}
    at_err = {"fwd": 0.0, "drop": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    t22 = time.time()
    for kind, ags in agen.items():
        check_attention(torch, np, pk, ags, gen, dev, wrate if kind == "wide" else rate,
                        6000 + 100 * len(kind), at_err)
    torch.cuda.empty_cache()
    log(f"[check-attn] {sum(len(a) for a in agen.values())} geometries in {time.time() - t22:.1f}s")

    # ---- 23. MOD pretrain steps with -no_pallas_block at batch 256; the
    # rate-0 step from the initial state (#6 and #8), kernels vs plain
    attn_step = {at_drop.__name__: per_fwd, at_drop_bwd.__name__: per_fwd}
    nargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                "-learn_framework", "FOCAL", "-stage", "pretrain",
                                "-no_pallas_block", "-batch_size", str(TRAIN_BATCH)])
    attn_train, (state, step, tdata, idx) = run_train_steps(
        torch, np, nargs, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, all_kernels, attn_step, dev,
        "train-no-pallas-block", rate0_from="initial",
        rate0_launches={at_fwd.__name__: per_fwd, at_bwd.__name__: per_fwd})
    attn_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-no-pallas-block", "one -no_pallas_block training step", attn_profile, top=15)
    attn_train["idle_share"] = 1 - attn_profile["device_busy_ms"] / attn_profile["wall_ms"]
    attn_train["attention_kernels_device_ms"] = {
        kern: attention_kernel_ms(attn_profile["rows"], kern, True)
        for kern in ("wattn_fwd_kernel", "wattn_bwd_kernel")}
    log(f"[train-no-pallas-block] device time in the profiled step: #7 "
        f"{attn_train['attention_kernels_device_ms']['wattn_fwd_kernel']:.4f} ms, #9 "
        f"{attn_train['attention_kernels_device_ms']['wattn_bwd_kernel']:.4f} ms (16 launches each; "
        f"#9's ordered d rel_bias pass apart); beside the default route's step of "
        f"phases 7 and 9: p50 {attn_train['p50_ms']:.3f} vs {p50_ms:.3f} ms, idle share "
        f"{attn_train['idle_share']:.3f} vs {train['idle_share']:.3f}, peak memory "
        f"{attn_train['peak_mb']:.1f} vs {train['peak_mb']:.1f} MiB")
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 24. the entry points at MOD with -no_pallas_block: supervised 1
    # epoch, -resume to 2, test; FOCAL pretrain 1 epoch, finetune 1 epoch,
    # test; then Predictor(pallas_block=False)
    run_dir = os.path.join(HERE, "build", "chip_smoke_no_pallas_block")
    shutil.rmtree(run_dir, ignore_errors=True)
    nbase = ["-dataset", "MOD", "-model", "SW_Transformer", "-no_pallas_block", "-synthetic",
             "-synthetic_samples", str(SUP_SAMPLES), "-val_epochs", "1", "-output_dir", run_dir]
    nsup = nbase + ["-learn_framework", "no", "-batch_size", str(SUP_BATCH)]
    nft = nbase + ["-learn_framework", "FOCAL", "-stage", "finetune", "-batch_size", str(SUP_BATCH)]
    attn_eval = {at_fwd.__name__: per_fwd}
    attn_runs = []
    for what, fn, argv, per_step, epochs, points_want in (
            ("supervised -epochs 1", train_cli.main, nsup + ["-epochs", "1"], attn_step, 1, [0]),
            ("supervised -epochs 2 -resume", train_cli.main, nsup + ["-epochs", "2", "-resume"],
             attn_step, 1, [1]),
            ("test (supervised _best)", test_cli.main, nsup, {}, 0, None),
            ("pretrain -epochs 1", train_cli.main,
             nbase + ["-learn_framework", "FOCAL", "-stage", "pretrain", "-epochs", "1"],
             attn_step, 1, [0]),
            ("finetune -epochs 1", train_cli.main, nft + ["-epochs", "1"],
             {at_drop.__name__: per_fwd}, 1, [0]),  # the frozen backbone takes no backward
            ("test (finetune _best)", test_cli.main, nft, {}, 0, None)):
        run_cli(f"-no_pallas_block {what}", fn, argv, per_step, epochs, points_want,
                evals=attn_eval, runs=attn_runs)
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0, pallas_block=False)
    zero_counts(all_kernels)
    attn_result = predictor.predict(data)
    attn_serve_launches = counts(all_kernels)
    attn_batches = attn_result["latency"]["batches"]
    check_counts("serving -no_pallas_block", attn_serve_launches,
                 {k.__name__: attn_eval.get(k.__name__, 0) * attn_batches for k in all_kernels})
    attn_serve_err = float(np.abs(attn_result["probs"] - probs).max())
    attn_lat = attn_result["latency"]
    log(f"[serve-no-pallas-block] {n} samples in {attn_batches} batches of {SERVE_BATCH}: launches "
        f"{attn_serve_launches}; p50 batch {attn_lat['p50_s'] * 1e3:.3f} ms (#1's route "
        f"{lat['p50_s'] * 1e3:.3f}), {attn_lat['windows_per_s']:.1f} samples/s; max|dprobs| vs "
        f"#1's route {attn_serve_err:.3e}")
    if not attn_serve_err <= SLICE_TOL:
        raise AssertionError(f"-no_pallas_block served probabilities differ by {attn_serve_err}")
    predictor._forward(first)
    attn_serve_profile = profile_device(torch, lambda: predictor._forward(first))
    log_profile("profile-serve-no-pallas-block", "one -no_pallas_block served batch",
                attn_serve_profile)
    attn_serve_device_ms = attention_kernel_ms(attn_serve_profile["rows"], "wattn_fwd_kernel",
                                               False)
    log(f"[serve-no-pallas-block] device time of #6 in the profiled batch: "
        f"{attn_serve_device_ms:.4f} ms ({per_fwd} launches)")
    del predictor
    torch.cuda.empty_cache()

    # ---- 25. #6-#9 timing per geometry: kernel, plain version, the library
    # yardstick (scaled_dot_product_attention with the bias as attn_mask,
    # its autograd backward) and the bound; #6 over one served forward, #7,
    # #8 (rate 0) and #9 over one training step
    atot = {}
    for kind, keys in (("serve", ("fwd",)), ("train", ("drop", "bwd", "drop_bwd"))):
        tot_k = atot.setdefault(kind, {})
        for gi, g in enumerate(agen[kind]):
            q, k, v, rel_bias, mask, gy = attention_inputs(torch, np, g, 7000 + gi, dev)
            attn_mask = library_mask(torch, g, rel_bias, mask)
            fb = {"fwd": attention_work(g, False), "bwd": attention_work(g, True)}
            fb["drop"], fb["drop_bwd"] = fb["fwd"], fb["bwd"]
            with torch.no_grad():
                if kind == "serve":
                    g["fwd_ms"] = time_ms_long(torch, lambda: at_fwd(q, k, v, rel_bias, mask))
                    g["fwd_plain_ms"] = time_ms(
                        torch, lambda: pk.fused_window_attention_reference(q, k, v, rel_bias, mask))
                    g["fwd_library_ms"] = time_ms(
                        torch, lambda: library_attention(torch, q, k, v, attn_mask))
                else:
                    keep = pk.window_attention_keep_mask(7, g["windows"], g["heads"], g["N"], rate,
                                                         dev)
                    g["drop_ms"] = time_ms_long(
                        torch, lambda: at_drop(q, k, v, rel_bias, mask, 7, rate))
                    g["drop_plain_ms"] = time_ms(torch, lambda: pk.fused_window_attention_reference(
                        q, k, v, rel_bias, mask, keep, rate))
                    g["drop_library_ms"] = time_ms(
                        torch, lambda: library_attention(torch, q, k, v, attn_mask, rate))
            fwd_key = "fwd" if kind == "serve" else "drop"
            g[f"{fwd_key}_device_ms"] = device_ms_per_call(torch, (
                (lambda: at_fwd(q, k, v, rel_bias, mask)) if kind == "serve"
                else (lambda: at_drop(q, k, v, rel_bias, mask, 7, rate))))
            tot_k[f"{fwd_key}_device_ms"] = (tot_k.get(f"{fwd_key}_device_ms", 0.0)
                                             + g["per_forward"] * g[f"{fwd_key}_device_ms"])
            if kind == "train":
                g["bwd_device_ms"] = device_ms_per_call(
                    torch, lambda: at_bwd(q, k, v, rel_bias, mask, gy))
                g["drop_bwd_device_ms"] = device_ms_per_call(
                    torch, lambda: at_drop_bwd(q, k, v, rel_bias, mask, gy, 7, rate))
                for d in ("bwd", "drop_bwd"):
                    tot_k[f"{d}_device_ms"] = (tot_k.get(f"{d}_device_ms", 0.0)
                                               + g["per_forward"] * g[f"{d}_device_ms"])
                g["bwd_ms"] = time_ms_long(torch, lambda: at_bwd(q, k, v, rel_bias, mask, gy))
                g["drop_bwd_ms"] = time_ms_long(
                    torch, lambda: at_drop_bwd(q, k, v, rel_bias, mask, gy, 7, rate))
                g["bwd_plain_ms"] = time_ms(torch, lambda: pk.fused_window_attention_backward_reference(
                    q, k, v, rel_bias, mask, gy))
                g["drop_bwd_plain_ms"] = time_ms(
                    torch, lambda: pk.fused_window_attention_backward_reference(
                        q, k, v, rel_bias, mask, gy, keep, rate))
                for r, key in ((0.0, "bwd_library_ms"), (rate, "drop_bwd_library_ms")):
                    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                    am = attn_mask.clone().requires_grad_(True)
                    ly = library_attention(torch, *leaves, am, r)
                    g[key] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves + [am], gy,
                                                                        retain_graph=True))
                    del ly, leaves, am
                del keep
            for d in keys:
                g[f"{d}_flops_bytes"] = fb[d]
                g[f"{d}_bound_ms"], g[f"{d}_bound_by"] = bound(*fb[d])
                for s in ("", "_plain", "_library", "_bound"):
                    tot_k[f"{d}{s}_ms"] = tot_k.get(f"{d}{s}_ms", 0.0) + g["per_forward"] * g[f"{d}{s}_ms"]
                tot_k[f"{d}_flops"] = tot_k.get(f"{d}_flops", 0) + g["per_forward"] * fb[d][0]
                tot_k[f"{d}_bytes"] = tot_k.get(f"{d}_bytes", 0) + g["per_forward"] * fb[d][1]
            log(f"[time-attn] {g['name']} (windows {g['windows']}, hd {g['hd']}): " + "; ".join(
                f"{d} {g[f'{d}_ms']:.4f} ms (plain {g[f'{d}_plain_ms']:.4f}, library "
                f"{g[f'{d}_library_ms']:.4f}, bound {g[f'{d}_bound_ms']:.4f} by {g[f'{d}_bound_by']}, "
                f"{fb[d][1] / g[f'{d}_ms'] / 1e6:.1f} GB/s)" for d in keys))
            del q, k, v, rel_bias, mask, gy, attn_mask
    # the route's backward at MOD stage 0's first training geometry: d(qkv)
    # goes to the qkv Linear as #9 writes it, with no stack or copy
    route_bwd = route_backward_profile(torch, swin_mod, agen["train"][0], dev, rate)
    for r in route_bwd["rows"][:12]:
        log(f"[profile-attn-route] {r['device_ms']:.4f} ms x{r['count']:g}: {r['name'][:90]}")
    log(f"[profile-attn-route] {agen['train'][0]['name']} backward of the -no_pallas_block "
        f"route: device {route_bwd['device_ms']:.4f} ms, #9 {route_bwd['kernel_ms']:.4f} ms, "
        f"copy kernels {route_bwd['copy_kernel_ms']:.4f} ms; stack, cat or window-sized "
        f"copies: {route_bwd['moves']}")
    if route_bwd["moves"] or not route_bwd["kernel_ms"] > 0:
        raise AssertionError(f"the attention-only route's backward stacks or copies its "
                             f"gradients: {route_bwd['moves']}")
    # the route's forward there: q scaled in #7/#6, their output the proj
    # Linear's input, with no q-sized multiply or copy
    route_fwd = route_forward_profile(torch, swin_mod, agen["train"][0], dev, rate)
    for mode, (num, prof_) in zip(("train", "eval"), (("#7", route_fwd["train"]),
                                                       ("#6", route_fwd["eval"]))):
        for r in prof_["rows"][:8]:
            log(f"[profile-attn-route-fwd] {mode} {r['device_ms']:.4f} ms x{r['count']:g}: "
                f"{r['name'][:90]}")
        log(f"[profile-attn-route-fwd] {agen['train'][0]['name']} {mode} forward of the "
            f"-no_pallas_block route: device {prof_['device_ms']:.4f} ms, {num} "
            f"{prof_['kernel_ms']:.4f} ms, copy kernels {prof_['copy_kernel_ms']:.4f} ms; stack, "
            f"cat, q-sized multiplies or copies: {prof_['moves']}")
        if prof_["moves"] or not prof_["kernel_ms"] > 0:
            raise AssertionError(f"the attention-only route's {mode} forward scales or copies q "
                                 f"or its output: {prof_['moves']}")
    names = {"fwd": "#6", "drop": "#7", "bwd": "#8 (rate 0)", "drop_bwd": "#9"}
    for kind, tot_k in atot.items():
        what = (f"one served MOD forward at batch {SERVE_BATCH}" if kind == "serve" else
                f"one MOD training step at batch {TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH})")
        log(f"[time-attn] {what}, {per_fwd} launches each: " + "; ".join(
            f"{names[d]} {tot_k[f'{d}_ms']:.3f} ms (plain {tot_k[f'{d}_plain_ms']:.3f}, library "
            f"{tot_k[f'{d}_library_ms']:.3f}, bound {tot_k[f'{d}_bound_ms']:.3f}, "
            f"{tot_k[f'{d}_bytes'] / 1e9:.3f} GB, {tot_k[f'{d}_flops'] / 1e9:.3f} GFLOP"
            + (f"; device {tot_k[f'{d}_device_ms']:.3f} ms" if f"{d}_device_ms" in tot_k else "")
            + ")" for d in ("fwd", "drop", "bwd", "drop_bwd") if f"{d}_ms" in tot_k))
    a_train = atot["train"]
    log(f"[time-attn] share of the -no_pallas_block p50 step (MOD): "
        f"{(a_train['drop_ms'] + a_train['drop_bwd_ms']) / attn_train['p50_ms']:.3f}")
    torch.cuda.empty_cache()
    log(f"[smoke] phases 22-25 in {time.time() - t22:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 26. the JAX package's ACIDS, PAMAP2 and RealWorld_HAR recipes at
    # full width: every kernel vs plain at their geometries, the served
    # batch, pretrain and supervised steps of both backbones
    recipes = {r: recipe_paths(torch, np, all_kernels, gen, dev, r) for r in RECIPES}

    # ---- 27. two locations at MOD's full width
    two_loc = two_location_paths(torch, np, all_kernels, gen, dev)
    new_runs = {f"{path}_{r}": run for r, res in recipes.items()
                for path, run in res["paths"].items()}
    new_runs.update({f"{path}_MOD_two_locations": run for path, run in two_loc["paths"].items()})
    log(f"[smoke] phases 26-27 in {sum(r['seconds'] for r in recipes.values()) + two_loc['seconds']:.1f}s;"
        f" {time.time() - t_start:.1f}s after the build started")

    # ---- 28. the attribution arms (-ragged_tail's tail step through the
    # kernels), the sweep and the reference format at MOD's full width
    attribution = attribution_paths(torch, np, all_kernels, gen, dev)
    log(f"[smoke] phase 28 in {attribution['seconds']:.1f}s; {time.time() - t_start:.1f}s after "
        "the build started")

    # ---- 29. -compute_dtype bfloat16: #1-bf16 to #3-bf16 vs their bf16 plain
    # versions and timed; the entry points, a served batch, the rate-0 step
    # against f32 and the bf16 step timed beside the f32 one
    bf16 = bf16_paths(torch, np, all_kernels, gen, dev)
    log(f"[smoke] phase 29 in {bf16['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 30. DeepSense at -compute_dtype bfloat16: #13-bf16/#14-bf16 vs
    # their bf16 plain versions at every tower geometry and timed; a served
    # batch, the rate-0 steps, the entry point and the timed steps
    ds_bf16 = deepsense_bf16_paths(torch, np, all_kernels, dev)
    log(f"[smoke] phase 30 in {ds_bf16['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 31. MOD_WIDE at -compute_dtype bfloat16: #4-bf16/#5-bf16 vs their
    # bf16 plain versions and timed; the bf16 steps beside the f32 ones, the
    # rate-0 step, the entry point and a served batch
    wide_bf16 = wide_bf16_paths(torch, np, all_kernels, gen, dev)
    log(f"[smoke] phase 31 in {wide_bf16['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 32. -pallas_mlp at -compute_dtype bfloat16: #10-bf16 to #12-bf16 vs
    # their bf16 plain versions and timed; the supervised steps of both
    # routes, the rate-0 step, the entry points and a served batch
    mlp_bf16 = mlp_bf16_paths(torch, np, all_kernels, dev)
    log(f"[smoke] phase 32 in {mlp_bf16['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 33. -no_pallas_block at -compute_dtype bfloat16: #6-bf16 to #9-bf16
    # vs their bf16 plain versions and timed; the bf16 steps beside the f32
    # ones, the rate-0 step, the entry point, a served batch and C12's width
    attn_bf16 = attention_bf16_paths(torch, np, all_kernels, dev)
    log(f"[smoke] phase 33 in {attn_bf16['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 34. #4-TP/#5-TP vs their plain versions at every local geometry of
    # MOD's and MOD_WIDE's stages at mp 2 and 4, the shards summed against #4
    # and #5 at full heads; timed on one of two shards of a MOD step; the
    # data-parallel forms timed on one of two data shards
    t34 = time.time()
    tpk = tp_kernel_paths(torch, np, pk, gen, dev)
    dp_forms = dp_form_times(torch, np, pk, fm, gen, dev)
    log(f"[smoke] phase 34 in {time.time() - t34:.1f}s (#4-TP/#5-TP {tpk['seconds']:.1f}s); "
        f"{time.time() - t_start:.1f}s after the build started")

    # ---- 36. #4-TP-bf16/#5-TP-bf16 vs their bf16 plain versions at every
    # local geometry of MOD's and MOD_WIDE's stages at mp 2 and 4, at D = C
    # the bits of #4-bf16/#5-bf16; timed on one of two shards of a MOD bf16
    # step; the conv tower's data-parallel form timed on one of two data
    # shards of a MOD DeepSense step, f32 and bf16
    t36 = time.time()
    tpb = tp_bf16_kernel_paths(torch, np, pk, gen, dev)
    dpt = dp_tower_times(torch, np, ct, dev)
    log(f"[smoke] phase 36 in {time.time() - t36:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 35. python -m focal_tpu_torch.train on two ranks sharing the card,
    # at -data_parallel 2 and at -model_parallel 2, at -model_parallel 2 in
    # bf16, DeepSense at -model_parallel 2 (f32, bf16) and with -pallas_conv
    # at -data_parallel 2 (f32, bf16); their rate-0 updates against the
    # single-process ones; their steps timed (after phase 36, whose kernels
    # its new layouts run)
    multi = multi_process_paths(torch, dev)
    log(f"[smoke] phase 35 in {multi['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 37. gradient accumulation and streaming: GradCache's pass 2
    # replaying pass 1 bit for bit through every training kernel, the
    # launches of an effective step exact; the rate-0 GradCache update of
    # 2 x 256 against the 512 step; the -grad_accum entry point resident and
    # streamed, bit for bit the same
    accum = accumulation_paths(torch, np, all_kernels, dev)
    log(f"[smoke] phase 37 in {accum['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    # ---- 38. sample files: the preprocessing CLIs on raw CSVs, the bulk
    # loader against the per-file read, the entry point fed from index files
    # (-dataset_config -gpu 0 -knn_backend jnp -profile_dir), traced
    files = files_paths(torch, np, all_kernels, dev)
    f_entry = files["entry"]["runs"]
    log(f"[files] entry point from files: wall {f_entry['files']['seconds']:.2f}s, step p50 "
        f"{f_entry['files']['p50_ms']:.3f} ms; synthetic-resident, the same flags: wall "
        f"{f_entry['synthetic']['seconds']:.2f}s, step p50 {f_entry['synthetic']['p50_ms']:.3f} ms; "
        f"phase 11's synthetic-resident MOD_WIDE entry point (1 epoch): wall "
        f"{cli_runs[0]['seconds']:.2f}s; phase 7's MOD step p50 {p50_ms:.3f} ms")
    log(f"[smoke] phase 38 in {files['seconds']:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    if cli.out:
        os.makedirs(cli.out, exist_ok=True)
        with open(os.path.join(cli.out, "chip_smoke.json"), "w") as f:
            json.dump({
                "card": card,
                "geometries": [{k: v for k, v in g.items() if k != "mask"} for g in geos],
                "train_geometries": [{k: v for k, v in g.items() if k != "mask"} for g in tgeos],
                "wide_geometries": [{k: v for k, v in g.items() if k != "mask"} for g in pgeos],
                "wide_stage0_geometries": [{k: v for k, v in g.items() if k != "mask"}
                                           for g in mono],
                "per_forward": tot, "per_step": ttot, "wide_per_step": wtot,
                "wide_stage0_per_step": stot, "train_device_ms_by_phase": train_split,
                "wide_stage0_device_ms_by_phase": wide_split,
                "wide_perhead_device_ms_by_phase": ph_split, "latency": lat,
                "launches": launches, "slice_err": slice_err, "profile": serve_profile,
                "train": train, "train_profile": train_profile, "wide": wide,
                "wide_profile": wide_profile, "train_cli": cli_runs,
                "tower_geometries": [{k: v for k, v in g.items() if k != "cfgs"} for g in cgeos],
                "tower_per_step": ctot, "deepsense_steps": ds_runs, "deepsense_rate0": rate0,
                "deepsense_cli": ds_cli, "deepsense_serve_latency": ds_lat,
                "mlp_geometries": mgeos, "mlp_per_forward": mtot, "supervised_steps": sup_runs,
                "supervised_rate0": sup_rate0, "classifier_cli": cls_runs,
                "serve_pallas_mlp_latency": mlp_lat, "serve_pallas_mlp_err": mlp_serve_err,
                "attention_geometries": {kind: [{k: v for k, v in g.items() if k != "mask"}
                                                for g in ags] for kind, ags in agen.items()},
                "attention_totals": atot, "no_pallas_block_steps": attn_train,
                "no_pallas_block_profile": attn_profile, "no_pallas_block_cli": attn_runs,
                "serve_no_pallas_block_latency": attn_lat,
                "serve_no_pallas_block_err": attn_serve_err,
                "serve_no_pallas_block_profile": attn_serve_profile,
                "serve_window_block_device_ms": serve_block_ms,
                "no_pallas_block_route_backward": route_bwd,
                "no_pallas_block_route_forward": route_fwd,
                "recipes": recipes, "two_locations": two_loc, "attribution": attribution,
                "bf16": bf16, "deepsense_bf16": ds_bf16, "wide_bf16": wide_bf16,
                "mlp_bf16": mlp_bf16, "attention_bf16": attn_bf16, "tp_kernels": tpk,
                "dp_forms": dp_forms, "multi_process": multi, "tp_bf16_kernels": tpb,
                "dp_towers": dpt, "accumulation": accum, "files": files,
            }, f, indent=1, default=str)

    def entry(name, replaces, launches_, err, ms, plain, bnd, flops_bytes, lib, per,
              source="focal_tpu_torch/csrc/window_block.cu", **extra):
        ops_t, byte_t = flops_bytes[0] / F32_FLOPS, flops_bytes[1] / HBM_BYTES_PER_S
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd,
                "bound_by": "operations" if ops_t >= byte_t else "bytes", "library_ms": lib,
                "per": per, **extra}

    by_path = {k.__name__: {"serve_MOD": serve_launches[k.__name__],
                            "pretrain_steps_MOD": train_launches[k.__name__],
                            "train_cli_MOD_WIDE": sum(r["launches"][k.__name__] for r in cli_runs),
                            "pretrain_steps_MOD_WIDE": wide["launches"][k.__name__],
                            "pretrain_steps_MOD_DeepSense_default":
                                ds_runs["deepsense-default"]["launches"][k.__name__],
                            "pretrain_steps_MOD_DeepSense_pallas_conv":
                                ds_runs["deepsense-pallas"]["launches"][k.__name__],
                            "pretrain_steps_MOD_WIDE_DeepSense_default":
                                ds_runs["deepsense-default-wide"]["launches"][k.__name__],
                            "pretrain_steps_MOD_WIDE_DeepSense_pallas_conv":
                                ds_runs["deepsense-pallas-wide"]["launches"][k.__name__],
                            "train_cli_MOD_DeepSense": sum(r["launches"][k.__name__] for r in ds_cli),
                            "serve_MOD_DeepSense": ds_serve_launches[k.__name__],
                            "supervised_steps_MOD_default":
                                sup_runs["supervised-default"]["launches"][k.__name__],
                            "supervised_steps_MOD_pallas_mlp":
                                sup_runs["supervised-pallas-mlp"]["launches"][k.__name__],
                            "supervised_rate0_step_MOD": sup_rate0["launches"].get(k.__name__, 0),
                            "classifier_cli_MOD_pallas_mlp":
                                sum(r["launches"][k.__name__] for r in cls_runs),
                            "serve_MOD_pallas_mlp": mlp_serve_launches[k.__name__],
                            "pretrain_steps_MOD_no_pallas_block": attn_train["launches"][k.__name__],
                            "pretrain_rate0_step_MOD_no_pallas_block":
                                attn_train["rate0_launches"][k.__name__],
                            "classifier_cli_MOD_no_pallas_block":
                                sum(r["launches"][k.__name__] for r in attn_runs),
                            "serve_MOD_no_pallas_block": attn_serve_launches[k.__name__]}
               for k in all_kernels}
    for path, run in new_runs.items():
        for k in all_kernels:
            by_path[k.__name__][path] = run["launches"][k.__name__]
    for path, run in attribution["paths"].items():
        for k in all_kernels:
            by_path[k.__name__][f"MOD {path}"] = run["launches"][k.__name__]
    new_errors = [res["errors"] for res in recipes.values()] + [two_loc["errors"]]

    def new_err(name):
        """The worst error of a kernel at phases 26-27's geometries (None where it ran none)."""
        errs = [e[name] for e in new_errors if name in e]
        return max(errs) if errs else None

    tower_new = [t for res in list(recipes.values()) + [two_loc] for t in res["towers"]]
    cli_launches = by_path[ph_fwd.__name__]["train_cli_MOD_WIDE"]
    train_per = (f"times: one pretrain step at batch {TRAIN_BATCH} (views fused to "
                 f"{2 * TRAIN_BATCH}), 16 launches; launches: {TRAIN_STEPS} timed steps")
    wide_per = (f"times: one MOD_WIDE pretrain step at batch {WIDE_BATCH} (views fused to "
                f"{2 * WIDE_BATCH}), {n_ph} launches; launches: the MOD_WIDE train CLI run "
                f"({sum(r['steps'] for r in cli_runs)} steps, "
                f"{sum(r['eval_forwards'] for r in cli_runs)} eval forwards)")
    tower_per = (f"times: the two conv towers of one MOD DeepSense pretrain step at batch "
                 f"{DS_BATCH} (views fused to {2 * DS_BATCH}; mod_wide_step: MOD_WIDE at "
                 f"{DS_WIDE_BATCH}); launches: {TRAIN_STEPS} timed MOD -pallas_conv steps; "
                 f"max_abs_err: worst over the MOD and MOD_WIDE towers (#14: every gradient, the "
                 f"near-zero conv-bias ones included)")

    MLP_SRC = "focal_tpu_torch/csrc/fused_mlp.cu"
    sup_mlp_launches = sup_runs["supervised-pallas-mlp"]["launches"]
    mlp_per = (f"times: the {per_fwd_mlp} MLPs of one MOD forward at batch {SUP_BATCH}; launches: "
               f"the -pallas_mlp served run ({mlp_batches} forwards)")
    mlp_step_per = (f"times: the {per_fwd_mlp} MLPs of one MOD supervised step at batch "
                    f"{SUP_BATCH} (dropout {mlp_rate}); launches: {TRAIN_STEPS} timed -pallas_mlp "
                    "supervised steps; max_abs_err: worst over the MOD and MOD_WIDE stage-0 "
                    "geometries")

    def train_extra(d):
        """#2's or #3's bounds on the tensor cores and by the design's bytes,
        device time by phase, and the MOD_WIDE stage-0 step's figures."""
        return {"bound_ms_tensor_cores": ttot[f"{d}_bound_tc_ms"],
                "bound_ms_design_bytes": ttot[f"{d}_bound_design_ms"],
                "device_ms_by_phase": train_split[d],
                "mod_wide_stage0": {
                    k: stot[f"{d}_{k}"] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_tc_ms", "bound_design_ms")}
                | {"device_ms_by_phase": wide_split[d],
                   "launches_per_step": wide_per_step[fwd_drop.__name__]}}

    def mlp_extra(d):
        """#10's, #11's or #12's bound on the tensor cores, device time by
        phase, and the MOD_WIDE stage-0 figures."""
        key = "fwd" if d == "drop" else d
        w = mtot["MOD_WIDE"]
        return {"bound_ms_tensor_cores": mod_mlp[f"{key}_bound_tc_ms"],
                "device_ms_by_phase": mod_mlp["device_ms_by_phase"][d],
                "mod_wide_stage0": {
                    "ms": w[f"{d}_ms"], "plain_ms": w[f"{d}_plain_ms"],
                    "library_ms": w[f"{d}_library_ms"], "bound_ms": w[f"{key}_bound_ms"],
                    "bound_ms_tensor_cores": w[f"{key}_bound_tc_ms"],
                    "device_ms_by_phase": w["device_ms_by_phase"][d],
                    "rows_of_samples": 2 * WIDE_BATCH, "launches": w["launches"]}}

    def per_wide(d):
        w = ctot["MOD_WIDE"]
        return {"ms": w[f"{d}_ms"], "plain_ms": w[f"{d}_plain_ms"],
                "library_ms": w[f"{d}_library_ms"], "bound_ms": w[f"{d}_bound_ms"],
                "bound_ms_tensor_cores": w[f"{d}_bound_tc_ms"],
                "device_ms_by_phase": w["device_ms_by_phase"][d], "batch": DS_WIDE_BATCH,
                "launches_per_step": ds_wide_per_step[(ct_fwd if d == "fwd" else ct_bwd).__name__]}

    kernels = [
        entry("fused_window_block", f"{PK}:949", launches, max_err, tot["ms"], tot["plain_ms"],
              tot["bound_ms"], (tot["flops"], tot["bytes"]), tot["library_ms"],
              f"times: one forward at batch {SERVE_BATCH}, 16 launches over {len(geos)} "
              f"geometries; launches: all {batches} forwards of the served run",
              launches_per_forward=per_fwd, forwards=batches, device_ms=tot["device_ms"],
              launches_by_path=by_path[fwd.__name__]),
        entry("fused_window_block_dropout", f"{PK}:1432", train_launches[fwd_drop.__name__],
              drop_err, ttot["fwd_ms"], ttot["fwd_plain_ms"], ttot["fwd_bound_ms"],
              (ttot["fwd_flops"], ttot["fwd_bytes"]), ttot["fwd_library_ms"], train_per,
              launches_per_step=per_fwd, steps=TRAIN_STEPS, **train_extra("fwd"),
              launches_by_path=by_path[fwd_drop.__name__]),
        entry("fused_window_block_backward", f"{PK}:971",
              train_launches[bwd.__name__], grad_abs, ttot["bwd_ms"],
              ttot["bwd_plain_ms"], ttot["bwd_bound_ms"], (ttot["bwd_flops"], ttot["bwd_bytes"]),
              ttot["bwd_library_ms"], train_per, launches_per_step=per_fwd, steps=TRAIN_STEPS,
              max_rel_err=grad_err, **train_extra("bwd"), launches_by_path=by_path[bwd.__name__]),
        entry("fused_window_block_perhead", f"{PK}:1123", cli_launches,
              max(ph_err, ph_drop_err), wtot["fwd_ms"], wtot["fwd_plain_ms"], wtot["fwd_bound_ms"],
              (wtot["fwd_flops"], wtot["fwd_bytes"]), wtot["fwd_library_ms"], wide_per, launches_per_step=n_ph,
              launches_per_eval_forward=wide_per_eval[ph_fwd.__name__],
              eval_forward_ms=wtot["eval_ms"], bound_ms_tensor_cores=wtot["fwd_bound_tc_ms"],
              device_ms_by_phase=ph_split["fwd"], launches_by_path=by_path[ph_fwd.__name__]),
        entry("fused_window_block_perhead_backward", f"{PK}:1166",
              by_path[ph_bwd.__name__]["train_cli_MOD_WIDE"], ph_grad_abs, wtot["bwd_ms"],
              wtot["bwd_plain_ms"], wtot["bwd_bound_ms"], (wtot["bwd_flops"], wtot["bwd_bytes"]),
              wtot["bwd_library_ms"],
              wide_per, launches_per_step=n_ph, max_rel_err=ph_grad_err,
              bound_ms_tensor_cores=wtot["bwd_bound_tc_ms"], device_ms_by_phase=ph_split["bwd"],
              launches_by_path=by_path[ph_bwd.__name__]),
        entry("fused_conv_tower", f"{CT}:174", by_path[ct_fwd.__name__][
                  "pretrain_steps_MOD_DeepSense_pallas_conv"], ct_fwd_err, mod_tot["fwd_ms"],
              mod_tot["fwd_plain_ms"], mod_tot["fwd_bound_ms"],
              (mod_tot["fwd_flops"], mod_tot["fwd_bytes"]), mod_tot["fwd_library_ms"], tower_per,
              source="focal_tpu_torch/csrc/conv_tower.cu", replaces_also=[f"{CT}:163"],
              launches_per_step=ds_per_step[ct_fwd.__name__], steps=TRAIN_STEPS,
              max_rel_err=max(g["max_rel_err_fwd"] for g in cgeos),
              bound_ms_tensor_cores=mod_tot["fwd_bound_tc_ms"],
              device_ms_by_phase=mod_tot["device_ms_by_phase"]["fwd"],
              mod_wide_step=per_wide("fwd"), launches_by_path=by_path[ct_fwd.__name__]),
        entry("fused_conv_tower_backward", f"{CT}:230", by_path[ct_bwd.__name__][
                  "pretrain_steps_MOD_DeepSense_pallas_conv"], ct_grad_abs, mod_tot["bwd_ms"],
              mod_tot["bwd_plain_ms"], mod_tot["bwd_bound_ms"],
              (mod_tot["bwd_flops"], mod_tot["bwd_bytes"]), mod_tot["bwd_library_ms"], tower_per,
              source="focal_tpu_torch/csrc/conv_tower.cu",
              replaces_also=[f"{CT}:206", f"{CT}:257"],
              launches_per_step=ds_per_step[ct_bwd.__name__], steps=TRAIN_STEPS,
              max_rel_err=ct_grad_rel, max_abs_err_near_zero=ct_grad_near,
              bound_ms_tensor_cores=mod_tot["bwd_bound_tc_ms"],
              device_ms_by_phase=mod_tot["device_ms_by_phase"]["bwd"],
              mod_wide_step=per_wide("bwd"), launches_by_path=by_path[ct_bwd.__name__]),
        entry("fused_mlp_forward", f"{PK}:527", by_path[mlp_fwd.__name__]["serve_MOD_pallas_mlp"],
              mlp_err["fwd"], mod_mlp["fwd_ms"], mod_mlp["fwd_plain_ms"], mod_mlp["fwd_bound_ms"],
              (mod_mlp["fwd_flops"], mod_mlp["fwd_bytes"]), mod_mlp["fwd_library_ms"], mlp_per,
              source=MLP_SRC, launches_per_forward=per_fwd_mlp, forwards=mlp_batches,
              **mlp_extra("fwd"), launches_by_path=by_path[mlp_fwd.__name__]),
        entry("fused_mlp_dropout_forward", f"{PK}:537", sup_mlp_launches[mlp_drop.__name__],
              mlp_err["drop"], mod_mlp["drop_ms"], mod_mlp["drop_plain_ms"], mod_mlp["fwd_bound_ms"],
              (mod_mlp["fwd_flops"], mod_mlp["fwd_bytes"]), mod_mlp["drop_library_ms"], mlp_step_per,
              source=MLP_SRC, launches_per_step=per_fwd_mlp, steps=TRAIN_STEPS,
              **mlp_extra("drop"), launches_by_path=by_path[mlp_drop.__name__]),
        entry("fused_mlp_backward", f"{PK}:590", sup_mlp_launches[mlp_bwd.__name__],
              mlp_err["bwd_abs"], mod_mlp["bwd_ms"], mod_mlp["bwd_plain_ms"], mod_mlp["bwd_bound_ms"],
              (mod_mlp["bwd_flops"], mod_mlp["bwd_bytes"]), mod_mlp["bwd_library_ms"], mlp_step_per,
              source=MLP_SRC, replaces_also=[f"{PK}:601"], launches_per_step=per_fwd_mlp,
              steps=TRAIN_STEPS, max_rel_err=mlp_err["bwd"], ms_without_masks=mod_mlp["bwd_nomask_ms"],
              **mlp_extra("bwd"), launches_by_path=by_path[mlp_bwd.__name__]),
    ]
    a_serve = atot["serve"]
    attn_step_per = (f"times: the {per_fwd} launches of one MOD training step at batch "
                     f"{TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH}; dropout {rate})")

    def attn_entry(name, line, kernel, d, tot_k, per, err, **extra):
        return entry(name, f"{PK}:{line}", extra.pop("launches"), err, tot_k[f"{d}_ms"],
                     tot_k[f"{d}_plain_ms"], tot_k[f"{d}_bound_ms"],
                     (tot_k[f"{d}_flops"], tot_k[f"{d}_bytes"]), tot_k[f"{d}_library_ms"], per,
                     source=ATTN_SRC, launches_by_path=by_path[kernel.__name__], **extra)

    kernels += [
        attn_entry("fused_window_attention", 119, at_fwd, "fwd", a_serve,
                   f"times: the {per_fwd} launches of one MOD forward at batch {SERVE_BATCH}; "
                   f"launches: the -no_pallas_block served run ({attn_batches} forwards); "
                   "max_abs_err: worst over the MOD and MOD_WIDE geometries", at_err["fwd"],
                   launches=attn_serve_launches[at_fwd.__name__], launches_per_forward=per_fwd,
                   forwards=attn_batches, device_ms_in_profiled_batch=attn_serve_device_ms,
                   device_ms=a_serve["fwd_device_ms"],
                   bound_share_by_device_ms=a_serve["fwd_bound_ms"] / a_serve["fwd_device_ms"],
                   route_forward_eval_copy_kernel_ms=route_fwd["eval"]["copy_kernel_ms"]),
        attn_entry("fused_window_attention_dropout", 129, at_drop, "drop", a_train,
                   attn_step_per + f"; launches: {TRAIN_STEPS} timed -no_pallas_block pretrain steps",
                   at_err["drop"], launches=attn_train["launches"][at_drop.__name__],
                   launches_per_step=per_fwd, steps=TRAIN_STEPS, device_ms_in_profiled_step=
                   attn_train["attention_kernels_device_ms"]["wattn_fwd_kernel"],
                   device_ms=a_train["drop_device_ms"],
                   bound_share_by_device_ms=a_train["drop_bound_ms"] / a_train["drop_device_ms"],
                   route_forward_train_copy_kernel_ms=route_fwd["train"]["copy_kernel_ms"]),
        attn_entry("fused_window_attention_backward", 189, at_bwd, "bwd", a_train,
                   attn_step_per.replace(f"dropout {rate}", "every drop rate 0")
                   + "; launches: the -no_pallas_block rate-0 step", at_err["bwd_abs"],
                   launches=attn_train["rate0_launches"][at_bwd.__name__],
                   launches_per_step=per_fwd, max_rel_err=at_err["bwd"],
                   device_ms=a_train["bwd_device_ms"]),
        attn_entry("fused_window_attention_dropout_backward", 200, at_drop_bwd, "drop_bwd", a_train,
                   attn_step_per + f"; launches: {TRAIN_STEPS} timed -no_pallas_block pretrain steps",
                   at_err["bwd_abs"], launches=attn_train["launches"][at_drop_bwd.__name__],
                   launches_per_step=per_fwd, steps=TRAIN_STEPS, max_rel_err=at_err["bwd"],
                   device_ms=a_train["drop_bwd_device_ms"], device_ms_in_profiled_step=
                   attn_train["attention_kernels_device_ms"]["wattn_bwd_kernel"],
                   route_backward_copy_kernel_ms=route_bwd["copy_kernel_ms"]),
    ]
    for k in kernels:
        k["max_abs_err_recipes_and_two_locations"] = new_err(k["name"])
        if k["name"].startswith("fused_conv_tower"):
            d = "bwd" if k["name"].endswith("backward") else "fwd"
            k["recipes_and_two_locations_geometries"] = [
                {key: t[key] for key in ("name", "R", "S", "C", "cin", "kw", "external", "towers")}
                | {"ms": t[f"{d}_ms"], "plain_ms": t[f"{d}_plain_ms"],
                   "library_ms": t[f"{d}_library_ms"], "bound_ms": t[f"{d}_bound_ms"],
                   "bound_ms_tensor_cores": t[f"{d}_bound_tc_ms"]} for t in tower_new]
    for k in kernels:
        if k["name"] in attribution["tail_kernels"]:
            k["ragged_tail_step"] = attribution["tail_kernels"][k["name"]] | {
                "launches_by_path": {p: r["launches"][k["name"]]
                                     for p, r in attribution["paths"].items()}}
    def bf16_entry(name, num, line, launches_, err, tot, per,
                   source="focal_tpu_torch/csrc/window_block.cu", **extra):
        by = ("operations" if tot["flops"] / BF16_FLOPS >= tot["bytes"] / HBM_BYTES_PER_S
              else "bytes")
        return {"name": name, "kernel": num, "route": "cuda",
                "source": source, "replaces": f"{PK}:{line}",
                "launches": launches_, "max_abs_err": err, "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"], "bound_by": by,
                "library_ms": tot["library_ms"], "per": per, "device_ms": tot["device_ms"],
                "flops": tot["flops"], "bytes": tot["bytes"], **extra}

    be, bpaths = bf16["errors"], bf16["paths"]
    bf_pre = bpaths["pretrain -compute_dtype bfloat16 -ragged_tail -epochs 2"]["launches"]
    bf_step_launches = bf16["steps"]["bfloat16"]["launches"]
    bf16_step_per = (f"times: the {per_fwd} launches of one MOD bf16 training step at batch "
                     f"{TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH}); launches: "
                     f"{TRAIN_STEPS} timed bf16 pretrain steps; bound at 989 TFLOP/s bf16 or "
                     "3.35 TB/s at bf16 activation bytes")
    kernels += [
        bf16_entry("fused_window_block_bf16", "#1-bf16", 949, bf_pre[bf_fwd.__name__],
                   be["fwd_abs"], bf16["serve_forward"],
                   f"times: the {per_fwd} launches of one MOD bf16 forward at batch "
                   f"{SERVE_BATCH}; launches: the bf16 pretrain entry point's eval forwards; "
                   "bound at 989 TFLOP/s bf16 or 3.35 TB/s at bf16 activation bytes",
                   max_rel_err=be["fwd"], device_ms_by_phase=bf16["serve_fwd_device_ms_by_phase"],
                   launches_by_path={p: r["launches"][bf_fwd.__name__] for p, r in bpaths.items()}
                   | {"serve_MOD_bf16": bf16["serve"]["launches"][bf_fwd.__name__]}),
        bf16_entry("fused_window_block_dropout_bf16", "#2-bf16", 1432,
                   bf_step_launches[bf_drop.__name__], be["drop_abs"], bf16["train_step"]["fwd"],
                   bf16_step_per, max_rel_err=be["drop"], launches_per_step=per_fwd,
                   device_ms_by_phase=bf16["train_fwd_device_ms_by_phase"],
                   launches_by_path={p: r["launches"][bf_drop.__name__] for p, r in bpaths.items()}),
        bf16_entry("fused_window_block_backward_bf16", "#3-bf16", 971,
                   bf_step_launches[bf_bwd.__name__], be["bwd_abs"], bf16["train_step"]["bwd"],
                   bf16_step_per, max_rel_err=be["bwd"], launches_per_step=per_fwd,
                   device_ms_by_phase=bf16["train_bwd_device_ms_by_phase"],
                   launches_by_path={p: r["launches"][bf_bwd.__name__] for p, r in bpaths.items()}),
    ]
    de, dstep = ds_bf16["errors"], ds_bf16["step"]
    ds_bf16_launches = ds_bf16["steps"]["ds-bf16-pallas-bfloat16"]["launches"]
    ds_bf16_per = (f"times: the towers of one MOD DeepSense bf16 pretrain step at batch "
                   f"{DS_BATCH} (views fused to {2 * DS_BATCH}); launches: {TRAIN_STEPS} timed "
                   "-pallas_conv bf16 pretrain steps; max_abs_err: worst over the MOD, MOD_WIDE, "
                   "recipe and two-location towers against the bf16 plain tower; bound: the convs "
                   "at 989 TFLOP/s bf16 and the rest at the f32 peak, or the bytes at bf16 rows")

    def tower_bf16_entry(name, num, line, d, err, **extra):
        t = dstep[d]
        return {"name": name, "kernel": num, "route": "cuda",
                "source": "focal_tpu_torch/csrc/conv_tower.cu", "replaces": f"{CT}:{line}",
                "launches": ds_bf16_launches[name], "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "per": ds_bf16_per, "device_ms": t["device_ms"],
                "f32_ms": t["f32_ms"], "f32_device_ms": t["f32_device_ms"],
                "device_ms_by_phase": t["device_ms_by_phase"], "flops": t["flops"],
                "bytes": t["bytes"], "launches_per_step": ds_bf16_launches[name] // TRAIN_STEPS,
                "launches_by_path": {p: r["launches"][name]
                                     for p, r in ds_bf16["paths"].items()}, **extra}

    kernels += [
        tower_bf16_entry(ct_bf_fwd.__name__, "#13-bf16", 174, "fwd", de["fwd_abs"],
                         replaces_also=[f"{CT}:163"], max_rel_err=de["fwd"],
                         max_rel_err_stats=de["stats"]),
        tower_bf16_entry(ct_bf_bwd.__name__, "#14-bf16", 230, "bwd", de["bwd_abs"],
                         replaces_also=[f"{CT}:206", f"{CT}:257"], max_rel_err=de["bwd"],
                         max_abs_err_near_zero=de["bwd_near"]),
    ]
    we, wstep = wide_bf16["errors"], wide_bf16["train_step"]
    wide_bf16_launches = wide_bf16["steps"]["bfloat16"]["launches"]
    wide_bf16_per = (f"times: the {wide_bf16['launches_per_step'][ph_bf_fwd.__name__]} per-head "
                     f"launches of one MOD_WIDE bf16 training step at batch {WIDE_BATCH} (views "
                     f"fused to {2 * WIDE_BATCH}); launches: {WIDE_STEPS} timed MOD_WIDE bf16 "
                     "pretrain steps; bound at 989 TFLOP/s bf16 or 3.35 TB/s at bf16 activation "
                     "bytes")

    def wide_bf16_entry(name, num, line, d, err, **extra):
        return bf16_entry(name, num, line, wide_bf16_launches[name], err, wstep[d], wide_bf16_per,
                          launches_per_step=wide_bf16["launches_per_step"][name],
                          steps=WIDE_STEPS, device_ms_by_phase=wide_bf16[f"train_{d}_device_ms_by_phase"],
                          launches_by_path={p: r["launches"][name]
                                            for p, r in wide_bf16["paths"].items()}
                          | {"serve_MOD_WIDE_bf16": wide_bf16["serve"]["launches"][name],
                             "rate0_step_MOD_WIDE_bf16": wide_bf16["rate0"]["launches"][name]},
                          **extra)

    kernels += [
        wide_bf16_entry(ph_bf_fwd.__name__, "#4-bf16", 1123, "fwd", we["fwd_abs"],
                        max_rel_err=we["fwd"]),
        wide_bf16_entry(ph_bf_bwd.__name__, "#5-bf16", 1166, "bwd", we["bwd_abs"],
                        max_rel_err=we["bwd"]),
    ]
    me, mpaths = mlp_bf16["errors"], mlp_bf16["paths"]
    mlp_bf16_launches = mlp_bf16["steps"]["mlp-bf16-steps-pallas-mlp"]["launches"]
    mlp_bf16_serve = mlp_bf16["serve"]["launches"]
    mlp_bf16_per = (f"times: the {mlp_bf16['launches_per_step'][mlp_bf_drop.__name__]} MLPs of one "
                    f"MOD forward at batch {SUP_BATCH} (mod_wide_stage0: MOD_WIDE stage 0 at "
                    f"{WIDE_BATCH} fused to {2 * WIDE_BATCH}); launches: {MLP_BF16_STEPS} timed "
                    "bf16 -pallas_mlp supervised steps (#10-bf16: the served bf16 -pallas_mlp "
                    "batch); max_abs_err: worst over the MOD and MOD_WIDE stage-0 geometries; "
                    "bound at 989 TFLOP/s bf16 or 3.35 TB/s at bf16 activation bytes")

    def mlp_bf16_entry(name, num, line, d, launches_, err, **extra):
        return bf16_entry(name, num, line, launches_, err, mlp_bf16["MOD_forward"][d],
                          mlp_bf16_per, source=MLP_SRC,
                          device_ms_by_phase=mlp_bf16["MOD_forward"][d]["device_ms_by_phase"],
                          mod_wide_stage0={k: v for k, v in mlp_bf16["MOD_WIDE_forward"][d].items()},
                          launches_by_path={p: r["launches"][name] for p, r in mpaths.items()}
                          | {"serve_MOD_bf16_pallas_mlp": mlp_bf16_serve[name],
                             "rate0_step_MOD_bf16_pallas_mlp": mlp_bf16["rate0"]["launches"][name]},
                          **extra)

    kernels += [
        mlp_bf16_entry(mlp_bf_fwd.__name__, "#10-bf16", 527, "fwd", mlp_bf16_serve[mlp_bf_fwd.__name__],
                       me["fwd_abs"], max_rel_err=me["fwd"],
                       launches_per_forward=mlp_bf16["launches_per_eval_forward"][mlp_bf_fwd.__name__]),
        mlp_bf16_entry(mlp_bf_drop.__name__, "#11-bf16", 537, "drop",
                       mlp_bf16_launches[mlp_bf_drop.__name__], me["drop_abs"], max_rel_err=me["drop"],
                       launches_per_step=mlp_bf16["launches_per_step"][mlp_bf_drop.__name__],
                       steps=MLP_BF16_STEPS),
        mlp_bf16_entry(mlp_bf_bwd.__name__, "#12-bf16", 590, "bwd",
                       mlp_bf16_launches[mlp_bf_bwd.__name__], me["bwd_abs"], max_rel_err=me["bwd"],
                       replaces_also=[f"{PK}:601"],
                       launches_per_step=mlp_bf16["launches_per_step"][mlp_bf_bwd.__name__],
                       steps=MLP_BF16_STEPS),
    ]
    ae, apaths = attn_bf16["errors"], attn_bf16["paths"]
    attn_bf16_launches = attn_bf16["steps"]["bfloat16"]["launches"]
    attn_bf16_per = (f"times: the {per_fwd} launches of one MOD bf16 -no_pallas_block training "
                     f"step at batch {TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH}; #8-bf16 at "
                     f"every drop rate 0); launches: {ATTN_BF16_STEPS} timed bf16 -no_pallas_block "
                     "pretrain steps (#8-bf16: the rate-0 step); max_abs_err: worst over the served "
                     "and training geometries; bound: the products at 989 TFLOP/s bf16 and the "
                     "softmax at 67 TFLOP/s f32, or 3.35 TB/s at bf16 rows")

    def attn_bf16_entry(name, num, line, launches_, tot, err, per=attn_bf16_per, **extra):
        return bf16_entry(name, num, line, launches_, err, tot, per, source=ATTN_SRC,
                          bound_by=bound(tot["flops"], tot["bytes"])[1], launches_by_path={p: r["launches"][name] for p, r in apaths.items()}
                          | {"serve_MOD_bf16_no_pallas_block": attn_bf16["serve"]["launches"][name],
                             "rate0_step_MOD_bf16_no_pallas_block":
                                 attn_bf16["rate0"]["launches"][name]}, **extra)

    kernels += [
        attn_bf16_entry(at_bf_fwd.__name__, "#6-bf16", 119,
                        attn_bf16["serve"]["launches"][at_bf_fwd.__name__], attn_bf16["serve_forward"],
                        ae["fwd_abs"],
                        per=(f"times: the {per_fwd} launches of one MOD bf16 -no_pallas_block "
                             f"forward at batch {SERVE_BATCH}; launches: the served bf16 "
                             "-no_pallas_block batch; bound: the products at 989 TFLOP/s "
                             "bf16 and the softmax at 67 TFLOP/s f32, or "
                             "3.35 TB/s at bf16 rows"),
                        max_rel_err=ae["fwd"], launches_per_forward=per_fwd),
        attn_bf16_entry(at_bf_drop.__name__, "#7-bf16", 129,
                        attn_bf16_launches[at_bf_drop.__name__], attn_bf16["train_step"]["drop"],
                        ae["drop_abs"], max_rel_err=ae["drop"], launches_per_step=per_fwd,
                        steps=ATTN_BF16_STEPS),
        attn_bf16_entry(at_bf_bwd.__name__, "#8-bf16", 189,
                        attn_bf16["rate0"]["launches"][at_bf_bwd.__name__],
                        attn_bf16["train_step"]["bwd"], ae["bwd_abs"], max_rel_err=ae["bwd"],
                        launches_per_step=per_fwd),
        attn_bf16_entry(at_bf_drop_bwd.__name__, "#9-bf16", 200,
                        attn_bf16_launches[at_bf_drop_bwd.__name__],
                        attn_bf16["train_step"]["drop_bwd"], ae["bwd_abs"], max_rel_err=ae["bwd"],
                        launches_per_step=per_fwd, steps=ATTN_BF16_STEPS),
    ]
    kernels += multi_process_entries(tpk, dp_forms, multi, tpb, dpt)
    # phase 37's paths: each kernel's launches in one GradCache update of a
    # replay case, the rate-0 update, the -grad_accum entry points; phase
    # 35's sharded dp 2 entry point (both ranks)
    accum_paths = {f"gradcache_update_{c}": r["launches"] for c, r in accum["replay"].items()}
    accum_paths["gradcache_rate0_update_MOD"] = accum["exact"]["launches_gradcache"]
    accum_paths.update({f"train_cli_MOD_grad_accum_{n}": accum["entry"][n]["launches"]
                        for n in ("resident", "streamed")})
    sharded = multi["layouts"]["dp2_sharded"]["ranks"]
    accum_paths["train_cli_MOD_dp2_sharded"] = {n: sum(r["cli_launches"][n] for r in sharded)
                                                for n in sharded[0]["cli_launches"]}
    for e in kernels:
        for path, got in accum_paths.items():
            if got.get(e["name"]):
                e.setdefault("launches_by_path", {})[path] = got[e["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
