#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tunevlseg_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its numbers on lines of its own:
  1. device: the CUDA card's name, the device count, and nvidia-smi's name
     and power limit (exits nonzero without a CUDA device);
  2. build: kernels K1 (csrc/flash_attn_fwd.cu), K2 (csrc/flash_attn_bwd.cu),
     K3 (csrc/flash_attn_bias_fwd.cu), K4 (csrc/conv_flat.cu) and the sweeps'
     S1-S4 (csrc/flash_attn_fwd_variants.cu) built from source side by side,
     timed, with the registers and spills `ptxas -v` reports for each kernel;
  3. kernel vs plain: K1 against `flash_attention_ref` (its output, and with
     the log-sum-exp a backward asks for: output bit-identical, lse against
     the plain version's, K1 timed with and without the lse write, and its
     device time from torch.profiler) and K2
     against `flash_attention_bwd_ref` on the lse K1 wrote, as a train step
     calls it, and against the plain version without it (p = e / sum e);
     two calls bit-identical; the device time of K2's two kernels, the dq
     pass with its delta sweep and the dk/dv pass) at the CLIPSeg vision and decoder
     shapes (485 tokens, and 489 with four visual contexts), a kv_valid case
     (masked dk/dv rows exactly zero), the two batch-16 shapes of the e2e
     train step and the CRIS decoder's b64 x 676 x 8 x 64; the host time of
     a K1 call at D = 64 and 16 (perf_counter over 1000 calls at the b1
     request's shapes, no synchronize, beside the kernel's device time); K3
     against `biased_attention_ref` at the text shape (U = 1 and U = 64 rows,
     causal + padding bias), the CRIS cross shape (676 queries into 77
     keys, key-padding bias) and the edges of its tiling (S = 129, T = 65,
     80, 81, 128, 129 and 245, kv_valid at a key-tile edge, -inf over a whole
     key tile, rows entirely at dtype-min; D = 16, 32, 64): max abs error
     against the stated bound, two calls bit-identical, times from CUDA
     events beside the device time from torch.profiler, the host time of a
     call at U = 1, and each kernel's bound (the larger of bytes over the
     memory rate and operations over the bf16 tensor-core rate); K1, K2 and
     K3 at D = 96 (phase 25's shapes). A device time (`kernel_device_ms`)
     is each kernel's recorded time over its recorded launches, with the
     L2 flushed before each call; the launches recorded must be the calls
     made times the launches a call, and the time at least the bound. The
     device times are all taken before phase 4 and the model paths;
  4. yardstick: `F.scaled_dot_product_attention` forward and backward at the
     same shapes (with the same mask for K3 and for kv_valid), printed beside
     the kernels and used nowhere in the port, after the K4 checks;
  5. serve, CLIPSeg: three requests through `serving.task_predict_fn` on the
     full-width bf16 CLIPSeg rd64 + CoOp (depth 3, 4 contexts) model with
     seeded random weights: batch 64 with one deduplicated prompt, batch 64
     with dense prompts, batch 1. Checks the output shape, range and
     finiteness, 13 K1 and 12 K3 launches per forward and no K2 launch, and
     the first request against the same model with every attention on the
     plain path;
  6. train, CLIPSeg CoOp: 2 warm-up + 5 timed steps of
     `SegmentationTask.train_step` on a b64 prompt-dedup batch: 13 K1, 3 K2
     and 12 K3 launches per step, finite loss, the context vectors change,
     every frozen tensor stays bit-identical, and the first step's loss and
     context gradient agree with the same step taken with every attention on
     the plain path;
  7. train, CLIPSeg e2e: the same model with everything trainable, b16 dense
     prompts (b16 keeps the whole script short), 2 warm-up + 6 steps: 13 K1,
     13 K2 and 12 K3 launches per step, finite loss, the loss falls;
  8. serve, CRIS: the full-width bf16 CRIS RN50 + CoOp (depth 3, 4 contexts)
     model at 416^2, the same three requests: 3 K1 and 15 K3 launches per
     forward and no K2, kernel path against plain path; then one b64 request
     on the stock (e2e) CRIS model;
  9. train, CRIS CoOp: 2 warm-up + 5 timed steps at b64 with prompt dedup and
     the decoder's dropout on: 3 K1, 3 K2 and 15 K3 launches per step, finite
     loss, the context vectors and the additive head change, every frozen
     tensor and every BatchNorm buffer stays bit-identical, and the first
     step's loss and gradients agree with the plain path.
 10. kernel vs plain, K4: the flat convolution against `conv_flat_ref` at the
     RN50's own shapes at b64 and 416^2 (stem, stage 1, 2 and 4, 3x3 and 1x1,
     with and without affine, ReLU and residual, and the dx form with the
     flipped weight): max abs error against the stated bound, guard and ring
     rows exactly zero, times from CUDA events, the bound from the pixel
     work, and `F.conv2d` in bf16 channels-last beside it (the convolution
     alone: the epilogue is not in it) and K4's time over it; then the
     backward of the `autograd.Function` (dx, dW, d_scale, d_offset,
     d_residual) against autograd through the plain version, beside
     `F.conv2d`'s backward, and the backward's prologue kernel (dy * scale,
     dy, per-block sums of dy) against its plain version;
 11. serve, CRIS flat: the same CRIS model built with `layout="flat"`: the
     b64 dedup request and b1; 3 K1, 15 K3 and 54 K4 launches per forward,
     and the probabilities against the same weights on `layout="nchw"`;
 12. train, CRIS flat CoOp: 2 warm-up + 3 timed b64 steps: 3 K1, 3 K2, 15 K3
     and 54 K4 forward launches per step and no K4 dx launch (the backbone
     is frozen), frozen tensors and BatchNorm buffers bit-identical;
 13. train, CRIS e2e, at b16 with `mutable_collections=("batch_stats",)`:
     (a) the default (towers frozen, "nchw"): the loss falls, the FPN's and
     the projector's running statistics move in the train state, the
     backbone's do not; (b) the full fine-tune on `layout="flat"`: 54 K4
     forward, 54 K4 dx and 54 prologue launches per step, backbone
     convolution weights and BatchNorm weight / bias change, the first
     step's loss against the same step on `layout="nchw"`, and every
     gradient of the backbone for a fixed cotangent on its pyramid against
     `layout="nchw"`.
 14. kernel vs plain, S1-S4, through the sweeps' entry points
     (`scripts/torch_micro_attn.py: check_variants, time_variants`), one pass
     per sweep: every variant of K1 (`ops/flash_attention_variants.py`: heads
     / batch rows per block, block order, exp2, no max pass, the two products
     alone; and S3, the denominator out of the P V product) against its plain
     version on q, k, v apart, then timed with the variants' launch counts
     set to 0 before and read after; at the vision shape b64 x 485 x 12 x 64,
     and S2 / S3 also at 512 with the keys from 485 on masked; the v2
     sweep's "hg1 exp2" row (K1's own instance of the forward body) printed
     beside K1's time in the same turns. The same two counts are read on
     every model path, where they must stay 0;
 15. serve and train, CLIPSeg MaPLe (depth 3, 4 contexts; visual contexts in
     the frozen vision tower, 489 tokens): the three requests (13 K1 and 12
     K3 per forward), kernel path against plain path; 2 warm-up + 5 timed
     b64 prompt-dedup steps: 13 K1, 13 K2 and 12 K3 per step (K2 at the
     vision shape inside a prompt-tuning step), the learner and the additive
     head move, every frozen tensor stays bit-identical and has no gradient,
     first step against the plain path;
 16. VPT, Shared-Separate, Shared-Attention (the same launches) and CoCoOp
     (dense text: 15 K1 and 12 K3 at 64 rows per forward, 3 K2 per step: the
     vision tower stays forward-only): one b64 request and 1 warm-up + 2
     timed steps each, checked the same way;
 17. CRIS CoCoOp on `layout="nchw"`: one b64 request and one train step. Its
     probabilities get a wider bound against the plain path, earned in the
     run: every K1 / K3 launch of the forward against its plain version on
     the path's own tensors, and two kernel-free paths that differ as much.
 18. fit, CLIPSeg CoOp (run right after phase 7): `Trainer.fit` on a new
     instance of phase 6's model (same seed) over an in-memory dataset (256 train, 64 val, 64 test
     samples, uint8 352^2, one prompt) through the threaded `DataLoader` at
     b64 with `text_dedup=1` (each batch pinned and copied to the card
     without blocking): 2 epochs of 4 steps,
     metrics logged every 2 steps, an interval snapshot every 3, the plateau
     scheduler, early stopping, jsonl + csv. Checks 13 K1, 3 K2 and 12 K3
     launches per train step and 13 / 0 / 12 per forward (validation and
     its image panel) over the whole fit, finite val metrics, `best`,
     `last` and `frozen` written, frozen tensors bit-identical, the context
     vectors moved; then a run that gets SIGTERM as its 5th batch is handed
     out and a resume from its `last`: trainable tensors, optimizer moments,
     step, learning rate, scheduler and early-stopping state and best value
     bit-identical to the uninterrupted run; `test(use_best=True)` puts the
     best checkpoint's weights in the model; `predict` gives 64 masks of
     352^2 in [0, 1]. Prints the loop's ms a step (host clock over an
     epoch's train part) beside phase 6's bare step, the loader alone, the
     loop over batches made beforehand, a save's blocking and writing ms and
     bytes, `save_frozen`'s, and the peak device memory over the fit.
 19. kernel vs plain, K4 at the TransformerSegmentor's five upsampler
     convolutions at b32 (512 -> 410 at 39^2 ... 104 -> 1 at 352^2), C and
     Cout zero-padded to multiples of 8 around the launch: against its plain
     version on the same flat tensors, the padded output channels exactly 0,
     `conv3_flat` against `F.conv2d`, timed beside the nchw layout's
     `F.conv2d` (phase 10's K4 numbers gain these shapes; phase 3's K1 / K2,
     phase 4's yardstick and K3's cases gain the TransformerSegmentor's and
     PhraseCut's attention shapes: b32·485·12·64, b32·485·8·64,
     b16·576·12·64, b16·576·16·32 (D = 32), the cross-attentions 485 -> 77
     and 576 -> 64 and SigLIP's 64 padded text tokens; K4's backward there
     against its bound; and DenseCLIP's: K1 / K2 at
     b16·257·32·64, also with the keys from 129 on masked, and at
     b2·1601·12·64; K3 at the text's 150·13·8·64 and 2400·13·8·64 under the
     causal bias, and unbiased from 150 queries into 257 and 1601 keys);
 20. serve and train, TransformerSegmentor (`bench.py`'s trans_seg row: CLIP
     ViT-B/16 and text towers at 352^2, decoder 4 x 8 heads, upsampler 5
     stages, everything trainable, AdamW lr 2e-4, seeded random weights):
     b32 dense, b32 with one prompt and b1 through `task_predict_fn`, 16 K1
     and 16 K3 per forward, the first request against the plain path; 2
     warm-up + 5 timed b32 dense steps with 16 K1, 16 K2 and 16 K3 each, the
     loss falls, every leaf with a gradient moves (the vision tower's
     post_layernorm, which only the unread pooled output uses, has none and
     keeps its value), the first step's loss and gradients against the plain
     path; then the same model on `upsampler_layout="flat"`: one b32 request
     (+5 K4) with its probabilities against "nchw", the first step's loss
     against "nchw", 1 + 2 steps with 5 K4, 5 K4 dx and 5 prologue launches
     each;
 21. serve and train, PhraseCut (`experiment=phrasecut`: SigLIP towers with
     the existing projections, frozen, decoder 16 heads of 32, output bias,
     DiceCE with BCE weight 5.8, 384^2): one b16 request with one prompt
     against the plain path (16 K1, 16 K3), 1 + 2 b16 dense steps (16 K1, 4
     K2, 16 K3), the towers' and projections' tensors bit-identical and
     without a gradient, every decoder and upsampler leaf moved.
 22. serve and train, DenseCLIP (the ADE-150 recipe: RN50 at 512^2, text 12
     x 8 heads over 150 classes x 13 tokens, context decoder, FPN head,
     AdamW 1e-4 with the backbone at x 0.1, poly + a 2-step warm-up, bn_train;
     seeded random weights, synthetic class ids): a b16 whole-image request
     and a 6-window slide request (one 512 x 2048 image, crop 512, stride 341)
     through `models/denseclip/inference.py`, 1 K1 and 15 K3 per forward, the
     class probabilities against the plain path, every K1 / K3 launch of a
     forward against its plain version on the path's own tensors; the same
     weights on `backbone_layout="flat"` (+54 K4), every K4 launch against
     its plain version on the path's own tensors, the log-probabilities
     against "nchw"; 1 + 3 b16 train steps (1 K1, 1 K2, 15 K3 a step):
     contexts, gamma, backbone and head weights and the BatchNorm statistics
     in the state move, the text encoder stays bit-identical, the first
     step's loss (relative gap 1e-3) and gradients (cosine 0.999, max diff
     0.1 of the largest entry; the context decoder's cross-attention v_proj
     and output projection among them) against the plain path; then ViT-B/16
     at 640^2, one b2 request (12 K1, 15 K3) against the plain path and on
     its own tensors.
 23. serve, zero-shot RIS (`eval_zeroshot.build_ris` in bf16 over seeded f32
     weights at full width: CLIP ViT-B/16 (224^2, 197 tokens) and text
     towers, FreeSOLO R101-FPN 256 with the zsseg heads, grids (40, 36, 24,
     16, 12), nms_pre 500, max_per_img 100; alpha 0.95, beta 0.5, masking
     from layer -3; one synthetic 1024^2 request with 2 x 77 text ids): the
     valid proposals (at least one; the thresholds lowered, and so printed,
     only if the defaults leave none) and the picked index; `predict_fused`
     warm-up and median of 5 with 12 K3 and no other kernel a request, every
     K3 launch against its plain version on the path's own tensors, the text
     features against the plain path; one `__call__` through the host crop
     loop (its picked proposal against the fused one where the similarity
     margin is wide), the device crop-resize against the host crops of the
     path's proposals; `predict_fused_many` at depth 2 over 6 requests; the
     same weights on `layout="flat"` (+87 K4 a request, every one held
     against its plain version on its own tensors, the raw outputs against
     "nchw", the proposals' agreement printed); BiomedCLIP (timm ViT-B/16,
     BERT-base) on the same proposals, 12 K3 a request against the plain
     path. K4 is also held and timed alone at the R101's 12 stride-1
     convolution shapes of a 1024^2 request, and K3 at the two text towers'.
 24. real-layout checkpoints (`phase_checkpoints`): synthetic full-width
     checkpoints drawn on the real key sets (`tunevlseg_torch/convert/
     keysets/`, `tests/fixtures/keysets/`) from a seeded generator on the
     CPU, written to a temporary directory in the real files' formats and
     loaded through the port's entry points: CIDAS CLIPSeg rd64-refined as
     `.safetensors` (written by this script's own few lines) through
     `train.load_pretrained` into CLIPSeg CoOp (depth 3, the contexts
     embedded from "a photo of a" through the loaded table: 4), one b64
     dedup request (13 K1 + 12 K3) and 2 + 3 b64 CoOp steps (13 / 3 / 12),
     frozen tensors bit-identical, the first step against the plain path;
     the same weights as the reference wrapper's Lightning `.ckpt` with a
     CoOp learner, loaded over them; OpenAI RN50 as a TorchScript `.pt`
     under CRIS CoOp, a b64 request on "nchw" (3 K1 + 15 K3) and on "flat"
     (+54 K4, every launch held against its plain version, flat against
     nchw); FreeSOLO R101 as `{"model": sd}` and the rd64-refined file as
     `clip_checkpoint` in `eval_zeroshot.build_ris`, fused 1024^2 requests
     (12 K3, each held; text features against the plain path); SigLIP-base
     as `.bin` under the PhraseCut segmentor, one b16 request (16 K1 + 16
     K3) against the plain path. For each file: every key read or in the
     converter's named ignorable set, every converted tensor on the card
     bit-identical in f32 to its source after the documented transform,
     every other tensor of the model under a named fresh prefix; load and
     convert seconds and GB; the phase's peak memory.
 25. K1, K2 and K3 at head dim 96 and `model=trans_seg_siglip`: the three
     kernels against their plain versions at the decoder's shapes (b32 x
     484 x 8 x 96 self-attention, 484 -> 64 cross-attention under the
     key-pad bias) and with keys short of T, event and device times,
     `scaled_dot_product_attention` beside them (`phase_kernels_d96`, run
     with phase 3); then (`phase_trans_seg_siglip`) the model at full width (SigLIP-base towers, fresh
     projections, a 768-wide decoder of 8 heads of 96, 352^2), its parameter
     count, a b32 dense and a b1 request (16 K1 + 16 K3) against the plain
     path, 2 + 5 b32 full fine-tune steps (16 K1, 16 K2, 16 K3 each; finite
     losses, step ms, peak memory), the first step against the plain path.
 26. the serving export (`phase_export`): `serving.export_task_predict`,
     `load_fn` and the loaded program against eager `task_predict_fn`, bit
     for bit, with the same launches a forward, the graph naming its
     `tunevlseg::` ops, latency beside eager and the artifact's bytes beside
     the weights': CLIPSeg CoOp rd64 b64 dedup (K1, K3) and b1 (exported for
     ("cuda", "cpu"); the cpu program run on the host against the card's),
     CRIS CoOp b64 on `layout="flat"` (K1, K3, K4), trans_seg b32 (its
     towers 6 layers deep, to keep the script's time) and
     trans_seg_siglip b32 (phase 25's model, K1 and K3 at D = 96).
 27. gradient accumulation and per-layer remat (`phase_accumulate_remat`):
     `bench.py`'s trans_seg b32 full fine-tune with the config's decoder
     dropout 0.1, 3 steps with remat off and 3 on from the same weights and
     seed (32 K1 + 16 K2 + 32 K3 a rematted step: the first loss
     bit-identical, the weights within the common bounds, peak memory and
     step ms of both); the flagship CLIPSeg CoOp b64 dedup step against two
     b32 micro-steps with `accumulate_grad_batches=2` (the gradient each
     update applies, the weights after it); DenseCLIP RN50 512^2 b16
     `bn_train` with remat off and on (one checkpoint of the loss: 2 K1 + 1
     K2 + 30 K3 a step; peak memory, step ms, the BatchNorm statistics in
     the state against the plain steps').
 28. data parallel (`phase_data_parallel`), every rank in a child process of
     its own, so that no process group is left in this one: (a) NCCL at
     world size 1 through `initialize_distributed`: the flagship CLIPSeg
     CoOp b64 dedup 352^2 bf16, 3 steps plain, 3 under DistributedDataParallel
     (`compile_steps`) and 3 under `fully_shard` (`state_fsdp_shardings`)
     from the same weights, both held to the plain steps bit for bit
     (losses and weights, which the steps must have moved), launches a step,
     peak memory; (b) two ranks on the one card
     over gloo with CUDA tensors: the flagship at b32 a rank against this
     process taking two accumulated b32 micro-steps of the same rows (the
     gradient the update applies), and CRIS e2e on `layout="flat"` (phase
     13's full fine-tune, decoder dropout 0) at b8 a rank, its FPN and
     projector BatchNorms on the global batch's statistics, against one b16
     step here (and, as a witness of the random model's rounding, the b16
     step on its rows reversed): the loss and statistics held, the bf16
     gradient only printed; the same CRIS e2e in f32 (TF32 off, the plain
     path), whose gradient is held to the b16 step's; each rank's dropout
     masks its own; the flagship at b32 a rank with the dice over the whole
     batch (`loss_kwargs={"batch": True}`: the three sums all-reduced over
     the data group, forward and backward) against one b64 step here with
     the same loss, held beside the witness of that step computed as the
     ranks compute it (two b32 forwards, the loss on their logits together),
     which DDP must match as (b)'s CoOp matches its micro-steps;
     whether FSDP2's all-gather and reduce-scatter run on gloo with CUDA tensors
     (they do; a fully_shard step over them crashed a rank, so FSDP's
     two-rank check is the CPU tests'); (c) phase
     23's 1024^2 zero-shot request with its proposals in 2 chunks, both on
     cuda:0, against the unsplit request; and FreeSOLO's pseudo losses
     (`models/solov2/pseudo_loss.paired_losses`) with their gradient on the
     card against the CPU at the request's proposal shapes.
 29. captured train steps (`phase_captured`): `compile_train_multistep(k)`,
     one `torch.cuda.CUDAGraph` of k whole train steps (`training/graphs.py`),
     against k eager steps a group from the same weights and a fresh state,
     two groups each: the flagship CLIPSeg CoOp b64 dedup at k = 10 (the JAX
     bench's `--scan`; the learning rate halved between the groups), CoOp
     b32 with `accumulate_grad_batches=2` at k = 3 (a window across the
     group boundary, one graph per phase), CRIS CoOp b64 and CRIS e2e b16
     (full fine-tune) on the flat layout, bench's trans_seg b32 with decoder
     dropout 0.1 and DenseCLIP RN50 512^2 b16 `bn_train` with a learning
     rate a step, at k = 2. Weights, AdamW moments, BatchNorm statistics,
     the accumulation window and the metrics bit-identical where two eager
     runs are, else within twice their gap; launches through the counters
     (the warm-up and the capture) and one replay's by kernel name under
     torch.profiler (k x the eager step's); a step's ms captured and eager
     (median of 3 groups), the capture's s, peak memory; with `--profile`
     busy ms and idle share of a group of each. Then `Trainer.fit` over 2
     epochs of 10 b64 batches with steps_per_execution 10 against 1 (the
     plateau scheduler between the epochs): weights and moments
     bit-identical, the loop's ms a step.
 30. the tools (`phase_tools`), through their entry points in this process
     on synthetic files under a temporary directory: (a)
     `scripts/torch_sweep.py --space coop --trials 3` over the port's train
     CLI (`experiment=coop/clipseg` on a synthetic kvasir_polyp folder at
     352^2, b16, one epoch of 2 batches, a synthetic BPE merges file, seeded
     random weights): each trial's launches from 0 (2 CoOp steps and 5
     forwards: 91 K1, 6 K2, 84 K3), a finite val_loss, no recorded error,
     its seconds; (b) `scripts/torch_analyze_prompts.py` on the best trial's
     run: the context tensor and its nearest ids against the 49,408-row
     token embedding, on the card; (c) `scripts/torch_analyze_zeroshot.py`
     `limit` on three 1024^2 images (CLIP ViT-B/16 and FreeSOLO R101 in f32,
     as eval_zeroshot builds them: no kernel launched, the gates take bf16),
     `topk --topk 1 5 10 --dtype bf16`, then `limit --dtype bf16` with
     `+model.layout=flat`: 12 K3 a request with a valid proposal in `topk`,
     87 K4 a request on flat, metrics finite and in [0, 1] (random FreeSOLO
     heads that leave no proposal get phase 23's lowered thresholds,
     printed); (d) `scripts/torch_train_mnist.py --synthetic
     --epochs 3` on the card: val_acc above 0.9, the seconds of each epoch;
     (e) `scripts/torch_analyze_phrasecut.py` on three synthetic images.
     The paths that launch no kernel (MNIST, the analyses on the host, the
     nchw `limit`) must launch none.
 31. tensor parallel (`phase_tensor_parallel`): ranks in child processes on
     cuda:0 over gloo (the machine has one card; phase 28's `dp_spawn`), the
     frozen towers sliced over each model group
     (`parallel/tensor_parallel.shard_model`), K1 / K2 / K3 on each rank's
     local heads. (a) tp = 2: CLIPSeg rd64 CoOp(3, 4) b64 dedup at 352^2, one
     request and 3 steps against the same in one process (tp = 1): the
     probabilities, each step's loss and the gradient each update applied,
     held to the kernel-vs-plain bounds beside that comparison's own gap at
     tp = 1 as the witness; the ranks bit-identical; frozen bytes a rank,
     peak memory, launches (13 / 0 / 12 a request, 13 / 3 / 12 a step) and
     the collectives' bytes a step; (b) tp = 2 at 336^2 (442 vision tokens)
     with the residual stream sequence-sharded against without, CoOp and
     MaPLe (whose contexts' gradient crosses the sharded stream); (c) dp 2 x
     tp 2, four ranks, b32 a data rank under DDP over the data groups,
     against two accumulated b32 micro-steps at tp = 2 (DDP2_GRAD_REL_TOL)
     and one process's b64 step, all four ranks bit-identical after the
     update; (d) CRIS CoOp on layout="flat" at tp = 2, b16, one step (54 K4,
     the attention pool's heads gathered before c_proj) against one process.
     (e) the run of (a) exported through the CLI's `train.export_task` on
     its two ranks (the whole tensors gathered over the model group, model
     rank 0 tracing a whole model built again) against the one-process
     export of the same task built here while the ranks ran: both programs
     loaded and called on the run's weights and a b64 request,
     bit-identical probabilities, the same `tunevlseg::` ops, the export
     and load seconds, the tp program's launches (13 / 0 / 12).
     Then K1 (with and without the lse), K2 and K3 against their plain
     versions at every local shape those runs launched them at, as the
     ranks recorded them through the wrappers' launchers.
 32. N1 (`phase_kernel_n1`, run after phase 10's K4 checks): the one-pass
     LayerNorm (`csrc/layer_norm.cu`) forward and backward at the ViT's
     31,040 x 768, the CLIPSeg decoder's 31,040 x 64 and CRIS's 43,264 x 512
     rows, bf16, against the plain chain it replaces (y within one bf16 ulp,
     dx, dw and db held, two backward calls bit-identical), each kernel's
     device time (L2 flushed) and events time beside its bytes bound and
     beside the chain's time. N1's launches (forward, backward, and the
     LayerNorm calls left on the chain) are read on every path beside the
     other kernels' and printed a line a path; the plain paths the kernel
     paths are held against run every LayerNorm on the chain.
`--profile` adds a breakdown of the train steps (forward / backward /
optimizer spans, device busy share under torch.profiler) and of the CRIS
b64 and b1 forwards, on both layouts, of the TransformerSegmentor's b32
and b1 requests, of DenseCLIP's b16 request and of the zero-shot fused
request.
The second-to-last line is a JSON object describing each kernel of the
paths; the last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

KERNEL_TOL = 2e-2          # K1 and K3, bf16 output: a few ulp at |o| ~ 1
# K2, bf16 outputs, against its plain version with p from the same lse (as
# the kernel takes it) and without (p = e / sum e), both held: the kernel and
# the plain version round p and ds to bf16 from f32 values that differ in the
# last bits, accumulate in f32 in another order, and round the outputs once.
# At worst the two roundings of an output near the largest magnitude land one
# bf16 ulp apart (2^-8 = 3.9e-3 relative), so the bound is 5e-3 of the
# largest |reference|. The kernels are deterministic (no atomics).
K2_REL_TOL = 5e-3
# K1's log-sum-exp against its plain version: f32 sums in another order and
# exp2 / log2 against the plain version's, relative to max(1, |lse|)
LSE_REL_TOL = 1e-4
# kernel path vs plain path, probabilities: the plain path rounds the scores
# to bf16 before the softmax and the kernel does not, so the two bf16 models
# differ by more than the kernel's own rounding (predicted max ~5e-3)
PROB_MAX_TOL = 2e-2
PROB_MEAN_TOL = 2e-3
# kernel path vs plain path, first CoOp train step: the same two bf16 models,
# so the loss (about 1) differs like the probabilities do, and the context
# gradient, carried back through three bf16 decoder blocks and twelve text
# layers (and, under visual contexts, the ten vision layers: measured cosine
# 0.9996 there), by a few percent of its largest entry
LOSS_TOL = 2e-2
GRAD_REL_TOL = 0.1
GRAD_COS_MIN = 0.99
# launches per forward or step, as (K1, K2, K3, K4 forward, K4 dx, K4's
# backward prologue, S1/S2/S4, S3): the variants' two counts are read beside
# the models' kernels on every path, and no model may launch them.
NO_VARIANTS = (0, 0)
COUNTED = "(K1, K2, K3, K4, K4 dx, K4 dy prologue, S1/S2/S4, S3)"
# CLIPSeg: K1 in 10 vision layers + 3 decoder blocks; K3 in the 12 text
# layers (causal + padding bias); K2 for the decoder blocks, and for the
# vision layers too when they train (the frozen vision tower needs none)
CLIPSEG_SERVE = (13, 0, 12, 0, 0, 0) + NO_VARIANTS
CLIPSEG_COOP_STEP = (13, 3, 12, 0, 0, 0) + NO_VARIANTS
CLIPSEG_E2E_STEP = (13, 13, 12, 0, 0, 0) + NO_VARIANTS
# visual contexts (VPT, MaPLe, the shared learners) sit in the frozen vision
# tower, so the gradient runs back through its ten layers: K2 in all 13
# attentions of a prompt-tuning step. CoCoOp runs the whole tower (12 layers)
# for the pooled image features, forward only: no trainable leaf lies
# upstream of them; its text tower runs 64 rows (no prompt dedup)
CLIPSEG_VISUAL_STEP = (13, 13, 12, 0, 0, 0) + NO_VARIANTS
CLIPSEG_COCOOP_SERVE = (15, 0, 12, 0, 0, 0) + NO_VARIANTS
CLIPSEG_COCOOP_STEP = (15, 3, 12, 0, 0, 0) + NO_VARIANTS
# CRIS CoCoOp, kernel path vs plain path: the meta-net ends in a LayerNorm,
# so its per-image bias has unit scale where context vectors and token
# embeddings have 0.02-0.04, and the randomly initialised text tower then sees
# scores in the tens: a sharp softmax, which amplifies any rounding. Measured
# max 2.98e-2, mean 2.6e-3 on probabilities that span [0.07, 0.997], while two
# paths WITHOUT a kernel (the plain path, and one with f32 scores) differ
# among themselves by 3.06e-2 / 2.5e-3, and every K1 and K3 launch of that
# forward is within 5.2e-3 of the largest |reference| on its own inputs.
# `compare_with_plain_path` holds the run to both witnesses before it accepts
# a bound wider than the common one.
COCOOP_CRIS_PROB_TOL = (5e-2, 5e-3)
# CRIS: K1 (K2) in the 3 decoder self-attentions over 676 tokens; K3 in the
# 12 text layers and the 3 cross-attentions into the text; the RN50
# attention pool has 169 tokens, under the gate's 256: plain
CRIS_SERVE = (3, 0, 15, 0, 0, 0) + NO_VARIANTS
CRIS_COOP_STEP = (3, 3, 15, 0, 0, 0) + NO_VARIANTS
# CRIS with layout="flat": K4 in the RN50's 2 stem convolutions, 3 per
# bottleneck in 16 bottlenecks and 4 downsample convolutions = 54; K4 again
# for dx of each of them when the backbone trains (conv1 in front of the stem
# trains too, so even the first flat convolution's input wants a gradient)
RN50_FLAT_CONVS = 2 + 3 * 16 + 4
CRIS_FLAT_SERVE = (3, 0, 15, RN50_FLAT_CONVS, 0, 0) + NO_VARIANTS
CRIS_FLAT_COOP_STEP = (3, 3, 15, RN50_FLAT_CONVS, 0, 0) + NO_VARIANTS
CRIS_E2E_STEP = (3, 3, 15, 0, 0, 0) + NO_VARIANTS
CRIS_E2E_FLAT_STEP = (3, 3, 15, RN50_FLAT_CONVS, RN50_FLAT_CONVS,
                      RN50_FLAT_CONVS) + NO_VARIANTS
# K4's bf16 output against the plain version's f32 value on the same bf16
# operands (`exact_conv_flat`): f32 accumulation in another order, then the
# kernel's one rounding, at most half a bf16 ulp, 2^-8 of |y| <= 3.9e-3 of
# the largest |reference|; 5e-3 with slack. (Against the plain version's own
# bf16 output the two roundings may land a whole ulp apart, up to 2^-7 =
# 7.8e-3 of a value at the bottom of its binade: over this bound.) Gradients
# of the Function against autograd through the plain version (dy*scale
# rounded to bf16 for dx, bf16 operands in the dW products): 1e-2 of the
# largest entry.
K4_REL_TOL = 5e-3
K4_GRAD_REL_TOL = 1e-2
# flat against nchw on the same weights, probabilities: the folded affine
# rounds to bf16 once per convolution where cuDNN + BatchNorm round twice,
# through 54 convolutions (predicted max ~2e-2, mean ~1e-3)
FLAT_PROB_MAX_TOL = 5e-2
FLAT_PROB_MEAN_TOL = 5e-3
# flat against nchw, gradients of the backbone for one fixed cotangent on its
# pyramid (two bf16 evaluations of 54 convolutions that round at different
# places: measured cosine >= 0.994, max diff <= 0.16 of the largest entry)
FLAT_GRAD_COS_MIN = 0.99
FLAT_GRAD_REL_TOL = 0.25
# flat against nchw, first e2e step of the whole randomly initialised model:
# its head under train-mode BatchNorm amplifies the 1-2% by which the two
# pyramids differ (loss 2.00 vs 1.94 measured; the same model's loss moves by
# 0.013 between the kernel and the plain attention path), and the gradients
# it sends back decorrelate with it, so the step's loss is held to 0.15 and
# the step's backbone gradients are printed, not held to a bound
E2E_FLAT_LOSS_TOL = 0.15
# TransformerSegmentor (`bench.py`'s trans_seg row: CLIP ViT-B/16 and text
# towers, decoder 4 x 8 heads of 64, upsampler 512 -> 410 -> 308 -> 206 ->
# 104 -> 1): K1 in the 12 vision layers (485 tokens) and the 4 decoder
# self-attentions; K3 in the 12 text layers and the 4 cross-attentions into
# the text; K2 for all 16 when everything trains. `upsampler_layout="flat"`
# adds K4 for the 5 upsampler convolutions, and in a step their dx and
# prologue (the decoder before them trains)
TS_SERVE = (16, 0, 16, 0, 0, 0) + NO_VARIANTS
# phase 26's trans_seg export at full width and half the towers' depth (6 of
# 12 layers a tower; the decoder's 4 whole): phase 29 made the script long
TS_EXPORT_TOWER_LAYERS = 6
TS_EXPORT_SERVE = (TS_EXPORT_TOWER_LAYERS + 4, 0, TS_EXPORT_TOWER_LAYERS + 4,
                   0, 0, 0) + NO_VARIANTS
TS_STEP = (16, 16, 16, 0, 0, 0) + NO_VARIANTS
TS_CONVS = 5
TS_FLAT_SERVE = (16, 0, 16, TS_CONVS, 0, 0) + NO_VARIANTS
TS_FLAT_STEP = (16, 16, 16, TS_CONVS, TS_CONVS, TS_CONVS) + NO_VARIANTS
# PhraseCut (SigLIP towers at 384^2: 576 tokens, no CLS; 64 text tokens with
# a padding bias only; decoder 16 heads of 32): the same 16 K1 and 16 K3 a
# forward; the towers are frozen, so K2 only for the 4 decoder layers
PC_SERVE = (16, 0, 16, 0, 0, 0) + NO_VARIANTS
PC_STEP = (16, 4, 16, 0, 0, 0) + NO_VARIANTS
# flat against nchw upsampler on the same weights, probabilities: five
# convolutions whose bf16 outputs round once each in both (K4: f32 sums and
# the bias in f32, then one rounding; cuDNN likewise), in another summation
# order, each followed by a LayerNorm over (C, H, W): predicted max ~5e-3
TS_FLAT_PROB_TOL = (2e-2, 2e-3)
IMG, BATCH, SEQ = 352, 64, 77
CRIS_IMG = 416
E2E_BATCH = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same sheet
VISION = (BATCH, 485, 12, 64)
DECODER = (BATCH, 485, 4, 16)
# with four visual contexts appended (VPT, MaPLe, the shared learners)
VISION_CTX = (BATCH, 489, 12, 64)
DECODER_CTX = (BATCH, 489, 4, 16)
# the shapes the e2e train step launches the kernels at
E2E_VISION = (E2E_BATCH, 485, 12, 64)
E2E_DECODER = (E2E_BATCH, 485, 4, 16)
CRIS_DECODER = (BATCH, 676, 8, 64)     # self-attention over 26 x 26 tokens
TS_BATCH, PC_BATCH, PC_IMG, PC_SEQ = 32, 16, 384, 64
TS_VISION = (TS_BATCH, 485, 12, 64)
TS_DECODER = (TS_BATCH, 485, 8, 64)
PC_VISION = (PC_BATCH, 576, 12, 64)    # SigLIP at 384^2: 24 x 24 tokens
PC_DECODER = (PC_BATCH, 576, 16, 32)   # 512 wide, 16 heads: D = 32
# DenseCLIP (ADE-150): RN50 at 512^2 in batches of 16, ViT-B/16 at 640^2 in 2;
# 150 class rows of 5 + 8 = 13 text tokens
DC_BATCH, DC_IMG, DC_VIT_BATCH, DC_VIT_IMG = 16, 512, 2, 640
DC_CLASSES, DC_TEXT = 150, 13
DC_POOL = (DC_BATCH, 257, 32, 64)
# zero-shot RIS: the text towers run the [phrase, class name] pair of a request
ZS_TEXT_ROWS = 2
DC_VIT = (DC_VIT_BATCH, 1601, 12, 64)
F32_MIN = -3.4028234663852886e38       # what the models' biases mask with


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only the end of one still sees why
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Counts(tuple):
    """The launch counts `counts` returns, with N1's beside them as `n1`:
    (forward launches, backward launches, LayerNorm calls on the plain
    chain). Equal to the plain tuple of the same counts, so every path's
    expected tuple holds the kernels it held before N1; pickled as that plain
    tuple (a rank's counts reach the parent without `n1`)."""
    n1 = None

    def __reduce__(self):
        return tuple, (tuple(self),)


def counts(fa) -> Counts:
    """(K1, K2, K3, K4 forward, K4 dx, K4 dy prologue, S1/S2/S4, S3)
    launches since the last reset, N1's as `.n1`."""
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention_variants as fav
    from tunevlseg_torch.ops import layer_norm as n1
    c = Counts((fa.launch_count(), fa.bwd_launch_count(), fa.bias_launch_count(),
                cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count(),
                fav.launch_count("variant"), fav.launch_count("ones_column")))
    c.n1 = (n1.launch_count(), n1.bwd_launch_count(), n1.plain_count())
    return c


def reset_counts(fa) -> None:
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention_variants as fav
    from tunevlseg_torch.ops import layer_norm as n1
    fa.reset_launch_count()
    cf.reset_launch_count()
    fav.reset_launch_count()
    n1.reset_launch_count()


def load_script(name: str):
    """scripts/<name> as a module (the sweeps' entry point
    `torch_micro_attn.py`, phase 30's tools)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "scripts" / name
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def minus(after: tuple, before: tuple) -> Counts:
    grew = Counts(a - b for a, b in zip(after, before))
    n1_after, n1_before = getattr(after, "n1", None), getattr(before, "n1", None)
    if n1_after is not None and n1_before is not None:
        grew.n1 = tuple(a - b for a, b in zip(n1_after, n1_before))
    return grew


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# nvidia-smi's "name, power.limit" of the card, printed beside the numbers
# of the fit phase
CARD = ["not read"]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"device: {name}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    CARD[0] = smi.strip().splitlines()[0]
    print(CARD[0])
    return name, count


def phase_build():
    from tunevlseg_torch.ops import build
    kernels = (("fwd", "K1"), ("bwd", "K2"), ("bias", "K3"), ("conv", "K4"),
               ("layer_norm", "N1"), ("variants", "S1-S4"))
    t0 = time.perf_counter()
    build.load_libraries(sweeps=True)
    secs = time.perf_counter() - t0
    print(f"build: K1, K2, K3, K4, N1 and S1-S4 (six sources side by side) {secs:.2f} s -> "
          + ", ".join(build.library_path(k).name for k, _ in kernels))
    for kernel, label in kernels:
        log = build.library_path(kernel).with_suffix(".log").read_text()
        entry = ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '_Z\w*?\d([a-z_]+_kernel)(I\w*?E)?E", line)
            if found:      # the kernel's name and its template arguments
                entry = found.group(1) + (found.group(2) or "")
            elif "registers" in line or "spill" in line:
                print(f"build: {label} {entry} ptxas {line.strip()}")


def attention_bound(n_tensors: int, flops_factor: int, b, s, h, d, t_valid,
                    nbytes=None):
    """(bound_ms, bound_by, flops): the larger of `nbytes` (by default those
    of `n_tensors` bf16 (B, S, H, D) tensors) over the memory rate and
    flops_factor*B*H*S*T*D operations over the bf16 tensor-core rate."""
    if nbytes is None:
        nbytes = n_tensors * b * s * h * d * 2
    flops = flops_factor * b * h * s * t_valid * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            flops)


TS_SHAPES = (("trans_seg vision", TS_VISION, None),
             ("trans_seg decoder", TS_DECODER, None),
             ("phrasecut vision", PC_VISION, None),
             ("phrasecut decoder d32", PC_DECODER, None))
# DenseCLIP: the RN50 attention pool at 512^2 (16^2 + 1 tokens, 32 heads: one
# valid row in the last 128-row query tile, one valid key in the last 64-key
# tile), the same with the keys from 129 on masked (masked dk / dv rows
# exactly zero), and the ViT-B/16 at 640^2 (40^2 + 1 tokens)
DC_SHAPES = (("denseclip pool", DC_POOL, None),
             ("denseclip pool kv_valid 129", DC_POOL, 129),
             ("denseclip vit", DC_VIT, None))


ATTN_SHAPES = (("vision", VISION, None), ("decoder", DECODER, None),
               ("vision 489", VISION_CTX, None), ("decoder 489", DECODER_CTX, None),
               ("vision kv_valid", (BATCH, 512, 12, 64), 485),
               ("e2e vision", E2E_VISION, None), ("e2e decoder", E2E_DECODER, None),
               ("cris decoder", CRIS_DECODER, None), *TS_SHAPES, *DC_SHAPES)


def kernel_cases(gen, shapes=ATTN_SHAPES):
    import torch
    for label, shape, kv in shapes:
        yield label, shape, kv, tuple(
            torch.randn(*shape, generator=gen, device="cuda").bfloat16()
            for _ in range(4))


# a write of this many bytes between profiled calls evicts the card's 50 MB
# L2, so that a call reads its inputs from HBM as a bytes bound counts them
L2_FLUSH_BYTES = 256 * 2 ** 20


def device_ms_by_kernel(fn, n: int = 5) -> dict:
    """{kernel name: (device ms per launch, launches)} of the kernels `fn`
    launches, from torch.profiler over `n` calls after a warm-up call, each
    call after an L2 flush: each kernel's recorded device time divided by
    its own recorded launches (`count`), which a caller holds against the
    calls made. The flush's kernels (named by a window of its own, which
    must see them) are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def recorded(prof) -> dict:
        return {e.key: (e.self_device_time_total / e.count / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flush.zero_()
        torch.cuda.synchronize()
    flush_names = set(recorded(prof))
    if not flush_names:
        return {}       # the window saw nothing: the caller takes another
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {k: v for k, v in recorded(prof).items() if k not in flush_names}


def kernel_device_ms(label: str, fn, keys: dict, bound_ms: float) -> tuple:
    """({key: device ms per call of the kernels whose names hold `key`},
    {key: launches recorded}) for `keys` = {key: launches a call, or None
    for any whole number a call (a library call's kernels)}, from
    `device_ms_by_kernel` with a cold L2. A window must record every launch
    of the calls it made (calls x launches a call), and the time of all the
    keys together must be at least `bound_ms`, the least time the work can
    take on the card (under it, the window read warm data: a cuDNN 1x1
    convolution of phase 4 came in at 0.9 of its bound once in nine whole
    runs); else another window is taken, up to six of growing length, and
    then it fails."""
    for attempt in range(6):
        calls = 5 * (attempt + 1)
        parts = device_ms_by_kernel(fn, n=calls)
        ms, launches = {}, {}
        for key in keys:
            found = [v for name, v in parts.items() if key in name]
            launches[key] = sum(c for _, c in found)
            ms[key] = sum(t * c for t, c in found) / calls
        complete = all(launches[key] == calls * per_call if per_call is not None
                       else launches[key] > 0 and launches[key] % calls == 0
                       for key, per_call in keys.items())
        total = sum(ms.values())
        if complete and total >= bound_ms:
            break
    else:
        if not complete:
            fail(f"{label}: torch.profiler recorded {launches} launches of {keys} "
                 f"a call over {calls} calls, not every one of them")
        fail(f"{label}: device time {total:.5f} ms a call by torch.profiler is "
             f"under the bound {bound_ms:.5f} ms ({launches} launches over "
             f"{calls} calls), in each of six windows")
    return ms, launches


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host time per call of `fn`: time.perf_counter over `calls` calls with
    no synchronize in between (they are only enqueued)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def phase_kernels(fa, shapes=ATTN_SHAPES, host: bool = True):
    """K1 against its plain version at `shapes`, with and without the
    log-sum-exp that a backward asks for, and (with `host`) the host time of
    a K1 call; returns {label: numbers}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (b, s, h, d), kv, (q, k, v, _) in kernel_cases(gen, shapes):
        t = kv or s
        out = fa.flash_attention(q, k, v, kv_valid=kv)
        with_lse, lse = fa._launch(q, k, v, t, with_lse=True)
        torch.cuda.synchronize()
        ref, lse_ref = fa.flash_attention_ref(q, k, v, kv_valid=kv, return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item()
        same = torch.equal(out, with_lse)
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, kv_valid=kv), 50)
        lse_ms = cuda_time_ms(lambda: fa._launch(q, k, v, t, with_lse=True), 50)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_ref(q, k, v, kv_valid=kv), 10)
        bound_ms, bound_by, flops = attention_bound(4, 4, b, s, h, d, t)
        # the kernel's own duration: where a call's host time comes near it
        # (D = 16, b16), the event time above is the host's
        device_ms = kernel_device_ms(
            f"K1 {label}", lambda: fa.flash_attention(q, k, v, kv_valid=kv),
            {"flash_attn_fwd": 1}, bound_ms)[0]["flash_attn_fwd"]
        print(f"kernel K1 {label} q{(b, s, h, d)} kv_valid {kv}: "
              f"max_abs_err {err:.6g} (bound {KERNEL_TOL}), kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s; device {device_ms:.4f} ms by "
              f"torch.profiler, the L2 flushed before each call), with the lse "
              f"write {lse_ms:.4f} ms "
              f"({100 * (lse_ms / ms - 1):+.1f}%; output bit-identical {same}, lse "
              f"error {lse_err:.3g} of max(1, |lse|), bound {LSE_REL_TOL}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% reached)")
        if not err <= KERNEL_TOL:
            fail(f"K1 {label}: max abs error {err} > {KERNEL_TOL}")
        if not same:
            fail(f"K1 {label}: the output changes when the lse is written")
        if not lse_err <= LSE_REL_TOL:
            fail(f"K1 {label}: lse error {lse_err} > {LSE_REL_TOL} of max(1, |lse|)")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "ms_with_lse": lse_ms, "device_ms": device_ms}
    if not host:
        return results
    # the b1 request's shapes, where the card finishes a call before the host
    # has launched the next: the wrapper's host time (ctypes, three tensor maps)
    for d, shape in ((64, (1, 485, 12, 64)), (16, (1, 485, 4, 16))):
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        us = min(host_us_per_call(lambda: fa.flash_attention(q, k, v)) for _ in range(3))
        device_ms = kernel_device_ms(
            f"K1 b1 D = {d}", lambda: fa.flash_attention(q, k, v),
            {"flash_attn_fwd": 1}, attention_bound(4, 4, *shape, shape[1])[0]
        )[0]["flash_attn_fwd"]
        print(f"host K1 D = {d} q{shape}: {us:.2f} us per flash_attention call "
              f"(perf_counter over 1000 calls, no synchronize, the least of 3 "
              f"rounds); the kernel's device time {device_ms * 1e3:.2f} us")
        results["vision" if d == 64 else "decoder"]["host_us_b1"] = us
    return results


def phase_kernels_bwd(fa, shapes=ATTN_SHAPES):
    """K2 against its plain version at `shapes` on the lse that K1 wrote, as
    a train step calls it, and without it; returns {label: numbers}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for label, (b, s, h, d), kv, (q, k, v, g) in kernel_cases(gen, shapes):
        t = kv or s
        _, lse = fa._launch(q, k, v, t, with_lse=True)
        before = fa.bwd_launch_count(), fa.launch_count()
        out = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv, lse=lse)
        torch.cuda.synchronize()
        if (fa.bwd_launch_count(), fa.launch_count()) != (before[0] + 1, before[1]):
            fail(f"K2 {label}: the wrapper did not count one K2 launch and no K1")
        ref = fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv, lse=lse)
        exact = fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv)
        errs, rels, exact_rels = [], [], []
        for name, got, want, want0 in zip(("dq", "dk", "dv"), out, ref, exact):
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                fail(f"K2 {label}: {name} is {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            errs.append(err)
            rels.append(err / top)
            exact_rels.append((got.float() - want0.float()).abs().max().item()
                              / want0.float().abs().max().item())
            if not err <= K2_REL_TOL * top:
                fail(f"K2 {label}: {name} max abs error {err} > "
                     f"{K2_REL_TOL} x {top}")
            if not exact_rels[-1] <= K2_REL_TOL:
                fail(f"K2 {label}: {name} is {exact_rels[-1]} of the largest "
                     f"|exact gradient| away from it (bound {K2_REL_TOL})")
        if kv is not None:
            for name, got in (("dk", out[1]), ("dv", out[2])):
                if not bool((got[:, kv:] == 0).all()):
                    fail(f"K2 {label}: {name} rows of masked keys are not "
                         "exactly zero")
        again = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv, lse=lse)
        if not all(torch.equal(x, y) for x, y in zip(out, again)):
            fail(f"K2 {label}: two calls on the same inputs differ")
        del ref, exact, again
        ms = cuda_time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, g, kv_valid=kv, lse=lse), 50)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv, lse=lse), 5)
        # each input read once (q, k, v, g and the f32 lse), each output
        # written once (dq, dk, dv)
        nbytes = 7 * b * s * h * d * 2 + 4 * b * h * s
        bound_ms, bound_by, flops = attention_bound(0, 10, b, s, h, d, t, nbytes)
        by_pass = kernel_device_ms(
            f"K2 {label}",
            lambda: fa.flash_attention_bwd(q, k, v, g, kv_valid=kv, lse=lse),
            {"bwd_dq": 1, "dkdv": 1}, bound_ms)[0]
        masked = "" if kv is None else f", {s - kv} masked dk/dv rows exactly 0"
        print(f"kernel K2 {label} q{(b, s, h, d)} kv_valid {kv}: max_abs_err "
              f"dq {errs[0]:.6g} dk {errs[1]:.6g} dv {errs[2]:.6g} (bound "
              f"{K2_REL_TOL} of the largest |reference|; reached "
              f"{max(rels):.4g}; against the plain version without the lse "
              f"{max(exact_rels):.4g}){masked}, two calls bit-identical, kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of 10*B*H*S*T*D; "
              f"device: dq pass with its delta sweep {by_pass['bwd_dq']:.4f}, "
              f"dk/dv pass {by_pass['dkdv']:.4f}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% reached)")
        results[label] = {"max_abs_err": max(errs), "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "passes_ms": by_pass,
                          "rel_err_vs_plain_without_lse": max(exact_rels)}
    return results


def k3_cases(gen):
    """K3's shapes on the main paths: the text towers' causal + padding bias
    over 77 tokens (U = 1 deduplicated row, U = 64 dense rows; 8 heads of 64
    in CLIPSeg and CRIS alike) and the CRIS decoder's cross-attention from
    676 visual tokens into 77 text tokens with a key-padding bias. Prompts
    have 10 real tokens (+ 4 contexts), the rest is padding. Then the edges
    of K3's tiling (128 query rows a tile, a block taking a run of a pair's
    query tiles, 80 keys a tile, up to two key tiles resident and more
    streamed, the keys' maps ending at kv_valid), with the biases that take
    the softmax's special cases: -inf over a whole key tile of a row, rows
    entirely at dtype-min. Yields (label, (B, S, H, D), T, kv_valid, bias,
    (q, k, v))."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def key_pad(rows, t=SEQ, first=14):
        bias = torch.zeros(rows, 1, 1, t, device="cuda")
        bias[..., first:] = F32_MIN
        return bias

    def causal(t):
        return torch.triu(torch.full((t, t), F32_MIN, device="cuda"), 1)[None, None]

    causal_77 = causal(SEQ)
    for label, b, s in (("text U=1", 1, SEQ), ("text U=64", BATCH, SEQ),
                        ("cris cross", BATCH, 676)):
        # min + min overflows to -inf where a key is both future and padding
        bias = key_pad(b) + causal_77 if s == SEQ else key_pad(b)
        yield label, (b, s, 8, 64), SEQ, None, bias, (
            rnd(b, s, 8, 64), rnd(b, SEQ, 8, 64), rnd(b, SEQ, 8, 64))

    def inf_tile(b, h, s, t):
        bias = torch.randn(b, h, s, t, generator=gen, device="cuda")
        bias[:, :, ::3, :64] = float("-inf")
        bias[:, :, 1::3, :80] = float("-inf")
        return bias

    def min_rows(b, h, s, t):
        bias = key_pad(b, t, t - 20).expand(b, h, s, t).clone()
        bias[:, :, ::5] = F32_MIN
        return bias

    for label, (b, s, h, d), t, kv, make in (
            ("edge S=129", (BATCH, 129, 8, 64), SEQ, None, lambda: key_pad(BATCH)),
            ("edge T=65", (16, 300, 8, 64), 65, None, lambda: key_pad(16, 65)),
            ("edge T=80 d32", (16, 300, 8, 32), 80, None, lambda: key_pad(16, 80)),
            ("edge T=81 d16", (16, 300, 8, 16), 81, None, lambda: key_pad(16, 81)),
            ("edge T=128", (16, 300, 8, 64), 128, None, lambda: key_pad(16, 128)),
            ("edge T=129 d32", (16, 300, 8, 32), 129, None, lambda: key_pad(16, 129)),
            ("edge kv_valid 80 of 129", (16, 300, 8, 64), 129, 80, lambda: key_pad(16, 129)),
            ("edge T=245 streamed", (16, 300, 8, 64), 245, None, lambda: key_pad(16, 245)),
            ("edge -inf over a key tile", (16, 300, 8, 64), 129, None,
             lambda: inf_tile(16, 8, 300, 129)),
            ("edge rows at dtype-min", (16, 300, 8, 32), SEQ, None,
             lambda: min_rows(16, 8, 300, SEQ)),
            # the TransformerSegmentor's cross-attention into the text
            # (key-pad bias), CLIP at b32 and PhraseCut's SigLIP at b16, and
            # SigLIP's 64 text tokens under a padding bias alone
            ("trans_seg cross", (TS_BATCH, 485, 8, 64), SEQ, None,
             lambda: key_pad(TS_BATCH)),
            ("phrasecut cross d32", (PC_BATCH, 576, 16, 32), PC_SEQ, None,
             lambda: key_pad(PC_BATCH, PC_SEQ)),
            ("siglip text b16", (PC_BATCH, PC_SEQ, 12, 64), PC_SEQ, None,
             lambda: key_pad(PC_BATCH, PC_SEQ)),
            # DenseCLIP's text encoder: 13 tokens under the causal bias, one
            # 80-key tile with 67 keys masked, over the 150 class rows a
            # forward runs (and over 16 x 150 rows); the context decoder's
            # cross-attention, unbiased, from 150 class queries into the RN50
            # pool's 257 tokens and the ViT's 1601 (streamed keys, S = 150 not
            # a multiple of 128)
            ("denseclip text", (DC_CLASSES, DC_TEXT, 8, 64), DC_TEXT, None,
             lambda: causal(DC_TEXT)),
            ("denseclip text 2400 rows", (DC_BATCH * DC_CLASSES, DC_TEXT, 8, 64),
             DC_TEXT, None, lambda: causal(DC_TEXT)),
            ("denseclip cross 257", (DC_BATCH, DC_CLASSES, 4, 64), 257, None,
             lambda: None),
            ("denseclip vit cross 1601", (DC_VIT_BATCH, DC_CLASSES, 4, 64), 1601,
             None, lambda: None),
            # zero-shot RIS: the CLIP text tower over its [phrase, class
            # name] rows under the causal + padding bias, and BiomedCLIP's
            # BERT tower (12 heads of 64) under a padding bias alone
            ("zsseg text", (ZS_TEXT_ROWS, SEQ, 8, 64), SEQ, None,
             lambda: key_pad(ZS_TEXT_ROWS, SEQ, 10) + causal_77),
            ("zsseg biomed text", (ZS_TEXT_ROWS, SEQ, 12, 64), SEQ, None,
             lambda: key_pad(ZS_TEXT_ROWS, SEQ, 10))):
        yield label, (b, s, h, d), t, kv, make(), (rnd(b, s, h, d), rnd(b, t, h, d),
                                                   rnd(b, t, h, d))


def phase_kernels_k3(fa, cases=None):
    """K3 against its plain version at `cases` (a generator like `k3_cases`,
    the default), with `scaled_dot_product_attention` under the same mask
    beside it, its device time from torch.profiler beside the event time,
    and the host time of a `biased_attention` call at the U = 1 shape;
    returns {label: numbers}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for label, (b, s, h, d), t, kv, bias, (q, k, v) in (cases or k3_cases)(gen):
        t_valid = kv or t
        before = fa.bias_launch_count()
        out = fa.biased_attention(q, k, v, bias, kv_valid=kv)
        torch.cuda.synchronize()
        if fa.bias_launch_count() != before + 1:
            fail(f"K3 {label}: the wrapper did not count its launch")
        ref = fa.biased_attention_ref(q, k, v, bias, kv_valid=kv)
        if out.shape != q.shape or out.dtype != torch.bfloat16:
            fail(f"K3 {label}: output is {tuple(out.shape)} {out.dtype}")
        if not bool(out.isfinite().all()):
            fail(f"K3 {label}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"K3 {label}: max abs error {err} > {KERNEL_TOL}")
        if not torch.equal(out, fa.biased_attention(q, k, v, bias, kv_valid=kv)):
            fail(f"K3 {label}: two calls on the same inputs differ")
        ms = cuda_time_ms(lambda: fa.biased_attention(q, k, v, bias, kv_valid=kv), 50)
        # each input read once (the keys up to kv_valid), the output written
        # once; the bias at the size it is stored at, not at (B, H, S, T)
        nbytes = 2 * (2 * q.numel() + 2 * b * t_valid * h * d) + (
            0 if bias is None else 4 * bias.numel())
        bound_ms, bound_by, flops = attention_bound(0, 4, b, s, h, d, t_valid, nbytes)
        device_ms = kernel_device_ms(
            f"K3 {label}", lambda: fa.biased_attention(q, k, v, bias, kv_valid=kv),
            {"biased_attn": 1}, bound_ms)[0]["biased_attn"]
        plain_ms = cuda_time_ms(lambda: fa.biased_attention_ref(q, k, v, bias, kv_valid=kv), 10)
        # one PyTorch call for the same function: a mask of 0 / dtype-min as
        # booleans, any other bias added in q's dtype; kv_valid as masked keys
        masks_only = bias is None or bool(((bias == 0) | (bias < -1e30)).all())
        mask = (None if bias is None else (bias > -1e30) if masks_only
                else bias.to(q.dtype))
        if kv is not None:
            keys = torch.arange(t, device="cuda") < kv
            mask = mask & keys if masks_only else mask.masked_fill(~keys, float("-inf"))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 50)
        row = {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        host = ""
        if label == "text U=1":
            # the b1 request's shape, where the host launches slower than the
            # card runs: the wrapper's host time (checks, ctypes, three maps)
            row["host_us"] = min(host_us_per_call(
                lambda: fa.biased_attention(q, k, v, bias)) for _ in range(3))
            host = (f", host {row['host_us']:.2f} us per biased_attention call "
                    "(perf_counter over 1000 calls, no synchronize, the least of 3 rounds)")
        print(f"kernel K3 {label} q{(b, s, h, d)} k{tuple(k.shape)} kv_valid {kv} bias "
              f"{None if bias is None else tuple(bias.shape)}: max_abs_err {err:.6g} (bound {KERNEL_TOL}), two calls "
              f"bit-identical, kernel {ms:.4f} ms by events, device {device_ms:.4f} ms by "
              f"torch.profiler, the L2 flushed before each call "
              f"({flops / device_ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention with the same "
              f"mask {lib_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({100 * bound_ms / device_ms:.1f}% reached by device time){host}")
        results[label] = row
    return results


def phase_yardstick(shapes=ATTN_SHAPES):
    """One PyTorch call for the same functions at `shapes`:
    scaled_dot_product_attention forward, and its backward alone on a kept
    graph. Timed here, used nowhere in the port. Returns {label: (forward
    ms, backward ms)}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for label, shape, kv in shapes:
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                      .bfloat16().transpose(1, 2) for _ in range(4))
        # kv_valid as a boolean key mask (True = attend)
        mask = None if kv is None else (
            torch.arange(shape[1], device="cuda") < kv)[None, None, None]
        fwd_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
            50)
        print(f"yardstick {label} {shape} kv_valid {kv}: "
              f"scaled_dot_product_attention forward {fwd_ms:.4f} ms, backward "
              f"{bwd_ms:.4f} ms (bf16, (B, H, S, D) views"
              + (", boolean key mask)" if kv else ")"))
        results[label] = (fwd_ms, bwd_ms)
    return results


def make_request(gen, batch: int, unique_prompts: int, img: int = IMG,
                 pad_id: int = 49407):
    """uint8 images and CLIP-style token ids: BOS, 8 word ids, EOS, then
    padding with `pad_id` (CLIPSeg pads with the EOS id, CRIS with 0).
    unique_prompts == 1 gives the deduplicated layout with text_index."""
    import torch
    rows = 1 if unique_prompts == 1 else batch
    ids = torch.randint(3, 1000, (rows, SEQ), generator=gen, dtype=torch.int32)
    ids[:, 0] = 49406
    ids[:, 9] = 49407
    ids[:, 10:] = pad_id
    mask = torch.ones_like(ids)
    mask[:, 9 if pad_id == 49407 else 10:] = 0
    req = {"image": torch.randint(0, 256, (batch, 3, img, img), generator=gen,
                                  dtype=torch.uint8),
           "input_ids": ids, "attention_mask": mask}
    if unique_prompts == 1:
        req["text_index"] = torch.zeros(batch, dtype=torch.int32)
    return {k: v.cuda() for k, v in req.items()}


def check_probs(label: str, probs, batch: int, img, classes: int = 1) -> None:
    """(batch, classes, H, W) finite probabilities in [0, 1] (`img` is H = W
    or (H, W)); with more than one class, each pixel's sum to 1."""
    import torch
    hw = (img, img) if isinstance(img, int) else tuple(img)
    if tuple(probs.shape) != (batch, classes, *hw):
        fail(f"{label}: output shape {tuple(probs.shape)}")
    if not bool(torch.isfinite(probs).all()):
        fail(f"{label}: non-finite probabilities")
    lo, hi = probs.min().item(), probs.max().item()
    if lo < 0.0 or hi > 1.0:
        fail(f"{label}: probabilities outside [0, 1]: [{lo}, {hi}]")
    if classes > 1:
        off = (probs.sum(dim=1) - 1).abs().max().item()
        if not off <= 1e-3:
            fail(f"{label}: class probabilities sum to 1 +- {off}")


def plain_path(f32_scores: bool = False):
    """A context in which every attention of the models takes
    `plain_attention` and every LayerNorm the plain chain N1 replaces: the
    reference the kernel paths are compared with. With `f32_scores` the
    attentions take the kernels' plain version instead, which keeps its
    scores in f32 as the kernels do: a second path without a kernel."""
    import contextlib
    from unittest import mock
    from tunevlseg_torch.nn import attention
    from tunevlseg_torch.ops import flash_attention as fa
    from tunevlseg_torch.ops import layer_norm as n1
    stack = contextlib.ExitStack()
    stack.enter_context(
        mock.patch.object(attention, "_kernel_eligible", lambda *a: ""))
    stack.enter_context(mock.patch.object(n1, "engages", lambda *a: False))
    if f32_scores:
        stack.enter_context(mock.patch.object(attention, "plain_attention",
                                              fa.biased_attention_ref))
    return stack


def kernels_on_path_inputs(fa, tag: str, run, kernels=("K1", "K3")) -> None:
    """`run()` once with K1 and K3 wrapped: each launch's output is held
    against the kernel's plain version on the very tensors the path gave it,
    at `KERNEL_TOL` of the largest |reference|; each of `kernels` must have
    launched. Says whether a difference between the kernel path and the plain
    path is a kernel's own."""
    import torch
    from unittest import mock
    from tunevlseg_torch.nn import attention
    seen = {"K1": [0, 0.0, 0.0], "K3": [0, 0.0, 0.0]}   # calls, worst ratio, its |ref|

    def held(name, kernel):
        def call(q, k, v, *bias, kv_valid=None):
            out = kernel(q, k, v, *bias, kv_valid=kv_valid)
            ref = fa.biased_attention_ref(q, k, v, *bias, kv_valid=kv_valid).float()
            top = ref.abs().max().item()
            ratio = (out.float() - ref).abs().max().item() / top
            entry = seen[name]
            entry[0] += 1
            if ratio >= entry[1]:
                entry[1:] = [ratio, top]
            return out
        return call

    with mock.patch.object(attention, "flash_attention",
                           held("K1", attention.flash_attention)), \
            mock.patch.object(attention, "biased_attention",
                              held("K3", attention.biased_attention)), \
            torch.no_grad():
        run()
        torch.cuda.synchronize()
    for name, (calls, ratio, top) in seen.items():
        if name not in kernels and calls == 0:
            continue
        print(f"{tag}: {name} on the path's own inputs, {calls} launches against "
              f"the plain version: worst max abs error {ratio:.4g} of the largest "
              f"|reference| ({top:.4g} there; bound {KERNEL_TOL})")
        if calls == 0 or not ratio <= KERNEL_TOL:
            fail(f"{tag}: {name} disagrees with its plain version on the path's "
                 "inputs, or was not launched")


def serve_requests(fa, tag: str, predict, params, requests, img: int,
                   per_forward: tuple, reps: int = 5, classes: int = 1):
    """Warm up, then `reps` timed forwards of each (label, request, batch)
    with the launch counts set to 0 just before and read just after; checks
    the per-forward launches (`COUNTED`) and the probabilities. Returns (the
    first request's probabilities, the counts)."""
    import torch
    for _, req, _ in requests:          # warm-up: cuBLAS/cuDNN handles, allocator
        predict(params, req)
    torch.cuda.synchronize()
    first_probs = None
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    for label, req, batch in requests:
        times = []
        for _ in range(reps):
            before = counts(fa)
            t = time.perf_counter()
            probs = predict(params, req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            grew = minus(counts(fa), before)
            if grew != per_forward:
                fail(f"{tag} {label}: one forward launched {COUNTED} = {grew}, "
                     f"expected {per_forward}")
        check_probs(f"{tag} {label}", probs, batch, img, classes)
        if first_probs is None:
            first_probs = probs
        lat = statistics.median(times)
        print(f"{tag}: {label}: latency median {lat * 1e3:.3f} ms over {reps} "
              f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
              f"{batch / lat:.1f} images/s, prob range "
              f"[{probs.min().item():.4f}, {probs.max().item():.4f}]")
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    forwards = len(requests) * reps
    print(f"{tag}: {COUNTED} launches in the main path {launches} "
          f"({forwards} forwards x {per_forward})")
    print(f"{tag}: peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if launches != tuple(forwards * n for n in per_forward):
        fail(f"{tag}: {COUNTED} launched {launches} times in the main path")
    return first_probs, launches


def compare_with_plain_path(fa, tag: str, predict, params, request, probs,
                            what: str = "b64 dedup",
                            tol: tuple = (PROB_MAX_TOL, PROB_MEAN_TOL)):
    """The kernel path's probabilities against the plain path's, within
    `tol`. A `tol` wider than the common bounds has to be earned in the same
    run: every K1 and K3 launch of the forward agrees with its plain version
    on the path's own inputs, and two paths WITHOUT a kernel (the plain path
    and the one with f32 scores) differ among themselves by at least half of
    what the kernel path differs from the plain path by. The model then
    amplifies a rounding, whichever code made it."""
    import torch

    def reference(name: str, f32_scores: bool):
        with plain_path(f32_scores):
            before = counts(fa)
            out = predict(params, request)
            torch.cuda.synchronize()
            if counts(fa) != before:
                fail(f"{tag}: the {name} reference launched a kernel")
        return out

    def differ(a, b):
        diff = (a - b).abs()
        return diff.max().item(), diff.mean().item()

    plain = reference("plain path", False)
    dmax, dmean = differ(probs, plain)
    print(f"{tag}: kernel path vs plain path, {what} probabilities: max abs "
          f"diff {dmax:.6g} (bound {tol[0]}), mean {dmean:.6g} "
          f"(bound {tol[1]})")
    if not (dmax <= tol[0] and dmean <= tol[1]):
        fail(f"{tag}: kernel path and plain path disagree beyond the stated bounds")
    if tol == (PROB_MAX_TOL, PROB_MEAN_TOL):
        return
    kernels_on_path_inputs(fa, tag, lambda: predict(params, request))
    plain_f32 = reference("plain path with f32 scores", True)
    kmax, kmean = differ(probs, plain_f32)
    pmax, pmean = differ(plain, plain_f32)
    print(f"{tag}: kernel path vs plain path with f32 scores: max abs diff "
          f"{kmax:.6g}, mean {kmean:.6g}; the two plain paths among themselves: "
          f"max {pmax:.6g}, mean {pmean:.6g} (at least half of the kernel path's "
          f"{dmax:.6g} and {dmean:.6g})")
    if not (2 * pmax >= dmax and 2 * pmean >= dmean):
        fail(f"{tag}: the kernel path differs from the plain path by more than "
             "twice what two kernel-free paths differ by: the wide bound is not "
             "earned")


def three_requests(seed: int, img: int, pad_id: int):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return [("b64 dedup U=1", make_request(gen, BATCH, 1, img, pad_id), BATCH),
            ("b64 dense", make_request(gen, BATCH, BATCH, img, pad_id), BATCH),
            ("b1", make_request(gen, 1, 1, img, pad_id), 1)]


def phase_serve(fa):
    import torch

    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model, _ = build_clipseg("coop", prompt_depth=3, num_context=4,
                             dtype=torch.bfloat16, device="cuda", seed=0)
    model.eval()
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    predict = task_predict_fn(SegmentationTask(model))
    print(f"serve: model CLIPSeg rd64 + CoOp(depth 3, n_ctx 4), bf16 compute "
          f"over f32 weights, {n_params} params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    requests = three_requests(1, IMG, 49407)
    probs, launches = serve_requests(fa, "serve", predict, params, requests, IMG,
                                     CLIPSEG_SERVE)
    compare_with_plain_path(fa, "serve", predict, params, requests[0][1], probs)
    return launches


def phase_serve_cris(fa, profile: bool):
    """CRIS RN50 + CoOp at 416^2 through the serving function (parameters and
    BatchNorm buffers passed in), then one b64 request on the stock model."""
    import torch

    from tunevlseg_torch.models.presets import build_cris
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model, _ = build_cris("coop", prompt_depth=3, num_context=4,
                          dtype=torch.bfloat16, device="cuda", seed=0)
    params = dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    predict = task_predict_fn(SegmentationTask(model))
    print(f"serve cris: model CRIS RN50 + CoOp(depth 3, n_ctx 4) at {CRIS_IMG}^2, "
          f"bf16 compute over f32 weights, {n_params} params, "
          f"{sum(b.numel() for b in model.buffers())} BatchNorm statistics, "
          f"built in {time.perf_counter() - t0:.1f} s")
    requests = three_requests(6, CRIS_IMG, 0)
    probs, launches = serve_requests(fa, "serve cris", predict, params, requests,
                                     CRIS_IMG, CRIS_SERVE)
    compare_with_plain_path(fa, "serve cris", predict, params, requests[0][1],
                            probs)
    if profile:
        for label, req, _ in (requests[0], requests[2]):
            profile_calls(f"serve cris {label}", lambda: predict(params, req))
    del model, params, predict, probs

    t0 = time.perf_counter()
    stock, _ = build_cris("e2e", dtype=torch.bfloat16, device="cuda", seed=0)
    predict = task_predict_fn(SegmentationTask(stock))
    print(f"serve cris e2e: the stock model (no learner, no additive head), "
          f"built in {time.perf_counter() - t0:.1f} s")
    _, stock_launches = serve_requests(
        fa, "serve cris e2e", predict, dict(stock.state_dict()), requests[1:2],
        CRIS_IMG, CRIS_SERVE, reps=3)
    return tuple(a + b for a, b in zip(launches, stock_launches))


def make_train_batch(batch: int, text_dedup: int, seed: int, img: int = IMG,
                     pad_id: int = 49407):
    """A training batch as the data pipeline makes it: per-sample uint8
    images, random {0, 1} masks and CLIP-style token ids (padded with
    `pad_id`: the EOS id for CLIPSeg, 0 for CRIS), stacked by the port's
    `collate` (prompt dedup to `text_dedup` rows, `valid` all ones) and moved
    to the card. text_dedup == 0 gives each sample its own prompt."""
    import numpy as np
    import torch
    from tunevlseg_torch.data.pipeline import collate, device_batch
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, 1000, size=(SEQ,)).astype(np.int32)
    samples = []
    for _ in range(batch):
        ids = shared.copy() if text_dedup else rng.integers(
            3, 1000, size=(SEQ,)).astype(np.int32)
        ids[0] = 49406
        ids[9] = 49407
        ids[10:] = pad_id
        samples.append({
            "image": rng.integers(0, 256, (3, img, img), dtype=np.uint8),
            "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids,
            "attention_mask": (ids != pad_id).astype(np.int32)})
    host = device_batch(collate(samples, batch, text_dedup=text_dedup))
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


# {label: (median step seconds, peak device bytes)} of `timed_steps`, read
# by the fit phase to set the loop's cost beside the bare step's
STEP_TIMES: dict = {}


def timed_steps(fa, task, state, batch, label: str, warmup: int, steps: int,
                per_step: tuple):
    """`warmup` untimed and `steps` timed train steps, the launch counts set
    to 0 before the timed ones and read after; checks the per-step launches and that every loss is finite. Returns (state, losses of all
    steps, the counts)."""
    import torch
    losses = []
    for _ in range(warmup):
        state, metrics = task.train_step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    times = []
    for _ in range(steps):
        before = counts(fa)
        t = time.perf_counter()
        state, metrics = task.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(metrics["loss"])
        grew = minus(counts(fa), before)
        if grew != per_step:
            fail(f"{label}: one step launched {COUNTED} = {grew}, expected "
                 f"{per_step}")
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"{label}: non-finite loss in {losses}")
    n = batch["image"].shape[0]
    med = statistics.median(times)
    STEP_TIMES[label] = (med, peak)
    print(f"{label}: step time median {med * 1e3:.3f} ms over {steps} "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{1 / med:.2f} steps/s, {n / med:.1f} images/s at batch {n}")
    print(f"{label}: {COUNTED} launches {launches} in {steps} steps; peak "
          f"device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"{label}: loss per step (warm-up first) "
          + " ".join(f"{x:.5f}" for x in losses))
    return state, losses, launches


def build_task(family: str, strategy: str, learning_rate: float,
               build_kwargs: dict = None, task_kwargs: dict = None):
    import torch
    from tunevlseg_torch.models.presets import build_clipseg, build_cris
    from tunevlseg_torch.training.optim import count_params
    from tunevlseg_torch.training.task import SegmentationTask
    t0 = time.perf_counter()
    build = {"CLIPSeg rd64": build_clipseg, "CRIS RN50": build_cris}[family]
    kwargs = {"dtype": torch.bfloat16, **(build_kwargs or {})}
    model, spec = build(strategy, prompt_depth=3, num_context=4, device="cuda",
                        seed=0, **kwargs)
    task = SegmentationTask(model, spec, learning_rate=learning_rate,
                            **(task_kwargs or {}))
    state = task.init()
    trainable = count_params(p for p in model.parameters() if p.requires_grad)
    compute = "bf16" if kwargs["dtype"] == torch.bfloat16 else str(kwargs["dtype"])
    print(f"train {strategy}: {family} {build_kwargs or ''}, {compute} compute over f32 weights, "
          f"{count_params(model.parameters())} params, {trainable} trainable, "
          f"lr {learning_rate}, built in {time.perf_counter() - t0:.1f} s")
    return task, state


def first_step(task, start: dict, batch, leaves=()) -> tuple:
    """The first train step from the weights `start` (the same dropout masks
    on every call: they depend on the seed and the step alone); returns its
    loss and {leaf: f32 gradient} for each of `leaves`."""
    import torch
    params = dict(task.model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            if p.requires_grad:
                p.copy_(start[name])
    _, metrics = task.train_step(task.init(), batch)
    return metrics["loss"].item(), {
        name: params[name].grad.detach().float().clone() for name in leaves}


def worst_leaf(got: dict, want: dict) -> tuple:
    """((least cosine, its leaf), (largest max abs diff over its leaf's
    largest |entry|, its leaf)) of the gradients `got` against `want`.
    Attention's k_proj biases are left out: their gradient is zero in exact
    arithmetic (a softmax does not see a shift shared by all its keys), so
    both sides hold rounding noise."""
    import torch
    worst_cos, worst_rel = (1.0, ""), (0.0, "")
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            continue
        a = got[name]
        cos = torch.nn.functional.cosine_similarity(a.flatten(), w.flatten(),
                                                    dim=0).item()
        rel = ((a - w).abs().max() / w.abs().max()).item()
        worst_cos, worst_rel = min(worst_cos, (cos, name)), max(worst_rel, (rel, name))
    return worst_cos, worst_rel


def first_step_kernel_vs_plain(fa, label: str, task, start: dict, batch,
                               leaves: tuple, *, cos_min: float = GRAD_COS_MIN,
                               loss_rel_tol: float | None = None,
                               printed: tuple = ()):
    """The first train step from the weights `start`, once on the kernel path
    and once with every attention on the plain path: the loss (within
    `LOSS_TOL`, or a relative gap of `loss_rel_tol`) and the gradient of each
    leaf in `leaves` (max abs diff within `GRAD_REL_TOL` of its largest entry,
    cosine at least `cos_min`). `printed`: leaves whose gradient rounding
    alone decides; their cosine is printed beside that of two kernel-free
    paths (the plain one, and with f32 scores), and not held."""
    import torch

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                     dim=0).item()

    names = leaves + printed
    loss_k, grads_k = first_step(task, start, batch, names)
    kernel_free = []
    for f32_scores in (False, True) if printed else (False,):
        with plain_path(f32_scores):
            before = counts(fa)
            kernel_free.append(first_step(task, start, batch, names))
            if counts(fa) != before:
                fail(f"{label}: a kernel-free step launched a kernel")
    loss_p, grads_p = kernel_free[0]
    if loss_rel_tol is None:
        ok = abs(loss_k - loss_p) <= LOSS_TOL
        bound = f"bound {LOSS_TOL}"
    else:
        gap = abs(loss_k - loss_p) / abs(loss_p)
        ok = gap <= loss_rel_tol
        bound = f"relative gap {gap:.3g}, bound {loss_rel_tol}"
    print(f"{label}: kernel path vs plain path, first step: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} ({bound})")
    for name in leaves:
        top = grads_p[name].abs().max().item()
        gdiff = (grads_k[name] - grads_p[name]).abs().max().item()
        cos = cosine(grads_k[name], grads_p[name])
        print(f"{label}:   gradient of {name}: max abs diff {gdiff:.6g} against "
              f"largest entry {top:.6g} (bound {GRAD_REL_TOL} of it), cosine "
              f"{cos:.6f} (at least {cos_min})")
        ok = ok and gdiff <= GRAD_REL_TOL * top and cos >= cos_min
    for name in printed:
        print(f"{label}:   gradient of {name} (printed, not held: rounding decides "
              f"it): cosine {cosine(grads_k[name], grads_p[name]):.6f} against the "
              f"plain path; the two kernel-free paths "
              f"{cosine(kernel_free[1][1][name], grads_p[name]):.6f}")
    if not ok:
        fail(f"{label}: kernel path and plain path disagree beyond the stated "
             "bounds")


def phase_train_coop(fa, profile: bool):
    import torch

    task, state = build_task("CLIPSeg rd64", "coop", 2e-4)
    model = task.model
    batch = make_train_batch(BATCH, text_dedup=1, seed=3)
    if batch["input_ids"].shape[0] != 1 or "text_index" not in batch:
        fail("train coop: collate did not give the U = 1 prompt-dedup layout")
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    ctx = model.learner.context_vectors

    state, _, launches = timed_steps(fa, task, state, batch, "train coop",
                                     warmup=2, steps=5,
                                     per_step=CLIPSEG_COOP_STEP)
    if torch.equal(ctx, start["learner.context_vectors"]):
        fail("train coop: the context vectors did not change")
    if model.residual_ratio.detach().item() != 0.5:
        fail("train coop: residual_ratio, which nothing reads, moved")
    for name, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, start[name]):
            fail(f"train coop: frozen tensor {name} changed")
    print("train coop: context vectors changed, every frozen tensor "
          "bit-identical, residual_ratio still 0.5")
    first_step_kernel_vs_plain(fa, "train coop", task, start, batch,
                               ("learner.context_vectors",))
    if profile:
        profile_step("coop", task, task.init(), batch)
    return launches


def phase_train_e2e(fa, profile: bool):
    task, state = build_task("CLIPSeg rd64", "e2e", 1e-4)
    batch = make_train_batch(E2E_BATCH, text_dedup=0, seed=4)
    if batch["input_ids"].shape[0] != E2E_BATCH:
        fail("train e2e: expected dense prompts")
    print(f"train e2e: batch {E2E_BATCH} rather than {BATCH}, to keep the "
          "whole script short")
    state, losses, launches = timed_steps(fa, task, state, batch, "train e2e",
                                          warmup=2, steps=6,
                                          per_step=CLIPSEG_E2E_STEP)
    if not losses[-1] < losses[0]:
        fail(f"train e2e: the loss did not fall: {losses[0]} -> {losses[-1]}")
    print(f"train e2e: loss fell {losses[0]:.5f} -> {losses[-1]:.5f} on one "
          "fixed batch")
    if profile:
        profile_step("e2e", task, state, batch)
    return launches


class InMemoryDataset:
    """`n` samples as a dataset of the port yields them (uint8 image, mask,
    one prompt's ids, name and original shape), made once, read by index."""

    def __init__(self, n: int, seed: int, img: int = IMG):
        import numpy as np
        rng = np.random.default_rng(seed)
        ids = np.full((SEQ,), 49407, np.int32)
        ids[0] = 49406
        ids[1:9] = rng.integers(3, 1000, size=(8,))
        mask = (ids != 49407).astype(np.int32)
        self.samples = [{
            "image": rng.integers(0, 256, (3, img, img), dtype=np.uint8),
            "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "mask_name": f"{seed}_{i}.png", "mask_shape": (img, img),
            "prompt": "synthetic"} for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[int(i)]


class SigtermAfter:
    """A train loader that sends this process SIGTERM as it hands out its
    `n`-th batch of the run (counted over epochs), as a preemption would."""

    def __init__(self, loader, n: int):
        self.loader, self.n, self.seen = loader, n, 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        self.loader.set_epoch(epoch, start_batch)

    def __iter__(self):
        import os
        import signal
        for batch in self.loader:
            self.seen += 1
            if self.seen == self.n:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def phase_fit_coop(fa):
    """`Trainer.fit` on the full-width CLIPSeg CoOp model over an in-memory
    dataset: uninterrupted, then interrupted by SIGTERM after batch 5 and
    resumed from `last`; test on `best`, predict."""
    import tempfile
    from pathlib import Path
    import torch
    from tunevlseg_torch.data.pipeline import DataLoader
    from tunevlseg_torch.training.loop import EarlyStopping, Trainer
    from tunevlseg_torch.training.optim import (ReduceLROnPlateau,
                                                get_learning_rate)

    t0 = time.perf_counter()
    train_ds, val_ds, test_ds = (InMemoryDataset(n, seed, IMG) for n, seed in
                                 ((4 * BATCH, 11), (BATCH, 12), (BATCH, 13)))
    print(f"fit coop: in-memory dataset of {len(train_ds)} train, {len(val_ds)} "
          f"val and {len(test_ds)} test samples (uint8 {IMG}^2, one prompt) "
          f"made in {time.perf_counter() - t0:.1f} s")

    def loader(ds, shuffle):
        return DataLoader(ds, BATCH, shuffle=shuffle, seed=5, num_workers=4,
                          text_dedup=1)

    task, _ = build_task("CLIPSeg rd64", "coop", 2e-4)
    model = task.model
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    trainable = [n for n, p in params.items() if p.requires_grad]
    epochs, batches = 2, len(train_ds) // BATCH

    def trainer(out):
        return Trainer(task, out, max_epochs=epochs, log_every_n_steps=2,
                       ckpt_every_n_steps=3,
                       scheduler=ReduceLROnPlateau(factor=0.2, patience=0),
                       early_stopping=EarlyStopping(),
                       loggers=("jsonl", "csv"))

    def fresh_state():
        with torch.no_grad():
            for n in trainable:
                params[n].copy_(start[n])
        return task.init()

    work = Path(tempfile.mkdtemp(prefix="fit_coop_"))
    # (a) uninterrupted
    tr_a = trainer(work / "a")
    state = fresh_state()
    t = time.perf_counter()
    tr_a.ckpt.save_frozen()
    frozen_s = time.perf_counter() - t
    frozen_bytes = (tr_a.ckpt.dir / "frozen" / "frozen.pt").stat().st_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t = time.perf_counter()
    final_a = tr_a.fit(state, loader(train_ds, True), loader(val_ds, False))
    fit_s = time.perf_counter() - t
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    forwards = 2 * epochs          # per epoch: the val panel and the val batch
    want = tuple(s * final_a.step + f * forwards for s, f in
                 zip(CLIPSEG_COOP_STEP, CLIPSEG_SERVE))
    if final_a.step != epochs * batches:
        fail(f"fit coop: {final_a.step} steps, expected {epochs * batches}")
    if launches != want:
        fail(f"fit coop: {COUNTED} launches {launches} over {final_a.step} "
             f"train steps and {forwards} forwards, expected {want}")
    print(f"fit coop: {epochs} epochs of {batches} b{BATCH} batches + val in "
          f"{fit_s:.2f} s; {COUNTED} launches {launches} = {final_a.step} x "
          f"{CLIPSEG_COOP_STEP[:3]} + {forwards} x {CLIPSEG_SERVE[:3]}")
    ctx = "learner.context_vectors"
    if torch.equal(params[ctx], start[ctx]):
        fail("fit coop: the context vectors did not change")
    for name, p in params.items():
        if not p.requires_grad and not torch.equal(p, start[name]):
            fail(f"fit coop: frozen tensor {name} changed")
    for tag in ("best", "last", "frozen"):
        if not (tr_a.ckpt.dir / tag).is_dir():
            fail(f"fit coop: no '{tag}' checkpoint")
    meta = tr_a.ckpt.load_meta("last")
    for key in ("val_loss", "val_dice", "val_iou"):
        if not np_finite(meta.get(key)):
            fail(f"fit coop: {key} = {meta.get(key)}")
    bare_s, bare_peak = STEP_TIMES["train coop"]
    for epoch, n, secs in tr_a.train_times:
        print(f"fit coop [{CARD[0]}]: epoch {epoch} train part {secs * 1e3:.3f} ms for {n} "
              f"steps = {secs * 1e3 / n:.3f} ms a step in the loop (host clock, "
              f"device drained at both ends) against the bare train_step's "
              f"median {bare_s * 1e3:.3f} ms (train coop): loop overhead "
              f"{(secs / n - bare_s) * 1e3:+.3f} ms a step")
    print(f"fit coop [{CARD[0]}]: peak device memory over the fit {peak} bytes "
          f"({peak / 2**30:.2f} GiB) against {bare_peak} ({bare_peak / 2**30:.2f} "
          "GiB) over the bare steps (train coop)")
    print(f"fit coop: val after epoch {int(meta['epoch'])}: loss {meta['val_loss']:.6f} "
          f"dice {meta['val_dice']:.6f} iou {meta['val_iou']:.6f}; lr "
          f"{get_learning_rate(final_a.optimizer):.3g}; best val_dice "
          f"{tr_a.ckpt.best_value:.6f}")
    print(f"fit coop [{CARD[0]}]: save_frozen {frozen_s * 1e3:.1f} ms for {frozen_bytes} "
          "bytes (the frozen parameters and buffers in f32, once per run)")
    t = time.perf_counter()
    tr_a.ckpt.save("probe", final_a, {"epoch": -1})
    d2h_s = time.perf_counter() - t
    tr_a.ckpt.wait()
    write_s = time.perf_counter() - t - d2h_s
    probe_bytes = (tr_a.ckpt.dir / "probe" / "state.pt").stat().st_size
    print(f"fit coop [{CARD[0]}]: save of the train state {d2h_s * 1e3:.3f} ms to the host "
          f"(blocking part), then {write_s * 1e3:.3f} ms to write and promote "
          f"{probe_bytes} bytes (trainable parameters, optimizer moments, step)")
    snapshot_a = fit_snapshot(tr_a, final_a, params, trainable)
    loop_costs(task, work, loader(train_ds, True), bare_s)

    # (b) SIGTERM as the 5th batch is handed out, then (c) resume from last
    reset_counts(fa)
    tr_b = trainer(work / "b")
    state_b = tr_b.fit(fresh_state(), SigtermAfter(loader(train_ds, True), 5),
                       loader(val_ds, False))
    meta_b = tr_b.ckpt.load_meta("last")
    if not (meta_b.get("preempted") and meta_b["epoch"] == 0
            and meta_b["batch_offset"] == 1 and state_b.step == 5):
        fail(f"fit coop: the preempted run saved {meta_b} at step {state_b.step}")
    tr_c = trainer(work / "b")
    final_c = tr_c.fit(fresh_state(), loader(train_ds, True),
                       loader(val_ds, False), resume_from="last")
    launches_bc = counts(fa)
    want_bc = tuple(s * final_c.step + f * forwards for s, f in
                    zip(CLIPSEG_COOP_STEP, CLIPSEG_SERVE))
    if launches_bc != want_bc:
        fail(f"fit coop: interrupted + resumed runs launched {launches_bc}, "
             f"expected {want_bc}")
    snapshot_c = fit_snapshot(tr_c, final_c, params, trainable)
    differ = [k for k in snapshot_a if not same(snapshot_a[k], snapshot_c[k])]
    if differ:
        fail(f"fit coop: the resumed run differs from the uninterrupted one in "
             f"{differ}")
    print(f"fit coop: SIGTERM after batch 5 saved 'last' at step 5 (epoch 0 "
          f"done, batch_offset 1); resumed from it: trainable tensors, optimizer "
          f"moments, step {final_c.step}, scheduler {snapshot_c['scheduler']}, "
          f"early stopping {snapshot_c['early_stopping']}, best value "
          f"{snapshot_c['best_value']:.6f} and lr {snapshot_c['lr']:.3g} "
          "bit-identical to the uninterrupted run")

    # test on best, predict
    best = torch.load(tr_c.ckpt.dir / "best" / "state.pt", map_location="cpu",
                      weights_only=True)
    result = tr_c.test(final_c, loader(test_ds, False), use_best=True)
    for name in trainable:
        if not torch.equal(params[name].cpu(), best["trainable"][name]):
            fail(f"fit coop: test(use_best=True) left {name} off the best "
                 "checkpoint's")
    if not all(np_finite(v) for v in result.values()):
        fail(f"fit coop: test metrics {result}")
    preds = tr_c.predict(final_c, loader(test_ds, False))
    if len(preds) != BATCH:
        fail(f"fit coop: predict gave {len(preds)} masks")
    for rec in preds:
        p = rec["pred"]
        if p.shape != (IMG, IMG) or not (p >= 0).all() or not (p <= 1).all():
            fail(f"fit coop: a predicted mask of shape {p.shape} in "
                 f"[{p.min()}, {p.max()}]")
    print(f"fit coop: test on best (restored: trainable tensors equal the best "
          f"checkpoint's) {result}; predict {len(preds)} masks of {IMG}^2 in "
          "[0, 1]")
    import shutil
    shutil.rmtree(work)
    return launches


class BatchList:
    """Batches collated beforehand, handed out as a loader does."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        pass

    def __iter__(self):
        return iter(self.batches)


def loop_costs(task, work, train_loader, bare_s: float) -> None:
    """Where the loop's time goes beyond the bare step: the loader alone
    (host clock from `iter` to each batch, nothing training), a batch's
    `device_batch` (pinned, then copied), then one epoch of the same
    Trainer over batches collated beforehand (no producer thread)."""
    from tunevlseg_torch.data.pipeline import device_batch
    from tunevlseg_torch.training.loop import Trainer
    train_loader.set_epoch(0)
    t = time.perf_counter()
    stamps, batches = [], []
    for batch in train_loader:
        stamps.append(time.perf_counter() - t)
        batches.append(batch)
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    print(f"fit coop [{CARD[0]}]: the loader alone (4 worker threads, collate in its "
          f"producer thread): first batch after {stamps[0] * 1e3:.3f} ms, then "
          f"{statistics.mean(gaps) * 1e3:.3f} ms a batch")
    import torch
    device = next(task.model.parameters()).device
    copies = []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        device_batch(batch, device)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t)
    nbytes = sum(torch.as_tensor(v).nbytes
                 for v in device_batch(batches[0]).values())
    print(f"fit coop [{CARD[0]}]: device_batch of a b{BATCH} batch ({nbytes} bytes) "
          f"{statistics.median(copies) * 1e3:.3f} ms: pinned, copied to the "
          "card, synchronized")
    tr = Trainer(task, work / "d", max_epochs=1, log_every_n_steps=2,
                 ckpt_every_n_steps=3, log_image_num=0)
    tr.fit(task.init(), BatchList(batches))
    _, n, secs = tr.train_times[0]
    print(f"fit coop [{CARD[0]}]: the same loop over batches collated beforehand: "
          f"{secs * 1e3 / n:.3f} ms a step ({n} steps; bare "
          f"train_step {bare_s * 1e3:.3f} ms)")


def np_finite(x) -> bool:
    return isinstance(x, float) and x == x and abs(x) != float("inf")


def same(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def fit_snapshot(tr, state, params, trainable) -> dict:
    """What a resumed fit must reproduce bit for bit."""
    from tunevlseg_torch.training.optim import get_learning_rate
    opt = state.optimizer.optimizer
    return {
        "trainable": {n: params[n].detach().clone() for n in trainable},
        "moments": {n: {k: v.clone() for k, v in opt.state[params[n]].items()}
                    for n in trainable if params[n] in opt.state},
        "step": state.step, "lr": get_learning_rate(state.optimizer),
        "scheduler": tr._fit_extra()["scheduler"],
        "early_stopping": tr._fit_extra()["early_stopping"],
        "best_value": tr.ckpt.best_value}


def phase_train_cris(fa, profile: bool):
    """CoOp steps of CRIS RN50 at b64 with prompt dedup: the backbone is
    frozen, the gradient runs back through the projector, the decoder (K2 at
    676 tokens; K3's backward is a plain recompute), the neck and the text
    tower into the context vectors and the additive head."""
    import torch

    task, state = build_task("CRIS RN50", "coop", 2e-4)
    model = task.model
    batch = make_train_batch(BATCH, text_dedup=1, seed=7, img=CRIS_IMG, pad_id=0)
    if batch["input_ids"].shape[0] != 1 or "text_index" not in batch:
        fail("train cris: collate did not give the U = 1 prompt-dedup layout")
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    want = ["additive_conv1.weight", "additive_conv2.bias",
            "additive_conv2.weight", "learner.context_vectors", "residual_ratio"]
    if trainable != want:
        fail(f"train cris: trainable leaves {trainable}, expected {want}")

    state, _, launches = timed_steps(fa, task, state, batch, "train cris",
                                     warmup=2, steps=5, per_step=CRIS_COOP_STEP)
    now = model.state_dict()
    for name in trainable:
        if torch.equal(now[name], start[name]):
            fail(f"train cris: trainable leaf {name} did not change")
    buffers = [n for n, _ in model.named_buffers()]
    for name, value in now.items():
        if name not in trainable and not torch.equal(value, start[name]):
            fail(f"train cris: frozen tensor or buffer {name} changed")
    print(f"train cris: the context vectors and the additive head changed; "
          f"{len(now) - len(trainable) - len(buffers)} frozen tensors and "
          f"{len(buffers)} BatchNorm buffers bit-identical")
    first_step_kernel_vs_plain(fa, "train cris", task, start, batch,
                               ("learner.context_vectors",
                                "additive_conv1.weight"))
    if profile:
        profile_step("cris coop", task, task.init(), batch)
    return launches


# --- K4, the flat convolution, and the CRIS paths that run on it -------------

# label, H = W, the stage's planes (they size the spec), C, Cout, k, ReLU,
# affine, residual, dx form: the RN50's own shapes at 416^2
K4_CASES = (
    ("stem 3x3 32->64 208^2", 208, 32, 32, 64, 3, True, True, False, False),
    ("stage1 3x3 64->64 104^2", 104, 64, 64, 64, 3, True, True, False, False),
    ("stage1 1x1 64->256 104^2 +res", 104, 64, 64, 256, 1, True, True, True, False),
    ("stage2 3x3 128->128 104^2", 104, 128, 128, 128, 3, True, True, False, False),
    ("stage2 3x3 128->128 52^2", 52, 128, 128, 128, 3, True, True, False, False),
    ("stage4 3x3 512->512 13^2", 13, 512, 512, 512, 3, True, True, False, False),
    ("stage4 1x1 512->2048 13^2 +res", 13, 512, 512, 2048, 1, True, True, True, False),
    ("stage3 3x3 256->256 26^2 no affine no relu", 26, 256, 256, 256, 3, False,
     False, False, False),
    ("stage1 3x3 64->64 104^2 dx form", 104, 64, 64, 64, 3, False, False, False, True),
)
K4_MAIN = "stage1 3x3 64->64 104^2"
# FreeSOLO's R101 on layout="flat" at a 1024^2 request (b1): the three
# convolutions of a stride-1 bottleneck of each stage, 2 / 3 / 22 / 2 such
# blocks (87 launches a forward)
ZS_K4_BLOCKS = (("res2", 256, 64, 2), ("res3", 128, 128, 3),
                ("res4", 64, 256, 22), ("res5", 32, 512, 2))
ZS_K4_CASES = tuple(
    case for name, hw, planes, _ in ZS_K4_BLOCKS for case in (
        (f"zsseg {name} 1x1 {4 * planes}->{planes} {hw}^2", hw, planes,
         4 * planes, planes, 1, True, True, False, False),
        (f"zsseg {name} 3x3 {planes}->{planes} {hw}^2", hw, planes, planes,
         planes, 3, True, True, False, False),
        (f"zsseg {name} 1x1 {planes}->{4 * planes} {hw}^2 +res", hw, planes,
         planes, 4 * planes, 1, True, True, True, False)))


def conv_bound(b, hw, k, c, cout, residual: bool):
    """(bound_ms, bound_by, flops) of a k x k convolution from its pixel work,
    whatever implements it: 2*B*H*W*k*k*C*Cout operations over the bf16
    tensor-core rate against the bytes of the unpadded input, output,
    residual and weight over the memory rate."""
    flops = 2 * b * hw * hw * k * k * c * cout
    nbytes = 2 * (b * hw * hw * (c + cout * (2 if residual else 1))
                  + k * k * c * cout)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            flops)


def conv_backward_bound(b, hw, k, c, cout, w_itemsize: int):
    """(bound_ms, bound_by) of a convolution's backward (dx and dW) from its
    pixel work: twice the forward's 2*B*H*W*k*k*C*Cout operations over the
    bf16 tensor-core rate against the bytes of dy and x read and dx (bf16)
    and dW (at the weight's item size) written once over the memory rate."""
    flops = 2 * 2 * b * hw * hw * k * k * c * cout
    nbytes = 2 * b * hw * hw * (cout + 2 * c) + w_itemsize * k * k * c * cout
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def flat_case(cf, gen, b, hw, planes, c, cout, k, affine, residual, dx_form):
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    spec = cf.make_flat_spec(hw, hw, 1, max_k2c=9 * planes, itemsize=2)
    x = cf.flat_begin(rnd(b, hw, hw, c).bfloat16(), spec)
    weight = rnd(cout, c, k, k) * (k * k * c) ** -0.5
    if dx_form:     # what the backward hands the kernel: W'[t'] = W[k*k-1-t']^T
        weight = weight.flip(2, 3).transpose(0, 1).contiguous()
    scale = rnd(cout).abs() + 0.5 if affine else None
    offset = rnd(cout) * 0.1 if affine else None
    res = cf.flat_begin(rnd(b, hw, hw, cout).bfloat16(), spec) if residual else None
    return spec, x, weight, scale, offset, res


def plain_conv_flat(cf, spec, relu, x, weight, scale, offset, res):
    """`conv_flat_ref` on the arguments `conv_flat` takes."""
    import torch
    cout, c, k, _ = weight.shape
    w_mat = weight.permute(2, 3, 1, 0).reshape(k * k * c, cout)
    ones = torch.ones(cout, device=x.device)
    return cf.conv_flat_ref(spec, relu, x, w_mat, ones if scale is None else scale,
                            ones * 0 if offset is None else offset, res)


def exact_conv_flat(cf, spec, relu, x, weight, scale, offset, res):
    """The plain version's f32 value, before its one rounding to bf16:
    `conv_flat_ref` on the same bf16 values held in f32 (the weight rounded
    to bf16 first, as the kernel takes it)."""
    return plain_conv_flat(cf, spec, relu, x.float(), weight.bfloat16().float(),
                           scale, offset, None if res is None else res.float())


def k4_on_path_inputs(cf, tag: str, run, module=None) -> int:
    """`run()` once with the ResNet's flat convolutions wrapped (those that
    `module` calls, by default CRIS's and DenseCLIP's `models/cris/resnet`):
    each K4 launch's output is held against the plain version's f32 value on
    the very tensors the path gave it (`exact_conv_flat`), at `K4_REL_TOL` of
    the largest |reference|, its guard and ring rows exactly zero. Prints the
    worst launch of each plane size; returns the number of launches held."""
    import torch
    from unittest import mock
    if module is None:
        from tunevlseg_torch.models.cris import resnet as module
    real = module.conv_flat
    seen = {}       # (H, W) -> [launches, worst ratio, its |ref|, its shape]
    broken = []

    def held(flat, spec, weight, scale=None, offset=None, relu=False,
             residual=None):
        out = real(flat, spec, weight, scale, offset, relu, residual)
        ref = exact_conv_flat(cf, spec, relu, flat, weight, scale, offset, residual)
        top = ref.abs().max().item()
        ratio = (out.float() - ref).abs().max().item() / top
        cout, c, k, _ = weight.shape
        shape = f"{k}x{k} {c}->{cout}{' +res' if residual is not None else ''}"
        if not bool((out[:, ~cf._valid_rows(spec, out.device)] == 0).all()):
            broken.append(f"{spec.h}x{spec.w} {shape}")
        entry = seen.setdefault((spec.h, spec.w), [0, 0.0, 0.0, ""])
        entry[0] += 1
        if ratio >= entry[1]:
            entry[1:] = [ratio, top, shape]
        return out

    with mock.patch.object(module, "conv_flat", held), torch.no_grad():
        run()
        torch.cuda.synchronize()
    for (h, w), (calls, ratio, top, shape) in sorted(seen.items(), reverse=True):
        print(f"{tag}: K4 on the path's own inputs at {h}x{w} planes, {calls} "
              f"launches against the plain version's f32 value: worst max abs "
              f"error {ratio:.4g} of the largest |reference| ({top:.4g} there, "
              f"{shape}; bound {K4_REL_TOL})")
    worst = max((v[1] for v in seen.values()), default=float("inf"))
    if not seen or broken or not worst <= K4_REL_TOL:
        fail(f"{tag}: K4 disagrees with its plain version on the path's inputs, "
             f"was not launched, or left guard or ring rows nonzero ({broken})")
    return sum(v[0] for v in seen.values())


def phase_kernels_k4(cf, cases=K4_CASES, batch=BATCH, device_time=False):
    """K4 against its plain version at the RN50's shapes at b64 (or at
    `cases` and `batch`), `F.conv2d` beside it, with `device_time` also the
    kernel's device time from torch.profiler (where the host launches slower
    than the card runs); returns {label: numbers}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for label, hw, planes, c, cout, k, relu, affine, residual, dx_form in cases:
        spec, x, weight, scale, offset, res = flat_case(
            cf, gen, batch, hw, planes, c, cout, k, affine, residual, dx_form)
        before = cf.launch_count()
        out = cf.conv_flat(x, spec, weight, scale, offset, relu, res)
        torch.cuda.synchronize()
        if cf.launch_count() != before + 1:
            fail(f"K4 {label}: the wrapper did not count its launch")
        if out.shape != (batch, spec.rows, cout) or out.dtype != torch.bfloat16:
            fail(f"K4 {label}: output is {tuple(out.shape)} {out.dtype}")
        ref = exact_conv_flat(cf, spec, relu, x, weight, scale, offset, res)
        err = (out.float() - ref).abs().max().item()
        top = ref.abs().max().item()
        if not err <= K4_REL_TOL * top:
            fail(f"K4 {label}: max abs error {err} > {K4_REL_TOL} x {top}")
        valid = cf._valid_rows(spec, x.device)
        if not bool((out[:, ~valid] == 0).all()):
            fail(f"K4 {label}: guard or ring rows are not exactly zero")
        del ref
        ms = cuda_time_ms(
            lambda: cf.conv_flat(x, spec, weight, scale, offset, relu, res), 20)
        plain_ms = cuda_time_ms(lambda: plain_conv_flat(
            cf, spec, relu, x, weight, scale, offset, res), 2, warmup=1)
        # one PyTorch call for the convolution alone, on the unpadded pixels
        x_nchw = cf.flat_end(x, spec).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w_cl = weight.bfloat16().contiguous(memory_format=torch.channels_last)
        lib_ms = cuda_time_ms(lambda: F.conv2d(x_nchw, w_cl, padding=k // 2), 20)
        # the weight copy each launch makes (cast, transposed to the kernel's
        # layout); it is inside `ms`
        w_mat = weight.permute(2, 3, 1, 0).reshape(k * k * c, cout)
        copy_ms = cuda_time_ms(lambda: cf.kernel_weight(w_mat, c, torch.bfloat16), 20)
        bound_ms, bound_by, flops = conv_bound(batch, hw, k, c, cout, residual)
        device = {}
        if device_time:
            device["device_ms"] = kernel_device_ms(
                f"K4 {label}", lambda: cf.conv_flat(x, spec, weight, scale, offset,
                                                    relu, res),
                {"conv_flat_kernel": 1}, bound_ms)[0]["conv_flat_kernel"]
            # every kernel F.conv2d launches (an empty key is in every name),
            # held to the bound of the convolution alone
            device["lib_device_ms"] = kernel_device_ms(
                f"F.conv2d {label}", lambda: F.conv2d(x_nchw, w_cl, padding=k // 2),
                {"": None}, conv_bound(batch, hw, k, c, cout, False)[0])[0][""]
        print(f"kernel K4 {label} x{tuple(x.shape)} (b{batch}, {hw}^2 pixels in "
              f"{spec.rows} rows, guard {spec.mb}: {1 - hw * hw / spec.rows:.3f} of "
              f"the rows hold no pixel) C {c} Cout {cout} k {k}: "
              f"max_abs_err {err:.6g} against the plain version's f32 value "
              f"(bound {K4_REL_TOL} x largest |reference| "
              f"{top:.4g}), {int((~valid).sum())} guard and ring rows exactly 0, "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; its weight copy "
              f"alone {copy_ms:.4f} ms), plain "
              f"{plain_ms:.3f} ms, F.conv2d bf16 channels-last (the convolution "
              f"alone, no epilogue) {lib_ms:.4f} ms, K4 / F.conv2d "
              f"{ms / lib_ms:.2f}, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({100 * bound_ms / ms:.1f}% reached)"
              + ("" if not device else
                 f"; device time {device['device_ms']:.4f} ms with the L2 "
                 f"flushed before each call ({100 * bound_ms / device['device_ms']:.1f}% "
                 f"of bound), F.conv2d's {device['lib_device_ms']:.4f} ms"))
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms, "over_library": ms / lib_ms,
                          "weight_copy_ms": copy_ms, **device}
        del out, x, res, x_nchw
    return results


# N1 at the flagship's shapes: the ViT's 21 calls a step (b64 x 485 rows of
# 768), the CLIPSeg decoder's (485 rows of 64) and CRIS's text-to-pixel rows
# (b64 x 676 rows of 512), bf16 in and out
N1_SHAPES = (("vit", BATCH * 485, 768), ("decoder", BATCH * 485, 64),
             ("cris", BATCH * 676, 512))
# N1 against the plain chain: y within one bf16 ulp, or 1e-5 where |y| is
# tiny (the f32 statistics are summed in another order: the mean differs by
# a few f32 ulps); dx within one bf16 ulp of its largest magnitude and 1e-5
# more; dw and db within 1e-5 of the sum of their terms' magnitudes
N1_NOISE = 1e-5


def phase_kernel_n1() -> dict:
    """N1 (`csrc/layer_norm.cu`) forward and backward against the plain
    chain it replaces (x to f32, f32 `F.layer_norm`, y to bf16; its
    backward through autograd) at `N1_SHAPES`: y, dx, dw and db held, two
    backward calls bit-identical; the device time of each kernel (L2
    flushed, torch.profiler) and by CUDA events, beside its bytes bound (the
    forward reads x and writes y, the backward reads dy and x and writes dx,
    and 8 bytes of statistics a row) and beside the chain's time by events.
    Returns {shape: numbers}."""
    import torch

    from tunevlseg_torch.ops import layer_norm as n1
    from tunevlseg_torch.ops import library
    bf16, eps = torch.bfloat16, 1e-5
    numbers = {}
    for label, rows, d in N1_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(rows + d)
        x = (torch.randn(rows, d, generator=gen, device="cuda") * 2 + 1).to(bf16)
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)

        def fwd():
            return library.layer_norm(x, w, b, eps, bf16)

        y, mean, rstd = fwd()

        def bwd():
            return n1._launch_bwd(dy, x, w, mean, rstd, True, True, True)

        dx, dw, db = bwd()
        again = bwd()
        xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
        y_chain = n1.layer_norm_ref(xr, wr, br, eps, bf16)

        def chain_fwd():
            return n1.layer_norm_ref(x, w, b, eps, bf16)

        def chain_bwd():
            return torch.autograd.grad(y_chain, (xr, wr, br), dy, retain_graph=True)

        gx, gw, gb = chain_bwd()
        torch.cuda.synchronize()
        y_gap = (y.float() - y_chain.float()).abs()
        _, exp = torch.frexp(torch.maximum(y.float().abs(), y_chain.float().abs()))
        y_ulp = torch.ldexp(torch.ones_like(y_gap), exp - 8).clamp(min=N1_NOISE)
        y_ulps = (y_gap / y_ulp).max().item()
        dx_gap = (dx.float() - gx.float()).abs().max().item() / gx.float().abs().max().item()
        xh = (x.float() - mean[:, None]) * rstd[:, None]
        dw_gap = ((dw - gw).abs() / (dy.float() * xh).abs().sum(0)).max().item()
        db_gap = ((db - gb).abs() / dy.float().abs().sum(0)).max().item()
        same = all(torch.equal(p, q) for p, q in zip((dx, dw, db), again))
        row_bytes = rows * d * 2
        bound_f = (2 * row_bytes + 8 * rows) / HBM_BYTES_PER_S * 1e3
        bound_b = (3 * row_bytes + 8 * rows) / HBM_BYTES_PER_S * 1e3
        dev_f, _ = kernel_device_ms(f"N1 {label} forward", fwd,
                                    {"layer_norm_fwd_kernel": 1}, bound_f)
        dev_b, _ = kernel_device_ms(f"N1 {label} backward", bwd,
                                    {"layer_norm_bwd_kernel": 1,
                                     "layer_norm_bwd_sum_kernel": 1}, bound_b)
        r = {"fwd_device_ms": dev_f["layer_norm_fwd_kernel"],
             "bwd_device_ms": dev_b["layer_norm_bwd_kernel"],
             "bwd_sum_device_ms": dev_b["layer_norm_bwd_sum_kernel"],
             "fwd_ms": cuda_time_ms(fwd, 50), "bwd_ms": cuda_time_ms(bwd, 50),
             "chain_fwd_ms": cuda_time_ms(chain_fwd, 50),
             "chain_bwd_ms": cuda_time_ms(chain_bwd, 50),
             "fwd_bound_ms": bound_f, "bwd_bound_ms": bound_b,
             "y_ulps": y_ulps, "dx_gap": dx_gap, "dw_gap": dw_gap, "db_gap": db_gap,
             "deterministic": same}
        r["fwd_roofline"] = 100 * bound_f / r["fwd_device_ms"]
        r["bwd_roofline"] = 100 * bound_b / (r["bwd_device_ms"] + r["bwd_sum_device_ms"])
        numbers[label] = r
        print(f"N1 {label} {rows} x {d} bf16: forward device {r['fwd_device_ms']:.4f} ms "
              f"(events {r['fwd_ms']:.4f}), bound {bound_f:.4f} ms by bytes "
              f"({r['fwd_roofline']:.1f}%), the chain {r['chain_fwd_ms']:.4f} ms "
              f"({r['chain_fwd_ms'] / r['fwd_ms']:.2f}x); backward device "
              f"{r['bwd_device_ms']:.4f} + sum {r['bwd_sum_device_ms']:.4f} ms (events "
              f"{r['bwd_ms']:.4f}), bound {bound_b:.4f} ms ({r['bwd_roofline']:.1f}%), "
              f"the chain's autograd {r['chain_bwd_ms']:.4f} ms "
              f"({r['chain_bwd_ms'] / r['bwd_ms']:.2f}x); y against the chain at most "
              f"{y_ulps:.2f} bf16 ulp (or 1e-5), dx {dx_gap:.3g} of its largest, dw {dw_gap:.3g} "
              f"and db {db_gap:.3g} of their terms' magnitudes; two backward calls "
              f"bit-identical: {same}")
        if not (y_ulps <= 1 and dx_gap <= 2 ** -8 + N1_NOISE and dw_gap <= N1_NOISE
                and db_gap <= N1_NOISE and same):
            fail(f"N1 {label}: against the chain y {y_ulps} ulp, dx {dx_gap}, dw "
                 f"{dw_gap}, db {db_gap}; deterministic {same}")
    return numbers


def phase_kernel_k4_backward(cf):
    """The backward of the `autograd.Function` at the e2e step's stage-1 3x3
    shape (b16, 104^2, 64 -> 64, affine, residual, ReLU): dx (a K4 launch),
    dW, d_scale, d_offset and d_residual against autograd through the plain
    version (without its ReLU, the ReLU state taken from the kernel's output,
    so that a pre-activation within rounding of 0 cannot flip one element's
    whole gradient); then the backward's prologue kernel against its plain
    version on the same cotangent. Returns (the numbers of the backward, the
    prologue's)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, hw, c, cout, k = E2E_BATCH, 104, 64, 64, 3
    spec, x, weight, scale, offset, res = flat_case(
        cf, gen, b, hw, 64, c, cout, k, True, True, False)
    names = ("dx", "dW", "d_scale", "d_offset", "d_residual")
    leaves = [t.clone().requires_grad_() for t in (x, weight, scale, offset, res)]
    fwd, dxs, dys = cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()
    out = cf.conv_flat(leaves[0], spec, *leaves[1:4], True, leaves[4])
    g = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    if (cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()) != (
            fwd + 1, dxs + 1, dys + 1):
        fail("K4 backward: expected one forward, one dx and one prologue launch")
    ref_leaves = [t.clone().requires_grad_() for t in (x, weight, scale, offset, res)]
    pre = plain_conv_flat(cf, spec, False, *ref_leaves).float()
    cot = g.float() * (out > 0)
    want = torch.autograd.grad(pre, ref_leaves, cot, retain_graph=True)
    valid = cf._valid_rows(spec, x.device)
    if not bool((got[0][:, ~valid] == 0).all()):
        fail("K4 backward: dx is not exactly zero on guard and ring rows")
    errs = {}
    for name, a, w in zip(names, got, want):
        a, w = a.float(), w.float()
        if name == "dx":    # the contract: the plain products' ring cotangent is dropped
            a, w = a[:, valid], w[:, valid]
        top = w.abs().max().item()
        errs[name] = (a - w).abs().max().item() / top
        if not errs[name] <= K4_GRAD_REL_TOL:
            fail(f"K4 backward: {name} differs by {errs[name]} of its largest "
                 f"entry {top} (bound {K4_GRAD_REL_TOL})")
    plain_ms = cuda_time_ms(lambda: torch.autograd.grad(
        pre, ref_leaves, cot, retain_graph=True), 3, warmup=1)
    del pre, want, ref_leaves, cot
    ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 10)
    # with x alone wanting a gradient the backward is the prologue and one K4
    # launch (what it computes is fixed when the forward runs)
    x_only = x.clone().requires_grad_()
    out_x = cf.conv_flat(x_only, spec, weight, scale, offset, True, res)
    dx_ms = cuda_time_ms(lambda: torch.autograd.grad(out_x, x_only, g,
                                                     retain_graph=True), 10)
    x_nchw = cf.flat_end(x, spec).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    w_cl = weight.bfloat16().contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = F.conv2d(x_nchw, w_cl, padding=1)
    gy = torch.randn_like(y)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(y, (x_nchw, w_cl), gy,
                                                      retain_graph=True), 10)
    # the bound of the whole backward: the dx and the dW convolutions'
    # operations against reading x, g, the output (the ReLU state) and
    # writing dx and d_residual, on the unpadded pixels
    pixels = b * hw * hw
    flops = 2 * (2 * pixels * k * k * c * cout)
    nbytes = 2 * (2 * pixels * c + 3 * pixels * cout + 2 * k * k * c * cout)
    by_ops, by_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(by_ops, by_bytes)
    bound_by = "operations" if by_ops >= by_bytes else "bytes"
    print(f"kernel K4 backward b{b} {hw}^2 {c}->{cout} k{k} affine + residual + "
          "ReLU: " + ", ".join(f"{n} {errs[n]:.3g}" for n in names)
          + f" of the largest entry (bound {K4_GRAD_REL_TOL}), dx exactly 0 on "
          f"guard and ring rows; all five gradients {ms:.4f} ms, autograd through "
          f"the plain version {plain_ms:.4f} ms, dx alone (prologue, one K4 "
          f"launch) {dx_ms:.4f} ms, F.conv2d backward (dgrad + wgrad, no "
          f"epilogue) {lib_ms:.4f} ms, all five / F.conv2d {ms / lib_ms:.2f}; "
          f"the bound of dx and dW {bound_ms:.4f} ms by {bound_by}")
    backward = {"backward_ms": ms, "plain_backward_ms": plain_ms, "dx_ms": dx_ms,
                "library_backward_ms": lib_ms, "over_library": ms / lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "max_rel_err": max(errs.values())}

    # the prologue kernel on this backward's cotangent and output: dy * scale
    # and dy in bf16 are exact (dy is a bf16 value times 0 or 1), the sum of
    # dy over batch and rows differs by f32 rounding in another order
    scale_f, out_d = scale.float(), out.detach()
    kernel = cf._dy_prologue(spec, True, g, out_d, scale_f, True, True, True)
    plain = cf.dy_prologue_ref(spec, True, g, out_d, scale_f, torch.bfloat16,
                               True, True, True)
    torch.cuda.synchronize()
    for name, a, w in zip(("dy * scale", "dy"), kernel[:2], plain[:2]):
        if not torch.equal(a, w):
            fail(f"K4 prologue: {name} differs from its plain version")
    sum_err = (kernel[2] - plain[2]).abs().max().item()
    sum_tol = 1e-5 * g.float().abs().sum((0, 1)).max().item()
    if not sum_err <= sum_tol:
        fail(f"K4 prologue: the sum of dy differs by {sum_err} > {sum_tol}")
    pro_ms = cuda_time_ms(lambda: cf._dy_prologue(spec, True, g, out_d, scale_f,
                                                  True, True, True), 20)
    pro_plain_ms = cuda_time_ms(lambda: cf.dy_prologue_ref(
        spec, True, g, out_d, scale_f, torch.bfloat16, True, True, True), 5)
    # reads g and out, writes dy * scale and dy, each (B, ROWS, Cout) bf16
    pro_bound = 4 * g.numel() * 2 / HBM_BYTES_PER_S * 1e3
    print(f"kernel K4 dy prologue {tuple(g.shape)}: dy * scale and dy bit-equal "
          f"to the plain version, sum of dy max abs err {sum_err:.4g} (bound "
          f"{sum_tol:.4g}); kernel {pro_ms:.4f} ms, plain {pro_plain_ms:.4f} ms, "
          f"bound {pro_bound:.4f} ms by bytes ({100 * pro_bound / pro_ms:.1f}% "
          f"reached)")
    prologue = {"max_abs_err": sum_err, "ms": pro_ms, "plain_ms": pro_plain_ms,
                "bound_ms": pro_bound, "bound_by": "bytes", "library_ms": None}
    return backward, prologue


def switch_layout(model, layout: str):
    """A context in which the CRIS backbone of `model` runs on `layout`: the
    parameters and buffers are the same for both, only the path differs."""
    from unittest import mock
    return mock.patch.object(model.visual, "layout", layout)


def phase_serve_cris_flat(fa, profile: bool):
    """CRIS RN50 + CoOp with `layout="flat"`: the RN50's stem tail and four
    stages through K4. The b64 dedup request and b1, and the first against
    the same weights on the cuDNN path."""
    import torch

    from tunevlseg_torch.models.presets import build_cris
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model, _ = build_cris("coop", prompt_depth=3, num_context=4, layout="flat",
                          dtype=torch.bfloat16, device="cuda", seed=0)
    params = dict(model.state_dict())
    predict = task_predict_fn(SegmentationTask(model))
    print(f"serve cris flat: CRIS RN50 + CoOp(depth 3, n_ctx 4) at {CRIS_IMG}^2, "
          f'layout="flat", stages {model.visual.flat_stages}, built in '
          f"{time.perf_counter() - t0:.1f} s")
    requests = three_requests(6, CRIS_IMG, 0)
    requests = [requests[0], requests[2]]
    probs, launches = serve_requests(fa, "serve cris flat", predict, params,
                                     requests, CRIS_IMG, CRIS_FLAT_SERVE)
    with switch_layout(model, "nchw"):
        before = counts(fa)
        nchw = predict(params, requests[0][1])
        torch.cuda.synchronize()
        grew = minus(counts(fa), before)
        if grew != CRIS_SERVE:
            fail(f"serve cris flat: the nchw reference launched {grew}")
        walls = []
        for _ in range(5):
            t = time.perf_counter()
            predict(params, requests[0][1])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    diff = (probs - nchw).abs()
    dmax, dmean = diff.max().item(), diff.mean().item()
    print(f'serve cris flat: layout="flat" vs "nchw" on the same weights, b64 '
          f"dedup probabilities: max abs diff {dmax:.6g} (bound "
          f"{FLAT_PROB_MAX_TOL}), mean {dmean:.6g} (bound {FLAT_PROB_MEAN_TOL}); "
          f'the "nchw" forward in the same call: median '
          f"{statistics.median(walls) * 1e3:.3f} ms")
    if not (dmax <= FLAT_PROB_MAX_TOL and dmean <= FLAT_PROB_MEAN_TOL):
        fail("serve cris flat: the two layouts disagree beyond the stated bounds")
    if profile:
        req = requests[0][1]
        profile_calls("serve cris flat b64 dedup", lambda: predict(params, req))
        with switch_layout(model, "nchw"):
            profile_calls("serve cris nchw b64 dedup (same model)",
                          lambda: predict(params, req))
    return launches


def phase_train_cris_flat(fa):
    """CoOp steps of CRIS RN50 on the flat layout: the frozen backbone runs
    K4 forward only (no input of it wants a gradient, so nothing is saved
    and no dx is launched)."""
    import torch

    task, state = build_task("CRIS RN50", "coop", 2e-4,
                             build_kwargs={"layout": "flat"})
    model = task.model
    batch = make_train_batch(BATCH, text_dedup=1, seed=7, img=CRIS_IMG, pad_id=0)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    state, _, launches = timed_steps(fa, task, state, batch, "train cris flat",
                                     warmup=2, steps=3,
                                     per_step=CRIS_FLAT_COOP_STEP)
    now = model.state_dict()
    for name in trainable:
        if torch.equal(now[name], start[name]):
            fail(f"train cris flat: trainable leaf {name} did not change")
    for name, value in now.items():
        if name not in trainable and not torch.equal(value, start[name]):
            fail(f"train cris flat: frozen tensor or buffer {name} changed")
    print(f"train cris flat: {len(trainable)} trainable leaves changed; "
          f"{len(now) - len(trainable)} frozen tensors and BatchNorm buffers "
          "bit-identical; no K4 dx launch")
    return launches


def backbone_gradients_flat_vs_nchw(task, batch):
    """Every gradient of the trainable RN50 for one fixed cotangent on its
    (C3, C4, C5') pyramid, on `layout="flat"` (K4 forward, K4 for dx, dW
    products) against `layout="nchw"` (cuDNN) from the same weights."""
    import torch
    net = task.model.visual
    image = task._prep_image(batch["image"])
    gen = torch.Generator(device="cuda").manual_seed(13)
    cots, grads = None, {}
    for layout in ("flat", "nchw"):
        with switch_layout(task.model, layout):
            net.zero_grad(set_to_none=True)
            feats = net(image)
            if cots is None:
                cots = [torch.randn(f.shape, generator=gen, device="cuda")
                        for f in feats]
            sum((f.float() * c).sum() for f, c in zip(feats, cots)).backward()
            grads[layout] = {n: p.grad.float().clone()
                             for n, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    worst_cos, worst_rel = worst_leaf(grads["flat"], grads["nchw"])
    print(f"train cris e2e flat: the backbone's {len(grads['nchw'])} gradients for "
          f'a fixed cotangent on its pyramid, layout "flat" vs "nchw": least '
          f"cosine {worst_cos[0]:.6f} ({worst_cos[1]}; at least "
          f"{FLAT_GRAD_COS_MIN}), largest max abs diff {worst_rel[0]:.4g} of its "
          f"leaf's largest entry ({worst_rel[1]}; bound {FLAT_GRAD_REL_TOL})")
    if not (worst_cos[0] >= FLAT_GRAD_COS_MIN and worst_rel[0] <= FLAT_GRAD_REL_TOL):
        fail("train cris e2e flat: the backbone's gradients on the two layouts "
             "disagree beyond the stated bounds")


def phase_train_cris_e2e(fa, profile: bool):
    """The e2e CRIS train step at b16 with the BatchNorm statistics in the
    train state: (a) the default, towers frozen, on cuDNN; (b) the full
    fine-tune on the flat layout, whose backward launches K4 for every dx."""
    import torch

    mutable = {"mutable_collections": ("batch_stats",)}
    # seeded random weights under train-mode BatchNorm are touchy: at 1e-5 and
    # above Adam's first steps overshoot (the loss jumps from 1.9 to 2.5-7 and
    # comes back), at 3e-6 it falls from the first step on
    lr = 3e-6
    batch = make_train_batch(E2E_BATCH, text_dedup=0, seed=8, img=CRIS_IMG, pad_id=0)
    print(f"train cris e2e: batch {E2E_BATCH} rather than {BATCH}, as the CLIPSeg "
          "e2e phase, to keep the whole script short")

    # (a) towers frozen, layout nchw
    task, state = build_task("CRIS RN50", "e2e", lr, task_kwargs=mutable)
    first = dict(state.model_state)
    buffers = {k: v.detach().clone() for k, v in task.model.named_buffers()}
    state, losses, launches_a = timed_steps(fa, task, state, batch,
                                            "train cris e2e", warmup=2, steps=5,
                                            per_step=CRIS_E2E_STEP)
    if not losses[-1] < losses[0]:
        fail(f"train cris e2e: the loss did not fall: {losses[0]} -> {losses[-1]}")
    moved = {k for k, v in state.model_state.items() if not torch.equal(v, first[k])}
    head = {k for k in first if k.startswith(("neck.", "proj."))}
    if moved != head:
        fail(f"train cris e2e: running statistics that moved: {len(moved)}, "
             f"expected the {len(head)} of the FPN and the projector; stray: "
             f"{sorted(moved ^ head)[:4]}")
    for name, buf in task.model.named_buffers():
        if not torch.equal(buf, buffers[name]):
            fail(f"train cris e2e: the module's buffer {name} was written")
    print(f"train cris e2e: loss fell {losses[0]:.5f} -> {losses[-1]:.5f} on one "
          f"fixed batch; {len(moved)} running statistics of the FPN and the "
          f"projector moved in the train state, the backbone's "
          f"{len(first) - len(moved)} did not, no module buffer was written")
    if profile:
        profile_step("cris e2e", task, state, batch)
    del task, state

    # (b) full fine-tune, layout flat
    task, state = build_task("CRIS RN50", "e2e", lr,
                             build_kwargs={"freeze_encoder": False,
                                           "layout": "flat"},
                             task_kwargs=mutable)
    model = task.model
    watch = ("visual.conv2.weight", "visual.layer1.0.conv2.weight",
             "visual.layer3.2.conv3.weight", "visual.layer4.0.downsample_conv.weight",
             "visual.bn2.weight", "visual.layer2.1.bn2.bias",
             "visual.layer4.2.bn3.weight")
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    before = counts(fa)
    loss_f, grads_f = first_step(task, start, batch, watch)
    grew = minus(counts(fa), before)
    if grew != CRIS_E2E_FLAT_STEP:
        fail(f"train cris e2e flat: the first step launched {grew}, expected "
             f"{CRIS_E2E_FLAT_STEP}")
    with switch_layout(model, "nchw"):
        before = counts(fa)
        loss_n, grads_n = first_step(task, start, batch, watch)
        if minus(counts(fa), before) != CRIS_E2E_STEP:
            fail("train cris e2e flat: the nchw reference step launched K4")
    print(f'train cris e2e flat: first step, layout "flat" vs "nchw" on the same '
          f"weights: loss {loss_f:.6f} vs {loss_n:.6f} (bound {E2E_FLAT_LOSS_TOL})")
    for name in watch:
        top = grads_n[name].abs().max().item()
        gdiff = (grads_f[name] - grads_n[name]).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(
            grads_f[name].flatten(), grads_n[name].flatten(), dim=0).item()
        print(f"train cris e2e flat:   the step's gradient of {name}: max abs "
              f"diff {gdiff:.6g} against largest entry {top:.6g}, cosine "
              f"{cos:.6f} (through the head; no bound)")
    if not abs(loss_f - loss_n) <= E2E_FLAT_LOSS_TOL:
        fail("train cris e2e flat: the two layouts' first-step losses disagree "
             "beyond the stated bound")
    backbone_gradients_flat_vs_nchw(task, batch)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(start[name])
    state = task.init()
    state, losses, launches_b = timed_steps(fa, task, state, batch,
                                            "train cris e2e flat", warmup=1,
                                            steps=4, per_step=CRIS_E2E_FLAT_STEP)
    now = dict(model.named_parameters())
    for name in watch:
        if torch.equal(now[name], start[name]):
            fail(f"train cris e2e flat: {name} did not change")
    print(f"train cris e2e flat: backbone convolution weights and BatchNorm "
          f"weight / bias changed ({', '.join(watch)}); loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}")
    if profile:
        profile_step("cris e2e flat", task, state, batch)
    return launches_a, launches_b


# --- Slice D: the TransformerSegmentor ----------------------------------------

def ts_config(**kw):
    """`bench.py`'s trans_seg row: TransSegmentorConfig() at 352^2 with the
    decoder's dropout off, as the bench builds it."""
    from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
    return TransSegmentorConfig(**{"image_size": IMG, "decoder_dropout": 0.0, **kw})


def k4_upsampler_case(cf, gen, c: int, cout: int, side: int) -> dict:
    """One upsampler convolution of phase 19, forward, then its backward
    (`k4_upsampler_backward`); returns {label: numbers}."""
    import torch
    import torch.nn.functional as F

    from tunevlseg_torch.models.trans_segmentor.model import (conv3_flat,
                                                              flat_operands)
    from tunevlseg_torch.nn.conv import Conv2d
    from tunevlseg_torch.nn.layers import init_params
    label = f"trans_seg upsampler {c}->{cout} {side}^2"
    conv = Conv2d(c, cout, 3, bias=True)
    init_params(conv, torch.Generator().manual_seed(side))
    conv = conv.cuda()
    x = torch.randn(TS_BATCH, c, side + 2, side + 2, generator=gen,
                    device="cuda").bfloat16()
    with torch.no_grad():
        flat, spec, weight, offset = flat_operands(x, conv)
        cp, coutp = flat.shape[-1], weight.shape[0]
        before = cf.launch_count()
        out = cf.conv_flat(flat, spec, weight, offset=offset)
        whole = conv3_flat(x, conv)
        torch.cuda.synchronize()
        if cf.launch_count() != before + 2:
            fail(f"K4 {label}: the wrapper did not count its launches")
        ref = exact_conv_flat(cf, spec, False, flat, weight, None, offset, None)
        err = (out.float() - ref).abs().max().item()
        top = ref.abs().max().item()
        if not err <= K4_REL_TOL * top:
            fail(f"K4 {label}: max abs error {err} > {K4_REL_TOL} x {top}")
        if not bool((out[..., cout:] == 0).all()):
            fail(f"K4 {label}: the padded output channels are not exactly zero")
        conv_ref = F.conv2d(x.float(), conv.weight.bfloat16().float(), conv.bias)
        whole_err = (whole.float() - conv_ref).abs().max().item()
        if not whole_err <= K4_REL_TOL * conv_ref.abs().max().item():
            fail(f"K4 {label}: conv3_flat is {whole_err} from F.conv2d")
        del ref, conv_ref, out, whole
        ms = cuda_time_ms(lambda: cf.conv_flat(flat, spec, weight, offset=offset), 20)
        whole_ms = cuda_time_ms(lambda: conv3_flat(x, conv), 20)
        plain_ms = cuda_time_ms(lambda: plain_conv_flat(
            cf, spec, False, flat, weight, None, offset, None), 2, warmup=1)
        w_b, b_b = conv.weight.detach().bfloat16(), conv.bias.detach().bfloat16()
        lib_ms = cuda_time_ms(lambda: F.conv2d(x, w_b, b_b), 20)
    bound_ms, bound_by, flops = conv_bound(TS_BATCH, side, 3, c, cout, False)
    print(f"kernel K4 {label} (b{TS_BATCH}, C {c} -> {cp}, Cout {cout} -> "
          f"{coutp}, {spec.rows} rows): max_abs_err {err:.6g} against the plain "
          f"version's f32 value (bound {K4_REL_TOL} x largest |reference| "
          f"{top:.4g}), padded output "
          f"channels exactly 0, conv3_flat vs F.conv2d {whole_err:.4g}; "
          f"kernel {ms:.4f} ms, conv3_flat with its copies {whole_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, F.conv2d bf16 NCHW (the nchw layout's "
          f"convolution) {lib_ms:.4f} ms, K4 / F.conv2d {ms / lib_ms:.2f}, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% "
          f"reached; {flops / ms / 1e9:.1f} TFLOP/s of the unpadded work)")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
           "over_library": ms / lib_ms, "conv3_flat_ms": whole_ms}
    row.update(k4_upsampler_backward(cf, gen, label, x, conv, flat, spec,
                                     weight, offset))
    return {label: row}


def k4_upsampler_backward(cf, gen, label: str, x, conv, flat, spec, weight,
                          offset) -> dict:
    """The backward of that K4 launch at b32 on the same flat tensors, as
    the train step runs it behind the trainable decoder: the prologue, dx
    (one K4 launch from Cout to C, 8 -> 104 for the output convolution over
    the 354^2 plane), dW and d_offset, against autograd through the plain
    version in f32 on the same bf16 values (dx on the valid rows, as the
    gradient contract of `conv_flat` has it, and exactly 0 on the guard and
    ring rows), each within K4_GRAD_REL_TOL of its largest entry; the time
    of all three beside `F.conv2d`'s backward (dgrad + wgrad) on the nchw
    layout's input. Returns the numbers."""
    import torch
    import torch.nn.functional as F
    leaves = [t.detach().clone().requires_grad_() for t in (flat, weight, offset)]
    before = cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()
    out = cf.conv_flat(leaves[0], spec, leaves[1], offset=leaves[2])
    g = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    if (cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()) != (
            before[0] + 1, before[1] + 1, before[2] + 1):
        fail(f"K4 backward {label}: expected one forward, one dx and one "
             "prologue launch")
    ref_leaves = [flat.detach().float().requires_grad_(),
                  weight.detach().bfloat16().float().requires_grad_(),
                  offset.detach().clone().requires_grad_()]
    pre = plain_conv_flat(cf, spec, False, ref_leaves[0], ref_leaves[1], None,
                          ref_leaves[2], None)
    want = torch.autograd.grad(pre, ref_leaves, g.float())
    del pre, ref_leaves
    valid = cf._valid_rows(spec, flat.device)
    if not bool((got[0][:, ~valid] == 0).all()):
        fail(f"K4 backward {label}: dx is not exactly zero on guard and ring rows")
    errs = {}
    for name, a, w in zip(("dx", "dW", "d_offset"), got, want):
        a, w = a.float(), w.float()
        if name == "dx":
            a, w = a[:, valid], w[:, valid]
        top = w.abs().max().item()
        errs[name] = (a - w).abs().max().item() / top
        if not errs[name] <= K4_GRAD_REL_TOL:
            fail(f"K4 backward {label}: {name} differs by {errs[name]} of its "
                 f"largest entry {top} (bound {K4_GRAD_REL_TOL})")
    del got, want
    ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 5)
    xl = x.detach().requires_grad_()
    wl = conv.weight.detach().bfloat16().requires_grad_()
    y = F.conv2d(xl, wl, conv.bias.detach().bfloat16())
    gy = torch.randn(y.shape, generator=gen, device="cuda").bfloat16()
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(y, (xl, wl), gy,
                                                      retain_graph=True), 5)
    # the unpadded work, as the forward's bound counts it
    side = x.shape[-1] - 2
    bound_ms, bound_by = conv_backward_bound(
        x.shape[0], side, 3, conv.weight.shape[1], conv.weight.shape[0],
        weight.element_size())
    print(f"kernel K4 backward {label}: " + ", ".join(
        f"{n} {e:.3g}" for n, e in errs.items())
          + f" of the largest entry (bound {K4_GRAD_REL_TOL}), dx exactly 0 on "
          f"guard and ring rows; prologue + dx + dW {ms:.4f} ms, F.conv2d "
          f"backward {lib_ms:.4f} ms ({ms / lib_ms:.2f}), bound {bound_ms:.4f} ms "
          f"by {bound_by} ({100 * bound_ms / ms:.1f}% reached)")
    return {"backward_rel_err": max(errs.values()), "backward_ms": ms,
            "library_backward_ms": lib_ms, "backward_bound_ms": bound_ms,
            "backward_bound_by": bound_by}


def phase_kernels_k4_upsampler(cf):
    """K4 at the TransformerSegmentor's five upsampler convolutions at b32
    (`conv3_flat`: the replicate-padded (s+2)^2 plane into flat space with C
    zero-padded to a multiple of 8, one K4 launch with Cout padded likewise
    and the bias as its offset, the interior sliced back): the launch against
    its plain version on the same flat tensors, the whole `conv3_flat`
    against the nchw layout's `F.conv2d` (cuDNN, VALID on the same padded
    input), the bound from the unpadded work, and the launch's backward
    against autograd through the plain version; returns {label: numbers}."""
    import torch

    from tunevlseg_torch.models.trans_segmentor.model import upsampler_stages
    gen = torch.Generator(device="cuda").manual_seed(12)
    results = {}
    for c, cout, side in upsampler_stages(ts_config()):
        results.update(k4_upsampler_case(cf, gen, c, cout, side))
    total = {k: sum(r[k] for r in results.values())
             for k in ("ms", "conv3_flat_ms", "library_ms", "bound_ms",
                       "backward_ms", "library_backward_ms")}
    print(f"kernel K4 trans_seg upsampler, the 5 convolutions at b{TS_BATCH}: "
          f"K4 {total['ms']:.4f} ms, conv3_flat {total['conv3_flat_ms']:.4f} ms, "
          f"F.conv2d {total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} "
          f"ms; backward (prologue + dx + dW) {total['backward_ms']:.4f} ms, "
          f"F.conv2d backward {total['library_backward_ms']:.4f} ms")
    return results


def siglip_ids(gen, rows: int):
    """SigLIP-style token ids (vocabulary 32000, 64 positions): 9 words,
    `</s>` (id 1), then padding (id 1); the attention mask keeps 10."""
    import torch
    ids = torch.randint(3, 1000, (rows, PC_SEQ), generator=gen, dtype=torch.int32)
    ids[:, 9:] = 1
    mask = torch.zeros_like(ids)
    mask[:, :10] = 1
    return ids, mask


def phase_trans_seg(fa, profile: bool) -> dict:
    """The TransformerSegmentor of `bench.py`'s trans_seg row, whole model
    trainable: three requests (b32 dense, b32 with one prompt, b1), kernel
    path against plain path; 2 warm-up + 5 timed b32 full fine-tune steps
    (the loss falls, every parameter with a gradient moves, the first step
    against the plain path); then the same weights on the flat upsampler
    (`build_trans_segmentor(upsampler_layout="flat")`): one b32 request and
    1 + 2 steps, the probabilities, and the first step's loss and the
    gradients of the last decoder layer and of the upsampler, against
    "nchw". Returns {path: counts}."""
    import torch

    from tunevlseg_torch.models.presets import build_trans_segmentor
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.optim import count_params
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model, spec = build_trans_segmentor(ts_config(), dtype=torch.bfloat16,
                                        device="cuda", seed=0)
    task = SegmentationTask(model, spec, learning_rate=2e-4)
    flat_model, _ = build_trans_segmentor(ts_config(), upsampler_layout="flat",
                                          dtype=torch.bfloat16, device="cuda")
    flat_model.load_state_dict(model.state_dict())
    flat_task = SegmentationTask(flat_model, spec, learning_rate=2e-4)
    print(f"trans_seg: TransformerSegmentor (CLIP ViT-B/16 + text, decoder "
          f"4 x 8 heads, FFN 2048, ReLU, upsampler 5 stages with the sample "
          f"LayerNorm) at {IMG}^2, bf16 compute over f32 weights, "
          f"{count_params(model.parameters())} params; the nchw and the flat "
          f"upsampler's model built in {time.perf_counter() - t0:.1f} s")
    by_path = {}
    params = dict(model.state_dict())
    predict = task_predict_fn(task)
    gen = torch.Generator().manual_seed(50)
    requests = [("b32 dense", make_request(gen, TS_BATCH, TS_BATCH, IMG), TS_BATCH),
                ("b32 dedup U=1", make_request(gen, TS_BATCH, 1, IMG), TS_BATCH),
                ("b1", make_request(gen, 1, 1, IMG), 1)]
    probs, by_path["serve_trans_seg"] = serve_requests(
        fa, "serve trans_seg", predict, params, requests, IMG, TS_SERVE)
    compare_with_plain_path(fa, "serve trans_seg", predict, params,
                            requests[0][1], probs, "b32 dense")
    flat_probs, by_path["serve_trans_seg_flat"] = serve_requests(
        fa, "serve trans_seg flat", task_predict_fn(flat_task), params,
        requests[:1], IMG, TS_FLAT_SERVE, reps=3)
    diff = (flat_probs - probs).abs()
    dmax, dmean = diff.max().item(), diff.mean().item()
    print(f'serve trans_seg flat: upsampler "flat" vs "nchw" on the same weights, '
          f"b32 dense probabilities: max abs diff {dmax:.6g} (bound "
          f"{TS_FLAT_PROB_TOL[0]}), mean {dmean:.6g} (bound {TS_FLAT_PROB_TOL[1]})")
    if not (dmax <= TS_FLAT_PROB_TOL[0] and dmean <= TS_FLAT_PROB_TOL[1]):
        fail("serve trans_seg flat: the two upsampler layouts disagree beyond "
             "the stated bounds")
    if profile:
        for label, req, _ in (requests[0], requests[2]):
            profile_calls(f"serve trans_seg {label}", lambda: predict(params, req))
    del probs, flat_probs, params

    state = task.init()
    batch = make_train_batch(TS_BATCH, text_dedup=0, seed=51, img=IMG)
    if batch["input_ids"].shape[0] != TS_BATCH:
        fail("train trans_seg: expected dense prompts")
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    print(f"train trans_seg: full fine-tune, {len(trainable)} of "
          f"{len(start)} leaves trainable "
          f"({count_params(p for p in model.parameters() if p.requires_grad)} "
          "values), AdamW lr 2e-4")
    if len(trainable) != len(start):
        fail("train trans_seg: the full fine-tune froze parameters")
    state, losses, by_path["train_trans_seg"] = timed_steps(
        fa, task, state, batch, "train trans_seg", warmup=2, steps=5,
        per_step=TS_STEP)
    if not losses[-1] < losses[0]:
        fail(f"train trans_seg: the loss did not fall: {losses[0]} -> {losses[-1]}")
    # the vision tower's post_layernorm feeds only the pooled output, which
    # the model does not read: it exists (as in the JAX package), gets no
    # gradient and keeps its value
    named = dict(model.named_parameters())
    unread = sorted(n for n in trainable if named[n].grad is None)
    if unread != ["vision_model.post_layernorm.bias",
                  "vision_model.post_layernorm.weight"]:
        fail(f"train trans_seg: leaves without a gradient: {unread}")
    for name in trainable:
        if (name in unread) == (not torch.equal(named[name], start[name])):
            fail(f"train trans_seg: {name} moved without a gradient or did not "
                 "move with one")
    print(f"train trans_seg: loss fell {losses[0]:.5f} -> {losses[-1]:.5f} on one "
          f"fixed batch; {len(trainable) - len(unread)} leaves with a gradient "
          f"moved, the {len(unread)} without one ({', '.join(unread)}) did not")
    first_step_kernel_vs_plain(
        fa, "train trans_seg", task, start, batch,
        ("vision_model.layers.0.self_attn.q_proj.weight",
         "text_model.layers.0.self_attn.q_proj.weight",
         "decoder_layers.0.multihead_attn.q_proj.weight",
         "decoder_layers.3.self_attn.out_proj.weight",
         "upsampler.out_conv.weight"))
    if profile:
        profile_step("trans_seg", task, task.init(), batch)

    # flat against nchw, the first step from the same weights: the loss, and
    # the gradients of the upsampler and of the last decoder layer, which
    # every K4 dx launch of the step lies in front of
    leaves = tuple(n for n in trainable
                   if n.startswith(("decoder_layers.3.", "upsampler.")))
    before = counts(fa)
    loss_flat, grads_flat = first_step(flat_task, start, batch, leaves)
    grew = minus(counts(fa), before)
    if grew != TS_FLAT_STEP:
        fail(f"train trans_seg flat: the first step launched {grew}, "
             f"expected {TS_FLAT_STEP}")
    loss_nchw, grads_nchw = first_step(task, start, batch, leaves)
    worst_cos, worst_rel = worst_leaf(grads_flat, grads_nchw)
    print(f'train trans_seg flat: first step, upsampler "flat" vs "nchw" on the '
          f"same weights: loss {loss_flat:.6f} vs {loss_nchw:.6f} (bound "
          f"{LOSS_TOL}); over the {len(leaves)} gradients of decoder_layers.3 "
          f"and the upsampler, least cosine {worst_cos[0]:.6f} ({worst_cos[1]}; "
          f"at least {GRAD_COS_MIN}), largest max abs diff {worst_rel[0]:.4g} "
          f"of its leaf's largest entry ({worst_rel[1]}; bound {GRAD_REL_TOL})")
    if not (abs(loss_flat - loss_nchw) <= LOSS_TOL
            and worst_cos[0] >= GRAD_COS_MIN and worst_rel[0] <= GRAD_REL_TOL):
        fail("train trans_seg flat: the two layouts' first steps disagree "
             "beyond the stated bounds")
    del grads_flat, grads_nchw
    _, _, by_path["train_trans_seg_flat"] = timed_steps(
        fa, flat_task, flat_task.init(), batch, "train trans_seg flat",
        warmup=1, steps=2, per_step=TS_FLAT_STEP)
    if profile:
        profile_step("trans_seg flat", flat_task, flat_task.init(), batch)
    if torch.equal(flat_model.upsampler.block0_conv.weight,
                   start["upsampler.block0_conv.weight"]):
        fail("train trans_seg flat: the upsampler's first convolution did not move")
    return by_path


def phase_phrasecut(fa, profile: bool) -> dict:
    """`experiment=phrasecut`: SigLIP towers with the existing projections
    (frozen), decoder 4 x 16 heads of 32 with dropout 0.1, the output bias,
    DiceCE with lambda_ce 0.2 and BCE weight 5.8, 384^2: one b16 request
    (one prompt) against the plain path, 1 + 2 dense b16 steps; the towers'
    and projections' tensors stay bit-identical. Returns {path: counts}."""
    import torch

    from tunevlseg_torch.models.presets import build_trans_segmentor
    from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
    from tunevlseg_torch.ops.losses import LOSS_REGISTRY
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.optim import count_params
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    config = TransSegmentorConfig.siglip_base(
        use_existing_proj=True, decoder_num_heads=16, decoder_dropout=0.1,
        output_bias=-1.748104048321891, image_size=PC_IMG)
    model, spec = build_trans_segmentor(config, freeze_encoders=True,
                                        dtype=torch.bfloat16, device="cuda",
                                        seed=0)
    task = SegmentationTask(
        model, spec, loss_fn=LOSS_REGISTRY["dice_ce"],
        loss_kwargs=dict(lambda_dice=1, lambda_ce=0.2, weight=5.8),
        learning_rate=2e-5)
    print(f"phrasecut: TransformerSegmentor with SigLIP towers (768 x 12, "
          f"{PC_SEQ} text positions) and the existing projections at "
          f"{PC_IMG}^2, decoder 4 x 16 heads of 32, output bias, bf16 compute, "
          f"{count_params(model.parameters())} params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    by_path = {}
    gen = torch.Generator().manual_seed(60)
    ids, mask = siglip_ids(gen, 1)
    request = {"image": torch.randint(0, 256, (PC_BATCH, 3, PC_IMG, PC_IMG),
                                      generator=gen, dtype=torch.uint8),
               "input_ids": ids, "attention_mask": mask,
               "text_index": torch.zeros(PC_BATCH, dtype=torch.int32)}
    request = {k: v.cuda() for k, v in request.items()}
    params = dict(model.state_dict())
    predict = task_predict_fn(task)
    probs, by_path["serve_phrasecut"] = serve_requests(
        fa, "serve phrasecut", predict, params,
        [("b16 dedup U=1", request, PC_BATCH)], PC_IMG, PC_SERVE, reps=3)
    compare_with_plain_path(fa, "serve phrasecut", predict, params, request, probs,
                            "b16 dedup")
    del probs, params

    state = task.init()
    ids, mask = siglip_ids(gen, PC_BATCH)
    batch = {"image": torch.randint(0, 256, (PC_BATCH, 3, PC_IMG, PC_IMG),
                                    generator=gen, dtype=torch.uint8),
             "mask": (torch.rand(PC_BATCH, 1, PC_IMG, PC_IMG, generator=gen)
                      > 0.85).float(),
             "input_ids": ids, "attention_mask": mask,
             "valid": torch.ones(PC_BATCH)}
    batch = {k: v.cuda() for k, v in batch.items()}
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    frozen = [n for n in start if n not in trainable]
    if not frozen or any(not n.startswith(("text_model.", "vision_model.",
                                           "text_projection.",
                                           "visual_projection."))
                         for n in frozen):
        fail(f"train phrasecut: frozen leaves {frozen[:4]}...")
    state, losses, by_path["train_phrasecut"] = timed_steps(
        fa, task, state, batch, "train phrasecut", warmup=1, steps=2,
        per_step=PC_STEP)
    named = dict(model.named_parameters())
    for name in frozen:
        if not torch.equal(named[name], start[name]) or named[name].grad is not None:
            fail(f"train phrasecut: frozen tensor {name} changed or got a gradient")
    for name in trainable:
        if torch.equal(named[name], start[name]):
            fail(f"train phrasecut: trainable leaf {name} did not change")
    print(f"train phrasecut: {len(trainable)} decoder and upsampler leaves moved, "
          f"{len(frozen)} tower and projection tensors bit-identical and without "
          f"a gradient; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if profile:
        profile_step("phrasecut", task, task.init(), batch)
    return by_path


# --- Slice E: DenseCLIP -------------------------------------------------------

# DenseCLIP RN50 (ADE-150 recipe): K1 in the attention pool (257 tokens); K3
# in the 12 text layers (13 tokens, causal bias) and the 3 cross-attentions
# from the 150 class queries into the 257 visual tokens; the context decoder's
# self-attention over the 150 classes stays under the gate's 256 (plain). A
# train step adds K2 for the pool (the backbone trains at lr x 0.1); the text
# encoder is frozen, but the contexts take their gradient through it by K3's
# plain recompute. backbone_layout="flat" adds K4 for the RN50's 54
# convolutions wherever the BatchNorms use running statistics.
DC_SERVE = (1, 0, 15, 0, 0, 0) + NO_VARIANTS
DC_STEP = (1, 1, 15, 0, 0, 0) + NO_VARIANTS
DC_FLAT_SERVE = (1, 0, 15, RN50_FLAT_CONVS, 0, 0) + NO_VARIANTS
# ViT-B/16 at 640^2: K1 in the 12 ViT layers (1601 tokens), K3 as above
DC_VIT_SERVE = (12, 0, 15, 0, 0, 0) + NO_VARIANTS
# mmseg's slide test of the RN50 recipe: crop 512, stride 341, over one
# 512 x 2048 image: ceil((2048 - 512) / 341) + 1 = 6 windows
DC_SLIDE_WIDTH, DC_STRIDE = 2048, 341
# kernel path against plain path, first DenseCLIP step: the relative loss gap
# and each held leaf's gradient cosine (beside GRAD_REL_TOL of its largest
# entry). The context decoder's cross-attention q_proj is printed, not held:
# over the near-identical visual tokens of a random backbone its gradient is
# rounding (the two kernel-free paths agree only to a cosine of about 0.8 on
# the H100); its v_proj and the decoder's output projection are held.
DC_LOSS_REL_TOL = 1e-3
DC_GRAD_COS_MIN = 0.999
# flat against nchw backbone, 150-class softmax: the probability bounds that
# CRIS's sigmoid masks hold (FLAT_PROB_*_TOL) carried to the logit scale
# through the sigmoid's largest slope, 1/4, where they are tightest, and held
# on the log-probabilities (the logits up to each pixel's shift), which do
# not shrink with the class count as the probabilities (about 1/150) do
DC_FLAT_LOGPROB_TOL = (FLAT_PROB_MAX_TOL / 0.25, FLAT_PROB_MEAN_TOL / 0.25)
IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def denseclip_class_ids(gen, vocab: int = 49408):
    """Synthetic class tokens: 150 rows of 5 ids, the EOS (the largest id)
    in the last slot."""
    import torch
    ids = torch.randint(1, vocab - 1, (DC_CLASSES, 5), generator=gen)
    ids[:, -1] = vocab - 1
    return ids


def denseclip_predict(task, slide: bool = False):
    """`predict(params, request)`: class probabilities (B, K, H, W) in f32 of
    the model with the tensors `params`, by whole-image inference or by
    mmseg's slide inference (crop 512, stride 341)."""
    import torch
    from torch.func import functional_call

    from tunevlseg_torch.models.denseclip.inference import (slide_inference,
                                                            whole_inference)

    def predict(params, request):
        with torch.no_grad():
            def apply_fn(x):
                return functional_call(task.model, params, (x,))
            images = task._prep_image(request["image"])
            logits = (slide_inference(apply_fn, images, (DC_IMG, DC_IMG),
                                      (DC_STRIDE, DC_STRIDE)) if slide
                      else whole_inference(apply_fn, images))
            return torch.softmax(logits.float(), dim=1)
    return predict


def denseclip_train_batch(gen):
    """uint8 images and ADE-style labels: 32 x 32 blocks of the 150 classes,
    the top 16 rows ignored (255)."""
    import torch
    yy, xx = torch.meshgrid(torch.arange(DC_IMG), torch.arange(DC_IMG),
                            indexing="ij")
    labels = ((yy // 32) * 16 + xx // 32) % DC_CLASSES
    labels = (labels[None] + torch.randint(0, DC_CLASSES, (DC_BATCH, 1, 1),
                                           generator=gen)) % DC_CLASSES
    labels[:, :16] = 255
    return {"image": torch.randint(0, 256, (DC_BATCH, 3, DC_IMG, DC_IMG),
                                   generator=gen, dtype=torch.uint8).cuda(),
            "label": labels.cuda()}


def phase_denseclip(fa, profile: bool) -> dict:
    """DenseCLIP's ADE-150 recipe at full width and depth, seeded random
    weights, synthetic class ids, bf16. RN50 at 512^2: a b16 whole-image
    request and a slide request over one 512 x 2048 image (6 windows), the
    class probabilities against the plain path, every K1 / K3 launch of a
    forward against its plain version on the path's own tensors; the same
    weights on `backbone_layout="flat"` (+54 K4), every K4 launch against its
    plain version on the path's own tensors, against "nchw"; 1 + 3 b16
    train steps (poly + short warm-up, AdamW, backbone lr x 0.1, bn_train):
    the launches, contexts / gamma / a backbone convolution / the decode head
    and the BatchNorm statistics in the state move, the text encoder stays
    bit-identical, the first step's loss and gradients against the plain
    path. Then ViT-B/16 at 640^2, one b2 request against the plain path.
    Returns {path: counts}."""
    import torch

    from tunevlseg_torch.models.denseclip.inference import window_starts
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig
    from tunevlseg_torch.models.presets import build_denseclip
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
    from tunevlseg_torch.training.optim import count_params

    by_path = {}
    gen = torch.Generator().manual_seed(70)
    ids = denseclip_class_ids(gen)
    t0 = time.perf_counter()
    model = build_denseclip(DenseCLIPConfig(), ids, bn_train=True,
                            dtype=torch.bfloat16, device="cuda", seed=0)
    flat = build_denseclip(DenseCLIPConfig(), ids, bn_train=True,
                           backbone_layout="flat", dtype=torch.bfloat16,
                           device="cuda", seed=0)
    flat.load_state_dict(model.state_dict())
    task = DenseCLIPTask(model, learning_rate=1e-4, weight_decay=1e-4,
                         warmup_iters=2, image_stats=IMAGENET_STATS)
    print(f"denseclip: DenseCLIP RN50 (ADE-150 recipe: 512^2, text 12 x 8 heads "
          f"over 150 classes x {DC_TEXT} tokens, context decoder 3 x 4 heads, FPN "
          f"head, dropout 0.1), bf16 compute over f32 weights, "
          f"{count_params(model.parameters())} params; the nchw and the flat "
          f"backbone's model built in {time.perf_counter() - t0:.1f} s")
    params = dict(model.state_dict())
    predict = denseclip_predict(task)
    request = {"image": torch.randint(0, 256, (DC_BATCH, 3, DC_IMG, DC_IMG),
                                      generator=gen, dtype=torch.uint8).cuda()}
    probs, whole = serve_requests(
        fa, "serve denseclip", predict, params,
        [("b16 whole image", request, DC_BATCH)], DC_IMG, DC_SERVE, reps=3,
        classes=DC_CLASSES)
    compare_with_plain_path(fa, "serve denseclip", predict, params, request, probs,
                            "b16 whole-image class")
    kernels_on_path_inputs(fa, "serve denseclip", lambda: predict(params, request))
    windows = (len(window_starts(DC_IMG, DC_IMG, DC_STRIDE))
               * len(window_starts(DC_SLIDE_WIDTH, DC_IMG, DC_STRIDE)))
    if windows != 6:
        fail(f"serve denseclip slide: {windows} windows, mmseg's grid gives 6")
    slide_request = {"image": torch.randint(0, 256, (1, 3, DC_IMG, DC_SLIDE_WIDTH),
                                            generator=gen, dtype=torch.uint8).cuda()}
    _, slide = serve_requests(
        fa, "serve denseclip slide", denseclip_predict(task, slide=True), params,
        [(f"b1 slide 512 x {DC_SLIDE_WIDTH}, {windows} windows", slide_request, 1)],
        (DC_IMG, DC_SLIDE_WIDTH), tuple(windows * n for n in DC_SERVE), reps=3,
        classes=DC_CLASSES)
    by_path["serve_denseclip"] = tuple(a + b for a, b in zip(whole, slide))
    if profile:
        profile_calls("serve denseclip b16", lambda: predict(params, request))

    flat_predict = denseclip_predict(DenseCLIPTask(flat, image_stats=IMAGENET_STATS))
    flat_probs, by_path["serve_denseclip_flat"] = serve_requests(
        fa, "serve denseclip flat", flat_predict, params,
        [("b16 whole image", request, DC_BATCH)], DC_IMG, DC_FLAT_SERVE, reps=2,
        classes=DC_CLASSES)
    k4_on_path_inputs(cf, "serve denseclip flat",
                      lambda: flat_predict(params, request))
    diff = (flat_probs.log() - probs.log()).abs()
    dmax, dmean = diff.max().item(), diff.mean().item()
    print(f'serve denseclip flat: backbone "flat" vs "nchw" on the same weights, '
          f"b16 class log-probabilities: max abs diff {dmax:.6g} (bound "
          f"{DC_FLAT_LOGPROB_TOL[0]}), mean {dmean:.6g} (bound "
          f"{DC_FLAT_LOGPROB_TOL[1]}); probabilities: max abs diff "
          f"{(flat_probs - probs).abs().max().item():.6g}")
    if not (dmax <= DC_FLAT_LOGPROB_TOL[0] and dmean <= DC_FLAT_LOGPROB_TOL[1]):
        fail("serve denseclip flat: the two backbone layouts disagree beyond the "
             "stated bounds")
    del probs, flat_probs, diff, flat, flat_predict, params

    state = task.init()
    batch = denseclip_train_batch(gen)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    named = dict(model.named_parameters())
    text = [n for n in named if n.startswith("text_encoder.")]
    trainable = [n for n, p in named.items() if p.requires_grad]
    print(f"train denseclip: {len(trainable)} of {len(named)} leaves trainable "
          f"({count_params(named[n] for n in trainable)} values; the text "
          f"encoder's {len(text)} frozen), AdamW lr 1e-4 (backbone x 0.1), wd "
          f"1e-4, poly + {task.warmup_iters}-step warm-up, batch statistics")
    state, losses, by_path["train_denseclip"] = timed_steps(
        fa, task, state, batch, "train denseclip", warmup=1, steps=3,
        per_step=DC_STEP)
    for name in ("contexts", "gamma", "backbone.layer1.0.conv1.weight",
                 "backbone.attnpool.q_proj.weight", "decode_head.cls_seg.weight"):
        if torch.equal(named[name], start[name]):
            fail(f"train denseclip: {name} did not move")
    for name in text:
        if not torch.equal(named[name], start[name]) or named[name].grad is not None:
            fail(f"train denseclip: text encoder tensor {name} changed or got a "
                 "gradient")
    stats = [k for k in state.model_state if k.endswith("running_mean")]
    moved = [k for k in stats if not torch.equal(state.model_state[k], start[k])]
    if not stats or len(moved) != len(stats) or any(
            not torch.equal(b, start[n]) for n, b in model.named_buffers()
            if n in start):
        fail(f"train denseclip: {len(moved)} of {len(stats)} running means moved in "
             "the state, or a module buffer changed")
    print(f"train denseclip: contexts, gamma, backbone and head weights moved; the "
          f"{len(stats)} backbone BatchNorms' running statistics moved in the state "
          f"(the module's own buffers did not); the {len(text)} text-encoder "
          f"tensors bit-identical and without a gradient; loss per step "
          + " ".join(f"{x:.5f}" for x in losses))
    first_step_kernel_vs_plain(
        fa, "train denseclip", task, start, batch,
        ("contexts", "gamma", "backbone.attnpool.q_proj.weight",
         "backbone.layer4.2.conv3.weight",
         "context_decoder.decoder.2.cross_attn.v_proj.weight",
         "context_decoder.out_proj_1.weight", "decode_head.cls_seg.weight"),
        cos_min=DC_GRAD_COS_MIN, loss_rel_tol=DC_LOSS_REL_TOL,
        printed=("context_decoder.decoder.2.cross_attn.q_proj.weight",))
    if profile:
        profile_step("denseclip", task, task.init(), batch)
    del task, model, state, batch, start

    t0 = time.perf_counter()
    vit = build_denseclip(DenseCLIPConfig.vitb16(), ids, dtype=torch.bfloat16,
                          device="cuda", seed=0)
    print(f"denseclip vit: DenseCLIP ViT-B/16 at {DC_VIT_IMG}^2 (drop_path 0.1 in "
          f"training only), bf16, {count_params(vit.parameters())} params, built "
          f"in {time.perf_counter() - t0:.1f} s")
    vit_task = DenseCLIPTask(vit, image_stats=IMAGENET_STATS)
    vit_params = dict(vit.state_dict())
    vit_predict = denseclip_predict(vit_task)
    vit_request = {"image": torch.randint(
        0, 256, (DC_VIT_BATCH, 3, DC_VIT_IMG, DC_VIT_IMG), generator=gen,
        dtype=torch.uint8).cuda()}
    vit_probs, by_path["serve_denseclip_vit"] = serve_requests(
        fa, "serve denseclip vit", vit_predict, vit_params,
        [("b2 whole image", vit_request, DC_VIT_BATCH)], DC_VIT_IMG, DC_VIT_SERVE,
        reps=3, classes=DC_CLASSES)
    compare_with_plain_path(fa, "serve denseclip vit", vit_predict, vit_params,
                            vit_request, vit_probs, "b2 whole-image class")
    kernels_on_path_inputs(fa, "serve denseclip vit",
                           lambda: vit_predict(vit_params, vit_request))
    return by_path


# --- zero-shot RIS (FreeSOLO proposals + masked / cropped CLIP features) ------

# launches a request: K3 in the 12 layers of the text tower over the two text
# rows (CLIP's causal + padding bias, BiomedCLIP's BERT padding bias); the
# ViTs' 197 tokens stay under K1's gate (256) and take the plain path, the
# masked CLIP and the crop CLIP alike; FreeSOLO's R101 on layout="flat" adds
# K4 for the 3 convolutions of every stride-1 bottleneck
R101_FLAT_CONVS = 3 * sum(n - 1 for n in (3, 4, 23, 3))
ZS_SERVE = (0, 0, 12, 0, 0, 0) + NO_VARIANTS
ZS_FLAT_SERVE = (0, 0, 12, R101_FLAT_CONVS, 0, 0) + NO_VARIANTS
# eval_zeroshot.yaml's image size, CLIP's pixel statistics (the CLI
# normalises the one image that feeds FreeSOLO and CLIP with them)
ZS_IMG = 1024
CLIP_STATS = ((0.48145466, 0.4578275, 0.40821073),
              (0.26862954, 0.26130258, 0.27577711))
# text features, kernel path against plain path: the plain path rounds the
# scores to bf16 before the softmax, K3 does not; 12 layers, then a pooled
# row and a projection (the same bounds as the other paths' probabilities)
ZS_FEATURE_COS_MIN = 0.999
ZS_FEATURE_REL_TOL = 2e-2
# the device crop-resize against the host crops: the same f32 taps and
# products, summed in another order (host: one canvas at a time through two
# resize GEMMs; device: gathers over every proposal)
ZS_CROP_REL_TOL = 1e-4
# flat against nchw backbone on the same weights, FreeSOLO's raw outputs
# (category logits, mask features), max and mean abs diff over the largest
# |nchw| value: 101 layers whose bf16 outputs round once per convolution on
# "flat" (the FrozenBN folded into K4's f32 epilogue) and twice on "nchw"
# (cuDNN's output, then the affine), then the heads' GroupNorms: a few
# roundings of 2^-9 relative per layer that do not cancel in a random
# network; the mean of the differences stays a tenth of their maximum
ZS_FLAT_RAW_TOL = (0.1, 1e-2)
# the picked proposal is held equal across two paths only where the top-2
# similarity margin exceeds this many times their measured difference
ZS_MARGIN_FACTOR = 10


def zs_k4_cases(cf) -> dict:
    """K4 at the R101's 12 stride-1 convolution shapes of a 1024^2 request
    (b1), then the 87 launches of a forward summed from them, beside
    `F.conv2d`'s; returns {label: numbers}."""
    numbers = phase_kernels_k4(cf, ZS_K4_CASES, batch=1, device_time=True)
    total = {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0,
             "lib_device_ms": 0.0, "bound_ms": 0.0}
    for (name, hw, planes, blocks), i in zip(ZS_K4_BLOCKS, range(0, 12, 3)):
        for case in ZS_K4_CASES[i:i + 3]:
            for key in total:
                total[key] += (blocks - 1) * numbers[case[0]][key]
    print(f"zsseg: K4 over the R101's {R101_FLAT_CONVS} stride-1 convolutions of a "
          f"request, summed from the shapes: {total['ms']:.3f} ms by events, "
          f"{total['device_ms']:.3f} ms device time; F.conv2d {total['library_ms']:.3f} "
          f"ms by events, {total['lib_device_ms']:.3f} device; bound "
          f"{total['bound_ms']:.4f} ms")
    return numbers


def zs_image(gen):
    """A 1024^2 RGB request as the CLI hands it over: uint8 pixels scaled to
    [0, 1] and normalised with CLIP's statistics, (3, H, W) f32 numpy."""
    import torch
    mean, std = (torch.tensor(v).reshape(3, 1, 1) for v in CLIP_STATS)
    pixels = torch.randint(0, 256, (3, ZS_IMG, ZS_IMG), generator=gen).float()
    return ((pixels / 255 - mean) / std).numpy()


def zs_text(gen, bos: int, eos: int, vocab: int):
    """[phrase, class name] rows of 77 ids: BOS, 8 (resp. 3) words, EOS,
    padding 0; and their attention masks."""
    import torch
    ids = torch.zeros(2, SEQ, dtype=torch.int32)
    for row, words in enumerate((8, 3)):
        ids[row, 0], ids[row, words + 1] = bos, eos
        ids[row, 1:words + 1] = torch.randint(5, vocab - 3, (words,), generator=gen)
    return ids.numpy(), (ids != 0).int().numpy()


def zs_request_extras(ris, image, ids, mask):
    """One fused request's picked mask and intermediates (proposals,
    features, similarities), on the card."""
    import torch
    with torch.no_grad():
        return ris._fused_forward(torch.from_numpy(image).cuda(),
                                  torch.from_numpy(ids).cuda(),
                                  torch.from_numpy(mask).cuda(), image.shape[-2:])


def zs_fused_requests(fa, tag: str, ris, request, per_request: tuple,
                      reps: int) -> tuple:
    """A warm-up, then `reps` timed `predict_fused` requests (host clock to
    the mask on the host) with the launch counts set to 0 just before and
    read just after, each request's launches checked. Returns (the mask, the
    counts, the median seconds)."""
    import torch
    ris.predict_fused(*request)
    torch.cuda.synchronize()
    reset_counts(fa)
    times = []
    for _ in range(reps):
        before = counts(fa)
        t = time.perf_counter()
        out = ris.predict_fused(*request)
        times.append(time.perf_counter() - t)
        grew = minus(counts(fa), before)
        if grew != per_request:
            fail(f"{tag}: one request launched {COUNTED} = {grew}, expected "
                 f"{per_request}")
    launches = counts(fa)
    if out.shape != (1, 1, ZS_IMG, ZS_IMG) or not ((out == 0) | (out == 1)).all():
        fail(f"{tag}: the picked mask is {out.shape}, not a 0 / 1 mask")
    lat = statistics.median(times)
    print(f"{tag}: predict_fused latency median {lat * 1e3:.3f} ms over {reps} "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{1 / lat:.2f} images/s; {COUNTED} launches {launches} ({reps} "
          f"requests x {per_request})")
    return out, launches, lat


def zs_agreement(tag: str, extras_a, extras_b, what: str) -> None:
    """The discrete outputs of two paths side by side: valid proposals,
    the masks' IoU index by index, the picked index; the picked index is
    held equal where the top-2 similarity margin exceeds ZS_MARGIN_FACTOR
    times the paths' largest similarity difference."""
    import torch
    va, vb = extras_a["valid"], extras_b["valid"]
    both = va & vb
    ma, mb = extras_a["masks"][both].float(), extras_b["masks"][both].float()
    inter = (ma * mb).flatten(1).sum(1)
    union = ((ma + mb) > 0).float().flatten(1).sum(1).clamp(min=1)
    iou = (inter / union).mean().item() if bool(both.any()) else float("nan")
    sa, sb = extras_a["sims"], extras_b["sims"]
    pa, pb = int(torch.argmax(sa)), int(torch.argmax(sb))
    print(f"{tag}: {what}: valid proposals {int(va.sum())} / {int(vb.sum())}, "
          f"{int(both.sum())} valid in both, mean mask IoU index by index "
          f"{iou:.4f}, picked index {pa} / {pb}")
    if bool((va == vb).all()) and int(va.sum()) > 0:
        diff = (sa - sb)[va].abs().max().item()
        top2 = sa[va].sort(descending=True).values
        margin = (top2[0] - top2[1]).item() if top2.numel() > 1 else float("inf")
        held = margin > ZS_MARGIN_FACTOR * diff
        print(f"{tag}: {what}: similarities max abs diff {diff:.4g}, top-2 margin "
              f"{margin:.4g}: the picked index is "
              f"{'held equal' if held else 'printed only (margin too small)'}")
        if held and pa != pb:
            fail(f"{tag}: {what}: the picked proposal differs ({pa} vs {pb}) "
                 "though the margin is wide")


def zs_text_vs_plain(fa, tag: str, clip, ids, mask) -> None:
    """The text features of the kernel path (K3) against the plain path."""
    import torch
    ids_t, mask_t = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    with torch.no_grad():
        kern = clip.get_text_features(ids_t, mask_t).float()
        with plain_path():
            before = counts(fa)
            plain = clip.get_text_features(ids_t, mask_t).float()
            if counts(fa) != before:
                fail(f"{tag}: the plain path launched a kernel")
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=-1).min().item()
    rel = ((kern - plain).abs().max() / plain.abs().max()).item()
    print(f"{tag}: text features, kernel path vs plain path: least cosine "
          f"{cos:.6f} (bound {ZS_FEATURE_COS_MIN}), max abs diff {rel:.4g} of the "
          f"largest |plain| (bound {ZS_FEATURE_REL_TOL})")
    if not (cos >= ZS_FEATURE_COS_MIN and rel <= ZS_FEATURE_REL_TOL):
        fail(f"{tag}: text features disagree with the plain path")


# phase 23's model, request and intermediates, which phase 28 reuses
ZS_SHARED: dict = {}


def phase_zero_shot(fa, cf, profile: bool) -> dict:
    """Zero-shot RIS at full width (`build_ris` in bf16 over seeded f32
    weights: CLIP ViT-B/16 and text towers, FreeSOLO R101-FPN with the zsseg
    heads; BiomedCLIP's timm ViT-B/16 and BERT-base), one synthetic 1024^2
    request, alpha 0.95, beta 0.5, masking from layer -3. Fused requests
    (warm-up, median of 5), one `__call__` through the host crop loop, 6
    requests through `predict_fused_many` at depth 2; the launches, every K3
    launch and the text features against the plain path, the device
    crop-resize against the host crops of the path's proposals; the same
    weights on `layout="flat"` (every K4 launch held on its own tensors, the
    raw outputs against "nchw"); BiomedCLIP on the same proposals. Returns
    {path: counts}."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from tunevlseg_torch.eval_zeroshot import build_ris
    from tunevlseg_torch.models.solov2 import backbone as solo_backbone
    from tunevlseg_torch.models.solov2.model import SOLOv2, preprocess_image
    from tunevlseg_torch.models.zero_shot_ris.biomed_clip import (BiomedCLIP,
                                                                  BiomedCLIPConfig)
    from tunevlseg_torch.nn.layers import init_params
    from tunevlseg_torch.ops.image import crop_resize_bicubic_masked
    from tunevlseg_torch.training.optim import count_params

    t_phase = time.perf_counter()
    by_path = {}
    # BiomedCLIP's weights are drawn on the CPU in a thread of their own while
    # the CLIP path runs
    box = {}

    def build_biomed():
        try:
            model = BiomedCLIP(BiomedCLIPConfig(), torch.bfloat16)
            init_params(model, torch.Generator().manual_seed(2))
            box["model"] = model
        except BaseException as e:      # handed to the main thread at join
            box["error"] = e

    builder = threading.Thread(target=build_biomed)
    builder.start()
    cfg = {"model": {"alpha": 0.95, "beta": 0.5, "masking_block_idx": -3},
           "seed": 0}
    t0 = time.perf_counter()
    ris = build_ris(cfg, device="cuda", dtype=torch.bfloat16)
    print(f"zsseg: ZeroShotRIS (CLIP ViT-B/16 + text, {count_params(ris.clip.parameters())} "
          f"params; FreeSOLO R101-FPN {ris.solo_config.fpn_channels}, instance head "
          f"{ris.solo_config.num_instance_convs} x {ris.solo_config.instance_channels}, "
          f"grids {tuple(ris.solo_config.num_grids)}, nms_pre {ris.solo_config.nms_pre}, "
          f"max_per_img {ris.solo_config.max_per_img}, "
          f"{count_params(ris.solo.parameters())} params), bf16 over f32 weights, "
          f"alpha {ris.alpha}, beta {ris.beta}, masking_block_idx "
          f"{ris.masking_block_idx}; built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(80)
    image = zs_image(gen)
    ids, mask = zs_text(gen, 49406, 49407, 49408)
    request = (image, ids, mask)

    torch.cuda.reset_peak_memory_stats()
    picked, extras = zs_request_extras(ris, *request)
    n_valid = int(extras["valid"].sum())
    if n_valid == 0:
        c = ris.solo_config
        ris.solo_config = dataclasses.replace(c, score_threshold=0.005,
                                              update_threshold=1e-4)
        print(f"zsseg: DEVIATION: no valid proposal at score_threshold "
              f"{c.score_threshold} / update_threshold {c.update_threshold}; "
              "lowered to 0.005 / 1e-4 (tests/test_zero_shot_ris.py's values)")
        picked, extras = zs_request_extras(ris, *request)
        n_valid = int(extras["valid"].sum())
    if n_valid < 1:
        fail("zsseg: no valid proposal")
    pick = int(torch.argmax(extras["sims"]))
    print(f"zsseg: {n_valid} valid proposals of {ris.solo_config.max_per_img}, "
          f"picked index {pick}, its mask covers {int(picked.sum())} pixels")

    fused, by_path["serve_zsseg"], fused_s = zs_fused_requests(
        fa, "serve zsseg", ris, request, ZS_SERVE, reps=5)
    if not np.array_equal(fused, picked.cpu().numpy()):
        fail("serve zsseg: predict_fused differs from the request's own mask")
    peak = torch.cuda.max_memory_allocated()
    print(f"serve zsseg: peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    kernels_on_path_inputs(fa, "serve zsseg", lambda: ris.predict_fused(*request),
                           kernels=("K3",))
    zs_text_vs_plain(fa, "serve zsseg", ris.clip, ids, mask)
    if profile:
        profile_calls("serve zsseg fused", lambda: ris.predict_fused(*request),
                      wall=fused_s)

    # the host loop: the crops cut and resized on the host one proposal at a
    # time; its crops and features are recorded on the way
    seen = {}

    def record(name, fn):
        def call(*args, **kwargs):
            seen[name] = (args, fn(*args, **kwargs))
            return seen[name][1]
        return call

    for name in ("host_crop_canvases", "get_visual_feature", "get_text_ensemble"):
        setattr(ris, name, record(name, getattr(ris, name)))
    reset_counts(fa)
    t = time.perf_counter()
    host = ris(*request)
    host_s = time.perf_counter() - t
    for name in ("host_crop_canvases", "get_visual_feature", "get_text_ensemble"):
        delattr(ris, name)
    by_path["serve_zsseg_host"] = counts(fa)
    if by_path["serve_zsseg_host"] != ZS_SERVE:
        fail(f"serve zsseg host: {COUNTED} = {by_path['serve_zsseg_host']}, "
             f"expected {ZS_SERVE}")
    visual, text = seen["get_visual_feature"][1], seen["get_text_ensemble"][1]
    (_, boxes, masks, valid, _), canvases = seen["host_crop_canvases"]
    v = visual / visual.norm(dim=-1, keepdim=True)
    sims = torch.where(torch.from_numpy(valid).to(v.device), v @ (text / text.norm()),
                       torch.tensor(float("-inf"), device=v.device))
    host_extras = {"valid": torch.from_numpy(valid).cuda(),
                   "masks": torch.from_numpy(masks).cuda(), "sims": sims}
    print(f"serve zsseg host: __call__ through the host crop loop {host_s * 1e3:.3f} "
          f"ms ({int(valid.sum())} crops cut on the host), "
          f"{'the same mask as' if np.array_equal(host, fused) else 'another mask than'}"
          " the fused request")
    zs_agreement("serve zsseg host", extras, host_extras, "fused vs host loop")
    dev = crop_resize_bicubic_masked(torch.from_numpy(image).cuda(),
                                     torch.from_numpy(masks).cuda(),
                                     torch.from_numpy(boxes).cuda(),
                                     ris.clip_image_size)[torch.from_numpy(valid).cuda()]
    ref = torch.from_numpy(canvases[valid]).cuda()
    crop_err = ((dev - ref).abs().max() / ref.abs().max()).item()
    print(f"serve zsseg: device crop-resize of the path's {int(valid.sum())} valid "
          f"proposals against the host crops: max abs diff {crop_err:.4g} of the "
          f"largest |host| (bound {ZS_CROP_REL_TOL})")
    if not crop_err <= ZS_CROP_REL_TOL:
        fail("serve zsseg: the device crop-resize disagrees with the host crops")
    del dev, ref, canvases, seen

    # pipelined: 6 requests over 3 images, 2 in flight, after a pass over
    # the 3 that sets the allocator up for requests in flight
    images = [image, zs_image(gen), zs_image(gen)]
    items = [{"image": images[i % 3], "input_ids": ids, "attention_mask": mask}
             for i in range(6)]
    for _ in ris.predict_fused_many(iter(items[:3]), depth=2):
        pass
    reset_counts(fa)
    t = time.perf_counter()
    outs = list(ris.predict_fused_many(iter(items), depth=2))
    pipe_s = time.perf_counter() - t
    by_path["serve_zsseg_pipelined"] = counts(fa)
    if by_path["serve_zsseg_pipelined"] != tuple(6 * n for n in ZS_SERVE) or \
            not np.array_equal(outs[0], fused) or not np.array_equal(outs[3], fused):
        fail(f"serve zsseg pipelined: {COUNTED} = "
             f"{by_path['serve_zsseg_pipelined']}, or another mask than "
             "predict_fused on the same image")
    print(f"serve zsseg pipelined: predict_fused_many depth 2 over 6 requests "
          f"{pipe_s * 1e3:.3f} ms, {6 / pipe_s:.2f} images/s (sequential "
          f"{1 / fused_s:.2f})")

    # the same weights on layout="flat": K4 in the R101's stride-1 blocks
    flat_solo = SOLOv2(ris.solo_config, layout="flat",
                       dtype=ris.solo.backbone.stem_conv1.dtype)
    flat_solo.load_state_dict(ris.solo.state_dict())
    flat = dataclasses.replace(ris, solo=flat_solo.cuda().eval())
    _, by_path["serve_zsseg_flat"], _ = zs_fused_requests(
        fa, "serve zsseg flat", flat, request, ZS_FLAT_SERVE, reps=2)
    held = k4_on_path_inputs(cf, "serve zsseg flat", lambda: flat.predict_fused(*request),
                             module=solo_backbone)
    if held != R101_FLAT_CONVS:
        fail(f"serve zsseg flat: {held} K4 launches held, expected {R101_FLAT_CONVS}")
    with torch.no_grad():
        batched = preprocess_image(torch.from_numpy(image).cuda(), ris.solo_config)
        raw_n, raw_f = ris.solo(batched), flat.solo(batched)
    for what, a, b in (("category logits", torch.cat([x.flatten() for x in raw_n[0]]),
                        torch.cat([x.flatten() for x in raw_f[0]])),
                       ("mask features", raw_n[3], raw_f[3])):
        top = a.float().abs().max().item()
        diff = (a.float() - b.float()).abs()
        dmax, dmean = diff.max().item() / top, diff.mean().item() / top
        print(f'serve zsseg flat: "flat" vs "nchw" on the same weights, {what}: max '
              f"abs diff {dmax:.4g} (bound {ZS_FLAT_RAW_TOL[0]}), mean {dmean:.4g} "
              f"(bound {ZS_FLAT_RAW_TOL[1]}) of the largest |nchw| ({top:.4g})")
        if not (dmax <= ZS_FLAT_RAW_TOL[0] and dmean <= ZS_FLAT_RAW_TOL[1]):
            fail(f"serve zsseg flat: the two layouts' {what} disagree")
    zs_agreement("serve zsseg flat", extras, zs_request_extras(flat, *request)[1],
                 "nchw vs flat")
    del flat, flat_solo, raw_n, raw_f, batched

    # BiomedCLIP over the same proposals
    builder.join()
    if "error" in box:
        raise box["error"]
    biomed = box.pop("model").cuda().eval()
    bris = dataclasses.replace(ris, clip=biomed, clip_config=biomed.config)
    bids, bmask = zs_text(gen, 2, 3, biomed.config.text.vocab_size)
    brequest = (image, bids, bmask)
    print(f"zsseg biomed: BiomedCLIP (timm ViT-B/16 at 224^2, BERT-base, "
          f"projection {biomed.config.projection_dim}), "
          f"{count_params(biomed.parameters())} params, bf16 over f32 weights")
    _, by_path["serve_zsseg_biomed"], _ = zs_fused_requests(
        fa, "serve zsseg biomed", bris, brequest, ZS_SERVE, reps=2)
    kernels_on_path_inputs(fa, "serve zsseg biomed",
                           lambda: bris.predict_fused(*brequest), kernels=("K3",))
    zs_text_vs_plain(fa, "serve zsseg biomed", biomed, bids, bmask)
    _, bextras = zs_request_extras(bris, *brequest)
    print(f"zsseg biomed: {int(bextras['valid'].sum())} valid proposals, picked "
          f"index {int(torch.argmax(bextras['sims']))}")
    del bris, biomed
    # phase 28 splits this request's proposals over two devices
    ZS_SHARED.update(ris=ris, request=request, extras=extras)
    del ris
    torch.cuda.empty_cache()
    print(f"zsseg: phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


# --- S1-S4, the variants of K1 that the attention sweeps time ----------------

# --- Slice G1: real-layout checkpoints ------------------------------------------

# OpenAI CLIP's BPE ids of "a photo of a" (without BOS / EOS), the default
# context initializer of the CoOp configs: constants, so the phase needs no
# vocabulary file
A_PHOTO_OF_A = (320, 1125, 539, 320)
CKPT_SEED = 240


class InitializerIds:
    """The tokenizer `train._initializer_embeddings` asks for the
    initializer's ids: here the constant ids of "a photo of a"."""

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        if text != "a photo of a" or add_special_tokens:
            fail(f"checkpoints: no constant ids for {text!r}")
        return list(A_PHOTO_OF_A)


def torch_holder():
    import torch

    class TensorHolder(torch.nn.Module):
        """A module that only holds tensors."""
    return TensorHolder


def write_safetensors(path, tensors: dict) -> None:
    """f32 tensors in the safetensors format: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}} padded to
    8 bytes, then the raw little-endian buffers in the header's order."""
    import struct

    import torch
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            fail(f"write_safetensors: {name} is {t.dtype}")
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + 4 * t.numel()]}
        offset += 4 * t.numel()
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().numpy().data)


def write_torchscript(path, tensors: dict) -> None:
    """The tensors as a TorchScript archive, OpenAI's RN50.pt layout: modules
    nested along the keys' dots, BatchNorm statistics as buffers."""
    import torch
    holder = torch_holder()
    root = holder()
    for key, value in tensors.items():
        *mods, leaf = key.split(".")
        node = root
        for part in mods:
            if part not in node._modules:
                node.add_module(part, holder())
            node = node._modules[part]
        if "running" in leaf or "num_batches" in leaf:
            node.register_buffer(leaf, value)
        else:
            node.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
    torch.jit.save(torch.jit.script(root), str(path))


def drawn_checkpoint(keyset: str, seed: int) -> dict:
    """A full-width checkpoint on a real key set, drawn on the CPU from a
    seeded torch.Generator at an initialisation's scale (norm weights
    1 +- 0.02, BatchNorm variances in [0.5, 1.5], the rest N(0, 0.02))."""
    import torch
    from tunevlseg_torch.convert.coverage import read_keyset, synthetic_state_dict
    return synthetic_state_dict(read_keyset(keyset),
                                torch.Generator().manual_seed(seed))


def checkpoint_landed(tag: str, written: dict, convert, module, ignored: tuple,
                      fresh: tuple = ()) -> None:
    """The checkpoint `written` (the tensors put in the file) against
    `module` on the card: every key read by `convert` or ignorable (by
    suffix); each module tensor converted from a key equal, bit for bit in
    f32, to that key's tensor after the documented transform (identity, the
    patch embedding's reshape, a q / k / v third); every other module tensor
    under `fresh`. Keys whose tensors the module elides are counted."""
    import torch
    from tunevlseg_torch.convert.checkpoint_io import TrackingDict, to_numpy
    from tunevlseg_torch.convert.coverage import (expected_tensor, sources,
                                                  unread_keys)
    sd = TrackingDict(to_numpy(written))
    tree = convert(sd)
    origin = sources(tree, sd)
    unread = unread_keys(tree, sd, ignored)
    own = module.state_dict()
    compared = 0
    for name, key in origin.items():
        if name not in own:
            continue
        got = own[name]
        want = expected_tensor(name, got.shape, written[key]).to(got.device)
        if got.dtype != torch.float32 or not torch.equal(got, want):
            fail(f"{tag}: {name} differs from {key} after its documented transform")
        compared += 1
    landed = {origin[n] for n in origin if n in own}
    elided = set(origin.values()) - landed
    unfilled = [n for n in own if n not in origin and not n.startswith(fresh)]
    ignorable = sum(k.endswith(ignored) for k in sd)
    print(f"{tag}: {len(sd)} checkpoint keys: {len(landed)} landed in {compared} "
          f"tensors on the card, bit-identical in f32 after the documented "
          f"transform; {len(elided)} read and elided by the named rule; "
          f"{ignorable} ignorable ({', '.join(ignored)}); {len(unread)} unread; "
          f"{len(own) - compared} module tensors fresh "
          f"({', '.join(fresh) or 'none'})")
    if unread or unfilled or not compared:
        fail(f"{tag}: unread keys {unread[:4]}, unfilled tensors {unfilled[:4]}")


def file_gb(path) -> float:
    import os
    return os.path.getsize(path) / 1e9


def timed_load(tag: str, path, load):
    """`load()` (read and convert a checkpoint) timed; prints its seconds,
    the file's GB and the rate."""
    t = time.perf_counter()
    out = load()
    secs = time.perf_counter() - t
    print(f"{tag}: load and convert {secs:.3f} s for {file_gb(path):.3f} GB "
          f"({file_gb(path) / secs:.2f} GB/s) from {path.name}")
    return out


def checkpoint_cfg(path, model: dict, **top) -> dict:
    """A composed config as the train CLI sees it, for `load_pretrained` and
    `build_model_and_task` (bf16 compute over f32 weights)."""
    return {"pretrained_checkpoint": str(path), "seed": 0,
            "trainer": {"precision": "bf16"}, "model": model, **top}


def initializer_landed(tag: str, model, table_name: str, written: dict) -> None:
    """The first depth's context vectors are the checkpoint's token
    embeddings of "a photo of a", bit for bit, and there are 4 of them."""
    import torch
    ctx = model.learner.context_vectors.detach()
    want = written[table_name][list(A_PHOTO_OF_A)].to(ctx.device)
    if ctx.shape[1] != len(A_PHOTO_OF_A) or not torch.equal(ctx[0], want):
        fail(f"{tag}: the context vectors are not the initializer's embeddings")
    print(f"{tag}: context vectors {tuple(ctx.shape)}, depth 0 = the checkpoint's "
          f"embeddings of \"a photo of a\" {A_PHOTO_OF_A}, bit-identical")


def phase_checkpoints(fa, cf) -> dict:
    """Synthetic full-width checkpoints in the real files' layouts, loaded
    through the port's entry points on the card: CIDAS CLIPSeg rd64-refined
    as `.safetensors` (CoOp, depth 3, contexts from "a photo of a") and the
    same weights as a reference-wrapper Lightning `.ckpt` with a CoOp
    learner, both through `train.load_pretrained`; OpenAI RN50 as a
    TorchScript `.pt` under CRIS CoOp ("nchw", then "flat": every K4 launch
    held, flat against nchw); FreeSOLO R101 as `{"model": sd}` with the
    CLIPSeg-layout file in `eval_zeroshot.build_ris`; SigLIP-base as `.bin`
    under the PhraseCut segmentor. Each: every key read or named, every
    converted tensor on the card bit-identical to its source, load seconds.
    Returns {path: counts}."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from tunevlseg_torch import eval_zeroshot, train
    from tunevlseg_torch.convert import clipseg as clipseg_conv
    from tunevlseg_torch.convert import cris as cris_conv
    from tunevlseg_torch.convert import solov2 as solo_conv
    from tunevlseg_torch.convert import trans_segmentor as ts_conv
    from tunevlseg_torch.convert.coverage import merged
    from tunevlseg_torch.models.presets import clipseg_rd64_config, cris_rn50_config
    from tunevlseg_torch.models.solov2.model import SOLOv2Config
    from tunevlseg_torch.serving import task_predict_fn

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    peaks = []      # the serve / step helpers reset the peak: read after each

    def peak_so_far():
        peaks.append(torch.cuda.max_memory_allocated())
    by_path = {}
    tmp = tempfile.TemporaryDirectory(prefix="tvs_ckpt_")
    folder = Path(tmp.name)

    # --- CLIPSeg rd64-refined + CoOp from the safetensors file -------------------
    t = time.perf_counter()
    rd64 = drawn_checkpoint("clipseg_rd64_refined", CKPT_SEED)
    st_path = folder / "clipseg-rd64-refined.safetensors"
    write_safetensors(st_path, rd64)
    print(f"checkpoints: CIDAS rd64-refined key set ({len(rd64)} keys) drawn and "
          f"written as safetensors in {time.perf_counter() - t:.2f} s")
    model_cfg = {"family": "clipseg", "strategy": "coop", "prompt_depth": 3,
                 "num_context": 4, "context_initializer": "a photo of a",
                 "complex_head": True, "optimizer": {"lr": 2e-4}}
    cfg = checkpoint_cfg(st_path, model_cfg)
    loaded = timed_load("checkpoints clipseg", st_path,
                        lambda: train.load_pretrained(cfg))
    t = time.perf_counter()
    model, task = train.build_model_and_task(cfg, InitializerIds(), pretrained=loaded,
                                             device="cuda")
    state = task.init(**train.init_kwargs(loaded))
    torch.cuda.synchronize()
    print(f"checkpoints clipseg: CoOp model built (seeded) and loaded on the card "
          f"in {time.perf_counter() - t:.2f} s")
    rcfg = clipseg_rd64_config(complex_head=True)
    checkpoint_landed("checkpoints clipseg", rd64,
                      lambda sd: clipseg_conv.convert_hf_clipseg(sd, rcfg), model,
                      clipseg_conv.CLIPSEG_IGNORED, ("learner.", "residual_ratio"))
    initializer_landed("checkpoints clipseg", model,
                       "clip.text_model.embeddings.token_embedding.weight", rd64)
    request = three_requests(240, IMG, 49407)[0]
    params = dict(model.named_parameters())
    predict = task_predict_fn(task)
    probs, by_path["serve_ckpt_clipseg"] = serve_requests(
        fa, "checkpoints clipseg serve", predict, params, [request], IMG,
        CLIPSEG_SERVE, reps=3)
    peak_so_far()
    compare_with_plain_path(fa, "checkpoints clipseg serve", predict, params,
                            request[1], probs)
    del probs, params
    batch = make_train_batch(BATCH, text_dedup=1, seed=241)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    state, _, by_path["train_ckpt_clipseg_coop"] = timed_steps(
        fa, task, state, batch, "checkpoints clipseg train coop", warmup=2, steps=3,
        per_step=CLIPSEG_COOP_STEP)
    peak_so_far()
    for name, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, start[name]):
            fail(f"checkpoints clipseg: frozen tensor {name} changed")
    if torch.equal(model.learner.context_vectors, start["learner.context_vectors"]):
        fail("checkpoints clipseg: the context vectors did not move")
    print("checkpoints clipseg train coop: context vectors moved, every frozen "
          "tensor (the checkpoint's) bit-identical")
    first_step_kernel_vs_plain(fa, "checkpoints clipseg train coop", task, start,
                               batch, ("learner.context_vectors",))
    del batch, start, state

    # --- the same weights as the reference wrapper's Lightning checkpoint --------
    ctx = 0.02 * torch.randn(tuple(model.learner.context_vectors.shape),
                             generator=torch.Generator().manual_seed(CKPT_SEED + 1))
    wrapper = {f"model.{k}": v for k, v in rd64.items()}
    wrapper.update({"context_learner.context_vectors": ctx,
                    "residual_ratio": torch.tensor(0.5)})
    ckpt_path = folder / "coop_clipseg.ckpt"
    t = time.perf_counter()
    torch.save({"state_dict": wrapper, "epoch": 12, "global_step": 3456}, ckpt_path)
    print(f"checkpoints clipseg ckpt: reference wrapper written in "
          f"{time.perf_counter() - t:.2f} s")
    cfg = checkpoint_cfg(ckpt_path, model_cfg)
    loaded = timed_load("checkpoints clipseg ckpt", ckpt_path,
                        lambda: train.load_pretrained(cfg))
    task.init(**train.init_kwargs(loaded))
    checkpoint_landed("checkpoints clipseg ckpt", wrapper,
                      lambda sd: clipseg_conv.load_checkpoint_params(
                          None, rcfg, "coop", sd=sd), model,
                      clipseg_conv.CLIPSEG_IGNORED)
    os.remove(ckpt_path)
    del model, task, predict, loaded, wrapper
    torch.cuda.empty_cache()

    # --- CRIS CoOp from OpenAI's RN50 TorchScript archive ------------------------
    t = time.perf_counter()
    rn50 = drawn_checkpoint("clip_rn50", CKPT_SEED + 2)
    rn_path = folder / "RN50.pt"
    write_torchscript(rn_path, rn50)
    print(f"checkpoints cris: RN50 key set ({len(rn50)} keys) drawn and written "
          f"as a TorchScript archive in {time.perf_counter() - t:.2f} s")
    cfg = checkpoint_cfg(rn_path, {**model_cfg, "family": "cris"}, img_size=CRIS_IMG)
    del cfg["model"]["complex_head"]
    loaded = timed_load("checkpoints cris", rn_path, lambda: train.load_pretrained(cfg))
    model, task = train.build_model_and_task(cfg, InitializerIds(), pretrained=loaded,
                                             device="cuda")
    task.init(**train.init_kwargs(loaded))
    checkpoint_landed("checkpoints cris", rn50,
                      lambda sd: merged(cris_conv.convert_cris(
                          sd, cris_rn50_config(CRIS_IMG))),
                      model, cris_conv.CRIS_IGNORED,
                      ("neck.", "decoder.", "proj.", "learner.", "additive_",
                       "residual_ratio"))
    initializer_landed("checkpoints cris", model, "token_embedding.weight", rn50)
    request = three_requests(242, CRIS_IMG, 0)[0]
    params = dict(model.state_dict())
    predict = task_predict_fn(task)
    probs, by_path["serve_ckpt_cris"] = serve_requests(
        fa, "checkpoints cris serve", predict, params, [request], CRIS_IMG,
        CRIS_SERVE, reps=3)
    peak_so_far()
    compare_with_plain_path(fa, "checkpoints cris serve", predict, params,
                            request[1], probs)
    with switch_layout(model, "flat"):
        flat, by_path["serve_ckpt_cris_flat"] = serve_requests(
            fa, "checkpoints cris flat serve", predict, params, [request], CRIS_IMG,
            CRIS_FLAT_SERVE, reps=3)
        peak_so_far()
        held = k4_on_path_inputs(cf, "checkpoints cris flat serve",
                                 lambda: predict(params, request[1]))
        with torch.no_grad():
            logits_flat = task._forward(request[1]).float()
    with torch.no_grad():
        logits = task._forward(request[1]).float()
    diff = (flat - probs).abs()
    ldiff = (logits_flat - logits).abs().max().item() / logits.abs().max().item()
    print(f"checkpoints cris flat serve: {held} K4 launches held on their own "
          f"tensors (the converted BatchNorm statistics folded in); flat vs nchw "
          f"probabilities max abs diff {diff.max().item():.6g} (bound "
          f"{FLAT_PROB_MAX_TOL}), mean {diff.mean().item():.6g} (bound "
          f"{FLAT_PROB_MEAN_TOL}); logits max abs diff {ldiff:.4g} of the largest")
    if not (diff.max().item() <= FLAT_PROB_MAX_TOL
            and diff.mean().item() <= FLAT_PROB_MEAN_TOL):
        fail("checkpoints cris: flat and nchw disagree beyond the stated bounds")
    os.remove(rn_path)
    del model, task, predict, params, probs, flat, loaded, rn50
    torch.cuda.empty_cache()

    # --- zero-shot RIS: FreeSOLO's payload and the CLIPSeg-layout file -----------
    t = time.perf_counter()
    solo = drawn_checkpoint("freesolo_r101", CKPT_SEED + 3)
    solo_path = folder / "FreeSOLO_R101_30k.pt"
    torch.save({"model": solo, "iteration": 30000}, solo_path)
    print(f"checkpoints zsseg: FreeSOLO R101 key set ({len(solo)} keys) drawn and "
          f"written in {time.perf_counter() - t:.2f} s")
    zcfg = {"model": {"solo_checkpoint": str(solo_path),
                      "clip_checkpoint": str(st_path)}, "seed": 0}
    ris = timed_load("checkpoints zsseg", solo_path, lambda: eval_zeroshot.build_ris(
        zcfg, device="cuda", dtype=torch.bfloat16))
    print(f"checkpoints zsseg: clip_checkpoint {file_gb(st_path):.3f} GB read in "
          "the same call")
    checkpoint_landed("checkpoints zsseg solo", solo,
                      lambda sd: solo_conv.convert_solov2(sd, SOLOv2Config()),
                      ris.solo, solo_conv.SOLOV2_IGNORED)
    checkpoint_landed("checkpoints zsseg clip", rd64,
                      lambda sd: clipseg_conv.convert_hf_clipseg(sd, rcfg), ris.clip,
                      clipseg_conv.CLIPSEG_IGNORED)
    gen = torch.Generator().manual_seed(243)
    image = zs_image(gen)
    ids, mask = zs_text(gen, 49406, 49407, 49408)
    _, by_path["serve_zsseg_ckpt"], _ = zs_fused_requests(
        fa, "checkpoints zsseg", ris, (image, ids, mask), ZS_SERVE, reps=3)
    kernels_on_path_inputs(fa, "checkpoints zsseg", lambda: ris.predict_fused(
        image, ids, mask), kernels=("K3",))
    peak_so_far()
    zs_text_vs_plain(fa, "checkpoints zsseg", ris.clip, ids, mask)
    os.remove(solo_path)
    del ris, solo, rd64
    torch.cuda.empty_cache()

    # --- PhraseCut on SigLIP-base ------------------------------------------------
    t = time.perf_counter()
    siglip = drawn_checkpoint("siglip_base_patch16_224", CKPT_SEED + 4)
    sig_path = folder / "siglip-base-patch16-224.bin"
    torch.save(siglip, sig_path)
    print(f"checkpoints phrasecut: SigLIP-base key set ({len(siglip)} keys) drawn "
          f"and written in {time.perf_counter() - t:.2f} s")
    cfg = checkpoint_cfg(sig_path, {
        "family": "trans_segmentor", "encoder_family": "siglip",
        "use_existing_proj": True, "freeze_encoders": True, "decoder_num_heads": 16,
        "decoder_num_layers": 4, "decoder_dropout": 0.1, "num_upsampler_layers": 5,
        "output_bias": -1.748104048321891, "optimizer": {"lr": 2e-5},
        "loss_fn": {"name": "dice_ce", "lambda_dice": 1, "lambda_ce": 0.2,
                    "weight": 5.8}}, img_size=PC_IMG)
    loaded = timed_load("checkpoints phrasecut", sig_path,
                        lambda: train.load_pretrained(cfg))
    model, task = train.build_model_and_task(cfg, None, pretrained=loaded,
                                             device="cuda")
    task.init(**train.init_kwargs(loaded))
    checkpoint_landed("checkpoints phrasecut", siglip,
                      lambda sd: ts_conv.convert_encoder(
                          sd, train.trans_segmentor_config(cfg)), model,
                      ts_conv.TRANS_SEGMENTOR_IGNORED,
                      ("decoder_layers.", "decoder_norm.", "upsampler.",
                       "text_projection.", "visual_projection."))
    ids, mask = siglip_ids(gen, 1)
    req = {"image": torch.randint(0, 256, (PC_BATCH, 3, PC_IMG, PC_IMG),
                                  generator=gen, dtype=torch.uint8),
           "input_ids": ids, "attention_mask": mask,
           "text_index": torch.zeros(PC_BATCH, dtype=torch.int32)}
    req = {k: v.cuda() for k, v in req.items()}
    params = dict(model.state_dict())
    predict = task_predict_fn(task)
    probs, by_path["serve_ckpt_phrasecut"] = serve_requests(
        fa, "checkpoints phrasecut serve", predict, params,
        [("b16 dedup U=1", req, PC_BATCH)], PC_IMG, PC_SERVE, reps=3)
    peak_so_far()
    compare_with_plain_path(fa, "checkpoints phrasecut serve", predict, params, req,
                            probs, "b16 dedup")
    del model, task, predict, params, probs, loaded, siglip
    tmp.cleanup()
    torch.cuda.empty_cache()
    peak_so_far()
    peak = max(peaks)
    print(f"checkpoints: peak device memory over the phase {peak} bytes "
          f"({peak / 2**30:.2f} GiB); phase {time.perf_counter() - t_phase:.1f} s "
          f"({CARD[0]})")
    return by_path


# --- Slice G2: trans_seg_siglip (D = 96) and the serving export ----------------

# model=trans_seg_siglip: SigLIP-base towers (12 heads of 64) with fresh
# projections, so a decoder 768 wide with 8 heads of 96, at 352^2 (22^2 = 484
# tokens, no CLS) over the SigLIP text's 64 tokens: K1 in the 12 vision layers
# and the 4 decoder self-attentions (D = 96), K3 in the 12 text layers
# (padding bias) and the 4 cross-attentions into the text (D = 96), K2 for
# all 16 in the full fine-tune
TSS_DECODER = (TS_BATCH, 484, 8, 96)
D96_SHAPES = (("trans_seg_siglip decoder d96", TSS_DECODER, None),
              ("d96 kv_valid 485 of 512", (4, 512, 8, 96), 485))
TSS_SERVE = (16, 0, 16, 0, 0, 0) + NO_VARIANTS
TSS_STEP = (16, 16, 16, 0, 0, 0) + NO_VARIANTS
# the SigLIP text's padding: 10 real tokens of 64 (`siglip_ids`)
TSS_TEXT_VALID = 10


def k3_cases_d96(gen):
    """K3 at D = 96: trans_seg_siglip's cross-attention (484 queries into the
    64 text keys under the key-pad bias), the same with keys short of T
    (kv_valid 10), and a full bias over streamed keys (T = 245: four 80-key
    tiles through the ring). Yields what `k3_cases` does."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def key_pad(rows, t, first):
        bias = torch.zeros(rows, 1, 1, t, device="cuda")
        bias[..., first:] = F32_MIN
        return bias

    b, s, h, d = TSS_DECODER
    for label, (b, s, h, d), t, kv, bias in (
            ("trans_seg_siglip cross d96", TSS_DECODER, PC_SEQ, None,
             key_pad(b, PC_SEQ, TSS_TEXT_VALID)),
            ("cross d96 kv_valid 10 of 64", TSS_DECODER, PC_SEQ, TSS_TEXT_VALID,
             key_pad(b, PC_SEQ, TSS_TEXT_VALID)),
            ("cross d96 full bias T=245 streamed", (4, 300, 8, 96), 245, None,
             torch.randn(4, 8, 300, 245, generator=gen, device="cuda"))):
        yield label, (b, s, h, d), t, kv, bias, (rnd(b, s, h, d), rnd(b, t, h, d),
                                                 rnd(b, t, h, d))


def tss_config():
    """model=trans_seg_siglip as the train CLI composes it at img_size 352
    (`train.trans_segmentor_config`), with the decoder's dropout off, as
    `bench.py` builds its trans_seg row (so that the kernel path and the
    plain path take the same step)."""
    from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
    return TransSegmentorConfig.siglip_base(image_size=IMG, decoder_dropout=0.0)


def siglip_request(gen, batch: int, unique_prompts: int):
    """A SigLIP request: uint8 images and `siglip_ids` rows (one deduplicated
    row with text_index, or one a sample), on the card."""
    import torch
    ids, mask = siglip_ids(gen, 1 if unique_prompts == 1 else batch)
    req = {"image": torch.randint(0, 256, (batch, 3, IMG, IMG), generator=gen,
                                  dtype=torch.uint8),
           "input_ids": ids, "attention_mask": mask}
    if unique_prompts == 1:
        req["text_index"] = torch.zeros(batch, dtype=torch.int32)
    return {k: v.cuda() for k, v in req.items()}


def phase_kernels_d96(fa) -> tuple:
    """K1, K2 and K3 at D = 96 against their plain versions (the kernel
    phases' checks and times at `D96_SHAPES` / `k3_cases_d96`). Returns the
    kernels' numbers (K1, K2, K3)."""
    return (phase_kernels(fa, D96_SHAPES, host=False),
            phase_kernels_bwd(fa, D96_SHAPES), phase_kernels_k3(fa, k3_cases_d96))


def phase_trans_seg_siglip(fa, profile: bool) -> tuple:
    """Phase 25: model=trans_seg_siglip at full width (its kernels at D = 96
    checked by `phase_kernels_d96`): b32 and b1 requests against the plain
    path, 2 warm-up + 5 timed b32 full fine-tune steps (finite losses, step
    ms, peak memory, the launches a step), the first step against the plain
    path. Returns ({path: counts}, the task and its weights, the b32
    request) for phase 26."""
    import torch

    from tunevlseg_torch.models.presets import (build_trans_segmentor,
                                                trans_segmentor_head_dims)
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.optim import count_params
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    config = tss_config()
    heads = trans_segmentor_head_dims(config)
    if heads["decoder"] != 96:
        fail(f"trans_seg_siglip: head dims {heads}, expected the decoder at 96")
    model, spec = build_trans_segmentor(config, dtype=torch.bfloat16,
                                        device="cuda", seed=0)
    task = SegmentationTask(model, spec, learning_rate=2e-5)
    print(f"trans_seg_siglip: TransformerSegmentor with SigLIP-base towers "
          f"(768 x 12, {PC_SEQ} text positions) and fresh projections at "
          f"{IMG}^2 (484 tokens), decoder 4 x 8 heads of 96 (head dims {heads}), "
          f"FFN 2048, upsampler 5 stages, bf16 compute over f32 weights, "
          f"{count_params(model.parameters())} params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    by_path = {}
    params = dict(model.state_dict())
    predict = task_predict_fn(task)
    gen = torch.Generator().manual_seed(70)
    requests = [("b32 dense", siglip_request(gen, TS_BATCH, TS_BATCH), TS_BATCH),
                ("b1", siglip_request(gen, 1, 1), 1)]
    probs, by_path["serve_trans_seg_siglip"] = serve_requests(
        fa, "serve trans_seg_siglip", predict, params, requests, IMG, TSS_SERVE,
        reps=3)
    compare_with_plain_path(fa, "serve trans_seg_siglip", predict, params,
                            requests[0][1], probs, "b32 dense")
    if profile:
        for label, req, _ in requests:
            profile_calls(f"serve trans_seg_siglip {label}",
                          lambda: predict(params, req))
    del probs

    state = task.init()
    ids, mask = siglip_ids(gen, TS_BATCH)
    batch = {"image": torch.randint(0, 256, (TS_BATCH, 3, IMG, IMG),
                                    generator=gen, dtype=torch.uint8),
             "mask": (torch.rand(TS_BATCH, 1, IMG, IMG, generator=gen)
                      > 0.85).float(),
             "input_ids": ids, "attention_mask": mask,
             "valid": torch.ones(TS_BATCH)}
    batch = {k: v.cuda() for k, v in batch.items()}
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    if len(trainable) != len(start):
        fail("train trans_seg_siglip: the full fine-tune froze parameters")
    state, losses, by_path["train_trans_seg_siglip"] = timed_steps(
        fa, task, state, batch, "train trans_seg_siglip", warmup=2, steps=5,
        per_step=TSS_STEP)
    print(f"train trans_seg_siglip: b{TS_BATCH} full fine-tune ({len(trainable)} "
          f"leaves, AdamW lr 2e-5) fits in 80 GB: launches a step (K1, K2, K3) "
          f"= {TSS_STEP[:3]}; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    first_step_kernel_vs_plain(
        fa, "train trans_seg_siglip", task, start, batch,
        ("vision_model.layers.0.self_attn.q_proj.weight",
         "text_model.layers.0.self_attn.q_proj.weight",
         "decoder_layers.0.multihead_attn.q_proj.weight",
         "decoder_layers.3.self_attn.out_proj.weight",
         "upsampler.out_conv.weight"))
    if profile:
        profile_step("trans_seg_siglip", task, task.init(), batch)
    del state, batch, start, params
    return by_path, task, requests[0][1]


def latency_ms(fn, reps: int = 5) -> float:
    """Median wall time of `fn()` with a synchronize after each call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def exported_vs_eager(fa, tag: str, task, params: dict, request, per_forward: tuple,
                      want_ops: tuple, out_dir, platforms=("cuda",), reps: int = 3,
                      profile: bool = False):
    """Export the task's predict step at `request`'s shapes, load it (the
    program alone) and hold it against the eager `task_predict_fn`: the
    probabilities bit for bit (else the largest difference, and the
    `tunevlseg::` op that differs, by running each of the graph's op calls
    against its eager launch on the same inputs), the launches of a
    forward equal to eager's `per_forward`, the graph naming `want_ops`.
    Returns (the counts of `reps` forwards of the program, counted from 0,
    {numbers})."""
    import torch

    from tunevlseg_torch import serving

    eager = serving.task_predict_fn(task)
    t0 = time.perf_counter()
    serving.export_task_predict(task, params, request, out_dir, platforms=platforms)
    export_s = time.perf_counter() - t0
    meta = serving.read_meta(out_dir)
    t0 = time.perf_counter()
    program = serving.load_fn(out_dir, device="cuda")
    load_s = time.perf_counter() - t0
    ops = serving.graph_ops(program.module)
    if sorted(want_ops) != ops:
        fail(f"{tag}: the program's graph calls {ops}, expected {want_ops}")
    if meta["tunevlseg_ops"]["cuda"] != sorted(want_ops):
        fail(f"{tag}: meta.json names {meta['tunevlseg_ops']}")
    want = eager(params, request)
    got = program(params, request)
    torch.cuda.synchronize()
    diff = (got - want).abs().max().item()
    same = torch.equal(got, want)
    if not same:
        for op_name, op_diff in op_differences(program, eager, params, request):
            print(f"{tag}: {op_name}'s output in the exported program against "
                  f"the same launch in eager task_predict_fn: max abs diff "
                  f"{op_diff:.6g}")
        fail(f"{tag}: the exported program's probabilities differ from the eager "
             f"task_predict_fn's by up to {diff:.6g}")
    reset_counts(fa)
    for _ in range(reps):
        program(params, request)
    torch.cuda.synchronize()
    launches = counts(fa)
    if launches != tuple(reps * n for n in per_forward):
        fail(f"{tag}: {reps} forwards of the program launched {COUNTED} = "
             f"{launches}, eager launches {per_forward} a forward")
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    numbers = {"program_ms": latency_ms(lambda: program(params, request)),
               "eager_ms": latency_ms(lambda: eager(params, request)),
               "graph_bytes": meta["graph_bytes"], "weight_bytes": weight_bytes,
               "export_s": export_s, "load_s": load_s, "ops": ops}
    batch = request["image"].shape[0]
    print(f"{tag}: exported for {meta['platforms']} in {export_s:.1f} s, loaded "
          f"in {load_s:.2f} s; the graph calls {ops}; b{batch} probabilities "
          f"bit-identical to eager task_predict_fn ({same}); {reps} forwards "
          f"launched {COUNTED} = {launches} ({per_forward} a forward, as eager); "
          f"latency (synchronized, median of 5) program {numbers['program_ms']:.3f} "
          f"ms vs eager {numbers['eager_ms']:.3f} ms "
          f"({numbers['program_ms'] / numbers['eager_ms']:.3f}x); artifact "
          f"{meta['graph_bytes']} bytes vs {weight_bytes} bytes of weights "
          f"({meta['graph_bytes'] / weight_bytes:.4f}x)")
    if not meta["graph_bytes"] < weight_bytes:
        fail(f"{tag}: the artifact is not smaller than the weights it serves")
    if profile:
        profile_calls(f"{tag} program", lambda: program(params, request))
        profile_calls(f"{tag} eager", lambda: eager(params, request))
    return launches, numbers


def op_differences(program, eager, params, request) -> list:
    """The `tunevlseg::` op launches of one forward of the program and one of
    the eager function, recorded in order by a dispatch mode and paired up:
    (op, largest difference of its first output) for each pair, in order, so
    that the first launch that differs names the op where the two part."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.outs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "tunevlseg":
                first = out[0] if isinstance(out, tuple) else out
                self.outs.append((str(func), first.detach().float().clone()))
            return out

    runs = []
    for fn in (program, eager):
        with Record() as rec:
            fn(params, request)
        torch.cuda.synchronize()
        runs.append(rec.outs)
    if len(runs[0]) != len(runs[1]):
        return [("the launch sequences", float(len(runs[0]) - len(runs[1])))]
    return [(f"launch {i} ({name})", (a - b).abs().max().item())
            for i, ((name, a), (_, b)) in enumerate(zip(*runs))]


def phase_export(fa, tss_task, tss_request, profile: bool = False) -> tuple:
    """Phase 26: the serving export on the card, at full width, in one
    process: CLIPSeg CoOp rd64 b64 dedup (K1 and K3 in the graph), CRIS CoOp
    b64 on the flat backbone (K1, K3 and K4), trans_seg b32 (`bench.py`'s
    row at full width, its towers cut to TS_EXPORT_TOWER_LAYERS layers) and
    trans_seg_siglip b32 (phase 25's model: K1 and K3 at D = 96). Each program is exported, loaded and
    held against eager `task_predict_fn` (`exported_vs_eager`); CLIPSeg also
    at b1, exported for ("cuda", "cpu"), and the cpu program run on CPU
    copies of the weights and the request against the card's program.
    Returns ({path: counts}, {label: numbers})."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from tunevlseg_torch import serving
    from tunevlseg_torch.models.presets import build_cris, build_trans_segmentor

    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.task import SegmentationTask

    by_path, numbers = {}, {}
    root = Path(tempfile.mkdtemp(prefix="export_"))
    model, _ = build_clipseg("coop", prompt_depth=3, num_context=4,
                             dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model.eval())
    params = dict(model.state_dict())
    requests = three_requests(80, IMG, 49407)
    by_path["export_clipseg_coop"], numbers["clipseg coop b64"] = exported_vs_eager(
        fa, "export clipseg coop b64 dedup", task, params, requests[0][1],
        CLIPSEG_SERVE, ("biased_attn_fwd", "flash_attn_fwd", "layer_norm"),
        root / "clipseg_b64", profile=profile)
    _, numbers["clipseg coop b1"] = exported_vs_eager(
        fa, "export clipseg coop b1", task, params, requests[2][1], CLIPSEG_SERVE,
        ("biased_attn_fwd", "flash_attn_fwd", "layer_norm"), root / "clipseg_b1",
        platforms=("cuda", "cpu"), profile=profile)
    meta = serving.read_meta(root / "clipseg_b1")
    if meta["platforms"] != ["cuda", "cpu"] or meta["tunevlseg_ops"]["cpu"]:
        fail(f"export clipseg coop b1: meta.json {meta['platforms']}, "
             f"{meta['tunevlseg_ops']}")
    cpu_program = serving.load_fn(root / "clipseg_b1", device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu_request = {k: v.cpu() for k, v in requests[2][1].items()}
    t0 = time.perf_counter()
    before = counts(fa)
    cpu_probs = cpu_program(cpu_params, cpu_request)
    cpu_s = time.perf_counter() - t0
    if counts(fa) != before:
        fail("export clipseg coop b1: the cpu program launched a kernel")
    card = serving.load_fn(root / "clipseg_b1", device="cuda")(params, requests[2][1])
    check_probs("export clipseg coop b1 cpu program", cpu_probs, 1, IMG)
    diff = (cpu_probs - card.cpu()).abs()
    print(f"export clipseg coop b1: the cpu program of the same artifact on the "
          f"host ({cpu_s:.2f} s, the plain path, no launch) against the card's "
          f"program: max abs diff {diff.max().item():.6g} (bound {PROB_MAX_TOL}), "
          f"mean {diff.mean().item():.6g} (bound {PROB_MEAN_TOL})")
    if not (diff.max().item() <= PROB_MAX_TOL and diff.mean().item() <= PROB_MEAN_TOL):
        fail("export clipseg coop b1: the cpu and the cuda programs disagree")
    numbers["clipseg coop b1"]["cpu_program_s"] = cpu_s
    del task, params, cpu_params, model

    model, _ = build_cris("coop", prompt_depth=3, num_context=4, layout="flat",
                          dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model)
    params = dict(model.state_dict())
    request = three_requests(81, CRIS_IMG, 0)[0][1]
    by_path["export_cris_flat_coop"], numbers["cris coop flat b64"] = \
        exported_vs_eager(fa, "export cris coop flat b64 dedup", task, params,
                          request, CRIS_FLAT_SERVE,
                          ("biased_attn_fwd", "conv_flat", "flash_attn_fwd",
                           "layer_norm"),
                          root / "cris_flat_b64")
    del task, params, model

    from tunevlseg_torch.models.clip.config import CLIPTextConfig, CLIPVisionConfig
    depth = {"num_layers": TS_EXPORT_TOWER_LAYERS}
    model, _ = build_trans_segmentor(
        ts_config(text=CLIPTextConfig(**depth), vision=CLIPVisionConfig(**depth)),
        dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model)
    params = dict(model.state_dict())
    request = make_request(torch.Generator().manual_seed(82), TS_BATCH, TS_BATCH, IMG)
    by_path["export_trans_seg"], numbers["trans_seg b32"] = exported_vs_eager(
        fa, "export trans_seg b32", task, params, request, TS_EXPORT_SERVE,
        ("biased_attn_fwd", "flash_attn_fwd", "layer_norm"), root / "ts_b32")
    del task, params, model

    params = dict(tss_task.model.state_dict())
    by_path["export_trans_seg_siglip"], numbers["trans_seg_siglip b32"] = \
        exported_vs_eager(fa, "export trans_seg_siglip b32", tss_task, params,
                          tss_request, TSS_SERVE,
                          ("biased_attn_fwd", "flash_attn_fwd", "layer_norm"),
                          root / "tss_b32",
                          profile=profile)
    shutil.rmtree(root)
    return by_path, numbers


# --- Slice G3: gradient accumulation and per-layer remat -----------------------

# remat reruns each rematted layer's forward in the backward: a
# TransformerSegmentor step runs K1 again in its 12 vision layers and 4
# decoder self-attentions and K3 in its 12 text layers and 4
# cross-attentions; K2 stays one a K1 of the first forward. DenseCLIP's one
# checkpoint of the loss reruns the whole forward: the pool's K1, the text
# encoder's 12 and the context decoder's 3 K3
TS_REMAT_STEP = (32, 16, 32, 0, 0, 0) + NO_VARIANTS
DC_REMAT_STEP = (2, 1, 30, 0, 0, 0) + NO_VARIANTS
# `configs/model/trans_seg.yaml`'s decoder dropout, so that masks are drawn
# inside the rematted decoder layers
TS_DROPOUT = 0.1
# remat on against off from the same weights and masks: the first forward is
# the same computation, so its loss is bit-identical; the backward adds up
# the same products (held to the kernel path's common bounds on the first
# step's gradients, and the later losses to LOSS_TOL). The DenseCLIP step's
# BatchNorm statistics (f32, from bf16 activations): 1e-3 of each tensor's
# largest entry
REMAT_STATS_REL_TOL = 1e-3


def trainable_snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def restore_trainable(model, start: dict) -> None:
    import torch
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in start.items():
            params[name].copy_(value)


def steps_from(fa, task, start: dict, batches: list, label: str, per_step: tuple,
               leaves: tuple = ()) -> dict:
    """Train steps on `batches` from the weights `start` with a fresh
    optimizer (its moments made in the first step): the launch counts set to
    0 before and read after, each step's launches held to `per_step`, its
    host ms (the device drained), the peak device memory of the run and
    above what was allocated at its start, the losses, the first step's
    gradients of `leaves`, the weights after (on the host), the state's
    buffers."""
    import torch
    restore_trainable(task.model, start)
    task.model.zero_grad(set_to_none=True)     # the last run's gradients
    state = task.init()
    named = dict(task.model.named_parameters())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    times, losses, grads = [], [], {}
    for i, batch in enumerate(batches):
        before = counts(fa)
        t = time.perf_counter()
        state, metrics = task.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(metrics["loss"].item())
        grew = minus(counts(fa), before)
        if grew != per_step:
            fail(f"{label}: a step launched {COUNTED} = {grew}, expected {per_step}")
        if i == 0:
            grads = {n: named[n].grad.detach().float().clone() for n in leaves}
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"{label}: non-finite loss in {losses}")
    run = {"losses": losses, "ms": statistics.median(times) * 1e3, "peak": peak,
           "above": peak - resident, "grads": grads, "launches": launches,
           # on the host, so that the next run's peak does not hold them
           "weights": {n: p.detach().to("cpu", copy=True) for n, p in named.items()
                       if p.requires_grad},
           "model_state": {k: v.clone() for k, v in state.model_state.items()}}
    print(f"{label}: {len(batches)} steps, ms a step (host clock, device drained) "
          + " ".join(f"{x * 1e3:.3f}" for x in times)
          + f", median {run['ms']:.3f}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB; {run['above'] / 2**30:.3f} GiB above the "
          f"{resident / 2**30:.3f} GiB resident at the start); launches "
          f"{launches} ({per_step} a step); losses "
          + " ".join(f"{x:.6f}" for x in losses))
    del state
    return run


def remat_against_plain(label: str, plain: dict, remat: dict, lr: float,
                        steps: int, witness: float | None = None) -> None:
    """The rematted run against the plain one from the same weights and
    masks: the first loss bit-identical (or, where `witness` is the first
    loss of a second plain run, within LOSS_TOL, printed beside how far the
    two plain runs are apart), the later ones within LOSS_TOL, the first
    step's gradients within the kernel path's common bounds, the weights
    after the steps within twice Adam's travel (printed: how many leaves
    are bit-identical, the first that is not)."""
    import torch
    first = remat["losses"][0] - plain["losses"][0]
    if witness is None and first != 0:
        fail(f"{label}: the first step's loss {remat['losses'][0]!r} is not the "
             f"plain step's {plain['losses'][0]!r}")
    if witness is not None:
        print(f"{label}: first loss {remat['losses'][0]!r} with remat, "
              f"{plain['losses'][0]!r} plain, {witness!r} in a second plain run "
              f"(remat - plain {first:.3g}, plain - plain "
              f"{witness - plain['losses'][0]:.3g}; bound {LOSS_TOL})")
    later = max(abs(a - b) for a, b in zip(remat["losses"], plain["losses"]))
    worst_cos, worst_rel = worst_leaf(remat["grads"], plain["grads"])
    same = [n for n, w in plain["weights"].items() if torch.equal(w, remat["weights"][n])]
    differ = [n for n in plain["weights"] if n not in same]
    top = max(((remat["weights"][n] - plain["weights"][n]).abs().max().item(), n)
              for n in differ) if differ else (0.0, "")
    travel = steps * lr * 1.05
    print(f"{label}: remat on vs off, first loss "
          + ("bit-identical " if first == 0 else f"apart by {first:.3g} ")
          + f"({plain['losses'][0]!r}); losses within {later:.3g} (bound "
          f"{LOSS_TOL}); first step's gradients: least cosine {worst_cos[0]:.6f} "
          f"({worst_cos[1]}; at least {GRAD_COS_MIN}), largest max abs diff "
          f"{worst_rel[0]:.4g} of its leaf's largest entry ({worst_rel[1]}; bound "
          f"{GRAD_REL_TOL}); weights after {steps} steps: {len(same)} of "
          f"{len(plain['weights'])} leaves bit-identical, the first that is not "
          f"{differ[0] if differ else 'none'}, the largest difference "
          f"{top[0]:.4g} ({top[1] or 'none'}; bound twice Adam's travel "
          f"{2 * travel:.4g})")
    if not (later <= LOSS_TOL and worst_cos[0] >= GRAD_COS_MIN
            and worst_rel[0] <= GRAD_REL_TOL and top[0] <= 2 * travel):
        fail(f"{label}: remat on and off disagree beyond the stated bounds")


def phase_accumulate_remat(fa, profile: bool) -> dict:
    """Phase 27: per-layer remat and gradient accumulation at full width.
    (a) `bench.py`'s trans_seg row (b32, 352^2, full fine-tune) with the
    config's decoder dropout 0.1: 3 steps with remat off and 3 with remat
    on from the same weights and seed (peak memory, step ms, launches a
    step; `remat_against_plain`). (b) The flagship, CLIPSeg CoOp b64 dedup
    352^2: one b64 step against two b32 micro-steps with
    `accumulate_grad_batches=2` from the same weights (the first micro-step
    moves nothing; the gradient each update applies and the weights after
    it). (c) DenseCLIP RN50 512^2 b16 `bn_train`: 3 steps with remat off
    and on (the monolithic checkpoint of the loss; peak memory, step ms, the
    BatchNorm statistics in the state against the plain step's). Returns
    {path: counts}."""
    import torch

    from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig
    from tunevlseg_torch.models.presets import build_denseclip, build_trans_segmentor
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
    from tunevlseg_torch.training.task import SegmentationTask

    by_path = {}
    t0 = time.perf_counter()
    model, spec = build_trans_segmentor(ts_config(decoder_dropout=TS_DROPOUT),
                                        dtype=torch.bfloat16, device="cuda", seed=0)
    plain = SegmentationTask(model, spec, learning_rate=2e-4)
    rematted = SegmentationTask(model, spec, learning_rate=2e-4, remat=True)
    plain.init()
    start = trainable_snapshot(model)
    batches = [make_train_batch(TS_BATCH, text_dedup=0, seed=91, img=IMG)] * 3
    print(f"remat trans_seg: bench's trans_seg row with decoder dropout "
          f"{TS_DROPOUT}, b{TS_BATCH} {IMG}^2 full fine-tune, built in "
          f"{time.perf_counter() - t0:.1f} s")
    leaves = ("vision_model.layers.0.self_attn.q_proj.weight",
              "text_model.layers.0.self_attn.q_proj.weight",
              "decoder_layers.0.multihead_attn.q_proj.weight",
              "decoder_layers.3.self_attn.out_proj.weight",
              "upsampler.out_conv.weight")
    runs = {}
    for key, task, per_step in (("plain", plain, TS_STEP),
                                ("remat", rematted, TS_REMAT_STEP)):
        runs[key] = steps_from(fa, task, start, batches, f"remat trans_seg {key}",
                               per_step, leaves)
    by_path["train_trans_seg_dropout"] = runs["plain"]["launches"]
    by_path["train_trans_seg_remat"] = runs["remat"]["launches"]
    remat_against_plain("remat trans_seg", runs["plain"], runs["remat"], 2e-4, 3)
    print(f"remat trans_seg: peak {runs['plain']['peak'] / 2**30:.3f} -> "
          f"{runs['remat']['peak'] / 2**30:.3f} GiB "
          f"({runs['remat']['peak'] / runs['plain']['peak']:.3f}x), step "
          f"{runs['plain']['ms']:.3f} -> {runs['remat']['ms']:.3f} ms "
          f"({runs['remat']['ms'] / runs['plain']['ms']:.3f}x)")
    if profile:
        for key, t in (("dropout", plain), ("dropout remat", rematted)):
            profile_step(f"trans_seg {key}", t, t.init(), batches[0])
    del model, plain, rematted, start, runs, batches

    # (b) the flagship: one b64 step against two b32 micro-steps
    task, _ = build_task("CLIPSeg rd64", "coop", 2e-4)
    model = task.model
    accumulating = SegmentationTask(model, task.freeze_spec, learning_rate=2e-4,
                                    accumulate_grad_batches=2)
    batch = make_train_batch(BATCH, text_dedup=1, seed=3)
    # the per-sample tensors split in two; the one prompt row stays whole
    halves = [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2] if v.shape[0] == BATCH
               else v for k, v in batch.items()} for i in range(2)]
    start = trainable_snapshot(model)
    applied = {}
    for key, t, micro in (("b64", task, [batch]), ("2 x b32", accumulating, halves)):
        restore_trainable(model, start)
        state = t.init()
        seen = []
        names = {id(p): n for n, p in model.named_parameters()}
        state.optimizer.optimizer.register_step_pre_hook(lambda o, a, k: seen.append(
            {names[id(p)]: p.grad.float().clone() for g in o.param_groups
             for p in g["params"] if p.grad is not None}))
        reset_counts(fa)
        for i, b in enumerate(micro):
            before = counts(fa)
            state, metrics = t.train_step(state, b)
            grew = minus(counts(fa), before)
            if grew != CLIPSEG_COOP_STEP:
                fail(f"accumulate coop {key}: a micro-step launched {grew}, "
                     f"expected {CLIPSEG_COOP_STEP}")
            if i < len(micro) - 1 and any(
                    not torch.equal(p, start[n]) for n, p in trainable_snapshot(model).items()):
                fail(f"accumulate coop {key}: a micro-step inside the window moved "
                     "the weights")
        torch.cuda.synchronize()
        if len(seen) != 1:
            fail(f"accumulate coop {key}: {len(seen)} updates, expected 1")
        applied[key] = (seen[0], trainable_snapshot(model), counts(fa))
        del state
    by_path["train_coop_accumulate"] = applied["2 x b32"][2]
    worst_cos, worst_rel = worst_leaf(applied["2 x b32"][0], applied["b64"][0])
    wdiff = max((applied["2 x b32"][1][n] - w).abs().max().item()
                for n, w in applied["b64"][1].items())
    print(f"accumulate coop: one b64 step against two b32 micro-steps "
          f"(accumulate_grad_batches=2) from the same weights: the gradient each "
          f"update applied, least cosine {worst_cos[0]:.6f} ({worst_cos[1]}; at "
          f"least {GRAD_COS_MIN}), largest max abs diff {worst_rel[0]:.4g} of its "
          f"leaf's largest entry (bound {GRAD_REL_TOL}); trainable weights after "
          f"the update: largest difference {wdiff:.4g} (bound twice Adam's "
          f"step {2 * 2e-4 * 1.05:.4g}); launches {applied['2 x b32'][2]}")
    if not (worst_cos[0] >= GRAD_COS_MIN and worst_rel[0] <= GRAD_REL_TOL
            and wdiff <= 2 * 2e-4 * 1.05):
        fail("accumulate coop: two micro-steps and one full step disagree beyond "
             "the stated bounds")
    del task, accumulating, model, batch, halves, start, applied

    # (c) DenseCLIP bn_train under the one checkpoint of its loss
    gen = torch.Generator().manual_seed(71)
    t0 = time.perf_counter()
    model = build_denseclip(DenseCLIPConfig(), denseclip_class_ids(gen), bn_train=True,
                            dtype=torch.bfloat16, device="cuda", seed=0)
    kw = dict(learning_rate=1e-4, weight_decay=1e-4, warmup_iters=2,
              image_stats=IMAGENET_STATS)
    plain, rematted = DenseCLIPTask(model, **kw), DenseCLIPTask(model, remat=True, **kw)
    plain.init()
    start = trainable_snapshot(model)
    batches = [denseclip_train_batch(gen)] * 3
    print(f"remat denseclip: RN50 512^2 b{DC_BATCH} bn_train, built in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for key, task, per_step in (("plain", plain, DC_STEP),
                                ("remat", rematted, DC_REMAT_STEP)):
        runs[key] = steps_from(fa, task, start, batches, f"remat denseclip {key}",
                               per_step, ("contexts", "decode_head.cls_seg.weight"))
    by_path["train_denseclip_bn_train"] = runs["plain"]["launches"]
    by_path["train_denseclip_remat"] = runs["remat"]["launches"]
    # a witness: the first plain step once more, for how far two plain runs
    # of the same step are apart
    witness = steps_from(fa, plain, start, batches[:1], "remat denseclip plain again",
                         DC_STEP)["losses"][0]
    remat_against_plain("remat denseclip", runs["plain"], runs["remat"], 1e-4, 3,
                        witness)
    stats_same, stats_worst = 0, (0.0, "")
    for name, want in runs["plain"]["model_state"].items():
        got = runs["remat"]["model_state"][name]
        stats_same += int(torch.equal(got, want))
        rel = ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
        stats_worst = max(stats_worst, (rel, name))
    n_stats = len(runs["plain"]["model_state"])
    print(f"remat denseclip: BatchNorm statistics in the state after 3 steps, remat "
          f"against plain: {stats_same} of {n_stats} tensors bit-identical, the "
          f"largest difference {stats_worst[0]:.4g} of its tensor's largest entry "
          f"({stats_worst[1] or 'none'}; bound {REMAT_STATS_REL_TOL}); peak "
          f"{runs['plain']['peak'] / 2**30:.3f} -> {runs['remat']['peak'] / 2**30:.3f} "
          f"GiB ({runs['remat']['peak'] / runs['plain']['peak']:.3f}x), step "
          f"{runs['plain']['ms']:.3f} -> {runs['remat']['ms']:.3f} ms "
          f"({runs['remat']['ms'] / runs['plain']['ms']:.3f}x)")
    if not n_stats or stats_worst[0] > REMAT_STATS_REL_TOL:
        fail("remat denseclip: the BatchNorm statistics of the rematted steps "
             "differ from the plain steps' beyond the stated bound")
    if profile:
        profile_step("denseclip remat", rematted, rematted.init(), batches[0])
    return by_path


# --- Slice G4: data parallel ---------------------------------------------------

# a child process of phase 28 that has not finished in this time fails the
# phase (and is stopped)
DP_TIMEOUT_S = 300
# (b): a rank's b32 gradient is the same arithmetic as a b32 micro-step here;
# DDP's mean (g0 + g1) / 2 and the window's running mean g0 + (g1 - g0) / 2
# round differently, in f32: 1e-5 of each leaf's largest entry
DDP2_GRAD_REL_TOL = 1e-5
# CRIS flat e2e (bf16, K4) over two ranks against one b16 step: the
# backbone's, FPN's and projector's batch statistics are summed over the
# ranks in f32 (two passes) where one device's BatchNorm takes them in one;
# the running statistics in the state to 1e-3 of each tensor's largest
# entry, or DP_WITNESS_FACTOR times the witness's gap (the same b16 step on
# its rows reversed) where that is wider. Its gradient is not held: the
# random bf16 model under train-mode BatchNorm turns summation order alone
# into a gap of 0.27 of a leaf's largest entry (the witness), so a bound
# there could not tell a mean from a sum; the f32 case holds it
DDP2_STATS_REL_TOL = 1e-3
DP_WITNESS_FACTOR = 4
# CRIS e2e in f32 (TF32 off; no kernel takes f32, so the path is plain) over
# two ranks against one b16 step, where summation order does not blow up:
# the gradient the update applied, each leaf against max(its largest entry,
# 1e-3 of any leaf's), within 5e-2, and a cosine of at least 0.9999 over
# the leaves above that floor. Summation order alone puts one leaf 1.5e-2
# off (neck.f2_cat.conv.weight, whose gradient cancels under its
# BatchNorm: the witness and DDP alike, on the H100); a sum over the ranks
# where DDP takes the mean is 1.0 off; a BatchNorm backward without its
# all-reduce misses the other rank's share of every statistic's gradient.
# The running statistics to 1e-4 of each tensor's largest entry, the loss
# (the mean over the ranks) to 1e-5 of itself
DP_F32_GRAD_REL_TOL = 5e-2
DP_F32_COS_MIN = 0.9999
DP_F32_STATS_REL_TOL = 1e-4
DP_F32_LOSS_REL_TOL = 1e-5
# the pseudo losses on the card against the CPU, f32, sums in another order
PSEUDO_LOSS_REL_TOL = 1e-4
DP_STEPS = 3


def dp_spawn(job: str, world: int, backend: str):
    """Start `world` ranks of `dp_rank(job)` in child processes that meet
    through a file in a fresh temporary directory; returns (context, the
    directory)."""
    import tempfile

    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    ctx = mp.start_processes(dp_rank, args=(world, workdir, job, backend),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, workdir


def dp_collect(ctx, workdir: str, job: str, label: str) -> list:
    """Wait for the ranks of `dp_spawn` (at most DP_TIMEOUT_S; past it they
    are stopped and the phase fails) and return each rank's results."""
    import shutil
    from pathlib import Path

    import torch
    deadline = time.perf_counter() + DP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"{label}: the ranks did not finish in {DP_TIMEOUT_S} s")
    except Exception as e:     # a rank raised: the others are stopped
        fail(f"{label}: a rank failed: {e}")
    out = [torch.load(Path(workdir) / f"{job}.rank{r}.pt", weights_only=False)
           for r in range(len(ctx.processes))]
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def dp_rank(rank: int, world: int, workdir: str, job: str, backend: str) -> None:
    """One rank of phase 28, in a child process: join the group on cuda:0
    (every rank here shares the one card), run the job, save its results."""
    import os
    from pathlib import Path

    import torch
    from tunevlseg_torch.ops import flash_attention as fa
    from tunevlseg_torch.parallel import distributed
    os.environ["LOCAL_RANK"] = "0"
    distributed.initialize_distributed(
        {"coordinator_address": f"file://{workdir}/store", "num_processes": world,
         "process_id": rank}, "cuda", backend=backend)
    try:
        out = DP_JOBS[job](fa)
        torch.save(out, Path(workdir) / f"{job}.rank{rank}.pt")
    finally:
        distributed.destroy()


def dp_rows(batch: dict, rank: int, world: int) -> dict:
    """A rank's contiguous rows of a global batch; the prompt-dedup rows stay
    whole."""
    n = batch["image"].shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] if v.shape[0] == batch["image"].shape[0]
            else v for k, v in batch.items()}


def applied_gradients(state, model) -> list:
    """The gradient each update applies, by name, whole and on the host."""
    from tunevlseg_torch.parallel.data_parallel import full_tensor
    seen = []
    names = {id(p): n for n, p in model.named_parameters()}
    state.optimizer.optimizer.register_step_pre_hook(lambda o, a, k: seen.append(
        {names[id(p)]: full_tensor(p.grad).float().cpu() for g in o.param_groups
         for p in g["params"] if p.grad is not None}))
    return seen


def dp_job_world1(fa) -> dict:
    """(a) The flagship over NCCL at world size 1: DP_STEPS steps plain, under
    DDP and under fully_shard from the same weights."""
    import torch
    from tunevlseg_torch.parallel import distributed
    from tunevlseg_torch.parallel.data_parallel import full_tensor, is_dtensor
    from tunevlseg_torch.training.task import SegmentationTask
    print(f"dp world 1: rank {distributed.rank()} of {distributed.world_size()}, "
          f"backend {torch.distributed.get_backend()}, {torch.cuda.get_device_name(0)}")
    task, _ = build_task("CLIPSeg rd64", "coop", 2e-4)
    model = task.model
    batches = [make_train_batch(BATCH, text_dedup=1, seed=s) for s in (3, 4, 5)]
    start = trainable_snapshot(model)
    runs = {"plain": steps_from(fa, task, start, batches, "dp world 1 plain",
                                CLIPSEG_COOP_STEP)}
    ddp = SegmentationTask(model, task.freeze_spec, learning_rate=2e-4)
    ddp.init()
    ddp.compile_steps()
    runs["ddp"] = steps_from(fa, ddp, start, batches, "dp world 1 ddp",
                             CLIPSEG_COOP_STEP)
    restore_trainable(model, start)
    model.zero_grad(set_to_none=True)
    fs = SegmentationTask(model, task.freeze_spec, learning_rate=2e-4)
    state = fs.state_fsdp_shardings(fs.init())
    fs.compile_steps(fsdp=True)
    sharded = sum(is_dtensor(p) for p in model.parameters())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    losses, times = [], []
    for b in batches:
        before = counts(fa)
        t = time.perf_counter()
        state, metrics = fs.train_step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(metrics["loss"].item())
        if minus(counts(fa), before) != CLIPSEG_COOP_STEP:
            fail(f"dp world 1 fsdp: a step launched {minus(counts(fa), before)}")
    runs["fsdp"] = {"losses": losses, "ms": statistics.median(times) * 1e3,
                    "peak": torch.cuda.max_memory_allocated(),
                    "above": torch.cuda.max_memory_allocated() - resident,
                    "launches": counts(fa),
                    "weights": {n: full_tensor(p).detach().cpu()
                                for n, p in model.named_parameters() if p.requires_grad},
                    "sharded": sharded}
    for run in runs.values():
        run.pop("grads", None)
        run.pop("model_state", None)
        # the leaves the steps moved from where they started
        run["moved"] = sum(not torch.equal(w, start[n].cpu())
                           for n, w in run["weights"].items())
    return runs


def dp_job_two_ranks(fa) -> dict:
    """(b) Two ranks on the one card over gloo: the flagship at b32 a rank,
    CRIS flat e2e at b8 a rank and CRIS e2e in f32 at b8 a rank, each one
    DDP step; the ranks' dropout masks; whether FSDP2's collectives run on
    gloo with CUDA tensors."""
    import torch
    import torch.distributed as dist
    from tunevlseg_torch.parallel import distributed
    rank, world = distributed.rank(), distributed.world_size()
    out = {}
    try:
        whole = torch.empty(2 * world, device="cuda")
        dist.all_gather_into_tensor(whole, torch.ones(2, device="cuda"))
        part = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(part, torch.ones(2 * world, device="cuda"))
        out["fsdp_collectives"] = "run"
    except Exception as e:        # the finding is printed, not a failure
        out["fsdp_collectives"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    # the f32 case's convolutions in f32, not TF32 (this process is the rank's)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for key, build, batch, per_step in dp_two_rank_cases():
        task, _ = build()
        state = task.init()
        task.compile_steps()
        applied = applied_gradients(state, task.model)
        reset_counts(fa)
        state, metrics = task.train_step(state, dp_rows(batch, rank, world))
        torch.cuda.synchronize()
        if counts(fa) != per_step:
            fail(f"dp two ranks {key}: rank {rank} launched {counts(fa)}, expected "
                 f"{per_step}")
        out[key] = {"applied": applied[0], "loss": metrics["loss"].item(),
                    "launches": counts(fa),
                    "model_state": {k: v.float().cpu()
                                    for k, v in state.model_state.items()},
                    "find_unused": task.ddp.find_unused_parameters,
                    "masks": torch.rand(64, generator=task.dropout_generator(0),
                                        device="cuda").cpu()}
        del task, state
        torch.cuda.empty_cache()
    return out


def dp_two_rank_cases():
    """(label, build function, global batch, launches a rank's step) of (b).
    The f32 CRIS launches no kernel (K1-K4 take bf16): it holds DDP's
    gradient where summation order does not blow up. The flagship runs with
    the per-sample dice and with the dice over the whole batch."""
    import dataclasses

    import torch
    from tunevlseg_torch.models.presets import cris_rn50_config
    cris_cfg = dataclasses.replace(cris_rn50_config(CRIS_IMG), dropout=0.0)
    cris_batch = make_train_batch(E2E_BATCH, text_dedup=0, seed=8, img=CRIS_IMG,
                                  pad_id=0)
    coop_batch = make_train_batch(BATCH, text_dedup=1, seed=3)
    return (
        ("coop", lambda: build_task("CLIPSeg rd64", "coop", 2e-4), coop_batch,
         CLIPSEG_COOP_STEP),
        ("coop_batch_dice", lambda: build_task(
            "CLIPSeg rd64", "coop", 2e-4,
            task_kwargs={"loss_kwargs": {"batch": True}}), coop_batch,
         CLIPSEG_COOP_STEP),
        ("cris_flat_e2e", lambda: build_task(
            "CRIS RN50", "e2e", 3e-6,
            build_kwargs={"freeze_encoder": False, "layout": "flat",
                          "config": cris_cfg},
            task_kwargs={"mutable_collections": ("batch_stats",)}),
         cris_batch, CRIS_E2E_FLAT_STEP),
        ("cris_e2e_f32", lambda: build_task(
            "CRIS RN50", "e2e", 3e-6,
            build_kwargs={"freeze_encoder": False, "config": cris_cfg,
                          "dtype": torch.float32},
            task_kwargs={"mutable_collections": ("batch_stats",)}),
         cris_batch, (0,) * len(CRIS_E2E_FLAT_STEP)))


DP_JOBS = {"world1": dp_job_world1, "two_ranks": dp_job_two_ranks}


def batch_dice_hold(got: dict, ref: dict, chunked: dict) -> None:
    """(b)'s dice over the whole batch: DDP's loss (the mean over the ranks)
    and the gradient its update applied against the ranks' arithmetic in
    one process (`chunked`; the gradient within DDP2_GRAD_REL_TOL, as the
    CoOp pair's, the loss within DP_F32_LOSS_REL_TOL of itself), and
    against one b64 step (`ref`) within DP_WITNESS_FACTOR times the gap
    between `chunked` and that step (the batch's two b32 forwards against
    one b64 forward), or those floors where they are wider. A rank's dice
    over its own rows, or a sums' gradient not summed over the ranks, is
    off by a tenth and more."""
    (ccos, _), (crel, crel_leaf) = worst_leaf(got["applied"], chunked["applied"])
    (cos, cos_leaf), (rel, rel_leaf) = worst_leaf(got["applied"], ref["applied"])
    (wcos, _), (wrel, _) = worst_leaf(chunked["applied"], ref["applied"])
    closs = abs(got["loss"] - chunked["loss"]) / abs(chunked["loss"])
    loss_gap, wloss = abs(got["loss"] - ref["loss"]), abs(chunked["loss"] - ref["loss"])
    loss_cap = max(DP_F32_LOSS_REL_TOL * abs(ref["loss"]), DP_WITNESS_FACTOR * wloss)
    rel_cap = max(DDP2_GRAD_REL_TOL, DP_WITNESS_FACTOR * wrel)
    cos_cap = min(DP_F32_COS_MIN, 1 - DP_WITNESS_FACTOR * (1 - wcos))
    print(f"dp two ranks coop_batch_dice: the dice's three sums over both ranks' "
          f"rows; against the ranks' arithmetic in one process (two b32 "
          f"forwards, one loss): loss {closs:.3g} of itself off (bound "
          f"{DP_F32_LOSS_REL_TOL}), gradient least cosine {ccos:.7f}, largest "
          f"max abs diff {crel:.4g} of its leaf's largest entry ({crel_leaf}; "
          f"bound {DDP2_GRAD_REL_TOL}); against one b64 step: loss "
          f"{got['loss']:.6f} / {ref['loss']:.6f}, gap {loss_gap:.4g} (bound "
          f"{loss_cap:.4g}; the witness {wloss:.4g}), gradient least cosine "
          f"{cos:.7f} ({cos_leaf}; at least {cos_cap:.7f}), largest max abs diff "
          f"{rel:.4g} ({rel_leaf}; bound {rel_cap:.4g}); the witness {wcos:.7f}, "
          f"{wrel:.4g}")
    if not (closs <= DP_F32_LOSS_REL_TOL and crel <= DDP2_GRAD_REL_TOL
            and loss_gap <= loss_cap and rel <= rel_cap and cos >= cos_cap):
        fail("dp two ranks coop_batch_dice: DDP's step is not the dice over the "
             "whole batch")


def dp_references(fa) -> dict:
    """(b)'s references in this process, with no process group: the flagship
    as two accumulated b32 micro-steps of the ranks' rows, each CRIS e2e as
    one b16 step, and as a witness the same b16 step on the rows in reverse
    order (the same samples: it differs from the first by summation order
    alone); the flagship with the dice over the whole batch as one b64 step,
    and as its witness the same loss and gradient from the ranks' two b32
    forwards (`chunked_batch_dice`)."""
    import torch
    from tunevlseg_torch.training.task import SegmentationTask
    refs = {}
    # the f32 case's convolutions in f32, as in the ranks
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for key, build, batch, per_step in dp_two_rank_cases():
        task, state = build()
        start = trainable_snapshot(task.model)
        if key == "coop":
            task = SegmentationTask(task.model, task.freeze_spec, learning_rate=2e-4,
                                    accumulate_grad_batches=2)
            runs = {key: [dp_rows(batch, r, 2) for r in range(2)]}
        elif key == "coop_batch_dice":
            refs[f"{key} chunked"] = chunked_batch_dice(task, start, batch, 2)
            runs = {key: [batch]}
        else:
            flipped = {k: v.flip(0) if v.shape[0] == E2E_BATCH else v
                       for k, v in batch.items()}
            runs = {key: [batch], f"{key} reversed": [flipped]}
        for label, micro in runs.items():
            restore_trainable(task.model, start)
            state = task.init()
            applied = applied_gradients(state, task.model)
            for b in micro:
                state, metrics = task.train_step(state, b)
            refs[label] = {"applied": applied[0], "loss": metrics["loss"].item(),
                           "model_state": {k: v.float().cpu()
                                           for k, v in state.model_state.items()}}
        del task, state
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return refs


def chunked_batch_dice(task, start: dict, batch: dict, ranks: int) -> dict:
    """The loss and gradient of one step of `task` (the dice over the whole
    batch) from the weights `start`, with the forward run on each of
    `ranks` blocks of rows apart and the loss on their logits together: one
    process's arithmetic of the ranks' step. {"applied": {leaf: f32
    gradient}, "loss": float}."""
    import torch
    restore_trainable(task.model, start)
    task.model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        logits = torch.cat([task._loss(dp_rows(batch, r, ranks))[1]
                            for r in range(ranks)])
        loss = task.loss_fn(logits, batch["mask"], **task.loss_kwargs)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in task.model.named_parameters()
             if p.requires_grad and p.grad is not None}
    task.model.zero_grad(set_to_none=True)
    return {"applied": grads, "loss": loss.item(), "model_state": {}}


def gradient_gap(got: dict, want: dict) -> tuple:
    """((least cosine, leaf), (largest max abs diff over max(the leaf's
    largest |entry|, 1e-3 of any leaf's), leaf)) of `got` against `want`;
    the cosine over the leaves whose gradient is at least 1e-3 of the
    largest (a BatchNorm that a train-mode BatchNorm follows, or a bias under
    one, has a gradient that is zero in exact arithmetic: rounding noise
    there, as tests/test_torch_cris.py's e2e rule says)."""
    import torch
    overall = max(w.abs().max().item() for w in want.values())
    worst_cos, worst_rel = (1.0, ""), (0.0, "")
    for name, w in want.items():
        top = w.abs().max().item()
        a = got[name]
        rel = (a - w).abs().max().item() / max(top, 1e-3 * overall)
        worst_rel = max(worst_rel, (rel, name))
        if top >= 1e-3 * overall:
            cos = torch.nn.functional.cosine_similarity(
                a.flatten(), w.flatten(), dim=0).item()
            worst_cos = min(worst_cos, (cos, name))
    return worst_cos, worst_rel


def dp_two_ranks_hold(fa) -> dict:
    """Phase 28 (b): the two-rank cases on the one card against their
    references in this process. Returns {path: counts} (rank 0's)."""
    import torch
    by_path = {}
    # (b) two ranks on the one card over gloo; the references here first
    refs = dp_references(fa)
    ctx, workdir = dp_spawn("two_ranks", 2, "gloo")
    ranks = dp_collect(ctx, workdir, "two_ranks", "dp two ranks")
    for key in ("coop", "coop_batch_dice", "cris_flat_e2e", "cris_e2e_f32"):
        r0, r1 = ranks[0][key], ranks[1][key]
        ref = refs[key]
        worst_cos, worst_rel = worst_leaf(r0["applied"], ref["applied"])
        ranks_same = all(torch.equal(r0["applied"][n], r1["applied"][n])
                         for n in r0["applied"])
        masks_differ = not torch.equal(r0["masks"], r1["masks"])
        against = {"coop": "two accumulated b32 micro-steps",
                   "coop_batch_dice": "one b64 step"}.get(key, "one b16 step")
        print(f"dp two ranks {key}: gloo, both ranks on cuda:0, the gradient the "
              f"update applied against {against} "
              f"in one process: least cosine {worst_cos[0]:.7f} ({worst_cos[1]}), "
              f"largest max abs diff {worst_rel[0]:.4g} of its leaf's largest entry "
              f"({worst_rel[1]}"
              + (f"; bound {DDP2_GRAD_REL_TOL}" if key == "coop" else "")
              + f"); the two ranks {'bit-identical' if ranks_same else 'DIFFERENT'}; "
              f"loss (the mean over the ranks) {r0['loss']:.6f} / {r1['loss']:.6f}, "
              f"reference {ref['loss']:.6f}; launches a rank {r0['launches']}; "
              f"find_unused_parameters {r0['find_unused']}; dropout masks of the "
              f"two ranks {'differ' if masks_differ else 'are THE SAME'}")
        if not ranks_same or not masks_differ:
            fail(f"dp two ranks {key}: the ranks' updates differ, or their dropout "
                 "masks are the same")
        if key == "coop" and worst_rel[0] > DDP2_GRAD_REL_TOL:
            fail(f"dp two ranks {key}: DDP's gradient is not the accumulated one")
        if key == "coop_batch_dice":
            batch_dice_hold(r0, ref, refs[f"{key} chunked"])
        elif key != "coop":
            # each leaf against max(its largest entry, 1e-3 of any leaf's): a
            # bias under a train-mode BatchNorm has a gradient that is zero in
            # exact arithmetic (tests/test_torch_cris.py's e2e rule); the
            # witness is the b16 step on its rows reversed
            witness = refs[f"{key} reversed"]
            gap = gradient_gap(r0["applied"], ref["applied"])
            wgap = gradient_gap(witness["applied"], ref["applied"])
            f32 = key == "cris_e2e_f32"
            loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
            print(f"dp two ranks {key}: by the e2e rule, DDP against one b16 step "
                  f"least cosine {gap[0][0]:.7f} ({gap[0][1]}), largest diff "
                  f"{gap[1][0]:.4g} ({gap[1][1]}); the witness: {wgap[0][0]:.7f} "
                  f"({wgap[0][1]}), {wgap[1][0]:.4g} ({wgap[1][1]}), its loss "
                  f"{witness['loss']:.6f}; the loss {loss_rel:.3g} of itself off; "
                  + (f"held: cosine at least {DP_F32_COS_MIN}, diff at most "
                     f"{DP_F32_GRAD_REL_TOL}, loss at most {DP_F32_LOSS_REL_TOL}"
                     if f32 else "not held (bf16 under train-mode BatchNorm; the "
                     "f32 case holds the gradient), the loss within "
                     f"{LOSS_TOL}"))
            if f32 and not (gap[0][0] >= DP_F32_COS_MIN
                            and gap[1][0] <= DP_F32_GRAD_REL_TOL
                            and loss_rel <= DP_F32_LOSS_REL_TOL):
                fail(f"dp two ranks {key}: DDP's step is not one b16 step's")
            if not f32 and abs(r0["loss"] - ref["loss"]) > LOSS_TOL:
                fail(f"dp two ranks {key}: the loss is not one b16 step's")
        if ref["model_state"]:
            def stats_gap(got):
                return max(((got[n] - w).abs().max()
                            / w.abs().max().clamp(min=1e-30)).item()
                           for n, w in ref["model_state"].items())
            stats = stats_gap(r0["model_state"])
            wstats = stats_gap(refs[f"{key} reversed"]["model_state"])
            cap = (DP_F32_STATS_REL_TOL if key == "cris_e2e_f32"
                   else max(DDP2_STATS_REL_TOL, DP_WITNESS_FACTOR * wstats))
            moved = sum(not torch.equal(r0["model_state"][n], r1["model_state"][n])
                        for n in ref["model_state"])
            print(f"dp two ranks {key}: the BatchNorm statistics in the state "
                  f"(the global batch's) against one b16 step's: largest "
                  f"difference {stats:.4g} of a tensor's largest entry (the "
                  f"witness {wstats:.4g}; bound {cap:.4g}; a rank's own statistics "
                  f"would be off by tenths); {moved} tensors differ between the ranks")
            if stats > cap or moved:
                fail(f"dp two ranks {key}: the statistics are not the global batch's")
        if key != "cris_e2e_f32":     # the f32 path launches no kernel
            by_path[f"train_ddp2_{key}"] = r0["launches"]
    # FSDP over these two ranks: the bare collectives run, but a fully_shard
    # step over gloo with CUDA tensors killed a rank with SIGSEGV (a
    # diagnostic call); FSDP's two-rank check stays on the CPU
    # (tests/test_torch_distributed.py), and (a) carries FSDP on the card
    print(f"dp two ranks: FSDP2's all_gather_into_tensor and reduce_scatter_tensor "
          f"on gloo with CUDA tensors: {ranks[0]['fsdp_collectives']}; a "
          "fully_shard step over them is not run here (it killed a rank with "
          "SIGSEGV); FSDP's two-rank check is the CPU tests'")
    del refs, ranks
    return by_path


def phase_data_parallel(fa) -> dict:
    """Phase 28 (see the module docstring). Returns {path: counts}; the
    counts of the ranks' paths are rank 0's."""
    import dataclasses

    import torch

    t_phase = time.perf_counter()
    by_path = {}
    # (a) NCCL at world size 1
    ctx, workdir = dp_spawn("world1", 1, "nccl")
    (runs,) = dp_collect(ctx, workdir, "world1", "dp world 1")
    plain = runs["plain"]
    n_leaves = len(plain["weights"])
    for key in ("ddp", "fsdp"):
        run = runs[key]
        worst = max(((run["weights"][n] - w).abs().max().item(), n)
                    for n, w in plain["weights"].items())
        same = sum(torch.equal(run["weights"][n], w) for n, w in plain["weights"].items())
        print(f"dp world 1 {key}: losses " + " ".join(f"{x!r}" for x in run["losses"])
              + " against plain " + " ".join(f"{x!r}" for x in plain["losses"])
              + f"; weights after {DP_STEPS} steps: {same} of {n_leaves} leaves "
              f"bit-identical (held: all), the largest difference {worst[0]:.4g} "
              f"({worst[1]}); {run['moved']} of {n_leaves} leaves moved from the "
              f"start (plain {plain['moved']}); "
              f"step {run['ms']:.3f} ms (plain {plain['ms']:.3f}); peak device "
              f"memory {run['peak']} bytes ({run['peak'] / 2**30:.3f} GiB, plain "
              f"{plain['peak'] / 2**30:.3f}); launches {run['launches']} "
              f"({CLIPSEG_COOP_STEP} a step)"
              + (f"; {run['sharded']} parameters sharded as DTensors"
                 if key == "fsdp" else ""))
        if run["launches"] != tuple(DP_STEPS * c for c in CLIPSEG_COOP_STEP):
            fail(f"dp world 1 {key}: launches {run['launches']}")
        # one rank's all-reduce, all-gather and reduce-scatter are copies and
        # its mean a division by 1: the steps are the plain steps bit for bit
        if run["losses"] != plain["losses"] or same != n_leaves:
            fail(f"dp world 1 {key}: one rank's steps are not the plain steps bit "
                 "for bit")
        if plain["moved"] == 0:
            fail("dp world 1: the plain steps moved no weight")
    by_path["train_ddp_ws1_coop"] = runs["ddp"]["launches"]
    by_path["train_fsdp_ws1_coop"] = runs["fsdp"]["launches"]
    del runs, plain

    by_path.update(dp_two_ranks_hold(fa))

    # (c) the zero-shot request with its proposals in 2 chunks on cuda:0
    if not ZS_SHARED:
        fail("dp zsseg split: phase 23's request is not there (run phase 23 first)")
    ris, request, extras = (ZS_SHARED[k] for k in ("ris", "request", "extras"))
    split = dataclasses.replace(ris, devices=(ris.device, ris.device))
    reset_counts(fa)
    picked_split, split_extras = zs_request_extras(split, *request)
    by_path["serve_zsseg_split"] = counts(fa)
    if by_path["serve_zsseg_split"] != ZS_SERVE:
        fail(f"dp zsseg split: launches {by_path['serve_zsseg_split']}")
    picked, _ = zs_request_extras(ris, *request)
    worst = max(((split_extras[k].float() - extras[k].float()).abs().max()
                 / extras[k].float().abs().max()).item()
                for k in ("mask_features", "crop_features"))
    n_props = int(extras["masks"].shape[0])
    print(f"dp zsseg split: phase 23's 1024^2 request, its {n_props} proposals in 2 "
          f"chunks of {-(-n_props // 2)} and {n_props // 2} through the towers on "
          f"cuda:0 and cuda:0: the visual features' largest difference from the "
          f"unsplit request {worst:.4g} of the largest |feature| (bound "
          f"{ZS_FEATURE_REL_TOL}), the same mask: "
          f"{bool(torch.equal(picked_split, picked))}; launches {by_path['serve_zsseg_split']}")
    if worst > ZS_FEATURE_REL_TOL or not torch.equal(picked_split, picked):
        fail("dp zsseg split: the split request disagrees with the unsplit one")

    # FreeSOLO's pseudo losses at the request's proposal shapes, on its
    # pixels (the CLIP normalisation undone)
    from tunevlseg_torch.models.solov2 import pseudo_loss
    mean, std = (torch.tensor(v).reshape(3, 1, 1) for v in CLIP_STATS)
    pixels = ((torch.from_numpy(request[0]) * std + mean) * 255).round()
    masks = extras["masks"].float().cpu()
    n, h, w = masks.shape
    gen = torch.Generator().manual_seed(28)
    quarter = (h // 4, w // 4)
    logits = torch.randn((n,) + quarter, generator=gen) * 2
    boxes = torch.nn.functional.interpolate(masks[None], size=quarter)[0]
    valid = extras["valid"].float().cpu()
    level = (torch.arange(n) % 5)
    results = {}
    for device in ("cpu", "cuda"):
        lg = logits.to(device).requires_grad_(True) if device == "cuda" else \
            logits.clone().requires_grad_(True)
        sim = pseudo_loss.prepare_color_similarity(
            pixels[None].to(device), torch.ones((1, h, w), device=device)
        ).expand(n, -1, -1, -1)
        losses = pseudo_loss.paired_losses(lg, boxes.to(device), sim, valid.to(device),
                                           level_ids=level.to(device), step=500)
        sum(losses.values()).backward()
        results[device] = ({k: v.item() for k, v in losses.items()}, lg.grad.cpu())
    (lc, gc), (lg_, gg) = results["cpu"], results["cuda"]
    rel = max(abs(lg_[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    grel = ((gg - gc).abs().max() / gc.abs().max()).item()
    print(f"pseudo loss: paired_losses over the request's {n} proposals at "
          f"{quarter[0]}x{quarter[1]} (per level, step 500) on the card against the "
          f"CPU: " + ", ".join(f"{k} {lg_[k]:.6f} / {lc[k]:.6f}" for k in lc)
          + f"; largest relative difference {rel:.3g}, gradient {grel:.3g} of its "
          f"largest entry (bound {PSEUDO_LOSS_REL_TOL})")
    if not (rel <= PSEUDO_LOSS_REL_TOL and grel <= PSEUDO_LOSS_REL_TOL):
        fail("pseudo loss: the card and the CPU disagree")
    ZS_SHARED.clear()
    del split, ris
    torch.cuda.empty_cache()
    print(f"dp: phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


# --- Slice G5: captured train steps ---------------------------------------------

# the JAX bench's `--scan`: the flagship's steps a captured group
CAPTURE_STEPS = 10
# groups held captured against eager from the same state, then groups timed
# of each (the median over them)
CAPTURE_GROUPS, CAPTURE_TIMED = 2, 3
# captured against eager where two eager runs of the same steps differ: the
# gap to the nearest of CAPTURE_EAGER_RUNS eager runs at most this multiple
# of the widest gap between two of them (each tensor's largest difference
# over its largest entry, the worst tensor of its kind). With three runs a
# correct captured run, one more draw of the same noise, fell outside that
# bound about one time in twenty a kind (a Gaussian draw against three; one
# CRIS flat CoOp metrics check in five calls on the card); with six, about
# one in five hundred
CAPTURE_WITNESS_FACTOR = 2
CAPTURE_EAGER_RUNS = 6
# torch.profiler windows of one replay each, until one records every launch
CAPTURE_PROFILE_WINDOWS = 6
# the spin kernel that opens a `device_launches` window (≈ 1 ms), and the
# short spin kernels each retaken window adds after it
PROFILE_SPIN_CYCLES = 2_000_000
PROFILE_LEAD = 50
# the kernels' names as torch.profiler records them, with the indices of
# `counts` whose launches each stands for (K2 is two kernels a launch; K4's
# forward and dx launches are one kernel)
PROFILED_KERNELS = (("K1", "flash_attn_fwd_kernel", (0,)),
                    ("K2 dq", "flash_attn_bwd_dq_kernel", (1,)),
                    ("K2 dk/dv", "flash_attn_bwd_dkdv_kernel", (1,)),
                    ("K3", "biased_attn_fwd_kernel", (2,)),
                    ("K4 + dx", "conv_flat_kernel", (3, 4)),
                    ("K4 prologue", "dy_prologue_kernel", (5,)))


def device_launches(fn, calls: int = 1, lead: int = 0) -> tuple:
    """({kernel name: launches a call}, whether the window's opening kernel
    was recorded, device records with no recorded duration) of `calls`
    calls of `fn` under torch.profiler (a CUDA graph's replay included):
    every device record counted by name, whatever duration it carries (a
    long script's windows came back one K4 of a captured replay short
    through the per-name averages, which keep only names with device
    time). The
    window opens, as `device_ms_by_kernel`'s do with their flush, with a
    kernel of its own (`torch.cuda._sleep`'s spin kernel, left out of the
    counts) and a synchronize before the first call: a window's first
    record is often lost. `lead` more short spin kernels after it shift
    where the calls' records fall in the profiler's buffers, should a loss
    come at the same place in every window."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_SPIN_CYCLES)
        for _ in range(lead):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("Optimizer.step")]
    spin = [e for e in events if "spin_kernel" in e.name]
    named = collections.Counter(e.name for e in events if "spin_kernel" not in e.name)
    untimed = sum(1 for e in events if e.time_range.elapsed_us() <= 0)
    return {n: c / calls for n, c in named.items()}, bool(spin), untimed


def state_tensors(task, state, metrics: list) -> dict:
    """{kind: {name: f32 tensor on the host}} of what a run of train steps
    leaves: the trainable weights, AdamW's moments and step counts, the
    BatchNorm statistics of the state, the accumulation window's running
    mean, and the metrics of each group."""
    names = {id(p): n for n, p in task.model.named_parameters()}
    opt = state.optimizer

    def host(t):
        return t.detach().float().to("cpu", copy=True)

    return {"weights": {n: host(p) for n, p in task.model.named_parameters()
                        if p.requires_grad},
            "moments": {f"{names[id(p)]}.{k}": host(v)
                        for p, entries in opt.optimizer.state.items()
                        for k, v in entries.items()},
            "statistics": {n: host(v) for n, v in state.model_state.items()},
            "window": {str(i): host(v) for i, v in opt.accumulated.items()},
            "metrics": {f"group {g} {k}": host(v) for g, m in enumerate(metrics)
                        for k, v in m.items()}}


def tensors_gap(got: dict, want: dict) -> tuple:
    """(bit-identical, the largest difference of a tensor over its largest
    entry, that tensor's name) of two {name: tensor} with the same names."""
    import torch
    if set(got) != set(want):
        fail(f"captured: the runs left other tensors: {sorted(set(got) ^ set(want))[:4]}")
    worst = (0.0, "")
    for name, w in want.items():
        rel = ((got[name] - w).abs().max() / w.abs().max().clamp(min=1e-30)).item() \
            if w.numel() else 0.0
        worst = max(worst, (rel, name))
    return all(torch.equal(got[n], w) for n, w in want.items()), *worst


def stack_groups(batches: list, k: int) -> list:
    """The batches in groups of k, each stacked on a leading (k, B, ...) axis."""
    import torch
    return [{key: torch.stack([b[key] for b in batches[g:g + k]]) for key in batches[0]}
            for g in range(0, len(batches), k)]


def captured_against_eager(fa, label: str, task, batches: list, k: int,
                           per_step: tuple, profile: bool,
                           halve_lr: bool = False) -> tuple:
    """`task.compile_train_multistep(k)` (one CUDA graph of k steps) against
    k eager steps a group from the same weights and a fresh state, over
    CAPTURE_GROUPS groups of `batches`: two eager runs (CAPTURE_EAGER_RUNS
    where they differ: the witness of their own rounding) and the captured
    one, whose weights, AdamW moments, BatchNorm statistics, accumulation
    window and group metrics must be bit-identical to the first eager
    run's wherever the first two are, and elsewhere within
    CAPTURE_WITNESS_FACTOR x the widest gap between two eager runs of the
    nearest one. Launches: each
    eager group k x `per_step`; the captured run's first call 2k x (the
    warm-up and the capture), the replays none through the counters, and
    one replay's kernels under torch.profiler k x `per_step` by name. Then
    CAPTURE_TIMED groups of each, timed (host clock, device drained; the
    median a step), the capture's seconds, peak memory, and with `profile`
    the device busy time and idle share of a group of each. With
    `halve_lr` the learning rate is halved between the groups (as the
    plateau scheduler does between epochs), which the graph must read.
    Returns (the captured run's counts, the eager runs' bit-identity)."""
    import torch
    from tunevlseg_torch.training import graphs
    from tunevlseg_torch.training.optim import get_learning_rate, set_learning_rate

    model = task.model
    start = trainable_snapshot(model)
    groups = stack_groups(batches, k)

    def run(captured: bool) -> dict:
        restore_trainable(model, start)
        model.zero_grad(set_to_none=True)
        state = task.init()
        multi = (task.compile_train_multistep(k) if captured
                 else graphs.eager_multistep(task, k))
        if captured and not isinstance(multi, graphs.CapturedSteps):
            fail(f"{label}: compile_train_multistep gave {type(multi).__name__}, "
                 "not the captured program")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)
        metrics, times, grew, want = [], [], [], []
        for g, group in enumerate(groups):
            if halve_lr and g:
                set_learning_rate(state.optimizer, get_learning_rate(state.optimizer) / 2)
            before, graphs_before = counts(fa), len(getattr(multi, "graphs", ()))
            t = time.perf_counter()
            state, m = multi(state, group)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            metrics.append(m)
            grew.append(minus(counts(fa), before))
            # a group that captures a graph runs its steps twice through
            # the counters (the warm-up and the capture); a replay not at all
            runs = (2 * (len(multi.graphs) - graphs_before) if captured else 1)
            want.append(tuple(runs * k * x for x in per_step))
        if grew != want:
            fail(f"{label}: {'captured' if captured else 'eager'} groups launched "
                 f"{COUNTED} = {grew} through the counters, expected {want}")
        losses = [m["loss"].item() for m in metrics]
        if not all(x == x and abs(x) != float("inf") for x in losses):
            fail(f"{label}: non-finite loss in {losses}")
        return {"state": state, "multi": multi, "times": times, "launches": counts(fa),
                "peak": torch.cuda.max_memory_allocated(), "resident": resident,
                "tensors": state_tensors(task, state, metrics), "losses": losses}

    eager = []
    for _ in range(2):
        eager.append(run(False))
        del eager[-1]["state"], eager[-1]["multi"]
    kinds = [kind for kind, want in eager[0]["tensors"].items() if want]
    deterministic = all(tensors_gap(eager[1]["tensors"][kind], eager[0]["tensors"][kind])[0]
                        for kind in kinds)
    if not deterministic:
        # more eager runs: the witness is the widest gap between two eager
        # runs, the captured run is held to the nearest eager run (one
        # witness pair alone let a scalar metric's noise fail the check,
        # and three one time in twenty; CAPTURE_EAGER_RUNS)
        while len(eager) < CAPTURE_EAGER_RUNS:
            eager.append(run(False))
            del eager[-1]["state"], eager[-1]["multi"]
    cap = run(True)
    verdicts, ok = [], True
    for kind in kinds:
        runs_of = [r["tensors"][kind] for r in eager]
        if tensors_gap(runs_of[1], runs_of[0])[0]:
            same_c, gap_c, where = tensors_gap(cap["tensors"][kind], runs_of[0])
            ok &= same_c
            verdicts.append(f"{kind} ({len(runs_of[0])}) " + ("bit-identical" if same_c
                            else f"NOT bit-identical (largest {gap_c:.3g} at {where})"))
            continue
        _, gap_c, where = min((tensors_gap(cap["tensors"][kind], want) for want in runs_of),
                              key=lambda g: g[1])
        gap_e = max(tensors_gap(runs_of[j], runs_of[i])[1]
                    for i in range(len(runs_of)) for j in range(i + 1, len(runs_of)))
        bound = CAPTURE_WITNESS_FACTOR * gap_e
        ok &= gap_c <= bound
        verdicts.append(f"{kind} ({len(runs_of[0])}) within {gap_c:.3g} of the nearest "
                        f"eager run (eager against eager up to {gap_e:.3g} over "
                        f"{len(runs_of)} runs, bound {bound:.3g}; worst {where or 'none'})")
    eager = eager[0]
    print(f"{label}: {len(groups)} groups of {k} steps from the same weights, captured "
          f"against eager: " + "; ".join(verdicts) + "; losses a group "
          + " ".join(f"{x:.6f}" for x in cap["losses"]) + " captured, "
          + " ".join(f"{x:.6f}" for x in eager["losses"]) + " eager")
    if not ok:
        fail(f"{label}: the captured steps and the eager steps disagree beyond the "
             "stated bounds")

    # one replay's kernels by name against k eager steps'
    multi, state, group = cap["multi"], cap["state"], groups[0]
    holder = [state]

    def captured_group():
        holder[0], _ = multi(holder[0], group)

    def eager_group():
        holder[0], _ = graphs.eager_multistep(task, k)(holder[0], group)

    # a profiler window may come back short of a launch (a phase-29 call
    # under --profile saw 31 of trans_seg's 32 K1; a whole script's call
    # on a slow host came back short in windows of 1, 2 and 3 replays of
    # the accumulate graph, the last with 116 of 117 K1, where later
    # processes on the same card recorded every one; then the CRIS e2e
    # flat replay 215 of its 216 K4 in six windows running): each window
    # opens with a kernel of its own (`device_launches`), and up to
    # CAPTURE_PROFILE_WINDOWS windows of one replay each are taken, each
    # retaken one behind PROFILE_LEAD more short kernels, the first that
    # records every launch kept
    want = {title: k * sum(per_step[i] for i in indices)
            for title, _, indices in PROFILED_KERNELS}
    short = []
    for window in range(1, CAPTURE_PROFILE_WINDOWS + 1):
        by_name, opened, untimed = device_launches(captured_group,
                                                   lead=PROFILE_LEAD * (window - 1))
        got = {title: sum(c for key, c in by_name.items() if name in key)
               for title, name, _ in PROFILED_KERNELS}
        if got == want:
            break
        short.append((got, "opening kernel recorded" if opened else "opening kernel lost",
                      f"{untimed} records without a duration"))
    else:
        fail(f"{label}: a replay launched {short} under torch.profiler (each of "
             f"{CAPTURE_PROFILE_WINDOWS} windows of one replay), expected {want} = "
             f"{k} x the eager step's")
    total = sum(by_name.values())
    print(f"{label}: one replay of the graph launched "
          + ", ".join(f"{t} {n:g}" for t, n in got.items()) + f" (= {k} x "
          f"{per_step[:6]} a step; window {window}, "
          + (f"after {short}" if short else "the first") + ", its opening "
          f"kernel {'recorded' if opened else 'NOT recorded'}, {untimed} records "
          f"without a duration) and {total:g} "
          "device kernels and copies in all (k eager steps': `--profile`)")

    # timing: replays, then the eager steps from the same state
    def timed(fn) -> list:
        out = []
        for _ in range(CAPTURE_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) / k)
        return out

    cap_ms = statistics.median(timed(captured_group)) * 1e3
    eager_ms = statistics.median(timed(eager_group)) * 1e3
    capture_s = cap["times"][0] - cap_ms * k / 1e3
    print(f"{label} [{CARD[0]}]: a step {cap_ms:.3f} ms captured, {eager_ms:.3f} ms eager "
          f"({eager_ms / cap_ms:.3f}x; host clock, device drained, median of "
          f"{CAPTURE_TIMED} groups of {k}); the first captured call (warm-up of {k} "
          f"eager steps, capture, replay) {cap['times'][0]:.3f} s, the capture "
          f"{capture_s:.3f} s above a replay; peak device memory {eager['peak'] / 2**30:.3f} "
          f"GiB eager, {cap['peak'] / 2**30:.3f} GiB captured ({eager['resident'] / 2**30:.3f} "
          f"GiB resident before)")
    if profile:
        for key, fn, wall in (("captured", captured_group, cap_ms),
                              ("eager", eager_group, eager_ms)):
            profile_calls(f"{label} {key} group of {k}", fn, wall=wall * k / 1e3)
    launches = cap["launches"]
    del cap, eager, multi, state, holder
    torch.cuda.empty_cache()
    return launches, deterministic


def fit_captured_against_eager(fa, task, deterministic: bool) -> None:
    """`Trainer.fit` with `steps_per_execution=CAPTURE_STEPS` against 1 from
    the same weights, over 2 epochs of CAPTURE_STEPS b64 batches (one full
    group an epoch; the plateau scheduler with patience 0 may change the
    learning rate between them, which the captured group must read): the
    final trainable weights, AdamW state and validation losses
    bit-identical where the flagship's two eager runs were (else only
    printed), and the loop's ms a step of both."""
    import tempfile
    from pathlib import Path
    import torch
    from tunevlseg_torch.data.pipeline import DataLoader
    from tunevlseg_torch.training.loop import Trainer
    from tunevlseg_torch.training.optim import ReduceLROnPlateau

    train_ds = InMemoryDataset(CAPTURE_STEPS * BATCH, 31, IMG)
    val_ds = InMemoryDataset(BATCH, 32, IMG)
    model = task.model
    start = trainable_snapshot(model)
    work = Path(tempfile.mkdtemp(prefix="fit_captured_"))
    results = {}
    for spe in (1, CAPTURE_STEPS):
        restore_trainable(model, start)
        model.zero_grad(set_to_none=True)
        tr = Trainer(task, work / str(spe), max_epochs=2, log_every_n_steps=5,
                     steps_per_execution=spe, loggers=("jsonl",),
                     scheduler=ReduceLROnPlateau(factor=0.5, patience=0))
        state = task.init()
        reset_counts(fa)
        final = tr.fit(state, DataLoader(train_ds, BATCH, shuffle=True, seed=5,
                                         num_workers=4, text_dedup=1),
                       DataLoader(val_ds, BATCH, shuffle=False, seed=5,
                                  num_workers=4, text_dedup=1))
        if final.step != 2 * CAPTURE_STEPS:
            fail(f"fit captured: spe {spe} took {final.step} steps")
        vals = [json.loads(line) for line in
                (work / str(spe) / "metrics.jsonl").read_text().splitlines()]
        results[spe] = (state_tensors(task, final, []), tr.train_times,
                        [r["val_loss"] for r in vals if "val_loss" in r], counts(fa))
        del final, state, tr
    eager, captured = results[1], results[CAPTURE_STEPS]
    verdicts, ok = [], True
    for kind in ("weights", "moments"):
        same, gap, where = tensors_gap(captured[0][kind], eager[0][kind])
        ok &= same or not deterministic
        verdicts.append(f"{kind} " + ("bit-identical" if same else
                                      f"largest {gap:.3g} ({where})"))
    if deterministic and captured[2] != eager[2]:
        ok = False
    per_step = {spe: [secs * 1e3 / n for _, n, secs in r[1]] for spe, r in results.items()}
    print(f"fit captured [{CARD[0]}]: Trainer.fit, 2 epochs of {CAPTURE_STEPS} b{BATCH} "
          f"batches, steps_per_execution {CAPTURE_STEPS} against 1: "
          + "; ".join(verdicts) + f"; val losses {captured[2]} against {eager[2]}; "
          f"loop ms a step by epoch {['%.3f' % x for x in per_step[CAPTURE_STEPS]]} "
          f"against {['%.3f' % x for x in per_step[1]]} (the first captured epoch holds "
          f"the warm-up and the capture); launches {captured[3]} against {eager[3]}")
    if not ok:
        fail("fit captured: steps_per_execution 10 and 1 disagree")


def phase_captured(fa, profile: bool) -> dict:
    """Phase 29: `compile_train_multistep` as one captured CUDA graph of k
    train steps, against the eager steps (`captured_against_eager`) on the
    flagship CLIPSeg CoOp b64 dedup at k = 10, the same model's b32 steps
    with `accumulate_grad_batches=2` at k = 3 (a window across the group
    boundary: two graphs, one per phase), CRIS CoOp b64 on the flat layout
    (54 K4 a step) and CRIS e2e on the flat layout (the full fine-tune: K4,
    its dx and prologue, K4's per-call weight copy after each update, the
    BatchNorm statistics in the state) at k = 2, bench's trans_seg b32 with
    decoder dropout 0.1 at k = 2 (the masks of each step), DenseCLIP RN50
    512^2 b16 `bn_train` with the poly schedule at k = 2 (a learning rate a
    step); then `Trainer.fit` with steps_per_execution 10 against 1.
    Returns {path: counts}."""
    import torch

    from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig
    from tunevlseg_torch.models.presets import build_denseclip, build_trans_segmentor
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
    from tunevlseg_torch.training.task import SegmentationTask

    t_phase = time.perf_counter()
    by_path = {}
    print(f"captured: torch {torch.__version__}, "
          f"CUDAGraph.register_generator_state "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}")
    task, _ = build_task("CLIPSeg rd64", "coop", 2e-4)
    distinct = [make_train_batch(BATCH, text_dedup=1, seed=60 + i) for i in range(4)]
    batches = [distinct[i % 4] for i in range(CAPTURE_GROUPS * CAPTURE_STEPS)]
    by_path["train_captured_coop"], deterministic = captured_against_eager(
        fa, "captured coop", task, batches, CAPTURE_STEPS, CLIPSEG_COOP_STEP, profile,
        halve_lr=True)
    fit_captured_against_eager(fa, task, deterministic)
    accumulating = SegmentationTask(task.model, task.freeze_spec, learning_rate=2e-4,
                                    accumulate_grad_batches=2)
    halves = [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2] if v.shape[0] == BATCH else v
               for k, v in b.items()} for b in distinct[:3] for i in range(2)]
    by_path["train_captured_coop_accumulate"], _ = captured_against_eager(
        fa, "captured coop accumulate", accumulating, halves, 3, CLIPSEG_COOP_STEP,
        profile)
    del task, accumulating, distinct, batches, halves
    print(f"captured: CLIPSeg paths at {time.perf_counter() - t_phase:.1f} s")

    task, _ = build_task("CRIS RN50", "coop", 2e-4, build_kwargs={"layout": "flat"})
    batches = [make_train_batch(BATCH, text_dedup=1, seed=70 + i, img=CRIS_IMG, pad_id=0)
               for i in range(2)] * CAPTURE_GROUPS
    by_path["train_captured_cris_flat_coop"], _ = captured_against_eager(
        fa, "captured cris flat coop", task, batches, 2, CRIS_FLAT_COOP_STEP, profile)
    del task, batches
    print(f"captured: CRIS CoOp flat at {time.perf_counter() - t_phase:.1f} s")
    task, _ = build_task("CRIS RN50", "e2e", 3e-6,
                         build_kwargs={"freeze_encoder": False, "layout": "flat"},
                         task_kwargs={"mutable_collections": ("batch_stats",)})
    batches = [make_train_batch(E2E_BATCH, text_dedup=0, seed=80 + i, img=CRIS_IMG,
                                pad_id=0) for i in range(2)] * CAPTURE_GROUPS
    by_path["train_captured_cris_e2e_flat"], _ = captured_against_eager(
        fa, "captured cris e2e flat", task, batches, 2, CRIS_E2E_FLAT_STEP, profile)
    del task, batches
    print(f"captured: CRIS e2e flat at {time.perf_counter() - t_phase:.1f} s")

    model, spec = build_trans_segmentor(ts_config(decoder_dropout=TS_DROPOUT),
                                        dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model, spec, learning_rate=2e-4)
    batches = [make_train_batch(TS_BATCH, text_dedup=0, seed=90 + i, img=IMG)
               for i in range(2)] * CAPTURE_GROUPS
    by_path["train_captured_trans_seg_dropout"], _ = captured_against_eager(
        fa, "captured trans_seg dropout", task, batches, 2, TS_STEP, profile)
    del model, task, batches
    print(f"captured: trans_seg at {time.perf_counter() - t_phase:.1f} s")

    gen = torch.Generator().manual_seed(72)
    model = build_denseclip(DenseCLIPConfig(), denseclip_class_ids(gen), bn_train=True,
                            dtype=torch.bfloat16, device="cuda", seed=0)
    task = DenseCLIPTask(model, learning_rate=1e-4, weight_decay=1e-4, warmup_iters=3,
                         image_stats=IMAGENET_STATS)
    batches = [denseclip_train_batch(gen) for _ in range(2)] * CAPTURE_GROUPS
    by_path["train_captured_denseclip_bn_train"], _ = captured_against_eager(
        fa, "captured denseclip bn_train", task, batches, 2, DC_STEP, profile)
    del model, task, batches
    torch.cuda.empty_cache()
    print(f"captured: phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


# phase 30, the tools: the sweep's trials take TOOLS_STEPS train steps of the
# flagship CoOp step at b16 (trainer.limit_batches) and TOOLS_FORWARDS
# forwards (the validation's batches, its image panel, the test's batches)
TOOLS_BATCH, TOOLS_LIMIT, TOOLS_TRIALS = 16, 2, 3
TOOLS_STEPS, TOOLS_FORWARDS = TOOLS_LIMIT, 2 * TOOLS_LIMIT + 1
SWEEP_TRIAL = tuple(TOOLS_STEPS * s + TOOLS_FORWARDS * f
                    for s, f in zip(CLIPSEG_COOP_STEP, CLIPSEG_SERVE))
TOOLS_ZS_IMAGES, TOOLS_TOPK = 3, (1, 5, 10)
NO_LAUNCH = (0,) * 8
# a synthetic BPE merges file: the tokenizer's ids stay under CLIP's 49,408
TOOLS_MERGES = ["p o", "l y", "po ly", "polyp </w>", "t h", "th e</w>", "a </w>"]


def tools_folder(root, n: int, side: int, zero_shot: bool) -> None:
    """A synthetic image-text-mask folder (`images/`, `masks/`, `anns/`): n
    random RGB images of side^2 with a square mask each, the prompt
    "a polyp" (and the class name "polyp" for zero-shot tasks)."""
    import numpy as np

    from tunevlseg_torch.data import opencv
    cv2 = opencv.cv2()
    for sub in ("images", "masks", "anns"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(n)
    tasks = []
    for i in range(n):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 255, (side, side, 3), dtype=np.uint8))
        mask = np.zeros((side, side), np.uint8)
        lo = side // 8 + (i % 4) * side // 16
        mask[lo:lo + side // 2, side // 4:side * 3 // 4] = 255
        cv2.imwrite(str(root / "masks" / f"{i}.png"), mask)
        task = {"img_name": f"{i}.png", "mask_name": f"{i}.png",
                "prompts": {"p0": "a polyp"}}
        if zero_shot:
            task["object_class"] = "polyp"
        tasks.append(task)
    for split in ("train", "val", "test"):
        (root / "anns" / f"{split}.json").write_text(json.dumps(tasks))


def tools_counted(fa, label: str, fn):
    """`fn()` with the launch counts set to 0 just before it and read just
    after: (its result, the counts, its seconds)."""
    import torch
    torch.cuda.synchronize()
    reset_counts(fa)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts(fa)
    print(f"{label}: {secs:.2f} s, launches {COUNTED} {c}")
    return out, c, secs


def phase_tools(fa) -> dict:
    """Phase 30: the slice's tools through their entry points, in this
    process, on synthetic files under a temporary directory: (a)
    `scripts/torch_sweep.py --space coop --trials 3` over the port's train
    CLI (CoOp CLIPSeg rd64 ViT-B/16 at 352^2, b16, one epoch of 2 batches,
    seeded random weights), each trial's launches from 0; (b)
    `scripts/torch_analyze_prompts.py` on the best trial's run; (c)
    `scripts/torch_analyze_zeroshot.py` `limit` on three 1024^2 images (the
    zsseg CLIP ViT-B/16 and FreeSOLO R101 in f32, as the eval_zeroshot entry
    point builds them), `topk --topk 1 5 10` and `limit` on
    `+model.layout=flat`, both `--dtype bf16`; (d)
    `scripts/torch_train_mnist.py --synthetic --epochs 3` on the card; (e)
    `scripts/torch_analyze_phrasecut.py` on a small synthetic folder.
    Returns {path: counts} of the paths that launch a kernel."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from tunevlseg_torch import eval_zeroshot

    t_phase = time.perf_counter()
    by_path = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        merges = tmp / "merges.txt"
        merges.write_text("#version: 0.2\n" + "\n".join(TOOLS_MERGES) + "\n")
        tools_folder(tmp / "data" / "kvasir_polyp", TOOLS_BATCH * TOOLS_LIMIT, IMG,
                     zero_shot=False)
        tools_folder(tmp / "data" / "zsds", TOOLS_ZS_IMAGES, ZS_IMG, zero_shot=True)
        print(f"tools: synthetic folders written in {time.perf_counter() - t_phase:.1f} s")

        # (a) the sweep, every trial's launches counted from 0
        from tunevlseg_torch import train
        trial_counts = []

        def counted_trial(overrides):
            torch.cuda.synchronize()
            reset_counts(fa)
            try:
                return train.main(overrides)
            finally:            # a failing trial's launches too
                torch.cuda.synchronize()
                trial_counts.append(counts(fa))

        sweep = load_script("torch_sweep.py").main(
            ["--space", "coop", "--trials", str(TOOLS_TRIALS),
             "--results", str(tmp / "sweep.json"),
             "experiment=coop/clipseg", "ds_name=kvasir_polyp",
             f"paths.data_root={tmp / 'data'}", f"paths.log_dir={tmp / 'logs'}",
             f"vocab_path={merges}", f"data.batch_size={TOOLS_BATCH}",
             "data.num_workers=4", "trainer.max_epochs=1", "trainer.min_epochs=1",
             f"trainer.limit_batches={TOOLS_LIMIT}", "predict=false"],
            train_main=counted_trial)
        if len(sweep["trials"]) != TOOLS_TRIALS or len(trial_counts) != TOOLS_TRIALS:
            fail(f"tools sweep: {len(sweep['trials'])} trials recorded")
        for t, c in zip(sweep["trials"], trial_counts):
            label = f"tools sweep trial {t['trial']}"
            if "error" in t:
                fail(f"{label} failed: {t['error']}")
            if t["value"] is None or not math.isfinite(t["value"]):
                fail(f"{label}: val_loss {t['value']}")
            if c != SWEEP_TRIAL:
                fail(f"{label}: launches {c}, expected {SWEEP_TRIAL} "
                     f"({TOOLS_STEPS} CoOp steps, {TOOLS_FORWARDS} forwards)")
            print(f"{label}: params {t['params']}, val_loss {t['value']:.6f}, "
                  f"test_dice {t['metrics'].get('test_dice')}, {t['seconds']:.2f} s")
            by_path[f"train_sweep_trial{t['trial']}"] = c
        best = sweep["best"]
        print(f"tools sweep: best trial {best['trial']}, val_loss {best['value']:.6f}; "
              f"{time.perf_counter() - t_phase:.1f} s into the phase")

        # (b) the prompt analysis of the best trial's run
        run = tmp / "logs" / "train" / f"sweep_trial{best['trial']}"
        reports, c, secs = tools_counted(
            fa, "tools analyze_prompts", lambda: load_script(
                "torch_analyze_prompts.py").main([str(run), "--out", str(tmp / "prompts")]))
        depth = int(best["params"]["model.prompt_depth"])
        if c != NO_LAUNCH or [r["tensor"] for r in reports] != ["learner/context_vectors"]:
            fail(f"tools analyze_prompts: {reports}, launches {c}")
        rep = reports[0]
        ids = np.asarray(rep.get("nearest_token_ids", []))
        if rep["shape"] != [depth, 4, 512] or ids.shape != (depth * 4, 3) \
                or not (0 <= ids).all() or not (ids < 49408).all() \
                or not math.isfinite(rep["norm_mean"]):
            fail(f"tools analyze_prompts: {rep}")
        pca = np.loadtxt(tmp / "prompts" / "pca.csv", delimiter=",", skiprows=1)
        if pca.shape != (depth * 4, 3) or not np.isfinite(pca).all():
            fail(f"tools analyze_prompts: pca.csv {pca.shape}")
        print(f"tools analyze_prompts: {rep['shape']} contexts, norm_mean "
              f"{rep['norm_mean']:.4f}, nearest ids of the first {ids[0].tolist()} "
              f"against the 49,408-row embedding, {secs:.2f} s")

        # (c) the zero-shot analyses. Random FreeSOLO heads may leave no
        # proposal over the default thresholds; then the analysis RIS gets
        # phase 23's lowered ones, and says so
        real_build = eval_zeroshot.build_ris
        built = []

        def build_ris(cfg, device="cuda", dtype=torch.float32):
            ris = real_build(cfg, device=device, dtype=dtype)
            image = eval_zeroshot.zero_shot_dataset(cfg)[0]["image"]
            before = counts(fa)
            probe = ris.get_freesolo_predictions(image)[2]
            probed = minus(counts(fa), before)
            if not probe.any():
                c = ris.solo_config
                ris.solo_config = dataclasses.replace(c, score_threshold=0.005,
                                                      update_threshold=1e-4)
                print(f"tools zeroshot: DEVIATION: no valid proposal at "
                      f"score_threshold {c.score_threshold} / update_threshold "
                      f"{c.update_threshold}; lowered to 0.005 / 1e-4")
            valid = []
            fetch = ris.get_freesolo_predictions

            def counted_fetch(*args, **kwargs):
                out = fetch(*args, **kwargs)
                valid.append(int(np.asarray(out[2]).sum()))
                return out
            ris.get_freesolo_predictions = counted_fetch
            built.append((probed, valid))
            return ris

        eval_zeroshot.build_ris = build_ris
        try:
            analyze = load_script("torch_analyze_zeroshot.py").main
            # the overrides right after the mode: Python 3.12.3's argparse
            # takes the empty list for them at the first option
            zs_args = ["ds_name=zsds", f"paths.data_root={tmp / 'data'}",
                       f"paths.log_dir={tmp / 'logs'}", f"vocab_path={merges}"]
            runs = {}
            # eval_zeroshot's f32 (the JAX package's precision) runs no
            # kernel: the gates take bf16 on the card; bf16 as phase 23 runs
            for tag, mode, options in (
                    ("limit", "limit", []),
                    ("topk", "topk", ["--topk", *map(str, TOOLS_TOPK), "--dtype", "bf16"]),
                    ("limit_flat", "limit", ["--dtype", "bf16"])):
                extra = ["+model.layout=flat"] if tag == "limit_flat" else []
                result, c, secs = tools_counted(
                    fa, f"tools analyze_zeroshot {tag}",
                    lambda: analyze([mode, *zs_args, *extra, *options,
                                     "--out-dir", str(tmp / f"zs_{tag}")]))
                # less the probe's launches: the analysis's own
                probed, valid = built[-1]
                c = minus(c, probed)
                runs[tag] = (result, c, valid)
                metrics = {k: v for k, v in result.items() if k not in ("mode", "images")}
                if result["images"] != TOOLS_ZS_IMAGES or not all(
                        math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()):
                    fail(f"tools analyze_zeroshot {tag}: {result}")
                print(f"tools analyze_zeroshot {tag}: {result}; valid proposals a "
                      f"request {valid}; {secs:.2f} s with the build")
        finally:
            eval_zeroshot.build_ris = real_build
        per_request = {"limit": NO_LAUNCH, "limit_flat": (0, 0, 0, R101_FLAT_CONVS)
                       + (0,) * 4}
        for tag in ("limit", "limit_flat"):
            _, c, valid = runs[tag]
            want = tuple(TOOLS_ZS_IMAGES * n for n in per_request[tag])
            if c != want:
                fail(f"tools analyze_zeroshot {tag}: launches {c}, expected {want}")
        _, c, valid = runs["topk"]
        # the host loop runs the text tower only for a request with a valid
        # proposal (12 K3 each), never K1 (197-token ViTs) nor K4 ("nchw")
        answered = sum(1 for n in valid if n)
        if answered < 1 or c != tuple(answered * n for n in ZS_SERVE):
            fail(f"tools analyze_zeroshot topk: launches {c} for {answered} "
                 f"requests with a valid proposal ({valid})")
        by_path["serve_zsseg_analysis_topk"] = c
        by_path["serve_zsseg_analysis_limit_flat"] = runs["limit_flat"][1]

        # (d) MNIST on the card
        mnist, c, secs = tools_counted(
            fa, "tools train_mnist", lambda: load_script("torch_train_mnist.py").main(
                ["--synthetic", "--epochs", "3"]))
        if c != NO_LAUNCH or not mnist["val_acc"] > 0.9 \
                or not math.isfinite(mnist["test_loss"]):
            fail(f"tools train_mnist: {mnist}, launches {c}")
        print(f"tools train_mnist: val_acc {mnist['val_acc']:.4f}, test_acc "
              f"{mnist['test_acc']:.4f}, s an epoch (host clock, device drained) "
              f"{[round(s, 4) for s in mnist['epoch_seconds']]}")

        # (e) PhraseCut statistics on the host
        from tunevlseg_torch.data import opencv
        cv2 = opencv.cv2()
        pc = tmp / "phrasecut"
        (pc / "images").mkdir(parents=True)
        tasks = []
        for image_id, phrase, (h, w) in ((10, "red car", (240, 320)),
                                         (11, "tree", (300, 200)),
                                         (12, "red car", (480, 640))):
            cv2.imwrite(str(pc / "images" / f"{image_id}.jpg"),
                        np.full((h, w, 3), image_id, np.uint8))
            tasks.append({"task_id": f"{image_id}__0", "phrase": phrase})
        (pc / "tasks.json").write_text(json.dumps(tasks))
        stats, c, secs = tools_counted(
            fa, "tools analyze_phrasecut",
            lambda: load_script("torch_analyze_phrasecut.py").main(
                ["--task-json", str(pc / "tasks.json"), "--image-dir",
                 str(pc / "images"), "--out-dir", str(pc / "out")]))
        if c != NO_LAUNCH or stats["tasks"] != 3 or stats["unique_phrases"] != 2 \
                or stats["image_shapes"]["scanned"] != 3 \
                or stats["crop_headroom_after_smallest_max_size"]["max_extra_hw"] != [112, 75]:
            fail(f"tools analyze_phrasecut: {stats}")
        print(f"tools analyze_phrasecut: {stats['tasks']} tasks, "
              f"{stats['unique_phrases']} phrases, shapes {stats['image_shapes']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"tools: phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


# --- Slice G7: tensor and sequence parallelism -----------------------------------

# (b)'s image size: 21^2 + 1 = 442 vision tokens, which divide by tp = 2 (at
# 352^2 the 485 do not, and the stream stays replicated, as the 77 text
# tokens do at either size)
TP_SP_IMG = 336
TP_SP_STEPS = 2
TP_CRIS_BATCH = 16
# (c): a data rank's rows of the b64 batch
TP_DP_BATCH = 32
# tp = 2 against one process: two bf16 evaluations that round differently
# (each row-parallel product is two partial sums rounded to bf16 and added,
# where one process rounds one f32 sum), like the kernel path against the
# plain path: held to that comparison's bounds (LOSS_TOL, GRAD_REL_TOL,
# GRAD_COS_MIN, PROB_*_TOL), each printed beside its witness, the kernel
# path against the plain path at tp = 1 on the same start, or to
# DP_WITNESS_FACTOR times the witness where that is wider


def frozen_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if not p.requires_grad)


def bias_form(bias):
    """A K3 bias as it broadcasts (each stride-0 dimension cut to one entry),
    on the host: what `tp_kernel_checks` passes the kernel again."""
    if bias is None:
        return None
    for i, (n, st) in enumerate(zip(bias.shape, bias.stride())):
        if n > 1 and st == 0:
            bias = bias.narrow(i, 0, 1)
    return bias.detach().cpu().clone()


def recording_shapes(fa, seen: dict):
    """A context in which every K1, K2 and K3 launch records its shapes into
    `seen`, {(kernel, q shape, k shape, kv_valid, bias shape): the bias
    (`bias_form`) or None}, through the wrappers' launchers
    (`_launch`, `_launch_bwd`, `_launch_biased`), which it calls as they
    are: the launches and their counts are unchanged."""
    import contextlib

    @contextlib.contextmanager
    def recording():
        launch, launch_bwd, launch_biased = fa._launch, fa._launch_bwd, fa._launch_biased

        def k1(q, k, v, t_valid, with_lse=False):
            seen.setdefault(("K1", tuple(q.shape), tuple(k.shape), t_valid, None), None)
            return launch(q, k, v, t_valid, with_lse)

        def k2(q, k, v, g, t_valid, lse):
            seen.setdefault(("K2", tuple(q.shape), tuple(k.shape), t_valid, None), None)
            return launch_bwd(q, k, v, g, t_valid, lse)

        def k3(q, k, v, bias, t_valid):
            key = ("K3", tuple(q.shape), tuple(k.shape), t_valid,
                   None if bias is None else tuple(bias_form(bias).shape))
            if key not in seen:
                seen[key] = bias_form(bias)
            return launch_biased(q, k, v, bias, t_valid)

        fa._launch, fa._launch_bwd, fa._launch_biased = k1, k2, k3
        try:
            yield seen
        finally:
            fa._launch, fa._launch_bwd, fa._launch_biased = launch, launch_bwd, launch_biased
    return recording()


def tp_kernel_checks(fa, by_path: dict, launches: dict) -> None:
    """K1, K2 and K3 against their plain versions on the card at every local
    shape the tensor-parallel runs launched them at, as their ranks recorded
    them (`recording_shapes`, {path: {key: bias}}): K1 with and without the
    log-sum-exp, K2 on K1's log-sum-exp and without it, K3 with the bias
    the path passed; q, k, v and the output gradient standard normal, at
    the tolerances of phases 2-4 (KERNEL_TOL, LSE_REL_TOL, K2_REL_TOL).
    Fails on a miss, and where a path counted launches of a kernel but
    recorded no shape of it (`launches`: {path: counts})."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(31)

    def rnd(shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    for path, counted in launches.items():
        for i, kernel in enumerate(("K1", "K2", "K3")):
            if counted[i] and not any(key[0] == kernel for key in by_path[path]):
                fail(f"tp kernels: {path} launched {kernel} {counted[i]} times and "
                     "recorded no shape of it")
    cases = {}
    for path, seen in by_path.items():
        for key, bias in seen.items():
            cases.setdefault(key, (bias, []))[1].append(path)
    for key in sorted(cases, key=str):
        bias, paths = cases[key]
        kernel, qs, ks, t_valid, _ = key
        q, k, v = rnd(qs), rnd(ks), rnd(ks)
        kv = None if t_valid == ks[1] else t_valid
        if kernel == "K1":
            out, lse = fa._launch(q, k, v, t_valid, with_lse=True)
            bare = fa._launch(q, k, v, t_valid)
            ref, lse_ref = fa.flash_attention_ref(q, k, v, kv_valid=kv, return_lse=True)
            err = max((x.float() - ref.float()).abs().max().item() for x in (out, bare))
            lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)).max().item()
            same = torch.equal(out, bare)
            ok = err <= KERNEL_TOL and lse_err <= LSE_REL_TOL and same
            what = (f"max_abs_err {err:.6g} with and without the lse (bound "
                    f"{KERNEL_TOL}), the two bit-identical {same}, lse error "
                    f"{lse_err:.3g} of max(1, |lse|) (bound {LSE_REL_TOL})")
        elif kernel == "K2":
            g = rnd(qs)
            _, lse = fa._launch(q, k, v, t_valid, with_lse=True)
            got = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv, lse=lse)
            want = fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv, lse=lse)
            exact = fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv)
            rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(got, want))
            exact_rel = max(((a.float() - b.float()).abs().max()
                             / b.float().abs().max()).item() for a, b in zip(got, exact))
            ok = rel <= K2_REL_TOL and exact_rel <= K2_REL_TOL
            what = (f"dq, dk, dv: largest max abs error {rel:.4g} of the largest "
                    f"|reference| on K1's lse, {exact_rel:.4g} without it (bound "
                    f"{K2_REL_TOL})")
        else:
            b = None if bias is None else bias.cuda()
            out = fa.biased_attention(q, k, v, b, kv_valid=kv)
            ref = fa.biased_attention_ref(q, k, v, b, kv_valid=kv)
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(out.isfinite().all()) and err <= KERNEL_TOL
            what = (f"bias {None if b is None else tuple(b.shape)}: max_abs_err "
                    f"{err:.6g} (bound {KERNEL_TOL})")
        torch.cuda.synchronize()
        print(f"tp kernels: {kernel} q{qs} k{ks} kv_valid {kv} against its plain "
              f"version: {what}; launched there on {', '.join(sorted(paths))}")
        if not ok:
            fail(f"tp kernels: {kernel} q{qs} k{ks} disagrees with its plain version")


def tp_train(fa, task, state, batches: list, label: str, per_step: tuple):
    """Train steps over `batches` with the launch counts and the collective
    bytes set to 0 before each and read after: (state, losses, {leaf:
    gradient each update applied} a step, launches of all, bytes a step,
    median ms, peak device bytes)."""
    import torch
    from tunevlseg_torch.parallel import tensor_parallel
    applied = applied_gradients(state, task.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    losses, moved, times = [], [], []
    for batch in batches:
        before = counts(fa)
        tensor_parallel.reset_bytes()
        t = time.perf_counter()
        state, metrics = task.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        moved.append(tensor_parallel.bytes_moved())
        losses.append(metrics["loss"].item())
        if minus(counts(fa), before) != per_step:
            fail(f"{label}: a step launched {minus(counts(fa), before)}, expected "
                 f"{per_step}")
    if not all(np_finite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    return (state, losses, applied, counts(fa), moved,
            statistics.median(times) * 1e3, torch.cuda.max_memory_allocated())


def tp_record(model, state, losses, applied, launches, moved, ms, peak,
              **extra) -> dict:
    return {"losses": losses, "applied": applied, "launches": launches,
            "bytes": moved, "ms": ms, "peak": peak,
            "trainable": {n: w.float().cpu()
                          for n, w in trainable_snapshot(model).items()},
            **extra}


def tp_job_two_ranks(fa) -> dict:
    """(a), (b), (d) and (e) on two ranks, one model group (tp = 2, dp = 1),
    both on cuda:0 over gloo; and (c)'s reference, two accumulated b32
    micro-steps at tp = 2."""
    import tempfile

    import torch
    from tunevlseg_torch.parallel import (activation_sharding, distributed,
                                          tensor_parallel)
    from tunevlseg_torch.parallel.mesh import make_mesh
    from tunevlseg_torch.train import export_task
    from tunevlseg_torch.training.task import SegmentationTask
    grid = make_mesh(2)
    shapes = {}
    out = {"shapes": shapes}
    task, state = build_task("CLIPSeg rd64", "coop", 2e-4)
    model = task.model
    start = trainable_snapshot(model)
    whole = frozen_bytes(model)
    tensor_parallel.shard_model(model, grid)
    batches = [make_train_batch(BATCH, text_dedup=1, seed=s) for s in (3, 4, 5)]
    # (a) serve: one b64 request, then three train steps
    reset_counts(fa)
    tensor_parallel.reset_bytes()
    with recording_shapes(fa, shapes.setdefault("serve_tp2_coop", {})):
        probs = task.predict_step(batches[0])
    torch.cuda.synchronize()
    serve = {"launches": counts(fa), "bytes": tensor_parallel.bytes_moved(),
             "probs": probs.half().cpu()}
    with recording_shapes(fa, shapes.setdefault("train_tp2_coop", {})):
        run = tp_train(fa, task, task.init(), batches, "tp2 coop", CLIPSEG_COOP_STEP)
    out["coop"] = tp_record(model, *run, serve=serve,
                            frozen=(whole, frozen_bytes(model)),
                            local_heads=model.vision_model.layers[0].self_attn.num_heads)
    # (e) the run's export through the CLI's `export_task`: the whole tensors
    # gathered over the model group, rank 0 tracing a whole model built again
    out_dir = (tempfile.mkdtemp(prefix="chip_smoke_tp_export_")
               if distributed.rank() == 0 else None)
    t = time.perf_counter()
    export_task(task, run[0], batches[0], out_dir, ("cuda",),
                rebuild=lambda: build_task("CLIPSeg rd64", "coop", 2e-4)[0])
    out["coop"]["export"] = {"dir": out_dir, "s": time.perf_counter() - t}
    # (c)'s reference: the first batch as two accumulated b32 micro-steps
    restore_trainable(model, start)
    acc = SegmentationTask(model, task.freeze_spec, learning_rate=2e-4,
                           accumulate_grad_batches=2)
    acc_state = acc.init()
    applied = applied_gradients(acc_state, model)
    for r in range(2):
        acc_state, metrics = acc.train_step(acc_state, dp_rows(batches[0], r, 2))
    out["accumulated"] = {"applied": applied[0], "loss": metrics["loss"].item()}
    del acc, acc_state
    # (b) at 336^2: tensor parallel alone, then with the stream
    # sequence-sharded; CoOp, then MaPLe, whose visual contexts' gradient
    # runs back through the sharded vision stream (the reduce-scatter of
    # gather_seq's backward, the all-gathers of split's and
    # reduce_scatter_seq's, the sum of the context rows' gradient)
    sp_batches = [make_train_batch(BATCH, text_dedup=1, seed=s, img=TP_SP_IMG)
                  for s in (6, 7)]
    for strategy, per_step in (("coop", CLIPSEG_COOP_STEP),
                               ("maple", CLIPSEG_VISUAL_STEP)):
        if strategy != "coop":
            del task, model, state
            torch.cuda.empty_cache()
            task, state = build_task("CLIPSeg rd64", strategy, 2e-4)
            model = task.model
            start = trainable_snapshot(model)
            tensor_parallel.shard_model(model, grid)
        for sp in (False, True):
            restore_trainable(model, start)
            if sp:
                activation_sharding.enable(model, grid)
            label = f"train_tp2{'_sp' if sp else '_'}336_{strategy}"
            with recording_shapes(fa, shapes.setdefault(label, {})):
                run = tp_train(fa, task, task.init(), sp_batches,
                               f"tp2 sp{int(sp)} 336 {strategy}", per_step)
            out[f"sp{int(sp)} {strategy}"] = tp_record(model, *run)
    del task, model, state
    torch.cuda.empty_cache()
    # (d) CRIS CoOp on the flat layout, b16, one step
    task, state = build_task("CRIS RN50", "coop", 2e-4,
                             build_kwargs={"layout": "flat"})
    whole = frozen_bytes(task.model)
    tensor_parallel.shard_model(task.model, grid)
    batch = make_train_batch(TP_CRIS_BATCH, text_dedup=1, seed=8, img=CRIS_IMG,
                             pad_id=0)
    with recording_shapes(fa, shapes.setdefault("train_tp2_cris_flat_coop", {})):
        run = tp_train(fa, task, task.init(), [batch], "tp2 cris flat",
                       CRIS_FLAT_COOP_STEP)
    out["cris"] = tp_record(task.model, *run, frozen=(whole, frozen_bytes(task.model)))
    return out


def tp_job_four_ranks(fa) -> dict:
    """(c) dp 2 x tp 2: four ranks on cuda:0 over gloo, b32 a data rank, one
    step under DDP over the data groups."""
    import torch
    from tunevlseg_torch.parallel import distributed, tensor_parallel
    from tunevlseg_torch.parallel.mesh import make_mesh
    grid = make_mesh(2)
    task, state = build_task("CLIPSeg rd64", "coop", 2e-4)
    tensor_parallel.shard_model(task.model, grid)
    task.compile_steps()
    batch = dp_rows(make_train_batch(BATCH, text_dedup=1, seed=3),
                    distributed.data_rank(), grid.data_size)
    shapes = {}
    with recording_shapes(fa, shapes):
        run = tp_train(fa, task, state, [batch], "dp2 tp2 coop", CLIPSEG_COOP_STEP)
    torch.cuda.synchronize()
    return tp_record(task.model, *run, grid=(grid.data_rank, grid.model_rank),
                     shapes=shapes)


DP_JOBS.update({"tp2": tp_job_two_ranks, "dp2tp2": tp_job_four_ranks})


def tp_references(fa) -> dict:
    """The one-process side: (a) the b64 request and the three steps at tp =
    1, with the kernel path against the plain path on the request and on
    the first step as the witness; (b)'s MaPLe steps at 336^2 and (d) the
    CRIS flat step likewise."""
    import torch
    refs = {}
    for key, family, strategy, batches, per_step in (
            ("coop", "CLIPSeg rd64", "coop",
             [make_train_batch(BATCH, text_dedup=1, seed=s) for s in (3, 4, 5)],
             CLIPSEG_COOP_STEP),
            ("maple", "CLIPSeg rd64", "maple",
             [make_train_batch(BATCH, text_dedup=1, seed=s, img=TP_SP_IMG)
              for s in (6, 7)], CLIPSEG_VISUAL_STEP),
            ("cris", "CRIS RN50", "coop",
             [make_train_batch(TP_CRIS_BATCH, text_dedup=1, seed=8, img=CRIS_IMG,
                               pad_id=0)], CRIS_FLAT_COOP_STEP)):
        task, state = build_task(family, strategy, 2e-4, build_kwargs=(
            {"layout": "flat"} if key == "cris" else None))
        start = trainable_snapshot(task.model)
        ref = {"frozen": frozen_bytes(task.model)}
        probs = task.predict_step(batches[0]).float()
        with plain_path():
            plain_probs = task.predict_step(batches[0]).float()
        _, ref["losses"], ref["applied"], *_ = tp_train(
            fa, task, task.init(), batches, f"tp1 {key}", per_step)
        leaves = tuple(ref["applied"][0])
        kernel_loss, kernel_grads = first_step(task, start, batches[0], leaves)
        with plain_path():
            plain_loss, plain_grads = first_step(task, start, batches[0], leaves)
        ref["probs"] = probs.cpu()
        ref["witness"] = {"probs": (probs - plain_probs).abs().cpu(),
                          "loss": abs(kernel_loss - plain_loss),
                          "grads": worst_leaf(kernel_grads, plain_grads)}
        refs[key] = ref
        del task, state
        torch.cuda.empty_cache()
    return refs


def tp_one_process_export() -> tuple:
    """(e)'s one-process side, run while the tp = 2 ranks train: the
    flagship CoOp task built as the ranks build it, exported at b64 through
    `export_task` with no process group (the one-process path), and its
    program loaded. Returns (the task, the program's directory, the
    export's seconds, the loaded program, the load's seconds)."""
    import tempfile

    from tunevlseg_torch import serving
    from tunevlseg_torch.train import export_task
    task, state = build_task("CLIPSeg rd64", "coop", 2e-4)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_one_export_")
    t = time.perf_counter()
    export_task(task, state, make_train_batch(BATCH, text_dedup=1, seed=3),
                out_dir, ("cuda",))
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    program = serving.load_fn(out_dir, device="cuda")
    return task, out_dir, export_s, program, time.perf_counter() - t


def tp_export_hold(fa, run: dict, one: tuple) -> tuple:
    """(e): the tp = 2 run's program (exported by model rank 0) and the
    one-process program, each loaded and called on the run's weights (the
    frozen tensors as built, the trainable ones after the run's steps) and
    its first b64 request: the probabilities bit-identical, the same
    `tunevlseg::` ops in both meta.json, the tp program's launches from 0.
    Returns those launches."""
    import shutil

    import torch
    from tunevlseg_torch import serving
    task, one_dir, one_s, one_program, one_load_s = one
    tp_dir = run["export"]["dir"]
    model_params = dict(task.model.named_parameters())
    with torch.no_grad():
        for name, w in run["trainable"].items():
            model_params[name].copy_(w)
    params = dict(task.model.state_dict())
    request = make_train_batch(BATCH, text_dedup=1, seed=3)
    t = time.perf_counter()
    program = serving.load_fn(tp_dir, device="cuda")
    loads = (time.perf_counter() - t, one_load_s)
    reset_counts(fa)
    probs = program(params, request)
    torch.cuda.synchronize()
    launches = counts(fa)
    want = one_program(params, request)
    torch.cuda.synchronize()
    check_probs("tp2 export", probs, BATCH, IMG)
    same = torch.equal(probs, want)
    ops = [serving.read_meta(d)["tunevlseg_ops"] for d in (tp_dir, one_dir)]
    print(f"tp2 export: the tp = 2 run exported through train.export_task (model "
          f"rank 0 tracing a whole model built again, the run's tensors gathered "
          f"into it) in {run['export']['s']:.2f} s, the one-process export in "
          f"{one_s:.2f} s; loaded in {loads[0]:.2f} / {loads[1]:.2f} s; ops "
          f"{ops[0]} / {ops[1]}; on the run's weights and its b64 request the "
          f"probabilities {'bit-identical' if same else 'DIFFERENT'} (max abs diff "
          f"{(probs - want).abs().max().item():.4g}); the tp program's launches "
          f"{launches}")
    shutil.rmtree(tp_dir, ignore_errors=True)
    shutil.rmtree(one_dir, ignore_errors=True)
    if not same or ops[0] != ops[1] or \
            ops[0] != {"cuda": ["biased_attn_fwd", "flash_attn_fwd", "layer_norm"]}:
        fail("tp2 export: the tp = 2 program is not the one-process program")
    if launches != CLIPSEG_SERVE:
        fail(f"tp2 export: the program launched {launches}")
    return launches


def tp_hold(label: str, got: dict, want: dict, witness: dict,
            other: str = "one process") -> None:
    """The losses of each step within LOSS_TOL (or DP_WITNESS_FACTOR times the
    witness's gap), the gradient each update applied by `worst_leaf` within
    GRAD_REL_TOL and GRAD_COS_MIN (or as much wider as the witness earns);
    `want` is `other`'s run."""
    loss_cap = max(LOSS_TOL, DP_WITNESS_FACTOR * witness["loss"])
    (wcos, wcos_leaf), (wrel, wrel_leaf) = witness["grads"]
    rel_cap = max(GRAD_REL_TOL, DP_WITNESS_FACTOR * wrel)
    cos_cap = min(GRAD_COS_MIN, 1 - DP_WITNESS_FACTOR * (1 - wcos))
    gaps = [abs(a - b) for a, b in zip(got["losses"], want["losses"], strict=True)]
    print(f"{label}: losses " + " ".join(f"{x:.6f}" for x in got["losses"])
          + f" against {other} " + " ".join(f"{x:.6f}" for x in want["losses"])
          + f"; largest gap {max(gaps):.4g} (bound {loss_cap:.4g}; the witness, "
          f"kernel against plain path at tp = 1: {witness['loss']:.4g})")
    ok = max(gaps) <= loss_cap
    for i, (g, w) in enumerate(zip(got["applied"], want["applied"], strict=True)):
        (cos, cos_leaf), (rel, rel_leaf) = worst_leaf(g, w)
        print(f"{label}: update {i + 1}, the gradient applied: least cosine "
              f"{cos:.7f} ({cos_leaf}; at least {cos_cap:.4g}), largest max abs "
              f"diff {rel:.4g} of its leaf's largest entry ({rel_leaf}; bound "
              f"{rel_cap:.4g}); the witness {wcos:.7f} ({wcos_leaf}), {wrel:.4g} "
              f"({wrel_leaf})")
        ok = ok and cos >= cos_cap and rel <= rel_cap
    if not ok:
        fail(f"{label}: tensor parallel and one process disagree beyond the bounds")


def phase_tensor_parallel(fa) -> dict:
    """Phase 31 (see the module docstring). Returns {path: counts}; the
    counts of the ranks' paths are rank 0's."""
    import torch

    t_phase = time.perf_counter()
    by_path = {}
    refs = tp_references(fa)
    two = dp_spawn("tp2", 2, "gloo")
    # (e)'s one-process export while the two ranks run
    one_export = tp_one_process_export()
    ranks = dp_collect(*two, "tp2", "tp2")
    # (c)'s ranks run while (a), (b) and (d) are read
    four = dp_spawn("dp2tp2", 4, "gloo")
    r0, r1 = ranks
    card = CARD[0]

    # (a)
    a0, a1, ref = r0["coop"], r1["coop"], refs["coop"]
    same = all(torch.equal(a0["trainable"][n], a1["trainable"][n])
               for n in a0["trainable"])
    probs_same = torch.equal(a0["serve"]["probs"], a1["serve"]["probs"])
    diff = (a0["serve"]["probs"].float() - ref["probs"]).abs()
    wmax, wmean = ref["witness"]["probs"].max().item(), ref["witness"]["probs"].mean().item()
    pmax = max(PROB_MAX_TOL, DP_WITNESS_FACTOR * wmax)
    pmean = max(PROB_MEAN_TOL, DP_WITNESS_FACTOR * wmean)
    whole, mine = a0["frozen"]
    print(f"tp2 coop ({card}): CLIPSeg rd64 CoOp(3, 4) b64 dedup at {IMG}^2 on two "
          f"gloo ranks on cuda:0, one model group; {a0['local_heads']} of 12 "
          f"vision heads a rank; frozen parameters {whole} bytes at tp = 1 "
          f"(one process: {ref['frozen']}), {mine} / {a1['frozen'][1]} on the two "
          f"ranks at tp = 2 ({mine / whole:.4f})")
    print(f"tp2 coop: the b64 request: the ranks' probabilities "
          f"{'bit-identical' if probs_same else 'DIFFERENT'}; against one process "
          f"max {diff.max().item():.4g} (bound {pmax:.4g}), mean "
          f"{diff.mean().item():.4g} (bound {pmean:.4g}); the witness {wmax:.4g} / "
          f"{wmean:.4g}; launches {a0['serve']['launches']}, collective bytes "
          f"{a0['serve']['bytes']} a rank")
    print(f"tp2 coop: a step {a0['ms']:.1f} ms (median, rank 0), peak device "
          f"memory {a0['peak']} / {a1['peak']} bytes on the two ranks, "
          f"collective bytes a step {a0['bytes']} / {a1['bytes']}; launches "
          f"{a0['launches']} / {a1['launches']} over {len(a0['losses'])} steps; the "
          f"ranks' trainable "
          f"state after the steps {'bit-identical' if same else 'DIFFERENT'}")
    tp_hold("tp2 coop", a0, ref, ref["witness"])
    if not (same and probs_same) or diff.max().item() > pmax \
            or diff.mean().item() > pmean:
        fail("tp2 coop: the ranks disagree, or the request is not one process's")
    if a0["serve"]["launches"] != CLIPSEG_SERVE or \
            a0["launches"] != tuple(len(a0["losses"]) * c for c in CLIPSEG_COOP_STEP):
        fail(f"tp2 coop: launches {a0['serve']['launches']} / {a0['launches']}")
    if not (mine < whole and all(b > 0 for b in a0["bytes"])):
        fail("tp2 coop: the frozen tensors were not sliced, or nothing was reduced")
    by_path["serve_tp2_coop"] = a0["serve"]["launches"]
    by_path["train_tp2_coop"] = a0["launches"]
    by_path["serve_exported_tp2_coop"] = tp_export_hold(fa, a0, one_export)
    del one_export

    # (b)
    for strategy, per_step, tokens in (("coop", CLIPSEG_COOP_STEP, 442),
                                       ("maple", CLIPSEG_VISUAL_STEP, 446)):
        plain, seq = r0[f"sp0 {strategy}"], r0[f"sp1 {strategy}"]
        bits = plain["losses"] == seq["losses"] and all(
            torch.equal(g[n], h[n]) for g, h in zip(plain["applied"], seq["applied"])
            for n in g)
        print(f"tp2 sp336 {strategy}: {TP_SP_IMG}^2 ({tokens} vision tokens, "
              f"{tokens // 2} a rank between the blocks; the 77 text tokens "
              f"replicated): losses " + " ".join(f"{x!r}" for x in seq["losses"])
              + " with the stream sequence-sharded, "
              + " ".join(f"{x!r}" for x in plain["losses"]) + " without: "
              + ("bit for bit, losses and the gradients applied" if bits
                 else "NOT bit for bit")
              + f" ({len(seq['applied'][0])} trainable leaves); collective bytes a "
              f"step a rank {seq['bytes']} (without: {plain['bytes']}); a step "
              f"{seq['ms']:.1f} ms (without: {plain['ms']:.1f}); peak {seq['peak']} "
              f"bytes (without: {plain['peak']}); launches {seq['launches']}")
        if strategy == "coop":
            tp_hold("tp2 sp336 coop", seq, plain,
                    {"loss": 0.0, "grads": ((1.0, ""), (0.0, ""))}, "tp = 2 alone")
        else:
            # the contexts' gradient sums in the sharded stream's order: held
            # to the kernel-vs-plain bounds, and both sides against one process
            ref = refs["maple"]
            tp_hold("tp2 sp336 maple", seq, plain, ref["witness"], "tp = 2 alone")
            for name, got in (("tp2 336 maple", plain), ("tp2 sp336 maple", seq)):
                tp_hold(f"{name} (against one process)", got, ref, ref["witness"])
        if seq["launches"] != tuple(TP_SP_STEPS * c for c in per_step):
            fail(f"tp2 sp336 {strategy}: launches {seq['launches']}")
        by_path[f"train_tp2_sp336_{strategy}"] = seq["launches"]

    # (d)
    d0, d1, dref = r0["cris"], r1["cris"], refs["cris"]
    same = all(torch.equal(d0["trainable"][n], d1["trainable"][n])
               for n in d0["trainable"])
    print(f"tp2 cris flat coop: CRIS RN50 CoOp b{TP_CRIS_BATCH} at {CRIS_IMG}^2 on "
          f"layout=flat (the attention pool's heads gathered before c_proj), frozen "
          f"parameters {d0['frozen'][0]} -> {d0['frozen'][1]} bytes a rank; a step "
          f"{d0['ms']:.1f} ms, peak {d0['peak']} bytes, collective bytes "
          f"{d0['bytes']}; launches {d0['launches']}; the ranks' trainable state "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    tp_hold("tp2 cris flat coop", d0, dref, dref["witness"])
    if not same or d0["launches"] != CRIS_FLAT_COOP_STEP:
        fail(f"tp2 cris flat coop: ranks differ or launches {d0['launches']}")
    by_path["train_tp2_cris_flat_coop"] = d0["launches"]

    # (c)
    ranks = dp_collect(*four, "dp2tp2", "dp2 tp2")
    c0 = ranks[0]
    acc = r0["accumulated"]
    (cos, cos_leaf), (rel, rel_leaf) = worst_leaf(c0["applied"][0], acc["applied"])
    same = all(torch.equal(c0["trainable"][n], r["trainable"][n])
               for r in ranks[1:] for n in c0["trainable"])
    print(f"dp2 tp2 coop: four gloo ranks on cuda:0 as (data, model) "
          f"{[r['grid'] for r in ranks]}, b{TP_DP_BATCH} a data rank: the gradient "
          f"the update applied against two accumulated b32 micro-steps at tp = 2: "
          f"least cosine {cos:.7f} ({cos_leaf}), largest max abs diff {rel:.4g} of "
          f"its leaf's largest entry ({rel_leaf}; bound {DDP2_GRAD_REL_TOL}); loss "
          f"{c0['losses'][0]:.6f} (the accumulated {acc['loss']:.6f}); the four "
          f"ranks' trainable state {'bit-identical' if same else 'DIFFERENT'}; a "
          f"step {c0['ms']:.1f} ms, peak {c0['peak']} bytes, collective bytes "
          f"{c0['bytes']} (model group); launches {c0['launches']}")
    tp_hold("dp2 tp2 coop (against one process's b64 step)",
            {"losses": c0["losses"], "applied": c0["applied"]},
            {"losses": refs["coop"]["losses"][:1], "applied": refs["coop"]["applied"][:1]},
            refs["coop"]["witness"])
    if not same or rel > DDP2_GRAD_REL_TOL or c0["launches"] != CLIPSEG_COOP_STEP:
        fail("dp2 tp2 coop: the ranks differ, DDP's gradient is not the accumulated "
             "one, or the launches are off")
    by_path["train_dp2tp2_coop"] = c0["launches"]

    # every kernel at the local shapes the paths above launched it at
    shapes = {**r0["shapes"], "train_dp2tp2_coop": c0["shapes"]}
    tp_kernel_checks(fa, shapes, {p: by_path[p] for p in shapes if p in by_path})
    print(f"tp: phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


def phase_kernels_variants(sweeps, library):
    """The sweeps' entry points, one pass per sweep: every variant against
    its plain version on q, k, v apart and standard normal (`check_variants`:
    a mismatch ends the run), then, with the variants' launch counts set to 0
    before and read after, timed on the sweep's own inputs at the least number
    of launches the script takes (`time_variants`). The v2 sweep runs at its
    own shape (512 with the keys from 485 on masked) and at the vision shape.
    Returns ({"S1".."S4": {tag @ shape: numbers}}, {"S1".."S4": launches})."""
    from tunevlseg_torch.ops import flash_attention_variants as fav
    results = {"S1": {}, "S2": {}, "S3": {}, "S4": {}}
    launches = dict.fromkeys(results, 0)
    b, h, d = BATCH, 12, 64
    for sweep, owners, label, at in (
            ("hg", ("S1",), "vision", None),
            ("v2", ("S2", "S3"), "vision kv_valid", None),
            ("v2", ("S2", "S3"), "vision", (485, None)),
            ("grid", ("S4",), "vision", None)):
        s, kv = at or sweeps.SWEEPS[sweep][1:3]
        checked = sweeps.check_variants(sweep, b, h, at)
        fav.reset_launch_count()
        rows = sweeps.time_variants(sweep, checked, 20, b, h, at=at)
        grew = (fav.launch_count("variant"), fav.launch_count("ones_column"))
        for owner, n in zip(owners, grew):
            launches[owner] += n
        if grew[len(owners):] not in ((), (0,)):
            fail(f"sweep {sweep}: launched S3 {grew[1]} times, it has no S3 row")
        print(f"sweep {sweep} @ {label}: launches while timing "
              + ", ".join(f"{o} {n}" for o, n in zip(owners, grew)))
        ms_of = {row["tag"]: row["ms"] for row in rows}
        if sweep == "v2":
            control = ms_of["hg1 exp2 (K1's choices)"]
            print(f"sweep v2 @ {label}: control row hg1 exp2 {control:.4f} ms beside "
                  f"K1 {ms_of['K1']:.4f} ms in the same turns (the same instance of "
                  f"the forward body; ratio {control / ms_of['K1']:.3f})")
        for row in rows:
            if row["max_abs_err"] is None:      # K1's row and the yardstick's
                continue
            tag, kw = row["tag"], row["kw"]
            owner = owners[-1 if "S3" in tag else 0]
            # the two products alone take no mask: they run over every key
            t_valid = s if kw.get("gemm_only") else (kv or s)
            bound_ms, bound_by, flops = attention_bound(4, 4, b, s, h, d, t_valid)
            ms = row["ms"]
            print(f"kernel {owner} {tag} {label} q{(b, s, h, d)} kv_valid {kv}: "
                  f"max_abs_err {row['max_abs_err']:.6g} (bound {KERNEL_TOL} of "
                  f"the largest |reference| {row['ref_max']:.4g}), kernel "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                  f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({100 * bound_ms / ms:.1f}% reached)")
            results[owner][f"{tag} @ {label}"] = {
                "max_abs_err": row["max_abs_err"], "ms": ms,
                "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library[label][0]}
    return results, launches


# --- Slice B: the five strategies beyond CoOp --------------------------------

def strategy_paths(fa, family: str, strategy: str, profile: bool, *,
                   dedup: bool, serve: tuple, step: tuple, all_requests: bool,
                   warmup: int, steps: int, img: int = IMG, pad_id: int = 49407,
                   seed: int = 30, prob_tol: tuple = (PROB_MAX_TOL, PROB_MEAN_TOL)):
    """One model of `strategy`, served and trained. Serving: the three
    requests (or the b64 one alone) through `task_predict_fn`, the launches
    per forward, kernel path against plain path. Training: `warmup` + `steps`
    b64 steps with the launches per step; every trainable leaf that got a
    gradient moves, every frozen tensor and buffer stays bit-identical and
    without a gradient; the first step against the plain path. Returns (the
    serving counts, the training counts)."""
    import torch

    from tunevlseg_torch.serving import task_predict_fn

    tag = f"{'cris ' if family.startswith('CRIS') else ''}{strategy}"
    task, state = build_task(family, strategy, 2e-4)
    model = task.model
    params = dict(model.state_dict())
    predict = task_predict_fn(task)
    requests = three_requests(seed, img, pad_id)
    if not dedup:
        requests = requests[1:]
    if not all_requests:
        requests = requests[:1]
    what = "b64 dedup" if dedup else "b64 dense"
    probs, serve_launches = serve_requests(
        fa, f"serve {tag}", predict, params, requests, img, serve,
        reps=5 if all_requests else 2)
    compare_with_plain_path(fa, f"serve {tag}", predict, params, requests[0][1],
                            probs, what, prob_tol)
    if profile:
        for label, req, _ in requests[::max(1, len(requests) - 1)]:
            profile_calls(f"serve {tag} {label}", lambda: predict(params, req))
    del probs

    batch = make_train_batch(BATCH, text_dedup=int(dedup), seed=seed + 1, img=img,
                             pad_id=pad_id)
    if (batch["input_ids"].shape[0] == 1) != dedup:
        fail(f"train {tag}: collate gave {batch['input_ids'].shape[0]} prompt rows")
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    if not all(n.startswith(("learner.", "additive_", "residual_ratio"))
               for n in trainable):
        fail(f"train {tag}: trainable leaves {trainable}")
    state, _, train_launches = timed_steps(fa, task, state, batch, f"train {tag}",
                                           warmup=warmup, steps=steps,
                                           per_step=step)
    now = model.state_dict()
    named = dict(model.named_parameters())
    unread = [n for n in trainable if named[n].grad is None]
    if unread not in ([], ["residual_ratio"]):
        fail(f"train {tag}: trainable leaves without a gradient: {unread}")
    for name in trainable:
        if name not in unread and torch.equal(now[name], start[name]):
            # q and k of the Shared-Attention projector attend over one key:
            # their gradient is exactly zero, and without weight decay so is
            # their update
            if ".self_attn.q_proj." in name or ".self_attn.k_proj." in name:
                if bool(named[name].grad.any()):
                    fail(f"train {tag}: {name} has a gradient and did not move")
                continue
            fail(f"train {tag}: trainable leaf {name} did not change")
    for name, value in now.items():
        if name not in trainable:
            if not torch.equal(value, start[name]):
                fail(f"train {tag}: frozen tensor or buffer {name} changed")
            if name in named and named[name].grad is not None:
                fail(f"train {tag}: frozen tensor {name} got a gradient")
    print(f"train {tag}: {len(trainable) - len(unread)} trainable leaves moved "
          f"(learner{', additive head' if any(n.startswith('additive') for n in trainable) else ''}; "
          f"never read: {unread or 'none'}); {len(now) - len(trainable)} frozen "
          "tensors and buffers bit-identical, none with a gradient")
    leaves = ["learner.context_vectors"]
    leaves += [n for n in trainable if n.endswith(("proj_0.out.weight",
                                                   "proj_0.linear2.weight"))][:1]
    first_step_kernel_vs_plain(fa, f"train {tag}", task, start, batch,
                               tuple(leaves))
    if profile:
        profile_step(tag, task, task.init(), batch)
    return serve_launches, train_launches


def phase_slice_b(fa, profile: bool) -> dict:
    """MaPLe at depth (three requests, 2 + 5 steps), then VPT, the two shared
    strategies and CoCoOp on CLIPSeg and CoCoOp on CRIS (one b64 request and
    a few steps each). Returns {path: counts}."""
    by_path = {}
    by_path["serve_maple"], by_path["train_maple"] = strategy_paths(
        fa, "CLIPSeg rd64", "maple", profile, dedup=True, serve=CLIPSEG_SERVE,
        step=CLIPSEG_VISUAL_STEP, all_requests=True, warmup=2, steps=5)
    for strategy in ("vpt", "shared_separate", "shared_attn"):
        by_path[f"serve_{strategy}"], by_path[f"train_{strategy}"] = strategy_paths(
            fa, "CLIPSeg rd64", strategy, False, dedup=True, serve=CLIPSEG_SERVE,
            step=CLIPSEG_VISUAL_STEP, all_requests=False, warmup=1, steps=2)
    by_path["serve_cocoop"], by_path["train_cocoop"] = strategy_paths(
        fa, "CLIPSeg rd64", "cocoop", profile, dedup=False,
        serve=CLIPSEG_COCOOP_SERVE, step=CLIPSEG_COCOOP_STEP,
        all_requests=False, warmup=1, steps=2)
    by_path["serve_cris_cocoop"], by_path["train_cris_cocoop"] = strategy_paths(
        fa, "CRIS RN50", "cocoop", False, dedup=False, serve=CRIS_SERVE,
        step=CRIS_COOP_STEP, all_requests=False, warmup=0, steps=1,
        img=CRIS_IMG, pad_id=0, seed=40, prob_tol=COCOOP_CRIS_PROB_TOL)
    return by_path


def profile_calls(label: str, fn, n: int = 3, wall: float = None):
    """Device-busy time of `n` calls of `fn` (the sum of kernel durations
    under torch.profiler) against the wall time of a call without the
    profiler (measured here over 5 calls unless given)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if wall is None:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        wall = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # device-side events that are kernels or copies: a user annotation (the
    # optimizer's step range) is mirrored on the device timeline and would
    # count its kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.step")]
    if not kernels:
        fail("profile: torch.profiler recorded no device time")
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e6
    print(f"profile {label} ({n} calls under torch.profiler): device busy "
          f"{busy * 1e3:.3f} ms of the {wall * 1e3:.3f} ms call, idle share "
          f"{1 - busy / wall:.3f}, {sum(e.count for e in kernels) / n:.0f} "
          "device kernels per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile {label}:   {e.self_device_time_total / n / 1e3:8.3f} "
              f"ms  x{e.count / n:6.1f}  {e.key[:90]}")


def profile_step(label: str, task, state, batch, steps: int = 5):
    """Where a train step's time goes: the spans of forward, backward and
    optimizer on the device's timeline (CUDA events at the boundaries, one
    synchronize at the end of each step, so a span holds the device's idle
    gaps too), then the device-busy time of whole steps against that step
    time."""
    import torch

    opt = state.optimizer
    spans = {"forward": [], "backward": [], "optimizer": []}
    walls = []
    for _ in range(steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        marks[0].record()
        loss, _ = task._loss(batch, state.step, state.model_state, {})
        if isinstance(loss, dict):      # DenseCLIPTask: the loss and its parts
            loss = loss["loss"]
        marks[1].record()
        loss.backward()
        marks[2].record()
        opt.step()
        marks[3].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for key, first, last in zip(spans, marks, marks[1:]):
            spans[key].append(first.elapsed_time(last))
    wall = statistics.median(walls)
    print(f"profile {label} step: wall {wall * 1e3:.3f} ms (median of {steps}); "
          "device-timeline spans " + ", ".join(
              f"{key} {statistics.median(v):.3f} ms" for key, v in spans.items()))
    holder = [state]

    def step():
        holder[0], _ = task.train_step(holder[0], batch)

    profile_calls(f"{label} step", step, wall=wall)


def main() -> None:
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention as fa

    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()

    def clock(done: str) -> None:
        print(f"chip_smoke: {done} at {time.perf_counter() - t_start:.1f} s")

    name, count = phase_device()
    phase_build()
    clock("kernels built")
    # every kernel's device time by torch.profiler is taken first: once the
    # yardstick's scaled_dot_product_attention had run, the profiler's short
    # windows came back without the launches they made, for the rest of the
    # run (a diagnostic call on the card)
    k1 = phase_kernels(fa)
    k2 = phase_kernels_bwd(fa)
    k3 = phase_kernels_k3(fa)
    for numbers, more in zip((k1, k2, k3), phase_kernels_d96(fa)):
        numbers.update(more)
    clock("attention kernels checked")
    k4 = phase_kernels_k4(cf)
    k4.update(phase_kernels_k4_upsampler(cf))
    k4.update(zs_k4_cases(cf))
    k4_backward, k4_prologue = phase_kernel_k4_backward(cf)
    clock("K4 checked")
    n1_numbers = phase_kernel_n1()
    clock("N1 checked")
    library = phase_yardstick()
    library.update(phase_yardstick(D96_SHAPES))
    by_path = {"serve": phase_serve(fa),
               "train_coop": phase_train_coop(fa, profile),
               "train_e2e": phase_train_e2e(fa, profile),
               "train_fit_coop": phase_fit_coop(fa)}
    clock("CLIPSeg paths")
    by_path.update({"serve_cris": phase_serve_cris(fa, profile),
                    "train_cris_coop": phase_train_cris(fa, profile),
                    "serve_cris_flat": phase_serve_cris_flat(fa, profile),
                    "train_cris_flat_coop": phase_train_cris_flat(fa)})
    by_path["train_cris_e2e"], by_path["train_cris_e2e_flat"] = \
        phase_train_cris_e2e(fa, profile)
    clock("CRIS paths")
    by_path.update(phase_slice_b(fa, profile))
    clock("slice B paths")
    by_path.update(phase_trans_seg(fa, profile))
    clock("trans_seg paths")
    by_path.update(phase_phrasecut(fa, profile))
    clock("phrasecut paths")
    by_path.update(phase_denseclip(fa, profile))
    clock("denseclip paths")
    by_path.update(phase_zero_shot(fa, cf, profile))
    clock("zero-shot RIS paths")
    by_path.update(phase_checkpoints(fa, cf))
    clock("checkpoint paths")
    tss_paths, tss_task, tss_request = phase_trans_seg_siglip(fa, profile)
    by_path.update(tss_paths)
    clock("trans_seg_siglip paths")
    export_paths, _ = phase_export(fa, tss_task, tss_request, profile)
    by_path.update(export_paths)
    del tss_task, tss_request
    clock("export paths")
    by_path.update(phase_accumulate_remat(fa, profile))
    clock("accumulation and remat paths")
    by_path.update(phase_data_parallel(fa))
    clock("data parallel paths")
    by_path.update(phase_captured(fa, profile))
    clock("captured train steps")
    by_path.update(phase_tools(fa))
    clock("tools paths")
    by_path.update(phase_tensor_parallel(fa))
    clock("tensor parallel paths")
    sweeps = load_script("torch_micro_attn.py")
    variants, sweep_launches = phase_kernels_variants(sweeps, library)

    for label, (fwd_ms, bwd_ms) in library.items():
        k1[label]["library_ms"], k2[label]["library_ms"] = fwd_ms, bwd_ms

    # the launches are those of the main paths, each counted from 0; the
    # times are for K1's and K2's CLIPSeg vision shape, K3's CRIS cross shape
    # and K4's stage-1 3x3 shape, max_abs_err the largest over every shape
    # checked. K4's launches are its forward and dx launches together.
    def entry(indices: tuple, name: str, source: str, replaces: str,
              numbers: dict, main: str, library_ms: float) -> dict:
        def launched(c):
            return sum(c[i] for i in indices)

        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launched(c) for c in by_path.values()),
                "launches_by_path": {p: launched(c) for p, c in by_path.items()},
                **numbers[main], "library_ms": library_ms,
                "max_abs_err": max(r["max_abs_err"] for r in numbers.values()),
                "by_shape": numbers}

    kernels = [
        entry((0,), "K1 flash_attn_fwd (unbiased self-attention forward, lse "
              "written when a gradient is wanted; wgmma from a TMA ring, two "
              "consumer warpgroups)",
              "tunevlseg_torch/csrc/flash_attn_fwd.cu",
              "tunevlseg_tpu/ops/flash_attention.py:80", k1, "vision",
              library["vision"][0]),
        entry((1,), "K2 flash_attn_bwd (self-attention backward: a dq pass with a delta "
              "sweep, then a dk/dv pass; wgmma from TMA rings, p from K1's lse)",
              "tunevlseg_torch/csrc/flash_attn_bwd.cu",
              "tunevlseg_tpu/ops/flash_attention.py:227", k2, "vision",
              library["vision"][1]),
        entry((2,), "K3 flash_attn_bias_fwd (biased / cross-attention forward; "
              "wgmma from TMA, 80-key tiles resident while double-buffered "
              "128-row query tiles stream past them, one block per SM)",
              "tunevlseg_torch/csrc/flash_attn_bias_fwd.cu",
              "tunevlseg_tpu/ops/flash_attention.py:140", k3, "cris cross",
              k3["cris cross"]["library_ms"]),
        entry((3, 4), "K4 conv_flat (flat guard-banded convolution, forward and "
              "as its own dx)", "tunevlseg_torch/csrc/conv_flat.cu",
              "tunevlseg_tpu/ops/conv_pallas.py:262", k4, K4_MAIN,
              k4[K4_MAIN]["library_ms"]),
    ]
    kernels[3]["dx_launches_by_path"] = {p: c[4] for p, c in by_path.items()}
    kernels[3]["backward"] = k4_backward
    # K4's backward prologue: one launch per backward of a flat convolution,
    # so on the path whose backbone trains; the TPU package leaves that work
    # to XLA inside the backward of `conv_flat`
    kernels.append({
        "name": "K4 dy prologue (the flat convolution's backward: masked, scaled "
                "and plain dy in one pass, per-block sums for d_offset)",
        "route": "cuda", "source": "tunevlseg_torch/csrc/conv_flat.cu",
        "replaces": "tunevlseg_tpu/ops/conv_pallas.py:480",
        "launches": sum(c[5] for c in by_path.values()),
        "launches_by_path": {p: c[5] for p, c in by_path.items()},
        **k4_prologue})
    # N1 runs in the LayerNorms of the bf16 blocks on the card: (forward,
    # backward launches, calls on the plain chain) by path, from each path's
    # own run; None where a path's counts came from other processes (ranks)
    n1_by_path = {p: getattr(c, "n1", None) for p, c in by_path.items()}
    for path, c in n1_by_path.items():
        print(f"N1 on the {path} path: " + ("counted in other processes" if c is None
              else f"{c[0]} forward launches, {c[1]} backward, {c[2]} calls on "
                   "the plain chain"))
    kernels.append({
        "name": "N1 layer_norm (one pass over a row held in registers: f32 "
                "statistics, bf16 in and out; its backward with deterministic "
                "partial sums of dw and db)",
        "route": "cuda", "source": "tunevlseg_torch/csrc/layer_norm.cu",
        "replaces": "none: XLA fuses the JAX package's LayerNorm",
        "launches": sum(c[0] for c in n1_by_path.values() if c is not None),
        "launches_by_path": n1_by_path,
        **n1_numbers["vit"], "by_shape": n1_numbers})
    # S1-S4 are on no model's path: their main path is the sweeps' entry
    # point, and their launches are those it made while timing. Their counts
    # were read beside the other kernels' on every model path
    # (`launches_by_path`) and must be 0 there. The numbers are those of the
    # variant named in `main` at the vision shape.
    source = "tunevlseg_torch/csrc/flash_attn_fwd_variants.cu"
    for key, index, title, replaces, main in (
            ("S1", 6, "S1 attn_variant: hg heads per block; wgmma from a TMA ring, "
             "two consumer warpgroups", "scripts/micro_attn.py:60", "hg2 @ vision"),
            ("S2", 6, "S2 attn_variant: exp2 / no max pass / products alone / hg / "
             "block order; wgmma from a TMA ring, two consumer warpgroups",
             "scripts/micro_attn_v2.py:45", "ours (hg3) @ vision"),
            ("S3", 7, "S3 attn_ones_column: folded scale, mask row, denominator out "
             "of the P V step; wgmma from a TMA ring, two consumer warpgroups",
             "scripts/micro_attn_v2.py:113",
             "opt (S3) @ vision"),
            ("S4", 6, "S4 attn_variant: bg batch rows x hg heads per block, block "
             "order; wgmma from a TMA ring, two consumer warpgroups",
             "scripts/micro_attn_grid.py:29", "bg1 hg3 query @ vision")):
        numbers = variants[key]
        if sweep_launches[key] <= 0:
            fail(f"{title} was never launched by its sweep")
        kernels.append({
            "name": title, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sweep_launches[key],
            "launches_by_path": {p: c[index] for p, c in by_path.items()},
            **numbers[main],
            "max_abs_err": max(r["max_abs_err"] for r in numbers.values()),
            "main": main, "by_shape": numbers})
    # K1 and K3 run on every path, K2 on those that take a gradient, K4 on the
    # flat paths, and as dx where the flat convolutions' inputs train (the
    # CRIS backbone's full fine-tune, and the TransformerSegmentor's
    # upsampler behind its trainable decoder)
    training = tuple(p for p in by_path if p.startswith("train"))
    flat = tuple(p for p in by_path if "flat" in p)
    flat_training = ("train_cris_e2e_flat", "train_trans_seg_flat",
                     "train_ddp2_cris_flat_e2e", "train_captured_cris_e2e_flat")
    # zero-shot RIS runs ViTs of 197 tokens, under K1's gate: no K1 there
    zero_shot = tuple(p for p in by_path if p.startswith("serve_zsseg"))
    with_k1 = tuple(p for p in by_path if p not in zero_shot)
    # the zero-shot `limit` analysis runs FreeSOLO's proposals alone: no text
    with_k3 = tuple(p for p in by_path if not p.startswith("serve_zsseg_analysis_limit"))
    for kernel, paths in zip(kernels[:4], (with_k1, training, with_k3, flat)):
        for path in paths:
            if kernel["launches_by_path"][path] <= 0:
                fail(f"{kernel['name']} was never launched on the {path} path")
    for path in zero_shot:
        if by_path[path][0]:
            fail(f"{path} launched K1 {by_path[path][0]} times")
    for path, c in by_path.items():
        if not path.startswith("train") and c[1] != 0:
            fail(f"{path} launched K2 {c[1]} times; it takes no gradient")
        if path not in flat and (c[3] or c[4]):
            fail(f"{path} launched K4; it does not run the flat layout")
        if (c[4] > 0) != (path in flat_training):
            fail(f"{path}: {c[4]} K4 dx launches")
        if c[5] != c[4]:
            fail(f"{path}: {c[5]} launches of K4's backward prologue for {c[4]} dx")
        if c[6] or c[7]:
            fail(f"{path} launched a variant of K1 (S1/S2/S4 {c[6]}, S3 {c[7]}): "
                 "they are the sweeps' alone")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to here, "
          "the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
