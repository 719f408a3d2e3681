#!/usr/bin/env python3
"""Drive the PyTorch port (``lkgd_torch``) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``. Phases,
each printing its own lines; any failure raises and the script exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``lkgd_torch/csrc`` with ``nvcc`` for sm_90a;
3. each kernel against its plain PyTorch version at the main path's shapes: bf16 inputs
   through the kernel, the plain version in fp32 on the same inputs (flash max |d| <=
   FLASH_TOL * max|ref|, GroupNorm max |d| <= 3e-2 in bf16 and <= 1e-5 in fp32), with
   both times, the time of the PyTorch library call for the same function and the bound
   (the least time the card could take); the flash and GroupNorm kernels also at the
   frame-transition clip's shapes (56 and 4 rows) and the flash kernels at the whole-clip
   decode's (14, 9216, 1, 512), the plain flash version in row chunks; the key-norm kernel
   that feeds the bound kernels against its plain version at every flash case; at (2,
   9216, 1, 512) the flash kernels must beat their plain versions; GroupNorm at every
   shape class of the UNet step (levels 0-2, spatial and temporal), the trans clip's and
   the VAE's full resolution: the form ``fused_plan`` picks (one pass on a cluster, or
   statistics then normalise) asserted from the launch counters, the one-pass kernel's own
   a, b within 1e-4 relative of its plain merge order and its bits the same over two
   calls, one device operation a one-pass forward and at most three a two-pass one (memset,
   statistics with their fold, normalise), kernel 3's a, b within 1e-4 relative of the
   plain statistics, kernel 4 alone against its plain version, device times under
   ``torch.profiler`` beside the wrappers' (20 calls), the one-pass bound (x read once, y
   written once), fp32 statistics with mean 1e3 and std 1 against an fp64 reference,
   bit-identical over three calls, and the bf16 SiLU of both forms within a bf16 ulp of
   t * sigmoid(t) over t in [-20, 20];
3b. the two microbenchmark kernels against their plain versions: the blocked matmul at
   (258048, 320) x (320, 320 | 1280) and ragged shapes (max |d| <= 1e-2 * max|ref|), the
   flash variants at (140, 9216, 64) in every mode with all four tile shapes (max |d| <=
   1e-2 * max|ref|, 3e-2 where exp2 runs in bf16), the plain version in chunks of rows;
   each with its time, the library call's, the bound, its share of the bound and its
   multiple of the library;
3c. kernels 1, 2 and 1a at the CogVideoX-5B DiT's joint attention (2, 17776, 48, 64),
   ragged against the 128-row tiles (the plain version in blocks of one row and 4 heads),
   with the fallback tiles recomputed, and kernels 3 and 4 at the whole-clip decode's N=1
   shapes (1, 49x480x720, 128) and (1, 25x240x360, 256), past 2^31 elements (compared in
   row blocks), each with its plain version's time, the library call's and the bound;
3d. kernels 5/6, 7/8, 9/10 and 1a at the CogVideoX-5B fine-tune's (1, 17776, 48, 64), ragged
   against the 128-row tiles, each against its plain version in blocks of heads (the plain
   backward's fp32 P of all 48 heads would be 60.7 GB), with the tolerances of phase 6, the
   library call's time (``scaled_dot_product_attention`` forward, and its backward through
   autograd) and the bound;
3e. kernels 1, 2 and 1a at the SD2 UNet's level-0 and level-1 self-attention (2, 4096, 5,
   64), (2, 1024, 10, 64) and the image VAE's mid block (1, 4096, 1, 512); kernels 7/8,
   9/10, 5/6 and 1a at the SD-2D joint LoRA step's (2, 4096, 5, 64); kernels 3/4 at (2,
   4096, 320), eps 1e-6, with and without SiLU: each against its plain version with the
   tolerances of phases 3 and 6, its device time under ``torch.profiler`` beside its
   wrapper's (which of the two sets the pace), the library call's time and the bound;
3f. the fp32 form of kernels 1, 2 and 1a (``csrc/flash_attention_f32.cu``: 3xTF32 products on
   wgmma after a pre-pass) against the plain fp32 version (max |d| <= 2e-5 * max|ref|, TF32
   off) at the precompute encode's mid block (14, 4096, 1, 512), (1, 1024, 1, 64), (2,
   4096, 1, 512), an input that trips the guard and the fp32 inference path's (2, 9216, 5,
   64), (4, 2304, 10, 64) and (14, 9216, 1, 512): a second launch bit-identical, one C call
   a forward, device time (the form's kernel and its pre-pass) beside the wrapper's, the
   plain version's, the library's fp32 SDPA with the backend that served it and its own
   max |d|, and the bound of three TF32 products at 495 TFLOP/s (the fp32 FMA bound at 67
   TFLOP/s beside it);
3i. kernels 7, 8, 9 and 10 in fp32 (the LSE form of ``flash_fwd_tf32_kernel`` and the
   backward of ``csrc/flash_attention_bwd_f32.cu``: 3xTF32 on wgmma after its pre-pass, the
   wide kernel above D = 64) against their plain fp32 versions (TF32 off) at the fp32 LKGD
   fine-tune's level 0 (14, 4096, 5, 64) and level 1 (14, 1024, 10, 64), a ragged (2, 1100,
   5, 64) x 1030 keys, a guard input, D=40 x 900 keys and D=128: out within FP32_TOL x
   max|ref|, lse within FP32_TOL x max(1, max|lse|), dq, dk, dv within FP32_GRAD_TOL (1e-4)
   x max|ref|, a second launch and the one-call pair (``flash_bwd``) bit-identical, kernels
   5/6 bit-exact on fp32 rows; device time under the profiler (a backward kernel's with its
   pre-pass), the pair's from one C call (``pair_ms``), the plain version's, fp32 SDPA's
   forward or backward, and the bound at 495 TFLOP/s x3 TF32 with the 67 TFLOP/s fp32 FMA bound
   beside it; then the backward alone at WIDE_BWD_FP32's shapes, the x60 guard input also
   against a float64 witness (``_bwd_fp64``);
4. the tiny end-to-end pipeline at fp32 on the GPU against the same weights and noise on
   the CPU (latents and frames at rtol 1e-4, atol 2e-4);
3g. the fp32 form of kernels 1, 2 and 1a at Depth-Anything's DINOv2 attention, (1, 1370, 6,
   64) and (1, 1370, 12, 64), as 3f holds them, and kernels 3/4 in fp32 (eps 1e-5, no SiLU)
   at DPT-hybrid's BiT GroupNorm shapes (three at 384x384, all nine of 384x672) as phase 3
   holds them, each with the library call's time (fp32 SDPA, ``F.group_norm``) and the bound;
4i. at fp32, GPU against CPU, every parameter random: the tiny RAFT, the point tracker on it,
   a narrow RIFE (midpoint and 2x), tiny DPT-hybrid and DPT-large, and a tiny-width
   Depth-Anything at 462x462, whose 1090 tokens run the fp32 flash form on the card (4
   launches of each of its kernels asserted) and its plain version on the CPU;
3h. kernels 1, 2 and 1a at a Ulysses rank's (2, 17776, 24, 64) and kernels 7 and 8 at a ring
   rank's (2, 8888, 48, 64) queries (113 text + 8775 video rows) against one 8775-key video
   shard, as 3d holds them, with the library call's time and the bound; then the ring's merge
   of two shards' (out, lse) against one LSE call on the unsplit keys, with key norms 100x
   apart between the shards and with a shard scaled until rows fall back to kernel 8;
4j. at fp32, GPU against CPU with the same random weights: HED, PiDiNet, the line-art
   generator, Anime2Sketch, OpenPose, SegFormer, BLIP and CogVLM (logits; greedy ids equal),
   then each of the twelve label annotators through ``cli/annotate.py``'s build functions from one
   file on both, ``annotate.main`` on the card, and ``caption.main`` for BLIP and CogVLM on
   both (``phase_tiny_labels``);
4h. at fp32, GPU against CPU: the precompute encode at tiny widths on 64x64 frames (the fp32
   flash form at the VAE's mid block), InceptionV3 at 299 on 2 images, I3D on (1, 10, 64,
   64, 3), CLIP features and the Frechet distance of each device's features;
4g. the tiny SD-2D family at fp32, GPU against CPU, every parameter random: the 2D UNet
   (per-sample timesteps with ControlNet residuals; 9 channels with the conditioning
   encoder; joint ``conv_fuse`` attention with stream-masked LoRA and track fusion), the
   image VAE (encode, decode, round trip), ControlNet-2D, the CLIP text tower at -1 and
   -2, the inpaint (+ ControlNet-2D), joint-control (joint UNet, ``cond_y``, spatial mask,
   two pairs) and condition pipelines with the starting noise given, and one joint LoRA
   train step: loss, gradients (scaled as 7c's), then the update against the CPU's AdamW
   on the card's gradients;
4f. at fp32, GPU against CPU: the tiny CogVideoX train step of ``train_cogvideox_lora``'s
   LoRA and fusion with remat, i2v and t2v (loss, gradients scaled as 7c's, the update
   against the CPU's AdamW on the GPU's gradients), the tiny T5 encoder on explicit ids with
   a padding mask, and a tensor cache written from the card and read back;
4e. the tiny CogVideoX pipelines (I2V with DPM, T2V with DDIM, V2V with DPM, the 1.5 form)
   and the tiny CogVideoX VAE (encode and decode of a clip, chunked, tiled) the same way,
   every parameter random, the DPM noise injected;
4b. the tiny frame-transition pipeline (joint attention, flip, two stream-masked LoRA
   adapters, every parameter random) the same way, batched and with ``sequential_cfg``;
4c. the tiny smoothing pipeline (10 frames in 4-frame joint chunks from step 1 of 3, the
   offsets given) the same way, batched and with ``sequential_cfg``;
5. the full-size clip: 14 frames at 576x1024, 25 steps, CFG, bf16 random weights from a
   seeded generator; two clips (the first warms up), every kernel's launch count in the
   second, which must be > 0 for the four inference kernels and 0 for the four training
   ones (no gradient is asked for), and finite frames in [0, 1]; then one UNet step and
   one whole-clip decode under ``torch.profiler`` for their device time by kind;
5b. the full-size frame-transition clip through ``lkgd_torch/cli/run_inference_svd.py``'s
   ``build_pipeline`` (``--mode trans --flip --temporal --lora-rank 4``): 2 streams x 14
   frames at 576x1024, 25 steps, CFG batched as 56 UNet rows, bf16; a 2-step warm-up and a
   timed one with the denoise/decode split, peak memory, launch counts and fallback
   tiles; frames finite, the two streams different; one more clip with
   ``sequential_cfg`` on the warm-up's seed and 2-step schedule, for its time and peak
   memory and its distance from the warm-up's latents; then one UNet step under
   ``torch.profiler`` for its device time by kind;
5c. the full-width smoothing of a 50-frame 576x1024 synthetic video through the inference
   CLI's ``build_pipeline`` (``--mode smooth --flip --temporal --lora-rank 4``): 14-frame
   joint chunks from step 20 of 25, CFG batched as 4 x 5 chunks = 20 UNet rows of 14
   frames, bf16; a warm-up from step 24, then a timed run split into conditioning (timed
   alone), the denoising loop and the decode, with peak memory, launch counts (> 0 for the
   inference kernels, 0 for the others) and fallback tiles, frames finite and in [0, 1];
   then one UNet step of 20 x 14 rows under ``torch.profiler``;
4d. the tiny ControlNet pipeline (batched, ``sequential_cfg``, ``reverse_time``,
   trans+ControlNet at ``controlnet_cond_scale=0.5, controlnet_scale=0.8``), the tiny base
   pipeline with DeepCache at ``dc=2`` over 4 steps and the tiny flow pipelines (``flow``,
   ``flow_fix`` with ``conv_in2``, joint video+flow) the same way, every parameter random
   (the zero-init heads, ``conv_in2`` and its alpha included);
5d. the full-width ControlNet clip through ``build_pipeline`` (``--mode controlnet``: a
   ControlNet at the UNet's widths, embedder (16, 32, 96, 256), its zero-init heads filled
   with 0.02 x normal, a synthetic 14-frame control video), 14x576x1024, 25 steps, bf16: a
   warm-up, a timed batched clip (28 UNet rows) and a timed ``sequential_cfg`` clip with
   their splits, peaks and launches, then one step under ``torch.profiler``, the ControlNet
   and the UNet with its residuals apart;
5e. the base clip at ``deep_cache_interval`` 1, 2 and 3 on one pipeline and seed: sec/clip,
   the full and cached steps (25/0, 13/12, 9/16), launches, the latents' relative distance
   from ``dc=1``'s (printed, not gated: DeepCache is an approximation); one full and one
   cached UNet call of 28 rows, whose launches of every inference kernel must be fewer when
   cached, and both under ``torch.profiler``;
5f. the full-width flow clip through ``build_pipeline`` (``--mode flow``, the frame its own
   flow condition): sec/clip, launches, finite frames in [0, 1];
5g. the CogVideoX-5B I2V at full width through ``lkgd_torch/cli/run_inference_cogvideox.py``'s
   ``build``, ``encode`` and ``decode`` (42 layers x 48 heads, knowledge fusion with its
   zero-init output 0.02 x normal, synthetic T5 tokens and width-1000 knowledge features,
   DPM with dynamic CFG, bf16): a warm-up DiT step, then the encode of one 480x720 frame, 3
   DPM steps (first order, 2M, final) with each step's seconds and the whole-clip decode of
   13 latent frames to 49x480x720, with peaks, launches (kernels 1, 2 and 1a 42 times a
   step) and fallback tiles, latents and frames finite; one DiT step under
   ``torch.profiler``; the decode chunked (2 latent frames) and tiled (60x90 and 30x45
   latent tiles), each timed with its peak; then DDIM inversion (``utils/inversion.py``) of the
   decoded clip's chunked encode, 13x60x90 latents, over a 3-step schedule with the DiT's
   eps (one conditional row): seconds a step, launches 42 a step asserted;
5i. sequence parallelism (``phase_sp_pair``): two processes on the one card over gloo (NCCL
   refuses two ranks on one card; every collective goes through the host), each building the
   CogVideoX-5B DiT through the CLI's ``build`` with ``--mesh context=2 --sequence-parallel
   ring`` (weights checked equal by a checksum all-reduce): the joint attention at (2, 17776,
   48, 64), Ulysses and ring, against the plain version (blocks of 4 heads) and one flash call
   on the whole sequence; one full-width ring DiT step (CFG, 49x480x720, bf16) against the
   unsharded step on rank 0 (max |d| <= SP_TOL x max|ref|; beside it the unsharded step
   through kernel 2 instead of 1, bf16's own spread), with its seconds (two ranks
   time-slicing one card: no scaling figure), the peak of each rank and the launches a rank
   (kernels 7/8 and 1a twice a layer, the 226-key text block plain, asserted); one Ulysses
   DiT step at full width on the PAR_FRAMES clip of 5k (2 x 5626 tokens: the 49-frame step
   is cut for the smoke's time) against the unsharded step of that clip, its launches a rank
   (kernels 1, 2 and 1a once a layer) asserted;
5k. weights, rows and frames split (``phase_par_pair``): a second pair of processes on
   cuda:0 over gloo. The CogVideoX-5B DiT built by the CLI's ``build`` with ``--mesh model=2``,
   tensor parallel (24 heads a rank) and then FSDP, one CFG step of a 13-frame clip (2 x 5626
   tokens, full width: the 49-frame step's 84 all-reduces of 437 MB through the host do not
   fit the smoke's time) against the unsharded step of the same seed on rank 0 (TP within
   SP_TOL, FSDP bit-identical), with seconds, peak and weight bytes a rank and 42 launches of
   kernels 1, 2 and 1a a rank asserted; the SVD base clip at 14x576x1024 (PAR_SVD_STEPS steps)
   through ``run_inference_svd.build_pipeline`` with ``--data-parallel 2`` and with
   ``--context-parallel 2`` against the unsharded pipeline and, for the floor, its
   ``--sequential-cfg`` run (one row a call, as a data rank's), the frames of the same latents
   bit-identical (the decode's chunks spread over context), launches a rank equal to the
   unsplit loop's; ``--mode`` trans (``--flip --temporal --lora-rank 4``), smooth (28 frames
   from step 24, decode chunks of 14, ``--sequential-cfg``: two ranks' batched loops do not
   fit on one card), controlnet and flow (decode chunks of 7) at full size,
   one step each, through ``build_pipeline`` with ``--context-parallel 2`` (PAR_MODES): the
   loop whole on each rank (no loop group, no UNet module gathering frames), the latents
   equal on both ranks by a checksum all-reduce and bit for bit the unsplit loop's on rank 0,
   the frames bit for bit the unsplit decode's (one chunk of every two a rank), launches a
   rank equal to the unsplit loop's, denoise and decode seconds and peaks;
   ``train_svd_lora.build`` over both ranks with ZeRO (``zero_shard_opt_state``), one step
   at 512x512x8f on a rank's row of a 2-row batch: the averaged gradients bit for bit
   those of this process's one-row passes averaged, within max(1e-2, 1.5 x their own
   distance) of one process's step on the whole batch, moment bytes a rank, launches a rank
   equal to one process's;
5l. pipeline parallelism (``phase_pp_pair``): a third pair of processes on cuda:0 over gloo,
   each building the CogVideoX-5B DiT through the CLI's ``build`` with ``--mesh stage=2``
   (the whole model a rank, as the JAX CLI), one CFG step of the PAR_FRAMES clip whole, then
   ``parallel/pp.py`` ``cogvideox_pp_blocks`` over the stage group (21 blocks a rank, the
   other 21 dropped) at M=1 (bit-identical to the whole step) and M=2 (within PP_TOL, and bit
   for bit the whole model on one CFG row at a time), weights a rank about half, kernels 1,
   2 and 1a M x 21 times a rank asserted;
5j. ``cli/web_demo.py`` in ``base`` mode at full width (14x576x1024, 25 steps) on an
   ephemeral port: two POSTs with different seeds, each a 200 whose mp4 OpenCV decodes to 14
   frames of 576x1024, seconds a request, the inference kernels launched from the server's
   handler thread;
5h. SD2 at 512x512, bf16, random weights from a seed: inpaint, 50 DDIM steps, guidance 7.5,
   through ``lkgd_torch/cli/run_inference_sd2d.py``'s ``build`` and ``denoise`` (a warm-up
   image, then a counted one: s/image split into denoise and decode, peak, launches of
   kernels 1, 2 and 1a asserted at 10 a UNet step and 2 for the VAE; one UNet step under
   ``torch.profiler``); inpaint with ControlNet-2D (zero-init heads 0.02 x normal, 14 a
   step); joint control as the CLI builds it (no joint attention) and with a joint UNet
   (``post="conv"``, mask (0, 1, 0, 1), 20 a step); the CLIP-H text tower on 77 token ids
   at -1 and -2; one UNet forward of a (src, dst) pair with 256 point tracks at
   ``track_fusion`` (``conv_fuse`` 0.02 x normal), against the same forward without;
6. the training kernels (head split and merge, flash LSE forwards, dq and dk/dv
   backwards) against their plain versions at the fine-tune's shapes, ragged S, S_q !=
   S_k, D=128 and the huge-norm input that trips the LSE forward's fallback: split/merge
   bit-exact, grouped (three projection views a launch, the library being three
   ``transpose().contiguous()`` calls) and single, with a line of the relayout wrappers'
   host microseconds a call, out max |d| <= FLASH_TOL * max|ref|, lse within 1e-2 log2
   units, dq/dk/dv max |d| <= 2e-2 * max|ref| and bit-identical over two launches, with
   the backward plan's blocks and waves, the pair's time as a multiple of the library
   backward, and the kernels' fwd+bwd times beside the plain ones; the LSE forwards also at
   the VAE's (2, 9216, 1, 512), the plain version a row at a time; the wide backward (D >
   128) on a huge-norm input at D=512 and at WIDE_BWD_BF16's shapes (``_wide_bwd_case``);
6b. ``torch.autograd.grad`` through the full-width ``VAEAttention`` (512 channels) at
   VAE_GRAD's latents with respect to to_q, to_k and to_v, launches of kernels 7/8, 9 and 10
   counted, against the same module with ``plain_attention``, and faults planted in dq and
   dk/dv failing that comparison;
7. the tiny LKGD train step (knowledge fusion, rank-2 temporal LoRA, remat) at fp32 on
   the GPU against the CPU with the same weights and injected sigmas, noise and dropout:
   the loss, every trainable gradient (scaled by its largest entry) and the trainables
   after one AdamW step at rtol 1e-4, atol 2e-4, frozen weights bit-identical;
7d. 7's step with 32 x 32 latents (256x256 frames): level 0 at 1024 tokens trains through the
   fp32 kernels 7-10 and 5/6 on the card (asserted) and their plain versions on the CPU,
   held as 7;
8o. the LKGD fine-tune at the JAX fine-tune CLI's own precision and defaults: ``--dtype
   fp32``, 512x512, 14 frames, batch 1, rank 4, no remat, through ``train_svd_lora.build``:
   a warm-up step, three between CUDA events under the CLI's TF32 setting (PyTorch's
   defaults) split into preprocessing and train step, peak, the busy share of one profiled
   step, launches a step (the four fp32 forms > 0, no bf16 training form, no plain flash
   version called); then one step's gradients through the kernels against plain attention,
   TF32 off, within FP32_STEP_TOL of max(1% of the largest gradient, each tensor's largest);
8. the LKGD fine-tune through ``lkgd_torch/cli/train_svd_lora.py``'s ``build`` at full
   width (SVD UNet, its VAE, CLIP-H, ViT-B/16-384; bf16 random frozen weights, fp32
   trainables), 512x512, 8 frames, batch 1, rank-4 temporal LoRA, remat, lr 2e-4: one
   warm-up step and three counted ones; sec/step split into preprocessing and train step,
   peak memory, each loss, every kernel's launch count (all eleven > 0, one key-norm
   launch for each bound launch, one split and one merge for each training forward and
   each backward: 54 relayout launches a step), the trainables moved, sampled frozen
   weights did not, every gradient finite; then one more step (PROFILED_STEPS) under ``torch.profiler``
   for the device's busy share of that window and its flash kernels by name (the training
   forward must be the wgmma kernel's LSE form, the backward the wgmma dq and dk/dv
   kernels, with their device ms and launches a step); and the exported
   safetensors read back. Neither window syncs the host inside it: losses stay on the
   device until it ends, and the end-of-fit checkpoint falls after its closing event;
7b. the tiny trans train step (joint branch with flip, the yx/xy/y adapters at rank 2,
   one [x, y] pair) the same way as 7, its trainables after the step against the CPU's
   AdamW applied to the GPU's gradients (7 checks both ways): Adam's first step divides
   each gradient entry by its own size plus 1e-8, and this UNet has entries near 1e-8, where
   last-bit gradient differences become step differences of ~3e-4; attn2's query and key
   adapters, which a one-key attention gives no gradient, must lack one on both sides;
8b. the trans fine-tune the same way as 8 (``--mode trans``: SVD UNet, VAE, CLIP-H, no ViT;
   one [clip, flipped clip] pair, 2 UNet rows), with the flash forwards launched inside
   the joint branch's ``attn1n`` calls counted by module hooks (> 0), the joint branch
   moved and attn2's zero-gradient B factors alone unmoved;
8c. a tiny-width trans fit on the card with ``--use-8bit-adam``, a validation pair rendered
   every step and ``--report-to tensorboard`` where the package is there: the GIFs, the
   event file and the 8-bit state;
7c. at fp32, GPU against CPU with the same weights and draws: the tiny joint video+flow
   step (the trans UNet on ``make_joint_vf_batch``'s [video, flow] rows of one clip, held
   as 7b); the tiny UniMatch (fan-in-scaled random weights, a moved view pair) on flow and
   stereo (rtol 1e-4, atol 1e-3 px) and depth (rtol 1e-4, atol 2e-4); ``make_flow_batch_fn`` "of" and "of_fix" (tiny UniMatch, a VAE of factor 4, the
   augmentation noise given); the tiny ControlNet train step (frozen UNet, every parameter
   random): loss, gradients (each scaled by its largest entry or by 1% of the largest of
   all, whichever is larger: biases before one-channel GroupNorm groups have rounding-level
   gradients), the update against the CPU's AdamW on the GPU's gradients and the EMA, at
   rtol 1e-4, atol 2e-4;
8d. the ControlNet-SDV fine-tune at full width, 512x512x8f, one 9-frame clip a step through
   ``Trainer.fit``: the base SVD UNet frozen in bf16 with remat, a ControlNet built from it
   with ``init_from_unet`` (fp32 parameters computed in bf16 under autocast, heads 0.02 x
   normal, lr 1e-5), an EMA; its control the clip's 8 flows from UniMatch ``lkgd()``
   through ``make_flow_fn`` and ``flow_to_image_naive``; a warm-up step, three between CUDA
   events (sec/step split into UniMatch, the other frozen preprocessing and the train step,
   host CPU s/step, peak memory, launches: every inference and training kernel > 0) and
   one (PROFILED_STEPS) under ``torch.profiler`` (device busy ms and operations a step); the UNet
   bit-identical, the ControlNet and most of its EMA moved (an EMA entry moves by 1e-4 of
   its parameter's move, below fp32's step at 1.0 for the norm scales);
8e. the flow-video fine-tune ("of") the same way: ``make_flow_batch_fn`` with UniMatch
   ``lkgd()`` and the base VAE on the clip's 9 frames, the first frame's CLIP embedding,
   then ``make_svd_train_step`` on the ``--mode lkgd`` UNet and its trainable set;
8f. the CogVideoX-5B I2V LoRA fine-tune at full width: T5-XXL (random bf16 weights) encodes
   two prompts of 226 tokens and is freed, the CogVideoX VAE encodes two synthetic 49x480x720
   clips in 8-frame chunks (and their first frames) into a ``TensorCache`` of 2 samples; then
   ``lkgd_torch/cli/train_cogvideox_lora.py``'s ``build`` at ``--rank 128 --lora-alpha 64
   --remat`` (frozen bf16 DiT, fp32 LoRA and fusion, its zero-init output 0.02 x normal)
   through ``Trainer.fit`` from the cache: a warm-up step, three between CUDA events (the
   cache read and host-to-device copy apart from the train step, host CPU s/step, peak,
   launches a step asserted: kernels 7/8 84, 9/10 42, 5/6 126, 1a 84) and one (PROFILED_STEPS) under
   ``torch.profiler`` (busy share, flash kernels by name); trainables moved, frozen weights
   bit-identical, one block's activations without remat, the export read back and one 2-step
   validation (kernels 1/2);
8g. ``--full-finetune --remat`` at full width and 2 layers: one step, every parameter moved,
   its peak;
8h. the SD-2D joint LoRA train step at 512x512 through ``training/sd2d.py``'s
   ``build_sd2d_training`` and ``Trainer.fit``: one x/y pair (batch 2), the SD2 UNet in
   bf16 with joint attention (``post="conv"``, mask (0, 1)) and a rank-64 LoRA on every
   ``attn1`` projection, the LoRA factors and the joint branch trained in fp32,
   ``snr_gamma=5``, ``joint_streams``, 77-token embeddings; a warm-up step, three between
   CUDA events (s/step, host CPU s/step, peak) and one (PROFILED_STEPS) under ``torch.profiler`` (busy
   share); launches a step asserted: kernels 7/8, 9/10 and 1a 20, 5/6 40, kernels 1/2 none;
   trainables moved, sampled frozen weights bit-identical;
8i. ``lkgd_torch/cli/precompute_cache.py`` at the published widths in fp32 (temporal VAE,
   CLIP-H) on three synthetic 14-frame 512x512 mp4 clips and one too short: the cache's
   keys and shapes, read back through ``PrecomputedLatentDataset`` and the CogVideoX
   fine-tune's cache adapter, launches a clip asserted (the fp32 flash forward once,
   kernels 3/4 once a GroupNorm of the encoder), s/clip split into VAE and CLIP, the peak,
   one clip under ``torch.profiler``;
8j. ``lkgd_torch/cli/compute_metrics.py`` at the published widths on 4 mp4s against 4 GIFs of
   16 frames at 256x256, InceptionV3 and I3D weights written from ``init_synthetic``: every
   key present and finite, seconds by stage (CLIP-H, InceptionV3 images/s, I3D clips/s, the
   Frechet fits on the host);
8k. ``lkgd_torch/cli/annotate.py``'s build functions at full width on a synthetic 14x576x1024
   video in the CLI's own arithmetic, ``annotate.precision`` (fp32 throughout): ``flow``
   (UniMatch), ``tracks`` (``raft_large`` from a random file of its manifest's keys, loaded
   strictly), ``depth_anything`` small and base, ``depth_midas``, ``depth`` (random state
   dicts written and loaded strictly); then RIFE 2x (27 frames), which has no CLI: s/clip
   after a warm-up on one frame (pair), peak GiB, one frame (pair) under
   ``torch.profiler``, the launches of one clip asserted (the fp32 flash form 12 a frame
   on ``depth_anything``, GroupNorm on ``depth_midas``, none elsewhere), outputs finite, in range and not constant; and how far
   cuDNN's TF32 (PyTorch's default, which the CLI turns off) would move each CLI path's
   frame (pair);
8l. the twelve label annotators of HED, PiDiNet, line art, SegFormer (B0 and B4) and OpenPose
   through ``cli/annotate.py``'s build functions at full width on the same 14x576x1024 video in
   ``annotate.precision``, each from a random file under the published names loaded
   strictly: s/clip, peak, one frame under ``torch.profiler``, TF32 against fp32, none of the
   port's kernels launched (``phase_labels_full``);
8m. BLIP-large (fp32) on one 384x384 frame at ``--max-length 20`` through ``cli/caption.py``'s
   ``caption_blip``: s/caption; CogVLM2-Caption at ``caption_8b`` (19.5 B parameters, bf16,
   built on the card from a seed, its names through ``port_cogvlm`` and loaded strictly) on
   24 frames at 224x224 with 12 prompt ids and 20 new tokens: s/video split vision / decode,
   peak, one decode step under ``torch.profiler`` (``phase_captions_full``);
8n. ``cli/verify_parity.py`` record (one record, ``--batch 1``) then check at ``--config
   svd-xt`` on a safetensors file written from seeded weights (1.5 B fp32 parameters); ``int8_matmul`` at (28 x 9216, 320) x
   (320, 1280) and ``int8_conv2d`` 3x3 over (28, 72, 128, 320) against exact fp64 products of
   their int8 codes, timed beside bf16 ``x @ w`` and ``F.conv2d``; ``collect_env``'s report
   (``phase_tools``);
9. the two microbenchmark entry points (``lkgd_torch/experiments``) at their full default
   shapes, with the launch counts of their kernels.

A line ``{"kernels": [...]}`` lists all twelve kernels and the key-norm kernel with their
launches on each path (base clip, trans clip, smoothing, ControlNet clip, DeepCache clips at
``dc=2`` and ``3``, flow clip, CogVideoX clip, the SD-2D inpaint, inpaint + ControlNet and
the two joint-control images, LKGD, trans, ControlNet, flow, CogVideoX and SD-2D training,
microbenchmarks, precompute, compute_metrics, the fp32 fine-tune), the fp32 form's three
rows among them (their other 3f shapes under ``shapes``) and the four fp32 training forms'
rows of 3i (launches from 8o's timed steps),
error, time, the
plain version's time, the library call's time and the bound, computed here from the shapes: the larger of the bytes moved over 3.35 TB/s and the
operations over the card's peak for their type (989 TFLOP/s for bf16 tensor-core products,
67 TFLOP/s for fp32 arithmetic outside them); the five inference kernels also carry their
row at the CogVideoX shapes of 3c under ``cogvideox``, and the training kernels and the
key-norm kernel their row at 3d's shape under ``train_cogvideox``; every kernel of 3e its
rows at the SD-2D shapes under ``sd2d`` (``ms`` the device time, ``wrapper_ms`` beside); the
kernels of 3h their rows under ``sequence_parallel``; ``launches_by_path`` also holds the
inversion, the ring's and the Ulysses DiT steps and the Ulysses joint attention call on rank
0 (``sp_ring``, ``sp_ulysses``, ``sp_ulysses_attention``), 5k's paths a rank (``tp``,
``fsdp``, ``svd_data``, ``svd_context``, ``svd_<mode>_context`` for the four other modes,
``train_data_parallel``), 5l's (``pp_m1``,
``pp_m2``), ``train_fp32`` (8o's three timed steps), the web demo's two
requests and ``verify_parity``'s check.

The second-to-last line of standard output holds the card's name and power limit as
``nvidia-smi`` prints them, the last one ``{"ok": true, "device": {...}}``. fp32 phases
run with TF32 off for matmuls and cuDNN convolutions. The script needs the repository
around it and a CUDA device; without either it fails before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# flash outputs relative to max|ref|: the kernels round P to bf16 before P.V and the
# output to bf16 (at most 4.8e-3 of max|ref| over every case here on an H100)
FLASH_TOL = 1e-2
GN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
# lse is rounded nowhere: exp2 and the summation order alone move it
LSE_TOL = 1e-2
# dq, dk, dv relative to max|ref|: the kernels round P and dS to bf16 before their
# products over up to 4096 keys or queries
GRAD_TOL = 2e-2
REPLACES = {  # the Pallas kernel body each CUDA kernel replaces
    "flash_bound": "lkgd_tpu/ops/flash_attention.py:40",
    "flash_maxtrack": "lkgd_tpu/ops/flash_attention.py:102",
    # no Pallas kernel: the part of the wrapper's _bound_t that the bound kernel takes from
    # outside, max_j|k_j| per (batch, head)
    "flash_key_norm": "lkgd_tpu/ops/flash_attention.py:95",
    # the one-pass form computes both Pallas kernels' work (and _sums_to_affine, :148)
    "gn_one_pass": "lkgd_tpu/ops/group_norm.py:44 + lkgd_tpu/ops/group_norm.py:56",
    "gn_stats": "lkgd_tpu/ops/group_norm.py:44",
    "gn_apply": "lkgd_tpu/ops/group_norm.py:56",
    "flash_bound_lse": "lkgd_tpu/ops/flash_attention.py:150",
    "flash_maxtrack_lse": "lkgd_tpu/ops/flash_attention.py:183",
    "flash_bwd_dq": "lkgd_tpu/ops/flash_attention.py:218",
    "flash_bwd_dkv": "lkgd_tpu/ops/flash_attention.py:246",
    "split_heads": "lkgd_tpu/ops/flash_attention.py:546",
    "merge_heads": "lkgd_tpu/ops/flash_attention.py:552",
    "blocked_matmul": "experiments/matmul_microbench.py:89",
    "flash_variant": "experiments/flash_variant_microbench.py:41",
    # the fp32 form of kernels 1, 2 and 1a (the Pallas bodies take fp32 operands too)
    "flash_bound_fp32": "lkgd_tpu/ops/flash_attention.py:40",
    "flash_maxtrack_fp32": "lkgd_tpu/ops/flash_attention.py:102",
    "flash_key_norm_fp32": "lkgd_tpu/ops/flash_attention.py:95",
    # kernels 7-10 on fp32 operands (the JAX SVD fine-tune CLI's precision)
    "flash_bound_lse_fp32": "lkgd_tpu/ops/flash_attention.py:150",
    "flash_maxtrack_lse_fp32": "lkgd_tpu/ops/flash_attention.py:183",
    "flash_bwd_dq_fp32": "lkgd_tpu/ops/flash_attention.py:218",
    "flash_bwd_dkv_fp32": "lkgd_tpu/ops/flash_attention.py:246",
}
INFERENCE = ("flash_bound", "flash_maxtrack", "flash_key_norm", "gn_one_pass", "gn_stats",
             "gn_apply")
GN_FORMS = ("gn_one_pass", "gn_stats", "gn_apply")
TRAINING = ("flash_bound_lse", "flash_maxtrack_lse", "flash_bwd_dq", "flash_bwd_dkv",
            "split_heads", "merge_heads")
EXPERIMENTS = ("blocked_matmul", "flash_variant")
# the two flash kernels that round exp2's argument and result to bf16
VARIANT_TOL = {"base": 1e-2, "prescale": 1e-2, "noexp": 1e-2, "bf16exp": 3e-2,
               "prescale_bf16exp": 3e-2}
MATMUL_TOL = 1e-2  # of max|ref|: fp32 accumulation, one bf16 rounding of the output
# the card's published peaks (H100 SXM): device memory, bf16 tensor cores, fp32 outside them
# and TF32 on them
PEAK_BYTES, PEAK_BF16, PEAK_FP32, PEAK_TF32 = 3.35e12, 989e12, 67e12, 495e12
SOURCES = {"flash_bound": "lkgd_torch/csrc/flash_attention_wgmma.cu",
           "flash_maxtrack": "lkgd_torch/csrc/flash_attention_wgmma.cu",
           "flash_key_norm": "lkgd_torch/csrc/flash_attention_wgmma.cu",
           "gn_one_pass": "lkgd_torch/csrc/group_norm.cu",
           "gn_stats": "lkgd_torch/csrc/group_norm.cu",
           "gn_apply": "lkgd_torch/csrc/group_norm.cu",
           "flash_bound_lse": "lkgd_torch/csrc/flash_attention_wgmma.cu",
           "flash_maxtrack_lse": "lkgd_torch/csrc/flash_attention_wgmma.cu",
           "flash_bwd_dq": "lkgd_torch/csrc/flash_attention_bwd.cu",
           "flash_bwd_dkv": "lkgd_torch/csrc/flash_attention_bwd.cu",
           "split_heads": "lkgd_torch/csrc/relayout_heads.cu",
           "merge_heads": "lkgd_torch/csrc/relayout_heads.cu",
           "blocked_matmul": "lkgd_torch/csrc/blocked_matmul.cu",
           "flash_variant": "lkgd_torch/csrc/flash_variant.cu",
           "flash_bound_fp32": "lkgd_torch/csrc/flash_attention_f32.cu",
           "flash_maxtrack_fp32": "lkgd_torch/csrc/flash_attention_f32.cu",
           "flash_key_norm_fp32": "lkgd_torch/csrc/flash_attention_f32.cu",
           "flash_bound_lse_fp32": "lkgd_torch/csrc/flash_attention_f32.cu",
           "flash_maxtrack_lse_fp32": "lkgd_torch/csrc/flash_attention_f32.cu",
           "flash_bwd_dq_fp32": "lkgd_torch/csrc/flash_attention_bwd_f32.cu",
           "flash_bwd_dkv_fp32": "lkgd_torch/csrc/flash_attention_bwd_f32.cu"}


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_BF16) -> dict:
    """The least time the card could take: the larger of each input read and each output
    written once over the memory rate, and the operations over their peak rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _gn_forwards(counts) -> int:
    """GroupNorm forwards in launch counts: each is one launch of the one-pass kernel, or a
    launch of the statistics and one of the normalise pass."""
    return counts.get("gn_one_pass", 0) + counts.get("gn_apply", 0)


def _by_forwards(counts: dict) -> dict:
    """Launch counts of one run with GroupNorm's two forms folded into its forwards
    (``gn_forwards``), for paths whose count of norms is known but not each norm's form;
    every two-pass forward launched both of its kernels."""
    assert counts.get("gn_stats", 0) == counts.get("gn_apply", 0), counts
    out = {k: v for k, v in counts.items() if v and k not in GN_FORMS}
    if _gn_forwards(counts):
        out["gn_forwards"] = _gn_forwards(counts)
    return out


def flash_bound(shape, s_k: int | None = None, products: int = 2, q_tensors: int = 2,
                k_tensors: int = 2, rows_fp32: int = 0) -> dict:
    """Bound of an attention kernel over (B, S_q, H, D) queries and S_k keys (S_q unless
    given), bf16: ``products`` S_q x S_k x D matrix products, ``q_tensors`` (B, S_q, H, D)
    and ``k_tensors`` (B, S_k, H, D) arrays moved and ``rows_fp32`` (B, H, S_q) fp32 ones."""
    b, s_q, h, d = shape
    s_k = s_k or s_q
    return bound(products * 2 * b * h * s_q * s_k * d,
                 (q_tensors * s_q + k_tensors * s_k) * b * h * d * 2
                 + rows_fp32 * b * h * s_q * 4)


def sdpa_ms(q, k, v, reps: int = 5) -> float:
    """The library's fused attention on the same (B, S, H, D) inputs."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return gpu_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)


def in_row_chunks(fn, tensors, rows: int = 2):
    """``fn`` over chunks of ``rows`` leading rows of ``tensors``, joined (each output of a
    ``fn`` that returns a tuple): the plain flash versions materialise (rows, H, S, S)
    fp32 logits, too much at 56 or 140 rows."""
    n = tensors[0].shape[0]
    parts = [fn(*(x[i:i + rows] for x in tensors)) for i in range(0, n, rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(column) for column in zip(*parts))
    return torch.cat(parts)


def gpu_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_probe_ms() -> float:
    """Wall ms of a fixed pure-Python loop: how fast this host runs interpreter work, the
    part of a host-bound step that is not waiting."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def host_line() -> str:
    return (f"host probe {host_probe_ms():.1f} ms, load average "
            f"{'/'.join(f'{x:.2f}' for x in os.getloadavg())}, {len(os.sched_getaffinity(0))} "
            f"cores")


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {host_line()}",
          flush=True)
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> None:
    from lkgd_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[build] {path.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'%.1f s' % _build.build_seconds if _build.build_seconds else 'reused'})",
          flush=True)


def phase_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels against their plain versions; returns per-kernel numbers at the main shapes
    (flash: UNet level 0; GroupNorm: the UNet level-0 spatial resblock)."""
    from lkgd_torch.experiments.group_norm_ab import device_times
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import group_norm as gn

    results = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    flash_cases = [("unet level 0", (2, 9216, 5, 64), 1.0),
                   ("unet level 1", (4, 2304, 10, 64), 1.0),
                   ("vae mid", (2, 9216, 1, 512), 1.0), ("ragged", (2, 1100, 5, 64), 1.0),
                   ("fallback", (1, 1100, 2, 64), 60.0), ("fallback wide", (1, 1100, 1, 512), 60.0),
                   ("vae decode", (14, 9216, 1, 512), 1.0),  # the whole-clip decode's call
                   # the frame-transition clip: 4 x 14 rows, attn1 and attn1n alike
                   ("trans level 0", (56, 9216, 5, 64), 1.0),
                   ("trans level 1", (56, 2304, 10, 64), 1.0)]
    for label, shape, scale in flash_cases:
        q, k = randn(*shape, scale=scale).bfloat16(), randn(*shape, scale=scale).bfloat16()
        v = randn(*shape).bfloat16()
        want = in_row_chunks(lambda *a: fa.flash_attention_maxtrack_plain(
            *(x.float() for x in a)), (q, k, v))
        for kernel in ("flash_bound", "flash_maxtrack"):
            if kernel == "flash_maxtrack":
                os.environ["LKGD_FLASH_MAXTRACK"] = "1"
            try:
                counter = fa.recomputed_tiles(dev)
                counter.zero_()
                got = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                recomputed = int(counter.item())
                err = (got.float() - want).abs()
                max_err, mean_err = err.max().item(), err.mean().item()
                ref_max = want.abs().max().item()
                ms = gpu_ms(lambda: fa.flash_attention(q, k, v))
            finally:
                os.environ.pop("LKGD_FLASH_MAXTRACK", None)
            plain = (fa.flash_attention_maxtrack_plain if kernel == "flash_maxtrack"
                     else fa.flash_attention_bound_plain)
            plain_ms = gpu_ms(lambda: in_row_chunks(plain, (q, k, v)), reps=2)
            lib_ms, least = sdpa_ms(q, k, v), flash_bound(shape)
            print(f"[kernel] {kernel} {label} (B,S,H,D)={shape} x{scale}: max|d| {max_err:.3e} "
                  f"of max|ref| {ref_max:.3e} (tol {FLASH_TOL} x max|ref|) mean|d| "
                  f"{mean_err:.3e} | {ms:.3f} ms, plain {plain_ms:.3f} ms (chunks of 2 rows), "
                  f"library sdpa {lib_ms:.3f} ms, bound {least['bound_ms']:.3f} ms by "
                  f"{least['bound_by']} | tiles recomputed {recomputed}", flush=True)
            assert np.isfinite(max_err) and max_err <= FLASH_TOL * ref_max, \
                (kernel, label, max_err, ref_max)
            if label.startswith("fallback") and kernel == "flash_bound":
                assert recomputed > 0, "the huge-norm input must trip the fallback"
            if label == "vae mid":
                assert ms < plain_ms, f"{kernel} at D=512 is slower than its plain version"
            if label == "unet level 0":
                results[kernel] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": lib_ms, **least}
        # the bound's key part alone: the kernel against its plain version (fp32 sums in
        # another order: rtol 1e-5)
        norm_got, norm_want = fa.key_norm_max(k), fa.key_norm_max_plain(k)
        norm_err = (norm_got - norm_want).abs().max().item()
        norm_ms, norm_plain_ms = gpu_ms(lambda: fa.key_norm_max(k)), gpu_ms(
            lambda: fa.key_norm_max_plain(k))
        # k read once, (B, H) fp32 written; 2 fp32 operations an element
        norm_least = bound(2 * k.numel(), k.numel() * 2 + shape[0] * shape[2] * 4, PEAK_FP32)
        print(f"[kernel] flash_key_norm {label} (B,S,H,D)={shape} x{scale}: max|d| "
              f"{norm_err:.3e} of max {norm_want.max().item():.3e} (rtol 1e-5) | {norm_ms:.3f} "
              f"ms, plain {norm_plain_ms:.3f} ms, bound {norm_least['bound_ms']:.4f} ms by "
              f"{norm_least['bound_by']}", flush=True)
        torch.testing.assert_close(norm_got, norm_want, rtol=1e-5, atol=0)
        if label == "unet level 0":
            results["flash_key_norm"] = {"max_abs_err": norm_err, "ms": norm_ms,
                                         "plain_ms": norm_plain_ms, "library_ms": None,
                                         **norm_least}
        del q, k, v, want
        torch.cuda.empty_cache()

    import torch.nn.functional as F

    # every shape class of the UNet step (the 960- and 1920-channel level-0 and level-1
    # norms are their 320- and 640-channel classes' wider cases), the trans clip's 56 and 4
    # rows, the VAE's full resolution, a ragged shape; one pass or two as fused_plan says
    gn_cases = [("unet level 0 spatial", (28, 9216, 320), torch.bfloat16),
                ("unet level 0 temporal", (2, 14 * 9216, 320), torch.bfloat16),
                ("unet level 1 spatial", (28, 2304, 640), torch.bfloat16),
                ("unet level 1 temporal", (2, 14 * 2304, 640), torch.bfloat16),
                ("unet level 2 spatial", (28, 576, 1280), torch.bfloat16),
                ("trans level 0 spatial", (56, 9216, 320), torch.bfloat16),
                ("trans level 0 temporal", (4, 14 * 9216, 320), torch.bfloat16),
                ("vae decode full res", (7, 576 * 1024, 128), torch.bfloat16),
                ("ragged", (3, 1001, 96), torch.bfloat16),
                ("unet level 0 spatial", (28, 9216, 320), torch.float32),
                ("ragged", (3, 1001, 96), torch.float32)]
    for label, shape, dtype in gn_cases:
        x = (randn(*shape, scale=2.0) + 0.5).to(dtype)
        w = (randn(shape[-1], scale=0.1) + 1.0).to(dtype)
        b = randn(shape[-1], scale=0.1).to(dtype)
        kw = dict(num_groups=32, eps=1e-5)
        plan = gn.fused_plan(*shape, 32, x.element_size())
        a_want, b_want = gn.group_norm_affine_plain(x.float(), w.float(), b.float(), **kw)
        a_got, b_got = gn.group_norm_affine(x, w, b, **kw)
        stats_err = max((a_got - a_want).abs().max().item(), (b_got - b_want).abs().max().item())
        # a, b within 1e-4 relative: the plain bf16 form's one-pass variance cancels to ~1e-5
        stats_rel = max(((g - t).abs().max() / t.abs().max().clamp(min=1.0)).item()
                        for g, t in ((a_got, a_want), (b_got, b_want)))
        assert stats_rel <= 1e-4, (label, dtype, stats_rel)
        form = "two passes"
        if plan is not None:
            # the one-pass form's own a, b against its plain merge order, and its bits over
            # two calls
            y1, a1, b1 = gn.group_norm_one_pass(x, w, b, act="silu", **kw)
            want1 = gn.group_norm_affine_slabs_plain(x, w, b, plan=plan, **kw)
            one_rel = max(((g - t).abs().max() / t.abs().max().clamp(min=1.0)).item()
                          for g, t in zip((a1, b1), want1))
            same = all(torch.equal(g, f) for g, f in zip(
                gn.group_norm_one_pass(x, w, b, act="silu", **kw), (y1, a1, b1)))
            form = (f"one pass: slabs of {plan.slab_groups} groups, clusters of {plan.cluster} "
                    f"x {plan.rows_per_block} rows, {plan.smem_bytes} B of shared memory a block; "
                    f"its a, b relative {one_rel:.2e} (tol 1e-4), two calls bit-identical "
                    f"{same}")
            assert one_rel <= 1e-4 and same, (label, dtype, form)
            del y1
        for act in (None, "silu"):
            before = dict(gn.launches)
            got = gn.group_norm(x, w, b, act=act, **kw)
            moved = {k: gn.launches[k] - before[k] for k in before if gn.launches[k] != before[k]}
            assert moved == ({"gn_one_pass": 1} if plan else {"gn_stats": 1, "gn_apply": 1}), \
                (label, moved)
            err = (got.float() - gn.group_norm_plain(x.float(), w.float(), b.float(), act=act,
                                                     **kw)).abs()
            del got
            apply_want = gn.group_norm_apply_plain(x.float(), a_got, b_got, act)
            apply_err = (gn.group_norm_apply(x, a_got, b_got, act).float()
                         - apply_want).abs().max().item()
            del apply_want
            tol = GN_TOL[dtype]
            stats_ms = gpu_ms(lambda: gn.group_norm_affine(x, w, b, **kw), 20)
            stats_plain_ms = gpu_ms(lambda: gn.group_norm_affine_plain(x, w, b, **kw))
            apply_ms = gpu_ms(lambda: gn.group_norm_apply(x, a_got, b_got, act), 20)
            apply_plain_ms = gpu_ms(lambda: gn.group_norm_apply_plain(x, a_got, b_got, act))
            forward_ms = gpu_ms(lambda: gn.group_norm(x, w, b, act=act, **kw), 20)
            # the library's GroupNorm (+ SiLU) on the same memory: (N, M, C) is the
            # channels-last form of (N, C, M, 1)
            x_nchw = x.view(shape[0], shape[1], 1, shape[2]).permute(0, 3, 1, 2)
            lib_ms = gpu_ms(lambda: (F.silu if act else (lambda y: y))(
                F.group_norm(x_nchw, 32, w, b, 1e-5)))
            n_el, size = x.numel(), x.element_size()
            # stats: x read once, (N, C) fp32 a and b written, ~3 fp32 operations an element;
            # apply, and the whole forward: x read once, y written once (a and b read),
            # ~8 operations an element with SiLU
            stats_least = bound(3 * n_el, n_el * size + 2 * shape[0] * shape[2] * 4, PEAK_FP32)
            apply_least = bound((8 if act else 2) * n_el,
                                2 * n_el * size + 2 * shape[0] * shape[2] * 4, PEAK_FP32)
            # each kernel alone under the profiler (with SiLU, the resblocks' form), and one
            # whole forward: its device time and device operations
            dev_t = device_times(x, w, b, act) if act else {}
            print(f"[kernel] group_norm {label} {tuple(shape)} {str(dtype)[6:]} act={act}: "
                  f"{form} | forward max|d| {err.max().item():.3e} mean|d| "
                  f"{err.mean().item():.3e} (tol {tol}), {forward_ms:.4f} ms (20 calls) | "
                  f"stats+fold {stats_ms:.4f} ms, plain {stats_plain_ms:.3f} ms (affine max|d| "
                  f"{stats_err:.3e}, relative {stats_rel:.2e}, tol 1e-4), bound "
                  f"{stats_least['bound_ms']:.4f} ms | apply {apply_ms:.4f} ms, plain "
                  f"{apply_plain_ms:.3f} ms (max|d| {apply_err:.3e}), bound "
                  f"{apply_least['bound_ms']:.4f} ms | library group_norm"
                  f"{'+silu' if act else ''} (both passes) {lib_ms:.3f} ms" + (
                      f" | device (torch.profiler): forward {dev_t['forward_device_ms']:.4f} ms "
                      f"({100 * apply_least['bound_ms'] / dev_t['forward_device_ms']:.1f}% of "
                      f"the one-pass bound), {dev_t['forward_device_ops']:.0f} device "
                      f"operations, {dev_t['form']}; stats+fold alone "
                      f"{dev_t['stats_device_ms']:.4f} ms "
                      f"({100 * stats_least['bound_ms'] / dev_t['stats_device_ms']:.1f}% of "
                      f"bound; kernel {dev_t['stats_kernel_ms']:.4f}), apply alone "
                      f"{dev_t['apply_device_ms']:.4f} ms ("
                      f"{100 * apply_least['bound_ms'] / dev_t['apply_device_ms']:.1f}% of "
                      f"bound)" if act else ""), flush=True)
            assert err.max().item() <= tol, (label, dtype, act, err.max().item())
            assert apply_err <= tol, (label, dtype, act, apply_err)
            if dev_t:
                assert dev_t["forward_device_ops"] == 1 if plan else \
                    dev_t["forward_device_ops"] <= 3, (label, dtype, dev_t)
            if label == "unet level 0 spatial" and dtype == torch.bfloat16 and act == "silu":
                # library_ms is one call for the forward's work: the same number in all three
                results["gn_one_pass"] = {"max_abs_err": err.max().item(),
                                          "ms": forward_ms,
                                          "device_ms": dev_t["forward_device_ms"],
                                          "plain_ms": gpu_ms(lambda: gn.group_norm_plain(
                                              x, w, b, act=act, **kw)),
                                          "library_ms": lib_ms, **apply_least}
                results["gn_stats"] = {"max_abs_err": stats_err, "ms": stats_ms,
                                       "device_ms": dev_t["stats_device_ms"],
                                       "plain_ms": stats_plain_ms, "library_ms": lib_ms,
                                       **stats_least}
                results["gn_apply"] = {"max_abs_err": apply_err, "ms": apply_ms,
                                       "device_ms": dev_t["apply_device_ms"],
                                       "plain_ms": apply_plain_ms, "library_ms": lib_ms,
                                       **apply_least}
            if label == "unet level 0 temporal" and act == "silu":
                # the kernel-4 row's own shape: the first the UNet runs two-pass
                results["gn_apply"]["level0_temporal"] = {
                    "max_abs_err": apply_err, "ms": apply_ms,
                    "device_ms": dev_t["apply_device_ms"], "plain_ms": apply_plain_ms,
                    "library_ms": lib_ms, **apply_least}
            del err
        del x, a_want, b_want, a_got, b_got
        torch.cuda.empty_cache()
    _gn_large_mean_check(gn, randn)
    # the bf16 SiLU of both forms over t in [-20, 20], in bf16 ulps of t * sigmoid(t)
    from lkgd_torch.experiments.group_norm_ab import silu_ulps

    ulps = silu_ulps()
    print(f"[kernel] group_norm bf16 silu against t * sigmoid(t) in fp64, bf16 ulps (tol 1): "
          + "; ".join(f"{form} {v['max_ulps']:.4f} at t = {v['at_t']:.4g}"
                      for form, v in ulps.items()), flush=True)
    assert all(v["max_ulps"] <= 1.0 for v in ulps.values()), ulps
    return results


def _gn_large_mean_check(gn, randn) -> None:
    """fp32 with mean 1e3 and std 1 at the ragged shape: kernel 3's a, b against an fp64
    two-pass reference (1e-4 relative), and bit-identical over three calls."""
    x = randn(3, 1001, 96) + 1e3
    w, b = randn(96, scale=0.1) + 1.0, randn(96, scale=0.1)
    got = [torch.cat(gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-5)) for _ in range(3)]
    xg = x.double().view(3, 1001, 32, 3)
    mean = xg.mean(dim=(1, 3))
    inv = torch.rsqrt(((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3)) + 1e-5)
    a = inv.repeat_interleave(3, dim=-1) * w.double()
    want = torch.cat((a, b.double() - mean.repeat_interleave(3, dim=-1) * a))
    rel = ((got[0].double() - want).abs().max() / want.abs().max()).item()
    same = all(torch.equal(g, got[0]) for g in got)
    print(f"[kernel] group_norm stats fp32 mean 1e3 std 1 (3, 1001, 96): a, b vs fp64 two-pass "
          f"relative {rel:.2e} (tol 1e-4), three calls bit-identical {same}", flush=True)
    assert rel <= 1e-4 and same, (rel, same)


def _versus(ms: float, lib_ms: float, least: dict) -> str:
    return (f"{100 * least['bound_ms'] / ms:.1f}% of bound, {ms / lib_ms:.2f}x library")


def phase_experiment_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels 11 and 12 against their plain versions at the microbenchmarks' shapes;
    returns their numbers at (258048, 320) x (320, 320) (with (320, 1280) beside) and at
    ``base`` on the production tile, 128 x 128 (with 64 x 64 beside)."""
    import torch.nn.functional as F

    from lkgd_torch.ops import flash_variants as fv
    from lkgd_torch.ops import matmul as mm

    results = {}
    for label, (m, k, n) in (("unet level 0 qkv", (258048, 320, 320)),
                             ("unet level 0 ff", (258048, 320, 1280)),
                             ("ragged M", (258000 + 7, 320, 320)),
                             ("ragged M, K, N", (1000, 72, 200))):
        x = torch.randn((m, k), device=dev, generator=gen).bfloat16()
        w = torch.randn((k, n), device=dev, generator=gen).bfloat16()
        got = mm.blocked_matmul(x, w)
        torch.cuda.synchronize()
        want = mm.blocked_matmul_plain(x.float(), w.float())
        err, ref = (got.float() - want).abs().max().item(), want.abs().max().item()
        del want
        ms = gpu_ms(lambda: mm.blocked_matmul(x, w), reps=20)
        plain_ms = gpu_ms(lambda: mm.blocked_matmul_plain(x, w))
        lib_ms = gpu_ms(lambda: x @ w, reps=20)
        least = bound(2 * m * k * n, 2 * (m * k + k * n + m * n))
        print(f"[kernel] blocked_matmul {label} ({m},{k})x({k},{n}): max|d| {err:.3e} of "
              f"max|ref| {ref:.3e} (tol {MATMUL_TOL} x max|ref|) | {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library x @ w {lib_ms:.3f} ms, bound "
              f"{least['bound_ms']:.3f} ms by {least['bound_by']} | "
              f"{_versus(ms, lib_ms, least)}", flush=True)
        assert np.isfinite(err) and err <= MATMUL_TOL * ref, (label, err, ref)
        if label == "unet level 0 qkv":
            results["blocked_matmul"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                         "library_ms": lib_ms, **least}
        elif label == "unet level 0 ff":
            ff = {"ff_ms": ms, "ff_library_ms": lib_ms, "ff_bound_ms": least["bound_ms"]}
        del x, w, got
        torch.cuda.empty_cache()
    results["blocked_matmul"].update(ff)

    bh, s_, d = 140, 9216, 64
    q, k, v = (torch.randn((bh, s_, d), device=dev, generator=gen).bfloat16() for _ in range(3))
    t = fv.bound_t(q, k)
    qt, kt, vt = (x[:, None] for x in (q, k, v))  # (B*H, 1, S, D) for the library call
    lib_ms = gpu_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=3)
    least = bound(4 * bh * s_ * s_ * d, 4 * bh * s_ * d * 2 + bh * s_ * 4)
    for mode in fv.MODES:
        def plain(*a, mode=mode):
            return fv.flash_variant_plain(*a, mode)

        want = in_row_chunks(plain, (q, k, v, t), rows=4).float()
        plain_ms = gpu_ms(lambda: in_row_chunks(plain, (q, k, v, t), rows=4), reps=1)
        ref = want.abs().max().item()
        for tile in fv.TILES:
            got = fv.flash_variant(q, k, v, t, mode, tile)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            ms = gpu_ms(lambda: fv.flash_variant(q, k, v, t, mode, tile), reps=3)
            print(f"[kernel] flash_variant {mode} tile {tile[0]}x{tile[1]} (B*H,S,D)="
                  f"{(bh, s_, d)}: max|d| {err:.3e} of max|ref| {ref:.3e} (tol "
                  f"{VARIANT_TOL[mode]} x max|ref|) | {ms:.3f} ms, plain {plain_ms:.3f} ms "
                  f"(chunks of 4 rows), library sdpa {lib_ms:.3f} ms, bound "
                  f"{least['bound_ms']:.3f} ms by {least['bound_by']} | "
                  f"{_versus(ms, lib_ms, least)}", flush=True)
            assert np.isfinite(err) and err <= VARIANT_TOL[mode] * ref, (mode, tile, err, ref)
            if mode == "base" and tile == fv.PRODUCTION_TILE:
                results["flash_variant"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                            "library_ms": lib_ms, "tile": list(tile), **least}
            elif mode == "base" and tile == (64, 64):
                ms_64 = ms
        del want
    results["flash_variant"]["ms_64x64"] = ms_64
    del q, k, v, t
    torch.cuda.empty_cache()
    return results


def _tiny_widths():
    """The tiny configuration of tests/test_pipeline_torch_oracle.py:35-46: UNet overrides,
    VAE and CLIP configs."""
    from lkgd_torch.models.configs import CLIPVisionConfig, TemporalVAEConfig

    unet = dict(block_out_channels=(32, 64),
                down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
                up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
                layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64)
    return (unet, TemporalVAEConfig(block_out_channels=(32, 64), layers_per_block=1),
            CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                             num_heads=2, intermediate_size=128, projection_dim=64))


def _tiny_pipeline(device):
    from lkgd_torch.models.configs import SVDUNetConfig
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    unet, vae, clip = _tiny_widths()
    return StableVideoDiffusionPipeline(
        config=SVDPipelineConfig(height=48, width=48, num_frames=4, num_inference_steps=3,
                                 decode_chunk_size=2),
        unet_config=SVDUNetConfig(**unet), vae_config=vae, clip_config=clip,
        dtype=torch.float32, device=device)


def phase_tiny(dev: torch.device) -> None:
    from lkgd_torch.ops import group_norm as gn

    cpu = _tiny_pipeline("cpu")
    cpu.init_params(torch.Generator().manual_seed(7))
    gpu = _tiny_pipeline(dev)
    for src, dst in zip(cpu.models, gpu.models):
        dst.load_state_dict(src.state_dict(), strict=True)
    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.uniform(size=(1, 48, 48, 3)).astype(np.float32))
    noise_aug = torch.from_numpy(rng.standard_normal((1, 48, 48, 3)).astype(np.float32))
    init_noise = torch.from_numpy(rng.standard_normal((1, 4, 24, 24, 4)).astype(np.float32))
    gn_before = _gn_forwards(gn.launches)
    lat_cpu = cpu.denoise(image, noise_aug=noise_aug, initial_noise=init_noise)
    lat_gpu = gpu.denoise(image, noise_aug=noise_aug, initial_noise=init_noise)
    frames_cpu = cpu.decode_latents(lat_cpu)
    frames_gpu = gpu.decode_latents(lat_gpu)
    torch.cuda.synchronize()
    gn_calls = _gn_forwards(gn.launches) - gn_before
    for name, got, want in (("latents", lat_gpu, lat_cpu), ("frames", frames_gpu, frames_cpu)):
        got = got.cpu()
        err = (got - want).abs().max().item()
        print(f"[tiny] GPU vs CPU fp32 {name} {tuple(want.shape)}: max|d| {err:.3e} "
              f"(rtol 1e-4, atol 2e-4) | GroupNorm forwards on the kernels {gn_calls}", flush=True)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
    assert gn_calls > 0, "the tiny GPU pipeline must run the GroupNorm kernels"


WARM_STEPS = 2  # a warm-up clip's denoising steps: a whole clip's shapes, a tenth of its time
PROFILED_STEPS = 1  # a fine-tune's steps under torch.profiler, after its 3 timed ones
FIT_STEPS = 4 + PROFILED_STEPS  # a fine-tune's steps in all: warm-up, 3 timed, profiled


def _short(pipe, fn):
    """``fn()`` with the SVD pipeline's schedule cut to ``WARM_STEPS`` steps: a warm-up."""
    schedule = pipe.schedule
    pipe.schedule = pipe.scheduler.set_timesteps(WARM_STEPS, pipe.device)
    try:
        return fn()
    finally:
        pipe.schedule = schedule


def phase_full(dev: torch.device) -> dict:
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    cfg = SVDPipelineConfig(height=576, width=1024, num_frames=14, num_inference_steps=25,
                            decode_chunk_size=14)
    t0 = time.perf_counter()
    pipe = StableVideoDiffusionPipeline(config=cfg, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe.init_params(gen)
    n_params = sum(p.numel() for m in pipe.models for p in m.parameters())
    image = torch.rand((1, cfg.height, cfg.width, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[full] {n_params / 1e9:.3f} B bf16 random params, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    launches = {}
    for clip in (1, 2):
        if clip == 2:  # the counted run: counters and peak memory from zero
            _zero_counts()
            fa.recomputed_tiles(dev).zero_()
            torch.cuda.reset_peak_memory_stats(dev)
        clip_gen = torch.Generator(device=dev).manual_seed(clip)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = (pipe.denoise(image, clip_gen) if clip == 2
                   else _short(pipe, lambda: pipe.denoise(image, clip_gen)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = pipe.decode_latents(latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if clip == 2:
            launches = _read_counts()
            recomputed = int(fa.recomputed_tiles(dev).item())
            peak = torch.cuda.max_memory_allocated(dev)
        steps = cfg.num_inference_steps if clip == 2 else WARM_STEPS
        print(f"[full] clip {clip}{' (warm-up)' if clip == 1 else ''}: {t2 - t0:.3f} s/clip "
              f"= denoise {t1 - t0:.3f} s ({steps} steps) + decode "
              f"{t2 - t1:.3f} s", flush=True)
        assert frames.shape == (1, cfg.num_frames, cfg.height, cfg.width, 3), frames.shape
        assert torch.isfinite(latents).all(), "non-finite latents"
        assert torch.isfinite(frames).all(), "non-finite frames"
        assert frames.min().item() >= 0.0 and frames.max().item() <= 1.0
    print(f"[full] clip 2: peak memory {peak / 2**30:.2f} GiB | launches {launches} | "
          f"fallback tiles recomputed {recomputed} | frames mean {frames.mean().item():.4f} "
          f"std {frames.std().item():.4f}", flush=True)
    for name in INFERENCE:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by the main path"
    for name in TRAINING + EXPERIMENTS:  # no gradient is asked for, no microbenchmark runs
        assert launches.get(name, 0) == 0, f"kernel {name} was launched by inference"
    _profile_unet_step("full", pipe, 2, gen)
    _profiled("full", "the whole-clip decode", lambda: pipe.decode_latents(latents))
    return launches


def _all_counts() -> tuple:
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import flash_variants as fv
    from lkgd_torch.ops import group_norm as gn
    from lkgd_torch.ops import matmul as mm

    return fa.launches, gn.launches, mm.launches, fv.launches


def _zero_counts() -> None:
    for counts in _all_counts():
        for name in counts:
            counts[name] = 0


def _read_counts() -> dict:
    return {name: n for counts in _all_counts() for name, n in counts.items()}


def _tiny_joint_pipeline(device, mode: str, sequential_cfg: bool = False):
    """The tiny widths through the inference CLI's ``build_pipeline`` in trans or smooth
    mode: joint attention with flip, spatial and temporal, and the two stream-masked LoRA
    rules; smooth mode takes 10 frames in 4-frame chunks from step 1 of 3."""
    from lkgd_torch.cli import run_inference_svd as cli

    argv = ["--mode", mode, "--image", "-", "--height", "48", "--width", "48",
            "--num-frames", "4", "--num-inference-steps", "3", "--decode-chunk-size", "2",
            "--flip", "--temporal", "--lora-rank", "2", "--dtype", "fp32", "--device",
            str(device)] + (["--sequential-cfg"] if sequential_cfg else [])
    if mode == "smooth":
        argv += ["--smooth-start-step", "1", "--smooth-total-frames", "10"]
    return cli.build_pipeline(cli.make_parser().parse_args(argv), cli.Widths(*_tiny_widths()))


def _randomize(pipe, seed: int) -> None:
    """Every parameter random: the joint branch's post projections and the LoRA B factors
    are zero at init, where a wrong branch would add nothing and pass every comparison."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for model in _all_models(pipe):
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.15)


def phase_tiny_joint(dev: torch.device, mode: str) -> None:
    """The tiny trans or smooth pipeline on the GPU, batched and with ``sequential_cfg``,
    against the batched one on the CPU with the same weights and noise (and in smooth mode
    the same offsets, both of which shift the buffer)."""
    label = f"tiny-{mode}"
    cpu = _tiny_joint_pipeline("cpu", mode)
    _randomize(cpu, 13 if mode == "trans" else 17)
    rng = np.random.default_rng(6 if mode == "trans" else 9)
    rows = 2 if mode == "trans" else 10  # images, or frames of the video
    image = torch.from_numpy(rng.uniform(size=(rows, 48, 48, 3)).astype(np.float32))
    latent_shape = (2, 4, 24, 24, 4) if mode == "trans" else (1, 10, 24, 24, 4)
    kw = dict(noise_aug=torch.from_numpy(rng.standard_normal((rows, 48, 48, 3)).astype(np.float32)),
              initial_noise=torch.from_numpy(rng.standard_normal(latent_shape).astype(np.float32)))
    if mode == "smooth":
        kw["offsets"] = [1, 3]
    lat_cpu = cpu.denoise(image, **kw)
    frames_cpu = cpu.decode_latents(lat_cpu)
    if mode == "trans":
        assert (lat_cpu[0] - lat_cpu[1]).abs().max().item() > 1e-3, "the streams must differ"
    for sequential in (False, True):
        gpu = _tiny_joint_pipeline(dev, mode, sequential)
        for src, dst in zip(cpu.models, gpu.models):
            dst.load_state_dict(src.state_dict(), strict=True)
        lat_gpu = gpu.denoise(image, **kw)
        frames_gpu = gpu.decode_latents(lat_gpu)
        torch.cuda.synchronize()
        for name, got, want in (("latents", lat_gpu, lat_cpu),
                                ("frames", frames_gpu, frames_cpu)):
            got = got.cpu()
            err = (got - want).abs().max().item()
            print(f"[{label}] {'sequential_cfg' if sequential else 'batched'} GPU vs batched "
                  f"CPU fp32 {name} {tuple(want.shape)}: max|d| {err:.3e} (rtol 1e-4, atol "
                  f"2e-4)", flush=True)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


_KINDS = (("flash attention kernels", ("flash_fwd", "flash_bwd", "key_sq_max", "tf32_split",
                                       "bwd_split")),
          ("GroupNorm kernels", ("gn_",)),
          # cuDNN's kernel names say what they compute (``sm90_xmma_fprop_implicit_gemm_*``);
          # cuBLAS's share the ``xmma`` prefix (``sm80_xmma_gemm_*``), so it names neither
          ("cuDNN convolutions", ("conv", "cudnn", "fprop", "implicit", "wgrad", "dgrad")),
          # cuDNN's FFT convolution: its transforms and the complex ``gemvx`` products
          ("cuDNN FFT convolutions", ("fft", "gemvx")),
          ("cuBLAS matrix products", ("gemm", "cutlass", "nvjet", "cublas", "gemv")),
          ("LayerNorm", ("layer_norm", "LayerNorm")),
          ("softmax", ("softmax",)),
          ("copies and concatenations", ("copy", "Memcpy", "Memset", "cat", "Cat", "fill")),
          ("reductions", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized")))


def _device_time_by_kind(prof) -> tuple[float, dict, int]:
    """Device ms, ms by kind of kernel (matched on the kernel's name) and the number of
    device operations of a profile."""
    from torch.autograd import DeviceType

    total, kinds, count = 0.0, {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        total += ms
        count += e.count
        kind = next((name for name, words in _KINDS if any(w in e.key for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return total, dict(sorted(kinds.items(), key=lambda kv: -kv[1])), count


def _profiled(label: str, what: str, fn) -> None:
    """``fn()`` once to warm up and once under ``torch.profiler``: its device time by kind."""
    from lkgd_torch.experiments._timing import traced

    def run() -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        prof, wall_ms = traced(run)
    device_ms, kinds, n_ops = _device_time_by_kind(prof)
    print(f"[{label}] {what} under torch.profiler: wall {wall_ms:.1f} ms, device "
          f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}% busy), {n_ops} device "
          f"operations | " + ", ".join(f"{k} {v:.1f} ms ({100 * v / device_ms:.1f}%)"
                                       for k, v in kinds.items()), flush=True)
    assert device_ms > 0.0


def _profile_unet_step(label: str, pipe, rows: int, gen: torch.Generator) -> None:
    """One UNet step of ``rows`` clips' frames under the profiler: where its time goes."""
    cfg, dev = pipe.config, gen.device
    model_in = torch.randn((rows, cfg.num_frames, pipe.latent_height, pipe.latent_width, 8),
                           generator=gen, device=dev).to(pipe.dtype)
    emb = torch.randn((rows, 1, 1024), generator=gen, device=dev).to(pipe.dtype)
    ids = pipe._add_time_ids(rows)
    _profiled(label, f"one UNet step of {rows} x {cfg.num_frames} = {rows * cfg.num_frames} rows",
              lambda: pipe.unet(model_in, pipe.schedule.timesteps[5], emb, ids))


def phase_trans_full(dev: torch.device) -> dict:
    """The full-width frame-transition clip: a warm-up (``WARM_STEPS``) and a timed, counted
    clip with batched CFG (56 UNet rows), then one with ``sequential_cfg`` on the same
    weights, seed and short schedule as the warm-up."""
    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.ops import flash_attention as fa

    args = cli.make_parser().parse_args(
        ["--mode", "trans", "--image", "-", "--joint-mask", "0,1,0,1", "--flip", "--temporal",
         "--lora-rank", "4", "--decode-chunk-size", "14", "--seed", "0", "--device", str(dev),
         "--sequential-cfg"])  # builds both UNet forms; each clip below picks one
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    cfg = pipe.config
    gen = torch.Generator(device=dev).manual_seed(3)
    # conv1n (and the LoRA B factors) are zero at init, so the joint branch and the adapters
    # would add nothing to the output: fill them with small seeded random values, so that the
    # clip's values really pass through attn1n and a wrong branch would show
    filled = 0
    with torch.no_grad():
        for name, p in pipe.unet.named_parameters():
            if ".conv1n." in name or name.endswith("_B"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
                filled += 1
    n_params = sum(p.numel() for m in pipe.models for p in m.parameters())
    images = torch.rand((2, cfg.height, cfg.width, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[trans] {n_params / 1e9:.3f} B bf16 random params ({filled} conv1n and LoRA B "
          f"tensors filled with 0.02 x normal), joint {pipe.unet.config.joint}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    import dataclasses

    def clip(seed: int, sequential: bool, steps: int) -> dict:
        """One clip of ``steps`` steps (``WARM_STEPS`` or the whole schedule) from zeroed
        counters: its times, peaks, launch counts and outputs."""
        pipe.config = dataclasses.replace(cfg, sequential_cfg=sequential)
        _zero_counts()
        fa.recomputed_tiles(dev).zero_()
        torch.cuda.reset_peak_memory_stats(dev)
        clip_gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = (pipe.denoise(images, clip_gen) if steps == cfg.num_inference_steps
                   else _short(pipe, lambda: pipe.denoise(images, clip_gen)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        denoise_peak = torch.cuda.max_memory_allocated(dev)
        frames = pipe.decode_latents(latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"s": t2 - t0, "denoise_s": t1 - t0, "decode_s": t2 - t1,
                "denoise_peak": denoise_peak, "peak": torch.cuda.max_memory_allocated(dev),
                "launches": _read_counts(), "recomputed": int(fa.recomputed_tiles(dev).item()),
                "latents": latents, "frames": frames}

    runs = {}
    steps = cfg.num_inference_steps
    for label, seed, sequential, n in (("warm-up, batched CFG (56 UNet rows)", 1, False,
                                        WARM_STEPS),
                                       ("batched CFG (56 UNet rows)", 2, False, steps),
                                       ("sequential_cfg (2 x 28 UNet rows)", 1, True,
                                        WARM_STEPS)):
        runs[label] = r = clip(seed, sequential, n)
        print(f"[trans] {label}: {r['s']:.3f} s/clip = denoise {r['denoise_s']:.3f} s "
              f"({n} steps) + decode {r['decode_s']:.3f} s | peak memory "
              f"{r['peak'] / 2**30:.2f} GiB (denoise alone {r['denoise_peak'] / 2**30:.2f} GiB) "
              f"| launches { {k: v for k, v in r['launches'].items() if v} } | fallback tiles "
              f"recomputed {r['recomputed']}", flush=True)
    pipe.config = cfg
    timed, seq = runs["batched CFG (56 UNet rows)"], runs["sequential_cfg (2 x 28 UNet rows)"]
    warm = runs["warm-up, batched CFG (56 UNet rows)"]
    launches, latents, frames = timed["launches"], timed["latents"], timed["frames"]
    assert frames.shape == (2, cfg.num_frames, cfg.height, cfg.width, 3), frames.shape
    assert torch.isfinite(latents).all() and torch.isfinite(frames).all(), "non-finite output"
    assert frames.min().item() >= 0.0 and frames.max().item() <= 1.0
    streams = (latents[0] - latents[1]).abs().max().item()
    # the same seed and schedule through both forms: bf16 kernels see other batch shapes, so
    # the forms agree loosely; reported, and held finite
    forms = (seq["latents"] - warm["latents"]).abs().max().item()
    print(f"[trans] timed clip: launches predicted flash 503 each, GroupNorm 2763 forwards: "
          f"{launches['gn_one_pass']} in one pass, {launches['gn_stats']} in two "
          f"({_gn_forwards(launches)} in all) | "
          f"frames mean {frames.mean().item():.4f} std {frames.std().item():.4f} | streams "
          f"differ by max {streams:.3f} in the latents | sequential_cfg vs batched latents "
          f"({WARM_STEPS} steps) max|d| {forms:.3f} of max|latent| "
          f"{warm['latents'].abs().max().item():.3f} (bf16)",
          flush=True)
    assert streams > 1e-3, "the two streams must differ"
    assert torch.isfinite(seq["frames"]).all(), "non-finite sequential_cfg output"
    for name in INFERENCE:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by the trans clip"
    for name in TRAINING + EXPERIMENTS:
        assert launches.get(name, 0) == 0, f"kernel {name} was launched by the trans clip"
    del frames, latents, runs, timed, seq, warm

    _profile_unet_step("trans", pipe, 2 * images.shape[0], gen)
    return launches


SMOOTH_FRAMES = 50
SMOOTH_START = 20  # the timed run's first step: its last 5 of the 25 steps


def phase_smooth_full(dev: torch.device) -> dict:
    """The full-width smoothing of a 50-frame 576x1024 video in 14-frame joint chunks from
    step ``SMOOTH_START`` of 25 (CFG batched: 4 x 5 chunks = 20 UNet rows of 14 frames),
    bf16, through the inference CLI's ``build_pipeline``: a warm-up from step 24 on the
    same shapes, then a timed, counted run with its split into conditioning, the denoising loop and the decode;
    then one UNet step of 20 x 14 rows under ``torch.profiler``."""
    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.ops import flash_attention as fa

    args = cli.make_parser().parse_args(
        ["--mode", "smooth", "--image", "-", "--flip", "--temporal", "--lora-rank", "4",
         "--smooth-total-frames", str(SMOOTH_FRAMES), "--smooth-start-step", str(SMOOTH_START),
         "--decode-chunk-size", "14", "--seed", "0", "--device", str(dev)])
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    cfg = pipe.config
    gen = torch.Generator(device=dev).manual_seed(4)
    filled = 0
    with torch.no_grad():  # conv1n and the LoRA B factors are zero at init (see trans)
        for name, p in pipe.unet.named_parameters():
            if ".conv1n." in name or name.endswith("_B"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
                filled += 1
    # a smooth synthetic video: a drifting gradient with a little noise
    t = torch.arange(SMOOTH_FRAMES, device=dev, dtype=torch.float32)[:, None, None, None]
    yy = torch.linspace(0, 1, cfg.height, device=dev)[None, :, None, None]
    xx = torch.linspace(0, 1, cfg.width, device=dev)[None, None, :, None]
    phase = torch.tensor([0.0, 2.1, 4.2], device=dev)
    video = 0.5 + 0.4 * torch.sin(6 * xx + 4 * yy + 0.15 * t + phase)
    video = (video + 0.02 * torch.randn(video.shape, generator=gen, device=dev)).clamp(0, 1)
    torch.cuda.synchronize()
    print(f"[smooth] {SMOOTH_FRAMES} frames, chunks of {cfg.num_frames}: {pipe.n_chunks} "
          f"chunks, {4 * pipe.n_chunks} UNet rows a step, steps {pipe.start_step}-"
          f"{cfg.num_inference_steps - 1}; {filled} conv1n and LoRA B tensors 0.02 x normal; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)

    def run(start_step: int, seed: int) -> dict:
        pipe.start_step = start_step
        _zero_counts()
        fa.recomputed_tiles(dev).zero_()
        torch.cuda.reset_peak_memory_stats(dev)
        run_gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = pipe.denoise(video, run_gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = pipe.decode_latents(latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"s": t2 - t0, "denoise_s": t1 - t0, "decode_s": t2 - t1,
                "peak": torch.cuda.max_memory_allocated(dev), "launches": _read_counts(),
                "recomputed": int(fa.recomputed_tiles(dev).item()), "latents": latents,
                "frames": frames}

    warm = run(cfg.num_inference_steps - 1, 1)
    print(f"[smooth] warm-up (1 step): {warm['s']:.3f} s, peak {warm['peak'] / 2**30:.2f} GiB",
          flush=True)
    del warm
    r = run(SMOOTH_START, 2)
    # the conditioning alone on the same video: CLIP on every frame, the two VAE encodes
    with torch.inference_mode():
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        m11 = video * 2.0 - 1.0
        pipe._encode_clip(video)
        pipe._encode_frames(m11 + cfg.noise_aug_strength * torch.randn_like(m11))
        pipe._encode_frames(m11)
        torch.cuda.synchronize()
        cond_s = time.perf_counter() - c0
    launches, latents, frames = r["launches"], r["latents"], r["frames"]
    n_steps = cfg.num_inference_steps - SMOOTH_START
    print(f"[smooth] {r['s']:.3f} s/clip = conditioning {cond_s:.3f} s (timed alone) + "
          f"denoise {r['denoise_s'] - cond_s:.3f} s ({n_steps} steps, "
          f"{(r['denoise_s'] - cond_s) / n_steps:.3f} s a step) + decode {r['decode_s']:.3f} s "
          f"| peak memory {r['peak'] / 2**30:.2f} GiB | launches "
          f"{ {k: v for k, v in launches.items() if v} } | fallback tiles recomputed "
          f"{r['recomputed']} | frames mean {frames.mean().item():.4f} std "
          f"{frames.std().item():.4f}, input mean {video.mean().item():.4f}", flush=True)
    assert frames.shape == (1, SMOOTH_FRAMES, cfg.height, cfg.width, 3), frames.shape
    assert torch.isfinite(latents).all() and torch.isfinite(frames).all(), "non-finite output"
    assert frames.min().item() >= 0.0 and frames.max().item() <= 1.0
    for name in INFERENCE:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by smoothing"
    for name in TRAINING + EXPERIMENTS:
        assert launches.get(name, 0) == 0, f"kernel {name} was launched by smoothing"
    del frames, latents, r
    torch.cuda.empty_cache()
    _profile_unet_step("smooth", pipe, 4 * pipe.n_chunks, gen)
    return launches


def _tiny_variant(device, kind: str, sequential_cfg: bool = False):
    """The tiny widths through the inference CLI's ``build_pipeline`` (``controlnet``,
    ``reverse`` = ControlNet with ``--reverse-time``, ``flow``, ``deep_cache`` = the base
    pipeline at ``deep_cache_interval=2`` over 4 steps), or built directly where the CLI
    has no such mode (``trans_controlnet``: the joint UNet of the tiny trans phase with a
    ControlNet at ``controlnet_cond_scale=0.5, controlnet_scale=0.8``; ``flow_fix``;
    ``joint_vf``)."""
    import dataclasses

    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.models.configs import SVDUNetConfig
    from lkgd_torch.models.controlnet_svd import ControlNetSDVConfig
    from lkgd_torch.pipelines import svd_controlnet, svd_flow
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    unet, vae, clip = _tiny_widths()
    widths = cli.Widths(unet, vae, clip, controlnet_embedding=(16, 32))  # the VAE's factor 2
    mode = {"reverse": "controlnet", "deep_cache": "base", "trans_controlnet": "trans",
            "flow_fix": "flow", "joint_vf": "trans"}.get(kind, kind)
    argv = ["--mode", mode, "--image", "-", "--height", "48", "--width", "48", "--num-frames",
            "4", "--num-inference-steps", "4" if kind == "deep_cache" else "3",
            "--decode-chunk-size", "2", "--dtype", "fp32", "--device", str(device),
            "--flip", "--temporal", "--lora-rank", "2"]
    argv += ["--sequential-cfg"] * sequential_cfg + ["--reverse-time"] * (kind == "reverse")
    args = cli.make_parser().parse_args(argv)
    if kind in ("controlnet", "reverse", "flow"):
        return cli.build_pipeline(args, widths)
    config = SVDPipelineConfig(height=48, width=48, num_frames=4,
                               num_inference_steps=args.num_inference_steps, decode_chunk_size=2,
                               sequential_cfg=sequential_cfg)
    kw = dict(config=config, unet_config=cli.unet_config(args, widths), vae_config=vae,
              clip_config=clip, dtype=torch.float32, device=device)
    if kind == "deep_cache":
        return StableVideoDiffusionPipeline(**{**kw, "config": dataclasses.replace(
            config, deep_cache_interval=2)})
    if kind == "trans_controlnet":
        return svd_controlnet.StableVideoDiffusionControlNetPipeline(
            **kw, controlnet_config=ControlNetSDVConfig(
                unet=kw["unet_config"], conditioning_embedding_out_channels=(16, 32)),
            controlnet_cond_scale=0.5, controlnet_scale=0.8)
    if kind == "flow_fix":
        kw["unet_config"] = SVDUNetConfig(**unet, in_channels=12, dual_cond_conv_in=True)
        return svd_flow.StableVideoDiffusionFlowPipeline(**kw, mode="flow_fix")
    return svd_flow.StableVideoDiffusionJointVFPipeline(**kw)  # joint_vf


def phase_tiny_variants(dev: torch.device) -> None:
    """The tiny ControlNet pipeline (batched, ``sequential_cfg``, ``reverse_time``,
    trans+ControlNet), DeepCache at ``dc=2`` and the flow pipelines (``flow``, ``flow_fix``,
    joint video+flow) on the GPU against the same pipeline on the CPU, every parameter
    random (the zero-init heads, ``conv_in2`` and its alpha included), at fp32 with the same
    noise, images and control video."""
    cases = [("controlnet", False), ("controlnet", True), ("reverse", False),
             ("trans_controlnet", False), ("trans_controlnet", True), ("deep_cache", False),
             ("flow", False), ("flow_fix", False), ("joint_vf", False)]
    for n, (kind, sequential) in enumerate(cases):
        label = f"tiny-{kind}{' sequential_cfg' if sequential else ''}"
        cpu = _tiny_variant("cpu", kind, sequential)
        _randomize(cpu, 40 + n)
        gpu = _tiny_variant(dev, kind, sequential)
        for src, dst in zip(_all_models(cpu), _all_models(gpu)):
            dst.load_state_dict(src.state_dict(), strict=True)
        rng = np.random.default_rng(20 + n)
        streams = 2 if kind in ("trans_controlnet", "joint_vf") else 1
        images = streams if kind != "joint_vf" else 1
        image = torch.from_numpy(rng.uniform(size=(images, 48, 48, 3)).astype(np.float32))
        kw = dict(noise_aug=torch.from_numpy(rng.standard_normal((images, 48, 48, 3))
                                             .astype(np.float32)),
                  initial_noise=torch.from_numpy(rng.standard_normal((streams, 4, 24, 24, 4))
                                                 .astype(np.float32)))
        if kind in ("controlnet", "reverse", "trans_controlnet"):
            kw["control"] = torch.from_numpy(rng.uniform(size=(4, 48, 48, 3)).astype(np.float32))
        if kind in ("flow", "flow_fix", "joint_vf"):
            kw["flow_cond"] = torch.from_numpy(rng.uniform(size=(1, 48, 48, 3)).astype(np.float32))
            kw["noise_aug2"] = torch.from_numpy(rng.standard_normal((1, 48, 48, 3))
                                                .astype(np.float32))
        outs = []
        for pipe in (cpu, gpu):
            latents = pipe.denoise(image, **kw)
            outs.append((latents, pipe.decode_latents(latents)))
        torch.cuda.synchronize()
        for i, name in enumerate(("latents", "frames")):
            got, want = outs[1][i].cpu(), outs[0][i]
            err = (got - want).abs().max().item()
            print(f"[{label}] GPU vs CPU fp32 {name} {tuple(want.shape)}: max|d| {err:.3e} "
                  f"(rtol 1e-4, atol 2e-4)", flush=True)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


def _all_models(pipe) -> tuple:
    controlnet = getattr(pipe, "controlnet", None)
    return pipe.models + ((controlnet,) if controlnet is not None else ())


def _fill_zero_init(pipe, gen: torch.Generator) -> int:
    """The zero-init heads of the ControlNet (the embedder's ``conv_out``, every
    ``controlnet_*`` head) filled with 0.02 x normal, so that the clip's values really pass
    through the ControlNet and a wrong branch would show; returns the tensors filled."""
    filled = 0
    with torch.no_grad():
        for name, p in pipe.controlnet.named_parameters():
            if name.startswith(("controlnet_cond_embedding.conv_out.", "controlnet_down_blocks.",
                                "controlnet_mid_block.")):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
                filled += 1
    return filled


def _timed_clip(dev, run, decode, seed: int) -> dict:
    """``run(generator)`` -> latents, then ``decode(latents)``, from zeroed counters: times,
    peak memory, launch counts, outputs."""
    from lkgd_torch.ops import flash_attention as fa

    _zero_counts()
    fa.recomputed_tiles(dev).zero_()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = run(gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    denoise_peak = torch.cuda.max_memory_allocated(dev)
    frames = decode(latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"s": t2 - t0, "denoise_s": t1 - t0, "decode_s": t2 - t1, "denoise_peak": denoise_peak,
            "peak": torch.cuda.max_memory_allocated(dev), "launches": _read_counts(),
            "recomputed": int(fa.recomputed_tiles(dev).item()), "latents": latents,
            "frames": frames}


def _clip_line(label: str, r: dict, steps: int) -> str:
    return (f"[{label}] {r['s']:.3f} s/clip = denoise {r['denoise_s']:.3f} s ({steps} steps) + "
            f"decode {r['decode_s']:.3f} s | peak memory {r['peak'] / 2**30:.2f} GiB (denoise "
            f"alone {r['denoise_peak'] / 2**30:.2f}) | launches "
            f"{ {k: v for k, v in r['launches'].items() if v} } | fallback tiles recomputed "
            f"{r['recomputed']}")


def _check_clip(label: str, r: dict, streams: int, cfg) -> None:
    latents, frames, launches = r["latents"], r["frames"], r["launches"]
    assert frames.shape == (streams, cfg.num_frames, cfg.height, cfg.width, 3), frames.shape
    assert torch.isfinite(latents).all() and torch.isfinite(frames).all(), "non-finite output"
    assert frames.min().item() >= 0.0 and frames.max().item() <= 1.0
    for name in INFERENCE:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by the {label} clip"
    for name in TRAINING + EXPERIMENTS:
        assert launches.get(name, 0) == 0, f"kernel {name} was launched by the {label} clip"


def _synthetic_video(cfg, dev, frames: int, gen: torch.Generator) -> torch.Tensor:
    """A drifting colour gradient with a little noise, ``(frames, H, W, 3)`` in [0, 1]."""
    t = torch.arange(frames, device=dev, dtype=torch.float32)[:, None, None, None]
    yy = torch.linspace(0, 1, cfg.height, device=dev)[None, :, None, None]
    xx = torch.linspace(0, 1, cfg.width, device=dev)[None, None, :, None]
    phase = torch.tensor([0.0, 2.1, 4.2], device=dev)
    video = 0.5 + 0.4 * torch.sin(6 * xx + 4 * yy + 0.15 * t + phase)
    return (video + 0.02 * torch.randn(video.shape, generator=gen, device=dev)).clamp(0, 1)


def phase_controlnet_full(dev: torch.device) -> dict:
    """The full-width ControlNet clip through the inference CLI's ``build_pipeline``
    (``--mode controlnet``): SVD widths, a ControlNet at the same widths with the embedder
    (16, 32, 96, 256), a synthetic 14-frame control video, 14x576x1024, 25 steps, bf16; a
    warm-up (``WARM_STEPS``), a timed batched-CFG clip (28 UNet rows) and a timed
    ``sequential_cfg`` clip;
    then one step under ``torch.profiler``, the ControlNet and the UNet apart."""
    import dataclasses

    from lkgd_torch.cli import run_inference_svd as cli

    args = cli.make_parser().parse_args(
        ["--mode", "controlnet", "--image", "-", "--decode-chunk-size", "14", "--seed", "0",
         "--device", str(dev), "--sequential-cfg"])  # builds both UNet forms
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    cfg = pipe.config
    gen = torch.Generator(device=dev).manual_seed(5)
    filled = _fill_zero_init(pipe, gen)
    n_unet = sum(p.numel() for m in pipe.models for p in m.parameters())
    n_cn = sum(p.numel() for p in pipe.controlnet.parameters())
    image = torch.rand((1, cfg.height, cfg.width, 3), generator=gen, device=dev)
    control = _synthetic_video(cfg, dev, cfg.num_frames, gen)
    torch.cuda.synchronize()
    print(f"[controlnet] {n_unet / 1e9:.3f} B + ControlNet {n_cn / 1e9:.3f} B bf16 random "
          f"params ({filled} zero-init head tensors 0.02 x normal), embedder "
          f"{pipe.controlnet.config.conditioning_embedding_out_channels}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    for label, seed, sequential in (("warm-up, batched CFG (28 UNet rows)", 1, False),
                                    ("batched CFG (28 UNet rows)", 2, False),
                                    ("sequential_cfg (2 x 14 UNet rows)", 2, True)):
        pipe.config = dataclasses.replace(cfg, sequential_cfg=sequential)
        warm = label.startswith("warm-up")
        runs[label] = r = _timed_clip(
            dev, lambda g: (_short(pipe, lambda: pipe.denoise(image, g, control=control))
                            if warm else pipe.denoise(image, g, control=control)),
            pipe.decode_latents, seed)
        print(_clip_line(f"controlnet] [{label}", r,
                         WARM_STEPS if warm else cfg.num_inference_steps), flush=True)
    pipe.config = cfg
    timed, seq = runs["batched CFG (28 UNet rows)"], runs["sequential_cfg (2 x 14 UNet rows)"]
    _check_clip("controlnet", timed, 1, cfg)
    assert torch.isfinite(seq["frames"]).all(), "non-finite sequential_cfg output"
    forms = (seq["latents"] - timed["latents"]).abs().max().item()
    print(f"[controlnet] frames mean {timed['frames'].mean().item():.4f} std "
          f"{timed['frames'].std().item():.4f} | sequential_cfg vs batched latents max|d| "
          f"{forms:.3f} of max|latent| {timed['latents'].abs().max().item():.3f} (bf16)",
          flush=True)
    launches = timed["launches"]
    del runs, timed, seq
    torch.cuda.empty_cache()

    # one step of 28 rows: the ControlNet, then the UNet with its residuals
    rows = 2
    model_in = torch.randn((rows, cfg.num_frames, pipe.latent_height, pipe.latent_width, 8),
                           generator=gen, device=dev).to(pipe.dtype)
    emb = torch.randn((rows, 1, 1024), generator=gen, device=dev).to(pipe.dtype)
    ids = pipe._add_time_ids(rows)
    t = pipe.schedule.timesteps[5]
    ctl = torch.cat([control[None]] * rows).to(pipe.dtype)
    with torch.inference_mode():
        down, mid = pipe.controlnet(model_in, t, emb, ids, controlnet_cond=ctl)
    _profiled("controlnet", f"the ControlNet of one step ({rows * cfg.num_frames} rows)",
              lambda: pipe.controlnet(model_in, t, emb, ids, controlnet_cond=ctl))
    _profiled("controlnet", f"the UNet with residuals of one step ({rows * cfg.num_frames} rows)",
              lambda: pipe.unet(model_in, t, emb, ids, down_block_additional_residuals=down,
                                mid_block_additional_residual=mid))
    return launches


def phase_deep_cache_full(dev: torch.device) -> dict:
    """The base clip (14x576x1024, 25 steps, CFG batched, bf16) at ``deep_cache_interval``
    1, 2 and 3 on one pipeline, the same seed: sec/clip, the full and cached steps, the
    launches of each clip and of one full and one cached UNet call, the device time of a
    full against a cached step under ``torch.profiler``, and the latents' relative distance
    from ``dc=1``'s (printed: DeepCache is an approximation)."""
    import dataclasses

    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    cfg = SVDPipelineConfig(height=576, width=1024, num_frames=14, num_inference_steps=25,
                            decode_chunk_size=14)
    t0 = time.perf_counter()
    pipe = StableVideoDiffusionPipeline(config=cfg, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe.init_params(gen)
    image = torch.rand((1, cfg.height, cfg.width, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[deep-cache] set-up {time.perf_counter() - t0:.1f} s", flush=True)
    by_dc, exact = {}, None
    for dc in (1, 2, 3):
        pipe.config = dataclasses.replace(cfg, deep_cache_interval=dc)
        r = _timed_clip(dev, lambda g: pipe.denoise(image, g), pipe.decode_latents, 7)
        full = sum(1 for i in range(cfg.num_inference_steps) if i % dc == 0)
        if dc == 1:
            exact = r["latents"]
            distance = 0.0
        else:
            distance = ((r["latents"] - exact).norm() / exact.norm()).item()
            _check_clip(f"dc={dc}", r, 1, cfg)
            by_dc[dc] = r["launches"]
        print(_clip_line(f"deep-cache] [dc={dc}", r, cfg.num_inference_steps)
              + f" | {full} full + {cfg.num_inference_steps - full} cached steps | latents "
              f"|d|/|dc=1| {distance:.4f}", flush=True)
        del r
    pipe.config = cfg
    del exact

    # one full and one cached UNet call of 28 rows: launches and device time
    rows = 2
    model_in = torch.randn((rows, cfg.num_frames, pipe.latent_height, pipe.latent_width, 8),
                           generator=gen, device=dev).to(pipe.dtype)
    emb = torch.randn((rows, 1, 1024), generator=gen, device=dev).to(pipe.dtype)
    ids = pipe._add_time_ids(rows)
    t = pipe.schedule.timesteps[5]
    step_launches = {}
    with torch.inference_mode():
        _, feature = pipe.unet(model_in, t, emb, ids, return_deep_feature=True)
        for kind, cache in (("full", None), ("cached", feature)):
            torch.cuda.synchronize()
            _zero_counts()
            pipe.unet(model_in, t, emb, ids, deep_cache=cache)
            torch.cuda.synchronize()
            step_launches[kind] = {k: v for k, v in _read_counts().items() if v}
    print(f"[deep-cache] one UNet call of {rows * cfg.num_frames} rows: launches full "
          f"{step_launches['full']} | cached {step_launches['cached']} | cached feature "
          f"{tuple(feature.shape)}", flush=True)
    for name in INFERENCE:
        assert 0 < step_launches["cached"].get(name, 0) < step_launches["full"][name], \
            f"a cached step must launch {name} fewer times than a full one, and at least once"
    _profiled("deep-cache", f"one full UNet step ({rows * cfg.num_frames} rows)",
              lambda: pipe.unet(model_in, t, emb, ids))
    _profiled("deep-cache", f"one cached UNet step ({rows * cfg.num_frames} rows)",
              lambda: pipe.unet(model_in, t, emb, ids, deep_cache=feature))
    return by_dc


def phase_flow_full(dev: torch.device) -> dict:
    """The full-width flow clip through the inference CLI's ``build_pipeline``
    (``--mode flow``: the frame is its own flow-condition image), 14x576x1024, 25 steps,
    bf16; every shape it runs was warmed by the base clip, so one timed clip."""
    from lkgd_torch.cli import run_inference_svd as cli

    args = cli.make_parser().parse_args(["--mode", "flow", "--image", "-",
                                         "--decode-chunk-size", "14", "--seed", "0",
                                         "--device", str(dev)])
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    cfg = pipe.config
    gen = torch.Generator(device=dev).manual_seed(6)
    image = torch.rand((1, cfg.height, cfg.width, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"[flow] set-up {time.perf_counter() - t0:.1f} s", flush=True)

    # the decode of __call__: the flow latents un-normalised first
    r = _timed_clip(dev, lambda g: pipe.denoise(image, g, flow_cond=image), pipe._frames, 8)
    print(_clip_line("flow", r, cfg.num_inference_steps)
          + f" | frames mean {r['frames'].mean().item():.4f} std {r['frames'].std().item():.4f}",
          flush=True)
    _check_clip("flow", r, 1, cfg)
    return r["launches"]


# ---------------------------------------------------------------- CogVideoX
COG_FLASH = (2, 17776, 48, 64)  # the 5B DiT's joint attention: CFG x (226 + 13 x 30 x 45)
COG_GN = (("decode full res", (1, 49 * 480 * 720, 128)),  # the decoder's last level
          ("decode level 2", (1, 25 * 240 * 360, 256)))


def in_head_blocks(fn, tensors, heads: int = 4):
    """``fn`` over blocks of one row and ``heads`` heads: (B, S, H, D) tensors cut on axes 0
    and 2, (B, H, S) rows (lse, delta) on axes 0 and 1, each output joined the same way. The
    plain flash versions' fp32 logits at 48 heads of 17776 tokens would be 60.7 GB a row,
    and the plain backward holds several tensors of that size."""
    def cut(x, i, j):
        return x[i:i + 1, :, j:j + heads] if x.dim() == 4 else x[i:i + 1, j:j + heads]

    b, h = tensors[0].shape[0], tensors[0].shape[2]
    rows = []
    for i in range(b):
        outs = [fn(*(cut(x, i, j) for x in tensors)) for j in range(0, h, heads)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        rows.append([torch.cat(col, dim=2 if col[0].dim() == 4 else 1) for col in zip(*outs)])
    out = tuple(torch.cat(col) for col in zip(*rows))
    return out if len(out) > 1 else out[0]


def heads_of(n: int) -> tuple:
    """The plain versions run over blocks of one row and ``n`` heads, and its name."""
    return (lambda fn, tensors: in_head_blocks(fn, tensors, n)), f"blocks of {n} heads"


def rows_of(n: int) -> tuple:
    """The plain versions run over chunks of ``n`` rows, and its name."""
    return (lambda fn, tensors: in_row_chunks(fn, tensors, n)), f"chunks of {n} rows"


def _kernel_name(key: str) -> str:
    """A profiler key as ``name<template arguments>``: casts, spaces, namespaces and the
    parameter list dropped."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cast in ("(int)", "(bool)", " "):
        name = name.replace(cast, "")
    return name.split("(")[0]


def _device_kernel_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of ``fn`` by kernel name under ``torch.profiler`` (``calls`` calls
    after a warm-up)."""
    from lkgd_torch.experiments.group_norm_ab import profiled

    out = {}
    for key, ms in profiled(fn, calls)["ms"].items():
        name = _kernel_name(key)
        out[name] = out.get(name, 0.0) + ms
    return out


def _timed_kernel(fn, prefix: str, suffix: str = "") -> dict:
    """``ms``: the device ms a call of ``fn``'s kernels named ``prefix...suffix`` under
    ``torch.profiler``; ``call_device_ms``: of every operation the call enqueues;
    ``wrapper_ms``: the call's ms between CUDA events (20 calls), which the host paces
    where it is the longer."""
    device = _device_kernel_ms(fn)
    ms = sum(t for n, t in device.items() if n.startswith(prefix) and n.endswith(suffix))
    assert ms > 0.0, (prefix, suffix, device)
    return {"ms": ms, "call_device_ms": sum(device.values()), "wrapper_ms": gpu_ms(fn, 20)}


def _paced(t: dict) -> str:
    pace = "the host" if t["wrapper_ms"] > 1.1 * t["call_device_ms"] else "the device"
    return (f"kernel {t['ms']:.4f} ms on the device (torch.profiler), the call's device "
            f"operations {t['call_device_ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms a call "
            f"(CUDA events): {pace} sets the pace")


def _key_norm_row(tag: str, label: str, k: torch.Tensor) -> dict:
    """Kernel 1a on (B, S, H, D) keys against its plain version (fp32 sums in another
    order: rtol 1e-5)."""
    from lkgd_torch.ops import flash_attention as fa

    got, want = fa.key_norm_max(k), fa.key_norm_max_plain(k)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    t = _timed_kernel(lambda: fa.key_norm_max(k), "key_sq_max")
    plain_ms = gpu_ms(lambda: fa.key_norm_max_plain(k), 20)
    # k read once, (B, H) fp32 written; 2 fp32 operations an element
    least = bound(2 * k.numel(), k.numel() * k.element_size() + k.shape[0] * k.shape[2] * 4,
                  PEAK_FP32)
    print(f"[{tag}] flash_key_norm {label} (B,S,H,D)={tuple(k.shape)}: max|d| {err:.3e} "
          f"(rtol 1e-5) | {_paced(t)} | plain {plain_ms:.4f} ms, bound "
          f"{least['bound_ms']:.4f} ms by {least['bound_by']}", flush=True)
    return {"shape": list(k.shape), "max_abs_err": err, **t, "plain_ms": plain_ms,
            "library_ms": None, **least}


def _forward_rows(tag: str, label: str, shape, gen: torch.Generator, plain_in) -> dict:
    """Kernels 1, 2 and 1a on random bf16 (B, S, H, D) q, k, v against their plain versions
    (run as ``plain_in`` says), with the kernels' device time, the wrappers', the library
    call's and the bound; returns these rows by kernel."""
    from lkgd_torch.ops import flash_attention as fa

    chunk, note = plain_in
    dev = gen.device
    q, k, v = (torch.randn(shape, device=dev, generator=gen).bfloat16() for _ in range(3))
    want = chunk(lambda *a: fa.flash_attention_maxtrack_plain(*(x.float() for x in a)), (q, k, v))
    ref_max = want.abs().max().item()
    least, lib_ms = flash_bound(shape), sdpa_ms(q, k, v, reps=20)
    plan = fa.flash_plan(shape[0], shape[1], shape[1], shape[2], shape[3])
    rows = {}
    for kernel, plain, form in (("flash_bound", fa.flash_attention_bound_plain, "true,false>"),
                                ("flash_maxtrack", fa.flash_attention_maxtrack_plain,
                                 "false,false>")):
        if kernel == "flash_maxtrack":
            os.environ["LKGD_FLASH_MAXTRACK"] = "1"
        try:
            counter = fa.recomputed_tiles(dev)
            counter.zero_()
            err = (fa.flash_attention(q, k, v).float() - want).abs().max().item()
            torch.cuda.synchronize()
            recomputed = int(counter.item())
            t = _timed_kernel(lambda: fa.flash_attention(q, k, v), "flash_fwd_wgmma_kernel<", form)
        finally:
            os.environ.pop("LKGD_FLASH_MAXTRACK", None)
        plain_ms = gpu_ms(lambda: chunk(plain, (q, k, v)), reps=1)
        print(f"[{tag}] {kernel} {label} (B,S,H,D)={shape}: max|d| {err:.3e} of max|ref| "
              f"{ref_max:.3e} (tol {FLASH_TOL} x max|ref|) | {_paced(t)} | plain {plain_ms:.3f} "
              f"ms ({note}), library sdpa {lib_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
              f"{least['bound_by']} ({_versus(t['ms'], lib_ms, least)}) | {plan.blocks} blocks "
              f"of {plan.tile_rows} rows | tiles recomputed {recomputed}", flush=True)
        assert np.isfinite(err) and err <= FLASH_TOL * ref_max, (kernel, label, err, ref_max)
        rows[kernel] = {"shape": list(shape), "max_abs_err": err, **t, "plain_ms": plain_ms,
                        "library_ms": lib_ms, **least}
    rows["flash_key_norm"] = _key_norm_row(tag, label, k)
    return rows


def _lse_rows(tag: str, label: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              plain_in) -> dict:
    """Kernels 7 and 8 (the LSE forwards) on bf16 q (B, S_q, H, D) and k, v (B, S_k, H, D)
    against their plain versions (run as ``plain_in`` says): out within FLASH_TOL x max|ref|,
    lse within LSE_TOL log2 units, with the kernels' device time, the wrappers', the
    library call's and the bound; returns these rows by kernel."""
    from lkgd_torch.ops import flash_attention as fa

    chunk, note = plain_in
    dev = q.device
    shape, s_k = tuple(q.shape), k.shape[1]
    want_out, want_lse = chunk(lambda *a: fa.flash_fwd_lse_maxtrack_plain(
        *(x.float() for x in a)), (q, k, v))
    out_tol = FLASH_TOL * want_out.abs().max().item()
    lib_ms, least = sdpa_ms(q, k, v, reps=20), flash_bound(shape, s_k, rows_fp32=1)
    keys = "" if s_k == shape[1] else f" x {s_k} keys"
    rows = {}
    for kernel, plain, form in (("flash_bound_lse", fa.flash_fwd_lse_bound_plain, "true,true>"),
                                ("flash_maxtrack_lse", fa.flash_fwd_lse_maxtrack_plain,
                                 "false,true>")):
        if kernel == "flash_maxtrack_lse":
            os.environ["LKGD_FLASH_MAXTRACK"] = "1"
        try:
            counter = fa.recomputed_tiles(dev)
            counter.zero_()
            out, lse = fa.flash_fwd_lse(q, k, v)
            torch.cuda.synchronize()
            recomputed = int(counter.item())
            t = _timed_kernel(lambda: fa.flash_fwd_lse(q, k, v), "flash_fwd_wgmma_kernel<", form)
        finally:
            os.environ.pop("LKGD_FLASH_MAXTRACK", None)
        out_err = (out.float() - want_out).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        plain_ms = gpu_ms(lambda: chunk(plain, (q, k, v)), reps=1)
        print(f"[{tag}] {kernel} {label} (B,S,H,D)={shape}{keys}: out max|d| {out_err:.3e} of "
              f"max|ref| {out_tol / FLASH_TOL:.3e} (tol {FLASH_TOL} x max|ref|), lse max|d| "
              f"{lse_err:.3e} (tol {LSE_TOL}) | {_paced(t)} | plain {plain_ms:.3f} ms ({note}), "
              f"library sdpa {lib_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
              f"{least['bound_by']} ({_versus(t['ms'], lib_ms, least)}) | tiles recomputed "
              f"{recomputed}", flush=True)
        assert np.isfinite(out_err) and out_err <= out_tol, (kernel, label, out_err, out_tol)
        assert np.isfinite(lse_err) and lse_err <= LSE_TOL, (kernel, label, lse_err)
        rows[kernel] = {"max_abs_err": out_err, **t, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **least}
    return rows


def _train_rows(tag: str, label: str, shape, gen: torch.Generator, plain_in) -> dict:
    """Kernels 5/6, 7/8 and 9/10 at a training step's (B, S, H, D) self-attention against
    their plain versions (run as ``plain_in`` says), with the kernels' device time, the
    wrappers', the library calls' and the bound; returns these rows by kernel."""
    import torch.nn.functional as F

    from lkgd_torch.ops import flash_attention as fa

    chunk, note = plain_in
    dev = gen.device

    def randn(*s):
        return torch.randn(*s, device=dev, generator=gen).bfloat16()

    rows = _relayout_check(fa, label, shape, shape[1], randn)
    xs = tuple(randn(*shape) for _ in range(3))
    split = fa.split_heads_many(*xs)
    for name, fn, grouped in (("split_heads", lambda: fa.split_heads_many(*xs), "<true>"),
                              ("merge_heads", lambda: fa.merge_heads_many(*split), "<false>")):
        t = _timed_kernel(fn, "relayout_heads_kernel", grouped)
        print(f"[{tag}] {name} {label} 3 x (B,S,H,D)={shape}: {_paced(t)}", flush=True)
        rows[name].update(t)
    del xs, split

    q, k, v, do = (randn(*shape) for _ in range(4))
    rows.update(_lse_rows(tag, label, q, k, v, plain_in))

    # the library's backward for kernels 9 and 10 together: autograd through its fused
    # attention on the same inputs
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves)
    lib_bwd_ms = gpu_ms(lambda: torch.autograd.grad(lib_out, leaves, do.transpose(1, 2),
                                                    retain_graph=True), 20)
    del lib_out, leaves
    # the backward from the guarded forward's out and lse, as the autograd Function
    out, lse = fa.flash_fwd_lse(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    for kernel, fn, plain, names in (
            ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
            ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv"))):
        dkv = kernel == "flash_bwd_dkv"

        def plain_run():
            return chunk(lambda q_, k_, v_, do_, lse_, delta_: plain(
                q_.float(), k_.float(), v_.float(), do_.float(), lse_, delta_), args)

        got, again, want = fn(*args), fn(*args), plain_run()
        got, again, want = (got, again, want) if dkv else ((got,), (again,), (want,))
        errs = {}
        for name, g, g2, w in zip(names, got, again, want):
            assert torch.isfinite(g).all(), (kernel, label, name)
            # no atomics: two launches give the same bits
            assert torch.equal(g, g2), f"{kernel} {label}: {name} differs between launches"
            errs[name] = ((g.float() - w.float()).abs().max().item(), w.float().abs().max().item())
        del got, again, want
        t = _timed_kernel(lambda: fn(*args), kernel)
        plain_ms = gpu_ms(plain_run, reps=1)
        plan = fa.flash_bwd_plan(shape[0], shape[1], shape[1], shape[2], shape[3], dkv)
        # dq: 3 S x S x D products, q, dO and dq on the query side, k and v on the key side;
        # dk/dv: 4 products, q and dO, k, v, dk and dv; lse and delta
        least = flash_bound(shape, products=4 if dkv else 3, q_tensors=2 if dkv else 3,
                            k_tensors=4 if dkv else 2, rows_fp32=2)
        print(f"[{tag}] {kernel} {label} (B,S,H,D)={shape}: " + ", ".join(
            f"{n} max|d| {e:.3e} of max|ref| {m:.3e} (tol {GRAD_TOL} x max|ref|)"
            for n, (e, m) in errs.items()) + f", two launches bit-identical | {_paced(t)} | "
              f"plain {plain_ms:.3f} ms ({note}), library sdpa backward (dq, dk and dv "
              f"together) {lib_bwd_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
              f"{least['bound_by']} ({100 * least['bound_ms'] / t['ms']:.1f}% of bound) | plan "
              f"{plan.blocks} blocks, {plan.waves:.2f} waves, {plan.tile_rows} resident rows",
              flush=True)
        for name, (e, m) in errs.items():
            assert e <= GRAD_TOL * m, (kernel, label, name, e, m)
        # library_ms is one backward for both kernels' work: the same number in both
        rows[kernel] = {"max_abs_err": max(e for e, _ in errs.values()), **t,
                        "plain_ms": plain_ms, "library_ms": lib_bwd_ms, **least}
    pair_ms = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    print(f"[{tag}] backward pair {label}: kernels 9 + 10 {pair_ms:.4f} ms = "
          f"{pair_ms / lib_bwd_ms:.2f} x the library backward ({lib_bwd_ms:.4f} ms), bound "
          f"{rows['flash_bwd_dq']['bound_ms'] + rows['flash_bwd_dkv']['bound_ms']:.4f} ms",
          flush=True)
    for r in rows.values():
        r["shape"] = list(shape)
    return rows


def _gn_rows(tag: str, label: str, shape, gen: torch.Generator, eps: float, acts,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """Kernels 3 and 4 on random (N, M, C) x of ``dtype``, 32 groups, against their plain
    versions, the output compared in slices of 2^21 rows (the fp32 temporaries of 2^31
    elements stay small), with the kernels' device time, the wrappers', the library call's
    and the bound. In bf16 kernel 4 is held on the plain statistics; in fp32 on kernel 3's
    own a, b (kernel 3 held to the plain ones at 1e-4 relative), so that GN_TOL's 1e-5 is
    kernel 4's rounding alone. Where ``fused_plan`` finds a slab the forward is the one-pass
    kernel: its a, b held to its plain merge order's at 1e-4 relative, two calls
    bit-identical, its device time (one device operation asserted). Returns ``gn_stats``'s
    row, and ``gn_apply``'s and ``gn_one_pass``'s for each act in ``acts`` (lists; the
    latter empty for a two-pass shape)."""
    import torch.nn.functional as F

    from lkgd_torch.experiments.group_norm_ab import device_times
    from lkgd_torch.ops import group_norm as gn

    dev = gen.device
    n, m, c = shape
    x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dtype)
    w = (torch.randn(c, device=dev, generator=gen) * 0.1 + 1.0).to(dtype)
    b = (torch.randn(c, device=dev, generator=gen) * 0.1).to(dtype)
    size = x.element_size()
    kw = dict(num_groups=32, eps=eps)
    plan = gn.chunk_plan(n, m, c, 32, x.element_size())
    fused = gn.fused_plan(n, m, c, 32, x.element_size())
    a_got, b_got = gn.group_norm_affine(x, w, b, **kw)
    # the plain version on the same bf16 inputs (one-pass fp32 sums), its output unrounded
    a_want, b_want = gn.group_norm_affine_plain(x, w, b, **kw)
    stats_err = max((a_got - a_want).abs().max().item(), (b_got - b_want).abs().max().item())
    # a, b within 1e-4 relative: a one-pass variance cancels to ~1e-5
    stats_rel = max(((g - t).abs().max() / t.abs().max().clamp(min=1.0)).item()
                    for g, t in ((a_got, a_want), (b_got, b_want)))
    assert stats_rel <= 1e-4, (label, stats_rel)
    x_nchw = x.view(n, m, 1, c).permute(0, 3, 1, 2)
    n_el = x.numel()
    # stats: x read once, (N, C) fp32 a and b written, ~3 fp32 operations an element;
    # apply: x read, y written, a and b read, ~8 operations an element with SiLU
    stats_least = bound(3 * n_el, n_el * size + 2 * n * c * 4, PEAK_FP32)
    stats_plain_ms = gpu_ms(lambda: gn.group_norm_affine_plain(x, w, b, **kw), 1)
    stats, apply_rows, one_rows = None, [], []
    one_line = "two passes"
    if fused is not None:
        y1, a1, b1 = gn.group_norm_one_pass(x, w, b, **kw)
        one_rel = max(((g - t).abs().max() / t.abs().max().clamp(min=1.0)).item() for g, t in
                      zip((a1, b1), gn.group_norm_affine_slabs_plain(x, w, b, plan=fused, **kw)))
        same = all(torch.equal(g, f) for g, f in zip(gn.group_norm_one_pass(x, w, b, **kw),
                                                     (y1, a1, b1)))
        assert one_rel <= 1e-4 and same, (label, one_rel, same)
        one_line = (f"one pass ({fused.slab_groups} groups a slab, clusters of {fused.cluster}; "
                    f"a, b relative {one_rel:.2e}, two calls bit-identical)")
        del y1
    for act in acts:
        got = gn.group_norm(x, w, b, act=act, **kw)
        step = 1 << 21
        a_ref, b_ref = (a_want, b_want) if dtype == torch.bfloat16 else (a_got, b_got)
        err = max((got[:, i:i + step].float() - gn.group_norm_apply_plain(
            x[:, i:i + step].float(), a_ref, b_ref, act)).abs().max().item()
            for i in range(0, m, step))
        del got
        assert np.isfinite(err) and err <= GN_TOL[dtype], (label, act, err)
        dev_t = device_times(x, w, b, act)
        assert dev_t["forward_device_ops"] == 1 if fused else dev_t["forward_device_ops"] <= 3, \
            (label, dev_t)
        stats = {"ms": dev_t["stats_kernel_ms"], "call_device_ms": dev_t["stats_device_ms"],
                 "wrapper_ms": gpu_ms(lambda: gn.group_norm_affine(x, w, b, **kw), 20)}
        apply = {"ms": dev_t["apply_device_ms"], "call_device_ms": dev_t["apply_device_ms"],
                 "wrapper_ms": gpu_ms(lambda: gn.group_norm_apply(x, a_got, b_got, act), 20)}
        apply_plain_ms = gpu_ms(lambda: gn.group_norm_apply_plain(x, a_got, b_got, act), 1)
        lib_ms = gpu_ms(lambda: (F.silu if act else (lambda y: y))(
            F.group_norm(x_nchw, 32, w, b, eps)), 5)
        apply_least = bound((8 if act else 2) * n_el, 2 * n_el * size + 2 * n * c * 4, PEAK_FP32)
        forward = {"ms": dev_t["forward_device_ms"], "call_device_ms": dev_t["forward_device_ms"],
                   "wrapper_ms": gpu_ms(lambda: gn.group_norm(x, w, b, act=act, **kw), 20)}
        print(f"[{tag}] group_norm {label} {tuple(shape)} {str(dtype)[6:]} eps {eps:g} act={act} "
              f"({n_el / 2**31:.3f} x 2^31 elements; {one_line}; the forward {_paced(forward)}, "
              f"{dev_t['forward_device_ops']:.0f} device operations; stats plan "
              f"{plan.n_chunks} chunks of {plan.rows_per_chunk} rows, tile {plan.tile}): "
              f"max|d| {err:.3e} (tol "
              f"{GN_TOL[dtype]}), affine max|d| {stats_err:.3e}, relative "
              f"{stats_rel:.2e} (tol 1e-4) | stats+fold {_paced(stats)}, plain "
              f"{stats_plain_ms:.4f} ms, bound {stats_least['bound_ms']:.4f} ms | apply "
              f"{_paced(apply)}, plain {apply_plain_ms:.4f} ms, bound "
              f"{apply_least['bound_ms']:.4f} ms | library group_norm{'+silu' if act else ''} "
              f"(both passes) {lib_ms:.4f} ms", flush=True)
        # library_ms is one call for both kernels' work: the same number in both
        apply_rows.append({"shape": list(shape), "eps": eps, "act": act, "max_abs_err": err,
                           **apply, "plain_ms": apply_plain_ms, "library_ms": lib_ms,
                           **apply_least})
        if fused is not None:  # the plain forward: the two plain passes
            one_rows.append({"shape": list(shape), "eps": eps, "act": act, "max_abs_err": err,
                             **forward, "plain_ms": stats_plain_ms + apply_plain_ms,
                             "library_ms": lib_ms, **apply_least})
    stats_row = {"shape": list(shape), "eps": eps, "max_abs_err": stats_err,
                 "max_rel_err": stats_rel, **stats, "plain_ms": stats_plain_ms,
                 "library_ms": lib_ms, **stats_least}
    del x, x_nchw, a_got, b_got, a_want, b_want
    return {"gn_stats": stats_row, "gn_apply": apply_rows, "gn_one_pass": one_rows}


def phase_cogvideox_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels 1, 2 and 1a at the 5B DiT's (2, 17776, 48, 64) (ragged against the 128-row
    tiles: 138 full tiles and 112 rows; the plain version in blocks of 4 heads) and kernels
    3 and 4 at the whole-clip decode's N=1 shapes, each against its plain version, with the
    library call's time and the bound; returns these rows by kernel (GroupNorm's at the
    decoder's last level)."""
    rows = _forward_rows("cogvideox-kernel", "5B DiT", COG_FLASH, gen, heads_of(4))
    torch.cuda.empty_cache()
    for label, shape in COG_GN:
        gn_rows = _gn_rows("cogvideox-kernel", label, shape, gen, 1e-6, ("silu",))
        if label == "decode full res":
            rows.update(gn_stats=gn_rows["gn_stats"], gn_apply=gn_rows["gn_apply"][0])
        del gn_rows
        torch.cuda.empty_cache()
    return rows


COG_TINY_PIPE = dict(height=32, width=48, num_frames=9, num_inference_steps=3,
                     vae_scale_factor_spatial=4)  # 3 latent frames of 8 x 12


def _cogvideox_tiny_pipe(device, kind: str, scheduler: str, overrides: dict):
    import dataclasses

    from lkgd_torch.models.configs import CogVideoXConfig
    from lkgd_torch.pipelines import cogvideox_i2v as cog

    cls = {"i2v": cog.CogVideoXImageToVideoPipeline, "t2v": cog.CogVideoXTextToVideoPipeline,
           "v2v": cog.CogVideoXVideoToVideoPipeline}[kind]
    extra = {"strength": 0.67} if kind == "v2v" else {}
    return cls(config=cog.CogVideoXPipelineConfig(**COG_TINY_PIPE, scheduler=scheduler),
               transformer_config=dataclasses.replace(CogVideoXConfig.tiny(), **overrides),
               dtype=torch.float32, device=device, **extra)


def _close_line(label: str, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    got = got.cpu()
    err = (got - want).abs().max().item()
    print(f"[{label}] GPU vs CPU fp32 {name} {tuple(want.shape)}: max|d| {err:.3e} (rtol 1e-4, "
          f"atol 2e-4)", flush=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


def phase_tiny_cogvideox(dev: torch.device) -> None:
    """The tiny CogVideoX pipelines (I2V with DPM, T2V with DDIM, V2V with DPM from step 1
    of 3, the 1.5 form's I2V) and the tiny VAE (encode and decode of a whole clip, chunked,
    tiled) on the GPU against the CPU at fp32, every parameter random, the same noise."""
    from lkgd_torch.models import vae_cogvideox as tvae
    from lkgd_torch.models.configs import CogVideoXVAEConfig
    from lkgd_torch.models.layers import materialize

    cases = [("i2v", "dpm", {}), ("t2v", "ddim", {"in_channels": 4}),
             ("v2v", "dpm", {"in_channels": 4}), ("i2v", "dpm", {"patch_size_t": 2})]
    for n, (kind, scheduler, overrides) in enumerate(cases):
        form = " 1.5" if overrides.get("patch_size_t") else ""
        label = f"tiny-cogvideox {kind} {scheduler}{form}"
        cpu = _cogvideox_tiny_pipe("cpu", kind, scheduler, overrides)
        gpu = _cogvideox_tiny_pipe(dev, kind, scheduler, overrides)
        g = torch.Generator().manual_seed(60 + n)
        with torch.no_grad():
            for p in cpu.transformer.parameters():  # the zero-init fusion output too
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        gpu.transformer.load_state_dict(cpu.transformer.state_dict(), strict=True)
        cfg = cpu.transformer.config
        shape = (1, cpu.latent_frames, 8, 12, cfg.out_channels)
        rng = np.random.default_rng(70 + n)

        def normal(*s):
            return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

        kw = dict(domain_features=normal(1, 1, 1000), flow_features=normal(1, 1, 1000),
                  step_noise=normal(3, *shape))
        prompt = normal(1, cfg.max_text_seq_length, cfg.text_embed_dim)
        if kind == "i2v":
            args, kw["initial_noise"] = (prompt, normal(1, 8, 12, cfg.out_channels)), normal(*shape)
        elif kind == "t2v":
            args, kw["initial_noise"] = (prompt,), normal(*shape)
        else:
            args, kw["noise"] = (prompt, normal(*shape)), normal(*shape)
        want, got = cpu(*args, **kw), gpu(*args, **kw)
        torch.cuda.synchronize()
        _close_line(label, "latents", got, want)

    cpu = materialize(lambda: tvae.AutoencoderKLCogVideoX(CogVideoXVAEConfig.tiny()), "cpu",
                      torch.float32)
    g = torch.Generator().manual_seed(80)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    gpu = materialize(lambda: tvae.AutoencoderKLCogVideoX(CogVideoXVAEConfig.tiny()), dev,
                      torch.float32)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.default_rng(81)
    video = torch.from_numpy(rng.uniform(-1, 1, (1, 9, 32, 48, 3)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, 3, 8, 12, 4)).astype(np.float32))
    modes = {"encode_mode": lambda vae, x, z: vae.encode_mode(x),
             "decode": lambda vae, x, z: vae.decode(z),
             "chunked_decode(2)": lambda vae, x, z: tvae.chunked_decode(vae, z,
                                                                        chunk_latent_frames=2),
             "tiled_decode(4x6)": lambda vae, x, z: tvae.tiled_decode(
                 vae, z, tile_latent_height=4, tile_latent_width=6),
             "chunked_encode(4)": lambda vae, x, z: tvae.chunked_encode(vae, x, chunk_frames=4),
             "tiled_encode(16x24)": lambda vae, x, z: tvae.tiled_encode(
                 vae, x, tile_height=16, tile_width=24)}
    from lkgd_torch.ops import group_norm as gn

    before = _gn_forwards(gn.launches)
    with torch.inference_mode():
        for name, fn in modes.items():
            _close_line("tiny-cogvideox vae", name, fn(gpu, video.to(dev), z.to(dev)),
                        fn(cpu, video, z))
    assert _gn_forwards(gn.launches) > before, "the tiny GPU VAE must run the GroupNorm kernels"


def _fill_fusion_output(transformer, gen: torch.Generator) -> int:
    """The fusion's zero-init output ``fuse_sf_2`` filled with 0.02 x normal, so that the
    knowledge features really reach the T5 context; returns the tensors filled."""
    fused = transformer.knowledge_fusion.fuse_sf_2
    with torch.no_grad():
        for p in (fused.weight, fused.bias):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
    return 2


def phase_cogvideox_full(dev: torch.device) -> dict:
    """The CogVideoX-5B I2V at full width through ``lkgd_torch/cli/run_inference_cogvideox.py``'s
    ``build``, ``encode`` and ``decode`` (DPM with dynamic CFG, guidance 6, bf16, random
    weights from a seed, the fusion's output 0.02 x normal, synthetic T5 tokens and
    width-1000 domain and flow features): one warm-up DiT step, then a counted run of the
    encode of one 480x720 frame, 3 DPM steps (first order, 2M, the final step) with each
    step's seconds and the whole-clip decode of 13 latent frames, flash launches 42 a step;
    one DiT step under ``torch.profiler``; then the decode chunked (2 latent frames) and
    tiled (60x90 latent tiles, one tile at this size, and 30x45), each timed with its peak."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.ops import flash_attention as fa

    steps = 3
    parser = cli.make_parser()
    args = parser.parse_args(["--image", "-", "--num-inference-steps", str(steps), "--seed", "0",
                              "--device", str(dev)])
    t0 = time.perf_counter()
    pipe, vae = cli.build(args)
    gen = torch.Generator(device=dev).manual_seed(9)
    filled = _fill_fusion_output(pipe.transformer, gen)
    tcfg, pcfg = pipe.transformer.config, pipe.config
    n_dit = sum(p.numel() for p in pipe.transformer.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    prompt = torch.randn((1, tcfg.max_text_seq_length, tcfg.text_embed_dim), generator=gen,
                         device=dev) * 0.2
    domain, flow = (torch.randn((1, 1, 1000), generator=gen, device=dev) for _ in range(2))
    yy = torch.linspace(-1, 1, pcfg.height, device=dev)[:, None, None]
    xx = torch.linspace(-1, 1, pcfg.width, device=dev)[None, :, None]
    image = torch.sin(3 * xx + 2 * yy + torch.tensor([0.0, 2.1, 4.2], device=dev))[None, None]
    torch.cuda.synchronize()
    patches = pipe.latent_frames * pcfg.latent_height * pcfg.latent_width // tcfg.patch_size ** 2
    tokens = tcfg.max_text_seq_length + patches
    print(f"[cogvideox] DiT {n_dit / 1e9:.3f} B + VAE {n_vae / 1e9:.3f} B bf16 random params "
          f"({filled} fusion output tensors 0.02 x normal), {tcfg.num_layers} layers x "
          f"{tcfg.num_attention_heads} heads x {tcfg.attention_head_dim}, joint sequence "
          f"{tokens} tokens, set-up {time.perf_counter() - t0:.1f} s", flush=True)
    assert tokens == COG_FLASH[1]

    with torch.inference_mode():
        # one warm-up step at the loop's shapes (CFG rows, image condition joined)
        rows = 2
        model_in = torch.randn((rows, pipe.latent_frames, pcfg.latent_height, pcfg.latent_width,
                                tcfg.in_channels), generator=gen, device=dev).bfloat16()
        ctx = torch.cat([torch.zeros_like(prompt), prompt]).bfloat16()
        t_step = torch.full((rows,), 999.0, device=dev)
        pipe.transformer(model_in, ctx, t_step, domain, flow)
        torch.cuda.synchronize()

        events = []

        def mark_step(*_):  # each DPM step starts with one DiT call
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        hook = pipe.transformer.register_forward_pre_hook(mark_step)
        _zero_counts()
        fa.recomputed_tiles(dev).zero_()
        torch.cuda.reset_peak_memory_stats(dev)
        step_gen = torch.Generator(device=dev).manual_seed(1)
        t0 = time.perf_counter()
        image_latents = cli.encode(vae, image, args)[:, 0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        encode_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        latents = pipe(prompt, image_latents, generator=step_gen, domain_features=domain,
                       flow_features=flow)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        hook.remove()
        denoise_peak = torch.cuda.max_memory_allocated(dev)
        denoise_launches = _read_counts()
        recomputed = int(fa.recomputed_tiles(dev).item())
        per_step = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:] + [end])]
        torch.cuda.reset_peak_memory_stats(dev)
        frames = cli.decode(vae, latents, args)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        decode_peak = torch.cuda.max_memory_allocated(dev)
    launches = _read_counts()
    print(f"[cogvideox] counted run: encode of one {pcfg.height}x{pcfg.width} frame "
          f"{t1 - t0:.3f} s (peak {encode_peak / 2**30:.2f} GiB) | denoise {t2 - t1:.3f} s, "
          f"{steps} DPM steps of {', '.join(f'{s:.3f}' for s in per_step)} s (first order, 2M, "
          f"final), peak {denoise_peak / 2**30:.2f} GiB | whole-clip decode of "
          f"{pipe.latent_frames} latent frames {t3 - t2:.3f} s, peak {decode_peak / 2**30:.2f} "
          f"GiB | launches { {k: v for k, v in launches.items() if v} } | fallback tiles "
          f"recomputed {recomputed}", flush=True)
    print(f"[cogvideox] latents {tuple(latents.shape)} mean {latents.mean().item():.4f} std "
          f"{latents.std().item():.4f} max|.| {latents.abs().max().item():.3f} | frames "
          f"{tuple(frames.shape)} mean {frames.mean().item():.4f} std {frames.std().item():.4f}",
          flush=True)
    assert len(per_step) == steps
    assert torch.isfinite(latents).all(), "non-finite latents"
    assert torch.isfinite(frames).all(), "non-finite frames"
    assert frames.shape == (1, pcfg.num_frames, pcfg.height, pcfg.width, 3), frames.shape
    for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
        assert denoise_launches[name] == tcfg.num_layers * steps, (name, denoise_launches[name])
    for name in INFERENCE:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by the CogVideoX clip"
    for name in TRAINING + EXPERIMENTS:
        assert launches.get(name, 0) == 0, f"kernel {name} was launched by the CogVideoX clip"

    _profiled("cogvideox", f"one DiT step ({rows} x {tokens} tokens, {tcfg.num_layers} layers)",
              lambda: pipe.transformer(model_in, ctx, t_step, domain, flow))
    del model_in, ctx
    torch.cuda.empty_cache()

    for label, flags in (("chunked (2 latent frames)", ["--vae-chunk-frames", "2"]),
                         ("tiled (60x90 latent tiles)", ["--vae-tiling"]),
                         ("tiled (30x45 latent tiles)", ["--vae-tiling", "--vae-tile-latent",
                                                         "30", "45"])):
        mode = parser.parse_args(["--image", "-", "--device", str(dev)] + flags)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = cli.decode(vae, latents, mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assert out.shape == frames.shape and torch.isfinite(out).all(), label
        dist = ((out - frames).norm() / frames.norm()).item()
        print(f"[cogvideox] decode {label}: {seconds:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | |d|/|whole| {dist:.4f}",
              flush=True)
        del out
    torch.cuda.empty_cache()
    inversion = _inversion(dev, pipe, vae, parser, frames, image_latents, prompt, domain, flow)
    return {"cogvideox": launches, "inversion": inversion}


def phase_train_options(dev: torch.device) -> None:
    """A tiny-width ``--mode trans`` fit on the card with ``--use-8bit-adam``, a validation
    pair rendered every step and ``--report-to tensorboard`` where the package is there:
    the trainables move through 8-bit moments and the GIFs and event file are written."""
    import importlib.util
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.training.optim8bit import AdamW8bit, opt_state_bytes

    unet, vae, clip = _tiny_widths()
    tensorboard = importlib.util.find_spec("tensorboard") is not None
    with tempfile.TemporaryDirectory() as out:
        from PIL import Image

        rng = np.random.default_rng(4)
        paths = []
        for i in range(2):
            paths.append(os.path.join(out, f"v{i}.png"))
            Image.fromarray((rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8)).save(
                paths[-1])
        args = cli.make_parser().parse_args(
            ["--mode", "trans", "--output-dir", out, "--height", "48", "--width", "48",
             "--num-frames", "4", "--rank", "2", "--max-steps", "2", "--checkpoint-every",
             "0", "--use-8bit-adam", "--validation-every", "1", "--num-validation-steps", "2",
             "--validation-image", paths[0], "--validation-image", paths[1], "--device",
             str(dev), "--report-to", "tensorboard" if tensorboard else "jsonl"])
        run = cli.build(args, cli.Widths(unet=unet, vae=vae, clip=clip))
        run.trainer.config.log_every = 1
        optimizer = run.trainer.state.optimizer.adamw
        assert isinstance(optimizer, AdamW8bit)
        before = {n: p.detach().clone() for n, p in run.trainer.state.trainables.items()}
        gen = torch.Generator(device=dev).manual_seed(6)
        clips = [{"pixel_values": torch.rand((1, 5, 48, 48, 3), generator=gen, device=dev)
                  * 2 - 1} for _ in range(2)]
        t0 = time.perf_counter()
        run.trainer.fit(iter(clips))
        torch.cuda.synchronize()
        moved = sum(not torch.equal(p, before[n])
                    for n, p in run.trainer.state.trainables.items())
        gifs = sorted(os.listdir(os.path.join(out, "validation")))
        events = [f for _, _, files in os.walk(os.path.join(out, "tb")) for f in files] \
            if tensorboard else []
        records = [json.loads(line) for line in
                   (Path(out) / "metrics.jsonl").read_text().splitlines()]
        print(f"[train-options] tiny trans fit on the card, 2 steps in "
              f"{time.perf_counter() - t0:.2f} s: 8-bit moments {opt_state_bytes(optimizer)} "
              f"bytes for {sum(p.numel() for p in before.values())} trainable values, "
              f"{moved}/{len(before)} trainables moved | validation GIFs {gifs} | tensorboard "
              f"{'event files ' + str(len(events)) if tensorboard else 'not installed'} | "
              f"records {records}", flush=True)
        assert gifs == ["step1_sample0.gif", "step2_sample0.gif"], gifs
        assert int(optimizer.state.count) == 2 and moved >= len(before) - 8
        assert all(np.isfinite(r["train_loss"]) for r in records if "train_loss" in r)
        assert {"step": 2, "val_num_samples": 1} in records
        assert not tensorboard or events


def phase_experiments(dev: torch.device) -> dict:
    """The two microbenchmark entry points at their default (full) shapes."""
    from lkgd_torch.experiments import flash_variant_microbench, matmul_microbench

    _zero_counts()
    rows = matmul_microbench.main(["--device", str(dev), "--reps", "20"])
    assert all(r["ok"] for r in rows), rows
    rows = flash_variant_microbench.main(["--device", str(dev), "--reps", "3"])
    assert all(np.isfinite(r["ms"]) for r in rows), rows
    torch.cuda.synchronize()
    launches = _read_counts()
    print(f"[experiments] launches { {k: v for k, v in launches.items() if v} }", flush=True)
    for name in EXPERIMENTS:
        assert launches.get(name, 0) > 0, f"kernel {name} was not launched by its entry point"
    return launches


def phase_train_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """The training kernels against their plain versions; returns per-kernel numbers at
    UNet level 0 of the fine-tune (B*T=8, S=4096, 5 heads, D=64)."""
    from lkgd_torch.ops import flash_attention as fa

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    _relayout_host_line()
    results = {}
    # (label, (B, S_q, H, D), scale, S_k)
    cases = [("unet level 0", (8, 4096, 5, 64), 1.0, 4096),
             ("unet level 1", (8, 1024, 10, 64), 1.0, 1024),
             ("ragged", (2, 1100, 5, 64), 1.0, 1100), ("fallback", (1, 1100, 2, 64), 60.0, 1100),
             ("sq_ne_sk", (2, 1100, 5, 64), 1.0, 1030), ("d128", (2, 2048, 4, 128), 1.0, 2048),
             # the LSE forward alone here: the wide backward's VAE shapes follow the loop
             ("vae mid", (2, 9216, 1, 512), 1.0, 9216),
             # the huge-norm guard at D=512, forward and backward (the wide kernels)
             ("fallback wide", (1, 1100, 1, 512), 60.0, 1100)]
    for label, shape, scale, s_k in cases:
        kshape = (shape[0], s_k, *shape[2:])
        q, k, v, do = randn(*shape, scale=scale), randn(*kshape, scale=scale), randn(*kshape), \
            randn(*shape)
        # the plain versions whole, or at D=512 a row at a time
        rows = 1 if shape[-1] > 128 else shape[0]
        want_out, want_lse = in_row_chunks(lambda *a: fa.flash_fwd_lse_maxtrack_plain(
            *(x.float() for x in a)), (q, k, v), rows)
        # at the huge-norm input lse reaches ~2e4 log2 units, where fp32 logits carry ~1e-3
        lse_tol = LSE_TOL * max(1.0, want_lse.abs().max().item() / 1e3)
        out_tol = FLASH_TOL * want_out.abs().max().item()
        row = _relayout_check(fa, label, shape, s_k, randn)
        for kernel in ("flash_bound_lse", "flash_maxtrack_lse"):
            if kernel == "flash_maxtrack_lse":
                os.environ["LKGD_FLASH_MAXTRACK"] = "1"
            try:
                counter = fa.recomputed_tiles(dev)
                counter.zero_()
                out, lse = fa.flash_fwd_lse(q, k, v)
                torch.cuda.synchronize()
                recomputed = int(counter.item())
                # 20 calls: at level 1 the wrapper's host time is near the kernels' own
                ms = gpu_ms(lambda: fa.flash_fwd_lse(q, k, v), 20)
            finally:
                os.environ.pop("LKGD_FLASH_MAXTRACK", None)
            plain = (fa.flash_fwd_lse_maxtrack_plain if kernel == "flash_maxtrack_lse"
                     else fa.flash_fwd_lse_bound_plain)
            plain_ms = gpu_ms(lambda: in_row_chunks(plain, (q, k, v), rows), reps=2)
            out_err = (out.float() - want_out).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            lib_ms, least = sdpa_ms(q, k, v), flash_bound(shape, s_k, rows_fp32=1)
            print(f"[train-kernel] {kernel} {label} (B,S,H,D)={shape} S_k={s_k} x{scale}: out "
                  f"max|d| {out_err:.3e} of max|ref| {out_tol / FLASH_TOL:.3e} (tol {FLASH_TOL} x "
                  f"max|ref|) lse max|d| {lse_err:.3e} (tol {lse_tol:.3g}) | {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (chunks of {rows} rows), library sdpa {lib_ms:.3f} ms, "
                  f"bound {least['bound_ms']:.3f} ms by {least['bound_by']} | tiles recomputed "
                  f"{recomputed}", flush=True)
            assert np.isfinite(out_err) and out_err <= out_tol, (kernel, label, out_err, out_tol)
            assert np.isfinite(lse_err) and lse_err <= lse_tol, (kernel, label, lse_err)
            assert torch.isfinite(out).all() and torch.isfinite(lse).all(), (kernel, label)
            if label.startswith("fallback") and kernel == "flash_bound_lse":
                assert recomputed > 0, "the huge-norm input must trip the fallback"
            row[kernel] = {"max_abs_err": out_err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, **least}
        if label == "vae mid":
            del q, k, v, do, want_out, want_lse, out, lse
            torch.cuda.empty_cache()
            continue

        # the library's backward for kernels 9 and 10 together: autograd through its fused
        # attention on the same inputs
        import torch.nn.functional as F

        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        lib_bwd_ms = gpu_ms(lambda: torch.autograd.grad(lib_out, leaves, do.transpose(1, 2),
                                                        retain_graph=True))
        del lib_out, leaves

        # the backward from the guarded forward's out and lse, as the autograd Function
        out, lse = fa.flash_fwd_lse(q, k, v)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        ref = (q.float(), k.float(), v.float(), do.float(), lse, delta)
        args = (q, k, v, do, lse, delta)
        for kernel, fn, plain, names in (
                ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
                ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv"))):
            dkv = kernel == "flash_bwd_dkv"
            got, again, want = fn(*args), fn(*args), plain(*ref)
            got, again, want = (got, again, want) if len(names) > 1 else \
                ((got,), (again,), (want,))
            errs = {}
            for name, g, g2, w in zip(names, got, again, want):
                assert torch.isfinite(g).all(), (kernel, label, name)
                # no atomics: two launches give the same bits
                assert torch.equal(g, g2), f"{kernel} {label}: {name} differs between launches"
                errs[name] = ((g.float() - w).abs().max().item(), w.abs().max().item())
            ms = gpu_ms(lambda: fn(*args))
            plain_ms = gpu_ms(lambda: plain(*args), reps=2)
            plan = fa.flash_bwd_plan(shape[0], shape[1], s_k, shape[2], shape[3], dkv)
            # dq: 3 S_q x S_k x D products, q, dO and dq on the query side, k and v on the
            # key side; dk/dv: 4 products, q and dO, k, v, dk and dv; lse and delta
            least = flash_bound(shape, s_k, products=4 if dkv else 3, q_tensors=2 if dkv else 3,
                                k_tensors=4 if dkv else 2, rows_fp32=2)
            print(f"[train-kernel] {kernel} {label} (B,S,H,D)={shape} S_k={s_k} x{scale}: "
                  + ", ".join(f"{n} max|d| {e:.3e} of max|ref| {m:.3e} (tol {GRAD_TOL} x "
                              f"max|ref|)" for n, (e, m) in errs.items())
                  + f", two launches bit-identical | {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {least['bound_ms']:.3f} ms by {least['bound_by']} | library sdpa "
                  f"backward (dq, dk and dv together) {lib_bwd_ms:.3f} ms | plan "
                  f"{plan.blocks} blocks, {plan.waves:.2f} waves, {plan.tile_rows} resident "
                  f"rows, {plan.stream_rows}-row tiles x {plan.stages} stages, "
                  f"{plan.smem_bytes} B shared", flush=True)
            for name, (e, m) in errs.items():
                assert e <= GRAD_TOL * m, (kernel, label, name, e, m)
            # library_ms is one backward for both kernels' work: the same number in both
            row[kernel] = {"max_abs_err": max(e for e, _ in errs.values()), "ms": ms,
                           "plain_ms": plain_ms, "library_ms": lib_bwd_ms, **least}
        pair_ms = row["flash_bwd_dq"]["ms"] + row["flash_bwd_dkv"]["ms"]
        print(f"[train-kernel] backward pair {label}: kernels 9 + 10 {pair_ms:.3f} ms = "
              f"{pair_ms / lib_bwd_ms:.2f} x the library backward ({lib_bwd_ms:.3f} ms), bound "
              f"{row['flash_bwd_dq']['bound_ms'] + row['flash_bwd_dkv']['bound_ms']:.3f} ms",
              flush=True)
        # one call of the Function: a grouped split, 7/8 and one merge; then one split, 9,
        # 10 and a grouped merge
        per_call = (("flash_bound_lse", ""), ("flash_bwd_dq", ""), ("flash_bwd_dkv", ""),
                    ("split_heads", ""), ("split_heads", "single_"), ("merge_heads", ""),
                    ("merge_heads", "single_"))
        fwd_bwd = sum(row[name][f"{form}ms"] for name, form in per_call)
        plain_fwd_bwd = sum(row[name]["single_library_ms" if form else "plain_ms"]
                            for name, form in per_call)
        print(f"[train-kernel] {label}: fwd+bwd (kernels 5 x2 + 7/8 + 9 + 10 + 6 x2) "
              f"{fwd_bwd:.3f} ms, plain {plain_fwd_bwd:.3f} ms", flush=True)
        if label == "unet level 0":
            results = row
        del q, k, v, do, want_out, want_lse, out, lse, delta, ref, args
        torch.cuda.empty_cache()
    # the wide kernels (D > 128) at the VAE mid block's widths, beside the level-0 rows
    wide: dict = {}
    for label, shape, s_k, scale in WIDE_BWD_BF16:
        _wide_bwd_case(label, shape, s_k, scale, gen, wide)
    for kernel, found in wide.items():
        results[kernel]["wide"] = found
    return results


# --------------------------------------------------- the wide backward (kernels 9 and 10)
# (label, (B, S_q, H, D), S_k, scale): the VAE mid block's one head of 512 at the fine-tunes'
# 512x512x8 latents and the 576x1024 clip's 14 frames, two heads of 256 (kernels 5/6 around
# them), D past a 128-column unit on a ragged S_q != S_k
WIDE_BWD_BF16 = (("vae mid 512x512x8f", (8, 4096, 1, 512), 4096, 1.0),
                 ("vae mid 576x1024x14f", (14, 9216, 1, 512), 9216, 1.0),
                 ("D=256, two heads", (8, 4096, 2, 256), 4096, 1.0),
                 ("D=136, ragged", (2, 1100, 2, 136), 1030, 1.0))
# the same at fp32, D = 128 where the device sets the pace, and the guard input at D=512: x4,
# where fp32 logits hold 1e-4, and x60 as the bf16 phase's (logits of ~1e5 in the exp2
# domain: see _fp32_logit_tol and _bwd_fp64)
WIDE_BWD_FP32 = (("vae mid 512x512x8f", (8, 4096, 1, 512), 4096, 1.0),
                 ("D=128", (8, 4096, 2, 128), 4096, 1.0),
                 ("D=136, ragged", (2, 1100, 2, 136), 1030, 1.0),
                 ("guard input x4, D=512", (1, 1100, 1, 512), 1100, 4.0),
                 ("guard input x60, D=512", (1, 1100, 1, 512), 1100, 60.0))


def _library_backward(q, k, v, do) -> tuple:
    """The library's backward of kernels 9 and 10 together: autograd through
    ``scaled_dot_product_attention`` on the same inputs, on the first of its fused backends
    (flash, memory-efficient, cuDNN) that takes the shape. (ms, the backend's name), or
    (None, "none") where none does (its math backend is the plain matrix products)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    grad = do.transpose(1, 2)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(*leaves)
                ms = gpu_ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True),
                            reps=3)
        except RuntimeError:
            continue
        return ms, backend.name.lower()
    return None, "none"


def _fp32_logit_tol(q, k) -> float:
    """The fp32 backward's tolerance relative to max|ref|: FP32_GRAD_TOL, or where the logits
    are so large that their own fp32 rounding moves P further, one rounding of the largest
    possible logit in the exp2 domain, 2^-23 max_i |t_i| (t the bound kernel's Cauchy-Schwarz
    bound, -|q_i| max_j|k_j| D^-0.5 log2 e): two fp32 computations of the same scores may differ
    by that much (1.5e-2 at the x60 guard input at D=512, ~7e-5 at x4)."""
    from lkgd_torch.ops import flash_attention as fa

    return max(FP32_GRAD_TOL, 2.0 ** -23 * fa.bound_t(q, k).abs().max().item())


def _bwd_fp64(q, k, v, do, lse, delta) -> tuple:
    """dq, dk, dv (B, S, H, D) of kernels 9 and 10 in float64 from the same inputs and the
    same fp32 lse and delta: the second witness where ``_fp32_logit_tol`` holds the fp32
    kernels above FP32_GRAD_TOL. The kernel is held within that tolerance of it too, and the
    fp32 plain version's distance from it is printed beside the kernel's."""
    from lkgd_torch.ops import flash_attention as fa

    qd, kd, vd, dod = (x.double().transpose(1, 2) for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    p = torch.exp2(qd @ kd.transpose(-1, -2) * (scale * fa.LOG2E) - lse.double()[..., None])
    ds = p * (dod @ vd.transpose(-1, -2) - delta.double()[..., None])
    return tuple(g.transpose(1, 2) for g in (ds @ kd * scale, ds.transpose(-1, -2) @ qd * scale,
                                             p.transpose(-1, -2) @ dod))


class _tf32_matmuls:
    """TF32 in matrix products inside the block: the plain backward of bf16 operands, whose
    S and dP products are exact there (bf16 operands) and whose other three round P and dS to
    TF32 (2^-11), below the kernels' own bf16 rounding of them (2^-9)."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def _wide_bwd_case(label: str, shape, s_k: int, scale: float, gen: torch.Generator, rows: dict,
                   fp32: bool = False) -> None:
    """Kernels 9 and 10 on the wide kernels (bf16 D > 128, fp32 D > 64) at one (B, S_q, H, D)
    input, from the LSE forward's lse and delta as the autograd Function hands them (head-major
    copies from kernel 5 where H > 1): each kernel alone and the pair from one ``flash_bwd``
    call (CUDA events; at fp32 the main kernels and the pre-pass apart, under the profiler),
    against the plain versions on the leading batch row(s) (at fp32 TF32 off, within
    FP32_GRAD_TOL or ``_fp32_logit_tol``, and in the latter case also within it of the fp64
    witness ``_bwd_fp64``; bf16 within GRAD_TOL, its plain products in TF32:
    ``_tf32_matmuls``), the library's backward (``_library_backward``) and the bound (bf16
    products at 989 TFLOP/s, or three TF32 products at 495). Two launches bit-identical; one
    launch of each counter a call. Appends a row a kernel to ``rows``."""
    from lkgd_torch.ops import flash_attention as fa

    dev, dtype = gen.device, torch.float32 if fp32 else torch.bfloat16
    suffix, tag = ("_fp32", "fp32-train-kernel") if fp32 else ("", "train-kernel")
    b, s_q, h, d = shape
    kshape = (b, s_k, h, d)
    q = (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)
    k = (torch.randn(kshape, device=dev, generator=gen) * scale).to(dtype)
    v, do = (torch.randn(x, device=dev, generator=gen).to(dtype) for x in (kshape, shape))
    if h > 1:  # the head-major copies of the Function
        q, k, v = fa.split_heads_many(q, k, v)
        (do,) = fa.split_heads_many(do)
    out, lse = fa.flash_fwd_lse(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    del out
    n = b if s_q * s_k * d <= 2 ** 30 else 1  # the plain versions' rows
    head = tuple(x[:n] for x in args)
    tol = _fp32_logit_tol(q, k) if fp32 else GRAD_TOL
    witness = dict(zip(("dq", "dk", "dv"), _bwd_fp64(*head))) if fp32 and tol > FP32_GRAD_TOL \
        else {}
    lib_ms, backend = _library_backward(q, k, v, do)
    pair = fa.flash_bwd(*args)
    pair_ms = gpu_ms(lambda: fa.flash_bwd(*args))
    device = _device_kernel_ms(lambda: fa.flash_bwd(*args)) if fp32 else {}
    split_ms = sum(t for name, t in device.items() if name.startswith("bwd_split_kernel"))
    products = 2 * b * h * s_q * s_k * d
    least_pair = 0.0
    for kernel, fn, plain, names in (
            ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
            ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv"))):
        dkv = kernel == "flash_bwd_dkv"
        before = fa.launches[kernel + suffix]
        got, again = fn(*args), fn(*args)
        assert fa.launches[kernel + suffix] == before + 2, (kernel, label)
        with contextlib.nullcontext() if fp32 else _tf32_matmuls():
            want = plain(*(x.float() for x in head[:4]), *head[4:])
            plain_ms = gpu_ms(lambda: plain(*(x.float() for x in head[:4]), *head[4:]), reps=1)
        got, again, want = (got, again, want) if dkv else ((got,), (again,), (want,))
        errs = {}
        far = {}  # the kernel's and the fp32 plain version's distances from the fp64 witness
        for name, g, g2, w, g3 in zip(names, got, again, want, pair[1:] if dkv else pair):
            assert g.dtype == dtype and torch.isfinite(g).all(), (kernel, label, name)
            assert torch.equal(g, g2), f"{kernel} {label}: {name} differs between launches"
            assert torch.equal(g, g3), f"{kernel} {label}: {name} differs in the one-call pair"
            errs[name] = ((g[:n].float() - w.float()).abs().max().item(),
                          w.float().abs().max().item())
            if name in witness:
                far[name] = ((g[:n].double() - witness[name]).abs().max().item(),
                             (w.double() - witness[name]).abs().max().item(),
                             witness[name].abs().max().item())
        del got, again, want
        ms = gpu_ms(lambda: fn(*args))
        main_ms = sum(t for name, t in device.items()
                      if name.startswith("flash_bwd_tf32_wide_kernel<")
                      and name.endswith("true>" if dkv else "false>"))
        plan = fa.flash_bwd_plan(b, s_q, s_k, h, d, dkv, fp32=fp32)
        # dq: 3 products, q, dO and dq on the query side, k and v; dk/dv: 4 products, q and
        # dO, k, v, dk and dv; lse and delta
        q_side, k_side, n_products = (2, 4, 4) if dkv else (3, 2, 3)
        if fp32:
            least = bound(3 * n_products * products,
                          4 * (q_side * b * s_q * h * d + k_side * b * s_k * h * d
                               + 2 * b * h * s_q), PEAK_TF32)
        else:
            least = flash_bound(shape, s_k, products=n_products, q_tensors=q_side,
                                k_tensors=k_side, rows_fp32=2)
        least_pair += least["bound_ms"]
        print(f"[{tag}] {kernel}{suffix} ({plan.kernel}) {label} (B,S,H,D)={shape} S_k={s_k} "
              f"x{scale}: " + ", ".join(f"{nm} max|d| {e:.3e} of max|ref| {m:.3e} (tol "
                                        f"{tol:.3g} x max|ref|, rows :{n})"
                                        for nm, (e, m) in errs.items())
              + f", two launches and the one-call pair bit-identical | {ms:.4f} ms (CUDA "
              f"events" + (f"; under the profiler main {main_ms:.4f} ms, the pair's pre-pass "
                           f"{split_ms:.4f} ms" if fp32 else "")
              + f"), plain {plain_ms:.3f} ms ({n} of {b} rows), bound {least['bound_ms']:.4f} "
              f"ms by {least['bound_by']} ({100 * least['bound_ms'] / ms:.1f}% of it) | plan "
              f"{plan.blocks} blocks ({plan.slices} column slices), {plan.waves:.2f} waves, "
              f"{plan.stages} ring units a warpgroup", flush=True)
        if far:
            print(f"[{tag}] {kernel}{suffix} {label} against the fp64 witness (tol {tol:.3g} x "
                  f"max|ref|; the fp32 plain version's distance beside): "
                  + ", ".join(f"{nm} kernel {e:.3e}, fp32 plain {ep:.3e} ({e / m:.2e}, "
                              f"{ep / m:.2e} of max|ref| {m:.3e})"
                              for nm, (e, ep, m) in far.items()), flush=True)
        for name, (e, m) in errs.items():
            assert np.isfinite(e) and e <= tol * m, (kernel, label, name, e, m)
        for name, (e, ep, m) in far.items():
            assert e <= tol * m, (kernel, label, name, e, ep, m)
        rows.setdefault(kernel + suffix, []).append(
            {"label": label, "shape": list(shape), "keys": s_k,
             "max_abs_err": max(e for e, _ in errs.values()), "ms": ms,
             **({"main_ms": main_ms, "split_ms": split_ms} if fp32 else {}),
             "plain_ms": plain_ms, "plain_rows": n, "library_ms": lib_ms,
             "library_backend": backend, **least, "pair_ms": pair_ms})
    lib_text = (f"{pair_ms / lib_ms:.2f} x the library backward ({lib_ms:.4f} ms, {backend})"
                if lib_ms else "no fused library backend takes the shape")
    print(f"[{tag}] backward pair{suffix} {label}: kernels 9 + 10 from one call {pair_ms:.4f} "
          f"ms = {lib_text}, {100 * least_pair / pair_ms:.1f}% of its {least_pair:.4f} ms bound",
          flush=True)
    del q, k, v, do, lse, delta, args, head, pair
    torch.cuda.empty_cache()


def _relayout_check(fa, label: str, shape, s_k: int, randn) -> dict:
    """Kernels 5 and 6 against their plain versions, bit for bit, in the forms the Function
    launches them: the grouped split of q (a slice of a fused qkv projection) with k and v
    (slices of a fused kv projection, S_k keys) and the grouped merge back, then one tensor
    split and merged back. The grouped forms' numbers are the kernels' own, the single ones
    beside them. 50 calls a time: the wrappers cost more host time than the copies take on
    the card, and 5 calls of a shared host scatter."""
    b, s, h, d = shape
    c = h * d
    qkv, kv = randn(b, s, 3 * c), randn(b, s_k, 2 * c)
    xs = (qkv[..., :c].unflatten(-1, (h, d)), kv[..., :c].unflatten(-1, (h, d)),
          kv[..., c:].unflatten(-1, (h, d)))
    x = xs[:1]
    split, split1 = fa.split_heads_many(*xs), fa.split_heads_many(*x)
    merged, merged1 = fa.merge_heads_many(*split), fa.merge_heads_many(*split1)
    want = (*fa.split_heads_many_plain(*xs), *fa.split_heads_many_plain(*x))
    errs = {"split_heads": max((g.float() - w.float()).abs().max().item()
                               for g, w in zip((*split, *split1), want)),
            "merge_heads": max((g.float() - w.float()).abs().max().item()
                               for g, w in zip((*merged, *merged1), (*xs, *x)))}
    row = {}
    for name, fn, plain, args, one in (
            ("split_heads", fa.split_heads_many, fa.split_heads_many_plain, xs, x),
            ("merge_heads", fa.merge_heads_many, fa.merge_heads_many_plain, split, split1)):
        ms, plain_ms = gpu_ms(lambda: fn(*args), 50), gpu_ms(lambda: plain(*args), 50)
        one_ms, one_plain_ms = gpu_ms(lambda: fn(*one), 50), gpu_ms(lambda: plain(*one), 50)
        nbytes = sum(a.numel() for a in args) * 2
        least, one_least = bound(0, 2 * nbytes), bound(0, 2 * one[0].numel() * 2)
        print(f"[train-kernel] {name} {label} 3 x (B,S,H,D)={shape} S_k={s_k} "
              f"({nbytes / 2 ** 20:.1f} MiB): max|d| {errs[name]:.3e} (tol 0: a copy) | one "
              f"launch {ms:.4f} ms, plain and library (three transpose().contiguous()) "
              f"{plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms | one tensor {one_ms:.4f} "
              f"ms, library {one_plain_ms:.4f} ms, bound {one_least['bound_ms']:.4f} ms",
              flush=True)
        assert errs[name] == 0.0, (name, label, errs[name])
        # the plain version is the library call here
        row[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": plain_ms, **least, "single_ms": one_ms,
                     "single_library_ms": one_plain_ms, "single_bound_ms": one_least["bound_ms"]}
    return row


def _relayout_host_line() -> None:
    """Host microseconds a call of the relayout wrappers and their parts, at a shape whose
    device time is far below the host's (``lkgd_torch/experiments/relayout_ab.py``)."""
    from lkgd_torch.experiments.relayout_ab import HOST_SHAPE, host_parts

    parts = host_parts(1000)
    print(f"[train-kernel] relayout host us a call at {HOST_SHAPE} (least of 5 rounds of 1000 "
          f"enqueues; device us of the same calls back to back beside): " + ", ".join(
              f"{k} {v:.2f} ({parts['device_us'][k]:.2f})" for k, v in parts["host_us"].items()),
          flush=True)


# (label, (frames, latent height, width, channels), dtype): the temporal VAE's mid-block
# attention at the fine-tunes' 512x512 clips of 8 frames and the 576x1024 clip's 14 frames
VAE_GRAD = (("512x512x8f", (8, 64, 64, 512), torch.bfloat16),
            ("512x512x8f", (8, 64, 64, 512), torch.float32),
            ("576x1024x14f", (14, 72, 128, 512), torch.bfloat16))
# the parameters whose gradients flow only through kernels 9 and 10: dq reaches to_q, dk
# to_k, dv to_v. to_k's bias has none (a shift of every key by one vector moves each query's
# logits by one constant, which the softmax cancels), and x's gradient is w, the residual's,
# plus an attention share that bf16 rounds away beside it
VAE_GRAD_PARAMS = ("to_q.weight", "to_q.bias", "to_k.weight", "to_v.weight", "to_v.bias")
# (name, the fault on (dq, dk, dv), the gradients it must push past the tolerance): faults
# planted in the backward's results, to show that 6b's comparison fails them
VAE_GRAD_FAULTS = (("dq zeroed", lambda dq, dk, dv: (torch.zeros_like(dq), dk, dv),
                    ("to_q.weight", "to_q.bias")),
                   ("dk, dv x 1.1", lambda dq, dk, dv: (dq, dk * 1.1, dv * 1.1),
                    ("to_k.weight", "to_v.weight", "to_v.bias")))


def _vae_attention_grads(module, x: torch.Tensor, w: torch.Tensor) -> dict:
    """``torch.autograd.grad`` of sum(module(x) * w) with respect to VAE_GRAD_PARAMS."""
    params = dict(module.named_parameters())
    grads = torch.autograd.grad((module(x) * w).float().sum(),
                                [params[name] for name in VAE_GRAD_PARAMS])
    return dict(zip(VAE_GRAD_PARAMS, grads))


def _vae_attention_twin(module, x: torch.Tensor, w: torch.Tensor) -> dict:
    """The same gradients from the same module and inputs with ``plain_attention`` (the
    attention the VAE runs below 1024 tokens) in place of the flash Function: everything but
    the attention and its gradient is the same computation, rounded the same way. bf16 with
    TF32 in its fp32 products (``_tf32_matmuls``: exact on bf16 operands), fp32 without."""
    from lkgd_torch.models import vae_temporal
    from lkgd_torch.ops.attention import plain_attention

    with mock.patch.object(vae_temporal, "dot_product_attention", plain_attention), \
            (contextlib.nullcontext() if x.dtype == torch.float32 else _tf32_matmuls()):
        return _vae_attention_grads(module, x, w)


def _vae_grad_errs(got: dict, want: dict) -> dict:
    """max|got - want| and max|want| by parameter."""
    return {name: ((got[name].float() - w).abs().max().item(), w.abs().max().item())
            for name, w in want.items()}


def phase_vae_attention_grad(dev: torch.device) -> dict:
    """6b, the slice's path through the model code: ``torch.autograd.grad`` of a weighted sum
    of the temporal VAE's full-width mid-block attention (``VAEAttention``: 512 channels, one
    head, its GroupNorm and residual) with respect to the projections that only kernels 9
    and 10 reach (VAE_GRAD_PARAMS), at VAE_GRAD's latents. Every launch count is set to 0
    just before the three gradients and read just after: the LSE forward (kernel 7 and its
    guard 8), 9 and 10 in each dtype's forms must have run, once a call. Each gradient is
    then held against its ``plain_attention`` twin (``_vae_attention_twin``) within GRAD_TOL
    (bf16) or FP32_GRAD_TOL (fp32) of its own max|ref|. At the first shape of each dtype, each
    of VAE_GRAD_FAULTS planted in the backward's results must fail that comparison on the
    gradients it breaks. Returns the path's counts."""
    from lkgd_torch.models import vae_temporal
    from lkgd_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(85)
    torch.manual_seed(85)
    modules = {dt: vae_temporal.VAEAttention(VAE_GRAD[0][1][-1]).to(dev, dt)
               for dt in (torch.bfloat16, torch.float32)}
    runs = []
    _zero_counts()
    for label, shape, dtype in VAE_GRAD:
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        w = torch.randn(shape, device=dev, generator=gen).to(dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _vae_attention_grads(modules[dtype], x, w)
        torch.cuda.synchronize()
        runs.append((label, shape, dtype, x, w, got, time.perf_counter() - t0))
    counts = _read_counts()
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        calls = sum(1 for _, _, dt, *_ in runs if dt == dtype)
        for kernel in ("flash_bound_lse", "flash_maxtrack_lse", "flash_bwd_dq", "flash_bwd_dkv"):
            assert counts[kernel + suffix] == calls, (kernel + suffix, counts)
    faulted = set()
    for label, shape, dtype, x, w, got, seconds in runs:
        tol = FP32_GRAD_TOL if dtype == torch.float32 else GRAD_TOL
        want = _vae_attention_twin(modules[dtype], x, w)
        errs = _vae_grad_errs(got, want)
        print(f"[vae-attention-grad] VAEAttention(512) {label} {tuple(shape)} {dtype}: "
              f"d/d(to_q, to_k, to_v) through the flash Function in {seconds:.3f} s (forward "
              f"and backward, host clock) | against the plain_attention twin (tol {tol} x "
              f"max|ref|): " + ", ".join(f"{n} max|d| {e:.3e} of max|ref| {m:.3e}"
                                         for n, (e, m) in errs.items()), flush=True)
        for name, (e, m) in errs.items():
            assert torch.isfinite(got[name]).all() and e <= tol * m, (label, dtype, name, e, m)
        if dtype in faulted:
            continue
        faulted.add(dtype)
        for fault, breaks, broken in VAE_GRAD_FAULTS:
            real = fa.flash_bwd
            with mock.patch.object(fa, "flash_bwd", lambda *a: breaks(*real(*a))):
                bad = _vae_grad_errs(_vae_attention_grads(modules[dtype], x, w), want)
            print(f"[vae-attention-grad] planted fault, {fault}, {label} {dtype}: "
                  + ", ".join(f"{n} max|d| {e:.3e} ({e / m:.2e} of max|ref|)"
                              for n, (e, m) in bad.items() if n in broken), flush=True)
            for name in broken:
                e, m = bad[name]
                assert e > tol * m, f"6b passed a planted fault: {fault} in {name} ({e}, {m})"
    print(f"[vae-attention-grad] launches of the three gradients: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    del modules, runs
    torch.cuda.empty_cache()
    return counts


COG_TRAIN = (1, 17776, 48, 64)  # one CFG-free row of the 5B DiT's joint sequence
COG_CLIP = (49, 480, 720)  # the fine-tune's clips: frames, height, width


def phase_cogvideox_train_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels 5/6, 7/8, 9/10 and 1a at the CogVideoX-5B fine-tune's (1, 17776, 48, 64): 138
    full 128-row tiles and 112 rows, 6672 blocks; every plain version in blocks of 2 heads,
    with the library call's time and the bound; returns these rows by kernel."""
    tag, label = "cogvideox-train-kernel", "5B fine-tune"
    rows = _train_rows(tag, label, COG_TRAIN, gen, heads_of(2))
    rows["flash_key_norm"] = _key_norm_row(
        tag, label, torch.randn(COG_TRAIN, device=dev, generator=gen).bfloat16())
    torch.cuda.empty_cache()
    return rows


def _tiny_train_unet(device, mode: str):
    """The tiny UNet of ``--mode lkgd`` (the configuration of tests/test_training.py:18-24,
    knowledge fusion and a rank-2 temporal LoRA) or ``--mode trans`` (the training CLI's
    joint branch and yx/xy/y adapters at rank 2), with remat, fp32."""
    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.models.configs import LoraRouter, LoraRule, SVDUNetConfig
    from lkgd_torch.models.layers import materialize
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition

    unet = _tiny_widths()[0]
    if mode == "lkgd":
        config = SVDUNetConfig(
            **unet, knowledge_fusion=True, remat=True,
            lora=LoraRouter(rules=(LoraRule(pattern="*temporal*attn1.*", name="ft", rank=2),)))
    else:
        args = cli.make_parser().parse_args(["--mode", "trans", "--num-frames", "4", "--rank",
                                             "2", "--remat"])
        config = cli.unet_config(args, cli.Widths(unet=unet))
    predicate = cli.trainable if mode == "lkgd" else cli.trainable_trans
    return materialize(lambda: UNetSpatioTemporalCondition(config), device, torch.float32,
                       fp32=predicate), predicate


def _cpu_step_from(start: dict, grads: dict) -> dict:
    """The CPU's AdamW step (lr 1e-3, the global-norm clip) from the trainables ``start``
    with the gradients ``grads`` (None where a trainable has none)."""
    from lkgd_torch.training import train_state as ts

    params = torch.nn.ParameterList([torch.nn.Parameter(start[n].clone()) for n in start])
    optimizer = ts.make_optimizer(1e-3)
    optimizer.init(params)
    for p, name in zip(params, start):
        p.grad = None if grads[name] is None else grads[name].clone()
    optimizer.step()
    return {name: p.detach() for name, p in zip(start, params)}


def phase_train_tiny(dev: torch.device, mode: str, hw: int = 8) -> None:
    """One train step of the tiny UNet of ``mode`` on the GPU against the CPU at fp32 with
    the same weights and injected draws: the loss, every trainable gradient (a trainable
    without one, attn2's query and key in trans mode, must lack it on both) and the
    trainables after the step, against the CPU's own step (lkgd mode) and against the CPU's
    AdamW applied to the GPU's gradients (both modes: Adam's first step divides each
    gradient by its own size plus 1e-8, so an entry near 1e-8 turns the gradients' last-bit
    differences into differences of the step); frozen weights bit-identical. ``hw``: the
    latents' side; at 32 (256x256 frames) level 0 reaches 1024 tokens, where the card's
    step trains through the fp32 flash kernels (7-10 and 5/6, asserted) and the CPU's
    through their plain versions (7d)."""
    from lkgd_torch.models.layers import init_params
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import group_norm as gn
    from lkgd_torch.training import train_state as ts

    label = {"lkgd": "train-tiny", "trans": "train-trans-tiny",
             "joint_vf": "train-joint-vf-tiny"}[mode] + ("" if hw == 8 else f"-{hw * hw}")
    joint_vf, mode = mode == "joint_vf", "trans" if mode == "joint_vf" else mode
    cpu, trainable = _tiny_train_unet("cpu", mode)
    gen = torch.Generator().manual_seed(11)
    init_params(cpu, gen)
    with torch.no_grad():  # LoRA B, conv1n and the text vectors start at zero: make them count
        for name, p in cpu.named_parameters():
            if trainable(name):
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    gpu, _ = _tiny_train_unet(dev, mode)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.default_rng(21)
    b, t = 2, 4
    batch = {"latents": rng.standard_normal((b, t, hw, hw, 4)) * 0.5,
             "cond_latents": rng.standard_normal((b, hw, hw, 4)),
             "image_embeddings": rng.standard_normal((b, 1, 64))}
    if mode == "lkgd":
        batch.update(domain_features=rng.standard_normal((b, 1, 48)),
                     flow_features=rng.standard_normal((b, 1, 48)))
        draws = {"sigmas": np.array([0.7, 3.0]), "dropout_u": np.array([0.61, 0.06])}
    else:  # one [x, y] pair: one sigma; y keeps its embedding and loses its image
        draws = {"sigmas": np.array([1.3, 1.3]), "dropout_u": np.array([0.96, 0.76])}
    if joint_vf:  # [video, flow] rows of one clip through make_joint_vf_batch
        from lkgd_torch.training.flow import make_joint_vf_batch

        joint = make_joint_vf_batch(*(torch.from_numpy(x) for x in (
            rng.standard_normal((1, t, hw, hw, 4)) * 0.5, rng.standard_normal((1, t, hw, hw, 4)),
            rng.standard_normal((1, 1, 64)))))
        batch.update({k: v.numpy() for k, v in joint.items()})
    draws["noise"] = rng.standard_normal((b, t, hw, hw, 4))
    config = ts.SVDTrainConfig(conditioning_dropout_prob=0.3, tie_stream_pairs=mode == "trans")
    results = {}
    for side, unet, device in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        tensors = {k: torch.tensor(v, dtype=torch.float32, device=device)
                   for k, v in {**batch, **draws}.items()}
        state = ts.init_train_state(unet, ts.make_optimizer(1e-3, trainable_predicate=trainable))
        frozen = {n: p.detach().clone() for n, p in unet.named_parameters() if not trainable(n)}
        start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
        gn_before, flash_before = _gn_forwards(gn.launches), dict(fa.launches)
        loss = ts.svd_loss(unet, {k: tensors[k] for k in batch}, config,
                           **{k: tensors[k] for k in draws})
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().cpu().clone()
                 for n, p in state.trainables.items()}
        state.optimizer.step()
        if device != "cpu":
            torch.cuda.synchronize()
        for name, p in unet.named_parameters():
            if not trainable(name):
                assert torch.equal(p, frozen[name]), f"{side}: frozen {name} moved"
        results[side] = (loss.item(), grads,
                         {n: p.detach().cpu() for n, p in state.trainables.items()},
                         _gn_forwards(gn.launches) - gn_before)
        flash = {n: c - flash_before[n] for n, c in fa.launches.items() if c != flash_before[n]}
    (loss_c, grads_c, after_c, _), (loss_g, grads_g, after_g, gn_calls) = \
        results["cpu"], results["gpu"]
    want_g = _cpu_step_from(start, grads_g)
    unused = sorted(n for n, g in grads_c.items() if g is None)
    assert unused == sorted(n for n, g in grads_g.items() if g is None), "unused trainables"
    used = [n for n in grads_c if grads_c[n] is not None]
    grad_err = max(((grads_g[n] - grads_c[n]).abs().max() / grads_c[n].abs().max().clamp_min(
        1e-12)).item() for n in used)
    step_err = max((after_g[n] - after_c[n]).abs().max().item() for n in after_c)
    own_err = max((after_g[n] - want_g[n]).abs().max().item() for n in after_c)
    print(f"[{label}] GPU vs CPU fp32: loss {loss_g:.6f} vs {loss_c:.6f} | {len(used)} "
          f"trainable grads, max |d|/max|ref| {grad_err:.3e} ({len(unused)} trainables "
          f"without a gradient on both) | after one step max|d| {step_err:.3e}, against the "
          f"CPU's step from the GPU's gradients {own_err:.3e} (rtol 1e-4, atol 2e-4) | frozen "
          f"bit-identical | GroupNorm forwards on the kernels {gn_calls} | flash launches {flash}",
          flush=True)
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    assert all(".attn2.to_q." in n or ".attn2.to_k." in n for n in unused), unused
    for name in grads_c:
        if name in used:
            assert torch.isfinite(grads_g[name]).all(), name
            scale = grads_c[name].abs().max().clamp_min(1e-12)
            torch.testing.assert_close(grads_g[name] / scale, grads_c[name] / scale,
                                       rtol=1e-4, atol=2e-4, msg=name)
        torch.testing.assert_close(after_g[name], want_g[name], rtol=1e-4, atol=2e-4,
                                   msg=name)
        if mode == "lkgd":
            torch.testing.assert_close(after_g[name], after_c[name], rtol=1e-4, atol=2e-4,
                                       msg=name)
    assert gn_calls > 0, "the tiny GPU train step must run the GroupNorm kernels"
    if hw * hw >= 1024:  # level 0 trains through the fp32 flash kernels on the card
        assert all(flash.get(n, 0) > 0 for n in TRAINING_FP32 + ("split_heads",)), flash
        assert not any(flash.get(n) for n in TRAINING[:4]), flash  # no bf16 form


def phase_tiny_cogvideox_train(dev: torch.device) -> None:
    """At fp32, the card against the CPU with the same weights (every parameter random) and
    draws: the tiny CogVideoX train step of ``train_cogvideox_lora``'s LoRA and fusion with
    remat, i2v and t2v (the loss, the gradients scaled as the ControlNet step's, the update
    against the CPU's AdamW on the card's gradients, frozen weights bit-identical); the tiny
    T5 encoder on explicit ids with a padding mask; a tensor cache written from the card
    and read back."""
    import tempfile

    from lkgd_torch.cli import train_cogvideox_lora as cli
    from lkgd_torch.data.tensor_cache import TensorCache
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.configs import T5Config
    from lkgd_torch.models.layers import materialize
    from lkgd_torch.models.t5_text import build_t5_encoder
    from lkgd_torch.pipelines.cogvideox_i2v import make_cogvideox_train_step
    from lkgd_torch.training import train_state as ts

    label = "cogvideox-train-tiny"
    for mode in ("i2v", "t2v"):
        args = cli.make_parser().parse_args(["--tiny", "--rank", "2", "--lora-alpha", "4",
                                             "--remat", "--mode", mode])
        config = cli.transformer_config(args)
        cpu = materialize(lambda: CogVideoXTransformer3D(config), "cpu", torch.float32)
        gen = torch.Generator().manual_seed(12)
        with torch.no_grad():
            for p in cpu.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.15)
        gpu = materialize(lambda: CogVideoXTransformer3D(config), dev, torch.float32)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        batch = {"latents": torch.randn((2, 3, 8, 8, 4), generator=gen),
                 "prompt_embeds": torch.randn((2, 8, 64), generator=gen),
                 "domain_features": torch.randn((2, 1, 1000), generator=gen),
                 "flow_features": torch.randn((2, 1, 1000), generator=gen)}
        if mode == "i2v":
            batch["image_latents"] = torch.randn((2, 8, 8, 4), generator=gen)
        draws = {"timesteps": torch.tensor([37, 901]),
                 "noise": torch.randn((2, 3, 8, 8, 4), generator=gen)}
        results = {}
        for side, model, device in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
            frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                      if not cli.trainable(n)}
            optimizer = ts.make_optimizer(1e-3, trainable_predicate=cli.trainable)
            state = ts.init_train_state(model, optimizer)
            start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
            grads = {}
            hooks = [p.register_post_accumulate_grad_hook(
                lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu().clone()))
                for n, p in state.trainables.items()]
            step = make_cogvideox_train_step(model, optimizer, mode=mode)
            state, loss = step(state, {k: v.to(device) for k, v in batch.items()},
                               **{k: v.to(device) for k, v in draws.items()})
            for h in hooks:
                h.remove()
            for name, p in model.named_parameters():
                if name in frozen:
                    assert torch.equal(p, frozen[name]), f"{side}: frozen {name} moved"
            results[side] = (loss.item(), grads,
                             {n: p.detach().cpu() for n, p in state.trainables.items()})
        (loss_c, grads_c, _), (loss_g, grads_g, after_g) = results["cpu"], results["gpu"]
        assert sorted(grads_g) == sorted(grads_c) == sorted(start)
        floor = 1e-2 * max(g.abs().max().item() for g in grads_c.values())
        grad_err = max(((grads_g[n] - g).abs().max() / max(floor, g.abs().max().item())).item()
                       for n, g in grads_c.items())
        want_after = _cpu_step_from(start, grads_g)
        step_err = max((after_g[n] - want_after[n]).abs().max().item() for n in start)
        print(f"[{label}] {mode} with remat, GPU vs CPU fp32: loss {loss_g:.6f} vs {loss_c:.6f} "
              f"| {len(grads_c)} trainable grads, max |d|/scale {grad_err:.3e} | the update "
              f"against the CPU's AdamW on the GPU's gradients max|d| {step_err:.3e} (rtol 1e-4, "
              f"atol 2e-4) | frozen bit-identical", flush=True)
        assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
        for name, want in grads_c.items():
            scale = max(floor, want.abs().max().item())
            torch.testing.assert_close(grads_g[name] / scale, want / scale, rtol=1e-4,
                                       atol=2e-4, msg=name)
            torch.testing.assert_close(after_g[name], want_after[name], rtol=1e-4, atol=2e-4,
                                       msg=name)

    cpu, gpu = (build_t5_encoder(T5Config.tiny(), torch.float32, d) for d in ("cpu", dev))
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    ids = torch.randint(0, 128, (2, 19), generator=gen)
    mask = torch.ones(2, 19, dtype=torch.long)
    mask[1, 7:] = 0
    with torch.no_grad():
        want = cpu(ids, mask)
        got = gpu(ids.to(dev), mask.to(dev)).cpu()
    err = (got - want).abs().max().item()
    print(f"[{label}] tiny T5 {tuple(want.shape)} with a padding mask, GPU vs CPU fp32: max|d| "
          f"{err:.3e} (rtol 1e-4, atol 2e-4)", flush=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)

    with tempfile.TemporaryDirectory() as tmp:
        tensors = {"clip0/latents": torch.randn((3, 4, 4, 4), device=dev),
                   "clip0/prompt_embeds": torch.randn((8, 64), device=dev).bfloat16(),
                   "clip0/ids": torch.arange(9, device=dev)}
        cache = TensorCache(f"{tmp}/cache.lkgd")
        for key, x in tensors.items():
            cache.put(key, x)
        cache.close()
        back = TensorCache(f"{tmp}/cache.lkgd")
        for key, x in tensors.items():
            assert torch.equal(back.get(key), x.cpu()), key
        print(f"[{label}] tensor cache written from the card ({len(back)} tensors: fp32, bf16, "
              f"int64) and read back equal", flush=True)
        back.close()


def _read_safetensors(path: str) -> dict:
    """name -> numpy array of a safetensors file of F32 tensors."""
    with open(path, "rb") as f:
        blob = f.read()
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8:8 + n])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        assert info["dtype"] == "F32", (name, info["dtype"])
        start, end = info["data_offsets"]
        out[name] = np.frombuffer(blob[8 + n + start:8 + n + end], "<f4").reshape(info["shape"])
    return out


def phase_train_full(dev: torch.device, mode: str = "lkgd") -> dict:
    """The fine-tune of ``--mode`` at full width, 512x512x8f, one clip a step (in trans mode
    one [clip, flipped clip] pair, 2 UNet rows, where the flash forwards launched inside the
    joint branch's ``attn1n`` calls are counted by module hooks)."""
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.ops import flash_attention as fa

    label = "train" if mode == "lkgd" else "train-trans"
    with tempfile.TemporaryDirectory() as out_dir:
        args = cli.make_parser().parse_args([
            "--mode", mode, "--output-dir", out_dir, "--height", "512", "--width", "512",
            "--num-frames", "8", "--per-device-batch-size", "1", "--rank", "4",
            "--learning-rate", "2e-4", "--remat", "--dtype", "bf16", "--device", str(dev),
            "--checkpoint-every", "0", "--max-steps", "1", "--seed", "0"])
        t0 = time.perf_counter()
        run = cli.build(args)
        trainer = run.trainer
        trainer.config.log_every = 1  # the warm-up step's record checks the JSONL log
        gen = torch.Generator(device=dev).manual_seed(5)
        clips = [{"pixel_values": torch.rand((1, 9, 512, 512, 3), generator=gen, device=dev)
                  * 2 - 1} for _ in range(7)]
        trainables = trainer.state.trainables
        n_train = sum(p.numel() for p in trainables.values())
        n_all = sum(p.numel() for p in run.unet.parameters())
        torch.cuda.synchronize()
        print(f"[{label}] {mode} fine-tune 512x512x8f, batch 1: UNet {n_all / 1e9:.3f} B params, "
              f"{len(trainables)} trainable tensors ({n_train / 1e6:.3f} M, fp32), set-up "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        trainer.fit(iter(clips[:1]))  # warm-up step
        torch.cuda.synchronize()
        print(f"[{label}] warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

        # In the timed windows the step keeps its loss on the device and records a CUDA
        # event after itself; with no log due, nothing in a window waits on the host, and
        # the end-of-fit checkpoint comes after the window's last event.
        losses, marks = [], []
        step = trainer.train_step

        def recorded_step(state, batch, generator):
            state, loss = step(state, batch, generator)
            losses.append(loss)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return state, loss

        trainer.train_step = recorded_step
        trainer.config.log_every = 10 ** 9

        def window(first: int, last: int) -> tuple[float, float]:
            """Steps on clips[first:last] through the trainer: seconds a step between the
            window's opening event and the last step's, and the process's CPU seconds a
            step (every thread, autograd's device thread included) over the fit."""
            marks.clear()
            opening = torch.cuda.Event(enable_timing=True)
            trainer.config.max_steps = trainer.state.step + last - first
            cpu0 = time.process_time()
            opening.record()
            trainer.fit(iter(clips[first:last]))
            cpu_s = (time.process_time() - cpu0) / (last - first)
            torch.cuda.synchronize()
            return opening.elapsed_time(marks[-1]) / 1e3 / (last - first), cpu_s

        before = {n: p.detach().clone() for n, p in trainables.items()}
        frozen = {n: p.detach().clone() for n, p in run.unet.named_parameters()
                  if n in ("conv_in.weight", "down_blocks.0.attentions.0.proj_in.weight",
                           "down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn1."
                           "to_q.weight", "mid_block.resnets.0.spatial_res_block.conv1.weight",
                           "up_blocks.3.attentions.2.transformer_blocks.0.ff.net.2.weight",
                           "conv_norm_out.weight")}
        assert len(frozen) == 6, sorted(frozen)
        finite = []
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p: finite.append(torch.isfinite(p.grad).all())) for p in trainables.values()]
        # the flash forwards (one key-norm launch each) inside attn1n calls, remat included
        joint_flash, opened = [0], {}
        for name, module in run.unet.named_modules():
            if name.endswith(".attn1n"):
                hooks.append(module.register_forward_pre_hook(
                    lambda m, a: opened.__setitem__(m, fa.launches["flash_key_norm"])))
                hooks.append(module.register_forward_hook(
                    lambda m, a, o: joint_flash.__setitem__(
                        0, joint_flash[0] + fa.launches["flash_key_norm"] - opened[m])))
        _zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        step_s, cpu_s = window(1, 4)
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        for h in hooks:
            h.remove()
        moved = [n for n, p in trainables.items() if not torch.equal(p, before[n])]

        t0 = time.perf_counter()  # the preprocessing alone, on the same clips
        for clip in clips[1:4]:
            run.preprocess(clip["pixel_values"], trainer.generator)
        torch.cuda.synchronize()
        pre_s = (time.perf_counter() - t0) / 3

        # the same window under the profiler: the device's busy share of it
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_step_s, prof_cpu_s = window(4, FIT_STEPS)
        device_ms, ckpt_ms, n_device, runtime = 0.0, 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                ms = e.self_device_time_total / 1e3
                # the end-of-fit checkpoint's reads fall after the window's last event
                if "DtoH" in e.key:
                    ckpt_ms += ms
                else:
                    device_ms += ms
                    n_device += e.count
            elif e.key.startswith("cuda"):  # runtime calls on the host
                runtime[e.key] = e.count
        relayout = _kernels_by_name(prof, ("relayout_",))
        flash = _kernels_by_name(prof, ("flash_", "key_sq_max"))
        busy = device_ms / (prof_step_s * 1e3 * PROFILED_STEPS)
        syncs = {k: n for k, n in runtime.items() if "Synchronize" in k or "Memcpy" in k}

        relayouts_per_step = (launches["split_heads"] + launches["merge_heads"]) / 3
        step_losses = [x.item() for x in losses[:3]]
        records = [json.loads(line) for line in
                   (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
        print(f"[{label}] {step_s:.3f} s/step = preprocessing {pre_s:.3f} s + train step "
              f"{step_s - pre_s:.3f} s (3 steps after the warm-up, between CUDA events; "
              f"preprocessing timed alone on the same clips), host CPU {cpu_s:.3f} s/step | "
              f"peak memory {peak / 2**30:.2f} GiB | losses {step_losses} | launches "
              f"{launches} | trainables moved {len(moved)}/{len(trainables)} | grads finite "
              f"{len(finite)} checks | {host_line()}", flush=True)
        print(f"[{label}] profiled window: {prof_step_s:.3f} s/step ({PROFILED_STEPS} step(s) "
              f"under torch.profiler), host CPU {prof_cpu_s:.3f} s/step, device busy "
              f"{device_ms / PROFILED_STEPS:.1f} ms/step = {100 * busy:.1f}% of the window "
              f"(kernels, copies and fills: {n_device / PROFILED_STEPS:.0f} a step; "
              f"device-to-host copies after the window {ckpt_ms:.1f} ms left out) | host syncs "
              f"and copies over the window and the checkpoint {syncs} | relayout kernels "
              f"device ms, launches over the window "
              f"{relayout}; relayout launches a step {relayouts_per_step:.0f} (split "
              f"{launches['split_heads'] / 3:.0f}, merge {launches['merge_heads'] / 3:.0f})",
              flush=True)
        print(f"[{label}] profiled window, flash kernels by name (device ms, launches over "
              f"{PROFILED_STEPS} step(s)): {flash}", flush=True)
        # <DP, BOUND, LSE>: the training forward is the wgmma kernel's LSE form, both ways
        for form in ("<64,true,true>", "<64,false,true>"):
            assert f"flash_fwd_wgmma_kernel{form}" in flash, (form, sorted(flash))
        # the backward is the wgmma/TMA pair at D=64
        backward = {name: flash.get(name) for name in ("flash_bwd_dq_kernel<64>",
                                                       "flash_bwd_dkv_kernel<64>")}
        assert all(backward.values()), (backward, sorted(flash))
        print(f"[{label}] profiled window, backward kernels a step: " + ", ".join(
            f"{name} {ms / PROFILED_STEPS:.3f} ms, {n / PROFILED_STEPS:.0f} launches"
            for name, (ms, n) in backward.items()),
            flush=True)
        assert trainer.state.step == FIT_STEPS and all(np.isfinite(step_losses)), step_losses
        assert [r["step"] for r in records] == [1] and np.isfinite(records[0]["train_loss"])
        # trans mode: attn2's query and key adapters get no gradient (one key), and their
        # B factors, zero at init, stay where they were
        still = sorted(set(trainables) - set(moved))
        no_grad = [n for n in trainables if ".attn2.to_q." in n or ".attn2.to_k." in n]
        assert all(".attn2.to_q.lora" in n and n.endswith("_B")
                   or ".attn2.to_k.lora" in n and n.endswith("_B") for n in still), still
        assert len(finite) == 3 * (len(trainables) - len(no_grad)) \
            and torch.stack(finite).all().item(), "non-finite gradient"
        assert mode == "trans" or not still, "a trainable did not move"
        if mode == "trans":
            moved_joint = [n for n in moved if ".conv1n." in n or ".attn1n.to_q.weight" in n]
            assert moved_joint, "the joint branch did not move"
        for name, p in run.unet.named_parameters():
            if name in frozen:
                assert torch.equal(p, frozen[name]), f"frozen {name} moved"
        for name in INFERENCE + TRAINING:
            assert launches.get(name, 0) > 0, f"kernel {name} was not launched by training"
        assert launches["flash_key_norm"] == launches["flash_bound"] \
            + launches["flash_bound_lse"], "one key-norm launch for each bound launch"
        # two relayout launches a Function call each way: a split and a merge for each
        # training forward (remat included) and each backward
        calls = launches["flash_bound_lse"] + launches["flash_bwd_dq"]
        assert launches["split_heads"] == launches["merge_heads"] == calls, launches
        if mode == "lkgd":
            assert relayouts_per_step == 54, relayouts_per_step
            assert joint_flash[0] == 0
        else:
            print(f"[{label}] the joint branch's attn1n launched {joint_flash[0] / 3:.0f} of "
                  f"the {launches['flash_key_norm'] / 3:.0f} flash forwards a step (remat "
                  f"included)", flush=True)
            assert joint_flash[0] > 0, "the joint branch ran no flash kernel"
        assert busy > 0.0, busy

        path = str(Path(out_dir) / "model.safetensors")
        n = cli.export_trainable_safetensors(run.unet, run.trainable, path)
        exported = _read_safetensors(path)
        assert n == len(exported) and sorted(exported) == sorted(trainables)
        for name, value in exported.items():
            assert np.array_equal(value, trainables[name].detach().float().cpu().numpy()), name
        print(f"[{label}] export: {n} tensors, {os.path.getsize(path) / 2**20:.2f} MiB, read back "
              f"equal", flush=True)
    return launches


FP32_STEP_TOL = 1e-3  # fp32 train step, kernels against plain attention: of max(1% floor, max|g|)


def _fp32_step_grads(run, batch: dict, draws: dict, plain: bool) -> dict:
    """The trainables' gradients of one loss of the fp32 UNet on ``batch`` with the draws
    given, through the flash kernels or (``plain``) plain attention; remat on, so that plain
    attention's (B, H, S, S) probabilities live one block at a time."""
    import dataclasses

    from lkgd_torch.ops import attention
    from lkgd_torch.training import train_state as ts

    unet = run.unet
    config, real = unet.config, attention.use_flash
    unet.config = dataclasses.replace(config, remat=True)
    if plain:
        attention.use_flash = lambda *args, **kwargs: False
    try:
        for p in run.trainer.state.trainables.values():
            p.grad = None
        loss = ts.svd_loss(unet, batch, run.config, **draws)
        loss.backward()
    finally:
        unet.config, attention.use_flash = config, real
    return {n: p.grad.detach().clone() for n, p in run.trainer.state.trainables.items()
            if p.grad is not None}


def phase_train_fp32_full(dev: torch.device) -> dict:
    """8o: the LKGD fine-tune at the JAX fine-tune CLI's own precision and defaults:
    ``train_svd_lora.build`` with ``--dtype fp32`` (every model fp32, as
    ``lkgd_tpu/cli/train_svd_lora.py:90-93`` builds them), 512x512, 14 frames, batch 1, rank 4,
    no remat. The UNet's spatial attention at levels 0 (14, 4096, 5, 64) and 1 (14, 1024, 10,
    64) trains through kernels 7-10 in fp32 and 5/6 on fp32 rows. A warm-up step, three
    between CUDA events under the CLI's own TF32 setting (PyTorch's defaults: cuBLAS fp32,
    cuDNN convolutions TF32): sec/step split into preprocessing and train step, host CPU,
    peak, launches a step (the four fp32 forms > 0, the bf16 forms and every plain flash
    version 0), one step under ``torch.profiler`` (busy share); then, TF32 off, one step's
    gradients through the kernels against plain attention on the same batch and draws,
    within FP32_STEP_TOL of max(1% of the largest gradient, each tensor's largest)."""
    import contextlib
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.ops import flash_attention as fa

    label = "train-fp32"
    with tempfile.TemporaryDirectory() as out_dir:
        args = cli.make_parser().parse_args([
            "--output-dir", out_dir, "--dtype", "fp32", "--device", str(dev),
            "--checkpoint-every", "0", "--max-steps", "1", "--seed", "0"])
        assert (args.mode, args.height, args.width, args.num_frames, args.per_device_batch_size,
                args.rank, args.remat) == ("lkgd", 512, 512, 14, 1, 4, False), args
        t0 = time.perf_counter()
        run = cli.build(args)
        trainer, unet = run.trainer, run.unet
        assert all(p.dtype == torch.float32 for p in unet.parameters())
        gen = torch.Generator(device=dev).manual_seed(6)
        clips = [{"pixel_values": torch.rand((1, 15, 512, 512, 3), generator=gen, device=dev)
                  * 2 - 1} for _ in range(6)]
        torch.cuda.synchronize()
        print(f"[{label}] lkgd fine-tune at fp32, 512x512x14, batch 1, rank 4, no remat (the "
              f"JAX CLI's defaults): UNet {sum(p.numel() for p in unet.parameters()) / 1e9:.3f} "
              f"B fp32 params, {len(trainer.state.trainables)} trainable tensors, set-up "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        trainer.fit(iter(clips[:1]))  # warm-up step
        torch.cuda.synchronize()
        print(f"[{label}] warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

        losses, marks, step = [], [], trainer.train_step

        def recorded_step(state, batch, generator):
            state, loss = step(state, batch, generator)
            losses.append(loss)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return state, loss

        trainer.train_step = recorded_step
        trainer.config.log_every = 10 ** 9

        def window(first: int, last: int) -> tuple[float, float]:
            marks.clear()
            opening = torch.cuda.Event(enable_timing=True)
            trainer.config.max_steps = trainer.state.step + last - first
            cpu0 = time.process_time()
            opening.record()
            trainer.fit(iter(clips[first:last]))
            cpu_s = (time.process_time() - cpu0) / (last - first)
            torch.cuda.synchronize()
            return opening.elapsed_time(marks[-1]) / 1e3 / (last - first), cpu_s

        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # the CLI sets nothing: PyTorch's default
        try:
            with contextlib.ExitStack() as spying:  # the plain flash versions' calls, counted
                spies = {name: spying.enter_context(mock.patch.object(
                    fa, name, wraps=getattr(fa, name))) for name in PLAIN_FLASH}
                _zero_counts()
                torch.cuda.reset_peak_memory_stats(dev)
                step_s, cpu_s = window(1, 4)
                launches = _read_counts()
                peak = torch.cuda.max_memory_allocated(dev)
                t0 = time.perf_counter()
                for clip in clips[1:4]:
                    run.preprocess(clip["pixel_values"], trainer.generator)
                torch.cuda.synchronize()
                pre_s = (time.perf_counter() - t0) / 3
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    prof_s, _ = window(4, 5)
            device_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA and "DtoH" not in e.key)
            _, kinds, n_ops = _device_time_by_kind(prof)
            plain_calls = {name: spy.call_count for name, spy in spies.items()}
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
        a_step = {n: c / 3 for n, c in launches.items() if c}
        step_losses = [x.item() for x in losses[:3]]
        print(f"[{label}] {step_s:.3f} s/step = preprocessing {pre_s:.3f} s + train step "
              f"{step_s - pre_s:.3f} s (3 steps after the warm-up, between CUDA events; cuDNN "
              f"TF32 on, matmuls fp32, as the CLI runs), host CPU {cpu_s:.3f} s/step | peak "
              f"{peak / 2**30:.2f} GiB | profiled step {prof_s:.3f} s, device busy "
              f"{device_ms:.1f} ms = {100 * device_ms / (prof_s * 1e3):.1f}% | losses "
              f"{step_losses} | launches a step {a_step} | plain flash calls {plain_calls} | "
              f"{host_line()}", flush=True)
        print(f"[{label}] profiled step by kind ({n_ops} device operations): " + ", ".join(
            f"{k} {ms:.1f} ms ({100 * ms / device_ms:.1f}%)" for k, ms in kinds.items()),
            flush=True)
        assert all(np.isfinite(step_losses)), step_losses
        assert all(launches.get(n, 0) > 0 for n in TRAINING_FP32), launches
        assert not any(launches.get(n) for n in TRAINING[:4]), launches  # no bf16 form
        assert launches["flash_bwd_dq_fp32"] == launches["flash_bwd_dkv_fp32"] \
            == launches["flash_bound_lse_fp32"] == launches["flash_maxtrack_lse_fp32"], launches
        assert launches["split_heads"] == launches["merge_heads"] \
            == 2 * launches["flash_bound_lse_fp32"], launches
        assert not any(plain_calls.values()), plain_calls

        # one step's gradients through the kernels and through plain attention, TF32 off
        batch = run.preprocess(clips[5]["pixel_values"], torch.Generator(device=dev).manual_seed(8))
        g = torch.Generator(device=dev).manual_seed(9)
        lat = batch["latents"]
        draws = {"sigmas": torch.tensor([1.7], device=dev),
                 "noise": torch.randn(lat.shape, generator=g, device=dev),
                 "dropout_u": torch.tensor([0.9], device=dev)}
        t0 = time.perf_counter()
        kern = _fp32_step_grads(run, batch, draws, plain=False)
        plain = _fp32_step_grads(run, batch, draws, plain=True)
        floor = 1e-2 * max(x.abs().max().item() for x in plain.values())
        errs = {n: (kern[n] - w).abs().max().item() / max(floor, w.abs().max().item())
                for n, w in plain.items()}
        worst = max(errs, key=errs.get)
        print(f"[{label}] one step's gradients, kernels against plain attention (TF32 off, remat "
              f"for plain attention's memory): {len(plain)} tensors, worst max|d| "
              f"{errs[worst]:.3e} of max(1% floor {floor:.3e}, its largest) ({worst}; tol "
              f"{FP32_STEP_TOL}) | {time.perf_counter() - t0:.1f} s", flush=True)
        assert sorted(kern) == sorted(plain) and errs[worst] <= FP32_STEP_TOL, (worst, errs[worst])
        del run, trainer, unet, clips, batch, kern, plain
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- ControlNet and flow training
def _tiny_unimatch(device, task: str):
    """The tiny UniMatch of ``task`` (one scale, factor 8 for depth), fp32."""
    import dataclasses

    from lkgd_torch.models.unimatch import UniMatchConfig, build_unimatch

    config = UniMatchConfig.tiny()
    if task == "depth":
        config = dataclasses.replace(config, num_scales=1, upsample_factor=8,
                                     attn_splits_list=(2,), corr_radius_list=(-1,),
                                     prop_radius_list=(-1,))
    return build_unimatch(config, task, device=device)


def phase_train_tiny_variants(dev: torch.device) -> None:
    """The tiny UniMatch (flow, stereo, depth), the flow batch ("of", "of_fix") and the
    ControlNet train step at fp32 on the GPU against the CPU with the same weights and
    draws, every parameter random (the ControlNet's zero-init heads included)."""
    from lkgd_torch.models.configs import SVDUNetConfig, TemporalVAEConfig
    from lkgd_torch.models.controlnet_svd import ControlNetSDV, ControlNetSDVConfig
    from lkgd_torch.models.layers import materialize
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from lkgd_torch.training import flow as tflow
    from lkgd_torch.training import train_state as ts
    from lkgd_torch.training import variants
    from lkgd_torch.utils.optical_flow import make_flow_fn

    tol = dict(rtol=1e-4, atol=2e-4)
    rng = np.random.default_rng(33)

    def twins(build, seed: int, fan_in: bool = False):
        """The module on the CPU with every parameter random (0.1 x normal; with ``fan_in``
        weights of std fan_in^-1/2, biases 0.1 x normal and norm scales 1 + 0.1 x normal,
        as the UniMatch tests draw them), and its copy on the card."""
        cpu = build("cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in cpu.named_parameters():
                x = torch.randn(p.shape, generator=gen)
                if fan_in and p.dim() > 1:
                    x = x * p[0].numel() ** -0.5
                elif fan_in and ("norm" in name and name.endswith("weight")):
                    x = 1.0 + 0.1 * x
                else:
                    x = 0.1 * x
                p.copy_(x)
        gpu = build(dev)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        return cpu, gpu

    # UniMatch on its three tasks: pixels at atol 1e-3 (flow, disparity), depth at rtol 1e-4
    base = rng.uniform(0, 255, (2, 40, 56, 3)).astype(np.float32)  # the second view moved
    img0, img1 = torch.from_numpy(base[:, :32, :48].copy()), torch.from_numpy(
        base[:, 4:36, 2:50].copy())
    K = torch.tensor([[[40.0, 0, 24.0], [0, 40.0, 16.0], [0, 0, 1.0]]]).repeat(2, 1, 1)
    pose = torch.eye(4).repeat(2, 1, 1)
    pose[:, 0, 3] = 0.2
    errs = {}
    for task in ("flow", "stereo", "depth"):
        cpu, gpu = twins(lambda d, task=task: _tiny_unimatch(d, task), 34, fan_in=True)
        kw = dict(intrinsics=K, pose=pose, num_depth_candidates=16) if task == "depth" else {}
        with torch.no_grad():
            want = cpu(img0, img1, **kw)
            got = gpu(img0.to(dev), img1.to(dev), **{k: v.to(dev) if torch.is_tensor(v) else v
                                                     for k, v in kw.items()}).cpu()
        errs[task] = ((got - want).abs().max().item(), want.abs().max().item())
        assert torch.isfinite(got).all() and got.shape == want.shape, task
        torch.testing.assert_close(got, want, **(tol if task == "depth"
                                                 else dict(rtol=1e-4, atol=1e-3)),
                                   msg=lambda m, task=task: f"{task}: {m}")
    print("[train-variants-tiny] UniMatch GPU vs CPU fp32, max|d| (max|ref|): " + ", ".join(
        f"{k} {d:.3e} ({m:.2f})" for k, (d, m) in errs.items()) + " (flow and disparity rtol "
        "1e-4, atol 1e-3 px; depth rtol 1e-4, atol 2e-4)", flush=True)

    # the flow batch of both modes: the tiny UniMatch, a VAE of factor 4, 32x32, 3 frames
    vae_config = TemporalVAEConfig(block_out_channels=(32, 64, 64), layers_per_block=1)
    vae_cpu, vae_gpu = twins(lambda d: materialize(lambda: AutoencoderKLTemporalDecoder(
        vae_config), d, torch.float32).eval(), 35)
    um_cpu, um_gpu = twins(lambda d: _tiny_unimatch(d, "flow"), 36, fan_in=True)
    frames = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((2, 1, 64)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    for mode in ("of", "of_fix"):
        want = tflow.make_flow_batch_fn(make_flow_fn(um_cpu, (32, 32)), vae_cpu, mode)(
            frames, emb, noise=noise)
        got = tflow.make_flow_batch_fn(make_flow_fn(um_gpu, (32, 32)), vae_gpu, mode)(
            frames.to(dev), emb.to(dev), noise=noise.to(dev))
        line = []
        for key, value in want.items():
            line.append(f"{key} {tuple(value.shape)} {(got[key].cpu() - value).abs().max():.3e}")
            torch.testing.assert_close(got[key].cpu(), value, **tol, msg=f"{mode} {key}")
        print(f"[train-variants-tiny] flow batch '{mode}' GPU vs CPU fp32, max|d|: "
              + ", ".join(line) + " (rtol 1e-4, atol 2e-4)", flush=True)

    # the ControlNet train step: ControlNet and UNet at the tiny widths, 2 clips x 4 frames
    unet_widths = _tiny_widths()[0]
    unet_cpu, unet_gpu = twins(lambda d: materialize(lambda: UNetSpatioTemporalCondition(
        SVDUNetConfig(**unet_widths)), d, torch.float32), 37)
    cn_config = ControlNetSDVConfig(unet=SVDUNetConfig(**unet_widths),
                                    conditioning_embedding_out_channels=(16, 32, 96))
    cn_cpu, cn_gpu = twins(lambda d: materialize(lambda: ControlNetSDV(cn_config), d,
                                                 torch.float32), 38)
    b, t, hw = 2, 4, 8
    batch = {"latents": rng.standard_normal((b, t, hw, hw, 4)) * 0.5,
             "cond_latents": rng.standard_normal((b, hw, hw, 4)),
             "image_embeddings": rng.standard_normal((b, 1, 64)),
             "control": rng.uniform(size=(b, t, 4 * hw, 4 * hw, 3))}
    draws = {"sigmas": np.array([0.7, 3.0]), "noise": rng.standard_normal((b, t, hw, hw, 4))}
    results = {}
    for side, controlnet, unet, device in (("cpu", cn_cpu, unet_cpu, "cpu"),
                                          ("gpu", cn_gpu, unet_gpu, dev)):
        tensors = {k: torch.tensor(v, dtype=torch.float32, device=device)
                   for k, v in {**batch, **draws}.items()}
        frozen = {n: p.detach().clone() for n, p in unet.named_parameters()}
        step = variants.make_controlnet_train_step(unet)
        state = ts.init_train_state(controlnet, ts.make_optimizer(1e-3), ema=True)
        start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
        grads = {}  # the gradients the step takes
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu().clone()))
            for n, p in state.trainables.items()]
        state, loss = step(state, {k: tensors[k] for k in batch},
                           **{k: tensors[k] for k in draws})
        for h in hooks:
            h.remove()
        if device != "cpu":
            torch.cuda.synchronize()
        assert all(torch.equal(p, frozen[n]) for n, p in unet.named_parameters()), side
        results[side] = (loss.item(), grads,
                         {n: p.detach().cpu() for n, p in state.trainables.items()},
                         {n: e.cpu() for n, e in state.ema_params.items()})
    (loss_c, grads_c, after_c, ema_c), (loss_g, grads_g, after_g, ema_g) = \
        results["cpu"], results["gpu"]
    assert sorted(grads_c) == sorted(grads_g), "the same parameters get a gradient"
    # a gradient scaled by its largest entry, or by 1% of the largest of all where that is
    # larger: the biases before one-channel GroupNorm groups have rounding-level gradients
    floor = 1e-2 * max(g.abs().max().item() for g in grads_c.values())
    grad_err = 0.0
    for name, g in grads_c.items():
        scale = max(floor, g.abs().max().item())
        grad_err = max(grad_err, (grads_g[name] - g).abs().max().item() / scale)
        torch.testing.assert_close(grads_g[name] / scale, g / scale, **tol, msg=name)
    want_g = _cpu_step_from(start, {n: grads_g.get(n) for n in start})
    step_err = max((after_g[n] - want_g[n]).abs().max().item() for n in start)
    ema_err = max((ema_g[n] - ema_c[n]).abs().max().item() for n in start)
    for name in start:
        torch.testing.assert_close(after_g[name], want_g[name], **tol, msg=name)
        torch.testing.assert_close(ema_g[name], ema_c[name], **tol, msg=name)
        torch.testing.assert_close(ema_g[name], start[name] * 0.9999 + after_g[name] * 1e-4,
                                   **tol, msg=name)
    moved = sum(not torch.equal(after_g[n], start[n]) for n in start)
    print(f"[train-variants-tiny] ControlNet step GPU vs CPU fp32: loss {loss_g:.6f} vs "
          f"{loss_c:.6f} | {len(grads_c)} of {len(start)} parameters with a gradient, max "
          f"|d|/scale {grad_err:.3e} | after one step against the CPU's AdamW on the GPU's "
          f"gradients {step_err:.3e}, {moved} moved | EMA against the CPU's {ema_err:.3e} "
          f"(rtol 1e-4, atol 2e-4) | UNet bit-identical", flush=True)
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    assert moved == len(start), "a ControlNet parameter did not move"


def _fit_windows(label: str, dev, trainer, clips: list, parts: dict) -> dict:
    """A warm-up step, three timed steps and PROFILED_STEPS under ``torch.profiler``, all through
    ``trainer.fit``. ``parts``: name -> list of (start, end) CUDA event pairs that the step
    appends to; each part's ms a step over the timed window. Returns sec/step, host CPU
    s/step, parts, device busy ms and operations a step, peak bytes, launches and losses."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    losses, marks = [], []
    step = trainer.train_step

    def recorded_step(state, batch, generator):
        state, loss = step(state, batch, generator)
        losses.append(loss)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return state, loss

    trainer.train_step = recorded_step
    trainer.config.log_every = 10 ** 9

    def window(first: int, last: int) -> tuple[float, float]:
        marks.clear()
        for pairs in parts.values():
            pairs.clear()
        opening = torch.cuda.Event(enable_timing=True)
        trainer.config.max_steps = trainer.state.step + last - first
        cpu0 = time.process_time()
        opening.record()
        trainer.fit(iter(clips[first:last]))
        cpu_s = (time.process_time() - cpu0) / (last - first)
        torch.cuda.synchronize()
        return opening.elapsed_time(marks[-1]) / 1e3 / (last - first), cpu_s

    t0 = time.perf_counter()
    trainer.config.max_steps = trainer.state.step + 1
    trainer.fit(iter(clips[:1]))
    torch.cuda.synchronize()
    print(f"[{label}] warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    _zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    step_s, cpu_s = window(1, 4)
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    part_ms = {name: sum(a.elapsed_time(b) for a, b in pairs) / 3
               for name, pairs in parts.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_step_s, prof_cpu_s = window(4, FIT_STEPS)
    device_ms, n_device = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "DtoH" not in e.key:
            device_ms += e.self_device_time_total / 1e3
            n_device += e.count
    trainer.train_step = step
    return dict(step_s=step_s, cpu_s=cpu_s, part_ms=part_ms, peak=peak, launches=launches,
                prof_step_s=prof_step_s, prof_cpu_s=prof_cpu_s,
                device_ms=device_ms / PROFILED_STEPS, n_device=n_device / PROFILED_STEPS,
                losses=[x.item() for x in losses],
                flash=_kernels_by_name(prof, ("flash_", "key_sq_max")))


def _fit_lines(label: str, r: dict) -> None:
    ms = r["part_ms"]
    rest = r["step_s"] - (ms["frozen preprocessing"] + ms["train step"]) / 1e3
    print(f"[{label}] {r['step_s']:.3f} s/step (3 steps after the warm-up, between CUDA "
          f"events) = UniMatch {ms['UniMatch'] / 1e3:.3f} s + other frozen preprocessing "
          f"{(ms['frozen preprocessing'] - ms['UniMatch']) / 1e3:.3f} s + train step "
          f"{ms['train step'] / 1e3:.3f} s + between them {rest:.3f} s (CUDA events around "
          f"each part), "
          f"host CPU {r['cpu_s']:.3f} s/step | peak memory {r['peak'] / 2**30:.2f} GiB | "
          f"losses {r['losses']} | launches { {k: v for k, v in r['launches'].items() if v} } | "
          f"{host_line()}", flush=True)
    print(f"[{label}] profiled window: {r['prof_step_s']:.3f} s/step ({PROFILED_STEPS} step(s) "
          f"under torch.profiler), host CPU {r['prof_cpu_s']:.3f} s/step, device busy "
          f"{r['device_ms']:.1f} ms/step = {100 * r['device_ms'] / (r['prof_step_s'] * 1e3):.1f}% "
          f"of the window, {r['n_device']:.0f} device operations a step", flush=True)
    assert all(np.isfinite(r["losses"])), r["losses"]
    assert r["device_ms"] > 0.0
    for name in INFERENCE + TRAINING:
        assert r["launches"].get(name, 0) > 0, f"kernel {name} was not launched by {label}"


def _unimatch_memory_line(label: str, dev, flow_fn, frames: torch.Tensor) -> None:
    """UniMatch's flows of one clip alone: the memory it adds above what is resident."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    flow_fn((frames + 1.0) / 2.0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - resident
    print(f"[{label}] UniMatch on the clip's {frames.shape[0] - 1} pairs alone: +"
          f"{extra / 2**30:.2f} GiB above the resident {resident / 2**30:.2f} GiB", flush=True)


def _unmoved(start: dict, now: dict) -> list:
    """Names of the tensors of ``now`` still equal to ``start``; each must be all zero (the
    weight decay moves every other one), i.e. a zero tensor without a gradient."""
    still = sorted(n for n, p in now.items() if torch.equal(p, start[n]))
    assert all(not start[n].any() for n in still), f"nonzero tensors did not move: {still}"
    return still


def _timed(fn, pairs: list):
    """``fn`` with a CUDA event pair around each call, appended to ``pairs``."""
    def wrapped(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        pairs.append((start, end))
        return out
    return wrapped


def _frozen_models(dev, dtype, gen, num_frames: int, frozen_unet: bool):
    """The SVD UNet at full width (bf16, remat; the base UNet frozen, or the ``--mode lkgd``
    UNet with its fp32 trainables), the VAE, CLIP-H and UniMatch ``lkgd()``, random from
    ``gen``; the frozen ones in eval mode without gradients."""
    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection
    from lkgd_torch.models.configs import CLIPVisionConfig, SVDUNetConfig, TemporalVAEConfig
    from lkgd_torch.models.layers import init_params, materialize
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.models.unimatch import UniMatchConfig, build_unimatch
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder

    if frozen_unet:
        unet = materialize(lambda: UNetSpatioTemporalCondition(SVDUNetConfig(
            num_frames=num_frames, remat=True)), dev, dtype)
    else:
        args = cli.make_parser().parse_args(["--mode", "lkgd", "--num-frames", str(num_frames),
                                             "--rank", "4", "--remat"])
        unet = materialize(lambda: UNetSpatioTemporalCondition(cli.unet_config(args)), dev,
                           dtype, fp32=cli.trainable)
    vae = materialize(lambda: AutoencoderKLTemporalDecoder(TemporalVAEConfig()), dev, dtype)
    clip = materialize(lambda: CLIPVisionModelWithProjection(CLIPVisionConfig()), dev, dtype)
    for model in (unet, vae, clip):
        init_params(model, gen)
    for model in (vae, clip):
        model.eval().requires_grad_(False)
    unimatch = build_unimatch(UniMatchConfig.lkgd(), device=dev, generator=gen)
    return unet, vae, clip, unimatch


def phase_train_controlnet_full(dev: torch.device) -> dict:
    """The ControlNet-SDV fine-tune at full width, 512x512x8f, one clip a step: the base SVD
    UNet frozen in bf16 (remat), a ControlNet built from it with ``init_from_unet`` (fp32,
    computed in bf16 under autocast, zero-init heads 0.02 x normal), trained with EMA; the
    control is the clip's flow, UniMatch ``lkgd()`` on its 9 frames through
    ``make_flow_fn`` and ``flow_to_image_naive``, as the reference's flow control."""
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.models.controlnet_svd import (ControlNetSDV, ControlNetSDVConfig,
                                                  init_from_unet)
    from lkgd_torch.models.layers import init_params, materialize
    from lkgd_torch.training import train_state as ts
    from lkgd_torch.training import variants
    from lkgd_torch.training.trainer import Trainer, TrainerConfig
    from lkgd_torch.utils.flow_codec import flow_to_image_naive
    from lkgd_torch.utils.optical_flow import make_flow_fn

    label, frames, size = "train-controlnet", 8, 512
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(8)
    unet, vae, clip, unimatch = _frozen_models(dev, torch.bfloat16, gen, frames, True)
    controlnet = materialize(lambda: ControlNetSDV(ControlNetSDVConfig(unet=unet.config)), dev,
                             torch.float32)
    init_params(controlnet, gen)
    copied = init_from_unet(controlnet, unet)
    with torch.no_grad():
        heads = [p for n, p in controlnet.named_parameters() if n.startswith((
            "controlnet_cond_embedding.conv_out.", "controlnet_down_blocks.",
            "controlnet_mid_block."))]
        for p in heads:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    preprocess = cli.make_preprocess(vae, clip)
    parts = {"frozen preprocessing": [], "UniMatch": [], "train step": []}
    flow_fn = _timed(make_flow_fn(unimatch, (size, size)), parts["UniMatch"])
    step = _timed(variants.make_controlnet_train_step(unet), parts["train step"])

    def prepare(pixel_values, generator):  # (1, 9, H, W, 3) in [-1, 1]
        control = flow_to_image_naive(flow_fn((pixel_values[0] + 1.0) / 2.0))[None]
        return dict(preprocess(pixel_values, generator), control=control)

    prepare = _timed(prepare, parts["frozen preprocessing"])

    def train_step(state, batch, generator):
        return step(state, prepare(batch["pixel_values"], generator), generator)

    state = ts.init_train_state(controlnet, ts.make_optimizer(1e-5), ema=True)
    n_unet = sum(p.numel() for p in unet.parameters())
    n_cn = sum(p.numel() for p in controlnet.parameters())
    unet_before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(train_step, state, TrainerConfig(output_dir=out_dir,
                                                           checkpoint_every=0, seed=0))
        # the end of each fit would write the ControlNet, its moments and its EMA (11 GB)
        trainer.save_checkpoint = lambda step: None
        clips = [{"pixel_values": torch.rand((1, frames + 1, size, size, 3), generator=gen,
                                             device=dev) * 2 - 1} for _ in range(7)]
        torch.cuda.synchronize()
        print(f"[{label}] ControlNet-SDV fine-tune {size}x{size}x{frames}f, batch 1: frozen UNet "
              f"{n_unet / 1e9:.3f} B bf16 (remat), ControlNet {n_cn / 1e9:.3f} B fp32 computed in "
              f"bf16 (autocast), {copied} tensors from the UNet, {len(heads)} zero-init head "
              f"tensors 0.02 x normal, EMA, no end-of-fit checkpoint; UniMatch lkgd() "
              f"{sum(p.numel() for p in unimatch.parameters()) / 1e6:.2f} M fp32; set-up "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        start = {n: p.detach().clone() for n, p in state.trainables.items()}
        ema_start = {n: e.clone() for n, e in state.ema_params.items()}
        r = _fit_windows(label, dev, trainer, clips, parts)
    _fit_lines(label, r)
    _unimatch_memory_line(label, dev, flow_fn, clips[0]["pixel_values"][0])
    still = _unmoved(start, state.trainables)
    # an EMA entry moves by 1e-4 of its parameter's move: below fp32's step at 1.0 for the
    # norm scales and mixing factors
    ema_moved = sum(not torch.equal(e, ema_start[n]) for n, e in state.ema_params.items())
    unet_same = all(torch.equal(p, unet_before[n]) for n, p in unet.named_parameters())
    print(f"[{label}] UNet bit-identical {unet_same} ({len(unet_before)} tensors) | ControlNet "
          f"moved {len(start) - len(still)}/{len(start)} (unmoved: zero and without a "
          f"gradient, {still}), its EMA {ema_moved}/{len(ema_start)} | step {state.step}",
          flush=True)
    assert unet_same and not any(p.requires_grad for p in unet.parameters())
    assert 2 * ema_moved > len(ema_start) and state.step == FIT_STEPS
    return r["launches"]


def phase_train_flow_full(dev: torch.device) -> dict:
    """The flow-video fine-tune ("of") at full width, 512x512x8f, one clip a step:
    ``make_flow_batch_fn`` with UniMatch ``lkgd()`` and the base VAE on 9 frames, the CLIP
    embedding of the first frame, then ``make_svd_train_step`` on the ``--mode lkgd`` UNet
    (bf16, remat; the knowledge fusion and the rank-4 temporal LoRA trained in fp32)."""
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.training import flow as tflow
    from lkgd_torch.training import train_state as ts
    from lkgd_torch.training.trainer import Trainer, TrainerConfig
    from lkgd_torch.utils.optical_flow import make_flow_fn

    label, frames, size = "train-flow", 8, 512
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(9)
    unet, vae, clip, unimatch = _frozen_models(dev, torch.bfloat16, gen, frames, False)
    parts = {"frozen preprocessing": [], "UniMatch": [], "train step": []}
    flow_fn = _timed(make_flow_fn(unimatch, (size, size)), parts["UniMatch"])
    prep = tflow.make_flow_batch_fn(flow_fn, vae, "of")
    step = _timed(ts.make_svd_train_step(ts.SVDTrainConfig()), parts["train step"])
    # (1, 9, H, W, 3) in [-1, 1]: the first frame's CLIP embedding, then the flow batch
    prepare = _timed(lambda pixel_values, generator: prep(
        pixel_values, cli.clip_embedding(clip, pixel_values[:, 0]), generator),
        parts["frozen preprocessing"])

    def train_step(state, batch, generator):
        return step(state, prepare(batch["pixel_values"], generator), generator)

    state = ts.init_train_state(unet, ts.make_optimizer(2e-4, trainable_predicate=cli.trainable))
    frozen = {n: p.detach().clone() for n, p in unet.named_parameters()
              if n in ("conv_in.weight", "mid_block.resnets.0.spatial_res_block.conv1.weight",
                       "up_blocks.3.attentions.2.transformer_blocks.0.ff.net.2.weight")}
    assert len(frozen) == 3
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(train_step, state, TrainerConfig(output_dir=out_dir,
                                                           checkpoint_every=0, seed=0))
        clips = [{"pixel_values": torch.rand((1, frames + 1, size, size, 3), generator=gen,
                                             device=dev) * 2 - 1} for _ in range(7)]
        torch.cuda.synchronize()
        n_train = sum(p.numel() for p in state.trainables.values())
        print(f"[{label}] flow-video fine-tune ('of') {size}x{size}x{frames}f, batch 1: UNet "
              f"{sum(p.numel() for p in unet.parameters()) / 1e9:.3f} B bf16 (remat), "
              f"{len(state.trainables)} trainable tensors ({n_train / 1e6:.3f} M, fp32, the "
              f"--mode lkgd set); set-up {time.perf_counter() - t0:.1f} s", flush=True)
        start = {n: p.detach().clone() for n, p in state.trainables.items()}
        r = _fit_windows(label, dev, trainer, clips, parts)
    _fit_lines(label, r)
    _unimatch_memory_line(label, dev, flow_fn, clips[0]["pixel_values"][0])
    still = _unmoved(start, state.trainables)
    same = all(torch.equal(p, frozen[n]) for n, p in unet.named_parameters() if n in frozen)
    print(f"[{label}] trainables moved {len(start) - len(still)}/{len(start)} (unmoved: zero "
          f"and without a gradient, {still}) | sampled frozen weights bit-identical {same} | "
          f"step {state.step}", flush=True)
    assert same and state.step == FIT_STEPS
    return r["launches"]


def _kernels_by_name(prof, words) -> dict:
    """Kernel name -> (device ms, launches) over a profile, for the device entries whose
    name holds one of ``words`` (template arguments kept, casts and namespaces dropped)."""
    from torch.autograd import DeviceType

    found = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(w in e.key for w in words):
            found[_kernel_name(e.key)] = (round(e.self_device_time_total / 1e3, 3), e.count)
    return found


def _cogvideox_cache(dev: torch.device, path: str, gen: torch.Generator) -> None:
    """The cache ``train_cogvideox_lora`` reads, filled at full width: T5-XXL (random bf16
    weights) encodes two prompts of seeded token ids, 226 tokens (the second padded after
    120), timed and freed before anything else is resident; the CogVideoX VAE (bf16)
    encodes two synthetic 49x480x720 clips in chunks of 8 frames to 13 latent frames,
    scaled by 0.7, and each clip's first frame alone; with width-1000 domain and flow
    features, two samples."""
    from lkgd_torch.cli import run_inference_cogvideox as infer
    from lkgd_torch.data.tensor_cache import TensorCache
    from lkgd_torch.models.configs import CogVideoXVAEConfig, T5Config
    from lkgd_torch.models.layers import init_params, materialize
    from lkgd_torch.models.t5_text import build_t5_encoder
    from lkgd_torch.models.vae_cogvideox import AutoencoderKLCogVideoX

    label = "train-cogvideox"
    t0 = time.perf_counter()
    t5 = build_t5_encoder(T5Config.xxl(), torch.bfloat16, dev, gen)
    n_t5 = sum(p.numel() for p in t5.parameters())
    ids = torch.randint(0, t5.config.vocab_size, (2, 226), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[1, 120:] = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        t5(ids, mask)  # warm-up
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        start.record()
        prompt = t5(ids, mask)
        end.record()
        torch.cuda.synchronize()
    t5_s, t5_peak = start.elapsed_time(end) / 1e3, torch.cuda.max_memory_allocated(dev)
    assert prompt.shape == (2, 226, t5.config.d_model) and torch.isfinite(prompt).all()
    prompt = prompt.float()
    print(f"[{label}] T5-XXL encoder {n_t5 / 1e9:.3f} B bf16 random params (set-up and a "
          f"warm-up {setup_s:.1f} s): 2 prompts x 226 tokens (the second padded after 120) "
          f"{t5_s:.3f} s between CUDA events, peak {t5_peak / 2**30:.2f} GiB | embeddings "
          f"{tuple(prompt.shape)} mean {prompt.mean().item():.4f} std {prompt.std().item():.4f}; "
          f"freed before the VAE and the DiT", flush=True)
    del t5, ids, mask
    torch.cuda.empty_cache()

    vcfg = CogVideoXVAEConfig()
    vae = materialize(lambda: AutoencoderKLCogVideoX(vcfg), dev, torch.bfloat16)
    init_params(vae, gen)
    vae.eval().requires_grad_(False)
    args = infer.make_parser().parse_args(["--image", "-", "--vae-chunk-frames", "2",
                                           "--device", str(dev)])
    frames, height, width = COG_CLIP
    tt = torch.linspace(0, 1, frames, device=dev)[:, None, None, None]
    yy = torch.linspace(-1, 1, height, device=dev)[:, None, None]
    xx = torch.linspace(-1, 1, width, device=dev)[None, :, None]
    shape = ((frames - 1) // vae.temporal_scale + 1, height // vae.spatial_scale,
             width // vae.spatial_scale, vcfg.latent_channels)
    cache = TensorCache(path)
    seconds, peaks = [], []
    with torch.inference_mode():
        for i in range(2):
            rgb = torch.tensor([0.0, 2.1, 4.2], device=dev) + i
            clip = torch.sin(3 * xx + 2 * yy + 4 * tt + rgb)[None].to(torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            latents = infer.encode(vae, clip, args)
            first = infer.encode(vae, clip[:, :1], args)[:, 0]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)
            peaks.append(torch.cuda.max_memory_allocated(dev))
            assert latents.shape == (1, *shape) and first.shape == (1, *shape[1:])
            assert torch.isfinite(latents).all() and torch.isfinite(first).all()
            cache.put(f"clip{i}/latents", latents[0])
            cache.put(f"clip{i}/image_latents", first[0])
            cache.put(f"clip{i}/prompt_embeds", prompt[i])
            for field in ("domain_features", "flow_features"):
                cache.put(f"clip{i}/{field}", torch.randn((1, 1000), generator=gen, device=dev))
    cache.close()
    print(f"[{label}] CogVideoX VAE {sum(p.numel() for p in vae.parameters()) / 1e9:.3f} B bf16: "
          f"chunked encode (8 frames a chunk) of a {frames}x{height}x{width} clip to "
          f"{shape[0]} latent frames and of its first frame, scaled by {vcfg.scaling_factor}: "
          f"{', '.join(f'{s:.3f}' for s in seconds)} s, peak {max(peaks) / 2**30:.2f} GiB | "
          f"latents std {latents.std().item():.4f} | cache {os.path.getsize(path) / 2**20:.1f} "
          f"MiB of 2 samples", flush=True)
    del vae
    torch.cuda.empty_cache()


def phase_train_cogvideox_full(dev: torch.device) -> dict:
    """The CogVideoX-5B I2V fine-tune path at full width: the cache filled by T5-XXL and the
    VAE (``_cogvideox_cache``), the LoRA fine-tune from it (8f, ``_train_cogvideox_lora``),
    then 8g, ``--full-finetune --remat`` at 2 layers. Returns the launches of the cache fill,
    the timed window and the validation."""
    import tempfile

    gen = torch.Generator(device=dev).manual_seed(21)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/cache.lkgd"
        _zero_counts()
        _cogvideox_cache(dev, path, gen)
        fill_launches = _read_counts()
        launches, val_launches = _train_cogvideox_lora(dev, path, f"{tmp}/out", gen)
        torch.cuda.empty_cache()  # everything of 8f is freed on its return
        phase_train_cogvideox_sft(dev, path)
    return {k: fill_launches[k] + launches[k] + val_launches[k] for k in launches}


def _train_cogvideox_lora(dev: torch.device, path: str, out_dir: str, gen: torch.Generator):
    """8f: the CogVideoX-5B I2V LoRA fine-tune at full width (42 layers x 48 heads,
    49x480x720: 13 latent frames, 17776 joint tokens, one clip a step) through
    ``lkgd_torch/cli/train_cogvideox_lora.py``'s ``build`` at ``--rank 128 --lora-alpha 64
    --remat`` (frozen bf16 DiT, fp32 LoRA and fusion, the fusion's zero-init output 0.02 x
    normal) on the cache at ``path``, read through the CLI's own dataset: a warm-up step,
    three between CUDA events (the cache read and host-to-device copy apart from the train
    step, host CPU s/step, peak memory, launches a step: kernels 7/8 84, 9/10 42, 5/6 126,
    1a 84, no inference kernel) and one (PROFILED_STEPS) under ``torch.profiler`` (busy share, flash
    kernels by name); the LoRA factors and the fusion moved, sampled frozen weights
    bit-identical, the trainable count, one block's activations without remat, the export
    read back, and one 2-step validation (kernels 1/2). Returns the launches of the timed
    window and of the validation."""
    from lkgd_torch.cli import train_cogvideox_lora as cli
    from lkgd_torch.data.tensor_cache import PrecomputedLatentDataset

    label = "train-cogvideox"
    t0 = time.perf_counter()
    args = cli.make_parser().parse_args([
        "--cache", path, "--output-dir", out_dir, "--rank", "128", "--lora-alpha", "64",
        "--remat", "--device", str(dev), "--checkpoint-every", "0", "--seed", "0",
        "--validation-every", str(10 ** 9), "--num-validation-steps", "2"])
    ds = cli._Adapted(PrecomputedLatentDataset(path), 4096)
    run = cli.build(args, ds[0])
    trainer, model = run.trainer, run.transformer
    # the end of each fit would write the trainables and their moments (1.7 GB)
    trainer.save_checkpoint = lambda step: None
    filled = _fill_fusion_output(model, gen)
    state = trainer.state
    lora = [p for n, p in state.trainables.items() if "lora_" in n]
    n_all = sum(p.numel() for p in model.parameters())
    last = model.config.num_layers - 1
    sampled = ("patch_embed.proj.weight", "time_embedding.linear_1.weight",
               "transformer_blocks.0.attn1.to_q.weight",
               f"transformer_blocks.{last // 2}.norm1.linear.weight",
               f"transformer_blocks.{last}.ff.net.2.weight", "proj_out.weight")
    params = dict(model.named_parameters())
    frozen = {n: params[n].detach().clone() for n in sampled}
    lat = tuple(ds[0]["latents"].shape[:3])
    tokens = ds[0]["prompt_embeds"].shape[0] + lat[0] * lat[1] * lat[2] // 4
    torch.cuda.synchronize()
    print(f"[{label}] CogVideoX-5B I2V LoRA fine-tune {'x'.join(map(str, COG_CLIP))} ("
          f"{' x '.join(map(str, lat))} latents, {tokens} tokens), batch 1: DiT "
          f"{n_all / 1e9:.3f} B, frozen bf16, remat; "
          f"{len(state.trainables)} trainable tensors fp32 ({len(lora)} LoRA factors = "
          f"{sum(p.numel() for p in lora) / 1e6:.1f} M, the fusion "
          f"{sum(p.numel() for n, p in state.trainables.items() if 'lora_' not in n) / 1e6:.2f}"
          f" M; {filled} fusion output tensors 0.02 x normal); set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert len(lora) == 42 * 4 * 2 and model.config.num_layers == 42
    assert tokens == COG_TRAIN[1], tokens  # the shape phase 3d holds the kernels at
    start = {n: p.detach().clone() for n, p in state.trainables.items()}

    parts = {"read and host-to-device": [], "train step": []}
    read = _timed(lambda i: {k: v[None].to(dev) for k, v in ds[i].items()},
                  parts["read and host-to-device"])
    step = _timed(trainer.train_step, parts["train step"])
    trainer.train_step = lambda state, i, generator: step(state, read(i), generator)
    r = _fit_windows(label, dev, trainer, [i % 2 for i in range(7)], parts)
    launches, ms = r["launches"], r["part_ms"]
    per_step = {k: v / 3 for k, v in launches.items() if v}
    print(f"[{label}] {r['step_s']:.3f} s/step (3 steps after the warm-up, between CUDA "
          f"events) = cache read and host-to-device {ms['read and host-to-device'] / 1e3:.3f} "
          f"s + train step {ms['train step'] / 1e3:.3f} s, host CPU {r['cpu_s']:.3f} s/step "
          f"| peak memory {r['peak'] / 2**30:.2f} GiB | losses {r['losses']} | launches a "
          f"step {per_step} | {host_line()}", flush=True)
    busy = r["device_ms"] / (r["prof_step_s"] * 1e3)
    flash = r["flash"]
    flash_ms = sum(m for m, _ in flash.values()) / PROFILED_STEPS
    print(f"[{label}] profiled window: {r['prof_step_s']:.3f} s/step ({PROFILED_STEPS} step(s) "
          f"under torch.profiler), host CPU {r['prof_cpu_s']:.3f} s/step, device busy "
          f"{r['device_ms']:.1f} ms/step = {100 * busy:.1f}% of the window, "
          f"{r['n_device']:.0f} device operations a step | flash kernels "
          f"{flash_ms:.1f} ms/step = {100 * flash_ms / r['device_ms']:.1f}% of the device "
          f"time; by name (device ms a step, launches a step): " + ", ".join(
              f"{k} {m / PROFILED_STEPS:.3f}, {n / PROFILED_STEPS:.0f}"
              for k, (m, n) in flash.items()), flush=True)
    assert all(np.isfinite(r["losses"])) and r["device_ms"] > 0.0, r["losses"]
    want = {"flash_bound_lse": 84, "flash_maxtrack_lse": 84, "flash_bwd_dq": 42,
            "flash_bwd_dkv": 42, "split_heads": 126, "merge_heads": 126, "flash_key_norm": 84}
    assert per_step == want, (per_step, want)
    for form in ("flash_fwd_wgmma_kernel<64,true,true>", "flash_fwd_wgmma_kernel<64,false,true>",
                 "flash_bwd_dq_kernel<64>", "flash_bwd_dkv_kernel<64>"):
        assert form in flash, (form, sorted(flash))
    still = _unmoved(start, state.trainables)
    same = all(torch.equal(params[n], frozen[n]) for n in frozen)
    print(f"[{label}] trainables moved {len(start) - len(still)}/{len(start)} (unmoved: "
          f"{still}) | sampled frozen weights bit-identical {same} | step {state.step}",
          flush=True)
    assert same and not still and state.step == FIT_STEPS

    # the reckoning without --remat: the activations one block keeps for its backward
    captured = {}
    hook = model.transformer_blocks[0].register_forward_pre_hook(
        lambda m, a: captured.setdefault("args", a))
    with torch.no_grad():
        batch = read(0)
        model(torch.cat([batch["latents"], torch.cat([batch["image_latents"][:, None],
              torch.zeros_like(batch["latents"][:, 1:])], 1)], -1), batch["prompt_embeds"],
              torch.tensor([500.0], device=dev), batch["domain_features"],
              batch["flow_features"])
    hook.remove()
    hidden, encoder, emb, rope, _ = captured.pop("args")  # the last: no context group
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = model.transformer_blocks[0](hidden.requires_grad_(), encoder.requires_grad_(), emb,
                                      rope)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated(dev) - before
    del out, hidden, encoder, emb, rope, batch
    print(f"[{label}] without --remat: one block keeps {kept / 2**30:.2f} GiB for its "
          f"backward (its output included), x 42 = {42 * kept / 2**30:.1f} GiB on top of the "
          f"resident weights", flush=True)

    path_out = f"{out_dir}/model.safetensors"
    n = cli.export(run, path_out)
    exported = _read_safetensors(path_out)
    names = {cli.cogvideox_export_name(k): k for k in state.trainables}
    assert n == len(exported) == len(state.trainables) and sorted(exported) == sorted(names)
    for key, value in exported.items():
        assert np.array_equal(value, state.trainables[names[key]].detach().float().cpu().numpy())
    print(f"[{label}] export: {n} tensors, {os.path.getsize(path_out) / 2**20:.1f} MiB, read "
          f"back equal", flush=True)

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.validation_fn(state, state.step)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_launches = _read_counts()
    latents = np.load(f"{out_dir}/validation/step{state.step}_latents.npy")
    print(f"[{label}] validation: 2 DDIM steps, CFG (2 rows), {'x'.join(map(str, COG_CLIP))} "
          f"{val_s:.3f} s | "
          f"latents {latents.shape} std {latents.std():.4f} | launches "
          f"{ {k: v for k, v in val_launches.items() if v} }", flush=True)
    assert latents.shape == (1, *ds[0]["latents"].shape) and np.isfinite(latents).all()
    assert val_launches["flash_bound"] == val_launches["flash_maxtrack"] == 2 * 42
    return launches, val_launches


def phase_train_cogvideox_sft(dev: torch.device, cache: str) -> None:
    """8g: ``--full-finetune --remat`` at full width cut to 2 layers (5.573 B fp32 weights,
    gradients and two moments would be 89 GB), one step from the cache, the fusion's
    zero-init output 0.02 x normal: fp32 parameters computed in bf16, every parameter
    moved, its peak memory."""
    import tempfile

    from lkgd_torch.cli import train_cogvideox_lora as cli
    from lkgd_torch.data.tensor_cache import PrecomputedLatentDataset

    label = "train-cogvideox-sft"
    with tempfile.TemporaryDirectory() as tmp:
        args = cli.make_parser().parse_args([
            "--cache", cache, "--output-dir", tmp, "--full-finetune", "--remat", "--device",
            str(dev), "--checkpoint-every", "0", "--seed", "1", "--max-steps", "1"])
        torch.cuda.reset_peak_memory_stats(dev)
        run = cli.build(args, num_layers=2)
        run.trainer.save_checkpoint = lambda step: None
        model, state = run.transformer, run.trainer.state
        _fill_fusion_output(model, torch.Generator(device=dev).manual_seed(22))
        n_all = sum(p.numel() for p in model.parameters())
        start = {n: p.detach().clone() for n, p in state.trainables.items()}
        batch = {k: v[None].to(dev) for k, v in
                 cli._Adapted(PrecomputedLatentDataset(cache), 4096)[0].items()}
        losses = []
        step = run.trainer.train_step

        def recorded(state, batch, generator):
            state, loss = step(state, batch, generator)
            losses.append(loss)
            return state, loss

        run.trainer.train_step = recorded
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        run.trainer.fit(iter([batch]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        still = _unmoved(start, state.trainables)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[{label}] --full-finetune --remat, 2 of 42 layers at full width, "
              f"{'x'.join(map(str, COG_CLIP))}: "
              f"{n_all / 1e9:.3f} B parameters, all {len(state.trainables)} trainable in fp32, "
              f"computed in bf16 | one step {seconds:.3f} s (the first: with the optimizer's "
              f"state made), loss {losses[0].item():.5f} | peak {peak / 2**30:.2f} GiB "
              f"(resident before the step {resident / 2**30:.2f} GiB) | moved "
              f"{len(start) - len(still)}/{len(start)} (unmoved: {still})", flush=True)
        assert len(state.trainables) == len(list(model.parameters())) and state.step == 1
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert np.isfinite(losses[0].item()) and not still
    del run, model, state, start
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ SD-2D at 512x512
SD2D_FLASH = (("unet level 0", (2, 4096, 5, 64)), ("unet level 1", (2, 1024, 10, 64)),
              # joint control: CFG x one [x, y] pair
              ("joint control level 0", (4, 4096, 5, 64)),
              ("joint control level 1", (4, 1024, 10, 64)), ("vae mid", (1, 4096, 1, 512)))
SD2D_TRAIN = (("joint LoRA step level 0", (2, 4096, 5, 64)),  # one x/y pair
              ("joint LoRA step level 1", (2, 1024, 10, 64)))
SD2D_GN = (2, 4096, 320)  # the UNet's level-0 transformer norm (eps 1e-6) and resblocks
SD2D_FLASH_A_FORWARD = 10  # flash self-attentions of one UNet forward at 512x512: 2 + 3 a level
SD2D_SIZE, SD2D_CTX = 512, 1024  # image side; SD2's text width (OpenCLIP-H)


def phase_sd2d_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels 1, 2 and 1a at the SD2 UNet's level-0 and level-1 self-attention (one image
    and joint control's pair, each under CFG) and the image VAE's mid block; 5/6, 7/8 and
    9/10 at the joint LoRA step's two levels; 3/4 at the level-0 transformer norm
    (2, 4096, 320), eps 1e-6, with and without SiLU. Each against its plain version, its
    device time under ``torch.profiler`` beside its wrapper's (these calls are short enough
    for the host to set the pace), the library call's time and the bound. Returns the rows
    by kernel, a list each."""
    rows = {}
    tables = [_forward_rows("sd2d-kernel", label, shape, gen, rows_of(2))
              for label, shape in SD2D_FLASH]
    tables += [_train_rows("sd2d-kernel", label, shape, gen, rows_of(1))
               for label, shape in SD2D_TRAIN]
    for table in tables:
        for kernel, row in table.items():
            rows.setdefault(kernel, []).append(row)
    gn_rows = _gn_rows("sd2d-kernel", "unet level 0", SD2D_GN, gen, 1e-6, (None, "silu"))
    rows["gn_stats"], rows["gn_apply"] = [gn_rows["gn_stats"]], gn_rows["gn_apply"]
    rows["gn_one_pass"] = gn_rows["gn_one_pass"]
    torch.cuda.empty_cache()
    return rows


def _random_twins(build, dev: torch.device, seed: int, scale: float = 0.1):
    """A module built on the CPU with every parameter ``scale`` x normal (every zero-init
    tensor included), and its copy built on ``dev``."""
    cpu = build("cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    gpu = build(dev)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, gpu


def _sd2d_tiny_unet(**kw):
    from lkgd_torch.cli.run_inference_sd2d import TINY_UNET
    from lkgd_torch.models.configs import UNet2DConfig

    return UNet2DConfig(**{**TINY_UNET, **kw})


def phase_tiny_sd2d(dev: torch.device) -> None:
    """The tiny SD-2D models, pipelines and joint LoRA train step at fp32 on the card against
    the CPU with the same weights (every parameter random) and draws."""
    from lkgd_torch.cli.run_inference_sd2d import TINY_VAE
    from lkgd_torch.models.clip_text import CLIPTextModel
    from lkgd_torch.models.configs import (CLIPTextConfig, ControlNet2DConfig,
                                           JointAttentionConfig, LoraRouter, LoraRule,
                                           VAE2DConfig)
    from lkgd_torch.models.controlnet_2d import ControlNet2D
    from lkgd_torch.models.layers import materialize
    from lkgd_torch.models.unet_2d import UNet2DCondition
    from lkgd_torch.models.vae_2d import AutoencoderKL
    from lkgd_torch.pipelines import sd2d as pipes
    from lkgd_torch.training import train_state as ts
    from lkgd_torch.training.sd2d import SD2DTrainConfig, make_sd2d_train_step

    label = "tiny-sd2d"
    g = torch.Generator().manual_seed(20)

    def on(x, d):
        return tuple(on(y, d) for y in x) if isinstance(x, tuple) else (
            x.to(d) if torch.is_tensor(x) else x)

    def both(models, args, kw=None, method=None):
        outs = []
        for model, d in zip(models, ("cpu", dev)):
            with torch.no_grad():
                fn = getattr(model, method) if method else model
                outs.append(on(fn(*on(args, d), **{k: on(v, d) for k, v in (kw or {}).items()}),
                               "cpu"))
        return outs

    rows = 4
    x4 = torch.randn((rows, 16, 16, 4), generator=g)
    t = torch.tensor([3.0, 999.0, 500.0, 41.0])
    ctx = torch.randn((rows, 5, 32), generator=g)
    tracks = (torch.rand((2, 24, 2), generator=g) * 64 - 2,
              torch.rand((2, 24, 2), generator=g) * 64,
              (torch.rand((2, 24), generator=g) > 0.3).float())
    residuals = (tuple(torch.randn((rows, s, s, c), generator=g) for c, s in
                       ((32, 16), (32, 16), (32, 8), (64, 8))),
                 torch.randn((rows, 8, 8, 64), generator=g))
    cases = {
        "base, per-sample timesteps, ControlNet residuals": (
            _sd2d_tiny_unet(), (x4, t, ctx), dict(down_block_additional_residuals=residuals[0],
                                                  mid_block_additional_residual=residuals[1])),
        "9 channels, conditioning encoder": (
            _sd2d_tiny_unet(in_channels=9, cond_embedding_channels=3,
                            cond_embedding_blocks=(16, 32, 96)),
            (torch.randn((rows, 16, 16, 9), generator=g), t, ctx),
            dict(cond_image=torch.rand((rows, 64, 64, 3), generator=g))),
        "joint conv_fuse + LoRA, tracks in pixels": (
            _sd2d_tiny_unet(joint=JointAttentionConfig(post="conv_fuse", mask=(0, 1, 0, 1)),
                            lora=LoraRouter((LoraRule("*attn1*", "xy", 2, 4.0, (1, 0, 1, 0)),)),
                            track_fusion=True),
            (x4, t, ctx), dict(joint_scale=0.7, tracks=tracks, track_image_size=(64, 64)))}
    for i, (name, (config, args, kw)) in enumerate(cases.items()):
        models = _random_twins(lambda d: materialize(lambda: UNet2DCondition(config), d,
                                                     torch.float32), dev, 21 + i)
        want, got = both(models, args, kw)
        _close_line(label, f"UNet ({name})", got, want)

    vae = _random_twins(lambda d: materialize(lambda: AutoencoderKL(VAE2DConfig(**TINY_VAE)), d,
                                              torch.float32), dev, 24)
    image = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1
    for method, arg in (("encode_mode", image), ("decode", torch.randn((2, 8, 8, 4), generator=g)),
                        ("forward", image)):
        want, got = both(vae, (arg,), method=None if method == "forward" else method)
        _close_line(label, f"VAE {method}", got, want)
    cn = _random_twins(lambda d: materialize(lambda: ControlNet2D(ControlNet2DConfig(
        unet=_sd2d_tiny_unet(), conditioning_embedding_out_channels=(16, 32, 96))), d,
        torch.float32), dev, 25)
    want, got = both(cn, (x4, t, ctx, torch.rand((rows, 64, 64, 3), generator=g), 0.7))
    for j, (gw, ww) in enumerate(zip(got[0] + (got[1],), want[0] + (want[1],))):
        _close_line(label, f"ControlNet-2D residual {j}", gw, ww)
    text = _random_twins(lambda d: materialize(lambda: CLIPTextModel(CLIPTextConfig.tiny()), d,
                                               torch.float32), dev, 26)
    ids = torch.randint(0, 128, (2, 16), generator=g)
    for index in (-1, -2):
        want, got = both(text, (ids, index))
        _close_line(label, f"CLIP text at {index}", got, want)

    pcfg = pipes.SD2DPipelineConfig(height=32, width=32, num_inference_steps=2)
    vcfg = VAE2DConfig(**TINY_VAE)
    prompt, negative = torch.randn((1, 4, 32), generator=g), torch.randn((1, 4, 32), generator=g)
    img, ctrl = torch.rand((1, 32, 32, 3), generator=g), torch.rand((1, 32, 32, 3), generator=g)
    mask = torch.zeros((1, 32, 32, 1))
    mask[:, 6:21, 5:22] = 1.0
    pipelines = {
        "inpaint + ControlNet-2D": (
            lambda d: pipes.StableDiffusionInpaintPipeline(
                pcfg, _sd2d_tiny_unet(in_channels=9), vcfg, ControlNet2DConfig(
                    unet=_sd2d_tiny_unet(), conditioning_embedding_out_channels=(16, 32, 96)),
                torch.float32, d),
            lambda p, n: p(prompt, img, mask, negative, control=ctrl, initial_noise=n), 1),
        "joint control, joint UNet, cond_y, spatial mask, two pairs": (
            lambda d: pipes.StableDiffusionJointControlPipeline(
                pcfg, _sd2d_tiny_unet(joint=JointAttentionConfig(post="conv", mask=(0, 1, 0, 1))),
                vcfg, False, torch.float32, d),
            lambda p, n: p(prompt.repeat(2, 1, 1), img.repeat(2, 1, 1, 1), negative.repeat(2, 1, 1),
                           spatial_mask=mask.repeat(2, 1, 1, 1), initial_noise=n), 4),
        "condition": (
            lambda d: pipes.StableDiffusionConditionPipeline(
                pcfg, _sd2d_tiny_unet(cond_embedding_channels=3,
                                      cond_embedding_blocks=(16, 32, 96)), vcfg, torch.float32, d),
            lambda p, n: p(prompt, ctrl, negative, initial_noise=n), 1)}
    for i, (name, (build, call, rows_n)) in enumerate(pipelines.items()):
        cpu, gpu = build("cpu"), build(dev)
        gen = torch.Generator().manual_seed(30 + i)
        with torch.no_grad():
            for mc, mg in zip(_all_models(cpu), _all_models(gpu)):
                for p in mc.parameters():
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
                mg.load_state_dict(mc.state_dict(), strict=True)
        noise = torch.randn((rows_n, 8, 8, 4), generator=gen)
        want, got = call(cpu, noise), call(gpu, noise.to(dev))
        _close_line(label, f"pipeline {name}, images", got, want)

    config = _sd2d_tiny_unet(joint=JointAttentionConfig(post="conv", mask=(0, 1)),
                             lora=LoraRouter((LoraRule("*attn1*", "j", 2, 2.0),)))
    models = _random_twins(lambda d: materialize(lambda: UNet2DCondition(config), d,
                                                 torch.float32), dev, 27)
    batch = {"latents": torch.randn((2, 16, 16, 4), generator=g) * 0.5,
             "prompt_embeds": torch.randn((2, 5, 32), generator=g)}
    draws = {"timesteps": torch.tensor([412, 412]), "noise": torch.randn((2, 16, 16, 4),
                                                                           generator=g),
             "drop": torch.tensor([False, True])}
    results = []
    for model, d in zip(models, ("cpu", dev)):
        optimizer = ts.make_optimizer(1e-3, trainable_predicate=ts.trainable_trans)
        state = ts.init_train_state(model, optimizer)
        start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
        grads = {}
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu().clone()))
            for n, p in state.trainables.items()]
        step = make_sd2d_train_step(model, optimizer,
                                    config=SD2DTrainConfig(snr_gamma=5.0, joint_streams=True))
        state, loss = step(state, {k: v.to(d) for k, v in batch.items()},
                           **{k: v.to(d) for k, v in draws.items()})
        for h in hooks:
            h.remove()
        results.append((loss.item(), grads, start,
                        {n: p.detach().cpu() for n, p in state.trainables.items()}))
    (loss_c, grads_c, start, _), (loss_g, grads_g, _, after_g) = results
    print(f"[{label}] joint LoRA train step loss GPU {loss_g:.6f} CPU {loss_c:.6f}", flush=True)
    assert abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    assert sorted(grads_g) == sorted(grads_c) == sorted(start)
    floor = 1e-2 * max(x.abs().max().item() for x in grads_c.values())
    worst = 0.0
    for name, want in grads_c.items():
        scale = max(floor, want.abs().max().item())
        worst = max(worst, ((grads_g[name] - want).abs().max() / scale).item())
        torch.testing.assert_close(grads_g[name] / scale, want / scale, rtol=1e-4, atol=2e-4,
                                   msg=name)
    want_after = _cpu_step_from(start, {n: grads_g.get(n) for n in start})
    step_err = max((after_g[n] - want_after[n]).abs().max().item() for n in start)
    print(f"[{label}] joint LoRA train step: {len(grads_c)} gradients, max |d| / scale "
          f"{worst:.2e} (each scaled by its largest entry or 1% of the largest of all); the "
          f"update against the CPU's AdamW on the card's gradients max|d| {step_err:.2e}",
          flush=True)
    for name in start:
        torch.testing.assert_close(after_g[name], want_after[name], rtol=1e-4, atol=2e-4,
                                   msg=name)


def _sd2d_image(gen: torch.Generator) -> np.ndarray:
    """A smooth colour gradient with a little noise, (H, W, 3) in [0, 1], on the host."""
    size = SD2D_SIZE
    ramp = torch.linspace(0.0, 1.0, size, device=gen.device)
    img = torch.stack([ramp[None, :].expand(size, size), ramp[:, None].expand(size, size),
                       0.5 * torch.ones(size, size, device=gen.device)], dim=-1)
    img = img + 0.05 * torch.randn((size, size, 3), generator=gen, device=gen.device)
    return img.clamp(0, 1).cpu().numpy()


def _sd2d_run(label: str, dev, run, decode, streams: int, flash_each: int, steps: int) -> dict:
    """A warm-up image, then a counted one (``_timed_clip``): its line, its checks and the
    launches asserted (``flash_each`` flash calls a UNet step and one each VAE encode and
    decode)."""
    _timed_clip(dev, run, decode, seed=0)
    r = _timed_clip(dev, run, decode, seed=0)
    print(_clip_line(label, r, steps).replace("s/clip", "s/image"), flush=True)
    images, launches = r["frames"], r["launches"]
    assert images.shape == (streams, SD2D_SIZE, SD2D_SIZE, 3), images.shape
    assert torch.isfinite(r["latents"]).all() and torch.isfinite(images).all()
    assert images.min().item() >= 0.0 and images.max().item() <= 1.0
    expect = steps * flash_each + 2
    for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
        assert launches.get(name, 0) == expect, (label, name, launches.get(name), expect)
    for name in GN_FORMS:  # level 0 one pass; the VAE's full resolution two
        assert launches.get(name, 0) > 0, (label, name)
    for name in TRAINING + EXPERIMENTS:
        assert launches.get(name, 0) == 0, (label, name)
    print(f"[{label}] flash launches {launches['flash_bound']} = {steps} steps x {flash_each} "
          f"+ VAE encode 1 + decode 1, as asserted", flush=True)
    return launches


def phase_sd2d_full(dev: torch.device) -> dict:
    """SD2 at full width on the card, bf16, random weights from a seed: inpaint 512x512, 50
    DDIM steps, guidance 7.5 through ``lkgd_torch/cli/run_inference_sd2d.py``'s ``build``
    (one UNet step profiled); inpaint with ControlNet-2D; joint control as the CLI builds it
    and with a joint UNet; the CLIP-H text tower at -1 and -2; one UNet forward with 256 point
    tracks. Returns the launches of each path."""
    from lkgd_torch.cli import run_inference_sd2d as cli
    from lkgd_torch.models.clip_text import CLIPTextModel
    from lkgd_torch.models.configs import (CLIPTextConfig, ControlNet2DConfig,
                                           JointAttentionConfig, UNet2DConfig)
    from lkgd_torch.models.layers import init_params, materialize
    from lkgd_torch.models.unet_2d import UNet2DCondition
    from lkgd_torch.pipelines import sd2d as pipes

    label, steps, size, lat = "sd2d", 50, SD2D_SIZE, SD2D_SIZE // 8
    gen = torch.Generator(device=dev).manual_seed(15)
    image = _sd2d_image(gen)
    mask = np.zeros((size, size, 1), np.float32)
    mask[size // 4:3 * size // 4, 5 * size // 16:13 * size // 16] = 1.0
    emb = torch.randn((1, 77, SD2D_CTX), generator=gen, device=dev) * 0.2
    launches = {}

    t0 = time.perf_counter()
    size_args = ["--height", str(size), "--width", str(size), "--device", str(dev)]
    args = cli.make_parser().parse_args(["--image", "synthetic", *size_args])
    pipe = cli.build(args)
    n_params = sum(p.numel() for m in pipe.models for p in m.parameters())
    print(f"[{label}] inpaint through the CLI's build: UNet + VAE {n_params / 1e9:.3f} B bf16, "
          f"{size}x{size}, {steps} DDIM steps, guidance {args.guidance_scale}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches["sd2d_inpaint"] = _sd2d_run(
        f"{label} inpaint", dev, lambda g: cli.denoise(pipe, args, emb, image, mask),
        pipe.decode, 1, SD2D_FLASH_A_FORWARD, steps)
    model_in = torch.randn((2, lat, lat, 9), generator=gen, device=dev).bfloat16()
    ctx = torch.cat([emb, emb]).bfloat16()
    _profiled(label, f"one inpaint UNet step (2 CFG rows, {lat}x{lat}x9)",
              lambda: pipe.unet(model_in, float(pipe.schedule.timesteps[10]), ctx))
    pcfg = pipe.config
    del pipe
    torch.cuda.empty_cache()

    cn_pipe = pipes.StableDiffusionInpaintPipeline(
        pcfg, controlnet_config=ControlNet2DConfig(unet=UNet2DConfig(in_channels=4)),
        dtype=torch.bfloat16, device=dev)
    cn_pipe.init_params(gen)
    filled = _fill_zero_init(cn_pipe, gen)
    control = torch.from_numpy(_sd2d_image(gen)[None])
    n_cn = sum(p.numel() for p in cn_pipe.controlnet.parameters())
    print(f"[{label}] inpaint + ControlNet-2D ({n_cn / 1e9:.3f} B bf16, {filled} zero-init "
          f"head tensors 0.02 x normal)", flush=True)
    launches["sd2d_controlnet"] = _sd2d_run(
        f"{label} inpaint+controlnet", dev,
        lambda g: cn_pipe.denoise(emb, image[None], mask[None], control=control, generator=g),
        cn_pipe.decode, 1, SD2D_FLASH_A_FORWARD + 4, steps)
    del cn_pipe
    torch.cuda.empty_cache()

    jargs = cli.make_parser().parse_args(["--mode", "joint_control", "--image", "synthetic",
                                          *size_args])
    jpipe = cli.build(jargs)
    print(f"[{label}] joint control through the CLI's build (its UNet has no joint attention: "
          f"the streams meet through the clamping alone)", flush=True)
    launches["sd2d_joint_cli"] = _sd2d_run(
        f"{label} joint-control cli", dev, lambda g: cli.denoise(jpipe, jargs, emb, image),
        jpipe.decode, 2, SD2D_FLASH_A_FORWARD, steps)
    del jpipe
    torch.cuda.empty_cache()
    joint_pipe = pipes.StableDiffusionJointControlPipeline(
        pcfg, UNet2DConfig(in_channels=4, joint=JointAttentionConfig(post="conv",
                                                                     mask=(0, 1, 0, 1))),
        dtype=torch.bfloat16, device=dev)
    joint_pipe.init_params(gen)
    with torch.no_grad():
        posts = [p for n, p in joint_pipe.unet.named_parameters() if ".conv1n." in n]
        for p in posts:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    print(f"[{label}] joint control with a joint UNet (post conv, mask (0, 1, 0, 1); "
          f"{len(posts)} conv1n tensors 0.02 x normal)", flush=True)
    launches["sd2d_joint"] = _sd2d_run(
        f"{label} joint-control joint", dev,
        lambda g: joint_pipe.denoise(emb, image[None], generator=g), joint_pipe.decode, 2,
        2 * SD2D_FLASH_A_FORWARD, steps)
    del joint_pipe
    torch.cuda.empty_cache()

    text = materialize(lambda: CLIPTextModel(CLIPTextConfig.open_clip_h()), dev, torch.bfloat16)
    init_params(text, gen)
    ids = torch.randint(0, text.config.vocab_size, (1, 77), generator=gen, device=dev)
    n_text = sum(p.numel() for p in text.parameters())
    with torch.inference_mode():
        for index in (-1, -2):
            out = text(ids, index)
            ms = gpu_ms(lambda: text(ids, index), 10)
            assert out.shape == (1, 77, SD2D_CTX) and torch.isfinite(out).all()
            print(f"[{label}] CLIP-H text tower ({n_text / 1e6:.1f} M bf16) on 77 token ids "
                  f"at {index}: {ms:.3f} ms (CUDA events, 10 calls), output std "
                  f"{out.float().std().item():.4f}", flush=True)
    del text
    torch.cuda.empty_cache()

    unet = materialize(lambda: UNet2DCondition(UNet2DConfig(track_fusion=True)), dev,
                       torch.bfloat16)
    unet.eval().requires_grad_(False)
    init_params(unet, gen)
    with torch.no_grad():
        fuse = [p for n, p in unet.named_parameters() if "conv_fuse" in n]
        for p in fuse:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    sample = torch.randn((2, lat, lat, 4), generator=gen, device=dev).bfloat16()
    tracks = (torch.rand((1, 256, 2), generator=gen, device=dev) * size,
              torch.rand((1, 256, 2), generator=gen, device=dev) * size,
              (torch.rand((1, 256), generator=gen, device=dev) > 0.2).float())
    with torch.inference_mode():
        def fused():
            return unet(sample, 500.0, ctx, tracks=tracks, track_image_size=(size, size))

        out, plain = fused(), unet(sample, 500.0, ctx)
        ms = gpu_ms(fused, 5)
        plain_ms = gpu_ms(lambda: unet(sample, 500.0, ctx), 5)
    moved = (out.float() - plain.float()).abs().amax(dim=(1, 2, 3))
    print(f"[{label}] one UNet forward of a (src, dst) pair with 256 point tracks, track_fusion "
          f"({len(fuse)} conv_fuse tensors 0.02 x normal): {ms:.3f} ms, without tracks "
          f"{plain_ms:.3f} ms (CUDA events, 5 calls); the tracks move the src row by "
          f"{moved[0].item():.3e}, the dst row by {moved[1].item():.3e}", flush=True)
    assert torch.isfinite(out).all() and (moved > 0).all()
    del unet
    torch.cuda.empty_cache()
    return launches


def phase_train_sd2d_full(dev: torch.device) -> dict:
    """The SD-2D joint LoRA train step at 512x512 through ``Trainer.fit``: one x/y pair
    (batch 2), the SD2 UNet frozen in bf16 with joint attention (post conv, mask (0, 1)) and
    a rank-64 LoRA on every ``attn1`` projection (alpha 64), the LoRA factors and the joint
    branch trained in fp32 (its zero-init ``conv1n`` 0.02 x normal), ``snr_gamma=5``,
    ``joint_streams``, 77-token embeddings; a warm-up step, three between CUDA events and
    one (PROFILED_STEPS) under ``torch.profiler``; the launches of kernels 5-10 and 1a a step asserted."""
    import tempfile

    from lkgd_torch.models.configs import JointAttentionConfig, LoraRouter, LoraRule, UNet2DConfig
    from lkgd_torch.training.sd2d import SD2DTrainConfig, build_sd2d_training
    from lkgd_torch.training.trainer import Trainer, TrainerConfig

    label = "train-sd2d"
    t0 = time.perf_counter()
    config = UNet2DConfig(joint=JointAttentionConfig(post="conv", mask=(0, 1)),
                          lora=LoraRouter((LoraRule("*attn1*", "j", 64, 64.0),)))
    state, step = build_sd2d_training(config, SD2DTrainConfig(snr_gamma=5.0, joint_streams=True),
                                      device=dev, seed=16)
    gen = torch.Generator(device=dev).manual_seed(17)
    with torch.no_grad():
        for name, p in state.trainables.items():
            if ".conv1n." in name:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    n_train = sum(p.numel() for p in state.trainables.values())
    n_all = sum(p.numel() for p in state.unet.parameters())
    lat = SD2D_SIZE // 8
    batches = [{"latents": torch.randn((2, lat, lat, 4), generator=gen, device=dev),
                "prompt_embeds": torch.randn((2, 77, SD2D_CTX), generator=gen, device=dev) * 0.2}
               for _ in range(7)]
    frozen = {n: p.detach().clone() for n, p in list(state.unet.named_parameters())[::40]
              if n not in state.trainables}
    start = {n: p.detach().clone() for n, p in state.trainables.items()}
    torch.cuda.synchronize()
    print(f"[{label}] SD2 UNet {n_all / 1e9:.3f} B with joint attention: {n_train / 1e6:.1f} M "
          f"trained in fp32 (LoRA rank 64 on attn1 and attn1n, the joint branch), the rest "
          f"bf16; one x/y pair at {SD2D_SIZE}x{SD2D_SIZE}, snr_gamma 5, no end-of-fit "
          f"checkpoint; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(step, state, TrainerConfig(output_dir=out_dir, checkpoint_every=0,
                                                     seed=0))
        trainer.save_checkpoint = lambda step: None
        r = _fit_windows(label, dev, trainer, batches, {})
    per_step = {k: v / 3 for k, v in r["launches"].items() if v}
    print(f"[{label}] {r['step_s']:.3f} s/step (3 steps after the warm-up, between CUDA events), "
          f"host CPU {r['cpu_s']:.3f} s/step | peak memory {r['peak'] / 2**30:.2f} GiB | losses "
          f"{[round(x, 5) for x in r['losses']]} | launches a step {per_step} | {host_line()}",
          flush=True)
    print(f"[{label}] profiled window: {r['prof_step_s']:.3f} s/step, host CPU "
          f"{r['prof_cpu_s']:.3f} s/step, device busy {r['device_ms']:.1f} ms/step = "
          f"{100 * r['device_ms'] / (r['prof_step_s'] * 1e3):.1f}% of the window, "
          f"{r['n_device']:.0f} device operations a step | flash kernels (ms, launches over "
          f"{PROFILED_STEPS} step(s)) {r['flash']}", flush=True)
    flash_calls = 2 * SD2D_FLASH_A_FORWARD  # attn1 and the joint branch's attn1n
    want = {"flash_bound_lse": flash_calls, "flash_maxtrack_lse": flash_calls,
            "flash_key_norm": flash_calls, "flash_bwd_dq": flash_calls,
            "flash_bwd_dkv": flash_calls, "split_heads": 2 * flash_calls,
            "merge_heads": 2 * flash_calls}
    for name, n in want.items():
        assert per_step.get(name) == n, (name, per_step.get(name), n)
    assert "flash_bound" not in per_step and "flash_maxtrack" not in per_step
    assert all(np.isfinite(r["losses"])) and r["device_ms"] > 0.0
    still = _unmoved(start, state.trainables)
    same = all(torch.equal(p, frozen[n]) for n, p in state.unet.named_parameters()
               if n in frozen)
    print(f"[{label}] launches a step as asserted {want}; trainables moved "
          f"{len(start) - len(still)}/{len(start)}, sampled frozen weights bit-identical {same}",
          flush=True)
    assert same and state.step == FIT_STEPS
    return r["launches"]


# ---------------------------------------------------------------- data in and metrics out
# fp32 flash form vs its plain version (TF32 off), of max|ref|: the 3xTF32 split's
# rounding, the tensor core's truncating sums and summation order
FP32_TOL = 2e-5
FP32_FLASH = (("precompute encode mid block", (14, 4096, 1, 512), 1.0),
              ("small head dim", (1, 1024, 1, 64), 1.0),
              ("encode mid block, two frames", (2, 4096, 1, 512), 1.0),
              # norms x3 at D=512: every row underflows the bound, the guard recomputes
              ("guard input", (1, 1100, 1, 512), 3.0),
              # run_inference_svd --dtype fp32: UNet levels 0 and 1, the decode's mid block
              ("fp32 UNet level 0", (2, 9216, 5, 64), 1.0),
              ("fp32 UNet level 1", (4, 2304, 10, 64), 1.0),
              ("fp32 whole-clip decode mid block", (14, 9216, 1, 512), 1.0))
FP32_GN = (("encode level 0", (14, 262144, 128), ("silu",)),
           ("encode level 1", (14, 65536, 256), ("silu",)),
           ("encode level 2", (14, 16384, 512), ("silu",)),
           ("encode level 3 and mid block", (14, 4096, 512), (None, "silu")))
PRECOMPUTE = ("flash_bound_fp32", "flash_maxtrack_fp32", "flash_key_norm_fp32")
PRECOMPUTE_CLIP = (14, 512, 512)  # frames, height, width: the JAX CLI's defaults
METRICS_SET = (4, 16, 256)  # videos a side, frames, size


def _one_c_call(fn) -> int:
    """Calls into ``lkgd_flash_forward`` that ``fn()`` makes."""
    from lkgd_torch.ops import _build

    lib, calls = _build.library(), []

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def lkgd_flash_forward(self, *args):
            calls.append(1)
            return lib.lkgd_flash_forward(*args)

    real = _build.library
    _build.library = lambda: Spy()
    try:
        fn()
    finally:
        _build.library = real
    return len(calls)


def _sdpa_backend(q, k, v):
    """The backend that serves ``scaled_dot_product_attention`` on these (B, S, H, D)
    inputs by default (the one whose output alone is bit-identical to the default call's),
    and that output."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    default = F.scaled_dot_product_attention(qt, kt, vt)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt)
        except RuntimeError:
            continue
        if torch.equal(out, default):
            return backend.name, default.transpose(1, 2)
    return "unknown", default.transpose(1, 2)


def _fp32_flash_case(tag: str, label: str, shape, scale: float, gen: torch.Generator,
                     rows: dict) -> None:
    """One case of the fp32 form of kernels 1, 2 and 1a against the plain fp32 version (see
    3f), its rows appended to ``rows`` by kernel."""
    from lkgd_torch.ops import flash_attention as fa

    dev = gen.device
    b, s, h, d = shape
    q, k, v = (torch.randn(shape, device=dev, generator=gen) * (scale if i < 2 else 1.0)
               for i in range(3))
    want = in_row_chunks(fa.flash_attention_maxtrack_plain, (q, k, v), rows=1)
    ref_max = want.abs().max().item()
    # three TF32 products of 4 S^2 D operations a (batch, head); q, k, v read and o
    # written once, fp32; the fp32 FMA bound of the same products beside it
    least = bound(3 * 4 * b * h * s * s * d, 4 * 4 * b * h * s * d, PEAK_TF32)
    fma_ms = bound(4 * b * h * s * s * d, 4 * 4 * b * h * s * d, PEAK_FP32)["bound_ms"]
    lib_ms = sdpa_ms(q, k, v, reps=5)
    backend, lib_out = _sdpa_backend(q, k, v)
    lib_err = (lib_out - want).abs().max().item()
    del lib_out
    for kernel, plain, form in (("flash_bound_fp32", fa.flash_attention_bound_plain, "true>"),
                                ("flash_maxtrack_fp32", fa.flash_attention_maxtrack_plain,
                                 "false>")):
        if kernel == "flash_maxtrack_fp32":
            os.environ["LKGD_FLASH_MAXTRACK"] = "1"
        try:
            counter = fa.recomputed_tiles(dev)
            counter.zero_()
            before = dict(fa.launches)
            out = fa.flash_attention(q, k, v)
            again = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            recomputed = int(counter.item())
            delta = {n: fa.launches[n] - before[n] for n in fa.launches
                     if fa.launches[n] != before[n]}
            calls = _one_c_call(lambda: fa.flash_attention(q, k, v))
            device = _device_kernel_ms(lambda: fa.flash_attention(q, k, v))
            wrapper_ms = gpu_ms(lambda: fa.flash_attention(q, k, v), 20)
        finally:
            os.environ.pop("LKGD_FLASH_MAXTRACK", None)
        main_ms = sum(t for n, t in device.items()
                      if n.startswith("flash_fwd_tf32_kernel<") and n.endswith(form))
        split_ms = sum(t for n, t in device.items() if n.startswith("tf32_split_kernel<"))
        assert main_ms > 0.0 and split_ms > 0.0, device
        # the kernel's time: its main kernel and the pre-pass that feeds it
        t = {"ms": main_ms + split_ms, "main_ms": main_ms, "split_ms": split_ms,
             "call_device_ms": sum(device.values()), "wrapper_ms": wrapper_ms}
        err = (out - want).abs().max().item()
        plain_ms = gpu_ms(lambda: in_row_chunks(plain, (q, k, v), rows=1), reps=1)
        print(f"[{tag}] {kernel} {label} (B,S,H,D)={shape}: max|d| {err:.3e} of max|ref| "
              f"{ref_max:.3e} (tol {FP32_TOL} x max|ref|) | {_paced(t)}: main "
              f"{main_ms:.4f} + pre-pass {split_ms:.4f} ms | plain {plain_ms:.3f} ms (one row "
              f"at a time), library sdpa fp32 {lib_ms:.4f} ms ({backend}, max|d| "
              f"{lib_err:.3e}), bound {least['bound_ms']:.4f} ms by {least['bound_by']} at "
              f"495 TFLOP/s TF32 x3 ({_versus(t['ms'], lib_ms, least)}; fp32 FMA bound "
              f"{fma_ms:.4f} ms at 67 TFLOP/s: {100 * fma_ms / t['ms']:.1f}%) | tiles "
              f"recomputed {recomputed} | second launch bit-identical "
              f"{torch.equal(out, again)} | C calls a forward {calls} | launches of two "
              f"forwards {delta}", flush=True)
        assert out.dtype == torch.float32 and torch.equal(out, again) and calls == 1
        assert np.isfinite(err) and err <= FP32_TOL * ref_max, (kernel, label, err, ref_max)
        bound_form = kernel == "flash_bound_fp32"
        assert delta == {"flash_maxtrack_fp32": 2, **({"flash_bound_fp32": 2,
                         "flash_key_norm_fp32": 2} if bound_form else {})}, delta
        assert (recomputed > 0) == (scale > 1.0 and bound_form), recomputed
        row = {"shape": list(shape), "max_abs_err": err, **t, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library_backend": backend,
               "library_max_abs_err": lib_err, **least, "bound_fp32_fma_ms": fma_ms}
        rows.setdefault(kernel, []).append(row)
    rows.setdefault("flash_key_norm_fp32", []).append(_key_norm_row(tag, label, k))
    del q, k, v, want, out, again
    torch.cuda.empty_cache()


def phase_fp32_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """3f: the fp32 form of kernels 1, 2 and 1a (``csrc/flash_attention_f32.cu``: 3xTF32 on
    wgmma after its pre-pass) against the plain fp32 version (max |d| <= FP32_TOL *
    max|ref|, TF32 off) at the precompute encode's mid block (14, 4096, 1, 512), (1, 1024,
    1, 64), (2, 4096, 1, 512), an input that trips the guard and the fp32 inference path's
    (2, 9216, 5, 64), (4, 2304, 10, 64) and (14, 9216, 1, 512); a second launch
    bit-identical, one C call a forward; device time under the profiler (the form's kernel
    and the pre-pass) beside the wrapper's, the plain version's, the library's fp32 SDPA
    (its backend and its own max |d| against the plain version) and the bound: three TF32
    products at 495 TFLOP/s (the fp32 FMA bound at 67 TFLOP/s beside it). Returns the rows
    by kernel: the first shape's, the others under ``shapes``."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rows: dict = {}
    for label, shape, scale in FP32_FLASH:
        _fp32_flash_case("fp32-kernel", label, shape, scale, gen, rows)
    out = {name: {**found[0], "shapes": found[1:]} for name, found in rows.items()}
    # kernels 3/4 in fp32 at the precompute encoder's four levels (eps 1e-6; the mid
    # block's attention norm has no SiLU)
    gn_rows = [_gn_rows("fp32-kernel", label, shape, gen, 1e-6, acts, torch.float32)
               for label, shape, acts in FP32_GN]
    out["gn_fp32"] = {"gn_stats": [r["gn_stats"] for r in gn_rows],
                      "gn_apply": [a for r in gn_rows for a in r["gn_apply"]],
                      "gn_one_pass": [a for r in gn_rows for a in r["gn_one_pass"]]}
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------- fp32 training: kernels 7-10 at fp32
FP32_GRAD_TOL = 1e-4  # of each gradient's max|ref|: the fp32 backward against its plain version
FP32_TRAIN = (("fine-tune level 0", (14, 4096, 5, 64), None, 1.0),
              ("fine-tune level 1", (14, 1024, 10, 64), None, 1.0),
              ("ragged, S_q != S_k", (2, 1100, 5, 64), 1030, 1.0),
              # norms x4 at D=64: the bound sits ~150 log2 units above every row's largest
              # logit, and the guard recomputes the bound form's tiles
              ("guard input", (1, 1100, 2, 64), None, 4.0),
              # the narrow kernels' D=40 (zero-padded to 64), and D=128 on the wide kernels
              # (the other wide shapes follow the loop: WIDE_BWD_FP32)
              ("D=40, S_q != S_k", (1, 700, 3, 40), 900, 1.0),
              ("D=128", (1, 1024, 4, 128), None, 1.0))
TRAINING_FP32 = ("flash_bound_lse_fp32", "flash_maxtrack_lse_fp32", "flash_bwd_dq_fp32",
                 "flash_bwd_dkv_fp32")
PLAIN_FLASH = ("flash_attention_bound_plain", "flash_attention_maxtrack_plain",
               "flash_fwd_lse_bound_plain", "flash_fwd_lse_maxtrack_plain",
               "flash_bwd_dq_plain", "flash_bwd_dkv_plain")


def _fp32_train_case(label: str, shape, s_k, scale: float, gen: torch.Generator,
                     rows: dict) -> None:
    """Kernels 5/6, 7, 8, 9 and 10 in fp32 on one (B, S_q, H, D) input against their plain
    fp32 versions (see 3i), their rows appended to ``rows`` by kernel."""
    import torch.nn.functional as F

    from lkgd_torch.ops import flash_attention as fa

    tag, dev = "fp32-train-kernel", gen.device
    b, s_q, h, d = shape
    s_k = s_k or s_q
    q = torch.randn(shape, device=dev, generator=gen) * scale
    k = torch.randn((b, s_k, h, d), device=dev, generator=gen) * scale
    v = torch.randn((b, s_k, h, d), device=dev, generator=gen)
    do = torch.randn(shape, device=dev, generator=gen)
    keys = "" if s_k == s_q else f" x {s_k} keys"
    if s_k == s_q:  # kernels 5/6 on 4-byte rows: 256 bytes a row at D=64, bit-exact
        split = fa.split_heads_many(q, k, v)
        merged = fa.merge_heads_many(*split)
        assert all(torch.equal(a, w) for a, w in zip(split, fa.split_heads_many_plain(q, k, v)))
        assert all(torch.equal(a, w) for a, w in zip(merged, (q, k, v)))
        # their times: three tensors read and written once a call
        least = bound(0, 2 * 3 * q.numel() * 4)
        lib_ms = gpu_ms(lambda: tuple(x.transpose(1, 2).contiguous() for x in (q, k, v)), 20)
        for name, fn, plain in (
                ("split_heads", lambda: fa.split_heads_many(q, k, v),
                 lambda: fa.split_heads_many_plain(q, k, v)),
                ("merge_heads", lambda: fa.merge_heads_many(*split),
                 lambda: fa.merge_heads_many_plain(*split))):
            t = _timed_kernel(fn, "relayout_heads_kernel")
            print(f"[{tag}] {name} fp32 rows {label} 3 x (B,S,H,D)={shape}: {_paced(t)}, plain "
                  f"{gpu_ms(plain, 20):.4f} ms, library transpose().contiguous() x3 "
                  f"{lib_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by {least['bound_by']}",
                  flush=True)
        del split, merged
    # the library: fp32 SDPA forward, and its backward through autograd (dq, dk, dv)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        lib_fwd_ms = gpu_ms(lambda: F.scaled_dot_product_attention(*leaves), 5)
    lib_out = F.scaled_dot_product_attention(*leaves)
    lib_bwd_ms = gpu_ms(lambda: torch.autograd.grad(lib_out, leaves, do.transpose(1, 2),
                                                    retain_graph=True), 5)
    del lib_out, leaves
    products = b * h * s_q * s_k * d

    def bounds(n_products: int, q_side: int, k_side: int) -> tuple:
        """(three TF32 products at 495 TFLOP/s, the fp32 FMA bound at 67 TFLOP/s): fp32
        tensors on the query and key sides read or written once, lse and delta rows."""
        nbytes = 4 * (q_side * b * s_q * h * d + k_side * b * s_k * h * d + 2 * b * h * s_q)
        ops = 2 * n_products * products
        return bound(3 * ops, nbytes, PEAK_TF32), bound(ops, nbytes, PEAK_FP32)["bound_ms"]

    least, fma_ms = bounds(2, 2, 2)
    for kernel, plain, form in (("flash_bound_lse_fp32", fa.flash_fwd_lse_bound_plain, "true>"),
                                ("flash_maxtrack_lse_fp32", fa.flash_fwd_lse_maxtrack_plain,
                                 "false>")):
        bound_form = kernel == "flash_bound_lse_fp32"
        if not bound_form:
            os.environ["LKGD_FLASH_MAXTRACK"] = "1"
        try:
            counter = fa.recomputed_tiles(dev)
            counter.zero_()
            before = dict(fa.launches)
            out, lse = fa.flash_fwd_lse(q, k, v)
            out2, lse2 = fa.flash_fwd_lse(q, k, v)
            torch.cuda.synchronize()
            recomputed = int(counter.item())
            delta = {n: fa.launches[n] - before[n] for n in fa.launches
                     if fa.launches[n] != before[n]}
            device = _device_kernel_ms(lambda: fa.flash_fwd_lse(q, k, v))
            wrapper_ms = gpu_ms(lambda: fa.flash_fwd_lse(q, k, v), 20)
        finally:
            os.environ.pop("LKGD_FLASH_MAXTRACK", None)
        main_ms = sum(t for n, t in device.items()
                      if n.startswith("flash_fwd_tf32_kernel<") and n.endswith(form))
        split_ms = sum(t for n, t in device.items() if n.startswith("tf32_split_kernel<"))
        assert main_ms > 0.0 and split_ms > 0.0, device
        t = {"ms": main_ms + split_ms, "main_ms": main_ms, "split_ms": split_ms,
             "call_device_ms": sum(device.values()), "wrapper_ms": wrapper_ms}
        want_out, want_lse = in_row_chunks(plain, (q, k, v), rows=2)
        plain_ms = gpu_ms(lambda: in_row_chunks(plain, (q, k, v), rows=2), reps=1)
        ref_max, lse_max = want_out.abs().max().item(), want_lse.abs().max().item()
        err = (out - want_out).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        lse_tol = FP32_TOL * max(1.0, lse_max)
        print(f"[{tag}] {kernel} {label} (B,S,H,D)={shape}{keys}: out max|d| {err:.3e} of "
              f"max|ref| {ref_max:.3e} (tol {FP32_TOL} x max|ref|), lse max|d| {lse_err:.3e} "
              f"of max|lse| {lse_max:.3e} (tol {lse_tol:.2e}) | {_paced(t)}: main "
              f"{main_ms:.4f} + pre-pass {split_ms:.4f} ms | plain {plain_ms:.3f} ms (two rows "
              f"at a time), library sdpa fp32 forward {lib_fwd_ms:.4f} ms, bound "
              f"{least['bound_ms']:.4f} ms by {least['bound_by']} at 495 TFLOP/s TF32 x3 "
              f"({_versus(t['ms'], lib_fwd_ms, least)}; fp32 FMA bound {fma_ms:.4f} ms at 67 "
              f"TFLOP/s: {100 * fma_ms / t['ms']:.1f}%) | tiles recomputed {recomputed} | "
              f"second launch bit-identical | launches of two forwards {delta}", flush=True)
        assert out.dtype == lse.dtype == torch.float32
        assert torch.equal(out, out2) and torch.equal(lse, lse2), (kernel, label)
        assert np.isfinite(err) and err <= FP32_TOL * ref_max, (kernel, label, err, ref_max)
        assert np.isfinite(lse_err) and lse_err <= lse_tol, (kernel, label, lse_err)
        assert delta == {"flash_maxtrack_lse_fp32": 2, **({"flash_bound_lse_fp32": 2,
                         "flash_key_norm_fp32": 2} if bound_form else {})}, delta
        assert (recomputed > 0) == (scale > 1.0 and bound_form), recomputed
        rows.setdefault(kernel, []).append(
            {"shape": list(shape), "keys": s_k, "max_abs_err": err, "lse_max_abs_err": lse_err,
             **t, "plain_ms": plain_ms, "library_ms": lib_fwd_ms, **least,
             "bound_fp32_fma_ms": fma_ms})
        del out, out2, lse, lse2, want_out, want_lse

    # the backward from the guarded forward's out and lse, as the autograd Function: kernels 9
    # and 10 each alone (its own pre-pass), then the pair from one C call (one pre-pass)
    out, lse = fa.flash_fwd_lse(q, k, v)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    wide = fa.flash_bwd_plan(b, s_q, s_k, h, d, False, fp32=True).kernel.endswith("_wide")

    def main_kernel(name: str, dkv: bool) -> bool:  # the profiler's name of kernel 9 or 10
        if wide:
            return (name.startswith("flash_bwd_tf32_wide_kernel<")
                    and name.endswith("true>" if dkv else "false>"))
        return name.startswith("flash_bwd_dkv_tf32_kernel" if dkv else "flash_bwd_dq_tf32_kernel")

    pair = fa.flash_bwd(*args)
    least_pair = 0.0
    for kernel, fn, plain, names in (
            ("flash_bwd_dq_fp32", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
            ("flash_bwd_dkv_fp32", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv"))):
        dkv = kernel == "flash_bwd_dkv_fp32"
        got, again = fn(*args), fn(*args)
        want = in_row_chunks(plain, args, rows=2)
        got, again, want = (got, again, want) if dkv else ((got,), (again,), (want,))
        errs = {}
        for name, g, g2, w, g3 in zip(names, got, again, want, pair[1:] if dkv else pair):
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), (kernel, label, name)
            assert torch.equal(g, g2), f"{kernel} {label}: {name} differs between launches"
            assert torch.equal(g, g3), f"{kernel} {label}: {name} differs in the one-call pair"
            errs[name] = ((g - w).abs().max().item(), w.abs().max().item())
        del got, again, want
        device = _device_kernel_ms(lambda: fn(*args))
        main_ms = sum(t for n, t in device.items() if main_kernel(n, dkv))
        split_ms = sum(t for n, t in device.items() if n.startswith("bwd_split_kernel"))
        assert main_ms > 0.0 and split_ms > 0.0, device
        t = {"ms": main_ms + split_ms, "main_ms": main_ms, "split_ms": split_ms,
             "call_device_ms": sum(device.values()), "wrapper_ms": gpu_ms(lambda: fn(*args), 20)}
        plain_ms = gpu_ms(lambda: in_row_chunks(plain, args, rows=2), reps=1)
        plan = fa.flash_bwd_plan(b, s_q, s_k, h, d, dkv, fp32=True)
        # dq: 3 products, q, dO and dq, k and v; dk/dv: 4 products, q and dO, k, v, dk, dv
        least, fma_ms = bounds(4 if dkv else 3, 2 if dkv else 3, 4 if dkv else 2)
        least_pair += least["bound_ms"]
        print(f"[{tag}] {kernel} ({plan.kernel}) {label} (B,S,H,D)={shape}{keys}: " + ", ".join(
            f"{n} max|d| {e:.3e} of max|ref| {m:.3e} (tol {FP32_GRAD_TOL} x max|ref|)"
            for n, (e, m) in errs.items()) + f", two launches and the one-call pair "
              f"bit-identical | {_paced(t)}: main {main_ms:.4f} + pre-pass {split_ms:.4f} ms | "
              f"plain {plain_ms:.3f} ms (two rows at a time), library sdpa fp32 backward (dq, "
              f"dk and dv together) {lib_bwd_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
              f"{least['bound_by']} at 495 TFLOP/s TF32 x3 "
              f"({100 * least['bound_ms'] / t['ms']:.1f}% of it), fp32 FMA bound {fma_ms:.4f} "
              f"ms at 67 TFLOP/s | plan {plan.blocks} blocks, {plan.waves:.2f} waves, {plan.tile_rows} "
              f"resident rows, {plan.stages} ring units", flush=True)
        for name, (e, m) in errs.items():
            assert e <= FP32_GRAD_TOL * m, (kernel, label, name, e, m)
        rows.setdefault(kernel, []).append(
            {"shape": list(shape), "keys": s_k, "max_abs_err": max(e for e, _ in errs.values()),
             **t, "plain_ms": plain_ms, "library_ms": lib_bwd_ms, **least,
             "bound_fp32_fma_ms": fma_ms})
    del pair
    pair_device = _device_kernel_ms(lambda: fa.flash_bwd(*args))
    pair_ms = sum(pair_device.values())
    for kernel in ("flash_bwd_dq_fp32", "flash_bwd_dkv_fp32"):
        rows[kernel][-1]["pair_ms"] = pair_ms
    print(f"[{tag}] fp32 backward pair {label}: kernels 9 + 10 from one C call {pair_ms:.4f} "
          f"ms on the device (" + ", ".join(f"{n} {ms:.4f}" for n, ms in pair_device.items())
          + f") = {pair_ms / lib_bwd_ms:.2f} x the library's fp32 backward ({lib_bwd_ms:.4f} "
          f"ms), {100 * least_pair / pair_ms:.1f}% of its {least_pair:.4f} ms bound at 495 "
          f"TFLOP/s TF32 x3", flush=True)
    del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()


def phase_fp32_train_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """3i: kernels 7, 8, 9 and 10 in fp32 (``csrc/flash_attention_f32.cu``'s LSE form,
    ``csrc/flash_attention_bwd_f32.cu``) against their plain fp32 versions (TF32 off) at the
    fp32 LKGD fine-tune's level 0 (14, 4096, 5, 64) and level 1 (14, 1024, 10, 64), a ragged
    call with S_q != S_k, an input that trips the bound form's guard, D=40 and D=128: out
    within FP32_TOL x max|ref| and lse within FP32_TOL x max(1, max|lse|), dq, dk, dv within
    FP32_GRAD_TOL x each one's max|ref|, a second launch and the one-call pair bit-identical,
    kernels 5/6 on fp32 rows bit-exact; device time under the profiler beside the wrapper's
    (a backward kernel's with its pre-pass; the pair's from one call under ``pair_ms``), the
    plain version's, the library's fp32 SDPA forward or backward, and the bound of three TF32
    products at 495 TFLOP/s with the fp32 FMA bound at 67 TFLOP/s beside it. Then the wide
    backward kernels alone at WIDE_BWD_FP32 (``_wide_bwd_case``). Returns the rows by kernel:
    the first shape's, the others under ``shapes``."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rows: dict = {}
    for label, shape, s_k, scale in FP32_TRAIN:
        _fp32_train_case(label, shape, s_k, scale, gen, rows)
    for label, shape, s_k, scale in WIDE_BWD_FP32:
        _wide_bwd_case(label, shape, s_k, scale, gen, rows, fp32=True)
    return {name: {**found[0], "shapes": found[1:]} for name, found in rows.items()}


def _tiny_precompute(device):
    from lkgd_torch.cli import precompute_cache as pc

    _, vae, clip = _tiny_widths()
    widths = pc.Widths(vae=vae, clip=clip)
    args = pc.make_parser().parse_args(["--video-folder", ".", "--output", "x", "--device",
                                        str(device)])
    return pc, pc.build(args, widths)


def phase_tiny_fp32(dev: torch.device) -> None:
    """4h: at fp32, once on the card and once on the CPU (rtol 1e-4, atol 2e-4, TF32 off):
    the precompute encode at tiny VAE and CLIP widths on 64 x 64 frames (the VAE's mid block
    at 1024 tokens: the fp32 flash form), InceptionV3 at 299 on 2 images, I3D on a (1, 10,
    64, 64, 3) clip, the CLIP features, and the Frechet distance of each device's
    features."""
    from lkgd_torch.eval import fid_inception, i3d
    from lkgd_torch.eval import metrics as M

    cpu = torch.device("cpu")
    pc, enc_cpu = _tiny_precompute(cpu)
    _, enc_gpu = _tiny_precompute(dev)
    enc_gpu.vae.load_state_dict(enc_cpu.vae.state_dict())
    enc_gpu.clip.load_state_dict(enc_cpu.clip.state_dict())
    g = torch.Generator().manual_seed(5)
    frames = torch.rand((4, 64, 64, 3), generator=g).numpy()
    _zero_counts()
    got = pc.encode_clip(enc_gpu, frames)
    counts = _read_counts()
    want = pc.encode_clip(enc_cpu, frames)
    for name in want:
        _close_line("tiny-fp32", f"precompute {name}", got[name], want[name])
    assert counts["flash_bound_fp32"] == 1 and _gn_forwards(counts) > 0, counts

    net_cpu = fid_inception.build_inception(cpu, torch.Generator().manual_seed(6))
    net_gpu = fid_inception.build_inception(dev)
    net_gpu.load_state_dict(net_cpu.state_dict())
    images = torch.rand((2, 299, 299, 3), generator=g)
    want = net_cpu(images)
    scale = want.abs().max()
    _close_line("tiny-fp32", "InceptionV3 features / max|ref|", net_gpu(images.to(dev)) / scale,
                want / scale)
    net_cpu = i3d.build_i3d(cpu, torch.Generator().manual_seed(7))
    net_gpu = i3d.build_i3d(dev)
    net_gpu.load_state_dict(net_cpu.state_dict())
    clip = torch.rand((1, 10, 64, 64, 3), generator=g)
    _close_line("tiny-fp32", "I3D logits", net_gpu(clip.to(dev)), net_cpu(clip))

    extract_cpu = M.make_clip_feature_extractor(enc_cpu.clip)
    extract_gpu = M.make_clip_feature_extractor(enc_gpu.clip)
    sets = [torch.rand((12, 48, 40, 3), generator=g) for _ in range(2)]
    feats = {}
    for name, extract, device in (("gpu", extract_gpu, dev), ("cpu", extract_cpu, cpu)):
        feats[name] = [extract(x.to(device)).cpu() for x in sets]
    for a, b in zip(feats["gpu"], feats["cpu"]):
        _close_line("tiny-fp32", "CLIP features", a, b)
    fd = {name: M.fid_from_features(*f) for name, f in feats.items()}
    print(f"[tiny-fp32] Frechet distance of the CLIP features: card's {fd['gpu']:.9g}, CPU's "
          f"{fd['cpu']:.9g} (rel 1e-4)", flush=True)
    assert abs(fd["gpu"] - fd["cpu"]) <= 1e-4 * abs(fd["cpu"]) + 1e-6


def _write_clips(folder: Path, clips) -> None:
    """Synthetic mp4 clips of moving colour ramps, ``clips`` (name, frames, h, w) tuples."""
    from lkgd_torch.data.video_io import write_mp4

    folder.mkdir(parents=True, exist_ok=True)
    for name, n, h, w in clips:
        yy, xx = np.mgrid[:h, :w]
        write_mp4(folder / f"{name}.mp4", np.stack(
            [np.stack([(xx + 8 * t) % 256, (yy + 4 * t) % 256, (xx + yy + 16 * t) % 256], -1)
             for t in range(n)]).astype(np.uint8))


def phase_precompute_full(dev: torch.device, smi: str) -> dict:
    """8i: ``lkgd_torch.cli.precompute_cache`` at the published widths in fp32 on three
    synthetic 14-frame 512 x 512 mp4 clips and one too short (skipped): the cache's keys and
    shapes, read back through ``PrecomputedLatentDataset`` and ``train_cogvideox_lora``'s
    cache adapter, the launches a clip asserted (the fp32 flash forward once: kernels 1, 2
    as its guard and 1a at fp32; kernels 3/4 once a GroupNorm of the encoder); then s/clip
    split into the VAE and CLIP between CUDA events, the peak and one clip under the
    profiler. Returns the path's launches."""
    import tempfile

    from lkgd_torch.cli import precompute_cache as pc
    from lkgd_torch.cli.train_cogvideox_lora import _Adapted
    from lkgd_torch.data.tensor_cache import PrecomputedLatentDataset, TensorCache
    from lkgd_torch.models.layers import GroupNorm

    t, h, w = PRECOMPUTE_CLIP
    work = Path(tempfile.mkdtemp(prefix="lkgd_precompute_"))
    _write_clips(work / "clips", [(f"clip{i}", t + 2 * i, h, w) for i in range(3)]
                 + [("short", t - 4, h, w)])
    cache_path = str(work / "cache.lkgd")
    argv = ["--video-folder", str(work / "clips"), "--output", cache_path, "--height", str(h),
            "--width", str(w), "--num-frames", str(t), "--seed", "3"]
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    pc.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    enc = pc.build(pc.make_parser().parse_args(argv), pc.Widths())
    n_gn = sum(isinstance(m, GroupNorm) for m in enc.vae.encoder.modules())
    per_clip = {name: 3 * n for name, n in (("flash_bound_fp32", 1), ("flash_maxtrack_fp32", 1),
                                           ("flash_key_norm_fp32", 1), ("gn_forwards", n_gn))}
    print(f"[precompute] {smi} | main() on 3 clips of {t}x{h}x{w} and one of {t - 4} frames: "
          f"{wall:.2f} s with the build and the mp4 decode, peak {peak:.2f} GiB | launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    assert _by_forwards(counts) == per_clip, (counts, per_clip)

    cache = TensorCache(cache_path)
    names = sorted({k.split("/")[0] for k in cache.keys()})
    assert names == ["clip0", "clip1", "clip2"], names
    for name in names:
        shapes = {f: tuple(cache.get(f"{name}/{f}").shape)
                  for f in ("latents", "cond_latents", "image_embeddings")}
        assert shapes == {"latents": (t, h // 8, w // 8, 4), "cond_latents": (h // 8, w // 8, 4),
                          "image_embeddings": (1, 1, 1024)}, shapes
        assert all(torch.isfinite(cache.get(f"{name}/{f}")).all() for f in shapes)
    cache.close()
    data = PrecomputedLatentDataset(cache_path)
    sample = _Adapted(data, 4096)[0]
    assert len(data) == 3 and sample["prompt_embeds"].shape == (8, 4096)
    assert sample["image_latents"].shape == (h // 8, w // 8, 4)
    print(f"[precompute] cache read back: {len(data)} samples through "
          f"PrecomputedLatentDataset, the CogVideoX adapter gives "
          f"{ {k: tuple(v.shape) for k, v in sample.items()} }", flush=True)

    from lkgd_torch.data.video_io import process_frames, read_video_frames

    frames, _ = read_video_frames(str(work / "clips" / "clip0.mp4"), max_frames=t)
    frames = process_frames(frames, h, w)
    pixels = torch.from_numpy(frames).to(dev) * 2 - 1
    torch.cuda.reset_peak_memory_stats(dev)
    pc.encode_clip(enc, frames)
    torch.cuda.synchronize()
    parts = {}
    for part, fn in (("vae", lambda: pc.encode_latents(enc, pixels)),
                     ("clip", lambda: pc.encode_image(enc, pixels))):
        parts[part] = gpu_ms(fn, reps=3) / 1e3
    timing = TensorCache(str(work / "timing.lkgd"))
    t0 = time.perf_counter()
    for i in range(3):
        pc.write_clip(timing, f"x{i}", pc.encode_clip(enc, frames))
    per_clip_s = (time.perf_counter() - t0) / 3
    timing.close()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[precompute] {smi} | s/clip {per_clip_s:.4f} (encode and cache write, host clock) "
          f"= VAE encode {parts['vae']:.4f} s + CLIP-H {parts['clip']:.4f} s (CUDA events) + "
          f"the rest | peak {peak:.2f} GiB | {n_gn} GroupNorms in the encoder", flush=True)
    _profiled("precompute", f"one clip's encode_clip ({t}x{h}x{w})",
              lambda: pc.encode_clip(enc, frames))
    del enc, pixels
    torch.cuda.empty_cache()
    return counts


def _metrics_media(folder: Path, seed: int, kind: str) -> str:
    """METRICS_SET videos of moving sinusoids, as mp4 (OpenCV) or GIF (PIL, as the card's
    machine writes and reads them)."""
    from lkgd_torch.data.video_io import write_mp4, write_video

    n, t, size = METRICS_SET
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    for i in range(n):
        phase = rng.random(3)
        frames = np.stack([np.stack([np.sin(6 * xx + j / 3 + phase[0]), np.cos(5 * yy + j / 4
                           + phase[1]), np.sin(4 * (xx + yy) + phase[2] + j / 5)], -1)
                           for j in range(t)]) * 0.5 + 0.5
        if kind == "mp4":
            write_mp4(folder / f"v{i}.mp4", (frames * 255).astype(np.uint8))
        else:
            write_video(str(folder / f"v{i}.gif"), frames.astype(np.float32))
    return str(folder)


def phase_metrics_full(dev: torch.device, smi: str) -> dict:
    """8j: ``lkgd_torch.cli.compute_metrics`` at the published widths (CLIP-H, InceptionV3,
    I3D) on a generated set of 4 mp4s and a reference set of 4 GIFs of 16 frames at 256 x
    256 (the two decoders the card's machine has: OpenCV and PIL), with
    ``--inception-weights`` (.pth) and ``--i3d-weights`` (.safetensors) written from
    ``init_synthetic``: every key present and finite, seconds by stage (CLIP-H features,
    InceptionV3 images/s at 299, I3D clips/s at 16 x 224 x 224, the Frechet fits on the
    host). Returns the path's launches (none of the port's kernels: convolutions are
    cuDNN's, CLIP-H's 257 tokens plain attention)."""
    import tempfile

    from lkgd_torch.cli import compute_metrics as cm
    from lkgd_torch.eval import fid_inception, i3d
    from lkgd_torch.utils.porting import save_safetensors

    work = Path(tempfile.mkdtemp(prefix="lkgd_metrics_"))
    gen, ref = _metrics_media(work / "gen", 1, "mp4"), _metrics_media(work / "ref", 2, "gif")
    torch.save(_synthetic_state(fid_inception.InceptionV3(), 1), work / "inception.pth")
    save_safetensors({k: v.numpy() for k, v in _synthetic_state(i3d.InceptionI3d(), 2).items()},
                     str(work / "i3d.safetensors"))
    stages: dict = {}

    def timed(stage_of, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stage = stage_of(*args)
            stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return run

    real = {"video_features": cm.video_features, "i3d_features": cm.i3d_features,
            "fid": cm.M.fid_from_features, "fvd": cm.M.fvd_from_features}
    cm.video_features = timed(lambda extract, *a: "inception" if isinstance(
        extract, fid_inception.InceptionV3) else "clip", real["video_features"])
    cm.i3d_features = timed(lambda *a: "i3d", real["i3d_features"])
    cm.M.fid_from_features = timed(lambda *a: "frechet", real["fid"])
    cm.M.fvd_from_features = timed(lambda *a: "frechet", real["fvd"])
    _zero_counts()
    t0 = time.perf_counter()
    try:
        results = cm.main(["--generated", gen, "--reference", ref, "--inception-weights",
                           str(work / "inception.pth"), "--i3d-weights",
                           str(work / "i3d.safetensors"), "--output", str(work / "m.json")])
    finally:
        cm.video_features, cm.i3d_features = real["video_features"], real["i3d_features"]
        cm.M.fid_from_features, cm.M.fvd_from_features = real["fid"], real["fvd"]
    wall = time.perf_counter() - t0
    counts = _read_counts()
    n, frames, size = METRICS_SET
    keys = ["psnr", "ssim", "clip_fid", "clip_fvd", "fid", "fvd"]
    assert sorted(results) == sorted(keys) and all(np.isfinite(results[k]) for k in keys), results
    images = 2 * n * frames
    print(f"[metrics] {smi} | compute_metrics on 2 x {n} videos of {frames}x{size}x{size}: "
          f"{wall:.2f} s | CLIP-H features {stages['clip']:.3f} s ({images / stages['clip']:.1f} "
          f"images/s at 224) | InceptionV3 {stages['inception']:.3f} s "
          f"({images / stages['inception']:.1f} images/s at 299) | I3D {stages['i3d']:.3f} s "
          f"({2 * n / stages['i3d']:.2f} clips/s at {frames}x224x224) | Frechet fits on the host "
          f"{stages['frechet']:.3f} s | {json.dumps(results)}", flush=True)
    return counts


def _synthetic_state(net, seed: int) -> dict:
    """The state dict of ``net`` after ``init_synthetic`` from ``seed`` (a file to write)."""
    net.init_synthetic(torch.Generator().manual_seed(seed))
    return net.state_dict()



# ---------------------------------------------------------------- pseudo-labels
# Depth-Anything's DINOv2 at 518 x 518: 37^2 + 1 tokens, 6 (small) or 12 (base) heads of 64
ANNOTATE_FLASH = (("Depth-Anything small 518^2", (1, 1370, 6, 64), 1.0),
                  ("Depth-Anything base 518^2", (1, 1370, 12, 64), 1.0))


def _bit_gn_shapes(h: int, w: int) -> list:
    """The (1, M, C) GroupNorm inputs of DPT-hybrid's BiT backbone on an h x w input (TF
    "SAME" strides round up): the stem's at /2, then each stage's bottleneck widths (the
    first block's first norm at the stage's input resolution)."""
    def at(k):
        return -(-h // k) * -(-w // k)

    shapes = [(1, at(2), 64), (1, at(4), 64), (1, at(4), 256)]
    for k, mid in ((8, 128), (16, 256)):
        shapes += [(1, at(k // 2), mid), (1, at(k), mid), (1, at(k), 4 * mid)]
    return shapes


ANNOTATE_GN = (("384x384", [_bit_gn_shapes(384, 384)[i] for i in (1, 5, 8)]),  # /4 to /16
               ("384x672", _bit_gn_shapes(384, 672)))  # a 576 x 1024 frame's: every one
ANNOTATE_CLIP = (14, 576, 1024)  # frames, height, width of the synthetic video


def phase_annotate_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """3g: the fp32 form of kernels 1, 2 and 1a at Depth-Anything's (1, 1370, 6, 64) and
    (1, 1370, 12, 64) as 3f holds it (ragged against the tiles: 10 full tiles of 128 rows
    and 90 rows), and kernels 3 and 4 in fp32, eps 1e-5, without SiLU, at the GroupNorm
    shapes of DPT-hybrid's BiT backbone (three at 384 x 384, all nine of a 576 x 1024
    frame's 384 x 672) as phase 3 holds them; each with the device time under the profiler
    beside the wrapper's, the plain version's, the library call's (fp32 SDPA,
    ``F.group_norm``) and the bound. Returns the rows by kernel."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rows: dict = {}
    for label, shape, scale in ANNOTATE_FLASH:
        _fp32_flash_case("annotate-kernel", label, shape, scale, gen, rows)
    for size, shapes in ANNOTATE_GN:
        for shape in shapes:
            r = _gn_rows("annotate-kernel", f"BiT at {size}", shape, gen, 1e-5, (None,),
                         torch.float32)
            rows.setdefault("gn_stats", []).append(r["gn_stats"])
            rows.setdefault("gn_apply", []).extend(r["gn_apply"])
            rows.setdefault("gn_one_pass", []).extend(r["gn_one_pass"])
    torch.cuda.empty_cache()
    return rows


# the last bias of each depth head, before its final ReLU: ``init_params`` zeroes every bias,
# and a positive one keeps the ReLU from zeroing the whole depth map
LAST_BIAS = {"hybrid": "scratch.output_conv.4.bias", "large": "head.head.4.bias",
             "depth_anything": "head.conv3.bias"}


def _tiny_twins(build, dev: torch.device, seed: int, last_bias: str = ""):
    """A model built on the CPU, random from ``seed`` (``last_bias``, where named, 0.5), and
    its copy on the card."""
    cpu = build("cpu", torch.Generator().manual_seed(seed))
    if last_bias:
        cpu.state_dict()[last_bias].fill_(0.5)
    gpu = build(dev, None)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def phase_tiny_annotate(dev: torch.device) -> None:
    """4i: the pseudo-label models at fp32 on the card against the CPU with the same random
    weights (rtol 1e-4, atol 2e-4): the tiny RAFT's flow, the point tracker on it (tracks,
    and visibility equal), a narrow RIFE (c=16) midpoint and 2x video, tiny DPT-hybrid on a
    non-square grid and DPT-large, and a tiny-width Depth-Anything at 462 x 462, whose 1090
    tokens run the fp32 flash form on the card (4 layers: 4 launches of kernels 1, 2 and 1a)
    and its plain version on the CPU; depths compared over their largest value, which must
    pass 1e-3 (each head's last bias 0.5: ``init_params`` zeroes it, and the final ReLU of
    a zero bias may zero the whole map)."""
    from lkgd_torch.models import depth_anything as da
    from lkgd_torch.models import midas, raft, rife
    from lkgd_torch.utils import point_tracker as pt

    label = "tiny-annotate"
    g = torch.Generator().manual_seed(30)
    cpu, gpu = _tiny_twins(lambda d, gen: raft.build_raft(raft.RAFTConfig.tiny(), d, gen),
                           dev, 31)
    base = torch.rand((40, 56, 3), generator=g)
    frames = torch.stack([base[i:i + 32, 2 * i:2 * i + 48] for i in range(4)])
    with torch.no_grad():
        want = cpu(frames[:2] * 2 - 1, frames[1:3] * 2 - 1)
        _close_line(label, "RAFT flow", gpu(frames[:2].to(dev) * 2 - 1,
                                            frames[1:3].to(dev) * 2 - 1), want)
    queries = torch.from_numpy(pt.grid_queries(32, 48, 4))
    want_t, want_v = pt.make_track_fn(cpu)(frames, queries)
    got_t, got_v = pt.make_track_fn(gpu)(frames.to(dev), queries.to(dev))
    _close_line(label, "tracks", got_t, want_t)
    assert torch.equal(got_v.cpu(), want_v), "visibility differs"

    cpu, gpu = _tiny_twins(lambda d, gen: rife.build_rife(rife.RIFEConfig(c=16), d, gen),
                           dev, 32)
    clip = torch.rand((3, 32, 64, 3), generator=g)
    with torch.no_grad():
        _close_line(label, "RIFE midpoint", gpu(clip[:2].to(dev), clip[1:].to(dev)),
                    cpu(clip[:2], clip[1:]))
    _close_line(label, "RIFE 2x video", rife.interpolate_video(gpu, clip.to(dev)),
                rife.interpolate_video(cpu, clip))

    for kind, cfg, hw in (("hybrid", midas.MidasConfig.tiny(), (64, 96)),
                          ("large", midas.MidasConfig.tiny_large(), (64, 64))):
        cpu, gpu = _tiny_twins(lambda d, gen: midas.build_dpt(kind, cfg, d, gen), dev, 33,
                               LAST_BIAS[kind])
        x = torch.rand((2, *hw, 3), generator=g) * 2 - 1
        with torch.no_grad():
            want = cpu(x)
            scale = want.abs().max()
            assert scale > 1e-3, f"DPT-{kind}: an all-zero reference proves nothing"
            _close_line(label, f"DPT-{kind} depth / max|ref| (max|ref| {scale:.4g})",
                        gpu(x.to(dev)) / scale.to(dev), want / scale)

    cfg = da.DepthAnythingConfig(image_size=462, patch_size=14, hidden_size=32, depth=4,
                                 num_heads=2, out_indices=(0, 1, 2, 3),
                                 neck_hidden_sizes=(8, 8, 16, 16), fusion_hidden_size=16,
                                 head_hidden_size=8)
    cpu, gpu = _tiny_twins(lambda d, gen: da.build_depth_anything(cfg, d, gen), dev, 34,
                           LAST_BIAS["depth_anything"])
    x = torch.randn((1, 462, 462, 3), generator=g)
    with torch.no_grad():
        want = cpu(x)
        _zero_counts()
        got = gpu(x.to(dev))
        counts = _read_counts()
    scale = want.abs().max()
    assert scale > 1e-3, "Depth-Anything: an all-zero reference proves nothing"
    _close_line(label, f"Depth-Anything at 1090 tokens, depth / max|ref| (max|ref| "
                f"{scale:.4g})", got / scale.to(dev), want / scale)
    launched = {k: v for k, v in counts.items() if v}
    print(f"[{label}] Depth-Anything's launches on the card: {launched}", flush=True)
    assert launched == dict.fromkeys(PRECOMPUTE, 4), launched


class _CudnnTF32On:
    """``with _CudnnTF32On():`` cuDNN's convolutions in TF32, PyTorch's default."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.saved


def _random_raft_file(path: str, seed: int) -> None:
    """torchvision ``raft_large``'s state dict, every key and shape of the checked-in
    manifest, random from ``seed``: convolutions normal / sqrt(fan-in), norm scales
    1 + 0.1 x normal, running variances uniform in [0.5, 1.5], the rest 0.1 x normal."""
    from lkgd_torch.utils import checkpoint_manifest as cm

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, zero in cm.synthetic_state_dict(cm.load_manifest("raft_large")).items():
        x = torch.randn(zero.shape, generator=g)
        if zero.dim() == 4:
            x = x / zero[0].numel() ** 0.5
        elif key.endswith("running_var"):
            x = 1.0 + torch.rand(zero.shape, generator=g) - 0.5
        elif key.endswith(".weight"):  # a norm's scale
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        sd[key] = x
    torch.save(sd, path)


def _random_model_file(model: torch.nn.Module, path: str) -> None:
    """The state dict of a model random from its ``init_params`` (the published names)."""
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def _annotate_clip(t: int = ANNOTATE_CLIP[0]) -> np.ndarray:
    """The synthetic ``ANNOTATE_CLIP`` (``t`` frames), (T, H, W, 3) float32 in [0, 1]: moving
    colour ramps with a seeded random texture."""
    h, w = ANNOTATE_CLIP[1:]
    g = torch.Generator().manual_seed(40)
    texture = torch.rand((h + 4 * t, w + 8 * t, 3), generator=g)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return np.stack([(0.5 * texture[2 * i:2 * i + h, 4 * i:4 * i + w] + 0.5 * torch.stack(
        [(xx + 8 * i) % 256, (yy + 4 * i) % 256, (xx + yy + 16 * i) % 256], -1) / 255).numpy()
        for i in range(t)]).astype(np.float32)


def _tf32_against_fp32(fn) -> str:
    """``fn()``, one frame's (pair's) labels, with cuDNN's convolutions in TF32 (PyTorch's
    default) against the CLI's fp32: for label images the largest difference and the share
    of values more than half a level of the 8-bit label (1/510) apart; for tracks the
    largest distance of a point and the visibility flags that differ."""
    want = fn()
    with _CudnnTF32On():
        got = fn()
    if isinstance(got, tuple):  # tracks, visibility
        return (f"tracks {np.abs(got[0] - want[0]).max():.3e} px apart at most, visibility "
                f"differs at {int((got[1] != want[1]).sum())} of {got[1].size}")
    scale = 255.0 if want.dtype == np.uint8 else 1.0  # uint8 palette images: 0-255
    d = np.abs(got.astype(np.float64) - want) / scale
    return (f"max|d| {d.max():.3e} ({255 * d.max():.3f} levels of 8 bits), "
            f"{100 * (d > 1 / 510).mean():.4f}% of values over half a level")


def _annotate_run(dev: torch.device, smi: str, name: str, fn, one, expect: dict, check,
                  with_tf32: bool) -> dict:
    """``fn()`` (a clip) after a warm-up on one frame (pair): s/clip, peak GiB, the launches
    (which must equal ``expect``, GroupNorm's counted as forwards), ``check``'s line; ``one`` = (what, a frame's or pair's
    call) under the profiler and, where ``with_tf32``, in TF32 against fp32."""
    t, h, w = ANNOTATE_CLIP
    one[1]()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launched = {k: v for k, v in counts.items() if v}
    print(f"[annotate] {smi} | {name} on {t}x{h}x{w}: {seconds:.4f} s/clip (host clock, "
          f"after a warm-up), peak {peak:.2f} GiB, launches {launched} | {check(out)}",
          flush=True)
    assert _by_forwards(counts) == expect, (name, launched, expect)
    _profiled("annotate", f"{name}, {one[0]}", one[1])
    if with_tf32:
        print(f"[annotate] {name}, {one[0]}: cuDNN TF32 (PyTorch's default) against the "
              f"CLI's fp32: {_tf32_against_fp32(one[1])}", flush=True)
    return counts


def phase_annotate_full(dev: torch.device, smi: str) -> dict:
    """8k: ``lkgd_torch/cli/annotate.py``'s own build functions at full width on the
    synthetic ``ANNOTATE_CLIP`` (14 x 576 x 1024) in the CLI's ``annotate.precision`` (fp32
    throughout): ``flow`` (UniMatch ``lkgd()``, random from seed 0), ``tracks``
    (``RAFTConfig()`` from a ``--weights`` file of the ``raft_large`` manifest's keys,
    random, loaded strictly; grid 16), ``depth_anything`` small and base, ``depth_midas``
    (DPT-hybrid) and ``depth`` (DPT-large), each from a ``--weights`` file of a random
    model's state dict (the head's last bias 0.5) loaded strictly, registered in
    ``control_preprocess`` for its path and unregistered after it; then RIFE 2x (14 -> 27
    frames, random), which has no CLI. For each: s/clip after a warm-up (host clock,
    synchronised), peak GiB, one frame (pair) under ``torch.profiler`` (busy share, device
    operations, time by kind), the launches of one clip (the fp32 flash form 12 a frame on
    ``depth_anything``, GroupNorm once a norm of the BiT backbone on ``depth_midas``,
    nothing of the port's kernels on the rest), outputs finite, in range and not constant;
    tracks (14, 256, 2) with their visible share; and each CLI path's frame (pair) with
    cuDNN's TF32 on against the CLI's fp32. Returns the launches by path."""
    from lkgd_torch.cli import annotate

    frames = _annotate_clip()
    with annotate.precision():
        by_path = _annotate_cli_paths(dev, smi, frames)
    by_path["annotate_rife"] = _rife_full(dev, smi, frames)
    return by_path


def _annotate_cli_paths(dev: torch.device, smi: str, frames: np.ndarray) -> dict:
    import argparse
    import shutil
    import tempfile

    from lkgd_torch.cli import annotate
    from lkgd_torch.models import depth_anything as da
    from lkgd_torch.models import midas
    from lkgd_torch.models.layers import GroupNorm
    from lkgd_torch.utils import control_preprocess as cp

    t, h, w = ANNOTATE_CLIP
    work = Path(tempfile.mkdtemp(prefix="lkgd_annotate_"))
    parser = annotate.make_parser()

    def args_for(annotation: str, *extra: str) -> argparse.Namespace:
        return parser.parse_args(["--input", str(work), "--output", str(work), "--annotation",
                                  annotation, *extra])

    def run(name, fn, one, expect, check) -> dict:
        return _annotate_run(dev, smi, name, fn, one, expect, check, with_tf32=True)

    by_path = {}
    # flow: UniMatch on the 13 consecutive pairs, FLOW_PAIRS a batch
    flow = annotate.build_flow_processor(args_for("flow"))

    def flow_check(images):
        assert images.shape == (t, h, w, 3) and np.isfinite(images).all()
        assert images.min() >= 0.0 and images.max() <= 1.0 and images.max() > images.min()
        return f"flow images {images.shape} in [{images.min():.3f}, {images.max():.3f}]"

    by_path["annotate_flow"] = run("flow", lambda: flow(frames),
                                   ("one pair", lambda: flow(frames[:2])), {}, flow_check)
    del flow
    torch.cuda.empty_cache()

    _random_raft_file(str(work / "raft_large.pth"), 41)
    track = annotate.build_tracker(args_for("tracks", "--weights", str(work / "raft_large.pth")))

    def track_check(out):
        tracks, vis = out
        assert tracks.shape == (t, 256, 2) and vis.shape == (t, 256) and vis.dtype == np.bool_
        assert np.isfinite(tracks).all() and vis[0].all()
        return (f"tracks {tracks.shape}, {100 * vis.mean():.1f}% visible, |displacement| up "
                f"to {np.abs(tracks - tracks[:1]).max():.1f} px")

    by_path["annotate_tracks"] = run("tracks", lambda: track(frames),
                                     ("one pair", lambda: track(frames[:2])), {}, track_check)
    del track
    torch.cuda.empty_cache()

    def depth_check(maps):
        assert maps.shape == (t, h, w, 3) and np.isfinite(maps).all()
        assert maps.min() >= 0.0 and maps.max() <= 1.0 and maps.max() > maps.min()
        return f"depth maps {maps.shape} in [{maps.min():.3f}, {maps.max():.3f}]"

    with torch.device("meta"):
        n_gn = sum(isinstance(m, GroupNorm) for m in midas.DPTHybridDepth().modules())
    for annotation, size, build, expect in (
            ("depth_anything", "small", lambda: da.build_depth_anything(
                da.DepthAnythingConfig.small(), dev, torch.Generator(device=dev).manual_seed(42)),
             dict.fromkeys(PRECOMPUTE, da.DepthAnythingConfig.small().depth * t)),
            ("depth_anything", "base", lambda: da.build_depth_anything(
                da.DepthAnythingConfig.base(), dev, torch.Generator(device=dev).manual_seed(43)),
             dict.fromkeys(PRECOMPUTE, da.DepthAnythingConfig.base().depth * t)),
            ("depth_midas", "hybrid", lambda: midas.build_dpt(
                "hybrid", None, dev, torch.Generator(device=dev).manual_seed(44)),
             {"gn_forwards": n_gn * t}),
            ("depth", "large", lambda: midas.build_dpt(
                "large", None, dev, torch.Generator(device=dev).manual_seed(45)), {})):
        path = str(work / f"{annotation}_{size}.pth")
        model = build()
        model.state_dict()[LAST_BIAS["depth_anything" if annotation == "depth_anything"
                                     else size]].fill_(0.5)
        _random_model_file(model, path)
        del model
        args = args_for(annotation, "--weights", path, "--model-size",
                        size if annotation == "depth_anything" else "small")
        cp.register_processor(annotation, annotate.build_depth_processor(args))
        try:
            by_path[f"annotate_{annotation}" + (f"_{size}" if annotation == "depth_anything"
                                                else "")] = run(
                f"{annotation} ({size})", lambda: cp.control_preprocess(frames, annotation),
                ("one frame", lambda: cp.control_preprocess(frames[:1], annotation)), expect,
                depth_check)
        finally:  # the processor, and with it the model, leaves the card
            cp._EXTERNAL.pop(annotation)
        os.remove(path)
        torch.cuda.empty_cache()
    shutil.rmtree(work)
    return by_path


def _rife_full(dev: torch.device, smi: str, frames: np.ndarray) -> dict:
    from lkgd_torch.models import rife

    t = len(frames)
    model = rife.build_rife(device=dev, generator=torch.Generator(device=dev).manual_seed(46))
    video = torch.from_numpy(frames).to(dev)

    def rife_check(out):
        assert tuple(out.shape) == (2 * t - 1, *frames.shape[1:]) and torch.isfinite(out).all()
        assert out.min() >= 0.0 and out.max() <= 1.0 and torch.equal(out[::2], video)
        return f"RIFE 2x: {tuple(out.shape)} in [{out.min():.3f}, {out.max():.3f}]"

    counts = _annotate_run(dev, smi, "RIFE 2x",
                           lambda: rife.interpolate_video(model, video),
                           ("one pair", lambda: rife.interpolate_video(model, video[:2])), {},
                           rife_check, with_tf32=False)
    del model, video
    torch.cuda.empty_cache()
    return counts



# ---------------------------------------------------------------- more labels, and captions
LABELS = ("softedge_hed", "scribble_hed", "softedge_hedsafe", "scribble_hedsafe",
          "softedge_pidinet", "softedge_pidsafe", "scribble_pidinet", "lineart",
          "lineart_coarse", "lineart_anime", "segmentation", "openpose")
TINY_BLIP = dict(image_size=32, patch_size=8, vision_hidden=48, vision_layers=2,
                 vision_heads=2, vision_intermediate=96, vocab_size=64, text_hidden=32,
                 text_layers=2, text_heads=2, text_intermediate=64, max_position_embeddings=32,
                 bos_token_id=60, sep_token_id=61, pad_token_id=0)
COGVLM_VIDEO = (24, 20, 12)  # frames, new tokens, prompt ids


def _label_file(annotation: str, path: str, device, seed: int) -> None:
    """A random model of ``annotation`` (from ``seed``, built on ``device`` at the size the
    CLI's build function would build) saved to ``path`` under the published names: PiDiNet's raw
    pixel-difference kernels (a radial difference's 3x3); HED's projection and PiDiNet's
    classifier biases 1, so that the scribble's >127 lines exist; OpenPose's last heatmap
    layer 0.1x with bias -2, so that no peak passes the 0.1 threshold (a random model's
    heatmaps give thousands, and the host's pairwise limb matching would run for minutes)."""
    from lkgd_torch.models import hed, lineart, lineart_anime, openpose, pidinet, segformer

    g = torch.Generator(device=device).manual_seed(seed)
    if annotation.endswith(("_pidinet", "_pidsafe")):
        with torch.device("meta"):
            names = pidinet.PiDiNet().state_dict()
        sd = {}
        for name, t in names.items():
            shape = torch.Size((t.shape[0], 1, 3, 3) if pidinet.pdc_op_for(name) == "rd"
                               else t.shape)
            x = torch.randn(shape, generator=g, device=device)
            sd[f"module.{name}"] = x / shape[1:].numel() ** 0.5 if len(shape) == 4 else 0.1 * x
        sd["module.classifier.bias"].fill_(1.0)
    else:
        if annotation.endswith(("_hed", "_hedsafe")):
            model = hed.build_hed(device, g)
            for i in range(1, 6):
                getattr(model, f"block{i}").projection.bias.fill_(1.0)
        elif annotation == "lineart_anime":
            model = lineart_anime.build_lineart_anime(lineart_anime.LineartAnimeConfig(),
                                                      device, g)
        elif annotation.startswith("lineart"):
            model = lineart.build_lineart(lineart.LineartConfig(), device, g)
        elif annotation == "segmentation":
            model = segformer.build_segformer(segformer.segformer_config("small"), device, g)
        else:
            model = openpose.build_openpose(openpose.OpenPoseConfig(), device, g)
            model.model6_2.Mconv7_stage6_L2.weight.mul_(0.1)
            model.model6_2.Mconv7_stage6_L2.bias.fill_(-2.0)
        sd = model.state_dict()
    torch.save({k: v.cpu() for k, v in sd.items()}, path)


def _tiny_label_configs():
    """The CLI's build functions at the tiny sizes of the tests: Anime2Sketch ``num_downs=6, ngf=8``,
    SegFormer tiny, OpenPose at ``detect_resolution=64``."""
    import contextlib
    import functools

    from lkgd_torch.models import lineart_anime, openpose, segformer

    stack = contextlib.ExitStack()
    anime = lineart_anime.LineartAnimeConfig
    stack.enter_context(mock.patch.object(lineart_anime, "LineartAnimeConfig",
                                          lambda: anime(num_downs=6, ngf=8)))
    stack.enter_context(mock.patch.object(segformer, "segformer_config",
                                          lambda size: segformer.SegformerConfig.tiny()))
    stack.enter_context(mock.patch.object(openpose, "make_openpose_processor", functools.partial(
        openpose.make_openpose_processor, detect_resolution=64)))
    return stack


def _labels_agree(label: str, name: str, got: np.ndarray, want: np.ndarray) -> None:
    """Label maps GPU against CPU: soft maps at rtol 1e-4, atol 2e-4; quantised ones (the
    ``*safe`` steps, scribbles, palette images, skeletons) equal but on at most 1% of the
    values, a value within rounding of a step falling either way."""
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
    differ = float((got != want).mean())
    print(f"[{label}] GPU vs CPU {name} labels {want.shape} {want.dtype}: max|d| "
          f"{np.abs(got.astype(np.float64) - want).max():.3e}, {100 * differ:.3f}% of values "
          f"differ", flush=True)
    if "safe" in name or "scribble" in name or name in ("segmentation", "openpose"):
        assert differ <= 0.01, (name, differ)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4, err_msg=name)


def phase_tiny_labels(dev: torch.device) -> None:
    """4j: at fp32, GPU against CPU with the same random weights: HED's edge (full width),
    PiDiNet, the line-art generator (full width), Anime2Sketch (``num_downs=6, ngf=8``),
    OpenPose's PAFs and heatmaps (full width), SegFormer tiny, BLIP and CogVLM at their tiny
    configurations (logits, and greedy ids equal); then both CLIs on files under the
    published names, written from random models at those sizes (the sizes of
    ``tests/test_torch_annotate.py``'s label cases and ``tests/test_torch_caption.py``):
    each of the twelve label annotators built by ``cli/annotate.py``'s own build function on the
    card and on the CPU from one file over a 4-frame 32x48 clip (``_labels_agree``), and
    ``annotate.main`` on the card for each; ``caption.main`` for BLIP and CogVLM (fp32) on
    the card and on the CPU, the ids equal. Nothing of the port's kernels launches."""
    import argparse
    import shutil
    import tempfile

    from lkgd_torch.cli import annotate, caption
    from lkgd_torch.data.video_io import write_video
    from lkgd_torch.models import (blip, cogvlm, hed, lineart, lineart_anime, openpose,
                                   pidinet, segformer)
    from lkgd_torch.utils import control_preprocess as cp

    label = "tiny-labels"
    g = torch.Generator().manual_seed(50)
    img = torch.rand((2, 32, 48, 3), generator=g)
    _zero_counts()
    for name, build, run, x in (
            ("HED edge", hed.build_hed, hed.hed_edge, img),
            ("PiDiNet edge", pidinet.build_pidinet, None, img),
            ("line art", lambda d, gen: lineart.build_lineart(lineart.LineartConfig(), d, gen),
             None, img),
            ("Anime2Sketch", lambda d, gen: lineart_anime.build_lineart_anime(
                lineart_anime.LineartAnimeConfig(num_downs=6, ngf=8), d, gen), None,
             torch.rand((1, 64, 128, 3), generator=g) * 2 - 1),
            ("OpenPose PAFs, heatmaps", lambda d, gen: openpose.build_openpose(
                openpose.OpenPoseConfig(), d, gen), None,
             torch.rand((1, 64, 96, 3), generator=g) - 0.5),
            ("SegFormer tiny logits", lambda d, gen: segformer.build_segformer(
                segformer.SegformerConfig.tiny(), d, gen), None,
             torch.randn((2, 64, 96, 3), generator=g))):
        cpu, gpu = _tiny_twins(build, dev, 51)
        run = run or (lambda m, t: m(t))
        with torch.no_grad():
            want, got = run(cpu, x), run(gpu, x.to(dev))
        for i, (a, b) in enumerate(zip(*(o if isinstance(o, tuple) else (o,)
                                         for o in (got, want)))):
            _close_line(label, f"{name} [{i}]", a, b)

    cpu, gpu = _tiny_twins(lambda d, gen: blip.build_blip(blip.BlipConfig(**TINY_BLIP), d, gen),
                           dev, 52)
    pixels = torch.randn((2, 32, 32, 3), generator=g)
    ids = torch.randint(1, 60, (2, 7), generator=g)
    with torch.no_grad():
        _close_line(label, "BLIP logits", gpu(pixels.to(dev), ids.to(dev)), cpu(pixels, ids))
    want = blip.greedy_caption(cpu, pixels, 12)
    got = blip.greedy_caption(gpu, pixels.to(dev), 12).cpu()
    print(f"[{label}] BLIP greedy ids GPU {got.tolist()} CPU {want.tolist()}", flush=True)
    assert torch.equal(got, want)

    cfg = cogvlm.CogVLMConfig.tiny()
    cpu, gpu = _tiny_twins(lambda d, gen: cogvlm.build_cogvlm(cfg, d, gen, torch.float32),
                           dev, 53)
    frames = torch.randn((1, 2, 32, 32, 3), generator=g)
    prompt = torch.randint(3, 64, (1, 5), generator=g)
    with torch.no_grad():
        _close_line(label, "CogVLM logits", gpu(frames.to(dev), prompt.to(dev)),
                    cpu(frames, prompt))
    want = cogvlm.greedy_video_caption(cpu, frames, prompt, 8)
    got = cogvlm.greedy_video_caption(gpu, frames.to(dev), prompt.to(dev), 8).cpu()
    print(f"[{label}] CogVLM greedy ids GPU {got.tolist()} CPU {want.tolist()}", flush=True)
    assert torch.equal(got, want)

    work = Path(tempfile.mkdtemp(prefix="lkgd_labels_"))
    clip = torch.rand((4, 32, 48, 3), generator=g).numpy()
    write_video(str(work / "clip.gif"), clip)
    parser = annotate.make_parser()
    with _tiny_label_configs():
        for i, annotation in enumerate(LABELS):
            path = str(work / f"{annotation}.pth")
            _label_file(annotation, path, "cpu", 60 + i)
            labels = {}
            for device in (str(dev), "cpu"):
                args = parser.parse_args(["--input", str(work), "--output", str(work / device),
                                          "--annotation", annotation, "--weights", path,
                                          "--device", device])
                cp.register_processor(annotation, annotate.PROCESSORS[annotation](args))
                labels[device] = cp.control_preprocess(clip, annotation)
                cp._EXTERNAL.pop(annotation)
            _labels_agree(label, annotation, labels[str(dev)], labels["cpu"])
            annotate.main(["--input", str(work), "--output", str(work / "labels"),
                           "--annotation", annotation, "--weights", path, "--device", str(dev)])
            assert (work / "labels" / f"clip_{annotation}.gif").exists()

    torch.save(blip.build_blip(blip.BlipConfig(**TINY_BLIP), "cpu",
                               torch.Generator().manual_seed(54)).state_dict(), work / "blip.pth")
    torch.save(cogvlm.build_cogvlm(cfg, "cpu", torch.Generator().manual_seed(55),
                                   torch.float32).state_dict(), work / "cogvlm.pth")
    (work / "prompt.json").write_text(json.dumps([5, 9, 17]))
    with mock.patch.object(blip.BlipConfig, "large", classmethod(lambda c: c(**TINY_BLIP))), \
            mock.patch.object(cogvlm.CogVLMConfig, "caption_8b",
                              classmethod(lambda c: c.tiny())), \
            mock.patch.object(caption, "COGVLM_DTYPE", torch.float32):
        for model, extra in (("blip", ["--max-length", "10"]),
                             ("cogvlm", ["--prompt-ids", str(work / "prompt.json"),
                                         "--max-length", "6", "--num-frames", "3"])):
            out = {}
            for device in (str(dev), "cpu"):
                caption.main(["--model", model, "--input", str(work), "--weights",
                              str(work / f"{model}.pth"), "--output",
                              str(work / f"{model}_{device}.json"), "--device", device, *extra])
                out[device] = json.loads((work / f"{model}_{device}.json").read_text())
            print(f"[{label}] caption --model {model}: GPU {out[str(dev)]} CPU {out['cpu']}",
                  flush=True)
            assert out[str(dev)] == out["cpu"] and out["cpu"], model
    shutil.rmtree(work)
    launched = {k: v for k, v in _read_counts().items() if v}
    assert not launched, launched


def _label_check(annotation: str):
    """What a clip's labels must be: (T, H, W, 3) finite in [0, 1] (``safe_step``'s [0, 1.5]
    for the ``*safe`` ones: a saturated edge of 1.0 steps to 1.5) and not constant; the
    scribbles (the random model's lines may cover the frame) and OpenPose's skeleton maps
    (empty with the random model's held-down heatmaps) finite and in range;
    ``segmentation``'s uint8 palette images (the processor divides the CLI's [0, 1] frames
    by 255 again, as the JAX one does, so a random model may see one class throughout)."""
    t, h, w = ANNOTATE_CLIP
    top = 1.5 if "safe" in annotation else 1.0

    def check(maps: np.ndarray) -> str:
        assert maps.shape == (t, h, w, 3), maps.shape
        if annotation == "segmentation":
            assert maps.dtype == np.uint8
            colours = len(np.unique(maps.reshape(-1, 3), axis=0))
            return f"palette images {maps.shape}, {colours} palette colours"
        assert np.isfinite(maps).all() and maps.min() >= 0.0 and maps.max() <= top
        if annotation != "openpose" and not annotation.startswith("scribble"):
            assert maps.max() > maps.min(), annotation
        return (f"label maps {maps.shape} in [{maps.min():.3f}, {maps.max():.3f}], mean "
                f"{maps.mean():.4f}")

    return check


def phase_labels_full(dev: torch.device, smi: str) -> dict:
    """8l: the twelve label annotators through ``cli/annotate.py``'s own build functions at full
    width on ``ANNOTATE_CLIP`` (14x576x1024) in the CLI's ``annotate.precision`` (fp32), each
    from a ``--weights`` file of a random model under the published names (``_label_file``),
    loaded strictly (SegFormer B0, ``--model-size small``, and B4, ``base``): s/clip after a
    warm-up, peak GiB, one frame under ``torch.profiler``, no launch of the port's kernels,
    the labels' check, and cuDNN's TF32 against the CLI's fp32 on that frame. Returns the
    launches by path."""
    import shutil
    import tempfile

    from lkgd_torch.cli import annotate
    from lkgd_torch.utils import control_preprocess as cp

    frames = _annotate_clip()
    work = Path(tempfile.mkdtemp(prefix="lkgd_labels_"))
    parser = annotate.make_parser()
    by_path = {}
    with annotate.precision():
        for i, (annotation, size) in enumerate([(a, "small") for a in LABELS]
                                               + [("segmentation", "base")]):
            path = str(work / f"{annotation}.pth")
            if size == "base":
                from lkgd_torch.models import segformer

                model = segformer.build_segformer(segformer.SegformerConfig.b4_ade(), dev,
                                                  torch.Generator(device=dev).manual_seed(90))
                torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
                del model
            else:
                _label_file(annotation, path, dev, 70 + i)
            args = parser.parse_args(["--input", str(work), "--output", str(work),
                                      "--annotation", annotation, "--weights", path,
                                      "--model-size", size])
            cp.register_processor(annotation, annotate.PROCESSORS[annotation](args))
            name = annotation + (f" ({'B0' if size == 'small' else 'B4'})"
                                 if annotation == "segmentation" else "")
            try:
                by_path[f"annotate_{annotation}" + ("_b4" if size == "base" else "")] = (
                    _annotate_run(dev, smi, name,
                                  lambda: cp.control_preprocess(frames, annotation),
                                  ("one frame", lambda: cp.control_preprocess(frames[:1],
                                                                              annotation)),
                                  {}, _label_check(annotation), with_tf32=True))
            finally:  # the processor, and with it the model, leaves the card
                cp._EXTERNAL.pop(annotation)
            os.remove(path)
            torch.cuda.empty_cache()
    shutil.rmtree(work)
    return by_path


def _timed_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_captions_full(dev: torch.device, smi: str) -> dict:
    """8m: the captioners at their published widths, random weights from a seed built on the
    card. BLIP-large (fp32, TF32 off) on one 384x384 frame through ``cli/caption.py``'s
    ``caption_blip`` at ``--max-length 20``: s/caption after a warm-up, peak. CogVLM2-Caption
    at ``caption_8b`` in bf16 (19.5 B parameters, never written to a file): its state dict's
    names with THUDM's rotary buffers added go through ``port_cogvlm`` to exactly the module's
    own and load strictly; a 24-frame 576x1024 video through ``video_clip`` (JAX's
    antialiased bilinear to 224x224) and ``greedy_video_caption`` with 12 prompt ids and 20
    new tokens: s/video split into the vision tower and the decode after a warm-up, peak, one
    decode step under ``torch.profiler``. No launch of the port's kernels (attention: 257
    tokens a frame, and a masked LM). Returns the launches by path."""
    import argparse
    import shutil
    import tempfile

    from PIL import Image

    from lkgd_torch.cli import annotate, caption
    from lkgd_torch.models import blip, cogvlm

    label = "captions"
    work = Path(tempfile.mkdtemp(prefix="lkgd_captions_"))
    Image.fromarray((_annotate_clip(1)[0] * 255).astype(np.uint8)).save(work / "frame.png")
    by_path = {}
    with annotate.precision():
        model = blip.build_blip(blip.BlipConfig.large(), dev,
                                torch.Generator(device=dev).manual_seed(91))
        args = argparse.Namespace(frame=0, max_length=20)
        caption.caption_blip(model, args, str(work / "frame.png"))  # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        ids, seconds = _timed_s(lambda: caption.caption_blip(model, args, str(work / "frame.png")))
        by_path["caption_blip"] = counts = _read_counts()
        n = sum(p.numel() for p in model.parameters())
        size = model.cfg.image_size
        print(f"[{label}] {smi} | BLIP-large ({n / 1e6:.1f} M parameters, fp32) on one {size}x"
              f"{size} frame, --max-length 20: {seconds:.4f} s/caption (host clock, after a warm-up), "
              f"peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, {len(ids)} ids "
              f"{ids}", flush=True)
        assert not {k: v for k, v in counts.items() if v}
        assert all(0 <= t < blip.BlipConfig.large().vocab_size for t in ids)
        pixels = torch.from_numpy(blip.preprocess_images(_annotate_clip(1),
                                                         model.cfg.image_size)).to(dev)
        with torch.no_grad():
            enc = model.vision_model(pixels)
            step_ids = torch.zeros((1, 20), dtype=torch.long, device=dev)
            _profiled(label, "BLIP-large, one decode step (20 positions)",
                      lambda: model.text_decoder(step_ids, enc))
        del model, enc
        torch.cuda.empty_cache()

    cfg = cogvlm.CogVLMConfig.caption_8b()
    torch.cuda.reset_peak_memory_stats(dev)
    model, build_s = _timed_s(lambda: cogvlm.build_cogvlm(
        cfg, dev, torch.Generator(device=dev).manual_seed(92)))
    sd = model.state_dict()
    n = sum(v.numel() for v in sd.values())
    published = {**sd, **{f"model.layers.{i}.self_attn.rotary_emb.inv_freq":
                          torch.zeros(cfg.head_dim // 2, device=dev)
                          for i in range(cfg.num_layers)}}
    ported = cogvlm.port_cogvlm(published)
    assert list(ported) == list(sd)
    _, load_s = _timed_s(lambda: model.load_state_dict(ported, strict=True))
    del sd, published, ported
    print(f"[{label}] CogVLM2-Caption caption_8b: {n / 1e9:.3f} B parameters in bf16 built on "
          f"the card from a seed in {build_s:.2f} s; its {len(model.state_dict())} names (THUDM's "
          f"{cfg.num_layers} rotary buffers dropped by port_cogvlm) loaded strictly in "
          f"{load_s:.2f} s", flush=True)
    t, new_tokens, n_prompt = COGVLM_VIDEO
    g = torch.Generator().manual_seed(93)
    prompt = torch.randint(0, cfg.bos_token_id, (1, n_prompt), generator=g).to(dev)
    clip = caption.video_clip(_annotate_clip(t), t, cfg.image_size, dev)
    cogvlm.greedy_video_caption(model, clip, prompt, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    with torch.no_grad():
        img, vision_s = _timed_s(lambda: model.image_features(clip))
    ids, total_s = _timed_s(lambda: cogvlm.greedy_video_caption(model, clip, prompt, new_tokens))
    by_path["caption_cogvlm"] = counts = _read_counts()
    seq = img.shape[1] + n_prompt + new_tokens
    print(f"[{label}] {smi} | CogVLM2-Caption bf16, {t} frames at {cfg.image_size}^2 "
          f"({img.shape[1]} image tokens), {n_prompt} prompt ids, {new_tokens} new tokens "
          f"(LM over {seq} positions a step): {total_s:.3f} s/video (host clock, after a "
          f"warm-up) = vision tower {vision_s:.3f} s + decode {total_s - vision_s:.3f} s "
          f"({(total_s - vision_s) / new_tokens * 1e3:.1f} ms a token), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB | ids {ids.tolist()}",
          flush=True)
    assert not {k: v for k, v in counts.items() if v}
    assert ids.shape == (1, new_tokens) and bool(((ids >= 0) & (ids < cfg.vocab_size)).all())
    full = torch.cat([prompt, ids], dim=1)
    with torch.no_grad():
        _profiled(label, f"CogVLM2-Caption, one decode step ({seq} positions)",
                  lambda: model.lm_head(model.hidden(img, full)[:, -1]))
    del model, img, clip
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    return by_path

# ------------------------------------------------------------------ sequence parallelism, tools
PAIR_RANKS = 2  # each pair of processes on the one card, over gloo
PAR_FRAMES = 13  # the Ulysses, TP and FSDP DiT steps' clip: 4 latent frames, 226 + 4 x 30 x 45
SP_ULYSSES = (2, 17776, 24, 64)  # a rank's Ulysses call: the whole joint sequence, H/2 heads
SP_RING_Q = (2, 113 + 8775, 48, 64)  # a rank's ring queries: its 113 text rows + 8775 video
SP_SHARD = 8775  # video keys a rank holds: 13 x 30 x 45 / 2
SP_TOL = 5e-2  # a bf16 DiT step through 42 layers, sharded against whole, of max|ref|


def phase_sp_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Kernels 1, 2 and 1a at a Ulysses rank's (2, 17776, 24, 64) and kernels 7 and 8 at a
    ring rank's (2, 8888, 48, 64) queries against one 8775-key video shard, each against its
    plain version (blocks of 4 heads), with the library call's time and the bound."""
    rows = {"ulysses": _forward_rows("sp-kernel", "Ulysses head shard", SP_ULYSSES, gen,
                                     heads_of(4))}
    torch.cuda.empty_cache()
    b, _, h, d = SP_RING_Q
    q = torch.randn(SP_RING_Q, device=dev, generator=gen).bfloat16()
    k, v = (torch.randn((b, SP_SHARD, h, d), device=dev, generator=gen).bfloat16()
            for _ in range(2))
    rows["ring"] = _lse_rows("sp-kernel", "ring rows x one video shard", q, k, v, heads_of(4))
    for r in rows["ring"].values():
        r["shape"], r["keys"] = list(SP_RING_Q), SP_SHARD
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def _sp_ring_merge(dev: torch.device, gen: torch.Generator) -> None:
    """A ring rank's queries against two video shards through ``attention_with_lse``
    (kernel 7 guarded by 8), merged as ring attention merges them, against one call on the
    unsplit keys: shards whose key norms differ 100x (each launch's bound shift its own,
    both shards weighing in), and a shard with one outlier key that no query reads, whose
    bound sends every row of the shard to kernel 8."""
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops.attention import attention_with_lse
    from lkgd_torch.parallel.sequence import merge_partials

    b, _, h, d = SP_RING_Q
    q = torch.randn(SP_RING_Q, device=dev, generator=gen)
    q[..., 0] = 0.0  # no query reads the outlier key's direction
    q = q.bfloat16()
    k = torch.randn((b, 2 * SP_SHARD, h, d), device=dev, generator=gen)
    v = torch.randn((b, 2 * SP_SHARD, h, d), device=dev, generator=gen).bfloat16()
    for label in ("key norms 100x apart", "an outlier key past the guard"):
        ks = k.clone()
        if label == "key norms 100x apart":  # both shards weigh in; their shifts differ
            ks[:, SP_SHARD:] *= 0.01
        else:  # one key of 60x the norm, orthogonal to every query: its shard's bound
            ks[:, 0] = 0.0  # leaves every row sum below 2^-110, its logit 0 weighs little
            ks[:, 0, :, 0] = 60.0 * d ** 0.5
        ks = ks.bfloat16()
        counter = fa.recomputed_tiles(dev)
        counter.zero_()
        parts = [attention_with_lse(q, ks[:, s], v[:, s])
                 for s in (slice(0, SP_SHARD), slice(SP_SHARD, None))]
        recomputed = int(counter.item())
        out, lse = merge_partials(parts)
        want_out, want_lse = attention_with_lse(q, ks, v)
        err = ((out - want_out.float()).abs().max() / want_out.float().abs().max()).item()
        lse_err = (lse - want_lse).abs().max().item()
        print(f"[sp-kernel] ring merge of two shards' (out, lse), {label}: out max|d| {err:.3e} "
              f"of max|ref| (tol {FLASH_TOL}), lse max|d| {lse_err:.3e} (tol {LSE_TOL}) against "
              f"one call on the {2 * SP_SHARD} keys | tiles recomputed in the shards {recomputed}",
              flush=True)
        assert err <= FLASH_TOL and lse_err <= LSE_TOL, (label, err, lse_err)
        if label.startswith("an outlier"):
            assert recomputed > 0, "no row of the outlier's shard fell back to kernel 8"
    del q, k, v, ks, parts, out


def _join_pair(rank: int, work: Path, timeout: int) -> torch.device:
    """One rank of a pair of processes on cuda:0: TF32 off, the gloo group joined through a
    ``FileStore`` in ``work``, the kernels' library built. Returns the card."""
    import datetime

    import torch.distributed as dist

    from lkgd_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), PAIR_RANKS),
                            rank=rank, world_size=PAIR_RANKS,
                            timeout=datetime.timedelta(seconds=timeout))
    _build.library()
    return dev


def _spawn_pair(flag: str, work: str, timeout: int) -> dict:
    """Run ``chip_smoke.py FLAG R WORK`` for both ranks and wait for them (a rank still
    running at ``timeout`` is killed; any rank that fails fails the phase). Returns rank 0's
    ``WORK/result.json``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(r),
                               work]) for r in range(PAIR_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * PAIR_RANKS, f"the {flag} ranks exited with {rcs}"
    return json.loads((Path(work) / "result.json").read_text())


def _sp_rank_main(rank: int, work: Path) -> int:
    """One rank of the SP pair (``chip_smoke.py --sp-rank R DIR``, started by
    ``phase_sp_pair``): joins the gloo group, then (1) the joint attention at CogVideoX's
    shapes, Ulysses and ring, against one flash call and the plain version on the whole
    sequence; (2) one full-width CogVideoX-5B DiT step in each mode against the unsharded
    step on rank 0. Rank 0 writes the numbers to ``DIR/result.json``."""
    import dataclasses

    import torch.distributed as dist

    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.layers import share_parameters
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.parallel import mesh, sequence

    dev = _join_pair(rank, work, 600)
    pg = mesh.make_mesh(f"context={PAIR_RANKS}", dev).groups["context"]
    tag = f"sp-pair r{rank}"
    result = {"attention": {}, "dit": {}}

    # (1) attention: the same q, k, v on both ranks, each rank its text + video shard
    gen = torch.Generator(device=dev).manual_seed(91)
    q, k, v = (torch.randn(COG_FLASH, device=dev, generator=gen).bfloat16() for _ in range(3))
    text, n = 226, SP_SHARD

    def shard(x):
        return torch.cat([x[:, :text], x[:, text + rank * n:text + (rank + 1) * n]], 1)

    if rank == 0:
        plain = in_head_blocks(lambda *a: fa.flash_attention_maxtrack_plain(
            *(x.float() for x in a)), (q, k, v), 4)
        whole = fa.flash_attention(q, k, v)
    for mode in ("ulysses", "ring"):
        torch.cuda.synchronize()
        dist.barrier()
        _zero_counts()
        t0 = time.perf_counter()
        out = sequence.joint_sp_attention(shard(q), shard(k), shard(v), text, mode, pg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k_: c for k_, c in _read_counts().items() if c}
        full = torch.cat([out[:, :text], sequence.all_gather(out[:, text:], 1, pg)], 1)
        if rank == 0:
            ref_max = plain.abs().max().item()
            err = (full.float() - plain).abs().max().item() / ref_max
            err_whole = (full.float() - whole.float()).abs().max().item() / ref_max
            print(f"[{tag}] joint {mode} attention {COG_FLASH}, {PAIR_RANKS} ranks: max|d| "
                  f"{err:.3e} of max|ref| against the plain version (tol {FLASH_TOL}), "
                  f"{err_whole:.3e} against one flash call on the whole sequence | {seconds:.3f} "
                  f"s a call (collectives through the host) | launches {counts}", flush=True)
            assert err <= FLASH_TOL, (mode, err)
            result["attention"][mode] = {"err": err, "err_whole": err_whole,
                                         "seconds": seconds, "launches": counts}
        del out, full
    del q, k, v
    if rank == 0:
        del plain, whole
    torch.cuda.empty_cache()

    # (2) the DiT: built by the CLI's build (--mesh, ring; weights checked replicated), its
    # Ulysses and unsharded twins on the same parameters; the ring step on the 49-frame clip,
    # the Ulysses step on its first PAR_FRAMES frames (the 49-frame one is cut for the
    # smoke's time), each against the unsharded step of its clip
    args = cli.make_parser().parse_args(
        ["--image", "-", "--seed", "0", "--device", str(dev), "--mesh",
         f"context={PAIR_RANKS}", "--sequence-parallel", "ring"])
    t0 = time.perf_counter()
    pipe, vae = cli.build(args)
    del vae
    gen = torch.Generator(device=dev).manual_seed(9)
    _fill_fusion_output(pipe.transformer, gen)
    models = {"ring": pipe.transformer}
    cfg = pipe.transformer.config
    for mode in ("ulysses", "none"):
        with torch.device("meta"):
            twin = CogVideoXTransformer3D(dataclasses.replace(cfg, sequence_parallel=mode))
        models[mode] = share_parameters(pipe.transformer, twin).eval()
    models["ulysses"].context_group = pipe.transformer.context_group
    pcfg = pipe.config
    rows = 2
    model_in = torch.randn((rows, pipe.latent_frames, pcfg.latent_height, pcfg.latent_width,
                            cfg.in_channels), generator=gen, device=dev).bfloat16()
    prompt = torch.randn((1, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen,
                         device=dev) * 0.2
    ctx = torch.cat([torch.zeros_like(prompt), prompt]).bfloat16()
    t_step = torch.full((rows,), 999.0, device=dev)
    domain, flow = (torch.randn((1, 1, 1000), generator=gen, device=dev) for _ in range(2))
    clips = {"ring": model_in, "ulysses": model_in[:, :(PAR_FRAMES - 1) // 4 + 1]}
    torch.cuda.synchronize()
    print(f"[{tag}] CogVideoX-5B DiT {sum(p.numel() for p in pipe.transformer.parameters()) / 1e9:.3f} "
          f"B built by run_inference_cogvideox.build (--mesh context={PAIR_RANKS} "
          f"--sequence-parallel ring, weights checked equal on both ranks) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def tokens(x):
        return ctx.shape[1] + x.shape[1] * pcfg.latent_height * pcfg.latent_width // 4

    with torch.inference_mode():
        refs = {}
        if rank == 0:
            models["none"](model_in, ctx, t_step, domain, flow)  # warm-up of the cuBLAS plans
            for mode, x in clips.items():
                torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                refs[mode] = models["none"](x, ctx, t_step, domain, flow).float()
                torch.cuda.synchronize()
                dense_s = time.perf_counter() - t0
                dense = {k_: c for k_, c in _read_counts().items() if c}
                result["dit"][f"none_{mode}"] = {"seconds": dense_s, "launches": dense}
                print(f"[{tag}] unsharded DiT step ({rows} x {tokens(x)} tokens, the {mode} "
                      f"step's clip): {dense_s:.3f} s, launches {dense}", flush=True)
            # the bf16 noise floor: the same step through kernel 2 instead of kernel 1
            ref = refs["ring"]
            os.environ["LKGD_FLASH_MAXTRACK"] = "1"
            try:
                alt = models["none"](model_in, ctx, t_step, domain, flow).float()
            finally:
                os.environ.pop("LKGD_FLASH_MAXTRACK", None)
            floor = ((alt - ref).abs().max() / ref.abs().max()).item()
            floor_mean = ((alt - ref).abs().mean() / ref.abs().mean()).item()
            del alt
            print(f"[{tag}] the unsharded {rows} x {tokens(model_in)}-token step through kernel "
                  f"2 instead of 1 differs by max|d| {floor:.3e} of max|ref|, mean |d| "
                  f"{floor_mean:.3e} of mean |ref| (bf16 rounding through {cfg.num_layers} "
                  f"layers)", flush=True)
            result["dit"]["none_ring"].update(floor=floor, floor_mean=floor_mean)
        for mode, x in clips.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            _zero_counts()
            t0 = time.perf_counter()
            out = models[mode](x, ctx, t_step, domain, flow)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            mesh.check_replicated([out], pg, "DiT outputs")
            peaks = [None] * PAIR_RANKS
            dist.all_gather_object(peaks, peak, group=pg)
            all_counts = [None] * PAIR_RANKS
            dist.all_gather_object(all_counts, counts, group=pg)
            assert all(c == counts for c in all_counts), all_counts
            assert torch.isfinite(out).all(), mode
            if rank == 0:
                ref = refs[mode]
                err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                mean = ((out.float() - ref).abs().mean() / ref.abs().mean()).item()
                shown = {k_: c for k_, c in counts.items() if c}
                print(f"[{tag}] {mode} DiT step ({rows} x {tokens(x)} tokens), {PAIR_RANKS} "
                      f"ranks on one card: max|d| {err:.3e} of max|ref| (tol {SP_TOL}), mean "
                      f"|d| {mean:.3e} of mean |ref| against the unsharded step | "
                      f"{seconds:.3f} s (two ranks time-slicing one card, collectives through "
                      f"the host: no scaling figure) | peak GiB a rank "
                      f"{', '.join(f'{p:.2f}' for p in peaks)} | launches a rank {shown}",
                      flush=True)
                assert err <= SP_TOL, (mode, err)
                result["dit"][mode] = {"err": err, "mean_err": mean, "seconds": seconds,
                                       "peak_gib": peaks, "launches": counts}
            del out
    layers = cfg.num_layers
    if rank == 0:
        ring, uly = result["dit"]["ring"]["launches"], result["dit"]["ulysses"]["launches"]
        # ring: the text block plain (226 keys), each video shard kernel 7 with its guard
        for name in ("flash_bound_lse", "flash_maxtrack_lse", "flash_key_norm"):
            assert ring[name] == 2 * layers, (name, ring[name])
        assert ring["flash_bound"] == ring["flash_maxtrack"] == 0, ring
        # Ulysses: the whole sequence on half the heads, kernel 1 with its guard and 1a
        for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
            assert uly[name] == layers, (name, uly[name])
        assert uly["flash_bound_lse"] == 0, uly
        uly_call = result["attention"]["ulysses"]["launches"]
        for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
            assert uly_call[name] == 1, (name, uly_call[name])
        (work / "result.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_sp_pair(dev: torch.device) -> dict:
    """Sequence parallelism on the one card: two processes (``--sp-rank``) on cuda:0 over
    gloo, since NCCL refuses two ranks on one card; every collective goes through the host.
    Returns the launches a rank of each DiT step by mode and of the Ulysses attention call."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        result = _spawn_pair("--sp-rank", work, 600)
    dit = result["dit"]
    print(f"[sp-pair] {PAIR_RANKS} ranks: attention max|d| ulysses "
          f"{result['attention']['ulysses']['err']:.3e}, ring {result['attention']['ring']['err']:.3e}; "
          f"DiT step ring {dit['ring']['seconds']:.3f} s (max|d| {dit['ring']['err']:.3e}; "
          f"unsharded {dit['none_ring']['seconds']:.3f} s), ulysses on {PAR_FRAMES} frames "
          f"{dit['ulysses']['seconds']:.3f} s (max|d| {dit['ulysses']['err']:.3e}; unsharded "
          f"{dit['none_ulysses']['seconds']:.3f} s) | phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"sp_ring": dit["ring"]["launches"], "sp_ulysses": dit["ulysses"]["launches"],
            "sp_ulysses_attention": result["attention"]["ulysses"]["launches"]}


PAR_SVD_STEPS = 1  # the SVD base clip's denoising steps under data=2 and under context=2
# the other modes under context=2, one step each (smooth: step 24 of 25): the loop whole on
# each rank, the decode's chunks one a rank in every mode. Smooth runs its CFG sides one after
# the other: two ranks' batched 12-row loops (~35 GiB each with the allocator's cache) do not
# fit on the one card beside each other and the parent process
PAR_MODES = {"trans": ["--flip", "--temporal", "--lora-rank", "4", "--decode-chunk-size", "14",
                       "--num-inference-steps", "1"],
             "smooth": ["--flip", "--temporal", "--lora-rank", "4", "--smooth-total-frames",
                        "28", "--smooth-start-step", "24", "--decode-chunk-size", "14",
                        "--sequential-cfg"],
             "controlnet": ["--decode-chunk-size", "7", "--num-inference-steps", "1"],
             "flow": ["--decode-chunk-size", "7", "--num-inference-steps", "1"]}
PAR_TRAIN = ["--height", "512", "--width", "512", "--num-frames", "8",
             "--per-device-batch-size", "1", "--rank", "4", "--learning-rate", "2e-4", "--remat",
             "--dtype", "bf16", "--checkpoint-every", "0", "--max-steps", "1", "--seed", "0"]


def _timed_counted(fn):
    """``fn()`` after a barrier with the counts zeroed: (result, seconds, launches, peak GiB)."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, _read_counts(), torch.cuda.max_memory_allocated() / 2**30


def _shown(counts: dict) -> dict:
    return {k: c for k, c in counts.items() if c}


def _par_dit(rank: int, dev: torch.device, tag: str) -> dict:
    """The CogVideoX-5B DiT built by the CLI's ``build`` with ``--mesh model=2``, tensor
    parallel and then FSDP, one CFG step of the PAR_FRAMES clip each, against the unsharded
    step of the same weights on rank 0 (``build`` without a mesh, the same seed)."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.parallel import mesh, tp

    base = ["--image", "-", "--seed", "0", "--device", str(dev), "--num-frames", str(PAR_FRAMES)]
    result, ref, inputs = {}, None, None
    for sharding in ("tp", "fsdp"):
        t0 = time.perf_counter()
        pipe, vae = cli.build(cli.make_parser().parse_args(
            base + ["--mesh", f"model={PAIR_RANKS}", "--weight-sharding", sharding]))
        del vae
        torch.cuda.synchronize()
        model, cfg = pipe.transformer, pipe.transformer.config
        held = tp.per_device_param_bytes(model)
        if inputs is None:
            gen = torch.Generator(device=dev).manual_seed(9)
            pcfg = pipe.config
            inputs = (torch.randn((2, pipe.latent_frames, pcfg.latent_height, pcfg.latent_width,
                                   cfg.in_channels), generator=gen, device=dev).bfloat16(),
                      (torch.randn((2, cfg.max_text_seq_length, cfg.text_embed_dim),
                                   generator=gen, device=dev) * 0.2).bfloat16(),
                      torch.full((2,), 999.0, device=dev),
                      torch.randn((1, 1, 1000), generator=gen, device=dev),
                      torch.randn((1, 1, 1000), generator=gen, device=dev))
        if rank == 0 and ref is None:
            whole, wvae = cli.build(cli.make_parser().parse_args(base))
            del wvae
            whole_bytes = tp.per_device_param_bytes(whole.transformer)
            with torch.inference_mode():
                whole.transformer(*inputs)  # warm-up of the cuBLAS plans
                torch.cuda.synchronize()
                _zero_counts()
                t1 = time.perf_counter()
                ref = whole.transformer(*inputs)
                torch.cuda.synchronize()
            dense_s, dense = time.perf_counter() - t1, _shown(_read_counts())
            del whole
            torch.cuda.empty_cache()
            print(f"[{tag}] unsharded DiT step ({2} x {226 + ref.shape[1] * 30 * 45} tokens): "
                  f"{dense_s:.3f} s, {whole_bytes / 2**30:.3f} GiB of weights, launches {dense}",
                  flush=True)
            result["none"] = {"seconds": dense_s, "launches": dense, "bytes": whole_bytes}
        with torch.inference_mode():
            out, seconds, counts, peak = _timed_counted(lambda: model(*inputs))
        mesh.check_replicated([out], None, "DiT outputs")
        assert torch.isfinite(out).all(), sharding
        peaks = [None] * PAIR_RANKS
        torch.distributed.all_gather_object(peaks, (peak, held, _shown(counts)))
        assert all(c == peaks[0][2] for *_, c in peaks), peaks
        if rank == 0:
            err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            print(f"[{tag}] {sharding} DiT step (model={PAIR_RANKS}, built by "
                  f"run_inference_cogvideox.build in {time.perf_counter() - t0 - seconds:.1f} s): "
                  f"max|d| {err:.3e} of max|ref| against the unsharded step | {seconds:.3f} s "
                  f"(two ranks time-slicing one card, collectives through the host: no scaling "
                  f"figure) | peak GiB a rank {', '.join(f'{p:.2f}' for p, *_ in peaks)} | "
                  f"weights a rank {', '.join(f'{b / 2**30:.3f}' for _, b, _ in peaks)} GiB of "
                  f"{result['none']['bytes'] / 2**30:.3f} | launches a rank {peaks[0][2]}",
                  flush=True)
            if sharding == "tp":
                assert err <= SP_TOL, err
            else:  # the same weights gathered: the same arithmetic
                assert torch.equal(out, ref), err
            for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
                assert counts[name] == result["none"]["launches"][name] == cfg.num_layers, (
                    sharding, name, counts[name])
            result[sharding] = {"err": err, "seconds": seconds, "peak_gib": [p for p, *_ in peaks],
                                "bytes": [b for _, b, _ in peaks], "launches": counts}
        del pipe, model, out
        torch.cuda.empty_cache()
    return result


def _par_svd(rank: int, dev: torch.device, tag: str) -> dict:
    """The base clip at full size (14x576x1024, PAR_SVD_STEPS steps) through
    ``run_inference_svd.build_pipeline`` with ``--data-parallel 2`` and then
    ``--context-parallel 2`` (the decode's two 7-frame chunks one a rank), against the
    unsharded pipeline of the same seed on rank 0: the latents within SP_TOL of max|ref|, and
    the frames of the same latents bit for bit."""
    from lkgd_torch.cli import run_inference_svd as cli

    argv = ["--image", "-", "--seed", "0", "--device", str(dev), "--num-inference-steps",
            str(PAR_SVD_STEPS), "--decode-chunk-size", "7"]
    image = torch.rand((1, 576, 1024, 3), generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    result, ref = {}, None
    if rank == 0:
        ref = cli.build_pipeline(cli.make_parser().parse_args(argv))
        _zero_counts()
        ref_lat = ref(image, torch.Generator(device=dev).manual_seed(1), output_type="latent")
        result["none"] = {"launches": _shown(_read_counts())}
        # the floor: the same pipeline one CFG row a UNet call, as a data rank runs it
        seq = cli.build_pipeline(cli.make_parser().parse_args(argv + ["--sequential-cfg"]))
        seq_lat = seq(image, torch.Generator(device=dev).manual_seed(1), output_type="latent")
        floor = ((seq_lat - ref_lat).abs().max() / ref_lat.abs().max()).item()
        floor_mean = ((seq_lat - ref_lat).abs().mean() / ref_lat.abs().mean()).item()
        del seq, seq_lat
        torch.cuda.empty_cache()
        print(f"[{tag}] SVD base clip, the unsharded pipeline with --sequential-cfg (one row a "
              f"UNet call) against it batched: max|d| {floor:.3e} of max|ref|, mean |d| "
              f"{floor_mean:.3e} (bf16 GEMMs tile 1 row and 2 differently)", flush=True)
        result["floor"] = {"err": floor, "mean_err": floor_mean}
    for axis, flags in (("data", ["--data-parallel", "2"]), ("context", ["--context-parallel", "2"])):
        pipe = cli.build_pipeline(cli.make_parser().parse_args(argv + flags))
        lat, seconds, counts, peak = _timed_counted(
            lambda: pipe(image, torch.Generator(device=dev).manual_seed(1), output_type="latent"))
        frames, dec_s, dec_counts, _ = _timed_counted(lambda: pipe.decode_latents(lat))
        assert torch.isfinite(lat).all() and torch.isfinite(frames).all(), axis
        if rank == 0:
            err = ((lat - ref_lat).abs().max() / ref_lat.abs().max()).item()
            mean = ((lat - ref_lat).abs().mean() / ref_lat.abs().mean()).item()
            same = torch.equal(frames, ref.decode_latents(lat))
            print(f"[{tag}] SVD base clip 14x576x1024, {PAR_SVD_STEPS} steps, {axis}=2: latents "
                  f"max|d| {err:.3e} of max|ref| (tol {SP_TOL}), mean |d| {mean:.3e} against "
                  f"the unsharded pipeline | frames of these latents equal to the unsharded "
                  f"decode's: {same} | denoise {seconds:.3f} s, decode {dec_s:.3f} s (collectives "
                  f"through the host: no scaling figure), peak {peak:.2f} GiB | launches a rank "
                  f"{_shown(counts)}, the decode's {_shown(dec_counts)}", flush=True)
            assert err <= SP_TOL and same, (axis, err, same)
            assert _shown(counts) == result["none"]["launches"], (counts, result["none"])
            result[axis] = {"err": err, "mean_err": mean, "seconds": seconds, "decode_s": dec_s,
                            "launches": counts}
        del pipe
        torch.cuda.empty_cache()
    return result


def _par_svd_modes(rank: int, dev: torch.device, tag: str) -> dict:
    """Trans, smooth, ControlNet and flow at full size (14x576x1024, one step) through
    ``run_inference_svd.build_pipeline`` with ``--context-parallel 2``: no loop group and no
    UNet module gathering frames, the latents equal on both ranks (a checksum all-reduce),
    rank 0's frames bit for bit the unsplit decode of the same latents, and the launches a
    rank those of the unsplit loop (rank 0 runs it again with the pipeline's groups
    cleared, as one process builds it)."""
    import torch.distributed as dist

    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.parallel import mesh
    from lkgd_torch.pipelines.svd import equal_chunks

    gen = torch.Generator(device=dev).manual_seed(11)
    image = torch.rand((2, 576, 1024, 3), generator=gen, device=dev)
    video = torch.rand((28, 576, 1024, 3), generator=gen, device=dev)
    calls = {"trans": lambda p, g: p.denoise(image, g),
             "smooth": lambda p, g: p.denoise(video, g),
             "controlnet": lambda p, g: p.denoise(image[:1], g),
             "flow": lambda p, g: p.denoise(image[:1], g, flow_cond=image[:1])}
    result = {}
    for mode, flags in PAR_MODES.items():
        t0 = time.perf_counter()
        pipe = cli.build_pipeline(cli.make_parser().parse_args(
            ["--mode", mode, "--image", "-", "--seed", "0", "--device", str(dev),
             "--context-parallel", "2", *flags]))
        gathering = sum(getattr(m, "frame_group", None) is not None for m in pipe.unet.modules())
        assert pipe.data_group is None and pipe.context_group is None and not gathering, mode
        assert dist.get_world_size(pipe.decode_group) == PAIR_RANKS, mode
        decode = pipe._frames if mode == "flow" else pipe.decode_latents  # as __call__ decodes
        build_s = time.perf_counter() - t0
        lat, seconds, counts, peak = _timed_counted(
            lambda: calls[mode](pipe, torch.Generator(device=dev).manual_seed(1)))
        mesh.check_replicated([lat], None, f"{mode} latents")
        frames, dec_s, dec_counts, dec_peak = _timed_counted(lambda: decode(lat))
        assert torch.isfinite(lat).all() and torch.isfinite(frames).all(), mode
        torch.cuda.empty_cache()
        if rank == 0:
            pipe.decode_group = None  # the pipeline one process builds
            b, t = lat.shape[:2]
            chunks = b * t // equal_chunks(t, pipe.config.decode_chunk_size)
            assert chunks % PAIR_RANKS == 0, (mode, chunks)  # spread, not decoded whole
            same = torch.equal(frames, decode(lat))
            _zero_counts()
            again = calls[mode](pipe, torch.Generator(device=dev).manual_seed(1))
            whole = _shown(_read_counts())
            loop_same = torch.equal(again, lat)
            del again
            print(f"[{tag}] SVD {mode} 14x576x1024 at context=2 (built in {build_s:.1f} s), one "
                  f"step: latents equal on both ranks, bit for bit the unsplit loop's: "
                  f"{loop_same} | frames {tuple(frames.shape)} equal to the unsplit decode's: "
                  f"{same} ({chunks} chunks, {chunks // PAIR_RANKS} a rank) | denoise "
                  f"{seconds:.3f} s, decode {dec_s:.3f} s (two ranks time-slicing one card, "
                  f"collectives through the host: no scaling figure) | peak {peak:.2f} GiB, "
                  f"decode {dec_peak:.2f} | launches a rank {_shown(counts)} (unsplit loop "
                  f"{whole}), the decode's {_shown(dec_counts)}", flush=True)
            assert same and loop_same, (mode, same, loop_same)
            assert _shown(counts) == whole, (mode, counts, whole)
            for name in INFERENCE:
                assert counts.get(name, 0) > 0, (mode, name)
            result[mode] = {"seconds": seconds, "decode_s": dec_s, "peak_gib": peak,
                            "decode_peak_gib": dec_peak, "launches": counts}
        del pipe, lat, frames
        torch.cuda.empty_cache()
        dist.barrier()
    return result


def _train_args(out_dir: str, dev: torch.device):
    from lkgd_torch.cli import train_svd_lora as cli

    return cli.make_parser().parse_args(["--output-dir", out_dir, "--device", str(dev)]
                                        + PAR_TRAIN)


def _train_step_record(run, pixel_values) -> dict:
    """One step of the training CLI's trainer: the gradients its optimizer clips, the loss,
    the trained parameters after, the moment bytes, seconds and launches."""
    from lkgd_torch.training.optim8bit import opt_state_bytes

    opt = run.trainer.state.optimizer
    grads = {}
    clip = opt.clip_grads

    def record():
        grads.update({n: p.grad.detach().float().cpu() for n, p in opt.params.items()})
        return clip()

    opt.clip_grads = record
    t0 = time.perf_counter()
    _zero_counts()
    _, loss = run.trainer.train_step(run.trainer.state, {"pixel_values": pixel_values},
                                     run.trainer.generator)
    torch.cuda.synchronize()
    return {"grads": grads, "loss": float(loss), "seconds": time.perf_counter() - t0,
            "launches": _shown(_read_counts()),
            "params": {n: p.detach().float().cpu() for n, p in opt.params.items()},
            "moment_bytes": opt_state_bytes(opt.adamw.state_dict())}


def _par_pixels(dev: torch.device) -> torch.Tensor:
    return torch.rand((PAIR_RANKS, 9, 512, 512, 3),
                      generator=torch.Generator(device=dev).manual_seed(5), device=dev) * 2 - 1


def _par_train(rank: int, dev: torch.device, work: Path, tag: str) -> None:
    """``train_svd_lora.build`` over the pair (the data axis of the whole world) with the
    optimizer ZeRO-sharded (``zero_shard_opt_state``): one step on this rank's row of a
    2-row batch, its record written to ``work`` for the parent's one-process step."""
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.training.trainer import zero_shard_opt_state

    with tempfile.TemporaryDirectory() as out_dir:
        run = cli.build(_train_args(out_dir, dev))
        state = run.trainer.state
        zero_shard_opt_state(state, state.optimizer.group)
        record = _train_step_record(run, _par_pixels(dev)[rank:rank + 1])
    torch.save(record, work / f"train{rank}.pt")
    print(f"[{tag}] LKGD fine-tune step 512x512x8f over {PAIR_RANKS} ranks (one row each, ZeRO): "
          f"{record['seconds']:.3f} s, loss {record['loss']:.5f}, moment bytes a rank "
          f"{record['moment_bytes'] / 2**20:.2f} MiB, launches a rank {record['launches']}",
          flush=True)


def _rows_emulated(cli, run, pixel_values) -> dict:
    """The data-parallel step's arithmetic in this one process: each rank's row through
    ``data_parallel_step`` from the same generator state, the optimizer's update skipped,
    the gradients averaged in fp32 as the ranks' all-reduce averages them. ``run`` is left
    as it was: parameters, optimizer and generator state."""
    opt, gen = run.trainer.state.optimizer, run.trainer.generator
    opt.adamw.step = lambda: None  # each row's gradients at the same parameters
    start, grads = gen.get_state(), []
    clip = opt.clip_grads

    def record():
        grads.append({n: p.grad.detach().float().cpu() for n, p in opt.params.items()})
        return clip()

    opt.clip_grads = record
    try:
        for r in range(PAIR_RANKS):
            gen.set_state(start)
            step = cli.data_parallel_step(run.step, run.preprocess, run.config, (r, PAIR_RANKS))
            step(run.trainer.state, {"pixel_values": pixel_values[r:r + 1]}, gen)
        torch.cuda.synchronize()
    finally:
        del opt.adamw.step, opt.clip_grads
        gen.set_state(start)
        run.trainer.state.step = 0
    return {n: sum(g[n] for g in grads) / PAIR_RANKS for n in grads[0]}


def _par_rank_main(rank: int, work: Path) -> int:
    """One rank of the weight-, row- and frame-splitting pair (``chip_smoke.py --par-rank R
    DIR``, started by ``phase_par_pair``): the DiT tensor parallel and FSDP, the SVD clip over
    data and over context, a data-parallel ZeRO fine-tune step. Rank 0 writes the numbers to
    ``DIR/result.json``."""
    import torch.distributed as dist

    dev = _join_pair(rank, work, 900)
    tag = f"par-pair r{rank}"
    result = {"dit": _par_dit(rank, dev, tag), "svd": _par_svd(rank, dev, tag),
              "svd_modes": _par_svd_modes(rank, dev, tag)}
    _par_train(rank, dev, work, tag)
    if rank == 0:
        (work / "result.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_par_pair(dev: torch.device) -> dict:
    """Weights, rows and frames split over two processes on cuda:0 over gloo (``--par-rank``),
    then the fine-tune step of the same 2-row batch in this one process, against which the
    ranks' averaged gradients are held (1% of each tensor's largest). Returns the launches a
    rank by path."""
    import tempfile

    from lkgd_torch.cli import train_svd_lora as cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        result = _spawn_pair("--par-rank", work, 900)
        ranks = [torch.load(Path(work) / f"train{r}.pt") for r in range(PAIR_RANKS)]
        with tempfile.TemporaryDirectory() as out_dir:
            run = cli.build(_train_args(out_dir, dev))
            rows = _rows_emulated(cli, run, _par_pixels(dev))
            one = _train_step_record(run, _par_pixels(dev))
            del run
    torch.cuda.empty_cache()

    def worst(grads, want):  # max|d| of each tensor over its largest gradient, the worst
        errs = {n: (grads[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for n, w in want.items()}
        name = max(errs, key=errs.get)
        return errs[name], name

    for name in one["params"]:
        assert all(torch.equal(r["params"][name], ranks[0]["params"][name]) for r in ranks), name
    emulated, name_e = worst(ranks[0]["grads"], rows)
    spread, name_s = worst(rows, one["grads"])
    err, name = worst(ranks[0]["grads"], one["grads"])
    moved = max((ranks[0]["params"][n] - p).abs().max().item() for n, p in one["params"].items())
    print(f"[par-pair] fine-tune step over {PAIR_RANKS} ranks: gradients max|d| {emulated:.3e} "
          f"of the tensor's largest against this process's one-row passes averaged (the same "
          f"arithmetic; worst {name_e}), {err:.3e} against one process on the 2-row batch "
          f"(worst {name}; the one-row passes' own distance from it {spread:.3e}, bf16 tiling 1 "
          f"row against 2: the floor); loss {ranks[0]['loss']:.6f} against {one['loss']:.6f}, "
          f"parameters after the step within {moved:.3e}; moment bytes a rank "
          f"{ranks[0]['moment_bytes'] / 2**20:.2f} MiB of {one['moment_bytes'] / 2**20:.2f} "
          f"(ZeRO); one process {one['seconds']:.3f} s, launches {one['launches']}", flush=True)
    assert emulated <= 1e-4, (name_e, emulated)
    assert err <= max(1e-2, 1.5 * spread), (name, err, spread)
    assert ranks[0]["moment_bytes"] < 0.6 * one["moment_bytes"], (ranks[0]["moment_bytes"],
                                                                 one["moment_bytes"])
    assert all(r["launches"] == one["launches"] for r in ranks), (one["launches"],
                                                                 [r["launches"] for r in ranks])
    dit, svd, modes = result["dit"], result["svd"], result["svd_modes"]
    print(f"[par-pair] DiT step tp {dit['tp']['seconds']:.3f} s (max|d| {dit['tp']['err']:.3e}), "
          f"fsdp {dit['fsdp']['seconds']:.3f} s (bit-identical), unsharded "
          f"{dit['none']['seconds']:.3f} s; SVD data=2 {svd['data']['seconds']:.3f} s (max|d| "
          f"{svd['data']['err']:.3e}), context=2 {svd['context']['seconds']:.3f} s (max|d| "
          f"{svd['context']['err']:.3e}); at context=2, denoise + decode: "
          + ", ".join(f"{m} {r['seconds']:.3f} + {r['decode_s']:.3f} s" for m, r in modes.items())
          + f" | phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"tp": dit["tp"]["launches"], "fsdp": dit["fsdp"]["launches"],
            "svd_data": svd["data"]["launches"], "svd_context": svd["context"]["launches"],
            **{f"svd_{m}_context": r["launches"] for m, r in modes.items()},
            "train_data_parallel": ranks[0]["launches"]}


PP_TOL = 1.22e-2  # M=2 against the whole step, of max|ref|: the bf16 floor of a DiT step


def _pp_rank_main(rank: int, work: Path) -> int:
    """One rank of the pipeline pair (``chip_smoke.py --pp-rank R DIR``, started by
    ``phase_pp_pair``): the CogVideoX-5B DiT built by the CLI's ``build`` with ``--mesh
    stage=2`` (the whole model on each rank, as the JAX CLI replicates it over an axis that
    nothing reads), one CFG step of the PAR_FRAMES clip whole; then ``parallel/pp.py``
    ``cogvideox_pp_blocks`` over the stage group, which drops the other rank's 21 blocks: at
    M=1 and M=2 microbatches, each against the whole step of the same process (M=1
    bit-identical; M=2 within PP_TOL, and bit for bit the whole model run with its blocks on
    one row at a time, the microbatches' arithmetic). Rank 0 writes the numbers to
    ``DIR/result.json``."""
    import torch.distributed as dist

    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.parallel import mesh, pp, tp

    dev = _join_pair(rank, work, 600)
    tag = f"pp-pair r{rank}"
    base = ["--image", "-", "--seed", "0", "--device", str(dev), "--num-frames", str(PAR_FRAMES),
            "--mesh", f"stage={PAIR_RANKS}"]
    t0 = time.perf_counter()
    pipe, vae = cli.build(cli.make_parser().parse_args(base))
    del vae
    model, cfg = pipe.transformer, pipe.transformer.config
    grid = mesh.make_mesh(f"stage={PAIR_RANKS}", dev)
    group = grid.groups[pp.STAGE_AXIS]
    gen = torch.Generator(device=dev).manual_seed(9)
    pcfg = pipe.config
    inputs = (torch.randn((2, pipe.latent_frames, pcfg.latent_height, pcfg.latent_width,
                           cfg.in_channels), generator=gen, device=dev).bfloat16(),
              (torch.randn((2, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen,
                           device=dev) * 0.2).bfloat16(),
              torch.full((2,), 999.0, device=dev),
              torch.randn((1, 1, 1000), generator=gen, device=dev),
              torch.randn((1, 1, 1000), generator=gen, device=dev))
    whole_bytes = tp.per_device_param_bytes(model)
    build_s = time.perf_counter() - t0

    def rows_one_at_a_time(hidden, encoder, emb, rope):
        """The blocks on one CFG row at a time: the arithmetic of M=2 in one process."""
        parts = []
        for i in range(hidden.shape[0]):
            h, e = hidden[i:i + 1], encoder[i:i + 1]
            for block in model.transformer_blocks:
                h, e = block(h, e, emb[i:i + 1], rope)
            parts.append((h, e))
        return torch.cat([h for h, _ in parts]), torch.cat([e for _, e in parts])

    result = {}
    with torch.inference_mode():
        model(*inputs)  # warm-up of the cuBLAS plans
        ref, ref_s, ref_counts, _ = _timed_counted(lambda: model(*inputs))
        rows = model(*inputs, blocks_override=rows_one_at_a_time)
        for m in (1, 2):
            override = pp.cogvideox_pp_blocks(model, group, num_microbatches=m)
            out, seconds, counts, peak = _timed_counted(
                lambda: model(*inputs, blocks_override=override))
            held = tp.per_device_param_bytes(model)
            assert torch.isfinite(out).all(), m
            err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            same_rows = torch.equal(out, rows) if m == 2 else None
            shown = _shown(counts)
            print(f"[{tag}] pipeline DiT step, stage={PAIR_RANKS} (21 blocks a rank), M={m}: "
                  f"max|d| {err:.3e} of max|ref| against the whole step (tol "
                  f"{0 if m == 1 else PP_TOL}){'' if m == 1 else f', bit for bit the whole model on one row at a time {same_rows}'} | "
                  f"{seconds:.3f} s (whole {ref_s:.3f} s; two ranks time-slicing one card, "
                  f"activations through the host: no scaling figure) | peak {peak:.2f} GiB | "
                  f"weights {held / 2**30:.3f} GiB of {whole_bytes / 2**30:.3f} | launches "
                  f"{shown}", flush=True)
            for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
                assert counts[name] == m * cfg.num_layers // PAIR_RANKS, (m, name, counts[name])
                assert ref_counts[name] == cfg.num_layers, (name, ref_counts[name])
            assert held < 0.6 * whole_bytes, (held, whole_bytes)
            if m == 1:
                assert torch.equal(out, ref), err
            else:
                assert err <= PP_TOL, err
            result[f"m{m}"] = {"err": err, "seconds": seconds, "peak_gib": peak,
                               "bytes": held, "launches": shown, "same_rows": same_rows}
    outs = [None] * PAIR_RANKS
    dist.all_gather_object(outs, result)
    assert all(o["m2"]["err"] == outs[0]["m2"]["err"] for o in outs), outs
    if rank == 0:
        result.update(whole={"seconds": ref_s, "bytes": whole_bytes, "build_s": build_s,
                             "launches": _shown(ref_counts)},
                      ranks=outs)
        (work / "result.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_pp_pair(dev: torch.device) -> dict:
    """5l: pipeline parallelism over two processes on cuda:0 over gloo (``--pp-rank``): the
    CLI's ``--mesh stage=2`` build, then ``cogvideox_pp_blocks`` at M=1 and M=2. Returns the
    launches a rank by path."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        result = _spawn_pair("--pp-rank", work, 600)
    whole = result["whole"]
    print(f"[pp-pair] CogVideoX-5B DiT step at {PAR_FRAMES} frames over stage={PAIR_RANKS}: "
          f"M=1 bit-identical in {result['m1']['seconds']:.3f} s, M=2 max|d| "
          f"{result['m2']['err']:.3e} in {result['m2']['seconds']:.3f} s (the whole step "
          f"{whole['seconds']:.3f} s); weights a rank {result['m2']['bytes'] / 2**30:.3f} of "
          f"{whole['bytes'] / 2**30:.3f} GiB; build {whole['build_s']:.1f} s | phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert result["m2"]["same_rows"], "M=2 is not the one-row-at-a-time arithmetic"
    return {"pp_m1": result["m1"]["launches"], "pp_m2": result["m2"]["launches"]}


def _inversion(dev, pipe, vae, parser, frames, image_latents, prompt, domain, flow) -> dict:
    """DDIM inversion (``utils/inversion.py``) of the clip's encoded 13x60x90 latents over a
    3-step DDIM schedule, its eps from the full-width DiT (one conditional row, the image
    condition in the first latent frame): seconds a step, launches."""
    from lkgd_torch.cli import run_inference_cogvideox as cli
    from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler
    from lkgd_torch.utils.inversion import ddim_inversion

    chunked = parser.parse_args(["--image", "-", "--device", str(dev), "--vae-chunk-frames", "2"])
    with torch.inference_mode():
        t0 = time.perf_counter()
        latents = cli.encode(vae, frames * 2.0 - 1.0, chunked)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
    scheduler = CogVideoXDDIMScheduler()
    schedule = scheduler.set_timesteps(3)
    cond = torch.zeros_like(latents)
    cond[:, 0] = image_latents
    acp = scheduler.alphas_cumprod
    events = []

    def model_eps(lat, t):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        x = torch.cat([lat, cond], dim=-1).bfloat16()
        v = pipe.transformer(x, prompt.bfloat16(), torch.full((1,), float(t), device=dev),
                             domain, flow).float()
        a = float(acp[t])
        return a ** 0.5 * v + (1.0 - a) ** 0.5 * lat  # v-prediction -> eps

    _zero_counts()
    with torch.inference_mode():
        noise = ddim_inversion(model_eps, scheduler, schedule, latents)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
    launches = _read_counts()
    per_step = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:] + [end])]
    dist = ((noise - latents).norm() / latents.norm()).item()
    print(f"[cogvideox] DDIM inversion of the clip's latents {tuple(latents.shape)} (chunked "
          f"encode of the decoded frames {encode_s:.3f} s): {schedule.num_steps} steps of "
          f"{', '.join(f'{s:.3f}' for s in per_step)} s (timesteps "
          f"{schedule.timesteps[::-1].tolist()}) | |noise - latents| / |latents| {dist:.3f}, "
          f"noise std {noise.std().item():.3f} | launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    assert torch.isfinite(noise).all() and dist > 0.1, dist
    for name in ("flash_bound", "flash_maxtrack", "flash_key_norm"):
        assert launches[name] == pipe.transformer.config.num_layers * schedule.num_steps, name
    return launches


def _png_b64(image: np.ndarray) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def phase_web_demo(dev: torch.device) -> dict:
    """``cli/web_demo.py`` in ``base`` mode at full width (14x576x1024, 25 steps, bf16 random
    weights) on an ephemeral port: two POSTs with different seeds, each a 200 whose mp4
    OpenCV decodes to 14 frames of 576x1024; seconds a request, the launches of both (the
    kernels run on the server's handler threads)."""
    import argparse
    import tempfile
    import threading
    import urllib.request

    import cv2

    from lkgd_torch.cli import web_demo

    args = argparse.Namespace(mode="base", height=576, width=1024, num_frames=14,
                              seed=23123134, device=str(dev))
    t0 = time.perf_counter()
    pipe = web_demo.build_svd(args)
    httpd = web_demo.make_server(web_demo.build_generate_fn(pipe, "base"), "base", 0,
                                 host="127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    yy, xx = np.mgrid[0:720, 0:1280] / 720.0
    start = np.stack([np.sin(3 * xx + 2 * yy + c) * 0.5 + 0.5 for c in (0.0, 2.1, 4.2)], -1)
    print(f"[web-demo] pipeline built in {time.perf_counter() - t0:.1f} s, serving {url}",
          flush=True)
    assert urllib.request.urlopen(url + "/").status == 200
    _zero_counts()
    videos = []
    try:
        for seed in (1, 2):
            body = json.dumps({"start": _png_b64(start), "seed": seed, "fps": 7}).encode()
            t0 = time.perf_counter()
            reply = urllib.request.urlopen(urllib.request.Request(url + "/generate", data=body),
                                           timeout=300)
            data = reply.read()
            seconds = time.perf_counter() - t0
            assert reply.status == 200, reply.status
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "clip.mp4")
                Path(path).write_bytes(data)
                cap = cv2.VideoCapture(path)
                frames = []
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    frames.append(frame)
                cap.release()
            video = np.stack(frames)
            print(f"[web-demo] POST /generate seed {seed}: 200, {len(data) / 1e6:.2f} MB mp4 "
                  f"decoded to {video.shape}, {seconds:.3f} s a request", flush=True)
            assert video.shape == (14, 576, 1024, 3), video.shape
            videos.append(video.astype(np.float32))
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = _read_counts()
    diff = np.abs(videos[0] - videos[1]).mean()
    print(f"[web-demo] two seeds' clips differ by {diff:.2f} levels on average | launches of "
          f"both requests { {k: v for k, v in launches.items() if v} }", flush=True)
    assert diff > 0.5, diff
    for name in INFERENCE:
        assert launches[name] > 0, f"kernel {name} was not launched by the web demo"
    del pipe
    torch.cuda.empty_cache()
    return launches


def _perturb_safetensors(path: str, name: str, delta: float) -> None:
    """Adds ``delta`` to the fp32 tensor ``name`` of a safetensors file, in place."""
    import struct

    with open(path, "r+b") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        info = json.loads(f.read(n))[name]
        assert info["dtype"] == "F32", info
        start, end = info["data_offsets"]
        f.seek(8 + n + start)
        x = np.frombuffer(f.read(end - start), "<f4") + np.float32(delta)
        f.seek(8 + n + start)
        f.write(x.astype("<f4").tobytes())


def phase_tools(dev: torch.device) -> dict:
    """``verify_parity`` record then check at ``--config svd-xt`` on a safetensors file
    written from seeded weights (and a perturbed copy that must fail), the w8a8 int8
    products against exact products of the same codes at the UNet's shapes with their
    times beside bf16, and ``collect_env``'s report. Returns the launches of the check."""
    import contextlib
    import io
    import tempfile

    import torch.nn.functional as F

    from lkgd_torch.cli import collect_env, verify_parity
    from lkgd_torch.models.configs import SVDUNetConfig
    from lkgd_torch.models.layers import init_params, materialize
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.ops import quantization as tq
    from lkgd_torch.utils.porting import save_safetensors

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        unet = materialize(lambda: UNetSpatioTemporalCondition(SVDUNetConfig()), dev,
                           torch.float32)
        init_params(unet, torch.Generator(device=dev).manual_seed(3))
        state = {k: v.cpu().numpy() for k, v in unet.state_dict().items()}
        del unet
        torch.cuda.empty_cache()
        ckpt = os.path.join(tmp, "diffusion_pytorch_model.safetensors")
        save_safetensors(state, ckpt)
        n = sum(x.size for x in state.values())
        del state
        write_s = time.perf_counter() - t0
        rec, report = os.path.join(tmp, "rec.npz"), os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        assert verify_parity.main(["record", "--config", "svd-xt", "--checkpoint", ckpt,
                                   "--out", rec, "--batch", "1", "--device", str(dev)]) == 0
        record_s = time.perf_counter() - t0
        _zero_counts()
        t0 = time.perf_counter()
        assert verify_parity.main(["check", "--record", rec, "--checkpoint", ckpt, "--report",
                                   report, "--device", str(dev)]) == 0
        check_s = time.perf_counter() - t0
        launches = _read_counts()
        rep = json.loads(Path(report).read_text())
        assert rep["pass"], rep
        _perturb_safetensors(ckpt, "conv_out.weight", 0.05)
        assert verify_parity.main(["check", "--record", rec, "--checkpoint", ckpt, "--report",
                                   report, "--device", str(dev)]) == 1
        bad = json.loads(Path(report).read_text())
    print(f"[tools] verify_parity svd-xt: {n / 1e9:.3f} B fp32 parameters written from a seed "
          f"({write_s:.1f} s), record {record_s:.1f} s, check {check_s:.1f} s: pass, max|d| "
          f"{rep['max_abs_err']:.3e} | conv_out.weight + 0.05 in the file: fail, max|d| "
          f"{bad['max_abs_err']:.3e} | launches of the first check "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    assert not bad["pass"], bad
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((28 * 9216, 320), generator=gen, device=dev).bfloat16()
    w = torch.randn((320, 1280), generator=gen, device=dev).bfloat16() * 0.05
    xq, _ = tq.quantize_rows(x)
    wq, _ = tq.quantize_cols(w)
    sums = tq.int_matmul(xq, wq)
    exact = (xq.double() @ wq.double())  # |sums| <= 127^2 x 320 < 2^53: exact in fp64
    assert torch.equal(sums.double(), exact), "int32 sums differ from the exact product"
    int8_ms, bf16_ms = gpu_ms(lambda: tq.int8_matmul(x, w), 10), gpu_ms(lambda: x @ w, 10)
    mm_ms = gpu_ms(lambda: tq.int_matmul(xq, wq), 10)
    y, ref = tq.int8_matmul(x, w).float(), (x.float() @ w.float())
    mm_err = ((y - ref).abs().max() / ref.abs().max()).item()
    del exact, sums, y, ref
    xc = torch.randn((28, 72, 128, 320), generator=gen, device=dev).bfloat16()
    wc = (torch.randn((3, 3, 320, 320), generator=gen, device=dev) * 0.02).bfloat16()
    got = tq.int8_conv2d(xc, wc)
    xs = torch.clamp(xc.float().abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, min=1e-8)
    ws = torch.clamp(wc.float().abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-8)
    cq = torch.clamp(torch.round(xc.float() / xs), -127, 127).double().permute(0, 3, 1, 2)
    kq = torch.clamp(torch.round(wc.float() / ws), -127, 127).double().permute(3, 2, 0, 1)
    # integer sums < 2^53: exact in fp64 up to the algorithm's rounding, which .round() undoes
    conv_exact = F.conv2d(cq, kq, padding=1).round().permute(0, 2, 3, 1)
    want = (conv_exact.float() * xs * ws).bfloat16()
    assert torch.equal(got, want), "int8_conv2d differs from the exact convolution of its codes"
    del cq, kq, conv_exact, want
    conv_ms = gpu_ms(lambda: tq.int8_conv2d(xc, wc), 5)
    xn, wn = xc.permute(0, 3, 1, 2), wc.permute(3, 2, 0, 1).contiguous()
    lib_conv_ms = gpu_ms(lambda: F.conv2d(xn, wn, padding=1), 5)
    print(f"[tools] int8_matmul (258048,320)x(320,1280): int32 sums equal the exact product; "
          f"{int8_ms:.3f} ms (the int32 product alone {mm_ms:.3f} ms) against bf16 x @ w "
          f"{bf16_ms:.3f} ms; max|d| {mm_err:.3e} of max|ref| against fp32 | int8_conv2d 3x3 "
          f"(28,72,128,320)x320: equal to the exact fp64 convolution of its codes, rescaled; "
          f"{conv_ms:.3f} ms against bf16 F.conv2d {lib_conv_ms:.3f} ms", flush=True)
    del x, w, xq, wq, xc, wc, got, xn, wn
    torch.cuda.empty_cache()

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        collect_env.main([])
    text = report.getvalue()
    print("[tools] collect_env:\n" + text.rstrip(), flush=True)
    assert "sm_90" in text and "SMs" in text, text
    return launches


def _phase_timed(name: str, fn, t_smoke: float):
    """``fn``, printing its seconds, the smoke's running total and the traces it took again
    for lost operations (``_timing.trace_counts["lost"]``) when it returns."""
    from lkgd_torch.experiments._timing import trace_counts

    def run(*args, **kwargs):
        t0, lost = time.perf_counter(), trace_counts["lost"]
        out = fn(*args, **kwargs)
        now = time.perf_counter()
        retaken = trace_counts["lost"] - lost
        print(f"[time] {name} {now - t0:.1f} s, the smoke {now - t_smoke:.1f} s so far"
              + (f", {retaken} trace(s) taken again for lost operations" if retaken else ""),
              flush=True)
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check runs "
                         "only on a CUDA device")
    root = Path(__file__).resolve().parent
    if not (root / "lkgd_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no lkgd_torch/csrc next to {__file__}; run it from a "
                         f"checkout of the repository")
    sys.path.insert(0, str(root))
    if sys.argv[1:2] == ["--sp-rank"]:  # one rank of phase_sp_pair's pair of processes
        return _sp_rank_main(int(sys.argv[2]), Path(sys.argv[3]))
    if sys.argv[1:2] == ["--par-rank"]:  # one rank of phase_par_pair's pair of processes
        return _par_rank_main(int(sys.argv[2]), Path(sys.argv[3]))
    if sys.argv[1:2] == ["--pp-rank"]:  # one rank of phase_pp_pair's pair of processes
        return _pp_rank_main(int(sys.argv[2]), Path(sys.argv[3]))
    # fp32 phases compare exact fp32 arithmetic: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_smoke = time.perf_counter()  # every phase's time, to keep the whole within its limit
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = _phase_timed(name, fn, t_smoke)

    smi, kind = phase_device()
    phase_build()
    kernels = phase_kernels(dev, torch.Generator(device=dev).manual_seed(1234))
    kernels.update(phase_experiment_kernels(dev, torch.Generator(device=dev).manual_seed(99)))
    cogvideox_kernels = phase_cogvideox_kernels(dev, torch.Generator(device=dev).manual_seed(77))
    cogvideox_train_kernels = phase_cogvideox_train_kernels(
        dev, torch.Generator(device=dev).manual_seed(78))
    sd2d_kernels = phase_sd2d_kernels(dev, torch.Generator(device=dev).manual_seed(79))
    fp32_kernels = phase_fp32_kernels(dev, torch.Generator(device=dev).manual_seed(80))
    gn_fp32 = fp32_kernels.pop("gn_fp32")
    kernels.update(fp32_kernels)
    kernels.update(phase_fp32_train_kernels(dev, torch.Generator(device=dev).manual_seed(84)))
    annotate_kernels = phase_annotate_kernels(dev, torch.Generator(device=dev).manual_seed(81))
    sp_kernels = phase_sp_kernels(dev, torch.Generator(device=dev).manual_seed(82))
    _sp_ring_merge(dev, torch.Generator(device=dev).manual_seed(83))
    phase_tiny(dev)
    phase_tiny_joint(dev, "trans")
    phase_tiny_joint(dev, "smooth")
    phase_tiny_variants(dev)
    phase_tiny_cogvideox(dev)
    phase_tiny_cogvideox_train(dev)
    phase_tiny_sd2d(dev)
    phase_tiny_fp32(dev)
    phase_tiny_annotate(dev)
    phase_tiny_labels(dev)
    clip_launches = phase_full(dev)
    torch.cuda.empty_cache()
    trans_launches = phase_trans_full(dev)
    torch.cuda.empty_cache()
    smooth_launches = phase_smooth_full(dev)
    torch.cuda.empty_cache()
    controlnet_launches = phase_controlnet_full(dev)
    torch.cuda.empty_cache()
    deep_cache_launches = phase_deep_cache_full(dev)
    torch.cuda.empty_cache()
    flow_launches = phase_flow_full(dev)
    torch.cuda.empty_cache()
    cogvideox_launches = phase_cogvideox_full(dev)
    torch.cuda.empty_cache()
    sp_launches = phase_sp_pair(dev)
    par_launches = phase_par_pair(dev)
    pp_launches = phase_pp_pair(dev)
    web_demo_launches = phase_web_demo(dev)
    torch.cuda.empty_cache()
    sd2d_launches = phase_sd2d_full(dev)
    torch.cuda.empty_cache()
    kernels.update(phase_train_kernels(dev, torch.Generator(device=dev).manual_seed(4321)))
    vae_grad_launches = phase_vae_attention_grad(dev)
    phase_train_tiny(dev, "lkgd")
    phase_train_tiny(dev, "trans")
    phase_train_tiny(dev, "joint_vf")
    phase_train_tiny(dev, "lkgd", hw=32)
    phase_train_tiny_variants(dev)
    train_launches = phase_train_full(dev)
    torch.cuda.empty_cache()
    train_fp32_launches = phase_train_fp32_full(dev)
    torch.cuda.empty_cache()
    train_trans_launches = phase_train_full(dev, "trans")
    torch.cuda.empty_cache()
    train_controlnet_launches = phase_train_controlnet_full(dev)
    torch.cuda.empty_cache()
    train_flow_launches = phase_train_flow_full(dev)
    torch.cuda.empty_cache()
    train_cogvideox_launches = phase_train_cogvideox_full(dev)
    torch.cuda.empty_cache()
    train_sd2d_launches = phase_train_sd2d_full(dev)
    torch.cuda.empty_cache()
    precompute_launches = phase_precompute_full(dev, smi)
    torch.cuda.empty_cache()
    metrics_launches = phase_metrics_full(dev, smi)
    torch.cuda.empty_cache()
    annotate_launches = phase_annotate_full(dev, smi)
    torch.cuda.empty_cache()
    annotate_launches.update(phase_labels_full(dev, smi))
    torch.cuda.empty_cache()
    caption_launches = phase_captions_full(dev, smi)
    torch.cuda.empty_cache()
    verify_parity_launches = phase_tools(dev)
    torch.cuda.empty_cache()
    phase_train_options(dev)
    experiment_launches = phase_experiments(dev)
    from lkgd_torch.experiments._timing import trace_counts
    print(f"[profiler] {trace_counts['traces']} short traces taken, {trace_counts['empty']} "
          f"of them with no device operation and {trace_counts['lost']} that lost operations, "
          f"each taken again", flush=True)
    # launches: each kernel's count on the path that is its own (the inference kernels' from
    # the base clip, the training kernels' from the counted LKGD training steps, the
    # microbenchmark kernels' from their entry points); every path's count under
    # launches_by_path
    by_path = {"clip": clip_launches, "trans": trans_launches, "smooth": smooth_launches,
               "controlnet": controlnet_launches, "deep_cache_2": deep_cache_launches[2],
               "deep_cache_3": deep_cache_launches[3], "flow": flow_launches,
               **cogvideox_launches, **sp_launches, **par_launches, **pp_launches,
               "web_demo": web_demo_launches,
               "verify_parity": verify_parity_launches,
               "vae_attention_grad": vae_grad_launches,
               "train": train_launches, "train_fp32": train_fp32_launches,
               "train_trans": train_trans_launches,
               "train_controlnet": train_controlnet_launches, "train_flow": train_flow_launches,
               "train_cogvideox": train_cogvideox_launches, **sd2d_launches,
               "train_sd2d": train_sd2d_launches, "experiments": experiment_launches,
               "precompute": precompute_launches, "compute_metrics": metrics_launches,
               **annotate_launches, **caption_launches}
    own = {**dict.fromkeys(INFERENCE, "clip"), **dict.fromkeys(TRAINING, "train"),
           **dict.fromkeys(EXPERIMENTS, "experiments"), **dict.fromkeys(PRECOMPUTE, "precompute"),
           **dict.fromkeys(TRAINING_FP32, "train_fp32")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": by_path[own[name]][name],
         "launches_by_path": {path: counts.get(name, 0) for path, counts in by_path.items()},
         **kernels[name], **({"cogvideox": cogvideox_kernels[name]}
                             if name in cogvideox_kernels else {}),
         **({"train_cogvideox": cogvideox_train_kernels[name]}
            if name in cogvideox_train_kernels else {}),
         **({"sd2d": sd2d_kernels[name]} if name in sd2d_kernels else {}),
         **({"precompute_fp32": gn_fp32[name]} if name in gn_fp32 else {}),
         **({"annotate": annotate_kernels[name]} if name in annotate_kernels else {}),
         **({"sequence_parallel": sp_kernels[mode][name] for mode in sp_kernels
             if name in sp_kernels[mode]})}
        for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
